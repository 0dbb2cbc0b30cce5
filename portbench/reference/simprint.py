"""
The plain reference of kind "simprints": per-asset chunk scoring, and the
comparison.

From the definitions of the upstream simprint search
(``iscc_search/indexes/simprint/usearch_core.py``): each query chunk takes
the ``limit * oversampling`` live stored chunks most similar to it (Hamming
similarity ``1 - hamming / bits``), keeps those at or above the threshold;
per matched asset, each query chunk keeps its best match; an asset scores
``sum(idf * sim) / sum(idf of every query chunk)``, with
``idf = log(1 + total_assets / (1 + freq))`` and here ``freq = 1``; the
``limit`` best assets by (score descending, asset id) are the answer. The
similarities come from ``nphd.scores`` (at one width NPHD is the Hamming
similarity); the arithmetic of similarities and scores is in ``dtype``:
float64 for the reference, a lower precision for the control. Imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.nphd import pm1

BLOCK_ROWS = 1 << 16  # stored chunks per step (bounds the memory)
TIE = 1e-12  # asset scores this close are one tie: either may take the rank


def matches(q_codes, data, threshold, count, device):
    """Per query chunk, {row: hamming} of the live stored chunks it keeps:
    at most ``count`` by similarity, all at or above ``threshold``, and the
    number of query chunks whose cut fell inside a tie."""
    dev = torch.device(device)
    bits = 32 * data.lanes
    q = pm1(torch.from_numpy(q_codes.view(np.int32)).to(dev), data.lanes)
    max_ham = math.floor((1 - threshold) * bits + 1e-9)
    found = [[] for _ in range(len(q_codes))]
    for s in range(0, len(data.valid), BLOCK_ROWS):
        e = min(len(data.valid), s + BLOCK_ROWS)
        rows = pm1(torch.from_numpy(data.codes[s:e].view(np.int32)).to(dev), data.lanes)
        ham = (bits - q @ rows.T) / 2
        ham[:, ~torch.from_numpy(data.valid[s:e]).to(dev)] = bits + 1
        qi, ri = torch.nonzero(ham <= max_ham, as_tuple=True)
        for a, r, h in zip(qi.tolist(), (ri + s).tolist(), ham[qi, ri].tolist()):
            found[a].append((int(h), r))
    kept, ties = [], 0
    for cands in found:
        cands.sort()
        if len(cands) > count:
            ties += cands[count - 1][0] == cands[count][0]
            cands = cands[:count]
        kept.append(dict((r, h) for h, r in cands))
    return kept, ties


def score_assets(kept, data, total_assets, dtype):
    """{asset: (score, matches, {query chunk: (sim, [rows tied at it])})},
    the arithmetic in ``dtype``."""
    bits = 32 * data.lanes
    one = torch.ones((), dtype=dtype)
    idf = torch.log(one + torch.tensor(total_assets, dtype=torch.float64).to(dtype) / (one + one))
    best = {}
    for qi, rows in enumerate(kept):
        for r, h in rows.items():
            sim = float(one - torch.tensor(h, dtype=dtype) / torch.tensor(bits, dtype=dtype))
            per_q = best.setdefault(r // data.chunks, {})
            old = per_q.get(qi)
            if old is None or sim > old[0]:
                per_q[qi] = (sim, [r])
            elif sim == old[0]:
                old[1].append(r)
    out = {}
    for asset, per_q in best.items():
        sims = torch.tensor([per_q[qi][0] for qi in sorted(per_q)], dtype=dtype)
        weighted = (idf * sims).sum()
        total = idf * torch.tensor(len(kept), dtype=dtype)
        out[asset] = (float(weighted / total), len(per_q), per_q)
    return out


def ranked(scored, limit):
    return sorted(scored, key=lambda a: (-scored[a][0], a))[:limit]


def answers(data, pool, items, config, mix, device, dtype=torch.float64):
    """{item: (ranked assets, {asset: (score, matches, best per query
    chunk)}, query chunks whose candidate cut fell in a tie)}. One pass over
    the stored chunks serves every item's query chunks."""
    count = mix["limit"] * config["oversampling"]
    if not items:
        return {}
    kept, ties = matches(np.concatenate([pool.codes[item] for item in items]), data, mix["threshold"], count, device)
    out = {}
    for j, item in enumerate(items):
        n = len(pool.codes[item])
        scored = score_assets(kept[j * n : (j + 1) * n], data, data.assets, dtype)
        out[item] = (ranked(scored, mix["limit"]), scored, ties)
    return out


def stored_body(data, row):
    return data.codes[row].astype(">u4").tobytes()


def as_program(data, pool, item, ref):
    """The reference's answer in the program's form (``systems.simprints``)."""
    top, scored, _ = ref
    out = []
    for asset in top:
        score, n, per_q = scored[asset]
        chunks = [(pool.bodies[item][qi], stored_body(data, min(rows)), sim, min(rows) % data.chunks * 100, 100, 1)
                  for qi, (sim, rows) in sorted(per_q.items())]
        out.append((int(asset).to_bytes(8, "big"), score, len(pool.bodies[item]), n, chunks))
    return out


def judge(data, pool, items, answers_by_item, ref_by_item, config, mix):
    """The numbers compared, over every recorded answer of the checked items:

    - ``score_gap``: the widest gap between an answer's asset score at a
      rank and the reference's at that rank, between a returned asset's
      score and its reference score, or between a returned chunk's
      similarity and its reference similarity;
    - ``wrong_answers``: answers of the wrong length, with an asset out of
      its rank (beyond a tie), a wrong count of matched or queried chunks,
      or a chunk that is not its query's best match in that asset;
    - ``dead_keys``: removed chunks returned.
    """
    gap, wrong, dead = 0.0, 0, 0
    for item in items:
        top, scored, _ = ref_by_item[item]
        index_of = {body: qi for qi, body in enumerate(pool.bodies[item])}
        for answer in answers_by_item[item]:
            bad = len(answer) != len(top)
            for rank, (body, score, queried, n, chunks) in enumerate(answer[: len(top)]):
                asset = int.from_bytes(body, "big")
                want = scored[top[rank]][0]
                gap = max(gap, abs(score - want))
                rows = [asset * data.chunks + offset // 100 if offset // 100 < data.chunks else -1
                        for _, _, _, offset, _, _ in chunks]
                if min(rows, default=0) < 0 or max(rows, default=0) >= len(data.valid):
                    bad = True
                    continue
                dead += int((~data.valid[rows]).sum())
                if asset not in scored:
                    bad = True
                    continue
                ref_score, ref_n, per_q = scored[asset]
                gap = max(gap, abs(score - ref_score))
                bad |= asset != top[rank] and abs(ref_score - want) > TIE
                bad |= queried != len(pool.bodies[item]) or n != ref_n or len(chunks) != n
                for row, (query, match, sim, offset, size, freq) in zip(rows, chunks):
                    qi = index_of.get(query)
                    if not data.valid[row]:
                        continue
                    if qi not in per_q or row not in per_q[qi][1] or offset % 100 or size != 100 or freq != 1 \
                            or match != stored_body(data, row):
                        bad = True
                    else:
                        gap = max(gap, abs(sim - per_q[qi][0]))
            wrong += bad
    return {"score_gap": gap, "wrong_answers": wrong, "dead_keys": dead}


def control_answers(data, pool, items, config, mix, device):
    """The control: the reference in the program's place, its similarity and
    score arithmetic in bfloat16, the nearest precision below the stated
    float32."""
    refs = answers(data, pool, items, config, mix, device, torch.bfloat16)
    return {item: [as_program(data, pool, item, ref)] for item, ref in refs.items()}
