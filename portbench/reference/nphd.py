"""
The plain reference of kind "units": exact NPHD top-k, and the comparison.

    score(q, r) = 1 - hamming(q, r over their common prefix) / prefix bits

ISCC-UNIT codes are whole 32-bit lanes, so the common prefix is
``min(lanes(q), lanes(r))`` lanes. Written from that definition in plain
PyTorch: the bits of both sides as ±1, one matmul per pair of lengths
(a ±1 dot over ``b`` bits is ``b - 2 * hamming``, exact in float64), and
the arithmetic of the score in ``dtype``: float64 for the reference, a
lower precision for the control. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 18  # database rows per step (bounds the memory)


def pm1(codes, lanes):
    """(n, 32 * lanes) float64 ±1 bits of the first ``lanes`` lanes of
    int32-carried uint32 ``codes`` (bit 31 of lane 0 first)."""
    shifts = torch.arange(31, -1, -1, device=codes.device, dtype=torch.int32)
    bits = (codes[:, :lanes, None] >> shifts) & 1
    return bits.reshape(codes.shape[0], lanes * 32).to(torch.float64) * 2 - 1


def scores(q_codes, q_lanes, db_codes, db_lanes, dtype):
    """(Q, n) scores of every query against every row, computed in ``dtype``."""
    out = torch.empty((len(q_lanes), len(db_lanes)), dtype=dtype, device=db_codes.device)
    for a in torch.unique(q_lanes).tolist():
        qi = torch.nonzero(q_lanes == a).ravel()
        for b in torch.unique(db_lanes).tolist():
            ri = torch.nonzero(db_lanes == b).ravel()
            m = min(a, b)
            dot = pm1(q_codes[qi], m) @ pm1(db_codes[ri], m).T
            bits = torch.tensor(32 * m, dtype=dtype, device=dot.device)
            ham = ((32 * m - dot) / 2).to(dtype)
            out[qi[:, None], ri[None, :]] = 1 - ham / bits
    return out


def topk(q_codes, q_lanes, db_codes, db_lanes, db_valid, k, dtype=torch.float64, device="cpu"):
    """(scores (Q, k) in ``dtype`` descending, rows (Q, k) int64) of the
    exact top-``k`` live rows of each query. Host arrays in, host arrays
    out; the database goes to ``device`` in blocks."""
    dev = torch.device(device)
    q = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    ql = torch.from_numpy(q_lanes).to(dev)
    best_s = torch.full((len(q_lanes), 0), -np.inf, dtype=dtype, device=dev)
    best_r = torch.zeros((len(q_lanes), 0), dtype=torch.int64, device=dev)
    for s in range(0, len(db_lanes), BLOCK_ROWS):
        e = min(len(db_lanes), s + BLOCK_ROWS)
        sc = scores(q, ql, torch.from_numpy(db_codes[s:e].view(np.int32)).to(dev),
                    torch.from_numpy(db_lanes[s:e]).to(dev), dtype)
        sc[:, ~torch.from_numpy(db_valid[s:e]).to(dev)] = -np.inf
        cs, cr = torch.topk(sc, min(k, e - s), dim=1)
        cat_s, cat_r = torch.cat([best_s, cs], dim=1), torch.cat([best_r, cr + s], dim=1)
        best_s, pos = torch.topk(cat_s, min(k, cat_s.shape[1]), dim=1)
        best_r = torch.gather(cat_r, 1, pos)
    return best_s.to(torch.float64).cpu().numpy(), best_r.cpu().numpy()


def answers(data, pool, items, config, mix, device, dtype=torch.float64):
    """{item: (keys (m, 8) uint8, scores (m,))}: the top-``count`` live rows
    of each query, as the index answers it (row ``r`` has key ``r``)."""
    s, r = topk(pool.codes[items], pool.lanes[items], data.codes, data.lanes, data.valid, mix["count"], dtype,
                device)
    out = {}
    for j, item in enumerate(items):
        live = np.isfinite(s[j].astype(np.float64))
        out[item] = (r[j][live].astype(">u8").view(np.uint8).reshape(-1, 8), s[j][live].astype(np.float64))
    return out


def judge(data, pool, items, answers_by_item, ref_by_item, config, mix):
    """The numbers compared, over every recorded answer of the checked items:

    - ``score_gap``: the widest gap between an answer's score at a rank and
      the reference's at that rank, or between a returned row's score and
      that row's reference score;
    - ``wrong_answers``: answers of the wrong length, out of order, with a
      row twice, or with a key of no row;
    - ``dead_keys``: removed rows returned.
    """
    gap, wrong, dead = 0.0, 0, 0
    n = len(data.lanes)
    for item in items:
        ref_scores = ref_by_item[item][1]
        want = len(ref_scores)
        for keys, got in answers_by_item[item]:
            got = np.asarray(got, np.float64)
            rows = np.asarray(keys, np.uint8).reshape(-1, 8).view(">u8").ravel().astype(np.int64)
            if len(got) != want or len(set(rows.tolist())) != len(rows) or np.any(np.diff(got) > 0) \
                    or np.any(rows >= n):
                wrong += 1
                continue
            if not data.valid[rows].all():
                dead += int((~data.valid[rows]).sum())
                continue
            exact = scores(torch.from_numpy(pool.codes[[item]].view(np.int32)), torch.from_numpy(pool.lanes[[item]]),
                           torch.from_numpy(data.codes[rows].view(np.int32)), torch.from_numpy(data.lanes[rows]),
                           torch.float64).numpy()[0]
            gap = max(gap, float(np.abs(got - ref_scores).max(initial=0.0)), float(np.abs(got - exact).max(initial=0.0)))
    return {"score_gap": gap, "wrong_answers": wrong, "dead_keys": dead}


def control_answers(data, pool, items, config, mix, device):
    """The control: the reference in the program's place, its score
    arithmetic in bfloat16, the nearest precision below the stated float32."""
    return {item: [answer] for item, answer in answers(data, pool, items, config, mix, device, torch.bfloat16).items()}
