"""The plain references against a brute force written here, and their controls."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import control
from portbench.reference import nphd, simprint
from portbench.systems import simprints as sp_system
from portbench.tests.conftest import TINY


def brute_nphd(q, ql, db, dl):
    """NPHD of one query against every row, bit by bit in Python ints."""
    out = []
    for row, lanes in zip(db, dl):
        m = min(ql, lanes)
        ham = sum(bin(int(a) ^ int(b)).count("1") for a, b in zip(q[:m], row[:m]))
        out.append(1 - ham / (32 * m))
    return np.array(out)


def random_units(rng, n):
    lanes = rng.choice(np.array([2, 4, 6, 8], np.int32), n)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    return codes, lanes


def test_nphd_topk_is_the_brute_force():
    rng = np.random.default_rng(5)
    db, dl = random_units(rng, 700)
    q, ql = random_units(rng, 9)
    q[:4] = db[:4]  # some queries are stored rows
    ql[:4] = dl[:4]
    valid = rng.random(700) > 0.1
    nphd.BLOCK_ROWS, old = 128, nphd.BLOCK_ROWS  # several blocks
    try:
        scores, rows = nphd.topk(q, ql, db, dl, valid, 10)
    finally:
        nphd.BLOCK_ROWS = old
    for j in range(len(ql)):
        want = brute_nphd(q[j], ql[j], db, dl)
        want[~valid] = -np.inf
        assert np.allclose(scores[j], np.sort(want)[::-1][:10], rtol=0, atol=1e-15)
        assert np.allclose(want[rows[j]], scores[j], rtol=0, atol=1e-15)
        assert valid[rows[j]].all()


def test_nphd_judge_counts_each_fault():
    rng = np.random.default_rng(6)
    db, dl = random_units(rng, 300)
    data = SimpleNamespace(codes=db, lanes=dl, valid=np.ones(300, bool))
    data.valid[7] = False
    pool = SimpleNamespace(codes=db[:3].copy(), lanes=dl[:3].copy())
    mix = {"count": 5}
    ref = nphd.answers(data, pool, [0, 1, 2], {}, mix, "cpu")
    keys, scores = ref[1]
    rows = keys.view(">u8").ravel().astype(np.int64)
    dead_keys = rows.copy()
    dead_keys[-1] = 7
    numbers = nphd.judge(data, pool, [0, 1, 2], {
        0: [ref[0]],
        1: [(keys, scores + 2.0**-10), (keys[:-1], scores[:-1]), (keys[::-1], scores[::-1]),
            (dead_keys.astype(">u8").view(np.uint8).reshape(-1, 8), scores)],
        2: [ref[2]],
    }, ref, {}, mix)
    assert numbers == {"score_gap": pytest.approx(2.0**-10), "wrong_answers": 2, "dead_keys": 1}


def tiny_corpus(seed):
    config = {"assets": 40, "chunks_per_asset": 10, "ndim": 128, "tombstone_every": 8, "oversampling": 2}
    mix = {"pool_requests": 4, "max_flips": 12, "sample": 4, "limit": 3,
           "threshold": 0.6}
    data = sp_system.make_data(config, seed, torch.device("cpu"))
    return config, mix, data, sp_system.make_pool(data, config, mix, seed)


def brute_simprint(data, query, config, mix, total_assets):
    """The upstream scoring, loop by loop, in Python floats."""
    count = mix["limit"] * config["oversampling"]
    idf = math.log(1 + total_assets / 2)
    best = {}
    for qi, q in enumerate(query):
        sims = []
        for row in np.flatnonzero(data.valid):
            ham = sum(bin(int(a) ^ int(b)).count("1") for a, b in zip(q, data.codes[row]))
            sims.append((1 - ham / 128, -row))
        for sim, neg_row in sorted(sims, reverse=True)[:count]:
            if sim >= mix["threshold"]:
                asset = -neg_row // data.chunks
                best.setdefault(asset, {})
                best[asset][qi] = max(best[asset].get(qi, 0.0), sim)
    scores = {a: sum(idf * s for s in per_q.values()) / (idf * len(query)) for a, per_q in best.items()}
    return sorted(scores, key=lambda a: (-scores[a], a))[: mix["limit"]], scores


@pytest.mark.parametrize("seed", [1, 2])
def test_simprint_reference_is_the_brute_force(seed):
    config, mix, data, pool = tiny_corpus(seed)
    ref = simprint.answers(data, pool, [0, 1, 2, 3], config, mix, "cpu")
    for item in range(4):
        top, scores = brute_simprint(data, pool.codes[item], config, mix, data.assets)
        got_top, scored, _ = ref[item]
        assert [scored[a][0] for a in got_top] == pytest.approx([scores[a] for a in top], abs=1e-12)
        assert set(got_top) == set(top)


def test_simprint_judge_counts_each_fault():
    config, mix, data, pool = tiny_corpus(3)
    ref = simprint.answers(data, pool, [0], config, mix, "cpu")
    good = simprint.as_program(data, pool, 0, ref[0])
    body, score, queried, n, chunks = good[0]
    moved = [(body, score + 0.01, queried, n, chunks)] + good[1:]
    short = [(body, score, queried, n - 1, chunks[:-1])] + good[1:]
    row = data.valid.tolist().index(False)
    dead_chunk = (chunks[0][0], chunks[0][1], chunks[0][2], row % data.chunks * 100, 100, 1)
    dead = [(int(row // data.chunks).to_bytes(8, "big"), score, queried, n, [dead_chunk])] + good[1:]
    numbers = simprint.judge(data, pool, [0], {0: [good, moved, short, dead]}, ref, config, mix)
    assert numbers["score_gap"] >= 0.01 and numbers["wrong_answers"] == 2 and numbers["dead_keys"] == 1
    assert simprint.judge(data, pool, [0], {0: [good]}, ref, config, mix) == {
        "score_gap": 0.0, "wrong_answers": 0, "dead_keys": 0}


@pytest.mark.parametrize("workload", list(TINY))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(spec, workload, seed):
    """The reference computed in bfloat16, in the program's place, fails the
    cell's limits (at a test's size; on the card at the cell's, by
    ``portbench/control.py``)."""
    config_over, mix_over = TINY[workload]
    numbers, limits = control.control_numbers(spec, workload, seed, "cpu", config_over, dict(mix_over, sample=128))
    assert any(numbers[name] > limits[name] for name in limits), numbers
