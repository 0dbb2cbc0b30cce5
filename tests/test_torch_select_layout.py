"""Phases 2-3 in one launch (``csrc/select_rescore.cu``) on the CPU: its
flow, mirrored in numpy by ``ops/select_layout.py``, keeps the contract of
the chain it replaces (``select_rescore_topk_plain``) at the edges; the
route between the two is a function of the device and the shape alone; the
engine's answers do not depend on the route, and its ``search.launch`` span
counts the fused scans. The kernel itself is held to the mirror and the
chain on the card (``tests/test_torch_gpu.py``)."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from iscc_search_tpu_torch import tracing
from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import select_layout as sl
from iscc_search_tpu_torch.ops.nphd import nphd_scores
from iscc_search_tpu_torch.ops.pm1_scan import query_prefix
from iscc_search_tpu_torch.parallel import make_mesh

NAME, T0, T1, ID, PARENT, REQUEST, THREAD, COUNTS = range(8)
SOURCE = Path(sl.__file__).resolve().parent.parent / "csrc" / "select_rescore.cu"


def test_constants_mirror_the_source():
    """The mirror's constants and the wrapper's routing limit are the
    kernel's."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))

    assert const("kThreads") // 32 == sl.WARPS
    assert const("kBlockRows") == sl.BLOCK_ROWS == hs.BLOCK
    assert const("kSuperBlock") == sl.SUPER_BLOCK
    assert const("kMaxCandidates") == sl.MAX_CANDIDATES == hs.FUSED_MAX_CANDIDATES
    assert const("kInvalidBin") == sl.INVALID_BIN


def partition(nbits, nblocks, nq, seed, live=None, planted=3):
    """(q_packed (Q, 8), min_lanes, q_scale, block_max, db, valid): random
    rows with tombstones, three blocks with no valid row and invalid
    padding (or only ``live`` valid rows), every query's code planted at
    ``planted`` rows (ties of block maxima and of scores at both cuts) and
    queries of every length."""
    rng = np.random.default_rng(seed)
    lanes = nbits // 32
    cap = nblocks * 128
    db = rng.integers(0, 2**32, (cap, lanes), dtype=np.uint32)
    q = rng.integers(0, 2**32, (nq, 8), dtype=np.uint32)
    q_lanes = rng.choice(np.array([1, 2, 4, 6, 8], np.int32), nq)
    q[np.arange(8)[None, :] >= q_lanes[:, None]] = 0
    for qi in range(nq):  # the query's own code, and one bit off it, at several rows
        at = rng.integers(0, cap, planted)
        db[at] = q[qi, :lanes]
        db[at[: planted // 2], 0] ^= 1
    valid = np.ones(cap, np.uint8)
    valid[::7] = 0
    blocks = rng.choice(nblocks, min(3, nblocks - 1), replace=False)
    valid[(blocks[:, None] * 128 + np.arange(128)).ravel()] = 0
    valid[cap - 61 :] = 0
    if live is not None:
        valid[:] = 0
        valid[rng.choice(cap, live, replace=False)] = 1
    q_packed = torch.from_numpy(q.view(np.int32))
    min_lanes, q_scale = query_prefix(torch.from_numpy(q_lanes), nbits)
    db_t, valid_t = torch.from_numpy(db.view(np.int32)), torch.from_numpy(valid)
    block_max = hs.blockmax_plain(q_packed, min_lanes, q_scale, db_t, valid_t)
    return q_packed, min_lanes, q_scale, block_max, db_t, valid_t


# (nbits, kk, nblocks, live): the hierarchy (more than 2 * kk whole
# super-blocks), its edge (exactly 2 * kk: flat), ragged rows of blocks,
# fewer blocks than a super-block, every block a candidate, fewer valid rows
# than the cut, and the largest kk the kernel takes.
CASES = [
    (64, 1, 3 * 128, None), (128, 3, 7 * 128, None), (192, 16, 33 * 128, None), (256, 16, 35 * 128, None),
    (256, 3, 6 * 128, None), (128, 2, 5 * 128 + 37, None), (64, 16, 97, None), (192, 7, 7, None),
    (256, 16, 40, 9), (64, 1, 300, 0), (128, 64, 64 * 128 + 5, None),
]


@pytest.mark.parametrize("nbits,kk,nblocks,live", CASES)
def test_the_mirrored_flow_keeps_the_chains_contract(nbits, kk, nblocks, live):
    args = partition(nbits, nblocks, nq=5, seed=nbits + kk + nblocks, live=live)
    q_packed, min_lanes, q_scale, block_max, db, valid = args
    # The candidates hold the top kk rows; all rows where every block is one.
    for out_k in sorted({max(1, kk // 2), kk, min(kk * 128, 3 * kk + 5) if kk == nblocks else kk}):
        want = hs.select_rescore_topk_plain(q_packed, min_lanes, q_scale, block_max, db, valid, kk, out_k)
        got = sl.select_rescore(*(t.numpy() for t in args), kk, out_k)
        sl.check_contract(*map(torch.from_numpy, got), want[0], q_packed, min_lanes, q_scale, db, valid)


def test_the_hierarchy_takes_the_blocks_of_the_flat_selection_by_maximum():
    """Where the hierarchy runs, its kk blocks' maxima are the kk largest
    maxima of the row (any of tied ones may be kept)."""
    _, _, _, block_max, _, _ = partition(256, 35 * 128, nq=5, seed=4, planted=40)
    for row in block_max.numpy():
        got = sl.select_blocks(row, 16)
        assert len(set(got.tolist())) == 16
        np.testing.assert_array_equal(np.sort(row[got]), np.sort(row)[-16:])


@pytest.mark.parametrize("seed", range(4))
def test_a_selection_takes_the_top_keys_and_the_first_tied_ones(seed):
    """The radix select over keys with many ties (a few distinct values,
    negatives, zero): the keys above the k-th largest in order, then the
    first ones equal to it."""
    rng = np.random.default_rng(seed)
    values = rng.choice(np.array([-1e3, -1.0, 0.0, 0.25, 0.5, 0.75, 1.0], np.float32), 1000)
    keys = sl.order_keys(values)
    for k in (1, 7, 140, 999, 1000):
        got = sl.select_top(keys, k)
        kth = np.sort(values)[::-1][k - 1]
        assert np.array_equal(got, np.concatenate([np.flatnonzero(values > kth),
                                                   np.flatnonzero(values == kth)[: k - np.sum(values > kth)]]))


def test_the_route_is_a_function_of_device_and_shape():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert hs.scan_route(cuda, 16, 4_718_592) == "fused"  # config 3 at count 10
    assert hs.scan_route(cuda, 512, 100_007_936) == "chain"  # config 4 at count 400
    assert hs.scan_route(cuda, 64, 1 << 20) == "fused" and hs.scan_route(cuda, 65, 1 << 20) == "chain"
    assert hs.scan_route(cuda, 512, 16 * 128) == "fused"  # kk = 16 blocks of a small partition
    assert hs.scan_route(cuda, 16, 0) == "chain"  # no block
    assert all(hs.scan_route(cpu, k, cap) == "chain" for k in (1, 16, 512) for cap in (128, 1 << 20))


def test_the_wrapper_takes_the_chain_on_the_cpu_and_checks_its_arguments():
    args = partition(128, 40, nq=5, seed=2)
    launches = hs.select_rescore_topk.launches
    got = hs.select_rescore_topk(*args, 16, 16)
    want = hs.select_rescore_topk_plain(*args, 16, 16)
    assert hs.select_rescore_topk.launches == launches
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="kk"):
        hs.select_rescore_topk(*args, 41, 16)
    with pytest.raises(ValueError, match="out_k"):
        hs.select_rescore_topk(*args, 1, 129)
    with pytest.raises(ValueError, match="block_max"):
        hs.select_rescore_topk(*args[:3], args[3][:, :-1].contiguous(), *args[4:], 16, 16)


def test_a_cpu_scan_takes_the_chain_and_counts_its_route():
    args = partition(64, 40, nq=5, seed=3)
    q_packed, min_lanes, q_scale, _, db, valid = args
    before = dict(hs.select_rescore_topk.by_route)
    hs.blockmax_topk_impl(q_packed, min_lanes, q_scale, db, valid, 10)
    assert hs.select_rescore_topk.by_route == {**before, "chain": before["chain"] + 1}


def _codes(n, seed):
    rng = np.random.default_rng(seed)
    lanes = rng.choice(np.array([2, 4, 8], np.int32), n)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    codes[n // 2 : n // 2 + 50] = codes[0]  # ties
    lanes[n // 2 : n // 2 + 50] = lanes[0]
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    valid = np.ones(n, bool)
    valid[::9] = False
    return keys, codes, lanes, valid


def _fused_on_the_cpu(monkeypatch):
    """Every scan routed "fused", its phases 2-3 by the mirrored flow of the
    kernel; returns the list of its calls' query counts."""
    calls = []

    def mirrored(q_packed, min_lanes, q_scale, block_max, db, valid, kk, out_k):
        calls.append(q_packed.shape[0])
        arrays = (t.numpy() for t in (q_packed, min_lanes, q_scale, block_max, db, valid))
        return tuple(map(torch.from_numpy, sl.select_rescore(*arrays, kk, out_k)))

    mirrored.by_route = hs.select_rescore_topk.by_route
    monkeypatch.setattr(hs, "scan_route", lambda device, k, cap: "fused")
    monkeypatch.setattr(hs, "select_rescore_topk", mirrored)
    return calls


@pytest.mark.parametrize("shards", [None, 4])
def test_engine_answers_do_not_depend_on_the_route_and_launch_counts_the_fused_scans(monkeypatch, shards):
    """A search on the CPU (one device, and a mesh of four CPU shards)
    answers the same score multisets, with rows of those scores, whether
    its scans take the chain or the kernel's flow; ``search.launch`` counts
    ``fused_scans`` (one a partition, or a shard) only in the latter."""
    n = 3000
    keys, codes, lanes, valid = _codes(n, seed=7)
    mesh = make_mesh(shards, device="cpu") if shards else None
    idx = DeviceNphdIndex.from_arrays(keys, codes, lanes, valid, device="cpu", mesh=mesh)
    rng = np.random.default_rng(1)
    pick = np.concatenate([[0, n // 2], rng.integers(0, n, 10)])
    bodies = [codes[i, : lanes[i]].astype(">u4").tobytes() for i in pick]
    tracing.disable()
    tracing.clear()
    try:
        tracing.enable()
        want = idx.search(bodies, 10, return_rows=True)
        chain_launch = [r for r in tracing.snapshot()[0] if r[NAME] == "search.launch"]
        tracing.clear()
        calls = _fused_on_the_cpu(monkeypatch)
        got = idx.search(bodies, 10, return_rows=True)
        fused_launch = [r for r in tracing.snapshot()[0] if r[NAME] == "search.launch"]
    finally:
        tracing.disable()
        tracing.clear()
    scans = len(idx._partitions) * (shards or 1)
    assert len(calls) == scans
    assert [r[COUNTS] for r in chain_launch] == [None]
    assert [r[COUNTS] for r in fused_launch] == [{"fused_scans": scans}]
    ref = nphd_scores(torch.from_numpy(codes[pick].view(np.int32)), torch.from_numpy(lanes[pick]),
                      torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lanes), torch.from_numpy(valid)).numpy()
    for qi, ((_, sw, _), (_, sg, rg)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(sg, sw)
        assert valid[rg].all() and len(set(rg.tolist())) == len(rg)
        np.testing.assert_allclose(ref[qi, rg], sg, rtol=0, atol=1e-6)


def test_chip_smoke_select_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s [select] phase end to end at a tiny size on the
    CPU (the wrapper's plain version): config 3's four partitions and the
    c5 shard, each held to the chain's contract, one point each."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "N_ROWS", 20000)
    monkeypatch.setattr(mod, "N_QUERIES", 9)
    monkeypatch.setattr(mod, "GATHER_REPS", 1)
    monkeypatch.setitem(mod.CARD, "sms", 132)
    monkeypatch.setitem(mod.CARD, "max_sm_mhz", 1980.0)
    points = mod.phase_select(np.random.default_rng(0), torch.device("cpu"), {2: 5000, 4: 5000, 6: 2000, 8: 8000})
    assert [p["point"] for p in points] == [f"config3 {b}-bit" for b in (64, 128, 192, 256)] + ["c5 shard 256-bit"]
    assert points[-1]["cap"] == 32768 and all(p["bound_by"] == "bytes" and p["q"] == 9 for p in points)
