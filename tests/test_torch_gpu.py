"""Hopper kernels of ``iscc_search_tpu_torch`` against their plain PyTorch
versions, on a CUDA card (marker ``gpu``; each test skips without one).

This file imports neither jax nor ``iscc_search_tpu``, so it also runs on a
host whose Python has only PyTorch, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Comparisons are ``torch.equal``: kernel and plain version compute the same
integer dots and round ``0.5 + m * q_scale`` the same way (once to f32: a
fused multiply-add in the kernel, an exact float64 product and sum in the
plain version), all-invalid blocks included, since both use the same f32
penalty.
"""

import numpy as np
import pytest
import torch

from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.experiments import bitplane_layout, exp_bitplane_int8, exp_bitplane_u8, exp_int4, exp_kernels
from iscc_search_tpu_torch.ops import bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import select_layout
from iscc_search_tpu_torch.ops import wgmma_layout as wl
from iscc_search_tpu_torch.ops.nphd import nphd_scores
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, query_prefix

pytestmark = pytest.mark.gpu

WIDTHS = (64, 128, 192, 256)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _random_codes(rng, n):
    lanes = rng.choice(np.array([2, 4, 6, 8], np.int32), n).astype(np.int32)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    return codes, lanes


def _case(dev, nbits, seed, cap=128 * 40, nq=77, kk=16):
    """Partition with padding, tombstones and one all-invalid block, plus
    queries of every length (shorter and longer than the partition)."""
    rng = np.random.default_rng(seed)
    lanes = nbits // 32
    db = torch.from_numpy(rng.integers(0, 2**32, (cap, lanes), dtype=np.uint32).view(np.int32)).to(dev)
    valid_np = np.zeros(cap, np.uint8)
    valid_np[: cap - 128 * 3 + 5] = 1
    valid_np[::7] = 0
    valid_np[3 * 128 : 4 * 128] = 0
    valid = torch.from_numpy(valid_np).to(dev)
    q_codes, q_lanes = _random_codes(rng, nq)
    q_packed = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    min_lanes, q_scale = query_prefix(torch.from_numpy(q_lanes).to(dev), nbits)
    block_ids = torch.from_numpy(rng.integers(0, cap // 128, (nq, kk)).astype(np.int32)).to(dev)
    return q_packed, min_lanes, q_scale, db, valid, block_ids


@pytest.mark.parametrize("nbits", WIDTHS)
def test_blockmax_kernel_equals_plain(dev, nbits):
    q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, nbits, seed=nbits)
    before = hs.blockmax.launches
    got = hs.blockmax(q_packed, min_lanes, q_scale, db, valid)
    torch.cuda.synchronize()
    assert hs.blockmax.launches == before + 1
    want = hs.blockmax_plain(q_packed, min_lanes, q_scale, db, valid)
    assert torch.equal(got, want)
    assert bool((got[:, 3] < -1.0).all())  # the all-invalid block


@pytest.mark.parametrize("nbits", WIDTHS)
def test_mma_kernels_equal_plain_and_blockmax(dev, nbits):
    """Both tensor-core entries against their plain versions and against the
    popc kernel, ``torch.equal``: Q=77 (a ragged query tile), short and long
    queries, tombstones, padding and an all-invalid block."""
    q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, nbits, seed=nbits + 2)
    twin = hs.build_unpacked_db(db, nbits)
    assert twin.shape == (db.shape[0], nbits) and twin.dtype == torch.int8
    popc = hs.blockmax(q_packed, min_lanes, q_scale, db, valid)
    before = hs.blockmax_mma_unpacked.launches, hs.blockmax_mma_packed.launches
    got_u = hs.blockmax_mma_unpacked(q_packed, min_lanes, q_scale, twin, valid)
    got_p = hs.blockmax_mma_packed(q_packed, min_lanes, q_scale, db, valid)
    torch.cuda.synchronize()
    assert (hs.blockmax_mma_unpacked.launches, hs.blockmax_mma_packed.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got_u, hs.blockmax_unpacked_plain(q_packed, min_lanes, q_scale, twin, valid))
    assert torch.equal(got_p, hs.blockmax_plain(q_packed, min_lanes, q_scale, db, valid))
    assert torch.equal(got_u, popc) and torch.equal(got_p, popc)
    assert bool((got_u[:, 3] < -1.0).all())  # the all-invalid block


@pytest.mark.parametrize(
    "kbytes,a_layout,b_layout",
    [
        (32, None, None),  # one k-step, the kernel's layouts
        (256, None, None),
        (192, (512 * 16, 128), None),  # the query tile inside a 512-query panel
        (256, (128, 16 * 128), (128, 16 * 128)),  # all k-chunks of an 8-row group together
        (64, (64 * 16 + 48, 128), (128 * 16, 128)),  # another pad, and none
    ],
)
def test_bare_wgmma_tile_equals_the_integer_product(dev, kbytes, a_layout, b_layout):
    """One m64n128k32 chain over random int8 tiles written through the Python
    mirror of the layout: proves the layout function, the descriptor fields
    (which offset is LBO, which SBO) and the accumulator layout."""
    rng = np.random.default_rng(kbytes)
    a = torch.from_numpy(rng.integers(-128, 128, (64, kbytes), dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-128, 128, (128, kbytes), dtype=np.int8)).to(dev)
    before = wl.wgmma_tile.launches
    got = wl.wgmma_tile(a, b, a_layout, b_layout)
    torch.cuda.synchronize()
    assert wl.wgmma_tile.launches == before + 1
    assert torch.equal(got, wl.wgmma_tile_plain(a, b))
    assert torch.equal(got.cpu(), a.cpu().int() @ b.cpu().int().T)


@pytest.mark.parametrize("lanes", range(1, 9))
@pytest.mark.parametrize("nq", (1, 63, 64, 65, 77, 512, 600))
def test_wgmma_kernels_at_every_width_and_query_count(dev, lanes, nq):
    """``blockmax_mma_*`` == plain == ``blockmax`` for every lane count, for
    query counts around the 64-query tile and the 512-query chunk, on a
    partition with fewer blocks than the card has SMs (40) and one with more
    (300: a persistent thread block walks several)."""
    nbits = lanes * 32
    for cap in (128 * 40, 128 * 300):
        q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, nbits, seed=1000 * lanes + nq, cap=cap, nq=nq)
        if lanes % 2:  # _random_codes draws even lane counts only: some queries shorter than an odd partition
            min_lanes = torch.minimum(min_lanes, torch.arange(nq, device=dev, dtype=torch.int32) % lanes + 1)
            q_scale = (1.0 / (64.0 * min_lanes)).to(torch.float32)
        twin = hs.build_unpacked_db(db, nbits)
        want = hs.blockmax_plain(q_packed, min_lanes, q_scale, db, valid)
        assert torch.equal(hs.blockmax_mma_packed(q_packed, min_lanes, q_scale, db, valid), want)
        assert torch.equal(hs.blockmax_mma_unpacked(q_packed, min_lanes, q_scale, twin, valid), want)
        assert torch.equal(hs.blockmax(q_packed, min_lanes, q_scale, db, valid), want)
        assert bool((want[:, 3] < -1.0).all())  # the all-invalid block


@pytest.mark.parametrize("lanes", range(1, 9))
@pytest.mark.parametrize("nq", (1, 7, 8, 9, 33, 100, 128, 129, 300))
def test_small_batch_kernel_at_every_width_and_query_count(dev, lanes, nq):
    """``blockmax_small`` == plain (``torch.equal``) for every lane count and
    the batch sizes around its n-tiles and its 128-query chunk: queries
    shorter than the partition, tombstones, padding, an all-invalid block and
    one whose only valid row is row 100, on 40 blocks (five thread blocks,
    one block per warp) and 8,001 blocks (a full grid, shares of seven and
    eight, sector groups split between warps); one launch per call."""
    nbits = lanes * 32
    for cap in (128 * 40, 128 * 8001):
        q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, nbits, seed=2000 * lanes + nq, cap=cap, nq=nq)
        min_lanes = torch.minimum(min_lanes, torch.arange(nq, device=dev, dtype=torch.int32) % lanes + 1)
        q_scale = (1.0 / (64.0 * min_lanes)).to(torch.float32)
        valid[128 * 7 + 100] = 1  # a block whose only valid row is row 100
        valid[128 * 7 : 128 * 7 + 100] = 0
        valid[128 * 7 + 101 : 128 * 8] = 0
        before = hs.blockmax_small.launches
        got = hs.blockmax_small(q_packed, min_lanes, q_scale, db, valid)
        torch.cuda.synchronize()
        assert hs.blockmax_small.launches == before + 1
        want = hs.blockmax_plain(q_packed, min_lanes, q_scale, db, valid)
        assert torch.equal(got, want)
        assert bool((got[:, 3] < -1.0).all()) and bool((got[:, 7] > -1.0).all())


def test_small_batch_kernel_refuses_rows_it_cannot_copy_whole(dev):
    """The TMA copies need 16-byte aligned rows and validity: a shifted view
    raises instead of launching."""
    q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, 64, seed=9)
    flat = torch.zeros(db.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(db.shape)
    shifted.copy_(db)
    before = hs.blockmax_small.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        hs.blockmax_small(q_packed, min_lanes, q_scale, shifted, valid)
    assert hs.blockmax_small.launches == before


@pytest.mark.parametrize("blocks", (1, 2, 3, 131, 133))
def test_wgmma_kernels_on_few_blocks_and_just_around_the_sm_count(dev, blocks):
    """One block (both teams of the one thread block take it), odd shares,
    and block counts next to the card's SM count."""
    for nbits in (64, 256):
        q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, nbits, seed=blocks, cap=128 * blocks, nq=130)
        valid[: 128 * blocks] = 1
        valid[::5] = 0
        if blocks > 1:
            valid[128:256] = 0  # an all-invalid block
        twin = hs.build_unpacked_db(db, nbits)
        want = hs.blockmax_plain(q_packed, min_lanes, q_scale, db, valid)
        assert torch.equal(hs.blockmax_mma_packed(q_packed, min_lanes, q_scale, db, valid), want)
        assert torch.equal(hs.blockmax_mma_unpacked(q_packed, min_lanes, q_scale, twin, valid), want)
        assert torch.equal(hs.blockmax_small(q_packed, min_lanes, q_scale, db, valid), want)


@pytest.mark.parametrize("nbits,k", [(64, 10), (192, 7), (256, 16)])
def test_twin_route_equals_the_route_without_a_twin(dev, nbits, k):
    """``blockmax_topk_packedq_impl`` with ``unpacked=True`` runs phase 1 on
    the tensor cores; the block maxima are identical, so are the results."""
    rng = np.random.default_rng(nbits + k)
    cap = 128 * 300
    db = torch.from_numpy(rng.integers(0, 2**32, (cap, nbits // 32), dtype=np.uint32).view(np.int32)).to(dev)
    valid = torch.from_numpy((rng.random(cap) > 0.1).astype(np.uint8)).to(dev)
    q_codes, q_lanes = _random_codes(rng, 77)
    q_packed, q_lanes = torch.from_numpy(q_codes.view(np.int32)).to(dev), torch.from_numpy(q_lanes).to(dev)
    twin = hs.build_unpacked_db(db, nbits)
    before = hs.blockmax_mma_unpacked.launches
    got = hs.blockmax_topk_packedq_impl(q_packed, q_lanes, db, valid, k, nbits, db_unpacked=twin, unpacked=True)
    assert hs.blockmax_mma_unpacked.launches == before + 1
    want = hs.blockmax_topk_packedq_impl(q_packed, q_lanes, db, valid, k, nbits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nbits", WIDTHS)
def test_gather_rescore_kernel_equals_plain(dev, nbits):
    q_packed, min_lanes, _, db, _, block_ids = _case(dev, nbits, seed=nbits + 1)
    before = hs.gather_rescore.launches
    got = hs.gather_rescore(q_packed, min_lanes, block_ids, db)
    torch.cuda.synchronize()
    assert hs.gather_rescore.launches == before + 1
    assert torch.equal(got, hs.gather_rescore_plain(q_packed, min_lanes, block_ids, db))


def _gather_edge_cases(dev, lanes, seed):
    """(label, q_packed (Q, 8), min_lanes, block_ids, db) at the edges of
    both gather forms: Q=1, kk=1, block ids repeated within a query, one
    block chosen by every query (a list longer than a segment), the
    partition's last block, ``min_lanes`` 0 and short prefixes."""
    rng = np.random.default_rng(seed)
    nblocks = 40
    db = torch.from_numpy(rng.integers(0, 2**32, (nblocks * 128, lanes), dtype=np.uint32).view(np.int32)).to(dev)

    def queries(nq):
        q = torch.from_numpy(rng.integers(0, 2**32, (nq, 8), dtype=np.uint32).view(np.int32)).to(dev)
        ml = torch.from_numpy(rng.integers(0, lanes + 1, nq).astype(np.int32)).to(dev)
        return q, ml

    def ids(nq, kk, fill=None):
        a = rng.integers(0, nblocks, (nq, kk)).astype(np.int32) if fill is None else np.full((nq, kk), fill, np.int32)
        return torch.from_numpy(a).to(dev)

    repeated = ids(9, 4).repeat(1, 3)
    last = ids(30, 5)
    last[:, 2] = nblocks - 1
    for label, nq, block_ids in (
        ("Q=1", 1, ids(1, 16)), ("kk=1", 13, ids(13, 1)), ("repeats", 9, repeated),
        ("one block by all", 77, ids(77, 3, fill=17)), ("last block", 30, last), ("random", 77, ids(77, 16)),
    ):
        yield (label, *queries(nq), block_ids.contiguous(), db)


@pytest.mark.parametrize("lanes", range(1, 9))
def test_gather_rescore_forms_equal_plain_and_each_other(dev, lanes):
    """Both forms of ``csrc/gather_rescore.cu`` and the route, ``torch.equal``
    to the plain version and to each other at the edge cases; each call
    counts one launch, and ``by_form`` the form it took."""
    for label, q_packed, min_lanes, block_ids, db in _gather_edge_cases(dev, lanes, seed=lanes):
        want = hs.gather_rescore_plain(q_packed, min_lanes, block_ids, db)
        got = {}
        for form in (*hs.GATHER_FORMS, None):
            before = hs.gather_rescore.launches, dict(hs.gather_rescore.by_form)
            got[form] = hs.gather_rescore(q_packed, min_lanes, block_ids, db, form=form)
            torch.cuda.synchronize()
            took = form or hs.gather_form(*block_ids.shape, db.shape[0] // 128, lanes)
            assert hs.gather_rescore.launches == before[0] + 1, label
            assert hs.gather_rescore.by_form == {**before[1], took: before[1][took] + 1}, label
            assert torch.equal(got[form], want), (label, form)
        assert torch.equal(got["query"], got["block"]), label


def test_gather_route_takes_each_form_by_reuse(dev):
    """High reuse (77 x 16 pairs over 40 blocks) takes the block-major form,
    low reuse (4 x 16 pairs over 4,096 blocks) the query-major form."""
    rng = np.random.default_rng(21)
    for nblocks, nq, form in ((40, 77, "block"), (4096, 4, "query")):
        db = torch.from_numpy(rng.integers(0, 2**32, (nblocks * 128, 4), dtype=np.uint32).view(np.int32)).to(dev)
        q_packed = torch.from_numpy(rng.integers(0, 2**32, (nq, 8), dtype=np.uint32).view(np.int32)).to(dev)
        min_lanes = torch.full((nq,), 4, dtype=torch.int32, device=dev)
        block_ids = torch.from_numpy(rng.integers(0, nblocks, (nq, 16)).astype(np.int32)).to(dev)
        assert hs.gather_form(nq, 16, nblocks, 4) == form
        before = dict(hs.gather_rescore.by_form)
        got = hs.gather_rescore(q_packed, min_lanes, block_ids, db)
        torch.cuda.synchronize()
        assert hs.gather_rescore.by_form[form] == before[form] + 1
        assert torch.equal(got, hs.gather_rescore_plain(q_packed, min_lanes, block_ids, db))


def test_gather_block_form_replays_in_a_cuda_graph(dev):
    """The block-major form zeroes its counts on the stream: a captured
    call replays to the same result every time."""
    q_packed, min_lanes, _, db, _, block_ids = _case(dev, 128, seed=8)
    want = hs.gather_rescore_plain(q_packed, min_lanes, block_ids, db)
    hs.gather_rescore(q_packed, min_lanes, block_ids, db, form="block")  # warm: builds and loads
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = hs.gather_rescore(q_packed, min_lanes, block_ids, db, form="block")
    for _ in range(3):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_kernels_take_a_strided_query_matrix(dev):
    """q_packed wider than the partition (the engine passes (Q, 8) queries
    to every partition): the kernels read only the first ``lanes`` words."""
    q_packed, min_lanes, q_scale, db, valid, block_ids = _case(dev, 64, seed=3)
    assert q_packed.shape[1] == 8 and db.shape[1] == 2
    narrow = q_packed[:, :2].contiguous()
    for phase1 in (hs.blockmax, hs.blockmax_mma_packed, hs.blockmax_small):
        assert torch.equal(phase1(q_packed, min_lanes, q_scale, db, valid), phase1(narrow, min_lanes, q_scale, db, valid))
    assert torch.equal(
        hs.gather_rescore(q_packed, min_lanes, block_ids, db), hs.gather_rescore(narrow, min_lanes, block_ids, db)
    )


def test_wrapper_rejects_mixed_devices(dev):
    q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, 128, seed=4)
    with pytest.raises(ValueError, match="one device"):
        hs.blockmax(q_packed.cpu(), min_lanes, q_scale, db, valid)


def test_index_search_on_card_matches_cpu_index(dev):
    """The engine on the card (kernels) and on the CPU (plain versions)
    return the same top-k scores, and every row carries its brute-force
    score."""
    rng = np.random.default_rng(11)
    n = 20000
    codes, lanes = _random_codes(rng, n)
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    gpu = DeviceNphdIndex(device="cuda")
    cpu = DeviceNphdIndex(device="cpu")
    for idx in (gpu, cpu):
        idx.add_packed(keys, codes, lanes)
        idx.remove(list(range(0, n, 9)))
    q_rows = rng.integers(0, n, 40)
    bodies = [codes[i, : lanes[i]].astype(">u4").tobytes() for i in q_rows]
    launches = sum(fn.launches for fn in hs.PHASE1.values()), hs.select_rescore_topk.launches, hs.gather_rescore.launches
    res_gpu = gpu.search(bodies, 10)
    assert sum(fn.launches for fn in hs.PHASE1.values()) == launches[0] + 4
    assert hs.select_rescore_topk.launches == launches[1] + 4  # phases 2-3 fused at k = 16
    assert hs.gather_rescore.launches == launches[2]
    res_cpu = cpu.search(bodies, 10)
    valid = np.ones(n, bool)
    valid[::9] = False
    ref = nphd_scores(
        torch.from_numpy(codes[q_rows].view(np.int32)), torch.from_numpy(lanes[q_rows]),
        torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lanes), torch.from_numpy(valid),
    ).numpy()
    for qi, ((kg, sg), (_, sc)) in enumerate(zip(res_gpu, res_cpu)):
        np.testing.assert_array_equal(np.sort(sg), np.sort(sc))
        rows = kg.view(">u8").ravel().astype(np.int64)
        np.testing.assert_allclose(ref[qi, rows], sg, rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.sort(sg)[::-1], np.sort(ref[qi])[::-1][:10], rtol=0, atol=1e-6)


def _engine_pair(rng, n, **kwargs):
    """The same rows (every width, tombstones) in an index on the card and
    in one on the CPU: (card, cpu, codes, lanes, valid)."""
    codes, lanes = _random_codes(rng, n)
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    gpu = DeviceNphdIndex(device="cuda", **kwargs)
    cpu = DeviceNphdIndex(device="cpu")
    for idx in (gpu, cpu):
        idx.add_packed(keys, codes, lanes)
        idx.remove(list(range(0, n, 9)))
    valid = np.ones(n, bool)
    valid[::9] = False
    return gpu, cpu, codes, lanes, valid


@pytest.mark.parametrize("nq", (1, 63, 64, 65, 512, 600))
@pytest.mark.parametrize("scan_kernel", ("auto", "mma", "mma_small", "popc"))
def test_engine_search_under_every_scan_kernel_equals_the_cpu_plain_path(dev, scan_kernel, nq):
    """Batch sizes around the 64-query tile and the 512-query chunk: the
    engine on the card returns the CPU index's score multisets under every
    ``scan_kernel``, every row carries its brute-force score, and phase 1
    launched the kernel ``scan_kernel`` names (``"auto"``: ``auto_phase1``)."""
    from iscc_search_tpu_torch.engine.device_index import auto_phase1

    rng = np.random.default_rng(1000 + nq)
    n = 40000
    gpu, cpu, codes, lanes, valid = _engine_pair(rng, n, scan_kernel=scan_kernel)
    q_rows = rng.integers(0, n, nq)
    bodies = [codes[i, : lanes[i]].astype(">u4").tobytes() for i in q_rows]
    for fn in hs.PHASE1.values():
        fn.launches = 0
    res_gpu = gpu.search(bodies, 10)
    got = {name: fn.launches for name, fn in hs.PHASE1.items()}
    want = dict.fromkeys(hs.PHASE1, 0)
    for lv in (2, 4, 6, 8):
        want[auto_phase1(nq, lv) if scan_kernel == "auto" else scan_kernel] += 1
    assert got == want
    res_cpu = cpu.search(bodies, 10)
    sample = np.linspace(0, nq - 1, min(nq, 12)).astype(np.int64)
    ref = nphd_scores(
        torch.from_numpy(codes[q_rows[sample]].view(np.int32)), torch.from_numpy(lanes[q_rows[sample]]),
        torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lanes), torch.from_numpy(valid),
    ).numpy()
    for (kg, sg), (_, sc) in zip(res_gpu, res_cpu):
        np.testing.assert_array_equal(np.sort(sg), np.sort(sc))
        assert valid[kg.view(">u8").ravel().astype(np.int64)].all()
    for j, qi in enumerate(sample):
        kg, sg = res_gpu[qi]
        np.testing.assert_allclose(ref[j, kg.view(">u8").ravel().astype(np.int64)], sg, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scan_kernel", ("mma", "mma_small", "popc"))
def test_engine_search_on_another_stream(dev, scan_kernel):
    """A search made under ``torch.cuda.stream`` launches on that stream and
    gets the tensor-core kernel's large dynamic shared memory there too
    (256-bit rows at Q=512: over 200 KB); same results as on the default
    stream."""
    rng = np.random.default_rng(77)
    gpu, _, codes, lanes, _ = _engine_pair(rng, 20000, scan_kernel=scan_kernel)
    q_rows = rng.integers(0, 20000, 512)
    bodies = [codes[i, : lanes[i]].astype(">u4").tobytes() for i in q_rows]
    want = gpu.search(bodies, 10)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = gpu.search(bodies, 10)
    for (kw, sw), (kg, sg) in zip(want, got):
        np.testing.assert_array_equal(kw, kg)
        np.testing.assert_array_equal(sw, sg)


def test_a_refused_phase1_launch_raises(dev, monkeypatch):
    """No way round a failed launch: the wrapper raises, the engine search
    with it, and nothing is counted."""
    gpu, _, codes, lanes, _ = _engine_pair(np.random.default_rng(5), 2000, scan_kernel="mma")
    gpu.search([bytes(8)], 1)
    monkeypatch.setattr(hs, "_entry", lambda name: (lambda *args: 9))  # cudaErrorInvalidConfiguration
    before = {name: fn.launches for name, fn in hs.PHASE1.items()}
    with pytest.raises(RuntimeError, match="blockmax_mma_packed kernel launch failed: cudaError 9"):
        gpu.search([bytes(8)], 1)
    assert {name: fn.launches for name, fn in hs.PHASE1.items()} == before


def test_index_saved_on_the_card_reopens_on_the_card(dev, tmp_path):
    """save, close, open anew on the card: the same keys and scores."""
    rng = np.random.default_rng(13)
    n = 30000
    codes, lanes = _random_codes(rng, n)
    keys = np.arange(1, n + 1, dtype=">u8").view(np.uint8).reshape(n, 8)
    idx = DeviceNphdIndex(tmp_path / "i", shard_size=45 * 7000, device="cuda")
    idx.add_packed(keys, codes, lanes)
    idx.remove(list(range(1, n, 11)))
    bodies = [codes[i, : lanes[i]].astype(">u4").tobytes() for i in rng.integers(0, n, 100)]
    want = idx.search(bodies, 10)
    idx.save(wait=True)
    assert idx.shard_count == 5
    idx.close()
    again = DeviceNphdIndex(tmp_path / "i", device="cuda")
    assert len(again) == len(idx) and again._partitions is None
    for (kw, sw), (kg, sg) in zip(want, again.search(bodies, 10)):
        np.testing.assert_array_equal(kw, kg)
        np.testing.assert_array_equal(sw, sg)
    again.close()


def _experiment_case(dev, n, seed, nq=77):
    """256-bit rows with tombstones and an all-invalid block (block 3), and
    Q=77 queries, half of them 192-bit prefixes (q_scale = 1/384)."""
    rng = np.random.default_rng(seed)
    packed = torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)).to(dev)
    valid_np = (rng.random(n) > 0.05).astype(np.uint8)
    valid_np[3 * 128 : 4 * 128] = 0
    valid = torch.from_numpy(valid_np).to(dev)
    q_lanes = torch.from_numpy(np.where(np.arange(nq) % 2, 8, 6).astype(np.int32)).to(dev)
    min_lanes, q_scale = query_prefix(q_lanes, 256)
    q_packed = packed[torch.from_numpy(rng.integers(0, n, nq)).to(dev)]
    return packed, valid, q_packed, min_lanes, q_scale


# (rows, queries, penalty on the per-element path): two chunks at Q=77; the
# per-element path; Q=513, three launches of 256, 256 and 1 queries; 2,816
# blocks (88 sub-tiles), which do not divide among 132 SMs x 2 teams.
VARIANT_CASES = {"tombstones": (32768, 77, False), "general": (32768, 77, True), "q513": (32768, 513, False),
                 "ragged": (360448, 77, False)}


@pytest.mark.parametrize("case", VARIANT_CASES)
@pytest.mark.parametrize("name", exp_kernels.NAMES)
def test_variant_kernel_equals_plain(dev, name, case):
    """Every kernel-8 variant of ``csrc/blockmax_variants.cu``: kernel ==
    plain, short prefixes, tombstones, a dead block, on both of the
    epilogue's paths, across query chunks and on a ragged grid."""
    n, nq, general = VARIANT_CASES[case]
    packed, valid, q_packed, min_lanes, q_scale = _experiment_case(dev, n, seed=8, nq=nq)
    db = hs.build_unpacked_db(packed, 256)
    q = masked_queries(q_packed, min_lanes, 256).to(torch.int8)
    fn, _ = exp_kernels.make_variant(name, n, q.shape[0])
    pen = exp_kernels.variant_penalties(name, valid, general)
    before = exp_kernels.blockmax_variant.launches
    got = fn(q, q_scale[:, None].contiguous(), db, pen)
    torch.cuda.synchronize()
    assert exp_kernels.blockmax_variant.launches == before + 1
    assert torch.equal(got, exp_kernels.blockmax_variant_plain(name, q, q_scale[:, None].contiguous(), db, pen))


@pytest.mark.parametrize("nq", (1, 8, 16, 17))
def test_int4_kernels_equal_plain_on_any_int4_values(dev, nq):
    """The dot and the probe of ``csrc/int4_dot.cu`` on random int4
    values, -8 included (twins of ±1 rows hold only 1 and 15), at query
    counts around the 16-query tile, and a probe chunk of 256 rows."""
    rng = np.random.default_rng(nq)
    n = 16384
    db4 = torch.from_numpy(rng.integers(0, 256, (n, 128), dtype=np.uint8)).to(dev)
    q4 = torch.from_numpy(rng.integers(0, 256, (nq, 128), dtype=np.uint8)).to(dev)
    db4[0], q4[0] = 0x88, 0x88  # -8 x -8, 256 times
    want = exp_int4.int4_dot_plain(q4, db4)
    assert int(want[0, 0]) == 256 * 64
    before = exp_int4.int4_dot.launches
    got = exp_int4.int4_dot(q4, db4)
    torch.cuda.synchronize()
    assert exp_int4.int4_dot.launches == before + 1
    assert torch.equal(got, want)
    for chunk in (exp_int4.CHUNK, 256):
        assert torch.equal(exp_int4.int4_probe(q4, db4, chunk), exp_int4.int4_probe_plain(q4, db4, chunk))


def test_time_ms_times_a_graph_replay_by_the_device_clock(dev):
    """``time_ms(graph=True)`` captures the calls once and replays them: the
    wrapper runs reps + 1 times in all (warm call, capture), the kernel
    reps more, and the reading is no larger than a host-paced one by much."""
    from iscc_search_tpu_torch.experiments import time_ms

    q_packed, min_lanes, _, db, _, block_ids = _case(dev, 256, seed=5)
    before = hs.gather_rescore.launches
    graph_ms = time_ms(lambda: hs.gather_rescore(q_packed, min_lanes, block_ids, db), dev, 10, graph=True)
    assert hs.gather_rescore.launches == before + 11
    host_ms = time_ms(lambda: hs.gather_rescore(q_packed, min_lanes, block_ids, db), dev, 10)
    assert 0.0 < graph_ms < 10 * host_ms


@pytest.mark.parametrize("nq", (8, 77))
def test_int4_kernels_equal_plain(dev, nq):
    """``csrc/int4_dot.cu``: the full dot and the probe against their plain
    versions and the int8 rows' dot."""
    n = 32768
    gen = torch.Generator(device=dev).manual_seed(nq)
    db_i8 = (torch.randint(0, 2, (n, 256), dtype=torch.int8, device=dev, generator=gen) * 2 - 1).to(torch.int8)
    q_i8 = db_i8[:nq].clone()
    q_i8[nq // 2 :, 192:] = 0
    q4, db4 = bitplane.build_int4_twin(q_i8), bitplane.build_int4_twin(db_i8)
    before = exp_int4.int4_dot.launches, exp_int4.int4_probe.launches
    full = exp_int4.int4_dot(q4, db4)
    probe = exp_int4.int4_probe(q4, db4)
    torch.cuda.synchronize()
    assert (exp_int4.int4_dot.launches, exp_int4.int4_probe.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(full, exp_int4.int4_dot_plain(q4, db4))
    assert torch.equal(full, exp_int4.int8_reference_dot(q_i8, db_i8))
    assert torch.equal(probe, exp_int4.int4_probe_plain(q4, db4))


def test_bitplane_kernels_equal_plain_and_blockmax(dev):
    """``csrc/blockmax_bitplane.cu``: both entries == plain; kernel 10's
    bf16 epilogue == ``blockmax`` on blocks with a valid row, kernel 11's
    int32 epilogue == ``blockmax`` everywhere."""
    n = 8192
    packed, valid, q_packed, min_lanes, q_scale = _experiment_case(dev, n, seed=10)
    q = masked_queries(q_packed, min_lanes, 256).to(torch.int8)
    popc = hs.blockmax(q_packed, min_lanes, q_scale, packed, valid)
    live = valid.bool().reshape(-1, 128).any(dim=1)
    twin = bitplane.bit_transpose_packed(packed)
    pen = bitplane.bitplane_penalty_perm(torch.where(valid.bool(), 0.0, -65536.0)).to(torch.bfloat16)[None, :]
    before = exp_bitplane_int8.blockmax_bitplane.launches
    got = exp_bitplane_int8.blockmax_bitplane(q, q_scale, twin, pen)
    torch.cuda.synchronize()
    assert exp_bitplane_int8.blockmax_bitplane.launches == before + 1
    assert torch.equal(got, exp_bitplane_int8.blockmax_bitplane_plain(q, q_scale, twin, pen))
    assert torch.equal(got[:, live], popc[:, live]) and not bool(live.all())
    for wb in (8, 16):
        twin = bitplane.build_twin(packed, wb)
        pen = exp_bitplane_u8.subword_penalty(valid, wb)
        before = exp_bitplane_u8.blockmax_subword.launches
        got = exp_bitplane_u8.blockmax_subword(q, q_scale, twin, pen, wb)
        torch.cuda.synchronize()
        assert exp_bitplane_u8.blockmax_subword.launches == before + 1
        assert torch.equal(got, exp_bitplane_u8.blockmax_subword_plain(q, q_scale, twin, pen, wb))
        assert torch.equal(got, popc)


@pytest.mark.parametrize("width", bitplane_layout.WIDTHS)
@pytest.mark.parametrize("general", (False, True))
@pytest.mark.parametrize("n, nq", [(32768, 77), (8192, 300)])
def test_bitplane_kernel_counts_its_paths_as_planned(dev, general, n, nq, width):
    """The kernel at each element width (32: kernel 10's bf16 epilogue; 16
    and 8: kernel 11's int32 one) on tombstone penalties (every block on the
    fast path) and on per-element ones (none but all-invalid blocks at 16
    and 8): == plain, and the blocks it counted on each path
    (``bitplane_path_blocks``) equal the plan's rule
    (``bitplane_layout.path_blocks``: every block once per query chunk)."""
    packed, valid, q_packed, min_lanes, q_scale = _experiment_case(dev, n, seed=n + nq, nq=nq)
    q = masked_queries(q_packed, min_lanes, 256).to(torch.int8)
    exp_bitplane_int8.bitplane_path_blocks(dev)  # cleared
    if width == 32:
        twin = bitplane.bit_transpose_packed(packed)
        pen = exp_bitplane_int8.bitplane_penalties(valid, general)
        got = exp_bitplane_int8.blockmax_bitplane(q, q_scale, twin, pen)
        want = exp_bitplane_int8.blockmax_bitplane_plain(q, q_scale, twin, pen)
        bits = pen.view(torch.int16)
    else:
        twin = bitplane.build_twin(packed, width)
        pen = exp_bitplane_u8.subword_penalty(valid, width, general)
        got = exp_bitplane_u8.blockmax_subword(q, q_scale, twin, pen, width)
        want = exp_bitplane_u8.blockmax_subword_plain(q, q_scale, twin, pen, width)
        bits = pen
    counted = exp_bitplane_int8.bitplane_path_blocks(dev)
    assert torch.equal(got, want)
    planned = bitplane_layout.path_blocks(bits.cpu().numpy(), nq, width)
    # Per-element int32 penalties keep -32768 on tombstones: an all-invalid
    # block (block 3) still takes the fast path, once per query chunk.
    dead = int((~valid.bool().reshape(-1, 128).any(dim=1)).sum()) * -(-nq // 256)
    assert counted == planned and planned[1] == (planned[0] if not general else dead if width < 32 else 0)


# ------------------------------------------------ the asset-level entry point


def _flip(rng, body, nbits):
    arr = np.frombuffer(body, np.uint8).copy()
    for p in rng.choice(len(arr) * 8, nbits, replace=False):
        arr[p // 8] ^= 1 << (p % 8)
    return arr.tobytes()


def test_hamming_index_on_card_equals_the_cpu_index(dev, tmp_path):
    from iscc_search_tpu_torch.engine import DeviceHammingIndex

    rng = np.random.default_rng(31)
    n = 20_000
    keys = [i.to_bytes(8, "big") + (i % 100).to_bytes(4, "big") + (100).to_bytes(4, "big") for i in range(n)]
    vecs = [rng.bytes(16) for _ in range(n)]
    for i in range(50):  # near-duplicates of row 0 at distinct distances
        vecs[1000 + i] = _flip(rng, vecs[0], i + 1)
    indexes = [DeviceHammingIndex(tmp_path / d, ndim=128, device=d) for d in ("cuda", "cpu")]
    for idx in indexes:
        idx.add(keys, vecs)
        idx.remove(keys[::64])
    queries = [vecs[0], vecs[5], vecs[777]] + [rng.bytes(16) for _ in range(60)]  # Q=63 (popc) and Q=3
    for count in (n, 40):
        for batch in (queries, queries[:3]):
            on_card, on_cpu = (idx.search(batch, count, return_rows=True) for idx in indexes)
            for (kc, sc, rc), (kp, sp, rp) in zip(on_card, on_cpu):
                assert np.array_equal(sc, sp)
                if count == n:  # no cut: the same rows (tie order aside)
                    assert sorted(zip(-sc, rc)) == sorted(zip(-sp, rp))
    for idx in indexes:
        idx.close()


def _assets(rng, n):
    from iscc_search_tpu_torch import codec as ic

    def unit(mtype, stype, body):
        header = ic.encode_header(mtype, stype, ic.VS.V0, ic.encode_length(mtype, len(body) * 8))
        return "ISCC:" + ic.encode_base32(header + body)

    out = []
    for i in range(n):
        src = out[i - 1] if i % 10 == 1 else None
        bodies = [rng.bytes(int(w)) for w in rng.choice([8, 16, 32], 3)]
        sps = [rng.bytes(16) for _ in range(30)]
        if src is not None:
            bodies = [_flip(rng, b, 1 + i % 5) for b in src["_bodies"]]
            sps = [_flip(rng, v, int(f)) for v, f in zip(src["_sps"], rng.integers(0, 9, 30))]
        out.append({
            "iscc_id": ic.gen_iscc_id_v1(timestamp_us=i + 1, server_id=i % 4096)["iscc"],
            "units": [unit(ic.MT.META, ic.ST.NONE, bodies[0]), unit(ic.MT.CONTENT, ic.ST_CC.TEXT, bodies[1]),
                      unit(ic.MT.DATA, ic.ST.NONE, bodies[2]), unit(ic.MT.INSTANCE, ic.ST.NONE, rng.bytes(8))],
            "simprints": {"CONTENT_TEXT_V0": [{"simprint": ic.encode_base64(v), "offset": c * 50, "size": 50}
                                              for c, v in enumerate(sps)]},
            "metadata": {"name": f"asset {i}"},
            "_bodies": bodies, "_sps": sps,
        })
    return out


def test_search_assets_on_card_equals_the_cpu_index(dev, tmp_path):
    """``TpuIndex`` on the card and on the CPU, filled alike: every search
    answers ``model_dump()``-identically (scan and exact, limits 5 and 50,
    concurrent requests through the batcher)."""
    import threading

    from iscc_search_tpu_torch.indexes.tpu import TpuIndex
    from iscc_search_tpu_torch.schema import IsccEntry, IsccQuery

    rng = np.random.default_rng(32)
    assets = _assets(rng, 600)
    entries = [IsccEntry(**{k: v for k, v in a.items() if not k.startswith("_")}) for a in assets]
    indexes = [TpuIndex(tmp_path / d, device=d) for d in ("cuda", "cpu")]
    for idx in indexes:
        for b in range(0, len(entries), 200):
            idx.add_assets(entries[b : b + 200])
    queries = []
    for i in (0, 10, 250, 591):
        sp = {"CONTENT_TEXT_V0": [s["simprint"] for s in assets[i]["simprints"]["CONTENT_TEXT_V0"]]}
        queries += [IsccQuery(units=assets[i]["units"]), IsccQuery(simprints=sp),
                    IsccQuery(units=assets[i]["units"][:2], simprints=sp), IsccQuery(iscc_id=assets[i]["iscc_id"])]
    for q in queries:
        for limit in (5, 50):
            for exact in (False, True):
                on_card, on_cpu = (idx.search_assets(q, limit=limit, exact=exact).model_dump() for idx in indexes)
                assert on_card == on_cpu
    want = [indexes[1].search_assets(q, limit=5).model_dump() for q in queries]
    got = [None] * len(queries)

    def client(j):
        got[j] = indexes[0].search_assets(queries[j], limit=5).model_dump()

    threads = [threading.Thread(target=client, args=(j,)) for j in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and got == want
    for idx in indexes:
        idx.close()


def test_the_batcher_searches_on_the_default_stream_of_its_thread(dev, tmp_path):
    """The batcher's collector thread calls ``index.search``; the search
    syncs the current stream of that thread, which is the device's default
    stream, where the search's kernels ran."""
    from iscc_search_tpu_torch.engine.batcher import SearchBatcher

    rng = np.random.default_rng(33)
    idx = DeviceNphdIndex(tmp_path / "i", device="cuda")
    bodies = [rng.bytes(32) for _ in range(3000)]
    idx.add(list(range(3000)), bodies)
    streams = []
    search = idx.search

    def spy(*args, **kwargs):
        streams.append(torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev))
        return search(*args, **kwargs)

    idx.search = spy
    batcher = SearchBatcher(idx, max_batch=64, window_ms=1.0)
    got = batcher.search(bodies[:20], 10)
    batcher.close()
    del idx.search
    want = idx.search(bodies[:20], 10)
    assert streams == [True]
    assert all(np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
    idx.close()


@pytest.mark.parametrize("k", [3, 10])
@pytest.mark.parametrize("queries_per_step", [1, 7])
def test_phase3_query_split_is_exact_on_the_card(dev, monkeypatch, queries_per_step, k):
    """Fault 3's repair on the card: phases 2-3 over slices of the queries
    give ``torch.equal`` results to the unsplit run, ties included. The
    slices hold fewer than 8,000 candidates per query and at most 77
    queries, where ``torch.topk`` on CUDA takes the same algorithm whatever
    the number of queries (its tie order depends on that choice)."""
    q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, 128, seed=9, cap=128 * 400, nq=77)
    args = (q_packed, min_lanes, q_scale, db, valid, k)
    monkeypatch.setattr(hs, "FUSED_MAX_CANDIDATES", 0)  # the chain, which alone splits the queries
    want = hs.blockmax_topk_impl(*args, phase1="popc")
    monkeypatch.setattr(hs, "PHASE3_BUDGET_BYTES", queries_per_step * k * hs.BLOCK * hs.PHASE3_ROW_BYTES)
    got = hs.blockmax_topk_impl(*args, phase1="popc")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------- phases 2-3 in one launch


def _select_case(dev, lanes, nblocks, seed, nq=512, live=None, planted=3):
    """(q_packed (Q, 8), min_lanes, q_scale, block_max, db, valid) on the
    card: random rows with tombstones, three blocks with no valid row and
    invalid padding (or only ``live`` valid rows), each query's code and
    one bit off it planted at ``planted`` rows (ties of maxima and scores
    at both cuts), queries of every length; phase 1 by ``blockmax``."""
    rng = np.random.default_rng(seed)
    cap = nblocks * 128
    db = rng.integers(0, 2**32, (cap, lanes), dtype=np.uint32)
    q, q_lanes = _random_codes(rng, nq)
    q_lanes[::5] = 1
    q[::5, 1:] = 0
    for qi in range(nq):
        at = rng.integers(0, cap, planted)
        db[at] = q[qi, :lanes]
        db[at[: planted // 2], 0] ^= 1
    valid = np.ones(cap, np.uint8)
    valid[::7] = 0
    dead = rng.choice(nblocks, min(3, nblocks - 1), replace=False)
    valid[(dead[:, None] * 128 + np.arange(128)).ravel()] = 0
    valid[cap - 61 :] = 0
    if live is not None:
        valid[:] = 0
        valid[rng.choice(cap, live, replace=False)] = 1
    q_packed = torch.from_numpy(q.view(np.int32)).to(dev)
    min_lanes, q_scale = query_prefix(torch.from_numpy(q_lanes).to(dev), lanes * 32)
    db_t = torch.from_numpy(db.view(np.int32)).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)
    return q_packed, min_lanes, q_scale, hs.blockmax(q_packed, min_lanes, q_scale, db_t, valid_t), db_t, valid_t


def _select_blocks(kk, shape):
    """Blocks of a partition of the named shape for ``kk`` candidate
    blocks: past the hierarchy's edge, at it (2 * kk super-blocks: flat),
    ragged, and fewer than a super-block."""
    return {"hierarchy": (2 * kk + 3) * 128, "edge": 2 * kk * 128, "ragged": (2 * kk + 1) * 128 + 37,
            "small": kk + 5}[shape]


@pytest.mark.parametrize("shape", ("hierarchy", "edge", "ragged", "small"))
@pytest.mark.parametrize("kk", (1, 16, hs.FUSED_MAX_CANDIDATES // hs.BLOCK))
@pytest.mark.parametrize("lanes", (2, 4, 6, 8))
def test_select_rescore_kernel_keeps_the_chains_contract(dev, lanes, kk, shape):
    """The kernel against the chain it replaces on the card, at Q = 1, 7,
    64 and 512, at the widest cut a scan makes (out_k = kk) and a narrower
    one: scores ``torch.equal``, every row distinct, valid and of its exact
    score, -1 exactly at NEG_SCORE; rows and scores equal the mirrored flow
    (``ops/select_layout.py``) on a sample of the queries, tie order
    included; one launch a call, the same output every call."""
    nblocks = _select_blocks(kk, shape)
    args = _select_case(dev, lanes, nblocks, seed=lanes * 1000 + kk * 10 + len(shape))
    host = [t.cpu().numpy() for t in args]
    for nq in (1, 7, 64, 512):
        part = [t[:nq] for t in args[:4]] + list(args[4:])
        for out_k in (kk, max(1, kk // 3)):
            before = hs.select_rescore_topk.launches
            got = hs.select_rescore_topk(*part, kk, out_k)
            again = hs.select_rescore_topk(*part, kk, out_k)
            torch.cuda.synchronize()
            assert hs.select_rescore_topk.launches == before + 2
            assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
            want = hs.select_rescore_topk_plain(*part, kk, out_k)
            select_layout.check_contract(*got, want[0], *part[:3], *args[4:])
            sample = min(nq, 16)
            mirror = select_layout.select_rescore(*(h[:sample] for h in host[:4]), *host[4:], kk, out_k)
            np.testing.assert_array_equal(got[0][:sample].cpu().numpy(), mirror[0])
            np.testing.assert_array_equal(got[1][:sample].cpu().numpy(), mirror[1])


@pytest.mark.parametrize("live", (0, 5, 40))
def test_select_rescore_kernel_with_fewer_valid_rows_than_the_cut(dev, live):
    """A partition of 0, 5 or 40 valid rows, kk = 16 of 300 blocks (flat)
    and of 5,000 (the hierarchy), cut at 16 and at every candidate: the
    valid rows first, then NEG_SCORE and -1; the chain's contract where
    the candidates hold every valid row, and the mirrored flow's rows."""
    for nblocks in (300, 5000):
        args = _select_case(dev, 4, nblocks, seed=live + nblocks, nq=64, live=live)
        for out_k in (16, 16 * 128):
            got = hs.select_rescore_topk(*args, 16, out_k)
            want = hs.select_rescore_topk_plain(*args, 16, out_k)
            torch.cuda.synchronize()
            if out_k == 16 or live <= 16:  # else the cut passes the top 16 rows, which alone are exact
                select_layout.check_contract(*got, want[0], *args[:3], *args[4:])
            assert int((got[1] >= 0).sum(dim=1).max()) <= live
            mirror = select_layout.select_rescore(*(t[:8].cpu().numpy() for t in args[:4]),
                                                  *(t.cpu().numpy() for t in args[4:]), 16, out_k)
            np.testing.assert_array_equal(got[1][:8].cpu().numpy(), mirror[1])


def test_scans_take_the_fused_route_by_shape(dev):
    """``blockmax_topk_impl`` on the card: k = 16 takes one launch of the
    kernel (``by_route`` "fused"), k = 512 the chain (``gather_rescore``),
    and both answer the plain CPU scan's scores."""
    q_packed, min_lanes, q_scale, _, db, valid = _select_case(dev, 4, 1024, seed=3, nq=77)
    for k, route in ((16, "fused"), (512, "chain")):
        before = dict(hs.select_rescore_topk.by_route), hs.select_rescore_topk.launches, hs.gather_rescore.launches
        got = hs.blockmax_topk_impl(q_packed, min_lanes, q_scale, db, valid, k)
        torch.cuda.synchronize()
        assert hs.select_rescore_topk.by_route == {**before[0], route: before[0][route] + 1}
        assert hs.select_rescore_topk.launches - before[1] == (route == "fused")
        assert hs.gather_rescore.launches - before[2] == (route == "chain")
        cpu = [t.cpu() for t in (q_packed, min_lanes, q_scale, db, valid)]
        want = hs.blockmax_topk_impl(*cpu, k)
        assert torch.equal(got[0].cpu(), want[0])


def test_the_store_builds_from_its_own_source_on_the_card_host():
    """The port's host store compiles from ``native/store.cpp`` with g++
    into ``build/`` (the card's host has g++ for nvcc) and round-trips."""
    import tempfile

    from iscc_search_tpu_torch.store import HostStore, kv

    lib = kv._build_library()
    assert lib.is_file() and lib.parent.parent == kv.BUILD_ROOT
    with tempfile.TemporaryDirectory() as tmp:
        store = HostStore(tmp + "/s")
        store.dup_putmulti("d", [(b"k", b"v2"), (b"k", b"v1")])
        store.put("p", b"a", b"b")
        assert store.get_dups("d", b"k") == [b"v1", b"v2"] and store.get("p", b"a") == b"b"
        store.close()


# ------------------------------------------------------------- the mesh path


def _mesh(dev, n):
    from iscc_search_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[dev] * n)


def test_meshes_over_cuda_devices(dev):
    """``make_mesh`` takes the first CUDA devices and raises past
    ``torch.cuda.device_count()``; a mesh on the card refuses a CPU index."""
    from iscc_search_tpu_torch.parallel import make_mesh, make_mesh_2d

    assert make_mesh(1).devices == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="only"):
        make_mesh(torch.cuda.device_count() + 1)
    assert make_mesh_2d(1).shape == {"dcn": 1, "ici": torch.cuda.device_count()}
    with pytest.raises(ValueError, match="the mesh's shards are on"):
        DeviceNphdIndex(device="cpu", mesh=_mesh(dev, 2))


@pytest.mark.parametrize("nq", (1, 40, 300))
def test_sharded_engine_on_card_equals_the_cpu_index(dev, nq):
    """4 shards on the card: every shard's scan launches its phase-1 kernel
    and ``select_rescore_topk`` on the card, the merged answers stay there, and
    the scores equal the CPU index's (plain versions, no mesh); every row
    carries its brute-force score."""
    rng = np.random.default_rng(17)
    gpu, cpu, codes, lanes, valid = _engine_pair(rng, 30000, mesh=_mesh(dev, 4))
    parts = gpu._sync_device()
    assert all(len(p.packed_dev) == 4 and all(t.device == dev for t in p.packed_dev) for p in parts.values())
    q_rows = rng.integers(0, 30000, nq)
    bodies = [codes[i, : lanes[i]].astype(">u4").tobytes() for i in q_rows]
    phase1, fused = sum(fn.launches for fn in hs.PHASE1.values()), hs.select_rescore_topk.launches
    res_gpu = gpu.search(bodies, 10)
    assert sum(fn.launches for fn in hs.PHASE1.values()) == phase1 + 4 * len(parts)
    assert hs.select_rescore_topk.launches == fused + 4 * len(parts)
    ref = nphd_scores(
        torch.from_numpy(codes[q_rows].view(np.int32)), torch.from_numpy(lanes[q_rows]),
        torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lanes), torch.from_numpy(valid),
    ).numpy()
    for qi, ((kg, sg), (_, sc)) in enumerate(zip(res_gpu, cpu.search(bodies, 10))):
        np.testing.assert_array_equal(np.sort(sg), np.sort(sc))
        rows = kg.view(">u8").ravel().astype(np.int64)
        assert valid[rows].all()
        np.testing.assert_allclose(ref[qi, rows], sg, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nbits", WIDTHS)
def test_sharded_twin_route_launches_kernel_4_per_shard(dev, nbits):
    """``sharded_pallas_topk`` on 4 shards of the card: kernel 4
    (``blockmax_mma_unpacked``) and ``select_rescore_topk`` once per shard, the
    result ``torch.equal`` to the popc route per shard + the same merge on
    the card, and its scores to the same call on CPU shards (plain versions)."""
    from iscc_search_tpu_torch.parallel.merge import lift_rows, merge_topk
    from iscc_search_tpu_torch.parallel.pallas_sharded import shard_unpacked_db, sharded_pallas_topk
    from iscc_search_tpu_torch.parallel.pm1_sharded import shard_pm1_database

    q_packed, min_lanes, q_scale, db, valid, _ = _case(dev, nbits, seed=nbits + 5, cap=128 * 64)
    outs = []
    for where in (dev, torch.device("cpu")):
        mesh = _mesh(where, 4)
        packed, shards_valid = shard_pm1_database(mesh, db.to(where), valid.to(where))
        twin = shard_unpacked_db(mesh, packed, nbits)
        query = (q_packed.to(where), min_lanes.to(where), q_scale.to(where))
        before = hs.blockmax_mma_unpacked.launches, hs.select_rescore_topk.launches
        outs.append(sharded_pallas_topk(mesh, *query, packed, twin, shards_valid, 10, nbits, merge_k=16))
        launched = hs.blockmax_mma_unpacked.launches - before[0], hs.select_rescore_topk.launches - before[1]
        assert launched == ((4, 4) if where.type == "cuda" else (0, 0))
        assert outs[-1][0].device == where
        if where.type == "cuda":
            parts = [hs.blockmax_topk_impl(*query, packed[i], shards_valid[i], 10) for i in range(4)]
            want = merge_topk([s for s, _ in parts], [lift_rows(r, len(packed[i]), i) for i, (_, r) in enumerate(parts)],
                              mesh, 16)
            assert torch.equal(outs[-1][0], want[0]) and torch.equal(outs[-1][1], want[1])
    assert torch.equal(outs[0][0].cpu(), outs[1][0])


@pytest.mark.parametrize("nq", (1, 40, 300))
def test_pallas_mesh_equals_the_auto_mesh_and_xla_routes_as_auto(dev, nq):
    """4 shards of the card under ``scan_kernel="pallas"``: every partition
    carries the int8 twin per shard, kernel 4's block maxima from it are
    ``torch.equal`` to the ``"auto"`` mesh's phase 1 on the packed shards,
    a search launches kernel 4 and ``select_rescore_topk`` once per shard
    and partition and no other phase-1 kernel, and its answers equal the
    ``"auto"`` mesh's by score multiset. ``"xla"`` (on the mesh and on one
    device) launches what ``"auto"`` does, the kernel ``auto_phase1`` names
    and ``select_rescore_topk`` once per shard and partition, and answers
    the same."""
    from iscc_search_tpu_torch.engine.device_index import auto_phase1
    from iscc_search_tpu_torch.ops.packing import pack_codes

    rng = np.random.default_rng(23)
    n = 30000
    codes, lanes = _random_codes(rng, n)
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    made = {name: DeviceNphdIndex(device="cuda", **kwargs) for name, kwargs in (
        ("auto", {"mesh": _mesh(dev, 4)}), ("pallas", {"mesh": _mesh(dev, 4), "scan_kernel": "pallas"}),
        ("xla", {"mesh": _mesh(dev, 4), "scan_kernel": "xla"}), ("xla_one", {"scan_kernel": "xla"}))}
    for idx in made.values():
        idx.add_packed(keys, codes, lanes)
        idx.remove(list(range(0, n, 9)))
    auto_parts, twin_parts = made["auto"]._sync_device(), made["pallas"]._sync_device()
    q_rows = rng.integers(0, n, nq)
    bodies = [codes[i, : lanes[i]].astype(">u4").tobytes() for i in q_rows]
    q_codes, q_lanes = pack_codes(bodies)
    q_packed = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    q_lanes_dev = torch.from_numpy(q_lanes).to(dev)
    for lv, auto_part in auto_parts.items():
        twin_part = twin_parts[lv]
        assert len(twin_part.unpacked_dev) == 4
        min_lanes, q_scale = query_prefix(q_lanes_dev, lv * 32)
        for i in range(4):
            assert torch.equal(auto_part.packed_dev[i], twin_part.packed_dev[i])
            twin_bm = hs.blockmax_mma_unpacked(q_packed, min_lanes, q_scale, twin_part.unpacked_dev[i], twin_part.valid_dev[i])
            auto_bm = hs.PHASE1[auto_phase1(nq, lv)](q_packed, min_lanes, q_scale, auto_part.packed_dev[i],
                                                     auto_part.valid_dev[i])
            assert torch.equal(twin_bm, auto_bm)
    want = made["auto"].search(bodies, 10)

    def counts():
        return {name: fn.launches for name, fn in (*hs.PHASE1.items(), ("select", hs.select_rescore_topk))}

    for name, idx in made.items():
        if name == "auto":
            continue
        before = counts()
        got = idx.search(bodies, 10)
        torch.cuda.synchronize()
        launched = {key: counts()[key] - before[key] for key in before}
        shards = 1 if name == "xla_one" else 4
        want_launched = dict.fromkeys(launched, 0)
        for lv in auto_parts:
            want_launched["mma_twin" if name == "pallas" else auto_phase1(nq, lv)] += shards
            want_launched["select"] += shards
        assert launched == want_launched
        for (_, sg), (_, sw) in zip(got, want):
            np.testing.assert_array_equal(np.sort(sg), np.sort(sw))
