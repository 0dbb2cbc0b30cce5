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
from iscc_search_tpu_torch.experiments import exp_bitplane_int8, exp_bitplane_u8, exp_int4, exp_kernels
from iscc_search_tpu_torch.ops import bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs
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


def test_kernels_take_a_strided_query_matrix(dev):
    """q_packed wider than the partition (the engine passes (Q, 8) queries
    to every partition): the kernels read only the first ``lanes`` words."""
    q_packed, min_lanes, q_scale, db, valid, block_ids = _case(dev, 64, seed=3)
    assert q_packed.shape[1] == 8 and db.shape[1] == 2
    narrow = q_packed[:, :2].contiguous()
    for phase1 in (hs.blockmax, hs.blockmax_mma_packed):
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
    launches = sum(fn.launches for fn in hs.PHASE1.values()), hs.gather_rescore.launches
    res_gpu = gpu.search(bodies, 10)
    assert sum(fn.launches for fn in hs.PHASE1.values()) == launches[0] + 4
    assert hs.gather_rescore.launches == launches[1] + 4
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
@pytest.mark.parametrize("scan_kernel", ("auto", "mma", "popc"))
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


@pytest.mark.parametrize("scan_kernel", ("mma", "popc"))
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


@pytest.mark.parametrize("name", exp_kernels.NAMES)
def test_variant_kernel_equals_plain(dev, name):
    """Every kernel-8 variant of ``csrc/blockmax_variants.cu``: kernel ==
    plain at two chunks, Q=77, short prefixes, tombstones, a dead block."""
    n = 32768
    packed, valid, q_packed, min_lanes, q_scale = _experiment_case(dev, n, seed=8)
    db = hs.build_unpacked_db(packed, 256)
    q = masked_queries(q_packed, min_lanes, 256).to(torch.int8)
    fn, orient = exp_kernels.make_variant(name, n, q.shape[0])
    pen = torch.where(valid.bool(), 0.0, -65536.0).to(torch.bfloat16)
    pen = valid[None, :] if name == "u8max" else (pen[:, None] if orient == "col" else pen[None, :])
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
