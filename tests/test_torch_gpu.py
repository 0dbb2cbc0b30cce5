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
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.nphd import nphd_scores
from iscc_search_tpu_torch.ops.pm1_scan import query_prefix

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
    launches = hs.blockmax.launches, hs.gather_rescore.launches
    res_gpu = gpu.search(bodies, 10)
    assert hs.blockmax.launches > launches[0] and hs.gather_rescore.launches > launches[1]
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
