"""TPU kernels 4-7 of ``iscc_search_tpu/ops/pallas_scan.py`` against their
counterparts in ``iscc_search_tpu_torch`` (CPU; the Pallas kernels run in
interpret mode, the port's wrappers take their plain versions).

- kernel 4 ``_scan_kernel_unpacked`` (int8 twin) <-> ``blockmax_mma_unpacked``
  (plain: ``blockmax_unpacked_plain``);
- kernels 5 ``_scan_kernel_packed`` and 6 ``_scan_kernel_packed_perm``
  (packed rows, in-kernel unpack) <-> ``blockmax_mma_packed`` (plain:
  ``blockmax_plain``);
- kernel 7 ``_gather_rescore_packed_kernel`` <-> ``gather_rescore`` (plain:
  ``gather_rescore_plain``), once its columns are put back in row order;
- the int8-twin route ``pallas_blockmax_topk_impl(unpacked=True)`` <->
  ``blockmax_topk_impl(unpacked=True)``.

Inputs are made with numpy from fixed seeds (n = 8192 rows, chunks of
4096). Tolerances: kernels 4, 5 and 7 and the twin are bit-exact (kernels 4
and 5 add the validity penalty in f32, as the port does, so all-invalid
blocks agree too); kernel 6 adds it in bf16, so only blocks with a valid row
are bit-exact and all-invalid blocks lie below NEG_SCORE on both sides; a
top-k has the same score multiset and every returned row carries its
brute-force score (``test_torch_ops._assert_topk_parity``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iscc_search_tpu.ops import pallas_scan as jax_pallas
from iscc_search_tpu.ops import pm1_scan as jax_pm1
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import pm1_scan
from tests.test_torch_ops import WIDTHS, _assert_blockmax_parity, _assert_topk_parity, _brute_force, _partition, _t

CHUNK = 4096


def _prep(nbits, n=8192, n_live=None):
    """A partition (tombstones, a dead block, invalid padding) and 13
    queries of every length, for both packages."""
    packed, valid, q_codes, q_lanes = _partition(nbits, n=n, n_live=n_live)
    q_pm1, q_scale = jax_pm1.prepare_queries_impl(jnp.asarray(q_codes), jnp.asarray(q_lanes), nbits)
    min_lanes, scale = pm1_scan.query_prefix(_t(q_lanes), nbits)
    return packed, valid, q_codes, q_lanes, (q_pm1, q_scale), (_t(q_codes), min_lanes, scale)


@pytest.mark.parametrize("nbits", WIDTHS)
def test_build_unpacked_db_equals_jax(monkeypatch, nbits):
    monkeypatch.setattr(hs, "UNPACK_CHUNK_ROWS", CHUNK)  # two chunks
    packed, *_ = _partition(nbits)
    got = hs.build_unpacked_db(_t(packed), nbits)
    assert got.dtype == torch.int8 and got.shape == (len(packed), nbits)
    want = np.asarray(jax_pallas.build_unpacked_db(jnp.asarray(packed), nbits, chunk_rows=CHUNK, permute=False))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbits", WIDTHS)
def test_mma_unpacked_plain_equals_kernel_4(nbits):
    """``_scan_kernel_unpacked``: bit-exact, all-invalid blocks included."""
    packed, valid, _, _, (q_pm1, q_scale), port_q = _prep(nbits)
    twin = hs.build_unpacked_db(_t(packed), nbits)
    launches = hs.blockmax_mma_unpacked.launches
    got = hs.blockmax_mma_unpacked(*port_q, twin, _t(valid)).numpy()
    assert hs.blockmax_mma_unpacked.launches == launches  # the CPU takes the plain version
    np.testing.assert_array_equal(got, hs.blockmax_unpacked_plain(*port_q, twin, _t(valid)).numpy())
    want = jax_pallas.pallas_blockmax(
        q_pm1, q_scale, jnp.asarray(twin.numpy()), jnp.asarray(valid), nbits,
        chunk_size=CHUNK, interpret=True, unpacked=True,
    )
    assert not valid[256:384].any() and got.shape == (13, len(packed) // 128)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[:3].max(axis=1), 1.0)  # exact matches


@pytest.mark.parametrize("nbits", WIDTHS)
def test_mma_packed_plain_equals_kernel_5(nbits):
    """``_scan_kernel_packed`` (the default layout): bit-exact, all-invalid
    blocks included."""
    packed, valid, _, _, (q_pm1, q_scale), port_q = _prep(nbits)
    launches = hs.blockmax_mma_packed.launches
    got = hs.blockmax_mma_packed(*port_q, _t(packed), _t(valid)).numpy()
    assert hs.blockmax_mma_packed.launches == launches
    want = jax_pallas.pallas_blockmax(
        q_pm1, q_scale, jnp.asarray(packed), jnp.asarray(valid), nbits, chunk_size=CHUNK, interpret=True
    )
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("nbits", (64, 128, 256))
def test_mma_packed_plain_matches_kernel_6(nbits):
    """``_scan_kernel_packed_perm`` over the ``permute_packed_rows`` view
    (lanes | 128): the port reads the rows unpermuted and gives the same
    block maxima in block order; bf16 penalty, so the parity rule."""
    packed, valid, _, _, (q_pm1, q_scale), port_q = _prep(nbits)
    got = hs.blockmax_mma_packed(*port_q, _t(packed), _t(valid)).numpy()
    perm = jax_pallas.permute_packed_rows(jnp.asarray(packed), nbits // 32)
    want = jax_pallas.pallas_blockmax(
        q_pm1, q_scale, perm, jnp.asarray(valid), nbits, chunk_size=CHUNK, interpret=True, packed_perm=True
    )
    _assert_blockmax_parity(got, np.asarray(want), valid)


def test_gather_rescore_plain_equals_kernel_7():
    """``_gather_rescore_packed_kernel`` (256-bit only) returns each block's
    rows in ``gather_perm_offsets`` order; reordered, bit-exact."""
    packed, _, _, _, (q_pm1, _), port_q = _prep(256)
    kk = 5
    block_ids = np.random.default_rng(7).integers(0, len(packed) // 128, (13, kk)).astype(np.int32)
    got = hs.gather_rescore(port_q[0], port_q[1], torch.from_numpy(block_ids), _t(packed)).numpy()
    want = jax_pallas.pallas_gather_rescore_packed(
        q_pm1, jnp.asarray(block_ids), jnp.asarray(packed), kk, 256, interpret=True
    )
    perm = jax_pallas.gather_perm_offsets()
    np.testing.assert_array_equal(got.reshape(13, kk, 128)[:, :, perm], np.asarray(want).reshape(13, kk, 128))


@pytest.mark.parametrize("nbits,n,k", [(64, 8192, 10), (128, 8192, 16), (192, 8192, 7), (256, 1024, 10)])
def test_twin_route_matches_pallas_and_brute_force(nbits, n, k):
    """The int8-twin route of both packages (phase 1 from the twin, kernel 4
    on the TPU side, no perm twin): non-power-of-two k and, at n=1024,
    total_blocks (8) < k."""
    packed, valid, q_codes, q_lanes, (q_pm1, q_scale), port_q = _prep(nbits, n=n, n_live=n - 40)
    twin = hs.build_unpacked_db(_t(packed), nbits)
    got_s, got_i = hs.blockmax_topk_impl(*port_q, _t(packed), _t(valid), k, db_unpacked=twin, unpacked=True)
    assert got_s.shape == got_i.shape == (13, k) and got_i.dtype == torch.int32
    no_twin = hs.blockmax_topk_impl(*port_q, _t(packed), _t(valid), k)
    assert torch.equal(got_s, no_twin[0]) and torch.equal(got_i, no_twin[1])
    want_s, want_i = jax_pallas.pallas_blockmax_topk_impl(
        q_pm1, q_scale, jnp.asarray(packed), jnp.asarray(valid), k, nbits,
        chunk_size=min(n, CHUNK), interpret=True, db_unpacked=jnp.asarray(twin.numpy()), unpacked=True,
    )
    full = np.zeros((n, 8), np.uint32)
    full[:, : nbits // 32] = packed
    ref = _brute_force(q_codes, q_lanes, full, np.full(n, nbits // 32, np.int32), valid)
    _assert_topk_parity(got_s.numpy(), got_i.numpy(), np.asarray(want_s), np.asarray(want_i), ref)
    np.testing.assert_allclose(np.sort(got_s.numpy(), axis=1)[:, ::-1], -np.sort(-ref, axis=1)[:, :k], rtol=0, atol=1e-6)


def test_twin_route_without_a_twin_raises():
    packed, valid, _, q_lanes, (q_pm1, q_scale), port_q = _prep(128, n=1024)
    with pytest.raises(ValueError, match="unpacked=True requires db_unpacked"):
        hs.blockmax_topk_impl(*port_q, _t(packed), _t(valid), 10, unpacked=True)
    with pytest.raises(ValueError, match="unpacked=True requires db_unpacked"):
        hs.blockmax_topk_packedq_impl(port_q[0], _t(q_lanes), _t(packed), _t(valid), 10, 128, unpacked=True)
    with pytest.raises(ValueError, match="unpacked=True requires db_unpacked"):
        jax_pallas.pallas_blockmax_topk_impl(
            q_pm1, q_scale, jnp.asarray(packed), jnp.asarray(valid), 10, 128, interpret=True, unpacked=True
        )
