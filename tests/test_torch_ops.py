"""The ops of ``iscc_search_tpu_torch`` against their JAX counterparts in
``iscc_search_tpu`` (CPU; the JAX Pallas kernels run in interpret mode).

Inputs are made with numpy from fixed seeds and handed to both packages.
Parity rule:

- query prep, the ±1 unpack and phase-3 dots are bit-exact;
- phase-1 block maxima are bit-exact for every 128-row block holding at
  least one valid row; for a block with none, both sides lie below
  NEG_SCORE (the JAX kernels round that penalty sum in bf16, each its own
  way, while the port keeps it in f32);
- a top-k has the same score multiset per query as the JAX function, and
  every returned row carries its brute-force NPHD score; the order of
  tied rows is not compared (``torch.topk`` and ``lax.top_k`` break ties
  differently).
"""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iscc_search_tpu.ops import nphd as jax_nphd
from iscc_search_tpu.ops import packing as jax_packing
from iscc_search_tpu.ops import pallas_scan as jax_pallas
from iscc_search_tpu.ops import pm1_scan as jax_pm1
from iscc_search_tpu_torch.ops import _build, packing, pm1_scan
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.nphd import NEG_SCORE, nphd_scores, popcount32

REPO = Path(__file__).resolve().parents[1]
WIDTHS = (64, 128, 192, 256)


def _t(a):
    """numpy -> torch; uint32 codes travel as their int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.bool_:
        a = a.view(np.uint8)
    return torch.from_numpy(a.copy())


def _codes(rng, n, lane_choices=(2, 4, 6, 8)):
    """(n, 8) uint32 codes zeroed past each row's length, (n,) int32 lanes."""
    lanes = rng.choice(np.asarray(lane_choices, np.int32), n).astype(np.int32)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    return codes, lanes


def _partition(nbits, n=8192, n_live=None, seed=0):
    """A (n, lanes) partition with tombstones, one dead block and invalid
    padding rows past ``n_live``, plus 13 queries of every length."""
    rng = np.random.default_rng(seed + nbits)
    lanes = nbits // 32
    packed = rng.integers(0, 2**32, (n, lanes), dtype=np.uint32)
    valid = np.zeros(n, bool)
    valid[: n - 300 if n_live is None else n_live] = True
    valid[rng.integers(0, n, n // 20)] = False
    valid[128 * 2 : 128 * 3] = False
    q_codes, q_lanes = _codes(rng, 13)
    q_codes[:3, :lanes] = packed[[5 % n, 700 % n, 1500 % n]]  # exact matches
    q_lanes[:3] = lanes
    return packed, valid, q_codes, q_lanes


def _assert_blockmax_parity(got, want, valid):
    has_valid = valid.reshape(-1, 128).any(axis=1)
    np.testing.assert_array_equal(got[:, has_valid], want[:, has_valid])
    assert (got[:, ~has_valid] < NEG_SCORE).all() and (want[:, ~has_valid] < NEG_SCORE).all()


def _brute_force(q_codes, q_lanes, codes, lanes, valid):
    return nphd_scores(_t(q_codes), _t(q_lanes), _t(codes), _t(lanes), _t(valid)).numpy()


def _assert_topk_parity(got_s, got_i, want_s, want_i, ref):
    """Same score multiset per query; each returned row carries its
    brute-force score ``ref[q, row]``; -1 exactly where the score is NEG."""
    np.testing.assert_array_equal(np.sort(got_s, axis=1), np.sort(want_s, axis=1))
    for s, i in ((got_s, got_i), (want_s, want_i)):
        np.testing.assert_array_equal(i < 0, s <= NEG_SCORE)
        q, r = np.nonzero(i >= 0)
        np.testing.assert_allclose(ref[q, i[q, r]], s[q, r], rtol=0, atol=1e-6)


# ------------------------------------------------------------- host + prep


def test_packing_equals_jax_package():
    rng = np.random.default_rng(1)
    bodies = [rng.integers(0, 256, 8 * rng.integers(1, 5), dtype=np.uint8).tobytes() for _ in range(200)]
    for max_lanes in (8, 6):
        fit = [b for b in bodies if len(b) <= 4 * max_lanes]
        got, want = packing.pack_codes(fit, max_lanes), jax_packing.pack_codes(fit, max_lanes)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for body in bodies[:20]:
        lanes, n = packing.pack_code(body)
        assert (lanes.tolist(), n) == (jax_packing.pack_code(body)[0].tolist(), jax_packing.pack_code(body)[1])
        assert packing.unpack_code(lanes, n) == jax_packing.unpack_code(lanes, n) == body
    for bad in (b"", b"abc", bytes(36)):
        with pytest.raises(ValueError):
            packing.pack_codes([bad])


@pytest.mark.parametrize("nbits", WIDTHS)
def test_unpack_pm1_equals_jax(nbits):
    codes, _ = _codes(np.random.default_rng(nbits), 64)
    got = pm1_scan.unpack_pm1(_t(codes), nbits).numpy()
    want = np.asarray(jax_pm1.unpack_pm1(jnp.asarray(codes), nbits, jnp.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pm1_scan.unpack_pm1_np(codes, nbits), jax_pm1.unpack_pm1_np(codes, nbits))


@pytest.mark.parametrize("nbits", WIDTHS)
def test_prepare_queries_equal_jax_bit_for_bit(nbits):
    codes, lanes = _codes(np.random.default_rng(nbits + 7), 40)
    q_pm1, q_scale = pm1_scan.prepare_queries_impl(_t(codes), _t(lanes), nbits)
    j_pm1, j_scale = jax_pm1.prepare_queries_impl(jnp.asarray(codes), jnp.asarray(lanes), nbits)
    np.testing.assert_array_equal(q_pm1.numpy(), np.asarray(j_pm1))
    assert q_scale.numpy().tobytes() == np.asarray(j_scale).tobytes()
    h_pm1, h_scale = pm1_scan.prepare_queries(codes, lanes, nbits)
    w_pm1, w_scale = jax_pm1.prepare_queries(codes, lanes, nbits)
    np.testing.assert_array_equal(h_pm1, w_pm1)
    assert h_scale.tobytes() == w_scale.tobytes() == q_scale.numpy().tobytes()
    min_lanes, scale = pm1_scan.query_prefix(_t(lanes), nbits)
    np.testing.assert_array_equal(min_lanes.numpy(), np.minimum(lanes, nbits // 32))
    assert scale.numpy().tobytes() == q_scale.numpy().tobytes()


def test_nphd_scores_equal_jax():
    rng = np.random.default_rng(3)
    codes, lanes = _codes(rng, 300)
    q_codes, q_lanes = _codes(rng, 9)
    valid = rng.random(300) > 0.2
    got = nphd_scores(_t(q_codes), _t(q_lanes), _t(codes), _t(lanes), _t(valid)).numpy()
    want = np.asarray(
        jax_nphd.nphd_scores(
            jnp.asarray(q_codes), jnp.asarray(q_lanes), jnp.asarray(codes), jnp.asarray(lanes), jnp.asarray(valid)
        )
    )
    np.testing.assert_array_equal(got, want)
    words = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    np.testing.assert_array_equal(popcount32(_t(words)).numpy(), np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1))


@pytest.mark.parametrize("nb,k", [(128 * 40, 16), (128 * 20, 16), (1000, 10), (5, 10)])
def test_topk_blocks_hier_selects_the_jax_blocks(nb, k):
    """Hierarchical (nb=5120), flat (few super-blocks), ragged and
    fewer-blocks-than-k branches; distinct maxima, so the sets agree."""
    bm = np.random.default_rng(nb).permutation(7 * nb)[: 3 * nb].reshape(3, nb).astype(np.float32)
    got = pm1_scan.topk_blocks_hier(torch.from_numpy(bm), k).numpy()
    want = np.asarray(jax_pm1.topk_blocks_hier(jnp.asarray(bm), k))
    assert got.shape == want.shape == (3, min(k, nb))
    np.testing.assert_array_equal(np.sort(got, axis=1), np.sort(want, axis=1))


def test_segmented_unpack_dots_equal_jax():
    rng = np.random.default_rng(4)
    packed = rng.integers(0, 2**32, (4096, 6), dtype=np.uint32)
    q_codes, q_lanes = _codes(rng, 5)
    rows = rng.integers(0, 4096, (5, 3000)).astype(np.int32)
    q_pm1, _ = pm1_scan.prepare_queries(q_codes, q_lanes, 192)
    got = pm1_scan.segmented_unpack_dots(torch.from_numpy(q_pm1), _t(packed), torch.from_numpy(rows).long(), 192)
    want = jax_pm1.segmented_unpack_dots(
        jnp.asarray(q_pm1, jnp.bfloat16), jnp.asarray(packed), jnp.asarray(rows), 192, jnp.bfloat16, jnp.float32
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nbits,k", [(64, 10), (256, 10), (128, 3)])
def test_pm1_blockmax_topk_impl_equals_jax(nbits, k):
    packed, valid, q_codes, q_lanes = _partition(nbits, n=4096)
    q_pm1, q_scale = pm1_scan.prepare_queries(q_codes, q_lanes, nbits)
    got = pm1_scan.pm1_blockmax_topk_impl(
        torch.from_numpy(q_pm1), torch.from_numpy(q_scale), _t(packed), _t(valid), k, nbits, chunk_size=1024
    )
    want = jax_pm1.pm1_blockmax_topk_impl(
        jnp.asarray(q_pm1), jnp.asarray(q_scale), jnp.asarray(packed), jnp.asarray(valid), k, nbits, chunk_size=1024
    )
    full = np.zeros((len(packed), 8), np.uint32)
    full[:, : nbits // 32] = packed
    ref = _brute_force(q_codes, q_lanes, full, np.full(len(packed), nbits // 32, np.int32), valid)
    _assert_topk_parity(got[0].numpy(), got[1].numpy(), np.asarray(want[0]), np.asarray(want[1]), ref)


# ------------------------------------------------------------ the kernels


def _jax_blockmax(nbits, packed, valid, q_codes, q_lanes):
    """Kernel 1 (bitplane, 128/256-bit) or 2 (perm, 64/192-bit), as the
    JAX engine routes them, in interpret mode."""
    q_pm1, q_scale = jax_pm1.prepare_queries_impl(jnp.asarray(q_codes), jnp.asarray(q_lanes), nbits)
    if nbits in (128, 256):
        db, flags = jax_pallas.bit_transpose_packed(jnp.asarray(packed)), {"bitplane": True}
    else:
        db = jax_pallas.build_unpacked_db(jnp.asarray(packed), nbits, permute=True)
        flags = {"unpacked": True, "permuted": True}
    out = jax_pallas.pallas_blockmax(
        q_pm1, q_scale, db, jnp.asarray(valid), nbits, chunk_size=4096, interpret=True, **flags
    )
    return np.asarray(out)


@pytest.mark.parametrize("nbits", WIDTHS)
def test_blockmax_plain_matches_pallas_kernels(nbits):
    packed, valid, q_codes, q_lanes = _partition(nbits)
    min_lanes, q_scale = pm1_scan.query_prefix(_t(q_lanes), nbits)
    launches = hs.blockmax.launches
    got = hs.blockmax(_t(q_codes), min_lanes, q_scale, _t(packed), _t(valid)).numpy()
    assert hs.blockmax.launches == launches  # the CPU takes the plain version
    want = _jax_blockmax(nbits, packed, valid, q_codes, q_lanes)
    assert got.shape == want.shape == (13, len(packed) // 128)
    _assert_blockmax_parity(got, want, valid)
    np.testing.assert_array_equal(got[:3].max(axis=1), 1.0)  # exact matches


@pytest.mark.parametrize("nbits", WIDTHS)
def test_gather_rescore_plain_equals_pallas_kernel(nbits):
    packed, _, q_codes, q_lanes = _partition(nbits)
    kk = 5
    block_ids = np.random.default_rng(nbits).integers(0, len(packed) // 128, (13, kk)).astype(np.int32)
    min_lanes, _ = pm1_scan.query_prefix(_t(q_lanes), nbits)
    launches = hs.gather_rescore.launches
    got = hs.gather_rescore(_t(q_codes), min_lanes, torch.from_numpy(block_ids), _t(packed)).numpy()
    assert hs.gather_rescore.launches == launches
    q_pm1, _ = jax_pm1.prepare_queries_impl(jnp.asarray(q_codes), jnp.asarray(q_lanes), nbits)
    db_unpacked = jax_pallas.build_unpacked_db(jnp.asarray(packed), nbits)
    want = jax_pallas.pallas_gather_rescore(
        q_pm1.astype(jnp.int8), jnp.asarray(block_ids), db_unpacked, kk, interpret=True
    )
    np.testing.assert_array_equal(got, np.asarray(want))


def _jax_topk(nbits, packed, valid, q_codes, q_lanes, k, chunk):
    """pallas_blockmax_topk_packedq_impl with the twins the JAX engine builds
    (bitplane + int8 for 128/256-bit, perm + int8 for 64/192-bit); below
    one 4096-row group the plain int8 kernel stands in for phase 1."""
    jp = jnp.asarray(packed)
    kw = {"db_unpacked": jax_pallas.build_unpacked_db(jp, nbits)}
    if len(packed) % 4096:
        kw["unpacked"] = True
    elif nbits in (128, 256):
        kw["db_bitplane"] = jax_pallas.bit_transpose_packed(jp)
    else:
        kw.update(unpacked=True, db_perm=jax_pallas.build_unpacked_db(jp, nbits, permute=True))
    s, i = jax_pallas.pallas_blockmax_topk_packedq_impl(
        jnp.asarray(q_codes), jnp.asarray(q_lanes), jp, jnp.asarray(valid), k, nbits,
        chunk_size=chunk, interpret=True, **kw,
    )
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize(
    "nbits,n,k",
    [(64, 8192, 10), (128, 8192, 10), (192, 8192, 7), (256, 8192, 16), (256, 1024, 10), (192, 128, 200)],
)
def test_blockmax_topk_packedq_matches_pallas_and_brute_force(nbits, n, k):
    """Non-power-of-two k, total_blocks < k (n=1024: 8 blocks) and k beyond
    the partition (n=128: padded with -1 / NEG_SCORE)."""
    packed, valid, q_codes, q_lanes = _partition(nbits, n=n, n_live=n - 40)
    got_s, got_i = hs.blockmax_topk_packedq_impl(_t(q_codes), _t(q_lanes), _t(packed), _t(valid), k, nbits)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32 and got_s.shape == (13, k)
    want_s, want_i = _jax_topk(nbits, packed, valid, q_codes, q_lanes, k, chunk=min(n, 4096))
    full = np.zeros((n, 8), np.uint32)
    full[:, : nbits // 32] = packed
    ref = _brute_force(q_codes, q_lanes, full, np.full(n, nbits // 32, np.int32), valid)
    _assert_topk_parity(got_s.numpy(), got_i.numpy(), want_s, want_i, ref)
    top = -np.sort(-ref, axis=1)[:, :k]
    top = np.pad(top, ((0, 0), (0, k - top.shape[1])), constant_values=NEG_SCORE)
    np.testing.assert_allclose(np.sort(got_s.numpy(), axis=1)[:, ::-1], top, rtol=0, atol=1e-6)


def test_blockmax_topk_rejects_a_partition_of_another_width():
    packed, valid, q_codes, q_lanes = _partition(128, n=1024)
    with pytest.raises(ValueError, match="not a 256-bit partition"):
        hs.blockmax_topk_packedq_impl(_t(q_codes), _t(q_lanes), _t(packed), _t(valid), 10, 256)


@pytest.mark.parametrize("phase1", ["popc", "mma", "mma_twin"])
@pytest.mark.parametrize("nbits", WIDTHS)
def test_every_phase1_formulation_gives_the_same_topk_on_the_cpu(nbits, phase1):
    """On the CPU each formulation takes its plain version; all return what
    the default (``"popc"``) returns, rows included."""
    packed, valid, q_codes, q_lanes = _partition(nbits, n=2048, n_live=2000)
    args = (_t(q_codes), _t(q_lanes), _t(packed), _t(valid), 10, nbits)
    twin = hs.build_unpacked_db(_t(packed), nbits)
    want_s, want_i = hs.blockmax_topk_packedq_impl(*args)
    got_s, got_i = hs.blockmax_topk_packedq_impl(*args, db_unpacked=twin, phase1=phase1)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)
    min_lanes, q_scale = pm1_scan.query_prefix(_t(q_lanes), nbits)
    got_s, got_i = hs.blockmax_topk_impl(_t(q_codes), min_lanes, q_scale, _t(packed), _t(valid), 10, twin, phase1=phase1)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)


def _split_k(nbits, n, n_live, k, budget_rows, monkeypatch):
    """blockmax_topk_packedq_impl with the phase 2-3 budget at
    ``budget_rows`` candidate rows; returns the result and the largest
    candidate count one gather_rescore call held."""
    packed, valid, q_codes, q_lanes = _partition(nbits, n=n, n_live=n_live)
    args = (_t(q_codes), _t(q_lanes), _t(packed), _t(valid), k, nbits)
    held = []
    rescore = hs.gather_rescore

    def spy(q_packed, min_lanes, block_ids, db):
        held.append(block_ids.numel() * hs.BLOCK)
        return rescore(q_packed, min_lanes, block_ids, db)

    monkeypatch.setattr(hs, "gather_rescore", spy)
    monkeypatch.setattr(hs, "PHASE3_BUDGET_BYTES", budget_rows * hs.PHASE3_ROW_BYTES)
    return hs.blockmax_topk_packedq_impl(*args), max(held), (packed, valid, q_codes, q_lanes)


@pytest.mark.parametrize("nbits", WIDTHS)
@pytest.mark.parametrize("queries_per_step", [1, 5])
def test_phase3_query_split_gives_the_unsplit_results(nbits, queries_per_step, monkeypatch):
    """Phases 2-3 over slices of the queries (repaired fault 3): each
    query's candidates are its own, so the results equal the unsplit run,
    and no step holds more candidates than the budget. Ties included here:
    the CPU's ``torch.topk`` keeps one tie order at these shapes (on CUDA
    that holds only while the slices do not change its algorithm; see
    ``test_phase3_query_split_is_exact_on_the_card``)."""
    k = 40  # kk = 32 blocks of the 4096-row partition
    want, full, _ = _split_k(nbits, 4096, 4000, k, 1 << 30, monkeypatch)
    assert full == 13 * 32 * hs.BLOCK  # one step for all 13 queries
    budget = queries_per_step * 32 * hs.BLOCK
    got, held, _ = _split_k(nbits, 4096, 4000, k, budget, monkeypatch)
    assert held <= budget
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nbits", [64, 128, 256])
@pytest.mark.parametrize("n,k", [(2048, 2048), (2048, 5000), (1024, 700)])
def test_phase3_split_up_to_a_whole_partition_is_exact(nbits, n, k, monkeypatch):
    """A count up to the whole partition (and beyond it) with a budget of
    three blocks: one query's candidate blocks are rescored in steps and
    merged, and the result is the brute-force top-k."""
    (got_s, got_i), held, (packed, valid, q_codes, q_lanes) = _split_k(nbits, n, n - 50, k, 3 * hs.BLOCK, monkeypatch)
    assert held <= 3 * hs.BLOCK and got_s.shape == (13, k)
    full = np.zeros((n, 8), np.uint32)
    full[:, : nbits // 32] = packed
    ref = _brute_force(q_codes, q_lanes, full, np.full(n, nbits // 32, np.int32), valid)
    top = -np.sort(-ref, axis=1)[:, :k]
    top = np.pad(top, ((0, 0), (0, k - top.shape[1])), constant_values=NEG_SCORE)
    # The brute force rounds NPHD its own way: one ulp apart at a 192-bit
    # common prefix (the parity rule), equal elsewhere.
    np.testing.assert_allclose(got_s.numpy(), top, rtol=0, atol=1e-6)
    s, i = got_s.numpy(), got_i.numpy()
    np.testing.assert_array_equal(i < 0, s <= NEG_SCORE)
    q, r = np.nonzero(i >= 0)
    np.testing.assert_allclose(ref[q, i[q, r]], s[q, r], rtol=0, atol=1e-6)
    for row in i:
        assert len(set(row[row >= 0].tolist())) == int((row >= 0).sum())  # no row twice


def test_phase1_names_the_three_wrappers():
    assert hs.PHASE1 == {"popc": hs.blockmax, "mma": hs.blockmax_mma_packed, "mma_small": hs.blockmax_small,
                         "mma_twin": hs.blockmax_mma_unpacked}
    packed, valid, q_codes, q_lanes = _partition(128, n=1024)
    args = (_t(q_codes), _t(q_lanes), _t(packed), _t(valid), 10, 128)
    with pytest.raises(ValueError, match=r"phase1 must be one of \['mma', 'mma_small', 'mma_twin', 'popc'\], got 'pallas'"):
        hs.blockmax_topk_packedq_impl(*args, phase1="pallas")
    with pytest.raises(ValueError, match="requires db_unpacked"):
        hs.blockmax_topk_packedq_impl(*args, phase1="mma_twin")
    # unpacked=True is the JAX contract's name for "mma_twin", whatever phase1 says.
    twin = hs.build_unpacked_db(_t(packed), 128)
    calls = []
    real = hs.PHASE1["mma_twin"]
    hs.PHASE1["mma_twin"] = lambda *a: (calls.append(a[3].dtype), real(*a))[1]
    try:
        hs.blockmax_topk_packedq_impl(*args, db_unpacked=twin, unpacked=True, phase1="popc")
    finally:
        hs.PHASE1["mma_twin"] = real
    assert calls == [torch.int8]


# ------------------------------------------------------ wrapper contracts


def _args(nbits=128, cap=256, nq=4):
    packed, valid, q_codes, q_lanes = _partition(nbits, n=cap, n_live=cap)
    min_lanes, q_scale = pm1_scan.query_prefix(_t(q_lanes[:nq]), nbits)
    return _t(q_codes[:nq]), min_lanes, q_scale, _t(packed), _t(valid)


# Bad inputs of the phase-1 wrappers that read packed rows, and the error each raises.
_PACKED_PHASE1_BAD_INPUTS = [
    (lambda a: (a[0].to(torch.int64), *a[1:]), "q_packed"),
    (lambda a: (a[0], a[1], a[2].double(), *a[3:]), "q_scale"),
    (lambda a: (*a[:3], a[3].t(), a[4]), "db"),
    (lambda a: (*a[:3], a[3][:200], a[4][:200]), "cap % 128"),
    (lambda a: (*a[:4], a[4].bool()), "valid"),
    (lambda a: (a[0][:, :2].contiguous(), *a[1:]), "do not fit"),
    (lambda a: (*a[:4], a[4][:128]), "valid"),
]


@pytest.mark.parametrize("mutate,error", _PACKED_PHASE1_BAD_INPUTS)
def test_blockmax_wrapper_checks_its_inputs(mutate, error):
    with pytest.raises(ValueError, match=error):
        hs.blockmax(*mutate(_args()))


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda a: (a[0].to(torch.int64), *a[1:]), "q_packed"),
        (lambda a: (a[0], a[1], a[2].double(), *a[3:]), "q_scale"),
        (lambda a: (*a[:3], a[3].float(), a[4]), "db_unpacked"),
        (lambda a: (*a[:3], a[3][:200], a[4][:200]), "cap % 128"),
        (lambda a: (*a[:3], a[3][:, :48].contiguous(), a[4]), "multiple of 32"),
        (lambda a: (*a[:3], torch.zeros((128, 288), dtype=torch.int8), a[4][:128]), "32..256"),
        (lambda a: (*a[:3], torch.zeros(256 * 128 + 1, dtype=torch.int8)[1:].view(256, 128), a[4]), "aligned"),
        (lambda a: (*a[:4], a[4][:128]), "valid"),
        (lambda a: (a[0][:, :2].contiguous(), *a[1:]), "do not fit"),
    ],
)
def test_blockmax_mma_unpacked_wrapper_checks_its_inputs(mutate, error):
    q_packed, min_lanes, q_scale, db, valid = _args()
    args = (q_packed, min_lanes, q_scale, hs.build_unpacked_db(db, 128), valid)
    with pytest.raises(ValueError, match=error):
        hs.blockmax_mma_unpacked(*mutate(args))


@pytest.mark.parametrize(
    "mutate,error", [*_PACKED_PHASE1_BAD_INPUTS, (lambda a: (a[0], a[1][:3], *a[2:]), "do not fit")]
)
def test_blockmax_mma_packed_wrapper_checks_its_inputs(mutate, error):
    with pytest.raises(ValueError, match=error):
        hs.blockmax_mma_packed(*mutate(_args()))


@pytest.mark.parametrize(
    "mutate,error", [*_PACKED_PHASE1_BAD_INPUTS, (lambda a: (a[0], a[1][:3], *a[2:]), "do not fit")]
)
def test_blockmax_small_wrapper_checks_its_inputs(mutate, error):
    with pytest.raises(ValueError, match=error):
        hs.blockmax_small(*mutate(_args()))


def test_blockmax_small_on_the_cpu_is_the_plain_phase1_and_counts_no_launch():
    """CPU tensors take the plain version, whatever their alignment (the
    16-byte rule is the kernel's TMA copies'), and count no launch."""
    q_packed, min_lanes, q_scale, db, valid = _args(nbits=192, cap=512, nq=9)
    before = hs.blockmax_small.launches
    want = hs.blockmax_plain(q_packed, min_lanes, q_scale, db, valid)
    assert torch.equal(hs.blockmax_small(q_packed, min_lanes, q_scale, db, valid), want)
    shifted = torch.zeros(db.numel() + 1, dtype=torch.int32)[1:].view(db.shape)
    shifted.copy_(db)
    assert shifted.data_ptr() % 16 and torch.equal(hs.blockmax_small(q_packed, min_lanes, q_scale, shifted, valid), want)
    assert hs.blockmax_small.launches == before
    assert hs._SIGNATURES["iscc_blockmax_small"] == hs._PHASE1


def test_mma_wrappers_refuse_devices_without_a_kernel():
    q_packed, min_lanes, q_scale, db, valid = [t.to("meta") for t in _args()]
    with pytest.raises(RuntimeError, match="no kernel for device type 'meta'"):
        hs.blockmax_mma_packed(q_packed, min_lanes, q_scale, db, valid)
    with pytest.raises(RuntimeError, match="no kernel for device type 'meta'"):
        hs.blockmax_small(q_packed, min_lanes, q_scale, db, valid)
    with pytest.raises(RuntimeError, match="no kernel for device type 'meta'"):
        hs.blockmax_mma_unpacked(q_packed, min_lanes, q_scale, torch.empty((256, 128), dtype=torch.int8, device="meta"), valid)


def test_gather_rescore_wrapper_checks_its_inputs():
    q_packed, min_lanes, _, db, _ = _args()
    with pytest.raises(ValueError, match="block_ids"):
        hs.gather_rescore(q_packed, min_lanes, torch.zeros((4, 2), dtype=torch.int64), db)
    with pytest.raises(ValueError, match="block_ids"):
        hs.gather_rescore(q_packed, min_lanes, torch.zeros((3, 2), dtype=torch.int32), db)
    with pytest.raises(ValueError, match="lanes"):
        hs.gather_rescore(q_packed, min_lanes, torch.zeros((4, 2), dtype=torch.int32), torch.zeros((128, 9), dtype=torch.int32))


def test_wrappers_refuse_devices_without_a_kernel():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises."""
    args = [t.to("meta") for t in _args()]
    with pytest.raises(RuntimeError, match="no kernel for device type 'meta'"):
        hs.blockmax(*args)
    q_packed, min_lanes, _, db, _ = args
    with pytest.raises(RuntimeError, match="meta"):
        hs.gather_rescore(q_packed, min_lanes, torch.zeros((4, 1), dtype=torch.int32, device="meta"), db)


# ----------------------------------------------------------------- build


def test_build_key_follows_sources_and_nvcc_is_required(tmp_path, monkeypatch):
    names = [p.name for p in _build.sources()]
    assert names == [
        "blockmax.cu", "blockmax_bitplane.cu", "blockmax_mma.cu", "blockmax_small.cu", "blockmax_variants.cu",
        "gather_rescore.cu", "int4_dot.cu", "select_rescore.cu",
    ]
    key = _build.build_key()
    assert key == _build.build_key() and len(key) == 16
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert _build.build_key() == key
    (csrc / "extra.cuh").write_text("#pragma once\n")
    header_key = _build.build_key()
    assert header_key != key  # a header rebuilds too
    (csrc / "extra.cuh").write_text("#pragma once\n// changed\n")
    assert _build.build_key() not in (key, header_key)  # and so does a change to it
    header_key = _build.build_key()
    (csrc / "blockmax.cu").write_text((csrc / "blockmax.cu").read_text() + "\n// changed\n")
    assert _build.build_key() not in (key, header_key)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.build_log() == ""


_FAKE_NVCC = """#!{python}
import sys, time
from pathlib import Path
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    # A compile waits until every compile has started: serial compiles fail.
    started = Path({started!r})
    (started / Path(args[-1]).name).touch()
    deadline = time.monotonic() + 60
    while len(list(started.iterdir())) < {n}:
        if time.monotonic() > deadline:
            print("error: the compiles did not run at once")
            sys.exit(3)
        time.sleep(0.01)
    if {fail!r} in args[-1]:
        print("error: " + args[-1])
        sys.exit(2)
open(out, "w").write(" ".join(args))
print("ptxas info: Used 32 registers for " + out)
"""


@pytest.mark.parametrize("fail", ["", "blockmax_mma.cu"])
def test_build_compiles_every_source_at_once_then_links(tmp_path, monkeypatch, fail):
    """One nvcc per source, started together, then one link; the log keeps
    every command's output, and a failed compile raises with its output."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    started = tmp_path / "started"
    started.mkdir()
    n = len(_build.sources())
    fake.write_text(_FAKE_NVCC.format(python=sys.executable, started=str(started), n=n, fail=fail or "no such source"))
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match="(?s)nvcc failed.*error: .*blockmax_mma.cu"):
            _build.build()
        assert not (tmp_path / "build" / _build.build_key() / _build.LIB_NAME).exists()
        return
    lib = _build.build()
    link = lib.read_text().split()
    assert "-shared" in link and sum(arg.endswith(".o") for arg in link) == n
    log = _build.build_log()
    assert log.count("-c -o") == n and log.count("Used 32 registers") == n + 1
    assert _build.build() == lib  # built once per key
    assert sorted(p.name for p in lib.parent.iterdir()) == ["build.log", _build.LIB_NAME]


# ------------------------------------------------------------ processes


_BLOCKER = """
import importlib, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "platformdirs", "pydantic", "pydantic_core", "httpx", "yaml", "click", "rich",
           "iscc_search_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())
import iscc_search_tpu_torch
names = [m.name for m in pkgutil.walk_packages(iscc_search_tpu_torch.__path__, "iscc_search_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names), "modules", *names)
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER], cwd=REPO, env=_env(PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    count, _, *names = proc.stdout.split()
    assert int(count) >= 30
    assert {
        "iscc_search_tpu_torch.codec",
        "iscc_search_tpu_torch.models",
        "iscc_search_tpu_torch.schema",
        "iscc_search_tpu_torch.options",
        "iscc_search_tpu_torch.utils",
        "iscc_search_tpu_torch.ops.topk",
        "iscc_search_tpu_torch.store.kv",
        "iscc_search_tpu_torch.engine.simprint",
        "iscc_search_tpu_torch.engine.simprint_ops",
        "iscc_search_tpu_torch.engine.batcher",
        "iscc_search_tpu_torch.indexes.common",
        "iscc_search_tpu_torch.indexes.tpu.index",
        "iscc_search_tpu_torch.indexes.tpu.manager",
        "iscc_search_tpu_torch.server.metrics",
        "iscc_search_tpu_torch.ops.bitplane",
        "iscc_search_tpu_torch.experiments",
        "iscc_search_tpu_torch.experiments.exp_kernels",
        "iscc_search_tpu_torch.experiments.exp_int4",
        "iscc_search_tpu_torch.experiments.exp_bitplane_int8",
        "iscc_search_tpu_torch.experiments.exp_bitplane_u8",
        "iscc_search_tpu_torch.experiments.exp_small_ablate",
        "iscc_search_tpu_torch.experiments.exp_bitplane_ablate",
        "iscc_search_tpu_torch.experiments.bitplane_layout",
        "iscc_search_tpu_torch.ops.small_layout",
        "iscc_search_tpu_torch.protocols.index",
        "iscc_search_tpu_torch.aggregator",
        "iscc_search_tpu_torch.aggregator.tlog",
        "iscc_search_tpu_torch.aggregator.entry",
        "iscc_search_tpu_torch.aggregator.cursors",
        "iscc_search_tpu_torch.aggregator.convert_worker",
        "iscc_search_tpu_torch.aggregator.hublist",
        "iscc_search_tpu_torch.aggregator.http",
        "iscc_search_tpu_torch.aggregator.poller",
        "iscc_search_tpu_torch.indexes.memory",
        "iscc_search_tpu_torch.indexes.memory.index",
        "iscc_search_tpu_torch.indexes.kv",
        "iscc_search_tpu_torch.indexes.kv.index",
        "iscc_search_tpu_torch.indexes.kv.manager",
        "iscc_search_tpu_torch.remote",
        "iscc_search_tpu_torch.remote.client",
        "iscc_search_tpu_torch.server",
        "iscc_search_tpu_torch.server.app",
        "iscc_search_tpu_torch.server.auth",
        "iscc_search_tpu_torch.server.httpd",
        "iscc_search_tpu_torch.server.openapi",
        "iscc_search_tpu_torch.server.pooled",
        "iscc_search_tpu_torch.server.wsgi",
        "iscc_search_tpu_torch.server.scaleout",
        "iscc_search_tpu_torch.server.worker",
        "iscc_search_tpu_torch.config",
        "iscc_search_tpu_torch.cli",
        "iscc_search_tpu_torch.cli.__main__",
        "iscc_search_tpu_torch.cli.add",
        "iscc_search_tpu_torch.cli.common",
        "iscc_search_tpu_torch.cli.datasets",
        "iscc_search_tpu_torch.cli.get",
        "iscc_search_tpu_torch.cli.hub",
        "iscc_search_tpu_torch.cli.index",
        "iscc_search_tpu_torch.cli.search",
        "iscc_search_tpu_torch.cli.serve",
        "iscc_search_tpu_torch.ops.pm1_scan",
        "iscc_search_tpu_torch.parallel",
        "iscc_search_tpu_torch.parallel.mesh",
        "iscc_search_tpu_torch.parallel.merge",
        "iscc_search_tpu_torch.parallel.sharded",
        "iscc_search_tpu_torch.parallel.pm1_sharded",
        "iscc_search_tpu_torch.parallel.pallas_sharded",
        "iscc_search_tpu_torch.parallel.hier",
        "iscc_search_tpu_torch.parallel.distributed",
        "iscc_search_tpu_torch.parallel.service",
    } <= set(names)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device here: the smoke run exits non-zero and prints no result,
    in the checkout and as a lone copy without the package."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    for cwd in (REPO, tmp_path):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=_env(CUDA_VISIBLE_DEVICES=""),
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_chip_smoke_module_names_the_kernels():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.WRAPPERS) == set(mod.EXPERIMENT_KERNELS)
    for meta in {**mod.KERNELS, **mod.EXPERIMENT_KERNELS}.values():
        assert (REPO / meta["source"]).is_file()
        for ref in [meta["replaces"], *meta.get("also_replaces", [])]:
            path, line = ref.split(":")
            assert (REPO / path).read_text().splitlines()[int(line) - 1].lstrip().startswith("def ")
    assert set(mod.PHASE1) <= set(mod.KERNELS)


def test_chip_smoke_bounds_each_variant_by_its_own_work():
    """Kernel-8 bounds: the ``*_nodma`` probes read chunk 0 only, so the
    int8 operations bound them; ``bf16dot`` computes the integer dot of
    ``bf16`` and shares its bound; a variant without a penalty reads less."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n, nq = mod.N8, mod.Q8
    ops_ms = 2 * nq * n * 256 / mod.INT8_OPS_S * 1e3
    bf16 = mod.variant_bound("bf16", n, nq)
    assert bf16[1] == "bytes" and bf16[0] > ops_ms
    assert mod.variant_bound("bf16dot", n, nq) == bf16
    assert mod.variant_bound("bf16_nopen", n, nq)[0] < bf16[0]
    for name in ("dotonly_nodma", "dotonly_bf16_nodma", "consume_nodma", "nodma_full"):
        assert mod.variant_bound(name, n, nq) == (pytest.approx(ops_ms), "operations")


def test_chip_smoke_measures_both_sides_of_every_auto_threshold():
    """The [route] grid holds a batch size on each side of every threshold
    of the engine's ``"auto"`` table, so the smoke run times all three
    kernels on both sides of every switch; the warm searches' small batch
    is one ``"auto"`` gives the small-batch kernel."""
    from iscc_search_tpu_torch.engine import device_index as di

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert list(mod.ROUTE_QS) == sorted(set(mod.ROUTE_QS)) and mod.ROUTE_QS[0] == 1 and mod.ROUTE_QS[-1] >= 1024
    assert {1, 2, 4, 8, 16, 32, 64, 96, 128, 192, 256, 512, 1024} <= set(mod.ROUTE_QS)
    assert mod.ROUTE_KERNELS == {"popc": "blockmax", "mma_small": "blockmax_small", "mma": "blockmax_mma_packed"}
    order = ("popc", "mma_small", "mma")
    for lanes in mod.LANE_CHOICES:
        for kernel, threshold in zip(order[1:], di._AUTO_ROUTE[lanes]):
            below = max(q for q in mod.ROUTE_QS if q < threshold)
            above = min(q for q in mod.ROUTE_QS if q >= threshold)
            assert order.index(di.auto_phase1(below, lanes)) < order.index(kernel) == order.index(di.auto_phase1(above, lanes))
        assert di.auto_phase1(mod.SMALL_Q, lanes) == "mma_small"
    assert mod.N_PERSIST == 1_048_576 and mod.N_PERSIST // (mod.PERSIST_SHARD_BYTES // 45) >= 4


def test_chip_smoke_simprint_and_product_phases_run_on_the_cpu(tmp_path, request):
    """The asset-level phases of the smoke run, end to end at a tiny size on
    the CPU (the wrappers' plain versions), [multihost]'s distributed
    ``serve()`` last: every check they make on the card passes here too. Their full sizes: BASELINE config 4's 100,000,000
    chunk rows, the 20,000-asset product cell, and the server's 1,000 assets
    added over HTTP."""
    from iscc_search_tpu_torch.engine import device_index as di

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.C4_ASSETS * mod.C4_CHUNKS == 100_000_000 and mod.PRODUCT_ASSETS * mod.PRODUCT_SIMPRINTS == 2_000_000
    rng = np.random.default_rng(0)
    dev = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # files run in parallel processes: this one's CPU work starves no other
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    launches, stats = mod.phase_simprint(rng, dev, tmp_path, n_assets=64, chunks=20, trials=1, widths=(5, 20), batches=(1, 3))
    # Config 4's scans keep the chain (kk = 512 candidate blocks): no fused kernel at its shapes.
    assert set(launches) == set(mod.PATH_KERNELS) and set(stats) == set(mod.PATH_KERNELS) - {"select_rescore_topk"}
    assert {s["q"] for s in stats["blockmax_small"]} == {5, 20} and len(stats["blockmax_mma_packed"]) == 3
    assert all(s["max_abs_err"] == 0.0 for entries in stats.values() for s in entries)
    launches, stats, truth, rate = mod.phase_product(rng, dev, tmp_path, n_assets=60, n_sp=12, n_cpu=30, reps=1,
                                                     clients=2, per_client=1)
    assert set(launches) == set(mod.PATH_KERNELS) and len(truth) == 60 and rate > 0
    assert set(stats) == {mod.ROUTE_KERNELS[di.auto_phase1(12, 4)], "gather_rescore"}
    assert all(s["max_abs_err"] == 0.0 for entries in stats.values() for s in entries)
    # [server]: the product index behind the REST app over real sockets and serve() in a subprocess.
    assert [p.name for p in (tmp_path / mod.PRODUCT_BASE).iterdir()] == [mod.PRODUCT_NAME]
    launches, recorded = mod.phase_server(rng, dev, tmp_path, truth, rate, n_new=20, n_sp=12, n_kv=10, reps=1,
                                          clients=2, per_client=1)
    assert set(launches) == set(mod.PATH_KERNELS)
    assert (mod.SERVER_NEW_ASSETS, mod.SERVER_CHUNK, mod.SERVER_KV_ASSETS) == (1000, 100, 100)
    assert len(recorded["want"]) == 10 and recorded["sub_rate"] > 0 and recorded["assets"] == 60 + 20 + 20 + 10  # + a direct batch of 20, + 10 by serve()
    # [scaleout]: serve_scaleout on a thread with two real workers; [cli]: the CLI in fresh processes.
    launches = mod.phase_scaleout(rng, dev, tmp_path, truth, recorded, n_new=20, n_sp=12, clients=2)
    assert set(launches) == set(mod.PATH_KERNELS)
    splits = dict(mod.phase_cli(rng, dev, tmp_path, truth, n_assets=12, n_sp=12))
    assert {"open index", "search_assets", "import iscc_search_tpu_torch.cli", "import torch"} <= set(
        splits["search by code"]) and mod.CLI_ASSETS == 1000
    # [multihost] (b): serve() in distributed mode, two gloo ranks on their copies of the product index.
    launches = mod.phase_multihost_serve(rng, dev, tmp_path, truth, recorded, n_new=10, n_sp=12, clients=2, timeout=120)
    assert set(launches) == set(mod.PATH_KERNELS) and mod.MULTIHOST_NEW_ASSETS == 200
