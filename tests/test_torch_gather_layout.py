"""CPU tests of the block-major form of ``csrc/gather_rescore.cu``: its
inversion of ``block_ids`` (histogram with atomics, tile sums, in-place
scan, scatter) and its serving of the sorted list in segments, run index for
index in numpy (``ops/gather_layout.py``) against the plain phase 3
(``gather_rescore_plain``) and, once per width, against the JAX package's
``pallas_gather_rescore`` in interpret mode; and the wrapper's ``form=`` and
its route by candidate reuse; and the builds of
``experiments/exp_gather_ablate.py``.

The kernel itself runs only on a card (``tests/test_torch_gpu.py``). Every
comparison here is an equality: the dots are exact integers.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iscc_search_tpu.ops import pallas_scan as jax_pallas
from iscc_search_tpu.ops import pm1_scan as jax_pm1
from iscc_search_tpu_torch.experiments import exp_gather_ablate
from iscc_search_tpu_torch.ops import _build
from iscc_search_tpu_torch.ops import gather_layout as gl
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.pm1_scan import query_prefix

SOURCE = Path(gl.__file__).resolve().parent.parent / "csrc" / "gather_rescore.cu"


def _case(lanes, nq, kk, nblocks=40, seed=0, min_lanes=None):
    """Random (cap, lanes) rows, (nq, 8) queries and (nq, kk) block ids;
    ``min_lanes`` random in 0..lanes (0 and short prefixes included) unless
    given."""
    rng = np.random.default_rng(seed * 100 + lanes)
    db = rng.integers(0, 2**32, (nblocks * 128, lanes), dtype=np.uint32).view(np.int32)
    q = rng.integers(0, 2**32, (nq, 8), dtype=np.uint32).view(np.int32)
    ml = rng.integers(0, lanes + 1, nq).astype(np.int32) if min_lanes is None else np.asarray(min_lanes, np.int32)
    ids = rng.integers(0, nblocks, (nq, kk)).astype(np.int32)
    return q, ml, ids, db


def _plain(q, ml, ids, db):
    return hs.gather_rescore_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, ml, ids, db))).numpy()


def _check_flow(q, ml, ids, db, order=None):
    """The mirror's stages hold their invariants and its output equals the
    plain phase 3; returns the stages."""
    got = gl.gather_blocks(q, ml, ids, db, order)
    flat = ids.reshape(-1)
    nblocks = db.shape[0] // 128
    np.testing.assert_array_equal(got["counts"], np.bincount(flat, minlength=nblocks))
    np.testing.assert_array_equal(got["offsets"], np.concatenate([[0], np.cumsum(got["counts"])[:-1]]))
    np.testing.assert_array_equal(got["tile_sums"].sum(), len(flat))
    srt = got["sorted"]
    assert (srt >= 0).all()  # every position written once
    np.testing.assert_array_equal(np.sort(srt[:, 0]), np.arange(len(flat)))
    assert (np.diff(srt[:, 1]) >= 0).all()  # grouped by block, ascending
    np.testing.assert_array_equal(flat[srt[:, 0]], srt[:, 1])
    assert (got["writes"] == 1).all()  # every output column by exactly one thread block
    segments = -(-len(flat) // gl.SEGMENT)
    assert got["loads"] <= np.count_nonzero(got["counts"]) + segments - 1
    np.testing.assert_array_equal(got["out"], _plain(q, ml, ids, db))
    return got


# ------------------------------------------------------------- the source


def test_constants_mirror_the_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))

    assert const("kBlockRows") == gl.BLOCK_ROWS == hs.BLOCK
    assert const("kSegment") == gl.SEGMENT
    assert const("kScanThreads") == gl.SCAN_THREADS
    assert const("kScanItems") == gl.SCAN_ITEMS
    assert "constexpr int kScanTile = kScanThreads * kScanItems;" in src
    # The workspace the wrapper allocates is the one the C entry carves.
    assert "ws_words < 3 * npairs + nblocks + ntiles" in src
    assert gl.workspace_words(10, 4097) == 30 + 4097 + 2
    # The inversion is written in the file: no library sort or scan.
    assert re.findall(r"#include <(\w+)", src) == ["cuda_runtime", "stdint"]


# ------------------------------------------------------- the mirror's flow


@pytest.mark.parametrize("lanes", range(1, 9))
def test_mirror_equals_plain_at_every_width(lanes):
    """lanes 1-8, ``min_lanes`` 0 to full (short prefixes), nine queries of
    six random blocks each (repeats within a query where they fall)."""
    q, ml, ids, db = _case(lanes, nq=9, kk=6)
    ml[:3] = (0, 1, lanes)
    _check_flow(q, ml, ids, db)


@pytest.mark.parametrize(
    "lanes,nq,kk,ids_of",
    [
        (4, 1, 7, None),  # Q=1
        (6, 11, 1, None),  # kk=1
        (2, 5, 8, lambda ids: np.repeat(ids[:, :2], 4, axis=1)),  # each block id four times in its query
        (8, 70, 2, lambda ids: np.full_like(ids, 17)),  # one block, every query twice: 140 > SEGMENT
        (3, 40, 3, lambda ids: np.where(np.arange(3) == 1, 39, ids)),  # the partition's last block, every query
        (5, 1, 1, lambda ids: np.full_like(ids, 39)),
    ],
    ids=["Q=1", "kk=1", "repeats", "one-block-by-all", "last-block", "one-pair"],
)
def test_mirror_equals_plain_at_the_edges(lanes, nq, kk, ids_of):
    q, ml, ids, db = _case(lanes, nq, kk, seed=1)
    if ids_of is not None:
        ids = ids_of(ids).astype(np.int32)
    got = _check_flow(q, ml, ids, db)
    if ids_of is not None and len(np.unique(ids)) == 1:
        # A list longer than a segment spans several thread blocks, each
        # loading the block once.
        assert got["loads"] == -(-ids.size // gl.SEGMENT)


def test_mirror_does_not_depend_on_the_order_of_the_atomics():
    """The ranks and so the lists' order follow the atomics' arrival; the
    output does not."""
    q, ml, ids, db = _case(4, nq=20, kk=10, nblocks=12, seed=2)
    rng = np.random.default_rng(3)
    first = _check_flow(q, ml, ids, db)
    for _ in range(3):
        again = _check_flow(q, ml, ids, db, order=rng.permutation(ids.size))
        np.testing.assert_array_equal(again["out"], first["out"])
        np.testing.assert_array_equal(again["offsets"], first["offsets"])


def test_scan_spans_several_tiles():
    """More blocks than one scan tile: the tile sums carry across tiles;
    the partition's last block sits in a ragged last tile."""
    nblocks = 2 * gl.SCAN_TILE + 77
    counts = np.random.default_rng(4).integers(0, 5, nblocks)
    counts[-1] = 9
    sums = gl.sum_tiles(counts)
    assert len(sums) == gl.ntiles(nblocks) == 3
    np.testing.assert_array_equal(sums, [counts[: gl.SCAN_TILE].sum(), counts[gl.SCAN_TILE : 2 * gl.SCAN_TILE].sum(),
                                         counts[2 * gl.SCAN_TILE :].sum()])
    np.testing.assert_array_equal(gl.scan_tiles(counts, sums), np.concatenate([[0], np.cumsum(counts)[:-1]]))


@pytest.mark.parametrize("nbits", (64, 128, 192, 256))
def test_mirror_equals_the_pallas_kernel(nbits):
    """The mirror against ``pallas_gather_rescore`` in interpret mode on the
    same seeded inputs: queries of every length (short prefixes), a block
    repeated within a query and the partition's last block."""
    lanes = nbits // 32
    rng = np.random.default_rng(nbits)
    nblocks = 6
    packed = rng.integers(0, 2**32, (nblocks * 128, lanes), dtype=np.uint32)
    q_lanes = np.array([2, 4, 6, 8, lanes], np.int32)
    q_codes = rng.integers(0, 2**32, (5, 8), dtype=np.uint32)
    q_codes[np.arange(8)[None, :] >= q_lanes[:, None]] = 0
    ids = rng.integers(0, nblocks, (5, 4)).astype(np.int32)
    ids[0, :2] = 3
    ids[1, 3] = nblocks - 1
    min_lanes, _ = query_prefix(torch.from_numpy(q_lanes), nbits)
    got = gl.gather_blocks(q_codes.view(np.int32), min_lanes.numpy(), ids, packed.view(np.int32))["out"]
    q_pm1, _ = jax_pm1.prepare_queries_impl(jnp.asarray(q_codes), jnp.asarray(q_lanes), nbits)
    want = jax_pallas.pallas_gather_rescore(
        q_pm1.astype(jnp.int8), jnp.asarray(ids), jax_pallas.build_unpacked_db(jnp.asarray(packed), nbits), 4,
        interpret=True,
    )
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------------ the wrapper's form


def test_form_on_cpu_tensors_is_the_plain_version_and_counts_nothing():
    q, ml, ids, db = (torch.from_numpy(a) for a in _case(4, nq=5, kk=3))
    want = hs.gather_rescore_plain(q, ml, ids, db)
    before = hs.gather_rescore.launches, dict(hs.gather_rescore.by_form)
    for form in (None, "query", "block"):
        assert torch.equal(hs.gather_rescore(q, ml, ids, db, form=form), want)
    assert (hs.gather_rescore.launches, hs.gather_rescore.by_form) == before
    for bad in ("row", "", "Block"):
        with pytest.raises(ValueError, match="form"):
            hs.gather_rescore(q, ml, ids, db, form=bad)


def test_the_route_takes_block_major_at_high_reuse_only():
    """``gather_form`` compares the pairs per partition block with the
    table: the product's limit-100 slice (64 x 4,096 pairs over 17,920
    blocks) and limit-10 request (100 x 512) are block-major, config 3's
    and config 4's shapes query-major."""
    assert set(hs.GATHER_BLOCK_REUSE) == set(range(1, 9))
    assert hs.gather_form(64, 4096, 17920, 4) == "block"
    assert hs.gather_form(100, 512, 17920, 4) == "block"
    assert hs.gather_form(512, 256, 879104, 4) == "query"
    assert hs.gather_form(128, 2048, 879104, 4) == "query"
    for lanes, threshold in hs.GATHER_BLOCK_REUSE.items():
        nblocks = 1000
        at = int(np.ceil(threshold * nblocks))
        assert hs.gather_form(1, at, nblocks, lanes) == "block"
        assert hs.gather_form(1, at - 1, nblocks, lanes) == "query"


# ------------------------------------------------------- exp_gather_ablate


@pytest.mark.parametrize("name", sorted(exp_gather_ablate.VARIANTS))
def test_ablation_variants_build_under_keys_of_their_own(name):
    """Each variant builds ``gather_rescore.cu`` alone with one
    ``ISCC_GATHER_ABLATE`` mask, under a key no other variant and not the
    port's library has; the masks are the source's cut bits."""
    names = (exp_gather_ablate.SOURCE,)
    defines = exp_gather_ablate.defines_of(name)
    assert defines == (f"ISCC_GATHER_ABLATE={exp_gather_ablate.VARIANTS[name]}",)
    key = _build.build_key(defines, names)
    assert key != _build.build_key()
    others = {_build.build_key(exp_gather_ablate.defines_of(n), names) for n in exp_gather_ablate.VARIANTS if n != name}
    assert key not in others
    src = SOURCE.read_text()
    for bit, cut in ((exp_gather_ablate.CUT_STORE, "kCutStore"), (exp_gather_ablate.CUT_COMPUTE, "kCutCompute"),
                     (exp_gather_ablate.CUT_SERVE, "kCutServe"), (exp_gather_ablate.CUT_ROWS, "kCutRows")):
        assert f"constexpr bool {cut} = ISCC_GATHER_ABLATE & {bit};" in src


def test_ablation_shapes_and_bound():
    """The shapes are the sweep's: the product's capacity for its 2,000,000
    chunk rows and config 4's for its 100,000,000; the bound counts what
    ``chip_smoke.gather_work`` counts."""
    from iscc_search_tpu_torch.engine.device_index import _cap_rows

    assert exp_gather_ablate.SHAPES["product100"][:2] == (_cap_rows(2_000_000), 2_000_000)
    assert exp_gather_ablate.SHAPES["config4"][0] == _cap_rows(100_000_000)
    assert exp_gather_ablate.SHAPES["product100"][3:] == (64, 4096)
    nbytes = 17920 * 128 * 16 + 64 * 4096 * 4 + 64 * 20 + 64 * 4096 * 512
    assert exp_gather_ablate.bound_ms(64, 4096, 4, 17920) == pytest.approx(nbytes / 3.35e12 * 1e3)
