"""CPU tests of ``iscc_blockmax_bitplane`` (``csrc/blockmax_bitplane.cu``),
TPU kernel 10 on ``wgmma``: its flow mirrored in numpy
(``experiments/bitplane_layout.py``) against the port's plain version
``exp_bitplane_int8.blockmax_bitplane_plain`` and against the script's
Pallas kernel (``benchmarks/exp_bitplane_int8.py`` ``make_variant``, loaded
from its file with ``pl.pallas_call`` run in interpret mode); the byte
permutes of the un-transpose, the row tile's swizzle, the slice box, the
threads' shares and shared-memory turns, the penalty plans and path counts,
the shared-memory budget.

The kernel itself runs only on a card (``tests/test_torch_gpu.py``). Every
comparison is an equality. Constants the mirror copies are read from the
``.cu`` source.
"""

import importlib.util
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iscc_search_tpu.ops import pm1_scan as jax_pm1
from iscc_search_tpu_torch.experiments import bitplane_layout as bl
from iscc_search_tpu_torch.experiments import exp_bitplane_ablate
from iscc_search_tpu_torch.experiments import exp_bitplane_int8 as port10
from iscc_search_tpu_torch.ops import _build, bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "iscc_search_tpu_torch" / "csrc" / "blockmax_bitplane.cu"
KINDS = ("tombstones", "dead_blocks", "per_element", "mixed")


def _const(src, name):
    m = re.search(rf"constexpr (?:int|uint32_t|float) {name} = ([^;]+);", src)
    return m.group(1).strip()


def _kernel10_source():
    src = SOURCE.read_text()
    return src[src.index("namespace planes {"):]


def test_the_mirror_carries_the_kernels_constants():
    src = _kernel10_source()
    ints = {
        "kBlockRows": bl.BLOCK_ROWS, "kBits": bl.BITS, "kGroupBlocks": bl.GROUP_BLOCKS, "kBands": bl.BANDS,
        "kSliceBlocks": bl.SLICE_BLOCKS, "kTileQueries": bl.TILE_QUERIES, "kChunkQueries": bl.CHUNK_QUERIES,
        "kProducerThreads": bl.PRODUCER_THREADS, "kSwizzleBytes": bl.SWIZZLE_BYTES,
    }
    for name, value in ints.items():
        assert int(_const(src, name)) == value, name
    assert _const(src, "kSliceBytes") == "kBits * kBands * kSliceBlocks * 4"
    assert _const(src, "kConsumerGroups") == "kChunkQueries / kTileQueries" and bl.CONSUMER_GROUPS == 4
    assert _const(src, "kConsumerThreads") == "kConsumerGroups * 128"
    assert _const(src, "kOutStride") == "kSliceBlocks + 1"
    assert _const(src, "kS8Atom") == "kBlockRows * kSwizzleBytes"
    assert _const(src, "kS8TileBytes") == "kBits / kSwizzleBytes * kS8Atom"
    assert int(_const(src, "kPlaneMask").rstrip("u"), 0) == bl.PLANE_MASK
    assert float(_const(src, "kDominance").rstrip("f")) == bl.DOMINANCE
    # The byte transpose's selectors, in the order transpose4 applies them.
    sels = [int(s, 16) for s in re.findall(r"__byte_perm\((?:e[02], e[13]|t[01], t[23]), (0x[0-9a-f]+)\)", src)]
    assert sels == [bl.PAIR_LO, bl.PAIR_HI, bl.PAIR_LO, bl.PAIR_HI, bl.HALF_LO, bl.HALF_HI, bl.HALF_LO, bl.HALF_HI]
    assert "(p0[s >> 3] >> (s & 7)) & kPlaneMask" in src
    # The producer thread's band and K bytes, the slice box and its offsets.
    flat = " ".join(src.split())
    assert ("const int j1 = lane & 3; const int u0 = 128 * (w >> 1) + 16 * (4 * ((lane >> 3) & 1) + 2 * (w & 1) + "
            "((lane >> 4) & 1)) + 8 * ((lane >> 2) & 1);") in flat
    assert "u0 * (kBands * kSliceBlocks * 4) + j1 * (kSliceBlocks * 4)" in flat
    assert "*reinterpret_cast<const uint4*>(src + i * (kBands * kSliceBlocks * 4) + 16 * h)" in flat  # half a slice
    assert "const cuuint32_t box[3] = {(cuuint32_t)kSliceBlocks, (cuuint32_t)kBands, (cuuint32_t)kBits};" in flat
    assert "slice % kGroupSlices * kSliceBlocks + 2 * w;" in flat  # load_pens: warp w's two blocks
    assert "smem_desc_sw128(smem_addr(s_rows + b * kS8TileBytes))" in flat
    # The shared-memory formula the mirror reckons the budget with.
    assert ("2 * kS8TileBytes + 2 * kSliceBytes + kS8Chunks * qc * 16 + qc * 8 + 2 * kSliceBlocks * kBlockRows * 4 + "
            "2 * kSliceBlocks * (int)sizeof(BlockPlan) + qc * kOutStride * 4 + 6 * 8 + 1024") in flat
    plan = re.search(r"struct BlockPlan \{(.*?)\};", src, re.S).group(1)
    assert len(re.findall(r"^\s*(?:float|int) \w+;", plan, re.M)) == 4 and "uint32_t dom[kBands];" in plan
    assert bl.PLAN_BYTES == 4 * 4 + 4 * bl.BANDS
    # The sub-word entry keeps only its own instantiations.
    whole = SOURCE.read_text()
    assert "launch<32" not in whole and "Element<32>" not in whole


@pytest.mark.parametrize("qc", (128, 256))
def test_shared_memory_fits_a_thread_block(qc):
    assert bl.smem_bytes(qc) <= bl.SMEM_LIMIT
    assert bl.smem_bytes(256) == 217648


# ------------------------------------------------------------ arithmetic


def test_transpose4_gathers_byte_b_of_each_element_and_plane_words_are_bits():
    rng = np.random.default_rng(0)
    e = rng.integers(0, 2**32, (4, 4096), dtype=np.uint64).astype(np.uint32)
    planes = bl.transpose4(*e)
    for b in range(4):
        for k in range(4):
            assert np.array_equal((planes[b] >> np.uint32(8 * k)) & 0xFF, (e[k] >> np.uint32(8 * b)) & 0xFF)
    for s in range(32):
        word = bl.plane_word(planes, s)
        for k in range(4):
            assert np.array_equal((word >> np.uint32(8 * k)) & 0xFF, (e[k] >> np.uint32(s)) & 1)


def test_each_producer_thread_owns_one_band_and_eight_k_bytes():
    j1, u0 = bl.producer_thread(np.arange(bl.PRODUCER_THREADS))
    assert np.all(u0 % 8 == 0) and u0.max() < bl.BITS
    pairs = set(zip(j1.tolist(), u0.tolist()))
    assert pairs == {(j, u) for j in range(bl.BANDS) for u in range(0, bl.BITS, 8)}


def test_shared_memory_turns_of_the_slice_loads_and_row_stores():
    """A slice load (16 bytes a lane) takes at most twice the ideal turns (a
    quarter-warp's lanes of one band differ only in u); a row store (8 bytes
    a lane, four rows of one s) takes the ideal two."""
    for w in range(4):
        p = 32 * w + np.arange(32)
        j1, u0 = bl.producer_thread(p)
        for i in range(8):
            for half in range(2):
                assert bl.wavefronts(bl.slice_offset(u0 + i, j1, 4 * half), 16) == 8
        for s in range(32):
            assert bl.wavefronts(bl.s8_offset(4 * s + j1, u0), 8) == 2


def test_slice_offsets_follow_the_tma_box():
    twin = np.arange(2 * bl.BITS * 128, dtype=np.uint32).reshape(-1, 128)
    for sl in range(8):
        box = bl.slice_box(twin, sl)
        flat = box.reshape(-1)
        u, j1, c = np.meshgrid(np.arange(bl.BITS), np.arange(bl.BANDS), np.arange(bl.SLICE_BLOCKS), indexing="ij")
        assert np.array_equal(flat[bl.slice_offset(u, j1, c) // 4], box[u, j1, c])
        g, first = divmod(sl * bl.SLICE_BLOCKS, bl.GROUP_BLOCKS)
        assert np.array_equal(box[:, 2, 5], twin[g * bl.BITS : (g + 1) * bl.BITS, 64 + first + 5])


def _packed(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_untransposed_rows_equal_the_unpacked_packed_rows():
    """Row r of block j0's tile is original row j0 * 128 + r of its group,
    as 0/1 bytes in unpack order, read back through the swizzle."""
    rng = np.random.default_rng(1)
    packed = _packed(rng, 8192)
    twin = bitplane.bit_transpose_packed(torch.from_numpy(packed.view(np.int32))).numpy()
    bits01 = (hs.build_unpacked_db(torch.from_numpy(packed.view(np.int32)), 256).numpy() + 1) // 2
    no_masks = np.zeros(bl.BANDS, np.uint64)
    for sl in (0, 3, 5, 7):
        box = bl.slice_box(twin, sl)
        for c in range(bl.SLICE_BLOCKS):
            block = sl * bl.SLICE_BLOCKS + c
            rows = bl.tile_rows(bl.untranspose(box, c, no_masks, 0))
            assert np.array_equal(rows, bits01[block * 128 : (block + 1) * 128])


def test_dominated_rows_are_stored_as_copies_of_the_first_top_row():
    rng = np.random.default_rng(2)
    twin = bitplane.bit_transpose_packed(torch.from_numpy(_packed(rng, 4096).view(np.int32))).numpy()
    box = bl.slice_box(twin, 1)
    p = np.zeros(128, np.float32)
    dead = np.array([0, 1, 6, 77, 127])
    p[dead] = -65536.0
    fast, pmax, masks, first_top = bl.block_plan(p)
    assert fast and pmax == 0 and first_top == 2
    assert [int(m).bit_count() for m in masks] == [1, 2, 1, 1]  # band r % 4: rows 0 | 1, 77 | 6 | 127
    plain = bl.tile_rows(bl.untranspose(box, 4, np.zeros(4, np.uint64), 0))
    got = bl.tile_rows(bl.untranspose(box, 4, masks, first_top))
    live = np.setdiff1d(np.arange(128), dead)
    assert np.array_equal(got[live], plain[live])
    assert np.array_equal(got[dead], np.repeat(plain[first_top][None], len(dead), axis=0))


# ------------------------------------------------------------- the plan


def test_pen_words_hold_two_blocks_of_each_band():
    rng = np.random.default_rng(3)
    pen = rng.integers(0, 2**16, 8192, dtype=np.uint64).astype(np.uint16)
    rows = bl.penalty_rows(pen)
    for sl in (0, 2, 7):
        for w in range(4):
            for lane in (0, 13, 31):
                words = bl.pen_words(pen, sl, w, lane)
                for h in range(2):
                    got = ((words >> np.uint32(16 * h)) & 0xFFFF).astype(np.uint32) << 16
                    block = sl * bl.SLICE_BLOCKS + 2 * w + h
                    assert np.array_equal(got, rows[block, 4 * lane : 4 * lane + 4].view(np.uint32))


@pytest.mark.parametrize(
    "values, fast",
    [
        ({}, True),  # all at pmax: fast, nothing replaced
        ({5: -600.0, 9: -512.0}, True),  # dominated rows only
        ({5: -600.0, 9: -100.0}, False),  # one row within 512 of pmax
        ({5: -np.inf}, False),  # not finite
        ({5: 3.0}, False),  # a new pmax; every other row 3 below it, not dominated
    ],
)
def test_the_plan_of_a_block(values, fast):
    p = np.zeros(128, np.float32)
    for r, v in values.items():
        p[r] = v
    got_fast, pmax, masks, first_top = bl.block_plan(p)
    assert got_fast == fast and pmax == p.max()
    assert first_top == int(np.argmax(p == p.max()))
    replaced = [4 * s + j for j in range(4) for s in range(32) if int(masks[j]) >> s & 1]
    assert sorted(replaced) == (sorted(r for r, v in values.items() if v <= p.max() - 512) if fast else [])


@pytest.mark.parametrize("nslices, sms", [(1, 132), (32, 132), (131, 132), (133, 132), (8192, 132), (100, 7)])
def test_every_slice_is_one_thread_blocks(nslices, sms):
    shares = bl.shares(nslices, sms)
    assert len(shares) == min(nslices, sms) and shares[0][0] == 0 and shares[-1][1] == nslices
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [e - f for f, e in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


# ------------------------------------------------------------ the flow


def _interpret_pallas_call(*args, **kwargs):
    kwargs.pop("compiler_params", None)
    kwargs["interpret"] = True
    return pl.pallas_call(*args, **kwargs)


@pytest.fixture(scope="module")
def script():
    """benchmarks/exp_bitplane_int8.py, its pallas_call in interpret mode."""
    spec = importlib.util.spec_from_file_location("_bench_exp_bitplane_int8_layout",
                                                  REPO / "benchmarks" / "exp_bitplane_int8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(pallas_call=_interpret_pallas_call, BlockSpec=pl.BlockSpec)
    return mod


def _penalty(kind, rng, n):
    """(N,) f32 penalty in original row order."""
    if kind == "tombstones":
        valid = rng.random(n) > 0.05
        valid[3 * 128 : 4 * 128] = False  # an all-dead block
        return np.where(valid, 0.0, -65536.0).astype(np.float32)
    if kind == "dead_blocks":
        return np.where(np.repeat(np.arange(n // 128) % 3 != 1, 128), 0.0, -65536.0).astype(np.float32)
    if kind == "per_element":
        return ((rng.random(n) - 0.5) * 400).astype(np.float32)
    # mixed: per block, rows at pmax, dominated rows and (every other block)
    # rows within 512 of pmax; pmax differs between blocks.
    pen = np.zeros(n, np.float32)
    for b in range(n // 128):
        pmax = np.float32(rng.integers(-8, 8) * 2.5)
        p = np.full(128, pmax, np.float32)
        p[rng.random(128) < 0.2] = pmax - 600 - rng.integers(0, 1000)  # dominated after bf16 rounding too
        if b % 2:
            p[rng.integers(0, 128, 3)] = pmax - rng.integers(1, 500)
        pen[b * 128 : (b + 1) * 128] = p
    return pen


def _case(kind, n, nq, seed):
    rng = np.random.default_rng(seed)
    packed = _packed(rng, n)
    q_codes = packed[rng.integers(0, n, nq)]
    q_lanes = np.where(np.arange(nq) % 2 == 0, 8, 6).astype(np.int32)
    q_pm1, q_scale = jax_pm1.prepare_queries(q_codes, q_lanes, 256)
    pen_bp = bitplane.bitplane_penalty_perm(torch.from_numpy(_penalty(kind, rng, n))).to(torch.bfloat16)
    twin = bitplane.bit_transpose_packed(torch.from_numpy(packed.view(np.int32)))
    return np.asarray(q_pm1).astype(np.int8), np.asarray(q_scale, np.float32), twin, pen_bp


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n, nq", [(8192, 13), (8192, 77), (32768, 13), (32768, 77)])
def test_the_flow_equals_plain_and_pallas(script, kind, n, nq):
    """The mirror == the plain version and == the script's kernel in
    interpret mode on every block, dead ones included; it counts its paths
    as the rule predicts."""
    q, qs, twin, pen_bp = _case(kind, n, nq, seed=n + nq)
    pen_bits = pen_bp.view(torch.int16).numpy()
    counts = [0, 0]
    got = bl.run(q, qs, twin.numpy(), pen_bits, counts=counts)
    want = port10.blockmax_bitplane_plain(torch.from_numpy(q), torch.from_numpy(qs), twin, pen_bp[None, :]).numpy()
    np.testing.assert_array_equal(got, want)
    assert tuple(counts) == bl.path_blocks(pen_bits, nq)
    fast_share = counts[1] / counts[0]
    assert fast_share == {"tombstones": 1.0, "dead_blocks": 1.0, "per_element": 0.0, "mixed": 0.5}[kind]
    pallas = np.asarray(
        script.make_variant(n, nq, 4096, 8, "int8")(
            jnp.asarray(q.astype(np.float32)), jnp.asarray(qs), jnp.asarray(twin.numpy().view(np.uint32)),
            jnp.asarray(pen_bits.view(jnp.bfloat16).reshape(1, n)),
        )
    )
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("kind", KINDS)
def test_the_flow_across_query_chunks_and_a_small_grid(kind):
    """Q=300: two launches (256 + 44 queries), every block counted once per
    launch; a grid of 3 thread blocks over 8 slices (shares of 3, 3, 2)."""
    q, qs, twin, pen_bp = _case(kind, 8192, 300, seed=5)
    pen_bits = pen_bp.view(torch.int16).numpy()
    counts = [0, 0]
    got = bl.run(q, qs, twin.numpy(), pen_bits, sms=3, counts=counts)
    want = port10.blockmax_bitplane_plain(torch.from_numpy(q), torch.from_numpy(qs), twin, pen_bp[None, :]).numpy()
    np.testing.assert_array_equal(got, want)
    assert tuple(counts) == bl.path_blocks(pen_bits, 300) and counts[0] == 2 * 64


def test_the_kernels_penalties_take_the_paths_they_name():
    valid = torch.from_numpy(np.random.default_rng(4).random(8192) > 0.05).to(torch.uint8)
    for general, share in ((False, 1.0), (True, 0.0)):
        pen = port10.bitplane_penalties(valid, general)
        assert pen.shape == (1, 8192) and pen.dtype == torch.bfloat16
        finished, fast = bl.path_blocks(pen.view(torch.int16).numpy(), 5)
        assert finished == 64 and fast == share * finished


# ------------------------------------------------- exp_bitplane_ablate


@pytest.mark.parametrize("name", sorted(exp_bitplane_ablate.VARIANTS))
def test_ablation_variant_builds_under_a_key_of_its_own(name):
    """Each variant builds ``blockmax_bitplane.cu`` alone, ``base`` with no
    define and every other with one ``ISCC_BITPLANE_ABLATE`` mask, each
    under a key of its own and never the port's library's."""
    defines = exp_bitplane_ablate.defines_of(name)
    mask = exp_bitplane_ablate.VARIANTS[name]
    assert 0 <= mask < 32 and (defines == () if name == "base" else defines == (f"ISCC_BITPLANE_ABLATE={mask}",))
    key = _build.build_key(defines, exp_bitplane_ablate.SOURCE)
    assert key != _build.build_key()
    others = {_build.build_key(exp_bitplane_ablate.defines_of(v), exp_bitplane_ablate.SOURCE)
              for v in exp_bitplane_ablate.VARIANTS if v != name}
    assert key not in others
    src = SOURCE.read_text()
    for bit, part in ((1, "kCutWgmma"), (2, "kCutEpilogue"), (4, "kCutStaging"), (8, "kCutUntranspose"),
                      (16, "kForceGeneral")):
        assert re.search(rf"constexpr bool {part} = ISCC_BITPLANE_ABLATE & {bit};", src), part


def test_ablation_compound_variants_are_the_union_of_their_parts():
    v = exp_bitplane_ablate.VARIANTS
    assert v["wgmma_only"] == v["no_epilogue"] | v["no_staging"] | v["no_untranspose"]
    assert v["stage_only"] == v["no_wgmma"] | v["no_epilogue"]
    assert sorted(v[n] for n in ("no_wgmma", "no_epilogue", "no_staging", "no_untranspose", "general")) == [
        1, 2, 4, 8, 16]
