"""CPU tests of ``csrc/blockmax_bitplane.cu``, one ``wgmma`` kernel templated
on the twin's element width: ``iscc_blockmax_bitplane`` (TPU kernel 10, W =
32) and ``iscc_blockmax_subword`` (TPU kernel 11, W = 8 and 16). Its flow
mirrored in numpy (``experiments/bitplane_layout.py``) against the port's
plain versions (``exp_bitplane_int8.blockmax_bitplane_plain``,
``exp_bitplane_u8.blockmax_subword_plain``) and against the scripts' Pallas
kernels (``benchmarks/exp_bitplane_int8.py`` ``make_variant`` and
``benchmarks/exp_bitplane_u8.py`` ``blockmax_subword_impl``, loaded from
their files with ``pl.pallas_call`` run in interpret mode); the byte
permutes of the un-transpose, the row tile's swizzle, the slice boxes, the
threads' shares and shared-memory turns, the penalty plans and path counts,
the shared-memory budget, each at every width.

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
from iscc_search_tpu_torch.experiments import exp_bitplane_u8 as port11
from iscc_search_tpu_torch.ops import _build, bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "iscc_search_tpu_torch" / "csrc" / "blockmax_bitplane.cu"
KINDS = ("tombstones", "dead_blocks", "per_element", "mixed")
SUBWORD = (16, 8)


def _const(src, name):
    m = re.search(rf"constexpr (?:int|uint32_t|float) {name} = ([^;]+);", src)
    return m.group(1).strip()


def _width_const(src, name):
    m = re.search(rf"static constexpr (?:int|bool) {name} = ([^;]+);", src)
    return m.group(1).strip()


def _kernel_source():
    src = SOURCE.read_text()
    return src[src.index("namespace planes {"):]


def test_the_mirror_carries_the_kernels_constants():
    src = _kernel_source()
    ints = {
        "kBlockRows": bl.BLOCK_ROWS, "kBits": bl.BITS, "kGroupBlocks": bl.GROUP_BLOCKS, "kBands": bl.BANDS,
        "kHoldBlocks": bl.HOLD_BLOCKS, "kFlushBlocks": bl.FLUSH_BLOCKS, "kTileQueries": bl.TILE_QUERIES,
        "kChunkQueries": bl.CHUNK_QUERIES, "kProducerThreads": bl.PRODUCER_THREADS,
        "kSwizzleBytes": bl.SWIZZLE_BYTES, "kDominance": bl.DOMINANCE,
    }
    for name, value in ints.items():
        assert int(_const(src, name)) == value, name
    assert _const(src, "kConsumerGroups") == "kChunkQueries / kTileQueries" and bl.CONSUMER_GROUPS == 4
    assert _const(src, "kConsumerThreads") == "kConsumerGroups * 128"
    assert _const(src, "kOutStride") == "kFlushBlocks + 1"
    assert _const(src, "kS8Atom") == "kBlockRows * kSwizzleBytes"
    assert _const(src, "kS8TileBytes") == "kBits / kSwizzleBytes * kS8Atom"
    assert int(_const(src, "kPlaneMask").rstrip("u"), 0) == bl.PLANE_MASK
    # What changes with the width (struct Width<W>), against the mirror's functions.
    width = {name: _width_const(src, name) for name in (
        "kPlaneBands", "kWordBlocks", "kSliceBlocks", "kSliceBufs", "kRowBytes", "kSliceBytes", "kHoldWords",
        "kHolds", "kPairSwap")}
    assert width == {
        "kPlaneBands": "32 / W", "kWordBlocks": "32 / W", "kSliceBlocks": "W == 8 ? 16 : 8",
        "kSliceBufs": "W == 8 ? 1 : 2", "kRowBytes": "kSliceBlocks * W / 8",
        "kSliceBytes": "kPlaneBands * kBits * kBands * kRowBytes", "kHoldWords": "W / 8",
        "kHolds": "kSliceBlocks / kHoldBlocks", "kPairSwap": "W < 32",
    }
    for w in bl.WIDTHS:
        assert bl.plane_bands(w) == 32 // w and bl.slice_blocks(w) == (16 if w == 8 else 8)
        assert bl.slice_bufs(w) == (1 if w == 8 else 2) and bl.row_bytes(w) == bl.slice_blocks(w) * w // 8
        assert bl.slice_bytes(w) == bl.plane_bands(w) * bl.BITS * bl.BANDS * bl.row_bytes(w)
        assert bl.hold_words(w) == w // 8
        k = np.arange(256)
        assert np.array_equal(bl.k_to_u(k, w), k ^ ((k >> 3) & 1) if w < 32 else k)
    # The byte transpose's selectors, in the order transpose4 applies them,
    # and the queries' pair swap.
    sels = [int(s, 16) for s in re.findall(r"__byte_perm\((?:e[02], e[13]|t[01], t[23]), (0x[0-9a-f]+)\)", src)]
    assert sels == [bl.PAIR_LO, bl.PAIR_HI, bl.PAIR_LO, bl.PAIR_HI, bl.HALF_LO, bl.HALF_HI, bl.HALF_LO, bl.HALF_HI]
    assert re.findall(r"__byte_perm\(v\.[zw], 0, (0x[0-9a-f]+)\)", src) == [hex(bl.PAIR_SWAP)] * 2
    # The producer thread's band and K bytes, its loads and the slice box.
    flat = " ".join(src.split())
    assert ("const int j1 = lane & 3; const int u0 = 128 * (w >> 1) + 16 * (4 * ((lane >> 3) & 1) + 2 * (w & 1) + "
            "((lane >> 4) & 1)) + 8 * ((lane >> 2) & 1);") in flat
    assert "const int swap = L::kPairSwap ? (u0 >> 3) & 1 : 0;" in flat
    assert "s_slice + sbuf * L::kSliceBytes + (u0 * kBands + j1) * L::kRowBytes" in flat
    assert "constexpr int kStep = kBands * L::kRowBytes;" in flat
    assert "const uint8_t* even = src + swap * kStep + h * kHoldBlocks * W / 8;" in flat
    assert "load_words((i & 1 ? odd : even) + (b * kBits + i) * kStep, e[b][i]);" in flat
    assert ("const cuuint32_t box[4] = {(cuuint32_t)L::kSliceBlocks, (cuuint32_t)kBands, (cuuint32_t)kBits, "
            "(cuuint32_t)L::kPlaneBands};") in flat
    assert "slice % kGroupSlices * L::kSliceBlocks + 2 * w;" in flat  # load_pens: warp w's pairs
    assert "src + 8 * p + j * 32" in flat
    assert "const int sel = sp % L::kPlaneBands * kBytes + (s >> 3);" in flat  # plane_word
    assert "return (word >> ((cw * W + s) & 7)) & kPlaneMask;" in flat
    assert "smem_desc_sw128(smem_addr(s_rows + b * kS8TileBytes))" in flat
    # The shared-memory formula the mirror reckons the budget with.
    assert ("2 * kS8TileBytes + L::kSliceBufs * L::kSliceBytes + kS8Chunks * qc * 16 + qc * 8 + "
            "2 * L::kSliceBlocks * kBlockRows * 4 + 2 * L::kSliceBlocks * (int)sizeof(BlockPlan<int>) + "
            "qc * kOutStride * 4 + 6 * 8 + 1024") in flat
    plan = re.search(r"struct BlockPlan \{(.*?)\};", src, re.S).group(1)
    assert len(re.findall(r"^\s*(?:V|int) \w+;", plan, re.M)) == 4 and "uint32_t dom[kBands];" in plan
    assert bl.PLAN_BYTES == 4 * 4 + 4 * bl.BANDS
    # One templated kernel: kernel 10 at W = 32 (bf16), kernel 11 at 8 and 16
    # (int32); no mma.sync path is left.
    whole = SOURCE.read_text()
    assert re.findall(r"planes::launch<(\d+), planes::(\w+)>", whole) == [
        ("32", "EpiBf16"), ("8", "EpiInt32"), ("16", "EpiInt32")]
    assert "mma.sync" not in whole and "#include \"" not in whole
    assert not (SOURCE.parent / "mma_s8.cuh").exists()


@pytest.mark.parametrize("width", bl.WIDTHS)
@pytest.mark.parametrize("qc", (128, 256))
def test_shared_memory_fits_a_thread_block(qc, width):
    assert bl.smem_bytes(qc, width) <= bl.SMEM_LIMIT
    assert bl.smem_bytes(256, width) == {32: 217648, 16: 217648, 8: 226352}[width]


# ------------------------------------------------------------ arithmetic


def test_transpose4_gathers_byte_b_of_each_element_and_plane_words_are_bits():
    rng = np.random.default_rng(0)
    e = rng.integers(0, 2**32, (4, 4096), dtype=np.uint64).astype(np.uint32)
    planes = bl.transpose4(*e)
    for b in range(4):
        for k in range(4):
            assert np.array_equal((planes[b] >> np.uint32(8 * k)) & 0xFF, (e[k] >> np.uint32(8 * b)) & 0xFF)
    hold = np.stack(planes)[None, :, None, :]  # W = 32: one band, K bytes 0-3 of block 0
    for s in range(32):
        word = bl.plane_word(hold, 0, 0, s, 32)
        for k in range(4):
            assert np.array_equal((word >> np.uint32(8 * k)) & 0xFF, (e[k] >> np.uint32(s)) & 1)


@pytest.mark.parametrize("width", bl.WIDTHS)
def test_plane_words_are_the_bits_of_each_block(width):
    """After the in-place transpose, plane_word(c, g, s') byte m is bit s of
    band b's element of hold block c at K byte 4 g + m (s' = s * bands + b;
    block c is bits (c % bands) * W .. of word c // bands)."""
    rng = np.random.default_rng(width)
    bands, nw = bl.plane_bands(width), bl.hold_words(width)
    raw = rng.integers(0, 2**32, (bands, 8, nw, 64), dtype=np.uint64).astype(np.uint32)
    hold = raw.copy()
    for b in range(bands):
        for g in range(2):
            for v in range(nw):
                hold[b, 4 * g : 4 * g + 4, v] = bl.transpose4(*raw[b, 4 * g : 4 * g + 4, v])
    for c in range(bl.HOLD_BLOCKS):
        elements = (raw[:, :, c // bands] >> np.uint32(c % bands * width)).astype(np.uint64)  # (bands, 8, 64)
        for g in range(2):
            for sp in range(32):
                b, s_bit = sp % bands, sp // bands
                word = bl.plane_word(hold, c, g, sp, width)
                for m in range(4):
                    want = (elements[b, 4 * g + m] >> np.uint64(s_bit)) & np.uint64(1)
                    assert np.array_equal((word >> np.uint32(8 * m)) & 0xFF, want)


def test_each_producer_thread_owns_one_band_and_eight_k_bytes():
    j1, u0 = bl.producer_thread(np.arange(bl.PRODUCER_THREADS))
    assert np.all(u0 % 8 == 0) and u0.max() < bl.BITS
    pairs = set(zip(j1.tolist(), u0.tolist()))
    assert pairs == {(j, u) for j in range(bl.BANDS) for u in range(0, bl.BITS, 8)}


@pytest.mark.parametrize("width, load_turns", [(32, 8), (16, 4), (8, 4)])
def test_shared_memory_turns_of_the_slice_loads_and_row_stores(width, load_turns):
    """A slice load takes at most twice the ideal turns at W = 32 (16 bytes a
    lane; a quarter-warp's lanes of one band differ only in u); below, the
    least a load of 8 or 4 bytes of one block quad can take (16 or 8 banks
    hold it), which the pair swap of odd octets halves from 8; a row store
    (8 bytes a lane, four rows of one s') takes the ideal two."""
    for w in range(4):
        p = 32 * w + np.arange(32)
        j1, u0 = bl.producer_thread(p)
        for h in range(bl.slice_blocks(width) // bl.HOLD_BLOCKS):
            for b in range(bl.plane_bands(width)):
                for i in range(8):
                    assert bl.wavefronts(bl.load_address(p, b, i, h, width), width // 2) == load_turns
                    if width < 32:  # without the swap: every lane of a band on one parity of u
                        plain = bl.slice_offset(b, u0 + i, j1, bl.HOLD_BLOCKS * h, width)
                        assert bl.wavefronts(plain, width // 2) == 8
        for sp in range(32):
            assert bl.wavefronts(bl.s8_offset(4 * sp + j1, u0), 8) == 2


def _twin(packed, width):
    t = torch.from_numpy(packed.view(np.int32))
    return (bitplane.bit_transpose_packed(t) if width == 32 else bitplane.build_twin(t, width)).numpy()


@pytest.mark.parametrize("width", bl.WIDTHS)
def test_slice_offsets_follow_the_tma_box(width):
    rng = np.random.default_rng(width)
    twin = _twin(_packed(rng, 8192), width)
    raw = twin.view(np.uint8).reshape(2, bl.plane_bands(width), bl.BITS, bl.BANDS, bl.GROUP_BLOCKS, width // 8)
    b, u, j1, c = np.meshgrid(np.arange(bl.plane_bands(width)), np.arange(bl.BITS), np.arange(bl.BANDS),
                              np.arange(bl.slice_blocks(width)), indexing="ij")
    for sl in range(2 * bl.GROUP_BLOCKS // bl.slice_blocks(width)):
        box = bl.slice_box(twin, sl, width)
        assert box.dtype == np.uint8 and box.size == bl.slice_bytes(width)
        g, first = divmod(sl * bl.slice_blocks(width), bl.GROUP_BLOCKS)
        for byte in range(width // 8):
            assert np.array_equal(box[bl.slice_offset(b, u, j1, c, width) + byte], raw[g, b, u, j1, first + c, byte])


def _packed(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("width", bl.WIDTHS)
def test_untransposed_rows_equal_the_unpacked_packed_rows(width):
    """Row r of block j0's tile is original row j0 * 128 + r of its group,
    as 0/1 bytes in unpack order once the tile's K order is undone, read
    back through the swizzle."""
    rng = np.random.default_rng(1)
    packed = _packed(rng, 8192)
    twin = _twin(packed, width)
    bits01 = (hs.build_unpacked_db(torch.from_numpy(packed.view(np.int32)), 256).numpy() + 1) // 2
    no_masks = np.zeros(bl.BANDS, np.uint64)
    u_of_k = bl.k_to_u(np.arange(bl.BITS), width)
    for sl in (0, 3) if width == 8 else (0, 3, 5, 7):
        box = bl.slice_box(twin, sl, width)
        for c in range(bl.slice_blocks(width)):
            block = sl * bl.slice_blocks(width) + c
            rows = np.empty((bl.BLOCK_ROWS, bl.BITS), np.int8)
            rows[:, u_of_k] = bl.tile_rows(bl.untranspose(box, c, no_masks, 0, width))
            assert np.array_equal(rows, bits01[block * 128 : (block + 1) * 128])


@pytest.mark.parametrize("width", bl.WIDTHS)
def test_dominated_rows_are_stored_as_copies_of_the_first_top_row(width):
    rng = np.random.default_rng(2)
    box = bl.slice_box(_twin(_packed(rng, 4096), width), 1, width)
    p = np.zeros(128, np.float32 if width == 32 else np.int32)
    dead = np.array([0, 1, 6, 77, 127])
    p[dead] = -65536 if width == 32 else -32768
    fast, pmax, masks, first_top = bl.block_plan(p)
    assert fast and pmax == 0 and first_top == 2
    assert [int(m).bit_count() for m in masks] == [1, 2, 1, 1]  # band r % 4: rows 0 | 1, 77 | 6 | 127
    plain = bl.tile_rows(bl.untranspose(box, 5, np.zeros(4, np.uint64), 0, width))
    got = bl.tile_rows(bl.untranspose(box, 5, masks, first_top, width))
    live = np.setdiff1d(np.arange(128), dead)
    assert np.array_equal(got[live], plain[live])
    assert np.array_equal(got[dead], np.repeat(plain[first_top][None], len(dead), axis=0))


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("width", bl.WIDTHS)
def test_pen_words_hold_two_blocks_of_each_band(width):
    rng = np.random.default_rng(3)
    if width == 32:
        pen = rng.integers(0, 2**16, 8192, dtype=np.uint64).astype(np.uint16)
    else:
        pen = rng.integers(-(2**20), 2**20, 8192).astype(np.int32)
    rows = bl.penalty_rows(pen, width=width)
    for sl in (0, 2, 3):
        for w in range(4):
            for lane in (0, 13, 31):
                for pair in range(bl.slice_blocks(width) // 8):
                    words = bl.pen_words(pen, sl, w, lane, pair, width)
                    for h in range(2):
                        block = sl * bl.slice_blocks(width) + 8 * pair + 2 * w + h
                        want = rows[block, 4 * lane : 4 * lane + 4]
                        if width == 32:
                            got = ((words >> np.uint32(16 * h)) & 0xFFFF).astype(np.uint32) << 16
                            assert np.array_equal(got, want.view(np.uint32))
                        else:
                            assert np.array_equal(words[:, h], want)


_PLAN_CASES = [
    ({}, True),  # all at pmax: fast, nothing replaced
    ({5: -600, 9: -512}, True),  # dominated rows only
    ({5: -600, 9: -100}, False),  # one row within 512 of pmax
    ({5: 3}, False),  # a new pmax; every other row 3 below it, not dominated
    ({5: -32768, 6: -32768}, True),  # tombstones of the int32 epilogue
]


@pytest.mark.parametrize(
    "values, fast, dtype",
    [(v, f, d) for v, f in _PLAN_CASES for d in (np.float32, np.int32)]
    + [
        ({5: -np.inf}, False, np.float32),  # not finite
        ({5: -(2**29), 6: 2**29, 7: 2**29 - 1}, False, np.int32),  # the int32 contract's extremes
    ],
)
def test_the_plan_of_a_block(values, fast, dtype):
    p = np.zeros(128, dtype)
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


def _load_script(name):
    """benchmarks/<name>.py, its pallas_call in interpret mode."""
    spec = importlib.util.spec_from_file_location(f"_bench_{name}_layout", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(pallas_call=_interpret_pallas_call, BlockSpec=pl.BlockSpec)
    return mod


@pytest.fixture(scope="module")
def script():
    return _load_script("exp_bitplane_int8")


@pytest.fixture(scope="module")
def script11():
    return _load_script("exp_bitplane_u8")


def _validity(kind, rng, n):
    if kind == "tombstones":
        valid = rng.random(n) > 0.05
        valid[3 * 128 : 4 * 128] = False  # an all-dead block
        return valid
    return np.repeat(np.arange(n // 128) % 3 != 1, 128)  # dead_blocks


def _penalty(kind, rng, n, width=32):
    """(N,) penalty in original row order: f32 at W = 32, else int32."""
    if kind in ("tombstones", "dead_blocks"):
        dead = -65536 if width == 32 else port11.PENALTY
        return np.where(_validity(kind, rng, n), 0, dead).astype(np.float32 if width == 32 else np.int32)
    if kind == "per_element":
        if width == 32:
            return ((rng.random(n) - 0.5) * 400).astype(np.float32)
        return rng.integers(-200, 200, n).astype(np.int32)
    # mixed: per block, rows at pmax, dominated rows and (every other block)
    # rows within 512 of pmax; pmax differs between blocks.
    pen = np.zeros(n, np.float32)
    for b in range(n // 128):
        pmax = np.float32(rng.integers(-8, 8) * 2.5) if width == 32 else np.float32(rng.integers(-300, 300))
        p = np.full(128, pmax, np.float32)
        p[rng.random(128) < 0.2] = pmax - 600 - rng.integers(0, 1000)  # dominated after bf16 rounding too
        if b % 2:
            p[rng.integers(0, 128, 3)] = pmax - rng.integers(1, 500)
        pen[b * 128 : (b + 1) * 128] = p
    return pen if width == 32 else pen.astype(np.int32)


def _queries(rng, packed, nq):
    q_codes = packed[rng.integers(0, len(packed), nq)]
    q_lanes = np.where(np.arange(nq) % 2 == 0, 8, 6).astype(np.int32)
    q_pm1, q_scale = jax_pm1.prepare_queries(q_codes, q_lanes, 256)
    return np.asarray(q_pm1).astype(np.int8), np.asarray(q_scale, np.float32)


def _case(kind, n, nq, seed):
    rng = np.random.default_rng(seed)
    packed = _packed(rng, n)
    q, qs = _queries(rng, packed, nq)
    pen_bp = bitplane.bitplane_penalty_perm(torch.from_numpy(_penalty(kind, rng, n))).to(torch.bfloat16)
    twin = bitplane.bit_transpose_packed(torch.from_numpy(packed.view(np.int32)))
    return q, qs, twin, pen_bp


def _subword_case(kind, n, nq, seed, width):
    """The kernel-11 inputs, with the validity where the penalty is one."""
    rng = np.random.default_rng(seed)
    packed = _packed(rng, n)
    q, qs = _queries(rng, packed, nq)
    valid = _validity(kind, np.random.default_rng(seed + 1), n) if kind in ("tombstones", "dead_blocks") else None
    pen = _penalty(kind, np.random.default_rng(seed + 1), n, width)
    twin = bitplane.build_twin(torch.from_numpy(packed.view(np.int32)), width)
    pen_t = bitplane.penalty_perm(torch.from_numpy(pen), width).reshape(1, n)
    return packed, q, qs, twin, pen_t, valid


_SHARES = {"tombstones": 1.0, "dead_blocks": 1.0, "per_element": 0.0, "mixed": 0.5}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n, nq", [(8192, 13), (8192, 77), (32768, 13), (32768, 77)])
def test_the_flow_equals_plain_and_pallas(script, kind, n, nq):
    """Kernel 10 (W = 32): the mirror == the plain version and == the
    script's kernel in interpret mode on every block, dead ones included; it
    counts its paths as the rule predicts."""
    q, qs, twin, pen_bp = _case(kind, n, nq, seed=n + nq)
    pen_bits = pen_bp.view(torch.int16).numpy()
    counts = [0, 0]
    got = bl.run(q, qs, twin.numpy(), pen_bits, counts=counts)
    want = port10.blockmax_bitplane_plain(torch.from_numpy(q), torch.from_numpy(qs), twin, pen_bp[None, :]).numpy()
    np.testing.assert_array_equal(got, want)
    assert tuple(counts) == bl.path_blocks(pen_bits, nq)
    assert counts[1] / counts[0] == _SHARES[kind]
    pallas = np.asarray(
        script.make_variant(n, nq, 4096, 8, "int8")(
            jnp.asarray(q.astype(np.float32)), jnp.asarray(qs), jnp.asarray(twin.numpy().view(np.uint32)),
            jnp.asarray(pen_bits.view(jnp.bfloat16).reshape(1, n)),
        )
    )
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("width", SUBWORD)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n, nq", [(8192, 13), (32768, 77)])
def test_the_subword_flow_equals_plain_and_pallas(script11, kind, n, nq, width):
    """Kernel 11 (W = 16 and 8, the int32 epilogue): the mirror == the plain
    version on every block and counts its paths as the rule predicts; where
    the penalty is the validity's 0 / -32768, it also == the script's
    ``blockmax_subword_impl`` in interpret mode, all-invalid blocks
    included."""
    packed, q, qs, twin, pen, valid = _subword_case(kind, n, nq, n + nq + width, width)
    counts = [0, 0]
    got = bl.run(q, qs, twin.numpy(), pen.numpy(), width=width, counts=counts)
    want = port11.blockmax_subword_plain(torch.from_numpy(q), torch.from_numpy(qs), twin, pen, width).numpy()
    np.testing.assert_array_equal(got, want)
    assert tuple(counts) == bl.path_blocks(pen.numpy(), nq, width)
    assert counts[1] / counts[0] == _SHARES[kind]
    if valid is not None:
        pallas = np.asarray(
            script11.blockmax_subword_impl(
                jnp.asarray(q.astype(np.float32)), jnp.asarray(qs), script11.build_twin(jnp.asarray(packed), width),
                jnp.asarray(valid), width, 4096, interpret=True,
            )
        )
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("width", bl.WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_the_flow_across_query_chunks_and_a_small_grid(kind, width):
    """Q=300: two launches (256 + 44 queries), every block counted once per
    launch; a grid of 3 thread blocks over the slices (8 at W = 32 and 16:
    shares of 3, 3, 2; 4 at W = 8: 2, 1, 1)."""
    if width == 32:
        q, qs, twin, pen_bp = _case(kind, 8192, 300, seed=5)
        pen = pen_bp.view(torch.int16).numpy()
        want = port10.blockmax_bitplane_plain(torch.from_numpy(q), torch.from_numpy(qs), twin, pen_bp[None, :])
    else:
        _, q, qs, twin, pen_t, _ = _subword_case(kind, 8192, 300, 5, width)
        pen = pen_t.numpy()
        want = port11.blockmax_subword_plain(torch.from_numpy(q), torch.from_numpy(qs), twin, pen_t, width)
    counts = [0, 0]
    got = bl.run(q, qs, twin.numpy(), pen, width=width, sms=3, counts=counts)
    np.testing.assert_array_equal(got, want.numpy())
    assert tuple(counts) == bl.path_blocks(pen, 300, width) and counts[0] == 2 * 64


@pytest.mark.parametrize("width", bl.WIDTHS)
def test_the_kernels_penalties_take_the_paths_they_name(width):
    valid = torch.from_numpy(np.random.default_rng(4).random(8192) > 0.05).to(torch.uint8)
    valid[3 * 128 : 4 * 128] = 0  # an all-dead block
    for general in (False, True):
        if width == 32:
            pen = port10.bitplane_penalties(valid, general)
            assert pen.shape == (1, 8192) and pen.dtype == torch.bfloat16
            finished, fast = bl.path_blocks(pen.view(torch.int16).numpy(), 5)
            assert finished == 64 and fast == (0 if general else 64)
        else:
            pen = port11.subword_penalty(valid, width, general)
            assert pen.shape == (1, 8192) and pen.dtype == torch.int32
            flat = pen.numpy().reshape(-1)
            live = flat[flat > port11.PENALTY]
            assert flat.min() == port11.PENALTY and live.max() - live.min() < 400
            finished, fast = bl.path_blocks(flat, 5, width)
            assert finished == 64 and fast == (1 if general else 64)  # general: the all-dead block alone


# ------------------------------------------------- exp_bitplane_ablate


@pytest.mark.parametrize("width", exp_bitplane_ablate.WIDTHS)
@pytest.mark.parametrize("name", sorted(exp_bitplane_ablate.VARIANTS))
def test_ablation_variant_builds_under_a_key_of_its_own(name, width):
    """Each variant builds ``blockmax_bitplane.cu`` alone, ``base`` with no
    define and every other with one ``ISCC_BITPLANE_ABLATE`` mask, each
    under a key of its own and never the port's library's; one build serves
    every width (the mask cuts the one templated kernel), which the script
    calls through the width's entry with the width's twin and penalty."""
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
    entry = exp_bitplane_ablate.entry_of(width)
    assert entry == ("iscc_blockmax_bitplane" if width == 32 else "iscc_blockmax_subword")
    packed = torch.from_numpy(_packed(np.random.default_rng(width), 4096).view(np.int32))
    valid = torch.ones(4096, dtype=torch.uint8)
    twin, pen, extra = exp_bitplane_ablate.inputs_of(width, packed, valid, name == "general")
    assert twin.shape == (4096 * 32 // width // 16, 128) and pen.shape == (1, 4096)
    assert pen.dtype == (torch.bfloat16 if width == 32 else torch.int32)
    assert len(hs._SIGNATURES[entry]) == 8 + len(extra) and extra == (() if width == 32 else (width,))


def test_ablation_compound_variants_are_the_union_of_their_parts():
    v = exp_bitplane_ablate.VARIANTS
    assert v["wgmma_only"] == v["no_epilogue"] | v["no_staging"] | v["no_untranspose"]
    assert v["stage_only"] == v["no_wgmma"] | v["no_epilogue"]
    assert sorted(v[n] for n in ("no_wgmma", "no_epilogue", "no_staging", "no_untranspose", "general")) == [
        1, 2, 4, 8, 16]
    with pytest.raises(ValueError, match="width"):
        exp_bitplane_ablate.entry_of(4)
