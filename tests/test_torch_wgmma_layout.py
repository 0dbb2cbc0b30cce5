"""CPU tests of what the redesigned Hopper kernels rest on: the ``wgmma``
shared-memory layout and descriptor that ``csrc/blockmax_mma.cu`` writes
(mirrored in ``ops/wgmma_layout.py``), emulated end to end against the plain
phase 1, and the nibble-shift form of ``csrc/int4_dot.cu`` in numpy.

Everything here is exact integer arithmetic: comparisons are equalities.
The kernels themselves run only on a card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.experiments import exp_int4, exp_wgmma_ablate
from iscc_search_tpu_torch.ops import _build
from iscc_search_tpu_torch.ops import bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import wgmma_layout as wl
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, query_prefix, unpack_pm1

WIDTHS = (64, 128, 192, 256)
# (rows, pad) of the kernel's two tiles: 64 queries of a 512-query chunk
# are addressed inside a 512-row panel; the row tile is padded.
OPERANDS = {"queries": (512, 0), "rows": (128, wl.ROWS_PAD)}


def _offsets(rows, kbytes, lbo, sbo):
    r = torch.arange(rows)[:, None]
    k = torch.arange(kbytes)[None, :]
    return wl.element_offset(r, k, lbo, sbo)


@pytest.mark.parametrize("operand", sorted(OPERANDS))
@pytest.mark.parametrize("nbits", WIDTHS)
def test_layout_is_a_bijection_onto_the_tile(nbits, operand):
    """Every (row, byte) has its own address, the image holds rows x nbits
    bytes plus the pads, and each core matrix is 128 contiguous bytes."""
    rows, pad = OPERANDS[operand]
    lbo, sbo = wl.panel_lbo(rows, pad), wl.CORE_BYTES
    off = _offsets(rows, nbits, lbo, sbo)
    flat = off.reshape(-1)
    assert flat.unique().numel() == rows * nbits and int(flat.min()) == 0
    chunks = nbits // 16
    assert wl.image_bytes(rows, nbits, lbo, sbo) == chunks * rows * 16 + (chunks - 1) * pad
    core = off.reshape(rows // 8, 8, chunks, 16).permute(0, 2, 1, 3).reshape(rows // 8, chunks, 128)
    assert torch.equal(core - core[:, :, :1], torch.arange(128).expand_as(core))
    assert bool((core[:, :, 0] % 16 == 0).all())


@pytest.mark.parametrize("nbits", WIDTHS)
def test_a_kstep_reads_two_core_matrices_one_lbo_apart(nbits):
    """k-step s of a tile starts 2 * s * LBO in; its bytes 0-15 of row r lie
    at r * 16 from there (SBO = 128 keeps the 8-row groups contiguous) and
    its bytes 16-31 one LBO further."""
    rows, pad = OPERANDS["rows"]
    lbo, sbo = wl.panel_lbo(rows, pad), wl.CORE_BYTES
    off = _offsets(rows, nbits, lbo, sbo)
    base = 4096
    for ks in range(nbits // 32):
        start = (wl.kstep_descriptor(base, lbo, sbo, ks) & 0x3FFF) * 16 - base
        assert start == 2 * ks * lbo
        step = off[:, 32 * ks : 32 * ks + 32] - start
        assert torch.equal(step[:, :16], torch.arange(rows)[:, None] * 16 + torch.arange(16))
        assert torch.equal(step[:, 16:], step[:, :16] + lbo)


@pytest.mark.parametrize("nbits", WIDTHS)
def test_to_image_places_every_byte_and_zeroes_the_gaps(nbits):
    rng = np.random.default_rng(nbits)
    rows, pad = OPERANDS["rows"]
    lbo, sbo = wl.panel_lbo(rows, pad), wl.CORE_BYTES
    tile = torch.from_numpy(rng.integers(-128, 128, (rows, nbits), dtype=np.int8))
    image = wl.to_image(tile, lbo, sbo)
    assert image.dtype == torch.int8 and image.numel() % 16 == 0
    off = _offsets(rows, nbits, lbo, sbo)
    assert torch.equal(image[off], tile)
    gaps = torch.ones(image.numel(), dtype=torch.bool)
    gaps[off.reshape(-1)] = False
    assert int(gaps.sum()) == image.numel() - rows * nbits and not bool(image[gaps].any())


def test_to_image_refuses_layouts_that_overlap_or_are_not_16_byte_pieces():
    tile = torch.zeros((64, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="overlap"):
        wl.to_image(tile, 512, 128)  # a 64-row panel needs 1024 bytes
    with pytest.raises(ValueError, match="16-byte pieces"):
        wl.to_image(tile, 1032, 128)
    with pytest.raises(ValueError, match="16-byte pieces"):
        wl.to_image(torch.zeros((60, 64), dtype=torch.int8), 1024, 128)
    with pytest.raises(ValueError, match="multiple"):
        wl.panel_lbo(64, 8)


@pytest.mark.parametrize(
    "addr,lbo,sbo",
    [(0, 16, 16), (0x1230, 2064, 128), (66304, 8192, 128), (0x3FFF0, 0x3FFF0, 0x3FFF0)],
)
def test_descriptor_packs_its_fields_into_the_right_bits(addr, lbo, sbo):
    desc = wl.descriptor(addr, lbo, sbo)
    assert desc & 0x3FFF == addr >> 4
    assert (desc >> 16) & 0x3FFF == lbo >> 4
    assert (desc >> 32) & 0x3FFF == sbo >> 4
    assert desc >> 62 == wl.LAYOUT_INTERLEAVE == 0
    # nothing outside the three fields
    assert desc & ~(0x3FFF | 0x3FFF << 16 | 0x3FFF << 32) == 0
    assert wl.descriptor(addr, lbo, sbo, layout=1) == desc | 1 << 62


def test_descriptor_refuses_fields_that_do_not_fit():
    for bad in ((8, 16, 16), (0, 24, 16), (0, 16, 8), (1 << 18, 16, 16), (0, 1 << 18, 16), (0, 16, 1 << 18)):
        with pytest.raises(ValueError):
            wl.descriptor(*bad)
    with pytest.raises(ValueError):
        wl.descriptor(0, 16, 16, layout=4)


def test_accumulator_coords_cover_the_tile_as_mma_sync_fragments():
    """128 threads x 64 registers cover the 64 x 128 tile once, and n-tile j
    is mma.sync's C fragment: registers 4j, 4j + 1 rows g, 4j + 2, 4j + 3
    rows g + 8 of the warp's 16, columns 8j + 2t, 8j + 2t + 1."""
    seen = np.zeros((wl.TILE_M, wl.TILE_N), np.int32)
    for thread in range(128):
        for reg in range(64):
            m, n = wl.accumulator_coords(thread, reg)
            seen[m, n] += 1
    assert (seen == 1).all()
    w, g, t, j = 2, 5, 3, 9
    thread = 32 * w + 4 * g + t
    assert [wl.accumulator_coords(thread, 4 * j + i) for i in range(4)] == [
        (16 * w + g, 8 * j + 2 * t), (16 * w + g, 8 * j + 2 * t + 1),
        (16 * w + g + 8, 8 * j + 2 * t), (16 * w + g + 8, 8 * j + 2 * t + 1),
    ]


@pytest.mark.parametrize("kbytes", (32, 192, 256))
def test_wgmma_tile_on_the_cpu_is_the_integer_product(kbytes):
    rng = np.random.default_rng(kbytes)
    a = rng.integers(-128, 128, (64, kbytes), dtype=np.int8)
    b = rng.integers(-128, 128, (128, kbytes), dtype=np.int8)
    before = wl.wgmma_tile.launches
    got = wl.wgmma_tile(torch.from_numpy(a), torch.from_numpy(b))
    assert wl.wgmma_tile.launches == before  # the plain version counts no launch
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32).T)


def test_wgmma_tile_checks_its_inputs():
    a, b = torch.zeros((64, 64), dtype=torch.int8), torch.zeros((128, 64), dtype=torch.int8)
    for bad_a, bad_b in ((a[:32].contiguous(), b), (a, b[:64].contiguous()), (a[:, :48].contiguous(), b[:, :48].contiguous()),
                         (a.to(torch.uint8), b), (a, torch.zeros((128, 32), dtype=torch.int8))):
        with pytest.raises(ValueError):
            wl.wgmma_tile(bad_a, bad_b)
    with pytest.raises(RuntimeError, match="meta"):
        wl.wgmma_tile(a.to("meta"), b.to("meta"))
    assert hs._SIGNATURES["iscc_wgmma_tile"] == (hs._P, hs._I, hs._I, hs._I, hs._P, hs._I, hs._I, hs._I, hs._I, hs._P, hs._P)


# ------------------------------------------ the kernel's flow, emulated


def _nibble_pm1(nib):
    """``nibble_pm1`` of the kernel: four ±1 bytes from a nibble."""
    spread = (nib * 0x00204081) & 0x01010101
    return ((spread * 0xFE) ^ 0xFFFFFFFF) & 0xFFFFFFFF


def _brev(w):
    return int(f"{w:032b}"[::-1], 2)


def _store_word_pm1(image, chunk0, lbo, word):
    """``store_word_pm1`` of the kernel: the word's two 16-byte k-chunks."""
    r = _brev(int(word) & 0xFFFFFFFF)
    for half in range(2):
        regs = [_nibble_pm1((r >> (4 * (4 * half + m))) & 0xF) for m in range(4)]
        image[chunk0 + half * lbo : chunk0 + half * lbo + 16] = np.array(regs, "<u4").view(np.int8)


def _read_tile(image, base, lbo, sbo, rows, kstep):
    """What one wgmma k-step reads through a descriptor: (rows, 32) int8."""
    start = (wl.kstep_descriptor(base, lbo, sbo, kstep) & 0x3FFF) * 16
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return image[start + wl.element_offset(r, k, lbo, sbo)]


def _source_rows(valid):
    """``RowStage::source_row`` of the kernel for every row of a block: the
    row itself if it is valid or none is, else the block's first valid row,
    found as the kernel finds it (four validity bytes per lane, a ballot)."""
    words = valid.reshape(32, 4)
    lanes_with_valid = [lane for lane in range(32) if words[lane].any()]
    if not lanes_with_valid:
        return np.arange(128), True
    first_lane = lanes_with_valid[0]
    first = 4 * first_lane + int(np.flatnonzero(words[first_lane])[0])
    return np.where(valid != 0, np.arange(128), first), False


@pytest.mark.parametrize("valid_rows", ("most", "one", "none"))
@pytest.mark.parametrize("lanes", range(1, 9))
def test_kernel_flow_emulated_equals_plain_phase1(lanes, valid_rows):
    """The kernel's staging formulas (each invalid row replaced by the
    block's first valid row), descriptors, accumulator layout and epilogue
    (a plain maximum; the penalty only off a block without a valid row), run
    in numpy on one 128-row block and 128 queries' tiles (some queries
    short, some past nq), against ``blockmax_plain``."""
    rng = np.random.default_rng(lanes)
    nbits, nq, qc = 32 * lanes, 77, 128
    db = rng.integers(0, 2**32, (128, lanes), dtype=np.uint32)
    valid = (rng.random(128) > 0.2).astype(np.uint8)
    valid[:5] = 0  # the first valid row is not row 0
    if valid_rows == "one":
        valid[:] = 0
        valid[77] = 1
    elif valid_rows == "none":
        valid[:] = 0
    q_codes = rng.integers(0, 2**32, (nq, 8), dtype=np.uint32)
    q_lanes = torch.from_numpy(rng.integers(1, 9, nq).astype(np.int32))
    min_lanes, q_scale = query_prefix(q_lanes, nbits)
    q_packed = torch.from_numpy(q_codes.view(np.int32))
    source, none_valid = _source_rows(valid)
    assert none_valid == (valid_rows == "none") and bool(valid[source].all()) != none_valid

    # Staging, with the kernel's address arithmetic: a team of 256 threads.
    rows_lbo, q_lbo = wl.panel_lbo(128, wl.ROWS_PAD), qc * 16
    rows_base = 0
    q_base = 2 * (2 * lanes * rows_lbo)  # past the two teams' row tiles
    smem = np.zeros(q_base + 2 * lanes * q_lbo, np.int8)
    for t in range(256):
        for j in range((lanes + 1) // 2):
            lane = (t >> 7) + 2 * j
            if lane < lanes:
                word = db[source[t & 127], lane]
                _store_word_pm1(smem, rows_base + 2 * lane * rows_lbo + (t & 127) * 16, rows_lbo, word)
    for i in range(qc * lanes):
        qi, lane = i % qc, i // qc
        if qi < nq and lane < int(min_lanes[qi]):
            _store_word_pm1(smem, q_base + 2 * lane * q_lbo + qi * 16, q_lbo, q_codes[qi, lane])
    assert q_base % 16 == 0

    # The row tile as the twin entry lays it out, piece by piece.
    twin = hs.build_unpacked_db(torch.from_numpy(db.view(np.int32)), nbits).numpy()
    twin_smem = np.zeros_like(smem)
    chunks = 2 * lanes
    for i in range(128 * chunks):
        r, c = divmod(i, chunks)
        piece = (source[r] * chunks + c) * 16
        twin_smem[c * rows_lbo + r * 16 : c * rows_lbo + r * 16 + 16] = twin.reshape(-1)[piece : piece + 16]
    assert np.array_equal(twin_smem[: chunks * rows_lbo], smem[: chunks * rows_lbo])

    # The wgmmas through their descriptors: each warpgroup of the team its tile.
    want_rows = unpack_pm1(torch.from_numpy(db.view(np.int32)), nbits).numpy()
    want_q = np.zeros((qc, nbits), np.float32)
    want_q[:nq] = masked_queries(q_packed, min_lanes, nbits).numpy()
    best = np.full(qc, np.iinfo(np.int32).min, np.int64)
    for member in range(2):
        q_addr = q_base + member * 64 * 16
        d = np.zeros((64, 128), np.int64)
        for ks in range(lanes):
            a = _read_tile(smem, q_addr, q_lbo, wl.CORE_BYTES, 64, ks).astype(np.int64)
            b = _read_tile(smem, rows_base, rows_lbo, wl.CORE_BYTES, 128, ks).astype(np.int64)
            d += a @ b.T
        tile_q = want_q[64 * member : 64 * member + 64]
        assert np.array_equal(d, (tile_q @ want_rows[source].T).astype(np.int64))
        # The epilogue per thread: a plain maximum, the t lanes' finish.
        for thread in range(128):
            for reg in range(64):
                m, n = wl.accumulator_coords(thread, reg)
                best[64 * member + m] = max(best[64 * member + m], d[m, n])
    best -= 65536 if none_valid else 0
    got = hs.fma_score(torch.from_numpy(best[:nq]), q_scale)
    want = hs.blockmax_plain(q_packed, min_lanes, q_scale, torch.from_numpy(db.view(np.int32)), torch.from_numpy(valid))
    assert torch.equal(got, want[:, 0])


# --------------------------------------------------- csrc/int4_dot.cu


def _int4_words(values):
    """(rows, 256) int4 values in [-8, 7] -> (rows, 32) uint32 twin words,
    element 2m in the low nibble of byte m."""
    twin = bitplane.build_int4_twin(torch.from_numpy(values.astype(np.int8))).numpy()
    assert twin.shape == (values.shape[0], 128)
    return twin.view("<u4")


def _as_int8(words):
    return np.ascontiguousarray(words.astype("<u4")).view(np.int8).astype(np.int64)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_nibble_shift_gives_256_times_the_int4_dot(seed):
    """``(w << 4) & 0xF0F0F0F0`` and ``w & 0xF0F0F0F0`` are the even and odd
    elements times 16 as int8, -8 included; the int8 dot over them is 256
    times the int4 dot, and ``>> 8`` gives it back exactly."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 8, (16, 256))
    b = rng.integers(-8, 8, (128, 256))
    a[0], b[0] = -8, -8  # the extreme: 256 * 64
    a[1], b[1] = -8, 7
    wa, wb = _int4_words(a), _int4_words(b)
    even = lambda w: _as_int8((w << np.uint32(4)) & np.uint32(0xF0F0F0F0))  # noqa: E731
    odd = lambda w: _as_int8(w & np.uint32(0xF0F0F0F0))  # noqa: E731
    assert np.array_equal(even(wa).reshape(16, 32, 4), 16 * a.reshape(16, 32, 4, 2)[..., 0])
    assert np.array_equal(odd(wa).reshape(16, 32, 4), 16 * a.reshape(16, 32, 4, 2)[..., 1])
    dot256 = even(wa) @ even(wb).T + odd(wa) @ odd(wb).T
    want = a @ b.T
    assert np.array_equal(dot256, 256 * want)
    assert np.array_equal(dot256.astype(np.int32) >> 8, want) and int(want.max()) == 256 * 64
    plain = exp_int4.int4_dot_plain(torch.from_numpy(wa.view(np.uint8)), torch.from_numpy(wb.view(np.uint8)))
    assert np.array_equal(plain.numpy(), want)  # the plain version of the same twins


@pytest.mark.parametrize("seed", (7, 8))
def test_int4_kernel_lane_order_gives_the_twin_dot(seed):
    """The kernel's k order: lane (g, t) holds bytes [16t, 16t + 16) and
    [64 + 16t, 64 + 16t + 16) of a row as words 0-7, and takes one word per
    k-step, its even elements as k 4t.. and its odd ones as k 16 + 4t...
    Summed over the four t lanes that gives 256 times the plain dot."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 8, (8, 256))
    b = rng.integers(-8, 8, (8, 256))
    wa, wb = _int4_words(a), _int4_words(b)
    lane_words = lambda w, t: np.concatenate([w[:, 4 * t : 4 * t + 4], w[:, 16 + 4 * t : 16 + 4 * t + 4]], axis=1)  # noqa: E731
    total = np.zeros((8, 8), np.int64)
    for t in range(4):
        la, lb = lane_words(wa, t), lane_words(wb, t)
        for word in range(8):  # m16n8k32: four even then four odd elements, times 16
            ea = _as_int8((la[:, word] << np.uint32(4)) & np.uint32(0xF0F0F0F0)).reshape(8, 4)
            eb = _as_int8((lb[:, word] << np.uint32(4)) & np.uint32(0xF0F0F0F0)).reshape(8, 4)
            oa = _as_int8(la[:, word] & np.uint32(0xF0F0F0F0)).reshape(8, 4)
            ob = _as_int8(lb[:, word] & np.uint32(0xF0F0F0F0)).reshape(8, 4)
            total += ea @ eb.T + oa @ ob.T
    assert not (total % 256).any()
    assert np.array_equal(total >> 8, a @ b.T)


def test_int4_quad_swap_gives_each_lane_four_consecutive_rows():
    """``swap_to_quads`` of the kernel: lanes t and t ^ 1 swap halves of two
    n-tiles' C pairs; every lane ends with four consecutive rows, 16-byte
    aligned, and the four lanes cover the two n-tiles' 16 rows once."""
    c = {(j, t): (100 * j + 2 * t, 100 * j + 2 * t + 1) for j in range(2) for t in range(4)}  # value = 100 j + row
    covered = []
    for t in range(4):
        odd = t & 1
        x, y = c[(0, t)], c[(1, t)]
        px, py = c[(0, t ^ 1)], c[(1, t ^ 1)]
        got = px if (t ^ 1) & 1 else py  # the partner sends x if it is odd, else y
        quad = (*got, *y) if odd else (*x, *got)
        first = 8 + 2 * (t - 1) if odd else 2 * t
        assert first % 4 == 0
        assert list(quad) == [100 * (first // 8) + first % 8 + i for i in range(4)]
        covered += range(first, first + 4)
    assert sorted(covered) == list(range(16))


@pytest.mark.parametrize("nq", (1, 8, 16, 17))
def test_int4_wrappers_on_the_cpu_equal_the_integer_dot_of_any_int4_values(nq):
    """On CPU tensors ``int4_dot`` and ``int4_probe`` take their plain
    versions (no launch is counted), which equal numpy's integer dot of
    random int4 values, -8 included, at query counts around the kernel's
    16-query tile and at a probe chunk of 256 rows."""
    rng = np.random.default_rng(nq)
    a = rng.integers(-8, 8, (nq, 256))
    b = rng.integers(-8, 8, (512, 256))
    a[0], b[0] = -8, -8
    q4 = torch.from_numpy(_int4_words(a).view(np.uint8))
    db4 = torch.from_numpy(_int4_words(b).view(np.uint8))
    before = exp_int4.int4_dot.launches, exp_int4.int4_probe.launches
    assert np.array_equal(exp_int4.int4_dot(q4, db4).numpy(), a @ b.T)
    stored = exp_int4.probe_rows(512, 256).numpy()
    assert np.array_equal(exp_int4.int4_probe(q4, db4, 256).numpy(), (a @ b[stored].T).astype(np.float32))
    assert (exp_int4.int4_dot.launches, exp_int4.int4_probe.launches) == before
    assert len(hs._SIGNATURES["iscc_int4_probe"]) == len(hs._SIGNATURES["iscc_int4_dot"]) + 1  # chunk


# ------------------------------------------------- exp_wgmma_ablate


@pytest.mark.parametrize("name", sorted(exp_wgmma_ablate.VARIANTS))
def test_ablation_variant_builds_under_a_key_of_its_own(name):
    """``base`` is the port's own library (no define, the library's key);
    every other variant defines one ``ISCC_ABLATE`` mask of the four parts
    and is built under another key, so it can never be loaded as the port's
    library."""
    defines = exp_wgmma_ablate.defines_of(name)
    mask = exp_wgmma_ablate.VARIANTS[name]
    assert 0 <= mask < 16
    if name == "base":
        assert defines == () and _build.build_key(defines) == _build.build_key()
    else:
        assert defines == (f"ISCC_ABLATE={mask}",) and mask
        assert _build.build_key(defines) != _build.build_key()
    others = {_build.build_key(exp_wgmma_ablate.defines_of(n)) for n in exp_wgmma_ablate.VARIANTS if n != name}
    assert _build.build_key(defines) not in others


def test_ablation_compound_variants_are_the_union_of_their_parts():
    v = exp_wgmma_ablate.VARIANTS
    assert v["fixed_only"] == v["no_wgmma"] | v["no_epilogue"]
    assert v["wgmma_only"] == v["no_epilogue"] | v["no_staging"] | v["no_flush"]
    assert sorted(v[n] for n in ("no_wgmma", "no_epilogue", "no_staging", "no_flush")) == [1, 2, 4, 8]
    assert all(cap % 128 == 0 for cap in exp_wgmma_ablate.CAPACITIES.values())


# ----------------------------------------------------------- time_ms


@pytest.mark.parametrize("graph", (False, True))
def test_time_ms_on_the_cpu_times_reps_calls_after_a_warm_one(graph):
    calls = []
    ms = ex.time_ms(lambda: calls.append(1), torch.device("cpu"), 4, graph=graph)
    assert len(calls) == 5 and ms >= 0.0
