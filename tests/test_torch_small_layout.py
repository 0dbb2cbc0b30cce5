"""CPU tests of ``csrc/blockmax_small.cu``, the small-batch phase 1 on
``mma.sync.m16n8k32.s8``: its fragment maps and bit order
(``ops/small_layout.py``), each warp's ring of TMA stages, and its whole flow
run lane by lane in numpy against the plain phase 1 (``blockmax_plain``).

The kernel itself runs only on a card (``tests/test_torch_gpu.py``). Here
every comparison is an equality: the arithmetic is exact integer work and
one rounding of ``0.5 + m * q_scale``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import small_layout as sl
from iscc_search_tpu_torch.ops import wgmma_layout as wl
from iscc_search_tpu_torch.ops.pm1_scan import query_prefix

SOURCE = Path(sl.__file__).resolve().parent.parent / "csrc" / "blockmax_small.cu"
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def _table(coords, regs):
    """(lane, reg, byte) -> coordinate arrays of a fragment map."""
    pairs = [[[coords(lane, reg, byte) for byte in range(4)] for reg in range(regs)] for lane in range(32)]
    arr = np.array(pairs)
    return arr[..., 0], arr[..., 1]


A_ROW, A_K = _table(sl.a_coords, 4)
B_K, B_COL = _table(sl.b_coords, 2)
C_ROW, C_COL = np.array([[sl.c_coords(lane, reg) for reg in range(4)] for lane in range(32)]).transpose(2, 0, 1)


def _bytes(regs):
    """(..., 4) uint32 registers -> (..., 4 bytes) int8 values, byte j of a
    register its bits 8j..8j+7."""
    regs = np.asarray(regs, np.uint32)
    return ((regs[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF).astype(np.uint8).view(np.int8)


# ------------------------------------------------------------- the maps


def test_the_k_order_is_a_bijection_and_matches_the_a_and_b_registers():
    """k-position k of a k-step carries bit ``bit_of_k(k)``: every bit once.
    Byte j of lane t's A registers is that bit of the row's word times
    ``4 ** t``, of its B registers that bit of the query's word as ±1 times
    ``2 ** (6 - 2t)``: every product is 64 x the 0/1 bit x the ±1 bit, and
    every byte fits int8."""
    assert sorted(sl.bit_of_k(k) for k in range(32)) == list(range(32))
    rng = np.random.default_rng(0)
    for word in [0, 0xFFFFFFFF, *rng.integers(0, 2**32, 20).tolist()]:
        bits = [(word >> b) & 1 for b in range(32)]
        for t in range(4):
            a = _bytes(sl.a_registers(word, 0, t)).astype(np.int64)
            b = _bytes(sl.b_registers(word, t, True)).astype(np.int64)
            for j in range(4):
                for reg, k in ((0, 4 * t + j), (2, 16 + 4 * t + j)):
                    x = bits[sl.bit_of_k(k)]
                    assert a[reg, j] == x * 4**t
                    assert b[reg // 2, j] == (2 * x - 1) * 2 ** (6 - 2 * t)
                    assert a[reg, j] * b[reg // 2, j] == sl.PRODUCT_SCALE * x * (2 * x - 1)
                assert a[1, j] == a[3, j] == 0  # the second row's word is 0
            assert sl.b_registers(word, t, False) == (0, 0)


def test_fragment_maps_cover_each_operand_and_the_accumulator_once():
    """m16n8k32's A (16 x 32), B (32 x 8) and C (16 x 8) are each covered
    once by the 32 lanes' registers, and the k of A register i byte j equals
    the k of B register i // 2 byte j for the same t: the MMA dots
    k-position against k-position."""
    for rows, cols, shape in ((A_ROW, A_K, (16, 32)), (B_K, B_COL, (32, 8)), (C_ROW, C_COL, (16, 8))):
        seen = np.zeros(shape, np.int32)
        np.add.at(seen, (rows.ravel(), cols.ravel()), 1)
        assert (seen == 1).all()
    for lane in range(32):
        for reg in range(4):
            for byte in range(4):
                assert A_K[lane, reg, byte] == B_K[lane, reg // 2, byte]


def test_constants_and_instantiations_match_the_kernel_source():
    """The Python mirror names the kernel's constants, its n-tile counts and
    its ring; every instantiation fits the card's shared memory."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|uint32_t) {name} = (\w+?)u?;", src).group(1), 0)

    assert const("kWarps") == sl.WARPS
    assert const("kMaxQueries") == sl.MAX_QUERIES == 16 * 8
    assert const("kOutBlocks") == sl.OUT_BLOCKS
    assert const("kInvalidPenalty") == sl.INVALID_PENALTY
    assert const("kByteBits") == sl.BYTE_BITS
    assert const("kBlockRows") == sl.BLOCK_ROWS == hs.BLOCK
    assert const("kWgmmaTiles") == sl.WGMMA_TILES
    ntiles = [int(n) for n in re.findall(r"ISCC_SMALL_NT\((\d+)\)\n", src)]
    assert ntiles + [16] == list(sl.NTILE_CHOICES)
    assert "return 16 / LANES < 2 ? 2 : (16 / LANES > 8 ? 8 : 16 / LANES);" in src
    assert "constexpr int ctas_per_sm() { return NT <= 8 ? 2 : 1; }" in src
    assert "(mx[n][h] >> 5) - qsum[qi] - penalty" in src and sl.PRODUCT_SCALE == 2 << 5
    for lanes in range(1, 9):
        for nt in sl.NTILE_CHOICES:
            assert sl.smem_bytes(lanes, nt) <= sl.SMEM_LIMIT
            assert sl.ctas_per_sm(nt) * (sl.smem_bytes(lanes, nt) + 1024) <= sl.SMEM_PER_SM
    assert [sl.ntiles(q) for q in (1, 8, 9, 16, 17, 32, 33, 64, 65, 96, 97, 128, 129, 1024)] == [
        1, 1, 2, 2, 4, 4, 8, 8, 12, 12, 16, 16, 16, 16]


def test_b_words_fill_each_layout_once_and_match_the_wgmma_core_matrices():
    """``b_word`` covers the B operand's shared memory once for every
    n-tile count; from ``WGMMA_TILES`` on, byte j of word ``b_word(ks, qi,
    k4)`` is element (qi, 32 ks + 4 k4 + j) of the K-major core-matrix
    layout with LBO = 16 x the chunk's queries and SBO = 128."""
    for lanes in (1, 3, 8):
        for nt in sl.NTILE_CHOICES:
            kq = 8 * nt
            words = [sl.b_word(ks, qi, k4, nt) for ks in range(lanes) for qi in range(kq) for k4 in range(8)]
            assert sorted(words) == list(range(lanes * kq * 8))
            if nt >= sl.WGMMA_TILES:
                for ks, qi, k4 in ((0, 0, 0), (lanes - 1, kq - 1, 7), (lanes // 2, 13, 5)):
                    k = 32 * ks + 4 * k4
                    assert 4 * sl.b_word(ks, qi, k4, nt) == wl.element_offset(qi, k, 16 * kq, wl.CORE_BYTES)


@pytest.mark.parametrize("nblocks", (1, 7, 8, 9, 131, 9728, 879104))
@pytest.mark.parametrize("sms", (1, 132))
def test_shares_split_every_block_once_and_differ_by_at_most_one(nblocks, sms):
    ctas, _ = sl.grid(nblocks, 1, sms)
    assert 1 <= ctas <= 2 * sms
    starts = [sl.share_begin(c, w, ctas, nblocks) for c in range(ctas) for w in range(sl.WARPS)]
    ends = starts[1:] + [nblocks]
    assert starts[0] == 0 and all(sl.share_begin(c, sl.WARPS, ctas, nblocks) == sl.share_begin(c + 1, 0, ctas, nblocks)
                                  for c in range(ctas - 1))
    sizes = [e - s for s, e in zip(starts, ends)]
    assert min(sizes) >= 0 and sum(sizes) == nblocks and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("lanes", (1, 2, 4, 8))
@pytest.mark.parametrize("count", (1, 3, 9, 40))
@pytest.mark.parametrize("seed", (0, 1))
def test_the_ring_hands_each_block_to_its_stage_in_order(lanes, count, seed):
    """One warp's ring, simulated with copies that complete late and in any
    order: lane 0 asks for blocks 0 .. ring - 1, then for block j + ring
    once block j is done; the wait for block j passes on the stage's
    barrier by parity (``try_wait.parity`` passes once the barrier's phase
    parity differs from the one waited on) exactly when block j's copy has
    landed, never on an older or a newer one, and no stage is asked for
    while its block is unread."""
    ring = sl.ring_stages(lanes)
    rng = np.random.default_rng(seed)
    phases = [0] * ring  # completed phases of each stage's barrier
    content = [None] * ring
    in_flight = []  # (stage, block) copies not landed yet
    asked = min(ring, count)
    in_flight += [(j % ring, j) for j in range(asked)]
    for j in range(count):
        s = j % ring
        while phases[s] % 2 == (j // ring) % 2:  # the wait: land some copy, any of those in flight
            assert in_flight, "the warp waits for a copy nobody asked for"
            stage, block = in_flight.pop(int(rng.integers(len(in_flight))))
            content[stage] = block
            phases[stage] += 1
        assert content[s] == j and phases[s] == j // ring + 1
        if j + ring < count:  # lane 0 asks for the block that comes into this stage next
            assert all(stage != s for stage, _ in in_flight)
            in_flight.append((s, j + ring))
            asked += 1
    assert asked == count and not in_flight


# ------------------------------------------------------- the whole flow


def emulate(q_codes, min_lanes, q_scale, db, valid, sms):
    """``blockmax_small_kernel`` lane by lane: fragments built by the
    kernel's formulas, each warp's share, the first-valid-row substitution,
    A registers from shifted words, MMAs through the fragment maps, the
    lane maxima, the row-group shuffles, the gather and its sector flush.
    Returns (nq, nblocks) float32, NaN where nothing was written."""
    nq = q_codes.shape[0]
    cap, lanes = db.shape
    nblocks = cap // sl.BLOCK_ROWS
    nt = sl.ntiles(nq)
    kq = 8 * nt
    ctas, chunks = sl.grid(nblocks, nq, sms)
    out = np.full((nq, nblocks), np.nan, np.float32)
    for chunk in range(chunks):
        q0 = chunk * kq
        nc = min(kq, nq - q0)
        # The B operand's shared memory, written as the kernel writes it.
        image = np.zeros(lanes * kq * 8, np.uint32)
        qsum = np.zeros(kq, np.int64)
        scale = np.zeros(kq, np.float32)
        for i in range(lanes * kq * 8):
            k4, qi, ks = i & 7, (i >> 3) % kq, (i >> 3) // kq
            live = qi < nc and ks < min(max(int(min_lanes[q0 + qi]), 0), lanes)
            image[sl.b_word(ks, qi, k4, nt)] = sl.b_registers(int(q_codes[q0 + qi, ks]) if live else 0, k4 % 4, live)[k4 // 4]
        for i in range(nc):
            ml = min(max(int(min_lanes[q0 + i]), 0), lanes)
            qsum[i] = sum(2 * bin(int(q_codes[q0 + i, ks])).count("1") - 32 for ks in range(ml))
            scale[i] = q_scale[q0 + i]
        b = np.zeros((lanes, nt, 32, 8), np.int64)  # B of each (k-step, n-tile) as the MMA reads it
        if nt >= sl.WGMMA_TILES:  # through wgmma's descriptor: k-step ks starts two k-chunks further per step
            lbo = kq * 16
            raw = image.view(np.int8)
            n_all, k_all = np.arange(kq)[:, None], np.arange(32)[None, :]
            for ks in range(lanes):
                start = (wl.kstep_descriptor(0, lbo, wl.CORE_BYTES, ks) & 0x3FFF) * 16
                tile = raw[start + wl.element_offset(n_all, k_all, lbo, wl.CORE_BYTES)]  # (queries, k)
                b[ks] = tile.reshape(nt, 8, 32).transpose(0, 2, 1)
        else:  # through the fragment map: lane (g, t) of n-tile n holds uint2 (h = 0, 1)
            b[:, :, B_K, B_COL] = _bytes(image.reshape(lanes, nt, 32, 2))
        for cta in range(ctas):
            for warp in range(sl.WARPS):
                b_first = sl.share_begin(cta, warp, ctas, nblocks)
                b_end = sl.share_begin(cta, warp + 1, ctas, nblocks)
                gather = np.full((kq, sl.OUT_BLOCKS + 1), np.nan, np.float32)
                for block in range(b_first, b_end):
                    rows = db[block * 128 : block * 128 + 128]
                    vb = valid[block * 128 : block * 128 + 128]
                    vword = vb.reshape(32, 4).astype(np.uint32) @ (1 << (8 * np.arange(4, dtype=np.uint32)))
                    ballot = vword != 0
                    none_valid = not ballot.any()
                    first_lane = 0 if none_valid else int(np.flatnonzero(ballot)[0])
                    fw = int(vword[first_lane])
                    first_valid = 0 if none_valid else 4 * first_lane + ((fw & -fw).bit_length() - 1) // 8
                    mx = np.full((nt, 2, 32), np.iinfo(np.int32).min, np.int64)
                    for mt in range(8):
                        r0 = 16 * mt + G
                        src0 = np.where(none_valid | (vb[r0] != 0), r0, first_valid)
                        src1 = np.where(none_valid | (vb[r0 + 8] != 0), r0 + 8, first_valid)
                        regs = np.stack(sl.a_registers(rows[src0], rows[src1], T[:, None]), axis=-1)  # (32, lanes, 4)
                        a = np.zeros((lanes, 16, 32), np.int64)
                        a[:, A_ROW, A_K] = _bytes(regs.transpose(1, 0, 2))
                        assert set(np.unique(a)) <= {0, 1, 4, 16, 64}
                        c = np.einsum("srk,snkc->nrc", a, b)  # (nt, 16, 8), summed over the k-steps
                        creg = c[:, C_ROW, C_COL]  # (nt, 32 lanes, 4 registers)
                        mx[:, 0] = np.maximum(mx[:, 0], np.maximum(creg[..., 0], creg[..., 2]))
                        mx[:, 1] = np.maximum(mx[:, 1], np.maximum(creg[..., 1], creg[..., 3]))
                    for off in (4, 8, 16):
                        mx = np.maximum(mx, mx[..., LANES ^ off])
                    slot = block % sl.OUT_BLOCKS
                    # Lanes 0-3 (row group 0, t = lane) score queries 8n + 2t + h.
                    qi = (8 * np.arange(nt)[:, None, None] + np.arange(2)[None, :, None] + 2 * T[None, None, :4]).ravel()
                    assert not (mx % sl.PRODUCT_SCALE).any()
                    m = (mx[:, :, :4].ravel() >> 5) - qsum[qi] - (sl.INVALID_PENALTY if none_valid else 0)
                    gather[qi, slot] = hs.fma_score(torch.from_numpy(m), torch.from_numpy(scale[qi])).numpy()
                    if slot == sl.OUT_BLOCKS - 1 or block + 1 == b_end:
                        sector = block - slot
                        lo = max(b_first, sector) - sector
                        for k in range(lo, slot + 1):
                            assert np.isnan(out[q0 : q0 + nc, sector + k]).all(), "a score written twice"
                            out[q0 : q0 + nc, sector + k] = gather[:nc, k]
    return out


def _case(lanes, nq, nblocks, seed):
    """Random rows and queries of a ``lanes``-lane partition: tombstones,
    a block with no valid row, one with a single valid row past row 0,
    invalid leading rows; queries of every prefix length up to the
    partition's, and some longer."""
    rng = np.random.default_rng(seed)
    cap = 128 * nblocks
    db = rng.integers(0, 2**32, (cap, lanes), dtype=np.uint32)
    valid = (rng.random(cap) > 0.15).astype(np.uint8)
    valid[:3] = 0
    if nblocks > 2:
        valid[128:256] = 0
        valid[256:384] = 0
        valid[256 + 77] = 1
    q_codes = rng.integers(0, 2**32, (nq, 8), dtype=np.uint32)
    q_lanes = rng.integers(1, 9, nq).astype(np.int32)
    min_lanes, q_scale = query_prefix(torch.from_numpy(q_lanes), 32 * lanes)
    return q_codes, min_lanes, q_scale, db, valid


def _check(lanes, nq, nblocks, sms, seed):
    q_codes, min_lanes, q_scale, db, valid = _case(lanes, nq, nblocks, seed)
    got = emulate(q_codes, min_lanes.numpy(), q_scale.numpy(), db, valid, sms)
    assert not np.isnan(got).any()
    want = hs.blockmax_plain(torch.from_numpy(q_codes.view(np.int32)), min_lanes, q_scale,
                             torch.from_numpy(db.view(np.int32)), torch.from_numpy(valid))
    assert torch.equal(torch.from_numpy(got), want)
    if nblocks > 2:
        assert bool((want[:, 1] < -1.0).all())  # the block with no valid row
    return min_lanes


@pytest.mark.parametrize("nq", (1, 7, 8, 9, 33, 80, 128))
@pytest.mark.parametrize("lanes", range(1, 9))
def test_emulated_kernel_equals_plain_phase1(lanes, nq):
    """Every lane count and the batch sizes around the n-tiles (``mma.sync``
    up to 32 queries, ``wgmma`` at 64, 96 and 128 columns), 37 blocks on
    two SMs (up to 32 warps: shares of one and two blocks, sector groups
    split between warps), tombstones, an all-invalid block and one with a
    single valid row."""
    min_lanes = _check(lanes, nq, nblocks=37, sms=2, seed=100 * lanes + nq)
    if lanes > 1 and nq > 8:
        assert int(min_lanes.min()) < lanes  # some queries shorter than the partition


@pytest.mark.parametrize("lanes,nq,nblocks,sms", [(4, 129, 5, 1), (2, 10, 1, 132), (8, 100, 70, 3), (3, 20, 100, 1)])
def test_emulated_kernel_on_query_chunks_one_block_and_long_shares(lanes, nq, nblocks, sms):
    """Two query chunks (129 queries), a single block (one warp's share,
    flushed partially), shares longer than a sector group."""
    _check(lanes, nq, nblocks, sms, seed=nq + nblocks)
