"""CPU tests of ``csrc/blockmax_variants.cu``, TPU kernel 8's epilogue
probes on ``wgmma``: its flow mirrored in numpy (``experiments/variant_layout.py``)
against the plain version ``exp_kernels.blockmax_variant_plain``, for every
epilogue code, on penalties that take the fast path (the dominant-penalty
row substitution) and the per-element path; its shares, gathers and
sub-tile flushes; the int8 -> bf16 conversion and the bf16 tile layout.

The kernel itself runs only on a card (``tests/test_torch_gpu.py``). Every
comparison is an equality. Constants the mirror copies are read from the
``.cu`` source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from iscc_search_tpu_torch.experiments import exp_kernels as ek
from iscc_search_tpu_torch.experiments import exp_variant_ablate
from iscc_search_tpu_torch.ops import _build
from iscc_search_tpu_torch.experiments import variant_layout as vl
from iscc_search_tpu_torch.ops import wgmma_layout as wl

SOURCE = Path(vl.__file__).resolve().parent.parent / "csrc" / "blockmax_variants.cu"


def _const(src, name):
    m = re.search(rf"constexpr (?:int|uint32_t|float) {name} = ([^;]+);", src)
    return m.group(1).strip()


def test_the_mirror_carries_the_kernels_constants():
    src = SOURCE.read_text()
    ints = {
        "kBlockRows": vl.BLOCK_ROWS, "kBits": vl.BITS, "kGroupBlocks": vl.SUB_BLOCKS, "kClasses": vl.CLASSES,
        "kTileQueries": vl.TILE_QUERIES, "kChunkQueries": vl.CHUNK_QUERIES, "kTeamThreads": vl.TEAM_THREADS,
        "kOutBlocks": vl.OUT_BLOCKS,
    }
    for name, value in ints.items():
        assert int(_const(src, name)) == value, name
    assert _const(src, "kBf16Lbo") == "kBlockRows * 16 + 16"
    assert int(_const(src, "kSwizzleBytes")) == vl.SWIZZLE_BYTES
    assert _const(src, "kS8Atom") == "kBlockRows * kSwizzleBytes" and _const(src, "kS8Sbo") == "8 * kSwizzleBytes"
    assert "return (c / 8) * kS8Atom + r * kSwizzleBytes + (((c % 8) ^ (r % 8)) * 16);" in src
    assert "smem_desc_sw128(b_addr + ks / 4 * kS8Atom + ks % 4 * 32)" in src
    assert _const(src, "kOutStride") == "kOutBlocks + 1"
    assert float(_const(src, "kDominance").rstrip("f")) == vl.DOMINANCE
    assert int(_const(src, "kMagicBits").rstrip("u"), 0) == vl.MAGIC_BITS
    assert float(_const(src, "kMagicOffset").rstrip("f")) == vl.MAGIC_OFFSET
    assert int(_const(src, "kIntMagic"), 0) == vl.INT_MAGIC
    assert float(_const(src, "kIntMagicValue").rstrip("f")) == vl.INT_MAGIC_VALUE
    assert [int(s, 16) for s in re.findall(r"__byte_perm\(u, kMagicBits, (0x[0-9a-f]+)\)", src)] == list(vl.PERM_BYTES)
    assert set(re.findall(r"__float_as_uint\(f[13]\), (0x[0-9a-f]+)\)", src)) == {hex(vl.PERM_HIGH)}
    # The epilogue codes and their groups.
    for code, name in enumerate(("kBf16", "kBf16NoPen", "kTrans", "kU8Max", "kBf16Dot", "kDotOnly", "kDotOnlyBf16",
                                 "kConsume", "kTree2d")):
        assert re.search(rf"\b{name} = {code},", src), name
    groups = {
        "bf16_mma": vl.BF16_EPIS, "uses_pen": vl.PEN_EPIS, "sub_tile": vl.SUB_TILE_EPIS, "gathers": vl.GATHER_EPIS,
    }
    codes = {"kBf16": ek.EPI_BF16, "kBf16NoPen": ek.EPI_BF16_NOPEN, "kTrans": ek.EPI_TRANS, "kU8Max": ek.EPI_U8MAX,
             "kBf16Dot": ek.EPI_BF16DOT, "kDotOnlyBf16": ek.EPI_DOTONLY_BF16, "kConsume": ek.EPI_CONSUME,
             "kTree2d": ek.EPI_TREE2D}
    for fn, members in groups.items():
        body = re.search(rf"constexpr bool {fn}\(int epi\) \{{\s*return ([^;]+);", src).group(1)
        assert sorted(codes[n] for n in re.findall(r"epi == (k\w+)", body)) == sorted(members), fn
    assert "constexpr bool finishes_max(int epi) { return gathers(epi) || epi == kTrans; }" in src
    assert sorted(vl.FINISH_MAX_EPIS) == sorted(vl.GATHER_EPIS + (ek.EPI_TRANS,))
    # The shared-memory formulas the mirror reckons the budget with.
    flat = " ".join(src.split())
    assert ("2 * 2 * kS8TileBytes + kS8Chunks * qc * 16 + qc * 4 + 2 * 2 * kBlockRows * 4 + 2 * qc * kOutStride * 4 "
            "+ 2 * 2 * 8 + 1024") in flat
    assert _const(src, "kS8TileBytes") == "kBits / kSwizzleBytes * kS8Atom"
    assert _const(src, "kBf16TileBytes") == "kBf16Chunks * kBf16Lbo"
    assert "kBf16TileBytes + kBf16Chunks * qc * 16 + qc * 4 + 2 * kBlockRows * 4 + qc * kOutStride * 4" in src


@pytest.mark.parametrize("qc", (128, 256))
def test_shared_memory_fits_a_thread_block(qc):
    """Both kernels at either query count fit the card's 227 KiB; the int8
    kernel keeps two row tiles per team."""
    assert vl.s8_smem_bytes(qc) <= vl.SMEM_LIMIT
    assert vl.bf16_smem_bytes(qc) <= vl.SMEM_LIMIT
    assert vl.s8_smem_bytes(256) == 219168 and vl.bf16_smem_bytes(256) == 208384


# ------------------------------------------------------------ arithmetic


def test_int8_to_bf16_is_exact_for_every_int8_value():
    """The PRMT and f32 trick of ``s8x4_bf16x4`` gives torch's bf16 of
    every int8 value, in order, the first of each pair in the low half."""
    vals = np.arange(-128, 128, dtype=np.int8)
    want = torch.from_numpy(vals.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    got = []
    for w in vals.view(np.uint8).reshape(-1, 4).view("<u4").reshape(-1):
        lo, hi = vl.s8x4_bf16x4(int(w))
        got += [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
    assert got == want.tolist()


def test_exact_float_of_every_dot():
    d = np.concatenate([np.arange(-300, 301), np.array([-(2**22) + 1, 2**22 - 1, 123456, -98765])])
    assert np.array_equal(vl.exact_float(d), d.astype(np.float32))


def test_round_bf16_equals_torch():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 300, 5000), rng.normal(0, 1e30, 100), [np.inf, -np.inf, 0.0, -0.0, 3.4e38]])
    x = x.astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(vl.round_bf16(x), want)


def test_bf16_tile_layout():
    """Every (row, k) of a bf16 row tile and query tile lands on its own 2
    bytes inside the tile; a 16-byte k-chunk of a row is 8 consecutive
    values; one k16 step is two k-chunks, as one int8 k32 step."""
    for rows, lbo in ((128, vl.BF16_LBO), (256, 256 * 16)):
        r = np.arange(rows)[:, None]
        k = np.arange(vl.BITS)[None, :]
        off = vl.bf16_offset(r, k, lbo)
        assert len(np.unique(off)) == off.size
        assert off.max() + 2 <= vl.BF16_CHUNKS * lbo
        assert np.array_equal(off[:, 1:8] - off[:, :7], np.full((rows, 7), 2))
        # Each core matrix (8 rows x 8 values) is 128 contiguous bytes, as wgmma's int8 layout.
        assert np.array_equal(off, wl.element_offset(r, 2 * k, lbo, wl.CORE_BYTES))
    assert wl.descriptor(0, vl.BF16_LBO, wl.CORE_BYTES) >> 16 & 0x3FFF == vl.BF16_LBO // 16


def test_int8_tile_swizzle():
    """The int8 row tile holds every (row, byte) once in 32 KiB; each
    128-byte line is one row's 128 k-bytes, its 16-byte pieces permuted
    within the line by the row's index in its 8-row group (as TMA's and
    wgmma's 128-byte swizzle); a k-step's 32 bytes are two pieces of one
    line; an 8-row group spans 1,024 bytes (SBO)."""
    r = np.arange(vl.BLOCK_ROWS)[:, None]
    k = np.arange(vl.BITS)[None, :]
    off = vl.s8_offset(r, k)
    assert np.array_equal(np.sort(off.reshape(-1)), np.arange(vl.BLOCK_ROWS * vl.BITS))
    assert np.array_equal(off // vl.SWIZZLE_BYTES % vl.BLOCK_ROWS, np.broadcast_to(r, off.shape))
    assert np.array_equal(off[:, :128] // 1024, np.broadcast_to(r // 8, (128, 128)))
    assert np.array_equal(off[8:] - off[:-8], np.full((120, vl.BITS), vl.S8_SBO))
    pieces = (off[:, ::16] % vl.SWIZZLE_BYTES) // 16  # (row, piece) -> slot in its line
    assert np.array_equal(pieces, (np.arange(16)[None, :] % 8) ^ (r % 8))
    # One TMA box per atom: k-bytes 128h..128h+127 of the 128 rows, 16 KiB each.
    for h in range(2):
        atom = off[:, 128 * h : 128 * (h + 1)]
        assert atom.min() == h * vl.S8_ATOM and atom.max() == (h + 1) * vl.S8_ATOM - 1
    desc = wl.descriptor(0, 16, vl.S8_SBO, layout=1)
    assert desc >> 62 == 1 and desc >> 32 & 0x3FFF == vl.S8_SBO // 16


# ---------------------------------------------------------- penalties


def _bf16_bits(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).view(torch.int16).numpy()


def _pen(kind, n, rng):
    """(N,) penalty row of one kind, as bf16 bits (int16) or uint8."""
    nblocks = n // vl.BLOCK_ROWS
    if kind == "tombstones":  # 0 / -65536: 5% tombstones, dead blocks 3 and the last
        valid = rng.random(n) > 0.05
        valid[3 * 128 : 4 * 128] = False
        valid[-128:] = False
        return _bf16_bits(np.where(valid, 0.0, -65536.0))
    if kind == "near":  # random bf16 within 512 of each other: the per-element path
        return _bf16_bits(rng.uniform(-200, 200, n))
    if kind == "split":  # per block a top value; every other row at least 512 below it (all exact in bf16)
        top = np.repeat(64.0 * rng.integers(-128, 129, nblocks), 128)
        low = top - 512 - 64.0 * rng.integers(0, 100, n)
        return _bf16_bits(np.where(rng.random(n) < 0.3, top, low))
    if kind == "gap":  # as split, the other rows 192 below the top: not dominated, so the per-element path
        top = np.repeat(64.0 * rng.integers(-128, 129, nblocks), 128)
        return _bf16_bits(np.where(rng.random(n) < 0.3, top, top - 192))
    if kind == "split_near":  # as split, one row per block 100 below the top: the per-element path
        p = torch.from_numpy(_pen("split", n, rng)).view(torch.bfloat16).float().numpy().reshape(nblocks, 128)
        p[:, 5] = p.max(axis=1) - 100
        return _bf16_bits(p.reshape(-1))
    if kind == "equal":  # one value per block, some large
        return _bf16_bits(np.repeat(rng.normal(0, 1e5, nblocks), 128))
    if kind == "inf":  # +-inf in some blocks, tombstones elsewhere
        p = np.where(rng.random(n) > 0.05, 0.0, -65536.0)
        p[128:256] = np.inf
        p[640:768:3] = -np.inf
        p[1024 + 7] = np.inf
        return _bf16_bits(p)
    if kind == "u8_01":
        valid = (rng.random(n) > 0.05).astype(np.uint8)
        valid[3 * 128 : 4 * 128] = 0
        return valid
    if kind == "u8_any":
        return rng.integers(0, 256, n, dtype=np.uint8)
    raise ValueError(kind)


def test_the_plan_of_a_block():
    """pmax, the dominated rows and the fast or per-element choice."""
    bits = lambda x: _bf16_bits(x)  # noqa: E731
    p = vl.pen_values(ek.EPI_BF16, bits(np.where(np.arange(128) % 3 == 0, -65536.0, 0.0)))
    fast, pmax, source = vl.plan(ek.EPI_BF16, p)
    assert fast and pmax == 0.0
    assert np.array_equal(source, np.where(np.arange(128) % 3 == 0, 1, np.arange(128)))  # row 1 is the first top
    fast, pmax, source = vl.plan(ek.EPI_BF16, vl.pen_values(ek.EPI_BF16, bits(np.full(128, -65536.0))))
    assert fast and pmax == -65536.0 and np.array_equal(source, np.arange(128))  # a dead block keeps its rows
    edge = np.zeros(128)
    edge[9] = -512.0
    assert vl.plan(ek.EPI_BF16, vl.pen_values(ek.EPI_BF16, bits(edge)))[0]  # exactly 512 below: dominated
    edge[9] = -510.0
    assert not vl.plan(ek.EPI_BF16, vl.pen_values(ek.EPI_BF16, bits(edge)))[0]
    edge[9] = np.inf
    assert not vl.plan(ek.EPI_BF16, vl.pen_values(ek.EPI_BF16, bits(edge)))[0]
    u8 = np.ones(128, np.uint8)
    u8[:40] = 0
    fast, pmax, source = vl.plan(ek.EPI_U8MAX, vl.pen_values(ek.EPI_U8MAX, u8))
    assert fast and pmax == 1.0 and np.array_equal(source, np.where(np.arange(128) < 40, 40, np.arange(128)))
    assert vl.plan(ek.EPI_U8MAX, vl.pen_values(ek.EPI_U8MAX, np.zeros(128, np.uint8)))[:2] == (True, 0.0)
    u8[0] = 2
    assert not vl.plan(ek.EPI_U8MAX, vl.pen_values(ek.EPI_U8MAX, u8))[0]
    assert not vl.plan(ek.EPI_TREE2D, vl.pen_values(ek.EPI_TREE2D, bits(np.zeros(128))))[0]
    assert vl.plan(ek.EPI_CONSUME, np.full(128, np.nan, np.float32))[0]  # no penalty: every block is fast


@pytest.mark.parametrize("kind, share", [("tombstones", 1.0), ("equal", 1.0), ("split", 1.0), ("near", 0.0),
                                         ("gap", 0.0), ("split_near", 0.0), ("u8_01", 1.0), ("u8_any", 0.0)])
def test_fast_share_of_each_penalty_kind(kind, share):
    rng = np.random.default_rng(3)
    epi = ek.EPI_U8MAX if kind.startswith("u8") else ek.EPI_BF16
    assert vl.fast_share(epi, _pen(kind, 16384, rng)) == share


# ------------------------------------------------------ shares and gathers


@pytest.mark.parametrize("epi", (ek.EPI_BF16, ek.EPI_CONSUME, ek.EPI_BF16DOT))
@pytest.mark.parametrize("nblocks, sms", [(128, 3), (128, 132), (256, 5), (96, 132), (4096, 132), (81920, 132)])
def test_every_block_is_one_teams_and_every_team_makes_the_same_steps(epi, nblocks, sms):
    """Real steps cover every block once; a thread block's teams make the
    same number of steps; sub-tile epilogues cut shares at sub-tiles; the
    gathers' flushes cover every block once."""
    if epi in vl.SUB_TILE_EPIS and nblocks % vl.SUB_BLOCKS:
        pytest.skip("sub-tile epilogues need whole sub-tiles")
    seen = np.zeros(nblocks, np.int64)
    flushed = np.zeros(nblocks, np.int64)
    all_shares = vl.shares(epi, nblocks, sms)
    per_cta = vl.teams(epi)
    for i, sh in enumerate(all_shares):
        assert sh.steps == all_shares[i - i % per_cta].steps
        if epi in vl.SUB_TILE_EPIS:
            assert sh.first % vl.SUB_BLOCKS == 0 and sh.end % vl.SUB_BLOCKS == 0
        for step in range(sh.steps):
            block = sh.block_of(step)
            assert 0 <= block <= sh.last
            if sh.real(step):
                seen[block] += 1
                flush = vl.flush_range(block, sh)
                if flush is not None:
                    flushed[block - flush[1] + flush[0] : block + 1] += 1
    assert (seen == 1).all()
    assert (flushed == 1).all()


# ---------------------------------------------------- the whole flow


def _inputs(n, nq, seed, pen_kind):
    rng = np.random.default_rng(seed)
    db = np.where(rng.random((n, vl.BITS)) < 0.5, 1, -1).astype(np.int8)
    q = db[rng.integers(0, n, nq)].copy()
    q[1::2, 192:] = 0  # 192-bit prefixes
    q[rng.random((nq, vl.BITS)) < 0.02] *= -1
    qs = np.where(np.arange(nq) % 2, 1 / 384, 1 / 512).astype(np.float32)
    return q, qs, db, _pen(pen_kind, n, rng)


def _check(name, pen_kind, nq, sms, seed=0):
    epi, chunk, nodma, orient = ek.variant_spec(name)
    n = 2 * chunk if nodma else 16384
    q, qs, db, pen = _inputs(n, nq, seed, pen_kind)
    got = vl.run(epi, q, qs, db, pen, db_wrap=chunk if nodma else 0, sms=sms)
    shape = (n, 1) if orient == "col" else (1, n)
    pen_t = torch.from_numpy(pen.reshape(shape))
    if pen.dtype != np.uint8:
        pen_t = pen_t.view(torch.bfloat16)
    want = ek.blockmax_variant_plain(
        name, torch.from_numpy(q), torch.from_numpy(qs[:, None].copy()), torch.from_numpy(db), pen_t
    ).numpy()
    assert not np.isnan(got).any(), "the flow left output unwritten"
    assert np.array_equal(got, want)


# One name per epilogue code (and each *_nodma launch), each with the
# penalty kinds its function reads.
BF16_KINDS = ("tombstones", "near", "split", "gap", "split_near", "equal", "inf")
CASES = (
    [(name, kind) for name in ("bf16", "trans", "bf16dot", "tree2d") for kind in BF16_KINDS]
    + [("u8max", "u8_01"), ("u8max", "u8_any")]
    + [(name, "tombstones") for name in ("bf16_nopen", "dotonly", "dotonly_bf16", "consume", "nodma_full",
                                         "dotonly_nodma", "dotonly_bf16_nodma", "consume_nodma")]
)


@pytest.mark.parametrize("name, kind", CASES)
def test_the_flow_equals_plain(name, kind):
    """N = 16384 (32,768 for the chunk-0 probes), Q = 77, a grid of 5: shares
    cut mid-sub-tile for the block epilogues, on whole sub-tiles for the
    others."""
    _check(name, kind, nq=77, sms=5)


@pytest.mark.parametrize("name, kind", [("bf16", "tombstones"), ("bf16", "near"), ("bf16_nopen", "tombstones"),
                                        ("trans", "split_near"), ("u8max", "u8_01"), ("u8max", "u8_any"),
                                        ("bf16dot", "gap"), ("tree2d", "split"), ("consume", "tombstones")])
def test_the_flow_counts_its_paths_as_the_plan_predicts(name, kind):
    """The blocks the flow finishes on each path, counted where it branches
    (as the kernel counts them in ``g_path_blocks``), equal
    ``path_blocks``: every block once per query chunk (Q = 300: two), the
    fast ones by the plan's rule; none for the epilogues without block
    maxima. ``chip_smoke.py`` holds the kernel's own counts to the same."""
    epi, _, _, _ = ek.variant_spec(name)
    q, qs, db, pen = _inputs(16384, 300, 4, kind)
    counts = [0, 0]
    vl.run(epi, q, qs, db, pen, sms=5, counts=counts)
    assert tuple(counts) == vl.path_blocks(epi, pen, 300)
    if epi in vl.FINISH_MAX_EPIS:
        assert counts[0] == 2 * 128 and counts[1] == 2 * 128 * vl.fast_share(epi, pen)
    else:
        assert counts == [0, 0]


@pytest.mark.parametrize("name", ("bf16", "trans", "bf16dot", "tree2d"))
def test_a_nan_penalty_is_dropped_where_plain_keeps_it(name):
    """Outside the wrapper's contract, pinned: the kernel's maxima are
    ``fmaxf``'s, so a NaN penalty drops its row (a block or class of NaN
    only gives -inf), as if it were -inf; the plain version's ``amax``
    gives NaN there. The mirror holds the kernel's side."""
    epi, _, _, orient = ek.variant_spec(name)
    q, qs, db, pen = _inputs(16384, 77, 5, "tombstones")
    p = torch.from_numpy(pen).view(torch.bfloat16).float()
    p[5 * 128 + 17] = float("nan")  # one row of block 5
    p[9 * 128 : 10 * 128] = float("nan")  # all of block 9
    nan_bits = p.to(torch.bfloat16).view(torch.int16).numpy()
    inf_bits = torch.where(p.isnan(), float("-inf"), p).to(torch.bfloat16).view(torch.int16).numpy()
    got = vl.run(epi, q, qs, db, nan_bits, sms=5)

    def plain(bits):
        shape = (16384, 1) if orient == "col" else (1, 16384)
        out = ek.blockmax_variant_plain(name, torch.from_numpy(q), torch.from_numpy(qs[:, None].copy()),
                                        torch.from_numpy(db), torch.from_numpy(bits.reshape(shape)).view(torch.bfloat16))
        return out.numpy().T if orient == "col" else out.numpy()

    assert np.array_equal(got.T if orient == "col" else got, plain(inf_bits))
    nan_cols = np.isnan(plain(nan_bits)).any(axis=0)
    if epi == ek.EPI_TREE2D:  # classes span a sub-tile's blocks: every class of sub-tile 0
        assert np.array_equal(np.flatnonzero(nan_cols), np.arange(vl.CLASSES))
    else:
        assert np.array_equal(np.flatnonzero(nan_cols), [5, 9])


@pytest.mark.parametrize("name, kind", [("bf16", "tombstones"), ("bf16", "near"), ("trans", "split"),
                                        ("u8max", "u8_01"), ("bf16dot", "tombstones"), ("dotonly_bf16", "tombstones"),
                                        ("consume", "tombstones"), ("tree2d", "tombstones"), ("dotonly", "tombstones")])
@pytest.mark.parametrize("nq, sms", [(1, 132), (513, 3)])
def test_the_flow_at_one_query_and_across_query_chunks(name, kind, nq, sms):
    """Q = 1 on the card's 132 SMs (a thread block per unit), Q = 513 (three
    launches: 256, 256, 1) on a grid of 3."""
    _check(name, kind, nq=nq, sms=sms, seed=nq)


# ------------------------------------------------- exp_variant_ablate


@pytest.mark.parametrize("name", sorted(exp_variant_ablate.VARIANTS))
def test_ablation_variant_builds_under_a_key_of_its_own(name):
    """Each variant builds ``blockmax_variants.cu`` alone, ``base`` with no
    define and every other with one ``ISCC_VARIANT_ABLATE`` mask of the
    source's three parts, each under a key of its own and never the port's
    library's."""
    defines = exp_variant_ablate.defines_of(name)
    mask = exp_variant_ablate.VARIANTS[name]
    assert 0 <= mask < 8 and (defines == () if name == "base" else defines == (f"ISCC_VARIANT_ABLATE={mask}",))
    key = _build.build_key(defines, exp_variant_ablate.SOURCE)
    assert key != _build.build_key()
    others = {_build.build_key(exp_variant_ablate.defines_of(n), exp_variant_ablate.SOURCE)
              for n in exp_variant_ablate.VARIANTS if n != name}
    assert key not in others
    src = SOURCE.read_text()
    for bit, part in ((1, "kCutWgmma"), (2, "kCutEpilogue"), (4, "kCutStaging")):
        assert f"constexpr bool {part} = ISCC_VARIANT_ABLATE & {bit};" in src


def test_ablation_compound_variants_are_the_union_of_their_parts():
    v = exp_variant_ablate.VARIANTS
    assert v["wgmma_only"] == v["no_epilogue"] | v["no_staging"]
    assert v["fixed_only"] == v["no_wgmma"] | v["no_epilogue"]
    assert sorted(v[n] for n in ("no_wgmma", "no_epilogue", "no_staging")) == [1, 2, 4]
    assert all(ek.variant_spec(name) for name in exp_variant_ablate.NAMES)
