"""
Phase 1 from the bit-transposed twin on the int8 tensor cores, an A/B
entry point (port of ``benchmarks/exp_bitplane_int8.py``; kernel
``csrc/blockmax_bitplane.cu``, entry ``iscc_blockmax_bitplane``).

The twin is :func:`~iscc_search_tpu_torch.ops.bitplane.bit_transpose_packed`
of 256-bit packed rows. Bit plane ``s`` of a (256, 128) view tile is the 0/1
matrix of 128 rows (one per view column), dotted with the ±1/0 queries;
``dot_pm1 = 2 * dot01 - sum(q)``. The epilogue is the script's:
``x = bf16(2 * dot01 - qsum) + pen`` in bfloat16 (``pen`` (1, N) in
:func:`~iscc_search_tpu_torch.ops.bitplane.bitplane_penalty_perm` order),
the max over each original block's 128 rows, then ``0.5 + f32(m) * qs``
rounded once. The script's modes (``int8``, ``int8v2``, ``bf16cast``) and
``planes_per_dot`` change how the TPU extracts and groups the planes, not
the function: they all map to the one kernel.

The kernel (``csrc/blockmax_bitplane.cu``, mirrored in numpy by
:mod:`.bitplane_layout`) runs ``wgmma`` with the queries resident per thread
block, lands each slice of the twin once by TMA, un-transposes it into 0/1
int8 row tiles by byte permutes in a producer warpgroup, and takes one
element per query and block wherever the block's penalties allow
(:func:`bitplane_path_blocks` reads how many blocks did).

On every block with a valid row the result equals
:func:`~iscc_search_tpu_torch.ops.hopper_scan.blockmax` on the packed rows.

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_bitplane_int8
[--n ROWS] [--q Q]``
"""

from __future__ import annotations

import ctypes
import functools
import json

import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.bitplane import PERM_GROUP, bit_transpose_packed, bitplane_penalty_perm
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, query_prefix

NBITS = 256
CHUNK = 32768
BLOCK = 128
MODES = ("int8", "int8v2", "bf16cast")
PLAIN_STEP_GROUPS = 16  # 4096-row groups per step of the plain version (bounds its memory)


def _check_bitplane(q, q_scale, db, pen, view_rows_per_group, pen_dtype):
    # type: (...) -> int
    """Shared checks of the bitplane wrappers; returns the database rows."""
    hs._check(q, "q", torch.int8, 2)
    hs._check(q_scale, "q_scale", torch.float32, 1)
    hs._check(pen, "pen", pen_dtype, 2)
    if db.dim() != 2 or not db.is_contiguous() or db.shape[1] != 128 or db.shape[0] % view_rows_per_group:
        raise ValueError(f"db must be a contiguous (G * {view_rows_per_group}, 128) twin, got {tuple(db.shape)}")
    n = db.shape[0] // view_rows_per_group * PERM_GROUP
    if q.shape[1] != NBITS or q.data_ptr() % 4 or q_scale.shape[0] != q.shape[0] or pen.shape != (1, n):
        raise ValueError(
            f"need q (Q, {NBITS}) 4-byte aligned, q_scale (Q,) and pen (1, {n}), got "
            f"{tuple(q.shape)}, {tuple(q_scale.shape)}, {tuple(pen.shape)}"
        )
    return n


def plane_dots(q, tile, width_bits):
    # type: (torch.Tensor, torch.Tensor, int) -> torch.Tensor
    """0/1-plane dots of a (G, bands * 256, 128) twin tile of ``width_bits``
    elements (already widened to int64 and masked): (Q, G * 4096) float32 in
    dot-column order ``c = s * bands * 128 + b * 128 + j`` per group."""
    g = tile.shape[0]
    bands = 32 // width_bits
    shifts = torch.arange(width_bits, dtype=torch.int64, device=tile.device)
    bits = ((tile.reshape(g, bands, 256, 128)[..., None] >> shifts) & 1).float()  # (g, b, u, j, s)
    return torch.einsum("qu,gbujs->qgsbj", q.float(), bits).reshape(q.shape[0], g * PERM_GROUP)


def blockmax_bitplane_plain(q, q_scale, db, pen):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """Plain version of :func:`blockmax_bitplane`: the planes of
    ``PLAIN_STEP_GROUPS`` groups at a time, f32 dots, the bf16 epilogue."""
    n = _check_bitplane(q, q_scale, db, pen, NBITS, torch.bfloat16)
    qsum = q.float().sum(dim=1, keepdim=True)
    out = torch.empty((q.shape[0], n // BLOCK), dtype=torch.float32, device=db.device)
    for g0 in range(0, n // PERM_GROUP, PLAIN_STEP_GROUPS):
        tile = db[g0 * NBITS : (g0 + PLAIN_STEP_GROUPS) * NBITS].to(torch.int64) & 0xFFFFFFFF
        gs = tile.shape[0] // NBITS
        rows = slice(g0 * PERM_GROUP, (g0 + gs) * PERM_GROUP)
        x = ((2.0 * plane_dots(q, tile.reshape(gs, NBITS, 128), 32) - qsum).to(torch.bfloat16) + pen[:, rows]).float()
        m = x.reshape(q.shape[0], gs, BLOCK, 32).amax(dim=2).reshape(q.shape[0], gs * 32)
        out[:, g0 * 32 : (g0 + gs) * 32] = hs.fma_score(m, q_scale[:, None])
    return out


def blockmax_bitplane(q, q_scale, db, pen):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """
    Block maxima from the bit-transposed twin (module docstring): the plain
    version for CPU tensors, the kernel for CUDA tensors
    (``blockmax_bitplane.launches``). For a NaN penalty the kernel's output
    is undefined (its maxima are ``fmaxf``'s, which drop a NaN that the
    plain version's ``amax`` keeps).

    :param q: (Q, 256) int8 ±1/0 prefix-masked queries
    :param q_scale: (Q,) float32
    :param db: (N / 16, 128) int32 ``bit_transpose_packed`` twin, N % 4096 == 0
    :param pen: (1, N) bfloat16 penalty in ``bitplane_penalty_perm`` order
    :return: (Q, N / 128) float32, block b = original rows [128b, 128b + 128)
    """
    n = _check_bitplane(q, q_scale, db, pen, NBITS, torch.bfloat16)
    hs._check(db, "db", torch.int32, 2)
    if hs._route([q, q_scale, db, pen]) == "cpu":
        return blockmax_bitplane_plain(q, q_scale, db, pen)
    out = torch.empty((q.shape[0], n // BLOCK), dtype=torch.float32, device=db.device)
    hs.launch(
        blockmax_bitplane, "iscc_blockmax_bitplane", db.device, q.data_ptr(), q_scale.data_ptr(), q.shape[0],
        db.data_ptr(), pen.data_ptr(), n, out.data_ptr(),
    )
    return out


blockmax_bitplane.launches = 0


def bitplane_path_blocks(device):
    # type: (torch.device) -> tuple[int, int]
    """(blocks whose maxima the kernel finished, those of them on the fast
    path) over the CUDA launches on ``device`` since the last call, as the
    kernel counted them where it branches (a block counts once per query
    chunk; the launches of ``exp_bitplane_u8.blockmax_subword`` count here
    too, one kernel at another width); the counts are then cleared."""
    counts = (ctypes.c_ulonglong * 2)()
    with torch.cuda.device(device):
        err = hs._entry("iscc_blockmax_bitplane_paths")(ctypes.addressof(counts), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"reading the blockmax_bitplane path counts failed: cudaError {err}")
    return int(counts[0]), int(counts[1])


def bitplane_penalties(valid, general=False):
    # type: (torch.Tensor, bool) -> torch.Tensor
    """The (1, N) bfloat16 penalty in ``bitplane_penalty_perm`` order from
    (N,) validity: 0 / -65536 (every block takes the kernel's fast path), or
    with ``general`` random values seeded by N, within 400 of each other,
    that take its per-element path."""
    n = valid.shape[0]
    if general:
        gen = torch.Generator(device=valid.device).manual_seed(n)
        pen = (torch.rand(n, device=valid.device, generator=gen) - 0.5) * 400
    else:
        pen = torch.where(valid.bool(), 0.0, -65536.0)
    return bitplane_penalty_perm(pen).to(torch.bfloat16)[None, :]


def _variant(q_pm1, q_scale, db, pen):
    return blockmax_bitplane(q_pm1.to(torch.int8).contiguous(), q_scale, db, pen)


def make_variant(n, q, chunk, planes_per_dot, mode):
    # type: (int, int, int, int, str) -> ...
    """fn(q_pm1, q_scale, db, pen) for one of the script's variants; every
    mode and ``planes_per_dot`` computes the same function."""
    if mode not in MODES or planes_per_dot <= 0 or 32 % planes_per_dot:
        raise ValueError(f"mode must be one of {MODES} and planes_per_dot divide 32, got {mode!r}, {planes_per_dot}")
    if chunk <= 0 or chunk % PERM_GROUP or n % chunk:
        raise ValueError(f"chunk must be a multiple of {PERM_GROUP} dividing n={n}, got {chunk}")
    return _variant


def main(argv=None):
    args = ex.parser(__doc__, n=8_388_608, q=256).parse_args(argv)
    dev = ex.device_of(args.device)
    n, nq = args.n, args.q
    chunk = min(CHUNK, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"n={n} q={nq} chunk={chunk} device={ex.device_name(dev)}", flush=True)
    packed = torch.randint(-(2**31), 2**31, (n, NBITS // 32), dtype=torch.int32, device=dev, generator=gen)
    valid = torch.ones(n, dtype=torch.uint8, device=dev)
    valid[torch.randint(0, n, (n // 64,), device=dev, generator=gen)] = 0
    q_packed = packed[:: n // nq][:nq].contiguous()
    min_lanes, q_scale = query_prefix(torch.full((nq,), NBITS // 32, dtype=torch.int32, device=dev), NBITS)
    q_pm1 = masked_queries(q_packed, min_lanes, NBITS)
    bt = bit_transpose_packed(packed)
    pen = bitplane_penalties(valid)

    shipped = functools.partial(hs.blockmax, q_packed, min_lanes, q_scale, packed, valid)
    ref = shipped()
    live = valid.bool().reshape(-1, BLOCK).any(dim=1)
    results = {"blockmax": ex.time_ms(shipped, dev, args.reps)}
    print(f"blockmax (popc, packed rows): {results['blockmax']:.4f} ms", flush=True)
    # Every mode and planes_per_dot is one launch: timed once, under every label.
    labels = []
    for mode in MODES:
        for ppd in (4, 8, 16):
            variant = make_variant(n, nq, chunk, ppd, mode)
            labels.append(f"{mode}_p{ppd}")
    fn = functools.partial(variant, q_pm1, q_scale, bt, pen)
    exact = bool(torch.equal(fn()[:, live], ref[:, live]))
    ms = ex.time_ms(fn, dev, args.reps)
    results.update(dict.fromkeys(labels, ms))
    print(f"bitplane: {ms:.4f} ms exact={exact} (one launch for {', '.join(labels)})", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
