"""
Phase-1 epilogue variants over the ±1 int8 twin, an A/B harness (port of
``benchmarks/exp_kernels.py``; kernel ``csrc/blockmax_variants.cu``).

Every variant takes ``q`` (Q, 256) int8 ±1/0, ``qs`` (Q, 1) float32,
``db`` (N, 256) int8 ±1 and a penalty row ``pen``, and returns (Q, N/128)
float32 ((N/128, Q) for ``trans*``). ``m`` below is a max over the 128
rows of a block, ``fma`` the score ``0.5 + m * qs`` rounded once, as the
Pallas kernels round it:

- ``bf16``, ``sub2048``, ``sub8192``, ``chunk<N>``, ``tree``:
  ``fma(f32(m(bf16(dot) + pen)))``, ``pen`` (1, N) bfloat16 added in
  bfloat16 (tiling and max-tree order do not change the function);
- ``bf16_nopen``: the same without the penalty;
- ``trans``, ``tree_trans``: the ``bf16`` function, ``pen`` (N, 1), output
  transposed;
- ``u8max``: ``(m(u8(clip((dot >> 1) + 127, 0, 255)) * pen) - 127) * 2``,
  ``pen`` (1, N) uint8 (a different function from the others);
- ``bf16dot``: the dot on the bf16 tensor cores (f32 accumulate), then
  ``fma(m(dot + f32(pen)))``;
- ``dotonly``, ``dotonly_bf16`` (dot on the bf16 tensor cores): column
  ``t * 32 + c`` holds the dot of row ``t * 4096 + c``: every dot is
  computed, the first 32 of each 4,096-row sub-tile are stored;
- ``consume*``: every column of sub-tile ``t`` holds the sum over its
  4,096 rows of ``bf16(dot)`` (exact in f32: ``|sum| <= 2**20``);
- ``tree2d``: column ``t * 32 + c`` is ``fma(m')``, ``m'`` the max of
  ``bf16(dot) + pen`` over the rows ``t * 4096 + c + 32 * i``, i < 128 (the
  probe's stride classes, not consecutive blocks);
- ``*_nodma`` and ``nodma_full``: the db rows of chunk 0 for every chunk
  (row ``r`` reads db row ``r % 16384``), the penalty of the true row.

``base`` is :func:`~iscc_search_tpu_torch.ops.hopper_scan.blockmax_mma_unpacked`.

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_kernels [--n ROWS]
[--q Q] [names ...]``
"""

from __future__ import annotations

import ctypes
import functools
import json

import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, query_prefix

NBITS = 256
CHUNK = 16384
SUB = 4096  # rows per sub-tile of the dotonly / consume / tree2d probes
BLOCK = 128
PLAIN_STEP_ROWS = 65536  # rows per step of the plain version (bounds its memory)
DEFAULT_NAMES = ("base", "bf16", "bf16_nopen", "trans", "sub2048", "sub8192")
NAMES = (
    "bf16", "bf16_nopen", "trans", "tree_trans", "sub2048", "sub8192", "tree", "tree2d", "u8max", "bf16dot",
    "dotonly", "dotonly_bf16", "dotonly_nodma", "dotonly_bf16_nodma", "consume", "consume_f32acc",
    "consume_nodma", "nodma_full", "chunk32768",
)  # every family the script accepts; any chunk<N> with N % 4096 == 0 works too

# Epilogues, the codes of csrc/blockmax_variants.cu.
EPI_BF16, EPI_BF16_NOPEN, EPI_TRANS, EPI_U8MAX, EPI_BF16DOT = 0, 1, 2, 3, 4
EPI_DOTONLY, EPI_DOTONLY_BF16, EPI_CONSUME, EPI_TREE2D = 5, 6, 7, 8


def variant_spec(name):
    # type: (str) -> tuple[int, int, bool, str]
    """(epilogue, chunk rows, chunk-0 rows only, "row" or "col") of a
    variant name, parsed as ``make_variant`` of the script parses it."""
    chunk = int(name[5:]) if name.startswith("chunk") else CHUNK
    sub = {"sub2048": 2048, "sub8192": 8192}.get(name, SUB)
    if chunk <= 0 or chunk % sub:
        raise ValueError(f"{name}: the chunk must be a positive multiple of its {sub}-row sub-tile")
    nodma = "nodma" in name
    if name.startswith("consume"):
        return EPI_CONSUME, chunk, nodma, "row"
    if name in ("nodma_full", "bf16dot"):
        return (EPI_BF16, chunk, True, "row") if name == "nodma_full" else (EPI_BF16DOT, chunk, False, "row")
    if name.startswith("dotonly"):
        return (EPI_DOTONLY_BF16 if "bf16" in name else EPI_DOTONLY), chunk, nodma, "row"
    if name in ("bf16", "sub2048", "sub8192", "tree") or name.startswith("chunk"):
        return EPI_BF16, chunk, False, "row"
    simple = {"bf16_nopen": EPI_BF16_NOPEN, "tree2d": EPI_TREE2D, "u8max": EPI_U8MAX}
    if name in simple:
        return simple[name], chunk, False, "row"
    if name in ("trans", "tree_trans"):
        return EPI_TRANS, CHUNK, False, "col"
    raise ValueError(f"unknown variant {name!r}")


def launch_key(name):
    # type: (str) -> tuple[int, int]
    """(epilogue, db_wrap): the kernel launch a variant makes. Names with one
    key launch the same kernel with the same arguments (tiling and tree
    order are the TPU's, not the function's)."""
    epi, chunk, nodma, _ = variant_spec(name)
    return epi, chunk if nodma else 0


def _check_inputs(name, q, qs, db, pen):
    # type: (...) -> tuple[int, int, bool, str]
    epi, chunk, nodma, orient = variant_spec(name)
    n = db.shape[0]
    hs._check(q, "q", torch.int8, 2)
    hs._check(qs, "qs", torch.float32, 2)
    hs._check(db, "db", torch.int8, 2)
    pen_dtype = torch.uint8 if epi == EPI_U8MAX else torch.bfloat16
    pen_shape = (n, 1) if orient == "col" else (1, n)
    hs._check(pen, "pen", pen_dtype, 2)
    if q.shape[1] != NBITS or db.shape[1] != NBITS or qs.shape != (q.shape[0], 1) or pen.shape != pen_shape:
        raise ValueError(
            f"{name}: need q (Q, {NBITS}), qs (Q, 1), db (N, {NBITS}) and pen {pen_shape}, got "
            f"{tuple(q.shape)}, {tuple(qs.shape)}, {tuple(db.shape)}, {tuple(pen.shape)}"
        )
    if n % chunk or db.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError(
            f"{name}: db rows ({n}) must be a multiple of the {chunk}-row chunk, db 16-byte and q 4-byte aligned"
        )
    return epi, chunk, nodma, orient


def _plain_step(epi, dot, qs, pen):
    # type: (int, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """(Q, rows / 128) output columns of one row step from its (Q, rows)
    f32 dots and the step's flat penalty."""
    nq, rows = dot.shape
    if epi in (EPI_DOTONLY, EPI_DOTONLY_BF16):
        return dot.reshape(nq, rows // SUB, SUB)[:, :, : SUB // BLOCK].reshape(nq, rows // BLOCK)
    if epi == EPI_CONSUME:
        sums = dot.to(torch.bfloat16).float().reshape(nq, rows // SUB, SUB).sum(dim=2, keepdim=True)
        return sums.expand(nq, rows // SUB, SUB // BLOCK).reshape(nq, rows // BLOCK)
    if epi == EPI_U8MAX:
        y = ((dot.to(torch.int32) >> 1) + 127).clamp(0, 255).to(torch.uint8) * pen[None, :]
        return (y.reshape(nq, rows // BLOCK, BLOCK).amax(dim=2).float() - 127.0) * 2.0
    if epi == EPI_BF16DOT:
        x = dot + pen.float()[None, :]
    elif epi == EPI_BF16_NOPEN:
        x = dot
    else:
        x = (dot.to(torch.bfloat16) + pen[None, :]).float()
    if epi == EPI_TREE2D:
        m = x.reshape(nq, rows // SUB, SUB // 32, 32).amax(dim=2).reshape(nq, rows // BLOCK)
    else:
        m = x.reshape(nq, rows // BLOCK, BLOCK).amax(dim=2)
    return hs.fma_score(m, qs)


def blockmax_variant_plain(name, q, qs, db, pen):
    # type: (str, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """Plain PyTorch version of :func:`blockmax_variant`: f32 matmul (exact
    for ±1 dots), then the variant's epilogue in torch's own bf16 / uint8
    arithmetic, in row steps of ``PLAIN_STEP_ROWS``."""
    epi, chunk, nodma, orient = _check_inputs(name, q, qs, db, pen)
    n = db.shape[0]
    qf = q.float()
    pen_flat = pen.reshape(n)
    out = torch.empty((q.shape[0], n // BLOCK), dtype=torch.float32, device=db.device)
    for s in range(0, n, PLAIN_STEP_ROWS):
        e = min(n, s + PLAIN_STEP_ROWS)
        rows = db[torch.arange(s, e, device=db.device) % chunk] if nodma else db[s:e]
        out[:, s // BLOCK : e // BLOCK] = _plain_step(epi, qf @ rows.float().T, qs, pen_flat[s:e])
    return out.T.contiguous() if orient == "col" else out


def blockmax_variant(name, q, qs, db, pen):
    # type: (str, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """
    One variant of the phase-1 probe (module docstring): the plain version
    for CPU tensors, the ``csrc/blockmax_variants.cu`` kernel for CUDA
    tensors (counted on ``blockmax_variant.launches``).

    The kernel holds to the plain version only within this contract: every
    dot in [-256, 256], and no NaN penalty. For values outside ±1 / ±1/0,
    or a NaN penalty, its output is undefined (its maxima are taken by
    ``fmaxf``, which drops a NaN that the plain version's ``amax`` keeps).

    :param q: (Q, 256) int8 ±1/0 queries
    :param qs: (Q, 1) float32 scales
    :param db: (N, 256) int8 ±1 twin, N a multiple of the variant's chunk
    :param pen: (1, N) bfloat16 (``u8max``: uint8; ``trans*``: (N, 1))
    """
    epi, chunk, nodma, orient = _check_inputs(name, q, qs, db, pen)
    if hs._route([q, qs, db, pen]) == "cpu":
        return blockmax_variant_plain(name, q, qs, db, pen)
    n, nq = db.shape[0], q.shape[0]
    out = torch.empty((n // BLOCK, nq) if orient == "col" else (nq, n // BLOCK), dtype=torch.float32, device=db.device)
    hs.launch(
        blockmax_variant, "iscc_blockmax_variant", db.device, epi, q.data_ptr(), qs.data_ptr(), nq,
        db.data_ptr(), pen.data_ptr(), n, chunk if nodma else 0, out.data_ptr(),
    )
    return out


blockmax_variant.launches = 0


def variant_path_blocks(device):
    # type: (torch.device) -> tuple[int, int]
    """(blocks whose maxima the kernel finished, those of them on the fast
    path) over the CUDA launches on ``device`` since the last call, as the
    kernel counted them where it branches (``bf16``, ``bf16_nopen``,
    ``trans``, ``u8max``, ``bf16dot``; a block counts once per query chunk);
    the counts are then cleared."""
    counts = (ctypes.c_ulonglong * 2)()
    with torch.cuda.device(device):
        err = hs._entry("iscc_blockmax_variant_paths")(ctypes.addressof(counts), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"reading the blockmax_variant path counts failed: cudaError {err}")
    return int(counts[0]), int(counts[1])


def variant_penalties(name, valid, general=False):
    # type: (str, torch.Tensor, bool) -> torch.Tensor
    """The penalty argument of variant ``name`` from (N,) uint8 validity:
    0 / -65536 bfloat16 (the validity itself for ``u8max``), or with
    ``general`` random values, seeded by N, that take the kernel's
    per-element path (bfloat16 within 512 of each other; any uint8). Shaped
    (1, N), or (N, 1) for ``trans*``."""
    epi, _, _, orient = variant_spec(name)
    n = valid.shape[0]
    if general:
        gen = torch.Generator(device=valid.device).manual_seed(n)
        pen = (torch.randint(0, 256, (n,), dtype=torch.uint8, device=valid.device, generator=gen)
               if epi == EPI_U8MAX else ((torch.rand(n, device=valid.device, generator=gen) - 0.5) * 400).to(torch.bfloat16))
    else:
        pen = valid if epi == EPI_U8MAX else torch.where(valid.bool(), 0.0, -65536.0).to(torch.bfloat16)
    return pen[:, None] if orient == "col" else pen[None, :]


def make_variant(name, n, q):
    # type: (str, int, int) -> tuple
    """(fn(q_i8, qs, db, pen), "row" or "col") for a variant name, as the
    script's ``make_variant`` returns."""
    _, chunk, _, orient = variant_spec(name)
    if n % chunk:
        raise ValueError(f"{name}: n={n} is not a multiple of the {chunk}-row chunk")
    return functools.partial(blockmax_variant, name), orient


def main(argv=None):
    args = ex.parser(__doc__, n=10 * 1024 * 1024, q=256)
    args.add_argument("names", nargs="*", help=f"variants (default: {' '.join(DEFAULT_NAMES)})")
    args = args.parse_args(argv)
    dev = ex.device_of(args.device)
    n, nq = args.n, args.q
    names = args.names or list(DEFAULT_NAMES)
    print(json.dumps({"device": ex.device_name(dev), "n": n, "q": nq, "reps": args.reps}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    packed = torch.randint(-(2**31), 2**31, (n, NBITS // 32), dtype=torch.int32, device=dev, generator=gen)
    valid = torch.ones(n, dtype=torch.uint8, device=dev)
    valid[torch.randint(0, n, (1000,), device=dev, generator=gen)] = 0
    q_packed = packed[torch.randint(0, n, (nq,), device=dev, generator=gen)]
    min_lanes, q_scale = query_prefix(torch.full((nq,), NBITS // 32, dtype=torch.int32, device=dev), NBITS)
    db = hs.build_unpacked_db(packed, NBITS)
    q_i8 = masked_queries(q_packed, min_lanes, NBITS).to(torch.int8)
    qs = q_scale[:, None].contiguous()

    base = None
    results = {}
    timed = {}  # launch key -> first name timed with it
    for name in names:
        if name == "base":
            fn = functools.partial(hs.blockmax_mma_unpacked, q_packed, min_lanes, q_scale, db, valid)
        else:
            key = launch_key(name)
            if key in timed:  # the same launch: timed once
                results[name] = results[timed[key]]
                print(f"{name}: {results[name]:.4f} ms (the launch of {timed[key]})", flush=True)
                continue
            timed[key] = name
            variant, _ = make_variant(name, n, nq)
            fn = functools.partial(variant, q_i8, qs, db, variant_penalties(name, valid))
        ms = ex.time_ms(fn, dev, args.reps)
        out = fn()
        if name == "base":
            base = out
        elif base is not None:
            got = out.T if variant_spec(name)[3] == "col" else out
            diff = float((got - base).abs().max())
            print(f"  {name}: matches base {bool(torch.allclose(got, base, atol=1e-3))} (max diff {diff:.2e})")
        results[name] = ms
        print(f"{name}: {ms:.4f} ms", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
