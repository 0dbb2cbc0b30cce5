"""
Phase 1 from the sub-word bitplane twins (uint8 / uint16 elements), an A/B
entry point (port of ``benchmarks/exp_bitplane_u8.py``; kernel
``csrc/blockmax_bitplane.cu``, entry ``iscc_blockmax_subword``).

The twin is :func:`~iscc_search_tpu_torch.ops.bitplane.build_twin`: per
4,096-row group, element ``(256 * b + u, j)`` holds at bit ``s`` bit ``u``
of row ``o(s, b, j)`` (:func:`~iscc_search_tpu_torch.ops.bitplane._o_map`).
The epilogue is the script's, in int32: ``x = dot01 + pen`` with ``pen``
0 / -32768 in :func:`~iscc_search_tpu_torch.ops.bitplane.penalty_perm`
order, the max over each original block's 128 rows, then
``0.5 + f32(2 * m - qsum) * qs``. The penalty commutes with the affine map,
so the result equals :func:`~iscc_search_tpu_torch.ops.hopper_scan.blockmax`
on the packed rows on every block, all-invalid blocks included.

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_bitplane_u8
[--n ROWS] [--q Q]``
"""

from __future__ import annotations

import functools
import json

import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.experiments.exp_bitplane_int8 import _check_bitplane, plane_dots
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.bitplane import PERM_GROUP, build_twin, penalty_perm
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, query_prefix

NBITS = 256
GROUP = PERM_GROUP
CHUNK = 32768
BLOCK = 128
PENALTY = -32768
PLAIN_STEP_GROUPS = 16  # 4096-row groups per step of the plain version
_TWIN_DTYPES = {8: torch.uint8, 16: torch.int16}


def _view_rows(width_bits):
    # type: (int) -> int
    if width_bits not in _TWIN_DTYPES:
        raise ValueError(f"width_bits must be 8 or 16, got {width_bits}")
    return (32 // width_bits) * 256


def blockmax_subword_plain(q, q_scale, twin, pen, width_bits):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int) -> torch.Tensor
    """Plain version of :func:`blockmax_subword`: f32 plane dots of a few
    groups at a time, the int32 epilogue."""
    vr = _view_rows(width_bits)
    n = _check_bitplane(q, q_scale, twin, pen, vr, torch.int32)
    qsum = q.to(torch.int32).sum(dim=1, keepdim=True)
    out = torch.empty((q.shape[0], n // BLOCK), dtype=torch.float32, device=twin.device)
    for g0 in range(0, n // GROUP, PLAIN_STEP_GROUPS):
        tile = twin[g0 * vr : (g0 + PLAIN_STEP_GROUPS) * vr].to(torch.int64) & ((1 << width_bits) - 1)
        gs = tile.shape[0] // vr
        x = plane_dots(q, tile.reshape(gs, vr, 128), width_bits).to(torch.int32) + pen[:, g0 * GROUP : (g0 + gs) * GROUP]
        m = x.reshape(q.shape[0], gs, BLOCK, 32).amax(dim=2).reshape(q.shape[0], gs * 32)
        out[:, g0 * 32 : (g0 + gs) * 32] = hs.fma_score((2 * m - qsum).float(), q_scale[:, None])
    return out


def blockmax_subword(q, q_scale, twin, pen, width_bits):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int) -> torch.Tensor
    """
    Block maxima from a sub-word twin (module docstring): the plain version
    for CPU tensors, the kernel for CUDA tensors
    (``blockmax_subword.launches``).

    :param q: (Q, 256) int8 ±1/0 prefix-masked queries
    :param q_scale: (Q,) float32
    :param twin: ``build_twin`` twin: (N / 4, 128) uint8 (w=8) or (N / 8, 128)
        int16 carrying uint16 bits (w=16), N % 4096 == 0
    :param pen: (1, N) int32 penalty in ``penalty_perm`` order
    :return: (Q, N / 128) float32, block b = original rows [128b, 128b + 128)
    """
    vr = _view_rows(width_bits)
    n = _check_bitplane(q, q_scale, twin, pen, vr, torch.int32)
    hs._check(twin, "twin", _TWIN_DTYPES[width_bits], 2)
    if hs._route([q, q_scale, twin, pen]) == "cpu":
        return blockmax_subword_plain(q, q_scale, twin, pen, width_bits)
    out = torch.empty((q.shape[0], n // BLOCK), dtype=torch.float32, device=twin.device)
    hs.launch(
        blockmax_subword, "iscc_blockmax_subword", twin.device, q.data_ptr(), q_scale.data_ptr(), q.shape[0],
        twin.data_ptr(), pen.data_ptr(), n, width_bits, out.data_ptr(),
    )
    return out


blockmax_subword.launches = 0


def subword_penalty(db_valid, width_bits):
    # type: (torch.Tensor, int) -> torch.Tensor
    """(1, N) int32 0 / -32768 penalty of a validity mask, in twin order."""
    pen = torch.where(db_valid.to(torch.bool), 0, PENALTY).to(torch.int32)
    return penalty_perm(pen, width_bits).reshape(1, -1)


def blockmax_subword_impl(q_pm1, q_scale, twin, db_valid, width_bits, chunk_size):
    # type: (...) -> torch.Tensor
    """The script's entry: penalty from the (N,) validity, int8 queries,
    then :func:`blockmax_subword`. ``chunk_size`` (a multiple of 4096
    dividing N) tiles the TPU grid only; the result does not depend on it."""
    n = twin.shape[0] // _view_rows(width_bits) * GROUP
    if chunk_size <= 0 or chunk_size % GROUP or n % chunk_size:
        raise ValueError(f"chunk_size must be a multiple of {GROUP} dividing N={n}, got {chunk_size}")
    return blockmax_subword(
        q_pm1.to(torch.int8).contiguous(), q_scale, twin, subword_penalty(db_valid, width_bits), width_bits
    )


def main(argv=None):
    args = ex.parser(__doc__, n=8_388_608, q=256).parse_args(argv)
    dev = ex.device_of(args.device)
    n, nq = args.n, args.q
    chunk = min(CHUNK, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"n={n} q={nq} chunk={chunk} device={ex.device_name(dev)}", flush=True)
    packed = torch.randint(-(2**31), 2**31, (n, NBITS // 32), dtype=torch.int32, device=dev, generator=gen)
    valid = torch.ones(n, dtype=torch.uint8, device=dev)
    q_packed = packed[torch.arange(nq, device=dev) * (n // nq)]
    min_lanes, q_scale = query_prefix(torch.full((nq,), NBITS // 32, dtype=torch.int32, device=dev), NBITS)
    q_pm1 = masked_queries(q_packed, min_lanes, NBITS)
    shipped = functools.partial(hs.blockmax, q_packed, min_lanes, q_scale, packed, valid)
    ref = shipped()
    results = {"blockmax": ex.time_ms(shipped, dev, args.reps)}
    print(f"blockmax (popc, packed rows): {results['blockmax']:.4f} ms per sweep", flush=True)
    for wb in (8, 16):
        twin = build_twin(packed, wb)
        fn = functools.partial(blockmax_subword_impl, q_pm1, q_scale, twin, valid, wb, chunk)
        exact = bool(torch.equal(fn(), ref))
        results[f"u{wb}"] = ex.time_ms(fn, dev, args.reps)
        print(f"u{wb}: {results[f'u{wb}']:.4f} ms per sweep, exact vs blockmax={exact}, "
              f"{results['blockmax'] / results[f'u{wb}']:.2f}x", flush=True)
        del twin
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
