"""
Twin layouts of the phase-1 experiments, as plain torch ops on any device
(port of ``bit_transpose_packed``, ``bitplane_penalty_perm`` and
``PERM_GROUP`` of ``iscc_search_tpu/ops/pallas_scan.py`` and of
``_o_map``, ``build_twin`` and ``penalty_perm`` of
``benchmarks/exp_bitplane_u8.py``), plus the int4 twin of the int4 probe.

Packed rows are int32 tensors carrying uint32 bits (see
:mod:`iscc_search_tpu_torch.ops.pm1_scan`); every word is widened to int64
and masked before a shift. Bit ``u`` of a row is in :func:`unpack_pm1`
order: lanes in order, MSB-first within each lane. The builders work in
row steps of ``TWIN_STEP_ROWS`` on the input's device, so a twin of
millions of rows is built on the card without a bit-expanded copy of the
whole input.

Layouts (per group of ``PERM_GROUP`` = 4096 rows, ``j = j1 * 32 + j0``):

- :func:`bit_transpose_packed`: ``(N * lanes / 128, 128)`` int32 words;
  view word ``(u, j)`` holds at bit ``s`` bit ``u`` of row
  ``j0 * 128 + s * 4 + j1``. Original block ``j0`` is the four view
  columns ``j1 * 32 + j0`` of all ``nbits`` view rows.
- :func:`build_twin` (sub-word twins, 256-bit rows): ``(N * 32 / w / 16,
  128)`` elements of ``w`` bits (uint8 for ``w = 8``; for ``w = 16`` an
  int16 tensor holding the uint16 bits, since CPU torch has few uint16
  ops). Element ``(256 * b + u, j)`` holds at bit ``s`` bit ``u`` of row
  ``j0 * 128 + s * (128 / w) + b * 4 + j1``.
- :func:`build_int4_twin`: ``(N, nbits / 2)`` uint8, two int4 values per
  byte, element ``2m`` in the low nibble of byte ``m`` and ``2m + 1`` in
  the high nibble, two's complement (+1 = 0x1, -1 = 0xF). This is the
  order in which ``mma.sync`` reads ``.s4`` operands from a register
  (element ``i`` in bits ``4i .. 4i + 3``, little-endian bytes).
"""

from __future__ import annotations

import numpy as np
import torch

PERM_GROUP = 4096  # rows per permutation group
TWIN_STEP_ROWS = 1 << 16  # rows per step of the twin builders (bounds their memory)
_WORD = 0xFFFFFFFF


def _words(packed):
    # type: (torch.Tensor) -> torch.Tensor
    """int32-carried uint32 words widened to int64 in [0, 2**32)."""
    return packed.to(torch.int64) & _WORD


def _bits(packed, nbits):
    # type: (torch.Tensor, int) -> torch.Tensor
    """(m, nbits) int64 0/1, bit u of each row in unpack_pm1 order."""
    shifts = torch.arange(31, -1, -1, dtype=torch.int64, device=packed.device)
    return ((_words(packed[:, : nbits // 32])[:, :, None] >> shifts) & 1).reshape(packed.shape[0], nbits)


def _as_int32(words):
    # type: (torch.Tensor) -> torch.Tensor
    """int64 values in [0, 2**32) -> int32 tensor carrying the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _check_groups(packed, lanes_allowed):
    # type: (torch.Tensor, tuple) -> tuple[int, int]
    if packed.dim() != 2 or packed.dtype != torch.int32:
        raise ValueError(f"packed must be a 2-d int32 tensor, got {packed.dtype} {tuple(packed.shape)}")
    n, lanes = packed.shape
    if lanes not in lanes_allowed or n % PERM_GROUP:
        raise ValueError(
            f"this layout needs {'/'.join(str(32 * x) for x in lanes_allowed)}-bit rows and "
            f"N % {PERM_GROUP} == 0, got {tuple(packed.shape)}"
        )
    return n, lanes


def _stepped(n, build, out_rows_per_row, width, dtype, device):
    # type: (...) -> torch.Tensor
    """Fill an (n * out_rows_per_row, width) output in TWIN_STEP_ROWS steps."""
    out = torch.empty((int(n * out_rows_per_row), width), dtype=dtype, device=device)
    for s in range(0, n, TWIN_STEP_ROWS):
        e = min(n, s + TWIN_STEP_ROWS)
        out[int(s * out_rows_per_row) : int(e * out_rows_per_row)] = build(s, e)
    return out


def bit_transpose_packed(packed):
    # type: (torch.Tensor) -> torch.Tensor
    """
    Bit-transposed twin of 128- or 256-bit packed rows (``bit_transpose_packed``
    of the JAX package): see the module docstring for the layout.

    :param packed: (N, lanes) int32 packed rows, lanes 4 or 8, N % 4096 == 0
    :return: (N * lanes // 128, 128) int32 (uint32 bits), on packed's device
    """
    n, lanes = _check_groups(packed, (4, 8))
    nbits = lanes * 32
    weights = torch.ones(32, dtype=torch.int64, device=packed.device) << torch.arange(32, device=packed.device)

    def build(s, e):
        g = (e - s) // PERM_GROUP
        # rows o = j0*128 + s*4 + j1: source axes (g, j0, s, j1, u) -> (g, j1, j0, s, u)
        b2 = _bits(packed[s:e], nbits).reshape(g, 32, 32, 4, nbits).permute(0, 3, 1, 2, 4)
        t = (b2.reshape(g, 128, 32, nbits) * weights[None, None, :, None]).sum(dim=2)  # (g, 128 j, nbits u)
        return _as_int32(t.transpose(1, 2)).reshape(g * nbits, 128)

    return _stepped(n, build, lanes / 128, 128, torch.int32, packed.device)


def bitplane_penalty_perm(penalty_flat):
    # type: (torch.Tensor) -> torch.Tensor
    """Reorder a per-row (N,) penalty into bitplane dot-column order
    (p = s*128 + j1*32 + j0  <->  o = j0*128 + s*4 + j1 per 4096 group)."""
    n = penalty_flat.shape[0]
    return penalty_flat.reshape(n // PERM_GROUP, 32, 32, 4).permute(0, 2, 3, 1).reshape(n)


def _o_map(width_bits):
    # type: (int) -> np.ndarray
    """(S, B, 128) original-row index per (shift s, sublane band b, lane j)."""
    s_count = width_bits
    b_count = 32 // width_bits
    s_i, b_i, j_i = np.meshgrid(np.arange(s_count), np.arange(b_count), np.arange(128), indexing="ij")
    return (j_i % 32) * 128 + s_i * (128 // s_count) + b_i * 4 + j_i // 32


def build_twin(packed, width_bits):
    # type: (torch.Tensor, int) -> torch.Tensor
    """
    Sub-word bitplane twin of 256-bit packed rows (``build_twin`` of
    ``benchmarks/exp_bitplane_u8.py``).

    :param packed: (N, 8) int32 packed rows, N % 4096 == 0
    :param width_bits: 8 (uint8 elements) or 16 (uint16 bits held in int16)
    :return: (N * (32 // width_bits) // 16, 128) uint8 or int16, on packed's device
    """
    if width_bits not in (8, 16):
        raise ValueError(f"width_bits must be 8 or 16, got {width_bits}")
    n, _ = _check_groups(packed, (8,))
    o_flat = torch.from_numpy(_o_map(width_bits).reshape(-1)).to(packed.device)
    weights = torch.ones(width_bits, dtype=torch.int64, device=packed.device) << torch.arange(
        width_bits, device=packed.device
    )
    bands = 32 // width_bits

    def build(s, e):
        g = (e - s) // PERM_GROUP
        bits = _bits(packed[s:e], 256).reshape(g, PERM_GROUP, 256)
        sel = bits[:, o_flat, :].reshape(g, width_bits, PERM_GROUP // width_bits, 256)  # [g, s, b*128+j, u]
        acc = (sel * weights[None, :, None, None]).sum(dim=1)  # (g, bands*128, 256)
        a = acc.reshape(g, bands, 128, 256).transpose(2, 3).reshape(-1, 128)  # rows 256*b + u, lanes j
        if width_bits == 8:
            return a.to(torch.uint8)
        return torch.where(a >= 2**15, a - 2**16, a).to(torch.int16)

    dtype = torch.uint8 if width_bits == 8 else torch.int16
    return _stepped(n, build, bands / 16, 128, dtype, packed.device)


def penalty_perm(pen_flat, width_bits):
    # type: (torch.Tensor, int) -> torch.Tensor
    """Reorder a per-row (N,) penalty into the sub-word twin's dot-column
    order c = (s, b, j)."""
    n = pen_flat.shape[0]
    o_flat = torch.from_numpy(_o_map(width_bits).reshape(-1)).to(pen_flat.device)
    return pen_flat.reshape(n // PERM_GROUP, PERM_GROUP)[:, o_flat].reshape(n)


def build_int4_twin(values):
    # type: (torch.Tensor) -> torch.Tensor
    """
    int4 twin of an int8 matrix whose values lie in [-8, 7] (the ±1 rows of
    the int4 probe): two's-complement nibbles, two per byte, element 2m in
    the low nibble of byte m.

    :param values: (N, K) int8, K even
    :return: (N, K // 2) uint8, on values' device
    """
    if values.dim() != 2 or values.dtype != torch.int8 or values.shape[1] % 2:
        raise ValueError(f"values must be a 2-d int8 tensor with an even width, got {values.dtype} {tuple(values.shape)}")
    n, k = values.shape

    def build(s, e):
        nib = values[s:e].to(torch.int16) & 0xF
        return (nib[:, 0::2] | (nib[:, 1::2] << 4)).to(torch.uint8)

    return _stepped(n, build, 1, k // 2, torch.uint8, values.device)


def unpack_int4(twin):
    # type: (torch.Tensor) -> torch.Tensor
    """(N, K // 2) uint8 int4 twin -> (N, K) int8 values (sign-extended)."""
    b = twin.to(torch.int16)
    nib = torch.stack([b & 0xF, b >> 4], dim=2).reshape(twin.shape[0], twin.shape[1] * 2)
    return torch.where(nib >= 8, nib - 16, nib).to(torch.int8)
