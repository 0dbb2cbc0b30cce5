"""
The shared-memory operand layout of Hopper's ``wgmma`` that
``csrc/blockmax_mma.cu`` writes, mirrored in Python so that it can be held
on the CPU, and one bare ``wgmma`` tile on the card to prove the mirror.

An 8-bit ``wgmma`` operand is K-major: rows x K bytes, each row's bytes
contiguous in the source. In the no-swizzle layout (type 0, "interleave")
shared memory holds it as *core matrices* of 8 rows x 16 bytes, each 128
contiguous bytes. Element (row ``r``, byte ``k``) lies at::

    (k // 16) * LBO + (r // 8) * SBO + (r % 8) * 16 + k % 16

LBO (leading byte offset) steps between the 16-byte k-chunks, SBO (stride
byte offset) between groups of 8 rows. One ``m64n128k32`` reads two k-chunks
of each operand; the next k-step's descriptor starts ``2 * LBO`` further.
The kernel stores a tile as *panels*: all rows of k-chunk 0, then all rows
of k-chunk 1, ..., so SBO is 128 and LBO is ``rows * 16`` plus a pad
(:func:`panel_lbo`).

The 64-bit matrix descriptor (:func:`descriptor`) packs the start address,
LBO and SBO, each in 16-byte units, at bits 0, 16 and 32, and the layout
type at bit 62.

The accumulator of ``m64n128`` (:func:`accumulator_coords`): thread ``32 w +
4 g + t`` holds in register ``4 j + 2 h + c`` the element of A
row ``16 w + g + 8 h`` and B row ``8 j + 2 t + c``.
"""

from __future__ import annotations

import torch

from iscc_search_tpu_torch.ops import hopper_scan as hs

CORE_ROWS = 8
CORE_ROW_BYTES = 16
CORE_BYTES = CORE_ROWS * CORE_ROW_BYTES  # one core matrix
KSTEP_BYTES = 32  # K of one 8-bit wgmma
TILE_M = 64
TILE_N = 128
LAYOUT_INTERLEAVE = 0
ROWS_PAD = 16  # pad of the row tile's panels in csrc/blockmax_mma.cu (kRowsLbo)


def element_offset(r, k, lbo, sbo):
    """Byte offset of element (row ``r``, byte ``k``); ints or integer
    tensors that broadcast."""
    return (k // CORE_ROW_BYTES) * lbo + (r // CORE_ROWS) * sbo + (r % CORE_ROWS) * CORE_ROW_BYTES + k % CORE_ROW_BYTES


def panel_lbo(rows, pad=0):
    # type: (int, int) -> int
    """LBO of the kernel's panel form (SBO = 128): one k-chunk of every row,
    then ``pad`` bytes (a multiple of 16)."""
    if rows % CORE_ROWS or pad % CORE_ROW_BYTES:
        raise ValueError(f"rows must be a multiple of {CORE_ROWS} and pad of {CORE_ROW_BYTES}, got {rows}, {pad}")
    return rows * CORE_ROW_BYTES + pad


def image_bytes(rows, kbytes, lbo, sbo):
    # type: (int, int, int, int) -> int
    """Size of the shared-memory image of a (rows, kbytes) tile: one past
    its last element."""
    return int(element_offset(rows - 1, kbytes - 1, lbo, sbo)) + 1


def to_image(tile, lbo, sbo):
    # type: (torch.Tensor, int, int) -> torch.Tensor
    """The shared-memory image of a K-major tile.

    :param tile: (rows, kbytes) int8, rows % 8 == 0, kbytes % 16 == 0
    :return: (nbytes,) int8, nbytes a multiple of 16, zero where the layout
        leaves gaps
    """
    hs._check(tile, "tile", torch.int8, 2)
    rows, kbytes = tile.shape
    if rows % CORE_ROWS or kbytes % CORE_ROW_BYTES or lbo % CORE_ROW_BYTES or sbo % CORE_ROW_BYTES:
        raise ValueError(f"tile {tuple(tile.shape)} with lbo={lbo}, sbo={sbo} is not made of 16-byte pieces")
    r = torch.arange(rows, device=tile.device)[:, None]
    k = torch.arange(kbytes, device=tile.device)[None, :]
    off = element_offset(r, k, lbo, sbo).reshape(-1)
    if off.unique().numel() != off.numel():
        raise ValueError(f"lbo={lbo}, sbo={sbo} overlap for a {tuple(tile.shape)} tile")
    size = -(-image_bytes(rows, kbytes, lbo, sbo) // CORE_ROW_BYTES) * CORE_ROW_BYTES
    image = torch.zeros(size, dtype=torch.int8, device=tile.device)
    image[off] = tile.reshape(-1)
    return image


def descriptor(addr, lbo, sbo, layout=LAYOUT_INTERLEAVE):
    # type: (int, int, int, int) -> int
    """The 64-bit matrix descriptor of a tile at shared-memory byte address
    ``addr`` (``smem_desc`` of the kernel)."""
    if addr % 16 or lbo % 16 or sbo % 16:
        raise ValueError("address and offsets are multiples of 16 bytes")
    if not (0 <= addr < 1 << 18 and 0 <= lbo < 1 << 18 and 0 <= sbo < 1 << 18 and 0 <= layout < 4):
        raise ValueError("a field does not fit its 14 bits (2 for the layout)")
    return (addr >> 4) | (lbo >> 4) << 16 | (sbo >> 4) << 32 | layout << 62


def kstep_descriptor(addr, lbo, sbo, kstep):
    # type: (int, int, int, int) -> int
    """Descriptor of k-step ``kstep``: two k-chunks further per step."""
    return descriptor(addr + 2 * kstep * lbo, lbo, sbo)


def accumulator_coords(thread, reg):
    # type: (int, int) -> tuple[int, int]
    """(A row, B row) of accumulator register ``reg`` (0..63) of thread
    ``thread`` (0..127) of the warpgroup, for ``m64n128``."""
    w, lane = thread // 32, thread % 32
    g, t = lane // 4, lane % 4
    j, h, c = reg // 4, reg // 2 % 2, reg % 2
    return 16 * w + g + 8 * h, 8 * j + 2 * t + c


def wgmma_tile_plain(a, b):
    # type: (torch.Tensor, torch.Tensor) -> torch.Tensor
    """Plain version of :func:`wgmma_tile`: the (64, 128) int32 product in
    float32 (exact: |sum| <= 256 * 128 * 128 < 2**24)."""
    return (a.float() @ b.float().T).to(torch.int32)


def wgmma_tile(a, b, a_layout=None, b_layout=None):
    # type: (torch.Tensor, torch.Tensor, tuple[int, int] | None, tuple[int, int] | None) -> torch.Tensor
    """
    One bare ``wgmma`` tile: (64, 128) int32 = ``a @ b.T`` over K // 32
    k-steps of ``m64n128k32``, each operand written through
    :func:`to_image` (entry ``iscc_wgmma_tile``, ``wgmma_tile.launches``);
    the plain version for CPU tensors.

    :param a: (64, K) int8, K a multiple of 32 up to 256
    :param b: (128, K) int8
    :param a_layout: (LBO, SBO) of ``a``'s image; default the kernel's panel
        form of the query tile, ``(64 * 16, 128)``
    :param b_layout: the same for ``b``; default the kernel's row tile,
        ``(128 * 16 + ROWS_PAD, 128)``
    """
    hs._check(a, "a", torch.int8, 2)
    hs._check(b, "b", torch.int8, 2)
    kbytes = a.shape[1]
    if a.shape[0] != TILE_M or b.shape != (TILE_N, kbytes) or kbytes % KSTEP_BYTES or not 0 < kbytes <= 256:
        raise ValueError(f"need (64, K) and (128, K) int8 with K % 32 == 0, K <= 256, got {tuple(a.shape)}, {tuple(b.shape)}")
    if hs._route([a, b]) == "cpu":
        return wgmma_tile_plain(a, b)
    a_lbo, a_sbo = a_layout or (panel_lbo(TILE_M), CORE_BYTES)
    b_lbo, b_sbo = b_layout or (panel_lbo(TILE_N, ROWS_PAD), CORE_BYTES)
    a_image, b_image = to_image(a, a_lbo, a_sbo), to_image(b, b_lbo, b_sbo)
    out = torch.empty((TILE_M, TILE_N), dtype=torch.int32, device=a.device)
    hs.launch(
        wgmma_tile, "iscc_wgmma_tile", a.device, a_image.data_ptr(), a_image.numel(), a_lbo, a_sbo,
        b_image.data_ptr(), b_image.numel(), b_lbo, b_sbo, kbytes // KSTEP_BYTES, out.data_ptr(),
    )
    return out


wgmma_tile.launches = 0
