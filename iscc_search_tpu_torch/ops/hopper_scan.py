"""
Exact two-phase NPHD top-k over one code-length partition, through
hand-written Hopper kernels (port of the Pallas path of
``iscc_search_tpu/ops/pallas_scan.py``).

- :func:`blockmax` (phase 1, XOR + popc, ``csrc/blockmax.cu``) replaces the
  Pallas kernels ``_scan_kernel_bitplane`` and ``_scan_kernel_unpacked_perm``.
- :func:`blockmax_mma_unpacked` (phase 1 on the int8 tensor cores, ``wgmma``
  from the ±1 int8 twin of :func:`build_unpacked_db`,
  ``csrc/blockmax_mma.cu``; its shared-memory layout is mirrored in
  ``ops/wgmma_layout.py``) replaces ``_scan_kernel_unpacked``.
- :func:`blockmax_mma_packed` (the same kernel, rows unpacked from the
  packed partition inside it) replaces ``_scan_kernel_packed`` and
  ``_scan_kernel_packed_perm``.
- :func:`blockmax_small` (phase 1 for small batches on the int8 tensor
  cores, each row's bits unpacked in registers into the A operand of
  ``mma.sync`` up to 32 queries and of ``wgmma`` above, rows streamed by TMA
  bulk copies, ``csrc/blockmax_small.cu``; its fragment maps are mirrored in
  ``ops/small_layout.py``) computes what :func:`blockmax` computes, and so
  replaces the same two Pallas kernels where the batch is small.
- :func:`gather_rescore` (phase 3, ``csrc/gather_rescore.cu``) replaces
  ``_gather_rescore_kernel`` and ``_gather_rescore_packed_kernel``: it reads
  the packed rows, and returns the candidates in row order. It has two
  forms, chosen by candidate reuse (:func:`gather_form`): query-major, one
  thread block per (query, candidate block), and block-major, which sorts
  the pairs by block on the card and reads each chosen block once for all
  the queries that chose it (its flow is mirrored in ``ops/gather_layout.py``).
- :func:`select_rescore_topk` (phases 2-3 in one launch,
  ``csrc/select_rescore.cu``) replaces no Pallas kernel: it does the work of
  the chain of PyTorch calls around :func:`gather_rescore` (phase 2's
  ``topk_blocks_hier``, the candidate rows and validity, the score epilogue,
  ``torch.topk``; :func:`select_rescore_topk_plain`) where a query's
  candidate rows fit its shared memory, and :func:`blockmax_topk_impl`
  takes it there (:func:`scan_route`).

The four phase-1 wrappers compute one function, bit for bit, and
:func:`blockmax_topk_impl` takes any of them by name (``phase1``, a key of
:data:`PHASE1`); which one is fastest depends on the batch and the width,
and the engine chooses (``scan_kernel`` of ``engine/device_index.py``). The packed
partition ``(cap, lanes)`` int32 is the resting layout; the TPU engine's
bit-transposed and permuted twins existed for its matrix unit and tiling
and are not ported. Validity reaches phase 1 as a ``(cap,)`` uint8 mask in
original row order.

Each wrapper checks device, dtype, shape and contiguity, then takes its
plain PyTorch version (``*_plain``) for tensors on the CPU and launches its
kernel on the current stream for CUDA tensors. Any other device raises, and
so does a launch the card refuses: there is no fallback from a CUDA tensor
to the plain version. ``<wrapper>.launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from iscc_search_tpu_torch.ops import _build, gather_layout
from iscc_search_tpu_torch.ops.packing import MAX_LANES
from iscc_search_tpu_torch.ops.pm1_scan import (
    NEG_SCORE,
    masked_queries,
    query_prefix,
    segmented_unpack_dots,
    topk_blocks_hier,
    unpack_pm1,
)

BLOCK = 128  # rows per block-max cell
PLAIN_CHUNK_ROWS = 65536  # rows per step of the plain phase 1 (bounds its memory)
UNPACK_CHUNK_ROWS = 65536  # rows per step of build_unpacked_db (bounds its memory)
PHASE3_BUDGET_BYTES = 1 << 30  # working set of one step of phases 2-3 (bounds their memory at large k)
# Working bytes per candidate row in phases 2-3: row id (8), validity (2),
# dot (4), score temporaries (12), the hierarchical top-k's gathered block
# maxima (4, at most) and top-k outputs (2, amortized). The block-major
# gather's workspace (12 bytes per candidate block, under 0.1 per row, and 4
# per block of the partition: 3.5 MB at 100M rows) is not counted.
PHASE3_ROW_BYTES = 32
# gather_rescore's form by candidate reuse r = Q * kk / (cap / 128), the
# (query, candidate block) pairs per block of the partition: block-major from
# GATHER_BLOCK_REUSE[lanes] on, query-major below. Below a reuse of ~1 the
# block-major form pays its inversion and gains nothing; on the [gather]
# ladder of chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
# 6) the two forms cross between a reuse of 0.9 and 2.7 at every width (at
# 1.8 the faster is at most 1.06x ahead), so one threshold serves all
# widths. The sweep fails when the table goes stale.
GATHER_BLOCK_REUSE = {lanes: 2.0 for lanes in range(1, MAX_LANES + 1)}
GATHER_FORMS = ("query", "block")
# Phases 2-3 of a scan in one launch (select_rescore_topk) where a query's
# kk * 128 candidate rows fit the kernel's shared memory: their 4-byte keys
# in a static array of 8,192 (32 KB), beside the per-warp bin counts (8 KB),
# within the 48 KB a thread block takes without opting in; so kk <= 64.
# Larger kk takes the chain of PyTorch calls (select_rescore_topk_plain).
FUSED_MAX_CANDIDATES = 8192
SCAN_ROUTES = ("fused", "chain")

_P = ctypes.c_void_p
_I = ctypes.c_int
# q, q_stride, min_lanes, q_scale, nq, db, valid, nblocks, lanes, out, stream
_PHASE1 = (_P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P)
_SIGNATURES = {
    "iscc_blockmax": _PHASE1,
    "iscc_blockmax_mma_unpacked": _PHASE1,
    "iscc_blockmax_mma_packed": _PHASE1,
    "iscc_blockmax_small": _PHASE1,
    # q, q_stride, min_lanes, block_ids, nq, kk, db, lanes, out, stream
    "iscc_gather_rescore": (_P, _I, _P, _P, _I, _I, _P, _I, _P, _P),
    # q, q_stride, min_lanes, block_ids, nq, kk, db, nblocks, lanes, workspace, words, out, stream
    "iscc_gather_rescore_blocks": (_P, _I, _P, _P, _I, _I, _P, _I, _I, _P, ctypes.c_longlong, _P, _P),
    # q, q_stride, min_lanes, q_scale, block_max, nq, nblocks, kk, out_k, db, valid, lanes, scores, rows, stream
    "iscc_select_rescore": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P),
    # The phase-1 experiments (iscc_search_tpu_torch/experiments):
    # epi, q, q_scale, nq, db, pen, nrows, db_wrap, out, stream
    "iscc_blockmax_variant": (_I, _P, _P, _I, _P, _P, _I, _I, _P, _P),
    # counts (2 x uint64, host), stream
    "iscc_blockmax_variant_paths": (_P, _P),
    # q, nq, db, nrows, out, stream / q, nq, db, nrows, chunk, out, stream
    "iscc_int4_dot": (_P, _I, _P, _I, _P, _P),
    "iscc_int4_probe": (_P, _I, _P, _I, _I, _P, _P),
    # q, q_scale, nq, twin, pen, nrows, out, stream / ... width_bits, out, stream
    "iscc_blockmax_bitplane": (_P, _P, _I, _P, _P, _I, _P, _P),
    "iscc_blockmax_bitplane_paths": (_P, _P),
    "iscc_blockmax_subword": (_P, _P, _I, _P, _P, _I, _I, _P, _P),
    # The bare wgmma tile of ops/wgmma_layout.py:
    # a_image, a_bytes, a_lbo, a_sbo, b_image, b_bytes, b_lbo, b_sbo, ksteps, out, stream
    "iscc_wgmma_tile": (_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P),
}


def _entry(name):
    # type: (str) -> ctypes._CFuncPtr
    fn = getattr(_build.library(), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def launch(wrapper, entry, device, *args):
    # type: (...) -> None
    """Launch C entry ``entry`` with ``args`` on ``device``'s current stream
    (appended as the last argument), raise if the card refuses the launch,
    else count it on ``wrapper.launches``."""
    with torch.cuda.device(device):
        err = _entry(entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: cudaError {err}")
    wrapper.launches += 1


def _check(t, name, dtype, ndim):
    # type: (torch.Tensor, str, torch.dtype, int) -> None
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {ndim}-d {dtype} tensor, got {t.dtype} "
            f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _route(tensors):
    # type: (list[torch.Tensor]) -> str
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device type {kind!r}: inputs must be on the CPU or a CUDA device")
    return kind


def _check_queries(q_packed, min_lanes, lanes):
    _check(q_packed, "q_packed", torch.int32, 2)
    _check(min_lanes, "min_lanes", torch.int32, 1)
    if q_packed.shape[1] < lanes or min_lanes.shape[0] != q_packed.shape[0]:
        raise ValueError(
            f"q_packed {tuple(q_packed.shape)} / min_lanes {tuple(min_lanes.shape)} "
            f"do not fit a {lanes}-lane partition"
        )


def _check_db(db):
    _check(db, "db", torch.int32, 2)
    cap, lanes = db.shape
    if cap % BLOCK or not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"db must be (cap, lanes) with cap % {BLOCK} == 0 and 1 <= lanes <= {MAX_LANES}, got {tuple(db.shape)}")
    return cap, lanes


# ----------------------------------------------------------------- phase 1


def build_unpacked_db(db_packed, nbits):
    # type: (torch.Tensor, int) -> torch.Tensor
    """
    The ±1 int8 twin of a packed partition (``build_unpacked_db`` of the
    JAX package with ``permute=False``), built in row chunks of
    ``UNPACK_CHUNK_ROWS`` on ``db_packed``'s device with plain torch ops.

    :param db_packed: (cap, >= nbits // 32) int32 packed rows
    :return: (cap, nbits) int8, column c = bit c of the row in
        :func:`unpack_pm1` order (+1 set, -1 clear)
    """
    cap = db_packed.shape[0]
    out = torch.empty((cap, nbits), dtype=torch.int8, device=db_packed.device)
    for s in range(0, cap, UNPACK_CHUNK_ROWS):
        out[s : s + UNPACK_CHUNK_ROWS] = unpack_pm1(db_packed[s : s + UNPACK_CHUNK_ROWS], nbits).to(torch.int8)
    return out


def fma_score(m, qs):
    # type: (torch.Tensor, torch.Tensor) -> torch.Tensor
    """``0.5 + m * qs`` rounded once to float32 (the float64 product and sum
    are exact), as the kernels' ``__fmaf_rn`` and the JAX phase-1 kernels
    round it; ``qs`` broadcasts against ``m``."""
    return (0.5 + m.double() * qs.double()).float()


def _blockmax_rows_plain(q_packed, min_lanes, q_scale, valid, nbits, rows_pm1):
    # type: (...) -> torch.Tensor
    """Plain phase 1 over ``rows_pm1(s, e)``, the (e - s, nbits) f32 ±1
    rows [s, e): f32 matmul (exact for integer dots of at most 256 terms),
    additive -65536 penalty on invalid rows, 128-row max, then
    :func:`fma_score`. Row chunks bound the memory."""
    cap = valid.shape[0]
    q_pm1 = masked_queries(q_packed, min_lanes, nbits)
    pen = torch.where(valid.to(torch.bool), 0.0, -65536.0)
    out = torch.empty((q_packed.shape[0], cap // BLOCK), dtype=torch.float32, device=valid.device)
    for s in range(0, cap, PLAIN_CHUNK_ROWS):
        e = min(cap, s + PLAIN_CHUNK_ROWS)
        dot = q_pm1 @ rows_pm1(s, e).T + pen[None, s:e]
        m = dot.reshape(dot.shape[0], (e - s) // BLOCK, BLOCK).amax(dim=2)
        out[:, s // BLOCK : e // BLOCK] = fma_score(m, q_scale[:, None])
    return out


def blockmax_plain(q_packed, min_lanes, q_scale, db, valid):
    # type: (...) -> torch.Tensor
    """Plain PyTorch phase 1 from the packed rows (unpacked to ±1 f32), the
    plain version of :func:`blockmax`, :func:`blockmax_mma_packed` and
    :func:`blockmax_small`."""
    nbits = db.shape[1] * 32
    return _blockmax_rows_plain(q_packed, min_lanes, q_scale, valid, nbits, lambda s, e: unpack_pm1(db[s:e], nbits))


def blockmax_unpacked_plain(q_packed, min_lanes, q_scale, db_unpacked, valid):
    # type: (...) -> torch.Tensor
    """Plain PyTorch phase 1 from the ±1 int8 twin (as f32), the plain
    version of :func:`blockmax_mma_unpacked`."""
    return _blockmax_rows_plain(
        q_packed, min_lanes, q_scale, valid, db_unpacked.shape[1], lambda s, e: db_unpacked[s:e].float()
    )


def _phase1(wrapper, entry, plain, q_packed, min_lanes, q_scale, db, valid, lanes):
    # type: (...) -> torch.Tensor
    """Shared checks, routing and launch of the phase-1 wrappers: ``plain``
    on the CPU, the C entry ``entry`` on CUDA (counted on ``wrapper``)."""
    cap = db.shape[0]
    _check_queries(q_packed, min_lanes, lanes)
    _check(q_scale, "q_scale", torch.float32, 1)
    _check(valid, "valid", torch.uint8, 1)
    if q_scale.shape[0] != q_packed.shape[0] or valid.shape[0] != cap:
        raise ValueError("q_scale must be (Q,) and valid (cap,)")
    if _route([q_packed, min_lanes, q_scale, db, valid]) == "cpu":
        return plain(q_packed, min_lanes, q_scale, db, valid)
    nq = q_packed.shape[0]
    out = torch.empty((nq, cap // BLOCK), dtype=torch.float32, device=db.device)
    launch(
        wrapper, entry, db.device, q_packed.data_ptr(), q_packed.stride(0), min_lanes.data_ptr(),
        q_scale.data_ptr(), nq, db.data_ptr(), valid.data_ptr(), cap // BLOCK, lanes, out.data_ptr(),
    )
    return out


def blockmax(q_packed, min_lanes, q_scale, db, valid):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """
    Phase-1 block maxima of one partition (XOR + popc kernel).

    :param q_packed: (Q, >= lanes) int32 packed queries
    :param min_lanes: (Q,) int32 common-prefix lanes, <= lanes
    :param q_scale: (Q,) float32 ``1 / (2 * 32 * min_lanes)`` (see query_prefix)
    :param db: (cap, lanes) int32 packed partition, cap % 128 == 0
    :param valid: (cap,) uint8 validity, original row order
    :return: (Q, cap // 128) float32: block b holds the max over valid rows
        [128b, 128b+128) of ``0.5 + dot * q_scale``; a block with no valid
        row lies below NEG_SCORE
    """
    _, lanes = _check_db(db)
    return _phase1(blockmax, "iscc_blockmax", blockmax_plain, q_packed, min_lanes, q_scale, db, valid, lanes)


blockmax.launches = 0


def blockmax_mma_packed(q_packed, min_lanes, q_scale, db, valid):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """:func:`blockmax` on the int8 tensor cores, the packed rows unpacked
    to ±1 int8 inside the kernel. Same arguments, same result bit for bit."""
    _, lanes = _check_db(db)
    return _phase1(
        blockmax_mma_packed, "iscc_blockmax_mma_packed", blockmax_plain, q_packed, min_lanes, q_scale, db, valid, lanes
    )


blockmax_mma_packed.launches = 0


def blockmax_small(q_packed, min_lanes, q_scale, db, valid):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """:func:`blockmax` on the int8 tensor cores for small batches (A from
    registers, chunks of up to 128 queries). Same arguments, same result
    bit for bit; on CUDA, ``db`` and ``valid`` must be 16-byte aligned (the
    kernel copies whole blocks with the TMA)."""
    _, lanes = _check_db(db)
    if db.is_cuda and (db.data_ptr() % 16 or valid.data_ptr() % 16):
        raise ValueError("blockmax_small copies whole blocks with the TMA: db and valid must be 16-byte aligned")
    return _phase1(blockmax_small, "iscc_blockmax_small", blockmax_plain, q_packed, min_lanes, q_scale, db, valid, lanes)


blockmax_small.launches = 0


def blockmax_mma_unpacked(q_packed, min_lanes, q_scale, db_unpacked, valid):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor) -> torch.Tensor
    """:func:`blockmax` on the int8 tensor cores from the ±1 int8 twin.

    :param db_unpacked: (cap, nbits) int8 ±1 twin (:func:`build_unpacked_db`),
        cap % 128 == 0, nbits a multiple of 32 up to 256, 16-byte aligned
    :return: as :func:`blockmax` on the packed rows the twin was built from
    """
    _check(db_unpacked, "db_unpacked", torch.int8, 2)
    cap, nbits = db_unpacked.shape
    if cap % BLOCK or nbits % 32 or not 32 <= nbits <= 32 * MAX_LANES or db_unpacked.data_ptr() % 16:
        raise ValueError(
            f"db_unpacked must be a 16-byte aligned (cap, nbits) twin with cap % {BLOCK} == 0 and "
            f"nbits in 32..{32 * MAX_LANES} a multiple of 32, got {tuple(db_unpacked.shape)}"
        )
    return _phase1(
        blockmax_mma_unpacked, "iscc_blockmax_mma_unpacked", blockmax_unpacked_plain,
        q_packed, min_lanes, q_scale, db_unpacked, valid, nbits // 32,
    )


blockmax_mma_unpacked.launches = 0

# The phase-1 formulations blockmax_topk_impl chooses from, by name.
PHASE1 = {"popc": blockmax, "mma": blockmax_mma_packed, "mma_small": blockmax_small, "mma_twin": blockmax_mma_unpacked}


# ----------------------------------------------------------------- phase 3


def gather_rescore_plain(q_packed, min_lanes, block_ids, db):
    # type: (...) -> torch.Tensor
    """Plain PyTorch phase 3: gather the candidate rows, unpack, f32 dots."""
    q, kk = block_ids.shape
    nbits = db.shape[1] * 32
    offsets = torch.arange(BLOCK, device=db.device)
    rows = (block_ids.to(torch.int64)[:, :, None] * BLOCK + offsets).reshape(q, kk * BLOCK)
    return segmented_unpack_dots(masked_queries(q_packed, min_lanes, nbits), db, rows, nbits)


def gather_form(nq, kk, nblocks, lanes):
    # type: (int, int, int, int) -> str
    """The form :func:`gather_rescore` takes for ``nq`` queries of ``kk``
    candidate blocks each over a partition of ``nblocks`` 128-row blocks and
    ``lanes`` lanes: ``"block"`` where the reuse ``nq * kk / nblocks``
    reaches ``GATHER_BLOCK_REUSE[lanes]``, else ``"query"``."""
    return "block" if nq * kk >= GATHER_BLOCK_REUSE[lanes] * nblocks else "query"


def gather_rescore(q_packed, min_lanes, block_ids, db, form=None):
    # type: (torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, str | None) -> torch.Tensor
    """
    Phase-3 exact rescore of each query's candidate blocks.

    :param q_packed: (Q, >= lanes) int32 packed queries
    :param min_lanes: (Q,) int32 common-prefix lanes, <= lanes
    :param block_ids: (Q, kk) int32 candidate block ids, each < cap // 128;
        they may repeat within a query
    :param db: (cap, lanes) int32 packed partition
    :param form: ``None`` (the form :func:`gather_form` names), ``"query"``
        or ``"block"``; on CPU tensors every form is the plain version
    :return: (Q, kk * 128) float32 raw ±1 dots; column c belongs to row
        ``block_ids[q, c // 128] * 128 + c % 128``
    """
    cap, lanes = _check_db(db)
    _check_queries(q_packed, min_lanes, lanes)
    _check(block_ids, "block_ids", torch.int32, 2)
    if block_ids.shape[0] != q_packed.shape[0]:
        raise ValueError("block_ids must be (Q, kk)")
    if form is not None and form not in GATHER_FORMS:
        raise ValueError(f"form must be None or one of {GATHER_FORMS}, got {form!r}")
    if _route([q_packed, min_lanes, block_ids, db]) == "cpu":
        return gather_rescore_plain(q_packed, min_lanes, block_ids, db)
    nq, kk = block_ids.shape
    nblocks = cap // BLOCK
    form = form or gather_form(nq, kk, nblocks, lanes)
    out = torch.empty((nq, kk * BLOCK), dtype=torch.float32, device=db.device)
    args = (q_packed.data_ptr(), q_packed.stride(0), min_lanes.data_ptr(), block_ids.data_ptr(), nq, kk, db.data_ptr())
    if form == "query":
        launch(gather_rescore, "iscc_gather_rescore", db.device, *args, lanes, out.data_ptr())
    else:
        ws = torch.empty(gather_layout.workspace_words(nq * kk, nblocks), dtype=torch.int32, device=db.device)
        launch(gather_rescore, "iscc_gather_rescore_blocks", db.device, *args, nblocks, lanes, ws.data_ptr(),
               ws.numel(), out.data_ptr())
    gather_rescore.by_form[form] += 1
    return out


gather_rescore.launches = 0
gather_rescore.by_form = dict.fromkeys(GATHER_FORMS, 0)  # calls that reached the card, by form


# ------------------------------------------------------- exact two-phase top-k


def blockmax_topk_impl(
    q_packed, min_lanes, q_scale, db_packed, db_valid, k, db_unpacked=None, unpacked=False, phase1="popc"
):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """
    Exact top-k of one partition: phase 1 block maxima -> hierarchical top-k
    blocks -> phase 3 gather rescore -> final top-k (contract of
    ``pallas_blockmax_topk_impl``). Phases 2-3 take the route
    :func:`scan_route` names: one launch of :func:`select_rescore_topk`, or
    the chain :func:`select_rescore_topk_plain` (counted on
    ``select_rescore_topk.by_route``).

    :param db_packed: (cap, lanes) int32 packed partition
    :param db_valid: (cap,) uint8 validity
    :param db_unpacked: optional (cap, nbits) int8 ±1 twin of ``db_packed``
        (:func:`build_unpacked_db`)
    :param unpacked: the JAX contract's name for ``phase1="mma_twin"``
    :param phase1: the phase-1 formulation, a key of :data:`PHASE1`:
        ``"popc"`` (:func:`blockmax`), ``"mma"`` (:func:`blockmax_mma_packed`,
        the tensor cores from the packed rows), ``"mma_small"``
        (:func:`blockmax_small`, the small-batch tensor-core kernel) or ``"mma_twin"``
        (:func:`blockmax_mma_unpacked`, the tensor cores from ``db_unpacked``).
        The block maxima are the same bit for bit, and phase 3 reads the
        packed rows whichever is taken.
    :return: (scores (Q, k) float32 desc, rows (Q, k) int32, -1 and NEG_SCORE
        where fewer than k valid rows exist)
    """
    if unpacked:
        phase1 = "mma_twin"
    if phase1 not in PHASE1:
        raise ValueError(f"phase1 must be one of {sorted(PHASE1)}, got {phase1!r}")
    if phase1 == "mma_twin" and db_unpacked is None:
        raise ValueError("unpacked=True requires db_unpacked")
    q = q_packed.shape[0]
    total_blocks = db_packed.shape[0] // BLOCK
    db = db_unpacked if phase1 == "mma_twin" else db_packed
    block_max = PHASE1[phase1](q_packed, min_lanes, q_scale, db, db_valid)
    kk = min(k, total_blocks)
    out_k = min(k, kk * BLOCK)
    # Phases 2 and 3: one launch where the route is "fused". The chain holds
    # (Q, kk * 128) candidates: it runs over slices of the queries that fit
    # PHASE3_BUDGET_BYTES. Each query's candidates are its own, so the scores
    # do not depend on the slicing. Which rows tied at the cut are kept
    # follows torch.topk there, whose CUDA algorithm (and with it the tie
    # order) is chosen by shape, the number of queries included.
    route = scan_route(db_packed.device, k, db_packed.shape[0])
    select_rescore_topk.by_route[route] += 1
    if route == "fused":
        fs, fi = select_rescore_topk(q_packed, min_lanes, q_scale, block_max, db_packed, db_valid, kk, out_k)
    else:
        step = max(1, PHASE3_BUDGET_BYTES // (kk * BLOCK * PHASE3_ROW_BYTES))
        parts = [
            select_rescore_topk_plain(q_packed[s : s + step], min_lanes[s : s + step], q_scale[s : s + step],
                                      block_max[s : s + step], db_packed, db_valid, kk, out_k)
            for s in range(0, q, step)
        ]
        fs, fi = (torch.cat(column) for column in zip(*parts))
    if out_k < k:
        fs = torch.nn.functional.pad(fs, (0, k - out_k), value=NEG_SCORE)
        fi = torch.nn.functional.pad(fi, (0, k - out_k), value=-1)
    return fs, fi


def scan_route(device, k, cap):
    # type: (torch.device, int, int) -> str
    """The route of phases 2-3 of a top-``k`` scan of a ``cap``-row
    partition on ``device``: ``"fused"`` (:func:`select_rescore_topk`) on a
    CUDA device where the kk = min(k, cap // 128) candidate blocks' rows,
    at least one block, fit ``FUSED_MAX_CANDIDATES``, else ``"chain"``
    (:func:`select_rescore_topk_plain`, on the CPU always)."""
    kk = min(k, cap // BLOCK)
    return "fused" if device.type == "cuda" and 0 < kk * BLOCK <= FUSED_MAX_CANDIDATES else "chain"


def select_rescore_topk_plain(q_packed, min_lanes, q_scale, block_max, db_packed, db_valid, kk, out_k):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """Phases 2 and 3 for a slice of the queries, as a chain of PyTorch
    calls around :func:`gather_rescore`: the top-``kk`` blocks, the exact
    rescore of their rows and the top-``out_k``. The candidate blocks are
    rescored in steps that fit PHASE3_BUDGET_BYTES; a step's top-k is merged
    into the best so far (one step, and so the plain top-k, unless a single
    query's candidates exceed the budget). The plain version of
    :func:`select_rescore_topk`."""
    q = q_packed.shape[0]
    total_blocks = db_packed.shape[0] // BLOCK
    top_blocks = topk_blocks_hier(block_max, kk)  # (q, kk) int64
    offsets = torch.arange(BLOCK, device=db_packed.device)
    seg = max(1, PHASE3_BUDGET_BYTES // (q * BLOCK * PHASE3_ROW_BYTES))
    best = None
    for c in range(0, kk, seg):
        blocks = top_blocks[:, c : c + seg].contiguous()
        width = blocks.shape[1] * BLOCK
        rows = (blocks[:, :, None] * BLOCK + offsets).reshape(q, width)
        cand_valid = db_valid.reshape(total_blocks, BLOCK)[blocks].reshape(q, width)
        dots = gather_rescore(q_packed, min_lanes, blocks.to(torch.int32), db_packed)
        # Product and sum rounded separately, as the JAX phase 3 rounds them
        # (phase 1 rounds once; both are strictly increasing in the dot, so
        # the block cut stays exact).
        scores = 0.5 + dots * q_scale[:, None]
        scores = torch.where(cand_valid.to(torch.bool), scores, NEG_SCORE)
        s, pos = torch.topk(scores, min(out_k, width), dim=1)
        r = torch.gather(rows, 1, pos)
        if best is not None:
            s, pos = torch.topk(torch.cat([best[0], s], dim=1), min(out_k, best[0].shape[1] + s.shape[1]), dim=1)
            r = torch.gather(torch.cat([best[1], r], dim=1), 1, pos)
        best = (s, r)
    fs, rows = best
    return fs, torch.where(fs > NEG_SCORE, rows, -1).to(torch.int32)


def select_rescore_topk(q_packed, min_lanes, q_scale, block_max, db_packed, db_valid, kk, out_k):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """
    Phases 2 and 3 of one partition's scan in one launch: each query's
    top-``kk`` blocks by their phase-1 maxima, the exact rescore of their
    rows and the top-``out_k`` rows (``csrc/select_rescore.cu``).

    :param block_max: (Q, cap // 128) float32 phase-1 maxima
    :param db_packed: (cap, lanes) int32 packed partition
    :param db_valid: (cap,) uint8 validity
    :param kk: candidate blocks a query, 1 <= kk <= cap // 128; on CUDA
        ``kk * 128 <= FUSED_MAX_CANDIDATES``
    :param out_k: rows kept a query, 1 <= out_k <= kk * 128
    :return: (scores (Q, out_k) float32 descending, rows (Q, out_k) int32,
        -1 where the score is NEG_SCORE): the contract of
        :func:`select_rescore_topk_plain`, whose scores it equals
        ``torch.equal``; of rows tied at a cut it may keep others
    """
    cap, lanes = _check_db(db_packed)
    _check_queries(q_packed, min_lanes, lanes)
    _check(q_scale, "q_scale", torch.float32, 1)
    _check(block_max, "block_max", torch.float32, 2)
    _check(db_valid, "db_valid", torch.uint8, 1)
    nq, nblocks = block_max.shape
    if q_scale.shape[0] != nq or nq != q_packed.shape[0] or nblocks != cap // BLOCK or db_valid.shape[0] != cap:
        raise ValueError("q_scale must be (Q,), block_max (Q, cap // 128) and db_valid (cap,)")
    if not (1 <= kk <= nblocks and 1 <= out_k <= kk * BLOCK):
        raise ValueError(f"need 1 <= kk <= {nblocks} and 1 <= out_k <= kk * {BLOCK}, got kk={kk}, out_k={out_k}")
    if _route([q_packed, min_lanes, q_scale, block_max, db_packed, db_valid]) == "cpu":
        return select_rescore_topk_plain(q_packed, min_lanes, q_scale, block_max, db_packed, db_valid, kk, out_k)
    if kk * BLOCK > FUSED_MAX_CANDIDATES or block_max.data_ptr() % 16:
        raise ValueError(f"the kernel takes kk * {BLOCK} <= {FUSED_MAX_CANDIDATES} and a 16-byte aligned block_max")
    scores = torch.empty((nq, out_k), dtype=torch.float32, device=db_packed.device)
    rows = torch.empty((nq, out_k), dtype=torch.int32, device=db_packed.device)
    launch(
        select_rescore_topk, "iscc_select_rescore", db_packed.device, q_packed.data_ptr(), q_packed.stride(0),
        min_lanes.data_ptr(), q_scale.data_ptr(), block_max.data_ptr(), nq, nblocks, kk, out_k,
        db_packed.data_ptr(), db_valid.data_ptr(), lanes, scores.data_ptr(), rows.data_ptr(),
    )
    return scores, rows


select_rescore_topk.launches = 0
select_rescore_topk.by_route = dict.fromkeys(SCAN_ROUTES, 0)  # blockmax_topk_impl's scans, by route


def blockmax_topk_packedq_impl(
    q_packed, q_lanes, db_packed, db_valid, k, nbits, db_unpacked=None, unpacked=False, phase1="popc"
):
    # type: (...) -> tuple[torch.Tensor, torch.Tensor]
    """Query prep (common-prefix lanes and scale) + :func:`blockmax_topk_impl`
    for packed queries — the engine's per-partition search step.

    :param q_packed: (Q, L) int32 packed queries, L >= nbits // 32
    :param q_lanes: (Q,) int32 query lane counts
    """
    if db_packed.shape[1] * 32 != nbits:
        raise ValueError(f"db_packed {tuple(db_packed.shape)} is not a {nbits}-bit partition")
    min_lanes, q_scale = query_prefix(q_lanes, nbits)
    return blockmax_topk_impl(
        q_packed, min_lanes, q_scale, db_packed, db_valid, k, db_unpacked=db_unpacked, unpacked=unpacked, phase1=phase1
    )
