"""
The int4 ±1 layout probe (port of ``benchmarks/exp_int4.py``; kernel
``csrc/int4_dot.cu``: ``mma.sync.m16n8k32`` s8 on nibbles shifted into
int8, since the card's tensor cores have no 4-bit mode).

Two questions, as in the script: does a dot of an int4 twin (half the bytes
of the int8 twin) run on the card and match the int8 dot exactly, and at
what streaming rate does a kernel read it?

- :func:`int4_dot`: the full (Q, N) int32 dot of two int4 twins, the
  counterpart of the script's XLA ``dot4`` (PyTorch has no int4 product);
- :func:`int4_probe`: the script's Pallas probe, (Q, N / 128) float32 where
  column ``i * 128 + j`` is the dot of row ``i * 16384 + j``, j < 128. Every
  row of every 16,384-row chunk is dotted; 128 of each chunk are stored.

The twins are :func:`~iscc_search_tpu_torch.ops.bitplane.build_int4_twin`
of (·, 256) int8 ±1 rows: (·, 128) uint8. ``main()`` checks both against
the int8 rows' dot (the script's reference) and times them; the library
yardstick (``torch._int_mm`` on the int8 form) is timed by ``chip_smoke.py``,
not here.

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_int4 [--n ROWS]``
"""

from __future__ import annotations

import functools

import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.bitplane import build_int4_twin, unpack_int4

NBITS = 256
Q = 8
CHUNK = 16384
BLOCK = 128
PLAIN_STEP_ROWS = 65536  # rows per step of the plain versions (bounds their memory)


def _check_int4(q4, db4, multiple):
    # type: (torch.Tensor, torch.Tensor, int) -> tuple[int, int]
    hs._check(q4, "q4", torch.uint8, 2)
    hs._check(db4, "db4", torch.uint8, 2)
    n = db4.shape[0]
    aligned = db4.data_ptr() % 16 == 0 and q4.data_ptr() % 16 == 0
    if q4.shape[1] != NBITS // 2 or db4.shape[1] != NBITS // 2 or n % multiple or not aligned:
        raise ValueError(
            f"need (Q, {NBITS // 2}) and (N, {NBITS // 2}) uint8 int4 twins, N % {multiple} == 0 and "
            f"16-byte aligned rows, got {tuple(q4.shape)} and {tuple(db4.shape)}"
        )
    return q4.shape[0], n


def int4_dot_plain(q4, db4):
    # type: (torch.Tensor, torch.Tensor) -> torch.Tensor
    """Plain version of :func:`int4_dot`: unpacked to f32 (exact: |dot| <=
    256 * 64), matmul in row steps."""
    nq, n = _check_int4(q4, db4, BLOCK)
    qf = unpack_int4(q4).float()
    out = torch.empty((nq, n), dtype=torch.int32, device=db4.device)
    for s in range(0, n, PLAIN_STEP_ROWS):
        out[:, s : s + PLAIN_STEP_ROWS] = (qf @ unpack_int4(db4[s : s + PLAIN_STEP_ROWS]).float().T).to(torch.int32)
    return out


def int4_dot(q4, db4):
    # type: (torch.Tensor, torch.Tensor) -> torch.Tensor
    """
    (Q, N) int32 dots of int4 twins: the plain version for CPU tensors, the
    ``iscc_int4_dot`` kernel for CUDA tensors (``int4_dot.launches``).

    :param q4: (Q, 128) uint8 int4 twin of the queries
    :param db4: (N, 128) uint8 int4 twin of the rows, N % 128 == 0
    """
    nq, n = _check_int4(q4, db4, BLOCK)
    if hs._route([q4, db4]) == "cpu":
        return int4_dot_plain(q4, db4)
    out = torch.empty((nq, n), dtype=torch.int32, device=db4.device)
    hs.launch(int4_dot, "iscc_int4_dot", db4.device, q4.data_ptr(), nq, db4.data_ptr(), n, out.data_ptr())
    return out


int4_dot.launches = 0


def probe_rows(n, chunk=CHUNK, device=None):
    # type: (int, int, torch.device) -> torch.Tensor
    """The rows the probe stores: ``i * chunk + j``, j < 128, in column order."""
    starts = torch.arange(0, n, chunk, device=device)
    return (starts[:, None] + torch.arange(BLOCK, device=device)).reshape(-1)


def int4_probe_plain(q4, db4, chunk=CHUNK):
    # type: (torch.Tensor, torch.Tensor, int) -> torch.Tensor
    """Plain version of :func:`int4_probe`: only the stored rows' dots."""
    _check_int4(q4, db4, chunk)
    rows = db4[probe_rows(db4.shape[0], chunk, db4.device)]
    return unpack_int4(q4).float() @ unpack_int4(rows).float().T


def int4_probe(q4, db4, chunk=CHUNK):
    # type: (torch.Tensor, torch.Tensor, int) -> torch.Tensor
    """
    The Pallas probe's output: (Q, N / chunk * 128) float32 (N / 128
    columns at the script's chunk), column ``i * 128 + j`` = dot of row
    ``i * chunk + j``; the kernel dots every row (``int4_probe.launches``).
    N % chunk == 0, chunk % 128 == 0.
    """
    if chunk <= 0 or chunk % BLOCK:
        raise ValueError(f"chunk must be a positive multiple of {BLOCK}, got {chunk}")
    nq, n = _check_int4(q4, db4, chunk)
    if hs._route([q4, db4]) == "cpu":
        return int4_probe_plain(q4, db4, chunk)
    out = torch.empty((nq, n // chunk * BLOCK), dtype=torch.float32, device=db4.device)
    hs.launch(int4_probe, "iscc_int4_probe", db4.device, q4.data_ptr(), nq, db4.data_ptr(), n, chunk, out.data_ptr())
    return out


int4_probe.launches = 0


def int8_reference_dot(q_i8, db_i8):
    # type: (torch.Tensor, torch.Tensor) -> torch.Tensor
    """(Q, N) int32 dot of the int8 rows (the script's reference, :60), f32
    matmul in row steps (exact: |dot| <= 256 * 128 * 128 < 2**24)."""
    out = torch.empty((q_i8.shape[0], db_i8.shape[0]), dtype=torch.int32, device=db_i8.device)
    for s in range(0, db_i8.shape[0], PLAIN_STEP_ROWS):
        out[:, s : s + PLAIN_STEP_ROWS] = (q_i8.float() @ db_i8[s : s + PLAIN_STEP_ROWS].float().T).to(torch.int32)
    return out


def main(argv=None):
    args = ex.parser(__doc__, n=1024 * 1024, q=Q).parse_args(argv)
    dev = ex.device_of(args.device)
    n, nq = args.n, args.q
    gen = torch.Generator(device=dev).manual_seed(0)
    db_i8 = (torch.randint(0, 2, (n, NBITS), dtype=torch.int8, device=dev, generator=gen) * 2 - 1).to(torch.int8)
    q_i8 = db_i8[:nq].clone()
    db4, q4 = build_int4_twin(db_i8), build_int4_twin(q_i8)
    print(f"device {ex.device_name(dev)}: int4 twin {db4.numel()} bytes (int8 {db_i8.numel()}), N={n} Q={nq}")
    ref = int8_reference_dot(q_i8, db_i8)
    out4 = int4_dot(q4, db4)
    ms = ex.time_ms(functools.partial(int4_dot, q4, db4), dev, args.reps)
    print(f"int4 dot kernel: exact={bool(torch.equal(out4, ref))}, {ms:.4f} ms, {db4.numel() / ms / 1e6:.0f} GB/s effective")
    probe = int4_probe(q4, db4)
    want = ref[:, probe_rows(n, CHUNK, dev)].float()
    ms_p = ex.time_ms(functools.partial(int4_probe, q4, db4), dev, args.reps)
    print(f"int4 probe kernel: exact={bool(torch.equal(probe, want))}, {ms_p:.4f} ms, "
          f"{db4.numel() / ms_p / 1e6:.0f} GB/s streaming")
    return {"int4_dot": ms, "int4_probe": ms_p}


if __name__ == "__main__":
    main()
