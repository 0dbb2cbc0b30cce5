"""
Where the time of ``csrc/blockmax_bitplane.cu`` goes, at each element width
of its one templated kernel (``--width``: 32 is ``iscc_blockmax_bitplane``,
TPU kernel 10; 16 and 8 are ``iscc_blockmax_subword``, TPU kernel 11): the
kernel built with parts left out, and each build timed on the card, in the
way of :mod:`.exp_variant_ablate`.

The source takes a mask of parts to leave out (``ISCC_BITPLANE_ABLATE``, 0
in the port's library); each variant here is that source alone built with
one mask (``ops._build.build(defines, names)``, under a build key of its
own) and called through ``ctypes`` like the real one. **A variant's output
is wrong on purpose**; only its time means anything, and only beside
``base`` from the same run:

- ``no_wgmma``: no ``wgmma`` is issued;
- ``no_epilogue``: no epilogue and no flush;
- ``no_staging``: the first slice lands by TMA and serves every slice;
- ``no_untranspose``: the producer reads no slice and writes no row tile
  (it still plans each block and signals its tile);
- ``wgmma_only``: ``no_epilogue``, ``no_staging`` and ``no_untranspose``:
  the ``wgmma`` loop and its barriers alone;
- ``stage_only``: ``no_wgmma`` and ``no_epilogue``: TMA staging and the
  un-transpose alone;
- ``general``: every block takes the per-element path.

Times are per launch at the script's size (1/64 rows tombstoned, 0 /
-65536 bf16 or 0 / -32768 int32 penalties; ``--general``: random penalties
within 400 of each other, which take the per-element path), with the clocks
per 128-row block per SM beside them.

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_bitplane_ablate
[--width 32|16|8] [--general] [--n N] [--q Q] [variant ...]``
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import subprocess

import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.experiments import exp_bitplane_int8 as e10
from iscc_search_tpu_torch.experiments import exp_bitplane_u8 as e11
from iscc_search_tpu_torch.ops import _build, bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, query_prefix

SOURCE = ("blockmax_bitplane.cu",)
WIDTHS = (32, 16, 8)
# The bits of ISCC_BITPLANE_ABLATE (csrc/blockmax_bitplane.cu).
NO_WGMMA, NO_EPILOGUE, NO_STAGING, NO_UNTRANSPOSE, GENERAL = 1, 2, 4, 8, 16
VARIANTS = {
    "base": 0,
    "no_wgmma": NO_WGMMA,
    "no_epilogue": NO_EPILOGUE,
    "no_staging": NO_STAGING,
    "no_untranspose": NO_UNTRANSPOSE,
    "wgmma_only": NO_EPILOGUE | NO_STAGING | NO_UNTRANSPOSE,
    "stage_only": NO_WGMMA | NO_EPILOGUE,
    "general": GENERAL,
}


def defines_of(name):
    # type: (str) -> tuple[str, ...]
    """The build's ``-D`` macros for variant ``name`` (none for ``base``)."""
    return (f"ISCC_BITPLANE_ABLATE={VARIANTS[name]}",) if VARIANTS[name] else ()


def entry_of(width):
    # type: (int) -> str
    """The C entry that launches the kernel at element width ``width``."""
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}, got {width}")
    return "iscc_blockmax_bitplane" if width == 32 else "iscc_blockmax_subword"


def inputs_of(width, packed, valid, general):
    # type: (int, torch.Tensor, torch.Tensor, bool) -> tuple[torch.Tensor, torch.Tensor, tuple[int, ...]]
    """(twin, penalty, the entry's arguments between the row count and the
    output) at element width ``width``."""
    if width == 32:
        return bitplane.bit_transpose_packed(packed), e10.bitplane_penalties(valid, general), ()
    return bitplane.build_twin(packed, width), e11.subword_penalty(valid, width, general), (width,)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS), help=f"of {', '.join(VARIANTS)}")
    p.add_argument("--n", type=lambda s: int(float(s)), default=8 * 1024 * 1024, help="database rows")
    p.add_argument("--q", type=int, default=256, help="queries")
    p.add_argument("--width", type=int, choices=WIDTHS, default=32, help="the twin's element width")
    p.add_argument("--general", action="store_true", help="penalties that take the per-element path")
    p.add_argument("--reps", type=int, default=10, help="timed calls per variant")
    args = p.parse_args(argv)
    dev = ex.device_of("cuda")
    props = torch.cuda.get_device_properties(dev)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    n, nq = args.n, args.q
    entry = entry_of(args.width)
    print(f"device {ex.device_name(dev)}, {props.multi_processor_count} SMs, maximum SM clock {mhz:.0f} MHz; "
          f"{entry}, W={args.width}, N={n}, Q={nq}, {'per-element' if args.general else 'tombstone'} penalties; "
          f"every variant but base computes something else: only the times mean anything")
    with concurrent.futures.ThreadPoolExecutor() as pool:  # every variant's nvcc runs at once
        libs = dict(zip(args.variants, pool.map(lambda v: _build.build(defines_of(v), SOURCE), args.variants)))
    gen = torch.Generator(device=dev).manual_seed(0)
    packed = torch.randint(-(2**31), 2**31, (n, e10.NBITS // 32), dtype=torch.int32, device=dev, generator=gen)
    valid = torch.ones(n, dtype=torch.uint8, device=dev)
    valid[torch.randint(0, n, (n // 64,), device=dev, generator=gen)] = 0
    min_lanes, q_scale = query_prefix(torch.full((nq,), e10.NBITS // 32, dtype=torch.int32, device=dev), e10.NBITS)
    q = masked_queries(packed[:: n // nq][:nq].contiguous(), min_lanes, e10.NBITS).to(torch.int8)
    twin, pen, extra = inputs_of(args.width, packed, valid, args.general)
    out = torch.empty((nq, n // hs.BLOCK), dtype=torch.float32, device=dev)
    blocks_per_sm = -(-(n // hs.BLOCK) // props.multi_processor_count)
    res = {}
    for variant, path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes, fn.restype = hs._SIGNATURES[entry], ctypes.c_int

        def call():
            err = fn(q.data_ptr(), q_scale.data_ptr(), nq, twin.data_ptr(), pen.data_ptr(), n, *extra, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {variant!r}: launch failed, cudaError {err}")

        res[variant] = ms = ex.time_ms(call, dev, args.reps)
        print(f"{variant:15s} {ms:.4f} ms, {ms * mhz * 1e3 / blocks_per_sm:.0f} clocks per block per SM", flush=True)
    return res


if __name__ == "__main__":
    main()
