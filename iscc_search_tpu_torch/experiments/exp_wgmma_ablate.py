"""
Where the time of ``csrc/blockmax_mma.cu`` goes: the kernel built with one
part left out at a time, and each build timed on the card.

The card's profilers with hardware counters do not run everywhere, and a
persistent ``wgmma`` kernel hides its parts from a timeline; leaving a part
out and timing the rest needs neither. The kernel's source takes a mask of
parts to leave out (``ISCC_ABLATE``, 0 in the port's library); each variant
here is the whole kernel library built with one mask
(``ops._build.build(defines=...)``, under a build key of its own) and called
through ``ctypes`` like the real one. **A variant's output is wrong on
purpose**; only its time means anything, and only beside ``base`` from the
same run:

- ``no_wgmma``: no ``wgmma`` is issued (the epilogue reads what the
  registers hold): what is left is everything but the tensor cores' work;
- ``no_epilogue``: the maxima loop stops after its first step;
- ``no_staging``: rows are brought into the row tile at a team's first
  block only;
- ``no_flush``: the gathered maxima are never written;
- ``fixed_only``: ``no_wgmma`` and ``no_epilogue``: a block's fixed work;
- ``wgmma_only``: ``no_epilogue``, ``no_staging`` and ``no_flush``.

Times are per Q-query sweep of one partition, with the clocks per 128-row
block per SM beside them (ms x SM clock / blocks per SM).

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_wgmma_ablate
[--twin] [--q 512] [variant ...]``
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import subprocess

import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.ops import _build
from iscc_search_tpu_torch.ops import hopper_scan as hs

# Rows per lane count of the timed partitions: four code lengths at sizes in
# the millions of rows, a multiple of 128 each.
CAPACITIES = {2: 3_014_656, 4: 2_949_120, 6: 1_245_184, 8: 4_718_592}
# The bits of ISCC_ABLATE (csrc/blockmax_mma.cu).
NO_WGMMA, NO_EPILOGUE, NO_STAGING, NO_FLUSH = 1, 2, 4, 8
VARIANTS = {
    "base": 0,
    "no_wgmma": NO_WGMMA,
    "no_epilogue": NO_EPILOGUE,
    "no_staging": NO_STAGING,
    "no_flush": NO_FLUSH,
    "fixed_only": NO_WGMMA | NO_EPILOGUE,
    "wgmma_only": NO_EPILOGUE | NO_STAGING | NO_FLUSH,
}


def defines_of(name):
    # type: (str) -> tuple[str, ...]
    """The build's ``-D`` macros for variant ``name``; none for ``base``,
    which is the port's own library."""
    return (f"ISCC_ABLATE={VARIANTS[name]}",) if VARIANTS[name] else ()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS), help=f"of {', '.join(VARIANTS)}")
    p.add_argument("--q", type=int, default=512, help="queries")
    p.add_argument("--reps", type=int, default=10, help="timed calls per variant and width")
    p.add_argument("--twin", action="store_true", help="the int8-twin entry instead of the packed-row entry")
    args = p.parse_args(argv)
    dev = ex.device_of("cuda")
    props = torch.cuda.get_device_properties(dev)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    entry = "iscc_blockmax_mma_unpacked" if args.twin else "iscc_blockmax_mma_packed"
    print(f"device {ex.device_name(dev)}, {props.multi_processor_count} SMs, maximum SM clock {mhz:.0f} MHz; "
          f"{entry}, Q={args.q}; every variant but base computes something else: only the times mean anything")
    with concurrent.futures.ThreadPoolExecutor() as pool:  # every variant's nvcc runs at once
        libs = dict(zip(args.variants, pool.map(lambda name: _build.build(defines_of(name)), args.variants)))
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes, fn.restype = hs._SIGNATURES[entry], ctypes.c_int
        res[name] = {}
        for lanes, cap in CAPACITIES.items():
            q = torch.randint(-(2**31), 2**31, (args.q, 8), dtype=torch.int32, device=dev, generator=gen)
            min_lanes = torch.full((args.q,), lanes, dtype=torch.int32, device=dev)
            q_scale = torch.full((args.q,), 1.0 / (64 * lanes), dtype=torch.float32, device=dev)
            db = torch.randint(-(2**31), 2**31, (cap, lanes), dtype=torch.int32, device=dev, generator=gen)
            if args.twin:
                db = hs.build_unpacked_db(db, lanes * 32)
            valid = (torch.rand(cap, device=dev, generator=gen) > 1 / 64).to(torch.uint8)
            out = torch.empty((args.q, cap // hs.BLOCK), dtype=torch.float32, device=dev)

            def call():
                err = fn(q.data_ptr(), q.stride(0), min_lanes.data_ptr(), q_scale.data_ptr(), args.q, db.data_ptr(),
                         valid.data_ptr(), cap // hs.BLOCK, lanes, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name!r}: launch failed, cudaError {err}")

            ms = ex.time_ms(call, dev, args.reps)
            blocks_per_sm = -(-(cap // hs.BLOCK) // props.multi_processor_count)
            res[name][lanes] = ms
            print(f"{name:12s} {lanes * 32:3d}-bit cap={cap}: {ms:.4f} ms, {ms * mhz * 1e3 / blocks_per_sm:.0f} clocks per block per SM")
            del db, out
    return res


if __name__ == "__main__":
    main()
