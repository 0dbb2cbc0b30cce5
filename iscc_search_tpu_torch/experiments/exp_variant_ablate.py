"""
Where the time of ``csrc/blockmax_variants.cu`` (TPU kernel 8's epilogue
probes) goes: the kernel built with parts left out, and each build timed on
the card, in the way of :mod:`.exp_wgmma_ablate`.

The source takes a mask of parts to leave out (``ISCC_VARIANT_ABLATE``, 0
in the port's library); each variant here is that source alone built with
one mask (``ops._build.build(defines, names)``, under a build key of its
own) and called through ``ctypes`` like the real one. **A variant's output
is wrong on purpose**; only its time means anything, and only beside
``base`` from the same run:

- ``no_wgmma``: no ``wgmma`` is issued;
- ``no_epilogue``: no epilogue and no flush;
- ``no_staging``: rows enter the row tile at a team's first block only (no
  copies, and for the bf16 epilogues no conversion);
- ``wgmma_only``: ``no_epilogue`` and ``no_staging``;
- ``fixed_only``: ``no_wgmma`` and ``no_epilogue``: staging and barriers.

Times are per launch at ``exp_kernels``'s size (0 / -65536 penalties, or
``--general``: random bf16 penalties within 512 of each other, which take
the per-element path), with the clocks per 128-row block per SM beside
them.

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_variant_ablate
[--general] [--n N] [--q Q] [--names bf16,tree2d,...] [variant ...]``
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import subprocess

import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.experiments import exp_kernels as ek
from iscc_search_tpu_torch.ops import _build
from iscc_search_tpu_torch.ops import hopper_scan as hs

SOURCE = ("blockmax_variants.cu",)
# The bits of ISCC_VARIANT_ABLATE (csrc/blockmax_variants.cu).
NO_WGMMA, NO_EPILOGUE, NO_STAGING = 1, 2, 4
VARIANTS = {
    "base": 0,
    "no_wgmma": NO_WGMMA,
    "no_epilogue": NO_EPILOGUE,
    "no_staging": NO_STAGING,
    "wgmma_only": NO_EPILOGUE | NO_STAGING,
    "fixed_only": NO_WGMMA | NO_EPILOGUE,
}
NAMES = ("bf16", "tree2d", "dotonly", "bf16dot", "dotonly_bf16")


def defines_of(name):
    # type: (str) -> tuple[str, ...]
    """The build's ``-D`` macros for variant ``name`` (none for ``base``)."""
    return (f"ISCC_VARIANT_ABLATE={VARIANTS[name]}",) if VARIANTS[name] else ()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS), help=f"of {', '.join(VARIANTS)}")
    p.add_argument("--n", type=lambda s: int(float(s)), default=10 * 1024 * 1024, help="database rows")
    p.add_argument("--q", type=int, default=256, help="queries")
    p.add_argument("--names", default=",".join(NAMES), help="kernel-8 variants to time, comma-separated")
    p.add_argument("--general", action="store_true", help="penalties that take the per-element path")
    p.add_argument("--reps", type=int, default=10, help="timed calls per variant and name")
    args = p.parse_args(argv)
    dev = ex.device_of("cuda")
    props = torch.cuda.get_device_properties(dev)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    n, nq = args.n, args.q
    print(f"device {ex.device_name(dev)}, {props.multi_processor_count} SMs, maximum SM clock {mhz:.0f} MHz; "
          f"N={n}, Q={nq}, {'per-element' if args.general else '0/-65536'} penalties; every variant but base "
          f"computes something else: only the times mean anything")
    with concurrent.futures.ThreadPoolExecutor() as pool:  # every variant's nvcc runs at once
        libs = dict(zip(args.variants, pool.map(lambda v: _build.build(defines_of(v), SOURCE), args.variants)))
    gen = torch.Generator(device=dev).manual_seed(0)
    db = torch.where(torch.rand((n, 256), device=dev, generator=gen) < 0.5, 1, -1).to(torch.int8)
    q = db[torch.randint(0, n, (nq,), device=dev, generator=gen)].contiguous()
    qs = torch.full((nq,), 1 / 256, dtype=torch.float32, device=dev)
    valid = (torch.rand(n, device=dev, generator=gen) > 0.05).to(torch.uint8)
    blocks_per_sm = -(-(n // hs.BLOCK) // props.multi_processor_count)
    res = {}
    for variant, path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), "iscc_blockmax_variant")
        fn.argtypes, fn.restype = hs._SIGNATURES["iscc_blockmax_variant"], ctypes.c_int
        res[variant] = {}
        for name in args.names.split(","):
            epi, chunk, nodma, _ = ek.variant_spec(name)
            pen = ek.variant_penalties(name, valid, args.general)
            out = torch.empty((nq, n // hs.BLOCK), dtype=torch.float32, device=dev)

            def call():
                err = fn(epi, q.data_ptr(), qs.data_ptr(), nq, db.data_ptr(), pen.data_ptr(), n, chunk if nodma else 0,
                         out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {variant!r}, {name}: launch failed, cudaError {err}")

            ms = ex.time_ms(call, dev, args.reps)
            res[variant][name] = ms
            print(f"{variant:12s} {name:20s} {ms:.4f} ms, {ms * mhz * 1e3 / blocks_per_sm:.0f} clocks per block per SM",
                  flush=True)
    return res


if __name__ == "__main__":
    main()
