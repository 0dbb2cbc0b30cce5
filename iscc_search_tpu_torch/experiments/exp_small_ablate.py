"""
Where the time of ``csrc/blockmax_small.cu`` goes: the kernel built with one
part left out at a time, and each build timed on the card.

The kernel's source takes a mask of parts to leave out
(``ISCC_SMALL_ABLATE``, 0 in the port's library); each variant here is
``blockmax_small.cu`` alone built with one mask (``ops._build.build(defines=
..., names=...)``, under a build key of its own) and called through
``ctypes`` like the real one. **A variant's output is wrong on purpose**;
only its time means anything, and only beside ``base`` from the same run:

- ``no_compute``: no unpack, MMA or maxima; the ring is still filled and
  waited for, and the maxima written: the streaming alone;
- ``no_valid``: the validity bytes are not copied (one TMA copy per block);
- ``no_flush``: the gathered maxima are never written;
- ``no_stream``: no copy is made or waited for; the warps compute on the
  ring as it is: the compute alone;
- ``stream_only``: ``no_compute`` and ``no_flush``.

Times are per Q-query sweep of the partitions, with the clocks per 128-row
block per SM beside them (ms x SM clock / blocks per SM).

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_small_ablate
[--q 16] [--config 3|4] [variant ...]``
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

SOURCE = "blockmax_small.cu"
ENTRY = "iscc_blockmax_small"
# Rows per lane count of the timed partitions: config 3's four capacities,
# or config 4's one 128-bit chunk partition.
CAPACITIES = {
    3: {2: 3_014_656, 4: 2_949_120, 6: 1_245_184, 8: 4_718_592},
    4: {4: 112_525_312},
}
# The bits of ISCC_SMALL_ABLATE (csrc/blockmax_small.cu).
NO_COMPUTE, NO_VALID, NO_FLUSH, NO_STREAM = 1, 2, 4, 8
VARIANTS = {
    "base": 0,
    "no_compute": NO_COMPUTE,
    "no_valid": NO_VALID,
    "no_flush": NO_FLUSH,
    "no_stream": NO_STREAM,
    "stream_only": NO_COMPUTE | NO_FLUSH,
}


def defines_of(name):
    # type: (str) -> tuple[str, ...]
    """The build's ``-D`` macros for variant ``name`` (``base``: the
    library's source as it is, built alone)."""
    return (f"ISCC_SMALL_ABLATE={VARIANTS[name]}",)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS), help=f"of {', '.join(VARIANTS)}")
    p.add_argument("--q", type=int, default=16, help="queries")
    p.add_argument("--config", type=int, default=3, choices=sorted(CAPACITIES), help="partitions of config 3 or 4")
    p.add_argument("--reps", type=int, default=10, help="timed calls per variant and width")
    args = p.parse_args(argv)
    dev = ex.device_of("cuda")
    props = torch.cuda.get_device_properties(dev)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    print(f"device {ex.device_name(dev)}, {props.multi_processor_count} SMs, maximum SM clock {mhz:.0f} MHz; "
          f"{ENTRY}, Q={args.q}, config {args.config}; every variant but base computes something else: "
          "only the times mean anything")
    with concurrent.futures.ThreadPoolExecutor() as pool:  # every variant's nvcc runs at once
        libs = dict(zip(args.variants, pool.map(lambda name: _build.build(defines_of(name), (SOURCE,)), args.variants)))
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for lanes, cap in CAPACITIES[args.config].items():
        q = torch.randint(-(2**31), 2**31, (args.q, 8), dtype=torch.int32, device=dev, generator=gen)
        min_lanes = torch.full((args.q,), lanes, dtype=torch.int32, device=dev)
        q_scale = torch.full((args.q,), 1.0 / (64 * lanes), dtype=torch.float32, device=dev)
        db = torch.randint(-(2**31), 2**31, (cap, lanes), dtype=torch.int32, device=dev, generator=gen)
        valid = (torch.rand(cap, device=dev, generator=gen) > 1 / 64).to(torch.uint8)
        out = torch.empty((args.q, cap // hs.BLOCK), dtype=torch.float32, device=dev)
        data[lanes] = (q, min_lanes, q_scale, db, valid, out)
    res = {}
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), ENTRY)
        fn.argtypes, fn.restype = hs._SIGNATURES[ENTRY], ctypes.c_int
        res[name] = {}
        for lanes, (q, min_lanes, q_scale, db, valid, out) in data.items():
            cap = db.shape[0]

            def call():
                err = fn(q.data_ptr(), q.stride(0), min_lanes.data_ptr(), q_scale.data_ptr(), args.q, db.data_ptr(),
                         valid.data_ptr(), cap // hs.BLOCK, lanes, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name!r}: launch failed, cudaError {err}")

            ms = ex.time_ms(call, dev, args.reps, graph=True)
            blocks_per_sm = -(-(cap // hs.BLOCK) // props.multi_processor_count)
            res[name][lanes] = ms
            print(f"{name:12s} {lanes * 32:3d}-bit cap={cap}: {ms:.4f} ms, {ms * mhz * 1e3 / blocks_per_sm:.0f} clocks per block per SM")
        print(f"{name:12s} all: {sum(res[name].values()):.4f} ms", flush=True)
    return res


if __name__ == "__main__":
    main()
