"""
Where the time of the block-major form of ``csrc/gather_rescore.cu`` goes:
the source built with one part left out at a time, each build timed on the
card beside the query-major form.

The source takes a mask of parts to leave out (``ISCC_GATHER_ABLATE``, 0 in
the port's library); each variant here is ``gather_rescore.cu`` alone built
with one mask (``ops._build.build(defines=..., names=...)``, under a build
key of its own) and called through ``ctypes`` like the real one. **A cut
variant's output is wrong on purpose**; only its time means anything, and
only beside ``base`` from the same run:

- ``base``: the block-major form as the library builds it (checked against
  the plain version);
- ``no_store``: the serving stage computes every dot and stores none;
- ``stores_only``: the serving stage loads no rows and counts no bits, and
  stores every pair's 128 floats: the inversion and the stores alone;
- ``no_rows``: the serving stage computes and stores as ``base`` does from
  a constant in place of each row: what reading the rows costs;
- ``inversion``: the serving stage is not launched: the counting sort alone.

``query`` is the query-major form of the base build. Each shape is a
synthetic partition of random rows, its first rows live, and the top-kk
blocks of ``blockmax_mma_packed`` for random full-length queries: the
product's chunk partition (``--shape product100``: Q=64, kk=4,096, a
limit-100 slice; ``product10``: Q=100, kk=512, a limit-10 request) or
config 4's (``config4``: Q=128, kk=2,048). Times are CUDA-graph replays,
beside the bound (distinct rows, block ids, queries and output once over
3.35 TB/s).

Usage: ``python -m iscc_search_tpu_torch.experiments.exp_gather_ablate
[--shape product100 ...] [variant ...]``
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes

import torch

from iscc_search_tpu_torch import experiments as ex
from iscc_search_tpu_torch.ops import _build, gather_layout
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.pm1_scan import query_prefix, topk_blocks_hier

SOURCE = "gather_rescore.cu"
ENTRY = "iscc_gather_rescore_blocks"
# The bits of ISCC_GATHER_ABLATE (csrc/gather_rescore.cu).
CUT_STORE, CUT_COMPUTE, CUT_SERVE, CUT_ROWS = 1, 2, 4, 8
VARIANTS = {"base": 0, "no_store": CUT_STORE, "stores_only": CUT_COMPUTE, "inversion": CUT_SERVE, "no_rows": CUT_ROWS}
# name: (capacity, live rows, lanes, Q, kk)
SHAPES = {
    "product100": (2_293_760, 2_000_000, 4, 64, 4096),
    "product10": (2_293_760, 2_000_000, 4, 100, 512),
    "config4": (112_525_312, 98_437_500, 4, 128, 2048),
}
HBM_BYTES_S = 3.35e12


def defines_of(name):
    # type: (str) -> tuple[str, ...]
    """The build's ``-D`` macros for variant ``name``."""
    return (f"ISCC_GATHER_ABLATE={VARIANTS[name]}",)


def bound_ms(nq, kk, lanes, blocks):
    # type: (int, int, int, int) -> float
    """The least time for the bytes: the distinct blocks' rows, the block
    ids, the queries (words and prefix lanes) read once, the f32 output
    written once."""
    return (blocks * 128 * lanes * 4 + nq * kk * 4 + nq * (lanes * 4 + 4) + nq * kk * 512) / HBM_BYTES_S * 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS), help=f"of {', '.join(VARIANTS)}")
    p.add_argument("--shape", action="append", choices=sorted(SHAPES), help="default: product100 and product10")
    p.add_argument("--reps", type=int, default=20, help="captured calls per variant and shape")
    args = p.parse_args(argv)
    variants = ["base", *(v for v in args.variants if v != "base")]
    dev = ex.device_of("cuda")
    print(f"device {ex.device_name(dev)}; {ENTRY} built with parts left out: every variant but base computes "
          "something else, only the times mean anything")
    with concurrent.futures.ThreadPoolExecutor() as pool:  # every variant's nvcc runs at once
        libs = dict(zip(variants, pool.map(lambda name: _build.build(defines_of(name), (SOURCE,)), variants)))
    entries = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for entry in (ENTRY, "iscc_gather_rescore"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = hs._SIGNATURES[entry], ctypes.c_int
        entries[name] = lib
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for shape in args.shape or ["product100", "product10"]:
        cap, live, lanes, nq, kk = SHAPES[shape]
        db = torch.randint(-(2**31), 2**31, (cap, lanes), dtype=torch.int32, device=dev, generator=gen)
        valid = torch.zeros(cap, dtype=torch.uint8, device=dev)
        valid[:live] = 1
        q = torch.randint(-(2**31), 2**31, (nq, 8), dtype=torch.int32, device=dev, generator=gen)
        min_lanes, q_scale = query_prefix(torch.full((nq,), lanes, dtype=torch.int32, device=dev), lanes * 32)
        block_ids = topk_blocks_hier(hs.blockmax_mma_packed(q, min_lanes, q_scale, db, valid), kk).to(torch.int32)
        nblocks = cap // hs.BLOCK
        out = torch.empty((nq, kk * hs.BLOCK), dtype=torch.float32, device=dev)
        ws = torch.empty(gather_layout.workspace_words(nq * kk, nblocks), dtype=torch.int32, device=dev)
        args_q = (q.data_ptr(), q.stride(0), min_lanes.data_ptr(), block_ids.data_ptr(), nq, kk, db.data_ptr())

        def call(lib, entry):
            extra = (nblocks, lanes, ws.data_ptr(), ws.numel()) if entry == ENTRY else (lanes,)
            err = getattr(lib, entry)(*args_q, *extra, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{entry}: launch failed, cudaError {err}")

        want = hs.gather_rescore_plain(q, min_lanes, block_ids, db)
        for entry in (ENTRY, "iscc_gather_rescore"):
            call(entries["base"], entry)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{shape}: the base build's {entry} differs from the plain version")
        del want
        blocks = int(torch.unique(block_ids).numel())
        bound = bound_ms(nq, kk, lanes, blocks)
        runs = {"query": lambda: call(entries["base"], "iscc_gather_rescore")}
        runs.update({name: (lambda lib=lib: call(lib, ENTRY)) for name, lib in entries.items()})
        res[shape] = {name: ex.time_ms(run, dev, args.reps, graph=True) for name, run in runs.items()}
        print(f"{shape}: cap {cap}, {lanes * 32}-bit, Q={nq}, kk={kk}, reuse {nq * kk / nblocks:.3f}, {blocks} distinct "
              f"blocks, bound {bound:.4f} ms: " + ", ".join(
                  f"{name} {ms:.4f} ms ({100 * bound / ms:.0f}%)" for name, ms in res[shape].items()), flush=True)
        if "inversion" in res[shape]:
            print(f"{shape}: serving stage (base - inversion) {res[shape]['base'] - res[shape]['inversion']:.4f} ms")
    return res


if __name__ == "__main__":
    main()
