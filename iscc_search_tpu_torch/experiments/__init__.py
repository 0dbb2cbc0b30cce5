"""
The phase-1 experiments of ``benchmarks/`` ported to PyTorch and Hopper
kernels: each module is an A/B entry point whose ``main()`` times variants
of phase 1 on the card and checks them against a reference.

- :mod:`.exp_kernels` (``benchmarks/exp_kernels.py``): epilogue width,
  orientation and tiling probes over the ±1 int8 twin
  (``csrc/blockmax_variants.cu``);
- :mod:`.exp_int4` (``benchmarks/exp_int4.py``): the int4 twin, dotted on
  the int8 tensor cores, nibbles shifted into bytes (``csrc/int4_dot.cu``);
- :mod:`.exp_bitplane_int8` (``benchmarks/exp_bitplane_int8.py``): 0/1 bit
  planes of the bit-transposed twin on the int8 tensor cores
  (``csrc/blockmax_bitplane.cu``);
- :mod:`.exp_bitplane_u8` (``benchmarks/exp_bitplane_u8.py``): the same
  from the uint8 / uint16 sub-word twins (``csrc/blockmax_bitplane.cu``).

One more has no counterpart in ``benchmarks/``: :mod:`.exp_wgmma_ablate`
times ``csrc/blockmax_mma.cu`` built with one part left out at a time.

Each module parses its arguments only inside ``main(argv)``; importing it
has no side effect. Run one on the card with, for example,
``python -m iscc_search_tpu_torch.experiments.exp_kernels --n 10485760 --q 256``.
Every wrapper takes its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors, as :mod:`iscc_search_tpu_torch.ops.hopper_scan`
does.
"""

from __future__ import annotations

import argparse
import functools
import time

import torch


def time_ms(fn, device, reps, graph=False):
    # type: (..., torch.device, int, bool) -> float
    """Mean milliseconds per call after one warm call: CUDA events on a
    card, the host clock on the CPU.

    :param graph: on a card, capture the ``reps`` calls in one
        ``torch.cuda.CUDAGraph`` and time a replay of it, so that a kernel
        shorter than its Python wrapper is timed by the device's clock and
        not by the host's launch rate. ``fn`` must be capturable: no
        synchronize, no host read of a device value. Ignored on the CPU.
    """
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    run = functools.partial(_repeat, fn, reps)
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(captured):
            run()
        run = captured.replay
        run()  # the first replay also uploads the graph
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        run()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _repeat(fn, reps):
    for _ in range(reps):
        fn()


def parser(doc, n, q):
    # type: (str, int, int) -> argparse.ArgumentParser
    """The arguments every experiment takes."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--n", type=lambda s: int(float(s)), default=n, help="database rows")
    p.add_argument("--q", type=int, default=q, help="queries")
    p.add_argument("--reps", type=int, default=10, help="timed calls per variant")
    p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions, a small --n)")
    return p


def device_of(name):
    # type: (str) -> torch.device
    """The device an experiment runs on; a CUDA run without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    return dev


def device_name(dev):
    # type: (torch.device) -> str
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
