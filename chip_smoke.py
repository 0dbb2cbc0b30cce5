#!/usr/bin/env python3
"""
Smoke run of the PyTorch + CUDA port (``iscc_search_tpu_torch``) on one
Hopper GPU, at the size of BASELINE config 3: 10,485,760 variable-length
ISCC-UNIT codes (64/128/192/256-bit at p = .25/.25/.10/.40, the mix of
``benchmarks/config3_10m.py``), exact NPHD top-10 for a batch of 512 queries;
and at the size of BASELINE config 2: 1,048,576 256-bit codes with a
persisted snapshot.

Phases (each prints its lines; any failure raises and exits non-zero):

1. device  — a CUDA device of compute capability >= 9.0 (there is no CPU
   path), and the card's name and power limit from ``nvidia-smi``;
2. build   — the kernels of ``iscc_search_tpu_torch/csrc`` with nvcc;
3. kernels — one bare ``wgmma`` tile against the integer product (the
   shared-memory layout of ``csrc/blockmax_mma.cu``), then each kernel
   against its plain PyTorch version on the card, ``torch.equal``, over all
   four widths, query tiles, short and long queries, tombstones and fully
   invalid blocks (the two tensor-core phase-1 entries also against the
   popc ``blockmax``), then at the shapes of the config-3 partitions
   (Q=512, 16 candidate blocks per query) with the time of each beside its
   plain version's (and beside ``blockmax``'s). ``gather_rescore`` runs
   shorter than its Python wrapper, so its time is a CUDA-graph replay of
   its calls (the device's clock); the host-paced reading is printed
   beside it;
4. slice   — ``DeviceNphdIndex(path, device="cuda")`` (``scan_kernel``
   left at ``"auto"``) filled through ``add_packed``, 1/64 of the keys
   removed, 4,096 rows appended through ``add``, then ``search`` of 512
   live rows at k=10: self-match at rank 0 with score 1.0, the top-10 of 16
   sampled queries against brute-force ``nphd_scores`` over the whole
   database, no removed key returned, and the search launched
   ``blockmax_mma_packed`` and ``gather_rescore`` and no ``blockmax``;
5. twin    — the int8-twin route over the engine's own four partitions:
   ``build_unpacked_db`` on the card (seconds and bytes printed), then
   ``blockmax_topk_packedq_impl(..., db_unpacked=twin, unpacked=True)``
   for the slice's 512 queries at the engine's k and the packed-row
   tensor-core phase 1 (``blockmax_mma_packed``) on each partition, both
   kernels launched; results ``torch.equal`` to the route without a twin
   and to ``blockmax``, with the time of each route;
6. route   — phase 1 by batch size, on the engine's four partitions:
   ``blockmax`` (XOR + popc) and ``blockmax_mma_packed`` (``wgmma``) at Q in
   1..1024, CUDA-graph replays, ``torch.equal`` at every point; the table
   Q x width x {popc ms, mma ms}, the crossover per width, and what
   ``scan_kernel="auto"`` takes (it fails if that is more than 1.5x the
   other kernel's time anywhere). Then warm searches at Q=512 and Q=1
   under ``"popc"``, ``"mma"`` and ``"auto"``, four rounds of 7 in
   alternating order, each checked against brute force, equal to the
   ``"popc"`` results and launching the phase-1 kernels its
   ``scan_kernel`` names; the JSON summary's ``launches`` of
   ``blockmax`` and ``blockmax_mma_packed`` are those of the ``"auto"``
   searches;
7. persist — BASELINE config 2 at its own size: 1,048,576 random 256-bit
   codes, keys 1..N, 1/64 tombstoned, in a fresh temporary directory with
   8 MiB shards (five sealed segments). Search (a), ``save(wait=True)``,
   ``close()``, open the directory anew, search (b); add 4,096 rows,
   remove some, ``save(wait=False)``, ``drain_rotations()``, reopen,
   search (c); ``compact()``, save, reopen, search (d). (a) == (b) exactly,
   (a), (c) and (d) equal brute force; save, load, first-search and
   warm-search seconds and the directory's bytes are printed. Then the
   config-3 index of phases 4-6 is saved, closed and opened anew, and must
   answer as before;
8. experiments — the phase-1 experiment entry points of
   ``iscc_search_tpu_torch.experiments`` (TPU kernels 8-11): each kernel
   against its plain version (``torch.equal``) on edge cases (Q=77,
   192-bit prefixes, tombstones, a dead block; kernels 10 and 11 also
   against ``blockmax`` on the same packed rows), then each module's
   ``main()`` at the script's own size with the counters set to 0 just
   before and read just after, then each kernel against its plain version
   at that size, with the plain version's time.

Each kernel's line in the JSON summary carries ``bound_ms``, the least time
the card could take for the same work: the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its operations over
the peak rate of their type (int8 1,979 TOP/s for the ±1 dots of every
phase-1 kernel, ``blockmax`` and the kernel-8 variants too, whatever unit
runs them; int4 MACs at the int8 rate, for want of an int4 figure; the
``popc`` of ``gather_rescore`` at 16 per clock per SM at the card's maximum
SM clock, NVIDIA's published throughput for compute capability 9.0).
``blockmax`` also carries ``popc_ceiling_ms``, its popc count over that
rate: the ceiling of XOR + popc as an implementation, not a bound of the
function.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.

``--profile`` adds, after phase 6, the host split and the device time by
kernel of warm searches under ``"popc"`` and ``"auto"`` at Q=512 and under
``"auto"`` at Q=1.

Usage: ``python3 chip_smoke.py [--seed N] [--profile]``
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine.device_index import _cap_rows, _pow2ceil, auto_phase1
from iscc_search_tpu_torch.experiments import exp_bitplane_int8 as ex10
from iscc_search_tpu_torch.experiments import time_ms
from iscc_search_tpu_torch.experiments import exp_bitplane_u8 as ex11
from iscc_search_tpu_torch.experiments import exp_int4 as ex9
from iscc_search_tpu_torch.experiments import exp_kernels as ex8
from iscc_search_tpu_torch.ops import _build, bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import wgmma_layout
from iscc_search_tpu_torch.ops.nphd import nphd_scores
from iscc_search_tpu_torch.ops.packing import pack_codes
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, query_prefix

N_ROWS = 10_485_760  # bench.py headline size
LANE_CHOICES = (2, 4, 6, 8)  # 64/128/192/256-bit
LANE_P = (0.25, 0.25, 0.10, 0.40)  # benchmarks/config3_10m.py length mix
N_QUERIES = 512
K = 10
KK = 16  # candidate blocks per query at k=10 (k bucketed to a power of two)
N_APPEND = 4096
TOMBSTONE_EVERY = 64
ROUTE_QS = (1, 2, 4, 8, 16, 32, 40, 48, 64, 96, 128, 192, 256, 512, 1024)  # batch sizes of the [route] table
ROUTE_ROUNDS = 4  # rounds of 7 warm searches per scan_kernel and batch size
AUTO_SLACK = 1.5  # 'auto' may take the slower phase-1 kernel by at most this factor (near a crossover)
N_PERSIST = 1_048_576  # BASELINE config 2: 1M x 256-bit units with a persisted snapshot
PERSIST_SHARD_BYTES = 8 * 1024 * 1024  # seals ~186,000 rows per segment: five sealed segments at config 2
N_ORACLE = 16
SCORE_ATOL = 1e-6  # 0.5 + dot*q_scale vs 1 - ham/min_bits: a few f32 ulps near 1.0

KERNELS = {
    "blockmax": {
        "source": "iscc_search_tpu_torch/csrc/blockmax.cu",
        "replaces": "iscc_search_tpu/ops/pallas_scan.py:310",
        "also_replaces": ["iscc_search_tpu/ops/pallas_scan.py:410"],
    },
    "gather_rescore": {
        "source": "iscc_search_tpu_torch/csrc/gather_rescore.cu",
        "replaces": "iscc_search_tpu/ops/pallas_scan.py:835",
        "also_replaces": ["iscc_search_tpu/ops/pallas_scan.py:910"],
    },
    "blockmax_mma_unpacked": {
        "source": "iscc_search_tpu_torch/csrc/blockmax_mma.cu",
        "replaces": "iscc_search_tpu/ops/pallas_scan.py:127",
    },
    "blockmax_mma_packed": {
        "source": "iscc_search_tpu_torch/csrc/blockmax_mma.cu",
        "replaces": "iscc_search_tpu/ops/pallas_scan.py:102",
        "also_replaces": ["iscc_search_tpu/ops/pallas_scan.py:372"],
    },
}
PHASE1 = ("blockmax", "blockmax_mma_unpacked", "blockmax_mma_packed")
EXPERIMENT_KERNELS = {  # TPU kernels 8-11, reached through iscc_search_tpu_torch.experiments
    "blockmax_variant": {
        "source": "iscc_search_tpu_torch/csrc/blockmax_variants.cu",
        "replaces": "benchmarks/exp_kernels.py:42",
        "also_replaces": [f"benchmarks/exp_kernels.py:{n}" for n in (59, 74, 91, 108, 129, 150, 169, 189)],
    },
    "int4_dot": {"source": "iscc_search_tpu_torch/csrc/int4_dot.cu", "replaces": "benchmarks/exp_int4.py:89"},
    "int4_probe": {"source": "iscc_search_tpu_torch/csrc/int4_dot.cu", "replaces": "benchmarks/exp_int4.py:89"},
    "blockmax_bitplane": {
        "source": "iscc_search_tpu_torch/csrc/blockmax_bitplane.cu",
        "replaces": "benchmarks/exp_bitplane_int8.py:53",
    },
    "blockmax_subword": {
        "source": "iscc_search_tpu_torch/csrc/blockmax_bitplane.cu",
        "replaces": "benchmarks/exp_bitplane_u8.py:123",
    },
}
WRAPPERS = {
    "blockmax_variant": ex8.blockmax_variant, "int4_dot": ex9.int4_dot, "int4_probe": ex9.int4_probe,
    "blockmax_bitplane": ex10.blockmax_bitplane, "blockmax_subword": ex11.blockmax_subword,
}
# Script sizes of the experiments (benchmarks/exp_*.py defaults).
N8, Q8 = 10_485_760, 256
N9, N9_LARGE, Q9 = 1_048_576, 10_485_760, 8
N10, Q10 = 8_388_608, 256
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_S = 1979e12
POPC_PER_CLOCK_SM = 16  # CUDA C++ Programming Guide, compute capability 9.0
CARD = {}  # filled by phase_device: SMs and maximum SM clock


def log(msg):
    print(msg, flush=True)


def random_codes(rng, n, lanes_choices=LANE_CHOICES, p=LANE_P):
    """(codes (n, 8) uint32 with zeroed lanes past each length, lanes (n,) int32)."""
    lanes = rng.choice(np.asarray(lanes_choices, np.int32), n, p=p).astype(np.int32)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    return codes, lanes


def bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def variant_bound(name, n, nq):
    """bound() of one kernel-8 variant: the db rows it reads (chunk 0 only
    for ``*_nodma``), its penalty row if its function uses one, the queries
    and the (nq, n / 128) f32 output; the int8 dot's operations at the int8
    rate, whatever unit the variant runs them on."""
    epi, chunk, nodma, _ = ex8.variant_spec(name)
    pen_bytes = {ex8.EPI_U8MAX: 1, ex8.EPI_BF16_NOPEN: 0, ex8.EPI_DOTONLY: 0, ex8.EPI_DOTONLY_BF16: 0,
                 ex8.EPI_CONSUME: 0}.get(epi, 2)
    nbytes = (min(n, chunk) if nodma else n) * 256 + n * pen_bytes + nq * 260 + nq * (n // 128) * 4
    return bound(nbytes, 2 * nq * n * 256, INT8_OPS_S)


def popc_per_s():
    return POPC_PER_CLOCK_SM * CARD["sms"] * CARD["max_sm_mhz"] * 1e6


def bodies_of(codes, lanes):
    return [codes[i, : lanes[i]].astype(">u4").tobytes() for i in range(len(lanes))]


# ------------------------------------------------------------------ phases


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False); the port's kernels need one")
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap} < (9, 0); the kernels are built for sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} capability={cap} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)  # name, power limit
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["max_sm_mhz"] = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    log(f"[device] {CARD['sms']} SMs, maximum SM clock {CARD['max_sm_mhz']:.0f} MHz")
    # f32 matmuls of the plain versions in full f32 (±1 dots are exact
    # either way; stated so the comparison does not depend on the default).
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s ({_build.BUILD_ROOT})")
    for line in _build.build_log().splitlines():
        # ptxas names each entry, then its registers and shared memory.
        if "Compiling entry function" in line or "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def _case(rng, dev, nbits, cap, nq, n_live, kk, tombstone_every=0, dead_block=None):
    """Random partition + queries on the card for one kernel comparison."""
    lanes = nbits // 32
    db = torch.randint(-(2**31), 2**31, (cap, lanes), dtype=torch.int32, device=dev)
    valid = torch.zeros(cap, dtype=torch.uint8, device=dev)
    valid[:n_live] = 1
    if tombstone_every:
        valid[::tombstone_every] = 0
    if dead_block is not None:
        valid[dead_block * 128 : (dead_block + 1) * 128] = 0
    q_codes, q_lanes = random_codes(rng, nq)  # 64..256-bit: shorter and longer than the partition
    q_packed = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    min_lanes, q_scale = query_prefix(torch.from_numpy(q_lanes).to(dev), nbits)
    block_ids = torch.from_numpy(rng.integers(0, cap // 128, (nq, kk)).astype(np.int32)).to(dev)
    return q_packed, min_lanes, q_scale, db, valid, block_ids


def _compare(name, got, want, err):
    """Raise unless kernel output ``got`` equals the plain ``want``; fold the
    measured max |got - want| into ``err[kernel]``."""
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got - want).abs()
        raise AssertionError(f"{name}: kernel != plain at {int((diff > 0).sum())} positions (max {float(diff.max())})")
    kernel = name.split()[0]
    err[kernel] = max(err[kernel], float((got - want).abs().max()))


def _phase1_outputs(q_packed, min_lanes, q_scale, db, valid, twin):
    """The three phase-1 kernels and the two plain versions on one input."""
    args = (q_packed, min_lanes, q_scale)
    return {
        "blockmax": lambda: hs.blockmax(*args, db, valid),
        "blockmax_mma_unpacked": lambda: hs.blockmax_mma_unpacked(*args, twin, valid),
        "blockmax_mma_packed": lambda: hs.blockmax_mma_packed(*args, db, valid),
        "blockmax_plain": lambda: hs.blockmax_plain(*args, db, valid),
        "blockmax_mma_unpacked_plain": lambda: hs.blockmax_unpacked_plain(*args, twin, valid),
        "blockmax_mma_packed_plain": lambda: hs.blockmax_plain(*args, db, valid),
    }


def _compare_phase1(label, calls, err):
    """Each phase-1 kernel equals its plain version, and the tensor-core
    entries equal the popc kernel; returns the popc kernel's output."""
    popc = calls["blockmax"]()
    for name in PHASE1:
        got = popc if name == "blockmax" else calls[name]()
        _compare(f"{name} {label}", got, calls[name + "_plain"](), err)
        if name != "blockmax":
            _compare(f"{name} {label} vs blockmax", got, popc, err)
    return popc


def phase_kernels(rng, dev, part_rows):
    err = dict.fromkeys(KERNELS, 0.0)
    # The layout, descriptors and accumulator order blockmax_mma.cu rests on.
    a = torch.randint(-128, 128, (wgmma_layout.TILE_M, 256), dtype=torch.int8, device=dev)
    b = torch.randint(-128, 128, (wgmma_layout.TILE_N, 256), dtype=torch.int8, device=dev)
    if not torch.equal(wgmma_layout.wgmma_tile(a, b), wgmma_layout.wgmma_tile_plain(a, b)):
        raise AssertionError("the bare wgmma tile differs from the integer product")
    log("[kernels] bare wgmma m64n128k32 x 8 over the core-matrix layout == integer product")
    # Edge cases: every width, Q not a multiple of the 64-query tile, short
    # and long queries, tombstones, a fully invalid block, invalid padding.
    for nbits in (64, 128, 192, 256):
        q_packed, min_lanes, q_scale, db, valid, block_ids = _case(
            rng, dev, nbits, cap=128 * 40, nq=77, n_live=128 * 37 + 5, kk=16, tombstone_every=7, dead_block=3
        )
        twin = hs.build_unpacked_db(db, nbits)
        bm = _compare_phase1(f"{nbits}-bit edge", _phase1_outputs(q_packed, min_lanes, q_scale, db, valid, twin), err)
        if not bool((bm[:, 3] < -1.0).all()):
            raise AssertionError("a fully invalid block must lie below NEG_SCORE")
        gr = hs.gather_rescore(q_packed, min_lanes, block_ids, db)
        _compare(f"gather_rescore {nbits}-bit edge", gr,
                 hs.gather_rescore_plain(q_packed, min_lanes, block_ids, db), err)
    log("[kernels] edge cases: kernel == plain for 64/128/192/256-bit (Q=77, tombstones, dead block); "
        "blockmax_mma_unpacked == blockmax_mma_packed == blockmax")

    # Main-path shapes: the capacities of the config-3 partitions, Q=512, kk=16.
    ms = dict.fromkeys(KERNELS, 0.0)
    plain_ms = dict.fromkeys(KERNELS, 0.0)
    gather_host_ms = 0.0  # gather_rescore paced by the host's launches
    work = {name: [0.0, 0.0] for name in KERNELS}  # bytes, operations
    popc_ops = 0.0  # what blockmax.cu executes: one popc per (query, row, lane)
    for lanes, n_part in sorted(part_rows.items()):
        nbits = lanes * 32
        cap = _cap_rows(n_part)
        q_packed, min_lanes, q_scale, db, valid, block_ids = _case(
            rng, dev, nbits, cap=cap, nq=N_QUERIES, n_live=n_part, kk=KK, tombstone_every=TOMBSTONE_EVERY
        )
        twin = hs.build_unpacked_db(db, nbits)
        calls = _phase1_outputs(q_packed, min_lanes, q_scale, db, valid, twin)
        calls["gather_rescore"] = lambda: hs.gather_rescore(q_packed, min_lanes, block_ids, db)
        calls["gather_rescore_plain"] = lambda: hs.gather_rescore_plain(q_packed, min_lanes, block_ids, db)
        _compare_phase1(f"{nbits}-bit main", calls, err)
        _compare(f"gather_rescore {nbits}-bit main", calls["gather_rescore"](), calls["gather_rescore_plain"](), err)
        t = {name: time_ms(calls[name], dev, 10) for name in PHASE1}
        t["gather_rescore"] = time_ms(calls["gather_rescore"], dev, 20, graph=True)  # the device's clock
        gather_host_ms += time_ms(calls["gather_rescore"], dev, 20)
        t.update({f"{name}_plain": time_ms(calls[f"{name}_plain"], dev, 5 if name == "gather_rescore" else 3) for name in KERNELS})
        for name in KERNELS:
            ms[name] += t[name]
            plain_ms[name] += t[name + "_plain"]
        # Bytes each input read once and each output written once; operations
        # of the function: two per ±1 product of a (query, row) dot, at the
        # int8 rate for every phase-1 kernel, whatever unit it runs them on.
        q_bytes = N_QUERIES * (lanes * 4 + 12)
        out_bytes = N_QUERIES * (cap // 128) * 4
        for name, db_bytes in (("blockmax", cap * lanes * 4), ("blockmax_mma_packed", cap * lanes * 4),
                               ("blockmax_mma_unpacked", cap * nbits)):
            work[name][0] += db_bytes + cap + q_bytes + out_bytes
            work[name][1] += N_QUERIES * cap * 2 * nbits
        popc_ops += N_QUERIES * cap * lanes
        blocks = int(torch.unique(block_ids).numel())
        work["gather_rescore"][0] += blocks * 128 * lanes * 4 + block_ids.numel() * 4 + q_bytes + block_ids.numel() * 512
        work["gather_rescore"][1] += block_ids.numel() * 128 * lanes
        log(f"[kernels] {nbits}-bit cap={cap} Q={N_QUERIES} kk={KK}: kernel == plain; "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
        del q_packed, min_lanes, q_scale, db, valid, block_ids, twin, calls
    log(f"[kernels] gather_rescore per sweep of all partitions: {ms['gather_rescore']:.4f} ms by the device's clock "
        f"(CUDA-graph replay of 20 calls), {gather_host_ms:.4f} ms with each call launched by the host (events)")
    stats = {}
    for name in KERNELS:
        rate = popc_per_s() if name == "gather_rescore" else INT8_OPS_S
        bound_ms, bound_by = bound(work[name][0], work[name][1], rate)
        stats[name] = {"max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        if name == "blockmax":
            # Not the function's bound: the ceiling of XOR + popc as an implementation.
            stats[name]["popc_ceiling_ms"] = popc_ops / popc_per_s() * 1e3
            log(f"[kernels] blockmax: the ceiling of its popc count is {stats[name]['popc_ceiling_ms']:.4f} ms ({popc_ops:.4g} popc)")
        log(f"[kernels] {name}: {ms[name]:.4f} ms per Q={N_QUERIES} sweep of all partitions "
            f"(plain {plain_ms[name]:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}: {work[name][0]:.4g} bytes, "
            f"{work[name][1]:.4g} ops), max |kernel - plain| = {err[name]}")
    return stats


def brute_force(dev, q_codes, q_lanes, all_codes, all_lanes, valid):
    """(len(q_lanes), len(all_lanes)) f32 NPHD scores of every row on the
    card, invalid rows masked, in steps of 2**20 rows."""
    db_codes = torch.from_numpy(all_codes.view(np.int32)).to(dev)
    db_lanes = torch.from_numpy(all_lanes).to(dev)
    db_valid = torch.from_numpy(valid).to(dev)
    oq = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    ol = torch.from_numpy(q_lanes).to(dev)
    step = 1 << 20
    return torch.cat([
        nphd_scores(oq, ol, db_codes[s : s + step], db_lanes[s : s + step], db_valid[s : s + step])
        for s in range(0, len(all_lanes), step)
    ], dim=1)


def check_results(label, res, q_keys, valid, ref_np, top_ref, sample, first_key=0):
    """Raise unless every query has ``K`` results with its own key (a live
    stored row) at score 1.0 in front, no result is an invalid row, and for
    the sampled queries the score multiset equals brute force's top-``K``
    and every returned row carries its brute-force score. Row r holds key
    ``first_key + r``; ``q_keys`` are the queries' own keys."""
    for qi, (k, s) in enumerate(res):
        got = k.view(">u8").ravel().astype(np.int64)
        if len(got) != K or int(got[0]) != int(q_keys[qi]) or float(s[0]) != 1.0:
            raise AssertionError(f"{label} query {qi}: rank 0 is key {got[:1]} score {s[:1]}, expected key {q_keys[qi]} at 1.0")
        if not valid[got - first_key].all():
            raise AssertionError(f"{label} query {qi} returned a removed key")
    for j, qi in enumerate(sample):
        k, s = res[qi]
        rows = k.view(">u8").ravel().astype(np.int64) - first_key
        if not np.allclose(np.sort(s)[::-1], top_ref[j], rtol=0, atol=SCORE_ATOL):
            raise AssertionError(f"{label} query {qi}: top-{K} scores {s} != brute force {top_ref[j]}")
        if not np.allclose(ref_np[j, rows], s, rtol=0, atol=SCORE_ATOL):
            raise AssertionError(f"{label} query {qi}: returned rows carry brute-force scores {ref_np[j, rows]}, not {s}")


def same_results(a, b):
    """Two result lists equal exactly: the same keys and scores in the same order."""
    return len(a) == len(b) and all(
        np.array_equal(ka, kb) and np.array_equal(sa, sb) for (ka, sa), (kb, sb) in zip(a, b)
    )


def warm_searches(idx, queries, reps=7):
    """(last results, sorted seconds) of ``reps`` warm searches by the host's clock."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = idx.search(queries, K)
        times.append(time.perf_counter() - t0)
    return res, sorted(times)


def phase_slice(rng, dev, codes, lanes, path):
    n = len(lanes)
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    idx = DeviceNphdIndex(path, device="cuda")
    t0 = time.perf_counter()
    idx.add_packed(keys, codes, lanes)
    log(f"[slice] add_packed {n} codes: {time.perf_counter() - t0:.3f} s")

    # Spread over the rows, each 1 mod TOMBSTONE_EVERY: never a removed row.
    q_rows = np.arange(N_QUERIES, dtype=np.int64) * (n // N_QUERIES) // TOMBSTONE_EVERY * TOMBSTONE_EVERY + 1
    t0 = time.perf_counter()
    idx.search(bodies_of(codes[q_rows], lanes[q_rows]), K)
    torch.cuda.synchronize()
    log(f"[slice] first search (builds and uploads the partitions): {time.perf_counter() - t0:.3f} s")

    removed = np.arange(0, n, TOMBSTONE_EVERY)
    t0 = time.perf_counter()
    n_removed = idx.remove(removed.tolist())
    if n_removed != len(removed):
        raise AssertionError(f"removed {n_removed} of {len(removed)} keys")
    new_codes, new_lanes = random_codes(rng, N_APPEND)
    idx.add(list(range(n, n + N_APPEND)), bodies_of(new_codes, new_lanes))
    log(f"[slice] removed {n_removed} keys, appended {N_APPEND} rows via add: {time.perf_counter() - t0:.3f} s")

    all_codes = np.concatenate([codes, new_codes])
    all_lanes = np.concatenate([lanes, new_lanes])
    q_rows[-8:] = n + np.arange(8) * (N_APPEND // 8)  # some queries are appended rows
    queries = bodies_of(all_codes[q_rows], all_lanes[q_rows])

    for fn in hs.PHASE1.values():
        fn.launches = 0
    hs.gather_rescore.launches = 0
    t0 = time.perf_counter()
    res = idx.search(queries, K)  # incremental sync: appends + fresh validity
    sync_s = time.perf_counter() - t0
    res, times = warm_searches(idx, queries)
    # scan_kernel="auto" at Q=512: phase 1 on the tensor cores, no popc launch.
    launches = {"blockmax_mma_packed": hs.blockmax_mma_packed.launches, "gather_rescore": hs.gather_rescore.launches}
    if hs.blockmax.launches:
        raise AssertionError(f"scan_kernel='auto' launched blockmax {hs.blockmax.launches} times at Q={N_QUERIES}")
    med = statistics.median(times)
    log(f"[slice] search after remove+add (incremental sync + search): {sync_s:.4f} s")
    log(f"[slice] warm search Q={N_QUERIES} k={K}: median {med * 1e3:.3f} ms of {len(times)} "
        f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), {N_QUERIES / med:.1f} QPS")
    log(f"[slice] device memory: allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[slice] kernel launches during the searches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the search never launched the {name} kernel")

    # Brute force over the whole database on the card (key == row here).
    valid = np.ones(len(all_lanes), bool)
    valid[removed] = False
    sample = np.linspace(0, N_QUERIES - 1, N_ORACLE).astype(np.int64)
    ref = brute_force(dev, all_codes[q_rows[sample]], all_lanes[q_rows[sample]], all_codes, all_lanes, valid)
    oracle = (q_rows, valid, ref.cpu().numpy(), torch.topk(ref, K, dim=1).values.cpu().numpy(), sample)
    check_results("[slice]", res, *oracle)
    log(f"[slice] self-match at rank 0 with score 1.0 for all {N_QUERIES} queries; no removed key returned; "
        f"{N_ORACLE} sampled queries: top-{K} score multisets and every row's score match brute-force "
        f"nphd_scores over all {len(all_lanes)} rows (atol {SCORE_ATOL})")
    return launches, idx, queries, oracle


def phase_twin(dev, idx, queries):
    """The int8-twin route on the engine's own partitions, after the slice's
    removes and appends: twin build, then the route and the packed-row
    tensor-core phase 1 with the counters set to 0 just before and read
    just after, then both held against the route without a twin."""
    parts = idx._sync_device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twins = {lanes: hs.build_unpacked_db(p.packed_dev, lanes * 32) for lanes, p in parts.items()}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    twin_bytes = sum(t.numel() * t.element_size() for t in twins.values())
    if twin_bytes != sum(p.cap * lanes * 32 for lanes, p in parts.items()):
        raise AssertionError(f"twins hold {twin_bytes} bytes, not cap x nbits")
    caps = {lanes: p.cap for lanes, p in sorted(parts.items())}
    log(f"[twin] build_unpacked_db of {len(twins)} partitions (capacity per lane count {caps}): {build_s:.4f} s, "
        f"{twin_bytes / 1e9:.3f} GB on the card ({twin_bytes} bytes = rows x nbits)")

    q_codes, q_lanes = pack_codes(queries)
    q_packed = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    q_lanes = torch.from_numpy(q_lanes).to(dev)
    steps = {}
    for lanes, p in sorted(parts.items()):
        nbits = lanes * 32
        k = min(_pow2ceil(K), p.cap)  # the engine's k for this partition
        min_lanes, q_scale = query_prefix(q_lanes, nbits)
        step = (q_packed, q_lanes, p.packed_dev, p.valid_dev, k, nbits)
        steps[lanes] = {
            "twin": lambda s=step, t=twins[lanes]: hs.blockmax_topk_packedq_impl(*s, db_unpacked=t, unpacked=True),
            "packed_mma": lambda s=step, m=min_lanes, q=q_scale: hs.blockmax_mma_packed(s[0], m, q, s[2], s[3]),
            "no_twin": lambda s=step: hs.blockmax_topk_packedq_impl(*s),
            "popc": lambda s=step, m=min_lanes, q=q_scale: hs.blockmax(s[0], m, q, s[2], s[3]),
        }

    for fn in (hs.blockmax_mma_unpacked, hs.blockmax_mma_packed):
        fn.launches = 0
    got = {lanes: (st["twin"](), st["packed_mma"]()) for lanes, st in steps.items()}
    torch.cuda.synchronize()
    launches = {"blockmax_mma_unpacked": hs.blockmax_mma_unpacked.launches,
                "blockmax_mma_packed": hs.blockmax_mma_packed.launches}
    log(f"[twin] kernel launches of the twin route and the packed-row phase 1: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the twin route never launched the {name} kernel")

    for lanes, st in steps.items():
        (scores, rows), bm = got[lanes]
        want_scores, want_rows = st["no_twin"]()
        if not (torch.equal(scores, want_scores) and torch.equal(rows, want_rows)):
            raise AssertionError(f"{lanes * 32}-bit partition: the twin route differs from the route without a twin")
        if not torch.equal(bm, st["popc"]()):
            raise AssertionError(f"{lanes * 32}-bit partition: blockmax_mma_packed differs from blockmax")
        t = {name: time_ms(fn, dev, 5) for name, fn in st.items()}
        log(f"[twin] {lanes * 32}-bit cap={parts[lanes].cap} Q={N_QUERIES} k={min(_pow2ceil(K), parts[lanes].cap)}: "
            "twin route == route without twin, blockmax_mma_packed == blockmax; "
            + ", ".join(f"{name} {v:.4f} ms" for name, v in t.items()))
    log(f"[twin] all {len(steps)} partitions ({sum(p.cap for p in parts.values())} rows, "
        f"{sum(p.count for p in parts.values())} filled): the int8-twin route equals the route without a twin")
    del twins, got, steps
    return launches


def phase_route(dev, idx, queries, oracle):
    """Phase 1 by batch size on the engine's own partitions: both kernels at
    every Q of ``ROUTE_QS`` (CUDA-graph replays, ``torch.equal`` at every
    point), the crossover per lane count beside what ``auto_phase1`` picks,
    then warm searches at Q=1 and Q=512 under each ``scan_kernel`` with the
    exactness check, and the launches of the ``"auto"`` searches."""
    parts = idx._sync_device()
    q_codes, q_lanes = pack_codes(queries)
    reps_q = -(-max(ROUTE_QS) // len(queries))
    q_all = torch.from_numpy(np.tile(q_codes, (reps_q, 1)).view(np.int32)).to(dev)
    l_all = torch.from_numpy(np.tile(q_lanes, reps_q)).to(dev)
    table = {}  # (lanes, Q) -> (popc ms, mma ms)
    for lanes, p in sorted(parts.items()):
        for nq in ROUTE_QS:
            q_packed = q_all[:nq].contiguous()
            min_lanes, q_scale = query_prefix(l_all[:nq].contiguous(), lanes * 32)
            args = (q_packed, min_lanes, q_scale, p.packed_dev, p.valid_dev)
            if not torch.equal(hs.blockmax(*args), hs.blockmax_mma_packed(*args)):
                raise AssertionError(f"{lanes * 32}-bit partition, Q={nq}: blockmax_mma_packed differs from blockmax")
            reps = 20 if nq <= 64 else 5
            table[lanes, nq] = tuple(
                time_ms(functools.partial(fn, *args), dev, reps, graph=True) for fn in (hs.blockmax, hs.blockmax_mma_packed)
            )
    log(f"[route] phase 1 per partition, ms by the device's clock (CUDA-graph replays), popc / mma, "
        f"blockmax_mma_packed == blockmax at all {len(table)} points; capacities "
        f"{ {lanes: p.cap for lanes, p in sorted(parts.items())} }")
    log("[route]     Q  " + "  ".join(f"{lanes * 32:>4d}-bit popc    mma" for lanes in sorted(parts)) + "   all: popc     mma    auto")
    for nq in ROUTE_QS:
        cells = [table[lanes, nq] for lanes in sorted(parts)]
        auto_ms = sum(table[lanes, nq][auto_phase1(nq, lanes) == "mma"] for lanes in parts)
        log(f"[route] {nq:5d}  " + "  ".join(f"{a:13.4f} {b:6.4f}" for a, b in cells)
            + f"   {sum(a for a, _ in cells):9.4f} {sum(b for _, b in cells):7.4f} {auto_ms:7.4f}")
    for lanes in sorted(parts):
        wins = [nq for nq in ROUTE_QS if table[lanes, nq][1] < table[lanes, nq][0]]
        cross = next((nq for nq in ROUTE_QS if all(m in wins for m in ROUTE_QS if m >= nq)), None)
        picks = [nq for nq in ROUTE_QS if auto_phase1(nq, lanes) == "mma"]
        log(f"[route] {lanes * 32}-bit: the wgmma kernel is faster at Q in {wins}"
            + (f", at every measured Q from {cross}" if cross else ", and loses at the largest measured Q")
            + f"; 'auto' takes it from Q={min(picks) if picks else None}")
        for nq in ROUTE_QS:
            popc_ms, mma_ms = table[lanes, nq]
            took = mma_ms if auto_phase1(nq, lanes) == "mma" else popc_ms
            if took > AUTO_SLACK * min(popc_ms, mma_ms):
                raise AssertionError(
                    f"{lanes * 32}-bit, Q={nq}: 'auto' takes {auto_phase1(nq, lanes)} at {took:.4f} ms, "
                    f"more than {AUTO_SLACK}x the other kernel's {min(popc_ms, mma_ms):.4f} ms: the table in "
                    "engine/device_index.py is out of date"
                )

    # Warm searches through the engine under each scan_kernel (the attribute
    # the constructor argument sets), in rounds that alternate the order, so
    # that the host clock's drift shows as spread between a kernel's rounds
    # and not as a difference between kernels. Exactness checked every time.
    q_keys, valid, ref_np, top_ref, sample = oracle
    kernels = ("popc", "mma", "auto")
    launches = dict.fromkeys(("blockmax", "blockmax_mma_packed"), 0)  # of the 'auto' searches, both batch sizes
    for nq in (N_QUERIES, 1):
        times = {kernel: [] for kernel in kernels}
        rounds = {kernel: [] for kernel in kernels}
        want_res = None  # the first round's 'popc' results
        for rnd in range(ROUTE_ROUNDS):
            for kernel in kernels if rnd % 2 == 0 else kernels[::-1]:
                idx.scan_kernel = kernel
                for fn in hs.PHASE1.values():
                    fn.launches = 0
                idx.search(queries[:nq], K)
                res, t = warm_searches(idx, queries[:nq])
                counts = {name: fn.launches // (len(t) + 1) for name, fn in hs.PHASE1.items()}
                want = dict.fromkeys(hs.PHASE1, 0)
                for lanes in parts:
                    want[auto_phase1(nq, lanes) if kernel == "auto" else kernel] += 1
                if counts != want:
                    raise AssertionError(f"scan_kernel={kernel!r} Q={nq}: phase-1 launches per search {counts}, expected {want}")
                if kernel == "auto":
                    for name in launches:
                        launches[name] += getattr(hs, name).launches
                check_results(f"[route] {kernel} Q={nq}", res, q_keys[:nq], valid, ref_np, top_ref, sample[sample < nq])
                want_res = want_res or res
                if not same_results(res, want_res):
                    raise AssertionError(f"scan_kernel={kernel!r} Q={nq}: results differ from scan_kernel='popc'")
                times[kernel] += t
                rounds[kernel].append(statistics.median(t) * 1e3)
        for kernel in kernels:
            log(f"[route] scan_kernel={kernel!r} Q={nq} k={K}: warm search median {statistics.median(times[kernel]) * 1e3:.3f} ms "
                f"of {len(times[kernel])} (min {min(times[kernel]) * 1e3:.3f}, max {max(times[kernel]) * 1e3:.3f}; medians of the "
                f"{ROUTE_ROUNDS} rounds " + ", ".join(f"{m:.3f}" for m in rounds[kernel]) + "); exact (brute force), equal to 'popc'")
    idx.scan_kernel = "auto"
    if min(launches.values()) <= 0:
        raise AssertionError(f"the 'auto' searches did not launch both phase-1 kernels: {launches}")
    log(f"[route] kernel launches of the 'auto' searches ({8 * ROUTE_ROUNDS} at Q=1, {8 * ROUTE_ROUNDS} at Q={N_QUERIES}): {launches}")
    return launches


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir() if f.is_file())


def phase_persist(rng, dev, idx3, queries3, tmp):
    """BASELINE config 2 (1,048,576 x 256-bit codes, exact NPHD top-k with a
    persisted snapshot) at its own size, then a save and reload of the
    config-3 index of the earlier phases. Every step raises on a fault."""
    n = N_PERSIST
    path = Path(tmp) / "config2"
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    lanes = np.full(n, 8, np.int32)
    keys = np.arange(1, n + 1, dtype=">u8").view(np.uint8).reshape(n, 8)  # row r holds key r + 1
    removed = np.arange(0, n, TOMBSTONE_EVERY)  # rows
    idx = DeviceNphdIndex(path, shard_size=PERSIST_SHARD_BYTES, device="cuda")
    t0 = time.perf_counter()
    idx.add_packed(keys, codes, lanes)
    if idx.remove((removed + 1).tolist()) != len(removed):
        raise AssertionError("config 2: not every tombstoned key was found")
    log(f"[persist] config 2: add_packed {n} x 256-bit codes, {len(removed)} removed: {time.perf_counter() - t0:.3f} s; "
        f"shard_rows {idx.shard_rows}, dirty {idx.dirty}, serialized_length {idx.serialized_length}")
    q_rows = np.arange(N_QUERIES, dtype=np.int64) * (n // N_QUERIES) // TOMBSTONE_EVERY * TOMBSTONE_EVERY + 1
    queries = bodies_of(codes[q_rows], lanes[q_rows])
    sample = np.linspace(0, N_QUERIES - 1, N_ORACLE).astype(np.int64)

    def timed_searches(index, label):
        t0 = time.perf_counter()
        index.search(queries, K)
        first_s = time.perf_counter() - t0
        res, times = warm_searches(index, queries)
        log(f"[persist] {label}: first search {first_s:.4f} s, warm search Q={N_QUERIES} k={K} median "
            f"{statistics.median(times) * 1e3:.3f} ms of {len(times)} (min {times[0] * 1e3:.3f}, max {times[-1] * 1e3:.3f})")
        return res

    def check(label, res, all_codes, valid):
        all_lanes = np.full(len(all_codes), 8, np.int32)
        ref = brute_force(dev, all_codes[q_rows[sample]], all_lanes[q_rows[sample]], all_codes, all_lanes, valid)
        check_results(f"[persist] ({label})", res, q_rows + 1, valid, ref.cpu().numpy(),
                      torch.topk(ref, K, dim=1).values.cpu().numpy(), sample, first_key=1)

    def reopen(label):
        t0 = time.perf_counter()
        index = DeviceNphdIndex(path, shard_size=PERSIST_SHARD_BYTES, device="cuda")
        log(f"[persist] {label}: opened {len(index)} live keys of {index._rows} rows in {index.shard_count} shards "
            f"in {time.perf_counter() - t0:.3f} s")
        return index

    valid = np.ones(n, bool)
    valid[removed] = False
    res_a = timed_searches(idx, "(a) before the save")
    check("a", res_a, codes, valid)
    t0 = time.perf_counter()
    idx.save(wait=True)
    save_s = time.perf_counter() - t0
    names = sorted(f.name for f in path.iterdir())
    n_seg = sum(name.startswith("seg-") for name in names)
    if n_seg < 4 or idx.shard_count != n_seg + 1 or idx.dirty or "state.json" not in names:
        raise AssertionError(f"config 2: {n_seg} sealed segments, shard_count {idx.shard_count}, dirty {idx.dirty}: {names}")
    log(f"[persist] save(wait=True): {save_s:.3f} s, {_dir_bytes(path)} bytes in {len(names)} files "
        f"({n_seg} sealed segments, one active, one validity bitmap, state.json)")
    idx.close()
    idx.close()  # idempotent

    idx = reopen("(b) reopened")
    res_b = timed_searches(idx, "(b) after the reload")
    if not same_results(res_a, res_b):
        raise AssertionError("config 2: the reloaded index answers differently from the saved one")
    log(f"[persist] (a) == (b): the same keys and scores for all {N_QUERIES} queries, and (a) equals brute force")

    new_codes = rng.integers(0, 2**32, (N_APPEND, 8), dtype=np.uint32)
    idx.add(list(range(n + 1, n + N_APPEND + 1)), bodies_of(new_codes, np.full(N_APPEND, 8, np.int32)))
    more_removed = np.arange(7, n, 1021)  # rows still live that are no query's own
    more_removed = more_removed[valid[more_removed] & ~np.isin(more_removed, q_rows)]
    if idx.remove((more_removed + 1).tolist()) != len(more_removed):
        raise AssertionError("config 2: not every key of the second removal was found")
    t0 = time.perf_counter()
    idx.save(wait=False)
    scheduled_s = time.perf_counter() - t0
    idx.drain_rotations()
    log(f"[persist] +{N_APPEND} rows via add, -{len(more_removed)} keys; save(wait=False) returned in {scheduled_s:.3f} s, "
        f"drained in {time.perf_counter() - t0:.3f} s; {_dir_bytes(path)} bytes on disk")
    idx.close()
    all_codes = np.concatenate([codes, new_codes])
    valid = np.concatenate([valid, np.ones(N_APPEND, bool)])
    valid[more_removed] = False
    idx = reopen("(c) reopened")
    if len(idx) != int(valid.sum()):
        raise AssertionError(f"config 2 (c): {len(idx)} live keys, expected {int(valid.sum())}")
    check("c", timed_searches(idx, "(c) after add, remove, background save, reload"), all_codes, valid)

    t0 = time.perf_counter()
    idx.compact()
    compact_s = time.perf_counter() - t0
    if idx.tombstone_fraction != 0.0 or idx._rows != int(valid.sum()):
        raise AssertionError("config 2: compact() left tombstones")
    t0 = time.perf_counter()
    idx.save(wait=True)
    log(f"[persist] compact(): {compact_s:.3f} s; save(wait=True): {time.perf_counter() - t0:.3f} s; "
        f"{_dir_bytes(path)} bytes on disk")
    idx.close()
    idx = reopen("(d) reopened")
    check("d", timed_searches(idx, "(d) after compact, save, reload"), all_codes, valid)
    idx.close()
    log("[persist] (c) and (d) equal brute force over all rows (self-match, no removed key, score multisets, "
        f"every row's score, {N_ORACLE} sampled queries)")

    # The config-3 index of the slice: saved, closed, opened anew.
    before = idx3.search(queries3, K)
    t0 = time.perf_counter()
    idx3.save(wait=True)
    save_s = time.perf_counter() - t0
    rows3, live3, nbytes = idx3._rows, len(idx3), _dir_bytes(idx3.path)
    idx3.close()
    t0 = time.perf_counter()
    again = DeviceNphdIndex(idx3.path, device="cuda")
    load_s = time.perf_counter() - t0
    if (again._rows, len(again)) != (rows3, live3) or not same_results(before, again.search(queries3, K)):
        raise AssertionError("config 3: the reloaded index differs from the saved one")
    log(f"[persist] config 3 ({rows3} rows, {live3} live): save(wait=True) {save_s:.3f} s, {nbytes} bytes; "
        f"reload {load_s:.3f} s; the reloaded index returns the same keys and scores")
    again.close()


def _experiment_data(dev, n, nq, seed):
    """256-bit rows on the card from torch.randint words, 5% tombstones and
    a dead block (block 3), and nq queries drawn from the rows, the odd ones
    192-bit prefixes: (packed, valid, q_packed, min_lanes, q_scale, q_i8)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(-(2**31), 2**31, (n, 8), dtype=torch.int32, device=dev, generator=gen)
    valid = (torch.rand(n, device=dev, generator=gen) > 0.05).to(torch.uint8)
    valid[3 * 128 : 4 * 128] = 0
    q_lanes = torch.where(torch.arange(nq, device=dev) % 2 == 1, 6, 8).to(torch.int32)
    min_lanes, q_scale = query_prefix(q_lanes, 256)
    q_packed = packed[torch.randint(0, n, (nq,), device=dev, generator=gen)]
    return packed, valid, q_packed, min_lanes, q_scale, masked_queries(q_packed, min_lanes, 256).to(torch.int8)


def _variant_pen(name, orient, valid):
    pen16 = torch.where(valid.bool(), 0.0, -65536.0).to(torch.bfloat16)
    return valid[None, :] if name == "u8max" else (pen16[:, None] if orient == "col" else pen16[None, :])


def _experiment_cases(dev, n, nq, seed, err, label, timed, which=(8, 9, 10)):
    """The kernels ``which`` of 8-11 (10 stands for 10 and 11) against
    their plain versions on one data set (kernels 10 and 11 also against
    ``blockmax`` on the packed rows); ``timed``: also the plain versions'
    times (the kernels' come from the entry points). Returns {kernel or
    variant: plain ms}."""
    packed, valid, q_packed, min_lanes, q_scale, q = _experiment_data(dev, n, nq, seed)
    qs = q_scale[:, None].contiguous()
    plain = {}
    live = valid.bool().reshape(-1, 128).any(dim=1)
    if 8 in which:
        db = hs.build_unpacked_db(packed, 256)
        first = {}  # launch key -> first name: names of one key share a plain time
        for name in ex8.NAMES:
            fn, orient = ex8.make_variant(name, n, nq)
            args = (q, qs, db, _variant_pen(name, orient, valid))
            _compare(f"blockmax_variant {name} {label}", fn(*args), ex8.blockmax_variant_plain(name, *args), err)
            key = ex8.launch_key(name)
            if timed and key in first:
                plain[name] = plain[first[key]]
            elif timed:
                first[key] = name
                plain[name] = time_ms(functools.partial(ex8.blockmax_variant_plain, name, *args), dev, 1)
        del db
    if 9 in which:
        db_i8 = hs.build_unpacked_db(packed, 256)
        q4, db4 = bitplane.build_int4_twin(q), bitplane.build_int4_twin(db_i8)
        for nq4 in sorted({Q9, nq}):
            q4n = q4[:nq4].contiguous()
            full = ex9.int4_dot(q4n, db4)
            _compare(f"int4_dot Q={nq4} {label}", full, ex9.int4_dot_plain(q4n, db4), err)
            _compare(f"int4_probe Q={nq4} {label}", ex9.int4_probe(q4n, db4), ex9.int4_probe_plain(q4n, db4), err)
        # The library yardstick: torch._int_mm on the int8 form (its A operand
        # needs more than 16 rows: the queries are zero-padded to 32).
        q_pad = torch.zeros((32, 256), dtype=torch.int8, device=dev)
        q_pad[:Q9] = q[:Q9]
        library = functools.partial(torch._int_mm, q_pad, db_i8.T)
        _compare(f"int4_dot {label} vs torch._int_mm", ex9.int4_dot(q4[:Q9].contiguous(), db4), library()[:Q9], err)
        if timed:
            # ms-scale plain versions of few launches: enough calls to average
            # out the host's launch latency
            plain["int4_dot"] = time_ms(functools.partial(ex9.int4_dot_plain, q4[:Q9].contiguous(), db4), dev, 5)
            plain["int4_probe"] = time_ms(functools.partial(ex9.int4_probe_plain, q4[:Q9].contiguous(), db4), dev, 20)
            plain["library"] = time_ms(library, dev, 20)
        del q4, db4, db_i8, q_pad, library
    if 10 in which:
        popc = hs.blockmax(q_packed, min_lanes, q_scale, packed, valid)
        bt = bitplane.bit_transpose_packed(packed)
        pen = bitplane.bitplane_penalty_perm(torch.where(valid.bool(), 0.0, -65536.0)).to(torch.bfloat16)[None, :]
        got = ex10.blockmax_bitplane(q, q_scale, bt, pen)
        _compare(f"blockmax_bitplane {label}", got, ex10.blockmax_bitplane_plain(q, q_scale, bt, pen), err)
        _compare(f"blockmax_bitplane {label} vs blockmax (blocks with a valid row)", got[:, live], popc[:, live], err)
        if timed:
            plain["blockmax_bitplane"] = time_ms(functools.partial(ex10.blockmax_bitplane_plain, q, q_scale, bt, pen), dev, 1)
        del bt
        for wb in (8, 16):
            twin = bitplane.build_twin(packed, wb)
            pen = ex11.subword_penalty(valid, wb)
            got = ex11.blockmax_subword(q, q_scale, twin, pen, wb)
            _compare(f"blockmax_subword u{wb} {label}", got, ex11.blockmax_subword_plain(q, q_scale, twin, pen, wb), err)
            _compare(f"blockmax_subword u{wb} {label} vs blockmax", got, popc, err)
            if timed:
                plain[f"u{wb}"] = time_ms(functools.partial(ex11.blockmax_subword_plain, q, q_scale, twin, pen, wb), dev, 1)
            del twin
    return plain


def phase_experiments(dev):
    """TPU kernels 8-11 through the experiment entry points (module
    docstring, phase 6)."""
    err = dict.fromkeys(EXPERIMENT_KERNELS, 0.0)
    t0 = time.perf_counter()
    _experiment_cases(dev, 32768, 77, seed=6, err=err, label="edge", timed=False)
    log(f"[experiments] edge cases (N=32768, Q=77, 192-bit prefixes, tombstones, a dead block): kernel == plain "
        f"for all {len(ex8.NAMES)} variants of kernel 8, int4_dot and int4_probe (Q=8 and 77), blockmax_bitplane "
        f"and blockmax_subword u8/u16; kernel 10 == blockmax on blocks with a valid row, kernel 11 == blockmax "
        f"everywhere ({time.perf_counter() - t0:.1f} s)")

    # The entry points at the scripts' sizes, counters at 0 just before.
    for fn in WRAPPERS.values():
        fn.launches = 0
    res8 = ex8.main(["--n", str(N8), "--q", str(Q8), "--reps", "10", "base", *ex8.NAMES])
    res9 = ex9.main(["--n", str(N9), "--q", str(Q9), "--reps", "20"])
    res9_large = ex9.main(["--n", str(N9_LARGE), "--q", str(Q9), "--reps", "10"])
    res10 = ex10.main(["--n", str(N10), "--q", str(Q10), "--reps", "10"])
    res11 = ex11.main(["--n", str(N10), "--q", str(Q10), "--reps", "10"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    log(f"[experiments] kernel launches of the entry points: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the experiment entry points never launched the {name} kernel")

    # Kernel == plain at the scripts' sizes, and the plain versions' times.
    plain8 = _experiment_cases(dev, N8, Q8, seed=8, err=err, label=f"N={N8}", timed=True, which=(8,))
    plain9 = _experiment_cases(dev, N9, Q9, seed=9, err=err, label=f"N={N9}", timed=True, which=(9,))
    plain9_large = _experiment_cases(dev, N9_LARGE, Q9, seed=9, err=err, label=f"N={N9_LARGE}", timed=True, which=(9,))
    plain10 = _experiment_cases(dev, N10, Q10, seed=10, err=err, label=f"N={N10}", timed=True, which=(10,))
    log(f"[experiments] kernel == plain at the scripts' sizes; plain ms: kernel 8 (N={N8}, Q={Q8}) "
        + ", ".join(f"{k} {v:.4f}" for k, v in plain8.items() if k in ex8.NAMES)
        + f"; int4 N={N9} Q={Q9}: dot {plain9['int4_dot']:.4f}, probe {plain9['int4_probe']:.4f}, "
        f"torch._int_mm on the int8 form {plain9['library']:.4f}; N={N9_LARGE}: dot {plain9_large['int4_dot']:.4f}, "
        f"probe {plain9_large['int4_probe']:.4f}, torch._int_mm {plain9_large['library']:.4f}; "
        f"kernels 10/11 (N={N10}, Q={Q10}): bitplane {plain10['blockmax_bitplane']:.4f}, "
        f"u8 {plain10['u8']:.4f}, u16 {plain10['u16']:.4f}")

    # Bounds from the shapes: bytes (inputs once, outputs once) and operations.
    macs10 = Q10 * N10 * 256
    out10 = Q10 * (N10 // 128) * 4
    bounds = {
        "blockmax_variant": variant_bound("bf16", N8, Q8),
        "int4_dot": bound(N9 * 128 + Q9 * 128 + Q9 * N9 * 4, 2 * Q9 * N9 * 256, INT8_OPS_S),
        "int4_probe": bound(N9 * 128 + Q9 * 128 + Q9 * (N9 // 128) * 4, 2 * Q9 * N9 * 256, INT8_OPS_S),
        "blockmax_bitplane": bound(N10 * 32 + N10 * 2 + Q10 * 260 + out10, 2 * macs10, INT8_OPS_S),
        "blockmax_subword": bound(N10 * 32 + N10 * 4 + Q10 * 260 + out10, 2 * macs10, INT8_OPS_S),
    }
    ms = {"blockmax_variant": res8["bf16"], "int4_dot": res9["int4_dot"], "int4_probe": res9["int4_probe"],
          "blockmax_bitplane": res10["int8_p8"], "blockmax_subword": res11["u8"]}
    plain_ms = {"blockmax_variant": plain8["bf16"], "int4_dot": plain9["int4_dot"],
                "int4_probe": plain9["int4_probe"], "blockmax_bitplane": plain10["blockmax_bitplane"],
                "blockmax_subword": plain10["u8"]}
    stats = {}
    for name in EXPERIMENT_KERNELS:
        stats[name] = {"max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
                       "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                       "library_ms": plain9["library"] if name == "int4_dot" else None}
    variants = stats["blockmax_variant"]["variants"] = {}
    for name in ex8.NAMES:
        bound_ms, bound_by = variant_bound(name, N8, Q8)
        variants[name] = {"ms": res8[name], "plain_ms": plain8[name], "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"[experiments] blockmax_variant {name}: {res8[name]:.4f} ms (plain {plain8[name]:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by})")
    stats["blockmax_variant"]["base_ms"] = res8["base"]
    for name in ("int4_dot", "int4_probe"):
        stats[name][f"at_n{N9_LARGE}"] = {"ms": res9_large[name], "plain_ms": plain9_large[name]}
    log(f"[experiments] int4_dot, N={N9} / N={N9_LARGE}: {res9['int4_dot']:.4f} / {res9_large['int4_dot']:.4f} ms; "
        f"torch._int_mm on the int8 form {plain9['library']:.4f} / {plain9_large['library']:.4f} ms")
    stats["int4_dot"][f"at_n{N9_LARGE}"]["library_ms"] = plain9_large["library"]
    stats["blockmax_bitplane"]["modes"] = sorted(k for k in res10 if k != "blockmax")  # one launch, timed once
    stats["blockmax_bitplane"]["blockmax_ms"] = res10["blockmax"]
    stats["blockmax_subword"]["variants"] = {f"u{wb}": {"ms": res11[f"u{wb}"], "plain_ms": plain10[f"u{wb}"]}
                                             for wb in (8, 16)}
    stats["blockmax_subword"]["blockmax_ms"] = res11["blockmax"]
    for name, st in stats.items():
        log(f"[experiments] {name}: {st['ms']:.4f} ms (plain {st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms "
            f"by {st['bound_by']}), max |kernel - plain| = {st['max_abs_err']}")
    return launches, stats


def phase_profile(idx, queries, scan_kernel, reps=5):
    """Where one warm search's time goes, under ``scan_kernel``.

    - Host split (host clock): query packing and kernel launches, waiting
      for the device, and the host merge of the partitions' candidates.
    - Device time by kernel over ``reps`` searches (``torch.profiler``,
      kernel events only), and the device's busy share of that window. The
      trace goes to ``build/chip_smoke_trace_<scan_kernel>_q<Q>.json``.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx.scan_kernel = scan_kernel
    tag = f"[profile {scan_kernel} Q={len(queries)}]"
    collect = idx._collect_results
    split = {"prep_launch": [], "device_wait": [], "host_merge": []}

    def timed_collect(*args):
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = collect(*args)
        t3 = time.perf_counter()
        split["prep_launch"].append(t1 - t0)
        split["device_wait"].append(t2 - t1)
        split["host_merge"].append(t3 - t2)
        return out

    idx._collect_results = timed_collect
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            idx.search(queries, K)
    finally:
        del idx._collect_results
    log(f"{tag} host split of a warm search (median ms): "
        + ", ".join(f"{name} {statistics.median(v) * 1e3:.3f}" for name, v in split.items()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            idx.search(queries, K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            us, n = by_kernel.get(evt.name, (0.0, 0))
            by_kernel[evt.name] = (us + evt.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    log(f"{tag} {reps} searches under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of the window)")
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"{tag} {us / 1e3 / reps:9.4f} ms/search  x{n // reps:<3d} {name[:90]}")
    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / f"chip_smoke_trace_{scan_kernel}_q{len(queries)}.json"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the generated codes and queries")
    parser.add_argument("--profile", action="store_true", help="also profile warm searches (device time by kernel)")
    args = parser.parse_args()

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    codes, lanes = random_codes(rng, N_ROWS)
    part_rows = {int(lv): int(c) for lv, c in zip(*np.unique(lanes, return_counts=True))}
    log(f"[data] {N_ROWS} codes, rows per lane count: {part_rows}")
    stats = phase_kernels(rng, dev, part_rows)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, idx, queries, oracle = phase_slice(rng, dev, codes, lanes, Path(tmp) / "config3")
        del codes, lanes
        launches.update(phase_twin(dev, idx, queries))
        launches.update(phase_route(dev, idx, queries, oracle))
        if args.profile:
            for scan_kernel, batch in (("popc", queries), ("auto", queries), ("auto", queries[:1])):
                phase_profile(idx, batch, scan_kernel)
        phase_persist(rng, dev, idx, queries, tmp)
        del idx, oracle
    exp_launches, exp_stats = phase_experiments(dev)
    launches.update(exp_launches)
    stats.update(exp_stats)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    summary = []
    for name, meta in {**KERNELS, **EXPERIMENT_KERNELS}.items():
        entry = {"name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"]}
        if "also_replaces" in meta:
            entry["also_replaces"] = meta["also_replaces"]
        entry.update({"launches": launches[name], **stats[name]})
        summary.append(entry)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
