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
   invalid blocks (the three tensor-core phase-1 entries also against the
   popc ``blockmax``), then at the shapes of the config-3 partitions
   (Q=512, 16 candidate blocks per query; ``blockmax_small`` at Q=32, in
   its range) with the time of each beside its plain version's (and beside
   ``blockmax``'s). ``gather_rescore`` and ``blockmax_small`` run shorter
   than their Python wrappers, so their times are CUDA-graph replays of
   their calls (the device's clock); ``gather_rescore``'s host-paced
   reading is printed beside it. ``gather_rescore`` at each partition is a
   point of the [gather] sweep (below);
   gather  — the [gather] sweep of candidate reuse (Q * kk pairs per block
   of the partition): at each point both forms of ``gather_rescore``
   (query-major and block-major, ``form=``) and the route (``form=None``),
   each ``torch.equal`` to ``gather_rescore_plain`` and to the other form,
   each form's time by CUDA-graph replays beside the bound and its share;
   it fails if the route's form is more than 1.5x the faster form's time
   anywhere (``GATHER_BLOCK_REUSE`` of ``ops/hopper_scan.py`` then is out of
   date). Points: config 3's four partitions (phase 3); a ladder on
   synthetic random partitions at the product's capacity, Q=64, the top
   128-4,096 blocks of ``blockmax_mma_packed`` at every width (run right
   after phase 3); config 4's partition at Q=512, kk=256 and Q=128,
   kk=2,048 (phase 9); the product's chunk partition at Q=100, kk=512 and
   Q=64, kk=4,096 (phase 10). The table of all points is printed before the
   JSON summary;
4. slice   — ``DeviceNphdIndex(path, device="cuda")`` (``scan_kernel``
   left at ``"auto"``) filled through ``add_packed``, 1/64 of the keys
   removed, 4,096 rows appended through ``add``, then ``search`` of 512
   live rows at k=10: self-match at rank 0 with score 1.0, the top-10 of 16
   sampled queries against brute-force ``nphd_scores`` over the whole
   database, no removed key returned, and the search launched the phase-1
   kernels ``auto_phase1`` names and ``gather_rescore``, and no other;
5. twin    — the int8-twin route over the engine's own four partitions:
   ``build_unpacked_db`` on the card (seconds and bytes printed), then
   ``blockmax_topk_packedq_impl(..., db_unpacked=twin, unpacked=True)``
   for the slice's 512 queries at the engine's k and the packed-row
   tensor-core phase 1 (``blockmax_mma_packed``) on each partition, both
   kernels launched; results ``torch.equal`` to the route without a twin
   and to ``blockmax``, with the time of each route;
6. route   — phase 1 by batch size, on the engine's four partitions:
   ``blockmax`` (XOR + popc), ``blockmax_small`` (A unpacked in registers:
   ``mma.sync``, ``wgmma`` from 33 queries) and ``blockmax_mma_packed``
   (``wgmma``, rows staged in shared memory) at Q in 1..1024, CUDA-graph replays,
   ``torch.equal`` to ``blockmax`` at every point; the table Q x width x
   {popc, small, mma ms}, the fastest per width and Q, and what
   ``scan_kernel="auto"`` takes (it fails if that is more than 1.5x the
   fastest kernel's time anywhere). Then warm searches at Q=512, 32 and 1
   under ``"popc"``, ``"mma_small"``, ``"mma"`` and ``"auto"``, four rounds
   of 7 in alternating order, each checked against brute force, equal to
   the ``"popc"`` results and launching the phase-1 kernels its
   ``scan_kernel`` names; the ``"auto"`` searches launch each kernel
   ``auto_phase1`` names there and no other. The JSON summary's config-3
   ``launches`` are those of the slice's and the ``"auto"`` searches, and
   each phase-1 kernel's ``by_q`` holds its [route] times per sweep with
   their bounds;
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
8. experiments (run last) — the phase-1 experiment entry points of
   ``iscc_search_tpu_torch.experiments`` (TPU kernels 8-11): each kernel
   against its plain version (``torch.equal``) on edge cases (Q=77,
   192-bit prefixes, tombstones, a dead block; kernels 8, 10 and 11 also
   on penalties that take their per-element path; kernels 10 and 11 also
   against ``blockmax`` on the same packed rows), then each module's
   ``main()`` at the script's own size with the counters set to 0 just
   before and read just after, then each kernel against its plain version
   at that size, with the plain version's time. Each kernel-8 launch is
   logged with its bound and share, beside ``base`` and, for the bf16-unit
   probes, the floor computed at the bf16 peak; kernel 11's u8 and u16
   beside their bound, plain version and kernel 10's time; the blocks that
   took kernel 8's, 10's and 11's fast path are counted by the kernel and
   must equal the plan's rule.

9. simprint — BASELINE config 4 at the engine level: 1,000,000 assets x
   100 random 128-bit chunk simprints (100,000,000 rows, keys shaped as
   ``benchmarks/config4_100m.py`` builds them) through
   ``SimprintEngine.add_packed``, 1/64 of the rows removed, 32 planted
   query assets (a stored asset's chunks with 0-12 bits flipped each);
   ``search_raw_many`` at 10 and 100 chunks per query asset in batches of
   1, 8 and 32 (limit 10, threshold 0.75, a constant document frequency),
   median warm ms and query assets per second, the device split, memory and
   launches (each phase-1 kernel ``auto_phase1`` names for the sweeps'
   batches, and no other). Every matched chunk's score equals the host's
   XOR + popcount, every asset score its recomputation from the chunks,
   every planted asset is at rank 0 with all its live chunks, no removed
   chunk comes back. Then the three phase-1 kernels at Q=10 and Q=100 (one
   asset's chunks), ``blockmax_mma_packed`` at Q=512 (a full sweep) and
   ``gather_rescore`` (the count's top blocks at limit 10 and 100, two
   [gather] points) against their plain versions on the 100,000,000-row
   partition, with their times and bounds;
10. product — ``TpuIndex`` on the card: 20,000 assets (units of 64-256 bits,
   INSTANCE, 100 x 128-bit simprints, metadata; config 4 cut to 2% of its
   assets) through ``add_assets`` in batches of 1,000, 1% re-added with
   changed units (and half of those with changed simprints), then
   ``search_assets`` by units, simprints and both, limit 10 and 100, scan
   and exact, and by ISCC-ID, each against brute force (NPHD per type, the
   threshold and confidence weighting, INSTANCE prefixes; the simprint
   checks of phase 9 with the store's document frequencies; and every chunk
   sweep's candidates, 400 or 4,000 per chunk query, against brute-force
   ``hamming_scores`` over all stored chunks); 8 concurrent clients through
   the batcher (answers equal the sequential ones); the phase-1 kernel
   ``"auto"`` takes for a request's 100 chunk queries and ``gather_rescore`` (a
   limit-10 request's 100 chunk queries at 512 candidate blocks, and one
   64-query slice of phases 2-3 at the 4,096 candidate blocks of count
   4,000: two [gather] points) against their plain versions on the
   product's chunk partition, then that slice's phases 2-3 split by part
   (phase 2, candidates, ``gather_rescore``, score epilogue, ``torch.topk``,
   row gather) and under the profiler;
   ``flush``/``close``/reopen (identical answers); a 1,000-asset copy
   opened with ``device="cpu"`` answering ``model_dump()``-identically.

Phases 9 and 10 run after phase 7 and set the launch counts to 0 just before
they drive their path and read them just after (phase 10's kernel-against-
plain launches are not counted); the JSON summary's ``launches`` of the path
kernels is the sum over the three search paths, ``launches_by_path`` splits
it, and ``at_simprint_shapes`` and ``at_product_shapes`` hold phases 9 and
10's kernel-against-plain numbers, one entry per shape (for
``gather_rescore`` the routed form's, with both forms' times).
``gather_rescore`` also carries ``by_form``, every [gather] point, and
``launches_by_form``, each path's calls by form.

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
``"auto"`` at Q=32 and Q=1.

Usage: ``python3 chip_smoke.py [--seed N] [--profile]``
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import shutil
import statistics
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from iscc_search_tpu_torch import codec as ic
from iscc_search_tpu_torch import schema
from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine import device_index, simprint_ops
from iscc_search_tpu_torch.engine.simprint import SimprintEngine
from iscc_search_tpu_torch.engine.device_index import _cap_rows, _pow2ceil, auto_phase1
from iscc_search_tpu_torch.experiments import exp_bitplane_int8 as ex10
from iscc_search_tpu_torch.experiments import time_ms
from iscc_search_tpu_torch.experiments import exp_bitplane_u8 as ex11
from iscc_search_tpu_torch.experiments import exp_int4 as ex9
from iscc_search_tpu_torch.experiments import exp_kernels as ex8
from iscc_search_tpu_torch.experiments import bitplane_layout, variant_layout
from iscc_search_tpu_torch.indexes.tpu import TpuIndex
from iscc_search_tpu_torch.models import IsccID, IsccUnit
from iscc_search_tpu_torch.ops import _build, bitplane
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops import wgmma_layout
from iscc_search_tpu_torch.ops.nphd import hamming_scores, nphd_scores
from iscc_search_tpu_torch.ops.packing import pack_codes
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, query_prefix, topk_blocks_hier
from iscc_search_tpu_torch.server import metrics

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
    "blockmax_small": {  # what kernels 1-2 compute, for small batches
        "source": "iscc_search_tpu_torch/csrc/blockmax_small.cu",
        "replaces": "iscc_search_tpu/ops/pallas_scan.py:310",
        "also_replaces": ["iscc_search_tpu/ops/pallas_scan.py:410"],
    },
}
PHASE1 = ("blockmax", "blockmax_mma_unpacked", "blockmax_mma_packed", "blockmax_small")
ROUTE_KERNELS = {"popc": "blockmax", "mma_small": "blockmax_small", "mma": "blockmax_mma_packed"}  # scan_kernel -> wrapper
SMALL_Q = 32  # the batch at which [kernels] times blockmax_small (its range; the others at Q=512)
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
# BASELINE config 4 (BASELINE.md, "SIMPRINT granular: 1M assets x ~100 chunk
# simprints") and the traffic of benchmarks/config4_100m.py.
C4_ASSETS, C4_CHUNKS = 1_000_000, 100
C4_SLICE_ASSETS = 40_000  # assets per add_packed call (4M rows): bounds the temporaries
C4_PLANTED = 32  # query assets, each a near copy of one stored asset
C4_MAX_FLIPS = 12  # bits flipped per planted chunk: 0..12 of 128
C4_WIDTHS = (10, 100)  # chunks per query asset
C4_BATCHES = (1, 8, 32)  # query assets per search_raw_many call
C4_TRIALS = 5  # warm calls per (width, batch), after one more
C4_LIMIT, C4_THRESHOLD = 10, 0.75
# The product cell: config 4 cut to 2% of its assets (the store ingest is per-asset Python).
PRODUCT_ASSETS, PRODUCT_BATCH, PRODUCT_SIMPRINTS = 20_000, 1000, 100
PRODUCT_SP = "CONTENT_TEXT_V0"
PRODUCT_CPU_ASSETS = 1000  # the copy opened with device="cpu"
PRODUCT_REPS = 7  # single requests per query shape
PRODUCT_CLIENTS, PRODUCT_PER_CLIENT = 8, 8
PRODUCT_T0 = 1_700_000_000_000_000  # ISCC-ID timestamps (microseconds) of the product assets
PATH_KERNELS = ("blockmax", "blockmax_mma_packed", "blockmax_small", "gather_rescore")  # what a search launches
GATHER_REPS = 20  # CUDA-graph-captured calls per form and [gather] point
# The [gather] ladder: synthetic random partitions at the product's capacity,
# Q=64, candidate blocks per query from reuse ~0.5 to ~15, at every width.
GATHER_Q, GATHER_LADDER_KK = 64, (128, 256, 512, 768, 1024, 4096)
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12  # dense bf16 tensor-core peak: the floor of the kernel-8 variants that dot on the bf16 units
POPC_PER_CLOCK_SM = 16  # CUDA C++ Programming Guide, compute capability 9.0
CARD = {}  # filled by phase_device: SMs and maximum SM clock
PATH_FORMS = {}  # path label -> gather_rescore calls by form, read beside its launches


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


def phase1_work(cap, lanes, nq):
    """(bytes, operations) of phase 1 over one packed partition: the rows and
    their validity read once, the queries (words, prefix lanes, scale) read
    once, the (nq, cap / 128) f32 maxima written once; two operations per ±1
    product of every (query, row) dot."""
    return cap * lanes * 4 + cap + nq * (lanes * 4 + 8) + nq * (cap // 128) * 4, nq * cap * 2 * lanes * 32


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


def gather_work(nq, kk, lanes, blocks):
    """(bytes, operations) of gather_rescore: the rows of the ``blocks``
    distinct candidate blocks, the block ids and the queries (words and
    prefix lanes) read once, the (nq, kk * 128) f32 dots written once; one
    popc per (candidate row, lane)."""
    return blocks * 128 * lanes * 4 + nq * kk * 4 + nq * (lanes * 4 + 4) + nq * kk * 512, nq * kk * 128 * lanes


def gather_point(label, dev, q_packed, min_lanes, block_ids, db, want=None):
    """One point of the [gather] sweep: both forms of ``gather_rescore`` and
    the route (``form=None``) on the same inputs, each ``torch.equal`` to the
    plain version (``want``, computed if None) and to the other form; each
    form's time by CUDA-graph replays, beside the bound. Fails on a card if
    the route's form takes more than ``AUTO_SLACK`` x the faster form's
    time. Returns the point's dict (``ms`` is the routed form's)."""
    nq, kk = block_ids.shape
    cap, lanes = db.shape
    nblocks = cap // hs.BLOCK
    routed = hs.gather_form(nq, kk, nblocks, lanes)
    if want is None:
        want = hs.gather_rescore_plain(q_packed, min_lanes, block_ids, db)
    outs = {form: hs.gather_rescore(q_packed, min_lanes, block_ids, db, form=form) for form in hs.GATHER_FORMS}
    outs["route"] = hs.gather_rescore(q_packed, min_lanes, block_ids, db)
    sync(dev)
    for form, got in outs.items():
        if not torch.equal(got, want):
            raise AssertionError(f"[gather] {label}: the {form} form != plain")
    if not torch.equal(outs["query"], outs["block"]):
        raise AssertionError(f"[gather] {label}: the query-major and block-major forms differ")
    err = max(float((got - want).abs().max()) for got in outs.values())
    del outs
    blocks = int(torch.unique(block_ids).numel())
    nbytes, ops = gather_work(nq, kk, lanes, blocks)
    bound_ms, bound_by = bound(nbytes, ops, popc_per_s() if dev.type == "cuda" else 1e12)
    reps = GATHER_REPS if dev.type == "cuda" else 1
    ms = {form: time_ms(functools.partial(hs.gather_rescore, q_packed, min_lanes, block_ids, db, form=form), dev,
                        reps, graph=True) for form in hs.GATHER_FORMS}
    fastest = min(ms, key=ms.get)
    log(f"[gather] {label}: cap {cap}, {lanes * 32}-bit, Q={nq}, kk={kk}, reuse {nq * kk / nblocks:.3f} "
        f"({blocks} distinct blocks): query {ms['query']:.4f} ms ({100 * bound_ms / ms['query']:.0f}% of bound), "
        f"block {ms['block']:.4f} ms ({100 * bound_ms / ms['block']:.0f}%), bound {bound_ms:.4f} ms by {bound_by}; "
        f"route takes {routed}; both forms and the route == plain and each other")
    if dev.type == "cuda" and ms[routed] > AUTO_SLACK * ms[fastest]:
        raise AssertionError(
            f"[gather] {label}: the route takes the {routed} form at {ms[routed]:.4f} ms, more than {AUTO_SLACK}x "
            f"the {fastest} form's {ms[fastest]:.4f} ms: GATHER_BLOCK_REUSE in ops/hopper_scan.py is out of date")
    return {"point": label, "q": nq, "kk": kk, "cap": cap, "lanes": lanes, "reuse": nq * kk / nblocks,
            "blocks": blocks, "form": routed, "ms": ms[routed], "query_ms": ms["query"], "block_ms": ms["block"],
            "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms[routed],
            "query_share": bound_ms / ms["query"], "block_share": bound_ms / ms["block"], "max_abs_err": err}


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
    """The four phase-1 kernels and the two plain versions on one input."""
    args = (q_packed, min_lanes, q_scale)
    return {
        "blockmax": lambda: hs.blockmax(*args, db, valid),
        "blockmax_mma_unpacked": lambda: hs.blockmax_mma_unpacked(*args, twin, valid),
        "blockmax_mma_packed": lambda: hs.blockmax_mma_packed(*args, db, valid),
        "blockmax_small": lambda: hs.blockmax_small(*args, db, valid),
        "blockmax_plain": lambda: hs.blockmax_plain(*args, db, valid),
        "blockmax_mma_unpacked_plain": lambda: hs.blockmax_unpacked_plain(*args, twin, valid),
        "blockmax_mma_packed_plain": lambda: hs.blockmax_plain(*args, db, valid),
        "blockmax_small_plain": lambda: hs.blockmax_plain(*args, db, valid),
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
        want = hs.gather_rescore_plain(q_packed, min_lanes, block_ids, db)
        for form in (None, *hs.GATHER_FORMS):
            _compare(f"gather_rescore {nbits}-bit edge, form {form}",
                     hs.gather_rescore(q_packed, min_lanes, block_ids, db, form=form), want, err)
    log("[kernels] edge cases: kernel == plain for 64/128/192/256-bit (Q=77, tombstones, dead block; gather_rescore "
        "in both forms and the route); blockmax_mma_unpacked == blockmax_mma_packed == blockmax_small == blockmax")

    # Main-path shapes: the capacities of the config-3 partitions, Q=512, kk=16.
    ms = dict.fromkeys(KERNELS, 0.0)
    plain_ms = dict.fromkeys(KERNELS, 0.0)
    gather_host_ms = 0.0  # gather_rescore paced by the host's launches
    gather_points = []  # the [gather] sweep's config-3 points, one per partition
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
        point = gather_point(f"config3 {nbits}-bit", dev, q_packed, min_lanes, block_ids, db,
                             want=calls["gather_rescore_plain"]())
        err["gather_rescore"] = max(err["gather_rescore"], point["max_abs_err"])
        gather_points.append(point)
        # blockmax_small at a batch in its range (the others at Q=512): the
        # first SMALL_Q queries, against plain and the popc kernel.
        small = _phase1_outputs(q_packed[:SMALL_Q], min_lanes[:SMALL_Q], q_scale[:SMALL_Q], db, valid, twin)
        got = small["blockmax_small"]()
        _compare(f"blockmax_small {nbits}-bit Q={SMALL_Q}", got, small["blockmax_small_plain"](), err)
        _compare(f"blockmax_small {nbits}-bit Q={SMALL_Q} vs blockmax", got, small["blockmax"](), err)
        calls["blockmax_small"], calls["blockmax_small_plain"] = small["blockmax_small"], small["blockmax_small_plain"]
        t = {name: time_ms(calls[name], dev, 10) for name in PHASE1 if name != "blockmax_small"}
        t["blockmax_small"] = time_ms(calls["blockmax_small"], dev, 20, graph=True)  # shorter than its wrapper
        t["gather_rescore"] = point["ms"]  # the routed form, by the device's clock
        gather_host_ms += time_ms(calls["gather_rescore"], dev, 20)
        t.update({f"{name}_plain": time_ms(calls[f"{name}_plain"], dev, 5 if name == "gather_rescore" else 3) for name in KERNELS})
        for name in KERNELS:
            ms[name] += t[name]
            plain_ms[name] += t[name + "_plain"]
        # Bytes each input read once and each output written once; operations
        # of the function: two per ±1 product of a (query, row) dot, at the
        # int8 rate for every phase-1 kernel, whatever unit it runs them on.
        for name, nq, extra in (("blockmax", N_QUERIES, 0), ("blockmax_mma_packed", N_QUERIES, 0),
                                ("blockmax_mma_unpacked", N_QUERIES, cap * (nbits - lanes * 4)),  # the twin's bytes
                                ("blockmax_small", SMALL_Q, 0)):
            nbytes, ops = phase1_work(cap, lanes, nq)
            work[name][0] += nbytes + extra
            work[name][1] += ops
        popc_ops += N_QUERIES * cap * lanes
        for i, amount in enumerate(gather_work(N_QUERIES, KK, lanes, point["blocks"])):
            work["gather_rescore"][i] += amount
        log(f"[kernels] {nbits}-bit cap={cap} Q={N_QUERIES} kk={KK}: kernel == plain; "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
        del q_packed, min_lanes, q_scale, db, valid, block_ids, twin, calls
    log(f"[kernels] gather_rescore per sweep of all partitions: {ms['gather_rescore']:.4f} ms by the device's clock "
        f"(CUDA-graph replay of {GATHER_REPS} calls, the routed form), {gather_host_ms:.4f} ms with each call "
        f"launched by the host (events); query-major {sum(p['query_ms'] for p in gather_points):.4f} ms, "
        f"block-major {sum(p['block_ms'] for p in gather_points):.4f} ms")
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
        if name == "blockmax_small":
            stats[name]["q"] = SMALL_Q
        if name == "gather_rescore":
            stats[name]["by_form"] = gather_points
        log(f"[kernels] {name}: {ms[name]:.4f} ms per Q={SMALL_Q if name == 'blockmax_small' else N_QUERIES} sweep of all partitions "
            f"(plain {plain_ms[name]:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}: {work[name][0]:.4g} bytes, "
            f"{work[name][1]:.4g} ops), max |kernel - plain| = {err[name]}")
    return stats


def phase_gather(rng, dev):
    """The [gather] ladder: both forms of ``gather_rescore`` on synthetic
    random partitions at the product's capacity (``_cap_rows`` of its
    2,000,000 chunk rows, those live), ``GATHER_Q`` random full-length
    queries, their top-kk blocks by ``blockmax_mma_packed`` for each kk of
    ``GATHER_LADDER_KK`` (reuse ~0.5 to ~15), at every width: where the
    block-major form starts to win. Returns the points."""
    n_live = PRODUCT_ASSETS * PRODUCT_SIMPRINTS
    cap = _cap_rows(n_live)
    points = []
    for nbits in (64, 128, 192, 256):
        lanes = nbits // 32
        db = torch.randint(-(2**31), 2**31, (cap, lanes), dtype=torch.int32, device=dev)
        valid = torch.zeros(cap, dtype=torch.uint8, device=dev)
        valid[:n_live] = 1
        q_codes, q_lanes = random_codes(rng, GATHER_Q, lanes_choices=(lanes,), p=(1.0,))
        q_packed = torch.from_numpy(q_codes.view(np.int32)).to(dev)
        min_lanes, q_scale = query_prefix(torch.from_numpy(q_lanes).to(dev), nbits)
        block_max = hs.blockmax_mma_packed(q_packed, min_lanes, q_scale, db, valid)
        for kk in GATHER_LADDER_KK:
            block_ids = topk_blocks_hier(block_max, kk).to(torch.int32)
            points.append(gather_point(f"synthetic {nbits}-bit kk={kk}", dev, q_packed, min_lanes, block_ids, db))
        del db, valid, block_max
    for nbits in (64, 128, 192, 256):
        mine = [p for p in points if p["lanes"] == nbits // 32]
        wins = [p["reuse"] for p in mine if p["block_ms"] < p["query_ms"]]
        log(f"[gather] ladder {nbits}-bit, cap {cap}, Q={GATHER_Q}, ms query / block: "
            + ", ".join(f"kk={p['kk']} (reuse {p['reuse']:.2f}) {p['query_ms']:.4f} / {p['block_ms']:.4f}" for p in mine)
            + f"; block-major faster at reuse {', '.join(f'{r:.2f}' for r in wins) or 'none'}; the table's "
            f"threshold {hs.GATHER_BLOCK_REUSE[nbits // 32]}")
    return points


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

    reset_launches()
    scans, stop = spy_routes()
    try:
        t0 = time.perf_counter()
        res = idx.search(queries, K)  # incremental sync: appends + fresh validity
        sync_s = time.perf_counter() - t0
        res, times = warm_searches(idx, queries)
    finally:
        stop()
    # scan_kernel="auto" at Q=512: the phase-1 kernels auto_phase1 names, and no other.
    launches = check_path_launches("[slice]", dev, read_launches(), scans)
    med = statistics.median(times)
    log(f"[slice] search after remove+add (incremental sync + search): {sync_s:.4f} s")
    log(f"[slice] warm search Q={N_QUERIES} k={K}: median {med * 1e3:.3f} ms of {len(times)} "
        f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), {N_QUERIES / med:.1f} QPS")
    log(f"[slice] device memory: allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[slice] kernel launches during the searches: {launches}")

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
    """Phase 1 by batch size on the engine's own partitions: the three
    kernels at every Q of ``ROUTE_QS`` (CUDA-graph replays, ``torch.equal``
    to ``blockmax`` at every point), the fastest per lane count beside what
    ``auto_phase1`` picks, then warm searches at Q=512, ``SMALL_Q`` and 1
    under each ``scan_kernel`` with the exactness check, and the launches of
    the ``"auto"`` searches. Returns (launches, table: (lanes, Q) ->
    {scan_kernel: ms}, capacities by lane count)."""
    parts = idx._sync_device()
    q_codes, q_lanes = pack_codes(queries)
    reps_q = -(-max(ROUTE_QS) // len(queries))
    q_all = torch.from_numpy(np.tile(q_codes, (reps_q, 1)).view(np.int32)).to(dev)
    l_all = torch.from_numpy(np.tile(q_lanes, reps_q)).to(dev)
    kernels = tuple(ROUTE_KERNELS)
    table = {}  # (lanes, Q) -> {scan_kernel: ms}
    for lanes, p in sorted(parts.items()):
        for nq in ROUTE_QS:
            q_packed = q_all[:nq].contiguous()
            min_lanes, q_scale = query_prefix(l_all[:nq].contiguous(), lanes * 32)
            args = (q_packed, min_lanes, q_scale, p.packed_dev, p.valid_dev)
            popc = hs.blockmax(*args)
            for kernel in kernels[1:]:
                if not torch.equal(getattr(hs, ROUTE_KERNELS[kernel])(*args), popc):
                    raise AssertionError(f"{lanes * 32}-bit partition, Q={nq}: {ROUTE_KERNELS[kernel]} differs from blockmax")
            reps = 20 if nq <= 64 else 5
            table[lanes, nq] = {
                kernel: time_ms(functools.partial(getattr(hs, ROUTE_KERNELS[kernel]), *args), dev, reps, graph=True)
                for kernel in kernels
            }
    caps = {lanes: p.cap for lanes, p in sorted(parts.items())}
    log(f"[route] phase 1 per partition, ms by the device's clock (CUDA-graph replays), popc / mma_small / mma "
        f"(blockmax / blockmax_small / blockmax_mma_packed), both tensor-core kernels == blockmax at all "
        f"{len(table)} points; capacities {caps}")
    log("[route]     Q  " + "  ".join(f"{lanes * 32:>4d}-bit popc  small    mma" for lanes in sorted(parts))
        + "   all: popc   small     mma    auto")
    for nq in ROUTE_QS:
        cells = [table[lanes, nq] for lanes in sorted(parts)]
        total = {kernel: sum(c[kernel] for c in cells) for kernel in kernels}
        auto_ms = sum(table[lanes, nq][auto_phase1(nq, lanes)] for lanes in parts)
        log(f"[route] {nq:5d}  " + "  ".join(f"{c['popc']:13.4f} {c['mma_small']:6.4f} {c['mma']:6.4f}" for c in cells)
            + f"   {total['popc']:9.4f} {total['mma_small']:7.4f} {total['mma']:7.4f} {auto_ms:7.4f}")
    for lanes in sorted(parts):
        fastest = {nq: min(kernels, key=table[lanes, nq].get) for nq in ROUTE_QS}
        log(f"[route] {lanes * 32}-bit: fastest " + ", ".join(f"Q={nq} {k}" for nq, k in fastest.items())
            + "; 'auto' takes " + ", ".join(f"Q={nq} {auto_phase1(nq, lanes)}" for nq in ROUTE_QS))
        for nq in ROUTE_QS:
            took = table[lanes, nq][auto_phase1(nq, lanes)]
            best = table[lanes, nq][fastest[nq]]
            if took > AUTO_SLACK * best:
                raise AssertionError(
                    f"{lanes * 32}-bit, Q={nq}: 'auto' takes {auto_phase1(nq, lanes)} at {took:.4f} ms, "
                    f"more than {AUTO_SLACK}x the fastest ({fastest[nq]}, {best:.4f} ms): the table in "
                    "engine/device_index.py is out of date"
                )

    # Warm searches through the engine under each scan_kernel (the attribute
    # the constructor argument sets), in rounds that alternate the order, so
    # that the host clock's drift shows as spread between a kernel's rounds
    # and not as a difference between kernels. Exactness checked every time.
    q_keys, valid, ref_np, top_ref, sample = oracle
    scan_kernels = (*kernels, "auto")
    launches = dict.fromkeys(ROUTE_KERNELS.values(), 0)  # of the 'auto' searches, every batch size
    picked = set()  # the phase-1 kernels 'auto' names at these batch sizes
    for nq in (N_QUERIES, SMALL_Q, 1):
        times = {kernel: [] for kernel in scan_kernels}
        rounds = {kernel: [] for kernel in scan_kernels}
        want_res = None  # the first round's 'popc' results
        for rnd in range(ROUTE_ROUNDS):
            for kernel in scan_kernels if rnd % 2 == 0 else scan_kernels[::-1]:
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
                    picked |= {ROUTE_KERNELS[auto_phase1(nq, lanes)] for lanes in parts}
                    for name in launches:
                        launches[name] += getattr(hs, name).launches
                check_results(f"[route] {kernel} Q={nq}", res, q_keys[:nq], valid, ref_np, top_ref, sample[sample < nq])
                want_res = want_res or res
                if not same_results(res, want_res):
                    raise AssertionError(f"scan_kernel={kernel!r} Q={nq}: results differ from scan_kernel='popc'")
                times[kernel] += t
                rounds[kernel].append(statistics.median(t) * 1e3)
        for kernel in scan_kernels:
            log(f"[route] scan_kernel={kernel!r} Q={nq} k={K}: warm search median {statistics.median(times[kernel]) * 1e3:.3f} ms "
                f"of {len(times[kernel])} (min {min(times[kernel]) * 1e3:.3f}, max {max(times[kernel]) * 1e3:.3f}; medians of the "
                f"{ROUTE_ROUNDS} rounds " + ", ".join(f"{m:.3f}" for m in rounds[kernel]) + "); exact (brute force), equal to 'popc'")
    idx.scan_kernel = "auto"
    for name in ROUTE_KERNELS.values():
        if (launches[name] > 0) != (name in picked):
            raise AssertionError(f"the 'auto' searches launched {name} {launches[name]} times; 'auto' names {sorted(picked)}")
    log(f"[route] kernel launches of the 'auto' searches ({8 * ROUTE_ROUNDS} each at Q={N_QUERIES}, {SMALL_Q} and 1): "
        f"{launches}; 'auto' names {sorted(picked)} there")
    return launches, table, caps


def route_stats(table, caps, kernel):
    """{Q: ms, bound and share} of one phase-1 kernel per config-3 sweep (all
    four partitions) from the [route] table."""
    out = {}
    for nq in ROUTE_QS:
        nbytes = ops = 0
        for lanes, cap in caps.items():
            b, o = phase1_work(cap, lanes, nq)
            nbytes, ops = nbytes + b, ops + o
        bound_ms, bound_by = bound(nbytes, ops, INT8_OPS_S)
        ms = sum(table[lanes, nq][kernel] for lanes in caps)
        out[nq] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms}
    return out


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


# ------------------------------------------------- config 4: the simprint path


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spy_routes():
    """Record (Q, lanes, phase1) of every partition scan the engine makes
    (its call of ``blockmax_topk_packedq_impl``) until ``stop()`` is called.
    Returns (the list of scans, stop)."""
    seen = []
    real = device_index.blockmax_topk_packedq_impl

    def spy(*args, phase1, **kwargs):
        seen.append((args[0].shape[0], args[5] // 32, phase1))
        return real(*args, phase1=phase1, **kwargs)

    def stop():
        device_index.blockmax_topk_packedq_impl = real

    device_index.blockmax_topk_packedq_impl = spy
    return seen, stop


def check_path_launches(label, dev, launches, scans):
    """Raise unless every scan of ``scans`` (``spy_routes()``) took the phase-1
    kernel ``auto_phase1`` names for its batch and width and, on a card, the
    path launched each kernel so named and ``gather_rescore``, and no other
    phase-1 kernel. Returns ``launches``."""
    for nq, lanes, phase1 in scans:
        if phase1 != auto_phase1(nq, lanes):
            raise AssertionError(f"{label}: a Q={nq} scan of a {lanes * 32}-bit partition took {phase1!r}, "
                                 f"'auto' names {auto_phase1(nq, lanes)!r}")
    named = {hs.PHASE1[phase1].__name__ for _, _, phase1 in scans} | {"gather_rescore"}
    PATH_FORMS[label] = dict(hs.gather_rescore.by_form)
    if dev.type == "cuda":
        for name in PATH_KERNELS:
            if (launches[name] > 0) != (name in named):
                raise AssertionError(f"{label}: {name} launched {launches[name]} times; the path's scans name {sorted(named)}")
        if sum(PATH_FORMS[label].values()) != launches["gather_rescore"]:
            raise AssertionError(f"{label}: gather_rescore's calls by form {PATH_FORMS[label]} do not sum to its launches")
    log(f"{label} gather_rescore calls of the path by form: {PATH_FORMS[label]}")
    return launches


def reset_launches():
    for fn in (*hs.PHASE1.values(), hs.gather_rescore):
        fn.launches = 0
    hs.gather_rescore.by_form = dict.fromkeys(hs.GATHER_FORMS, 0)


def read_launches():
    return {name: getattr(hs, name).launches for name in PATH_KERNELS}


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are not the path's: the counts are put back
    as they were (kernel-against-plain checks made within a path's run)."""
    saved = {fn: fn.launches for fn in (*hs.PHASE1.values(), hs.gather_rescore)}
    forms = dict(hs.gather_rescore.by_form)
    try:
        yield
    finally:
        for fn, n in saved.items():
            fn.launches = n
        hs.gather_rescore.by_form = forms


def device_memory(dev):
    if dev.type != "cuda":
        return "not measured (CPU)"
    return (f"allocated {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB, "
            f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")


def profile_device(tag, fn, dev, reps=1):
    """Device time by kernel and the device's busy share of the window of
    ``reps`` calls of ``fn`` (``torch.profiler``, kernel events only). On
    the CPU the calls run unprofiled: there is no device time."""
    if dev.type != "cuda":
        for _ in range(reps):
            fn()
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            us, n = by_kernel.get(evt.name, (0.0, 0))
            by_kernel[evt.name] = (us + evt.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    log(f"{tag} {reps} call(s) under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of the window; idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"{tag} {us / 1e3 / reps:9.4f} ms/call  x{n // reps:<4d} {name[:90]}")


def host_split(tag, fn, parts, reps=1):
    """Where the calling thread's time goes in ``reps`` calls of ``fn``:
    ``cProfile``'s cumulative seconds of the functions each part names
    (``"file.py:function"``), and the top functions by own time. cProfile
    slows every Python call, so read the shares, not the seconds. Time the
    thread spends waiting (on a batcher's sweep, a device sync) counts where
    it waits."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    wall = (time.perf_counter() - t0) / reps
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (calls, ..., own s, cumulative s, callers)

    def cumulative(names):
        return sum(v[3] for (path, _, func), v in stats.items()
                   if any(path.endswith(n.split(":")[0]) and func == n.split(":")[1] for n in names)) / reps

    log(f"{tag} {reps} call(s) under cProfile, {wall * 1e3:.3f} ms per call (profiled): "
        + "; ".join(f"{label} {100 * cumulative(names) / wall:.1f}%" for label, names in parts.items()))
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
    log(f"{tag} own time: " + ", ".join(f"{func} ({Path(path).name}) {100 * v[2] / reps / wall:.1f}%"
                                        for (path, _, func), v in top))


def composite_keys(assets, offsets, size=100):
    """(n, 16) uint8 simprint keys as the simprint engine stores them: the
    asset's 8-byte body, then the chunk's offset and size, each big-endian
    (the shape ``benchmarks/config4_100m.py`` builds)."""
    keys = np.empty((len(assets), 16), np.uint8)
    keys[:, :8] = np.asarray(assets, np.uint64).astype(">u8").view(np.uint8).reshape(-1, 8)
    keys[:, 8:12] = np.asarray(offsets, np.uint32).astype(">u4").view(np.uint8).reshape(-1, 4)
    keys[:, 12:16] = np.full(len(assets), size, ">u4").view(np.uint8).reshape(-1, 4)
    return keys


def hamming_score(a, b):
    """1 - popcount(a ^ b) / bits of two simprints (bytes), on the host."""
    x = np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)
    return 1.0 - int(np.unpackbits(x).sum()) / (8 * len(a))


def flip_rows(rng, vecs, counts):
    """``vecs`` ((n, nbytes) uint8) with ``counts[i]`` distinct bits of row
    ``i`` flipped (bit p is bit p % 8 of byte p // 8)."""
    n, nbytes = vecs.shape
    rank = np.argsort(rng.random((n, nbytes * 8)), axis=1).argsort(axis=1)
    return vecs ^ np.packbits(rank < np.asarray(counts)[:, None], axis=1, bitorder="little")


def check_asset_match(label, match, queries, idf_of, query_freq, stored=None):
    """The checks of one asset's simprint match (``SimprintMatchRaw`` or the
    wire ``Types`` with base64 chunks decoded by the caller into
    ``(query, match, score, offset, freq)``): every chunk's score equals the
    host's XOR + popcount, the match is the stored vector where ``stored``
    names it, and the asset score is recomputed from the chunks, term by
    term in the engine's order (matched chunks, then the unmatched
    queries)."""
    chunks, score = match
    matched = set()
    weighted = total = 0.0
    for query, found, sim, offset, freq in chunks:
        if sim != hamming_score(query, found):
            raise AssertionError(f"{label}: chunk at offset {offset} scores {sim}, XOR + popcount gives {hamming_score(query, found)}")
        if stored is not None and found != stored(offset):
            raise AssertionError(f"{label}: chunk at offset {offset} matched bytes that are not the stored vector")
        matched.add(query)
        idf = idf_of(freq)
        total += idf
        weighted += idf * sim
    for query in queries:
        if query not in matched:
            total += idf_of(query_freq(query))
    if score != (weighted / total if total > 0 else 0.0):
        raise AssertionError(f"{label}: asset score {score} != {weighted / total} recomputed from its chunks")


def phase_simprint(rng, dev, tmp, n_assets=C4_ASSETS, chunks=C4_CHUNKS, trials=C4_TRIALS, widths=C4_WIDTHS,
                   batches=C4_BATCHES):
    """BASELINE config 4 at the engine level: 100-chunk assets of random
    128-bit simprints through ``SimprintEngine.add_packed``, 1/64 of the rows
    removed, then ``search_raw_many`` for planted near-duplicates, checked
    chunk by chunk and asset by asset, with the kernels held against their
    plain versions at the path's shapes."""
    n = n_assets * chunks
    cut = "" if n_assets == C4_ASSETS else f" (cut from {C4_ASSETS} assets)"
    log(f"[simprint] BASELINE config 4, engine level: {n_assets} assets x {chunks} random 128-bit chunk simprints "
        f"= {n} rows{cut}, 1/{TOMBSTONE_EVERY} removed, {C4_PLANTED} planted query assets")
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    engine = SimprintEngine(Path(tmp) / "simprint", ndim=128, device=dev)
    engine._index.save_enabled = False  # the engine-level cell writes nothing; [product] covers persistence
    targets = np.linspace(0, n_assets - 1, C4_PLANTED).astype(np.int64)
    stored = {}  # target asset -> (chunks, 16) uint8 vectors
    t0 = time.perf_counter()
    for a0 in range(0, n_assets, C4_SLICE_ASSETS):
        a1 = min(a0 + C4_SLICE_ASSETS, n_assets)
        assets = np.repeat(np.arange(a0, a1), chunks)
        keys = composite_keys(assets, np.tile(np.arange(chunks) * 100, a1 - a0))
        vecs = rng.integers(0, 256, ((a1 - a0) * chunks, 16), dtype=np.uint8)
        for t in targets[(targets >= a0) & (targets < a1)]:
            stored[int(t)] = vecs[(t - a0) * chunks : (t - a0 + 1) * chunks].copy()
        engine.add_packed(keys, vecs)
        del keys, vecs, assets
    add_s = time.perf_counter() - t0
    removed = np.arange(0, n, TOMBSTONE_EVERY)
    t0 = time.perf_counter()
    buf = composite_keys(removed // chunks, removed % chunks * 100).tobytes()
    engine.remove([buf[i : i + 16] for i in range(0, len(buf), 16)])
    remove_s = time.perf_counter() - t0
    if engine.size != n - len(removed):
        raise AssertionError(f"{engine.size} live rows after removing {len(removed)} of {n}")
    log(f"[simprint] add_packed of {n} rows in slices of {C4_SLICE_ASSETS * chunks}: {add_s:.3f} s "
        f"({n / add_s:.0f} rows/s); remove of {len(removed)} keys: {remove_s:.3f} s")

    def live(asset, c):
        return (asset * chunks + c) % TOMBSTONE_EVERY != 0

    flips = rng.integers(0, C4_MAX_FLIPS + 1, (C4_PLANTED, chunks))
    planted = [[row.tobytes() for row in flip_rows(rng, stored[int(t)], flips[j])] for j, t in enumerate(targets)]
    idf1 = simprint_ops.calculate_idf(1, n_assets)

    def check(label, results, width):
        for j, res in enumerate(results):
            t = int(targets[j])
            want = sum(live(t, c) for c in range(width))
            body = t.to_bytes(8, "big")
            if not res or res[0].iscc_id_body != body or res[0].matches != want or res[0].queried != width:
                top = (res[0].iscc_id_body.hex(), res[0].matches) if res else None
                raise AssertionError(f"{label} query asset {j}: rank 0 is {top}, expected asset {t} with {want} matched chunks")
            for r in res:
                asset = int.from_bytes(r.iscc_id_body, "big")
                for ch in r.chunks:
                    if not live(asset, ch.offset // 100):
                        raise AssertionError(f"{label}: a removed chunk came back (asset {asset}, offset {ch.offset})")
                check_asset_match(
                    f"{label} query asset {j}", ([(ch.query, ch.match, ch.score, ch.offset, ch.freq) for ch in r.chunks], r.score),
                    planted[j][:width], lambda freq: idf1, lambda q: 1,
                    (lambda off, t=t: stored[t][off // 100].tobytes()) if asset == t else None,
                )

    kwargs = dict(limit=C4_LIMIT, threshold=C4_THRESHOLD, detailed=True, doc_freq_fn=lambda sp: 1, total_assets=n_assets)
    scans, stop = spy_routes()
    t0 = time.perf_counter()
    engine.search_raw_many([planted[0][: widths[0]]], **kwargs)
    sync(dev)
    log(f"[simprint] first search (builds and uploads the partition): {time.perf_counter() - t0:.3f} s; "
        f"device memory {device_memory(dev)}")
    sweeps = []
    search = engine._index.search

    def timed_search(bodies, count, **kw):
        t1 = time.perf_counter()
        out = search(bodies, count, **kw)
        sweeps.append(time.perf_counter() - t1)
        return out

    engine._index.search = timed_search
    try:
        for width in widths:
            for b in batches:
                qsets = [planted[j][:width] for j in range(b)]
                times, sweep_s = [], []
                for _ in range(trials + 1):
                    sweeps.clear()
                    t0 = time.perf_counter()
                    results = engine.search_raw_many(qsets, **kwargs)
                    times.append(time.perf_counter() - t0)
                    sweep_s.append(sum(sweeps))
                check(f"[simprint] {width} chunks x {b}", results, width)
                med = statistics.median(times[1:])
                log(f"[simprint] {b} query asset(s) x {width} chunks ({b * width} chunk queries, count "
                    f"{C4_LIMIT * engine.oversampling_factor}): median {med * 1e3:.3f} ms of {trials} warm "
                    f"(min {min(times[1:]) * 1e3:.3f}, max {max(times[1:]) * 1e3:.3f}), {b / med:.2f} query assets/s; "
                    f"device sweeps (launch, device, readback, host merge) {statistics.median(sweep_s[1:]) * 1e3:.3f} ms, "
                    f"per-asset scoring {(med - statistics.median(sweep_s[1:])) * 1e3:.3f} ms; checks passed")
        widest = [planted[j][: widths[-1]] for j in range(batches[-1])]
        profile_device(f"[simprint profile {batches[-1]} x {widths[-1]}]", lambda: engine.search_raw_many(widest, **kwargs), dev)
        host_split(f"[simprint host {batches[-1]} x {widths[-1]}]", lambda: engine.search_raw_many(widest, **kwargs), {
            "device sweeps (launch, device, readback, host merge)": ["device_index.py:search"],
            "host merge": ["device_index.py:_collect_results"],
            "per-asset scoring": ["simprint.py:_score_query_asset"],
            "IDF": ["simprint_ops.py:calculate_idf"],
            "stored vectors (body_at)": ["device_index.py:body_at"],
        })
    finally:
        del engine._index.search
        stop()
    launches = check_path_launches("[simprint]", dev, read_launches(), scans)
    log(f"[simprint] kernel launches of the path (first search and every timed search): {launches}, for sweeps of "
        f"Q in {sorted({nq for nq, _, _ in scans})}; device memory {device_memory(dev)}")
    log(f"[simprint] every matched chunk's score == XOR + popcount on the host, every planted asset at rank 0 with "
        f"all its live chunks matched, every asset score == its recomputation from the chunks, no removed chunk returned")
    stats = simprint_kernel_stats(dev, engine, planted, widths, batches)
    engine.close()
    return launches, stats


def simprint_kernel_stats(dev, engine, planted, widths, batches):
    """Each kernel of the simprint path against its plain version at the
    path's shapes: the 128-bit partition; the three phase-1 kernels at
    Q = the narrowest and the widest query asset (10 and 100 chunks, one
    asset's request), ``blockmax_mma_packed`` also at Q = 512 (one full
    sweep), and ``gather_rescore`` of the count's top blocks for a full
    sweep at limit 10 and for 128 queries at limit 100 (two [gather]
    points)."""
    part = engine._index._sync_device()[4]
    flat = [q for j in range(batches[-1]) for q in planted[j][: widths[-1]]][: SimprintEngine.max_sweep_queries]
    kk = candidate_blocks(C4_LIMIT * engine.oversampling_factor, part.cap)
    kk100 = candidate_blocks(100 * engine.oversampling_factor, part.cap)
    shapes = [(name, nq, None) for nq in (widths[0], widths[-1]) for name in ROUTE_KERNELS.values()]
    return path_kernel_stats("[simprint]", dev, part, flat, [
        *shapes, ("blockmax_mma_packed", len(flat), None), ("gather_rescore", len(flat), kk),
        ("gather_rescore", min(128, len(flat)), kk100),
    ])


def candidate_blocks(count, cap):
    """kk, the candidate blocks per query of a search for ``count`` rows in a
    partition of ``cap`` rows: k bucketed as the engine buckets it, at most
    the partition's blocks (``blockmax_topk_impl``)."""
    return min(_pow2ceil(count), cap // hs.BLOCK)


def path_kernel_stats(label, dev, part, flat, shapes):
    """Kernels of a search path against their plain versions (``torch.equal``)
    on the path's own partition ``part``, with their times. ``shapes`` lists
    (kernel name, Q, kk): the first Q of the chunk queries ``flat``, and for
    ``gather_rescore`` the kk candidate blocks per query (the top-kk blocks
    of the tensor-core phase 1), a [gather] point (``gather_point``).
    Returns {kernel name: [one dict per shape]}."""
    cap = part.cap
    nbits = part.packed_dev.shape[1] * 32
    q_codes, q_lanes = pack_codes(flat)
    q_all = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    l_all = torch.from_numpy(q_lanes).to(dev)
    plain_of = {}  # Q -> (plain phase-1 output, its ms): one plain run per batch
    stats = {}
    for name, nq, kk in shapes:
        q_packed = q_all[:nq].contiguous()
        min_lanes, q_scale = query_prefix(l_all[:nq].contiguous(), nbits)
        args = (q_packed, min_lanes, q_scale, part.packed_dev, part.valid_dev)
        if name == "gather_rescore":
            # A [gather] point: both forms and the route, the routed form's time.
            block_ids = topk_blocks_hier(hs.blockmax_mma_packed(*args), kk).to(torch.int32)
            plain = functools.partial(hs.gather_rescore_plain, q_packed, min_lanes, block_ids, part.packed_dev)
            want, plain_ms = plain(), time_ms(plain, dev, 1)
            point = gather_point(f"{label} Q={nq} kk={kk}", dev, q_packed, min_lanes, block_ids, part.packed_dev, want)
            stats.setdefault(name, []).append({**point, "plain_ms": plain_ms})
            log(f"{label} gather_rescore plain version at Q={nq}, kk={kk}: {plain_ms:.4f} ms")
            continue
        run = functools.partial(getattr(hs, name), *args)
        work = bound(*phase1_work(cap, nbits // 32, nq), INT8_OPS_S)
        if nq not in plain_of:
            plain = functools.partial(hs.blockmax_plain, *args)
            plain_of[nq] = (plain(), time_ms(plain, dev, 1))
        want, plain_ms = plain_of[nq]
        got = run()
        sync(dev)
        if not torch.equal(got, want):
            raise AssertionError(f"{label} {name} at Q={nq}: kernel != plain")
        err = float((got - want).abs().max())
        del got
        ms = time_ms(run, dev, 10 if dev.type == "cuda" else 1)
        stats.setdefault(name, []).append({"q": nq, "cap": cap, "ms": ms, "plain_ms": plain_ms, "bound_ms": work[0],
                                           "bound_by": work[1], "max_abs_err": err})
        log(f"{label} {name} at the path's shape (cap {cap}, Q={nq}): kernel == plain; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {work[0]:.4f} ms by {work[1]}, {100 * work[0] / ms:.0f}% of it)")
    return stats


# ------------------------------------------- the asset-level entry point


def _unit(mtype, stype, body):
    header = ic.encode_header(mtype, stype, ic.VS.V0, ic.encode_length(mtype, len(body) * 8))
    return "ISCC:" + ic.encode_base32(header + body)


UNIT_KINDS = ((ic.MT.META, ic.ST.NONE), (ic.MT.SEMANTIC, ic.ST_CC.TEXT), (ic.MT.CONTENT, ic.ST_CC.IMAGE),
              (ic.MT.DATA, ic.ST.NONE))


def product_assets(rng, n, n_sp=PRODUCT_SIMPRINTS):
    """(wire dicts, truth) of ``n`` assets: META, SEMANTIC, CONTENT and DATA
    units of 64-256 bits, an INSTANCE unit, ``n_sp`` 128-bit simprints and
    a little metadata. Asset ``i`` with ``i % 10 == 1`` is a near copy of
    asset ``i - 1``: units with 1-6 bits flipped, simprints with 0-12 bits
    flipped, and an INSTANCE that is a 64-bit prefix of its original's.
    ``truth[i]`` holds the bodies: ``units`` (four), ``instance``, ``sp``
    ((n_sp, 16) uint8)."""
    truth, assets = [], []
    for i in range(n):
        if i % 10 == 1:
            src = truth[i - 1]
            units = [flip_rows(rng, np.frombuffer(b, np.uint8)[None], [1 + i % 6])[0].tobytes() for b in src["units"]]
            instance = src["instance"][:8]
            sp = flip_rows(rng, src["sp"], rng.integers(0, 13, n_sp))
        else:
            units = [rng.bytes(int(w)) for w in rng.choice([8, 16, 24, 32], len(UNIT_KINDS))]
            instance = rng.bytes(int(rng.choice([8, 16, 32])))
            sp = rng.integers(0, 256, (n_sp, 16), dtype=np.uint8)
        truth.append({"units": units, "instance": instance, "sp": sp})
        assets.append(product_wire(i, truth[i]))
    return assets, truth


def product_iscc_id(i):
    return ic.gen_iscc_id_v1(timestamp_us=PRODUCT_T0 + i, server_id=i % 4096)["iscc"]


def product_wire(i, t):
    return {
        "iscc_id": product_iscc_id(i),
        "units": [_unit(m, s, b) for (m, s), b in zip(UNIT_KINDS, t["units"])]
        + [_unit(ic.MT.INSTANCE, ic.ST.NONE, t["instance"])],
        "simprints": {PRODUCT_SP: [{"simprint": ic.encode_base64(v.tobytes()), "offset": c * 100, "size": 100}
                                   for c, v in enumerate(t["sp"])]},
        "metadata": {"name": f"asset {i}", "source": f"https://example.com/{i}"},
    }


class ProductOracle:
    """Brute force of ``search_assets`` over the host truth: NPHD per unit
    type on the card (``nphd_scores`` over every stored body), INSTANCE
    prefixes both ways, the threshold and confidence weighting of
    ``indexes/tpu/index.py``, and the simprint checks of ``[simprint]``."""

    def __init__(self, dev, truth, index):
        self.dev, self.truth, self.index = dev, truth, index
        self.ids = [product_iscc_id(i) for i in range(len(truth))]
        self.asset_of = {iscc_id: i for i, iscc_id in enumerate(self.ids)}
        self.types = [IsccUnit(_unit(m, s, b"\0" * 8)).unit_type for m, s in UNIT_KINDS]
        self.by_type = []
        for k in range(len(UNIT_KINDS)):
            codes, lanes = pack_codes([t["units"][k] for t in truth])
            self.by_type.append((torch.from_numpy(codes.view(np.int32)).to(dev), torch.from_numpy(lanes).to(dev)))
        # Every stored chunk simprint, row a * n_sp + c = asset a's chunk c,
        # packed big-endian as the engine packs them; the assets' ISCC-ID
        # bodies sorted, to map a composite key back to its asset.
        sp = np.stack([t["sp"] for t in truth])
        self.n_sp = sp.shape[1]
        self.sp_rows = torch.from_numpy(sp.reshape(-1, 4, 4).view(">u4")[..., 0].astype(np.uint32).view(np.int32)).to(dev)
        bodies = np.array([int.from_bytes(IsccID(i).body, "big") for i in self.ids], np.uint64)
        self.body_order = np.argsort(bodies)
        self.sorted_bodies = bodies[self.body_order]

    def _found(self, k, body, limit):
        """{asset: score} of one type's top ``limit``: ``definite`` above the
        cut, ``maybe`` tied at it (which of those the engine keeps is a tie
        break), as float32 scores."""
        codes, lanes = self.by_type[k]
        q_codes, q_lanes = pack_codes([body])
        s = nphd_scores(torch.from_numpy(q_codes.view(np.int32)).to(self.dev), torch.from_numpy(q_lanes).to(self.dev),
                        codes, lanes)[0].cpu().numpy()
        if len(s) <= limit:
            return dict(enumerate(s.tolist())), {}
        cut = np.sort(s)[::-1][limit - 1]
        above, tied = np.flatnonzero(s > cut), np.flatnonzero(s == cut)
        if len(above) + len(tied) == limit:
            above, tied = np.concatenate([above, tied]), tied[:0]
        return {int(a): float(s[a]) for a in above}, {int(a): float(s[a]) for a in tied}

    def _instance(self, body):
        hits = set()
        for i, t in enumerate(self.truth):
            inst = t["instance"]
            if inst.startswith(body) or (len(body) == 32 and inst == body[:16]) or (len(body) >= 16 and inst == body[:8]):
                hits.add(i)
        return hits

    def check_global(self, label, matches, units, limit, exclude=None):
        opts = self.index._opts
        definite, maybe = {}, {}
        for u in units:
            unit = IsccUnit(u)
            if unit.unit_type.startswith("INSTANCE_"):
                for a in self._instance(unit.body):
                    definite.setdefault(a, {})[unit.unit_type] = 1.0
                continue
            sure, tied = self._found(self.types.index(unit.unit_type), unit.body, limit)
            for found, out in ((sure, definite), (tied, maybe)):
                for a, s in found.items():
                    out.setdefault(a, {})[unit.unit_type] = max(0.0, s)
            if tied and max(tied.values()) >= opts.match_threshold_units:
                raise AssertionError(f"{label}: a tie at the top-{limit} cut above the threshold; the data cannot decide it")

        def confident(types):
            return any(s >= opts.match_threshold_units for s in types.values())

        sure_ids = {self.ids[a] for a, t in definite.items() if confident(t)} - {exclude}
        may_ids = sure_ids | {self.ids[a] for a in maybe if confident({**maybe[a], **definite.get(a, {})})} - {exclude}
        got = [m.iscc_id for m in matches]
        if len(got) != len(set(got)) or not set(got) <= may_ids or (len(may_ids) <= limit and not sure_ids <= set(got)):
            raise AssertionError(f"{label}: global matches {sorted(got)} != brute force {sorted(sure_ids)} (+ ties {sorted(may_ids - sure_ids)})")
        if len(got) != min(limit, len(sure_ids)) and len(may_ids) == len(sure_ids):
            raise AssertionError(f"{label}: {len(got)} global matches, brute force has {len(sure_ids)}")
        for m in matches:
            a = self.asset_of[m.iscc_id]
            sure_t, may_t = definite.get(a, {}), maybe.get(a, {})
            if not set(sure_t) <= set(m.types) <= set(sure_t) | set(may_t):
                raise AssertionError(f"{label} {m.iscc_id}: unit types {sorted(m.types)}, brute force {sorted(sure_t)}")
            for t, s in m.types.items():
                if abs(s - {**may_t, **sure_t}[t]) > SCORE_ATOL:
                    raise AssertionError(f"{label} {m.iscc_id} {t}: score {s}, brute force {sure_t.get(t, may_t.get(t))}")
            conf = [s for s in m.types.values() if s >= opts.match_threshold_units]
            total = sum(s ** opts.confidence_exponent for s in conf) / sum(conf)
            if abs(m.score - total) > SCORE_ATOL:
                raise AssertionError(f"{label} {m.iscc_id}: score {m.score}, confidence weighting gives {total}")
            if m.metadata is None or m.metadata.name != f"asset {a}":
                raise AssertionError(f"{label} {m.iscc_id}: metadata {m.metadata} is not the stored asset's")
        if [m.score for m in matches] != sorted((m.score for m in matches), reverse=True):
            raise AssertionError(f"{label}: global matches not in score order")

    def check_chunks(self, label, chunk_matches, query_sp, want_first):
        """[simprint]'s checks on the wire: chunk scores by XOR + popcount,
        the match is the asset's current stored vector (so no removed chunk
        came back), asset scores recomputed from the chunks with the
        document frequencies of the store, the expected asset first."""
        store = self.index.store
        db = f"sp:{PRODUCT_SP}"
        total_assets = len(self.index)
        queries = [ic.decode_base64(s) for s in query_sp]
        got = [m.iscc_id for m in chunk_matches]
        if got[: len(want_first)] != want_first:
            raise AssertionError(f"{label}: chunk matches begin {got[:len(want_first)]}, expected {want_first}")
        for m in chunk_matches:
            a = self.asset_of[m.iscc_id]
            t = m.types[PRODUCT_SP]
            chunks = [(ic.decode_base64(c.query), ic.decode_base64(c.match), c.score, c.offset, c.freq) for c in t.chunks]
            for _, found, _, offset, freq in chunks:
                if freq != simprint_ops.count_doc_freq(store, db, found):
                    raise AssertionError(f"{label} {m.iscc_id}: chunk freq {freq} is not the store's")
            check_asset_match(
                f"{label} {m.iscc_id}", (chunks, t.score), queries,
                lambda f: simprint_ops.calculate_idf(f, total_assets),
                lambda q: simprint_ops.count_doc_freq(store, db, q),
                lambda off, a=a: self.truth[a]["sp"][off // 100].tobytes(),
            )
            if m.score != t.score or t.queried != len(queries) or t.matches != len(chunks):
                raise AssertionError(f"{label} {m.iscc_id}: score {m.score} / queried {t.queried} / matches {t.matches} inconsistent")

    def check_sweeps(self, label, swept):
        """Completeness of the chunk sweeps behind one request (``swept``: the
        engine index's ``(bodies, count, results)`` of each call): per chunk
        query, the candidates are a top ``count`` of brute-force
        ``hamming_scores`` over every stored chunk, on the card. The scores
        equal brute force's top ``count`` in order, each candidate is the chunk
        its key names and carries that chunk's brute-force score, and no key
        comes twice. So none was dropped or under-scored, whatever the tie
        order at the cut."""
        n = self.sp_rows.shape[0]
        for bodies, count, results in swept:
            q_codes, _ = pack_codes(bodies, 4)
            q = torch.from_numpy(q_codes.view(np.int32)).to(self.dev)
            bf = torch.cat([hamming_scores(q, self.sp_rows[s : s + hs.PLAIN_CHUNK_ROWS], 128)
                            for s in range(0, n, hs.PLAIN_CHUNK_ROWS)], dim=1)
            m = min(count, n)
            top = torch.topk(bf, m, dim=1).values.cpu().numpy()
            if any(len(res[1]) != m for res in results):
                raise AssertionError(f"{label}: a chunk query got {sorted({len(r[1]) for r in results})} candidates, not {m}")
            keys = np.stack([res[0] for res in results])  # (Q, m, 16)
            scores = np.stack([res[1] for res in results])
            body = keys[..., :8].copy().view(">u8")[..., 0].astype(np.uint64)
            pos = np.minimum(np.searchsorted(self.sorted_bodies, body), len(self.sorted_bodies) - 1)
            if not np.array_equal(self.sorted_bodies[pos], body):
                raise AssertionError(f"{label}: a candidate's key names no stored asset")
            offset = keys[..., 8:12].copy().view(">u4")[..., 0].astype(np.int64)
            rows = self.body_order[pos] * self.n_sp + offset // 100
            if (offset % 100).any() or (offset // 100 >= self.n_sp).any():
                raise AssertionError(f"{label}: a candidate's key names no stored chunk")
            if (np.diff(np.sort(rows, axis=1), axis=1) == 0).any():
                raise AssertionError(f"{label}: a chunk query got the same chunk twice")
            if not np.array_equal(scores, top):
                raise AssertionError(f"{label}: candidate scores != brute force's top {m} (a candidate dropped or under-scored)")
            if not np.array_equal(scores, torch.gather(bf, 1, torch.from_numpy(rows).to(self.dev)).cpu().numpy()):
                raise AssertionError(f"{label}: a candidate's score is not its chunk's brute-force score")


def phase_product(rng, dev, tmp, n_assets=PRODUCT_ASSETS, n_sp=PRODUCT_SIMPRINTS, n_cpu=PRODUCT_CPU_ASSETS,
                  reps=PRODUCT_REPS, clients=PRODUCT_CLIENTS, per_client=PRODUCT_PER_CLIENT):
    """The asset-level entry point on the card: ``TpuIndex.add_assets`` in
    batches, 1% updated, ``search_assets`` by units, simprints and both
    (limit 10 and 100, scan and exact, an ISCC-ID query) against brute
    force, concurrent clients through the batcher, ``flush``/``close``/
    reopen, and a small copy opened on the CPU answering the same."""
    path = Path(tmp) / "product"
    log(f"[product] TpuIndex (device={dev}): {n_assets} assets x (META, SEMANTIC, CONTENT, DATA units of 64-256 bits, "
        f"INSTANCE, {n_sp} x 128-bit simprints, metadata) = {n_assets * n_sp} chunk rows "
        f"(BASELINE config 4 cut to {100 * n_assets / C4_ASSETS:g}% of its assets: the store ingest is per-asset Python)")
    reset_launches()
    t0 = time.perf_counter()
    assets, truth = product_assets(rng, n_assets, n_sp)
    entries = [schema.IsccEntry(**a) for a in assets]
    log(f"[product] made and validated {n_assets} entries: {time.perf_counter() - t0:.3f} s")
    index = TpuIndex(path, device=dev)
    t0 = time.perf_counter()
    for b in range(0, n_assets, PRODUCT_BATCH):
        results = index.add_assets(entries[b : b + PRODUCT_BATCH])
        if [r.status.value for r in results] != ["created"] * len(results):
            raise AssertionError(f"[product] add_assets batch {b}: not every asset was created")
    add_s = time.perf_counter() - t0
    log(f"[product] add_assets in batches of {PRODUCT_BATCH}: {add_s:.3f} s, {n_assets / add_s:.1f} assets/s, "
        f"{n_assets * n_sp / add_s:.0f} chunk rows/s")
    del entries

    updated = list(range(50, n_assets, 100))  # 1%: a new DATA unit and INSTANCE; half also 10 new simprints
    old_instance = {}
    for i in updated:
        t = truth[i]
        old_instance[i] = t["instance"]
        t["units"][3] = rng.bytes(len(t["units"][3]))
        t["instance"] = rng.bytes(16)
        if i % 200 == 50:
            t["sp"] = t["sp"].copy()
            t["sp"][:10] = rng.integers(0, 256, (10, 16), dtype=np.uint8)
    t0 = time.perf_counter()
    results = index.add_assets([schema.IsccEntry(**product_wire(i, truth[i])) for i in updated])
    if [r.status.value for r in results] != ["updated"] * len(updated):
        raise AssertionError("[product] re-added assets are not all 'updated'")
    log(f"[product] {len(updated)} assets re-added with changed units ({len(updated) // 2} also with 10 new simprints): "
        f"{time.perf_counter() - t0:.3f} s, all 'updated'")
    oracle = ProductOracle(dev, truth, index)
    for i in updated[:5]:
        q = schema.IsccQuery(units=[_unit(ic.MT.INSTANCE, ic.ST.NONE, old_instance[i])])
        if product_iscc_id(i) in [m.iscc_id for m in index.search_assets(q, limit=10).global_matches]:
            raise AssertionError(f"[product] asset {i} still matches its replaced INSTANCE")

    def query_of(i, kind):
        w = product_wire(i, truth[i])
        sp = {PRODUCT_SP: [s["simprint"] for s in w["simprints"][PRODUCT_SP]]}
        return {"units": {"units": w["units"]}, "simprints": {"simprints": sp},
                "both": {"units": w["units"], "simprints": sp}, "iscc_id": {"iscc_id": w["iscc_id"]}}[kind]

    # The chunk index's sweeps (through its batcher) are recorded while the
    # single requests run, to hold their candidates against brute force.
    chunk_index = index._simprint_indexes[PRODUCT_SP]._index
    swept = []

    def recording_search(bodies, count, return_rows=False, _search=chunk_index.search):
        out = _search(bodies, count, return_rows=return_rows)
        swept.append((bodies, count, out))
        return out

    def checked(i, kind, limit, exact=False):
        """(result, seconds of the search_assets call alone) after the checks."""
        q = query_of(i, kind)
        query = schema.IsccQuery(**q)
        swept.clear()
        t0 = time.perf_counter()
        res = index.search_assets(query, limit=limit, exact=exact)
        took = time.perf_counter() - t0
        label = f"[product] {kind} asset {i} limit {limit}{' exact' if exact else ''}"
        if "simprints" in q and not exact:
            if len(swept) != 1 or len(swept[0][0]) != n_sp:
                raise AssertionError(f"{label}: {len(swept)} chunk sweeps recorded, expected one of {n_sp} queries")
            oracle.check_sweeps(label, swept)
            checked_sweeps[limit] += 1
        if kind == "iscc_id":
            oracle.check_global(label, res.global_matches, query_of(i, "units")["units"], limit, exclude=q["iscc_id"])
        elif "units" in q:
            oracle.check_global(label, res.global_matches, q["units"], limit)
        if "simprints" in q:
            first = [product_iscc_id(i)] if exact else [product_iscc_id(i), product_iscc_id(i + 1)]
            if exact:
                if [m.iscc_id for m in res.chunk_matches[:1]] != first:
                    raise AssertionError(f"{label}: exact chunk matches begin {[m.iscc_id for m in res.chunk_matches[:1]]}")
            else:
                oracle.check_chunks(label, res.chunk_matches, q["simprints"][PRODUCT_SP], first)
        return res, took

    originals = list(range(0, n_assets, 10))
    cases = [(kind, limit, False) for kind in ("units", "simprints", "both", "iscc_id") for limit in (10, 100)]
    cases.append(("simprints", 10, True))
    answers = {}
    checked_sweeps = {10: 0, 100: 0}
    chunk_index.search = recording_search
    try:
        for kind, limit, exact in cases:  # warm: the first search of each shape builds and uploads partitions
            checked(originals[0], kind, limit, exact)
        reset_launches()
        scans, stop = spy_routes()  # every scan of the path's counted run, to its end
        counted = 0
        for kind, limit, exact in cases:
            times = []
            for r in range(reps):
                i = originals[1 + r]
                res, took = checked(i, kind, limit, exact)
                answers[kind, limit, exact, i] = res
                times.append(took)
                counted += not exact
            log(f"[product] search_assets {kind:9s} limit {limit:3d}{' exact' if exact else '      '}: median "
                f"{statistics.median(times) * 1e3:.3f} ms of {reps} (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
                f"{len(res.global_matches)} global / {len(res.chunk_matches)} chunk matches; brute-force checks passed")
    finally:
        del chunk_index.search
    log(f"[product] the chunk sweeps of {checked_sweeps[10]} limit-10 and {checked_sweeps[100]} limit-100 requests "
        f"(counts {10 * 2 * index._opts.oversampling_factor} and {100 * 2 * index._opts.oversampling_factor} per chunk "
        f"query): every candidate list a top count of brute-force hamming_scores over all "
        f"{oracle.sp_rows.shape[0]} stored chunks, each with its chunk's score")
    split_q = [schema.IsccQuery(**query_of(originals[1 + r], "both")) for r in range(reps)]
    profile_device(f"[product profile {reps} x both limit 10]", lambda: [index.search_assets(q, limit=10) for q in split_q], dev)
    counted += reps
    for limit in (10, 100):
        cycle = itertools.cycle(split_q)
        host_split(f"[product host both limit {limit}]", lambda: index.search_assets(next(cycle), limit=limit), {
            "device sweeps (waiting on the batchers)": ["batcher.py:search"],
            "base64 decode": ["codec.py:decode_base64"],
            "document frequencies (store dup scans)": ["simprint_ops.py:count_doc_freq"],
            "simprint scoring (with the doc. frequencies)": ["simprint.py:_score_query_asset"],
            "INSTANCE prefix scans": ["index.py:_search_instance_unit"],
            "enrichment (store reads, metadata)": ["index.py:_convert_simprint_match", "kv.py:get_many"],
            "wire types": ["schema.py:__post_init__", "schema.py:_model"],
        }, reps=reps)
        counted += reps
    per_search = {name: n / counted for name, n in read_launches().items()}
    log(f"[product] kernel launches per device search_assets call (mean of {counted}): {per_search}, for scans of "
        f"(Q, lanes) in {sorted({(nq, lanes) for nq, lanes, _ in scans})}")

    # Concurrent clients: the batcher fuses their sweeps; answers equal the sequential ones.
    work = [originals[1 + reps + j] for j in range(clients * per_client)]
    want = {i: index.search_assets(schema.IsccQuery(**query_of(i, "both")), limit=10).model_dump() for i in work}
    sweeps0, fused0 = metrics.batch_queries._totals.get((), 0), metrics.batch_queries._sums.get((), 0.0)
    got, errors = {}, []

    def client(mine):
        try:
            for i in mine:
                got[i] = index.search_assets(schema.IsccQuery(**query_of(i, "both")), limit=10).model_dump()
        except Exception as exc:  # noqa: BLE001 - reported below, the phase fails
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(work[c::clients],)) for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads) or got != want:
        raise AssertionError(f"[product] concurrent clients: errors {errors[:1]}, answers equal: {got == want}")
    sweeps = metrics.batch_queries._totals.get((), 0) - sweeps0
    fused = metrics.batch_queries._sums.get((), 0.0) - fused0
    log(f"[product] {clients} concurrent clients x {per_client} 'both' requests: {wall:.3f} s, "
        f"{len(work) / wall:.1f} query assets/s; {sweeps} device sweeps for {fused:.0f} queries "
        f"({fused / max(sweeps, 1):.1f} per sweep); answers equal the sequential ones")

    # The kernels at this path's own shapes, on its chunk partition: a limit-100
    # request's chunk queries through the tensor-core phase 1, and one query
    # slice of its phases 2-3 (PHASE3_BUDGET_BYTES) at its count's candidate
    # blocks; gather_rescore also at a limit-10 request's (two [gather] points).
    # Then phase 3 of the limit-100 slice, split by part.
    part = chunk_index._sync_device()[4]
    kk = candidate_blocks(100 * 2 * index._opts.oversampling_factor, part.cap)
    kk10 = candidate_blocks(10 * 2 * index._opts.oversampling_factor, part.cap)
    step = max(1, hs.PHASE3_BUDGET_BYTES // (kk * hs.BLOCK * hs.PHASE3_ROW_BYTES))
    step10 = max(1, hs.PHASE3_BUDGET_BYTES // (kk10 * hs.BLOCK * hs.PHASE3_ROW_BYTES))
    chunk_queries = [v.tobytes() for v in truth[originals[1]]["sp"]]
    request_kernel = ROUTE_KERNELS[auto_phase1(len(chunk_queries), part.packed_dev.shape[1])]
    with uncounted():
        stats = path_kernel_stats("[product]", dev, part, chunk_queries, [
            (request_kernel, len(chunk_queries), None), ("gather_rescore", min(step10, len(chunk_queries)), kk10),
            ("gather_rescore", min(step, len(chunk_queries)), kk),
        ])
        stats["gather_rescore"][-1]["phase3_split_ms"] = phase3_split(
            dev, part, chunk_queries[:step], kk, min(_pow2ceil(100 * 2 * index._opts.oversampling_factor), kk * hs.BLOCK))
    del part

    # Durability: flush, close, reopen; the same answers.
    t0 = time.perf_counter()
    index.flush()
    index.close()
    close_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = TpuIndex(path, device=dev)
    open_s = time.perf_counter() - t0
    oracle.index = index
    for (kind, limit, exact, i), res in answers.items():
        if index.search_assets(schema.IsccQuery(**query_of(i, kind)), limit=limit, exact=exact).model_dump() != res.model_dump():
            raise AssertionError(f"[product] after reopen: {kind} asset {i} limit {limit} answers differently")
    index.close()
    log(f"[product] flush + close {close_s:.3f} s, reopen {open_s:.3f} s ({sum(f.stat().st_size for f in path.rglob('*') if f.is_file())} "
        f"bytes on disk): all {len(answers)} answers identical after reopen")

    # A small copy opened on the CPU answers as the card does (model_dump).
    small, small_cpu = Path(tmp) / "product_small", Path(tmp) / "product_small_cpu"
    index = TpuIndex(small, device=dev)
    index.add_assets([schema.IsccEntry(**a) for a in assets[:n_cpu]])
    index.flush()
    index.close()
    shutil.copytree(small, small_cpu)
    on_card, on_cpu = TpuIndex(small, device=dev), TpuIndex(small_cpu, device="cpu")
    compared = 0
    for i in range(0, min(n_cpu, 30), 10):  # limit 10: the CPU's plain phase 3 is slow at count 4,000
        for kind, limit, exact in (case for case in cases if case[1] == 10):
            q = schema.IsccQuery(**query_of(i, kind))
            if on_card.search_assets(q, limit=limit, exact=exact).model_dump() != \
                    on_cpu.search_assets(q, limit=limit, exact=exact).model_dump():
                raise AssertionError(f"[product] {n_cpu}-asset copy: {kind} asset {i} limit {limit} differs on the CPU")
            compared += 1
    on_card.close()
    on_cpu.close()
    stop()
    launches = check_path_launches("[product]", dev, read_launches(), scans)
    log(f"[product] {n_cpu}-asset copy opened with device='cpu': {compared} answers model_dump()-identical to the card's")
    log(f"[product] kernel launches of the path: {launches}")
    return launches, stats


def phase3_split(dev, part, flat, kk, out_k):
    """Device time of one slice of phases 2-3 (``hopper_scan._rescore_topk``)
    on the path's partition ``part`` for the chunk queries ``flat``, split
    by part, each timed alone on the same inputs: phase 2
    (``topk_blocks_hier``), the candidate rows and validity,
    ``gather_rescore`` (CUDA-graph replays; the rest by events over host-
    paced calls), the score epilogue with ``torch.where``, ``torch.topk`` of
    ``out_k`` and the row ``torch.gather``; then the whole slice, and the
    device time by kernel of one slice under the profiler. Returns {part: ms}."""
    nq = len(flat)
    q_codes, q_lanes = pack_codes(flat)
    q_packed = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    db, valid = part.packed_dev, part.valid_dev
    min_lanes, q_scale = query_prefix(torch.from_numpy(q_lanes).to(dev), db.shape[1] * 32)
    block_max = hs.blockmax_mma_packed(q_packed, min_lanes, q_scale, db, valid)
    total_blocks, width = db.shape[0] // hs.BLOCK, kk * hs.BLOCK
    offsets = torch.arange(hs.BLOCK, device=dev)
    blocks = topk_blocks_hier(block_max, kk)
    block_ids = blocks.to(torch.int32)

    def candidates():
        rows = (blocks[:, :, None] * hs.BLOCK + offsets).reshape(nq, width)
        return rows, valid.reshape(total_blocks, hs.BLOCK)[blocks].reshape(nq, width)

    rows, cand_valid = candidates()
    dots = hs.gather_rescore(q_packed, min_lanes, block_ids, db)

    def epilogue():
        return torch.where(cand_valid.to(torch.bool), 0.5 + dots * q_scale[:, None], hs.NEG_SCORE)

    pos = torch.topk(epilogue(), out_k, dim=1).indices
    scores = epilogue()
    reps = 10 if dev.type == "cuda" else 1
    ms = {
        "phase 2 (topk_blocks_hier)": time_ms(lambda: topk_blocks_hier(block_max, kk), dev, reps),
        "candidate rows and validity": time_ms(candidates, dev, reps),
        "gather_rescore": time_ms(lambda: hs.gather_rescore(q_packed, min_lanes, block_ids, db), dev, reps, graph=True),
        "score epilogue and torch.where": time_ms(epilogue, dev, reps),
        "torch.topk": time_ms(lambda: torch.topk(scores, out_k, dim=1), dev, reps),
        "row torch.gather": time_ms(lambda: torch.gather(rows, 1, pos), dev, reps),
    }
    whole = functools.partial(hs._rescore_topk, q_packed, min_lanes, q_scale, block_max, db, valid, kk, out_k)
    ms["whole slice"] = time_ms(whole, dev, reps)
    log(f"[product] phase 3 of one limit-100 slice (Q={nq}, kk={kk}, top-{out_k} of {width} columns), ms by part: "
        + ", ".join(f"{name} {v:.4f}" for name, v in ms.items())
        + f"; the parts sum to {sum(v for name, v in ms.items() if name != 'whole slice'):.4f}")
    profile_device("[product phase-3 slice]", whole, dev, reps=3)
    return ms


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


def _count_paths(name, label, kind, pen, nq, fast):
    """Kernel 8's path counts of the launch just made, as the kernel counted
    them (``exp_kernels.variant_path_blocks``), against the plan's rule on
    the same penalties (``experiments/variant_layout.py`` ``path_blocks``:
    every block once per query chunk, the fast ones by the rule); recorded
    in ``fast`` for the launches that finish block maxima."""
    counted = ex8.variant_path_blocks(pen.device)
    epi = ex8.variant_spec(name)[0]
    bits = pen.reshape(-1) if pen.dtype == torch.uint8 else pen.reshape(-1).view(torch.int16)
    planned = variant_layout.path_blocks(epi, bits.cpu().numpy(), nq)
    if counted != planned:
        raise AssertionError(f"blockmax_variant {name} {label}, {kind}: the kernel counted (finished, fast) blocks "
                             f"{counted}, the plan {planned}")
    if planned[0]:
        fast[f"{name}, {label}, {kind}"] = {"blocks": counted[0], "fast_blocks": counted[1],
                                            "share": counted[1] / counted[0]}


def _count_bitplane_paths(case, pen, nq, fast, width=32):
    """The path counts of the launch of ``csrc/blockmax_bitplane.cu`` just
    made (kernel 10 at ``width`` 32, kernel 11 at 16 and 8), as the kernel
    counted them (``exp_bitplane_int8.bitplane_path_blocks``), against the
    rule of ``experiments/bitplane_layout.py`` on the same penalties;
    recorded in ``fast`` under ``blockmax_bitplane, <case>`` or
    ``blockmax_subword, u<width> <case>``."""
    counted = ex10.bitplane_path_blocks(pen.device)
    bits = pen.reshape(-1).view(torch.int16) if width == 32 else pen.reshape(-1)
    planned = bitplane_layout.path_blocks(bits.cpu().numpy(), nq, width)
    name = "blockmax_bitplane, " if width == 32 else f"blockmax_subword, u{width} "
    if counted != planned:
        raise AssertionError(f"{name}{case}: the kernel counted (finished, fast) blocks {counted}, the plan {planned}")
    fast[name + case] = {"blocks": counted[0], "fast_blocks": counted[1], "share": counted[1] / counted[0]}


def _experiment_cases(dev, n, nq, seed, err, fast, label, timed, which=(8, 9, 10)):
    """The kernels ``which`` of 8-11 (10 stands for 10 and 11) against
    their plain versions on one data set (kernels 10 and 11 also against
    ``blockmax`` on the packed rows); ``timed``: also the plain versions'
    times (the kernels' come from the entry points). ``fast`` gets kernels
    8's, 10's and 11's counted path shares per launch and penalty kind
    (``_count_paths``, ``_count_bitplane_paths``; kernel 11's too). Returns
    {kernel or variant: plain ms}."""
    packed, valid, q_packed, min_lanes, q_scale, q = _experiment_data(dev, n, nq, seed)
    qs = q_scale[:, None].contiguous()
    plain = {}
    live = valid.bool().reshape(-1, 128).any(dim=1)
    if 8 in which:
        db = hs.build_unpacked_db(packed, 256)
        first = {}  # launch key -> first name: names of one key share a plain time
        # Edge cases: 0 / -65536 penalties (the fast path) and random ones (the per-element path).
        for general in (False, True) if label == "edge" else (False,):
            kind = "per-element penalties" if general else "tombstone penalties"
            paths_read = set()  # launch keys whose path counts were read
            for name in ex8.NAMES:
                fn, _ = ex8.make_variant(name, n, nq)
                args = (q, qs, db, ex8.variant_penalties(name, valid, general))
                key = ex8.launch_key(name)
                ex8.variant_path_blocks(dev)  # cleared
                got = fn(*args)
                if key not in paths_read:
                    paths_read.add(key)
                    _count_paths(name, label, kind, args[3], nq, fast)
                _compare(f"blockmax_variant {name} {label}, {kind}", got, ex8.blockmax_variant_plain(name, *args), err)
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
        # 0 / -65536 penalties (the fast path) and, in the edge case, random ones (the per-element path).
        for general in (False, True) if label == "edge" else (False,):
            kind = "per-element penalties" if general else "tombstone penalties"
            pen = ex10.bitplane_penalties(valid, general)
            ex10.bitplane_path_blocks(dev)  # cleared
            got = ex10.blockmax_bitplane(q, q_scale, bt, pen)
            _count_bitplane_paths(f"{label}, {kind}", pen, q.shape[0], fast)
            _compare(f"blockmax_bitplane {label}, {kind}", got, ex10.blockmax_bitplane_plain(q, q_scale, bt, pen), err)
            if not general:
                _compare(f"blockmax_bitplane {label} vs blockmax (blocks with a valid row)", got[:, live], popc[:, live],
                         err)
            if timed and not general:
                plain["blockmax_bitplane"] = time_ms(functools.partial(ex10.blockmax_bitplane_plain, q, q_scale, bt, pen),
                                                     dev, 1)
        del bt
        for wb in (8, 16):
            twin = bitplane.build_twin(packed, wb)
            # 0 / -32768 penalties and, in the edge case, random ones within
            # 400 of each other beside -32768 on tombstones.
            for general in (False, True) if label == "edge" else (False,):
                kind = "per-element penalties" if general else "tombstone penalties"
                pen = ex11.subword_penalty(valid, wb, general)
                ex10.bitplane_path_blocks(dev)  # cleared
                got = ex11.blockmax_subword(q, q_scale, twin, pen, wb)
                _count_bitplane_paths(f"{label}, {kind}", pen, q.shape[0], fast, wb)
                _compare(f"blockmax_subword u{wb} {label}, {kind}", got,
                         ex11.blockmax_subword_plain(q, q_scale, twin, pen, wb), err)
                if not general:
                    _compare(f"blockmax_subword u{wb} {label} vs blockmax", got, popc, err)
                if timed and not general:
                    plain[f"u{wb}"] = time_ms(functools.partial(ex11.blockmax_subword_plain, q, q_scale, twin, pen, wb),
                                              dev, 1)
            del twin
    return plain


def phase_experiments(dev):
    """TPU kernels 8-11 through the experiment entry points (module
    docstring, phase 6)."""
    err = dict.fromkeys(EXPERIMENT_KERNELS, 0.0)
    fast = {}  # kernel 8, 10 or 11 launch and data set -> blocks counted on each path
    t0 = time.perf_counter()
    _experiment_cases(dev, 32768, 77, seed=6, err=err, fast=fast, label="edge", timed=False)
    log(f"[experiments] edge cases (N=32768, Q=77, 192-bit prefixes, tombstones, a dead block): kernel == plain "
        f"for all {len(ex8.NAMES)} variants of kernel 8 (0/-65536 penalties and per-element ones), int4_dot and "
        f"int4_probe (Q=8 and 77), blockmax_bitplane (0/-65536 penalties and per-element ones) and blockmax_subword "
        f"u8/u16 (0/-32768 penalties and per-element ones); kernel 10 == blockmax on blocks with a valid row, "
        f"kernel 11 == blockmax everywhere (0/-32768 penalties) "
        f"({time.perf_counter() - t0:.1f} s)")

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
    plain8 = _experiment_cases(dev, N8, Q8, seed=8, err=err, fast=fast, label=f"N={N8}", timed=True, which=(8,))
    plain9 = _experiment_cases(dev, N9, Q9, seed=9, err=err, fast=fast, label=f"N={N9}", timed=True, which=(9,))
    plain9_large = _experiment_cases(dev, N9_LARGE, Q9, seed=9, err=err, fast=fast, label=f"N={N9_LARGE}", timed=True,
                                     which=(9,))
    plain10 = _experiment_cases(dev, N10, Q10, seed=10, err=err, fast=fast, label=f"N={N10}", timed=True, which=(10,))
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
    bf16_floor = 2 * Q8 * N8 * 256 / BF16_OPS_S * 1e3
    log(f"[experiments] blockmax_variant: base (blockmax_mma_unpacked, the same twin and queries) "
        f"{res8['base']:.4f} ms; the variants on the bf16 units cannot beat {bf16_floor:.4f} ms "
        f"(a floor computed from their dots at the bf16 peak, not measured)")
    for name in ex8.NAMES:
        bound_ms, bound_by = variant_bound(name, N8, Q8)
        variants[name] = {"ms": res8[name], "plain_ms": plain8[name], "bound_ms": bound_ms, "bound_by": bound_by,
                          "share": bound_ms / res8[name]}
        floor = ""
        if ex8.variant_spec(name)[0] in (ex8.EPI_BF16DOT, ex8.EPI_DOTONLY_BF16):
            floor = f"; the computed bf16-peak floor {bf16_floor:.4f} ms is {100 * bf16_floor / res8[name]:.1f}% of its time"
        log(f"[experiments] blockmax_variant {name}: {res8[name]:.4f} ms, {res8[name] / res8['base']:.2f}x base "
            f"(plain {plain8[name]:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / res8[name]:.1f}% "
            f"of it{floor})")
    stats["blockmax_variant"]["base_ms"] = res8["base"]
    for name in ("blockmax_variant", "blockmax_bitplane", "blockmax_subword"):
        mine = {k: v for k, v in fast.items()
                if k.startswith(name + ", ") or (name == "blockmax_variant" and not k.startswith("blockmax_"))}
        stats[name]["fast_path"] = mine
        log(f"[experiments] {name}, blocks on the fast path (one element per query and block) of the blocks "
            "the kernel finished, as it counted them (each equal to the plan's rule): "
            + "; ".join(f"{k} {v['fast_blocks']} of {v['blocks']} ({v['share']:.4f})" for k, v in mine.items()))
    for name in ("int4_dot", "int4_probe"):
        stats[name][f"at_n{N9_LARGE}"] = {"ms": res9_large[name], "plain_ms": plain9_large[name]}
    log(f"[experiments] int4_dot, N={N9} / N={N9_LARGE}: {res9['int4_dot']:.4f} / {res9_large['int4_dot']:.4f} ms; "
        f"torch._int_mm on the int8 form {plain9['library']:.4f} / {plain9_large['library']:.4f} ms")
    stats["int4_dot"][f"at_n{N9_LARGE}"]["library_ms"] = plain9_large["library"]
    stats["blockmax_bitplane"]["modes"] = sorted(k for k in res10 if k != "blockmax")  # one launch, timed once
    stats["blockmax_bitplane"]["blockmax_ms"] = res10["blockmax"]
    stats["blockmax_subword"]["variants"] = {
        f"u{wb}": {"ms": res11[f"u{wb}"], "plain_ms": plain10[f"u{wb}"], "entry_ms": res11[f"u{wb}_impl"],
                   "bound_ms": bounds["blockmax_subword"][0], "share": bounds["blockmax_subword"][0] / res11[f"u{wb}"]}
        for wb in (8, 16)}
    stats["blockmax_subword"]["blockmax_ms"] = res11["blockmax"]
    stats["blockmax_subword"]["blockmax_bitplane_ms"] = res10["int8_p8"]
    bound11 = bounds["blockmax_subword"][0]
    for wb in (8, 16):
        ms11 = res11[f"u{wb}"]
        log(f"[experiments] blockmax_subword u{wb}: {ms11:.4f} ms, {100 * bound11 / ms11:.1f}% of its {bound11:.4f} ms "
            f"bound ({res11[f'u{wb}_impl']:.4f} ms through the script's entry, which builds the penalty on every "
            f"call); plain {plain10[f'u{wb}']:.4f} ms; kernel 10 (blockmax_bitplane) {res10['int8_p8']:.4f} ms "
            "in the same run")
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
    gather_ladder = phase_gather(rng, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        slice_launches, idx, queries, oracle = phase_slice(rng, dev, codes, lanes, Path(tmp) / "config3")
        del codes, lanes
        twin_launches = phase_twin(dev, idx, queries)
        route_launches, route_table, caps = phase_route(dev, idx, queries, oracle)
        if args.profile:
            for scan_kernel, batch in (("popc", queries), ("auto", queries), ("auto", queries[:SMALL_Q]),
                                       ("auto", queries[:1])):
                phase_profile(idx, batch, scan_kernel)
        phase_persist(rng, dev, idx, queries, tmp)
        del idx, oracle
    # The config-3 path: the slice's searches and the [route] phase's 'auto' searches.
    by_path = {"config3": {name: slice_launches[name] + route_launches.get(name, 0) for name in PATH_KERNELS}}
    launches = {**by_path["config3"], "blockmax_mma_unpacked": twin_launches["blockmax_mma_unpacked"]}
    for kernel, name in ROUTE_KERNELS.items():
        stats[name]["by_q"] = route_stats(route_table, caps, kernel)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        by_path["simprint"], path_stats = phase_simprint(rng, dev, tmp)
        log(f"[simprint] phase time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["product"], product_stats = phase_product(rng, dev, tmp)
        log(f"[product] phase time {time.perf_counter() - t0:.1f} s")
    exp_launches, exp_stats = phase_experiments(dev)
    launches.update(exp_launches)
    stats.update(exp_stats)
    # The [gather] sweep: config 3's partitions, the ladder, config 4's and the product's shapes.
    gather = stats["gather_rescore"]["by_form"] + gather_ladder + [
        p for src in (path_stats, product_stats) for p in src["gather_rescore"]]
    stats["gather_rescore"]["by_form"] = gather
    stats["gather_rescore"]["launches_by_form"] = {label.strip("[]"): forms for label, forms in PATH_FORMS.items()}
    log("[gather] point                                   Q     kk    reuse  query ms  block ms  bound ms  "
        "query %  block %  route")
    for p in gather:
        log(f"[gather] {p['point'][:38]:38s} {p['q']:4d} {p['kk']:6d} {p['reuse']:8.3f} {p['query_ms']:9.4f} "
            f"{p['block_ms']:9.4f} {p['bound_ms']:9.4f} {100 * p['query_share']:7.1f} {100 * p['block_share']:7.1f}  "
            f"{p['form']}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    summary = []
    for name, meta in {**KERNELS, **EXPERIMENT_KERNELS}.items():
        entry = {"name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"]}
        if "also_replaces" in meta:
            entry["also_replaces"] = meta["also_replaces"]
        entry.update({"launches": launches[name], **stats[name]})
        if name in PATH_KERNELS:
            # The search paths' launches: config 3 (phases 4-6), the simprint
            # engine at config 4 and the asset-level entry point; and the
            # kernel at the simprint and product paths' shapes.
            entry["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
            entry["launches"] = sum(entry["launches_by_path"].values())
            entry["at_simprint_shapes"] = path_stats[name]
            if name in product_stats:
                entry["at_product_shapes"] = product_stats[name]
        summary.append(entry)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
