#!/usr/bin/env python3
"""
Smoke run of the PyTorch + CUDA port (``iscc_search_tpu_torch``) on one
Hopper GPU, at the size of BASELINE config 3: 10,485,760 variable-length
ISCC-UNIT codes (64/128/192/256-bit at p = .25/.25/.10/.40, the mix of
``benchmarks/config3_10m.py``), exact NPHD top-10 for a batch of 512 queries.

Phases (each prints its lines; any failure raises and exits non-zero):

1. device  — a CUDA device of compute capability >= 9.0 (there is no CPU
   path), and the card's name and power limit from ``nvidia-smi``;
2. build   — the kernels of ``iscc_search_tpu_torch/csrc`` with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card,
   ``torch.equal``, over all four widths, query tiles, short and long
   queries, tombstones and fully invalid blocks (the two tensor-core
   phase-1 entries also against the popc ``blockmax``), then at the shapes
   of the config-3 partitions (Q=512, 16 candidate blocks per query) with
   the time of each beside its plain version's (and beside ``blockmax``'s);
4. slice   — ``DeviceNphdIndex(device="cuda")`` filled through
   ``add_packed``, 1/64 of the keys removed, 4,096 rows appended through
   ``add``, then ``search`` of 512 live rows at k=10: self-match at rank 0
   with score 1.0, the top-10 of 16 sampled queries against brute-force
   ``nphd_scores`` over the whole database, no removed key returned, and
   both kernels launched by the search;
5. twin    — the int8-twin route over the engine's own four partitions:
   ``build_unpacked_db`` on the card (seconds and bytes printed), then
   ``blockmax_topk_packedq_impl(..., db_unpacked=twin, unpacked=True)``
   for the slice's 512 queries at the engine's k and the packed-row
   tensor-core phase 1 (``blockmax_mma_packed``) on each partition, both
   kernels launched; results ``torch.equal`` to the route without a twin
   and to ``blockmax``, with the time of each route.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py [--seed N] [--profile]``
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from iscc_search_tpu_torch.engine import DeviceNphdIndex
from iscc_search_tpu_torch.engine.device_index import _cap_rows, _pow2ceil
from iscc_search_tpu_torch.ops import _build
from iscc_search_tpu_torch.ops import hopper_scan as hs
from iscc_search_tpu_torch.ops.nphd import nphd_scores
from iscc_search_tpu_torch.ops.packing import pack_codes
from iscc_search_tpu_torch.ops.pm1_scan import query_prefix

N_ROWS = 10_485_760  # bench.py headline size
LANE_CHOICES = (2, 4, 6, 8)  # 64/128/192/256-bit
LANE_P = (0.25, 0.25, 0.10, 0.40)  # benchmarks/config3_10m.py length mix
N_QUERIES = 512
K = 10
KK = 16  # candidate blocks per query at k=10 (k bucketed to a power of two)
N_APPEND = 4096
TOMBSTONE_EVERY = 64
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


def log(msg):
    print(msg, flush=True)


def random_codes(rng, n, lanes_choices=LANE_CHOICES, p=LANE_P):
    """(codes (n, 8) uint32 with zeroed lanes past each length, lanes (n,) int32)."""
    lanes = rng.choice(np.asarray(lanes_choices, np.int32), n, p=p).astype(np.int32)
    codes = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    codes[np.arange(8)[None, :] >= lanes[:, None]] = 0
    return codes, lanes


def bodies_of(codes, lanes):
    return [codes[i, : lanes[i]].astype(">u4").tobytes() for i in range(len(lanes))]


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events, after one warm call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    # f32 matmuls of the plain versions in full f32 (±1 dots are exact
    # either way; stated so the comparison does not depend on the default).
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s ({_build.BUILD_ROOT})")
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line:
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
        t = {name: cuda_ms(calls[name], 20 if name == "gather_rescore" else 10) for name in KERNELS}
        t.update({f"{name}_plain": cuda_ms(calls[f"{name}_plain"], 5 if name == "gather_rescore" else 3) for name in KERNELS})
        for name in KERNELS:
            ms[name] += t[name]
            plain_ms[name] += t[name + "_plain"]
        log(f"[kernels] {nbits}-bit cap={cap} Q={N_QUERIES} kk={KK}: kernel == plain; "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
        del q_packed, min_lanes, q_scale, db, valid, block_ids, twin, calls
    for name in KERNELS:
        log(f"[kernels] {name}: {ms[name]:.4f} ms per Q={N_QUERIES} sweep of all partitions "
            f"(plain {plain_ms[name]:.4f} ms), max |kernel - plain| = {err[name]}")
    return {name: {"max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name]} for name in KERNELS}


def phase_slice(rng, dev, codes, lanes):
    n = len(lanes)
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    idx = DeviceNphdIndex(device="cuda")
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

    for fn in (hs.blockmax, hs.gather_rescore):
        fn.launches = 0
    t0 = time.perf_counter()
    res = idx.search(queries, K)  # incremental sync: appends + fresh validity
    sync_s = time.perf_counter() - t0
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        res = idx.search(queries, K)
        times.append(time.perf_counter() - t0)
    launches = {"blockmax": hs.blockmax.launches, "gather_rescore": hs.gather_rescore.launches}
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

    # Self-match, and no removed key anywhere.
    removed_set = set(removed.tolist())
    for qi, (k, s) in enumerate(res):
        got = k.view(">u8").ravel()
        if len(got) != K or int(got[0]) != int(q_rows[qi]) or float(s[0]) != 1.0:
            raise AssertionError(f"query {qi}: rank 0 is key {got[:1]} score {s[:1]}, expected key {q_rows[qi]} at 1.0")
        if removed_set.intersection(got.tolist()):
            raise AssertionError(f"query {qi} returned a removed key")
    log(f"[slice] self-match at rank 0 with score 1.0 for all {N_QUERIES} queries; no removed key returned")

    # Brute force over the whole database on the card (key == row here).
    valid = np.ones(len(all_lanes), bool)
    valid[removed] = False
    db_codes = torch.from_numpy(all_codes.view(np.int32)).to(dev)
    db_lanes = torch.from_numpy(all_lanes).to(dev)
    db_valid = torch.from_numpy(valid).to(dev)
    sample = np.linspace(0, N_QUERIES - 1, N_ORACLE).astype(np.int64)
    oq = torch.from_numpy(all_codes[q_rows[sample]].view(np.int32)).to(dev)
    ol = torch.from_numpy(all_lanes[q_rows[sample]]).to(dev)
    step = 1 << 20
    ref = torch.cat([
        nphd_scores(oq, ol, db_codes[s : s + step], db_lanes[s : s + step], db_valid[s : s + step])
        for s in range(0, len(all_lanes), step)
    ], dim=1)
    top_ref = torch.topk(ref, K, dim=1).values.cpu().numpy()
    ref_np = ref.cpu().numpy()
    for j, qi in enumerate(sample):
        k, s = res[qi]
        rows = k.view(">u8").ravel().astype(np.int64)
        if not np.allclose(np.sort(s)[::-1], top_ref[j], rtol=0, atol=SCORE_ATOL):
            raise AssertionError(f"query {qi}: top-{K} scores {s} != brute force {top_ref[j]}")
        if not np.allclose(ref_np[j, rows], s, rtol=0, atol=SCORE_ATOL):
            raise AssertionError(f"query {qi}: returned rows carry brute-force scores {ref_np[j, rows]}, not {s}")
    log(f"[slice] {N_ORACLE} sampled queries: top-{K} score multisets and every row's score match brute-force "
        f"nphd_scores over all {len(all_lanes)} rows (atol {SCORE_ATOL})")
    return launches, idx, queries


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
        t = {name: cuda_ms(fn, 5) for name, fn in st.items()}
        log(f"[twin] {lanes * 32}-bit cap={parts[lanes].cap} Q={N_QUERIES} k={min(_pow2ceil(K), parts[lanes].cap)}: "
            "twin route == route without twin, blockmax_mma_packed == blockmax; "
            + ", ".join(f"{name} {v:.4f} ms" for name, v in t.items()))
    log(f"[twin] all {len(steps)} partitions ({sum(p.cap for p in parts.values())} rows, "
        f"{sum(p.count for p in parts.values())} filled): the int8-twin route equals the route without a twin")
    del twins, got, steps
    return launches


def phase_profile(idx, queries, reps=5):
    """Where one warm search's time goes.

    - Host split (host clock): query packing and kernel launches, waiting
      for the device, and the host merge of the partitions' candidates.
    - Device time by kernel over ``reps`` searches (``torch.profiler``,
      kernel events only), and the device's busy share of that window. The
      trace goes to ``build/chip_smoke_trace.json``.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    log("[profile] host split of a warm search (median ms): "
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
    log(f"[profile] {reps} searches under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of the window)")
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile] {us / 1e3 / reps:9.4f} ms/search  x{n // reps:<3d} {name[:90]}")
    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "chip_smoke_trace.json"))


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
    launches, idx, queries = phase_slice(rng, dev, codes, lanes)
    launches.update(phase_twin(dev, idx, queries))
    if args.profile:
        phase_profile(idx, queries)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    summary = []
    for name, meta in KERNELS.items():
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
