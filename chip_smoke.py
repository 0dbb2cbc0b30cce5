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
   select  — ``select_rescore_topk`` (phases 2-3 in one launch) beside the
   chain of PyTorch calls it replaces (``select_rescore_topk_plain``) at
   config 3's four partitions and at a ``c5_mesh4`` shard of the 256-bit
   partition, Q=512, kk=16: the kernel held to the chain's contract and to
   its mirrored flow, both timed by CUDA-graph replays and paced by the
   host, beside the bound (``select_work``). ``--select-only`` runs the
   device, build and select phases alone;
4. slice   — ``DeviceNphdIndex(path, device="cuda")`` (``scan_kernel``
   left at ``"auto"``) filled through ``add_packed``, 1/64 of the keys
   removed, 4,096 rows appended through ``add``, then ``search`` of 512
   live rows at k=10: self-match at rank 0 with score 1.0, the top-10 of 16
   sampled queries against brute-force ``nphd_scores`` over the whole
   database, no removed key returned, and the search launched the phase-1
   kernels ``auto_phase1`` names and the phases 2-3 kernel of each scan's
   route (``select_rescore_topk`` or ``gather_rescore``), and no other;
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
   knobs   — the engine's scan knobs on config 3's rows (indexes made by
   ``from_arrays`` from the slice's host arrays, no second ingest), one
   device: ``scan_kernel="xla"`` at Q=512, 32 and 1 (k=10) and limit 100
   (Q=32), ``"xla"`` with ``recall_target=0.9`` at Q=32, ``"pallas"`` and
   ``"auto"`` with ``recall_target=0.9`` at Q=512: each search's warm
   median of 5 after a first call, the device memory, the launches (every
   route a kernel route: exactly the kernels ``auto_phase1`` names), every
   answer equal to ``"auto"``'s by score multiset and brute force, no
   removed key. Their launches are ``launches_by_path["knobs"]``;
   mesh    — config 3's rows (the slice's index) row-sharded over 4 shards
   of the card (``make_mesh(devices=[dev] * 4)``, a power of two per
   shard): ``DeviceNphdIndex(mesh=...)`` at Q=512, 32 and 1 (k=10) and at
   limit 100 (Q=32) against the single-device index (score multisets),
   brute force (every returned row's score, the sampled top-10s, no removed
   key) and with each scan on the kernel ``auto_phase1`` names; the same
   searches under ``scan_kernel="pallas"`` (the int8 twin per shard, its
   build seconds, timed inside the index's first search, and bytes
   printed: every partition scan through ``sharded_pallas_topk``, TPU
   kernel 4 launched once per shard by each), and one ``"xla"`` search at
   Q=32 (the kernel route per shard), held the same way; the int8-twin
   route per shard called directly on the ``"pallas"`` index's twins
   ``torch.equal`` to the sharded scan, and kernel 4 to its plain version
   at each partition's shard; warm ms beside the single device's. Then, one after the other,
   two clusters in subprocesses (``--mesh-worker``): 2 processes x 2
   shards joined by gloo and one process of 4 shards in a one-rank NCCL
   group, each uploading only its own row block, running ``hier_pm1_topk``
   over the 256-bit partition and the engine's searches in lockstep (the
   median of 7 warm calls per batch): answers equal one process's (the gloo pair's
   ``hier_pm1_topk`` bit for bit). Its launches are ``launches_by_path["mesh"]``;
   multihost — the multi-host control plane, two rank processes on the
   card joined by ``init_distributed`` (gloo: they share it). (a) After
   [mesh]: ``DeviceNphdIndex(mesh=make_mesh_2d(2, 1))`` in each rank
   (``--multihost-worker``); rank 0 makes config 3's codes from ``--seed``
   and drives its engine hooked by ``MultihostService``: ``add_packed`` in
   batches of 1,048,576 rows, the removal of every 64th key and the slice's
   4,096 appended rows via ``add``, each acked by rank 1, which gets rows
   only over the channel (``follow()``); ``check``; searches at Q=512, 32, 1
   (k=10) and Q=32 at limit 100 (each first call checked, then the median of
   7 warm calls). Answers equal the single-device index by score multiset
   and brute force, no removed key, both replicas' rows equal its rows
   (digests); the mirrored ingest's rows/s beside the same adds without a
   hook, each op's channel ms beside its local ms, the warm ms beside
   [mesh]'s gloo pair; each kernel the path launched against its plain
   version on rank 0's shard at the searches' shapes. (b) After [cli]: two
   copies of the product index's directory, ``python -m
   iscc_search_tpu_torch.cli serve`` per rank with
   ``ISCC_SEARCH_DISTRIBUTED=1`` (``MULTIHOST_SERVE`` runs the CLI's
   ``__main__`` and prints the rank's launches at exit): rank 1 binds no
   port, both hold a context on the card; every search kind at limit 10 and
   100 equal to the direct call (ties in any order), 8 client
   subprocesses, 200 assets added over HTTP and found, SIGTERM to rank 0:
   both exit 0, the follower's directory gains no file, the coordinator's
   holds the assets. Both ranks of both parts are
   ``launches_by_path["multihost"]``;
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
   opened with ``device="cpu"`` answering ``model_dump()``-identically;
11. server — the REST front on that index, alone in its base directory:
   ``get_index("tpu://...")`` on the card (its default device),
   ``create_app`` on ``PooledHTTPServer`` over loopback sockets; the probes,
   ``/indexes``, ``/openapi.json`` and ``/metrics``; every search kind
   (units, simprints, both, ISCC-ID by POST, ISCC-CODE by GET) at limit 10
   and 100, 7 requests each through ``RemoteIndex``, each body equal to the
   direct ``search_assets(...).model_dump(mode="json", exclude_none=True)``
   on the same manager (and once through ``RemoteIndex.search_assets`` and
   ``urllib``), timed beside the direct call; ``GET .../assets/{id}``; 8
   keep-alive clients x 8 ``both`` requests (query assets/s beside
   [product]'s direct figure); 1,000 new assets added over HTTP in
   ``RemoteIndex`` batches of 100 (assets/s, a batch split into encoding,
   decoding and ``add_assets``), each then found by a units search; 422,
   404, 409 and 401 (a second app with ``api_secret``); then ``serve()``
   in a subprocess (``ISCC_SEARCH_INDEX_URI``, ``_PORT``, ``_HOST``): a
   search equal to the direct call, 10 assets added, SIGTERM, exit 0, and
   the reopened index holds them; ``memory://`` and ``kv://`` through
   ``get_index``, 100 assets each over HTTP. The 8 clients' load is also
   sent from client subprocesses (4 x 2 keep-alive connections, the
   standard library only), so the clients do not share the server's GIL;
12. scaleout — ``serve_scaleout`` (``serve --workers N``) on a thread of
   this process, the engine, over the product index on the card, with N =
   min(4, runnable cores - 1) ``SO_REUSEPORT`` worker processes (exactly N,
   read from /proc, none with a context on the card by ``nvidia-smi``, each
   with ``CUDA_VISIBLE_DEVICES=""``): every search kind at limit 10 and 100
   through the workers, each body equal to [server]'s direct answers of the
   reopened index, with the hop's added ms; the 8 clients from client
   subprocesses beside [server]'s single process under the same load; 1,000
   assets added over HTTP, each found; a 503 with Retry-After from an
   engine endpoint with an in-flight bound of 1; a worker SIGKILLed and
   respawned while searches keep succeeding; stopped by its event;
13. cli — ``python -m iscc_search_tpu_torch.cli`` in fresh processes on the
   card (its default device), ``HOME`` in a temporary directory: ``index
   add``, ``add`` of 1,000 product-style assets (an .iscc.json file, a
   directory, an NDJSON file), ``index list``, ``get``, ``search --json`` by
   code and ISCC-ID, ``index rebuild --all``, ``serve --workers 2`` (a
   search, SIGTERM, exit 0), ``index remove``; then the index opened here
   holds every asset and the outputs equal the direct calls. Each process's
   split: the CLI's and torch's import (``-X importtime``), opening the
   index and the call (the CLI's timers); last, a cold ``search`` of the
   product index;
14. aggregator — ``python -m iscc_search_tpu_torch.cli serve`` on the card
   in aggregator mode (``ISCC_SEARCH_AGGREGATOR_NETWORK=testnet``,
   ``ISCC_SEARCH_INDEX_URI=tpu://...``, a poll interval of 1 s, the default
   conversion workers), following a stub hub on loopback (``chip_smoke_hub.py``,
   a subprocess on ``http.server``; its hub list reached through a 302)
   whose hub 0 builds its log on request, ``HUB0_RECORDS`` records (262,144;
   ``phase_aggregator(..., n_records=HUB0_FULL)`` runs the JAX sizing,
   1,048,576; 1 in 8 a 4-unit code with 256-bit
   expansions and a gateway, 1 in 100 a skip of each reason in turn) and
   whose hub 1 answers 500: the records/s from the first entries fetch to
   hub 0's cursor at the log's size on ``/status``, the five longest gaps
   between group fetches and the stub's build time; per-reason counts equal
   the stub's, hub 1 not ok throughout, the conversion workers alive and off
   the card (``CUDA_VISIBLE_DEVICES=""``, no ``libcuda.so`` mapped, not in
   ``nvidia-smi``'s compute apps), no "conversion pool failed"; SIGTERM:
   exit 0, ``aggregator_cursors.json`` at the size; a restart whose first
   poll fetches no bundle, then a 100-record partial bundle (``.p/100``)
   ingested and counted; SIGTERM again. Then a group's time split in this
   process (build, conversion, ``add_assets``), and the index opened here:
   the asset count equals the ok count, 1,024 sampled ``get_asset`` equal
   ``record_to_entry`` (units, code, metadata), and 512 ``search_assets``
   by a record's units at limit 10 return it at score 1.0 (their launches:
   ``launches_by_path["aggregator"]``).

``[knobs]``, ``[mesh]``, ``[multihost]`` and phases 9-12 and 14 run after
phase 7 and set the launch counts to 0 just before they drive their path and
read them just after (``[multihost]``'s rank processes count from their start; phase 10's
kernel-against-plain launches are not counted; phases 11 and 12 count their
HTTP requests alone, phase 14 its searches of the aggregator's index); the
JSON summary's ``launches`` of the path kernels is the sum over the nine
search paths, ``launches_by_path`` splits it (for ``blockmax_mma_unpacked``:
the twin phase and the mesh path, whose ``"pallas"`` searches and direct
calls ``mesh_launches_by_source`` splits), and ``at_simprint_shapes``,
``at_product_shapes`` and ``at_multihost_shapes`` hold phases 9 and 10's and
[multihost]'s kernel-against-plain numbers, one entry per shape (for
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
``"auto"`` at Q=32 and Q=1, and for the mesh index at Q=512 and 32.

Usage: ``python3 chip_smoke.py [--seed N] [--profile]``
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import itertools
import json
import os
import pickle
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import torch

import iscc_search_tpu_torch
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
from iscc_search_tpu_torch.ops import select_layout, wgmma_layout
from iscc_search_tpu_torch.ops.nphd import hamming_scores, nphd_scores
from iscc_search_tpu_torch.ops.packing import pack_codes
from iscc_search_tpu_torch.ops.pm1_scan import masked_queries, prepare_queries, query_prefix, topk_blocks_hier
from iscc_search_tpu_torch.parallel import hier_pm1_topk, make_mesh, make_mesh_2d
from iscc_search_tpu_torch.parallel.distributed import init_distributed
from iscc_search_tpu_torch.parallel.pallas_sharded import sharded_pallas_topk
from iscc_search_tpu_torch.parallel.pm1_sharded import shard_pm1_database
from iscc_search_tpu_torch import options as options_mod
from iscc_search_tpu_torch.options import SearchOptions, get_index
from iscc_search_tpu_torch.remote import RemoteIndex
from iscc_search_tpu_torch.server import metrics
from iscc_search_tpu_torch.server import scaleout as so
from iscc_search_tpu_torch.server.app import create_app
from iscc_search_tpu_torch.server.openapi import build_openapi
from iscc_search_tpu_torch.server.pooled import PooledHTTPServer

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
# [mesh]: config 3's codes row-sharded over several shards of the one card.
MESH_SHARDS = 4  # shards of the one-process mesh
MESH_CHIPS = 2  # shards per process of the two-process 2-D mesh (2 x 2)
MESH_QS = (512, 32, 1)  # batches of the sharded searches at k=10 (the second also at MESH_LIMIT)
MESH_LIMIT = 100
MESH_PM1_CHUNK = 32768  # rows per step of the plain pm1 scan in hier_pm1_topk
MESH_TIMEOUT_S = 300  # a cluster process that runs longer fails the phase
MULTIHOST_BATCH = 1_048_576  # rows per mirrored add_packed of [multihost] (a)
MULTIHOST_NAME = "config3:DATA"  # the replica name the engine's ops carry over the control channel
MULTIHOST_TIMEOUT_S = 480  # [multihost] (a): both rank processes, start to exit
MULTIHOST_NEW_ASSETS = 200  # [multihost] (b): assets added over HTTP to the distributed serve()
MULTIHOST_SERVE_TIMEOUT_S = 600  # [multihost] (b): both serve() processes, start to exit
MESH_ARRAYS = ("keys", "codes", "nlanes", "valid", "q_codes", "q_lanes", "pm1_packed", "pm1_valid")
# [knobs]: (scan_kernel, recall_target, searches as (Q, count)) on config 3's rows, one device.
KNOB_ROUTES = (
    ("xla", None, ((N_QUERIES, K), (32, K), (1, K), (32, MESH_LIMIT))),
    ("xla", 0.9, ((32, K),)),
    ("pallas", None, ((N_QUERIES, K),)),
    ("auto", 0.9, ((N_QUERIES, K),)),
)
KNOB_REPS = 5  # warm searches per route and batch after a first call
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
PRODUCT_BASE, PRODUCT_NAME = "product_base", "product"  # the product index's base directory and name
SERVER_NEW_ASSETS, SERVER_CHUNK = 1000, 100  # assets added over HTTP, in RemoteIndex batches of this size
SERVER_KV_ASSETS = 100  # assets of the memory:// and kv:// round trips
# What a search launches: a phase-1 kernel, then select_rescore_topk (the fused route) or gather_rescore (the chain).
PATH_KERNELS = ("blockmax", "blockmax_mma_packed", "blockmax_small", "gather_rescore", "select_rescore_topk")
PHASE23_KERNELS = {"fused": "select_rescore_topk", "chain": "gather_rescore"}  # hs.scan_route -> what it launches
GATHER_REPS = 20  # CUDA-graph-captured calls per form and [gather] point
# The [gather] ladder: synthetic random partitions at the product's capacity,
# Q=64, candidate blocks per query from reuse ~0.5 to ~15, at every width.
GATHER_Q, GATHER_LADDER_KK = 64, (128, 256, 512, 768, 1024, 4096)
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12  # dense bf16 tensor-core peak: the floor of the kernel-8 variants that dot on the bf16 units
POPC_PER_CLOCK_SM = 16  # CUDA C++ Programming Guide, compute capability 9.0
CARD = {}  # filled by phase_device: name and power limit, SMs and maximum SM clock
PATH_FORMS = {}  # path label -> gather_rescore calls by form, read beside its launches
TWIN_LAUNCHES = {}  # blockmax_mma_unpacked (kernel 4) launches by where they came from


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
    CARD["smi"] = smi
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


def select_work(nq, nblocks, kk, lanes, out_k):
    """(bytes, operations) of phases 2-3 in one launch: each query's row of
    block maxima read once, its candidate rows (words and validity) read
    once, the queries (words, prefix lanes, scale) read once and the (nq,
    out_k) scores and rows written once; one popc per (candidate row, lane)."""
    nbytes = nq * nblocks * 4 + nq * kk * 128 * (lanes * 4 + 1) + nq * (lanes * 4 + 8) + nq * out_k * 8
    return nbytes, nq * kk * 128 * lanes


def phase_select(rng, dev, part_rows):
    """[select]: ``select_rescore_topk`` (phases 2-3 in one launch) beside
    the chain it replaces (``select_rescore_topk_plain``) at config 3's four
    partitions and at a ``c5_mesh4`` shard of the 256-bit partition (a
    power-of-two shard of 104,857,600 codes' 41.9M 256-bit rows), Q=512,
    kk=16 (count 10): block maxima of random rows by ``blockmax_mma_packed``,
    the kernel's output held to the chain's contract and to its mirrored
    flow on 16 queries (``ops/select_layout.py``); the kernel's time by
    CUDA-graph replays (the device's clock) and paced by the host, the
    chain's both ways, beside the bound (``select_work``). Returns the
    points."""
    shard_rows = _pow2ceil(-(-int(N_ROWS * 10 * LANE_P[-1]) // MESH_SHARDS))
    points = []
    shapes = [(f"config3 {lanes * 32}-bit", lanes, _cap_rows(n), n) for lanes, n in sorted(part_rows.items())]
    shapes.append(("c5 shard 256-bit", 8, shard_rows, int(N_ROWS * 10 * LANE_P[-1]) // MESH_SHARDS))
    for label, lanes, cap, n_live in shapes:
        q_packed, min_lanes, q_scale, db, valid, _ = _case(
            rng, dev, lanes * 32, cap=cap, nq=N_QUERIES, n_live=n_live, kk=KK, tombstone_every=TOMBSTONE_EVERY)
        block_max = hs.blockmax_mma_packed(q_packed, min_lanes, q_scale, db, valid)
        args = (q_packed, min_lanes, q_scale, block_max, db, valid, KK, KK)
        got = hs.select_rescore_topk(*args)
        want = hs.select_rescore_topk_plain(*args)
        sync(dev)
        select_layout.check_contract(*got, want[0], q_packed, min_lanes, q_scale, db, valid)
        if dev.type == "cuda":  # on the CPU the wrapper takes the chain, whose ties fall otherwise
            host = [t[:16].cpu().numpy() for t in args[:4]]
            mirror = select_layout.select_rescore(*host, db.cpu().numpy(), valid.cpu().numpy(), KK, KK)
            if not all(np.array_equal(g[:16].cpu().numpy(), m) for g, m in zip(got, mirror)):
                raise AssertionError(f"[select] {label}: the kernel differs from its mirrored flow")
        nblocks = cap // hs.BLOCK
        nbytes, ops = select_work(N_QUERIES, nblocks, KK, lanes, KK)
        bound_ms, bound_by = bound(nbytes, ops, popc_per_s())
        kernel = functools.partial(hs.select_rescore_topk, *args)
        chain = functools.partial(hs.select_rescore_topk_plain, *args)
        ms = {"kernel": time_ms(kernel, dev, GATHER_REPS, graph=True), "kernel_host": time_ms(kernel, dev, GATHER_REPS),
              "chain": time_ms(chain, dev, GATHER_REPS, graph=True), "chain_host": time_ms(chain, dev, GATHER_REPS)}
        log(f"[select] {label}: cap {cap}, Q={N_QUERIES}, kk={KK}: kernel {ms['kernel']:.4f} ms "
            f"({100 * bound_ms / ms['kernel']:.1f}% of bound; host-paced {ms['kernel_host']:.4f}), chain "
            f"{ms['chain']:.4f} ms (host-paced {ms['chain_host']:.4f}), bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes:.4g} bytes); kernel == chain's contract" + (" and its mirrored flow" if dev.type == "cuda" else ""))
        points.append({"point": label, "q": N_QUERIES, "kk": KK, "cap": cap, "lanes": lanes, **ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms["kernel"]})
        del q_packed, min_lanes, q_scale, db, valid, block_max, args, got, want
    c3 = [p for p in points if p["point"].startswith("config3")]
    log(f"[select] config 3 sweep of four partitions: kernel {sum(p['kernel'] for p in c3):.4f} ms "
        f"(host-paced {sum(p['kernel_host'] for p in c3):.4f}), chain {sum(p['chain'] for p in c3):.4f} ms "
        f"(host-paced {sum(p['chain_host'] for p in c3):.4f}), bound {sum(p['bound_ms'] for p in c3):.4f} ms")
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


# ------------------------------------------------------- [mesh]: sharded search


def row_scores(q_codes, q_lanes, codes, lanes, rows):
    """(Q, m) float64 NPHD of each query against its rows ``rows`` (Q, m)
    of ``codes`` / ``lanes`` (numpy, lane-exact prefixes); NaN where the row
    is -1."""
    r = np.maximum(rows, 0)
    x = (np.asarray(q_codes, np.uint32)[:, None, :] ^ np.asarray(codes, np.uint32)[r]).astype(">u4")
    pops = np.unpackbits(x.view(np.uint8), axis=-1).reshape(*r.shape, -1, 32).sum(-1)  # (Q, m, lanes)
    ml = np.minimum(np.asarray(q_lanes)[:, None], np.asarray(lanes)[r])
    ham = np.where(np.arange(pops.shape[-1]) < ml[..., None], pops, 0).sum(-1)
    return np.where(rows >= 0, 1.0 - ham / np.maximum(ml * 32, 1), np.nan)


def padded_results(res, count):
    """Engine results as (Q, count) int64 keys (-1 padding) and float32 scores (NaN padding)."""
    keys = np.full((len(res), count), -1, np.int64)
    scores = np.full((len(res), count), np.nan, np.float32)
    for qi, (k, sc) in enumerate(res):
        keys[qi, : len(sc)] = k.view(">u8").ravel()
        scores[qi, : len(sc)] = sc
    return keys, scores


def check_sharded(label, keys, scores, want_scores, q_codes, q_lanes, host):
    """Raise unless each query's scores equal ``want_scores`` exactly (the
    same multiset, the engines sort them alike), no key repeats or is
    removed, and every returned key's row carries its brute-force score."""
    if not np.array_equal(scores, want_scores, equal_nan=True):
        raise AssertionError(f"{label}: score multisets differ from the single-device index's")
    live = keys >= 0
    if not host["valid"][keys[live]].all():
        raise AssertionError(f"{label}: a removed key came back")
    if any(len(set(row[row >= 0])) != int((row >= 0).sum()) for row in keys):
        raise AssertionError(f"{label}: a key repeats within one query's results")
    direct = row_scores(q_codes, q_lanes, host["codes"], host["nlanes"], keys)  # key == row
    if not np.allclose(direct[live], scores[live], rtol=0, atol=SCORE_ATOL):
        raise AssertionError(f"{label}: returned rows do not carry their brute-force scores")


def phase_knobs(dev, single, queries, oracle, routes=KNOB_ROUTES, reps=KNOB_REPS):
    """The engine's scan knobs on config 3's rows, one device: for each
    (scan_kernel, recall_target) of ``routes`` an index made by
    ``from_arrays`` from ``single``'s host arrays (no second ingest), its
    partitions uploaded by a first search, then each search's first call
    and ``reps`` warm calls with the counts set to 0 just before and read
    just after. Every route is a kernel route and must launch exactly the
    kernels ``auto_phase1`` names, once per partition scan. Every answer
    equals ``single``'s (``"auto"``) by score multiset, carries brute-force
    scores and holds no removed key. Returns the launches."""
    rows = single._rows
    host = {"keys": single._keys[:rows], "codes": single._codes[:rows], "nlanes": single._nlanes[:rows],
            "valid": single._valid[:rows]}
    q_codes, q_lanes = pack_codes(queries)
    q_rows, valid, ref_np, top_ref, sample = oracle
    searches = {search for _, _, batch in routes for search in batch}
    want = {(nq, count): single.search(queries[:nq], count) for nq, count in sorted(searches)}
    launches = dict.fromkeys(PATH_KERNELS, 0)
    for scan_kernel, recall, batch in routes:
        label = f"[knobs] scan_kernel={scan_kernel!r}" + (f" recall_target={recall}" if recall else "")
        sync(dev)
        t0 = time.perf_counter()
        idx = DeviceNphdIndex.from_arrays(*(host[n] for n in ("keys", "codes", "nlanes", "valid")), device=dev,
                                          scan_kernel=scan_kernel, recall_target=recall)
        idx.search(queries[:1], K)
        sync(dev)
        log(f"{label}: from_arrays + first search (uploads the partitions) {time.perf_counter() - t0:.3f} s; "
            f"device memory {device_memory(dev)} [{CARD.get('smi', 'cpu')}]")
        n_parts = len(idx._partitions)
        for nq, count in batch:
            reset_launches()
            hs.blockmax_mma_unpacked.launches = 0
            scans, stop = spy_routes()
            try:
                t0 = time.perf_counter()
                res = idx.search(queries[:nq], count)
                first_s = time.perf_counter() - t0
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    idx.search(queries[:nq], count)
                    times.append(time.perf_counter() - t0)
            finally:
                stop()
            got = read_launches()
            calls = (reps + 1) * n_parts
            if len(scans) != calls or hs.blockmax_mma_unpacked.launches:
                raise AssertionError(f"{label} Q={nq}: {len(scans)} kernel scans of {calls} partition scans, "
                                     f"blockmax_mma_unpacked launched {hs.blockmax_mma_unpacked.launches} times")
            # Its label keys launches_by_form in the JSON summary (brackets stripped).
            recall_tag = f" recall_target={recall}" if recall else ""
            check_path_launches(f"[knobs {scan_kernel}{recall_tag} Q={nq}]", dev, got, scans)
            for name in PATH_KERNELS:
                launches[name] += got[name]
            keys, scores = padded_results(res, count)
            check_sharded(f"{label} Q={nq} limit {count}", keys, scores, padded_results(want[nq, count], count)[1],
                          q_codes[:nq], q_lanes[:nq], host)
            if count == K:
                part = sample < nq
                check_results(f"{label} Q={nq}", res, q_rows[:nq], valid, ref_np[part], top_ref[part], sample[part])
            med = statistics.median(times)
            log(f"{label} Q={nq} limit {count}: warm median {med * 1e3:.3f} ms of {reps} (min "
                f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; first call {first_s * 1e3:.3f} ms), "
                f"{nq / med:.1f} QPS; launches {got}; equal to 'auto' by score multiset and brute force "
                f"[{CARD.get('smi', 'cpu')}]")
        log(f"{label}: device memory {device_memory(dev)} [{CARD.get('smi', 'cpu')}]")
        idx.close()
        del idx
    log(f"[knobs] every route's answers equal scan_kernel='auto''s; every route took the kernels auto_phase1 names, "
        f"launched {launches}")
    return launches


def mesh_worker(data_dir, rank, world, port, device, chips):
    """One process of a [mesh] cluster (``--mesh-worker``): joins the
    ``torch.distributed`` group (the backend that ``init_distributed``
    chooses), builds the 2-D mesh of ``world`` x ``chips`` shards, then runs
    ``hier_pm1_topk`` over the 256-bit partition and the engine's searches
    in lockstep with the other processes, each uploading only its own row
    block. Each batch's first call gives the answers that are checked; its
    time is the median of ``reps`` calls after it. Writes ``rank<r>.npz`` and
    ``rank<r>.json`` into ``data_dir``."""
    import torch.distributed as dist

    d, dev = Path(data_dir), torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # on the CPU (tests) the cluster's processes share the host
    params = json.loads((d / "params.json").read_text())
    a = {name: np.load(d / f"{name}.npy", mmap_mode="r") for name in MESH_ARRAYS}
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{port}", world, rank)
    report = {"rank": rank, "backend": dist.get_backend(), "join_s": time.perf_counter() - t0}
    mesh = make_mesh_2d(chips_per_host=chips, devices=[dev] * chips, group=dist.group.WORLD)
    out = {}
    q_pm1, q_scale = (torch.from_numpy(t).to(dev) for t in prepare_queries(a["q_codes"], a["q_lanes"], 256))
    packed, valid = shard_pm1_database(mesh, a["pm1_packed"], a["pm1_valid"])
    t0 = time.perf_counter()
    s, i = hier_pm1_topk(mesh, q_pm1, q_scale, packed, valid, K, 256, chunk_size=params["chunk"])
    out["pm1_scores"], out["pm1_rows"] = s.cpu().numpy(), i.cpu().numpy()
    report["pm1_s"] = time.perf_counter() - t0
    report["pm1_shard_rows"] = [int(t.shape[0]) for t in packed]
    del packed, valid

    idx = DeviceNphdIndex.from_arrays(a["keys"], a["codes"], a["nlanes"], a["valid"], device=dev, mesh=mesh)
    queries = bodies_of(np.asarray(a["q_codes"]), np.asarray(a["q_lanes"]))
    t0 = time.perf_counter()
    idx.search(queries[:1], K)  # builds and uploads this process's shards
    report["build_s"] = time.perf_counter() - t0
    reset_launches()
    for nq, count in params["searches"]:
        t0 = time.perf_counter()
        out[f"keys_{nq}_{count}"], out[f"scores_{nq}_{count}"] = padded_results(idx.search(queries[:nq], count), count)
        report[f"first_{nq}_{count}_s"] = time.perf_counter() - t0
        times = []
        for _ in range(params["reps"]):
            t0 = time.perf_counter()
            idx.search(queries[:nq], count)
            times.append(time.perf_counter() - t0)
        report[f"search_{nq}_{count}_s"] = statistics.median(times)
    report["launches"] = read_launches()
    parts = idx._sync_device()
    if any(len(p.packed_dev) != chips or p.packed_dev[0].shape[0] * chips * world != p.cap for p in parts.values()):
        raise AssertionError("a process holds other rows than its own block")
    report["shard_rows"] = {lanes: int(p.packed_dev[0].shape[0]) for lanes, p in parts.items()}
    if dev.type == "cuda":
        report["memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    np.savez(d / f"rank{rank}_{world}.npz", **out)
    (d / f"rank{rank}_{world}.json").write_text(json.dumps(report))
    idx.close()
    dist.destroy_process_group()


def phase_mesh(dev, single, queries, oracle, tmp, shards=MESH_SHARDS, chips=MESH_CHIPS, qs=MESH_QS,
               limit=MESH_LIMIT, chunk=MESH_PM1_CHUNK, timeout=MESH_TIMEOUT_S, reps=7, profile=False):
    """Config 3 row-sharded on the card: the engine over a 1-D mesh of
    ``shards`` shards in this process against the single-device index
    ``single`` (the slice's, same rows and removals) and brute force, the
    int8-twin route per shard (``sharded_pallas_topk``: TPU kernel 4 on a
    search path), then two clusters, one after the other and after this
    process's timed searches, so that no two of them share the card or the
    host: 2 processes x ``chips`` shards over gloo and one process of
    ``shards`` shards in a one-rank group (NCCL on the card), each running
    ``hier_pm1_topk`` and the engine in lockstep; ``timeout`` bounds both
    clusters together. ``profile``: also the mesh index's host split
    and device time by kernel at the first two batches. Returns (the path's launches, kernel 4's
    numbers at the shards' shapes, the clusters' outputs by (rank, world))."""
    rows = single._rows
    host = {"keys": single._keys[:rows], "codes": single._codes[:rows], "nlanes": single._nlanes[:rows],
            "valid": single._valid[:rows]}
    q_codes, q_lanes = pack_codes(queries)
    sel = np.flatnonzero(host["nlanes"] == 8)  # the 256-bit partition, padded for the plain pm1 scan
    n_pm1 = -(-len(sel) // (shards * chunk)) * shards * chunk
    pm1_packed = np.zeros((n_pm1, 8), np.uint32)
    pm1_packed[: len(sel)] = host["codes"][sel]
    pm1_valid = np.zeros(n_pm1, bool)
    pm1_valid[: len(sel)] = host["valid"][sel]
    data = Path(tmp) / "mesh"
    data.mkdir()
    arrays = {**host, "q_codes": q_codes, "q_lanes": q_lanes, "pm1_packed": pm1_packed, "pm1_valid": pm1_valid}
    for name in MESH_ARRAYS:
        np.save(data / f"{name}.npy", arrays[name])
    searches = [(q, K) for q in qs] + [(qs[1], limit)]
    (data / "params.json").write_text(json.dumps({"chunk": chunk, "searches": searches, "reps": reps}))

    mesh = make_mesh(devices=[dev] * shards)
    arrays_of = [host[n] for n in ("keys", "codes", "nlanes", "valid")]
    t0 = time.perf_counter()
    idx = DeviceNphdIndex.from_arrays(*arrays_of, device=dev, mesh=mesh)
    idx.search(queries[:1], K)
    sync(dev)
    log(f"[mesh] {mesh}: from_arrays + first search (builds the sharded partitions): "
        f"{time.perf_counter() - t0:.3f} s; capacity per lane count "
        f"{ {lanes: p.cap for lanes, p in sorted(idx._partitions.items())} } "
        f"(a power of two per shard); device memory {device_memory(dev)}")
    parts = idx._sync_device()
    # The 'pallas' index builds its twins in its first search's sync: their
    # build is timed there, each shard_unpacked_db call between two syncs.
    twin_s, build = [], device_index.shard_unpacked_db

    def timed_build(*args):
        sync(dev)
        t0 = time.perf_counter()
        twins = build(*args)
        sync(dev)
        twin_s.append(time.perf_counter() - t0)
        return twins

    t0 = time.perf_counter()
    device_index.shard_unpacked_db = timed_build
    try:
        pidx = DeviceNphdIndex.from_arrays(*arrays_of, device=dev, mesh=mesh, scan_kernel="pallas")
        pidx.search(queries[:1], K)
    finally:
        device_index.shard_unpacked_db = build
    sync(dev)
    pidx_s = time.perf_counter() - t0
    pparts = pidx._partitions
    if any(p.unpacked_dev is None for p in pparts.values()) or len(twin_s) != len(pparts):
        raise AssertionError("[mesh] scan_kernel='pallas': a partition lacks its int8 twin per shard")
    twin_bytes = sum(t.numel() for p in pparts.values() for t in p.unpacked_dev)
    log(f"[mesh] int8 twin per shard (shard_unpacked_db) of all {len(pparts)} partitions: {sum(twin_s):.4f} s, "
        f"{twin_bytes / 1e9:.3f} GB ({twin_bytes} bytes = rows x nbits); scan_kernel='pallas' mesh index: "
        f"from_arrays + first search (shards and twins) {pidx_s:.3f} s; device memory {device_memory(dev)} "
        f"[{CARD.get('smi', 'cpu')}]")
    xidx = DeviceNphdIndex.from_arrays(*arrays_of, device=dev, mesh=mesh, scan_kernel="xla")
    xidx.search(queries[:1], K)

    # The path, counted: the sharded searches ('auto', then 'pallas': kernel 4
    # from the twin per shard on every search), one 'xla' search (the kernel
    # route per shard), then the int8-twin route per shard called directly.
    reset_launches()
    hs.blockmax_mma_unpacked.launches = 0
    scans, stop = spy_routes()
    got, times, got_p, times_p = {}, {}, {}, {}
    try:
        for nq, count in searches:
            res = idx.search(queries[:nq], count)
            got[nq, count] = res
            if count == K:
                times[nq] = warm_searches(idx, queries[:nq], reps)[1]
        twin_calls, stop_calls = spy_calls(("sharded_pallas_topk",))
        try:
            n_auto = len(scans)
            for nq, count in searches:
                got_p[nq, count] = pidx.search(queries[:nq], count)
                if count == K:
                    times_p[nq] = warm_searches(pidx, queries[:nq], reps)[1]
            twin_searches = hs.blockmax_mma_unpacked.launches
            n_pallas = len(scans)
            got_x = xidx.search(queries[: qs[1]], K)
        finally:
            stop_calls()
    finally:
        stop()
    searched = sum(1 + (reps if count == K else 0) for _, count in searches)
    if twin_calls["sharded_pallas_topk"] != searched * len(pparts) or n_pallas != n_auto:
        raise AssertionError(f"[mesh] scan_kernel='pallas': {twin_calls['sharded_pallas_topk']} calls of "
                             f"sharded_pallas_topk and {n_pallas - n_auto} other scans, expected every partition "
                             f"scan ({searched * len(pparts)}) through sharded_pallas_topk")
    if len(scans) - n_pallas != len(parts) * shards or hs.blockmax_mma_unpacked.launches != twin_searches:
        raise AssertionError(f"[mesh] scan_kernel='xla': {len(scans) - n_pallas} kernel scans, expected one per "
                             f"shard and partition ({len(parts) * shards}), and no twin")
    TWIN_LAUNCHES["mesh searches"] = twin_searches
    if dev.type == "cuda" and TWIN_LAUNCHES["mesh searches"] != searched * len(pparts) * shards:
        raise AssertionError(f"[mesh] the 'pallas' searches launched blockmax_mma_unpacked "
                             f"{TWIN_LAUNCHES['mesh searches']} times, not once per shard and partition scan")
    log(f"[mesh] scan_kernel='pallas': {searched} searches, every partition scan through sharded_pallas_topk, "
        f"blockmax_mma_unpacked launched {TWIN_LAUNCHES['mesh searches']} times by them; scan_kernel='xla' "
        f"(Q={qs[1]}): the kernel route per shard on every partition")
    q_packed = torch.from_numpy(q_codes.view(np.int32)).to(dev)
    q_lanes_dev = torch.from_numpy(q_lanes).to(dev)
    twin_out, kernel4 = {}, []
    for lanes, p in sorted(parts.items()):
        nbits, per_shard, pp = lanes * 32, p.cap // shards, pparts[lanes]
        k = min(_pow2ceil(K), per_shard)
        min_lanes, q_scale = query_prefix(q_lanes_dev, nbits)
        twin_out[lanes] = sharded_pallas_topk(mesh, q_packed, min_lanes, q_scale, pp.packed_dev, pp.unpacked_dev,
                                              pp.valid_dev, k, nbits, merge_k=min(_pow2ceil(K), k * shards))
        with uncounted():
            want = idx._sharded_scan(q_packed, q_lanes_dev, p.packed_dev, p.valid_dev, k, lanes, K, "mma")
            if not all(torch.equal(g, w) for g, w in zip(twin_out[lanes], want)):
                raise AssertionError(f"[mesh] {nbits}-bit: sharded_pallas_topk differs from the sharded engine scan")
            call = (q_packed, min_lanes, q_scale, pp.unpacked_dev[0], pp.valid_dev[0])
            bm, plain = hs.blockmax_mma_unpacked(*call), hs.blockmax_unpacked_plain(*call)
            if not torch.equal(bm, plain):
                raise AssertionError(f"[mesh] {nbits}-bit shard: blockmax_mma_unpacked differs from its plain version")
            nbytes, ops = phase1_work(per_shard, lanes, len(queries))
            nbytes += per_shard * (nbits - lanes * 4)  # the twin: one byte per bit, not the packed row
            b_ms, b_by = bound(nbytes, ops, INT8_OPS_S)
            kernel4.append({"lanes": lanes, "rows": per_shard, "q": len(queries),
                            "ms": time_ms(lambda: hs.blockmax_mma_unpacked(*call), dev, 5),
                            "plain_ms": time_ms(lambda: hs.blockmax_unpacked_plain(*call), dev, 2),
                            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": float((bm - plain).abs().max())})
    sync(dev)
    launches = check_path_launches("[mesh]", dev, read_launches(), scans)
    launches["blockmax_mma_unpacked"] = hs.blockmax_mma_unpacked.launches
    TWIN_LAUNCHES["mesh direct calls"] = launches["blockmax_mma_unpacked"] - TWIN_LAUNCHES["mesh searches"]
    log(f"[mesh] launches of the path (sharded searches under 'auto' and 'pallas' + the int8-twin route per shard "
        f"called directly): {launches}")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"[mesh] a kernel of the path was never launched: {launches}")
    for e in kernel4:
        log(f"[mesh] blockmax_mma_unpacked == plain at a {e['lanes'] * 32}-bit shard ({e['rows']} rows, "
            f"Q={e['q']}): {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}) [{CARD.get('smi', 'cpu')}]")

    # Against the single-device index and brute force.
    q_rows, valid, ref_np, top_ref, sample = oracle
    answers = [("auto", nq, count, res) for (nq, count), res in got.items()]
    answers += [("pallas", nq, count, res) for (nq, count), res in got_p.items()] + [("xla", qs[1], K, got_x)]
    for scan_kernel, nq, count, res in answers:
        label = f"[mesh] scan_kernel={scan_kernel!r} Q={nq} limit {count}"
        keys, scores = padded_results(res, count)
        want_keys, want_scores = padded_results(single.search(queries[:nq], count), count)
        check_sharded(label, keys, scores, want_scores, q_codes[:nq], q_lanes[:nq], host)
        if count == K:
            part = sample < nq
            check_results(label, res, q_rows[:nq], valid, ref_np[part], top_ref[part], sample[part])
    for nq, t in times.items():
        single_t = warm_searches(single, queries[:nq], reps)[1]
        log(f"[mesh] warm search Q={nq} k={K}: {shards} shards median {statistics.median(t) * 1e3:.3f} ms, "
            f"'pallas' (the twin per shard) {statistics.median(times_p[nq]) * 1e3:.3f} ms, "
            f"single device {statistics.median(single_t) * 1e3:.3f} ms ({reps} each) [{CARD.get('smi', 'cpu')}]")
    pidx.close()
    xidx.close()
    del pidx, xidx, pparts
    if profile:
        for nq in qs[:2]:
            phase_profile(idx, queries[:nq], "auto", name="mesh")
    log(f"[mesh] {shards} shards at Q={qs} k={K} and limit {limit}, under 'auto' and 'pallas' (and 'xla' at "
        f"Q={qs[1]}): score multisets equal the single-device index's, every row carries its brute-force score, no "
        f"removed key; {N_ORACLE} sampled queries against brute force; the int8-twin route per shard equals the "
        f"sharded scan")

    # The in-process references of the clusters' hier_pm1_topk.
    q_pm1, q_scale = (torch.from_numpy(t).to(dev) for t in prepare_queries(q_codes, q_lanes, 256))
    ref_pm1 = {}
    for world, per in ((2, chips), (1, shards)):
        grid = make_mesh_2d(world, per, devices=[dev] * (world * per))
        packed, pvalid = shard_pm1_database(grid, pm1_packed, pm1_valid)
        ref_pm1[world] = [t.cpu().numpy() for t in hier_pm1_topk(grid, q_pm1, q_scale, packed, pvalid, K, 256,
                                                                   chunk_size=chunk)]
        del packed, pvalid
    deadline = time.perf_counter() + timeout
    outs = {}
    for world, per in ((2, chips), (1, shards)):
        outs.update(run_cluster(data, dev, world, per, deadline))

    pm1_lanes = np.full(n_pm1, 8, np.int32)
    for (rank, world), (out, report) in sorted(outs.items()):
        label = f"[mesh] {world}-process cluster, rank {rank} ({report['backend']})"
        want_backend = "nccl" if world == 1 and dev.type == "cuda" else "gloo"
        if report["backend"] != want_backend:
            raise AssertionError(f"{label}: init_distributed chose {report['backend']}, expected {want_backend}")
        s, r = out["pm1_scores"], out["pm1_rows"]
        if world > 1 and not (np.array_equal(s, ref_pm1[world][0]) and np.array_equal(r, ref_pm1[world][1])):
            raise AssertionError(f"{label}: hier_pm1_topk differs from the same 2 x {chips} mesh in one process")
        if not np.array_equal(s, ref_pm1[world][0]):
            raise AssertionError(f"{label}: hier_pm1_topk scores differ from one process's")
        direct = row_scores(q_codes, q_lanes, pm1_packed, pm1_lanes, r)
        if not (pm1_valid[r[r >= 0]].all() and np.allclose(direct[r >= 0], s[r >= 0], rtol=0, atol=SCORE_ATOL)):
            raise AssertionError(f"{label}: hier_pm1_topk rows do not carry their brute-force scores")
        for nq, count in searches:
            keys, scores = out[f"keys_{nq}_{count}"], out[f"scores_{nq}_{count}"]
            check_sharded(f"{label} Q={nq} limit {count}", keys, scores, padded_results(got[nq, count], count)[1],
                          q_codes[:nq], q_lanes[:nq], host)
        if dev.type == "cuda" and min(report["launches"][n] for n in ("blockmax", "blockmax_small", "gather_rescore",
                                                                        "blockmax_mma_packed")) <= 0:
            raise AssertionError(f"{label}: the engine's searches skipped a kernel: {report['launches']}")
        log(f"{label}: joined in {report['join_s']:.2f} s; rows per shard {report['shard_rows']}, built in "
            f"{report['build_s']:.3f} s; hier_pm1_topk over {n_pm1} rows {report['pm1_s']:.3f} s "
            f"(equal to one process's); engine searches " + ", ".join(
                f"Q={nq}/{count} {report[f'search_{nq}_{count}_s'] * 1e3:.1f} ms" for nq, count in searches)
            + f" (median of {reps} after a first call of "
            + ", ".join(f"{report[f'first_{nq}_{count}_s'] * 1e3:.1f}" for nq, count in searches)
            + f" ms; equal to {shards} shards in one process); launches {report['launches']}"
            + (f"; peak device memory {report['memory_gib']:.3f} GiB" if "memory_gib" in report else ""))
    if not all(np.array_equal(outs[0, 2][0][k], outs[1, 2][0][k]) for k in outs[0, 2][0]):
        raise AssertionError("[mesh] the two processes' answers differ")
    idx.close()
    return launches, kernel4, outs


def state_digest(engine):
    """sha256 of an engine's host rows (keys, codes, lane counts, validity):
    equal digests, equal replicas."""
    n = engine._rows
    h = hashlib.sha256()
    for a in (engine._keys[:n], engine._codes[:n], engine._nlanes[:n], engine._valid[:n]):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def multihost_worker(data_dir, rank, port, ctrl_port, device):
    """One rank of [multihost] (a) (``--multihost-worker``): joins the
    two-process ``torch.distributed`` group (gloo: both ranks share one
    card), holds ``DeviceNphdIndex(mesh=make_mesh_2d(2, 1))`` and its end of
    the control channel (``MultihostService``). Rank 0, the coordinator,
    hooks its engine and drives it (:func:`multihost_coordinator`); rank 1
    gets its rows only over the channel, in ``follow()``, and joins each
    search's merge. Each rank counts its launches from its start and writes
    ``rank<r>.json`` (and rank 0 ``rank0.npz``, its answers) into
    ``data_dir``."""
    import torch.distributed as dist

    from iscc_search_tpu_torch.parallel.service import MultihostService

    d, dev = Path(data_dir), torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # on the CPU (tests) both ranks share the host
    params = json.loads((d / "params.json").read_text())
    CARD.update(params["card"])  # phase_device's reading of the card, for the bounds
    reset_launches()
    scans, stop = spy_routes()
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{port}", 2, rank)
    report = {"rank": rank, "backend": dist.get_backend(), "join_s": time.perf_counter() - t0}
    idx = DeviceNphdIndex(None, device=dev, mesh=make_mesh_2d(2, 1, device=dev))
    t0 = time.perf_counter()
    svc = MultihostService(rank == 0, n_followers=1, host="127.0.0.1", coordinator_host="127.0.0.1", port=ctrl_port,
                           timeout=params["timeout"])
    report["connect_s"] = time.perf_counter() - t0
    try:
        if rank == 0:
            out = multihost_coordinator(svc, idx, d, params, dev, report)
        else:
            applied = report["applied"] = []

            def timed(op, impl):
                def run(*args):
                    t0 = time.perf_counter()
                    try:
                        return impl(*args)
                    finally:
                        applied.append((op, time.perf_counter() - t0))
                return run

            for op in ("add", "add_packed", "remove", "search"):
                setattr(idx, f"_{op}_impl", timed(op, getattr(idx, f"_{op}_impl")))

            def resolve(name):
                if name != MULTIHOST_NAME:
                    raise ValueError(f"an op for {name!r}: this follower holds {MULTIHOST_NAME!r}")
                return idx

            svc.follow(resolve)  # until the coordinator's stop op
    finally:
        stop()
    report.update(launches=read_launches(), scans=scans, by_form=dict(hs.gather_rescore.by_form),
                  rows=idx._rows, live=idx._live, digest=state_digest(idx), save_enabled=idx.save_enabled)
    if rank == 0:
        svc.stop()  # releases the follower
        report["kernels"] = multihost_kernel_stats(dev, idx, bodies_of(np.load(d / "q_codes.npy"),
                                                                        np.load(d / "q_lanes.npy")), params)
        np.savez(d / "rank0.npz", **out)
    else:
        svc.stop()
    if dev.type == "cuda":
        report["memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    (d / f"rank{rank}.json").write_text(json.dumps(report))
    idx.close()
    dist.destroy_process_group()


def multihost_coordinator(svc, idx, d, params, dev, report):
    """Rank 0 of [multihost] (a): config 3's codes made from the seed (the
    draw ``main()`` makes first, checked against the single-device index's
    rows by digest), the same adds without a hook timed, then ``idx`` hooked
    and driven: ``add_packed`` in batches, ``remove`` of every
    ``tombstone_every``-th key, ``add`` of the slice's appended rows,
    ``check``, and each search's first call (its answers) and ``reps``
    warm calls. Every hooked op's time is split into its local part and
    the channel's (pickle, send and, for a mutation, the follower's apply
    and ack). Returns the answers by search."""
    n, batch = params["n_rows"], params["batch"]
    t0 = time.perf_counter()
    codes, lanes = random_codes(np.random.default_rng(params["seed"]), n)
    report["make_s"] = time.perf_counter() - t0
    if hashlib.sha256(codes.tobytes() + lanes.tobytes()).hexdigest() != params["digest"]:
        raise AssertionError("[multihost] the codes made from the seed are not the single-device index's rows")
    keys = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    plain = DeviceNphdIndex(None, device=dev)  # the same adds without a hook
    t0 = time.perf_counter()
    for s in range(0, n, batch):
        plain.add_packed(keys[s : s + batch], codes[s : s + batch], lanes[s : s + batch])
    report["plain_ingest_s"] = time.perf_counter() - t0
    del plain

    svc.hook(MULTIHOST_NAME, idx)
    hook, ops = idx.control_hook, report.setdefault("ops", [])

    def timed(op, args, local):
        spent = {}

        def run_local():
            t0 = time.perf_counter()
            try:
                return local()
            finally:
                spent["local"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        result = hook(op, args, run_local)
        total = time.perf_counter() - t0
        t0 = time.perf_counter()
        size = len(pickle.dumps((op, MULTIHOST_NAME) + args, protocol=pickle.HIGHEST_PROTOCOL))
        ops.append({"op": op, "n": len(args[0]), "total_s": total, "local_s": spent["local"],
                    "pickle_s": time.perf_counter() - t0, "bytes": size})
        return result

    idx.control_hook = timed
    t0 = time.perf_counter()
    for s in range(0, n, batch):
        idx.add_packed(keys[s : s + batch], codes[s : s + batch], lanes[s : s + batch])
    report["ingest_s"] = time.perf_counter() - t0
    del codes, lanes, keys
    removed = np.arange(0, n, params["tombstone_every"])
    if idx.remove(removed.tolist()) != len(removed):
        raise AssertionError("[multihost] the mirrored remove missed keys")
    app_codes, app_lanes = np.load(d / "append_codes.npy"), np.load(d / "append_lanes.npy")
    idx.add(list(range(n, n + len(app_lanes))), bodies_of(app_codes, app_lanes))
    t0 = time.perf_counter()
    svc.check(MULTIHOST_NAME, idx._rows, idx._live)
    report["check_s"] = time.perf_counter() - t0
    queries = bodies_of(np.load(d / "q_codes.npy"), np.load(d / "q_lanes.npy"))
    out = {}
    for nq, count in params["searches"]:
        t0 = time.perf_counter()
        out[f"keys_{nq}_{count}"], out[f"scores_{nq}_{count}"] = padded_results(idx.search(queries[:nq], count), count)
        report[f"first_{nq}_{count}_s"] = time.perf_counter() - t0
        times = []
        for _ in range(params["reps"]):
            t0 = time.perf_counter()
            idx.search(queries[:nq], count)
            times.append(time.perf_counter() - t0)
        report[f"search_{nq}_{count}_s"] = statistics.median(times)
    return out


def multihost_kernel_stats(dev, idx, queries, params):
    """The kernels the cluster's searches launched, each against its plain
    version on this process's shard of the widest partition at the
    searches' shapes: the phase-1 kernel ``auto_phase1`` names at each Q
    (``path_kernel_stats``), and ``gather_rescore`` of the top-kk blocks of
    the k=10 search at the first Q and the limit search at the second (the
    engine's kk: k bucketed to a power of two). Uncounted."""
    p = idx._sync_device()[max(idx._sync_device())]
    lanes = p.packed_dev[0].shape[1]
    part = types.SimpleNamespace(cap=p.packed_dev[0].shape[0], packed_dev=p.packed_dev[0], valid_dev=p.valid_dev[0])
    qs, limit = params["qs"], params["limit"]
    shapes = [(ROUTE_KERNELS[auto_phase1(nq, lanes)], nq, None) for nq in qs]
    label = f"[multihost] rank 0 shard of the {lanes * 32}-bit partition"
    with uncounted():
        stats = path_kernel_stats(label, dev, part, queries, shapes)
        q_codes, q_lanes = pack_codes(queries)
        for nq, count in ((qs[0], K), (qs[1], limit)):
            kk = min(_pow2ceil(count), part.cap // hs.BLOCK)
            q_packed = torch.from_numpy(q_codes[:nq].view(np.int32)).to(dev)
            min_lanes, q_scale = query_prefix(torch.from_numpy(q_lanes[:nq]).to(dev), lanes * 32)
            block_ids = topk_blocks_hier(hs.blockmax_mma_packed(q_packed, min_lanes, q_scale, part.packed_dev,
                                                                part.valid_dev), kk).to(torch.int32)
            call = (q_packed, min_lanes, block_ids, part.packed_dev)
            got, want = hs.gather_rescore(*call), hs.gather_rescore_plain(*call)
            sync(dev)
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: gather_rescore at Q={nq}, kk={kk} != plain")
            blocks = int(torch.unique(block_ids).numel())
            nbytes, ops = gather_work(nq, kk, lanes, blocks)
            b_ms, b_by = bound(nbytes, ops, popc_per_s() if dev.type == "cuda" else 1e12)
            ms = time_ms(functools.partial(hs.gather_rescore, *call), dev, GATHER_REPS if dev.type == "cuda" else 1,
                         graph=True)
            plain_ms = time_ms(functools.partial(hs.gather_rescore_plain, *call), dev, 1)
            stats.setdefault("gather_rescore", []).append({
                "q": nq, "kk": kk, "cap": part.cap, "form": hs.gather_form(nq, kk, part.cap // hs.BLOCK, lanes),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": float((got - want).abs().max())})
            log(f"{label} gather_rescore at Q={nq}, kk={kk} (cap {part.cap}): kernel == plain; {ms:.4f} ms (plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by})")
    return stats


def phase_multihost(dev, single, queries, oracle, tmp, seed, mesh_outs=None, n_rows=N_ROWS, batch=MULTIHOST_BATCH,
                    qs=MESH_QS, limit=MESH_LIMIT, reps=7, timeout=MULTIHOST_TIMEOUT_S):
    """[multihost] (a): config 3 served by one engine over two processes on
    one card, through the multi-host control plane. Rank 0 makes config 3's
    ``n_rows`` codes from ``seed`` and mirrors every mutation to rank 1
    (``add_packed`` in batches of ``batch``, the removal of every 64th key,
    the slice's appended rows), then runs the searches at Q = ``qs`` (k=10)
    and ``qs[1]`` at ``limit``: the answers equal the single-device index
    ``single`` (the slice's, same rows and removals) by score multiset and
    brute force, the replicas end equal to it, and each kernel the path
    launched equals its plain version on rank 0 at the searches' shapes.
    ``mesh_outs``: [mesh]'s clusters, whose gloo pair's times are printed
    beside. Returns (the launches of both ranks, the kernels' numbers at the
    cluster's shapes)."""
    rows = single._rows
    host = {"keys": single._keys[:rows], "codes": single._codes[:rows], "nlanes": single._nlanes[:rows],
            "valid": single._valid[:rows]}
    card = CARD.get("smi", str(dev))
    data = Path(tmp) / "multihost"
    data.mkdir()
    q_codes, q_lanes = pack_codes(queries)
    for name, array in (("append_codes", host["codes"][n_rows:]), ("append_lanes", host["nlanes"][n_rows:]),
                        ("q_codes", q_codes), ("q_lanes", q_lanes)):
        np.save(data / f"{name}.npy", array)
    searches = [(q, K) for q in qs] + [(qs[1], limit)]
    digest = hashlib.sha256(np.ascontiguousarray(host["codes"][:n_rows]).tobytes()
                            + np.ascontiguousarray(host["nlanes"][:n_rows]).tobytes()).hexdigest()
    (data / "params.json").write_text(json.dumps({
        "seed": seed, "n_rows": n_rows, "batch": batch, "searches": searches, "reps": reps, "qs": list(qs),
        "limit": limit, "tombstone_every": TOMBSTONE_EVERY, "digest": digest, "timeout": timeout, "card": CARD}))
    port, ctrl, procs, texts = _free_port(), _free_port(), [], []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            cmd = [sys.executable, str(Path(__file__).resolve()), "--multihost-worker", str(data), str(rank), str(port),
                   str(ctrl), str(dev)]
            procs.append(subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        for rank, proc in enumerate(procs):
            text, _ = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            texts.append(text)
            if proc.returncode:
                raise AssertionError(f"[multihost] rank {rank} failed (exit {proc.returncode}):\n{text[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    reports = [json.loads((data / f"rank{r}.json").read_text()) for r in range(2)]
    out = dict(np.load(data / "rank0.npz"))
    coord, follower = reports

    # Both replicas are the single-device index's rows, tombstones and all.
    want_digest = state_digest(single)
    for r in reports:
        if r["backend"] != "gloo":
            raise AssertionError(f"[multihost] rank {r['rank']}: init_distributed chose {r['backend']}, two ranks on one "
                                 f"card take gloo")
        if (r["rows"], r["live"], r["digest"]) != (single._rows, single._live, want_digest):
            raise AssertionError(f"[multihost] rank {r['rank']}: replica of {r['rows']} rows / {r['live']} live differs "
                                 f"from the single-device index's {single._rows} / {single._live}")
    if follower["save_enabled"]:
        raise AssertionError("[multihost] the follower's replica would save")
    q_rows, valid, ref_np, top_ref, sample = oracle
    for nq, count in searches:
        keys, scores = out[f"keys_{nq}_{count}"], out[f"scores_{nq}_{count}"]
        _, want_scores = padded_results(single.search(queries[:nq], count), count)
        check_sharded(f"[multihost] Q={nq} limit {count}", keys, scores, want_scores, q_codes[:nq], q_lanes[:nq], host)
        if count == K:
            part = sample < nq
            res = [(keys[qi][keys[qi] >= 0].astype(">u8").view(np.uint8).reshape(-1, 8),
                    scores[qi][keys[qi] >= 0]) for qi in range(nq)]
            check_results(f"[multihost] Q={nq}", res, q_rows[:nq], valid, ref_np[part], top_ref[part], sample[part])
    for line in texts[0].splitlines():  # rank 0's kernel-against-plain lines
        if line.startswith("[multihost] rank 0"):
            log(line)
    launches = {name: coord["launches"][name] + follower["launches"][name] for name in PATH_KERNELS}
    forms = {form: coord["by_form"][form] + follower["by_form"][form] for form in hs.GATHER_FORMS}
    check_path_launches("[multihost]", dev, launches, [tuple(x) for x in coord["scans"] + follower["scans"]], forms)
    if coord["launches"] != follower["launches"]:
        raise AssertionError(f"[multihost] the ranks launched differently: {coord['launches']} / {follower['launches']}")

    n_batches = -(-n_rows // batch)
    log(f"[multihost] 2 ranks on {card} over gloo: joined in {coord['join_s']:.2f} / {follower['join_s']:.2f} s, the "
        f"control channel connected in {coord['connect_s']:.2f} s; both ran to their end in {wall:.1f} s")
    log(f"[multihost] mirrored ingest [{card}]: {n_rows} rows in {n_batches} add_packed ops of {batch} rows: "
        f"{coord['ingest_s']:.3f} s, {n_rows / coord['ingest_s']:.0f} rows/s; the same adds without a hook: "
        f"{coord['plain_ingest_s']:.3f} s, {n_rows / coord['plain_ingest_s']:.0f} rows/s (codes made from the seed in "
        f"{coord['make_s']:.1f} s); check {coord['check_s'] * 1e3:.3f} ms")
    applied = {}
    for op, secs in follower["applied"]:
        applied.setdefault(op, []).append(secs)
    by_op = {}
    for e in coord["ops"]:
        by_op.setdefault((e["op"], e["n"] if e["op"] == "search" else None), []).append(e)
    for (op, nq), entries in by_op.items():
        med = {k: statistics.median(e[k] for e in entries) * 1e3 for k in ("total_s", "local_s", "pickle_s")}
        what = f"search Q={nq}" if op == "search" else op
        follower_ms = (f", the follower's apply median {statistics.median(applied[op]) * 1e3:.3f} ms"
                       if op in applied and op != "search" else "")
        log(f"[multihost] op {what:14s} x{len(entries):3d} [{card}]: channel median {med['total_s'] - med['local_s']:.3f} "
            f"ms (pickle {med['pickle_s']:.3f} ms of {statistics.median(e['bytes'] for e in entries):.0f} bytes, send"
            + (", the follower's apply and ack" if op != "search" else ", no ack") + f"{follower_ms}), local "
            f"{med['local_s']:.3f} ms")
    gloo_pair = (mesh_outs or {}).get((0, 2), (None, {}))[1]
    for nq, count in searches:
        pair = gloo_pair.get(f"search_{nq}_{count}_s")
        log(f"[multihost] warm search Q={nq} limit {count} [{card}]: median {coord[f'search_{nq}_{count}_s'] * 1e3:.3f} "
            f"ms of {reps} (first call {coord[f'first_{nq}_{count}_s'] * 1e3:.1f} ms); [mesh]'s gloo pair (2 x "
            f"{MESH_CHIPS} shards, no control plane): " + (f"{pair * 1e3:.3f} ms" if pair is not None else "not run"))
    log(f"[multihost] launches of both ranks: {launches} (rank 0: {coord['launches']}); answers equal the "
        f"single-device index by score multiset and brute force on {len(sample)} sampled queries, no removed key; the "
        f"replicas equal its rows" + (f"; peak device memory per rank {coord['memory_gib']:.3f} / "
                                      f"{follower['memory_gib']:.3f} GiB" if "memory_gib" in coord else ""))
    return launches, coord["kernels"]


def run_cluster(data, dev, world, per, deadline):
    """Run the ``world`` processes of one [mesh] cluster (``per`` shards
    each) to their end before ``deadline`` (``time.perf_counter()``);
    raise if one fails or runs past it, and kill the others then. Returns
    their (arrays, report) by (rank, world)."""
    port, procs, outs = _free_port(), {}, {}
    try:
        for rank in range(world):
            cmd = [sys.executable, str(Path(__file__).resolve()), "--mesh-worker", str(data), str(rank), str(world),
                   str(port), str(dev), str(per)]
            procs[rank, world] = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
        for key, proc in procs.items():
            text, _ = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
            if proc.returncode:
                raise AssertionError(f"[mesh] cluster process {key} failed (exit {proc.returncode}):\n{text[-4000:]}")
            outs[key] = (dict(np.load(data / f"rank{key[0]}_{key[1]}.npz")),
                         json.loads((data / f"rank{key[0]}_{key[1]}.json").read_text()))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


# ------------------------------------------------- config 4: the simprint path


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spy_routes():
    """Record (Q, lanes, phase1, route of phases 2-3) of every partition
    scan the engine makes (its call of ``blockmax_topk_packedq_impl``) until
    ``stop()`` is called. Returns (the list of scans, stop)."""
    seen = []
    real = device_index.blockmax_topk_packedq_impl

    def spy(*args, phase1, **kwargs):
        db, k = args[2], args[4]
        seen.append((args[0].shape[0], args[5] // 32, phase1, hs.scan_route(db.device, k, db.shape[0])))
        return real(*args, phase1=phase1, **kwargs)

    def stop():
        device_index.blockmax_topk_packedq_impl = real

    device_index.blockmax_topk_packedq_impl = spy
    return seen, stop


def spy_calls(names):
    """Count the engine's calls of the route functions ``names`` of
    ``engine/device_index.py`` until ``stop()`` is called. Returns (the
    counts by name, stop)."""
    seen = dict.fromkeys(names, 0)
    real = {name: getattr(device_index, name) for name in names}

    def counting(name):
        def call(*args, **kwargs):
            seen[name] += 1
            return real[name](*args, **kwargs)
        return call

    def stop():
        for name, fn in real.items():
            setattr(device_index, name, fn)

    for name in names:
        setattr(device_index, name, counting(name))
    return seen, stop


def check_path_launches(label, dev, launches, scans, forms=None):
    """Raise unless every scan of ``scans`` (``spy_routes()``) took the phase-1
    kernel ``auto_phase1`` names for its batch and width and, on a card, the
    path launched each kernel so named and each phases 2-3 kernel its scans'
    routes name (``PHASE23_KERNELS``), and no other. ``forms``:
    ``gather_rescore``'s calls by form where the path ran in other processes
    (else this process's). Returns ``launches``."""
    for nq, lanes, phase1, _ in scans:
        if phase1 != auto_phase1(nq, lanes):
            raise AssertionError(f"{label}: a Q={nq} scan of a {lanes * 32}-bit partition took {phase1!r}, "
                                 f"'auto' names {auto_phase1(nq, lanes)!r}")
    named = {hs.PHASE1[phase1].__name__ for _, _, phase1, _ in scans} | {PHASE23_KERNELS[r] for *_, r in scans}
    PATH_FORMS[label] = dict(hs.gather_rescore.by_form if forms is None else forms)
    if dev.type == "cuda":
        for name in PATH_KERNELS:
            if (launches[name] > 0) != (name in named):
                raise AssertionError(f"{label}: {name} launched {launches[name]} times; the path's scans name {sorted(named)}")
        if sum(PATH_FORMS[label].values()) != launches["gather_rescore"]:
            raise AssertionError(f"{label}: gather_rescore's calls by form {PATH_FORMS[label]} do not sum to its launches")
    log(f"{label} gather_rescore calls of the path by form: {PATH_FORMS[label]}")
    return launches


def reset_launches():
    for fn in (*hs.PHASE1.values(), hs.gather_rescore, hs.select_rescore_topk):
        fn.launches = 0
    hs.gather_rescore.by_form = dict.fromkeys(hs.GATHER_FORMS, 0)


def read_launches():
    return {name: getattr(hs, name).launches for name in PATH_KERNELS}


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are not the path's: the counts are put back
    as they were (kernel-against-plain checks made within a path's run)."""
    saved = {fn: fn.launches for fn in (*hs.PHASE1.values(), hs.gather_rescore, hs.select_rescore_topk)}
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


_IDLE = {"wait", "select", "poll", "accept", "sleep", "_wait_for_tstate_lock", "recv_into", "readinto", "get",
         "acquire", "_recv_exact", "serve_forever", "_accept_loop", "join"}


def sample_stacks(tag, fn, interval=0.005, top=10):
    """Where every thread's time goes during ``fn()`` (it may hand work to
    other threads: the batchers, an IPC handler): a sampler thread reads
    ``sys._current_frames()`` every ``interval`` s and counts, per busy
    thread (its innermost frame not an idle wait), the innermost function of
    the port and the innermost function of all. Returns ``fn()``'s result;
    logs the wall time and the top functions by share of the samples."""
    import collections

    port_hits, inner_hits, samples, done = collections.Counter(), collections.Counter(), [0], threading.Event()

    def sampler():
        while not done.wait(interval):
            samples[0] += 1
            for ident, frame in sys._current_frames().items():
                if ident == threading.get_ident() or frame.f_code.co_name in _IDLE:
                    continue
                inner = f"{frame.f_code.co_name} ({Path(frame.f_code.co_filename).name})"
                port = None
                while frame is not None and port is None:
                    if "iscc_search_tpu_torch" in frame.f_code.co_filename:
                        port = f"{frame.f_code.co_name} ({Path(frame.f_code.co_filename).name}:{frame.f_lineno})"
                    frame = frame.f_back
                inner_hits[inner] += 1
                port_hits[port or "(outside the port)"] += 1

    thread = threading.Thread(target=sampler, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        out = fn()
    finally:
        done.set()
        thread.join(5)
    wall = time.perf_counter() - t0
    n = max(samples[0], 1)
    log(f"{tag} {wall:.3f} s; {samples[0]} samples of every busy thread every {interval * 1e3:.0f} ms, the innermost "
        "function of the port: " + ", ".join(f"{k} {100 * v / n:.1f}%" for k, v in port_hits.most_common(top)))
    log(f"{tag} the innermost function of all: " + ", ".join(f"{k} {100 * v / n:.1f}%"
                                                          for k, v in inner_hits.most_common(top)))
    return out


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
        f"Q in {sorted({nq for nq, *_ in scans})}; device memory {device_memory(dev)}")
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
    path = Path(tmp) / PRODUCT_BASE / PRODUCT_NAME  # alone in its base directory: [server] serves it
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
        f"(Q, lanes) in {sorted({(nq, lanes) for nq, lanes, *_ in scans})}")

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
    direct_rate = len(work) / wall
    log(f"[product] {clients} concurrent clients x {per_client} 'both' requests: {wall:.3f} s, "
        f"{direct_rate:.1f} query assets/s; {sweeps} device sweeps for {fused:.0f} queries "
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
    return launches, stats, truth, direct_rate


# ---------------------------------------------------------- the REST server


def product_query(i, t, kind):
    """The wire query of product asset ``i`` (host truth ``t``) by ``kind``:
    its units, its simprints, both, its ISCC-ID, or an ISCC-CODE of its META,
    CONTENT, DATA and INSTANCE units (the GET route's query)."""
    w = product_wire(i, t)
    sp = {PRODUCT_SP: [v["simprint"] for v in w["simprints"][PRODUCT_SP]]}
    if kind == "iscc_code":
        return {"iscc_code": ic.gen_iscc_code_v0([w["units"][k] for k in (0, 2, 3, 4)])["iscc"]}
    return {"units": {"units": w["units"]}, "simprints": {"simprints": sp},
            "both": {"units": w["units"], "simprints": sp}, "iscc_id": {"iscc_id": w["iscc_id"]}}[kind]


def http_json(base, method, route, payload=None, headers=None):
    """(status, body, headers) of one request through ``urllib`` on a new
    connection; a JSON body parsed, any other as text."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + route, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, body, hdrs = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, e.read(), e.headers
    if body and (hdrs.get("Content-Type") or "").startswith("application/json"):
        return status, json.loads(body), hdrs
    return status, body.decode(), hdrs


class ServedApp:
    """``create_app`` over ``index`` served by ``PooledHTTPServer`` on
    127.0.0.1 at a free port, in a thread, with the options' transport
    settings; ``close()`` stops it."""

    def __init__(self, index, opts):
        self.srv = PooledHTTPServer("127.0.0.1", 0, create_app(index=index, opts=opts), threads=opts.http_threads,
                                    max_pending=opts.http_max_pending,
                                    queue_deadline=opts.http_queue_deadline_ms / 1000.0)
        self.base = f"http://127.0.0.1:{self.srv.server_port}"
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.srv.server_close()
        self.thread.join(10)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dump(model):
    """What the app's routes answer for ``model`` (server/app.py ``_dump``)."""
    return model.model_dump(mode="json", exclude_unset=True, exclude_none=True)


def _threads(fn, parts):
    """Run ``fn(part)`` for each part on a thread of its own; raise the first
    error. Returns the wall time in seconds."""
    errors = []

    def run(part):
        try:
            fn(part)
        except Exception as exc:  # noqa: BLE001 - raised below, the phase fails
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(part,)) for part in parts]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("a client thread did not finish in 300 s")
    return wall


def roundtrip_assets(n, first):
    """``n`` wire assets with META, CONTENT, DATA and INSTANCE units of 64
    bits and their ISCC-CODE (the memory:// backend matches codes only)."""
    rng = np.random.default_rng(first)
    kinds = ((ic.MT.META, ic.ST.NONE), (ic.MT.CONTENT, ic.ST_CC.TEXT), (ic.MT.DATA, ic.ST.NONE),
             (ic.MT.INSTANCE, ic.ST.NONE))
    out = []
    for j in range(n):
        units = [_unit(m, st, rng.bytes(8)) for m, st in kinds]
        out.append({"iscc_id": product_iscc_id(first + j), "iscc_code": ic.gen_iscc_code_v0(units)["iscc"],
                    "units": units, "metadata": {"name": f"round trip {j}"}})
    return out


def phase_server(rng, dev, tmp, truth, direct_rate, n_new=SERVER_NEW_ASSETS, n_sp=PRODUCT_SIMPRINTS,
                 n_kv=SERVER_KV_ASSETS, reps=PRODUCT_REPS, clients=PRODUCT_CLIENTS, per_client=PRODUCT_PER_CLIENT):
    """The REST front on the card: the product index opened through the
    backend factory (``get_index("tpu://...")``, the card by default), served
    by ``create_app`` on ``PooledHTTPServer`` over real sockets; every search
    kind at limit 10 and 100 through the port's ``RemoteIndex`` and ``urllib``,
    each body equal to the direct ``search_assets`` call's on the same
    manager; 8 keep-alive clients; 1,000 assets added over HTTP and each
    found by a search; the error codes; ``serve()`` itself in a subprocess,
    stopped by SIGTERM; the memory:// and kv:// backends. Returns the path's
    kernel launches (the HTTP requests' alone) and what [scaleout] is held
    to: the direct answers of the reopened index (every kind at limit 10 and
    100 for the picked assets, and the 8 clients' ``both`` requests), and
    the single-process figures. On the card the factory and ``serve()`` take
    their default device; elsewhere they are given ``dev``."""
    base_dir, name, n = Path(tmp) / PRODUCT_BASE, PRODUCT_NAME, len(truth)
    t_phase = time.perf_counter()

    def slog(msg):  # each line with the phase's elapsed seconds: where its time goes
        log(f"{msg} [{time.perf_counter() - t_phase:.1f} s]")

    on_card = {} if dev.type == "cuda" else {"device": dev}
    card = CARD.get("smi", str(dev))  # every timing line names the card and its power limit
    t0 = time.perf_counter()
    manager = get_index(f"tpu://{base_dir}", **on_card)
    listed = manager.list_indexes()
    if manager.device.type != dev.type or [(i.name, i.assets) for i in listed] != [(name, n)]:
        raise AssertionError(f"[server] get_index('tpu://...'): device {manager.device}, indexes {listed}")
    opts = SearchOptions(index_uri=f"tpu://{base_dir}", host="127.0.0.1", port=0)
    served = ServedApp(manager, opts)
    slog(f"[server] get_index('tpu://.../{PRODUCT_BASE}') on {manager.device} ({[i.name for i in listed]}, {n} assets) "
        f"+ create_app + PooledHTTPServer ({opts.http_threads} threads) on {served.base}: "
        f"{time.perf_counter() - t0:.3f} s")
    try:
        # The probes and the index routes: each body what the direct call gives.
        for route, want in (
            ("/healthz", {"status": "ok"}), ("/readyz", {"status": "ready"}),
            ("/status", {"version": iscc_search_tpu_torch.__version__, "mode": "standard"}),
            ("/indexes", [_dump(i) for i in manager.list_indexes()]),
            (f"/indexes/{name}", _dump(manager.get_index(name))), ("/openapi.json", build_openapi()),
        ):
            status, body, _ = http_json(served.base, "GET", route)
            if (status, body) != (200, want):
                raise AssertionError(f"[server] GET {route}: {status} {str(body)[:300]}")
        status, body, hdrs = http_json(served.base, "GET", "/metrics")
        if status != 200 or 'iscc_http_requests_total{method="GET",route="/healthz",status="200"} 1' not in body:
            raise AssertionError(f"[server] GET /metrics: {status} {body[:300]}")
        slog("[server] GET /healthz, /readyz, /status, /indexes, /indexes/{name}, /openapi.json, /metrics: 200, "
            "each body what the direct call gives")

        # The direct answers and times, before the path's counted run.
        picks = list(range(0, 10 * reps, 10))
        kinds = ("units", "simprints", "both", "iscc_id", "iscc_code")
        cases = [(kind, limit) for kind in kinds for limit in (10, 100)]

        def direct(q, limit):
            return manager.search_assets(name, schema.IsccQuery(**q), limit).model_dump(mode="json", exclude_none=True)

        for kind, limit in cases:  # warm: the reopened index builds and uploads its partitions
            direct(product_query(picks[0], truth[picks[0]], kind), limit)
        want, direct_ms = {}, {}
        for kind, limit in cases:
            times = []
            for i in picks:
                q = product_query(i, truth[i], kind)
                t0 = time.perf_counter()
                want[kind, limit, i] = direct(q, limit)
                times.append(time.perf_counter() - t0)
            direct_ms[kind, limit] = statistics.median(times) * 1e3
        work = list(range(10 * reps, 10 * (reps + clients * per_client), 10))
        want_both = {i: direct(product_query(i, truth[i], "both"), 10) for i in work}

        # The path: HTTP requests alone, the counts set to 0 just before.
        reset_launches()
        scans, stop = spy_routes()
        remote = RemoteIndex(served.base, name, chunk_size=SERVER_CHUNK)
        http_ms = {}
        for kind, limit in cases:
            times = []
            for i in picks:
                q = product_query(i, truth[i], kind)
                t0 = time.perf_counter()
                if kind == "iscc_code":
                    r = remote.request("GET", f"/indexes/{name}/search", params={**q, "limit": limit})
                else:
                    r = remote.request("POST", f"/indexes/{name}/search", payload=q, params={"limit": limit})
                times.append(time.perf_counter() - t0)
                if r.status_code != 200 or r.json() != want[kind, limit, i]:
                    raise AssertionError(f"[server] {kind} asset {i} limit {limit}: HTTP {r.status_code} differs from "
                                         f"the direct call: {r.text[:300]}")
            http_ms[kind, limit] = statistics.median(times) * 1e3
            slog(f"[server] {card}: search {kind:9s} limit {limit:3d}: HTTP median {http_ms[kind, limit]:.3f} ms of {reps} "
                f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), direct {direct_ms[kind, limit]:.3f} ms; "
                f"{len(want[kind, limit, picks[-1]]['global_matches'])} global / "
                f"{len(want[kind, limit, picks[-1]]['chunk_matches'])} chunk matches, bodies equal the direct call's")
            # The same answer through RemoteIndex.search_assets and through urllib.
            q = product_query(picks[0], truth[picks[0]], kind)
            got = remote.search_assets(name, schema.IsccQuery(**q), limit=limit).model_dump(mode="json",
                                                                                            exclude_none=True)
            if kind == "iscc_code":
                status, body, _ = http_json(served.base, "GET", f"/indexes/{name}/search?" +
                                            urllib.parse.urlencode({**q, "limit": limit}))
            else:
                status, body, _ = http_json(served.base, "POST", f"/indexes/{name}/search?limit={limit}", q)
            if got != want[kind, limit, picks[0]] or (status, body) != (200, want[kind, limit, picks[0]]):
                raise AssertionError(f"[server] {kind} limit {limit}: RemoteIndex or urllib differs from the direct call")
        times, times_direct = [], []
        for i in picks:
            iscc_id = product_iscc_id(i)
            t0 = time.perf_counter()
            r = remote.request("GET", f"/indexes/{name}/assets/{iscc_id}")
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            asset = manager.get_asset(name, iscc_id)
            times_direct.append(time.perf_counter() - t0)
            if r.status_code != 200 or r.json() != _dump(asset) or remote.get_asset(name, iscc_id) != asset:
                raise AssertionError(f"[server] GET asset {i}: {r.status_code} differs from the direct call")
        http_ms["asset", 0], direct_ms["asset", 0] = statistics.median(times) * 1e3, statistics.median(times_direct) * 1e3
        slog(f"[server] {card}: GET /indexes/{name}/assets/{{id}}: HTTP median {http_ms['asset', 0]:.3f} ms of {reps}, direct "
            f"{direct_ms['asset', 0]:.3f} ms; bodies equal the direct call's")

        got = {}

        def both_client(mine):
            client = RemoteIndex(served.base, name)
            try:
                for i in mine:
                    r = client.request("POST", f"/indexes/{name}/search", payload=product_query(i, truth[i], "both"),
                                       params={"limit": 10})
                    got[i] = (r.status_code, r.json())
            finally:
                client.close()

        wall = _threads(both_client, [work[c::clients] for c in range(clients)])
        if got != {i: (200, want_both[i]) for i in work}:
            raise AssertionError("[server] concurrent HTTP clients: answers differ from the direct calls")
        http_rate = len(work) / wall
        slog(f"[server] {card}: {clients} keep-alive clients x {per_client} 'both' limit-10 requests over HTTP: {wall:.3f} s, "
            f"{http_rate:.1f} query assets/s ([product], direct calls: {direct_rate:.1f}); answers equal the direct calls")
        # The same load from client subprocesses: clients in this process share its GIL with the server.
        load = client_load(served.base, f"/indexes/{name}/search?limit=10",
                           [(i, product_query(i, truth[i], "both")) for i in work], clients)
        check_load("[server] client subprocesses", load, {i: want_both[i] for i in work})
        sub_rate = len(work) / load["wall"]
        slog(f"[server] {card}: {clients} keep-alive clients in {load['procs']} client subprocesses x "
             f"{load['conns']} connections, {per_client} 'both' limit-10 requests each: {load['wall']:.3f} s, "
             f"{sub_rate:.1f} query assets/s (client threads in this process: {http_rate:.1f}); answers equal the "
             f"direct calls")

        # Ingest over HTTP: each new asset then found by a search.
        _, new_truth = product_assets(rng, n_new, n_sp)
        new_wire = [product_wire(n + j, t) for j, t in enumerate(new_truth)]
        entries = [schema.IsccEntry(**a) for a in new_wire]
        t0 = time.perf_counter()
        results = remote.add_assets(name, entries)
        ingest_s = time.perf_counter() - t0
        if [r.status.value for r in results] != ["created"] * len(entries):
            raise AssertionError("[server] assets added over HTTP are not all 'created'")
        t0 = time.perf_counter()
        missing = [j for j, a in enumerate(new_wire) if a["iscc_id"] not in [
            m.iscc_id for m in remote.search_assets(name, schema.IsccQuery(units=a["units"]), limit=10).global_matches]]
        find_s = time.perf_counter() - t0
        if missing:
            raise AssertionError(f"[server] {len(missing)} assets added over HTTP are not found, e.g. {missing[:3]}")
        stop()
        launches = check_path_launches("[server]", dev, read_launches(), scans)
        # Where a batch's time goes: the client's encoding, the server's
        # decoding and validation, add_assets of a batch of the same size
        # called directly (more new assets), and the rest.
        batch = entries[:SERVER_CHUNK]
        t0 = time.perf_counter()
        body = json.dumps([a.model_dump(mode="json", exclude_unset=True) for a in batch]).encode()
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = [schema.IsccEntry(**a) for a in json.loads(body)]
        decode_s = time.perf_counter() - t0
        if decoded != batch:
            raise AssertionError("[server] a batch does not decode to what was encoded")
        direct_batch = [schema.IsccEntry(**product_wire(n + n_new + j, t))
                        for j, t in enumerate(product_assets(rng, len(batch), n_sp)[1])]
        t0 = time.perf_counter()
        manager.add_assets(name, direct_batch)
        add_s = time.perf_counter() - t0
        n_new += len(direct_batch)
        per_batch = ingest_s / -(-len(entries) // SERVER_CHUNK)  # seconds per RemoteIndex batch
        slog(f"[server] {card}: POST /indexes/{name}/assets of {len(entries)} new assets in RemoteIndex batches of "
             f"{SERVER_CHUNK}: {ingest_s:.3f} s, {len(entries) / ingest_s:.1f} assets/s over HTTP; per batch "
             f"{per_batch * 1e3:.1f} ms: client encoding {encode_s * 1e3:.1f} ms ({len(body)} bytes), server "
             f"decoding and validation {decode_s * 1e3:.1f} ms, add_assets of {len(batch)} called directly "
             f"{add_s * 1e3:.1f} ms, the rest {(per_batch - encode_s - decode_s - add_s) * 1e3:.1f} ms; each asset "
             f"then found by a units search (one client, {len(entries) / find_s:.1f} searches/s)")
        slog(f"[server] kernel launches of the HTTP path: {launches}")
        want_after = direct(product_query(picks[0], truth[picks[0]], "units"), 10)

        # The error codes, and a 401 from a second app with an API secret.
        for label, method, route, payload, code, detail in (
            ("bad ISCC", "POST", f"/indexes/{name}/search", {"iscc_code": "ISCC:nope"}, 422,
             ["iscc_code: String should match pattern '^ISCC:[A-Z2-7]{16,}$'"]),
            ("bad name", "POST", "/indexes", {"name": "Bad-Name"}, 422,
             ["name: String should match pattern '^[a-z][a-z0-9]*$'"]),
            ("missing index", "GET", "/indexes/missing", None, 404, "Index 'missing' not found"),
            ("existing index", "POST", "/indexes", {"name": name}, 409, f"Index '{name}' already exists"),
        ):
            status, body, _ = http_json(served.base, method, route, payload)
            if (status, body) != (code, {"detail": detail}):
                raise AssertionError(f"[server] {label}: {status} {body}, expected {code} {detail!r}")
        secured = ServedApp(manager, opts.override({"api_secret": "s3cret"}))
        try:
            statuses = [http_json(secured.base, "GET", "/indexes", headers=h)[0]
                        for h in ({}, {"X-API-Key": "wrong"}, {"X-API-Key": "s3cret"})]
        finally:
            secured.close()
        if statuses != [401, 401, 200]:
            raise AssertionError(f"[server] api_secret: statuses {statuses}, expected [401, 401, 200]")
        slog("[server] 422 (bad ISCC, bad name, pydantic's messages), 404, 409; with api_secret: 401 without or "
            "with a wrong key, 200 with it")
        remote.close()
    finally:
        served.close()
        manager.close()

    # serve() itself, in a subprocess: it answers, adds, and on SIGTERM drains and flushes.
    port = _free_port()
    env = {**os.environ, "ISCC_SEARCH_INDEX_URI": f"tpu://{base_dir}", "ISCC_SEARCH_HOST": "127.0.0.1",
           "ISCC_SEARCH_PORT": str(port), "PYTHONPATH": str(Path(__file__).resolve().parent)}
    serve_log = Path(tmp) / "serve.log"
    url = f"http://127.0.0.1:{port}"
    late = [product_wire(n + n_new + j, t) for j, t in enumerate(product_assets(rng, 10, n_sp)[1])]
    t0 = time.perf_counter()
    with open(serve_log, "wb") as out:
        call = "serve()" if dev.type == "cuda" else f"serve(device={str(dev)!r})"
        proc = subprocess.Popen([sys.executable, "-c", f"from iscc_search_tpu_torch.server.httpd import serve; {call}"],
                                env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        while True:
            try:
                if http_json(url, "GET", "/healthz")[:2] == (200, {"status": "ok"}):
                    break
            except OSError:
                pass
            if proc.poll() is not None or time.perf_counter() - t0 > 180:
                raise AssertionError(f"[server] serve() did not answer /healthz: {serve_log.read_text()[-2000:]}")
            time.sleep(0.25)
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        status, body, _ = http_json(url, "POST", f"/indexes/{name}/search?limit=10",
                                    product_query(picks[0], truth[picks[0]], "units"))
        first_s = time.perf_counter() - t0
        if (status, body) != (200, want_after):
            raise AssertionError(f"[server] serve(): the search answers {status}, not what the direct call gave")
        client = RemoteIndex(url, name)
        added = client.add_assets(name, [schema.IsccEntry(**a) for a in late])
        client.close()
        if [r.status.value for r in added] != ["created"] * len(late):
            raise AssertionError("[server] serve(): the late assets are not all 'created'")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(120)
        stop_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = serve_log.read_text()
    if code != 0 or "SIGTERM received" not in text or "closing index" not in text:
        raise AssertionError(f"[server] serve() after SIGTERM: exit {code}: {text[-2000:]}")
    t0 = time.perf_counter()
    manager = get_index(f"tpu://{base_dir}", **on_card)
    reopen_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        direct(product_query(picks[0], truth[picks[0]], "both"), 10)
        first_search_s = time.perf_counter() - t0
        if manager.get_index(name).assets != n + n_new + len(late):
            raise AssertionError(f"[server] reopened after serve(): {manager.get_index(name).assets} assets")
        for a in late:
            res = manager.search_assets(name, schema.IsccQuery(units=a["units"]), limit=10)
            if manager.get_asset(name, a["iscc_id"]).units != a["units"] or \
                    a["iscc_id"] not in [m.iscc_id for m in res.global_matches]:
                raise AssertionError(f"[server] reopened after serve(): {a['iscc_id']} is not there")
        # The direct answers of the index as [scaleout] finds it (the adds
        # above changed the simprints' document frequencies).
        recorded = {"want": {(kind, limit, i): direct(product_query(i, truth[i], kind), limit)
                             for kind, limit in cases for i in picks},
                    "both": {i: direct(product_query(i, truth[i], "both"), 10) for i in work},
                    "picks": picks, "work": work, "assets": n + n_new + len(late), "http_ms": http_ms,
                    "sub_rate": sub_rate, "thread_rate": http_rate, "ingest_rate": len(entries) / ingest_s}
    finally:
        manager.close()
    slog(f"[server] serve() in a subprocess (ISCC_SEARCH_INDEX_URI=tpu://..., the pooled transport): /healthz after "
         f"{up_s:.1f} s, a first search ({first_s:.1f} s) equal to the direct call, {len(late)} assets added; "
         f"SIGTERM: exit 0 after {stop_s:.1f} s, drained and flushed; reopened here ({reopen_s:.3f} s, its first "
         f"search {first_search_s:.3f} s), they are there")

    # The memory:// and kv:// backends through get_index, served and used through RemoteIndex.
    for uri in ("memory://", f"kv://{Path(tmp) / 'kv'}"):
        backend = get_index(uri)
        served = ServedApp(backend, SearchOptions(index_uri=uri))
        client = RemoteIndex(served.base, "roundtrip", chunk_size=SERVER_CHUNK // 4)
        try:
            client.create_index(schema.IsccIndex(name="roundtrip"))
            items = roundtrip_assets(n_kv, 2_000_000)
            added = client.add_assets("roundtrip", [schema.IsccEntry(**a) for a in items])
            if [r.status.value for r in added] != ["created"] * len(items):
                raise AssertionError(f"[server] {uri}: the assets are not all 'created'")
            for a in items:
                res = client.search_assets("roundtrip", schema.IsccQuery(iscc_code=a["iscc_code"]), limit=5)
                top = res.global_matches[0] if res.global_matches else None
                if top is None or (top.iscc_id, top.score) != (a["iscc_id"], 1.0) or \
                        client.get_asset("roundtrip", a["iscc_id"]).units != a["units"]:
                    raise AssertionError(f"[server] {uri}: {a['iscc_id']} is not found by its code")
            if client.get_index("roundtrip").assets != len(items):
                raise AssertionError(f"[server] {uri}: the index does not count {len(items)} assets")
        finally:
            client.close()
            served.close()
            backend.close()
        slog(f"[server] {uri.split(':')[0]}:// through get_index: {len(items)} assets added, each found by its "
            f"ISCC-CODE at score 1.0 and read back over HTTP")
    return launches, recorded


# ------------------------------------------------- multi-host serve()


# Runs the CLI as `python -m iscc_search_tpu_torch.cli` does, with the smoke
# run's counters: every partition scan is recorded (spy_routes) and, at exit,
# the launches of the kernels, the scans, gather_rescore's calls by form and
# whether the process held the card (its CUDA context and peak allocation)
# are printed on one line for the parent.
MULTIHOST_SERVE = r"""
import atexit, json, runpy, sys
import torch
import chip_smoke
from iscc_search_tpu_torch.ops import hopper_scan as hs

scans, _ = chip_smoke.spy_routes()
atexit.register(lambda: print("[multihost-launches] " + json.dumps(
    {"launches": chip_smoke.read_launches(), "scans": scans, "by_form": hs.gather_rescore.by_form,
     "cuda": torch.cuda.is_initialized(),
     "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_initialized() else 0.0}), flush=True))
sys.argv[0] = "iscc_search_tpu_torch.cli"
runpy.run_module("iscc_search_tpu_torch.cli", run_name="__main__", alter_sys=True)
"""


def parity(body):
    """A search answer with its global matches of equal score in one order
    (the ROADMAP parity rule: tie order is not compared)."""
    if isinstance(body, dict) and "global_matches" in body:
        body = dict(body, global_matches=sorted(body["global_matches"], key=lambda m: (-m["score"], m["iscc_id"])))
    return body


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def phase_multihost_serve(rng, dev, tmp, truth, server, n_new=MULTIHOST_NEW_ASSETS, n_sp=PRODUCT_SIMPRINTS,
                          clients=PRODUCT_CLIENTS, timeout=MULTIHOST_SERVE_TIMEOUT_S):
    """[multihost] (b): the product index served by ``serve()`` in
    distributed mode over two processes on one card. Two copies of the
    product index's directory, made with the index closed (the store is
    single-writer): one per rank. ``python -m iscc_search_tpu_torch.cli
    serve`` twice with ``ISCC_SEARCH_DISTRIBUTED=1``, ``_COORDINATOR``,
    ``_NUM_HOSTS=2``, ``_HOST_ID``, ``_MULTIHOST_INDEX``,
    ``_MULTIHOST_CONTROL_PORT`` and ``_INDEX_URI`` (run through
    ``MULTIHOST_SERVE``, which counts the launches): rank 0 serves HTTP, rank
    1 follows and binds no port, both hold a context on the card. Every
    search kind at limit 10 and 100 (``server['picks']``) equal to the direct
    ``search_assets`` of the same directory opened here (the parity rule for
    ties); 8 clients from client subprocesses beside [server]'s figure;
    ``n_new`` assets added over HTTP, mirrored, each then found; SIGTERM to
    the coordinator: both exit 0, the follower's directory gains no file, and
    the coordinator's directory reopened here holds the added assets.
    Returns the launches of both ranks."""
    base_dir, name = Path(tmp) / PRODUCT_BASE, PRODUCT_NAME
    card = CARD.get("smi", str(dev))
    on_card = {} if dev.type == "cuda" else {"device": dev}
    t_phase = time.perf_counter()

    def slog(msg):
        log(f"{msg} [{time.perf_counter() - t_phase:.1f} s]")

    picks, work = server["picks"], server["work"]
    cases = [(kind, limit) for kind in ("units", "simprints", "both", "iscc_id", "iscc_code") for limit in (10, 100)]
    manager = get_index(f"tpu://{base_dir}", **on_card)
    try:
        n_assets = manager.get_index(name).assets

        def direct(q, limit):
            return manager.search_assets(name, schema.IsccQuery(**q), limit).model_dump(mode="json", exclude_none=True)

        want = {(kind, limit, i): direct(product_query(i, truth[i], kind), limit) for kind, limit in cases for i in picks}
        want_both = {i: direct(product_query(i, truth[i], "both"), 10) for i in work}
    finally:
        manager.close()
    copies = [Path(tmp) / "multihost_serve" / f"rank{rank}" for rank in range(2)]
    t0 = time.perf_counter()
    for copy in copies:
        shutil.copytree(base_dir, copy)
    follower_files = _files(copies[1])
    slog(f"[multihost] serve(): direct answers of the product index ({n_assets} assets) taken here; two copies of its "
         f"directory in {time.perf_counter() - t0:.1f} s")

    http, store, ctrl = _free_port(), _free_port(), _free_port()
    device_args = [] if dev.type == "cuda" else ["--device", str(dev)]
    procs, logs = [], [Path(tmp) / "multihost_serve" / f"serve{rank}.log" for rank in range(2)]
    t_start = time.perf_counter()
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent), "ISCC_SEARCH_DISTRIBUTED": "1",
               "ISCC_SEARCH_COORDINATOR": f"127.0.0.1:{store}", "ISCC_SEARCH_NUM_HOSTS": "2",
               "ISCC_SEARCH_HOST_ID": str(rank), "ISCC_SEARCH_MULTIHOST_INDEX": name,
               "ISCC_SEARCH_MULTIHOST_COORDINATOR": "127.0.0.1", "ISCC_SEARCH_MULTIHOST_CONTROL_PORT": str(ctrl),
               "ISCC_SEARCH_INDEX_URI": f"tpu://{copies[rank]}", "ISCC_SEARCH_HOST": "127.0.0.1",
               "ISCC_SEARCH_PORT": str(http)}
        with open(logs[rank], "wb") as out:
            procs.append(subprocess.Popen([sys.executable, "-c", MULTIHOST_SERVE, *device_args, "serve"], env=env,
                                          cwd=Path(__file__).resolve().parent, stdout=out, stderr=subprocess.STDOUT))
    url = f"http://127.0.0.1:{http}"
    try:
        def healthy():
            if any(p.poll() is not None for p in procs):
                raise AssertionError("[multihost] a serve() rank exited early:\n" + "\n".join(
                    f"rank {r}: {logs[r].read_text()[-2000:]}" for r in range(2)))
            with contextlib.suppress(OSError):
                return http_json(url, "GET", "/healthz")[:2] == (200, {"status": "ok"})
            return False

        up_s = wait_for("[multihost] the coordinator's /healthz", healthy, timeout=timeout, poll=0.25)
        q = product_query(picks[0], truth[picks[0]], "units")
        status, body, _ = http_json(url, "POST", f"/indexes/{name}/search?limit=10", q)
        first_s = time.perf_counter() - t_start
        if (status, parity(body)) != (200, parity(want["units", 10, picks[0]])):
            raise AssertionError(f"[multihost] serve(): the first search answers {status}, not the direct call's")
        if listeners(http) != 1:
            raise AssertionError(f"[multihost] {listeners(http)} sockets listen on the HTTP port: the follower binds none")
        apps = compute_apps()
        slog(f"[multihost] serve() over 2 ranks [{card}]: start to /healthz {up_s:.1f} s, to the first answer "
             f"{first_s:.1f} s (equal to the direct call); one socket listens on the HTTP port (rank 0's); nvidia-smi "
             f"lists {apps if apps is not None else 'no'} compute app(s) (pids as the card's host sees them; ranks "
             f"{[p.pid for p in procs]} here)")

        remote = RemoteIndex(url, name, chunk_size=SERVER_CHUNK)
        http_ms = {}
        for kind, limit in cases:
            times = []
            for i in picks:
                q = product_query(i, truth[i], kind)
                t0 = time.perf_counter()
                if kind == "iscc_code":
                    r = remote.request("GET", f"/indexes/{name}/search", params={**q, "limit": limit})
                else:
                    r = remote.request("POST", f"/indexes/{name}/search", payload=q, params={"limit": limit})
                times.append(time.perf_counter() - t0)
                if r.status_code != 200 or parity(r.json()) != parity(want[kind, limit, i]):
                    raise AssertionError(f"[multihost] {kind} asset {i} limit {limit}: HTTP {r.status_code} differs "
                                         f"from the direct call: {r.text[:300]}")
            http_ms[kind, limit] = statistics.median(times) * 1e3
            single = server["http_ms"].get((kind, limit))
            slog(f"[multihost] {card}: search {kind:9s} limit {limit:3d} through the 2-rank cluster: HTTP median "
                 f"{http_ms[kind, limit]:.3f} ms of {len(picks)} (min {min(times) * 1e3:.3f}, max "
                 f"{max(times) * 1e3:.3f}); [server], one process: " + (f"{single:.3f} ms" if single else "not run")
                 + "; bodies equal the direct call's")

        load = client_load(url, f"/indexes/{name}/search?limit=10",
                           [(i, product_query(i, truth[i], "both")) for i in work], clients)
        bad = [r and r[:2] for r in load["results"] if r is None or r[1] != 200 or parity(r[3]) != parity(want_both[r[0]])]
        if bad or len(load["results"]) != len(work):
            raise AssertionError(f"[multihost] client subprocesses: {len(bad)} answers differ from the direct calls")
        rate = len(work) / load["wall"]
        slog(f"[multihost] {card}: {clients} keep-alive clients in {load['procs']} client subprocesses x "
             f"{load['conns']} connections, 'both' limit-10 requests: {load['wall']:.3f} s, {rate:.1f} query assets/s "
             f"through the 2-rank cluster ([server], one process, the same load: {server['sub_rate']:.1f}); answers "
             f"equal the direct calls")

        first = n_assets + 100_000  # ISCC-IDs no earlier phase used
        new_wire = [product_wire(first + j, t) for j, t in enumerate(product_assets(rng, n_new, n_sp)[1])]
        t0 = time.perf_counter()
        results = remote.add_assets(name, [schema.IsccEntry(**a) for a in new_wire])
        ingest_s = time.perf_counter() - t0
        if [r.status.value for r in results] != ["created"] * len(new_wire):
            raise AssertionError("[multihost] assets added over HTTP are not all 'created'")
        t0 = time.perf_counter()
        missing = [j for j, a in enumerate(new_wire) if a["iscc_id"] not in [
            m.iscc_id for m in remote.search_assets(name, schema.IsccQuery(units=a["units"]), limit=10).global_matches]]
        find_s = time.perf_counter() - t0
        remote.close()
        if missing:
            raise AssertionError(f"[multihost] {len(missing)} assets added over HTTP are not found, e.g. {missing[:3]}")
        slog(f"[multihost] {card}: {len(new_wire)} assets added over HTTP in RemoteIndex batches of {SERVER_CHUNK}, "
             f"their units mirrored to rank 1: {ingest_s:.3f} s, {len(new_wire) / ingest_s:.1f} assets/s ([server], "
             f"one process: {server['ingest_rate']:.1f}); each then found by a units search "
             f"({len(new_wire) / find_s:.1f} searches/s)")

        t0 = time.perf_counter()
        procs[0].send_signal(signal.SIGTERM)
        codes = [p.wait(max(1.0, timeout - (time.perf_counter() - t_start))) for p in procs]
        stop_s = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [lg.read_text() for lg in logs]
    if codes != [0, 0] or "SIGTERM received" not in texts[0] or "Multi-host follower" not in texts[1]:
        raise AssertionError(f"[multihost] SIGTERM to the coordinator: exits {codes}:\n" + "\n".join(
            f"rank {r}: {texts[r][-3000:]}" for r in range(2)))
    if "Serving on" in texts[1]:
        raise AssertionError("[multihost] the follower served HTTP")
    if _files(copies[1]) != follower_files:
        raise AssertionError(f"[multihost] the follower's directory gained files: "
                             f"{sorted(set(_files(copies[1])) - set(follower_files))}")
    counts = []
    for r, text in enumerate(texts):
        lines = [ln for ln in text.splitlines() if ln.startswith("[multihost-launches] ")]
        if len(lines) != 1:
            raise AssertionError(f"[multihost] rank {r} printed {len(lines)} launch lines")
        counts.append(json.loads(lines[0].split(" ", 1)[1]))
    if dev.type == "cuda" and not all(c["cuda"] and c["peak_gib"] > 0 for c in counts):
        raise AssertionError(f"[multihost] both ranks should have held the card: {[(c['cuda'], c['peak_gib']) for c in counts]}")
    launches = {n: counts[0]["launches"][n] + counts[1]["launches"][n] for n in PATH_KERNELS}
    forms = {f: counts[0]["by_form"][f] + counts[1]["by_form"][f] for f in hs.GATHER_FORMS}
    check_path_launches("[multihost serve]", dev, launches, [tuple(x) for c in counts for x in c["scans"]], forms)
    t0 = time.perf_counter()
    manager = get_index(f"tpu://{copies[0]}", **on_card)
    try:
        reopen_s = time.perf_counter() - t0
        held = manager.get_index(name).assets
        if held != n_assets + n_new:
            raise AssertionError(f"[multihost] the coordinator's directory holds {held} assets, not {n_assets + n_new}")
        for a in new_wire[:: max(1, n_new // 20)]:
            if manager.get_asset(name, a["iscc_id"]).units != a["units"]:
                raise AssertionError(f"[multihost] the reopened coordinator's directory lacks {a['iscc_id']}")
    finally:
        manager.close()
    slog(f"[multihost] SIGTERM to the coordinator: both ranks exit 0 after {stop_s:.1f} s; the follower's directory "
         f"gained no file; the coordinator's reopened here ({reopen_s:.3f} s) holds {held} assets. Launches of both "
         f"ranks: {launches} (rank 0 {counts[0]['launches']}, rank 1 {counts[1]['launches']}); peak device memory "
         f"{counts[0]['peak_gib']:.3f} / {counts[1]['peak_gib']:.3f} GiB, each rank's own CUDA context")
    return launches


# ------------------------------------------------- load from client processes


CLIENT = r"""
import http.client, json, sys, threading, time

spec = json.load(open(sys.argv[1]))
out = [None] * len(spec["work"])


def run(c):
    conn = None
    for j in range(c, len(spec["work"]), spec["conns"]):
        key, payload = spec["work"][j]
        for attempt in range(3):  # a connection the server closed (a 503, a killed worker): open another
            try:
                if conn is None or spec["fresh"]:
                    conn = http.client.HTTPConnection(spec["host"], spec["port"], timeout=300)
                conn.request("POST", spec["route"], body=json.dumps(payload), headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                body = r.read()
                break
            except (OSError, http.client.HTTPException):
                conn = None
                if attempt == 2:
                    raise
                time.sleep(0.05)
        out[j] = [key, r.status, r.getheader("Retry-After"), json.loads(body) if body else None]
        if r.getheader("Connection", "").lower() == "close":
            conn = None


t0 = time.time()
threads = [threading.Thread(target=run, args=(c,)) for c in range(spec["conns"])]
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump({"start": t0, "end": time.time(), "results": out}, open(sys.argv[2], "w"))
"""


def client_load(base, route, work, clients, procs=None, fresh=False):
    """POST every ``(key, payload)`` of ``work`` to ``route`` from ``clients``
    keep-alive connections spread over client subprocesses (at most 4, two
    connections each, as ``benchmarks/latency_openloop.py`` spreads its
    load; standard library only, so they start in a blink), all started
    together. Returns the wall time from the first process's start to the
    last one's end and every result ``[key, status, Retry-After, body]``."""
    procs = procs or min(4, max(1, clients // 2))
    conns = -(-clients // procs)
    host, port = urllib.parse.urlparse(base).hostname, urllib.parse.urlparse(base).port
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clients_") as tmp:
        running = []
        for p in range(procs):
            spec, out = Path(tmp) / f"spec{p}.json", Path(tmp) / f"out{p}.json"
            spec.write_text(json.dumps({"host": host, "port": port, "route": route, "conns": conns, "fresh": fresh,
                                        "work": work[p::procs]}))
            running.append((subprocess.Popen([sys.executable, "-c", CLIENT, str(spec), str(out)]), out))
        for proc, _ in running:
            if proc.wait(600) != 0:
                raise AssertionError(f"a client subprocess failed (exit {proc.returncode})")
        outs = [json.loads(out.read_text()) for _, out in running]
    return {"wall": max(o["end"] for o in outs) - min(o["start"] for o in outs), "procs": procs, "conns": conns,
            "results": [r for o in outs for r in o["results"]]}


def check_load(label, load, want):
    """Raise unless every result of ``client_load`` is a 200 with the body
    ``want[key]``."""
    bad = [r and r[:2] for r in load["results"] if r is None or (r[1], r[3]) != (200, want[r[0]])]
    if bad or not load["results"]:
        raise AssertionError(f"{label}: {len(bad)} answers differ from the direct calls, e.g. {bad[:3]}")


# ------------------------------------------------------------- scale-out


def worker_children(parent, module=b"iscc_search_tpu_torch.server.worker"):
    """Pids of the live ``module`` processes (``python -m module``) whose
    parent is ``parent``, read from /proc."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            ppid = int(Path(f"/proc/{entry}/stat").read_text().rsplit(")", 1)[1].split()[1])
            cmdline = Path(f"/proc/{entry}/cmdline").read_bytes().split(b"\0")
        except (OSError, IndexError, ValueError):
            continue
        if ppid == parent and module in cmdline:
            pids.append(int(entry))
    return sorted(pids)


def listeners(port):
    """The sockets listening on TCP ``port`` (``SO_REUSEPORT``: one per worker),
    read from /proc/net/tcp."""
    count = 0
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        with contextlib.suppress(OSError):
            for line in Path(table).read_text().splitlines()[1:]:
                fields = line.split()
                count += fields[3] == "0A" and int(fields[1].rsplit(":", 1)[1], 16) == port
    return count


def compute_apps():
    """Pids of the processes with a context on the card, as ``nvidia-smi``
    lists them (None without nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    return [int(x) for x in out.split() if x.strip().isdigit()]


def wait_for(what, cond, timeout=180, poll=0.1):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not after {timeout} s")
        time.sleep(poll)
    return time.perf_counter() - t0


def phase_scaleout(rng, dev, tmp, truth, server, n_new=SERVER_NEW_ASSETS, n_sp=PRODUCT_SIMPRINTS,
                   clients=PRODUCT_CLIENTS):
    """Scale-out serving on the card: ``serve_scaleout`` (the port's
    ``serve --workers N``) on a thread of this process, which is the engine
    and owns the product index on the card, and N ``SO_REUSEPORT`` worker
    processes. Every search kind at limit 10 and 100 equal to [server]'s
    recorded direct answers; 8 keep-alive clients in client subprocesses
    beside [server]'s single process under the same load; 1,000 assets
    added over HTTP, each then found; a 503 with Retry-After past an
    engine's in-flight bound; a worker SIGKILLed and respawned while
    requests keep succeeding. Returns the path's kernel launches."""
    base_dir, name = Path(tmp) / PRODUCT_BASE, PRODUCT_NAME
    on_card = "cuda" if dev.type == "cuda" else str(dev)
    card = CARD.get("smi", str(dev))
    t_phase = time.perf_counter()

    def slog(msg):
        log(f"{msg} [{time.perf_counter() - t_phase:.1f} s]")

    cores = so._runnable_cores()
    n_workers = max(2, min(4, cores - 1))
    forced, previous_force = cores < n_workers + 1, os.environ.get("ISCC_SEARCH_SCALEOUT_FORCE")
    if forced:
        os.environ["ISCC_SEARCH_SCALEOUT_FORCE"] = "1"
    slog(f"[scaleout] {cores} runnable cores (sched_getaffinity): {n_workers} workers"
         + (", ISCC_SEARCH_SCALEOUT_FORCE=1 set (fewer than workers + 1 cores)" if forced else ""))
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    opts = SearchOptions(index_uri=f"tpu://{base_dir}", host="127.0.0.1", port=port, workers=n_workers)
    opened, real_get_index = [], options_mod.get_index

    def recording_get_index(uri=None, device="cuda"):  # the engine's index, for the overload step
        opened.append(real_get_index(uri, device=device))
        return opened[-1]

    options_mod.get_index = recording_get_index
    stop, failed = threading.Event(), []

    def engine():
        try:
            so.serve_scaleout(opts, stop=stop, device=on_card)
        except BaseException as exc:  # noqa: BLE001 - raised in the phase below
            failed.append(exc)

    apps_before = compute_apps()
    t0 = time.perf_counter()
    thread = threading.Thread(target=engine, name="scaleout-engine", daemon=True)
    thread.start()
    extra, extra_ipc = None, None
    try:
        spawn_s = wait_for("[scaleout] worker processes", lambda: failed or len(worker_children(os.getpid())) >= n_workers)
        listen_s = wait_for("[scaleout] workers listening", lambda: failed or listeners(port) >= n_workers)
        if failed:
            raise failed[0]
        options_mod.get_index = real_get_index
        workers = worker_children(os.getpid())
        if len(workers) != n_workers or listeners(port) != n_workers:
            raise AssertionError(f"[scaleout] {len(workers)} worker processes, {listeners(port)} listeners: "
                                 f"expected {n_workers} (a fall-back to single-process serving is not scale-out)")
        envs = [Path(f"/proc/{pid}/environ").read_bytes().split(b"\0") for pid in workers]
        if any(b"CUDA_VISIBLE_DEVICES=" not in env for env in envs):
            raise AssertionError("[scaleout] a worker's environment does not hide the card")
        apps = compute_apps()
        if apps is not None and (set(workers) & set(apps) or len(apps) != len(apps_before)):
            raise AssertionError(f"[scaleout] the card's compute apps: {apps_before} before the workers, {apps} "
                                 f"with them (worker pids {workers})")
        libcuda = sum("libcuda.so" in Path(f"/proc/{pid}/maps").read_text() for pid in workers)
        slog(f"[scaleout] serve_scaleout(workers={n_workers}, device={on_card!r}) on a thread of this process (the "
             f"engine, pid {os.getpid()}): index opened and {n_workers} workers spawned after {spawn_s:.1f} s, all "
             f"listening on port {port} (SO_REUSEPORT) {listen_s:.1f} s later; worker pids {workers}, each with "
             f"CUDA_VISIBLE_DEVICES=''; nvidia-smi lists {len(apps) if apps is not None else 'no'} compute app(s) "
             f"{apps} with the workers up, as before them ({apps_before}; pids as the card's host sees them), no "
             f"worker pid among them; libcuda.so mapped in {libcuda} of {n_workers} workers")

        # The engine's first search after its open, over HTTP (a worker, the
        # engine's IPC thread), with every thread of this process sampled
        # (PERF.md section 7: serve()'s first search).
        picks, work, want = server["picks"], server["work"], server["want"]
        engine_index = opened[0]
        remote = RemoteIndex(base, name, chunk_size=SERVER_CHUNK)
        with uncounted():
            cold = sample_stacks("[scaleout] the engine's first search after its open ('both' limit 10 over HTTP):",
                                 lambda: remote.request("POST", f"/indexes/{name}/search", params={"limit": 10},
                                                        payload=product_query(picks[0], truth[picks[0]], "both")))
            if cold.status_code != 200 or cold.json() != want["both", 10, picks[0]]:
                raise AssertionError("[scaleout] the engine's first search differs from [server]'s direct answer")
        kinds = ("units", "simprints", "both", "iscc_id", "iscc_code")
        reset_launches()
        scans, stop_spy = spy_routes()
        http_ms = {}
        for kind in kinds:
            for limit in (10, 100):
                times = []
                for i in picks:
                    q = product_query(i, truth[i], kind)
                    t1 = time.perf_counter()
                    if kind == "iscc_code":
                        r = remote.request("GET", f"/indexes/{name}/search", params={**q, "limit": limit})
                    else:
                        r = remote.request("POST", f"/indexes/{name}/search", payload=q, params={"limit": limit})
                    times.append(time.perf_counter() - t1)
                    if r.status_code != 200 or r.json() != want[kind, limit, i]:
                        raise AssertionError(f"[scaleout] {kind} asset {i} limit {limit}: HTTP {r.status_code} "
                                             f"differs from the direct call: {r.text[:300]}")
                http_ms[kind, limit] = statistics.median(times) * 1e3
                with uncounted():  # the same requests direct on the engine's index, now
                    times = []
                    for i in picks:
                        q = schema.IsccQuery(**product_query(i, truth[i], kind))
                        t1 = time.perf_counter()
                        engine_index.search_assets(name, q, limit)
                        times.append(time.perf_counter() - t1)
                direct_ms = statistics.median(times) * 1e3
                slog(f"[scaleout] {card}: search {kind:9s} limit {limit:3d}: HTTP median {http_ms[kind, limit]:.3f} ms "
                     f"of {len(picks)} through a worker and the engine's RPC, direct on the engine's index "
                     f"{direct_ms:.3f} ms (HTTP and the hop: {http_ms[kind, limit] - direct_ms:+.3f} ms); [server], "
                     f"one process: {server['http_ms'][kind, limit]:.3f} ms; bodies equal the direct calls")

        load = client_load(base, f"/indexes/{name}/search?limit=10",
                           [(i, product_query(i, truth[i], "both")) for i in work], clients)
        check_load("[scaleout] client subprocesses", load, server["both"])
        rate = len(work) / load["wall"]
        slog(f"[scaleout] {card}: {clients} keep-alive clients in {load['procs']} client subprocesses x "
             f"{load['conns']} connections, {len(work) // clients} 'both' limit-10 requests each: "
             f"{load['wall']:.3f} s, {rate:.1f} query assets/s through {n_workers} workers ([server], one process, "
             f"the same client subprocesses: {server['sub_rate']:.1f}; client threads in its process: "
             f"{server['thread_rate']:.1f}); answers equal the direct calls")

        # Overload: a second engine endpoint with an in-flight bound of 1 on
        # the same index, and one worker process on it.
        sock2 = str(Path(tmp) / "bounded.sock")
        extra_ipc = so.EngineIPCServer(opened[0], sock2, max_inflight=1)
        extra_ipc.start()
        port2 = _free_port()
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(Path(iscc_search_tpu_torch.__file__).parents[1]),
                   ISCC_SCALEOUT_CONFIG=json.dumps({"opts": dataclasses.asdict(opts.override({"port": port2})),
                                                    "socket_path": sock2}))
        extra = subprocess.Popen([sys.executable, "-m", "iscc_search_tpu_torch.server.worker"], env=env)
        wait_for("[scaleout] the bounded worker", lambda: listeners(port2) >= 1 or extra.poll() is not None)
        statuses = []
        for _ in range(5):
            shed = client_load(f"http://127.0.0.1:{port2}", f"/indexes/{name}/search?limit=10",
                               [(i, product_query(i, truth[i], "both")) for i in work[:clients]], clients, procs=1,
                               fresh=True)
            statuses = [(status, retry) for _, status, retry, _ in shed["results"]]
            if any(s == 503 for s, _ in statuses):
                break
        ok = [(key, body) for key, status, _, body in shed["results"] if status == 200]
        if not any(s == 503 and r is not None for s, r in statuses) or any(s not in (200, 503) for s, _ in statuses) \
                or any(body != server["both"][key] for key, body in ok):
            raise AssertionError(f"[scaleout] past the in-flight bound of 1: statuses {statuses}")
        extra.terminate()
        if extra.wait(60) != 0:
            raise AssertionError(f"[scaleout] the bounded worker exited {extra.returncode} on SIGTERM")
        extra = None
        extra_ipc.close()
        extra_ipc = None
        slog(f"[scaleout] an engine endpoint with max_inflight=1 and one worker on it: {clients} concurrent 'both' "
             f"searches answered {sorted(s for s, _ in statuses)} (503 with Retry-After "
             f"{sorted({r for s, r in statuses if s == 503})}), every 200 equal to the direct call")

        # A worker SIGKILLed: respawned while requests keep succeeding.
        victim = workers[0]
        t1 = time.perf_counter()
        os.kill(victim, signal.SIGKILL)

        def respawned():
            pids = worker_children(os.getpid())
            return len(pids) == n_workers and victim not in pids and listeners(port) == n_workers

        during = 0
        while not respawned():  # rounds of searches on fresh connections until the worker is back
            if time.perf_counter() - t1 > 120:
                raise AssertionError(f"[scaleout] worker {victim} not respawned after 120 s")
            load = client_load(base, f"/indexes/{name}/search?limit=10",
                               [(i, product_query(i, truth[i], "both")) for i in work[:8]], 4, procs=1, fresh=True)
            check_load("[scaleout] requests while a worker respawns", load, server["both"])
            during += len(load["results"])
        respawn_s = time.perf_counter() - t1
        if failed or not thread.is_alive():
            raise AssertionError(f"[scaleout] the engine stopped: {failed}")
        slog(f"[scaleout] worker {victim} SIGKILLed: {during} searches on fresh connections meanwhile, all 200 and "
             f"equal to the direct calls; respawned and listening {respawn_s:.1f} s after the kill "
             f"(pids {worker_children(os.getpid())})")

        # Ingest over HTTP: each new asset then found by a units search.
        first = server["assets"] + 10_000
        _, new_truth = product_assets(rng, n_new, n_sp)
        new_wire = [product_wire(first + j, t) for j, t in enumerate(new_truth)]
        t1 = time.perf_counter()
        results = remote.add_assets(name, [schema.IsccEntry(**a) for a in new_wire])
        ingest_s = time.perf_counter() - t1
        if [r.status.value for r in results] != ["created"] * len(new_wire):
            raise AssertionError("[scaleout] assets added over HTTP are not all 'created'")
        t1 = time.perf_counter()
        missing = [j for j, a in enumerate(new_wire) if a["iscc_id"] not in [
            m.iscc_id for m in remote.search_assets(name, schema.IsccQuery(units=a["units"]), limit=10).global_matches]]
        find_s = time.perf_counter() - t1
        if missing:
            raise AssertionError(f"[scaleout] {len(missing)} assets added over HTTP are not found, e.g. {missing[:3]}")
        stop_spy()
        launches = check_path_launches("[scaleout]", dev, read_launches(), scans)
        phase23 = sum(launches[k] for k in PHASE23_KERNELS.values())
        if dev.type == "cuda" and not (phase23 > 0 and sum(launches[k] for k in PATH_KERNELS) > phase23):
            raise AssertionError(f"[scaleout] the path launched {launches}")
        batch = [schema.IsccEntry(**a) for a in new_wire[:SERVER_CHUNK]]
        t1 = time.perf_counter()
        frame = pickle.dumps(("call", "add_assets", (name, batch)), protocol=5)
        pickle_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        pickle.loads(frame)
        unpickle_s = time.perf_counter() - t1
        slog(f"[scaleout] {card}: POST /indexes/{name}/assets of {len(new_wire)} new assets in RemoteIndex batches of "
             f"{SERVER_CHUNK}: {ingest_s:.3f} s, {len(new_wire) / ingest_s:.1f} assets/s through the workers "
             f"([server], one process: {server['ingest_rate']:.1f}); a batch's RPC frame {len(frame)} bytes, pickled "
             f"in {pickle_s * 1e3:.1f} ms and unpickled in {unpickle_s * 1e3:.1f} ms (timed here); each then found by "
             f"a units search (one client, {len(new_wire) / find_s:.1f} searches/s)")
        slog(f"[scaleout] kernel launches of the path (its HTTP requests through the workers): {launches}")
        remote.close()

    finally:
        options_mod.get_index = real_get_index
        if extra is not None:
            extra.terminate()
            extra.wait(60)
        if extra_ipc is not None:
            extra_ipc.close()
        stop.set()
        thread.join(120)
        if forced and previous_force is None:
            os.environ.pop("ISCC_SEARCH_SCALEOUT_FORCE", None)
    if thread.is_alive() or failed or worker_children(os.getpid()):
        raise AssertionError(f"[scaleout] after the stop: engine alive {thread.is_alive()}, {failed}, workers "
                             f"{worker_children(os.getpid())}")
    slog(f"[scaleout] stopped by its event: workers gone, the index flushed and closed (phase {time.perf_counter() - t0:.1f} s)")
    return launches


# ------------------------------------------------------------------- the CLI


CLI_ASSETS = 1000  # product-style assets the [cli] phase writes as .iscc.json files and NDJSON
_LOG_LINE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3} \| ")
_TIMER = re.compile(r"iscc_search_tpu_torch\.timer:timer:\d+ - (.+): ([0-9.]+)s$")


def cli_document(i, t):
    """Product asset ``i`` as an .iscc.json document: its ISCC-CODE, units,
    metadata and the chunk simprints as a ``features`` entry."""
    w = product_wire(i, t)
    sp = w["simprints"][PRODUCT_SP]
    return {"iscc_id": w["iscc_id"], "iscc_code": ic.gen_iscc_code_v0([w["units"][k] for k in (0, 2, 3, 4)])["iscc"],
            "units": w["units"], "metadata": w["metadata"],
            "features": [{"maintype": "content", "subtype": "text", "version": 0,
                          "simprints": [v["simprint"] for v in sp], "offsets": [v["offset"] for v in sp],
                          "sizes": [v["size"] for v in sp]}]}


def run_cli(args, env, device_args, timeout=600):
    """``python -m iscc_search_tpu_torch.cli`` in a fresh process (``-X
    importtime``). Returns (exit code, printed lines without the log lines,
    log lines, split): the wall time, the import of the CLI and of torch
    (cumulative, from ``-X importtime``) and the CLI's timers (``open
    index``, the call)."""
    cmd = [sys.executable, "-X", "importtime", "-m", "iscc_search_tpu_torch.cli", *device_args, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    split = {"wall": time.perf_counter() - t0}
    for line in proc.stderr.splitlines():
        parts = line.split("|")
        if line.startswith("import time:") and len(parts) == 3 and parts[2].strip() in ("iscc_search_tpu_torch.cli",
                                                                                          "torch"):
            split[f"import {parts[2].strip()}"] = int(parts[1]) / 1e6
    lines = proc.stdout.splitlines()
    logs = [line for line in lines if _LOG_LINE.match(line)]
    for line in logs:
        m = _TIMER.search(line)
        if m:
            split[m.group(1)] = float(m.group(2))
    if proc.returncode != 0:
        errors = [line for line in proc.stderr.splitlines() if not line.startswith("import time:")]
        log(f"[cli] {' '.join(args)}: exit {proc.returncode}: " + "\n".join(lines[-20:] + errors[-20:]))
    return proc.returncode, [line for line in lines if not _LOG_LINE.match(line)], logs, split


def _split_text(split):
    order = ("import iscc_search_tpu_torch.cli", "import torch", "open index")
    parts = [f"{k} {split[k]:.3f}" for k in order if k in split]
    parts += [f"{k} {v:.3f}" for k, v in split.items() if k not in order and k != "wall"]
    return f"wall {split['wall']:.3f} s: " + ", ".join(parts)


def phase_cli(rng, dev, tmp, product_truth, n_assets=CLI_ASSETS, n_sp=PRODUCT_SIMPRINTS):
    """The CLI on the card in fresh processes: ``python -m
    iscc_search_tpu_torch.cli`` on its default device with ``HOME`` in a
    temporary directory: ``index add``, ``add`` of an .iscc.json file, a
    directory and an NDJSON file (``n_assets`` product-style assets), ``index
    list``, ``get``, ``search --json`` by code and by ISCC-ID, ``index rebuild
    --all``, ``serve --workers 2`` (one search, then SIGTERM), ``index
    remove``; then a cold ``search`` of the product index. Each process's
    time split (the CLI's import, torch's import, opening the index, the
    call). Afterwards the index opened here holds every asset, and every
    ``get`` and ``search --json`` output equals the direct call's."""
    root = Path(tmp) / "cli"
    home, data, files = root / "home", root / "data", root / "files"
    for d in (home, files / "dir"):
        d.mkdir(parents=True)
    on_card = {} if dev.type == "cuda" else {"device": dev}
    device_args = [] if dev.type == "cuda" else ["--device", str(dev)]
    card = CARD.get("smi", str(dev))
    t_phase = time.perf_counter()

    def slog(msg):
        log(f"{msg} [{time.perf_counter() - t_phase:.1f} s]")

    first = 5_000_000  # ISCC-ID serials of their own
    docs = [cli_document(first + j, t) for j, t in enumerate(product_assets(rng, n_assets, n_sp)[1])]
    (files / "one.iscc.json").write_text(json.dumps(docs[0]))
    half = n_assets // 2
    for j in range(1, half):
        (files / "dir" / f"a{j:04d}.iscc.json").write_text(json.dumps(docs[j]))
    (files / "bulk.ndjson").write_text("".join(json.dumps(d) + "\n" for d in docs[half:]))
    env = dict(os.environ, HOME=str(home), XDG_DATA_HOME=str(home / "share"),
               PYTHONPATH=str(Path(iscc_search_tpu_torch.__file__).resolve().parents[1]))
    slog(f"[cli] {n_assets} product-style assets written: one .iscc.json file, {half - 1} in a directory, "
         f"{n_assets - half} in one NDJSON file; HOME={home}")

    outputs, splits = {}, []

    def cli(label, *args, want_code=0):
        code, lines, logs, split = run_cli(list(args), env, device_args)
        if code != want_code:
            raise AssertionError(f"[cli] {label}: exit {code}, expected {want_code}")
        splits.append((label, split))
        slog(f"[cli] {card}: {label}: exit {code}; {_split_text(split)}")
        outputs[label] = lines
        return lines, logs

    cli("index add", "index", "add", "cli", "--path", str(data))
    counts = [cli(f"add {src}", "add", str(files / src))[0][-1] for src in ("one.iscc.json", "dir", "bulk.ndjson")]
    if counts != [f"Added {n} created, 0 updated, 0 skipped" for n in (1, half - 1, n_assets - half)]:
        raise AssertionError(f"[cli] add: {counts}")
    rows = [line.split("\t") for line in cli("index list", "index", "list")[0] if "\t" in line]
    if rows != [["", "Name", "Type", "Location"], ["*", "cli", "local", str(data.resolve())]]:
        raise AssertionError(f"[cli] index list: {rows}")
    picked = docs[7]
    cli("get", "get", picked["iscc_id"])
    cli("search by code", "search", docs[10]["iscc_code"], "--json")
    cli("search by ISCC-ID", "search", docs[11]["iscc_id"], "--json")
    rebuilt = cli("index rebuild --all", "index", "rebuild", "--all")[0]

    # serve --workers 2: one search, then SIGTERM, exit 0.
    port = _free_port()
    serve_cmd = [sys.executable, "-m", "iscc_search_tpu_torch.cli", *device_args, "serve", "--workers", "2", "--host",
                 "127.0.0.1", "--port", str(port), "--index-uri", f"tpu://{data}"]
    serve_log = root / "serve.log"
    query = {"units": docs[3]["units"]}
    t0 = time.perf_counter()
    with open(serve_log, "wb") as out:
        proc = subprocess.Popen(serve_cmd, env={**env, "ISCC_SEARCH_SCALEOUT_FORCE": "1"}, stdout=out,
                                stderr=subprocess.STDOUT)
    try:
        up_s = wait_for("[cli] serve --workers 2 /healthz", lambda: proc.poll() is not None or _healthy(port))
        if proc.poll() is not None:
            raise AssertionError(f"[cli] serve --workers 2 exited {proc.returncode}: {serve_log.read_text()[-2000:]}")
        workers = worker_children(proc.pid)
        t1 = time.perf_counter()
        status, served, _ = http_json(f"http://127.0.0.1:{port}", "POST", "/indexes/cli/search?limit=10", query)
        search_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(120)
        stop_s = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if code != 0 or status != 200 or len(workers) != 2:
        raise AssertionError(f"[cli] serve --workers 2: exit {code}, search {status}, workers {workers}: "
                             f"{serve_log.read_text()[-2000:]}")
    slog(f"[cli] {card}: serve --workers 2: /healthz after {up_s:.1f} s (workers {workers}), a first search "
         f"{search_s:.3f} s (HTTP 200), SIGTERM: exit 0 after {stop_s:.1f} s")
    cli("index remove", "index", "remove", "cli")

    # The index as the CLI left it, opened here: every asset, every answer.
    manager = get_index(f"tpu://{data}", **on_card)
    try:
        if manager.get_index("cli").assets != n_assets:
            raise AssertionError(f"[cli] the index holds {manager.get_index('cli').assets} assets, not {n_assets}")
        missing = [d["iscc_id"] for d in docs if manager.get_asset("cli", d["iscc_id"]).units != d["units"]]
        if missing:
            raise AssertionError(f"[cli] assets added by the CLI are not there: {missing[:3]}")

        def parsed(label):
            text = "\n".join(outputs[label])
            return json.loads(text[text.index("{"):])

        direct = {
            "get": manager.get_asset("cli", picked["iscc_id"]).model_dump(mode="json", exclude_none=True),
            "search by code": manager.search_assets("cli", schema.IsccQuery(iscc_code=docs[10]["iscc_code"]),
                                                    10).model_dump(mode="json", exclude_none=True),
            "search by ISCC-ID": manager.search_assets("cli", schema.IsccQuery(iscc_id=docs[11]["iscc_id"]),
                                                       10).model_dump(mode="json", exclude_none=True),
        }
        for label, want in direct.items():
            if parsed(label) != want:
                raise AssertionError(f"[cli] {label}: the CLI's output differs from the direct call")
        if served != manager.search_assets("cli", schema.IsccQuery(**query), 10).model_dump(mode="json",
                                                                                              exclude_none=True):
            raise AssertionError("[cli] serve --workers 2: the search differs from the direct call")
        top = [m["iscc_id"] for m in direct["search by ISCC-ID"]["global_matches"]]
        if top[:1] != [docs[10]["iscc_id"]]:  # asset 11 is a near copy of asset 10 (the asset itself is left out)
            raise AssertionError(f"[cli] search by ISCC-ID: top matches {top[:2]}")
    finally:
        manager.close()
    slog(f"[cli] opened here afterwards: {n_assets} assets, each with its units; get, both searches --json and the "
         f"served search equal the direct calls; {rebuilt}")

    # A cold CLI process on the product index (PERF.md section 7: serve()'s first search).
    cli("index add product", "index", "add", "product", "--path", str(Path(tmp) / PRODUCT_BASE))
    code = product_query(0, product_truth[0], "iscc_code")["iscc_code"]
    lines, logs = cli("search the product index", "search", "--index", "product", code, "--json")
    text = "\n".join(lines)
    top = [m["iscc_id"] for m in json.loads(text[text.index("{"):])["global_matches"][:2]]
    if product_iscc_id(0) not in top:
        raise AssertionError(f"[cli] search the product index: top matches {top}")
    slog("[cli] the cold search of the product index (asset 0 found), its log:\n" + "\n".join(logs))
    return splits


def _healthy(port):
    try:
        return http_json(f"http://127.0.0.1:{port}", "GET", "/healthz")[:2] == (200, {"status": "ok"})
    except OSError:
        return False


HUB0_FULL = 1_048_576  # hub 0's log at the JAX package's sizing: 4,096 bundles, 256 groups of GROUP_BUNDLES
HUB0_RECORDS = 262_144  # the smoke run's cut: 1,024 bundles, 64 groups (PERF.md section 4)
HUB_SPLIT_GROUPS = 4  # groups built, converted and added in this process to split a group's time
HUB_GROW = 100  # records the log grows by after the restart: one partial bundle (.p/100)
HUB_SAMPLES, HUB_SEARCHES = 1024, 512  # records checked by get_asset, and found by search_assets
HUB_BUILD_PROCS = 3  # the stub's processes that build requested bundles


def _status(base):
    status, body, _ = http_json(base, "GET", "/status")
    if status != 200:
        raise AssertionError(f"[aggregator] /status answered {status}: {body}")
    return body


def _hub_row(body, hub_id):
    rows = [h for h in body.get("hubs", []) if h["hub_id"] == hub_id]
    return rows[0] if rows else None


def phase_aggregator(rng, dev, tmp, n_records=HUB0_RECORDS, grow=HUB_GROW, samples=HUB_SAMPLES,
                     searches=HUB_SEARCHES, procs=HUB_BUILD_PROCS, seed=0):
    """Aggregator mode on the card: ``python -m iscc_search_tpu_torch.cli
    serve`` in a subprocess with ``ISCC_SEARCH_AGGREGATOR_NETWORK=testnet``
    on ``tpu://``, following a stub hub on loopback (``chip_smoke_hub.py``) whose
    hub 0 serves ``n_records`` records and whose hub 1 answers 500. Returns
    the launch counts of ``searches`` searches of the ingested index."""
    from iscc_search_tpu_torch.aggregator import entry as agg_entry
    from iscc_search_tpu_torch.aggregator import tlog as agg_tlog
    from iscc_search_tpu_torch.aggregator.poller import GROUP_BUNDLES

    import chip_smoke_hub as hub

    root = Path(tmp) / "aggregator"
    data, home = root / "data", root / "home"
    home.mkdir(parents=True)
    card = CARD.get("smi", str(dev))
    on_card = {} if dev.type == "cuda" else {"device": dev}
    device_args = [] if dev.type == "cuda" else ["--device", str(dev)]
    pythonpath = str(Path(iscc_search_tpu_torch.__file__).resolve().parents[1])
    t_phase = time.perf_counter()

    def slog(msg):
        log(f"{msg} [{time.perf_counter() - t_phase:.1f} s]")

    port_file = root / "stub.port"
    stub_log = open(root / "stub.log", "w")
    stub = subprocess.Popen([sys.executable, hub.__file__, "--seed", str(seed), "--records",
                             str(n_records), "--procs", str(procs), "--port-file", str(port_file)],
                            env=dict(os.environ, PYTHONPATH=pythonpath), stdout=stub_log, stderr=subprocess.STDOUT)
    served = []
    try:
        wait_for("[aggregator] the stub hub", lambda: port_file.exists() or stub.poll() is not None, timeout=120)
        if stub.poll() is not None:
            raise AssertionError(f"[aggregator] the stub hub exited {stub.returncode}")
        stub_base = f"http://127.0.0.1:{port_file.read_text()}"
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        env = dict(os.environ, HOME=str(home), XDG_DATA_HOME=str(home / "share"), PYTHONPATH=pythonpath,
                   ISCC_SEARCH_INDEX_URI=f"tpu://{data}", ISCC_SEARCH_HOST="127.0.0.1", ISCC_SEARCH_PORT=str(port),
                   ISCC_SEARCH_AGGREGATOR_NETWORK="testnet", ISCC_SEARCH_AGGREGATOR_POLL_INTERVAL="1",
                   ISCC_SEARCH_AGGREGATOR_HUB_LIST_URL=f"{stub_base}/hubs")
        cmd = [sys.executable, "-m", "iscc_search_tpu_torch.cli", *device_args, "serve"]
        slog(f"[aggregator] stub hub at {stub_base} (hub 0: {n_records} records, {n_records // 256} bundles; hub 1: "
             f"500; {procs} build processes); serving: {' '.join(cmd[1:])} with the hub list at {stub_base}/hubs "
             "(a 302 to /hubs.yaml)")

        def start(tag):
            with open(root / f"serve_{tag}.log", "wb") as out:
                proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT)
            served.append(proc)
            up_s = wait_for(f"[aggregator] serve ({tag}) /healthz", lambda: proc.poll() is not None or _healthy(port))
            if proc.poll() is not None:
                raise AssertionError(f"[aggregator] serve ({tag}) exited {proc.returncode}: "
                                     f"{(root / f'serve_{tag}.log').read_text()[-3000:]}")
            return proc, up_s

        def stop(proc, tag):
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(300)
            text = (root / f"serve_{tag}.log").read_text()
            if code != 0:
                raise AssertionError(f"[aggregator] serve ({tag}): SIGTERM, exit {code}: {text[-3000:]}")
            if "conversion pool failed" in text:
                raise AssertionError(f"[aggregator] serve ({tag}): the conversion pool failed: {text[-3000:]}")
            return time.perf_counter() - t1

        def cursors():
            return json.loads((data / "aggregator_cursors.json").read_text())

        # 1. Backfill hub 0 from leaf 0; hub 1 fails beside it.
        apps_before = compute_apps()
        proc, up_s = start("first")
        hub1_seen = []

        def done():
            body = _status(base)
            row0, row1 = _hub_row(body, 0), _hub_row(body, 1)
            if row1 is not None and row0 is not None and row0["cursor"] < n_records:
                hub1_seen.append(row1["ok"])
            return proc.poll() is not None or (row0 is not None and row0["cursor"] == n_records)

        wait_for("[aggregator] hub 0's cursor at the log's size", done, timeout=3600, poll=0.2)
        t_done = time.monotonic()
        if proc.poll() is not None:
            raise AssertionError(f"[aggregator] serve exited {proc.returncode} during the ingest")
        body = _status(base)
        stats = http_json(stub_base, "GET", "/control/stats")[1]
        row0, row1 = _hub_row(body, 0), _hub_row(body, 1)
        if row0["counts"] != stats["counts"] or sum(stats["counts"].values()) != n_records:
            raise AssertionError(f"[aggregator] per-reason counts {row0['counts']}, the stub's {stats['counts']}")
        if not row0["ok"] or row1 is None or row1["ok"] or any(hub1_seen) or (
                n_records >= 64 * 256 and not hub1_seen):
            raise AssertionError(f"[aggregator] hub rows {body['hubs']}, hub 1 while hub 0 ingested: {hub1_seen}")
        fetches = sorted(stats["fetches"], key=lambda f: f[2])
        if sorted(f[0] for f in fetches) != list(range(n_records // 256)):
            raise AssertionError("[aggregator] hub 0's bundles were not each fetched once")
        t_first = fetches[0][2]
        rate = n_records / (t_done - t_first)
        starts = {}
        for bundle, _, arrival, _ in fetches:
            g = bundle // GROUP_BUNDLES
            starts[g] = min(starts.get(g, arrival), arrival)
        gaps = sorted(((starts[g + 1] - starts[g], g) for g in range(len(starts) - 1)), reverse=True)
        builds = [f[3] for f in fetches]
        workers = worker_children(proc.pid, b"iscc_search_tpu_torch.aggregator.convert_worker")
        apps = compute_apps()
        libcuda = [pid for pid in workers if "libcuda.so" in Path(f"/proc/{pid}/maps").read_text()]
        hidden = all(b"CUDA_VISIBLE_DEVICES=" in Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
                     for pid in workers)
        if not workers or libcuda or not hidden or (apps is not None and (
                set(workers) & set(apps) or len(apps) > len(apps_before or []) + 1)):
            raise AssertionError(f"[aggregator] conversion workers {workers} (libcuda in {libcuda}, card hidden "
                                 f"{hidden}); compute apps {apps_before} before serve, {apps} with it")
        slog(f"[aggregator] {card}: serve up after {up_s:.1f} s; hub 0's {n_records} records ingested: "
             f"{rate:.1f} records/s from the first entries fetch to the cursor at {n_records} "
             f"({t_done - t_first:.1f} s); counts {row0['counts']} equal the stub's; hub 1 ok=false throughout "
             f"({len(hub1_seen)} reads)")
        slog("[aggregator] the five longest gaps between consecutive group fetches (stub's clock): " + ", ".join(
            f"groups {g}->{g + 1} {s:.3f} s" for s, g in gaps[:5]) + (
            f"; median gap {statistics.median(s for s, _ in gaps):.3f} s" if gaps else ""))
        slog(f"[aggregator] the stub built {len(builds)} bundles in {sum(builds):.1f} s of build time "
             f"(mean {statistics.mean(builds) * 1e3:.1f} ms, max {max(builds) * 1e3:.1f} ms a bundle, "
             f"{procs or 1} process(es): {n_records / max(sum(builds) / max(procs, 1), 1e-9):.0f} records/s "
             "if nothing else waited)")
        slog(f"[aggregator] conversion workers {workers}: CUDA_VISIBLE_DEVICES='' in each, no libcuda.so mapped, "
             f"nvidia-smi compute apps {len(apps) if apps is not None else 'not listed'} with serve running "
             f"({len(apps_before) if apps_before is not None else 'not listed'} before)")
        stop_s = stop(proc, "first")
        if cursors() != {"network": "testnet", "cursors": {"0": n_records}}:
            raise AssertionError(f"[aggregator] the cursor file after SIGTERM: {cursors()}")
        slog(f"[aggregator] SIGTERM: exit 0 after {stop_s:.1f} s; aggregator_cursors.json {cursors()}")

        # 2. Restart: the cursor resumes, no re-backfill; then a 100-record partial bundle.
        fetched = len(stats["fetches"])
        proc, up_s = start("restart")
        poll_s = wait_for("[aggregator] the restart's first poll", lambda: proc.poll() is not None or (
            _hub_row(_status(base), 0) or {}).get("counts"), timeout=600, poll=0.1)
        row0 = _hub_row(_status(base), 0)
        stats = http_json(stub_base, "GET", "/control/stats")[1]
        if row0["cursor"] != n_records or any(row0["counts"].values()) or len(stats["fetches"]) != fetched:
            raise AssertionError(f"[aggregator] after the restart's first poll: {row0}, "
                                 f"{len(stats['fetches']) - fetched} new entries fetches")
        slog(f"[aggregator] restart: up after {up_s:.1f} s, its first poll read from /status {poll_s:.1f} s later "
             f"(serve opened the index before it answered): cursor {row0['cursor']}, counts "
             f"{row0['counts']}, no entries fetched")
        t1 = time.perf_counter()
        http_json(stub_base, "POST", f"/control/grow?n={grow}")
        size = n_records + grow
        wait_for("[aggregator] the grown log ingested", lambda: proc.poll() is not None or (
            _hub_row(_status(base), 0)["cursor"] == size), timeout=600, poll=0.1)
        grow_s = time.perf_counter() - t1
        row0 = _hub_row(_status(base), 0)
        stats = http_json(stub_base, "GET", "/control/stats")[1]
        new = [f[:2] for f in stats["fetches"][fetched:]]
        want = {k: v - hub.log_counts(n_records)[k] for k, v in stats["counts"].items()}
        if row0["counts"] != want or new != [[n_records // 256, grow]]:
            raise AssertionError(f"[aggregator] the grown log: counts {row0['counts']} (the stub's {want}), "
                                 f"fetches {new}")
        stop_s = stop(proc, "restart")
        if cursors()["cursors"] != {"0": size}:
            raise AssertionError(f"[aggregator] the cursor file after the restart: {cursors()}")
        slog(f"[aggregator] the log grown by {grow}: one .p/{grow} fetch, counts {row0['counts']}, cursor {size} "
             f"after {grow_s:.1f} s; SIGTERM: exit 0 after {stop_s:.1f} s; cursor file {cursors()['cursors']}")
    finally:
        for proc in served:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        stub.terminate()
        stub.wait(60)
        stub_log.close()

    # 3. A group's time split in this process: the stub's build (one process),
    # the conversion a worker makes, and add_assets into a fresh index.
    split = {"build": [], "convert": [], "add_assets": []}
    scratch = get_index(f"tpu://{root / 'split'}", **on_card)
    try:
        scratch.create_index(schema.IsccIndex(name="idptest"))
        for g in range(HUB_SPLIT_GROUPS):
            t1 = time.perf_counter()
            bundles = [hub.hub_bundle(seed + 1, GROUP_BUNDLES * g + b)[0] for b in range(GROUP_BUNDLES)]
            split["build"].append(time.perf_counter() - t1)
            records = [r for b in bundles for r in agg_tlog.parse_entry_bundle(b)]
            t1 = time.perf_counter()
            fields, _ = agg_entry.convert_group(records, 0, "testnet")
            split["convert"].append(time.perf_counter() - t1)
            t1 = time.perf_counter()
            scratch.add_assets("idptest", [agg_entry.entry_from_fields(f) for f in fields])
            split["add_assets"].append(time.perf_counter() - t1)
    finally:
        scratch.close()
    gap = statistics.median(s for s, _ in gaps) if gaps else float("nan")
    slog(f"[aggregator] {card}: a group of {GROUP_BUNDLES * 256} records, medians of {HUB_SPLIT_GROUPS} in this process: "
         + ", ".join(f"{k} {statistics.median(v):.3f} s" for k, v in split.items())
         + f" (entries built in add_assets' time; into a fresh index); the ingest's median gap between group "
           f"fetches {gap:.3f} s")

    # 4. The index opened here: every ok record there, sampled records equal, found by their units.
    ok_total = stats["counts"]["ok"]
    t1 = time.perf_counter()
    manager = get_index(f"tpu://{data}", **on_card)
    try:
        assets = manager.get_index("idptest").assets
        open_s = time.perf_counter() - t1
        if assets != ok_total:
            raise AssertionError(f"[aggregator] the index holds {assets} assets, {ok_total} records were ok")
        picks = []
        while len(picks) < samples + searches:
            n = int(rng.integers(0, size))
            if hub.leaf_kind(n) == "ok":
                picks.append(n)
        t1 = time.perf_counter()
        for n in picks[:samples]:
            want, reason = agg_entry.record_to_entry(hub.hub_record(seed, n), "testnet")
            got = manager.get_asset("idptest", want.iscc_id)
            if reason != "ok" or (got.iscc_code, sorted(got.units), got.metadata) != (
                    want.iscc_code, sorted(want.units), want.metadata):
                raise AssertionError(f"[aggregator] leaf {n}: get_asset {got} differs from record_to_entry {want}")
        get_s = time.perf_counter() - t1
        queries = [agg_entry.record_to_entry(hub.hub_record(seed, n), "testnet")[0] for n in picks[samples:]]
        reset_launches()
        scans, stop_spy = spy_routes()
        t1 = time.perf_counter()
        try:
            for q in queries:
                res = manager.search_assets("idptest", schema.IsccQuery(units=q.units), limit=10)
                if not any(m.iscc_id == q.iscc_id and m.score == 1.0 for m in res.global_matches):
                    raise AssertionError(f"[aggregator] a search by {q.iscc_id}'s units: {res.global_matches[:3]}")
            sync(dev)
        finally:
            stop_spy()
        search_s = time.perf_counter() - t1
        launches = check_path_launches("[aggregator]", dev, read_launches(), scans)
    finally:
        manager.close()
    slog(f"[aggregator] {card}: opened here: {assets} assets (the ok count) in {open_s:.1f} s; {samples} get_asset "
         f"equal record_to_entry in units, code and metadata ({get_s:.1f} s); {len(queries)} searches by units "
         f"found their record at score 1.0 ({search_s:.1f} s, {1e3 * search_s / max(len(queries), 1):.1f} ms each); "
         f"launches {launches}")
    return launches


def phase3_split(dev, part, flat, kk, out_k):
    """Device time of one slice of phases 2-3 (``hopper_scan.select_rescore_topk_plain``)
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
    whole = functools.partial(hs.select_rescore_topk_plain, q_packed, min_lanes, q_scale, block_max, db, valid, kk, out_k)
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


def phase_profile(idx, queries, scan_kernel, reps=5, name=""):
    """Where one warm search's time goes, under ``scan_kernel`` (``name``
    tells one index's lines and trace from another's).

    - Host split (host clock): query packing and kernel launches, waiting
      for the device, and the host merge of the partitions' candidates.
    - Device time by kernel over ``reps`` searches (``torch.profiler``,
      kernel events only), and the device's busy share of that window. The
      trace goes to ``build/chip_smoke_trace_<scan_kernel>_q<Q>.json``.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx.scan_kernel = scan_kernel
    tag = f"[profile{' ' + name if name else ''} {scan_kernel} Q={len(queries)}]"
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
    prof.export_chrome_trace(str(out / f"chip_smoke_trace_{name + '_' if name else ''}{scan_kernel}_q{len(queries)}.json"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the generated codes and queries")
    parser.add_argument("--profile", action="store_true", help="also profile warm searches (device time by kernel)")
    parser.add_argument("--select-only", action="store_true",
                        help="run the device, build and [select] phases only (phases 2-3 in one launch)")
    parser.add_argument("--mesh-worker", nargs=6, metavar=("DIR", "RANK", "WORLD", "PORT", "DEVICE", "CHIPS"),
                        help="run one process of a [mesh] cluster (started by the [mesh] phase)")
    parser.add_argument("--multihost-worker", nargs=5, metavar=("DIR", "RANK", "PORT", "CONTROL_PORT", "DEVICE"),
                        help="run one rank of [multihost]'s engine cluster (started by the [multihost] phase)")
    args = parser.parse_args()
    if args.mesh_worker:
        data, rank, world, port, device, chips = args.mesh_worker
        mesh_worker(data, int(rank), int(world), int(port), device, int(chips))
        return
    if args.multihost_worker:
        data, rank, port, ctrl, device = args.multihost_worker
        multihost_worker(data, int(rank), int(port), int(ctrl), device)
        return

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    codes, lanes = random_codes(rng, N_ROWS)
    part_rows = {int(lv): int(c) for lv, c in zip(*np.unique(lanes, return_counts=True))}
    log(f"[data] {N_ROWS} codes, rows per lane count: {part_rows}")
    if args.select_only:
        print(json.dumps({"select": phase_select(rng, dev, part_rows), "ok": True,
                          "device": {"kind": torch.cuda.get_device_name(0), "smi": CARD["smi"]}}))
        return
    stats = phase_kernels(rng, dev, part_rows)
    gather_ladder = phase_gather(rng, dev)
    select_points = phase_select(rng, dev, part_rows)
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
        t0 = time.perf_counter()
        knob_launches = phase_knobs(dev, idx, queries, oracle)
        log(f"[knobs] phase time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_launches, mesh_kernel4, mesh_outs = phase_mesh(dev, idx, queries, oracle, tmp, profile=args.profile)
        log(f"[mesh] phase time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mh_launches, mh_stats = phase_multihost(dev, idx, queries, oracle, tmp, args.seed, mesh_outs)
        log(f"[multihost] engine cluster time {time.perf_counter() - t0:.1f} s")
        del idx, oracle
    # The config-3 path: the slice's searches and the [route] phase's 'auto' searches.
    by_path = {"config3": {name: slice_launches[name] + route_launches.get(name, 0) for name in PATH_KERNELS},
               "knobs": knob_launches, "mesh": {name: mesh_launches[name] for name in PATH_KERNELS}}
    # Kernel 4 (the int8-twin phase 1): [twin] on the engine's partitions, and the mesh path: the
    # scan_kernel="pallas" searches' twin route per shard and its direct calls (TWIN_LAUNCHES splits them).
    twin_by_path = {"twin": twin_launches["blockmax_mma_unpacked"], "mesh": mesh_launches["blockmax_mma_unpacked"]}
    launches = {**by_path["config3"], "blockmax_mma_unpacked": sum(twin_by_path.values())}
    for kernel, name in ROUTE_KERNELS.items():
        stats[name]["by_q"] = route_stats(route_table, caps, kernel)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        by_path["simprint"], path_stats = phase_simprint(rng, dev, tmp)
        log(f"[simprint] phase time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["product"], product_stats, truth, direct_rate = phase_product(rng, dev, tmp)
        log(f"[product] phase time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["server"], recorded = phase_server(rng, dev, tmp, truth, direct_rate)
        log(f"[server] phase time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["scaleout"] = phase_scaleout(rng, dev, tmp, truth, recorded)
        log(f"[scaleout] phase time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_cli(rng, dev, tmp, truth)
        log(f"[cli] phase time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mh_serve_launches = phase_multihost_serve(rng, dev, tmp, truth, recorded)
        by_path["multihost"] = {name: mh_launches[name] + mh_serve_launches[name] for name in PATH_KERNELS}
        log(f"[multihost] serve() part time {time.perf_counter() - t0:.1f} s")
        del truth, recorded
        t0 = time.perf_counter()
        by_path["aggregator"] = phase_aggregator(rng, dev, tmp, seed=args.seed)
        log(f"[aggregator] phase time {time.perf_counter() - t0:.1f} s")
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
            # The search paths' launches: config 3 (phases 4-6), [knobs]' kernel routes, the mesh, the
            # simprint engine at config 4, the asset-level entry point, the
            # REST server, scale-out, the multi-host cluster (both ranks of
            # both its parts) and the aggregator's index; and the kernel at the
            # simprint, product and multi-host paths' shapes.
            entry["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
            entry["launches"] = sum(entry["launches_by_path"].values())
            entry["at_simprint_shapes"] = path_stats[name]
            if name in product_stats:
                entry["at_product_shapes"] = product_stats[name]
            if name in mh_stats:
                entry["at_multihost_shapes"] = mh_stats[name]
        if name == "blockmax_mma_unpacked":
            entry["launches_by_path"] = twin_by_path
            entry["mesh_launches_by_source"] = {src: TWIN_LAUNCHES[f"mesh {src}"] for src in ("searches", "direct calls")}
            entry["at_mesh_shapes"] = mesh_kernel4
        summary.append(entry)
    summary.append({"name": "select_rescore_topk", "route": "cuda", "source": "iscc_search_tpu_torch/csrc/select_rescore.cu",
                    "replaces": None, "launches_by_path": {path: counts["select_rescore_topk"] for path, counts in by_path.items()},
                    "by_point": select_points})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
