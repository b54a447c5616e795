#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pmdfc_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each reported on its own line; any failure exits nonzero:

1. env     — the card (nvidia-smi name and power limit), torch, CUDA, nvcc.
2. build   — compiles every kernel of the paths from `pmdfc_tpu_torch/ops/csrc`
             (one source, `fused_get.cu`, holding all four fused-GET variants)
             with nvcc, and beside it the coalescing engine
             (`pmdfc_tpu_torch/native/runtime.cpp`) with g++.
3. kernel  — each kernel against its plain PyTorch version, bit for bit
             (tolerance 0: all integer arithmetic), on small states at w in
             {16, 2^10, 2^14}, over batches that hold every miss cause (real
             extent covers for EXT, corrupted pages for DIGEST; tiered: a
             NOPAGE entry and a cleared live bit for PARKED, entries left
             stale by a forced shrink, a grow and fresh puts for STALE):
             linear and cceh with S=16 and S=32, and cceh on an extendible
             (LSB directory) state through the wrapper with msb=False, each
             over the flat pool and then over a tiered pool whose 1/16 hot
             tier went through promotions, demotions and ghost readmits.
4. main    — four main paths through the `KV` host class on the default
             device at the serving size, 2^21 slots and 4 KiB pages, the
             evicted-key sketch, one path at a time:
             - linear·flat: 65,536 clusters of 32, a 2^24-bit counting
               bloom, an 8 GiB pool;
             - cceh·flat: the JAX defaults (1024-slot segments, 32-slot
               probe windows, split headroom 1, 64 splits per round) at
               capacity 2^20, so 1024 segments growing to 2048 (Gmax 11,
               an 8 KiB directory, a 32 MiB table), the default bloom;
             - linear·tiered and cceh·tiered: the same indexes over the
               tiered pool with `TierConfig()`'s defaults, 262,144 hot +
               2,097,152 cold rows = 9 GiB; cceh·tiered with the admission
               gate (`AdmitConfig()`), linear·tiered without.
             Fill 75% of the slots in 2^16-key inserts (CCEH: splits up to
             the headroom, then in-window evictions; on the flat path, a
             third of the way in, one replicated directory entry is
             damaged, the keys behind it stop hitting, and `recovery()`
             repairs it); serve mixed 2^14-key GET and get_compact batches
             (present, never-inserted, capacity-evicted, padding; tiered: a
             quarter from a fixed hot set of 2^12 present keys, which
             promote and are then served byte-exact from hot rows); delete;
             serve again with deleted keys mixed in. Every hit must return
             the exact page inserted (pages are a function of key and word
             index, made on the device), every present key must hit, every
             miss is zeroed, `misses == Σ miss_*`, and the path's kernel
             must have launched. cceh·flat then inserts a few hundred
             extents (bases and values around 2^31 and 2^32) and checks
             `get_extent`'s addresses, a page GET of a cover (a cold miss
             through EXT), a page put over a cover (converted), and
             `find_anyway` on 16 keys. The tiered paths update hot-resident
             keys in place, delete hot-resident keys (`hot_occupied` drops
             by as many), shrink the balloon by its free rows plus 2 x 1024
             (every key whose row it evicted misses as `miss_stale`), grow
             it back and insert fresh keys into the evicted rows (the old
             keys still miss, the new ones hit byte-exact). Then phase 3's
             comparison on each full-size state.
5. times   — per path: CUDA-event device times per 2^14-key batch of the
             kernel and of its plain version (queued behind a busy stream,
             so the host's launch time is not counted; the host-driven loop
             is reported beside), rotated over 8 distinct batches whose pages
             (about 8 x 42 MB) far exceed the 50 MB L2, with one batch
             repeated as the warm time beside it; the kernel's bound (the
             bytes these batches must move over 3.35 TB/s); whole-path GET
             (tiered: with its `tier.on_get` epilogue) and insert rates and
             a torch.profiler breakdown of `KV.get`.
6. families — the six index families that take the composed GET (cuckoo,
             cuckoo-probing, level, path, static, HotRing), one at a time,
             each through `KV` at linear·flat's serving configuration with
             only the kind changed (requested capacity 2^21, the 2^24-bit
             bloom, 4 KiB pages, the sketch); the pool follows each
             family's slot count (level 3 x 2^20 slots = 12 GiB, path's
             base-15 slots 2,088,960). Fill 75% of the slots; serve mixed
             get and get_compact batches (present, never-inserted,
             evicted or dropped, padding) and, after a delete, with the
             deleted keys mixed in: every key an insert reported placed
             and no later insert reported evicted hits byte-exact, every
             miss is zeroed, `misses == Σ miss_*`, static never evicts,
             and a `scan()` of the table holds exactly the present keys.
             HotRing serves 2^20 GET keys, a quarter from a 2^12-key hot
             set, so the default decay fires through `KV`; then every hot
             key resolves from the mirror, and hot keys updated in place
             serve their new bytes from the table. No family launches the
             fused GET. Times per family: fill pages/s, `KV.get` wall per
             2^14 keys (CUDA events), and torch.profiler's device ops,
             device busy and device-to-host copies per insert and get
             (its profiled inserts of fresh keys take the table to about
             87% full, and their results are held to the same checks).
             Then the standalone policy cache (`ops/policy_cache.py`):
             LRU, LFU and FIFO on the card, each call held equal to the
             same call on the CPU (gets, evictions, table, metric, tick).
7. serve   — the serving path, after the families: linear·flat's configuration
             (8 GiB) in a `KVServer` behind the native engine (32 queues,
             2^14-request flushes, a 256 MiB arena), driven by 4 clients x 8
             threads of `CleanCacheClient` over `EngineBackend`, each with
             its own queue and a 2^11-page arena slice, the server pushing
             its bloom filter every 0.05 s. `warmup()` first, on the main
             thread (a kernel that fails to build or launch raises there,
             not as -2 statuses inside the driver). Fill 75% of the slots:
             5/8 through `KV.insert` in 2^16-page batches, then 1/8
             through the engine in 2^11-page put_pages verbs; push; every
             acknowledged key a mirror denies must miss at the server;
             invalidate; then 8 get_pages verbs per thread (5/8 present,
             1/8 never inserted, 1/8 invalidated, 1/16 oldest, 1/16
             padding): hits byte-exact, misses zeroed with their arena
             slots untouched by the server, never-inserted and
             invalidated keys miss, misses of acknowledged keys <=
             evictions + drops, >= 90% of never-inserted GETs
             short-circuited by the mirrors, no -2 status, no serve error,
             submitted == completed, one fused-GET launch per GET flush;
             then 256 extents through OP_INS_EXT, read back through
             OP_GET_EXT. Reports fill and GET rates, verb latency, flush
             widths, the driver's phase times and the push counters. With
             the driver stopped: quiet PUT flushes (2^14 and 11,826 pages)
             that must serve their pages back and a quiet GET flush that
             must agree with `KV.get`, timed, and a profile of the GET
             flush; then phase 3's comparison and phase 5's times on the
             server's full-size state.

8. wire   — the wire path, last: linear·flat's configuration (8 GiB) behind
             the port's `NetServer(NetConfig())` on loopback TCP, driven by
             4 clients x 8 connections, each a pipelined `TcpBackend`
             (window 32, keepalives on) built by a `ReconnectingClient`
             under a `CleanCacheClient` whose mirror the server's bloom
             pushes (every 0.05 s) feed. Pre-fill 1,310,720 pages straight
             through `KV.insert`, then 262,144 pages over the wire in
             2^11-page put_pages verbs (75% of the slots in all); a scan
             names the pre-fill keys the fills evicted; every acknowledged
             key a mirror denies must miss; invalidate; a GET storm of
             2^19 keys (5/8 present, 1/8 never inserted, 1/8 invalidated,
             1/8 evicted); 128 extents over the wire. The fast lane: 4
             connections opened with `directory=True` pull the directory
             and read 2^16 pre-fill keys each by MSG_FASTREAD; another
             connection rewrites 2^12 of them and the second pass must
             serve the new pages (their lanes stale, answered by the verb
             path); it invalidates 2^12 more and the third pass must miss
             them. A recovering window (`begin_recovering`, one GET verb of
             never-inserted keys past the mirror, MSG_RECOVERY's
             `mark_recovered`): its cold misses count as miss_recovering.
             Checks: hits byte-exact, misses zeroed, misses of acknowledged
             keys <= evictions + drops, `misses == Σ miss_*`,
             fastpath_hits + fastpath_stale == the fast lanes read, no
             serve error, no disconnect, no bloom false negative, >= 90%
             of never-inserted GETs short-circuited, one fused-GET launch
             per GET phase. Reports rates, verb latency, flush widths, the
             fast passes, `directory_snapshot` and `fast_view` costs; the
             kernel against plain at the smallest and largest GET-phase
             widths and its times at the largest. Then, with the KV freed,
             the one-sided sub-phase: a `PassivePool` of 2^21 rows (8 GiB)
             on the card behind `PoolServer`, 4 `OneSidedBackend`s over
             `RemotePool`s, each writing 2^16 pages and reading them back
             byte-exact; rows/s both ways.
9. fleet  — durability and the replicated fleet, after the wire: three
             nodes, each a `pmdfc_tpu_torch.tools.crashbox` child process
             (spawn) on the card serving linear·flat's configuration (an
             8 GiB pool) from a `KV` with its own write-ahead `Journal`
             (`JournalConfig()`) behind `NetServer(NetConfig())` on
             loopback: three 8 GiB pools on the one H100, the one phase
             where pools share the card, because a fleet needs them to.
             Snapshots and journals go to `build/fleet` (git-ignored; its
             filesystem and free bytes are printed, tmpfs or less than
             11 GiB free fails), removed at the end. One `ReplicaGroup`
             (rf 2, hedge 50 ms, the ring; repair by manual ticks) over a
             `ReconnectingClient(TcpBackend)` per node, whose factory
             follows the node's port, shared by 8 client threads with
             2^11-key verbs; keys (0xC0000000, i). Put 2^18 keys; node 2
             cuts a full snapshot; put 2^15; node 2 cuts a delta; put 2^14
             and invalidate 2^12 earlier keys (node 2's journal tail); a
             GET storm of 2^17 keys. With the traffic paused, SIGKILL node
             2; while it is down put 2^13, invalidate 2^11 and storm 2^17:
             every acknowledged, non-invalidated key hits byte-exact by
             failover, every invalidated key misses, node 2's breaker
             opens. Warm restart node 2 from [full, delta] and its journal
             (time from spawn to serving, with the child's split: chain
             read and verify, fold, to the device, `recovery()`, replay);
             over its own `TcpBackend`: every key the ring gives it that
             was acknowledged before the kill hits byte-exact (losses
             within `(rpo_ops + 1) x 2^11`, 0 expected), keys invalidated
             before the kill miss, it is `recovering` and the misses of
             the outage's keys count as `miss_recovering` with `misses ==
             Σ miss_*`. Rejoin: the breaker closes, repair ticks drain
             the backlog (pages/s), the drain's `mark_recovered` makes
             `recoveries_completed` 1 and node 2 leaves `recovering`;
             then node 2 serves every key it owns byte-exact, those put
             while it was down included (a bloom false positive of the
             repair scan is the one legal miss, counted), and no
             invalidated key is served by it or by the group (its client
             replays the invalidations it journaled). Node 2 cuts one
             more delta; the nodes stop; this process restores the
             three-member chain with `checkpoint.load_chain(...,
             device="cuda")` into a `KV`, where every such key hits
             byte-exact, and phase 3's comparison runs on that 8 GiB
             state. Throughout: one fused-GET launch per GET phase on
             every node (read over each child's control pipe), no serve
             error, no contained phase failure, no corrupt page, no wrong
             byte, no shed put. Reports snapshot seconds and GB/s, dirty
             rows, journal appends, syncs and fsync lag per node, put and
             GET rates and verb p50/p99 before and during the outage,
             time to recover and its split, repair pages/s, the
             in-process restore's seconds and peak RSS.
10. plane — the sharded plane, last: `ShardedKV` over a grid that names the
             card four times (`make_mesh(["cuda"] * 4)`), each shard
             linear·flat at 2^19 slots, `BloomConfig(num_bits=1 << 22)`
             (8 bits per slot, as linear·flat) and 4 KiB pages: four 2 GiB
             pools, 8 GiB in all — the reference server's 10 GB buffer
             split over four shards as `NuMA_KV` splits one server over its
             NUMA nodes; four shards on one card stand in for four devices
             (no width is cut). Fill 1,310,720 pages through
             `ShardedKV.insert` (a2a, 2^16-key batches; the a2a pair
             overflow is counted, 0 expected); put `PlaneBackend(skv)`
             behind `NetServer(NetConfig())` with the wire phase's 4 x 8
             pipelined connections: 262,144 pages over the wire (75% of the
             slots), the mirror check and invalidates, a GET storm of 2^19
             keys (present, never inserted, invalidated, evicted), 64
             extents, and the fast lane's three passes over 2^14 pre-fill
             keys per directory connection (per-(shard, row) validated
             reads around rewrites and invalidates). Checks: the
             wire phase's (hits byte-exact, misses zeroed, acknowledged
             misses <= evictions + drops, no serve error, NACK or
             disconnect; the mirrors, the OR of the per-shard filters,
             short-circuit what their bit density allows),
             `misses == Σ miss_*` on `stats()` and on every
             shard's row of `shard_report()`, the `shard{i}_ops` counters
             sum to the routed ops, every GET key routed is counted once,
             and one fused-GET launch per shard per GET phase; then the
             kernel against plain on shard 0's full state at w = 8 (the
             router's pad floor) and at the widest per-shard width served,
             timed at both. Snapshots to `build/plane` (git-ignored, on the
             checkout's disk): a full, 2^14 puts and 2^12 deletes, a delta;
             `restore_chain` onto a fresh 4-shard plane, where every key the
             delta held hits byte-exact and the deleted ones miss; the
             engine pass on that plane (`KVServer(kv=skv)`, 8 clean-cache
             threads putting and getting 2^16 pages through the engine:
             every hit byte-exact, no -2, no serve error, one launch per
             shard per GET flush); then, with both planes freed, the full
             reshard-restored onto 8 shards (16 GiB): no live page lost,
             invalidated keys stay missing, the replay drops nothing,
             counters carried. Last the 2 x 2 plane (`make_mesh2d(2, 2,
             ["cuda"] * 4)`, 2^20 slots per lane: 4 GiB pools, 16 GiB on
             the card, 8 GiB of distinct pages) behind `NetServer`: every
             connection negotiates `replica_lanes == 2`; 1,310,720 pages
             through `plane_insert` (one call writes both lanes) and 262,144
             over the wire; lane 1 corrupted: a storm serves every hit
             byte-exact from lane 0 and lane 1's `digest_refused` counts
             exactly lane 0's serves; `TcpBackend.replica_repair()`
             (`MSG_RREPAIR`) repairs at least every live row; lane 0
             corrupted: lane 1 serves, with the same checks, one launch per
             shard per lane per GET phase. Reports rates, verb p50/p99,
             snapshot and restore seconds, GB/s and peak RSS, the kernel at
             w = 8 and at the widest width.
11. control — the device-time profiler, the row-rebuild insert and the
             closed-loop controller, after the plane, its KV freed first.
             The row insert: two linear indexes of 2^21 slots (32 MiB
             each) filled to 75% in 2^16-key batches of fresh keys,
             updates, in-batch duplicates and padding (same-cluster
             collisions come with the fill), one through
             `insert_batch_element` and one through `insert_batch_row`:
             tables, heads and every InsertResult equal after every batch,
             every insert timed with CUDA events. Then a child process of
             this script (`--row-kv`) started with PMDFC_INSERT_PATH=row:
             linear·flat at 8 GiB filled to 75% through `KV.insert` on the
             row path, GET storms through the fused kernel (every hit
             byte-exact, every present key hits, `misses == Σ miss_*`),
             kernel against plain on that state, and its times. Then
             linear·tiered at 9 GiB (`TierConfig()`) pre-filled through
             `KV.insert`, behind `NetServer(NetConfig())` with PMDFC_PROF
             on, telemetry dumping under `build/control` (git-ignored,
             removed at the end), a series collector every 0.25 s and
             `autotune.attach(server=..., client=...)` with the KV's
             balloon bound: 32 pipelined `TcpBackend` connections, a light
             phase (one connection, 64-key verbs, 4 s) then a fan-in phase
             (all 32, 2^11-key verbs) during which a monitor connection
             sends MSG_PROFILE. Checks: every hit byte-exact, never-inserted
             keys miss, present keys miss only by a legal cause, `misses ==
             Σ miss_*`, no serve error or failed phase, no reconnect, one
             fused-GET launch per GET phase, the profiler's `kv.get`
             launches equal to the GET phases, each `kv.get` `device_us`
             (its CUDA event window) at least 0.9x the kernel alone at that
             width and at most the phase's wall, the capture's `trace.json`
             holding `fused_get_kernel` kernel events, a second capture
             inside the cooldown refused, the controller having consumed
             series windows with every knob inside its `AutotuneConfig`
             envelope, and `tools/proftool.py` breaking down the pulled
             MSG_STATS snapshot. Prints the knob moves (their direction
             depends on the host's timing and is not checked). Last, the
             harnesses `bench/insert_rowscatter.py` and
             `bench/telemetry_overhead.py --smoke` on the card, each its
             own process (the ON/OFF ratio is reported, not gated).
12. scale — the multi-process plane on torch.distributed and the
             reference's workload harnesses, after control. (a) Two
             processes from the `spawn` context join over gloo on
             loopback (`connect_multihost`, two shards each on the card,
             the exchange staged through pinned host buffers), each shard
             linear·flat at 2^19 slots, 8 bloom bits per slot, 4 KiB
             pages (8 GiB in all, phase 10's split). Every process passes
             the same full batches: 75% of the slots in 2^14-key a2a
             inserts (the pair overflow counted), 2^12 deletes, 6 a2a
             GETs of 2^14 keys (5/8 present, 1/8 deleted, 1/8 never
             inserted, 1/8 any) and one broadcast GET of 2^12 on the same
             plane. Checks in every process: every present key hits, every
             hit byte-exact, every deleted or never-inserted key misses,
             every miss zeroed, `misses == Σ miss_*` on `stats()` and on
             every shard's row of `shard_report()`, one fused-GET launch
             per shard per GET phase; the processes' results are
             identical; the kernel against plain on each process's first
             full shard at w = 8 and at the widest per-shard width (rank
             0 times it). Reports fill and GET rates and the exchange's
             bytes and seconds per batch. (b) One process in an NCCL
             group of world size 1, four 2^16-slot shards on the card
             (the exchange's collectives run on the card): the same
             checks. Then two NCCL ranks naming the one card must both
             be refused (`SharedDeviceError`) before any collective. (c)
             The harnesses of `pmdfc_tpu_torch/bench/`, each its own
             process with `--device cuda`, four side by side:
             `multihost_bench --procs 2 --backend gloo` (hits == n),
             `test_kv` over the reference baseline's 10M uniform keys at
             2^25 slots, linear then cceh (`failedSearch` 0), the six
             `paging_sim` jobs, `swap_sim`, filebench's fileserver and
             webserver (8 GiB pools; `verify_failures` 0), `replay` of
             the bundled trace and of 10^6 synthetic events (no wrong
             value), `multinode` with 3 clients (no wrong page).
13. tail   — the bench tail of `pmdfc_tpu_torch/bench/`, after scale.
             In this process, launches counted: `fused_get` for
             linear·flat and cceh·flat at phase 4's configurations (8 GiB
             pools filled to 75% of the slots), one family at a time, its
             kernel side (`KV.get_async`) against the composed chain
             (`kv._get_core` on a second KV) on zipf 0 and 0.99 streams
             of 2^18 keys in batches of 2^11, 2^14 and 2^16: pages, found
             and every stats lane equal on every batch, every hit the
             key's page, every miss zeroed, one launch per kernel-side GET
             and none on the composed side, both timed by CUDA events;
             then `tier_sweep`, linear at 2^21 slots tiered against flat
             (8 GiB each), batches of 2^14, zipf 0, 0.6, 0.99 and 1.2,
             2^18 GETs a skew: every hit byte-exact, every miss zeroed,
             `misses == Σ miss_*`. Each harness's last state is held
             kernel against plain and timed (w = 2^11, 2^14, 2^16). Then
             `mesh_sweep` (1, 2, 4 and 8 shards over an 8 GiB total, the
             one card named per shard, and the PMDFC_MESH=off row, behind
             `NetServer`; every verb verified, one launch per shard per
             GET phase). From the phase's start, five side by side, each
             its own process with `--device cuda`: `soak` (linear·flat at
             8 GiB through the engine for 60 s; no wrong page, no stale
             serve, no serve error), `fill_sweep` (its families and fills
             at 2^21 slots, inserts of 2^16), `insert_profile`,
             `train_pressure` (4 KiB pages), and `fastpath_sweep`,
             `replica_soak` and `elastic_sweep` (300 storm steps),
             `recovery_soak`, `containment_soak`, `qos_soak --backend
             direct` (4 KiB pages, 2^18 slots a node), each held to its
             gates (no wrong byte, no serve error, and its own: the RPO
             bound and `miss_recovering`, the isolation and re-admission,
             the shed attribution, a falling loss). Reports every row
             beside the card's name and power limit, and its wall time.

Each KV is freed before the next path's fill, so no two pools share the
card but the fleet's and the plane's own shards. The next-to-last line is one JSON object naming each kernel with its
path, launches, error and times; the last is `{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
PAGE_HI = 0x80000001  # hi word of page keys (>= 2^31: unsigned order matters)
EXT_HI = 0x80000002   # hi word of extent keys
INS_B, GET_B = 1 << 16, 1 << 14
HOT_SET = 1 << 12      # tiered paths: a quarter of each GET comes from it
BALLOON_EVICT = 2 * 1024  # tiered paths: live rows a forced shrink evicts
# the serving size: 2^21 slots for each family (CCEH's capacity is its
# initial segments' slots; one split of each gives the 2^21)
DEVICE = "cuda"
LINEAR_INDEX = dict(capacity=1 << 21)
CCEH_INDEX = dict(capacity=1 << 20)
CAUSE_NAMES = "(hit,pad,cold,evicted,ext,parked,stale,digest)"
# the families phase: linear·flat's serving configuration with only the
# index kind changed, for each family that takes the composed GET
FAMILY_INDEX = dict(capacity=1 << 21)
FAMILIES = ("cuckoo", "ccp", "level", "path", "static", "hotring")
# hotring: GET keys served before the mirror drill, and the decay period
# (`IndexConfig`'s default, so the decay fires once through `KV`)
HOT_GETS = 1 << 20
# the policy cache's check: its capacity and the keys per call
POLICY_CAPACITY, POLICY_B = 1 << 16, 1 << 12
# the serving path: linear·flat's configuration behind the engine and the
# KVServer driver; 4 clients x 8 threads (the reference's 4 clients x 8
# QPs), each thread with its own engine queue and a VERB-page arena slice
SERVE_INDEX = dict(capacity=1 << 21)
SERVE_BLOOM_BITS = 1 << 24
SERVE_ENGINE = dict(num_queues=32, queue_cap=1 << 14, batch=1 << 14,
                    arena_pages=1 << 16, page_bytes=4096)
CLIENT_GROUPS, GROUP_THREADS = 4, 8
VERB = 1 << 11         # pages per client verb
GET_VERBS = 8          # get_pages verbs per thread in the storm
SERVE_EXTENTS = 256    # extents one thread registers through the engine
PUT_ODD = 11_826       # a quiet PUT flush off the ladder: the mean width of
                       # the fill's PUT flushes on an H100
MISS_FILL = 0xA5A5A5A5  # a GET verb's arena slots hold this until served
BF_PUSH_S = 0.05       # the server's bloom push period
SERVE_HI = 0x90000000  # thread t's page keys are (SERVE_HI + t, i)
SERVE_DIRECT_HI = 0x9F000000  # the pre-fill's keys are (SERVE_DIRECT_HI, i)
NEVER_LO = 1 << 24     # lo words at or above this were never inserted
CLIENT_TIMEOUT_US = 120_000_000
# one deadline for all the client threads of a serving phase (the fill
# through the engine took 93-176 s on the H100)
PHASE_TIMEOUT_S = 600.0
# the wire: linear·flat's configuration behind the port's NetServer on
# loopback TCP, 4 clients x 8 connections (the reference's 4 clients x 8
# QPs), each a pipelined TcpBackend in a ReconnectingClient under a
# CleanCacheClient fed by the server's bloom pushes
WIRE_INDEX = dict(capacity=1 << 21)
WIRE_BLOOM_BITS = 1 << 24
WIRE_CLIENTS, WIRE_CONNS = 4, 8
WIRE_WINDOW = 32
WIRE_DIRECT = 1_310_720  # pages the pre-fill puts straight through KV.insert
WIRE_FILL = 1 << 18      # pages the connections then put over the wire
WIRE_GETS = 1 << 19      # keys of the GET storm
WIRE_EXTENTS = 128
WIRE_FAST_CONNS = 4      # connections that open with a directory
WIRE_FAST_KEYS = 1 << 16  # present keys each of them reads on the fast lane
WIRE_REWRITE = 1 << 12   # of those, keys rewritten, and keys invalidated
WIRE_HI = 0xA0000000     # connection c's wire keys are (WIRE_HI + c, i)
DIRECT_HI = 0xB0000000   # the pre-fill's keys are (DIRECT_HI, i)
# the one-sided sub-phase: a PassivePool of POOL_ROWS rows (8 GiB) behind
# PoolServer, POOL_CLIENTS OneSidedBackends each writing POOL_PAGES pages
POOL_ROWS = 1 << 21
POOL_CLIENTS = 4
POOL_PAGES = 1 << 16
# the fleet: three crashbox nodes at linear·flat's configuration behind a
# ReplicaGroup (rf 2); node FLEET_CRASH is snapshotted, killed, warm
# restarted and rejoined. Keys are (FLEET_HI, i).
FLEET_INDEX = dict(capacity=1 << 21)
FLEET_BLOOM_BITS = 1 << 24
FLEET_NODES = 3
FLEET_CRASH = 2
FLEET_THREADS = 8         # client threads sharing the group
FLEET_FILL = 1 << 18      # keys put before the full snapshot
FLEET_DELTA = 1 << 15     # keys put before the delta
FLEET_TAIL = 1 << 14      # keys put after the delta (the journal tail)
FLEET_INVAL = 1 << 12     # earlier keys invalidated in the tail
FLEET_STORM = 1 << 17     # GET keys of each storm
FLEET_DOWN_PUT = 1 << 13  # keys put while the node is down
FLEET_DOWN_INVAL = 1 << 11  # keys invalidated while it is down
FLEET_HI = 0xC0000000
FLEET_JOURNAL: dict = {}  # JournalConfig's defaults (rpo_ops 256, 50 ms)
FLEET_DISK_BYTES = 11 << 30  # a full, deltas and the journals
FLEET_START_S = 300.0     # a node's start timeout (spawn to serving)
FLEET_REPAIR_S = 600.0    # the repair drain's deadline

# the sharded plane (phase 10): per shard linear·flat at 2^19 slots and 8
# bloom bits per slot (a 2 GiB pool); four shards on the one card hold
# 8 GiB, the reference's 10 GB buffer split as NuMA_KV splits one server
PLANE_SHARDS = 4
PLANE_INDEX = dict(capacity=1 << 19)
PLANE_BLOOM_BITS = 1 << 22
PLANE_DIRECT = 1_310_720  # pages through ShardedKV.insert (a2a)
PLANE_INS_B = 1 << 16     # keys per a2a fill batch
PLANE_FILL = 1 << 18      # pages then put over the wire (75% of the slots)
PLANE_GETS = 1 << 19      # keys of the GET storm
PLANE_EXTENTS = 64
PLANE_FAST_KEYS = 1 << 14  # pre-fill keys each fast connection reads
PLANE_MUTATE = 1 << 14    # keys put between the full and the delta
PLANE_MUT_HI = 0xD0000000
PLANE_RESHARD = 8         # shards the full is reshard-restored onto (16 GiB)
PLANE_ENGINE_THREADS = 8
PLANE_ENGINE_PAGES = 1 << 16
PLANE_DISK_BYTES = 10 << 30  # the full and the delta
# the 2 x 2 replica plane: 2^20 slots per lane (a 4 GiB pool), 16 GiB on
# the card, 8 GiB of distinct pages
PLANE2D = (2, 2)
PLANE2D_INDEX = dict(capacity=1 << 20)
PLANE2D_BLOOM_BITS = 1 << 23

# phase 11, control: the row insert, the profiler and the controller
ROW_INDEX = dict(capacity=1 << 21)  # each of the two A/B indexes (32 MiB)
ROW_KV_TIMEOUT_S = 600.0  # the row-path KV's child process
CONTROL_INDEX = dict(capacity=1 << 21)
CONTROL_BLOOM_BITS = 1 << 24
CONTROL_CONNS = 32        # pipelined TcpBackend connections
CONTROL_LIGHT_S = 4.0     # the light phase: one connection, small verbs
CONTROL_LIGHT_VERB = 64
CONTROL_FANIN_VERBS = 8   # GET verbs of VERB keys per connection, fan-in
# the MSG_PROFILE capture sent mid-storm: the profiler's longest window,
# since a recorded session slows each tiered GET to a good part of a
# second (300 ms windows caught 0-1 of the fan-in's GET kernels)
CONTROL_CAPTURE_MS = 2000
CONTROL_HI = 0xE0000000   # the control path's pre-fill keys
# what a capture's trace must hold: a CUDA kernel event of the fused GET
TRACE_CAT, TRACE_NAME = "kernel", "fused_get_kernel"
# the harnesses run on the card, each as its own process
HARNESSES = (("insert_rowscatter", ()),
             ("telemetry_overhead", ("--smoke", "--gate", "1e9")))

# phase 12, scale: the multi-process plane on torch.distributed and the
# reference's workload harnesses. Part (a): 2 spawned processes joined
# over gloo, 2 shards each on the one card, each shard linear·flat at
# 2^19 slots (8 bits of bloom per slot, 4 KiB pages: 2 GiB pools, 8 GiB in
# all, phase 10's split); part (b): one process in an NCCL group of world
# size 1, 4 shards of 2^16 slots
SCALE_PROCS = 2
SCALE_PER_PROC = 2
SCALE_INDEX = dict(capacity=1 << 19)
SCALE_BLOOM_BITS = 1 << 22
SCALE_SOLO_BACKEND = "nccl"
SCALE_SOLO_SHARDS = 4
SCALE_SOLO_INDEX = dict(capacity=1 << 16)
SCALE_SOLO_BLOOM_BITS = 1 << 19
SCALE_INS_B = 1 << 14     # keys per a2a insert
SCALE_GET_B = 1 << 14     # keys per a2a GET
SCALE_GETS = 6            # a2a GET batches
SCALE_BCAST_B = 1 << 12   # the broadcast GET batch
SCALE_DELETE = 1 << 12    # present keys deleted before the GETs
SCALE_HI = 0xF0000000     # the plane's keys are (SCALE_HI, i)
SCALE_JOIN_S = 120.0      # connect_multihost's timeout
SCALE_TIMEOUT_S = 600.0   # a part's workers, spawn to exit
SCALE_TIMED = True        # rank 0 times the kernel (not in the rehearsal)
SCALE_HARNESS_LANES = 4   # harness processes run side by side
# the paging jobs over an 8 GiB pool (2^21 slots, 4 KiB pages): the read
# jobs batch 16 faults a window over a 4096-page file through a
# 1024-page RAM cache (8 passes of it); the write jobs go op by op (each
# write invalidates its page on the card), over a 1024-page file through
# a 256-page cache (8 passes)
_POOL = ("--capacity", str(1 << 21))
_READS = (*_POOL, "--file-pages", "4096", "--ram-pages", "1024", "--ops",
          "8192", "--iodepth", "16")
_WRITES = (*_POOL, "--file-pages", "1024", "--ram-pages", "256", "--ops",
           "2048")
SCALE_HARNESSES = (
    ("multihost_bench", ("--procs", "2", "--backend", "gloo")),
    ("test_kv", ("--n", "10000000", "--batch", "1000000", "--capacity",
                 str(1 << 25), "--index", "linear", "--no-engine")),
    ("test_kv", ("--n", "10000000", "--batch", "1000000", "--capacity",
                 str(1 << 25), "--index", "cceh", "--no-engine")),
    ("paging_sim", ("--job", "seq_read", *_READS)),
    ("paging_sim", ("--job", "rand_read", *_READS)),
    *(("paging_sim", ("--job", job, *_WRITES)) for job in
      ("rand_rw", "seq_rw", "seq_write")),
    ("paging_sim", ("--job", "scan_mix", *_POOL, "--ops", "4096",
                    "--iodepth", "16", "--repeats", "1")),
    ("swap_sim", (*_POOL, "--working-pages", "4096", "--ram-pages", "1024",
                  "--ops", "4096", "--iodepth", "16")),
    ("filebench", ("--personality", "fileserver", *_POOL, "--loops", "15")),
    ("filebench", ("--personality", "webserver", *_POOL, "--loops", "15")),
    ("replay", ("--trace", "tests/data/fileserver.trace")),
    ("replay", ("--synthetic", "1000000")),
    ("multinode", ("--clients", "3", *_POOL, "--ops", "3000")),
)


# ---------------------------------------------------------------------------
# phase 13, tail: the bench tail's harnesses
# ---------------------------------------------------------------------------

# fused_get, one family at a time at phase 4's configurations (4 KiB
# pages, 8 GiB pools, 75% of the slots filled), two KVs each
TAIL_FUSED = (("linear", LINEAR_INDEX["capacity"]),
              ("cceh", CCEH_INDEX["capacity"]))
TAIL_FUSED_ARGS = dict(page_words=1024, fill=0.75,
                       batches=[1 << 11, 1 << 14, 1 << 16], gets=1 << 18,
                       zipfs=[0.0, 0.99])
# tier_sweep: linear at 2^21 slots, tiered vs flat (8 GiB each); 2^18
# GETs a skew (cut from 2^19 for the time limit)
TAIL_TIER_ARGS = dict(capacity=1 << 21, page_words=1024, batch=1 << 14,
                      gets=1 << 18, zipfs=[0.0, 0.6, 0.99, 1.2],
                      hot_fraction=16)
TAIL_WIDTHS = (1 << 11, 1 << 14, 1 << 16)  # kernel against plain, timed
TAIL_TIMED_W = 1 << 14                    # the kernels line's width
# after the in-process sweeps, on the card alone: mesh_sweep over an
# 8 GiB total (1, 2, 4, 8 shards and PMDFC_MESH=off)
_TAIL_POOL = ("--capacity", str(1 << 21), "--page-words", "1024")
TAIL_SERIAL = (
    ("mesh_sweep", ("--shards", "1,2,4,8", *_TAIL_POOL, "--rounds", "1")),
)
# side by side in lanes from the phase's start: the soak (8 GiB, 60 s),
# then the host-bound harnesses at their JAX defaults but 4 KiB pages and
# 2^18 slots per node, the replica and elastic storms cut to 300 steps
# (from 600) for the time limit
_TAIL_NODE = ("--page-words", "1024", "--capacity", str(1 << 18))
TAIL_LANE_RUNS = (
    ("elastic_sweep", (*_TAIL_NODE, "--steps", "300", "--settle-steps",
                       "30")),
    ("recovery_soak", _TAIL_NODE),
    ("soak", ("--minutes", "1", *_TAIL_POOL)),
    ("train_pressure", ("--page-words", "1024")),
    ("replica_soak", (*_TAIL_NODE, "--steps", "300", "--kill-every", "75",
                      "--down-steps", "37")),
    ("fill_sweep", ("--capacity", str(1 << 21), "--batch", str(1 << 16))),
    ("fastpath_sweep", _TAIL_NODE),
    ("containment_soak", _TAIL_NODE),
    ("qos_soak", ("--backend", "direct", *_TAIL_NODE)),
    ("insert_profile", ()),
)
TAIL_LANES = 5
TAIL_ROWS = ("mesh_sweep", "fastpath_sweep", "qos_soak")  # rows in --out


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def variant_of(state) -> str:
    family = "cceh" if hasattr(state.index, "dirr") else "linear"
    pool = "tiered" if hasattr(state.pool, "cgen") else "flat"
    return f"fused_get_{family}_{pool}"


class Smoke:
    def __init__(self, seed: int):
        import numpy as np
        import torch

        from pmdfc_tpu_torch import kv as kv_mod
        from pmdfc_tpu_torch.ops import fused
        from pmdfc_tpu_torch.utils import u32
        from pmdfc_tpu_torch.utils.keys import is_invalid

        self.np, self.torch, self.kv_mod, self.fused, self.u32 = (
            np, torch, kv_mod, fused, u32)
        self.is_invalid = is_invalid
        self.dev = torch.device(DEVICE)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(seed)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.max_err: dict[str, int] = {}

    # -- data made on the device --------------------------------------------
    def keys_of(self, hi: int, lo):
        """[n, 2] int32 keys (u32 bits) from a hi word and int64 lo words."""
        torch, u32 = self.torch, self.u32
        hiw = torch.full_like(lo, hi)
        return torch.stack([u32.narrow(hiw), u32.narrow(lo)], dim=-1)

    def pages_of(self, keys, pw: int):
        """Page contents as a function of key and word index."""
        torch, u32 = self.torch, self.u32
        hi, lo = u32.widen(keys[:, 0]), u32.widen(keys[:, 1])
        j = torch.arange(pw, device=keys.device)
        base = u32.mul(lo, 0x9E3779B1) ^ u32.mul(hi, 0x85EBCA77)
        return u32.narrow(base[:, None] + u32.mul(j, 0x01000193)[None, :]
                          + 0x165667B1)

    def pick(self, idx, n: int):
        """n rows of idx drawn uniformly (with replacement)."""
        r = self.torch.randint(0, idx.shape[0], (n,), device=self.dev,
                               generator=self.gen)
        return idx[r]

    # -- kernel against plain -----------------------------------------------
    @staticmethod
    def kernel_args(state):
        """fused_get's tensors and keywords for a state (with its directory
        and `msb` flag for CCEH and extendible hashing, and the cold rows'
        sidecars for a tiered pool)."""
        ix, pool = state.index, state.pool
        kw = dict(dirr=ix.dirr, msb=ix.msb) if hasattr(ix, "dirr") else {}
        if hasattr(pool, "cgen"):
            kw.update(cgen=pool.cgen, live=pool.live,
                      hot_rows=pool.hfree.shape[0])
        return (ix.table, pool.pages, pool.sums, state.evicted_filter), kw

    def compare(self, keys, state, label: str):
        """Kernel and plain version on the same inputs, bit for bit;
        -> (the batch's cause counts, keys whose page entry sits on a cold
        row past the generation gate: they read its generation and live
        byte; 0 over the flat pool)."""
        torch, fused = self.torch, self.fused
        args, kw = self.kernel_args(state)
        got = fused.fused_get(keys, *args, **kw)
        want = fused.get_core_reference(keys, *args, **kw)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, r in zip(got, want))
        v = variant_of(state)
        self.max_err[v] = max(self.max_err.get(v, 0), err)
        if err:
            raise AssertionError(f"{label}: kernel differs from plain "
                                 f"version (max abs err {err})")
        cause, rows = want[1], want[2]
        cold = int((rows >= kw["hot_rows"]).sum()) if "hot_rows" in kw else 0
        return torch.bincount(cause, minlength=8).tolist(), cold

    def add_extents(self, kv, n: int):
        """n extents of a few pages under EXT_HI -> their base keys."""
        bases = [1000 * (j + 1) for j in range(n)]
        for j, base in enumerate(bases):
            kv.insert_extent(self.np.array([EXT_HI, base], self.np.uint32),
                             self.np.array([j, 4096 * j], self.np.uint32),
                             1 + 7 * j)
        return self.keys_of(EXT_HI, self.torch.tensor(bases, device=self.dev))

    def small_state(self, kind: str, s: int, tiered: bool = False):
        """A small KV on the card with evictions (CCEH: and splits),
        deletes, real extent covers and a sketch; tiered: a 1/16 hot tier
        through promotions, demotions and ghost readmits, then a forced
        shrink, a grow and fresh puts into the evicted rows (stale
        entries)."""
        torch, kv_mod = self.torch, self.kv_mod
        from pmdfc_tpu_torch.config import (IndexConfig, IndexKind, KVConfig,
                                            TierConfig)

        if kind == "linear":
            ix, n = IndexConfig(capacity=2048, cluster_slots=s), 3072
        else:  # 4 segments of 512 slots growing to 8, then evictions
            ix = IndexConfig(kind=IndexKind(kind), capacity=2048,
                             segment_slots=512, probe_window=s)
            n = 6144
        tier = TierConfig(hot_fraction=16, ghost_rows=64, balloon_step=64) \
            if tiered else None
        kv = kv_mod.KV(KVConfig(index=ix, page_words=64, tier=tier,
                                evicted_sketch_bits=1 << 14), device=self.dev)
        lo = torch.randint(0, 1 << 32, (n,), device=self.dev,
                           generator=self.gen)
        keys = self.keys_of(0x80000003, lo)
        for i in range(0, n, 1024):
            kv.insert(keys[i:i + 1024], self.pages_of(keys[i:i + 1024], 64))
        covers = self.add_extents(kv, 4)
        kv.delete(keys[n - 1024:n - 872])
        if tiered:
            for r in range(12):  # rotate over 3 windows of present keys
                kv.get(keys[(r % 3) * 400:(r % 3) * 400 + 600])
            kv.balloon_shrink(kv.balloon_state()["free"] + 256)
            kv.balloon_grow(256)
            fresh = self.keys_of(0x80000004, torch.arange(256, device=self.dev))
            kv.insert(fresh, self.pages_of(fresh, 64))
            t = kv.tier_stats()
            log("kernel", f"small {kind} S={s} tiered: promotions "
                f"{t['promotions']}, demotions {t['demotions']}, ghost "
                f"readmits {t['ghost_readmits']}, shrink evictions "
                f"{t['shrink_evictions']}")
            if not (t["demotions"] and t["ghost_readmits"]
                    and t["shrink_evictions"]):
                raise AssertionError("the small tiered state lacks a tier event")
        absent = self.keys_of(7, torch.randint(0, 1 << 32, (512,),
                                               device=self.dev,
                                               generator=self.gen))
        pool = torch.cat([keys, absent,
                          torch.full((64, 2), -1, dtype=torch.int32,
                                     device=self.dev)])
        return kv, pool, keys[:2048], covers

    def poke(self, kv, keys, covers):
        """Corrupt one present key's page word (tiered: one on a hot row
        and one on a cold row, then poke one entry to NOPAGE and clear one
        current cold row's live bit, and take up to 8 stale keys); keep up
        to 4 of the cover keys that are live extent entries. -> (probe
        head: those keys and covers, undo)."""
        from pmdfc_tpu_torch import tier
        from pmdfc_tpu_torch.models.base import get_index_ops

        torch, u32 = self.torch, self.u32
        ops = get_index_ops(kv.config.index.kind)
        st = kv.state
        pool = st.pool
        res = ops.get_batch(st.index, keys)
        cres = ops.get_batch(st.index, covers)
        live = cres.found & (cres.values[:, 0] == self.fused.EXTENT_TAG_I32)
        if not bool(live.any()):
            raise AssertionError("no live extent cover to probe")
        rows = res.values[:, 1]
        if not hasattr(pool, "cgen"):
            picks = [int(res.found.nonzero().flatten()[0])]
            corrupt, extra = picks, []
        else:
            h = pool.hfree.shape[0]
            entry = res.found & ((u32.widen(res.values[:, 0]) >> 30) == 0)
            cur = tier.entry_current(pool, res.values)
            page = entry & cur & tier.row_live(pool, rows)
            hot = (page & (rows < h)).nonzero().flatten().tolist()
            cold = (page & (rows >= h)).nonzero().flatten().tolist()
            if not hot or len(cold) < 3:
                raise AssertionError("no hot or too few cold keys to poke")
            picks = [hot[0], cold[0], cold[1], cold[2]]
            corrupt = picks[:2]
            extra = (entry & ~cur).nonzero().flatten()[:8].tolist()
        saved = [(int(rows[k]), st.pool.pages[int(rows[k]), 0].clone())
                 for k in corrupt]
        for r, _ in saved:
            st.pool.pages[r, 0] ^= 1 << 7
        if hasattr(pool, "cgen"):
            knp, kd = picks[2], picks[3]
            slot = res.slots[knp:knp + 1]
            ops.set_values(st.index, slot, u32.narrow(torch.tensor(
                [[0xC0000000, 0]], device=keys.device)))
            drow = int(rows[kd]) - pool.hfree.shape[0]
            pool.live[drow] = False

        def undo():
            for r, word in saved:
                st.pool.pages[r, 0] = word
            if hasattr(pool, "cgen"):
                ops.set_values(st.index, slot, res.values[knp:knp + 1])
                pool.live[drow] = True

        return torch.cat([keys[picks + extra], covers[live][:4]]), undo

    def kernel_phase(self, kv, pool, present, covers, label: str,
                     extra=None, need=None):
        """Kernel against plain at w in {16, 2^10, 2^14}: each batch holds
        the poked keys (and `extra` keys) ahead of keys drawn from `pool`;
        at w >= 2^10 every cause in `need` must occur (by default every
        cause of the pool: the tiered pool's PARKED and STALE too)."""
        torch = self.torch
        head, undo = self.poke(kv, present, covers)
        if extra is not None:
            head = torch.cat([head, extra])
        tiered = hasattr(kv.state.pool, "cgen")
        if need is None:
            need = range(8) if tiered else (0, 1, 2, 3, 4, 7)
        for w in (16, 1 << 10, 1 << 14):
            npad = w // 64  # padding rides every batch but the smallest
            keys = torch.cat([head, self.pick(pool, max(
                w - head.shape[0] - npad, 0)),
                              torch.full((npad, 2), -1, dtype=torch.int32,
                                         device=self.dev)])[:w]
            causes, _ = self.compare(keys, kv.state, f"{label} w={w}")
            log("kernel", f"{label} w={w}: kernel == plain, causes "
                f"{CAUSE_NAMES}={causes}")
            if w >= 1 << 10 and not all(causes[c] for c in need):
                raise AssertionError(f"{label} w={w}: a cause is missing")
        undo()


def time_ms(torch, fns, iters: int, warmup: int = 3,
            device_only: bool = False) -> float:
    """Mean ms per call over `iters` calls taken round-robin from `fns`.
    With `device_only`, the stream is first held busy (about 50 ms) so the
    host queues every call before the first runs: the events then see the
    device's time alone, not the host's time to launch."""
    for i in range(warmup):
        fns[i % len(fns)]()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(100_000_000)  # cycles
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_breakdown(torch, fn, iters: int) -> str:
    """Device-side breakdown of `fn` from torch.profiler: device ops per
    call, device busy time per call, and the ops taking the most of it.
    `fn` runs 1 + `iters` times whatever the profiler does, and an
    exception from `fn` propagates: only the profiler's own failure is
    caught, and then the line says "not measured"."""
    fn()
    torch.cuda.synchronize()
    prof = failed = None
    try:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # the profiler's own failure: report, go on
        prof, failed = None, e
    try:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    finally:
        if prof is not None:
            try:
                prof.stop()
                events = prof.key_averages()
            except Exception as e:  # the profiler's own failure
                failed = e
    if failed is not None:
        return f"not measured: {failed!r}"
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return "not measured: the profiler saw no device activity"
    busy = sum(e.self_device_time_total for e in dev) / iters / 1e3
    ops = sum(e.count for e in dev) / iters
    d2h = sum(e.count for e in dev if "DtoH" in e.key) / iters
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize",
                             "cudaDeviceSynchronize")) / iters
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    parts = "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / iters / 1e3:.4f} ms "
        f"x{e.count // iters}" for e in top)
    return (f"{ops:.0f} device ops, device busy {busy:.4f} ms per call, "
            f"{d2h:.1f} device-to-host copies and {syncs:.1f} stream "
            f"synchronizes per call; top: {parts}")


class MainPath:
    """One index family's serving path through `KV` at the serving size.

    Key index i <-> key (PAGE_HI, i); `status[i]`: 0 never inserted,
    1 present, 2 capacity-evicted, 3 deleted, 4 dropped, 5 its row evicted
    by a forced balloon shrink (tiered: the entry is stale). With a `hot`
    set of key indices, a quarter of every mixed batch is drawn from it."""

    def __init__(self, sm: Smoke, cfg, label: str):
        torch = sm.torch
        self.sm, self.label = sm, label
        self.kv = sm.kv_mod.KV(cfg, device=sm.dev)
        self.pw = cfg.page_words
        self.n_slots = self.kv.capacity()
        self.n_fill = (3 * self.n_slots // 4) // INS_B * INS_B
        self.n_keys = self.n_fill + self.n_slots
        self.status = torch.zeros(self.n_keys, dtype=torch.int8,
                                  device=sm.dev)
        self.evicted_covers: set[int] = set()  # lo words of EXT_HI keys
        self.evictions = self.drops = 0
        self.hot = None
        st = self.kv.state
        log("main", f"{label}: KV on {self.kv.device}: {self.n_slots} slots, "
            f"table {tuple(st.index.table.shape)}, pool "
            f"{tuple(st.pool.pages.shape)} = "
            f"{st.pool.pages.numel() * 4 / 2**30:.2f} GiB, bloom "
            f"{cfg.bloom.num_bits} counters, sketch "
            f"{cfg.evicted_sketch_bits} bits")

    def track(self, res) -> None:
        """Mark what an insert evicted: page keys turn status 2, extent
        covers join `evicted_covers`."""
        sm, u32 = self.sm, self.sm.u32
        ev = res.evicted
        if not isinstance(ev, sm.torch.Tensor):  # uint32 from a host call
            ev = u32.from_numpy(ev, sm.dev)
        ev = ev[~sm.is_invalid(ev)]
        hi = u32.widen(ev[:, 0])
        self.status[u32.widen(ev[hi == PAGE_HI, 1])] = 2
        self.evicted_covers |= set(u32.widen(ev[hi == EXT_HI, 1]).tolist())
        self.evictions += ev.shape[0]

    def fill(self, start: int, stop: int) -> float:
        """Insert key indices [start, stop) in INS_B batches -> seconds."""
        sm, torch = self.sm, self.sm.torch
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for i in range(start, stop, INS_B):
            lo = torch.arange(i, i + INS_B, device=sm.dev)
            keys = sm.keys_of(PAGE_HI, lo)
            res = self.kv.insert(keys, sm.pages_of(keys, self.pw))
            self.status[lo] = torch.where(res.dropped, 4, 1).to(torch.int8)
            self.drops += int(res.dropped.sum())
            self.track(res)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    def counts(self):
        return self.sm.torch.bincount(self.status.long(),
                                      minlength=6).tolist()

    def mixed(self, n: int, deleted: bool):
        sm, torch, status = self.sm, self.sm.torch, self.status
        present = (status == 1).nonzero().flatten()
        evicted = (status == 2).nonzero().flatten()
        never = (status == 0).nonzero().flatten()
        if self.hot is None:
            parts = [sm.pick(present, n * 5 // 8)]
        else:
            parts = [sm.pick(self.hot, n // 4),
                     sm.pick(present, n * 5 // 8 - n // 4)]
        parts.append(sm.pick(never, n // 8))
        if evicted.numel():
            parts.append(sm.pick(evicted, n // 8))
        if deleted:
            parts.append(sm.pick((status == 3).nonzero().flatten(), n // 16))
        idx = torch.cat(parts)
        keys = torch.cat([sm.keys_of(PAGE_HI, idx),
                          torch.full((n - idx.numel(), 2), -1,
                                     dtype=torch.int32, device=sm.dev)])
        return keys[torch.randperm(n, device=sm.dev, generator=sm.gen)]

    def check_get(self, keys, out, found, stats_before, label):
        sm, kv = self.sm, self.kv
        valid = ~sm.is_invalid(keys)
        st = self.status[sm.u32.widen(keys[:, 1]).clamp(max=self.n_keys - 1)]
        want = valid & (st == 1)
        if not sm.torch.equal(found, want):
            raise AssertionError(f"{label}: found mask != present keys "
                                 f"({int((found != want).sum())} differ)")
        if not sm.torch.equal(out[found], sm.pages_of(keys[found], self.pw)):
            raise AssertionError(f"{label}: a hit returned wrong bytes")
        if out[~found].any():
            raise AssertionError(f"{label}: a miss returned nonzero bytes")
        d = (kv.state.stats.long() - stats_before).tolist()
        s = dict(zip(sm.kv_mod.STAT_NAMES, d))
        causes = sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES)
        counts = [int((valid & (st == k)).sum()) for k in range(6)]
        if s["misses"] != causes:
            raise AssertionError(f"{label}: misses {s['misses']} != "
                                 f"sum of causes {causes}")
        if s["misses"] > sum(counts) - counts[1]:
            raise AssertionError(f"{label}: more misses than lost keys")
        if s["miss_evicted"] < counts[2]:
            raise AssertionError(f"{label}: evicted keys not attributed")
        return s, counts

    def serve(self, rounds: int, deleted: bool, label: str):
        sm, torch, kv = self.sm, self.sm.torch, self.kv
        for _ in range(rounds):
            keys = self.mixed(GET_B, deleted)
            before = kv.state.stats.long()
            out, found = kv.get(keys)
            s, counts = self.check_get(keys, out, found, before,
                                       f"{label} get")
            before = kv.state.stats.long()
            o2, order, f2, nfound, b = kv.get_compact_async(keys)
            nf = int(nfound)
            hits = found.nonzero().flatten()
            if not (torch.equal(f2[:b], found) and nf == hits.numel()
                    and torch.equal(order[:nf].long(), hits)
                    and torch.equal(o2[:nf], out[hits])):
                raise AssertionError(f"{label}: get_compact disagrees with get")
            self.check_get(keys, out, found, before, f"{label} get_compact")
        log("main", f"{self.label} {label}: {rounds} x (get + get_compact) of "
            f"{GET_B} keys ok; last batch (never,present,evicted,deleted,"
            f"dropped,stale)={counts}, hits={s['hits']}, misses="
            f"{s['misses']} (cold={s['miss_cold']}, evicted="
            f"{s['miss_evicted']}, stale={s['miss_stale']}, digest="
            f"{s['miss_digest']})")

    def delete(self):
        sm = self.sm
        gone = sm.pick((self.status == 1).nonzero().flatten(), GET_B).unique()
        hit = self.kv.delete(sm.keys_of(PAGE_HI, gone))
        if not bool(hit.all()):
            raise AssertionError("delete missed present keys")
        self.status[gone] = 3
        log("main", f"{self.label} delete: {gone.numel()} keys, all hit")

    def run_fill(self, on_fill_step=None):
        """Fill 75% of the slots -> seconds. `on_fill_step(i)` runs after
        the fill batch that ends at key index i."""
        t = 0.0
        for i in range(0, self.n_fill, INS_B):
            t += self.fill(i, i + INS_B)
            if on_fill_step is not None:
                on_fill_step(i + INS_B)
        self.t_fill = t
        log("main", f"{self.label} fill: {self.n_fill} pages in {t:.3f} s = "
            f"{self.n_fill / t:.0f} pages/s; evictions {self.evictions}, "
            f"drops {self.drops}; status counts (never,present,evicted,"
            f"deleted,dropped,stale)={self.counts()}")

    def run(self, on_fill_step=None):
        """Fill, serve, delete, serve."""
        self.run_fill(on_fill_step)
        self.serve(4, False, "serve")
        self.delete()
        self.serve(4, True, "serve after delete")


def measure(sm: Smoke, path: MainPath, launches: int, dir_bytes: int = 0):
    """Phase 5 for one path -> its kernel's `kernels` entry."""
    torch, fused, kv = sm.torch, sm.fused, path.kv
    st = kv.state
    name = variant_of(st)
    smi = nvidia_smi()
    s = st.index.table.shape[1] // 4
    args, kw = sm.kernel_args(st)
    # 8 distinct batches: their pages (about 8 x 42 MB) far exceed the
    # 50 MB L2, so launches rotated over them read from memory, as a
    # stream of fresh requests does; one batch repeated is the warm time.
    batches = [path.mixed(GET_B, True) for _ in range(8)]
    nbytes = []
    for i, k in enumerate(batches):
        causes, cold = sm.compare(k, st, f"timed batch {i}")
        nbytes.append(fused.fused_get_bytes(causes, GET_B, s, path.pw,
                                            st.evicted_filter.numel(),
                                            dir_bytes, cold))
    kern = [lambda k=k: fused.fused_get(k, *args, **kw) for k in batches]
    plain = [lambda k=k: fused.get_core_reference(k, *args, **kw)
             for k in batches]
    ms = time_ms(torch, kern, 48, device_only=True)
    warm_ms = time_ms(torch, kern[:1], 48, device_only=True)
    host_ms = time_ms(torch, kern, 48)
    plain_ms = time_ms(torch, plain, 8, device_only=True)
    mean_bytes = sum(nbytes) / len(nbytes)
    bound_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
    warm_bound_ms = nbytes[0] / HBM_BYTES_PER_S * 1e3
    log("times", f"{name} w={GET_B}, rotated over {len(batches)} "
        f"batches: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({mean_bytes:.0f} bytes per batch, "
        f"{min(nbytes)}..{max(nbytes)}) = {bound_ms / ms:.1%} of the memory "
        f"rate; no single PyTorch call computes this function, so there is "
        f"no library time ({smi})")
    log("times", f"{name} w={GET_B}, one batch repeated (warm L2): "
        f"kernel {warm_ms:.4f} ms, bound {warm_bound_ms:.4f} ms "
        f"({nbytes[0]} bytes) = {warm_bound_ms / warm_ms:.1%} ({smi})")
    log("times", f"{name} w={GET_B}, rotated, launched back to back "
        f"from the host with no queue ahead: {host_ms:.4f} ms per call "
        f"(wrapper and launch on the host included) ({smi})")
    kv_get = [lambda k=k: kv.get(k) for k in batches]
    get_ms = time_ms(torch, kv_get, 24)
    log("times", f"{path.label} whole-path KV.get, rotated: {get_ms:.3f} ms "
        f"per {GET_B} keys = {GET_B / get_ms * 1e3:.0f} keys/s (a tiered "
        f"KV.get includes its tier.on_get epilogue); fill "
        f"{path.n_fill / path.t_fill:.0f} pages/s ({smi})")
    log("times", f"{path.label} torch.profiler, KV.get of 2^14 keys: "
        + profile_breakdown(torch, kv_get[0], 5))
    return {
        "name": name,
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err[name],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "path": path.label,
    }


def all_keys(sm: Smoke, path: MainPath):
    """Every page key of the path plus padding: the full-size probe pool."""
    torch = sm.torch
    return torch.cat([sm.keys_of(PAGE_HI, torch.arange(path.n_keys,
                                                        device=sm.dev)),
                      torch.full((64, 2), -1, dtype=torch.int32,
                                 device=sm.dev)])


def run_linear(sm: Smoke):
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig

    cfg = KVConfig(index=IndexConfig(**LINEAR_INDEX),
                   bloom=BloomConfig(num_bits=1 << 24, num_hashes=4))
    path = MainPath(sm, cfg, "linear")
    sm.fused.launches.clear()
    sm.torch.cuda.synchronize()
    path.run()
    sm.torch.cuda.synchronize()
    launches = sm.fused.launches["fused_get_linear_flat"]
    if launches <= 0:
        raise AssertionError("the linear main path never launched its kernel")
    check_stats(sm, path)

    # 3, continued: kernel against plain on the full-size state, with
    # real extent covers for EXT
    present = (path.status == 1).nonzero().flatten()[:4096]
    covers = sm.add_extents(path.kv, 4)
    sm.kernel_phase(path.kv, all_keys(sm, path),
                    sm.keys_of(PAGE_HI, present), covers, "linear full")
    return measure(sm, path, launches)


def check_stats(sm: Smoke, path: MainPath) -> None:
    stats = path.kv.stats()
    if stats["misses"] != sum(stats[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError("misses != sum of miss causes")
    log("main", f"{path.label}: {dict(sm.fused.launches)} launches on the "
        f"main path; utilization {path.kv.utilization():.4f}; stats "
        f"{json.dumps(stats)}")


def recovery_drill(sm: Smoke, path: MainPath) -> None:
    """Damage one replicated directory entry: the present keys behind it
    stop hitting; `recovery()` restores the directory and they hit
    byte-exact again."""
    torch, u32, kv = sm.torch, sm.u32, path.kv
    from pmdfc_tpu_torch.utils.hashing import hash_u64

    ix = kv.state.index
    saved = ix.dirr.clone()
    dirr, ld = saved.tolist(), ix.ld.tolist()
    gmax = len(dirr).bit_length() - 1
    i = next((i for i in range(len(dirr))
              if i & ((1 << (gmax - ld[dirr[i]])) - 1)), None)
    if i is None:
        raise AssertionError("no replicated directory entry to damage")
    present = (path.status == 1).nonzero().flatten()
    keys = sm.keys_of(PAGE_HI, present)
    bucket = hash_u64(keys[:, 0], keys[:, 1]) >> (32 - gmax)
    behind = keys[bucket == i]
    ix.dirr[i] = (dirr[i] + 1) % len(dirr)
    _, found = kv.get(behind)
    hidden = int((~found).sum())
    if hidden != behind.shape[0] or hidden == 0:
        raise AssertionError(f"damaged entry {i} hid {hidden} of "
                             f"{behind.shape[0]} keys")
    kv.recovery()
    if not torch.equal(ix.dirr, saved):
        raise AssertionError("recovery() did not restore the directory")
    before = kv.state.stats.long()
    out, found = kv.get(behind)
    path.check_get(behind, out, found, before, "after recovery")
    log("main", f"{path.label} recovery: directory entry {i} of "
        f"{len(dirr)} damaged, {hidden} present keys behind it missed; "
        f"recovery() restored the directory, all {hidden} hit byte-exact "
        f"(nseg {int(ix.nseg)}, gdepth {u32.widen(ix.gdepth).item()})")


def extent_phase(sm: Smoke, path: MainPath):
    """A few hundred extents on the CCEH path -> live cover base keys."""
    np, torch, kv, kv_mod = sm.np, sm.torch, path.kv, sm.kv_mod
    cfg = kv.config
    lengths = [1, 2, 3, 7, 64, 100, 255, 1000, 4096, 3000, 33, 517]
    vlos = [0x7FFFF000, 0xFFFFF000, 0x7FF00000, 0xFFF80000, 0, 0x12345000]
    exts = []  # (base, length, value words)
    for j in range(298):
        base = (j + 1) * (1 << 22) + int(sm.rng.integers(0, 4096))
        vlo = (vlos[j % len(vlos)] - 4096 * (j % 5)) % (1 << 32)
        exts.append((base, lengths[j % len(lengths)], (j, vlo)))
    exts += [((1 << 31) - 1500, 3000, (7, 0x7FFFF800)),   # base across 2^31
             ((1 << 32) - 5000, 4096, (8, 0xFFFFE000))]   # base near 2^32
    covers, uncovered = [], 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for base, n, val in exts:
        res, unc = kv.insert_extent(np.array([EXT_HI, base], np.uint32),
                                    np.array(val, np.uint32), n)
        path.track(res)
        bases, _ = kv_mod._covers(base, n, cfg.extent_max_covers,
                                  cfg.extent_max_height)
        covers.append([b for b in bases if b != 0xFFFFFFFF])
        uncovered += unc
    torch.cuda.synchronize()
    t_ext = time.monotonic() - t0

    # probe: offsets inside each run and just past it. A key is found
    # through any live cover of its own extent that one of GetExtent's
    # height-masked probes names (extents are disjoint, so no other
    # record spans it), and its address is value + 4096 * offset.
    probe, expect = [], []
    heights = range(cfg.extent_max_height)
    for (base, n, val), cb in zip(exts, covers):
        live = set(cb) - path.evicted_covers
        for o in (0, n - 1, n // 2, int(sm.rng.integers(0, n)), n + 3):
            lo = base + o
            hit = o < n and any((lo >> h) << h in live for h in heights)
            probe.append([EXT_HI, lo])
            expect.append((hit, (((val[0] << 32) | val[1]) + 4096 * o)
                           % (1 << 64)))
    keys = sm.u32.from_numpy(np.array(probe, np.uint32), sm.dev)
    before = kv.state.stats.long()
    out, found = kv.get_extent(keys)
    got = sm.u32.to_numpy(out).astype(np.uint64)
    addr = (got[:, 0] << np.uint64(32)) | got[:, 1]
    found = found.cpu().numpy()
    want_found = np.array([e[0] for e in expect])
    if not np.array_equal(found, want_found):
        raise AssertionError(f"get_extent: found mask differs at "
                             f"{int((found != want_found).sum())} keys")
    want = np.array([e[1] for e in expect], np.uint64)
    if not np.array_equal(addr[found], want[found]) or addr[~found].any():
        raise AssertionError("get_extent: wrong address")
    d = dict(zip(kv_mod.STAT_NAMES,
                 (kv.state.stats.long() - before).tolist()))
    if d["misses"] != sum(d[c] for c in kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError("get_extent: misses != sum of causes")

    # a page GET of a live cover is a cold miss (cause EXT); a page put
    # over a cover converts it into a page entry
    live = [b for cb in covers for b in cb if b not in path.evicted_covers]
    ck = sm.keys_of(EXT_HI, torch.tensor(live[:256], device=sm.dev))
    before = kv.state.stats.long()
    out, found = kv.get(ck)
    d = dict(zip(kv_mod.STAT_NAMES,
                 (kv.state.stats.long() - before).tolist()))
    if found.any() or out.any() or d["miss_cold"] != ck.shape[0] \
            or d["misses"] != ck.shape[0]:
        raise AssertionError(f"page GET of covers: {d}")
    conv = ck[:8]
    res = kv.insert(conv, sm.pages_of(conv, path.pw))
    path.track(res)
    out, found = kv.get(conv)
    if not (found.all() and torch.equal(out, sm.pages_of(conv, path.pw))):
        raise AssertionError("a page put over a cover did not convert it")
    log("main", f"{path.label} extents: {len(exts)} inserted in "
        f"{t_ext:.3f} s ({sum(map(len, covers))} covers, {uncovered} pages "
        f"uncovered, {len(path.evicted_covers)} covers evicted); get_extent "
        f"of {len(probe)} keys: {int(want_found.sum())} addresses exact, the "
        f"rest missed as expected; page GET of "
        f"{ck.shape[0]} covers: all cold misses; 8 page puts over covers "
        f"converted them")
    return sm.keys_of(EXT_HI, torch.tensor(live[8:264], device=sm.dev))


def find_anyway_check(sm: Smoke, path: MainPath) -> None:
    torch, kv, status = sm.torch, path.kv, path.status
    idx = torch.cat([sm.pick((status == 1).nonzero().flatten(), 8),
                     sm.pick((status >= 2).nonzero().flatten(), 4),
                     torch.arange(path.n_fill, path.n_fill + 4,
                                  device=sm.dev)])
    keys = sm.keys_of(PAGE_HI, idx)
    vals, found, slot = kv.find_anyway(keys)
    res = kv._ops.get_batch(kv.state.index, keys)
    if not (torch.equal(found, status[idx] == 1)
            and torch.equal(found, res.found)
            and torch.equal(slot, res.slots)
            and torch.equal(vals[found], res.values[found])):
        raise AssertionError("find_anyway disagrees with the hashed probe")
    log("main", f"{path.label} find_anyway: 16 keys scanned over "
        f"{path.n_slots} slots, {int(found.sum())} found, slots and values "
        f"equal to the hashed probe's")


def run_cceh(sm: Smoke):
    from pmdfc_tpu_torch.config import IndexConfig, IndexKind, KVConfig

    cfg = KVConfig(index=IndexConfig(kind=IndexKind.CCEH, **CCEH_INDEX))
    path = MainPath(sm, cfg, "cceh")
    ix = path.kv.state.index
    log("main", f"cceh: {int(ix.nseg)} segments of "
        f"{cfg.index.segment_slots} slots, directory {ix.dirr.numel()} "
        f"entries ({ix.dirr.numel() * 4} bytes), up to {ix.ld.numel()} "
        f"segments, {ix.rounds} insert rounds, {ix.k_splits} splits a round")
    third = path.n_fill // 3 // INS_B * INS_B

    def step(i):
        if i == third:
            log("main", f"cceh after {i} pages: nseg {int(ix.nseg)}, gdepth "
                f"{sm.u32.widen(ix.gdepth).item()}, evictions "
                f"{path.evictions}")
            recovery_drill(sm, path)

    sm.fused.launches.clear()
    sm.torch.cuda.synchronize()
    path.run(step)
    log("main", f"cceh after the fill: nseg {int(ix.nseg)}, gdepth "
        f"{sm.u32.widen(ix.gdepth).item()}, evictions {path.evictions}, "
        f"drops {path.drops}")
    covers = extent_phase(sm, path)
    find_anyway_check(sm, path)
    sm.torch.cuda.synchronize()
    launches = sm.fused.launches["fused_get_cceh_flat"]
    if launches <= 0:
        raise AssertionError("the CCEH main path never launched its kernel")
    check_stats(sm, path)

    # 3, continued: kernel against plain on the full-size state
    present = (path.status == 1).nonzero().flatten()[:4096]
    sm.kernel_phase(path.kv, all_keys(sm, path),
                    sm.keys_of(PAGE_HI, present), covers, "cceh full")
    return measure(sm, path, launches, dir_bytes=ix.dirr.numel() * 4)


def hot_resident(sm: Smoke, kv, idx):
    """Of key indices `idx` (present keys), those whose entry points at a
    hot row."""
    res = kv._ops.get_batch(kv.state.index, sm.keys_of(PAGE_HI, idx))
    return idx[res.found & (res.values[:, 1] < kv.state.pool.hfree.shape[0])]


def tier_line(kv) -> str:
    t = kv.tier_stats()
    return ", ".join(f"{k} {t[k]}" for k in (
        "promotions", "demotions", "hot_hits", "cold_hits", "hot_occupied",
        "migrated_bytes", "balloon_grows", "balloon_shrinks",
        "shrink_evictions", "cold_free"))


def run_tiered(sm: Smoke, kind: str):
    """One family's 9 GiB tiered path: fill, serve with a hot set (its keys
    promote and then hit byte-exact from hot rows), update hot-resident
    keys in place, delete (hot-resident keys among them), a forced balloon
    shrink whose evicted keys all miss as stale, a grow and fresh puts
    into the evicted rows (the old keys still miss, the new hit), then
    kernel against plain on the full-size state."""
    torch, u32, kv_mod = sm.torch, sm.u32, sm.kv_mod
    from pmdfc_tpu_torch.config import (AdmitConfig, BloomConfig, IndexConfig,
                                        IndexKind, KVConfig, TierConfig)

    if kind == "linear":
        cfg = KVConfig(index=IndexConfig(**LINEAR_INDEX),
                       bloom=BloomConfig(num_bits=1 << 24), tier=TierConfig())
    else:
        cfg = KVConfig(index=IndexConfig(kind=IndexKind.CCEH, **CCEH_INDEX),
                       tier=TierConfig(admit=AdmitConfig()))
    path = MainPath(sm, cfg, f"{kind}·tiered")
    kv = path.kv
    pool = kv.state.pool
    h = pool.hfree.shape[0]
    log("main", f"{path.label}: {h} hot + {pool.live.numel()} cold rows, "
        f"{cfg.tier}")
    variant = variant_of(kv.state)
    sm.fused.launches.clear()
    torch.cuda.synchronize()
    path.run_fill()

    # serve with a hot set: its keys reach 2 touches and promote
    present = (path.status == 1).nonzero().flatten()
    path.hot = present[torch.randperm(present.numel(), device=sm.dev,
                                      generator=sm.gen)[:HOT_SET]]
    path.serve(4, False, "serve")
    res_hot = hot_resident(sm, kv, path.hot)
    if res_hot.numel() == 0 or kv.tier_stats()["promotions"] <= 0:
        raise AssertionError(f"{path.label}: nothing promoted")
    before = kv.state.stats.long()
    hits0 = kv.tier_stats()["hot_hits"]
    keys = sm.keys_of(PAGE_HI, res_hot)
    out, found = kv.get(keys)
    path.check_get(keys, out, found, before, "hot-resident get")
    if kv.tier_stats()["hot_hits"] - hits0 != res_hot.numel():
        raise AssertionError(f"{path.label}: hot-resident keys not served "
                             "from hot rows")
    log("main", f"{path.label} hot set: {res_hot.numel()} of {HOT_SET} keys "
        f"on rows < {h}, all hit byte-exact from hot rows; {tier_line(kv)}")
    if kind != "linear":
        log("main", f"{path.label} admit_state {json.dumps(kv.admit_state())}")

    # update in place: new bytes on hot rows, read back, then restored
    upd = sm.keys_of(PAGE_HI, res_hot[:64])
    new_pages = sm.pages_of(upd, path.pw) ^ 0x5A5A5A5A
    kv.insert(upd, new_pages)
    out, found = kv.get(upd)
    if not (found.all() and torch.equal(out, new_pages)):
        raise AssertionError(f"{path.label}: in-place update not served")
    if hot_resident(sm, kv, res_hot[:64]).numel() != 64:
        raise AssertionError(f"{path.label}: an update moved a hot key")
    kv.insert(upd, sm.pages_of(upd, path.pw))
    log("main", f"{path.label} update: 64 hot-resident keys rewritten in "
        f"place and read back byte-exact, then restored")

    # delete, hot-resident keys among them: their hot rows free
    occ0 = kv.tier_stats()["hot_occupied"]
    gone_hot = res_hot[64:320]
    hit = kv.delete(sm.keys_of(PAGE_HI, gone_hot))
    if not bool(hit.all()):
        raise AssertionError("delete missed hot-resident keys")
    path.status[gone_hot] = 3
    occ1 = kv.tier_stats()["hot_occupied"]
    if occ1 != occ0 - gone_hot.numel():
        raise AssertionError(f"hot_occupied {occ0} -> {occ1} after deleting "
                             f"{gone_hot.numel()} hot-resident keys")
    path.delete()
    path.serve(2, True, "serve after delete")
    log("main", f"{path.label} delete: hot_occupied {occ0} -> {occ1} for "
        f"{gone_hot.numel()} hot-resident keys deleted")

    # forced balloon shrink: free rows park, then the coldest live rows
    # are evicted; every key on an evicted row misses as stale
    live0 = pool.live.clone()
    free = kv.balloon_state()["free"]
    kv.balloon_shrink(free + BALLOON_EVICT)
    evicted_rows = live0 & ~pool.live
    present = (path.status == 1).nonzero().flatten()
    res = kv._ops.get_batch(kv.state.index, sm.keys_of(PAGE_HI, present))
    crow = (res.values[:, 1].long() - h).clamp(min=0)
    on_evicted = (res.values[:, 1] >= h) & evicted_rows[crow]
    stale_idx = present[on_evicted]
    if stale_idx.numel() != int(evicted_rows.sum()) or not stale_idx.numel():
        raise AssertionError(f"{path.label}: {stale_idx.numel()} keys on "
                             f"{int(evicted_rows.sum())} evicted rows")
    path.status[stale_idx] = 5
    before = kv.state.stats.long()
    for i in range(0, stale_idx.numel(), GET_B):
        k = sm.keys_of(PAGE_HI, stale_idx[i:i + GET_B])
        out, found = kv.get(k)
        if found.any() or out.any():
            raise AssertionError("a key on an evicted row was served")
    d = dict(zip(kv_mod.STAT_NAMES, (kv.state.stats.long() - before).tolist()))
    if d["miss_stale"] != stale_idx.numel() or d["misses"] != d["miss_stale"]:
        raise AssertionError(f"{path.label}: evicted keys missed as {d}")
    log("main", f"{path.label} balloon shrink by {free} free + "
        f"{BALLOON_EVICT}: {stale_idx.numel()} live rows evicted, every key "
        f"on them missed as miss_stale; {kv.balloon_state()}")

    # grow, then fresh keys reuse the evicted rows: old keys still miss,
    # the new keys hit byte-exact
    kv.balloon_grow(stale_idx.numel())
    nfree = kv.balloon_state()["free"]
    new_idx = (path.status == 0).nonzero().flatten()[:nfree]
    new_keys = sm.keys_of(PAGE_HI, new_idx)
    res = kv.insert(new_keys, sm.pages_of(new_keys, path.pw))
    path.status[new_idx] = torch.where(res.dropped, 4, 1).to(torch.int8)
    path.track(res)
    rows = kv._ops.get_batch(kv.state.index, new_keys).values[:, 1].long()
    reused = int(evicted_rows[(rows - h).clamp(min=0)].sum())
    if reused == 0:
        raise AssertionError("no fresh key landed on an evicted row")
    for label, idx in (("stale keys", stale_idx), ("fresh keys", new_idx)):
        for i in range(0, idx.numel(), GET_B):
            k = sm.keys_of(PAGE_HI, idx[i:i + GET_B])
            before = kv.state.stats.long()
            out, found = kv.get(k)
            path.check_get(k, out, found, before, f"{label} after regrow")
    log("main", f"{path.label} balloon grow: {nfree} rows back, {new_idx.numel()}"
        f" fresh keys inserted, {reused} on rows the shrink evicted; the "
        f"{stale_idx.numel()} stale keys still miss, the fresh keys hit "
        f"byte-exact; {tier_line(kv)}")
    torch.cuda.synchronize()
    launches = sm.fused.launches[variant]
    if launches <= 0:
        raise AssertionError(f"the {path.label} main path never launched "
                             "its kernel")
    check_stats(sm, path)

    # 3, continued: kernel against plain on the full-size state, with
    # real extent covers, stale keys and capacity-evicted keys in the head
    covers = sm.add_extents(kv, 4)
    cand = torch.cat([path.hot, (path.status == 1).nonzero().flatten()[:4096],
                      stale_idx[:64]])
    evicted = (path.status == 2).nonzero().flatten()[:4]
    sm.kernel_phase(kv, all_keys(sm, path), sm.keys_of(PAGE_HI, cand), covers,
                    f"{path.label} full", extra=sm.keys_of(PAGE_HI, evicted))
    dir_bytes = kv.state.index.dirr.numel() * 4 if kind != "linear" else 0
    return measure(sm, path, launches, dir_bytes=dir_bytes)


def scan_agrees(sm: Smoke, path: MainPath) -> int:
    """The page keys a scan of the whole table finds are exactly the
    present ones (every reported drop, eviction and delete gone, every
    placement there) -> the count of occupied slots."""
    torch, u32 = sm.torch, sm.u32
    flat_keys, _ = path.kv._ops.scan(path.kv.state.index)
    occ = flat_keys[~sm.is_invalid(flat_keys)]
    if not bool((u32.widen(occ[:, 0]) == PAGE_HI).all()):
        raise AssertionError(f"{path.label}: a foreign key in the table")
    held = u32.widen(occ[:, 1]).sort().values
    present = (path.status == 1).nonzero().flatten()
    if not torch.equal(held, present):
        raise AssertionError(
            f"{path.label}: the table holds {held.numel()} page keys, the "
            f"inserts reported {present.numel()} present")
    return occ.shape[0]


def hot_mirror_drill(sm: Smoke, path: MainPath, decays: int,
                     gets: int) -> None:
    """HotRing after at least 2^20 GET keys: the default decay fired through
    `KV`, and its shift put every hot key in its bucket's mirror (a hot
    key is touched about 64 times; the shift caps its heat key at
    0xFFFFFFFE, so a count of 1 after the halving would tie an untouched
    occupant). Then 64 hot keys are updated in place: their mirror rows
    are invalidated, and GETs serve the new bytes from the table; the old
    pages go back."""
    torch, kv = sm.torch, path.kv
    from pmdfc_tpu_torch.models import hotring

    if not decays:
        raise AssertionError(f"{path.label}: the decay never fired")
    hot = sm.keys_of(PAGE_HI, path.hot.unique())
    in_mirror = hotring.probe_hot(kv.state.index, hot)
    if not bool(in_mirror.all()):
        raise AssertionError(f"hotring: {int((~in_mirror).sum())} of "
                             f"{hot.shape[0]} hot keys not in the mirror")
    upd = hot[:64]
    new_pages = sm.pages_of(upd, path.pw) ^ 0x5A5A5A5A
    kv.insert(upd, new_pages)
    if bool(hotring.probe_hot(kv.state.index, upd).any()):
        raise AssertionError("hotring: an update left its mirror row")
    out, found = kv.get(upd)
    if not (bool(found.all()) and torch.equal(out, new_pages)):
        raise AssertionError("hotring: an updated hot key served stale bytes")
    kv.insert(upd, sm.pages_of(upd, path.pw))
    log("families", f"hotring mirror: {decays} decay(s) through KV "
        f"after {gets} GET keys; all {hot.shape[0]} hot keys resolve "
        f"from the mirror; 64 hot keys updated in place served their new "
        f"bytes from the table (mirror rows invalidated), then restored")


def run_family(sm: Smoke, kind: str) -> None:
    """One index family through `KV` at linear·flat's serving configuration
    with only `kind` changed: fill 75% of its slots, serve mixed GETs and
    get_compact (HotRing: a quarter from a hot set, at least 2^20 GET keys,
    then the mirror drill), delete, serve again; the table's scan must
    hold exactly the present keys. Times: fill, `KV.get` wall (CUDA
    events) and device busy, device ops and copies per insert and get."""
    torch = sm.torch
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, IndexKind, \
        KVConfig

    smi = nvidia_smi()
    cfg = KVConfig(index=IndexConfig(kind=IndexKind(kind),
                                     decay_every_gets=HOT_GETS,
                                     **FAMILY_INDEX),
                   bloom=BloomConfig(num_bits=1 << 24))
    path = MainPath(sm, cfg, kind)
    kv = path.kv
    decays = [0]
    if kv._ops.decay is not None:
        real_decay = kv._ops.decay

        def decay(index):
            decays[0] += 1
            return real_decay(index)
        kv._ops = dataclasses.replace(kv._ops, decay=decay)
    log("families", f"{kind}: num_slots {path.n_slots}, pool "
        f"{kv.state.pool.pages.numel() * 4 / 2**30:.2f} GiB")
    sm.fused.launches.clear()
    torch.cuda.synchronize()
    path.run_fill()
    if kind == "hotring":
        present = (path.status == 1).nonzero().flatten()
        path.hot = present[torch.randperm(present.numel(), device=sm.dev,
                                          generator=sm.gen)[:HOT_SET]]
        rounds = -(-HOT_GETS // (2 * GET_B))
    else:
        rounds = 4
    path.serve(rounds, False, "serve")
    if kind == "hotring":
        hot_mirror_drill(sm, path, decays[0], rounds * 2 * GET_B)
    path.delete()
    path.serve(2, True, "serve after delete")
    scan_agrees(sm, path)
    check_stats(sm, path)

    # times: KV.get over 8 mixed batches, and inserts of fresh keys (they
    # take the table from 75% to about 87% of its slots); the profiled
    # calls are real verbs whose results the checks below hold
    batches = [path.mixed(GET_B, True) for _ in range(8)]
    get_ms = time_ms(torch, [lambda k=k: kv.get(k) for k in batches], 24)
    starts = iter(range(path.n_fill, path.n_keys - INS_B, INS_B))

    def insert_fresh():
        i = next(starts)
        lo = torch.arange(i, i + INS_B, device=sm.dev)
        keys = sm.keys_of(PAGE_HI, lo)
        res = kv.insert(keys, sm.pages_of(keys, path.pw))
        path.status[lo] = torch.where(res.dropped, 4, 1).to(torch.int8)
        path.drops += int(res.dropped.sum())
        path.track(res)

    ins_prof = profile_breakdown(torch, insert_fresh, 3)
    get_prof = profile_breakdown(torch, lambda: kv.get(batches[0]), 5)
    path.serve(2, True, "serve after the timed inserts")
    if kind == "static" and path.evictions:
        raise AssertionError("static evicted")
    occupied = scan_agrees(sm, path)
    check_stats(sm, path)
    torch.cuda.synchronize()
    if sum(sm.fused.launches.values()):
        raise AssertionError(f"{kind} took the fused GET: "
                             f"{dict(sm.fused.launches)}")
    log("families", f"{kind}: fill {path.n_fill / path.t_fill:.0f} pages/s "
        f"({path.n_fill} pages in {path.t_fill:.3f} s); KV.get "
        f"{get_ms:.3f} ms per {GET_B} keys (CUDA events, rotated over 8 "
        f"batches); evictions {path.evictions}, drops {path.drops} (fill "
        f"and timed inserts); occupied {occupied} of {path.n_slots} slots "
        f"({smi})")
    log("families", f"{kind} torch.profiler, KV.insert of {INS_B} fresh "
        f"pages: {ins_prof} ({smi})")
    log("families", f"{kind} torch.profiler, KV.get of {GET_B} keys: "
        f"{get_prof} ({smi})")


def policy_cache_check(sm: Smoke) -> None:
    """The standalone policy cache on `sm.dev` against the same calls on
    the CPU, for LRU, LFU and FIFO: fill 3/4 of POLICY_CAPACITY, get live
    keys with repeats (LRU ticks, LFU counts) beside never-inserted and
    padding keys, put a batch of new keys past capacity with duplicates
    and padding (evictions over tied metrics), update live keys, get
    again. Every get, every eviction and the table, metric and tick after
    each call must be identical."""
    torch, u32 = sm.torch, sm.u32
    from pmdfc_tpu_torch.ops import policy_cache as pc

    cap, b = POLICY_CAPACITY, POLICY_B
    gen = torch.Generator().manual_seed(11)

    def rand(n):
        return torch.randint(0, 1 << 31, (n, 2), dtype=torch.int32,
                             generator=gen)

    for policy in ("lru", "lfu", "fifo"):
        card = pc.init(cap, policy, device=sm.dev)
        host = pc.init(cap, policy, device="cpu")
        live, evictions = rand(0), 0

        def same(label, *pairs):
            for x, y in pairs:
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"policy cache {policy} {label}: "
                                         "card != CPU")
            for f in ("table", "metric", "tick"):
                if not torch.equal(getattr(card, f).cpu(),
                                   getattr(host, f)):
                    raise AssertionError(f"policy cache {policy} {label}: "
                                         f"{f} differs, card != CPU")

        def put(keys, label):
            nonlocal evictions
            vals = rand(keys.shape[0])
            _, ek, ev = pc.put_batch(card, keys.to(sm.dev), vals.to(sm.dev))
            _, hk, hv = pc.put_batch(host, keys, vals)
            same(label, (ek, hk), (ev, hv))
            evictions += int((~sm.is_invalid(hk)).sum())

        def get(keys, label):
            _, cv, cf = pc.get_batch(card, keys.to(sm.dev))
            _, hv, hf = pc.get_batch(host, keys)
            same(label, (cv, hv), (cf, hf))
            return hf

        for _ in range(3 * cap // 4 // b):
            keys = rand(b)
            put(keys, "fill")
            live = torch.cat([live, keys])
        pad = torch.full((16, 2), -1, dtype=torch.int32)
        for _ in range(3):
            hot = live[torch.randint(0, live.shape[0], (b // 2,),
                                     generator=gen)]
            get(torch.cat([hot, hot[:b // 4], rand(b // 4 - 16), pad]),
                "get with repeats")
        new = rand(2 * b)
        put(torch.cat([new, new[:b // 8], pad]), "put past capacity")
        put(live[:b], "update")
        found = get(torch.cat([live[:b], new[:b]]), "get after evictions")
        if not evictions:
            raise AssertionError(f"policy cache {policy}: nothing evicted")
        log("families", f"policy cache {policy} on {sm.dev}: every get, "
            f"eviction and state leaf == the CPU's over capacity {cap} in "
            f"{b}-key calls; {evictions} evictions, {int(found.sum())} of "
            f"{2 * b} keys found after them")


def run_families(sm: Smoke) -> None:
    """The families phase: each of FAMILIES in turn, each KV freed before
    the next family's fill; then the policy cache's check."""
    for kind in FAMILIES:
        run_family(sm, kind)
        sm.torch.cuda.empty_cache()
    policy_cache_check(sm)


def pages_np(hi, lo, pw: int):
    """`Smoke.pages_of` on the host: the pages of keys (hi, lo), uint32
    (hi a word or one per key)."""
    import numpy as np

    with np.errstate(over="ignore"):
        base = (np.asarray(lo, np.uint32) * np.uint32(0x9E3779B1)) \
            ^ (np.asarray(hi, np.uint32) * np.uint32(0x85EBCA77))
        cols = np.arange(pw, dtype=np.uint32) * np.uint32(0x01000193)
        return base[:, None] + cols[None, :] + np.uint32(0x165667B1)


def percentiles_ms(xs) -> str:
    import numpy as np

    p50, p99 = np.percentile(np.asarray(xs) * 1e3, [50, 99])
    return f"p50 {p50:.3f} ms, p99 {p99:.3f} ms over {len(xs)} verbs"


def run_threads(targets, label: str) -> float:
    """Run one thread per callable, join them all by one deadline,
    PHASE_TIMEOUT_S after the start -> wall seconds; a thread still running
    at the deadline or any thread's exception fails the phase."""
    import threading

    errors: list[BaseException] = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)
        return run

    threads = [threading.Thread(target=wrap(fn), name=f"client-{i}")
               for i, fn in enumerate(targets)]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    deadline = t0 + PHASE_TIMEOUT_S
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    wall = time.monotonic() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError(f"{label}: a client thread did not finish "
                             f"within {PHASE_TIMEOUT_S} s")
    if errors:
        raise AssertionError(f"{label}: {len(errors)} client thread(s) "
                             f"failed; first: {errors[0]!r}") from errors[0]
    return wall


class ServeClient:
    """One client thread of the serving path: its own engine queue, a
    `VERB`-page arena slice (`EngineBackend`) and a `CleanCacheClient`
    registered for bloom pushes. Its page keys are (SERVE_HI + tid, i)."""

    def __init__(self, srv, tid: int, n_fill: int, seed: int):
        import numpy as np

        from pmdfc_tpu_torch.client import CleanCacheClient, EngineBackend

        self.np, self.tid, self.n_fill = np, tid, n_fill
        self.hi = SERVE_HI + tid
        self.pw = srv.config.page_words
        self.rng = np.random.default_rng([seed, tid])
        self.be = EngineBackend(srv, queue=tid, slice_pages=VERB,
                                timeout_us=CLIENT_TIMEOUT_US)
        self.never_asked = 0  # never-inserted keys that reached the server
        real_get = self.be.get

        def get(keys):
            """Counts never-inserted keys asked; checks that the server
            wrote nothing into a miss's arena slot (one verb: len(keys)
            <= VERB, the slice)."""
            self.never_asked += int(((keys[:, 0] == self.hi)
                                     & (keys[:, 1] >= NEVER_LO)).sum())
            slots = self.be.engine.arena[self.be.arena_lo:][:len(keys)]
            slots[:] = MISS_FILL
            out, found = real_get(keys)
            if (slots[~found] != MISS_FILL).any():
                raise AssertionError(f"client {tid}: the server wrote into "
                                     "a miss's arena slot")
            return out, found

        self.be.get = get
        self.cc = CleanCacheClient(self.be)
        srv.register_bf_client(self.cc)
        self.put_lat: list[float] = []
        self.get_lat: list[float] = []
        self.inval = np.zeros(0, np.uint32)
        self.acked_misses = self.negatives = self.never = 0

    def oids(self, n: int):
        return self.np.full(n, self.hi, self.np.uint32)

    def fill(self) -> None:
        """put_pages of [0, n_fill) in VERB-page verbs."""
        np = self.np
        for v in range(self.n_fill // VERB):
            lo = np.arange(v * VERB, (v + 1) * VERB, dtype=np.uint32)
            pages = pages_np(self.hi, lo, self.pw)
            t0 = time.perf_counter()
            self.cc.put_pages(self.oids(VERB), lo, pages)
            self.put_lat.append(time.perf_counter() - t0)

    def check_mirror(self) -> None:
        """After a push: every acknowledged key the mirror denies must be
        one the server lost. Asked without the mirror, each must miss."""
        from pmdfc_tpu_torch.utils.hashing_np import query_packed_np

        np = self.np
        acked = np.arange(self.n_fill, dtype=np.uint32)
        keys = np.stack([self.oids(self.n_fill), acked], -1)
        neg = keys[~query_packed_np(self.cc._bloom, keys, self.cc.num_hashes)]
        for i in range(0, len(neg), VERB):
            _, found = self.be.get(neg[i:i + VERB])
            if found.any():
                raise AssertionError(f"client {self.tid}: a key its mirror "
                                     "denies still hits (false negative)")
        self.negatives = len(neg)

    def prepare(self) -> None:
        """The mirror check, then invalidate 1/8 of the GET volume through
        the engine."""
        np = self.np
        self.check_mirror()
        n_inv = GET_VERBS * VERB // 8
        perm = self.rng.permutation(self.n_fill).astype(np.uint32)
        self.inval = np.sort(perm[:n_inv])
        self.cc.invalidate_pages(self.oids(n_inv), self.inval)
        self.present = perm[n_inv:]

    def storm(self) -> None:
        """GET_VERBS get_pages verbs: 5/8 present, 1/8 never inserted, 1/8
        invalidated, 1/16 from the first fill verb (the likeliest evicted),
        1/16 padding. Checks every verb: hits byte-exact, misses zeroed
        (their arena slots untouched by the server: `get` above),
        never-inserted, invalidated and padding keys miss."""
        np = self.np
        present = self.present
        oldest = np.setdiff1d(np.arange(VERB, dtype=np.uint32), self.inval)
        k8, k16 = VERB // 8, VERB // 16
        for _ in range(GET_VERBS):
            kinds = [(present, VERB - 2 * k8 - 2 * k16, 0),
                     (None, k8, 1), (self.inval, k8, 2), (oldest, k16, 3)]
            his, los, tags = [], [], []
            for pool, n, tag in kinds:
                if pool is None:
                    lo = self.rng.integers(NEVER_LO, 1 << 32, n,
                                           dtype=np.uint64).astype(np.uint32)
                else:
                    lo = pool[self.rng.integers(0, len(pool), n)]
                his.append(self.oids(n))
                los.append(lo)
                tags.append(np.full(n, tag, np.int8))
            his.append(np.full(k16, 0xFFFFFFFF, np.uint32))  # padding
            los.append(np.full(k16, 0xFFFFFFFF, np.uint32))
            tags.append(np.full(k16, 4, np.int8))
            order = self.rng.permutation(VERB)
            hi, lo, tag = (np.concatenate(x)[order] for x in (his, los, tags))
            t0 = time.perf_counter()
            out, found = self.cc.get_pages(hi, lo)
            self.get_lat.append(time.perf_counter() - t0)
            if found[(tag == 1) | (tag == 2) | (tag == 4)].any():
                raise AssertionError(f"client {self.tid}: a never-inserted, "
                                     "invalidated or padding key hit")
            if not np.array_equal(out[found],
                                  pages_np(self.hi, lo[found], self.pw)):
                raise AssertionError(f"client {self.tid}: a hit returned "
                                     "wrong bytes")
            if out[~found].any():
                raise AssertionError(f"client {self.tid}: a miss returned "
                                     "nonzero bytes")
            self.acked_misses += int((~found & ((tag == 0) | (tag == 3))).sum())
            self.never += k8

    def extents(self, n: int, stats) -> tuple[int, int]:
        """n extents through OP_INS_EXT, read back through OP_GET_EXT
        (`extent_roundtrip`)."""
        return extent_roundtrip(self.be, n, stats)


def extent_roundtrip(be, n: int, stats) -> tuple[int, int]:
    """n extents registered through a client backend, read back in
    VERB-key verbs: every address found is value + 4096 * (key -
    base), keys past a run's end miss, and in-run keys missed are at
    most the evictions the phase made. -> (in-run probes found, of)."""
    import numpy as np

    ev0 = stats()["evictions"]
    exts = []
    for j in range(n):
        base, length = (j + 1) * 4096, 1 + (7 * j) % 61
        value = (j, (0xFFFF0000 - 4096 * 64 * j) % (1 << 32))
        unc = be.insert_extent(np.array([EXT_HI, base], np.uint32),
                               np.array(value, np.uint32), length)
        if unc:
            raise AssertionError(f"extent {j}: {unc} pages uncovered")
        exts.append((base, length, value))
    probe, want, inrun = [], [], []
    for base, length, (vhi, vlo) in exts:
        for o in (0, length - 1, length // 2, length):
            probe.append([EXT_HI, base + o])
            want.append((((vhi << 32) | vlo) + 4096 * o) % (1 << 64))
            inrun.append(o < length)
    probe, want, inrun = (np.array(probe, np.uint32),
                          np.array(want, np.uint64), np.array(inrun))
    vals, found = np.zeros((0, 2), np.uint32), np.zeros(0, bool)
    for i in range(0, len(probe), VERB):
        v, f = be.get_extent(probe[i:i + VERB])
        vals, found = np.concatenate([vals, v]), np.concatenate([found, f])
    addr = (vals[:, 0].astype(np.uint64) << np.uint64(32)) | vals[:, 1]
    if found[~inrun].any():
        raise AssertionError("get_extent found a key past a run's end")
    if not np.array_equal(addr[found], want[found]) or addr[~found].any():
        raise AssertionError("get_extent returned a wrong address")
    lost = int((inrun & ~found).sum())
    if lost > stats()["evictions"] - ev0:
        raise AssertionError(f"get_extent lost {lost} in-run keys beyond "
                             "the phase's evictions")
    return int(found.sum()), int(inrun.sum())


class ServePath:
    """The serving path's key sets on the device for phase 5 (`measure`):
    status[tid, i] of key (SERVE_HI + tid, i): 1 present, 3 invalidated."""

    def __init__(self, sm: Smoke, kv, clients, t_fill: float):
        torch = sm.torch
        self.sm, self.kv, self.label = sm, kv, "serving"
        self.pw = kv.config.page_words
        n = clients[0].n_fill
        self.n_fill, self.t_fill = n * len(clients), t_fill
        status = torch.ones((len(clients), n), dtype=torch.int8,
                            device=sm.dev)
        for c in clients:
            status[c.tid, torch.from_numpy(c.inval.astype("int64")).to(
                sm.dev)] = 3
        self.status = status

    def keys(self, want: int):
        """Keys of status `want` as [n, 2] int32 on the device."""
        sm = self.sm
        tid, lo = (self.status == want).nonzero(as_tuple=True)
        return sm.torch.stack([sm.u32.narrow(tid + SERVE_HI),
                               sm.u32.narrow(lo)], dim=-1)

    def mixed(self, n: int, deleted: bool = True):
        """5/8 present, 1/8 never inserted, 1/16 invalidated, padding."""
        sm, torch = self.sm, self.sm.torch
        never = torch.stack([
            sm.u32.narrow(torch.randint(0, self.status.shape[0], (n // 8,),
                                        device=sm.dev, generator=sm.gen)
                          + SERVE_HI),
            sm.u32.narrow(torch.randint(NEVER_LO, 1 << 32, (n // 8,),
                                        device=sm.dev, generator=sm.gen))],
            dim=-1)
        parts = [sm.pick(self.keys(1), n * 5 // 8), never]
        if deleted:
            parts.append(sm.pick(self.keys(3), n // 16))
        keys = torch.cat(parts)
        keys = torch.cat([keys, torch.full((n - keys.shape[0], 2), -1,
                                           dtype=torch.int32, device=sm.dev)])
        return keys[torch.randperm(n, device=sm.dev, generator=sm.gen)]


def quiet_flushes(sm: Smoke, srv, path: ServePath) -> None:
    """With the driver stopped and no client running, through a probe
    engine that shares the server's KV: `serve_batch` of a PUT flush of
    present keys re-put with their own pages, at GET_B and at PUT_ODD
    pages (a width the pad ladder rounds up), and of one GET flush of GET_B
    mixed keys. Checks (they raise): every re-put page is served back, and
    the GET flush's statuses agree with `KV.get`. Measured: each flush's
    host-clock time (mean of 3); a PUT_ODD flush's padding step both ways
    (padded on the host with GET_B rows across, or `KV._padded`: PUT_ODD
    rows across, padded on the device); torch.profiler over the GET flush
    (device ops, device busy time, host syncs)."""
    np, torch, smi = sm.np, sm.torch, nvidia_smi()
    from pmdfc_tpu_torch.runtime import OP_GET, OP_PUT, Engine, KVServer

    eng = Engine(num_queues=1, queue_cap=GET_B, batch=GET_B,
                 arena_pages=GET_B, page_bytes=path.pw * 4)
    probe = KVServer(srv.config, engine=eng, kv=srv.kv)

    def flush(op, keys):
        n = len(keys)
        base = eng.submit_batch(0, op, keys, np.arange(n, dtype=np.uint32))
        reqs = eng.pop_batch(n, timeout_us=0)
        if len(reqs) != n:
            raise AssertionError(f"probe flush popped {len(reqs)} of {n}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            probe.serve_batch(reqs)
        torch.cuda.synchronize()
        return reqs, eng.wait_many(base, n), (
            time.perf_counter() - t0) / 3 * 1e3

    try:
        put_ms = {}
        for n in (GET_B, PUT_ODD):
            keys = sm.u32.to_numpy(sm.pick(path.keys(1), n))
            pages = pages_np(keys[:, 0], keys[:, 1], path.pw)
            eng.arena[:n] = pages
            _, st, put_ms[n] = flush(OP_PUT, keys)
            out, found = srv.kv.get(keys)
            if (st != 0).any() or not (found.all()
                                       and np.array_equal(out, pages)):
                raise AssertionError(f"a re-put flush of {n} pages did not "
                                     "serve its pages")
        rows = eng.arena[np.arange(PUT_ODD)]  # the flush's gather
        w = sm.kv_mod._pad_pow2(PUT_ODD)

        def host_pad():
            h = np.zeros((w, rows.shape[1]), np.int32)
            h[:PUT_ODD] = rows.view(np.int32)
            return torch.from_numpy(h).to(srv.kv.device)

        host_ms = time_ms(torch, [host_pad], 5, warmup=1)
        dev_ms = time_ms(torch, [lambda: srv.kv._padded(rows, w, 0)], 5,
                         warmup=1)
        keys = sm.u32.to_numpy(path.mixed(GET_B))
        reqs, st, get_ms = flush(OP_GET, keys)
        _, found = srv.kv.get(keys)
        if not np.array_equal(st == 0, found):
            raise AssertionError("a served GET flush disagrees with KV.get")
        log("serve", f"quiet flushes (driver stopped, no client running), "
            f"serve_batch, host clock, mean of 3: PUT flush of {GET_B} pages "
            f"{put_ms[GET_B]:.3f} ms, of {PUT_ODD} pages (padded to {w}) "
            f"{put_ms[PUT_ODD]:.3f} ms, GET flush of {GET_B} keys "
            f"{get_ms:.3f} ms; the {PUT_ODD}-page flush's padding, mean of "
            f"5: padded on the host, {w} rows across {host_ms:.3f} ms; "
            f"KV._padded, {PUT_ODD} rows across and padded on the device "
            f"{dev_ms:.3f} ms ({smi})")
        prof = profile_breakdown(torch, lambda: probe.serve_batch(reqs), 5)
        log("serve", f"torch.profiler of the quiet GET flush: {prof} ({smi})")
    finally:
        eng.close()


def run_serving(sm: Smoke):
    """The serving path: linear·flat at the serving size behind the native
    engine and the `KVServer` driver, CLIENT_GROUPS x GROUP_THREADS clean-
    cache client threads (one engine queue each), a bloom push every
    BF_PUSH_S. Fill 75% of the slots (5/8 through KV.insert, then an
    eighth through the engine), push, then the GET
    storm and the extent verbs; then kernel against plain on the server's
    full-size state and phase 5's times."""
    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.runtime import Engine, KVServer

    smi = nvidia_smi()
    cfg = KVConfig(index=IndexConfig(**SERVE_INDEX),
                   bloom=BloomConfig(num_bits=SERVE_BLOOM_BITS))
    srv = KVServer(cfg, engine=Engine(**SERVE_ENGINE), device=DEVICE,
                   bf_push_s=BF_PUSH_S)
    kv, eng = srv.kv, srv.engine
    minus_two: list[int] = []
    real_wait = eng.wait_many

    def wait_many(base, n, timeout_us=10_000_000):
        st = real_wait(base, n, timeout_us=timeout_us)
        if (st == -2).any():
            minus_two.append(int((st == -2).sum()))
        return st

    eng.wait_many = wait_many  # every client verb's statuses pass here
    nthreads = CLIENT_GROUPS * GROUP_THREADS
    unit = nthreads * VERB
    # 75% of the slots, 5/8 straight through KV.insert, then an eighth
    # through the engine: the fill through the engine runs at 8,000-10,000
    # pages/s, and the whole 75% through it took 156 s
    n_fill = (kv.capacity() // 8) // unit * unit
    n_direct = (3 * kv.capacity() // 4 - n_fill) // INS_B * INS_B
    st = kv.state
    log("serve", f"KVServer on {kv.device}: {kv.capacity()} slots, table "
        f"{tuple(st.index.table.shape)}, pool {tuple(st.pool.pages.shape)} = "
        f"{st.pool.pages.numel() * 4 / 2**30:.2f} GiB, bloom "
        f"{cfg.bloom.num_bits} counters; engine {SERVE_ENGINE} (arena "
        f"{eng.arena.nbytes / 2**20:.0f} MiB); {CLIENT_GROUPS} clients x "
        f"{GROUP_THREADS} threads, {VERB}-page verbs, bloom push every "
        f"{BF_PUSH_S} s")
    t0 = time.monotonic()
    n_warm = srv.warmup()  # on this thread: a kernel failure raises here
    torch.cuda.synchronize()
    log("serve", f"warmup: {n_warm} (kind, width) ops in "
        f"{time.monotonic() - t0:.3f} s, pad floor {srv.pad_floor}")
    # the pre-fill straight through KV.insert; the clients' fill then
    # evicts the oldest entries of full clusters, the pre-fill's
    t0 = time.monotonic()
    for i in range(0, n_direct, INS_B):
        keys = sm.keys_of(SERVE_DIRECT_HI,
                          torch.arange(i, i + INS_B, device=sm.dev))
        kv.insert(keys, sm.pages_of(keys, cfg.page_words))
    torch.cuda.synchronize()
    log("serve", f"pre-fill: {n_direct} pages through KV.insert in "
        f"{INS_B}-page batches in {time.monotonic() - t0:.3f} s")

    fused.launches.clear()
    torch.cuda.synchronize()
    srv.start()
    clients: list[ServeClient] = []
    try:
        clients = [ServeClient(srv, t, n_fill // nthreads, sm.seed)
                   for t in range(nthreads)]
        t_fill = run_threads([c.fill for c in clients], "fill")
        e_fill = eng.stats()
        fill_phases = srv.timers.report()
        fill_totals = srv.timers.totals_s()
        push = srv.push_bloom_now()
        run_threads([c.prepare for c in clients], "mirror check, invalidate")
        e_prep = eng.stats()
        srv.timers.reset()
        t_storm = run_threads([c.storm for c in clients], "storm")
        e_storm = eng.stats()
        storm_phases = srv.timers.report()
        storm_totals = srv.timers.totals_s()
        n_found, n_inrun = clients[0].extents(SERVE_EXTENTS, kv.stats)
        torch.cuda.synchronize()
        launches = fused.launches["fused_get_linear_flat"]
        health = srv.health()
    finally:
        srv.stop()
        for c in clients:
            c.cc.close()
            c.be.close()

    s, e = health["kv"], health["engine"]
    get_flushes = health["op_batches"].get("get", 0)
    n_gets = nthreads * GET_VERBS * VERB
    acked_misses = sum(c.acked_misses for c in clients)
    negatives = sum(c.negatives for c in clients)
    never = sum(c.never for c in clients)
    asked = sum(c.never_asked for c in clients)
    short = 1 - asked / never
    lost = s["evictions"] + s["drops"]
    checks = [
        (health["serve_errors"] == 0, f"serve_errors {health['serve_errors']}"),
        (not minus_two, f"{sum(minus_two)} requests completed with -2"),
        (e["submitted"] == e["completed"], f"engine {e}"),
        (s["misses"] == sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES),
         "misses != sum of miss causes"),
        (acked_misses <= lost, f"{acked_misses} acknowledged keys missed, "
         f"more than evictions + drops {lost}"),
        (negatives <= lost, f"{negatives} mirror negatives among "
         f"acknowledged keys, more than evictions + drops {lost}"),
        (short >= 0.9, f"only {short:.1%} of never-inserted GETs were "
         "short-circuited by the mirror"),
        (get_flushes > 0 and launches >= get_flushes,
         f"{launches} fused-GET launches for {get_flushes} GET flushes"),
        (push["clients"] == nthreads, f"push reached {push}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"serving: {msg}")

    def widths(a, b=None):
        d = {k: a[k] - (b[k] if b else 0) for k in a}
        return (f"{d['batches']} batches ({d['flushes']} flushed partial), "
                f"mean width {d['submitted'] / max(d['batches'], 1):.1f}")

    put_lat = [x for c in clients for x in c.put_lat]
    get_lat = [x for c in clients for x in c.get_lat]
    log("serve", f"fill: {n_fill} pages through the engine by {nthreads} "
        f"threads in {t_fill:.3f} s = {n_fill / t_fill:.0f} pages/s; "
        f"put_pages verb of {VERB} pages: {percentiles_ms(put_lat)}; engine "
        f"{widths(e_fill)} ({smi})")
    log("serve", f"fill driver phases: {fill_phases}; totals {fill_totals} "
        f"of a {t_fill:.3f} s wall ({smi})")
    log("serve", f"storm: {n_gets} GET keys in {t_storm:.3f} s = "
        f"{n_gets / t_storm:.0f} keys/s; get_pages verb of {VERB} keys: "
        f"{percentiles_ms(get_lat)}; engine {widths(e_storm, e_prep)} ({smi})")
    log("serve", f"storm driver phases: {storm_phases}; totals "
        f"{storm_totals} of a {t_storm:.3f} s wall ({smi})")
    log("serve", f"bloom push: {srv.bf_push_stats}; after the fill push: "
        f"{negatives} mirror negatives among {n_fill} acknowledged keys, "
        f"each a server miss; never-inserted GETs short-circuited "
        f"{never - asked} of {never} = {short:.2%} ({smi})")
    log("serve", f"checks passed: {acked_misses} acknowledged keys missed "
        f"<= evictions {s['evictions']} + drops {s['drops']}; hits "
        f"{s['hits']}, misses {s['misses']} (cold {s['miss_cold']}, "
        f"evicted {s['miss_evicted']}); serve_errors 0, no -2 status, "
        f"submitted == completed == {e['submitted']}; extents: "
        f"{SERVE_EXTENTS} through OP_INS_EXT, {n_found} of {n_inrun} in-run "
        f"probes found through OP_GET_EXT, every address exact")
    log("serve", f"fused_get_linear_flat launches {launches} for {get_flushes} "
        f"GET flushes (op batches {health['op_batches']}) ({smi})")

    path = ServePath(sm, kv, clients, t_fill)
    quiet_flushes(sm, srv, path)

    # 3, continued: kernel against plain on the server's full-size state
    present = path.keys(1)[:4096]
    pool = torch.cat([path.keys(1), path.keys(3), path.mixed(1 << 16)])
    covers = sm.keys_of(EXT_HI, torch.tensor(
        [(j + 1) * 4096 for j in range(SERVE_EXTENTS)], device=sm.dev))
    # the capacity evictions fell on the pre-fill's oldest keys: a few of
    # its first batch that miss now ride every batch (the EVICTED cause)
    first = sm.keys_of(SERVE_DIRECT_HI, torch.arange(INS_B, device=sm.dev))
    _, found = kv.get(first)
    sm.kernel_phase(kv, pool, present, covers, "serving full",
                    extra=first[~found][:4])
    return measure(sm, path, launches)


class WireClient:
    """One connection of the wire phase: a pipelined `TcpBackend` (window
    WIRE_WINDOW; `directory=True` for the fast-lane connections) built by
    a `ReconnectingClient`, under a `CleanCacheClient` that the TcpBackend
    feeds with the server's bloom pushes. Its wire keys are (WIRE_HI +
    cid, i); `storm` draws evicted keys from the pre-fill's."""

    def __init__(self, port: int, cid: int, n_fill: int, pw: int,
                 seed: int, directory: bool = False):
        import threading

        import numpy as np

        from pmdfc_tpu_torch.client import CleanCacheClient
        from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        self.np, self.cid, self.n_fill, self.pw = np, cid, n_fill, pw
        self.hi = WIRE_HI + cid
        self.rng = np.random.default_rng([seed, 1000 + cid])
        self.tcp: list = []  # every TcpBackend the factory made
        # the push channel's sink: the CleanCacheClient below, which pulls
        # the filter (and so connects) inside its own constructor; a push
        # that arrives first waits for it
        self._cc_ready = threading.Event()

        def factory():
            # keepalives (the default period) hold a connection that
            # sits out a pass past the server's idle timeout
            be = TcpBackend("127.0.0.1", port, page_words=pw,
                            bloom_sink=self,
                            client_id=(0xC11E << 32) | cid,
                            window=WIRE_WINDOW, op_timeout_s=120.0,
                            directory=directory,
                            dir_max_entries=4 * WIRE_INDEX["capacity"])
            self.tcp.append(be)
            return be

        self.rc = ReconnectingClient(factory, page_words=pw)
        self.never_asked = 0
        real_get = self.rc.get

        def get(keys):
            self.never_asked += int(((keys[:, 0] == self.hi)
                                     & (keys[:, 1] >= NEVER_LO)).sum())
            return real_get(keys)

        self.rc.get = get
        self.cc = CleanCacheClient(self.rc)
        self._cc_ready.set()
        self.put_lat: list[float] = []
        self.get_lat: list[float] = []
        self.inval = np.zeros(0, np.uint32)
        self.acked_misses = self.negatives = self.never = 0

    @property
    def be(self):
        """The live TcpBackend."""
        return self.tcp[-1]

    def receive_bloom_full(self, *args, **kw):
        self._cc_ready.wait(60)
        self.cc.receive_bloom_full(*args, **kw)

    def receive_bloom_blocks(self, *args, **kw):
        self._cc_ready.wait(60)
        self.cc.receive_bloom_blocks(*args, **kw)

    def oids(self, n: int, hi: int | None = None):
        return self.np.full(n, self.hi if hi is None else hi, self.np.uint32)

    def fill(self) -> None:
        """put_pages of [0, n_fill) in VERB-page verbs."""
        np = self.np
        for v in range(self.n_fill // VERB):
            lo = np.arange(v * VERB, (v + 1) * VERB, dtype=np.uint32)
            t0 = time.perf_counter()
            self.cc.put_pages(self.oids(VERB), lo,
                              pages_np(self.hi, lo, self.pw))
            self.put_lat.append(time.perf_counter() - t0)

    def check_mirror(self) -> None:
        """Every acknowledged key the pushed mirror denies must miss at the
        server (asked without the mirror)."""
        from pmdfc_tpu_torch.utils.hashing_np import query_packed_np

        np = self.np
        keys = np.stack([self.oids(self.n_fill),
                         np.arange(self.n_fill, dtype=np.uint32)], -1)
        neg = keys[~query_packed_np(self.cc._bloom, keys, self.cc.num_hashes)]
        for i in range(0, len(neg), VERB):
            if self.rc.get(neg[i:i + VERB])[1].any():
                raise AssertionError(f"connection {self.cid}: a key its "
                                     "mirror denies still hits")
        self.negatives = len(neg)

    def prepare(self, n_inv: int) -> None:
        """The mirror check, then invalidate n_inv of the connection's
        keys over the wire."""
        np = self.np
        self.check_mirror()
        perm = self.rng.permutation(self.n_fill).astype(np.uint32)
        self.inval = np.sort(perm[:n_inv])
        self.cc.invalidate_pages(self.oids(n_inv), self.inval)
        self.present = perm[n_inv:]

    def storm(self, verbs: int, evicted) -> None:
        """`verbs` get_pages verbs: 5/8 present, 1/8 never inserted, 1/8
        invalidated, 1/8 evicted (pre-fill keys the index evicted; never
        inserted ones if it evicted none). Hits
        byte-exact, misses zeroed, never-inserted, invalidated and evicted
        keys miss."""
        np = self.np
        k8 = VERB // 8
        for _ in range(verbs):
            his, los, tags = [], [], []
            for pool, n, tag, hi in (
                    (self.present, VERB - 3 * k8, 0, self.hi),
                    (None, k8, 1, self.hi), (self.inval, k8, 2, self.hi),
                    (evicted if len(evicted) else None, k8, 3, DIRECT_HI)):
                if pool is None:
                    lo = self.rng.integers(NEVER_LO, 1 << 32, n,
                                           dtype=np.uint64).astype(np.uint32)
                else:
                    lo = pool[self.rng.integers(0, len(pool), n)]
                his.append(self.oids(n, hi))
                los.append(lo)
                tags.append(np.full(n, tag, np.int8))
            order = self.rng.permutation(VERB)
            hi, lo, tag = (np.concatenate(x)[order] for x in (his, los, tags))
            t0 = time.perf_counter()
            out, found = self.cc.get_pages(hi, lo)
            self.get_lat.append(time.perf_counter() - t0)
            if found[tag != 0].any():
                raise AssertionError(f"connection {self.cid}: a never-"
                                     "inserted, invalidated or evicted key "
                                     "hit")
            if not np.array_equal(out[found], pages_np(hi[found], lo[found],
                                                       self.pw)):
                raise AssertionError(f"connection {self.cid}: a hit "
                                     "returned wrong bytes")
            if out[~found].any():
                raise AssertionError(f"connection {self.cid}: a miss "
                                     "returned nonzero bytes")
            self.acked_misses += int((~found & (tag == 0)).sum())
            self.never += k8

    def close(self) -> None:
        self.cc.close()
        self.rc.close()


def fast_pass(clients, sets, want: dict, label: str):
    """Each fast connection reads its key set (pre-fill keys) through
    get_pages in VERB-key verbs, in parallel: every hit must equal
    `want[lo]`, the page the key holds now (never an older one); keys in
    `want["gone"]` must miss. -> (wall s, keys, hits, fast lanes asked,
    acknowledged keys missed)."""
    import numpy as np

    res = [None] * len(clients)
    lanes0 = [c.be.directory.counters["fastpath_gets"] for c in clients]

    def run(i):
        c, los = clients[i], sets[i]
        hits = missed = 0
        for j in range(0, len(los), VERB):
            lo = los[j:j + VERB]
            hi = np.full(len(lo), DIRECT_HI, np.uint32)
            out, found = c.cc.get_pages(hi, lo)
            gone = np.isin(lo, want["gone"])
            if found[gone].any():
                raise AssertionError(f"{label}: an invalidated key hit")
            exp = pages_np(hi, lo, c.pw)
            rw = np.isin(lo, want["rewritten"])
            exp[rw] ^= np.uint32(want["xor"])
            bad = found & (out != exp).any(axis=1)
            if bad.any():
                old = pages_np(hi, lo, c.pw)
                raise AssertionError(
                    f"{label}: {int(bad.sum())} hits returned bytes other "
                    f"than the key's current page ({int((bad & rw).sum())} "
                    f"of them rewritten keys, "
                    f"{int((bad & (out == old).all(axis=1)).sum())} equal "
                    f"to the key's first page); client {c.rc.stats()}")
            if out[~found].any():
                raise AssertionError(f"{label}: a miss returned nonzero "
                                     "bytes")
            hits += int(found.sum())
            missed += int((~found & ~gone).sum())
        res[i] = (hits, missed)

    wall = run_threads([lambda i=i: run(i) for i in range(len(clients))],
                       label)
    lanes = sum(c.be.directory.counters["fastpath_gets"] - l0
                for c, l0 in zip(clients, lanes0))
    return (wall, sum(len(x) for x in sets), sum(r[0] for r in res), lanes,
            sum(r[1] for r in res))


def run_wire(sm: Smoke):
    """The wire path (phase 8): linear·flat's configuration behind the
    port's `NetServer` on loopback TCP, WIRE_CLIENTS x WIRE_CONNS
    connections, then the one-sided sub-phase. -> the wire path's kernel
    entry."""
    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.client import DirectBackend
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        NetConfig)
    from pmdfc_tpu_torch.runtime.net import NetServer

    smi = nvidia_smi()
    cfg = KVConfig(index=IndexConfig(**WIRE_INDEX),
                   bloom=BloomConfig(num_bits=WIRE_BLOOM_BITS))
    kv = sm.kv_mod.KV(cfg, device=DEVICE)
    pw = cfg.page_words
    nconn = WIRE_CLIENTS * WIRE_CONNS
    st = kv.state
    log("wire", f"KV on {kv.device}: {kv.capacity()} slots, pool "
        f"{tuple(st.pool.pages.shape)} = {st.pool.pages.numel() * 4 / 2**30:.2f}"
        f" GiB, bloom {cfg.bloom.num_bits} counters; NetServer(NetConfig()) "
        f"on 127.0.0.1, {WIRE_CLIENTS} clients x {WIRE_CONNS} connections, "
        f"window {WIRE_WINDOW}, {VERB}-page verbs, bloom push every "
        f"{BF_PUSH_S} s")

    # pre-fill straight through KV.insert
    t0 = time.monotonic()
    for i in range(0, WIRE_DIRECT, INS_B):
        lo = torch.arange(i, min(i + INS_B, WIRE_DIRECT), device=sm.dev)
        keys = sm.keys_of(DIRECT_HI, lo)
        kv.insert(keys, sm.pages_of(keys, pw))
    torch.cuda.synchronize()
    t_direct = time.monotonic() - t0
    log("wire", f"pre-fill: {WIRE_DIRECT} pages through KV.insert in "
        f"{INS_B}-page batches in {t_direct:.3f} s = "
        f"{WIRE_DIRECT / t_direct:.0f} pages/s")

    shared = DirectBackend(kv)
    phases: list[int] = []  # the padded width of every GET phase served
    real_get = shared.get

    def get(keys):
        phases.append(len(keys))
        return real_get(keys)

    shared.get = get
    srv = NetServer(lambda: shared, net=NetConfig(), bf_push_s=BF_PUSH_S)
    srv.start()
    clients: list[WireClient] = []
    fused.launches.clear()
    torch.cuda.synchronize()
    try:
        clients = [WireClient(srv.port, c, WIRE_FILL // nconn, pw, sm.seed,
                              directory=c < WIRE_FAST_CONNS)
                   for c in range(nconn)]
        t_fill = run_threads([c.fill for c in clients], "wire fill")
        s_fill = dict(srv.stats)
        # which pre-fill keys the table still holds (a scan on the card):
        # the rest were evicted by the fills
        with kv._lock:
            flat, _ = kv._ops.scan(kv.state.index)
            held = flat[flat[:, 0] == sm.u32.narrow(torch.tensor(DIRECT_HI))]
            direct_present = np.sort(sm.u32.to_numpy(held[:, 1]))
        evicted = np.setdiff1d(np.arange(WIRE_DIRECT, dtype=np.uint32),
                               direct_present)
        log("wire", f"after the fills: {len(direct_present)} pre-fill keys "
            f"held, {len(evicted)} evicted")
        # every mirror must have taken a push (the push channel works);
        # between pushes each client's put overlay keeps it free of false
        # negatives
        srv.push_bloom_now()
        deadline = time.monotonic() + 60
        while any(c.cc.counters["bf_pushes"] < 1 or c.cc._bloom is None
                  for c in clients):
            if time.monotonic() > deadline:
                raise AssertionError("wire: a client never received the "
                                     "bloom push")
            time.sleep(0.01)
        verbs = max(1, WIRE_GETS // (nconn * VERB))
        run_threads([lambda c=c: c.prepare(verbs * VERB // 8)
                     for c in clients], "wire mirror check, invalidate")
        s0 = dict(srv.stats)
        t_storm = run_threads([lambda c=c: c.storm(verbs, evicted)
                               for c in clients], "wire storm")
        s_storm = dict(srv.stats)
        n_found, n_inrun = extent_roundtrip(clients[-1].rc, WIRE_EXTENTS,
                                            kv.stats)

        # the fast lane: the directory connections pull the directory and
        # read pre-fill keys; the driver rewrites and invalidates some of
        # them over the wire between passes
        fast = clients[:WIRE_FAST_CONNS]
        t0 = time.monotonic()
        if not all(c.rc.dir_refresh() for c in fast):
            raise AssertionError("wire: a directory pull failed")
        t_pull = time.monotonic() - t0
        n_dir = len(fast[0].be.directory)
        perm = np.random.default_rng(sm.seed).permutation(direct_present)
        k = min(WIRE_FAST_KEYS, len(perm) // WIRE_FAST_CONNS)
        sets = [np.sort(perm[i * k:(i + 1) * k])
                for i in range(WIRE_FAST_CONNS)]
        want = {"gone": np.zeros(0, np.uint32),
                "rewritten": np.zeros(0, np.uint32), "xor": 0x5A5A5A5A}
        fp0 = (int(srv.stats["fastpath_hits"]), int(srv.stats["fastpath_stale"]))
        p1 = fast_pass(fast, sets, want, "fast read 1")
        r = WIRE_REWRITE // WIRE_FAST_CONNS
        rw = np.sort(np.concatenate([x[:r] for x in sets]))
        gone = np.sort(np.concatenate([x[r:2 * r] for x in sets]))
        driver = clients[WIRE_FAST_CONNS]
        for j in range(0, len(rw), VERB):
            lo = rw[j:j + VERB]
            hi = np.full(len(lo), DIRECT_HI, np.uint32)
            driver.cc.put_pages(hi, lo, pages_np(hi, lo, pw)
                                ^ np.uint32(want["xor"]))
        # a put the ReconnectingClient dropped is legal, but then the
        # rewrite did not happen and the passes below test nothing
        rs = driver.rc.stats()
        if rs["dropped_puts"] or rs["disconnects"]:
            raise AssertionError(f"wire: the driver's rewrites were not all "
                                 f"applied: {rs}")
        want["rewritten"] = rw
        p2 = fast_pass(fast, sets, want, "fast read 2 (after rewrites)")
        driver.cc.invalidate_pages(np.full(len(gone), DIRECT_HI, np.uint32),
                                   gone)
        want["gone"] = gone
        p3 = fast_pass(fast, sets, want, "fast read 3 (after invalidates)")
        fp = (int(srv.stats["fastpath_hits"]) - fp0[0],
              int(srv.stats["fastpath_stale"]) - fp0[1])

        # a recovering window: one storm batch of never-inserted keys asked
        # past the mirror; its cold misses count as miss_recovering
        s_rec0 = kv.stats()
        kv.begin_recovering()
        lo = np.random.default_rng(sm.seed).integers(
            NEVER_LO, 1 << 32, VERB, dtype=np.uint64).astype(np.uint32)
        rec_found = driver.be.get(np.stack([driver.oids(VERB), lo], -1))[1]
        info = driver.be.recovery_info()
        was = driver.be.mark_recovered()
        s_rec1 = kv.stats()
        torch.cuda.synchronize()
        launches = fused.launches["fused_get_linear_flat"]
        n_phases = len(phases)
        health = dict(srv.stats)
        disconnects = sum(c.rc.stats()["disconnects"] for c in clients)
    finally:
        srv.stop()
        for c in clients:
            c.close()

    s = kv.stats()
    d_rec = {c: s_rec1[c] - s_rec0[c] for c in sm.kv_mod.MISS_CAUSE_NAMES}
    never = sum(c.never for c in clients)
    asked = sum(c.never_asked for c in clients)
    short = 1 - asked / never
    lost = s["evictions"] + s["drops"]
    acked = (sum(c.acked_misses for c in clients) + p1[4] + p2[4] + p3[4])
    negatives = sum(c.negatives for c in clients)
    lanes = p1[3] + p2[3] + p3[3]
    checks = [
        (int(health["serve_errors"]) == 0,
         f"serve_errors {health['serve_errors']}"),
        # a failing phase is bisected and its ops answered MSG_NACK (a
        # legal miss): none may have happened
        (all(int(health[k]) == 0 for k in ("nacks_sent", "bisect_failures",
                                           "poison_ops", "deadline_shed")),
         "a phase failed: " + str({k: health[k] for k in (
             "nacks_sent", "bisect_failures", "poison_ops",
             "deadline_shed")})),
        (disconnects == 0, f"{disconnects} client disconnects"),
        (s["misses"] == sum(s[c] for c in sm.kv_mod.MISS_CAUSE_NAMES),
         "misses != sum of miss causes"),
        (acked <= lost, f"{acked} acknowledged keys missed, more than "
         f"evictions + drops {lost}"),
        (negatives <= lost, f"{negatives} mirror negatives among "
         f"acknowledged keys, more than evictions + drops {lost}"),
        (short >= 0.9, f"only {short:.1%} of never-inserted GETs were "
         "short-circuited by the mirrors"),
        (fp[0] + fp[1] == lanes, f"fastpath_hits {fp[0]} + fastpath_stale "
         f"{fp[1]} != {lanes} fast lanes read"),
        (p1[2] > 0 and p2[3] > 0, "the fast lane served nothing"),
        (info.get("recovering") is True and was,
         f"recovering window not seen over the wire ({info}, {was})"),
        # a never-inserted key the evicted-key sketch flags is
        # miss_evicted; every other one would be miss_cold
        (not rec_found.any() and d_rec["miss_cold"] == 0
         and d_rec["miss_recovering"] > 0
         and d_rec["miss_recovering"] + d_rec["miss_evicted"] == VERB,
         f"recovering batch: causes {d_rec}"),
        (n_phases > 0 and launches == n_phases,
         f"{launches} fused-GET launches for {n_phases} GET phases"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"wire: {msg}")

    def flushes(a, b):
        f = int(b["flushes"]) - int(a["flushes"])
        ops = int(b["coalesced_ops"]) - int(a["coalesced_ops"])
        return f"{f} flushes, mean {ops / max(f, 1):.1f} verbs per flush"

    put_lat = [x for c in clients for x in c.put_lat]
    get_lat = [x for c in clients for x in c.get_lat]
    n_gets = nconn * verbs * VERB
    log("wire", f"fill: {WIRE_FILL} pages over the wire by {nconn} "
        f"connections in {t_fill:.3f} s = {WIRE_FILL / t_fill:.0f} pages/s; "
        f"put_pages verb of {VERB} pages: {percentiles_ms(put_lat)}; "
        f"{flushes({'flushes': 0, 'coalesced_ops': 0}, s_fill)} ({smi})")
    log("wire", f"storm: {n_gets} GET keys in {t_storm:.3f} s = "
        f"{n_gets / t_storm:.0f} keys/s; get_pages verb of {VERB} keys: "
        f"{percentiles_ms(get_lat)}; {flushes(s0, s_storm)} ({smi})")
    log("wire", f"GET phases {n_phases}, padded widths "
        f"{min(phases)}..{max(phases)}, mean {sum(phases) / n_phases:.0f}; "
        f"fused_get_linear_flat launches {launches} ({smi})")
    log("wire", f"fast lane: directory pull by {WIRE_FAST_CONNS} "
        f"connections in {t_pull:.3f} s ({n_dir} entries each); read 1: "
        f"{p1[1]} keys in {p1[0]:.3f} s = {p1[1] / p1[0]:.0f} keys/s, "
        f"{p1[2]} hits; read 2 after {len(rw)} rewrites: {p2[1] / p2[0]:.0f}"
        f" keys/s; read 3 after {len(gone)} invalidates: "
        f"{p3[1] / p3[0]:.0f} keys/s; server fastpath_hits {fp[0]}, "
        f"fastpath_stale {fp[1]} of {lanes} fast lanes ({smi})")
    log("wire", f"checks passed: {acked} acknowledged keys missed <= "
        f"evictions {s['evictions']} + drops {s['drops']}; hits {s['hits']},"
        f" misses {s['misses']} == sum of causes; {negatives} mirror "
        f"negatives; never-inserted GETs short-circuited {never - asked} of "
        f"{never} = {short:.2%}; no serve error, NACK or disconnect; "
        f"recovering batch of {VERB}: {d_rec['miss_recovering']} "
        f"miss_recovering, "
        f"{d_rec['miss_evicted']} miss_evicted (sketch), 0 miss_cold; "
        f"extents: {WIRE_EXTENTS} over the wire, {n_found} of {n_inrun} "
        f"in-run probes found, every address exact; fast reads served no "
        f"old byte")

    # directory and fast-view costs at the phase's end state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = kv.directory_snapshot(max_entries=4 * WIRE_INDEX["capacity"])
    t_snap = (time.perf_counter() - t0) * 1e3
    kv.bump_dir_epoch()
    t0 = time.perf_counter()
    fv = kv.fast_view()
    t_fv = (time.perf_counter() - t0) * 1e3
    m = min(VERB, len(snap["rows"]))
    t0 = time.perf_counter()
    ok, hit, _ = fv.read(fv.epoch, snap["shards"][:m], snap["rows"][:m],
                         snap["digs"][:m])
    t_read = (time.perf_counter() - t0) * 1e3
    from pmdfc_tpu_torch.ops.pagepool import page_digest_np

    if not ok.all() or not np.array_equal(page_digest_np(hit),
                                          snap["digs"][:m]):
        raise AssertionError("wire: FastView.read of a fresh directory "
                             "refused a lane or served other bytes")
    log("wire", f"directory_snapshot: {len(snap['keys'])} entries in "
        f"{t_snap:.3f} ms; fast_view() after a mutation {t_fv:.4f} ms; "
        f"FastView.read of {m} lanes {t_read:.3f} ms ({smi})")

    # kernel against plain at the smallest and largest widths the phase
    # launched, and the kernel's times at the largest
    present = torch.from_numpy(direct_present.astype(np.int64)).to(sm.dev)

    def batch(w):
        n_never = w // 8
        keys = torch.cat([
            sm.keys_of(DIRECT_HI, sm.pick(present, w - 2 * n_never)),
            sm.keys_of(DIRECT_HI, torch.randint(
                NEVER_LO, 1 << 32, (n_never,), device=sm.dev,
                generator=sm.gen)),
            sm.keys_of(DIRECT_HI, torch.from_numpy(evicted[:n_never].astype(
                np.int64)).to(sm.dev)) if len(evicted) >= n_never else
            torch.full((n_never, 2), -1, dtype=torch.int32, device=sm.dev)])
        return keys[torch.randperm(w, device=sm.dev, generator=sm.gen)]

    wmax = max(phases)
    for w in sorted({min(phases), wmax}):
        causes, _ = sm.compare(batch(w), kv.state, f"wire w={w}")
        log("kernel", f"wire full w={w}: kernel == plain, causes "
            f"{CAUSE_NAMES}={causes}")
    args, kw = sm.kernel_args(kv.state)
    batches = [batch(wmax) for _ in range(4)]
    s_ = kv.state.index.table.shape[1] // 4
    nbytes = [fused.fused_get_bytes(
        sm.compare(k, kv.state, "wire timed")[0], wmax, s_, pw,
        kv.state.evicted_filter.numel()) for k in batches]
    ms = time_ms(torch, [lambda k=k: fused.fused_get(k, *args, **kw)
                         for k in batches], 24, device_only=True)
    plain_ms = time_ms(torch, [lambda k=k: fused.get_core_reference(
        k, *args, **kw) for k in batches], 4, device_only=True)
    bound_ms = sum(nbytes) / len(nbytes) / HBM_BYTES_PER_S * 1e3
    log("times", f"fused_get_linear_flat w={wmax} (the wire's widest GET "
        f"phase), rotated over {len(batches)} batches: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
        f"{bound_ms / ms:.1%} of the memory rate ({smi})")
    entry = {
        "name": "fused_get_linear_flat",
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err["fused_get_linear_flat"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "path": "wire",
    }
    del kv, shared, srv, st, snap, fv
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    run_onesided(sm)
    return entry


def run_onesided(sm: Smoke) -> None:
    """The one-sided sub-phase: a PassivePool of POOL_ROWS rows on the card
    behind `PoolServer`; POOL_CLIENTS `OneSidedBackend`s, each over its own
    `RemotePool` and grant, write POOL_PAGES pages in VERB-page verbs in
    parallel and read them back byte-exact."""
    np, torch = sm.np, sm.torch
    from pmdfc_tpu_torch.onesided import OneSidedBackend, PassivePool
    from pmdfc_tpu_torch.runtime.net import PoolServer, RemotePool

    smi = nvidia_smi()
    pool = PassivePool(num_rows=POOL_ROWS, device=DEVICE)
    pw = pool.page_words
    log("onesided", f"PassivePool on {pool.device}: {POOL_ROWS} rows = "
        f"{POOL_ROWS * pw * 4 / 2**30:.2f} GiB behind PoolServer; "
        f"{POOL_CLIENTS} OneSidedBackends over RemotePool, {POOL_PAGES} "
        f"pages each in {VERB}-page verbs")
    with PoolServer(pool).start() as srv:
        remotes = [RemotePool("127.0.0.1", srv.port, page_words=pw,
                              keepalive_s=None, op_timeout_s=120.0)
                   for _ in range(POOL_CLIENTS)]
        bes = [OneSidedBackend(r, grant=r.grant(POOL_PAGES))
               for r in remotes]
        keys = [np.stack([np.full(POOL_PAGES, i, np.uint32),
                          np.arange(POOL_PAGES, dtype=np.uint32)], -1)
                for i in range(POOL_CLIENTS)]

        def write(i):
            for j in range(0, POOL_PAGES, VERB):
                k = keys[i][j:j + VERB]
                bes[i].put(k, pages_np(k[:, 0], k[:, 1], pw))

        def read(i):
            for j in range(0, POOL_PAGES, VERB):
                k = keys[i][j:j + VERB]
                out, found = bes[i].get(k)
                if not found.all() or not np.array_equal(
                        out, pages_np(k[:, 0], k[:, 1], pw)):
                    raise AssertionError(f"one-sided client {i}: a row read "
                                         "back wrong bytes")

        n = POOL_CLIENTS * POOL_PAGES
        t_w = run_threads([lambda i=i: write(i)
                           for i in range(POOL_CLIENTS)], "one-sided write")
        t_r = run_threads([lambda i=i: read(i)
                           for i in range(POOL_CLIENTS)], "one-sided read")
        for r in remotes:
            r.close()
        ps = pool.stats()
    if ps["writes"] != n or ps["reads"] != n:
        raise AssertionError(f"one-sided: pool counted {ps}")
    log("onesided", f"write {n} rows in {t_w:.3f} s = {n / t_w:.0f} rows/s; "
        f"read back byte-exact in {t_r:.3f} s = {n / t_r:.0f} rows/s; pool "
        f"{ps} ({smi})")
    del pool
    torch.cuda.empty_cache()


def fleet_dir():
    """Where the fleet's snapshots and journals go: `build/fleet` under the
    checkout (git-ignored, on the checkout's disk)."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "fleet"


def disk_of(path) -> tuple[str, int]:
    """(filesystem type, free bytes) of the mount holding `path`."""
    import os

    path = os.path.realpath(path)
    fs, best = "unknown", ""
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, kind = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                fs, best = kind, mnt
    st = os.statvfs(path)
    return fs, st.f_bavail * st.f_frsize


class RssPeak:
    """Peak resident set of this process while the block runs, sampled
    every 5 ms from /proc/self/statm (`ru_maxrss` is the whole life's)."""

    def __enter__(self):
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self._rss()
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()
        self.peak = max(self.peak, self._rss())


class Fleet:
    """The fleet phase's cluster: FLEET_NODES crashbox children, each a
    journal-attached `KV` behind `NetServer(NetConfig())` on loopback, and
    one `ReplicaGroup` over a `ReconnectingClient(TcpBackend)` per node
    whose factory follows the node's current port.

    Key index i is the key (FLEET_HI, i); `status[i]`: 0 never put, 1
    acknowledged, 2 invalidated; `stage[i]`: which put stage wrote it (1
    fill, 2 before the delta, 3 the journal tail, 4 while the node was
    down)."""

    def __init__(self, sm: Smoke, cfg, root):
        from pmdfc_tpu_torch.config import JournalConfig
        from pmdfc_tpu_torch.models.base import get_index_ops

        np = sm.np
        self.sm, self.np, self.cfg, self.root = sm, np, cfg, root
        self.pw = cfg.page_words
        self.n_slots = get_index_ops(cfg.index.kind).num_slots(cfg.index)
        self.jcfg = JournalConfig(**FLEET_JOURNAL)
        self.n_keys = (FLEET_FILL + FLEET_DELTA + FLEET_TAIL
                       + FLEET_DOWN_PUT)
        self.status = np.zeros(self.n_keys, np.int8)
        self.stage = np.zeros(self.n_keys, np.int8)
        self.next_key = 0
        self.rng = np.random.default_rng([sm.seed, 9])
        self.boxes: list = [None] * FLEET_NODES
        self.ports = [0] * FLEET_NODES
        self.hello: list = [None] * FLEET_NODES
        self.past: list = [[] for _ in range(FLEET_NODES)]  # dead nodes'
        self.group = None
        self.eps: list = []
        self.lat: dict[str, list[float]] = {}

    # -- nodes --------------------------------------------------------------
    def wal(self, i: int) -> str:
        return str(self.root / f"wal{i}")

    def start_node(self, i: int, chain=()) -> float:
        """Spawn node i (a warm restart from `chain` if given) -> seconds
        from spawn to serving."""
        from pmdfc_tpu_torch.tools.crashbox import Crashbox

        box = Crashbox(self.cfg, self.wal(i), self.jcfg, chain_paths=chain,
                       start_timeout_s=FLEET_START_S, device=DEVICE)
        t0 = time.monotonic()
        self.hello[i] = box.start()
        dt = time.monotonic() - t0
        if not self.hello[i]["device"].startswith(DEVICE):
            raise AssertionError(f"fleet: node {i} serves on "
                                 f"{self.hello[i]['device']}, not {DEVICE}")
        self.boxes[i], self.ports[i] = box, box.port
        return dt

    def start(self) -> float:
        """All nodes in parallel, then the group -> seconds."""
        from pmdfc_tpu_torch.client.replica import ReplicaGroup
        from pmdfc_tpu_torch.config import ReplicaConfig
        from pmdfc_tpu_torch.runtime.failure import ReconnectingClient
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        t = run_threads([lambda i=i: self.start_node(i)
                         for i in range(FLEET_NODES)], "fleet start")

        def factory(i):
            # keepalives (the default period) hold a connection idle
            # through a snapshot past the server's idle timeout
            return lambda: TcpBackend("127.0.0.1", self.ports[i],
                                      page_words=self.pw, op_timeout_s=120.0)

        self.eps = [ReconnectingClient(factory(i), page_words=self.pw,
                                       seed=self.sm.seed * 31 + i)
                    for i in range(FLEET_NODES)]
        # connect each endpoint before the threads share it: a client
        # still connecting drops the ops that arrive meanwhile (legal, but
        # then a put reaches fewer replicas than the group counted)
        for i, ep in enumerate(self.eps):
            ep.recovery_info()
            if not ep.connected:
                raise AssertionError(f"fleet: node {i} refused the client")
        self.group = ReplicaGroup(
            self.eps, page_words=self.pw,
            cfg=ReplicaConfig(n_replicas=FLEET_NODES, repair_interval_s=0),
            seed=self.sm.seed)
        return t

    def close(self) -> None:
        if self.group is not None:
            self.group.close()
        for box in self.boxes:
            if box is not None and box.alive():
                box.kill()

    # -- keys ---------------------------------------------------------------
    def keys(self, idx):
        np = self.np
        idx = np.asarray(idx, np.uint32)
        return np.stack([np.full(len(idx), FLEET_HI, np.uint32), idx], -1)

    def pages(self, idx):
        return pages_np(FLEET_HI, idx, self.pw)

    def owned(self, i: int):
        """Bool mask over every key index: the ring gives it to node i."""
        own = self.group.ring.owners_np(
            self.keys(self.np.arange(self.n_keys)), self.group.cfg.rf)
        return (own == i).any(axis=1)

    # -- traffic through the group -------------------------------------------
    def _verbs(self, idx):
        return [idx[j:j + VERB] for j in range(0, len(idx), VERB)]

    def put(self, n: int, stage: int, label: str) -> float:
        """Put the next n keys in VERB-key verbs over FLEET_THREADS threads
        -> wall seconds."""
        np = self.np
        idx = np.arange(self.next_key, self.next_key + n, dtype=np.uint32)
        self.next_key += n
        verbs = self._verbs(idx)
        lat = self.lat.setdefault(label, [])

        def worker(t):
            for v in verbs[t::FLEET_THREADS]:
                t0 = time.perf_counter()
                self.group.put(self.keys(v), self.pages(v))
                lat.append(time.perf_counter() - t0)

        wall = run_threads([lambda t=t: worker(t)
                            for t in range(min(FLEET_THREADS, len(verbs)))],
                           f"fleet {label}")
        self.status[idx] = 1
        self.stage[idx] = stage
        return wall

    def no_drops(self, nodes, label: str) -> None:
        """No client of a live node dropped a put or an invalidate."""
        for i in nodes:
            st = self.eps[i].stats()
            if st["dropped_puts"] or st.get("failed_invalidates", 0):
                raise AssertionError(
                    f"fleet {label}: node {i}'s client dropped "
                    f"{st['dropped_puts']} puts, "
                    f"{st.get('failed_invalidates', 0)} invalidates")

    def invalidate(self, n: int, among) -> "object":
        """Invalidate n acknowledged keys drawn from the index mask `among`
        -> their indices."""
        np = self.np
        pool = np.flatnonzero(among & (self.status == 1))
        idx = np.sort(self.rng.choice(pool, n, replace=False)).astype(
            np.uint32)
        for v in self._verbs(idx):
            self.group.invalidate(self.keys(v))
        self.status[idx] = 2
        return idx

    def storm(self, n: int, label: str) -> float:
        """n GET keys through the group over FLEET_THREADS threads, each
        VERB-key verb 3/4 acknowledged, 1/8 invalidated and 1/8 never-put
        keys: every acknowledged key hits byte-exact (failover serves a
        dead node's share), every other key misses with a zeroed page.
        -> wall seconds."""
        np = self.np
        present = np.flatnonzero(self.status == 1)
        gone = np.flatnonzero(self.status == 2)
        k8 = VERB // 8
        verbs = []
        for _ in range(max(1, n // VERB)):
            lo = np.concatenate([
                self.rng.choice(present, VERB - 2 * k8),
                self.rng.choice(gone, k8),
                self.rng.integers(NEVER_LO, 1 << 32, k8,
                                  dtype=np.uint64)]).astype(np.uint32)
            verbs.append(self.rng.permutation(lo))
        lat = self.lat.setdefault(label, [])
        bad: list[str] = []

        def worker(t):
            for lo in verbs[t::FLEET_THREADS]:
                t0 = time.perf_counter()
                out, found = self.group.get(self.keys(lo))
                lat.append(time.perf_counter() - t0)
                want = np.zeros(len(lo), bool)
                inside = lo < self.n_keys
                want[inside] = self.status[lo[inside]] == 1
                if not np.array_equal(found, want):
                    bad.append(f"{int((found & ~want).sum())} keys hit that "
                               f"must miss, {int((want & ~found).sum())} "
                               "acknowledged keys missed: "
                               + self.explain(lo[found != want]))
                elif not np.array_equal(out[found], self.pages(lo[found])):
                    bad.append("a hit returned wrong bytes")
                elif out[~found].any():
                    bad.append("a miss returned nonzero bytes")

        wall = run_threads([lambda t=t: worker(t)
                            for t in range(min(FLEET_THREADS, len(verbs)))],
                           f"fleet {label}")
        if bad:
            raise AssertionError(f"fleet {label}: {bad[0]}")
        return wall

    def explain(self, idx) -> str:
        """Where up to 4 keys live: their status, stage and owners, and
        which live owner holds them."""
        idx = idx[:4]
        own = self.group.ring.owners_np(self.keys(idx), self.group.cfg.rf)
        held = {i: self.node_get(i, idx)[1] for i in range(FLEET_NODES)
                if self.boxes[i] is not None and self.boxes[i].alive()}
        return "; ".join(
            f"key {k}: status {self.status[k]}, stage {self.stage[k]}, "
            f"owners {own[j].tolist()}, held by "
            f"{[i for i, f in held.items() if f[j]]}"
            for j, k in enumerate(idx.tolist()))

    # -- one node, directly ---------------------------------------------------
    def node_get(self, i: int, idx):
        """GET key indices from node i over its own TcpBackend -> (pages,
        found); every hit byte-exact."""
        from pmdfc_tpu_torch.runtime.net import TcpBackend

        np = self.np
        out = np.zeros((len(idx), self.pw), np.uint32)
        found = np.zeros(len(idx), bool)
        with TcpBackend("127.0.0.1", self.ports[i], page_words=self.pw,
                        op_timeout_s=120.0) as be:
            for j in range(0, len(idx), VERB):
                o, f = be.get(self.keys(idx[j:j + VERB]))
                out[j:j + VERB], found[j:j + VERB] = o, f
        if not np.array_equal(out[found], self.pages(idx[found])):
            raise AssertionError(f"fleet: node {i} served wrong bytes")
        return out, found

    def serving(self, i: int) -> dict:
        """Node i's serving counters; holds its checks: no serve error, no
        contained phase failure, one fused-GET launch per GET phase (the
        plain version runs on the CPU: none there)."""
        sv = self.boxes[i].serving()
        srv = sv["server"]
        if int(srv["serve_errors"]):
            raise AssertionError(f"fleet: node {i} serve_errors "
                                 f"{srv['serve_errors']}")
        contained = {k: srv[k] for k in ("nacks_sent", "bisect_failures",
                                         "poison_ops", "deadline_shed")}
        if any(int(v) for v in contained.values()):
            raise AssertionError(f"fleet: node {i}: a phase failed: "
                                 f"{contained}")
        launches = int(sv["launches"].get("fused_get_linear_flat", 0))
        want = len(sv["get_phases"]) if DEVICE != "cpu" else 0
        if launches != want or not sv["get_phases"]:
            raise AssertionError(
                f"fleet: node {i}: {launches} fused-GET launches for "
                f"{len(sv['get_phases'])} GET phases")
        return sv


def fleet_check_restart(fleet: Fleet, i: int, killed_stage: int,
                        gone_before) -> tuple[int, int]:
    """Node i right after its warm restart, before the group reaches it:
    every key the ring gives it that was acknowledged before the kill and
    not invalidated hits byte-exact, losses within the journal's RPO bound
    (`(rpo_ops + 1) x VERB`); keys invalidated before the kill miss; it is
    `recovering` and the misses of keys put while it was down count as
    `miss_recovering`, with `misses == Σ miss_*`. -> (lost, asked)."""
    np, sm = fleet.np, fleet.sm
    own = fleet.owned(i)
    before = np.flatnonzero(own & (fleet.status == 1)
                            & (fleet.stage <= killed_stage)
                            & (fleet.stage > 0))
    _, found = fleet.node_get(i, before)
    lost = int((~found).sum())
    bound = (fleet.jcfg.rpo_ops + 1) * VERB
    if lost > bound:
        raise AssertionError(f"fleet: node {i} lost {lost} acknowledged keys "
                             f"in the crash, more than the RPO bound {bound}")
    inv = gone_before[own[gone_before]]
    if fleet.node_get(i, inv)[1].any():
        raise AssertionError(f"fleet: node {i} serves a key invalidated "
                             "before the kill")
    info = fleet.boxes[i].recovery_info()
    if info.get("recovering") is not True:
        raise AssertionError(f"fleet: node {i} is not recovering: {info}")
    down = np.flatnonzero(own & (fleet.stage == killed_stage + 1))
    s0 = fleet.boxes[i].stats()
    got = fleet.node_get(i, down)[1]
    s1 = fleet.boxes[i].stats()
    d = {k: s1[k] - s0[k] for k in sm.kv_mod.STAT_NAMES}
    if got.any() or d["miss_recovering"] != len(down) or d["miss_cold"]:
        raise AssertionError(f"fleet: node {i}: keys put while it was down: "
                             f"{int(got.sum())} hit, causes {d}")
    if s1["misses"] != sum(s1[c] for c in sm.kv_mod.MISS_CAUSE_NAMES):
        raise AssertionError(f"fleet: node {i}: misses != sum of causes")
    return lost, len(before)


def fleet_check_rejoined(fleet: Fleet, i: int, gone, fp_keys) -> int:
    """Node i after the rejoin: every key the ring gives it, acknowledged
    and not invalidated, hits byte-exact (those put while it was down
    came by repair; a key its bloom claimed falsely, `fp_keys`, is the
    one legal miss), and no invalidated key is served by it or by the
    group. -> keys checked."""
    np = fleet.np
    own = fleet.owned(i)
    live = np.flatnonzero(own & (fleet.status == 1))
    _, found = fleet.node_get(i, live)
    missed = live[~found]
    if len(np.setdiff1d(missed, fp_keys)):
        raise AssertionError(
            f"fleet: node {i} misses {len(missed)} acknowledged keys after "
            f"the rejoin ({len(np.setdiff1d(missed, fp_keys))} not bloom "
            "false positives)")
    if fleet.node_get(i, gone[own[gone]])[1].any():
        raise AssertionError(f"fleet: node {i} served an invalidated key "
                             "after the rejoin")
    for v in fleet._verbs(gone):
        if fleet.group.get(fleet.keys(v))[1].any():
            raise AssertionError("fleet: the group served an invalidated "
                                 "key after the rejoin")
    return len(live)


def run_fleet(sm: Smoke):
    """The fleet phase (9): three crashbox nodes at linear·flat's serving
    configuration (8 GiB pools, all three on the one card) behind a
    `ReplicaGroup`; node FLEET_CRASH is snapshotted (a full, a delta),
    killed with SIGKILL, warm restarted from its chain and journal, and
    rejoined; its final chain is restored in this process. -> the fleet's
    kernel entry."""
    import shutil

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig

    cfg = KVConfig(index=IndexConfig(**FLEET_INDEX),
                   bloom=BloomConfig(num_bits=FLEET_BLOOM_BITS))
    root = fleet_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    fs, free = disk_of(root)
    log("env", f"fleet directory {root}: filesystem {fs}, {free} bytes free")
    if fs == "tmpfs" or free < FLEET_DISK_BYTES:
        raise AssertionError(f"fleet: {root} is {fs} with {free} bytes free; "
                             f"the phase needs a disk with {FLEET_DISK_BYTES}")
    try:
        return fleet_run(sm, cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def fleet_run(sm: Smoke, cfg, root):
    """`run_fleet`'s steps, in the fleet directory `root`."""
    import os
    import resource

    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch import checkpoint
    from pmdfc_tpu_torch.utils.hashing_np import query_packed_np

    smi = nvidia_smi()
    c = FLEET_CRASH
    fleet = Fleet(sm, cfg, root)
    full, d1, d2 = (str(root / f) for f in ("full.npz", "d1.npz", "d2.npz"))
    try:
        t_start = fleet.start()
        g = fleet.group
        log("fleet", f"{FLEET_NODES} nodes on {DEVICE} started in "
            f"{t_start:.3f} s: each KV(IndexConfig(**{FLEET_INDEX}), "
            f"BloomConfig(num_bits={FLEET_BLOOM_BITS})), a pool of "
            f"{fleet.n_slots} pages = {fleet.n_slots * fleet.pw * 4 / 2**30:.2f}"
            f" GiB, {fleet.jcfg}, NetServer(NetConfig()); ReplicaGroup "
            f"rf {g.cfg.rf}, hedge_ms {g.cfg.hedge_ms}, ring on, repair by "
            f"manual ticks; {FLEET_THREADS} client threads, {VERB}-key verbs")

        # 3. fill and chain
        t = fleet.put(FLEET_FILL, 1, "fill")
        log("fleet", f"fill: {FLEET_FILL} keys through the group in {t:.3f} s"
            f" = {FLEET_FILL / t:.0f} keys/s ({g.cfg.rf * FLEET_FILL / t:.0f} "
            f"pages/s written); put verb {percentiles_ms(fleet.lat['fill'])}"
            f" ({smi})")
        snaps = {}
        for name, path, delta, n, stage in (("full", full, False, FLEET_DELTA,
                                             2),
                                            ("delta", d1, True, FLEET_TAIL, 3)):
            r = fleet.boxes[c].snapshot(path, delta=delta)
            if r["kind"] != name:
                raise AssertionError(f"fleet: the {name} snapshot came out "
                                     f"a {r['kind']}")
            size = os.path.getsize(path)
            snaps[name] = r
            log("fleet", f"node {c} {name} snapshot: {size} bytes in "
                f"{r['seconds']:.3f} s = {size / r['seconds'] / 1e9:.3f} GB/s"
                f", dirty rows {r['dirty_rows']} of {r['total_rows']}, seq "
                f"{r['seq']}; the child's peak RSS {r['peak_rss_bytes']} "
                f"bytes ({smi})")
            t = fleet.put(n, stage, f"put {name}")
        gone_before = fleet.invalidate(FLEET_INVAL,
                                       fleet.stage == 1)
        t = fleet.storm(FLEET_STORM, "storm")
        log("fleet", f"after {FLEET_DELTA} + {FLEET_TAIL} more puts and "
            f"{FLEET_INVAL} invalidates: storm of {FLEET_STORM} GET keys in "
            f"{t:.3f} s = {FLEET_STORM / t:.0f} keys/s; get verb "
            f"{percentiles_ms(fleet.lat['storm'])}; every hit byte-exact "
            f"({smi})")

        # 4. crash, with traffic paused between acknowledged verbs
        sv = [fleet.serving(i) for i in range(FLEET_NODES)]
        fleet.no_drops(range(FLEET_NODES), "before the kill")
        time.sleep(max(0.2, 2 * fleet.jcfg.rpo_ms / 1e3))
        fleet.past[c].append(sv[c])
        fleet.boxes[c].kill()
        if fleet.boxes[c].alive():
            raise AssertionError(f"fleet: node {c} survived SIGKILL")
        t = fleet.put(FLEET_DOWN_PUT, 4, "put down")
        gone_during = fleet.invalidate(FLEET_DOWN_INVAL, fleet.stage <= 3)
        t_storm = fleet.storm(FLEET_STORM, "storm down")
        fleet.no_drops([i for i in range(FLEET_NODES) if i != c],
                       "while a node is down")
        # open, or half-open once its cooldown has run out (reading
        # `state` moves it there): never closed while the node is down
        br = g.breakers[c]
        if br.stats["opens"] < 1 or br.state == "closed":
            raise AssertionError(f"fleet: node {c}'s breaker never opened "
                                 f"while it was down ({br.state}, "
                                 f"{dict(br.stats)})")
        log("fleet", f"node {c} killed (SIGKILL); while down: "
            f"{FLEET_DOWN_PUT} puts in {t:.3f} s = {FLEET_DOWN_PUT / t:.0f} "
            f"keys/s, put verb {percentiles_ms(fleet.lat['put down'])}; "
            f"{FLEET_DOWN_INVAL} invalidates; storm of {FLEET_STORM} keys in "
            f"{t_storm:.3f} s = {FLEET_STORM / t_storm:.0f} keys/s, get verb "
            f"{percentiles_ms(fleet.lat['storm down'])}; every acknowledged "
            f"key served byte-exact by failover; breaker {c} opened "
            f"({dict(br.stats)}) ({smi})")

        # 5. warm restart
        t_rec = fleet.start_node(c, chain=[full, d1])
        h = fleet.hello[c]
        rep = h["replay"]
        tm = rep["timings_s"]
        lost, asked = fleet_check_restart(fleet, c, 3, gone_before)
        log("fleet", f"node {c} warm restart: spawn to serving {t_rec:.3f} s;"
            f" in the child {h['restore_s']:.3f} s = chain read and verify "
            f"{tm['read']:.3f} + fold {tm['fold']:.3f} + to the device "
            f"{tm['to_device']:.3f} + recovery() {tm['recovery']:.3f} + "
            f"replay {tm['replay']:.3f} s (+ KV and journal set-up); replay: "
            f"{rep['records']} records, {rep['puts']} puts, {rep['deletes']} "
            f"deletes, {rep['pages']} pages, {rep['truncated_bytes']} bytes "
            f"truncated; peak RSS {h['peak_rss_bytes']} bytes; {lost} of "
            f"{asked} acknowledged keys it owns lost; recovering, cold "
            f"misses counted as miss_recovering ({smi})")

        # 6. rejoin: the breaker closes, repair drains, mark_recovered
        probe = fleet.keys(np.flatnonzero(fleet.status == 1)[:VERB])
        deadline = time.monotonic() + 120.0
        while g.breakers[c].state != "closed":
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: node {c}'s breaker never "
                                     "closed after the restart")
            g.get(probe)
            time.sleep(0.05)
        bloom = fleet.eps[c].packed_bloom()
        down = np.flatnonzero(fleet.owned(c) & (fleet.stage == 4)
                              & (fleet.status == 1))
        fp = down[query_packed_np(bloom, fleet.keys(down),
                                  cfg.bloom.num_hashes)]
        p0, t0 = g.counters["repair_pages"], time.monotonic()
        while True:
            g.repair_tick()
            if not g._repair_pending:
                break
            if time.monotonic() - t0 > FLEET_REPAIR_S:
                raise AssertionError("fleet: the repair backlog never "
                                     "drained")
        t_rep = time.monotonic() - t0
        repaired = g.counters["repair_pages"] - p0
        info = fleet.boxes[c].recovery_info()
        if g.counters["recoveries_completed"] != 1 or info["recovering"]:
            raise AssertionError(
                f"fleet: recoveries_completed "
                f"{g.counters['recoveries_completed']}, node {c} {info}")
        gone = np.concatenate([gone_before, gone_during])
        n_live = fleet_check_rejoined(fleet, c, gone, fp)
        log("fleet", f"rejoin: breaker closed; repair drained {repaired} "
            f"pages in {t_rep:.3f} s = {repaired / max(t_rep, 1e-9):.0f} "
            f"pages/s ({g.counters['repair_rounds']} rounds); "
            f"recoveries_completed 1, node {c} left recovering; it serves "
            f"all {n_live} acknowledged keys it owns byte-exact ({len(fp)} "
            f"bloom false positives among the keys put while it was down) "
            f"and none of the {len(gone)} invalidated ({smi})")

        # 7. one more delta, stop, restore the chain in this process
        r = fleet.boxes[c].snapshot(d2, delta=True)
        if r["kind"] != "delta" or r["seq"] != 2:
            raise AssertionError(f"fleet: the last delta is {r}")
        sv = [fleet.serving(i) for i in range(FLEET_NODES)]
        grp = dict(g.counters)
        for k in ("corrupt_pages", "load_shed_puts", "load_shed_gets",
                  "miss_digest"):
            if grp[k]:
                raise AssertionError(f"fleet: group {k} {grp[k]}")
        for i in range(FLEET_NODES):
            for when, x in [("before the kill", p) for p in fleet.past[i]] \
                    + [("", sv[i])]:
                j = x["journal"]
                log("fleet", f"node {i}{' ' + when if when else ''}: journal "
                    f"appends {j['appends']}, syncs {j['syncs']}, "
                    f"fsync_lag_ms {j['fsync_lag_ms']:.3f}, rotations "
                    f"{j['rotations']}; GET phases {len(x['get_phases'])}, "
                    f"fused launches "
                    f"{x['launches'].get('fused_get_linear_flat', 0)}; peak "
                    f"RSS {x['peak_rss_bytes']} bytes ({smi})")
        launches = sum(int(x["launches"].get("fused_get_linear_flat", 0))
                       for x in sv + fleet.past[c])
        log("fleet", f"group counters {json.dumps(grp)}")
        for box in fleet.boxes:
            box.stop()
    finally:
        fleet.close()

    with RssPeak() as rss:
        t0 = time.monotonic()
        state = checkpoint.load_chain([full, d1, d2], cfg, device=DEVICE)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
    kv = sm.kv_mod.KV(cfg, state=state, device=DEVICE)
    own = fleet.owned(c)
    live = np.flatnonzero(own & (fleet.status == 1))
    gone_own = np.flatnonzero(own & (fleet.status == 2))
    for idx, hit in ((live, True), (gone_own, False)):
        for j in range(0, len(idx), GET_B):
            keys = sm.u32.from_numpy(fleet.keys(idx[j:j + GET_B]), sm.dev)
            out, found = kv.get(keys)
            if hit:
                ok = found | torch.from_numpy(np.isin(
                    idx[j:j + GET_B], fp)).to(sm.dev)
                if not bool(ok.all()) or not torch.equal(
                        out[found], sm.pages_of(keys[found], fleet.pw)):
                    raise AssertionError("fleet: the restored chain lost or "
                                         "changed a page")
            elif bool(found.any()):
                raise AssertionError("fleet: the restored chain serves an "
                                     "invalidated key")
    log("fleet", f"in-process restore of node {c}'s chain (full + 2 deltas) "
        f"onto {kv.device}: {t_load:.3f} s, peak RSS of this process during "
        f"it {rss.peak} bytes (lifetime peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}); all "
        f"{len(live)} acknowledged keys it owns hit byte-exact, its "
        f"{len(gone_own)} invalidated keys miss ({smi})")

    # kernel against plain on the restored 8 GiB state, and its times
    present = sm.u32.from_numpy(fleet.keys(live[:4096]), sm.dev)
    never = sm.keys_of(FLEET_HI, torch.randint(
        NEVER_LO, 1 << 32, (1024,), device=sm.dev, generator=sm.gen))
    pool = torch.cat([sm.u32.from_numpy(fleet.keys(live), sm.dev), never,
                      torch.full((64, 2), -1, dtype=torch.int32,
                                 device=sm.dev)])
    covers = sm.add_extents(kv, 4)
    # no key was ever evicted in the fleet: every other cause occurs
    sm.kernel_phase(kv, pool, present, covers, "fleet restored",
                    need=(0, 1, 2, 4, 7))
    st = kv.state
    args, kw = sm.kernel_args(st)
    batches = [sm.pick(pool, GET_B) for _ in range(8)]
    s_ = st.index.table.shape[1] // 4
    nbytes = [fused.fused_get_bytes(sm.compare(k, st, "fleet timed")[0],
                                    GET_B, s_, fleet.pw,
                                    st.evicted_filter.numel())
              for k in batches]
    ms = time_ms(torch, [lambda k=k: fused.fused_get(k, *args, **kw)
                         for k in batches], 48, device_only=True)
    plain_ms = time_ms(torch, [lambda k=k: fused.get_core_reference(
        k, *args, **kw) for k in batches], 8, device_only=True)
    bound_ms = sum(nbytes) / len(nbytes) / HBM_BYTES_PER_S * 1e3
    log("times", f"fused_get_linear_flat w={GET_B} on the restored fleet "
        f"node, rotated over {len(batches)} batches: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
        f"{bound_ms / ms:.1%} of the memory rate ({smi})")
    return {
        "name": "fused_get_linear_flat",
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err["fused_get_linear_flat"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "path": "fleet",
    }


def plane_dir():
    """Where the plane's snapshots go: `build/plane` under the checkout
    (git-ignored, on the checkout's disk)."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "plane"


class PlaneCounts:
    """What a `ShardedKV`'s plane verbs were asked in a window: routed ops
    (extent phases count one per shard, as the plane's `shard{i}_ops`
    counters do), GET phases with keys, their keys, and the widest
    per-shard width a GET phase ran. Wraps the instance's verbs."""

    def __init__(self, skv):
        import numpy as np

        self.ops = self.get_phases = self.get_keys = self.wl_max = 0
        n = skv.n_shards
        for name in ("plane_insert", "plane_get", "plane_delete",
                     "plane_get_extent", "insert_extent"):
            real = getattr(skv, name)

            def wrapped(*args, _real=real, _name=name):
                out = _real(*args)
                if _name == "insert_extent" or out.counts is None:
                    self.ops += n
                    if _name == "plane_get_extent":
                        # a GetExtent counts its keys as GETs (shard 0)
                        self.get_keys += out.b
                else:
                    c = np.asarray(out.counts)
                    self.ops += int(c.sum())
                    if _name == "plane_get" and out.b:
                        self.get_phases += 1
                        self.get_keys += out.b
                        self.wl_max = max(self.wl_max,
                                          skv._router.width(int(c.max())))
                return out

            setattr(skv, name, wrapped)


def shard_ops(be) -> int:
    return sum(int(c.value) for c in be._c_shard)


def plane_fill(skv, n: int, hi: int, plane: bool):
    """Pages (hi, i < n) put in PLANE_INS_B-key batches through
    `ShardedKV.insert` (a2a) or `plane_insert`. -> (seconds, drops reported
    by the inserts, rows past an a2a pair's capacity)."""
    import numpy as np

    from pmdfc_tpu_torch.parallel.partitioning import shard_of_np
    from pmdfc_tpu_torch.parallel.shard import pair_capacity

    pw = skv.config.page_words
    drops = overflow = 0
    t0 = time.monotonic()
    for i in range(0, n, PLANE_INS_B):
        lo = np.arange(i, min(i + PLANE_INS_B, n), dtype=np.uint32)
        his = np.full(len(lo), hi, np.uint32)
        keys = np.stack([his, lo], -1)
        if plane:
            res = skv.plane_insert(keys, pages_np(his, lo, pw)).fetch()
        else:
            res = skv.insert(keys, pages_np(his, lo, pw))
            # the rows no a2a bucket could take: each source's count per
            # destination past the pair capacity
            w = 16
            while w < len(lo):
                w <<= 1
            w += -w % skv.n_shards
            bl = w // skv.n_shards
            c = pair_capacity(bl, skv.n_shards)
            own = shard_of_np(keys, skv.n_shards)
            for s in range(skv.n_shards):
                per = np.bincount(own[s * bl:(s + 1) * bl],
                                  minlength=skv.n_shards)
                overflow += int(np.maximum(per - c, 0).sum())
        drops += int(np.asarray(res.dropped).sum())
    skv._sync()
    return time.monotonic() - t0, drops, overflow


def plane_held(skv, hi: int):
    """Sorted lo words of the keys (hi, .) every shard's index holds now
    (lane 0; a scan on each shard's device)."""
    import numpy as np

    from pmdfc_tpu_torch.models.base import get_index_ops
    from pmdfc_tpu_torch.utils import u32

    ops = get_index_ops(skv.config.index.kind)
    out = []
    with skv._lock:
        for st in skv.states:
            flat, _ = ops.scan(st.index)
            hit = flat[:, 0] == int(np.uint32(hi).view(np.int32))
            out.append(u32.to_numpy(flat[hit][:, 1]))
    return np.sort(np.concatenate(out))


def plane_checks(sm, skv, be, srv, clients, counts, launches_per_phase,
                 shard_ops0, stats0, label):
    """The plane's serving checks over one window, as the wire phase's:
    no serve error, no contained phase failure, no disconnect, `misses ==
    Σ miss_*` on stats() and on every shard's row of shard_report(), the
    shard{i}_ops counters sum to the routed ops, every GET key routed was
    counted once (a read-only GET's stats land once), and one fused-GET
    launch per shard (per lane) per GET phase."""
    fused = sm.fused
    health = dict(srv.stats)
    s = skv.stats()
    rep = skv.shard_report()["stats"]
    causes = sm.kv_mod.MISS_CAUSE_NAMES
    launches = fused.launches["fused_get_linear_flat"]
    disconnects = sum(c.rc.stats()["disconnects"] for c in clients)
    checks = [
        (int(health["serve_errors"]) == 0,
         f"serve_errors {health['serve_errors']}"),
        (all(int(health[k]) == 0 for k in ("nacks_sent", "bisect_failures",
                                           "poison_ops", "deadline_shed")),
         "a phase failed: " + str({k: health[k] for k in (
             "nacks_sent", "bisect_failures", "poison_ops",
             "deadline_shed")})),
        (disconnects == 0, f"{disconnects} client disconnects"),
        (s["misses"] == sum(s[c] for c in causes),
         "misses != sum of miss causes"),
        (all(rep["misses"][i] == sum(rep[c][i] for c in causes)
             for i in range(skv.n_shards)),
         "a shard's misses != the sum of its miss causes"),
        (shard_ops(be) - shard_ops0 == counts.ops,
         f"shard ops {shard_ops(be) - shard_ops0} != {counts.ops} routed"),
        (s["gets"] - stats0["gets"] == counts.get_keys,
         f"{s['gets'] - stats0['gets']} GETs counted for {counts.get_keys} "
         "GET keys routed"),
        (counts.get_phases > 0
         and launches == launches_per_phase * counts.get_phases,
         f"{launches} fused-GET launches for {counts.get_phases} GET phases "
         f"x {launches_per_phase}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"{label}: {msg}")
    return launches


def plane_kernel(sm, state, present, pw: int, widths, label: str, smi,
                 hi: int = DIRECT_HI, timed: bool = True, batch=None):
    """Kernel against plain on one full state at each width (its keys (hi,
    present) and never-inserted ones, or the batches `batch(w)` draws),
    and with `timed` the kernel's times at each -> {w: (ms, plain_ms,
    bound_ms)}."""
    np, torch, fused = sm.np, sm.torch, sm.fused
    name = variant_of(state)
    if batch is None:
        present = torch.from_numpy(present.astype(np.int64)).to(sm.dev)

        def batch(w):
            n_never = max(1, w // 8)
            keys = torch.cat([
                sm.keys_of(hi, sm.pick(present, w - n_never)),
                sm.keys_of(hi, torch.randint(
                    NEVER_LO, 1 << 32, (n_never,), device=sm.dev,
                    generator=sm.gen))])
            return keys[torch.randperm(w, device=sm.dev, generator=sm.gen)]

    args, kw = sm.kernel_args(state)
    s_ = state.index.table.shape[1] // 4
    # a CCEH key reads its directory word first; a tiered key past the
    # generation gate its cold row's generation and live byte
    dirr = getattr(state.index, "dirr", None)
    dir_bytes = 0 if dirr is None else 4 * dirr.numel()
    out = {}
    for w in widths:
        causes, _ = sm.compare(batch(w), state, f"{label} w={w}")
        log("kernel", f"{label} full w={w}: kernel == plain, "
            f"causes {CAUSE_NAMES}={causes}")
        if not timed:
            continue
        batches = [batch(w) for _ in range(8)]
        nbytes = [fused.fused_get_bytes(
            *cmp[:1], w, s_, pw, state.evicted_filter.numel(), dir_bytes,
            cmp[1]) for cmp in (sm.compare(k, state, f"{label} timed")
                                for k in batches)]
        ms = time_ms(torch, [lambda k=k: fused.fused_get(k, *args, **kw)
                             for k in batches], 48, device_only=True)
        plain_ms = time_ms(torch, [lambda k=k: fused.get_core_reference(
            k, *args, **kw) for k in batches], 8, device_only=True)
        bound_ms = sum(nbytes) / len(nbytes) / HBM_BYTES_PER_S * 1e3
        log("times", f"{name} w={w} on {label}, "
            f"rotated over {len(batches)} batches: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
            f"{bound_ms / ms:.1%} of the memory rate ({smi})")
        out[w] = (ms, plain_ms, bound_ms)
    return out


def plane_entry(sm, path: str, launches: int, t,
                name: str = "fused_get_linear_flat") -> dict:
    ms, plain_ms, bound_ms = t
    return {
        "name": name,
        "route": "cuda",
        "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
        "replaces": "pmdfc_tpu/ops/fused.py:414",
        "launches": launches,
        "max_abs_err": sm.max_err[name],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "path": path,
    }


def free_card(torch) -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_plane(sm: Smoke):
    """The sharded plane (phase 10): a 4-shard 8 GiB plane behind
    `NetServer`, its snapshots, chain restore and reshard restore, the
    engine pass, and the 2 x 2 replica plane. -> the plane's kernel
    entries (1-D and 2-D)."""
    import shutil

    root = plane_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    fs, free = disk_of(root)
    log("env", f"plane directory {root}: filesystem {fs}, {free} bytes free")
    if fs == "tmpfs" or free < PLANE_DISK_BYTES:
        raise AssertionError(f"plane: {root} is {fs} with {free} bytes free; "
                             f"the phase needs a disk with {PLANE_DISK_BYTES}")
    try:
        entry, snap = plane_1d(sm, root)
        free_card(sm.torch)
        plane_restore(sm, snap)
        free_card(sm.torch)
        return [entry, plane_2d(sm)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def plane_1d(sm: Smoke, root):
    """The 1-D plane: a2a fill, the wire, the storm, extents, the fast
    lane, kernel against plain; then its full and delta snapshots.
    -> (the kernel entry, what the restores check)."""
    import os

    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        NetConfig)
    from pmdfc_tpu_torch.parallel.plane import PlaneBackend
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh
    from pmdfc_tpu_torch.runtime.net import NetServer

    smi = nvidia_smi()
    cfg = KVConfig(index=IndexConfig(**PLANE_INDEX),
                   bloom=BloomConfig(num_bits=PLANE_BLOOM_BITS))
    pw = cfg.page_words
    n = PLANE_SHARDS
    skv = ShardedKV(cfg, mesh=make_mesh([DEVICE] * n))
    nconn = WIRE_CLIENTS * WIRE_CONNS
    pool_b = sum(st.pool.pages.numel() * 4 for st in skv.states)
    log("plane", f"ShardedKV over {n} shards on {skv.mesh}: "
        f"{skv.capacity()} slots, pools {pool_b / 2**30:.2f} GiB, bloom "
        f"{PLANE_BLOOM_BITS} counters per shard; NetServer(NetConfig()) on "
        f"127.0.0.1, {WIRE_CLIENTS} clients x {WIRE_CONNS} connections")

    t_fill, drops, overflow = plane_fill(skv, PLANE_DIRECT, DIRECT_HI,
                                         plane=False)
    log("plane", f"fill: {PLANE_DIRECT} pages through ShardedKV.insert "
        f"(a2a, {PLANE_INS_B}-key batches) in {t_fill:.3f} s = "
        f"{PLANE_DIRECT / t_fill:.0f} pages/s; a2a pair overflow "
        f"{overflow} rows, drops reported {drops} ({smi})")

    be = PlaneBackend(skv)
    counts = PlaneCounts(skv)
    srv = NetServer(lambda: be, net=NetConfig(), bf_push_s=BF_PUSH_S)
    srv.start()
    clients: list[WireClient] = []
    fused.launches.clear()
    ops0, stats0 = shard_ops(be), skv.stats()
    try:
        clients = [WireClient(srv.port, c, PLANE_FILL // nconn, pw, sm.seed,
                              directory=c < WIRE_FAST_CONNS)
                   for c in range(nconn)]
        t_wfill = run_threads([c.fill for c in clients], "plane fill")
        direct_present = plane_held(skv, DIRECT_HI)
        evicted = np.setdiff1d(np.arange(PLANE_DIRECT, dtype=np.uint32),
                               direct_present)
        log("plane", f"after the fills: {len(direct_present)} pre-fill keys "
            f"held, {len(evicted)} evicted")
        srv.push_bloom_now()
        deadline = time.monotonic() + 60
        while any(c.cc.counters["bf_pushes"] < 1 or c.cc._bloom is None
                  for c in clients):
            if time.monotonic() > deadline:
                raise AssertionError("plane: a client never received the "
                                     "bloom push")
            time.sleep(0.01)
        verbs = max(1, PLANE_GETS // (nconn * VERB))
        run_threads([lambda c=c: c.prepare(verbs * VERB // 8)
                     for c in clients], "plane mirror check, invalidate")
        t_storm = run_threads([lambda c=c: c.storm(verbs, evicted)
                               for c in clients], "plane storm")
        n_found, n_inrun = extent_roundtrip(clients[-1].rc, PLANE_EXTENTS,
                                            skv.stats)
        # the fast lane: per-(shard, row) validated reads of the directory
        fast = clients[:WIRE_FAST_CONNS]
        t0 = time.monotonic()
        if not all(c.rc.dir_refresh() for c in fast):
            raise AssertionError("plane: a directory pull failed")
        t_pull = time.monotonic() - t0
        perm = np.random.default_rng(sm.seed).permutation(direct_present)
        k = min(PLANE_FAST_KEYS, len(perm) // WIRE_FAST_CONNS)
        sets = [np.sort(perm[i * k:(i + 1) * k])
                for i in range(WIRE_FAST_CONNS)]
        want = {"gone": np.zeros(0, np.uint32),
                "rewritten": np.zeros(0, np.uint32), "xor": 0x5A5A5A5A}
        fp0 = (int(srv.stats["fastpath_hits"]),
               int(srv.stats["fastpath_stale"]))
        p1 = fast_pass(fast, sets, want, "plane fast read 1")
        r = WIRE_REWRITE // WIRE_FAST_CONNS
        rw = np.sort(np.concatenate([x[:r] for x in sets]))
        gone = np.sort(np.concatenate([x[r:2 * r] for x in sets]))
        driver = clients[WIRE_FAST_CONNS]
        for j in range(0, len(rw), VERB):
            lo = rw[j:j + VERB]
            hi = np.full(len(lo), DIRECT_HI, np.uint32)
            driver.cc.put_pages(hi, lo, pages_np(hi, lo, pw)
                                ^ np.uint32(want["xor"]))
        rs = driver.rc.stats()
        if rs["dropped_puts"] or rs["disconnects"]:
            raise AssertionError(f"plane: the driver's rewrites were not all "
                                 f"applied: {rs}")
        want["rewritten"] = rw
        p2 = fast_pass(fast, sets, want, "plane fast read 2 (rewrites)")
        driver.cc.invalidate_pages(np.full(len(gone), DIRECT_HI, np.uint32),
                                   gone)
        want["gone"] = gone
        p3 = fast_pass(fast, sets, want, "plane fast read 3 (invalidates)")
        fp = (int(srv.stats["fastpath_hits"]) - fp0[0],
              int(srv.stats["fastpath_stale"]) - fp0[1])
        torch.cuda.synchronize()
        launches = plane_checks(sm, skv, be, srv, clients, counts, n, ops0,
                                stats0, "plane")
        widths = sorted({8, counts.wl_max})
    finally:
        srv.stop()
        for c in clients:
            c.close()

    s = skv.stats()
    never = sum(c.never for c in clients)
    asked = sum(c.never_asked for c in clients)
    short = 1 - asked / never
    mirror = clients[0].cc._bloom
    density = float(np.unpackbits(mirror.view(np.uint8)).mean())
    expect_short = 1 - density ** clients[0].cc.num_hashes
    lost = s["evictions"] + s["drops"]
    acked = sum(c.acked_misses for c in clients) + p1[4] + p2[4] + p3[4]
    negatives = sum(c.negatives for c in clients)
    lanes = p1[3] + p2[3] + p3[3]
    for ok, msg in [
            (acked <= lost, f"{acked} acknowledged keys missed, more than "
             f"evictions + drops {lost}"),
            (negatives <= lost, f"{negatives} mirror negatives among "
             f"acknowledged keys, more than evictions + drops {lost}"),
            # the mirror is the OR of the per-shard filters (PLANE_SHARDS
            # x the keys in one shard's bits): it short-circuits what its
            # bit density lets it, 1 - density^k of never-inserted keys
            (short >= expect_short - 0.05, f"only {short:.1%} of never-"
             f"inserted GETs were short-circuited by the mirrors, "
             f"{expect_short:.1%} expected from their density"),
            (fp[0] + fp[1] == lanes, f"fastpath_hits {fp[0]} + "
             f"fastpath_stale {fp[1]} != {lanes} fast lanes read"),
            (p1[2] > 0 and p2[3] > 0, "the fast lane served nothing")]:
        if not ok:
            raise AssertionError(f"plane: {msg}")
    put_lat = [x for c in clients for x in c.put_lat]
    get_lat = [x for c in clients for x in c.get_lat]
    n_gets = nconn * verbs * VERB
    log("plane", f"fill: {PLANE_FILL} pages over the wire by {nconn} "
        f"connections in {t_wfill:.3f} s = {PLANE_FILL / t_wfill:.0f} "
        f"pages/s; put_pages verb of {VERB} pages: {percentiles_ms(put_lat)}"
        f" ({smi})")
    log("plane", f"storm: {n_gets} GET keys in {t_storm:.3f} s = "
        f"{n_gets / t_storm:.0f} keys/s; get_pages verb of {VERB} keys: "
        f"{percentiles_ms(get_lat)} ({smi})")
    log("plane", f"GET phases {counts.get_phases} ({counts.get_keys} keys), "
        f"widest per-shard width {counts.wl_max}; fused_get_linear_flat "
        f"launches {launches} = {n} per phase; shard ops "
        f"{skv.shard_report()['stats']['gets']} GETs per shard ({smi})")
    log("plane", f"fast lane: directory pull by {WIRE_FAST_CONNS} "
        f"connections in {t_pull:.3f} s; read 1: {p1[1]} keys in "
        f"{p1[0]:.3f} s = {p1[1] / p1[0]:.0f} keys/s; read 2 after "
        f"{len(rw)} rewrites: {p2[1] / p2[0]:.0f} keys/s; read 3 after "
        f"{len(gone)} invalidates: {p3[1] / p3[0]:.0f} keys/s; "
        f"fastpath_hits {fp[0]}, fastpath_stale {fp[1]} ({smi})")
    log("plane", f"checks passed: {acked} acknowledged keys missed <= "
        f"evictions {s['evictions']} + drops {s['drops']}; hits {s['hits']},"
        f" misses {s['misses']} == sum of causes on stats() and every "
        f"shard; routed ops == shard{{i}}_ops; GETs counted once; mirrors "
        f"short-circuited {short:.2%} (bit density {density:.3f}: "
        f"{expect_short:.2%} expected); extents {n_found} of {n_inrun} "
        f"in-run probes found, every address exact; no serve error, NACK "
        f"or disconnect")
    kt = plane_kernel(sm, skv.states[0], direct_present[
        skv.node_of(np.stack([np.full(len(direct_present), DIRECT_HI,
                                      np.uint32), direct_present], -1)) == 0],
        pw, widths, "plane shard 0", smi)

    # snapshots: a full, then PLANE_MUTATE puts and invalidates, a delta
    deleted = np.concatenate(
        [np.stack([c.oids(len(c.inval)), c.inval], -1) for c in clients]
        + [np.stack([np.full(len(gone), DIRECT_HI, np.uint32), gone], -1)])
    d_full = skv.directory_snapshot(max_entries=1 << 30)
    s_full = skv.stats()
    full, delta = str(root / "full.npz"), str(root / "delta.npz")
    with RssPeak() as rss:
        t0 = time.monotonic()
        rep_f = skv.save(full)
        t_full = time.monotonic() - t0
    size_f = os.path.getsize(full)
    log("plane", f"full snapshot: {size_f} bytes in {t_full:.3f} s = "
        f"{size_f / t_full / 1e9:.3f} GB/s, peak RSS {rss.peak} bytes "
        f"({rep_f['kind']}, {rep_f['total_rows']} rows)")
    lo = np.arange(PLANE_MUTATE, dtype=np.uint32)
    his = np.full(PLANE_MUTATE, PLANE_MUT_HI, np.uint32)
    skv.plane_insert(np.stack([his, lo], -1), pages_np(his, lo, pw)).fetch()
    drop = d_full["keys"][np.random.default_rng(sm.seed).choice(
        len(d_full["keys"]), PLANE_MUTATE // 4, replace=False)]
    skv.plane_delete(drop).fetch()
    with RssPeak() as rss_d:
        t0 = time.monotonic()
        rep_d = skv.save(delta, delta=True)
        t_delta = time.monotonic() - t0
    if rep_d["kind"] != "delta":
        raise AssertionError(f"plane: the second snapshot is a {rep_d}")
    d_delta = skv.directory_snapshot(max_entries=1 << 30)
    size_d = os.path.getsize(delta)
    log("plane", f"delta snapshot: {rep_d['dirty_rows']} dirty rows, "
        f"{size_d} bytes in {t_delta:.3f} s = "
        f"{size_d / t_delta / 1e9:.3f} GB/s, peak RSS {rss_d.peak} bytes")
    snap = {"cfg": cfg, "full": full, "delta": delta, "d_full": d_full,
            "d_delta": d_delta, "deleted": deleted, "s_full": s_full,
            "rewritten": rw, "dropped": drop, "size_full": size_f}
    entry = plane_entry(sm, "plane", launches, kt[counts.wl_max])
    log("plane", f"kernel at w=8 per shard: {kt[8][0]:.4f} ms, bound "
        f"{kt[8][2]:.4f} ms ({smi})")
    del skv, be, srv, clients
    return entry, snap


def plane_expect(snap, keys):
    """The page each key should hold: its own page, XOR-ed where the fast
    lane's driver rewrote it."""
    import numpy as np

    pages = pages_np(keys[:, 0], keys[:, 1], snap["cfg"].page_words)
    rw = (keys[:, 0] == DIRECT_HI) & np.isin(keys[:, 1], snap["rewritten"])
    pages[rw] ^= np.uint32(0x5A5A5A5A)
    return pages


def plane_serves(skv, snap, keys, label: str) -> None:
    """Every key hits byte-exact (in 2^16-key plane GETs)."""
    import numpy as np

    for i in range(0, len(keys), 1 << 16):
        k = keys[i:i + (1 << 16)]
        g = skv.plane_get(k).fetch()
        if not g.found.all():
            raise AssertionError(f"{label}: {int((~g.found).sum())} of "
                                 f"{len(k)} live keys missed")
        if not np.array_equal(g.dense(), plane_expect(snap, k)):
            raise AssertionError(f"{label}: a page came back changed")


def plane_restore(sm: Smoke, snap) -> None:
    """The chain restore onto a fresh 4-shard plane (every key the delta
    held hits byte-exact), the engine pass on it, then the reshard restore
    of the full onto PLANE_RESHARD shards (no live page lost, deleted keys
    stay deleted, the replay drops nothing)."""
    import os

    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh
    from pmdfc_tpu_torch.runtime import Engine, KVServer

    smi = nvidia_smi()
    cfg = snap["cfg"]
    skv = ShardedKV(cfg, mesh=make_mesh([DEVICE] * PLANE_SHARDS))
    size = snap["size_full"] + os.path.getsize(snap["delta"])
    with RssPeak() as rss:
        t0 = time.monotonic()
        skv.restore_chain([snap["full"], snap["delta"]])
        skv._sync()
        t_chain = time.monotonic() - t0
    plane_serves(skv, snap, snap["d_delta"]["keys"], "chain restore")
    gone = skv.plane_get(snap["dropped"]).fetch()
    if gone.found.any():
        raise AssertionError("chain restore: a key the delta dropped hit")
    log("plane", f"restore_chain([full, delta]) onto {PLANE_SHARDS} shards: "
        f"{size} bytes in {t_chain:.3f} s = {size / t_chain / 1e9:.3f} GB/s,"
        f" peak RSS {rss.peak} bytes; all {len(snap['d_delta']['keys'])} "
        f"live keys hit byte-exact ({smi})")

    # the engine pass: KVServer(kv=the restored plane), clean-cache
    # threads through the native engine
    srv = KVServer(cfg, engine=Engine(**SERVE_ENGINE), kv=skv)
    eng = srv.engine
    minus_two: list[int] = []
    real_wait = eng.wait_many

    def wait_many(base, nw, timeout_us=10_000_000):
        st = real_wait(base, nw, timeout_us=timeout_us)
        if (st == -2).any():
            minus_two.append(int((st == -2).sum()))
        return st

    eng.wait_many = wait_many
    srv.warmup()
    fused.launches.clear()
    s0 = skv.stats()
    srv.start()
    try:
        per = PLANE_ENGINE_PAGES // PLANE_ENGINE_THREADS
        clients = [ServeClient(srv, t, per, sm.seed)
                   for t in range(PLANE_ENGINE_THREADS)]
        t_fill = run_threads([c.fill for c in clients], "plane engine fill")
        srv.push_bloom_now()
        run_threads([c.prepare for c in clients], "plane engine prepare")
        t_get = run_threads([c.storm for c in clients], "plane engine gets")
    finally:
        srv.stop()
    s1 = skv.stats()
    launches = fused.launches["fused_get_linear_flat"]
    lost = (s1["evictions"] - s0["evictions"]) + (s1["drops"] - s0["drops"])
    acked = sum(c.acked_misses for c in clients)
    for ok, msg in [
            (not minus_two, f"{sum(minus_two)} requests failed with -2"),
            (srv.errors == 0, f"{srv.errors} serve errors"),
            (acked <= lost, f"{acked} acknowledged pages missed, more than "
             f"the pass's evictions + drops {lost}"),
            (srv.op_batches["get"] > 0
             and launches == PLANE_SHARDS * srv.op_batches["get"],
             f"{launches} launches for {srv.op_batches['get']} GET flushes"),
            (s1["misses"] == sum(s1[c] for c in sm.kv_mod.MISS_CAUSE_NAMES),
             "misses != sum of miss causes")]:
        if not ok:
            raise AssertionError(f"plane engine pass: {msg}")
    n_get = PLANE_ENGINE_THREADS * GET_VERBS * VERB
    log("plane", f"engine pass: KVServer(kv=ShardedKV) with "
        f"{PLANE_ENGINE_THREADS} clean-cache threads: {PLANE_ENGINE_PAGES} "
        f"pages put in {t_fill:.3f} s = {PLANE_ENGINE_PAGES / t_fill:.0f} "
        f"pages/s, {n_get} GET keys in {t_get:.3f} s = {n_get / t_get:.0f} "
        f"keys/s; every hit byte-exact, no -2, {srv.op_batches['get']} GET "
        f"flushes = {launches} launches / {PLANE_SHARDS} ({smi})")
    del srv, skv, clients
    free_card(torch)

    # reshard the full onto PLANE_RESHARD shards
    skv = ShardedKV(cfg, mesh=make_mesh([DEVICE] * PLANE_RESHARD))
    with RssPeak() as rss:
        t0 = time.monotonic()
        skv.restore(snap["full"])
        skv._sync()
        t_rs = time.monotonic() - t0
    s = skv.stats()
    plane_serves(skv, snap, snap["d_full"]["keys"], "reshard restore")
    dele = snap["deleted"]
    for i in range(0, len(dele), 1 << 16):
        if skv.plane_get(dele[i:i + (1 << 16)]).fetch().found.any():
            raise AssertionError("reshard restore: a deleted key hit")
    if s["drops"] != snap["s_full"]["drops"]:
        raise AssertionError(f"reshard restore: the replay dropped "
                             f"{s['drops'] - snap['s_full']['drops']} pages")
    for k in ("puts", "deletes", "extent_puts"):
        if s[k] != snap["s_full"][k]:
            raise AssertionError(f"reshard restore: {k} {s[k]} != "
                                 f"{snap['s_full'][k]}")
    log("plane", f"reshard restore of the full onto {PLANE_RESHARD} shards "
        f"({skv.capacity()} slots): {snap['size_full']} bytes in "
        f"{t_rs:.3f} s = {snap['size_full'] / t_rs / 1e9:.3f} GB/s, "
        f"{len(snap['d_full']['keys'])} live pages replayed "
        f"= {len(snap['d_full']['keys']) / t_rs:.0f} pages/s, peak RSS "
        f"{rss.peak} bytes; none lost, {len(dele)} deleted keys miss, the "
        f"replay dropped 0 ({smi})")
    del skv


def plane_2d(sm: Smoke) -> dict:
    """The 2 x 2 replica plane behind NetServer: the replica capability,
    the fill, a corrupted lane routed around, MSG_RREPAIR, the other lane
    corrupted. -> its kernel entry."""
    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, KVConfig,
                                        NetConfig)
    from pmdfc_tpu_torch.parallel.plane import PlaneBackend
    from pmdfc_tpu_torch.parallel.shard import ShardedKV, make_mesh2d
    from pmdfc_tpu_torch.runtime.net import NetServer

    smi = nvidia_smi()
    ns, nr = PLANE2D
    cfg = KVConfig(index=IndexConfig(**PLANE2D_INDEX),
                   bloom=BloomConfig(num_bits=PLANE2D_BLOOM_BITS))
    pw = cfg.page_words
    skv = ShardedKV(cfg, mesh=make_mesh2d(ns, nr, [DEVICE] * (ns * nr)))
    nconn = WIRE_CLIENTS * WIRE_CONNS
    pool_b = sum(st.pool.pages.numel() * 4 for row in skv._st for st in row)
    log("plane2d", f"ShardedKV over {ns} shards x {nr} replica lanes on "
        f"{skv.mesh}: {skv.capacity()} distinct slots, pools "
        f"{pool_b / 2**30:.2f} GiB on the card")
    t_fill, drops, _ = plane_fill(skv, PLANE_DIRECT, DIRECT_HI, plane=True)
    log("plane2d", f"fill: {PLANE_DIRECT} pages through plane_insert (every "
        f"lane in one call) in {t_fill:.3f} s = {PLANE_DIRECT / t_fill:.0f} "
        f"pages/s, drops {drops} ({smi})")
    be = PlaneBackend(skv)
    counts = PlaneCounts(skv)
    srv = NetServer(lambda: be, net=NetConfig(), bf_push_s=BF_PUSH_S)
    srv.start()
    clients: list[WireClient] = []
    fused.launches.clear()
    ops0, stats0 = shard_ops(be), skv.stats()
    try:
        clients = [WireClient(srv.port, c, PLANE_FILL // nconn, pw, sm.seed)
                   for c in range(nconn)]
        lanes = {c.be.replica_lanes for c in clients}
        if lanes != {nr}:
            raise AssertionError(f"plane2d: connections negotiated replica "
                                 f"lanes {lanes}, not {nr}")
        t_wfill = run_threads([c.fill for c in clients], "plane2d fill")
        direct_present = plane_held(skv, DIRECT_HI)
        evicted = np.setdiff1d(np.arange(PLANE_DIRECT, dtype=np.uint32),
                               direct_present)
        srv.push_bloom_now()
        deadline = time.monotonic() + 60
        while any(c.cc.counters["bf_pushes"] < 1 or c.cc._bloom is None
                  for c in clients):
            if time.monotonic() > deadline:
                raise AssertionError("plane2d: a client never received the "
                                     "bloom push")
            time.sleep(0.01)
        verbs = max(1, PLANE_GETS // (2 * nconn * VERB))
        run_threads([lambda c=c: c.prepare(2 * verbs * VERB // 8)
                     for c in clients], "plane2d mirror check, invalidate")

        def storm(label):
            r0 = skv.replica_report()
            t = run_threads([lambda c=c: c.storm(verbs, evicted)
                             for c in clients], label)
            r1 = skv.replica_report()
            return t, {k: [b - a for a, b in zip(r0[k], r1[k])]
                       for k in ("served", "digest_refused", "repaired")}

        skv.corrupt_replica_lane(1)
        t_s1, d1 = storm("plane2d storm, lane 1 corrupt")
        if not (d1["served"][0] > 0 and d1["served"][1] == 0
                and d1["digest_refused"][1] == d1["served"][0]
                and d1["digest_refused"][0] == 0):
            raise AssertionError(f"plane2d: lane 1 corrupt: {d1}")
        live = int(sum(skv.shard_report()["occupancy"]))
        t0 = time.monotonic()
        repaired = clients[0].be.replica_repair()
        t_rep = time.monotonic() - t0
        if repaired < live:
            raise AssertionError(f"plane2d: MSG_RREPAIR repaired {repaired} "
                                 f"rows, fewer than the {live} live pages")
        skv.corrupt_replica_lane(0)
        t_s2, d2 = storm("plane2d storm, lane 0 corrupt")
        if not (d2["served"][1] > 0 and d2["served"][0] == 0
                and d2["digest_refused"][0] == d2["served"][1]
                and d2["digest_refused"][1] == 0):
            raise AssertionError(f"plane2d: lane 0 corrupt: {d2}")
        torch.cuda.synchronize()
        launches = plane_checks(sm, skv, be, srv, clients, counts, ns * nr, ops0,
                                stats0, "plane2d")
        widths = sorted({8, counts.wl_max})
    finally:
        srv.stop()
        for c in clients:
            c.close()
    s = skv.stats()
    lost = s["evictions"] + s["drops"]
    acked = sum(c.acked_misses for c in clients)
    if acked > lost:
        raise AssertionError(f"plane2d: {acked} acknowledged keys missed, "
                             f"more than evictions + drops {lost}")
    put_lat = [x for c in clients for x in c.put_lat]
    get_lat = [x for c in clients for x in c.get_lat]
    n_gets = nconn * verbs * VERB
    log("plane2d", f"fill: {PLANE_FILL} pages over the wire in "
        f"{t_wfill:.3f} s = {PLANE_FILL / t_wfill:.0f} pages/s; put_pages "
        f"verb: {percentiles_ms(put_lat)} ({smi})")
    log("plane2d", f"storms of {n_gets} GET keys: lane 1 corrupt "
        f"{n_gets / t_s1:.0f} keys/s (lane 0 served {d1['served'][0]}, lane "
        f"1 refused {d1['digest_refused'][1]}); lane 0 corrupt "
        f"{n_gets / t_s2:.0f} keys/s (lane 1 served {d2['served'][1]}, lane "
        f"0 refused {d2['digest_refused'][0]}); get_pages verb: "
        f"{percentiles_ms(get_lat)} ({smi})")
    log("plane2d", f"MSG_RREPAIR: {repaired} rows repaired (>= {live} live "
        f"pages) in {t_rep:.3f} s; GET phases {counts.get_phases}, widest "
        f"per-shard width {counts.wl_max}, fused_get_linear_flat launches "
        f"{launches} = {ns * nr} per phase; checks passed: no wrong byte, "
        f"{acked} acknowledged keys missed <= {lost}, misses == sum of "
        f"causes on stats() and every shard ({smi})")
    own0 = skv.node_of(np.stack([np.full(len(direct_present), DIRECT_HI,
                                         np.uint32), direct_present], -1)) == 0
    skv.replica_repair()
    kt = plane_kernel(sm, skv.states[0], direct_present[own0], pw, widths,
                      "plane2d shard 0", smi)
    del skv, be, srv, clients
    return plane_entry(sm, "plane2d", launches, kt[8])


def control_dir():
    """Where phase 11 writes its telemetry dumps and captures (git-ignored,
    on the checkout's disk); removed at the end of the phase."""
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "control"


def run_row_kv(sm: Smoke):
    """The whole KV on the row-rebuild insert (the child process, started
    with PMDFC_INSERT_PATH=row): linear·flat at 8 GiB filled to 75%
    through `KV.insert`, GET storms through the fused kernel with every
    hit byte-exact and `misses == Σ miss_*`, the kernel against its plain
    version on the full state, and its times. -> its `kernels` entry."""
    from pmdfc_tpu_torch.config import (BloomConfig, IndexConfig, IndexKind,
                                        KVConfig)
    from pmdfc_tpu_torch.models import linear
    from pmdfc_tpu_torch.models.base import get_index_ops

    if get_index_ops(IndexKind.LINEAR).insert_batch \
            is not linear.insert_batch_row:
        raise AssertionError("row-kv: PMDFC_INSERT_PATH=row did not select "
                             "the row-rebuild insert")
    cfg = KVConfig(index=IndexConfig(**LINEAR_INDEX),
                   bloom=BloomConfig(num_bits=1 << 24, num_hashes=4))
    # this process starts cold: one untimed insert and get of the fill's
    # batch width on a small KV first, so the timed fill does not pay the
    # caching allocator's first allocations (the element path's fill in
    # phase 4 runs after phase 3 has warmed them)
    warm = sm.kv_mod.KV(dataclasses.replace(
        cfg, index=IndexConfig(capacity=INS_B * 2)), device=sm.dev)
    keys = sm.keys_of(PAGE_HI, sm.torch.arange(INS_B, device=sm.dev))
    warm.insert(keys, sm.pages_of(keys, cfg.page_words))
    warm.get(keys[:GET_B])
    del warm, keys
    path = MainPath(sm, cfg, "linear·row")
    sm.fused.launches.clear()
    sm.torch.cuda.synchronize()
    path.run()
    sm.torch.cuda.synchronize()
    launches = sm.fused.launches["fused_get_linear_flat"]
    if launches <= 0:
        raise AssertionError("row-kv: the fused GET never launched")
    check_stats(sm, path)
    present = (path.status == 1).nonzero().flatten()[:4096]
    covers = sm.add_extents(path.kv, 4)
    sm.kernel_phase(path.kv, all_keys(sm, path),
                    sm.keys_of(PAGE_HI, present), covers, "linear·row full")
    entry = measure(sm, path, launches)
    entry["fill_pages_per_s"] = path.n_fill / path.t_fill
    return entry


def row_kv_subprocess(sm: Smoke) -> dict:
    """`run_row_kv` in a child process of this script with
    PMDFC_INSERT_PATH=row (the switch is read at import); its log lines
    are echoed, its entry read from its `ROWKV` line. A child that fails
    fails the phase."""
    import os

    env = dict(os.environ, PMDFC_INSERT_PATH="row")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--row-kv", "--seed",
         str(sm.seed)], env=env, capture_output=True, text=True,
        timeout=ROW_KV_TIMEOUT_S)
    entry = None
    for line in proc.stdout.splitlines():
        if line.startswith("ROWKV "):
            entry = json.loads(line[len("ROWKV "):])
        else:
            print(line, flush=True)
    if proc.returncode != 0 or entry is None:
        raise AssertionError(f"row-kv child exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return entry


def run_harness(name: str, args) -> dict:
    """One harness of `pmdfc_tpu_torch/bench` as its own process on
    DEVICE -> its last JSON line. A nonzero exit fails the phase."""
    proc = subprocess.run(
        [sys.executable, "-m", f"pmdfc_tpu_torch.bench.{name}", "--device",
         DEVICE, *args], capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"harness {name} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def trace_kernels(path) -> int:
    """Events of the fused GET kernel (`TRACE_CAT`, `TRACE_NAME`) in the
    capture's `trace.json`."""
    import os

    with open(os.path.join(path, "trace.json")) as f:
        doc = json.load(f)
    return sum(1 for e in doc.get("traceEvents", [])
               if e.get("cat") == TRACE_CAT
               and TRACE_NAME in str(e.get("name", "")))


def knob_envelope(cfg) -> dict:
    """Each controller knob's [lo, hi] from its `AutotuneConfig`."""
    m = cfg.balloon_max_extents
    return {"dwell_us": (cfg.dwell_us_lo, cfg.dwell_us_hi),
            "settle_us": (cfg.settle_us_lo, cfg.settle_us_hi),
            "window": (cfg.window_lo, cfg.window_hi),
            "hedge_ms": (cfg.hedge_ms_lo, cfg.hedge_ms_hi),
            "migrate_pps": (cfg.migrate_pps_lo, cfg.migrate_pps_hi),
            "balloon_x": (-m, m),
            "admit_thresh": (cfg.admit_lo, cfg.admit_hi)}


class ControlConn:
    """One pipelined `TcpBackend` of the control path: GET verbs over the
    pre-fill keys (7/8 present, 1/8 never inserted); every hit must be the
    key's page, every never-inserted key must miss."""

    def __init__(self, port: int, cid: int, pw: int, present, seed: int):
        import numpy as np

        from pmdfc_tpu_torch.runtime.net import TcpBackend

        self.np, self.pw, self.present = np, pw, present
        self.rng = np.random.default_rng([seed, 2000 + cid])
        self.be = TcpBackend("127.0.0.1", port, page_words=pw,
                             window=WIRE_WINDOW, op_timeout_s=120.0)
        self.present_misses = self.keys = 0

    def gets(self, n: int, verb: int, until=None) -> None:
        """`n` GET verbs of `verb` keys, and more until the event `until`
        (when given) is set."""
        np = self.np
        i = 0
        while i < n or (until is not None and not until.is_set()):
            i += 1
            n_never = max(1, verb // 8)
            lo = np.concatenate([
                self.rng.choice(self.present, verb - n_never),
                self.rng.integers(NEVER_LO, 1 << 32, n_never,
                                  dtype=np.uint64).astype(np.uint32)])
            keys = np.stack([np.full(verb, CONTROL_HI, np.uint32), lo], -1)
            out, found = self.be.get(keys)
            found = np.asarray(found, bool)
            if found[verb - n_never:].any():
                raise AssertionError("control: a never-inserted key hit")
            if not np.array_equal(np.asarray(out, np.uint32)[found],
                                  pages_np(CONTROL_HI, lo[found], self.pw)):
                raise AssertionError("control: a hit returned wrong bytes")
            if np.asarray(out)[~found].any():
                raise AssertionError("control: a miss returned nonzero bytes")
            self.present_misses += int((~found[:verb - n_never]).sum())
            self.keys += verb

    def close(self) -> None:
        self.be.close()


def control_row_ab(sm: Smoke) -> None:
    """The index alone: two linear indexes of 2^21 slots filled to 75% in
    INS_B-key batches, one through each insert path, equal bit for bit
    after every batch, every insert timed."""
    from pmdfc_tpu_torch.bench import insert_rowscatter

    smi = nvidia_smi()
    r = insert_rowscatter.ab_fill(ROW_INDEX["capacity"], INS_B, 0.75, DEVICE,
                                  sm.seed)
    speedup = r["element_ms_per_batch"] / r["row_ms_per_batch"]
    log("control", f"row vs element, the index alone: {r['batches']} "
        f"batches of {r['batch']} keys (3/4 fresh, 1/8 updates, 1/16 "
        f"in-batch duplicates, 1/16 padding) into two linear indexes of "
        f"{r['slots']} slots, {r['occupied']} occupied at the end; "
        f"{r['collided']} same-cluster collisions, {r['updates']} updates, "
        f"{r['evicted']} evictions, {r['dropped']} drops; tables, heads and "
        f"every InsertResult equal after every batch; element "
        f"{r['element_ms_per_batch']:.4f} ms, row "
        f"{r['row_ms_per_batch']:.4f} ms per {r['batch']}-key insert "
        f"(CUDA events): row speedup {speedup:.3f}x ({smi})")


def run_control(sm: Smoke):
    """Phase 11: the row insert at full width (the index alone, then the
    whole KV on the row path in a child process), the profiler and the
    controller behind the wire on linear·tiered, and the harnesses.
    -> the phase's kernel entries."""
    import os
    import shutil
    import threading

    np, torch, fused = sm.np, sm.torch, sm.fused
    from pmdfc_tpu_torch.client import DirectBackend
    from pmdfc_tpu_torch.config import (AutotuneConfig, BloomConfig,
                                        IndexConfig, KVConfig, NetConfig,
                                        ProfilerConfig, TelemetryConfig,
                                        TierConfig)
    from pmdfc_tpu_torch.runtime import autotune
    from pmdfc_tpu_torch.runtime import profiler as prof_mod
    from pmdfc_tpu_torch.runtime import telemetry as tele
    from pmdfc_tpu_torch.runtime import timeseries
    from pmdfc_tpu_torch.runtime.net import NetServer, TcpBackend

    t_phase = time.monotonic()
    control_row_ab(sm)
    row_entry = row_kv_subprocess(sm)
    log("control", f"row path, whole KV: linear·flat filled at "
        f"{row_entry['fill_pages_per_s']:.0f} pages/s through KV.insert on "
        f"the row-rebuild insert; GETs byte-exact; fused_get_linear_flat "
        f"{row_entry['launches']} launches, kernel == plain ({nvidia_smi()})")
    row_entry.pop("fill_pages_per_s")
    row_entry["path"] = "row-path"

    smi = nvidia_smi()
    root = control_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env0 = os.environ.get("PMDFC_PROF")
    os.environ["PMDFC_PROF"] = "on"
    reg = tele.configure(TelemetryConfig(dump_dir=str(root / "tele")))
    collector = None
    try:
        prof = prof_mod.install(ProfilerConfig(trace_min_interval_s=60.0))
        collector = timeseries.ensure_collector(interval_s=0.25)
        cfg = KVConfig(index=IndexConfig(**CONTROL_INDEX),
                       bloom=BloomConfig(num_bits=CONTROL_BLOOM_BITS),
                       tier=TierConfig())
        kv = sm.kv_mod.KV(cfg, device=DEVICE)
        pw = cfg.page_words
        n_fill = 3 * kv.capacity() // 4 // INS_B * INS_B
        t0 = time.monotonic()
        for i in range(0, n_fill, INS_B):
            lo = torch.arange(i, i + INS_B, device=sm.dev)
            keys = sm.keys_of(CONTROL_HI, lo)
            kv.insert(keys, sm.pages_of(keys, pw))
        torch.cuda.synchronize()
        t_fill = time.monotonic() - t0
        with kv._lock:
            flat, _ = kv._ops.scan(kv.state.index)
            held = flat[flat[:, 0] == sm.u32.narrow(torch.tensor(CONTROL_HI))]
            present = np.sort(sm.u32.to_numpy(held[:, 1]))
        log("control", f"linear·tiered {kv.state.pool.pages.numel() * 4 / 2**30:.2f}"
            f" GiB ({cfg.tier}) pre-filled with {n_fill} pages through "
            f"KV.insert in {t_fill:.3f} s = {n_fill / t_fill:.0f} pages/s; "
            f"{len(present)} held; NetServer(NetConfig()), PMDFC_PROF=on, "
            f"a series collector every 0.25 s, the controller attached")

        shared = DirectBackend(kv)
        # (padded width, wall us, [kv.get device_us], end on the host clock)
        phases: list = []
        dev_us: list = []
        real_note = prof.note_launch

        def note(program, phase, device_us, *a, **kw):
            if program == "kv.get":
                dev_us.append(device_us)
            return real_note(program, phase, device_us, *a, **kw)

        prof.note_launch = note
        real_get = shared.get

        def get(keys):
            n0 = len(dev_us)
            t0 = time.perf_counter()
            out = real_get(keys)
            phases.append((len(keys), (time.perf_counter() - t0) * 1e6,
                           dev_us[n0:], time.monotonic()))
            return out

        shared.get = get
        srv = NetServer(lambda: shared, net=NetConfig()).start()
        conns: list[ControlConn] = []
        mon = ctl = None
        try:
            conns = [ControlConn(srv.port, c, pw, present, sm.seed)
                     for c in range(CONTROL_CONNS)]
            mon = TcpBackend("127.0.0.1", srv.port, page_words=pw,
                             op_timeout_s=120.0)
            if not (mon.prof and all(c.be.prof for c in conns)):
                raise AssertionError("control: MSG_PROFILE not negotiated")
            ctl = autotune.attach(server=srv, client=conns[0].be,
                                  cfg=AutotuneConfig(interval_s=0.1),
                                  start=True)
            ctl.bind_balloon(kv)
            knobs0 = ctl.knob_values()
            s0 = kv.stats()
            fused.launches.clear()
            get0 = reg.snapshot()["histograms"].get(
                "prof.kv.get.device_us", {}).get("count", 0)
            del phases[:]
            # the light phase: one connection, small verbs, until the
            # deadline
            t_light = time.monotonic()
            while time.monotonic() - t_light < CONTROL_LIGHT_S:
                conns[0].gets(1, CONTROL_LIGHT_VERB)
            knobs_light = ctl.knob_values()
            n_light = len(phases)
            # the fan-in phase, a capture sent mid-storm: every connection
            # serves on until the capture's window has passed
            cap: dict = {}
            done = threading.Event()

            def capture():
                try:
                    time.sleep(0.2)
                    cap["res"] = mon.server_profile(CONTROL_CAPTURE_MS)
                    cap["t"] = time.monotonic()
                    time.sleep(CONTROL_CAPTURE_MS / 1e3)
                finally:
                    done.set()

            th = threading.Thread(target=capture, name="capture")
            th.start()
            t_fan = run_threads([lambda c=c: c.gets(CONTROL_FANIN_VERBS, VERB,
                                                    done)
                                 for c in conns], "control fan-in")
            th.join()
            res = cap.get("res")
            if not res or not res.get("path"):
                raise AssertionError(f"control: the capture was refused "
                                     f"({res})")
            deadline = time.monotonic() + 120
            trace = os.path.join(res["path"], "trace.json")
            while not os.path.exists(trace):
                if time.monotonic() > deadline:
                    raise AssertionError("control: the capture wrote no "
                                         "trace.json")
                time.sleep(0.05)
            t_trace = time.monotonic() - cap["t"]
            second = mon.server_profile(CONTROL_CAPTURE_MS)
            torch.cuda.synchronize()
            launches = fused.launches["fused_get_linear_tiered"]
            snap = reg.snapshot()
            get1 = snap["histograms"]["prof.kv.get.device_us"]["count"]
            health = dict(srv.stats)
            stats_doc = mon.server_stats()
            ctl.stop()
            knobs = ctl.knob_values()
            live = {"dwell_us": srv.flush_knobs()[0],
                    "settle_us": srv.flush_knobs()[1],
                    "window": float(conns[0].be.window)}
            cstats = dict(ctl.stats)
            moves = [r for r in tele.get().ring_tail()
                     if r.get("kind") == "ctl"]
        finally:
            if ctl is not None:
                ctl.stop()
            srv.stop()
            for c in conns:
                c.close()
            if mon is not None:
                mon.close()
            prof.note_launch = real_note
        s1 = kv.stats()
        n_kernel = trace_kernels(res["path"])
        d = {k: s1[k] - s0[k] for k in ("gets", "hits", "misses",
                                        *sm.kv_mod.MISS_CAUSE_NAMES)}
        present_misses = sum(c.present_misses for c in conns)
        n_phases = len(phases)
        widths = sorted({ph[0] for ph in phases})
        t_cap = cap["t"] + res["duration_ms"] / 1e3
        in_capture = sum(1 for ph in phases if cap["t"] <= ph[3] <= t_cap)

        # the kernel alone at each width the phases ran, on this state
        def batch(w):
            idx = torch.from_numpy(present.astype(np.int64)).to(sm.dev)
            n_never = max(1, w // 8)
            keys = torch.cat([
                sm.keys_of(CONTROL_HI, sm.pick(idx, w - n_never)),
                sm.keys_of(CONTROL_HI, torch.randint(
                    NEVER_LO, 1 << 32, (n_never,), device=sm.dev,
                    generator=sm.gen))])
            return keys[torch.randperm(w, device=sm.dev, generator=sm.gen)]

        args, kw = sm.kernel_args(kv.state)
        kern_ms = {}
        for w in widths:
            bs = [batch(w) for _ in range(8)]
            sm.compare(bs[0], kv.state, f"control w={w}")
            kern_ms[w] = time_ms(torch, [lambda k=k: fused.fused_get(
                k, *args, **kw) for k in bs], 24, device_only=True)
        # on the CPU `device_us` is the fetch's host time, which does not
        # hold the plain version's run: the lower bound is the card's
        under = [ph[:3] for ph in phases
                 if len(ph[2]) == 1 and DEVICE != "cpu"
                 and ph[2][0] < 0.9 * kern_ms[ph[0]] * 1e3]
        over = [ph[:3] for ph in phases
                if len(ph[2]) == 1 and ph[2][0] > ph[1]]
        env = knob_envelope(ctl.cfg)
        outside = {k: v for k, v in {**knobs, **live}.items()
                   if not env[k][0] <= v <= env[k][1]}
        checks = [
            (int(health["serve_errors"]) == 0,
             f"serve_errors {health['serve_errors']}"),
            (all(int(health[k]) == 0 for k in (
                "nacks_sent", "bisect_failures", "poison_ops",
                "deadline_shed")), "a phase failed"),
            # a TcpBackend never reconnects (a dropped connection raises
            # in its verb): the connections the server saw are ours alone
            (int(health["connects"]) == CONTROL_CONNS + 1,
             f"{health['connects']} connections for {CONTROL_CONNS + 1}"),
            (n_phases > 0 and launches == n_phases,
             f"{launches} fused-GET launches for {n_phases} GET phases"),
            (get1 - get0 == n_phases
             and all(len(ph[2]) == 1 for ph in phases),
             f"the profiler noted {get1 - get0} kv.get launches for "
             f"{n_phases} GET phases"),
            (not under, f"kv.get device_us under 0.9x the kernel alone: "
             f"{under[:3]}"),
            (not over, f"kv.get device_us over its phase's wall: "
             f"{over[:3]}"),
            (n_kernel > 0, f"the capture's trace holds no {TRACE_NAME} "
             f"kernel event"),
            (second is None, f"a second capture inside the cooldown was "
             f"not refused ({second})"),
            (cstats.get("windows_seen", 0) > 0,
             "the controller consumed no series window"),
            (not outside, f"knobs outside their envelope: {outside}"),
            (d["misses"] == sum(d[c] for c in sm.kv_mod.MISS_CAUSE_NAMES),
             f"misses != sum of miss causes ({d})"),
            (d["miss_digest"] == 0, "a digest miss"),
            (present_misses <= d["miss_evicted"] + d["miss_stale"]
             + d["miss_parked"], f"{present_misses} present keys missed, "
             f"more than their legal causes ({d})"),
        ]
        for ok, msg in checks:
            if not ok:
                raise AssertionError(f"control: {msg}")

        # tools/proftool.py over the pulled MSG_STATS snapshot
        import tools.proftool as proftool

        stats_path = root / "stats.json"
        stats_path.write_text(json.dumps(stats_doc))
        table = proftool.breakdown(proftool._merge(
            proftool.load_docs([str(stats_path)])))
        progs = {r["program"] for r in table["rows"]}
        if "kv.get" not in progs or not table["launches"]:
            raise AssertionError(f"control: proftool saw {progs}")

        n_keys = sum(c.keys for c in conns)
        dus = [ph[2][0] for ph in phases]
        walls = [ph[1] for ph in phases]
        by_w = {}
        for ph in phases:
            by_w.setdefault(ph[0], []).append(ph[2][0])
        log("control", f"light phase: {n_light} GET phases in "
            f"{CONTROL_LIGHT_S} s; fan-in: {CONTROL_CONNS} connections x "
            f">= {CONTROL_FANIN_VERBS} verbs of {VERB} keys in {t_fan:.3f} s; "
            f"{n_keys} keys in all, every hit byte-exact, {present_misses} "
            f"present keys missed (legal), serve_errors 0 ({smi})")
        log("control", f"GET phases {n_phases}, widths {widths}; "
            f"fused_get_linear_tiered launches {launches}; profiler kv.get "
            f"launches {get1 - get0}; kv.get device_us (CUDA events on a "
            f"card) per width: " + "; ".join(
                f"w={w}: median {np.median(v):.1f} us (kernel alone "
                f"{kern_ms[w] * 1e3:.1f} us)" for w, v in sorted(by_w.items()))
            + f"; device_us / phase wall median "
            f"{np.median(np.asarray(dus) / np.asarray(walls)):.3f} ({smi})")
        log("control", f"MSG_PROFILE capture mid-storm: {res['path']} "
            f"({res['duration_ms']} ms), trace.json written "
            f"{t_trace:.2f} s after the reply, {n_kernel} {TRACE_NAME} "
            f"kernel events for {in_capture} GET phases that ended inside "
            f"the window; a second request inside the cooldown refused")
        log("control", f"controller: {cstats.get('ticks', 0)} ticks, "
            f"{cstats.get('windows_seen', 0)} series windows, "
            f"{cstats.get('decisions', 0)} decisions, "
            f"{cstats.get('reverts', 0)} reverts; knobs at start {knobs0}, "
            f"after the light phase {knobs_light}, at the end {knobs}; "
            f"every knob inside its envelope; series windows collected "
            f"{len(collector.ring)}")
        for r in moves:
            log("control", f"knob move: {r['knob']} {r['from']} -> "
                f"{r['to']} ({r['why']})")
        log("control", "proftool over the MSG_STATS snapshot:\n"
            + proftool.render_report(table))

        # the kernel's entry at the widest width, on this state
        wmax = widths[-1]
        bs = [batch(wmax) for _ in range(8)]
        s_ = kv.state.index.table.shape[1] // 4
        nbytes = []
        for k in bs:
            causes, cold = sm.compare(k, kv.state, "control timed")
            nbytes.append(fused.fused_get_bytes(
                causes, wmax, s_, pw, kv.state.evicted_filter.numel(),
                cold_rows=cold))
        plain_ms = time_ms(torch, [lambda k=k: fused.get_core_reference(
            k, *args, **kw) for k in bs], 8, device_only=True)
        bound_ms = sum(nbytes) / len(nbytes) / HBM_BYTES_PER_S * 1e3
        log("times", f"fused_get_linear_tiered w={wmax} on the control "
            f"state, rotated over 8 batches: kernel {kern_ms[wmax]:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
            f"{bound_ms / kern_ms[wmax]:.1%} of the memory rate ({smi})")
        control_entry = {
            "name": "fused_get_linear_tiered",
            "route": "cuda",
            "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
            "replaces": "pmdfc_tpu/ops/fused.py:414",
            "launches": launches,
            "max_abs_err": sm.max_err["fused_get_linear_tiered"],
            "ms": kern_ms[wmax],
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": None,
            "path": "control",
        }
        del kv, shared, conns
    finally:
        if env0 is None:
            os.environ.pop("PMDFC_PROF", None)
        else:
            os.environ["PMDFC_PROF"] = env0
        if collector is not None:
            collector.stop()
        tele.configure()
        shutil.rmtree(root, ignore_errors=True)
    free_card(torch)

    # the harnesses on the card
    for name, args in HARNESSES:
        out = run_harness(name, args)
        log("control", f"harness {name}: " + json.dumps(
            {k: v for k, v in out.items() if not isinstance(v, (list, dict))})
            + f" ({nvidia_smi()})")
    log("control", f"phase 11 took {time.monotonic() - t_phase:.1f} s")
    return [row_entry, control_entry]


# ---------------------------------------------------------------------------
# phase 12, scale: the multi-process plane and the workload harnesses
# ---------------------------------------------------------------------------

def scale_params(label: str) -> dict:
    """What the children of one part of phase 12 run, from the module's
    constants (the children import this module afresh, so they are
    passed, not read there)."""
    solo = label == "nccl"
    return {"label": label, "device": DEVICE, "seed": 0,
            "world": 1 if solo else SCALE_PROCS,
            "per_proc": SCALE_SOLO_SHARDS if solo else SCALE_PER_PROC,
            "backend": SCALE_SOLO_BACKEND if solo else "gloo",
            "index": SCALE_SOLO_INDEX if solo else SCALE_INDEX,
            "bloom_bits": SCALE_SOLO_BLOOM_BITS if solo else SCALE_BLOOM_BITS,
            "ins_b": SCALE_INS_B, "get_b": SCALE_GET_B, "gets": SCALE_GETS,
            "bcast_b": SCALE_BCAST_B, "delete": SCALE_DELETE,
            "hi": SCALE_HI, "join_s": SCALE_JOIN_S, "timed": SCALE_TIMED}


def scale_child(rank: int, port: int, p: dict, q) -> None:
    """One process of a multi-process plane (spawned): its results, or the
    traceback of what failed, go to the parent through `q`."""
    try:
        q.put((rank, "ok", scale_drive(rank, port, p)))
    except BaseException:
        import traceback

        q.put((rank, "error", traceback.format_exc()))
        raise


def scale_drive(rank: int, port: int, p: dict) -> dict:
    global DEVICE
    DEVICE = p["device"]
    import torch

    from pmdfc_tpu_torch.ops import _build, fused
    from pmdfc_tpu_torch.parallel import shard as shard_mod

    if torch.device(DEVICE).type == "cuda":
        _build.load("fused_get")
    else:
        # the CPU rehearsal: on CPU tensors the wrapper runs the plain
        # version and counts nothing, so count its calls here; and there
        # is no stream to wait for
        torch.cuda.synchronize = lambda *a: None
        plain = fused.fused_get

        def counted(keys, *a, **kw):
            fused.launches["fused_get_linear_flat"] += 1
            return plain(keys, *a, **kw)

        fused.fused_get = counted
    ndev = shard_mod.connect_multihost(
        f"localhost:{port}", p["world"], rank, timeout_s=p["join_s"],
        backend=p["backend"], devices=[DEVICE] * p["per_proc"])
    try:
        return scale_plane(rank, ndev, p)
    finally:
        shard_mod.shutdown_multihost()


def scale_plane(rank: int, ndev: int, p: dict) -> dict:
    """Fill, delete, a2a GETs, a broadcast GET, the stats rows and the
    kernel against plain, in one process of the group; every check
    raises. -> the numbers the parent reports and compares."""
    import zlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig
    from pmdfc_tpu_torch.models.base import get_index_ops
    from pmdfc_tpu_torch.ops import fused
    from pmdfc_tpu_torch.parallel.partitioning import shard_of_np
    from pmdfc_tpu_torch.parallel.shard import (
        ShardedKV, make_mesh, pair_capacity)
    from pmdfc_tpu_torch.utils import u32

    sm = Smoke(p["seed"] + rank)
    label, hi = f"{p['label']} rank {rank}", p["hi"]
    cfg = KVConfig(index=IndexConfig(**p["index"]),
                   bloom=BloomConfig(num_bits=p["bloom_bits"]))
    pw = cfg.page_words
    skv = ShardedKV(cfg, mesh=make_mesh(), dispatch="a2a")
    n = skv.n_shards
    if ndev != n or n != p["world"] * p["per_proc"]:
        raise AssertionError(f"{label}: {ndev} devices, {n} shards")
    n_fill = 3 * skv.capacity() // 4
    alive = np.zeros(n_fill, bool)
    rng = np.random.default_rng(p["seed"])  # the same batches everywhere

    def keys_of(lo):
        lo = np.asarray(lo, np.uint32)
        return np.stack([np.full(len(lo), hi, np.uint32), lo], -1)

    def xch():
        r = skv.exchange_report()
        return np.array([r["calls"], r["bytes"], r["seconds"]])

    # the fill: a2a inserts; drops, evictions and the pair overflow
    ins_b = p["ins_b"]
    drops = overflow = 0
    x0, t0 = xch(), time.monotonic()
    for i in range(0, n_fill, ins_b):
        lo = np.arange(i, min(i + ins_b, n_fill), dtype=np.uint32)
        keys = keys_of(lo)
        res = skv.insert(keys, pages_np(hi, lo, pw))
        drops += int(res.dropped.sum())
        alive[lo[~np.asarray(res.dropped)]] = True
        ev = np.asarray(res.evicted)
        ev = ev[ev[:, 0] == np.uint32(hi), 1]
        alive[ev[ev < n_fill]] = False
        w = 16
        while w < len(lo):
            w <<= 1
        w += -w % n
        bl, own = w // n, shard_of_np(keys, n)
        c = pair_capacity(bl, n)
        for s in range(n):
            per = np.bincount(own[s * bl:(s + 1) * bl], minlength=n)
            overflow += int(np.maximum(per - c, 0).sum())
    t_fill = time.monotonic() - t0
    x_fill = xch() - x0
    n_ins = -(-n_fill // ins_b)

    # deletes, then the GETs: present, deleted, never inserted, any
    gone = rng.choice(np.flatnonzero(alive), p["delete"], replace=False)
    hit = skv.delete(keys_of(gone))
    if not hit.all():
        raise AssertionError(f"{label}: {(~hit).sum()} deletes missed")
    alive[gone] = False

    def get_batch(b):
        k = b // 8
        lo = np.concatenate([
            rng.choice(np.flatnonzero(alive), 5 * k),
            rng.choice(gone, k),
            rng.integers(NEVER_LO, 1 << 32, k, dtype=np.uint32),
            rng.integers(0, n_fill, b - 7 * k, dtype=np.uint32)])
        return rng.permutation(lo).astype(np.uint32)

    digests = []

    def check_get(lo, what):
        out, found = skv.get(keys_of(lo))
        known = lo < n_fill
        must = np.zeros(len(lo), bool)
        must[known] = alive[lo[known]]
        never = ~known | np.isin(lo, gone)
        if not found[must].all():
            raise AssertionError(f"{label} {what}: {(~found[must]).sum()} "
                                 "present keys missed")
        if found[never].any():
            raise AssertionError(f"{label} {what}: a deleted or "
                                 "never-inserted key hit")
        if not np.array_equal(out[found], pages_np(hi, lo[found], pw)):
            raise AssertionError(f"{label} {what}: a hit's page differs")
        if out[~found].any():
            raise AssertionError(f"{label} {what}: a miss is not zeroed")
        digests.append(zlib.crc32(out.tobytes(), zlib.crc32(
            found.tobytes())))
        return int(found.sum())

    batches = [get_batch(p["get_b"]) for _ in range(p["gets"])]
    bcast = get_batch(p["bcast_b"])
    fused.launches.clear()
    x0, t0 = xch(), time.monotonic()
    hits = sum(check_get(lo, f"a2a GET {j}") for j, lo in enumerate(batches))
    t_get = time.monotonic() - t0
    x_get = xch() - x0
    skv.dispatch = "broadcast"  # the same plane, its other dispatch
    hits += check_get(bcast, "broadcast GET")
    skv.dispatch = "a2a"
    launches = fused.launches["fused_get_linear_flat"]
    phases = p["gets"] + 1
    if launches != p["per_proc"] * phases:
        raise AssertionError(f"{label}: {launches} fused-GET launches for "
                             f"{phases} GET phases x {p['per_proc']} shards")
    rep, s = skv.shard_report(), skv.stats()
    causes = sm.kv_mod.MISS_CAUSE_NAMES
    if s["misses"] != sum(s[c] for c in causes) or not all(
            rep["stats"]["misses"][i] == sum(rep["stats"][c][i]
                                             for c in causes)
            for i in range(n)):
        raise AssertionError(f"{label}: misses != the sum of the causes")

    # the kernel against plain on this process's first shard, full
    st = skv.states[0]
    flat, _ = get_index_ops(cfg.index.kind).scan(st.index)
    flat = u32.to_numpy(flat)
    present = flat[flat[:, 0] == np.uint32(hi), 1]
    widths = (8, n * pair_capacity(p["get_b"] // n, n))
    for r in range(p["world"]):  # one process at a time on the card
        if r == rank:
            smi = nvidia_smi() if p["timed"] else "rehearsal"
            times = plane_kernel(sm, st, present, pw, widths,
                                 f"{p['label']} rank {rank} shard 0", smi,
                                 hi=hi, timed=p["timed"] and rank == 0)
        dist.barrier()
    return {"rank": rank, "shards": n, "n_fill": n_fill, "fill_s": t_fill,
            "drops": drops, "overflow": overflow, "inserts": n_ins,
            "x_fill": x_fill.tolist(), "gets": p["gets"],
            "get_keys": p["gets"] * p["get_b"], "get_s": t_get,
            "x_get": x_get.tolist(), "hits": hits, "launches": launches,
            "phases": phases, "digests": digests,
            "stats": {k: s[k] for k in ("puts", "gets", "hits", "misses",
                                        "evictions", "drops")},
            "widths": widths, "times": times,
            "max_err": sm.max_err.get("fused_get_linear_flat", 0)}


def scale_spawn(target, world: int, args: tuple, label: str) -> list:
    """`world` spawned processes (CUDA cannot be forked) running
    `target(rank, port, *args, q)` -> their messages in rank order. A
    worker that reports an error, dies, or outlives SCALE_TIMEOUT_S fails
    the phase; every worker is stopped on the way out."""
    import multiprocessing as mp
    import queue
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, *args, q))
             for r in range(world)]
    got = {}
    deadline = time.monotonic() + SCALE_TIMEOUT_S
    try:
        for pr in procs:
            pr.start()
        while len(got) < world:
            try:
                rank, status, body = q.get(timeout=1.0)
                got[rank] = (status, body)
                if status == "error":
                    # a peer's failure often follows from this one's: wait
                    # a little for every report, then name them all
                    end = time.monotonic() + 5.0
                    while len(got) < world and time.monotonic() < end:
                        try:
                            r, st, b = q.get(timeout=0.5)
                            got[r] = (st, b)
                        except queue.Empty:
                            pass
                    raise AssertionError("\n".join(
                        f"{label} rank {r} failed:\n{b}"
                        for r, (st, b) in sorted(got.items())
                        if st == "error"))
            except queue.Empty:
                dead = [r for r, pr in enumerate(procs)
                        if r not in got and pr.exitcode is not None]
                if dead:
                    raise AssertionError(
                        f"{label}: worker {dead[0]} died (exit code "
                        f"{procs[dead[0]].exitcode}) with no report")
                if time.monotonic() > deadline:
                    raise AssertionError(f"{label}: workers outlived "
                                         f"{SCALE_TIMEOUT_S} s")
        for r, pr in enumerate(procs):
            pr.join(timeout=60)
            if pr.exitcode != 0:
                raise AssertionError(f"{label}: worker {r} exited "
                                     f"{pr.exitcode}")
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=10)
    return [got[r] for r in range(world)]


def scale_part(label: str) -> dict:
    """One multi-process plane (part a: 2 processes over gloo; part b:
    one process in an NCCL group), checked across its processes ->
    rank 0's numbers with the launches of every rank."""
    p = scale_params(label)
    res = [body for _, body in scale_spawn(scale_child, p["world"], (p,),
                                           f"scale {label}")]
    if any(r["digests"] != res[0]["digests"] for r in res):
        raise AssertionError(f"scale {label}: the processes returned "
                             "different results")
    r0 = res[0]
    r0["launches_all"] = sum(r["launches"] for r in res)
    r0["max_err"] = max(r["max_err"] for r in res)
    ins_s, get_s = r0["fill_s"], r0["get_s"]
    xf, xg = r0["x_fill"], r0["x_get"]
    log("scale", f"{label}: {p['world']} process(es) x {p['per_proc']} "
        f"shards over {p['backend']}, {r0['shards']} shards of "
        f"{p['index']['capacity']} slots: fill {r0['n_fill']} pages in "
        f"{r0['inserts']} a2a inserts of {p['ins_b']} in {ins_s:.3f} s = "
        f"{r0['n_fill'] / ins_s:.0f} pages/s; a2a pair overflow "
        f"{r0['overflow']} rows, drops {r0['drops']}; GETs "
        f"{r0['get_keys']} keys in {get_s:.3f} s = "
        f"{r0['get_keys'] / get_s:.0f} keys/s, {r0['hits']} hits "
        f"byte-exact (broadcast batch included), every miss zeroed, "
        f"identical on every process; exchange per insert "
        f"{xf[1] / r0['inserts']:.0f} bytes sent, "
        f"{xf[2] / r0['inserts'] * 1e3:.2f} ms ({xf[0] / r0['inserts']:.0f} "
        f"collectives); per GET {xg[1] / r0['gets']:.0f} bytes, "
        f"{xg[2] / r0['gets'] * 1e3:.2f} ms; fused-GET launches "
        f"{r0['launches_all']} over every process for {r0['phases']} GET "
        f"phases; stats {r0['stats']} ({nvidia_smi()})")
    return r0


def scale_refuse_child(rank: int, port: int, device: str, q) -> None:
    """One of two NCCL ranks naming the same card: the join must refuse."""
    from pmdfc_tpu_torch.parallel import shard as shard_mod

    try:
        shard_mod.connect_multihost(f"localhost:{port}", 2, rank,
                                    timeout_s=SCALE_JOIN_S, backend="nccl",
                                    devices=[device])
    except shard_mod.SharedDeviceError as e:
        q.put((rank, "refused", str(e)))
        return
    except BaseException:
        import traceback

        q.put((rank, "error", traceback.format_exc()))
        raise
    shard_mod.shutdown_multihost()
    q.put((rank, "error", "two NCCL ranks on one card joined"))


def scale_refusal() -> None:
    got = scale_spawn(scale_refuse_child, 2, (DEVICE,), "scale nccl x2")
    log("scale", f"nccl with two ranks on one card: both refused with "
        f"SharedDeviceError before any collective ({got[0][1][:120]})")


def run_harnesses(runs, lanes: int) -> list:
    """Harness processes, `lanes` side by side -> their rows in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(lanes) as ex:
        futs = [ex.submit(run_harness, name, args) for name, args in runs]
        return [f.result() for f in futs]


def harness_check(name: str, args, row: dict) -> str:
    """The harness's own correctness gate on its row -> what held."""
    fails = []
    if name == "multihost_bench":
        if row["hits"] != row["n"] or row.get("wrong_values"):
            fails.append(f"hits {row['hits']} of {row['n']}")
    elif name == "test_kv":
        if row["failed_search"] != 0:
            fails.append(f"failed_search {row['failed_search']}")
    elif name == "paging_sim" and row.get("job") == "scan_mix":
        for arm in ("admit_on", "admit_off"):
            if row[arm]["verify_failures"]:
                fails.append(f"{arm} verify_failures")
            row[f"{arm}_zipf_hit_rate"] = row[arm]["zipf_hit_rate"]
            row[f"{arm}_get_p99_us"] = row[arm]["get_p99_us"]
    elif name == "replay":
        if row["wrong_values"]:
            fails.append(f"wrong_values {row['wrong_values']}")
    elif name == "multinode":
        if row["errors"] or row["ok"] != row["clients"]:
            fails.append(f"client errors {row['errors']}")
    if row.get("verify_failures"):
        fails.append(f"verify_failures {row['verify_failures']}")
    if row.get("device") != torch_device_type():
        fails.append(f"ran on {row.get('device')}")
    if fails:
        raise AssertionError(f"harness {name} {' '.join(args)}: "
                             + "; ".join(fails))
    keep = ("value", "unit", "insert_mops", "hits", "n", "failed_search",
            "found", "verify_failures", "cc_hits", "disk_reads", "iops",
            "swap_hits", "pages_per_sec", "read_mib_per_sec", "read_hits",
            "read_misses", "wrong_values", "evictions", "ok",
            "total_pages_per_sec", "secs", "exchange_bytes",
            "exchange_seconds", "p99_batch_ms", "admit_on_zipf_hit_rate",
            "admit_off_zipf_hit_rate", "admit_on_get_p99_us",
            "admit_off_get_p99_us", "hit_rate_ratio_on_vs_off")
    return json.dumps({k: row[k] for k in keep if k in row})


def torch_device_type() -> str:
    import torch

    return torch.device(DEVICE).type


def scale_entry(r: dict, path: str) -> dict:
    widest = r["widths"][-1]
    ms, plain_ms, bound_ms = r["times"].get(widest, (None,) * 3)
    return {"name": "fused_get_linear_flat", "route": "cuda",
            "source": "pmdfc_tpu_torch/ops/csrc/fused_get.cu",
            "replaces": "pmdfc_tpu/ops/fused.py:414",
            "launches": r["launches_all"], "max_abs_err": r["max_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None, "path": path}


def run_scale(sm: Smoke):
    """The multi-process plane and the workload harnesses (phase 12).
    -> the kernel entries of its two multi-process planes."""
    t_phase = time.monotonic()
    free_card(sm.torch)
    gloo = scale_part("gloo")
    solo = scale_part("nccl")
    scale_refusal()
    rows = run_harnesses(SCALE_HARNESSES, SCALE_HARNESS_LANES)
    for (name, args), row in zip(SCALE_HARNESSES, rows):
        log("scale", f"harness {name} {' '.join(args)}: "
            f"{harness_check(name, args, row)} ({nvidia_smi()})")
    log("scale", f"phase 12 took {time.monotonic() - t_phase:.1f} s")
    return [scale_entry(gloo, "scale-gloo"), scale_entry(solo, "scale-nccl")]


# ---------------------------------------------------------------------------
# phase 13, tail: the bench tail's harnesses on the card
# ---------------------------------------------------------------------------

def uncounted(fused, fn):
    """Run `fn` and take back the fused-GET launches it made: the launches
    that compare a kernel with its plain version do not count."""
    before = dict(fused.launches)
    try:
        return fn()
    finally:
        fused.launches.clear()
        fused.launches.update(before)


def tail_kernel(sm, kv, keys, label: str, smi):
    """Kernel against plain on a harness's full-size state at TAIL_WIDTHS,
    on batches of its inserted keys with an eighth never inserted, timed
    at each -> {w: (ms, plain_ms, bound_ms)} (these launches uncounted)."""
    torch = sm.torch
    n = len(keys)
    present = torch.from_numpy(keys.view(sm.np.int32)).to(sm.dev)

    def batch(w):
        n_never = max(1, w // 8)
        lo = torch.randint(n + 1, 1 << 30, (n_never,), device=sm.dev,
                           generator=sm.gen)
        never = torch.stack([lo >> 16, lo], -1).to(torch.int32)
        keys_w = torch.cat([sm.pick(present, w - n_never), never])
        return keys_w[torch.randperm(w, device=sm.dev, generator=sm.gen)]

    return uncounted(sm.fused, lambda: plane_kernel(
        sm, kv.state, None, kv.config.page_words, TAIL_WIDTHS, label, smi,
        batch=batch))


def tail_check(name: str, row: dict) -> str:
    """A tail harness's own gates on its row (beyond its exit code) ->
    what held."""
    fails = []
    for k in ("wrong_bytes", "serve_errors", "verify_failures",
              "mismatches", "deleted_hits", "conformance_violations"):
        if row.get(k):
            fails.append(f"{k} {row[k]}")
    if name == "recovery_soak":
        if row["miss_recovering"] <= 0 or row["pages_lost"] > row["rpo_bound"]:
            fails.append(f"miss_recovering {row['miss_recovering']}, lost "
                         f"{row['pages_lost']} of bound {row['rpo_bound']}")
    elif name == "replica_soak":
        if row["hit_rate_ratio"] < 0.8:
            fails.append(f"hit_rate_ratio {row['hit_rate_ratio']}")
    elif name == "containment_soak":
        iso = row["isolation"]
        if iso["poison_ops"] != 1 or iso["bisect_failures"] > row["bound"] \
                or not row["readmitted"] or row["proof"]["poison_ops"]:
            fails.append(f"isolation {iso}, readmitted {row['readmitted']}, "
                         f"proof {row['proof']}")
    elif name == "qos_soak":
        if not row["miss_shed"] or row["lanes"]["good"].get("shed_edge"):
            fails.append(f"miss_shed {row['miss_shed']}, lanes "
                         f"{row['lanes']}")
    elif name == "train_pressure":
        if not row["loss_last"] < row["loss_first"]:
            fails.append(f"loss {row['loss_first']} -> {row['loss_last']}")
    elif name == "soak":
        if not (row["clean_cache_invariant_ok"] and row["causes_ok"]):
            fails.append("clean-cache invariant or miss causes broken")
    if row.get("device") != torch_device_type():
        fails.append(f"ran on {row.get('device')}")
    if fails:
        raise AssertionError(f"harness {name}: " + "; ".join(fails))
    skip = ("rows", "lanes", "client", "tier", "teledoc")
    return json.dumps({k: v for k, v in row.items() if k not in skip})


def tail_harness(name: str, args, tmp: str):
    """One tail harness as its own process -> (its last JSON row, with the
    rows it wrote to `--out` for the harnesses in TAIL_ROWS; seconds)."""
    t0 = time.monotonic()
    out = os.path.join(tmp, f"{name}.json")
    extra = ("--out", out) if name in TAIL_ROWS else ()
    row = run_harness(name, (*args, *extra))
    if extra:
        with open(out) as f:
            row["rows"] = json.load(f)["rows"]
    return row, time.monotonic() - t0


def tail_log(name: str, args, row: dict, secs: float) -> None:
    log("tail", f"harness {name} {' '.join(args)} ({secs:.1f} s): "
        f"{tail_check(name, row)} ({nvidia_smi()})")
    keep = ("transport", "n_shards", "value", "unit", "p50_us", "p95_us",
            "gets_per_s", "cpu_us_per_get")
    for r in row.get("rows", ()):
        log("tail", f"  {name} row {r['metric']}: "
            + json.dumps({k: r[k] for k in keep if k in r}))


def run_tail(sm):
    """The bench tail (phase 13): fused_get and tier_sweep in this
    process, their launches counted, then mesh_sweep; the soak and the
    host-bound harnesses side by side in lanes from the start. -> the
    kernel entries of its path."""
    import argparse
    from concurrent.futures import ThreadPoolExecutor

    from pmdfc_tpu_torch.bench import fused_get as fg
    from pmdfc_tpu_torch.bench import tier_sweep as ts

    fused, torch = sm.fused, sm.torch
    t_phase = time.monotonic()
    free_card(torch)
    smi = nvidia_smi()
    times = {}
    with ThreadPoolExecutor(TAIL_LANES) as ex, \
            tempfile.TemporaryDirectory() as tmp:
        lanes = [ex.submit(tail_harness, name, args, tmp)
                 for name, args in TAIL_LANE_RUNS]
        fused.launches.clear()
        for fam, cap in TAIL_FUSED:
            t0 = time.monotonic()
            args = argparse.Namespace(
                capacity=cap, families=[fam], seed=sm.seed, device=DEVICE,
                out=None, history=None, smoke=False, **TAIL_FUSED_ARGS)

            def keep(f, kv, keys):
                times[variant_of(kv.state)] = tail_kernel(
                    sm, kv, keys, f"tail fused_get {f}·flat", smi)

            out = fg.run(args, keep=keep)
            for r in out["sweeps"]:
                log("tail", f"fused_get {fam}·flat zipf {r['zipf']} batch "
                    f"{r['batch']}: kernel side {r['ms_fused']:.4f} ms, "
                    f"composed chain {r['ms_composed']:.4f} ms per GET "
                    f"(CUDA event window) = "
                    f"{r['speedup_fused_vs_composed']}x; {r['hits']} hits "
                    f"of {r['gets']}, parity bit for bit on every batch, "
                    f"one launch per kernel-side GET, none composed ({smi})")
            free_card(torch)
            log("tail", f"fused_get {fam}·flat took "
                f"{time.monotonic() - t0:.1f} s (its fill "
                f"{out['sweeps'][0]['fill_s']} s)")
        t0 = time.monotonic()
        args = argparse.Namespace(seed=sm.seed, device=DEVICE, out=None,
                                  history=None, smoke=False,
                                  **TAIL_TIER_ARGS)

        def keep_tier(kv, keys):
            times[variant_of(kv.state)] = tail_kernel(
                sm, kv, keys, "tail tier_sweep linear·tiered", smi)

        out = ts.run(args, keep=keep_tier)
        for r in out["sweeps"]:
            log("tail", f"tier_sweep zipf {r['zipf']}: tiered "
                f"{r['stream_mops_tier']} Mops/s, flat "
                f"{r['stream_mops_flat']} Mops/s (KV.get, host clock); hot "
                f"gather {r['hot_gather_us_tier']} vs "
                f"{r['hot_gather_us_flat']} us (CUDA events); hits "
                f"{r['hits_tier']} / {r['hits_flat']}, every hit byte-exact, "
                f"every miss zeroed, misses == sum of causes; promotions "
                f"{r['tier']['promotions']} ({smi})")
        launches = dict(fused.launches)
        free_card(torch)
        log("tail", f"tier_sweep took {time.monotonic() - t0:.1f} s")
        for want in times:
            if not launches.get(want):
                raise AssertionError(f"tail: {want} was never launched")
        log("tail", f"fused-GET launches of the in-process sweeps: "
            f"{launches}")
        for name, args in TAIL_SERIAL:
            tail_log(name, args, *tail_harness(name, args, tmp))
        log("tail", f"main thread done at {time.monotonic() - t_phase:.1f} s")
        for (name, args), f in zip(TAIL_LANE_RUNS, lanes):
            tail_log(name, args, *f.result())
    log("tail", f"phase 13 took {time.monotonic() - t_phase:.1f} s")
    return [plane_entry(sm, "tail", launches[name], t[TAIL_TIMED_W], name)
            for name, t in times.items()]


T0 = time.monotonic()  # the smoke's start: phase times are logged from it


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--row-kv", action="store_true",
                    help="run only the row-path KV of phase 11 (the child "
                         "process phase 11 starts with PMDFC_INSERT_PATH=row)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    from pmdfc_tpu_torch.ops import _build

    if args.row_kv:
        _build.load("fused_get")
        print("ROWKV " + json.dumps(run_row_kv(Smoke(args.seed))),
              flush=True)
        return 0

    # 1. env
    smi = nvidia_smi()
    log("env", smi)
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvcc: {nvcc_v.splitlines()[-1]}")

    # 2. build: nvcc and g++ side by side, then load
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(_build.build, "fused_get"),
                  ex.submit(_build.build_host, "runtime")]:
            f.result()
    _build.load("fused_get")
    _build.load_host("runtime")
    log("build", f"fused_get (nvcc) and the engine (g++) built and loaded "
        f"in {time.monotonic() - t0:.2f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        for line in out.strip().splitlines():
            log("build", f"{name}: {line.strip()}")

    sm = Smoke(args.seed)

    # 3. kernel against plain, small states, flat then tiered
    for tiered in (False, True):
        pool_name = "tiered" if tiered else "flat"
        for kind, s in (("linear", 16), ("linear", 32), ("cceh", 16),
                        ("cceh", 32)):
            kv, pool, present, covers = sm.small_state(kind, s, tiered)
            sm.kernel_phase(kv, pool, present, covers,
                            f"small {kind}·{pool_name} S={s}")
            del kv
        # the LSB directory: extendible hashing serves through the
        # composed GET, so its state is held here by calling the wrapper
        # with msb=False
        kv, pool, present, covers = sm.small_state("extendible", 32, tiered)
        assert not kv.state.index.msb
        sm.kernel_phase(kv, pool, present, covers,
                        f"small extendible·{pool_name} (msb=False)")
        del kv
    torch.cuda.empty_cache()

    # 4 and 5, one path at a time: each KV is freed before the next fill
    kernels = []
    log("smoke", f"phases 1-3 took {time.monotonic() - T0:.1f} s")
    for label, run in (
            ("linear", run_linear), ("cceh", run_cceh),
            ("linear·tiered", lambda sm: run_tiered(sm, "linear")),
            ("cceh·tiered", lambda sm: run_tiered(sm, "cceh")),
            ("families", run_families), ("serve", run_serving),
            ("wire", run_wire), ("fleet", run_fleet), ("plane", run_plane),
            ("control", run_control), ("scale", run_scale),
            ("tail", run_tail)):
        t0 = time.monotonic()
        entry = run(sm)
        log("smoke", f"{label} took {time.monotonic() - t0:.1f} s, "
            f"{time.monotonic() - T0:.1f} s since the start")
        if isinstance(entry, list):  # the plane's, control's, scale's, tail's
            kernels.extend(entry)
        elif entry is not None:  # the families launch no kernel of their own
            kernels.append(entry)
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
