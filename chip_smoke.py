#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails loudly (exit code 1, no result line):
  1. print the card's name and power limit; build every hand kernel
     from the sources in the checkout (gf_apply.cu, csum.cu and
     placement.cu, one nvcc each) and the native host library
     (native/ec_tpu.cpp, g++, always anew), all started together;
  2. hold each kernel bit-exact against its plain PyTorch version on
     the card, at the main path's shapes and at odd ones (CRC32C at
     L in {0, 1, 7, 8, 9, 63, 64, 65, 4093, 4096, 524288} and B in {1,
     3, 32, 352} for both seed conventions and crc32c_extend, row views
     at offsets 1, 2, 3, 4, 8 and more from the 16-byte grid with odd
     pitches, the RMW delta's 64 and 96 rows of 4093 bytes, few long
     rows, and crc32c_sets launches of 2, 3 and 4 sets of mixed L and
     seeds; XXH32 and XXH64 at 13 lengths and seeds 0 and 42,
     misaligned row views included; a sample of rows against the
     reference oracle; the placement scorer at 31 cases (SCORE_CASES:
     N of 64, 129, 1000 and 262,144, U of 1 to 5000, so both the walk
     instance and the scan instance above 4096 targets, 2S of 6, 22
     and 32, topk 1 to 8; targets in random order and in the
     balancer's deviation order, integer deviations, rounding-collapsed
     gains, all-illegal blocks, rows whose first 128 targets clash,
     inf and NaN deviations), indices and float32 scores bit for bit
     (any NaN equal to any NaN), each case launched twice, the second
     time through the counting entry, whose targets visited a row must
     be score_visits_plain's);
  3. drive the main path at full width: RS k=8 m=3 over 1024 objects
     of 4 MiB (data made on the card from a seeded torch.Generator),
     in batches of 32: fused write (parity + 11 hinfo CRCs per object),
     lose shards 0 and 9, fused recovery on the first 8 survivors with
     the helper-fold verify, decode_concat of one batch; check against
     the write-time bytes and CRCs, the numpy oracle and the CRC
     reference, and check that the kernels were launched;
  4. time each kernel and its plain version with CUDA events around a
     run of back-to-back calls (warm, median per call), each kernel's
     device time per launch in a torch.profiler trace (from CUDA
     events behind a device sleep where three traces lose every
     record, marked in `device_ms_from`) and the host's time per call, and the end-to-end encode GB/s, decode GB/s and
     recovery objects/s one call at a time, host overhead included;
  5. drive the PG backend the way its users do, at the same width:
     ECBackend.write_objects of 256 seeded 4 MiB objects in groups of
     32, read_objects of all of them, a degraded read with shards 0
     and 9 down, one flipped byte in a helper shard, recover_shards
     of shards 0 and 9 through RecoveryRunner (batch 32), repair_pg
     and a clean deep_scrub, one RMW delta wave over 32 objects with
     ragged windows (5 bytes at 3, 4093 bytes at 1 MiB + 7), and a
     stripe-journal replay; every check bit-exact;
  6. CRUSH placement at BASELINE config #5 (tools/crush_10m.py's map:
     10,000 OSDs, 10 per host, 25 hosts per rack, the EC indep host
     rule, numrep 11, full weights) through the VectorMapper on the
     card: do_rule on 10,000 seeds, 2,000 sampled lanes held bit for
     bit against the scalar OracleMapper; scan_rule over 10,000,000
     placements, whose XOR digest must be the JAX package's
     (CRUSH_10M.json); an OSDMap pool at pg_num 131072 mapped with one
     pgs_to_up, 2,000 PGs held against pg_to_up_acting_osds;
  7. the cluster's failure path at full width: SimCluster with 48 OSDs
     in 12 hosts, 64 PGs of RS k=8 m=3, 256 seeded 4 MiB objects;
     kill an OSD until the map marks it down (degraded reads bit-exact),
     destroy it and tick past down_out_interval (out -> CRUSH remap ->
     recover_shards onto the new acting sets, timed and traced), then
     kill another, write 32 objects while it is down and revive it
     before it goes out (the PG-log replay); every read bit-exact;
  8. BASELINE configs #3 and #4 through ECBackend and RecoveryRunner
     (batch 32) at 256 seeded 4 MiB objects each: LRC k=8 m=4 l=4 (15
     shards) loses data_positions[0] and rebuilds it from its local
     group of 4 (lrc_local, 4 x 512 KiB per object on the wire), then
     two shards of that group (lrc_multi), a degraded read and a clean
     deep_scrub; Clay k=8 m=4 d=11 (64 sub-chunks of 8 KiB) loses shard
     0 with one byte flipped inside a shipped repair plane of one helper
     and one outside them in another, and rebuilds it from the repair
     planes alone (range batches, 11/32 of k chunks on the wire, both
     flips flagged at the source; traced for the device's idle share),
     then shards 0 and 9 through decode_chunks (clay_full), a degraded
     read and a clean deep_scrub; SHEC k=4 m=3 c=2 writes 32 objects,
     rebuilds a shard (shec_cost) and reads degraded. Every rebuilt
     shard and hinfo equals the write's, every read is bit-exact, and
     gf_apply must have launched;
  9. BlueStore block checksums and streaming: Checksummer for all five
     algorithms over 1 GiB of seeded data on the card (256 x 4 MiB
     objects, block_size 4096: 262,144 blocks a call), each held against
     the kernels' plain versions on the card and a sample of 256 blocks
     against the oracle, verify with two flipped bytes reporting the
     first one's offset; StreamingCodec (RS k=8 m=3, tile 8 MiB, depth
     2 and 3) over a pinned host stripe of 4 x 8 x (64 MiB + 777 B),
     held against one apply of the whole stripe on the card, its
     host-to-host GB/s beside a pinned host-to-device copy of the same
     bytes; make_tiled_encoder at (32, 8, 4 MiB) with a 1 MiB tile
     against the one-shot encode;
 10. the mgr's upmap balancer at 10k OSDs / 1M PGs (BALANCER_10K.json's
     configuration: tools/scale_sim.py's heavy-half map, 10,000 OSDs,
     8 a host, 16 hosts a rack, replicated size 3 over hosts, pg_num
     1,048,576, the first half of the devices at twice the CRUSH
     weight): the pool's raw mapping through the VectorMapper in 16
     launches of 65,536 lanes, then batch_calc_pg_upmaps (max_src and
     max_dst 512, a budget of 65,536 moves) under torch.profiler, its
     scorer on the card; its moves, rounds, candidates, spreads and
     the sha256 digests of its moves and proposed upmaps must be the
     JAX package's (BALANCER_10K.json), the budget must hold, 2,000
     sampled PGs' up sets after the upmaps land must be
     pg_to_up_acting_osds', and the first and the last scorer launch
     must equal the plain version on the card; prints the mapping time,
     the scorer's device ms a launch at the last launch's inputs, its
     launches, the targets its rows visit (score_visits_plain, held
     equal to the kernel's own count) and the bound they give, the host
     greedy's time and the device's idle share;
 11. phase 7's scenario over persistent TinStores in a temporary
     directory (removed afterwards): the revive is a real remount from
     the OSD's WAL, then a bare remount of the fullest store, a clean
     deep scrub of every PG and the reads once more; then 32
     compressible 4 MiB objects (a seeded 64 KiB block repeated)
     through zlib-compressed TinStores, which must store fewer bytes
     than they are given and read back exact after a remount. It
     fails unless the native library built in phase 1 serves TinDB's
     CRC32C on SSE4.2. Host-bound by design (a 32 KiB cache: every
     read a pread);
 12. the client tier over phase 7's cluster, through the entry points
     users call: rados bench's defaults (-b 4194304 -t 16), 256 x 4 MiB
     through IoCtx.aio_write_full (traced for the device's idle share)
     and aio_read, 16 in flight; a 1 GiB RBD image at Ceph's default
     layout (order 22, stripe_count 1) written whole in 4 MiB writes,
     then 1,024 fio-style random 4 KiB writes at 4 KiB-aligned seeded
     offsets with snap_create after 512 and, after 768, the primary
     OSD of a PG holding image objects killed: reads in the gap served
     degraded (op_degraded, decode launches), the map marks it down and
     later ops retarget (op_resend); the head and the snapshot read
     back; FsClient at the JAX package's layout, a 256 MiB file in 4 MiB
     writes and a directory of 2 x frag_split_threshold files that must
     split; RGW, 64 x 1 MiB objects and a multipart upload of 8 x 8 MiB,
     a request signed through rgw/auth accepted and a tampered one
     refused; then a tick past down_out_interval (out, remap,
     recovery), every byte read again and a clean deep scrub of every
     PG. Every read is held byte for byte against a host model; it
     fails unless gf_apply launched the 4 KiB overwrites' delta shape
     (1, 3, 4096) and a decode, and the CRC32C kernel launched;
 13. the (dp, shard) mesh (ceph_tpu_torch/parallel/): one spawned rank
     a card over NCCL (parallel.distributed.init_process), at mesh (1,
     cards) (default_mesh) and, on an even number of cards above one,
     host_mesh(shard=cards // 2), (2, 2) on four; on one card the mesh
     is (1, 1) and its all-gathers move no bytes. On each: the sharded
     RS k=8 m=3 encode of 32 x 4 MiB objects a dp row (global_batch
     in) and its decode of shards 0 and 9, LRC k=8 m=4 l=4's local
     repair of data_positions[0] and Clay k=8 m=4 d=11's repair of
     shard 0 from its 11 helpers' repair planes; every rank's block
     gathered to rank 0 (replicas must agree) and held bit for bit
     against the single-card make_encoder result, the RS parity against
     the numpy oracle on a sample; the byte counters against the
     layout (encode moves nothing, a gather only the wanted slots,
     Clay's helpers a quarter of their rows); each rank's gf_apply
     launches (fails at 0); for each step the bytes a rank received
     and sent, the step's ms (CUDA events), gf_apply's and NCCL's
     device ms in a utils/tracing trace, and the all-gather alone at
     the step's shape by CUDA events, with its GB/s beside its bound at
     450 GB/s each way on NVLink. Any rank's failure fails the phase;
 14. the wire tier (osd/standalone.py): after the kernels and the native
     library are built and the card is touched, a StandaloneCluster of
     12 OSD daemons, three Paxos monitors and a client over AES-GCM
     sessions (secret from os.urandom; op_window 16, op_timeout 3.0 as
     tools/rados_bench.py gives its standalone writes; heartbeat grace
     SA_GRACE, SA_KILL_GRACE from the kill on, and no cephx: see
     SA_CEPHX), pg_num 32 of RS k=8 m=3 over 512 KiB chunks, every
     interaction a frame on the Messenger, every encode, delta, decode
     and CRC on the card: 32 x 4 MiB objects written 16 at a time
     (traced for the device's idle share) and read back with read_many,
     16 seeded 4 KiB write_at overwrites (the parity delta over
     rmw_fetch frames), an OSD holding shards killed, 8 degraded reads
     (of objects whose primary lives), wait_for_down, wait_for_clean
     (120 s; recovery staged from readv frames), every byte read again
     against a host model and a deep scrub of every PG. Prints write
     and read GB/s, write_at ops/s, kill -> down seconds and the last
     recovered object's seconds after the down mark (a watcher
     thread's), recovered objects/s and recover_wire_bytes, the
     messengers' frames and bytes, gf_apply's and CRC32C's launches by
     shape; fails unless gf_apply launched an encode, the (1, 3, 4096)
     delta and a decode, CRC32C launched, recovery staged a readv
     frame, every read is exact and the scrub is clean;
 15. one process an OSD (osd/multiproc.py), then the last modules in
     this process: (a) phase 14's cluster with each OSD daemon its own
     OS process on the card (12 children, the monitors and the client
     here), over cephx and AES-GCM, TinStores in a temporary directory,
     booted at the JAX package's default 1.2 s heartbeat grace, or at
     the next of SP_GRACES after a boot that storms (a live OSD marked
     down+out, PGs not clean in 120 s, an OSD without its osd ticket
     after 40 s), every child on the cluster's device, every PG clean
     and one config epoch folded without a suspect; (b) 128 x 4 MiB
     written 16 at a time (the card's utilization sampled by nvidia-smi
     meanwhile, each child's CPU seconds from /proc), read back, 128
     seeded 4 KiB write_at overwrites, a SIGKILL of an OSD holding
     shards, its down mark and recovery by the survivors, every byte
     read again against a host model, a deep scrub of every PG (every
     shard checked), the victim revived as a fresh child over its
     TinStore (WAL remount) and every byte read once more; (c) the
     children's own launch counts over their `launches` line (the
     victim's read before the kill), which must show gf_apply encodes,
     the (1, 3, 4096) delta and decodes, and CRC32C; (d) the workload
     engine over the same cluster with WORKLOAD_r20.json's four tenants,
     seed and duration, every stream digest the artifact's; (e) the
     seeded thrasher (seed 42, one round of five ops, in this process),
     its invariants held and its schedule's sha256 printed; (f) the
     writeback cache tier over SimClusters on the card (an RS k=8 m=3
     base, a replicated size=2 cache, 64 x 4 MiB at a 64 MiB target):
     every read exact through the tier and from the base after
     flush_evict_all, the base's flushes gf_apply encodes; (g) the EC
     runtime server behind the native shim: NativeReedSolomon k=8 m=3
     encodes 8 x 8 x 512 KiB and decodes shards 0 and 9 through it,
     the bytes the shim's own CPU codec's and the server's gf_apply
     launches counted (the shim falls back to the CPU in C on any
     socket failure); (h) phase 16's live ceph commands (TOOLS_LIVE)
     over this cluster's admin sockets, before its shutdown;
 16. the operator tools (ceph_tpu_torch/tools/), each through its
     main(argv) in this process with no --device (the card): crushtool
     --test at its own 10,000-OSD example (100,000 inputs, 11
     replicas, two OSDs out), the first 2,000 inputs the --oracle's
     (six `python -m` processes on the CPU, overlapping the rest of the
     phase), the map through -o, -d and -c unchanged; osdmaptool --createsimple 10000 --pool-pgs
     65536, --test-map-pgs, --upmap in batch mode with --save (a
     scorer launch a round), and a 1,000-OSD map's upmap file the
     plain (CPU) path's; rados put/ls/stat/get/rm of 16 x 4 MiB, every
     get exact, and one put as `python -X importtime -m` (beside the
     rest) that loads no JAX and reads back exact;
     rbd: a 256 MiB image, 64 MiB imported, snap, protect, clone,
     flatten, exports and diffs against a host model;
     ceph-objectstore-tool demo and inspect, then fsck of every
     TinStore of phase 11's cluster shape after 16 x 4 MiB; the ceph
     CLI's status, df, pg stat, balancer and tier at phase 7's
     cluster, and the live commands of phase 15 (h); the thrash
     reproducer (seed 42, TinStores, one round), its schedule's sha256
     the twin's. Logs each tool's host seconds; fails on a non-zero
     exit, a read that differs, or no launch of gf_apply, CRC32C or
     the scorer.
Phases 3, 5, 7, 8, 9, 11, 12, 14, 15 and 16 print the CRC32C kernel's
launches and fail if there are none; phase 9 also needs XXH32, XXH64 and
gf_apply launches, phase 10 a scorer launch a round, phase 16 gf_apply
and scorer launches.
Phase 4 also times the checksum kernels at the main path's shapes
(CRC32C over 256 and 352 rows of 512 KiB, the fused write's and the
recovery program's launches of two row sets, the RMW delta's 4093-byte
rows alone and as its one launch, 1, 8 and 16 rows of 512 KiB and
one object's fused write of 8 + 3 rows;
XXH32 and XXH64 over 262,144 rows of 4 KiB) the way gf_apply's rows
are timed, beside their plain versions and their bytes bound, and
fails unless one call of the fused write, the fused RMW delta or the
recovery program launches the CRC32C kernel exactly once. Phases 3,
5, 7, 8 and 9 print the CRC32C launches by shape (B, L, vec a row
set), which the kernels line carries.
Phase 2 holds gf_apply at the LRC and Clay matrices (Clay's also at
the backend's (32, k, 8192)), a matrix with one non-zero coefficient,
a row group with no entry, schedules whose shared-memory chunks pass 48
KiB, and a two-chunk schedule whose blocks walk several tiles, and
fails unless its cases reach the kernel's three ways to its
coefficient words (global memory, shared memory staged once, chunk by
chunk). Phase 4 holds it against its plain version and times it at
every row of PERF.md's kernel table (RS k=8 m=3 encode and decode, the
one-loss rebuild at 1 and 32 objects, the ragged RMW delta, phase 12's
4 KiB and 64 KiB deltas of one data shard, LRC's global layer and local
repair, Clay's encode,
repair and two-loss decode and SHEC's encode at the shapes of phase
8): ms per call, device ms per launch from a trace that must show
every launch, host microseconds per call, beside its plain version and
impl=mxu. Phases 3, 5, 7, 8, 11 and 12 print gf_apply's launches by (k,
m, L, vec).

    python3 chip_smoke.py --gf-times

prints the card and one JSON object of phase 4's kernel rows (without
the plain versions), and nothing else: copied into an older checkout,
it times that checkout's gf_apply with the same method.

    python3 chip_smoke.py --crc-times

does the same for phase 4's CRC32C rows (the multi-set rows only where
the checkout has crc32c_sets) and adds the microbenchmark of the CRC
kernel's parts (tools/crc_microbench.cu: the loads alone, the shared
and the lane-private tables' lookups alone, the lane-private lookups
on the kernel's loads) with each part's instructions a byte from
`cuobjdump -sass`.

    python3 chip_smoke.py --fold-times

builds xor_fold.cu and prints phase 4's XOR fold rows (FOLD_ROWS: the
recovery program's helper stacks of the RS k=8 m=3 and the Clay k=8 m=4
d=11 recovery cells, 128 objects each; FOLD_RAGGED: 4,093-byte rows on
the kernel's byte-place instance): device ms a launch, ms and host us a
call, the bytes bound and the share, and the plain torch loop's ms.
Phase 4 times the same rows in the full run, and fails unless one call
of the recovery program launches the fold kernel exactly once; phase 3
fails unless the main path launches it once a recovery call.

    python3 chip_smoke.py --score-times [PARENT_PLACEMENT_CU]

prints the placement scorer's rows (SCORE_ROWS at N = 262,144, 2S = 6,
U = 512, topk 8: the balancer's target order, the same rows with the
targets shuffled, phase 2's unsorted integer deviations, and rows whose
first 128 targets clash; then phase 10's last launch, after phase 10's
balancer run and its checks): device ms a launch, ms a call, plain ms,
the targets a row visits, the bound and the share, and the SASS loops
of the 2S = 6 instances. Given an older placement.cu (its C entry
score_candidates has kept its signature, e.g. `git show
<commit>:ceph_tpu_torch/mgr/csrc/placement.cu` into a file), it builds
that too, side by side, and times it on the same inputs.

    python3 chip_smoke.py --client

builds gf_apply.cu and csum.cu and runs phase 12 alone, with its gates,
then prints the card and one JSON object of its results.

    python3 chip_smoke.py --mesh

does the same for phase 13 (gf_apply.cu only): on one card a (1, 1)
mesh; on a host with four cards, NCCL across them at (1, 4) and (2, 2).

    python3 chip_smoke.py --standalone

builds gf_apply.cu, csum.cu and the native library and runs phase 14
alone, with its gates, then prints the card and one JSON object of its
results.

    python3 chip_smoke.py --osd-procs

does the same for phase 15.

    python3 chip_smoke.py --tools

builds every kernel and the native library and runs phase 16 alone (its
live commands over a StandaloneCluster of 8 OSDs booted for them), with
its gates, then prints the card and one JSON object of its results.
The full run logs each phase's seconds before its kernels line. The
line before the last is a JSON object with one entry per kernel;
the last line is {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of ceph_tpu, and needs one card.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

SEED = 20261017
K, M = 8, 3
OBJECT_SIZE = 4 << 20
N_OBJECTS = 1024
N_BACKEND = 256
BATCH = 32
LOST = (0, 9)
PROFILE = f"plugin=jerasure technique=reed_sol_van k={K} m={M}"

# BASELINE config #5 (tools/crush_10m.py): its map, rule and lanes
CRUSH_OSDS = 10_000
CRUSH_NUMREP = K + M
CRUSH_PLACEMENTS = 10_000_000
CRUSH_SUB = 1_000_000        # lanes per scan_rule batch
CRUSH_LANES = 10_000         # lanes of one do_rule call
CRUSH_SAMPLE = 2_000         # lanes and PGs held against the oracle
# the JAX package's scan_rule digest over seeds 0 .. 10,000,000 - 1
# (CRUSH_10M.json, "digest"; the digest does not depend on the batch
# size the placements are split into)
CRUSH_DIGEST = 12828
# pgcalc: 100 PGs per OSD x 10,000 OSDs / size 11 = 90,909, rounded up
# to a power of two
CRUSH_PG_NUM = 131072
# phase 10: the balancer's configuration and the JAX package's result
# (tools/balancer_10k.py), in the checkout beside this script
BALANCER_REF = "BALANCER_10K.json"
# phase 7: 12 hosts for k+m = 11 shards on a host failure domain
CLUSTER_OSDS = 48
CLUSTER_PER_HOST = 4
CLUSTER_PGS = 64
CLUSTER_OBJECTS = 256
CLUSTER_MORE = 32
# phase 8: BASELINE configs #3 and #4 (and SHEC) through ECBackend
# phase 12, the client tier: rados bench's defaults (-b 4194304 -t 16),
# an RBD image at Ceph's default layout (order 22: 4 MiB objects,
# stripe_unit = object size, stripe_count 1) and fio's randwrite bs=4k,
# a CephFS file in 4 MiB writes, RGW objects and a multipart upload
# (S3's smallest part is 5 MiB)
RADOS_OBJECTS = 256
RADOS_INFLIGHT = 16
RBD_IMAGE = 1 << 30
RBD_OBJECT = 1 << 22
RBD_RANDOM = 1024
RBD_BLOCK = 4096
FS_FILE = 256 << 20
FS_WRITE = 4 << 20
FS_SPLIT = 128               # FsClient's frag_split_threshold default
RGW_OBJECTS = 64
RGW_OBJECT = 1 << 20
RGW_PARTS = 8
RGW_PART = 8 << 20
MESH_OBJECTS = 32            # phase 13: objects a dp row
SA_OSDS = 12                 # phase 14: the standalone cluster
SA_PGS = 32
SA_OBJECTS = 32              # 128 MiB: phase 15 writes 512 MiB
SA_INFLIGHT = 16             # op_window: rados bench -t 16
SA_OP_TIMEOUT = 3.0          # tools/rados_bench.py's standalone writes
SA_RANDOM = 16               # 4 KiB write_at overwrites
SA_DEGRADED = 8
# 12 daemons in one process, the JAX package's alike (PERF.md PR 12):
# they miss the 1.2 s default heartbeat grace at boot, so the phase
# writes and reads under SA_GRACE and kills under SA_KILL_GRACE, Ceph's
# own osd_heartbeat_grace default (at 8 s a host slowed by other load
# marked five live OSDs down+out after the kill, and the PGs ran out of
# shards); and the monitors' cephx ticket service times out for a third
# of the OSDs, so the phase runs AES-GCM sessions without cephx (the CPU
# tests hold cephx on 8 OSDs)
SA_GRACE = 60.0
SA_KILL_GRACE = 20.0
SA_CEPHX = False
# phase 15: the same cluster with each OSD its own process, over cephx;
# booted at the JAX package's default heartbeat grace first, then at the
# next of these graces after each boot that storms (a live OSD marked
# down, a PG not clean, an OSD without its osd ticket)
SP_OBJECTS = 128             # 512 MiB (cut from 1 GiB for the time limit)
SP_RANDOM = 128
SP_GRACES = (1.2, 5.0, 20.0, 60.0)
SP_SETTLE = 5.0              # seconds watched for false down marks
SP_KILL_GRACE = 8.0          # the least grace the kill and recovery run at
SP_REVIVE_GRACE = 30.0       # the heartbeat grace the revive runs under
SP_TICKETS = 40.0            # seconds for every OSD's osd ticket
WORKLOAD_REF = "WORKLOAD_r20.json"
THRASH = {"seed": 42, "rounds": 1, "ops": 5}
TIER_OBJECTS = 64
TIER_TARGET = 64 << 20       # target_max_bytes: a quarter of the objects
TIER_GROUP = 4               # objects a tier.write
RT_BATCH = 8                 # objects of the runtime server's encode
# phase 16: the operator tools (ceph_tpu_torch/tools/), at the sizes of
# the tools' own examples or of phase 7's cluster
TOOLS_CRUSH = ["--build", "--num-osds", "10000", "--test", "--rule", "ec",
               "--num-rep", "11", "--mark-out", "0,17"]
TOOLS_CRUSH_X = 100_000       # crushtool's own 10,000-OSD example
TOOLS_ORACLE_X = 2_000        # inputs also run through --oracle
TOOLS_ORACLE_PROCS = 6        # oracle slices, one `python -m` each
TOOLS_OSDMAP = ["--createsimple", "10000", "--pool-pgs", "65536"]
# the upmap file of the card and of the plain (CPU) path, from one map
TOOLS_OSDMAP_PLAIN = ["--createsimple", "1000", "--pool-pgs", "8192"]
TOOLS_RADOS_OBJECTS = 16      # x OBJECT_SIZE through rados put/get
TOOLS_RBD_IMAGE = "256M"
TOOLS_RBD_IMPORT = 64 << 20
TOOLS_CLI = ["--num-osds", str(CLUSTER_OSDS), "--pg-num", str(CLUSTER_PGS)]
TOOLS_STORE_OBJECTS = 16      # phase 11's cluster shape, 16 x 4 MiB
TOOLS_THRASH = ["--seed", "42", "--store", "tin", "--rounds", "1",
                "--repro"]
# the twin's schedule for TOOLS_THRASH (its tools/thrash.py on the CPU,
# held in tests/test_torch_tools_cli.py), less "parked" lines
TOOLS_THRASH_SHA = \
    "2a00c41c4904d0984149ff726f21ecf4fc118e2d7123f1fc05dcf7148855fdc0"
TOOLS_LIVE = (["status"], ["health", "detail"], ["prometheus"],
              ["daemon", "osd.0", "perf", "dump"], ["trace"])

LRC_PROFILE = "plugin=lrc k=8 m=4 l=4"
CLAY_PROFILE = "plugin=clay k=8 m=4 d=11"
SHEC_PROFILE = "plugin=shec k=4 m=3 c=2"
N_CODEC = 256
N_SHEC = 32
# phase 9: BlueStore's csum_block_size over 1 GiB; the streamed stripe
CSUM_OBJECTS = 256
CSUM_BLOCK = 4096
STREAM_SHAPE = (4, K, (64 << 20) + 777)
STREAM_TILE = 8 << 20
TILED_SHAPE = (32, K, 4 << 20)
TILED_TILE = 1 << 20
# phase 2's checksum shapes
CRC_LENGTHS = (0, 1, 7, 8, 9, 63, 64, 65, 4093, 4096, 524288)
CRC_BATCHES = (1, 3, 32, 352)
XXH_LENGTHS = (0, 1, 3, 4, 15, 16, 17, 31, 32, 33, 100, 4096, 4099)
XXH_BATCHES = (1, 3, 333)
FEW_LONG_ROWS = (1, 8, 16)   # phase 4's few-long-row CRC rows

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 at 3.35 TB/s,
# int8 tensor cores at 1,979 Tops/s, float32 outside them at 67 T/s.
HBM_BYTES_PER_S = 3.35e12
# NVLink 4 between the H100s of one host: 900 GB/s, 450 GB/s each way
NVLINK_BYTES_PER_S = 450e9
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12
# int32 operations: 64 int32 lanes a SM, half the float32 lanes behind
# the 67 TFLOP/s (132 SMs x 128 lanes x 2 for a fused multiply-add x
# 1.98 GHz): 132 x 64 x 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, warm: int = 3, reps: int = 7, calls: int = 1) -> float:
    """Milliseconds per call: CUDA events around `calls` back-to-back
    calls, divided by `calls`; the median of `reps` such runs after
    `warm` calls. With calls=1 the time includes the host's work
    between the events, as a user's single call would."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def kernel_device_ms(fn, symbol: str, calls: int = 20
                     ) -> tuple[float, str]:
    """Milliseconds of device time per launch of the kernel whose
    symbol holds `symbol`, and where the number came from. A
    torch.profiler trace records `calls` calls after warm ones (one
    warm-up step of `calls` calls with its tracing on but not kept
    comes first) and must show every launch ("trace"). A trace can
    lose kernel records, some of a run's or, now and then, all of them
    for a while: one that does not show every launch is logged with
    the count it shows and taken again, up to three times. If none
    does, the time comes from CUDA events around `calls` back-to-back
    calls queued behind a device sleep, so that the host's launch time
    stays hidden ("events")."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1), acc_events=False) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        evs = [e for e in device_events(prof) if symbol in e.key]
        n = sum(e.count for e in evs)
        if n == calls:
            return (sum(e.self_device_time_total for e in evs) / n / 1e3,
                    "trace")
        log(f"  the trace shows {n} launches of {symbol}, of {calls}: "
            f"tracing again")
    log(f"  three traces show {n} launches of {symbol}, of {calls}: its "
        f"device time from CUDA events behind a device sleep")
    return fenced_ms(fn, calls), "events"


def fenced_ms(fn, calls: int, reps: int = 5) -> float:
    """Milliseconds per call of `calls` back-to-back calls, timed by
    CUDA events that a device sleep holds back until the host has
    queued them all: the device's time, gaps between launches
    included, without the host's (median of `reps`)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)     # ~25 ms at the H100's clocks
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of the host's clock per call over `calls` calls in
    a row, the device left to run behind (a warm call first, and a
    synchronize before and after the run, outside the clock)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def gf_bound(B: int, k: int, m: int, L: int,
             nnz: int | None = None) -> tuple[float, str]:
    """Least time (ms) the card could take for the GF apply: the larger
    of B*(k+m)*L bytes through HBM and the fewest operations known for
    the function, a (8m x 8k) bit-matrix product per byte column on the
    int8 tensor cores: 2*64 ops per column for each of the matrix's `nnz`
    non-zero coefficients (m*k when dense), B*L columns."""
    nnz = m * k if nnz is None else nnz
    t_bytes = B * (k + m) * L / HBM_BYTES_PER_S
    t_ops = 2 * 64 * nnz * B * L / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def clay_matrices(coder) -> dict:
    """Config #4's GF matrices as the port's Clay coder builds them:
    encode (256, 512), single-loss repair of shard 0 from its 11 helpers
    (64, 176) and the two-loss decode of shards 0 and 9 (128, 640)."""
    n = coder.get_chunk_count()
    enc, _ = coder._affine_decode(tuple(range(coder.k, n)),
                                  tuple(range(coder.k)))
    rep, _ = coder.repair_plan_matrix(0, list(range(1, coder.d + 1)))
    dec, _ = coder._affine_decode((0, 9), tuple(c for c in range(n)
                                                if c not in (0, 9)))
    return {"clay encode": enc, "clay repair": rep, "clay 2-loss decode": dec}


def lrc_matrices(coder) -> dict:
    """Config #3's GF matrices: the global layer (4, 8), a local layer
    (1, 4) and the local repair of data_positions[0] linearized (1, 4)."""
    from ceph_tpu_torch.ec.linearize import derive_repair_matrix
    n = coder.get_chunk_count()
    lost = coder.data_positions[0]
    helpers = sorted(coder.minimum_to_decode(
        [lost], [c for c in range(n) if c != lost]))
    return {"lrc global layer": coder.layers[0].coder.matrix,
            "lrc local layer": coder.layers[1].coder.matrix,
            "lrc local repair": derive_repair_matrix(coder, [lost], helpers)}


def gf_counts(G) -> tuple:
    """gf_apply's launch count and its counts by (k, m, L, vec)."""
    f = G.apply_matrix_gf
    return f.launches, collections.Counter(f.by_shape)


def gf_set(G, counts=(0, ())) -> None:
    """Set gf_apply's counts (to zero by default)."""
    G.apply_matrix_gf.launches = counts[0]
    G.apply_matrix_gf.by_shape = collections.Counter(dict(counts[1]))


def by_shape(counter) -> dict:
    """Launches by shape as JSON: {"k,m,L,vec": launches}."""
    return {",".join(map(str, key)): n for key, n in sorted(counter.items())}


# ------------------------------------------------------------- phase 2

def check_gf_kernel(torch, dev) -> dict:
    import numpy as np

    from ceph_tpu_torch.ec.matrices import reed_sol_van_matrix
    from ceph_tpu_torch.gf.numpy_ref import decode_matrix
    from ceph_tpu_torch.ops import gf_kernel as G

    rng = np.random.default_rng(SEED)
    rs = reed_sol_van_matrix(K, M)
    sl = OBJECT_SIZE // K
    cases = [("encode k8m3", rs, (BATCH, K, sl), 0)]
    for lost in ((3,), LOST, (1, 5, 10)):
        surv = [s for s in range(K + M) if s not in lost][:K]
        cases.append((f"decode {len(lost)}-loss {lost}",
                      decode_matrix(rs, list(lost), K, surv),
                      (BATCH, K, sl), 0))

    def rmat(m, k):
        return rng.integers(0, 256, (m, k), dtype=np.uint8)
    cases += [
        ("k=1", rmat(3, 1), (4, 1, 4096), 0),
        ("m=1", rmat(1, 8), (4, 8, 4096), 0),
        ("k=16 m=4", rmat(4, 16), (3, 16, 8192), 0),
        ("m=12 (row groups)", rmat(12, 5), (2, 5, 1024), 0),
        ("k=250 m=8", rmat(8, 250), (2, 250, 256), 0),
        ("L=4", rs, (5, K, 4), 0),
        ("L=128", rs, (5, K, 128), 0),
        ("L=524292", rs, (2, K, 524292), 0),
        ("B=1", rs, (1, K, sl), 0),
        ("unaligned start", rs, (3, K, 4096), 4),
        ("L=1 (ragged)", rs, (5, K, 1), 0),
        ("L=5 (ragged)", rs, (5, K, 5), 0),
        ("L=6 (ragged)", rs, (5, K, 6), 0),
        ("L=7 (ragged)", rs, (5, K, 7), 0),
        ("L=4093 (ragged)", rs, (BATCH, K, 4093), 0),
        ("delta (ragged)", rs[:, [0, 2]], (BATCH, 2, 4093), 0),
        ("ragged, odd start", rs, (3, K, 4097), 1),
    ]
    # config #3 and #4 matrices at B = 2 and a short sub-chunk, a sparse
    # (8, 2560), one non-zero coefficient, an empty row group, Clay's
    # matrices at the backend's shapes
    from ceph_tpu_torch.ec.registry import factory
    codec = {**lrc_matrices(factory(LRC_PROFILE, **entry_device(dev))),
             **clay_matrices(factory(CLAY_PROFILE, **entry_device(dev)))}
    for name, mat in codec.items():
        cases.append((name, mat, (2, mat.shape[1], 512), 0))
    wide = rmat(8, 2560) * (rng.random((8, 2560)) < 0.05)
    one = np.zeros((4, 8), np.uint8)
    one[2, 5] = 7
    half = rmat(16, 12)
    half[8:] = 0                                    # row group 1 is empty
    cases += [("(8, 2560) 5 % non-zero", wide, (2, 2560, 4096),
               0),
              ("clay 2-loss decode, ragged", codec["clay 2-loss decode"],
               (2, 640, 131), 0),
              ("one non-zero coefficient", one, (4, 8, 4096), 0),
              ("a row group with no entry", half, (3, 12, 2048), 0)]
    cases += [(f"{name}, backend shape", mat,
               (BATCH, mat.shape[1], OBJECT_SIZE // K // 64), 0)
              for name, mat in codec.items() if name.startswith("clay")]
    # schedules whose chunks pass the default 48 KiB of shared memory: a
    # dense (8, 250) (one chunk of 55.6 KB) and a dense (8, 2560) (640
    # KiB of words in chunks of 96 KiB)
    big = [("k=250 m=8 dense, one chunk > 48 KiB", rmat(8, 250) | 1,
            (2, 250, 256), 0),
           ("k=2560 m=8 dense, chunks of 96 KiB", rmat(8, 2560) | 1,
            (2, 2560, 1024), 0)]
    for name, mat, _, _ in big:
        cw = G.compile_schedule(mat).chunk_words
        if cw * 4 <= 48 * 1024:
            fail(f"{name}: chunk of {cw * 4} bytes, want > 48 KiB")
    # a dense (8, 385) has two chunks (384 entries of 64 words fill 96
    # KiB); at these lengths the blocks of its one row group walk two or
    # more tiles of places and stage both chunks again on each. The
    # kernel's grid covers sms * 8 * 4 blocks of 128 places (vec 4: 16
    # bytes a place; vec 1: 4 bytes), one row group here, per object
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    two = rmat(8, 385) | 1
    per = -(-sms * 32 // 2)                         # tiles a block at B=2
    cases += big + [
        ("k=385 m=8 dense, two chunks, several tiles a block (vec 1)", two,
         (2, 385, (2 * per + 1) * 512 - 12), 0),
        ("k=385 m=8 dense, two chunks, several tiles a block (vec 4)", two,
         (1, 385, (sms * 32 + 64) * 2048), 0)]
    worst = 0
    seen = set()
    for name, mat, (B, k, L), offset in cases:
        flat = torch.randint(0, 256, (B * k * L + offset,), dtype=torch.uint8,
                             device=dev)
        data = flat[offset:].view(B, k, L)
        want = G.apply_matrix_plain(mat, data)
        got = G.apply_matrix_gf(mat, data)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs()
                  .max()) if got.numel() else 0
        worst = max(worst, err)
        if err or not torch.equal(got, want):
            fail(f"gf_apply disagrees with its plain version on {name}")
        sched = G.compile_schedule(mat)
        chunks = int(np.diff(sched.gch).max(initial=0))
        seen.add((G.stages(sched), chunks > 1))
        log(f"  gf_apply {name}: ({B},{k},{L})->({B},{mat.shape[0]},{L}) "
            f"max_abs_err={err} ({len(sched.ent)} entries in "
            f"{sched.groups} groups of {sched.mt}, up to {chunks} chunks "
            f"of up to {sched.chunk_words * 4} B, read from "
            f"{'shared' if G.stages(sched) else 'global'} memory)")
        del flat, data, want, got
    torch.cuda.empty_cache()
    # the kernel's three ways to its coefficient words: global memory,
    # shared memory staged once, shared memory chunk by chunk
    if not {(False, False), (True, False), (True, True)} <= seen:
        fail(f"phase 2 missed a way to the coefficient words: {seen}")
    return {"max_abs_err": worst}


def csum_counts() -> collections.Counter:
    """The checksum kernels' launch counts by name."""
    from ceph_tpu_torch.csum import kernels as C
    return collections.Counter(C.launches)


def crc_shapes() -> collections.Counter:
    """The CRC kernel's launch counts by shape ("B,L,vec" a row set)."""
    from ceph_tpu_torch.csum import kernels as C
    return collections.Counter(C.shapes)


def csum_set(counts=None, shapes=None) -> None:
    """Set the checksum kernels' counts, by name and the CRC kernel's by
    shape (to zero by default)."""
    from ceph_tpu_torch.csum import kernels as C
    C.launches.clear()
    C.launches.update(counts or {})
    C.shapes.clear()
    C.shapes.update(shapes or {})


# CRC launches by shape, each phase's as crc_launches read them
CRC_BY_SHAPE: dict = {}


def crc_launches(label: str) -> int:
    """CRC32C launches since the counts were last set; fails on none.
    Keeps their shapes in CRC_BY_SHAPE[label]."""
    n = csum_counts()["crc32c"]
    CRC_BY_SHAPE[label] = dict(sorted(crc_shapes().items(),
                                      key=lambda kv: -kv[1]))
    log(f"  crc32c launches in {label}: {n}, by shape (B,L,vec; sets "
        f"joined by +): {json.dumps(CRC_BY_SHAPE[label])}")
    if n == 0:
        fail(f"{label} never launched the CRC32C kernel")
    return n


def check_csum_kernels(torch, dev) -> dict:
    """Phase 2 for csum.cu: each kernel bit-exact against its plain
    version on the card at every phase-2 shape (CRC32C with both seed
    conventions and crc32c_extend with random registers; XXH32 and
    XXH64 with seeds 0 and 42), row views whose starts and pitch reach
    every realignment of the CRC kernel's loads (start offsets 1, 2, 3,
    4 and 8 from the 16-byte grid, odd pitches), the RMW delta's
    4093-byte rows, few long rows, multi-set launches of mixed lengths
    and seeds, and a sample of rows against the reference oracle. Fails
    unless the CRC cases reach both load paths and every offset, rows
    over several items, items of several rows, the short-row plan, few
    long rows spread over every SM, and launches of 2, 3 and 4 sets."""
    import numpy as np

    from ceph_tpu_torch.csum import kernels as C
    from ceph_tpu_torch.csum import reference as R

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, seen = 0, set()

    def same(name, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        worst = max(worst, err)
        if err or got.shape != want.shape or not torch.equal(got, want):
            fail(f"{name}: the kernel disagrees with its plain version")

    def rows_of(B, L, offset=0, extra=0):
        """(B, L) rows `offset` bytes into a buffer, L + extra apart."""
        flat = torch.randint(0, 256, (offset + B * (L + extra) + 16,),
                             dtype=torch.uint8, device=dev, generator=gen)
        return flat[offset:offset + B * (L + extra)].view(B, L + extra)[
            :, :L]

    def sample(B):
        return sorted({0, B - 1})

    def reached(x, plan):
        B = x.shape[0]
        pitch = x.stride(0) if B > 1 else 0
        vec = next(v for v in (16, 8, 4, 2, 1)
                   if x.data_ptr() % v == 0 and pitch % v == 0)
        seen.add(("vec", vec))
        if plan.units:
            seen.add(("offset", x.data_ptr() % 16))
        seen.add(("items a row", plan.nb > 1))
        seen.add(("rows an item", plan.log_lanes < 5 and B > 1))
        seen.add(("short-row plan", plan.nb == 1 and plan.segments == 32
                  and plan.seg <= C.MIN_SEG_UNITS))
        seen.add(("few long rows on every SM",
                  B <= 16 and plan.items(B) >= sms))

    cases = [(B, L, 0, 0) for B in CRC_BATCHES for L in CRC_LENGTHS]
    # row starts and pitches off the 16-byte grid: every realignment
    cases += [(3, 4096, 8, 8), (32, 4093, 0, 0), (5, 4096, 1, 3),
              (3, 524288, 3, 1), (2, 65, 5, 2), (7, 1000, 2, 5),
              (9, 4093, 3, 0), (4, 300, 4, 1), (6, 777, 12, 3),
              (3, 20000, 10, 6)]
    # the RMW delta's rows (4093 apart) and few long rows
    cases += [(64, 4093, 0, 0), (96, 4093, 0, 0), (11, 524288, 0, 0),
              (16, 524288, 0, 0), (2, 1 << 21, 0, 0), (5, 524288, 1, 0)]
    n_crc = 0
    for B, L, off, extra in cases:
        x = rows_of(B, L, off, extra)
        name = f"crc32c ({B}, {L}) at +{off}, pitch {L + extra}"
        for init, xorout in ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0)):
            same(name, C.crc32c_blocks(x, init, xorout),
                 C.crc32c_blocks_plain(x, init, xorout))
        regs = torch.randint(0, 1 << 32, (B,), dtype=torch.int64,
                             device=dev, generator=gen)
        got = C.crc32c_extend(regs, x)
        same(name + " extend", got, C.crc32c_extend_plain(regs, x))
        # the oracle on a row or two (one row of 512 KiB at most)
        if L < 524288 or B == 1:
            host, hregs = x.cpu().numpy(), regs.cpu().numpy()
            for i in sample(B):
                if int(got[i]) != R.ceph_crc32c(int(hregs[i]), host[i]):
                    fail(f"{name}: row {i} differs from the oracle")
        reached(x, C.plan_for(B, L, sms))
        n_crc += 1
    # one launch over several row sets: mixed L, offsets and seeds
    set_cases = [
        ((256, 4096, 0, 0, "blocks"), (96, 4096, 0, 0, "raw")),
        ((64, 4093, 0, 0, "zero"), (96, 4093, 0, 0, "zero")),
        ((64, 524288, 0, 0, "raw"), (32, 65536, 0, 0, "raw")),
        ((3, 1000, 1, 3, "extend"), (5, 77, 2, 0, "raw"),
         (1, 0, 0, 0, "blocks")),
        ((7, 4093, 3, 0, "zero"), (2, 524288, 0, 0, "extend"),
         (33, 31, 5, 1, "blocks"), (4, 64, 8, 0, "raw"))]
    seeds = {"blocks": (0xFFFFFFFF, 0xFFFFFFFF), "raw": (0xFFFFFFFF, 0),
             "zero": (0, 0)}
    before = csum_counts()["crc32c"]
    for spec in set_cases:
        sets = []
        for B, L, off, extra, kind in spec:
            x = rows_of(B, L, off, extra)
            regs = torch.randint(0, 1 << 32, (B,), dtype=torch.int64,
                                 device=dev, generator=gen) \
                if kind == "extend" else None
            init, xorout = seeds.get(kind, (0xFFFFFFFF, 0xFFFFFFFF))
            sets.append(C.CrcRows(x, init, xorout, regs))
        for st, plan in zip(sets, C.plans_for(
                [tuple(st.blocks.shape) for st in sets], sms)):
            reached(st.blocks, plan)
        name = "crc32c_sets " + " + ".join(
            f"({B}, {L}) at +{off} {kind}" for B, L, off, _, kind in spec)
        got = C.crc32c_sets(sets)
        same(name, got, C.crc32c_sets_plain(sets))
        seen.add(("sets", len(sets)))
        seen.add(("sets of mixed L", len({s.blocks.shape[1]
                                          for s in sets}) > 1))
        seen.add(("sets of mixed seeds", len({k for *_, k in spec}) > 1))
    if csum_counts()["crc32c"] - before != len(set_cases):
        fail("a crc32c_sets call did not make exactly one launch")
    for want in ([("vec", v) for v in (16, 8, 4, 2, 1)]
                 + [("offset", o) for o in (1, 2, 3, 4, 8)]
                 + [("items a row", True), ("rows an item", True),
                    ("short-row plan", True),
                    ("few long rows on every SM", True),
                    ("sets", 2), ("sets", 3), ("sets", 4),
                    ("sets of mixed L", True),
                    ("sets of mixed seeds", True)]):
        if want not in seen:
            fail(f"phase 2's CRC cases missed {want}: {sorted(seen)}")
    log(f"  crc32c: {n_crc} shapes x (2 seed conventions + extend) and "
        f"{len(set_cases)} multi-set launches equal to the plain "
        f"versions; sampled rows equal the oracle; reached "
        f"{sorted(seen)}")
    cases = [(B, L, 0, 0) for B in XXH_BATCHES for L in XXH_LENGTHS]
    cases += [(5, 4096, 1, 3), (3, 4099, 4, 4), (7, 100, 8, 0)]
    for B, L, off, extra in cases:
        x = rows_of(B, L, off, extra)
        host = x.cpu().numpy()
        for seed in (0, 42):
            name = f"({B}, {L}) at +{off}, pitch {L + extra}, seed {seed}"
            h32 = C.xxh32_blocks(x, seed)
            same("xxh32 " + name, h32, C.xxh32_blocks_plain(x, seed))
            h64 = C.xxh64_blocks(x, seed)
            same("xxh64 " + name, h64, C.xxh64_blocks_plain(x, seed))
            for i in sample(B):
                if int(h32[i]) != R.xxh32(host[i], seed) or \
                        (int(h64[i, 0]) << 32 | int(h64[i, 1])) != \
                        R.xxh64(host[i], seed):
                    fail(f"xxhash {name}: row {i} differs from the oracle")
    log(f"  xxh32 / xxh64: {len(cases)} shapes x seeds 0, 42 equal to the "
        f"plain versions; sampled rows equal the oracle")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst}


LONG_WALK = 128              # "long": the targets every row clashes with


def score_inputs(torch, dev, rng, N: int, S2: int, U: int, n_osds: int,
                 kind: str = "ties") -> tuple:
    """A seeded candidate block for the placement scorer on `dev`:
    members with CRUSH_ITEM_NONE holes and the source among them,
    domains 8 devices wide with some devices outside every bucket, and
    by `kind`: "ties" integer-valued deviations (ties everywhere) and
    "normal" real ones, both with dsts in random order (the kernel sorts
    them); "illegal" every row's source the least loaded device (every
    gain <= 0); "sorted" dsts the U least loaded devices in deviation
    order, as the balancer passes them; "balancer" that, with phase
    10's shape of row (2S = 6: a size-3 PG on 3 hosts of 8 devices,
    raw set = effective set, its source among the 512 most loaded
    devices); "shuffled" the balancer's rows with dsts in random order
    (the walk sorts them); "collapsed" dev[src] = 3e7 on half the rows and target
    deviations 0.125, 0.25, ... 1.0 in random order, which round to one
    or two gains; "long" the balancer's rows whose first LONG_WALK targets
    all clash (one domain that a member of every row holds); and "nan
    source", "inf source", "inf target", "-inf target", "nan target"
    that value in dev[src] of every third row or in two targets."""
    import numpy as np
    dom = (np.arange(n_osds) // 8 - 1000).astype(np.int32)
    outside = rng.choice(n_osds, 7, replace=False)
    dev_ = (rng.integers(-20, 21, n_osds).astype(np.float64)
            if kind in ("ties", "illegal", "collapsed")
            else rng.normal(0, 30, n_osds))
    if kind in ("balancer", "shuffled", "long"):
        # hosts of 8 devices, one PG on 3 distinct hosts, raw = effective
        hosts = n_osds // 8
        order = np.argsort(dev_, kind="stable")
        src = order[-512:][rng.integers(0, 512, N)].astype(np.int32)
        h = np.empty((N, 3), np.int64)
        h[:, 0] = src // 8
        for c in (1, 2):
            h[:, c] = rng.integers(0, hosts, N)
            while True:
                same = (h[:, [c]] == h[:, :c]).any(axis=1)
                if not same.any():
                    break
                h[same, c] = rng.integers(0, hosts, int(same.sum()))
        raw = (h * 8 + rng.integers(0, 8, (N, 3))).astype(np.int32)
        raw[:, 0] = src
        members = np.concatenate([raw, raw], axis=1)[:, :S2]
        dsts = order[:U].astype(np.int32)
        if kind == "shuffled":
            dsts = rng.permutation(dsts)
        if kind == "long":
            holder = int(order[U])          # neither a target nor a source
            dom[dsts[:LONG_WALK]] = dom[holder] = 1 << 20
            members[:, 1] = members[:, 4 % S2] = holder
    else:
        dom[outside] = -(10 ** 7) - np.arange(7)
        dsts = rng.choice(n_osds, U, replace=False).astype(np.int32)
        if kind == "sorted":
            dsts = np.argsort(dev_, kind="stable")[:U].astype(np.int32)
        members = rng.integers(0, n_osds, (N, S2)).astype(np.int32)
        members[rng.random((N, S2)) < 0.1] = 0x7FFFFFFF
        src = rng.integers(0, n_osds, N).astype(np.int32)
        if kind == "illegal":
            src[:] = int(np.argmin(dev_))
        members[:, 0] = src
        if N > 16 and kind != "illegal":
            members[-8:] = 0x7FFFFFFF        # pow2 padding rows
            src[-8:] = 0
    dev_ = dev_.astype(np.float32)
    if kind == "collapsed":
        dev_[dsts] = rng.choice(np.float32(np.arange(1, 9) / 8), U)
        dev_[src[::2]] = np.float32(3.0e7)
    if kind.endswith("source"):
        dev_[src[::3]] = np.float32(kind.split()[0])
    if kind.endswith("target"):
        dev_[dsts[[0, U // 2]]] = np.float32(kind.split()[0])
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (members, src, dsts, dev_, dom))


def same_scores(torch, a, b) -> bool:
    """Equal bit for bit, except that any two NaNs are equal: a NaN's
    payload is the subtraction unit's, not the function's (torch.sort
    ranks every NaN alike)."""
    an, bn = torch.isnan(a), torch.isnan(b)
    return torch.equal(an, bn) and torch.equal(
        torch.where(an, 0.0, a).view(torch.int32),
        torch.where(bn, 0.0, b).view(torch.int32))


# phase 2's scorer cases: (N, 2S, U, topk, kind)
SCORE_CASES = (
    (1000, 6, 512, 8, "ties"), (129, 6, 7, 7, "ties"), (64, 6, 1, 1, "ties"),
    (64, 22, 512, 8, "normal"), (1000, 32, 700, 8, "ties"),
    (1000, 22, 64, 3, "ties"), (129, 32, 512, 8, "illegal"),
    (1000, 6, 512, 5, "illegal"), (262144, 6, 512, 8, "ties"),
    # the walk: the balancer's order, collapsed ties, long walks
    (1000, 6, 512, 8, "sorted"), (1000, 22, 512, 4, "sorted"),
    (262144, 6, 512, 8, "balancer"), (262144, 6, 512, 5, "balancer"),
    (262144, 6, 512, 1, "balancer"), (262144, 6, 512, 8, "shuffled"),
    (262144, 6, 512, 1, "ties"),
    (262144, 6, 512, 5, "ties"),
    (1000, 6, 512, 8, "collapsed"), (1000, 6, 64, 3, "collapsed"),
    (1000, 6, 512, 8, "long"), (1000, 6, 512, 1, "long"),
    # the most targets the walk stages (96 KiB of shared memory), and
    # the scan instance above it
    (1000, 22, 4096, 8, "normal"), (1000, 6, 4097, 8, "ties"),
    (1000, 6, 5000, 5, "normal"),
    # non-finite deviations: those rows, or the whole block, exhaustive
    (1000, 6, 512, 8, "nan source"), (1000, 6, 512, 8, "inf source"),
    (1000, 6, 512, 8, "inf target"), (1000, 6, 512, 5, "-inf target"),
    (1000, 6, 512, 8, "nan target"), (1000, 6, 5000, 8, "nan source"),
    (1000, 6, 5000, 8, "inf target"))


def check_score_kernel(torch, dev) -> dict:
    """Phase 2 for placement.cu: best indices and float32 scores bit for
    bit (any NaN equal to any NaN) against score_candidates_plain on
    the card at every SCORE_CASES entry: N not a multiple of the block
    (1000, 129), N = 64 (the pad minimum) and N = 262,144 (phase 10's),
    U from 1 to 5000 (the walk instance up to 4096 targets, the scan
    above), 2S = 6, 22 and 32, topk 1 to 8, and every kind of
    `score_inputs`. Each case launches the kernel twice, through
    score_candidates and through its counting entry, whose visits must
    be score_visits_plain's; fails unless every call launched and both
    instances ran."""
    import numpy as np

    from ceph_tpu_torch.mgr import placement as P

    rng = np.random.default_rng(SEED + 21)
    worst = 0.0
    n0, inst0 = P.launches, dict(P.instance_launches)
    walked = []
    for N, S2, U, topk, kind in SCORE_CASES:
        inp = score_inputs(torch, dev, rng, N, S2, U, 10_000, kind)
        best, score = P.score_candidates(*inp, topk)
        visits = torch.full((N,), -1, dtype=torch.int32, device=dev)
        best2, score2 = P.score_candidates(*inp, topk, visits=visits)
        pb, ps = P.score_candidates_plain(*inp, topk)
        pv = P.score_visits_plain(*inp, topk)
        torch.cuda.synchronize()
        name = f"score_candidates N={N} 2S={S2} U={U} topk={topk} {kind}"
        for b, s in ((best, score), (best2, score2)):
            if b.shape != (N, topk) or not torch.equal(b, pb) or \
                    not same_scores(torch, s, ps):
                fail(f"{name}: the kernel disagrees with its plain version")
        if not torch.equal(visits, pv):
            fail(f"{name}: the kernel visited {int(visits.sum())} targets, "
                 f"score_visits_plain counts {int(pv.sum())}")
        finite = torch.isfinite(ps)
        if kind == "illegal" and bool(finite.any()):
            fail(f"{name}: an all-illegal block scored a legal target")
        if kind == "long" and int(visits[:-8].min()) < LONG_WALK:
            fail(f"{name}: a row settled before its clashing targets")
        if bool(finite.any()):
            worst = max(worst, float((score - ps)[finite].abs().max()))
        walked.append(f"{kind} U={U} topk={topk}: "
                      f"{float(pv.float().mean()):.2f}")
    if P.launches - n0 != 2 * len(SCORE_CASES):
        fail("phase 2's scorer cases did not all launch the kernel")
    ran = {k: P.instance_launches[k] - inst0[k] for k in inst0}
    if not all(ran.values()):
        fail(f"phase 2 did not run both scorer instances: {ran}")
    log(f"  score_candidates: {len(SCORE_CASES)} cases bit-exact against "
        f"the plain version (indices, scores, -inf slots, tie order), "
        f"visits equal to score_visits_plain; launches by instance "
        f"{ran}; mean targets a row: {'; '.join(walked)}")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst}


# ------------------------------------------------------------- phase 3

def main_path(torch, dev) -> dict:
    import numpy as np

    from ceph_tpu_torch.csum.reference import ceph_crc32c
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.gf.numpy_ref import encode_ref
    from ceph_tpu_torch.osd.ecbackend import (_build_recover_program,
                                              _expected_fold_crcs,
                                              _fused_write_fn)

    coder = factory(PROFILE)
    if coder.device.type != dev.type or coder.impl != "pallas":
        fail(f"coder on {coder.device} with impl {coder.impl}")
    sl = coder.get_chunk_size(OBJECT_SIZE)
    n = K + M
    write = _fused_write_fn(coder.matrix.tobytes(), M, K, coder.impl, sl,
                            BATCH, coder.device)
    survivors = [s for s in range(n) if s not in LOST][:K]
    dec_fn = coder.batch_decoder(LOST, survivors)
    recover = _build_recover_program(dec_fn, verify=True, host_crc=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for bi in range(N_OBJECTS // BATCH):
        data = torch.randint(0, 256, (BATCH, K, sl), dtype=torch.uint8,
                             device=dev, generator=gen)
        parity, crcs = write(data)
        full = torch.cat([data, parity], dim=1)        # (B, n, sl)
        stack = full[:, survivors]
        exp = crcs[:, survivors].cpu().numpy()         # hinfo, on host
        expfold = torch.from_numpy(
            _expected_fold_crcs(exp, sl).astype(np.int64)).to(dev)
        rebuilt, rcrc, ok = recover(stack, expfold)
        bad += (~ok).sum()
        for ei, e in enumerate(LOST):
            bad += (rebuilt[:, ei] != full[:, e]).any()
            bad += (rcrc[:, ei] != crcs[:, e]).sum()
        if bi == 0:
            d0 = data[:2].cpu().numpy()
            want = encode_ref(coder.matrix, d0)
            if not np.array_equal(parity[:2].cpu().numpy(), want):
                fail("fused write parity differs from encode_ref")
            host = full[0, [0, 8, 9, 10]].cpu().numpy()
            got_crc = crcs[0, [0, 8, 9, 10]].cpu().numpy()
            ref_crc = [ceph_crc32c(0xFFFFFFFF, r) for r in host]
            if [int(c) for c in got_crc] != ref_crc:
                fail(f"hinfo CRCs {got_crc} != reference {ref_crc}")
            chunks = {i: full[:, i] for i in range(n) if i not in LOST}
            obj = coder.decode_concat(chunks, OBJECT_SIZE)
            if obj.shape != (BATCH, OBJECT_SIZE) or \
                    not torch.equal(obj, data.reshape(BATCH, -1)):
                fail("decode_concat did not return the written objects")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if int(bad):
        fail(f"main path: {int(bad)} recovery mismatches "
             f"(fold checks, rebuilt rows or rebuilt CRCs)")
    log(f"  main path: {N_OBJECTS} x {OBJECT_SIZE >> 20} MiB objects, "
        f"write -> lose {list(LOST)} -> fused recover -> verify in "
        f"{seconds:.3f} s (host clock, with checks)")
    return {"coder": coder, "recover": recover, "write": write,
            "dec_fn": dec_fn, "survivors": survivors, "sl": sl}


# ------------------------------------------------------------- phase 4

def gf_table(torch, dev, plain: bool = True) -> dict:
    """gf_apply at every row of PERF.md's kernel table: RS k=8 m=3
    encode and two-loss decode over 32 objects of 4 MiB, the one-loss
    rebuild over 1 and 32, the ragged RMW delta of phase 5 (and the same
    launch with an all-zero matrix), phase 12's one-shard deltas of 4
    KiB and 64 KiB, and
    configs #3 and #4 and SHEC at the backend's shapes. For each: ms per
    call (CUDA events around 20 back-to-back calls), the kernel's own
    device time per launch (a trace), the host's microseconds per call;
    with `plain`, the plain version's and impl=mxu's ms beside. Uses only
    gf_kernel's public surface, so that `--gf-times` can time an older
    checkout of the package as well. Returns the rows and their
    matrices."""
    import numpy as np

    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.gf.numpy_ref import decode_matrix
    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.ops.rs_kernels import apply_matrix

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    rs = factory(PROFILE, **entry_device(dev)).matrix
    sl = OBJECT_SIZE // K
    survivors = [s for s in range(K + M) if s not in LOST][:K]
    mats = {"encode": rs,
            "decode": decode_matrix(rs, list(LOST), K, survivors),
            "rebuild": decode_matrix(rs, [0], K, list(range(1, K + 1))),
            "ragged": rs[:, [0, 2]],
            "delta": rs[:, [0]],
            **lrc_matrices(factory(LRC_PROFILE, **entry_device(dev))),
            **clay_matrices(factory(CLAY_PROFILE, **entry_device(dev))),
            "shec encode": factory(SHEC_PROFILE, **entry_device(dev)).matrix}
    # (row, matrix, length, batch); configs #3 and #4 at the backend's
    # shapes: LRC chunks of 512 KiB, Clay's 64 sub-chunks of 8 KiB; the
    # RS one-loss rebuild of phases 7, 11 and 12 at one object and at a
    # batch; phase 12's RMW deltas of one data shard, a 4 KiB RBD
    # overwrite and a 64 KiB striper piece
    rows = (("encode", "encode", sl, BATCH), ("decode", "decode", sl, BATCH),
            ("rebuild_b1", "rebuild", sl, 1),
            ("rebuild_b32", "rebuild", sl, BATCH),
            ("ragged", "ragged", 4093, BATCH),
            ("delta_4k", "delta", 4096, 1),
            ("delta_64k", "delta", 65536, 1),
            ("lrc_global", "lrc global layer", sl, BATCH),
            ("lrc_repair", "lrc local repair", sl, BATCH),
            ("clay_encode", "clay encode", sl // 64, BATCH),
            ("clay_repair", "clay repair", sl // 64, BATCH),
            ("clay_decode", "clay 2-loss decode", sl // 64, BATCH),
            ("shec_encode", "shec encode", OBJECT_SIZE // 4, BATCH))
    out = {}
    for label, name, s_len, batch in rows:
        mat = mats[name]
        m, k = mat.shape
        x = torch.randint(0, 256, (batch, k, s_len), dtype=torch.uint8,
                          device=dev, generator=gen)
        # the kernel against its plain version at this shape
        if not torch.equal(G.apply_matrix_gf(mat, x),
                           G.apply_matrix_plain(mat, x)):
            fail(f"gf_apply disagrees with its plain version on {name} "
                 f"at ({batch},{k},{s_len})")
        ms = cuda_ms(lambda: G.apply_matrix_gf(mat, x), calls=20)
        dev_ms, dev_from = kernel_device_ms(
            lambda: G.apply_matrix_gf(mat, x), "gf_apply_kernel")
        us = host_us(lambda: G.apply_matrix_gf(mat, x))
        nnz = int((mat != 0).sum())
        bound, by = gf_bound(batch, k, m, s_len, nnz)
        row = {"ms": ms, "device_ms": dev_ms, "device_ms_from": dev_from,
               "host_us": us, "bound_ms": bound, "bound_by": by, "nnz": nnz,
               "max_abs_err": 0, "shape": [batch, k, m, s_len]}
        extra = ""
        if label == "ragged":
            # the same launch with a schedule of no entry: the kernel's
            # fixed path at this shape
            zero = np.zeros_like(mat)
            row["empty_schedule_ms"], row["empty_schedule_ms_from"] = \
                kernel_device_ms(lambda: G.apply_matrix_gf(zero, x),
                                 "gf_apply_kernel")
            extra = (f"; with an all-zero matrix "
                     f"{row['empty_schedule_ms']:.5f} ms on the device")
        if plain:
            row["plain_ms"] = cuda_ms(lambda: G.apply_matrix_plain(mat, x),
                                      0 if k > 100 else 1, 3 if k > 100
                                      else 5, calls=1 if k > 100 else 3)
            extra += f"; plain {row['plain_ms']:.4f} ms"
            if label.startswith(("lrc", "clay", "shec")):
                row["mxu_ms"] = cuda_ms(lambda: apply_matrix(mat, x, "mxu"),
                                        1, 3)
                extra += f", impl=mxu {row['mxu_ms']:.4f} ms"
        out[label] = row
        log(f"  gf_apply {name} ({batch},{k},{s_len})->({batch},{m},{s_len})"
            f": equal to plain; {ms:.5f} ms per call, {dev_ms:.5f} ms on "
            f"the device, {us:.1f} us of host time per call (bound "
            f"{bound:.6f} ms, {by}; {nnz} non-zero coefficients){extra}")
        del x
    torch.cuda.empty_cache()
    return out, {label: mats[name] for label, name, _, _ in rows}


def csum_bound(B: int, L: int, out_bytes: int, ops_per_byte: float
               ) -> tuple[float, str]:
    """Least time (ms) for a checksum of B rows of L bytes: the larger
    of the bytes (each input byte read once, `out_bytes` a row written)
    through HBM and `ops_per_byte` integer operations a byte at the
    card's float32 rate outside the tensor cores (67 T/s; the data
    sheet gives no integer rate there)."""
    t_bytes = B * (L + out_bytes) / HBM_BYTES_PER_S
    t_ops = B * L * ops_per_byte / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def csum_table(torch, dev, plain: bool = True, only_crc: bool = False
               ) -> dict:
    """The checksum kernels at the main path's shapes: CRC32C over 256
    rows of 512 KiB (an (32, 8) batch's data rows, PERF.md's row), the
    fused write's 352 rows (data and parity) as one set and as its two
    sets in one launch, the recovery program's launch (64 rebuilt rows
    and 32 fold rows), the RMW delta's 64 data and 96 parity rows of
    4093 bytes (4093 apart: the realigned loads) alone and as its one
    launch, and few long rows (FEW_LONG_ROWS rows of 512 KiB and one
    object's fused write, 8 + 3 rows: the cluster path's most launched
    shapes); XXH32 and XXH64 over 262,144 rows of 4
    KiB (phase 9's 1 GiB). For each: ms per call (CUDA events around 20
    calls), the kernel's device ms per launch (a trace), host us per
    call, the plain version's ms (with `plain`), and the bound. The
    bound's operations: CRC32C one table lookup and one XOR a byte,
    XXH32 3 per 4 bytes, XXH64 3 per 8. `only_crc` leaves out the XXH
    rows; a checkout without `crc32c_sets` leaves out the multi-set
    rows (so that `--crc-times` can time an older checkout)."""
    from ceph_tpu_torch.csum import kernels as C

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    sl = OBJECT_SIZE // K
    crc = (("crc32c_256x512KiB", ((BATCH * K, sl),)),
           ("crc32c_352x512KiB", ((BATCH * (K + M), sl),)),
           ("crc32c_write_256+96x512KiB", ((BATCH * K, sl),
                                           (BATCH * M, sl))),
           ("crc32c_recover_64+32x512KiB", ((BATCH * 2, sl), (BATCH, sl))),
           ("crc32c_rmw_64x4093", ((BATCH * 2, 4093),)),
           ("crc32c_rmw_96x4093", ((BATCH * M, 4093),)),
           ("crc32c_rmw_64+96x4093", ((BATCH * 2, 4093),
                                      (BATCH * M, 4093))),
           *((f"crc32c_{B}x512KiB", ((B, sl),)) for B in FEW_LONG_ROWS),
           ("crc32c_write_8+3x512KiB", ((K, sl), (M, sl))))
    rows = [("crc32c", label, sets, 2.0) for label, sets in crc
            if len(sets) == 1 or hasattr(C, "crc32c_sets")]
    if not only_crc:
        n = CSUM_OBJECTS * OBJECT_SIZE // CSUM_BLOCK
        rows += [("xxh32", "xxh32_262144x4KiB", ((n, CSUM_BLOCK),), 0.75),
                 ("xxh64", "xxh64_262144x4KiB", ((n, CSUM_BLOCK),), 0.375)]

    def crc_fns(xs):
        if len(xs) == 1:
            return (lambda: C.crc32c_blocks(xs[0], 0xFFFFFFFF, 0),
                    lambda: C.crc32c_blocks_plain(xs[0], 0xFFFFFFFF, 0))
        sets = [C.CrcRows(x, 0xFFFFFFFF, 0) for x in xs]
        return (lambda: C.crc32c_sets(sets),
                lambda: C.crc32c_sets_plain(sets))
    out = {}
    for kernel, label, shapes, ops in rows:
        xs = [torch.randint(0, 256, (B, L), dtype=torch.uint8, device=dev,
                            generator=gen) for B, L in shapes]
        if kernel == "crc32c":
            fn, ref = crc_fns(xs)
        else:
            f, g = ((C.xxh32_blocks, C.xxh32_blocks_plain)
                    if kernel == "xxh32" else
                    (C.xxh64_blocks, C.xxh64_blocks_plain))
            fn, ref = (lambda: f(xs[0])), (lambda: g(xs[0]))
        if not torch.equal(fn(), ref()):
            fail(f"{label}: {kernel} disagrees with its plain version")
        ms = cuda_ms(fn, calls=20)
        dev_ms, dev_from = kernel_device_ms(fn, f"{kernel}_kernel")
        us = host_us(fn)
        plain_ms = cuda_ms(ref, 1, 3) if plain else None
        nbytes = sum(B * L for B, L in shapes)
        bounds = [csum_bound(B, L, 16 if kernel == "xxh64" else 8, ops)
                  for B, L in shapes]
        bound = sum(b for b, _ in bounds)
        by = "bytes" if all(w == "bytes" for _, w in bounds) \
            else "operations"
        out[label] = {"ms": ms, "device_ms": dev_ms,
                      "device_ms_from": dev_from, "host_us": us,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "shape": [list(x) for x in shapes]
                      if len(shapes) > 1 else list(shapes[0]),
                      "device_share_of_bound": bound / dev_ms,
                      "gbps": nbytes / ms / 1e6}
        log(f"  {label}: equal to plain; {ms:.5f} ms per call "
            f"({nbytes / ms / 1e6:.2f} GB/s), {dev_ms:.5f} ms on the "
            f"device ({bound / dev_ms:.0%} of the bound), {us:.1f} us of "
            f"host time per call; plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}"
            f"; bound {bound:.6f} ms ({by})")
        del xs
    torch.cuda.empty_cache()
    return out


# the recovery program's folds: (B, H, rl) helper stacks of the
# benchmark's recovery cells, RS k=8 m=3's 8 full rows and Clay k=8 m=4
# d=11's 11 helpers' 16 shipped planes of 8 KiB, 128 objects an op
FOLD_ROWS = (("fold_rs_128x8x512KiB", (128, 8, 524288)),
             ("fold_clay_128x11x128KiB", (128, 11, 131072)))
# a ragged row: 4,093-byte rows (the RMW delta's window), which run the
# kernel's byte-place instance; 2,048 of them, so the stack (67 MB)
# does not stay in L2 from one call to the next
FOLD_RAGGED = ("fold_ragged_2048x8x4093", (2048, 8, 4093))


def fold_table(torch, dev, plain: bool = True) -> dict:
    """The XOR fold kernel at FOLD_ROWS and FOLD_RAGGED: held byte for
    byte against the plain torch loop (the largest absolute difference
    of a byte in "max_abs_err", which has to be 0), then ms per call
    (CUDA events around 20 calls), its device ms per launch (a trace),
    host us per call, the bound (B * (H + 1) * rl bytes through HBM)
    and the device time's share of it, and with `plain` the plain
    loop's ms (the fold's path before the kernel). Each input is over
    50 MB, so a call finds no more of its input in L2 than the end of
    the call before it, which it reaches last."""
    from ceph_tpu_torch.ops import fold_kernel as F

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    out = {"max_abs_err": 0}
    for label, (B, H, L) in FOLD_ROWS + (FOLD_RAGGED,):
        x = torch.randint(0, 256, (B, H, L), dtype=torch.uint8, device=dev,
                          generator=gen)
        n0 = F.xor_fold.launches
        got = F.xor_fold(x, 1)
        torch.cuda.synchronize()
        if F.xor_fold.launches - n0 != 1:
            fail(f"{label}: one xor_fold call made "
                 f"{F.xor_fold.launches - n0} launches")
        err = int((got.to(torch.int16) - F.xor_fold_plain(x, 1)
                   .to(torch.int16)).abs().max())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if err:
            fail(f"{label}: xor_fold disagrees with its plain version "
                 f"(max_abs_err={err})")
        del got

        def fn():
            return F.xor_fold(x, 1)
        ms = cuda_ms(fn, calls=20)
        dev_ms, dev_from = kernel_device_ms(fn, "xor_fold_kernel")
        us = host_us(fn)
        plain_ms = cuda_ms(lambda: F.xor_fold_plain(x, 1), 1, 3) \
            if plain else None
        bound = B * (H + 1) * L / HBM_BYTES_PER_S * 1e3
        out[label] = {"ms": ms, "device_ms": dev_ms,
                      "device_ms_from": dev_from, "host_us": us,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": "bytes", "shape": [B, H, L],
                      "place_bytes": F.place_bytes(
                          x.data_ptr(), x.stride(0), x.stride(1), L,
                          0),
                      "device_share_of_bound": bound / dev_ms,
                      "device_gbps": B * (H + 1) * L / dev_ms / 1e6}
        log(f"  xor_fold ({B},{H},{L})->({B},{L}), "
            f"{out[label]['place_bytes']}-byte places: equal to plain; "
            f"{ms:.5f} ms per call, {dev_ms:.5f} ms on the device "
            f"({bound / dev_ms:.1%} of the bound {bound:.5f} ms, "
            f"{B * (H + 1) * L / dev_ms / 1e6:.0f} GB/s), {us:.1f} us of "
            f"host time per call; plain loop "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}")
        del x
    torch.cuda.empty_cache()
    return out


def sass_loops(lib) -> dict:
    """The loops of each kernel in a built library, from `cuobjdump
    -sass` beside the nvcc that built it: for every backward branch that
    holds loads (LDS or LDG) and no shared-memory store, the
    instructions from its target to the branch, their count, the LDS
    and LDG among them and the bytes an iteration consumes (one 32-bit
    LDS, a table lookup, a byte where the loop looks tables up, else 16
    a 16-byte LDG or LDS), by function name. Empty where cuobjdump is
    missing or fails."""
    import re

    from ceph_tpu_torch.utils import nvcc
    tool = Path(nvcc.find()).with_name("cuobjdump")
    try:
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        log(f"  cuobjdump failed: {exc}")
        return {}
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                funcs[name].append((None, m.group(1)))
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                funcs[name].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, items in funcs.items():
        labels, ins, pending = {}, [], []
        for addr, txt in items:
            if addr is None:
                pending.append(txt)
                continue
            labels.update({lb: addr for lb in pending})
            pending = []
            ins.append((addr, re.sub(r"^@!?U?P\w+\s+", "", txt)))
        loops = []
        for addr, txt in ins:
            m = re.match(r"BRA\S*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))",
                         txt)
            if not m:
                continue
            tgt = labels.get(m.group(1)) if m.group(1) \
                else int(m.group(2), 16)
            if tgt is None or tgt > addr:
                continue
            ops = [t.split()[0] for a, t in ins if tgt <= a <= addr]
            lds = sum(o.startswith("LDS") for o in ops)
            ldg = sum(o.startswith("LDG") for o in ops)
            if lds + ldg == 0 or any(o.startswith("STS") for o in ops):
                continue
            lookups = sum(o.startswith("LDS") and "128" not in o
                          for o in ops)
            nbytes = lookups or 16 * sum(
                o.startswith(("LDG", "LDS")) and "128" in o for o in ops)
            loops.append({"instructions": len(ops), "lds": lds, "ldg": ldg,
                          "lookups": lookups,
                          "bytes": nbytes,
                          "per_byte": len(ops) / nbytes if nbytes else None})
        if loops:
            out[name] = loops
    return out


MICRO_PARTS = ("loads only, each lane its own", "loads only, coalesced",
               "shared tables, random data",
               "lane-private tables, random data",
               "lane-private tables, each lane's own loads",
               "loads only, staged as the kernel stages them")


def crc_microbench(torch, dev) -> dict:
    """The CRC kernel's parts on the card (tools/crc_microbench.cu) over
    256 rows of 512 KiB, the items and segments `plan_for` gives them:
    each part's ms per launch (CUDA events around 20 launches), its GB/s
    and its hottest loop's instructions a byte (`sass_loops`), beside
    the whole kernel's (crc32c_blocks on the same rows) and the bytes
    bound."""
    import ctypes

    from ceph_tpu_torch.csum import kernels as C
    from ceph_tpu_torch.utils import nvcc

    src = Path(__file__).resolve().parent / "tools" / "crc_microbench.cu"
    path = nvcc.build(src)
    lib = ctypes.CDLL(str(path))
    P = ctypes.c_void_p
    lib.crc_probe.argtypes = [ctypes.c_int, P, ctypes.c_longlong,
                              ctypes.c_int, P, ctypes.c_int, P]
    lib.crc_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, L = BATCH * K, OBJECT_SIZE // K
    plan = C.make_plan(L, 512, 32)        # 32 units a lane, as plan_for
    items = B * plan.segments // 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 22)
    data = torch.randint(0, 256, (B * L,), dtype=torch.uint8, device=dev,
                         generator=gen)
    grid = min(sms, items)
    out = torch.empty(grid * 1024, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(mode):
        rc = lib.crc_probe(mode, data.data_ptr(), items, plan.seg,
                           out.data_ptr(), grid, stream)
        if rc:
            fail(f"crc_probe mode {mode}: cudaError {rc}")
    sass = sass_loops(path)
    sass.update(sass_loops(C.build()))
    bound, _ = csum_bound(B, L, 8, 2.0)
    res = {"rows": [B, L], "segments": plan.segments, "seg_units": plan.seg,
           "items": items, "grid": grid, "bound_ms": bound}
    for mode, part in enumerate(MICRO_PARTS):
        ms = cuda_ms(lambda: run(mode), calls=20)
        loops = [v for k, v in sass.items() if f"probeILi{mode}E" in k]
        res[part] = {"ms": ms, "gbps": B * L / ms / 1e6,
                     "sass_loops": loops[0] if loops else "not measured"}
        log(f"  microbench {part}: {ms:.5f} ms ({B * L / ms / 1e6:.1f} "
            f"GB/s); loops {res[part]['sass_loops']}")
    rows = data.view(B, L)
    ms = cuda_ms(lambda: C.crc32c_blocks(rows, 0xFFFFFFFF, 0), calls=20)
    loops = [v for k, v in sass.items() if "crc32c_kernel" in k]
    res["the kernel"] = {"ms": ms, "gbps": B * L / ms / 1e6,
                         "sass_loops": loops or "not measured"}
    log(f"  microbench the kernel: {ms:.5f} ms; bound {bound:.5f} ms; "
        f"loops {res['the kernel']['sass_loops']}")
    del data, out
    torch.cuda.empty_cache()
    return res


def measure(torch, dev, ctx) -> dict:
    import numpy as np

    from ceph_tpu_torch.csum.kernels import crc32c_blocks
    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.osd.ecbackend import _fused_delta_fn

    coder, sl = ctx["coder"], ctx["sl"]
    out, mats = gf_table(torch, dev)
    out["csum"] = csum_table(torch, dev)
    out["fold"] = fold_table(torch, dev)
    for label, mat in mats.items():
        sched = G.compile_schedule(mat)
        out[label]["entries"] = len(sched.ent)
        out[label]["chunks"] = int(np.diff(sched.gch).max(initial=0))
        out[label]["coefficients_from"] = \
            "shared" if G.stages(sched) else "global"
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    data = torch.randint(0, 256, (BATCH, K, sl), dtype=torch.uint8,
                         device=dev, generator=gen)
    in_bytes = BATCH * K * sl
    t_enc = cuda_ms(lambda: coder.encode_chunks(data))
    t_write = cuda_ms(lambda: ctx["write"](data))
    t_dec = cuda_ms(lambda: ctx["dec_fn"](data))
    expfold = torch.zeros(BATCH, dtype=torch.int64, device=dev)
    t_rec = cuda_ms(lambda: ctx["recover"](data, expfold))
    # the RMW delta program of phase 5's 4093-byte windows (2 of k rows)
    delta = _fused_delta_fn(
        np.ascontiguousarray(coder.matrix[:, :2]).tobytes(), M, 2,
        coder.impl, 4093, BATCH, coder.device)
    d = torch.randint(0, 256, (BATCH, 2, 4093), dtype=torch.uint8,
                      device=dev, generator=gen)
    t_delta = cuda_ms(lambda: delta(d))
    # one CRC launch a call of each fused program
    for label, call in (("the fused write", lambda: ctx["write"](data)),
                        ("the fused delta", lambda: delta(d)),
                        ("the recovery program",
                         lambda: ctx["recover"](data, expfold))):
        n0 = csum_counts()["crc32c"]
        call()
        if csum_counts()["crc32c"] - n0 != 1:
            fail(f"one call of {label} launched the CRC32C kernel "
                 f"{csum_counts()['crc32c'] - n0} times, not once")
    log("  the fused write, the fused delta and the recovery program "
        "each launch the CRC32C kernel once a call")
    from ceph_tpu_torch.ops import fold_kernel as F
    n0 = F.xor_fold.launches
    ctx["recover"](data, expfold)
    if F.xor_fold.launches - n0 != 1:
        fail(f"one call of the recovery program launched the XOR fold "
             f"kernel {F.xor_fold.launches - n0} times, not once")
    log("  the recovery program launches the XOR fold kernel once a call")
    rows = data.reshape(BATCH * K, sl)
    t_crc = cuda_ms(lambda: crc32c_blocks(rows, init=0xFFFFFFFF, xorout=0))
    e2e = {"encode_gbps": in_bytes / t_enc / 1e6,
           "fused_write_gbps": in_bytes / t_write / 1e6,
           "decode_gbps": in_bytes / t_dec / 1e6,
           "recovery_objects_per_s": BATCH / t_rec * 1e3,
           "encode_ms": t_enc, "fused_write_ms": t_write,
           "decode_ms": t_dec, "recover_ms": t_rec,
           "fused_delta_ms": t_delta,
           "crc32c_gbps": BATCH * K * sl / t_crc / 1e6,
           "crc32c_ms_per_8_rows_of_batch": t_crc}
    log(f"  encode_chunks {e2e['encode_gbps']:.2f} GB/s "
        f"({t_enc:.4f} ms / batch of {BATCH}); fused write (encode + 11 "
        f"CRCs) {e2e['fused_write_gbps']:.2f} GB/s ({t_write:.4f} ms)")
    log(f"  decode 2-loss {e2e['decode_gbps']:.2f} GB/s ({t_dec:.4f} ms); "
        f"fused recovery (decode + rebuilt CRCs + fold verify) "
        f"{e2e['recovery_objects_per_s']:.1f} objects/s ({t_rec:.4f} ms); "
        f"fused RMW delta ({BATCH}, 2, 4093) {t_delta:.4f} ms")
    log(f"  crc32c_blocks over {BATCH * K} rows of {sl} B: {t_crc:.4f} ms "
        f"({e2e['crc32c_gbps']:.2f} GB/s)")
    out["e2e"] = e2e
    return out


# ------------------------------------------------------------- phase 5

def backend_path(torch, dev) -> dict:
    """The PG data path through ECBackend and RecoveryRunner at full
    width; returns the phase's rates, span totals and counters."""
    import numpy as np

    from ceph_tpu_torch.osd.ecbackend import (HINFO_KEY, ECBackend,
                                              ShardSet, Transaction,
                                              _fused_write_fn, shard_cid)
    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.osd.stripe import HashInfo

    n = K + M
    sl = OBJECT_SIZE // K
    pg = "1.0"
    be = ECBackend(PROFILE, pg, list(range(n)), ShardSet(), chunk_size=sl,
                   device=dev)
    if be.device.type != dev.type or be.sinfo.chunk_size != sl \
            or be.coder.impl != "pallas":
        fail(f"backend on {be.device}, chunk {be.sinfo.chunk_size}, "
             f"impl {be.coder.impl}")
    names = [f"obj{i:04d}" for i in range(N_BACKEND)]
    groups = [names[i:i + BATCH] for i in range(0, N_BACKEND, BATCH)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    objs: dict = {}

    # 1. writes, 32 objects per call
    t_write = 0.0
    for g in groups:
        batch = torch.randint(0, 256, (len(g), OBJECT_SIZE),
                              dtype=torch.uint8, device=dev,
                              generator=gen).cpu().numpy()
        chunk = {nm: batch[i] for i, nm in enumerate(g)}
        objs.update(chunk)
        t0 = time.perf_counter()
        be.write_objects(chunk)
        t_write += time.perf_counter() - t0
    write_gbps = N_BACKEND * OBJECT_SIZE / t_write / 1e9
    log(f"  write_objects: {N_BACKEND} x {OBJECT_SIZE >> 20} MiB in "
        f"{t_write:.3f} s: {write_gbps:.3f} GB/s (host clock)")

    # 2. reads, then 3. a degraded read with shards 0 and 9 down
    for dead, label in (((), "read"), ((be.acting[0], be.acting[9]),
                                       "degraded read (0, 9 down)")):
        t0 = time.perf_counter()
        for g in groups:
            got = be.read_objects(g, dead_osds=set(dead))
            for nm in g:
                if not np.array_equal(got[nm], objs[nm]):
                    fail(f"{label} of {nm} differs from the write")
        log(f"  {label}: {N_BACKEND} objects bit-exact in "
            f"{time.perf_counter() - t0:.3f} s")

    # 4. one flipped byte in a helper shard the recovery will read
    flip_slot, flip_name, flip_off = 3, names[37], sl // 3
    st = be.cluster.osd(be.acting[flip_slot])
    cid = shard_cid(pg, flip_slot)
    byte = st.read(cid, flip_name, flip_off, 1)
    st.queue_transaction(Transaction().write(
        cid, flip_name, flip_off, (byte ^ 0x5A).astype(np.uint8)))

    # 5. lose shards 0 and 9; RecoveryRunner rebuilds them
    lost = list(LOST)
    from ceph_tpu_torch.ops import gf_kernel as G
    old = {s: be.cluster.stores.pop(be.acting[s]) for s in lost}
    before = gf_counts(G)[1]
    t0 = time.perf_counter()
    counters = be.recover_shards(lost, replacement_osds={
        s: 100 + s for s in lost}, batch=BATCH)
    t_rec = time.perf_counter() - t0
    rec_rate = counters["objects"] / t_rec
    rec_shapes = gf_counts(G)[1]
    rec_shapes.subtract(before)
    log(f"  recover_shards({lost}, batch={BATCH}): {counters} in "
        f"{t_rec:.3f} s: {rec_rate:.1f} objects/s (host clock); gf_apply "
        f"launches by (k,m,L,vec): {json.dumps(by_shape(+rec_shapes))}")
    if counters["objects"] != N_BACKEND or counters["hinfo_failures"] < 1:
        fail(f"recovery counters {counters}: want {N_BACKEND} objects "
             f"and the flipped helper flagged")
    for s in lost:
        new_st = be.cluster.osd(100 + s)
        scid = shard_cid(pg, s)
        for nm in names:
            if not np.array_equal(new_st.read(scid, nm),
                                  old[s].read(scid, nm)):
                fail(f"rebuilt shard {s} of {nm} differs from the write")
            if new_st.getattr(scid, nm, HINFO_KEY) != \
                    old[s].getattr(scid, nm, HINFO_KEY):
                fail(f"rebuilt hinfo of shard {s} of {nm} differs")
    log(f"  rebuilt shards {lost} of {N_BACKEND} objects and their hinfo "
        f"equal the write's, the flipped helper's object included")

    # 6. repair the flipped helper, then a clean deep scrub
    rep = be.repair_pg()
    if rep["repaired"] != 1 or rep["objects"] != 1:
        fail(f"repair_pg {rep}: want the one flipped shard repaired")
    scrub = be.deep_scrub()
    if scrub["inconsistent"] or scrub["checked"] != N_BACKEND * n \
            or scrub["journal_bad"]:
        fail(f"deep_scrub not clean: {scrub}")
    log(f"  repair_pg {rep}; deep_scrub checked {scrub['checked']} "
        f"shards, clean")

    # 7. one RMW delta wave over 32 objects with ragged windows
    rng = np.random.default_rng(SEED + 7)
    wave = names[:BATCH]
    ops = []
    for nm in wave:
        for off, ln in ((3, 5), (OBJECT_SIZE // 4 + 7, 4093)):
            patch = rng.integers(0, 256, ln, dtype=np.uint8)
            ops.append((nm, off, patch))
            objs[nm] = objs[nm].copy()
            objs[nm][off:off + ln] = patch
    rmw0 = be.perf.get("rmw_ops")
    t0 = time.perf_counter()
    be.write_ranges(ops)
    t_rmw = time.perf_counter() - t0
    if be.perf.get("rmw_ops") - rmw0 != BATCH \
            or be.perf.get("rmw_full_fallbacks"):
        fail(f"RMW wave took the full path: rmw_ops "
             f"{be.perf.get('rmw_ops') - rmw0}, fallbacks "
             f"{be.perf.get('rmw_full_fallbacks')}")
    got = be.read_objects(wave)
    data = np.stack([got[nm] for nm in wave])
    if not np.array_equal(data, np.stack([objs[nm] for nm in wave])):
        fail("RMW wave: objects read back differ from the overlay")
    full = _fused_write_fn(be.coder.matrix.tobytes(), M, K, be.coder.impl,
                           sl, BATCH, be.device)
    ref0, crc0 = gf_counts(G), csum_counts()    # the reference is not
    shapes0 = crc_shapes()                      # the path
    parity, crcs = full(torch.from_numpy(
        be.sinfo.object_to_shards(data)).to(dev))
    gf_set(G, ref0)
    csum_set(crc0, shapes0)
    parity, crcs = parity.cpu().numpy(), crcs.cpu().numpy()
    for bi, nm in enumerate(wave):
        for s in range(n):
            st = be.cluster.osd(be.acting[s])
            scid = shard_cid(pg, s)
            h = HashInfo.from_bytes(st.getattr(scid, nm, HINFO_KEY))
            if h.get_chunk_hash(0) != int(crcs[bi, s]):
                fail(f"RMW hinfo of shard {s} of {nm} differs from a "
                     f"full re-encode")
            if s >= K and not np.array_equal(st.read(scid, nm),
                                             parity[bi, s - K]):
                fail(f"RMW parity shard {s} of {nm} differs from a full "
                     f"re-encode")
    log(f"  RMW delta wave: {BATCH} objects x 2 ragged windows in "
        f"{t_rmw:.3f} s; parity and hinfo equal a full re-encode")

    # 8. nothing left in the stripe journal
    replay = be.stripe_journal_replay()
    if replay != {"forward": 0, "rolled_back": 0, "entries": 0}:
        fail(f"stripe_journal_replay found pending intents: {replay}")
    spans = {k: be.perf.get(k)["sum"] for k in (
        "encode_time", "recover_stage_time", "recover_launch_time",
        "recover_fetch_time", "recover_writeback_time")}
    log(f"  span totals (s): " + json.dumps(spans))
    launches, shapes = gf_counts(G)
    log(f"  gf_apply launches in phase 5: {launches}, by (k,m,L,vec): "
        f"{json.dumps(by_shape(shapes))}")
    if launches == 0:
        fail("the backend path never launched gf_apply")
    crc = crc_launches("phase 5")
    trace = trace_backend(torch, be, gen)
    return {"gf_apply_launches": launches, "crc32c_launches": crc,
            "gf_apply_by_shape": by_shape(shapes),
            "write_gbps": write_gbps, "write_s": t_write,
            "recovery_objects_per_s": rec_rate, "recover_s": t_rec,
            "rmw_wave_s": t_rmw, "spans_s": spans,
            "recover_counters": counters, "trace": trace}


def device_events(prof) -> list:
    """The profile's device-side entries (kernels and copies). Host ops
    that launched them, and the spans' ranges that the profiler mirrors
    onto the device timeline, are left out, so nothing counts twice."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy_s(prof) -> float | None:
    """Seconds of device work (kernels and copies) in a profile; None,
    logged, where the trace holds no device entry at all (the tracer
    lost its records: see `kernel_device_ms`)."""
    evs = device_events(prof)
    if not evs:
        log("  the trace holds no device entry: device busy time and "
            "idle share not measured")
        return None
    return sum(e.self_device_time_total for e in evs) / 1e6


def idle_share(busy: float | None, wall: float) -> float | None:
    """1 - device-busy / wall, or None where busy was not measured."""
    return None if busy is None else 1 - busy / wall


def show(x: float | None) -> str:
    """A share or a time in seconds for a log line."""
    return "not measured" if x is None else f"{x:.4f}"


def trace_backend(torch, be, gen) -> dict:
    """Where phase 5's time goes, after its checks: one more write
    group and a one-shard recovery under torch.profiler (the device's
    busy share of the wall time), and one more write group under
    cProfile (the host functions that take the write's time)."""
    import cProfile
    import pstats

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.osd.ecbackend import shard_cid

    def group(tag):
        batch = torch.randint(0, 256, (BATCH, OBJECT_SIZE), dtype=torch.uint8,
                              device=gen.device, generator=gen)
        return {f"{tag}{i:02d}": row for i, row in
                enumerate(batch.cpu().numpy())}

    out = {}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        be.write_objects(group("tw"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["write_group_s"] = wall
    out["write_device_busy_s"] = device_busy_s(prof)
    slot = 5
    old = be.cluster.stores.pop(be.acting[slot])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        counters = be.recover_shards([slot], replacement_osds={slot: 105},
                                     batch=BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cid = shard_cid(be.pg, slot)
    for nm in old.list_objects(cid):
        if not np.array_equal(be.cluster.osd(105).read(cid, nm),
                              old.read(cid, nm)):
            fail(f"traced recovery of shard {slot} of {nm} differs")
    out["recover_objects"] = counters["objects"]
    out["recover_s"] = wall
    out["recover_device_busy_s"] = device_busy_s(prof)
    out["recover_top_device"] = [
        [e.key[:60], e.self_device_time_total / 1e3, e.count]
        for e in sorted(device_events(prof),
                        key=lambda e: -e.self_device_time_total)[:6]]
    cp = cProfile.Profile()
    objs = group("tc")
    cp.enable()
    be.write_objects(objs)
    cp.disable()
    stats = pstats.Stats(cp)
    out["write_host_top"] = [
        [f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}:{fn[2]}", tt, ct]
        for fn, (_cc, _nc, tt, ct, _callers) in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][2])[:10]]
    for k in ("write", "recover"):
        busy = out[f"{k}_device_busy_s"]
        wall = out[f"{k}_group_s" if k == "write" else "recover_s"]
        log(f"  traced {k}: wall {wall:.4f} s, device busy {show(busy)} "
            f"s, idle share {show(idle_share(busy, wall))}")
    log("  trace " + json.dumps(out))
    return out


# ------------------------------------------------------------- phase 6

def _oracle_rows(job) -> list:
    """Worker: the scalar OracleMapper's rows for a slice of seeds,
    NONE-padded to n like the VectorMapper's."""
    crush, rule_id, xs, weights, n = job
    from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
    from ceph_tpu_torch.crush.oracle import OracleMapper
    om = OracleMapper(crush)
    return [(om.do_rule(rule_id, int(x), weights, n)
             + [CRUSH_ITEM_NONE] * n)[:n] for x in xs]


def _scalar_up(job) -> list:
    """Worker: up sets from pg_to_up_acting_osds, the scalar path, on
    the same map decoded from its wire form."""
    blob, pool, pss = job
    from ceph_tpu_torch.osd.osdmap import OSDMap
    m = OSDMap.decode(blob, device="cpu")
    return [m.pg_to_up_acting_osds(pool, int(ps))[0] for ps in pss]


def on_host_workers(fn, jobs) -> list:
    """Run the scalar checks in worker processes (spawned, and stopped
    when the pool closes); results in job order."""
    n = max(1, min(8, os.cpu_count() or 1, len(jobs)))
    with multiprocessing.get_context("spawn").Pool(n) as pool:
        return pool.map(fn, jobs)


def slices(items, n: int = 16) -> list:
    step = -(-len(items) // n)
    return [items[i:i + step] for i in range(0, len(items), step)]


def gather_bytes_per_lane(vm, rule_id: int, numrep: int) -> int:
    """Table bytes one lane gathers in one round of the rule (every
    replica once): for each straw2 bucket_choose step of width S, the
    items (int32), zero-weight flags (bool), weight-table indices and
    q values (int64) of S slots, plus the bucket's alg, size and type
    (int32); plus the reweight of the chosen device."""
    per_rep = 0
    for widths, leaf_widths in vm._plan(rule_id).values():
        per_rep += sum(21 * S + 12 for S in widths + leaf_widths) + 4
    return per_rep * numrep


def entry_device(dev) -> dict:
    """Keyword arguments for an entry point: none on the card, where a
    user passes none; the device itself for a rehearsal on the CPU."""
    return {} if dev.type == "cuda" else {"device": dev}


def placement_path(torch, dev) -> dict:
    """CRUSH config #5 through the VectorMapper and the OSDMap on the
    card; fails unless every sampled lane and PG is the oracle's and the
    10M digest is the JAX package's."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.crush.map import build_hierarchy, ec_rule
    from ceph_tpu_torch.crush.mapper import VectorMapper, full_weights
    from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool

    crush = build_hierarchy(CRUSH_OSDS, osds_per_host=10, hosts_per_rack=25)
    ec_rule(crush, 1, choose_type=1)
    w = full_weights(CRUSH_OSDS)
    n = CRUSH_NUMREP
    t0 = time.perf_counter()
    vm = VectorMapper(crush, **entry_device(dev))
    build_s = time.perf_counter() - t0
    if vm.device.type != dev.type:
        fail(f"VectorMapper on {vm.device}")
    rng = np.random.default_rng(SEED + 6)
    out = {"map_build_s": build_s, "plan": {str(k): v for k, v in
                                            vm._plan(1).items()}}

    # (a) 10,000 seeds; 2,000 sampled lanes against the oracle
    xs = np.arange(CRUSH_LANES, dtype=np.uint32)
    got = vm.do_rule(1, xs, w, n).cpu().numpy()
    sample = np.sort(rng.choice(CRUSH_LANES, CRUSH_SAMPLE, replace=False))
    t0 = time.perf_counter()
    want = np.concatenate([np.asarray(r, dtype=np.int32).reshape(-1, n)
                           for r in on_host_workers(_oracle_rows, [
                               (crush, 1, sl, w, n)
                               for sl in slices(xs[sample])])])
    bad = sample[(got[sample] != want).any(axis=1)]
    if bad.size:
        fail(f"do_rule differs from the oracle at {bad.size} of "
             f"{CRUSH_SAMPLE} sampled lanes, first seed {int(bad[0])}: "
             f"{got[bad[0]].tolist()} != "
             f"{want[np.searchsorted(sample, bad[0])].tolist()}")
    log(f"  do_rule({CRUSH_LANES} seeds): {CRUSH_SAMPLE} sampled lanes "
        f"equal the OracleMapper's bit for bit (oracle "
        f"{time.perf_counter() - t0:.1f} s on the host)")
    s0 = vm.host_syncs
    out["do_rule_10k_ms"] = cuda_ms(lambda: vm.do_rule(1, xs, w, n),
                                    warm=1, reps=5)
    out["do_rule_10k_syncs"] = (vm.host_syncs - s0) / 6
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for lanes in (CRUSH_LANES, CRUSH_SUB):
        seeds = np.arange(lanes, dtype=np.uint32)
        vm.do_rule(1, seeds, w, n)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            vm.do_rule(1, seeds, w, n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = device_busy_s(prof)
        out[f"trace_{lanes}"] = {
            "wall_s": wall, "device_busy_s": busy,
            "idle_share": idle_share(busy, wall),
            "device_ops": sum(e.count for e in device_events(prof)),
            "top_device": [[e.key[:50], e.self_device_time_total / 1e3,
                            e.count] for e in sorted(
                device_events(prof),
                key=lambda e: -e.self_device_time_total)[:5]]}
    log(f"  do_rule, {CRUSH_LANES} lanes: {out['do_rule_10k_ms']:.2f} ms "
        f"({CRUSH_LANES / out['do_rule_10k_ms'] * 1e3:.0f} placements/s), "
        f"{out['do_rule_10k_syncs']:.0f} host syncs, "
        f"{out[f'trace_{CRUSH_LANES}']['device_ops']} device ops, idle "
        f"share {show(out[f'trace_{CRUSH_LANES}']['idle_share'])}")

    # (b) 10,000,000 placements; the digest must be the JAX package's
    nb = CRUSH_PLACEMENTS // CRUSH_SUB
    s0 = vm.host_syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    digest, last = vm.scan_rule(1, w, n, 0, CRUSH_SUB, nb)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    if digest != CRUSH_DIGEST:
        fail(f"scan_rule digest {digest} over {CRUSH_PLACEMENTS} "
             f"placements != the JAX package's {CRUSH_DIGEST}")
    filled = int((last.cpu().numpy() != 0x7FFFFFFF).sum(axis=1).min())
    if filled != n:
        fail(f"last scan batch: a lane filled only {filled} of {n} slots")
    out.update({
        "scan_placements": CRUSH_PLACEMENTS, "scan_sub": CRUSH_SUB,
        "scan_s": scan_s, "placements_per_s": CRUSH_PLACEMENTS / scan_s,
        "scan_syncs_per_batch": (vm.host_syncs - s0) / nb,
        "digest": digest})
    per_lane = gather_bytes_per_lane(vm, 1, n)
    out["gather_bytes_per_lane"] = per_lane
    out["gather_bound_ms"] = \
        per_lane * CRUSH_PLACEMENTS / HBM_BYTES_PER_S * 1e3
    # each input read once (the map tables, the reweights), each output
    # written once (int32 rows); the seeds are made on the card
    io = CRUSH_PLACEMENTS * n * 4 + sum(
        t.numel() * t.element_size() for k, t in vars(vm).items()
        if k.startswith("t_")) + w.nbytes
    out["bound_ms"] = io / HBM_BYTES_PER_S * 1e3
    log(f"  scan_rule: {CRUSH_PLACEMENTS} placements in {scan_s:.3f} s: "
        f"{out['placements_per_s']:.1f} placements/s, digest {digest} "
        f"(= CRUSH_10M.json), {out['scan_syncs_per_batch']:.1f} host syncs "
        f"per {CRUSH_SUB}-lane batch; bound {out['bound_ms']:.3f} ms "
        f"(bytes in and out), table gathers {per_lane} B/lane: "
        f"{out['gather_bound_ms']:.1f} ms")

    # (c) an OSDMap pool at pg_num 131072, one pgs_to_up
    osdmap = OSDMap(crush, **entry_device(dev))
    osdmap.add_pool(PGPool(1, pg_num=CRUSH_PG_NUM, size=n, min_size=K + 1,
                           crush_rule=1, is_erasure=True))
    if osdmap.device != vm.device:
        fail(f"OSDMap on {osdmap.device}")
    t0 = time.perf_counter()
    up = osdmap.pgs_to_up(1)
    up_s = time.perf_counter() - t0
    pss = np.sort(rng.choice(CRUSH_PG_NUM, CRUSH_SAMPLE, replace=False))
    want = np.concatenate([np.asarray(r, dtype=np.int32).reshape(-1, n)
                           for r in on_host_workers(_scalar_up, [
                               (osdmap.encode(), 1, sl)
                               for sl in slices(pss)])])
    bad = pss[(up[pss] != want).any(axis=1)]
    if up.shape != (CRUSH_PG_NUM, n) or bad.size:
        fail(f"pgs_to_up {up.shape} differs from pg_to_up_acting_osds at "
             f"{bad.size} of {CRUSH_SAMPLE} sampled PGs")
    out["pgs_to_up_s"] = up_s
    log(f"  OSDMap pool pg_num {CRUSH_PG_NUM}: pgs_to_up in {up_s:.3f} s; "
        f"{CRUSH_SAMPLE} sampled PGs equal pg_to_up_acting_osds")
    return out


# ------------------------------------------------------------- phase 7

def cluster_path(torch, dev, **store) -> dict:
    """SimCluster's failure -> remap -> recovery path over ECBackend on
    the card, at the BASELINE geometry; every read is held bit for bit
    against the bytes written. `store` goes to SimCluster: with
    store="tin" the revive is a remount from the OSD's WAL, and the
    phase ends with a bare remount of one store, a clean deep scrub of
    every PG and the reads once more."""
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.osd.cluster import SimCluster

    c = SimCluster(n_osds=CLUSTER_OSDS, osds_per_host=CLUSTER_PER_HOST,
                   pg_num=CLUSTER_PGS, profile=PROFILE,
                   chunk_size=OBJECT_SIZE // K, **store,
                   **entry_device(dev))
    be = c.pgs[0]
    if c.device.type != dev.type or be.device != c.device \
            or c.osdmap.device != c.device or be.coder.impl != "pallas" \
            or c.pool_size != K + M:
        fail(f"cluster on {c.device}, backend on {be.device} with impl "
             f"{be.coder.impl}, pool size {c.pool_size}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    objs: dict = {}

    def objects(tag: str, n: int) -> dict:
        batch = torch.randint(0, 256, (n, OBJECT_SIZE), dtype=torch.uint8,
                              device=dev, generator=gen).cpu().numpy()
        return {f"{tag}{i:02d}": batch[i] for i in range(n)}

    def verify(label: str) -> None:
        t0 = time.perf_counter()
        try:
            ok = c.verify_all(objs)
        except (AssertionError, KeyError, ValueError) as e:
            fail(f"{label}: {e!r}")
        log(f"  verify_all ({label}): {ok} objects bit-exact in "
            f"{time.perf_counter() - t0:.3f} s")

    out = {}
    t_write = 0.0
    for g in range(CLUSTER_OBJECTS // BATCH):
        group = objects(f"g{g}_", BATCH)
        objs.update(group)
        t0 = time.perf_counter()
        c.write(group)
        t_write += time.perf_counter() - t0
    out["write_s"] = t_write
    out["write_gbps"] = CLUSTER_OBJECTS * OBJECT_SIZE / t_write / 1e9
    log(f"  write: {CLUSTER_OBJECTS} x {OBJECT_SIZE >> 20} MiB over "
        f"{CLUSTER_PGS} PGs in {t_write:.3f} s ({out['write_gbps']:.3f} "
        f"GB/s, host clock)")

    # kill -> heartbeats go silent -> marked down; degraded reads
    a = be.acting[0]
    c.kill_osd(a)
    c.tick(30)
    h = c.health()
    if c.osdmap.osd_up[a] or h["pgs_degraded"] == 0:
        fail(f"osd.{a} killed: up in the map {bool(c.osdmap.osd_up[a])}, "
             f"{h['pgs_degraded']} degraded PGs")
    out["degraded_pgs"] = h["pgs_degraded"]
    verify(f"osd.{a} down, {h['pgs_degraded']} PGs degraded")

    # disk lost -> out after down_out_interval -> remap -> recovery
    c.destroy_osd(a)
    rec0 = c.perf.get("recovered_objects")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        c.tick(c.down_out_interval)
        torch.cuda.synchronize()
        tick_s = time.perf_counter() - t0
    busy = device_busy_s(prof)
    recovered = c.perf.get("recovered_objects") - rec0
    holders = [ps for ps, pg in c.pgs.items() if a in pg.acting]
    h = c.health()
    if c.osdmap.osd_weight[a] != 0 or holders or recovered == 0 \
            or h["pgs_degraded"]:
        fail(f"after the out: weight {int(c.osdmap.osd_weight[a])}, PGs "
             f"still on osd.{a}: {holders}, recovered {recovered}, "
             f"{h['pgs_degraded']} degraded PGs")
    out.update({"recovery_tick_s": tick_s, "recovered_objects": recovered,
                "recovery_device_busy_s": busy,
                "recovery_idle_share": idle_share(busy, tick_s),
                "recovery_objects_per_s": recovered / tick_s})
    log(f"  out -> remap -> recover: tick of {c.down_out_interval:.0f} s "
        f"(virtual) took {tick_s:.3f} s and recovered {recovered} objects "
        f"({recovered / tick_s:.1f} objects/s); device busy {show(busy)} "
        f"s, idle share {show(idle_share(busy, tick_s))} (torch.profiler)")
    verify("after the out-recovery")

    # kill, write while down, revive before out: PG-log replay
    b = next(o for o in c.pgs[1].acting if o != a)
    c.kill_osd(b)
    c.tick(30)
    if c.osdmap.osd_up[b]:
        fail(f"osd.{b} killed but still up in the map")
    more = objects("late", CLUSTER_MORE)
    objs.update(more)
    c.write(more)
    rep0 = c.perf.get("log_replayed_objects")
    t0 = time.perf_counter()
    c.revive_osd(b)
    c.tick(c.hb_interval)
    out["replay_s"] = time.perf_counter() - t0
    out["replayed_objects"] = c.perf.get("log_replayed_objects") - rep0
    h = c.health()
    if not c.osdmap.osd_up[b] or c.osdmap.osd_weight[b] == 0 \
            or out["replayed_objects"] == 0 or h["pgs_degraded"]:
        fail(f"osd.{b} revived: up {bool(c.osdmap.osd_up[b])}, weight "
             f"{int(c.osdmap.osd_weight[b])}, replayed "
             f"{out['replayed_objects']}, {h['pgs_degraded']} degraded")
    log(f"  osd.{b} down for {CLUSTER_MORE} writes, revived: "
        f"{out['replayed_objects']} objects replayed from the PG log in "
        f"{out['replay_s']:.3f} s")
    verify("after the log replay")
    out["objects"] = len(objs)
    if c.store_kind != "tin":
        return out
    # a bare remount of the store that holds the most objects: RAM state
    # dropped, the mirror rebuilt from the WAL and the KV segments
    osd = max(c.cluster.stores,
              key=lambda o: c.cluster.stores[o].used_bytes())
    st = c.cluster.stores[osd]
    n_obj = sum(len(st.list_objects(cid)) for cid in st.list_collections())
    st.crash()
    t0 = time.perf_counter()
    st.remount()
    out["remount_s"] = time.perf_counter() - t0
    out["remount_objects"] = n_obj
    log(f"  osd.{osd}'s TinStore ({n_obj} objects) remounted from its WAL "
        f"and segments in {out['remount_s']:.4f} s")
    t0 = time.perf_counter()
    for ps, pg in c.pgs.items():
        rep = pg.deep_scrub(dead_osds=c._dead_osds())
        if rep["inconsistent"]:
            fail(f"deep scrub of PG {ps}: {rep['inconsistent']}")
    out["deep_scrub_s"] = time.perf_counter() - t0
    log(f"  deep scrub of {len(c.pgs)} PGs: clean, "
        f"{out['deep_scrub_s']:.3f} s")
    verify("after the remount and the deep scrub")
    return out


# ------------------------------------------------------------- phase 8

def codec_backend(torch, dev, profile: str, n_objects: int, seed: int):
    """An ECBackend over MemStores for `profile` at 4 MiB objects, with
    `n_objects` seeded objects written in groups of 32; returns the
    backend, the objects and the host-clock write time."""
    import numpy as np

    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.osd.ecbackend import ECBackend, ShardSet

    coder = factory(profile, **entry_device(dev))
    n = coder.get_chunk_count()
    be = ECBackend(profile, "1.0", list(range(n)), ShardSet(),
                   chunk_size=coder.get_chunk_size(OBJECT_SIZE),
                   **entry_device(dev))
    if be.device.type != dev.type or be.coder.impl != "pallas" \
            or be.sinfo.stripe_width != OBJECT_SIZE:
        fail(f"{profile}: backend on {be.device}, impl {be.coder.impl}, "
             f"stripe width {be.sinfo.stripe_width}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    objs: dict = {}
    t_write = 0.0
    for g in range(0, n_objects, BATCH):
        batch = torch.randint(0, 256, (BATCH, OBJECT_SIZE), dtype=torch.uint8,
                              device=dev, generator=gen).cpu().numpy()
        group = {f"obj{g + i:04d}": batch[i] for i in range(BATCH)}
        objs.update(group)
        t0 = time.perf_counter()
        be.write_objects(group)
        t_write += time.perf_counter() - t0
    gbps = n_objects * OBJECT_SIZE / t_write / 1e9
    log(f"  {profile}: write_objects {n_objects} x {OBJECT_SIZE >> 20} MiB "
        f"in {t_write:.3f} s: {gbps:.3f} GB/s (host clock)")
    return be, objs, {"write_s": t_write, "write_gbps": gbps}


def codec_recover(be, lost: list, family: str, profile=None) -> dict:
    """Lose `lost`, rebuild them through plan_recovery + RecoveryRunner
    (batch 32, the hinfo verify on) and hold every rebuilt shard and
    hinfo against the lost store's; `profile` traces the run."""
    import numpy as np
    import torch

    from ceph_tpu_torch.osd.ecbackend import (HINFO_KEY, RecoveryRunner,
                                              shard_cid)
    from ceph_tpu_torch.ops import gf_kernel as G
    old = {s: be.cluster.stores.pop(be.acting[s]) for s in lost}
    before = gf_counts(G)[1]
    t0 = time.perf_counter()
    plan = be.plan_recovery(lost, {s: 200 + s for s in lost})
    runner = RecoveryRunner([plan], batch=BATCH)
    if profile is not None:
        with profile:
            runner.run()
            torch.cuda.synchronize()
    else:
        runner.run()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    shapes = gf_counts(G)[1]
    shapes.subtract(before)
    rp = plan.repair
    if rp.family != family:
        fail(f"recovery of {lost}: plan family {rp.family}, want {family}")
    for s in lost:
        new_st, cid = be.cluster.osd(200 + s), shard_cid(be.pg, s)
        for nm in old[s].list_objects(cid):
            if not np.array_equal(new_st.read(cid, nm),
                                  old[s].read(cid, nm)) \
                    or new_st.getattr(cid, nm, HINFO_KEY) != \
                    old[s].getattr(cid, nm, HINFO_KEY):
                fail(f"rebuilt shard {s} of {nm} ({rp.family}) differs "
                     f"from the write")
    out = {"family": rp.family, "helpers": list(rp.helpers),
           "counters": dict(plan.counters), "s": secs,
           "objects_per_s": plan.counters["objects"] / secs,
           "gf_apply_by_shape": by_shape(+shapes),
           "stats": {k: runner.stats[k] for k in (
               "batches", "fused_batches", "generic_batches",
               "range_batches", "helper_bytes_on_wire")}}
    log(f"  recover {lost} ({rp.family}, helpers {list(rp.helpers)}): "
        f"{plan.counters} in {secs:.3f} s: {out['objects_per_s']:.1f} "
        f"objects/s (host clock); {out['stats']}; gf_apply launches by "
        f"(k,m,L,vec) {json.dumps(out['gf_apply_by_shape'])}; rebuilt shards "
        f"and hinfo equal the write's")
    return out


def codec_read(be, objs: dict, dead: set, label: str) -> float:
    import numpy as np
    names = sorted(objs)
    t0 = time.perf_counter()
    for i in range(0, len(names), BATCH):
        got = be.read_objects(names[i:i + BATCH], dead_osds=dead)
        for nm in names[i:i + BATCH]:
            if not np.array_equal(got[nm], objs[nm]):
                fail(f"{label} of {nm} differs from the write")
    secs = time.perf_counter() - t0
    log(f"  {label}: {len(names)} objects bit-exact in {secs:.3f} s")
    return secs


def codec_scrub(be, label: str) -> None:
    scrub = be.deep_scrub()
    if scrub["inconsistent"] or scrub["checked"] != len(be.object_sizes) \
            * be.n:
        fail(f"{label}: deep_scrub not clean: {scrub}")
    log(f"  {label}: deep_scrub checked {scrub['checked']} shards, clean")


def flip(be, slot: int, name: str, off: int) -> None:
    """Flip one stored byte of shard `slot` of `name` (bit rot)."""
    import numpy as np

    from ceph_tpu_torch.osd.ecbackend import Transaction, shard_cid
    st = be.cluster.osd(be.acting[slot])
    cid = shard_cid(be.pg, slot)
    byte = st.read(cid, name, off, 1)
    st.queue_transaction(Transaction().write(
        cid, name, off, (byte ^ 0x5A).astype(np.uint8)))


def codecs_path(torch, dev) -> dict:
    """BASELINE configs #3 (LRC k=8 m=4 l=4) and #4 (Clay k=8 m=4 d=11)
    and SHEC k=4 m=3 c=2 through ECBackend and RecoveryRunner on the
    card; every read and rebuilt shard held against the write."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    # config #3: LRC, local repair from a group of 4
    be, objs, w = codec_backend(torch, dev, LRC_PROFILE, N_CODEC, SEED + 8)
    sl = be.sinfo.chunk_size
    first = be.coder.data_positions[0]
    one = codec_recover(be, [first], "lrc_local")
    if len(one["helpers"]) != 4 or one["stats"]["helper_bytes_on_wire"] \
            != N_CODEC * 4 * sl:
        fail(f"LRC local repair read {one['helpers']}, "
             f"{one['stats']['helper_bytes_on_wire']} bytes: want 4 "
             f"helpers of {sl} bytes per object")
    two = codec_recover(be, [first, first + 1], "lrc_multi")
    dead = {be.acting[first], be.acting[be.n - 1]}
    rd = codec_read(be, objs, dead, f"LRC degraded read ({sorted(dead)} "
                    f"down)")
    codec_scrub(be, "LRC")
    out["lrc"] = {**w, "local": one, "multi": two, "degraded_read_s": rd,
                  "helper_ratio": be.k / len(one["helpers"])}
    del be, objs

    # config #4: Clay, the sub-chunk range repair and the coupled decode
    be, objs, w = codec_backend(torch, dev, CLAY_PROFILE, N_CODEC, SEED + 9)
    sl, c = be.sinfo.chunk_size, be.coder
    s = sl // c.sub_chunk_count
    planes = c._repair_planes(0)
    names = sorted(objs)
    outside = next(z for z in range(c.sub_chunk_count) if z not in planes)
    flip(be, 1, names[7], planes[3] * s + 11)       # inside a shipped plane
    flip(be, 2, names[40], outside * s + 13)        # outside them
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    prof = profile(activities=acts)
    one = codec_recover(be, [0], "clay_planes", profile=prof)
    busy = device_busy_s(prof)
    one["device_busy_s"] = busy
    one["idle_share"] = idle_share(busy, one["s"])
    # the kernel's own share of the device time, and the largest entries
    gf = [e for e in device_events(prof) if "gf_apply_kernel" in e.key]
    one["gf_apply_device_s"] = sum(e.self_device_time_total
                                   for e in gf) / 1e6
    one["gf_apply_traced_launches"] = sum(e.count for e in gf)
    one["top_device"] = [
        [e.key[:60], e.self_device_time_total / 1e3, e.count]
        for e in sorted(device_events(prof),
                        key=lambda e: -e.self_device_time_total)[:6]]
    # where the tracer lost every record, phase 8's launch count
    # (below) is what shows the kernel ran
    if one["gf_apply_traced_launches"] == 0 and busy is not None:
        fail("the traced Clay repair shows no gf_apply_kernel launch")
    wire = one["stats"]["helper_bytes_on_wire"]
    if one["stats"]["range_batches"] < 1 \
            or wire * 32 != 11 * N_CODEC * c.k * sl \
            or one["counters"]["hinfo_failures"] != 2:
        fail(f"Clay repair: {one['stats']}, {one['counters']}: want range "
             f"batches, 11/32 of k chunks on the wire and both flipped "
             f"helpers flagged")
    log(f"  Clay repair: helper bytes / (objects x k x chunk) = "
        f"{wire / (N_CODEC * c.k * sl)} (11/32 = {11 / 32}); both flipped "
        f"bytes flagged at the source; device busy {show(busy)} s, idle "
        f"share {show(one['idle_share'])} (torch.profiler); gf_apply_kernel "
        f"{one['gf_apply_device_s']:.4f} s of device time in "
        f"{one['gf_apply_traced_launches']} launches")
    rep = be.repair_pg()
    if rep["repaired"] != 2:
        fail(f"repair_pg {rep}: want the two flipped shards repaired")
    full = codec_recover(be, [0, 9], "clay_full")
    if full["stats"]["generic_batches"] < 1:
        fail(f"Clay two-loss recovery: {full['stats']}: want decode_chunks")
    rd = codec_read(be, objs, {be.acting[0], be.acting[9]},
                    "Clay degraded read (0, 9 down)")
    codec_scrub(be, "Clay")
    out["clay"] = {**w, "planes": one, "full": full, "degraded_read_s": rd,
                   "repair_pg": rep,
                   "helper_fraction": wire / (N_CODEC * c.k * sl)}
    del be, objs

    # SHEC: a cost-ranked shingle repair and a decode
    be, objs, w = codec_backend(torch, dev, SHEC_PROFILE, N_SHEC, SEED + 10)
    one = codec_recover(be, [1], "shec_cost")
    rd = codec_read(be, objs, {be.acting[0], be.acting[2]},
                    "SHEC degraded read (0, 2 down)")
    codec_scrub(be, "SHEC")
    out["shec"] = {**w, "recover": one, "degraded_read_s": rd}
    return out


# ------------------------------------------------------------- phase 9

def bluestore_path(torch, dev) -> dict:
    """BlueStore block checksums and streaming on the card: Checksummer
    over 1 GiB in 4 KiB blocks for the five algorithms, verify with two
    flipped bytes, StreamingCodec over a pinned host stripe larger than
    a tile at depths 2 and 3, make_tiled_encoder; each held against its
    plain version or the one-shot encode. The counts of the path's
    launches are read before the comparisons, which do not count."""
    import numpy as np

    from ceph_tpu_torch.csum import CSUM_ALGORITHMS, Checksummer
    from ceph_tpu_torch.csum import kernels as C
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.ops.streaming import (StreamingCodec,
                                              make_tiled_encoder)
    from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    out = {}
    data = torch.randint(0, 256, (CSUM_OBJECTS * OBJECT_SIZE,),
                         dtype=torch.uint8, device=dev, generator=gen)
    nblocks = data.numel() // CSUM_BLOCK
    sums = {}
    for algo in CSUM_ALGORITHMS:
        cs = Checksummer(algo, CSUM_BLOCK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums[algo] = cs.calculate(data, **entry_device(dev))
        secs = time.perf_counter() - t0
        if sums[algo].shape != (nblocks,):
            fail(f"Checksummer {algo}: {sums[algo].shape} checksums")
        out[f"{algo}_s"] = secs
        log(f"  Checksummer({algo!r}, {CSUM_BLOCK}).calculate over "
            f"{data.numel() >> 30} GiB ({nblocks} blocks): {secs:.4f} s "
            f"({data.numel() / secs / 1e9:.2f} GB/s, host clock, "
            f"checksums to the host included)")
    # verify: two flipped bytes; the first one's block offset comes back
    first = nblocks // 4 * CSUM_BLOCK + 17
    second = nblocks * 3 // 4 * CSUM_BLOCK + 3
    data[first] ^= 0x5A
    data[second] ^= 0x01
    cs = Checksummer("crc32c", CSUM_BLOCK)
    bad = cs.verify(data, sums["crc32c"], **entry_device(dev))
    data[first] ^= 0x5A
    data[second] ^= 0x01
    if bad != first // CSUM_BLOCK * CSUM_BLOCK:
        fail(f"verify reported offset {bad}, want "
             f"{first // CSUM_BLOCK * CSUM_BLOCK}")
    if cs.verify(data, sums["crc32c"], **entry_device(dev)) != -1:
        fail("verify of the restored data is not clean")
    log(f"  verify with bytes {first} and {second} flipped: first bad "
        f"offset {bad}; clean once restored")

    # StreamingCodec: host stripe in pinned memory, parity to the host
    rs = factory(PROFILE, **entry_device(dev)).matrix
    B, k, L = STREAM_SHAPE
    stripe = torch.randint(0, 256, STREAM_SHAPE, dtype=torch.uint8,
                           device=dev, generator=gen)
    host = torch.empty(STREAM_SHAPE, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    host.copy_(stripe)
    perf = (PerfCountersBuilder("chip_smoke_stream")
            .add_u64_counter("stream_launches")
            .add_u64_counter("stream_bytes")
            .add_time_avg("stream_drain_time").create_perf_counters())
    parities = {}
    for depth in (2, 3):
        sc = StreamingCodec(rs, tile=STREAM_TILE, depth=depth, perf=perf,
                            **entry_device(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parities[depth] = sc.encode(host.numpy())
        secs = time.perf_counter() - t0
        out[f"stream_depth{depth}_s"] = secs
        out[f"stream_depth{depth}_gbps"] = host.numel() / secs / 1e9
        log(f"  StreamingCodec depth {depth}, tile {STREAM_TILE >> 20} MiB "
            f"over a host stripe {STREAM_SHAPE}: {secs:.4f} s, "
            f"{host.numel() / secs / 1e9:.3f} GB/s host to host")
    out["stream_counters"] = {key: perf.get(key) for key in (
        "stream_launches", "stream_bytes", "stream_drain_time")}

    # make_tiled_encoder on the card against the one-shot encode
    x = torch.randint(0, 256, TILED_SHAPE, dtype=torch.uint8, device=dev,
                      generator=gen)
    tiled = make_tiled_encoder(rs, tile=TILED_TILE)(x)
    counts = {"csum": csum_counts(), "gf": gf_counts(G)}
    out["launches"] = dict(counts["csum"])
    CRC_BY_SHAPE["phase 9"] = dict(crc_shapes())
    out["gf_apply_launches"] = counts["gf"][0]
    log(f"  phase 9's launches: {dict(counts['csum'])}, gf_apply "
        f"{counts['gf'][0]}")
    for name in ("crc32c", "xxh32", "xxh64"):
        if counts["csum"][name] == 0:
            fail(f"phase 9 never launched the {name} kernel")
    if counts["gf"][0] == 0:
        fail("phase 9 never launched gf_apply")

    # the comparisons, uncounted: the plain versions on the card, the
    # oracle on a sample, one apply of the whole stripe
    blocks = data.view(nblocks, CSUM_BLOCK)
    crc = C.crc32c_blocks_plain(blocks, 0xFFFFFFFF, 0)
    plain = {"crc32c": crc, "crc32c_16": crc & 0xFFFF,
             "crc32c_8": crc & 0xFF,
             "xxhash32": C.xxh32_blocks_plain(blocks)}
    pairs = C.xxh64_blocks_plain(blocks).cpu().numpy().astype(np.uint64)
    del crc
    pick = np.sort(np.random.default_rng(SEED + 9).choice(
        nblocks, min(256, nblocks), replace=False))
    sample = blocks[torch.from_numpy(pick).to(dev)].cpu().numpy()
    for algo in CSUM_ALGORITHMS:
        want = (pairs[:, 0] << np.uint64(32)) | pairs[:, 1] \
            if algo == "xxhash64" else \
            plain[algo].cpu().numpy().astype(np.uint32)
        if sums[algo].dtype != want.dtype or \
                not np.array_equal(sums[algo], want):
            fail(f"Checksummer {algo} on the card differs from the "
                 f"kernels' plain versions")
        oracle = Checksummer(algo, CSUM_BLOCK).calculate(sample,
                                                         device=False)
        if not np.array_equal(sums[algo][pick], oracle):
            fail(f"Checksummer {algo}: sampled blocks differ from the "
                 f"oracle")
    log(f"  Checksummer: all {len(CSUM_ALGORITHMS)} algorithms equal the "
        f"plain versions on all {nblocks} blocks and the oracle on "
        f"{len(pick)}")
    del plain, pairs, blocks
    ref0 = gf_counts(G)
    want = G.apply_matrix_gf(rs, stripe).cpu().numpy()
    if not torch.equal(tiled, G.apply_matrix_gf(rs, x)):
        fail("make_tiled_encoder differs from the one-shot encode")
    gf_set(G, ref0)
    for depth, parity in parities.items():
        if not np.array_equal(parity, want):
            fail(f"StreamingCodec depth {depth} differs from one apply of "
                 f"the whole stripe")
    log(f"  StreamingCodec (depths 2, 3) equals one apply of the whole "
        f"stripe; make_tiled_encoder {TILED_SHAPE}, tile {TILED_TILE} "
        f"equals the one-shot encode")
    # the PCIe bound: a pinned host-to-device copy of the same bytes
    dst = torch.empty_like(stripe)
    h2d = cuda_ms(lambda: dst.copy_(host, non_blocking=True), 1, 3)
    out["h2d_pinned_ms"] = h2d
    out["h2d_pinned_gbps"] = host.numel() / h2d / 1e6
    log(f"  pinned host-to-device copy of the stripe: {h2d:.3f} ms, "
        f"{out['h2d_pinned_gbps']:.2f} GB/s")
    del data, stripe, host, dst, x, tiled
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 10

def score_bound(N: int, S2: int, U: int, topk: int, n_osds: int,
                visited: int) -> tuple[float, str]:
    """Least time (ms) the card could take for one scorer launch: the
    larger of the bytes (members, sources, the target list, dev and dom
    read once; the (index, score) pairs written once) through HBM and
    the compares these inputs need at the int32 rate: 2S + 1 for each of
    the `visited` targets (`score_visits_plain` summed over the rows:
    what each row tests before its top k are settled, plus the -inf
    fill's checks). 2S + 1, not 2*2S: a member equal to the target is
    either the source or in the target's domain, so one compare with
    the source and one a member's domain decide legality."""
    t_bytes = (N * S2 * 4 + N * 4 + U * 4 + n_osds * 8
               + N * topk * 8) / HBM_BYTES_PER_S
    t_ops = visited * (S2 + 1) / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def scorer_library(torch, path: Path):
    """A built placement.cu library (this checkout's or an older one:
    the C entry score_candidates keeps its signature) as a function of
    the scorer's arguments that launches it on the current stream."""
    import ctypes
    lib = ctypes.CDLL(str(path))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.score_candidates.argtypes = [P_] * 5 + [I_] * 5 + [P_] * 3
    lib.score_candidates.restype = I_

    def call(members, src, dsts, dev, dom, topk):
        N, S2 = members.shape
        best = torch.empty((N, topk), dtype=torch.int32, device=members.device)
        score = torch.empty((N, topk), dtype=torch.float32,
                            device=members.device)
        rc = lib.score_candidates(
            members.data_ptr(), src.data_ptr(), dsts.data_ptr(),
            dev.data_ptr(), dom.data_ptr(), N, S2, dsts.shape[0],
            dev.shape[0], topk, best.data_ptr(), score.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"{path.name}: score_candidates returned cudaError {rc}")
        return best, score
    return call


def score_row(torch, args, parent=None) -> dict:
    """One scorer row at `args` (the scorer's six arguments on the card):
    the kernel's device ms a launch (a trace) and ms a call, beside the
    plain version's ms and, with `parent` (`scorer_library` of an older
    placement.cu), that kernel's device ms on the same inputs, its
    result held equal; the mean targets a row visits
    (score_visits_plain, checked against the kernel's own count) and the
    bound they give, with each kernel's share of it."""
    from ceph_tpu_torch.mgr import placement as P
    members, src, dsts, dev_, dom, topk = args
    N, S2 = members.shape
    U = dsts.shape[0]
    pv = P.score_visits_plain(*args)
    kv = torch.empty_like(pv)
    P.score_candidates(*args, visits=kv)
    if not torch.equal(kv, pv):
        fail(f"scorer at {[N, S2, U, topk]}: the kernel visited "
             f"{int(kv.sum())} targets, score_visits_plain {int(pv.sum())}")
    visited = int(pv.sum())
    bound, by = score_bound(N, S2, U, topk, dev_.shape[0], visited)
    dev_ms, src_ms = kernel_device_ms(lambda: P.score_candidates(*args),
                                      "score_kernel")
    row = {"shape": [N, S2, U, topk], "device_ms": dev_ms,
           "device_ms_from": src_ms,
           "ms": cuda_ms(lambda: P.score_candidates(*args)),
           "plain_ms": cuda_ms(lambda: P.score_candidates_plain(*args),
                               warm=1, reps=3),
           "mean_visits": visited / N, "bound_ms": bound, "bound_by": by,
           "share": bound / dev_ms}
    if parent is not None:
        got, want = parent(*args), P.score_candidates(*args)
        if not (torch.equal(got[0], want[0])
                and same_scores(torch, got[1], want[1])):
            fail(f"scorer at {[N, S2, U, topk]}: the parent kernel's result "
                 f"differs from this one's")
        ms, src_p = kernel_device_ms(lambda: parent(*args), "score_kernel")
        row.update(parent_device_ms=ms, parent_device_ms_from=src_p,
                   parent_share=bound / ms)
    log(f"  score_candidates {row['shape']} (N, 2S, U, topk): device "
        f"{dev_ms:.5f} ms ({src_ms}), {row['ms']:.5f} ms a call"
        + (f", parent device {row['parent_device_ms']:.5f} ms"
           if parent is not None else "")
        + f", plain {row['plain_ms']:.3f} ms; {row['mean_visits']:.2f} "
        f"targets a row, bound {bound:.5f} ms "
        f"({by}), share {row['share']:.3f}"
        + (f" (parent {row['parent_share']:.3f})"
           if parent is not None else ""))
    return row


def heavy_half_map(c: dict):
    """tools/scale_sim.py's build_cluster(heavy_half=True) on the port's
    crush.map: the first half of the devices at twice the CRUSH weight,
    the replicated host rule 0."""
    from ceph_tpu_torch.crush.map import build_hierarchy, replicated_rule
    m = build_hierarchy(c["osds"], c["osds_per_host"], c["hosts_per_rack"])
    half = c["osds"] // 2
    for b in m.buckets.values():
        if b.type_id == 1:
            for i, it in enumerate(b.items):
                if it < half:
                    b.weights[i] = 2 * 0x10000
    for lvl in (2, 3):
        for b in m.buckets.values():
            if b.type_id == lvl:
                b.weights = [m.buckets[ch].weight for ch in b.items]
    m._packed = None
    replicated_rule(m, 0, choose_type=1, firstn=True)
    return m


BALANCER_KEYS = ("moves", "rounds", "candidates_scored", "max_dev_before",
                 "max_dev_after", "spread_before", "spread_after",
                 "budget_used", "converged")


def balancer_path(torch, dev, parent=None) -> dict:
    """The mgr's upmap balancer at 10k OSDs / 1M PGs on the card
    (BALANCER_10K.json's configuration): the pool's raw mapping, then
    batch_calc_pg_upmaps traced, np.argsort pinned to kind="stable" as
    the reference was made (tools/balancer_10k.py's `stable_argsort`:
    the greedy sorts integer-valued deviations, and numpy's default
    argsort orders ties by the CPU it runs on); fails unless its result
    and digests are the JAX package's, the budget holds, 2,000 sampled PGs' up sets
    after the upmaps land are pg_to_up_acting_osds', and the first and
    the last scorer launch equal the plain version on the card. The
    last launch is timed (`score_row`), beside `parent`'s kernel where
    one is given."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.mgr import placement as P
    from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool
    # the reference's digests and argsort pin, from the tool that wrote
    # it (numpy only at import; it loads the JAX package in main alone)
    from tools.balancer_10k import balance_digests, stable_argsort

    ref = json.loads((Path(__file__).resolve().parent / BALANCER_REF)
                     .read_text())
    c = ref["config"]
    om = OSDMap(heavy_half_map(c), **entry_device(dev))
    om.add_pool(PGPool(1, pg_num=c["pg_num"], size=c["size"],
                       min_size=max(1, c["size"] - 1), crush_rule=0))
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = P.chunked_pgs_to_raw(om, 1, c["chunk"])
    torch.cuda.synchronize()
    out["map_s"] = time.perf_counter() - t0
    log(f"  raw mapping of {c['pg_num']} PGs x {c['size']} over "
        f"{c['osds']} OSDs ({c['pg_num'] // c['chunk']} launches of "
        f"{c['chunk']} lanes): {out['map_s']:.3f} s")

    calls = {}
    kernel = P.score_candidates

    def recording(*args):
        # keeps the first and the last launch's inputs and outputs
        got = kernel(*args)
        keep = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args), tuple(t.clone() for t in got))
        calls.setdefault("first", keep)
        calls["last"] = keep
        return got
    P.score_candidates = recording
    P.launches = 0
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        with stable_argsort(), profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = P.batch_calc_pg_upmaps(
                om, 1, max_deviation=c["max_deviation"],
                max_movement=c["max_movement"], max_src=c["max_src"],
                max_dst=c["max_dst"], chunk=c["chunk"], raw=raw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        P.score_candidates = kernel
    out["launches"] = P.launches
    busy = device_busy_s(prof)
    score_evs = [e for e in device_events(prof)
                 if "score_kernel" in e.key]
    traced = sum(e.count for e in score_evs)
    got = dict(res.to_dict(), upmap_pgs=len(res.proposed),
               **balance_digests(res.moves, res.proposed))
    want = dict(ref["result"], upmap_pgs=ref["upmap_pgs"],
                moves_sha256=ref["moves_sha256"],
                proposed_sha256=ref["proposed_sha256"])
    diff = {k: (got[k], want[k]) for k in BALANCER_KEYS + (
        "upmap_pgs", "moves_sha256", "proposed_sha256") if got[k] != want[k]}
    if diff:
        fail(f"batch_calc_pg_upmaps differs from BALANCER_10K.json: {diff}")
    if res.budget_used > c["max_movement"]:
        fail(f"budget {c['max_movement']} exceeded: {res.budget_used}")
    if P.launches != res.rounds or not P.launches:
        fail(f"{P.launches} scorer launches for {res.rounds} rounds")
    log(f"  batch_calc_pg_upmaps: {len(res.moves)} moves in {res.rounds} "
        f"rounds, max deviation {res.max_dev_before:.3f} -> "
        f"{res.max_dev_after:.3f}, spread {res.spread_before} -> "
        f"{res.spread_after}, {res.candidates_scored} candidates scored: "
        f"= BALANCER_10K.json, digests included; {P.launches} "
        f"scorer launches")
    for label, (args, (best, score)) in calls.items():
        pb, ps = P.score_candidates_plain(*args)
        if not torch.equal(best, pb) or not same_scores(torch, score, ps):
            fail(f"the {label} scorer launch differs from the plain "
                 f"version on the card")
    log("  the first and the last scorer launch equal the plain version "
        "bit for bit")

    # the landed upmaps against the scalar path
    rng = np.random.default_rng(SEED + 10)
    pss = np.sort(rng.choice(c["pg_num"], CRUSH_SAMPLE, replace=False))
    eff = P.apply_upmaps_to_raw(raw, 1, om.pg_upmap_items)
    up = om.pgs_to_up(1, pss)
    want_up = np.concatenate([
        np.asarray(r, dtype=np.int32).reshape(-1, c["size"])
        for r in on_host_workers(_scalar_up, [
            (om.encode(), 1, sl) for sl in slices(pss)])])
    if not (np.array_equal(up, want_up) and np.array_equal(eff[pss],
                                                           want_up)):
        fail("after the upmaps land, sampled up sets differ from "
             "pg_to_up_acting_osds")
    log(f"  {CRUSH_SAMPLE} sampled PGs' up sets after the upmaps land "
        f"equal pg_to_up_acting_osds")

    # the last launch's shape, timed, its visits counted
    row = score_row(torch, calls["last"][0], parent)
    out.update({
        "result": got, "wall_s": wall, "device_busy_s": busy,
        "idle_share": idle_share(busy, wall),
        "score_s": res.score_elapsed_s,
        "host_greedy_s": res.elapsed_s - res.score_elapsed_s,
        "traced_score_launches": traced,
        "traced_score_ms_per_launch": (
            sum(e.self_device_time_total for e in score_evs) / traced / 1e3
            if traced else None),
        "kernel": row})
    log(f"  balancer run {wall:.3f} s: scoring (candidates, copies, "
        f"launch) {res.score_elapsed_s:.3f} s, host greedy "
        f"{out['host_greedy_s']:.3f} s; device busy {show(busy)} s, idle "
        f"share {show(out['idle_share'])}; the trace shows {traced} of "
        f"{out['launches']} scorer launches, "
        f"{show(out['traced_score_ms_per_launch'])} ms each")
    del calls, raw, eff
    torch.cuda.empty_cache()
    return out


# the scorer's rows of `--score-times`: (label, N, 2S, U, topk, kind)
SCORE_ROWS = (("balancer order", 262144, 6, 512, 8, "balancer"),
              ("balancer rows, targets shuffled", 262144, 6, 512, 8,
               "shuffled"),
              ("unsorted", 262144, 6, 512, 8, "ties"),
              ("worst case: the first 128 targets clash", 262144, 6, 512, 8,
               "long"))


def score_times(torch, dev, parent_src: Path | None) -> dict:
    """`--score-times`: the scorer's rows (SCORE_ROWS, then phase 10's
    last launch, which needs phase 10's balancer run) and the SASS of
    the walk's loops, beside the kernel of `parent_src` (an older
    placement.cu) where it is given, built side by side."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ceph_tpu_torch.mgr import placement as P
    from ceph_tpu_torch.utils import nvcc
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(P.build)] + ([pool.submit(nvcc.build, parent_src)]
                                         if parent_src else [])
        libs = [j.result() for j in jobs]
    log(f"  built {', '.join(lib.name for lib in libs)}")
    parent = scorer_library(torch, libs[1]) if parent_src else None
    rng = np.random.default_rng(SEED + 23)
    out = {"rows": {}}
    for label, N, S2, U, topk, kind in SCORE_ROWS:
        log(f"  {label}:")
        args = score_inputs(torch, dev, rng, N, S2, U, 10_000, kind) + (topk,)
        out["rows"][label] = score_row(torch, args, parent)
    log("  phase 10's last launch (the balancer run first):")
    out["rows"]["phase 10, last launch"] = \
        balancer_path(torch, dev, parent)["kernel"]
    for name, lib in zip(("change", "parent"), libs):
        for k, loops in sass_loops(lib).items():
            if "ILi6E" not in k or "score_kernel" not in k:
                continue
            label = (f"{name} "
                     + ("walk" if "_walk" in k else
                        "scan" if "_scan" in k else "score_kernel") + "<6>")
            out[f"sass {label}"] = loops
            log(f"  SASS {label}: loops as (instructions, LDS, LDG): "
                f"{[(lp['instructions'], lp['lds'], lp['ldg']) for lp in loops]}"
                f"; a loop with one LDS reads one staged target record an "
                f"iteration")
    return out


# ------------------------------------------------------------ phase 11

def store_path(torch, dev, native_lib: Path) -> dict:
    """Phase 7's scenario over persistent TinStores in a temporary
    directory (removed afterwards), then 32 compressible objects
    through zlib-compressed TinStores; fails unless the native host
    library built in phase 1 serves TinDB's and TinStore's CRC32C on
    SSE4.2, every read is bit-exact, and the compressed stores shrink."""
    import shutil
    import tempfile

    import numpy as np

    from ceph_tpu_torch import native
    from ceph_tpu_torch.kv import tindb
    from ceph_tpu_torch.osd.cluster import SimCluster

    if not native.crc32c_hw() or native.lib()._name != str(native_lib):
        fail(f"the native library {native.lib()._name} is not phase 1's "
             f"build {native_lib} on SSE4.2: TinDB would checksum in "
             f"Python")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tin-")
    try:
        out = cluster_path(torch, dev, store="tin",
                           store_dir=os.path.join(tmp, "osds"))
        shutil.rmtree(os.path.join(tmp, "osds"))
        c = SimCluster(n_osds=CLUSTER_OSDS, osds_per_host=CLUSTER_PER_HOST,
                       pg_num=CLUSTER_PGS, profile=PROFILE,
                       chunk_size=OBJECT_SIZE // K, store="tin",
                       store_dir=os.path.join(tmp, "zlib"),
                       store_compression="zlib", **entry_device(dev))
        # a seeded 64 KiB block repeated; the block is itself a seeded
        # 4 KiB row repeated, inside zlib's 32 KiB window
        rng = np.random.default_rng(SEED + 11)
        objs = {f"z{i:02d}": np.tile(rng.integers(0, 256, 4096, np.uint8),
                                     OBJECT_SIZE // 4096)
                for i in range(CLUSTER_MORE)}
        t0 = time.perf_counter()
        c.write(objs)
        t_write = time.perf_counter() - t0
        stats = [st.compress_stats for st in c.cluster.stores.values()]
        logical = sum(s["logical_bytes"] for s in stats)
        stored = sum(s["stored_bytes"] for s in stats)
        if not stored < logical or not any(s["compressed_blobs"]
                                           for s in stats):
            fail(f"zlib TinStores: {stored} bytes stored of {logical}")
        victim = c.pgs[0].acting[0]
        c.kill_osd(victim)
        c.revive_osd(victim)                 # remount from its WAL
        c.tick(c.hb_interval)
        if c.verify_all(objs) != len(objs):
            fail("zlib TinStores: reads differ after the remount")
        out["zlib"] = {"objects": len(objs), "write_s": t_write,
                       "logical_bytes": logical, "stored_bytes": stored}
        log(f"  zlib TinStores: {len(objs)} compressible objects written in "
            f"{t_write:.3f} s, {stored} bytes stored for {logical} "
            f"({stored / logical:.4f}); bit-exact after osd.{victim}'s "
            f"remount")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if tindb._crc_impl is None or tindb._crc_impl.__defaults__ is None:
        fail("TinDB's CRC32C ran in Python, not in the native library")
    return out


# ------------------------------------------------------------ phase 12

def decode_launches(shapes) -> int:
    """gf_apply launches that decode or rebuild at the main geometry: k
    survivor rows in, fewer rows out than the encode's m."""
    return sum(n for (k, m, _L, _vec), n in shapes.items()
               if k == K and m < M)


def client_path(torch, dev) -> dict:
    """The client tier over the card's EC pool (phase 7's cluster): rados
    bench's 256 x 4 MiB through aio_write_full and aio_read, 16 in flight
    (the write traced); a 1 GiB RBD image at Ceph's default layout
    written whole, then fio-style 4 KiB random writes with a snapshot
    half way and, three quarters of the way, the primary OSD of a PG
    holding image objects killed: reads in the gap served degraded, the
    map marks it down, later ops retarget; the head and the snapshot
    read back; a CephFS file in 4 MiB writes and a directory that must
    split; RGW objects, a multipart upload and a signed request; then a
    tick past down_out_interval (out, remap, recovery), every byte read
    again and a deep scrub of every PG. Every read is held byte for
    byte against a host model; any failed op fails the phase."""
    import collections

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.client.rbd import RBD
    from ceph_tpu_torch.fs.client import FsClient
    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.osd.cluster import SimCluster
    from ceph_tpu_torch.rgw.auth import (AuthedGateway, S3Client,
                                         SignatureDoesNotMatch, UserStore,
                                         amz_date, sign)
    from ceph_tpu_torch.rgw.gateway import Gateway

    t_phase = time.perf_counter()
    c = SimCluster(n_osds=CLUSTER_OSDS, osds_per_host=CLUSTER_PER_HOST,
                   pg_num=CLUSTER_PGS, profile=PROFILE,
                   chunk_size=OBJECT_SIZE // K, **entry_device(dev))
    devices = {pg.device for pg in c.pgs.values()}
    if c.device.type != dev.type or devices != {c.device} \
            or c.osdmap.device != c.device \
            or c.pgs[0].coder.impl != "pallas" or c.pool_size != K + M:
        fail(f"phase 12: cluster on {c.device}, backends on {devices}, "
             f"mapper on {c.osdmap.device}, impl {c.pgs[0].coder.impl}")
    rados = Rados(c, aio_threads=RADOS_INFLIGHT)
    io = rados.open_ioctx()
    perf = rados._objecter.perf
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    out: dict = {}

    def made_on_card(rows: int, n: int) -> np.ndarray:
        return torch.randint(0, 256, (rows, n), dtype=torch.uint8,
                             device=dev, generator=gen).cpu().numpy()

    def same(label: str, got: bytes, want: np.ndarray) -> None:
        if len(got) != want.size or not np.array_equal(
                np.frombuffer(got, np.uint8), want.reshape(-1)):
            fail(f"phase 12: {label}: the bytes read differ from those "
                 f"written")

    def windowed(submit, items) -> list:
        """submit(item) -> Completion, RADOS_INFLIGHT in flight; the
        results in order (a failed op fails the phase)."""
        window: collections.deque = collections.deque()
        results = []
        try:
            for item in items:
                if len(window) == RADOS_INFLIGHT:
                    results.append(window.popleft().get_return_value())
                window.append(submit(item))
            while window:
                results.append(window.popleft().get_return_value())
        except Exception as e:  # noqa: BLE001 — any failed op fails
            fail(f"phase 12: an aio op failed: {e!r}")
        return results

    # -- librados: rados bench -b 4194304 -t 16, write then read --------
    names = [f"benchmark_data_{i:04d}" for i in range(RADOS_OBJECTS)]
    rows = made_on_card(RADOS_OBJECTS, OBJECT_SIZE)
    gbytes = RADOS_OBJECTS * OBJECT_SIZE / 1e9
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        wrote = windowed(lambda i: io.aio_write_full(names[i], rows[i]),
                         range(RADOS_OBJECTS))
        torch.cuda.synchronize()
        t_write = time.perf_counter() - t0
    if wrote != [OBJECT_SIZE] * RADOS_OBJECTS:
        fail(f"phase 12: aio_write_full returned {set(wrote)}")
    busy = device_busy_s(prof)
    t0 = time.perf_counter()
    got = windowed(io.aio_read, names)
    t_read = time.perf_counter() - t0
    for i, g in enumerate(got):
        same(f"aio_read {names[i]}", g, rows[i])
    out["rados"] = {"objects": RADOS_OBJECTS, "in_flight": RADOS_INFLIGHT,
                    "write_s": t_write, "write_gbps": gbytes / t_write,
                    "read_s": t_read, "read_gbps": gbytes / t_read,
                    "write_device_busy_s": busy,
                    "write_idle_share": idle_share(busy, t_write)}
    log(f"  librados: {RADOS_OBJECTS} x {OBJECT_SIZE >> 20} MiB, "
        f"{RADOS_INFLIGHT} in flight: write {gbytes / t_write:.4f} GB/s "
        f"(traced), read {gbytes / t_read:.4f} GB/s (host clock); the "
        f"write's device busy {show(busy)} s, idle share "
        f"{show(idle_share(busy, t_write))} (torch.profiler)")

    # -- RBD: a 1 GiB image, order 22, written whole, then 4 KiB random
    #    writes with a snapshot and a primary's death among them --------
    rbd = RBD(io, stripe_unit=RBD_OBJECT, stripe_count=1,
              object_size=RBD_OBJECT)
    img = rbd.create("bench", RBD_IMAGE)
    model = made_on_card(RBD_IMAGE // RBD_OBJECT, RBD_OBJECT).reshape(-1)
    t0 = time.perf_counter()
    for off in range(0, RBD_IMAGE, RBD_OBJECT):
        img.write(off, model[off:off + RBD_OBJECT].tobytes())
    t_full = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 12)
    offs = rng.integers(0, RBD_IMAGE // RBD_BLOCK, RBD_RANDOM) * RBD_BLOCK
    blocks = rng.integers(0, 256, (RBD_RANDOM, RBD_BLOCK), dtype=np.uint8)
    snap_at, kill_at = RBD_RANDOM // 2, RBD_RANDOM * 3 // 4
    t_rand = 0.0
    for i, off in enumerate(int(o) for o in offs):
        if i == snap_at:
            img.snap_create("s1")
            snap_model = model.copy()
        if i == kill_at:
            q = off // RBD_OBJECT
            ps = c.locate(f"rbd_data.bench.{q:016x}")
            victim = c.osdmap.pg_to_up_acting_osds(1, ps)[3]
            c.kill_osd(victim)
            deg0 = perf.get("op_degraded")
            same("RBD read, primary dead", img.read(q * RBD_OBJECT,
                                                    RBD_OBJECT),
                 model[q * RBD_OBJECT:(q + 1) * RBD_OBJECT])
            in_pg = [n for n in names if c.locate(n) == ps]
            for n, g in io.read_many(in_pg).items():
                same(f"read_many {n}, primary dead", g,
                     rows[names.index(n)])
            decodes = decode_launches(gf_counts(G)[1])
            if perf.get("op_degraded") == deg0 or decodes == 0:
                fail(f"phase 12: reads with osd.{victim} dead: "
                     f"op_degraded {perf.get('op_degraded') - deg0}, "
                     f"decode launches {decodes}")
            c.tick(30)
            if c.osdmap.osd_up[victim]:
                fail(f"phase 12: osd.{victim} killed but still up")
            out["victim"] = {"osd": victim, "pg": ps,
                             "objects_in_pg": len(in_pg),
                             "decode_launches_in_gap": decodes}
            log(f"  osd.{victim}, primary of PG {ps}, killed after "
                f"{kill_at} random writes: image object {q} and "
                f"{len(in_pg)} rados objects read degraded "
                f"({decodes} decode launches), then marked down")
        t0 = time.perf_counter()
        img.write(off, blocks[i].tobytes())
        t_rand += time.perf_counter() - t0
        model[off:off + RBD_BLOCK] = blocks[i]

    def image_check(label: str, want: np.ndarray) -> float:
        t0 = time.perf_counter()
        for off in range(0, RBD_IMAGE, 16 * RBD_OBJECT):
            n = min(16 * RBD_OBJECT, RBD_IMAGE - off)
            same(f"{label} at {off}", img.read(off, n), want[off:off + n])
        return time.perf_counter() - t0
    t_head = image_check("RBD head", model)
    img.set_snap("s1")
    t_snap = image_check("RBD snapshot s1", snap_model)
    img.set_snap(None)
    out["rbd"] = {"image_bytes": RBD_IMAGE, "full_write_s": t_full,
                  "full_write_gbps": RBD_IMAGE / t_full / 1e9,
                  "random_writes": RBD_RANDOM, "random_s": t_rand,
                  "random_iops": RBD_RANDOM / t_rand,
                  "head_read_s": t_head, "snap_read_s": t_snap,
                  "clones": sum(len(v) for v in c.snapsets.values())}
    log(f"  RBD: {RBD_IMAGE >> 20} MiB image written in {t_full:.3f} s "
        f"({RBD_IMAGE / t_full / 1e9:.4f} GB/s), {RBD_RANDOM} x 4 KiB "
        f"random writes at {RBD_RANDOM / t_rand:.1f} ops/s (host clock), "
        f"{out['rbd']['clones']} clones after the snapshot; head read "
        f"{t_head:.3f} s, snapshot read {t_snap:.3f} s, both exact")

    # -- CephFS: one 256 MiB file in 4 MiB writes; a directory split ----
    fs = FsClient(io, frag_split_threshold=FS_SPLIT)
    fs.mkdir("/bench")
    fs.create("/bench/file")
    fdata = made_on_card(FS_FILE // FS_WRITE, FS_WRITE)
    t0 = time.perf_counter()
    for i in range(FS_FILE // FS_WRITE):
        fs.write("/bench/file", fdata[i].tobytes(), offset=i * FS_WRITE)
    t_fs_w = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(FS_FILE // FS_WRITE):
        same(f"CephFS read {i}", fs.read("/bench/file", length=FS_WRITE,
                                         offset=i * FS_WRITE), fdata[i])
    t_fs_r = time.perf_counter() - t0
    fs.mkdir("/bench/dir")
    for i in range(2 * FS_SPLIT):
        fs.create(f"/bench/dir/f{i:04d}")
    frags = fs.frag_info("/bench/dir")
    if frags["bits"] < 1 or frags["dentries"] != 2 * FS_SPLIT:
        fail(f"phase 12: a directory of {2 * FS_SPLIT} files: {frags}")
    out["cephfs"] = {"file_bytes": FS_FILE, "write_s": t_fs_w,
                     "write_gbps": FS_FILE / t_fs_w / 1e9,
                     "read_s": t_fs_r, "read_gbps": FS_FILE / t_fs_r / 1e9,
                     "dir_files": 2 * FS_SPLIT, "frag_bits": frags["bits"]}
    log(f"  CephFS: {FS_FILE >> 20} MiB file in {FS_WRITE >> 20} MiB "
        f"writes {FS_FILE / t_fs_w / 1e9:.4f} GB/s, read "
        f"{FS_FILE / t_fs_r / 1e9:.4f} GB/s (host clock); "
        f"{2 * FS_SPLIT} files split the directory into {frags['frags']} "
        f"frags")

    # -- RGW: 64 x 1 MiB, a multipart upload of 8 x 8 MiB, a signature --
    gw = Gateway(io)
    gw.create_bucket("bench")
    robjs = made_on_card(RGW_OBJECTS, RGW_OBJECT)
    parts = made_on_card(RGW_PARTS, RGW_PART)
    t0 = time.perf_counter()
    for i in range(RGW_OBJECTS):
        gw.put_object("bench", f"obj{i:03d}", robjs[i].tobytes())
    up = gw.initiate_multipart("bench", "multi")
    for j in range(RGW_PARTS):
        gw.upload_part("bench", "multi", up, j + 1, parts[j].tobytes())
    gw.complete_multipart("bench", "multi", up)
    t_rgw_w = time.perf_counter() - t0

    def rgw_check(label: str) -> float:
        t0 = time.perf_counter()
        for i in range(RGW_OBJECTS):
            same(f"{label} obj{i:03d}", gw.get_object("bench",
                                                      f"obj{i:03d}"),
                 robjs[i])
        same(f"{label} multipart", gw.get_object("bench", "multi"), parts)
        return time.perf_counter() - t0
    t_rgw_r = rgw_check("RGW get")
    rgw_bytes = RGW_OBJECTS * RGW_OBJECT + RGW_PARTS * RGW_PART
    users = UserStore()
    ak, sk = users.create_user("bench")
    agw = AuthedGateway(gw, users)
    agw.adopt_bucket("bench", "bench")
    same("signed get", S3Client(agw, ak, sk).get_object("bench", "obj000"),
         robjs[0])
    date = amz_date(time.time())
    try:
        agw.call(ak, date, sign(sk, date, "get_object", "bench", "obj001",
                                "n1", {}, b""), "get_object", "bench",
                 "obj000", nonce="n1")
        fail("phase 12: a request signed for another key was accepted")
    except SignatureDoesNotMatch:
        pass
    out["rgw"] = {"bytes": rgw_bytes, "write_s": t_rgw_w,
                  "write_gbps": rgw_bytes / t_rgw_w / 1e9,
                  "read_s": t_rgw_r, "read_gbps": rgw_bytes / t_rgw_r / 1e9}
    log(f"  RGW: {RGW_OBJECTS} x {RGW_OBJECT >> 20} MiB and a multipart "
        f"upload of {RGW_PARTS} x {RGW_PART >> 20} MiB: put "
        f"{rgw_bytes / t_rgw_w / 1e9:.4f} GB/s, get "
        f"{rgw_bytes / t_rgw_r / 1e9:.4f} GB/s (host clock); a signed "
        f"request accepted, a tampered one refused")

    # -- out -> remap -> recovery; everything read again; deep scrub ----
    rec0 = c.perf.get("recovered_objects")
    dec0 = decode_launches(gf_counts(G)[1])
    t0 = time.perf_counter()
    c.tick(c.down_out_interval)
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    recovered = c.perf.get("recovered_objects") - rec0
    holders = [ps for ps, pg in c.pgs.items() if victim in pg.acting]
    h = c.health()
    if c.osdmap.osd_weight[victim] != 0 or holders or recovered == 0 \
            or h["pgs_degraded"] \
            or decode_launches(gf_counts(G)[1]) == dec0:
        fail(f"phase 12 after the out: weight "
             f"{int(c.osdmap.osd_weight[victim])}, PGs still on "
             f"osd.{victim}: {holders}, recovered {recovered}, "
             f"{h['pgs_degraded']} degraded PGs")
    t0 = time.perf_counter()
    for i, g in enumerate(windowed(io.aio_read, names)):
        same(f"aio_read {names[i]} after recovery", g, rows[i])
    image_check("RBD head after recovery", model)
    img.set_snap("s1")
    image_check("RBD snapshot after recovery", snap_model)
    img.set_snap(None)
    for i in range(FS_FILE // FS_WRITE):
        same(f"CephFS read {i} after recovery",
             fs.read("/bench/file", length=FS_WRITE, offset=i * FS_WRITE),
             fdata[i])
    rgw_check("RGW get after recovery")
    t_reread = time.perf_counter() - t0
    t0 = time.perf_counter()
    for ps, pg in c.pgs.items():
        rep = pg.deep_scrub(dead_osds=c._dead_osds())
        if rep["inconsistent"]:
            fail(f"phase 12: deep scrub of PG {ps}: {rep['inconsistent']}")
    t_scrub = time.perf_counter() - t0
    rados.shutdown()
    counts = {key: perf.get(key) for key in ("op_send", "op_resend",
                                             "map_refresh", "op_degraded")}
    if counts["op_resend"] == 0 or counts["op_degraded"] == 0:
        fail(f"phase 12: the Objecter's counters {counts}")
    out.update({"recovery_tick_s": t_rec, "recovered_objects": recovered,
                "reread_s": t_reread, "deep_scrub_s": t_scrub,
                "objecter": counts,
                "phase_s": time.perf_counter() - t_phase})
    log(f"  out -> remap -> recover: {recovered} objects in {t_rec:.3f} s; "
        f"every byte read again exact in {t_reread:.3f} s; deep scrub of "
        f"{len(c.pgs)} PGs clean in {t_scrub:.3f} s")
    log(f"  the Objecter: {json.dumps(counts)}")
    log(f"  phase 12 wall time {out['phase_s']:.1f} s; {card_line()}")
    return out


def client_phase(torch, dev) -> tuple:
    """Phase 12 with its launch counts set to 0 before and read after;
    fails unless gf_apply (the 4 KiB overwrites' delta shape and a decode
    among its launches) and the CRC32C kernel launched."""
    from ceph_tpu_torch.ops import gf_kernel as G
    gf_set(G)
    csum_set()
    client = client_path(torch, dev)
    launches, shapes = gf_counts(G)
    log(f"  gf_apply launches in phase 12: {launches}, by (k,m,L,vec): "
        f"{json.dumps(by_shape(shapes))}")
    deltas = sum(n for (k, m, L, _v), n in shapes.items()
                 if k < K and m == M and L == RBD_BLOCK)
    if launches == 0 or deltas == 0 or decode_launches(shapes) == 0:
        fail(f"phase 12: gf_apply launches {launches}, of the 4 KiB delta "
             f"shape {deltas}, decodes {decode_launches(shapes)}")
    crc = crc_launches("phase 12")
    client.update({"gf_apply_launches": launches,
                   "gf_apply_delta_4k_launches": deltas,
                   "gf_apply_decode_launches": decode_launches(shapes),
                   "crc32c_launches": crc})
    return client, launches, shapes, crc


# ------------------------------------------------------------ phase 13

def slot_counts(wanted, n_slots: int, shard: int) -> list:
    """How many of the `wanted` chunk slots each shard column holds."""
    per = n_slots // shard
    return [sum(1 for s in set(wanted) if c * per <= s < (c + 1) * per)
            for c in range(shard)]


def trace_kernel_ms(log_dir: Path, calls: int) -> dict:
    """Device ms a call of gf_apply's kernel and of NCCL's kernels in the
    chrome trace that utils/tracing.stop_trace exported into `log_dir`
    (None where the trace holds no such kernel)."""
    (path,) = Path(log_dir).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    sums = {"gf_apply": 0.0, "nccl": 0.0}
    seen = {"gf_apply": 0, "nccl": 0}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        key = "gf_apply" if "gf_apply_kernel" in name else \
            "nccl" if "nccl" in name.lower() else None
        if key:
            sums[key] += float(e.get("dur", 0.0))
            seen[key] += 1
    return {key: sums[key] / 1e3 / calls if seen[key] else None
            for key in sums}


def mesh_steps(torch, mesh, gen_seed: int) -> dict:
    """Phase 13 on one mesh, on this rank: the sharded RS k=8 m=3 encode
    of MESH_OBJECTS x 4 MiB objects a dp row and its decode of LOST, the
    LRC local repair of config #3 and the Clay repair of config #4's
    shard 0, through the mesh's entry points; every rank's block held
    on rank 0 against the single-card result (and the RS bytes against
    the numpy oracle on a sample), the byte counters against the layout;
    then each step's wire bytes, collective and gf_apply times."""
    import tempfile

    import numpy as np

    from ceph_tpu_torch.ec.linearize import derive_repair_matrix
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.gf.numpy_ref import decode_matrix, encode_ref
    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.ops.rs_kernels import make_encoder
    from ceph_tpu_torch.parallel import distributed as D
    from ceph_tpu_torch.parallel import mesh as MM
    from ceph_tpu_torch.utils import tracing

    dev = mesh.device
    dp, shard = mesh.devices.shape
    row, col = mesh.position
    B = MESH_OBJECTS * dp
    gen = torch.Generator(device=dev)
    gen.manual_seed(gen_seed)
    sl = OBJECT_SIZE // K
    rs = factory(PROFILE).matrix
    survivors = tuple(s for s in range(K + M) if s not in LOST)[:K]
    # every rank makes the whole batch from one seed: the host's data
    data = torch.randint(0, 256, (B, K, sl), dtype=torch.uint8, device=dev,
                         generator=gen)

    def stacked(profile):
        coder = factory(profile)
        n = coder.get_chunk_count()
        objs = torch.randint(0, 256, (B, OBJECT_SIZE), dtype=torch.uint8,
                             device=dev, generator=gen)
        enc = coder.encode(range(n), objs)
        full = torch.stack([enc[i] for i in range(n)], dim=1)
        return coder, n, torch.nn.functional.pad(
            full, (0, 0, 0, MM.padded_slots(n, mesh) - n))

    lrc, n_lrc, lrc_chunks = stacked(LRC_PROFILE)
    lost = lrc.data_positions[0]
    helpers = sorted(lrc.minimum_to_decode(
        [lost], [c for c in range(n_lrc) if c != lost]))
    R = derive_repair_matrix(lrc, [lost], helpers)
    clay, n_clay, clay_chunks = stacked(CLAY_PROFILE)
    clay_helpers = tuple(range(1, clay.d + 1))
    _D, planes = clay.repair_plan_matrix(0, clay_helpers)
    nsub = clay.get_sub_chunk_count()
    torch.cuda.synchronize()

    steps = {"encode": MM.make_sharded_encoder(rs, mesh),
             "decode": MM.make_sharded_decoder(rs, LOST, survivors, mesh),
             "lrc_repair": MM.make_sharded_gather_apply(R, tuple(helpers),
                                                        mesh),
             "clay_repair": MM.make_sharded_clay_repair(clay, 0, clay_helpers,
                                                        mesh)}
    # the drive, its gf_apply launches counted from 0
    gf_set(G)
    gdata = D.global_batch(mesh, data)
    chunks = steps["encode"](gdata)
    outs = {"encode": chunks, "decode": steps["decode"](chunks),
            "lrc_repair": steps["lrc_repair"](lrc_chunks),
            "clay_repair": steps["clay_repair"](clay_chunks)}
    torch.cuda.synchronize()
    launches, shapes = gf_counts(G)
    if launches == 0:
        fail(f"phase 13: rank {mesh.rank} launched no gf_apply on mesh "
             f"{mesh.devices.tolist()}")
    wires = {name: dict(vars(step.wire)) for name, step in steps.items()}

    # every rank's block on rank 0, against the single-card result
    slots = MM.padded_slots(K + M, mesh)
    got = {name: out.gather_global(dst=0) for name, out in outs.items()}
    if mesh.rank == 0:
        full = torch.zeros((B, slots, sl), dtype=torch.uint8, device=dev)
        full[:, :K] = data
        full[:, K:K + M] = make_encoder(rs)(data)
        want = {"encode": full,
                "decode": make_encoder(decode_matrix(
                    rs, list(LOST), K, list(survivors)))(
                        full[:, list(survivors)]),
                "lrc_repair": make_encoder(R)(lrc_chunks[:, helpers]),
                "clay_repair": clay_chunks[:, 0]}
        for name in want:
            if not torch.equal(got[name], want[name]):
                fail(f"phase 13: the sharded {name} on mesh "
                     f"{mesh.devices.tolist()} differs from the single-card "
                     f"result")
        if not torch.equal(want["decode"], full[:, list(LOST)]) or \
                not torch.equal(want["lrc_repair"][:, 0],
                                lrc_chunks[:, lost]):
            fail("phase 13: a single-card rebuild differs from the lost "
                 "chunk")
        sample = data[:4, :, :4096].cpu().numpy()
        if not np.array_equal(full[:4, K:K + M, :4096].cpu().numpy(),
                              encode_ref(rs, sample)):
            fail("phase 13: the sharded parity differs from the numpy "
                 "oracle")
    del got

    # the wire: encode moves nothing, a gather only the wanted slots
    b = B // dp
    wanted = {"decode": (survivors, slots, sl),
              "lrc_repair": (helpers, lrc_chunks.shape[1], sl),
              "clay_repair": (clay_helpers, clay_chunks.shape[1],
                              sl // nsub * len(planes))}
    if wires["encode"] != {"calls": 0, "sent": 0, "received": 0,
                           "padding": 0}:
        fail(f"phase 13: the sharded encode moved bytes: {wires['encode']}")
    for name, (want_slots, n_slots, width) in wanted.items():
        counts = slot_counts(want_slots, n_slots, shard)
        w = wires[name]
        payload = (sum(counts) - counts[col]) * b * width
        if w["calls"] != 1 or w["received"] - w["padding"] != payload or \
                w["received"] != (shard - 1) * max(counts) * b * width:
            fail(f"phase 13: {name} on rank {mesh.rank} moved {w}, not "
                 f"{payload} bytes of wanted slots")
    if len(planes) * clay.q != nsub:
        fail("phase 13: Clay's helpers ship other than beta/nsub")

    # times: each step under a trace (device ms of gf_apply and NCCL),
    # the collective alone by CUDA events at the step's shape
    times = {}
    inputs = {"encode": gdata, "decode": chunks, "lrc_repair": lrc_chunks,
              "clay_repair": clay_chunks}
    calls = 5
    for name, step in steps.items():
        x = step.in_sharding.put(inputs[name])   # cut once, not a call
        step(x)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as log_dir:
            with tracing.trace(log_dir) as ok:
                if not ok:
                    fail("phase 13: utils/tracing could not start a trace")
                for _ in range(calls):
                    step(x)
                torch.cuda.synchronize()
            traced = trace_kernel_ms(Path(log_dir), calls)
        step_ms = cuda_ms(lambda: step(x), calls=calls)
        w = wires[name]
        row_t = {"received": w["received"], "sent": w["sent"],
                 "padding": w["padding"], "step_ms": step_ms,
                 "gf_apply_device_ms": traced["gf_apply"],
                 "collective_trace_ms": traced["nccl"]}
        if name != "encode":
            want_slots, n_slots, width = wanted[name]
            top = max(slot_counts(want_slots, n_slots, shard))
            piece = torch.zeros((b, top, width), dtype=torch.uint8,
                                device=dev)
            probe = MM.Wire()
            torch.distributed.barrier()
            ms = cuda_ms(lambda: mesh.all_gather(piece, "shard", probe),
                         calls=10)
            bound = max(w["sent"], w["received"]) / NVLINK_BYTES_PER_S * 1e3
            row_t.update({
                "collective_ms": ms,
                "gbps": w["received"] / ms / 1e6 if w["received"] else None,
                "bound_ms": bound,
                "share": bound / ms if w["received"] else None})
        times[name] = row_t
    return {"mesh": mesh.devices.tolist(), "position": [row, col],
            "launches": launches, "by_shape": by_shape(shapes),
            "wire": wires, "times": times}


def mesh_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of phase 13 (a spawned process a card): init_process over
    NCCL, then `mesh_steps` at (1, world) (default_mesh) and, on more
    than one card, host_mesh(shard=world // 2); its results into
    `out_dir`/rank<rank>.json."""
    import torch

    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.parallel import distributed as D
    from ceph_tpu_torch.parallel import mesh as MM
    from ceph_tpu_torch.utils import nvcc

    if not nvcc.library_path(G._SRC).exists():
        fail(f"phase 13: rank {rank} finds no gf_apply library from "
             f"phase 1")
    dev = D.init_process(f"127.0.0.1:{port}", world, rank,
                         local_devices=world)
    meshes = [("default_mesh(shard=%d)" % world,
               lambda: MM.default_mesh(shard=world))]
    if world > 1 and world % 2 == 0:
        meshes.append(("host_mesh(shard=%d)" % (world // 2),
                       lambda: D.host_mesh(shard=world // 2)))
    out = {"rank": rank, "device": str(dev),
           "name": torch.cuda.get_device_name(dev), "meshes": {}}
    for i, (label, make) in enumerate(meshes):
        out["meshes"][label] = mesh_steps(torch, make(), SEED + 30 + i)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def mesh_phase(torch) -> dict:
    """Phase 13: spawn one rank a card (NCCL), run `mesh_rank` on each and
    print every rank's launches, bytes and times; any rank's failure
    fails the phase. Returns the ranks' results."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    torch.cuda.empty_cache()            # the ranks share the cards with us
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(mesh_rank, args=(world, port, out_dir), nprocs=world,
                 join=True)
        ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
                 for r in range(world)]
    secs = time.perf_counter() - t0
    if world == 1:
        log("  one card: the mesh is (1, 1); its collectives run over a "
            "one-rank NCCL group and move no bytes")
    total, shapes = 0, collections.Counter()
    for label in ranks[0]["meshes"]:
        log(f"  {label}: mesh {ranks[0]['meshes'][label]['mesh']}")
        for r in ranks:
            res = r["meshes"][label]
            total += res["launches"]
            shapes.update(res["by_shape"])
            log(f"    rank {r['rank']} ({r['device']}, position "
                f"{res['position']}): gf_apply launches {res['launches']}")
            for name, t in res["times"].items():
                extra = ""
                if "collective_ms" in t:
                    gbps = "no bytes" if t["gbps"] is None else \
                        f"{t['gbps']:.2f} GB/s, {t['share']:.3f} of the " \
                        f"{t['bound_ms']:.5f} ms NVLink bound"
                    extra = (f"; all-gather alone {t['collective_ms']:.5f} "
                             f"ms ({gbps})")
                log(f"      {name}: received {t['received']} B (padding "
                    f"{t['padding']}), sent {t['sent']} B; step "
                    f"{t['step_ms']:.5f} ms; device ms in the trace: "
                    f"gf_apply {show(t['gf_apply_device_ms'])}, NCCL "
                    f"{show(t['collective_trace_ms'])}{extra}")
    log(f"  phase 13 took {secs:.1f} s on {world} card(s); every rank's "
        f"block equal to the single-card result")
    return {"world": world, "seconds": secs, "launches": total,
            "by_shape": dict(shapes), "ranks": ranks}


# ------------------------------------------------------------ phase 14

def standalone_path(torch, dev) -> dict:
    """The wire tier on the card: a StandaloneCluster (osd/standalone.py)
    of SA_OSDS OSD daemons, three Paxos monitors and a cephx client over
    AES-GCM sessions, every interaction a frame on the Messenger. Writes
    SA_OBJECTS x 4 MiB 16 at a time (traced), reads them back, overwrites
    4 KiB ranges, kills an OSD holding shards, reads degraded, waits for the
    down mark and for recovery onto the new acting sets, reads
    everything again against a host model and deep-scrubs every PG.
    The kernels and the native library must be built before: a first
    build on a daemon's thread would hold its pings past the heartbeat
    grace."""
    from ceph_tpu_torch.osd import standalone as S

    t_phase = time.perf_counter()
    # the CUDA context and the first allocation, before any daemon runs
    torch.zeros(1, device=dev).sum().item()
    frames = collections.Counter()
    submit = {kind: getattr(S.RemoteStore, kind)
              for kind in ("readv_submit", "readv_ranges_submit")}

    def counted(kind):
        def call(self, *args, **kw):
            frames[kind] += 1
            return submit[kind](self, *args, **kw)
        return call
    for kind in submit:
        setattr(S.RemoteStore, kind, counted(kind))
    c = S.StandaloneCluster(
        n_osds=SA_OSDS, pg_num=SA_PGS, profile=f"plugin=tpu_rs k={K} m={M}",
        chunk_size=OBJECT_SIZE // K, secret=os.urandom(32), cephx=SA_CEPHX,
        op_window=SA_INFLIGHT, op_timeout=SA_OP_TIMEOUT, hb_grace=SA_GRACE,
        **entry_device(dev))
    try:
        return standalone_run(torch, dev, c, frames, t_phase)
    finally:
        c.shutdown()
        for kind, fn in submit.items():
            setattr(S.RemoteStore, kind, fn)


def suspects(c) -> dict:
    """Each OSD daemon's suspected peers, where it has any."""
    return {d.name: sorted(d.suspect) for d in c.osds.values()
            if d.suspect}


def downs(c) -> dict:
    """The OSDs each running OSD daemon's map holds down."""
    return {d.name: [o for o, up in enumerate(d.osdmap.osd_up) if not up]
            for d in c.osds.values()
            if not d._stop.is_set() and d.osdmap is not None}


def unclean_pgs(c) -> dict:
    """Why each PG of the in-process cluster `c` is not clean yet, by
    wait_for_clean's tests: no live primary in its map, no backend, a
    backend on another acting set, a recovery in flight, or a lagging
    slot."""
    out = {}
    for ps in range(c.pg_num):
        owner = None
        for d in c.osds.values():
            if d._stop.is_set() or d.osdmap is None:
                continue
            acting = d.osdmap.pg_to_up_acting_osds(1, ps)[2]
            if acting and acting[0] == d.osd_id:
                owner = d
                break
        be = owner.backends.get(ps) if owner is not None else None
        if owner is None:
            out[ps] = "no primary"
        elif be is None:
            out[ps] = f"osd.{owner.osd_id}: no backend"
        elif be.acting != acting:
            out[ps] = f"osd.{owner.osd_id}: backend on {be.acting}"
        elif ps in owner._recovering:
            out[ps] = f"osd.{owner.osd_id}: recovering"
        elif owner._lagging_slots(be):
            out[ps] = f"osd.{owner.osd_id}: lagging slots"
    return out


def standalone_run(torch, dev, c, frames, t_phase) -> dict:
    """standalone_path's steps on the started cluster `c`; `frames`
    counts the readv frames submitted."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    want = torch.device(dev.type, torch.cuda.current_device()) \
        if dev.type == "cuda" else dev
    devices = {str(d.device) for d in c.osds.values()} | {
        str(m.device) for m in c.mons}
    if c.device != want or devices != {str(want)}:
        fail(f"phase 14: cluster on {c.device}, daemons on {devices}")
    # a daemon whose heartbeat thread died never reports a failure, and
    # the down mark after the kill below would never come
    dead = [d.name for d in [*c.osds.values(), *c.mons]
            if not d._hb.is_alive()]
    if dead:
        fail(f"phase 14: heartbeat threads dead at start: {dead}")
    # every PG active before the load, as tools/rados_bench.py waits
    # before its standalone writes: a primary still peering gathers PG
    # metadata with a 1 s timeout, which the writes' frames outlast, and
    # suspects the peers that answer late; writes skip suspects until
    # one falls below min_size. The budget is phase 15's: a host slowed
    # by other load once took longer than 60 s to peer all 32 PGs
    try:
        c.wait_for_clean(timeout=120)
    except TimeoutError:
        log(f"  PGs not clean at boot: {unclean_pgs(c)}; suspects "
            f"{suspects(c)}")
        raise
    cl = c.client()
    # then one committed epoch, which clears every suspicion left from
    # boot; it turns the daemons' sampling profilers off as well, as
    # `ceph config set global daemon_profile_hz 0` does (fifteen stack
    # samplers at 10 Hz over every thread of the process)
    cl.config_set("daemon_profile_hz", "0", timeout=60)
    t_end = time.monotonic() + 60
    while not all(d.osdmap is not None
                  and d.osdmap.config_kv.get("daemon_profile_hz") == "0"
                  for d in c.osds.values()):
        if time.monotonic() > t_end:
            fail("phase 14: daemon_profile_hz 0 not folded by every OSD")
        time.sleep(0.05)
    out["boot_s"] = time.perf_counter() - t_phase
    log(f"  started: every PG clean, epoch "
        f"{min(d.osdmap.epoch for d in c.osds.values())}, suspects "
        f"{suspects(c)}, {out['boot_s']:.1f} s into the phase")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    names = [f"sa_{i:04d}" for i in range(SA_OBJECTS)]
    rows = torch.randint(0, 256, (SA_OBJECTS, OBJECT_SIZE),
                         dtype=torch.uint8, device=dev,
                         generator=gen).cpu().numpy()

    def same(label: str, got: dict, idx) -> None:
        for i in idx:
            g = got.get(names[i])
            if g is None or len(g) != OBJECT_SIZE or not np.array_equal(
                    np.frombuffer(g, np.uint8), rows[i]):
                fail(f"phase 14: {label}: {names[i]} differs from the "
                     f"bytes written")

    def read_all(label: str) -> float:
        t0 = time.perf_counter()
        for i in range(0, SA_OBJECTS, SA_INFLIGHT):
            idx = range(i, min(SA_OBJECTS, i + SA_INFLIGHT))
            same(label, cl.read_many([names[j] for j in idx]), idx)
        return time.perf_counter() - t0

    gbytes = SA_OBJECTS * OBJECT_SIZE / 1e9
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(0, SA_OBJECTS, SA_INFLIGHT):
            try:
                cl.write({names[j]: rows[j].tobytes() for j in
                          range(i, min(SA_OBJECTS, i + SA_INFLIGHT))})
            except ConnectionError:
                log(f"  write of objects {i}.. refused after "
                    f"{time.perf_counter() - t0:.1f} s; suspects "
                    f"{suspects(c)}")
                raise
        torch.cuda.synchronize()
        t_write = time.perf_counter() - t0
    busy = device_busy_s(prof)
    backends = [be for d in c.osds.values() for be in d.backends.values()]
    impls = {be.coder.impl for be in backends}
    if not backends or impls != {"pallas"} \
            or {str(be.device) for be in backends} != {str(want)}:
        fail(f"phase 14: backends {len(backends)}, impls {impls}")
    t_read = read_all("read_many")
    out.update({"objects": SA_OBJECTS, "object_bytes": OBJECT_SIZE,
                "write_s": t_write, "write_gbps": gbytes / t_write,
                "write_device_busy_s": busy,
                "write_idle_share": idle_share(busy, t_write),
                "read_s": t_read, "read_gbps": gbytes / t_read})
    log(f"  standalone: {SA_OSDS} OSDs, {SA_PGS} PGs, "
        f"{'cephx over ' if SA_CEPHX else ''}AES-GCM sessions; "
        f"{SA_OBJECTS} x {OBJECT_SIZE >> 20} MiB written "
        f"{gbytes / t_write:.4f} GB/s (device busy {show(busy)} s, idle "
        f"{show(idle_share(busy, t_write))}), read {gbytes / t_read:.4f} "
        f"GB/s (host clock), exact; suspects after the write "
        f"{suspects(c)}")

    # -- 4 KiB overwrites: the parity delta over rmw_fetch frames -------
    rng = np.random.default_rng(SEED + 14)
    picks = rng.integers(0, SA_OBJECTS, SA_RANDOM)
    offs = rng.integers(0, OBJECT_SIZE // RBD_BLOCK, SA_RANDOM) * RBD_BLOCK
    data = torch.randint(0, 256, (SA_RANDOM, RBD_BLOCK), dtype=torch.uint8,
                         device=dev, generator=gen).cpu().numpy()
    rmw0 = sum(d.ec_perf.get("rmw_ops") for d in c.osds.values())
    t0 = time.perf_counter()
    for i in range(SA_RANDOM):
        j, off = int(picks[i]), int(offs[i])
        cl.write_at(names[j], off, data[i].tobytes())
        rows[j, off:off + RBD_BLOCK] = data[i]
    t_rand = time.perf_counter() - t0
    rmw = sum(d.ec_perf.get("rmw_ops") for d in c.osds.values()) - rmw0
    touched = sorted({int(j) for j in picks})
    got = {}
    for i in range(0, len(touched), SA_INFLIGHT):
        got.update(cl.read_many([names[j] for j in
                                 touched[i:i + SA_INFLIGHT]]))
    same("read after write_at", got, touched)
    out.update({"write_at_ops": SA_RANDOM, "write_at_s": t_rand,
                "write_at_ops_s": SA_RANDOM / t_rand, "rmw_ops": rmw})
    log(f"  {SA_RANDOM} random {RBD_BLOCK} B write_at at "
        f"{SA_RANDOM / t_rand:.1f} ops/s (host clock), {rmw} on the delta "
        f"path; reads exact")

    # -- kill an OSD holding shards; degraded reads; down; recovery -----
    osdmap = cl.osdmap

    def acting(name: str) -> tuple:
        ps = osdmap.object_to_pg(1, name)[1]
        return ps, osdmap.pg_to_up_acting_osds(1, ps)[2]
    victim = acting(names[0])[1][1]
    held = [i for i in range(SA_OBJECTS) if victim in acting(names[i])[1]]
    rec0 = sum(d.ec_perf.get("recovered_objects") for d in c.osds.values())
    for d in c.osds.values():
        d.config.set("osd_heartbeat_grace", SA_KILL_GRACE, level="override")
    live = {o: d for o, d in c.osds.items() if o != victim}
    # when every live daemon's map first shows the victim down, and when
    # the last object was recovered, seen from a watcher thread (the
    # degraded reads below block the main thread meanwhile)
    seen = {"down": None, "recovered": 0, "last": None}
    stop = threading.Event()

    def watch() -> None:
        while not stop.wait(0.02):
            if seen["down"] is None and all(
                    d.osdmap is not None and not d.osdmap.osd_up[victim]
                    for d in live.values()):
                seen["down"] = time.perf_counter()
            n = sum(d.ec_perf.get("recovered_objects")
                    for d in live.values()) - rec0
            if n > seen["recovered"]:
                seen["recovered"], seen["last"] = n, time.perf_counter()
    watcher = threading.Thread(target=watch, daemon=True)
    t_kill = time.perf_counter()
    c.kill_osd(victim)
    watcher.start()
    # degraded reads of objects whose primary lives: the primary decodes
    # them from the surviving shards (a read whose primary died waits
    # for the down mark instead, which kill -> down below measures)
    deg = [i for i in held if acting(names[i])[1][0] != victim][
        :SA_DEGRADED]
    t0 = time.perf_counter()
    try:
        same("degraded read", cl.read_many([names[i] for i in deg]), deg)
    except ConnectionError:
        # the client's view when a read gave up: which OSDs its map
        # holds down or out, and the acting sets of the PGs read
        m = cl.osdmap
        pgs = sorted({acting(names[i])[0] for i in deg})
        log(f"  degraded read failed {time.perf_counter() - t0:.1f} s "
            f"after the kill: client map epoch {m.epoch}, down "
            f"{[o for o, up in enumerate(m.osd_up) if not up]}, out "
            f"{[o for o, w in enumerate(m.osd_weight) if w == 0]}, "
            f"acting sets "
            f"{ {ps: m.pg_to_up_acting_osds(1, ps)[2] for ps in pgs} }, "
            f"suspects {suspects(c)}")
        raise
    t_deg = time.perf_counter() - t0
    # the down mark waits for two reporters and a Paxos commit among 12
    # in-process daemons on one host: a generous budget
    try:
        c.wait_for_down(victim, timeout=240)
        c.wait_for_clean(timeout=120)
        out["kill_to_clean_wait_s"] = time.perf_counter() - t_kill
    except TimeoutError:
        # which PGs hold out and why, what each live daemon suspects
        # and which OSDs its map holds down
        log(f"  after osd.{victim}'s kill: PGs not clean "
            f"{unclean_pgs(c)}; suspects {suspects(c)}; down in each "
            f"live daemon's map {downs(c)}")
        raise
    stop.set()
    watcher.join(5)
    recovered = sum(d.ec_perf.get("recovered_objects")
                    for d in live.values()) - rec0
    t_down = seen["down"] or time.perf_counter()
    t_clean = max(seen["last"] or t_down, t_down)
    wire = sum(d.ec_perf.get("recover_wire_bytes") for d in live.values())
    if recovered == 0 or sum(frames.values()) == 0:
        fail(f"phase 14: recovered {recovered} objects from "
             f"{dict(frames)} readv frames")
    out.update({"victim": victim, "objects_on_victim": len(held),
                "degraded_reads": len(deg), "degraded_read_s": t_deg,
                "kill_to_down_s": t_down - t_kill,
                "down_to_clean_s": t_clean - t_down,
                "kill_to_clean_s": t_clean - t_kill,
                "recovered_objects": recovered,
                "recovered_objects_s": recovered / max(t_clean - t_down,
                                                       1e-9),
                "recover_wire_bytes": wire,
                "readv_frames": dict(frames)})
    log(f"  osd.{victim} ({len(held)} objects with a shard on it) killed: "
        f"{len(deg)} degraded reads exact in {t_deg:.3f} s; down after "
        f"{t_down - t_kill:.3f} s; {recovered} objects recovered, "
        f"{out['recovered_objects_s']:.1f} objects/s, the last "
        f"{t_clean - t_down:.3f} s after the down mark, from "
        f"{dict(frames)} readv frames, "
        f"recover_wire_bytes {wire}; wait_for_clean returned "
        f"{out['kill_to_clean_wait_s']:.3f} s after the kill")

    # -- everything again, then a deep scrub of every PG ----------------
    t_reread = read_all("read after recovery")
    t0 = time.perf_counter()
    for ps in range(SA_PGS):
        rep = cl.deep_scrub(ps)
        if rep["inconsistent"]:
            fail(f"phase 14: deep scrub of PG {ps}: {rep['inconsistent']}")
    t_scrub = time.perf_counter() - t0
    msgrs = [d.msgr for d in c.osds.values()] + [m.msgr for m in c.mons] \
        + [x.msgr for x in c.clients]
    wire_counts = {key: sum(m.perf.get(key) for m in msgrs)
                   for key in ("frames_tx", "bytes_tx", "frames_rx",
                               "bytes_rx")}
    out.update({"reread_s": t_reread, "deep_scrub_s": t_scrub,
                "messenger": wire_counts,
                "phase_s": time.perf_counter() - t_phase})
    log(f"  every byte read again exact in {t_reread:.3f} s; deep scrub "
        f"of {SA_PGS} PGs clean in {t_scrub:.3f} s; messengers "
        f"{json.dumps(wire_counts)}")
    log(f"  phase 14 wall time {out['phase_s']:.1f} s; {card_line()}")
    return out


def standalone_phase(torch, dev) -> tuple:
    """Phase 14 with its launch counts set to 0 before and read after;
    fails unless gf_apply launched an encode, the 4 KiB delta and a
    decode, and the CRC32C kernel launched."""
    from ceph_tpu_torch.ops import gf_kernel as G
    gf_set(G)
    csum_set()
    sa = standalone_path(torch, dev)
    launches, shapes = gf_counts(G)
    log(f"  gf_apply launches in phase 14: {launches}, by (k,m,L,vec): "
        f"{json.dumps(by_shape(shapes))}")
    encodes = sum(n for (k, m, _L, _v), n in shapes.items()
                  if k == K and m == M)
    deltas = sum(n for (k, m, L, _v), n in shapes.items()
                 if k < K and m == M and L == RBD_BLOCK)
    if encodes == 0 or deltas == 0 or decode_launches(shapes) == 0:
        fail(f"phase 14: gf_apply launches {launches}: encodes {encodes}, "
             f"of the 4 KiB delta shape {deltas}, decodes "
             f"{decode_launches(shapes)}")
    crc = crc_launches("phase 14")
    sa.update({"gf_apply_launches": launches,
               "gf_apply_encode_launches": encodes,
               "gf_apply_delta_4k_launches": deltas,
               "gf_apply_decode_launches": decode_launches(shapes),
               "gf_apply_by_shape": by_shape(shapes),
               "crc32c_launches": crc})
    return sa, launches, shapes, crc


# ------------------------------------------------------------ phase 15

def proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of process `pid` so far, from
    /proc/<pid>/stat (utime and stime, fields 14 and 15)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class CardSampler:
    """nvidia-smi's utilization.gpu every 100 ms while the with-block
    runs: the share of each sample period in which a kernel of any
    process ran on the card (the children's included, which the parent's
    torch.profiler cannot see). No samples where there is no nvidia-smi
    (a rehearsal on the CPU)."""

    def __enter__(self):
        self.samples = []
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)
        except OSError:
            self._proc = None
        return self

    def __exit__(self, *exc):
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            out = self._proc.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            self._proc.kill()
            out = self._proc.communicate()[0]
        for line in out.splitlines():
            try:
                self.samples.append(float(line.split(",")[0]))
            except ValueError:
                pass

    def busy_share(self) -> float | None:
        if not self.samples:
            return None
        return statistics.fmean(self.samples) / 100


def procs_state(c, what: str) -> None:
    """Log each live child's view where a wait of phase 15 failed: its
    map epoch and suspects, the PGs it primaries that are not clean, its
    recovered objects, the last lines of its log that speak of recovery
    or failure, and the end of its stderr."""
    import re

    from ceph_tpu_torch.utils.admin_socket import AdminSocketError
    log(f"  {what} failed; monitors at epoch "
        f"{[m.osdmap.epoch for m in c.mons if m.osdmap is not None]}")
    for h in c.osds.values():
        if h._stop.is_set():
            continue
        try:
            st = h.asok("status", timeout=30.0)
            claims = h.asok("pg clean", timeout=30.0)
            ec = h.asok("perf dump", timeout=30.0)["ec"]
            lines = h.asok("log dump", timeout=30.0)["lines"]
        except (OSError, AdminSocketError, ValueError, KeyError) as e:
            log(f"    {h.name}: no answer ({e!r}); stderr ends "
                f"{h.stderr_tail(600)!r}")
            continue
        said = [line for line in lines
                if re.search(r"recover|fail|error|Error|timed out", line)]
        log(f"    {h.name}: epoch {st['osdmap_epoch']}, suspects "
            f"{st['suspect']}, not clean {sorted(k for k, v in claims.items() if not v)} "
            f"of {len(claims)}, recovered_objects "
            f"{ec.get('recovered_objects')}; log {said[-4:]}; stderr ends "
            f"{h.stderr_tail(300)!r}")


def settled_or_undersized(c, held_pgs: list, rec0: int, victim: int
                          ) -> list | None:
    """After a kill: None until every PG's primary claims it clean and
    the survivors have recovered every object that had a shard on the
    victim (`held_pgs`: the PG of each), but for the PGs whose acting
    set in the committed map holds a CRUSH_ITEM_NONE slot (12 OSDs, 11
    shards a PG: CRUSH cannot always place 11 on the 11 left; ROADMAP
    queue 3), which stay undersized until the victim returns; then the
    list of those PGs."""
    from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
    from ceph_tpu_torch.utils.admin_socket import AdminSocketError
    osdmap = next(m.osdmap for m in c.mons if not m._stop.is_set())
    holes = [ps for ps in range(c.pg_num)
             if CRUSH_ITEM_NONE in osdmap.pg_to_up_acting_osds(1, ps)[2]]
    want = sum(ps not in holes for ps in held_pgs)
    try:
        if child_perf(c, "recovered_objects", skip={victim}) - rec0 < want:
            return None
        claims: dict = {}
        for h in c.osds.values():
            if not h._stop.is_set():
                for pg, ok in h.asok("pg clean", timeout=10.0).items():
                    claims[pg] = claims.get(pg, False) or ok
    except (OSError, AdminSocketError, ValueError, KeyError):
        return None
    if all(claims.get(f"1.{ps}") for ps in range(c.pg_num)
           if ps not in holes):
        return holes
    return None


def child_perf(c, key: str, skip=()) -> int:
    """The OSD children's `ec` perf counter `key`, summed over their
    admin sockets (a child's RAM is out of the parent's reach)."""
    return sum(h.asok("perf dump", timeout=10.0)["ec"][key]
               for o, h in c.osds.items()
               if o not in skip and not h._stop.is_set())


def tickets_held(c) -> int:
    """OSD children that fetched their service tickets: a fetch round
    that completed (cephx fetch_time's count in their perf dump)."""
    from ceph_tpu_torch.utils.admin_socket import AdminSocketError
    held = 0
    for h in c.osds.values():
        try:
            dump = h.asok("perf dump", timeout=5.0)
        except (OSError, AdminSocketError, ValueError):
            continue
        held += dump.get("cephx", {}).get("fetch_time", {}).get(
            "avgcount", 0) > 0
    return held


class BootStorm(RuntimeError):
    """A live OSD marked down+out while phase 15's cluster boots."""


def storm_guarded(S, marks: list):
    """StandaloneCluster for phase 15's boots: every wait of its boot
    stops at the first down+out the monitors commit (`marks` grows),
    and a boot that fails shuts down the processes it started (the
    constructor raises with its children up)."""
    class Cluster(S.StandaloneCluster):
        def __init__(self, **kw):
            self.booting = len(marks)
            try:
                super().__init__(**kw)
            except BaseException:
                with contextlib.suppress(AttributeError):
                    self.shutdown()
                raise

        def _wait(self, pred, timeout: float, what: str) -> None:
            def watched() -> bool:
                if self.booting is not None and len(marks) > self.booting:
                    raise BootStorm(
                        f"{sorted({o for _t, o in marks[self.booting:]})} "
                        f"marked down+out while waiting for {what}")
                return pred()
            super()._wait(watched, timeout, what)
    return Cluster


def settle(c, boot: dict, faults: list, t1: float) -> None:
    """procs_boot's waits on the constructed cluster `c`: every PG
    clean, every child's osd ticket, one committed config epoch folded
    by every child without a suspect, then SP_SETTLE seconds. Adds its
    numbers to `boot` and what failed to `faults`."""
    from ceph_tpu_torch.utils.admin_socket import AdminSocketError
    try:
        c.wait_for_clean(timeout=120)
    except TimeoutError:
        faults.append("PGs not clean in 120 s")
    boot["ready_to_clean_s"] = time.perf_counter() - t1
    t_end = time.monotonic() + SP_TICKETS
    while tickets_held(c) < SA_OSDS and time.monotonic() < t_end:
        time.sleep(0.5)
    boot["osds_with_tickets"] = tickets_held(c)
    if boot["osds_with_tickets"] < SA_OSDS:
        faults.append(f"{boot['osds_with_tickets']} of {SA_OSDS} OSDs "
                      f"hold their osd ticket after {SP_TICKETS:.0f} s")
    # one committed epoch clears the suspicion left from boot and turns
    # the daemons' sampling profilers off (phase 14's step)
    cl = c.client()
    cl.config_set("daemon_profile_hz", "0", timeout=60)
    epoch = max(m.osdmap.epoch for m in c.mons if not m._stop.is_set())
    t_end = time.monotonic() + 60
    while True:
        status = {}
        for h in c.osds.values():
            try:
                st = h.asok("status", timeout=10.0)
                status[h.name] = (st["osdmap_epoch"], st["suspect"])
            except (OSError, AdminSocketError, ValueError) as e:
                status[h.name] = (0, repr(e))
        if all(e >= epoch and not sus for e, sus in status.values()):
            break
        if time.monotonic() > t_end:
            faults.append(f"epoch {epoch} not folded without suspects: "
                          f"{status}")
            break
        time.sleep(0.2)
    time.sleep(SP_SETTLE)
    c._wait(lambda: True, 1, "the settle")    # a storm since raises


def procs_boot(torch, dev, S, store_dir: str, grace: float, marks: list
               ) -> tuple:
    """One boot of phase 15's cluster at heartbeat grace `grace`: spawn
    to ready, every PG clean, every OSD's osd ticket, one committed
    config epoch folded by every child, then SP_SETTLE seconds watched.
    Returns the cluster (None where the boot failed), the boot's numbers
    and its faults (the boot storm and the cephx ticket fault of
    ROADMAP queue 3)."""
    n0 = len(marks)
    t0 = time.perf_counter()
    boot = {"grace_s": grace}
    try:
        c = storm_guarded(S, marks)(
            n_osds=SA_OSDS, pg_num=SA_PGS,
            profile=f"plugin=tpu_rs k={K} m={M}",
            chunk_size=OBJECT_SIZE // K, osd_procs=True, store="tin",
            store_dir=store_dir, cephx=True, secret=os.urandom(32),
            op_window=SA_INFLIGHT, op_timeout=SA_OP_TIMEOUT, hb_grace=grace,
            **entry_device(dev))
    except (BootStorm, TimeoutError) as e:
        boot.update({"failed_after_s": time.perf_counter() - t0,
                     "false_down_marks": sorted({o for _t, o in marks[n0:]}),
                     "faults": [str(e)]})
        log(f"  boot at a {grace} s heartbeat grace failed after "
            f"{boot['failed_after_s']:.2f} s: {e}")
        return None, boot, boot["faults"]
    boot["spawn_to_ready_s"] = time.perf_counter() - t0
    faults = []
    devices = {h.name: h.device for h in c.osds.values()}
    want = str(torch.device(dev.type, torch.cuda.current_device())
               if dev.type == "cuda" else dev)
    if set(devices.values()) != {want}:
        fail(f"phase 15: children on {devices}, the cluster on {c.device}")
    t1 = time.perf_counter()
    try:
        settle(c, boot, faults, t1)
    except BootStorm as e:
        faults.append(str(e))
    c.booting = None
    boot["spawn_to_settled_s"] = time.perf_counter() - t0
    boot["false_down_marks"] = sorted({osd for _t, osd in marks[n0:]})
    boot["faults"] = faults
    free, total = torch.cuda.mem_get_info() if dev.type == "cuda" else (
        None, None)
    boot.update({"child_devices": sorted(set(devices.values())),
                 "card_free_bytes": free, "card_total_bytes": total})
    log(f"  boot at a {grace} s heartbeat grace: spawn -> ready "
        f"{boot['spawn_to_ready_s']:.2f} s, ready -> clean "
        f"{boot.get('ready_to_clean_s', 0):.2f} s, "
        f"{boot.get('osds_with_tickets')} "
        f"OSDs with tickets, settled {boot['spawn_to_settled_s']:.2f} s "
        f"after the spawn; children on {boot['child_devices']}; card "
        f"memory free {free} of {total} B; faults {faults or 'none'}")
    return c, boot, faults


def workload_run(c) -> dict:
    """The workload engine over the phase's cluster: WORKLOAD_r20.json's
    tenants, seed and duration, no kill; every tenant's stream digest
    must be the artifact's."""
    from ceph_tpu_torch.workload import WorkloadEngine, parse_profiles
    ref = json.loads((Path(__file__).resolve().parent / WORKLOAD_REF)
                     .read_text())
    engine = WorkloadEngine(c, parse_profiles(ref["profiles"]),
                            seed=int(ref["config"]["seed"]),
                            duration_s=float(ref["config"]["duration_s"]))
    t0 = time.perf_counter()
    engine.setup()
    t_setup = time.perf_counter() - t0
    engine.run()
    results = engine.results()
    for name, row in results.items():
        if row["digest"] != ref["streams"][name]["digest"]:
            fail(f"phase 15: tenant {name}'s stream digest {row['digest']} "
                 f"is not {WORKLOAD_REF}'s")
        if row["ops"] == 0:
            fail(f"phase 15: tenant {name} completed no op: {row}")
    tenants = {name: {key: row.get(key) for key in (
        "stream_ops", "ops", "errors", "p50_ms", "p99_ms", "routed")}
        for name, row in results.items()}
    log(f"  workload engine ({len(results)} tenants, seed "
        f"{engine.seed}, {engine.duration_s} s of streams): setup "
        f"{t_setup:.2f} s, run {engine.elapsed:.2f} s; digests are "
        f"{WORKLOAD_REF}'s; {json.dumps(tenants)}")
    return {"setup_s": t_setup, "run_s": engine.elapsed,
            "tenants": tenants}


def procs_run(torch, dev, c, marks: list, grace: float) -> tuple:
    """Phase 15's steps on the booted cluster `c`: returns its numbers
    and every child's launch counts (the victim's read before the
    kill)."""
    import numpy as np

    out: dict = {}
    cl = c.clients[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    names = [f"sp_{i:04d}" for i in range(SP_OBJECTS)]
    rows = torch.randint(0, 256, (SP_OBJECTS, OBJECT_SIZE),
                         dtype=torch.uint8, device=dev,
                         generator=gen).cpu().numpy()

    def same(label: str, got: dict, idx) -> None:
        for i in idx:
            g = got.get(names[i])
            if g is None or len(g) != OBJECT_SIZE or not np.array_equal(
                    np.frombuffer(g, np.uint8), rows[i]):
                fail(f"phase 15: {label}: {names[i]} differs from the "
                     f"bytes written")

    def read_all(label: str) -> float:
        t0 = time.perf_counter()
        for i in range(0, SP_OBJECTS, SA_INFLIGHT):
            idx = range(i, min(SP_OBJECTS, i + SA_INFLIGHT))
            same(label, cl.read_many([names[j] for j in idx]), idx)
        return time.perf_counter() - t0

    gbytes = SP_OBJECTS * OBJECT_SIZE / 1e9
    pids = {h.name: h._proc.pid for h in c.osds.values()}
    cpu0 = {name: proc_cpu_s(pid) for name, pid in pids.items()}
    own0 = time.process_time()
    with CardSampler() as card:
        t0 = time.perf_counter()
        for i in range(0, SP_OBJECTS, SA_INFLIGHT):
            cl.write({names[j]: rows[j].tobytes() for j in
                      range(i, min(SP_OBJECTS, i + SA_INFLIGHT))})
        t_write = time.perf_counter() - t0
    cpu = {name: proc_cpu_s(pid) - cpu0[name] for name, pid in pids.items()}
    own = time.process_time() - own0
    busy = card.busy_share()
    t_read = read_all("read_many")
    out.update({"objects": SP_OBJECTS, "object_bytes": OBJECT_SIZE,
                "write_s": t_write, "write_gbps": gbytes / t_write,
                "write_card_busy_share": busy,
                "write_idle_share": None if busy is None else 1 - busy,
                "write_card_samples": len(card.samples),
                "write_child_cpu_s": cpu, "write_parent_cpu_s": own,
                "read_s": t_read, "read_gbps": gbytes / t_read})
    log(f"  {SA_OSDS} OSD processes, {SA_PGS} PGs, cephx over AES-GCM; "
        f"{SP_OBJECTS} x {OBJECT_SIZE >> 20} MiB written "
        f"{gbytes / t_write:.4f} GB/s (card busy {show(busy)} of the "
        f"write in {len(card.samples)} nvidia-smi samples, idle "
        f"{show(None if busy is None else 1 - busy)}), read "
        f"{gbytes / t_read:.4f} GB/s (host clock), exact; CPU seconds "
        f"over the write: children {json.dumps(cpu)} (sum "
        f"{sum(cpu.values()):.2f}), this process {own:.2f}")

    # -- 4 KiB overwrites: the parity delta in the primary's process ----
    rng = np.random.default_rng(SEED + 15)
    picks = rng.integers(0, SP_OBJECTS, SP_RANDOM)
    offs = rng.integers(0, OBJECT_SIZE // RBD_BLOCK, SP_RANDOM) * RBD_BLOCK
    data = torch.randint(0, 256, (SP_RANDOM, RBD_BLOCK), dtype=torch.uint8,
                         device=dev, generator=gen).cpu().numpy()
    rmw0 = child_perf(c, "rmw_ops")
    t0 = time.perf_counter()
    for i in range(SP_RANDOM):
        j, off = int(picks[i]), int(offs[i])
        cl.write_at(names[j], off, data[i].tobytes())
        rows[j, off:off + RBD_BLOCK] = data[i]
    t_rand = time.perf_counter() - t0
    rmw = child_perf(c, "rmw_ops") - rmw0
    touched = sorted({int(j) for j in picks})
    got = {}
    for i in range(0, len(touched), SA_INFLIGHT):
        got.update(cl.read_many([names[j] for j in
                                 touched[i:i + SA_INFLIGHT]]))
    same("read after write_at", got, touched)
    out.update({"write_at_ops": SP_RANDOM, "write_at_s": t_rand,
                "write_at_ops_s": SP_RANDOM / t_rand, "rmw_ops": rmw})
    log(f"  {SP_RANDOM} random {RBD_BLOCK} B write_at at "
        f"{SP_RANDOM / t_rand:.1f} ops/s (host clock), {rmw} on the delta "
        f"path; reads exact; live OSDs marked down so far "
        f"{sorted({osd for _t, osd in marks})}")

    # -- SIGKILL an OSD holding shards; down; recovery -------------------
    osdmap = cl.osdmap

    def acting(name: str) -> list:
        return osdmap.pg_to_up_acting_osds(
            1, osdmap.object_to_pg(1, name)[1])[2]
    victim = acting(names[0])[1]
    held = [i for i in range(SP_OBJECTS) if victim in acting(names[i])]
    held_pgs = [osdmap.object_to_pg(1, names[i])[1] for i in held]
    counts = [c.osds[victim].launches()]
    # the recovery's load holds the children's pings seconds late: at
    # the 1.2 s default their peers mark live OSDs down again and again
    # and the children fall tens of epochs behind (ROADMAP queue 3), so
    # the kill runs at SP_KILL_GRACE at least
    kill_grace = max(grace, SP_KILL_GRACE)
    cl.config_set("osd_heartbeat_grace", str(kill_grace), timeout=60)
    rec0 = child_perf(c, "recovered_objects", skip={victim})
    seen = {"down": None, "recovered": 0, "last": None}
    stop = threading.Event()

    def watch_down() -> None:
        # the monitors' committed map, in this process: cheap to poll
        while seen["down"] is None and not stop.wait(0.02):
            if any(m.osdmap is not None and not m.osdmap.osd_up[victim]
                   for m in c.mons if not m._stop.is_set()):
                seen["down"] = time.perf_counter()

    def watch_recovery() -> None:
        # the children's counters, over their admin sockets
        from ceph_tpu_torch.utils.admin_socket import AdminSocketError
        while not stop.wait(0.25):
            try:
                n = child_perf(c, "recovered_objects", skip={victim}) - rec0
            except (OSError, AdminSocketError, ValueError, KeyError):
                continue
            if n > seen["recovered"]:
                seen["recovered"], seen["last"] = n, time.perf_counter()
    watchers = [threading.Thread(target=fn, daemon=True)
                for fn in (watch_down, watch_recovery)]
    n_marks = len(marks)
    t_kill = time.perf_counter()
    c.kill_osd(victim)
    for w in watchers:
        w.start()
    try:
        c.wait_for_down(victim, timeout=120)
    except TimeoutError:
        procs_state(c, f"the wait for osd.{victim}'s down mark")
        raise
    t_down_all = time.perf_counter()
    log(f"  osd.{victim} down everywhere {t_down_all - t_kill:.3f} s after "
        f"its SIGKILL")
    t_end = time.monotonic() + 240
    while (undersized := settled_or_undersized(
            c, held_pgs, rec0, victim)) is None:
        if time.monotonic() > t_end:
            log(f"  {seen['recovered']} objects recovered by "
                f"{time.perf_counter() - t_kill:.1f} s after the kill")
            procs_state(c, f"the wait for osd.{victim}'s recovery")
            fail(f"phase 15: recovery after osd.{victim}'s SIGKILL not "
                 f"settled in 240 s")
        time.sleep(0.25)
    t_clean_all = time.perf_counter()
    stop.set()
    for w in watchers:
        w.join(5)
    recovered = child_perf(c, "recovered_objects", skip={victim}) - rec0
    wire = child_perf(c, "recover_wire_bytes", skip={victim})
    t_down = seen["down"] or t_down_all
    t_last = max(seen["last"] or t_down, t_down)
    if recovered == 0:
        fail(f"phase 15: no object recovered after osd.{victim}'s kill")
    out.update({"victim": victim, "objects_on_victim": len(held),
                "kill_grace_s": kill_grace,
                "kill_to_down_s": t_down - t_kill,
                "kill_to_down_everywhere_s": t_down_all - t_kill,
                "down_to_last_recovered_s": t_last - t_down,
                "kill_to_settled_s": t_clean_all - t_kill,
                "undersized_pgs": undersized,
                "recovered_objects": recovered,
                "recovered_objects_s": recovered / max(t_last - t_down,
                                                       1e-9),
                "recover_wire_bytes": wire,
                "down_marks_after_kill": sorted({
                    osd for _t, osd in marks[n_marks:]})})
    log(f"  osd.{victim} ({len(held)} objects with a shard on it) "
        f"SIGKILLed at a {kill_grace} s grace: down in the monitors' map "
        f"after "
        f"{t_down - t_kill:.3f} s, in every child's after "
        f"{t_down_all - t_kill:.3f} s; {recovered} objects recovered, the "
        f"last {t_last - t_down:.3f} s after the down mark "
        f"({out['recovered_objects_s']:.1f} objects/s), every PG clean "
        f"{t_clean_all - t_kill:.3f} s after the kill but {undersized} "
        f"(undersized: a CRUSH_ITEM_NONE slot); recover_wire_bytes "
        f"{wire}; down marks since the kill "
        f"{out['down_marks_after_kill']}")

    # -- everything again, a deep scrub, the victim revived ----------------
    t_reread = read_all("read after recovery")
    t0 = time.perf_counter()
    checked = 0
    for ps in range(SA_PGS):
        rep = cl.deep_scrub(ps)
        if rep["inconsistent"]:
            fail(f"phase 15: deep scrub of PG {ps}: {rep['inconsistent']}")
        checked += rep["checked"]
    t_scrub = time.perf_counter() - t0
    # every shard, but at most one an object of an undersized PG (its
    # slot without an OSD, which the scrub skips)
    pgs = [osdmap.object_to_pg(1, n)[1] for n in names]
    least = SP_OBJECTS * (K + M) - sum(ps in undersized for ps in pgs)
    if not least <= checked <= SP_OBJECTS * (K + M):
        fail(f"phase 15: deep scrub checked {checked} shards, not "
             f"{least} to {SP_OBJECTS * (K + M)}")
    # a revived child folding the map history answers pings seconds
    # late, and at the boot's grace its peers mark it down again and
    # again (ROADMAP queue 3): the revive runs under SP_REVIVE_GRACE
    cl.config_set("osd_heartbeat_grace", str(SP_REVIVE_GRACE), timeout=60)
    t0 = time.perf_counter()
    c.revive_osd(victim)
    t_ready = time.perf_counter() - t0
    try:
        c.wait_for_clean(timeout=240)
    except TimeoutError:
        procs_state(c, f"the wait after osd.{victim}'s revive")
        raise
    t_revive = time.perf_counter() - t0
    t_after = read_all("read after the revive")
    out.update({"reread_s": t_reread, "deep_scrub_s": t_scrub,
                "shards_scrubbed": checked, "revive_ready_s": t_ready,
                "revive_clean_s": t_revive, "read_after_revive_s": t_after})
    log(f"  every byte read again exact in {t_reread:.3f} s; deep scrub "
        f"of {SA_PGS} PGs clean ({checked} shards) in {t_scrub:.3f} s; "
        f"osd.{victim} revived at a {SP_REVIVE_GRACE} s grace over its "
        f"TinStore (WAL remount): ready in "
        f"{t_ready:.3f} s, clean in {t_revive:.3f} s, every byte read "
        f"exact again in {t_after:.3f} s")
    out["workload"] = workload_run(c)
    counts += [h.launches() for h in c.osds.values() if not h._stop.is_set()]
    out["false_down_marks_before_kill"] = sorted({
        osd for _t, osd in marks[:n_marks]})
    return out, counts


def child_launches(counts: list) -> tuple:
    """The children's launch counts summed: gf_apply's total and by (k,
    m, L, vec), the checksum kernels' by name, the CRC kernel's by
    shape."""
    total, shapes = 0, collections.Counter()
    csum, crc_shapes = collections.Counter(), collections.Counter()
    for n in counts:
        total += n["gf_apply"]["launches"]
        for key, k in n["gf_apply"]["by_shape"].items():
            shapes[tuple(int(x) for x in key.split(","))] += k
        csum.update(n["csum"]["launches"])
        crc_shapes.update(n["csum"]["shapes"])
    return total, shapes, csum, crc_shapes


def procs_path(torch, dev) -> tuple:
    """Phase 15's cluster of OSD processes, (a) to (d): boot at the
    twin's default grace (the next of SP_GRACES after a boot that
    storms), the run and the workload engine. Returns its numbers and
    every child's launch counts."""
    import shutil
    import tempfile

    from ceph_tpu_torch.osd import standalone as S

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.zeros(1, device=dev).sum().item()
    log(f"  host: os.cpu_count() {os.cpu_count()}, "
        f"sched_getaffinity {len(os.sched_getaffinity(0))} cores")
    # the monitors live in this process: every down+out they commit
    # passes through the cluster's log as (time, "osd.N")
    import re
    marks: list = []
    cluster_log = S.StandaloneCluster.log

    def counted(self, msg: str) -> None:
        hit = re.search(r"marking (osd\.\d+) down\+out", msg)
        if hit:
            marks.append((time.perf_counter(), hit.group(1)))
        cluster_log(self, msg)
    S.StandaloneCluster.log = counted
    root = tempfile.mkdtemp(prefix="phase15-")
    c = None
    try:
        boots = []
        for grace in SP_GRACES:
            c, boot, faults = procs_boot(torch, dev, S, os.path.join(
                root, f"grace-{grace}"), grace, marks)
            boots.append(boot)
            if not faults:
                break
            log(f"  the boot at a {grace} s grace storms: {faults}")
            if c is not None:
                c.shutdown()
                c = None
            marks.clear()
        if c is None:
            fail(f"phase 15: every heartbeat grace of {SP_GRACES} storms")
        out, counts = procs_run(torch, dev, c, marks, boot["grace_s"])
        out["boots"] = boots
        log("  phase 16's live ceph commands over this cluster's admin "
            "sockets, before its shutdown:")
        out["live_cli"] = live_cli(c.admin_dir)
        return out, counts
    finally:
        if c is not None:
            c.shutdown()
        S.StandaloneCluster.log = cluster_log
        shutil.rmtree(root, ignore_errors=True)


def thrash_path(dev) -> dict:
    """The seeded thrasher in this process (MemStores, cephx, AES-GCM,
    socket-failure and delay injection): seed 42, one round of five ops.
    Its profile is the JAX package's default less `impl=bitlinear`, which
    in the port names the torch-ops apply, not gf_apply; the profile
    draws nothing, so the schedule is the seed's."""
    import hashlib

    from ceph_tpu_torch.chaos import Thrasher
    th = Thrasher(THRASH["seed"], rounds=THRASH["rounds"], ops=THRASH["ops"],
                  profile="plugin=tpu_rs k=2 m=1", **entry_device(dev))
    t0 = time.perf_counter()
    report = th.run()        # InvariantViolation fails the phase
    lines = [line for line in th.schedule if not line.startswith("parked")]
    sha = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    parked = len(th.schedule) - len(lines)
    log(f"  thrasher seed {th.seed}: invariants held in "
        f"{time.perf_counter() - t0:.2f} s, {report['objects_verified']} "
        f"objects verified, {parked} ops parked; schedule sha256 {sha} "
        f"({len(lines)} lines)")
    return {"seconds": time.perf_counter() - t0, "schedule_sha256": sha,
            "schedule_lines": len(lines), "parked": parked,
            "objects_verified": report["objects_verified"],
            "unknown_fate": report["unknown_fate"]}


def tier_path(torch, dev) -> dict:
    """The writeback cache tier over SimClusters on the card: an RS
    k=8 m=3 base of 12 OSDs and a replicated size=2 cache of 4
    (tools/ceph_cli.py's cmd_tier), 64 seeded 4 MiB objects through it
    at a 64 MiB target, so the agent flushes and evicts; every read
    exact through the tier and from the base after flush_evict_all."""
    import numpy as np

    from ceph_tpu_torch.ops import gf_kernel as G
    from ceph_tpu_torch.osd.cachetier import CacheTier
    from ceph_tpu_torch.osd.cluster import SimCluster

    base = SimCluster(n_osds=SA_OSDS, pg_num=8, profile=PROFILE,
                      chunk_size=OBJECT_SIZE // K, **entry_device(dev))
    cache = SimCluster(n_osds=4, pg_num=2, profile="replicated size=2",
                       **entry_device(dev))
    tier = CacheTier(base, cache, target_max_bytes=TIER_TARGET,
                     dirty_ratio=0.4, full_ratio=0.8)
    flushes = []             # (objects, gf_apply encodes) each base write
    base_write = base.write

    def flush_write(objects) -> None:
        n0 = G.apply_matrix_gf.launches
        base_write(objects)
        flushes.append((len(objects), G.apply_matrix_gf.launches - n0))
    base.write = flush_write
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 151)
    names = [f"tier_{i:03d}" for i in range(TIER_OBJECTS)]
    rows = torch.randint(0, 256, (TIER_OBJECTS, OBJECT_SIZE),
                         dtype=torch.uint8, device=dev,
                         generator=gen).cpu().numpy()

    def check(label: str, read) -> float:
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            if not np.array_equal(np.asarray(read(name)), rows[i]):
                fail(f"phase 15: cache tier {label}: {name} differs")
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(0, TIER_OBJECTS, TIER_GROUP):
        tier.write({names[j]: rows[j] for j in range(i, i + TIER_GROUP)})
    t_write = time.perf_counter() - t0
    mid = tier.stats()
    t_read = check("read", tier.read)
    t0 = time.perf_counter()
    tier.flush_evict_all()
    t_drain = time.perf_counter() - t0
    t_base = check("base read after flush_evict_all", base.read)
    stats = tier.stats()
    encodes = sum(n for _objs, n in flushes)
    if not flushes or encodes == 0 or mid["tier_evict"] == 0 \
            or stats["objects"] != 0:
        fail(f"phase 15: cache tier flushes {flushes}, stats {mid} then "
             f"{stats}")
    out = {"write_s": t_write, "read_s": t_read, "drain_s": t_drain,
           "base_read_s": t_base, "flushes": flushes,
           "encodes_per_flush": encodes / len(flushes),
           "stats_after_writes": mid, "stats_after_drain": stats}
    log(f"  cache tier: {TIER_OBJECTS} x {OBJECT_SIZE >> 20} MiB through "
        f"a {TIER_TARGET >> 20} MiB writeback tier in {t_write:.3f} s "
        f"({mid['tier_flush']} flushed, {mid['tier_evict']} evicted), read "
        f"exact in {t_read:.3f} s, drained in {t_drain:.3f} s, read exact "
        f"from the base in {t_base:.3f} s; {len(flushes)} base writes, "
        f"(objects, gf_apply encodes) each {flushes}")
    return out


def runtime_path(torch, dev) -> dict:
    """The EC runtime server behind the native shim: NativeReedSolomon
    k=8 m=3 encodes RT_BATCH x 8 x 512 KiB and decodes shards 0 and 9
    through the server on the card; the bytes must be the shim's own CPU
    codec's, and the server must have served them with gf_apply (the
    shim falls back to the CPU in C whenever the socket fails, so only
    the counts show the card did the work)."""
    import shutil
    import tempfile

    import numpy as np

    from ceph_tpu_torch import native
    from ceph_tpu_torch.native.server import ECRuntimeServer
    from ceph_tpu_torch.ops import gf_kernel as G

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 152)
    L = OBJECT_SIZE // K
    data = torch.randint(0, 256, (RT_BATCH, K, L), dtype=torch.uint8,
                         device=dev, generator=gen).cpu().numpy()
    coder = native.NativeReedSolomon({"k": str(K), "m": str(M)},
                                     device="cpu")
    lost = list(LOST)
    root = tempfile.mkdtemp(prefix="ec-rt-")
    path = os.path.join(root, "ec.sock")
    n0, s0 = gf_counts(G)
    srv = ECRuntimeServer(path, **entry_device(dev)).start()
    try:
        native.set_runtime_socket(path)
        try:
            if not native.runtime_ping():
                fail("phase 15: the runtime server answered no ping")
            t0 = time.perf_counter()
            parity = np.asarray(coder.encode_chunks(data))
            t_enc = time.perf_counter() - t0
            full = np.concatenate([data, parity], axis=1)
            t0 = time.perf_counter()
            rec = coder.decode_chunks(lost, {i: full[:, i]
                                             for i in range(K + M)
                                             if i not in lost})
            t_dec = time.perf_counter() - t0
        finally:
            native.set_runtime_socket(None)
        served, errors = srv.requests_handled, srv.errors
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    n1, s1 = gf_counts(G)
    t0 = time.perf_counter()
    host = np.asarray(coder.encode_chunks(data))
    t_host = time.perf_counter() - t0
    if not np.array_equal(parity, host) or any(
            not np.array_equal(np.asarray(rec[i]), full[:, i])
            for i in lost):
        fail("phase 15: the runtime server's bytes are not the CPU codec's")
    shapes = s1 - s0
    encodes = sum(n for (k, m, LL, _v), n in shapes.items()
                  if (k, m, LL) == (K, M, L))
    decodes = sum(n for (k, m, LL, _v), n in shapes.items()
                  if k == K and m == len(lost) and LL == L)
    if served < 3 or errors or encodes == 0 or decodes == 0:
        fail(f"phase 15: the runtime server served {served} requests "
             f"({errors} errors) with gf_apply launches "
             f"{json.dumps(by_shape(shapes))}")
    gb = RT_BATCH * K * L / 1e9
    log(f"  runtime server: {served} requests through the native shim, "
        f"encode {gb / t_enc:.3f} GB/s and decode {t_dec * 1e3:.1f} ms "
        f"over the socket (the CPU codec's encode {gb / t_host:.3f} GB/s), "
        f"bytes the CPU codec's; gf_apply {n1 - n0} launches "
        f"{json.dumps(by_shape(shapes))}")
    return {"requests_handled": served, "encode_gbps": gb / t_enc,
            "decode_s": t_dec, "host_encode_gbps": gb / t_host,
            "gf_apply_launches": n1 - n0}


def procs_phase(torch, dev) -> tuple:
    """Phase 15 with its launch counts set to 0 before and read after:
    the children's own (their `launches` answers; a child's counts start
    at 0 when it is spawned) and this process's (the thrasher, the cache
    tier, the runtime server). Fails unless the children launched
    gf_apply encodes, the 4 KiB delta and decodes, and CRC32C."""
    from ceph_tpu_torch.ops import gf_kernel as G
    t0 = time.perf_counter()
    gf_set(G)
    csum_set()
    out, counts = procs_path(torch, dev)
    n, shapes, csum, child_crc = child_launches(counts)
    encodes = sum(k for (kk, m, _L, _v), k in shapes.items()
                  if kk == K and m == M)
    deltas = sum(k for (kk, m, L, _v), k in shapes.items()
                 if kk < K and m == M and L == RBD_BLOCK)
    if encodes == 0 or deltas == 0 or decode_launches(shapes) == 0 \
            or csum["crc32c"] == 0:
        fail(f"phase 15: the children launched gf_apply {n} times: "
             f"encodes {encodes}, of the 4 KiB delta shape {deltas}, "
             f"decodes {decode_launches(shapes)}; CRC32C {csum['crc32c']}")
    out.update({"children_gf_apply_launches": n,
                "children_gf_apply_encode_launches": encodes,
                "children_gf_apply_delta_4k_launches": deltas,
                "children_gf_apply_decode_launches": decode_launches(shapes),
                "children_gf_apply_by_shape": by_shape(shapes),
                "children_crc32c_launches": csum["crc32c"]})
    log(f"  the children's launches: gf_apply {n} (encodes {encodes}, 4 "
        f"KiB deltas {deltas}, decodes {decode_launches(shapes)}), by "
        f"(k,m,L,vec) {json.dumps(by_shape(shapes))}; CRC32C "
        f"{csum['crc32c']}")
    out["thrasher"] = thrash_path(dev)
    out["cache_tier"] = tier_path(torch, dev)
    out["runtime_server"] = runtime_path(torch, dev)
    own, own_shapes = gf_counts(G)
    launches = n + own
    all_shapes = shapes + own_shapes
    crc = csum["crc32c"] + csum_counts()["crc32c"]
    CRC_BY_SHAPE["phase 15"] = dict(sorted(
        (child_crc + crc_shapes()).items(), key=lambda kv: -kv[1]))
    out.update({"gf_apply_launches": launches,
                "gf_apply_by_shape": by_shape(all_shapes),
                "crc32c_launches": crc,
                "phase_s": time.perf_counter() - t0})
    log(f"  gf_apply launches in phase 15: {launches} ({n} in the "
        f"children), by (k,m,L,vec): {json.dumps(by_shape(all_shapes))}; "
        f"crc32c {crc}")
    log(f"  phase 15 wall time {out['phase_s']:.1f} s; {card_line()}")
    return out, launches, all_shapes, crc


# ------------------------------------------------------------ phase 16

class ToolRun:
    """The port's operator tools as a user runs them: each call is the
    tool's `main(argv)` in this process (so the kernels' launch counts
    count here) with its stdout captured; the host seconds of the calls
    are summed by tool. A non-zero exit fails the phase."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.calls = collections.Counter()

    def __call__(self, name: str, argv: list) -> str:
        import importlib
        import io
        mod = importlib.import_module(f"ceph_tpu_torch.tools.{name}")
        argv = [str(a) for a in argv]
        out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8",
                               write_through=True)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                code = mod.main(argv) or 0
        except SystemExit as e:
            code = 0 if e.code is None else e.code
        self.seconds[name] += time.perf_counter() - t0
        self.calls[name] += 1
        text = out.buffer.getvalue().decode(errors="replace")
        if code != 0:
            fail(f"phase 16: {name} {' '.join(argv)} exited {code!r}: "
                 f"{text[-2000:]}")
        return text


def module_env(root: Path) -> dict:
    """The environment of a `python -m ceph_tpu_torch...` child: this
    checkout first on its path."""
    path = [str(root)] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path))


def start_oracle() -> dict:
    """crushtool --oracle over the first TOOLS_ORACLE_X inputs of
    TOOLS_CRUSH (host code: `python -m` a slice on the CPU), for phase
    16 to hold its card mappings to. The full run starts it with phase
    10, whose host work is one thread, so that it is done by phase 16;
    phase 16 alone starts it first."""
    root = Path(__file__).resolve().parent
    step = -(-TOOLS_ORACLE_X // TOOLS_ORACLE_PROCS)
    oracle = {"procs": [], "t0": time.perf_counter()}
    try:
        for lo in range(0, TOOLS_ORACLE_X, step):
            hi = min(lo + step, TOOLS_ORACLE_X)
            oracle["procs"].append(subprocess.Popen(
                [sys.executable, "-m", "ceph_tpu_torch.tools.crushtool",
                 "--device", "cpu", *TOOLS_CRUSH, "--min-x", str(lo),
                 "--max-x", str(hi), "--show-mappings", str(hi - lo),
                 "--no-show-statistics", "--oracle"],
                cwd=root, env=module_env(root), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    except BaseException:
        stop_procs(oracle["procs"])
        raise
    return oracle


def start_module_run(tmp: Path) -> tuple:
    """One `python -X importtime -m ceph_tpu_torch.tools.rados_cli` put
    on the card, beside the rest of phase 16; returns the child and the
    object it puts."""
    import numpy as np
    root = Path(__file__).resolve().parent
    payload = np.random.default_rng(SEED + 162).integers(
        0, 256, OBJECT_SIZE, np.uint8).tobytes()
    (tmp / "sub.in").write_bytes(payload)
    child = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "ceph_tpu_torch.tools.rados_cli", "--state", str(tmp / "sub.st"),
         "put", "sub", str(tmp / "sub.in")],
        cwd=root, env=module_env(root), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return child, payload


def stop_procs(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def check_background(run, oracle: dict, child, payload: bytes,
                     sample: list, tmp: Path) -> dict:
    """The oracle's mappings must be the card's `sample`; the `python
    -m` put must exit 0 having imported no jax* and no ceph_tpu*
    module, and its object must read back exact in this process."""
    lines = []
    for p in oracle["procs"]:
        out, err = p.communicate(timeout=900)
        if p.returncode != 0:
            fail(f"phase 16: crushtool --oracle exited {p.returncode}: "
                 f"{err[-2000:]}")
        lines += out.splitlines()
    oracle_s = time.perf_counter() - oracle["t0"]
    if lines != sample:
        bad = next((i for i, (a, b) in enumerate(zip(lines, sample))
                    if a != b), min(len(lines), len(sample)))
        fail(f"phase 16: crushtool's mapping {bad} is not the oracle's "
             f"({len(sample)} and {len(lines)} lines): "
             f"{sample[bad:bad + 1]} vs {lines[bad:bad + 1]}")
    out, err = child.communicate(timeout=600)
    loaded = [line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
              if line.startswith("import time:")]
    bad = sorted({m for m in loaded if m == "jax" or m.startswith(
        ("jax.", "jaxlib", "ceph_tpu.")) or m == "ceph_tpu"})
    if child.returncode != 0 or bad or not loaded:
        fail(f"phase 16: python -m ceph_tpu_torch.tools.rados_cli exited "
             f"{child.returncode}, loaded {bad}: {err[-1500:]}")
    run("rados_cli", ["--state", tmp / "sub.st", "get", "sub",
                      tmp / "sub.out"])
    if (tmp / "sub.out").read_bytes() != payload:
        fail("phase 16: the object the `python -m` rados put reads back "
             "different")
    log(f"  crushtool --oracle: {len(lines)} inputs the card's "
        f"({len(oracle['procs'])} processes, {oracle_s:.1f} s from their "
        f"start to this check); `python -m ceph_tpu_torch.tools.rados_cli "
        f"put` loaded {len(loaded)} modules, none of JAX; its object "
        f"read back exact")
    return {"oracle_inputs": len(lines), "oracle_to_check_s": oracle_s,
            "module_run_imports": len(loaded)}


def crush_tools(run, tmp: Path) -> tuple:
    """crushtool's own 10,000-OSD example on the card (100,000 inputs
    of the EC rule at 11 replicas, two OSDs out), then the first
    TOOLS_ORACLE_X inputs again (the oracle's sample, held in
    check_background), then the same map through -o, -d and -c, which
    must give the same bytes. Returns its numbers and the sample."""
    text = run("crushtool", TOOLS_CRUSH + ["--max-x", TOOLS_CRUSH_X,
                                           "--show-mappings", 5])
    stats = dict(line.split(": ", 1) for line in text.splitlines()
                 if not line.startswith("CRUSH rule"))
    if int(stats["inputs"]) != TOOLS_CRUSH_X \
            or float(stats["fill"]) < 0.999:
        fail(f"phase 16: crushtool --test: {stats}")
    sample = run("crushtool", TOOLS_CRUSH + [
        "--max-x", TOOLS_ORACLE_X, "--show-mappings", TOOLS_ORACLE_X,
        "--no-show-statistics"]).splitlines()
    build = TOOLS_CRUSH[:3]
    run("crushtool", build + ["-o", tmp / "crush.bin"])
    run("crushtool", ["-d", tmp / "crush.bin", "-o", tmp / "crush.txt"])
    run("crushtool", ["-c", tmp / "crush.txt", "-o", tmp / "crush2.bin"])
    if (tmp / "crush.bin").read_bytes() != (tmp / "crush2.bin").read_bytes():
        fail("phase 16: crushtool -c of -d's text is not the map")
    log(f"  crushtool: {TOOLS_CRUSH_X} inputs at "
        f"{stats['mappings_per_s']} mappings/s, fill {stats['fill']}; "
        f"-o/-d/-c give the map's {(tmp / 'crush.bin').stat().st_size} "
        f"bytes again")
    return {"inputs": TOOLS_CRUSH_X, "fill": float(stats["fill"]),
            "mappings_per_s": float(stats["mappings_per_s"]),
            "map_bytes": (tmp / "crush.bin").stat().st_size}, sample


def osdmap_tools(run, tmp: Path) -> dict:
    """osdmaptool at 10,000 OSDs and a 65,536-PG pool of size 3:
    --createsimple, --test-map-pgs, then --upmap --upmap-mode batch with
    --save (a scorer launch a round); the saved map prints its upmaps.
    The card's upmap file must be the plain (CPU) path's from one map,
    made by --createsimple at TOOLS_OSDMAP_PLAIN."""
    import re
    import shutil

    from ceph_tpu_torch.mgr import placement as P
    big = tmp / "osdmap.bin"
    run("osdmaptool", [big] + TOOLS_OSDMAP)
    text = run("osdmaptool", [big, "--test-map-pgs"]).splitlines()
    if text[-1] != " size 3: fill 1.0000" or \
            len(text) != int(TOOLS_OSDMAP[1]) + 4:
        fail(f"phase 16: osdmaptool --test-map-pgs: {text[:2]} {text[-2:]}")
    n0 = P.launches
    t0 = time.perf_counter()
    out = run("osdmaptool", [big, "--upmap", tmp / "up.txt",
                             "--upmap-mode", "batch", "--save"])
    upmap_s = time.perf_counter() - t0
    rounds = int(re.search(r"balancer: (\d+) round", out).group(1))
    moves = int(re.search(r"(\d+) upmap move", out).group(1))
    if not rounds or P.launches - n0 != rounds or not moves:
        fail(f"phase 16: osdmaptool --upmap: {P.launches - n0} scorer "
             f"launches, {out}")
    up = (tmp / "up.txt").read_text().splitlines()
    printed = [line for line in run("osdmaptool", [big, "--print"])
               .splitlines() if line.startswith("pg_upmap_items")]
    if len(printed) != len(up):
        fail(f"phase 16: the saved map holds {len(printed)} upmap items, "
             f"the upmap file {len(up)}")
    small = tmp / "small.bin"
    run("osdmaptool", [small] + TOOLS_OSDMAP_PLAIN)
    shutil.copy(small, tmp / "small_cpu.bin")
    run("osdmaptool", [small, "--upmap", tmp / "small.txt"])
    n1 = P.launches
    run("osdmaptool", [tmp / "small_cpu.bin", "--upmap",
                       tmp / "small_cpu.txt", "--device", "cpu"])
    if P.launches != n1:
        fail("phase 16: osdmaptool --device cpu launched the scorer")
    if (tmp / "small.txt").read_bytes() != \
            (tmp / "small_cpu.txt").read_bytes():
        fail("phase 16: the card's upmap file is not the plain path's")
    log(f"  osdmaptool: {TOOLS_OSDMAP[1]} OSDs, {TOOLS_OSDMAP[3]} PGs; "
        f"batch upmap {upmap_s:.2f} s, {rounds} round(s), {moves} moves "
        f"({out.splitlines()[0]}); the plain path's upmap file at "
        f"{TOOLS_OSDMAP_PLAIN[1]} OSDs is the card's "
        f"({len((tmp / 'small.txt').read_text().splitlines())} PGs)")
    return {"upmap_s": upmap_s, "rounds": rounds, "moves": moves,
            "upmap_pgs": len(up)}


def rados_tools(run, tmp: Path, rng) -> dict:
    """rados put, ls, stat, get and rm of TOOLS_RADOS_OBJECTS x 4 MiB
    over one state file (every call restores the cluster from it: a
    fused write on the card); every get exact."""
    import numpy as np
    st = tmp / "rados.st"
    objs = {f"obj-{i:02d}": rng.integers(0, 256, OBJECT_SIZE,
                                         np.uint8).tobytes()
            for i in range(TOOLS_RADOS_OBJECTS)}
    for name, data in objs.items():
        (tmp / f"{name}.in").write_bytes(data)
        run("rados_cli", ["--state", st, "put", name, tmp / f"{name}.in"])
    if run("rados_cli", ["--state", st, "ls"]).split() != sorted(objs):
        fail("phase 16: rados ls does not list the objects put")
    name = next(iter(objs))
    if run("rados_cli", ["--state", st, "stat", name]) != \
            f"{name} mtime n/a, size {OBJECT_SIZE}\n":
        fail("phase 16: rados stat")
    for name, data in objs.items():
        run("rados_cli", ["--state", st, "get", name, tmp / f"{name}.out"])
        if (tmp / f"{name}.out").read_bytes() != data:
            fail(f"phase 16: rados get {name} differs from its put")
    run("rados_cli", ["--state", st, "rm", *objs])
    if run("rados_cli", ["--state", st, "ls"]) != "":
        fail("phase 16: rados rm left objects")
    log(f"  rados: {len(objs)} x {OBJECT_SIZE >> 20} MiB put, listed, "
        f"read back exact, removed")
    return {"objects": len(objs)}


def rbd_tools(run, tmp: Path, rng) -> dict:
    """rbd over one state file: a 256 MiB image, a 64 MiB disk imported,
    a protected snapshot, a clone, its flattening, exports and diffs;
    every export is the host model's bytes (the disk, or zeros)."""
    import numpy as np
    st = ["--state", tmp / "rbd.st"]
    disk = rng.integers(0, 256, TOOLS_RBD_IMPORT, np.uint8).tobytes()
    (tmp / "disk.raw").write_bytes(disk)
    for argv in (["create", "big", "--size", TOOLS_RBD_IMAGE],
                 ["import", tmp / "disk.raw", "vm"],
                 ["snap", "create", "vm@gold"],
                 ["snap", "protect", "vm@gold"],
                 ["clone", "vm@gold", "kid"],
                 ["export", "kid", tmp / "clone.raw"],
                 ["flatten", "kid"],
                 ["export", "kid", tmp / "kid.raw"],
                 ["export", "big", tmp / "big.raw"]):
        run("rbd_cli", st + argv)
    for f in ("clone.raw", "kid.raw"):
        if (tmp / f).read_bytes() != disk:
            fail(f"phase 16: rbd export {f} is not the imported disk")
    from ceph_tpu_torch.tools.rbd_cli import parse_size
    big = (tmp / "big.raw").read_bytes()
    if len(big) != parse_size(TOOLS_RBD_IMAGE) or big.count(0) != len(big):
        fail("phase 16: rbd export of the fresh image is not zeros")
    full = run("rbd_cli", st + ["diff", "kid"]).split()
    since = run("rbd_cli", st + ["diff", "vm", "--from-snap", "gold"])
    if sum(int(n) for n in full[1::2]) != len(disk) or since != "":
        fail(f"phase 16: rbd diff: {full[:6]} / {since[:200]!r}")
    children = run("rbd_cli", st + ["children", "vm@gold"])
    if children != "":
        fail(f"phase 16: the flattened clone is still a child: {children}")
    log(f"  rbd: {TOOLS_RBD_IMAGE} image, {len(disk) >> 20} MiB imported, "
        f"snap, protect, clone, flatten; exports and diffs the host "
        f"model's")
    return {"image": TOOLS_RBD_IMAGE, "imported_bytes": len(disk)}


def store_tools(run, tmp: Path, dev) -> dict:
    """ceph-objectstore-tool: demo (a degraded PG exported, its reads
    rebuilt, imported into a k=8 m=3 cluster) and inspect of its file;
    then kv-dump and fsck of every TinStore of phase 11's cluster shape
    (48 OSDs, 64 PGs of RS k=8 m=3) after 16 x 4 MiB written."""
    import re

    import numpy as np

    from ceph_tpu_torch.osd.cluster import SimCluster
    text = run("objectstore_tool", ["demo", "--file", tmp / "pg.export"])
    hit = re.search(r"verified (\d+)/(\d+) objects", text)
    if not hit or hit.group(1) != hit.group(2):
        fail(f"phase 16: objectstore_tool demo: {text}")
    listed = run("objectstore_tool", ["inspect", tmp / "pg.export"])
    if len(listed.splitlines()) != int(hit.group(2)) + 1:
        fail(f"phase 16: objectstore_tool inspect: {listed[:300]}")
    c = SimCluster(n_osds=CLUSTER_OSDS, osds_per_host=CLUSTER_PER_HOST,
                   pg_num=CLUSTER_PGS, profile=PROFILE,
                   chunk_size=OBJECT_SIZE // K, store="tin",
                   store_dir=str(tmp / "osds"), **entry_device(dev))
    rng = np.random.default_rng(SEED + 161)
    c.write({f"s{i:02d}": rng.integers(0, 256, OBJECT_SIZE, np.uint8)
             for i in range(TOOLS_STORE_OBJECTS)})
    for st in c.cluster.stores.values():
        st.umount()
    shards = 0
    dirs = sorted((tmp / "osds").iterdir())
    for d in dirs:
        rep = json.loads(run("objectstore_tool", ["fsck", d]))
        shards += rep["objects"]
    run("objectstore_tool", ["kv-dump", dirs[0]])
    if shards != TOOLS_STORE_OBJECTS * (K + M):
        fail(f"phase 16: fsck found {shards} shards in {len(dirs)} stores")
    log(f"  objectstore_tool: demo {hit.group(0)}; fsck clean over "
        f"{len(dirs)} TinStores holding {shards} shards")
    return {"demo_objects": int(hit.group(2)), "fsck_stores": len(dirs),
            "fsck_shards": shards}


def cli_tools(run) -> dict:
    """The ceph CLI's hermetic scenario at phase 7's cluster (48 OSDs,
    64 PGs): status, df, pg stat, balancer and the cache tier."""
    texts = {" ".join(cmd): run("ceph_cli", TOOLS_CLI + cmd)
             for cmd in (["status"], ["df"], ["pg", "stat"], ["balancer"],
                         ["tier"])}
    if "HEALTH_OK" not in texts["status"] or \
            f"osd: {CLUSTER_OSDS} osds" not in texts["status"] or \
            len(texts["pg stat"].splitlines()) != CLUSTER_PGS or \
            "bit-exact from base" not in texts["tier"]:
        fail(f"phase 16: ceph: {json.dumps(texts)[:2000]}")
    log(f"  ceph: status, df, pg stat, balancer "
        f"({texts['balancer'].strip()}) and tier at {CLUSTER_OSDS} OSDs")
    return {"balancer": texts["balancer"].strip()}


def live_cli(asok_dir: str) -> dict:
    """The ceph CLI's live mode against a running cluster's admin
    sockets: each of TOOLS_LIVE must answer."""
    run = ToolRun()
    texts = {" ".join(cmd): run("ceph_cli", ["--asok-dir", asok_dir] + cmd)
             for cmd in TOOLS_LIVE}
    if not all(t.strip() for t in texts.values()) or \
            " osds: " not in texts["status"]:
        fail(f"phase 16: ceph --asok-dir: {json.dumps(texts)[:2000]}")
    osd_line = next(line.strip() for line in texts["status"].splitlines()
                    if " osds: " in line)
    log(f"  ceph --asok-dir: {', '.join(texts)} answered "
        f"({run.seconds['ceph_cli']:.2f} s); {osd_line}")
    return {"answer_bytes": {cmd: len(t) for cmd, t in texts.items()},
            "seconds": run.seconds["ceph_cli"]}


def live_cluster(torch, dev) -> dict:
    """For phase 16 alone: a StandaloneCluster of 8 OSDs on the card
    (the CPU tests' size), a few objects written, every PG clean, then
    live_cli over its admin sockets."""
    from ceph_tpu_torch.osd.standalone import StandaloneCluster
    torch.zeros(1, device=dev).sum().item()
    c = StandaloneCluster(n_osds=8, pg_num=8, chunk_size=4096,
                          hb_grace=SA_GRACE, **entry_device(dev))
    try:
        c.client().write({f"live-{i}": bytes([i]) * 40_000
                          for i in range(16)})
        c.wait_for_clean(120)
        return live_cli(c.admin_dir)
    finally:
        c.shutdown()


def thrash_tool(run) -> dict:
    """The thrash reproducer at TOOLS_THRASH: invariants held and the
    schedule, less "parked" lines, the twin's (TOOLS_THRASH_SHA)."""
    import hashlib
    text = run("thrash", TOOLS_THRASH)
    tag = "thrash[42]: "
    sched = [line[len(tag):] for line in text.splitlines()
             if line.startswith(tag)]
    keep = [line for line in sched if not line.startswith("parked")]
    sha = hashlib.sha256("\n".join(keep).encode()).hexdigest()
    report = json.loads(text.splitlines()[-1])
    if not report["ok"] or sha != TOOLS_THRASH_SHA:
        fail(f"phase 16: thrash schedule sha256 {sha}, not the twin's "
             f"{TOOLS_THRASH_SHA}: {sched}; {report}")
    log(f"  thrash: invariants held, schedule sha256 {sha[:8]}... the "
        f"twin's ({len(keep)} lines, {len(sched) - len(keep)} parked)")
    return {"schedule_sha256": sha, "parked": len(sched) - len(keep),
            "objects_verified": report["objects_verified"]}


def tools_phase(torch, dev, live: dict | None = None,
                oracle: dict | None = None) -> tuple:
    """Phase 16: the port's operator tools on the card, each through its
    `main(argv)` with no --device (the card, as a user runs it), with
    gf_apply's, the checksum kernels' and the scorer's counts set to 0
    before and read after. `live` is live_cli's result over phase 15's
    cluster and `oracle` start_oracle's children; without them (phase 16
    alone) a cluster is booted and the oracle started here. Fails unless
    gf_apply, CRC32C and the scorer launched."""
    import shutil
    import tempfile

    import numpy as np

    from ceph_tpu_torch.mgr import placement as P
    from ceph_tpu_torch.ops import gf_kernel as G
    t0 = time.perf_counter()
    gf_set(G)
    csum_set()
    P.launches = 0
    run = ToolRun()
    rng = np.random.default_rng(SEED + 16)
    oracle = oracle or start_oracle()
    tmp = Path(tempfile.mkdtemp(prefix="phase16-"))
    child = None
    try:
        child, payload = start_module_run(tmp)
        crush, sample = crush_tools(run, tmp)
        out = {"crushtool": crush,
               "osdmaptool": osdmap_tools(run, tmp),
               "rados": rados_tools(run, tmp, rng),
               "rbd": rbd_tools(run, tmp, rng),
               "objectstore_tool": store_tools(run, tmp, dev),
               "ceph": cli_tools(run),
               "thrash": thrash_tool(run)}
        out["background"] = check_background(run, oracle, child, payload,
                                             sample, tmp)
    finally:
        stop_procs(oracle["procs"] + ([child] if child else []))
        shutil.rmtree(tmp, ignore_errors=True)
    launches, shapes = gf_counts(G)
    crc = crc_launches("phase 16")
    score = P.launches
    if launches == 0 or score == 0:
        fail(f"phase 16: gf_apply launched {launches} times, the scorer "
             f"{score}")
    if live is None:
        live = live_cluster(torch, dev)
    out["ceph_live"] = live
    seconds = {name: run.seconds[name] for name in sorted(run.seconds)}
    seconds["ceph_cli --asok-dir"] = live["seconds"]
    out.update({"tool_seconds": seconds, "tool_calls": dict(run.calls),
                "gf_apply_launches": launches,
                "gf_apply_by_shape": by_shape(shapes),
                "crc32c_launches": crc, "score_launches": score,
                "phase_s": time.perf_counter() - t0})
    log(f"  phase 16 seconds by tool (host clock): {json.dumps(seconds)}; "
        f"gf_apply {launches}, by (k,m,L,vec) {json.dumps(by_shape(shapes))}"
        f"; CRC32C {crc}; scorer {score}")
    log(f"  phase 16 wall time {out['phase_s']:.1f} s; {card_line()}")
    return out, launches, shapes, crc, score


def build_all() -> Path:
    """Phase 1: build every kernel source, one nvcc each, and the native
    host library (g++, always anew: a library copied in from another
    machine is never loaded), all started together; print each one's
    build time and return the native library's path."""
    from concurrent.futures import ThreadPoolExecutor

    from ceph_tpu_torch import native
    from ceph_tpu_torch.csum import kernels as C
    from ceph_tpu_torch.mgr import placement as P
    from ceph_tpu_torch.ops import fold_kernel as F
    from ceph_tpu_torch.ops import gf_kernel as G

    def timed(build):
        t0 = time.perf_counter()
        path = Path(build())
        return path, time.perf_counter() - t0
    with ThreadPoolExecutor(5) as pool:
        jobs = {"gf_apply.cu": pool.submit(timed, G.build),
                "csum.cu": pool.submit(timed, C.build),
                "xor_fold.cu": pool.submit(timed, F.build),
                "placement.cu": pool.submit(timed, P.build),
                "native/ec_tpu.cpp": pool.submit(
                    timed, lambda: native.build(force=True))}
        paths = {}
        for name, job in jobs.items():
            try:
                paths[name], secs = job.result()
            except Exception as e:  # noqa: BLE001 — any failed build fails
                fail(f"phase 1: building {name} failed: {e}")
            log(f"phase 1: built {name} in {secs:.1f} s "
                f"({paths[name].name})")
    return paths["native/ec_tpu.cpp"]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    root = Path(__file__).resolve().parent
    if not (root / "ceph_tpu_torch" / "__init__.py").is_file():
        fail(f"ceph_tpu_torch/ not found beside {Path(__file__).name}: "
             f"run from a checkout of the repository")
    sys.path.insert(0, str(root))
    from ceph_tpu_torch.ops import gf_kernel as G

    dev = torch.device("cuda")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    if sys.argv[1:] == ["--crc-times"]:
        from ceph_tpu_torch.csum import kernels as C
        t0 = time.perf_counter()
        C.build()
        log(f"phase 1: built csum.cu in {time.perf_counter() - t0:.1f} s")
        rows = csum_table(torch, dev, plain=False, only_crc=True)
        micro = crc_microbench(torch, dev)
        log(card_line())
        log(json.dumps({"crc_times": rows, "microbench": micro}))
        return
    if sys.argv[1:] == ["--gf-times"]:
        t0 = time.perf_counter()
        G.build()
        log(f"phase 1: built gf_apply.cu in {time.perf_counter() - t0:.1f} s")
        rows, _ = gf_table(torch, dev, plain=False)
        log(card_line())
        log(json.dumps({"gf_times": rows}))
        return
    if sys.argv[1:] == ["--fold-times"]:
        from ceph_tpu_torch.ops import fold_kernel as F
        t0 = time.perf_counter()
        F.build()
        log(f"phase 1: built xor_fold.cu in {time.perf_counter() - t0:.1f} s")
        rows = fold_table(torch, dev)
        log(card_line())
        log(json.dumps({"fold_times": rows}))
        return
    if sys.argv[1:2] == ["--score-times"] and len(sys.argv) <= 3:
        parent = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else None
        if parent is not None and not parent.is_file():
            fail(f"--score-times: no file {parent}")
        rows = score_times(torch, dev, parent)
        log(card_line())
        log(json.dumps({"score_times": rows}))
        return
    if sys.argv[1:] == ["--client"]:
        from concurrent.futures import ThreadPoolExecutor

        from ceph_tpu_torch.csum import kernels as C
        with ThreadPoolExecutor(2) as pool:
            for job in [pool.submit(G.build), pool.submit(C.build)]:
                job.result()
        log("phase 12: the client tier over the card's EC pool")
        client = client_phase(torch, dev)[0]
        log(card_line())
        log(json.dumps({"client": client}))
        return
    if sys.argv[1:] == ["--mesh"]:
        t0 = time.perf_counter()
        G.build()
        log(f"phase 1: built gf_apply.cu in {time.perf_counter() - t0:.1f} s")
        log("phase 13: the (dp, shard) mesh on the cards")
        mesh = mesh_phase(torch)
        log(card_line())
        log(json.dumps({"mesh": mesh}))
        return
    if sys.argv[1:] == ["--standalone"]:
        from concurrent.futures import ThreadPoolExecutor

        from ceph_tpu_torch import native
        from ceph_tpu_torch.csum import kernels as C
        with ThreadPoolExecutor(3) as pool:
            for job in [pool.submit(G.build), pool.submit(C.build),
                        pool.submit(native.build, True)]:
                job.result()
        log("phase 14: the wire tier's daemons over the card's EC backend")
        standalone = standalone_phase(torch, dev)[0]
        log(card_line())
        log(json.dumps({"standalone": standalone}))
        return
    if sys.argv[1:] == ["--osd-procs"]:
        from concurrent.futures import ThreadPoolExecutor

        from ceph_tpu_torch import native
        from ceph_tpu_torch.csum import kernels as C
        with ThreadPoolExecutor(3) as pool:
            for job in [pool.submit(G.build), pool.submit(C.build),
                        pool.submit(native.build, True)]:
                job.result()
        log("phase 15: one process an OSD on the card, the thrasher, the "
            "workload engine, the cache tier and the runtime server")
        procs = procs_phase(torch, dev)[0]
        log(card_line())
        log(json.dumps({"osd_procs": procs}))
        return
    if sys.argv[1:] == ["--tools"]:
        build_all()
        log("phase 16: the operator tools on the card")
        tools = tools_phase(torch, dev)[0]
        log(card_line())
        log(json.dumps({"tools": tools}))
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: none, --gf-times, "
             f"--crc-times, --fold-times, --score-times "
             f"[PARENT_PLACEMENT_CU], "
             f"--client, --mesh, --standalone, --osd-procs or --tools")
    # each phase's seconds, phase 1's from here on
    seconds: dict = {}
    started = ["1", time.perf_counter()]
    # each phase's XOR fold launches in this process
    from ceph_tpu_torch.ops import fold_kernel as F
    folds: dict = {}

    def close_phase() -> None:
        seconds[started[0]] = time.perf_counter() - started[1]
        folds[started[0]] = F.xor_fold.launches
        F.xor_fold.launches = 0

    def lap(name: str, msg: str) -> None:
        """Close the running phase's seconds and open phase `name`."""
        close_phase()
        started[:] = [name, time.perf_counter()]
        log(msg)

    native_lib = build_all()

    lap("2", "phase 2: kernels against their plain versions")
    gf_check = check_gf_kernel(torch, dev)
    csum_check = check_csum_kernels(torch, dev)
    score_check = check_score_kernel(torch, dev)

    lap("3", "phase 3: main path")
    gf_set(G)
    csum_set()
    ctx = main_path(torch, dev)
    launches, shapes3 = gf_counts(G)
    log(f"  gf_apply launches on the main path: {launches}, by "
        f"(k,m,L,vec): {json.dumps(by_shape(shapes3))}")
    if launches == 0:
        fail("the main path never launched gf_apply")
    crc3 = crc_launches("phase 3")
    fold3 = F.xor_fold.launches
    log(f"  xor_fold launches on the main path: {fold3} in "
        f"{N_OBJECTS // BATCH} calls of the recovery program")
    if fold3 != N_OBJECTS // BATCH:
        fail(f"the main path launched the XOR fold kernel {fold3} times "
             f"in {N_OBJECTS // BATCH} calls of the recovery program")

    lap("4", "phase 4: times")
    times = measure(torch, dev, ctx)
    enc = times["encode"]

    lap("5", "phase 5: the PG backend path")
    gf_set(G)
    csum_set()
    backend = backend_path(torch, dev)
    launches5 = backend["gf_apply_launches"]
    crc5 = backend["crc32c_launches"]
    log("backend " + json.dumps(backend))

    lap("6", "phase 6: CRUSH placement at BASELINE config #5")
    placement = placement_path(torch, dev)
    log("placement " + json.dumps(placement))

    lap("7", "phase 7: the cluster's failure -> remap -> recovery path")
    gf_set(G)
    csum_set()
    cluster = cluster_path(torch, dev)
    launches7, shapes7 = gf_counts(G)
    log(f"  gf_apply launches in phase 7: {launches7}, by (k,m,L,vec): "
        f"{json.dumps(by_shape(shapes7))}")
    if launches7 == 0:
        fail("the cluster path never launched gf_apply")
    crc7 = crc_launches("phase 7")
    log("cluster " + json.dumps(cluster))

    lap("8", "phase 8: BASELINE configs #3 (LRC) and #4 (Clay), and SHEC, "
        "through the PG backend")
    gf_set(G)
    csum_set()
    t0 = time.perf_counter()
    codecs = codecs_path(torch, dev)
    launches8, shapes8 = gf_counts(G)
    log(f"  gf_apply launches in phase 8: {launches8} "
        f"({time.perf_counter() - t0:.1f} s), by (k,m,L,vec): "
        f"{json.dumps(by_shape(shapes8))}")
    if launches8 == 0:
        fail("the codec paths never launched gf_apply")
    crc8 = crc_launches("phase 8")
    log("codecs " + json.dumps(codecs))

    lap("9", "phase 9: BlueStore block checksums and streaming")
    gf_set(G)
    csum_set()
    t0 = time.perf_counter()
    bluestore = bluestore_path(torch, dev)
    launches9 = bluestore["gf_apply_launches"]
    by9 = bluestore["launches"]
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    log("bluestore " + json.dumps(bluestore))

    lap("10", "phase 10: the upmap balancer at 10k OSDs / 1M PGs")
    # phase 16's crushtool --oracle, on host cores phase 10 leaves idle
    oracle = start_oracle()
    atexit.register(stop_procs, oracle["procs"])
    t0 = time.perf_counter()
    balancer = balancer_path(torch, dev)
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    log("balancer " + json.dumps(balancer))

    lap("11", "phase 11: the failure path over persistent TinStores")
    gf_set(G)
    csum_set()
    t0 = time.perf_counter()
    store = store_path(torch, dev, native_lib)
    launches11, shapes11 = gf_counts(G)
    log(f"  gf_apply launches in phase 11: {launches11} "
        f"({time.perf_counter() - t0:.1f} s), by (k,m,L,vec): "
        f"{json.dumps(by_shape(shapes11))}")
    if launches11 == 0:
        fail("the TinStore cluster path never launched gf_apply")
    crc11 = crc_launches("phase 11")
    log("store " + json.dumps(store))

    lap("12", "phase 12: the client tier over the card's EC pool")
    client, launches12, shapes12, crc12 = client_phase(torch, dev)
    log("client " + json.dumps(client))

    lap("13", "phase 13: the (dp, shard) mesh on the cards")
    mesh = mesh_phase(torch)
    launches13 = mesh["launches"]
    log("mesh " + json.dumps({key: mesh[key] for key in
                              ("world", "seconds", "launches", "by_shape")}))

    lap("14", "phase 14: the wire tier's daemons over the card's EC backend")
    standalone, launches14, shapes14, crc14 = standalone_phase(torch, dev)
    log("standalone " + json.dumps(standalone))

    lap("15", "phase 15: one process an OSD on the card, the thrasher, the "
        "workload engine, the cache tier and the runtime server")
    procs, launches15, shapes15, crc15 = procs_phase(torch, dev)
    log("osd_procs " + json.dumps(procs))

    lap("16", "phase 16: the operator tools on the card")
    tools, launches16, shapes16, crc16, score16 = tools_phase(
        torch, dev, live=procs["live_cli"], oracle=oracle)
    log("tools " + json.dumps(tools))
    close_phase()
    log(f"seconds by phase: {json.dumps(seconds)} (sum "
        f"{sum(seconds.values()):.1f} s)")
    kernels = [{
        "name": "gf_apply",
        "route": "cuda",
        "source": "ceph_tpu_torch/ops/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:103",
        "launches": launches + launches5 + launches7 + launches8
        + launches9 + launches11 + launches12 + launches13
        + launches14 + launches15 + launches16,
        "launches_by_phase": {"3": launches, "5": launches5,
                              "7": launches7, "8": launches8,
                              "9": launches9, "11": launches11,
                              "12": launches12, "13": launches13,
                              "14": launches14, "15": launches15,
                              "16": launches16},
        "launches_by_shape": {"3": by_shape(shapes3),
                              "5": backend["gf_apply_by_shape"],
                              "7": by_shape(shapes7),
                              "8": by_shape(shapes8),
                              "11": by_shape(shapes11),
                              "12": by_shape(shapes12),
                              "13": mesh["by_shape"],
                              "14": by_shape(shapes14),
                              "15": by_shape(shapes15),
                              "16": by_shape(shapes16)},
        "max_abs_err": gf_check["max_abs_err"],
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None,
        "shape": enc["shape"],
        "decode": times["decode"],
        "ragged": times["ragged"],
        **{key: times[key] for key in ("rebuild_b1", "rebuild_b32",
                                       "delta_4k", "delta_64k",
                                       "lrc_global", "lrc_repair",
                                       "clay_encode", "clay_repair",
                                       "clay_decode", "shec_encode")},
    }]
    csum = times["csum"]
    crc_phases = {"3": crc3, "5": crc5, "7": crc7, "8": crc8,
                  "9": by9["crc32c"], "11": crc11, "12": crc12,
                  "14": crc14, "15": crc15, "16": crc16}
    for name, replaces, main_row, by_phase, extra in (
            ("crc32c", "ceph_tpu/csum/kernels.py:113", "crc32c_256x512KiB",
             crc_phases, tuple(k for k in csum if k.startswith("crc32c")
                               and k != "crc32c_256x512KiB")),
            ("xxh32", "ceph_tpu/csum/kernels.py:245", "xxh32_262144x4KiB",
             {"9": by9["xxh32"]}, ()),
            ("xxh64", "ceph_tpu/csum/kernels.py:400", "xxh64_262144x4KiB",
             {"9": by9["xxh64"]}, ())):
        row = csum[main_row]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ceph_tpu_torch/csum/csrc/csum.cu",
            "replaces": replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": csum_check["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"],
            "device_ms": row["device_ms"],
            "device_ms_from": row["device_ms_from"],
            "host_us": row["host_us"], **{key: csum[key] for key in extra}})
        if name == "crc32c":
            kernels[-1]["launches_by_shape"] = {
                label.split()[-1]: shapes
                for label, shapes in CRC_BY_SHAPE.items()}
    row = balancer["kernel"]
    kernels.append({
        "name": "score_candidates", "route": "cuda",
        "source": "ceph_tpu_torch/mgr/csrc/placement.cu",
        "replaces": "ceph_tpu/mgr/placement.py:107",
        "launches": balancer["launches"] + score16,
        "launches_by_phase": {"10": balancer["launches"], "16": score16},
        "max_abs_err": score_check["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "shape": row["shape"],
        "device_ms": row["device_ms"],
        "device_ms_from": row["device_ms_from"],
        "mean_visits": row["mean_visits"]})
    # phase 4's launches are its own timing calls, not a served path's;
    # phases 12-16 fold in their own processes, which this one does not
    # count
    fold_by_phase = {name: n for name, n in folds.items()
                     if n and name != "4"}
    log(f"  xor_fold launches by phase (4 left out): "
        f"{json.dumps(fold_by_phase)}")
    row = times["fold"][FOLD_ROWS[0][0]]
    kernels.append({
        "name": "xor_fold", "route": "cuda",
        "source": "ceph_tpu_torch/ops/csrc/xor_fold.cu",
        "replaces": "ceph_tpu/osd/ecbackend.py:2045",
        "launches": sum(fold_by_phase.values()),
        "launches_by_phase": fold_by_phase,
        "max_abs_err": times["fold"]["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "shape": row["shape"],
        "device_ms": row["device_ms"],
        "device_ms_from": row["device_ms_from"],
        "host_us": row["host_us"],
        **{label: times["fold"][label]
           for label, _ in FOLD_ROWS[1:] + (FOLD_RAGGED,)}})
    log("e2e " + json.dumps(times["e2e"]))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
