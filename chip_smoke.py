#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``summerset_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); with no card it exits non-zero
before printing any result.  Phases, each printed as it runs:

1. build   — compile ``summerset_tpu_torch/csrc/bitslice.cu`` from the
             checkout (``nvcc``, sm_90a) and the native WAL
             ``csrc/wal.cpp`` (``g++``), in parallel, and print the build
             times.
2. kernel  — the GF(2^8) kernel against its plain PyTorch version on the
             card, bit for bit, for the RS(3,2), RS(2,1), RS(5,3) and
             RS(6,4) parity tables, the ten 3-of-5 decode tables and one
             6-of-10 RS(6,4) decode table, at 1024 values of 4 KiB,
             single values of 4 KiB..4 MiB and an odd lane count; kernel
             time (CUDA events) beside its bound.
3. multipaxos — the engine at the bench shape (4096 groups x 5, W=128,
             P=32) for a window of ticks: commits must advance, and the
             first 64 groups must equal a CPU run of the port at G=64;
             then a short ``torch.profiler`` window: device busy time,
             idle share, kernels per tick and device time per phase.
4. rspaxos — RSPaxos at 1024 groups x 5 with RS(3,2) (the main path the
             kernel serves): the engine window, the same CPU check, then
             the codeword plane: every leader's last-tick values encoded
             in one batched kernel call, decoded from rotating 3-of-5
             shard subsets, and a few values through ``CodewordStore``.
             Kernel launch counts are read over this phase only.  The
             same profile window follows.
5. raft    — Raft at the BASELINE shape (4096 groups x 5, W=128, P=32)
             from a cold start with the default 30-60 tick election
             timers: warm up until every group has exactly one leader,
             then a timed window (ms/tick, committed slots/s), the CPU
             check of the first 64 groups and the profile window.
6. craft   — CRaft 1024 x 5, fault_tolerance=1, RS(3,2): a healthy window
             whose last tick's coded values are encoded in one batched
             kernel call and decoded from rotating 3-of-5 subsets; two
             followers of every group paused past alive_timeout (new
             slots must be stamped full-copy and still commit); the
             followers resumed (new slots coded again); CPU check; profile.
7. crossword — Crossword 1024 x 5, fault_tolerance=1, T=5 (RS(3,2)),
             adaptive assignment, with spr_override=2 for the odd groups
             in its second window: the last tick's values are encoded in
             one batched call, each replica keeps only its assigned shard
             rows at the value's width, and each value is rebuilt from a
             rotating replica set whose rows cover d shards; a few values
             go through CodewordStore; CPU check; profile.
8. quorumleases — QuorumLeases 4096 x 5, W=128, P=32: responders {1, 2}
             installed through the log (``conf_target``); every replica's
             ``conf_cur``, leases held on replicas 1 and 2 only, leader
             reads on replica 0 only; then replica 2 paused: the leader's
             commit bar moves at most 2P in 8 ticks and rises again once
             the lease and its margin have lapsed; CPU check; profile.
9. bodega  — Bodega 4096 x 5: a roster (leader 0, responders {1, 2}) is
             announced through ``conf_init`` and installed everywhere with
             config leases out and replica 0 a stable leader; with writes
             drained, responders 1 and 2 serve local reads; bucket 3 moves
             to {3, 4}; replica 0 paused past ``conf_timeout``: a
             higher-ballot conf names a new leader and commits go on; CPU
             check; profile.
10. basic  — ChainRep, SimplePush and RepNothing 4096 x 5 through
             ``run_synthetic``: commits in every group, ChainRep's tail acks
             back at the head, CPU check, one timing line each.
11. epaxos — EPaxos at 1024 groups x 5 (``BASELINE.json:11``), W=128,
             P=32, 8 key buckets, default timeouts: (a) the device-exec
             path, 8 warm-up ticks then a timed window of 64: every row's
             ``cmt_row`` and ``exec_row`` advance at every replica, and
             committed instances agree across replicas (val/seq/noop/deps,
             checked on the card); (b) replica 0 paused past
             ``alive_timeout``: every survivor commits row 0 up to the
             survivors' max ``ext_row``, rows 1-4 keep committing, row-0
             instances committed before the pause keep their values; (c)
             the host-exec path (``exec_follows_commit=False``) at 64
             groups, with rotating ``prop_replica``, ``prop_vids`` minted
             per bucket as ``host/server.py`` mints them, and one port
             ``EPaxosExecutor`` per (group, replica) feeding
             ``exec_floor_rows``: per-bucket apply orders agree across
             replicas and ``exec_row`` follows the floors; (d) the first 64
             groups of (a)+(b), and all of (c), equal a CPU run; (e) the
             profile window and the phase's peak device memory.
12. serving — the port's serving path, at the JAX serving records' shape
             (1024 groups x 3 replicas, W=64, tick 0.002 s): the port's
             manager and three ``ServerReplica`` threads in this process
             on the card (the harness of ``tests/test_torch_cluster.py``),
             16 closed-loop clients over 1024 keys.  MultiPaxos: a 6 s
             timed window (one ``serving`` JSON line: ops/s, p50/p99,
             ticks/s per replica, the mean of each ``loop_stage_us``
             stage, ``max_memory_allocated``, the leader's bytes per
             payload), the group-0 leader paused until
             every client succeeds at a new leader (at least 3 s), a
             durable reset of a follower and then of the leader, every
             acknowledged key read back; then, with the clients stopped,
             every replica's applied floors and KV equal each other and
             every key's last acknowledged put, and a 3-client, 3-key
             history recorded through the faults passes the port's
             ``check_history``; a replica that failed a bring-up or
             crashed at any point fails the phase (durable resets are
             neither).  Then a ``take_snapshot`` through the manager
             (seconds; every replica's WAL bytes before and after, each
             must shrink), every replica restarted from snapshot plus WAL
             tail (seconds) and every acked key read back (the
             ``snapshot`` record of the JSON line).  After MultiPaxos's
             window, 8 ticks of the group-0
             leader are recorded and, once the cluster has stopped,
             replayed alone under ``torch.profiler`` (uploads, step,
             prefetch): device busy ms, kernels and host CUDA runtime ms
             per tick (one ``serving_profile`` JSON line).  Raft: 4 s of
             load, one leader pause, the same agreement, history and fault
             checks.  Last, 24 sequential puts on a 1-replica cluster on
             the card and on the CPU, serial and pipelined: equal durable
             digests, KV, floors and WAL records.
13. codeword serving — phase 12's harness and shape serving the codeword
             family, RS(2,1) (``fault_tolerance=0``), puts of 3000 B
             values: the leader encodes each proposed batch with
             ``bitslice_gf256`` and ships each peer its shard, followers
             rebuild from shards.  First MultiPaxos at the same load, 4 s,
             for the full-copy baseline.  RSPaxos: a
             6 s window, the leader paused (the new leader rebuilds
             adopted values from shards), a durable reset of a follower
             and then of the leader, every acked key read back,
             agreement, a linearizable 3-client history, then phase 12's
             snapshot and restart of every replica: values come back by
             rebuilding from shards, whose launches are counted (and must
             be some) and join the ``kernels`` line.  CRaft: 4 s, the
             leader paused until the new leader ships full copies, then
             shards again after the resume (both kinds counted).
             Crossword, adaptive width: 4 s and a leader pause, the widths
             chosen logged.  The RSPaxos leader's bytes per payload below
             0.75x the MultiPaxos baseline's, and the wire sizes of one
             shard send and one full copy at phase 12's values and at
             3000 B (the finding at small values); three RSPaxos replicas
             on the card against three on the CPU in per-tick lockstep
             through a leader change; the kernel's time per launch at the
             serving encode and decode shapes beside its bound and the
             plain version; peak device memory and each replica's
             codeword store at the end.
14. lease serving — phase 12's harness and shape serving the lease planes
             to 16 read-mostly clients (95% gets, 5% puts: YCSB workload
             B) pinned to the three replicas in turn, so followers take
             gets.  QuorumLeases: responders {0, 1, 2} installed by a
             client ``conf_change`` at the leader (timed), a 6 s window,
             a leader pause.  MultiPaxos with ``leader_leases``: 4 s.
             Bodega (the JAX cluster config, lease_len 40): a roster conf
             announced at a non-leader (timed), 5 s.  Per protocol one
             ``lease_serving`` JSON line: ops/s, the share of gets
             answered locally per replica, p50/p99 of local and of logged
             gets, peak device memory, failover.  Checks: every acked key
             read back, agreement, a linearizable 3-client history (the
             clients pinned to the replicas) holding local reads, local
             gets at followers (QuorumLeases, Bodega) or at the leader
             only (leader leases), no replica fault; then three
             QuorumLeases replicas on the card against three on the CPU
             in per-tick lockstep through the conf change and the first
             local gets (replies compared with their ``local`` flags).
15. process cluster — phase 12's MultiPaxos cluster as one process per
             replica: ``python -m summerset_tpu_torch.cli.manager`` and
             three ``python -m summerset_tpu_torch.cli.server ... --device
             cuda`` on the one card, 16 closed-loop clients over the
             manager's address for a 6 s window (ops/s, p50/p99 beside
             phase 12's), every acked key read back, then the processes
             stopped and their WALs' apply records equal slot by slot.  A
             process that dies or never logs readiness fails the phase;
             every process is killed on every exit path.
16. bench — ``python -m summerset_tpu_torch.bench`` at 256-tick windows
             (4096 groups x 5, W=128, P=32): one JSON line with ``ok``
             true, the backend ``cuda`` and this card's stamp.
17. epaxos serving — phase 12's harness and shape serving EPaxos
             (leaderless; a host Tarjan executor per group): 16 clients
             pinned to the three replicas in turn, puts on their own keys
             and gets on every key, so commands at different replicas
             conflict; a 10 s window (the ``serving`` line with the
             ``ep_exec`` stage, the executors' Tarjan pass), 8 ticks of
             replica 0 replayed under the profiler (kernels per tick,
             device ms), a burst of 4 puts to distinct key buckets of one
             group proposed in one tick, then with the load stopped (as
             the JAX ``TestClusterEPaxos``) a durable reset of replica 1,
             every acked key read back, agreement, a linearizable
             history of 3 pinned clients on 2 keys, phase 12's snapshot
             and restart; then three replicas on the card against three
             on the CPU in per-tick lockstep at 32 groups through a
             durable reset, serial and pipelined.
18. basic serving — phase 12's harness and shape serving ChainRep,
             SimplePush and RepNothing: a 4 s window each, a durable
             reset of the serving node under load, every acked key read
             back, agreement (RepNothing replicates nothing: its serving
             replica's KV alone) and a linearizable 3-client history.
19. read tier and wire — phase 12's harness and shape, the wire codec on
             (the default) and the native WAL: MultiPaxos with
             ``near_quorum_reads``, 16 clients pinned to the two followers
             (10% puts) for a 4 s window (local-read share, get p50/p99,
             ops/s), a writer streaming unique values to one key and a
             reader at each follower (a linearizable history), two
             barrier scans at the leader over a span of acked keys (each
             returns every acked key of the span), a learner subscribed at
             the leader whose snapshot plus notes equal the leader's KV at
             the end (note seqs rising by one); RSPaxos RS(2,1) with 3000 B
             puts and a barrier scan, whose markers launch
             ``bitslice_gf256`` (counted, and the kernel held against its
             plain version at the marker's shape); an EPaxos scan answered
             ``error``; QuorumLeases with responders {0, 1, 2}: one probe
             per group at every responder answers ``success``; a mixed
             mesh (replica 0 with the codec off) where a codec client and
             a pickle client read back each other's writes, the codec
             replicas meter bytes saved, and the p2p tick frame's size in
             both formats.  Seconds and peak device memory.
20. planes — the observability and control planes at phase 12's shape,
             the servers' default planes on.  MultiPaxos: (a) phase 12's
             load for 4 s, then ``metrics_dump``, ``flight_dump`` and
             ``watch_series`` through the manager with the port's client
             functions (seconds and bytes each): every replica's device
             lanes, the leader's committed counts at least the acked ops,
             ``wal_fsync_us`` and ``loop_stage_us`` not empty, every
             sampled slot trace committed no later than applied, the
             flight rings' drop accounting, and each replica's watch
             frames summing to its counters at its newest frame
             (lossless); (d) 16 clients on a Zipf-skewed put/get mix
             (seeded numpy draws over the 1024 keys): an ``observe``
             autopilot sends no ctrl mutation, an ``act`` one splits the
             hot key off its group within its budget and the range
             change installs (decisions and their ticks printed); (b) a
             slow WAL injected at the leader (``inject_faults``) under 4
             of the clients: it self-indicts and demotes once (a flight
             ``demote`` event), every group elects another leader
             (seconds; ops/s before, during, after), no second demotion
             after the heal, every acked key read back.  RSPaxos RS(2,1)
             at 3000 B puts: (c) a key split to another group with a
             writer's puts in flight, then merged back, each installed
             at all three replicas (seconds; sheds), ``route_group``
             equal everywhere, every acked key read back, then a
             snapshot and a restart of one follower with the ranges
             standing; the adopt's encode and rebuilds launch
             ``bitslice_gf256`` (counted; the kernel held against its
             plain version at the adopt's shape).
Every served replica of phases 12-14 and 17-20 must have opened the native
WAL, and a phase with no injected fault fails on any demoted leader
21. nemesis and workload planes — (a) the device plane: seed 11's
             ``FaultPlan`` over crash, device_reset, pause, partition,
             isolate, one_way, drop and clock_skew, compiled on the card
             for G (``compile_device``) and run through
             ``Engine.run_ticks`` on RSPaxos 1024 x 5 (phase 4's shape)
             and MultiPaxos 4096 x 5 (phase 3's) for 160 ticks, then a
             200-tick heal: agreement, commits in every group, a
             commit-bar spread of at most 4P after the heal, the first 64
             groups equal to a CPU run given the card's masks sliced to
             them (ms/tick under faults and in the heal); RSPaxos's heal
             values encoded and rebuilt through ``bitslice_gf256``
             (counted, held against the plain version).  (b) the host
             plane on a live RSPaxos cluster at phase 12's shape: the
             first seed whose 120-tick plan (the soak's horizon) over
             crash, partition, pause, drop, wal_torn, take_snapshot and
             clock_skew holds a crash-armed snapshot, a clock skew, a
             crash and a partition, played through
             ``nemesis_soak.soak`` (``NemesisRunner`` under 3 recorded
             clients, then ``heal_all``): a put acked within 20 s, more
             than 20 ops, no crash but the injected ones (their errors
             say "injected"), the soak's WAL and window bounds, no failed
             action, every acked key read back into a linearizable
             history.  (c) the workload
             plane on the same cluster: a ``hot_burst`` plan through
             ``start_workload_clients`` for 6 s against an 8-deep ingress
             queue: sheds on the scrape and a linearizable history (shed
             puts as negative acks); accepted ops/s and p99.
Every served replica of phases 12-14 and 17-20 must have opened the native
WAL, and a phase with no injected fault fails on any demoted leader
(phases 12-19 each log ``leader_demotions``).  Phases 4, 6, 7, 13, 19,
20 and 21 each count their own kernel launches and fail on none; phases
8-12 and 14-18 run no codeword plane and launch no hand kernel.

The last lines are a ``{"phase_seconds": {...}, "total_s": ...}`` line
(each phase's seconds), a JSON object ``{"kernels": [...]}`` and the
card's ``nvidia-smi`` name and power limit, then ``{"ok": true,
"device": ...}``.  Any mismatch or exception exits non-zero.
"""

import itertools
import json
import os
import subprocess
import sys
import time

SEED = 20261016
MP_SHAPE = dict(G=4096, R=5, W=128, P=32)
RS_SHAPE = dict(G=1024, R=5, W=128, P=32)
RAFT_SHAPE = dict(G=4096, R=5, W=128, P=32)
CRAFT_SHAPE = dict(G=1024, R=5, W=128, P=32)
CW_SHAPE = dict(G=1024, R=5, W=128, P=32)
QL_SHAPE = dict(G=4096, R=5, W=128, P=32)
BO_SHAPE = dict(G=4096, R=5, W=128, P=32)
BASIC_SHAPE = dict(G=4096, R=5, W=128, P=32)
EP_SHAPE = dict(G=1024, R=5, W=128, P=32, K=8)
EP_PAUSE_TICKS = 150     # replica 0 paused: past alive_timeout to recovery
EP_HOST_GROUPS = 64      # the host-exec part (a Python executor per replica)
EP_HOST_TICKS = 40
EP_HOST_DRAIN = 8        # last host-exec ticks propose nothing
QL_RESP = 0b00110        # QuorumLeases responders {1, 2}
QL_RELEASE_TICKS = 60    # responder 2 paused: ticks until the barrier lifts
BO_RESP = 0b00110        # Bodega roster responders {1, 2} on every bucket
BO_RESP3 = 0b11000       # ... then {3, 4} on bucket 3
BO_FAILOVER_TICKS = 200  # replica 0 paused: past conf_timeout to a new leader
TIMED_TICKS = 64         # the timed window of phases 8-10
CPU_GROUPS = 64
MP_TICKS = 64
RS_TICKS = 48
RAFT_TICKS = 64
ELECT_STEP = 10          # ticks between leader counts in the cold start
ELECT_MAX = 400          # cold-start ticks allowed until one leader/group
PROFILE_TICKS = 8
PAYLOAD = 4096
# phase 12: the serving records' shape (1024 groups x 3, W=64 as
# summerset_tpu/cli/server.py:33, tick 0.002 s as :34), 16 clients
SERVE_SHAPE = dict(G=1024, R=3, W=64, tick=0.002, keys=1024)
SERVE_CLIENTS = 16
# the timed windows of phases 12-15 (once 10 s / 5 s, then 6 s) are short enough
# that the script, phases 17-18 included, stays well inside its time
# limit; their shapes are unchanged
SERVE_SECS = 4.0          # MultiPaxos timed load window
READ_BACK_CHUNK = 8       # keys per read-back reader thread
SERVE_RAFT_SECS = 4.0     # Raft timed load window
SERVE_PAUSE_S = 3.0       # a paused leader stays paused at least this
SERVE_FAILOVER_MAX_S = 30.0
SERVE_OP_TIMEOUT = 1.0
# a load client's per-op budget stretches to this many ticks of the
# cluster's fastest live replica when that is longer than its fixed
# budget: the card machine's host speed swings about 2x between calls,
# and at 2.5 ticks/s a codeword put needs about 2 s
OP_BUDGET_TICKS = 8
SERVE_HISTORY_OPS = 30    # the 3-client history is at least this long
# phase 13: the codeword family at phase 12's shape, RS(2,1), puts of
# the value size of the JAX package's shard-economy check
# (tests/test_codeword_plane.py, TestClusterCodewordPlane: "x" * 3000)
SERVE_CW_CFG = {"fault_tolerance": 0}
SERVE_CW_VALUE_BYTES = 3000
SERVE_CW_SECS = 4.0       # CRaft and Crossword timed load windows
SERVE_RESUME_MAX_S = 30.0  # after a resume, shard sends must resume by then
# phase 14: the lease planes at phase 12's shape, read-mostly (YCSB
# workload B: 95% reads, 5% updates), clients pinned to the replicas in
# turn; Bodega with the JAX cluster config (tests/test_cluster.py:871)
SERVE_LEASE_PUT_SHARE = 0.05
SERVE_LEASE_SECS = {"QuorumLeases": 6.0, "MultiPaxos": 4.0, "Bodega": 5.0}
SERVE_BODEGA_CFG = {"lease_len": 40, "lease_margin": 8, "grant_interval": 4,
                    "conf_timeout": 80}
LEASE_HISTORY_PUT_SHARE = 0.1  # the history clients' puts (3 keys)
# a logged op at 1024 groups takes ~5 ticks, and the lease planes tick at
# 3.6-6.2/s on an H100 at this shape: a 1 s budget timed out every Bodega put
SERVE_LEASE_OP_TIMEOUT = 5.0
# phase 17: EPaxos served at phase 12's shape, a 10 s window (with 6 s
# the snapshot's WAL-shrink check failed once: a replica wrote 7.8 MB in
# the run and compacted to 8.1 MB); the card-against-CPU lockstep's
# groups
SERVE_EP_SECS = 10.0
EP_SERVE_LOCK_GROUPS = 32
# phase 18: the basic kernels' timed windows (once 5 s)
SERVE_BASIC_SECS = 4.0
# phase 19: the read tier's timed window, its scan span (about 136 of the
# 1024 load keys, over most groups) and the RSPaxos scans' puts
SERVE_READ_SECS = 4.0
READ_SPAN = ("key1", "key2")
READ_CW_PUTS = 16
READ_OP_TIMEOUT = 5.0
# phase 15: one process per replica; readiness within this many seconds
PROC_READY_S = 240.0
# phase 16: the bench entry point's window at chip_smoke time
BENCH_SMOKE_ENV = {"BENCH_TICKS": "256", "BENCH_RUNS": "3"}
#: the card every phase runs on (a rehearsal on the CPU may override it)
DEV = "cuda"
#: config every ``_serve_run`` cluster starts from (empty: the servers'
#: defaults, every observability and control plane on); ``planes_ab``
#: sets PLANES_OFF here for its planes-off runs
SERVE_BASE_CFG = {}
PLANES_OFF = {"flight_record": 0, "health_enabled": 0, "graftwatch": 0,
              "trace_sample": 0}
# phase 20 (the observability and control planes)
PLANES_SECS = 4.0          # (a): phase 12's load before the scrapes
PLANES_SLOW_WAL = {"slow": 6.0, "slow_floor": 0.01}
PLANES_FAILOVER_MAX_S = 60.0
#: (b) runs under 4 of the 16 clients: the slow WAL stalls every append
#: 50 ms (the fault's floor), so a tick costs 50 ms per record, and
#: 16 clients' records would slow the leader's tick, and with it its
#: health evaluations (every 10 of its own ticks), past the followers'
#: election timers, turning the fail-slow leader into a fail-stop one
PLANES_DEMOTE_CLIENTS = 4
PLANES_HEAL_S = 4.0        # after the heal: no second demotion
PLANES_ZIPF = 1.1          # (d): the hot-key mix's Zipf exponent
PLANES_AP_SCRAPE_S = 1.5
PLANES_AP_ROUNDS = 4       # observe-mode rounds
PLANES_AP_MAX_S = 45.0     # act mode: the reshard installs by then
PLANES_CUT_MAX_S = 60.0    # (c): seal to install
# phase 21: the nemesis and workload planes
NEM_DEVICE_SEED = 11
NEM_DEVICE_TICKS = 160
NEM_HEAL_TICKS = 200
NEM_DEVICE_CLASSES = ("crash", "device_reset", "pause", "partition",
                      "isolate", "one_way", "drop", "clock_skew")
NEM_HOST_CLASSES = ("crash", "partition", "pause", "drop", "wal_torn",
                    "take_snapshot", "clock_skew")
NEM_HOST_TICKS = 120       # (b): the soak's horizon in nemesis ticks
NEM_TICK_LEN = 0.25        # wall seconds per nemesis tick
NEM_CLIENTS = 3
NEM_KEYS = ("nem0", "nem1", "nem2")
NEM_RECOVERY_MAX_S = 20.0
NEM_MIN_OPS = 20
# a small ingress queue, so (c)'s burst sheds visibly
NEM_HOST_CFG = {"fault_tolerance": 0, "api_max_batch": 4,
                "api_max_pending": 8}
WL_SEED = 3
WL_SECS = 6.0              # (c): the hot_burst plan's wall window
WL_CAP = 60.0              # (c): offered ops/s at rate_x 1.0

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 3.35 TB/s;
# int32 ALU rate = 132 SMs x 64 INT32 lanes x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# ------------------------------------------------------------- kernel math --
def bitslice_work(rows, cols, B, L):
    """(bytes, int32 ops) the GF product must move and do: each input word
    read once, each output word written once; per lane and (c, i) one
    shift and one mask, per row one multiply and one XOR."""
    nbytes = 4 * (B * cols * L + B * rows * L + rows * cols * 8)
    ops = B * L * cols * 8 * (2 + 2 * rows)
    return nbytes, ops


def bound_ms(rows, cols, B, L):
    nbytes, ops = bitslice_work(rows, cols, B, L)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def lanes_for(nbytes, d):
    """Lane count of one value at the kernel geometry (128-lane multiple),
    as ``pack_bytes(..., lane_multiple=128)`` gives it."""
    shard = -(-nbytes // d)
    return -(-shard // 512) * 128


def pack_batch(np, payloads, d, lanes):
    """[B, n] uint8 payloads -> [B, d, lanes] int32, each row exactly what
    ``pack_bytes(payload, d, lane_multiple=128)`` gives."""
    B, n = payloads.shape
    buf = np.zeros((B, d * lanes * 4), np.uint8)
    buf[:, :n] = payloads
    return buf.view("<i4").reshape(B, d, lanes).astype(np.int32)


# ---------------------------------------------------------- engine helpers --
def make_engine(proto, cfg, sh, G, device):
    from summerset_tpu_torch.core import Engine
    from summerset_tpu_torch.protocols import make_protocol

    k = make_protocol(proto, G, sh["R"], sh["W"], cfg, device=device)
    return Engine(k, device=device)


def drive(torch, eng, ticks, P):
    """A window of saturating synthetic load: ``run_synthetic`` for all but
    the last tick, then one ``tick`` so its effects can be read."""
    G, R = eng.kernel.G, eng.kernel.R
    state, ns = eng.init()
    state, ns = eng.run_synthetic(state, ns, ticks - 1, P)
    dev = eng.device
    state, ns, fx = eng.tick(state, ns, {
        "n_proposals": torch.full((G,), P, dtype=torch.int32, device=dev),
        "value_base": torch.full((G,), (ticks - 1) * P, dtype=torch.int32,
                                 device=dev),
        "exec_floor": torch.full((G, R), 1 << 30, dtype=torch.int32,
                                 device=dev),
    })
    return state, ns, fx


def compare_groups(torch, card, cpu, n, what):
    """The first ``n`` groups of a card run equal a CPU run of ``n``
    groups, leaf for leaf (state and netstate)."""
    st_c, ns_c = card
    st_h, ns_h = cpu
    if sorted(st_c) != sorted(st_h):
        fail(f"{what}: state leaves differ")
    for k in st_c:
        a = st_c[k][:n].cpu()
        if a.dtype != st_h[k].dtype or not torch.equal(a, st_h[k]):
            fail(f"{what}: state leaf {k!r} differs between card and CPU")
    for k in ("rng", "last_due"):
        if not torch.equal(ns_c[k][:n].cpu(), ns_h[k]):
            fail(f"{what}: netstate {k!r} differs")
    for k in ("cursor", "tick"):
        if int(ns_c[k]) != int(ns_h[k]):
            fail(f"{what}: netstate {k!r} differs")
    for k, b in ns_c["bufs"].items():
        gax = 2 if k in ("__pair__", "__bcast__") else 1
        a = b.narrow(gax, 0, n).cpu()
        if not torch.equal(a, ns_h["bufs"][k]):
            fail(f"{what}: netstate buffer {k!r} differs")
    return len(st_c)


def committed(state):
    return int(state["commit_bar"].amax(dim=1).sum())


def _union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_ticks(torch, eng, state, ns, ticks, P, what, card):
    """Where a synthetic tick's time goes (``profile_run`` over
    ``ticks`` ticks of ``run_synthetic``)."""
    box = [state, ns]

    def run():
        box[0], box[1] = eng.run_synthetic(box[0], box[1], ticks, P)

    return profile_run(torch, run, ticks, what, card)


def profile_run(torch, run, ticks, what, card):
    """Where a tick's time goes: ``run()`` (``ticks`` ticks) timed on the
    host clock without the profiler, then once more under
    ``torch.profiler`` for the device busy time (the union of kernel
    intervals), kernel launches per tick, device time per phase and the
    host's CUDA runtime calls.  The idle share is one less busy time
    over the unprofiled wall time.  Returns the per-tick numbers (None
    where the profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # device events minus the phase ranges mirrored onto the device
    # timeline (those span idle gaps too)
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)]
    out = {"wall_ms_per_tick": round(wall_us / ticks / 1e3, 4)}
    if not kernels:
        log(f"profile {what}: wall {wall_us / ticks / 1e3:.3f} ms/tick; the "
            f"profiler saw no device activity, so device busy time and idle "
            f"share are not measured | {card}")
        return dict(out, device_busy_ms_per_tick=None,
                    kernels_per_tick=None, runtime_ms_per_tick=None)
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    log(f"profile {what}: {ticks} ticks, wall {wall_us / ticks / 1e3:.3f} "
        f"ms/tick, device busy {busy_us / ticks / 1e3:.3f} ms/tick, idle "
        f"share {1 - busy_us / wall_us:.3f}, {len(kernels) / ticks:.1f} "
        f"kernel launches/tick | {card}")
    # the host-side phase ranges: device time of the kernels each launched
    phases = sorted(
        ((e.key[len("graftphase__"):], e.device_time_total, e.cpu_time_total)
         for e in prof.key_averages()
         if e.key.startswith("graftphase__") and e.device_type == cpu),
        key=lambda r: -r[1])
    for name, dev_us, cpu_us in phases:
        log(f"  phase {name:<22} device {dev_us / ticks / 1e3:.4f} ms/tick, "
            f"host {cpu_us / ticks / 1e3:.4f} ms/tick (profiled)")
    # the host's CUDA runtime calls: launches, copies, syncs, allocations
    api = sorted(((e.key, e.count, e.cpu_time_total)
                  for e in prof.key_averages()
                  if e.device_type == cpu and e.key.startswith("cu")),
                 key=lambda r: -r[2])
    log("  runtime calls per tick: " + ", ".join(
        f"{k} {n / ticks:.1f}x {us / ticks / 1e3:.4f} ms"
        for k, n, us in api[:6]))
    return dict(out,
                device_busy_ms_per_tick=round(busy_us / ticks / 1e3, 4),
                idle_share=round(1 - busy_us / wall_us, 4),
                kernels_per_tick=round(len(kernels) / ticks, 1),
                runtime_ms_per_tick=round(
                    sum(us for _k, _n, us in api) / ticks / 1e3, 4))


def run_window(torch, eng, st, ns, t0, ticks, P, alive=None, spr=None,
               extra=None, n_prop=None):
    """``ticks`` ticks of saturating load from absolute tick ``t0`` (value
    ids ``tick * P + i``, host applier saturated) through ``run_ticks``;
    ``alive`` ([R] bools) and ``spr`` ([G] int32 ``spr_override``) hold
    for every tick; ``extra`` maps a host input to one int for every tick
    and group, or to a list of one int per tick; ``n_prop`` (default
    ``P``) is the per-tick offer.  Returns the state, the netstate and the
    last tick's effects extras."""
    G, R = eng.kernel.G, eng.kernel.R
    dev = eng.device
    t = torch.arange(t0, t0 + ticks, dtype=torch.int32, device=dev)
    seq = {
        "n_proposals": torch.full((ticks, G), P if n_prop is None else n_prop,
                                  dtype=torch.int32, device=dev),
        "value_base": (t * P)[:, None].expand(ticks, G),
        "exec_floor": torch.full((G, R), 1 << 30, dtype=torch.int32,
                                 device=dev).expand(ticks, G, R),
    }
    if alive is not None:
        seq["alive"] = torch.tensor(alive, device=dev)[None, None, :].expand(
            ticks, G, R)
    if spr is not None:
        seq["spr_override"] = spr.to(dev)[None].expand(ticks, G)
    for k, v in (extra or {}).items():
        per_tick = v if isinstance(v, list) else [v] * ticks
        seq[k] = torch.tensor(per_tick, dtype=torch.int32,
                              device=dev)[:, None].expand(ticks, G)
    st, ns, fx = eng.run_ticks(st, ns, seq, collect=True)
    return st, ns, {k: v[-1] for k, v in fx.extra.items()}


def last_tick_slots(torch, st, fx, frontier, P, what):
    """The slots each group's leader appended in the last tick: ``(groups,
    leader rows, absolute slots)``, each [B] on the device.  Fails unless
    every group has exactly one serving leader."""
    isl = fx["is_leader"]
    if not bool((isl.sum(dim=1) == 1).all()):
        fail(f"{what}: a group has no single serving leader")
    G = isl.shape[0]
    dev = isl.device
    lead = isl.to(torch.int32).argmax(dim=1)
    g = torch.arange(G, device=dev)
    n = fx["n_accepted"][g, lead]
    end = st[frontier][g, lead]
    i = torch.arange(P, device=dev)
    m = i[None, :] < n[:, None]
    slot = end[:, None] - n[:, None] + i[None, :]
    gg = g[:, None].expand(G, P)[m]
    return gg, lead[gg], slot[m]


def drive_plan(torch, eng, plan, P):
    """Boot ``eng`` and run the windows of ``plan`` back to back: dicts of
    ``ticks`` and ``run_window`` keywords.  Returns each window's
    ``(state, netstate, last-tick extras, wall seconds)``."""
    st, ns = eng.init()
    out, t0 = [], 0
    for w in plan:
        w = dict(w)
        ticks = w.pop("ticks")
        torch.cuda.synchronize()
        a = time.perf_counter()
        st, ns, fx = run_window(torch, eng, st, ns, t0, ticks, P, **w)
        torch.cuda.synchronize()
        out.append((st, ns, fx, time.perf_counter() - a))
        t0 += ticks
    return out


# -------------------------------------------------------- codeword helpers --
def abs_err(got, want):
    return int((got.long() - want.long()).abs().max())


def encode_values(torch, np, rs, code, B, seed, what):
    """``B`` random 4 KiB payloads packed at the kernel geometry and
    encoded in one batched call, held bit for bit against the plain
    version: ``(payloads [B, PAYLOAD] uint8, data [B, d, L], codeword
    [B, d + p, L], max_abs_err)``."""
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, size=(B, PAYLOAD), dtype=np.uint8)
    L = lanes_for(PAYLOAD, code.d)
    data = torch.from_numpy(pack_batch(np, payloads, code.d, L)).to(DEV)
    parity = code.compute_parity(data)
    want = rs._bitslice_matmul_plain(code._parity_tbl, data)
    if not torch.equal(parity, want):
        fail(f"{what} encode: kernel != plain")
    return (payloads, data, torch.cat([data, parity], dim=1),
            abs_err(parity, want))


def decode_values(torch, np, rs, code, cw, present, payloads, what):
    """Decode value ``b`` of ``cw`` [B, T, L] from the shard ids
    ``present[b]``, one kernel call per distinct set, each held against
    the plain version; the payload bytes must round-trip.  Returns the
    number of distinct sets and the max_abs_err against the plain
    version."""
    B = cw.shape[0]
    decoded = torch.empty((B, code.d, cw.shape[2]), dtype=torch.int32,
                          device=cw.device)
    keys = sorted(set(present))
    err = 0
    for key in keys:
        idx = torch.from_numpy(np.array(
            [b for b, p in enumerate(present) if p == key])).to(cw.device)
        shards = cw.index_select(0, idx)[:, list(key)].contiguous()
        got = code.reconstruct_data(shards, key)
        want = rs._bitslice_matmul_plain(code._decode_tbl(key), shards)
        if not torch.equal(got, want):
            fail(f"{what} decode from {key}: kernel != plain")
        err = max(err, abs_err(got, want))
        decoded[idx] = got
    torch.cuda.synchronize()
    back = decoded.cpu().numpy().view(np.uint8).reshape(B, -1)[:, :PAYLOAD]
    if not np.array_equal(back, payloads):
        fail(f"{what}: decoded payload bytes differ")
    return len(keys), err


def kernel_numbers(torch, rs, code, data, card, what):
    """The kernel's time at a path's encode shape beside the plain
    version's and the bound."""
    B, d, L = data.shape
    k_ms = time_ms(torch, lambda: code.compute_parity(data), 20)
    p_ms = time_ms(torch, lambda: rs._bitslice_matmul_plain(
        code._parity_tbl, data), 3)
    b_ms, b_by = bound_ms(code.p, d, B, L)
    log(f"{what} encode [{B},{d},{L}]: kernel {k_ms:.4f} ms plain "
        f"{p_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) share "
        f"{b_ms / k_ms:.3f} | {card}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


# ------------------------------------------------------------------ phases --
def phase_build():
    """Build the CUDA kernel and the native WAL from the checkout, one
    compiler process each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from summerset_tpu_torch.host import storage
    from summerset_tpu_torch.ops import native

    log("== phase 1: build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        paths = dict(zip(("bitslice", "wal"),
                         pool.map(native.build, ("bitslice", "wal"))))
    native.load("bitslice")
    if storage.load_wal() is None:
        fail(f"the native WAL did not load: {storage.wal_build_error()}")
    log(f"built {paths['bitslice']} and {paths['wal']} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc "
        f"{native.build_seconds.get('bitslice', 0.0):.3f} s, g++ "
        f"{native.build_seconds.get('wal', 0.0):.3f} s)")
    for line in native.build_log.get("bitslice", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(torch, np, card):
    from summerset_tpu_torch.ops import rscoding as rs

    log("== phase 2: kernel vs plain on the card (bit-exact)")
    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED)
    codes = {(d, p): rs.RSCode(d, p, device=dev)
             for d, p in ((3, 2), (2, 1), (5, 3), (6, 4))}
    tables = [(f"enc({d},{p})", code._parity_tbl)
              for (d, p), code in codes.items()]
    subsets = list(itertools.combinations(range(5), 3))
    tables += [(f"dec(3,2){s}", codes[(3, 2)]._decode_tbl(s))
               for s in subsets]
    # Crossword at T=10: replicas 1, 3 and 4 hold shards {2,3}, {6,7}, {8,9}
    held64 = (2, 3, 6, 7, 8, 9)
    tables.append((f"dec(6,4){held64}", codes[(6, 4)]._decode_tbl(held64)))
    shape_defs = [("1024x4KiB", 1024, 4096), ("1x4KiB", 1, 4096),
                  ("1x64KiB", 1, 65536), ("1x1MiB", 1, 1 << 20),
                  ("1x4MiB", 1, 4 << 20), ("3xL1000", 3, None)]
    max_err = 0
    checked = 0
    for sname, B, nbytes in shape_defs:
        for tname, tbl in tables:
            rows, cols = int(tbl.shape[0]), int(tbl.shape[1])
            L = 1000 if nbytes is None else lanes_for(nbytes, cols)
            x = torch.from_numpy(rng.integers(
                -2**31, 2**31, size=(B, cols, L), dtype=np.int32)).to(dev)
            got = rs.bitslice_gf256(tbl, x)
            want = rs._bitslice_matmul_plain(tbl, x)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                fail(f"kernel != plain for {tname} at {sname} [{B},{cols},{L}]")
            checked += 1
            if tname in ("enc(3,2)", "dec(3,2)(2, 3, 4)"):
                iters = 20 if B * L > 1 << 18 else 100
                k_ms = time_ms(torch, lambda: rs.bitslice_gf256(tbl, x), iters)
                p_ms = time_ms(torch, lambda: rs._bitslice_matmul_plain(tbl, x),
                               max(iters // 10, 3))
                b_ms, b_by = bound_ms(rows, cols, B, L)
                log(f"{tname:>18} {sname:>10} [{B},{cols},{L}] kernel "
                    f"{k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.4f} ms "
                    f"({b_by}) share {b_ms / k_ms:.3f} | {card}")
    log(f"{checked} (table, shape) pairs bit-exact, max_abs_err {max_err}")
    log('kernels: ["bitslice_gf256"]')
    return max_err


def phase_multipaxos(torch, card):
    from summerset_tpu_torch.protocols.multipaxos import (
        ReplicaConfigMultiPaxos,
    )

    log("== phase 3: MultiPaxos at the bench shape")
    sh = MP_SHAPE
    cfg = ReplicaConfigMultiPaxos(
        max_proposals_per_tick=sh["P"], chunk_size=2 * sh["P"],
        exec_follows_commit=False,
    )

    def engine(G, device):
        return make_engine("multipaxos", cfg, sh, G, device)

    eng = engine(sh["G"], DEV)
    st, ns = eng.init()
    st, ns = eng.run_synthetic(st, ns, 8, sh["P"])  # warm-up
    torch.cuda.synchronize()
    c0 = committed(st)
    t0 = time.perf_counter()
    st, ns = eng.run_synthetic(st, ns, MP_TICKS, sh["P"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = (committed(st) - c0) / dt
    if committed(st) <= c0:
        fail("multipaxos: commits did not advance")
    log(f"multipaxos G={sh['G']} R={sh['R']} W={sh['W']} P={sh['P']}: "
        f"{MP_TICKS} ticks in {dt:.3f} s ({dt / MP_TICKS * 1e3:.3f} ms/tick), "
        f"{rate:.1f} committed slots/s | {card}")
    profile_ticks(torch, eng, st, ns, PROFILE_TICKS, sh["P"], "multipaxos",
                  card)

    card_run = drive(torch, engine(sh["G"], DEV), MP_TICKS, sh["P"])
    cpu_run = drive(torch, engine(CPU_GROUPS, "cpu"), MP_TICKS, sh["P"])
    n = compare_groups(torch, card_run[:2], cpu_run[:2], CPU_GROUPS,
                       "multipaxos")
    if committed(card_run[0]) <= 0:
        fail("multipaxos: nothing committed in the compared window")
    log(f"multipaxos: first {CPU_GROUPS} groups equal the CPU run over "
        f"{MP_TICKS} ticks ({n} state leaves + netstate)")


def phase_rspaxos(torch, np, card):
    from summerset_tpu_torch.host.codeword import CodewordStore
    from summerset_tpu_torch.ops import rscoding as rs
    from summerset_tpu_torch.protocols.rspaxos import ReplicaConfigRSPaxos

    log("== phase 4: RSPaxos + RS(3,2) codeword plane (main path)")
    sh = RS_SHAPE
    cfg = ReplicaConfigRSPaxos(
        max_proposals_per_tick=sh["P"], chunk_size=2 * sh["P"],
        exec_follows_commit=False, fault_tolerance=1,
    )

    def engine(G, device):
        return make_engine("rspaxos", cfg, sh, G, device)

    eng = engine(sh["G"], DEV)
    rs.bitslice_gf256.launches = 0
    t0 = time.perf_counter()
    st, ns, fx = drive(torch, eng, RS_TICKS, sh["P"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cb = st["commit_bar"].amax(dim=1)
    fb_follow = st["full_bar"][:, 1:].amin(dim=1)
    if int(cb.min()) <= 0 or int(fb_follow.min()) <= 0:
        fail("rspaxos: commit_bar / follower full_bar did not advance")
    log(f"rspaxos G={sh['G']} R={sh['R']} W={sh['W']} P={sh['P']} ft=1: "
        f"{RS_TICKS} ticks in {dt:.3f} s, commit_bar min {int(cb.min())}, "
        f"follower full_bar min {int(fb_follow.min())}, "
        f"{committed(st) / dt:.1f} committed slots/s | {card}")

    # the codeword plane over the window's last tick: each group's leader
    # proposed n_accepted values with ids value_base + i
    code = rs.RSCode(3, 2, device=DEV)
    n_acc = fx.extra["n_accepted"].amax(dim=1).cpu().numpy()
    B = int(n_acc.sum())
    if B == 0:
        fail("rspaxos: no values proposed in the last tick")
    groups = np.repeat(np.arange(sh["G"]), n_acc)
    payloads, data, cw, e_enc = encode_values(torch, np, rs, code, B,
                                              SEED + 4, "main-path")
    ref = rs.pack_bytes(payloads[0].tobytes(), 3, lane_multiple=128)
    if not np.array_equal(data[0].cpu().numpy(), ref):
        fail("batched packing differs from pack_bytes")
    subsets = list(itertools.combinations(range(5), 3))
    calls, e_dec = decode_values(torch, np, rs, code, cw,
                                 [subsets[g % len(subsets)] for g in groups],
                                 payloads, "rspaxos")
    log(f"codeword plane: {B} values x {PAYLOAD} B encoded in one "
        f"[{B}, 3, {data.shape[2]}] call, decoded from {calls} 3-of-5 "
        f"subsets by group, bytes round-trip")

    store = CodewordStore(sh["G"], code, total=5, device=DEV)
    peer = CodewordStore(sh["G"], code, total=5, device=DEV)
    for j in range(4):
        g, vid = int(groups[j]), 1000 + j
        batch = payloads[j].tobytes()
        dlen, rows = store.encode(g, vid, batch, spr=1)
        sub = subsets[(j * 3 + 5) % len(subsets)]
        peer.add_shards(g, vid, dlen, {s: rows[s] for s in sub})
        if peer.reconstruct_batch(g, vid) != batch:
            fail(f"CodewordStore round-trip failed for value {j}")
        if peer.have_mask(g, vid) != 0b11111:
            fail("CodewordStore did not restore the full codeword")
    torch.cuda.synchronize()
    launches = rs.bitslice_gf256.launches
    if launches == 0:
        fail("the main path never launched bitslice_gf256")
    log(f"CodewordStore: 4 values encode -> add_shards -> reconstruct_batch "
        f"round-trip; bitslice_gf256 launches on the main path: {launches}")

    cpu = drive(torch, engine(CPU_GROUPS, "cpu"), RS_TICKS, sh["P"])
    n = compare_groups(torch, (st, ns), cpu[:2], CPU_GROUPS, "rspaxos")
    log(f"rspaxos: first {CPU_GROUPS} groups equal the CPU run over "
        f"{RS_TICKS} ticks ({n} state leaves + netstate)")
    profile_ticks(torch, eng, st, ns, PROFILE_TICKS, sh["P"], "rspaxos", card)

    # the kernel's numbers at the main path's encode shape
    return dict(kernel_numbers(torch, rs, code, data, card, "main-path"),
                launches=launches, max_abs_err=max(e_enc, e_dec))


# --------------------------------- phases 5-7: Raft, CRaft and Crossword --
def phase_raft(torch, card):
    from summerset_tpu_torch.protocols.raft import ReplicaConfigRaft

    log("== phase 5: Raft at the BASELINE shape, cold start")
    sh = RAFT_SHAPE
    P = sh["P"]
    cfg = ReplicaConfigRaft(
        max_proposals_per_tick=P, chunk_size=2 * P,
        exec_follows_commit=False, init_leader=-1,
    )

    def elect(eng, chunks=None):
        """Saturating load from a cold start until every group has exactly
        one leader (the card), or the card's chunks replayed (the CPU)."""
        st, ns = eng.init()
        if chunks is not None:
            for n in chunks:
                st, ns = eng.run_synthetic(st, ns, n, P)
            return st, ns, chunks
        chunks = []
        while True:
            st, ns = eng.run_synthetic(st, ns, ELECT_STEP, P)
            chunks.append(ELECT_STEP)
            if bool((st["is_leader"].sum(dim=1) == 1).all()):
                return st, ns, chunks
            if sum(chunks) >= ELECT_MAX:
                fail(f"raft: not every group elected one leader within "
                     f"{ELECT_MAX} ticks")

    eng = make_engine("raft", cfg, sh, sh["G"], DEV)
    t0 = time.perf_counter()
    st, ns, chunks = elect(eng)
    torch.cuda.synchronize()
    elect_s = time.perf_counter() - t0
    terms = st["term"].amax(dim=1)
    log(f"raft G={sh['G']} R={sh['R']} W={sh['W']} P={P}: one leader in "
        f"every group after {sum(chunks)} ticks ({elect_s:.3f} s), term "
        f"max {int(terms.max())} mean {float(terms.float().mean()):.2f}")
    c0 = committed(st)
    t0 = time.perf_counter()
    st, ns = eng.run_synthetic(st, ns, RAFT_TICKS, P)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if int(st["commit_bar"].amax(dim=1).min()) <= 0:
        fail("raft: a group committed nothing")
    if committed(st) <= c0:
        fail("raft: commits did not advance")
    log(f"raft: {RAFT_TICKS} ticks in {dt:.3f} s ({dt / RAFT_TICKS * 1e3:.3f} "
        f"ms/tick), {(committed(st) - c0) / dt:.1f} committed slots/s, "
        f"commit_bar min {int(st['commit_bar'].amax(dim=1).min())} | {card}")

    cpu = make_engine("raft", cfg, sh, CPU_GROUPS, "cpu")
    cst, cns, _ = elect(cpu, chunks)
    cst, cns = cpu.run_synthetic(cst, cns, RAFT_TICKS, P)
    n = compare_groups(torch, (st, ns), (cst, cns), CPU_GROUPS, "raft")
    log(f"raft: first {CPU_GROUPS} groups equal the CPU run over "
        f"{sum(chunks) + RAFT_TICKS} ticks ({n} state leaves + netstate)")
    profile_ticks(torch, eng, st, ns, PROFILE_TICKS, P, "raft", card)


def phase_craft(torch, np, card):
    from summerset_tpu_torch.ops import rscoding as rs
    from summerset_tpu_torch.protocols.craft import ReplicaConfigCRaft

    log("== phase 6: CRaft + RS(3,2), full-copy fallback and back")
    sh = CRAFT_SHAPE
    P = sh["P"]
    cfg = ReplicaConfigCRaft(
        max_proposals_per_tick=P, chunk_size=2 * P,
        exec_follows_commit=False, fault_tolerance=1,
    )
    down = (True, True, True, False, False)   # followers 3 and 4 paused
    # warm-up, timed healthy window, two followers paused past
    # alive_timeout (read at 24 and 40 ticks), resumed
    plan = [dict(ticks=8), dict(ticks=40), dict(ticks=24, alive=down),
            dict(ticks=16, alive=down), dict(ticks=32)]
    if cfg.alive_timeout >= 24:
        fail("craft: the pause must outlast alive_timeout")

    rs.bitslice_gf256.launches = 0
    eng = make_engine("craft", cfg, sh, sh["G"], DEV)
    out = drive_plan(torch, eng, plan, P)
    st, ns = out[-1][:2]
    dt = out[1][3]   # the timed healthy window
    c_warm, c_healthy = committed(out[0][0]), committed(out[1][0])
    log(f"craft G={sh['G']} R={sh['R']} W={sh['W']} P={P} ft=1: "
        f"{plan[1]['ticks']} healthy ticks in {dt:.3f} s "
        f"({dt / plan[1]['ticks'] * 1e3:.3f} ms/tick), "
        f"{(c_healthy - c_warm) / dt:.1f} committed slots/s | {card}")

    def modes(k):
        st_k, _, fx_k, _ = out[k]
        g, lead, slot = last_tick_slots(torch, st_k, fx_k, "log_end", P,
                                        "craft")
        return g, st_k["win_full"][g, lead, slot % sh["W"]]

    # the healthy window's last tick: every leader's new slots are coded
    g1, full1 = modes(1)
    if bool(full1.any()) or full1.numel() == 0:
        fail("craft: the healthy window stamped no slots or full-copy ones")
    # two followers down past alive_timeout: full-copy, and still commits
    _, full3 = modes(3)
    if not bool(full3.all()) or full3.numel() == 0:
        fail("craft: with two followers down new slots are not full-copy")
    cb2 = out[2][0]["commit_bar"].amax(dim=1)
    cb3 = out[3][0]["commit_bar"].amax(dim=1)
    if not bool((cb3 > cb2).all()):
        fail("craft: a group stopped committing in full-copy mode")
    # resumed: coded again
    _, full4 = modes(4)
    if bool(full4.any()) or full4.numel() == 0:
        fail("craft: after the followers resumed new slots are not coded")
    log(f"craft: last-tick slots coded {full1.numel()} (healthy) -> "
        f"full-copy {full3.numel()} (two followers paused, commits "
        f"{int(cb2.sum())} -> {int(cb3.sum())}) -> coded {full4.numel()} "
        f"(resumed)")

    # the codeword plane over the healthy window's coded values
    code = rs.RSCode(3, 2, device=DEV)
    B = int(full1.numel())
    payloads, data, cw, e_enc = encode_values(torch, np, rs, code, B,
                                              SEED + 6, "craft")
    subsets = list(itertools.combinations(range(5), 3))
    groups = g1.cpu().numpy()
    present = [subsets[g % len(subsets)] for g in groups]
    calls, e_dec = decode_values(torch, np, rs, code, cw, present, payloads,
                                 "craft")
    torch.cuda.synchronize()
    launches = rs.bitslice_gf256.launches
    if launches == 0:
        fail("the craft path never launched bitslice_gf256")
    log(f"craft codeword plane: {B} coded values x {PAYLOAD} B encoded in "
        f"one [{B}, 3, {data.shape[2]}] call, decoded from {calls} "
        f"rotating 3-of-5 subsets, bytes round-trip; bitslice_gf256 "
        f"launches on the craft path: {launches}")

    cout = drive_plan(torch, make_engine("craft", cfg, sh, CPU_GROUPS, "cpu"),
                      plan, P)
    n = compare_groups(torch, (st, ns), cout[-1][:2], CPU_GROUPS, "craft")
    log(f"craft: first {CPU_GROUPS} groups equal the CPU run over "
        f"{sum(w['ticks'] for w in plan)} ticks ({n} state leaves + "
        f"netstate)")
    profile_ticks(torch, eng, st, ns, PROFILE_TICKS, P, "craft", card)
    kernel_numbers(torch, rs, code, data, card, "craft")
    return {"launches": launches, "max_abs_err": max(e_enc, e_dec)}


def phase_crossword(torch, np, card):
    from summerset_tpu_torch.host.codeword import CodewordStore, assigned_sids
    from summerset_tpu_torch.ops import rscoding as rs
    from summerset_tpu_torch.protocols.crossword import (
        ReplicaConfigCrossword,
    )

    log("== phase 7: Crossword + RS(3,2), adaptive and overridden widths")
    sh = CW_SHAPE
    P, R, W = sh["P"], sh["R"], sh["W"]
    cfg = ReplicaConfigCrossword(
        max_proposals_per_tick=P, chunk_size=2 * P,
        exec_follows_commit=False, fault_tolerance=1, rs_total_shards=5,
        assignment_adaptive=True,
    )
    T, dj, d = 5, 1, 3
    # warm-up, timed healthy window, odd groups at spr_override=2
    def plan(G):
        odd = (torch.arange(G, dtype=torch.int32) % 2) * 2   # 0 / 2
        return [dict(ticks=8), dict(ticks=40), dict(ticks=32, spr=odd)]

    rs.bitslice_gf256.launches = 0
    eng = make_engine("crossword", cfg, sh, sh["G"], DEV)
    windows = plan(sh["G"])
    out = drive_plan(torch, eng, windows, P)
    st, ns = out[-1][:2]
    dt = out[1][3]   # the timed healthy window
    c_warm, c_healthy = committed(out[0][0]), committed(out[1][0])
    log(f"crossword G={sh['G']} R={R} W={W} P={P} ft=1 T={T}: "
        f"{windows[1]['ticks']} healthy ticks in {dt:.3f} s "
        f"({dt / windows[1]['ticks'] * 1e3:.3f} ms/tick), "
        f"{(c_healthy - c_warm) / dt:.1f} committed slots/s | {card}")
    if committed(st) <= c_healthy:
        fail("crossword: commits did not advance under the override")

    # each last-tick value's width, read from its leader's win_spr
    g, lead, slot = last_tick_slots(torch, st, out[-1][2], "next_slot", P,
                                    "crossword")
    spr = st["win_spr"][g, lead, slot % W]
    want = torch.where(g % 2 == 1, 2, 1).to(torch.int32)
    if spr.numel() == 0 or not torch.equal(spr, want):
        fail("crossword: last-tick widths are not 2 (odd groups, "
             "overridden) and 1 (even groups, adaptive)")
    log(f"crossword: last tick {spr.numel()} values, "
        f"{int((spr == 2).sum())} at spr=2 (override), "
        f"{int((spr == 1).sum())} at spr=1 (adaptive)")

    # covering replica sets per width: rows of the replicas in the set
    # hold >= d distinct shard ids, and no smaller subset does
    def covers(s):
        out_ = []
        for k in range(1, R + 1):
            for combo in itertools.combinations(range(R), k):
                held = {x for r in combo for x in assigned_sids(r, s, dj, T)}
                if len(held) >= d and not any(set(c) <= set(combo)
                                              for c, _ in out_):
                    out_.append((combo, tuple(sorted(held))[:d]))
        return out_

    cover = {s: covers(s) for s in (1, 2)}
    code = rs.RSCode(d, T - d, device=DEV)
    B = int(spr.numel())
    payloads, data, cw, e_enc = encode_values(torch, np, rs, code, B,
                                              SEED + 7, "crossword")
    widths = spr.cpu().numpy()
    present = [cover[int(s)][j % len(cover[int(s)])][1]
               for j, s in enumerate(widths)]
    calls, e_dec = decode_values(torch, np, rs, code, cw, present, payloads,
                                 "crossword")

    # a few values through the store: replica r is given only its
    # assigned rows at the value's width
    store = CodewordStore(sh["G"], code, total=T, dj=dj, device=DEV)
    groups = g.cpu().numpy()
    for j in range(4):
        s = int(widths[j])
        gj, vid = int(groups[j]), 5000 + j
        batch = payloads[j].tobytes()
        dlen, rows = store.encode(gj, vid, batch, spr=s)
        combo, _ = cover[s][(j * 3 + 1) % len(cover[s])]
        peer = CodewordStore(sh["G"], code, total=T, dj=dj, device=DEV)
        for r in combo:
            peer.add_shards(gj, vid, dlen, {
                x: rows[x] for x in assigned_sids(r, s, dj, T)
            }, assigned=True)
        if peer.reconstruct_batch(gj, vid) != batch:
            fail(f"crossword: CodewordStore round-trip failed for value {j}")
    torch.cuda.synchronize()
    launches = rs.bitslice_gf256.launches
    if launches == 0:
        fail("the crossword path never launched bitslice_gf256")
    log(f"crossword codeword plane: {B} values encoded in one "
        f"[{B}, {d}, {data.shape[2]}] call; each rebuilt from the assigned "
        f"rows of a rotating covering replica set ({calls} decode sets), "
        f"bytes round-trip; 4 values through CodewordStore; "
        f"bitslice_gf256 launches on the crossword path: {launches}")

    cout = drive_plan(torch, make_engine("crossword", cfg, sh, CPU_GROUPS,
                                         "cpu"), plan(CPU_GROUPS), P)
    n = compare_groups(torch, (st, ns), cout[-1][:2], CPU_GROUPS,
                       "crossword")
    log(f"crossword: first {CPU_GROUPS} groups equal the CPU run over "
        f"{sum(w['ticks'] for w in windows)} ticks ({n} state leaves + "
        f"netstate)")
    profile_ticks(torch, eng, st, ns, PROFILE_TICKS, P, "crossword", card)
    kernel_numbers(torch, rs, code, data, card, "crossword")
    return {"launches": launches, "max_abs_err": max(e_enc, e_dec)}


# ------------------- phases 8-10: the lease planes and the basic kernels --
def timed_line(what, sh, out, card):
    """ms/tick and committed slots/s of window 1, the timed window."""
    ticks, dt = TIMED_TICKS, out[1][3]
    rate = (committed(out[1][0]) - committed(out[0][0])) / dt
    if rate <= 0:
        fail(f"{what}: commits did not advance in the timed window")
    log(f"{what} G={sh['G']} R={sh['R']} W={sh['W']} P={sh['P']}: "
        f"{ticks} ticks in {dt:.3f} s ({dt / ticks * 1e3:.3f} ms/tick), "
        f"{rate:.1f} committed slots/s | {card}")


def lease_plane_check(torch, proto, cfg, sh, plan, card):
    """Run ``plan`` on the card at full width and on the CPU at
    ``CPU_GROUPS`` groups; the first groups must be equal.  Returns the
    card engine and its windows."""
    eng = make_engine(proto, cfg, sh, sh["G"], DEV)
    out = drive_plan(torch, eng, plan, sh["P"])
    cpu = drive_plan(torch, make_engine(proto, cfg, sh, CPU_GROUPS, "cpu"),
                   plan, sh["P"])
    n = compare_groups(torch, out[-1][:2], cpu[-1][:2], CPU_GROUPS, proto)
    log(f"{proto}: first {CPU_GROUPS} groups equal the CPU run over "
        f"{sum(w['ticks'] for w in plan)} ticks ({n} state leaves + "
        f"netstate)")
    return eng, out


def phase_quorum_leases(torch, card):
    from summerset_tpu_torch.protocols.quorum_leases import (
        ReplicaConfigQuorumLeases,
    )

    log("== phase 8: QuorumLeases at the bench shape, conf via the log, "
        "write barrier")
    sh = QL_SHAPE
    P = sh["P"]
    cfg = ReplicaConfigQuorumLeases(
        max_proposals_per_tick=P, chunk_size=2 * P,
        exec_follows_commit=False,
    )
    conf = {"conf_target": QL_RESP}
    down2 = (True, True, False, True, True)
    # warm-up (the conf is proposed through the log), the timed window,
    # responder 2 paused: the barrier stalls, then lifts once its lease
    # and the margin have lapsed
    plan = [dict(ticks=8, extra=conf), dict(ticks=TIMED_TICKS, extra=conf),
            dict(ticks=8, alive=down2, extra=conf),
            dict(ticks=QL_RELEASE_TICKS, alive=down2, extra=conf)]
    eng, out = lease_plane_check(torch, "quorumleases", cfg, sh, plan, card)
    timed_line("quorumleases", sh, out, card)

    st, _, fx, _ = out[1]
    if not bool((st["conf_cur"] == QL_RESP).all()):
        fail("quorumleases: conf {1, 2} not applied on every replica")
    held, reads = fx["lease_held"], fx["leader_read_ok"]
    if not bool(held[:, 1:3].all()) or bool(held[:, [0, 3, 4]].any()):
        fail("quorumleases: leases not held on exactly replicas 1 and 2")
    if not bool(reads[:, 0].all()) or bool(reads[:, 1:].any()):
        fail("quorumleases: leader reads not on replica 0 only")
    log(f"quorumleases: conf_cur == {QL_RESP:#07b} on every replica, "
        f"lease_held on replicas 1 and 2 and leader_read_ok on replica 0 "
        f"only, in all {sh['G']} groups")

    pre = out[1][0]["commit_bar"][:, 0]
    mid = out[2][0]["commit_bar"][:, 0]
    fin = out[3][0]["commit_bar"][:, 0]
    if not bool((mid - pre <= 2 * P).all()):
        fail("quorumleases: commits ran past the paused responder's lease")
    if not bool((fin - mid > 10 * P).all()):
        fail("quorumleases: the write barrier did not lift")
    log(f"quorumleases: replica 2 paused: leader commit_bar rose "
        f"{int((mid - pre).min())}..{int((mid - pre).max())} slots in 8 "
        f"ticks (<= {2 * P}), then {int((fin - mid).min())}.."
        f"{int((fin - mid).max())} in the next {QL_RELEASE_TICKS} "
        f"(> {10 * P}), in all {sh['G']} groups")
    profile_ticks(torch, eng, out[1][0], out[1][1], PROFILE_TICKS, P,
                  "quorumleases", card)


def phase_bodega(torch, card):
    from summerset_tpu_torch.protocols.bodega import ReplicaConfigBodega

    log("== phase 9: Bodega at the bench shape, roster, per-bucket change, "
        "leader failover")
    sh = BO_SHAPE
    P, G, K = sh["P"], sh["G"], 8
    cfg = ReplicaConfigBodega(
        max_proposals_per_tick=P, chunk_size=2 * P,
        exec_follows_commit=False, num_key_buckets=K,
    )
    bal0 = 1 << 8            # the warm-start roster's ballot (leader 0)

    def announce(resp, bucket, ticks):
        """Replica 0 announces leader 0 and ``resp`` on ``bucket`` (-1 =
        every bucket) on the window's first tick."""
        return {"conf_init": [0] + [-1] * (ticks - 1),
                "conf_leader_target": 0, "conf_resp_target": resp,
                "conf_bucket": bucket}

    down0 = (False, True, True, True, True)
    # roster announce, the timed window, writes drained, bucket 3 moved to
    # {3, 4}, replica 0 paused past conf_timeout
    plan = [dict(ticks=8, extra=announce(BO_RESP, -1, 8)),
            dict(ticks=TIMED_TICKS), dict(ticks=16, n_prop=0),
            dict(ticks=24, extra=announce(BO_RESP3, 3, 24)),
            dict(ticks=BO_FAILOVER_TICKS, alive=down0)]
    eng, out = lease_plane_check(torch, "bodega", cfg, sh, plan, card)
    timed_line("bodega", sh, out, card)

    st, _, fx, _ = out[1]
    if not bool((st["conf_bal"] > bal0).all()):
        fail("bodega: the announced roster is not installed everywhere")
    if not bool((st["conf_resp"] == BO_RESP).all()) or not bool(
            (st["conf_leader"] == 0).all()):
        fail("bodega: installed roster differs from the announced one")
    if not bool((st["lease_out"].amax(dim=(1, 2)) > 0).all()):
        fail("bodega: a group has no config lease out")
    if not bool(fx["stable_leader"][:, 0].all()):
        fail("bodega: replica 0 is not a stable leader in every group")
    nloc = out[2][2]["n_local_buckets"]
    if not bool((nloc[:, 1:3] > 0).all()) or bool(nloc[:, [0, 3, 4]].any()):
        fail("bodega: local reads not served on exactly responders 1, 2")
    log(f"bodega: roster {BO_RESP:#07b} installed at conf_bal "
        f"{int(st['conf_bal'].min())}..{int(st['conf_bal'].max())} on every "
        f"replica, config leases out, replica 0 stable leader; writes "
        f"drained: n_local_buckets on responders 1, 2 min "
        f"{int(nloc[:, 1:3].min())} of {K}, in all {G} groups")

    st3 = out[3][0]
    resp = st3["conf_resp"]
    want = torch.full((K,), BO_RESP, dtype=torch.int32, device=resp.device)
    want[3] = BO_RESP3
    if not bool((resp == want).all()) or not bool(
            (st3["conf_bal"] > st["conf_bal"]).all()):
        fail("bodega: the per-bucket change is not installed everywhere")
    log(f"bodega: bucket 3 -> {BO_RESP3:#07b}, the other buckets "
        f"{BO_RESP:#07b}, on every replica of all {G} groups")

    st4 = out[4][0]
    lead = st4["conf_leader"][:, 1:]
    if not bool((lead != 0).all()) or not bool(
            (st4["conf_bal"][:, 1:] > st3["conf_bal"][:, 1:]).all()):
        fail("bodega: no higher-ballot conf named a new leader")
    if not bool((lead == lead[:, :1]).all()):
        fail("bodega: the live replicas of a group name different leaders")
    before = st3["commit_bar"][:, 1:].amax(dim=1)
    after = st4["commit_bar"][:, 1:].amax(dim=1)
    if not bool((after > before).all()):
        fail("bodega: commits stopped after the leader paused")
    log(f"bodega: replica 0 paused {BO_FAILOVER_TICKS} ticks: every "
        f"group's live replicas name one new conf leader (leaders "
        f"{sorted(set(lead[:, 0].tolist()))}) at a higher ballot, live "
        f"commit_bar "
        f"+{int((after - before).min())}..+{int((after - before).max())}, "
        f"in all {G} groups")
    profile_ticks(torch, eng, out[1][0], out[1][1], PROFILE_TICKS, P,
                  "bodega", card)


def phase_basic(torch, card):
    from summerset_tpu_torch.protocols.chain_rep import ReplicaConfigChainRep
    from summerset_tpu_torch.protocols.rep_nothing import (
        ReplicaConfigRepNothing,
    )
    from summerset_tpu_torch.protocols.simple_push import (
        ReplicaConfigSimplePush,
    )

    log("== phase 10: ChainRep, SimplePush and RepNothing")
    sh = BASIC_SHAPE
    P, G = sh["P"], sh["G"]
    cfgs = {
        "chainrep": ReplicaConfigChainRep(max_proposals_per_tick=P,
                                          chunk_size=2 * P),
        "simplepush": ReplicaConfigSimplePush(max_proposals_per_tick=P,
                                              chunk_size=2 * P),
        "repnothing": ReplicaConfigRepNothing(max_proposals_per_tick=P),
    }
    for proto, cfg in cfgs.items():
        eng = make_engine(proto, cfg, sh, G, DEV)
        st, ns = eng.init()
        st, ns = eng.run_synthetic(st, ns, 8, P)  # warm-up
        torch.cuda.synchronize()
        c0 = committed(st)
        t0 = time.perf_counter()
        st, ns = eng.run_synthetic(st, ns, TIMED_TICKS, P)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        cb = st["commit_bar"]
        if not bool((cb.amax(dim=1) > 0).all()) or committed(st) <= c0:
            fail(f"{proto}: commits did not advance in every group")
        if proto == "chainrep" and not bool(
                ((cb[:, 0] > 0) & (cb[:, 0] <= cb[:, -1])).all()):
            fail("chainrep: the tail's acks did not ripple back to the head")
        if proto == "simplepush" and not bool((cb > 0).all()):
            fail("simplepush: a pushed peer committed nothing")
        if proto == "repnothing" and bool(cb[:, 1:].any()):
            fail("repnothing: a non-serving replica committed")
        log(f"{proto} G={G} R={sh['R']} W={sh['W']} P={P}: {TIMED_TICKS} "
            f"ticks in {dt:.3f} s ({dt / TIMED_TICKS * 1e3:.3f} ms/tick), "
            f"{(committed(st) - c0) / dt:.1f} committed slots/s, head/tail "
            f"commit_bar min {int(cb[:, 0].min())}/{int(cb[:, -1].min())} "
            f"| {card}")
        card_run = drive(torch, make_engine(proto, cfg, sh, G, DEV),
                         TIMED_TICKS, P)
        cpu_run = drive(torch, make_engine(proto, cfg, sh, CPU_GROUPS,
                                           "cpu"), TIMED_TICKS, P)
        n = compare_groups(torch, card_run[:2], cpu_run[:2], CPU_GROUPS,
                           proto)
        log(f"{proto}: first {CPU_GROUPS} groups equal the CPU run over "
            f"{TIMED_TICKS} ticks ({n} state leaves + netstate)")


# ----------------------------------------------------- phase 11: EPaxos --
def ep_instances(st):
    """Committed instances: per group and row, the furthest replica's
    contiguous committed frontier, summed."""
    return int(st["cmt_row"].amax(dim=1).sum())


def ep_agreement(st, what):
    """Wherever two replicas hold the same (row, col) as COMMITTED, its
    value, seq, no-op mark and deps are equal (checked on the device).
    Returns the number of (pair, instance) comparisons."""
    from summerset_tpu_torch.protocols.epaxos import COMMITTED

    cm = st["st2"] == COMMITTED                      # [G, R, row, W]
    R = cm.shape[1]
    n = 0
    for a in range(R):
        for b in range(a + 1, R):
            both = cm[:, a] & cm[:, b] & (st["abs2"][:, a] == st["abs2"][:, b])
            for k in ("val2", "seq2", "noop2"):
                if bool((both & (st[k][:, a] != st[k][:, b])).any()):
                    fail(f"{what}: replicas {a}, {b} committed different "
                         f"{k} for one instance")
            dd = (st["deps2"][:, a] != st["deps2"][:, b]).any(dim=-1)
            if bool((both & dd).any()):
                fail(f"{what}: replicas {a}, {b} committed different deps")
            n += int(both.sum())
    return n


class EPaxosHost:
    """The host side of EPaxos serving, as ``host/server.py`` runs it, for
    every (group, replica) of a lockstep engine: the proposing replica
    rotates with the tick and mints one vid per proposed key bucket in the
    residue class ``bucket + K * me (mod K * R)``, with the window space
    read from the previous tick's ``exec_row`` (``server.py:2020-2063``);
    each (group, replica) runs its own ``EPaxosExecutor``, whose floors
    are that replica's row of ``exec_floor_rows`` (``:2585-2595``)."""

    def __init__(self, np, G, R, W, P, K, seed):
        from summerset_tpu_torch.host.epaxos_exec import EPaxosExecutor

        self.np, self.G, self.R, self.W, self.P, self.K = np, G, R, W, P, K
        self.rng = np.random.default_rng(seed)
        self.next_vid = [1] * G
        self.applied = {(g, r): [] for g in range(G) for r in range(R)}
        self.execs = {
            (g, r): EPaxosExecutor(R, W, self._rec(g, r))
            for g in range(G) for r in range(R)
        }

    def _rec(self, g, r):
        out = self.applied[(g, r)]
        return lambda row, col, vid, noop: out.append(
            (row, col, int(vid), bool(noop)))

    def inputs(self, sn, t, propose):
        np, G, R, W, P, K = self.np, self.G, self.R, self.W, self.P, self.K
        me = t % R
        pv = np.zeros((G, P), np.int32)
        n = np.zeros(G, np.int32)
        for g in range(G if propose else 0):
            # the buckets with requests pending this tick
            take = self.rng.permutation(K)[:int(self.rng.integers(1, K + 1))]
            space = max(0, int(sn["exec_row"][g, me, me]) + W
                        - int(sn["own_next"][g, me]))
            for i, b in enumerate(take[:min(P, space)]):
                vid = self.next_vid[g]
                vid += (int(b) + K * me - vid) % (K * R)
                self.next_vid[g] = vid + 1
                pv[g, i] = vid
                n[g] = i + 1
        floors = np.zeros((G, R, R), np.int32)
        for (g, r), ex in self.execs.items():
            floors[g, r] = ex.floor
        return {"n_proposals": n, "value_base": pv[:, 0].copy(),
                "prop_replica": np.full(G, me, np.int32), "prop_vids": pv,
                "exec_floor_rows": floors}

    def advance(self, sn):
        for (g, r), ex in self.execs.items():
            ex.advance(sn["abs2"][g, r], sn["st2"][g, r], sn["seq2"][g, r],
                       sn["val2"][g, r], sn["noop2"][g, r],
                       sn["deps2"][g, r], sn["cmt_row"][g, r])


def ep_host_run(np, cfg, sh, device):
    """The host-exec path for ``EP_HOST_TICKS`` ticks at ``EP_HOST_GROUPS``
    groups.  Checks that ``exec_row`` equals the floors fed in every tick;
    returns the state, netstate, the host side and the wall seconds."""
    G, R, W, P, K = EP_HOST_GROUPS, sh["R"], sh["W"], sh["P"], sh["K"]
    eng = make_engine("epaxos", cfg, sh, G, device)
    host = EPaxosHost(np, G, R, W, P, K, SEED + 11)
    keys = ("abs2", "st2", "seq2", "val2", "noop2", "deps2", "cmt_row",
            "exec_row", "own_next")
    st, ns = eng.init()
    sn = {k: st[k].cpu().numpy() for k in keys}
    t0 = time.perf_counter()
    for t in range(EP_HOST_TICKS):
        inp = host.inputs(sn, t, t < EP_HOST_TICKS - EP_HOST_DRAIN)
        st, ns, _ = eng.tick(st, ns, inp)
        sn = {k: st[k].cpu().numpy() for k in keys}
        if not np.array_equal(sn["exec_row"], inp["exec_floor_rows"]):
            fail(f"epaxos host-exec ({device}): exec_row does not follow "
                 f"the executors' floors at tick {t}")
        host.advance(sn)
    return st, ns, host, time.perf_counter() - t0


def phase_epaxos(torch, np, card):
    from summerset_tpu_torch.protocols.epaxos import (
        COMMITTED,
        ReplicaConfigEPaxos,
    )

    log("== phase 11: EPaxos 1024x5, device exec, row failover, host exec")
    sh = EP_SHAPE
    G, R, W, P, K = sh["G"], sh["R"], sh["W"], sh["P"], sh["K"]
    cfg = ReplicaConfigEPaxos(max_proposals_per_tick=P, num_key_buckets=K)
    if EP_PAUSE_TICKS <= cfg.alive_timeout:
        fail("epaxos: the pause must outlast alive_timeout")
    torch.cuda.reset_peak_memory_stats()
    down0 = (False, True, True, True, True)
    plan = [dict(ticks=8), dict(ticks=TIMED_TICKS),
            dict(ticks=EP_PAUSE_TICKS, alive=down0)]
    eng = make_engine("epaxos", cfg, sh, G, DEV)
    out = drive_plan(torch, eng, plan, P)
    (st0, _, _, _), (st1, ns1, _, dt), (st2, ns2, _, _) = out

    # (a) the device-exec path
    if not bool((st1["cmt_row"] > st0["cmt_row"]).all()):
        fail("epaxos: a row's cmt_row did not advance at some replica")
    if not bool((st1["exec_row"] > st0["exec_row"]).all()):
        fail("epaxos: a row's exec_row did not advance at some replica")
    n_agree = ep_agreement(st1, "epaxos (a)")
    rate = (ep_instances(st1) - ep_instances(st0)) / dt
    log(f"epaxos G={G} R={R} W={W} P={P} K={K}: {TIMED_TICKS} ticks in "
        f"{dt:.3f} s ({dt / TIMED_TICKS * 1e3:.3f} ms/tick), {rate:.1f} "
        f"committed instances/s; cmt_row and exec_row advanced on every "
        f"row at every replica; {n_agree} replica-pair instance agreements "
        f"| {card}")

    # (b) row failover
    ext0 = st2["ext_row"][:, 1:, 0].amax(dim=1, keepdim=True)
    if not bool((st2["cmt_row"][:, 1:, 0] >= ext0).all()):
        fail("epaxos: a survivor did not commit row 0 up to the "
             "survivors' ext_row")
    if not bool((st2["cmt_row"][:, 1:, 1:] > st1["cmt_row"][:, 1:, 1:]).all()):
        fail("epaxos: rows 1-4 stopped committing during the pause")
    kept = 0
    for r in range(1, R):
        pre = (st1["st2"][:, r, 0] == COMMITTED)
        post = (st2["st2"][:, r, 0] == COMMITTED) & (
            st2["abs2"][:, r, 0] == st1["abs2"][:, r, 0])
        both = pre & post
        for k in ("val2", "seq2", "noop2"):
            if bool((both & (st2[k][:, r, 0] != st1[k][:, r, 0])).any()):
                fail(f"epaxos: a row-0 instance committed before the pause "
                     f"changed its {k} at replica {r}")
        kept += int(both.sum())
    n_agree2 = ep_agreement(st2, "epaxos (b)")
    recovered = int((st2["cmt_row"][:, 1:, 0] - st1["cmt_row"][:, 1:, 0])
                    .amax(dim=1).sum())
    log(f"epaxos: replica 0 paused {EP_PAUSE_TICKS} ticks: every survivor "
        f"committed row 0 to the survivors' ext_row ({recovered} row-0 "
        f"instances resolved by recovery), rows 1-4 kept committing, "
        f"{kept} pre-pause row-0 commits unchanged, {n_agree2} agreements, "
        f"in all {G} groups")

    # (d) the first groups of (a)+(b) against the CPU
    cpu = drive_plan(torch, make_engine("epaxos", cfg, sh, CPU_GROUPS, "cpu"),
                     plan, P)
    n = compare_groups(torch, (st2, ns2), cpu[-1][:2], CPU_GROUPS, "epaxos")
    log(f"epaxos: first {CPU_GROUPS} groups equal the CPU run over "
        f"{sum(w['ticks'] for w in plan)} ticks ({n} state leaves + "
        f"netstate)")
    profile_ticks(torch, eng, st1, ns1, PROFILE_TICKS, P, "epaxos", card)
    peak = torch.cuda.max_memory_allocated()

    # (c) the host-exec path, on the card and on the CPU
    hcfg = ReplicaConfigEPaxos(max_proposals_per_tick=P, num_key_buckets=K,
                               exec_follows_commit=False)
    hst, hns, host, hdt = ep_host_run(np, hcfg, sh, DEV)
    applied = sum(len(v) for v in host.applied.values())
    if applied == 0 or int(hst["exec_row"].sum()) == 0:
        fail("epaxos host-exec: the executors applied nothing")
    for g in range(EP_HOST_GROUPS):
        orders = []
        for r in range(R):
            per = {b: [] for b in range(K)}
            for row, col, vid, noop in host.applied[(g, r)]:
                if not noop:
                    per[vid % K].append((row, col, vid))
            orders.append(per)
        for r in range(1, R):
            for b in range(K):
                m = min(len(orders[0][b]), len(orders[r][b]))
                if orders[0][b][:m] != orders[r][b][:m]:
                    fail(f"epaxos host-exec: group {g} bucket {b}: replica "
                         f"{r}'s apply order diverges from replica 0's")
    cst, cns, chost, _ = ep_host_run(np, hcfg, sh, "cpu")
    n = compare_groups(torch, (hst, hns), (cst, cns), EP_HOST_GROUPS,
                       "epaxos host-exec")
    if chost.applied != host.applied:
        fail("epaxos host-exec: apply orders differ between card and CPU")
    log(f"epaxos host-exec G={EP_HOST_GROUPS}: {EP_HOST_TICKS} ticks "
        f"({EP_HOST_DRAIN} drain) in {hdt:.3f} s with "
        f"{EP_HOST_GROUPS * R} executors; {applied} instances applied, "
        f"per-bucket orders agree across replicas, exec_row == floors every "
        f"tick; equal to the CPU run ({n} state leaves + netstate, apply "
        f"orders) | {card}")
    log(f"epaxos: peak device memory {peak / 2**20:.1f} MiB "
        f"(max_memory_allocated over (a), (b) and the profile) | {card}")


# ---------------------------------------------------------- serving path --
def _serve_harness():
    """The card/CPU lockstep harnesses and the recorded-client helpers of
    ``tests/test_torch_cluster.py`` (jax-free; the live ``Cluster`` itself
    comes from ``summerset_tpu_torch.cluster``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import test_torch_cluster as harness

    return harness


def _demotions(cluster):
    """``leader_demotions`` per live replica (the health plane's count;
    a replica restarted by a durable reset counts from 0 again)."""
    return {str(me): rep.metrics.counter_value("leader_demotions")
            for me, rep in sorted(cluster.replicas.items())}


def _require_clean(cluster, what, demotions_ok=False):
    """No replica fault, every served replica's WAL opened native, and
    (unless the phase injected a fault) no leader demoted."""
    dem = _demotions(cluster)
    log(f"{what}: leader_demotions {dem}")
    if not demotions_ok and any(dem.values()):
        fail(f"{what}: the health plane demoted a leader with no fault "
             f"injected: {dem}")
    if cluster.faults():
        fail(f"{what}: replica bring-up failures or crashes: "
             f"{cluster.faults()}")
    py = sorted(me for me, rep in cluster.replicas.items()
                if not rep.wal.native)
    if py:
        from summerset_tpu_torch.host.storage import wal_build_error

        fail(f"{what}: replicas {py} opened the Python WAL "
             f"({wal_build_error()})")


class _LoadClient:
    """One closed-loop client thread over its own slice of the keys
    (key ``i`` belongs to client ``i % SERVE_CLIENTS``, so each key has
    one writer and a last acknowledged put), putting with probability
    ``put_share``.  A put's value is its short tag, padded to
    ``value_bytes`` when given.  Records every success as (time,
    latency, server it was connected to) in ``ok``, and every successful
    get as (time, latency, server, answered as a local read) in
    ``gets``.  With ``pin`` the client works against that server: a
    redirected put is issued again at the leader, then the client
    returns (after a timeout or refusal it stays where the failover took
    it for ``PIN_RETURN_S``).  With ``shared_gets`` a get reads any key,
    so it meets other clients' puts to it (EPaxos: conflicting commands
    at different replicas); puts stay on the client's own keys.  With
    ``zipf`` = s, key ``k`` is drawn with weight ``1 / (k + 1) ** s``
    from a seeded numpy generator (a hot-key mix).  A shed op (a sealed
    range mid-cutover) was never executed: it is counted in ``sheds`` and
    retried after its hint."""

    PIN_RETURN_S = 5.0

    def __init__(self, cluster, ci, stop, value_bytes=None, put_share=0.5,
                 pin=None, op_timeout=SERVE_OP_TIMEOUT, shared_gets=False,
                 zipf=None):
        import random
        import threading

        import numpy as np

        self.ci = ci
        self.stop = stop
        self.value_bytes = value_bytes
        self.put_share = put_share
        self.pin = pin
        self.op_timeout = op_timeout
        self.rng = random.Random(SEED + ci)
        self.keys = [f"key{k}" for k in range(SERVE_SHAPE["keys"])
                     if k % SERVE_CLIENTS == ci]
        self.get_keys = ([f"key{k}" for k in range(SERVE_SHAPE["keys"])]
                         if shared_gets else self.keys)
        self.zipf = None
        if zipf:
            def probs(keys):
                w = np.array([1.0 / (int(k[3:]) + 1) ** zipf for k in keys])
                return w / w.sum()

            self.nprng = np.random.default_rng(SEED + 1000 + ci)
            self.zipf = (probs(self.keys), probs(self.get_keys))
        self.sheds = 0
        self.acked = {}      # key -> last acknowledged put value
        self.later = {}      # key -> puts unacknowledged since then
        self.ok = []         # (t_done, latency_s, server)
        self.gets = []       # (t_done, latency_s, server, local)
        self.errors = 0
        self.cluster = cluster
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def _endpoint(self):
        from summerset_tpu_torch.client.endpoint import GenericEndpoint

        if self.pin is None:
            return self.cluster.endpoint()
        ep = GenericEndpoint(self.cluster.manager_addr, server_id=self.pin)
        ep.connect()
        return ep

    def _ticks(self):
        """Each in-process replica's tick (none for a cluster of
        processes: its budget stays ``op_timeout``)."""
        reps = getattr(self.cluster, "replicas", {})
        return {me: r.tick for me, r in list(reps.items())}

    def _stretch_budget(self, drv, mark):
        """Once a second, set the driver's per-op budget to
        ``op_timeout`` or ``OP_BUDGET_TICKS`` ticks at the fastest live
        replica's tick rate since the last mark, whichever is longer;
        returns the new mark."""
        t0, ticks0 = mark
        now = time.monotonic()
        if now - t0 < 1.0:
            return mark
        ticks = self._ticks()
        rate = max([(ticks[me] - ticks0[me]) / (now - t0)
                    for me in ticks if me in ticks0] or [0.0])
        if rate > 0:
            drv.timeout = max(self.op_timeout, OP_BUDGET_TICKS / rate)
        return now, ticks

    def run(self):
        from summerset_tpu_torch.client.drivers import DriverClosedLoop

        ep = self._endpoint()
        drv = DriverClosedLoop(ep, timeout=self.op_timeout)
        seq = 0
        t_fail = -1e9
        mark = (time.monotonic(), self._ticks())
        while not self.stop.is_set():
            mark = self._stretch_budget(drv, mark)
            if (self.pin is not None and ep.current != self.pin
                    and time.monotonic() - t_fail > self.PIN_RETURN_S):
                try:
                    ep.reconnect(self.pin)
                except Exception:
                    t_fail = time.monotonic()
            t0 = time.monotonic()
            is_put = self.rng.random() < self.put_share
            keys = self.keys if is_put else self.get_keys
            if self.zipf is None:
                key = self.rng.choice(keys)
            else:
                key = keys[int(self.nprng.choice(
                    len(keys), p=self.zipf[0 if is_put else 1]))]
            if is_put:
                val = f"c{self.ci}.{seq}"
                if self.value_bytes:
                    val = f"{val}.".ljust(self.value_bytes, "x")
                rep = drv.put(key, val)
                if rep.kind == "redirect" and self.pin is not None:
                    # a pinned client's put starts at a follower: it
                    # follows the redirect to the leader once
                    rep = drv.put(key, val)
                if rep.kind == "success":
                    self.acked[key] = val
                    self.later[key] = set()
                elif rep.kind not in ("redirect", "shed"):
                    # may or may not have executed
                    self.later.setdefault(key, set()).add(val)
            else:
                rep = drv.get(key)
            t1 = time.monotonic()
            if rep.kind == "success":
                self.ok.append((t1, t1 - t0, ep.current))
                if not is_put:
                    self.gets.append((t1, t1 - t0, ep.current, rep.local))
            elif rep.kind == "shed":
                self.sheds += 1
                time.sleep(max(rep.retry_after, 0.01))
            elif rep.kind != "redirect":
                self.errors += 1
                t_fail = time.monotonic()
                drv._failover(rep)
            seq += 1
        ep.leave()


def _stage_means(reps, prev):
    """Mean ``loop_stage_us`` per stage over the window since ``prev``
    (histogram copies), averaged over the replicas."""
    from summerset_tpu_torch.host.server import STAGES

    out = {}
    for st in STAGES:
        tot = cnt = 0
        for me, rep in reps.items():
            h = rep.metrics.hist("loop_stage_us", stage=st)
            if h is None:
                continue
            w = h.since(prev.get((me, st)))
            tot += w.total
            cnt += w.count
        if cnt:
            out[st] = round(tot / cnt, 1)
    return out


def _stage_marks(reps):
    from summerset_tpu_torch.host.server import STAGES

    marks = {}
    for me, rep in reps.items():
        for st in STAGES:
            h = rep.metrics.hist("loop_stage_us", stage=st)
            if h is not None:
                marks[(me, st)] = h.copy()
    return marks


#: kernel state rows a lagging group's diagnosis reads (those present)
_LAG_LEAVES = ("vote_bal", "vote_from", "vote_bar", "full_bar", "f2_lo",
               "f2_hi", "prep_trigger", "next_idx", "match_f", "match_from")


def _lag_state(rep, lag):
    """``debug_state`` of one replica cut to the lagging groups, with its
    kernel rows of ``_LAG_LEAVES`` in those groups."""
    groups = sorted({g for gs in lag.values() for g in gs})
    st = rep.debug_state()
    out = {k: ([v[g] for g in groups] if isinstance(v, list)
               and len(v) == len(rep.applied) else v)
           for k, v in st.items()}
    for k in _LAG_LEAVES:
        if k in rep.state:
            rows = rep._np_state(k)[groups, rep.me]
            out[k] = rows.tolist()
    return out


def _barrier_writes(cluster, what, groups, timeout=SERVE_OP_TIMEOUT):
    """One put into each of ``groups``, through up to 16 client threads.
    Followers learn commits lazily: one whose vote run at the leader's
    ballot starts above its commit bar (a restarted or resumed replica)
    stays behind in an idle group until the group's next write, whose
    accept makes the leader resend the run (the kernel's rule, as in the
    JAX package).  These writes are that next write."""
    import threading
    import zlib

    from summerset_tpu_torch.client.drivers import DriverClosedLoop

    G = SERVE_SHAPE["G"]
    want, keys, i = set(groups), {}, 0
    while len(keys) < len(want):
        k = f"barrier{i}"
        g = zlib.crc32(k.encode()) % G
        if g in want:
            keys.setdefault(g, k)
        i += 1
    todo = sorted(keys.values())
    errs = []

    def writer(part):
        ep = cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=timeout)
        try:
            for k in part:
                drv.checked_put(k, "b", retries=60)
        except AssertionError as e:
            errs.append(str(e))
        ep.leave()

    n = min(SERVE_CLIENTS, len(todo))
    ts = [threading.Thread(target=writer, args=(todo[c::n],), daemon=True)
          for c in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    if errs:
        fail(f"{what}: barrier writes failed: {errs[:3]}")
    return len(todo)


def _quiesce(cluster, what, rounds=4, settle=5.0, timeout=SERVE_OP_TIMEOUT):
    """With the clients stopped, wait until every replica has applied the
    same floors; a group still differing after ``settle`` seconds gets
    one barrier write, up to ``rounds`` times.  Returns the floors and
    the barrier writes it took."""
    writes = 0
    for r in range(rounds + 1):
        deadline = time.monotonic() + settle
        while True:
            floors = [list(r.applied) for r in cluster.replicas.values()]
            if len(floors) == cluster.n and all(f == floors[0]
                                                 for f in floors):
                return floors[0], writes
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
        top = [max(col) for col in zip(*floors)]
        lag = sorted({g for f in floors for g, (a, b) in
                      enumerate(zip(f, top)) if a != b})
        if r == rounds:
            break
        writes += _barrier_writes(cluster, what, lag, timeout)
    lagmap = {me: [g for g, (a, b) in enumerate(zip(r.applied, top))
                   if a != b][:8]
              for me, r in cluster.replicas.items()}
    fail(f"{what}: replicas did not converge on their applied floors "
         f"after {writes} barrier writes; lagging groups: {lagmap}; "
         f"states: {[_lag_state(r, lagmap) for r in cluster.replicas.values()]}")


def _check_agreement(cluster, clients, what, timeout=SERVE_OP_TIMEOUT):
    """Every replica's floors and KV are equal, and every key's value is
    its last acknowledged put (or a put issued after it that timed out:
    it may have executed)."""
    _floors, writes = _quiesce(cluster, what, timeout=timeout)
    views = {me: (list(rep.applied), dict(rep.statemach.snapshot_items()))
             for me, rep in sorted(cluster.replicas.items())}
    first = next(iter(views.values()))
    for me, v in views.items():
        if v != first:
            fail(f"{what}: replica {me}'s applied floors or KV differ "
                 "from replica 0's")
    kv = first[1]
    n = 0
    for c in clients:
        for key, val in c.acked.items():
            got = kv.get(key)
            if got != val and got not in c.later.get(key, ()):
                fail(f"{what}: key {key} holds {got!r}, last acked put "
                     f"{val!r}")
            n += 1
    return n, sum(first[0]), writes


def _await_load(clients, secs=30.0):
    """A second for the clients to connect, then until some client has
    completed an op (at most ``secs``), so that a timed window measures
    the running load and not the first ops' leader discovery."""
    time.sleep(1.0)
    deadline = time.monotonic() + secs
    while not any(c.ok for c in clients) and time.monotonic() < deadline:
        time.sleep(0.1)


def _window(np, cluster, clients, secs, what):
    """One timed window of the running load: ops/s and p50/p99 of the
    successes completed in it, ticks/s per replica and the stage means."""
    reps = dict(cluster.replicas)
    ticks0 = {me: r.tick for me, r in reps.items()}
    marks = _stage_marks(reps)
    t0 = time.monotonic()
    time.sleep(secs)
    t1 = time.monotonic()
    ticks = {str(me): round((r.tick - ticks0[me]) / (t1 - t0), 1)
             for me, r in sorted(reps.items())}
    lats = sorted(lat for c in clients for (t, lat, _s) in c.ok
                  if t0 <= t < t1)
    if not lats:
        fail(f"{what}: no operation succeeded in the {secs} s window "
             f"(ticks/s {ticks}, leader of group 0 {cluster.leader_of(0)}, "
             f"client errors {sum(c.errors for c in clients)}, successes "
             f"before it {sum(len(c.ok) for c in clients)}, faults "
             f"{cluster.faults()})")
    return {
        "secs": round(t1 - t0, 3),
        "ops_per_s": round(len(lats) / (t1 - t0), 1),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 3),
        "ticks_per_s": ticks,
        "stage_mean_us": _stage_means(reps, marks),
    }


def _pp_per_item(rep):
    """A replica's payload-plane egress bytes per payload sent."""
    return sum(rep.pp_bytes) / max(1, sum(rep.pp_items))


def _store_records(cluster):
    """Each replica's codeword store at the end of a run: values held,
    shard bytes held for the values the replicas proposed (walked on the
    host), and the lane counts of those rows."""
    keys = set()
    for rep in cluster.replicas.values():
        keys |= rep.origin
    out, lanes = {}, set()
    for me, rep in sorted(cluster.replicas.items()):
        store = rep.codewords
        nbytes = 0
        for g, vid in keys:
            held = store.shards_for(g, vid)
            if held is not None:
                for row in held[1].values():
                    nbytes += row.nbytes
                    lanes.add(int(row.shape[-1]))
        out[str(me)] = {
            "values": sum(store.size(g) for g in range(SERVE_SHAPE["G"])),
            "shard_bytes_of_proposed": nbytes,
        }
    return out, sorted(lanes)


def _record_leader_ticks(np, cluster, n, what):
    """The host inputs of ``n`` consecutive ticks of the group-0 leader
    under load: per tick the state its step reads and the inbox and
    input arrays it uploads (copied).  Returns (replica, records)."""
    import threading

    lead = cluster.leader_of(0)
    if lead is None and cluster.protocol == "EPaxos":
        lead = min(cluster.replicas)  # leaderless: every replica proposes
    if lead is None:
        fail(f"{what}: no group-0 leader to profile")
    rep = cluster.replicas[lead]
    recs, ups, done = [], [], threading.Event()
    orig_up, orig_disp = rep._upload, rep._dispatch

    def upload(arrays):
        ups.append({k: np.array(v, copy=True) for k, v in arrays.items()})
        return orig_up(arrays)

    def dispatch(inbox, inputs):
        if len(recs) < n and len(ups) >= 2:
            recs.append((rep.state, ups[-2], ups[-1]))
            if len(recs) == n:
                done.set()
        ups.clear()
        return orig_disp(inbox, inputs)

    rep._upload, rep._dispatch = upload, dispatch
    ok = done.wait(60)
    del rep._upload, rep._dispatch
    if not ok:
        fail(f"{what}: the leader ran fewer than {n} ticks in 60 s")
    return rep, recs


def _profile_serving_step(torch, rep, recs, card):
    """The recorded leader ticks' device seam replayed alone (the cluster
    stopped): each tick's inbox and inputs uploaded, the step and the
    prefetch of its host views, on the replica's stream, through
    ``profile_run``."""

    def run():
        for state, inbox_np, inputs_np in recs:
            inbox = rep._upload(inbox_np)
            inputs = rep._upload(inputs_np)
            with rep._on_stream(), torch.inference_mode():
                new_state, out, fx = rep.kernel.step(state, inbox, inputs)
                rep._prefetch_async(new_state, out, fx)

    return profile_run(torch, run, len(recs),
                       "serving step (group-0 leader, replayed)", card)


def _serve_run(torch, np, card, protocol, secs, fault_plan,
               read_back=False, config=None, value_bytes=None,
               profile=False, pinned=False, shared_gets=False,
               hist_keys=3, snapshot=False, replicated=True,
               op_timeout=SERVE_OP_TIMEOUT, quiet_plan=None):
    """One live 3-replica cluster on the card: a timed load window of
    clients putting ``value_bytes`` values (``_LoadClient``), then
    ``fault_plan(cluster, clients)`` under load with a 3-client, 3-key
    history recorded, then (``read_back``) every acked key read back, the
    agreement and the history checks.  The JSON line also holds the
    group-0 leader's payload bytes per payload at the end of the window
    and the ``bitslice_gf256`` launches in the window, per leader tick.
    With ``profile``, ``PROFILE_TICKS`` leader ticks after the window are
    recorded and, once the cluster has stopped, replayed under the
    profiler (``_profile_serving_step``; ``line["profile"]``).
    ``pinned`` pins the load and history clients to the replicas in
    turn (``shared_gets``: see ``_LoadClient``), the history runs over
    ``hist_keys`` keys; with ``snapshot``, once the checks passed, a
    manager ``take_snapshot``, a restart of every replica from snapshot
    plus tail and every acked key read back (``_snapshot_restart``;
    ``line["snapshot"]``).  ``replicated`` False (RepNothing) checks the
    serving replica's KV alone, not agreement across replicas.
    ``op_timeout`` is every client's budget per operation.
    ``quiet_plan(cluster, clients)``, if given, runs once the load and
    history clients have stopped, before the read-back; its record joins
    the fault plan's."""
    import shutil
    import tempfile
    import threading

    harness = _serve_harness()
    from summerset_tpu_torch.cluster import Cluster
    from summerset_tpu_torch.ops import rscoding as rs
    from summerset_tpu_torch.utils.linearize import check_history

    sh = SERVE_SHAPE
    tmp = tempfile.mkdtemp(prefix="serve_")
    t_up = time.perf_counter()
    cluster = Cluster(
        protocol, sh["R"], tmp, tick=sh["tick"], num_groups=sh["G"],
        window=sh["W"], device=DEV, settle=2.0,
        config=dict(SERVE_BASE_CFG, **(config or {})),
    )
    try:
        up_s = time.perf_counter() - t_up
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        stop = threading.Event()
        clients = [_LoadClient(cluster, ci, stop, value_bytes,
                               pin=ci % sh["R"] if pinned else None,
                               shared_gets=shared_gets,
                               op_timeout=op_timeout)
                   for ci in range(SERVE_CLIENTS)]
        time.sleep(1.0)  # clients connected and past their first op
        n0 = rs.bitslice_gf256.launches
        w = _window(np, cluster, clients, secs, f"serving {protocol}")
        w_launches = rs.bitslice_gf256.launches - n0
        prof = (_record_leader_ticks(np, cluster, PROFILE_TICKS,
                                     f"serving {protocol}")
                if profile else None)
        lead = cluster.leader_of(0)
        pp_per = (_pp_per_item(cluster.replicas[lead])
                  if lead is not None else None)
        lead_ticks = (w["ticks_per_s"].get(str(lead), 0.0) * w["secs"]
                      if lead is not None else 0.0)
        stages = w["stage_mean_us"]
        host = sum(v for k, v in stages.items() if k != "device_wait")
        peak = (torch.cuda.max_memory_allocated() / 2**20
                if DEV == "cuda" else 0.0)
        # the history clients run through the faults
        hist_ops, hist_stop = [], threading.Event()
        hist = [threading.Thread(target=harness.history_worker,
                                 args=(cluster, ci, hist_ops, hist_stop),
                                 kwargs={"timeout": op_timeout,
                                         "keys": hist_keys,
                                         "pin": ci if pinned else None},
                                 daemon=True) for ci in range(3)]
        for t in hist:
            t.start()
        faults = fault_plan(cluster, clients)
        stop.set()
        for c in clients:
            c.thread.join(timeout=30)
        # the history clients run on alone until the history is big
        # enough to be worth checking (bounded)
        deadline = time.monotonic() + 60
        while len(hist_ops) < SERVE_HISTORY_OPS \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        hist_stop.set()
        for t in hist:
            t.join(timeout=30)
        if quiet_plan is not None:
            faults.update(quiet_plan(cluster, clients))
        if read_back:
            faults["read_back_keys"] = _read_back(
                cluster, clients, f"serving {protocol}", op_timeout)
        if replicated:
            n_keys, applied, writes = _check_agreement(
                cluster, clients, f"serving {protocol}", op_timeout)
        else:
            n_keys, applied, writes = _check_serving_kv(
                cluster, clients, f"serving {protocol}")
        if len(hist_ops) < SERVE_HISTORY_OPS:
            fail(f"serving {protocol}: history of {len(hist_ops)} ops, "
                 f"fewer than {SERVE_HISTORY_OPS}")
        ok, diag = check_history(hist_ops)
        if not ok:
            fail(f"serving {protocol}: history not linearizable: {diag}")
        _require_clean(cluster, f"serving {protocol}")
        # followers whose lost accept NACK the server repeated (read
        # before the snapshot restart starts every count from 0)
        renacks = {str(me): rep.metrics.counter_value("stall_renacks")
                   for me, rep in sorted(cluster.replicas.items())}
        snap = (_snapshot_restart(cluster, clients, f"serving {protocol}",
                                  op_timeout) if snapshot else None)
        extra = {}
        if next(iter(cluster.replicas.values())).codewords is not None:
            stores, lanes = _store_records(cluster)
            extra = {"codeword_stores": stores, "shard_lanes": lanes}
        line = {
            "serving": protocol, "groups": sh["G"], "replicas": sh["R"],
            "window": sh["W"], "clients": SERVE_CLIENTS,
            "keys": sh["keys"], "value_bytes": value_bytes, **w,
            "device_wait_share": round(
                stages.get("device_wait", 0.0)
                / max(host + stages.get("device_wait", 0.0), 1e-9), 4),
            "max_memory_allocated_mib": round(peak, 1),
            "bring_up_s": round(up_s, 2), "faults": faults,
            "acked_keys_checked": n_keys, "applied_total": applied,
            "quiesce_barrier_writes": writes,
            "history_ops": len(hist_ops),
            "leader_pp_bytes_per_payload": (round(pp_per, 1)
                                            if pp_per is not None else None),
            "bitslice_launches_window": w_launches,
            "leader_demotions": _demotions(cluster),
            "stall_renacks": renacks,
            "launches_per_leader_tick": round(
                w_launches / max(lead_ticks, 1e-9), 3),
            **extra, "card": card,
        }
        if snap is not None:
            line["snapshot"] = snap
        log(json.dumps(line))
    finally:
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if prof is not None:
        line["profile"] = _profile_serving_step(torch, *prof, card)
        log(json.dumps({"serving_profile": protocol,
                        "ticks": PROFILE_TICKS, **line["profile"],
                        "card": card}))
    return line


def _pause_leader(cluster, clients, what, until=None):
    """Pause the group-0 leader (at least SERVE_PAUSE_S) until every load
    client has a success from another server (and ``until()`` holds),
    then resume it; returns the seconds until the last client
    recovered."""
    leader = cluster.leader_of(0)
    if leader is None:
        fail(f"{what}: no leader of group 0 before the pause")
    t_pause = time.monotonic()
    cluster.ctrl("pause_servers", servers=[leader], timeout=60)
    deadline = t_pause + SERVE_FAILOVER_MAX_S
    while True:
        done = [
            next((t for t, _lat, s in c.ok if t > t_pause and s != leader),
                 None) for c in clients
        ]
        if (all(d is not None for d in done)
                and time.monotonic() - t_pause >= SERVE_PAUSE_S
                and (until is None or until())):
            break
        if time.monotonic() > deadline:
            cluster.ctrl("resume_servers", servers=[leader], timeout=60)
            fail(f"{what}: {sum(d is None for d in done)} of "
                 f"{len(clients)} clients got no success from a new "
                 f"leader within {SERVE_FAILOVER_MAX_S} s of pausing "
                 f"replica {leader}"
                 + ("" if until is None else f" (or {until.__doc__})"))
        time.sleep(0.1)
    new = cluster.leader_of(0)
    cluster.ctrl("resume_servers", servers=[leader], timeout=60)
    time.sleep(1.0)
    return {"paused": leader, "new_leader": new,
            "recovered_s": round(max(done) - t_pause, 3)}


def _pause_and_resets(protocol):
    """The fault plan: the group-0 leader paused and resumed, then a
    durable reset of a follower and then of the leader."""
    what = f"serving {protocol}"

    def plan(cluster, clients):
        out = {"pause": _pause_leader(cluster, clients, what)}
        leader = cluster.leader_of(0)
        follower = next(me for me in sorted(cluster.replicas)
                        if me != leader)
        for victim in (follower, leader):
            t = time.monotonic()
            rep = cluster.ctrl("reset_servers", servers=[victim],
                               timeout=300)
            if rep.done != [victim]:
                fail(f"{what}: durable reset of {victim} not "
                     f"acknowledged ({rep.done})")
            kind = "leader" if victim == leader else "follower"
            out[f"reset_{kind}_s"] = round(time.monotonic() - t, 3)
        time.sleep(2.0)
        return out

    return plan


def _raft_faults(cluster, clients):
    return {"pause": _pause_leader(cluster, clients, "serving Raft")}


def _read_back(cluster, clients, what, timeout=SERVE_OP_TIMEOUT):
    """Every key's last acknowledged value reads back through the
    cluster (after the durable resets).  Each client's keys are read by
    readers of at most ``READ_BACK_CHUNK`` keys each, so a read-back
    takes a few gets' time, not one per key of the busiest client."""
    import threading

    from summerset_tpu_torch.client.drivers import DriverClosedLoop

    bad = []

    def reader(c, items):
        ep = cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=timeout)
        for key, val in items:
            for _ in range(40):
                rep = drv.get(key)
                if rep.kind == "success":
                    got = rep.result.value if rep.result else None
                    if got != val and got not in c.later.get(key, ()):
                        bad.append((key, val, got))
                    break
                drv._retry_pause(rep)
            else:
                bad.append((key, val, "no reply"))
        ep.leave()

    ts = []
    for c in clients:
        items = list(c.acked.items())
        for i in range(0, len(items), READ_BACK_CHUNK):
            ts.append(threading.Thread(
                target=reader, args=(c, items[i:i + READ_BACK_CHUNK]),
                daemon=True))
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    if bad:
        fail(f"{what}: {len(bad)} keys did not read back their last acked "
             f"value, e.g. {bad[:3]}")
    return sum(len(c.acked) for c in clients)


def _check_serving_kv(cluster, clients, what):
    """RepNothing replicates nothing: the serving replica's KV holds every
    key's last acknowledged put (or a later one that timed out)."""
    serving = cluster.leader_of(0)
    if serving is None:
        fail(f"{what}: no serving replica")
    rep = cluster.replicas[serving]
    kv = dict(rep.statemach.snapshot_items())
    n = 0
    for c in clients:
        for key, val in c.acked.items():
            got = kv.get(key)
            if got != val and got not in c.later.get(key, ()):
                fail(f"{what}: key {key} holds {got!r} at the serving "
                     f"replica, last acked put {val!r}")
            n += 1
    return n, sum(rep.applied), 0


def _snapshot_restart(cluster, clients, what, timeout=SERVE_OP_TIMEOUT):
    """With the clients stopped: a ``take_snapshot`` through the manager
    (every replica answers; the seconds, and each replica's WAL bytes
    before and after, each of which must shrink), then a durable reset
    of every replica, one at a time (each recovers from snapshot plus
    WAL tail), and every acked key read back.  Returns the record, with
    the ``bitslice_gf256`` launches from the restart through the
    read-back (the codeword family rebuilds values from shards)."""
    from summerset_tpu_torch.ops import rscoding as rs

    reps = dict(cluster.replicas)
    before = {str(me): rep.wal.size for me, rep in sorted(reps.items())}
    t0 = time.monotonic()
    rep = cluster.ctrl("take_snapshot", timeout=300)
    snap_s = time.monotonic() - t0
    if sorted(rep.done) != sorted(reps):
        fail(f"{what}: take_snapshot answered by {rep.done}, not "
             f"{sorted(reps)}")
    after = {str(me): r.wal.size for me, r in sorted(reps.items())}
    if not all(after[k] < before[k] for k in before):
        fail(f"{what}: a WAL did not shrink: {before} -> {after}")
    snaps = {str(me): os.path.getsize(r.snap_path)
             for me, r in sorted(reps.items())}
    n0 = rs.bitslice_gf256.launches
    t1 = time.monotonic()
    rep = cluster.ctrl("reset_servers", timeout=900)
    if sorted(rep.done) != sorted(reps):
        fail(f"{what}: restart of every replica acknowledged by "
             f"{rep.done}")
    restart_s = time.monotonic() - t1
    t2 = time.monotonic()
    keys = _read_back(cluster, clients, f"{what} after the snapshot "
                      "restart", timeout)
    read_s = time.monotonic() - t2
    if cluster.faults():
        fail(f"{what}: replica faults after the snapshot restart: "
             f"{cluster.faults()}")
    out = {"snapshot_s": round(snap_s, 3), "wal_bytes_before": before,
           "wal_bytes_after": after, "snapshot_bytes": snaps,
           "restart_all_s": round(restart_s, 3),
           "read_back_s": round(read_s, 3), "read_back_keys": keys,
           "bitslice_launches_after_restart":
               rs.bitslice_gf256.launches - n0}
    log(f"{what}: snapshot {out['snapshot_s']} s, WAL bytes {before} -> "
        f"{after}; every replica restarted from snapshot + tail in "
        f"{out['restart_all_s']} s, {keys} acked keys read back in "
        f"{out['read_back_s']} s")
    return out


def phase_serving(torch, np, card):
    """Phase 12: the port's manager, three ServerReplica threads and 16
    closed-loop clients in this process, on the card; then the
    1-replica card-against-CPU check."""
    import tempfile

    from summerset_tpu_torch.ops import rscoding as rs

    sh = SERVE_SHAPE
    log(f"== phase 12: serving, {sh['G']} groups x {sh['R']} replicas, "
        f"W={sh['W']}, {SERVE_CLIENTS} clients (MultiPaxos, Raft, card vs "
        "cpu)")
    t_phase = time.perf_counter()
    rs.bitslice_gf256.launches = 0
    mp = _serve_run(torch, np, card, "MultiPaxos", SERVE_SECS,
                    _pause_and_resets("MultiPaxos"), read_back=True,
                    profile=True, snapshot=True)
    raft = _serve_run(torch, np, card, "Raft", SERVE_RAFT_SECS,
                      _raft_faults)
    harness = _serve_harness()
    runs = {}
    for dev in (DEV, "cpu"):
        for pipeline in (False, True):
            with tempfile.TemporaryDirectory(prefix="seq_") as d:
                runs[(dev, pipeline)] = harness.sequential_puts(
                    d, dev, pipeline, groups=SERVE_SHAPE["G"],
                    window=SERVE_SHAPE["W"])
    for pipeline in (False, True):
        mode = "pipelined" if pipeline else "serial"
        a, b = runs[(DEV, pipeline)], runs[("cpu", pipeline)]
        if sum(a["applied"]) != 24:
            fail(f"serving {DEV} vs cpu ({mode}): {sum(a['applied'])} of "
                 "24 puts applied")
        for part in ("digest", "kv", "applied", "wal"):
            if a[part] != b[part]:
                fail(f"serving {DEV} vs cpu ({mode}): {part} differs")
    log(f"serving: 24 sequential puts on 1 replica x {SERVE_SHAPE['G']} "
        f"groups, {DEV} vs cpu, serial and pipelined: durable digests, KV, "
        f"floors and WAL records ({len(runs[(DEV, True)]['wal'])} / "
        f"{len(runs[(DEV, False)]['wal'])}) equal | {card}")
    for (dev, pipeline), r in sorted(runs.items()):
        log(json.dumps({
            "serving_1_replica": dev, "pipeline": pipeline,
            "groups": SERVE_SHAPE["G"],
            "ticks_per_s": round(r["ticks_per_s"], 1),
            "stage_mean_us": {k: round(v, 1)
                              for k, v in r["stage_mean_us"].items()},
            "card": card,
        }))
    log(f"bitslice_gf256 launches in phase 12 (no codeword plane): "
        f"{rs.bitslice_gf256.launches}; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return mp, raft


# ------------------------------------------------- codeword serving path --
def _sends(cluster):
    """Proposals sent as shard rows and as full copies, summed over the
    replicas (``proposals_sent{copy}``)."""
    out = {"shards": 0, "full": 0}
    for rep in list(cluster.replicas.values()):
        for k in out:
            out[k] += rep.metrics.counter_value("proposals_sent", copy=k)
    return out


def _craft_faults(cluster, clients):
    """CRaft: the group-0 leader paused until the new leaders, seeing a
    dead peer, ship full copies; after the resume, shard sends again."""
    what = "serving CRaft"
    s0 = _sends(cluster)

    def fell_back():
        """a full-copy send by a new leader"""
        return _sends(cluster)["full"] > s0["full"]

    pause = _pause_leader(cluster, clients, what, until=fell_back)
    s1 = _sends(cluster)
    deadline = time.monotonic() + SERVE_RESUME_MAX_S
    while _sends(cluster)["shards"] <= s1["shards"]:
        if time.monotonic() > deadline:
            fail(f"{what}: no shard send within {SERVE_RESUME_MAX_S} s of "
                 "the resume")
        time.sleep(0.2)
    time.sleep(1.0)
    s2 = _sends(cluster)
    return {"pause": pause,
            "full_copies_in_pause": s1["full"] - s0["full"],
            "shard_sends_before_pause": s0["shards"],
            "shard_sends_after_resume": s2["shards"] - s1["shards"]}


def _crossword_faults(cluster, clients):
    """Crossword: the group-0 leader paused and resumed; the widths the
    replicas' adaptive policies chose, in ticks per width."""
    pause = _pause_leader(cluster, clients, "serving Crossword")
    d = next(iter(cluster.replicas.values())).kernel.data_shards
    widths = {str(w): sum(rep.metrics.counter_value("spr_choice_ticks",
                                                    spr=w)
                          for rep in list(cluster.replicas.values()))
              for w in range(1, d + 1)}
    if not sum(widths.values()):
        fail("serving Crossword: no adaptive width was chosen")
    return {"pause": pause, "spr_choice_ticks": widths}


def _wire_sizes(rs, mp, value_bytes):
    """Pickled bytes of one put's payload sent to a follower as a shard
    send (RS(2,1) on the card, the mean over the two followers' shards)
    and as a full copy, at phase 12's values (``mp``, its MultiPaxos
    line when phase 12 ran, gives the leader's metered bytes per payload
    beside them) and at ``value_bytes``."""
    import pickle

    from summerset_tpu_torch.host.messages import ApiRequest, ShardPayload
    from summerset_tpu_torch.host.statemach import Command

    code = rs.RSCode(2, 1, device=DEV)
    out = {"phase12_multipaxos_leader_bytes_per_payload":
           mp["leader_pp_bytes_per_payload"] if mp else None}
    for name, val in (("phase12_value", "c15.123456"),
                      (f"{value_bytes}_B", "x" * value_bytes)):
        reqs = [(15, ApiRequest("req", req_id=123456,
                                cmd=Command("put", "key1023", val)))]
        full = len(pickle.dumps({(1023, 70001): reqs},
                                pickle.HIGHEST_PROTOCOL))
        n, cw = rs.encode_payload(code, pickle.dumps(reqs))
        shard = sum(len(pickle.dumps({(1023, 70001): ShardPayload(
            n, {s: cw[s]})}, pickle.HIGHEST_PROTOCOL)) for s in (1, 2)) / 2
        out[name] = {"full_copy": full, "shard_send": shard,
                     "ratio": round(shard / full, 4)}
    return out


def serving_kernel_numbers(torch, np, rs, card, lanes):
    """The kernel's time per launch at the serving path's shapes: one
    value's RS(2,1) encode ``[1, 2, L]`` and its decode from shards
    {1, 2}, at each lane count ``L`` in ``lanes``, each held bit for bit
    against the plain version, timed with CUDA events beside its bound
    and the plain version's time.  Returns the max_abs_err."""
    code = rs.RSCode(2, 1, device=DEV)
    rng = np.random.default_rng(SEED + 13)
    err = 0
    for L in lanes:
        x = torch.from_numpy(rng.integers(-2**31, 2**31, size=(1, 2, L),
                                          dtype=np.int32)).to(DEV)
        for name, tbl in (("encode", code._parity_tbl),
                          ("decode", code._decode_tbl((1, 2)))):
            got = rs.bitslice_gf256(tbl, x)
            want = rs._bitslice_matmul_plain(tbl, x)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"serving {name} [1, 2, {L}]: kernel != plain")
            err = max(err, abs_err(got, want))
            rows = int(tbl.shape[0])
            k_ms = time_ms(torch, lambda: rs.bitslice_gf256(tbl, x), 200)
            p_ms = time_ms(torch, lambda: rs._bitslice_matmul_plain(tbl, x),
                           50)
            b_ms, b_by = bound_ms(rows, 2, 1, L)
            log(f"serving {name} [1,2,{L}] -> [1,{rows},{L}]: kernel "
                f"{k_ms:.4f} ms/launch plain {p_ms:.4f} ms bound "
                f"{b_ms:.3e} ms ({b_by}) share {b_ms / k_ms:.2e} | {card}")
    return err


def phase_codeword_serving(torch, np, card, mp=None):
    """Phase 13: RSPaxos, CRaft and Crossword served by phase 12's
    harness on the card at 3000 B puts, the codeword plane encoding with
    ``bitslice_gf256``, beside a MultiPaxos run at the same load; then
    the card-against-CPU lockstep and the kernel's time per launch at the
    serving shapes.  ``mp`` is phase 12's MultiPaxos line, if it ran."""
    import tempfile

    from summerset_tpu_torch.ops import rscoding as rs

    sh = SERVE_SHAPE
    log(f"== phase 13: codeword serving, {sh['G']} groups x {sh['R']} "
        f"replicas, W={sh['W']}, {SERVE_CLIENTS} clients, RS(2,1) "
        f"{SERVE_CW_VALUE_BYTES} B puts (MultiPaxos baseline, RSPaxos, "
        "CRaft, Crossword, card vs cpu)")
    t_phase = time.perf_counter()
    vb = SERVE_CW_VALUE_BYTES
    base = _serve_run(torch, np, card, "MultiPaxos", SERVE_CW_SECS,
                      lambda cluster, clients: {}, value_bytes=vb)
    launches, lines = {}, {}
    for proto, secs, plan, read_back in (
            ("RSPaxos", SERVE_SECS, _pause_and_resets("RSPaxos"), True),
            ("CRaft", SERVE_CW_SECS, _craft_faults, False),
            ("Crossword", SERVE_CW_SECS, _crossword_faults, False)):
        rs.bitslice_gf256.launches = 0
        lines[proto] = _serve_run(torch, np, card, proto, secs, plan,
                                  read_back=read_back, config=SERVE_CW_CFG,
                                  value_bytes=vb,
                                  snapshot=proto == "RSPaxos")
        launches[proto.lower()] = rs.bitslice_gf256.launches
        if launches[proto.lower()] == 0:
            fail(f"serving {proto}: the codeword path never launched "
                 "bitslice_gf256")
    launches["serving"] = sum(launches.values())
    log("bitslice_gf256 launches in phase 13 by path: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    after = lines["RSPaxos"]["snapshot"]["bitslice_launches_after_restart"]
    if DEV == "cuda" and not after:
        fail("serving RSPaxos: no bitslice_gf256 launch after the restart "
             "from the snapshot (values come back through shards)")
    log(f"bitslice_gf256 launches after RSPaxos's snapshot restart "
        f"(within rspaxos above): {after}")
    rsp = lines["RSPaxos"]["leader_pp_bytes_per_payload"]
    full = base["leader_pp_bytes_per_payload"]
    if rsp is None or full is None:
        fail(f"serving at {vb} B values: no group-0 leader to meter "
             f"(RSPaxos {rsp}, MultiPaxos {full})")
    ratio = rsp / full
    log(f"shard economy at {vb} B values: RSPaxos leader {rsp} "
        f"bytes/payload, MultiPaxos leader {full}: {ratio:.3f}x")
    if not ratio < 0.75:
        fail(f"serving RSPaxos: {rsp} bytes per payload against "
             f"MultiPaxos's {full} at {vb} B values: not shard-sized")
    log("wire bytes of one put's payload, RS(2,1) on the card, shard send "
        "/ full copy: " + json.dumps(_wire_sizes(rs, mp, vb)))

    harness = _serve_harness()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cwlock_") as d:
        try:
            lock = harness.card_cpu_lockstep(d, DEV)
        except AssertionError as e:
            fail(f"codeword serving {DEV} vs cpu: {e}")
    if (not lock["rebuilt"] or not lock["shard_frames"]
            or len(lock["leaders"]) < 2):
        fail(f"codeword serving {DEV} vs cpu: the schedule did not move "
             f"leadership and rebuild from shards: {lock}")
    if DEV == "cuda" and not lock["launches"]:
        fail("codeword serving card vs cpu: the card replicas never "
             "launched bitslice_gf256")
    log(f"codeword serving: 3 RSPaxos replicas on {DEV} == 3 on cpu for "
        f"{lock['ticks']} lockstep ticks (state, frames, shard records by "
        f"batch, WAL, floors, KV, replies), leaders {lock['leaders']}, "
        f"{lock['rebuilt']} rebuilds from shards, {lock['launches']} card "
        f"launches (not counted above), "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    # the smallest and the largest shard rows the RSPaxos run held (a
    # get's batch and a put's)
    lanes = lines["RSPaxos"].get("shard_lanes") or [128]
    err = serving_kernel_numbers(torch, np, rs, card,
                                 sorted({min(lanes), max(lanes)}))
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches["serving"], "max_abs_err": err}


# ------------------------------------------------------ lease serving --
def _get_records(np, clients, t0, t1, leader):
    """The window's successful gets: per server the share answered as a
    local read, and p50/p99 of local and of logged gets."""
    gets = [g for c in clients for g in c.gets if t0 <= g[0] < t1]
    per = {}
    for _t, _lat, srv, loc in gets:
        n, k = per.get(srv, (0, 0))
        per[srv] = (n + 1, k + int(loc))

    def pct(lats):
        if not lats:
            return None
        return [round(float(np.percentile(lats, q)) * 1e3, 3)
                for q in (50, 99)]

    return {
        "gets": len(gets),
        "local_share_by_server": {
            str(srv): round(k / n, 4) for srv, (n, k) in sorted(per.items())
        },
        "local_gets_by_server": {
            str(srv): k for srv, (n, k) in sorted(per.items())
        },
        "local_get_p50_p99_ms": pct([g[1] for g in gets if g[3]]),
        "logged_get_p50_p99_ms": pct([g[1] for g in gets if not g[3]]),
        "leader": leader,
    }


def _lease_run(torch, np, card, protocol, config, conf_at, pause):
    """One live 3-replica lease-plane cluster on the card at phase 12's
    shape: the conf change (``conf_at``: "leader", "follower" or None)
    by a client, timed; 16 read-mostly clients pinned to the replicas in
    turn for a timed window; 3 pinned history clients through the
    leader pause (``pause``) or a quiet stretch; then every acked key
    read back, agreement, the history (with local reads in it)
    linearizable, local reads where the protocol serves them, no
    replica fault."""
    import shutil
    import tempfile
    import threading

    harness = _serve_harness()
    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.client.endpoint import GenericEndpoint
    from summerset_tpu_torch.cluster import Cluster
    from summerset_tpu_torch.utils.linearize import check_history

    what = f"lease serving {protocol}"
    sh = SERVE_SHAPE
    tmp = tempfile.mkdtemp(prefix="lease_")
    cluster = Cluster(
        protocol, sh["R"], tmp, tick=sh["tick"], num_groups=sh["G"],
        window=sh["W"], device=DEV, settle=2.0, config=config,
    )
    try:
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        leader = None
        deadline = time.monotonic() + SERVE_FAILOVER_MAX_S
        while leader is None:
            leader = cluster.leader_of(0)
            if time.monotonic() > deadline:
                fail(f"{what}: no leader of group 0")
            time.sleep(0.1)
        conf_s, conf = None, None
        if conf_at is not None:
            sid = leader if conf_at == "leader" else next(
                s for s in sorted(cluster.replicas) if s != leader)
            ep = GenericEndpoint(cluster.manager_addr, server_id=sid)
            ep.connect()
            try:
                t = time.monotonic()
                rep = DriverClosedLoop(ep, timeout=SERVE_OP_TIMEOUT) \
                    .conf_change({"responders": [0, 1, 2]})
                conf_s = round(time.monotonic() - t, 3)
                if rep.kind != "success":
                    fail(f"{what}: conf change failed: {rep}")
                conf = harness.query_conf(ep).conf
            finally:
                ep.leave()
            if not conf or sorted(conf["responders"]) != [0, 1, 2]:
                fail(f"{what}: the manager holds conf {conf}")
        stop = threading.Event()
        clients = [_LoadClient(cluster, ci, stop,
                               put_share=SERVE_LEASE_PUT_SHARE,
                               pin=ci % sh["R"],
                               op_timeout=SERVE_LEASE_OP_TIMEOUT)
                   for ci in range(SERVE_CLIENTS)]
        time.sleep(1.0)
        t0 = time.monotonic()
        w = _window(np, cluster, clients, SERVE_LEASE_SECS[protocol], what)
        gets = _get_records(np, clients, t0, t0 + w["secs"], leader)
        peak = (torch.cuda.max_memory_allocated() / 2**20
                if DEV == "cuda" else 0.0)
        hist_ops, hist_stop, hist_local = [], threading.Event(), [0]
        hist = [threading.Thread(
            target=harness.history_worker,
            args=(cluster, ci, hist_ops, hist_stop),
            kwargs={"timeout": SERVE_LEASE_OP_TIMEOUT, "seed": SEED,
                    "pin": ci % sh["R"],
                    "put_share": LEASE_HISTORY_PUT_SHARE,
                    "n_local": hist_local},
            daemon=True) for ci in range(3)]
        for t in hist:
            t.start()
        faults = {}
        if pause:
            faults["pause"] = _pause_leader(cluster, clients, what)
        else:
            time.sleep(2.0)
        stop.set()
        for c in clients:
            c.thread.join(timeout=30)
        deadline = time.monotonic() + 60
        while ((len(hist_ops) < SERVE_HISTORY_OPS or not hist_local[0])
               and time.monotonic() < deadline):
            time.sleep(0.2)
        hist_stop.set()
        for t in hist:
            t.join(timeout=30)
        n_read = _read_back(cluster, clients, what, SERVE_LEASE_OP_TIMEOUT)
        if not n_read:
            fail(f"{what}: no put was acknowledged, so no key reads back")
        n_keys, applied, writes = _check_agreement(
            cluster, clients, what, SERVE_LEASE_OP_TIMEOUT)
        if len(hist_ops) < SERVE_HISTORY_OPS:
            fail(f"{what}: history of {len(hist_ops)} ops, fewer than "
                 f"{SERVE_HISTORY_OPS}")
        if not hist_local[0]:
            fail(f"{what}: the history holds no local read")
        ok, diag = check_history(hist_ops)
        if not ok:
            fail(f"{what}: history not linearizable: {diag}")
        _require_clean(cluster, what)
        loc = {int(k): v for k, v in gets["local_gets_by_server"].items()}
        at_leader = loc.get(leader, 0)
        at_followers = sum(v for k, v in loc.items() if k != leader)
        if protocol == "MultiPaxos":
            if not at_leader or at_followers:
                fail(f"{what}: local gets {loc}: want them at the leader "
                     f"{leader} only")
        elif not at_followers:
            fail(f"{what}: no follower served a local get ({loc})")
        line = {
            "lease_serving": protocol, "groups": sh["G"],
            "replicas": sh["R"], "window": sh["W"],
            "clients": SERVE_CLIENTS, "keys": sh["keys"],
            "put_share": SERVE_LEASE_PUT_SHARE, "config": config,
            "conf_change_s": conf_s, "conf": conf, **w, **gets,
            "max_memory_allocated_mib": round(peak, 1), "faults": faults,
            "read_back_keys": n_read, "acked_keys_checked": n_keys,
            "applied_total": applied, "quiesce_barrier_writes": writes,
            "history_ops": len(hist_ops),
            "history_local_gets": hist_local[0], "card": card,
        }
        log(json.dumps(line))
        return line
    finally:
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_lease_serving(torch, np, card):
    """Phase 14: QuorumLeases, MultiPaxos with leader leases and Bodega
    served on the card, read-mostly, then QuorumLeases' card-against-CPU
    lockstep through the conf change and the first local gets."""
    import tempfile

    from summerset_tpu_torch.ops import rscoding as rs

    sh = SERVE_SHAPE
    log(f"== phase 14: lease serving, {sh['G']} groups x {sh['R']} "
        f"replicas, W={sh['W']}, {SERVE_CLIENTS} pinned clients, "
        f"{int(SERVE_LEASE_PUT_SHARE * 100)}% puts (QuorumLeases, "
        "MultiPaxos leader leases, Bodega, card vs cpu)")
    t_phase = time.perf_counter()
    rs.bitslice_gf256.launches = 0
    lines = {
        "QuorumLeases": _lease_run(torch, np, card, "QuorumLeases", None,
                                   "leader", pause=True),
        "MultiPaxos": _lease_run(torch, np, card, "MultiPaxos",
                                 {"leader_leases": True}, None,
                                 pause=False),
        "Bodega": _lease_run(torch, np, card, "Bodega", SERVE_BODEGA_CFG,
                             "follower", pause=False),
    }
    harness = _serve_harness()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="leaselock_") as d:
        try:
            lock = harness.card_cpu_lease_lockstep(d, DEV)
        except AssertionError as e:
            fail(f"lease serving {DEV} vs cpu: {e}")
    if lock["conf_ok"] != 1 or not sum(lock["local"][1:]):
        fail(f"lease serving {DEV} vs cpu: no conf change or no follower "
             f"local get in the schedule: {lock}")
    log(f"lease serving: 3 QuorumLeases replicas on {DEV} == 3 on cpu for "
        f"{lock['ticks']} lockstep ticks through the conf change (state, "
        f"frames, WAL, floors, KV, replies with local flags), local gets "
        f"per replica {lock['local']}, {time.perf_counter() - t0:.1f} s "
        f"| {card}")
    if rs.bitslice_gf256.launches:
        fail(f"lease serving launched bitslice_gf256 "
             f"{rs.bitslice_gf256.launches} times (no codeword plane)")
    log(f"bitslice_gf256 launches in phase 14 (no codeword plane): 0; "
        f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return lines


# ------------------------------------------------ process per replica --
def _wal_applies(harness, path):
    """A replica's apply records from its WAL: {group: {slot: batch}}."""
    out = {}
    for e in harness.read_wal(path):
        if e and e[0] == "vote":
            continue
        g, slot, _vid, batch = e
        out.setdefault(g, {})[slot] = batch
    return out


def phase_process_cluster(np, card, mp=None):
    """Phase 15: phase 12's MultiPaxos cluster as one process per
    replica: ``python -m summerset_tpu_torch.cli.manager`` and three
    ``python -m summerset_tpu_torch.cli.server ... --device cuda``, 16
    closed-loop clients through the manager's address for a timed
    window, every acked key read back, then the processes stopped and
    their WALs' apply records held against each other slot by slot.
    ``mp`` is phase 12's MultiPaxos line, set beside."""
    import shutil
    import signal
    import tempfile
    import threading
    import types

    harness = _serve_harness()
    from summerset_tpu_torch.client.endpoint import GenericEndpoint
    from summerset_tpu_torch.cluster import free_ports

    sh = SERVE_SHAPE
    what = "process cluster MultiPaxos"
    log(f"== phase 15: one process per replica, MultiPaxos {sh['G']} groups "
        f"x {sh['R']}, W={sh['W']}, tick {sh['tick']} s, {SERVE_CLIENTS} "
        "clients")
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    ports = free_ports(2 + 2 * sh["R"])
    tmp = tempfile.mkdtemp(prefix="proc_")
    env = dict(os.environ, PYTHONPATH=here)
    procs = []

    def spawn(name, args):
        path = os.path.join(tmp, f"{name}.log")
        with open(path, "w") as f:
            p = subprocess.Popen([sys.executable, "-m", *args], cwd=here,
                                 env=env, stdout=f, stderr=subprocess.STDOUT,
                                 start_new_session=True)
        procs.append((name, p, path))

    def tail(path):
        try:
            with open(path) as f:
                return " | ".join(f.read().strip().splitlines()[-6:])
        except OSError:
            return ""

    def alive(when):
        for name, p, path in procs:
            if p.poll() is not None:
                fail(f"{what}: {name} exited with {p.returncode} {when}: "
                     f"{tail(path)}")

    def ready(name, p, path, needle, deadline):
        while True:
            with open(path) as f:
                if needle in f.read():
                    return
            if p.poll() is not None:
                fail(f"{what}: {name} exited with {p.returncode} before it "
                     f"logged readiness: {tail(path)}")
            if time.monotonic() > deadline:
                fail(f"{what}: {name} never logged readiness "
                     f"({needle!r}) in {PROC_READY_S} s: {tail(path)}")
            time.sleep(0.2)

    try:
        t_up = time.monotonic()
        spawn("manager", ["summerset_tpu_torch.cli.manager", "-p",
                          "MultiPaxos", "--srv-port", str(ports[0]),
                          "--cli-port", str(ports[1]), "-n",
                          str(sh["R"])])
        ready(*procs[0], "manager up", t_up + PROC_READY_S)
        for r in range(sh["R"]):
            spawn(f"server{r}", [
                "summerset_tpu_torch.cli.server", "-p", "MultiPaxos",
                "-a", str(ports[2 + r]), "-i", str(ports[2 + sh["R"] + r]),
                "-m", f"127.0.0.1:{ports[0]}", "-g", str(sh["G"]),
                "--window", str(sh["W"]), "--tick-interval",
                str(sh["tick"]), "--device", DEV, "--backer-dir", tmp])
            time.sleep(1.0)  # staggered joins
        for name, p, path in procs[1:]:
            ready(name, p, path, "ready on", t_up + PROC_READY_S)
        up_s = time.monotonic() - t_up
        time.sleep(2.0)  # the warm-start leader settles
        mgr = ("127.0.0.1", ports[1])

        def endpoint():
            ep = GenericEndpoint(mgr)
            ep.connect()
            return ep

        cluster = types.SimpleNamespace(manager_addr=mgr, endpoint=endpoint)
        stop = threading.Event()
        clients = [_LoadClient(cluster, ci, stop)
                   for ci in range(SERVE_CLIENTS)]
        time.sleep(1.0)
        t0 = time.monotonic()
        time.sleep(SERVE_SECS)
        t1 = time.monotonic()
        alive("during the window")
        lats = sorted(lat for c in clients for (t, lat, _s) in c.ok
                      if t0 <= t < t1)
        if not lats:
            fail(f"{what}: no operation succeeded in the window")
        stop.set()
        for c in clients:
            c.thread.join(timeout=30)
        n_read = _read_back(cluster, clients, what)
        alive("after the read-back")
        from summerset_tpu_torch.client.endpoint import scrape_metrics

        snaps = scrape_metrics(mgr, timeout=60)
        dem = {sid: snap["host"]["counters"]["leader_demotions"]
               for sid, snap in snaps.items()}
        log(f"{what}: leader_demotions {dem}")
        if len(dem) != sh["R"] or any(dem.values()):
            fail(f"{what}: the health plane demoted a leader with no "
                 f"fault injected, or a scrape missed a replica: {dem}")
        time.sleep(2.0)  # the followers' last applies land
        for _name, p, _path in procs:
            os.killpg(p.pid, signal.SIGTERM)
        for _name, p, _path in procs:
            p.wait(timeout=30)
        views = [_wal_applies(harness, os.path.join(tmp, f"r{r}.wal"))
                 for r in range(sh["R"])]
        slots = 0
        for g in range(sh["G"]):
            merged = {}
            for r, v in enumerate(views):
                applied = sorted(v.get(g, {}))
                if applied != list(range(len(applied))):
                    fail(f"{what}: replica {r}'s applied slots of group {g}"
                         f" have a gap: {applied[:12]}")
                for slot, batch in v.get(g, {}).items():
                    if merged.setdefault(slot, batch) != batch:
                        fail(f"{what}: group {g} slot {slot} differs "
                             "between replicas' WALs")
            slots += len(merged)
        floors = [sum(len(v.get(g, {})) for g in range(sh["G"]))
                  for v in views]
        line = {
            "process_cluster": "MultiPaxos", "groups": sh["G"],
            "replicas": sh["R"], "window": sh["W"],
            "clients": SERVE_CLIENTS,
            "secs": round(t1 - t0, 3),
            "ops_per_s": round(len(lats) / (t1 - t0), 1),
            "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 3),
            "bring_up_s": round(up_s, 2), "read_back_keys": n_read,
            "slots_agreed": slots, "applied_per_replica": floors,
            "leader_demotions": dem,
            "phase12_one_interpreter": (
                {k: mp[k] for k in ("ops_per_s", "p50_ms", "p99_ms")}
                if mp else None),
            "card": card,
        }
        log(json.dumps(line))
    finally:
        for _name, p, _path in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return line


# ------------------------------------------------------- bench entry --
def phase_bench(card):
    """Phase 16: ``python -m summerset_tpu_torch.bench`` as a subprocess
    at ``BENCH_SMOKE_ENV``'s window (the default shape otherwise): one
    JSON line with ``ok`` true, this card's backend and stamp."""
    here = os.path.dirname(os.path.abspath(__file__))
    log("== phase 16: bench entry point, "
        + ", ".join(f"{k}={v}" for k, v in BENCH_SMOKE_ENV.items()))
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=here, **BENCH_SMOKE_ENV)
    args = [sys.executable, "-m", "summerset_tpu_torch.bench"]
    if DEV != "cuda":
        args += ["--device", DEV]
    proc = subprocess.run(args, cwd=here, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"bench exited with {proc.returncode}: "
             f"{proc.stderr.strip()[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        fail(f"bench printed {len(lines)} lines, not one")
    doc = json.loads(lines[0])
    want = {"cuda": card}.get(DEV)
    if (doc.get("ok") is not True or doc.get("backend") != DEV
            or doc.get("card") != want):
        fail(f"bench line: ok {doc.get('ok')}, backend "
             f"{doc.get('backend')}, card {doc.get('card')}")
    log(json.dumps({"bench": doc}))
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return doc


# ------------------------------------------------------ EPaxos serving --
def _ep_burst(cluster, what, tries=3):
    """Four pre-connected clients pinned to replica 0 put, behind one
    barrier, to four keys of one group in four distinct key buckets
    (the shape of the JAX ``TestClusterEPaxosMultiBucket``): the burst
    must be proposed in one tick, several vids in one ``prop_vids``
    row.  Returns the most vids replica 0 proposed in one group in one
    tick, and the tries it took."""
    import threading

    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.client.endpoint import GenericEndpoint

    srv = cluster.replicas[0]
    keys, i = [], 0
    while len(keys) < 4:
        k = f"burst{i}"
        i += 1
        if srv.group_of(k) == 0 and srv._key_bucket(k) not in {
                srv._key_bucket(x) for x in keys}:
            keys.append(k)
    seen = []
    orig = srv._intake_epaxos

    def wrapped(by_group, n_prop, vbase, piggy):
        out = orig(by_group, n_prop, vbase, piggy)
        seen.append(int((srv._ep_prop_vids != 0).sum(axis=1).max()))
        return out

    srv._intake_epaxos = wrapped
    eps = []
    for _ in keys:
        e = GenericEndpoint(cluster.manager_addr, server_id=0)
        e.connect()
        eps.append(e)
    try:
        for attempt in range(1, tries + 1):
            seen.clear()
            barrier = threading.Barrier(len(keys))
            errs = []

            def put(e, k):
                barrier.wait()
                try:
                    DriverClosedLoop(e, timeout=SERVE_LEASE_OP_TIMEOUT) \
                        .checked_put(k, f"burst-{k}")
                except AssertionError as ex:
                    errs.append(str(ex))

            ts = [threading.Thread(target=put, args=(e, k), daemon=True)
                  for e, k in zip(eps, keys)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            if errs:
                fail(f"{what}: burst puts failed: {errs[:2]}")
            if seen and max(seen) >= 2:
                return max(seen), attempt
    finally:
        del srv._intake_epaxos
        for e in eps:
            e.leave()
    fail(f"{what}: a burst of {len(keys)} puts to distinct buckets was "
         f"never proposed in one tick ({seen})")


def _ep_faults(cluster, clients):
    """EPaxos under load: the multi-bucket burst."""
    vids, tries = _ep_burst(cluster, "serving EPaxos")
    return {"burst_vids_in_one_tick": vids, "burst_tries": tries}


def _ep_quiet_reset(cluster, clients):
    """EPaxos with the load stopped (as the JAX ``TestClusterEPaxos``
    resets its server): every replica's floors equal, then a durable
    reset of replica 1, whose ``eapply`` records replay.  A reset under
    load whose rejoin outlasts ``alive_timeout`` leaves the restarted
    replica behind for good in both packages (ROADMAP Queue 3, pinned by
    ``tests/test_torch_server.py::
    test_epaxos_rejoin_after_long_absence_lockstep``)."""
    what = "serving EPaxos"
    _quiesce(cluster, what, timeout=SERVE_LEASE_OP_TIMEOUT)
    t = time.monotonic()
    rep = cluster.ctrl("reset_servers", servers=[1], timeout=300)
    if rep.done != [1]:
        fail(f"{what}: durable reset of replica 1 not acknowledged "
             f"({rep.done})")
    out = {"reset_1_s": round(time.monotonic() - t, 3)}
    time.sleep(2.0)
    return out


def phase_epaxos_serving(torch, np, card):
    """Phase 17: EPaxos served by phase 12's harness on the card, then
    card against CPU in per-tick lockstep at ``EP_SERVE_LOCK_GROUPS``
    groups in both loop modes."""
    import tempfile

    sh = SERVE_SHAPE
    log(f"== phase 17: EPaxos serving, {sh['G']} groups x {sh['R']} "
        f"replicas, W={sh['W']}, {SERVE_CLIENTS} clients pinned to the "
        "replicas in turn (burst, reset, snapshot, card vs cpu)")
    t_phase = time.perf_counter()
    line = _serve_run(torch, np, card, "EPaxos", SERVE_EP_SECS, _ep_faults,
                      read_back=True, profile=True, pinned=True,
                      shared_gets=True, hist_keys=2, snapshot=True,
                      op_timeout=SERVE_LEASE_OP_TIMEOUT,
                      quiet_plan=_ep_quiet_reset)
    if "ep_exec" not in line["stage_mean_us"]:
        fail("serving EPaxos: no ep_exec stage was recorded")
    harness = _serve_harness()
    for pipelined in (False, True):
        mode = "pipelined" if pipelined else "serial"
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="eplock_") as d:
            try:
                lock = harness.card_cpu_serving_lockstep(
                    d, DEV, "EPaxos", pipelined=pipelined,
                    G=EP_SERVE_LOCK_GROUPS)
            except AssertionError as e:
                fail(f"EPaxos serving {DEV} vs cpu ({mode}): {e}")
        if not lock["acked"] or lock["multi"] < 2:
            fail(f"EPaxos serving {DEV} vs cpu ({mode}): the schedule "
                 f"acked no put or never proposed two buckets: {lock}")
        log(f"EPaxos serving: 3 replicas on {DEV} == 3 on cpu for "
            f"{lock['ticks']} {mode} lockstep ticks at "
            f"{EP_SERVE_LOCK_GROUPS} groups through a durable reset "
            f"(state, frames, WAL with eapply records, floors, KV, "
            f"replies), {lock['acked']} replies, up to {lock['multi']} "
            f"vids per group per tick, card ep_exec mean "
            f"{lock['ep_exec_us']:.1f} us, "
            f"{time.perf_counter() - t0:.1f} s | {card}")
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return line


# ------------------------------------------------ basic kernels serving --
def _reset_serving(protocol):
    """The fault plan of the basic kernels: a durable reset of the
    serving node (ChainRep's head, SimplePush's and RepNothing's serving
    replica) under load."""
    what = f"serving {protocol}"

    def plan(cluster, clients):
        serving = cluster.leader_of(0)
        if serving is None:
            fail(f"{what}: no serving replica before the reset")
        t = time.monotonic()
        rep = cluster.ctrl("reset_servers", servers=[serving], timeout=300)
        if rep.done != [serving]:
            fail(f"{what}: durable reset of {serving} not acknowledged "
                 f"({rep.done})")
        out = {"reset_serving": serving,
               "reset_serving_s": round(time.monotonic() - t, 3)}
        time.sleep(2.0)
        return out

    return plan


def phase_basic_serving(torch, np, card):
    """Phase 18: ChainRep, SimplePush and RepNothing served by phase 12's
    harness on the card: a 4 s window each, a durable reset of the
    serving node, every acked key read back (RepNothing, which
    replicates nothing, from its serving replica only)."""
    sh = SERVE_SHAPE
    log(f"== phase 18: basic kernels serving, {sh['G']} groups x "
        f"{sh['R']} replicas, W={sh['W']}, {SERVE_CLIENTS} clients "
        "(ChainRep, SimplePush, RepNothing)")
    t_phase = time.perf_counter()
    lines = {}
    for proto in ("ChainRep", "SimplePush", "RepNothing"):
        lines[proto] = _serve_run(torch, np, card, proto, SERVE_BASIC_SECS,
                                  _reset_serving(proto), read_back=True,
                                  replicated=proto != "RepNothing")
    log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return lines


# ------------------------------------------------- read tier and wire --
def _read_cluster(protocol, tmp, config=None, slot_config=None):
    """Phase 12's cluster shape for phase 19; its bring-up seconds in
    ``cluster.up_s``."""
    from summerset_tpu_torch.cluster import Cluster

    sh = SERVE_SHAPE
    t = time.perf_counter()
    cluster = Cluster(protocol, sh["R"], tmp, tick=sh["tick"],
                      num_groups=sh["G"], window=sh["W"], device=DEV,
                      settle=2.0, config=config, slot_config=slot_config)
    cluster.up_s = round(time.perf_counter() - t, 2)
    return cluster


def _keys_per_group(G, prefix):
    """One key routed to each group (the server's crc32 routing)."""
    import zlib

    out, i = {}, 0
    while len(out) < G:
        k = f"{prefix}{i}"
        out.setdefault(zlib.crc32(k.encode()) % G, k)
        i += 1
    return [out[g] for g in range(G)]


class _Subscriber:
    """A read-tier learner on its own connection: ``sub`` at server
    ``sid``, then every ``note`` reply until stopped; ``kv`` is the
    snapshot plus the notes, ``seqs`` the notes' sequence numbers."""

    def __init__(self, cluster, sid, cid):
        import threading

        from summerset_tpu_torch.client.endpoint import ClientApiStub
        from summerset_tpu_torch.host.messages import ApiRequest

        ep = cluster.endpoint()
        addr = ep.servers[sid][0]
        ep.leave()
        self.stub = ClientApiStub(cid, addr)
        self.stub.send_req(ApiRequest("sub", req_id=1))
        snap = self.stub.recv_reply(timeout=30)
        if snap.kind != "sub" or not snap.success:
            fail(f"read tier: subscription at {sid} answered {snap.kind}")
        self.kv = dict(snap.notes)
        self.seqs = [snap.seq]
        self.bad = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def run(self):
        import socket

        while not self.stop.is_set():
            try:
                x = self.stub.recv_reply(timeout=0.5)
            except socket.timeout:
                continue
            except Exception as e:
                self.bad.append(repr(e))
                return
            if x.kind != "note":
                self.bad.append(f"{x.kind} on the feed")
                continue
            for seq, k, v in x.notes:
                if seq != self.seqs[-1] + 1:
                    self.bad.append(f"seq {seq} after {self.seqs[-1]}")
                self.seqs.append(seq)
                self.kv[k] = v
            if x.seq != self.seqs[-1]:
                self.bad.append(f"note seq {x.seq} != {self.seqs[-1]}")

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)
        self.stub.close()


def _scan_checked(drv, clients, what, span=READ_SPAN, tries=40):
    """A scan over ``span`` through the driver, retried through redirects
    and sheds: sorted, inside the span, and every acked key of the span
    holds its last acked value (or a later put that timed out)."""
    lo, hi = span
    for _ in range(tries):
        t0 = time.monotonic()
        rep = drv.scan(lo, end=hi)
        if rep.kind == "success":
            break
        drv._retry_pause(rep)
    else:
        fail(f"{what}: scan [{lo}, {hi}) never succeeded")
    secs = time.monotonic() - t0
    items = rep.result.items or ()
    keys = [k for k, _v in items]
    if keys != sorted(keys) or any(not lo <= k < hi for k in keys):
        fail(f"{what}: scan items unsorted or outside the span")
    got = dict(items)
    n = 0
    for c in clients:
        for key, val in c.acked.items():
            if lo <= key < hi:
                n += 1
                if got.get(key) != val and \
                        got.get(key) not in c.later.get(key, ()):
                    fail(f"{what}: scan missed acked {key}={val!r} "
                         f"(got {got.get(key)!r})")
    return {"items": len(items), "acked_in_span": n,
            "secs": round(secs, 3), "local": rep.local}


def _nqr_history(cluster, followers, stop, ops):
    """One writer streaming unique values to one key at the leader and a
    reader pinned to each follower (``TestClusterNearQuorumReads``)."""
    import threading

    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.client.endpoint import GenericEndpoint
    from summerset_tpu_torch.utils.linearize import record_get, record_put

    def writer():
        ep = cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=READ_OP_TIMEOUT)
        seq = 0
        while not stop.is_set():
            val = f"w-{seq}"
            t0 = time.monotonic()
            rep = drv.put("nqr_hist", val)
            t1 = time.monotonic()
            if rep.kind == "success":
                ops.append(record_put(0, "nqr_hist", val, t0, t1, True))
            elif rep.kind != "redirect":
                ops.append(record_put(0, "nqr_hist", val, t0, None, False))
                drv._failover(rep)
            seq += 1
            time.sleep(0.1)
        ep.leave()

    def reader(ci, sid):
        ep = GenericEndpoint(cluster.manager_addr, server_id=sid)
        ep.connect()
        drv = DriverClosedLoop(ep, timeout=READ_OP_TIMEOUT)
        while not stop.is_set():
            t0 = time.monotonic()
            rep = drv.get("nqr_hist")
            t1 = time.monotonic()
            if rep.kind == "success":
                val = rep.result.value if rep.result else None
                ops.append(record_get(ci, "nqr_hist", val, t0, t1))
            elif ep.current != sid:
                try:
                    ep.reconnect(sid)
                except Exception:
                    time.sleep(0.1)
        ep.leave()

    ts = [threading.Thread(target=writer, daemon=True)]
    ts += [threading.Thread(target=reader, args=(1 + i, sid), daemon=True)
           for i, sid in enumerate(followers)]
    for t in ts:
        t.start()
    return ts


def _read_tier_multipaxos(torch, np, card, tmp):
    """Near-quorum reads under load from followers, the history, barrier
    scans and the commit feed, on one MultiPaxos cluster."""
    import threading

    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.utils.linearize import check_history

    what = "read tier MultiPaxos"
    cluster = _read_cluster("MultiPaxos", tmp,
                            config={"near_quorum_reads": True})
    try:
        leader = cluster.leader_of(0)
        if leader is None or not bool(
                cluster.replicas[leader]._is_leader.all()):
            fail(f"{what}: replica {leader} does not lead every group")
        followers = [me for me in sorted(cluster.replicas) if me != leader]
        sub = _Subscriber(cluster, leader, 900001)
        stop = threading.Event()
        clients = [_LoadClient(cluster, ci, stop, put_share=0.1,
                               pin=followers[ci % 2],
                               op_timeout=READ_OP_TIMEOUT)
                   for ci in range(SERVE_CLIENTS)]
        hist_ops, hist_stop = [], threading.Event()
        hist = _nqr_history(cluster, followers, hist_stop, hist_ops)
        time.sleep(1.0)
        w = _window(np, cluster, clients, SERVE_READ_SECS, what)
        t1 = time.monotonic()
        t0 = t1 - w["secs"]
        gets = [(lat, loc) for c in clients
                for (t, lat, srv, loc) in c.gets if t0 <= t < t1]
        local_share = (sum(1 for _l, loc in gets if loc)
                       / max(1, len(gets)))
        lats = sorted(lat for lat, _loc in gets)
        stop.set()
        for c in clients:
            c.thread.join(timeout=30)
        deadline = time.monotonic() + 30
        while (sum(1 for o in hist_ops if o.kind == "get") < 20
               and time.monotonic() < deadline):
            time.sleep(0.2)
        hist_stop.set()
        for t in hist:
            t.join(timeout=30)
        n_local = sum(1 for c in clients for g in c.gets if g[3])
        if n_local == 0:
            fail(f"{what}: no follower answered a get by quorum")
        ok, diag = check_history(hist_ops)
        if not ok:
            fail(f"{what}: history not linearizable: {diag}")
        n_keys, applied, writes = _check_agreement(cluster, clients, what,
                                                   READ_OP_TIMEOUT)
        # barrier scans at the leader (no lease: markers in every group)
        ep = cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=30.0)
        rs_before = cluster.replicas[leader].metrics.counter_value(
            "scan_served")
        scans = [_scan_checked(drv, clients, what) for _ in range(2)]
        if any(s["local"] for s in scans):
            fail(f"{what}: a scan was served locally without a lease")
        served = (cluster.replicas[leader].metrics.counter_value(
            "scan_served") - rs_before)
        if served < 2:
            fail(f"{what}: the leader counted {served} scans served")
        ep.leave()
        # the commit feed caught up with the leader's applied KV
        kv = dict(cluster.replicas[leader].statemach.snapshot_items())
        deadline = time.monotonic() + 30
        while sub.kv != kv and time.monotonic() < deadline:
            time.sleep(0.2)
        sub.close()
        if sub.bad:
            fail(f"{what}: commit feed faults: {sub.bad[:3]}")
        if sub.kv != kv:
            diff = [k for k in set(kv) | set(sub.kv)
                    if kv.get(k) != sub.kv.get(k)]
            fail(f"{what}: snapshot plus notes differ from the leader's "
                 f"KV at {len(diff)} keys, e.g. {diff[:3]}")
        _require_clean(cluster, what)
        line = {
            "read_tier": "MultiPaxos", "near_quorum_reads": True,
            "groups": SERVE_SHAPE["G"], "clients": SERVE_CLIENTS,
            "bring_up_s": cluster.up_s, "pinned_to": followers,
            "window_s": w["secs"], "ops_per_s": w["ops_per_s"],
            "p50_ms": w["p50_ms"], "p99_ms": w["p99_ms"],
            "ticks_per_s": w["ticks_per_s"],
            "stage_mean_us": w["stage_mean_us"],
            "gets": len(gets), "local_read_share": round(local_share, 4),
            "get_p50_ms": (round(float(np.percentile(lats, 50)) * 1e3, 3)
                           if lats else None),
            "get_p99_ms": (round(float(np.percentile(lats, 99)) * 1e3, 3)
                           if lats else None),
            "history_ops": len(hist_ops), "acked_keys_checked": n_keys,
            "quiesce_barrier_writes": writes, "scans": scans,
            "feed_notes": len(sub.seqs) - 1, "feed_keys": len(sub.kv),
            "card": card,
        }
        log(json.dumps(line))
        return line
    finally:
        cluster.stop()


def _read_tier_rspaxos(torch, np, card, tmp, rs):
    """A barrier scan on RSPaxos RS(2,1): its marker in every group is
    encoded at the leader with ``bitslice_gf256`` and rebuilt at the
    followers."""
    import threading

    from summerset_tpu_torch.client.drivers import DriverClosedLoop

    what = "read tier RSPaxos"
    cluster = _read_cluster("RSPaxos", tmp, config=SERVE_CW_CFG)
    try:
        stop = threading.Event()
        # 16 writers, each on its own keys: a few puts land in the span
        clients = [_LoadClient(cluster, ci, stop,
                               value_bytes=SERVE_CW_VALUE_BYTES,
                               put_share=1.0, op_timeout=READ_OP_TIMEOUT)
                   for ci in range(SERVE_CLIENTS)]
        deadline = time.monotonic() + 60
        while (sum(len(c.acked) for c in clients) < READ_CW_PUTS
               and time.monotonic() < deadline):
            time.sleep(0.1)
        stop.set()
        for c in clients:
            c.thread.join(timeout=30)
        ep = cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=30.0)
        n0 = rs.bitslice_gf256.launches
        scans = [_scan_checked(drv, clients, what, span=("key", "kez"))]
        launches = rs.bitslice_gf256.launches - n0
        ep.leave()
        if DEV == "cuda" and launches == 0:
            fail(f"{what}: the scan markers never launched bitslice_gf256")
        leader = cluster.leader_of(0)
        lanes = None
        if leader is not None:
            rep = cluster.replicas[leader]
            for g, vid in sorted(rep.origin):
                b = rep.payloads.get(g, vid)
                held = rep.codewords.shards_for(g, vid)
                if b and b[0][0] is None and held is not None:
                    lanes = int(next(iter(held[1].values())).shape[-1])
                    break
        n_keys, applied, writes = _check_agreement(cluster, clients, what,
                                                   READ_OP_TIMEOUT)
        _require_clean(cluster, what)
        line = {"read_tier": "RSPaxos", "bring_up_s": cluster.up_s,
                "scans": scans,
                "acked_keys_checked": n_keys,
                "bitslice_launches_scans": launches,
                "marker_shard_lanes": lanes, "card": card}
        log(json.dumps(line))
        return line
    finally:
        cluster.stop()


def _read_tier_epaxos(tmp, card):
    """EPaxos answers a scan with ``error``."""
    what = "read tier EPaxos"
    cluster = _read_cluster("EPaxos", tmp)
    try:
        ep = cluster.endpoint()
        ep.send_scan(1, READ_SPAN[0], READ_SPAN[1])
        rep = ep.recv_reply(timeout=30)
        ep.leave()
        if rep.kind != "error" or rep.success:
            fail(f"{what}: a scan was answered {rep.kind}")
        _require_clean(cluster, what)
        log(f"{what}: scan answered error | {card}")
        return rep.kind
    finally:
        cluster.stop()


def _read_tier_probes(tmp, card):
    """Probes on QuorumLeases with responders {0, 1, 2}: one key per
    group at every responder, each answered ``success``."""
    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.client.endpoint import ClientApiStub
    from summerset_tpu_torch.host.messages import ApiRequest
    from summerset_tpu_torch.host.statemach import Command

    what = "read tier probes QuorumLeases"
    G = SERVE_SHAPE["G"]
    cluster = _read_cluster("QuorumLeases", tmp)
    try:
        ep = cluster.endpoint()
        t = time.monotonic()
        DriverClosedLoop(ep, timeout=SERVE_LEASE_OP_TIMEOUT).conf_change(
            {"responders": [0, 1, 2]})
        conf_s = time.monotonic() - t
        keys = _keys_per_group(G, "probe")
        out = {}
        for sid in sorted(cluster.replicas):
            stub = ClientApiStub(800000 + sid, ep.servers[sid][0])
            todo = list(range(G))
            seq = None
            for _round in range(40):
                for g in todo:
                    stub.send_req(ApiRequest("probe", req_id=g,
                                             cmd=Command("get", keys[g])))
                got = {}
                while len(got) < len(todo):
                    x = stub.recv_reply(timeout=30)
                    if x.kind != "probe":
                        fail(f"{what}: a probe at {sid} answered {x.kind}")
                    got[x.req_id] = x.success
                    seq = x.seq
                todo = [g for g in todo if not got[g]]
                if not todo:
                    break
                time.sleep(0.25)
            stub.close()
            if todo:
                fail(f"{what}: responder {sid} refused probes in "
                     f"{len(todo)} groups, e.g. {todo[:4]}")
            out[str(sid)] = {"probes": G, "rounds": _round + 1, "seq": seq}
        ep.leave()
        _require_clean(cluster, what)
        line = {"read_tier": "probes", "protocol": "QuorumLeases",
                "bring_up_s": cluster.up_s,
                "responders": [0, 1, 2], "conf_change_s": round(conf_s, 3),
                "per_responder": out, "card": card}
        log(json.dumps(line))
        return line
    finally:
        cluster.stop()


def _frame_sizes(rep):
    """One p2p tick frame of this replica (its last outbox slice to one
    peer, no payload parts) in both formats."""
    from summerset_tpu_torch.utils import safetcp

    dst, msg = next(iter(rep._slice_outbox(rep._last_out).items()))
    frame = (rep.tick, {"msg": msg, "pp": {}, "kv_need": False,
                        "ts": 0.0, "need": []})
    return {"codec": len(safetcp.encode_frame(frame, codec=True)),
            "pickle": len(safetcp.encode_frame(frame, codec=False))}


def _read_tier_mixed(tmp, card):
    """Replica 0 with the codec off, 1-2 on; a codec client and a pickle
    client read back each other's acked writes."""
    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.client.endpoint import GenericEndpoint

    what = "read tier mixed formats"
    cluster = _read_cluster("MultiPaxos", tmp, slot_config={
        0: {"wire_codec": False}, 1: {"wire_codec": True},
        2: {"wire_codec": True}})
    eps = []
    try:
        codec = {me: rep.wire_codec for me, rep in cluster.replicas.items()}
        if sorted(codec.values()) != [False, True, True]:
            fail(f"{what}: replica codec knobs {codec}")
        drivers = {}
        for on in (True, False):
            ep = GenericEndpoint(cluster.manager_addr, wire_codec=on)
            ep.connect()
            eps.append(ep)
            drivers[on] = DriverClosedLoop(ep, timeout=READ_OP_TIMEOUT)
        n = 4
        for i in range(n):
            for on, drv in drivers.items():
                drv.checked_put(f"mix{on}{i}", f"v{on}{i}", retries=40)
        for on, drv in drivers.items():
            for i in range(n):
                drv.checked_get(f"mix{not on}{i}", f"v{not on}{i}",
                                retries=40)
        # every 64th codec frame is also pickled to meter the savings
        deadline = time.monotonic() + 30
        while True:
            saved = {me: rep.metrics.counter_value("wire_bytes_saved")
                     for me, rep in cluster.replicas.items()}
            if (all(saved[me] > 0 for me, on in codec.items() if on)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
        for me, rep in cluster.replicas.items():
            if rep.wire_codec and saved[me] <= 0:
                fail(f"{what}: codec replica {me} saved no bytes")
        sent = {}
        for me, rep in cluster.replicas.items():
            peer = next(q for q in cluster.replicas if q != me)
            sent[me] = (
                rep.metrics.counter_value("transport_bytes_sent", peer=peer),
                rep.metrics.counter_value("transport_frames_sent",
                                          peer=peer))
        sizes = {str(me): _frame_sizes(rep)
                 for me, rep in sorted(cluster.replicas.items())}
        _require_clean(cluster, what)
        line = {
            "read_tier": "mixed formats", "bring_up_s": cluster.up_s,
            "codec": {str(k): v for k, v in sorted(codec.items())},
            "wire_bytes_saved": {str(k): v
                                 for k, v in sorted(saved.items())},
            "mean_frame_bytes_sent": {
                str(me): round(b / max(f, 1), 1)
                for me, (b, f) in sorted(sent.items())},
            "tick_frame_bytes": sizes, "cross_reads": 2 * n, "card": card,
        }
        log(json.dumps(line))
        return line
    finally:
        for ep in eps:
            ep.leave()
        cluster.stop()


def phase_read_tier(torch, np, card):
    """Phase 19: the read tier and the byte formats at phase 12's shape
    (the codec on, the native WAL): near-quorum reads, barrier scans and
    the commit feed on MultiPaxos; RSPaxos barrier scans launching
    ``bitslice_gf256``; EPaxos refusing a scan; probes on QuorumLeases;
    a mixed codec/pickle mesh.  Returns the kernel's launches and its
    max_abs_err against the plain version at the marker's shape."""
    import shutil
    import tempfile

    from summerset_tpu_torch.ops import rscoding as rs

    sh = SERVE_SHAPE
    log(f"== phase 19: read tier and wire, {sh['G']} groups x {sh['R']} "
        f"replicas, W={sh['W']}, {SERVE_CLIENTS} clients")
    t_phase = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n0 = rs.bitslice_gf256.launches
    lines = {}
    tmp = tempfile.mkdtemp(prefix="read_")
    try:
        for name, run in (
            ("multipaxos", lambda d: _read_tier_multipaxos(
                torch, np, card, d)),
            ("rspaxos", lambda d: _read_tier_rspaxos(
                torch, np, card, d, rs)),
            ("epaxos", lambda d: _read_tier_epaxos(d, card)),
            ("probes", lambda d: _read_tier_probes(d, card)),
            ("mixed", lambda d: _read_tier_mixed(d, card)),
        ):
            t = time.perf_counter()
            lines[name] = run(os.path.join(tmp, name))
            log(f"phase 19 {name}: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = rs.bitslice_gf256.launches - n0
    lanes = lines["rspaxos"]["marker_shard_lanes"] or 128
    err = serving_kernel_numbers(torch, np, rs, card, [lanes])
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if DEV == "cuda" else 0.0)
    log(json.dumps({"phase": 19, "seconds": round(
        time.perf_counter() - t_phase, 1),
        "max_memory_allocated_mib": round(peak, 1),
        "bitslice_launches": launches, "card": card}))
    return {"launches": launches, "max_abs_err": err}



# ------------------------------------- observability and control planes --
def _leads(cluster):
    """{sid: [G] bool} of the live replicas' leader flags."""
    return {me: rep._is_leader.copy()
            for me, rep in sorted(cluster.replicas.items())}


def _ctrl_req(cluster, kind, payload=None, servers=None, timeout=120):
    from summerset_tpu_torch.host.messages import CtrlRequest

    ep = cluster.endpoint()
    try:
        return ep.ctrl.request(CtrlRequest(kind, servers=servers,
                                           payload=payload), timeout=timeout)
    finally:
        ep.leave()


def _planes_scrapes(cluster, clients, what):
    """(a): ``metrics_dump``, ``flight_dump`` and ``watch_series`` through
    the manager with the port's client functions, each timed and sized,
    and their checks."""
    from summerset_tpu_torch.client.endpoint import (
        scrape_fleet, scrape_flight, scrape_metrics,
    )
    from summerset_tpu_torch.core.telemetry import LANES

    addr = cluster.manager_addr
    got, out = {}, {}
    # counted first: every op acknowledged by now was applied before the
    # scrape reads the counters (acks ride execution)
    acked = sum(len(c.ok) for c in clients)
    for name, fn in (("metrics_dump", lambda: scrape_metrics(addr, 60)),
                     ("flight_dump", lambda: scrape_flight(addr, None, 60)),
                     ("watch_series", lambda: scrape_fleet(addr, 60))):
        t = time.monotonic()
        got[name] = fn()
        out[name] = {"s": round(time.monotonic() - t, 3),
                     "bytes": len(json.dumps(got[name]))}
    snaps = got["metrics_dump"]
    if sorted(snaps) != ["0", "1", "2"]:
        fail(f"{what}: metrics_dump answered {sorted(snaps)}")
    lead = str(cluster.leader_of(0))
    for sid, snap in snaps.items():
        lanes = snap["device"]["lanes"]
        if set(lanes) != set(LANES):
            fail(f"{what}: replica {sid}'s device lanes {sorted(lanes)}")
        hs = snap["host"]["histograms"]
        for h in ("wal_fsync_us", "loop_stage_us{stage=intake}"):
            if not hs.get(h, {}).get("count"):
                fail(f"{what}: replica {sid}'s {h} is empty")
        for tr in snap["traces"]:
            if not (tr["tick_committed"] <= tr["tick_applied"]
                    and "latency_ms" in tr):
                fail(f"{what}: replica {sid}'s slot trace {tr}")
        if snap["host"]["gauges"]["health_score"] != 1.0 or \
                snap["host"]["counters"]["leader_demotions"]:
            fail(f"{what}: replica {sid} scored unhealthy with no fault")
    ls = snaps[lead]
    if (ls["device"]["lanes"]["commits"] < 1
            or ls["host"]["counters"]["commits_applied_total"] < acked):
        fail(f"{what}: the leader's committed counts "
             f"{ls['device']['lanes']['commits']} slots / "
             f"{ls['host']['counters']['commits_applied_total']} ops below "
             f"the {acked} acknowledged ops")
    traces = sum(len(s["traces"]) for s in snaps.values())
    if not traces:
        fail(f"{what}: no sampled slot trace completed")
    dumps = got["flight_dump"]
    if sorted(dumps) != ["0", "1", "2"]:
        fail(f"{what}: flight_dump answered {sorted(dumps)}")
    for sid, d in dumps.items():
        if (d["dropped"] != d["count"] - len(d["events"])
                or sum(d["dropped_by_type"].values()) != d["dropped"]
                or len(d["events"]) < min(d["count"], 8192)):
            fail(f"{what}: replica {sid}'s flight ring accounting: count "
                 f"{d['count']}, {len(d['events'])} events, dropped "
                 f"{d['dropped']} {d['dropped_by_type']}")
    out["traces"] = traces
    out["flight_events"] = {s: d["count"] for s, d in dumps.items()}
    out["flight_dropped"] = {s: d["dropped"] for s, d in dumps.items()}
    # graftwatch is lossless: each replica's frames in the manager's ring
    # sum to the cumulative counters of its newest frame (the emitter's
    # own cursor), re-read until every replica has emitted a frame (one
    # per ``watch_ticks`` ticks) and the ring holds its newest
    deadline = time.monotonic() + 30
    while True:
        cur = {me: (rep.watch.frames_emitted, dict(rep.watch._prev_counters))
               for me, rep in sorted(cluster.replicas.items())}
        fleet = scrape_fleet(addr, 60) or {}
        series = {s["sid"]: s["frames"] for s in fleet.get("series", ())}
        if all(n > 0 and len(series.get(me, ())) == n
               for me, (n, _c) in cur.items()):
            break
        if time.monotonic() > deadline:
            fail(f"{what}: the fleet ring never caught up with the frames "
                 f"emitted: {[(me, n) for me, (n, _c) in cur.items()]}")
        time.sleep(0.5)
    for me, (n, cum) in cur.items():
        tot = {}
        for f in series[me]:
            for k, d in f["counters"].items():
                tot[k] = tot.get(k, 0) + d
        if n == 0 or {k: v for k, v in cum.items() if v} != tot:
            fail(f"{what}: replica {me}'s {n} watch frames do not sum to "
                 "its counters")
    out["watch_frames"] = {str(me): n for me, (n, _c) in cur.items()}
    log(f"{what}: scrapes " + ", ".join(
        f"{k} {v['s']} s {v['bytes']} B" for k, v in out.items()
        if isinstance(v, dict) and "s" in v))
    return out


def _planes_autopilot(np, cluster, what):
    """(d): the autopilot over a Zipf-skewed put/get mix: ``observe``
    sends no ctrl mutation, then ``act`` splits the hot key off its group
    within the policy's budget, and the range change installs."""
    import zlib

    from summerset_tpu_torch.host.autopilot import (
        AutopilotDriver, AutopilotPolicy,
    )
    from summerset_tpu_torch.host.resharding import ResharderPolicy

    G = SERVE_SHAPE["G"]

    def policy():
        return AutopilotPolicy(
            seed=SEED, population=SERVE_SHAPE["R"], num_groups=G,
            streak_need=2, cooldown_rounds=3, window_rounds=4,
            budget_per_window=2,
            resharder=ResharderPolicy(
                G, lambda k: zlib.crc32(k.encode()) % G, hot_frac=0.25,
                cold_frac=0.02, min_total=10))

    def mutations():
        reps = dict(cluster.replicas)
        return (sum(r.metrics.counter_value("autopilot_actions", actuator=a)
                    for r in reps.values()
                    for a in ("batch", "pipeline", "lead_move")),
                [r.metrics.gauge_value("autopilot_mode")
                 for r in reps.values()],
                _ctrl_req(cluster, "query_info").ranges or [])

    obs = AutopilotDriver(cluster.manager_addr, policy(), mode="observe",
                          scrape_s=PLANES_AP_SCRAPE_S, timeout=30)
    for _ in range(PLANES_AP_ROUNDS):
        obs.step()
        time.sleep(PLANES_AP_SCRAPE_S)
    obs.close()
    if obs.actuation_log or mutations() != (0, [0.0] * 3, []):
        fail(f"{what}: observe mode mutated the cluster: "
             f"{obs.actuation_log} {mutations()}")
    pol = policy()
    act = AutopilotDriver(cluster.manager_addr, pol, mode="act",
                          scrape_s=PLANES_AP_SCRAPE_S, timeout=30)
    t0 = time.monotonic()
    ticks, installed = [], None
    while installed is None:
        lead = cluster.leader_of(0)
        for d in act.step():
            ticks.append((d.render(), cluster.replicas[lead].tick
                          if lead is not None else None))
        fired = [d for d in pol.decisions() if d.actuator == "reshard"]
        if fired:
            arg = fired[0].arg
            key, dst = arg["start"], int(arg["dst_group"])
            ranges = _ctrl_req(cluster, "query_info").ranges or []
            if ranges and all(r.route_group(key) == dst
                              for r in cluster.replicas.values()):
                installed = {"key": key, "dst_group": dst,
                             "s": round(time.monotonic() - t0, 3)}
                break
        if time.monotonic() - t0 > PLANES_AP_MAX_S:
            act.close()
            fail(f"{what}: no reshard installed in {PLANES_AP_MAX_S} s "
                 f"of act mode: decisions {act.decision_log}")
        time.sleep(PLANES_AP_SCRAPE_S)
    act.close()
    per_window = {}
    for d in pol.decisions():
        if d.actuator != "recommend":
            w = d.round_no // pol.window_rounds
            per_window[w] = per_window.get(w, 0) + 1
    if any(n > pol.budget_per_window for n in per_window.values()):
        fail(f"{what}: actuations per window {per_window} over the "
             f"budget {pol.budget_per_window}")
    out = {"observe_decisions": obs.decision_log,
           "act_decisions": [t for t, _tick in ticks],
           "decision_ticks": [tick for _t, tick in ticks],
           "actuations": act.actuation_log, "installed": installed}
    log(f"{what}: autopilot decisions (leader tick): "
        + "; ".join(f"{t} @{k}" for t, k in ticks)
        + f"; installed {installed}")
    return out


def _planes_demotion(np, cluster, clients, what):
    """(b): a slow WAL at the leader: it self-indicts and demotes once,
    every group elects another leader, the clients go on; healed, no
    second demotion."""
    G = SERVE_SHAPE["G"]
    victim = cluster.leader_of(0)
    leads = _leads(cluster)
    if victim is None or not leads[victim].all():
        fail(f"{what}: replica {victim} does not lead every group before "
             "the fault")
    t_fault = time.monotonic()
    rep = _ctrl_req(cluster, "inject_faults", servers=[victim],
                    payload={"wal": dict(PLANES_SLOW_WAL), "seed": SEED})
    if rep.done != [victim]:
        fail(f"{what}: inject_faults answered {rep.done}")
    deadline = t_fault + PLANES_FAILOVER_MAX_S
    t_demote = t_new = None
    while True:
        vr = cluster.replicas.get(victim)
        if t_demote is None and vr is not None and \
                vr.metrics.counter_value("leader_demotions"):
            t_demote = time.monotonic()
        leads = _leads(cluster)
        others = np.zeros(G, bool)
        for me, lv in leads.items():
            if me != victim:
                others |= lv
        if t_demote is not None and others.all() and \
                not leads.get(victim, np.zeros(G, bool)).any():
            t_new = time.monotonic()
            break
        if time.monotonic() > deadline:
            _ctrl_req(cluster, "inject_faults", servers=[victim],
                      payload={"wal": None})
            h = vr.health if vr is not None else None
            diag = {} if h is None else {
                "tick": vr.tick, "leads": int(vr._is_leader.sum()),
                "self_bad": vr._health_self_bad,
                "streak": dict(h._bad_streak),
                "table": h._signal_table(time.monotonic())}
            fail(f"{what}: {int((~others).sum())} groups without a new "
                 f"leader {PLANES_FAILOVER_MAX_S} s after the slow WAL "
                 f"(demoted: {t_demote is not None}); victim {diag}")
        time.sleep(0.2)
    dumps = cluster.replicas[victim].flight_snapshot()
    demotes = [e for e in dumps["events"] if e["type"] == "demote"]
    if len(demotes) != 1:
        fail(f"{what}: {len(demotes)} demote events at replica {victim}")
    time.sleep(3.0)  # the clients go on at the new leaders
    t_heal = time.monotonic()
    _ctrl_req(cluster, "inject_faults", servers=[victim],
              payload={"wal": None})
    time.sleep(PLANES_HEAL_S)
    t_end = time.monotonic()
    dem = _demotions(cluster)
    if dem != {str(me): int(me == victim) for me in cluster.replicas}:
        fail(f"{what}: demotions after the heal {dem} (one at replica "
             f"{victim} expected)")

    def rate(a, b):
        n = sum(1 for c in clients for (t, _l, _s) in c.ok if a <= t < b)
        return round(n / max(b - a, 1e-9), 1)

    out = {"victim": victim, "demote_s": round(t_demote - t_fault, 3),
           "new_leaders_s": round(t_new - t_fault, 3),
           "signals": demotes[0].get("signals"),
           "ops_per_s": {"before": rate(t_fault - 4.0, t_fault),
                         "during": rate(t_fault, t_new),
                         "after": rate(t_heal, t_end)},
           "demotions": dem}
    log(f"{what}: slow WAL at replica {victim}: demoted after "
        f"{out['demote_s']} s, a new leader in all {G} groups after "
        f"{out['new_leaders_s']} s; ops/s {out['ops_per_s']}")
    return out


class _KeyWriter:
    """One closed-loop writer streaming unique values of ``value_bytes``
    to one key, through sheds (counted) and failovers; ``acked`` holds
    the last acknowledged value, ``later`` what may have executed."""

    def __init__(self, cluster, key, stop, value_bytes):
        import threading

        self.cluster, self.key, self.stop = cluster, key, stop
        self.value_bytes = value_bytes
        self.acked = {}
        self.later = {}
        self.ok = []
        self.sheds = 0
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def run(self):
        from summerset_tpu_torch.client.drivers import DriverClosedLoop

        ep = self.cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=SERVE_OP_TIMEOUT)
        seq = 0
        while not self.stop.is_set():
            val = f"w.{seq}.".ljust(self.value_bytes, "x")
            rep = drv.put(self.key, val)
            if rep.kind == "success":
                self.acked[self.key] = val
                self.later[self.key] = set()
                self.ok.append((time.monotonic(), rep.latency, ep.current))
            elif rep.kind == "shed":
                self.sheds += 1
                time.sleep(max(rep.retry_after, 0.01))
            elif rep.kind != "redirect":
                self.later.setdefault(self.key, set()).add(val)
                drv._failover(rep)
            seq += 1
        ep.leave()


def _range_cutover(cluster, key, dst, op, what):
    """One ``range_change`` through the manager: sealed at every replica,
    then adopted and installed at all three; returns the seconds."""
    from summerset_tpu_torch.host.resharding import single_key_range

    start, end = single_key_range(key)
    t0 = time.monotonic()
    rep = _ctrl_req(cluster, "range_change",
                    payload={"op": op, "start": start, "end": end,
                             "dst_group": dst})
    if rep.kind != "range_change" or sorted(rep.done or ()) != [0, 1, 2]:
        fail(f"{what}: {op} sealed at {rep.done} ({rep.kind})")
    rc_id = rep.conf["rc_id"]
    while True:
        ents = [[e["rc_id"] for e in r.rangetab.entries()]
                for r in cluster.replicas.values()]
        if all(rc_id in e for e in ents) and all(
                r.route_group(key) == dst for r in cluster.replicas.values()):
            return rc_id, round(time.monotonic() - t0, 3)
        if time.monotonic() - t0 > PLANES_CUT_MAX_S:
            fail(f"{what}: {op} {rc_id} of {key!r} not installed at every "
                 f"replica in {PLANES_CUT_MAX_S} s: {ents}")
        time.sleep(0.1)


def _planes_reshard(torch, np, card, tmp, rs):
    """(c): RSPaxos RS(2,1), phase 13's 3000 B puts: a key split to
    another group with puts to it in flight, then merged back; the
    adopt rides the destination group's log as shards
    (``bitslice_gf256``)."""
    import threading

    what = "planes RSPaxos resharding"
    cluster = _read_cluster("RSPaxos", tmp, config=SERVE_CW_CFG)
    try:
        G = SERVE_SHAPE["G"]
        stop, wstop = threading.Event(), threading.Event()
        clients = [_LoadClient(cluster, ci, stop,
                               value_bytes=SERVE_CW_VALUE_BYTES)
                   for ci in range(SERVE_CLIENTS)]
        key = "zkey"
        writer = _KeyWriter(cluster, key, wstop, SERVE_CW_VALUE_BYTES)
        time.sleep(3.0)
        # the load stops so the cutover's launches are its own; the
        # writer's puts to the key stay in flight through the seal
        stop.set()
        for c in clients:
            c.thread.join(timeout=30)
        home = next(iter(cluster.replicas.values())).group_of(key)
        dst = (home + 1) % G
        shed0 = sum(r.metrics.counter_value("api_shed")
                    for r in cluster.replicas.values())
        n0 = rs.bitslice_gf256.launches
        rc1, split_s = _range_cutover(cluster, key, dst, "split", what)
        launches = rs.bitslice_gf256.launches - n0
        if DEV == "cuda" and launches == 0:
            fail(f"{what}: the adopt never launched bitslice_gf256")
        lead = cluster.leader_of(dst)
        lanes = None
        if lead is not None:
            lr = cluster.replicas[lead]
            for g, vid in sorted(lr.origin):
                b = lr.payloads.get(g, vid)
                held = lr.codewords.shards_for(g, vid)
                if b and b[0][1].cmd.kind == "adopt" and held is not None:
                    lanes = int(next(iter(held[1].values())).shape[-1])
        time.sleep(1.0)
        rc2, merge_s = _range_cutover(cluster, key, home, "merge", what)
        time.sleep(1.0)
        wstop.set()
        writer.thread.join(timeout=30)
        sheds = writer.sheds
        shed_srv = sum(r.metrics.counter_value("api_shed")
                       for r in cluster.replicas.values()) - shed0
        if not writer.acked:
            fail(f"{what}: the writer's puts were never acknowledged")
        routes = {me: [r.route_group(k) for k in (key, "key1", "key2")]
                  for me, r in cluster.replicas.items()}
        if len({tuple(v) for v in routes.values()}) != 1:
            fail(f"{what}: route_group differs between replicas: {routes}")
        n_keys = _read_back(cluster, clients + [writer], what)
        # a snapshot, then a restart of one follower: the ranges stand
        rep = cluster.ctrl("take_snapshot", timeout=300)
        if sorted(rep.done) != [0, 1, 2]:
            fail(f"{what}: take_snapshot answered {rep.done}")
        victim = next(me for me in sorted(cluster.replicas)
                      if me != cluster.leader_of(0))
        t = time.monotonic()
        rep = cluster.ctrl("reset_servers", servers=[victim], timeout=300)
        if rep.done != [victim]:
            fail(f"{what}: restart of {victim} not acknowledged")
        restart_s = round(time.monotonic() - t, 3)
        ents = {me: [e["rc_id"] for e in r.rangetab.entries()]
                for me, r in cluster.replicas.items()}
        if ents[victim] != [rc1, rc2] or len(
                {tuple(v) for v in ents.values()}) != 1:
            fail(f"{what}: the ranges after the restart of {victim}: "
                 f"{ents}")
        _read_back(cluster, [writer], f"{what} after the restart")
        _require_clean(cluster, what)
        line = {"planes_reshard": "RSPaxos", "key": key, "home": home,
                "dst_group": dst, "split_s": split_s, "merge_s": merge_s,
                "sheds": sheds, "api_shed": shed_srv,
                "writer_acked_puts": len(writer.ok),
                "bitslice_launches_split": launches,
                "adopt_shard_lanes": lanes, "read_back_keys": n_keys,
                "restart_s": restart_s, "ranges": ents[victim],
                "card": card}
        log(json.dumps(line))
    finally:
        cluster.stop()
    # held against the plain version at the adopt's shape, timed with
    # the cluster stopped
    err = serving_kernel_numbers(torch, np, rs, card, [lanes]) \
        if lanes else 0
    return {"launches": launches, "max_abs_err": err, "line": line}


def phase_planes(torch, np, card):
    """Phase 20: the observability and control planes at phase 12's
    shape, the JAX default planes on.  MultiPaxos: (a) the scrapes, (d)
    the autopilot, (b) health and demotion; RSPaxos: (c) resharding.
    Returns the kernel's launches in the cutover and its max_abs_err."""
    import shutil
    import tempfile
    import threading
    import types

    from summerset_tpu_torch.ops import rscoding as rs

    sh = SERVE_SHAPE
    what = "planes MultiPaxos"
    log(f"== phase 20: observability and control planes, {sh['G']} groups "
        f"x {sh['R']} replicas, W={sh['W']}, {SERVE_CLIENTS} clients")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="planes_")
    try:
        cluster = _read_cluster("MultiPaxos",
                                os.path.join(tmp, "mp"))
        try:
            stop = threading.Event()
            clients = [_LoadClient(cluster, ci, stop)
                       for ci in range(SERVE_CLIENTS)]
            _await_load(clients)
            w = _window(np, cluster, clients, PLANES_SECS, what)
            scrapes = _planes_scrapes(cluster, clients, what)
            stop.set()
            for c in clients:
                c.thread.join(timeout=30)
            # the hot-key mix; its first PLANES_DEMOTE_CLIENTS clients
            # run on through (b), the rest stop before the fault
            zstop = [threading.Event(), threading.Event()]
            zipf = [_LoadClient(cluster, ci,
                                zstop[ci < PLANES_DEMOTE_CLIENTS],
                                shared_gets=True, zipf=PLANES_ZIPF)
                    for ci in range(SERVE_CLIENTS)]
            auto = _planes_autopilot(np, cluster, what)
            zstop[0].set()
            for c in zipf[PLANES_DEMOTE_CLIENTS:]:
                c.thread.join(timeout=30)
            demote = _planes_demotion(np, cluster,
                                      zipf[:PLANES_DEMOTE_CLIENTS], what)
            zstop[1].set()
            for c in zipf[:PLANES_DEMOTE_CLIENTS]:
                c.thread.join(timeout=30)
            # a key's last acked put is its zipf client's if that client
            # wrote it, else the uniform client's of (a)
            writers = []
            for u, z in zip(clients, zipf):
                later = dict(u.later)
                for k, vals in z.later.items():
                    later[k] = (set() if k in z.acked else
                                set(later.get(k, ()))) | vals
                writers.append(types.SimpleNamespace(
                    acked={**u.acked, **z.acked}, later=later))
            n_keys = _read_back(cluster, writers, what)
            _require_clean(cluster, what, demotions_ok=True)
            log(json.dumps({"planes": "MultiPaxos", **w,
                            "scrapes": scrapes, "autopilot": auto,
                            "demotion": demote,
                            "zipf_sheds": sum(c.sheds for c in zipf),
                            "read_back_keys": n_keys,
                            "bring_up_s": cluster.up_s, "card": card}))
        finally:
            cluster.stop()
        t = time.perf_counter()
        res = _planes_reshard(torch, np, card, os.path.join(tmp, "rsp"),
                              rs)
        log(f"phase 20 resharding: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({"phase": 20, "seconds": round(
        time.perf_counter() - t_phase, 1),
        "bitslice_launches": res["launches"], "card": card}))
    return {"launches": res["launches"], "max_abs_err": res["max_abs_err"]}


# ------------------------------ phase 21: the nemesis and workload planes --
def _slot_agreement(torch, st, what):
    """No two replicas of a group commit different values for one slot
    (slot ``s`` sits at window position ``s % W``); returns the number of
    replica pairs x slots compared."""
    abs_, val = st["win_abs"], st["win_val"]
    com = (abs_ >= 0) & (abs_ < st["commit_bar"][..., None])
    both = ((abs_[:, :, None] == abs_[:, None])
            & com[:, :, None] & com[:, None])
    bad = both & (val[:, :, None] != val[:, None])
    if bool(bad.any()):
        g, r1, r2, p = (int(x) for x in bad.nonzero()[0])
        fail(f"{what}: group {g} slot {int(abs_[g, r1, p])} committed "
             f"{int(val[g, r1, p])} at replica {r1} and "
             f"{int(val[g, r2, p])} at replica {r2}")
    return int(both.sum())


def _plan_window(torch, eng, st, ns, t0, ticks, P, masks=None):
    """``ticks`` ticks of saturating load from absolute tick ``t0``
    through ``run_ticks``, with the plan's per-tick ``alive``,
    ``link_up`` and ``reset`` masks when given.  Returns the state, the
    netstate and the last tick's effects extras."""
    G, R = eng.kernel.G, eng.kernel.R
    dev = eng.device
    t = torch.arange(t0, t0 + ticks, dtype=torch.int32, device=dev)
    seq = {
        "n_proposals": torch.full((ticks, G), P, dtype=torch.int32,
                                  device=dev),
        "value_base": (t * P)[:, None].expand(ticks, G),
        "exec_floor": torch.full((G, R), 1 << 30, dtype=torch.int32,
                                 device=dev).expand(ticks, G, R),
    }
    for k, v in (masks or {}).items():
        seq[k] = v[t0:t0 + ticks].to(dev)
    st, ns, fx = eng.run_ticks(st, ns, seq, collect=True)
    return st, ns, {k: v[-1] for k, v in fx.extra.items()}


def _nemesis_engine(torch, eng, masks, P):
    """The plan's ticks, then the fault-free heal segment: the state and
    netstate after each, the heal's last-tick extras and the seconds."""
    st, ns = eng.init()
    torch.cuda.synchronize()
    a = time.perf_counter()
    st, ns, _ = _plan_window(torch, eng, st, ns, 0, NEM_DEVICE_TICKS, P,
                             masks)
    torch.cuda.synchronize()
    b = time.perf_counter()
    faulted = {k: v.clone() for k, v in st.items()}
    st, ns, fx = _plan_window(torch, eng, st, ns, NEM_DEVICE_TICKS,
                              NEM_HEAL_TICKS, P)
    torch.cuda.synchronize()
    return faulted, st, ns, fx, b - a, time.perf_counter() - b


def _nemesis_device(torch, np, rs, card, proto, cfg, sh):
    """(a) on one protocol: seed 11's plan compiled for the card's G
    through ``Engine.run_ticks`` and a 200-tick heal, checked for
    agreement, commits in every group after the plan, a commit-bar
    spread of at most 4P after the heal, and the first 64 groups equal
    to a CPU run given the card's masks sliced to them (``drop`` draws
    over every group, so ``compile_device(64)`` would differ).  RSPaxos
    then encodes the heal's last-tick values through the codeword plane
    and rebuilds them from 3-of-5 subsets."""
    import itertools

    from summerset_tpu_torch.host.nemesis import FaultPlan

    G, P = sh["G"], sh["P"]
    what = f"nemesis device {proto}"
    plan = FaultPlan.generate(NEM_DEVICE_SEED, sh["R"], NEM_DEVICE_TICKS,
                              classes=NEM_DEVICE_CLASSES)
    t = time.perf_counter()
    masks = plan.compile_device(G, device=DEV)
    compile_s = time.perf_counter() - t
    if any(m.device.type != torch.device(DEV).type for m in masks.values()):
        fail(f"{what}: masks not on {DEV}")
    eng = make_engine(proto, cfg, sh, G, DEV)
    faulted, st, ns, fx, fault_s, heal_s = _nemesis_engine(torch, eng,
                                                           masks, P)
    pairs = _slot_agreement(torch, faulted, what + " (plan)")
    cb0 = faulted["commit_bar"].amax(dim=1)
    if int(cb0.min()) <= 0:
        fail(f"{what}: a group committed nothing under the plan")
    pairs += _slot_agreement(torch, st, what + " (heal)")
    cb = st["commit_bar"]
    spread = cb.amax(dim=1) - cb.amin(dim=1)
    if int(spread.max()) > 4 * P:
        g = int(spread.argmax())
        fail(f"{what}: commit bars of group {g} spread "
             f"{cb[g].tolist()} after the heal")
    if not bool((cb.amax(dim=1) > cb0).all()):
        fail(f"{what}: a group made no progress in the heal")
    cpu_masks = {k: v[:, :CPU_GROUPS].cpu() for k, v in masks.items()}
    _f, st_c, ns_c, _fx, _a, _b = _nemesis_engine(
        torch, make_engine(proto, cfg, sh, CPU_GROUPS, "cpu"), cpu_masks, P)
    n = compare_groups(torch, (st, ns), (st_c, ns_c), CPU_GROUPS, what)
    out = {"protocol": proto, "groups": G, "replicas": sh["R"],
           "window": sh["W"], "P": P, "plan_digest": plan.digest(),
           "plan_events": [e.render() for e in plan.events],
           "compile_s": round(compile_s, 3),
           "fault_ms_per_tick": round(fault_s / NEM_DEVICE_TICKS * 1e3, 3),
           "heal_ms_per_tick": round(heal_s / NEM_HEAL_TICKS * 1e3, 3),
           "commit_bar_min_after_plan": int(cb0.min()),
           "commit_bar_min_after_heal": int(cb.amax(dim=1).min()),
           "spread_max": int(spread.max()), "agreement_pairs": pairs,
           "cpu_groups_equal": CPU_GROUPS, "leaves": n, "card": card}
    if proto == "rspaxos":
        code = rs.RSCode(3, 2, device=DEV)
        n_acc = fx["n_accepted"].amax(dim=1).cpu().numpy()
        B = int(n_acc.sum())
        if B == 0:
            fail(f"{what}: no values proposed in the heal's last tick")
        groups = np.repeat(np.arange(G), n_acc)
        payloads, _data, cw, e_enc = encode_values(
            torch, np, rs, code, B, SEED + 21, what)
        subsets = list(itertools.combinations(range(5), 3))
        calls, e_dec = decode_values(
            torch, np, rs, code, cw,
            [subsets[(g + 3) % len(subsets)] for g in groups], payloads,
            what)
        out.update(encoded_values=B, decode_sets=calls,
                   max_abs_err=max(e_enc, e_dec))
    log(json.dumps({"nemesis_device": out}))
    return out


def _nemesis_seed():
    """The first seed >= 1 whose host plan holds a crash-armed
    ``take_snapshot``, a ``clock_skew``, a ``crash`` and a ``partition``
    (chosen for coverage)."""
    from summerset_tpu_torch.host.nemesis import FaultPlan

    seed = 1
    while True:
        plan = FaultPlan.generate(seed, SERVE_SHAPE["R"], NEM_HOST_TICKS,
                                  classes=NEM_HOST_CLASSES)
        kinds = {(e.kind, e.arg > 0) for e in plan.events}
        if ("take_snapshot", True) in kinds and {
                "clock_skew", "crash", "partition"} <= {k for k, _ in kinds}:
            return seed, plan
        seed += 1


def _api_sheds(cluster):
    from summerset_tpu_torch.client.endpoint import scrape_metrics

    snap = scrape_metrics(cluster.manager_addr, timeout=30.0)
    return sum(s.get("host", {}).get("counters", {}).get("api_shed", 0)
               for s in (snap or {}).values())


def _nemesis_host(card, cluster):
    """(b): a seeded host plan through ``nemesis_soak.soak`` on the live
    cluster (3 recorded clients, ``NemesisRunner``, ``heal_all``; a put
    acked within 20 s of the heal, more than 20 ops, only injected
    crashes, the WAL and window bounds, a linearizable history), then no
    action error and every acked key read back into the history, which
    must stay linearizable."""
    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.host.nemesis import NemesisRunner
    from summerset_tpu_torch.nemesis_soak import soak
    from summerset_tpu_torch.utils.linearize import check_history, record_get

    what = "nemesis host RSPaxos"
    seed, plan = _nemesis_seed()
    log(f"{what}: seed {seed} digest {plan.digest()}")
    for line in plan.timeline().splitlines():
        log(f"  {line}")
    ops = []
    res = {"seed": seed, "digest": plan.digest(), "ok": False}
    runner = NemesisRunner(cluster.manager_addr, plan,
                           tick_len=NEM_TICK_LEN)
    runner.range_keys = NEM_KEYS
    try:
        soak(cluster, runner, res, ops, seed=seed, clients=NEM_CLIENTS,
             keys=NEM_KEYS, recovery_budget_s=NEM_RECOVERY_MAX_S,
             min_ops=NEM_MIN_OPS)
    finally:
        runner.close()
    res.pop("server_metrics", None)
    if not res["ok"]:
        fail(f"{what}: {res.get('error')} ({json.dumps(res, default=str)})")
    if res["action_errors"]:
        fail(f"{what}: fault actions failed: {res['action_errors']}")
    n_ops = len(ops)
    # every key read back after the heal, the reads joining the history
    ep = cluster.endpoint()
    drv = DriverClosedLoop(ep, timeout=SERVE_OP_TIMEOUT * 5)
    for key in NEM_KEYS:
        for _ in range(40):
            t0 = time.monotonic()
            rep = drv.get(key)
            if rep.kind == "success":
                ops.append(record_get(NEM_CLIENTS, key,
                                      rep.result.value if rep.result
                                      else None, t0, time.monotonic()))
                break
            drv._failover(rep)
        else:
            fail(f"{what}: {key} never read back")
    ep.leave()
    acked = {o.key for o in ops if o.kind == "put" and o.acked}
    final = {o.key: o.value for o in ops[-len(NEM_KEYS):]}
    if any(final.get(k) is None for k in acked):
        fail(f"{what}: an acked key read back None: {final}")
    ok, diag = check_history(ops)
    if not ok:
        fail(f"{what}: history with the read-back not linearizable: {diag}")
    out = {"seed": seed, "digest": plan.digest(),
           "executed": res["executed"],
           "action_errors": res["action_errors"],
           "injected_crashes": res["crashes"],
           "leader_demotions": _demotions(cluster),
           "play_s": res["play_s"], "recovery_s": res["recovery_s"],
           "ops": n_ops, "history_ops": len(ops),
           "wal_bytes": res["wal_bytes"], "window_span": res["window_span"],
           "acked_keys_read_back": sorted(acked), "card": card}
    log(json.dumps({"nemesis_host": out}))
    return out


def _workload_plane(card, cluster):
    """(c): a ``hot_burst`` plan through ``start_workload_clients`` for
    ``WL_SECS`` against the small ingress queue: sheds on the scrape, and
    the history (shed puts as negative acks) linearizable."""
    import threading

    from summerset_tpu_torch.client.tester import start_workload_clients
    from summerset_tpu_torch.host.workload import WorkloadPlan
    from summerset_tpu_torch.utils.linearize import check_history

    what = "workload hot_burst"
    plan = WorkloadPlan.generate(WL_SEED, "hot_burst", clients=3)
    tick_len = WL_SECS / plan.horizon()
    shed0 = _api_sheds(cluster)
    stop = threading.Event()
    ops, stats = [], []
    t0 = time.monotonic()

    def rate_total_of():
        return plan.rate_x_at((time.monotonic() - t0) / tick_len) * WL_CAP

    threads = start_workload_clients(cluster.manager_addr, plan,
                                     rate_total_of, stop, ops, stats,
                                     timeout=5.0)
    time.sleep(WL_SECS)
    stop.set()
    for th in threads:
        th.join(timeout=30)
    sheds = _api_sheds(cluster) - shed0
    if sheds <= 0:
        fail(f"{what}: no shed on the scrape (stats {stats})")
    ok, diag = check_history(ops)
    if not ok:
        fail(f"{what}: history not linearizable: {diag}")
    lat = sorted(o.t_resp - o.t_inv for o in ops
                 if o.acked and o.t_resp != float("inf"))
    if not lat:
        fail(f"{what}: no op acked")
    out = {"seed": WL_SEED, "digest": plan.digest(), "secs": WL_SECS,
           "offered_ops_per_s_at_1x": WL_CAP,
           "accepted_ops_per_s": round(len(lat) / WL_SECS, 1),
           "p50_ms": round(lat[len(lat) // 2] * 1e3, 3),
           "p99_ms": round(lat[min(len(lat) - 1,
                                   int(len(lat) * 0.99))] * 1e3, 3),
           "api_shed": sheds,
           "client_counts": {k: sum(s[k] for s in stats)
                             for k in ("issued", "acked", "shed", "held",
                                       "expired", "window")},
           "history_ops": len(ops), "card": card}
    log(json.dumps({"workload": out}))
    return out


def phase_nemesis(torch, np, card):
    """Phase 21: (a) the device plane on RSPaxos 1024x5 and MultiPaxos
    4096x5, (b) the host plane and (c) the workload plane on a live
    RSPaxos cluster at phase 12's shape.  Returns the kernel's launches
    (the engine's codeword plane and the live cluster's encodes and
    rebuilds) and its max_abs_err."""
    import shutil
    import tempfile

    from summerset_tpu_torch.ops import rscoding as rs
    from summerset_tpu_torch.protocols.multipaxos import (
        ReplicaConfigMultiPaxos,
    )
    from summerset_tpu_torch.protocols.rspaxos import ReplicaConfigRSPaxos

    log("== phase 21: nemesis and workload planes (device plan on RSPaxos "
        f"{RS_SHAPE['G']}x{RS_SHAPE['R']} and MultiPaxos {MP_SHAPE['G']}x"
        f"{MP_SHAPE['R']}; host plan and hot_burst on RSPaxos "
        f"{SERVE_SHAPE['G']}x{SERVE_SHAPE['R']})")
    t_phase = time.perf_counter()
    rs.bitslice_gf256.launches = 0
    rsp = _nemesis_device(torch, np, rs, card, "rspaxos",
                          ReplicaConfigRSPaxos(
                              max_proposals_per_tick=RS_SHAPE["P"],
                              chunk_size=2 * RS_SHAPE["P"],
                              exec_follows_commit=False, fault_tolerance=1),
                          RS_SHAPE)
    dev_launches = rs.bitslice_gf256.launches
    if dev_launches == 0:
        fail("nemesis device rspaxos: bitslice_gf256 never launched")
    _nemesis_device(torch, np, rs, card, "multipaxos",
                    ReplicaConfigMultiPaxos(
                        max_proposals_per_tick=MP_SHAPE["P"],
                        chunk_size=2 * MP_SHAPE["P"],
                        exec_follows_commit=False),
                    MP_SHAPE)
    log(f"phase 21 (a): {time.perf_counter() - t_phase:.1f} s")
    tmp = tempfile.mkdtemp(prefix="nemesis_")
    t = time.perf_counter()
    try:
        cluster = _read_cluster("RSPaxos", tmp,
                                config=NEM_HOST_CFG)
        try:
            host = _nemesis_host(card, cluster)
            log(f"phase 21 (b): {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            wl = _workload_plane(card, cluster)
            log(f"phase 21 (c): {time.perf_counter() - t:.1f} s")
        finally:
            cluster.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = rs.bitslice_gf256.launches
    if launches <= dev_launches:
        fail("nemesis host RSPaxos: bitslice_gf256 never launched")
    log(json.dumps({"phase": 21, "seconds": round(
        time.perf_counter() - t_phase, 1), "bitslice_launches": launches,
        "device_plane_launches": dev_launches,
        "cluster_launches": launches - dev_launches,
        "recovery_s": host["recovery_s"],
        "accepted_ops_per_s": wl["accepted_ops_per_s"],
        "card": card}))
    return {"launches": launches, "max_abs_err": rsp["max_abs_err"]}


def planes_ab(torch, np, card, order=("on", "off", "off", "on")):
    """Phase 12's MultiPaxos run (its window, pause, resets, snapshot and
    profile) with the servers' default planes on and with ``PLANES_OFF``,
    in turns within one call; one ``planes_ab`` JSON line per run.  Not
    part of ``main``: ``python3 -c 'import torch, numpy as np,
    chip_smoke as cs; cs.phase_build(); cs.planes_ab(torch, np,
    cs.card_label())'``."""
    global SERVE_BASE_CFG
    out = []
    try:
        for planes in order:
            SERVE_BASE_CFG = dict(PLANES_OFF) if planes == "off" else {}
            line = _serve_run(torch, np, card, "MultiPaxos", SERVE_SECS,
                              _pause_and_resets("MultiPaxos"),
                              read_back=True, profile=True, snapshot=True)
            rec = {"planes_ab": planes, "config": SERVE_BASE_CFG,
                   **{k: line[k] for k in ("ops_per_s", "p50_ms", "p99_ms",
                                           "ticks_per_s", "stage_mean_us")},
                   "failover_s": line["faults"]["pause"]["recovered_s"],
                   "profile": line.get("profile"), "card": card}
            log(json.dumps(rec))
            out.append(rec)
    finally:
        SERVE_BASE_CFG = {}
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        import numpy as np
        import summerset_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"summerset_tpu_torch is not importable here: {e}",
              file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    card = card_label()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    secs = {}

    def timed(n, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[str(n)] = round(time.perf_counter() - t, 1)
        return out

    timed(1, phase_build)
    max_err = timed(2, phase_kernels, torch, np, card)
    timed(3, phase_multipaxos, torch, card)
    main_path = timed(4, phase_rspaxos, torch, np, card)
    timed(5, phase_raft, torch, card)
    paths = {"rspaxos": main_path,
             "craft": timed(6, phase_craft, torch, np, card),
             "crossword": timed(7, phase_crossword, torch, np, card)}
    log("bitslice_gf256 launches by path: " + ", ".join(
        f"{k} {v['launches']}" for k, v in paths.items()))
    from summerset_tpu_torch.ops import rscoding as rs

    rs.bitslice_gf256.launches = 0
    timed(8, phase_quorum_leases, torch, card)
    timed(9, phase_bodega, torch, card)
    timed(10, phase_basic, torch, card)
    log(f"bitslice_gf256 launches in phases 8-10 (no codeword plane): "
        f"{rs.bitslice_gf256.launches}")
    rs.bitslice_gf256.launches = 0
    timed(11, phase_epaxos, torch, np, card)
    log(f"bitslice_gf256 launches in phase 11 (no codeword plane): "
        f"{rs.bitslice_gf256.launches}")
    mp, _raft = timed(12, phase_serving, torch, np, card)
    serving = timed(13, phase_codeword_serving, torch, np, card, mp)
    paths["serving"] = serving
    rs.bitslice_gf256.launches = 0
    timed(14, phase_lease_serving, torch, np, card)
    timed(15, phase_process_cluster, np, card, mp)
    timed(16, phase_bench, card)
    timed(17, phase_epaxos_serving, torch, np, card)
    timed(18, phase_basic_serving, torch, np, card)
    log(f"bitslice_gf256 launches in phases 14-18 (no codeword plane): "
        f"{rs.bitslice_gf256.launches}")
    rs.bitslice_gf256.launches = 0
    paths["read_tier"] = timed(19, phase_read_tier, torch, np, card)
    rs.bitslice_gf256.launches = 0
    paths["planes"] = timed(20, phase_planes, torch, np, card)
    rs.bitslice_gf256.launches = 0
    paths["nemesis"] = timed(21, phase_nemesis, torch, np, card)
    log("bitslice_gf256 launches by path (the kernels line): " + ", ".join(
        f"{k} {v['launches']}" for k, v in paths.items()))
    total = round(time.perf_counter() - t_start, 1)
    log(f"total {total} s")
    print(json.dumps({"phase_seconds": secs, "total_s": total}),
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "bitslice_gf256",
        "route": "cuda",
        "source": "summerset_tpu_torch/csrc/bitslice.cu",
        "replaces": "summerset_tpu/ops/rscoding.py:176",
        "launches": sum(v["launches"] for v in paths.values()),
        "max_abs_err": max([max_err] + [v["max_abs_err"]
                                         for v in paths.values()]),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
