"""Deterministic nemesis engine: seeded fault schedules across planes,
counterpart of ``summerset_tpu/host/nemesis.py``.

One ``FaultPlan`` (a seed-generated list of timed fault events) compiles
into coordinated actions on the seams of the stack:

1. **Device plane** (``core/netmodel.ControlInputs``): ``compile_device``
   lowers the plan to per-tick ``alive``/``link_up``/``reset`` mask
   sequences for ``Engine.run_ticks``, as tensors on ``device``.
2. **Host message plane** (``host/transport.py`` and
   ``utils/safetcp.FrameFaults``): partitions, one-way link faults, iid
   drop, duplication and added delay on a live cluster's mesh, installed
   through the manager (``CtrlRequest("inject_faults")`` -> per-server
   ``fault_ctl``).
3. **Disk plane** (``host/storage.StorageHub.set_faults``): torn tail
   records and failing fsyncs; the replica's durability gate turns these
   into crashes ("injected" in the error), and its supervisor restart
   replays the WAL.

Crash/restart and pause/resume ride the manager's orchestration
(``reset_servers`` / ``pause_servers``); clock skew and the snapshot crash
point ride ``fault_ctl`` (``skew``, ``snap_crash``).

Determinism contract: ``FaultPlan.generate(seed, ...)`` draws only from
``random.Random(seed)``, so the same seed always yields a byte-identical
``timeline()`` and identical compiled masks, equal to the JAX package's
(``tests/test_torch_nemesis.py``).  On a live cluster the schedule is
deterministic while OS-level interleaving stays real.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..host.messages import CtrlRequest
from ..utils.errors import SummersetError
from ..utils.logging import pf_info, pf_logger, pf_warn

logger = pf_logger("nemesis")

# every fault class the engine knows how to schedule; generation defaults
# to the full set, callers narrow it (e.g. device-only plans skip wal_*)
ALL_CLASSES = (
    "crash",       # durable crash-restart (manager-orchestrated)
    "device_reset",  # durable DEVICE crash: down for `duration`, then the
                   # state row is rebuilt from the kernel's declared
                   # durable leaves only (volatile rows zeroed) — the
                   # host lowering is a manager durable reset, so both
                   # planes lose volatile state the same way
    "pause",       # SIGSTOP-style freeze + resume after `duration`
    "partition",   # symmetric split: targets vs the rest
    "isolate",     # cut each target from everyone
    "one_way",     # asymmetric: src->dst down, reverse fine
    "drop",        # iid per-frame loss at prob `arg` on targets' egress
    "delay",       # +`arg` seconds one-way ingress delay at targets
    "dup",         # per-frame duplication at prob `arg`
    "wal_torn",    # next WAL append tears mid-record; replica crashes
    "wal_fsync",   # next `arg` fsyncs fail; durability gate crashes
    "clock_skew",  # targets' tick clocks run at rate `arg` < 1 (device:
                   # duty-cycled alive masks; host: tick_interval / arg)
    "conf_change",  # drive a client ConfChange (responders := targets)
                   # through the manager relay WHILE other faults play —
                   # the QuorumLeases/Bodega revoke-then-adopt barrier's
                   # adversarial coverage; conf-less protocols answer
                   # with an explicit failure (the reply path is still
                   # exercised)
    "take_snapshot",  # compaction on the serving path: targets snapshot
                   # + WAL-compact mid-schedule; arg=1 arms a crash
                   # point between the snapshot write and the WAL
                   # truncate (recovery must reconcile new snapshot +
                   # old WAL)
    # -- gray failures (fail-slow: the victim stays alive enough to hold
    # leadership/leases while tanking the group; host/health.py is the
    # detection plane, voluntary leader demotion the mitigation) --
    "slow_disk",   # StorageHub fsync/append latency inflated x `arg`
                   # on targets for `duration` (a limping disk)
    "slow_peer",   # egress token-bucket bandwidth cap + CPU-starve duty
                   # cycle `arg` on targets (a rate-limited NIC / a
                   # CPU-starved host) — distinct from `delay`, which
                   # models the LINK in the receiver's messenger thread
                   # and leaves the sender at full speed
    "mem_pressure",  # bounded WAL write-back buffer (`arg` bytes): group
                   # commit degrades to constant forced fsyncs + reclaim
                   # stalls (memory pressure on the durability path)
    "range_change",  # live resharding under fire (host/resharding.py):
                   # drive a key-range split through the manager ctrl
                   # plane WHILE partitions/crashes play — the seal ->
                   # barrier -> adopt cutover's adversarial coverage
                   # (arg selects which canonical runner key moves; the
                   # destination group rides the first target id,
                   # normalized mod G server-side).  Leaderless
                   # protocols answer with an explicit refusal — the
                   # reply path is still exercised, like conf_change
    "proxy_crash",  # serving-plane tier fault (the ingress tier): kill an
                   # ingress PROXY (targets = proxy indices, not replica
                   # ids) and restart it after `duration` ticks — its
                   # ctrl-connection drop deregisters it at the manager,
                   # so clients must rediscover the tier via the
                   # re-announce in their next query_info/rotate.  Played
                   # through NemesisRunner.proxy_ctl (wired to a live
                   # host/ingress.ServingPlane.proxy_ctl, as
                   # nemesis_soak.soak(plane=) does); plans without an
                   # attached proxy tier record the action as an error,
                   # not fatal
)

# slow_peer host-lowering constants: the bandwidth cap is sized so a
# 3-replica localhost mesh limps (frames stall tens of ms/tick) without
# looking dead — heartbeats still land well inside election timeouts
SLOW_PEER_BW = 48_000.0  # bytes/second egress

# classes with no device-plane lowering: frame-level delay/duplication are
# netmodel *config* (delay line depth), not per-tick masks, the WAL /
# snapshot files are host-only, and the conf plane is driven by host
# inputs the mask compiler does not carry.  compile_device skips these
# (documented weakening).
HOST_ONLY = (
    "delay", "dup", "wal_torn", "wal_fsync", "conf_change",
    "take_snapshot",
    # the resharding ctrl plane is host machinery (manager fan-out +
    # host seal/adopt state); the lockstep device plane has no analog
    "range_change",
    # fail-slow classes are host-only like wal_*: the lockstep device
    # plane has no notion of a replica running SLOWER than the tick (the
    # closest device analog, duty-cycled aliveness, is already
    # clock_skew) — disk latency, egress bandwidth, and allocator
    # pressure live in the host hubs
    "slow_disk", "slow_peer", "mem_pressure",
    # the proxy tier is a host-process tier with no device analog at all
    "proxy_crash",
)
# instantaneous events: no heal action at tick + duration
INSTANT = ("crash", "wal_torn", "wal_fsync", "conf_change",
           "take_snapshot", "range_change")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timed fault.  ``tick`` is in nemesis schedule ticks (scaled to
    wall time by the runner, mapped 1:1 to engine ticks by the device
    compiler); a non-instant event holds for ``duration`` ticks and then
    heals."""

    tick: int
    kind: str
    targets: Tuple[int, ...] = ()
    duration: int = 0
    arg: float = 0.0

    def render(self) -> str:
        return (
            f"@{self.tick:05d} {self.kind}"
            f" targets={list(self.targets)}"
            f" dur={self.duration} arg={self.arg:g}"
        )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int
    population: int
    ticks: int
    events: Tuple[FaultEvent, ...]

    # ------------------------------------------------------------ build
    @staticmethod
    def generate(
        seed: int,
        population: int,
        ticks: int,
        classes: Sequence[str] = ALL_CLASSES,
        heal_tail: Optional[int] = None,
    ) -> "FaultPlan":
        """Draw a sequential (non-overlapping) schedule from the seed.

        Victim counts are capped at a sub-quorum minority so the cluster
        can keep serving (or at least electing) *during* the fault, and
        every fault heals before ``heal_tail`` — the final fault-free
        stretch the soak's recovery assertion runs in.
        """
        import random

        for c in classes:
            if c not in ALL_CLASSES:
                raise ValueError(f"unknown fault class {c!r}")
        rng = random.Random(seed)
        R = population
        max_victims = max(1, (R - 1) // 2)
        if heal_tail is None:
            heal_tail = max(10, ticks // 4)
        events: List[FaultEvent] = []
        t = rng.randint(2, 6)
        while t < ticks - heal_tail:
            kind = rng.choice(list(classes))
            dur = rng.randint(4, max(5, ticks // 6))
            if t + dur >= ticks - heal_tail:
                dur = ticks - heal_tail - t - 1
                if dur < 2 and kind not in INSTANT:
                    break
            nv = rng.randint(1, max_victims)
            targets = tuple(sorted(rng.sample(range(R), nv)))
            arg = 0.0
            if kind == "one_way":
                src, dst = rng.sample(range(R), 2)
                targets = (src, dst)
            elif kind == "drop":
                arg = round(rng.uniform(0.1, 0.5), 3)
            elif kind == "dup":
                arg = round(rng.uniform(0.1, 0.4), 3)
            elif kind == "delay":
                arg = round(rng.uniform(0.02, 0.2), 3)
            elif kind == "clock_skew":
                # tick-rate scale: 0.3 = the victim's clock runs at 30%
                # of the cluster's (the lease planes are the at-risk
                # consumer — a slow holder's countdowns outlive the
                # grantor's real-time intent)
                arg = round(rng.uniform(0.3, 0.8), 3)
            elif kind == "wal_fsync":
                arg = float(rng.randint(1, 3))
            elif kind == "slow_disk":
                # latency inflation factor: severe enough to tank the
                # victim's tick loop (one group-commit fsync per busy
                # tick) while staying far from fail-stop
                arg = float(rng.randint(10, 30))
            elif kind == "slow_peer":
                # CPU-starve duty cycle; the egress bandwidth cap rides
                # along at SLOW_PEER_BW in the lowering
                arg = round(rng.uniform(0.5, 0.85), 3)
            elif kind == "mem_pressure":
                # write-back buffer cap in BYTES: smaller than one
                # tick's WAL records, so nearly every append forces an
                # inline fsync + reclaim stall
                arg = float(rng.choice((256, 512)))
            elif kind == "take_snapshot":
                # ~1/3 of snapshots crash between the snapshot write and
                # the WAL truncate — the window where a half-finished
                # compaction must still recover losslessly
                arg = 1.0 if rng.random() < 0.34 else 0.0
            elif kind == "range_change":
                # which canonical runner key to split off (the runner's
                # range_keys tuple); targets[0] seeds the destination
                arg = float(rng.randint(0, 2))
            if kind in INSTANT:
                dur = 0
            events.append(FaultEvent(t, kind, targets, dur, arg))
            # crashes are wall-serialized by the manager (ack + rejoin),
            # and a crash-armed snapshot restarts its victims through the
            # supervisor; leave slack so the next event still lands in
            # its window
            gap = rng.randint(3, 9) + (
                6 if kind in ("crash", "device_reset")
                or (kind == "take_snapshot" and arg > 0) else 0
            )
            t += max(dur, 1) + gap
        return FaultPlan(seed, population, ticks, tuple(events))

    @staticmethod
    def failslow(
        kind: str,
        seed: int,
        population: int,
        ticks: int,
        arg: Optional[float] = None,
    ) -> "FaultPlan":
        """Canonical single-event gray-failure plan for the fail-slow
        soak matrix: one ``kind`` event starting a few ticks in and
        holding until a short heal tail — long enough for detection,
        demotion, and a post-mitigation throughput window to play out
        WHILE the victim is still limping.

        The event targets replica 0 as a placeholder; the soak runner
        retargets it to the LIVE leader at fire time (the victim that
        makes fail-slow a group-wide outage), exactly like the workload
        soak's mid-burst leader crash.  The digest covers this canonical
        form, so recorded fail-slow rows stay replayable per seed while the victim stays a runtime decision.
        """
        import random

        if kind not in ("slow_disk", "slow_peer", "mem_pressure"):
            raise ValueError(f"not a fail-slow class: {kind!r}")
        import zlib

        # stable per-class stream: str.__hash__ is process-randomized
        # and would break the byte-identical-per-seed digest contract
        rng = random.Random((seed << 8) ^ (zlib.crc32(kind.encode()) % 251))
        onset = rng.randint(4, 8)
        if arg is None:
            # severities above the generate() ranges: the soak's twin
            # cells must make the victim's tick unambiguously dominated
            # by the limp (the >= 2x mitigated-throughput assertion),
            # while staying far under election timeouts — gray, not dead
            arg = {
                "slow_disk": float(rng.randint(40, 60)),
                "slow_peer": round(rng.uniform(0.7, 0.85), 3),
                # pathological allocator: smaller than ANY WAL record,
                # so every append pays a direct-reclaim flush
                "mem_pressure": float(rng.choice((64, 128))),
            }[kind]
        heal_tail = max(6, ticks // 8)
        dur = max(4, ticks - onset - heal_tail)
        ev = FaultEvent(onset, kind, (0,), dur, float(arg))
        return FaultPlan(seed, population, ticks, (ev,))

    @staticmethod
    def proxy_crash(
        seed: int,
        population: int,
        ticks: int,
        proxies: int = 2,
        at: Optional[int] = None,
        restart_after: int = 10,
    ) -> "FaultPlan":
        """Canonical single-event proxy-tier crash plan: kill ingress
        proxy ``seed % proxies`` at schedule tick ``at`` (or a seeded
        point ~1/3 in) and restart it ``restart_after`` ticks later.
        Targets are PROXY indices; a runner plays it against a live
        proxy tier through ``NemesisRunner.proxy_ctl`` (wired to
        ``ServingPlane.proxy_ctl``; with nothing wired, a runner records
        the action as an error).  Deterministic given its arguments,
        so committed rows regenerate the digest without a cluster —
        the same contract as :meth:`failslow`."""
        import random

        rng = random.Random((seed << 8) ^ 0x9C)
        if at is None:
            at = rng.randint(max(2, ticks // 3), max(3, ticks // 2))
        pidx = seed % max(1, int(proxies))
        ev = FaultEvent(
            int(at), "proxy_crash", (pidx,),
            max(1, int(restart_after)), 0.0,
        )
        return FaultPlan(seed, population, ticks, (ev,))

    # ------------------------------------------------------- determinism
    def timeline(self) -> str:
        """Canonical rendering; byte-identical for identical plans (the
        repro contract — soak failures print this plus the seed)."""
        head = (
            f"# FaultPlan v1 seed={self.seed}"
            f" population={self.population} ticks={self.ticks}\n"
        )
        return head + "".join(e.render() + "\n" for e in self.events)

    def digest(self) -> str:
        return hashlib.sha256(self.timeline().encode()).hexdigest()[:16]

    # ----------------------------------------------------- device plane
    def compile_device(self, G: int, device=None) -> Dict[str, Any]:
        """Lower to per-tick ``alive`` [T, G, R] / ``link_up`` [T, G, R, R]
        / ``reset`` [T, G, R] mask sequences for ``Engine.run_ticks``
        (append to its ``inputs_seq``).  Crash lowers to freeze-and-thaw
        (``alive`` down for the duration) — the pause-like legacy model;
        ``device_reset`` is the durable crash: down for the duration,
        then the ``reset`` mask fires on the thaw tick and the engine
        rebuilds the state row from only the kernel's declared durable
        leaves (``engine.reset_durable_rows``), so volatile state is
        demonstrably lost.  ``HOST_ONLY`` classes are skipped here.

        The masks are built on the host (numpy, equal to the JAX
        package's arrays) and returned as bool tensors on ``device``
        (default ``"cuda"``; it raises with no card unless the CPU is
        asked for)."""
        from ..core.netmodel import ControlInputs
        from ..device import resolve_device

        dev = resolve_device(device)

        T, R = self.ticks, self.population
        alive = np.ones((T, G, R), bool)
        link = np.ones((T, G, R, R), bool)
        reset = np.zeros((T, G, R), bool)
        for ev in self.events:
            lo = ev.tick
            hi = min(ev.tick + max(ev.duration, 1), T)
            if lo >= T:
                continue
            if ev.kind in ("crash", "pause", "device_reset"):
                alive[lo:hi][:, :, list(ev.targets)] = False
                if ev.kind == "device_reset" and hi < T:
                    # restart-from-durable-lanes on the thaw tick: the
                    # replica steps tick `hi` already reborn (alive, but
                    # with every volatile leaf zeroed)
                    reset[hi][:, list(ev.targets)] = True
            elif ev.kind == "clock_skew":
                # duty-cycled alive: the victim steps only on ticks where
                # its scaled clock advances a whole tick (deterministic —
                # no RNG — so the compiled masks stay byte-identical).
                # Under lockstep semantics this is the adversarial
                # superset of real skew: countdowns crawl AND off-tick
                # deliveries are lost (see ControlInputs.skew_alive).
                m = ControlInputs.skew_alive(
                    G, R, hi - lo, {t: ev.arg for t in ev.targets},
                    offset=lo, device="cpu",
                ).numpy()
                alive[lo:hi] &= m
            elif ev.kind == "partition":
                m = ControlInputs.split_links(
                    G, R, ev.targets, device="cpu").numpy()
                link[lo:hi] &= m[None]
            elif ev.kind == "isolate":
                m = ControlInputs.isolate_links(
                    G, R, *ev.targets, device="cpu").numpy()
                link[lo:hi] &= m[None]
            elif ev.kind == "one_way":
                src, dst = ev.targets
                m = ControlInputs.one_way_down(
                    G, R, src, dst, device="cpu").numpy()
                link[lo:hi] &= m[None]
            elif ev.kind == "drop":
                # iid per-(tick, group, link) loss, seeded off the plan:
                # the same seed compiles the same loss pattern
                rng = np.random.default_rng([self.seed, ev.tick])
                keep = rng.random((hi - lo, G, R, R)) >= ev.arg
                sel = np.zeros(R, bool)
                sel[list(ev.targets)] = True
                keep |= ~sel[None, None, :, None]  # only targets' egress
                keep |= np.eye(R, dtype=bool)[None, None]  # self-links up
                link[lo:hi] &= keep
        return {k: torch.from_numpy(v).to(dev) for k, v in
                (("alive", alive), ("link_up", link), ("reset", reset))}

    # ------------------------------------------------------- host plane
    def host_actions(self) -> List[Tuple[int, str, str, dict]]:
        """Flatten to a sorted action list for the live-cluster runner:
        ``(tick, action, desc, spec)`` where ``action`` names a runner
        verb and ``spec`` its arguments.  Duration events contribute an
        explicit heal action at ``tick + duration``."""
        acts: List[Tuple[int, str, str, dict]] = []
        R = self.population

        def others(ts):
            return [r for r in range(R) if r not in ts]

        for ev in self.events:
            ts = list(ev.targets)
            end = ev.tick + ev.duration
            if ev.kind in ("crash", "device_reset"):
                # on the host plane BOTH are durable crash-restarts (the
                # live replica already loses its volatile process state);
                # device_reset's distinct lowering is device-side only
                acts.append((ev.tick, "reset", ev.render(),
                             {"servers": ts}))
            elif ev.kind == "pause":
                acts.append((ev.tick, "pause", ev.render(),
                             {"servers": ts}))
                acts.append((end, "resume", f"@{end:05d} resume"
                             f" targets={ts}", {"servers": ts}))
            elif ev.kind in ("partition", "isolate"):
                # cutting both directions at the victims' side alone
                # severs the link: egress dies at their mute, ingress
                # from the far side dies at their deaf
                if ev.kind == "partition":
                    spec = {"mute": others(ts), "deaf": others(ts)}
                    net = {r: spec for r in ts}
                else:
                    net = {
                        r: {
                            "mute": [p for p in range(R) if p != r],
                            "deaf": [p for p in range(R) if p != r],
                        }
                        for r in ts
                    }
                acts.append((ev.tick, "net", ev.render(), {"per": net}))
                acts.append((end, "net_clear", f"@{end:05d} heal"
                             f" targets={ts}", {"servers": ts}))
            elif ev.kind == "one_way":
                src, dst = ev.targets
                acts.append((ev.tick, "net", ev.render(),
                             {"per": {src: {"mute": [dst]}}}))
                acts.append((end, "net_clear", f"@{end:05d} heal"
                             f" targets=[{src}]", {"servers": [src]}))
            elif ev.kind in ("drop", "delay", "dup"):
                key = {"drop": "drop", "delay": "delay", "dup": "dup"}[
                    ev.kind
                ]
                spec = {key: {"*": ev.arg}}
                acts.append((ev.tick, "net", ev.render(),
                             {"per": {r: spec for r in ts}}))
                acts.append((end, "net_clear", f"@{end:05d} heal"
                             f" targets={ts}", {"servers": ts}))
            elif ev.kind == "clock_skew":
                # host lowering: stretch the victims' tick interval by
                # 1/rate through the fault_ctl plane; heal restores 1.0
                acts.append((ev.tick, "skew", ev.render(),
                             {"servers": ts,
                              "factor": round(1.0 / ev.arg, 3)}))
                acts.append((end, "skew", f"@{end:05d} skew heal"
                             f" targets={ts}",
                             {"servers": ts, "factor": None}))
            elif ev.kind == "conf_change":
                # responders := targets — driven through the data plane
                # (a real client ConfChange) while the rest of the
                # schedule keeps playing
                acts.append((ev.tick, "conf_change", ev.render(),
                             {"responders": ts}))
            elif ev.kind == "take_snapshot":
                acts.append((ev.tick, "take_snapshot", ev.render(),
                             {"servers": ts, "crash": bool(ev.arg)}))
            elif ev.kind == "range_change":
                # a live split driven through the ctrl plane while the
                # rest of the schedule keeps playing (normalized mod G
                # at the servers — a G=1 cluster still exercises the
                # full seal/barrier/adopt cutover as a self-move)
                acts.append((ev.tick, "range_change", ev.render(),
                             {"sel": int(ev.arg),
                              "dst": ts[0] if ts else 0}))
            elif ev.kind == "slow_disk":
                acts.append((ev.tick, "wal", ev.render(),
                             {"servers": ts, "spec": {"slow": ev.arg}}))
                acts.append((end, "wal", f"@{end:05d} slow_disk heal"
                             f" targets={ts}",
                             {"servers": ts, "spec": None}))
            elif ev.kind == "mem_pressure":
                acts.append((ev.tick, "wal", ev.render(),
                             {"servers": ts,
                              "spec": {"mem": int(ev.arg)}}))
                acts.append((end, "wal", f"@{end:05d} mem_pressure heal"
                             f" targets={ts}",
                             {"servers": ts, "spec": None}))
            elif ev.kind == "slow_peer":
                spec = {"bw": SLOW_PEER_BW, "starve": ev.arg}
                acts.append((ev.tick, "net", ev.render(),
                             {"per": {r: spec for r in ts}}))
                acts.append((end, "net_clear", f"@{end:05d} slow_peer "
                             f"heal targets={ts}", {"servers": ts}))
            elif ev.kind == "proxy_crash":
                # targets are PROXY indices (the runner's proxy_ctl maps
                # them onto the live ServingPlane); the heal action is
                # the restart — a fresh incarnation on the same port
                acts.append((ev.tick, "proxy_crash", ev.render(),
                             {"proxies": ts}))
                acts.append((end, "proxy_restart",
                             f"@{end:05d} proxy restart targets={ts}",
                             {"proxies": ts}))
            elif ev.kind == "wal_torn":
                acts.append((ev.tick, "wal", ev.render(),
                             {"servers": ts, "spec": {"torn": 1}}))
            elif ev.kind == "wal_fsync":
                acts.append((
                    ev.tick, "wal", ev.render(),
                    {"servers": ts,
                     "spec": {"fsync_fail": int(ev.arg)}},
                ))
        acts.sort(key=lambda a: a[0])
        return acts


class NemesisRunner:
    """Plays a FaultPlan against a live cluster through the manager
    control plane.  One schedule tick maps to ``tick_len`` wall seconds;
    blocking actions (manager-serialized crash-restarts) may slide later
    events' wall times, but never their order or logical ticks — the
    logical timeline IS the plan."""

    def __init__(
        self,
        manager_addr: Tuple[str, int],
        plan: FaultPlan,
        tick_len: float = 0.25,
        on_action: Optional[Callable[[int, str], None]] = None,
    ):
        from ..client.endpoint import GenericEndpoint

        self.plan = plan
        self.tick_len = tick_len
        self.manager_addr = manager_addr
        self.ep = GenericEndpoint(manager_addr)  # ctrl stub only
        self.executed: List[Tuple[int, str]] = []
        self._on_action = on_action
        # serving-plane hook: the soak wires this to a live
        # ServingPlane so proxy_crash/proxy_restart actions land on real
        # proxy processes; plans scheduling proxy faults without a tier
        # attached record the action error (not fatal) like any other
        # impossible fault action
        self.proxy_ctl: Optional[Callable[[str, dict], None]] = None
        # canonical keys range_change events move (sel = arg indexes
        # this tuple); soaks override it with keys their workload
        # actually writes so the cutover carries real state
        self.range_keys: Tuple[str, ...] = ("nem0", "nem1", "nem2")
        # in-flight conf_change driver threads: conf entries ride the log
        # and may take many ticks to install under faults — the schedule
        # must keep playing WHILE they do (that concurrency is the point)
        self._conf_threads: List[threading.Thread] = []

    # --------------------------------------------------------- plumbing
    def _request(self, req: CtrlRequest, timeout: float = 60.0):
        return self.ep.ctrl.request(req, timeout=timeout)

    def _inject(self, servers: List[int], payload: dict) -> None:
        payload = dict(payload)
        payload.setdefault(
            "seed", self.plan.seed * 1000003 % (1 << 31)
        )
        self._request(CtrlRequest(
            "inject_faults", servers=servers, payload=payload,
        ))

    def _run_action(self, action: str, spec: dict) -> None:
        if action == "reset":
            # durable crash-restart; serialized by the manager (ack,
            # id free, rejoin) — the long pole of the schedule
            self._request(
                CtrlRequest("reset_servers", servers=spec["servers"],
                            durable=True),
                timeout=240.0,
            )
        elif action == "pause":
            self._request(CtrlRequest(
                "pause_servers", servers=spec["servers"]))
        elif action == "resume":
            self._request(CtrlRequest(
                "resume_servers", servers=spec["servers"]))
        elif action == "net":
            for sid, net in spec["per"].items():
                self._inject([sid], {"net": net})
        elif action == "net_clear":
            self._inject(spec["servers"], {"net": None})
        elif action == "wal":
            self._inject(spec["servers"], {"wal": spec["spec"]})
        elif action == "skew":
            self._inject(spec["servers"], {"skew": spec["factor"]})
        elif action == "conf_change":
            self._start_conf_change(list(spec["responders"]))
        elif action == "range_change":
            self._start_range_change(int(spec["sel"]), int(spec["dst"]))
        elif action in ("proxy_crash", "proxy_restart"):
            if self.proxy_ctl is None:
                raise SummersetError(
                    "proxy fault scheduled but no serving plane attached"
                )
            self.proxy_ctl(action, spec)
        elif action == "take_snapshot":
            if spec.get("crash"):
                # arm the crash point FIRST: the snapshot request then
                # dies between the snapshot write and the WAL truncate,
                # and the victim's supervisor restart exercises the
                # new-snapshot + old-WAL recovery path
                self._inject(spec["servers"], {"snap_crash": 1})
            self._request(
                CtrlRequest("take_snapshot", servers=spec["servers"]),
                timeout=60.0,
            )

    def _start_conf_change(self, responders: List[int]) -> None:
        """Fire a real client ConfChange from a background driver; the
        schedule does NOT wait for installation — partitions/crashes
        keep playing against the in-flight revoke-then-adopt barrier."""
        from ..client.drivers import DriverClosedLoop
        from ..client.endpoint import GenericEndpoint

        def drive() -> None:
            ep = None
            try:
                ep = GenericEndpoint(self.manager_addr)
                ep.connect()
                drv = DriverClosedLoop(ep, timeout=8.0)
                drv.conf_change({"responders": responders}, retries=4)
            except Exception as e:
                # expected under adversity: a conf-less protocol answers
                # failure fast, a partitioned cluster may time the driver
                # out — the attempt itself is the coverage
                pf_warn(logger, f"conf_change {responders} gave up: {e}")
            finally:
                if ep is not None:
                    try:
                        ep.leave()
                    except Exception:
                        pass

        t = threading.Thread(target=drive, daemon=True)
        t.start()
        self._conf_threads.append(t)

    def _start_range_change(self, sel: int, dst: int) -> None:
        """Fire a live range split through the manager ctrl plane from a
        background driver; the schedule keeps playing WHILE the seal ->
        barrier -> adopt cutover is in flight (that concurrency is the
        coverage).  The manager normalizes dst mod G, so any seeded
        target id is a valid destination group."""
        from ..host.resharding import single_key_range

        key = self.range_keys[sel % len(self.range_keys)]
        start, end = single_key_range(key)

        def drive() -> None:
            try:
                self._request(CtrlRequest("range_change", payload={
                    "op": "split", "start": start, "end": end,
                    "dst_group": int(dst),
                }), timeout=60.0)
            except Exception as e:
                # expected under adversity: a partitioned manager fan-
                # out may time out — the attempt itself is the coverage
                pf_warn(logger, f"range_change {key!r} gave up: {e}")

        t = threading.Thread(target=drive, daemon=True)
        t.start()
        self._conf_threads.append(t)

    # ------------------------------------------------------------- play
    def play(self, stop: Optional[threading.Event] = None) -> None:
        """Execute the schedule; returns after the last action (all
        durations healed).  ``stop`` aborts between actions."""
        t0 = time.monotonic()
        for tick, action, desc, spec in self.plan.host_actions():
            if stop is not None and stop.is_set():
                break
            lag = t0 + tick * self.tick_len - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            try:
                self._run_action(action, spec)
                self.executed.append((tick, desc))
                pf_info(logger, f"nemesis {desc}")
            except Exception as e:
                # a fault action failing (e.g. victim already down) is
                # recorded, not fatal — the heal pass below re-clears
                self.executed.append((tick, f"{desc} !error {e}"))
                pf_warn(logger, f"nemesis action failed: {desc}: {e}")
            if self._on_action is not None:
                self._on_action(tick, desc)
        # drain in-flight conf drivers (bounded: their own retry budgets
        # already cap them) so a late install never races teardown
        for t in self._conf_threads:
            t.join(timeout=60.0)

    def flight_tails(self, last_n: int = 256) -> Dict[str, Any]:
        """Per-replica flight-recorder tails (graftscope) for failure
        repro bundles: what each survivor was doing in its final ticks,
        alongside the seed + history the bundle already carries.  Must
        run while the cluster is still up (the soak calls it before
        teardown); best-effort — diagnostics never mask the verdict."""
        try:
            rep = self._request(CtrlRequest(
                "flight_dump", payload={"last_n": int(last_n)},
            ), timeout=30.0)
            return {
                str(sid): dump
                for sid, dump in sorted((rep.payloads or {}).items())
            }
        except Exception as e:
            pf_warn(logger, f"flight scrape failed: {e}")
            return {}

    def heal_all(self) -> None:
        """Belt-and-braces final heal: clear every injector and resume
        everyone, so the recovery assertion never races a leftover
        fault."""
        try:
            self._inject(
                list(range(self.plan.population)),
                {"net": None, "wal": None, "skew": None,
                 "snap_crash": None},
            )
        except Exception:
            pass
        try:
            self._request(CtrlRequest("resume_servers", servers=None))
        except Exception:
            pass

    def close(self) -> None:
        try:
            self.ep.leave()
        except Exception:
            pass
