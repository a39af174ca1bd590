"""Deterministic workload plane: seeded traffic schedules, counterpart
of ``summerset_tpu/host/workload.py``.

The workload twin of ``host/nemesis.py``: a ``FaultPlan`` decides what
breaks and when, a ``WorkloadPlan`` decides what traffic arrives and
when.  ``WorkloadPlan.generate(seed, wl_class, ...)`` draws only from
``random.Random`` seeded off its arguments, so the same seed always
yields a byte-identical ``timeline()`` and the same per-client op
sequence, equal to the JAX package's (``tests/test_torch_workload.py``).

Classes are YCSB-style: ``uniform``, ``read_mostly`` (zipfian, ~5-10%
puts), ``write_heavy`` (zipfian, ~85-95% puts), ``value_mix``
(log-uniform value sizes), ``multi_tenant`` (private key ranges plus a
shared hot range), ``hot_burst`` (strong skew plus a burst phase offering
~2x the ingress capacity: bounded queues must shed visibly), ``ycsb_e``
(~95% ordered range scans) and ``trace`` (a YCSB trace file normalized by
:meth:`WorkloadPlan.from_trace`, its rows' digest in the timeline).

Everything logical (op kinds, keys, value sizes, phases, rate
multipliers) is a pure function of the seed here; everything temporal
(phase ticks to wall seconds, expovariate arrival pacing) lives in the
drivers (``client/drivers.DriverOpenLoopPaced``,
``client/tester.start_workload_clients``).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import zlib
from typing import List, Tuple

#: every workload class the plane knows how to generate
WORKLOAD_CLASSES = (
    "uniform",
    "read_mostly",
    "write_heavy",
    "value_mix",
    "multi_tenant",
    "hot_burst",
    "ycsb_e",
    "trace",
)


@dataclasses.dataclass(frozen=True)
class WorkloadPhase:
    """One open-loop arrival phase.  ``tick``/``ticks`` are workload
    schedule ticks (the runner maps them to wall seconds with its
    ``tick_len``, sharing the logical clock with the FaultPlan playing
    alongside); ``rate_x`` is the offered-arrival multiplier relative to
    the serving path's ingress capacity (``api_max_batch / tick``) — a
    phase with ``rate_x >= 1`` offers more than the ingress tier can
    drain and MUST surface as visible shedding, not unbounded queues."""

    tick: int
    ticks: int
    rate_x: float

    def render(self) -> str:
        return (
            f"@{self.tick:05d} phase rate_x={self.rate_x:g}"
            f" ticks={self.ticks}"
        )


@dataclasses.dataclass(frozen=True)
class WorkloadPlan:
    seed: int
    wl_class: str
    clients: int
    num_keys: int
    put_ratio: float
    zipf_s: float           # 0 = uniform key popularity
    value_lo: int
    value_hi: int
    log_values: bool        # log-uniform (vs uniform) value sizes
    tenant_span: int        # >0: per-client private key range width
    shared_keys: int        # multi-tenant: size of the shared hot range
    shared_frac: float      # fraction of multi-tenant ops on shared keys
    phases: Tuple[WorkloadPhase, ...]
    # ordered-range-read knobs (ycsb_e; default-zero keeps every older
    # plan's constructor call AND timeline byte-identical)
    scan_frac: float = 0.0  # fraction of non-put ops issued as scans
    scan_max: int = 0       # uniform scan length in [1, scan_max]
    # normalized external trace rows (wl_class "trace"): the op sequence
    # IS this tuple, strided per client by OpStream
    trace: Tuple[Tuple[str, str, int], ...] = ()

    # ------------------------------------------------------------ build
    @staticmethod
    def generate(
        seed: int,
        wl_class: str,
        clients: int = 3,
        num_keys: int = 24,
        horizon: int = 120,
    ) -> "WorkloadPlan":
        """Draw a plan from the seed.  Class parameters are jittered
        per-seed inside each class's envelope, so different seeds of the
        same class are genuinely different workloads while the class's
        character (skew, mix, burst shape) is preserved."""
        import random

        if wl_class not in WORKLOAD_CLASSES:
            raise ValueError(f"unknown workload class {wl_class!r}")
        # class-salted seed: seed 1 of read_mostly and seed 1 of
        # write_heavy must not share a random stream
        rng = random.Random(
            (seed << 16) ^ zlib.crc32(wl_class.encode())
        )
        put_ratio, zipf_s = 0.5, 0.0
        value_lo, value_hi, log_values = 48, 64, False
        tenant_span, shared_keys, shared_frac = 0, 0, 0.0
        scan_frac, scan_max = 0.0, 0
        steady = round(0.25 + rng.uniform(0.0, 0.15), 3)
        phases: List[WorkloadPhase] = [
            WorkloadPhase(0, horizon, steady)
        ]
        if wl_class == "read_mostly":
            put_ratio = round(rng.uniform(0.04, 0.10), 3)
            zipf_s = round(rng.uniform(0.9, 1.2), 3)
            value_lo, value_hi = 32, 128
        elif wl_class == "write_heavy":
            put_ratio = round(rng.uniform(0.85, 0.95), 3)
            zipf_s = round(rng.uniform(0.8, 1.1), 3)
            value_lo, value_hi = 64, 192
        elif wl_class == "value_mix":
            value_lo, value_hi, log_values = 16, 2048, True
        elif wl_class == "multi_tenant":
            put_ratio = round(rng.uniform(0.3, 0.5), 3)
            tenant_span = rng.randint(6, 10)
            shared_keys = rng.randint(3, 5)
            shared_frac = round(rng.uniform(0.2, 0.4), 3)
            num_keys = clients * tenant_span + shared_keys
        elif wl_class == "hot_burst":
            zipf_s = round(rng.uniform(1.1, 1.3), 3)
            # steady → burst (~2x ingress capacity) → recover; the
            # recover tail is where the soak measures throughput
            # returning to the pre-burst steady state
            t1 = int(horizon * rng.uniform(0.28, 0.34))
            blen = int(horizon * rng.uniform(0.22, 0.28))
            burst_x = round(rng.uniform(1.9, 2.2), 3)
            phases = [
                WorkloadPhase(0, t1, steady),
                WorkloadPhase(t1, blen, burst_x),
                WorkloadPhase(t1 + blen, horizon - t1 - blen, steady),
            ]
        elif wl_class == "ycsb_e":
            # YCSB workload E: short ordered scans dominate, a thin
            # insert/update stream keeps the scanned state moving.
            # Scan start is zipfian (the shared hot-key shuffle below),
            # scan LENGTH is uniform in [1, scan_max] — the canonical
            # E shape (zipfian request keys, uniform scan lengths)
            put_ratio = round(rng.uniform(0.03, 0.07), 3)
            zipf_s = round(rng.uniform(0.9, 1.2), 3)
            value_lo, value_hi = 32, 96
            scan_frac = round(rng.uniform(0.9, 1.0), 3)
            scan_max = rng.randint(6, 12)
        elif wl_class == "trace":
            raise ValueError(
                "wl_class 'trace' plans come from WorkloadPlan."
                "from_trace, not generate()"
            )
        return WorkloadPlan(
            seed, wl_class, clients, num_keys, put_ratio, zipf_s,
            value_lo, value_hi, log_values, tenant_span, shared_keys,
            shared_frac, tuple(phases), scan_frac, scan_max,
        )

    @staticmethod
    def from_trace(
        rows,
        seed: int = 0,
        clients: int = 3,
        horizon: int = 120,
        rate_x: float = 0.3,
    ) -> "WorkloadPlan":
        """Normalize real YCSB trace rows into the seeded plan contract.

        ``rows`` is a path to a trace file or an iterable of its lines;
        accepted row shapes are the YCSB runner's operation lines —
        ``READ <table> <key> ...``, ``INSERT|UPDATE <table> <key>
        <fields...>``, ``SCAN <table> <startkey> <len> ...`` — plus the
        bare 2/3-column form (``op key [len]``).  Unknown lines are
        skipped, not errors (real trace dumps interleave progress
        noise).  Parsing is PURE (no wallclock, no unseeded
        randomness, no pacing — the drivers own time): the same bytes
        always yield the same plan, and :meth:`timeline` embeds the
        normalized rows' sha256, so same trace ⇒ same digest is a
        checkable contract, not a convention.  ``seed`` only salts the
        client-stride offset, keeping distinct cells distinguishable
        without touching the rows."""
        if isinstance(rows, (str, bytes)):
            with open(rows, "r", encoding="utf-8",
                      errors="replace") as f:
                lines = f.read().splitlines()
        else:
            lines = [str(r) for r in rows]
        ops: List[Tuple[str, str, int]] = []
        for line in lines:
            parts = line.split()
            if len(parts) < 2:
                continue
            verb = parts[0].upper()
            # full YCSB rows carry the table name second; the bare form
            # puts the key there — disambiguate by verb arity
            rest = parts[1:]
            if verb in ("READ", "INSERT", "UPDATE", "SCAN") \
                    and len(rest) >= 2 and not rest[1].isdigit():
                rest = rest[1:]  # drop the table column
            key = rest[0]
            if verb == "READ":
                ops.append(("get", key, 0))
            elif verb in ("INSERT", "UPDATE"):
                # field payload sizes vary per dump; normalize to the
                # joined field text length (bounded below so empty
                # fields still write a real value)
                size = max(8, len(" ".join(rest[1:])))
                ops.append(("put", key, min(size, 2048)))
            elif verb == "SCAN":
                n = 1
                if len(rest) >= 2:
                    try:
                        n = max(1, int(rest[1]))
                    except ValueError:
                        n = 1
                ops.append(("scan", key, min(n, 64)))
        if not ops:
            raise ValueError("trace contains no recognizable ops")
        keys = {k for _, k, _ in ops}
        puts = sum(1 for o in ops if o[0] == "put")
        return WorkloadPlan(
            seed, "trace", clients, len(keys),
            round(puts / len(ops), 3), 0.0, 8, 2048, False, 0, 0, 0.0,
            (WorkloadPhase(0, horizon, rate_x),),
            0.0, 0, tuple(ops),
        )

    # ------------------------------------------------------- determinism
    def timeline(self) -> str:
        """Canonical rendering; byte-identical for identical plans (the
        repro contract — soak failures print this plus the seed)."""
        head = (
            f"# WorkloadPlan v1 seed={self.seed} class={self.wl_class}"
            f" clients={self.clients}\n"
            f"keys={self.num_keys} put={self.put_ratio:g}"
            f" zipf={self.zipf_s:g}"
            f" value=[{self.value_lo},{self.value_hi}"
            f"{',log' if self.log_values else ''}]"
            f" tenant_span={self.tenant_span}"
            f" shared={self.shared_keys}@{self.shared_frac:g}\n"
        )
        # scan/trace lines render ONLY when the knobs are live, so every
        # pre-scan plan's timeline (and committed digest) is unchanged
        if self.scan_frac > 0.0 or self.scan_max > 0:
            head += (
                f"scan={self.scan_frac:g}@max{self.scan_max}\n"
            )
        if self.trace:
            head += (
                f"trace_sha={self.trace_sha()} rows={len(self.trace)}\n"
            )
        return head + "".join(p.render() + "\n" for p in self.phases)

    def trace_sha(self) -> str:
        """sha256 over the normalized trace rows (canonical rendering):
        the byte-reproducibility anchor — same trace file, same
        normalization, same sha, same plan digest."""
        h = hashlib.sha256()
        for kind, key, n in self.trace:
            h.update(f"{kind} {key} {n}\n".encode())
        return h.hexdigest()[:16]

    def digest(self) -> str:
        return hashlib.sha256(self.timeline().encode()).hexdigest()[:16]

    # ---------------------------------------------------------- streams
    def rate_x_at(self, tick: float) -> float:
        """Offered-rate multiplier at a workload tick (0 past the
        horizon — issuing stops, inflight ops drain)."""
        for p in self.phases:
            if p.tick <= tick < p.tick + p.ticks:
                return p.rate_x
        return 0.0

    def horizon(self) -> int:
        return max(p.tick + p.ticks for p in self.phases)

    def opstream(self, ci: int) -> "OpStream":
        """The per-client op stream: a pure function of (plan, ci)."""
        return OpStream(self, ci)


class OpStream:
    """Seeded per-client op generator: ``next()`` yields
    ``(kind, key, value_size)`` tuples drawn from this client's own
    ``random.Random`` — replaying a client from the same (plan, ci)
    yields the identical op sequence.

    Key popularity: zipfian over a per-plan shuffled key order (the hot
    key identity varies per seed but is SHARED across clients, so skew
    creates real cross-client contention).  Multi-tenant plans route
    ``shared_frac`` of ops to the shared hot range and the rest to this
    client's private range (disjoint from every other client's)."""

    def __init__(self, plan: WorkloadPlan, ci: int):
        import random

        self.plan = plan
        self.ci = int(ci)
        self._rng = random.Random(
            plan.seed * 7919 + self.ci * 104729 + 13
        )
        if plan.trace:
            # trace replay: this client's rows are the seed-rotated
            # per-client stride of the normalized trace — every row is
            # issued by exactly one client, and the union across
            # clients is the trace itself
            off = (self.ci + plan.seed) % max(plan.clients, 1)
            self._trows = plan.trace[off::max(plan.clients, 1)] \
                or plan.trace
            self._tpos = 0
            self.keys = []
            self._shared, self._private = [], []
            self._cdf = []
            return
        if plan.tenant_span > 0:
            self._shared = [
                f"t_shared{i}" for i in range(plan.shared_keys)
            ]
            self._private = [
                f"t{self.ci}_k{j}" for j in range(plan.tenant_span)
            ]
            self.keys = self._shared + self._private
            self._cdf: List[float] = []
        else:
            # per-plan (client-shared) hot-key identity: one shuffle
            # seeded off the plan alone
            order = list(range(plan.num_keys))
            random.Random((plan.seed << 8) | 0xA5).shuffle(order)
            self.keys = [f"w{i}" for i in order]
            self._shared, self._private = [], []
            s = plan.zipf_s
            if s > 0:
                w = [1.0 / ((i + 1) ** s) for i in range(plan.num_keys)]
                tot = sum(w)
                acc, cdf = 0.0, []
                for x in w:
                    acc += x / tot
                    cdf.append(acc)
                self._cdf = cdf
            else:
                self._cdf = []

    def _pick_key(self) -> str:
        p = self.plan
        if p.tenant_span > 0:
            if self._shared and self._rng.random() < p.shared_frac:
                return self._rng.choice(self._shared)
            return self._rng.choice(self._private)
        if self._cdf:
            i = bisect.bisect_left(self._cdf, self._rng.random())
            return self.keys[min(i, len(self.keys) - 1)]
        return self._rng.choice(self.keys)

    def _pick_size(self) -> int:
        p = self.plan
        if p.value_hi <= p.value_lo:
            return p.value_lo
        if p.log_values:
            # log-uniform: small values dominate, the tail reaches
            # value_hi (frame-encoder stress without every op paying it)
            import math

            lo, hi = math.log(p.value_lo), math.log(p.value_hi)
            return int(round(math.exp(self._rng.uniform(lo, hi))))
        return self._rng.randint(p.value_lo, p.value_hi)

    def next(self) -> Tuple[str, str, int]:
        """One op: ``(kind, key, arg)`` — ``("put", key, value_size)``,
        ``("get", key, 0)``, or ``("scan", start_key, scan_len)``."""
        if self.plan.trace:
            op = self._trows[self._tpos % len(self._trows)]
            self._tpos += 1
            return op
        key = self._pick_key()
        if self._rng.random() < self.plan.put_ratio:
            return "put", key, self._pick_size()
        if self.plan.scan_max > 0 \
                and self._rng.random() < self.plan.scan_frac:
            return "scan", key, self._rng.randint(
                1, self.plan.scan_max
            )
        return "get", key, 0
