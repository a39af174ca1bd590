"""ClientBench: throughput/latency benchmark mode, counterpart of
``summerset_tpu/client/bench.py``.

Parity: reference ``summerset_client/src/clients/bench.rs`` — open-loop
driver with target frequency pacing (0 = unlimited), put ratio, value
sizes with "t1:v1/t2:v2" schedules, key count with preloading, normal /
uniform size distributions, optional YCSB-style trace replay, and
periodic interval stats lines ``tput ... lat p50/p99 ...`` parsed by the
orchestration scripts (bench.rs:28-130).
"""

from __future__ import annotations

import random
import string
import time
from typing import List, Optional, Tuple

from ..host.statemach import Command
from ..host.telemetry import Histogram
from ..utils.logging import pf_info, pf_logger
from .drivers import DriverClosedLoop, DriverOpenLoop
from .endpoint import GenericEndpoint

logger = pf_logger("bench")


def load_ycsb_trace(path: str) -> List[Tuple[str, str, Optional[str]]]:
    """Load a YCSB run log into a ClientBench trace.

    Parity: the reference bench replays YCSB trace files
    (``clients/bench.rs`` ycsb trace support; lines shaped
    ``READ usertable <key> ...`` / ``UPDATE usertable <key> [field=...]``
    / ``INSERT ...``).  SCANs replay as ordered range reads (the third
    tuple slot carries the YCSB scan count as a string); for plan-level
    replay with digest stamping use ``WorkloadPlan.from_trace``."""
    trace: List[Tuple[str, str, Optional[str]]] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 3:
                continue
            op = toks[0].upper()
            if op == "READ":
                trace.append(("get", toks[2], None))
            elif op == "SCAN":
                count = toks[3] if len(toks) > 3 and toks[3].isdigit() \
                    else "1"
                trace.append(("scan", toks[2], count))
            elif op in ("UPDATE", "INSERT"):
                val: Optional[str] = None
                if "[" in line:
                    val = line.split("[", 1)[1].rsplit("]", 1)[0].strip()
                trace.append(("put", toks[2], val))
    return trace


def parse_value_schedule(spec: str) -> List[Tuple[float, int]]:
    """"t1:v1/t2:v2" -> [(t_from, size)]; a bare "128" means a constant
    size from t=0 (bench.rs value-size schedule)."""
    out = []
    for seg in str(spec).split("/"):
        if ":" in seg:
            t, v = seg.split(":")
            out.append((float(t), int(v)))
        else:
            out.append((0.0, int(seg)))
    return sorted(out)


class ClientBench:
    def __init__(
        self,
        endpoint: GenericEndpoint,
        secs: float = 10.0,
        freq: float = 0.0,            # target reqs/sec; 0 = unlimited
        put_ratio: float = 0.5,
        value_size: str = "128",      # int or "t:v/t:v" schedule
        num_keys: int = 5,
        normal_stdev_ratio: float = 0.0,
        trace: Optional[List[Tuple[str, str, Optional[str]]]] = None,
        interval: float = 0.1,
        seed: int = 0,
        opgen=None,
    ):
        self.ep = endpoint
        self.secs = secs
        self.freq = freq
        self.put_ratio = put_ratio
        self.schedule = parse_value_schedule(value_size)
        self.num_keys = num_keys
        self.stdev = normal_stdev_ratio
        self.trace = trace
        self.interval = interval
        self.rng = random.Random(seed)
        # workload plane (host/workload.WorkloadPlan.opstream): when an
        # op stream is given it owns kinds/keys/value sizes and the
        # uniform knobs above are ignored (uniform stays the default, as
        # in the JAX package)
        self.opgen = opgen
        self.keys = (
            list(opgen.keys) if opgen is not None
            else [f"k{i}" for i in range(num_keys)]
        )

    def _value(self, now: float) -> str:
        size = self.schedule[0][1]
        for t, v in self.schedule:
            if now >= t:
                size = v
        if self.stdev > 0:
            size = max(1, int(self.rng.gauss(size, size * self.stdev)))
        return "".join(
            self.rng.choices(string.ascii_lowercase, k=size)
        )

    def _sized_value(self, size: int) -> str:
        return "".join(
            self.rng.choices(string.ascii_lowercase, k=max(1, size))
        )

    def _next_cmd(self, now: float, i: int) -> Command:
        if self.opgen is not None:
            kind, key, size = self.opgen.next()
            if kind == "put":
                return Command("put", key, self._sized_value(size))
            if kind == "scan":
                # ordered range read: start at the picked key, length
                # capped by the plan's scan_max (YCSB-E start+count)
                return Command("scan", key, limit=max(1, int(size)))
            return Command("get", key)
        if self.trace:
            op, key, val = self.trace[i % len(self.trace)]
            if op == "put":
                return Command("put", key, val or self._value(now))
            if op == "scan":
                return Command("scan", key,
                               limit=max(1, int(val or 1)))
            return Command("get", key)
        key = self.rng.choice(self.keys)
        if self.rng.random() < self.put_ratio:
            return Command("put", key, self._value(now))
        return Command("get", key)

    def run(self) -> dict:
        # preload every key once (bench.rs preloading) with the
        # closed-loop driver: it follows redirects/timeouts, where an
        # open-loop pipeline would strand its inflight window on the
        # first redirect reconnect
        pre = DriverClosedLoop(self.ep)
        for k in self.keys:
            pre.checked_put(k, self._value(0.0))
        drv = DriverOpenLoop(self.ep)

        t_start = time.monotonic()
        issued = acked = 0
        lats: List[float] = []
        # interval stats ride a cumulative exponential histogram and
        # its since() window view (host/telemetry.py) instead of a
        # per-interval sample list: a long soak's interval lines cost
        # O(1) memory, while the exact end-of-run summary still sorts
        # the full `lats` list
        lat_hist = Histogram()
        int_prev = lat_hist.copy()
        int_acked = 0
        t_int = t_start
        pace = 1.0 / self.freq if self.freq > 0 else 0.0
        t_next = t_start
        while True:
            now = time.monotonic()
            if now - t_start >= self.secs:
                break
            if pace == 0.0 or now >= t_next:
                drv.issue(self._next_cmd(now - t_start, issued))
                issued += 1
                t_next += pace
            budget = max(0.0, min(
                (t_next - now) if pace else 0.001, 0.01
            ))
            rep = drv.wait_reply(timeout=budget or 0.001)
            if rep is not None and rep.kind == "success":
                acked += 1
                int_acked += 1
                lats.append(rep.latency)
                lat_hist.observe(int(rep.latency * 1e6))
            if now - t_int >= self.interval:
                dt = now - t_int
                tput = int_acked / dt
                win = lat_hist.since(int_prev)
                p50 = win.quantile(0.50) / 1e6
                p99 = win.quantile(0.99) / 1e6
                pf_info(
                    logger,
                    f"tput {tput:10.2f} reqs/s  "
                    f"lat p50 {p50 * 1e3:7.3f} p99 {p99 * 1e3:7.3f} ms",
                )
                t_int = now
                int_acked = 0
                int_prev = lat_hist.copy()

        # drain stragglers briefly
        t_end = time.monotonic() + 1.0
        while drv.inflight and time.monotonic() < t_end:
            rep = drv.wait_reply(timeout=0.1)
            if rep is not None and rep.kind == "success":
                acked += 1
                lats.append(rep.latency)
        dt = time.monotonic() - t_start
        p50, p99 = _pctiles(lats)
        summary = {
            "issued": issued,
            "acked": acked,
            "tput": acked / dt,
            "lat_p50_ms": p50 * 1e3,
            "lat_p99_ms": p99 * 1e3,
        }
        pf_info(
            logger,
            f"total tput {summary['tput']:.2f} reqs/s  "
            f"p50 {summary['lat_p50_ms']:.3f} p99 "
            f"{summary['lat_p99_ms']:.3f} ms",
        )
        return summary


def _pctiles(lats: List[float]) -> Tuple[float, float]:
    if not lats:
        return 0.0, 0.0
    s = sorted(lats)
    return s[len(s) // 2], s[min(len(s) - 1, int(len(s) * 0.99))]
