"""Autopilot control plane: close the sense -> decide -> actuate loop.

The port's own copy of ``summerset_tpu/host/autopilot.py``, held to it by
``tests/test_torch_autopilot.py``; it imports nothing of the JAX package.

PR 10 built the senses (quorum-median health verdicts riding ``hb``
beacons, per-tier shed/queue telemetry, per-phase perf attribution) and
PRs 7/10/13/16 grew the actuators (voluntary leader demotion, QL/Bodega
responder ConfChange, ``api_max_batch``, ``pipeline``, range splits via
``ResharderPolicy``) — but every policy was static: a workload or fault
shift meant a human re-running a driver with different flags.  This
module is the policy tier that turns those knobs continuously:

- :class:`AutopilotPolicy` — the SEEDED decision core.  A pure function
  of (seed, the senses sequence fed to :meth:`~AutopilotPolicy.evaluate`):
  no wallclock, no unseeded RNG (graftlint ``SEEDED_SCOPES`` membership,
  the FaultPlan/WorkloadPlan repro contract).  Time is the round counter
  — one ``evaluate`` call per scrape round.  Every actuator is
  deliberately conservative in the PR 10 style: hysteresis streaks (an
  oscillating signal flaps the streak, not the cluster), per-actuator
  cooldowns, quorum-gated evaluation (no quorum => no actuation, streaks
  RESET so churn windows cannot bank hysteresis credit), a bounded
  actuation budget per window, and at most one change per group per
  window (the reshard-vs-lead_move race guard).  Decisions accumulate
  into a canonical :meth:`~AutopilotPolicy.timeline` with a sha256
  :meth:`~AutopilotPolicy.digest` — the decision-trace analog of
  ``FaultPlan.timeline()``.
- :class:`AutopilotDriver` — the wall-clock half.  Scrapes the senses on
  a cadence (``metrics_dump`` partial-tolerant gathers + ``query_info``),
  folds them into the canonical senses dict (:func:`build_senses`), and
  in ``mode="act"`` lowers fired decisions onto the EXISTING ctrl plane:
  ``autopilot_ctl`` fan-outs (targeted demotion, live ``api_max_batch``
  / ``pipeline`` retune), ``range_change`` (reshard), and injectable
  ``conf_ctl`` / ``proxy_ctl`` hooks (responder resize, proxy scaling).
  ``mode="observe"`` evaluates and logs decisions but sends ZERO ctrl
  mutations — byte-identical to no autopilot at all on the same seed,
  the twin-soak control cell.

Actuator -> signal -> lowering:

====  ============  =======================  ===========================
act   actuator      fires on                 lowered as
====  ============  =======================  ===========================
1     lead_move     leader health_score low  ``autopilot_ctl {demote}``
                    OR ingress/leader        to the leader (reuses the
                    affinity mismatch        health plane's revoke-then-
                                             demote machinery)
2     batch         shed-rate EWMA high /    ``autopilot_ctl {retune
                    idle                     api_max_batch}`` fan-out
3     pipeline      shed persists at         ``autopilot_ctl {retune
                    batch_max, serial loop   pipeline}`` fan-out
4     conf_resize   key-heat concentration   ``conf_ctl(responders)``
                    (lease protocols only)   hook (client ConfChange)
5     reshard       embedded ResharderPolicy ``range_change`` ctrl req
                    (decisions flow through  (the PR 16 seal/adopt
                    THIS policy's budget)    cutover)
6     recommend     overload survives every  log-only: ``tally`` /
                    live knob                ``wire_codec`` are compile-
                                             time retunes
====  ============  =======================  ===========================

The batch ladder is smoothed through an EWMA of the shed rate — the
in-tree predictive-refit template is ``host/adaptive.py``'s
CrosswordAdaptive (sample -> refit -> override), shrunk to one scalar
model since the shed signal is already a rate.

Related work: compartmentalized SMR (arxiv 2012.15762) motivates
re-sizing serving compartments (responder sets, batch capacity, proxy
count) as load moves; arxiv 1905.10786 frames porting the same policies
across the kernel families (the demote actuator degrades to score-only
on families without the ``demote`` input, exactly like the health
plane).
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .messages import CtrlRequest
from .resharding import RangeHeat, ResharderPolicy
from ..utils.logging import pf_info, pf_logger, pf_warn

logger = pf_logger("autopilot")

#: actuator label vocabulary (``autopilot_actions`` counter labels and
#: the per-actuator cooldown gauges)
ACTUATORS = (
    "lead_move", "batch", "pipeline", "conf_resize", "reshard",
    "recommend",
)

#: kernel families whose conf plane carries lease responder sets (the
#: conf_resize actuator is a no-op elsewhere)
LEASE_PROTOCOLS = ("quorumleases", "bodega")

#: graftwatch SLO objective -> actuator lowering: a latched burn-rate
#: alert that persists a full streak drives the EXISTING actuators
#: through the same admission/budget/fire path as every other signal.
#: Latency and shed burns escalate the batch ladder; a WAL-fsync burn
#: indicts the leader's disk (the fail-slow demote path); a scan-
#: starvation burn has no live knob — it lowers as a log-only
#: recommendation (route scans to the learner tier).
SLO_ACTUATORS = {
    "reply_p99": "batch",
    "shed_rate": "batch",
    "wal_fsync_lag": "lead_move",
    "scan_starvation": "recommend",
}


@dataclasses.dataclass(frozen=True)
class Decision:
    """One fired (or recommended) actuation — the decision-trace unit.

    ``target`` is a server id where the act is targeted (the demotee for
    ``lead_move``); ``arg`` is the actuator-specific operand (new batch
    size, responder list, ``RangeChange.as_dict()``...).  ``render`` is
    the canonical one-line form the timeline/digest is built from, so
    every field that matters to repro must appear in it.
    """

    round_no: int
    actuator: str
    group: int
    target: Optional[int]
    arg: Any
    reason: str

    def render(self) -> str:
        tgt = "-" if self.target is None else str(self.target)
        return (f"r{self.round_no:04d} {self.actuator:<11s} "
                f"g{self.group} t{tgt} arg={self.arg!r} [{self.reason}]")


@dataclasses.dataclass
class ActuatorState:
    """Per-actuator hysteresis bookkeeping: a signed streak (positive =
    escalate pressure, negative = relax pressure), the round the
    cooldown holds until (exclusive), and the lifetime fire count."""

    streak: int = 0
    cooldown_until: int = -1
    fires: int = 0


class AutopilotPolicy:
    """Seeded-deterministic sense->decision core (see module docstring).

    The policy holds NO sockets and reads NO clocks: callers feed one
    senses dict per round (``evaluate``) and receive the decisions that
    fired.  The only RNG is seeded (successor tie-breaks), so the same
    seed + the same senses sequence yields a byte-identical decision
    timeline — the gate and the unit tests both lean on that.
    """

    def __init__(
        self,
        seed: int,
        population: int,
        num_groups: int = 1,
        streak_need: int = 3,
        cooldown_rounds: int = 10,
        window_rounds: int = 8,
        budget_per_window: int = 2,
        shed_hi: float = 0.05,
        shed_lo: float = 0.005,
        shed_alpha: float = 0.5,
        batch_max: int = 16,
        health_bad: float = 0.5,
        affinity_frac: float = 0.6,
        min_ingress: int = 20,
        lease_hot_share: float = 0.5,
        lease_flat_share: float = 0.15,
        heat_min: int = 20,
        resharder: Optional[ResharderPolicy] = None,
    ):
        self.seed = int(seed)
        self.population = int(population)
        self.G = int(num_groups)
        self.streak_need = max(1, int(streak_need))
        self.cooldown_rounds = max(0, int(cooldown_rounds))
        self.window_rounds = max(1, int(window_rounds))
        self.budget_per_window = max(0, int(budget_per_window))
        self.shed_hi = float(shed_hi)
        self.shed_lo = float(shed_lo)
        self.shed_alpha = float(shed_alpha)
        self.batch_max = int(batch_max)
        self.health_bad = float(health_bad)
        self.affinity_frac = float(affinity_frac)
        self.min_ingress = int(min_ingress)
        self.lease_hot_share = float(lease_hot_share)
        self.lease_flat_share = float(lease_flat_share)
        self.heat_min = int(heat_min)
        # seeded RNG: the only nondeterminism budget (successor
        # tie-breaks); salted so policy draws differ from the nemesis/
        # workload generators sharing a seed in one soak cell
        self.rng = random.Random((self.seed << 8) ^ 0x417)
        self.resharder = resharder
        if resharder is not None:
            # satellite bugfix (PR 17): ResharderPolicy decisions flow
            # through THIS policy's budget — a reshard storm can no
            # longer race a leader re-placement on the same group
            resharder.budget_gate = (
                lambda g: self._admit("reshard", int(g))
            )
        self._acts: Dict[str, ActuatorState] = {
            a: ActuatorState() for a in ACTUATORS
        }
        self._round = -1
        self._win = -1
        self._win_spend = 0
        #: high-water mark of per-window spend — the committed soak row
        #: records it so the gate can check the budget was never blown
        self.max_window_spend = 0
        self._group_round: Dict[int, int] = {}
        self._decisions: List[Decision] = []
        self._shed_ewma = 0.0
        self._batch_base: Optional[int] = None
        self._recommended = False
        self.last_quorum = False
        # graftwatch burn-alert streaks, per objective name.  Kept OFF
        # config_line(): a policy evaluated without slo_burn senses
        # renders and digests byte-identically to one built before the
        # graftwatch plane existed (the committed AUTOPILOT.json drift
        # gate regenerates digests from this code)
        self._slo_streaks: Dict[str, int] = {}

    # ------------------------------------------------------- admission
    def _admit(self, actuator: str, group: int) -> bool:
        """Cooldown + window budget + one-change-per-group admission.
        Shared by every actuator AND (via ``budget_gate``) by an
        embedded ResharderPolicy, so all actuation paths answer to one
        budget."""
        st = self._acts[actuator]
        if self._round < st.cooldown_until:
            return False
        if self._win_spend >= self.budget_per_window:
            return False
        last = self._group_round.get(int(group))
        if last is not None and self._round - last < self.window_rounds:
            return False
        return True

    def _fire(self, actuator: str, group: int, target: Optional[int],
              arg: Any, reason: str) -> Decision:
        st = self._acts[actuator]
        st.streak = 0
        st.cooldown_until = self._round + self.cooldown_rounds
        st.fires += 1
        self._win_spend += 1
        self.max_window_spend = max(self.max_window_spend,
                                    self._win_spend)
        self._group_round[int(group)] = self._round
        d = Decision(self._round, actuator, int(group), target, arg,
                     reason)
        self._decisions.append(d)
        return d

    def cooldowns(self) -> Dict[str, int]:
        """Remaining cooldown rounds per actuator (0 = armed)."""
        return {
            a: max(0, st.cooldown_until - self._round)
            for a, st in self._acts.items()
        }

    def fires(self) -> Dict[str, int]:
        return {a: st.fires for a, st in self._acts.items()}

    # ------------------------------------------------------- evaluate
    def evaluate(self, senses: Dict[str, Any]) -> List[Decision]:
        """One decision round over one senses dict; returns the
        decisions that fired this round (possibly empty)."""
        self._round += 1
        win = self._round // self.window_rounds
        if win != self._win:
            self._win = win
            self._win_spend = 0
        out: List[Decision] = []
        pop = int(senses.get("population", self.population))
        alive = int(senses.get("alive", 0))
        leader = senses.get("leader")
        self.last_quorum = (
            alive >= pop // 2 + 1 and leader is not None
        )
        if not self.last_quorum:
            # no quorum => no actuation, and streaks RESET: an election-
            # churn window must not bank hysteresis credit that fires
            # the instant quorum returns
            for st in self._acts.values():
                st.streak = 0
            return out
        leader = int(leader)
        health = dict(senses.get("health") or {})
        ingress = {
            int(s): float(n)
            for s, n in (senses.get("ingress") or {}).items()
        }
        shed = float(senses.get("shed_rate", 0.0))
        self._shed_ewma = (
            self.shed_alpha * shed
            + (1.0 - self.shed_alpha) * self._shed_ewma
        )
        cur_batch = int(senses.get("api_max_batch", 0) or 0)
        if cur_batch and self._batch_base is None:
            self._batch_base = cur_batch

        out.extend(self._eval_lead_move(leader, health, ingress))
        out.extend(self._eval_batch(cur_batch))
        out.extend(self._eval_pipeline(senses, cur_batch))
        out.extend(self._eval_conf_resize(senses, leader, ingress))
        out.extend(self._eval_reshard(senses))
        out.extend(self._eval_recommend(senses, cur_batch))
        out.extend(self._eval_slo_burn(senses, leader))
        return out

    # ------------------------------------------------- actuator rules
    def _eval_lead_move(self, leader: int, health: Dict[Any, float],
                        ingress: Dict[int, float]) -> List[Decision]:
        """Re-place leadership near health and traffic: fires when the
        leader's own health verdict is bad (fail-slow) or when a
        dominant share of ingress lands on a healthy non-leader (the
        affinity flip)."""
        bad = float(health.get(leader, 1.0)) <= self.health_bad
        total_in = sum(ingress.values())
        top = None
        if total_in >= self.min_ingress:
            top = min(ingress, key=lambda s: (-ingress[s], s))
        affinity_off = (
            top is not None and top != leader
            and ingress[top] >= self.affinity_frac * total_in
            and float(health.get(top, 1.0)) > self.health_bad
        )
        st = self._acts["lead_move"]
        if bad or affinity_off:
            st.streak = max(1, st.streak + 1)
        else:
            st.streak = 0
        if st.streak < self.streak_need \
                or not self._admit("lead_move", 0):
            return []
        # preferred successor: the affinity target when the signal is
        # affinity; otherwise a seeded pick among healthy non-leaders
        # (advisory — the kernel's own election decides)
        if affinity_off:
            succ = int(top)
        else:
            cands = sorted(
                int(s) for s, sc in health.items()
                if int(s) != leader and float(sc) > self.health_bad
            )
            succ = self.rng.choice(cands) if cands else None
        reason = "leader-unhealthy" if bad else "leader-affinity"
        return [self._fire("lead_move", 0, leader, succ, reason)]

    def _eval_batch(self, cur: int) -> List[Decision]:
        """Shed-rate EWMA drives the ``api_max_batch`` ladder: sustained
        shedding doubles it (up to ``batch_max``); a sustained idle
        signal steps it back down toward the configured baseline —
        never below it, so the autopilot cannot starve a deliberately
        small ingress tier."""
        if not cur:
            return []
        st = self._acts["batch"]
        base = self._batch_base or cur
        if self._shed_ewma >= self.shed_hi and cur < self.batch_max:
            st.streak = max(1, st.streak + 1)
        elif self._shed_ewma <= self.shed_lo and cur > base:
            st.streak = min(-1, st.streak - 1)
        else:
            st.streak = 0
        if st.streak >= self.streak_need and self._admit("batch", 0):
            arg = min(cur * 2, self.batch_max)
            return [self._fire(
                "batch", 0, None, arg,
                f"shed_ewma={self._shed_ewma:.3f}",
            )]
        if st.streak <= -self.streak_need and self._admit("batch", 0):
            arg = max(cur // 2, base)
            return [self._fire("batch", 0, None, arg, "idle")]
        return []

    def _eval_pipeline(self, senses: Dict[str, Any],
                       cur_batch: int) -> List[Decision]:
        """Flip the pipelined tick loop on when shedding persists with
        the batch ladder exhausted — the remaining live throughput
        lever before compile-time recommendations."""
        st = self._acts["pipeline"]
        pipe = senses.get("pipeline")
        if (pipe is False and cur_batch >= self.batch_max
                and self._shed_ewma >= self.shed_hi):
            st.streak = max(1, st.streak + 1)
        else:
            st.streak = 0
        if st.streak >= self.streak_need \
                and self._admit("pipeline", 0):
            return [self._fire("pipeline", 0, None, True,
                               "shed-at-batch-max")]
        return []

    def _eval_conf_resize(self, senses: Dict[str, Any], leader: int,
                          ingress: Dict[int, float]) -> List[Decision]:
        """QL/Bodega lease-responder sizing per key-range heat:
        concentrated heat shrinks the responder set to {leader, hottest
        ingress replica} (fewer lease grants to revoke per write of a
        hot key); flat heat widens it back out (reads everywhere)."""
        if not senses.get("lease_protocol"):
            return []
        resp = senses.get("responders")
        if resp is None:
            return []
        resp = sorted(int(r) for r in resp)
        heat = {
            k: float(v)
            for k, v in (senses.get("heat") or {}).items()
            if k != RangeHeat.SPILL
        }
        total = sum(heat.values())
        top_share = (
            max(heat.values()) / total if total > 0 else 0.0
        )
        sids = sorted(
            int(s) for s in (senses.get("sids") or
                             range(self.population))
        )
        st = self._acts["conf_resize"]
        target: Optional[List[int]] = None
        reason = ""
        if (total >= self.heat_min
                and top_share >= self.lease_hot_share
                and len(resp) > 2):
            hot_sid = (
                min(ingress, key=lambda s: (-ingress[s], s))
                if ingress else leader
            )
            target = sorted({leader, int(hot_sid)})
            reason = f"heat-concentrated({top_share:.2f})"
        elif (total >= self.heat_min
                and top_share <= self.lease_flat_share
                and len(resp) < len(sids)):
            target = sids
            reason = f"heat-flat({top_share:.2f})"
        if target is not None and target != resp:
            st.streak = max(1, st.streak + 1)
        else:
            st.streak = 0
            return []
        if st.streak >= self.streak_need \
                and self._admit("conf_resize", 0):
            return [self._fire("conf_resize", 0, None, target, reason)]
        return []

    def _eval_reshard(self, senses: Dict[str, Any]) -> List[Decision]:
        """Heat-driven placement through the embedded ResharderPolicy.
        The heat signal must persist a full streak before ``decide`` is
        even consulted, and ``decide`` itself answers to this policy's
        budget via ``budget_gate`` — so a heat spike and a health
        indictment cannot both actuate on one group in one window."""
        if self.resharder is None:
            return []
        pol = self.resharder
        heat = {
            k: int(v) for k, v in (senses.get("heat") or {}).items()
        }
        live = {k: n for k, n in heat.items() if k != RangeHeat.SPILL}
        total = sum(live.values())
        hot = any(
            k not in pol._moved and n >= pol.hot_frac * total
            for k, n in live.items()
        ) if total >= pol.min_total else False
        cold = any(
            k in pol._moved and n <= pol.cold_frac * total
            for k, n in live.items()
        ) if total >= pol.min_total else False
        st = self._acts["reshard"]
        if hot or cold:
            st.streak = max(1, st.streak + 1)
        else:
            st.streak = 0
        if st.streak < self.streak_need:
            return []
        ch = pol.decide(heat)
        if ch is None:
            return []
        return [self._fire("reshard", int(ch.dst_group), None,
                           ch.as_dict(), ch.op)]

    def _eval_recommend(self, senses: Dict[str, Any],
                        cur_batch: int) -> List[Decision]:
        """Log-only compile-time recommendations: when overload survives
        every live knob (batch at max, pipeline on, shed EWMA still
        high), recommend the tally/wire_codec retunes a redeploy would
        apply.  Fires once per policy lifetime and spends no budget —
        there is nothing to actuate."""
        if self._recommended:
            return []
        st = self._acts["recommend"]
        if (cur_batch >= self.batch_max
                and senses.get("pipeline") is True
                and self._shed_ewma >= self.shed_hi):
            st.streak = max(1, st.streak + 1)
        else:
            st.streak = 0
        if st.streak < 2 * self.streak_need:
            return []
        self._recommended = True
        st.fires += 1
        d = Decision(
            self._round, "recommend", 0, None,
            {"tally": "hierarchical", "wire_codec": True},
            "overload-survives-live-knobs",
        )
        self._decisions.append(d)
        return [d]

    def _eval_slo_burn(self, senses: Dict[str, Any],
                       leader: int) -> List[Decision]:
        """graftwatch burn-rate alerts as a sense input: each LATCHED
        alert (fast AND slow burn over the policy's hi bound —
        host/graftwatch.py SloPolicy) must persist a full streak of
        rounds, then lowers through :data:`SLO_ACTUATORS` under the
        same admission gates as every native signal.  INERT without
        the ``slo_burn`` sense key: no streak state moves, no RNG
        draw happens, so a driver without a graftwatch attachment
        evaluates byte-identically to pre-graftwatch code."""
        burns = senses.get("slo_burn")
        if not burns:
            return []
        out: List[Decision] = []
        cur_batch = int(senses.get("api_max_batch", 0) or 0)
        for name in sorted(burns):
            row = burns[name] or {}
            streak = (
                self._slo_streaks.get(name, 0) + 1
                if row.get("alerting") else 0
            )
            self._slo_streaks[name] = streak
            if streak < self.streak_need:
                continue
            actuator = SLO_ACTUATORS.get(name)
            reason = (f"slo:{name} fast={row.get('fast')} "
                      f"slow={row.get('slow')}")
            if actuator == "batch":
                if not cur_batch or cur_batch >= self.batch_max \
                        or not self._admit("batch", 0):
                    continue
                self._slo_streaks[name] = 0
                arg = min(cur_batch * 2, self.batch_max)
                out.append(self._fire("batch", 0, None, arg, reason))
                cur_batch = arg
            elif actuator == "lead_move":
                if not self._admit("lead_move", 0):
                    continue
                self._slo_streaks[name] = 0
                # successor deliberately unspecified (no RNG draw —
                # the kernel's own election decides): the signal is
                # "this leader's durability path is burning budget",
                # not a placement preference
                out.append(self._fire(
                    "lead_move", 0, leader, None, reason
                ))
            elif actuator == "recommend":
                if self._recommended:
                    continue
                self._slo_streaks[name] = 0
                self._recommended = True
                st = self._acts["recommend"]
                st.fires += 1
                d = Decision(
                    self._round, "recommend", 0, None,
                    {"scan_tier": "learner"}, reason,
                )
                self._decisions.append(d)
                out.append(d)
        return out

    # -------------------------------------------------- decision trace
    def decisions(self) -> List[Decision]:
        return list(self._decisions)

    def config_line(self) -> str:
        """The canonical knob rendering — the static half of the
        timeline, regenerable by the gate without replaying senses."""
        return (
            f"autopilot seed={self.seed} pop={self.population} "
            f"G={self.G} streak={self.streak_need} "
            f"cooldown={self.cooldown_rounds} "
            f"window={self.window_rounds} "
            f"budget={self.budget_per_window} "
            f"shed=[{self.shed_lo},{self.shed_hi}] "
            f"batch_max={self.batch_max} "
            f"health_bad={self.health_bad} "
            f"affinity={self.affinity_frac}"
        )

    def timeline(self) -> str:
        lines = [self.config_line()]
        lines.extend(d.render() for d in self._decisions)
        return "\n".join(lines) + "\n"

    def digest(self) -> str:
        return hashlib.sha256(self.timeline().encode()).hexdigest()[:16]

    def config_digest(self) -> str:
        return hashlib.sha256(
            self.config_line().encode()
        ).hexdigest()[:16]


# ---------------------------------------------------------------- senses
def build_senses(snaps: Dict[str, dict], info: Any,
                 prev: Optional[dict]) -> Tuple[dict, dict]:
    """Fold one ``metrics_dump`` gather + one ``query_info`` reply into
    the canonical senses dict, computing per-interval DELTAS against the
    previous scrape's cumulative counters (cumulative series never cool;
    the delta is the live signal — the run_reshard_ab convention).

    Returns ``(senses, cursor)``; pass ``cursor`` back as ``prev`` on
    the next round.  Shared by the driver and the twin soak so both
    sides of an A/B sense identically.
    """
    cur = {"req": {}, "shed": {}, "heat": {}}
    health: Dict[int, float] = {}
    queue = 0.0
    batch = 0
    pipeline = None
    protocol = ""
    for sid_s, snap in (snaps or {}).items():
        sid = int(sid_s)
        host = snap.get("host", {}) or {}
        ctr = host.get("counters", {}) or {}
        gag = host.get("gauges", {}) or {}
        cur["req"][sid] = int(ctr.get("api_requests_total", 0))
        cur["shed"][sid] = int(ctr.get("api_shed", 0))
        for name, v in gag.items():
            if name.startswith("range_heat{key="):
                k = name[len("range_heat{key="):-1]
                cur["heat"][k] = cur["heat"].get(k, 0) + int(v)
        health[sid] = float(gag.get("health_score", 1.0))
        queue = max(queue, float(gag.get("api_queue_depth", 0.0)))
        batch = max(batch, int(snap.get("api_max_batch", 0) or 0))
        if pipeline is None:
            pipeline = bool(snap.get("pipeline", False))
        protocol = str(snap.get("protocol", protocol))
    prev = prev or {"req": {}, "shed": {}, "heat": {}}
    d_req = {
        sid: max(0, n - int(prev["req"].get(sid, 0)))
        for sid, n in cur["req"].items()
    }
    d_shed = sum(
        max(0, n - int(prev["shed"].get(sid, 0)))
        for sid, n in cur["shed"].items()
    )
    d_heat = {
        k: max(0, n - int(prev["heat"].get(k, 0)))
        for k, n in cur["heat"].items()
    }
    arrivals = sum(d_req.values())
    senses = {
        "population": len(getattr(info, "servers", None) or {})
        or len(snaps or {}),
        "alive": len(snaps or {}),
        "leader": getattr(info, "leader", None),
        "health": health,
        "ingress": d_req,
        "shed_rate": d_shed / arrivals if arrivals > 0 else 0.0,
        "queue_depth": queue,
        "api_max_batch": batch,
        "pipeline": pipeline,
        "heat": d_heat,
        "lease_protocol": (
            protocol.replace("_", "").lower() in LEASE_PROTOCOLS
        ),
        "responders": None,
        "sids": sorted(int(s) for s in (snaps or {})),
    }
    return senses, cur


# ---------------------------------------------------------------- driver
class AutopilotDriver:
    """Wall-clock sense/actuate loop around an :class:`AutopilotPolicy`.

    ``mode``:

    - ``"observe"`` — scrape + evaluate + log; ZERO ctrl mutations (the
      manager sees only the same read-only scrapes any telemetry client
      sends), so a cluster under an observing autopilot is
      byte-identical to one with no autopilot.
    - ``"act"`` — additionally lower fired decisions onto the ctrl
      plane and announce mode/cooldowns so the servers' autopilot
      gauges export the policy state.

    Test seams: ``sense_fn`` replaces the live scrape, ``ctrl``
    replaces the manager stub (a callable taking a CtrlRequest),
    ``conf_ctl`` / ``proxy_ctl`` carry the actuators whose transports
    live outside the ctrl plane (client ConfChange, proxy supervisor).
    """

    def __init__(
        self,
        manager_addr: Optional[Tuple[str, int]],
        policy: AutopilotPolicy,
        mode: str = "observe",
        scrape_s: float = 1.0,
        timeout: float = 8.0,
        ctrl: Optional[Callable[[CtrlRequest], Any]] = None,
        conf_ctl: Optional[Callable[[List[int]], Any]] = None,
        proxy_ctl: Optional[Callable[[Any], Any]] = None,
        sense_fn: Optional[Callable[[], Optional[dict]]] = None,
        slo_policy: Optional[Any] = None,
    ):
        if mode not in ("observe", "act"):
            raise ValueError(f"unknown autopilot mode {mode!r}")
        self.manager_addr = manager_addr
        self.policy = policy
        self.mode = mode
        self.scrape_s = float(scrape_s)
        self.timeout = float(timeout)
        self._ctrl = ctrl
        self.conf_ctl = conf_ctl
        self.proxy_ctl = proxy_ctl
        self._sense_fn = sense_fn
        # graftwatch attachment (host/graftwatch.py SloPolicy): when
        # given, each scrape also pulls the manager's fleet series
        # (watch_series — a read-only request, so observe mode stays
        # mutation-free), folds any NEW windows through the policy, and
        # feeds the latched burn verdicts as senses["slo_burn"]
        self.slo_policy = slo_policy
        self._slo_widx = -1
        self._prev: Optional[dict] = None
        self._stub = None
        #: rendered ctrl mutations actually SENT (empty in observe mode
        #: by construction — the gate's byte-identical check)
        self.actuation_log: List[str] = []
        #: every fired decision, rendered (observe mode logs here too)
        self.decision_log: List[str] = []

    # ------------------------------------------------------------ ctrl
    def _request(self, req: CtrlRequest) -> Any:
        if self._ctrl is not None:
            return self._ctrl(req)
        from ..client.endpoint import ClientCtrlStub

        try:
            if self._stub is None:
                self._stub = ClientCtrlStub(self.manager_addr)
            return self._stub.request(req, timeout=self.timeout)
        except Exception as e:
            pf_warn(logger, f"ctrl request {req.kind} failed: {e}")
            try:
                if self._stub is not None:
                    self._stub.sock.close()
            except Exception:
                pass
            self._stub = None
            return None

    def close(self) -> None:
        if self._stub is not None:
            try:
                self._stub.close()
            except Exception:
                pass
            self._stub = None

    # ---------------------------------------------------------- senses
    def _scrape(self) -> Optional[dict]:
        from ..client.endpoint import scrape_metrics

        info = self._request(CtrlRequest("query_info"))
        if info is None:
            return None
        snaps = scrape_metrics(self.manager_addr, timeout=self.timeout)
        senses, self._prev = build_senses(snaps, info, self._prev)
        if self.slo_policy is not None:
            burn = self._scrape_burn()
            if burn:
                senses["slo_burn"] = burn
        return senses

    def _scrape_burn(self) -> Optional[dict]:
        """Pull the fleet series and fold NEW windows (widx strictly
        beyond the last observed one) through the attached SloPolicy;
        return its latched status.  Windows still in flight next scrape
        are re-merged then — only completed indices are consumed, so
        one window is never double-counted."""
        from .graftwatch import windows

        rep = self._request(CtrlRequest("watch_series"))
        export = (getattr(rep, "payloads", None) or {}).get("fleet") \
            if rep is not None else None
        if not export:
            return None
        fresh = [
            w for w in windows(export) if w["widx"] > self._slo_widx
        ]
        # the newest widx may still be accumulating frames; hold it
        # back one scrape so a partial window can't fake a burn dip
        if fresh:
            fresh = fresh[:-1]
        for w in fresh:
            self.slo_policy.observe_window(w)
            self._slo_widx = w["widx"]
        return self.slo_policy.status() or None

    # ------------------------------------------------------------ loop
    def step(self) -> List[Decision]:
        """One sense->decide(->actuate) round."""
        senses = (
            self._sense_fn() if self._sense_fn is not None
            else self._scrape()
        )
        if senses is None:
            return []
        decisions = self.policy.evaluate(senses)
        for d in decisions:
            self.decision_log.append(d.render())
            pf_info(logger, f"decision: {d.render()}")
        if self.mode == "act":
            for d in decisions:
                self._actuate(d)
            self._announce()
        return decisions

    def play(self, stop: threading.Event) -> None:
        """Run rounds on the scrape cadence until ``stop`` is set."""
        while not stop.is_set():
            try:
                self.step()
            except Exception as e:  # a flaky scrape must not kill the loop
                pf_warn(logger, f"autopilot round failed: {e}")
            stop.wait(self.scrape_s)
        self.close()

    # -------------------------------------------------------- actuate
    def _send(self, what: str, req: CtrlRequest) -> None:
        self.actuation_log.append(what)
        rep = self._request(req)
        if rep is None:
            pf_warn(logger, f"actuation got no reply: {what}")

    def _actuate(self, d: Decision) -> None:
        if d.actuator == "lead_move":
            self._send(
                f"autopilot_ctl demote -> s{d.target} [{d.reason}]",
                CtrlRequest(
                    "autopilot_ctl", servers=[int(d.target)],
                    payload={"act": "demote", "reason": d.reason},
                ),
            )
        elif d.actuator == "batch":
            self._send(
                f"autopilot_ctl retune api_max_batch={d.arg}",
                CtrlRequest(
                    "autopilot_ctl",
                    payload={"act": "retune",
                             "api_max_batch": int(d.arg)},
                ),
            )
        elif d.actuator == "pipeline":
            self._send(
                f"autopilot_ctl retune pipeline={bool(d.arg)}",
                CtrlRequest(
                    "autopilot_ctl",
                    payload={"act": "retune",
                             "pipeline": bool(d.arg)},
                ),
            )
        elif d.actuator == "conf_resize":
            if self.conf_ctl is None:
                pf_warn(logger, "conf_resize fired with no conf_ctl "
                                "hook; dropped")
                return
            self.actuation_log.append(
                f"conf_ctl responders={list(d.arg)}"
            )
            self.conf_ctl(list(d.arg))
        elif d.actuator == "reshard":
            self._send(
                f"range_change {d.arg.get('op')} "
                f"[{d.arg.get('start')!r},{d.arg.get('end')!r}) "
                f"-> g{d.arg.get('dst_group')}",
                CtrlRequest("range_change", payload=dict(d.arg)),
            )
        elif d.actuator == "recommend":
            pf_info(logger, f"recommend (compile-time): {d.arg}")

    def _announce(self) -> None:
        """Export the policy state through the servers' gauges (act
        mode only — observe mode must stay mutation-free)."""
        self._request(CtrlRequest("autopilot_ctl", payload={
            "act": "announce", "mode": self.mode,
            "cooldowns": self.policy.cooldowns(),
        }))
