"""The autopilot of the port against the JAX package.

Each schedule of ``tests/test_autopilot.py`` feeds the same senses to
both packages' ``AutopilotPolicy``: the decision timeline, ``digest()``
and ``config_digest()`` are equal.  ``build_senses`` over the same
scrapes gives equal senses and cursors.  The driver against a fake ctrl
renders the same ``CtrlRequest``s in ``act`` mode and none in
``observe`` mode.
"""

import dataclasses
from typing import Any, Dict

import pytest

from summerset_tpu.host import autopilot as jap
from summerset_tpu.host import resharding as jrs
from summerset_tpu_torch.host import autopilot as tap
from summerset_tpu_torch.host import resharding as trs

PKGS = {"jax": (jap, jrs), "torch": (tap, trs)}


def base_senses(**over) -> Dict[str, Any]:
    s = {
        "population": 3, "alive": 3, "leader": 0,
        "health": {0: 1.0, 1: 1.0, 2: 1.0},
        "ingress": {0: 50.0, 1: 10.0, 2: 10.0},
        "shed_rate": 0.0, "queue_depth": 0.0,
        "api_max_batch": 2, "pipeline": False,
        "heat": {}, "lease_protocol": False, "responders": None,
        "sids": [0, 1, 2],
    }
    s.update(over)
    return s


def burn(alerting=True, fast=5.0, slow=5.0):
    return {"burn": fast, "fast": fast, "slow": slow, "alerting": alerting}


#: name -> (policy keywords, the resharder's keywords or None, senses)
SCHEDULES = {
    "oscillating_shed": (dict(shed_alpha=1.0), None,
                         [base_senses(shed_rate=0.5 if i % 2 == 0 else 0.0)
                          for i in range(40)]),
    "sustained_shed": ({}, None, [base_senses(shed_rate=0.5)] * 12),
    "sub_threshold": ({}, None, [base_senses(shed_rate=0.001)] * 30),
    "no_quorum": ({}, None, [base_senses(shed_rate=0.5)] * 2
                  + [base_senses(shed_rate=0.5, alive=1)] * 10),
    "leaderless": ({}, None, [base_senses(shed_rate=0.5, leader=None)] * 8),
    "window_budget": (dict(streak_need=1, cooldown_rounds=0,
                           budget_per_window=2, window_rounds=8), None,
                      [base_senses(shed_rate=0.5,
                                   health={0: 0.1, 1: 1.0, 2: 1.0})] * 64),
    "group_budget": (dict(streak_need=1, cooldown_rounds=0,
                          budget_per_window=8, window_rounds=6,
                          num_groups=2),
                     dict(hot_frac=0.25, cold_frac=0.02, min_total=10),
                     [base_senses(health={0: 0.1, 1: 1.0, 2: 1.0},
                                  heat={"hot": 90, "cold": 10})] * 18),
    "determinism": ({}, None,
                    [base_senses()] * 2
                    + [base_senses(shed_rate=0.4)] * 6
                    + [base_senses(alive=1)] * 3
                    + [base_senses(health={0: 0.2, 1: 1.0, 2: 1.0})] * 8
                    + [base_senses()] * 4),
    "reply_burn": ({}, None,
                   [base_senses(slo_burn={"reply_p99": burn()})] * 5),
    "flapping_burn": ({}, None, [base_senses(
        slo_burn={"reply_p99": burn(alerting=i % 2 == 0)})
        for i in range(30)]),
    "wal_burn": ({}, None,
                 [base_senses(slo_burn={"wal_fsync_lag": burn()})] * 5),
    "scan_burn": (dict(cooldown_rounds=0), None,
                  [base_senses(slo_burn={"scan_starvation": burn()})] * 20),
    "heat_and_lease": (dict(streak_need=1, cooldown_rounds=0,
                            budget_per_window=99, window_rounds=1,
                            num_groups=2, shed_alpha=1.0),
                       dict(min_total=10),
                       [base_senses(health={0: 0.1, 1: 1.0, 2: 1.0}),
                        base_senses(shed_rate=0.6),
                        base_senses(shed_rate=0.6, api_max_batch=16),
                        base_senses(lease_protocol=True,
                                    responders=[0, 1, 2],
                                    heat={"hk": 95, "x": 5}),
                        base_senses(heat={"hk2": 90, "y": 10})]),
}


def make_policy(ap, rs, kw, rkw, seed=7):
    args = dict(seed=seed, population=3, streak_need=3, cooldown_rounds=10,
                window_rounds=8, budget_per_window=2)
    args.update(kw)
    if rkw is not None:
        args["resharder"] = rs.ResharderPolicy(2, lambda k: 1, **rkw)
    return ap.AutopilotPolicy(**args)


def plain(x):
    if dataclasses.is_dataclass(x):
        return {k: plain(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_policy_timeline_equals_jax(case):
    kw, rkw, senses = SCHEDULES[case]
    got = {}
    for name, (ap, rs) in PKGS.items():
        p = make_policy(ap, rs, kw, rkw)
        fired = [plain(p.evaluate(dict(s))) for s in senses]
        got[name] = (fired, p.timeline(), p.digest(), p.config_digest(),
                     plain(p.decisions()), p.last_quorum)
    assert got["jax"] == got["torch"]
    assert tap.ACTUATORS == jap.ACTUATORS


def test_config_digest_tracks_knobs_equal_jax():
    got = {name: [make_policy(ap, rs, {}, None, seed=s).config_digest()
                  for s in (42, 43)] for name, (ap, rs) in PKGS.items()}
    assert got["jax"] == got["torch"]
    assert got["torch"][0] != got["torch"][1]


def snap(sid, req=0, shed=0, heat=(), score=1.0, batch=4, proto="MultiPaxos"):
    gauges = {"health_score": score, "api_queue_depth": 2.0 * sid}
    for k, n in heat:
        gauges[f"range_heat{{key={k}}}"] = n
    return {"protocol": proto, "pipeline": False, "api_max_batch": batch,
            "host": {"counters": {"api_requests_total": req,
                                  "api_shed": shed},
                     "gauges": gauges}}


class _Info:
    leader = 0
    servers = {0: None, 1: None, 2: None}


@pytest.mark.parametrize("proto", ["MultiPaxos", "QuorumLeases"])
def test_build_senses_equal_jax(proto):
    rounds = [
        {str(s): snap(s, req=100, heat=[("hk", 50)], proto=proto)
         for s in range(3)},
        {str(s): snap(s, req=150, shed=25, heat=[("hk", 80), ("x", 3)],
                      score=0.5 if s == 1 else 1.0, proto=proto)
         for s in range(3)},
        {str(s): snap(s, req=400, shed=30, heat=[("hk", 81)], batch=8,
                      proto=proto) for s in range(2)},
    ]
    got = {}
    for name, (ap, _rs) in PKGS.items():
        cur, out = None, []
        for snaps in rounds:
            s, cur = ap.build_senses(snaps, _Info(), cur)
            out.append((s, cur))
        got[name] = out
    assert got["jax"] == got["torch"]


class FakeCtrl:
    def __init__(self):
        self.requests = []

    def __call__(self, req):
        self.requests.append(req)
        return None if req.kind == "query_info" else {"ok": True}

    def rendered(self):
        return [(r.kind, r.servers, r.durable, r.payload)
                for r in self.requests]


@pytest.mark.parametrize("mode", ["act", "observe"])
def test_driver_renders_equal_requests(mode):
    kw, rkw, senses = SCHEDULES["heat_and_lease"]
    got = {}
    for name, (ap, rs) in PKGS.items():
        ctrl = FakeCtrl()
        conf_calls = []
        p = ap.AutopilotPolicy(
            seed=7, population=3, streak_need=1, cooldown_rounds=0,
            budget_per_window=99, window_rounds=1, num_groups=2,
            shed_alpha=1.0,
            resharder=rs.ResharderPolicy(2, lambda k: 0, min_total=10))
        it = iter(senses)
        drv = ap.AutopilotDriver(None, p, mode=mode, ctrl=ctrl,
                                 conf_ctl=conf_calls.append,
                                 sense_fn=lambda: next(it, None))
        for _ in senses:
            drv.step()
        got[name] = (ctrl.rendered(), conf_calls, plain(drv.decision_log),
                     plain(drv.actuation_log))
    assert got["jax"] == got["torch"]
    if mode == "observe":
        assert got["torch"][0] == [] and got["torch"][3] == []
    else:
        kinds = [(k, (pl or {}).get("act")) for k, _s, _d, pl
                 in got["torch"][0]]
        assert ("autopilot_ctl", "demote") in kinds
        assert ("range_change", None) in kinds
