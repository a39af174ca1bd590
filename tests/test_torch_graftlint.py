"""The port's analysis plane held to the JAX package's on the CPU:
graftlint's broken-kernel fixtures, the host sync rule, the host lint,
the report format and the port's committed baseline.

Each fixture of ``tests/graftlint_fixtures`` is ported below as a torch
kernel violating the same one rule; the port's pass gives the same
``(code, scope)`` list as the JAX pass on the JAX fixture, computed live
(C10 scopes name the defining file, which differs, so they compare by
the input name).  The collective-outside-scope fixture has no
counterpart: a port step holds no collective op (the collective tally's
record is gathered by ``core/sharding.exchange`` outside the step), so a
c10d op anywhere in a step is the C6 finding, checked on a step that
calls one.
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import graftlint_fixtures as jfix  # noqa: E402
import test_graftlint as jtests  # noqa: E402

from summerset_tpu.analysis import hostlint as jhostlint  # noqa: E402
from summerset_tpu.analysis.contract import (  # noqa: E402
    verify_kernel as j_verify_kernel,
)
from summerset_tpu.analysis.ranges import (  # noqa: E402
    verify_kernel_ranges as j_verify_kernel_ranges,
)
from summerset_tpu.analysis.report import Finding as JFinding  # noqa: E402
from summerset_tpu.analysis.taint import (  # noqa: E402
    verify_kernel_taint as j_verify_kernel_taint,
)
from summerset_tpu_torch import graftlint  # noqa: E402
from summerset_tpu_torch.analysis import hostlint  # noqa: E402
from summerset_tpu_torch.analysis.contract import (  # noqa: E402
    rule_finding,
    trace_step,
    verify_kernel,
)
from summerset_tpu_torch.analysis.ranges import (  # noqa: E402
    verify_kernel_ranges,
)
from summerset_tpu_torch.analysis.report import (  # noqa: E402
    Finding,
    assemble_report,
    dumps_report,
)
from summerset_tpu_torch.analysis.taint import (  # noqa: E402
    verify_kernel_taint,
)
from summerset_tpu_torch.core import quorum as quorum_lib  # noqa: E402
from summerset_tpu_torch.core.protocol import (  # noqa: E402
    KERNEL_CONTRACT,
    ProtocolKernel,
    StepEffects,
    phase_scope,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ROOT = os.path.join(REPO, "summerset_tpu_torch")


# ------------------------------------------------------ the port fixtures --
class GoodKernel(ProtocolKernel):
    """Minimal contract-clean kernel: one flags-gated inbox fold."""

    name = "FixtureGood"
    DURABLE_SCALARS = ("commit_bar",)
    DURABLE_WINDOWS = ("win_val",)
    VALUE_WINDOW = "win_val"

    def init_state(self, seed: int = 0):
        G, R, W = self.G, self.R, self.W
        return {
            "commit_bar": self.zeros(G, R),
            "exec_bar": self.zeros(G, R),
            "win_val": self.zeros(G, R, W),
        }

    def zero_outbox(self):
        G, R = self.G, self.R
        return {"flags": self.zeros(G, R, R), "data": self.zeros(G, R, R)}

    def _fold(self, s, inbox):
        valid = (inbox["flags"] & 1) != 0
        best = torch.where(valid, inbox["data"], 0).amax(dim=2)
        s["commit_bar"] = torch.maximum(s["commit_bar"], best)

    def step(self, state, inbox, inputs):
        s = dict(state)
        self._fold(s, inbox)
        s["exec_bar"] = s["commit_bar"]
        self._accumulate_telemetry(state, s, SimpleNamespace())
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


class UnflaggedInboxReadKernel(GoodKernel):
    name = "FixtureUnflagged"

    def step(self, state, inbox, inputs):
        s = dict(state)
        self._fold(s, inbox)
        s["shadow"] = inbox["data"].amax(dim=2)
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )

    def init_state(self, seed: int = 0):
        st = super().init_state(seed)
        st["shadow"] = self.zeros(self.G, self.R)
        return st


class UnflaggedEffectsKernel(GoodKernel):
    name = "FixtureUnflaggedEffects"

    def step(self, state, inbox, inputs):
        s = dict(state)
        self._fold(s, inbox)
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"],
            extra={"raw_peek": inbox["data"].amax(dim=2)},
        )


class InvertedGateKernel(GoodKernel):
    name = "FixtureInvertedGate"

    def step(self, state, inbox, inputs):
        s = dict(state)
        self._fold(s, inbox)
        valid = (inbox["flags"] & 1) != 0
        s["shadow"] = torch.where(valid, 0, inbox["data"]).amax(dim=2)
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )

    def init_state(self, seed: int = 0):
        st = super().init_state(seed)
        st["shadow"] = self.zeros(self.G, self.R)
        return st


class RangeUnsoundKernel(GoodKernel):
    name = "FixtureRangeUnsound"
    RANGE_CLAIMS = (("commit_bar", 0, 100),)


class RangeEntangledKernel(GoodKernel):
    name = "FixtureRangeEntangled"

    def init_state(self, seed: int = 0):
        st = super().init_state(seed)
        st["prep_bal"] = self.zeros(self.G, self.R)
        return st

    def step(self, state, inbox, inputs):
        s = dict(state)
        valid = (inbox["flags"] & 1) != 0
        bal = torch.where(valid, inbox["data"], -1).amax(dim=2)
        payload = inbox["data"].amax(dim=2)
        ok = bal > s["prep_bal"]
        s["commit_bar"] = torch.where(ok, payload, s["commit_bar"])
        s["prep_bal"] = torch.maximum(s["prep_bal"], bal)
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


class StaleAllowKernel(GoodKernel):
    name = "FixtureStaleAllow"
    TAINT_ALLOW = (
        ("data", "commit_bar", "declared but the flow is actually gated"),
    )


class FloatStateKernel(GoodKernel):
    name = "FixtureFloatState"

    def init_state(self, seed: int = 0):
        st = super().init_state(seed)
        st["score"] = self.zeros(self.G, self.R, dtype=torch.float32)
        return st


class MissingFlagsKernel(GoodKernel):
    name = "FixtureMissingFlags"

    def zero_outbox(self):
        return {"data": self.zeros(self.G, self.R, self.R)}

    def step(self, state, inbox, inputs):
        s = dict(state)
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


class UndeclaredBroadcastKernel(GoodKernel):
    name = "FixtureUndeclaredBroadcast"

    def zero_outbox(self):
        out = super().zero_outbox()
        out["bw_extra"] = self.zeros(self.G, self.R, self.W)
        return out


class BogusDurableKernel(GoodKernel):
    name = "FixtureBogusDurable"
    DURABLE_WINDOWS = ("win_val", "win_ghost")


class UndeclaredInputKernel(GoodKernel):
    name = "FixtureUndeclaredInput"

    def step(self, state, inbox, inputs):
        s = dict(state)
        self._fold(s, inbox)
        ghost = inputs.get("ghost_lane")  # the violation: undeclared
        if ghost is not None:
            s["commit_bar"] = s["commit_bar"] + ghost[:, None]
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


class BrokenForwarderKernel(GoodKernel):
    name = "FixtureBrokenForwarder"

    def step(self, state, inbox, inputs):
        s = dict(state)
        self._fold(s, inbox)
        s["exec_bar"] = s["commit_bar"]
        out = self.zero_outbox()
        out["data"] = inbox["data"].transpose(1, 2)
        out["flags"] = self.full((self.G, self.R, self.R), 1)
        return s, out, StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


class AllowedForwarderKernel(BrokenForwarderKernel):
    name = "FixtureAllowedForwarder"
    TAINT_ALLOW = (
        ("data", "outbox.data",
         "fixture: deliberate relay lane, receiver re-validates"),
    )


class GoodCollectiveKernel(GoodKernel):
    """A per-source [G, R] tally record (the collective tally's broadcast
    lane) folded in the quorum_tally phase, gated per source."""

    name = "FixtureGoodCollective"
    broadcast_lanes = frozenset({"tlane"})
    TALLY_LANES = ("tlane",)

    def zero_outbox(self):
        out = super().zero_outbox()
        out["tlane"] = self.zeros(self.G, self.R)
        return out

    def _tally(self, s, inbox, gated: bool):
        contrib = inbox["tlane"]
        if gated:
            valid_src = ((inbox["flags"] & 1) != 0).any(dim=1)
            contrib = torch.where(valid_src, contrib, 0)
        s["commit_bar"] = torch.maximum(
            s["commit_bar"], contrib.sum(dim=1, dtype=torch.int32)[:, None]
        )

    def step(self, state, inbox, inputs):
        s = dict(state)
        self._fold(s, inbox)
        with quorum_lib.tally_scope():
            self._tally(s, inbox, gated=True)
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


class UngatedCollectiveTallyKernel(GoodCollectiveKernel):
    name = "FixtureUngatedCollective"

    def step(self, state, inbox, inputs):
        s = dict(state)
        self._fold(s, inbox)
        with quorum_lib.tally_scope():
            self._tally(s, inbox, gated=False)  # the violation
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


class C10dInStepKernel(GoodCollectiveKernel):
    """C6: a c10d collective inside the step (the port's counterpart of
    the JAX collective-outside-scope fixture; no scope sanctions one)."""

    name = "FixtureC10dInStep"

    def step(self, state, inbox, inputs):
        import torch.distributed as dist

        s = dict(state)
        self._fold(s, inbox)
        with quorum_lib.tally_scope():
            agg = inbox["tlane"] + 0
            dist.all_reduce(agg)
            s["commit_bar"] = torch.maximum(
                s["commit_bar"], agg.sum(dim=1, dtype=torch.int32)[:, None]
            )
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


FIXTURES = {
    "fixturegood": GoodKernel,
    "fixturegoodcollective": GoodCollectiveKernel,
    "fixtureungatedcollective": UngatedCollectiveTallyKernel,
    "fixturec10dinstep": C10dInStepKernel,
    "fixturebrokenforwarder": BrokenForwarderKernel,
    "fixtureallowedforwarder": AllowedForwarderKernel,
    "fixtureinvertedgate": InvertedGateKernel,
    "fixtureunflagged": UnflaggedInboxReadKernel,
    "fixtureunflaggedeffects": UnflaggedEffectsKernel,
    "fixturerangeunsound": RangeUnsoundKernel,
    "fixturerangeentangled": RangeEntangledKernel,
    "fixturestaleallow": StaleAllowKernel,
    "fixturefloatstate": FloatStateKernel,
    "fixturemissingflags": MissingFlagsKernel,
    "fixtureundeclaredbroadcast": UndeclaredBroadcastKernel,
    "fixturebogusdurable": BogusDurableKernel,
    "fixtureundeclaredinput": UndeclaredInputKernel,
}


def make_fixture(name, *args, **kwargs):
    return FIXTURES[name.lower()](*args, **kwargs)


PORT_PASS = {"contract": verify_kernel, "taint": verify_kernel_taint,
             "ranges": verify_kernel_ranges}
JAX_PASS = {"contract": j_verify_kernel, "taint": j_verify_kernel_taint,
            "ranges": j_verify_kernel_ranges}


def _port(passname, name, **kw):
    return PORT_PASS[passname](make_fixture, name, device="cpu", **kw)


def _jax(passname, name, **kw):
    return JAX_PASS[passname](jfix.make_fixture, name, **kw)


def _codes(res):
    """(code, scope) pairs; a C10 scope names the defining file, which
    differs between the packages, so it compares by the input name."""
    assert res.error is None, res.error
    out = []
    for f in res.findings:
        scope = f.scope.split(":", 1)[1] if f.code == "C10" else f.scope
        out.append((f.code, scope))
    return sorted(out)


# every JAX fixture with the pass that reports its planted rule (the
# collective-outside-scope fixture is checked apart, see the module doc)
FIXTURE_CASES = [
    ("fixturegood", "contract"), ("fixturegood", "taint"),
    ("fixturegood", "ranges"),
    ("fixturegoodcollective", "contract"),
    ("fixturegoodcollective", "taint"),
    ("fixtureungatedcollective", "taint"),
    ("fixturebrokenforwarder", "taint"),
    ("fixtureallowedforwarder", "taint"),
    ("fixtureinvertedgate", "taint"),
    ("fixtureunflagged", "taint"),
    ("fixtureunflaggedeffects", "taint"),
    ("fixturerangeunsound", "ranges"),
    ("fixturerangeentangled", "taint"),
    ("fixturerangeentangled", "ranges"),
    ("fixturestaleallow", "taint"),
    ("fixturefloatstate", "contract"),
    ("fixturemissingflags", "contract"),
    ("fixtureundeclaredbroadcast", "contract"),
    ("fixturebogusdurable", "contract"),
    ("fixtureundeclaredinput", "contract"),
]


@pytest.mark.parametrize("name,passname", FIXTURE_CASES)
def test_fixture_matches_jax_live(name, passname):
    got = _codes(_port(passname, name))
    want = _codes(_jax(passname, name))
    assert got == want
    if name in ("fixturegood", "fixturegoodcollective"):
        assert got == []


# the planted violation is the only one: the other pass stays clean
ONLY_OWN_RULE = [
    ("fixtureunflagged", "contract"),
    ("fixtureinvertedgate", "contract"),
    ("fixtureunflaggedeffects", "contract"),
    ("fixturebrokenforwarder", "contract"),
    ("fixtureungatedcollective", "contract"),
    ("fixturefloatstate", "taint"),
    ("fixturebogusdurable", "taint"),
    ("fixtureundeclaredinput", "taint"),
    ("fixturerangeunsound", "contract"),
    ("fixturerangeunsound", "taint"),
]


@pytest.mark.parametrize("name,passname", ONLY_OWN_RULE)
def test_fixture_fails_only_its_rule(name, passname):
    assert _port(passname, name).ok
    assert _jax(passname, name).ok


def test_ungated_collective_reaches_every_sink():
    """T1 fires on each sink the ungated tally record lands in, the same
    four flows as the JAX fixture's psum."""
    res = _port("taint", "fixtureungatedcollective")
    assert {f.scope for f in res.findings} == {
        "tlane->commit_bar", "tlane->exec_bar",
        "tlane->effects.commit_bar", "tlane->effects.exec_bar",
    }


def test_c10d_op_in_a_step_fires_c6():
    """The JAX collective-outside-scope fixture (``psum`` outside the
    quorum_tally scope) has no port counterpart while no step holds a
    collective op; any c10d op in a step, tally phase or not, is C6."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert _codes(_jax("contract", "fixturecollectiveoutsidescope")) == [
        ("C6", "step:psum")
    ]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=1)
    try:
        res = _port("contract", "fixturec10dinstep")
    finally:
        dist.destroy_process_group()
    assert _codes(res) == [("C6", "step:c10d.allreduce_.default")]


def test_range_entangled_gate_is_proven_only_with_intervals():
    with_rng = _port("taint", "fixturerangeentangled", use_ranges=True)
    without = _port("taint", "fixturerangeentangled", use_ranges=False)
    assert with_rng.ok and without.ok
    assert with_rng.extra["gates_proven"] == 2
    assert with_rng.extra["gates_optimistic"] == 0
    assert without.extra["gates_proven"] == 1
    assert without.extra["gates_optimistic"] == 1
    assert [r["op"] for r in without.extra["residuals"]] == [
        "aten.where.self"]
    dev = _port("ranges", "fixturerangeentangled").extra["variants"][
        "device"]
    assert dev["invariants"]["prep_bal"][0] == 0


def test_allowed_forwarder_suppresses_outbox_sink():
    res = _port("taint", "fixtureallowedforwarder")
    assert res.ok, [f.render() for f in res.findings]
    assert [(f.scope, r) for f, r in res.suppressed] == [
        ("data->outbox.data",
         "fixture: deliberate relay lane, receiver re-validates")
    ]


# ------------------------------------------------- C6 on the recorded trace --
class _PhasedSync(GoodKernel):
    name = "FixtureSync"

    def step(self, state, inbox, inputs):
        s = dict(state)
        with phase_scope("fold"):
            if bool(((inbox["flags"] & 1) != 0).any()):
                self._fold(s, inbox)
        s["exec_bar"] = s["commit_bar"]
        return s, self.zero_outbox(), StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"]
        )


def _one(cls, passname="contract"):
    return PORT_PASS[passname](lambda _n, *a, **k: cls(*a, **k), "x",
                               device="cpu")


def test_undeclared_host_sync_fires_c6():
    res = _one(_PhasedSync)
    assert _codes(res) == [("C6", "step:sync:fold")]


def test_declared_host_sync_is_suppressed_with_its_reason():
    class Declared(_PhasedSync):
        HOST_SYNCS = (("fold", "fixture: skips the fold when idle"),)

    res = _one(Declared)
    assert res.ok
    assert [(f.code, f.scope, r) for f, r in res.suppressed] == [
        ("C6", "step:sync:fold", "fixture: skips the fold when idle")]
    # both outcomes of the one bool read were recorded as branches
    k = Declared(2, 3, 8, device="cpu")
    st = trace_step(k)
    assert st.n_syncs == 1 and len(st.branches) == 2
    assert [b.forced for b in st.branches] == [(False,), (True,)]
    assert len(st.branches[1].calls) > len(st.branches[0].calls)
    # the flows of the taken branch reach the pass: still gated, clean
    assert _one(Declared, "taint").ok


def test_stale_host_sync_entry_fires_c6():
    class Stale(GoodKernel):
        HOST_SYNCS = (("gone", "fixture: no read any more"),)

    assert _codes(_one(Stale)) == [("C6", "HOST_SYNCS:gone")]


def test_multipaxos_prepare_reply_sync_is_declared():
    from summerset_tpu_torch import protocols

    res = verify_kernel(protocols.make_protocol, "multipaxos", device="cpu")
    assert res.ok, [f.render() for f in res.findings] or res.error
    assert [(f.scope, r.split(" ")[0]) for f, r in res.suppressed] == [
        ("step:sync:ingest_prepare_reply", "_gated_prepare_reply")]


def test_in_place_write_and_rng_fire_c6():
    class InPlace(GoodKernel):
        def step(self, state, inbox, inputs):
            state["commit_bar"].add_(1)  # the violation
            return super().step(state, inbox, inputs)

    class Rng(GoodKernel):
        def step(self, state, inbox, inputs):
            s, out, fx = super().step(state, inbox, inputs)
            s["exec_bar"] = s["exec_bar"] + torch.randint(
                0, 2, (self.G, self.R), dtype=torch.int32)
            return s, out, fx

    assert ("C6", "step:state.commit_bar") in _codes(_one(InPlace))
    assert _codes(_one(Rng)) == [("C6", "step:aten.randint.low")]


def test_cpu_leaf_beside_a_card_kernel_fires_c1(monkeypatch):
    """C1 placement: a leaf on another device than the kernel's (here a
    ``meta`` kernel handing back CPU tensors) is a finding."""
    class Split(GoodKernel):
        def init_state(self, seed=0):
            st = super().init_state(seed)
            st["win_val"] = st["win_val"].to("meta")
            return st

    res = _one(Split)
    assert ("C1", "win_val") in _codes(res)


# ------------------------------------------------------------- host lint --
SNIPPETS = sorted(
    n for n, v in vars(jtests).items()
    if n.startswith("_") and n.isupper() and isinstance(v, str)
    and ("class " in v or "def " in v)
)
RELS = ("host/x.py", "host/storage.py", "host/nemesis.py",
        "host/workload.py", "host/autopilot.py", "host/server.py",
        "host/tracing.py", "host/profiling.py", "host/ingress.py",
        "host/other.py", "host/metrics.py")


def _scan_both(tmp_path, src, rel):
    p = tmp_path / "mod.py"
    p.write_text(src)
    a = hostlint.scan_file(str(p), rel)
    b = jhostlint.scan_file(str(p), rel)

    def key(res):
        findings, supp = res
        return (sorted((f.fingerprint, f.line) for f in findings),
                sorted((f.fingerprint, r) for f, r in supp))
    return key(a), key(b)


def test_snippets_cover_the_jax_host_lint_tests():
    assert len(SNIPPETS) >= 15, SNIPPETS


@pytest.mark.parametrize("snippet", SNIPPETS)
def test_hostlint_matches_jax_on_snippet(tmp_path, snippet):
    src = getattr(jtests, snippet)
    for rel in RELS:
        port, jax_ = _scan_both(tmp_path, src, rel)
        assert port == jax_, rel


def test_hostlint_tree_walk_matches_jax(tmp_path):
    sub = tmp_path / "host" / "replication"
    sub.mkdir(parents=True)
    (sub / "wal.py").write_text(jtests._LOCKED_FSYNC)
    (tmp_path / "utils").mkdir()
    (tmp_path / "utils" / "u.py").write_text(jtests._NON_DAEMON)
    a, na = hostlint.lint_host(str(tmp_path))
    b, nb = jhostlint.lint_host(str(tmp_path))
    assert na == nb == 2
    assert a.as_json() == b.as_json()


def test_port_host_tree_is_clean():
    res, n_files = hostlint.lint_host(PORT_ROOT)
    assert n_files > 20
    assert res.ok, [f.render() for f in res.findings]
    waived = {(f.code, f.where, f.scope) for f, _ in res.suppressed}
    for site in (
        ("H105", "host/server.py", "ServerReplica._tick_serial:send_tick"),
        ("H104", "host/server.py", "ServerReplica._take_snapshot:os.fsync"),
        ("H101", "host/transport.py", "TransportHub.send_tick:sendmsg_all"),
    ):
        assert site in waived
    assert all(r for _, r in res.suppressed)


# --------------------------------------------------------------- reports --
def test_report_is_deterministic_and_fingerprints_match_jax():
    host, n = hostlint.lint_host(PORT_ROOT)
    kres = {"Fixture": {"contract": _port("contract", "fixturegood")}}
    a = dumps_report(assemble_report(kres, host, n))
    b = dumps_report(assemble_report(kres, host, n))
    assert a == b
    assert '"version": 1' in a
    for f, _ in host.suppressed:
        assert f.fingerprint == JFinding(f.code, f.where, f.scope,
                                         "m").fingerprint


def test_fingerprint_excludes_line_numbers():
    f1 = Finding("H104", "host/x.py", "Hub.flush:os.fsync", "m", line=10)
    f2 = Finding("H104", "host/x.py", "Hub.flush:os.fsync", "m", line=99)
    assert f1.fingerprint == f2.fingerprint


def test_kernel_contract_table_is_the_jax_table():
    from summerset_tpu.core.protocol import KERNEL_CONTRACT as JTABLE

    assert [c for c, _, _ in KERNEL_CONTRACT] == [c for c, _, _ in JTABLE]
    assert [s for _, s, _ in KERNEL_CONTRACT] == [s for _, s, _ in JTABLE]
    with pytest.raises(KeyError):
        rule_finding("Z1", "K", "leaf", "undeclared rule code")


# -------------------------------------------------------------- baseline --
def test_baseline_check_matches_committed_lint_json(capsys):
    """``python -m summerset_tpu_torch.graftlint --check --device cpu``
    exits 0 against the committed ``summerset_tpu_torch/LINT.json``."""
    rc = graftlint.main(["--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "baseline matches" in out
