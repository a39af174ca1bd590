"""The port's profiling plane (``summerset_tpu_torch/host/profiling.py``,
``profile_run.py``, ``perf_gate.py``): the logic tests of JAX
``tests/test_profiling.py`` on the port, on the CPU.

- Phase declarations: every kernel's phases resolve and are exactly the
  ``graftphase__`` ranges a profiled step records (both config variants);
  the ranges cost nothing without a profiler and the step is the same
  with them on or off.
- Attribution of profiler events to phases: innermost range wins, nested
  aten calls count once, launches per phase; a real tick attributes ops
  to every declared phase.
- The gate's logic with monkeypatched data: analytic drift, wall
  tolerance with re-measure escalation and recovery, the mesh and tally
  sweeps' checks.
- The committed artifact's structure (a ``cpu`` and a ``cuda`` block,
  the card and its power limit stamped) and the ``cpu`` block's analytic
  cells reproduced here.
- A small live ``mesh_cell``, ``tally_cell`` and ``profile_cell``.
"""

import dataclasses
import json
import os
import types

import pytest
import torch

from summerset_tpu_torch import perf_gate, profile_run
from summerset_tpu_torch.core.protocol import (
    PHASE_SCOPE_PREFIX,
    phase_scope,
    phase_scopes_enabled,
    set_phase_scopes,
)
from summerset_tpu_torch.host import profiling
from summerset_tpu_torch.protocols import make_protocol, protocol_names

ARTIFACT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "summerset_tpu_torch", "PROFILE.json")


def _inputs(kernel):
    """The step() input superset: the base lanes and every declared
    extra input at its shape code."""
    G, R = kernel.G, kernel.R
    out = {
        "n_proposals": torch.full((G,), 2, dtype=torch.int32),
        "value_base": torch.zeros((G,), dtype=torch.int32),
        "exec_floor": torch.zeros((G, R), dtype=torch.int32),
    }
    shapes = {"g": (G,), "gr": (G, R), "grr": (G, R, R), "gp": (G, 2)}
    for name, code in kernel.EXTRA_INPUTS:
        dtype = torch.bool if name == "demote" else torch.int32
        fill = 0 if dtype == torch.bool else -1
        out[name] = torch.full(shapes[code], fill, dtype=dtype)
    return out


def _kernel(name, variant="device"):
    return profiling.build_kernel(make_protocol, name, variant, G=4, R=3,
                                  W=16, device="cpu")


def _recorded_phases(kernel):
    from torch.profiler import ProfilerActivity, profile

    state = kernel.init_state(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kernel.step(state, kernel.zero_outbox(), _inputs(kernel))
    return {e.name[len(PHASE_SCOPE_PREFIX):] for e in prof.events()
            if e.name.startswith(PHASE_SCOPE_PREFIX)}


# ------------------------------------------------------ phase registry ----
@pytest.mark.parametrize("name", protocol_names())
def test_every_kernel_declares_resolvable_phases(name):
    k = _kernel(name)
    assert len(k.PHASES) >= 1
    names = [ph for ph, _ in k.PHASES]
    assert len(set(names)) == len(names), f"{name}: duplicate phase"
    for ph, meth in k.PHASES:
        assert callable(getattr(k, meth, None)), (name, ph, meth)


@pytest.mark.parametrize("name", protocol_names())
def test_declared_phases_appear_as_profiler_ranges(name):
    """A profiled step records exactly the declared phases' ranges (the
    union over the device and host variants)."""
    k = _kernel(name)
    seen = _recorded_phases(k) | _recorded_phases(_kernel(name, "host"))
    assert seen == {ph for ph, _ in k.PHASES}


def test_phase_ranges_only_under_a_profiler():
    """Without a profiler a phase range is a no-op context (a recorded
    range costs ~9 us of host time per phase per tick); under one it is
    a ``record_function``."""
    import contextlib

    assert phase_scopes_enabled()
    assert isinstance(phase_scope("x"), contextlib.nullcontext)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(phase_scope("x"), contextlib.nullcontext)
        set_phase_scopes(False)
        try:
            assert isinstance(phase_scope("x"), contextlib.nullcontext)
        finally:
            set_phase_scopes(True)


def test_step_semantics_identical_with_and_without_scopes():
    k = _kernel("multipaxos")
    state = k.init_state(seed=0)
    inbox, inputs = k.zero_outbox(), _inputs(k)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        s_on, out_on, _ = k.step(state, inbox, inputs)
    set_phase_scopes(False)
    try:
        s_off, out_off, _ = k.step(state, inbox, inputs)
    finally:
        set_phase_scopes(True)
    for key in s_on:
        assert torch.equal(s_on[key], s_off[key]), key
    for key in out_on:
        assert torch.equal(out_on[key], out_off[key]), key


# ------------------------------------------------- event attribution ----
def _ev(name, parent=None):
    return types.SimpleNamespace(name=name, cpu_parent=parent)


def test_event_attribution_innermost_phase_and_nesting():
    outer = _ev(PHASE_SCOPE_PREFIX + "election")
    inner = _ev(PHASE_SCOPE_PREFIX + "quorum_tally", outer)
    where = _ev("aten::where", outer)
    nested = _ev("aten::_s_where", where)
    sort = _ev("aten::sort", inner)
    launch = _ev("cudaLaunchKernel", sort)
    stray = _ev("aten::add")
    got = profiling.attribute_events(
        [outer, inner, where, nested, sort, launch, stray])
    assert got["aten_ops"] == 3
    assert got["aten_ops_by_phase"] == {
        "election": 1, "quorum_tally": 1, "unattributed": 1}
    assert got["kernel_launches"] == 1
    assert got["kernel_launches_by_phase"] == {"quorum_tally": 1}


def test_union_us():
    assert profiling.union_us([]) == 0.0
    assert profiling.union_us([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert profiling.union_us([(5, 6), (0, 10)]) == 10.0


def test_profile_run_without_device_activity(monkeypatch):
    """On the CPU the profiler sees no device events: wall time only,
    the device numbers None (never made up)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    lines = []
    k = _kernel("multipaxos")
    st = k.init_state(0)
    got = profiling.profile_run(
        lambda: k.step(st, k.zero_outbox(), _inputs(k)), 1, "t", "cpu",
        log=lines.append)
    assert got["wall_ms_per_tick"] > 0
    assert got["device_busy_ms_per_tick"] is None
    assert got["kernels_per_tick"] is None
    assert "no device activity" in lines[0]
    assert profiling.capture_phase_walltime(lambda: None, 1, "cpu") is None


def test_real_tick_attributes_every_declared_phase():
    cell = profiling.profile_cell("multipaxos", "device", G=8, R=3, W=16,
                                  with_device_trace=False, with_wall=False,
                                  device="cpu")
    a = cell["analytic"]
    assert a["kernel_launches"] == 0  # the CPU launches no kernel
    for ph in cell["phases"]:
        assert a["aten_ops_by_phase"].get(ph, 0) > 0, ph
    assert a["aten_ops"] == sum(a["aten_ops_by_phase"].values())
    assert a["state_bytes"] > 0 and a["netstate_bytes"] > 0
    assert cell["donation"] is None


# ---------------------------------------------------- the gate's logic ----
def _cell():
    return {
        "protocol": "multipaxos", "variant": "device",
        "shape": {"G": 8, "R": 3, "W": 16, "P": 4},
        "phases": ["ingest_accept"],
        "analytic": {"aten_ops": 10, "aten_ops_by_phase": {
            "ingest_accept": 10}, "kernel_launches": 0},
        "ok": True,
        "wall": {"s_per_tick": 1e-4, "ticks": 16, "reps": 1,
                 "committed_slots_per_s": 100.0},
    }


class TestPerfGateLogic:
    def test_analytic_drift_detected(self, monkeypatch):
        committed = _cell()
        drifted = json.loads(json.dumps(committed))
        drifted["analytic"]["aten_ops"] = 11
        monkeypatch.setattr(perf_gate.profiling, "profile_cell",
                            lambda *a, **k: drifted)
        errors = []
        perf_gate.check_analytic_cell(committed, errors)
        assert len(errors) == 1 and "analytic" in errors[0]

    def test_analytic_match_passes(self, monkeypatch):
        committed = _cell()
        monkeypatch.setattr(perf_gate.profiling, "profile_cell",
                            lambda *a, **k: json.loads(json.dumps(committed)))
        errors = []
        perf_gate.check_analytic_cell(committed, errors)
        assert errors == []

    def test_wall_within_tolerance_passes_first_round(self, monkeypatch):
        calls = []
        monkeypatch.setattr(perf_gate, "wall_measure",
                            lambda c, t, r, d=None: calls.append(1) or 1.2e-4)
        errors, notes = [], []
        perf_gate.check_wall_cell(_cell(), 0.5, 3, errors, notes)
        assert errors == [] and len(calls) == 1

    def test_wall_regression_escalates_then_fails(self, monkeypatch):
        calls = []
        monkeypatch.setattr(perf_gate, "wall_measure",
                            lambda c, t, r, d=None: calls.append(1) or 5e-4)
        errors, notes = [], []
        perf_gate.check_wall_cell(_cell(), 0.5, 3, errors, notes)
        assert len(calls) == 3, "no re-measure escalation"
        assert len(errors) == 1 and "regressed" in errors[0]

    def test_wall_escalation_recovers_on_quieter_round(self, monkeypatch):
        seq = iter([5e-4, 1.1e-4])
        monkeypatch.setattr(perf_gate, "wall_measure",
                            lambda c, t, r, d=None: next(seq))
        errors, notes = [], []
        perf_gate.check_wall_cell(_cell(), 0.5, 3, errors, notes)
        assert errors == [], "best-of escalation must win over noise"

    def test_wall_improvement_notes_not_fails(self, monkeypatch):
        monkeypatch.setattr(perf_gate, "wall_measure",
                            lambda c, t, r, d=None: 0.2e-4)
        errors, notes = [], []
        perf_gate.check_wall_cell(_cell(), 0.5, 3, errors, notes)
        assert errors == [] and notes and "improved" in notes[0]

    def test_committed_dead_cell_fails(self):
        cell = _cell()
        cell["ok"] = False
        cell["wall"]["committed_slots_per_s"] = 0
        errors = []
        perf_gate.check_committed({"protocols": {"MultiPaxos": {
            "device": cell}}}, errors)
        assert any("ok=false" in e for e in errors)
        assert any("no progress" in e for e in errors)

    def test_backend_mismatch_fails(self):
        errors, _ = perf_gate.gate({"backend": "cuda", "protocols": {}},
                                   "cpu", skip_wall=True, skip_overhead=True)
        assert any("backend" in e for e in errors)


def _mesh_doc(points):
    return {"mesh_sweep": {
        "protocol": "multipaxos", "variant": "device",
        "shape": {"G": 8, "R": 4, "W": 8, "ticks": 4},
        "devices": ["cpu"] * 8, "points": points, "skipped": [],
    }}


def _mesh_point(spec="2x1", devices=2, ok=True, placed=True, slots=100):
    gs, rs = (int(x) for x in spec.split("x"))
    return {
        "mesh": spec, "group_shards": gs, "replica_shards": rs,
        "devices": devices, "groups_per_device": 8 // gs,
        "analytic": {"aten_ops": 50, "xfer_bytes_per_tick": 0},
        "donation": None, "placed": placed, "committed_slots": slots,
        "ok": ok,
    }


class TestMeshSweepGate:
    def _run(self, doc, cur_points=None, monkeypatch=None):
        if cur_points is not None:
            monkeypatch.setattr(
                perf_gate.profiling, "mesh_sweep",
                lambda *a, **k: {"points": cur_points, "skipped": []})
        errors = []
        perf_gate.check_mesh_sweep(doc, errors, "cpu")
        return errors

    def test_match_passes(self, monkeypatch):
        pts = [_mesh_point("1x1", 1), _mesh_point("2x1", 2)]
        assert self._run(_mesh_doc(pts), json.loads(json.dumps(pts)),
                         monkeypatch) == []

    def test_no_multi_device_point_fails(self):
        errors = self._run(_mesh_doc([_mesh_point("1x1", 1)]))
        assert len(errors) == 1 and "multi-shard" in errors[0]

    def test_unplaced_committed_point_fails(self):
        errors = self._run(_mesh_doc([_mesh_point("2x1", 2, placed=False)]))
        assert any("off their shard's device" in e for e in errors)

    def test_dead_committed_capture_fails(self):
        errors = self._run(_mesh_doc([_mesh_point("2x1", 2, ok=False,
                                                  slots=0)]))
        assert any("ok=false" in e for e in errors)
        assert any("no progress" in e for e in errors)

    def test_analytic_drift_fails(self, monkeypatch):
        pts = [_mesh_point("2x1", 2)]
        cur = json.loads(json.dumps(pts))
        cur[0]["analytic"]["xfer_bytes_per_tick"] = 8
        errors = self._run(_mesh_doc(pts), cur, monkeypatch)
        assert len(errors) == 1 and "drift in 'analytic'" in errors[0]

    def test_placement_regression_fails(self, monkeypatch):
        pts = [_mesh_point("2x1", 2)]
        cur = json.loads(json.dumps(pts))
        cur[0]["placed"] = cur[0]["ok"] = False
        errors = self._run(_mesh_doc(pts), cur, monkeypatch)
        assert any("off its shard's device" in e for e in errors)

    def test_too_few_devices_fails(self, monkeypatch):
        monkeypatch.setattr(
            perf_gate.profiling, "mesh_sweep",
            lambda *a, **k: {"points": [], "skipped": [
                {"mesh": "4x2", "reason": "needs 8"}]})
        errors = []
        perf_gate.check_mesh_sweep(_mesh_doc([_mesh_point("4x2", 8)]),
                                   errors, "cpu")
        assert len(errors) == 1 and "cannot re-derive" in errors[0]


def _tally_doc(points):
    return {"tally_sweep": {
        "shape": {"G": 8, "R": 4, "W": 8, "ticks": 4},
        "points": points, "skipped": [],
    }}


def _tally_point(tally="pairwise", mesh="2x2", slots=100, ok=True):
    pair = tally == "pairwise"
    return {
        "protocol": "multipaxos", "tally": tally, "mesh": mesh,
        "group_shards": 2, "replica_shards": 2, "devices": 4,
        "groups_per_device": 4,
        "analytic": {"aten_ops": 100 if pair else 90,
                     "tally_phase_ops": 20 if pair else 10,
                     "xfer_bytes_per_tick": 800 if pair else 700,
                     "kernel_launches": 0},
        "aten_ops_by_phase": {"quorum_tally": 20 if pair else 10},
        "tally_lane_shapes": {"ar_f": [1, 8, 4, 4] if pair else [1, 8, 4]},
        "committed_slots": slots, "ok": ok,
    }


class TestTallySweepGate:
    def _run(self, doc, cur_points=None, monkeypatch=None):
        if cur_points is not None:
            monkeypatch.setattr(
                perf_gate.profiling, "tally_sweep",
                lambda *a, **k: {"points": cur_points, "skipped": []})
        errors = []
        perf_gate.check_tally_sweep(doc, errors, "cpu")
        return errors

    def _pair(self):
        return [_tally_point("pairwise"), _tally_point("collective")]

    def test_match_passes(self, monkeypatch):
        pts = self._pair()
        assert self._run(_tally_doc(pts), json.loads(json.dumps(pts)),
                         monkeypatch) == []

    def test_missing_sweep_fails(self):
        errors = []
        perf_gate.check_tally_sweep({}, errors, "cpu")
        assert len(errors) == 1 and "missing" in errors[0]

    def test_missing_mode_fails(self):
        errors = self._run(_tally_doc([_tally_point()]))
        assert any("missing a tally mode" in e for e in errors)

    def test_unreduced_collective_fails(self):
        pts = self._pair()
        pts[1]["analytic"] = dict(pts[0]["analytic"])
        errors = self._run(_tally_doc(pts))
        assert sum("not strictly below" in e for e in errors) == 3

    def test_progress_divergence_fails(self):
        pts = self._pair()
        pts[1]["committed_slots"] = 99
        errors = self._run(_tally_doc(pts))
        assert any("semantically identical" in e for e in errors)

    def test_pairwise_shaped_collective_lane_fails(self):
        pts = self._pair()
        pts[1]["tally_lane_shapes"]["ar_f"] = [1, 8, 4, 4]
        errors = self._run(_tally_doc(pts))
        assert any("pairwise-shaped" in e for e in errors)

    def test_dead_committed_point_fails(self):
        pts = self._pair()
        pts[1]["committed_slots"] = 0
        pts[1]["ok"] = False
        errors = self._run(_tally_doc(pts))
        assert any("no progress" in e for e in errors)

    def test_rederive_drift_fails(self, monkeypatch):
        pts = self._pair()
        cur = json.loads(json.dumps(pts))
        cur[1]["analytic"]["tally_phase_ops"] = 11
        errors = self._run(_tally_doc(pts), cur, monkeypatch)
        assert any("drift in 'analytic'" in e for e in errors)


# ------------------------------------------------ the committed artifact --
@pytest.fixture(scope="module")
def artifact():
    with open(ARTIFACT) as f:
        return json.load(f)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_committed_artifact_structure(artifact, backend):
    assert artifact["generated_by"] == \
        "python -m summerset_tpu_torch.profile_run"
    doc = artifact["backends"][backend]
    assert doc["backend"] == backend
    assert doc["torch_version"] and doc["shape"]["G"] == 64
    if backend == "cuda":
        # the card and its power limit (nvidia-smi's name, power.limit)
        assert "H100" in doc["card"] and doc["card"].endswith(" W")
        assert doc["cuda_version"]
    assert set(doc["protocols"]) == {"MultiPaxos", "Raft", "RSPaxos"}
    for proto, per in doc["protocols"].items():
        assert set(per) == {"device", "host"}, proto
        for variant, cell in per.items():
            where = f"{proto}[{variant}]"
            assert cell["ok"] and cell["donation"] is None, where
            a = cell["analytic"]
            assert a["aten_ops"] == sum(a["aten_ops_by_phase"].values())
            assert (a["kernel_launches"] > 0) == (backend == "cuda"), where
            assert cell["wall"]["committed_slots_per_s"] > 0, where
            if backend == "cuda":
                pw = cell["phase_wall_us_per_tick"]
                assert pw and all(v >= 0 for v in pw.values()), where
                assert 0 <= cell["device"]["idle_share"] < 1, where
                assert cell["memory"]["peak_device_bytes"] > 0, where
    assert doc["donation"] is None and "donation" in doc["donation_note"]
    ms = doc["mesh_sweep"]
    assert [p["mesh"] for p in ms["points"]] == list(profiling.MESH_SWEEP)
    for p in ms["points"]:
        assert p["ok"] and p["placed"] and p["committed_slots"] > 0
        assert (p["analytic"]["xfer_bytes_per_tick"] > 0) == \
            (p["replica_shards"] > 1), p["mesh"]
    errors = []
    perf_gate.check_tally_pairs(doc["tally_sweep"]["points"], errors)
    assert errors == []


def test_committed_cpu_block_reproduces(artifact):
    """The cpu block's analytic cells re-derived here equal the
    committed ones (the gate's strict half, at the committed shape)."""
    doc = artifact["backends"]["cpu"]
    for per in doc["protocols"].values():
        for cell in per.values():
            errors = []
            perf_gate.check_analytic_cell(cell, errors, "cpu")
            assert errors == [], errors


def test_profile_run_merge_keeps_the_other_block(tmp_path, artifact):
    path = tmp_path / "P.json"
    path.write_text(json.dumps(artifact))
    block = dict(artifact["backends"]["cpu"], torch_version="x")
    got = profile_run.merge(str(path), block)
    assert got["backends"]["cpu"]["torch_version"] == "x"
    assert got["backends"]["cuda"] == artifact["backends"]["cuda"]
    md = profiling.phase_table_markdown(artifact["backends"]["cuda"])
    assert "| MultiPaxos (device) |" in md


# --------------------------------------------------------- live cells ----
def test_mesh_cell_live_small():
    cell = profiling.mesh_cell("multipaxos", "2x2", G=8, R=4, W=8, ticks=8,
                               device="cpu")
    assert cell["devices"] == 4 and cell["groups_per_device"] == 4
    assert cell["placed"] and cell["ok"] and cell["committed_slots"] > 0
    assert cell["analytic"]["aten_ops"] > 0
    assert cell["analytic"]["xfer_bytes_per_tick"] > 0
    assert cell["donation"] is None


def test_tally_cell_live_small():
    pw = profiling.tally_cell("multipaxos", "pairwise", "2x2", G=8, R=4,
                              W=8, ticks=8, device="cpu")
    co = profiling.tally_cell("multipaxos", "collective", "2x2", G=8, R=4,
                              W=8, ticks=8, device="cpu")
    errors = []
    perf_gate.check_tally_pairs([pw, co], errors)
    assert errors == []
    assert all(len(s) == 3 for s in co["tally_lane_shapes"].values())


def test_profile_cell_end_to_end():
    cell = profiling.profile_cell("multipaxos", "device", G=8, R=3, W=16,
                                  ticks=8, reps=1, device="cpu")
    assert cell["ok"] and cell["wall"]["committed_slots_per_s"] > 0
    assert cell["phase_wall_us_per_tick"] is None  # no device here
    assert cell["memory"]["peak_device_bytes"] is None


def test_build_kernel_variants():
    k = profiling.build_kernel(make_protocol, "multipaxos", "host", G=4,
                               R=3, W=16, device="cpu")
    assert k.config.exec_follows_commit is False
    assert k.config.leader_leases is True
    c = profiling.build_kernel(make_protocol, "crossword", "collective",
                               G=4, R=3, W=16, device="cpu")
    assert c.config.tally == "collective"
    assert dataclasses.is_dataclass(c.config)
