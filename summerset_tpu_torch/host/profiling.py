"""The profiling plane of the port, counterpart of
``summerset_tpu/host/profiling.py``: machine-produced numbers for the
device plane, committed as ``summerset_tpu_torch/PROFILE.json`` and gated
by ``python -m summerset_tpu_torch.perf_gate``.

The JAX module reads XLA's artifacts (``cost_analysis``, HLO op counts,
``memory_analysis``, donation aliases).  A torch step has no compiled
module, so their places are taken by what ``torch.profiler`` and the
tensors themselves say about one tick:

- **Analytic counts** (deterministic per backend, gated strictly): the
  aten ops a tick issues, in all and per declared phase (an op belongs to
  the innermost ``graftphase__`` range around it; nested aten calls count
  once, at the outermost), the CUDA kernel launches in all and per phase
  (0 on the CPU), the bytes of the state, the outbox and the netstate,
  and on a mesh the bytes that cross between shards per tick.  The tick
  counted is the one after ``WARM_TICKS`` ticks of synthetic load.
- **Measured numbers** (gated with a tolerance): best-of-N seconds per
  tick of ``run_synthetic`` and the committed-slot rate, device time per
  phase, device busy time, the idle share and launches per tick under
  ``torch.profiler`` (:func:`profile_run`), peak device memory.
- **Donation**: JAX donates the scan carry; a torch step never updates a
  tensor in place, so there is nothing to alias.  Where JAX records
  donation facts the port records ``null`` with :data:`DONATION_NOTE`,
  and the gate checks instead that every shard's leaves sit on its
  shard's device.

All timing uses ``time.perf_counter``.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import Engine
from ..core import sharding as shardlib
from ..core.protocol import (
    PHASE_SCOPE_PREFIX,
    phase_scopes_enabled,
    set_phase_scopes,
)
from ..core.quorum import PHASE_TALLY, TALLY_MODES
from ..device import resolve_device

PROFILE_VERSION = 1

#: the canonical capture set: MultiPaxos, Raft and the RS-coded
#: MultiPaxos variant, each at both config variants (device defaults /
#: host-serving knobs)
CANONICAL_PROTOCOLS = ("multipaxos", "raft", "rspaxos")
CANONICAL_VARIANTS = ("device", "host")
CANONICAL_SHAPE: Dict[str, int] = {"G": 64, "R": 3, "W": 16}
CANONICAL_TICKS = 128
CANONICAL_REPS = 3
G_SWEEP = (16, 64, 256)

#: the mesh axis at a fixed global shape; R=4 so 2x2 splits the replica
#: axis (in-group delivery crosses shards)
MESH_SWEEP = ("1x1", "2x1", "4x1", "2x2")
MESH_SWEEP_SHAPE: Dict[str, int] = {"G": 64, "R": 4, "W": 16}
MESH_SWEEP_TICKS = 32

#: the quorum-tally plane's before/after axis (core/quorum.py)
TALLY_SWEEP_PROTOCOLS = ("multipaxos", "crossword")
TALLY_SWEEP_MESHES = ("1x1", "2x2")

#: ticks of synthetic load before the tick the analytic counts read
WARM_TICKS = 8
#: handles of the capture device the mesh sweeps place shards on (the
#: counterpart of the JAX package's 8 virtual CPU devices)
MESH_DEVICES = 8

DONATION_NOTE = (
    "torch has no buffer donation: a step returns new tensors and never "
    "updates one in place, so no carry buffer is aliased; the gate checks "
    "shard placement instead"
)

Log = Callable[[str], None]


# ------------------------------------------------------------------ cells --
def build_kernel(make_protocol, name: str, variant: str = "device",
                 G: int = CANONICAL_SHAPE["G"], R: int = CANONICAL_SHAPE["R"],
                 W: int = CANONICAL_SHAPE["W"], device=None):
    """A kernel at profile geometry with the variant rules of the JAX
    package's ``analysis/contract.build_kernel``: ``host`` flips
    ``exec_follows_commit`` off and leader leases on, ``collective`` the
    quorum-tally transport; proposals are capped at ``W // 2``."""
    probe = make_protocol(name, G, R, 64, device=device)
    cfg = getattr(probe, "config", None)
    if not dataclasses.is_dataclass(cfg):
        return make_protocol(name, G, R, W, device=device)
    overrides: Dict[str, Any] = {}
    if hasattr(cfg, "max_proposals_per_tick"):
        overrides["max_proposals_per_tick"] = min(
            cfg.max_proposals_per_tick, W // 2)
    if variant == "collective" and hasattr(cfg, "tally"):
        overrides["tally"] = "collective"
    if variant == "host":
        if hasattr(cfg, "exec_follows_commit"):
            overrides["exec_follows_commit"] = False
        if hasattr(cfg, "leader_leases"):
            try:
                return make_protocol(
                    name, G, R, W,
                    dataclasses.replace(cfg, leader_leases=True,
                                        **overrides),
                    device=device)
            except ValueError:
                pass
    return make_protocol(name, G, R, W, dataclasses.replace(cfg, **overrides),
                         device=device)


def _cell_kernel(name, variant, G, R, W, device):
    from ..protocols import make_protocol

    return build_kernel(make_protocol, name, variant, G, R, W, device)


def _proposals(kernel) -> int:
    return min(4, getattr(kernel.config, "max_proposals_per_tick", 4))


def synth_inputs(kernel, proposals: int, t: int = 0) -> Dict[str, Any]:
    """One tick of ``run_synthetic``'s inputs."""
    G, R, dev = kernel.G, kernel.R, kernel.device
    return {
        "n_proposals": torch.full((G,), proposals, dtype=torch.int32,
                                  device=dev),
        "value_base": torch.full((G,), t * proposals, dtype=torch.int32,
                                 device=dev),
        "exec_floor": torch.full((G, R), 1 << 30, dtype=torch.int32,
                                 device=dev),
    }


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _committed(state) -> int:
    return int(state["commit_bar"].amax(dim=1).sum())


# ------------------------------------------------------ profiler readings --
def union_us(intervals) -> float:
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


def _activities(dev):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name


def attribute_events(events) -> Dict[str, Any]:
    """Aten ops and kernel launches of host events, in all and per phase:
    an event belongs to its innermost ``graftphase__`` ancestor (none:
    ``unattributed``); an aten op under another aten op is not counted
    again."""
    ops: Dict[str, int] = {}
    launches: Dict[str, int] = {}
    n_ops = n_launch = 0
    for e in events:
        name = e.name
        op = name.startswith("aten::")
        launch = _is_launch(name)
        if not (op or launch):
            continue
        phase, nested = None, False
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                nested = True
            elif phase is None and p.name.startswith(PHASE_SCOPE_PREFIX):
                phase = p.name[len(PHASE_SCOPE_PREFIX):]
            p = p.cpu_parent
        key = phase or "unattributed"
        if op and not nested:
            n_ops += 1
            ops[key] = ops.get(key, 0) + 1
        if launch:
            n_launch += 1
            launches[key] = launches.get(key, 0) + 1
    return {
        "aten_ops": n_ops,
        "aten_ops_by_phase": dict(sorted(ops.items())),
        "kernel_launches": n_launch,
        "kernel_launches_by_phase": dict(sorted(launches.items())),
    }


def count_tick(run: Callable[[], Any], dev) -> Dict[str, Any]:
    """:func:`attribute_events` over one call of ``run`` (one tick)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    _sync(dev)
    with profile(activities=_activities(dev)) as prof:
        run()
        _sync(dev)
    return attribute_events(
        [e for e in prof.events() if e.device_type == DeviceType.CPU])


def profile_run(run: Callable[[], Any], ticks: int, what: str, card: str,
                log: Log = print) -> Dict[str, Any]:
    """Where a tick's time goes: ``run()`` (``ticks`` ticks) timed on the
    host clock without the profiler, then once more under
    ``torch.profiler`` for the device busy time (the union of kernel
    intervals), kernel launches per tick, device time per phase and the
    host's CUDA runtime calls.  The idle share is one less busy time over
    the unprofiled wall time.  Returns the per-tick numbers (None where
    the profiler saw no device activity) and logs them with ``log``."""
    from torch.autograd import DeviceType
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
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
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
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
    log(f"profile {what}: {ticks} ticks, wall {wall_us / ticks / 1e3:.3f} "
        f"ms/tick, device busy {busy_us / ticks / 1e3:.3f} ms/tick, idle "
        f"share {1 - busy_us / wall_us:.3f}, {len(kernels) / ticks:.1f} "
        f"kernel launches/tick | {card}")
    # the host-side phase ranges: device time of the kernels each launched
    phases = sorted(
        ((e.key[len(PHASE_SCOPE_PREFIX):], e.device_time_total,
          e.cpu_time_total)
         for e in prof.key_averages()
         if e.key.startswith(PHASE_SCOPE_PREFIX) and e.device_type == cpu),
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
                    sum(us for _k, _n, us in api) / ticks / 1e3, 4),
                phase_device_us_per_tick={
                    name: round(dev_us / ticks, 3)
                    for name, dev_us, _ in phases})


def capture_phase_walltime(run_fn: Callable[[], Any], ticks: int, dev
                           ) -> Optional[Dict[str, Any]]:
    """Measured device time per phase in us/tick, with the device busy
    time, idle share and launches per tick: ``run_fn`` (``ticks`` ticks)
    through :func:`profile_run`.  ``None`` on a backend whose profiler
    sees no device activity (the CPU); callers record that."""
    if torch.device(dev).type != "cuda":
        return None
    got = profile_run(run_fn, ticks, "cell", "", log=lambda m: None)
    if got.get("device_busy_ms_per_tick") is None:
        return None
    return got


# ----------------------------------------------------------- the cells ----
def _warm(eng, state, ns, proposals):
    return eng.run_synthetic(state, ns, WARM_TICKS, proposals)


def _tick_counts(eng, state, ns, proposals) -> Dict[str, Any]:
    """The analytic counts of the tick after the warm-up (which the
    caller ran): one tick at synthetic tick ``WARM_TICKS``."""
    inputs = synth_inputs(eng.kernel, proposals, WARM_TICKS)
    before = eng.xfer["bytes"]
    got = count_tick(lambda: eng.tick(state, ns, inputs), eng.device)
    got["xfer_bytes_per_tick"] = eng.xfer["bytes"] - before
    return got


def _bytes_block(eng, state, ns) -> Dict[str, int]:
    return {
        "state_bytes": shardlib.tree_bytes(state),
        "outbox_bytes": shardlib.tree_bytes(eng.kernel.zero_outbox()),
        "netstate_bytes": shardlib.tree_bytes(ns),
    }


def _peak_bytes(dev) -> Optional[int]:
    if torch.device(dev).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated())


def _reset_peak(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def measure_steady_tick(eng, state, ns, ticks: int, proposals: int,
                        reps: int = CANONICAL_REPS):
    """Best-of-N steady-state seconds per tick of ``run_synthetic`` over
    ``ticks``-tick windows, the committed-slot rate over the best window
    and the final ``(state, ns)``.  Two untimed windows of the same
    length come first."""
    dev = eng.device
    for _ in range(2):
        state, ns = eng.run_synthetic(state, ns, ticks, proposals)
    _sync(dev)
    best, best_rate = float("inf"), 0.0
    for _ in range(reps):
        start = _committed(state)
        t0 = time.perf_counter()
        state, ns = eng.run_synthetic(state, ns, ticks, proposals)
        _sync(dev)
        dt = time.perf_counter() - t0
        if dt < best:
            best = dt
            best_rate = float(_committed(state) - start) / dt
    return best / ticks, best_rate, state, ns


def profile_cell(
    name: str,
    variant: str = "device",
    G: int = CANONICAL_SHAPE["G"],
    R: int = CANONICAL_SHAPE["R"],
    W: int = CANONICAL_SHAPE["W"],
    ticks: int = CANONICAL_TICKS,
    reps: int = CANONICAL_REPS,
    with_device_trace: bool = True,
    with_wall: bool = True,
    device=None,
) -> Dict[str, Any]:
    """One protocol x variant profile cell, the PROFILE.json unit."""
    dev = resolve_device(device)
    kernel = _cell_kernel(name, variant, G, R, W, dev)
    P = _proposals(kernel)
    eng = Engine(kernel, device=dev)
    _reset_peak(dev)
    state, ns = eng.init()
    state, ns = _warm(eng, state, ns, P)
    cell: Dict[str, Any] = {
        "protocol": name,
        "variant": variant,
        "shape": {"G": G, "R": R, "W": W, "P": P},
        "phases": [ph for ph, _ in kernel.PHASES],
        "analytic": dict(_tick_counts(eng, state, ns, P),
                         **_bytes_block(eng, state, ns)),
        "donation": None,
        "ok": True,
    }
    if not with_wall:
        return cell
    s_per_tick, rate, state, ns = measure_steady_tick(eng, state, ns, ticks,
                                                      P, reps)
    cell["wall"] = {
        "s_per_tick": round(s_per_tick, 9),
        "ticks": ticks,
        "reps": reps,
        "committed_slots_per_s": round(rate, 1),
    }
    cell["ok"] = rate > 0
    if with_device_trace:
        box = [state, ns]

        def run_once():
            box[0], box[1] = eng.run_synthetic(box[0], box[1], ticks, P)

        got = capture_phase_walltime(run_once, ticks, dev)
        cell["phase_wall_us_per_tick"] = (
            None if got is None else got["phase_device_us_per_tick"])
        cell["device"] = None if got is None else {
            k: got[k] for k in ("wall_ms_per_tick", "device_busy_ms_per_tick",
                                "idle_share", "kernels_per_tick",
                                "runtime_ms_per_tick")}
    cell["memory"] = {"peak_device_bytes": _peak_bytes(dev)}
    return cell


def measure_scope_overhead(
    name: str = "multipaxos",
    G: int = CANONICAL_SHAPE["G"],
    R: int = CANONICAL_SHAPE["R"],
    W: int = CANONICAL_SHAPE["W"],
    ticks: int = CANONICAL_TICKS,
    pairs: int = 2,
    max_pairs: int = 4,
    max_pct: float = 5.0,
    device=None,
) -> Dict[str, Any]:
    """The instrumentation ablation: steady tick cost with the phase
    ranges on against off (``set_phase_scopes``), as interleaved pairs
    compared best of side; escalates (more pairs) while the apparent
    overhead exceeds ``max_pct``."""
    dev = resolve_device(device)
    prior = phase_scopes_enabled()
    sides: Dict[bool, list] = {}
    for enabled in (True, False):
        kernel = _cell_kernel(name, "device", G, R, W, dev)
        eng = Engine(kernel, device=dev)
        sides[enabled] = [eng, *eng.init()]
    P = _proposals(sides[True][0].kernel)
    results = {True: float("inf"), False: float("inf")}
    i = 0
    try:
        while True:
            i += 1
            for enabled in (True, False):
                set_phase_scopes(enabled)
                eng, state, ns = sides[enabled]
                s_per_tick, _, state, ns = measure_steady_tick(
                    eng, state, ns, ticks, P, reps=2)
                sides[enabled] = [eng, state, ns]
                results[enabled] = min(results[enabled], s_per_tick)
            pct = ((results[True] - results[False]) / results[False] * 100.0
                   if results[False] > 0 else 0.0)
            if i >= pairs and (pct <= max_pct or i >= max_pairs):
                break
    finally:
        set_phase_scopes(prior)
    return {
        "pct": round(pct, 2),
        "scopes_on_s_per_tick": round(results[True], 9),
        "scopes_off_s_per_tick": round(results[False], 9),
        "pairs": i,
    }


def default_mesh_devices(device, n: int = MESH_DEVICES) -> List[str]:
    """The sweeps' device list: ``n`` handles of the capture device (on
    one card or the CPU, every shard shares it)."""
    return [str(resolve_device(device))] * n


def _mesh(spec: str, devices: Sequence):
    gs, rs = shardlib.parse_mesh(spec)
    return gs, rs, shardlib.mesh_for(gs, rs, devices, repeat=True)


def placement_ok(mesh, *trees) -> bool:
    """Every leaf of every shard sits on its shard's device."""
    want = [str(d) for _i, _j, d in mesh.cells()]
    return all(
        got == {w}
        for tree in trees for got, w in zip(tree.devices(), want)
    )


def mesh_cell(
    name: str,
    spec: str,
    G: int = MESH_SWEEP_SHAPE["G"],
    R: int = MESH_SWEEP_SHAPE["R"],
    W: int = MESH_SWEEP_SHAPE["W"],
    ticks: int = MESH_SWEEP_TICKS,
    run_check: bool = True,
    devices: Optional[Sequence] = None,
    device=None,
) -> Dict[str, Any]:
    """One mesh-shape point: the sharded engine's analytic tick counts,
    the bytes that cross between shards per tick and per-shard state
    bytes, the placement check (every shard's leaves on its device) and
    a progress check (``committed_slots`` > 0 after two windows)."""
    dev = resolve_device(device)
    devices = devices or default_mesh_devices(dev)
    gs, rs, mesh = _mesh(spec, devices)
    kernel = _cell_kernel(name, "device", G, R, W, dev)
    P = _proposals(kernel)
    eng = Engine(kernel, device=dev, mesh=mesh)
    state, ns = eng.init()
    state, ns = _warm(eng, state, ns, P)
    counts = _tick_counts(eng, state, ns, P)
    placed = placement_ok(mesh, state, ns)
    cell: Dict[str, Any] = {
        **shardlib.mesh_stamp(gs, rs, G),
        "analytic": dict(
            counts,
            state_bytes_per_shard=shardlib.tree_bytes(state.shards[0]),
            netstate_bytes_per_shard=shardlib.tree_bytes(ns.shards[0]),
        ),
        "donation": None,
        "donation_note": DONATION_NOTE,
        "placed": placed,
    }
    if run_check:
        for _ in range(2):
            state, ns = eng.run_synthetic(state, ns, ticks, P)
        _sync(dev)
        cell["committed_slots"] = _committed(state)
        cell["placed"] = placed = placed and placement_ok(mesh, state, ns)
        cell["ok"] = placed and cell["committed_slots"] > 0
    else:
        cell["ok"] = placed
    return cell


def mesh_sweep(
    name: str = "multipaxos",
    meshes: Tuple[str, ...] = MESH_SWEEP,
    G: int = MESH_SWEEP_SHAPE["G"],
    R: int = MESH_SWEEP_SHAPE["R"],
    W: int = MESH_SWEEP_SHAPE["W"],
    ticks: int = MESH_SWEEP_TICKS,
    run_check: bool = True,
    devices: Optional[Sequence] = None,
    device=None,
    log: Log = lambda m: None,
) -> Dict[str, Any]:
    """One :func:`mesh_cell` per mesh spec at a fixed global shape.
    Shapes the device list cannot fit are recorded under ``skipped``,
    never dropped."""
    dev = resolve_device(device)
    devices = list(devices or default_mesh_devices(dev))
    points, skipped = [], []
    for spec in meshes:
        gs, rs = shardlib.parse_mesh(spec)
        if gs * rs > len(devices):
            skipped.append({"mesh": spec, "reason": f"needs {gs * rs} "
                            f"devices, {len(devices)} listed"})
            continue
        log(f"mesh sweep {name} @ {spec} ...")
        points.append(mesh_cell(name, spec, G=G, R=R, W=W, ticks=ticks,
                                run_check=run_check, devices=devices,
                                device=dev))
    return {
        "protocol": name,
        "variant": "device",
        "shape": {"G": G, "R": R, "W": W, "ticks": ticks},
        "devices": [str(d) for d in devices],
        "points": points,
        "skipped": skipped,
    }


def tally_cell(
    name: str,
    tally: str,
    spec: str,
    G: int = MESH_SWEEP_SHAPE["G"],
    R: int = MESH_SWEEP_SHAPE["R"],
    W: int = MESH_SWEEP_SHAPE["W"],
    ticks: int = MESH_SWEEP_TICKS,
    with_device_trace: bool = False,
    devices: Optional[Sequence] = None,
    device=None,
) -> Dict[str, Any]:
    """One (protocol, tally mode, mesh shape) point of the quorum-tally
    before/after: the tick's counts with the tally phase's ops, the
    delay line's tally lane shapes (pairwise ``[D, G, R, R]``, collective
    ``[D, G, R]``) and ``committed_slots`` (equal across the modes at a
    point)."""
    dev = resolve_device(device)
    devices = devices or default_mesh_devices(dev)
    gs, rs = shardlib.parse_mesh(spec)
    variant = "collective" if tally == "collective" else "device"
    kernel = _cell_kernel(name, variant, G, R, W, dev)
    P = _proposals(kernel)
    mesh = None
    if gs * rs > 1:
        mesh = _mesh(spec, devices)[2]
    eng = Engine(kernel, device=dev, mesh=mesh)
    state, ns = eng.init()
    bufs = shardlib.gather_netstate(ns)["bufs"]
    lane_shapes = {lane: list(bufs[lane].shape)
                   for lane in kernel.TALLY_LANES if lane in bufs}
    state, ns = _warm(eng, state, ns, P)
    counts = _tick_counts(eng, state, ns, P)
    cell: Dict[str, Any] = {
        "protocol": name,
        "tally": tally,
        **shardlib.mesh_stamp(gs, rs, G),
        "analytic": dict(
            {k: counts[k] for k in ("aten_ops", "kernel_launches",
                                    "xfer_bytes_per_tick")},
            tally_phase_ops=counts["aten_ops_by_phase"].get(PHASE_TALLY, 0),
        ),
        "aten_ops_by_phase": counts["aten_ops_by_phase"],
        "tally_lane_shapes": lane_shapes,
    }
    for _ in range(2):
        state, ns = eng.run_synthetic(state, ns, ticks, P)
    _sync(dev)
    cell["committed_slots"] = _committed(state)
    cell["ok"] = cell["committed_slots"] > 0
    if with_device_trace:
        box = [state, ns]

        def run_once():
            box[0], box[1] = eng.run_synthetic(box[0], box[1], ticks, P)

        got = capture_phase_walltime(run_once, ticks, dev)
        pw = None if got is None else got["phase_device_us_per_tick"]
        cell["phase_wall_us_per_tick"] = pw
        if pw:
            cell["tally_phase_wall_us"] = pw.get(PHASE_TALLY, 0.0)
    return cell


def tally_sweep(
    protocols: Tuple[str, ...] = TALLY_SWEEP_PROTOCOLS,
    meshes: Tuple[str, ...] = TALLY_SWEEP_MESHES,
    G: int = MESH_SWEEP_SHAPE["G"],
    R: int = MESH_SWEEP_SHAPE["R"],
    W: int = MESH_SWEEP_SHAPE["W"],
    ticks: int = MESH_SWEEP_TICKS,
    with_device_trace: bool = True,
    devices: Optional[Sequence] = None,
    device=None,
    log: Log = lambda m: None,
) -> Dict[str, Any]:
    """Every (protocol, mesh, tally mode) cell at the mesh-sweep shape;
    device time is captured on the one-shard points only.  Shapes the
    device list cannot fit are recorded under ``skipped``."""
    dev = resolve_device(device)
    devices = list(devices or default_mesh_devices(dev))
    points, skipped = [], []
    for name in protocols:
        for spec in meshes:
            gs, rs = shardlib.parse_mesh(spec)
            if gs * rs > len(devices):
                skipped.append({
                    "protocol": name, "mesh": spec,
                    "reason": f"needs {gs * rs} devices, {len(devices)} "
                              "listed",
                })
                continue
            for tally in TALLY_MODES:
                log(f"tally sweep {name} @ {spec} [{tally}] ...")
                points.append(tally_cell(
                    name, tally, spec, G=G, R=R, W=W, ticks=ticks,
                    with_device_trace=with_device_trace and gs * rs == 1,
                    devices=devices, device=dev,
                ))
    return {
        "shape": {"G": G, "R": R, "W": W, "ticks": ticks},
        "points": points,
        "skipped": skipped,
    }


def g_sweep(
    name: str = "multipaxos",
    groups: Tuple[int, ...] = G_SWEEP,
    R: int = CANONICAL_SHAPE["R"],
    W: int = CANONICAL_SHAPE["W"],
    device=None,
) -> Dict[str, Any]:
    """Analytic-only sweep over the group axis: how the tick's op and
    launch counts and the state's bytes scale with G (the counts stay
    flat: a tick's work is batched over the groups)."""
    points = []
    for G in groups:
        cell = profile_cell(name, "device", G=G, R=R, W=W,
                            with_device_trace=False, with_wall=False,
                            device=device)
        a = cell["analytic"]
        points.append({
            "G": G,
            "aten_ops": a["aten_ops"],
            "kernel_launches": a["kernel_launches"],
            "state_bytes": a["state_bytes"],
            "netstate_bytes": a["netstate_bytes"],
        })
    return {"protocol": name, "variant": "device", "points": points}


def card_stamp() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0].strip()


def build_profile(
    protocols: Tuple[str, ...] = CANONICAL_PROTOCOLS,
    variants: Tuple[str, ...] = CANONICAL_VARIANTS,
    G: int = CANONICAL_SHAPE["G"],
    R: int = CANONICAL_SHAPE["R"],
    W: int = CANONICAL_SHAPE["W"],
    ticks: int = CANONICAL_TICKS,
    reps: int = CANONICAL_REPS,
    with_overhead: bool = True,
    with_sweep: bool = True,
    with_mesh_sweep: bool = True,
    with_tally_sweep: bool = True,
    tally_trace: bool = True,
    sweep_ticks: int = MESH_SWEEP_TICKS,
    mesh_shapes: Optional[Tuple[str, ...]] = None,
    mesh_devices: Optional[Sequence] = None,
    device=None,
    log: Log = print,
) -> Dict[str, Any]:
    """One backend's block of PROFILE.json (``profile_run.py``).
    ``tally_trace`` False skips the tally points' measured device time
    (a profiled window costs seconds of trace processing a point);
    ``sweep_ticks`` sets the sweeps' progress windows (their analytic
    counts do not depend on it)."""
    from ..protocols import protocol_display_name

    dev = resolve_device(device)
    devices = list(mesh_devices or default_mesh_devices(dev))
    cuda = dev.type == "cuda"
    doc: Dict[str, Any] = {
        "version": PROFILE_VERSION,
        "generated_by": "python -m summerset_tpu_torch.profile_run",
        "backend": dev.type,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "card": card_stamp() if cuda else None,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "shape": {"G": G, "R": R, "W": W, "ticks": ticks, "reps": reps,
                  "warm_ticks": WARM_TICKS},
        "donation": None,
        "donation_note": DONATION_NOTE,
        "protocols": {},
    }
    t0 = time.perf_counter()
    for name in protocols:
        disp = protocol_display_name(name)
        doc["protocols"][disp] = {}
        for variant in variants:
            log(f"profiling {disp} [{variant}] ... "
                f"({time.perf_counter() - t0:.1f} s in)")
            doc["protocols"][disp][variant] = profile_cell(
                name, variant, G=G, R=R, W=W, ticks=ticks, reps=reps,
                device=dev)
    if with_sweep:
        log("g-sweep (analytic) ...")
        doc["g_sweep"] = g_sweep(protocols[0], R=R, W=W, device=dev)
    if with_mesh_sweep:
        log("mesh sweep (analytic + placement) ...")
        doc["mesh_sweep"] = mesh_sweep(
            protocols[0], meshes=mesh_shapes or MESH_SWEEP, ticks=sweep_ticks,
            devices=devices, device=dev, log=log)
    if with_tally_sweep:
        log("quorum-tally sweep (pairwise vs collective) ...")
        doc["tally_sweep"] = tally_sweep(ticks=sweep_ticks,
                                         with_device_trace=tally_trace,
                                         devices=devices, device=dev,
                                         log=log)
    if with_overhead:
        log("phase-range overhead ablation A/B ...")
        doc["scope_overhead"] = measure_scope_overhead(
            protocols[0], G=G, R=R, W=W, ticks=ticks, device=dev)
    doc["profiler_available"] = any(
        cell.get("phase_wall_us_per_tick") is not None
        for per in doc["protocols"].values() for cell in per.values()
    )
    return doc


def analytic_view(doc: Dict[str, Any]) -> Dict[str, Any]:
    """The deterministic part of one backend's block: every cell's
    ``analytic`` counts, the g-sweep, and each mesh and tally point's
    counts and lane shapes.  The perf gate compares it strictly, and the
    chip check holds the card's against the committed ``cuda`` block."""
    out: Dict[str, Any] = {"protocols": {}}
    for proto, per in sorted(doc.get("protocols", {}).items()):
        out["protocols"][proto] = {
            v: cell["analytic"] for v, cell in sorted(per.items())}
    if "g_sweep" in doc:
        out["g_sweep"] = doc["g_sweep"]["points"]
    if "mesh_sweep" in doc:
        out["mesh_sweep"] = {p["mesh"]: p["analytic"]
                             for p in doc["mesh_sweep"]["points"]}
    if "tally_sweep" in doc:
        out["tally_sweep"] = {
            f"{p['protocol']}@{p['mesh']}[{p['tally']}]": dict(
                p["analytic"], tally_lane_shapes=p["tally_lane_shapes"])
            for p in doc["tally_sweep"]["points"]}
    return out


def phase_table_markdown(doc: Dict[str, Any]) -> str:
    """PERF.md's breakdown table from one backend's block."""
    card = doc.get("card") or doc.get("backend", "?")
    lines = [
        f"Backend `{doc.get('backend')}` ({card}), torch "
        f"{doc.get('torch_version')}, G={doc['shape']['G']} "
        f"R={doc['shape']['R']} W={doc['shape']['W']}.",
        "",
        "| Protocol (variant) | ms/tick | device busy ms/tick | idle share "
        "| top phases by device time (us/tick) | aten ops/tick | launches/"
        "tick |",
        "|---|---|---|---|---|---|---|",
    ]
    for proto, per in sorted(doc.get("protocols", {}).items()):
        for variant, cell in sorted(per.items()):
            wall = cell.get("wall") or {}
            ms = (wall.get("s_per_tick") or 0.0) * 1e3
            dv = cell.get("device") or {}
            pw = cell.get("phase_wall_us_per_tick") or {}
            top = sorted(((k, v) for k, v in pw.items()),
                         key=lambda kv: -kv[1])[:3]
            tops = ", ".join(f"{k} {v:.0f}" for k, v in top) or "n/a"
            busy = dv.get("device_busy_ms_per_tick")
            idle = dv.get("idle_share")
            a = cell["analytic"]
            lines.append(
                f"| {proto} ({variant}) | {ms:.3f} | "
                f"{'n/a' if busy is None else f'{busy:.4f}'} | "
                f"{'n/a' if idle is None else f'{idle:.3f}'} | {tops} | "
                f"{a['aten_ops']} | {a['kernel_launches']} |"
            )
    return "\n".join(lines)
