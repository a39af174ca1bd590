"""The port's perf gate, counterpart of ``scripts/perf_gate.py``: hold one
backend's block of ``summerset_tpu_torch/PROFILE.json`` against a fresh
derivation on this machine.

- **Analytic counts are gated strictly** (``host/profiling.py``: aten ops
  and kernel launches per tick, in all and per phase, state / outbox /
  netstate bytes): deterministic per backend, so any difference fails,
  and a change that moves them regenerates the block
  (``python -m summerset_tpu_torch.profile_run``) and commits the diff.
- **Wall time is gated with a tolerance** and re-measure escalation: an
  over-tolerance first reading triggers more rounds (best of all rounds
  is compared); a faster reading only prints a note.
- **The mesh and tally sweeps** are re-derived and compared field for
  field; every mesh point's leaves must sit on their shard's device (the
  port's stand-in for JAX's donation checks: a torch step donates
  nothing), every point must make progress, and each collective tally
  point must issue strictly fewer tally-phase and tick aten ops than
  its pairwise twin, with ``[D, G, R]`` lanes on the delay line and, on
  a split replica axis, fewer bytes between shards.
- The phase-range overhead (ranges on against off) must stay under
  ``--max-overhead-pct``.

Exit 0 = the block reproduced; 1 = drift, a regression, or a committed
block whose own ``ok`` fields record a bad capture.  The full re-derive
runs outside tier-1; the tests check the gate's logic and the committed
artifact's structure.

Usage: ``python -m summerset_tpu_torch.perf_gate [--device cpu]
[--wall-tol 0.5] [--max-rounds 3] [--skip-wall] [--skip-overhead]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .host import profiling

ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "PROFILE.json")

#: cell fields compared strictly; wall-clock numbers are not here
STRICT_FIELDS = ("phases", "analytic", "shape")


def _drift(where, field, com, cur, errors) -> None:
    if com != cur:
        errors.append(
            f"{where}: drift in {field!r}:\n"
            f"    committed: {json.dumps(com, sort_keys=True)}\n"
            f"    current:   {json.dumps(cur, sort_keys=True)}")


def check_analytic_cell(committed: dict, errors: list, device=None) -> None:
    """Strict drift check for one protocol x variant cell."""
    shape = committed["shape"]
    cur = profiling.profile_cell(
        committed["protocol"], committed["variant"], G=shape["G"],
        R=shape["R"], W=shape["W"], with_device_trace=False,
        with_wall=False, device=device,
    )
    where = f"{committed['protocol']}[{committed['variant']}]"
    for field in STRICT_FIELDS:
        _drift(where, field, committed.get(field), cur.get(field), errors)


def wall_measure(committed: dict, ticks: int, reps: int,
                 device=None) -> float:
    """One wall re-measure of a committed cell's steady tick."""
    from .core import Engine

    shape = committed["shape"]
    kernel = profiling._cell_kernel(
        committed["protocol"], committed["variant"], shape["G"],
        shape["R"], shape["W"], device)
    eng = Engine(kernel, device=device)
    state, ns = eng.init()
    s_per_tick, _, _, _ = profiling.measure_steady_tick(
        eng, state, ns, ticks, shape["P"], reps)
    return s_per_tick


def check_wall_cell(committed: dict, tol: float, max_rounds: int,
                    errors: list, notes: list, device=None) -> None:
    """Tolerance gate with re-measure escalation: best of all rounds is
    compared, so one noisy window cannot fail by itself."""
    wall = committed.get("wall") or {}
    base = wall.get("s_per_tick")
    where = f"{committed['protocol']}[{committed['variant']}]"
    if not base or base <= 0:
        errors.append(f"{where}: committed wall.s_per_tick missing/zero")
        return
    ticks, reps = wall.get("ticks", 128), wall.get("reps", 3)
    best = float("inf")
    rounds = 0
    while rounds < max_rounds:
        rounds += 1
        best = min(best, wall_measure(committed, ticks, reps, device))
        if best <= base * (1.0 + tol):
            break
    ratio = best / base
    if ratio > 1.0 + tol:
        errors.append(
            f"{where}: steady tick regressed {ratio:.2f}x vs committed "
            f"({best * 1e3:.3f} vs {base * 1e3:.3f} ms/tick) after "
            f"{rounds} escalation round(s); tolerance {tol:.0%}")
    elif ratio < 1.0 / (1.0 + tol):
        notes.append(
            f"{where}: steady tick improved {1 / ratio:.2f}x vs committed "
            f"({best * 1e3:.3f} ms/tick); consider regenerating the block")


#: mesh point fields compared strictly; ``committed_slots`` is re-proved
#: > 0 instead (a progress check, not a count)
MESH_STRICT_FIELDS = ("mesh", "group_shards", "replica_shards", "devices",
                      "groups_per_device", "analytic", "placed")


def check_mesh_sweep(doc: dict, errors: list, device=None) -> None:
    """The committed mesh points must be good captures with a split
    point among them, every point placed on its shards' devices; then
    the sweep is re-derived and compared field for field."""
    ms = doc.get("mesh_sweep")
    if not ms:
        errors.append("mesh_sweep: missing from the committed block")
        return
    if not any(p.get("devices", 1) > 1 for p in ms["points"]):
        errors.append("mesh_sweep: the committed block has no "
                      "multi-shard point")
        return
    pre = len(errors)
    for p in ms["points"]:
        where = f"mesh_sweep[{p.get('mesh')}]"
        if not p.get("ok", False):
            errors.append(f"{where}: committed point has ok=false")
        if not p.get("placed", False):
            errors.append(f"{where}: committed point has leaves off their "
                          "shard's device")
        if p.get("committed_slots", 1) <= 0:
            errors.append(f"{where}: committed capture made no progress")
    if len(errors) > pre:
        return
    print("analytic: mesh sweep ...", flush=True)
    shape = ms.get("shape", {})
    cur = profiling.mesh_sweep(
        ms["protocol"], meshes=tuple(p["mesh"] for p in ms["points"]),
        G=shape.get("G", profiling.MESH_SWEEP_SHAPE["G"]),
        R=shape.get("R", profiling.MESH_SWEEP_SHAPE["R"]),
        W=shape.get("W", profiling.MESH_SWEEP_SHAPE["W"]),
        ticks=shape.get("ticks", profiling.MESH_SWEEP_TICKS),
        devices=ms.get("devices") and profiling.default_mesh_devices(
            device, len(ms["devices"])),
        device=device,
    )
    if cur["skipped"]:
        errors.append(f"mesh_sweep: cannot re-derive {cur['skipped']}")
        return
    for com, new in zip(ms["points"], cur["points"]):
        where = f"mesh_sweep[{com['mesh']}]"
        if new.get("committed_slots", 1) <= 0 or not new.get("ok"):
            errors.append(f"{where}: re-derived run made no progress or "
                          "left a leaf off its shard's device")
        for field in MESH_STRICT_FIELDS:
            _drift(where, field, com.get(field), new.get(field), errors)


#: tally point fields compared strictly
TALLY_STRICT_FIELDS = ("protocol", "tally", "mesh", "group_shards",
                       "replica_shards", "devices", "groups_per_device",
                       "analytic", "aten_ops_by_phase", "tally_lane_shapes")


def check_tally_pairs(points: list, errors: list) -> None:
    """The pairwise/collective invariants of the committed points."""
    by_key: dict = {}
    for p in points:
        where = (f"tally_sweep[{p.get('protocol')}@{p.get('mesh')}"
                 f":{p.get('tally')}]")
        if not p.get("ok", False) or p.get("committed_slots", 0) <= 0:
            errors.append(f"{where}: committed point made no progress")
        by_key.setdefault((p.get("protocol"), p.get("mesh")),
                          {})[p.get("tally")] = p
    for (proto, mesh), modes in sorted(by_key.items()):
        where = f"tally_sweep[{proto}@{mesh}]"
        pw, co = modes.get("pairwise"), modes.get("collective")
        if pw is None or co is None:
            errors.append(f"{where}: missing a tally mode "
                          f"(have {sorted(modes)})")
            continue
        if pw["committed_slots"] != co["committed_slots"]:
            errors.append(
                f"{where}: collective progress diverges from pairwise "
                f"({co['committed_slots']} vs {pw['committed_slots']} "
                "slots): the modes must be semantically identical")
        metrics = ["tally_phase_ops", "aten_ops"]
        if pw.get("replica_shards", 1) > 1:
            metrics.append("xfer_bytes_per_tick")
        for metric in metrics:
            pv = pw["analytic"].get(metric)
            cv = co["analytic"].get(metric)
            if pv is None or cv is None or not cv < pv:
                errors.append(
                    f"{where}: collective {metric} not strictly below "
                    f"pairwise ({cv} vs {pv})")
        for lane, shape in sorted(co["tally_lane_shapes"].items()):
            if len(shape) != 3:
                errors.append(f"{where}: collective lane {lane} is "
                              f"pairwise-shaped on the delay line: {shape}")
        for lane, shape in sorted(pw["tally_lane_shapes"].items()):
            if len(shape) != 4:
                errors.append(f"{where}: pairwise lane {lane} has "
                              f"delay-line shape {shape}")


def check_tally_sweep(doc: dict, errors: list, device=None) -> None:
    """The quorum-tally gate: the committed points' invariants
    (:func:`check_tally_pairs`), then a re-derive compared strictly."""
    ts = doc.get("tally_sweep")
    if not ts:
        errors.append("tally_sweep: missing from the committed block")
        return
    points = ts.get("points", [])
    pre = len(errors)
    check_tally_pairs(points, errors)
    if len(errors) > pre:
        return
    print("analytic: tally sweep ...", flush=True)
    shape = ts.get("shape", {})
    cur = profiling.tally_sweep(
        protocols=tuple(dict.fromkeys(p["protocol"] for p in points)),
        meshes=tuple(dict.fromkeys(p["mesh"] for p in points)),
        G=shape.get("G", profiling.MESH_SWEEP_SHAPE["G"]),
        R=shape.get("R", profiling.MESH_SWEEP_SHAPE["R"]),
        W=shape.get("W", profiling.MESH_SWEEP_SHAPE["W"]),
        ticks=shape.get("ticks", profiling.MESH_SWEEP_TICKS),
        with_device_trace=False, device=device,
    )
    if cur["skipped"]:
        errors.append(f"tally_sweep: cannot re-derive {cur['skipped']}")
        return
    cur_by = {(p["protocol"], p["mesh"], p["tally"]): p
              for p in cur["points"]}
    for com in points:
        key = (com["protocol"], com["mesh"], com["tally"])
        where = f"tally_sweep[{key[0]}@{key[1]}:{key[2]}]"
        new = cur_by.get(key)
        if new is None:
            errors.append(f"{where}: point missing from re-derived sweep")
            continue
        if new.get("committed_slots", 0) <= 0:
            errors.append(f"{where}: re-derived run made no progress")
        for field in TALLY_STRICT_FIELDS:
            _drift(where, field, com.get(field), new.get(field), errors)


def check_committed(doc: dict, errors: list) -> list:
    """The committed block's own verdicts; returns its cells."""
    cells = [cell for per in doc.get("protocols", {}).values()
             for cell in per.values()]
    if not cells:
        errors.append("the committed block has no protocol cells")
    for cell in cells:
        where = f"{cell['protocol']}[{cell['variant']}]"
        if not cell.get("ok", False):
            errors.append(f"{where}: committed cell has ok=false")
        wall = cell.get("wall") or {}
        if wall and wall.get("committed_slots_per_s", 0) <= 0:
            errors.append(f"{where}: committed capture made no progress "
                          "(0 committed slots/s)")
        if doc.get("profiler_available") and \
                cell.get("phase_wall_us_per_tick") is None:
            errors.append(f"{where}: no per-phase device time although the "
                          "profiler saw the device at capture time")
    return cells


def gate(doc: dict, device, wall_tol: float = 0.5, max_rounds: int = 3,
         max_overhead_pct: float = 5.0, skip_wall: bool = False,
         skip_overhead: bool = False) -> tuple:
    """Run every check on one backend's block; ``(errors, notes)``."""
    errors: list = []
    notes: list = []
    import torch

    backend = torch.device(device).type
    if doc.get("backend") != backend:
        errors.append(f"block backend {doc.get('backend')!r} != current "
                      f"{backend!r}: counts compare only per backend")
    cells = check_committed(doc, errors)
    if not errors:
        for cell in cells:
            print(f"analytic: {cell['protocol']}[{cell['variant']}] ...",
                  flush=True)
            check_analytic_cell(cell, errors, device)
        sweep = doc.get("g_sweep")
        if sweep:
            print("analytic: g-sweep ...", flush=True)
            cur = profiling.g_sweep(
                sweep["protocol"],
                groups=tuple(p["G"] for p in sweep["points"]),
                device=device)
            _drift("g_sweep", "points", sweep["points"], cur["points"],
                   errors)
        check_mesh_sweep(doc, errors, device)
        check_tally_sweep(doc, errors, device)
    if not errors and not skip_wall:
        for cell in cells:
            if cell.get("variant") != "device" or not cell.get("wall"):
                continue
            print(f"wall: {cell['protocol']}[{cell['variant']}] ...",
                  flush=True)
            check_wall_cell(cell, wall_tol, max_rounds, errors, notes,
                            device)
    if not errors and not skip_overhead:
        committed_ov = doc.get("scope_overhead") or {}
        if committed_ov.get("pct", 0.0) > max_overhead_pct:
            errors.append(f"committed scope_overhead {committed_ov['pct']}%"
                          f" > {max_overhead_pct}%")
        else:
            print("overhead: phase-range ablation A/B ...", flush=True)
            ov = profiling.measure_scope_overhead(max_pct=max_overhead_pct,
                                                  device=device)
            print(f"  live overhead {ov['pct']}% ({ov['pairs']} "
                  "interleaved pairs)")
            if ov["pct"] > max_overhead_pct:
                errors.append(f"phase-range overhead {ov['pct']}% > "
                              f"{max_overhead_pct}% (after escalation)")
    return errors, notes


def main(argv=None) -> int:
    from .device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=ARTIFACT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' gates the "
                         "cpu block)")
    ap.add_argument("--wall-tol", type=float, default=0.5)
    ap.add_argument("--max-rounds", type=int, default=3)
    ap.add_argument("--max-overhead-pct", type=float, default=5.0)
    ap.add_argument("--skip-wall", action="store_true")
    ap.add_argument("--skip-overhead", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    try:
        with open(args.profile) as f:
            art = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"perf_gate: cannot read {args.profile}: {e}")
        return 1
    doc = (art.get("backends") or {}).get(dev.type)
    if doc is None:
        print(f"perf_gate: {args.profile} has no {dev.type!r} block")
        return 1
    errors, notes = gate(doc, dev, args.wall_tol, args.max_rounds,
                         args.max_overhead_pct, args.skip_wall,
                         args.skip_overhead)
    for n in notes:
        print(f"note: {n}")
    if errors:
        print(f"perf_gate: FAIL ({len(errors)} problem(s))")
        for e in errors:
            print(f"  - {e}")
        print("regenerate with: python -m summerset_tpu_torch.profile_run "
              "(and commit the PROFILE.json diff with the change that "
              "caused it)")
        return 1
    print(f"perf_gate: PASS (the {dev.type} block of {args.profile} "
          "reproduced)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
