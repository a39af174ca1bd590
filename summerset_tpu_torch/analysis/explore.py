"""Exhaustive small-model explorer, counterpart of ``models/explore.py``.

Every fault schedule over a bounded horizon is enumerated at a tiny
geometry (G=1, R=3, W=4) by stepping the port's real kernel through its
engine: per round (2 lockstep ticks) one of {all-up, kill r, isolate r}
for each replica r, 7 actions, breadth-first, with the network made
deterministic (fixed 1-tick delay, no jitter, no drops) so the fault
alphabet is the only nondeterminism.  At every reached node it asserts

- **agreement** — no two replicas commit different values for a slot;
- **durability** — a binding committed in the parent never changes in
  the child.

Nodes dedup on a hash of (kernel state, network state) plus a digest of
the path's committed bindings that slid out of every window, so two
paths converging on one state with different slid-out histories both
stay explored.  The run is also the range prover's soundness oracle:
every proven interval invariant and pair fact of this exact kernel
(``analysis/ranges.py``) must hold at every visited state.

``python -m summerset_tpu_torch.analysis.explore [--device cpu]
[--protocols multipaxos:3,raft:3] [--out rows.json]`` runs on the card
unless ``--device cpu`` is given, and raises with no card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
from collections import deque
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..convert import to_numpy
from ..core.engine import Engine
from ..core.netmodel import NetConfig
from ..device import resolve_device
from ..protocols import make_protocol

G = 1  # one group: the fault alphabet acts on all groups identically


def _actions(R: int) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """(name, alive [G, R], link_up [G, R, R]) fault alphabet."""
    acts = []
    up = np.ones((G, R), bool)
    full = np.ones((G, R, R), bool)
    acts.append(("up", up, full))
    for r in range(R):
        alive = up.copy()
        alive[:, r] = False
        acts.append((f"kill{r}", alive, full))
    for r in range(R):
        link = full.copy()
        link[:, r, :] = link[:, :, r] = False
        link[:, r, r] = True
        acts.append((f"iso{r}", up, link))
    return acts


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _state_hash(np_state: Dict[str, np.ndarray], ns) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(np_state):
        h.update(k.encode())
        h.update(np_state[k].tobytes())
    for _, leaf in _leaves(ns):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.digest()


def _oow_digest(acc: Dict[int, int], visible: Dict[int, int]) -> bytes:
    """Digest of the path's committed bindings no replica's window still
    shows (folded into the dedup key)."""
    items = [(s, v) for s, v in sorted(acc.items()) if s not in visible]
    if not items:
        return b""
    h = hashlib.blake2b(digest_size=8)
    for s, v in items:
        h.update(s.to_bytes(8, "little") + v.to_bytes(8, "little"))
    return h.digest()


def _committed(state: Dict[str, np.ndarray], R: int, W: int
               ) -> Dict[int, int]:
    """Merged {slot: value} over replicas' windows; raises on divergence."""
    merged: Dict[int, int] = {}
    for r in range(R):
        cb = int(state["commit_bar"][0, r])
        absw = state["win_abs"][0, r]
        valw = state["win_val"][0, r]
        for p in range(W):
            a = int(absw[p])
            if 0 <= a < cb:
                v = int(valw[p])
                if a in merged and merged[a] != v:
                    raise AssertionError(
                        f"agreement violated: slot {a}: {merged[a]} != {v} "
                        f"(replica {r})"
                    )
                merged[a] = v
    return merged


@dataclasses.dataclass
class ExploreResult:
    protocol: str
    depth: int
    round_ticks: int
    nodes_expanded: int
    dedup_hits: int
    max_committed_slots: int
    violations: List[str]
    tally: str = "pairwise"
    range_leaves: int = 0
    range_pairs: int = 0

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


def check_ranges(np_state: Dict[str, np.ndarray], inv_items, pair_items,
                 where: str) -> List[str]:
    """Every proven invariant and pair fact against one concrete state
    (``np_state`` in the JAX layout: uint32 leaves as uint32)."""
    out = []
    for leaf, (lo, hi) in inv_items:
        a = np_state.get(leaf)
        if a is None:
            continue
        mn, mx = int(a.min()), int(a.max())
        if mn < lo or mx > hi:
            out.append(
                f"range invariant violated: {leaf} proven in "
                f"[{lo}, {hi}] but witness state at {where} has "
                f"[{mn}, {mx}]"
            )
    for x, y in pair_items:
        ax, ay = np_state.get(x), np_state.get(y)
        if ax is None or ay is None:
            continue
        if not bool(np.all(ax <= ay)):
            i = int(np.argmax(np.ravel(ax > ay)))
            out.append(
                f"range pair violated: {x} <= {y} proven but "
                f"witness state at {where} has {x}="
                f"{int(np.ravel(ax)[i])} > {y}={int(np.ravel(ay)[i])} "
                f"(flat index {i})"
            )
    return out


def build(protocol: str, R: int = 3, W: int = 4,
          config_overrides: Dict[str, Any] | None = None,
          tally: str = "pairwise", device=None):
    """The explorer's kernel: shrunken timeouts so elections fall inside
    the horizon, one proposal a tick, the given overrides."""
    base = make_protocol(protocol, G, R, 64, device=device)
    overrides = dict(config_overrides or {})
    if tally != "pairwise":
        if not hasattr(base.config, "tally"):
            raise ValueError(
                f"protocol {protocol!r} has no quorum-tally knob; "
                f"cannot explore tally={tally!r}"
            )
        overrides.setdefault("tally", tally)
    cfg = dataclasses.replace(
        base.config,
        max_proposals_per_tick=1,
        hear_timeout_lo=4,
        hear_timeout_hi=6,
        retry_interval=2,
        **overrides,
    )
    return make_protocol(protocol, G, R, W, cfg, device=device), cfg


def explore(protocol: str = "multipaxos", R: int = 3, W: int = 4,
            depth: int = 6, round_ticks: int = 2,
            config_overrides: Dict[str, Any] | None = None,
            tally: str = "pairwise", range_oracle: bool = True,
            progress: bool = False, device=None,
            invariants: Dict[str, Tuple[int, int]] | None = None
            ) -> ExploreResult:
    """Breadth-first exhaustion of all fault schedules of ``depth`` rounds.

    ``invariants`` replaces the proven intervals the oracle asserts (the
    tests narrow one on purpose to see it reported)."""
    dev = resolve_device(device)
    kernel, cfg = build(protocol, R, W, config_overrides, tally, dev)
    inv_items: List[Tuple[str, Tuple[int, int]]] = []
    pair_items: Tuple[Tuple[str, str], ...] = ()
    if range_oracle:
        from .ranges import analyze_kernel_ranges

        ra = analyze_kernel_ranges(kernel)
        inv_items = sorted((invariants or ra.invariants).items())
        pair_items = ra.pairs

    eng = Engine(kernel, netcfg=NetConfig(delay_ticks=1), seed=0,
                 device=dev)
    state0, ns0 = eng.init()
    # the telemetry-free step: exploration asserts nothing on the lanes
    state0.pop("telem", None)
    acts = [(n, torch.as_tensor(a, device=dev), torch.as_tensor(lk,
                                                                device=dev))
            for n, a, lk in _actions(R)]
    ones = torch.ones((G,), dtype=torch.int32, device=dev)

    def run_round(state, ns, alive, link, vbase):
        for t in range(round_ticks):
            inputs = {
                "n_proposals": ones,
                "value_base": torch.full((G,), vbase + t,
                                         dtype=torch.int32, device=dev),
                "alive": alive,
                "link_up": link,
            }
            state, ns, _ = eng.tick(state, ns, inputs)
        return state, ns

    nodes = deque()
    np0 = to_numpy(state0)
    acc0 = _committed(np0, R, W)
    nodes.append((state0, ns0, acc0, 0))
    seen = {_state_hash(np0, ns0) + _oow_digest(acc0, acc0)}
    expanded = 0
    dedup = 0
    max_committed = 0
    violations: List[str] = []
    violations.extend(check_ranges(np0, inv_items, pair_items, "init"))

    while nodes:
        state, ns, acc, d = nodes.popleft()
        if d >= depth:
            continue
        for name, alive, link in acts:
            vbase = 1 + d * round_ticks  # unique value per (depth, tick)
            s2, n2 = run_round(state, ns, alive, link, vbase)
            expanded += 1
            np2 = to_numpy(s2)
            try:
                cm = _committed(np2, R, W)
                for slot, v in acc.items():
                    if slot in cm and cm[slot] != v:
                        raise AssertionError(
                            f"durability violated: slot {slot}: "
                            f"{v} -> {cm[slot]} after {name}@d{d}"
                        )
            except AssertionError as e:
                violations.append(str(e))
                continue
            rv = check_ranges(np2, inv_items, pair_items, f"{name}@d{d}")
            if rv:
                violations.extend(rv)
                continue
            acc2 = dict(acc)
            acc2.update(cm)
            max_committed = max(max_committed, len(acc2))
            h = _state_hash(np2, n2) + _oow_digest(acc2, cm)
            if h in seen:
                dedup += 1
                continue
            seen.add(h)
            nodes.append((s2, n2, acc2, d + 1))
        if progress and expanded % 500 < len(acts):
            print(f"  d<{depth} expanded={expanded} frontier={len(nodes)} "
                  f"dedup={dedup}", flush=True)

    return ExploreResult(
        protocol=protocol, depth=depth, round_ticks=round_ticks,
        nodes_expanded=expanded, dedup_hits=dedup,
        max_committed_slots=max_committed, violations=violations,
        tally=getattr(cfg, "tally", "pairwise"),
        range_leaves=len(inv_items), range_pairs=len(pair_items),
    )


# per-protocol config overrides for CLI runs, the JAX explorer's presets
CLI_PRESETS: Dict[str, Dict[str, Any]] = {
    "rspaxos": {"fault_tolerance": 1},
    "crossword": {"fault_tolerance": 0, "assignment_adaptive": False},
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocols", default="multipaxos:3,raft:3,rspaxos:3",
                    help="comma list of name[+collective][:depth]")
    ap.add_argument("--depth", type=int, default=3,
                    help="depth for entries without an explicit :depth")
    ap.add_argument("--round-ticks", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="device to step on (default: the card; 'cpu' to "
                         "run here)")
    ap.add_argument("--no-range-oracle", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    results = []
    bad = False
    for spec in args.protocols.split(","):
        name, _, d = spec.strip().partition(":")
        name, _, mode = name.partition("+")
        r = explore(name, depth=int(d) if d else args.depth,
                    round_ticks=args.round_ticks,
                    config_overrides=CLI_PRESETS.get(name),
                    tally=mode or "pairwise",
                    range_oracle=not args.no_range_oracle,
                    progress=True, device=args.device)
        print(json.dumps(r.as_json()))
        results.append(r.as_json())
        bad |= bool(r.violations)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
