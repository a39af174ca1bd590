"""Flags-taint pass, counterpart of ``summerset_tpu/analysis/taint.py``:
prove every inbox read is gated on ``flags``, over the recorded aten
trace of one step (``analysis/tracer.py``).

The netmodel zeroes only the ``flags`` pair-field on a dead, partitioned
or dropped link; the data lanes still carry bytes.  So a kernel must pass
every inbox lane through a ``flags``-derived gate before it lands in a
sink: a state leaf, an effects output (``effects.<leaf>``, served to
clients) or an outbox lane (``outbox.<leaf>``, a relay hop).  Each value
carries

- ``sources`` — the inbox leaves that reached it without a gate,
- ``guard`` — whether it derives from ``flags``,
- ``dead`` — its class in the all-links-dead world (a number, ``"nz"``
  for known nonzero, or ``None``),
- ``rng`` — its dead-world interval: state leaves are seeded with the
  range pass's proven invariants and the range pass's transfer table
  (:func:`ranges.op_intervals`) carries them.

Gates: ``where.self`` with a guarded predicate clears the cases the live
world selects (strict when the dead-world polarity is decided, the
optimistic clearing otherwise, counted and listed as a residual);
``mul`` / ``bitwise_and`` / ``logical_and`` with a guarded operand that
is not provably inverted.  A sink whose sources are not empty is a
``T1`` finding per (inbox leaf, sink) flow, unless ``TAINT_ALLOW``
names it; a stale allow entry is ``T9``.  A step with host-read
branches is walked once per branch trace and the flows are united.
"""

from __future__ import annotations

import dataclasses
import operator as op
from typing import Any, Dict, FrozenSet, List, Set, Tuple

import torch

from . import ranges as _ranges
from . import tracer
from .contract import kernel_variants, rule_finding, trace_step
from .report import PassResult

EMPTY: FrozenSet[str] = frozenset()


@dataclasses.dataclass(frozen=True)
class Taint:
    sources: FrozenSet[str] = EMPTY
    guard: bool = False
    dead: Any = None
    rng: Any = None


CLEAN = Taint()
GUARD = Taint(EMPTY, True, 0, (0, 0))

_MASK_OPS = frozenset({"mul", "bitwise_and", "__and__", "logical_and"})
_NOT_OPS = frozenset({"bitwise_not", "logical_not"})
_ARITH = {
    "bitwise_or": "or", "__or__": "or", "bitwise_xor": "xor",
    "__xor__": "xor", "add": "add", "sub": "sub", "maximum": "max",
    "minimum": "min", "clamp_min": "max", "clamp_max": "min",
}
_PRESERVE = _ranges.SHAPE_OPS
_REDUCE_KEEP = frozenset({"any", "all", "amax", "amin", "max", "min"})
_REDUCE_ZERO = frozenset({"sum", "prod"})


def _dead_zero(t: Taint) -> bool:
    if t.rng is not None and t.rng[0] == 0 and t.rng[1] == 0:
        return True
    return t.dead is not None and not isinstance(t.dead, str) and t.dead == 0


def _dead_nonzero(t: Taint) -> bool:
    if t.rng is not None and (t.rng[0] > 0 or t.rng[1] < 0):
        return True
    return t.dead == "nz" or (
        t.dead is not None and not isinstance(t.dead, str) and t.dead != 0
    )


def _join_flat(*xs):
    first = xs[0] if xs else None
    for x in xs[1:]:
        if x is None or first is None or x != first:
            return None
    return first


def _join(*ts: Taint) -> Taint:
    src: Set[str] = set()
    guard = False
    for t in ts:
        src |= t.sources
        guard |= t.guard
    return Taint(frozenset(src), guard, _join_flat(*[t.dead for t in ts]),
                 _join_flat(*[t.rng for t in ts]))


def _const(v: tracer.Val) -> Taint:
    """A recorded constant: the same value in every world, so a uniform
    one pins the dead-world class exactly."""
    lo, hi = v.const_interval()
    if lo is None:
        return CLEAN
    return Taint(EMPTY, False, lo if lo == hi else None, (lo, hi))


def _cmp_dead(name: str, da, db):
    fns = {"eq": op.eq, "ne": op.ne, "lt": op.lt, "le": op.le,
           "gt": op.gt, "ge": op.ge}
    if da is None or db is None:
        return None
    a_nz, b_nz = da == "nz", db == "nz"
    if a_nz or b_nz:
        other = db if a_nz else da
        if not (a_nz and b_nz) and not isinstance(other, str) and other == 0:
            if name == "eq":
                return 0
            if name == "ne":
                return 1
        return None
    return int(fns[name](da, db))


def _truth_dead(d):
    if d is None:
        return None
    if d == "nz":
        return 1
    return int(d != 0)


class _Walker:
    """One abstract-interpretation pass over one branch trace."""

    def __init__(self, tr: tracer.Trace, gates: Dict[str, Dict]):
        self.tr = tr
        self.env: Dict[int, Taint] = {}
        self.gates = gates

    def _gate(self, kind: str, call, cleared) -> None:
        """Record one gate that dropped live taint, keyed by a line-free
        descriptor (op, phase, operand shapes and dtypes)."""
        if not cleared:
            return
        key = (
            call.name, call.phase,
            tuple(self._desc(a) for a in call.args
                  if isinstance(a, tracer.Ref)),
        )
        self.gates[kind].setdefault(key, set()).update(cleared)

    def _desc(self, a) -> str:
        v = self.tr.vals[a.id]
        return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"

    def read(self, x) -> Taint:
        if isinstance(x, tracer.Ref):
            t = self.env.get(x.id)
            if t is None:
                v = self.tr.vals[x.id]
                t = _const(v) if v.tensor is not None else CLEAN
                self.env[x.id] = t
            return t
        if isinstance(x, bool):
            return Taint(EMPTY, False, int(x), (int(x), int(x)))
        if isinstance(x, (int, float)):
            return Taint(EMPTY, False, x, (x, x))
        return CLEAN

    def run(self, in_taints: Dict[int, Taint]) -> None:
        self.env.update(in_taints)
        for call in self.tr.calls:
            if call.sync or not call.outs:
                continue
            outs = self._transfer(call)
            for vid, t in zip(call.outs, outs):
                self.env[vid] = t

    def _tensor_args(self, call) -> List[Taint]:
        out = []
        for a in tracer._flat(call.args):
            if isinstance(a, tracer.Ref):
                out.append(self.read(a))
        return out

    def _transfer(self, call) -> List[Taint]:
        outs = self._transfer_core(call)
        vals = [self.tr.vals[v] for v in call.outs]
        if any(t.rng is None for t in outs):
            def iv(a):
                if isinstance(a, tracer.Ref):
                    r = self.read(a).rng
                    if r is None:
                        return _ranges.dtype_bounds(self.tr.vals[a.id].dtype)
                    return (int(r[0]), int(r[1]))
                return self.read(a).rng or (-_ranges._FINF, _ranges._FINF)
            try:
                rngs = _ranges.op_intervals(self.tr, call, iv)
            except Exception:  # pragma: no cover - table bug must not kill T1
                rngs = None
            if rngs:
                outs = [
                    t if t.rng is not None or r is None
                    else dataclasses.replace(t, rng=(int(r[0]), int(r[1])))
                    for t, r in zip(outs, rngs)
                ]
        return outs[:len(vals)]

    def _transfer_core(self, call) -> List[Taint]:
        vals = [self.tr.vals[v] for v in call.outs]
        n_out = len(vals)
        if all(v.tensor is not None for v in vals):
            return [_const(v) for v in vals]
        base = call.opname
        args = call.args
        if base == "where" and call.name.endswith(".self"):
            pred = self.read(args[0])
            cases = [self.read(args[2]), self.read(args[1])]
            sel = None
            if pred.guard:
                if _dead_zero(pred):
                    sel = cases[0]
                elif _dead_nonzero(pred):
                    sel = cases[1]
            if sel is not None:
                cleared: Set[str] = set()
                for c in cases:
                    if c is not sel:
                        cleared |= c.sources
                self._gate("proven", call, cleared - sel.sources)
                out = Taint(frozenset(pred.sources | sel.sources), True,
                            sel.dead, sel.rng)
            elif pred.guard:
                dropped: Set[str] = set()
                for c in cases:
                    dropped |= c.sources
                self._gate("optimistic", call, dropped)
                out = Taint(pred.sources, True, None)
            else:
                out = _join(pred, *cases)
            return [out] * n_out
        if base in _MASK_OPS and len(args) >= 2:
            ins = [self.read(args[0]), self.read(args[1])]
            src: Set[str] = set()
            prv: Set[str] = set()
            opt: Set[str] = set()
            for i, t in enumerate(ins):
                gaters = [o for j, o in enumerate(ins)
                          if j != i and o.guard and not _dead_nonzero(o)]
                if gaters:
                    if any(_dead_zero(o) for o in gaters):
                        prv |= t.sources
                    else:
                        opt |= t.sources
                    continue
                src |= t.sources
            self._gate("proven", call, prv)
            self._gate("optimistic", call, opt)
            deads = [t.dead for t in ins]
            if base == "logical_and":
                deads = [_truth_dead(d) for d in deads]
            if any(_dead_zero(t) for t in ins):
                dead = 0
            elif all(d is not None and not isinstance(d, str)
                     for d in deads):
                a = deads[0]
                for d in deads[1:]:
                    a = (a * d) if base == "mul" else (int(a) & int(d))
                dead = a
            else:
                dead = None
            return [Taint(frozenset(src), any(t.guard for t in ins),
                          dead)] * n_out
        if base in _ranges.CMP_OPS and len(args) >= 2:
            a, b = self.read(args[0]), self.read(args[1])
            return [Taint(frozenset(a.sources | b.sources),
                          a.guard or b.guard,
                          _cmp_dead(base, a.dead, b.dead))] * n_out
        if base in _NOT_OPS:
            t = self.read(args[0])
            logical = vals[0].dtype == torch.bool
            d = t.dead
            if base == "logical_not":
                d = _truth_dead(d)
            if d is None:
                dead = None
            elif d == "nz":
                dead = 0 if logical else None
            elif logical:
                dead = int(not d)
            else:
                dead = ~int(d)
            return [Taint(t.sources, t.guard, dead)] * n_out
        if base in _ARITH and len(args) >= 2:
            return [self._arith(_ARITH[base],
                                [self.read(args[0]),
                                 self.read(args[1])])] * n_out
        if base == "rsub":
            return [self._arith("sub", [self.read(args[1]),
                                        self.read(args[0])])] * n_out
        if base == "clamp":
            t = self.read(args[0])
            lo = _ranges._arg(call, 1, "min")
            hi = _ranges._arg(call, 2, "max")
            if lo is not None:
                t = self._arith("max", [t, self.read(lo)])
            if hi is not None:
                t = self._arith("min", [t, self.read(hi)])
            return [dataclasses.replace(t, rng=None)] * n_out
        if base == "_to_copy":
            t = self.read(args[0])
            if vals[0].dtype == torch.bool:
                t = Taint(t.sources, t.guard, _truth_dead(t.dead))
            return [dataclasses.replace(t, rng=None)] * n_out
        if base in _PRESERVE and len(args) >= 1 and \
                isinstance(args[0], tracer.Ref):
            t = self.read(args[0])
            return [dataclasses.replace(t, rng=None)] * n_out
        if base in _REDUCE_KEEP and args:
            t = _join(*self._tensor_args(call))
            d = self.read(args[0]).dead
            if base in ("any", "all") and \
                    self.tr.vals[args[0].id].dtype != torch.bool:
                d = _truth_dead(d)
            return [Taint(t.sources, t.guard, d)] * n_out
        if base in _REDUCE_ZERO and args:
            t = _join(*self._tensor_args(call))
            dead = 0 if _dead_zero(self.read(args[0])) else None
            return [Taint(t.sources, t.guard, dead)] * n_out
        if base in _ranges.PICK_OPS and args:
            t = _join(*self._tensor_args(call))
            return [Taint(t.sources, t.guard,
                          self.read(args[0]).dead)] * n_out
        if base in ("cat", "stack") and args:
            return [_join(*self._tensor_args(call))] * n_out
        ins = self._tensor_args(call)
        if not ins:
            return [CLEAN] * n_out
        t = _join(*ins)
        # unmodeled op: sources and guard join, no dead-world class
        return [Taint(t.sources, t.guard, None)] * n_out

    @staticmethod
    def _arith(name: str, ins: List[Taint]) -> Taint:
        t = _join(*ins)
        deads = [i.dead for i in ins]
        conc = [d for d in deads if d is not None and not isinstance(d, str)]
        dead = None
        if len(conc) == len(deads):
            fns = {
                "or": lambda a, b: int(a) | int(b),
                "xor": lambda a, b: int(a) ^ int(b),
                "add": op.add, "sub": op.sub, "max": max, "min": min,
            }
            a = conc[0]
            for d in conc[1:]:
                a = fns[name](a, d)
            dead = a
        elif name in ("or", "xor", "add"):
            rest = [i for i in ins if not _dead_zero(i)]
            if len(rest) == 1:
                dead = rest[0].dead
            elif name == "or" and rest and all(_dead_nonzero(i)
                                               for i in rest):
                dead = "nz"
        return Taint(t.sources, t.guard, dead)


def analyze_kernel_flows(kernel, invariants=None,
                         stats=None) -> Set[Tuple[str, str]]:
    """All ungated (inbox_leaf -> sink) flows over every branch trace of
    one step.  ``invariants`` (leaf -> int32 ``(lo, hi)``, the range
    pass's ``internal``) seed the state leaves' dead-world intervals;
    ``stats`` collects the gate accounting across calls."""
    st = trace_step(kernel)
    inv = invariants or {}
    flows: Set[Tuple[str, str]] = set()
    gates: Dict[str, Dict] = {"proven": {}, "optimistic": {}}
    for tr in st.branches:
        in_taints: Dict[int, Taint] = {}
        for tree, leaf, vid in tr.inputs:
            if tree == 1:
                in_taints[vid] = GUARD if leaf == "flags" else \
                    Taint(frozenset({leaf}), False)
            elif tree == 0 and leaf in inv:
                iv = _ranges.iv_clamp(
                    (int(inv[leaf][0]), int(inv[leaf][1])),
                    _ranges.dtype_bounds(tr.vals[vid].dtype),
                )
                in_taints[vid] = Taint(EMPTY, False, None, iv)
            else:
                in_taints[vid] = CLEAN
        w = _Walker(tr, gates)
        w.run(in_taints)
        for tree, leaf, vid in tr.outputs:
            t = w.read(tracer.Ref(vid))
            dst = leaf if tree == 0 else (
                f"effects.{leaf}" if tree == 2 else f"outbox.{leaf}")
            for src in t.sources:
                flows.add((src, dst))
    if stats is not None:
        for kind, d in gates.items():
            tgt = stats.setdefault(kind, {})
            for key, srcs in d.items():
                tgt.setdefault(key, set()).update(srcs)
    return flows


def verify_kernel_taint(make_protocol, name: str, use_ranges: bool = True,
                        device=None) -> PassResult:
    """T1/T9 findings for one kernel over every config variant; the gate
    accounting rides in ``extra`` (``gates_proven`` / ``gates_optimistic``
    / ``residuals``)."""
    res = PassResult()
    try:
        variants = kernel_variants(make_protocol, name, device=device)
        kernel = variants[0][1]
        flows: Set[Tuple[str, str]] = set()
        stats: Dict[str, Dict[Tuple, Set[str]]] = {}
        for _, k in variants:
            inv = None
            if use_ranges:
                try:
                    inv = _ranges.analyze_kernel_ranges(k).internal
                except Exception as e:
                    res.extra["ranges_error"] = f"{type(e).__name__}: {e}"
            flows |= analyze_kernel_flows(k, invariants=inv, stats=stats)
        res.extra["gates_proven"] = len(stats.get("proven", {}))
        res.extra["gates_optimistic"] = len(stats.get("optimistic", {}))
        res.extra["residuals"] = [
            {"op": p, "phase": ph, "operands": list(av),
             "sources": sorted(srcs)}
            for (p, ph, av), srcs in sorted(
                stats.get("optimistic", {}).items()
            )
        ]
        allow = {(src, dst): reason
                 for src, dst, reason in kernel.TAINT_ALLOW}
        for src, dst in sorted(flows):
            f = rule_finding(
                "T1", kernel.name, f"{src}->{dst}",
                f"inbox leaf {src!r} reaches sink {dst!r} without a "
                "flags-derived gate (garbage consumed on dead or "
                "partitioned links)",
            )
            reason = allow.get((src, dst))
            if reason is not None:
                res.suppressed.append((f, reason))
            else:
                res.findings.append(f)
        for (src, dst), _reason in sorted(allow.items()):
            if (src, dst) not in flows:
                res.findings.append(rule_finding(
                    "T9", kernel.name, f"{src}->{dst}",
                    f"stale TAINT_ALLOW entry: flow {src!r} -> {dst!r} "
                    "no longer occurs — delete the suppression",
                ))
    except Exception as e:
        res.error = f"{type(e).__name__}: {e}"
    return res
