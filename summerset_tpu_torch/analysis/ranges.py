"""Inductive value-range invariants over kernel state, counterpart of
``summerset_tpu/analysis/ranges.py``, run over the recorded aten trace of
one step (``analysis/tracer.py``) instead of a jaxpr.

The same three phases as the JAX prover:

1. **Init** — leaf intervals of ``init_state`` over the seed set
   ``INIT_SEEDS``, unioned.
2. **Step as interval transfer** — every recorded call is an interval
   transfer (:func:`op_intervals`; ``where.self`` joins and refines its
   reachable cases by the predicate's comparison conjuncts), inbox and
   step-input leaves are ⊤ within their dtype, constants (a kernel's
   prebuilt tensors, factory results) are their concrete value.  The
   fixpoint runs with the JAX prover's threshold widening, bounded
   narrowing, inductive re-check and coinductive tightening; the
   octagon-lite pair facts ``x <= y`` come from the same
   greatest-fixpoint candidate removal.  A step with host-read branches
   has one trace per branch: intervals join over the branches, and a
   pair fact survives only if every branch re-establishes it.
3. **Feed T1** — ``taint.py`` seeds state leaves' dead-world intervals
   with the proven invariants.

Arithmetic is the JAX prover's saturating, no-wrap interval arithmetic,
widening int32 to int64 where torch promotes (``sum``, index tensors).
An overload the table does not model gives ⊤ in its dtype, and the run
lists it (``RangeAnalysis.unmodeled``).

Logical dtypes: the leaves the JAX package holds as uint32 are int32 bit
patterns here (``convert.UINT32_LEAVES``).  The analysis runs on the
int32 values; :attr:`RangeAnalysis.invariants` reports those leaves in
their logical uint32 range so they compare with the JAX prover's
(``internal`` keeps the int32 intervals the taint pass seeds with).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

import torch

from ..convert import UINT32_LEAVES
from ..core import telemetry
from . import tracer
from .contract import kernel_variants, rule_finding, trace_step
from .report import PassResult

Interval = Tuple[int, int]

_FINF = 2 ** 63
_OUTER_CAP = 64
_NARROW_ROUNDS = 3

#: seeds the concrete init-interval evaluation unions over
INIT_SEEDS = (0, 1, 2)

_REL_CAP = 64
_NO_REL = (frozenset(), frozenset())

U32 = (0, 2 ** 32 - 1)


# ------------------------------------------------------ interval algebra --
_BOUNDS: Dict[Any, Interval] = {}


def dtype_bounds(dtype) -> Interval:
    """The dtype's representable range: the ⊤ element for a value."""
    b = _BOUNDS.get(dtype)
    if b is None:
        b = _BOUNDS[dtype] = _dtype_bounds(dtype)
    return b


def _dtype_bounds(dtype) -> Interval:
    if dtype is None:
        return (-_FINF, _FINF)
    if dtype == torch.bool:
        return (0, 1)
    if dtype.is_floating_point or dtype.is_complex:
        return (-_FINF, _FINF)
    info = torch.iinfo(dtype)
    return (int(info.min), int(info.max))


def iv_clamp(iv: Interval, bounds: Interval) -> Interval:
    lo, hi = iv
    blo, bhi = bounds
    return (min(max(lo, blo), bhi), max(min(hi, bhi), blo))


def iv_join(a: Interval, b: Interval) -> Interval:
    return (min(a[0], b[0]), max(a[1], b[1]))


def iv_meet(a: Interval, b: Interval) -> Optional[Interval]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return None if lo > hi else (lo, hi)


def iv_leq(a: Interval, b: Interval) -> bool:
    return b[0] <= a[0] and a[1] <= b[1]


def logical_interval(leaf: str, iv: Interval) -> Interval:
    """An int32 interval of a ``UINT32_LEAVES`` leaf as its uint32 range."""
    if leaf not in UINT32_LEAVES:
        return iv
    lo, hi = iv
    if lo >= 0:
        return (lo, hi)
    if hi < 0:
        return (lo + 2 ** 32, hi + 2 ** 32)
    return U32


def _corners(a: Interval, b: Interval, fn) -> Interval:
    vs = [fn(x, y) for x in a for y in b]
    return (min(vs), max(vs))


def _tdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _truth(iv: Interval) -> Interval:
    """Interval of ``x != 0`` as a bool."""
    lo, hi = iv
    if lo == 0 and hi == 0:
        return (0, 0)
    if lo > 0 or hi < 0:
        return (1, 1)
    return (0, 1)


def _wrapping(iv: Interval, dtype) -> Interval:
    """A product that leaves its dtype is ⊤: the LCG's multiply wraps on
    purpose (``ops/prng.py`` keeps uint32 bits in int32 lanes), so
    saturating it would claim bounds a real run breaks.  Sums and shifts
    keep the JAX prover's saturating semantics."""
    b = dtype_bounds(dtype)
    if iv[0] < b[0] or iv[1] > b[1]:
        return b
    return iv


def tensor_interval(t: torch.Tensor) -> Interval:
    if t.numel() == 0:
        return dtype_bounds(t.dtype)
    if t.dtype == torch.bool:
        a = t.to(torch.int32)
    else:
        a = t
    if a.dtype.is_floating_point:
        return (float(a.min()), float(a.max()))
    return (int(a.min()), int(a.max()))


def const_interval(v: tracer.Val) -> Interval:
    """A recorded constant's interval (its dtype's range when empty)."""
    lo, hi = v.const_interval()
    return dtype_bounds(v.dtype) if lo is None else (lo, hi)


def _cmp_interval(name: str, a: Interval, b: Interval) -> Interval:
    """Decide a comparison from operand intervals, else (0, 1)."""
    if name == "eq":
        if iv_meet(a, b) is None:
            return (0, 0)
        if a == b and a[0] == a[1]:
            return (1, 1)
    elif name == "ne":
        if iv_meet(a, b) is None:
            return (1, 1)
        if a == b and a[0] == a[1]:
            return (0, 0)
    elif name == "lt":
        if a[1] < b[0]:
            return (1, 1)
        if a[0] >= b[1]:
            return (0, 0)
    elif name == "le":
        if a[1] <= b[0]:
            return (1, 1)
        if a[0] > b[1]:
            return (0, 0)
    elif name == "gt":
        if a[0] > b[1]:
            return (1, 1)
        if a[1] <= b[0]:
            return (0, 0)
    elif name == "ge":
        if a[0] >= b[1]:
            return (1, 1)
        if a[1] < b[0]:
            return (0, 0)
    return (0, 1)


# ------------------------------------------------------ op classes --
CMP_OPS = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})
#: value-preserving views and copies (and dtype conversions, handled apart)
SHAPE_OPS = frozenset({
    "unsqueeze", "expand", "view", "_unsafe_view", "reshape", "select",
    "slice", "transpose", "t", "permute", "squeeze", "detach", "alias",
    "clone", "flip", "lift_fresh", "lift_fresh_copy", "contiguous",
    "expand_copy", "view_copy", "select_copy", "slice_copy",
    "unsqueeze_copy", "squeeze_copy", "permute_copy", "transpose_copy",
    "repeat", "movedim", "diagonal", "narrow", "unbind", "split",
    "split_with_sizes", "chunk",
})
#: the dtype-preserving value copies a conjunct / case identity chases
COPY_OPS = frozenset({"detach", "alias", "clone", "lift_fresh",
                      "lift_fresh_copy", "_to_copy"})
PICK_OPS = frozenset({"gather", "index", "index_select",
                      "take_along_dim"})
REDUCE_SAME = frozenset({"amax", "amin"})


def _arg(call, i, name=None, default=None):
    if i < len(call.args):
        return call.args[i]
    if name is not None and name in call.kwargs:
        return call.kwargs[name]
    return default


def _dims(x, shape) -> List[int]:
    if x is None:
        return list(range(len(shape)))
    if isinstance(x, int):
        x = [x]
    x = list(x)
    if not x:
        return list(range(len(shape)))
    return [d % max(len(shape), 1) for d in x]


def _count(shape, dims) -> int:
    n = 1
    for d in dims:
        n *= int(shape[d]) if shape else 1
    return max(n, 1)


def op_intervals(tr: tracer.Trace, call: tracer.Call,
                 iv: Callable[[Any], Interval]) -> Optional[List[Interval]]:
    """Interval transfer for one recorded call.

    Pure: the result depends only on the op, its arguments' shapes and
    dtypes, its Python constants and the operand intervals ``iv(arg)``.
    ``None`` for an op the table does not model.  Every result is
    saturated into its output dtype (the no-wrap abstraction)."""
    outs = [tr.vals[v] for v in call.outs]
    if not outs:
        return None
    base = call.opname
    a0 = _arg(call, 0)

    def one(x: Interval) -> List[Interval]:
        return [iv_clamp(x, dtype_bounds(o.dtype)) for o in outs]

    def shape_of(x):
        if isinstance(x, tracer.Ref):
            return tr.vals[x.id].shape
        return ()

    if base == "_to_copy":
        if outs[0].dtype == torch.bool:
            return one(_truth(iv(a0)))
        return one(iv(a0))
    if base in SHAPE_OPS:
        if isinstance(a0, (list, tuple)):
            acc = None
            for t in a0:
                acc = iv(t) if acc is None else iv_join(acc, iv(t))
            return one(acc) if acc is not None else None
        return one(iv(a0))
    if base in PICK_OPS or base in REDUCE_SAME:
        return one(iv(a0))
    if base in ("max", "min") and call.name.endswith((".dim",)):
        dim = _arg(call, 1, "dim", 0)
        n = int(shape_of(a0)[dim]) if shape_of(a0) else 1
        return [iv_clamp(iv(a0), dtype_bounds(outs[0].dtype)),
                iv_clamp((0, n - 1), dtype_bounds(outs[1].dtype))]
    if base in ("max", "min") and len(call.args) == 1:
        return one(iv(a0))
    if base in ("argmax", "argmin"):
        sh = shape_of(a0)
        dim = _arg(call, 1, "dim")
        n = _count(sh, _dims(dim, sh)) if sh else 1
        return one((0, n - 1))
    if base in ("any", "all"):
        return one(_truth(iv(a0)) if tr.vals[a0.id].dtype != torch.bool
                   else iv(a0))
    if base in CMP_OPS:
        return one(_cmp_interval(base, iv(a0), iv(_arg(call, 1))))
    if base in ("where",):
        return None  # the walker refines selects itself
    if base in ("add", "sub", "rsub"):
        a, b = iv(a0), iv(_arg(call, 1))
        alpha = _arg(call, 2, "alpha", 1)
        if alpha != 1:
            b = _corners(b, (alpha, alpha), lambda x, y: x * y)
        if base == "add":
            return one((a[0] + b[0], a[1] + b[1]))
        if base == "sub":
            return one((a[0] - b[1], a[1] - b[0]))
        return one((b[0] - a[1], b[1] - a[0]))
    if base == "mul":
        return one(_wrapping(
            _corners(iv(a0), iv(_arg(call, 1)), lambda x, y: x * y),
            outs[0].dtype))
    if base == "neg":
        lo, hi = iv(a0)
        return one((-hi, -lo))
    if base == "abs":
        lo, hi = iv(a0)
        if lo >= 0:
            return one((lo, hi))
        if hi <= 0:
            return one((-hi, -lo))
        return one((0, max(-lo, hi)))
    if base == "sign":
        lo, hi = iv(a0)
        return one((1 if lo > 0 else (0 if lo >= 0 else -1),
                    -1 if hi < 0 else (0 if hi <= 0 else 1)))
    if base in ("maximum", "clamp_min") and \
            isinstance(_arg(call, 1), (tracer.Ref, int, bool)):
        a, b = iv(a0), iv(_arg(call, 1))
        return one((max(a[0], b[0]), max(a[1], b[1])))
    if base in ("minimum", "clamp_max") and \
            isinstance(_arg(call, 1), (tracer.Ref, int, bool)):
        a, b = iv(a0), iv(_arg(call, 1))
        return one((min(a[0], b[0]), min(a[1], b[1])))
    if base == "clamp":
        x = iv(a0)
        lo_a = _arg(call, 1, "min")
        hi_a = _arg(call, 2, "max")
        if lo_a is not None:
            lo_iv = iv(lo_a)
            x = (max(x[0], lo_iv[0]), max(x[1], lo_iv[1]))
        if hi_a is not None:
            hi_iv = iv(hi_a)
            x = (min(x[0], hi_iv[0]), min(x[1], hi_iv[1]))
        return one(x)
    if base in ("bitwise_not", "logical_not"):
        lo, hi = iv(a0)
        if outs[0].dtype == torch.bool:
            if base == "logical_not":
                lo, hi = _truth((lo, hi))
            return one((1 - hi, 1 - lo))
        return one((-hi - 1, -lo - 1))
    if base in ("logical_and", "logical_or", "logical_xor"):
        (alo, ahi), (blo, bhi) = _truth(iv(a0)), _truth(iv(_arg(call, 1)))
        if base == "logical_and":
            return one((min(alo, blo), min(ahi, bhi)))
        if base == "logical_or":
            return one((max(alo, blo), max(ahi, bhi)))
        return one(_corners((alo, ahi), (blo, bhi), lambda x, y: x ^ y))
    if base in ("bitwise_and", "bitwise_or", "bitwise_xor", "__and__",
                "__or__", "__xor__"):
        op = base.strip("_").replace("bitwise_", "")
        (alo, ahi), (blo, bhi) = iv(a0), iv(_arg(call, 1))
        if outs[0].dtype == torch.bool:
            if op == "and":
                return one((min(alo, blo), min(ahi, bhi)))
            if op == "or":
                return one((max(alo, blo), max(ahi, bhi)))
            return one(_corners((alo, ahi), (blo, bhi),
                                lambda x, y: x ^ y))
        if alo >= 0 and blo >= 0:
            if op == "and":
                return one((0, min(ahi, bhi)))
            mask = (1 << max(int(ahi).bit_length(),
                             int(bhi).bit_length())) - 1
            if op == "or":
                return one((max(alo, blo), mask))
            return one((0, mask))
        return one(dtype_bounds(outs[0].dtype))
    if base in ("__lshift__", "bitwise_left_shift"):
        slo, shi = iv(_arg(call, 1))
        slo, shi = max(slo, 0), min(max(shi, 0), 64)
        return one(_corners(iv(a0), (slo, shi), lambda x, s: x << s))
    if base in ("__rshift__", "bitwise_right_shift"):
        slo, shi = iv(_arg(call, 1))
        slo, shi = max(slo, 0), min(max(shi, 0), 64)
        return one(_corners(iv(a0), (slo, shi), lambda x, s: x >> s))
    if base == "div" and call.name.endswith("Tensor_mode") or \
            base == "floor_divide":
        mode = "floor" if base == "floor_divide" else \
            _arg(call, 2, "rounding_mode")
        b = iv(_arg(call, 1))
        if b[0] <= 0 <= b[1] or mode is None:
            return one(dtype_bounds(outs[0].dtype))
        fn = _tdiv if mode == "trunc" else (lambda x, y: x // y)
        return one(_corners(iv(a0), b, fn))
    if base == "remainder":
        (alo, ahi), (blo, bhi) = iv(a0), iv(_arg(call, 1))
        if blo > 0:
            if alo >= 0 and ahi < blo:
                return one((alo, ahi))
            if alo >= 0:
                return one((0, min(ahi, bhi - 1)))
            return one((0, bhi - 1))
        if bhi < 0:
            return one((blo + 1, 0))
        return one(dtype_bounds(outs[0].dtype))
    if base == "fmod":
        (alo, ahi), (blo, bhi) = iv(a0), iv(_arg(call, 1))
        if blo > 0:
            return one((max(-(bhi - 1), min(alo, 0)),
                        min(bhi - 1, max(ahi, 0))))
        return one(dtype_bounds(outs[0].dtype))
    if base in ("sum", "cumsum", "prod"):
        sh = shape_of(a0)
        lo, hi = iv(a0)
        if base == "prod":
            return one(dtype_bounds(outs[0].dtype))
        if base == "cumsum":
            dim = _arg(call, 1, "dim", 0)
            n = int(sh[dim % len(sh)]) if sh else 1
            return one((min(lo, n * lo), max(hi, n * hi)))
        dims = _arg(call, 1, "dim") if call.name.endswith("dim_IntList") \
            else None
        n = _count(sh, _dims(dims, sh)) if sh else 1
        return one((n * lo if lo < 0 else lo, n * hi if hi > 0 else hi))
    if base in ("cat", "stack"):
        acc = None
        for t in a0:
            acc = iv(t) if acc is None else iv_join(acc, iv(t))
        return one(acc)
    if base in ("sort", "topk"):
        sh = shape_of(a0)
        dim = _arg(call, 1, "dim", -1) if base == "sort" else \
            _arg(call, 2, "dim", -1)
        if base == "sort" and isinstance(dim, bool):
            dim = -1
        n = int(sh[dim % len(sh)]) if sh else 1
        return [iv_clamp(iv(a0), dtype_bounds(outs[0].dtype)),
                iv_clamp((0, n - 1), dtype_bounds(outs[1].dtype))]
    if base == "masked_fill":
        m = iv(_arg(call, 1))
        x, v = iv(a0), iv(_arg(call, 2))
        if m == (0, 0):
            return one(x)
        if m == (1, 1):
            return one(v)
        return one(iv_join(x, v))
    if base in ("scatter", "index_put", "index_copy"):
        val = _arg(call, 3) if base == "scatter" else _arg(call, 2)
        if base == "index_put" and _arg(call, 3, "accumulate", False):
            return None
        return one(iv_join(iv(a0), iv(val)))
    return None


# ------------------------------------------------------------- widening --
def _thresholds(kernel) -> Tuple[List[int], List[int]]:
    g, r, w = kernel.G, kernel.R, kernel.W
    his = sorted({0, 1, 2, g, r, w, w - 1, r - 1, 255, 256,
                  (1 << 8) * (w + 1), 1 << 16, 1 << 30})
    los = sorted({0, -1, -2, -r, -w, -256, -(1 << 16), -(1 << 30)})
    return los, his


def _widen(old: Interval, new: Interval, los: List[int],
           his: List[int], bounds: Interval) -> Interval:
    lo, hi = new
    if lo < old[0]:
        lo = bounds[0]
        for t in reversed(los):
            if t <= new[0]:
                lo = max(t, bounds[0])
                break
    else:
        lo = old[0]
    if hi > old[1]:
        hi2 = bounds[1]
        for t in his:
            if t >= new[1]:
                hi2 = min(t, bounds[1])
                break
        hi = hi2
    else:
        hi = old[1]
    return (lo, hi)


# --------------------------------------------------------------- walker --
class Lit:
    """A Python constant operand of a conjunct."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


_NEGATE = {"eq": "ne", "ne": "eq", "lt": "ge", "le": "gt",
           "gt": "le", "ge": "lt"}
_MIRROR = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
           "eq": "eq", "ne": "ne"}
# conjunct chasing passes through these (bool predicates reshaped)
_PRED_PASS = frozenset({"unsqueeze", "expand", "view", "_unsafe_view",
                        "reshape", "squeeze", "detach", "alias", "clone",
                        "_to_copy", "lift_fresh"})


def _is_scalar(x) -> bool:
    return isinstance(x, (bool, int, float)) and not isinstance(x, tracer.Ref)


class _Walker:
    """One interval (+ optional relational) pass over one branch trace.

    Abstract values are ``(interval, lbs, ubs)``; in relational mode
    ``lbs`` / ``ubs`` are frozensets of bound witnesses: pre-state leaf
    tokens ``"leaf:<name>"`` and ``(tag, value id)`` tokens for
    intermediates."""

    def __init__(self, tr: tracer.Trace, rel: bool = False, tag: int = 0,
                 unmodeled: Optional[set] = None):
        self.tr = tr
        self.rel = rel
        self.tag = tag
        self.env: Dict[int, Tuple] = {}
        self.unmodeled = unmodeled if unmodeled is not None else set()

    # -- env helpers -----------------------------------------------------
    def _const_val(self, v: tracer.Val) -> Tuple:
        if v.tensor is not None:
            return (const_interval(v), _NO_REL[0], _NO_REL[1])
        return (dtype_bounds(v.dtype), _NO_REL[0], _NO_REL[1])

    def _get(self, vid: int) -> Tuple:
        val = self.env.get(vid)
        if val is None:
            v = self.tr.vals[vid]
            val = self._const_val(v) if v.kind != "input" else \
                (dtype_bounds(v.dtype), _NO_REL[0], _NO_REL[1])
            self.env[vid] = val
        return val

    def read(self, x) -> Tuple:
        if isinstance(x, tracer.Ref):
            val = self._get(x.id)
            if not self.rel:
                return val
            r = (self.tag, x.id)
            lbs, ubs = val[1], val[2]
            if len(lbs) < _REL_CAP:
                lbs = lbs | {r}
            if len(ubs) < _REL_CAP:
                ubs = ubs | {r}
            return (val[0], lbs, ubs)
        if isinstance(x, bool):
            return ((int(x), int(x)), _NO_REL[0], _NO_REL[1])
        if isinstance(x, (int, float)):
            return ((x, x), _NO_REL[0], _NO_REL[1])
        return ((-_FINF, _FINF), _NO_REL[0], _NO_REL[1])

    def iv(self, x) -> Interval:
        return self.read(x)[0] if x is not None else (-_FINF, _FINF)

    def run(self, in_vals: Dict[int, Tuple]) -> Dict[int, Tuple]:
        self.env.update(in_vals)
        for call in self.tr.calls:
            if call.sync or not call.outs:
                continue
            outs = self._transfer(call)
            for vid, t in zip(call.outs, outs):
                self.env[vid] = t
        return self.env

    # -- predicate structure (where refinement) ----------------------------
    def _def(self, vid: int):
        c = self.tr.vals[vid].call
        return None if c is None else self.tr.calls[c]

    def _base(self, x):
        """Chase a value through value-preserving copies and dtype
        conversions so ``convert(x)`` still matches ``x``."""
        if not isinstance(x, tracer.Ref):
            return x
        key = ("base", x.id)
        hit = self.tr.memo.get(key)
        if hit is None:
            hit = self.tr.memo[key] = self._base_chase(x)
        return hit

    def _base_chase(self, x):
        for _ in range(64):
            if not isinstance(x, tracer.Ref):
                return x
            v = self.tr.vals[x.id]
            if v.tensor is not None:
                return x
            c = self._def(x.id)
            if c is None or c.opname not in COPY_OPS:
                return x
            nxt = c.args[0]
            if not isinstance(nxt, tracer.Ref):
                return x
            x = nxt
        return x

    def _conjuncts(self, x):
        """Comparison conjuncts implied wherever ``x`` is true, as
        ``(conjs, pure)``; ``pure`` when ``x`` is one comparison."""
        if not isinstance(x, tracer.Ref):
            return [], False
        key = ("conj", x.id)
        hit = self.tr.memo.get(key)
        if hit is None:
            hit = self.tr.memo[key] = self._conj_chase(x, 0)
        return hit

    def _conj_chase(self, x, depth: int):
        if depth > 24 or not isinstance(x, tracer.Ref):
            return [], False
        c = self._def(x.id)
        if c is None:
            return [], False
        p = c.opname
        if p in ("bitwise_and", "logical_and", "__and__") and \
                self.tr.vals[x.id].dtype == torch.bool:
            a, _ = self._conj_chase(c.args[0], depth + 1)
            b, _ = self._conj_chase(c.args[1], depth + 1)
            return a + b, False
        if p == "all":
            a, _ = self._conj_chase(c.args[0], depth + 1)
            return a, False
        if p in _PRED_PASS:
            return self._conj_chase(c.args[0], depth + 1)
        if p == "ne":
            lhs, rhs = c.args[0], c.args[1]
            if _is_scalar(rhs) and rhs == 0 and \
                    isinstance(lhs, tracer.Ref) and \
                    self.tr.vals[lhs.id].dtype == torch.bool:
                return self._conj_chase(lhs, depth + 1)
        if p in CMP_OPS:
            return [(p, self._operand(c.args[0]),
                     self._operand(c.args[1]))], True
        return [], False

    def _operand(self, x):
        if isinstance(x, tracer.Ref):
            return self._base(x)
        return Lit(x)

    def _iv_of(self, x) -> Interval:
        if isinstance(x, Lit):
            v = x.value
            return (int(v), int(v)) if isinstance(v, bool) else (v, v)
        return self._get(x.id)[0]

    @staticmethod
    def _refine(civ: Interval, cmpn: str, left: bool,
                other: Interval) -> Optional[Interval]:
        lo, hi = civ
        olo, ohi = other
        if not left:
            cmpn = _MIRROR[cmpn]
        if cmpn == "ge":
            lo = max(lo, olo)
        elif cmpn == "gt":
            lo = max(lo, olo + 1)
        elif cmpn == "le":
            hi = min(hi, ohi)
        elif cmpn == "lt":
            hi = min(hi, ohi - 1)
        elif cmpn == "eq":
            lo, hi = max(lo, olo), min(hi, ohi)
        return None if lo > hi else (lo, hi)

    def _refined_case(self, case_arg, idx: int, civ: Interval, conjs,
                      pure: bool) -> Optional[Interval]:
        """Refine case ``idx`` (0 = the false case) of a select by the
        predicate's conjuncts: every conjunct holds on the true branch;
        only a pure single comparison negates onto the false branch."""
        if not isinstance(case_arg, tracer.Ref):
            return civ
        case_v = self._base(case_arg)
        use = conjs
        if idx == 0:
            if not (pure and len(conjs) == 1):
                return civ
            n, a, b = conjs[0]
            use = [(_NEGATE[n], a, b)]
        out = civ
        for (cmpn, a, b) in use:
            if cmpn == "ne":
                continue
            if isinstance(a, tracer.Ref) and a.id == getattr(case_v, "id",
                                                             None):
                out2 = self._refine(out, cmpn, True, self._iv_of(b))
            elif isinstance(b, tracer.Ref) and b.id == getattr(case_v, "id",
                                                               None):
                out2 = self._refine(out, cmpn, False, self._iv_of(a))
            else:
                continue
            if out2 is None:
                return None
            out = out2
        return out

    # -- transfer --------------------------------------------------------
    def _transfer(self, call: tracer.Call) -> List[Tuple]:
        outs = [self.tr.vals[v] for v in call.outs]
        if outs[0].tensor is not None:
            return [self._const_val(o) for o in outs]
        base = call.opname

        def tops():
            return [(dtype_bounds(o.dtype), _NO_REL[0], _NO_REL[1])
                    for o in outs]

        if base == "where" and call.name.endswith(".self"):
            pred = self.read(call.args[0])
            cases = [call.args[2], call.args[1]]  # [false, true]
            cvals = [self.read(c) for c in cases]
            piv = pred[0]
            idxs = [i for i in range(2) if piv[0] <= i <= piv[1]] or [0, 1]
            conjs, pure = ([], False)
            if len(idxs) > 1:
                conjs, pure = self._conjuncts(call.args[0])
            ivs = []
            for i in idxs:
                civ = cvals[i][0]
                if conjs or pure:
                    civ = self._refined_case(cases[i], i, civ, conjs, pure)
                if civ is not None:
                    ivs.append(civ)
            if not ivs:
                ivs = [cvals[i][0] for i in idxs]
            acc = ivs[0]
            for x in ivs[1:]:
                acc = iv_join(acc, x)
            acc = iv_clamp(acc, dtype_bounds(outs[0].dtype))
            lbs = ubs = frozenset()
            if self.rel:
                shp = outs[0].shape
                sets = [cvals[i] if self._same_shape(cases[i], shp)
                        else (None, frozenset(), frozenset())
                        for i in idxs]
                lbs = frozenset.intersection(*[s[1] for s in sets])
                ubs = frozenset.intersection(*[s[2] for s in sets])
            return [(acc, lbs, ubs)]

        ivs = op_intervals(self.tr, call, self.iv)
        if ivs is None:
            self.unmodeled.add(call.name)
            return tops()
        rels = [_NO_REL] * len(outs)
        if self.rel:
            rels = [self._rel_transfer(call, base)] * len(outs)
        return [(x, r[0], r[1]) for x, r in zip(ivs, rels)]

    def _same_shape(self, x, shape) -> bool:
        return isinstance(x, tracer.Ref) and \
            self.tr.vals[x.id].shape == shape

    def _rel_transfer(self, call, base) -> Tuple[FrozenSet, FrozenSet]:
        """Bound-witness propagation for the order-preserving ops, on
        elementwise operands of the output's shape (a broadcast operand
        carries no witnesses)."""
        shp = self.tr.vals[call.outs[0]].shape

        def sets(x):
            if isinstance(x, tracer.Ref) and self._same_shape(x, shp):
                v = self.read(x)
                return v[0], v[1], v[2]
            return self.read(x)[0], frozenset(), frozenset()

        a0 = call.args[0] if call.args else None
        if base in ("maximum", "minimum") or (
                base in ("clamp_min", "clamp_max")):
            (_, al, au), (_, bl, bu) = sets(a0), sets(call.args[1])
            if base in ("maximum", "clamp_min"):
                return (al | bl, au & bu)
            return (al & bl, au | bu)
        if base == "clamp":
            _, xl, xu = sets(a0)
            lo_a = _arg(call, 1, "min")
            hi_a = _arg(call, 2, "max")
            if lo_a is not None:
                _, ml, mu = sets(lo_a)
                xl, xu = xl | ml, xu & mu
            if hi_a is not None:
                _, hl, hu = sets(hi_a)
                xl, xu = xl & hl, xu | hu
            return (xl, xu)
        if base in ("_to_copy", "clone", "detach", "alias") and \
                isinstance(a0, tracer.Ref):
            if self.tr.vals[call.outs[0]].dtype == torch.bool:
                return _NO_REL
            _, l, u = sets(a0)
            return (l, u)
        if base == "add" and _arg(call, 2, "alpha", 1) == 1:
            (aiv, albs, aubs), (biv, blbs, bubs) = sets(a0), \
                sets(call.args[1])
            lbs, ubs = frozenset(), frozenset()
            if biv[0] >= 0:
                lbs |= albs
            if biv[1] <= 0:
                ubs |= aubs
            if aiv[0] >= 0:
                lbs |= blbs
            if aiv[1] <= 0:
                ubs |= bubs
            return (lbs, ubs)
        if base == "sub" and _arg(call, 2, "alpha", 1) == 1:
            (_, albs, aubs), (biv, _, _) = sets(a0), sets(call.args[1])
            lbs, ubs = frozenset(), frozenset()
            if biv[1] <= 0:
                lbs |= albs
            if biv[0] >= 0:
                ubs |= aubs
            return (lbs, ubs)
        return _NO_REL


# --------------------------------------------------------- kernel driver --
@dataclasses.dataclass(frozen=True)
class RangeAnalysis:
    """Proven inductive invariants for one kernel instance."""

    #: state leaf -> (lo, hi), inclusive, in the leaf's logical dtype
    invariants: Dict[str, Interval]
    #: elementwise pairwise facts (x, y) meaning x <= y
    pairs: Tuple[Tuple[str, str], ...]
    #: outer widening/narrowing rounds it took
    iterations: int
    #: state leaf -> (lo, hi) over the port's int32 representation
    internal: Dict[str, Interval] = dataclasses.field(default_factory=dict)
    #: overloads the transfer table does not model (given ⊤)
    unmodeled: Tuple[str, ...] = ()

    def as_json(self) -> dict:
        out = {
            "invariants": {
                k: [int(v[0]), int(v[1])]
                for k, v in sorted(self.invariants.items())
            },
            "pairs": [[a, b] for a, b in self.pairs],
            "iterations": self.iterations,
        }
        if self.unmodeled:
            out["unmodeled"] = list(self.unmodeled)
        return out


_RANGE_CACHE: Dict[Tuple, RangeAnalysis] = {}


def _init_intervals(kernel, state_keys) -> Dict[str, Interval]:
    out: Dict[str, Interval] = {}
    for seed in INIT_SEEDS:
        st = telemetry.attach(
            kernel.init_state(seed=seed), kernel.G, kernel.R
        )
        for k in state_keys:
            iv = tensor_interval(st[k])
            out[k] = iv if k not in out else iv_join(out[k], iv)
    return out


def _in_vals(tr: tracer.Trace, cur: Dict[str, Interval],
             rel_seed: Optional[Dict[str, Tuple]] = None
             ) -> Dict[int, Tuple]:
    vals = {}
    for tree, leaf, vid in tr.inputs:
        bounds = dtype_bounds(tr.vals[vid].dtype)
        if tree == 0 and leaf in cur:
            rel = (rel_seed or {}).get(leaf, _NO_REL)
            vals[vid] = (iv_clamp(cur[leaf], bounds), rel[0], rel[1])
        else:
            # inbox and step-input leaves: ⊤ within dtype bounds
            vals[vid] = (bounds, _NO_REL[0], _NO_REL[1])
    return vals


def _state_out(tr: tracer.Trace, env) -> Dict[str, Tuple]:
    return {leaf: env_get(env, tr, vid)
            for tree, leaf, vid in tr.outputs if tree == 0}


def env_get(env, tr, vid):
    val = env.get(vid)
    if val is None:
        v = tr.vals[vid]
        if v.tensor is not None:
            return (const_interval(v), _NO_REL[0], _NO_REL[1])
        return (dtype_bounds(v.dtype), _NO_REL[0], _NO_REL[1])
    return val


def _step_intervals(st: tracer.StepTrace, cur: Dict[str, Interval],
                    unmodeled: Optional[set] = None
                    ) -> Dict[str, Interval]:
    res: Dict[str, Interval] = {}
    for tr in st.branches:
        w = _Walker(tr, rel=False, unmodeled=unmodeled)
        env = w.run(_in_vals(tr, cur))
        for leaf, val in _state_out(tr, env).items():
            res[leaf] = val[0] if leaf not in res else \
                iv_join(res[leaf], val[0])
    return res


def analyze_kernel_ranges(kernel) -> RangeAnalysis:
    """Phase 1+2: inductive per-leaf intervals and pairwise facts."""
    key = tracer.trace_key(kernel)
    hit = _RANGE_CACHE.get(key)
    if hit is not None:
        return hit
    st = trace_step(kernel)
    state_keys = sorted(st.state.keys())
    init_iv = _init_intervals(kernel, state_keys)
    dtype_top = {k: dtype_bounds(v.dtype) for k, v in st.state.items()}
    los, his = _thresholds(kernel)
    unmodeled: set = set()

    cur = dict(init_iv)
    rounds = 0
    for it in range(_OUTER_CAP):
        rounds = it + 1
        step = _step_intervals(st, cur, unmodeled)
        nxt = {k: iv_join(cur[k], step.get(k, cur[k])) for k in cur}
        if nxt == cur:
            break
        if it >= 2:
            nxt = {
                k: _widen(cur[k], nxt[k], los, his,
                          dtype_top.get(k, (-_FINF, _FINF)))
                for k in cur
            }
        cur = nxt
    else:
        raise RuntimeError(
            f"{kernel.name}: range fixpoint did not converge in "
            f"{_OUTER_CAP} rounds"
        )

    cand = dict(cur)
    for _ in range(_NARROW_ROUNDS):
        step = _step_intervals(st, cand)
        nar = {k: iv_join(init_iv[k], step.get(k, cand[k])) for k in cand}
        if nar == cand:
            break
        cand = nar
        rounds += 1
    step = _step_intervals(st, cand)
    inductive = all(
        iv_leq(init_iv[k], cand[k]) and iv_leq(step.get(k, cand[k]),
                                               cand[k])
        for k in cand
    )
    final = cand if inductive else cur
    if not inductive:
        step = _step_intervals(st, cur)
        if not all(
            iv_leq(init_iv[k], cur[k]) and iv_leq(step.get(k, cur[k]),
                                                  cur[k])
            for k in cur
        ):  # pragma: no cover - analysis bug guard
            raise RuntimeError(
                f"{kernel.name}: widened fixpoint failed its own "
                "inductiveness re-check"
            )

    final, t_rounds = _tighten(st, init_iv, final)
    rounds += t_rounds

    pairs = _pair_facts(kernel, st, final)
    res = RangeAnalysis(
        invariants={k: logical_interval(k, v) for k, v in final.items()},
        pairs=pairs, iterations=rounds, internal=dict(final),
        unmodeled=tuple(sorted(unmodeled)),
    )
    _RANGE_CACHE[key] = res
    return res


def _tighten(st, init_iv, proven, max_rounds: int = 64):
    """Coinductive per-side tightening after the widening fixpoint (the
    JAX prover's ``_tighten``): propose the init bound on every side the
    fixpoint left weaker, revert any side one abstract step refutes."""
    cand = {}
    for k, (plo, phi) in proven.items():
        ilo, ihi = init_iv[k]
        cand[k] = (max(plo, ilo), min(phi, ihi))
    if cand == dict(proven):
        return dict(proven), 0
    for it in range(max_rounds):
        step = _step_intervals(st, cand)
        changed = False
        for k, (clo, chi) in list(cand.items()):
            slo, shi = step.get(k, cand[k])
            nlo = proven[k][0] if slo < clo else clo
            nhi = proven[k][1] if shi > chi else chi
            if (nlo, nhi) != (clo, chi):
                cand[k] = (nlo, nhi)
                changed = True
        if not changed:
            return cand, it + 1
    return dict(proven), max_rounds


def _pair_facts(kernel, st, invariants) -> Tuple[Tuple[str, str], ...]:
    """Octagon-lite pairwise ``x <= y`` facts over the [G, R] signed
    int32 leaves, by greatest-fixpoint candidate removal; a fact survives
    a round only if every branch trace re-establishes it."""
    gr = (kernel.G, kernel.R)
    cand_leaves = sorted(
        k for k, v in st.state.items()
        if tuple(v.shape) == gr and v.dtype == torch.int32
        and k not in UINT32_LEAVES
    )
    if len(cand_leaves) < 2:
        return ()
    inits = []
    for seed in INIT_SEEDS:
        s0 = telemetry.attach(kernel.init_state(seed=seed), kernel.G,
                              kernel.R)
        inits.append({k: s0[k] for k in cand_leaves})
    assumed = {
        (x, y)
        for x in cand_leaves for y in cand_leaves if x != y
        if all(bool(torch.all(s0[x] <= s0[y])) for s0 in inits)
    }

    def closure(rel):
        c = set(rel)
        changed = True
        while changed:
            changed = False
            for (a, b) in list(c):
                for (b2, d) in list(c):
                    if b2 == b and (a, d) not in c and a != d:
                        c.add((a, d))
                        changed = True
        return c

    while assumed:
        cl = closure(assumed)
        rel_seed = {}
        for leaf in cand_leaves:
            tok = "leaf:" + leaf
            lbs = {tok} | {"leaf:" + a for (a, b) in cl if b == leaf}
            ubs = {tok} | {"leaf:" + b for (a, b) in cl if a == leaf}
            rel_seed[leaf] = (frozenset(lbs), frozenset(ubs))
        ok_tokens = {("leaf:" + a, "leaf:" + b) for (a, b) in cl}
        kept = set(assumed)
        for bi, tr in enumerate(st.branches):
            w = _Walker(tr, rel=True, tag=bi)
            env = w.run(_in_vals(tr, invariants, rel_seed))
            outs = {leaf: env_get(env, tr, vid)
                    for tree, leaf, vid in tr.outputs if tree == 0}
            out_tok = {leaf: (bi, vid)
                       for tree, leaf, vid in tr.outputs if tree == 0}

            def survives(x, y):
                ox, oy = outs[x], outs[y]
                # the output value itself witnesses both of its bounds
                ubs_x = ox[2] | {out_tok[x]}
                lbs_y = oy[1] | {out_tok[y]}
                for z in ubs_x:
                    for v in lbs_y:
                        if z == v or (z, v) in ok_tokens:
                            return True
                return False

            kept = {(x, y) for (x, y) in kept if survives(x, y)}
        if kept == assumed:
            break
        assumed = kept
    return tuple(sorted(assumed))


# ---------------------------------------------------------- claims / R2 --
def check_claims(kernel, analysis: RangeAnalysis) -> List[Tuple[str, str]]:
    """Inductiveness check for each ``RANGE_CLAIMS`` entry; returns
    (leaf, reason) per violated claim (R2 material).  Claims are stated
    in the leaf's logical dtype."""
    claims = getattr(kernel, "RANGE_CLAIMS", ()) or ()
    if not claims:
        return []
    st = trace_step(kernel)
    init_log = {k: logical_interval(k, v) for k, v in
                _init_intervals(kernel, sorted(st.state.keys())).items()}
    bad: List[Tuple[str, str]] = []
    for leaf, lo, hi in claims:
        claim = (int(lo), int(hi))
        if leaf not in init_log:
            bad.append((leaf, f"claimed leaf {leaf!r} is not a state leaf"))
            continue
        if not iv_leq(init_log[leaf], claim):
            bad.append((leaf, (
                f"claim [{lo}, {hi}] does not hold at init_state: "
                f"init interval is {list(init_log[leaf])}"
            )))
            continue
        if iv_leq(analysis.invariants[leaf], claim):
            continue
        seeded = dict(analysis.internal)
        m = iv_meet(seeded[leaf], claim)
        seeded[leaf] = m if m is not None else claim
        step = _step_intervals(st, seeded)
        got = logical_interval(leaf, step.get(leaf, seeded[leaf]))
        if not iv_leq(got, claim):
            bad.append((leaf, (
                f"claim [{lo}, {hi}] is not inductive: one abstract "
                f"step from the claimed interval reaches "
                f"{[int(got[0]), int(got[1])]}"
            )))
    return bad


# ------------------------------------------------------------ entrypoint --
def variant_analyses(make_protocol, name: str, device=None
                     ) -> List[Tuple[str, Any, RangeAnalysis]]:
    """(variant, kernel, analysis) for every config variant that differs."""
    return [(v, k, analyze_kernel_ranges(k))
            for v, k in kernel_variants(make_protocol, name, device=device)]


def verify_kernel_ranges(make_protocol, name: str, device=None
                         ) -> PassResult:
    """Range-proof pass for one kernel: the invariants per config variant
    (serialized into the report extra) and every RANGE_CLAIMS check
    (violations are R2 findings)."""
    res = PassResult()
    try:
        variants = {}
        seen = set()
        for vname, kernel, ra in variant_analyses(make_protocol, name,
                                                  device=device):
            variants[vname] = ra.as_json()
            for leaf, reason in check_claims(kernel, ra):
                f = rule_finding(
                    "R2", kernel.name, leaf,
                    f"RANGE_CLAIMS[{leaf!r}]: {reason}",
                )
                if f.fingerprint not in seen:
                    seen.add(f.fingerprint)
                    res.findings.append(f)
        res.extra["variants"] = variants
    except Exception as e:
        res.error = f"{type(e).__name__}: {e}"
    return res
