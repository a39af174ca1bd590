"""Record one kernel ``step`` as a flat aten trace: the analysis plane's
counterpart of ``jax.make_jaxpr``.

The step runs once on real tensors on the kernel's device under a
``TorchDispatchMode`` that logs every aten call it reaches.  ``make_fx``
cannot take the port's steps (a host-checked gate reads a bool off the
device and branches on it), and ``torch.export`` refuses such branches
too, so the trace is recorded here instead.

- **Values.** Every tensor the step touches is a :class:`Val`: an input
  leaf named ``(tree, leaf)`` (tree 0/1/2 = state/inbox/inputs), a
  constant the step did not make (a kernel's prebuilt tensors, wrapped
  Python scalars; its concrete value is kept), or the output of a call.
  A view records the value it views (``base``).
- **Calls.** Each :class:`Call` holds the op overload, its arguments
  (:class:`Ref` for tensors, Python constants as they are), its output
  value ids, the phase it ran in (``phase_scope`` tags it while the
  trace records, changing nothing else) and the ids it wrote in place.
- **Host syncs.** A ``_local_scalar_dense`` is a sync call.  The step is
  re-run once per assignment of forced outcomes to the bool syncs of the
  first run (``2 ** k`` branch traces), so every branch's op sequence is
  recorded; the passes join over the branches.
- **Outputs.** ``outputs`` names every leaf of the returned state /
  outbox / effects as ``(tree, leaf)`` (tree 0/1/2) with its value id.

Traces are cached per ``(class, G, R, W, config repr, device)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import protocol as protocol_mod
from ..core import telemetry

SYNC_OPS = frozenset({"aten._local_scalar_dense.default"})

#: ops whose value does not depend on their tensor arguments (if any):
#: their outputs are recorded as constants with the concrete value
FACTORY_LIKE = frozenset({"zeros_like", "ones_like", "full_like"})

#: a step with more bool host reads than this is refused: its branch
#: traces (2 ** k) would not stay cheap
MAX_BRANCH_SYNCS = 6


@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor argument of a call: the id of its value."""

    id: int


@dataclasses.dataclass
class Val:
    id: int
    dtype: torch.dtype
    shape: Tuple[int, ...]
    kind: str  # "input" | "const" | "op"
    leaf: Optional[Tuple[int, str]] = None
    call: Optional[int] = None
    base: Optional[int] = None
    tensor: Optional[torch.Tensor] = None  # consts: the concrete value
    _iv: Optional[Tuple[Any, Any]] = dataclasses.field(default=None,
                                                      repr=False)

    def const_interval(self) -> Tuple[Any, Any]:
        """``(min, max)`` of a constant's value (read once, then cached:
        on the card each read is a device sync)."""
        if self._iv is None:
            t = self.tensor
            if t.numel() == 0:
                self._iv = (None, None)
            else:
                a = t.to(torch.int64) if t.dtype == torch.bool else t
                lo, hi = a.min().item(), a.max().item()
                self._iv = (lo, hi) if a.dtype.is_floating_point else \
                    (int(lo), int(hi))
        return self._iv


@dataclasses.dataclass
class Call:
    idx: int
    name: str  # "aten.where.self"
    op: Any
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    outs: Tuple[int, ...]
    phase: str
    writes: Tuple[int, ...] = ()  # value ids written in place / out=
    sync: bool = False
    forced: Optional[bool] = None  # a branched sync's forced outcome

    opname: str = ""  # "aten.add.Tensor" -> "add"

    def __post_init__(self):
        self.opname = self.name.split(".")[1]


@dataclasses.dataclass
class Trace:
    """One branch's recorded step."""

    vals: List[Val]
    calls: List[Call]
    inputs: List[Tuple[int, str, int]]   # (tree, leaf, value id)
    outputs: List[Tuple[int, str, int]]  # (tree, leaf, value id)
    forced: Tuple[bool, ...] = ()
    # per-trace memo of structure-only facts the passes derive (select
    # conjuncts, copy-chain bases): they depend on the trace, not on the
    # abstract values
    memo: Dict[Any, Any] = dataclasses.field(default_factory=dict,
                                             repr=False)

    def input_ids(self) -> Dict[int, Tuple[int, str]]:
        return {vid: (t, leaf) for t, leaf, vid in self.inputs}

    def root(self, vid: int) -> int:
        """The value a view chain starts from."""
        seen = 0
        while self.vals[vid].base is not None and seen < 256:
            vid = self.vals[vid].base
            seen += 1
        return vid


@dataclasses.dataclass
class StepTrace:
    """Every branch trace of one step, plus what the trace ran against."""

    branches: List[Trace]
    state: Dict[str, torch.Tensor]    # the telemetry-attached input state
    out_meta: Dict[Tuple[int, str], Tuple[Tuple[int, ...], torch.dtype,
                                          torch.device]]
    n_syncs: int


def _op_name(func) -> str:
    ns = getattr(func, "namespace", "aten")
    return f"{ns}.{func._opname}.{func._overloadname}"


def _written_args(func, args, kwargs) -> List[Any]:
    """The tensors an op writes (in-place ``self`` or ``out=``)."""
    out = []
    schema = getattr(func, "_schema", None)
    if schema is None:
        return out
    for i, a in enumerate(schema.arguments):
        info = a.alias_info
        if info is None or not info.is_write:
            continue
        if a.kwarg_only or i >= len(args):
            v = kwargs.get(a.name)
        else:
            v = args[i]
        vs = v if isinstance(v, (list, tuple)) else (v,)
        out.extend(t for t in vs if isinstance(t, torch.Tensor))
    return out


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flat(x)
        else:
            yield x


class _Recorder(TorchDispatchMode):
    def __init__(self, forced: Tuple[bool, ...]):
        super().__init__()
        self.vals: List[Val] = []
        self.calls: List[Call] = []
        self.ids: Dict[int, int] = {}
        self.keep: List[torch.Tensor] = []
        self.forced = forced
        self.n_bool_syncs = 0
        self.phases: List[str] = []

    # -- phase tags ----------------------------------------------------------
    @contextlib.contextmanager
    def phase_ctx(self, name: str):
        self.phases.append(name)
        try:
            yield
        finally:
            self.phases.pop()

    @property
    def phase(self) -> str:
        return self.phases[-1] if self.phases else ""

    # -- values --------------------------------------------------------------
    def _new(self, t: torch.Tensor, kind: str, **kw) -> int:
        vid = len(self.vals)
        self.vals.append(Val(vid, t.dtype, tuple(t.shape), kind, **kw))
        self.ids[id(t)] = vid
        self.keep.append(t)
        return vid

    def add_input(self, t: torch.Tensor, tree: int, leaf: str) -> int:
        return self._new(t, "input", leaf=(tree, leaf))

    def ref(self, t: torch.Tensor) -> int:
        vid = self.ids.get(id(t))
        if vid is None:
            vid = self._new(t, "const", tensor=t.detach().clone())
        return vid

    def _wrap(self, x):
        if isinstance(x, torch.Tensor):
            return Ref(self.ref(x))
        if isinstance(x, (list, tuple)):
            return type(x)(self._wrap(v) for v in x)
        return x

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_name(func)
        wargs = self._wrap(tuple(args))
        wkw = {k: self._wrap(v) for k, v in kwargs.items()}
        if name in SYNC_OPS:
            t = args[0]
            forced = None
            if t.dtype == torch.bool:
                k = self.n_bool_syncs
                self.n_bool_syncs += 1
                if k < len(self.forced):
                    forced = bool(self.forced[k])
            self.calls.append(Call(len(self.calls), name, func, wargs, wkw,
                                   (), self.phase, sync=True,
                                   forced=forced))
            if forced is not None:
                return forced
            return func(*args, **kwargs)
        written = _written_args(func, args, kwargs)
        out = func(*args, **kwargs)
        factory = not written and "empty" not in name and (
            func._opname in FACTORY_LIKE
            or not any(isinstance(r, Ref) for r in _flat(wargs))
            and not any(isinstance(r, Ref) for r in _flat(wkw.values()))
        )
        outs = []
        flat = out if isinstance(out, (list, tuple)) else (out,)
        idx = len(self.calls)
        wids = tuple(self.ids.get(id(t), -1) for t in written)
        for t in flat:
            if not isinstance(t, torch.Tensor):
                continue
            base = None
            if t._base is not None:
                base = self.ids.get(id(t._base))
            # an in-place result is the same object with a new value
            outs.append(self._new(
                t, "op", call=idx, base=base,
                tensor=t.detach().clone() if factory else None,
            ))
        self.calls.append(Call(idx, name, func, wargs, wkw, tuple(outs),
                               self.phase, writes=wids))
        return out


def _record(kernel, state, inbox, inputs, forced: Tuple[bool, ...]):
    rec = _Recorder(forced)
    st = {k: v.clone() for k, v in state.items()}
    ib = {k: v.clone() for k, v in inbox.items()}
    ins = {k: v.clone() for k, v in inputs.items()}
    inputs_named = []
    for tree, d in ((0, st), (1, ib), (2, ins)):
        for k in sorted(d):
            inputs_named.append((tree, k, rec.add_input(d[k], tree, k)))
    prev = protocol_mod._PHASE_TAGGER
    protocol_mod._PHASE_TAGGER = rec.phase_ctx
    try:
        with rec:
            s2, out, fx = kernel.step(st, ib, ins)
    finally:
        protocol_mod._PHASE_TAGGER = prev
    outputs = []
    meta = {}

    def name_out(tree, leaf, t):
        vid = rec.ref(t)
        outputs.append((tree, leaf, vid))
        meta[(tree, leaf)] = (tuple(t.shape), t.dtype, t.device)

    for k in sorted(s2):
        name_out(0, k, s2[k])
    for k in sorted(out):
        name_out(1, k, out[k])
    name_out(2, "commit_bar", fx.commit_bar)
    name_out(2, "exec_bar", fx.exec_bar)
    for k in sorted(fx.extra):
        name_out(2, k, fx.extra[k])
    tr = Trace(rec.vals, rec.calls, inputs_named, outputs, tuple(forced))
    return tr, meta, rec.n_bool_syncs


_TRACE_CACHE: Dict[Tuple, StepTrace] = {}


def trace_key(kernel) -> Tuple:
    return (type(kernel), kernel.G, kernel.R, kernel.W,
            repr(getattr(kernel, "config", None)), str(kernel.device))


def record_step(kernel, inputs: Dict[str, torch.Tensor]) -> StepTrace:
    """Every branch trace of one ``kernel.step`` from its seed-0 boot
    state (telemetry attached), an all-invalid inbox and ``inputs``."""
    key = trace_key(kernel)
    hit = _TRACE_CACHE.get(key)
    if hit is not None:
        return hit
    state = telemetry.attach(kernel.init_state(seed=0), kernel.G, kernel.R)
    inbox = kernel.zero_outbox()
    first, meta, k = _record(kernel, state, inbox, inputs, ())
    if k > MAX_BRANCH_SYNCS:
        raise RuntimeError(
            f"{kernel.name}: {k} bool host reads in one step (at most "
            f"{MAX_BRANCH_SYNCS} are branched on)"
        )
    branches = []
    if k == 0:
        branches = [first]
    else:
        for bits in itertools.product((False, True), repeat=k):
            tr, m2, _ = _record(kernel, state, inbox, inputs, bits)
            if m2 != meta:
                raise RuntimeError(
                    f"{kernel.name}: branch {bits} returns other leaves "
                    "than the first run"
                )
            branches.append(tr)
    hit = _TRACE_CACHE[key] = StepTrace(branches, state, meta, k)
    return hit
