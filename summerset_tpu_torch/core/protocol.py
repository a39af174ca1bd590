"""Protocol SPI for vectorized lockstep consensus kernels, counterpart of
``summerset_tpu/core/protocol.py``.

A :class:`ProtocolKernel` holds static geometry and config; all dynamic
data lives in a dict of tensors.  ``step`` advances every replica of
every group by one lockstep tick and never updates a tensor in place:
the engine keeps the pre-tick state for the pause freeze.

Phases run under ``torch.profiler.record_function`` with the same
``graftphase__`` names the JAX package gives its named scopes, so a
profiler trace attributes time to the same phases.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

import torch

from ..device import resolve_device
from . import telemetry

State = Dict[str, torch.Tensor]

PHASE_SCOPE_PREFIX = "graftphase__"

_PHASE_SCOPES_ENABLED = True

#: set by the analysis plane's tracer (``analysis/tracer.py``) while it
#: records one step: ``phase_scope`` then returns the tracer's context,
#: which tags every recorded op with its phase and changes nothing else
_PHASE_TAGGER: Optional[Callable[[str], Any]] = None


def set_phase_scopes(enabled: bool) -> None:
    """Enable/disable the phase ranges globally (the profiling plane's
    instrumentation ablation; default on)."""
    global _PHASE_SCOPES_ENABLED
    _PHASE_SCOPES_ENABLED = bool(enabled)


def phase_scopes_enabled() -> bool:
    return _PHASE_SCOPES_ENABLED


def phase_scope(name: str):
    """The profiler range a declared phase runs under: recorded while a
    profiler is on, a no-op context otherwise (a range costs ~9 us of host
    time even with no profiler listening) and when the phase ranges are
    ablated away."""
    if _PHASE_TAGGER is not None:
        return _PHASE_TAGGER(name)
    if _PHASE_SCOPES_ENABLED and torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(PHASE_SCOPE_PREFIX + name)
    return contextlib.nullcontext()


#: The kernel SPI contract, numbered and checked by the analysis plane
#: (``analysis/``, ``python -m summerset_tpu_torch.graftlint``, baseline
#: ``summerset_tpu_torch/LINT.json``).  The codes and rules are the JAX
#: package's; where its table says "jaxpr" the port reads "the recorded
#: aten trace" of one step (``analysis/tracer.py``).
KERNEL_CONTRACT: Tuple[Tuple[str, str, str], ...] = (
    ("C1", "state-geometry",
     "every state leaf leads with [G, R] and lives on the kernel's "
     "device; int32 commit_bar / exec_bar [G, R] leaves are present "
     "(engine freeze masks + effects mirror)"),
    ("C10", "input-declarations",
     "every step-input name the kernel reads — including optional "
     ".get()-style reads, which a trace cannot KeyError on — is a base "
     "input (n_proposals/value_base/exec_floor) or declared in "
     "EXTRA_INPUTS, so the verified/tainted surface covers every lane "
     "the kernel can consume"),
    ("C2", "state-dtype",
     "protocol state is integer/bool only — no float leaves"),
    ("C3", "outbox-shape",
     "the outbox carries a 32-bit [G, R, R] 'flags' pair-field; every "
     "other leaf is per-pair [G, R_src, R_dst, ...] (delivered "
     "transposed) or declared in broadcast_lanes and leads with "
     "[G, R_src] (delivered as-is)"),
    ("C4", "outbox-dtype",
     "outbox lanes are integer/bool only"),
    ("C5", "durable-contract",
     "DURABLE_SCALARS / DURABLE_WINDOWS are declared and resolve to "
     "state arrays of the declared shapes ([G, R] scalars, [G, R, ...] "
     "windows); VALUE_WINDOW names one of DURABLE_WINDOWS"),
    ("C6", "step-purity",
     "step records an aten trace with no nondeterministic (seeded RNG) "
     "op, no in-place or out= write into an input leaf, no c10d "
     "collective (the collective tally is the broadcast record of "
     "core/quorum.py, gathered outside the step), and no host read "
     "(_local_scalar_dense) that HOST_SYNCS does not declare; "
     "init_state runs eagerly on the host exactly once and is exempt"),
    ("C7", "carry-stability",
     "step returns a state dict structurally identical (keys, shapes, "
     "dtypes) to its input — the engine's carry contract"),
    ("C8", "int-discipline",
     "no floating-point intermediate appears in the step trace (no "
     "silent float32 upcasts in protocol lanes)"),
    ("C9", "telemetry-path",
     "the telem lane block is written only via the stacked "
     "accumulate path in core/telemetry.py, contributed through "
     "the _telemetry hook"),
    ("R2", "range-claims",
     "every RANGE_CLAIMS entry (leaf, lo, hi) is an inductive value-"
     "range invariant: it holds at init_state and is preserved by one "
     "abstract step under the saturating interval semantics of "
     "analysis/ranges.py"),
    ("T1", "flags-gating",
     "every inbox read that lands in a state update, an effects "
     "output, or an outbox lane (a relay hop back onto the wire) "
     "passes a gate (select / mask-multiply) derived — directly or "
     "transitively — from the netmodel-zeroed flags field; "
     "intentional exceptions are declared in TAINT_ALLOW with a reason"),
    ("T9", "suppression-hygiene",
     "every TAINT_ALLOW entry names a flow that still occurs — a stale "
     "suppression is itself a finding, so the allowlist cannot rot"),
)


@dataclasses.dataclass
class StepEffects:
    """Per-tick observables: ``commit_bar``/``exec_bar`` ``[G, R]`` int32
    snapshots after the tick, plus protocol-specific fixed-shape extras."""

    commit_bar: Any
    exec_bar: Any
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _set_row(t: torch.Tensor, g: int, me: int, v) -> torch.Tensor:
    t = t.clone()
    t[g, me] = v
    return t


def _max_row(t: torch.Tensor, g: int, me: int, v: int) -> torch.Tensor:
    t = t.clone()
    t[g, me] = torch.clamp(t[g, me], min=v)
    return t


class ProtocolKernel:
    """Base class for vectorized protocol kernels.

    Constructed with static geometry (``num_groups``, ``population``,
    ``window``), a protocol config dataclass and the ``device`` its state
    lives on."""

    name: str = "generic"
    # outbox leaves delivered as-is, [G, R_src, ...] (not per-pair)
    broadcast_lanes: FrozenSet[str] = frozenset()
    # per-source tally records (core/quorum.py): [G, R_src] broadcast
    # lanes under tally="collective", [G, R, R] pair lanes otherwise
    TALLY_LANES: Tuple[str, ...] = ()
    # (phase_name, method_name) pairs in execution order; each method is
    # ``meth(self, s, c)`` over the state dict under construction and the
    # step's scratch namespace
    PHASES: Tuple[Tuple[str, str], ...] = ()

    # durable acceptor record: the leaves a crash-restart keeps
    # (engine.reset_durable_rows) and the host WAL logs per row
    DURABLE_SCALARS = None   # tuple[str] of [G, R] tensors
    DURABLE_WINDOWS = None   # tuple[str] of [G, R, W] tensors
    VALUE_WINDOW = "win_val"
    # step() inputs beyond n_proposals [G], value_base [G] and exec_floor
    # [G, R], as (name, shape code): g=[G], gr=[G, R], grr=[G, R, R]
    EXTRA_INPUTS: Tuple[Tuple[str, str], ...] = ()
    # declared-intentional ungated inbox->sink flows for the flags-taint
    # pass, as (inbox_leaf, sink, reason); a stale entry is a T9 finding
    TAINT_ALLOW: Tuple[Tuple[str, str, str], ...] = ()
    # author-asserted per-leaf bounds (state_leaf, lo, hi), inclusive,
    # each checked inductive by the range pass (R2)
    RANGE_CLAIMS: Tuple[Tuple[str, int, int], ...] = ()
    # host reads a step may make, as (phase, reason): C6 lists a declared
    # read under ``suppressed``, fails an undeclared one, and fails an
    # entry whose phase no longer reads (a stale declaration)
    HOST_SYNCS: Tuple[Tuple[str, str], ...] = ()

    def reset_rows(self, st, reset):
        """Hook run by the engine's device reset (``core/engine.py::
        reset_durable_rows``) on the state whose ``reset``-masked rows
        were just rebuilt from their durable leaves; returns the state.
        Default: the rebuilt rows as they are."""
        return st

    def renack(self, frames, view, me: int, cbar, stall):
        """Host hook run by a serving replica on its outgoing frames each
        tick, before they are sent: ``frames`` maps a peer to its frame
        (``ServerReplica._slice_outbox``), ``view(name)`` gives a state
        leaf as a host array, ``cbar`` is this replica's commit bar per
        group as of its last apply and ``stall`` a per-group tick counter
        the replica keeps for the hook.  Returns the new counter and the
        number of frames' groups it rewrote.  Default: no rewrite."""
        return stall, 0

    def restore_durable(self, st, g: int, me: int, rec: dict, floor: int):
        """Reinstate acceptor row ``(g, me)`` from the logged durable record
        ``rec`` ({field: int | list}) given the host applier's recovered
        exec floor.  Replaces the touched tensors in ``st``.

        Default: DURABLE_SCALARS restore as ``max(rec, floor)``, the
        dur/commit/exec bars rise to the floor, DURABLE_WINDOWS content is
        copied verbatim."""
        if self.DURABLE_SCALARS is None:
            raise NotImplementedError(
                f"{type(self).__name__} declares no durable contract"
            )
        fl = int(floor)
        for k in self.DURABLE_SCALARS:
            st[k] = _set_row(st[k], g, me, max(int(rec[k]), fl))
        for k in ("dur_bar", "commit_bar", "exec_bar"):
            if k in st and k not in self.DURABLE_SCALARS:
                st[k] = _max_row(st[k], g, me, fl)
        for k in self.DURABLE_WINDOWS:
            st[k] = _set_row(
                st[k], g, me,
                torch.as_tensor(rec[k], dtype=st[k].dtype,
                                device=st[k].device),
            )

    def __init__(self, num_groups: int, population: int, window: int,
                 device=None):
        if population < 1 or population > 32:
            raise ValueError("population must be in [1, 32] (32-bit bitmap lanes)")
        self.num_groups = num_groups
        self.population = population
        self.window = window
        self.device = resolve_device(device)
        # the row window a mesh shard steps (shard()); the whole [0, R)
        # on an unsharded kernel
        self.row0 = 0
        self._nrows = None

    def shard(self, num_groups: int, row0: int, rows: int, device
              ) -> "ProtocolKernel":
        """The kernel one mesh shard steps: ``num_groups`` groups and the
        replica rows ``row0 : row0 + rows`` of each, on ``device``.  Its
        per-pair and broadcast lanes keep all ``R`` peers as their last
        replica axis; only the leading (own-row) axis is windowed.  A
        shard never boots state: it steps slices of the full kernel's
        boot (``core/sharding.py``), so the seeds stay those of the full
        shape."""
        if row0 < 0 or rows < 1 or row0 + rows > self.R:
            raise ValueError(f"row window {row0}:{row0 + rows} outside "
                             f"R={self.R}")
        k = copy.copy(self)
        k.num_groups = int(num_groups)
        k.row0 = int(row0)
        k._nrows = int(rows)
        k.device = resolve_device(device)
        k._build_consts()
        return k

    def _build_consts(self) -> None:
        """Hook: (re)build the per-kernel constant tensors at this
        kernel's geometry, row window and device."""

    # -- geometry shorthands -------------------------------------------------
    @property
    def G(self) -> int:
        return self.num_groups

    @property
    def R(self) -> int:
        return self.population

    @property
    def W(self) -> int:
        return self.window

    @property
    def rows(self) -> int:
        """The replica rows this kernel steps: ``R`` unless it is a mesh
        shard's kernel (``shard``)."""
        return self.R if self._nrows is None else self._nrows

    def row_ids(self) -> torch.Tensor:
        """``[rows]`` int32 replica ids of the stepped rows."""
        return torch.arange(self.row0, self.row0 + self.rows,
                            dtype=torch.int32, device=self.device)

    def row_eye(self) -> torch.Tensor:
        """``[1, rows, R]`` bool: True where the peer is the row itself."""
        eye = torch.eye(self.R, dtype=torch.bool, device=self.device)
        return eye[self.row0:self.row0 + self.rows][None]

    @property
    def quorum(self) -> int:
        return self.population // 2 + 1

    @property
    def collective_tally(self) -> bool:
        return (
            getattr(getattr(self, "config", None), "tally", "pairwise")
            == "collective"
        )

    @property
    def tally_lanes(self) -> FrozenSet[str]:
        return frozenset(self.TALLY_LANES)

    # -- tensor constructors on the kernel's device ----------------------------
    def zeros(self, *shape, dtype=torch.int32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def full(self, shape, value, dtype=torch.int32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    # -- telemetry SPI -------------------------------------------------------
    def _telemetry(self, old: State, s: State, c: Any) -> Dict[str, Any]:
        """Hook: lane name -> [G, R] per-tick increments (bool or int32)."""
        tel = {"commits": torch.clamp(s["commit_bar"] - old["commit_bar"],
                                      min=0)}
        n_new = getattr(c, "n_new", None)
        if n_new is not None:
            tel["proposals"] = n_new
        for key in ("next_slot", "prop_bar"):
            if key in s:
                tel["win_occupancy_hw"] = self._occupancy_span(s, key)
                break
        return tel

    def _occupancy_span(self, s, hi_key: str):
        """High-water proxy: ``frontier - exec_bar`` clipped to [0, W]."""
        span = s[hi_key] - s["exec_bar"]
        if "vote_bar" in s and hi_key != "vote_bar":
            span = torch.maximum(span, s["vote_bar"] - s["exec_bar"])
        return torch.clamp(span, 0, self.window)

    def _accumulate_telemetry(self, old: State, s: State, c: Any) -> None:
        if telemetry.TELEM_KEY in s:
            s[telemetry.TELEM_KEY] = telemetry.accumulate(
                s[telemetry.TELEM_KEY], self._telemetry(old, s, c)
            )

    # -- phase runner --------------------------------------------------------
    def _run_phases(self, s: State, c: Any) -> None:
        """Run the declared :data:`PHASES` in order, each under its
        ``phase_scope``."""
        for name, meth in self.PHASES:
            with phase_scope(name):
                getattr(self, meth)(s, c)

    def _phase_build_outbox(self, s: State, c: Any) -> None:
        c.out = self._build_outbox(s, c)

    def _phase_telemetry(self, s: State, c: Any) -> None:
        self._accumulate_telemetry(c.old, s, c)

    # -- SPI -----------------------------------------------------------------
    def init_state(self, seed: int = 0) -> State:
        raise NotImplementedError

    def zero_outbox(self) -> State:
        """An all-invalid outbox (flags == 0); defines the outbox structure."""
        raise NotImplementedError

    def step(self, state: State, inbox: State, inputs: Dict[str, Any]
             ) -> Tuple[State, State, StepEffects]:
        """Advance one lockstep tick; ``inbox`` is the outbox structure with
        per-pair fields transposed to ``[G, R_dst, R_src]``."""
        raise NotImplementedError
