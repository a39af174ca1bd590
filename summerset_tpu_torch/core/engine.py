"""The lockstep tick engine, counterpart of ``summerset_tpu/core/engine.py``.

One ``tick`` advances every replica of every group by one round of
receive -> protocol step -> send; ``run_ticks`` and ``run_synthetic``
roll it over a window in a Python loop (the JAX engine's ``lax.scan``).

Pause semantics: non-alive replicas keep their whole state row for the
tick and their per-replica effects read zero.  Durable crash semantics:
a ``reset`` mask rebuilds the masked rows from only the kernel's declared
durable leaves at the start of the tick (``reset_durable_rows``).

The sharded mesh of the JAX engine is not ported yet (ROADMAP, Queue 1):
``mesh=`` is refused.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from . import telemetry
from .netmodel import ControlInputs, NetConfig, NetModel
from .protocol import ProtocolKernel, StepEffects

State = Dict[str, Any]


def _lease_plane_on(kcfg) -> bool:
    return (
        getattr(kcfg, "leader_leases", False)
        or getattr(kcfg, "enable_leader_leases", False)
        or hasattr(kcfg, "lease_len")
    )


class Engine:
    def __init__(
        self,
        kernel: ProtocolKernel,
        netcfg: NetConfig = NetConfig(),
        seed: int = 0,
        mesh: Optional[Any] = None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "the sharded mesh engine is not ported to summerset_tpu_torch "
                "yet (ROADMAP.md, Queue 1: the multi-GPU mesh)"
            )
        self.device = resolve_device(device)
        if kernel.device != self.device:
            raise ValueError(
                f"kernel lives on {kernel.device}, engine on {self.device}"
            )
        self.kernel = kernel
        self.netcfg = netcfg
        # lease safety is clock-free only while the grantor's countdown
        # outlives the holder's belief by more than the max one-way delay
        kcfg = getattr(kernel, "config", None)
        margin = getattr(kcfg, "lease_margin", None)
        if margin is not None and _lease_plane_on(kcfg) and (
            margin <= netcfg.max_delay_ticks
        ):
            raise ValueError(
                f"lease_margin ({margin}) must exceed the network's "
                f"max_delay_ticks ({netcfg.max_delay_ticks}): a lease "
                "margin at or below the one-way delay permits a stale "
                "holder to serve a local read after its grantor's "
                "countdown lapsed"
            )
        self.seed = seed
        self.net = NetModel(
            netcfg, kernel.G, kernel.R, kernel.broadcast_lanes,
            tally_lanes=kernel.tally_lanes, device=self.device,
        )
        # the freshly-booted state a device reset rewinds volatile rows
        # to; also the initial state init() hands out (nothing updates a
        # state tensor in place, so sharing it is safe)
        self._boot = self.kernel.init_state(seed)

    def init(self) -> Tuple[State, State]:
        state = dict(self._boot)
        telemetry.attach(state, self.kernel.G, self.kernel.R, self.device)
        netstate = self.net.init_netstate(self.kernel.zero_outbox(),
                                          self.seed)
        return state, netstate

    def _to_device(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in inputs.items()}

    def tick(self, state: State, netstate: State, inputs: Dict[str, Any]
             ) -> Tuple[State, State, StepEffects]:
        """One lockstep tick."""
        return _tick(self.kernel, self.net, self._boot, state, netstate,
                     self._to_device(inputs))

    def run_ticks(self, state: State, netstate: State,
                  inputs_seq: Dict[str, Any], collect: bool = False):
        """Run T ticks; ``inputs_seq`` holds tensors with leading time dim T.
        Returns ``(state, netstate, fxs)``: ``fxs`` is the per-tick
        effects stacked over T when ``collect`` is set, else ``None``."""
        seq = self._to_device(inputs_seq)
        T = next(iter(seq.values())).shape[0]
        fxs = []
        for t in range(T):
            state, netstate, fx = _tick(
                self.kernel, self.net, self._boot, state, netstate,
                {k: v[t] for k, v in seq.items()},
            )
            if collect:
                fxs.append(fx)
        return state, netstate, (_stack_effects(fxs) if collect else None)

    def run_synthetic(self, state: State, netstate: State, num_ticks: int,
                      proposals_per_tick: int):
        """Device-only benchmark loop: every tick each group is offered
        ``proposals_per_tick`` commands with value ids ``tick * P + i``,
        and the host applier saturates (``exec_floor = 2^30``)."""
        G, R = self.kernel.G, self.kernel.R
        dev = self.device
        n_prop = torch.full((G,), proposals_per_tick, dtype=torch.int32,
                            device=dev)
        floor = torch.full((G, R), 1 << 30, dtype=torch.int32, device=dev)
        for t in range(num_ticks):
            inputs = {
                "n_proposals": n_prop,
                "value_base": torch.full((G,), t * proposals_per_tick,
                                         dtype=torch.int32, device=dev),
                "exec_floor": floor,
            }
            state, netstate, _ = _tick(self.kernel, self.net, self._boot,
                                       state, netstate, inputs)
        return state, netstate


def _stack_effects(fxs) -> StepEffects:
    return StepEffects(
        commit_bar=torch.stack([f.commit_bar for f in fxs]),
        exec_bar=torch.stack([f.exec_bar for f in fxs]),
        extra={k: torch.stack([f.extra[k] for f in fxs])
               for k in fxs[0].extra},
    )


def _row_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape(tuple(mask.shape) + (1,) * (leaf.ndim - 2))


def reset_durable_rows(kernel: ProtocolKernel, state: State,
                       reset: torch.Tensor,
                       boot: Optional[State] = None) -> State:
    """Rebuild the ``reset``-masked ``[G, R]`` rows from only the kernel's
    declared durable leaves: those keep their values, every other leaf
    rewinds to its ``boot`` value (zeros for leaves absent from ``boot``,
    such as the telemetry block); then the kernel's ``reset_rows`` rule
    (the MultiPaxos family empties a vote run above the rewound commit
    bar, as its ``restore_durable`` does)."""
    durable = frozenset(kernel.DURABLE_SCALARS or ()) | frozenset(
        kernel.DURABLE_WINDOWS or ()
    )
    boot = boot or {}

    def rewind(key, leaf):
        if key in durable:
            return leaf
        fresh = boot.get(key)
        if fresh is None:
            fresh = torch.zeros_like(leaf)
        return torch.where(_row_mask(reset, leaf), fresh, leaf)

    return kernel.reset_rows({k: rewind(k, v) for k, v in state.items()},
                             reset)


def _tick(kernel: ProtocolKernel, net: NetModel, boot: State, state: State,
          netstate: State, inputs: Dict[str, Any]
          ) -> Tuple[State, State, StepEffects]:
    ctrl = ControlInputs(
        alive=inputs.get("alive"), link_up=inputs.get("link_up"),
        reset=inputs.get("reset"),
    )
    if ctrl.reset is not None:
        state = reset_durable_rows(kernel, state, ctrl.reset, boot)
    netstate, inbox = net.pop(netstate, ctrl)
    new_state, outbox, fx = kernel.step(state, inbox, inputs)
    if ctrl.alive is not None:
        # freeze paused replicas: every state leaf leads with [G, R]
        alive = ctrl.alive
        new_state = {
            k: torch.where(_row_mask(alive, v), v, state[k])
            for k, v in new_state.items()
        }

        # effects mirror the freeze: bars from the frozen state, per-
        # replica extras zeroed (a paused replica has no events)
        def mask_extra(leaf):
            if leaf.ndim >= 2 and tuple(leaf.shape[:2]) == tuple(alive.shape):
                return torch.where(_row_mask(alive, leaf), leaf,
                                   torch.zeros_like(leaf))
            return leaf

        fx = StepEffects(
            commit_bar=new_state["commit_bar"],
            exec_bar=new_state["exec_bar"],
            extra={k: mask_extra(v) for k, v in fx.extra.items()},
        )
    if telemetry.TELEM_KEY in new_state:
        netstate, tel = net.push(
            netstate, outbox, ctrl, telem=new_state[telemetry.TELEM_KEY]
        )
        new_state = dict(new_state, **{telemetry.TELEM_KEY: tel})
    else:
        netstate = net.push(netstate, outbox, ctrl)
    return new_state, netstate, fx
