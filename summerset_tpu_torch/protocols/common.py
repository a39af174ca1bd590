"""Shared helpers for vectorized consensus kernels, counterpart of
``summerset_tpu/protocols/common.py``.

Conventions that keep the port bit-identical to the JAX reference:
every integer tensor is int32 (``arange``/``full``/``zeros`` pin it, since
an int64 operand would silently widen a leaf), ``%`` is floor-mod
(``torch.remainder``), ties in a max pick the first sender, and gather
indices are clamped to the axis (the indices here are argmax results and
always in range; an out-of-range CUDA gather would abort the context).
"""

from __future__ import annotations

import torch

from ..core.quorum import quorum_frontier

NULL_VAL = 0      # reserved value id: no-op filler
NO_SLOT = -1      # empty window position marker
I32_MAX = (1 << 31) - 1
INF = 1 << 30     # frontier-min sentinel of the JAX kernels (a state value)


# ----------------------------------------------------------------- ballots --
def make_greater_ballot(bal_max, rid):
    """Next ballot for ``rid`` above ``bal_max``: ``(round+1) << 8 | id``."""
    return (((bal_max >> 8) + 1) << 8) | rid


def initial_ballot(rid: int) -> int:
    return (1 << 8) | rid


# ------------------------------------------------------------- ring window --
def arange32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def range_cover(lo: torch.Tensor, hi: torch.Tensor, window: int):
    """Cover of absolute-slot range [lo, hi) on a size-``window`` ring:
    ``(mask, abs_slots)`` of shape ``[..., W]``; position ``p`` holds
    absolute slot ``lo + ((p - lo) mod W)``."""
    p = arange32(window, lo.device)
    lo_e = lo[..., None]
    abs_slots = lo_e + torch.remainder(p - lo_e, window)
    mask = abs_slots < hi[..., None]
    return mask, abs_slots


# ------------------------------------------------------------ msg selection --
def first_argmax(x: torch.Tensor, best: torch.Tensor, dim: int):
    """Index of the first maximum of ``x`` along ``dim`` (``best`` is the
    max, reduced over ``dim``): the tie rule of ``jnp.argmax``.  Some
    position always hits, so the last index stands in for a miss, which
    keeps the result's value range ``[0, n - 1]`` visible to the range
    prover (``analysis/ranges.py``)."""
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    idx = arange32(n, x.device).reshape(shape)
    hit = x == best.unsqueeze(dim)
    return torch.where(hit, idx, n - 1).amin(dim=dim)


def first_true(mask: torch.Tensor, dim: int):
    """Index of the first True of a bool tensor along ``dim``, 0 where
    there is none: ``jnp.argmax`` on a bool lane."""
    m = mask.to(torch.int32)
    return first_argmax(m, m.amax(dim=dim), dim)


def best_by_ballot(flags, bit: int, bal_field):
    """Among senders with ``bit`` set in flags, pick the max-ballot one.

    ``flags``/``bal_field``: [G, R, R_src].  Returns ``(ok, bal, src)``
    each [G, R]; ``src`` is the first sender holding the max."""
    valid = (flags & bit) != 0
    eff = torch.where(valid, bal_field, -1)
    best = eff.amax(dim=2)
    src = first_argmax(eff, best, 2)
    return best >= 0, best, src


def _gather_idx(src: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(src, 0, n - 1).to(torch.int64)


def take_src(field, src):
    """Gather per-sender scalar field [G, R, R_src] at src [G, R]."""
    idx = _gather_idx(src, field.shape[2])
    return torch.gather(field, 2, idx[..., None])[..., 0]


def take_lane(lane, src):
    """Gather broadcast window lane [G, R_src, W] at src [G, R] -> [G, R, W]."""
    G, R = src.shape
    idx = _gather_idx(src, lane.shape[1])
    return torch.gather(lane, 1, idx[..., None].expand(G, R, lane.shape[2]))


# ------------------------------------------------------------ quorum tally --
def kth_largest(values, k: int):
    """k-th largest along the last axis (k >= 1): the quorum-frontier
    tally, delegated to the tally plane's ``quorum_frontier``."""
    return quorum_frontier(values, k)


# --------------------------------------------------- shared lockstep blocks --
def client_intake(s, inputs, serving, cap: int, window: int,
                  frontier: str = "next_slot"):
    """Clamp this tick's client proposals to window space and batch cap.
    Returns ``(n_new, m_new, abs_new, new_vals)``."""
    G, R = s["exec_bar"].shape
    space = torch.clamp(s["exec_bar"] + window - s[frontier], min=0)
    # clamp the host-supplied count at the kernel edge: a negative count
    # would walk every slot frontier backwards
    n_prop = torch.clamp(
        inputs["n_proposals"].to(torch.int32)[:, None].expand(G, R), min=0
    )
    n_new = torch.where(
        serving, torch.clamp(torch.minimum(n_prop, space), max=cap), 0
    )
    vbase = inputs["value_base"].to(torch.int32)[:, None].expand(G, R)
    m_new, abs_new = range_cover(s[frontier], s[frontier] + n_new, window)
    new_vals = vbase[..., None] + (abs_new - s[frontier][..., None])
    return n_new, m_new, abs_new, new_vals


def advance_durability(s, dur_lag: int, frontier: str = "next_slot"):
    """WAL-ack progression: instant, or ``dur_lag`` slots/tick."""
    if dur_lag > 0:
        return torch.minimum(s[frontier], s["dur_bar"] + dur_lag)
    return s[frontier]


def advance_exec(s, inputs, exec_follows_commit: bool):
    """Exec bar: mirrors commit in device-only mode, else follows the host
    applier's reported floor (``exec_floor`` input)."""
    if exec_follows_commit:
        return s["commit_bar"]
    return torch.maximum(
        s["exec_bar"],
        torch.minimum(s["commit_bar"], inputs["exec_floor"].to(torch.int32)),
    )


def flag_bits(mask: torch.Tensor, bit: int) -> torch.Tensor:
    """``bit`` where ``mask`` else 0, as int32 flags."""
    return mask.to(torch.int32) * bit


def dst_onehot(src, R: int):
    """[G, R] sender index -> [G, R, R_dst] bool one-hot (reply routing)."""
    return arange32(R, src.device)[None, None, :] == src[..., None]


def not_self(G: int, R: int, device, row0: int = 0, rows: int = None):
    """[G, R_src, R_dst] mask: True off-diagonal (no self-sends); with a
    row window, the sources ``row0 : row0 + rows`` only."""
    rows = R if rows is None else rows
    eye = torch.eye(R, dtype=torch.bool, device=device)[row0:row0 + rows]
    return (~eye)[None, :, :].expand(G, rows, R)
