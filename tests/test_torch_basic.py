"""The port's ChainRep, SimplePush and RepNothing kernels against the JAX
package, exactly (the configurations of ``tests/test_basic_protocols.py``).

The recipe of ``tests/test_torch_raft.py``: both engines start from the
JAX boot state carried across through ``summerset_tpu_torch.convert`` and
run three windows of the same per-tick inputs (proposals every tick, one
replica paused at tick 3 and durably reset in window 1).  After every
window the sha256 digest of every state leaf, the stacked effects and the
netstate must be equal, and so must the state signatures.  Tolerance:
none, every compared value is an integer or a bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smr_helpers import check_agreement, committed_values
from summerset_tpu.core import Engine as JEngine
from summerset_tpu.core import NetConfig as JNet
from summerset_tpu.core.engine import reset_durable_rows as jreset
from summerset_tpu.protocols import make_protocol as jmake
from summerset_tpu.protocols.bodega import ReplicaConfigBodega as JBO
from summerset_tpu.protocols.chain_rep import ReplicaConfigChainRep as JCR
from summerset_tpu.protocols.epaxos import ReplicaConfigEPaxos as JEP
from summerset_tpu.protocols.quorum_leases import (
    ReplicaConfigQuorumLeases as JQL,
)
from summerset_tpu.protocols.rep_nothing import ReplicaConfigRepNothing as JRN
from summerset_tpu.protocols.simple_push import (
    ReplicaConfigSimplePush as JSP,
)
from summerset_tpu_torch.convert import to_numpy
from summerset_tpu_torch.core import Engine as TEngine
from summerset_tpu_torch.core import NetConfig as TNet
from summerset_tpu_torch.core.engine import reset_durable_rows
from summerset_tpu_torch.protocols import NOT_PORTED
from summerset_tpu_torch.protocols import make_protocol as tmake
from summerset_tpu_torch.protocols.bodega import ReplicaConfigBodega as TBO
from summerset_tpu_torch.protocols.chain_rep import (
    ReplicaConfigChainRep as TCR,
)
from summerset_tpu_torch.protocols.epaxos import ReplicaConfigEPaxos as TEP
from summerset_tpu_torch.protocols.quorum_leases import (
    ReplicaConfigQuorumLeases as TQL,
)
from summerset_tpu_torch.protocols.rep_nothing import (
    ReplicaConfigRepNothing as TRN,
)
from summerset_tpu_torch.protocols.simple_push import (
    ReplicaConfigSimplePush as TSP,
)
from test_torch_engine import _common_start, _digest_window, _signature

G, W, P = 8, 32, 4
TICKS = 20      # per window
WINDOWS = 3

DROPS = dict(drop_rate=0.2, jitter_ticks=1, max_delay_ticks=3)
CONFIGS = {"chainrep": (JCR, TCR), "simplepush": (JSP, TSP),
           "repnothing": (JRN, TRN)}

# name -> (protocol, population, config kwargs, net kwargs)
CASES = {
    "chainrep-default": ("chainrep", 4, {}, {}),
    "chainrep-dur-lag2": ("chainrep", 4, dict(dur_lag=2), {}),
    "chainrep-drops-retry": ("chainrep", 3, {}, DROPS),
    "chainrep-one-node": ("chainrep", 1, {}, {}),
    "simplepush-default": ("simplepush", 3, {}, {}),
    "simplepush-dur-lag2": ("simplepush", 3, dict(dur_lag=2), {}),
    "simplepush-rep-degree2": ("simplepush", 5, dict(rep_degree=2), {}),
    "simplepush-drops-retry": ("simplepush", 3, {}, DROPS),
    "repnothing-default": ("repnothing", 3, {}, {}),
    "repnothing-dur-lag2": ("repnothing", 1, dict(dur_lag=2), {}),
}


def _kernels(proto, r, cfg, g=G):
    jcfg, tcfg = CONFIGS[proto]
    cfg = dict(max_proposals_per_tick=P, **cfg)
    return (jmake(proto, g, r, W, jcfg(**cfg)),
            tmake(proto, g, r, W, tcfg(**cfg), device="cpu"))


def _window_seq(w, r):
    """One window's per-tick inputs: proposals every tick, replica
    ``min(1, r - 1)`` paused at tick 3 and durably reset in window 1."""
    t = np.arange(TICKS, dtype=np.int32)
    victim = min(1, r - 1)
    alive = np.ones((TICKS, G, r), bool)
    alive[3, :, victim] = False
    reset = np.zeros((TICKS, G, r), bool)
    if w == 1:
        reset[5, :, victim] = True
    return {
        "n_proposals": np.full((TICKS, G), P, np.int32),
        "value_base": np.broadcast_to(
            ((w * TICKS + t) * P)[:, None], (TICKS, G)).astype(np.int32),
        "alive": alive,
        "reset": reset,
    }


def _run_both(name):
    proto, r, cfg, net = CASES[name]
    jk, tk = _kernels(proto, r, cfg)
    jeng = JEngine(jk, netcfg=JNet(**net), seed=9)
    teng = TEngine(tk, netcfg=TNet(**net), seed=9, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    jd, td = [], []
    for w in range(WINDOWS):
        seq = _window_seq(w, r)
        js, jns, jfx = jeng.run_ticks(
            js, jns, {k: jnp.asarray(v) for k, v in seq.items()},
            collect=True)
        ts, tns, tfx = teng.run_ticks(ts, tns, seq, collect=True)
        jd.append(_digest_window(
            js, jns, {"commit_bar": jfx.commit_bar, "exec_bar": jfx.exec_bar,
                      "extra": jfx.extra}))
        tsn = to_numpy(ts)
        assert _signature(tsn) == _signature(js), f"window {w}"
        td.append(_digest_window(
            tsn, to_numpy(tns),
            {"commit_bar": tfx.commit_bar.numpy(),
             "exec_bar": tfx.exec_bar.numpy(),
             "extra": {k: v.numpy() for k, v in tfx.extra.items()}}))
    return jd, td, to_numpy(ts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_digests_equal_jax(name):
    jd, td, final = _run_both(name)
    assert td == jd
    proto, r, cfg, net = CASES[name]
    T = WINDOWS * TICKS
    cb = final["commit_bar"]
    assert int(cb.max()) > 0, "nothing committed"
    if cfg.get("dur_lag"):
        # the WAL lag bounds the commit frontier
        assert int(cb.max()) <= cfg["dur_lag"] * T
    if proto == "chainrep" and r > 1:
        # the tail commits; the acks ripple back up to the head
        assert (cb[:, 0] > 0).all() and (cb[:, -1] > 0).all()
        assert (cb[:, 0] <= cb[:, -1]).all()
    if proto == "chainrep" and r == 1:
        # a one-node chain is its own tail: it commits all it appended
        assert (cb[:, 0] == final["prop_bar"][:, 0]).all()
    if proto == "simplepush" and cfg.get("rep_degree") == 2:
        # pushed peers (1, 2) advance; unpushed (3, 4) stay empty
        assert (cb[:, 1:3] > 0).all() and (cb[:, 3:] == 0).all()
    if proto == "repnothing" and r > 1:
        assert (cb[:, 1:] == 0).all()
    if proto != "repnothing":
        check_agreement(final, G, r, W)
    # committed values are the offered ids in slot order (a paused tick
    # offers ids that no slot takes)
    vals = committed_values(final, 0, r - 1 if proto == "chainrep" else 0, W)
    order = [vals[s] for s in sorted(vals)]
    assert order and order == sorted(set(order))


@pytest.mark.parametrize("proto,r", [("chainrep", 4), ("simplepush", 3),
                                     ("repnothing", 3)])
def test_reset_and_restore_durable_match_jax(proto, r):
    jk, tk = _kernels(proto, r, {})
    jeng, teng = JEngine(jk, seed=3), TEngine(tk, seed=3, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    seq = _window_seq(0, r)
    js, jns, _ = jeng.run_ticks(
        js, jns, {k: jnp.asarray(v) for k, v in seq.items()})
    ts, tns, _ = teng.run_ticks(ts, tns, seq)
    mask = np.zeros((G, r), bool)
    mask[::2, 0] = True
    jr = jreset(jk, js, jnp.asarray(mask), jeng._boot)
    tr = reset_durable_rows(tk, ts, torch.from_numpy(mask), teng._boot)
    trn = to_numpy(tr)
    for k in jr:
        np.testing.assert_array_equal(trn[k], np.asarray(jr[k]), err_msg=k)
    rec = {k: np.asarray(js[k][1, 1]).tolist()
           for k in jk.DURABLE_SCALARS + jk.DURABLE_WINDOWS}
    jst, tst = dict(jeng._boot), dict(teng._boot)
    jk.restore_durable(jst, 1, 1, rec, floor=5)
    tk.restore_durable(tst, 1, 1, rec, floor=5)
    tn = to_numpy(tst)
    for k in jst:
        np.testing.assert_array_equal(tn[k], np.asarray(jst[k]), err_msg=k)


@pytest.mark.parametrize("proto,cfgs", [
    ("chainrep", (JCR, TCR)), ("simplepush", (JSP, TSP)),
    ("repnothing", (JRN, TRN)), ("quorumleases", (JQL, TQL)),
    ("bodega", (JBO, TBO)), ("epaxos", (JEP, TEP)),
])
def test_kernel_declarations_match_jax(proto, cfgs):
    """Broadcast and tally lanes, durable leaves, host inputs and phase
    tables are declared as the JAX kernels declare them, and the outbox
    has the same lanes, shapes and byte widths, in the same key order
    (the netmodel's packing plan reads it).  Every protocol is ported."""
    jk = jmake(proto, 2, 5, W, cfgs[0](max_proposals_per_tick=P))
    tk = tmake(proto, 2, 5, W, cfgs[1](max_proposals_per_tick=P),
               device="cpu")
    assert tk.broadcast_lanes == jk.broadcast_lanes
    assert tk.TALLY_LANES == jk.TALLY_LANES
    assert tk.DURABLE_SCALARS == jk.DURABLE_SCALARS
    assert tk.DURABLE_WINDOWS == jk.DURABLE_WINDOWS
    assert tk.EXTRA_INPUTS == jk.EXTRA_INPUTS
    assert tk.PHASES == jk.PHASES
    assert type(tk).name == type(jk).name
    jo = {k: np.asarray(v) for k, v in jk.zero_outbox().items()}
    to = to_numpy(tk.zero_outbox())
    assert _signature(to) == _signature(jo)
    assert list(to) == list(jo)
    assert NOT_PORTED == ()
