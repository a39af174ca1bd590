"""The port's range prover, contract and taint passes on the 11 protocols,
held to the JAX package's live range analysis on the CPU.

- Every protocol × config variant: the port's proven interval of every
  state leaf equals the JAX prover's (in the leaf's logical dtype: the
  uint32 leaves the port holds as int32 bits compare as uint32), and the
  pair facts are equal.  Each difference is an entry of ``RANGE_DIFFS``
  with its reason; every entry is tighter on the port's side, and one
  abstract step of the JAX prover from the port's intervals leaves the
  port's interval for that leaf, so the difference is in the transfer
  of the two traces, not in the fixpoint's path.
- Every port interval and pair fact holds at every tick of a seeded
  200-tick CPU engine run under a nemesis plan (MultiPaxos, RSPaxos,
  Raft at G=4).
- The port's contract, taint and ranges passes are clean on every
  protocol.
"""

import json
import os

import numpy as np
import pytest
import torch

from summerset_tpu import protocols as jprotocols
from summerset_tpu.analysis import contract as jcontract
from summerset_tpu.analysis import ranges as jranges
from summerset_tpu_torch import protocols
from summerset_tpu_torch.analysis import contract, ranges
from summerset_tpu_torch.analysis.contract import verify_kernel
from summerset_tpu_torch.analysis.taint import verify_kernel_taint
from summerset_tpu_torch.convert import to_numpy
from summerset_tpu_torch.core import Engine
from summerset_tpu_torch.host.nemesis import FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

I32 = (-(2 ** 31), 2 ** 31 - 1)
I32_TOP_HI = (I32[0], I32[1] - 1)

_WINDOW = (
    "the window write where(abs < end, abs, win_abs) refines its taken "
    "case by the mask's conjunct abs < end, so a written slot stays "
    "below 2^31-1; the JAX prover's step of the same select does not "
    "narrow it"
)
_BCAST = (
    "torch broadcasts the collective tally's [G, 1, R] record view inside "
    "both eq and where, so the conjunct ar_bal == bal names the where's "
    "own case and refines it to the ballot's range; the JAX trace "
    "broadcasts the view apart for each op, so its conjunct never names "
    "the case"
)
_REM = (
    "torch.remainder is one op with the floor-mod range [0, m-1]; jnp's % "
    "traces to rem plus a sign-fixing select whose interval reaches "
    "below 0, which the JAX fixpoint widens"
)
_INF = (
    "INF = 2^30 is a Python int in the port (a literal of the where); the "
    "JAX package's INF is a jnp.int32 array, closed over as a constant "
    "its walker reads as the whole int32 range"
)

#: (protocol, variant, leaf) -> (JAX interval, port interval, reason)
RANGE_DIFFS = {
    ("bodega", "device", "pam"): (I32, (I32[0], 1 << 30), _INF),
    ("bodega", "host", "pam"): (I32, (I32[0], 1 << 30), _INF),
    ("bodega", "collective", "pam"): (I32, (I32[0], 1 << 30), _INF),
    ("bodega", "collective", "match_bal"): (I32, (0, I32[1]), _BCAST),
    ("crossword", "collective", "match_bal"): (I32, (0, I32[1]), _BCAST),
    ("multipaxos", "collective", "match_bal"): (I32, (0, I32[1]), _BCAST),
    ("quorumleases", "collective", "match_bal"): (I32, (0, I32[1]),
                                                  _BCAST),
    ("rspaxos", "collective", "match_bal"): (I32, (0, I32[1]), _BCAST),
    ("craft", "device", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("craft", "host", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("craft", "collective", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("crossword", "device", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("crossword", "host", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("crossword", "collective", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("raft", "device", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("raft", "host", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("raft", "collective", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("rspaxos", "device", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("rspaxos", "host", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("rspaxos", "collective", "win_abs"): (I32, I32_TOP_HI, _WINDOW),
    ("repnothing", "device", "win_abs"): ((-8, I32[1]), (-1, I32[1]), _REM),
    ("repnothing", "host", "win_abs"): ((-8, I32[1]), (-1, I32[1]), _REM),
    ("epaxos", "device", "rec_row"): ((-2, 7), (-1, 2), _REM),
    ("epaxos", "host", "rec_row"): ((-2, 7), (-1, 2), _REM),
}


def _variants():
    out = []
    for name in protocols.protocol_names():
        k = contract.build_kernel(protocols.make_protocol, name,
                                  device="cpu")
        out.append((name, "device"))
        if contract.host_variant_differs(k):
            out.append((name, "host"))
        if contract.collective_variant_differs(k):
            out.append((name, "collective"))
    return out


VARIANTS = _variants()


def test_variant_sets_match_the_jax_package():
    want = []
    for name in jprotocols.protocol_names():
        k = jcontract.build_kernel(jprotocols.make_protocol, name)
        want.append((name, "device"))
        if jcontract.host_variant_differs(k):
            want.append((name, "host"))
        if jcontract.collective_variant_differs(k):
            want.append((name, "collective"))
    assert VARIANTS == want


def test_range_diffs_name_live_variants():
    for (name, var, _leaf), (jiv, piv, reason) in RANGE_DIFFS.items():
        assert (name, var) in VARIANTS
        assert reason
        assert ranges.iv_leq(piv, jiv) and piv != jiv


@pytest.mark.parametrize("name,variant", VARIANTS)
def test_invariants_equal_jax_live(name, variant):
    pk = contract.build_kernel(protocols.make_protocol, name, variant,
                               device="cpu")
    jk = jcontract.build_kernel(jprotocols.make_protocol, name, variant)
    pra = ranges.analyze_kernel_ranges(pk)
    jra = jranges.analyze_kernel_ranges(jk)
    assert pra.unmodeled == ()
    assert set(pra.invariants) == set(jra.invariants)
    diffs = {}
    for leaf, piv in sorted(pra.invariants.items()):
        jiv = tuple(int(x) for x in jra.invariants[leaf])
        if tuple(piv) != jiv:
            diffs[leaf] = (jiv, tuple(piv))
    want = {leaf: (jiv, piv)
            for (n, v, leaf), (jiv, piv, _) in RANGE_DIFFS.items()
            if (n, v) == (name, variant)}
    assert diffs == want
    assert pra.pairs == tuple(tuple(p) for p in jra.pairs)
    if diffs:
        # the JAX prover's own step from the port's intervals leaves them
        # on exactly these leaves: the traces' transfers differ there
        closed, in_paths, out_paths, _, _ = jcontract.trace_step(jk)
        cur = {k: tuple(v) for k, v in pra.invariants.items()}
        step = jranges._step_intervals(closed, in_paths, out_paths, cur)
        for leaf in diffs:
            assert not jranges.iv_leq(step[leaf], cur[leaf]), leaf


@pytest.mark.parametrize("name", protocols.protocol_names())
def test_port_passes_are_clean(name):
    for res in (verify_kernel(protocols.make_protocol, name, device="cpu"),
                verify_kernel_taint(protocols.make_protocol, name,
                                    device="cpu"),
                ranges.verify_kernel_ranges(protocols.make_protocol, name,
                                            device="cpu")):
        assert res.ok, [f.render() for f in res.findings] or res.error


def test_taint_gate_counts_are_pinned_in_the_baseline():
    with open(os.path.join(REPO, "summerset_tpu_torch", "LINT.json")) as f:
        doc = json.load(f)
    gates = doc["summary"]["taint_gates"]
    per_kernel = [
        (k["taint"]["extra"]["gates_proven"],
         k["taint"]["extra"]["gates_optimistic"])
        for k in doc["kernels"].values()
    ]
    assert gates["port"] == {"proven": sum(p for p, _ in per_kernel),
                             "optimistic": sum(o for _, o in per_kernel)}
    assert gates["port"] == {"proven": 213, "optimistic": 14}
    assert gates["jax_package"] == {"proven": 126, "optimistic": 37}
    for k in doc["kernels"].values():
        ex = k["taint"]["extra"]
        assert ex["gates_optimistic"] == len(ex["residuals"])


# ------------------------------------------------ the seeded engine runs --
SEEDED_RUN = ("multipaxos", "rspaxos", "raft")
PLAN_SEED = 11
PLAN_CLASSES = ("crash", "device_reset", "pause", "partition", "isolate",
                "one_way", "drop", "clock_skew")


@pytest.mark.parametrize("name", SEEDED_RUN)
def test_invariants_hold_on_a_seeded_nemesis_run(name):
    """The device variant's proven intervals and pair facts hold at every
    tick of 200 ticks at G=4 (the verification geometry's R and W) under
    seed 11's plan with saturating load."""
    k = contract.build_kernel(protocols.make_protocol, name, device="cpu")
    ra = ranges.analyze_kernel_ranges(k)
    G, R, P, T = 4, k.R, k.config.max_proposals_per_tick, 200
    run_k = protocols.make_protocol(name, G, R, k.W, k.config, device="cpu")
    eng = Engine(run_k, device="cpu")
    plan = FaultPlan.generate(PLAN_SEED, R, T, classes=PLAN_CLASSES)
    masks = plan.compile_device(G, device="cpu")
    st, ns = eng.init()
    lo = {leaf: np.iinfo(np.int64).max for leaf in ra.invariants}
    hi = {leaf: np.iinfo(np.int64).min for leaf in ra.invariants}
    for t in range(T):
        inputs = {
            "n_proposals": torch.full((G,), P, dtype=torch.int32),
            "value_base": torch.full((G,), t * P, dtype=torch.int32),
            "exec_floor": torch.full((G, R), 1 << 30, dtype=torch.int32),
        }
        for key, m in masks.items():
            inputs[key] = m[t]
        st, ns, _ = eng.tick(st, ns, inputs)
        a = to_numpy(st)
        for leaf in ra.invariants:
            lo[leaf] = min(lo[leaf], int(a[leaf].min()))
            hi[leaf] = max(hi[leaf], int(a[leaf].max()))
        for x, y in ra.pairs:
            assert bool(np.all(a[x] <= a[y])), (x, y, t)
    for leaf, (plo, phi) in ra.invariants.items():
        assert plo <= lo[leaf] and hi[leaf] <= phi, (leaf, (plo, phi),
                                                      (lo[leaf], hi[leaf]))
    # the run did move: commits happened and the plan faulted replicas
    assert hi["commit_bar"] > 0
    assert not bool(masks["alive"].all())


# ------------------------------------------------- transfer-table units --
def test_unknown_overload_is_top_and_listed():
    from summerset_tpu_torch.analysis import tracer

    vals = [tracer.Val(0, torch.int32, (2,), "input"),
            tracer.Val(1, torch.int32, (2,), "op", call=0)]
    call = tracer.Call(0, "aten.bogus.default", None, (tracer.Ref(0),), {},
                       (1,), "")
    tr = tracer.Trace(vals, [call], [(0, "x", 0)], [(0, "x", 1)])
    seen = set()
    env = ranges._Walker(tr, unmodeled=seen).run({0: ((0, 3), (), ())})
    assert env[1][0] == I32
    assert seen == {"aten.bogus.default"}


def test_logical_uint32_leaves_report_as_uint32():
    assert ranges.logical_interval("rng", I32) == (0, 2 ** 32 - 1)
    assert ranges.logical_interval("flags", (0, 7)) == (0, 7)
    assert ranges.logical_interval("prep_acks", (-1, -1)) == (
        2 ** 32 - 1, 2 ** 32 - 1)
    assert ranges.logical_interval("commit_bar", (-1, 5)) == (-1, 5)
