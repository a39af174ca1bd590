"""Kernel-contract verifier, counterpart of ``summerset_tpu/analysis/contract.py``.

Each kernel is built at a small static geometry on a device, its
``init_state`` / ``zero_outbox`` dicts are inspected directly, and one
``step`` is recorded as an aten trace (``analysis/tracer.py``), the
port's counterpart of the jaxpr the JAX verifier walks.  The rules are
``core.protocol.KERNEL_CONTRACT``; the checks read what the runtime
relies on: the engine's freeze masks reshape on leading ``[G, R]``, the
netmodel transposes axes 1/2 of non-broadcast lanes, the WAL logs the
``DURABLE_*`` rows, the engine feeds the state back as its carry, and
every leaf lives on the kernel's device (a CPU leaf beside a card kernel
is the fallback the port forbids).
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import os
from typing import Any, Dict, List, Tuple

import torch

from ..core import telemetry
from ..core.protocol import KERNEL_CONTRACT, ProtocolKernel
from . import tracer
from .report import Finding, PassResult

#: rule code -> short name, straight from the SPI's own table: a check can
#: only emit codes the table declares
CONTRACT_RULES: Dict[str, str] = {
    code: slug for code, slug, _ in KERNEL_CONTRACT
}


def rule_finding(code: str, where: str, scope: str, message: str,
                 line: int = 0) -> Finding:
    if code not in CONTRACT_RULES:
        raise KeyError(
            f"finding code {code!r} is not declared in "
            "core.protocol.KERNEL_CONTRACT — add the rule to the table "
            "before emitting it"
        )
    return Finding(code, where, scope, message, line=line)


# the JAX verifier's geometry: G, R and W mutually distinct
VERIFY_G, VERIFY_R, VERIFY_W = 2, 3, 8
PROP_WIDTH = 4  # [G, P] input lanes ("gp" shape code)

#: op namespaces of the c10d collectives (eager and functional)
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional",
                                   "c10d_functional"})

_INPUT_SHAPES = {
    "g": lambda G, R, P: (G,),
    "gr": lambda G, R, P: (G, R),
    "grr": lambda G, R, P: (G, R, R),
    "gp": lambda G, R, P: (G, P),
}


def build_kernel(make_protocol, name: str, variant: str = "device",
                 G: int = VERIFY_G, R: int = VERIFY_R, W: int = VERIFY_W,
                 device=None) -> ProtocolKernel:
    """A kernel at verification geometry on ``device`` (the card unless
    ``"cpu"`` is given).  ``variant`` is ``device`` (the defaults),
    ``host`` (``exec_follows_commit`` off, leader leases on where the
    config takes them) or ``collective`` (``tally="collective"``)."""
    probe = make_protocol(name, G, R, 64, device=device)
    cfg = getattr(probe, "config", None)
    if not dataclasses.is_dataclass(cfg):
        return make_protocol(name, G, R, W, device=device)
    overrides: Dict[str, Any] = {}
    if hasattr(cfg, "max_proposals_per_tick"):
        overrides["max_proposals_per_tick"] = min(
            cfg.max_proposals_per_tick, W // 2
        )
    if variant == "collective" and hasattr(cfg, "tally"):
        overrides["tally"] = "collective"
    if variant == "host":
        if hasattr(cfg, "exec_follows_commit"):
            overrides["exec_follows_commit"] = False
        if hasattr(cfg, "leader_leases"):
            # QL/Bodega carry their own lease planes and refuse the base
            # MultiPaxos flag: fall back without it
            try:
                return make_protocol(
                    name, G, R, W,
                    dataclasses.replace(cfg, leader_leases=True,
                                        **overrides),
                    device=device,
                )
            except ValueError:
                pass
    cfg = dataclasses.replace(cfg, **overrides)
    return make_protocol(name, G, R, W, cfg, device=device)


def host_variant_differs(kernel: ProtocolKernel) -> bool:
    cfg = getattr(kernel, "config", None)
    return hasattr(cfg, "exec_follows_commit") or hasattr(
        cfg, "leader_leases"
    )


def collective_variant_differs(kernel: ProtocolKernel) -> bool:
    return (
        hasattr(getattr(kernel, "config", None), "tally")
        and bool(kernel.TALLY_LANES)
    )


def kernel_variants(make_protocol, name: str, device=None
                    ) -> List[Tuple[str, ProtocolKernel]]:
    """(variant, kernel) for every config variant that differs."""
    kernel = build_kernel(make_protocol, name, device=device)
    out = [("device", kernel)]
    if host_variant_differs(kernel):
        out.append(("host", build_kernel(make_protocol, name, "host",
                                         device=device)))
    if collective_variant_differs(kernel):
        out.append(("collective", build_kernel(
            make_protocol, name, "collective", device=device)))
    return out


def build_inputs(kernel: ProtocolKernel,
                 prop_width: int = PROP_WIDTH) -> Dict[str, torch.Tensor]:
    """The step() input superset: the base lanes plus the declared
    ``EXTRA_INPUTS``, on the kernel's device."""
    G, R = kernel.G, kernel.R
    dev = kernel.device
    i32 = torch.int32
    inputs: Dict[str, torch.Tensor] = {
        "n_proposals": torch.ones((G,), dtype=i32, device=dev),
        "value_base": torch.ones((G,), dtype=i32, device=dev),
        "exec_floor": torch.zeros((G, R), dtype=i32, device=dev),
    }
    for name, code in kernel.EXTRA_INPUTS:
        if code not in _INPUT_SHAPES:
            raise ValueError(
                f"{type(kernel).__name__}.EXTRA_INPUTS: unknown shape "
                f"code {code!r} for {name!r}"
            )
        inputs[name] = torch.zeros(_INPUT_SHAPES[code](G, R, prop_width),
                                   dtype=i32, device=dev)
    return inputs


def trace_step(kernel: ProtocolKernel) -> tracer.StepTrace:
    """The recorded branch traces of one step (cached per surface)."""
    return tracer.record_step(kernel, build_inputs(kernel))


# --------------------------------------------------------------- checks --
def _is_int_like(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


def _on_device(kernel, t) -> bool:
    dev = kernel.device
    tdev = t.device if isinstance(t, torch.Tensor) else t
    if tdev.type != dev.type:
        return False
    return dev.index is None or tdev.index in (None, dev.index)


def _check_state(kernel, state, out: List[Finding]) -> None:
    name = kernel.name
    G, R = kernel.G, kernel.R
    for bar in ("commit_bar", "exec_bar"):
        leaf = state.get(bar)
        if leaf is None:
            out.append(rule_finding(
                "C1", name, bar, f"required state leaf {bar!r} missing"
            ))
        elif tuple(leaf.shape) != (G, R) or leaf.dtype != torch.int32:
            out.append(rule_finding(
                "C1", name, bar,
                f"{bar} must be int32 [G, R]; got "
                f"{leaf.dtype} {tuple(leaf.shape)}",
            ))
    for key, leaf in state.items():
        if leaf.dim() < 2 or tuple(leaf.shape[:2]) != (G, R):
            out.append(rule_finding(
                "C1", name, key,
                f"state leaf {key!r} must lead with [G, R]=({G}, {R}); "
                f"got shape {tuple(leaf.shape)}",
            ))
        if not _on_device(kernel, leaf):
            out.append(rule_finding(
                "C1", name, key,
                f"state leaf {key!r} lives on {leaf.device}, the kernel "
                f"on {kernel.device}",
            ))
        if not _is_int_like(leaf.dtype):
            out.append(rule_finding(
                "C2", name, key,
                f"state leaf {key!r} has non-integer dtype {leaf.dtype} "
                "(protocol state is integer/bool only)",
            ))


def _check_outbox(kernel, outbox, out: List[Finding]) -> None:
    name = kernel.name
    G, R = kernel.G, kernel.R
    bl = kernel.broadcast_lanes
    flags = outbox.get("flags")
    if flags is None:
        out.append(rule_finding(
            "C3", name, "flags",
            "outbox must contain the 32-bit [G, R, R] 'flags' pair-field "
            "(the netmodel's masking lane)",
        ))
    else:
        if flags.dtype != torch.int32 or tuple(flags.shape) != (G, R, R):
            out.append(rule_finding(
                "C3", name, "flags",
                f"flags must be int32 (uint32 bits) [G, R, R]; got "
                f"{flags.dtype} {tuple(flags.shape)}",
            ))
        if "flags" in bl:
            out.append(rule_finding(
                "C3", name, "flags",
                "flags must be a per-pair field, not a broadcast lane",
            ))
    for lane in sorted(bl):
        if lane not in outbox:
            out.append(rule_finding(
                "C3", name, lane,
                f"broadcast_lanes entry {lane!r} is not an outbox leaf",
            ))
    for key, leaf in outbox.items():
        if not _is_int_like(leaf.dtype):
            out.append(rule_finding(
                "C4", name, key,
                f"outbox leaf {key!r} has non-integer dtype {leaf.dtype}",
            ))
        if not _on_device(kernel, leaf):
            out.append(rule_finding(
                "C1", name, f"outbox.{key}",
                f"outbox leaf {key!r} lives on {leaf.device}, the kernel "
                f"on {kernel.device}",
            ))
        if key in bl:
            if leaf.dim() < 2 or tuple(leaf.shape[:2]) != (G, R):
                out.append(rule_finding(
                    "C3", name, key,
                    f"broadcast lane {key!r} must lead with "
                    f"[G, R_src]; got shape {tuple(leaf.shape)}",
                ))
        elif leaf.dim() < 3 or tuple(leaf.shape[:3]) != (G, R, R):
            out.append(rule_finding(
                "C3", name, key,
                f"outbox leaf {key!r} must be per-pair "
                f"[G, R_src, R_dst, ...] or declared in broadcast_lanes; "
                f"got shape {tuple(leaf.shape)}",
            ))


def _check_durable(kernel, state, out: List[Finding]) -> None:
    name = kernel.name
    G, R = kernel.G, kernel.R
    scalars, windows = kernel.DURABLE_SCALARS, kernel.DURABLE_WINDOWS
    if scalars is None or windows is None:
        out.append(rule_finding(
            "C5", name, "DURABLE",
            "kernel declares no durable acceptor contract "
            "(DURABLE_SCALARS/DURABLE_WINDOWS is None); the host refuses "
            "to serve it",
        ))
        return
    for k in scalars:
        leaf = state.get(k)
        if leaf is None:
            out.append(rule_finding(
                "C5", name, k,
                f"DURABLE_SCALARS entry {k!r} is not a state leaf",
            ))
        elif tuple(leaf.shape) != (G, R):
            out.append(rule_finding(
                "C5", name, k,
                f"DURABLE_SCALARS entry {k!r} must be [G, R]; got "
                f"{tuple(leaf.shape)}",
            ))
    for k in windows:
        leaf = state.get(k)
        if leaf is None:
            out.append(rule_finding(
                "C5", name, k,
                f"DURABLE_WINDOWS entry {k!r} is not a state leaf",
            ))
        elif leaf.dim() < 3 or tuple(leaf.shape[:2]) != (G, R):
            out.append(rule_finding(
                "C5", name, k,
                f"DURABLE_WINDOWS entry {k!r} must lead with [G, R] and "
                f"carry a window axis; got {tuple(leaf.shape)}",
            ))
    if kernel.VALUE_WINDOW not in windows:
        out.append(rule_finding(
            "C5", name, kernel.VALUE_WINDOW,
            f"VALUE_WINDOW {kernel.VALUE_WINDOW!r} must be one of "
            "DURABLE_WINDOWS (the WAL logs payload ids from it)",
        ))


def _check_purity(kernel, st: tracer.StepTrace, out: List[Finding],
                  suppressed: List[Tuple[Finding, str]]) -> None:
    """C6 over every branch trace: seeded RNG ops, in-place / out= writes
    into input leaves, c10d collectives, and host syncs against
    ``HOST_SYNCS``."""
    name = kernel.name
    hit = set()
    sync_phases = set()
    for tr in st.branches:
        inputs = tr.input_ids()
        for call in tr.calls:
            if call.sync:
                sync_phases.add(call.phase)
                continue
            tags = getattr(call.op, "tags", ())
            if torch.Tag.nondeterministic_seeded in tags:
                key = ("rng", call.name)
                if key not in hit:
                    hit.add(key)
                    out.append(rule_finding(
                        "C6", name, f"step:{call.name}",
                        f"nondeterministic (seeded RNG) op {call.name!r} "
                        "in the step trace",
                    ))
            ns = call.name.split(".", 1)[0]
            if ns in COLLECTIVE_NAMESPACES:
                key = ("coll", call.name)
                if key not in hit:
                    hit.add(key)
                    out.append(rule_finding(
                        "C6", name, f"step:{call.name}",
                        f"collective op {call.name!r} inside the step — "
                        "the collective tally is the broadcast record of "
                        "core/quorum.py, gathered outside the step",
                    ))
            for w in call.writes:
                if w < 0:
                    continue
                root = tr.root(w)
                leaf = inputs.get(root)
                if leaf is None:
                    continue
                tree = ("state", "inbox", "inputs")[leaf[0]]
                key = ("write", leaf)
                if key not in hit:
                    hit.add(key)
                    out.append(rule_finding(
                        "C6", name, f"step:{tree}.{leaf[1]}",
                        f"{call.name!r} writes into the input leaf "
                        f"{tree}.{leaf[1]} in place (step never updates a "
                        "tensor in place: the engine keeps the pre-tick "
                        "state for the pause freeze)",
                    ))
    declared = {}
    for phase, reason in kernel.HOST_SYNCS:
        declared[phase] = reason
    for phase in sorted(sync_phases):
        f = rule_finding(
            "C6", name, f"step:sync:{phase or '<no phase>'}",
            f"host read (_local_scalar_dense) in phase {phase!r}",
        )
        if phase in declared:
            suppressed.append((f, declared[phase]))
        else:
            out.append(f)
    for phase in sorted(set(declared) - sync_phases):
        out.append(rule_finding(
            "C6", name, f"HOST_SYNCS:{phase}",
            f"stale HOST_SYNCS entry: phase {phase!r} makes no host read "
            "any more — delete the declaration",
        ))


def _check_int_discipline(kernel, st: tracer.StepTrace,
                          out: List[Finding]) -> None:
    name = kernel.name
    hit = set()
    for tr in st.branches:
        for call in tr.calls:
            for vid in call.outs:
                dt = tr.vals[vid].dtype
                if (dt.is_floating_point or dt.is_complex) and \
                        call.name not in hit:
                    hit.add(call.name)
                    out.append(rule_finding(
                        "C8", name, f"step:{call.name}",
                        f"floating-point intermediate ({dt}) produced "
                        f"by {call.name!r} in the step trace — protocol "
                        "lanes are integer-only",
                    ))


def _check_carry(kernel, st: tracer.StepTrace, out: List[Finding]) -> None:
    """C7: step's state output must be a structurally identical carry."""
    name = kernel.name
    in_leaves = {k: (tuple(v.shape), v.dtype) for k, v in st.state.items()}
    out_leaves = {
        leaf: (shape, dtype)
        for (tree, leaf), (shape, dtype, _) in st.out_meta.items()
        if tree == 0
    }
    for k in sorted(set(in_leaves) | set(out_leaves)):
        if k not in out_leaves:
            out.append(rule_finding(
                "C7", name, k, f"state leaf {k!r} dropped by step()"
            ))
        elif k not in in_leaves:
            out.append(rule_finding(
                "C7", name, k, f"state leaf {k!r} invented by step()"
            ))
        elif in_leaves[k] != out_leaves[k]:
            out.append(rule_finding(
                "C7", name, k,
                f"state leaf {k!r} changes shape/dtype across step(): "
                f"{in_leaves[k]} -> {out_leaves[k]} (breaks the "
                "engine's carry)",
            ))


def _check_effects_device(kernel, st: tracer.StepTrace,
                          out: List[Finding]) -> None:
    """C1 placement of what step returns: state, outbox and effects."""
    tree_name = ("state", "outbox", "effects")
    for (tree, leaf), (_, _, dev) in sorted(st.out_meta.items(),
                                            key=lambda kv: kv[0]):
        if not _on_device(kernel, dev):
            out.append(rule_finding(
                "C1", kernel.name, f"{tree_name[tree]}.{leaf}",
                f"step returns {tree_name[tree]} leaf {leaf!r} on {dev}, "
                f"the kernel lives on {kernel.device}",
            ))


# --------------------------------------------------- input declarations --
BASE_INPUTS = frozenset({"n_proposals", "value_base", "exec_floor"})


def _ends_with_inputs(expr) -> bool:
    """A bare ``inputs`` name or a one-hop ``<local>.inputs`` attribute."""
    if isinstance(expr, ast.Name):
        return expr.id == "inputs"
    if isinstance(expr, ast.Attribute) and expr.attr == "inputs":
        return (
            isinstance(expr.value, ast.Name)
            and expr.value.id != "self"
        )
    return False


class _InputReadScan(ast.NodeVisitor):
    """Step-input name literals read off the ``inputs`` mapping."""

    def __init__(self):
        self.reads: List[Tuple[str, int, str]] = []

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (
            isinstance(fn, ast.Attribute) and fn.attr == "get"
            and _ends_with_inputs(fn.value) and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            self.reads.append((node.args[0].value, node.lineno, "get"))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        sl = node.slice
        if (
            _ends_with_inputs(node.value)
            and isinstance(sl, ast.Constant)
            and isinstance(sl.value, str)
        ):
            self.reads.append((sl.value, node.lineno, "subscript"))
        self.generic_visit(node)


def _check_input_declarations(kernel, out: List[Finding]) -> None:
    """C10: every input-name literal the kernel's class bodies read is a
    base input or declared in ``EXTRA_INPUTS``."""
    name = kernel.name
    declared = BASE_INPUTS | {n for n, _ in kernel.EXTRA_INPUTS}
    seen_classes = set()
    for cls in type(kernel).__mro__:
        if cls in (ProtocolKernel, object):
            continue
        mod = inspect.getmodule(cls)
        fn = getattr(mod, "__file__", None)
        if not fn or getattr(mod, "__name__", "") == \
                "summerset_tpu_torch.core.protocol":
            continue
        key = (fn, cls.__name__)
        if key in seen_classes:
            continue
        seen_classes.add(key)
        try:
            with open(fn, "r") as f:
                tree = ast.parse(f.read(), filename=fn)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.ClassDef)
                and node.name == cls.__name__
            ):
                continue
            scan = _InputReadScan()
            scan.visit(node)
            for rname, line, how in scan.reads:
                if rname in declared:
                    continue
                out.append(rule_finding(
                    "C10", name,
                    f"{os.path.basename(fn)}:{rname}",
                    f"step-input {rname!r} read via "
                    f"{'inputs.get(...)' if how == 'get' else 'inputs[...]'}"
                    " but not declared in EXTRA_INPUTS (nor a base "
                    "input) — the traced surface silently drops this "
                    "branch",
                    line=line,
                ))


# ------------------------------------------------- telemetry write path --
class _TelemWriteScan(ast.NodeVisitor):
    """Direct references to the telemetry lane block in a protocol module."""

    def __init__(self):
        self.hits: List[Tuple[int, str]] = []

    def visit_Constant(self, node: ast.Constant) -> None:
        if node.value == telemetry.TELEM_KEY:
            self.hits.append((node.lineno, "literal 'telem' subscript"))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in ("accumulate", "bump", "TELEM_KEY"):
            base = getattr(node.value, "id", None)
            if base == "telemetry":
                self.hits.append(
                    (node.lineno, f"direct telemetry.{node.attr} call")
                )
        self.generic_visit(node)


def _check_telemetry_path(kernel, out: List[Finding]) -> None:
    """C9 over the kernel's defining modules under ``protocols/``."""
    name = kernel.name
    seen_files = set()
    for cls in type(kernel).__mro__:
        mod = inspect.getmodule(cls)
        fn = getattr(mod, "__file__", None)
        if not fn or os.sep + "protocols" + os.sep not in fn:
            continue
        if fn in seen_files:
            continue
        seen_files.add(fn)
        with open(fn, "r") as f:
            tree = ast.parse(f.read(), filename=fn)
        scan = _TelemWriteScan()
        scan.visit(tree)
        for line, what in scan.hits:
            out.append(rule_finding(
                "C9", name,
                f"{os.path.basename(fn)}:{what}",
                f"telemetry lane block touched directly ({what}) — "
                "contribute lanes via the _telemetry hook so the one "
                "stacked accumulate stays the only write path",
                line=line,
            ))


# ------------------------------------------------------------ entrypoint --
def verify_kernel(make_protocol, name: str, device=None) -> PassResult:
    """Every contract check for one kernel, over each config variant that
    differs; findings are deduplicated by (fingerprint, message)."""
    res = PassResult()
    seen = set()
    seen_supp = set()

    def emit(findings: List[Finding]) -> None:
        for f in findings:
            key = (f.fingerprint, f.message)
            if key not in seen:
                seen.add(key)
                res.findings.append(f)

    try:
        variants = kernel_variants(make_protocol, name, device=device)
        kernel = variants[0][1]
        for _, k in variants:
            found: List[Finding] = []
            supp: List[Tuple[Finding, str]] = []
            plain_state = k.init_state(seed=0)
            _check_state(k, plain_state, found)
            _check_outbox(k, k.zero_outbox(), found)
            _check_durable(k, plain_state, found)
            st = trace_step(k)
            _check_effects_device(k, st, found)
            _check_purity(k, st, found, supp)
            _check_int_discipline(k, st, found)
            _check_carry(k, st, found)
            emit(found)
            for f, reason in supp:
                if f.fingerprint not in seen_supp:
                    seen_supp.add(f.fingerprint)
                    res.suppressed.append((f, reason))
        tel_found: List[Finding] = []
        _check_telemetry_path(kernel, tel_found)
        _check_input_declarations(kernel, tel_found)
        emit(tel_found)
    except Exception as e:  # a crash in tracing is itself a violation
        res.error = f"{type(e).__name__}: {e}"
    return res
