"""Host-plane concurrency lint: AST rules over the threaded host stack,
counterpart of ``summerset_tpu/analysis/hostlint.py`` (the same rules,
module keys and suppression syntax, run over the port's own tree).

The host planes (``summerset_tpu_torch/host/``, ``manager/``, ``utils/``) are
hand-threaded: hub worker threads, per-peer messengers, an asyncio API
front end, seeded nemesis schedule generation.  Four recurring hazards
have each bitten a replicated-state-machine codebase at some point, and
all four are mechanically checkable:

- **H101 lock-held blocking call** — ``fsync``/socket ops/untimed
  ``queue.get`` inside a ``with <lock>:`` body serialize unrelated
  threads behind device latency (and can deadlock against the logger /
  messenger threads).
- **H102 non-daemon thread** — a forgotten ``daemon=True`` turns every
  crash-teardown path into a hang: the interpreter waits on a thread
  parked in a blocking read.
- **H103 wallclock/unseeded RNG in a seeded-determinism scope** — the
  nemesis repro contract is "same seed, byte-identical schedule";
  ``time.time()`` or an unseeded RNG inside schedule generation breaks
  it silently.  The rule also covers the tracing plane through
  ``MONOTONIC_SCOPES``, a *scoped* allow (not a blanket inline waiver):
  ``host/tracing.py`` may read the monotonic clock family for its
  stamps, but a wallclock read there still fires — wallclock jumps
  would reorder exported spans.
- **H104 fsync outside StorageHub** — durability points belong to the
  logger thread (single-writer discipline + fault injection + fsync
  telemetry); a stray ``os.fsync`` bypasses all three.
- **H106 exception swallowed in a hub thread** — a broad ``except
  Exception:`` (or bare ``except:``) whose handler neither re-raises,
  nor records a typed flight/telemetry event, nor even reads the bound
  exception, inside the hub-thread modules (server / transport /
  storage / external / ingress).  Hub worker loops MUST wrap their
  bodies to survive poison input — but a handler that drops the
  exception on the floor turns every future bug in that loop into a
  silent stall: the thread keeps spinning, the operator sees nothing.
  The contract is "survive AND record": re-raise, or emit through the
  flight recorder / telemetry counters (``pf_*``/``note_*`` helpers,
  ``.record``/``.bump``/``.inc``), or at minimum consume the exception
  value into some sink the operator can read.
- **H105 unfenced egress in the pipelined tick loop** — the pipelined
  loop's durability contract is that no vote/ack computed by step N
  leaves the process (peer tick frame OR client reply) before step N's
  WAL records are fsynced.  The fence is ``_fence_wait``; this rule
  makes the contract machine-checked: every ``send_tick`` /
  ``send_replies`` call site in the fence owner module
  (``host/server.py``) must either be dominated by a ``_fence_wait()``
  call earlier in the same function's straight-line body, or pass the
  fence down as a ``fence=..._fence_wait`` keyword so the egress seam
  itself re-checks.  The serial loop's call site carries an inline
  waiver instead (its strict stage order — fsync at the END of tick
  N-1, frames computed by step N-1 leaving at the TOP of tick N — IS
  the fence), so every egress site is either dominated or reasoned.

Suppressions are explicit, inline, and carry a reason::

    with self._wlocks[peer]:  # graftlint: disable=H101 -- per-socket writer serialization IS the lock's job
        sock.sendall(buf)

A trailing comment attaches to its own line; standalone comment lines
attach to the next statement (several can stack above one site) and the
enclosing ``with`` line is also consulted.  Suppressed findings still
appear in ``LINT.json`` (with their reason) so the baseline records
every waiver.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from .report import Finding, PassResult

# directories scanned, relative to the package root
SCAN_DIRS = ("host", "manager", "utils")

# the one module allowed to own durability points
STORAGE_OWNER = "host/storage.py"

# seeded-determinism scopes: module -> class names whose methods must be
# wallclock-free and draw only from explicitly seeded RNGs (the nemesis
# and workload schedule-generation surfaces; NemesisRunner's and the
# open-loop drivers' wall pacing are exempt by not being listed).
# host/ingress.py (the serving-plane proxy tier) is in the H101-H104
# scan like every host/ module but declares NO seeded scope: the proxy
# holds no schedule generators — its only time reads are wall pacing
# (forward-cycle ticks, probe deadlines), which the contract exempts.
SEEDED_SCOPES: Dict[str, Tuple[str, ...]] = {
    "host/nemesis.py": ("FaultPlan", "FaultEvent"),
    "host/workload.py": ("WorkloadPlan", "WorkloadPhase", "OpStream"),
    # the autopilot's DECISION core: same seed + same senses sequence
    # must yield a byte-identical decision timeline/digest, so the
    # policy's notion of time is the evaluate-round counter, never a
    # clock.  AutopilotDriver (the wall-clock scrape/actuate loop) is
    # exempt by not being listed, like NemesisRunner.
    "host/autopilot.py": ("AutopilotPolicy", "Decision",
                          "ActuatorState"),
}

# monotonic-only scopes: module -> class names (or "*" for the whole
# module) whose timestamps must come from the monotonic clock family.
# This is a SCOPED allow, not a blanket waiver: the tracing plane's
# time.monotonic() stamps are the sanctioned path, while a wallclock
# read (time.time / datetime.now) in the same scope still fires H103 —
# wallclock can jump (NTP step, suspend) and would reorder recorded
# spans, silently corrupting exported timelines.
MONOTONIC_SCOPES: Dict[str, Tuple[str, ...]] = {
    "host/tracing.py": ("*",),
    # graftprof timing: perf_counter (monotonic family) is the
    # sanctioned stopwatch; a wallclock read in the profiler would make
    # committed PROFILE.json numbers jump with NTP steps
    "host/profiling.py": ("*",),
}

# wallclock spellings that fire inside BOTH scope kinds (the seeded
# scopes additionally ban the monotonic family — schedules must be a
# pure function of the seed, not of any clock)
WALLCLOCK_READS = (
    "time.time", "time.time_ns", "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
)

# call names considered blocking when made while a lock is held.
# send_msg_sync/recv_msg_sync are this repo's own blocking frame helpers
# (utils/safetcp.py) — project-aware linting catches the call sites a
# generic socket list would miss.
BLOCKING_NAMES = frozenset({
    "fsync", "fdatasync", "sleep", "accept", "connect", "recv",
    "recvfrom", "recv_into", "sendall", "send_msg_sync", "recv_msg_sync",
    "recv_exact", "sendmsg", "sendmsg_all",
})
# blocking only without a timeout= kwarg (queue.get, thread.join)
TIMEOUT_GATED_NAMES = frozenset({"get", "join"})

# H106: modules whose classes run hub worker threads (long-lived loops
# draining queues/sockets).  Broad excepts there must re-raise or
# record — a swallowed exception stalls the loop's users silently.
HUB_MODULES = frozenset({
    "host/server.py", "host/transport.py", "host/storage.py",
    "host/external.py", "host/ingress.py",
})
# call spellings that count as "recording" the failure: the flight-
# recorder/print helpers and the telemetry-counter surface
H106_RECORD_CALLS = frozenset({"record", "bump", "inc", "exception"})
H106_RECORD_PREFIXES = ("pf_", "note_", "log_")

# H105: the durability-fence owner module and its egress seams.  Egress
# calls here must be fence-dominated (a `_fence_wait()` earlier in the
# same function's straight-line body) or carry a `fence=` kwarg naming
# the fence — anything else can leak a not-yet-durable vote/ack.
FENCE_OWNER = "host/server.py"
FENCE_EGRESS_NAMES = frozenset({"send_tick", "send_replies"})
FENCE_WAIT_NAME = "_fence_wait"

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Z]\d+)(?:\s*--\s*(.*))?"
)


def _call_name(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _dotted(node) -> str:
    """Best-effort dotted rendering of a Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _has_kw(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)


def _broad_except(t) -> bool:
    """Is this handler type a catch-(almost)-everything?  Bare
    ``except:``, ``Exception``/``BaseException``, or a tuple containing
    one of them."""
    if t is None:
        return True
    if isinstance(t, ast.Tuple):
        return any(_broad_except(e) for e in t.elts)
    return _dotted(t) in ("Exception", "BaseException")


def _handler_records(h: ast.ExceptHandler) -> bool:
    """Does a broad handler discharge its H106 obligation?  True when
    the body re-raises, calls a recording helper
    (:data:`H106_RECORD_CALLS` / :data:`H106_RECORD_PREFIXES`), or at
    least *reads* the bound exception value (feeding it into any sink
    an operator can inspect)."""
    for stmt in h.body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Raise):
                return True
            if isinstance(n, ast.Call):
                cn = _call_name(n)
                if cn and (cn in H106_RECORD_CALLS
                           or cn.startswith(H106_RECORD_PREFIXES)):
                    return True
            if (h.name and isinstance(n, ast.Name) and n.id == h.name
                    and isinstance(n.ctx, ast.Load)):
                return True
    return False


# 'lock' as its own word-start in the identifier (optionally r/w
# prefixed): `_lock`, `self._wlocks[peer]`, `rlock`, `cv_lock` — but NOT
# `block`/`_block`/`nonblocking`, where 'lock' is a substring of another
# word
_LOCK_NAME_RE = re.compile(r"(?:^|_)[rw]?lock", re.IGNORECASE)


def _looks_like_lock(expr) -> bool:
    """A with-item that names a lock: any Name/Attribute/Subscript chain
    whose final identifier matches :data:`_LOCK_NAME_RE`, or an explicit
    ``.acquire()``."""
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Attribute) and \
                expr.func.attr == "acquire":
            return True
        return False
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    name = ""
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    return _LOCK_NAME_RE.search(name) is not None


class _Scanner(ast.NodeVisitor):
    def __init__(self, rel: str,
                 suppress: Dict[int, List[Tuple[str, str]]]):
        self.rel = rel
        self.suppress = suppress
        self.findings: List[Finding] = []
        self.suppressed: List[Tuple[Finding, str]] = []
        self._scope: List[str] = []  # class/function qualname stack
        self._lock_lines: List[int] = []  # enclosing with-lock linenos
        self._seeded_classes = SEEDED_SCOPES.get(rel, ())
        self._mono_classes = MONOTONIC_SCOPES.get(rel, ())
        # H105 dominance: per enclosing function, the linenos of
        # STRAIGHT-LINE (top-level-of-body) `..._fence_wait()` call
        # statements — a fence inside an `if` doesn't dominate
        self._fence_lines: List[List[int]] = []
        # H106: per-qualname ordinal of broad excepts, so the scope
        # symbol (`qual:except#k`) is stable across line-number churn
        self._h106_ord: Dict[str, int] = {}

    # ---------------------------------------------------------- helpers
    def _qual(self) -> str:
        return ".".join(self._scope) or "<module>"

    def _emit(self, code: str, scope_sym: str, message: str,
              line: int) -> None:
        f = Finding(code, self.rel, scope_sym, message, line=line)
        for cand in (line, *self._lock_lines[::-1]):
            for hcode, reason in self.suppress.get(cand, ()):
                if hcode == code:
                    self.suppressed.append(
                        (f, reason or "(no reason given)")
                    )
                    return
        self.findings.append(f)

    def _in_seeded_scope(self) -> bool:
        return bool(self._scope) and self._scope[0] in self._seeded_classes

    def _in_mono_scope(self) -> bool:
        if "*" in self._mono_classes:
            return True
        return bool(self._scope) and self._scope[0] in self._mono_classes

    # ------------------------------------------------------- structure
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def _visit_func(self, node) -> None:
        self._scope.append(node.name)
        # H105 dominance set: fence waits that are top-level statements
        # of THIS function's body (straight-line — unconditionally
        # executed before anything below them)
        fences = []
        for stmt in node.body:
            if (
                isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)
                and _call_name(stmt.value) == FENCE_WAIT_NAME
            ):
                fences.append(stmt.lineno)
        self._fence_lines.append(fences)
        self.generic_visit(node)
        self._fence_lines.pop()
        self._scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if self.rel in HUB_MODULES and _broad_except(node.type):
            qual = self._qual()
            k = self._h106_ord.get(qual, 0)
            self._h106_ord[qual] = k + 1
            if not _handler_records(node):
                spelled = "bare except:" if node.type is None else \
                    f"except {_dotted(node.type) or '...'}"
                self._emit(
                    "H106", f"{qual}:except#{k}",
                    f"{spelled} in a hub-thread module neither "
                    "re-raises, records a flight/telemetry event, nor "
                    "reads the exception — a future bug in this loop "
                    "becomes a silent stall (survive AND record)",
                    node.lineno,
                )
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        is_lock = any(
            _looks_like_lock(item.context_expr) for item in node.items
        )
        if is_lock:
            self._lock_lines.append(node.lineno)
        self.generic_visit(node)
        if is_lock:
            self._lock_lines.pop()

    # ----------------------------------------------------------- rules
    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)
        dotted = _dotted(node.func)
        qual = self._qual()

        if self._lock_lines:
            if name in BLOCKING_NAMES:
                self._emit(
                    "H101", f"{qual}:{name}",
                    f"blocking call {dotted or name}() inside a "
                    "lock-held region (serializes threads behind I/O; "
                    "deadlock-prone against hub worker threads)",
                    node.lineno,
                )
            elif name in TIMEOUT_GATED_NAMES and not _has_kw(
                node, "timeout"
            ) and not node.args:
                # .get()/.join() with positional args (dict.get(k),
                # str.join(xs)) are not the queue/thread idiom
                self._emit(
                    "H101", f"{qual}:{name}",
                    f"untimed {dotted or name}() inside a lock-held "
                    "region (unbounded wait while holding the lock)",
                    node.lineno,
                )

        if name == "Thread" and dotted in ("threading.Thread", "Thread"):
            daemon_true = any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords
            )
            if not daemon_true:
                self._emit(
                    "H102", f"{qual}:Thread",
                    "threading.Thread(...) without daemon=True — a "
                    "crashed owner leaves the interpreter hanging on "
                    "this thread at teardown",
                    node.lineno,
                )

        if self._in_mono_scope() and dotted in WALLCLOCK_READS:
            self._emit(
                "H103", f"{qual}:{dotted}",
                f"wallclock read {dotted}() inside a monotonic-stamp "
                "tracing scope — flight-recorder/span stamps must come "
                "from the monotonic clock family (wallclock jumps "
                "reorder exported spans)",
                node.lineno,
            )

        if self._in_seeded_scope():
            if dotted in WALLCLOCK_READS + (
                "time.monotonic", "time.monotonic_ns",
                "time.perf_counter", "time.perf_counter_ns",
            ):
                self._emit(
                    "H103", f"{qual}:{dotted}",
                    f"wallclock read {dotted}() inside seeded-"
                    "determinism scope (schedules must be a pure "
                    "function of the seed)",
                    node.lineno,
                )
            elif dotted in ("random.Random", "np.random.default_rng",
                            "numpy.random.default_rng") and not (
                node.args or node.keywords
            ):
                self._emit(
                    "H103", f"{qual}:{dotted}",
                    f"unseeded RNG {dotted}() inside seeded-"
                    "determinism scope",
                    node.lineno,
                )
            elif dotted.startswith("random.") and dotted not in (
                "random.Random",
            ):
                self._emit(
                    "H103", f"{qual}:{dotted}",
                    f"module-level {dotted}() draws from the global "
                    "(unseeded) RNG inside seeded-determinism scope",
                    node.lineno,
                )

        if name in FENCE_EGRESS_NAMES and self.rel == FENCE_OWNER:
            fenced_kwarg = any(
                kw.arg == "fence"
                and _dotted(kw.value).endswith(FENCE_WAIT_NAME)
                for kw in node.keywords
            )
            dominated = bool(self._fence_lines) and any(
                ln < node.lineno for ln in self._fence_lines[-1]
            )
            if not (fenced_kwarg or dominated):
                self._emit(
                    "H105", f"{qual}:{name}",
                    f"egress call {dotted or name}() not dominated by a "
                    f"{FENCE_WAIT_NAME}() in this function's straight-"
                    "line body and not passing fence= — a vote/ack "
                    "computed by the in-flight step could leave before "
                    "its WAL records are fsynced (the pipelined loop's "
                    "durability fence contract)",
                    node.lineno,
                )

        if dotted in ("os.fsync", "os.fdatasync") and \
                self.rel != STORAGE_OWNER:
            self._emit(
                "H104", f"{qual}:{dotted}",
                f"direct {dotted}() outside StorageHub "
                f"({STORAGE_OWNER}) — durability points belong to the "
                "logger thread (single-writer + fault injection + "
                "fsync telemetry)",
                node.lineno,
            )

        self.generic_visit(node)


def _collect_suppressions(src: str) -> Dict[int, List[Tuple[str, str]]]:
    """Map line -> [(code, reason), ...].  A trailing comment attaches
    to its own line; a standalone comment line attaches to the next
    *statement* line — blank and comment-only lines in between are
    skipped, so several standalone waivers can stack above one site
    without the earlier ones landing on the later comments.  A line can
    accumulate several codes (its own trailing comment plus standalone
    ones above)."""
    out: Dict[int, List[Tuple[str, str]]] = {}
    lines = src.splitlines()
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        target = i
        if line.strip().startswith("#"):
            target = i + 1
            while target <= len(lines) and (
                not lines[target - 1].strip()
                or lines[target - 1].strip().startswith("#")
            ):
                target += 1
        out.setdefault(target, []).append(
            (m.group(1), (m.group(2) or "").strip())
        )
    return out


def scan_file(path: str, rel: str) -> Tuple[List[Finding],
                                            List[Tuple[Finding, str]]]:
    with open(path, "r") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    scanner = _Scanner(rel, _collect_suppressions(src))
    scanner.visit(tree)
    return scanner.findings, scanner.suppressed


def lint_host(package_root: str) -> Tuple[PassResult, int]:
    """Scan the host-plane dirs under ``package_root`` (the
    ``summerset_tpu_torch`` package directory).  Returns (result, files)."""
    res = PassResult()
    n_files = 0
    for d in SCAN_DIRS:
        dpath = os.path.join(package_root, d)
        if not os.path.isdir(dpath):
            continue
        for root, dirs, files in os.walk(dpath):
            # recurse so a future subpackage can't silently escape the
            # lint; deterministic order keeps LINT.json byte-stable
            dirs[:] = sorted(
                x for x in dirs if x != "__pycache__"
            )
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(root, fn)
                rel = os.path.relpath(path, package_root).replace(
                    os.sep, "/"
                )
                n_files += 1
                try:
                    findings, suppressed = scan_file(path, rel)
                except SyntaxError as e:
                    res.findings.append(Finding(
                        "H100", rel, "parse", f"unparseable: {e}"
                    ))
                    continue
                res.findings.extend(findings)
                res.suppressed.extend(suppressed)
    return res, n_files
