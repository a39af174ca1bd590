"""Finding records + the deterministic LINT.json report format,
counterpart of ``summerset_tpu/analysis/report.py`` (same ``LINT_VERSION``,
same fingerprints: equal ``(code, where, scope)`` give equal fingerprints
in both packages).

Every graftlint pass (contract verifier, flags-taint, host AST lint)
emits :class:`Finding` records.  Two properties make the committed
``LINT.json`` a usable CI baseline:

- **stable fingerprints** — a finding is identified by *what* it is
  (rule code, file/kernel, scope, symbol), never by *where in the file*
  it sits, so unrelated edits shifting line numbers don't churn the
  baseline; and
- **deterministic ordering** — every list in the report is sorted on the
  full record, so regenerating the file from a clean tree is
  byte-identical (the same contract NEMESIS.json digests follow).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

LINT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint/verifier finding.

    ``code``    rule id (``C1``..``C10``, ``R2``, ``T1``/``T9``, ``H1xx``).
    ``where``   kernel name or repo-relative file path.
    ``scope``   sub-location that is stable across edits: a state/outbox
                leaf, a ``Class.method`` qualname — NOT a line number.
    ``message`` human-readable one-liner.
    ``line``    best-effort line number for console output only; excluded
                from the fingerprint and from LINT.json.
    """

    code: str
    where: str
    scope: str
    message: str
    line: int = 0

    @property
    def fingerprint(self) -> str:
        raw = "|".join((self.code, self.where, self.scope))
        return hashlib.sha256(raw.encode()).hexdigest()[:12]

    def render(self) -> str:
        loc = f"{self.where}:{self.line}" if self.line else self.where
        return f"{self.code} [{self.fingerprint}] {loc} ({self.scope}): " \
               f"{self.message}"

    def as_json(self) -> Dict[str, Any]:
        return {
            "code": self.code,
            "where": self.where,
            "scope": self.scope,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


def sort_findings(findings: List[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.code, f.where, f.scope))


def findings_json(findings: List[Finding]) -> List[Dict[str, Any]]:
    return [f.as_json() for f in sort_findings(findings)]


@dataclasses.dataclass
class PassResult:
    """Outcome of one pass over one subject (kernel or file set)."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    suppressed: List[Tuple[Finding, str]] = dataclasses.field(
        default_factory=list
    )  # (finding, reason)
    error: Optional[str] = None  # pass crashed (counts as failure)
    # pass-specific structured payload riding into LINT.json: the range
    # pass serializes its proven invariants here, the taint pass its
    # proven-vs-optimistic gate counts and residual predicates.  Must be
    # JSON-serializable, deterministic (pre-sorted lists), and is NOT
    # part of ok/fail — it is drift-gated data, not findings.
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings and self.error is None

    def as_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "status": "pass" if self.ok else "fail",
            "findings": findings_json(self.findings),
            "suppressed": [
                dict(f.as_json(), reason=reason)
                for f, reason in sorted(
                    self.suppressed,
                    key=lambda p: (p[0].code, p[0].where, p[0].scope),
                )
            ],
        }
        if self.error is not None:
            out["error"] = self.error
        if self.extra:
            out["extra"] = self.extra
        return out


def assemble_report(
    kernels: Dict[str, Dict[str, PassResult]],
    host: PassResult,
    host_files: int,
) -> Dict[str, Any]:
    """The LINT.json document (sorted keys, no timestamps)."""
    kdoc = {
        name: {pname: pres.as_json() for pname, pres in sorted(
            passes.items()
        )}
        for name, passes in sorted(kernels.items())
    }
    n_fail = sum(
        1 for passes in kernels.values()
        for pres in passes.values() if not pres.ok
    ) + (0 if host.ok else 1)
    return {
        "version": LINT_VERSION,
        "generated_by": "python -m summerset_tpu_torch.graftlint",
        "kernels": kdoc,
        "host": dict(host.as_json(), files_scanned=host_files),
        "summary": {
            "kernels_verified": len(kernels),
            "failing_passes": n_fail,
            "clean": n_fail == 0,
        },
    }


def dumps_report(doc: Dict[str, Any]) -> str:
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"
