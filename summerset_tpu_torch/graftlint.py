"""graftlint for the port: the kernel-contract verifier, the range prover,
the flags-taint pass and the host lint over ``summerset_tpu_torch``,
counterpart of ``scripts/graftlint.py``.

Usage::

    python -m summerset_tpu_torch.graftlint --device cpu          # run, print
    python -m summerset_tpu_torch.graftlint --write --device cpu  # rewrite
                                                   # summerset_tpu_torch/LINT.json
    python -m summerset_tpu_torch.graftlint --check               # on the card:
                                   # fail on findings or drift vs LINT.json
    python -m summerset_tpu_torch.graftlint --only taint --kernel raft -v

Kernels are built on ``--device`` (default ``cuda``; with no card the
run raises, as every entry point of the port does).  The report is the
same on either device, so the committed CPU baseline also checks a run on
the card.  Exit status: 0 = clean (and, with ``--check``, the baseline
matches); 1 = any finding, pass error or drift.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from . import protocols
from .analysis import (
    assemble_report,
    dumps_report,
    lint_host,
    verify_kernel,
    verify_kernel_ranges,
    verify_kernel_taint,
)
from .device import resolve_device

PKG_ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE = os.path.join(PKG_ROOT, "LINT.json")
PASSES = ("contract", "ranges", "taint", "host")

#: the JAX package's gate totals over its 11 kernels (``python
#: scripts/graftlint.py`` on the CPU, jax 0.9.0), kept beside the port's
#: own in the report: the two traces differ, so the counts are pinned,
#: not required equal
JAX_TAINT_GATES = {"proven": 126, "optimistic": 37}


def run(device, passes=PASSES, kernels: Optional[List[str]] = None,
        verbose: bool = False, log=print) -> Dict:
    """Run the passes; returns ``{"doc", "n_findings", "seconds"}`` where
    ``doc`` is the LINT.json document (``None`` for a partial run)."""
    resolve_device(device)
    t0 = time.monotonic()
    names = protocols.protocol_names()
    partial = set(passes) != set(PASSES) or kernels is not None
    if kernels is not None:
        want = {k.lower() for k in kernels}
        unknown = want - set(names)
        if unknown:
            raise ValueError(f"unknown kernels {sorted(unknown)}; "
                             f"have {names}")
        names = [n for n in names if n in want]
    results = {}
    n_findings = 0
    gates = {"proven": 0, "optimistic": 0}
    for lname in names:
        kres = {}
        if "contract" in passes:
            kres["contract"] = verify_kernel(protocols.make_protocol,
                                             lname, device=device)
        if "ranges" in passes:
            kres["ranges"] = verify_kernel_ranges(protocols.make_protocol,
                                                  lname, device=device)
        if "taint" in passes:
            kres["taint"] = verify_kernel_taint(protocols.make_protocol,
                                                lname, device=device)
        if not kres:
            continue
        disp = protocols.protocol_display_name(lname)
        results[disp] = kres
        for pname, pres in sorted(kres.items()):
            status = "pass" if pres.ok else "FAIL"
            supp = f" ({len(pres.suppressed)} suppressed)" \
                if pres.suppressed else ""
            note = ""
            if pname == "ranges" and "variants" in pres.extra:
                vs = pres.extra["variants"].values()
                note = (f" ({len(pres.extra['variants'])} variants, "
                        f"{sum(len(v['invariants']) for v in vs)} leaves, "
                        f"{sum(len(v['pairs']) for v in vs)} pairs)")
            elif pname == "taint" and "gates_proven" in pres.extra:
                gp = pres.extra["gates_proven"]
                go = pres.extra["gates_optimistic"]
                gates["proven"] += gp
                gates["optimistic"] += go
                note = f" ({gp} proven / {go} optimistic gates)"
            log(f"{disp:>14s} {pname:<9s} {status}{supp}{note}")
            for f in pres.findings:
                n_findings += 1
                log(f"    {f.render()}")
            if pres.error:
                n_findings += 1
                log(f"    ERROR {pres.error}")
            if verbose:
                for f, reason in pres.suppressed:
                    log(f"    suppressed {f.render()}\n"
                        f"        reason: {reason}")
                for r in pres.extra.get("residuals", []):
                    log(f"    optimistic gate: {r['op']} [{r['phase']}] "
                        f"sources={r['sources']}")
    host, n_files = None, 0
    if "host" in passes:
        host, n_files = lint_host(PKG_ROOT)
        status = "pass" if host.ok else "FAIL"
        log(f"{'host-plane':>14s} astlint   {status} "
            f"({n_files} files, {len(host.suppressed)} suppressed)")
        for f in host.findings:
            n_findings += 1
            log(f"    {f.render()}")
        if verbose:
            for f, reason in host.suppressed:
                log(f"    suppressed {f.render()}\n"
                    f"        reason: {reason}")
    if "taint" in passes:
        log(f"{'':>14s} gate polarity: {gates['proven']} proven, "
            f"{gates['optimistic']} optimistic (JAX package: "
            f"{JAX_TAINT_GATES['proven']} / {JAX_TAINT_GATES['optimistic']})")
    doc = None
    if not partial:
        doc = assemble_report(results, host, n_files)
        doc["summary"]["taint_gates"] = {
            "port": gates, "jax_package": dict(JAX_TAINT_GATES),
        }
    return {"doc": doc, "n_findings": n_findings,
            "seconds": time.monotonic() - t0}


def print_drift(old, new, path="", log=print) -> None:
    """Shallow recursive diff, enough to locate the drifting key."""
    if isinstance(old, dict) and isinstance(new, dict):
        for k in sorted(set(old) | set(new)):
            if k not in old:
                log(f"  + {path}/{k}")
            elif k not in new:
                log(f"  - {path}/{k}")
            elif old[k] != new[k]:
                print_drift(old[k], new[k], f"{path}/{k}", log)
    elif isinstance(old, list) and isinstance(new, list):
        log(f"  ~ {path}: list differs ({len(old)} -> {len(new)} entries)")
    else:
        log(f"  ~ {path}: {old!r} -> {new!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the kernels are built on (default: the "
                         "card; 'cpu' to run here)")
    ap.add_argument("--out", default=BASELINE)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="compare against the committed baseline; fail "
                           "on findings or drift")
    mode.add_argument("--write", action="store_true",
                      help="rewrite the baseline")
    ap.add_argument("--only", action="append", choices=PASSES,
                    help="run a subset of passes (console only)")
    ap.add_argument("--kernel", action="append",
                    help="restrict kernel passes to these protocol names")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    partial = bool(args.only) or bool(args.kernel)
    if (args.check or args.write) and partial:
        ap.error("--check/--write need the full run: the baseline covers "
                 "every pass and kernel")
    out = run(args.device, tuple(args.only or PASSES), kernels=args.kernel,
              verbose=args.verbose)
    doc = out["doc"]
    if doc is None:
        print(f"graftlint (partial): {out['n_findings']} finding(s)")
        return 1 if out["n_findings"] else 0
    if args.check:
        try:
            with open(args.out, "r") as f:
                committed = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"graftlint --check: cannot read baseline {args.out}: {e}")
            return 1
        if committed != doc:
            print(f"graftlint --check: DRIFT against {args.out} — "
                  "regenerate with --write and commit the diff with the "
                  "change that caused it")
            print_drift(committed, doc)
            return 1
        print(f"graftlint --check: baseline matches ({args.out})")
    elif args.write:
        with open(args.out, "w") as f:
            f.write(dumps_report(doc))
        print(f"wrote {args.out}")
    clean = doc["summary"]["clean"]
    print(f"graftlint: {'CLEAN' if clean else 'FINDINGS'} "
          f"({doc['summary']['kernels_verified']} kernels, "
          f"{out['n_findings']} finding(s), {out['seconds']:.1f} s)")
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main())
