"""Write one backend's block of the port's profile artifact,
``summerset_tpu_torch/PROFILE.json`` (counterpart of
``scripts/profile_run.py``; never the repo root's ``PROFILE.json``).

Per protocol x config variant at the canonical shape
(``host/profiling.py``): the analytic counts of one tick (aten ops and
kernel launches, in all and per phase; state, outbox and netstate
bytes), best-of-N steady seconds per tick and the committed-slot rate,
device time per phase, device busy time, idle share and launches per tick
under ``torch.profiler`` (on the card), peak device memory; then the
g-sweep, the mesh sweep (on repeated handles of the capture device), the
quorum-tally sweep and the phase-range overhead A/B.  The artifact holds
one block per backend (``cpu``, ``cuda``); a run replaces its own
backend's block and keeps the other.  Each block stamps torch, CUDA and,
on the card, ``nvidia-smi``'s name and power limit.

Usage::

    python -m summerset_tpu_torch.profile_run [--device cpu] [--markdown]
        [--out PATH] [--ticks N] [--reps N] [--no-overhead]

``--markdown`` prints PERF.md's phase table from the block just written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .host import profiling

ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "PROFILE.json")


def merge(path: str, block: dict) -> dict:
    """The artifact at ``path`` with ``block`` as its backend's block."""
    art = {}
    if os.path.exists(path):
        with open(path) as f:
            art = json.load(f)
    art["version"] = profiling.PROFILE_VERSION
    art["generated_by"] = "python -m summerset_tpu_torch.profile_run"
    art.setdefault("backends", {})[block["backend"]] = block
    return art


def main(argv=None) -> int:
    from .device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=ARTIFACT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' writes "
                         "the cpu block)")
    ap.add_argument("--protocols", default=",".join(
        profiling.CANONICAL_PROTOCOLS))
    ap.add_argument("--ticks", type=int, default=profiling.CANONICAL_TICKS)
    ap.add_argument("--reps", type=int, default=profiling.CANONICAL_REPS)
    ap.add_argument("--no-overhead", action="store_true")
    ap.add_argument("--markdown", action="store_true",
                    help="print PERF.md's phase table")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    block = profiling.build_profile(
        protocols=tuple(p.strip() for p in args.protocols.split(",")
                        if p.strip()),
        ticks=args.ticks, reps=args.reps,
        with_overhead=not args.no_overhead, device=dev,
        log=lambda m: print(m, flush=True),
    )
    art = merge(args.out, block)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote the {block['backend']} block of {args.out}")
    ov = block.get("scope_overhead")
    if ov:
        print(f"phase-range overhead: {ov['pct']}% ({ov['pairs']} "
              "interleaved pairs)")
    if args.markdown:
        print()
        print(profiling.phase_table_markdown(block))
    return 0


if __name__ == "__main__":
    sys.exit(main())
