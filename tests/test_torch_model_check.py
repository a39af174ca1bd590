"""The port's exhaustive small-model explorer held to ``models/explore.py``
on the CPU: the same rows (nodes expanded, dedup hits, max committed
slots, violations, proven range leaves and pair facts asserted) at G=1,
R=3, W=4 under the 7-action fault alphabet, and a deliberately narrowed
invariant reported with its leaf, interval and step.
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "models"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from explore import explore as jexplore  # noqa: E402

from summerset_tpu_torch.analysis import explore as texplore  # noqa: E402

CROSSWORD = {"fault_tolerance": 0, "assignment_adaptive": False}

ROWS = [
    ("multipaxos", 3, {}),
    ("raft", 3, {}),
    ("rspaxos", 3, {"config_overrides": {"fault_tolerance": 1}}),
    ("multipaxos", 3, {"tally": "collective"}),
    ("crossword", 2, {"config_overrides": CROSSWORD}),
]


@pytest.mark.parametrize(
    "protocol,depth,kw", ROWS,
    ids=["multipaxos", "raft", "rspaxos", "multipaxos-collective",
         "crossword"],
)
def test_rows_equal_jax_explorer(protocol, depth, kw):
    port = texplore.explore(protocol, depth=depth, device="cpu", **kw)
    ref = jexplore(protocol, depth=depth, **kw)
    assert port.as_json() == ref.as_json()
    assert not port.violations
    # chip_smoke.py phase 24 (c) holds the card's rows to this table
    want = chip_smoke.EXPLORE_CPU_ROWS.get(protocol)
    if want is not None and kw.get("tally", "pairwise") == "pairwise":
        assert kw.get("config_overrides") == texplore.CLI_PRESETS.get(
            protocol)
        assert depth == chip_smoke.EXPLORE_DEPTH
        assert {k: port.as_json()[k] for k in want} == want
    assert port.max_committed_slots > 0
    if depth >= 3:
        assert port.nodes_expanded >= 7 + 7 * 7


def test_narrowed_invariant_is_reported():
    """An interval narrowed below what the kernel reaches is caught at
    the first step a witness state leaves it, naming the leaf, the
    interval and the fault-schedule step."""
    from summerset_tpu_torch.analysis.ranges import analyze_kernel_ranges

    k, _cfg = texplore.build("multipaxos", device="cpu")
    inv = dict(analyze_kernel_ranges(k).invariants)
    inv["commit_bar"] = (0, 0)
    r = texplore.explore("multipaxos", depth=2, device="cpu",
                         invariants=inv)
    hits = [v for v in r.violations if v.startswith(
        "range invariant violated: commit_bar proven in [0, 0]")]
    assert hits, r.violations
    assert "witness state at " in hits[0] and "@d" in hits[0]


def test_cli_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texplore.main(["--protocols", "multipaxos:1"])
