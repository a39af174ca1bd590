"""Netem qdisc introspection (delay / jitter / rate of an emulated link),
the port's own copy of ``summerset_tpu/utils/qdisc.py``.

Parity: reference ``src/utils/qdisc.rs`` (``QdiscInfo::new/update``):
shells out to ``tc qdisc show dev <dev>`` and parses netem delay, jitter
and rate so that Crossword can fold emulated-network state into its perf
model.  Parsing is separate from the shell-out; without ``tc``, without
a device name, or when ``tc`` fails, ``update`` changes nothing and the
fields stay zero.  It never raises.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import Optional

_UNITS_TIME = {"us": 0.001, "ms": 1.0, "s": 1000.0}
_UNITS_RATE = {"bit": 1e-9, "Kbit": 1e-6, "Mbit": 1e-3, "Gbit": 1.0,
               "Tbit": 1e3}


def _parse_time_ms(tok: str) -> float:
    m = re.fullmatch(r"([0-9.]+)(us|ms|s)", tok)
    if not m:
        return 0.0
    return float(m.group(1)) * _UNITS_TIME[m.group(2)]


def _parse_rate_gbps(tok: str) -> float:
    m = re.fullmatch(r"([0-9.]+)(Tbit|Gbit|Mbit|Kbit|bit)", tok)
    if not m:
        return 0.0
    return float(m.group(1)) * _UNITS_RATE[m.group(2)]


class QdiscInfo:
    """Parsed netem state of one device: delay (ms), jitter (ms), rate
    (Gbps)."""

    def __init__(self, dev: Optional[str] = None):
        self.dev = dev
        self.delay_ms = 0.0
        self.jitter_ms = 0.0
        self.rate_gbps = 0.0

    def parse_output(self, output: str) -> bool:
        """Parse ``tc qdisc show`` output; True if netem was found."""
        for line in output.splitlines():
            if "netem" not in line:
                continue
            # fields absent from the current netem line must not keep
            # stale values from a previous update
            self.delay_ms = 0.0
            self.jitter_ms = 0.0
            self.rate_gbps = 0.0
            toks = line.split()
            for i, tok in enumerate(toks):
                if tok == "delay" and i + 1 < len(toks):
                    self.delay_ms = _parse_time_ms(toks[i + 1])
                    if i + 2 < len(toks) and re.fullmatch(
                        r"[0-9.]+(us|ms|s)", toks[i + 2]
                    ):
                        self.jitter_ms = _parse_time_ms(toks[i + 2])
                elif tok == "rate" and i + 1 < len(toks):
                    self.rate_gbps = _parse_rate_gbps(toks[i + 1])
            return True
        return False

    def update(self) -> bool:
        """Refresh by shelling out to ``tc`` (no-op without tc or dev)."""
        if self.dev is None or shutil.which("tc") is None:
            return False
        try:
            out = subprocess.run(
                ["tc", "qdisc", "show", "dev", self.dev],
                capture_output=True,
                text=True,
                timeout=2.0,
                check=False,
            ).stdout
        except (subprocess.SubprocessError, OSError):
            return False
        return self.parse_output(out)
