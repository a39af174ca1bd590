"""Crossword's host-side adaptive shard assignment, counterpart of
``summerset_tpu/host/adaptive.py``.

Parity: reference ``src/protocols/crossword/adaptive.rs:274+``: per-peer
linear-regression perf models (payload size -> delivery time,
``utils/linreg.py``) folded with netem qdisc introspection
(``utils/qdisc.py``) pick the shards-per-replica width pushed into the
Accept path.

The device kernel owns the reactive policy (per-peer lag counters
widening ``cur_spr``); this module is the predictive override: the host
samples per-peer frame delivery times (``TransportHub.samples``), fits a
model per peer, folds the local interface's netem state, and computes
the ``spr_override`` kernel input: the width whose predicted
critical-path delivery is fastest, full copies (``spr = d``) until there
is evidence.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..utils.linreg import LinearRegressor, PerfModel
from ..utils.qdisc import QdiscInfo


class CrosswordAdaptive:
    def __init__(
        self,
        population: int,
        data_shards: int,
        me: int,
        dev: Optional[str] = None,
        window_ms: float = 5000.0,
        refit_interval: float = 0.5,
    ):
        self.R = population
        self.d = data_shards
        self.me = me
        self.window_ms = window_ms
        self.refit_interval = refit_interval
        self._reg: Dict[int, LinearRegressor] = {
            p: LinearRegressor() for p in range(population) if p != me
        }
        self._model: Dict[int, PerfModel] = {
            p: PerfModel() for p in range(population) if p != me
        }
        self._qdisc = QdiscInfo(dev)
        self._last_fit = 0.0
        self._fitted: set = set()

    def observe(self, peer: int, nbytes: float, delay_ms: float) -> None:
        """One delivery sample: a frame of ``nbytes`` from ``peer`` took
        ``delay_ms`` from its send stamp to its receipt (same machine)."""
        reg = self._reg.get(peer)
        if reg is None or delay_ms < 0:
            return
        now_ms = time.monotonic() * 1e3
        reg.append_sample(now_ms, nbytes, delay_ms)
        reg.discard_before(now_ms - self.window_ms)

    def _refit(self) -> None:
        now = time.monotonic()
        if now - self._last_fit < self.refit_interval:
            return
        self._last_fit = now
        self._qdisc.update()
        for p, reg in self._reg.items():
            fit = reg.calc_model()
            if fit is not None:
                self._model[p].update(*fit)
                self._fitted.add(p)

    def predict_ms(self, peer: int, nbytes: float) -> float:
        """Predicted delivery time of ``nbytes`` to ``peer``, with the
        local netem delay and rate folded in."""
        m = self._model.get(peer)
        base = m.predict(nbytes) if m is not None else 0.0
        q = self._qdisc
        return base + q.delay_ms + (
            nbytes * 8e-9 / q.rate_gbps * 1e3 if q.rate_gbps > 0 else 0.0
        )

    def choose_spr(self, batch_bytes: float) -> int:
        """Shards per replica: the width whose predicted delivery to the
        slowest peer of its commit quorum (majority + d - spr acks) is
        fastest; ``d`` (full copies) without evidence."""
        self._refit()
        peers = sorted(self._reg)
        if not peers or batch_bytes <= 0 or not self._fitted:
            return self.d
        shard = batch_bytes / max(self.d, 1)
        best_spr, best_t = self.d, None
        majority = self.R // 2 + 1
        for spr in range(1, self.d + 1):
            k = min(majority + (self.d - spr) - 1, len(peers))
            if k <= 0:
                continue
            times = sorted(
                self.predict_ms(p, shard * spr) for p in peers
            )
            t = times[k - 1]
            if best_t is None or t < best_t:
                best_spr, best_t = spr, t
        return best_spr

    def overrides(self, num_groups: int, batch_bytes: float) -> List[int]:
        """The ``spr_override`` kernel input: one choice for every group
        (the host observes one shared TCP mesh)."""
        return [self.choose_spr(batch_bytes)] * num_groups
