"""Per-peer linear-regression performance model, the port's own copy of
``summerset_tpu/utils/linreg.py``.

Parity: reference ``src/utils/linreg.rs`` — ``LinearRegressor``
accumulates (payload size -> delivery time) samples per peer and fits
y = a + b*x (``append_sample:97``, ``calc_model:137``);
``PerfModel::predict`` (``linreg.rs:56``) projects the expected delivery
time of a payload size.  Crossword's adaptive shard assignment
(``host/adaptive.py``) reads it.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Tuple


class PerfModel:
    """y = interval + alpha + beta * x, with a jitter allowance."""

    def __init__(self, interval_ms: float = 0.0, alpha: float = 0.0,
                 beta: float = 0.0, jitter: float = 0.0):
        self.interval_ms = interval_ms
        self.alpha = alpha
        self.beta = beta
        self.jitter = jitter

    def update(self, alpha: float, beta: float) -> None:
        self.alpha = alpha
        self.beta = beta

    def predict(self, x: float) -> float:
        return self.interval_ms + self.alpha + self.beta * x + self.jitter

    def __repr__(self) -> str:
        return (f"PerfModel({self.interval_ms}+{self.alpha}+{self.beta}*x"
                f"~{self.jitter})")


class LinearRegressor:
    """Ordinary least squares over a sliding window of samples."""

    def __init__(self, window: int = 1000):
        self._samples: Deque[Tuple[float, float, float]] = deque(
            maxlen=window
        )

    def append_sample(self, t_ms: float, x: float, y: float) -> None:
        self._samples.append((t_ms, x, y))

    def discard_before(self, t_ms: float) -> None:
        while self._samples and self._samples[0][0] < t_ms:
            self._samples.popleft()

    def calc_model(self) -> Optional[Tuple[float, float]]:
        """Fit (alpha, beta); None if under-determined."""
        n = len(self._samples)
        if n < 2:
            return None
        xs = [s[1] for s in self._samples]
        ys = [s[2] for s in self._samples]
        mx = sum(xs) / n
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        if sxx == 0.0:
            return (my, 0.0)
        beta = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
        alpha = my - beta * mx
        return (alpha, beta)
