"""graftlint for the port: static verification of the kernel SPI contract
plus the host lint, counterpart of ``summerset_tpu/analysis``.

Four passes, one committed baseline (``summerset_tpu_torch/LINT.json``),
one entry point (``python -m summerset_tpu_torch.graftlint``):

- :mod:`.contract` — every registered kernel is built at a small static
  geometry on a device, one ``step`` is recorded as an aten trace
  (:mod:`.tracer`), and the ``KERNEL_CONTRACT`` rules are checked over
  its state, outbox, source and trace (C1–C10).
- :mod:`.ranges` — the inductive value-range prover over the recorded
  trace (intervals, widening, narrowing, pair facts; ``RANGE_CLAIMS``
  inductiveness is R2).
- :mod:`.taint` — the flags-taint pass: every inbox read that lands in a
  sink passed a ``flags``-derived gate (T1), with ``TAINT_ALLOW`` and its
  hygiene (T9).
- :mod:`.hostlint` — the AST concurrency lint over the port's ``host/``,
  ``manager/`` and ``utils/`` (H101–H106).

The exhaustive small-model explorer, the range prover's soundness
oracle, is :mod:`.explore`.
"""

from .contract import verify_kernel  # noqa: F401
from .hostlint import lint_host  # noqa: F401
from .ranges import (  # noqa: F401
    RangeAnalysis,
    analyze_kernel_ranges,
    verify_kernel_ranges,
)
from .report import (  # noqa: F401
    Finding,
    PassResult,
    assemble_report,
    dumps_report,
)
from .taint import verify_kernel_taint  # noqa: F401
