"""Observability layer: contention attribution + pipeline telemetry.

Two halves, neither of which launches a kernel:

* :mod:`repro_torch.obs.heatmap` / :mod:`repro_torch.obs.report` —
  per-bin, per-wave contention attribution from committed index streams,
  with text/json/csv renderers (``Session.heatmap`` and
  ``python -m repro_torch heatmap`` land here);
* :mod:`repro_torch.obs.telemetry` — the process-wide metrics registry
  and tracing spans with propagated trace ids.

This package sits *below* ``repro_torch.analysis`` in the import graph:
it depends only on ``repro_torch.core``, numpy and the stdlib, so every
layer above can instrument itself without cycles.
"""

from repro_torch.obs import report, telemetry
from repro_torch.obs.heatmap import (DEFAULT_HOT_DEGREE, Heatmap,
                                     heatmap_for_spec, heatmap_from_stream)

__all__ = ["telemetry", "report", "Heatmap", "heatmap_for_spec",
           "heatmap_from_stream", "DEFAULT_HOT_DEGREE"]
