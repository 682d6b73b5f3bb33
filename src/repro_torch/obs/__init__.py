"""Observability: the process-wide metrics registry and tracing spans.

Stdlib only, below ``repro_torch.analysis`` in the import graph, so every
layer above can instrument itself without cycles.  The reference's other
half, the contention heat maps (``obs/heatmap.py``, ``obs/report.py``),
comes with the port's observability slice.
"""

from repro_torch.obs import telemetry

__all__ = ["telemetry"]
