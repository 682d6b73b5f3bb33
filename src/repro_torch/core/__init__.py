"""Core: operational single-server queuing model of data-dependent TPU
bottlenecks (Dong & Pai 2025, adapted from GPU shared-memory atomics to the
TPU VMEM scatter/accumulate path) plus the dry-run roofline machinery."""

from repro_torch.core.qmodel import (  # noqa: F401
    BasicCounters,
    CoreUtilization,
    ServiceTimeTable,
    derive_core_utilization,
    render_utilization_report,
)
from repro_torch.core.timing import CAS, FAO, POPC, V5E, V5E_SCATTER  # noqa: F401
from repro_torch.core.microbench import build_table, make_pattern  # noqa: F401
from repro_torch.core.counters import (  # noqa: F401
    CounterSet,
    WaveTrace,
    trace_from_indices,
)
from repro_torch.core.profiler import (  # noqa: F401
    CacheModel,
    WorkloadProfile,
    profile_counters,
    profile_scatter_workload,
)
from repro_torch.core.bottleneck import classify, detect_shifts  # noqa: F401
