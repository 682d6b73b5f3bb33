"""Public analysis API: Device + provider registries, WorkloadSpec, Session.

The two paper tools in five lines:

    from repro_torch.analysis import Session, WorkloadSpec
    sess = Session(device="v5e")            # Tool 1: cached S(n, e, c) table
    spec = WorkloadSpec.from_histogram(img, label="solid 256Kpx",
                                       waves_per_tile=32)
    print(sess.classify(spec).comment)      # Tool 2: utilization -> verdict

Counter acquisition is pluggable: ``Session(provider="kernel")`` reads
counters back from the instrumented Hopper kernels instead of
synthesizing the trace, and ``sess.validate(spec)`` compares the two —
the paper's §5 model-vs-measured validation as one call.  ``device``
names the *modeled* chip; the kernels run on the provider's
``torch_device`` (``"cuda"`` for the registered ``"kernel"`` provider).
"""

from repro_torch.analysis.device import (  # noqa: F401
    DEVICES,
    Device,
    default_cache_dir,
    get_device,
    register_device,
)
from repro_torch.analysis.providers import (  # noqa: F401
    PROVIDERS,
    CounterProvider,
    CounterSet,
    FaultInjectionProvider,
    InjectedFault,
    InstrumentedKernelProvider,
    MicrobenchProvider,
    TraceProvider,
    get_provider,
    register_provider,
)
from repro_torch.analysis.resilience import (  # noqa: F401
    CircuitBreaker,
    CorruptCounterError,
    Deadline,
    DeadlineExceeded,
    ProviderCallTimeout,
    ResilienceExhausted,
    ResilientProvider,
    RetryPolicy,
    TransientProviderError,
    resilience_scope,
)
from repro_torch.analysis.render import (  # noqa: F401
    rows_to_csv,
    union_fieldnames,
)
from repro_torch.analysis.sweep_cache import (  # noqa: F401
    SweepCache,
    default_cache_root,
)
from repro_torch.analysis.workload import KernelSource, WorkloadSpec  # noqa: F401
from repro_torch.analysis.session import (  # noqa: F401
    ProviderComparison,
    Session,
    SweepResult,
    ValidationReport,
    sweep_grid,
)
from repro_torch.core.counters import CounterFrame  # noqa: F401
from repro_torch.core.profiler import profile_batch  # noqa: F401
