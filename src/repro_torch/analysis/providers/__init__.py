"""Pluggable counter-acquisition backends for the analysis Session.

One acquisition API for modeled and measured counters::

    Session(device="v5e", provider="kernel").classify(spec)
    Session(device="v5e").validate(spec, providers=("trace", "kernel"))

See ``base`` for the ``CounterProvider`` protocol and registry, and the
sibling modules for the three providers the port ships so far.
"""

from repro_torch.analysis.providers.base import (  # noqa: F401
    PROVIDERS,
    CounterProvider,
    collect_batch_fallback,
    get_provider,
    provider_collect_batch,
    register_provider,
)
from repro_torch.analysis.providers.kernel import (  # noqa: F401
    InstrumentedKernelProvider,
)
from repro_torch.analysis.providers.microbench import (  # noqa: F401
    MicrobenchProvider,
)
from repro_torch.analysis.providers.trace import TraceProvider  # noqa: F401
from repro_torch.core.counters import CounterSet  # noqa: F401
