"""Profiling-as-a-service: the paper's tool behind a localhost daemon.

``python -m repro_torch serve`` turns the ``Session`` API into a
long-running HTTP service: ``WorkloadSpec`` JSON jobs (profile / sweep /
advise / validate / heatmap) are queued onto a bounded worker pool that
shares one cross-request memo and persistent ``SweepCache`` per device —
a hot spec costs zero collection no matter which client asks.  Every
provider call runs through ``repro_torch.analysis.resilience``
(deadlines, retries, breakers, degraded fallbacks), so the daemon sheds
load with 429s and degrades with marked responses instead of hanging or
five-hundreding.  With ``--provider kernel`` the instrumented kernels
(K3, K6) on the card are the daemon's primary counter source::

    python -m repro_torch serve --port 8642 --workers 4 \
        --provider kernel --fallbacks trace
    python -m repro_torch client --port 8642 submit \
        --job '{"kind": "profile", "workload": {"size": 16384}}'

``--torch-device cpu`` runs the kernels' plain versions instead.

Python surface::

    from repro_torch.service import ProfilingService, ServiceConfig, serve
    svc = ProfilingService(ServiceConfig(workers=4))
    svc.start()
    response = svc.submit({"kind": "profile",
                           "workload": {"workload": "indices"}})
"""

from repro_torch.service.client import (  # noqa: F401
    ServiceClient,
    ServiceError,
)
from repro_torch.service.jobs import (  # noqa: F401
    JOB_KINDS,
    Job,
    JobError,
    parse_job,
)
from repro_torch.service.server import (  # noqa: F401
    ProfilingService,
    ServiceConfig,
    ServiceOverloaded,
    serve,
)
