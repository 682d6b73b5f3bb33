"""Model-driven optimization advisor: search workload transforms, rank fixes.

The paper stops at diagnosis ("the scatter unit is your bottleneck");
this layer turns the same queueing model prescriptive.  A declarative
``Transform`` catalog rewrites ``WorkloadSpec``s without touching kernel
code (channel rotation à la ``hist2``, bin replication, CAS→FAO
substitution, launch geometry, lane interleave), a beam search
enumerates compositions, and every frontier is scored by ONE columnar
``profile_batch`` evaluation through the session's provider/memo/
``SweepCache`` machinery — the predicted speedups, post-transform
bottlenecks, and cost annotations come back as a ranked
``AdvisorReport``::

    from repro_torch.analysis import Session, WorkloadSpec
    sess = Session("v5e")
    report = sess.advise(WorkloadSpec.from_histogram(img, label="hist",
                                                     variant="hist"))
    print(report.render())        # rank 1: rotate-channels, x1.27 ...

Or from the command line::

    python -m repro_torch advise --workload histogram --dist solid \
        --pixels 2^16 --top-k 5 --validate-top 1
"""

from repro_torch.advisor.report import AdvisorReport, Candidate  # noqa: F401
from repro_torch.advisor.search import AdvisorSearch  # noqa: F401
from repro_torch.advisor.transforms import (  # noqa: F401
    CasToFao,
    ChannelRotation,
    LaneInterleave,
    Replicate,
    SetPipelineDepth,
    SetWavesPerTile,
    Transform,
    TransformCost,
    default_catalog,
)
