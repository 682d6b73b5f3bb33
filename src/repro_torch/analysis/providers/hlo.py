"""HloProvider: roofline counters from a compiled step: a captured torch
step or HLO text.

The scatter unit needs runtime data (it is data-dependent — that is the
paper's point), so this provider reports only the static side: FLOPs and
HBM bytes of a captured step (``hlo.flops_and_bytes``) and its
collectives' ring-model wire traffic (``hlo.capture_collectives``), or of
HLO text from the trip-count-aware ``hlo.analyze_module`` walk and the
collectives of the same walk.
The returned ``CounterSet`` has empty scatter counters;
``profile_counters`` then reports the three throughput servers
(HBM/MXU/ICI) with an empty per-core table.  Pair it with a trace/kernel
collection of the same step when the scatter verdict is also needed.

It launches nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis.providers.base import (collect_batch_fallback,
                                                 register_provider)
from repro_torch.core.counters import CounterFrame, CounterSet


class HloProvider:
    """Bytes/FLOPs/collective counters from HLO module text."""

    name = "hlo"

    def collect_batch(self, specs: Sequence, device, *,
                      parallel: Optional[int] = None) -> CounterFrame:
        """Loop fallback: each module's walk is independent, with no
        batched entry point.  All rows land on ``num_cores=1`` (the
        per-chip normalization below), so any mix of HLO specs frames
        rectangularly."""
        return collect_batch_fallback(self, specs, device, parallel)

    def collect(self, spec, device) -> CounterSet:
        from repro_torch.core import hlo as hlo_mod  # lazy: keeps import light

        del device  # cost extraction is device-independent
        meta: dict = {}
        if spec.compiled is not None:
            flops, nbytes = hlo_mod.flops_and_bytes(spec.compiled)
            coll = hlo_mod.capture_collectives(spec.compiled)
            wire = float(coll.total_wire_bytes)
            meta["collectives"] = coll.by_opcode()
        elif spec.hlo_text is not None:
            cost = hlo_mod.analyze_module(spec.hlo_text, spec.num_devices)
            flops, nbytes = float(cost.flops), float(cost.bytes)
            wire = float(cost.collective_wire_bytes)
            meta["unresolved_loops"] = cost.unresolved_loops
            if cost.collectives:
                meta["collectives"] = hlo_mod.CollectiveSummary(
                    ops=cost.collectives).by_opcode()
        else:
            raise ValueError(
                f"WorkloadSpec {spec.label!r} has no compiled/HLO source — "
                f"build it with WorkloadSpec.from_compiled(...)")
        # Whole-step artifacts are per-chip quantities: report against one
        # core so profile_counters does not dilute them by a core count the
        # compiler already accounted for.  A nonzero bytes_read/flops on
        # the spec is a caller override of the cost analysis — honor it,
        # as the other providers honor the same roofline-side fields.
        return CounterSet(
            label=spec.label, source=self.name, num_cores=1,
            bytes_read=spec.bytes_read or nbytes,
            flops=spec.flops or flops, ici_bytes=wire,
            overhead_cycles=spec.overhead_cycles, meta=meta)


register_provider(HloProvider())
