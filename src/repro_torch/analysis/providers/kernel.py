"""InstrumentedKernelProvider: the measured counter path.

Launches the instrumented Hopper kernel described by the spec and reads
the in-kernel per-wave degrees back — nothing is synthesized on the host.
This is the paper's "measured" column: the counters the paper wishes the
GPU exposed, computed by the kernel (K1, inlined) from the committed index
stream, group by group.  The degrees are the stream's, not the atomic
traffic's: K3 commits one count atomic per pixel and step, but K6 adds
once per distinct id in each commit group.

The compute device is explicit: ``InstrumentedKernelProvider(torch_device)``
launches on that device (the registered ``"kernel"`` instance uses
``"cuda"``; ``torch_device="cpu"`` runs the kernels' plain versions).

``indices`` sources are routed through the instrumented scatter-add
kernel (K6; the index stream becomes a unit-value scatter), so even
synthetic streams can be cross-validated against in-kernel counters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.analysis.providers.base import (collect_batch_fallback,
                                                 register_provider)
from repro_torch.core.counters import CounterFrame, CounterSet
from repro_torch.kernels.scatter_add import ops as scat_ops


class InstrumentedKernelProvider:
    """Counters read back from an instrumented kernel launch."""

    name = "kernel"

    def __init__(self, torch_device="cuda") -> None:
        self.torch_device = torch_device

    def collect_batch(self, specs: Sequence, device, *,
                      parallel: Optional[int] = None) -> CounterFrame:
        """Grouped loop fallback: each spec is its own launch, so the batch
        is one scalar ``collect`` per spec — still one provider call per
        sweep group from the Session's point of view."""
        return collect_batch_fallback(self, specs, device, parallel)

    def collect(self, spec, device) -> CounterSet:
        del device  # the modeled device does not change what the kernel counts
        if spec.kernel is not None:
            # spec.run_kernel() owns the op dispatch and geometry
            # threading (one definition, shared with resolve_trace)
            return CounterSet.from_trace(
                spec.run_kernel(self.torch_device), label=spec.label,
                num_cores=spec.num_cores, bytes_read=spec.bytes_read,
                flops=spec.flops, overhead_cycles=spec.overhead_cycles,
                source=self.name, meta={"op": spec.kernel.op})
        if spec.indices is not None:
            return self._collect_indices(spec)
        if spec.run is not None:
            # custom lazy source: by contract it runs an instrumented
            # kernel and returns its trace
            tr = spec.resolve_trace(self.torch_device)
            return CounterSet.from_trace(
                tr, label=spec.label, num_cores=spec.num_cores,
                bytes_read=spec.bytes_read, flops=spec.flops,
                overhead_cycles=spec.overhead_cycles, source=self.name)
        raise ValueError(
            f"WorkloadSpec {spec.label!r} has no runnable source — the "
            f"'kernel' provider needs a kernel | indices | run spec, not "
            f"a pre-recorded trace")

    def _collect_indices(self, spec) -> CounterSet:
        """Run a bare index stream through the instrumented scatter-add.

        Geometry defaults mirror ``trace_from_indices`` (waves_per_tile 1)
        so the 'trace' and 'kernel' providers agree bit-for-bit.  The
        stream length must be a multiple of the kernel tile: a shorter
        stream would be sentinel-padded by the launch, and the padding
        waves would be *counted* — the measured N/e would then silently
        diverge from the trace provider's (which models the raw stream),
        turning every ``validate()`` into a false alarm.  Refuse instead.
        """
        idx = np.asarray(spec.indices).reshape(-1)
        tile = scat_ops.sk.DEFAULT_TILE
        if idx.size % tile != 0:
            raise ValueError(
                f"WorkloadSpec {spec.label!r}: the 'kernel' provider needs "
                f"an index stream sized to a multiple of the scatter tile "
                f"({tile}); got {idx.size}. Pad the stream, or use "
                f"WorkloadSpec.from_scatter_add (both providers then share "
                f"the kernel's own sentinel padding).")
        return scat_ops.collect_counters(
            idx, np.ones(idx.shape, np.float32), spec.num_bins,
            label=spec.label, num_cores=spec.num_cores,
            job_class=spec.job_class,
            waves_per_tile=spec.waves_per_tile or 1,
            pipeline_depth=spec.pipeline_depth or 2,
            bytes_read=spec.bytes_read, flops=spec.flops,
            overhead_cycles=spec.overhead_cycles,
            torch_device=self.torch_device)


register_provider(InstrumentedKernelProvider("cuda"))
