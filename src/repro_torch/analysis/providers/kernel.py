"""InstrumentedKernelProvider: the measured counter path.

Launches the instrumented Hopper kernel described by the spec and reads
the in-kernel per-wave degrees back — nothing is synthesized on the host.
This is the paper's "measured" column: the counters the paper wishes the
GPU exposed, computed by the kernel from the very index stream its
shared-memory atomics commit.

The compute device is explicit: ``InstrumentedKernelProvider(torch_device)``
launches on that device (the registered ``"kernel"`` instance uses
``"cuda"``; ``torch_device="cpu"`` runs the kernels' plain versions).
The ``indices`` route, which runs a bare index stream through the
instrumented scatter-add kernel (K6), comes with the scatter slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis.providers.base import (collect_batch_fallback,
                                                 register_provider)
from repro_torch.core.counters import CounterFrame, CounterSet


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
            raise NotImplementedError(
                f"WorkloadSpec {spec.label!r}: the 'kernel' provider runs an "
                f"index stream through the instrumented scatter-add kernel "
                f"(K6), which comes with the port's scatter slice; collect "
                f"it with the 'trace' provider")
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
            f"'kernel' provider needs a kernel | run spec, not a "
            f"pre-recorded trace")


register_provider(InstrumentedKernelProvider("cuda"))
