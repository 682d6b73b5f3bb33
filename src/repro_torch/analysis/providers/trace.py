"""TraceProvider: the modeled counter path (no kernel launch).

This is the acquisition backend the pre-provider ``Session`` hardwired:
counters derived from a wave trace built on the host.  For ``indices``
and ``trace`` sources that is exactly the old behaviour; for ``kernel``
sources it *synthesizes the kernel's committed index stream in numpy*
(``committed_index_stream`` mirrors the in-kernel issue ordering bit for
bit) instead of launching the instrumented kernel — the "modeled"
column of the paper's §5 model-vs-measured validation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.analysis.providers.base import register_provider
from repro_torch.core import counters as counters_mod
from repro_torch.core.counters import CounterFrame, CounterSet


class TraceProvider:
    """Counters from a host-synthesized wave trace (see module docstring)."""

    name = "trace"

    def collect(self, spec, device) -> CounterSet:
        del device  # trace synthesis is device-independent
        if spec.kernel is not None:
            tr = self._synthesize(spec)
        else:
            tr = spec.resolve_trace()
        return self._from_trace(tr, spec)

    def collect_batch(self, specs: Sequence, device, *,
                      parallel: Optional[int] = None) -> CounterFrame:
        """Vectorized batch collection: one frame row per spec.

        Every spec whose counters come from a committed index stream
        (``indices`` sources and ``kernel`` sources, whose streams the
        kernel ops synthesize in numpy) is routed through
        ``traces_from_index_batch`` and the stacked per-core aggregation
        of ``countersets_from_traces``, so the whole grid's wave degrees
        AND counter bundles come out of a few large numpy ops.
        Pre-recorded ``trace`` sources and opaque ``run`` callables keep
        the scalar path per point.  Rows are bit-for-bit equal to
        ``collect`` — neither the batch degree kernel nor the stacked
        aggregation ever mixes rows (asserted per provider by
        ``Session.validate`` and the ``collect_batch_vs_loop`` canary).
        """
        del parallel  # the vectorized path has no per-point loop to thread
        specs = list(specs)
        if not specs:
            raise ValueError("collect_batch needs at least one spec")
        csets: list = [None] * len(specs)
        planned: list[int] = []
        streams, classes, wpts, depths, cores = [], [], [], [], []
        for i, spec in enumerate(specs):
            if spec.kernel is not None:
                stream, job_class, wpt = self._stream_plan(spec)
            elif spec.indices is not None:
                stream = np.asarray(spec.indices).reshape(-1)
                job_class = spec.job_class
                wpt = spec.waves_per_tile or 1
            else:
                csets[i] = self.collect(spec, device)
                continue
            planned.append(i)
            streams.append(stream)
            classes.append(job_class)
            wpts.append(wpt)
            depths.append(spec.pipeline_depth or 2)
            cores.append(spec.num_cores)
        if planned:
            traces = counters_mod.traces_from_index_batch(
                streams, num_cores=cores, job_class=classes,
                waves_per_tile=wpts, pipeline_depth=depths)
            batch_sets = counters_mod.countersets_from_traces(
                traces,
                labels=[specs[i].label for i in planned],
                num_cores=cores,
                bytes_read=[specs[i].bytes_read for i in planned],
                flops=[specs[i].flops for i in planned],
                overhead_cycles=[specs[i].overhead_cycles for i in planned],
                source=self.name)
            for i, cs in zip(planned, batch_sets):
                csets[i] = cs
        return CounterFrame.from_sets(csets)

    def _from_trace(self, tr: counters_mod.WaveTrace, spec) -> CounterSet:
        """The one aggregation call both scalar and batch paths share."""
        return CounterSet.from_trace(
            tr, label=spec.label, num_cores=spec.num_cores,
            bytes_read=spec.bytes_read, flops=spec.flops,
            overhead_cycles=spec.overhead_cycles, source=self.name)

    def _stream_plan(self, spec):
        """(committed stream, job class, waves_per_tile) for a kernel spec.

        The kernel family's committed-stream mirror makes the degrees
        match the in-kernel instrumentation exactly (cross-validated by
        the provider-equivalence tests and ``Session.validate``).
        """
        p = spec.kernel.params
        if spec.kernel.op == "histogram":
            from repro_torch.kernels.histogram import ops as hist_ops
            stream = hist_ops.committed_index_stream(
                p["img"], num_bins=p["num_bins"], variant=p["variant"])
            job_class = hist_ops.histogram_job_class(
                force_fao=p["force_fao"], weighted=p["weighted"])
            wpt = (spec.waves_per_tile
                   or hist_ops.default_waves_per_tile(p["img"]))
        elif spec.kernel.op == "scatter_add":
            from repro_torch.kernels.scatter_add import ops as scat_ops
            stream = scat_ops.committed_id_stream(
                p["ids"], p["num_segments"])
            job_class = p["job_class"]
            wpt = spec.waves_per_tile or scat_ops.default_waves_per_tile()
        else:
            raise ValueError(f"unknown kernel op {spec.kernel.op!r}")
        return stream, job_class, wpt

    def _synthesize(self, spec) -> counters_mod.WaveTrace:
        """Build the trace a kernel launch would emit, without launching."""
        stream, job_class, wpt = self._stream_plan(spec)
        # trace_from_indices' num_bins argument is unused (degrees come
        # from the raw index values); the spec default satisfies the
        # signature
        return counters_mod.trace_from_indices(
            stream, spec.num_bins, num_cores=spec.num_cores,
            job_class=job_class, waves_per_tile=wpt,
            pipeline_depth=spec.pipeline_depth or 2)


register_provider(TraceProvider())
