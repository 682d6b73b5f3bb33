"""WorkloadSpec: an immutable description of one scatter-heavy launch.

The old call path required the caller to (a) run an instrumented kernel,
(b) mutate ``trace.waves_per_tile`` after the fact, and (c) thread 11
kwargs into ``profiler.profile_scatter_workload``.  A ``WorkloadSpec``
captures all of that declaratively: what runs (an index stream, an
existing wave trace, a described kernel launch, or the HLO text of a
compiled step), under which launch geometry, and with which
roofline-side inputs (bytes read, FLOPs, overhead).  Specs are frozen —
sweeps derive variants with ``with_()`` instead of mutating shared
state.

A spec is deliberately *provider-agnostic*: it describes the workload,
not how its counters are acquired.  ``KernelSource`` keeps the kernel
launch as data (op name + arguments) rather than a baked closure, so the
``repro_torch.analysis.providers`` backends can either synthesize the
committed index stream in numpy (``TraceProvider``) or actually run the
instrumented Hopper kernel (``InstrumentedKernelProvider``) from one and
the same spec — the model-vs-measured split the paper's validation (§5)
needs.

A compiled step is described by its HLO text or by a captured torch step
(``launch.lowering.build_captured``), both through ``from_compiled``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Optional

import numpy as np

from repro_torch.core import counters as counters_mod
from repro_torch.core import timing


def _host(value) -> np.ndarray:
    """Host copy of an array or tensor, for hashing."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """A described (not yet launched) instrumented-kernel source.

    ``op`` names the kernel family (``"histogram"`` | ``"scatter_add"``);
    ``params`` holds its source-specific arguments (image / ids / values /
    bins).  Launch geometry lives on the owning ``WorkloadSpec`` so
    ``with_()`` derivations apply to the launch too.
    """

    op: str
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One profileable launch: measurement source + geometry + roofline.

    Exactly one of ``trace`` / ``indices`` / ``run`` / ``kernel`` /
    ``hlo_text`` is the measurement source (checked at construction).
    ``run`` is a zero-arg callable returning a ``WaveTrace`` — the escape
    hatch for custom instrumented sources, kept lazy so building a
    sweep's spec list costs nothing until a provider collects it.
    ``kernel`` is the declarative form the shipped providers understand
    (see ``from_histogram`` / ``from_scatter_add``).
    ``compiled`` (a captured torch step, ``launch.capture.Capture``) or
    ``hlo_text`` describes a compiled step for the HLO provider (no wave
    trace; roofline counters only).
    """

    label: str
    # measurement source (one of):
    trace: Optional[counters_mod.WaveTrace] = None
    indices: Optional[np.ndarray] = None
    run: Optional[Any] = None          # () -> WaveTrace, lazy custom source
    kernel: Optional[KernelSource] = None
    compiled: Optional[Any] = None     # captured torch step (HLO provider)
    hlo_text: Optional[str] = None     # HLO module text (HLO provider)
    # index-stream interpretation (for the ``indices`` source):
    num_bins: int = 256
    job_class: int = timing.FAO
    # launch geometry:
    waves_per_tile: Optional[int] = None   # None: keep the source's own
    pipeline_depth: Optional[int] = None
    num_cores: int = 8
    num_devices: int = 1               # chips (HLO collective accounting)
    # roofline-side inputs:
    bytes_read: float = 0.0
    flops: float = 0.0
    overhead_cycles: float = 500.0

    def __post_init__(self) -> None:
        sources = sum(s is not None
                      for s in (self.trace, self.indices, self.run,
                                self.kernel))
        sources += self.compiled is not None or self.hlo_text is not None
        if sources != 1:
            raise ValueError(
                f"WorkloadSpec {self.label!r} needs exactly one measurement "
                f"source (trace | indices | run | kernel | compiled/hlo), "
                f"got {sources}")

    # -- derivation -------------------------------------------------------

    def with_(self, **changes) -> "WorkloadSpec":
        """Frozen-friendly variant derivation (sweeps, relabeling)."""
        return dataclasses.replace(self, **changes)

    def grid(self, **axes) -> list["WorkloadSpec"]:
        """Cartesian expansion of this spec over parameter axes.

        Each keyword names a spec field and supplies the values to sweep;
        the product is expanded in the given axis order (last axis fastest)
        and every point is relabeled ``label[k=v,...]`` so sweep reports
        and shift events stay self-describing::

            spec.grid(waves_per_tile=[4, 8, 32], pipeline_depth=[2, 4])
            # -> 6 specs, labels like "solid[waves_per_tile=4,pipeline_depth=2]"

        Pair with ``Session.sweep`` (or ``sweep_grid`` for a device axis).
        """
        for k in axes:
            if k not in {f.name for f in dataclasses.fields(self)}:
                raise ValueError(
                    f"grid axis {k!r} is not a WorkloadSpec field")
        keys = list(axes)
        out = []
        for combo in itertools.product(*(axes[k] for k in keys)):
            changes = dict(zip(keys, combo))
            suffix = ",".join(f"{k}={v}" for k, v in changes.items())
            out.append(self.with_(label=f"{self.label}[{suffix}]", **changes))
        return out

    def fingerprint(self) -> Optional[str]:
        """Content hash of everything a provider's ``collect`` reads.

        Keys the sweep engine's per-point memoization: two specs with the
        same fingerprint yield the same ``CounterSet`` from a (stateless)
        provider, so a repeated grid point or a re-run sweep is served
        from cache.  The label is deliberately *excluded* — it names the
        point but does not change the measurement (the cache relabels).
        Opaque sources (``run`` callables) are not hashable by content:
        returns ``None``, meaning "never memoize".
        """
        if self.run is not None:
            return None
        h = hashlib.sha256()

        def put(*parts) -> None:
            for part in parts:
                if isinstance(part, np.ndarray):
                    arr = np.ascontiguousarray(part)
                    h.update(str(arr.dtype).encode())
                    h.update(str(arr.shape).encode())
                    h.update(arr.tobytes())
                else:
                    h.update(repr(part).encode())
                h.update(b"|")

        if self.trace is not None:
            put("trace", self.trace.degree, self.trace.job_class,
                self.trace.core, self.trace.lanes_active,
                self.trace.waves_per_tile, self.trace.pipeline_depth)
        elif self.indices is not None:
            put("indices", np.asarray(self.indices))
        elif self.kernel is not None:
            put("kernel", self.kernel.op)
            for k in sorted(self.kernel.params):
                v = self.kernel.params[k]
                put(k, _host(v) if hasattr(v, "shape") else v)
        elif self.compiled is not None:
            put("capture", self.compiled.text, self.compiled.chips)
        if self.hlo_text is not None:
            put("hlo", self.hlo_text)
        put(self.num_bins, self.job_class, self.waves_per_tile,
            self.pipeline_depth, self.num_cores, self.num_devices,
            self.bytes_read, self.flops, self.overhead_cycles)
        return h.hexdigest()

    def resolve_trace(self, torch_device="cuda") -> counters_mod.WaveTrace:
        """Materialize the wave trace with this spec's geometry applied.

        Runs the kernel on ``torch_device`` for ``kernel`` sources, and
        calls ``run`` sources (``TraceProvider`` synthesizes ``kernel``
        sources without a launch instead).  Never mutates the source
        trace: geometry overrides produce a copied-geometry view via
        ``WaveTrace.with_geometry``.
        """
        if self.compiled is not None or self.hlo_text is not None:
            raise ValueError(
                f"WorkloadSpec {self.label!r} has no wave-trace source "
                f"(compiled/HLO specs carry roofline counters only — "
                f"collect them with the 'hlo' provider)")
        if self.trace is not None:
            tr = self.trace
        elif self.run is not None:
            tr = self.run()
        elif self.kernel is not None:
            tr = self.run_kernel(torch_device)
        else:
            tr = counters_mod.trace_from_indices(
                np.asarray(self.indices), self.num_bins,
                num_cores=self.num_cores, job_class=self.job_class,
                waves_per_tile=self.waves_per_tile or 1,
                pipeline_depth=self.pipeline_depth or 2)
        if self.waves_per_tile is not None or self.pipeline_depth is not None:
            tr = tr.with_geometry(self.waves_per_tile, self.pipeline_depth)
        return tr

    def run_kernel(self, torch_device="cuda") -> counters_mod.WaveTrace:
        """Launch the described instrumented kernel on ``torch_device``;
        return its trace."""
        if self.kernel is None:
            raise ValueError(f"WorkloadSpec {self.label!r} has no kernel "
                             f"source")
        p = self.kernel.params
        if self.kernel.op == "histogram":
            from repro_torch.kernels.histogram import ops as hist_ops
            _, tr = hist_ops.histogram_instrumented(
                p["img"], variant=p["variant"], force_fao=p["force_fao"],
                weighted=p["weighted"], num_bins=p["num_bins"],
                num_cores=self.num_cores,
                waves_per_tile=self.waves_per_tile,
                pipeline_depth=self.pipeline_depth or 2,
                torch_device=torch_device)
            return tr
        if self.kernel.op == "scatter_add":
            from repro_torch.kernels.scatter_add import ops as scat_ops
            _, c = scat_ops.instrumented_scatter_add(
                p["ids"], p["values"], p["num_segments"],
                num_cores=self.num_cores, job_class=p["job_class"],
                waves_per_tile=self.waves_per_tile,
                pipeline_depth=self.pipeline_depth or 2,
                torch_device=torch_device)
            return c["trace"]
        raise ValueError(f"unknown kernel op {self.kernel.op!r}")

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_trace(cls, trace: counters_mod.WaveTrace, *, label: str,
                   **kw) -> "WorkloadSpec":
        return cls(label=label, trace=trace, **kw)

    @classmethod
    def from_indices(cls, indices, num_bins: int, *, label: str,
                     **kw) -> "WorkloadSpec":
        """Synthetic/offline index stream (no kernel run needed)."""
        spec = cls(label=label, indices=np.asarray(indices),
                   num_bins=num_bins, **kw)
        if spec.bytes_read == 0.0:
            spec = spec.with_(bytes_read=float(np.asarray(indices).size * 4))
        return spec

    @classmethod
    def from_histogram(cls, img, *, label: str, variant: str = "hist",
                       force_fao: bool = True, weighted: bool = False,
                       num_bins: int = 256, **kw) -> "WorkloadSpec":
        """Instrumented histogram kernel launch as the counter source.

        ``bytes_read`` defaults to the image's HBM traffic (1 byte per
        channel, as in the paper's case study).
        """
        spec_kw = dict(kw)
        if "bytes_read" not in spec_kw:
            from repro_torch.kernels.histogram import ops as hist_ops
            spec_kw["bytes_read"] = hist_ops.image_bytes(img)
        return cls(label=label,
                   kernel=KernelSource(op="histogram", params={
                       "img": img, "variant": variant,
                       "force_fao": force_fao, "weighted": weighted,
                       "num_bins": num_bins}),
                   **spec_kw)

    @classmethod
    def from_scatter_add(cls, ids, values, num_segments: int, *, label: str,
                         job_class: int = timing.FAO, **kw) -> "WorkloadSpec":
        """Instrumented scatter-add launch (K6) as the counter source."""
        spec_kw = dict(kw)
        spec_kw.setdefault("bytes_read", float(np.asarray(ids).size * 4))
        return cls(label=label,
                   kernel=KernelSource(op="scatter_add", params={
                       "ids": ids, "values": values,
                       "num_segments": num_segments,
                       "job_class": job_class}),
                   **spec_kw)

    @classmethod
    def from_compiled(cls, compiled=None, *, label: str,
                      hlo_text: Optional[str] = None, num_devices: int = 1,
                      **kw) -> "WorkloadSpec":
        """Compiled-step source for the HLO provider (roofline counters).

        Pass a captured torch step (``launch.lowering.build_captured``,
        a ``launch.capture.Capture``), an HLO module text, or both (the
        capture supplies FLOPs, bytes and collectives).  Anything else as
        ``compiled`` (a JAX compiled object among them) raises
        ``ValueError``.
        """
        if compiled is not None and not (hasattr(compiled, "nodes")
                                         and hasattr(compiled, "text")):
            raise ValueError(
                f"from_compiled takes a captured step "
                f"(launch.lowering.build_captured) or hlo_text, not a "
                f"{type(compiled).__name__!r}")
        if compiled is not None and num_devices == 1:
            num_devices = compiled.chips
        return cls(label=label, compiled=compiled, hlo_text=hlo_text,
                   num_devices=num_devices, **kw)
