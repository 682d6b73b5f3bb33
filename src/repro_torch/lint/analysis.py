"""Static degree derivation: symbolic streams -> exact paper counters.

Where a scatter site's index stream is *static* — data-independent, or
dependent only on operands that are provably constant (a solid-color
probe image) — the stream can be evaluated per grid step with plain
numpy and fed through the very same ``trace_from_indices`` /
``CounterSet.from_trace`` pipeline the dynamic ``TraceProvider`` uses.
The derived counters are therefore **bit-for-bit identical** to what
trace synthesis would produce, with zero kernel launches and zero
provider collections (``Session.stats`` untouched); the tests pin that
equality on the paper's §5 hist/hist2 kernels, and the card holds K3's
measured degrees to the same derivation.

Fast path: when the stream does not depend on the grid position either,
every grid step commits the same tile stream, so degrees are computed
once per tile and tiled across the launch — the static derivation then
costs one tile evaluation instead of a full-stream synthesis.

Streams that read non-constant operand data classify as
``data-dependent`` and fall back to the dynamic audit path (KERN005
carries the probe ``WorkloadSpec`` for the existing sweep machinery).

Operands are numpy arrays or CPU tensors; nothing here launches a kernel.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from repro_torch.core import counters as counters_mod
from repro_torch.lint import symbolic as sym
from repro_torch.lint.tracing import (KernelModel, LaunchDecl, ScatterSite,
                                      build_model)

STATIC = "static"
DATA_DEPENDENT = "data-dependent"
OPAQUE = "opaque"


@dataclasses.dataclass
class StaticDerivation:
    """Outcome of classifying + evaluating one scatter site's stream."""

    classification: str                  # static | data-dependent | opaque
    site: ScatterSite
    model: KernelModel
    reasons: list
    tile_stream: Optional[np.ndarray] = None   # one grid step's indices
    reps: int = 1                              # grid steps (tile-periodic)
    stream: Optional[np.ndarray] = None        # full committed stream
    mean_degree: Optional[float] = None
    floor_degree: Optional[float] = None

    @property
    def is_static(self) -> bool:
        return self.classification == STATIC


def _constant_operand(arr) -> bool:
    arr = np.asarray(arr)
    return arr.size > 0 and bool(np.all(arr == arr.flat[0]))


def derive_stream(model: KernelModel, site: ScatterSite,
                  operands) -> StaticDerivation:
    """Classify a site's symbolic stream and, when static, evaluate it.

    ``operands`` are the launch inputs in *ref order* (the declaration's
    inputs); entries may be None when unknown.  Evaluation walks the grid
    in row-major order — the order the kernel's tiles are numbered and
    ``committed_index_stream`` concatenates them.
    """
    record = model.record
    reasons = sym.opaque_reasons(site.stream)
    if reasons:
        return StaticDerivation(OPAQUE, site, model,
                                [f"unmodeled op: {r}" for r in reasons])

    refs = sorted(sym.data_refs(site.stream))
    pids = sorted(sym.program_axes(site.stream))
    for r in refs:
        if r >= record.num_inputs:
            return StaticDerivation(
                DATA_DEPENDENT, site, model,
                [f"stream reads output/scratch ref {r}"])
        if r >= len(operands) or operands[r] is None:
            return StaticDerivation(
                DATA_DEPENDENT, site, model,
                [f"stream reads ref {r} with no operand bound"])
    if not all(_constant_operand(operands[r]) for r in refs):
        return StaticDerivation(
            DATA_DEPENDENT, site, model,
            [f"stream reads non-constant operand ref(s) {refs}"])

    steps = list(itertools.product(*(range(g) for g in record.grid)))
    reasons = ([f"affine over grid axes {pids}"] if pids
               else ["grid-invariant (tile-periodic)"])
    if refs:
        reasons.append(f"operand ref(s) {refs} provably constant")

    def _env(step):
        env = {("pid", a): s for a, s in enumerate(step)}
        for r in refs:
            env[("ref", r)] = record.block_for(r, operands[r], step)
        return env

    try:
        if not pids:
            tile = np.asarray(
                sym.evaluate(site.stream, _env(steps[0]))).reshape(-1)
            full = np.tile(tile, len(steps))
        else:
            parts = [np.asarray(
                sym.evaluate(site.stream, _env(s))).reshape(-1)
                for s in steps]
            tile, full = None, np.concatenate(parts)
    except sym.EvalError as e:
        return StaticDerivation(OPAQUE, site, model, [str(e)])

    return StaticDerivation(STATIC, site, model, reasons,
                            tile_stream=tile, reps=len(steps), stream=full)


def degree_stats(deriv: StaticDerivation) -> StaticDerivation:
    """Fill mean/floor degree on a static derivation (in place).

    ``floor_degree`` is the reorder-achievable lower bound: a lane remap
    can spread a wave's traffic across its *distinct* destinations but
    cannot create new ones, so per wave the best possible commit-group
    max multiplicity is ceil(group / min(distinct, group)).  hist-solid
    waves hold 4 distinct bins -> floor 8 vs observed 32; hist2 already
    sits on its floor (8) and lints clean.
    """
    if not deriv.is_static or deriv.stream is None:
        return deriv
    lanes, group = counters_mod.LANES, counters_mod.COMMIT_GROUP
    stream = deriv.stream
    n = stream.shape[0]
    w = max(1, n // lanes) if n % lanes == 0 else None
    if deriv.tile_stream is not None and \
            deriv.tile_stream.shape[0] % lanes == 0:
        tile2d = deriv.tile_stream.reshape(-1, lanes)
        deg = np.tile(
            counters_mod._degrees_full_waves(tile2d, group), deriv.reps)
        uniq = np.array([len(np.unique(row)) for row in tile2d], float)
        floors = np.ceil(group / np.minimum(uniq, group))
        deriv.floor_degree = float(np.mean(np.tile(floors, deriv.reps)))
    elif w:
        waves = stream.reshape(w, lanes)
        deg = counters_mod._degrees_full_waves(waves, group)
        uniq = np.array([len(np.unique(row)) for row in waves], float)
        deriv.floor_degree = float(np.mean(
            np.ceil(group / np.minimum(uniq, group))))
    else:
        deg = np.array([counters_mod.wave_degree(stream)])
        uniq = np.array([len(np.unique(stream))], float)
        deriv.floor_degree = float(np.ceil(group / min(uniq[0], group)))
    deriv.mean_degree = float(np.mean(deg))
    return deriv


# -- spec -> declared launch -------------------------------------------------


def _pad_rows(arr: np.ndarray, tile: int) -> np.ndarray:
    """Zero-pad the leading axis to a tile multiple."""
    n = arr.shape[0]
    pad = (-n) % tile
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    return arr


@dataclasses.dataclass
class LintTarget:
    """Everything needed to lint one kernel launch statically."""

    label: str
    decl: LaunchDecl             # the launch, as its launcher declares it
    operands: tuple              # inputs in ref order (numpy, or None)
    spec: Optional[object] = None          # probe WorkloadSpec
    module: Optional[object] = None        # source module (noqa scope)
    job_class: Optional[int] = None        # derived scatter job class
    waves_per_tile: Optional[int] = None


def target_from_spec(spec) -> LintTarget:
    """The declared launch a ``WorkloadSpec.kernel`` source makes."""
    if spec.kernel is None:
        raise ValueError(f"spec {spec.label!r} has no KernelSource")
    p = spec.kernel.params
    if spec.kernel.op == "histogram":
        from repro_torch.kernels.histogram import kernel as hist_kernel
        from repro_torch.kernels.histogram import ops as hist_ops

        img = _pad_rows(hist_ops.to_numpy(p["img"]).astype(np.int32),
                        hist_kernel.DEFAULT_TILE)
        weighted = bool(p.get("weighted", False))
        operands = [img]
        if weighted:
            operands.append(np.ones((img.shape[0],), np.float32))
        decl = hist_kernel.lint_declaration(
            img.shape[0], img.shape[1], num_bins=int(p.get("num_bins", 256)),
            reorder=p.get("variant", "hist") == "hist2", weighted=weighted)
        return LintTarget(
            label=spec.label, decl=decl, operands=tuple(operands),
            spec=spec, module=hist_kernel,
            job_class=hist_ops.histogram_job_class(
                force_fao=bool(p.get("force_fao", True)), weighted=weighted),
            waves_per_tile=spec.waves_per_tile
            or hist_ops.default_waves_per_tile(p["img"]))

    if spec.kernel.op == "scatter_add":
        from repro_torch.kernels.scatter_add import kernel as scat_kernel
        from repro_torch.kernels.scatter_add import ops as scat_ops

        num_segments = int(p["num_segments"])
        # the stream K6 commits: padded with ids that match no segment
        ids = scat_ops.committed_id_stream(p["ids"], num_segments)
        values = _pad_rows(scat_ops.to_numpy(p["values"]).astype(np.float32),
                           scat_kernel.DEFAULT_TILE)
        if values.ndim == 1:
            values = values[:, None]
        decl = scat_kernel.scatter_add_lint_declaration(
            ids.shape[0], values.shape[1], num_segments)
        # refs as the reference numbers them: 0 = ids, 1 = values
        return LintTarget(
            label=spec.label, decl=decl, operands=(ids, values), spec=spec,
            module=scat_kernel,
            job_class=int(p.get("job_class", spec.job_class)),
            waves_per_tile=spec.waves_per_tile
            or scat_ops.default_waves_per_tile())

    raise ValueError(
        f"no lint declaration for KernelSource op {spec.kernel.op!r}")


def analyze_target(target: LintTarget) -> list[KernelModel]:
    return [build_model(target.decl, name=target.label)]


# -- counters ----------------------------------------------------------------


def _trace_from_derivation(deriv: StaticDerivation, spec, *,
                           job_class: int, waves_per_tile: int):
    """Mirror of ``TraceProvider._synthesize``'s trace construction.

    The tile-periodic fast path computes degrees on one tile and tiles
    them — bit-identical to ``trace_from_indices`` on the full stream
    because that function's bulk path is itself per-wave over the same
    commit groups (`_degrees_full_waves` rows don't interact).
    """
    lanes = counters_mod.LANES
    pd = spec.pipeline_depth or 2
    tile = deriv.tile_stream
    if tile is not None and tile.shape[0] % lanes == 0 \
            and tile.shape[0] > 0:
        deg_tile = counters_mod._degrees_full_waves(
            tile.reshape(-1, lanes), counters_mod.COMMIT_GROUP)
        degree = np.tile(deg_tile, deriv.reps)
        num_waves = degree.shape[0]
        tiles = np.arange(num_waves) // max(waves_per_tile, 1)
        return counters_mod.WaveTrace(
            degree=degree,
            job_class=np.full(num_waves, job_class, np.int32),
            core=(tiles % spec.num_cores).astype(np.int32),
            lanes_active=np.full(num_waves, float(lanes)),
            waves_per_tile=waves_per_tile,
            pipeline_depth=pd)
    return counters_mod.trace_from_indices(
        deriv.stream, spec.num_bins, num_cores=spec.num_cores,
        job_class=job_class, waves_per_tile=waves_per_tile,
        pipeline_depth=pd)


def derive_counters(spec, *, target: Optional[LintTarget] = None,
                    model: Optional[KernelModel] = None):
    """(CounterSet, StaticDerivation) for a spec's kernel — statically.

    Returns ``(None, derivation)`` when the stream is data-dependent or
    opaque (use the dynamic ``TraceProvider`` path instead).  Never
    launches the kernel: the stream is traced on meta tensors, and
    evaluated in numpy.
    """
    if target is None:
        target = target_from_spec(spec)
    if model is None:
        models = analyze_target(target)
        with_sites = [m for m in models if m.sites]
        if not with_sites:
            raise ValueError(
                f"no scatter site found in {target.label!r} "
                f"({len(models)} launch(es) modeled)")
        model = with_sites[0]
    deriv = derive_stream(model, model.sites[0], target.operands)
    if not deriv.is_static:
        return None, deriv
    degree_stats(deriv)
    trace = _trace_from_derivation(
        deriv, spec, job_class=target.job_class,
        waves_per_tile=target.waves_per_tile)
    cset = counters_mod.CounterSet.from_trace(
        trace, label=spec.label, num_cores=spec.num_cores,
        bytes_read=spec.bytes_read, flops=spec.flops,
        overhead_cycles=spec.overhead_cycles, source="trace")
    return cset, deriv
