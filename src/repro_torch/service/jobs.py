"""Job schema: JSON payloads -> validated ``WorkloadSpec`` jobs.

The service accepts the same declarative workload description the CLI
does (family + content knobs + launch-geometry axes), as JSON::

    {"kind": "sweep",
     "device": "v5e",
     "timeout_s": 20,
     "workload": {"workload": "indices", "size": 16384, "dist": "solid",
                  "waves_per_tile": [4, 8, 32]}}

Parsing is strict and *up front* — unknown keys, wrong types, empty
grids, and over-budget sweeps all raise ``JobError`` (HTTP 400) before
any session or device work starts, mirroring the CLI's argparse
rejection matrix.  Spec construction delegates to
``repro_torch.cli.workloads.build_specs``, so a service job is
bit-identical to the same CLI invocation.  The schema is the
reference's key for key, the ``hlo`` family (``hlo_file``,
``num_devices``) included; its specs carry no wave trace, so a daemon
answers them through the ``hlo`` provider.

``device`` is the *modeled* device (``v5e``/``v5p``); where the kernels
run is the service's ``torch_device``, not a job's.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

from repro_torch.analysis.workload import WorkloadSpec

JOB_KINDS = ("profile", "sweep", "advise", "validate", "heatmap")

# one declarative workload surface, shared with the CLI: every key the
# ``repro_torch.cli.workloads.build_specs`` namespace reads, with its
# default
WORKLOAD_DEFAULTS: dict = {
    "workload": "indices",
    "size": None,
    "pixels": None,
    "dist": "uniform",
    "variant": "hist",
    "num_bins": 256,
    "num_segments": 256,
    "seed": 0,
    "hlo_file": None,
    "num_devices": 1,
    "label": None,
    "waves_per_tile": None,
    "pipeline_depth": None,
    "num_cores": 8,
    "bytes_read": None,
    "flops": None,
    "overhead_cycles": 500.0,
}

class JobError(ValueError):
    """A malformed job payload (maps to HTTP 400)."""


@dataclasses.dataclass
class Job:
    """One validated unit of service work."""

    kind: str
    device: str
    specs: list[WorkloadSpec]
    timeout_s: float
    options: dict                  # kind-specific knobs (advise/validate)
    workload: dict                 # the raw (defaulted) workload payload

    @property
    def label(self) -> str:
        return self.specs[0].label if self.specs else "<empty>"


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise JobError(message)


def _check_number(name: str, value, *, minimum=None,
                  integral: bool = False) -> None:
    _require(isinstance(value, (int, float))
             and not isinstance(value, bool)
             and math.isfinite(value),
             f"{name} must be a finite number, got {value!r}")
    if integral:
        _require(float(value) == int(value),
                 f"{name} must be an integer, got {value!r}")
    if minimum is not None:
        _require(value >= minimum,
                 f"{name} must be >= {minimum}, got {value!r}")


def _workload_namespace(workload: dict) -> argparse.Namespace:
    """The defaulted, type-checked namespace ``build_specs`` consumes."""
    _require(isinstance(workload, dict),
             f"'workload' must be an object, got {type(workload).__name__}")
    unknown = sorted(set(workload) - set(WORKLOAD_DEFAULTS))
    _require(not unknown,
             f"unknown workload key(s): {', '.join(unknown)} "
             f"(known: {', '.join(sorted(WORKLOAD_DEFAULTS))})")
    merged = {**WORKLOAD_DEFAULTS, **workload}
    for name in ("size", "pixels", "waves_per_tile", "pipeline_depth"):
        value = merged[name]
        if value is None:
            continue
        values = value if isinstance(value, list) else [value]
        _require(len(values) > 0, f"{name} must not be an empty list")
        for v in values:
            _check_number(name, v, minimum=1, integral=True)
        merged[name] = [int(v) for v in values] \
            if isinstance(value, list) else int(value)
    for name, minimum in (("num_bins", 1), ("num_segments", 1),
                          ("num_devices", 1), ("num_cores", 1),
                          ("seed", 0), ("overhead_cycles", 0.0)):
        _check_number(name, merged[name], minimum=minimum,
                      integral=name != "overhead_cycles")
    for name in ("bytes_read", "flops"):
        if merged[name] is not None:
            _check_number(name, merged[name], minimum=0.0)
    _require(merged["workload"] in ("indices", "histogram", "scatter",
                                    "hlo"),
             f"unknown workload family {merged['workload']!r}")
    _require(merged["dist"] in ("solid", "uniform"),
             f"unknown dist {merged['dist']!r}")
    _require(merged["variant"] in ("hist", "hist2"),
             f"unknown variant {merged['variant']!r}")
    return argparse.Namespace(**merged)


def build_workload_specs(workload: dict,
                         max_points: int = 4096) -> list[WorkloadSpec]:
    """Expand one workload payload to its full spec list (grid included)."""
    from repro_torch.cli import workloads as wl  # lazy: keeps import cheap
    ns = _workload_namespace(workload)
    # cheap combinatorics check before any content is synthesized
    n_points = 1
    for name in ("size", "pixels", "waves_per_tile", "pipeline_depth"):
        value = getattr(ns, name)
        if isinstance(value, list):
            n_points *= len(value)
    _require(n_points <= max_points,
             f"workload grid expands to {n_points} points, over the "
             f"service cap of {max_points}")
    try:
        specs, axes = wl.build_specs(ns)
        specs = wl.expand_grid(specs, axes)
    except JobError:
        raise
    except (ValueError, OSError) as exc:
        raise JobError(f"invalid workload: {exc}") from exc
    _require(len(specs) >= 1, "workload expanded to zero points")
    return specs


def parse_job(payload, *, default_timeout_s: float = 30.0,
              max_timeout_s: float = 300.0,
              max_points: int = 4096) -> Job:
    """Validate one JSON job payload into a ``Job`` (or raise JobError)."""
    _require(isinstance(payload, dict),
             f"job payload must be a JSON object, got "
             f"{type(payload).__name__}")
    known = {"kind", "device", "workload", "timeout_s", "options"}
    unknown = sorted(set(payload) - known)
    _require(not unknown,
             f"unknown job key(s): {', '.join(unknown)} "
             f"(known: {', '.join(sorted(known))})")
    kind = payload.get("kind")
    _require(kind in JOB_KINDS,
             f"kind must be one of {', '.join(JOB_KINDS)}, got {kind!r}")
    device = payload.get("device", "v5e")
    _require(isinstance(device, str) and device,
             f"device must be a non-empty string, got {device!r}")
    timeout_s = payload.get("timeout_s", default_timeout_s)
    _check_number("timeout_s", timeout_s, minimum=0.001)
    _require(timeout_s <= max_timeout_s,
             f"timeout_s must be <= {max_timeout_s}, got {timeout_s}")
    options = payload.get("options", {})
    _require(isinstance(options, dict), "options must be an object")
    _require("workload" in payload, "job payload needs a 'workload' object")

    specs = build_workload_specs(payload["workload"],
                                 max_points=max_points)
    if kind in ("profile", "advise", "validate", "heatmap"):
        _require(len(specs) == 1,
                 f"{kind} takes exactly one workload point, got "
                 f"{len(specs)} — use kind 'sweep' for multi-value axes")
    options = _check_options(kind, options)
    return Job(kind=kind, device=device, specs=specs,
               timeout_s=float(timeout_s), options=options,
               workload=payload["workload"])


_OPTION_SCHEMA = {
    # kind -> option name -> (minimum, integral)
    "advise": {"depth": (1, True), "beam_width": (1, True),
               "top_k": (1, True), "validate_top": (0, True)},
    "sweep": {"parallel": (1, True)},
    "profile": {},
    "validate": {},   # 'providers' handled separately
    "heatmap": {"top_k": (1, True)},  # 'hot_degree' handled separately
}
_ADVISE_DEFAULTS = {"depth": 2, "beam_width": 8, "top_k": 5,
                    "validate_top": 0}


def _check_options(kind: str, options: dict) -> dict:
    schema = _OPTION_SCHEMA[kind]
    extra_keys = {"providers"} if kind == "validate" else set()
    if kind == "heatmap":
        extra_keys = {"hot_degree"}
    unknown = sorted(set(options) - set(schema) - extra_keys)
    _require(not unknown,
             f"unknown option(s) for kind {kind!r}: {', '.join(unknown)}")
    out = dict(_ADVISE_DEFAULTS) if kind == "advise" else {}
    for name, (minimum, integral) in schema.items():
        if name in options:
            _check_number(name, options[name], minimum=minimum,
                          integral=integral)
            out[name] = int(options[name]) if integral else options[name]
    if kind == "heatmap" and "hot_degree" in options:
        _check_number("hot_degree", options["hot_degree"], minimum=1.0)
        out["hot_degree"] = float(options["hot_degree"])
    if kind == "validate":
        providers = options.get("providers", ["trace", "kernel"])
        _require(isinstance(providers, list) and len(providers) >= 2
                 and all(isinstance(p, str) for p in providers),
                 "validate providers must be a list of >= 2 provider "
                 "names")
        out["providers"] = providers
    return out


def describe_defaults() -> dict:
    """The defaulted workload schema (the ``/schema`` endpoint payload)."""
    return dict(WORKLOAD_DEFAULTS)


def mixed_burst(n: int, rng, *, sizes=(512, 1024, 2048),
                histogram: bool = False,
                validate_providers=("trace", "trace")) -> list[dict]:
    """A load of ``n`` job payloads, each point its own content, mixing
    every kind but ``heatmap`` (advise kept cheap): six in ten profile,
    two sweep, one validate, one advise.

    ``rng`` is a ``numpy.random.Generator``; each job draws a size from
    ``sizes``, a seed and a distribution, in that order.  With
    ``histogram`` every odd job is an image (``hist`` or ``hist2``, one
    more draw) instead of an index stream; ``validate_providers=None``
    leaves a validate job's default providers (``trace``, ``kernel``).
    """
    jobs = []
    for i in range(n):
        size = int(rng.choice(list(sizes)))
        seed = int(rng.integers(0, 40))
        dist = str(rng.choice(["solid", "uniform"]))
        if histogram and i % 2:
            workload = {"workload": "histogram", "pixels": size,
                        "seed": seed, "dist": dist,
                        "variant": str(rng.choice(["hist", "hist2"]))}
        else:
            workload = {"workload": "indices", "size": size, "seed": seed,
                        "dist": dist}
        roll = i % 10
        if roll < 6:
            jobs.append({"kind": "profile", "workload": workload})
        elif roll < 8:
            jobs.append({"kind": "sweep",
                         "workload": {**workload,
                                      "waves_per_tile": [2, 4]}})
        elif roll < 9:
            job = {"kind": "validate", "workload": workload}
            if validate_providers is not None:
                job["options"] = {"providers": list(validate_providers)}
            jobs.append(job)
        else:
            jobs.append({"kind": "advise", "workload": workload,
                         "options": {"depth": 1, "beam_width": 2,
                                     "top_k": 1}})
    return jobs
