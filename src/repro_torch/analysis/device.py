"""Device registry: one bundle per modeled chip, one cached table per bundle.

The paper's Tool 1 output — the service-time table ``S(n, e, c)`` — is a
*per-device* artifact: "once per chip model" (§3.4).  Schweizer et al. and
Stevens & Klöckner both organize their atomic-cost models the same way: a
per-architecture parameter bundle plus a fitted table, looked up by device
name.  This module is that bundle for our reproduction:

    Device = ChipParams (throughput servers: MXU/HBM/ICI)
           + ScatterUnitParams (the load-dependent queue server)
           + CacheModel (LLC latency-exposure emulation)
           + lazily built, disk-cached ServiceTimeTable

Tables are cached as ``.npz`` under ``results/torch/tables/`` keyed by device
name and a hash of the scatter-unit calibration, so a second ``Session``
(or a ``--only`` benchmark run, or a test import) never pays the full-grid
microbenchmark again.  Changing the calibration constants invalidates the
key and triggers a rebuild.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Optional, Union

from repro_torch.core import microbench, qmodel, timing
from repro_torch.core.profiler import CacheModel

# In-process memo so repeated Session construction in one process does not
# even touch the filesystem.  Keyed like the on-disk cache.
_TABLE_MEMO: dict[str, qmodel.ServiceTimeTable] = {}


def default_cache_dir() -> Path:
    """``results/torch/tables/`` at the repo root (overridable per call).

    The port's own cache root, apart from the reference package's, so the
    two never read each other's files.  Resolved relative to this source
    tree so scripts and tests share one cache regardless of their working
    directory; set ``REPRO_TORCH_TABLE_CACHE`` to relocate it.
    """
    env = os.environ.get("REPRO_TORCH_TABLE_CACHE")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "results" / "torch" / "tables"


@dataclasses.dataclass(frozen=True)
class Device:
    """Immutable per-device parameter bundle (the registry entry)."""

    name: str
    chip: timing.ChipParams = timing.V5E
    scatter: timing.ScatterUnitParams = timing.V5E_SCATTER
    cache: CacheModel = CacheModel()
    num_cores: int = 8
    description: str = ""

    # -- table cache ------------------------------------------------------

    def table_key(self) -> str:
        """Cache key: device name + calibration hash + grid shape.

        Any change to the scatter-unit constants (the thing the table is
        built *from*) changes the key, so stale tables are never reused.
        """
        payload = json.dumps(dataclasses.asdict(self.scatter), sort_keys=True)
        digest = hashlib.sha256(payload.encode()).hexdigest()[:12]
        return (f"{self.name}-n{self.scatter.n_max}"
                f"-e{self.scatter.e_max}-{digest}")

    def table_path(self, cache_dir: Optional[Union[str, Path]] = None) -> Path:
        base = Path(cache_dir) if cache_dir is not None else default_cache_dir()
        return base / f"{self.table_key()}.npz"

    def table(self, cache_dir: Optional[Union[str, Path]] = None,
              refresh: bool = False) -> qmodel.ServiceTimeTable:
        """The device's service-time table, building it at most once.

        Resolution order: in-process memo -> ``.npz`` on disk -> full grid
        build (which is then written back to disk).  ``refresh=True``
        forces a rebuild and overwrites the cached file.
        """
        path = self.table_path(cache_dir)
        # memo key includes the resolved path: a caller asking for a
        # specific cache_dir must hit/populate THAT directory, not a table
        # memoized under a different one
        key = str(path)
        if not refresh and key in _TABLE_MEMO:
            return _TABLE_MEMO[key]
        if not refresh and path.exists():
            try:
                tab = qmodel.ServiceTimeTable.load(str(path))
            except Exception:
                tab = None  # corrupt/stale cache: fall through to rebuild
            if tab is not None:
                _TABLE_MEMO[key] = tab
                return tab
        tab = microbench.build_table(self.scatter)
        tab.meta["device"] = self.name
        path.parent.mkdir(parents=True, exist_ok=True)
        tab.save(str(path))
        _TABLE_MEMO[key] = tab
        return tab

    def describe(self, cache_dir: Optional[Union[str, Path]] = None) -> dict:
        """Flat summary record (the ``devices`` CLI listing / json row)."""
        return {
            "name": self.name,
            "description": self.description,
            "cores": self.num_cores,
            "clock_ghz": self.chip.clock_hz / 1e9,
            "hbm_gbps": self.chip.hbm_bw / 1e9,
            "table_cached": self.table_path(cache_dir).exists(),
        }

    # -- variants ---------------------------------------------------------

    def with_(self, **changes) -> "Device":
        """Derived device (e.g. a different CacheModel for case studies).

        A changed name keeps cache entries distinguishable in listings;
        the table cache itself is keyed by calibration, so variants that
        only change ``chip``/``cache``/``num_cores`` share the same table.
        """
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

DEVICES: dict[str, Device] = {}


def register_device(device: Device) -> Device:
    DEVICES[device.name] = device
    return device


register_device(Device(
    name="v5e",
    description="TPU v5e (default calibration; paper's Titan-V analogue)",
))

# A bandwidth-rich sibling: same scatter-unit calibration scaled to a
# faster clock, ~3.4x HBM and ~2.3x peak FLOPs (public v5p specs).  Shows
# the bottleneck-shift machinery reacting to hardware balance: workloads
# that are HBM-bound on v5e stay scatter-bound longer here.
register_device(Device(
    name="v5p",
    chip=timing.ChipParams(peak_bf16_flops=459e12, hbm_bw=2765e9,
                           ici_bw_per_link=100e9, clock_hz=1.75e9,
                           vmem_bytes=128 * 1024 * 1024,
                           hbm_bytes=95 * 1024**3),
    scatter=dataclasses.replace(timing.V5E_SCATTER, clock_hz=1.75e9),
    description="TPU v5p (modeled: v5e scatter calibration at v5p clock)",
))


def get_device(name_or_device: Union[str, Device]) -> Device:
    """Look up a registry entry; a Device instance passes through."""
    if isinstance(name_or_device, Device):
        return name_or_device
    try:
        return DEVICES[name_or_device]
    except KeyError:
        known = ", ".join(sorted(DEVICES))
        raise KeyError(
            f"unknown device {name_or_device!r}; registered: {known}. "
            f"Use repro_torch.analysis.register_device() for custom hardware."
        ) from None
