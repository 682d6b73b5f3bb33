"""Persistent cross-process counter cache for sweeps.

``Session`` already memoizes collected ``CounterSet``s per process by
content fingerprint; this module extends that memo across processes so a
repeated sweep in a new process skips counter *collection* (a kernel
launch per point, for the ``kernel`` provider) entirely and goes straight
to the batch model evaluation.  Entries are
one ``.npz`` per point under ``results/torch/cache/`` (relocate with the
``REPRO_TORCH_RESULTS`` environment variable; clear by deleting the
directory or via ``SweepCache.clear()``), keyed by

    provider name + ``WorkloadSpec.fingerprint()`` + ``Device.table_key()``
    + a content hash of the counter-producing source files

so a different counter source, workload content, launch geometry,
scatter-unit calibration, or collection *implementation* never collides
(a change to counter synthesis or to a CUDA kernel invalidates old
entries by construction — stale numbers cannot survive a code change).
The entry format is the reference's (``CACHE_VERSION``), but the root and
the key are the port's own: the two packages never read each other's
entries.  Specs whose content cannot be hashed (``fingerprint() is
None``: opaque ``run`` callables) are never cached, mirroring the
in-process memo.  Corrupt or truncated entries read as misses and are
overwritten on the next collection — the cache is an accelerator, never
a correctness input.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Union

import numpy as np

from repro_torch.core.counters import CounterSet
from repro_torch.obs import telemetry as _telemetry

_CACHE_LOOKUPS = _telemetry.counter(
    "repro_sweep_cache_lookups_total",
    "SweepCache.get outcomes (bulk reads route through get too)",
    ("result",))

CACHE_VERSION = 1


@functools.lru_cache(maxsize=1)
def _collection_code_digest() -> str:
    """Content hash of the counter-*producing* source files.

    The spec fingerprint and device key capture the inputs to
    ``collect``; this captures its implementation.  Folding it into
    every cache key means a change to counter synthesis (a provider, the
    wave-degree math, a kernel's committed-stream mirror, or the CUDA
    source of a kernel the ``kernel`` provider launches) automatically
    invalidates stale cross-process entries — nobody has to remember to
    bump ``CACHE_VERSION`` or clear the cache.  Over-inclusion only costs
    a cold re-collection, so the whole kernels package is hashed rather
    than chasing exact call graphs.
    """
    root = Path(__file__).resolve().parents[1]        # repro_torch/
    kernels = root / "kernels"
    paths = [root / "core" / "counters.py"]
    paths.extend(sorted((root / "analysis" / "providers").glob("*.py")))
    paths.extend(sorted(kernels.rglob("*.py")))
    paths.extend(sorted(kernels.glob("csrc/*.cu*")))
    h = hashlib.sha256()
    for p in paths:
        h.update(p.relative_to(root).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def results_root() -> Path:
    """``results/torch/`` at the repo root (``REPRO_TORCH_RESULTS``
    overrides): the port's results, apart from the reference's."""
    env = os.environ.get("REPRO_TORCH_RESULTS")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "results" / "torch"


def default_cache_root() -> Path:
    """``cache/`` under ``results_root()``."""
    return results_root() / "cache"


def save_counter_set(cset: CounterSet, path: Union[str, Path]) -> None:
    """Serialize one ``CounterSet`` to an ``.npz`` (atomic via tmp+rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(
                fh,
                version=np.int64(CACHE_VERSION),
                label=np.str_(cset.label),
                source=np.str_(cset.source),
                num_cores=np.int64(cset.num_cores),
                O=cset.O, N_f=cset.N_f, N_c=cset.N_c, N_p=cset.N_p,
                lanes_active=np.float64(cset.lanes_active),
                num_waves=np.int64(cset.num_waves),
                waves_per_tile=np.int64(cset.waves_per_tile),
                pipeline_depth=np.int64(cset.pipeline_depth),
                bytes_read=np.float64(cset.bytes_read),
                flops=np.float64(cset.flops),
                ici_bytes=np.float64(cset.ici_bytes),
                overhead_cycles=np.float64(cset.overhead_cycles),
                has_wall_time=np.bool_(cset.wall_time_s is not None),
                wall_time_s=np.float64(cset.wall_time_s
                                       if cset.wall_time_s is not None
                                       else 0.0),
                meta=np.str_(json.dumps(cset.meta, default=str)),
            )
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_counter_set(path: Union[str, Path]) -> CounterSet:
    """Inverse of ``save_counter_set`` (raises on any malformed entry)."""
    z = np.load(path)
    if int(z["version"]) != CACHE_VERSION:
        raise ValueError(f"cache entry version {int(z['version'])} != "
                         f"{CACHE_VERSION}")
    return CounterSet(
        label=str(z["label"]),
        source=str(z["source"]),
        num_cores=int(z["num_cores"]),
        O=z["O"], N_f=z["N_f"], N_c=z["N_c"], N_p=z["N_p"],
        lanes_active=float(z["lanes_active"]),
        num_waves=int(z["num_waves"]),
        waves_per_tile=int(z["waves_per_tile"]),
        pipeline_depth=int(z["pipeline_depth"]),
        bytes_read=float(z["bytes_read"]),
        flops=float(z["flops"]),
        ici_bytes=float(z["ici_bytes"]),
        overhead_cycles=float(z["overhead_cycles"]),
        wall_time_s=float(z["wall_time_s"]) if bool(z["has_wall_time"])
        else None,
        meta=json.loads(str(z["meta"])),
    )


class SweepCache:
    """One-file-per-point on-disk counter cache (see module docstring)."""

    def __init__(self, root: Optional[Union[str, Path]] = None) -> None:
        self.root = Path(root) if root is not None else default_cache_root()

    def key(self, provider_name: str, fingerprint: str,
            table_key: str) -> str:
        payload = (f"v{CACHE_VERSION}|{_collection_code_digest()}|"
                   f"{provider_name}|{fingerprint}|{table_key}")
        return hashlib.sha256(payload.encode()).hexdigest()[:32]

    def path(self, key: str) -> Path:
        return self.root / f"{key}.npz"

    def _glob(self, pattern: str) -> list:
        """Directory listing that treats a vanished root as empty.

        A concurrent ``clear()``/``rm -rf`` of the root (or a racing
        prune in another process) can delete the root between an
        ``exists()`` check and the scan; every maintenance surface
        resolves its file list through here so that race reads as an
        empty cache, never a crash.
        """
        try:
            return sorted(self.root.glob(pattern))
        except OSError:
            return []

    def _quarantine(self, path: Path) -> None:
        """Move a corrupt entry aside as ``<name>.npz.corrupt``.

        A corrupt entry left in place would be re-read (and re-fail) on
        every future lookup — a permanent per-request tax.  Renaming it
        turns the corruption into a one-time event: the key reads as a
        clean miss, the next collection overwrites it, and the evidence
        survives for ``stats()`` (``quarantined``) until ``prune()``
        deletes it.  Rename races with other readers or a
        concurrent clear are benign (first mover wins).
        """
        try:
            path.rename(path.with_name(path.name + ".corrupt"))
        except OSError:
            pass

    def get(self, key: str) -> Optional[CounterSet]:
        """Cached CounterSet, or ``None`` (missing or unreadable = miss).

        An unreadable-but-present entry is quarantined (see
        ``_quarantine``) instead of being left to fail again forever.
        """
        path = self.path(key)
        try:
            hit = load_counter_set(path)
            _CACHE_LOOKUPS.inc(result="hit")
            return hit
        except FileNotFoundError:
            _CACHE_LOOKUPS.inc(result="miss")
            return None
        except Exception:
            if path.exists():
                self._quarantine(path)
                _CACHE_LOOKUPS.inc(result="quarantined")
            else:
                _CACHE_LOOKUPS.inc(result="miss")
            return None

    def put(self, key: str, cset: CounterSet) -> None:
        save_counter_set(cset, self.path(key))

    def get_many(self, keys) -> dict[str, CounterSet]:
        """Bulk read: ``{key: CounterSet}`` for the keys present.

        Misses (absent or unreadable entries) are simply omitted — the
        batch sweep executor treats anything not in the returned dict as
        a point to collect.
        """
        out: dict[str, CounterSet] = {}
        for key in keys:
            hit = self.get(key)
            if hit is not None:
                out[key] = hit
        return out

    def put_many(self, entries: dict) -> None:
        """Bulk write-back; each entry keeps the atomic tmp+rename write,
        so concurrent shards racing on the same keys stay safe."""
        for key, cset in entries.items():
            self.put(key, cset)

    def iter_entries(self):
        """Yield ``(path, CounterSet | None)`` per on-disk entry
        (``None`` marks a corrupt/unreadable one), in stable path order —
        the shard-merge and maintenance iteration surface."""
        for f in self._glob("*.npz"):
            try:
                yield f, load_counter_set(f)
            except FileNotFoundError:
                continue    # vanished mid-iteration (concurrent clear)
            except Exception:
                yield f, None

    def stats(self) -> dict:
        """Entry count, bytes on disk, and a per-provider breakdown.

        The provider is recovered from each entry's stored ``source``
        field (keys are opaque hashes); unreadable entries are counted
        under ``"<corrupt>"`` and quarantined ``*.npz.corrupt`` files
        under ``quarantined``, so the report never hides either.  Files
        vanishing mid-scan (a concurrent ``clear()``) are skipped, and a
        deleted cache root reads as an empty cache.
        """
        entries = 0
        total_bytes = 0
        by_provider: dict[str, dict] = {}
        for path, cset in self.iter_entries():
            try:
                size = path.stat().st_size
            except OSError:
                continue    # vanished between listing and stat
            entries += 1
            total_bytes += size
            source = cset.source if cset is not None else "<corrupt>"
            bucket = by_provider.setdefault(source, {"entries": 0, "bytes": 0})
            bucket["entries"] += 1
            bucket["bytes"] += size
        return {"root": str(self.root), "entries": entries,
                "bytes": total_bytes,
                "quarantined": len(self._glob("*.npz.corrupt")),
                "by_provider": dict(sorted(by_provider.items()))}

    def prune(self, max_bytes: Optional[int] = None) -> tuple[int, int]:
        """Delete quarantined/tmp litter, then LRU-evict to ``max_bytes``.

        Quarantined ``*.npz.corrupt`` entries and orphaned ``*.tmp``
        files (a writer SIGKILLed between ``mkstemp`` and the atomic
        rename) are always removed — they serve no lookup and only
        accumulate.  Then, when ``max_bytes`` is given, oldest-written
        live entries go first (every write refreshes mtime via the
        tmp+rename, so mtime is last-write recency).  Returns
        ``(entries_removed, bytes_freed)`` over both phases.  Races with
        concurrent writers are benign: a vanished file is skipped, and
        evicting an entry another process still wants only costs it a
        re-collection.
        """
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        removed = 0
        freed = 0
        for f in self._glob("*.npz.corrupt") + self._glob("*.tmp"):
            try:
                size = f.stat().st_size
                f.unlink()
            except OSError:
                continue
            removed += 1
            freed += size
        if max_bytes is None:
            return removed, freed
        files = []
        for f in self._glob("*.npz"):
            try:
                st = f.stat()
            except OSError:
                continue
            files.append((st.st_mtime, st.st_size, f))
        total = sum(size for _, size, _ in files)
        for _, size, f in sorted(files, key=lambda t: (t[0], t[2].name)):
            if total <= max_bytes:
                break
            try:
                f.unlink()
            except OSError:
                continue
            total -= size
            removed += 1
            freed += size
        return removed, freed

    def clear(self) -> int:
        """Delete every entry (live, quarantined, tmp); returns how many
        live entries were removed.  Safe against concurrent clears."""
        n = 0
        for f in self._glob("*.npz"):
            try:
                f.unlink()
            except OSError:
                continue
            n += 1
        for f in self._glob("*.npz.corrupt") + self._glob("*.tmp"):
            try:
                f.unlink()
            except OSError:
                pass
        return n

    def __len__(self) -> int:
        return len(self._glob("*.npz"))
