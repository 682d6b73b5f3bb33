"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/kernels/<digest>/lib<name>.so`` under the checkout.  The
digest hashes every ``.cu``/``.cuh`` source and the compiler flags, so an
edited source builds anew and an unchanged one is loaded as it is.  Nothing
is built when a module is imported: the first launch of a kernel (or
``build_all``) builds it.  The target is Hopper, ``sm_90a``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return str(path)


def source_digest() -> str:
    """Hash of every CUDA source and of the flags they are built with."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / source_digest() / f"lib{name}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen]:
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> dict[str, str]:
    """Build every ``csrc/*.cu`` not yet built, one nvcc each, in parallel.

    Returns the compiler's output (registers, shared memory, spills) by
    library name; a library already built returns an empty string.
    """
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        started = {n: _start(n) for n in names
                   if not library_path(n).exists()}
        return {n: _finish(n, *started[n]) if n in started else ""
                for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
        return lib


def bind(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """``load(name)`` with each C entry point's argument types declared;
    every entry point returns its ``cudaError_t`` as an int."""
    lib = load(name)
    for fn_name, args in argtypes.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def raise_on_error(err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def count_launch(launches: dict[str, int], name: str) -> None:
    """Add one launch of ``name`` to a wrapper's ``LAUNCHES``, under a
    lock: service workers launch from several threads, and a bare ``+=``
    on a dict entry is a read-modify-write that Python does not promise
    to keep whole."""
    with _COUNT_LOCK:
        launches[name] += 1


def reset_counts(launches: dict[str, int]) -> None:
    """Set every count of a wrapper's ``LAUNCHES`` to 0."""
    with _COUNT_LOCK:
        for name in launches:
            launches[name] = 0
