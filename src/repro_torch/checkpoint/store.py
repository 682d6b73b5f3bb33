"""Checkpoints with atomic commit and async writes: the reference's
``checkpoint/store.py`` for trees of tensors.

Layout, the reference's:  <dir>/step_<N>/
                              manifest.json   step, each leaf's shape and dtype
                              leaf_XXXXX.npy  one file per leaf (host values)
                           <dir>/LATEST       committed step (atomic rename)

Leaves are numbered in ``repro_torch.tree``'s order, the reference's, so
a tree of the same structure saved by either package restores in the
other.  numpy has no bfloat16: a bf16 leaf is stored as the 16-bit
unsigned view of its bits, as the reference stores it, and the manifest's
dtype turns it back.  ``restore`` puts each leaf on the device of the
matching leaf of ``like``, or with ``shardings`` (a tree of
``parallel.sharding.NamedSharding``) places it on its mesh.  A DTensor
leaf (a state on a mesh) is saved as its full tensor, gathered on every
rank and written by rank 0, so that a checkpoint knows no mesh and
restores onto any (the reference's elastic restore).  A background
thread writes off the training loop; the commit order (leaves ->
manifest -> rename -> LATEST) means a torn write is never visible.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``; a DTensor's full tensor (a collective: every
    rank of its mesh takes part)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().to("cpu", copy=True)


def _writer() -> bool:
    """Whether this process writes: rank 0, or a process with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_savable(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; bf16 as its 16-bit pattern."""
    t = _host(t)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _ids(n: int) -> list[str]:
    return [f"leaf_{i:05d}" for i in range(n)]


def save(directory: str, step: int, state: Any) -> str:
    """Synchronous checkpoint write with atomic commit of a tree of
    tensors (any device; DTensor leaves on every rank of their mesh,
    which returns once rank 0 has committed)."""
    flat = tree.leaves(state)
    final = os.path.join(directory, f"step_{step}")
    meshed = any(isinstance(leaf, DTensor) for leaf in flat)
    if not _writer():
        if meshed:
            for leaf in flat:
                _host(leaf)
            dist.barrier()
        return final
    tmp = os.path.join(directory, f".tmp_step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for lid, leaf in zip(_ids(len(flat)), flat):
        arr = _to_savable(leaf)
        np.save(os.path.join(tmp, lid + ".npy"), arr)
        manifest["leaves"].append(
            {"id": lid, "shape": list(arr.shape),
             "dtype": _dtype_name(leaf)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, ".LATEST_tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, ".LATEST_tmp"),
               os.path.join(directory, "LATEST"))
    if meshed:
        dist.barrier()
    return final


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore(directory: str, like: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, int]:
    """The checkpoint at ``step`` (default: the committed one) in the
    structure of ``like``, each leaf on the device of ``like``'s leaf, or
    with ``shardings`` (a matching tree of ``NamedSharding``) a DTensor
    placed on its mesh, whatever mesh it was saved from.  Returns (tree,
    step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = {m["id"]: m["dtype"] for m in manifest["leaves"]}
    flat = tree.leaves(like)
    if len(flat) != len(dtypes):
        raise ValueError(f"{directory} step {step} holds {len(dtypes)} "
                         f"leaves, the tree {len(flat)}")
    shards = (tree.leaves(shardings) if shardings is not None
              else [None] * len(flat))
    if len(shards) != len(flat):
        raise ValueError(f"{len(shards)} shardings for {len(flat)} leaves")
    out = []
    for lid, leaf, sh in zip(_ids(len(flat)), flat, shards):
        t = _from_saved(np.load(os.path.join(d, lid + ".npy")), dtypes[lid])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{lid}: saved {tuple(t.shape)}, the tree "
                             f"{tuple(leaf.shape)}")
        if sh is None:
            out.append(t.to(leaf.device))
        else:
            out.append(distribute_tensor(t.to(sh.mesh.device_type),
                                         sh.mesh, sh.placements))
    return tree.unflatten(like, out), step


def gc(directory: str, keep: int = 3) -> None:
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


class AsyncCheckpointer:
    """Background writer: ``submit`` copies the tree to the host and
    returns; the thread writes it and keeps the newest ``keep``; ``wait``
    joins the queue and raises the writer's error, if any."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree = item
            try:
                save(self.directory, step, host_tree)
                gc(self.directory, self.keep)
            except Exception as e:  # surfaced on the next submit or wait
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, state: Any) -> None:
        if self._err:
            raise self._err
        # host copies now: the caller may write the device tensors next
        host = tree.map(_host, state)
        self._q.put((int(step), host))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
