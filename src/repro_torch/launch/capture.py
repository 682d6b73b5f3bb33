"""Capture a step without running it: the port's counterpart of
``jax.jit(step).lower(...)``.

``capture(fn, *args)`` runs ``fn`` on meta tensors (shapes and dtypes, no
memory, no kernel) under a ``TorchDispatchMode`` that records every
operation that reaches the dispatcher: the forward, the backward of
``torch.autograd.grad`` (which runs through the same dispatcher), a
remat layer's recompute, the custom ops of K5, K7 and K8 as one node
each (``repro_torch::scatter_add``, ``::bincount``,
``::flash_attention``), and the collectives.  Under DTensor the mode
defers each DTensor operation to DTensor (it returns ``NotImplemented``,
as ``CommDebugMode`` does), so what it records is each rank's own
program: the local operations and the collectives DTensor issues for
them, the per-partition module of the reference.

The result, a ``Capture``, is a graph: each ``Node`` names its operation
(``aten.index_put_.default``), its arguments with each tensor as a
``TensorRef`` (a value number, its shape and dtype and the storage it
lives in), its outputs, the loops around it (``models/loops.py``: the
reference's scans — the layer groups, the encoder and decoder blocks, the
microbatches), its FLOPs by ``FlopCounterMode``'s formulas and the bytes
it reads and writes.  ``Capture.text`` prints it, one node a line, the
counterpart of the pre-optimization HLO text.  A backward operation runs
after the loop that made its forward has closed; it is placed in the
loops of the autograd node that runs it, as the reference's
backward scan sits at the depth of its forward scan: a
``TorchFunctionMode`` tags each autograd node with the loops it was made
in, and the recorder reads the tag of the node that runs
(``torch._C._current_autograd_node``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import loops

# torch dtypes by the HLO names the audit's rules and reports use
DTYPE_NAMES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64",
}
# the key of an autograd node's metadata that holds its loops
_LOOPS = "repro_torch.loops"

# collective operations by the HLO opcode they stand for
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-broadcast",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.broadcast_": "collective-broadcast",
}


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """A tensor value of the graph: ``%id``, on storage ``storage``."""
    id: int
    shape: tuple
    dtype: str
    storage: int
    itemsize: int

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.itemsize

    def __str__(self) -> str:
        return f"%{self.id}"

    def type_str(self) -> str:
        return f"{self.dtype}[{','.join(map(str, self.shape))}]"


@dataclasses.dataclass(frozen=True)
class Node:
    """One recorded operation."""
    index: int
    target: str                  # e.g. "aten.index_put_.default"
    args: tuple                  # TensorRef, lists of them, or Python values
    kwargs: dict
    outputs: tuple               # TensorRef
    loops: tuple                 # ((name, trips), ...), outermost first
    flops: float = 0.0           # one execution, one rank
    bytes: float = 0.0           # inputs read + outputs written, one rank
    line: int = 0                # 1-based line in Capture.text
    collective: Optional[tuple] = None   # (opcode, operand bytes, group)
    backward: bool = False

    @property
    def depth(self) -> int:
        return len(self.loops)

    @property
    def trips(self) -> int:
        n = 1
        for _, t in self.loops:
            n *= t
        return n

    @property
    def op(self) -> str:
        """The target without its overload: ``aten.index_put_``."""
        return self.target.rsplit(".", 1)[0]

    def tensor_args(self) -> list:
        out = []
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, TensorRef):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out.extend(x for x in a if isinstance(x, TensorRef))
        return out

    def render(self) -> str:
        def fmt(a):
            if isinstance(a, (list, tuple)):
                return "[" + ", ".join(fmt(x) for x in a) + "]"
            return str(a)
        args = ", ".join([fmt(a) for a in self.args]
                         + [f"{k}={fmt(v)}" for k, v in self.kwargs.items()])
        outs = ", ".join(str(o) for o in self.outputs) or "_"
        types = ", ".join(o.type_str() for o in self.outputs)
        where = " ".join(f"{n}:{t}" for n, t in self.loops)
        tag = " backward" if self.backward else ""
        return (f"{outs} = {self.target}({args})  # {types}"
                f"{'  loops=' + where if where else ''}{tag}")


@dataclasses.dataclass
class Capture:
    """A captured step: its nodes, its inputs and outputs, and its text."""
    label: str
    nodes: list
    inputs: list                 # (path, TensorRef) of the step's tensors
    outputs: list                # TensorRef of the step's result
    chips: int = 1
    text: str = ""
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def input_storages(self) -> dict:
        """Storage number -> the step input that owns it."""
        return {ref.storage: ref for _, ref in self.inputs}

    @property
    def num_instructions(self) -> int:
        return len(self.nodes)


def _dtype_name(dt: torch.dtype) -> str:
    return DTYPE_NAMES.get(dt, str(dt).replace("torch.", ""))


class _Recorder(TorchDispatchMode):
    """Records every operation below DTensor as a ``Node``."""

    def __init__(self, trips: dict):
        super().__init__()
        self.trips = trips            # loop name -> trips (overrides)
        self.nodes: list[Node] = []
        self._refs: dict[int, TensorRef] = {}
        self._keep: list = []         # holds every tensor seen: ids stay
        self._storages: dict[int, int] = {}
        self._next = 0
        self._task_base: dict[int, int] = {}

    # -- values -----------------------------------------------------------

    def _storage(self, t: torch.Tensor) -> int:
        try:
            key = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            key = id(t)
        if key not in self._storages:
            self._storages[key] = len(self._storages)
        return self._storages[key]

    def ref(self, t: torch.Tensor, new: bool = False) -> TensorRef:
        """The value ``t`` holds: a new number where ``new`` (an output)
        or where ``t`` was not seen before."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        r = self._refs.get(id(t))
        if r is None or new:
            r = TensorRef(id=self._next, shape=tuple(t.shape),
                          dtype=_dtype_name(t.dtype), storage=self._storage(t),
                          itemsize=t.element_size())
            self._next += 1
            self._refs[id(t)] = r
            self._keep.append(t)
        return r

    def _convert(self, a):
        if isinstance(a, torch.Tensor):
            return self.ref(a)
        if isinstance(a, (list, tuple)):
            return type(a)(self._convert(x) for x in a)
        if isinstance(a, (int, float, bool, str)) or a is None:
            return a
        if isinstance(a, (torch.dtype, torch.device, torch.layout,
                          torch.memory_format)):
            return str(a)
        return type(a).__name__

    # -- loops ------------------------------------------------------------

    def frames(self) -> tuple:
        return tuple((name, self.trips.get(name, trips))
                     for name, _, trips in loops.current())

    def _loops(self) -> tuple[tuple, bool]:
        """(the node's loops, whether it runs in a backward pass)."""
        frames = self.frames()
        task = torch._C._current_graph_task_id()
        if task == -1:
            return frames, False
        base = self._task_base.setdefault(task, len(frames))
        if len(frames) > base:        # a remat layer's recompute
            return frames, False
        node = torch._C._current_autograd_node()
        made = node.metadata.get(_LOOPS) if node is not None else None
        if made is not None and len(made) > len(frames):
            return made, True
        return frames, True

    # -- the mode ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor runs it; we see its parts
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in pytree.tree_leaves(args)):
            return func(*args, **kwargs)
        in_args = self._convert(args)
        in_kwargs = {k: self._convert(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in pytree.tree_leaves(out)):
            return out                # DTensor's own shape inference
        self._record(func, args, kwargs, in_args, in_kwargs, out)
        return out

    def _record(self, func, args, kwargs, in_args, in_kwargs, out):
        flat_out = [o for o in pytree.tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
        outputs = tuple(self.ref(o, new=True) for o in flat_out)
        target = str(func)
        node = Node(index=len(self.nodes), target=target, args=in_args,
                    kwargs=in_kwargs, outputs=outputs, loops=())
        ins = node.tensor_args()
        node_loops, backward = self._loops()
        packet = getattr(func, "_overloadpacket", None)
        flops = 0.0
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        nbytes = 0.0
        if not getattr(func, "is_view", False) and not target.startswith(
                ("aten.empty", "aten.detach", "aten.lift_fresh",
                 "_c10d_functional.wait_tensor")):
            nbytes = float(sum(r.nbytes for r in ins)
                           + sum(r.nbytes for r in outputs))
        coll = None
        base = target.rsplit(".", 1)[0]
        if base in _COLLECTIVES:
            coll = (_COLLECTIVES[base], sum(r.nbytes for r in ins[:1]),
                    _group_size(args, kwargs))
            # a group's name differs between captures: print its size
            in_args = tuple(f"group({coll[2]})" if isinstance(x, str) else x
                            for x in in_args)
            node = dataclasses.replace(node, args=in_args)
        node = dataclasses.replace(node, loops=node_loops, flops=flops,
                                   bytes=nbytes, collective=coll,
                                   backward=backward)
        self.nodes.append(node)


class _Tagger(TorchFunctionMode):
    """Tags each autograd node a torch call makes with the loops it was
    made in, for the backward operations that node will run."""

    def __init__(self, recorder: _Recorder):
        super().__init__()
        self.recorder = recorder

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        frames = None
        for t in pytree.tree_leaves(out):
            node = getattr(t, "grad_fn", None) \
                if isinstance(t, torch.Tensor) else None
            stack = [node]
            while stack:
                n = stack.pop()
                if n is None or _LOOPS in n.metadata:
                    continue
                if frames is None:
                    frames = self.recorder.frames()
                n.metadata[_LOOPS] = frames
                stack.extend(f for f, _ in n.next_functions)
        return out


def _group_size(args, kwargs) -> int:
    """The group size of a collective's arguments: a functional
    collective names its group, a c10d one holds it."""
    import torch.distributed as dist
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                return _resolve_process_group(a).size()
            except Exception:
                continue
        if hasattr(a, "size") and not isinstance(a, torch.Tensor) \
                and callable(a.size):
            try:
                return int(a.size())
            except Exception:
                continue
    return dist.get_world_size() if dist.is_initialized() else 1


def _input_paths(args) -> list:
    """(path, tensor) of every tensor leaf of ``args``, DTensors as their
    local shards."""
    out = []

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out.append((path, x._local_tensor if isinstance(x, DTensor)
                        else x))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}" if path else str(k))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}.{i}" if path else str(i))
    walk(args, "")
    return out


def capture(fn, *args, label: str = "step", trips: Optional[dict] = None,
            chips: int = 1, grad: bool = True, **kwargs) -> Capture:
    """Run ``fn(*args, **kwargs)`` on its meta (or DTensor-of-meta)
    arguments under the recorder; loops of ``models.loops.repeat`` run
    their first iteration (one microbatch).  ``trips`` overrides a loop's
    trip count by name (a depth-cut model stands for the whole one).
    ``grad=False`` runs it under ``torch.no_grad()`` (serving)."""
    rec = _Recorder(dict(trips or {}))
    inputs = [(p, rec.ref(t)) for p, t in _input_paths((args, kwargs))]
    ctx = torch.enable_grad() if grad else torch.no_grad()
    with ctx, loops.first_only(), rec, _Tagger(rec):
        out = fn(*args, **kwargs)
    outputs = [rec.ref(t) for _, t in _input_paths(out)]
    lines = [f"// capture {label}: {len(rec.nodes)} nodes, {chips} rank(s)"]
    lines += [f"{ref} = input {path}  # {ref.type_str()}"
              for path, ref in inputs]
    nodes = []
    for node in rec.nodes:
        lines.append(node.render())
        nodes.append(dataclasses.replace(node, line=len(lines)))
    lines.append("return " + ", ".join(str(r) for r in outputs))
    return Capture(label=label, nodes=nodes, inputs=inputs, outputs=outputs,
                   chips=chips, text="\n".join(lines) + "\n")
