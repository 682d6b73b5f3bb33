"""Kernel models for the lint: a CUDA kernel's launch as declared beside
its launcher, and its committed index stream traced from torch.

The reference's lint reads each Pallas kernel's body as a jaxpr.  The
port's kernels are CUDA C++ (``kernels/csrc``), which nothing on the host
compiles or traces, so a :class:`KernelModel` here has two sources:

* the **index stream** is traced, not written by hand: ``trace_stream``
  runs the torch function that the instrumented kernels' degrees are held
  to on the card (``kernels/histogram/kernel.py:issue_ordered_bins_plain``
  for K2-K4, the ids as they come for K5-K7) on meta tensors under a
  ``TorchDispatchMode``.  Each aten operation becomes a node of
  :mod:`repro_torch.lint.symbolic`: ``arange`` an ``Iota``, arithmetic and
  comparisons an ``Elem``, ``view``/``transpose``/``expand``/``slice`` a
  ``Reindex``, ``gather`` a ``Gather``, an operand's block a ``Data``, and
  any other operation an ``Opaque`` named after it;
* the **launch structure** exists only in the ``.cu`` source, so it is
  declared beside each launcher (``lint_declaration`` and its kin in
  ``kernels/{histogram,scatter_add,flash_attention}/kernel.py``) as a
  :class:`LaunchDecl`: the grid (the tiles the kernel's stream is cut
  into, which its blocks stride over), each input's block, and each
  accumulator — which output it is, its bins and row width, shared memory
  or L2, padded or not, how it is zeroed, the atomic that combines into
  it, and how a block's copy reaches the result.  A declaration follows
  the route its launcher takes at the launch's shape.

``build_model`` joins the two into the reference's dataclasses, with the
same field names (``ScatterSite``, ``WriteRecord``, ``KernelModel`` and a
``LaunchRecord`` with ``block_shape``/``block_for``), so that
:mod:`repro_torch.lint.analysis` and :mod:`repro_torch.lint.rules` follow
the reference's almost line for line.  Nothing is launched.

``combine_classes`` reads a kernel's atomic opcodes (``cuobjdump -sass``)
into the classes a declaration states, so that the card can hold each
declaration to the code its kernel compiled to.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.lint import symbolic as sym

_KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"

MEMORIES = ("shared", "global")
COMBINES = ("popc", "fao", "cas")
INITS = ("block", "caller", "none")
FLUSHES = ("add", "store", "")


# -- the declaration ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Operand:
    """An input of the launch and the block of it one grid step reads."""

    name: str
    block: tuple                # the block's shape
    index_axes: tuple           # per block dim: the grid axis its block
    #                             index follows, or None (always block 0)

    def dep_axes(self) -> frozenset:
        return frozenset(a for a in self.index_axes if a is not None)


@dataclasses.dataclass(frozen=True)
class Accumulator:
    """An output the kernel adds into with atomics, one update an id.

    ``kind`` keeps the reference's site kinds, so that the two lints'
    reports compare: ``one_hot_popcount`` adds one value to a bin an
    update, ``one_hot_matmul`` a row of ``row_elems`` values.
    """

    name: str
    shape: tuple                # the output's shape
    bins: int                   # destinations the stream indexes
    row_elems: int = 1
    kind: str = "one_hot_popcount"
    memory: str = "shared"      # a block's copy in shared memory, or the
    #                             result itself, added at L2 ("global")
    padded: bool = False        # a word of padding after each 32 of the
    #                             copy (csrc/warp_aggregate.cuh: padded_slot)
    init: str = "block"         # "block": each block zeroes its copy before
    #                             __syncthreads; "caller": the launcher
    #                             zeroes the result first; "none"
    combine: str = "popc"       # "popc": atomicAdd(int) of 1, its result
    #                             unused (ATOMS.POPC.INC); "fao": an integer
    #                             add, or a native f32 add at L2 (RED);
    #                             "cas": a shared atomicAdd(float), a CAS
    #                             loop on Hopper (ATOMS.CAST.SPIN)
    vector: int = 1             # values one atomic adds (f32x4: 4)
    retry_loop: bool = False    # an atomicCAS retry loop in the source
    flush: str = "add"          # how a block's copy reaches the result:
    #                             "add" (atomicAdd of each non-zero entry,
    #                             at L2), "store", or "" (none: the result
    #                             itself, or scratch the block keeps)

    def __post_init__(self) -> None:
        for field, allowed in (("memory", MEMORIES), ("combine", COMBINES),
                               ("init", INITS), ("flush", FLUSHES)):
            if getattr(self, field) not in allowed:
                raise ValueError(f"accumulator {self.name}: {field} "
                                 f"{getattr(self, field)!r} not in {allowed}")
        if self.memory == "global" and self.flush:
            raise ValueError(f"accumulator {self.name}: the global result "
                             f"has no copy to flush")


@dataclasses.dataclass(frozen=True)
class Store:
    """An output whose every block one grid step stores, no atomics."""

    name: str
    block: tuple
    index_axes: tuple


@dataclasses.dataclass(frozen=True)
class LaunchDecl:
    """One CUDA launch, as the lint models it.

    Refs are numbered as the reference numbers a Pallas kernel's: the
    inputs first, then the accumulators, then the stores.  ``stream``
    takes the blocks of the inputs ``stream_refs`` names (torch tensors)
    and returns one grid step's committed index stream, flat.
    """

    kernel: str                 # the instantiation, as the SASS names it
    source: str                 # its .cu file, under kernels/
    grid: tuple
    inputs: tuple
    accumulators: tuple = ()
    stores: tuple = ()
    stream: Optional[Callable] = None
    stream_refs: tuple = ()

    @property
    def num_inputs(self) -> int:
        return len(self.inputs)

    @property
    def num_outputs(self) -> int:
        return len(self.accumulators) + len(self.stores)

    def expected_combines(self) -> set:
        """The (memory, class, values per atomic) of every atomic the
        kernel should compile to: each accumulator's combine, and a
        flush's add at L2."""
        out = set()
        for acc in self.accumulators:
            out.add((acc.memory, acc.combine, acc.vector))
            if acc.flush == "add":
                out.add(("global", "fao", 1))
        return out


def combine_classes(opcodes) -> set:
    """(memory, class, values per atomic) of each atomic or reduction
    opcode of a kernel's SASS (``ATOMS``/``ATOMG``/``RED``), in
    ``LaunchDecl.expected_combines``' terms; other opcodes are skipped,
    and an atomic of no known class keeps its opcode as its class."""
    out = set()
    for op in opcodes:
        if not re.match(r"(ATOM|RED)[SG]?\.", op):   # not REDUX: a warp op
            continue
        memory = "shared" if op.startswith("ATOMS") else "global"
        if ".POPC.INC" in op:
            cls = "popc"
        elif ".CAS" in op:
            cls = "cas"
        elif ".ADD" in op:
            cls = "fao"
        else:
            cls = op
        width = re.search(r"x(\d+)\.", op + ".")
        out.add((memory, cls, int(width.group(1)) if width else 1))
    return out


# -- the model (the reference's dataclasses) ---------------------------------


@dataclasses.dataclass
class ScatterSite:
    """One accumulate-into-ref site of a kernel model.

    ``memory``, ``padded`` and ``combine`` are the declaration's: where
    the accumulator sits and which atomic adds into it.
    """

    ref: int
    ref_name: str
    stream: sym.Expr
    stream_len: int
    num_bins: int
    kind: str
    row_elems: int
    rmw: bool                   # value reads the ref's previous contents
    guard_axes: frozenset       # init-guard axes at this site
    memory: str = "shared"
    padded: bool = False
    combine: str = "fao"


@dataclasses.dataclass
class WriteRecord:
    ref: int
    rmw: bool
    is_zero_init: bool
    guard_axes: frozenset


@dataclasses.dataclass
class LaunchRecord:
    """The declaration's launch, as the analysis reads it: grid, refs,
    and the block an operand ref sees at one grid step."""

    decl: LaunchDecl

    @property
    def grid(self) -> tuple:
        return self.decl.grid

    @property
    def num_inputs(self) -> int:
        return self.decl.num_inputs

    @property
    def num_outputs(self) -> int:
        return self.decl.num_outputs

    def block_shape(self, ref: int) -> tuple:
        d = self.decl
        if ref < d.num_inputs:
            return tuple(d.inputs[ref].block)
        ref -= d.num_inputs
        if ref < len(d.accumulators):
            return tuple(d.accumulators[ref].shape)
        return tuple(d.stores[ref - len(d.accumulators)].block)

    def block_for(self, ref: int, operand, step: tuple) -> np.ndarray:
        """The block an operand ref sees at one grid step."""
        op = self.decl.inputs[ref]
        arr = np.asarray(operand)
        slices = tuple(
            slice(0, b) if a is None
            else slice(int(step[a]) * b, (int(step[a]) + 1) * b)
            for a, b in zip(op.index_axes, op.block))
        return arr[slices]


@dataclasses.dataclass
class KernelModel:
    name: str
    grid: tuple
    num_inputs: int
    num_outputs: int
    block_shapes: list
    block_dep_axes: list        # per ref: frozenset of grid axes, or None
    sites: list
    writes: list
    init_guards: dict           # ref -> set of guarded grid axes
    has_while: bool = False
    while_has_swap: bool = False
    num_eqns: int = 0
    source_file: str = ""
    source_line: int = 0
    record: Optional[LaunchRecord] = None

    def dep_axes(self, ref: int):
        if 0 <= ref < len(self.block_dep_axes):
            return self.block_dep_axes[ref]
        return None


# -- tracing the stream ------------------------------------------------------

_NP_DTYPES = {
    torch.bool: np.dtype(bool), torch.uint8: np.dtype(np.uint8),
    torch.int8: np.dtype(np.int8), torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64),
    torch.float16: np.dtype(np.float16), torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}

# aten operations that are one elementwise op of the evaluator
_ELEMENTWISE = {
    "add": "add", "sub": "sub", "mul": "mul", "remainder": "remainder",
    "floor_divide": "floor_divide", "fmod": "rem", "eq": "eq", "ne": "ne",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "maximum": "max",
    "minimum": "min", "bitwise_and": "and", "bitwise_or": "or",
    "bitwise_xor": "xor", "bitwise_not": "not", "neg": "neg",
}
_DIV_MODES = {"trunc": "div", "floor": "floor_divide"}
# operations whose result is their first argument's value
_IDENTITY = {"clone", "contiguous", "alias", "detach", "lift_fresh"}
_RESHAPES = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
             "flatten"}


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype the evaluator models."""
    try:
        return _NP_DTYPES[dtype]
    except KeyError:
        raise ValueError(f"the lint models no {dtype} values") from None


class _Tracer(TorchDispatchMode):
    """Records each aten operation's result as an expression."""

    def __init__(self):
        super().__init__()
        self.exprs: dict[int, sym.Expr] = {}
        self.keep: list = []        # every tensor seen: no id is reused
        self.ops = 0

    def bind(self, t: torch.Tensor, expr: sym.Expr) -> None:
        self.exprs[id(t)] = expr
        self.keep.append(t)

    def expr(self, a, like=None) -> sym.Expr:
        if isinstance(a, torch.Tensor):
            got = self.exprs.get(id(a))
            if got is not None:
                return got
            shape, dtype = tuple(a.shape), _NP_DTYPES.get(a.dtype)
            if a.device.type == "meta" or dtype is None:
                return sym.Opaque(shape=shape, dtype=dtype,
                                  reason="untraced tensor")
            val = a.detach().numpy()
            return sym.Const(shape=shape, dtype=dtype, value=val)
        dt = np_dtype(torch.result_type(like, a) if like is not None
                      else torch.tensor(a).dtype)
        return sym.Const(shape=(), dtype=dt, value=np.asarray(a, dt))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if isinstance(out, torch.Tensor):
            try:
                expr = self.model(func, args, kwargs, out)
            except ValueError:        # a dtype the evaluator has no word for
                expr = None
            if expr is None:
                expr = self.opaque(func, args, out)
            self.bind(out, expr)
        else:
            for t in (out if isinstance(out, (tuple, list)) else ()):
                if isinstance(t, torch.Tensor):
                    self.bind(t, self.opaque(func, args, t))
        return out

    def opaque(self, func, args, out) -> sym.Expr:
        kids = tuple(self.exprs[id(a)] for a in args
                     if isinstance(a, torch.Tensor) and id(a) in self.exprs)
        return sym.Opaque(shape=tuple(out.shape),
                          dtype=_NP_DTYPES.get(out.dtype), reason=str(func),
                          args=kids)

    def model(self, func, args, kwargs, out) -> Optional[sym.Expr]:
        """The expression of ``func``'s result, or None (opaque)."""
        name = func.overloadpacket.__name__
        shape, dtype = tuple(out.shape), np_dtype(out.dtype)
        if name.endswith("_") and not name.startswith("__"):
            return None               # in place: not modeled
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        like = tensors[0] if tensors else None
        if name == "arange":
            nums = [a for a in args if not isinstance(a, torch.Tensor)]
            start, step = (0, 1) if len(nums) < 2 else (
                nums[0], nums[2] if len(nums) > 2 else 1)
            expr = sym.Iota(shape=shape, dtype=dtype, dim=0)
            if step != 1:
                expr = sym.Elem(shape=shape, dtype=dtype, op="mul", args=(
                    expr, sym.Const(shape=(), dtype=dtype, value=step)))
            if start != 0:
                expr = sym.Elem(shape=shape, dtype=dtype, op="add", args=(
                    expr, sym.Const(shape=(), dtype=dtype, value=start)))
            return expr
        if name in _IDENTITY:
            return self.expr(args[0])
        if name == "_to_copy":
            src = self.expr(args[0])
            if src.dtype == dtype:
                return src
            return sym.Elem(shape=shape, dtype=dtype, op="convert",
                            args=(src,))
        if name in _ELEMENTWISE or name == "div":
            if kwargs.get("alpha", 1) != 1:
                return None
            ops = tuple(self.expr(a, like) for a in args)
            op = _ELEMENTWISE.get(name)
            if name == "div":
                op = _DIV_MODES.get(kwargs.get("rounding_mode"))
                if op is None:        # true division, in the result's dtype
                    op = "div"
                    ops = tuple(o if o.dtype == dtype else sym.Elem(
                        shape=o.shape, dtype=dtype, op="convert", args=(o,))
                        for o in ops)
            return sym.Elem(shape=shape, dtype=dtype, op=op, args=ops)
        if name == "where" and len(args) == 3:
            pred, x, y = (self.expr(a, like) for a in args)
            return sym.Elem(shape=shape, dtype=dtype, op="select_n",
                            args=(pred, y, x))
        src = self.expr(args[0]) if tensors else None
        if name in _RESHAPES:
            return sym.Reindex(shape=shape, dtype=dtype, kind="reshape",
                               src=src)
        if name == "transpose":
            perm = list(range(len(shape)))
            d0, d1 = args[1] % len(shape), args[2] % len(shape)
            perm[d0], perm[d1] = perm[d1], perm[d0]
            return sym.Reindex(shape=shape, dtype=dtype, kind="transpose",
                               src=src, info=tuple(perm))
        if name == "expand":
            lead = len(shape) - len(src.shape)
            return sym.Reindex(shape=shape, dtype=dtype, kind="broadcast",
                               src=src,
                               info=tuple(range(lead, len(shape))))
        if name == "slice":
            return self._slice(src, shape, dtype, *args[1:])
        if name == "gather":
            return sym.Gather(shape=shape, dtype=dtype, src=src,
                              index=self.expr(args[2]),
                              dim=args[1] % len(shape))
        return None

    @staticmethod
    def _slice(src, shape, dtype, dim=0, start=None, end=None, step=1):
        dim %= len(src.shape)
        size = src.shape[dim]
        start, end, _ = slice(start, end, step).indices(size)
        starts = [0] * len(src.shape)
        limits = list(src.shape)
        strides = [1] * len(src.shape)
        starts[dim], limits[dim], strides[dim] = start, max(start, end), step
        return sym.Reindex(shape=shape, dtype=dtype, kind="slice", src=src,
                           info=(tuple(starts), tuple(limits),
                                 tuple(strides)))


def trace_stream(fn: Callable, blocks: list) -> tuple[sym.Expr, int]:
    """(expression, aten operations) of ``fn``'s flat result.

    ``blocks`` is one ``(ref, name, shape, torch dtype)`` per argument:
    each is passed as a meta tensor whose value is ``Data(ref)``.  Only
    shapes and dtypes exist while it runs; nothing is computed.
    """
    tracer = _Tracer()
    inputs = []
    for ref, name, shape, dtype in blocks:
        t = torch.empty(tuple(shape), dtype=dtype, device="meta")
        tracer.bind(t, sym.Data(shape=tuple(shape), dtype=np_dtype(dtype),
                                ref=ref, name=name))
        inputs.append(t)
    with tracer:
        out = fn(*inputs)
    expr = tracer.expr(out)
    if len(expr.shape) != 1:
        expr = sym.Reindex(shape=(int(np.prod(expr.shape)),),
                           dtype=expr.dtype, kind="reshape", src=expr)
    return expr, tracer.ops


# -- the model ---------------------------------------------------------------


def _kernel_line(path: Path, kernel: str) -> int:
    """The line of the ``__global__`` function ``kernel`` (its name
    without template arguments) in ``path``, or 0."""
    base = kernel.split("<")[0]
    try:
        lines = path.read_text().splitlines()
    except OSError:
        return 0
    for i, line in enumerate(lines):
        if "__global__" in line:
            for j in (i, i + 1):
                if j < len(lines) and re.search(
                        rf"\b{re.escape(base)}\s*\(", lines[j]):
                    return j + 1
    return 0


def build_model(decl: LaunchDecl, name: str = "") -> KernelModel:
    """The kernel model of one declared launch, its stream traced."""
    record = LaunchRecord(decl)
    nin = decl.num_inputs
    refs = nin + decl.num_outputs
    path = _KERNELS_DIR / decl.source
    model = KernelModel(
        name=name or decl.kernel, grid=tuple(decl.grid), num_inputs=nin,
        num_outputs=decl.num_outputs,
        block_shapes=[record.block_shape(r) for r in range(refs)],
        block_dep_axes=([op.dep_axes() for op in decl.inputs]
                        + [frozenset()] * len(decl.accumulators)
                        + [frozenset(a for a in st.index_axes
                                     if a is not None)
                           for st in decl.stores]),
        sites=[], writes=[], init_guards={},
        has_while=any(a.retry_loop for a in decl.accumulators),
        while_has_swap=any(a.retry_loop for a in decl.accumulators),
        source_file=str(path), source_line=_kernel_line(path, decl.kernel),
        record=record)
    stream, ops = None, 0
    if decl.stream is not None and decl.accumulators:
        stream, ops = trace_stream(decl.stream, [
            (r, decl.inputs[r].name, decl.inputs[r].block, dtype)
            for r, dtype in decl.stream_refs])
    every = frozenset(range(len(decl.grid)))
    for k, acc in enumerate(decl.accumulators):
        ref = nin + k
        if acc.init != "none":
            model.writes.append(WriteRecord(
                ref=ref, rmw=False, is_zero_init=True, guard_axes=every))
            model.init_guards.setdefault(ref, set()).update(every)
        model.writes.append(WriteRecord(
            ref=ref, rmw=True, is_zero_init=False, guard_axes=frozenset()))
        if stream is not None:
            model.sites.append(ScatterSite(
                ref=ref, ref_name=acc.name, stream=stream,
                stream_len=int(stream.shape[0]), num_bins=acc.bins,
                kind=acc.kind, row_elems=acc.row_elems, rmw=True,
                guard_axes=frozenset(), memory=acc.memory,
                padded=acc.padded, combine=acc.combine))
    for k, _ in enumerate(decl.stores):
        model.writes.append(WriteRecord(
            ref=nin + len(decl.accumulators) + k, rmw=False,
            is_zero_init=False, guard_axes=frozenset()))
    model.num_eqns = ops + len(model.writes)
    return model
