"""Symbolic per-element index expressions over grid/wave/lane variables.

The lint's middle layer: a tiny expression language describing, for every
array a kernel's index stream is computed through, the value of each
element as a function of the array's own coordinates (``Iota``), the grid
position (``ProgramId``), and the operand blocks (``Data``).  The tracer
in :mod:`repro_torch.lint.tracing` builds these expressions from the aten
operations of a torch function; this module owns the node types, the
dependency analysis (is an index stream affine in grid/lane variables, or
does it read runtime data?), and an exact numpy evaluator.

Integer division has two spellings, kept apart by name because they
differ on negative values: ``div`` and ``rem`` truncate toward zero (C's
``/`` and ``%``, and XLA's ``div``/``rem``), ``floor_divide`` and
``remainder`` round toward minus infinity, the remainder taking the
divisor's sign (Python's ``//`` and ``%``, ``torch.floor_divide`` and
``torch.remainder``).  ``Gather`` is ``torch.gather``: a read along one
axis at a computed index.  Anything the tracer cannot model becomes
:class:`Opaque`, which poisons dependency analysis instead of crashing
it — an opaque stream is simply reported as "needs dynamic audit"
(KERN005) rather than proved.

No torch imports here: the expression algebra and evaluator are pure
numpy, so the audit/SARIF layer can import the lint rule catalog without
pulling in the tracer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class Expr:
    """Base node: every expression knows its array shape and dtype."""

    shape: tuple
    dtype: Any


@dataclasses.dataclass(frozen=True, eq=False)
class Const(Expr):
    value: Any = 0          # python scalar or ndarray


@dataclasses.dataclass(frozen=True, eq=False)
class Iota(Expr):
    """Value = the element's own coordinate along ``dim`` (lane/step id)."""

    dim: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class ProgramId(Expr):
    """The grid index along ``axis`` (scalar, per kernel instance)."""

    axis: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Data(Expr):
    """Contents of an operand ref's block (a runtime-data leaf)."""

    ref: int = 0
    name: str = ""


@dataclasses.dataclass(frozen=True, eq=False)
class Elem(Expr):
    """Elementwise op over broadcast-compatible args (incl. select_n)."""

    op: str = ""
    args: tuple = ()


@dataclasses.dataclass(frozen=True, eq=False)
class Reindex(Expr):
    """Pure coordinate remap: reshape/transpose/broadcast/slice."""

    kind: str = ""
    src: Optional[Expr] = None
    info: tuple = ()


@dataclasses.dataclass(frozen=True, eq=False)
class Gather(Expr):
    """``torch.gather(src, dim, index)``: ``src`` read along ``dim`` at
    ``index``, every other coordinate the element's own."""

    src: Optional[Expr] = None
    index: Optional[Expr] = None
    dim: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Opaque(Expr):
    """An unmodeled computation; poisons static analysis, never crashes."""

    reason: str = ""
    args: tuple = ()        # kept so tags/deps can flow through


# -- dependency analysis -----------------------------------------------------


def _walk(expr: Expr, seen: set) -> list[Expr]:
    if id(expr) in seen:
        return []
    seen.add(id(expr))
    out = [expr]
    children: tuple = ()
    if isinstance(expr, Elem):
        children = expr.args
    elif isinstance(expr, Reindex):
        children = (expr.src,)
    elif isinstance(expr, Gather):
        children = (expr.src, expr.index)
    elif isinstance(expr, Opaque):
        children = expr.args
    for c in children:
        if isinstance(c, Expr):
            out.extend(_walk(c, seen))
    return out


def walk(expr: Expr) -> list[Expr]:
    """Every distinct node in the expression DAG (shared nodes once)."""
    return _walk(expr, set())


def data_refs(expr: Expr) -> set[int]:
    """Operand refs the expression reads — empty means data-independent."""
    return {n.ref for n in walk(expr) if isinstance(n, Data)}


def program_axes(expr: Expr) -> set[int]:
    """Grid axes the expression depends on (affine-over-grid variables)."""
    return {n.axis for n in walk(expr) if isinstance(n, ProgramId)}


def opaque_reasons(expr: Expr) -> list[str]:
    return [n.reason for n in walk(expr) if isinstance(n, Opaque)]


def is_zero(expr: Expr) -> bool:
    """Structurally provably all-zero (init-store detection)."""
    if isinstance(expr, Const):
        return bool(np.all(np.asarray(expr.value) == 0))
    if isinstance(expr, Reindex):
        return is_zero(expr.src)
    if isinstance(expr, Elem) and expr.op == "convert":
        return is_zero(expr.args[0])
    return False


# -- evaluation --------------------------------------------------------------


class EvalError(Exception):
    """Raised when an expression cannot be evaluated (opaque/mismatch)."""


def _trunc_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        q = np.floor_divide(a, b)
        r = a - q * b
        # floor -> trunc correction for mixed signs
        return q + ((r != 0) & ((a < 0) != (b < 0)))
    return a / b


def _apply_elem(op: str, args: list[np.ndarray], dtype) -> np.ndarray:
    if op == "convert":
        return args[0].astype(dtype)
    if op == "select_n":
        pred, cases = args[0], args[1:]
        if len(cases) == 2:
            return np.where(pred.astype(bool), cases[1], cases[0])
        idx = pred.astype(np.int64)
        stacked = np.stack(np.broadcast_arrays(*cases))
        return np.take_along_axis(
            stacked, idx[None].astype(np.int64), axis=0)[0]
    a = args[0]
    b = args[1] if len(args) > 1 else None
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return _trunc_div(a, b)
    if op == "rem":
        return np.fmod(a, b)        # truncated remainder (C's %)
    if op == "floor_divide":
        return np.floor_divide(a, b)
    if op == "remainder":
        return np.remainder(a, b)   # the divisor's sign (Python's %)
    if op == "max":
        return np.maximum(a, b)
    if op == "min":
        return np.minimum(a, b)
    if op == "eq":
        return a == b
    if op == "ne":
        return a != b
    if op == "lt":
        return a < b
    if op == "le":
        return a <= b
    if op == "gt":
        return a > b
    if op == "ge":
        return a >= b
    if op == "and":
        return np.bitwise_and(a, b)
    if op == "or":
        return np.bitwise_or(a, b)
    if op == "xor":
        return np.bitwise_xor(a, b)
    if op == "not":
        return np.bitwise_not(a)
    if op == "neg":
        return -a
    raise EvalError(f"unknown elementwise op {op!r}")


def evaluate(expr: Expr, env: dict) -> np.ndarray:
    """Exact numpy evaluation of ``expr`` at one grid step.

    ``env`` maps ``("ref", i)`` to that operand's block contents and
    ``("pid", axis)`` to the grid index.  Results are memoized per DAG
    node, so shared subexpressions evaluate once.
    """
    memo: dict[int, np.ndarray] = {}

    def ev(e: Expr) -> np.ndarray:
        got = memo.get(id(e))
        if got is not None:
            return got
        if isinstance(e, Const):
            out = np.broadcast_to(np.asarray(e.value, dtype=e.dtype), e.shape)
        elif isinstance(e, Iota):
            n = e.shape[e.dim]
            view = [1] * len(e.shape)
            view[e.dim] = n
            out = np.broadcast_to(
                np.arange(n, dtype=e.dtype).reshape(view), e.shape)
        elif isinstance(e, ProgramId):
            try:
                out = np.asarray(env[("pid", e.axis)], dtype=e.dtype)
            except KeyError:
                raise EvalError(f"program_id({e.axis}) unbound")
        elif isinstance(e, Data):
            try:
                block = np.asarray(env[("ref", e.ref)])
            except KeyError:
                raise EvalError(f"ref {e.ref} ({e.name}) has no block bound")
            if tuple(block.shape) != tuple(e.shape):
                raise EvalError(
                    f"ref {e.ref} block shape {block.shape} != expression "
                    f"shape {e.shape} (indexed access)")
            out = block
        elif isinstance(e, Elem):
            args = [ev(a) for a in e.args]
            out = np.broadcast_to(
                np.asarray(_apply_elem(e.op, args, e.dtype)), e.shape)
            if out.dtype != np.dtype(e.dtype):
                out = out.astype(e.dtype)
        elif isinstance(e, Reindex):
            src = ev(e.src)
            if e.kind == "reshape":
                out = np.ascontiguousarray(src).reshape(e.shape)
            elif e.kind == "transpose":
                out = src.transpose(e.info)
            elif e.kind == "broadcast":
                view = [1] * len(e.shape)
                for i, d in enumerate(e.info):
                    view[d] = src.shape[i]
                out = np.broadcast_to(src.reshape(view), e.shape)
            elif e.kind == "slice":
                starts, limits, strides = e.info
                out = src[tuple(slice(s, li, st)
                                for s, li, st in zip(starts, limits, strides))]
            else:
                raise EvalError(f"unknown reindex kind {e.kind!r}")
        elif isinstance(e, Gather):
            src, index = ev(e.src), ev(e.index)
            if np.any((index < 0) | (index >= src.shape[e.dim])):
                raise EvalError(f"gather index outside [0, "
                                f"{src.shape[e.dim]}) along dim {e.dim}")
            out = np.take_along_axis(src, index.astype(np.int64),
                                     axis=e.dim)
        elif isinstance(e, Opaque):
            raise EvalError(f"opaque computation: {e.reason}")
        else:
            raise EvalError(f"unknown node {type(e).__name__}")
        memo[id(e)] = out
        return out

    return ev(expr)


def squeeze_axis(expr: Expr, axis: int) -> Expr:
    """Drop a size-1 axis (the one-hot comparison's bin axis)."""
    if expr.shape[axis] != 1:
        raise ValueError(f"axis {axis} of {expr.shape} is not size 1")
    new_shape = tuple(s for i, s in enumerate(expr.shape) if i != axis)
    return Reindex(shape=new_shape, dtype=expr.dtype, kind="reshape",
                   src=expr)
