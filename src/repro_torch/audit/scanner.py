"""Instruction-graph scan of (pre-optimization) HLO for atomic-shaped idioms.

Extends the ``_INSTR_RE`` line walk in ``repro_torch.core.hlo`` into a full
call-graph traversal: starting at the entry computation, descend through
``while`` bodies (multiplying resolved trip counts, flagging unresolved
ones), ``call`` / ``fusion`` / ``conditional`` regions, and record every
site whose lowering lands on the shared-memory atomic unit:

* ``scatter`` / ``select-and-scatter`` without ``unique_indices=true`` —
  classified by combiner region (add -> FAO, compare/select -> CAS
  retry) and update window (scalar updates -> histogram / expert-count,
  row updates -> MoE token dispatch),
* ``dynamic-update-slice`` inside a loop body (KV-cache decode write),
* one-hot lowerings (``convert(compare(..., iota chain))`` or calls into
  jax's ``_one_hot*`` computations) feeding a ``dot`` (one-hot matmul)
  or ``reduce`` (dense histogram),
* key/value ``sort`` with integer keys (sort-segment dispatch prologue).

The scan targets *pre-optimization* HLO (the reference lowers a step to
it with ``launch.lowering.pre_optimization_hlo``; the port reads the
text from a file) where these idioms are still explicit ops;
post-optimization CPU HLO rewrites scatters into ``while`` loops.  A
light fallback recognizes those rewritten loops by their surviving
``op_name`` metadata so a post-optimization text still reports them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from repro_torch.core import hlo

_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_REF_RE = re.compile(r"%?([\w.\-]+)")
_OPNAME_META_RE = re.compile(r'op_name="([^"]*)"')

# Producer hops the one-hot detector may cross inside one computation.
_CHAIN_OPS = ("broadcast", "reshape", "convert", "transpose", "copy")
_INT_DTYPES = ("s8", "u8", "s16", "u16", "s32", "u32", "s64", "u64")


@dataclasses.dataclass(frozen=True)
class AtomicSite:
    """One atomic-shaped instruction, with enough static context to rate it."""

    op_name: str                 # HLO instruction name (e.g. scatter.439)
    opcode: str
    kind: str                    # histogram_scatter | dispatch_scatter |
    #                              scatter | kv_cache_write | one_hot_matmul |
    #                              one_hot_histogram | sort_segment
    computation: str
    hlo_line: int                # 1-based line number in the scanned text
    operand_dtype: str = "f32"
    operand_shape: tuple = ()
    update_dtype: str = "f32"
    update_shape: tuple = ()
    index_dtype: str = "s32"
    num_bins: int = 1            # destination slots addressed by indices
    num_updates: int = 1         # independent indexed updates per execution
    row_elems: int = 1           # elements per update window
    combiner: str = "none"       # add | max | min | mul | overwrite | cas
    unique_indices: bool = False
    loop_depth: int = 0
    trip_count: int = 1          # product of resolved enclosing trip counts
    trip_unresolved: bool = False

    def describe(self) -> str:
        dest = f"{self.operand_dtype}{list(self.operand_shape)}"
        trips = f"{self.trip_count}{'?' if self.trip_unresolved else ''}"
        return (f"{self.opcode} {self.op_name} ({self.kind}) -> {dest}: "
                f"{self.num_updates} update(s) x {self.row_elems} elem(s) "
                f"into {self.num_bins} bin(s), combiner={self.combiner}, "
                f"loop_depth={self.loop_depth}, trips={trips}")


@dataclasses.dataclass
class ScanResult:
    sites: list[AtomicSite]
    num_instructions: int = 0
    num_computations: int = 0
    unresolved_loops: int = 0
    entry: Optional[str] = None

    def by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.sites:
            out[s.kind] = out.get(s.kind, 0) + 1
        return out


def _attr_dims(line: str, name: str) -> Optional[tuple]:
    m = re.search(re.escape(name) + r"=\{([0-9,]*)\}", line)
    if m is None:
        return None
    return tuple(int(d) for d in m.group(1).split(",") if d != "")


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _first_shape(shape_text: str) -> tuple[str, tuple]:
    dims = hlo.shape_dims(shape_text)
    if not dims:
        return "f32", ()
    dt, dd = dims[0]
    return dt, tuple(dd)


class _Scanner:
    def __init__(self, text: str):
        self.text = text
        self.comps = hlo.parse_computations(text)
        self.entry = hlo.find_entry(text)
        self.names = {c: {i.name: i for i in instrs}
                      for c, instrs in self.comps.items()}
        self.line_no: dict[str, int] = {}
        for n, line in enumerate(text.splitlines(), start=1):
            m = hlo._INSTR_RE.match(line)
            if m and m.group(1) not in self.line_no:
                self.line_no[m.group(1)] = n
        self.unresolved_loops = 0
        # op_name -> site (global instruction names dedup shared call paths;
        # keep the occurrence with the largest trip multiplier)
        self.sites: dict[str, AtomicSite] = {}

    # -- operand helpers --------------------------------------------------

    def _operand_refs(self, ins, comp: str) -> list[str]:
        sec = hlo.operand_section(ins.line, ins.opcode)
        local = self.names.get(comp, {})
        return [r for r in _REF_RE.findall(sec) if r in local]

    def _ref_shape(self, ref: str, comp: str) -> tuple[str, tuple]:
        ins = self.names.get(comp, {}).get(ref)
        if ins is None:
            return "f32", ()
        return _first_shape(ins.result)

    def _producer(self, ref: str, comp: str):
        return self.names.get(comp, {}).get(ref)

    def _chain_has_iota(self, ref: str, comp: str, depth: int = 5) -> bool:
        """Does ref's producer chain (elementwise-ish hops) reach an iota?"""
        seen = set()
        frontier = [(ref, 0)]
        while frontier:
            r, d = frontier.pop()
            if r in seen or d > depth:
                continue
            seen.add(r)
            ins = self._producer(r, comp)
            if ins is None:
                continue
            if ins.opcode == "iota":
                return True
            # follow through shape-preserving hops and tiny calls
            if ins.opcode in _CHAIN_OPS or ins.opcode == "compare":
                for rr in self._operand_refs(ins, comp):
                    frontier.append((rr, d + 1))
            elif ins.opcode == "call":
                for c in hlo.called_computations(ins.line):
                    if any(i.opcode == "iota"
                           for i in self.comps.get(c, [])):
                        return True
        return False

    def _combiner(self, line: str) -> str:
        for c in hlo.called_computations(line):
            ops = {i.opcode for i in self.comps.get(c, [])
                   if i.opcode != "parameter"}
            if not ops:
                return "overwrite"
            if ops <= {"add", "convert"}:
                return "add"
            if ops <= {"maximum", "convert"}:
                return "max"
            if ops <= {"minimum", "convert"}:
                return "min"
            if ops <= {"multiply", "convert"}:
                return "mul"
            if "compare" in ops or "select" in ops:
                return "cas"
            return "cas"
        return "none"

    # -- site constructors ------------------------------------------------

    def _add(self, site: AtomicSite) -> None:
        prev = self.sites.get(site.op_name)
        if prev is None or site.trip_count > prev.trip_count:
            self.sites[site.op_name] = site

    def _scatter_site(self, ins, comp, trip, depth, unres) -> None:
        refs = self._operand_refs(ins, comp)
        op_dt, op_shape = _first_shape(ins.result)
        idx_dt, upd_dt, upd_shape = "s32", op_dt, ()
        if len(refs) >= 3:
            # scatter(operand, indices, updates)
            op_dt, op_shape = self._ref_shape(refs[0], comp)
            idx_dt, _ = self._ref_shape(refs[1], comp)
            upd_dt, upd_shape = self._ref_shape(refs[2], comp)
        window = _attr_dims(ins.line, "update_window_dims") or ()
        sdims = _attr_dims(ins.line, "scatter_dims_to_operand_dims") or ()
        row = _prod(upd_shape[d] for d in window if d < len(upd_shape))
        n_upd = _prod(d for i, d in enumerate(upd_shape) if i not in window)
        bins = _prod(op_shape[d] for d in sdims if d < len(op_shape))
        combiner = self._combiner(ins.line)
        kind = "scatter"
        if row <= 1 and combiner in ("add", "max", "min", "mul"):
            kind = "histogram_scatter"
        elif row > 1 and combiner in ("overwrite", "add"):
            kind = "dispatch_scatter"
        self._add(AtomicSite(
            op_name=ins.name, opcode=ins.opcode, kind=kind, computation=comp,
            hlo_line=self.line_no.get(ins.name, 0),
            operand_dtype=op_dt, operand_shape=op_shape,
            update_dtype=upd_dt, update_shape=upd_shape, index_dtype=idx_dt,
            num_bins=max(1, bins), num_updates=max(1, n_upd),
            row_elems=max(1, row), combiner=combiner,
            unique_indices="unique_indices=true" in ins.line,
            loop_depth=depth, trip_count=trip, trip_unresolved=unres))

    def _dus_site(self, ins, comp, trip, depth, unres) -> None:
        if depth < 1:
            return  # only loop-carried updates (KV-cache decode writes)
        refs = self._operand_refs(ins, comp)
        buf_dt, buf_shape = _first_shape(ins.result)
        upd_dt, upd_shape, idx_dt = buf_dt, (), "s32"
        if len(refs) >= 2:
            buf_dt, buf_shape = self._ref_shape(refs[0], comp)
            upd_dt, upd_shape = self._ref_shape(refs[1], comp)
        if len(refs) >= 3:
            idx_dt, _ = self._ref_shape(refs[2], comp)
        buf_elems = _prod(buf_shape)
        upd_elems = max(1, _prod(upd_shape))
        if buf_elems <= upd_elems:
            return  # full overwrite, not an indexed update
        self._add(AtomicSite(
            op_name=ins.name, opcode=ins.opcode, kind="kv_cache_write",
            computation=comp, hlo_line=self.line_no.get(ins.name, 0),
            operand_dtype=buf_dt, operand_shape=buf_shape,
            update_dtype=upd_dt, update_shape=upd_shape, index_dtype=idx_dt,
            num_bins=max(1, buf_elems // upd_elems), num_updates=1,
            row_elems=upd_elems, combiner="overwrite",
            loop_depth=depth, trip_count=trip, trip_unresolved=unres))

    def _one_hot_site(self, ins, comp, trip, depth, unres,
                      oh_dt, oh_shape) -> None:
        bins = oh_shape[-1] if oh_shape else 1
        n_upd = _prod(oh_shape[:-1]) if len(oh_shape) > 1 else 1
        # consumer decides matmul vs dense histogram
        kind = "one_hot_histogram"
        for other in self.comps.get(comp, []):
            if ins.name in self._operand_refs(other, comp):
                if other.opcode == "dot":
                    kind = "one_hot_matmul"
                    break
                if other.opcode == "reduce":
                    kind = "one_hot_histogram"
                    break
        self._add(AtomicSite(
            op_name=ins.name, opcode=ins.opcode, kind=kind, computation=comp,
            hlo_line=self.line_no.get(ins.name, 0),
            operand_dtype=oh_dt, operand_shape=oh_shape,
            update_dtype=oh_dt, update_shape=oh_shape, index_dtype="s32",
            num_bins=max(1, bins), num_updates=max(1, n_upd),
            row_elems=1, combiner="add",
            loop_depth=depth, trip_count=trip, trip_unresolved=unres))

    def _sort_site(self, ins, comp, trip, depth, unres) -> None:
        refs = self._operand_refs(ins, comp)
        if len(refs) < 2:
            return  # plain value sort, not a key/value dispatch prologue
        key_dt, key_shape = self._ref_shape(refs[0], comp)
        if key_dt not in _INT_DTYPES:
            return
        self._add(AtomicSite(
            op_name=ins.name, opcode=ins.opcode, kind="sort_segment",
            computation=comp, hlo_line=self.line_no.get(ins.name, 0),
            operand_dtype=key_dt, operand_shape=key_shape,
            update_dtype=key_dt, update_shape=key_shape, index_dtype=key_dt,
            num_bins=max(1, _prod(key_shape)),
            num_updates=max(1, _prod(key_shape)), row_elems=1,
            combiner="none", loop_depth=depth, trip_count=trip,
            trip_unresolved=unres))

    def _rewritten_scatter_site(self, ins, comp, trip, depth, unres) -> None:
        """Post-optimization fallback: XLA:CPU rewrites scatters into while
        loops whose metadata op_name still says `.../scatter...`."""
        m = _OPNAME_META_RE.search(ins.line)
        opname = m.group(1) if m else ""
        dt, shape = _first_shape(ins.result)
        self._add(AtomicSite(
            op_name=ins.name, opcode="scatter", kind="scatter",
            computation=comp, hlo_line=self.line_no.get(ins.name, 0),
            operand_dtype=dt, operand_shape=shape,
            combiner="add" if "add" in opname else "overwrite",
            num_bins=max(1, _prod(shape)), loop_depth=depth,
            trip_count=trip, trip_unresolved=unres))

    # -- the walk ---------------------------------------------------------

    def scan(self) -> ScanResult:
        if self.entry is not None:
            self._walk(self.entry, trip=1, depth=0, unres=False, path=())
        else:
            # no ENTRY marker (fragment): scan every computation flat
            for comp in self.comps:
                self._walk(comp, trip=1, depth=0, unres=False, path=())
        sites = sorted(self.sites.values(),
                       key=lambda s: (s.hlo_line, s.op_name))
        return ScanResult(
            sites=sites,
            num_instructions=sum(len(v) for v in self.comps.values()),
            num_computations=len(self.comps),
            unresolved_loops=self.unresolved_loops,
            entry=self.entry)

    def _walk(self, comp: str, *, trip: int, depth: int, unres: bool,
              path: tuple) -> None:
        if comp in path:   # defensive: HLO call graphs are acyclic
            return
        path = path + (comp,)
        for ins in self.comps.get(comp, []):
            op = ins.opcode
            if op == "while":
                mb = _BODY_RE.search(ins.line)
                mc = _COND_RE.search(ins.line)
                t = hlo.resolve_trip_count(self.comps, ins.line,
                                           mc.group(1) if mc else None)
                if t is None:
                    self.unresolved_loops += 1
                if self._looks_like_rewritten_scatter(ins):
                    self._rewritten_scatter_site(ins, comp, trip, depth,
                                                 unres or t is None)
                if mb:
                    self._walk(mb.group(1), trip=trip * (t or 1),
                               depth=depth + 1, unres=unres or t is None,
                               path=path)
                continue
            if op in ("scatter", "select-and-scatter"):
                self._scatter_site(ins, comp, trip, depth, unres)
                continue
            if op == "dynamic-update-slice":
                self._dus_site(ins, comp, trip, depth, unres)
                continue
            if op == "sort":
                self._sort_site(ins, comp, trip, depth, unres)
                continue
            if op == "convert":
                refs = self._operand_refs(ins, comp)
                p = self._producer(refs[0], comp) if refs else None
                if p is not None and p.opcode == "compare" and \
                        any(self._chain_has_iota(r, comp)
                            for r in self._operand_refs(p, comp)):
                    dt, shape = _first_shape(ins.result)
                    self._one_hot_site(ins, comp, trip, depth, unres,
                                       dt, shape)
                continue
            if op == "call":
                for c in hlo.called_computations(ins.line):
                    if c.lstrip("_").startswith("one_hot"):
                        dt, shape = _first_shape(ins.result)
                        self._one_hot_site(ins, comp, trip, depth, unres,
                                           dt, shape)
                    else:
                        self._walk(c, trip=trip, depth=depth, unres=unres,
                                   path=path)
                continue
            if op in ("fusion", "map", "conditional"):
                for c in hlo.called_computations(ins.line):
                    self._walk(c, trip=trip, depth=depth, unres=unres,
                               path=path)

    @staticmethod
    def _looks_like_rewritten_scatter(ins) -> bool:
        m = _OPNAME_META_RE.search(ins.line)
        return bool(m and "scatter" in m.group(1))


def scan_hlo(text: str) -> ScanResult:
    """Scan an HLO module text for atomic-shaped sites."""
    return _Scanner(text).scan()


# ---------------------------------------------------------------------------
# Captured torch steps (``launch/capture.py``)
# ---------------------------------------------------------------------------

# shape-only hops the one-hot and consumer walks cross
_GRAPH_HOPS = ("aten.unsqueeze", "aten.view", "aten.expand", "aten._to_copy",
               "aten.reshape", "aten._unsafe_view", "aten.clone",
               "aten.permute", "aten.transpose", "aten.t", "aten.squeeze",
               "aten.select", "aten.slice")
_MATMULS = ("aten.mm", "aten.bmm", "aten.matmul", "aten.addmm", "aten.einsum",
            "aten.baddbmm")
_REDUCE_COMBINERS = {"sum": "add", "amax": "max", "amin": "min",
                     "prod": "mul"}


class _GraphScanner:
    """Atomic-shaped sites of a captured step, by the reference scanner's
    rules for the HLO op each aten node replaces."""

    def __init__(self, capture):
        self.cap = capture
        self.inputs = capture.input_storages
        self.producer: dict[int, object] = {}
        self.consumers: dict[int, list] = {}
        for node in capture.nodes:
            for r in node.outputs:
                self.producer[r.id] = node
            for r in node.tensor_args():
                self.consumers.setdefault(r.id, []).append(node)
        self.sites: list[AtomicSite] = []

    def _site(self, node, kind, *, operand, update=None, index=None,
              bins, updates, row, combiner) -> None:
        update = update or operand
        self.sites.append(AtomicSite(
            op_name=f"{node.op.split('.')[-1]}.{node.index}",
            opcode=node.op, kind=kind, computation=self.cap.label,
            hlo_line=node.line, operand_dtype=operand.dtype,
            operand_shape=tuple(operand.shape), update_dtype=update.dtype,
            update_shape=tuple(update.shape),
            index_dtype=index.dtype if index is not None else "s32",
            num_bins=max(1, int(bins)), num_updates=max(1, int(updates)),
            row_elems=max(1, int(row)), combiner=combiner,
            loop_depth=node.depth, trip_count=node.trips))

    def _scatter(self, node, *, operand, update, index, bins, updates, row,
                 combiner) -> None:
        kind = "scatter"
        if row <= 1 and combiner in ("add", "max", "min", "mul"):
            kind = "histogram_scatter"
        elif row > 1 and combiner in ("overwrite", "add"):
            kind = "dispatch_scatter"
        self._site(node, kind, operand=operand, update=update, index=index,
                   bins=bins, updates=updates, row=row, combiner=combiner)

    # -- the walks over producers and consumers ---------------------------

    def _reaches_arange(self, ref, depth: int = 5) -> bool:
        node = self.producer.get(ref.id)
        if node is None or depth < 0:
            return False
        if node.op == "aten.arange":
            return True
        if node.op in _GRAPH_HOPS:
            return any(self._reaches_arange(r, depth - 1)
                       for r in node.tensor_args()[:1])
        return False

    def _one_hot_kind(self, ref) -> str:
        """The consumer decides, through shape-only hops: a product makes
        it a one-hot matmul, anything else a dense histogram."""
        frontier = [ref]
        for _ in range(6):
            nxt = []
            for r in frontier:
                for node in self.consumers.get(r.id, []):
                    if node.op in _MATMULS:
                        return "one_hot_matmul"
                    if node.op in _GRAPH_HOPS:
                        nxt.extend(node.outputs)
            frontier = nxt
        return "one_hot_histogram"

    # -- one node ---------------------------------------------------------

    def visit(self, node) -> None:
        op, a = node.op, node.args
        if op in ("repro_torch.bincount", "aten.bincount"):
            ids = a[0]
            out = node.outputs[0]
            self._scatter(node, operand=out, update=ids, index=ids,
                          bins=out.numel, updates=ids.numel, row=1,
                          combiner="add")
        elif op == "repro_torch.scatter_add":
            values, ids, segments = a[0], a[1], a[2]
            self._scatter(node, operand=node.outputs[0], update=values,
                          index=ids, bins=segments, updates=ids.numel,
                          row=values.numel // max(1, ids.numel),
                          combiner="add")
        elif op in ("aten.scatter_add", "aten.scatter_add_",
                    "aten.scatter_reduce", "aten.scatter_reduce_",
                    "aten.scatter", "aten.scatter_"):
            self._elementwise_scatter(node)
        elif op in ("aten.index_put", "aten.index_put_",
                    "aten._index_put_impl_"):
            self._index_put(node)
        elif op in ("aten.index_add", "aten.index_add_", "aten.index_copy",
                    "aten.index_copy_"):
            self_, dim, index, src = a[0], a[1], a[2], a[3]
            dim %= len(self_.shape)
            bins = self_.shape[dim]
            self._scatter(node, operand=self_, update=src, index=index,
                          bins=bins, updates=index.numel,
                          row=self_.numel // max(1, bins),
                          combiner="add" if "add" in op else "overwrite")
        elif op == "aten.embedding_dense_backward":
            grad, ids, num_weights = a[0], a[1], a[2]
            self._scatter(node, operand=node.outputs[0], update=grad,
                          index=ids, bins=num_weights, updates=ids.numel,
                          row=grad.shape[-1], combiner="add")
        elif op == "aten.copy_":
            self._cache_write(node)
        elif op == "aten._to_copy":
            self._one_hot(node)
        elif op in ("aten.sort", "aten.argsort"):
            keys = a[0]
            if keys.dtype in _INT_DTYPES and any(
                    self.consumers.get(o.id) for o in node.outputs[1:]):
                self._site(node, "sort_segment", operand=keys, index=keys,
                           bins=keys.numel, updates=keys.numel, row=1,
                           combiner="none")

    def _elementwise_scatter(self, node) -> None:
        a = node.args
        self_, dim, index = a[0], a[1], a[2]
        src = a[3] if isinstance(a[3], type(self_)) else index
        combiner = "add" if "add" in node.op else "overwrite"
        if "reduce" in node.op:
            reduce = a[4] if len(a) > 4 else node.kwargs.get("reduce", "sum")
            combiner = _REDUCE_COMBINERS.get(reduce, "cas")
        dim %= len(self_.shape)
        self._scatter(node, operand=self_, update=src, index=index,
                      bins=self_.shape[dim], updates=index.numel, row=1,
                      combiner=combiner)

    def _index_put(self, node) -> None:
        a = node.args
        self_, indices, values = a[0], a[1], a[2]
        accumulate = a[3] if len(a) > 3 else node.kwargs.get(
            "accumulate", False)
        k = len(indices)
        bins = 1
        for d in self_.shape[:k]:
            bins *= d
        row = self_.numel // max(1, bins)
        idx = next((i for i in indices if i is not None), None)
        if idx is not None and idx.dtype == "pred":
            return                    # a mask: each element its own slot
        updates = idx.numel if idx is not None else 1
        self._scatter(node, operand=self_, update=values, index=idx,
                      bins=bins, updates=updates, row=row,
                      combiner="add" if accumulate else "overwrite")

    def _cache_write(self, node) -> None:
        """``buf[..., slot:slot + t, ...] = x`` into a step input: the
        decode step's KV write (only inside the layer loop, as the
        reference's scanner takes only loop-carried updates)."""
        if node.depth < 1:
            return
        dst, src = node.args[0], node.args[1]
        buf = self.inputs.get(dst.storage)
        if buf is None or buf.numel <= dst.numel:
            return
        self._site(node, "kv_cache_write", operand=buf, update=src,
                   bins=buf.numel // max(1, dst.numel), updates=1,
                   row=dst.numel, combiner="overwrite")

    def _one_hot(self, node) -> None:
        """``eq(ids[..., None], arange(n))`` converted: ``F.one_hot``."""
        src = node.args[0]
        eq = self.producer.get(src.id)
        if eq is None or eq.op != "aten.eq":
            return
        if not any(self._reaches_arange(r) for r in eq.tensor_args()):
            return
        out = node.outputs[0]
        updates = out.numel // max(1, out.shape[-1]) if out.shape else 1
        self._site(node, self._one_hot_kind(out), operand=out,
                   bins=out.shape[-1] if out.shape else 1, updates=updates,
                   row=1, combiner="add")


def scan_graph(capture) -> ScanResult:
    """Scan a captured step (``launch.capture.Capture``) for the
    reference's atomic-shaped sites; ``hlo_line`` is the node's line in
    ``capture.text``."""
    scanner = _GraphScanner(capture)
    for node in capture.nodes:
        scanner.visit(node)
    return ScanResult(sites=scanner.sites,
                      num_instructions=capture.num_instructions,
                      num_computations=1, unresolved_loops=0,
                      entry=capture.label)
