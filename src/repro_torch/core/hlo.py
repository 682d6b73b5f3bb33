"""HLO module text: FLOPs, bytes, and per-collective traffic.

The static side of a step, read from its HLO text alone: a
trip-count-aware walk of the module's computations gives FLOPs and HBM
bytes (``analyze_module``), and every collective op is listed with its
operand shapes and replica groups (``parse_collectives``).
``collective_bytes`` is not in XLA's own cost analysis, so the module
text is parsed and operand sizes are summed per collective opcode.

For a per-partition SPMD module, operand sizes are *per-device* shard
sizes.  Both the raw per-device operand byte sum and a ring-model
wire-time estimate that accounts for group size k are reported
(all-gather moves (k-1)/k of the full buffer through each link;
all-reduce twice that).

The text is all the walk reads.  A captured torch step
(``launch.capture.Capture``) stands for the reference's compiled object:
``cost_analysis_dict``, ``memory_analysis_dict`` and ``flops_and_bytes``
read it as the reference reads ``compiled.cost_analysis()`` and
``memory_analysis()``, and ``capture_collectives`` lists its collectives
through the same ring model.  This module imports nothing but ``re`` and
``dataclasses``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3": 1,
    "e4m3": 1, "e5m2": 1, "f4e2m1fn": 1,
}

# opcode -> per-link traffic multiplier as a function of group size k,
# relative to the summed *input operand* bytes s (per device):
#   all-gather: each device contributes s and receives (k-1)s -> ring moves
#     (k-1)*s per link;  all-reduce: reduce-scatter + all-gather = 2(k-1)/k
#     on the full buffer = 2(k-1)*s_in/k ... we use input-operand based
#     forms so everything keys off operand sizes, matching the spec.
_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)

# Dims may carry dynamic-size markers (`s32[<=16]`); tuples may nest one
# level and carry layout annotations on elements and on the tuple itself:
# `(f32[8,128]{1,0}, s32[])` or `((f32[2], s32[]), f32[4]{0})`.
_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,<=]*)\]")
_ARRAY_SHAPE_PAT = r"[a-z0-9]+\[[0-9,<=]*\](?:\{[^}]*\})?"
_TUPLE_SHAPE_PAT = r"\((?:[^()]|\([^()]*\))*\)(?:\{[^}]*\})?"
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*"
    rf"({_TUPLE_SHAPE_PAT}|{_ARRAY_SHAPE_PAT})\s+"
    r"([\w\-]+)\(")


def _dim_int(d: str) -> int:
    """Parse one dim token, tolerating dynamic-size markers (`<=16`)."""
    return int(d.lstrip("<="))
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_LIST_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def shape_bytes(shape_text: str) -> int:
    """Sum bytes over every `dtype[dims]` token in a shape/operand string."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= _dim_int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass
class CollectiveOp:
    opcode: str
    name: str
    operand_bytes: int     # per-device summed input operand bytes
    group_size: int        # replica group size k (1 = no comm)
    wire_bytes: float      # ring-model per-link traffic estimate

    @staticmethod
    def ring_wire_bytes(opcode: str, operand_bytes: int, k: int) -> float:
        if k <= 1:
            return 0.0
        if opcode.startswith("all-reduce"):
            return 2.0 * operand_bytes * (k - 1) / k
        if opcode.startswith("all-gather"):
            return float(operand_bytes) * (k - 1)
        if opcode.startswith("reduce-scatter"):
            return float(operand_bytes) * (k - 1) / k
        if opcode.startswith(("all-to-all", "ragged-all-to-all")):
            return float(operand_bytes) * (k - 1) / k
        if opcode.startswith(("collective-permute", "collective-broadcast")):
            return float(operand_bytes)
        return float(operand_bytes)


@dataclasses.dataclass
class CollectiveSummary:
    ops: list[CollectiveOp]

    @property
    def total_operand_bytes(self) -> int:
        return sum(o.operand_bytes for o in self.ops)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    def by_opcode(self) -> dict[str, dict]:
        agg: dict[str, dict] = {}
        for o in self.ops:
            d = agg.setdefault(o.opcode, {"count": 0, "operand_bytes": 0,
                                          "wire_bytes": 0.0})
            d["count"] += 1
            d["operand_bytes"] += o.operand_bytes
            d["wire_bytes"] += o.wire_bytes
        return agg


def _base_opcode(opcode: str) -> Optional[str]:
    # `all-gather-start`, `all-reduce-start` etc.: count -start, skip -done.
    if opcode.endswith("-done"):
        return None
    for c in _COLLECTIVES:
        if opcode == c or opcode == c + "-start":
            return c
    return None


def parse_collectives(hlo_text: str, num_devices: int) -> CollectiveSummary:
    """Extract every collective op with operand bytes + replica group size."""
    # First pass: map instruction name -> result shape text (for operands
    # referenced by name without an inline shape).
    shapes: dict[str, str] = {}
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if m:
            shapes[m.group(1)] = m.group(2)

    ops: list[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, _result_shape, opcode = m.groups()
        base = _base_opcode(opcode)
        if base is None:
            continue
        # Operand list: text between the first '(' after opcode and the
        # matching ')'.  Operands are printed with inline shapes in
        # post-optimization dumps; fall back to name lookup otherwise.
        start = line.index(opcode + "(") + len(opcode) + 1
        depth, end = 1, start
        while end < len(line) and depth:
            if line[end] == "(":
                depth += 1
            elif line[end] == ")":
                depth -= 1
            end += 1
        operand_text = line[start:end - 1]
        obytes = shape_bytes(operand_text)
        if obytes == 0:
            for ref in re.findall(r"%([\w.\-]+)", operand_text):
                obytes += shape_bytes(shapes.get(ref, ""))
        k = _parse_group_size(line, num_devices)
        ops.append(CollectiveOp(
            opcode=base, name=name, operand_bytes=obytes, group_size=k,
            wire_bytes=CollectiveOp.ring_wire_bytes(base, obytes, k)))
    return CollectiveSummary(ops=ops)


def _parse_group_size(line: str, num_devices: int) -> int:
    m = _IOTA_GROUPS_RE.search(line)
    if m:
        # iota format: replica_groups=[num_groups,group_size]<=[N]...
        return max(1, int(m.group(2)))
    m = _LIST_GROUPS_RE.search(line)
    if m:
        first = [t for t in m.group(1).split(",") if t.strip() != ""]
        return max(1, len(first))
    return num_devices


# ---------------------------------------------------------------------------
# Full-module cost model with loop trip-count accounting
# ---------------------------------------------------------------------------
#
# XLA's HloCostAnalysis (and thus compiled.cost_analysis()) counts a while
# body ONCE, so any scan-heavy program (layer stacks, grad accumulation,
# blockwise attention) is undercounted by orders of magnitude.  This
# analyzer walks the computation call graph, multiplies while bodies by
# their detected trip count (scan lowers to `compare(iv, constant), LT`),
# counts dot FLOPs exactly from shapes + contracting dims, approximates
# elementwise FLOPs at 1/elem, and models bytes at fusion boundaries
# (operands + outputs of top-level ops), which mirrors XLA's post-fusion
# HBM-traffic model.  Collective operand bytes get the same multipliers.

_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.+\{\s*$")
# Pre-optimization dumps (`lowered.compiler_ir("hlo").as_hlo_text()`) print
# computation headers without signatures: `region_9.143 {` / `ENTRY main.847 {`.
_COMP_BARE_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\{\s*$")
_CALLED_RE = re.compile(
    r"(?:calls|to_apply|body|condition|branch_computations)=\{?%?([\w.\-]+(?:,\s*%?[\w.\-]+)*)\}?")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_CONST_CMP_RE = re.compile(r"constant\((\d+)\)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_REF_RE = re.compile(r"%([\w.\-]+)")

_ELEMWISE = {
    "add", "subtract", "multiply", "divide", "power", "exponential",
    "exponential-minus-one", "log", "log-plus-one", "tanh", "sqrt", "rsqrt",
    "negate", "maximum", "minimum", "abs", "cosine", "sine", "logistic",
    "floor", "ceil", "round-nearest-afz", "sign", "atan2", "erf",
    "remainder", "cbrt",
}
_FREE = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "reshape", "broadcast", "iota", "copy-start", "copy-done",
    "after-all", "partition-id", "replica-id", "custom-call", "infeed",
    "outfeed", "rng-bit-generator", "optimization-barrier",
}


def np_prod(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


class _Instr:
    __slots__ = ("name", "result", "opcode", "line")

    def __init__(self, name, result, opcode, line):
        self.name, self.result, self.opcode, self.line = \
            name, result, opcode, line


def _parse_computations(text: str) -> dict[str, list[_Instr]]:
    comps: dict[str, list[_Instr]] = {}
    cur: Optional[str] = None
    for line in text.splitlines():
        if cur is None:
            s = line.strip()
            m = _COMP_RE.match(s) or _COMP_BARE_RE.match(s)
            if m and line.rstrip().endswith("{"):
                cur = m.group(1)
                comps[cur] = []
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if m:
            comps[cur].append(_Instr(m.group(1), m.group(2), m.group(3),
                                     line))
    return comps


def _operand_section(line: str, opcode: str) -> str:
    try:
        start = line.index(opcode + "(") + len(opcode) + 1
    except ValueError:
        return ""
    depth, end = 1, start
    while end < len(line) and depth:
        if line[end] == "(":
            depth += 1
        elif line[end] == ")":
            depth -= 1
        end += 1
    return line[start:end - 1]


def _shape_dims(shape_text: str) -> list[tuple[str, list[int]]]:
    return [(dt, [_dim_int(d) for d in dims.split(",")] if dims else [])
            for dt, dims in _SHAPE_RE.findall(shape_text)]


def called_computations(line: str) -> list[str]:
    """Names of computations referenced by calls/to_apply/body/... attrs."""
    out = []
    for m in _CALLED_RE.finditer(line):
        for name in m.group(1).split(","):
            out.append(name.strip().lstrip("%"))
    return out


def resolve_trip_count(comps: dict[str, list["_Instr"]], while_line: str,
                       cond_name: Optional[str]) -> Optional[int]:
    """Trip count of a `while` op: frontend `known_trip_count` metadata if
    present, else the loop-bound constant found in the condition
    computation (possibly fusion-wrapped). None if unresolvable."""
    m = _TRIP_RE.search(while_line)
    if m:
        return int(m.group(1))
    if cond_name is None:
        return None
    seen, frontier = set(), [cond_name]
    while frontier:
        c = frontier.pop()
        if c in seen:
            continue
        seen.add(c)
        for ins in comps.get(c, []):
            if ins.opcode == "constant":
                m = _CONST_CMP_RE.search(ins.line)
                if m:
                    return int(m.group(1))
            frontier.extend(called_computations(ins.line))
    return None


@dataclasses.dataclass
class ModuleCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_operand_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    unresolved_loops: int = 0


class HloCostModel:
    """Trip-count-aware cost walk over a post-optimization HLO module."""

    def __init__(self, text: str, num_devices: int):
        self.text = text
        self.num_devices = num_devices
        self.comps = _parse_computations(text)
        self.entry = self._find_entry(text)
        self._memo: dict[str, ModuleCost] = {}
        # per-computation name -> result-shape text (operands are printed
        # name-only in post-scheduling dumps)
        self._shapes: dict[str, dict[str, str]] = {
            comp: {i.name: i.result for i in instrs}
            for comp, instrs in self.comps.items()}

    def _operand_bytes(self, ins: _Instr, comp: str) -> int:
        sec = _operand_section(ins.line, ins.opcode)
        inline = shape_bytes(sec)
        if inline:
            return inline
        local = self._shapes.get(comp, {})
        total = 0
        for ref in _REF_RE.findall(sec):
            total += shape_bytes(local.get(ref, ""))
        return total

    def _operand_shapes(self, ins: _Instr, comp: str) -> list:
        sec = _operand_section(ins.line, ins.opcode)
        inline = _shape_dims(sec)
        if inline:
            return inline
        local = self._shapes.get(comp, {})
        out = []
        for ref in _REF_RE.findall(sec):
            out.extend(_shape_dims(local.get(ref, "")))
        return out

    @staticmethod
    def _find_entry(text: str) -> Optional[str]:
        for line in text.splitlines():
            s = line.strip()
            if s.startswith("ENTRY"):
                m = _COMP_RE.match(s) or _COMP_BARE_RE.match(s)
                if m:
                    return m.group(1)
        return None

    def analyze(self) -> ModuleCost:
        if self.entry is None:
            return ModuleCost()
        return self._cost_of(self.entry)

    # -- internals ----------------------------------------------------------

    def _trip_count(self, while_line: str, cond_name: Optional[str]
                    ) -> Optional[int]:
        return resolve_trip_count(self.comps, while_line, cond_name)

    def _flops_only(self, comp: str) -> float:
        """Arithmetic inside a fused computation (bytes stay at boundary)."""
        total = 0.0
        for ins in self.comps.get(comp, []):
            total += self._instr_flops(ins, comp)
            called = self._called(ins)
            if ins.opcode == "fusion" or ins.opcode in ("call", "map"):
                for c in called:
                    total += self._flops_only(c)
        return total

    def _called(self, ins: _Instr) -> list[str]:
        return called_computations(ins.line)

    def _instr_flops(self, ins: _Instr, comp: str) -> float:
        op = ins.opcode
        if op == "dot":
            out_elems = 1.0
            for _, dims in _shape_dims(ins.result):
                for d in dims:
                    out_elems *= d
            operands = self._operand_shapes(ins, comp)
            contract = 1.0
            m = _CONTRACT_RE.search(ins.line)
            if m and operands:
                lhs_dims = operands[0][1]
                idxs = [int(i) for i in m.group(1).split(",") if i != ""]
                for i in idxs:
                    if i < len(lhs_dims):
                        contract *= lhs_dims[i]
            return 2.0 * out_elems * contract
        if op == "reduce":
            ops_ = self._operand_shapes(ins, comp)
            elems = 1.0
            if ops_:
                for d in ops_[0][1]:
                    elems *= d
            return elems
        if op in _ELEMWISE:
            elems = 1.0
            for _, dims in _shape_dims(ins.result):
                for d in dims:
                    elems *= d
            return elems
        return 0.0

    def _fusion_is_inplace_update(self, ins: _Instr) -> bool:
        """kLoop fusions wrapping a dynamic-update-slice write only the
        updated region in-place; the big buffer passes through aliased."""
        seen, frontier = set(), list(self._called(ins))
        while frontier:
            c = frontier.pop()
            if c in seen:
                continue
            seen.add(c)
            for sub in self.comps.get(c, []):
                if sub.opcode == "dynamic-update-slice":
                    return True
                if sub.opcode == "fusion":
                    frontier.extend(self._called(sub))
        return False

    def _instr_bytes(self, ins: _Instr, comp: str) -> float:
        """HBM-traffic model per top-level op (TPU-fusion-calibrated):

        * dot / reduce / concatenate / sort: operands + output (real
          streaming reads/writes),
        * dynamic-slice / gather: 2x output (read region + write result),
        * dynamic-update-slice (incl. fused): 2x update operand — the
          buffer is updated in place (XLA aliases it), not copied,
        * everything else (elementwise, fusions, transposes): 2x output —
          one write plus one read of equal order by the consumer; operand
          re-counting would double-bill every producer-consumer edge, which
          on TPU is fused away.
        """
        op = ins.opcode
        if op in _FREE or op in ("while", "conditional"):
            return 0.0
        out_b = shape_bytes(ins.result)
        if op == "dot" or op in ("reduce", "concatenate", "sort", "pad",
                                 "reduce-window"):
            return float(out_b + self._operand_bytes(ins, comp))
        if op in ("dynamic-slice", "gather"):
            return float(2 * out_b)
        if op == "dynamic-update-slice":
            shapes = self._operand_shapes(ins, comp)
            upd = 0
            if len(shapes) >= 2:
                dt, dims = shapes[1]
                n = 1
                for d in dims:
                    n *= d
                upd = n * _DTYPE_BYTES.get(dt, 4)
            return float(2 * upd) if upd else float(out_b)
        if op == "fusion":
            if self._fusion_is_trivial_init(ins):
                # zero/constant buffer fills are aliased or hoisted on TPU
                return 0.0
            if self._fusion_is_inplace_update(ins):
                # charge the non-aliased operands (update + indices); drop
                # ONE operand matching the output size (the aliased buffer)
                sizes = [(_DTYPE_BYTES.get(dt, 4) * int(np_prod(dims)))
                         for dt, dims in self._operand_shapes(ins, comp)]
                if sizes:
                    for i, sz in enumerate(sizes):
                        if sz == out_b:
                            sizes.pop(i)
                            break
                    return float(2 * sum(sizes))
                return float(out_b)
        return float(2 * out_b)

    def _fusion_is_trivial_init(self, ins: _Instr) -> bool:
        for c in self._called(ins):
            ops = {s.opcode for s in self.comps.get(c, [])}
            if ops <= {"parameter", "constant", "broadcast", "bitcast",
                       "iota", "convert"}:
                return True
        return False

    def _cost_of(self, comp: str) -> ModuleCost:
        if comp in self._memo:
            return self._memo[comp]
        total = ModuleCost()
        self._memo[comp] = total  # break cycles defensively
        for ins in self.comps.get(comp, []):
            op = ins.opcode
            called = self._called(ins)
            if op == "while":
                mb = re.search(r"body=%?([\w.\-]+)", ins.line)
                mc = re.search(r"condition=%?([\w.\-]+)", ins.line)
                body = mb.group(1) if mb else None
                cond = mc.group(1) if mc else None
                trip = self._trip_count(ins.line, cond)
                if trip is None:
                    trip = 1
                    total.unresolved_loops += 1
                sub = self._cost_of(body) if body else ModuleCost()
                total.flops += trip * sub.flops
                total.bytes += trip * sub.bytes
                total.collective_operand_bytes += \
                    trip * sub.collective_operand_bytes
                total.collective_wire_bytes += trip * sub.collective_wire_bytes
                total.unresolved_loops += sub.unresolved_loops
                continue
            if op == "fusion":
                for c in called:
                    total.flops += self._flops_only(c)
                total.bytes += self._instr_bytes(ins, comp)
                continue
            if op in ("call", "map", "conditional", "sort",
                      "reduce", "reduce-window", "scatter", "select-and-scatter",
                      "all-reduce", "reduce-scatter"):
                # reductions/collectives carry to_apply computations (tiny),
                # conditionals take the max branch
                if op == "conditional" and called:
                    branches = [self._cost_of(c) for c in called]
                    best = max(branches, key=lambda c: c.flops)
                    total.flops += best.flops
                    total.bytes += best.bytes
                    total.collective_operand_bytes += \
                        best.collective_operand_bytes
                    total.collective_wire_bytes += best.collective_wire_bytes
                    continue
                if op in ("call", "map") and called:
                    for c in called:
                        sub = self._cost_of(c)
                        total.flops += sub.flops
                        total.bytes += sub.bytes
                        total.collective_operand_bytes += \
                            sub.collective_operand_bytes
                        total.collective_wire_bytes += sub.collective_wire_bytes
                    continue
            base = _base_opcode(op)
            if base is not None:
                obytes = self._operand_bytes(ins, comp)
                k = _parse_group_size(ins.line, self.num_devices)
                wire = CollectiveOp.ring_wire_bytes(base, obytes, k)
                total.collective_operand_bytes += obytes
                total.collective_wire_bytes += wire
                total.collectives.append(
                    CollectiveOp(opcode=base, name=ins.name,
                                 operand_bytes=obytes, group_size=k,
                                 wire_bytes=wire))
            total.flops += self._instr_flops(ins, comp)
            total.bytes += self._instr_bytes(ins, comp)
        self._memo[comp] = total
        return total


def analyze_module(text: str, num_devices: int) -> ModuleCost:
    return HloCostModel(text, num_devices).analyze()


# Public aliases for the instruction-graph walk (used by `repro_torch.audit`).
def parse_computations(text: str) -> dict[str, list[_Instr]]:
    return _parse_computations(text)


def operand_section(line: str, opcode: str) -> str:
    return _operand_section(line, opcode)


def shape_dims(shape_text: str) -> list[tuple[str, list[int]]]:
    return _shape_dims(shape_text)


def find_entry(text: str) -> Optional[str]:
    return HloCostModel._find_entry(text)


# ---------------------------------------------------------------------------
# A captured step: the counterpart of the reference's compiled object
# ---------------------------------------------------------------------------


def cost_analysis_dict(capture) -> dict:
    """Per-rank ``{"flops", "bytes accessed"}`` of a captured step: each
    node's FLOPs (``FlopCounterMode``'s formulas) and bytes times its
    trips (the loops the capture cut to one iteration).  The bytes are
    the sum over the captured aten operations of their input and output
    tensor bytes: an upper bound before fusion, where XLA's cost analysis
    counts after it."""
    flops = nbytes = 0.0
    for node in capture.nodes:
        flops += node.flops * node.trips
        nbytes += node.bytes * node.trips
    return {"flops": flops, "bytes accessed": nbytes}


def memory_analysis_dict(capture) -> dict:
    """Per-rank argument, output and temp bytes of a captured step: the
    step's inputs, its outputs, and the peak of the storages its
    operations make while they are live (from each storage's first write
    to its last use), over the captured iteration of each loop."""
    inputs = {ref.storage: ref.nbytes for _, ref in capture.inputs}
    outputs = {ref.storage: ref.nbytes for ref in capture.outputs}
    first: dict[int, int] = {}
    last: dict[int, int] = {}
    size: dict[int, int] = {}
    for node in capture.nodes:
        for ref in node.outputs:
            if ref.storage not in inputs:
                first.setdefault(ref.storage, node.index)
                size[ref.storage] = max(size.get(ref.storage, 0), ref.nbytes)
        for ref in node.tensor_args():
            last[ref.storage] = node.index
    events: list[tuple[int, int]] = []
    for st, start in first.items():
        if st in outputs:
            continue
        events.append((start, size[st]))
        events.append((last.get(st, start) + 1, -size[st]))
    live = peak = 0
    for _, delta in sorted(events, key=lambda e: (e[0], e[1])):
        live += delta
        peak = max(peak, live)
    return {"argument_size_in_bytes": int(sum(inputs.values())),
            "output_size_in_bytes": int(sum(outputs.values())),
            "temp_size_in_bytes": int(peak),
            "alias_size_in_bytes": 0}


def flops_and_bytes(capture) -> tuple[float, float]:
    ca = cost_analysis_dict(capture)
    return float(ca["flops"]), float(ca["bytes accessed"])


def capture_collectives(capture) -> CollectiveSummary:
    """The collectives a captured step issues on each rank, one entry a
    node with its operand bytes summed over its trips, and its wire bytes
    through the ring model of ``parse_collectives`` at its group size."""
    ops = []
    for node in capture.nodes:
        if node.collective is None:
            continue
        opcode, obytes, k = node.collective
        ops.append(CollectiveOp(
            opcode=opcode, name=f"{node.op}.{node.index}",
            operand_bytes=int(obytes) * node.trips, group_size=int(k),
            wire_bytes=CollectiveOp.ring_wire_bytes(opcode, obytes, k)
            * node.trips))
    return CollectiveSummary(ops=ops)
