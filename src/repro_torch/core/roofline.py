"""Three-term roofline of a captured step (the reference's spec
§ROOFLINE), on the reference's TPU constants.

    compute term    = step FLOPs  / (chips * peak_FLOP/s)
    memory term     = step bytes  / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

plus MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) and the useful
compute ratio.  The constants are ``timing.V5E``'s, as in the reference:
these terms are model outputs for a TPU v5e part, held as data to compare
the port's captured steps with the reference's compiled ones, not times
of the H100.

A capture records each rank's own operations (``launch/capture.py``):
per-partition quantities, as XLA's cost analysis of an SPMD module.
``probe_cost_normalization()`` measures that once a process, as the
reference probes XLA: it captures a matmul sharded over the current
process group and compares the FLOPs with the analytic count.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import hlo, timing

V5E = timing.V5E


@functools.cache
def probe_cost_normalization() -> float:
    """Return multiplier m such that total_flops = reported_flops * m *
    chips.

    Captures ``x @ w`` with ``w`` sharded over every rank of the default
    process group (a ``fake`` group of any size will do) and compares
    the captured FLOPs with 2·m·k·n.  m ~= 1/chips means the capture is
    already whole-program; m ~= 1 means per-rank.  Without a group, or
    with one rank, it is 1.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.capture import capture

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 1.0
    ndev = dist.get_world_size()
    mesh = init_device_mesh("cpu", (ndev,), mesh_dim_names=("x",))
    m, k, n = 256, 256, 256 * ndev
    x = distribute_tensor(torch.empty((m, k), device="meta"), mesh,
                          [Replicate()])
    w = distribute_tensor(torch.empty((k, n), device="meta"), mesh,
                          [Shard(1)])
    flops, _ = hlo.flops_and_bytes(capture(lambda a, b: a @ b, x, w,
                                           label="probe", chips=ndev,
                                           grad=False))
    true_flops = 2.0 * m * k * n
    if flops <= 0:
        return 1.0
    ratio = true_flops / flops  # = chips if per-rank, 1 if total
    return ratio / ndev  # per-chip multiplier


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh_name: str
    chips: int
    # whole-program quantities
    hlo_flops: float
    hlo_bytes: float
    collective_operand_bytes: float   # per-device operand-byte sum (spec)
    collective_wire_bytes: float      # ring-model per-link traffic
    # terms (seconds)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    model_flops: float = 0.0
    bytes_per_device: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        chip = V5E
        self.compute_s = self.hlo_flops / (self.chips * chip.peak_bf16_flops)
        self.memory_s = self.hlo_bytes / (self.chips * chip.hbm_bw)
        # collective_operand_bytes is per-device; scaling by chips and then
        # dividing by (chips * link_bw) per the spec formula reduces to
        # per-device bytes / link_bw.  The ring-model estimate is reported
        # alongside as the tighter wire-time bound.
        self.collective_s = self.collective_operand_bytes / chip.ici_bw_per_link

    @property
    def collective_wire_s(self) -> float:
        return self.collective_wire_bytes / V5E.ici_bw_per_link

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": max(self.collective_s, self.collective_wire_s)}
        return max(terms, key=terms.get)

    @property
    def step_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s,
                   self.collective_s, self.collective_wire_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step bound spent on *useful* compute."""
        useful_s = self.model_flops / (self.chips * V5E.peak_bf16_flops)
        lb = self.step_lower_bound_s
        return useful_s / lb if lb > 0 else 0.0

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant,
                 useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction,
                 collective_wire_s=self.collective_wire_s,
                 step_lower_bound_s=self.step_lower_bound_s)
        return d


def from_compiled(capture, *, arch: str, shape: str, mesh_name: str,
                  chips: int, model_flops: float) -> RooflineTerms:
    """Build roofline terms from a captured step (``launch.capture``):
    its per-rank FLOPs and bytes times ``probe_cost_normalization()`` and
    the chips are the whole program's."""
    multiplier = probe_cost_normalization()
    flops, nbytes = hlo.flops_and_bytes(capture)
    coll = hlo.capture_collectives(capture)
    mem = hlo.memory_analysis_dict(capture)
    bytes_per_device = float(
        mem.get("argument_size_in_bytes", 0)
        + mem.get("output_size_in_bytes", 0)
        + mem.get("temp_size_in_bytes", 0)
        - mem.get("alias_size_in_bytes", 0))
    return RooflineTerms(
        arch=arch, shape=shape, mesh_name=mesh_name, chips=chips,
        hlo_flops=flops * multiplier * chips,
        hlo_bytes=nbytes * multiplier * chips,
        collective_operand_bytes=float(coll.total_operand_bytes),
        collective_wire_bytes=float(coll.total_wire_bytes),
        model_flops=model_flops,
        bytes_per_device=bytes_per_device,
        collective_counts=coll.by_opcode(),
    )

