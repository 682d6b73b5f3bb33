"""The audit's expected findings, and its finding specs as K6 takes them
(shared by the CPU tests, the card's tests and ``chip_smoke.py``'s audit
phase).

Each finding carries a candidate ``WorkloadSpec`` of 2^17 synthesized ids;
one spec serves every finding with its fingerprint.  K6, like the
reference's kernel, takes a segment axis wider than one block only as
whole blocks, and a few sites address a destination of a block count and
one (2^23 + 1 rows in qwen3-moe's prefill).  Their streams are checked
with the axis widened to whole blocks: the ids are the same and all lie
below the original count, so the degrees, N and O do not move
(``kernel_ready`` callers hold the trace provider's counters of both
specs bit-equal).
"""

import dataclasses

from repro_torch.kernels.scatter_add import kernel as sk

# each HLO text of tests/data the port audits: its (rule, severity) counts
# and distinct finding specs, as the reference audits it
PINNED = {
    "granite_moe_1b_a400m__decode": (
        {("ATOM001", "warning"): 1, ("BANK001", "warning"): 5}, 4),
    "whisper_small__train": (
        {("BANK001", "warning"): 40, ("ATOM003", "note"): 1}, 4),
    "qwen3_moe_235b_a22b__decode": (
        {("ATOM001", "error"): 1, ("BANK001", "warning"): 7,
         ("GEOM001", "note"): 3, ("ATOM003", "note"): 1}, 10),
    "qwen3_moe_235b_a22b__prefill": (
        {("ATOM001", "error"): 1, ("BANK001", "warning"): 3,
         ("GEOM001", "note"): 10, ("ATOM003", "note"): 1}, 11),
}


def distinct_specs(report) -> dict:
    """fingerprint -> the first finding's spec, in finding order."""
    out = {}
    for f in report.findings:
        if f.spec is not None:
            out.setdefault(f.spec.fingerprint(), f.spec)
    return out


def whole_blocks(n: int, block: int = sk.DEFAULT_SEG_BLOCK) -> int:
    return n if n < block or n % block == 0 else -(-n // block) * block


def kernel_ready(spec):
    """``spec`` with its segment axis widened to whole K6 blocks."""
    if spec.kernel is not None:
        n = spec.kernel.params["num_segments"]
        if whole_blocks(n) != n:
            params = {**spec.kernel.params, "num_segments": whole_blocks(n)}
            return spec.with_(kernel=dataclasses.replace(spec.kernel,
                                                         params=params))
    elif whole_blocks(spec.num_bins) != spec.num_bins:
        return spec.with_(num_bins=whole_blocks(spec.num_bins))
    return spec
