"""What the per-layer readers (``metrics/<metric>.py``) share.  A
reader returns None where its cell gives it nothing to read, and the
harness then leaves the metric out of the line; a share of a roofline or
of a peak is None off the card, never 0."""

from __future__ import annotations

from perfbench import counts
from perfbench.harness import log


def idle_percent(run, kind: str):
    """100 x (1 - busy / window) of the traced slice."""
    prof = run.profile
    if run.kind != kind or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu_percent(run, kind: str):
    """The window's model FLOPs over its time and the card's bf16 peak."""
    peak = run.peaks()
    if run.kind != kind or peak is None or not run.units:
        return None
    flops = sum(u["flops"] for u in run.units)
    return 100.0 * flops / run.elapsed / peak["bf16_flops_per_s"]


def _share(run, name: str, flops: float, nbytes: float, seconds: float):
    peak = run.peaks()
    if peak is None:
        return None
    share, bound = counts.roofline_share(flops, nbytes, seconds, peak)
    log(f"{name}: {seconds * 1e3:.4f} ms a call, {flops:.6g} FLOP, "
        f"{nbytes:.6g} B, bound by {bound}, {share:.4f}% of the roofline "
        f"(power limit {run.power_limit})")
    return share


def moe_roofline(run, kind: str, backward: bool):
    """Roofline share of one call of the program's MoE layer (forward,
    or forward and backward) at the cell's token count, timed from
    outside."""
    if run.kind != kind or run.peaks() is None:
        return None
    call, tokens = run.driver.moe_call()
    seconds = run.time_call(call)
    flops = counts.moe_flops(run.arch, tokens) * (3 if backward else 1)
    nbytes = counts.moe_bytes(run.arch, tokens, backward)
    return _share(run, f"moe_roofline.{kind}", flops, nbytes, seconds)


def attention_roofline(run, kind: str):
    """Roofline share of one call of the program's self-attention
    (projections and the causal core), timed from outside."""
    if run.kind != kind or run.peaks() is None:
        return None
    call, (b, t) = run.driver.attention_call()
    seconds = run.time_call(call)
    return _share(run, f"attention_roofline.{kind}",
                  counts.attention_flops(run.arch, b, t),
                  counts.attention_bytes(run.arch, b, t), seconds)
