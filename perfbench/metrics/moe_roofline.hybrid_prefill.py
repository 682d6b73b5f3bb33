"""moe_roofline.hybrid_prefill: roofline share (%) of one forward of the
program's MoE layer 0 (``models/moe.py`` ``apply_local``: the routed
experts and the shared expert) over its own input from
``roofline_tokens`` of the cell's tokens (the embedding plus layer 0's
Mamba-2 mixer, normed), timed from outside by CUDA events; FLOPs and
bytes from ``counts_hybrid.py``."""

from perfbench import counts_hybrid, readers


def read(run):
    if run.kind != "hybrid_prefill" or run.peaks() is None:
        return None
    call, tokens = run.driver.moe_call()
    seconds = run.time_call(call)
    return readers._share(run, "moe_roofline.hybrid_prefill",
                          counts_hybrid.moe_flops(run.arch, tokens),
                          counts_hybrid.moe_bytes(run.arch, tokens), seconds)
