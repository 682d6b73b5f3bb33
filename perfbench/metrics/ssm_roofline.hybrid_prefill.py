"""ssm_roofline.hybrid_prefill: roofline share (%) of one forward of the
program's Mamba-2 mixer of layer 0 (``models/mamba2.py`` ``apply``) over
its own input from ``roofline_tokens`` of the cell's tokens as one
sequence (the embedding, normed), timed from outside by CUDA events;
FLOPs and bytes from ``counts_hybrid.py``."""

from perfbench import counts_hybrid, readers


def read(run):
    if run.kind != "hybrid_prefill" or run.peaks() is None:
        return None
    call, tokens = run.driver.ssm_call()
    seconds = run.time_call(call)
    return readers._share(run, "ssm_roofline.hybrid_prefill",
                          counts_hybrid.ssm_flops(run.arch, 1, tokens),
                          counts_hybrid.ssm_bytes(run.arch, tokens), seconds)
