"""mla_attention_roofline.mla_prefill: roofline share (%) of one call of
the attention core of the program's MLA mixer of layer 0
(``mla.attend_core``: K8 at q·k 192 and v 128, 128 heads) over its own q,
k and v from one sequence of ``roofline_tokens`` of the cell's tokens,
timed from outside by CUDA events; FLOPs (causal, half of the square)
and bytes from ``counts_mla.py``."""

from perfbench import counts_mla, readers


def read(run):
    if run.kind != "mla_prefill" or run.peaks() is None:
        return None
    call, (b, t) = run.driver.mla_attention_call()
    seconds = run.time_call(call)
    return readers._share(run, "mla_attention_roofline.mla_prefill",
                          counts_mla.mla_attention_flops(run.arch, b, t),
                          counts_mla.mla_attention_bytes(run.arch, b, t),
                          seconds)
