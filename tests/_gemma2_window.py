"""gemma2-27b's local layer at every published width, and the two checks
that hold its window and its ring buffer to their definitions (shared by
the card's tests and ``chip_smoke.py``'s families phase)."""

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.models import attention, layers, transformer


def local_layer(device, t: int):
    """gemma2-27b's local attention layer in f32 (seed 2) and an input of
    (1, t, d_model) x 2: scores of about 4 sigma, so that the 50.0 softcap
    takes a few percent off the largest.  Returns (acfg, params, the
    generator, x)."""
    cfg = dataclasses.replace(get_config("gemma2-27b"), dtype="float32")
    acfg = transformer._attn_cfg(cfg, "attn_local")
    gen = torch.Generator(device=device).manual_seed(2)
    params = attention.init(gen, acfg)
    x = torch.randn((1, t, cfg.d_model), generator=gen, device=device) * 2
    return acfg, params, gen, x


def banded_attention_f64(p, x, acfg):
    """The local attention of x (1, T, d) in f64, straight from the
    definitions: projections, RoPE (on the model's f32 angles, which the
    reference also computes in f32: at position 4600 their rounding alone
    moves an angle by up to 3e-4), softcapped scores, the band of the
    window (key j seen by query i where i - window < j <= i) by index
    arithmetic, not ``attention._mask_bias``, softmax.  Returns it and the
    same without the window (the causal mask alone), both f64."""
    b, t, _ = x.shape
    hd, g = acfg.head_dim, acfg.num_heads // acfg.num_kv_heads
    x64 = x.double()

    def heads(w, n):
        return (x64 @ w["w"].double()).reshape(b, t, n, hd).transpose(1, 2)

    cos, sin = (a.double() for a in layers.rope_angles(
        torch.arange(t, device=x.device), hd, acfg.rope_theta))

    def rope(z):
        z1, z2 = z[..., :hd // 2], z[..., hd // 2:]
        return torch.cat([z1 * cos - z2 * sin, z2 * cos + z1 * sin], -1)

    q = rope(heads(p["wq"], acfg.num_heads))
    k = rope(heads(p["wk"], acfg.num_kv_heads)).repeat_interleave(g, 1)
    v = heads(p["wv"], acfg.num_kv_heads).repeat_interleave(g, 1)
    s = q @ k.transpose(-1, -2) * hd ** -0.5
    s = torch.tanh(s / acfg.logit_softcap) * acfg.logit_softcap
    i = torch.arange(t, device=x.device)[:, None]
    j = torch.arange(t, device=x.device)[None, :]
    outs = []
    for keep in ((j <= i) & (i - j < acfg.window), j <= i):
        o = torch.softmax(s.masked_fill(~keep, float("-inf")), -1) @ v
        outs.append(o.transpose(1, 2).reshape(b, t, -1)
                    @ p["wo"]["w"].double())
    return outs


def ring_against_full(p, x, acfg):
    """x (1, T, d), T past the window, decoded token by token twice: through
    the ring ``init_cache`` gives a windowed layer (the window's slots) and
    through a T-slot buffer, which ``init_cache`` of the same layer without
    its window gives (the window would shrink it to the ring).  ``attend``
    takes the windowed config both times and masks the window by position.
    Returns the buffers' slots and the max |diff| over every step and over
    the steps past the wrap."""
    dev, steps = x.device, x.shape[1]
    if steps <= acfg.window:
        raise ValueError(f"{steps} steps never wrap a {acfg.window}-slot ring")
    caches = [attention.init_cache(c, 1, steps, x.dtype, dev) for c in
              (acfg, dataclasses.replace(acfg, window=None))]
    slots = tuple(c["k"].shape[2] for c in caches)
    if slots != (acfg.window, steps):
        raise AssertionError(f"buffers of {slots} slots, not "
                             f"{(acfg.window, steps)}")
    worst = wrapped = 0.0
    with torch.no_grad():
        for t in range(steps):
            outs = []
            for i, c in enumerate(caches):
                o, caches[i] = attention.attend(
                    p, x[:, t:t + 1], acfg,
                    positions=torch.tensor([t], device=dev),
                    cache=dict(c, pos=t))
                outs.append(o)
            e = float((outs[0] - outs[1]).abs().max())
            worst = max(worst, e)
            if t >= acfg.window:
                wrapped = max(wrapped, e)
    return slots, worst, wrapped
