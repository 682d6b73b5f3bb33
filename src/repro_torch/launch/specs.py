"""Meta-device stand-ins for every model input, with their placements.

The reference's ``repro/launch/specs.py``: where it returns
``ShapeDtypeStruct``s with ``NamedSharding``s, each function here returns
tensors on the meta device (shape and dtype, no memory) and the matching
tree of ``sharding.NamedSharding`` on the mesh.  Parameters and caches
come from the port's own ``init``/``init_cache`` run on the meta device
(``layers.MetaGenerator``), the counterpart of ``jax.eval_shape``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import data_axes_of
from repro_torch.models import layers
from repro_torch.models.registry import build_model
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import NamedSharding, P
from repro_torch.train import step as train_step_mod

META = torch.device("meta")


def _batch_axes(mesh, batch_size: int) -> Optional[tuple[str, ...]]:
    """Data axes if the batch divides across them, else replicate."""
    axes = data_axes_of(mesh)
    n = pctx.axes_size(mesh, axes)
    return axes if batch_size % n == 0 and batch_size >= n else None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _extras(cfg: ModelConfig, b: int, mesh, axes) -> tuple[dict, dict]:
    """The modality stub of the audio and VLM families."""
    stubs = {"audio": ("frames", cfg.encoder_frames),
             "vlm": ("image_embeds", cfg.image_tokens)}
    if cfg.family not in stubs:
        return {}, {}
    name, n = stubs[cfg.family]
    return ({name: _meta((b, n, cfg.d_model), layers.torch_dtype(cfg.dtype))},
            {name: NamedSharding(mesh, P(axes, None, None))})


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                      ) -> tuple[dict, dict]:
    """(the batch on meta, its shardings)."""
    b, s = shape.global_batch, shape.seq_len
    axes = _batch_axes(mesh, b)
    batch = {k: _meta((b, s), torch.int32) for k in ("tokens", "labels")}
    sh = {k: NamedSharding(mesh, P(axes)) for k in batch}
    extra, extra_sh = _extras(cfg, b, mesh, axes)
    return {**batch, **extra}, {**sh, **extra_sh}


def meta_model(cfg: ModelConfig):
    """The model of ``cfg`` on the meta device."""
    return build_model(cfg, META)


def param_specs(model, mesh) -> tuple:
    """(the parameters on meta, their shardings) of ``model``'s config."""
    model = meta_model(model.cfg)
    shapes = model.init(layers.MetaGenerator())
    return shapes, shd.param_shardings(shapes, model.cfg, mesh)


def state_specs(model, mesh, ocfg=None) -> tuple:
    """The full train state (parameters and AdamW state) on meta, and its
    shardings."""
    model = meta_model(model.cfg)
    shapes = train_step_mod.init_state(model, layers.MetaGenerator(), ocfg)
    pspecs = shd.param_pspecs(shapes["params"], model.cfg)
    state_pspecs = {"params": pspecs,
                    "opt": shd.opt_state_pspecs(shapes["opt"], pspecs),
                    "step": P()}
    return shapes, shd.shardings_of(state_pspecs, mesh)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model, mesh,
                 params_meta) -> tuple:
    """(the cache on meta, its shardings, the tokens on meta, their
    sharding, the position's sharding).  The reference's ``pos`` is a
    replicated int32 scalar; the port's decode step takes a Python int,
    so only its (replicated) sharding comes back."""
    b = shape.global_batch
    axes = _batch_axes(mesh, b)
    model = meta_model(cfg)
    extras, _ = _extras(cfg, b, mesh, axes)
    if cfg.family == "audio":
        cache = model.init_cache(params_meta, b, shape.seq_len,
                                 frames=extras["frames"])
    elif cfg.family == "vlm":
        cache = model.init_cache(params_meta, b, shape.seq_len,
                                 image_embeds=extras["image_embeds"])
    else:
        cache = model.init_cache(params_meta, b, shape.seq_len)
    cache_sh = shd.shardings_of(
        shd.cache_pspecs(cache, cfg, data_axes=axes, seq_axis="model"), mesh)
    tokens = _meta((b, 1), torch.int32)
    return (cache, cache_sh, tokens, NamedSharding(mesh, P(axes, None)),
            NamedSharding(mesh, P()))


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                  ) -> tuple[dict, dict]:
    """(the prefill's inputs on meta, their shardings)."""
    b, s = shape.global_batch, shape.seq_len
    axes = _batch_axes(mesh, b)
    out = {"tokens": _meta((b, s), torch.int32)}
    sh = {"tokens": NamedSharding(mesh, P(axes, None))}
    extra, extra_sh = _extras(cfg, b, mesh, axes)
    return {**out, **extra}, {**sh, **extra_sh}
