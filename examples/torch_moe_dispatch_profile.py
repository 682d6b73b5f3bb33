"""Beyond-paper application on the PyTorch/H100 port: the queuing model
watching a *live* MoE router.

The first MoE layer of the reduced qwen3-MoE routes seeded activations
through ``repro_torch.models.moe.apply_local`` on ``--torch-device``
(default ``cuda``, where K7 counts the dispatch and K5 sums the combine;
``cpu`` runs their plain versions).  Each router's dispatch stream is
then profiled with counters read from the instrumented scatter-add
kernel (K6) on the same device, not from a host-synthesized trace.  A
collapsing router (simulated by a bias toward the first top-k experts)
is flagged by the model before it would show up as a slower step — the
MoE-age version of the paper's solid-image histogram.

The reference example (``examples/moe_dispatch_profile.py``) draws its
weights with ``jax.random``; given the same weights and activations,
``profile_routers`` prints its lines (e, U and verdict) exactly.

Run: PYTHONPATH=src python examples/torch_moe_dispatch_profile.py \
         [--torch-device cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import (InstrumentedKernelProvider,  # noqa: E402
                                  Session, WorkloadSpec)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

ROUTERS = ((0.0, "healthy router"), (0.5, "drifting router"),
           (50.0, "collapsed router"))


def profile_dispatch(session: Session, ids: np.ndarray, num_experts: int,
                     label: str):
    spec = WorkloadSpec.from_scatter_add(
        ids.astype(np.int32), np.ones((ids.size, 1), np.float32),
        num_experts, label=label, waves_per_tile=32)
    prof = session.profile(spec)
    v = session.last.verdicts[0]
    print(f"  {label:24s} e={prof.e:5.2f} "
          f"U={prof.scatter_utilization:6.2%}  {v.comment}")
    return prof


def profile_routers(p_moe: dict, h: torch.Tensor, mcfg: moe.MoEConfig,
                    session: Session) -> list:
    """Route ``h`` (T, d) through the layer ``p_moe`` with each router
    bias, and profile each dispatch stream; returns the profiles."""
    print("router health via scatter-unit utilization:")
    profiles = []
    for bias, label in ROUTERS:
        # router collapse = systematic bias toward a few experts (top-k is
        # invariant to logit *scaling*, so collapse manifests as bias)
        w = p_moe["router"]["w"].clone()
        w[:, :mcfg.top_k] += bias
        p_biased = dict(p_moe, router={"w": w})
        _, _, disp = moe.apply_local(p_biased, h.to(torch.float32), mcfg)
        profiles.append(profile_dispatch(
            session, disp.cpu().numpy(), mcfg.num_experts,
            f"{label} (bias {bias:g})"))
    return profiles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="where the layer and the kernels run (default cuda)")
    args = ap.parse_args(argv)
    dev = args.torch_device
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_expert=cfg.d_expert,
                         num_experts=cfg.num_experts, top_k=cfg.top_k,
                         dtype=cfg.dtype)
    # one layer's MoE params, and activations routed through it
    p_moe = params["layers"][0]["ffn"]
    h = torch.randn((8 * 128, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)) * 0.3
    # provider: counters from the instrumented scatter-add launch itself
    session = Session(device="v5e",
                      provider=InstrumentedKernelProvider(torch_device=dev))
    return profile_routers(p_moe, h, mcfg, session)


if __name__ == "__main__":
    main()
