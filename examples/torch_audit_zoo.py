"""Static audit of a zoo config on the PyTorch port: MoE dispatch +
KV-cache findings, no kernels.

The audit is the paper's utilization model turned into a *linter*: it
never runs a kernel and never collects counters from a provider.  Each
step of a config is captured on meta tensors (shapes only, no memory)
under a one-rank mesh — the forward, the backward of a train step, and
the K5/K7/K8 operators as one node each — and the scanner walks the
captured aten graph for atomic-shaped sites: MoE token-dispatch
scatters, expert-count histograms, KV-cache decode writes, one-hot and
sort-segment lowerings.  Every matched rule scores a synthesized
worst-plausible index stream in one columnar model pass.  Each finding
carries the predicted scatter-unit utilization, its contention ratio
over a conflict-free baseline, and the advisor transform that would fix
it.

This example audits ``qwen3-moe-235b-a22b`` (128-expert MoE with a
32k-token KV cache) and asserts the headline hazards are found:

  * a ``dispatch_scatter`` site — the MoE token-dispatch scatter that
    routes token rows into expert buffers, and
  * a ``histogram_scatter`` site — the per-expert token-count
    accumulation the router needs (K7),
  * a ``kv_cache_write`` — the decode step's KV write,

and that the session's collection stats stay at zero: the whole audit
is static.  The reference's example (``examples/audit_zoo.py``) makes
the same assertions on the HLO JAX lowers.

The same audit is available without Python:

    PYTHONPATH=src python -m repro_torch audit --config qwen3_moe_235b_a22b

Run: PYTHONPATH=src python examples/torch_audit_zoo.py
"""

import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.analysis import Session  # noqa: E402
from repro_torch.audit import audit_config  # noqa: E402

CONFIG = "qwen3-moe-235b-a22b"


def main() -> int:
    sess = Session("v5e")
    # reduced=True captures the smoke-geometry variant (same scatter
    # idioms, sub-second); drop it to audit the full production shapes.
    report = audit_config(CONFIG, session=sess, reduced=True)
    print(report.render("text"))

    kinds = {f.site.kind for f in report.findings if f.site is not None}
    assert "dispatch_scatter" in kinds, (
        f"MoE token-dispatch scatter not found (kinds: {sorted(kinds)})")
    assert "histogram_scatter" in kinds, (
        f"expert-count histogram not found (kinds: {sorted(kinds)})")
    assert "kv_cache_write" in kinds, (
        f"KV-cache decode write not found (kinds: {sorted(kinds)})")

    for f in report.findings:
        if f.site is not None:
            assert f.utilization is not None and f.fixit, f
    assert sess.stats == {"collected": 0, "memo_hits": 0, "disk_hits": 0,
                          "batch_calls": 0}, (
        f"audit must be static, but providers ran: {sess.stats}")

    print(f"\naudit found {len(report.findings)} finding(s) across "
          f"{sorted(kinds)} — zero kernel executions ({sess.stats})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
