"""Render a contention ``Heatmap`` as text, json, or csv.

Same renderer contract as ``SweepResult.render``: one function, three
formats, the string goes to stdout or an artifact file.  The text form
is the operator view — a unicode sparkline of the per-wave contention
series plus a bar grid of the hottest bins; json carries the full
attribution for tooling; csv is the per-bin table.
"""

from __future__ import annotations

import csv as _csv
import io
import json
from typing import List

import numpy as np

__all__ = ["render", "render_text", "render_json", "render_csv",
           "sparkline"]

_BLOCKS = "▁▂▃▄▅▆▇█"  # ▁▂▃▄▅▆▇█


def sparkline(values, width: int = 64) -> str:
    """Downsample ``values`` to ``width`` buckets (max within a bucket)
    and map each to an eighth-block glyph.  Empty input -> empty string."""
    vals = np.asarray(values, np.float64).reshape(-1)
    if not vals.size:
        return ""
    width = max(1, min(int(width), vals.size))
    edges = np.linspace(0, vals.size, width + 1).astype(np.int64)
    buckets = np.array([vals[a:b].max() if b > a else vals[min(a, vals.size - 1)]
                        for a, b in zip(edges[:-1], edges[1:])])
    lo, hi = float(vals.min()), float(vals.max())
    if hi <= lo:
        return _BLOCKS[0] * width
    scaled = (buckets - lo) / (hi - lo) * (len(_BLOCKS) - 1)
    return "".join(_BLOCKS[int(round(s))] for s in scaled)


def render(hm, fmt: str = "text", top_k: int = 16) -> str:
    if fmt == "text":
        return render_text(hm, top_k=top_k)
    if fmt == "json":
        return render_json(hm, top_k=top_k)
    if fmt == "csv":
        return render_csv(hm)
    raise ValueError(f"unknown heat-map format {fmt!r}")


def _bin_rows(hm, top_k=None) -> List[dict]:
    idx = hm.top(top_k) if top_k else np.arange(hm.bins.size)
    total = hm.total_hits or 1
    hot = hm.hot_mask
    return [{
        "bin": int(hm.bins[i]),
        "hits": int(hm.hits[i]),
        "replays": int(hm.replays[i]),
        "max_wave_degree": float(hm.max_wave_degree[i]),
        "replay_share": float(hm.replays[i]) / total,
        "hot": bool(hot[i]),
    } for i in idx]


def render_text(hm, top_k: int = 16) -> str:
    c = hm.counters
    out = [f"contention heat map — {hm.label or '(unlabeled)'}"]
    op = hm.meta.get("op")
    if op:
        out[0] += f" [{op}/{hm.meta.get('variant')}]"
    out.append(
        f"  slots {hm.num_slots} · touched {hm.bins.size} · "
        f"hits {hm.total_hits} · waves {hm.num_waves} · "
        f"e {c.e:.2f} · O {c.total_O:.1f}")
    if hm.num_waves:
        out.append(
            f"  wave contention (degree over time, peak "
            f"{hm.peak_degree:.1f} @ wave {hm.peak_wave}):")
        out.append("    " + sparkline(hm.wave_degree))
    n_hot = int(hm.hot_mask.sum())
    out.append(f"  hot bins: {n_hot} of {hm.bins.size} touched "
               f"(wave degree >= {hm.hot_degree:g} with replays)")
    rows = _bin_rows(hm, top_k)
    if rows:
        out.append(f"  top {len(rows)} bins by serialized replays:")
        out.append("    {:>8} {:>10} {:>10} {:>7} {:>7}  {}".format(
            "bin", "hits", "replays", "maxdeg", "share", ""))
        peak = max(r["replays"] for r in rows) or 1
        for r in rows:
            bar = _BLOCKS[-1] * max(1 if r["replays"] else 0,
                                    round(10 * r["replays"] / peak))
            out.append(
                "    {bin:>8} {hits:>10} {replays:>10} "
                "{max_wave_degree:>7.1f} {pct:>6.1f}%  {bar}{mark}".format(
                    pct=100.0 * r["replay_share"], bar=bar,
                    mark=" *" if r["hot"] else "",
                    **{k: v for k, v in r.items() if k != "hot"}))
    if hm.top_bin is not None:
        out.append(f"  top-bin share {100.0 * hm.top_bin_share:.1f}% "
                   f"(bin {hm.top_bin})")
    else:
        out.append("  no serialized replays — stream is contention-free")
    return "\n".join(out)


def render_json(hm, top_k: int = 16) -> str:
    c = hm.counters
    body = {
        "label": hm.label,
        "meta": hm.meta,
        "num_slots": hm.num_slots,
        "touched_bins": int(hm.bins.size),
        "total_hits": hm.total_hits,
        "num_waves": hm.num_waves,
        "lanes": hm.lanes,
        "commit_group": hm.commit_group,
        "hot_degree": hm.hot_degree,
        "hot_bins": [int(b) for b in hm.hot_bins],
        "top_bin": hm.top_bin,
        "top_bin_share": hm.top_bin_share,
        "peak_wave": hm.peak_wave,
        "peak_degree": hm.peak_degree,
        "counters": {
            "total_O": c.total_O,
            "total_jobs": c.total_jobs,
            "e": c.e,
            "num_waves": c.num_waves,
            "lanes_active": c.lanes_active,
        },
        "bins": _bin_rows(hm, top_k),
        "wave_degree": [float(d) for d in hm.wave_degree],
    }
    return json.dumps(body, indent=2, sort_keys=True)


def render_csv(hm) -> str:
    buf = io.StringIO()
    w = _csv.writer(buf)
    w.writerow(["bin", "hits", "replays", "max_wave_degree",
                "replay_share", "hot"])
    for r in _bin_rows(hm, top_k=None):
        w.writerow([r["bin"], r["hits"], r["replays"],
                    f"{r['max_wave_degree']:.6g}",
                    f"{r['replay_share']:.6g}", int(r["hot"])])
    return buf.getvalue()
