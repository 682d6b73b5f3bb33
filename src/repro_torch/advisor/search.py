"""Candidate enumeration + frontier scoring for the optimization advisor.

The search is "cartesian + beam": the catalog's parameterized transforms
supply the cartesian axes (every replication factor / geometry value is
its own catalog entry) and a beam composes across transform *families*
— each level extends every surviving composition with every legal
transform whose family it does not already use, so depth 2 with the
default catalog explores e.g. ``rotate-channels + wpt=32`` but never
``wpt=16 + wpt=32``.

Scoring rides the session's batch machinery: candidate counters are
acquired through the session's memo / persistent ``SweepCache`` (a
re-advised spec collects nothing), and **each frontier is scored by a
single columnar ``CounterFrame``/``profile_batch`` evaluation** — the
baseline rides along as row 0, so predicted speedups come from one
whole-array model pass per level, never per-candidate scalar profiling.
That batch-evaluation invariant is asserted by the tests.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.advisor.report import AdvisorReport, Candidate
from repro_torch.advisor.transforms import (Transform, TransformCost,
                                            default_catalog)
from repro_torch.analysis.providers import CounterProvider
from repro_torch.core import bottleneck


def _speedup(baseline_prof, prof) -> float:
    """``speedup_estimate`` that degrades broken candidates to 0.0.

    A candidate whose modeled window is zero is a broken rewrite, not an
    infinite win; ranking it last (0.0) keeps the search total-ordered
    without poisoning the report.
    """
    if float(np.max(prof.T_cycles)) <= 0.0:
        return 0.0
    return bottleneck.speedup_estimate(baseline_prof, prof)


class AdvisorSearch:
    """Beam search over transform compositions, scored by the queue model.

    ``session`` supplies everything: the device bundle, the counter
    provider, the in-process memo and optional persistent sweep cache,
    and the columnar batch evaluator.  ``catalog`` defaults to
    ``transforms.default_catalog()``; ``depth`` bounds composition
    length; ``beam_width`` bounds how many compositions each level
    extends.  ``kernel_provider`` is what ``validate_top`` measures the
    top candidates through (a registry name or a provider instance;
    default the registered ``"kernel"``, which launches on the card) —
    the one signature difference from the reference's advisor, so that a
    caller's ``InstrumentedKernelProvider(torch_device=...)`` decides
    where the validation runs.
    """

    def __init__(self, session, *, catalog: Optional[Sequence[Transform]]
                 = None, depth: int = 2, beam_width: int = 8,
                 kernel_provider: Union[str, CounterProvider] = "kernel",
                 ) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if beam_width < 1:
            raise ValueError(f"beam_width must be >= 1, got {beam_width}")
        self.session = session
        self.catalog = list(catalog) if catalog is not None \
            else default_catalog()
        self.depth = depth
        self.beam_width = beam_width
        self.kernel_provider = kernel_provider

    # -- enumeration ------------------------------------------------------

    def _extend(self, node: Candidate, seen: set) -> list[Candidate]:
        """All one-transform extensions of ``node`` (family-once rule)."""
        used = {t.family for t in node.transforms}
        out = []
        for t in self.catalog:
            if t.family in used or not t.legal(node.spec):
                continue
            new_spec = t.apply(node.spec)
            fp = new_spec.fingerprint()
            if fp is not None:
                # two orders of the same composition produce the same
                # spec content: enumerate it once
                if fp in seen:
                    continue
                seen.add(fp)
            # cost is judged on the spec the transform is APPLIED to:
            # Replicate's scratch/reduce annotations describe the bins it
            # multiplies, not the already-multiplied result
            out.append(Candidate(
                spec=new_spec, transforms=node.transforms + (t,),
                cost=TransformCost.merge([node.cost, t.cost(node.spec)])))
        return out

    # -- the search -------------------------------------------------------

    def search(self, spec, *, top_k: int = 5, validate_top: int = 0,
               parallel: Optional[int] = None) -> AdvisorReport:
        """Search transform space around ``spec``; return the ranked report.

        ``top_k`` bounds how many candidates the report renders (all
        evaluated candidates stay on ``AdvisorReport.candidates``);
        ``validate_top`` re-validates that many of the top-ranked
        kernel-source candidates through ``kernel_provider`` (paper §5's
        model-vs-measured check); ``parallel`` spreads counter
        collection over a thread pool like ``Session.sweep``.
        """
        sess = self.session
        stats_before = dict(sess.stats)
        base_cset = sess.collect_cached(spec)
        baseline_prof = None
        survivors = [Candidate(spec=spec, transforms=())]
        evaluated: list[Candidate] = []
        seen = {spec.fingerprint()} - {None}
        frontiers = batch_evals = 0

        for _level in range(self.depth):
            frontier: list[Candidate] = []
            for node in survivors:
                frontier.extend(self._extend(node, seen))
            if not frontier:
                break
            frontiers += 1
            csets = self._collect(frontier, parallel)
            # one columnar model evaluation scores the whole frontier;
            # the baseline rides along as row 0 so speedups are computed
            # against numbers from the very same batch pass
            profs = sess.profile_sets([base_cset] + csets)
            batch_evals += 1
            if baseline_prof is None:
                baseline_prof = profs[0]
            for cand, prof in zip(frontier, profs[1:]):
                cand.profile = prof
                cand.speedup = _speedup(baseline_prof, prof)
                cand.verdict = bottleneck.classify(prof)
            evaluated.extend(frontier)
            survivors = sorted(frontier, key=_rank_key)[:self.beam_width]

        if baseline_prof is None:
            # no transform was legal: the report is just the baseline
            baseline_prof = sess.profile_sets([base_cset])[0]
            batch_evals += 1

        ranked = sorted(evaluated, key=_rank_key)
        report = AdvisorReport(
            device=sess.device.name,
            baseline_label=spec.label,
            baseline_profile=baseline_prof,
            baseline_verdict=bottleneck.classify(baseline_prof),
            candidates=ranked,
            top_k=top_k,
            stats=_stats(stats_before, sess.stats, len(evaluated),
                         frontiers, batch_evals),
        )
        if validate_top > 0:
            self._validate_top(report, validate_top)
        return report

    def _collect(self, frontier: Sequence[Candidate],
                 parallel: Optional[int]) -> list:
        # one batch resolution per frontier: memo / persistent-cache hits
        # in bulk, misses through provider.collect_batch (``parallel``
        # only threads providers that fall back to a scalar loop)
        return self.session.collect_cached_batch(
            [c.spec for c in frontier], parallel=parallel)

    def _validate_top(self, report: AdvisorReport, k: int) -> None:
        """Paper-§5 check on the top-k: modeled vs measured counters.

        Only kernel-source candidates can run the instrumented-kernel
        provider; others are skipped (they stay unvalidated, which the
        report renders as such).
        """
        for cand in report.top(k):
            if cand.spec.kernel is None:
                continue
            cand.validation = self.session.validate(
                cand.spec, providers=("trace", self.kernel_provider))


def _rank_key(c: Candidate):
    """Total order: speedup desc, then fewer transforms, then label.

    The tie-breaks make the ranking deterministic — same spec + seed
    must reproduce the identical report (tested).
    """
    return (-c.speedup, len(c.transforms), c.label)


def _stats(before: dict, after: dict, candidates: int, frontiers: int,
           batch_evals: int) -> dict:
    collection = {k: after[k] - before.get(k, 0) for k in after}
    return {"candidates": candidates, "frontiers": frontiers,
            "batch_evals": batch_evals, **collection}
