"""MicrobenchProvider: trace counters plus a modeled service-time clock.

The paper's validation compares the queue model's prediction against a
*timed* run.  The service-time table models the reference's TPU scatter
unit (``v5e``/``v5p``), not the card the port runs on, so a wall clock
here would time another machine: the calibrated timing model prices the
counted ``(n, e, c)`` directly instead — exactly what
``core.microbench`` does in ``analytic`` mode when building Tool 1's
table.  Downstream consumers get a ``wall_time_s`` that comes from the
measurement side, not from the table the model interpolates, so
``Session.validate`` has an independent time axis to compare against.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.analysis.providers.base import register_provider
from repro_torch.analysis.providers.trace import TraceProvider
from repro_torch.core import timing
from repro_torch.core.counters import CounterFrame, CounterSet


class MicrobenchProvider(TraceProvider):
    """Trace counters + timing-model wall time (measured-side stand-in)."""

    name = "microbench"

    def collect(self, spec, device) -> CounterSet:
        return self._attach_wall_time(super().collect(spec, device), device)

    def collect_batch(self, specs: Sequence, device, *,
                      parallel: Optional[int] = None) -> CounterFrame:
        """The inherited vectorized trace batch, plus the per-row wall
        time post-pass (which the plain trace batch would silently drop —
        this override is what keeps batch rows bit-identical to scalar
        ``collect``)."""
        frame = super().collect_batch(specs, device, parallel=parallel)
        return CounterFrame.from_sets(
            [self._attach_wall_time(frame.row(i), device)
             for i in range(len(frame))])

    def _attach_wall_time(self, cset: CounterSet, device) -> CounterSet:
        params = device.scatter
        n_hat = cset.occupancy(params.n_max) * params.n_max
        e = cset.e
        # Price each core's jobs in batches of n_hat through the timing
        # model: busy ~= N * T(n_hat, e, c, p) / n_hat (paper Eq. 3).
        busy = np.zeros(cset.num_cores)
        for core in range(cset.num_cores):
            n_jobs = float(cset.N[core])
            if n_jobs == 0 or n_hat <= 0:
                continue
            c_share = n_hat * (cset.N_c[core] / n_jobs)
            p_share = n_hat * (cset.N_p[core] / n_jobs)
            t_batch = float(timing.total_time_cycles(
                n_hat, e, c_share, p_share, params))
            busy[core] = n_jobs * t_batch / n_hat
        # source is already "microbench": the inherited collect stamps
        # self.name
        cset.wall_time_s = float(np.max(busy)) / params.clock_hz
        cset.meta["busy_cycles_measured"] = busy.tolist()
        return cset


register_provider(MicrobenchProvider())
