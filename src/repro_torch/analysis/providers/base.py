"""CounterProvider protocol + registry (the acquisition layer's contract).

The paper's pipeline is "performance counters -> queuing model ->
utilization verdict", and its validation (§5) hinges on comparing
*modeled* against *measured* counters.  A ``CounterProvider`` is one
counter source: it consumes a ``WorkloadSpec`` + ``Device`` and returns a
uniform ``repro_torch.core.counters.CounterSet``, so every downstream consumer
(``profile_counters``, ``Session``, ``Session.validate``) is agnostic to
where the numbers came from.

Four providers ship, registered under the names the ``Session``
constructor accepts:

    ``trace``      — synthesize the committed index stream in numpy and
                     derive counters from it (the modeled path; default)
    ``kernel``     — run the instrumented Hopper kernel and read its
                     per-wave degrees back (the measured path)
    ``hlo``        — derive bytes/FLOPs/collective traffic from a
                     compiled step's HLO text (no scatter counters)
    ``microbench`` — trace counters plus a wall time priced by the
                     calibrated timing model

The registry mirrors the device registry: look up by name with
``get_provider`` (instances pass through), extend with
``register_provider`` — a further counter source registers here and
every Session feature works unchanged.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Protocol, Sequence, Union, runtime_checkable

from repro_torch.core.counters import CounterFrame, CounterSet


@runtime_checkable
class CounterProvider(Protocol):
    """One counter-acquisition backend (see module docstring).

    ``collect`` is the required surface.  Providers may additionally
    implement the batch extension

        collect_batch(specs, device, *, parallel=None) -> CounterFrame

    returning one frame row per spec, bit-for-bit equal row-wise to the
    scalar ``collect`` (``CounterFrame`` rows are rectangular, so all
    specs in one call must share ``num_cores`` — ``Session`` groups
    before calling).  It is deliberately *not* part of the runtime
    protocol: a minimal collect-only provider still registers and works
    everywhere, with ``provider_collect_batch`` supplying the loop
    fallback.
    """

    name: str

    def collect(self, spec, device) -> CounterSet:
        """Acquire the spec's counters on the given device bundle."""
        ...


def collect_batch_fallback(
    provider: CounterProvider,
    specs: Sequence,
    device,
    parallel: Optional[int] = None,
) -> CounterFrame:
    """Grouped/loop ``collect_batch`` for backends with no vectorized path.

    One scalar ``collect`` per spec (optionally on a thread pool when
    ``parallel`` > 1), stacked into a ``CounterFrame`` — trivially
    bit-for-bit equal row-wise to the scalar path.  The kernel provider
    delegates here, and so does any registered collect-only
    provider via ``provider_collect_batch``.
    """
    specs = list(specs)
    if not specs:
        raise ValueError("collect_batch needs at least one spec")
    workers = min(parallel or 1, len(specs))
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            csets = list(pool.map(lambda s: provider.collect(s, device),
                                  specs))
    else:
        csets = [provider.collect(s, device) for s in specs]
    return CounterFrame.from_sets(csets)


def provider_collect_batch(
    provider: CounterProvider,
    specs: Sequence,
    device,
    parallel: Optional[int] = None,
) -> CounterFrame:
    """Dispatch to the provider's batch path, or the loop fallback.

    The single call site contract the ``Session`` batch executor uses:
    providers that implement ``collect_batch`` get the whole group at
    once; collect-only providers (including user-registered ones) are
    looped transparently.
    """
    batch = getattr(provider, "collect_batch", None)
    if batch is None:
        return collect_batch_fallback(provider, specs, device, parallel)
    return batch(specs, device, parallel=parallel)


PROVIDERS: dict[str, CounterProvider] = {}


def register_provider(provider: CounterProvider) -> CounterProvider:
    """Register a provider instance under ``provider.name``.

    Providers are stateless; one shared instance per name is registered
    (mirroring ``repro_torch.analysis.register_device``).  Returns the provider
    so the call can decorate a module-level instantiation.
    """
    PROVIDERS[provider.name] = provider
    return provider


def get_provider(
    name_or_provider: Union[str, CounterProvider],
) -> CounterProvider:
    """Look up a registry entry; a provider instance passes through."""
    if not isinstance(name_or_provider, str):
        if isinstance(name_or_provider, CounterProvider):
            return name_or_provider
        raise TypeError(f"not a CounterProvider: {name_or_provider!r} "
                        f"(needs .name and .collect(spec, device))")
    try:
        return PROVIDERS[name_or_provider]
    except KeyError:
        known = ", ".join(sorted(PROVIDERS))
        raise KeyError(
            f"unknown provider {name_or_provider!r}; registered: {known}. "
            f"Use repro_torch.analysis.register_provider() for custom sources."
        ) from None
