"""repro_torch.lint — the kernel lint's rule catalog (``rules``).

The lint itself (``lint_kernel``, ``lint_registry``, ``Session.lint``
and the ``lint`` command) waits for ROADMAP queue 1, "Kernel lint".
"""
