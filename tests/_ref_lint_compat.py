"""Run the reference's kernel lint (``repro.lint``) on this jax, scoped.

The reference's lint traces its Pallas kernels to jaxprs through three
names that newer jax releases (0.9.0 among them) moved or renamed:

1. ``jax.core.ClosedJaxpr``, ``Jaxpr`` and ``Literal`` now live in
   ``jax.extend.core`` (``repro/lint/tracing.py`` reads them from
   ``jax.core``);
2. a block dimension of a ``BlockSpec`` is a ``Blocked(block_size=...)``
   object, no longer an int (``PallasRecord.block_shape`` calls ``int``
   on it);
3. the ``pjit`` primitive is named ``jit``, so the interpreter's handler
   lookup (``_prim_<name>``) misses ``_prim_pjit`` and a nested jit call
   reads as opaque.

``reference_lint_compat(monkeypatch)`` papers over the three, through a
``pytest.MonkeyPatch`` that the caller scopes (a fixture's
``MonkeyPatch.context()``): nothing here runs at import, and nothing of
``src/repro`` is edited.  Undone, the reference's own ``tests/test_lint.py``
sees this jax as it is.
"""

from __future__ import annotations


def reference_lint_compat(monkeypatch) -> None:
    """Apply the three changes above to ``monkeypatch``'s scope."""
    import jax
    import jax.extend.core as jex
    from jax._src.pallas import core as pallas_core

    from repro.lint import tracing as ref_tracing

    for name in ("ClosedJaxpr", "Jaxpr", "Literal"):
        monkeypatch.setattr(jax.core, name, getattr(jex, name),
                            raising=False)
    monkeypatch.setattr(pallas_core.Blocked, "__int__",
                        lambda self: int(self.block_size), raising=False)
    monkeypatch.setattr(ref_tracing._Interpreter, "_prim_jit",
                        ref_tracing._Interpreter._prim_pjit, raising=False)


def compat_applied() -> bool:
    """Whether any of the three changes is in place."""
    import jax
    from jax._src.pallas import core as pallas_core

    from repro.lint import tracing as ref_tracing

    return (hasattr(jax.core, "ClosedJaxpr")
            or "__int__" in vars(pallas_core.Blocked)
            or hasattr(ref_tracing._Interpreter, "_prim_jit"))
