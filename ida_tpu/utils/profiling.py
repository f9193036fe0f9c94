"""Profiling hooks.

The reference's profiling is ``thread_profiler`` scopes around each hot
routine producing a Chrome trace (SURVEY.md §5). The JAX equivalent
is the XLA profiler plus per-routine ``jax.named_scope`` annotations
(``profile_scope!`` in every hot function: reference src/lib.rs:614-615,
723-724, 788-789, 895-896, 1275-1276, 1363-1364; impl_solve.rs:75-76;
impl_complete_step.rs:23-24; SURVEY.md §5):

* :func:`scope` — decorator adding ``jax.named_scope("ida.<name>")`` so HLO
  ops carry the routine name and xprof traces attribute time per stage
  instead of one undifferentiated fusion soup.
* :func:`profile` — an XLA profiler trace around a whole block.
"""

from __future__ import annotations

import contextlib
import functools

import jax


def scope(name: str):
    """Decorator: run the function under ``jax.named_scope("ida.<name>")``.

    Pure metadata — zero effect on the compiled program's numerics or
    fusion decisions; HLO instructions created inside carry the scope in
    their metadata, which xprof and compiler dumps display per stage."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with jax.named_scope(f"ida.{name}"):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def profile(trace_dir: str):
    """Capture an XLA profiler trace around a block::

        with ida_tpu.utils.profiling.profile("/tmp/ida_trace"):
            ens.solve(400.0)

    View with TensorBoard (or xprof). On backends without profiler support
    this degrades to a no-op with a warning.
    """
    try:
        with jax.profiler.trace(trace_dir):
            yield
    except Exception as e:  # pragma: no cover - backend dependent
        import warnings

        warnings.warn(f"ida_tpu: profiler unavailable ({e}); running unprofiled")
        yield
