"""Unit tests for the pytree/select utilities and the fused-solve packing."""

import jax
import jax.numpy as jnp
import numpy as np

from ida_tpu.utils import masked_while_loop, take1, take_row, set_row, set1, tree_where


def test_take_set_helpers():
    v = jnp.asarray([10.0, 20.0, 30.0, 40.0])
    for i in range(4):
        assert float(take1(v, jnp.int32(i))) == float(v[i])
    m = jnp.arange(12.0).reshape(4, 3)
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(take_row(m, jnp.int32(i))), np.asarray(m[i]))
    np.testing.assert_array_equal(
        np.asarray(set1(v, jnp.int32(2), jnp.asarray(-1.0))), [10.0, 20.0, -1.0, 40.0]
    )
    m2 = set_row(m, jnp.int32(1), jnp.full((3,), -1.0))
    np.testing.assert_array_equal(np.asarray(m2[1]), [-1.0, -1.0, -1.0])
    np.testing.assert_array_equal(np.asarray(m2[0]), np.asarray(m[0]))


def test_masked_while_under_vmap_freezes_finished_lanes():
    # lanes count to different targets; finished lanes must not keep counting
    def run(target):
        def cond(c):
            return c[0] < target

        def body(c):
            return (c[0] + 1, c[1] + c[0])

        return masked_while_loop(cond, body, (jnp.int32(0), jnp.int32(0)))

    targets = jnp.asarray([1, 3, 5, 0], jnp.int32)
    n, s = jax.vmap(run)(targets)
    np.testing.assert_array_equal(np.asarray(n), [1, 3, 5, 0])
    np.testing.assert_array_equal(np.asarray(s), [0, 3, 10, 0])


def test_tree_where_broadcasts_over_leaves():
    a = {"x": jnp.ones((2, 3)), "y": jnp.zeros((2,))}
    b = {"x": jnp.zeros((2, 3)), "y": jnp.ones((2,))}
    out = tree_where(jnp.asarray([True, False]), a, b)
    np.testing.assert_array_equal(np.asarray(out["x"]), [[1, 1, 1], [0, 0, 0]])
    np.testing.assert_array_equal(np.asarray(out["y"]), [0, 1])


def test_named_scopes_in_lowered_program():
    """Per-routine jax.named_scope annotations (the reference's
    profile_scope! coverage, src/lib.rs:614-1364) are visible in the lowered
    program's metadata, so xprof attributes time per stage."""
    import re
    import jax
    import jax.numpy as jnp
    from ida_tpu.core.step import attempt_once
    from ida_tpu.core.state import init_state, IdaOptions
    from ida_tpu.models import roberts_problem

    prob = roberts_problem(with_roots=False)
    st = init_state(prob, jnp.array([1.0, 0, 0]), jnp.array([-0.04, 0.04, 0]))
    st = st._replace(hh=jnp.asarray(1e-4, st.dtype), ewt=jnp.ones(3, st.dtype))
    opts = IdaOptions()
    z = jnp.zeros((), jnp.int32)

    def fn(st):
        return attempt_once(st, prob, opts, st.tn, z, z)

    txt = jax.jit(fn).lower(st).as_text(debug_info=True)
    scopes = set(re.findall(r"ida\.[a-z_.]+", txt))
    for expected in ("ida.set_coeffs", "ida.predict", "ida.nonlinear_solve",
                     "ida.error_test", "ida.restore", "ida.lsetup",
                     "ida.newton_iterate"):
        assert expected in scopes, (expected, sorted(scopes))


def test_profile_scope_degrades_to_noop(monkeypatch, tmp_path):
    """utils.profiling.profile: on backends without profiler support the
    context degrades to a WARNED no-op — the block still runs (the
    documented contract; reference tracing role, SURVEY.md §5)."""
    import contextlib
    import warnings

    import ida_tpu.utils.profiling as prof

    @contextlib.contextmanager
    def broken_trace(_dir):
        raise RuntimeError("no profiler on this backend")
        yield  # pragma: no cover

    monkeypatch.setattr(jax.profiler, "trace", broken_trace)
    ran = []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with prof.profile(str(tmp_path / "trace")):
            ran.append(True)
    assert ran == [True]
    assert any("unprofiled" in str(x.message) for x in w)

    # and the happy path really enters jax.profiler.trace
    entered = []

    @contextlib.contextmanager
    def ok_trace(d):
        entered.append(d)
        yield

    monkeypatch.setattr(jax.profiler, "trace", ok_trace)
    with prof.profile(str(tmp_path / "trace2")):
        pass
    assert entered == [str(tmp_path / "trace2")]
