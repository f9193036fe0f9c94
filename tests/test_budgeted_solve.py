"""Budgeted attempt loop (max_attempts fori_loop + exact resume carry):
bit-identical to the unbudgeted while-loop path. This is the
reverse-differentiable main-loop form the discrete adjoint uses."""

import jax
import jax.numpy as jnp
import numpy as np

from ida_tpu import constants as C
from ida_tpu.core.solve import solve as core_solve
from ida_tpu.core.state import IdaOptions, init_state
from ida_tpu.models import roberts_problem, ROBERTS_YY0, ROBERTS_YP0
from ida_tpu.tol_control import tol_sv


def _setup():
    prob = roberts_problem(with_roots=False)
    tol = tol_sv(1e-4, jnp.array([1e-8, 1e-6, 1e-6]))
    opts = IdaOptions()
    st = init_state(prob, ROBERTS_YY0, ROBERTS_YP0, opts=opts)
    return prob, tol, opts, st


def test_budgeted_resume_bit_identical():
    prob, tol, opts, st0 = _setup()
    tout = jnp.asarray(4.0)

    ref_st, ref_tret, ref_ist = jax.jit(
        lambda s: core_solve(s, prob, opts, tol, tout)
    )(st0)
    assert int(ref_ist) == C.SUCCESS

    budget = 7  # deliberately tiny so several resumes are needed
    first = jax.jit(
        lambda s: core_solve(s, prob, opts, tol, tout, max_attempts=budget)
    )
    again = jax.jit(
        lambda s, carry: core_solve(
            s, prob, opts, tol, tout, max_attempts=budget, resume_carry=carry
        )
    )
    st, tret, ist, carry = first(st0)
    rounds = 1
    while int(ist) == C.CONTINUE:
        st, tret, ist, carry = again(st, carry)
        rounds += 1
        assert rounds < 100
    assert rounds > 3  # the budget actually bit

    assert int(ist) == int(ref_ist)
    np.testing.assert_array_equal(np.asarray(tret), np.asarray(ref_tret))
    for name in ("phi", "yy", "yp", "tn", "hh", "nst", "nre", "nni", "ncfn",
                 "netf", "kused", "psi"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st, name)), np.asarray(getattr(ref_st, name)),
            err_msg=name,
        )


def test_budgeted_resume_vmapped_heterogeneous():
    """Lanes finish at different attempt counts; frozen lanes must stay
    frozen across resume boundaries."""
    from ida_tpu.models import roberts_factory, ROBERTS_PARAMS
    from ida_tpu.parallel import ensemble_init

    b = 5
    scale = np.linspace(0.5, 2.0, b)
    params = jnp.asarray(np.outer(scale, ROBERTS_PARAMS))
    yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0), (b, 1))
    yp0 = params[:, 0:1] * jnp.asarray([-1.0, 1.0, 0.0])
    tol = tol_sv(1e-4, jnp.array([1e-8, 1e-6, 1e-6]))
    opts = IdaOptions()
    states = ensemble_init(roberts_factory, params, yy0, yp0)
    tout = jnp.asarray(0.4)

    def one_ref(s, p):
        return core_solve(s, roberts_factory(p), opts, tol, tout)

    rs, rtret, rist = jax.jit(jax.vmap(one_ref))(states, params)

    def one_first(s, p):
        return core_solve(s, roberts_factory(p), opts, tol, tout, max_attempts=5)

    def one_again(s, p, carry):
        return core_solve(s, roberts_factory(p), opts, tol, tout,
                          max_attempts=5, resume_carry=carry)

    st, tret, ist, carry = jax.jit(jax.vmap(one_first))(states, params)
    while (np.asarray(ist) == C.CONTINUE).any():
        st, tret, ist, carry = jax.jit(jax.vmap(one_again))(st, params, carry)

    np.testing.assert_array_equal(np.asarray(ist), np.asarray(rist))
    np.testing.assert_array_equal(np.asarray(tret), np.asarray(rtret))
    np.testing.assert_array_equal(np.asarray(st.yy), np.asarray(rs.yy))
    np.testing.assert_array_equal(np.asarray(st.nst), np.asarray(rs.nst))
    np.testing.assert_array_equal(np.asarray(st.nni), np.asarray(rs.nni))


def test_budgeted_resume_with_roots():
    """max_attempts + resume across a root crossing: the ROOT_RETURN arrives
    at the same t as the unbudgeted path, bit-identically."""
    from ida_tpu.models import roberts_problem

    prob = roberts_problem(with_roots=True)
    tol = tol_sv(1e-4, jnp.array([1e-8, 1e-6, 1e-6]))
    opts = IdaOptions()
    st0 = init_state(prob, ROBERTS_YY0, ROBERTS_YP0, opts=opts)
    tout = jnp.asarray(4.0)

    ref_st, ref_tret, ref_ist = jax.jit(
        lambda s: core_solve(s, prob, opts, tol, tout)
    )(st0)
    assert int(ref_ist) == C.ROOT_RETURN  # y1 = 1e-4 crossing in decade 2

    first = jax.jit(lambda s: core_solve(s, prob, opts, tol, tout, max_attempts=5))
    again = jax.jit(
        lambda s, carry: core_solve(
            s, prob, opts, tol, tout, max_attempts=5, resume_carry=carry
        )
    )
    st, tret, ist, carry = first(st0)
    while int(ist) == C.CONTINUE:
        st, tret, ist, carry = again(st, carry)

    assert int(ist) == C.ROOT_RETURN
    np.testing.assert_array_equal(np.asarray(tret), np.asarray(ref_tret))
    np.testing.assert_array_equal(np.asarray(st.iroots), np.asarray(ref_st.iroots))
    np.testing.assert_array_equal(np.asarray(st.yy), np.asarray(ref_st.yy))
    np.testing.assert_array_equal(np.asarray(st.nge), np.asarray(ref_st.nge))


def test_budgeted_one_step_mode():
    """TASK_ONE_STEP under a budget: each resume sequence returns after one
    internal step, same as unbudgeted."""
    from ida_tpu.core.solve import TASK_ONE_STEP

    prob, tol, opts, st0 = _setup()
    tout = jnp.asarray(4.0)

    ref = jax.jit(lambda s: core_solve(s, prob, opts, tol, tout, TASK_ONE_STEP))
    r_st, r_tret, r_ist = ref(st0)
    assert int(r_ist) == C.SUCCESS and int(r_st.nst) == 1

    first = jax.jit(
        lambda s: core_solve(s, prob, opts, tol, tout, TASK_ONE_STEP, max_attempts=2)
    )
    again = jax.jit(
        lambda s, carry: core_solve(
            s, prob, opts, tol, tout, TASK_ONE_STEP, max_attempts=2,
            resume_carry=carry,
        )
    )
    st, tret, ist, carry = first(st0)
    while int(ist) == C.CONTINUE:
        st, tret, ist, carry = again(st, carry)
    assert int(ist) == C.SUCCESS
    assert int(st.nst) == 1
    np.testing.assert_array_equal(np.asarray(tret), np.asarray(r_tret))
    np.testing.assert_array_equal(np.asarray(st.yy), np.asarray(r_st.yy))
