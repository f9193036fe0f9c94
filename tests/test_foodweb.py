"""Food-web reaction-diffusion DAE (BASELINE.md config 5): SPGMR with the
block-diagonal preconditioner + calc_ic for the algebraic predators."""

import numpy as np

from ida_tpu import IDA, IdaOptions, IdaSolveStatus
from ida_tpu.models import foodweb_problem, foodweb_ic
from ida_tpu.models.foodweb import EE
from ida_tpu.tol_control import tol_ss


def test_foodweb_spgmr():
    mx = my = 8
    prob = foodweb_problem(mx, my)
    c0, cp0 = foodweb_ic(mx, my)
    opts = IdaOptions(
        linear_solver="spgmr", mxstep=5000, krylov_maxl=12, krylov_max_restarts=10
    )
    ida = IDA(prob, c0, cp0, tol_ss(1e-5, 1e-5), options=opts)

    # predators start at a flat 1e5 guess; calc_ic must pull them onto the
    # algebraic manifold c_pred ~= EE*c_prey - fac
    ida.calc_ic("ya_ydp", tout1=1e-3)
    y0, _ = ida.get_consistent_ic()
    c = y0.reshape(mx, my, 2)
    np.testing.assert_allclose(c[..., 1] / (EE * c[..., 0]), 1.0, rtol=1e-3)

    t = 1e-3
    for _ in range(3):
        tret, status = ida.solve(t)
        assert status == IdaSolveStatus.Success
        t *= 4
    cend = ida.get_yy().reshape(mx, my, 2)
    # predators track EE*prey throughout (quasi-steady algebraic relation)
    np.testing.assert_allclose(cend[..., 1] / (EE * cend[..., 0]), 1.0, rtol=1e-2)
    # prey grows from its initial profile on this time horizon
    assert cend[..., 0].mean() > c[..., 0].mean()
    # Krylov + preconditioner actually exercised; no dense Jacobians
    assert ida.get_num_lin_iters() > 0
    assert ida.get_num_prec_solves() > 0
    assert ida.get_num_jac_evals() == 0


def test_contractions_ask_for_full_float32_precision():
    """Every dot_general of the foodweb residual and preconditioner setup
    carries Precision.HIGHEST, so a float32 state never contracts in TF32
    (about three decimal digits) on a GPU."""
    import jax
    import jax.numpy as jnp

    mx = my = 4
    prob = foodweb_problem(mx, my)
    c0, cp0 = foodweb_ic(mx, my)
    y = jnp.asarray(c0, jnp.float32)
    yp = jnp.asarray(cp0, jnp.float32)
    t, cj = jnp.float32(0.0), jnp.float32(1e3)

    def dots(jaxpr):
        # dot_generals at every nesting level (jnp.einsum wraps its own jit)
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        yield from dots(sub)

    for fn, args in ((prob.res, (t, y, yp)),
                     (prob.prec_setup, (t, cj, y, yp, y))):
        found = list(dots(jax.make_jaxpr(fn)(*args).jaxpr))
        assert found, fn
        for eqn in found:
            prec = eqn.params["precision"]
            assert prec is not None, eqn
            assert all(p == jax.lax.Precision.HIGHEST for p in prec), prec
