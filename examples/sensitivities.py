"""Sensitivity-analysis tour on Roberts kinetics: forward dy/dp (one
jax.jvp), adjoint dL/dp (one jax.grad, the IDAS/IDAA role), and the
gradient of an integral loss via quadratures — capabilities C IDA needs
the separate IDAS package for, and which the reference (SURVEY.md §2.3)
lists as absent.

Run: PYTHONPATH=. python examples/sensitivities.py
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from ida_tpu.core.quad import get_quad
from ida_tpu.models import roberts_factory, ROBERTS_PARAMS, ROBERTS_YY0
from ida_tpu.sensitivity import (
    adjoint_gradient,
    batched_adjoint_gradient,
    forward_sensitivity,
)
from ida_tpu.tol_control import tol_sv

TOL = tol_sv(1e-4, jnp.array([1e-8, 1e-6, 1e-6]))
P0 = jnp.asarray(ROBERTS_PARAMS)
YY0_OF = lambda p: jnp.asarray(ROBERTS_YY0)  # noqa: E731
YP0_OF = lambda p: p[0] * jnp.asarray([-1.0, 1.0, 0.0])  # noqa: E731
TOUT = 4.0


def main():
    # --- forward: dy(tout)/dk1 from one jvp -----------------------------
    y, dy_dk1 = forward_sensitivity(
        roberts_factory, P0, YY0_OF, YP0_OF, TOL, TOUT,
        jnp.asarray([1.0, 0.0, 0.0]),
    )
    print(f"y(t={TOUT})          = {np.asarray(y)}")
    print(f"dy/dk1 (forward jvp) = {np.asarray(dy_dk1)}")

    # --- adjoint: d loss(y(tout)) / dp for ALL p from one backward pass -
    w = jnp.asarray([1.0, 2.0, 3.0])
    val, grad, istate = adjoint_gradient(
        roberts_factory, P0, YY0_OF, YP0_OF, TOL, TOUT,
        lambda y: jnp.sum(y * w), max_attempts=120,
    )
    assert int(istate) == 0
    print(f"loss sum(w*y)        = {float(val):.12f}")
    print(f"dL/dp (adjoint grad) = {np.asarray(grad)}")

    # --- adjoint of an INTEGRAL loss via quadratures --------------------
    # L = ∫_0^T y3 dt, accumulated by the solver's quadrature machinery
    factory_q = lambda p: dataclasses.replace(  # noqa: E731
        roberts_factory(p),
        quad=lambda t, yy, yp: jnp.stack([yy[2]]),
        nquad=1,
    )
    val_q, grad_q, istate_q = adjoint_gradient(
        factory_q, P0, YY0_OF, YP0_OF, TOL, TOUT, None, max_attempts=120,
        loss_of_state=lambda st, tret, prob: get_quad(st, prob, tret)[0],
    )
    assert int(istate_q) == 0
    print(f"∫ y3 dt              = {float(val_q):.12f}")
    print(f"d(∫ y3 dt)/dp        = {np.asarray(grad_q)}")

    # --- adjoint THROUGH IDACalcIC (implicit differentiation) -----------
    # start from an inconsistent guess; calc_ic fixes it, and the gradient
    # flows through the IC solve via the implicit function theorem
    # (sensitivity.make_consistent_ic — the IDAS IDASensCalcIC role)
    val_ic, grad_ic, istate_ic = adjoint_gradient(
        roberts_factory, P0,
        lambda p: jnp.asarray([1.0, 0.0, 0.3]),  # y3 violates sum = 1
        lambda p: jnp.zeros(3),
        TOL, TOUT, lambda y: jnp.sum(y * w), max_attempts=120,
        ic=("ya_ydp", 0.4),
    )
    assert int(istate_ic) == 0
    print(f"loss (via calc_ic)   = {float(val_ic):.12f}")
    print(f"dL/dp (thru calc_ic) = {np.asarray(grad_ic)}")

    # --- batched adjoint: per-lane gradients for a parameter ensemble ---
    pB = jnp.asarray([0.9, 1.0, 1.1])[:, None] * P0[None, :]
    vals, grads, istates = batched_adjoint_gradient(
        roberts_factory, pB, YY0_OF, YP0_OF, TOL, TOUT,
        lambda y: jnp.sum(y * w), max_attempts=120,
    )
    assert np.all(np.asarray(istates) == 0)
    for b in range(3):
        print(f"lane {b}: loss={float(vals[b]):.9f}  dL/dp={np.asarray(grads[b])}")


if __name__ == "__main__":
    main()
