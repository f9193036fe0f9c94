"""Parameter estimation by gradient descent THROUGH the DAE solver.

Recovers the Roberts reaction-rate constant k1 from trajectory
observations, using `sensitivity.continuous_adjoint` (the IDAS
adjoint-module machinery: checkpointed forward solve, backward adjoint
DAE, gradient via backward quadratures) to get d(loss)/d(log k1) at
~2-solves cost per observation time, and optax.adam as the optimizer.

The loss is a sum over observation times t_i of |y1(t_i; p) - d_i|^2 —
each term is a terminal loss for one adjoint solve, and one vmapped
program computes ALL of them (forward + backward + gradient) per
optimizer step.

Run:  PYTHONPATH=. python examples/fit_kinetics.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ida_tpu.core.state import IdaOptions
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu.sensitivity import continuous_adjoint, solve_with_params
from ida_tpu.tol_control import tol_sv

TOL = tol_sv(1e-8, jnp.asarray([1e-10, 1e-12, 1e-10]))
OPTS = IdaOptions(mxstep=20000)
T_OBS = np.asarray([0.4, 1.0, 2.0, 4.0])
K1_TRUE = ROBERTS_PARAMS[0]  # 0.04


def factory_of_logk1(logk1):
    return roberts_factory(
        jnp.stack([jnp.exp(logk1), ROBERTS_PARAMS[1], ROBERTS_PARAMS[2]])
    )


def yp0_of(logk1):
    return jnp.exp(logk1) * jnp.asarray([-1.0, 1.0, 0.0])


def make_loss_and_grad(data):
    yy0 = jnp.asarray(ROBERTS_YY0)

    def one(logk1, ti, di):
        grid = jnp.linspace(0.0, ti, 65)[1:]
        loss, gp, _gy0, istf, istb = continuous_adjoint(
            factory_of_logk1, logk1, yy0, yp0_of(logk1), TOL, ti,
            lambda y: (y[0] - di) ** 2, grid=grid, opts=OPTS,
        )
        return loss, gp, istf + istb

    @jax.jit
    def loss_and_grad(logk1):
        losses, grads, ists = jax.vmap(one, in_axes=(None, 0, 0))(
            logk1, jnp.asarray(T_OBS), data
        )
        return jnp.sum(losses), jnp.sum(grads), jnp.max(jnp.abs(ists))

    return loss_and_grad


def main() -> int:
    # synthetic observations from the true parameters
    data = jnp.asarray([float(_solve_y1(t)) for t in T_OBS])

    loss_and_grad = make_loss_and_grad(data)
    logk1 = jnp.asarray(np.log(K1_TRUE * 2.0))  # start 2x off
    n_iters = 30
    # decay the step so adam settles instead of orbiting the optimum
    opt = optax.adam(optax.exponential_decay(0.2, 10, 0.5))
    opt_state = opt.init(logk1)

    print(f"fitting k1 (true {K1_TRUE:g}) from y1 at t = {T_OBS.tolist()}")
    print(f"{'iter':>4} {'k1':>12} {'loss':>12}")
    for it in range(n_iters):
        loss, grad, bad = loss_and_grad(logk1)
        assert int(bad) == 0, "a solve failed during fitting"
        updates, opt_state = opt.update(grad, opt_state)
        logk1 = optax.apply_updates(logk1, updates)
        if it % 10 == 0 or it == n_iters - 1:
            print(f"{it:>4} {float(jnp.exp(logk1)):12.6g} {float(loss):12.4e}")

    # polish: 1-D secant iteration on the gradient root (the adjoint
    # gradient is exact enough that this converges quadratically-ish)
    x0 = logk1 - 0.02
    g0 = loss_and_grad(x0)[1]
    x1 = logk1
    for it in range(6):
        loss, g1, bad = loss_and_grad(x1)
        assert int(bad) == 0, "a solve failed during polish"
        if float(jnp.abs(g1)) < 1e-14 or float(jnp.abs(g1 - g0)) == 0.0:
            break
        x0, g0, x1 = x1, g1, x1 - g1 * (x1 - x0) / (g1 - g0)
        print(f"  secant {it}: k1={float(jnp.exp(x1)):.8g} loss={float(loss):.4e}")
    logk1 = x1

    k1 = float(jnp.exp(logk1))
    err = abs(k1 - K1_TRUE) / K1_TRUE
    print(f"recovered k1 = {k1:.6g}  (relative error {err:.2e})")
    ok = err < 1e-3
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


def _solve_y1(t):
    """y1(t) at the true parameters (observation generator)."""
    f = solve_with_params(
        lambda p: roberts_factory(p), jnp.asarray(ROBERTS_PARAMS),
        lambda p: jnp.asarray(ROBERTS_YY0),
        lambda p: p[0:1] * jnp.asarray([-1.0, 1.0, 0.0]),
        TOL, t, opts=OPTS,
    )
    return f(jnp.asarray(ROBERTS_PARAMS))[0]


if __name__ == "__main__":
    raise SystemExit(main())
