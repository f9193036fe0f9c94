"""2-D heat equation DAE on the unit square (SUNDIALS ``idaHeat2D``).

    u_t = u_xx + u_yy  on the interior of an M x M grid,
    u   = 0            on the boundary (algebraic identity equations),

initial profile u = 16 x (1-x) y (1-y). The reference does not ship this
problem; it is BASELINE.md config 4 ("idaHeat2D-style 100x100 grid DAE").

Design: the state is the flattened grid; the residual computes the
5-point Laplacian with shifted slices on the [M, M] view — pure elementwise work
that XLA fuses, and the natural demo for the SPGMR matrix-free path (the
dense Jacobian would be 1e8 entries at M=100). The diagonal preconditioner
mirrors C ``idaHeat2D_kry``'s PsetupHeat/PsolveHeat.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..problem import IdaProblem


def heat2d_problem(m: int = 10, use_prec: bool = True) -> IdaProblem:
    n = m * m
    dx = 1.0 / (m - 1)
    coeff = 1.0 / (dx * dx)

    interior = np.zeros((m, m), bool)
    interior[1:-1, 1:-1] = True
    interior_flat = jnp.asarray(interior.reshape(-1))

    def laplacian(u):
        # batch-native aware: u may be [N, *batch]; the grid view keeps the
        # trailing batch axes and the stencil rolls stay on axes 0/1
        u2 = u.reshape((m, m) + u.shape[1:])
        lap = (
            jnp.roll(u2, 1, 0) + jnp.roll(u2, -1, 0)
            + jnp.roll(u2, 1, 1) + jnp.roll(u2, -1, 1)
            - 4.0 * u2
        ) * coeff
        return lap.reshape(u.shape)

    def _mask(bnd):
        return interior_flat.reshape((n,) + (1,) * bnd)

    def res(t, yy, yp):
        # interior: u' - lap(u); boundary: u (algebraic, pins u=0)
        return jnp.where(_mask(yy.ndim - 1), yp - laplacian(yy), yy)

    # diagonal preconditioner (C idaHeat2D_kry PsetupHeat):
    # interior J_ii = cj + 4/dx^2 ; boundary J_ii = 1
    def prec_setup(t, cj, yy, yp, rr):
        diag = jnp.where(_mask(yy.ndim - 1), cj + 4.0 * coeff, 1.0)
        return (1.0 / diag,)

    def prec_solve(pdata, r, cj):
        return pdata[0] * r

    def prec_zero():
        return (jnp.zeros(n, jnp.float64),)

    kwargs = {}
    if use_prec:
        kwargs = dict(prec_setup=prec_setup, prec_solve=prec_solve, prec_zero=prec_zero)

    return IdaProblem(n=n, res=res, id=interior_flat, **kwargs)


def heat2d_ic(m: int = 10):
    """Consistent initial profile (C SetInitialProfile): u0 = 16x(1-x)y(1-y),
    up0 = lap(u0) in the interior, 0 on the boundary."""
    x = np.linspace(0.0, 1.0, m)
    xx, yy_ = np.meshgrid(x, x, indexing="ij")
    u0 = 16.0 * xx * (1.0 - xx) * yy_ * (1.0 - yy_)
    dx = 1.0 / (m - 1)
    lap = np.zeros_like(u0)
    lap[1:-1, 1:-1] = (
        u0[:-2, 1:-1] + u0[2:, 1:-1] + u0[1:-1, :-2] + u0[1:-1, 2:] - 4 * u0[1:-1, 1:-1]
    ) / dx**2
    up0 = lap
    up0[0, :] = up0[-1, :] = up0[:, 0] = up0[:, -1] = 0.0
    u0[0, :] = u0[-1, :] = u0[:, 0] = u0[:, -1] = 0.0
    return u0.reshape(-1), up0.reshape(-1)
