"""Robertson chemical kinetics: the canonical stiff 3-equation DAE.

Behavioural spec: reference ``src/sample_problems/roberts.rs:36-114``
(itself SUNDIALS ``idaRoberts_dns``):

    dy1/dt = -.04*y1 + 1e4*y2*y3
    dy2/dt =  .04*y1 - 1e4*y2*y3 - 3e7*y2^2
    0      =  y1 + y2 + y3 - 1

on t in [0, 4e10], y0 = [1, 0, 0]. Roots tracked at y1 = 1e-4 and y3 = 0.01.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..problem import IdaProblem

ROBERTS_YY0 = np.array([1.0, 0.0, 0.0])
ROBERTS_YP0 = np.array([-0.04, 0.04, 0.0])


def _res(t, yy, yp):
    # (reference src/sample_problems/roberts.rs:47-62)
    r0 = -0.04 * yy[0] + 1.0e4 * yy[1] * yy[2]
    r1 = -r0 - 3.0e7 * yy[1] * yy[1] - yp[1]
    return jnp.stack([r0 - yp[0], r1, yy[0] + yy[1] + yy[2] - 1.0])


def _jac(t, cj, yy, yp, rr):
    # analytic J = dF/dy + cj*dF/dy' (reference roberts.rs:66-91)
    return jnp.array(
        [
            [-0.04 - cj, 1.0e4 * yy[2], 1.0e4 * yy[1]],
            [0.04, -1.0e4 * yy[2] - 6.0e7 * yy[1] - cj, -1.0e4 * yy[1]],
            [1.0, 1.0, 1.0],
        ]
    )


def _root(t, yy, yp):
    # (reference roberts.rs:100-113)
    return jnp.stack([yy[0] - 0.0001, yy[2] - 0.01])


def roberts_factory(params, with_roots: bool = False) -> IdaProblem:
    """Parameterized Roberts for ensemble sweeps: ``params = [k1, k2, k3]``
    (nominal [0.04, 1e4, 3e7]). The residual closes over the (traced) params,
    so under vmap each lane integrates its own chemistry."""
    k1, k2, k3 = params[0], params[1], params[2]

    def res(t, yy, yp):
        r0 = -k1 * yy[0] + k2 * yy[1] * yy[2]
        r1 = -r0 - k3 * yy[1] * yy[1] - yp[1]
        return jnp.stack([r0 - yp[0], r1, yy[0] + yy[1] + yy[2] - 1.0])

    def jac(t, cj, yy, yp, rr):
        # rows built from traced values only (no literal sub-arrays)
        row0 = jnp.stack([-k1 - cj, k2 * yy[2], k2 * yy[1]])
        row1 = jnp.stack([k1, -k2 * yy[2] - 2.0 * k3 * yy[1] - cj, -k2 * yy[1]])
        row2 = jnp.ones_like(yy)
        return jnp.stack([row0, row1, row2])

    return IdaProblem(
        n=3,
        res=res,
        jac=jac,
        root=_root if with_roots else None,
        nroots=2 if with_roots else 0,
        id=jnp.array([True, True, False]),
    )


ROBERTS_PARAMS = np.array([0.04, 1.0e4, 3.0e7])


def roberts_problem(analytic_jac: bool = True, with_roots: bool = True) -> IdaProblem:
    return IdaProblem(
        n=3,
        res=_res,
        jac=_jac if analytic_jac else None,
        root=_root if with_roots else None,
        nroots=2 if with_roots else 0,
        id=jnp.array([True, True, False]),  # y3 is algebraic
    )
