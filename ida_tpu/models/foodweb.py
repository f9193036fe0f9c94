"""Food-web reaction-diffusion DAE (SUNDIALS ``idaFoodWeb_kry`` structure).

``ns`` species (np prey + np predators) on an MX x MY grid:

  prey     s:  dc_s/dt = d_s * lap(c_s) + R_s(x, y, c)      (differential)
  predator s:  0       = d_s * lap(c_s) + R_s(x, y, c)      (algebraic)

with rates R_s = c_s * ( b_s(x,y) + sum_j a_sj c_j ), interaction matrix
a = [[-AA, -GG], [EE, -AA]] (np = 1), b = (+-BB) * (1 + ALPHA x y), and
reflective (Neumann) boundaries. Predators being purely algebraic makes
this a genuine index-1 DAE; it is BASELINE.md config 5.

The reference has no such problem (nor any Krylov path); constants follow
the C example's structure (values documented here, not golden-matched).

Preconditioner: block-diagonal over grid points — at each point the
ns x ns reaction Jacobian plus cj on differential rows, LU-factored with
the batched dense kernel (a [npts, ns, ns] vmapped factorization, exactly
the "batched small-LU" shape the ensemble path is built for).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.dense_lu import lu_factor_unrolled as lu_factor, lu_solve_unrolled as lu_solve
from ..ops.dense_lu import DenseLU
from ..problem import IdaProblem

# float32 contractions must not drop to TF32 on GPUs (about three decimal
# digits): every einsum here asks for full precision
HIGHEST = jax.lax.Precision.HIGHEST

AA = 1.0
EE = 1.0e4
GG = 0.5e-6
BB = 1.0
DPREY = 1.0
DPRED = 0.05
ALPHA = 50.0


def foodweb_problem(mx: int = 20, my: int = 20, use_prec: bool = True) -> IdaProblem:
    ns = 2  # 1 prey + 1 predator
    npts = mx * my
    n = ns * npts
    dx = 1.0 / (mx - 1)
    dy = 1.0 / (my - 1)

    acoef = jnp.asarray([[-AA, -GG], [EE, -AA]])
    x = np.linspace(0.0, 1.0, mx)
    y = np.linspace(0.0, 1.0, my)
    xx, yy_ = np.meshgrid(x, y, indexing="ij")
    fac = jnp.asarray(1.0 + ALPHA * xx * yy_)  # [mx, my]
    bcoef = jnp.stack([BB * fac, -BB * fac], axis=-1)  # [mx, my, ns]
    diff = jnp.asarray([DPREY, DPRED])

    # differential mask: prey rows only
    id_np = np.zeros((mx, my, ns), bool)
    id_np[:, :, 0] = True
    id_mask = jnp.asarray(id_np.reshape(-1))

    def _lap_neumann(c):
        # reflective boundaries: outward neighbor = inward neighbor
        up = jnp.concatenate([c[1:2], c[:-1]], axis=0)
        dn = jnp.concatenate([c[1:], c[-2:-1]], axis=0)
        lf = jnp.concatenate([c[:, 1:2], c[:, :-1]], axis=1)
        rt = jnp.concatenate([c[:, 1:], c[:, -2:-1]], axis=1)
        return (up + dn - 2.0 * c) / (dx * dx) + (lf + rt - 2.0 * c) / (dy * dy)

    def rhs(c3, bnd):
        """d * lap(c) + R(c) on the [mx, my, ns, *batch] view.

        The captured constant arrays are cast to the STATE dtype: without
        this, f32 inputs silently promote to f64 through the f64 constants,
        which ran the whole jtimes jvp — the dominant Krylov cost — in
        f64 even under ls_precision="single" (on an earlier accelerator
        with emulated f64, the foodweb mixed leg gained only 1.05x vs
        heat2d's 4.29x until this was fixed)."""
        dt = c3.dtype
        lap = jnp.stack([_lap_neumann(c3[:, :, s]) for s in range(ns)], axis=2)
        # rates_t = b_t + sum_s a_ts c_s (trailing batch rides the ellipsis)
        rates = bcoef.astype(dt).reshape((mx, my, ns) + (1,) * bnd) + jnp.einsum(
            "xys...,ts->xyt...", c3, acoef.astype(dt), precision=HIGHEST
        )
        return diff.astype(dt).reshape((1, 1, ns) + (1,) * bnd) * lap + c3 * rates

    def res(t, yyv, ypv):
        # batch-native aware: yyv may be [n, *batch]
        lane = yyv.shape[1:]
        bnd = len(lane)
        c3 = yyv.reshape((mx, my, ns) + lane)
        cp3 = ypv.reshape((mx, my, ns) + lane)
        f = rhs(c3, bnd)
        mask = jnp.asarray(id_np).reshape((mx, my, ns) + (1,) * bnd)
        r = jnp.where(mask, cp3 - f, -f)
        return r.reshape(yyv.shape)

    # ---- block-diagonal preconditioner (C Precondbd/PSolvebd) ----
    def prec_setup(t, cj, yyv, ypv, rr):
        # per grid point: block = cj*I_diff - (diag(rate) + c outer a),
        # built elementwise so trailing batch axes ride along; the batched
        # small-LU factors with the trailing-batch-aware unrolled kernel
        lane = yyv.shape[1:]
        bnd = len(lane)
        c_pts = yyv.reshape((npts, ns) + lane)
        b_pts = bcoef.reshape((npts, ns) + (1,) * bnd)
        rate = b_pts + jnp.einsum(
            "ts,ps...->pt...", acoef, c_pts, precision=HIGHEST
        )
        eye = jnp.eye(ns).reshape((1, ns, ns) + (1,) * bnd)
        a_b = acoef.reshape((1, ns, ns) + (1,) * bnd)
        jac_r = eye * rate[:, :, None] + c_pts[:, :, None] * a_b
        isd = jnp.diag(jnp.asarray([1.0, 0.0])).reshape(
            (1, ns, ns) + (1,) * bnd
        )
        blocks = cj * isd - jac_r
        f = jax.vmap(lu_factor)(blocks)
        return (f.lu, f.piv)

    def prec_solve(pdata, r, cj):
        lu, piv = pdata
        rb = r.reshape((npts, ns) + r.shape[1:])
        z = jax.vmap(
            lambda l, p, b: lu_solve(DenseLU(l, p, jnp.zeros((), jnp.int32)), b)
        )(lu, piv, rb)
        return z.reshape(r.shape)

    def prec_zero():
        return (
            jnp.zeros((npts, ns, ns), jnp.float64),
            jnp.zeros((npts, ns), jnp.int32),
        )

    kwargs = {}
    if use_prec:
        kwargs = dict(prec_setup=prec_setup, prec_solve=prec_solve, prec_zero=prec_zero)

    return IdaProblem(n=n, res=res, id=id_mask, **kwargs)


def foodweb_ic(mx: int = 20, my: int = 20):
    """C SetInitialProfiles: prey = 10 + (16x(1-x)y(1-y))^2, predator = 1e5.
    Predator values are a guess to be corrected by calc_ic('ya_ydp')."""
    x = np.linspace(0.0, 1.0, mx)
    y = np.linspace(0.0, 1.0, my)
    xx, yy_ = np.meshgrid(x, y, indexing="ij")
    prey = 10.0 + (16.0 * xx * (1 - xx) * yy_ * (1 - yy_)) ** 2
    pred = np.full_like(prey, 1.0e5)
    c0 = np.stack([prey, pred], axis=-1).reshape(-1)
    cp0 = np.zeros_like(c0)
    return c0, cp0
