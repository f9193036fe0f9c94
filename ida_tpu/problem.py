"""Problem-definition API (L5 layer).

Behavioural spec: reference ``src/traits.rs`` — traits ``ModelSpec`` /
``Residual`` / ``Jacobian`` / ``Root`` with the blanket ``IdaProblem``
(reference src/traits.rs:92-94). Rust static dispatch becomes plain Python
callables captured at trace time; everything the solver calls is pure and
traceable.

The DAE is ``F(t, y, y') = 0``. The system Jacobian used by the Newton/linear
layer is ``J = dF/dy + cj * dF/dy'`` (reference src/traits.rs:50).

Unlike the reference, an analytic Jacobian is OPTIONAL: because the Newton
iterate is ``y = yypredict + e``, ``y' = yppredict + cj*e``, the system
Jacobian is exactly the Jacobian of the residual w.r.t. the correction ``e``,
which we obtain with one ``jax.jacfwd`` (this subsumes the reference's
missing DQ-Jacobian path, reference src/ida_ls.rs:136-152).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

ResFn = Callable[[jax.Array, jax.Array, jax.Array], jax.Array]  # (t, yy, yp) -> r [N]
JacFn = Callable[
    [jax.Array, jax.Array, jax.Array, jax.Array, jax.Array], jax.Array
]  # (t, cj, yy, yp, rr) -> J [N, N]
RootFn = Callable[[jax.Array, jax.Array, jax.Array], jax.Array]  # (t, yy, yp) -> g [nroots]


@dataclasses.dataclass(frozen=True)
class IdaProblem:
    """A DAE problem ``F(t, y, y') = 0``.

    Attributes:
      n: state dimension N (static).
      res: residual function ``(t, yy, yp) -> F`` of shape [N].
      jac: optional analytic system Jacobian ``(t, cj, yy, yp, rr) -> J``
        with ``J = dF/dy + cj*dF/dy'`` of shape [N, N]. When None, the
        Jacobian is computed by forward-mode AD of ``res``.
      root: optional root (event) function ``(t, yy, yp) -> g`` of shape
        [nroots]; roots of each component are located during integration.
      nroots: number of root functions (static; must match ``root`` output).
      id: optional bool [N] marking differential (True) vs algebraic (False)
        variables; used by ``suppressalg`` local error tests and IDACalcIC.
    """

    n: int
    res: ResFn
    jac: Optional[JacFn] = None
    root: Optional[RootFn] = None
    nroots: int = 0
    id: Optional[jax.Array] = None
    # Krylov-path preconditioner hooks (C IDASetPreconditioner; the
    # reference stubs these out entirely, src/ida_ls.rs:168-180):
    #   prec_setup(t, cj, yy, yp, rr) -> pdata pytree (factored P)
    #   prec_solve(pdata, r, cj)      -> z approx P^{-1} r
    #   prec_zero()                   -> zero pdata pytree (for state init)
    prec_setup: Optional[Callable] = None
    prec_solve: Optional[Callable] = None
    prec_zero: Optional[Callable] = None
    # Custom Jacobian-times-vector hooks (C IDASetJacTimes; counted by
    # njtsetup/njtimes like reference ida_ls.rs:44-59 tracks them):
    #   jtimes_setup(t, cj, yy, yp, rr) -> jdata pytree (may be ())
    #   jtimes_fn(jdata, t, cj, yy, yp, v) -> J v
    # When absent, Jv comes from one jvp of the residual (matrix-free).
    jtimes_setup: Optional[Callable] = None
    jtimes_fn: Optional[Callable] = None
    # Quadrature integration along the solution (the IDAS quadrature role —
    # yQ' = q(t, y, y'), integrated WITHOUT entering the Newton system or
    # the error test, like IDAS with errconQ=SUNFALSE; absent from the
    # reference and from plain C IDA):
    #   quad(t, yy, yp) -> [nquad] quadrature right-hand side
    quad: Optional[Callable] = None
    nquad: int = 0

    def __post_init__(self):
        if self.root is None and self.nroots:
            raise ValueError("nroots > 0 requires a root function")
        if self.quad is None and self.nquad:
            raise ValueError("nquad > 0 requires a quad function")
        if self.prec_setup is not None and (
            self.prec_solve is None or self.prec_zero is None
        ):
            raise ValueError("prec_setup requires prec_solve and prec_zero")
        if self.jtimes_setup is not None and self.jtimes_fn is None:
            raise ValueError("jtimes_setup requires jtimes_fn")

    def jtimes(
        self,
        t: jax.Array,
        cj: jax.Array,
        yy: jax.Array,
        yp: jax.Array,
        v: jax.Array,
        jdata=None,
    ) -> jax.Array:
        """Matrix-free J v = (dF/dy) v + cj (dF/dy') v via one jvp — the
        matrix-free replacement for the reference's absent DQ jtimes
        (src/ida_ls.rs:136-152) — or the user ``jtimes_fn`` when provided."""
        if self.jtimes_fn is not None:
            return self.jtimes_fn(jdata, t, cj, yy, yp, v)
        return jax.jvp(lambda y, ydot: self.res(t, y, ydot), (yy, yp), (v, cj * v))[1]

    def sys_jacobian(
        self, t: jax.Array, cj: jax.Array, yy: jax.Array, yp: jax.Array, rr: jax.Array
    ) -> jax.Array:
        """System Jacobian ``J = dF/dy + cj*dF/dy'`` at (t, yy, yp).

        Uses the analytic ``jac`` when provided (reference calls the user
        ``Jacobian`` trait at src/ida_ls.rs:260-267 — note we pass the true
        ``t`` rather than replicating the reference's `tt = 0` bug, documented
        in SURVEY.md §2.4), otherwise one jacfwd of the correction map.
        """
        if self.jac is not None:
            return self.jac(t, cj, yy, yp, rr)

        def f_of_e(e):
            return self.res(t, yy + e, yp + cj * e)

        return jax.jacfwd(f_of_e)(jnp.zeros_like(yy))
