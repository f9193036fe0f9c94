"""Forward AND adjoint (reverse-mode) sensitivity analysis via AD through
the solver.

The C SUNDIALS family needs a separate package (IDAS) with dedicated
forward-sensitivity and adjoint (backward) equations to compute dy/dp and
dL/dp; the reference implements none of it (SURVEY.md §2.3 lists
quadrature/FSA/adjoint as absent). Here the whole integrator is a pure
traced function, so:

- one ``jax.jvp`` through ``core.solve`` yields FORWARD parameter
  sensitivities of the numerical solution (``forward_sensitivity``) —
  validated against central finite differences to ~1e-7 relative on
  Roberts (tests/test_sensitivity.py);
- one ``jax.grad`` back through every step attempt yields the DISCRETE
  ADJOINT gradient of a scalar loss of the solution
  (``adjoint_gradient``) — the IDAS "IDAA" role, with exact consistency
  to the forward numerics by construction (the discrete adjoint of the
  actual BDF steps taken, not a separately integrated adjoint DAE).
  Validated against central differences (tests/test_adjoint.py);
- ``continuous_adjoint`` implements the other IDAS strategy — the
  ADJOINT DAE integrated backwards from checkpoint-interpolated forward
  data (IDAAdjInit/IDASolveB/IDACalcICB/backward quadratures) — at
  ~2-solve cost and O(checkpoints) memory; see its docstring.

Reverse mode needs two ingredients forward mode does not:

1. A reverse-differentiable loop form: ``lax.while_loop`` has no VJP, so
   the adjoint path runs the budgeted ``max_attempts`` fori/scan form of
   the attempt loop and the unrolled Newton loop
   (``IdaOptions(unroll_newton=True)``).
2. The ``safe_ad()`` trace context (utils/ad_mode.py): the solver's
   self-masked lanes legitimately compute discarded inf/nan garbage whose
   *backward* 0·inf products would poison real gradients; under
   ``safe_ad()`` every such site is guarded primal-preservingly.

Caveat (inherent to differentiating adaptive solvers, not to this
implementation): the derivative is of the NUMERICAL solution including its
step-size/order control, which is piecewise-smooth in the parameters; for
very tight accuracy on dy/dp, tighten rtol/atol as you would for y itself.
Memory: reverse mode stores the loop carry per attempt
(O(max_attempts · state size)); size ``max_attempts`` to the problem.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from .core.solve import solve as core_solve, TASK_NORMAL
from .core.state import IdaOptions, init_state
from .problem import IdaProblem
from .tol_control import TolControl
from .utils.ad_mode import safe_ad

# float32 products must not drop to TF32 on GPUs (about three decimal
# digits) when the caller picks float32
HIGHEST = jax.lax.Precision.HIGHEST


def solve_with_params(
    problem_factory: Callable[[Any], IdaProblem],
    params: Any,
    yy0_of: Callable[[Any], jax.Array],
    yp0_of: Callable[[Any], jax.Array],
    tol: TolControl,
    tout,
    opts: IdaOptions = IdaOptions(),
    dtype=jnp.float64,
):
    """Differentiable map params -> y(tout). Initial conditions may depend
    on the parameters through ``yy0_of``/``yp0_of``."""

    def f(p):
        prob = problem_factory(p)
        st = init_state(prob, yy0_of(p), yp0_of(p), dtype=dtype, opts=opts)
        st, _, _ = core_solve(st, prob, opts, tol, jnp.asarray(tout, dtype), TASK_NORMAL)
        return st.yy

    return f


def make_consistent_ic(
    problem_factory,
    icopt: str,
    tout1,
    tol: TolControl,
    opts: IdaOptions = IdaOptions(),
    dtype=jnp.float64,
    t0=0.0,
):
    """Differentiable consistent-IC computation — the IDAS ``IDASensCalcIC``
    role (sensitivities of the corrected initial conditions), done the JAX
    way: implicit differentiation of the solved IC system.

    Returns ``cic(params, yy0, yp0) -> (yyc, ypc, ok)`` where the primal is
    exactly ``core.calc_ic`` (``icopt`` = "ya_ydp" or "y",
    core/calc_ic.py:61) and the derivative comes from the implicit function
    theorem at its solution: with unknowns ``u`` (algebraic y and
    differential y' for YA_YDP; all of y for Y_INIT) satisfying
    ``G(u, p) = F(t0, yy(u), yp(u)) = 0``,

        du/dp = -(dG/du)^{-1} dG/dp

    — one extra Jacobian factorization instead of unrolling the damped
    Newton/linesearch/h-retry iteration (whose while loops have no VJP, and
    whose iteration count is not differentiable anyway). The tangent
    program is linear, so BOTH ``jax.jvp`` (forward sensitivities) and
    ``jax.grad`` (adjoint through the IC solve) work. ``ok`` is returned as
    a 0/1 float with zero tangent; when the primal IC solve failed
    (ok == 0), the implicit derivative is meaningless.
    """
    from .core.calc_ic import calc_ic as core_calc_ic, IC_YA_YDP_INIT, IC_Y_INIT
    from .ops.dense_lu import lu_factor_auto, lu_solve_auto

    icopt_i = {"ya_ydp": IC_YA_YDP_INIT, "y": IC_Y_INIT}[icopt]

    @jax.custom_jvp
    def cic(p, yy0, yp0):
        prob = problem_factory(p)
        st = init_state(prob, yy0, yp0, dtype=dtype, opts=opts)
        # keep the primal IC solve and the JVP's linearization point at the
        # SAME time: calc_ic solves F(state.tn, ., .) = 0 and cic_jvp
        # linearizes G at t0, so state.tn must be t0
        st = st._replace(tn=jnp.asarray(t0, dtype))
        st2, ok = core_calc_ic(
            st, prob, opts, tol, icopt_i, jnp.asarray(tout1, dtype)
        )
        return st2.yy, st2.yp, ok.astype(dtype)

    @cic.defjvp
    def cic_jvp(primals, tangents):
        p, yy0, yp0 = primals
        pdot, yy0dot, yp0dot = tangents
        yyc, ypc, okf = cic(p, yy0, yp0)
        prob = problem_factory(p)
        tt = jnp.asarray(t0, dtype)
        if icopt_i == IC_YA_YDP_INIT:
            if prob.id is None:
                raise ValueError("ya_ydp requires problem.id")
            dm = prob.id.astype(dtype)  # 1 = differential, 0 = algebraic
            sel_yy = lambda u, a: dm * a + (1.0 - dm) * u  # noqa: E731
            sel_yp = lambda u, b: dm * u + (1.0 - dm) * b  # noqa: E731
            u_star = dm * ypc + (1.0 - dm) * yyc
        else:
            sel_yy = lambda u, a: u  # noqa: E731
            sel_yp = lambda u, b: b  # noqa: E731
            u_star = yyc

        def G(u, p_, a, b):
            return problem_factory(p_).res(tt, sel_yy(u, a), sel_yp(u, b))

        fact = lu_factor_auto(jax.jacfwd(G)(u_star, p, yy0, yp0))
        _, gdot = jax.jvp(
            lambda p_, a, b: G(u_star, p_, a, b),
            (p, yy0, yp0),
            (pdot, yy0dot, yp0dot),
        )
        udot = -lu_solve_auto(fact, gdot)
        if icopt_i == IC_YA_YDP_INIT:
            yycdot = dm * yy0dot + (1.0 - dm) * udot
            ypcdot = dm * udot + (1.0 - dm) * yp0dot
        else:
            yycdot, ypcdot = udot, yp0dot
        return (yyc, ypc, okf), (yycdot, ypcdot, jnp.zeros_like(okf))

    return cic


def _reverse_opts(opts):
    """Force the reverse-differentiable loop forms: lax.while_loop has no
    VJP, so the adjoint path runs the unrolled Newton loop and the
    static-bounded Illinois root loop (arithmetic per lane unchanged)."""
    if opts is None:
        opts = IdaOptions()
    if not (opts.unroll_newton and opts.unroll_roots):
        opts = dataclasses.replace(opts, unroll_newton=True, unroll_roots=True)
    return opts


def adjoint_gradient(
    problem_factory,
    params,
    yy0_of,
    yp0_of,
    tol: TolControl,
    tout,
    loss_of,
    opts: IdaOptions | None = None,
    max_attempts: int = 500,
    dtype=jnp.float64,
    loss_of_state=None,
    ic=None,
):
    """Reverse-mode (discrete-adjoint) gradient of ``loss_of(y(tout))``
    with respect to ``params`` — the IDAS adjoint (IDAA) analogue.

    Returns ``(loss, grad, istate)``. ``istate`` is the solver return code
    (0 = success); the gradient is only meaningful when the solve
    succeeded. ``max_attempts`` bounds the differentiated attempt loop —
    it must cover the whole integration (the canonical Roberts decade-1
    run takes ~80 attempts to t=4e4) or ``istate`` stays CONTINUE.

    ``loss_of_state`` (optional, overrides ``loss_of``) receives
    ``(state, tret, problem)`` and must return a scalar — use this for
    losses on quadrature integrals (``core.quad.get_quad(state, problem,
    tret)``), counters, or anything beyond y(tout).

    ``opts.unroll_newton`` is forced True (the while-form Newton loop has
    no VJP rule). Rootfinding problems (nroots > 0) are supported only
    via the bounded Illinois iteration already used by the solver.

    ``ic`` (optional): ``("ya_ydp" | "y", tout1)`` — first compute
    consistent initial conditions from the (possibly inconsistent)
    ``yy0_of(p)``/``yp0_of(p)`` guesses with ``calc_ic``, differentiating
    THROUGH the IC solve by implicit differentiation
    (``make_consistent_ic``), then integrate. This is how to take
    gradients on problems like the food web whose ICs only exist via
    IDACalcIC.
    """
    opts = _reverse_opts(opts)

    f = _make_loss_fn(
        problem_factory, yy0_of, yp0_of, tol, tout, loss_of, opts,
        max_attempts, dtype, loss_of_state, ic,
    )
    with safe_ad():
        (val, istate), grad = jax.value_and_grad(f, has_aux=True)(params)
    return val, grad, istate


def _make_loss_fn(
    problem_factory, yy0_of, yp0_of, tol, tout, loss_of, opts,
    max_attempts, dtype, loss_of_state, ic,
):
    cic = (
        make_consistent_ic(
            problem_factory, ic[0], ic[1], tol, opts=opts, dtype=dtype
        )
        if ic is not None
        else None
    )

    def f(p):
        prob = problem_factory(p)
        yy0, yp0 = yy0_of(p), yp0_of(p)
        ic_ok = None
        if cic is not None:
            yy0, yp0, ic_ok = cic(p, yy0, yp0)
        st = init_state(prob, yy0, yp0, dtype=dtype, opts=opts)
        out = core_solve(
            st, prob, opts, tol, jnp.asarray(tout, dtype), TASK_NORMAL,
            max_attempts=max_attempts,
        )
        istate = out[2]
        if ic_ok is not None:
            # surface a failed IC solve (its implicit derivative is
            # meaningless) as CONV_FAIL — C IDACalcIC's failure code —
            # instead of silently integrating from the uncorrected guess
            from . import constants as C

            istate = jnp.where(
                ic_ok > 0.0, istate, jnp.asarray(C.CONV_FAIL, istate.dtype)
            )
        if loss_of_state is not None:
            return loss_of_state(out[0], out[1], prob), istate
        return loss_of(out[0].yy), istate

    return f


def batched_adjoint_gradient(
    problem_factory,
    params,
    yy0_of,
    yp0_of,
    tol: TolControl,
    tout,
    loss_of,
    opts: IdaOptions | None = None,
    max_attempts: int = 500,
    dtype=jnp.float64,
    loss_of_state=None,
    ic=None,
):
    """Vmapped ``adjoint_gradient`` over a leading batch axis of ``params``
    — one compiled program computing per-lane losses AND per-lane
    gradients for an ensemble (e.g. multi-start parameter estimation).
    ``yy0_of``/``yp0_of``/``loss_of`` are per-lane maps, applied under
    vmap. Returns ``(vals[B], grads[B, ...], istates[B])``."""
    opts = _reverse_opts(opts)

    f = _make_loss_fn(
        problem_factory, yy0_of, yp0_of, tol, tout, loss_of, opts,
        max_attempts, dtype, loss_of_state, ic,
    )
    with safe_ad():
        (vals, istates), grads = jax.vmap(
            jax.value_and_grad(f, has_aux=True)
        )(params)
    return vals, grads, istates


def adjoint_hvp(
    problem_factory,
    params,
    yy0_of,
    yp0_of,
    tol: TolControl,
    tout,
    loss_of,
    tangent,
    opts: IdaOptions | None = None,
    max_attempts: int = 500,
    dtype=jnp.float64,
    loss_of_state=None,
    ic=None,
):
    """Second-order sensitivity: the Hessian-vector product
    ``(d²L/dp²) · tangent`` of a scalar loss of the solution, by
    forward-over-reverse AD through the solver (jvp of the discrete-adjoint
    gradient). Even IDAS has no second-order machinery; here it is one more
    functional transform over the same traced integrator. Returns
    ``(grad, hvp, istate)`` — the gradient comes for free from the jvp
    primal, and ``istate`` is the solver return code (grad/hvp are only
    meaningful when the solve succeeded). Build the full (small) Hessian
    by mapping over basis tangents."""
    opts = _reverse_opts(opts)

    f = _make_loss_fn(
        problem_factory, yy0_of, yp0_of, tol, tout, loss_of, opts,
        max_attempts, dtype, loss_of_state, ic,
    )

    def gradf(p):
        g, ist = jax.grad(f, has_aux=True)(p)
        # float-cast so the aux rides through jvp (its tangent is zero —
        # istate comes from integer lanes)
        return g, ist.astype(dtype)

    with safe_ad():
        (grad, istf), (hvp, _) = jax.jvp(gradf, (params,), (tangent,))
    return grad, hvp, jnp.asarray(istf, jnp.int32)


# ---------------------------------------------------------------------------
# Continuous adjoint (the IDAS IDAA machinery: IDAAdjInit / IDASolveB /
# IDACalcICB / backward quadratures), accelerator-native form.
# ---------------------------------------------------------------------------


def _hermite_interp(knots_t, knots_y, knots_yp, t):
    """Cubic-Hermite interpolation of the forward solution between
    checkpoints (the role of IDAS's checkpoint interpolation, IDAADJ_HERMITE
    variant). ``knots_y``/``knots_yp``: [K, N]. Returns (y(t), yp(t))."""
    K = knots_t.shape[0]
    i = jnp.clip(jnp.searchsorted(knots_t, t, side="right") - 1, 0, K - 2)
    t0 = jnp.take(knots_t, i)
    t1 = jnp.take(knots_t, i + 1)
    y0 = jnp.take(knots_y, i, axis=0)
    y1 = jnp.take(knots_y, i + 1, axis=0)
    d0 = jnp.take(knots_yp, i, axis=0)
    d1 = jnp.take(knots_yp, i + 1, axis=0)
    h = t1 - t0
    s = (t - t0) / h
    s2, s3 = s * s, s * s * s
    y = (
        (2 * s3 - 3 * s2 + 1) * y0
        + (s3 - 2 * s2 + s) * h * d0
        + (-2 * s3 + 3 * s2) * y1
        + (s3 - s2) * h * d1
    )
    yp = (
        (6 * s2 - 6 * s) / h * y0
        + (3 * s2 - 4 * s + 1) * d0
        + (-6 * s2 + 6 * s) / h * y1
        + (3 * s2 - 2 * s) * d1
    )
    return y, yp


def continuous_adjoint(
    problem_factory,
    params,
    yy0,
    yp0,
    tol: TolControl,
    tout,
    g_of,
    *,
    grid=None,
    opts: IdaOptions | None = None,
    tol_b: TolControl | None = None,
    lamT=None,
    dtype=jnp.float64,
):
    """Continuous-adjoint gradient of ``g_of(y(tout))`` — the IDAS adjoint
    MODULE's approach (IDAAdjInit + IDASolveB + IDACalcICB + backward
    quadratures), as opposed to :func:`adjoint_gradient`'s discrete
    backprop through the solver tape.

    Method (Cao-Li-Petzold adjoint for F(t, y, y', p) = 0):

    1. FORWARD: one :func:`core.solve.solve_dense` pass records
       (t_k, y_k, y'_k) checkpoints on ``grid``; the trajectory between
       checkpoints is cubic-Hermite interpolated (IDAS's checkpoint +
       interpolation machinery, scripts-free because the record is one
       device array).
    2. TERMINAL CONDITIONS at T: lambda(T) solves the square KKT system

           [ M^T          -J^T diag(m) ] [lambda]   [-g_y^T]
           [ diag(m) J^T   diag(1-m)   ] [ mu   ] = [   0  ]

       with M = dF/dy', J = dF/dy at T and m the algebraic-variable mask
       (zero columns of M). This kills the boundary term g_y s(T) +
       lambda^T M s(T) for every direction s admissible under the
       linearized constraints AND imposes the adjoint's own algebraic
       consistency (J^T lambda)_alg = 0 — the IDACalcICB role, solved
       directly instead of by Newton. For a pure ODE (m = 0) it reduces
       to M^T lambda = -g_y^T. Supply ``lamT`` to override (e.g. for
       losses needing a custom terminal treatment).
    3. BACKWARD: the adjoint DAE  d/dt(M^T lambda) = J^T lambda  is
       integrated from T down to t0 by the SAME solver (negative steps),
       with residual  R = M^T lambda' - J^T lambda  (dM/dt = 0 is assumed
       along trajectories — exact for the dominant linear-in-y' class
       F = M y' + phi(t, y, p) with constant M; pass a problem-specific
       residual via a custom factory otherwise), evaluating J^T/M^T as
       vjps of the residual at the interpolated forward solution. The
       gradient integrand rides the quadrature machinery (core/quad):
       yQ accumulates  integral lambda^T F_p dt  via two more vjps.
    4. GRADIENTS:  dG/dp = integral_{t0}^{T} lambda^T F_p dt   and
       dG/dy0 = -M(t0)^T lambda(t0)  (the gradient w.r.t. the initial
       values; for algebraic components it reports the multiplier of the
       constraint direction, zero in the semi-explicit aligned class).

    Cost: ~2 solves (one forward with dense output, one backward — the
    adjoint is LINEAR in lambda so Newton converges immediately) and
    O(grid) checkpoint memory, vs the discrete adjoint's full reverse
    tape through every attempt. Everything is jnp, so the whole pipeline
    vmaps and jits.

    ``grid``: monotone increasing checkpoint times in (t0, tout], last
    == tout (default: 128 uniform points — use a log-spaced grid for
    multi-decade stiff horizons). Accuracy of dG is limited by the
    checkpoint interpolation (O(grid step^4)) on top of the integration
    tolerances; tighten both together.

    Returns ``(loss, grad_p, grad_y0, ist_fwd, ist_bwd)`` where
    ``ist_fwd``/``ist_bwd`` are 0 on success (gradients are meaningful
    only when both are 0). Reference role: IDAS idas_adjoint; the
    reference rust-ida has none of this (SURVEY §2.3).
    """
    from functools import partial

    from jax.flatten_util import ravel_pytree

    from . import constants as C
    from .core.solve import solve_dense
    from .ops.dense_lu import lu_factor_auto, lu_solve_auto

    opts = opts or IdaOptions()
    tol_b = tol_b or tol
    tdt = jnp.asarray(tout, dtype)
    yy0 = jnp.asarray(yy0, dtype)
    yp0 = jnp.asarray(yp0, dtype)
    prob = problem_factory(params)
    assert prob.nroots == 0, "continuous_adjoint: rootfinding not supported"
    t0 = jnp.asarray(0.0, dtype)
    if grid is None:
        grid = jnp.linspace(0.0, tout, 129)[1:]
    grid = jnp.asarray(grid, dtype)

    p_flat, unravel = ravel_pytree(params)
    n_p = p_flat.size

    # --- 1. forward pass with dense checkpoints ---
    st = init_state(prob, yy0, yp0, dtype=dtype, opts=opts)
    stf, out_tret, out_ist, out_yy, out_yp, _ = solve_dense(
        st, prob, opts, tol, grid
    )
    ist_f = jnp.max(jnp.abs(out_ist))  # 0 iff every row succeeded
    loss = g_of(out_yy[-1])

    knots_t = jnp.concatenate([t0[None], grid])
    knots_y = jnp.concatenate([yy0[None], out_yy], axis=0)
    knots_yp = jnp.concatenate([yp0[None], out_yp], axis=0)
    interp = partial(_hermite_interp, knots_t, knots_y, knots_yp)

    def res_at(t, yy, yp, p_f):
        return problem_factory(unravel(p_f)).res(t, yy, yp)

    # --- 2. terminal conditions ---
    yT, ypT = out_yy[-1], out_yp[-1]
    M_T = jax.jacfwd(lambda v: prob.res(tdt, yT, v))(ypT)
    J_T = jax.jacfwd(lambda v: prob.res(tdt, v, ypT))(yT)
    m_alg = (jnp.max(jnp.abs(M_T), axis=0) == 0.0).astype(dtype)  # zero cols
    g_y = jax.grad(g_of)(yT)
    n = prob.n
    if lamT is None:
        kkt = jnp.block(
            [
                [M_T.T, -J_T.T * m_alg[None, :]],
                [m_alg[:, None] * J_T.T, jnp.diag(1.0 - m_alg)],
            ]
        )
        rhs = jnp.concatenate([-g_y, jnp.zeros((n,), dtype)])
        lam_T = lu_solve_auto(lu_factor_auto(kkt), rhs)[:n]
    else:
        lam_T = jnp.asarray(lamT, dtype)
    # consistent lambda'(T): M^T lam' = J^T lam on differential rows
    # (algebraic rows get 0 — they do not enter the residual)
    rhsd = (1.0 - m_alg) * jnp.matmul(J_T.T, lam_T, precision=HIGHEST)
    lamp_T = lu_solve_auto(
        lu_factor_auto(M_T.T + jnp.diag(m_alg)), rhsd
    ) * (1.0 - m_alg)

    # --- 3. backward problem: R = M^T lam' - J^T lam, quad = F_p^T lam ---
    def resB(t, lam, lamp):
        y_t, yp_t = interp(t)
        _, vjp = jax.vjp(lambda yy, yp: res_at(t, yy, yp, p_flat), y_t, yp_t)
        jty_lam, _ = vjp(lam)  # J^T lam
        _, mty_lamp = vjp(lamp)  # M^T lam'
        return mty_lamp - jty_lam

    def quadB(t, lam, lamp):
        y_t, yp_t = interp(t)
        _, vjp = jax.vjp(lambda pf: res_at(t, y_t, yp_t, pf), p_flat)
        return vjp(lam)[0]  # F_p^T lam

    id_b = 1.0 - m_alg
    prob_b = IdaProblem(
        n=n, res=resB, id=id_b, quad=quadB, nquad=n_p
    )
    opts_b = dataclasses.replace(opts, suppressalg=True)
    st_b = init_state(prob_b, lam_T, lamp_T, dtype=dtype, opts=opts_b)
    st_b = st_b._replace(tn=tdt, tlo=tdt)
    st_b, tret_b, ist_b = core_solve(
        st_b, prob_b, opts_b, tol_b, t0, TASK_NORMAL
    )

    # --- 4. gradients ---
    # yQ integrated T -> t0 holds -(integral_{t0}^{T} lambda^T F_p dt);
    # get_quad trims the part of the last step that overshot past t0
    from .core.quad import get_quad

    grad_p = unravel(-get_quad(st_b, prob_b, tret_b))
    y0_t, yp0_t = yy0, yp0
    M_0 = jax.jacfwd(lambda v: prob.res(t0, y0_t, v))(yp0_t)
    lam_0 = st_b.yy
    grad_y0 = -jnp.matmul(M_0.T, lam_0, precision=HIGHEST)

    return loss, grad_p, grad_y0, ist_f, ist_b



# Measured routing window between the two adjoint strategies, in step
# ATTEMPTS of the forward solve (see docs/user_guide.md §10a for the
# numbers): the discrete adjoint back-propagates through every attempt
# (cost and tape linear in attempts), the continuous adjoint costs ~2
# solves + an O(grid) checkpoint pass regardless of horizon.
#
# Lower edge (speed): on CPU the continuous strategy is already 4.5x
# faster at ~60 attempts; below a few dozen attempts the discrete tape's
# single forward pass wins. The crossover has not been measured on the
# GPU yet.
#
# Upper edge (accuracy): the continuous gradient is limited by the
# cubic-Hermite checkpoint interpolation. Measured on Roberts vs central
# finite differences (round 5): rel err 3e-4 at ~60 attempts, 2e-3 at
# ~120, but 1e-1 at ~260 attempts (t=400, three decades) even with a
# 256-point log-spaced grid — while the discrete adjoint stays FD-exact
# (7e-7). Multi-decade stiff horizons must use the discrete tape (or a
# problem-tuned grid via continuous_adjoint directly).
ADJOINT_CROSSOVER_ATTEMPTS = 48
ADJOINT_CONTINUOUS_MAX_ATTEMPTS = 160


def adjoint_gradient_auto(
    problem_factory,
    params,
    yy0,
    yp0,
    tol: TolControl,
    tout,
    loss_of,
    *,
    opts: IdaOptions | None = None,
    max_attempts: int = 500,
    dtype=jnp.float64,
    grid=None,
    crossover: int = ADJOINT_CROSSOVER_ATTEMPTS,
    continuous_max: int = ADJOINT_CONTINUOUS_MAX_ATTEMPTS,
):
    """Gradient of ``loss_of(y(tout))`` w.r.t. ``params``, routing between
    the DISCRETE adjoint (:func:`adjoint_gradient`) and the CONTINUOUS
    adjoint (:func:`continuous_adjoint`) by expected horizon length.

    Decision rule (measured; see ``ADJOINT_CROSSOVER_ATTEMPTS`` /
    ``ADJOINT_CONTINUOUS_MAX_ATTEMPTS`` for the numbers):

    * continuous — when the problem qualifies (no rootfinding; loss is a
      function of y(tout) only; fixed initial conditions) AND
      ``crossover <= max_attempts <= continuous_max``: ~2-solve cost and
      O(grid) memory, 4.5-25.7x faster than the tape in that window.
    * discrete — short horizons (tape is cheap), LONG multi-decade
      horizons (checkpoint interpolation error dominates the continuous
      gradient there — measured 1e-1 at three decades vs FD-exact
      discrete), or whenever exact consistency with the forward numerics
      / rootfinding / ``loss_of_state`` losses / parameter-dependent ICs
      (``ic=`` / ``yy0_of``) are needed; those call
      :func:`adjoint_gradient` directly.

    Unlike :func:`adjoint_gradient`, ``yy0``/``yp0`` are ARRAYS (constant
    ICs) — the continuous path does not account for parameter-dependent
    initial conditions. Returns ``(loss, grad, istate)``; ``istate`` is 0
    on success (for the continuous route, nonzero if either the forward or
    the backward integration failed)."""
    prob = problem_factory(params)
    yy0 = jnp.asarray(yy0, dtype)
    yp0 = jnp.asarray(yp0, dtype)
    if prob.nroots == 0 and crossover <= max_attempts <= continuous_max:
        loss, grad_p, _grad_y0, ist_f, ist_b = continuous_adjoint(
            problem_factory, params, yy0, yp0, tol, tout, loss_of,
            grid=grid, opts=opts, dtype=dtype,
        )
        istate = jnp.where(ist_f != 0, ist_f, ist_b).astype(jnp.int32)
        return loss, grad_p, istate
    return adjoint_gradient(
        problem_factory, params, lambda p: yy0, lambda p: yp0, tol, tout,
        loss_of, opts=opts, max_attempts=max_attempts, dtype=dtype,
    )


def forward_sensitivity(
    problem_factory,
    params,
    yy0_of,
    yp0_of,
    tol: TolControl,
    tout,
    tangent,
    opts: IdaOptions = IdaOptions(),
):
    """One jvp: returns (y(tout), dy/dp . tangent)."""
    f = solve_with_params(problem_factory, params, yy0_of, yp0_of, tol, tout, opts)
    return jax.jvp(f, (params,), (tangent,))
