"""Nonlinear system solution for one step attempt (L3 layer).

Behavioural spec:
* driver & lsetup decision: reference ``nonlinear_solve`` (src/lib.rs:787-890)
* Newton iteration with deferred Jacobian: reference
  ``crates/nonlinear/src/newton.rs:51-167``
* IDA-specific sys/setup/solve/ctest: reference ``src/ida_nls.rs:105-266``
  and ``src/ida_ls.rs:232-455``

Design: the reference's outer(retry)/inner(iterate) Rust loops
with ``Result`` early exits become two nested masked ``while_loop`` state
machines; every lane of a vmapped ensemble runs its own iteration count in
lockstep. The loop carries hold ONLY what each loop mutates — the BDF
history (phi/psi/...), predictor, and weights are loop invariants read from
the closure, so each masked iteration moves a few vectors, not the whole
integrator state. The linear solve is the batched LU from ``ops.dense_lu``;
the Jacobian comes from the problem (analytic or one ``jacfwd``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..norms import wrms_norm_bnd
from ..ops.dense_lu import DenseLU, lu_factor_auto as lu_factor, lu_solve_auto as lu_solve
from ..problem import IdaProblem
from ..utils import masked_while_loop, tree_where
from ..utils.ad_mode import is_safe_ad, smask_den, spow
from .state import IdaState, IdaOptions
from ..utils.profiling import scope

# internal Newton loop status
_CONTINUE = 0
_OK = 1
_CONV_RECVR = 2  # recoverable: retry with fresh Jacobian or fail the attempt
_LSETUP_RECVR = 3  # singular/non-finite Jacobian in lsetup
_RES_RECVR = 4  # non-finite residual (C IDA_RES_RECVR; reference error.rs:5)
_LSOLVE_RECVR = 5  # failed linear solve (C IDA_LSOLVE_RECVR; error.rs:8)


def _res_ok(r) -> jax.Array:
    """Per-lane recoverable-residual channel (C IDA res return flag;
    reference error.rs:3-15 Recoverable::Residual, ida_nls.rs:118-153).
    User callbacks here are pure functions with no return-flag channel, so
    the failure signal is the residual VALUE itself: any
    non-finite entry (overflow at a too-ambitious h, log/sqrt out of
    domain, ...) marks the lane's evaluation recoverably failed. One
    reduce over an array the conv-test already reads — fuses into the
    residual computation."""
    return jnp.all(jnp.isfinite(r), axis=0)


class _Lin(NamedTuple):
    """Mutable linear-solver state threaded through the Newton loops."""

    lu: jax.Array
    piv: jax.Array
    pdata: object
    cjold: jax.Array
    cjratio: jax.Array
    nje: jax.Array
    nsetups: jax.Array
    nli: jax.Array
    nps: jax.Array
    # lsetup linearization point (ls_precision="refined"; () otherwise):
    # the f64 defect correction applies the factored Jacobian matrix-free
    # as a jvp of the residual at this point
    ls_pt: object


class _Inner(NamedTuple):
    """Carry of the inner Newton iteration — only what it mutates.

    Byte-diet (round 3): the while carry is HBM traffic every masked
    iteration, so the dense path drops everything it can reconstruct:
    ``yy``/``yp`` are ``predict + ycor`` (recomputed where needed),
    ``savres`` always equals ``delta`` inside the loop (both are set to the
    freshly evaluated residual under the same mask), and the five iterative-
    LS counters never change. Dropped fields carry the empty pytree ``()``
    so they cost nothing in the loop carry. Counters accumulate in LOCAL
    int32 lanes (``knni``/``kre``/…) and are widened into the int64 state
    counters once, after the loop — bit-identical totals."""

    ycor: jax.Array
    delta: jax.Array
    yy: object  # () on the dense path
    yp: object  # () on the dense path
    savres: object  # () on the dense path (== delta there)
    oldnrm: jax.Array
    ss: jax.Array
    curiter: jax.Array  # int32 m
    istatus: jax.Array  # int32
    knni: jax.Array  # int32 Newton iterations this nonlinear_solve
    kre: jax.Array  # int32 residual evaluations this nonlinear_solve
    knli: object  # () on the dense path; int32 lanes under spgmr
    knps: object
    kncfl: object
    knjtsetup: object
    knjtimes: object


class _Outer(NamedTuple):
    inner: _Inner
    lin: _Lin
    ss: jax.Array
    call_lsetup: jax.Array  # bool
    jcur: jax.Array  # bool
    ostatus: jax.Array  # int32


@scope("lsetup")
def _lsetup(
    state: IdaState, problem: IdaProblem, opts: IdaOptions, lin: _Lin, yy, yp, savres
) -> Tuple[_Lin, jax.Array]:
    """idaNlsLSetup + idaLsSetup (reference src/ida_nls.rs:156-187,
    src/ida_ls.rs:232-290). Dense: evaluate J = dF/dy + cj*dF/dy' at the
    predictor and LU-factor it. SPGMR: refresh the preconditioner (the
    operator itself is matrix-free via jvp, always current)."""
    if opts.linear_solver == "dense":
        if opts.ls_precision == "single":
            # mixed-precision mode: evaluate the Jacobian and factor in f32
            # (see IdaOptions.ls_precision). The factored LU is STORED in
            # f32 (init_state sizes the carry buffer accordingly) — the
            # loop-carry bytes are where the bandwidth goes.
            f32 = jnp.float32
            # the trailing astype guards against problem closures whose
            # captured (f64) parameters promote the result back up
            j = problem.sys_jacobian(
                state.tn.astype(f32), state.cj.astype(f32),
                yy.astype(f32), yp.astype(f32), savres.astype(f32),
            ).astype(f32)
        elif opts.ls_precision == "refined":
            # refined mode: f64 Jacobian, f32 factor+storage; lsolve
            # restores f64-quality corrections by defect correction
            # against this Jacobian applied matrix-free (see lsolve)
            j = problem.sys_jacobian(state.tn, state.cj, yy, yp, savres)
            lin = lin._replace(ls_pt=(state.tn, state.cj, yy, yp))
            j = j.astype(jnp.float32)
        else:
            j = problem.sys_jacobian(state.tn, state.cj, yy, yp, savres)
        f = lu_factor(j)
        lin = lin._replace(
            lu=f.lu.astype(lin.lu.dtype), piv=f.piv, nje=lin.nje + 1
        )
        # singular (pivot == 0) OR non-finite Jacobian (overflowing jacfwd)
        # => recoverable lsetup failure (C IDA_LSETUP_RECVR; a NaN pivot
        # passes the == 0 test, so singularity alone doesn't catch it)
        fail = jnp.logical_or(
            f.fail_col > 0,
            jnp.logical_not(jnp.all(jnp.isfinite(j), axis=(0, 1))),
        )
    elif opts.linear_solver == "band":
        # banded direct solver (the C IDA IDABand analogue; ops/banded.py).
        # The AD-colored band Jacobian costs mu+ml+1 jvps instead of N.
        from ..ops.banded import band_factor, band_sys_jacobian

        if opts.ls_precision == "single":
            f32 = jnp.float32
            ab = band_sys_jacobian(
                problem, state.tn.astype(f32), state.cj.astype(f32),
                yy.astype(f32), yp.astype(f32),
                opts.band_mu, opts.band_ml,
            ).astype(f32)
        else:
            ab = band_sys_jacobian(
                problem, state.tn, state.cj, yy, yp,
                opts.band_mu, opts.band_ml,
            )
        f = band_factor(ab, opts.band_mu, opts.band_ml)
        lin = lin._replace(
            lu=f.lu.astype(lin.lu.dtype), piv=f.piv, nje=lin.nje + 1
        )
        fail = jnp.logical_or(
            f.fail_col > 0,
            jnp.logical_not(jnp.all(jnp.isfinite(ab), axis=(0, 1))),
        )
    else:
        if problem.prec_setup is not None:
            pdata = problem.prec_setup(state.tn, state.cj, yy, yp, savres)
            lin = lin._replace(pdata=pdata)
        fail = jnp.asarray(False)
    lin = lin._replace(
        nsetups=lin.nsetups + 1,
        cjold=state.cj,
        cjratio=jnp.ones((), state.dtype),
    )
    return lin, fail


@scope("newton_iterate")
def _newton_iterate(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    lin: _Lin,
    inner0: _Inner,
) -> _Inner:
    """The inner Newton loop (reference newton.rs:96-135 + idaNlsConvTest
    src/ida_nls.rs:218-266). ``lin`` (factored J / preconditioner) is a loop
    invariant; the predictor and weights come from ``state`` (also
    invariant)."""
    dtype = state.dtype
    cj, tn = state.cj, state.tn
    ewt, eps_newt, toldel = state.ewt, state.eps_newt, state.toldel
    yypredict, yppredict = state.yypredict, state.yppredict

    def lsolve(c: _Inner, b, first):
        """idaLsSolve (reference src/ida_ls.rs:298-455). ``first`` is true on
        the first Newton iteration of this attempt: SUNDIALS idaLsSolve then
        accepts SUNLS_RES_REDUCED (residual reduced but not to tolerance) so
        Krylov problems don't take spurious convergence failures."""
        if opts.linear_solver == "dense":
            if opts.ls_precision == "single":
                # mixed-precision: back-substitute in f32 (lu is stored f32)
                f = DenseLU(lin.lu, lin.piv, jnp.zeros((), jnp.int32))
                x = lu_solve(f, b.astype(jnp.float32)).astype(dtype)
            elif opts.ls_precision == "refined":
                # one step of f64 iterative refinement against the
                # setup-point Jacobian applied matrix-free:
                #   x = x0 + LU32^{-1} (b - J x0),  J v = d/de res(y+e v,
                #   yp + e cj v) at the saved lsetup point.
                # The refined correction is f64-accurate, so step decisions
                # track the "full" mode while factor/back-substitution
                # traffic is f32 (IdaOptions.ls_precision docs).
                f = DenseLU(lin.lu, lin.piv, jnp.zeros((), jnp.int32))
                x0 = lu_solve(f, b.astype(jnp.float32)).astype(dtype)
                s_tn, s_cj, s_yy, s_yp = lin.ls_pt
                _, jx0 = jax.jvp(
                    lambda y, ydot: problem.res(s_tn, y, ydot),
                    (s_yy, s_yp), (x0, s_cj * x0),
                )
                dx = lu_solve(
                    f, (b - jx0).astype(jnp.float32)
                ).astype(dtype)
                x = x0 + dx
            else:
                x = lu_solve(
                    DenseLU(lin.lu, lin.piv, jnp.zeros((), jnp.int32)), b
                )
            scale = jnp.where(
                lin.cjratio != 1.0, 2.0 / (1.0 + lin.cjratio), jnp.ones((), dtype)
            )
            return c, x * scale, jnp.asarray(True)
        if opts.linear_solver == "band":
            from ..ops.banded import BandLU, band_solve

            fb = BandLU(
                lin.lu, lin.piv, jnp.zeros((), jnp.int32),
                opts.band_mu, opts.band_ml,
            )
            if opts.ls_precision == "single":
                # lu is stored f32 already (init_state); solve in f32
                x = band_solve(fb, b.astype(jnp.float32)).astype(dtype)
            else:
                x = band_solve(fb, b)
            # same cj-change correction as every direct solver (idaLsSolve,
            # reference src/ida_ls.rs:406-410)
            scale = jnp.where(
                lin.cjratio != 1.0, 2.0 / (1.0 + lin.cjratio), jnp.ones((), dtype)
            )
            return c, x * scale, jnp.asarray(True)
        from ..ops.spgmr import spgmr_solve

        yy, yp = c.yy, c.yp
        jdata = None
        if problem.jtimes_setup is not None:
            # C idaLsSolve calls the user jtsetup once per linear solve
            jdata = problem.jtimes_setup(tn, cj, yy, yp, c.savres)
            c = c._replace(knjtsetup=c.knjtsetup + 1)
        # mixed-precision mode (IdaOptions.ls_precision="single"): the whole
        # Krylov iteration — matvecs, preconditioner applications, Gram-
        # Schmidt reductions — runs in f32; the correction is cast back.
        # Requires dtype-polymorphic jtimes/prec callbacks (all in-repo
        # problems are); a no-op when the state is already f32.
        ldt = jnp.float32 if opts.ls_precision == "single" else dtype

        def _lcast(t):
            return jax.tree_util.tree_map(
                lambda x: x.astype(ldt)
                if jnp.issubdtype(jnp.result_type(x), jnp.floating)
                else x,
                t,
            )

        tn_l, cj_l, yy_l, yp_l, jdata_l = _lcast((tn, cj, yy, yp, jdata))
        # trailing astype: keep the Krylov carry dtype stable even if a
        # problem closure's captured f64 parameters promote internally
        atimes = lambda v: problem.jtimes(  # noqa: E731
            tn_l, cj_l, yy_l, yp_l, v, jdata_l
        ).astype(ldt)
        psolve = None
        if problem.prec_solve is not None:
            pdata_l = _lcast(lin.pdata)
            psolve = lambda r: problem.prec_solve(  # noqa: E731
                pdata_l, r, cj_l
            ).astype(ldt)
        sqrt_n = jnp.sqrt(jnp.asarray(problem.n, dtype))
        tol = sqrt_n * opts.eplifac * eps_newt
        res = spgmr_solve(
            atimes, b.astype(ldt), tol.astype(ldt), psolve=psolve,
            s1=ewt.astype(ldt), s2=ewt.astype(ldt),
            maxl=opts.krylov_maxl, max_restarts=opts.krylov_max_restarts,
            storage_dtype=(
                jnp.bfloat16 if opts.krylov_storage == "bfloat16" else None
            ),
            gs=opts.krylov_gs,
        )
        if ldt != dtype:
            res = res._replace(x=res.x.astype(dtype))
        ok = jnp.logical_or(res.converged, jnp.logical_and(first, res.reduced))
        c = c._replace(
            knli=c.knli + res.nli.astype(jnp.int32),
            knps=c.knps + res.nps.astype(jnp.int32),
            knjtimes=c.knjtimes + res.natimes.astype(jnp.int32),
            # linear convergence failure (reference ida_ls.rs ncfl): C
            # idaLsSolve counts EVERY non-success linear return — including
            # SUNLS_RES_REDUCED that the first Newton iteration then accepts
            # (ADVICE r2) — so count on res.converged, not on ok
            kncfl=c.kncfl + jnp.logical_not(res.converged).astype(jnp.int32),
        )
        return c, res.x, ok

    def cond(c: _Inner) -> jax.Array:
        return c.istatus == _CONTINUE

    # "dense" here means DIRECT (dense or band): both drop the
    # iterative-LS carry fields and reconstruct yy/yp/savres
    dense = opts.linear_solver in ("dense", "band")

    def body(c: _Inner) -> _Inner:
        c = c._replace(knni=c.knni + 1)
        m = c.curiter
        first = m == 0
        c, x, lok = lsolve(c, -c.delta, first)
        ycor = c.ycor + x

        # --- convergence test (idaNlsConvTest) ---
        delnrm = wrms_norm_bnd(x, ewt, problem.n, jnp.ndim(cj))
        oldnrm = jnp.where(first, delnrm, c.oldnrm)
        conv_direct = jnp.logical_and(first, delnrm <= 1.0e-4 * toldel)
        rate = jnp.where(
            first,
            jnp.zeros((), dtype),
            spow(delnrm / smask_den(oldnrm), 1.0 / jnp.maximum(m, 1)),
        )
        diverged = jnp.logical_and(jnp.logical_not(first), rate > C.RATEMAX)
        ss = jnp.where(
            jnp.logical_not(first), rate / smask_den(1.0 - rate), c.ss
        )
        converged = jnp.logical_or(conv_direct, ss * delnrm <= eps_newt)

        curiter = m + 1
        exhausted = curiter >= opts.maxnlsit
        istatus = jnp.where(
            diverged,
            _CONV_RECVR,
            jnp.where(converged, _OK, jnp.where(exhausted, _CONV_RECVR, _CONTINUE)),
        ).astype(jnp.int32)
        # failed linear solve => DISTINCT recoverable kind (C
        # IDA_LSOLVE_RECVR; reference error.rs:8 Recoverable::LSolve) so
        # handle_n_flag can return LSOLVE_FAIL, not CONV_FAIL, at maxncf
        istatus = jnp.where(lok, istatus, jnp.asarray(_LSOLVE_RECVR, jnp.int32))

        # re-evaluate the residual only if iterating again; a non-finite
        # result ends the Newton loop with the recoverable-residual kind
        # (C SUNNonlinSolSolve_Newton: a recoverable SysFn failure inside
        # the iteration exits to the jbad retry path) without poisoning
        # the carried delta/savres
        keep = istatus == _CONTINUE
        yy = yypredict + ycor
        yp = yppredict + cj * ycor
        r = problem.res(tn, yy, yp)
        rbad = jnp.logical_and(keep, jnp.logical_not(_res_ok(r)))
        istatus = jnp.where(rbad, jnp.asarray(_RES_RECVR, jnp.int32), istatus)
        keep_w = jnp.logical_and(keep, jnp.logical_not(rbad))
        return _Inner(
            ycor=ycor,
            delta=jnp.where(keep_w, r, c.delta),
            # dense path: yy/yp/savres are reconstructable (see class doc)
            yy=() if dense else jnp.where(keep_w, yy, c.yy),
            yp=() if dense else jnp.where(keep_w, yp, c.yp),
            savres=() if dense else jnp.where(keep_w, r, c.savres),
            oldnrm=oldnrm,
            ss=ss,
            curiter=curiter,
            istatus=istatus,
            knni=c.knni,
            kre=c.kre + keep.astype(jnp.int32),
            knli=c.knli,
            knps=c.knps,
            kncfl=c.kncfl,
            knjtsetup=c.knjtsetup,
            knjtimes=c.knjtimes,
        )

    if opts.unroll_newton:
        c = inner0
        for _ in range(opts.maxnlsit):
            c = tree_where(cond(c), body(c), c)
        return c
    return masked_while_loop(cond, body, inner0)


@scope("nonlinear_solve")
def nonlinear_solve(
    state: IdaState, problem: IdaProblem, opts: IdaOptions,
    active: jax.Array | None = None,
) -> Tuple[IdaState, jax.Array]:
    """Attempt the nonlinear solve for the current step (reference
    src/lib.rs:787-890). Returns (state, nl_status) with nl_status in
    {REC_NONE (ok), REC_CONV, REC_RESIDUAL, REC_LSETUP, REC_LSOLVE,
    REC_CONSTRAINT} — the full recoverable taxonomy of reference
    error.rs:3-15. On success state.ee/yy/yp hold the accepted correction.

    ``active``: lanes with active=False pass through bit-identically and
    report REC_NONE (self-masked loop-body contract; their Newton loops are
    short-circuited so they add no iterations)."""
    dtype = state.dtype
    if active is None:
        active = jnp.ones(jnp.shape(state.tn), bool)

    # first-call initialisation (src/lib.rs:794-799)
    first = state.nst == 0
    cjold = jnp.where(first, state.cj, state.cjold)
    ss = jnp.where(first, jnp.asarray(20.0, dtype), state.ss)
    call_lsetup = first

    # lsetup decision from the cj ratio (src/lib.rs:804-812)
    cjratio = state.cj / smask_den(cjold)
    lo = (1.0 - C.XRATE) / (1.0 + C.XRATE)
    call_lsetup = jnp.logical_or(
        call_lsetup, jnp.logical_or(cjratio < lo, cjratio > 1.0 / lo)
    )
    call_lsetup = jnp.logical_and(call_lsetup, active)
    ss = jnp.where(state.cj != state.cjlast, jnp.asarray(100.0, dtype), ss)

    lin0 = _Lin(
        lu=state.lu, piv=state.piv, pdata=state.pdata, cjold=cjold,
        cjratio=cjratio, nje=state.nje, nsetups=state.nsetups,
        nli=state.nli, nps=state.nps,
        ls_pt=(
            (state.ls_tn, state.ls_cj, state.ls_yy, state.ls_yp)
            if opts.ls_precision == "refined"
            else ()
        ),
    )

    # "dense" here means DIRECT (dense or band): both drop the
    # iterative-LS carry fields and reconstruct yy/yp/savres
    dense = opts.linear_solver in ("dense", "band")
    zero_i = jnp.zeros(jnp.shape(state.tn), jnp.int32)

    def fresh_inner(c_prev: _Inner | None, delta, yy, yp, savres, ss, kre) -> _Inner:
        z = jnp.zeros_like(state.yy)
        return _Inner(
            ycor=z, delta=delta,
            yy=() if dense else yy,
            yp=() if dense else yp,
            savres=() if dense else savres,
            oldnrm=state.oldnrm, ss=ss,
            curiter=jnp.zeros(jnp.shape(state.tn), jnp.int32),
            istatus=jnp.where(active, _CONTINUE, _OK).astype(jnp.int32),
            knni=(c_prev.knni if c_prev is not None else zero_i),
            kre=kre,
            knli=() if dense else (c_prev.knli if c_prev is not None else zero_i),
            knps=() if dense else (c_prev.knps if c_prev is not None else zero_i),
            kncfl=() if dense else (c_prev.kncfl if c_prev is not None else zero_i),
            knjtsetup=() if dense else (
                c_prev.knjtsetup if c_prev is not None else zero_i
            ),
            knjtimes=() if dense else (
                c_prev.knjtimes if c_prev is not None else zero_i
            ),
        )

    # --- outer loop: residual -> (lsetup?) -> Newton; one retry with a
    # fresh Jacobian on recoverable convergence failure (newton.rs:73-160)
    def cond(c: _Outer) -> jax.Array:
        return c.ostatus == _CONTINUE

    def body(c: _Outer) -> _Outer:
        # residual at the predictor (ycor = 0)
        yy, yp = state.yypredict, state.yppredict
        r = problem.res(state.tn, yy, yp)
        kre = c.inner.kre + 1
        # non-finite predictor residual => recoverable residual failure,
        # TERMINAL for this attempt (C SUNNonlinSolSolve_Newton breaks on
        # an initial-SysFn failure without the fresh-J retry: the retry
        # re-evaluates at the same predictor, so it cannot help); the
        # lsetup below is also skipped so no Jacobian is evaluated (and
        # persisted into lin.lu) at the non-finite point
        res_bad = jnp.logical_not(_res_ok(r))

        lin = c.lin
        lin2, setup_fail = _lsetup(state, problem, opts, lin, yy, yp, r)
        do_setup = jnp.logical_and(c.call_lsetup, jnp.logical_not(res_bad))
        lin = tree_where(do_setup, lin2, lin)
        # lsetup refreshes ss to 20 (src/ida_nls.rs:179)
        ss = jnp.where(do_setup, jnp.asarray(20.0, dtype), c.ss)
        setup_fail = jnp.logical_and(do_setup, setup_fail)
        jcur = jnp.logical_or(c.jcur, do_setup)

        inner0 = fresh_inner(c.inner, r, yy, yp, r, ss, kre)
        inner_out = _newton_iterate(state, problem, opts, lin, inner0)
        skip_newton = jnp.logical_or(setup_fail, res_bad)
        inner = tree_where(jnp.logical_not(skip_newton), inner_out, inner0)

        # any recoverable inner failure earns ONE retry with a fresh
        # Jacobian if the current one is stale (C SUNNonlinSolSolve_Newton
        # jbad path applies to conv, lsolve AND in-loop residual failures)
        recvr = jnp.logical_or(
            inner.istatus == _CONV_RECVR,
            jnp.logical_or(
                inner.istatus == _LSOLVE_RECVR, inner.istatus == _RES_RECVR
            ),
        )
        retry = jnp.logical_and(recvr, jnp.logical_not(jcur))
        retry = jnp.logical_and(retry, jnp.logical_not(skip_newton))

        ostatus = jnp.where(
            setup_fail,
            _LSETUP_RECVR,
            jnp.where(
                res_bad,
                _RES_RECVR,
                jnp.where(
                    retry,
                    _CONTINUE,
                    jnp.where(inner.istatus == _OK, _OK, inner.istatus),
                ),
            ),
        ).astype(jnp.int32)

        return _Outer(
            inner=inner,
            lin=lin,
            ss=inner.ss,
            call_lsetup=retry,
            # logical_and, not where(pred, False, .): the form a removed
            # Pallas kernel needed, kept (rewrites risk step-parity flips)
            jcur=jnp.logical_and(jcur, inner.istatus != _OK),
            ostatus=ostatus,
        )

    init = _Outer(
        inner=fresh_inner(
            None, state.savres, state.yy, state.yp, state.savres, ss, zero_i
        ),
        lin=lin0,
        ss=ss,
        call_lsetup=call_lsetup,
        jcur=jnp.zeros(jnp.shape(state.tn), bool),
        # inactive lanes start terminal so the Newton loops never touch them
        ostatus=jnp.where(active, _CONTINUE, _OK).astype(jnp.int32),
    )
    if opts.unroll_newton:
        # the retry loop runs at most twice (one retry with a fresh
        # Jacobian: body sets ostatus != CONTINUE unless retry, and a retry
        # sets jcur so the second pass always terminates) — two masked
        # applications are exact and reverse-differentiable, which a
        # dynamic while loop is not (the adjoint path forces this form)
        out = init
        for _ in range(2):
            out = tree_where(cond(out), body(out), out)
    else:
        out = masked_while_loop(cond, body, init)
    inner, lin = out.inner, out.lin

    # fold the loop-local pieces back into the integrator state (masked:
    # inactive lanes keep every field bit-identically). The loop-carried
    # pieces are already identical for inactive lanes (their loops never
    # ran), except the lsetup-decision fields computed before the loop.
    a = active
    cdt = state.nni.dtype  # counter dtype: widen the local int32 tallies
    if opts.ls_precision == "refined":
        state = state._replace(
            ls_tn=lin.ls_pt[0], ls_cj=lin.ls_pt[1],
            ls_yy=lin.ls_pt[2], ls_yp=lin.ls_pt[3],
        )
    state = state._replace(
        lu=lin.lu, piv=lin.piv, pdata=lin.pdata,
        cjold=jnp.where(a, lin.cjold, state.cjold),
        cjratio=jnp.where(a, lin.cjratio, state.cjratio),
        nje=lin.nje, nsetups=lin.nsetups,
        nni=state.nni + inner.knni.astype(cdt),
        nre=state.nre + inner.kre.astype(cdt),
        oldnrm=jnp.where(a, inner.oldnrm, state.oldnrm),
        ss=jnp.where(a, inner.ss, state.ss),
        # dense path: savres == delta throughout the inner loop (class doc)
        savres=inner.delta if dense else inner.savres,
    )
    if not dense:
        state = state._replace(
            nli=state.nli + inner.knli.astype(cdt),
            nps=state.nps + inner.knps.astype(cdt),
            ncfl=state.ncfl + inner.kncfl.astype(cdt),
            njtsetup=state.njtsetup + inner.knjtsetup.astype(cdt),
            njtimes=state.njtimes + inner.knjtimes.astype(cdt),
        )

    # apply the final correction (src/lib.rs:845-849)
    ee = jnp.where(a, inner.ycor, state.ee)
    yy = jnp.where(a, state.yypredict + inner.ycor, state.yy)
    yp = jnp.where(a, state.yppredict + state.cj * inner.ycor, state.yp)
    state = state._replace(ee=ee, yy=yy, yp=yp)

    nl_status = jnp.where(
        out.ostatus == _OK,
        C.REC_NONE,
        jnp.where(
            out.ostatus == _LSETUP_RECVR,
            C.REC_LSETUP,
            jnp.where(
                out.ostatus == _RES_RECVR,
                C.REC_RESIDUAL,
                jnp.where(
                    out.ostatus == _LSOLVE_RECVR, C.REC_LSOLVE, C.REC_CONV
                ),
            ),
        ),
    ).astype(jnp.int32)

    nl_status = jnp.where(active, nl_status, C.REC_NONE).astype(jnp.int32)
    if not opts.enable_constraints:
        # trace-time constraintsSet branch (C ida.c IDANls checks a scalar
        # bool for free; in a lockstep batch the block below costs real
        # bandwidth even when select-discarded). The block is an exact
        # identity when no lane has constraints set, so this skip is
        # bit-identical for constraint-free problems.
        return state, nl_status

    # --- inequality constraints (C IDA IDANls; the reference leaves this
    # branch unimplemented!() with the C spec in comments, src/lib.rs:857-887)
    # constraint codes: 2 => y>0, 1 => y>=0, -1 => y<=0, -2 => y<0, 0 = none
    cvec = state.constraints
    # pure boolean algebra, not nested bool-valued wheres (the removed
    # Pallas kernel's form; kept, as rewrites risk step-parity flips)
    viol = (
        jnp.logical_and(cvec == 2.0, yy <= 0.0)
        | jnp.logical_and(cvec == 1.0, yy < 0.0)
        | jnp.logical_and(cvec == -1.0, yy > 0.0)
        | jnp.logical_and(cvec == -2.0, yy >= 0.0)
    )
    bnd = jnp.ndim(state.tn)
    check = jnp.logical_and(
        jnp.logical_and(state.constraints_set, nl_status == C.REC_NONE), active
    )
    failed = jnp.logical_and(check, jnp.any(viol, axis=0))

    mm = viol.astype(dtype)
    strict = (jnp.abs(cvec) >= 1.5).astype(dtype)  # N_VCompare(1.5, |c|)
    v = mm * (yy - 0.1 * strict * cvec / state.ewt)  # mm*(y - 0.1*a*c*wt)
    vnorm = wrms_norm_bnd(v, state.ewt, problem.n, bnd)
    small = vnorm <= state.eps_newt

    # small violation: pull the correction back inside (ee only — phi gets
    # rebuilt from ee in complete_step; yy/yp are scratch past this point)
    ee_fixed = jnp.where(jnp.logical_and(failed, small), ee - v, ee)

    # large violation: shrink h by rr = max(0.9*minquotient(phi[0], mm*(phi0-y)), 0.1)
    denom = mm * (state.phi[0] - yy)
    # under safe_ad: guard the discarded 0-division AND use a finite
    # no-quotient sentinel (SUNDIALS N_VMinQuotient's BIG_REAL) — an inf
    # primal would make the backward 0*inf = nan even though this whole
    # path is select-discarded when constraints are unset.
    sentinel = jnp.finfo(dtype).max if is_safe_ad() else jnp.inf
    quot = jnp.where(denom != 0.0, state.phi[0] / smask_den(denom), sentinel)
    minq = jnp.min(quot, axis=0)
    rr_c = jnp.maximum(0.9 * minq, 0.1)
    constr_recvr = jnp.logical_and(failed, jnp.logical_not(small))

    state = state._replace(
        ee=ee_fixed,
        rr=jnp.where(constr_recvr, rr_c, state.rr),
    )
    nl_status = jnp.where(constr_recvr, C.REC_CONSTRAINT, nl_status).astype(jnp.int32)
    return state, nl_status
