"""The main integration driver (L4 top).

Behavioural spec: reference ``solve`` (src/impl_solve.rs:69-377) and the
stop tests (src/impl_stop_test.rs:36-211): first-call initialisation
(initial step heuristic, tstop guard, root init, phi[1] *= h), pre-step
root re-checks and stop tests, then the internal-step loop (mxstep guard,
ewt refresh + positivity, accuracy test, step(), per-step root check,
post-step stop test).

Design: one traced function; every reference early-return is a
status lane write that terminates the masked while loop, so a vmapped batch
of instances with different step counts finishes in lockstep. The host-side
wrapper in ``ida_tpu.solver`` decodes statuses into exceptions/enums.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..problem import IdaProblem
from ..tol_control import TolControl
from ..utils import masked_while_loop, tree_where
from ..utils.tree import int_carry_fori_loop
from ..utils.ad_mode import smask_den
from .complete_step import complete_step
from .error_test import _norm
from .quad import accumulate_quad
from .interp import check_t_legal, get_solution, interpolate
from .root import r_check1, r_check2, r_check3
from .state import IdaState, IdaOptions
from .step import attempt_once, step_begin


def _eps(state):
    """Unit roundoff for the state's dtype (weak scalar: no f64 promotion
    in f32 runs, and f32 runs get f32-appropriate roundoff guards)."""
    return float(jnp.finfo(state.dtype).eps)


TASK_NORMAL = 0
TASK_ONE_STEP = 1


def _ewt_invalid(ewt: jax.Array) -> jax.Array:
    """Per-component BAD_EWT predicate. C IDAEwtSet checks the DENOMINATOR
    ``min(rtol*|y| + atol) <= 0`` before inverting (ida.c IDAEwtSetSS/SV);
    after inversion that surfaces as ewt <= 0 (negative or overflowed
    denominator) OR non-finite ewt (zero denominator -> inf, e.g. atol = 0
    on a component that reaches exactly 0)."""
    return jnp.logical_or(
        jnp.logical_not(ewt > 0.0), jnp.logical_not(jnp.isfinite(ewt))
    )


def _first_call_init(
    state: IdaState, problem: IdaProblem, opts: IdaOptions, tol: TolControl, tout
) -> Tuple[IdaState, jax.Array]:
    """First-call block (reference impl_solve.rs:84-173). Returns
    (state, istate); istate == CONTINUE unless input checks fail."""
    dtype = state.dtype
    istate = jnp.asarray(C.CONTINUE, jnp.int32)

    # initial_setup: error weights from phi[0] (src/lib.rs:537-545)
    ewt = tol.ewt_set(state.phi[0])
    istate = jnp.where(
        jnp.any(_ewt_invalid(ewt), axis=tuple(range(ewt.ndim - jnp.ndim(state.tn)))),
        C.BAD_EWT,
        istate,
    )
    state = state._replace(ewt=ewt)

    # tout sanity (impl_solve.rs:97-109)
    tdist = jnp.abs(tout - state.tn)
    troundoff = 2.0 * _eps(state) * (jnp.abs(state.tn) + jnp.abs(tout))
    istate = jnp.where(
        jnp.logical_or(tdist == 0.0, tdist < troundoff), C.ILL_INPUT, istate
    )

    # initial step selection (impl_solve.rs:111-133)
    hh = state.hin
    istate = jnp.where(
        jnp.logical_and(hh != 0.0, (tout - state.tn) * hh < 0.0), C.ILL_INPUT, istate
    )
    hh_auto = 0.001 * tdist
    ypnorm = _norm(state, problem, opts, state.phi[1])
    hh_auto = jnp.where(
        ypnorm > 2.0 / smask_den(hh_auto), 0.5 / smask_den(ypnorm), hh_auto
    )
    hh_auto = jnp.where(tout < state.tn, -hh_auto, hh_auto)
    hh = jnp.where(hh == 0.0, hh_auto, hh)

    # hmax clamp (impl_solve.rs:135-138)
    rh = jnp.abs(hh) * state.hmax_inv
    hh = jnp.where(rh > 1.0, hh / smask_den(rh), hh)

    # tstop guard (impl_solve.rs:140-155)
    bad_tstop = jnp.logical_and(
        state.tstop_set, (state.tstop - state.tn) * hh <= 0.0
    )
    istate = jnp.where(bad_tstop, C.ILL_INPUT, istate)
    clamp = jnp.logical_and(
        state.tstop_set, (state.tn + hh - state.tstop) * hh > 0.0
    )
    hh = jnp.where(clamp, (state.tstop - state.tn) * (1.0 - 4.0 * _eps(state)), hh)

    state = state._replace(
        hh=hh,
        h0u=hh,
        kk=jnp.asarray(0, jnp.int32),
        kused=jnp.asarray(0, jnp.int32),
    )

    # root init at t0 (impl_solve.rs:161-164)
    if problem.nroots > 0:
        state = r_check1(state, problem)

    # phi[1] *= hh; Newton constants (impl_solve.rs:166-172)
    state = state._replace(
        phi=state.phi
        * jnp.expand_dims(
            jnp.where(
                jnp.arange(C.MXORDP1, dtype=jnp.int32).reshape((C.MXORDP1,) + (1,) * jnp.ndim(hh)) == 1,
                hh,
                jnp.ones((), dtype),
            ),
            1,
        ),
        eps_newt=state.epcon,
        toldel=1.0e-4 * state.epcon,
    )
    return state, istate


def _stop_test1(
    state: IdaState, tout, tret, itask: int
) -> Tuple[IdaState, jax.Array, jax.Array]:
    """Pre-step stop tests (reference impl_stop_test.rs:36-125).
    Returns (state, tret, istate)."""
    istate = jnp.asarray(C.CONTINUE, jnp.int32)

    bad_tstop = jnp.logical_and(
        state.tstop_set, (state.tn - state.tstop) * state.hh > 0.0
    )
    istate = jnp.where(bad_tstop, C.ILL_INPUT, istate)
    troundoff = 100.0 * _eps(state) * (jnp.abs(state.tn) + jnp.abs(state.hh))

    if itask == TASK_NORMAL:
        # tout == tretlast (impl_stop_test.rs:54-58): return without interp
        hit_prev = tout == state.tretlast
        # tn past tout (:60-65)
        past_tout = (state.tn - tout) * state.hh >= 0.0
        st_interp, ok = get_solution(state, tout)
        past_tout_ok = jnp.logical_and(past_tout, ok)
        # near tstop (:67-83)
        at_tstop = jnp.logical_and(
            state.tstop_set, jnp.abs(state.tn - state.tstop) <= troundoff
        )
        st_tstop, _ = get_solution(state, state.tstop)

        # priority: hit_prev, then past_tout, then tstop
        sel_tstop = jnp.logical_and(
            at_tstop, jnp.logical_not(jnp.logical_or(hit_prev, past_tout))
        )
        sel_tout = jnp.logical_and(past_tout_ok, jnp.logical_not(hit_prev))
        state = tree_where(sel_tstop, st_tstop, tree_where(sel_tout, st_interp, state))

        newret = jnp.where(
            jnp.logical_or(hit_prev, past_tout), tout,
            jnp.where(sel_tstop, state.tstop, tret),
        )
        returning = jnp.logical_or(jnp.logical_or(hit_prev, past_tout), sel_tstop)
        tret = jnp.where(returning, newret, tret)
        state = state._replace(
            tretlast=jnp.where(returning, newret, state.tretlast),
            tstop_set=jnp.logical_and(state.tstop_set, jnp.logical_not(sel_tstop)),
        )
        istate = jnp.where(
            istate != C.CONTINUE,
            istate,
            jnp.where(
                jnp.logical_or(hit_prev, past_tout),
                jnp.where(
                    jnp.logical_and(past_tout, jnp.logical_not(jnp.logical_or(hit_prev, ok))),
                    C.BAD_T,
                    C.SUCCESS,
                ),
                jnp.where(sel_tstop, C.TSTOP_RETURN, C.CONTINUE),
            ),
        ).astype(jnp.int32)
    else:
        # ONE_STEP (impl_stop_test.rs:94-123)
        past_last = (state.tn - state.tretlast) * state.hh > 0.0
        st_interp, _ = get_solution(state, state.tn)
        at_tstop = jnp.logical_and(
            state.tstop_set, jnp.abs(state.tn - state.tstop) <= troundoff
        )
        st_tstop, _ = get_solution(state, state.tstop)
        sel_tstop = jnp.logical_and(at_tstop, jnp.logical_not(past_last))
        state = tree_where(
            past_last, st_interp, tree_where(sel_tstop, st_tstop, state)
        )
        newret = jnp.where(past_last, state.tn, jnp.where(sel_tstop, state.tstop, tret))
        returning = jnp.logical_or(past_last, sel_tstop)
        tret = jnp.where(returning, newret, tret)
        state = state._replace(
            tretlast=jnp.where(returning, newret, state.tretlast)
        )
        istate = jnp.where(
            istate != C.CONTINUE,
            istate,
            jnp.where(
                past_last, C.SUCCESS, jnp.where(sel_tstop, C.TSTOP_RETURN, C.CONTINUE)
            ),
        ).astype(jnp.int32)

    # clamp hh to land on tstop (both tasks)
    clamp = jnp.logical_and(
        jnp.logical_and(state.tstop_set, istate == C.CONTINUE),
        (state.tn + state.hh - state.tstop) * state.hh > 0.0,
    )
    state = state._replace(
        hh=jnp.where(clamp, (state.tstop - state.tn) * (1.0 - 4.0 * _eps(state)), state.hh)
    )
    return state, tret, istate


def _stop_test2(
    state: IdaState, tout, tret, itask: int
) -> Tuple[IdaState, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Post-step stop tests (reference impl_stop_test.rs:146-211), with the
    interpolation DEFERRED: instead of evaluating y(t) inline (which would
    run the full cvals/dvals interpolation every attempt only to be masked
    away on continuing lanes — measured as the single largest
    per-iteration cost on an earlier accelerator), this returns (state,
    tret, istate, ikind, itgt) where
    ikind/itgt say which interpolation the exiting lane needs; the caller
    applies it ONCE after the loop. Lanes freeze at exit, so the deferred
    evaluation is bit-identical to the inline one."""
    istate = jnp.asarray(C.CONTINUE, jnp.int32)
    troundoff = 100.0 * _eps(state) * (jnp.abs(state.tn) + jnp.abs(state.hh))
    zero_t = jnp.zeros_like(state.tn)
    ikind = jnp.zeros(jnp.shape(state.tn), jnp.int32)

    at_tstop = jnp.logical_and(
        state.tstop_set, jnp.abs(state.tn - state.tstop) <= troundoff
    )

    if itask == TASK_NORMAL:
        past_tout = (state.tn - tout) * state.hh >= 0.0
        sel_tstop = jnp.logical_and(at_tstop, jnp.logical_not(past_tout))
        ikind = jnp.where(
            past_tout, 1, jnp.where(sel_tstop, 1, 0)
        ).astype(jnp.int32)
        itgt = jnp.where(past_tout, tout, jnp.where(sel_tstop, state.tstop, zero_t))
        newret = jnp.where(past_tout, tout, jnp.where(sel_tstop, state.tstop, tret))
        returning = jnp.logical_or(past_tout, sel_tstop)
        tret = jnp.where(returning, newret, tret)
        state = state._replace(
            tretlast=jnp.where(returning, newret, state.tretlast),
            tstop_set=jnp.logical_and(state.tstop_set, jnp.logical_not(sel_tstop)),
        )
        istate = jnp.where(
            past_tout, C.SUCCESS, jnp.where(sel_tstop, C.TSTOP_RETURN, C.CONTINUE)
        ).astype(jnp.int32)
    else:
        ikind = at_tstop.astype(jnp.int32)
        itgt = jnp.where(at_tstop, state.tstop, zero_t)
        newret = jnp.where(at_tstop, state.tstop, state.tn)
        tret = newret
        state = state._replace(
            tretlast=newret,
            tstop_set=jnp.logical_and(state.tstop_set, jnp.logical_not(at_tstop)),
        )
        istate = jnp.where(at_tstop, C.TSTOP_RETURN, C.SUCCESS).astype(jnp.int32)

    clamp = jnp.logical_and(
        jnp.logical_and(state.tstop_set, istate == C.CONTINUE),
        (state.tn + state.hh - state.tstop) * state.hh > 0.0,
    )
    state = state._replace(
        hh=jnp.where(clamp, (state.tstop - state.tn) * (1.0 - 4.0 * _eps(state)), state.hh)
    )
    return state, tret, istate, ikind, itgt


class _Loop(NamedTuple):
    state: IdaState
    tret: jax.Array
    istate: jax.Array
    nstloc: jax.Array
    saved_t: jax.Array
    ncf: jax.Array
    nef: jax.Array
    fresh: jax.Array  # bool: next iteration begins a new step
    ikind: jax.Array  # int32: deferred interpolation (0 none, 1 at itgt)
    itgt: jax.Array  # target time of the deferred interpolation


def solve(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    tol: TolControl,
    tout: jax.Array,
    itask: int = TASK_NORMAL,
    max_attempts: int | None = None,
    resume_carry=None,
) -> Tuple[IdaState, jax.Array, jax.Array]:
    """Integrate toward ``tout`` (reference impl_solve.rs:69-377).

    ``itask`` is trace-time: TASK_NORMAL steps past tout then interpolates;
    TASK_ONE_STEP returns after each internal step.

    Returns (state, tret, istate) with istate one of SUCCESS, TSTOP_RETURN,
    ROOT_RETURN or a negative failure code.

    ``max_attempts`` (trace-time) bounds the internal loop to a FIXED trip
    count (``lax.fori_loop`` with masked body — reverse-differentiable,
    unlike a data-dependent while). Lanes that need more attempts return
    with istate == CONTINUE and
    an opaque ``carry`` for exact resumption; the return becomes
    ``(state, tret, istate, carry)``. Pass the carry back via
    ``resume_carry`` to continue precisely where the loop stopped (the
    pre-loop prologue is skipped — retry counters, saved_t, and the
    mid-step/fresh flag are all preserved, so a budgeted+resumed solve is
    bit-identical to an unbudgeted one).
    """
    dtype = state.dtype
    tout = jnp.asarray(tout, dtype)
    # tret defaults to tn (not 0) so failures raised before any step — e.g.
    # ILL_INPUT/BAD_EWT from the first-call block — report the true time for
    # problems with nonzero t0 (ADVICE r1).
    tret = jnp.asarray(state.tn, dtype)
    has_roots = problem.nroots > 0

    if resume_carry is not None:
        # exact continuation of a budget-exhausted call: skip the prologue,
        # re-enter the loop with the preserved carry (frozen lanes stay
        # frozen — their istate is already terminal so cond() masks them)
        assert max_attempts is not None, "resume_carry requires max_attempts"
        init = _Loop(state, *resume_carry)
        return _run_attempt_loop(init, problem, opts, tol, tout, itask, max_attempts)

    if itask == TASK_NORMAL:
        state = state._replace(toutc=tout)
    state = state._replace(
        taskc=jnp.asarray(itask, jnp.int32),
        status=jnp.asarray(C.CONTINUE, jnp.int32),
    )

    first = state.nst == 0

    # ---- first-call block ----
    st_init, istate_init = _first_call_init(state, problem, opts, tol, tout)
    state = tree_where(first, st_init, state)
    istate = jnp.where(first, istate_init, C.CONTINUE).astype(jnp.int32)

    # ---- pre-step root checks (impl_solve.rs:186-227) ----
    if has_roots:
        def pre_root(state, istate, tret):
            irfndp = state.irfnd
            chk2 = r_check2(state, problem)
            state = chk2.state
            istate = jnp.where(
                jnp.logical_and(istate == C.CONTINUE, chk2.close_roots),
                C.CLOSE_ROOTS,
                istate,
            )
            found2 = jnp.logical_and(istate == C.CONTINUE, chk2.found)
            tret = jnp.where(found2, state.tlo, tret)
            state = state._replace(
                tretlast=jnp.where(found2, state.tlo, state.tretlast)
            )
            istate = jnp.where(found2, C.ROOT_RETURN, istate)

            troundoff = 100.0 * _eps(state) * (jnp.abs(state.tn) + jnp.abs(state.hh))
            do3 = jnp.logical_and(
                istate == C.CONTINUE,
                jnp.abs(state.tn - state.tretlast) > troundoff,
            )
            chk3 = r_check3(state, problem, opts, itask == TASK_NORMAL)
            state = tree_where(do3, chk3.state, state)
            found3 = jnp.logical_and(do3, chk3.found)
            state = state._replace(
                irfnd=jnp.where(do3, found3, state.irfnd),
                tretlast=jnp.where(found3, state.tlo, state.tretlast),
            )
            tret = jnp.where(found3, state.tlo, tret)
            istate = jnp.where(found3, C.ROOT_RETURN, istate)

            # ONE_STEP: if an earlier root pre-empted y(tn), return it now
            if itask == TASK_ONE_STEP:
                ret_tn = jnp.logical_and(
                    jnp.logical_and(do3, jnp.logical_not(found3)), irfndp
                )
                st_tn, _ = get_solution(state, state.tn)
                state = tree_where(ret_tn, st_tn, state)
                tret = jnp.where(ret_tn, state.tn, tret)
                state = state._replace(
                    tretlast=jnp.where(ret_tn, state.tn, state.tretlast)
                )
                istate = jnp.where(ret_tn, C.SUCCESS, istate)
            return state, istate, tret

        st_r, istate_r, tret_r = pre_root(state, istate, tret)
        not_first = jnp.logical_not(first)
        state = tree_where(not_first, st_r, state)
        istate = jnp.where(not_first, istate_r, istate)
        tret = jnp.where(not_first, tret_r, tret)

    # ---- pre-step stop tests (nst > 0 only) ----
    st_s, tret_s, istate_s = _stop_test1(state, tout, tret, itask)
    pre_ok = jnp.logical_and(jnp.logical_not(first), istate == C.CONTINUE)
    state = tree_where(pre_ok, st_s, state)
    tret = jnp.where(pre_ok, tret_s, tret)
    istate = jnp.where(pre_ok, istate_s, istate)

    # first-iteration preamble (the loop body runs it at iteration END for
    # the next step; entering lanes need it once here)
    nstloc0 = jnp.zeros(jnp.shape(state.tn), jnp.int32)
    ikind0 = jnp.zeros(jnp.shape(state.tn), jnp.int32)
    itgt0 = jnp.zeros_like(state.tn)
    state, istate, tret, ikind0, itgt0 = _step_preamble(
        state, problem, opts, tol, nstloc0, istate, tret, ikind0, itgt0,
        istate == C.CONTINUE,
    )

    init = _Loop(
        state=state,
        tret=tret,
        istate=istate,
        nstloc=nstloc0,
        saved_t=state.tn,
        ncf=jnp.zeros(jnp.shape(state.tn), jnp.int32),
        nef=jnp.zeros(jnp.shape(state.tn), jnp.int32),
        fresh=jnp.ones(jnp.shape(state.tn), bool),
        ikind=ikind0,
        itgt=itgt0,
    )
    return _run_attempt_loop(init, problem, opts, tol, tout, itask, max_attempts)


class DenseEvents(NamedTuple):
    """Root-crossing events recorded by :func:`solve_dense` (the fused
    dense-output counterpart of the scan form's ROOT_RETURN re-entry loop;
    reference impl_r_check.rs:343-576 locates them, impl_solve.rs:335-359
    returns them one call at a time).

    ``count`` is the TOTAL number of events each lane found; events past
    ``max_events`` are dropped (the first ``max_events`` per lane are kept),
    so ``count > max_events`` flags an undersized buffer."""

    t: jax.Array  # [E, *batch] event times (unused rows = 0)
    iroots: jax.Array  # [E, R, *batch] int32 C sign convention (+1 up, -1 down)
    yy: jax.Array  # [E, N, *batch] solution at the event
    yp: jax.Array  # [E, N, *batch] derivative at the event
    count: jax.Array  # [*batch] int32 total events found (may exceed E)


class _GridLoop(NamedTuple):
    state: IdaState
    istate: jax.Array  # CONTINUE while any grid rows remain for the lane
    nstloc: jax.Array  # per-row internal-step budget (mxstep, reset per row)
    saved_t: jax.Array
    ncf: jax.Array
    nef: jax.Array
    fresh: jax.Array
    gidx: jax.Array  # int32: next grid row to fill (T = done)
    out_tret: jax.Array  # [T, *batch]
    out_ist: jax.Array  # [T, *batch] int32
    out_yy: jax.Array  # [T, N, *batch]
    out_yp: jax.Array  # [T, N, *batch]
    out_nst: jax.Array  # [T, *batch] cumulative lane nst at each row
    eidx: jax.Array  # [*batch] int32: events found so far (E=0 when no roots)
    out_tev: jax.Array  # [E, *batch]
    out_irt: jax.Array  # [E, R, *batch] int32
    out_yev: jax.Array  # [E, N, *batch]
    out_ypev: jax.Array  # [E, N, *batch]


def solve_dense(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    tol: TolControl,
    touts: jax.Array,
    max_events: int = 0,
):
    """Integrate through a whole monotone output grid inside ONE while loop
    — the barrier-free form of ``lax.scan``-over-:func:`solve` (see
    ``IDA.solve_grid``).

    The scan form synchronizes the whole lockstep batch at every grid row:
    no lane may start row i+1 until the slowest lane finishes row i, which
    costs ~40% occupancy on the canonical 12-decade Roberts sweep (each
    decade averages only ~36 steps/lane, PERF.md round 3). Here each lane
    advances its OWN row index ``gidx`` the moment it passes ``touts[gidx]``
    — recording the interpolated solution in-loop — so lanes never wait.

    Semantics per row mirror the NORMAL-mode driver exactly (reference
    impl_solve.rs:69-377 / impl_stop_test.rs:36-211): each lane's stepping
    sequence, interpolated outputs, and per-row status codes are
    bit-identical to the scan form on all-success paths
    (tests/test_dense_output.py). ``tstop`` follows the scan form's
    semantics (impl_stop_test.rs:67-83,177-203): steps clamp to land on
    it, the row whose tout lies beyond gets TSTOP_RETURN at t = tstop,
    tstop_set clears, and later rows integrate past it
    (tests/test_dense_output.py::test_dense_tstop*). Deliberate scope
    limits vs scan-of-solve:

    * a lane whose row FAILS records the failure code at that row and keeps
      integrating toward the next row with fresh budgets — same outcome as
      the scan form's per-leg re-entry — except a first-call input failure
      (ILL_INPUT/BAD_EWT at t0), which freezes the lane and stamps every
      row with that code;
    * quadratures accumulate in ``state.yQ`` but are not recorded per row.

    Rootfinding (``problem.nroots > 0``) requires ``max_events > 0``: root
    crossings are recorded into a SEPARATE per-lane event buffer of that
    static size as they are located, instead of interrupting the sweep the
    way the scan form's ROOT_RETURN does. The event machinery is the same
    r_check2/r_check3 + Illinois stack the scan form runs (reference
    impl_solve.rs:186-227 pre-step re-checks and :335-359 post-step check);
    the only difference is that "return to the caller and re-enter" becomes
    "record and continue", which visits the identical check sequence. A
    lane that finds more than ``max_events`` events keeps integrating and
    counting but drops the extras (``DenseEvents.count`` exposes the true
    total). The r_check2 close-roots condition freezes the lane with
    CLOSE_ROOTS exactly as the scan form returns it.

    Returns ``(state, out_tret [T,*b], out_ist [T,*b], out_yy [T,N,*b],
    out_yp [T,N,*b], out_nst [T,*b])`` — ``out_nst`` is each lane's
    cumulative internal step count when the row was recorded — plus a
    trailing :class:`DenseEvents` when ``problem.nroots > 0``.
    """
    has_roots = problem.nroots > 0
    if has_roots and max_events <= 0:
        raise ValueError(
            "solve_dense: a problem with roots needs max_events > 0 "
            "(static event-buffer size per lane)"
        )
    E = int(max_events) if has_roots else 0
    dtype = state.dtype
    bshape = jnp.shape(state.tn)
    bnd = len(bshape)
    touts = jnp.asarray(touts, dtype)
    T = int(touts.shape[0])
    if touts.ndim == 1 and bnd > 0:
        touts = jnp.broadcast_to(
            touts.reshape((T,) + (1,) * bnd), (T,) + bshape
        )
    from ..utils import take1

    state = state._replace(
        taskc=jnp.asarray(TASK_NORMAL, jnp.int32),
        status=jnp.asarray(C.CONTINUE, jnp.int32),
        toutc=touts[-1],
    )

    first = state.nst == 0
    st_init, istate_init = _first_call_init(state, problem, opts, tol, touts[0])
    state = tree_where(first, st_init, state)
    istate = jnp.where(first, istate_init, C.CONTINUE).astype(jnp.int32)

    zero_i = jnp.zeros(bshape, jnp.int32)
    init = _GridLoop(
        state=state,
        istate=istate,
        nstloc=zero_i,
        saved_t=state.tn,
        ncf=zero_i,
        nef=zero_i,
        fresh=jnp.ones(bshape, bool),
        gidx=zero_i,
        out_tret=jnp.zeros((T,) + bshape, dtype),
        out_ist=jnp.full((T,) + bshape, C.CONTINUE, jnp.int32),
        out_yy=jnp.zeros((T,) + state.yy.shape, dtype),
        out_yp=jnp.zeros((T,) + state.yp.shape, dtype),
        out_nst=jnp.zeros((T,) + bshape, state.nst.dtype),
        eidx=zero_i,
        out_tev=jnp.zeros((E,) + bshape, dtype),
        out_irt=jnp.zeros((E,) + state.iroots.shape, jnp.int32),
        out_yev=jnp.zeros((E,) + state.yy.shape, dtype),
        out_ypev=jnp.zeros((E,) + state.yp.shape, dtype),
    )

    iota_T = jax.lax.broadcasted_iota(jnp.int32, (T,) + bshape, 0)
    iota_E = jax.lax.broadcasted_iota(jnp.int32, (E,) + bshape, 0)

    def record(c, mask, code, t_rec, yy_rec, yp_rec, nstloc, hold=None):
        """Fill row gidx for masked lanes; advance gidx; freeze when done.

        ``hold``: lanes whose istate stamping must be DEFERRED even when
        the final row lands (events still pending in the last step); the
        pending-scan phase stamps them once the scan dries up."""
        row = jnp.logical_and(iota_T == c.gidx, mask)
        out_tret = jnp.where(row, t_rec, c.out_tret)
        out_ist = jnp.where(row, code, c.out_ist).astype(jnp.int32)
        rowN = jnp.expand_dims(row, 1)
        out_yy = jnp.where(rowN, jnp.expand_dims(yy_rec, 0), c.out_yy)
        out_yp = jnp.where(rowN, jnp.expand_dims(yp_rec, 0), c.out_yp)
        out_nst = jnp.where(row, c.state.nst, c.out_nst)
        gidx = c.gidx + mask.astype(jnp.int32)
        done = jnp.logical_and(mask, gidx >= T)
        if hold is not None:
            done = jnp.logical_and(done, jnp.logical_not(hold))
        istate = jnp.where(done, code, c.istate).astype(jnp.int32)
        nstloc = jnp.where(mask, 0, nstloc)
        return c._replace(
            out_tret=out_tret, out_ist=out_ist, out_yy=out_yy, out_yp=out_yp,
            out_nst=out_nst, gidx=gidx, istate=istate, nstloc=nstloc,
        )

    def record_event(c, mask, t_ev, iroots_ev, yy_ev, yp_ev):
        """Append one event row for masked lanes; rows past E are dropped
        but still counted (DenseEvents.count exposes the overflow)."""
        row = jnp.logical_and(iota_E == c.eidx, mask)
        out_tev = jnp.where(row, t_ev, c.out_tev)
        rowR = jnp.expand_dims(row, 1)
        out_irt = jnp.where(rowR, jnp.expand_dims(iroots_ev, 0), c.out_irt)
        out_yev = jnp.where(rowR, jnp.expand_dims(yy_ev, 0), c.out_yev)
        out_ypev = jnp.where(rowR, jnp.expand_dims(yp_ev, 0), c.out_ypev)
        return c._replace(
            eidx=c.eidx + mask.astype(jnp.int32),
            out_tev=out_tev, out_irt=out_irt,
            out_yev=out_yev, out_ypev=out_ypev,
        )

    def body(c: _GridLoop) -> _GridLoop:
        state = c.state
        active = c.istate == C.CONTINUE
        fresh = jnp.logical_and(c.fresh, active)
        tout_cur = take1(touts, jnp.minimum(c.gidx, T - 1))
        # lanes kept alive past their last row only to drain pending root
        # scans (has_roots): no row/step work, only the pend phase below
        rows_left = c.gidx < T
        # events pending in the last step: defer istate stamping (hold)
        hold = state.irfnd if has_roots else None

        # ---- bad-tstop guard (the scan form's _stop_test1 ILL_INPUT,
        # impl_solve.rs:140-155 / impl_stop_test.rs:44-47): a stop time
        # BEHIND tn in the direction of integration is a user input error —
        # without this, attempt_once's clamp would snap tn backward onto
        # tstop and record corrupt rows. Freezing with ILL_INPUT stamps
        # every remaining row through the post-loop unfilled-rows pass,
        # matching the scan form's per-leg ILL_INPUT returns. (nst == 0
        # lanes are already handled by _first_call_init's guard.) ----
        bad_tstop = jnp.logical_and(
            jnp.logical_and(fresh, state.nst > 0),
            jnp.logical_and(
                state.tstop_set,
                (state.tn - state.tstop) * state.hh > 0.0,
            ),
        )
        c = c._replace(
            istate=jnp.where(bad_tstop, C.ILL_INPUT, c.istate).astype(
                jnp.int32
            )
        )
        active = c.istate == C.CONTINUE
        fresh = jnp.logical_and(fresh, active)

        # ---- row fast path (the scan form's _stop_test1, NORMAL): a lane
        # already past its current tout records it WITHOUT stepping; same
        # priority order as the scan form: hit_prev, past_tout, at_tstop
        # (a lane parked at tstop whose tout lies beyond records the row
        # as TSTOP_RETURN at t = tstop and clears tstop_set, after which
        # later rows integrate past it — exactly the scan form's leg
        # sequence, impl_stop_test.rs:67-83) ----
        hit_prev = tout_cur == state.tretlast
        past = (state.tn - tout_cur) * state.hh >= 0.0
        troundoff = 100.0 * _eps(state) * (
            jnp.abs(state.tn) + jnp.abs(state.hh)
        )
        sel_tstop = jnp.logical_and(
            jnp.logical_and(
                state.tstop_set,
                jnp.abs(state.tn - state.tstop) <= troundoff,
            ),
            jnp.logical_not(jnp.logical_or(hit_prev, past)),
        )
        can_fp = jnp.logical_and(
            jnp.logical_and(fresh, state.nst > 0), rows_left
        )
        fp_main = jnp.logical_and(can_fp, jnp.logical_or(hit_prev, past))
        fp_tstop = jnp.logical_and(can_fp, sel_tstop)  # disjoint from main
        fp_any = jnp.logical_or(fp_main, fp_tstop)
        iok = check_t_legal(state, tout_cur)
        yy_fp, yp_fp = jax.lax.cond(
            jnp.any(fp_main),
            lambda: interpolate(state, tout_cur),
            lambda: (state.yy, state.yp),
        )
        # the tstop interpolation runs as its OWN rare cond: feeding a
        # where-select into the main interpolate's time argument measurably
        # reshuffles XLA's fma fusions and breaks the bit-parity contract
        # with the scan form (1-ulp, every row — found by
        # test_dense_tstop_batch_native_per_lane)
        yy_ts, yp_ts = jax.lax.cond(
            jnp.any(fp_tstop),
            lambda: interpolate(state, state.tstop),
            lambda: (state.yy, state.yp),
        )
        # interp applies only on the past-and-legal path (not hit_prev /
        # BAD_T), exactly like get_solution's ok-masked write; the tstop
        # path interpolates unconditionally (scan's get_solution(tstop))
        use_interp = jnp.logical_and(
            jnp.logical_and(past, iok), jnp.logical_not(hit_prev)
        )
        yy_rec = jnp.where(jnp.logical_and(fp_main, use_interp), yy_fp, state.yy)
        yp_rec = jnp.where(jnp.logical_and(fp_main, use_interp), yp_fp, state.yp)
        yy_rec = jnp.where(fp_tstop, yy_ts, yy_rec)
        yp_rec = jnp.where(fp_tstop, yp_ts, yp_rec)
        tgt_fp = jnp.where(fp_tstop, state.tstop, tout_cur)
        fp_code = jnp.where(
            jnp.logical_and(past, jnp.logical_not(jnp.logical_or(hit_prev, iok))),
            C.BAD_T,
            C.SUCCESS,
        )
        fp_code = jnp.where(sel_tstop, C.TSTOP_RETURN, fp_code)
        state = state._replace(
            yy=yy_rec,
            yp=yp_rec,
            tretlast=jnp.where(fp_any, tgt_fp, state.tretlast),
            tstop_set=jnp.logical_and(
                state.tstop_set, jnp.logical_not(fp_tstop)
            ),
        )
        c = c._replace(state=state)
        c = record(c, fp_any, fp_code, tgt_fp, yy_rec, yp_rec, c.nstloc,
                   hold=hold)
        state = c.state
        active = c.istate == C.CONTINUE
        skip = fp_any  # recorded without stepping; re-check next iteration

        # ---- pending root scan (the scan form's pre-step re-checks,
        # impl_solve.rs:186-227, run on re-entry after a ROOT_RETURN):
        # lanes whose last step still holds unsearched (tlo, tn] interval
        # scan it WITHOUT stepping — r_check2 at the last root, then
        # r_check3 over the remainder; each found root records an event
        # and keeps irfnd set so the scan resumes next iteration ----
        if has_roots:
            pend = jnp.logical_and(jnp.logical_and(fresh, state.irfnd),
                                   active)

            def pend_phase(c):
                # recompute pend from the carry so the branch is a pure
                # function of c (bit-identical to the masked inline form)
                state = c.state
                act = c.istate == C.CONTINUE
                pend = jnp.logical_and(
                    jnp.logical_and(jnp.logical_and(c.fresh, act),
                                    state.irfnd),
                    act,
                )
                chk2 = r_check2(state, problem)  # self-skips when ~irfnd
                st_a = tree_where(pend, chk2.state, state)
                close = jnp.logical_and(pend, chk2.close_roots)
                found2 = jnp.logical_and(
                    jnp.logical_and(pend, chk2.found), jnp.logical_not(close)
                )
                # r_check2's probe leaves yy/yp at tlo+smallh; the event row
                # wants y(tlo) (C IDASolve calls IDAGetSolution(tlo) after an
                # RTFOUND from Rcheck2)
                yy_e2, yp_e2 = jax.lax.cond(
                    jnp.any(found2),
                    lambda: interpolate(st_a, st_a.tlo),
                    lambda: (st_a.yy, st_a.yp),
                )
                c = c._replace(state=st_a)
                c = record_event(c, found2, st_a.tlo, st_a.iroots, yy_e2, yp_e2)
                istate2 = jnp.where(close, C.CLOSE_ROOTS, c.istate).astype(
                    jnp.int32
                )
                # r_check3 over the remaining (tlo, tn] — skipped when the
                # interval is within roundoff of empty (impl_solve.rs:203-207;
                # tlo plays tretlast's role: rows overwrite tretlast here)
                troundoff = 100.0 * _eps(st_a) * (
                    jnp.abs(st_a.tn) + jnp.abs(st_a.hh)
                )
                do3 = jnp.logical_and(
                    jnp.logical_and(
                        pend,
                        jnp.logical_not(jnp.logical_or(found2, close)),
                    ),
                    jnp.abs(st_a.tn - st_a.tlo) > troundoff,
                )
                chk3p = r_check3(st_a, problem, opts, True)
                st_b = tree_where(do3, chk3p.state, st_a)
                found3 = jnp.logical_and(do3, chk3p.found)
                c = c._replace(state=st_b)
                c = record_event(
                    c, found3, st_b.tlo, st_b.iroots, st_b.yy, st_b.yp
                )
                irfnd = jnp.where(
                    pend, jnp.logical_or(found2, found3), st_b.irfnd
                )
                # scan drained on a rows-complete lane: stamp the deferred
                # terminal code (the last recorded row's own code). c.gidx,
                # not rows_left: the fast path above may have recorded the
                # final row THIS iteration
                drained = jnp.logical_and(
                    jnp.logical_and(pend, jnp.logical_not(irfnd)),
                    c.gidx >= T,
                )
                istate2 = jnp.where(drained, c.out_ist[T - 1], istate2).astype(
                    jnp.int32
                )
                return c._replace(
                    state=st_b._replace(irfnd=irfnd), istate=istate2
                )

            # cond, not inline-masked: the phase (two root scans with an
            # Illinois loop) is only needed the iteration right after a
            # root was found; running it masked-away every iteration
            # roughly doubled the per-step root cost vs the scan form.
            # All its writes are pend-masked, so skipping is value-exact.
            c = jax.lax.cond(jnp.any(pend), pend_phase, lambda c: c, c)
            state = c.state
            active = c.istate == C.CONTINUE
            skip = jnp.logical_or(skip, pend)

        # ---- per-step preamble at iteration START (scan runs it after its
        # _stop_test1 and before each step; state is identical at either
        # loop boundary, so placement here preserves the scan's ordering) --
        pre = jnp.logical_and(jnp.logical_and(fresh, jnp.logical_not(skip)), active)
        if has_roots:
            # drain-only lanes (rows done, events pending) never step
            pre = jnp.logical_and(pre, rows_left)
        ik0 = jnp.zeros(bshape, jnp.int32)
        it0 = jnp.zeros(bshape, dtype)
        st_p, ist_p, _tret_p, _ikp, _itp = _step_preamble(
            state, problem, opts, tol, c.nstloc, c.istate, state.tn, ik0, it0, pre
        )
        aborted = jnp.logical_and(pre, ist_p != C.CONTINUE)
        # scan records the abort at tret = tn with y(tn) interpolated
        yy_ab, yp_ab = jax.lax.cond(
            jnp.any(aborted),
            lambda: interpolate(st_p, st_p.tn),
            lambda: (st_p.yy, st_p.yp),
        )
        st_p = st_p._replace(
            yy=jnp.where(aborted, yy_ab, st_p.yy),
            yp=jnp.where(aborted, yp_ab, st_p.yp),
            tretlast=jnp.where(aborted, st_p.tn, st_p.tretlast),
        )
        c = c._replace(state=st_p)
        c = record(
            c, aborted, ist_p, st_p.tn, st_p.yy, st_p.yp, c.nstloc
        )
        state = c.state
        active = c.istate == C.CONTINUE
        skip = jnp.logical_or(skip, aborted)

        # ---- the attempt ----
        att = jnp.logical_and(active, jnp.logical_not(skip))
        if has_roots:
            att = jnp.logical_and(att, rows_left)  # drain-only lanes
        saved_t = jnp.where(jnp.logical_and(fresh, att), state.tn, c.saved_t)
        state = step_begin(state, mask=jnp.logical_and(fresh, att))
        z = jnp.zeros((), jnp.int32)
        ncf = jnp.where(jnp.logical_and(fresh, att), z, c.ncf)
        nef = jnp.where(jnp.logical_and(fresh, att), z, c.nef)
        st2, success, fatal, ck, err_k, err_km1, ncf, nef = attempt_once(
            state, problem, opts, saved_t, ncf, nef, active=att
        )
        step_failed = fatal != C.CONTINUE
        st2 = complete_step(st2, problem, opts, err_k, err_km1, ck=ck, mask=success)
        if problem.nquad > 0:
            st2 = accumulate_quad(st2, problem, success)
        nstloc = jnp.where(success, c.nstloc + 1, c.nstloc)
        ok = jnp.logical_and(success, att)

        # ---- per-step root check (the scan form's impl_solve.rs:335-359):
        # a found root records an event in-loop instead of returning ----
        if has_roots:
            chk3 = r_check3(st2, problem, opts, True)
            st2 = tree_where(ok, chk3.state, st2)
            found = jnp.logical_and(ok, chk3.found)
            st2 = st2._replace(irfnd=jnp.logical_or(st2.irfnd, found))
            c = c._replace(state=st2)
            c = record_event(c, found, st2.tlo, st2.iroots, st2.yy, st2.yp)
            hold = st2.irfnd  # fresh events defer this iteration's stamping

        # ---- post-step: fatal failure, row crossing, or landing on tstop
        # records in-loop (the scan form's _stop_test2, NORMAL: past_tout
        # takes priority over at_tstop, impl_stop_test.rs:146-211) ----
        past2 = jnp.logical_and(ok, (st2.tn - tout_cur) * st2.hh >= 0.0)
        tro2 = 100.0 * _eps(st2) * (jnp.abs(st2.tn) + jnp.abs(st2.hh))
        stop2 = jnp.logical_and(
            jnp.logical_and(ok, st2.tstop_set),
            jnp.logical_and(
                jnp.abs(st2.tn - st2.tstop) <= tro2,
                jnp.logical_not(past2),
            ),
        )
        rec_main = jnp.logical_or(step_failed, past2)
        tgt = jnp.where(step_failed, st2.tn, tout_cur)
        yy_po, yp_po = jax.lax.cond(
            jnp.any(rec_main),
            lambda: interpolate(st2, tgt),
            lambda: (st2.yy, st2.yp),
        )
        # separate rare cond for the tstop interpolation — see the fast
        # path's fusion-parity note
        yy_st, yp_st = jax.lax.cond(
            jnp.any(stop2),
            lambda: interpolate(st2, st2.tstop),
            lambda: (st2.yy, st2.yp),
        )
        rec_post = jnp.logical_or(rec_main, stop2)
        tgt = jnp.where(stop2, st2.tstop, tgt)
        st2 = st2._replace(
            yy=jnp.where(stop2, yy_st, jnp.where(rec_main, yy_po, st2.yy)),
            yp=jnp.where(stop2, yp_st, jnp.where(rec_main, yp_po, st2.yp)),
            tretlast=jnp.where(rec_post, tgt, st2.tretlast),
            tstop_set=jnp.logical_and(st2.tstop_set, jnp.logical_not(stop2)),
        )
        code_post = jnp.where(
            step_failed, fatal, jnp.where(stop2, C.TSTOP_RETURN, C.SUCCESS)
        )
        # clamp the next h to land on tstop (scan form clamps per leg in
        # _stop_test1/2; complete_step may have raised h past it)
        clamp = jnp.logical_and(
            jnp.logical_and(st2.tstop_set, ok),
            (st2.tn + st2.hh - st2.tstop) * st2.hh > 0.0,
        )
        st2 = st2._replace(
            hh=jnp.where(
                clamp,
                (st2.tstop - st2.tn) * (1.0 - 4.0 * _eps(st2)),
                st2.hh,
            )
        )
        c = c._replace(state=st2)
        c = record(c, rec_post, code_post, tgt, st2.yy, st2.yp, nstloc,
                   hold=hold)

        return c._replace(
            saved_t=saved_t,
            ncf=ncf,
            nef=nef,
            # a failed-row lane restarts fresh toward the next row, exactly
            # like the scan form's re-entry; recoverable failures retry
            fresh=jnp.logical_or(
                jnp.logical_and(
                    active,
                    jnp.logical_or(skip, jnp.logical_or(success, step_failed)),
                ),
                jnp.logical_and(jnp.logical_not(active), c.fresh),
            ),
        )

    out = jax.lax.while_loop(
        lambda c: jnp.any(c.istate == C.CONTINUE), body, init
    )
    # lanes frozen before filling every row (first-call input failures)
    # stamp their terminal code on the remaining rows
    unfilled = iota_T >= out.gidx
    out_ist = jnp.where(unfilled, out.istate, out.out_ist).astype(jnp.int32)
    out_tret = jnp.where(unfilled, out.state.tn, out.out_tret)
    out_nst = jnp.where(unfilled, out.state.nst, out.out_nst)
    state = out.state._replace(status=out.istate)
    if has_roots:
        events = DenseEvents(
            t=out.out_tev, iroots=out.out_irt,
            yy=out.out_yev, yp=out.out_ypev, count=out.eidx,
        )
        return state, out_tret, out_ist, out.out_yy, out.out_yp, out_nst, events
    return state, out_tret, out_ist, out.out_yy, out.out_yp, out_nst


def _step_preamble(
    state: IdaState, problem, opts, tol, nstloc, istate, tret, ikind, itgt, active
):
    """Per-step guards (impl_solve.rs:249-308): mxstep, ewt refresh +
    positivity, too-much-accuracy. ``active`` marks lanes about to start a
    new step; failing lanes get their abort status/tret/deferred-interp set
    here, so they exit the loop through the ordinary while merge."""
    too_much = jnp.logical_and(active, nstloc >= opts.mxstep)
    refresh = jnp.logical_and(active, state.nst > 0)
    ewt = tol.ewt_set(state.phi[0])
    ewt_bad = jnp.logical_and(
        refresh,
        jnp.any(_ewt_invalid(ewt), axis=tuple(range(ewt.ndim - jnp.ndim(state.tn)))),
    )
    state = state._replace(ewt=jnp.where(refresh, ewt, state.ewt))
    nrm = _norm(state, problem, opts, state.phi[0])
    tolsf = _eps(state) * nrm
    too_acc = jnp.logical_and(active, tolsf > 1.0)
    state = state._replace(tolsf=jnp.where(too_acc, tolsf * 10.0, state.tolsf))

    abort = jnp.logical_or(too_much, jnp.logical_or(ewt_bad, too_acc))
    code = jnp.where(
        too_much, C.TOO_MUCH_WORK, jnp.where(ewt_bad, C.BAD_EWT, C.TOO_MUCH_ACC)
    )
    istate = jnp.where(abort, code, istate).astype(jnp.int32)
    tret = jnp.where(abort, state.tn, tret)
    state = state._replace(tretlast=jnp.where(abort, state.tn, state.tretlast))
    ikind = jnp.where(abort, 1, ikind).astype(jnp.int32)
    itgt = jnp.where(abort, state.tn, itgt)
    return state, istate, tret, ikind, itgt


def _run_attempt_loop(
    init: _Loop, problem, opts, tol, tout, itask, max_attempts: int | None
):
    """The flattened internal loop over step ATTEMPTS (impl_solve.rs:246-373
    + src/lib.rs:613-711 merged): each iteration is one attempt; fresh
    iterations also do the per-step bookkeeping and, on success, the
    completion/root/stop work — one while level instead of two."""
    has_roots = problem.nroots > 0

    def cond(c: _Loop) -> jax.Array:
        return c.istate == C.CONTINUE

    def body(c: _Loop) -> _Loop:
        state, tret, istate = c.state, c.tret, c.istate
        # SELF-MASKED body: every write below is masked so finished lanes
        # pass through bit-identically — the loop needs NO outer merge
        # (the full-state select was ~180 MB/iteration at B=65536).
        active = c.istate == C.CONTINUE
        fresh = jnp.logical_and(c.fresh, active)

        # step begin: save tn, first-step init, reset local failure counters.
        # (The per-step preamble — mxstep/ewt/accuracy guards — runs at the
        # END of the previous iteration via _step_preamble, so aborting
        # lanes exit through the normal lane freeze instead of a dedicated
        # full-state select here.)
        saved_t = jnp.where(fresh, state.tn, c.saved_t)
        state = step_begin(state, mask=fresh)
        zero_i = jnp.zeros((), jnp.int32)
        ncf = jnp.where(fresh, zero_i, c.ncf)
        nef = jnp.where(fresh, zero_i, c.nef)

        # ---- the attempt ----
        st2, success, fatal, ck, err_k, err_km1, ncf, nef = attempt_once(
            state, problem, opts, saved_t, ncf, nef, active=active
        )
        step_failed = fatal != C.CONTINUE

        # ---- success epilogue (src/lib.rs:697-708); mask folded into the
        # routine's own updates — no phi-sized merge select ----
        st2 = complete_step(
            st2, problem, opts, err_k, err_km1, ck=ck, mask=success
        )

        # quadrature accumulation for the accepted step (IDAS quadrature
        # role, core/quad.py): post-complete_step phi/psi are exactly the
        # interpolant C IDAGetSolution would evaluate for this step
        if problem.nquad > 0:
            st2 = accumulate_quad(st2, problem, success)

        # on fatal attempt failure: interpolate y(tn), tret = tn
        # (deferred: the lane freezes at exit, so the single post-loop
        # interpolation is bit-identical to doing it here every attempt)
        fail = step_failed
        ikind = jnp.where(fail, 1, c.ikind).astype(jnp.int32)
        itgt = jnp.where(fail, st2.tn, c.itgt)
        tret = jnp.where(fail, st2.tn, tret)
        st2 = st2._replace(tretlast=jnp.where(fail, st2.tn, st2.tretlast))
        istate = jnp.where(step_failed, fatal, istate).astype(jnp.int32)
        nstloc = jnp.where(success, c.nstloc + 1, c.nstloc)

        ok = jnp.logical_and(istate == C.CONTINUE, success)

        # per-step root check (impl_solve.rs:335-359)
        if has_roots:
            chk3 = r_check3(st2, problem, opts, itask == TASK_NORMAL)
            st2 = tree_where(ok, chk3.state, st2)
            found = jnp.logical_and(ok, chk3.found)
            st2 = st2._replace(
                irfnd=jnp.logical_or(st2.irfnd, found),
                tretlast=jnp.where(found, st2.tlo, st2.tretlast),
            )
            tret = jnp.where(found, st2.tlo, tret)
            istate = jnp.where(found, C.ROOT_RETURN, istate)
            ok = jnp.logical_and(istate == C.CONTINUE, success)

        # post-step stop tests (interpolation deferred to after the loop)
        st3, tret3, istate3, ikind3, itgt3 = _stop_test2(st2, tout, tret, itask)
        st2 = tree_where(ok, st3, st2)
        tret = jnp.where(ok, tret3, tret)
        istate = jnp.where(ok, istate3, istate)
        ikind = jnp.where(ok, ikind3, ikind).astype(jnp.int32)
        itgt = jnp.where(ok, itgt3, itgt)

        # ---- preamble for the NEXT step (lanes that continue) ----
        nxt = jnp.logical_and(istate == C.CONTINUE, success)
        st2, istate, tret, ikind, itgt = _step_preamble(
            st2, problem, opts, tol, nstloc, istate, tret, ikind, itgt, nxt
        )

        return _Loop(
            state=st2,
            tret=tret,
            istate=istate,
            nstloc=nstloc,
            saved_t=saved_t,
            ncf=ncf,
            nef=nef,
            # retry the same step unless the attempt landed; frozen lanes
            # keep their carried value (self-masked contract). Logical
            # algebra, not a bool select (a removed Pallas kernel's form).
            fresh=jnp.logical_or(
                jnp.logical_and(active, success),
                jnp.logical_and(jnp.logical_not(active), c.fresh),
            ),
            ikind=ikind,
            itgt=itgt,
        )

    def apply_deferred_interp(out: _Loop) -> IdaState:
        """The single post-loop interpolation (see _stop_test2 docstring)."""
        st_i, _ = get_solution(out.state, out.itgt)
        return tree_where(out.ikind > 0, st_i, out.state)

    if max_attempts is None:
        # the body is fully self-masked (finished lanes pass through
        # bit-identically), so the loop needs no per-leaf merge
        out = jax.lax.while_loop(lambda c: jnp.any(cond(c)), body, init)
        state = apply_deferred_interp(out)._replace(status=out.istate)
        return state, out.tret, out.istate

    # fixed trip count: a masked fori_loop (reverse-differentiable, unlike
    # a data-dependent while). Lanes
    # needing more attempts come back with istate == CONTINUE plus the loop
    # carry for exact host-side resumption. The deferred interpolation is
    # applied at every budget boundary (idempotent on frozen lanes), but
    # NOT folded back into the carry state, so resumed lanes continue from
    # the uninterpolated state exactly as the while path would.
    def fbody(_, c: _Loop) -> _Loop:
        return body(c)  # self-masked: safe to run past lane completion

    if opts.remat_attempts:
        # store only the loop carry for the backward pass; recompute the
        # attempt's internals (Newton iterates, factors) during the VJP
        fbody = jax.checkpoint(fbody)

    # int-carried fori (see utils/tree.py)
    out = int_carry_fori_loop(0, max_attempts, fbody, init)
    state = apply_deferred_interp(out)._replace(status=out.istate)
    carry = (
        out.tret, out.istate, out.nstloc, out.saved_t, out.ncf, out.nef,
        out.fresh, out.ikind, out.itgt,
    )
    return state, out.tret, out.istate, carry
