"""One internal BDF step tn -> tn + hh, with retries (L4 core).

Behavioural spec: reference ``step`` (src/lib.rs:613-711) and
``handle_n_flag`` (src/lib.rs:1120-1244):

    loop {
      set_coeffs -> advance tn (tstop roundoff clamp) -> predict
      -> nonlinear_solve -> test_error
      on failure: restore + handle_n_flag (+ reset if nst == 0), retry
    } then complete_step, ee *= ck

Design: the Rust retry loop with Result early-exits becomes a
masked ``while_loop`` whose carry holds local failure counters (ncf/nef) and
a done/fatal lane per instance.

Note: the reference's tstop clamp compares against ``one()``
(src/lib.rs:655) — a port bug; C IDA clamps when ``(tn - tstop)*hh > 0``.
We implement the C semantics (SURVEY.md §2.4).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..problem import IdaProblem
from ..utils import masked_while_loop, tree_where
from ..utils.ad_mode import smask_den, spow
from .coeffs import set_coeffs, predict, restore, reset
from .complete_step import complete_step
from .error_test import error_test
from .nls import nonlinear_solve
from .state import IdaState, IdaOptions
from ..utils.profiling import scope


class _Attempt(NamedTuple):
    state: IdaState
    ck: jax.Array
    err_k: jax.Array
    err_km1: jax.Array
    ncf: jax.Array  # int32 local convergence-failure counter
    nef: jax.Array  # int32 local error-test-failure counter
    done: jax.Array  # bool: success
    fatal: jax.Array  # int32 fatal status (CONTINUE while fine)


def _handle_n_flag(
    state: IdaState,
    opts: IdaOptions,
    kind: jax.Array,  # REC_CONV / REC_LSETUP / ... or ERROR_TEST_FAIL
    err_k: jax.Array,
    err_km1: jax.Array,
    ncf: jax.Array,
    nef: jax.Array,
    mask: jax.Array | None = None,
) -> Tuple[IdaState, jax.Array, jax.Array, jax.Array]:
    """Failure policy (reference src/lib.rs:1120-1244). Returns
    (state, ncf, nef, fatal_status). ``mask`` folds the caller's
    failure-merge into the state writes (masked-out lanes pass through)."""
    dtype = state.dtype
    if mask is None:
        mask = jnp.ones(jnp.shape(state.tn), bool)
    state = state._replace(
        phase=jnp.where(mask, jnp.asarray(1, jnp.int32), state.phase)
    )
    is_etf = kind == C.ERROR_TEST_FAIL

    # ---------- error test failure branch (src/lib.rs:1143-1198) ----------
    nef_new = nef + 1
    err_knew = jnp.where(state.kk == state.knew, err_k, err_km1)
    kk1 = state.knew
    rr1 = 0.9 * spow(
        2.0 * err_knew + 1.0e-4, -1.0 / (kk1.astype(dtype) + 1.0)
    )
    rr1 = jnp.maximum(0.25, jnp.minimum(0.9, rr1))
    # nef == 1 -> (knew, rr1); nef == 2 -> (knew, 0.25); nef >= 3 -> (1, 0.25)
    kk_etf = jnp.where(nef_new >= 3, jnp.asarray(1, jnp.int32), kk1)
    rr_etf = jnp.where(nef_new == 1, rr1, jnp.asarray(0.25, dtype))
    etf_fatal = nef_new >= opts.maxnef

    # ---------- recoverable convergence failure branch (src/lib.rs:1201-1237)
    ncf_new = ncf + 1
    rr_cf = jnp.where(
        kind == C.REC_CONSTRAINT, state.rr, jnp.asarray(0.25, dtype)
    )
    cf_fatal = ncf_new >= opts.maxncf
    # fatal code at maxncf keyed on the recoverable kind (C IDAHandleNFlag;
    # reference error.rs:3-15): repeated residual failures => REP_RES_ERR,
    # lsetup => LSETUP_FAIL, lsolve => LSOLVE_FAIL, constraint =>
    # CONSTR_FAIL, plain Newton non-convergence => CONV_FAIL
    cf_fatal_code = jnp.where(
        kind == C.REC_RESIDUAL,
        C.REP_RES_ERR,
        jnp.where(
            kind == C.REC_CONSTRAINT,
            C.CONSTR_FAIL,
            jnp.where(
                kind == C.REC_LSETUP,
                C.LSETUP_FAIL,
                jnp.where(kind == C.REC_LSOLVE, C.LSOLVE_FAIL, C.CONV_FAIL),
            ),
        ),
    )

    kk = jnp.where(is_etf, kk_etf, state.kk)
    rr = jnp.where(is_etf, rr_etf, rr_cf)
    hh = state.hh * rr
    nef = jnp.where(is_etf, nef_new, nef)
    ncf = jnp.where(is_etf, ncf, ncf_new)
    # bool->counter-dtype casts, NOT jnp.where(?, 1, 0): a weak-int where
    # materializes a default-int (int64 under x64) tensor
    netf = state.netf + jnp.logical_and(is_etf, mask).astype(state.netf.dtype)
    ncfn = state.ncfn + jnp.logical_and(
        jnp.logical_not(is_etf), mask
    ).astype(state.ncfn.dtype)

    fatal = jnp.where(
        is_etf,
        jnp.where(etf_fatal, C.ERR_FAIL, C.CONTINUE),
        jnp.where(cf_fatal, cf_fatal_code, C.CONTINUE),
    ).astype(jnp.int32)

    m = mask
    state = state._replace(
        kk=jnp.where(m, kk, state.kk),
        rr=jnp.where(m, rr, state.rr),
        hh=jnp.where(m, hh, state.hh),
        netf=netf,
        ncfn=ncfn,
    )
    return state, ncf, nef, fatal


@scope("step.begin")
def step_begin(state: IdaState, mask: jax.Array | None = None) -> IdaState:
    """First-step initialisation at the start of a fresh step
    (src/lib.rs:619-627). ``mask`` restricts the (nst == 0) init to the
    given lanes so the caller needs no outer select."""
    dtype = state.dtype
    first = state.nst == 0
    if mask is not None:
        first = jnp.logical_and(first, mask)
    return state._replace(
        kk=jnp.where(first, jnp.asarray(1, jnp.int32), state.kk),
        kused=jnp.where(first, jnp.asarray(0, jnp.int32), state.kused),
        hused=jnp.where(first, jnp.zeros((), dtype), state.hused),
        psi=jnp.where(
            jnp.logical_and(
                first,
                jnp.arange(C.MXORDP1, dtype=jnp.int32).reshape(
                    (C.MXORDP1,) + (1,) * jnp.ndim(state.hh)
                )
                == 0,
            ),
            state.hh,
            state.psi,
        ),
        cj=jnp.where(first, 1.0 / smask_den(state.hh), state.cj),
        phase=jnp.where(first, jnp.asarray(0, jnp.int32), state.phase),
        ns=jnp.where(first, jnp.asarray(0, jnp.int32), state.ns),
    )


@scope("step.attempt")
def attempt_once(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    saved_t: jax.Array,
    ncf: jax.Array,
    nef: jax.Array,
    active: jax.Array | None = None,
):
    """One step attempt: set_coeffs -> advance -> predict -> nonlinear solve
    -> error test; on failure restore + handle_n_flag (+ reset). The single
    building block shared by step() and the flattened solve loop.

    Returns (state, success, fatal, ck, err_k, err_km1, ncf, nef).

    ``active``: self-masked contract — lanes with active=False pass through
    bit-identically (success=False, fatal=CONTINUE, ncf/nef unchanged), so
    the caller's loop needs no outer full-state merge.
    """
    dtype = state.dtype
    if active is None:
        active = jnp.ones(jnp.shape(state.tn), bool)
    if opts.debug_trace:
        # per-attempt state dump (reference src/lib.rs:635-639)
        from ..utils.trace import trace_sink, TRACE_FIELDS

        jax.debug.callback(
            trace_sink,
            ordered=True,
            **{f: getattr(state, f) for f in TRACE_FIELDS},
        )

    st, ck = set_coeffs(state, mask=active, fast_math=opts.fast_math)

    # advance tn, clamping to tstop against roundoff (C semantics)
    tn = st.tn + st.hh
    past_tstop = jnp.logical_and(st.tstop_set, (tn - st.tstop) * st.hh > 0.0)
    tn = jnp.where(past_tstop, st.tstop, tn)
    st = st._replace(tn=jnp.where(active, tn, st.tn))

    st = predict(st, mask=active, fast_math=opts.fast_math)
    st, nl_status = nonlinear_solve(st, problem, opts, active=active)

    st, etr = error_test(st, problem, opts, ck, mask=active)
    nl_ok = nl_status == C.REC_NONE
    success = jnp.logical_and(
        jnp.logical_and(nl_ok, etr.converged), active
    )
    kind = jnp.where(nl_ok, C.ERROR_TEST_FAIL, nl_status).astype(jnp.int32)
    # error norms are only meaningful when the NLS succeeded
    err_k = jnp.where(nl_ok, etr.err_k, jnp.zeros((), dtype))
    err_km1 = jnp.where(nl_ok, etr.err_km1, jnp.zeros((), dtype))

    # failure path: restore, adjust h/k, maybe reset (src/lib.rs:676-689).
    # All three routines take the failure mask and edit in place — lanes
    # that succeeded (or are inactive) pass through bit-identically, so NO
    # full-state select is needed (phi-sized merges were the costliest
    # fusions).
    fail = jnp.logical_and(jnp.logical_not(success), active)
    st = restore(st, saved_t, mask=fail, fast_math=opts.fast_math)
    st, ncf_f, nef_f, fatal = _handle_n_flag(
        st, opts, kind, err_k, err_km1, ncf, nef, mask=fail
    )
    st = reset(
        st,
        mask=jnp.logical_and(
            jnp.logical_and(fail, fatal == C.CONTINUE), st.nst == 0
        ),
    )

    fatal = jnp.where(fail, fatal, jnp.asarray(C.CONTINUE, jnp.int32)).astype(jnp.int32)
    ncf = jnp.where(fail, ncf_f, ncf)
    nef = jnp.where(fail, nef_f, nef)
    return st, success, fatal, ck, err_k, err_km1, ncf, nef


def step(state: IdaState, problem: IdaProblem, opts: IdaOptions) -> IdaState:
    """Take one internal step; on fatal failure sets state.status.

    (Standalone form; the production solve loop uses attempt_once directly
    in its flattened while loop.)"""
    dtype = state.dtype
    saved_t = state.tn
    state = step_begin(state)

    def cond(c: _Attempt) -> jax.Array:
        return jnp.logical_and(jnp.logical_not(c.done), c.fatal == C.CONTINUE)

    def body(c: _Attempt) -> _Attempt:
        st, success, fatal, ck, err_k, err_km1, ncf, nef = attempt_once(
            c.state, problem, opts, saved_t, c.ncf, c.nef
        )
        return _Attempt(
            state=st,
            ck=jnp.where(success, ck, c.ck),
            err_k=jnp.where(success, err_k, c.err_k),
            err_km1=jnp.where(success, err_km1, c.err_km1),
            ncf=ncf,
            nef=nef,
            done=success,
            fatal=fatal,
        )

    z = jnp.zeros((), dtype)
    init = _Attempt(
        state=state,
        ck=z,
        err_k=z,
        err_km1=z,
        ncf=jnp.zeros((), jnp.int32),
        nef=jnp.zeros((), jnp.int32),
        done=jnp.asarray(False),
        fatal=jnp.asarray(C.CONTINUE, jnp.int32),
    )
    out = masked_while_loop(cond, body, init)
    state = out.state

    # success epilogue (src/lib.rs:697-708); mask folded in — no full merge
    state = complete_step(
        state, problem, opts, out.err_k, out.err_km1, ck=out.ck, mask=out.done
    )

    # fatal failures land in the status lane
    state = state._replace(
        status=jnp.where(out.done, state.status, out.fatal).astype(jnp.int32)
    )
    return state
