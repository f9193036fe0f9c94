"""Successful-step completion: order/stepsize selection and phi update (L4).

Behavioural spec: reference ``complete_step``
(src/impl_complete_step.rs:22-177): increment counters, startup
(phase 0) order-raise/step-double policy, steady-state (phase 1)
Lower/Maintain/Raise order selection from truncation error norms, stepsize
ratio selection, and the phi-array update recurrence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants as C
from ..problem import IdaProblem
from .error_test import _norm
from ..utils import take_row
from ..utils.ad_mode import smask_den, spow
from .state import IdaState, IdaOptions
from ..utils.profiling import scope

_LOWER, _MAINTAIN, _RAISE = 0, 1, 2


@scope("complete_step")
def complete_step(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    err_k: jax.Array,
    err_km1: jax.Array,
    ck: jax.Array | None = None,
    mask: jax.Array | None = None,
) -> IdaState:
    """``mask`` (per-lane bool) folds the caller's success-merge INTO this
    routine's own masked updates: lanes with mask=False pass through
    bit-identically, so the caller needs no full-state select afterwards —
    the phi-sized merge was one of the most expensive fusions on an
    earlier accelerator (not yet measured on the GPU). When
    ``ck`` is given, the success path's ``ee *= ck`` (src/lib.rs:708) is
    applied here under the same mask."""
    dtype = state.dtype
    if mask is None:
        mask = jnp.ones(jnp.shape(state.tn), bool)
    nst = state.nst + 1
    kdiff = state.kk - state.kused  # (impl_complete_step.rs:27)
    kused = state.kk
    hused = state.hh

    phase = jnp.where(
        jnp.logical_or(state.knew == state.kk - 1, state.kk == opts.maxord),
        jnp.asarray(1, jnp.int32),
        state.phase,
    )

    # ---- phase 0: raise order and double step (impl_complete_step.rs:43-52)
    hnew0 = 2.0 * state.hh
    tmp0 = jnp.abs(hnew0) * state.hmax_inv
    hnew0 = jnp.where(tmp0 > 1.0, hnew0 / smask_den(tmp0), hnew0)
    do_startup_grow = jnp.logical_and(phase == 0, nst > 1)
    kk_p0 = jnp.where(do_startup_grow, state.kk + 1, state.kk)
    hh_p0 = jnp.where(do_startup_grow, hnew0, state.hh)
    rr_p0 = state.rr

    # ---- phase 1: order selection (impl_complete_step.rs:54-121)
    kkf = state.kk.astype(dtype)
    # err_kp1 estimate from ||ee - phi[kk+1]|| (impl_complete_step.rs:74-78);
    # index clamped: the estimate is only used when kk < maxord
    kp1_idx = jnp.minimum(state.kk + 1, C.MXORDP1 - 1)
    enorm_kp1 = _norm(state, problem, opts, state.ee - take_row(state.phi, kp1_idx))
    err_kp1 = enorm_kp1 / (kkf + 2.0)

    terr_k = (kkf + 1.0) * err_k
    terr_kp1 = (kkf + 2.0) * err_kp1
    terr_km1 = kkf * err_km1

    # kk == 1 branch (impl_complete_step.rs:85-90)
    action_k1 = jnp.where(terr_kp1 >= 0.5 * terr_k, _MAINTAIN, _RAISE)
    # kk > 1 branch (impl_complete_step.rs:91-100)
    action_kN = jnp.where(
        terr_km1 <= jnp.minimum(terr_k, terr_kp1),
        _LOWER,
        jnp.where(terr_kp1 >= terr_k, _MAINTAIN, _RAISE),
    )
    action = jnp.where(state.kk == 1, action_k1, action_kN)
    # short-circuit cases that skip the err_kp1 estimate entirely
    # (impl_complete_step.rs:63-68)
    action = jnp.where(
        jnp.logical_or(state.kk + 1 >= state.ns, kdiff == 1), _MAINTAIN, action
    )
    action = jnp.where(state.kk == opts.maxord, _MAINTAIN, action)
    action = jnp.where(state.knew == state.kk - 1, _LOWER, action)

    kk_p1 = state.kk + jnp.where(action == _RAISE, 1, jnp.where(action == _LOWER, -1, 0))
    err_knew = jnp.where(
        action == _RAISE, err_kp1, jnp.where(action == _LOWER, err_km1, err_k)
    )

    # stepsize ratio rr = (2*err_knew + 1e-4)^(-1/(kk+1)) (impl_complete_step.rs:126-146)
    base = 2.0 * err_knew + 1.0e-4
    rr_p1 = spow(base, -1.0 / (kk_p1.astype(dtype) + 1.0))
    hnew1_double = 2.0 * state.hh
    tmp1 = jnp.abs(hnew1_double) * state.hmax_inv
    hnew1_double = jnp.where(tmp1 > 1.0, hnew1_double / smask_den(tmp1), hnew1_double)
    rr_clamped = jnp.maximum(0.5, jnp.minimum(0.9, rr_p1))
    hh_p1 = jnp.where(
        rr_p1 >= 2.0,
        hnew1_double,
        jnp.where(rr_p1 <= 1.0, state.hh * rr_clamped, state.hh),
    )
    rr_p1_out = jnp.where(rr_p1 <= 1.0, rr_clamped, rr_p1)

    in_phase0 = phase == 0
    kk = jnp.where(in_phase0, kk_p0, kk_p1).astype(jnp.int32)
    hh = jnp.where(in_phase0, hh_p0, hh_p1)
    rr = jnp.where(in_phase0, rr_p0, rr_p1_out)

    # ONE phi construction for both updates (each row is touched by exactly
    # one of them, so fusing is exact and saves a full [K1,N,B] write+read):
    # * save ee into phi[kused+1] for a possible order raise
    #   (impl_complete_step.rs:152-156) — row kused+1 only;
    # * the update recurrence walking rows kused..0
    #   (impl_complete_step.rs:158-176): tmp = ee; tmp += phi[j]; phi[j] = tmp.
    # fast_math: phi holds UNSCALED rows; the recurrence consumes the
    # phi-star value phi[j]*s[j] on the fly (same single rounding as the
    # parity mode's pre-materialized multiply) and writes TRUE phi rows,
    # restoring the unscaled invariant for the next step.
    phi = state.phi
    if opts.fast_math:
        from .coeffs import phi_star_scale

        s = phi_star_scale(state)
    save = jnp.logical_and(kused < opts.maxord, mask)
    tmp = state.ee
    rows = []
    for j in range(C.MXORDP1 - 1, -1, -1):
        active = jnp.logical_and(j <= kused, mask)
        phi_j = phi[j] * jnp.expand_dims(s[j], 0) if opts.fast_math else phi[j]
        new_tmp = tmp + phi_j
        row = jnp.where(active, new_tmp, phi[j])
        # the saved-ee row: j == kused+1 (never inside the recurrence range)
        row = jnp.where(jnp.logical_and(save, j == kused + 1), state.ee, row)
        tmp = jnp.where(active, new_tmp, tmp)
        rows.append(row)
    phi = jnp.stack(rows[::-1], axis=0)

    ee = state.ee if ck is None else jnp.where(mask, state.ee * ck, state.ee)
    m = mask
    return state._replace(
        nst=jnp.where(m, nst, state.nst),
        kused=jnp.where(m, kused, state.kused),
        hused=jnp.where(m, hused, state.hused),
        phase=jnp.where(m, phase, state.phase),
        kk=jnp.where(m, kk, state.kk),
        hh=jnp.where(m, hh, state.hh),
        rr=jnp.where(m, rr, state.rr),
        phi=phi,
        ee=ee,
    )
