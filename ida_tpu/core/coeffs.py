"""BDF coefficient recurrences, predictor, and failure restore (L4 layer).

Behavioural spec: reference ``set_coeffs`` (src/lib.rs:722-782), ``predict``
(src/lib.rs:894-959), ``restore`` (src/lib.rs:1044-1083), ``reset``
(src/lib.rs:1249-1252).

Design: the reference's data-dependent loops over the current
order ``kk`` become unrolled straight-line code over the static MAXORD bound
with per-index masks — no dynamic shapes, identical arithmetic order for the
lanes that are active, so individual trajectories match the reference to
rounding.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..utils import take1
from ..utils.ad_mode import smask_den
from .state import IdaState
from ..utils.profiling import scope


def phi_star_scale(state: IdaState) -> jax.Array:
    """The implicit phi -> phi-star row scale of fast_math mode: beta on
    rows ns..kk, exact 1.0 elsewhere ([K1, *batch]). With
    ``IdaOptions.fast_math`` the phi array stays UNSCALED in the state and
    every phi-star consumer multiplies by this per-row factor on the fly
    (see the option's docstring in core/state.py)."""
    bnd = jnp.ndim(state.kk)
    idx = jnp.arange(C.MXORDP1, dtype=jnp.int32).reshape(
        (C.MXORDP1,) + (1,) * bnd
    )
    sel = jnp.logical_and(idx >= state.ns, idx <= state.kk)
    return jnp.where(sel, state.beta, jnp.ones((), state.dtype))


@scope("set_coeffs")
def set_coeffs(
    state: IdaState,
    mask: jax.Array | None = None,
    fast_math: bool = False,
) -> Tuple[IdaState, jax.Array]:
    """Compute method coefficients for the current (hh, kk); returns
    (state, ck) where ck is the variable-stepsize error coefficient.

    ``mask``: lanes with mask=False pass through bit-identically (their ck
    output is unspecified) — lets a self-masked loop body skip the outer
    full-state merge.

    ``fast_math``: leave phi UNSCALED (consumers apply
    :func:`phi_star_scale` on the fly), saving the [K1,N,B] write+read."""
    dtype = state.dtype
    kk = state.kk
    if mask is None:
        mask = jnp.ones(jnp.shape(state.tn), bool)

    # ns tracking (src/lib.rs:727-731)
    ns_new = jnp.where(
        jnp.logical_or(state.hh != state.hused, state.kk != state.kused),
        jnp.asarray(0, jnp.int32),
        state.ns,
    )
    ns_new = jnp.minimum(ns_new + 1, state.kused + 2)
    ns = jnp.where(mask, ns_new, state.ns)

    update = jnp.logical_and(kk + 1 >= ns, mask)  # (src/lib.rs:731)

    one = jnp.asarray(1.0, dtype)
    zero = jnp.zeros((), dtype)
    hh = state.hh

    # Whole-array form of the reference recurrence (src/lib.rs:732-748).
    # Unwinding the loop algebraically: with temp1 starting at hh and
    # becoming psi_old[i-1] + hh each round,
    #   psi_new[0]  = hh,            psi_new[i] = psi_old[i-1] + hh
    #   alpha_new[0] = 1,            alpha_new[i] = hh / psi_new[i]
    #   beta_new[0]  = 1,   beta_new[i]  = beta_new[i-1]*psi_new[i-1]/psi_old[i-1]
    #   sigma_new[0] = 1,   sigma_new[i] = (i*sigma_new[i-1])*alpha_new[i]
    #   gamma_new[0] = 0,   gamma_new[i] = gamma_new[i-1] + alpha_new[i-1]/hh
    # Candidate rows are computed wholesale (identical multiply/divide order
    # to the reference for every row that ends up selected — golden tests
    # assert this at rtol 1e-12) and ONE masked select per array keeps rows
    # > kk / non-updating lanes bit-identical. This replaces ~25 interleaved
    # per-row wheres with 5 whole-[K1,B] selects — measured as a material
    # HBM-byte cut on the batch-native path (PERF.md round 3).
    psi_o = state.psi
    psi_n = jnp.concatenate([jnp.broadcast_to(hh, psi_o[:1].shape), psi_o[:-1] + hh])
    alpha_rows = [jnp.broadcast_to(one, jnp.shape(hh))]
    for i in range(1, C.MXORDP1):
        alpha_rows.append(hh / smask_den(psi_n[i]))
    beta_rows = [jnp.broadcast_to(one, jnp.shape(hh))]
    sigma_rows = [jnp.broadcast_to(one, jnp.shape(hh))]
    gamma_rows = [jnp.broadcast_to(zero, jnp.shape(hh))]
    for i in range(1, C.MXORDP1):
        beta_rows.append(beta_rows[i - 1] * psi_n[i - 1] / smask_den(psi_o[i - 1]))
        sigma_rows.append((i * sigma_rows[i - 1]) * alpha_rows[i])
        gamma_rows.append(gamma_rows[i - 1] + alpha_rows[i - 1] / smask_den(hh))
    alpha_n = jnp.stack(alpha_rows)
    beta_n = jnp.stack(beta_rows)
    sigma_n = jnp.stack(sigma_rows)
    gamma_n = jnp.stack(gamma_rows)

    bnd0 = jnp.ndim(kk)
    idx0 = jnp.arange(C.MXORDP1, dtype=jnp.int32).reshape((C.MXORDP1,) + (1,) * bnd0)
    row_act = jnp.logical_and(update, idx0 <= kk)
    psi = jnp.where(row_act, psi_n, psi_o)
    alpha = jnp.where(row_act, alpha_n, state.alpha)
    beta = jnp.where(row_act, beta_n, state.beta)
    sigma = jnp.where(row_act, sigma_n, state.sigma)
    gamma = jnp.where(row_act, gamma_n, state.gamma)

    # alphas, alpha0 sums over i = 0..kk-1 (src/lib.rs:750-756)
    bnd = jnp.ndim(kk)  # trailing batch dims (0 normally; 1 batch-native)
    idx = jnp.arange(C.MXORDP1, dtype=jnp.int32).reshape((C.MXORDP1,) + (1,) * bnd)
    in_sum = idx < kk
    alphas = -jnp.sum(
        jnp.where(in_sum, 1.0 / (idx + 1.0), 0.0), axis=0
    ).astype(dtype)
    alpha0 = -jnp.sum(jnp.where(in_sum, alpha, 0.0), axis=0)

    # leading coefficient cj, saving cjlast (src/lib.rs:758-760)
    cjlast = jnp.where(mask, state.cj, state.cjlast)
    cj = jnp.where(mask, -alphas / smask_den(state.hh), state.cj)

    # error coefficient ck (src/lib.rs:762-764)
    alpha_kk = take1(alpha, kk)
    ck = jnp.abs(alpha_kk + alphas - alpha0)
    ck = jnp.maximum(ck, alpha_kk)

    # phi -> phi-star: scale rows ns..kk by beta (src/lib.rs:766-779);
    # fast_math defers this multiply into the consumers (phi_star_scale)
    if fast_math:
        phi = state.phi
    else:
        scale_row = jnp.logical_and(jnp.logical_and(idx >= ns, idx <= kk), mask)
        phi = state.phi * jnp.expand_dims(jnp.where(scale_row, beta, 1.0), 1)

    state = state._replace(
        ns=ns, psi=psi, alpha=alpha, beta=beta, sigma=sigma, gamma=gamma,
        cj=cj, cjlast=cjlast, phi=phi,
    )
    return state, ck


@scope("predict")
def predict(
    state: IdaState,
    mask: jax.Array | None = None,
    fast_math: bool = False,
) -> IdaState:
    """Predictor: yypredict = sum_{j<=kk} phi[j], yppredict = sum_{1<=j<=kk}
    gamma[j] phi[j] (src/lib.rs:894-959). ``mask`` as in set_coeffs.

    (A stacked two-output reduction measured the same or slightly slower
    on an earlier accelerator — XLA streams phi through the two separate
    reduces — so the straightforward form stays; not yet measured on the
    GPU.)

    ``fast_math``: phi is unscaled; fold :func:`phi_star_scale` into the
    per-row coefficients ([K1,B] arithmetic — zero extra phi bytes). The
    yy sum is bit-identical (the 0/1 row mask times beta is exact); the yp
    sum re-associates phi*(beta*gamma) and may differ by ~1 ulp."""
    bnd = jnp.ndim(state.kk)
    idx = jnp.arange(C.MXORDP1, dtype=jnp.int32).reshape((C.MXORDP1,) + (1,) * bnd)
    yy_mask = (idx <= state.kk).astype(state.dtype)
    yp_coef = jnp.where(jnp.logical_and(idx >= 1, idx <= state.kk), state.gamma, 0.0)
    if fast_math:
        s = phi_star_scale(state)
        yy_mask = yy_mask * s
        yp_coef = yp_coef * s
    yypredict = jnp.sum(state.phi * jnp.expand_dims(yy_mask, 1), axis=0)
    yppredict = jnp.sum(state.phi * jnp.expand_dims(yp_coef, 1), axis=0)
    if mask is not None:
        yypredict = jnp.where(mask, yypredict, state.yypredict)
        yppredict = jnp.where(mask, yppredict, state.yppredict)
    return state._replace(yypredict=yypredict, yppredict=yppredict)


@scope("restore")
def restore(
    state: IdaState,
    saved_t: jax.Array,
    mask: jax.Array | None = None,
    fast_math: bool = False,
) -> IdaState:
    """Undo a failed step attempt: restore tn and psi, un-scale phi-star
    back to phi (src/lib.rs:1044-1083).

    ``mask`` folds the caller's failure-merge into this routine's own masked
    updates (lanes with mask=False pass through bit-identically), so no
    phi-sized select is needed afterwards.

    ``fast_math``: phi was never scaled, so the whole (lossy!) 1/beta
    un-scale pass disappears — failed attempts leave phi untouched, which
    is both cheaper and exact (parity mode's scale/unscale round-trips
    phi through two roundings per failure)."""
    bnd = jnp.ndim(state.kk)
    idx = jnp.arange(C.MXORDP1, dtype=jnp.int32).reshape((C.MXORDP1,) + (1,) * bnd)
    if mask is None:
        mask = jnp.ones(jnp.shape(state.tn), bool)

    # psi[j-1] = psi[j] - hh for j = 1..kk
    shifted = jnp.roll(state.psi, -1, axis=0) - state.hh
    psi = jnp.where(jnp.logical_and(idx < state.kk, mask), shifted, state.psi)

    if fast_math:
        phi = state.phi
    else:
        # phi rows ns..kk multiplied by 1/beta
        unscale = jnp.logical_and(
            jnp.logical_and(idx >= state.ns, idx <= state.kk), mask
        )
        phi = state.phi * jnp.expand_dims(
            jnp.where(unscale, 1.0 / smask_den(state.beta), 1.0), 1
        )

    return state._replace(
        tn=jnp.where(mask, saved_t, state.tn), psi=psi, phi=phi
    )


@scope("reset")
def reset(state: IdaState, mask: jax.Array | None = None) -> IdaState:
    """nst == 0 re-prediction path: psi[0] = hh, phi[1] *= rr — the C
    ``IDAReset`` semantics (rescale ONLY the h-scaled derivative row so
    phi[1] = h_new * y'0 after the step size shrank). ``mask`` as in
    :func:`restore`.

    DELIBERATE DEVIATION from the reference: src/lib.rs:1249-1252 scales
    the ENTIRE phi array (``self.ida_phi *= self.ida_rr``), including
    phi[0] = y0 — so every first-step retry multiplies the initial
    condition by rr (0.25-0.9), corrupting the predictor base point and
    the yp-from-y Newton coupling, compounding per retry. C IDA scales
    only phi[1] (``N_VScale(rr, phi[1], phi[1])``); rows >= 2 are not yet
    populated at nst == 0, and phi[0] must stay y0. Replicating the
    reference here would make any problem whose first attempt fails
    (e.g. an over-optimistic user hin) spuriously diverge — see
    tests/test_options.py::test_first_step_failure_preserves_y0.

    The multiply is a plain masked update (phi[1] * 1.0 is the IEEE
    identity for masked-out lanes): a ``lax.cond`` skip looked attractive
    since the mask can only be true before the FIRST successful step, but
    measured WORSE — XLA copies phi through the false branch every
    iteration (~165 us/iter at B=262144) AND the branch boundary blocks
    fusion with restore's adjacent phi pass (PERF.md round 3). The C
    row-1-only semantics additionally shrink the touched data from the
    whole phi array to one static row (a constant-index update-slice)."""
    if mask is None:
        mask = jnp.ones(jnp.shape(state.hh), bool)
    one = jnp.ones((), state.dtype)
    idx = jnp.arange(C.MXORDP1, dtype=jnp.int32).reshape(
        (C.MXORDP1,) + (1,) * jnp.ndim(state.hh)
    )
    # whole-array masked forms (row != 1 multiplies by 1.0, the IEEE
    # identity), NOT static-row update-slices: the dus form measured ~
    # the same semantics but broke XLA's fusion of this multiply into
    # restore's adjacent phi pass
    phi = state.phi * jnp.expand_dims(
        jnp.where(jnp.logical_and(idx == 1, mask), state.rr, one), 1
    )
    psi = jnp.where(jnp.logical_and(idx == 0, mask), state.hh, state.psi)
    return state._replace(psi=psi, phi=phi)
