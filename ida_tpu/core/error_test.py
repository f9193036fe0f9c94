"""Local truncation error estimation and order-decrease decision (L4).

Behavioural spec: reference ``test_error`` (src/lib.rs:967-1039).
Estimates errors at orders k, k-1, k-2, proposes ``knew``, and performs the
local error test ``ck * enorm_k <= 1``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..norms import wrms_norm, wrms_norm_masked
from ..problem import IdaProblem
from ..utils import take1, take_row
from .state import IdaState, IdaOptions
from ..utils.profiling import scope


class ErrorTestResult(NamedTuple):
    err_k: jax.Array
    err_km1: jax.Array
    converged: jax.Array  # bool: error test passed


def _norm(state: IdaState, problem: IdaProblem, opts: IdaOptions, x: jax.Array) -> jax.Array:
    """WRMS norm with the suppressalg mask (reference src/lib.rs:1353-1370).
    Batch-native aware: reduces over the data axis, not the trailing one."""
    from ..norms import wrms_norm_bnd

    bnd = jnp.ndim(state.tn)
    mask = problem.id if (opts.suppressalg and problem.id is not None) else None
    return wrms_norm_bnd(x, state.ewt, problem.n, bnd, mask)


@scope("error_test")
def error_test(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    ck: jax.Array,
    mask: jax.Array | None = None,
) -> tuple[IdaState, ErrorTestResult]:
    kk = state.kk
    kkf = kk.astype(state.dtype)

    # error estimate vectors at orders k, k-1, k-2
    # (src/lib.rs:982-1007): ee; phi[kk] + ee; that + phi[kk-1].
    # Per-row take_row picks: measured faster on an earlier accelerator
    # than a stacked one-hot pick reading phi once (XLA streamed the two
    # where+reduce fusions better than the [2,K1,N,B] masked intermediate;
    # the probe is in git history); not yet measured on the GPU.
    row_k = take_row(state.phi, kk)
    row_km1 = take_row(state.phi, jnp.maximum(kk - 1, 0))
    if opts.fast_math:
        # phi is unscaled; apply the implicit phi-star scale to the two
        # picked rows (per-lane scalars — no extra phi bytes)
        from .coeffs import phi_star_scale

        s = phi_star_scale(state)
        row_k = row_k * jnp.expand_dims(take1(s, kk), 0)
        row_km1 = row_km1 * jnp.expand_dims(take1(s, jnp.maximum(kk - 1, 0)), 0)
    delta1 = row_k + state.ee
    delta2 = delta1 + row_km1
    # three separate reduces, not one stacked [3,N,batch] reduction: the
    # form a removed Pallas kernel needed, kept because XLA fuses the three
    # identically-shaped reduces anyway and changing the reduction order
    # risks step-parity flips
    enorm_k = _norm(state, problem, opts, state.ee)
    enorm_km1 = _norm(state, problem, opts, delta1)
    enorm_km2 = _norm(state, problem, opts, delta2)

    err_k = take1(state.sigma, kk) * enorm_k
    terr_k = err_k * (kkf + 1.0)
    err_km1_val = take1(state.sigma, jnp.maximum(kk - 1, 0)) * enorm_km1
    terr_km1 = kkf * err_km1_val
    err_km2 = take1(state.sigma, jnp.maximum(kk - 2, 0)) * enorm_km2
    terr_km2 = (kkf - 1.0) * err_km2

    # order-decrease decision (src/lib.rs:999-1022)
    knew_gt2 = jnp.where(
        jnp.maximum(terr_km1, terr_km2) <= terr_k, kk - 1, kk
    )
    knew_eq2 = jnp.where(terr_km1 <= 0.5 * terr_k, kk - 1, kk)
    knew = jnp.where(kk > 2, knew_gt2, knew_eq2)
    knew = jnp.where(kk > 1, knew, kk)
    err_km1 = jnp.where(kk > 1, err_km1_val, jnp.zeros((), state.dtype))

    converged = (ck * enorm_k) <= 1.0  # (src/lib.rs:1032)

    knew = knew.astype(jnp.int32)
    if mask is not None:
        knew = jnp.where(mask, knew, state.knew)
    state = state._replace(knew=knew)
    return state, ErrorTestResult(err_k=err_k, err_km1=err_km1, converged=converged)
