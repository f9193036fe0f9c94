"""SPGMR: scaled preconditioned GMRES (restarted) — the Krylov linear path.

The reference only stubs this out: ``LSolverType::{Iterative,
MatrixIterative}`` variants and tolerance plumbing exist but no iterative
solver is implemented (reference crates/linear/src/lib.rs:15-20,
src/ida_ls.rs:70-96,323-329; SURVEY.md §2.3 marks SPGMR in-scope). Semantics
follow SUNDIALS ``sunlinsol_spgmr``: solve A x = b with left preconditioner
P and row/column scalings s1, s2 by running GMRES on

    (s1 P^{-1} A s2^{-1}) (s2 x) = s1 P^{-1} b .

Design: A is never materialized — callers pass ``atimes`` (for
IDA, one ``jax.jvp`` of the residual). The Arnoldi loop is a fixed
``maxl``-iteration masked loop (static shapes [maxl+1, N, *batch] for the
Krylov basis); restarts are a masked while loop. Dot products/norms reduce
over the DATA axis (axis 0), so the solver is batch-native: ``b`` may carry
trailing batch axes ([N, *batch]) and every lane runs its own restarted
GMRES in lockstep — this is how a whole ensemble of large systems shares
one chip without a vmap while-merge. A state vector sharded over a mesh
gets its ``psum`` inserted by XLA (SURVEY.md §5 long-context note).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

Atimes = Callable[[jax.Array], jax.Array]
Psolve = Callable[[jax.Array], jax.Array]


class SpgmrResult(NamedTuple):
    x: jax.Array
    converged: jax.Array  # bool
    res_norm: jax.Array  # final scaled-preconditioned residual norm
    nli: jax.Array  # int32 linear iterations
    nps: jax.Array  # int32 psolve calls
    res0: jax.Array  # initial scaled-preconditioned residual norm (||s1 P^-1 b||)
    natimes: jax.Array  # int32 A-times (Jacobian-vector product) calls

    @property
    def reduced(self) -> jax.Array:
        """SUNLS_RES_REDUCED analogue: not converged to tol, but the scaled
        preconditioned residual did shrink (sunlinsol_spgmr returns this when
        rho < beta0; idaLsSolve accepts it on the first Newton iteration)."""
        return jnp.logical_and(
            jnp.logical_not(self.converged), self.res_norm < self.res0
        )


def _identity(z):
    return z


def spgmr_solve(
    atimes: Atimes,
    b: jax.Array,
    tol: jax.Array,
    *,
    psolve: Optional[Psolve] = None,
    s1: Optional[jax.Array] = None,
    s2: Optional[jax.Array] = None,
    maxl: int = 5,
    max_restarts: int = 5,
    storage_dtype=None,
    gs: str = "modified",
) -> SpgmrResult:
    """Solve A x = b from x0 = 0 (IDA always starts Newton corrections at
    zero, reference src/ida_ls.rs:337).

    ``b`` is [N] (single system) or [N, *batch] (batch-native lockstep
    lanes); per-lane convergence, restart counts, and counters come back
    with the trailing batch shape.

    ``storage_dtype`` (opt-in, e.g. ``jnp.bfloat16``): the Krylov basis V —
    the solver's dominant HBM traffic, re-read j+1 times per Arnoldi
    iteration by modified Gram-Schmidt and once more by the correction
    reconstruction — is STORED in this narrower dtype while every reduction
    (dot products, norms, Hessenberg/Givens algebra, back substitution)
    still runs in ``b.dtype``. Halves the MGS read bytes on a
    bandwidth-bound lane at the cost of basis orthogonality (~3 significant
    digits in bf16); the f64 Newton/error-test loop above gates accuracy
    either way. ``None`` stores V in ``b.dtype`` (exact baseline path).

    ``gs`` selects the Arnoldi orthogonalization, the SUNLS_SPGMR gstype
    pair: "modified" (MGS, the SUNDIALS default and parity anchor) or
    "classical" (CGS2 — classical Gram-Schmidt with one unconditional
    reorthogonalization pass). CGS2 turns iteration j's j+1 sequential
    dot+axpy pairs into 4 whole-basis contractions (rows above j are
    still zero, so they contribute nothing): a much shorter dependency
    chain for latency-bound single instances, more V reads for
    bandwidth-bound batched lanes (see IdaOptions.krylov_gs)."""
    dtype = b.dtype
    sdt = storage_dtype or dtype
    n = b.shape[0]
    lane = b.shape[1:]  # trailing batch shape; () for a single system
    psolve_fn = psolve or _identity
    s1v = jnp.ones(n, dtype).reshape((n,) + (1,) * len(lane)) if s1 is None else s1
    s2v = jnp.ones(n, dtype).reshape((n,) + (1,) * len(lane)) if s2 is None else s2

    def vdot(a, c):
        return jnp.sum(a * c, axis=0)

    def prec_scaled_r(r):
        """s1 * P^{-1} r"""
        return s1v * psolve_fn(r)

    def arnoldi_cycle(x, nli, nps):
        """One GMRES(maxl) cycle from current iterate x. Returns
        (x_new, res_norm, converged, nli, nps, beta) where beta is this
        cycle's starting residual norm."""
        # r = b - A x ; for the first cycle x = 0 so r = b
        r = b - atimes(x)
        z = prec_scaled_r(r)
        nps = nps + 1
        beta = jnp.sqrt(vdot(z, z))  # [*batch]

        V = jnp.zeros((maxl + 1, n) + lane, sdt).at[0].set(
            jnp.where(beta > 0.0, z / beta, z).astype(sdt)
        )
        H = jnp.zeros((maxl + 1, maxl) + lane, dtype)
        # Givens rotation coefficients and the rhs of the least-squares prob
        cs = jnp.zeros((maxl,) + lane, dtype)
        sn = jnp.zeros((maxl,) + lane, dtype)
        g = jnp.zeros((maxl + 1,) + lane, dtype).at[0].set(beta)

        # --- unrolled/masked MGS Arnoldi (maxl is small and static) ---
        done = beta <= tol
        for j in range(maxl):
            active = jnp.logical_not(done)
            v = V[j].astype(dtype)
            # unscale -> A -> precondition+scale. v lives in scaled space:
            # actual direction is s2^{-1} v
            w = prec_scaled_r(atimes(v / s2v))
            nps = nps + active.astype(jnp.int32)
            nli = nli + active.astype(jnp.int32)
            if gs == "classical":
                # CGS2 against the whole basis: rows i > j of V are still
                # zero, so their dots vanish and the contraction over the
                # full [maxl+1] axis equals the 0..j sum. Two passes
                # (reorthogonalization) keep CGS at MGS-level
                # orthogonality.
                Vd = V.astype(dtype)
                hs = jnp.sum(Vd * w[None], axis=1)  # [maxl+1, *lane]
                w = w - jnp.sum(hs[:, None] * Vd, axis=0)
                hs2 = jnp.sum(Vd * w[None], axis=1)
                w = w - jnp.sum(hs2[:, None] * Vd, axis=0)
                h_col = hs + hs2
            else:
                # modified Gram-Schmidt against V[0..j]
                h_col = jnp.zeros((maxl + 1,) + lane, dtype)
                for i in range(j + 1):
                    vi = V[i].astype(dtype)
                    hij = vdot(w, vi)
                    w = w - hij * vi
                    h_col = h_col.at[i].set(hij)
            hnorm = jnp.sqrt(vdot(w, w))
            h_col = h_col.at[j + 1].set(hnorm)
            V = V.at[j + 1].set(
                jnp.where(hnorm > 0.0, w / hnorm, w).astype(sdt)
            )

            # apply previous Givens rotations to the new column
            col = h_col
            for i in range(j):
                tmp_i = cs[i] * col[i] - sn[i] * col[i + 1]
                col = col.at[i + 1].set(sn[i] * col[i] + cs[i] * col[i + 1]).at[i].set(tmp_i)
            # new rotation to annihilate col[j+1]
            denom = jnp.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            c_new = jnp.where(denom > 0.0, col[j] / denom, 1.0)
            s_new = jnp.where(denom > 0.0, -col[j + 1] / denom, 0.0)
            col = col.at[j].set(c_new * col[j] - s_new * col[j + 1]).at[j + 1].set(0.0)
            g_new = g.at[j + 1].set(s_new * g[j]).at[j].set(c_new * g[j])

            # masked commit (per-lane: active is [*batch])
            H = jnp.where(active, H.at[:, j].set(col), H)
            cs = jnp.where(active, cs.at[j].set(c_new), cs)
            sn = jnp.where(active, sn.at[j].set(s_new), sn)
            g = jnp.where(active, g_new, g)
            done = jnp.logical_or(done, jnp.abs(g[j + 1]) <= tol)

        # solve the triangular system H y = g by back substitution over the
        # full maxl (columns never entered stay identity-ish: guard zeros)
        y = jnp.zeros((maxl,) + lane, dtype)
        for j in range(maxl - 1, -1, -1):
            s = g[j] - jnp.sum(H[j] * y, axis=0)
            hjj = H[j, j]
            y = y.at[j].set(jnp.where(hjj != 0.0, s / hjj, 0.0))

        # x += s2^{-1} V^T y (map correction back from scaled space)
        dx = jnp.sum(y[:, None] * V[:maxl].astype(dtype), axis=0) / s2v
        x_new = x + dx
        res_norm = jnp.abs(g[maxl])  # residual estimate after maxl rotations
        # recompute true preconditioned scaled residual for restart logic
        r_true = prec_scaled_r(b - atimes(x_new))
        nps = nps + 1
        res_true = jnp.sqrt(vdot(r_true, r_true))
        return x_new, res_true, res_true <= tol, nli, nps, beta

    class _Carry(NamedTuple):
        x: jax.Array
        res: jax.Array
        converged: jax.Array
        restarts: jax.Array
        nli: jax.Array
        nps: jax.Array
        res0: jax.Array

    x0 = jnp.zeros_like(b)

    def cond(c: _Carry):
        return jnp.logical_and(
            jnp.logical_not(c.converged), c.restarts < max_restarts + 1
        )

    def body(c: _Carry):
        x, res, conv, nli, nps, beta = arnoldi_cycle(c.x, c.nli, c.nps)
        return _Carry(
            x=x, res=res, converged=conv, restarts=c.restarts + 1, nli=nli, nps=nps,
            res0=jnp.where(c.restarts == 0, beta, c.res0),
        )

    from ..utils import masked_while_loop

    out = masked_while_loop(
        cond,
        body,
        _Carry(
            x=x0,
            res=jnp.full(lane, jnp.inf, dtype),
            converged=jnp.zeros(lane, bool),
            restarts=jnp.zeros(lane, jnp.int32),
            nli=jnp.zeros(lane, jnp.int32),
            nps=jnp.zeros(lane, jnp.int32),
            res0=jnp.full(lane, jnp.inf, dtype),
        ),
    )
    return SpgmrResult(
        x=out.x, converged=out.converged, res_norm=out.res, nli=out.nli, nps=out.nps,
        res0=out.res0,
        # per cycle: one atimes for the starting residual, one per active
        # Arnoldi iteration (== nli), one for the true-residual recompute
        natimes=out.nli + 2 * out.restarts,
    )
