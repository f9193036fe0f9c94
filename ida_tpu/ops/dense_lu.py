"""Dense LU with partial pivoting (L2 layer), exact SUNDIALS semantics.

Behavioural spec: reference ``crates/linear/src/dense.rs:86-206``
(``dense_get_rf`` / ``dense_get_rs``, themselves ports of SUNDIALS
``denseGETRF``/``denseGETRS``). The pivot choice (first occurrence of the
column max at-or-below the diagonal) and the elimination order are preserved
so factorizations match the reference's golden fixtures bit-for-bit on
well-posed inputs.

Design: the factorization is expressed as N rank-1 updates over a
statically-shaped [N, N] matrix inside a ``fori_loop`` — fully vmappable, so
a [B, N, N] ensemble factors in lockstep with no data-dependent shapes. For
Roberts-class problems (N=3..10) the hot ensemble path uses the unrolled
variant below: a handful of fused elementwise ops per instance, which XLA
compiles for the accelerator as it is.

Failure (zero pivot) is reported as a status lane, not an exception:
``col`` is the 1-based column of the first zero pivot, 0 on success —
mirroring reference ``crates/linear/src/lib.rs:10-13``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.ad_mode import smask_den


class DenseLU(NamedTuple):
    """LU factorization PA = LU packed SUNDIALS-style.

    ``lu``: upper triangle (incl. diagonal) is U; strictly-lower part holds
    the multipliers (I - L). ``piv[k]`` is the row swapped with row k at
    elimination step k. ``fail_col`` is 0 on success, else the 1-based column
    index of the first zero pivot.
    """

    lu: jax.Array  # [N, N]
    piv: jax.Array  # [N] int32
    fail_col: jax.Array  # [] int32


def lu_factor(a: jax.Array) -> DenseLU:
    """LU-factor a square matrix, SUNDIALS ``denseGETRF`` order of operations.

    Reference: crates/linear/src/dense.rs:86-158.
    """
    n = a.shape[-1]
    assert a.shape[-2] == n, "lu_factor expects a square matrix"
    idx = jnp.arange(n, dtype=jnp.int32)

    def step(k, carry):
        mat, piv, fail = carry
        col = mat[:, k]
        # pivot row: first occurrence of max |a[i,k]| for i >= k
        # (the reference scan replaces only on strict '>', i.e. first max wins)
        masked_abs = jnp.where(idx >= k, jnp.abs(col), -jnp.inf)
        l = jnp.argmax(masked_abs).astype(jnp.int32)
        piv = piv.at[k].set(l)
        pivot_val = mat[l, k]
        zero_piv = pivot_val == 0.0
        fail = jnp.where(jnp.logical_and(fail == 0, zero_piv), k + 1, fail)

        # swap full rows k and l (no-op when l == k)
        row_k = mat[k]
        row_l = mat[l]
        mat = mat.at[k].set(row_l).at[l].set(row_k)

        # scale sub-diagonal entries of column k by 1/pivot
        safe_piv = jnp.where(zero_piv, 1.0, mat[k, k])
        mult = 1.0 / safe_piv
        col_k = mat[:, k]
        col_scaled = jnp.where(idx > k, col_k * mult, col_k)
        mat = mat.at[:, k].set(col_scaled)

        # trailing-submatrix rank-1 update: a[i,j] -= a[i,k] * a[k,j]
        update = col_scaled[:, None] * mat[k, :][None, :]
        mask = (idx[:, None] > k) & (idx[None, :] > k)
        mat = mat - jnp.where(mask, update, 0.0)
        return mat, piv, fail

    piv0 = jnp.zeros(n, jnp.int32)
    fail0 = jnp.asarray(0, jnp.int32)
    lu, piv, fail = jax.lax.fori_loop(0, n, step, (a, piv0, fail0))
    return DenseLU(lu, piv, fail)


def lu_factor_unrolled(a: jax.Array) -> DenseLU:
    """Gather/scatter-free LU for small static N (the ensemble hot path).

    Identical arithmetic and pivot choices to :func:`lu_factor` -- the same
    multiplies and subtractions in the same order -- but fully scalarized:
    the matrix lives as N*N separate traced scalars updated with selects,
    so under vmap the device sees one short fused chain of full-width ops
    (no gathers, scatters, or dynamic slices). Results are bit-identical.
    """
    # leading-axis size: N in both per-lane [N, N] and batch-native
    # [N, N, B] layouts (trailing axes, if any, are batch)
    n = a.shape[0]
    m = [[a[i, j] for j in range(n)] for i in range(n)]
    piv = []
    fail = jnp.asarray(0, jnp.int32)

    for k in range(n):
        # pivot row: first occurrence of max |a[i,k]| for i >= k
        # (the reference scan replaces only on strict '>', first max wins)
        best = jnp.abs(m[k][k])
        # broadcast to the (possibly batched) element shape so jnp.stack(piv)
        # stays uniform in batch-native [N, N, B] layouts
        lsel = jnp.broadcast_to(jnp.asarray(k, jnp.int32), jnp.shape(best))
        for i in range(k + 1, n):
            cand = jnp.abs(m[i][k])
            take = cand > best
            best = jnp.where(take, cand, best)
            lsel = jnp.where(take, jnp.asarray(i, jnp.int32), lsel)
        piv.append(lsel)

        # swap rows k and l via per-element selects
        for j in range(n):
            mkj = m[k][j]
            mlj = mkj
            for i in range(k + 1, n):
                mlj = jnp.where(lsel == i, m[i][j], mlj)
            m[k][j] = mlj
            for i in range(k + 1, n):
                m[i][j] = jnp.where(lsel == i, mkj, m[i][j])

        pivot_val = m[k][k]
        zero_piv = pivot_val == 0.0
        fail = jnp.where(jnp.logical_and(fail == 0, zero_piv), k + 1, fail)
        mult = 1.0 / jnp.where(zero_piv, jnp.ones((), a.dtype), pivot_val)
        for i in range(k + 1, n):
            m[i][k] = m[i][k] * mult
        for j in range(k + 1, n):
            mkj = m[k][j]
            for i in range(k + 1, n):
                m[i][j] = m[i][j] - mkj * m[i][k]

    lu = jnp.stack([jnp.stack(r) for r in m])
    return DenseLU(lu, jnp.stack(piv), fail)


def lu_solve_unrolled(f: DenseLU, b: jax.Array) -> jax.Array:
    """Companion solve to :func:`lu_factor_unrolled`: same arithmetic as
    :func:`lu_solve`, fully scalarized (permutation by selects). Accepts
    per-lane [N] or batch-native [N, B] right-hand sides."""
    n = b.shape[0]
    lu = [[f.lu[i, j] for j in range(n)] for i in range(n)]
    piv = [f.piv[i] for i in range(n)]
    x = [b[i] for i in range(n)]

    for k in range(n):
        pk = piv[k]
        xk = x[k]
        xpk = xk
        for i in range(k + 1, n):
            xpk = jnp.where(pk == i, x[i], xpk)
        x[k] = xpk
        for i in range(k + 1, n):
            x[i] = jnp.where(pk == i, xk, x[i])

    for k in range(n - 1):
        for i in range(k + 1, n):
            x[i] = x[i] - lu[i][k] * x[k]

    for k in range(n - 1, 0, -1):
        x[k] = x[k] / smask_den(lu[k][k])
        for i in range(k):
            x[i] = x[i] - lu[i][k] * x[k]
    x[0] = x[0] / smask_den(lu[0][0])
    return jnp.stack(x)


# below this size the unrolled elementwise variant is used; it is
# bit-identical. The crossover was tuned on an earlier accelerator and is
# not yet measured on the GPU; above it, unrolled code size starts to hurt
SMALL_N_UNROLL = 16


def lu_factor_auto(a: jax.Array) -> DenseLU:
    if a.shape[0] <= SMALL_N_UNROLL:
        return lu_factor_unrolled(a)
    return lu_factor(a)


def lu_solve_auto(f: DenseLU, b: jax.Array) -> jax.Array:
    if b.shape[0] <= SMALL_N_UNROLL:
        return lu_solve_unrolled(f, b)
    return lu_solve(f, b)


def lu_solve(f: DenseLU, b: jax.Array) -> jax.Array:
    """Solve ``A x = b`` from a factorization, SUNDIALS ``denseGETRS`` order.

    Reference: crates/linear/src/dense.rs:165-206. Cannot fail if the
    factorization succeeded.
    """
    n = b.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    lu, piv = f.lu, f.piv

    # permute b according to the pivot sequence (inherently sequential)
    def permute(k, bb):
        pk = piv[k]
        bk, bpk = bb[k], bb[pk]
        return bb.at[k].set(bpk).at[pk].set(bk)

    b = jax.lax.fori_loop(0, n, permute, b)

    # forward substitution Ly = b (unit diagonal; multipliers below diag)
    def fwd(k, bb):
        return bb - jnp.where(idx > k, lu[:, k] * bb[k], 0.0)

    b = jax.lax.fori_loop(0, n - 1, fwd, b)

    # back substitution Ux = y, walking k = n-1 .. 1, then b[0] /= a[0,0]
    def bwd(i, bb):
        k = n - 1 - i
        bk = bb[k] / smask_den(lu[k, k])
        bb = bb.at[k].set(bk)
        return bb - jnp.where(idx < k, lu[:, k] * bk, 0.0)

    b = jax.lax.fori_loop(0, n - 1, bwd, b)
    return b.at[0].set(b[0] / smask_den(lu[0, 0]))
