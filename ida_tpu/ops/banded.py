"""Banded LU with partial pivoting + AD banded Jacobians (L2 layer).

Behavioural spec: SUNDIALS ``bandGETRF``/``bandGETRS`` (the C IDA ``IDABand``
linear solver the reference never ported — its only direct solver is dense,
crates/linear/src/dense.rs). Semantics kept: column-oriented elimination,
partial pivoting restricted to the ``ml`` subdiagonal rows of each column
(first occurrence of the column max wins, as in the dense port), ``ml``
fill rows above the stored band to absorb row swaps.

Design: the band lives in LAPACK-style column band storage
``ab[i - j + smu, j]`` with ``smu = mu + ml`` (rows ``0..ml-1`` are fill),
padded with ``smu`` zero columns so every window slice is in-range. One
``fori_loop`` step per column does: a STATIC (ml+1)-row pivot search, a
row swap expressed as two one-hot rank-1 corrections (no scatters, no
dynamic gathers), and the trailing rank-1 band update
built from a static ``di = r - smu + t`` index grid. Everything carries an
arbitrary trailing batch: ``ab`` may be ``[rows, n]`` or ``[rows, n, B]``
(batch-native ensembles factor B bands in lockstep).

The banded Jacobian builder uses W = mu+ml+1 jvp probes with the classic
Curtis–Powell–Reid coloring (columns j ≡ c (mod W) share a probe; no
aliasing because same-color columns are ≥ W apart) — exact AD entries, not
the C module's difference quotients.

Failure (zero pivot) is a status lane: ``fail_col`` is the 1-based column
of the first zero pivot, 0 on success (crates/linear/src/lib.rs:10-13
convention).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class BandLU(NamedTuple):
    """Banded LU factorization, SUNDIALS band-storage packing.

    ``lu``: [2*ml+mu+1, n(, batch...)] — rows ``smu+1..smu+ml`` of column k
    hold the multipliers; rows ``0..smu`` hold U (anti-diagonal layout:
    ``U[k, k+t] = lu[smu-t, k+t]``). ``piv[k]`` is the OFFSET d of the row
    swapped with row k (absolute row k+d, d in [0, ml]). ``fail_col`` is 0
    on success, else the 1-based first zero-pivot column.
    """

    lu: jax.Array
    piv: jax.Array  # [n(, batch...)] int32 offsets
    fail_col: jax.Array  # [(batch...)] int32
    mu: int
    ml: int


def band_rows(mu: int, ml: int) -> int:
    return 2 * ml + mu + 1


def band_from_dense(a: jax.Array, mu: int, ml: int) -> jax.Array:
    """Pack a dense [n, n(, batch...)] matrix into band storage (test/setup
    helper; entries outside the band are dropped)."""
    n = a.shape[1]
    smu = mu + ml
    rows = band_rows(mu, ml)
    cols = jnp.arange(n)
    out = jnp.zeros((rows, n) + a.shape[2:], a.dtype)
    for o in range(-mu, ml + 1):  # o = i - j
        i = cols + o
        valid = (i >= 0) & (i < n)
        src = a[jnp.clip(i, 0, n - 1), cols]
        src = jnp.where(valid.reshape(valid.shape + (1,) * (a.ndim - 2)), src, 0.0)
        out = out.at[o + smu].set(src)
    return out


def band_to_dense(ab: jax.Array, mu: int, ml: int) -> jax.Array:
    """Unpack band storage to dense (test helper; fill rows included so a
    FACTORED band round-trips its U part)."""
    smu = mu + ml
    rows, n = ab.shape[0], ab.shape[1]
    out = jnp.zeros((n, n) + ab.shape[2:], ab.dtype)
    for r in range(rows):
        o = r - smu  # i - j
        cols = jnp.arange(n)
        i = cols + o
        valid = (i >= 0) & (i < n)
        vals = jnp.where(
            valid.reshape(valid.shape + (1,) * (ab.ndim - 2)), ab[r], 0.0
        )
        out = out.at[jnp.clip(i, 0, n - 1), cols].add(vals)
    return out


def band_factor(ab: jax.Array, mu: int, ml: int) -> BandLU:
    """LU-factor a band matrix in place, SUNDIALS ``bandGETRF`` semantics.

    ``ab``: [2*ml+mu+1, n(, batch...)] band storage (fill rows zeroed).
    """
    smu = mu + ml
    rows = band_rows(mu, ml)
    assert ab.shape[0] == rows, (ab.shape, rows)
    n = ab.shape[1]
    batch = ab.shape[2:]
    dtype = ab.dtype
    w = smu + 1  # trailing window width (columns k..k+smu)

    # pad columns so every window slice is in-range
    pad = jnp.zeros((rows, smu) + batch, dtype)
    ab_pad = jnp.concatenate([ab, pad], axis=1)

    r_idx = jnp.arange(rows, dtype=jnp.int32)  # [rows]
    t_idx = jnp.arange(w, dtype=jnp.int32)  # [w]
    # static one-hot of the anti-diagonal r == smu - t (row k inside window)
    A1 = (r_idx[:, None] == (smu - t_idx)[None, :]).astype(dtype)  # [rows, w]
    A1b = A1.reshape(A1.shape + (1,) * len(batch))
    # static index grid di = r - smu + t for the rank-1 band update
    DI = r_idx[:, None] - smu + t_idx[None, :]  # [rows, w]
    DI_valid = (DI >= 1) & (DI <= ml) & (t_idx[None, :] >= 1)
    DI_clip = jnp.clip(DI, 0, ml)

    di_piv = jnp.arange(ml + 1, dtype=jnp.int32)  # pivot window offsets

    def step(k, carry):
        abp, piv, fail = carry
        win = jax.lax.dynamic_slice_in_dim(abp, k, w, axis=1)  # [rows, w, *B]

        # --- pivot search over rows k..k+ml of column k (static window) ---
        cand = win[smu : smu + ml + 1, 0]  # [ml+1, *B]
        live = (k + di_piv) < n  # [ml+1]
        liveb = live.reshape(live.shape + (1,) * len(batch))
        masked = jnp.where(liveb, jnp.abs(cand), -jnp.inf)
        d = jnp.argmax(masked, axis=0).astype(jnp.int32)  # [*B]
        piv = jax.lax.dynamic_update_slice_in_dim(
            piv, d[None].astype(piv.dtype), k, axis=0
        )

        # --- swap rows k and k+d across the window (two one-hot updates) ---
        # val1[t] = win[smu - t, t] (row k); val2[t] = win[smu - t + d, t]
        val1 = jnp.sum(win * A1b, axis=0)  # [w, *B]
        r2 = (smu - t_idx)[:, None].reshape((w,) + (1,) * len(batch)) + d  # [w,*B]
        O2 = (
            r_idx.reshape((rows,) + (1,) * (1 + len(batch))) == r2[None]
        ).astype(dtype)  # [rows, w, *B]
        val2 = jnp.sum(win * O2, axis=0)  # [w, *B]
        win = win + A1b * (val2 - val1)[None] + O2 * (val1 - val2)[None]

        # --- scale multipliers and track zero pivots ---
        p = win[smu, 0]  # [*B]
        zero_piv = p == 0.0
        fail = jnp.where(
            jnp.logical_and(fail == 0, zero_piv),
            jnp.asarray(k + 1, jnp.int32),
            fail,
        )
        safe_p = jnp.where(zero_piv, jnp.ones((), dtype), p)
        mult = win[smu + 1 : smu + ml + 1, 0] / safe_p  # [ml, *B]
        win = win.at[smu + 1 : smu + ml + 1, 0].set(mult)

        # --- trailing rank-1 band update:
        # win[smu + di - t, t] -= mult[di] * u[t]  (di in 1..ml, t in 1..smu)
        u = jnp.sum(win * A1b, axis=0)  # row k after swap, [w, *B]
        m_full = jnp.concatenate(
            [jnp.zeros((1,) + batch, dtype), mult], axis=0
        )  # [ml+1, *B]
        M = jnp.take(m_full, DI_clip, axis=0)  # [rows, w, *B]
        maskb = DI_valid.reshape(DI_valid.shape + (1,) * len(batch))
        win = win - jnp.where(maskb, M * u[None], jnp.zeros((), dtype))

        abp = jax.lax.dynamic_update_slice_in_dim(abp, win, k, axis=1)
        return abp, piv, fail

    piv0 = jnp.zeros((n,) + batch, jnp.int32)
    fail0 = jnp.zeros(batch, jnp.int32)
    abp, piv, fail = jax.lax.fori_loop(0, n, step, (ab_pad, piv0, fail0))
    return BandLU(abp[:, :n], piv, fail, mu, ml)


def band_solve(f: BandLU, b: jax.Array) -> jax.Array:
    """Solve ``A x = b`` from a banded factorization, SUNDIALS ``bandGETRS``
    order: interleaved permute+forward substitution, then back substitution.
    ``b``: [n(, batch...)]."""
    mu, ml = f.mu, f.ml
    smu = mu + ml
    rows = band_rows(mu, ml)
    n = b.shape[0]
    batch = b.shape[1:]
    dtype = b.dtype
    w = smu + 1

    lu_pad = jnp.concatenate(
        [f.lu, jnp.zeros((rows, smu) + tuple(f.lu.shape[2:]), dtype)], axis=1
    )

    b_pad = jnp.concatenate([b, jnp.zeros((ml,) + batch, dtype)], axis=0)
    di_idx = jnp.arange(ml + 1, dtype=jnp.int32)
    t_idx = jnp.arange(w, dtype=jnp.int32)
    r_idx = jnp.arange(rows, dtype=jnp.int32)
    A1 = (r_idx[:, None] == (smu - t_idx)[None, :]).astype(dtype)  # [rows, w]
    A1b = A1.reshape(A1.shape + (1,) * len(batch))

    # --- permute + forward substitution (bandGETRS first loop) ---
    def fwd(k, bp):
        wv = jax.lax.dynamic_slice_in_dim(bp, k, ml + 1, axis=0)  # [ml+1, *B]
        d = jax.lax.dynamic_index_in_dim(f.piv, k, axis=0, keepdims=False)  # [*B]
        oh = (
            di_idx.reshape((ml + 1,) + (1,) * len(batch)) == d
        ).astype(dtype)  # [ml+1, *B]
        vk = wv[0]
        vd = jnp.sum(wv * oh, axis=0)
        oh0 = jnp.zeros((ml + 1,), dtype).at[0].set(1.0)
        oh0 = oh0.reshape((ml + 1,) + (1,) * len(batch))
        wv = wv + oh0 * (vd - vk) + oh * (vk - vd)[None]
        # subtract multipliers: b[k+di] -= mult[di] * b[k]
        mult = jax.lax.dynamic_slice_in_dim(lu_pad, k, 1, axis=1)[
            smu + 1 : smu + ml + 1, 0
        ]  # [ml, *B]
        wv = wv.at[1:].add(-mult * wv[0][None])
        return jax.lax.dynamic_update_slice_in_dim(bp, wv, k, axis=0)

    b_pad = jax.lax.fori_loop(0, n, fwd, b_pad)

    # --- back substitution: x[k] = (b[k] - U[k, k+1..k+smu] @ x[..]) / U[k,k]
    b_pad2 = jnp.concatenate(
        [b_pad[:n], jnp.zeros((smu,) + batch, dtype)], axis=0
    )

    def bwd(i, bp):
        k = n - 1 - i
        uwin = jax.lax.dynamic_slice_in_dim(lu_pad, k, w, axis=1)  # [rows, w, *B]
        urow = jnp.sum(uwin * A1b, axis=0)  # [w, *B]: U[k, k+t]
        xwin = jax.lax.dynamic_slice_in_dim(bp, k, w, axis=0)  # [w, *B]
        num = xwin[0] - jnp.sum(urow[1:] * xwin[1:], axis=0)
        xk = num / urow[0]
        return jax.lax.dynamic_update_slice_in_dim(bp, xk[None], k, axis=0)

    b_pad2 = jax.lax.fori_loop(0, n, bwd, b_pad2)
    return b_pad2[:n]


def band_jacobian(
    fn: Callable[[jax.Array], jax.Array], y: jax.Array, mu: int, ml: int
) -> jax.Array:
    """Banded Jacobian of ``fn`` at ``y`` in band storage, via mu+ml+1
    Curtis–Powell–Reid-colored jvp probes (exact AD — subsumes the C
    BBD module's difference quotients). ``y``: [n(, batch...)]."""
    n = y.shape[0]
    smu = mu + ml
    width = mu + ml + 1
    rows = band_rows(mu, ml)
    cols = jnp.arange(n)
    batch = y.shape[1:]

    jvs = []
    for c in range(width):
        v = (cols % width == c).astype(y.dtype)
        v = v.reshape((n,) + (1,) * len(batch))
        _, jv = jax.jvp(fn, (y,), (jnp.broadcast_to(v, y.shape),))
        jvs.append(jv)
    jstack = jnp.stack(jvs)  # [width, n, *batch]

    out = jnp.zeros((rows, n) + tuple(batch), y.dtype)
    color = cols % width  # [n]
    for o in range(-mu, ml + 1):  # o = i - j
        i = cols + o
        valid = (i >= 0) & (i < n)
        vals = jstack[color, jnp.clip(i, 0, n - 1)]  # [n, *batch]
        vals = jnp.where(valid.reshape(valid.shape + (1,) * len(batch)), vals, 0.0)
        out = out.at[o + smu].set(vals)
    return out


def band_sys_jacobian(problem, t, cj, yy, yp, mu: int, ml: int) -> jax.Array:
    """Banded system Jacobian ``J = dF/dy + cj*dF/dy'`` in band storage
    (the band analogue of ``IdaProblem.sys_jacobian``, problem.py)."""

    def f_of_e(e):
        return problem.res(t, yy + e, yp + cj * e)

    return band_jacobian(f_of_e, jnp.zeros_like(yy), mu, ml)
