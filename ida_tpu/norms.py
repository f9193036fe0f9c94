"""Weighted root-mean-square norms (L1 layer).

Behavioural spec: reference ``src/norm_rms.rs:24-58`` and
``crates/nonlinear/src/norm_wrms.rs:19-34``.

``wrms(x, w) = sqrt( sum_i (x_i * w_i)^2 / N )``

The masked variant zeroes masked entries but still divides by the FULL length
N — this matches SUNDIALS ``N_VWrmsNormMask`` semantics exactly (documented
quirk, reference ``src/norm_rms.rs:49-57``); do not "fix" it.

Sharding: for a state vector sharded over a device mesh the sum becomes a
``psum``; pass ``axis_name`` when calling inside ``shard_map``/``pmap``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .utils.ad_mode import ssqrt


def wrms_norm(x: jax.Array, w: jax.Array, axis_name: str | None = None) -> jax.Array:
    """Weighted RMS norm over the trailing axis of ``x``."""
    sq = jnp.sum(jnp.square(x * w), axis=-1)
    n = x.shape[-1]
    if axis_name is not None:
        sq = jax.lax.psum(sq, axis_name)
        n = n * jax.lax.psum(1, axis_name)
    return ssqrt(sq / n)


def wrms_norm_masked(
    x: jax.Array,
    w: jax.Array,
    mask: jax.Array,
    axis_name: str | None = None,
) -> jax.Array:
    """Masked weighted RMS norm; divides by full N (SUNDIALS semantics)."""
    mask = mask.astype(x.dtype)
    sq = jnp.sum(jnp.square(x * w * mask), axis=-1)
    n = x.shape[-1]
    if axis_name is not None:
        sq = jax.lax.psum(sq, axis_name)
        n = n * jax.lax.psum(1, axis_name)
    return ssqrt(sq / n)


def wrms_norm_bnd(
    x: jax.Array,
    w: jax.Array,
    n: int,
    bnd: int,
    mask: jax.Array | None = None,
) -> jax.Array:
    """WRMS norm over the DATA axis of a possibly batch-native array.

    ``x`` has shape [..., N, *batch] with ``bnd`` trailing batch dims; the
    reduction runs over the N axis (identical arithmetic to
    :func:`wrms_norm` for bnd = 0). ``mask`` is a static bool [N]."""
    t = x * w
    if mask is not None:
        t = t * mask.astype(x.dtype).reshape((n,) + (1,) * bnd)
    axis = x.ndim - 1 - bnd
    return ssqrt(jnp.sum(jnp.square(t), axis=axis) / n)


def wrms_norm_maybe_masked(
    x: jax.Array,
    w: jax.Array,
    mask: jax.Array | None,
    use_mask: bool,
    axis_name: str | None = None,
) -> jax.Array:
    """Dispatch helper mirroring ``Ida::wrms_norm`` (reference src/lib.rs:1353-1370).

    ``use_mask`` is a trace-time Python bool (it corresponds to the
    ``suppressalg`` solver option, fixed at construction).
    """
    if use_mask and mask is not None:
        return wrms_norm_masked(x, w, mask, axis_name)
    return wrms_norm(x, w, axis_name)
