"""Pytree control-flow helpers for the branchless, batchable solver core.

The reference expresses retries and early exits with Rust ``Result``/``break``
(e.g. the step-attempt loop, reference ``src/lib.rs:634-694``). In a traced,
vmapped JAX solver each batch element carries its own status; loops run until
every element is done and each body application is masked so finished
elements are frozen. These helpers centralise that pattern.
"""

from __future__ import annotations

from typing import Callable, TypeVar

import jax
import jax.numpy as jnp

T = TypeVar("T")


def tree_where(pred, new_tree: T, old_tree: T) -> T:
    """Elementwise select over matching pytrees.

    ``pred`` may be a scalar bool (the common case inside masked loops), a
    batch-LEADING bool (leaf shapes ``pred.shape + ...``, e.g. explicitly
    batched states), or a batch-TRAILING bool (leaf shapes
    ``... + pred.shape``, the batch-native layout). Alignment is chosen
    per leaf: trailing match uses standard numpy broadcasting; a leading
    match right-pads pred with singleton dims.
    """

    def sel(new, old):
        new = jnp.asarray(new)
        old = jnp.asarray(old)
        p = jnp.asarray(pred)
        if p.ndim and new.ndim >= p.ndim:
            if new.shape[new.ndim - p.ndim :] == p.shape:
                pass  # trailing match: standard (left-aligned) broadcasting
            elif new.shape[: p.ndim] == p.shape:
                p = p.reshape(p.shape + (1,) * (new.ndim - p.ndim))
        if p.ndim and p.shape != new.shape:
            # explicit int32 broadcast instead of an implicit i1
            # broadcast in the select: the form a removed Pallas kernel
            # needed, kept because XLA fuses it identically and rewriting
            # it risks step-parity flips
            p = jnp.broadcast_to(p.astype(jnp.int32), jnp.broadcast_shapes(p.shape, new.shape)) != 0
        if new.dtype == jnp.bool_:
            # boolean select as logical algebra (the same removed kernel's
            # form, kept for the same reason)
            return jnp.logical_or(
                jnp.logical_and(p, new),
                jnp.logical_and(jnp.logical_not(p), old),
            )
        return jnp.where(p, new, old)

    return jax.tree_util.tree_map(sel, new_tree, old_tree)


def take1(vec: jax.Array, idx: jax.Array) -> jax.Array:
    """Exact dynamic element pick from a small vector via one-hot masked sum.

    Lowers to elementwise multiply + reduce instead of a gather — under vmap
    batched gathers can serialize while this stays full-width elementwise
    work.
    Exact (no arithmetic on the selected value: zeros sum away).

    Batch-native layout supported: ``vec`` may be [K, *batch] with ``idx``
    [*batch]; the pick reduces over axis 0."""
    n = vec.shape[0]
    # broadcasted_iota, not reshape-of-arange (the removed Pallas kernel's
    # form; XLA lowers both alike)
    onehot = jax.lax.broadcasted_iota(jnp.int32, (n,) + (1,) * jnp.ndim(idx), 0) == idx
    return jnp.sum(jnp.where(onehot, vec, jnp.zeros((), vec.dtype)), axis=0)


def take_row(mat: jax.Array, idx: jax.Array) -> jax.Array:
    """Exact dynamic row pick from a small [K, ...] array (masked sum over
    rows); gather-free under vmap. Batch-native layout supported: ``mat``
    may be [K, N, *batch] with ``idx`` [*batch] (trailing-batch broadcast)."""
    k = mat.shape[0]
    onehot = jax.lax.broadcasted_iota(jnp.int32, (k,) + (1,) * (mat.ndim - 1), 0) == idx
    return jnp.sum(jnp.where(onehot, mat, jnp.zeros((), mat.dtype)), axis=0)


def set_row(mat: jax.Array, idx: jax.Array, row: jax.Array) -> jax.Array:
    """Dynamic row write into a small [K, ...] array via select; scatter-free
    under vmap. Batch-native layout supported ([K, N, *batch] mat,
    [*batch] idx, [N, *batch] row)."""
    k = mat.shape[0]
    onehot = jax.lax.broadcasted_iota(jnp.int32, (k,) + (1,) * (mat.ndim - 1), 0) == idx
    return jnp.where(onehot, row[None], mat)


def set1(vec: jax.Array, idx: jax.Array, value: jax.Array) -> jax.Array:
    """Dynamic element write into a small vector via select; scatter-free.
    Batch-native layout supported ([K, *batch] vec, [*batch] idx/value)."""
    k = vec.shape[0]
    onehot = jax.lax.broadcasted_iota(jnp.int32, (k,) + (1,) * jnp.ndim(idx), 0) == idx
    return jnp.where(onehot, value, vec)


def masked_while_loop(cond_fn: Callable[[T], jax.Array], body_fn: Callable[[T], T], init: T) -> T:
    """``lax.while_loop`` that stays correct under ``vmap``.

    ``cond_fn`` returns a per-instance bool. Under vmap, JAX reduces the loop
    condition with ``any``; the body then runs for *every* instance including
    finished ones, so we mask each body application with the instance's own
    condition. Without vmap this is an ordinary while loop with a redundant
    (constant-true) select.
    """

    def body(carry: T) -> T:
        active = cond_fn(carry)
        return tree_where(active, body_fn(carry), carry)

    return jax.lax.while_loop(lambda c: jnp.any(cond_fn(c)), body, init)


def int_carry_fori_loop(lo, hi, body_fn: Callable, init: T) -> T:
    """``lax.fori_loop`` whose boolean leaves are carried as int32 and
    every leaf rank-promoted to >= 2-D at the loop boundary (squeezed back
    before the body runs). The form was needed by a since-removed Pallas
    kernel; the budgeted adjoint path still uses it (core/solve.py), and on
    the XLA path the converts/reshapes fuse away, so it is free and
    bit-exact."""
    leaves, treedef = jax.tree_util.tree_flatten(init)
    leaves = [jnp.asarray(l) for l in leaves]
    isbool = [l.dtype == jnp.bool_ for l in leaves]
    pad = [max(0, 2 - l.ndim) for l in leaves]

    def enc(ls):
        return [
            jnp.expand_dims(
                l.astype(jnp.int32) if b else l, tuple(range(p))
            ) if p else (l.astype(jnp.int32) if b else l)
            for l, b, p in zip(ls, isbool, pad)
        ]

    def dec(ls):
        out = []
        for l, b, p in zip(ls, isbool, pad):
            if p:
                l = l.reshape(l.shape[p:])
            out.append(l != 0 if b else l)
        return out

    def body(i, enc_leaves):
        carry = jax.tree_util.tree_unflatten(treedef, dec(enc_leaves))
        out = body_fn(i, carry)
        return enc([jnp.asarray(l) for l in jax.tree_util.tree_leaves(out)])

    out_leaves = jax.lax.fori_loop(lo, hi, body, enc(leaves))
    return jax.tree_util.tree_unflatten(treedef, dec(out_leaves))


def bounded_while_loop(
    cond_fn: Callable[[T], jax.Array],
    body_fn: Callable[[T], T],
    init: T,
    max_iters: int,
) -> T:
    """Masked while loop with a hard iteration bound (safety net for traced
    root-search loops whose convergence is mathematically, not structurally,
    guaranteed)."""

    def body(carry_i):
        carry, i = carry_i
        active = cond_fn(carry)
        return tree_where(active, body_fn(carry), carry), i + 1

    def cond(carry_i):
        carry, i = carry_i
        return jnp.logical_and(jnp.any(cond_fn(carry)), i < max_iters)

    out, _ = jax.lax.while_loop(cond, body, (init, jnp.asarray(0, jnp.int32)))
    return out


def bounded_fori_loop(
    cond_fn: Callable[[T], jax.Array],
    body_fn: Callable[[T], T],
    init: T,
    max_iters: int,
) -> T:
    """Reverse-differentiable form of ``bounded_while_loop``: identical
    masked body, but a STATIC fori_loop that always runs ``max_iters``
    iterations (each a tree_where no-op once a lane's cond turns False).
    ``lax.while_loop`` has no VJP rule, so the adjoint path selects this
    form (IdaOptions.unroll_roots); the extra masked passes change no
    arithmetic on any lane."""

    def body(_, carry):
        active = cond_fn(carry)
        return tree_where(active, body_fn(carry), carry)

    return jax.lax.fori_loop(0, max_iters, body, init)
