"""Rootfinding: event detection during integration (L4).

Behavioural spec: reference ``src/impl_r_check.rs`` — ``r_check1`` (t0
handling, :32-99), ``r_check2`` (re-check at last root, :117-209),
``r_check3`` (search the last step, :221-271), and ``root_find``
(:343-576), the Illinois modified-secant algorithm (Hiebert & Shampine,
SAND80-0180).

Design: the reference's fold loops over root components become
vectorized masked reductions (any/argmax); the bracketing loop is a masked
``while_loop`` with a hard iteration bound. Deviation from the reference
(not from C IDA): roots start active at t0 (see core/state.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..problem import IdaProblem
from ..utils import tree_where, take1
from ..utils.ad_mode import smask_den, smask_pos
from .interp import interpolate
from .state import IdaState, IdaOptions
from ..utils.profiling import scope


def _eps(state):
    """Unit roundoff for the state's dtype (weak scalar: no f64 promotion
    in f32 runs, and f32 runs get f32-appropriate roundoff guards)."""
    return float(jnp.finfo(state.dtype).eps)



def _eval_root(state: IdaState, problem: IdaProblem, t, yy, yp) -> Tuple[IdaState, jax.Array]:
    g = problem.root(t, yy, yp)
    return state._replace(nge=state.nge + 1), g


def _scan(gactive, rootdir, glo, gnew) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Shared sign-change scan (reference :347-381 and :486-519).

    Returns (zroot, sgnchg, imax): zroot = some active component is exactly
    zero at the far end; sgnchg = a sign change was found; imax = component
    with the largest |gnew/(gnew-glo)| fraction.

    All reductions run over the root-component axis (axis 0 of the
    [R, *batch] root lanes) so the same code serves the single-instance,
    vmapped, AND batch-native (trailing-batch) layouts.
    """
    dirok = rootdir.astype(glo.dtype) * glo <= 0.0
    active = jnp.logical_and(gactive, dirok)
    zroot = jnp.any(jnp.logical_and(active, jnp.abs(gnew) == 0.0), axis=0)
    chg = jnp.logical_and(active, jnp.logical_and(jnp.abs(gnew) != 0.0, glo * gnew < 0.0))
    # smask_den: no-chg lanes have gnew == glo; their 0-cotangent x inf
    # partial would NaN reverse-mode AD (utils/ad_mode.py)
    gfrac = jnp.where(chg, jnp.abs(gnew / smask_den(gnew - glo)), 0.0)
    sgnchg = jnp.any(chg, axis=0)
    imax = jnp.argmax(gfrac, axis=0).astype(jnp.int32)
    return zroot, sgnchg, imax


@scope("r_check1")
def r_check1(state: IdaState, problem: IdaProblem) -> IdaState:
    """Initialization at t0: evaluate g, deactivate exact zeros, try to
    re-activate at t0 + smallh (reference :32-99)."""
    state = state._replace(
        iroots=jnp.zeros_like(state.iroots),
        tlo=state.tn,
        ttol=(jnp.abs(state.tn) + jnp.abs(state.hh)) * _eps(state) * 100.0,
    )
    state, glo = _eval_root(state, problem, state.tlo, state.phi[0], state.phi[1])

    zero_at_t0 = jnp.abs(glo) == 0.0
    gactive = jnp.logical_and(state.gactive, jnp.logical_not(zero_at_t0))
    any_zero = jnp.any(zero_at_t0, axis=0)

    # probe at t0 + smallh (reference :64-95)
    hratio = jnp.maximum(state.ttol / jnp.abs(state.hh), 0.1)
    smallh = hratio * state.hh
    tplus = state.tlo + smallh
    yy_probe = state.phi[0] + smallh * state.phi[1]
    st2, ghi = _eval_root(state, problem, tplus, yy_probe, state.phi[1])
    reactivate = jnp.logical_and(zero_at_t0, jnp.abs(ghi) != 0.0)
    gactive2 = jnp.logical_or(gactive, reactivate)
    glo2 = jnp.where(reactivate, ghi, glo)

    state = tree_where(
        any_zero,
        st2._replace(gactive=gactive2, glo=glo2),
        state._replace(gactive=gactive, glo=glo),
    )
    return state


class RootCheckResult(NamedTuple):
    state: IdaState
    found: jax.Array  # bool
    close_roots: jax.Array  # bool (r_check2 error condition)


@scope("r_check2")
def r_check2(state: IdaState, problem: IdaProblem) -> RootCheckResult:
    """Re-check for zeros at (and just past) the last root location
    (reference :117-209). Only runs when the last return was a root."""
    no = jnp.asarray(False)

    def run(state: IdaState) -> RootCheckResult:
        yy, yp = interpolate(state, state.tlo)
        state = state._replace(yy=yy, yp=yp)
        state, glo = _eval_root(state, problem, state.tlo, yy, yp)
        state = state._replace(glo=glo)

        zero_lo = jnp.logical_and(state.gactive, jnp.abs(glo) == 0.0)
        iroots = zero_lo.astype(jnp.int32)
        state = state._replace(iroots=iroots)
        any_zero = jnp.any(zero_lo, axis=0)

        # probe just past tlo (reference :148-172)
        ttol = (jnp.abs(state.tn) + jnp.abs(state.hh)) * _eps(state) * 100.0
        smallh = ttol * jnp.sign(state.hh)
        tplus = state.tlo + smallh
        use_linear = (tplus - state.tn) * state.hh >= 0.0
        yy_lin = state.yy + (smallh / state.hh) * state.phi[1]
        yy_int, yp_int = interpolate(state, tplus)
        yy_p = jnp.where(use_linear, yy_lin, yy_int)
        yp_p = jnp.where(use_linear, state.yp, yp_int)
        st2 = state._replace(ttol=ttol, yy=yy_p, yp=yp_p)
        st2, ghi = _eval_root(st2, problem, tplus, yy_p, yp_p)

        # classify (reference :176-195)
        zero_hi = jnp.logical_and(st2.gactive, jnp.abs(ghi) == 0.0)
        close = jnp.any(jnp.logical_and(zero_hi, iroots > 0), axis=0)
        new_zero = jnp.logical_and(zero_hi, iroots == 0)
        iroots2 = jnp.where(new_zero, 1, iroots).astype(jnp.int32)
        moved_off = jnp.logical_and(
            jnp.logical_and(st2.gactive, jnp.abs(ghi) != 0.0), iroots > 0
        )
        glo2 = jnp.where(moved_off, ghi, glo)
        st2 = st2._replace(iroots=iroots2, glo=glo2)

        state = tree_where(any_zero, st2, state)
        found = jnp.logical_and(any_zero, jnp.any(new_zero, axis=0))
        close = jnp.logical_and(any_zero, close)
        return RootCheckResult(state=state, found=found, close_roots=close)

    out = run(state)
    skip = jnp.logical_not(state.irfnd)
    return RootCheckResult(
        state=tree_where(skip, state, out.state),
        found=jnp.where(skip, no, out.found),
        close_roots=jnp.where(skip, no, out.close_roots),
    )


class _Illinois(NamedTuple):
    state: IdaState
    alph: jax.Array
    side: jax.Array  # int32: 0 initial, 1 low, 2 high
    sideprev: jax.Array  # int32: -1 initial
    imax: jax.Array  # int32
    done: jax.Array  # bool


@scope("root_find")
def _root_find(
    state: IdaState, problem: IdaProblem, opts: IdaOptions
) -> Tuple[IdaState, jax.Array]:
    """Illinois modified-secant root location on (tlo, thi)
    (reference :343-576). Returns (state, found)."""
    dtype = state.dtype

    zroot, sgnchg, imax0 = _scan(state.gactive, state.rootdir, state.glo, state.ghi)

    # --- no sign change: maybe exact zeros at thi (reference :386-410) ---
    dirok = state.rootdir.astype(dtype) * state.glo <= 0.0
    # C IDA sign convention: +1 for increasing g, -1 for decreasing
    # (the reference stores sign(glo), which is inverted — not replicated)
    cross_sign = jnp.where(state.glo > 0.0, -1, 1).astype(jnp.int32)
    iroots_zero = jnp.where(
        jnp.logical_and(
            jnp.logical_and(state.gactive, dirok), jnp.abs(state.ghi) == 0.0
        ),
        cross_sign,
        0,
    )
    st_nochg = state._replace(
        trout=state.thi,
        grout=state.ghi,
        iroots=jnp.where(zroot, iroots_zero, state.iroots),
    )

    # --- Illinois loop (reference :421-551) ---
    def cond(c: _Illinois) -> jax.Array:
        conv = jnp.abs(c.state.thi - c.state.tlo) <= c.state.ttol
        return jnp.logical_and(jnp.logical_not(c.done), jnp.logical_not(conv))

    def body(c: _Illinois) -> _Illinois:
        st = c.state
        same_side = c.sideprev == c.side
        alph = jnp.where(
            same_side,
            jnp.where(c.side == 2, c.alph * 2.0, c.alph * 0.5),
            jnp.asarray(1.0, dtype),
        )

        ghi_i = take1(st.ghi, c.imax)
        glo_i = take1(st.glo, c.imax)
        # smask_den guards (identity outside safe_ad): done/inactive lanes
        # can hold ghi == alph*glo or thi == tlo, whose discarded-quotient
        # inf partials would NaN the adjoint of the event time
        tmid = st.thi - (st.thi - st.tlo) * ghi_i / smask_den(
            ghi_i - alph * glo_i
        )

        # inward nudges (reference :453-470)
        fracint = jnp.abs(st.thi - st.tlo) / st.ttol
        fracsub = jnp.where(fracint > 5.0, 0.1, 0.5 / smask_pos(fracint))
        tmid = jnp.where(
            jnp.abs(tmid - st.tlo) < 0.5 * st.ttol,
            st.tlo + fracsub * (st.thi - st.tlo),
            tmid,
        )
        tmid = jnp.where(
            jnp.abs(st.thi - tmid) < 0.5 * st.ttol,
            st.thi - fracsub * (st.thi - st.tlo),
            tmid,
        )

        yy, yp = interpolate(st, tmid)
        st = st._replace(yy=yy, yp=yp)
        st, grout = _eval_root(st, problem, tmid, yy, yp)
        st = st._replace(grout=grout)

        zroot, sgnchg, imax = _scan(st.gactive, st.rootdir, st.glo, grout)

        # bracket update (reference :522-551)
        st_low = st._replace(thi=tmid, ghi=grout)  # sign change in (tlo, tmid)
        st_zero = st._replace(thi=tmid, ghi=grout)  # g = 0 at tmid
        st_high = st._replace(tlo=tmid, glo=grout)  # change in (tmid, thi)
        st = tree_where(sgnchg, st_low, tree_where(zroot, st_zero, st_high))
        side = jnp.where(sgnchg, 1, jnp.where(zroot, c.side, 2)).astype(jnp.int32)
        done = jnp.logical_and(jnp.logical_not(sgnchg), zroot)
        imax = jnp.where(sgnchg, imax, c.imax)

        return _Illinois(
            state=st, alph=alph, side=side, sideprev=c.side, imax=imax, done=done
        )

    lane = jnp.shape(state.tn)  # per-lane shape: () single/vmapped, [B] native
    init = _Illinois(
        state=state,
        alph=jnp.full(lane, 1.0, dtype),
        side=jnp.full(lane, 0, jnp.int32),
        sideprev=jnp.full(lane, -1, jnp.int32),
        imax=imax0,
        # no sign change => the loop must not run (reference returns early)
        done=jnp.logical_not(sgnchg),
    )
    # bounded: ttol convergence is guaranteed mathematically, not structurally
    from ..utils.tree import bounded_fori_loop, bounded_while_loop

    loop = bounded_fori_loop if opts.unroll_roots else bounded_while_loop
    looped = loop(cond, body, init, opts.max_root_iters)
    st = looped.state

    # found-root epilogue (reference :554-575)
    dirok2 = st.rootdir.astype(dtype) * st.glo <= 0.0
    hit = jnp.logical_and(
        jnp.logical_and(st.gactive, dirok2),
        jnp.logical_or(jnp.abs(st.ghi) == 0.0, st.glo * st.ghi < 0.0),
    )
    st_found = st._replace(
        trout=st.thi,
        grout=st.ghi,
        iroots=jnp.where(
            hit, jnp.where(st.glo > 0.0, -1, 1).astype(jnp.int32), 0
        ),
    )

    state = tree_where(sgnchg, st_found, st_nochg)
    found = jnp.logical_or(sgnchg, zroot)
    return state, found


@scope("r_check3")
def r_check3(
    state: IdaState, problem: IdaProblem, opts: IdaOptions, task_normal: bool
) -> RootCheckResult:
    """Search (tlo, tn-or-tout) for roots after a successful step
    (reference :221-271)."""
    if task_normal:
        thi = jnp.where(
            (state.toutc - state.tn) * state.hh >= 0.0, state.tn, state.toutc
        )
    else:
        thi = state.tn
    state = state._replace(thi=thi)

    yy, yp = interpolate(state, thi)
    state = state._replace(yy=yy, yp=yp)
    state, ghi = _eval_root(state, problem, thi, yy, yp)
    state = state._replace(
        ghi=ghi,
        ttol=(jnp.abs(state.tn) + jnp.abs(state.hh)) * _eps(state) * 100.0,
    )

    state, found = _root_find(state, problem, opts)

    # re-activate components that moved off zero (reference :254-260)
    gactive = jnp.where(
        jnp.logical_and(jnp.logical_not(state.gactive), state.grout != 0.0),
        True,
        state.gactive,
    )
    state = state._replace(gactive=gactive, tlo=state.trout, glo=state.grout)

    # interpolate to the root location (reference :266-269)
    yy, yp = interpolate(state, state.trout)
    state = state._replace(
        yy=jnp.where(found, yy, state.yy), yp=jnp.where(found, yp, state.yp)
    )
    return RootCheckResult(state=state, found=found, close_roots=jnp.asarray(False))
