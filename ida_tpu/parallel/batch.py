"""Ensemble (batch) integration: thousands of independent DAE instances in
lockstep on one chip — the DP axis of this domain (SURVEY.md §2.2).

The reference has no parallelism at all (single-problem, single-thread;
SURVEY.md §2.2); this module is the scale-out axis: ``vmap`` the
entire functional solver over a leading batch axis. Every while loop in the
core is masked (ida_tpu.utils.tree), so instances with different step
counts, orders, and retry histories advance together; finished instances
freeze until the whole batch is done.

Per-instance *parameters* work through closure: pass a ``problem_factory``
that builds an :class:`IdaProblem` whose residual closes over a traced
params pytree — under vmap each lane sees its own slice. Per-instance
*tolerances* work the same way (TolControl is a pytree).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..core.solve import solve as core_solve, TASK_NORMAL, TASK_ONE_STEP
from ..core.state import IdaState, IdaOptions, init_state
from ..problem import IdaProblem
from ..tol_control import TolControl

ProblemFactory = Callable[[Any], IdaProblem]


def ensemble_init(
    problem_factory: ProblemFactory,
    params: Any,
    yy0: jax.Array,
    yp0: jax.Array,
    *,
    dtype=jnp.float64,
    opts: IdaOptions = IdaOptions(),
) -> IdaState:
    """Build a batched IdaState: vmap of ``init_state`` over the leading
    axis of (params, yy0[B,N], yp0[B,N])."""

    def one(p, y, ydot):
        return init_state(problem_factory(p), y, ydot, dtype=dtype, opts=opts)

    return jax.vmap(one)(params, jnp.asarray(yy0, dtype), jnp.asarray(yp0, dtype))


def make_ensemble_solve(
    problem_factory: ProblemFactory,
    opts: IdaOptions = IdaOptions(),
    itask: int = TASK_NORMAL,
    *,
    batch_tol: bool = False,
    batch_tout: bool = False,
    donate: bool = True,
):
    """Build a jitted batched solve:
    ``fn(states, params, tol, tout) -> (states, tret[B], istate[B])``.

    ``batch_tol``/``batch_tout`` make tolerances / output times per-instance.
    The state buffers are donated by default (pure in-place update on device).
    """

    def one(state, p, tol, tout):
        return core_solve(state, problem_factory(p), opts, tol, tout, itask)

    in_axes = (0, 0, 0 if batch_tol else None, 0 if batch_tout else None)
    fn = jax.vmap(one, in_axes=in_axes)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


class EnsembleIDA:
    """Stateful convenience wrapper over a vmapped solver (host side).

    For a single instance prefer :class:`ida_tpu.IDA`; this class drives a
    [B]-batch and exposes per-lane statuses instead of exceptions.
    """

    def __init__(
        self,
        problem_factory: ProblemFactory,
        params: Any,
        yy0,
        yp0,
        tol: TolControl,
        options: IdaOptions = IdaOptions(),
        *,
        dtype=jnp.float64,
        mesh=None,
    ):
        """``mesh``: optional :class:`jax.sharding.Mesh` (see
        :func:`ida_tpu.parallel.make_mesh`) — lanes are split across its
        first axis (data parallelism; SURVEY.md §2.2). The batch
        must divide by the mesh size. Everything else is unchanged: XLA
        runs each shard's lockstep solver locally with zero inner-loop
        collectives."""
        self.factory = problem_factory
        self.params = params
        self.options = options
        self.tol = tol
        self.states = ensemble_init(
            problem_factory, params, yy0, yp0, dtype=dtype, opts=options
        )
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            from .mesh import shard_ensemble

            axis = mesh.axis_names[0]
            self.states = shard_ensemble(self.states, mesh, axis)
            spec = NamedSharding(mesh, PartitionSpec(axis))
            self.params = jax.tree_util.tree_map(
                lambda x: jax.device_put(jnp.asarray(x), spec), self.params
            )
        self._solvers = {}

    def solve(self, tout: float, one_step: bool = False):
        """Advance every lane toward ``tout`` (or by one internal step each
        with ``one_step``). Returns (tret[B], istate[B]) as numpy arrays;
        lane failures are status codes, not exceptions."""
        itask = TASK_ONE_STEP if one_step else TASK_NORMAL
        if itask not in self._solvers:
            self._solvers[itask] = make_ensemble_solve(
                self.factory, self.options, itask=itask, donate=False
            )
        self.states, tret, istate = self._solvers[itask](
            self.states, self.params, self.tol, jnp.asarray(tout)
        )
        return np.asarray(tret), np.asarray(istate)

    def solve_grid(self, touts, fused: bool | None = None,
                   max_events: int = 0):
        """Dense trajectory output for the whole ensemble: sweep a monotone
        time grid in ONE jitted program (see ``IDA.solve_grid``). ``touts``
        is [T] (shared grid) or [T, B] (per-lane grids). Returns numpy
        ``(tret [T, B], istate [T, B], yy [T, B, N], yp [T, B, N])``.

        ``fused=None`` auto-selects the dense-output form
        (``core.solve.solve_dense`` under vmap) when the problem has no
        roots — or when it has roots AND ``max_events > 0``, in which case
        the return gains a trailing per-lane
        :class:`~ida_tpu.core.solve.DenseEvents` (leading axis B) holding
        every root crossing in the swept span. Lanes advance through their
        rows independently instead of synchronizing the whole lockstep
        batch at every row — row values are bit-identical either way
        (tests/test_dense_output.py). For the highest-throughput layout use
        the batch-native (trailing-batch) harness directly, as bench.py's
        decades sweep does."""
        nroots = self.factory(self.params[0]).nroots
        if fused is None:
            fused = nroots == 0 or max_events > 0
        if max_events > 0 and not fused:
            raise ValueError(
                "solve_grid: the scan form (fused=False) cannot record "
                "events — drop fused=False, or use solve() for "
                "ROOT_RETURN-driven stepping"
            )

        if fused:
            has_roots = nroots > 0
            key = ("grid_fused", max_events if has_roots else 0)
            if key not in self._solvers:
                from ..core.solve import solve_dense

                def dense(states, params, tol, touts_bt):
                    def one(state, p, tl, touts_t):
                        out = solve_dense(
                            state, self.factory(p), self.options, tl,
                            touts_t,
                            max_events=max_events if has_roots else 0,
                        )
                        st, tret, ist, yy, yp = out[:5]
                        ev = out[6] if has_roots else None
                        return st, tret, ist, yy, yp, ev

                    # tol is shared across lanes (as in make_ensemble_solve)
                    sts, tret, ist, yy, yp, ev = jax.vmap(
                        one, in_axes=(0, 0, None, 0)
                    )(states, params, tol, touts_bt)
                    # per-lane rows come back [B, T(, N)] -> [T, B(, N)];
                    # events keep their leading B (per-lane buffers)
                    mv = lambda x: jnp.moveaxis(x, 0, 1)  # noqa: E731
                    return sts, (mv(tret), mv(ist), mv(yy), mv(yp), ev)

                self._solvers[key] = jax.jit(dense)

            touts = jnp.asarray(touts)
            b = jax.tree_util.tree_leaves(self.states)[0].shape[0]
            if touts.ndim == 1:
                touts = jnp.broadcast_to(touts[:, None], (touts.shape[0], b))
            self.states, (tret, istate, yy, yp, ev) = self._solvers[key](
                self.states, self.params, self.tol, touts.T
            )
            base = (
                np.asarray(tret),
                np.asarray(istate),
                np.asarray(yy),
                np.asarray(yp),
            )
            if ev is not None:
                return base + (jax.tree.map(np.asarray, ev),)
            return base

        if "grid" not in self._solvers:
            base = make_ensemble_solve(
                self.factory,
                self.options,
                itask=TASK_NORMAL,
                batch_tout=True,
                donate=False,
            )

            def sweep(states, params, tol, touts):
                from ..utils import masked_while_loop, tree_where

                def one(sts, tout):
                    sts, tret, ist = base(sts, params, tol, tout)
                    # continue lanes stopped at a root crossing (per-lane
                    # masked; finished lanes freeze) — dense output samples
                    # the grid, it does not stop at events
                    sts, tret, ist = masked_while_loop(
                        lambda c: c[2] == C.ROOT_RETURN,
                        lambda c: base(c[0], params, tol, tout),
                        (sts, tret, ist),
                    )
                    return sts, (tret, ist, sts.yy, sts.yp)

                return jax.lax.scan(one, states, touts)

            self._solvers["grid"] = jax.jit(sweep)

        touts = jnp.asarray(touts)
        b = jax.tree_util.tree_leaves(self.states)[0].shape[0]
        if touts.ndim == 1:
            touts = jnp.broadcast_to(touts[:, None], (touts.shape[0], b))
        self.states, (tret, istate, yy, yp) = self._solvers["grid"](
            self.states, self.params, self.tol, touts
        )
        return (
            np.asarray(tret),
            np.asarray(istate),
            np.asarray(yy),
            np.asarray(yp),
        )

    def calc_ic(self, icopt: str, tout1: float):
        """Per-lane consistent initial conditions (vmapped IDACalcIC).
        Returns a bool[B] success mask; lanes that fail keep their guesses."""
        from ..core.calc_ic import calc_ic as core_calc_ic, IC_YA_YDP_INIT, IC_Y_INIT

        code = {"ya_ydp": IC_YA_YDP_INIT, "y": IC_Y_INIT}[icopt]

        def one(state, p):
            return core_calc_ic(
                state, self.factory(p), self.options, self.tol, code,
                jnp.asarray(tout1, state.dtype),
            )

        self.states, ok = jax.jit(jax.vmap(one))(self.states, self.params)
        return np.asarray(ok)

    @property
    def yy(self):
        return np.asarray(self.states.yy)

    @property
    def nst(self):
        return np.asarray(self.states.nst)

    def status_names(self, istate) -> list[str]:
        return [C.STATUS_NAMES.get(int(s), str(int(s))) for s in istate]

    def report_failures(self, istate=None) -> list[dict]:
        """Host-side decode of failed lanes — *which* lane failed, *why*, at
        *what* t, after how many steps (the honest-error-reporting hard part,
        SURVEY.md §7 item 5). Pass the ``istate`` array returned by
        :meth:`solve`, or omit it to use the statuses stored in the states.

        Returns one dict per failed lane:
        ``{lane, status, status_name, t, nst, hh, hused, kused, ncfn, netf}``.
        """
        status = (
            np.asarray(self.states.status) if istate is None else np.asarray(istate)
        )
        bad = np.nonzero(status < 0)[0]
        tn = np.asarray(self.states.tn)
        nst = np.asarray(self.states.nst)
        hh = np.asarray(self.states.hh)
        hused = np.asarray(self.states.hused)
        kused = np.asarray(self.states.kused)
        ncfn = np.asarray(self.states.ncfn)
        netf = np.asarray(self.states.netf)
        return [
            {
                "lane": int(i),
                "status": int(status[i]),
                "status_name": C.STATUS_NAMES.get(int(status[i]), str(int(status[i]))),
                "t": float(tn[i]),
                "nst": int(nst[i]),
                "hh": float(hh[i]),
                "hused": float(hused[i]),
                "kused": int(kused[i]),
                "ncfn": int(ncfn[i]),
                "netf": int(netf[i]),
            }
            for i in bad
        ]

    def format_failures(self, istate=None) -> str:
        """Readable multi-line report of :meth:`report_failures` (empty
        string when every lane is healthy)."""
        rows = self.report_failures(istate)
        return "\n".join(
            f"lane {r['lane']}: {r['status_name']} at t={r['t']:.6e} "
            f"(nst={r['nst']}, h={r['hh']:.3e}, last h={r['hused']:.3e}, "
            f"k={r['kused']}, ncfn={r['ncfn']}, netf={r['netf']})"
            for r in rows
        )


# ----------------------------------------------------------------------
# Straggler control: stratified (sorted sub-batch) ensemble solve
# ----------------------------------------------------------------------

def make_stratified_solve(
    problem_factory: ProblemFactory,
    opts: IdaOptions = IdaOptions(),
    *,
    n_chunks: int = 4,
):
    """Straggler control for mixed-stiffness ensembles.

    A lockstep batch runs until its SLOWEST lane finishes, so a batch mixing
    cheap and expensive instances wastes (max-mean)/max of the LANES
    (measured on CPU: 19% waste over a 2-decade Roberts rate-constant
    spread; sorted k=4 sub-batching cuts it to ~5%).

    **When to use (measured, PERF.md):** only when lanes have linear cost —
    CPU hosts, or batches far beyond device saturation. On an earlier
    accelerator at B <= ~256k the device was resource-bound, masked idle
    lanes were free, and stratification lost (each sub-batch pays the
    full per-iteration wall); on the GPU this is not yet measured. This
    builds
    ``fn(states, params, tol, tout, cost_key) -> (states, tret, istate)``
    that sorts lanes by ``cost_key`` (any per-lane cost proxy: a stiffness
    estimate, or nst from a cheap pilot solve — see :func:`pilot_cost`),
    solves ``n_chunks`` contiguous sub-batches separately so similar-cost
    lanes run in lockstep together, and restores the original lane order.

    B must be divisible by ``n_chunks``. Each call dispatches ``n_chunks``
    device programs; keep B/n_chunks large enough to saturate the device.
    """
    base = make_ensemble_solve(problem_factory, opts, donate=False)

    def fn(states: IdaState, params, tol, tout, cost_key):
        b = jax.tree_util.tree_leaves(states)[0].shape[0]
        assert b % n_chunks == 0, f"batch {b} not divisible into {n_chunks} chunks"
        order = jnp.argsort(jnp.asarray(cost_key))
        take = lambda x: jnp.take(jnp.asarray(x), order, axis=0)  # noqa: E731
        states_s = jax.tree_util.tree_map(take, states)
        params_s = jax.tree_util.tree_map(take, params)

        outs = []
        csz = b // n_chunks
        for c in range(n_chunks):
            sl = lambda x: x[c * csz : (c + 1) * csz]  # noqa: B023,E731
            st_c = jax.tree_util.tree_map(sl, states_s)
            p_c = jax.tree_util.tree_map(sl, params_s)
            outs.append(base(st_c, p_c, tol, jnp.asarray(tout)))

        cat = lambda *xs: jnp.concatenate(xs, axis=0)  # noqa: E731
        states_o = jax.tree_util.tree_map(cat, *[o[0] for o in outs])
        tret_o = jnp.concatenate([o[1] for o in outs])
        ist_o = jnp.concatenate([o[2] for o in outs])

        inv = jnp.argsort(order)  # undo the sort
        untake = lambda x: jnp.take(x, inv, axis=0)  # noqa: E731
        return (
            jax.tree_util.tree_map(untake, states_o),
            untake(tret_o),
            untake(ist_o),
        )

    return fn


def pilot_cost(
    problem_factory: ProblemFactory,
    states: IdaState,
    params,
    tol,
    tout_pilot,
    opts: IdaOptions = IdaOptions(),
):
    """Cheap per-lane cost key for :func:`make_stratified_solve`: run the
    ensemble to a short horizon ``tout_pilot`` and return each lane's step
    count (early stiffness strongly predicts total cost for Roberts-class
    kinetics). Solves a COPY of the states; the originals are untouched."""
    fn = make_ensemble_solve(problem_factory, opts, donate=False)
    st, _, _ = fn(states, params, tol, jnp.asarray(tout_pilot))
    return st.nst
