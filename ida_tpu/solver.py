"""User-facing solver API (host side).

Mirrors the reference public surface: ``Ida::new`` (src/lib.rs:278),
``Ida::solve`` (src/impl_solve.rs:69), ``get_dky`` (src/lib.rs:424),
``get_solution`` (src/lib.rs:1274), and the ~20 statistics getters
(src/ida_io.rs:10-118) — plus the option setters the reference lacks
(SURVEY.md §5: hin/hmax/tstop/maxord/rootdir/suppressalg/constraints are
fields without setters there).

This class is a thin stateful shell: all numerics happen in the jitted
functional core (``ida_tpu.core``); the shell holds the current ``IdaState``
pytree, decodes status lanes into Python enums/exceptions, and re-uses the
compiled solve across calls.
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .core.solve import solve as core_solve, TASK_NORMAL, TASK_ONE_STEP
from .core.state import IdaState, IdaOptions, init_state
from .core import interp
from .problem import IdaProblem
from .tol_control import TolControl


class IdaTask(enum.Enum):
    """reference src/lib.rs:52-55"""

    Normal = TASK_NORMAL
    OneStep = TASK_ONE_STEP


class IdaSolveStatus(enum.Enum):
    """reference src/lib.rs:57-63"""

    Success = C.SUCCESS
    TStop = C.TSTOP_RETURN
    Root = C.ROOT_RETURN


class IdaError(RuntimeError):
    """A failure status from the solver core (reference src/error.rs taxonomy)."""

    def __init__(self, code: int, t: float | None = None):
        self.code = int(code)
        self.t = t
        self.name = C.STATUS_NAMES.get(self.code, f"UNKNOWN({self.code})")
        msg = f"IDA failure {self.name}"
        if t is not None:
            msg += f" at t = {t:.6e}"
        super().__init__(msg)


class IDA:
    """Implicit DAE solver for ``F(t, y, y') = 0`` (single instance).

    For large ensembles use :mod:`ida_tpu.parallel` (vmapped/sharded core)
    instead of many ``IDA`` objects.
    """

    def __init__(
        self,
        problem: IdaProblem,
        yy0,
        yp0,
        tol: TolControl,
        options: IdaOptions = IdaOptions(),
        *,
        t0: float = 0.0,
        dtype=jnp.float64,
    ):
        self.problem = problem
        self.options = options
        self.tol = tol
        self.state = init_state(problem, yy0, yp0, dtype=dtype, opts=options)
        if t0 != 0.0:
            self.state = self.state._replace(
                tn=jnp.asarray(t0, dtype),
                tlo=jnp.asarray(t0, dtype),
            )
        self._solve_jit = {}

    def reinit(self, yy0, yp0, t0: float = 0.0) -> None:
        """Reinitialize for a new problem instance of the same shape
        (C IDAReInit): resets history, counters, and time, keeps options,
        tolerances, and compiled solvers."""
        dtype = self.state.dtype
        keep = dict(
            hin=self.state.hin,
            hmax_inv=self.state.hmax_inv,
            epcon=self.state.epcon,
            tstop=self.state.tstop,
            tstop_set=self.state.tstop_set,
            constraints=self.state.constraints,
            constraints_set=self.state.constraints_set,
            rootdir=self.state.rootdir,
        )
        self.state = init_state(self.problem, yy0, yp0, dtype=dtype, opts=self.options)
        self.state = self.state._replace(
            tn=jnp.asarray(t0, dtype), tlo=jnp.asarray(t0, dtype), **keep
        )

    # ------------------------------------------------------------------
    # option setters (absent in the reference; SURVEY.md §5)
    # ------------------------------------------------------------------
    def set_initial_step(self, hin: float) -> None:
        self.state = self.state._replace(hin=jnp.asarray(hin, self.state.dtype))

    def set_max_step(self, hmax: float) -> None:
        self.state = self.state._replace(
            hmax_inv=jnp.asarray(0.0 if hmax == 0 else 1.0 / hmax, self.state.dtype)
        )

    def set_stop_time(self, tstop: float) -> None:
        self.state = self.state._replace(
            tstop=jnp.asarray(tstop, self.state.dtype), tstop_set=jnp.asarray(True)
        )

    def clear_stop_time(self) -> None:
        self.state = self.state._replace(tstop_set=jnp.asarray(False))

    def set_root_direction(self, rootdir) -> None:
        self.state = self.state._replace(
            rootdir=jnp.asarray(rootdir, jnp.int32).reshape(self.state.rootdir.shape)
        )

    def set_epcon(self, epcon: float) -> None:
        self.state = self.state._replace(epcon=jnp.asarray(epcon, self.state.dtype))

    def set_constraints(self, constraints) -> None:
        if not self.options.enable_constraints:
            raise ValueError(
                "IdaOptions(enable_constraints=False) traced the solver "
                "without the constraint block; rebuild with it enabled"
            )
        self.state = self.state._replace(
            constraints=jnp.asarray(constraints, self.state.dtype),
            constraints_set=jnp.asarray(True),
        )

    # ------------------------------------------------------------------
    # consistent initial conditions (C IDACalcIC; absent in the reference,
    # SURVEY.md §2.3 in-scope)
    # ------------------------------------------------------------------
    def calc_ic(self, icopt: str, tout1: float) -> None:
        """Compute consistent initial conditions before the first solve.

        icopt: "ya_ydp" (solve for algebraic y + differential y', needs
        problem.id) or "y" (solve for all of y given y').
        """
        from .core.calc_ic import calc_ic as core_calc_ic, IC_YA_YDP_INIT, IC_Y_INIT

        code = {"ya_ydp": IC_YA_YDP_INIT, "y": IC_Y_INIT}[icopt]
        cache = getattr(self, "_calc_ic_jit", {})
        if code not in cache:
            cache[code] = jax.jit(
                partial(
                    core_calc_ic,
                    problem=self.problem,
                    opts=self.options,
                    tol=self.tol,
                    icopt=code,
                )
            )
            self._calc_ic_jit = cache
        state, ok = cache[code](self.state, tout1=jnp.asarray(tout1, self.state.dtype))
        if not bool(ok):
            raise IdaError(C.CONV_FAIL, t=float(self.state.tn))
        self.state = state

    def get_consistent_ic(self):
        """(y0, y'0) after calc_ic (C IDAGetConsistentIC)."""
        return np.asarray(self.state.phi[0]), np.asarray(self.state.phi[1])

    # ------------------------------------------------------------------
    # main entry point (reference impl_solve.rs:69)
    # ------------------------------------------------------------------
    def solve(self, tout: float, itask: IdaTask = IdaTask.Normal):
        """Integrate toward ``tout``. Returns ``(tret, IdaSolveStatus)``;
        raises :class:`IdaError` on failure statuses."""
        self._ls_perf(perftask=False)
        key = itask.value
        if key not in self._solve_jit:
            self._solve_jit[key] = jax.jit(
                partial(
                    core_solve,
                    problem=self.problem,
                    opts=self.options,
                    tol=self.tol,
                    itask=key,
                )
            )
        state, tret, istate = self._solve_jit[key](self.state, tout=tout)
        self.state = state
        self._ls_perf(perftask=True)
        code = int(istate)
        if code < 0:
            raise IdaError(code, t=float(tret))
        return float(tret), IdaSolveStatus(code)

    def solve_grid(self, touts, fused: bool | None = None,
                   max_events: int = 0):
        """Dense trajectory output: integrate through every point of a
        monotone time grid in ONE jitted call, returning the interpolated
        solution at each grid point.

        The device-side equivalent of the reference's host-side output loop
        (examples/roberts.rs:55-70 calls ``solve`` once per row): here the
        grid sweep is a single device program with no host round-trips
        between outputs. Two forms, bit-identical on success paths
        (tests/test_dense_output.py):

        * ``fused=True`` — ``core.solve.solve_dense``: ONE while loop that
          records each grid row in-loop the moment it is crossed. Under
          batching, lanes advance their rows independently (no per-row
          lockstep barrier) — the fast form for ensembles. With roots,
          pass ``max_events`` (static per-lane event-buffer size) and the
          return gains a trailing :class:`~ida_tpu.core.solve.DenseEvents`
          holding every root crossing in the swept span. ``tstop`` follows
          the scan form's semantics (TSTOP_RETURN row at t = tstop, later
          rows integrate past it).
        * ``fused=False`` — ``lax.scan`` over ``core_solve``, one leg per
          row. Root crossings do NOT stop the sweep: each grid point
          re-solves through ROOT_RETURNs until ``tout`` is reached (use
          :meth:`solve` when the events themselves are wanted).

        ``fused=None`` (default) picks the fused form whenever it applies
        (``max_events > 0`` makes it apply to problems with roots).

        Returns ``(tret [T], istate [T], yy [T, N], yp [T, N])`` as numpy
        arrays — plus ``DenseEvents`` when the fused form runs with roots;
        per-point failures are status codes, not exceptions.
        """
        touts = jnp.asarray(touts, self.state.dtype)
        if fused is None:
            fused = self.problem.nroots == 0 or max_events > 0
        if max_events > 0 and not fused:
            raise ValueError(
                "solve_grid: the scan form (fused=False) cannot record "
                "events — drop fused=False, or use solve() for "
                "ROOT_RETURN-driven stepping"
            )

        if fused:
            key = ("grid_fused", max_events if self.problem.nroots else 0)
            if key not in self._solve_jit:
                from .core.solve import solve_dense

                has_roots = self.problem.nroots > 0

                def dense(state, touts):
                    out = solve_dense(
                        state, self.problem, self.options, self.tol, touts,
                        max_events=max_events if has_roots else 0,
                    )
                    st, tret, ist, yy, yp = out[:5]
                    ev = out[6] if has_roots else None
                    return st, (tret, ist, yy, yp, ev)

                self._solve_jit[key] = jax.jit(dense)

            self.state, (tret, istate, yy, yp, ev) = self._solve_jit[key](
                self.state, touts
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

        if "grid" not in self._solve_jit:

            def solve1(st, tout):
                return core_solve(
                    st,
                    problem=self.problem,
                    opts=self.options,
                    tol=self.tol,
                    tout=tout,
                    itask=IdaTask.Normal.value,
                )

            def sweep(state, touts):
                def one(st, tout):
                    st, tret, ist = solve1(st, tout)
                    # continue through root crossings to the grid point
                    st, tret, ist = jax.lax.while_loop(
                        lambda c: c[2] == C.ROOT_RETURN,
                        lambda c: solve1(c[0], tout),
                        (st, tret, ist),
                    )
                    # on success state.yy/yp hold y(tret) (stop-test interp)
                    return st, (tret, ist, st.yy, st.yp)

                return jax.lax.scan(one, state, touts)

            self._solve_jit["grid"] = jax.jit(sweep)

        self.state, (tret, istate, yy, yp) = self._solve_jit["grid"](
            self.state, touts
        )
        return (
            np.asarray(tret),
            np.asarray(istate),
            np.asarray(yy),
            np.asarray(yp),
        )

    def _ls_perf(self, perftask: bool) -> None:
        """Poor-performance monitor (reference idaLsPerf, src/ida_ls.rs:458-499):
        warn when nonlinear/linear convergence failure rates exceed 0.9 per
        step since the last solve call."""
        import warnings

        if not perftask:
            self._perf0 = (
                int(self.state.nst),
                int(self.state.nni),
                int(self.state.ncfn),
                int(self.state.nli),
                int(self.state.ncfl),
            )
            self._nwarn = getattr(self, "_nwarn", 0)
            return
        nst0, nni0, ncfn0, nli0, ncfl0 = getattr(self, "_perf0", (0, 0, 0, 0, 0))
        nstd = int(self.state.nst) - nst0
        nnid = int(self.state.nni) - nni0
        # each rate needs only its own denominator (the reference computes
        # both from one guard because its monitor runs inside the step loop
        # where nstd > 0 always; host-side we may see nstd == 0 on a call
        # whose every attempt failed — the linear rate is still meaningful)
        rcfn = (int(self.state.ncfn) - ncfn0) / nstd if nstd > 0 else 0.0
        rcfl = (int(self.state.ncfl) - ncfl0) / nnid if nnid > 0 else 0.0
        for rate, kind in ((rcfn, "nonlinear"), (rcfl, "linear")):
            if rate > 0.9 and self._nwarn <= 10:
                self._nwarn += 1
                warnings.warn(
                    f"ida_tpu: at t = {float(self.state.tn):.6e}, poor "
                    f"iterative algorithm performance: {kind} convergence "
                    f"failure rate is {rate:.2f}.",
                    RuntimeWarning,
                )

    # ------------------------------------------------------------------
    # interpolated output
    # ------------------------------------------------------------------
    def get_solution(self, t: float):
        """y(t), y'(t) inside the last step (reference src/lib.rs:1274-1343)."""
        state, ok = interp.get_solution(self.state, jnp.asarray(t, self.state.dtype))
        if not bool(ok):
            raise IdaError(C.BAD_T, t=t)
        self.state = state
        return np.asarray(state.yy), np.asarray(state.yp)

    def get_dky(self, t: float, k: int):
        """k-th derivative of the interpolating polynomial at t
        (reference src/lib.rs:424-529)."""
        if k < 0 or k > int(self.state.kused):
            raise IdaError(C.BAD_K)
        dky, ok = interp.get_dky(self.state, jnp.asarray(t, self.state.dtype), k)
        if not bool(ok):
            raise IdaError(C.BAD_T, t=t)
        return np.asarray(dky)

    # ------------------------------------------------------------------
    # observability getters (reference src/ida_io.rs:10-118)
    # ------------------------------------------------------------------
    def get_yy(self):
        return np.asarray(self.state.yy)

    def get_yp(self):
        return np.asarray(self.state.yp)

    def get_last_order(self) -> int:
        return int(self.state.kused)

    def get_current_order(self) -> int:
        return int(self.state.kk)

    def get_actual_init_step(self) -> float:
        return float(self.state.h0u)

    def get_last_step(self) -> float:
        return float(self.state.hused)

    def get_current_step(self) -> float:
        return float(self.state.hh)

    # drop-in alias for the reference's misspelled getter (ida_io.rs:42)
    get_current_setp = get_current_step

    def get_current_time(self) -> float:
        return float(self.state.tn)

    def get_tol_scale_factor(self) -> float:
        return float(self.state.tolsf)

    def get_num_steps(self) -> int:
        return int(self.state.nst)

    def get_num_res_evals(self) -> int:
        return int(self.state.nre)

    def get_num_lin_solv_setups(self) -> int:
        return int(self.state.nsetups)

    def get_num_err_test_fails(self) -> int:
        return int(self.state.netf)

    def get_num_jac_evals(self) -> int:
        return int(self.state.nje)

    def get_num_nonlin_solv_iters(self) -> int:
        return int(self.state.nni)

    def get_num_lin_res_evals(self) -> int:
        return 0  # DQ Jacobian path subsumed by AD; no extra res calls

    def get_num_lin_iters(self) -> int:
        return int(self.state.nli)

    def get_num_prec_solves(self) -> int:
        return int(self.state.nps)

    def get_num_lin_conv_fails(self) -> int:
        """Linear (Krylov) convergence failures (reference ida_ls.rs:52)."""
        return int(self.state.ncfl)

    def get_num_jtsetup_evals(self) -> int:
        """jtimes-setup calls (reference ida_ls.rs:56)."""
        return int(self.state.njtsetup)

    def get_num_jtimes_evals(self) -> int:
        """Jacobian-vector products (reference ida_ls.rs:58)."""
        return int(self.state.njtimes)

    def get_num_nonlin_solv_conv_fails(self) -> int:
        return int(self.state.ncfn)

    def get_num_g_evals(self) -> int:
        return int(self.state.nge)

    def get_root_info(self):
        return np.asarray(self.state.iroots)

    def get_quad(self, t: float | None = None):
        """Quadrature integrals ``∫ q dt`` from t0 to ``t`` (default: the
        last return time) — the IDAS ``IDAGetQuad`` analogue. Requires
        ``problem.nquad > 0`` (core/quad.py). Like get_solution/get_dky
        (and IDAS's IDAGetQuad), ``t`` must lie within the last step."""
        if self.problem.nquad == 0:
            raise ValueError("problem has no quadratures (nquad == 0)")
        from .core.interp import check_t_legal
        from .core.quad import get_quad as _get_quad

        st = self.state
        tt = st.tretlast if t is None else jnp.asarray(t, st.dtype)
        if not bool(check_t_legal(st, tt)):
            raise IdaError(C.BAD_T, t=float(tt))
        return np.asarray(_get_quad(st, self.problem, tt))
