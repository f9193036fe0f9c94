"""Run the solver's main paths on one GPU and check every answer.

Each phase drives a user entry point (``IDA``, ``solve_dae``,
``EnsembleIDA``, the batch-native harness that ``bench.py`` times,
``sensitivity.adjoint_gradient``) at the size the repo treats as real,
and compares the result with an independent reference: the native C++
oracle (``ida_tpu.native``), the same solve on this process's CPU
backend, or central differences. Each phase prints one line: its
numbers, its tolerance and why, the seconds spent compiling and running
on the card, and the card's name and power limit. The last line,
printed only when every phase passed, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Run from the repository root:

    python chip_smoke.py          # one GPU: device, parity, ensemble,
                                  # krylov and gradient phases
    python chip_smoke.py --four   # four GPUs: the multi-device path only

Without a GPU it exits non-zero and prints no result. It opens the card
from this one process; nothing it starts touches JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

RTOL = 1.0e-4
ATOL = np.array([1.0e-8, 1.0e-6, 1.0e-6])
#: idaRoberts_dns output times and C IDA's step count at each of them
DECADES = [0.4 * 10.0**k for k in range(12)]
CANONICAL_NST = [29, 43, 68, 95, 126, 161, 202, 250, 293, 325, 348, 362]
#: step-control fields of the per-attempt trace that decide parity
STEP_FIELDS = ("nst", "kk", "hh", "netf", "ncfn")

ENSEMBLE_BATCH = 262144  # bench.py's headline width
ENSEMBLE_TOUT = 400.0
ORACLE_LANES = 8
#: two integrations whose step sequences differ drift apart by a few
#: error-weight units (tests/test_native_oracle.py). That covers the
#: oracle lanes and the same solve under another rounding order (CPU vs
#: GPU, one card vs four), where one flipped borderline step decision is
#: enough: heat2d 100x100 split over four virtual CPU devices took 200
#: steps against 202 and landed 1.6 units away
DRIFT_WRMS_LIMIT = 10.0
#: the float32 Krylov correction inside the float64 Newton loop must not
#: move any output by one local-error unit
SINGLE_WRMS_LIMIT = 1.0
#: float32 foodweb residual vs float64 numpy, in float32 epsilons of the
#: summand bound: a handful of roundings, where TF32 costs thousands
F32_RES_LIMIT = 4.0
#: adjoint vs central differences (tests/test_adjoint.py)
GRAD_REL_LIMIT = 5e-4

HEAT_M, HEAT_TOUT = 100, 0.16  # idaHeat2D_kry grid
HEAT_RTOL, HEAT_ATOL = 1e-5, 1e-8
FOODWEB_M, FOODWEB_BATCH = 20, 128  # idaFoodWeb_kry grid
FOODWEB_TOUTS = (1e-3, 4e-3, 1.6e-2, 6.4e-2)
FOODWEB_RTOL = FOODWEB_ATOL = 1e-5


# ---------------------------------------------------------------------------
# checks (numpy only; tests/test_chip_smoke.py runs them on the CPU)


def wrms(y, ref, rtol, atol):
    """Weighted RMS distance of ``y`` from ``ref`` over the last axis, in
    the error weights ``1 / (rtol |ref| + atol)`` the solver uses."""
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    w = 1.0 / (rtol * np.abs(ref) + atol)
    return np.sqrt(np.mean(((y - ref) * w) ** 2, axis=-1))


def roberts_np(k):
    """Residual and Jacobian of Roberts with rate constants ``k`` as numpy
    callbacks for the native oracle."""
    k1, k2, k3 = (float(v) for v in k)

    def res(t, y, yp):
        r0 = -k1 * y[0] + k2 * y[1] * y[2]
        return np.array([r0 - yp[0], -r0 - k3 * y[1] ** 2 - yp[1],
                         y[0] + y[1] + y[2] - 1.0])

    def jac(t, cj, y, yp, r):
        return np.array([
            [-k1 - cj, k2 * y[2], k2 * y[1]],
            [k1, -k2 * y[2] - 2.0 * k3 * y[1] - cj, -k2 * y[1]],
            [1.0, 1.0, 1.0],
        ])

    return res, jac


def oracle_lanes(params, tout, n_lanes=ORACLE_LANES):
    """Solve ``n_lanes`` lanes of a Roberts ensemble, spread evenly over
    its parameter rows, with the native oracle. Returns (lane indices,
    y(tout) [n_lanes, 3])."""
    from ida_tpu.native import oracle_solve

    params = np.asarray(params, np.float64)
    lanes = np.unique(np.linspace(0, len(params) - 1, n_lanes).round().astype(int))
    refs = []
    for i in lanes:
        res, jac = roberts_np(params[i])
        yp0 = params[i, 0] * np.array([-1.0, 1.0, 0.0])
        ret, y_out, _ = oracle_solve(res, jac, [1.0, 0.0, 0.0], yp0, [tout],
                                     RTOL, ATOL)
        if ret != 0:
            raise RuntimeError(f"oracle failed on lane {i}: ret={ret}")
        refs.append(y_out[-1])
    return lanes, np.asarray(refs)


def foodweb_res_np(c, cp, m=FOODWEB_M):
    """The foodweb residual in float64 numpy, written apart from the JAX
    model, and a per-component bound on the size of its summands (the
    scale its rounding error is measured against)."""
    from ida_tpu.models import foodweb as fw

    c3 = np.asarray(c, np.float64).reshape(m, m, 2)
    cp3 = np.asarray(cp, np.float64).reshape(m, m, 2)
    x = np.linspace(0.0, 1.0, m)
    fac = 1.0 + fw.ALPHA * np.outer(x, x)
    b = np.stack([fw.BB * fac, -fw.BB * fac], axis=-1)
    a = np.array([[-fw.AA, -fw.GG], [fw.EE, -fw.AA]])
    d = np.array([fw.DPREY, fw.DPRED])
    inv_h2 = (m - 1.0) ** 2
    # reflective boundaries: the outward neighbour is the inward one
    p = np.pad(c3, ((1, 1), (1, 1), (0, 0)), mode="reflect")
    nbr = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
    rates = b + c3 @ a.T
    f = d * (nbr - 4.0 * c3) * inv_h2 + c3 * rates
    prey = np.array([True, False])
    res = np.where(prey, cp3 - f, -f)
    pa = np.abs(p)
    nbr_abs = pa[:-2, 1:-1] + pa[2:, 1:-1] + pa[1:-1, :-2] + pa[1:-1, 2:]
    scale = (np.abs(cp3) + d * (nbr_abs + 4.0 * np.abs(c3)) * inv_h2
             + np.abs(c3) * (np.abs(b) + np.abs(c3) @ np.abs(a).T))
    return res.reshape(-1), scale.reshape(-1)


def foodweb_f32_res_error(m=FOODWEB_M, seed=0):
    """Largest error of the float32 foodweb residual, on the default
    device, against :func:`foodweb_res_np`, in units of float32 epsilon
    times the summand bound. A contraction run in TF32 (10-bit mantissa)
    lands in the thousands of these units."""
    import jax
    import jax.numpy as jnp
    from ida_tpu.models.foodweb import foodweb_ic, foodweb_problem

    rng = np.random.default_rng(seed)
    c0, _ = foodweb_ic(m, m)
    c = (c0 * (1.0 + 0.1 * rng.standard_normal(c0.shape))).astype(np.float32)
    cp = (1e3 * rng.standard_normal(c0.shape)).astype(np.float32)
    prob = foodweb_problem(m, m)
    got = np.asarray(jax.jit(prob.res)(jnp.float32(0.0), jnp.asarray(c),
                                       jnp.asarray(cp)), np.float64)
    ref, scale = foodweb_res_np(c, cp, m)
    return float(np.max(np.abs(got - ref) / (np.finfo(np.float32).eps * scale)))


def heat2d_exact(m, t):
    """The heat2d model's semi-discrete solution at time ``t``, exactly:
    the interior is the 5-point Dirichlet Laplacian, whose eigenvectors
    are products of sines, so u(t) is a sine transform of u0 with each
    mode decayed by exp(lambda t)."""
    from ida_tpu.models.heat2d import heat2d_ic

    u0, _ = heat2d_ic(m)
    n = m - 1
    k = np.arange(1, m - 1)
    s = np.sin(np.pi * np.outer(k, k) / n)  # symmetric: modes x points
    lam = -4.0 * n**2 * np.sin(np.pi * k / (2 * n)) ** 2
    coef = (2.0 / n) ** 2 * s @ u0.reshape(m, m)[1:-1, 1:-1] @ s
    u = np.zeros((m, m))
    u[1:-1, 1:-1] = s @ (coef * np.exp(t * (lam[:, None] + lam[None, :]))) @ s
    return u.reshape(-1)


def result_line(devices) -> str:
    """The script's last line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }})


# ---------------------------------------------------------------------------
# reporting


def card_info() -> list[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` as it prints it, one
    line per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        return ["nvidia-smi not found"]
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines if out.returncode == 0 and lines else [
        f"nvidia-smi exit {out.returncode}"
    ]


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, read from its
    own monitoring spans; nested spans count once."""

    EVENTS = frozenset({
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    })

    def __init__(self):
        import jax

        self.spans = []
        jax.monitoring.register_event_time_span_listener(self._on_span)

    def _on_span(self, event, start, end, **_):
        if event in self.EVENTS:
            self.spans.append((start, end))

    def seconds(self, t0, t1):
        total, edge = 0.0, t0
        for s, e in sorted(self.spans):
            s, e = max(s, edge), min(e, t1)
            if e > s:
                total += e - s
                edge = e
        return total


class Stopwatch:
    """Wall and compile seconds of the device work of one phase."""

    def __init__(self, clock):
        self.clock = clock
        self.wall = 0.0
        self.compile = 0.0

    def __call__(self, fn):
        t0 = time.time()
        out = fn()
        t1 = time.time()
        self.wall += t1 - t0
        self.compile += self.clock.seconds(t0, t1)
        return out

    def __str__(self):
        return (f"compile_s={self.compile:.1f} "
                f"run_s={self.wall - self.compile:.2f}")


def report(name, ok, card, numbers, tolerance, watch=None):
    fields = [f"[{name}] {'PASS' if ok else 'FAIL'}"]
    fields += [f"{k}={v}" for k, v in numbers.items()]
    fields.append(f"tolerance: {tolerance}")
    if watch is not None:
        fields.append(str(watch))
    fields.append(f"card: {card}")
    print(" | ".join(fields), flush=True)
    return bool(ok)


def _g(x):
    return f"{float(x):.3e}"


# ---------------------------------------------------------------------------
# phases


def phase_device(devices, card, cache_dir):
    import jax
    import jaxlib

    d = devices[0]
    return report("device", d.platform == "gpu", card, {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(devices),
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "XLA_FLAGS": repr(os.environ.get("XLA_FLAGS", "")),
        "compile_cache": cache_dir,
    }, "platform must be gpu: the run never moves to the CPU by itself")


def _first_divergence(touts):
    """Rerun Roberts over ``touts`` with the per-attempt trace on, beside
    the native oracle's own trace, and return the first step attempt whose
    step-control fields differ: (attempt, field, difference) or None."""
    import tempfile

    import jax.numpy as jnp
    from ida_tpu import IDA, IdaOptions
    from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0
    from ida_tpu.models import roberts_problem
    from ida_tpu.native import oracle_solve_traced
    from ida_tpu.tol_control import tol_sv
    from ida_tpu.utils.trace import DataTrace
    from scripts.compare_traces import divergences, load

    ida = IDA(roberts_problem(with_roots=False), ROBERTS_YY0, ROBERTS_YP0,
              tol_sv(RTOL, jnp.asarray(ATOL)),
              options=IdaOptions(debug_trace=True))
    with DataTrace() as tr:
        for t in touts:
            ida.solve(t)
    res, jac = roberts_np(ROBERTS_PARAMS)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "oracle.jsonl")
        oracle_solve_traced(res, jac, ROBERTS_YY0, ROBERTS_YP0, touts, RTOL,
                            ATOL, path)
        oracle = load(path)
    return next(divergences(tr.records, oracle, atol=0.0, rtol=1e-10,
                            fields=STEP_FIELDS), None)


def phase_parity(card, clock):
    """Roberts through ``IDA`` over 12 decades against the native oracle,
    and the rooted variant through ``solve_dae``."""
    import jax.numpy as jnp
    from examples.roberts import ans_wrms
    from ida_tpu import IDA, solve_dae
    from ida_tpu.models import ROBERTS_YP0, ROBERTS_YY0, roberts_problem
    from ida_tpu.native import oracle_roberts_trajectory
    from ida_tpu.tol_control import tol_sv

    ret, y_oracle, nst_oracle = oracle_roberts_trajectory(DECADES)
    if ret != 0:
        raise RuntimeError(f"oracle trajectory failed: ret={ret}")
    watch = Stopwatch(clock)
    ida = watch(lambda: IDA(roberts_problem(with_roots=False), ROBERTS_YY0,
                            ROBERTS_YP0, tol_sv(RTOL, jnp.asarray(ATOL))))

    def sweep():
        nst, ys = [], []
        for t in DECADES:
            ida.solve(t)
            nst.append(ida.get_num_steps())
            ys.append(ida.get_yy())
        return nst, np.asarray(ys)

    nst, ys = watch(sweep)
    rel = np.max(np.abs((ys - y_oracle) / y_oracle), axis=1)
    limits = np.where(np.asarray(DECADES) <= 4.0e4, 1e-10, 1e-6)
    parity = (nst == CANONICAL_NST
              and nst_oracle.tolist() == CANONICAL_NST
              and bool(np.all(rel <= limits)))
    decade_wrms = wrms(ys, y_oracle, RTOL, ATOL)

    prob = roberts_problem(with_roots=True)
    sol = watch(lambda: solve_dae(
        prob.res, (0.0, DECADES[-1]), ROBERTS_YY0, ROBERTS_YP0,
        t_eval=DECADES, rtol=RTOL, atol=ATOL, jac=prob.jac, roots=prob.root,
    ))
    ans = ans_wrms(sol.y[-1])
    rooted = sol.success and ans < 1.0 and len(sol.t_events) == 2

    numbers = {
        "nst": nst,
        "nst_equals_canonical": nst == CANONICAL_NST,
        "rel_err_to_oracle_max_t<=4e4": _g(rel[limits == 1e-10].max()),
        "rel_err_to_oracle_max_t>4e4": _g(rel[limits == 1e-6].max()),
        "parity": parity,
        "rooted_check_ans_wrms": f"{ans:.4f}",
        "rooted_t_events": [f"{t:.4e}" for t in sol.t_events],
    }
    if parity:
        ok = rooted
        tolerance = ("per-decade nst == C IDA table; |y - oracle|/|y| <= "
                     "1e-10 through t=4e4 and <= 1e-6 after (rounding "
                     "accumulates on the 1e-13-size y2 tail); rooted run "
                     "check_ans WRMS < 1 with both roots found")
    else:
        first = next(
            k for k in range(len(DECADES)) if nst[k] != CANONICAL_NST[k]
        ) if nst != CANONICAL_NST else len(DECADES) - 1
        numbers["first_divergence"] = _first_divergence(DECADES[:first + 1])
        numbers["decade_wrms_to_oracle_max"] = f"{decade_wrms.max():.4f}"
        ok = rooted and bool(decade_wrms.max() < 1.0)
        tolerance = ("step parity does not hold on this card, so the "
                     "check_ans-level criterion applies: WRMS to the oracle "
                     "< 1 at every decade (the two engines then take "
                     "different rounding-driven step sequences, each "
                     "within its local error test); rooted run check_ans "
                     "WRMS < 1 with both roots found")
    return report("parity", ok, card, numbers, tolerance, watch)


def phase_ensemble(card, clock, batch=ENSEMBLE_BATCH, tout=ENSEMBLE_TOUT,
                   n_oracle=ORACLE_LANES):
    """The Roberts ensemble at bench.py's headline width, through
    ``EnsembleIDA`` (vmapped) and the batch-native harness, each checked
    lane-by-lane against the native oracle."""
    import jax
    import jax.numpy as jnp

    import bench
    from ida_tpu import constants as C
    from ida_tpu.models import ROBERTS_YY0, roberts_factory
    from ida_tpu.parallel import EnsembleIDA, ensemble_init
    from ida_tpu.tol_control import tol_sv

    params_np = bench.roberts_params(batch)
    params = jnp.asarray(params_np)
    yy0 = np.tile(ROBERTS_YY0, (batch, 1))
    yp0 = params_np[:, :1] * np.array([-1.0, 1.0, 0.0])
    tol = tol_sv(RTOL, jnp.asarray(ATOL))
    watch = Stopwatch(clock)

    # vmapped: compile + first run, then a timed run from fresh states
    ens = watch(lambda: EnsembleIDA(roberts_factory, params, yy0, yp0, tol))
    watch(lambda: ens.solve(tout))
    ens.states = jax.block_until_ready(
        ensemble_init(roberts_factory, params, yy0, yp0)
    )
    t0 = time.perf_counter()
    _, ist_v = ens.solve(tout)
    wall_v = time.perf_counter() - t0
    yy_v, steps_v = ens.yy, float(ens.nst.sum())

    # batch-native (trailing batch, no vmap): what bench.py times
    fn, states_T = watch(lambda: bench.native_ensemble_solver(batch, jnp.float64))
    tout_T = jnp.full((batch,), tout)
    watch(lambda: jax.block_until_ready(fn(states_T, tout=tout_T)))
    states_T = jax.block_until_ready(bench._native_setup(batch, jnp.float64)[0])
    t0 = time.perf_counter()
    st, _, ist_n = jax.block_until_ready(fn(states_T, tout=tout_T))
    wall_n = time.perf_counter() - t0
    yy_n, ist_n = np.asarray(st.yy).T, np.asarray(ist_n)
    steps_n = float(np.asarray(st.nst).sum())

    lanes, refs = oracle_lanes(params_np, tout, n_oracle)
    err_v = wrms(yy_v[lanes], refs, RTOL, ATOL)
    err_n = wrms(yy_n[lanes], refs, RTOL, ATOL)
    ok_v = int((ist_v == C.SUCCESS).sum())
    ok_n = int((ist_n == C.SUCCESS).sum())
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    ok = (ok_v == batch and ok_n == batch
          and bool(np.all(err_v < DRIFT_WRMS_LIMIT))
          and bool(np.all(err_n < DRIFT_WRMS_LIMIT)))
    return report("ensemble", ok, card, {
        "B": batch, "tout": tout, "dtype": "f64",
        "success_vmapped": ok_v, "success_native": ok_n,
        "steps_vmapped": steps_v, "steps_native": steps_n,
        "wall_vmapped_s": f"{wall_v:.4f}", "wall_native_s": f"{wall_n:.4f}",
        "steps_per_s_vmapped": f"{steps_v / wall_v:.1f}",
        "steps_per_s_native": f"{steps_n / wall_n:.1f}",
        "oracle_lanes": lanes.tolist(),
        "oracle_wrms_max_vmapped": f"{err_v.max():.4f}",
        "oracle_wrms_max_native": f"{err_n.max():.4f}",
        "peak_bytes_in_use": peak,
    }, f"every lane SUCCESS; each oracle lane WRMS < {DRIFT_WRMS_LIMIT:g} "
       "in its own error weights (independent rtol=1e-4 runs drift by a "
       "few weight units; tests/test_native_oracle.py)", watch)


def _foodweb_ensemble(scales, ls_precision):
    """Batched foodweb through ``EnsembleIDA``: perturbed prey ICs, calc_ic
    for the algebraic predators, then the four outputs. Returns
    (calc_ic ok [B], istate [T, B], yy [T, B, N])."""
    import jax.numpy as jnp
    from ida_tpu import IdaOptions
    from ida_tpu.models.foodweb import foodweb_ic, foodweb_problem
    from ida_tpu.parallel import EnsembleIDA
    from ida_tpu.tol_control import tol_ss

    prob = foodweb_problem(FOODWEB_M, FOODWEB_M)
    c0, cp0 = foodweb_ic(FOODWEB_M, FOODWEB_M)
    scales = np.asarray(scales, np.float64)
    prey = np.asarray(prob.id)
    yy0 = c0[None, :] * np.where(prey[None, :], scales[:, None], 1.0)
    yp0 = np.tile(cp0, (len(scales), 1))
    opts = IdaOptions(linear_solver="spgmr", mxstep=5000, krylov_maxl=12,
                      krylov_max_restarts=10, ls_precision=ls_precision)
    ens = EnsembleIDA(lambda s: prob, jnp.asarray(scales), yy0, yp0,
                      tol_ss(FOODWEB_RTOL, FOODWEB_ATOL), opts)
    ic_ok = ens.calc_ic("ya_ydp", FOODWEB_TOUTS[0])
    ists, rows = [], []
    for t in FOODWEB_TOUTS:
        _, ist = ens.solve(t)
        ists.append(ist)
        rows.append(ens.yy)
    return ic_ok, np.stack(ists), np.stack(rows)


def _heat2d():
    """heat2d through ``IDA`` with SPGMR to HEAT_TOUT: (yy, nst, nli, ok)."""
    from ida_tpu import IDA, IdaOptions, IdaSolveStatus
    from ida_tpu.models.heat2d import heat2d_ic, heat2d_problem
    from ida_tpu.tol_control import tol_ss

    prob = heat2d_problem(HEAT_M, use_prec=True)
    u0, up0 = heat2d_ic(HEAT_M)
    ida = IDA(prob, u0, up0, tol_ss(HEAT_RTOL, HEAT_ATOL),
              IdaOptions(linear_solver="spgmr", mxstep=20000))
    _, status = ida.solve(HEAT_TOUT)
    return (ida.get_yy(), ida.get_num_steps(), ida.get_num_lin_iters(),
            status == IdaSolveStatus.Success)


def phase_krylov(card, clock, fw_batch=FOODWEB_BATCH):
    """heat2d 100x100 and batched foodweb 20x20 on the SPGMR path, each
    against the same solve on this process's CPU backend; foodweb in full
    and in single-precision Krylov."""
    import jax
    from ida_tpu import constants as C

    watch = Stopwatch(clock)
    cpu = jax.devices("cpu")[0]
    res_err = watch(foodweb_f32_res_error)
    yy_h, nst_h, nli_h, ok_h = watch(_heat2d)
    scales = np.linspace(0.95, 1.05, fw_batch)
    ic_f, ist_f, yy_f = watch(lambda: _foodweb_ensemble(scales, "full"))
    ic_s, ist_s, yy_s = watch(lambda: _foodweb_ensemble(scales, "single"))

    t0 = time.perf_counter()
    with jax.default_device(cpu):
        yy_hc, nst_hc, _, ok_hc = _heat2d()
        ic_c, ist_c, yy_c = _foodweb_ensemble(scales[:1], "full")
    cpu_s = time.perf_counter() - t0

    heat_wrms = float(wrms(yy_h, yy_hc, HEAT_RTOL, HEAT_ATOL))
    exact = heat2d_exact(HEAT_M, HEAT_TOUT)
    heat_exact_gpu = float(wrms(yy_h, exact, HEAT_RTOL, HEAT_ATOL))
    heat_exact_cpu = float(wrms(yy_hc, exact, HEAT_RTOL, HEAT_ATOL))
    lane0_wrms = wrms(yy_f[:, 0], yy_c[:, 0], FOODWEB_RTOL, FOODWEB_ATOL)
    single_wrms = wrms(yy_s, yy_f, FOODWEB_RTOL, FOODWEB_ATOL)  # [T, B]
    fw_ok = (ic_f.all() and ic_s.all() and ic_c.all()
             and bool(np.all(ist_f == C.SUCCESS))
             and bool(np.all(ist_s == C.SUCCESS))
             and bool(np.all(ist_c == C.SUCCESS)))
    ok = (ok_h and ok_hc and fw_ok and res_err < F32_RES_LIMIT
          and heat_wrms < DRIFT_WRMS_LIMIT
          and heat_exact_gpu < DRIFT_WRMS_LIMIT
          and bool(np.all(lane0_wrms < DRIFT_WRMS_LIMIT))
          and bool(np.all(single_wrms < SINGLE_WRMS_LIMIT)))
    return report("krylov", ok, card, {
        "heat2d": f"{HEAT_M}x{HEAT_M} N={HEAT_M**2} t={HEAT_TOUT:g}",
        "heat2d_nst_gpu": nst_h, "heat2d_nst_cpu": nst_hc,
        "heat2d_nli_gpu": nli_h,
        "heat2d_wrms_gpu_vs_cpu": f"{heat_wrms:.3e}",
        "heat2d_wrms_to_exact_gpu": f"{heat_exact_gpu:.3e}",
        "heat2d_wrms_to_exact_cpu": f"{heat_exact_cpu:.3e}",
        "foodweb": f"{FOODWEB_M}x{FOODWEB_M} N={2 * FOODWEB_M**2} "
                   f"B={fw_batch} t={FOODWEB_TOUTS[-1]:g}",
        "foodweb_success_full": int((ist_f[-1] == C.SUCCESS).sum()),
        "foodweb_success_single": int((ist_s[-1] == C.SUCCESS).sum()),
        "foodweb_lane0_wrms_gpu_vs_cpu_max": f"{lane0_wrms.max():.3e}",
        "foodweb_single_vs_full_wrms_max": f"{single_wrms.max():.3e}",
        "foodweb_f32_res_err_eps": f"{res_err:.3f}",
        "cpu_reference_s": f"{cpu_s:.1f}",
    }, f"every solve SUCCESS; GPU vs CPU, and heat2d vs its exact "
       f"semi-discrete solution, WRMS < {DRIFT_WRMS_LIMIT:g} (one algorithm, "
       "two rounding orders: a flipped borderline step leaves two runs a "
       "few weight units apart, and local error control leaves the global "
       "error a few units); single vs full WRMS < "
       f"{SINGLE_WRMS_LIMIT:g} at every output (the f32 Krylov correction "
       "must not move an answer by one local-error unit); float32 "
       f"foodweb residual within {F32_RES_LIMIT:g} float32 epsilons of its "
       "summand bound from a float64 numpy reference (a few roundings; a "
       "contraction in TF32 costs thousands)", watch)


def phase_gradient(card, clock):
    """One discrete adjoint gradient of a Roberts loss against central
    differences of the same solve."""
    import jax
    import jax.numpy as jnp
    from ida_tpu import IdaOptions
    from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
    from ida_tpu.sensitivity import adjoint_gradient, solve_with_params
    from ida_tpu.tol_control import tol_sv

    tol = tol_sv(RTOL, jnp.asarray(ATOL))
    p0 = jnp.asarray(ROBERTS_PARAMS)
    w = jnp.asarray([1.0, 2.0, 3.0])

    def yy0_of(p):
        return jnp.asarray(ROBERTS_YY0)

    def yp0_of(p):
        return p[0] * jnp.asarray([-1.0, 1.0, 0.0])

    def loss_of(y):
        return jnp.sum(y * w)

    watch = Stopwatch(clock)
    _, grad, ist = watch(lambda: jax.block_until_ready(adjoint_gradient(
        roberts_factory, p0, yy0_of, yp0_of, tol, 4.0, loss_of,
        max_attempts=120,
    )))
    f = jax.jit(solve_with_params(roberts_factory, p0, yy0_of, yp0_of, tol,
                                  4.0, IdaOptions(unroll_newton=True)))

    def central():
        fd = []
        for i in range(3):
            eps = 1e-6 * float(p0[i])
            v = jnp.zeros(3).at[i].set(eps)
            fd.append((float(loss_of(f(p0 + v))) - float(loss_of(f(p0 - v))))
                      / (2.0 * eps))
        return np.asarray(fd)

    fd = watch(central)
    grad = np.asarray(grad)
    rel = np.abs(grad - fd) / np.maximum(np.abs(fd), 1e-12)
    ok = int(ist) == 0 and bool(np.all(np.isfinite(grad))) and bool(
        np.all(rel < GRAD_REL_LIMIT))
    return report("gradient", ok, card, {
        "loss": "<(1,2,3), y(4)>", "istate": int(ist),
        "grad": [_g(g) for g in grad], "central_diff": [_g(g) for g in fd],
        "rel_err_max": _g(rel.max()),
    }, f"relative error < {GRAD_REL_LIMIT:g} per component (central "
       "differences with eps = 1e-6 p_i carry ~1e-6 truncation and the "
       "solve's own tolerance noise; tests/test_adjoint.py)", watch)


def phase_four(card, clock, batch=ENSEMBLE_BATCH, tout=ENSEMBLE_TOUT):
    """The multi-device path on four cards against one card: the
    dp-sharded ensemble, its HLO, sharded-N heat2d and BBD foodweb."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from ida_tpu import IdaOptions
    from ida_tpu import constants as C
    from ida_tpu.core.calc_ic import IC_YA_YDP_INIT, calc_ic
    from ida_tpu.core.solve import solve as core_solve
    from ida_tpu.core.state import init_state
    from ida_tpu.models import ROBERTS_YY0, roberts_factory
    from ida_tpu.models.foodweb import foodweb_ic, foodweb_problem
    from ida_tpu.models.heat2d import heat2d_ic, heat2d_problem
    from ida_tpu.parallel import (EnsembleIDA, make_ensemble_solve, make_mesh,
                                  shard_state_vector)
    from ida_tpu.parallel.mesh import data_collectives
    from ida_tpu.tol_control import tol_ss, tol_sv

    mesh = make_mesh(4)
    watch = Stopwatch(clock)

    # dp: the ensemble's lanes split over four cards vs the same lanes on one
    params = jnp.asarray(bench.roberts_params(batch))
    yy0 = np.tile(ROBERTS_YY0, (batch, 1))
    yp0 = np.asarray(params)[:, :1] * np.array([-1.0, 1.0, 0.0])
    tol = tol_sv(RTOL, jnp.asarray(ATOL))
    ens4 = watch(lambda: EnsembleIDA(roberts_factory, params, yy0, yp0, tol,
                                     mesh=mesh))
    _, ist4 = watch(lambda: ens4.solve(tout))
    ens1 = watch(lambda: EnsembleIDA(roberts_factory, params, yy0, yp0, tol))
    _, ist1 = watch(lambda: ens1.solve(tout))
    counters = ("nst", "nni", "nre", "nje", "netf", "ncfn")
    same_counters = all(
        np.array_equal(np.asarray(getattr(ens4.states, f)),
                       np.asarray(getattr(ens1.states, f)))
        for f in counters
    )
    dp_rel = float(np.max(np.abs(ens4.yy - ens1.yy) / np.abs(ens1.yy)))
    dp_ok = (len(ens4.states.phi.sharding.device_set) == 4
             and bool(np.all(ist4 == C.SUCCESS))
             and np.array_equal(ist4, ist1) and same_counters
             and dp_rel <= 1e-10)
    hlo = watch(lambda: make_ensemble_solve(roberts_factory, donate=False).lower(
        ens4.states, ens4.params, tol, jnp.asarray(tout)).compile().as_text())
    dp_moves = data_collectives(hlo)

    # sharded-N heat2d: one 10^4 state vector split over four cards
    prob = heat2d_problem(HEAT_M, use_prec=True)
    u0, up0 = heat2d_ic(HEAT_M)
    opts = IdaOptions(linear_solver="spgmr", mxstep=20000)
    solve_h = jax.jit(partial(core_solve, problem=prob, opts=opts,
                              tol=tol_ss(HEAT_RTOL, HEAT_ATOL)))
    st4, _, ih4 = watch(lambda: solve_h(
        shard_state_vector(init_state(prob, u0, up0, opts=opts), mesh, prob.n),
        tout=jnp.asarray(HEAT_TOUT)))
    st1, _, ih1 = watch(lambda: solve_h(init_state(prob, u0, up0, opts=opts),
                                        tout=jnp.asarray(HEAT_TOUT)))
    heat_wrms = float(wrms(np.asarray(st4.yy), np.asarray(st1.yy),
                           HEAT_RTOL, HEAT_ATOL))
    heat_ok = (int(ih4) == C.SUCCESS and int(ih1) == C.SUCCESS
               and len(st4.yy.sharding.device_set) == 4
               and heat_wrms < DRIFT_WRMS_LIMIT)

    # BBD foodweb: block preconditioner on the sharded state, calc_ic first
    prob_fw = foodweb_problem(FOODWEB_M, FOODWEB_M, use_prec=True)
    c0, cp0 = foodweb_ic(FOODWEB_M, FOODWEB_M)
    opts_fw = IdaOptions(linear_solver="spgmr", mxstep=5000, krylov_maxl=12,
                         krylov_max_restarts=10)
    tol_fw = tol_ss(FOODWEB_RTOL, FOODWEB_ATOL)
    ic_fw = jax.jit(partial(calc_ic, problem=prob_fw, opts=opts_fw,
                            tol=tol_fw, icopt=IC_YA_YDP_INIT))
    solve_fw = jax.jit(partial(core_solve, problem=prob_fw, opts=opts_fw,
                               tol=tol_fw))

    def foodweb(sharded):
        st = init_state(prob_fw, c0, cp0, opts=opts_fw)
        if sharded:
            st = shard_state_vector(st, mesh, prob_fw.n)
        st, ok = ic_fw(st, tout1=jnp.asarray(FOODWEB_TOUTS[0]))
        st, _, ist = solve_fw(st, tout=jnp.asarray(FOODWEB_TOUTS[-1]))
        return st, bool(ok), int(ist)

    sf4, icok4, if4 = watch(lambda: foodweb(True))
    sf1, icok1, if1 = watch(lambda: foodweb(False))
    fw_wrms = float(wrms(np.asarray(sf4.yy), np.asarray(sf1.yy),
                         FOODWEB_RTOL, FOODWEB_ATOL))
    vspec = NamedSharding(mesh, P(mesh.axis_names[0]))
    args_ps = (jnp.asarray(0.0), jnp.asarray(1.0e3), sf4.yy, sf4.yp, sf4.yy)
    setup = jax.jit(prob_fw.prec_setup,
                    in_shardings=(None, None, vspec, vspec, vspec))
    pdata = setup(*args_ps)
    prec_moves = watch(lambda: data_collectives(
        setup.lower(*args_ps).compile().as_text(), allow_scalar=False
    ) + data_collectives(jax.jit(prob_fw.prec_solve).lower(
        pdata, sf4.yy, jnp.asarray(1.0e3)).compile().as_text(),
        allow_scalar=False))
    fw_ok = (icok4 and icok1 and if4 == C.SUCCESS and if1 == C.SUCCESS
             and fw_wrms < DRIFT_WRMS_LIMIT and not prec_moves)

    ok = dp_ok and not dp_moves and heat_ok and fw_ok
    return report("four", ok, card, {
        "dp_B": batch, "dp_success": int((ist4 == C.SUCCESS).sum()),
        "dp_status_equal": bool(np.array_equal(ist4, ist1)),
        "dp_counters_equal": same_counters,
        "dp_yy_rel_diff_max": _g(dp_rel),
        "dp_hlo_data_collectives": len(dp_moves),
        "heat2d_sharded_N": HEAT_M**2,
        "heat2d_nst_4_vs_1": f"{int(st4.nst)}/{int(st1.nst)}",
        "heat2d_wrms_4_vs_1": f"{heat_wrms:.3e}",
        "bbd_foodweb_N": prob_fw.n,
        "bbd_nst_4_vs_1": f"{int(sf4.nst)}/{int(sf1.nst)}",
        "bbd_wrms_4_vs_1": f"{fw_wrms:.3e}",
        "bbd_prec_collectives": len(prec_moves),
    }, "dp: statuses and counters bitwise equal, |yy4 - yy1|/|yy1| <= "
       "1e-10 (each lane runs the same program; only vector-width "
       "rounding may differ), no array collective in its HLO; sharded-N "
       f"heat2d and BBD foodweb SUCCESS with WRMS < {DRIFT_WRMS_LIMIT:g} "
       "to one card (the SPGMR dot products reduce in another order, "
       "which can flip a borderline step); BBD preconditioner HLO without "
       "any collective", watch)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device path, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke.py: JAX found no GPU (platform "
                 f"{devices[0].platform!r}); nothing was run")
    need = 4 if args.four else 1
    if len(devices) < need:
        sys.exit(f"chip_smoke.py: needs {need} GPUs, found {len(devices)}")

    import ida_tpu  # noqa: F401  (float64 on)
    from ida_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    card_lines = card_info()
    card = "; ".join(card_lines)
    clock = CompileClock()
    print("\n".join(card_lines), flush=True)
    oks = [phase_device(devices, card, cache_dir)]
    if args.four:
        oks.append(phase_four(card, clock))
    else:
        for phase in (phase_parity, phase_ensemble, phase_krylov,
                      phase_gradient):
            oks.append(phase(card, clock))
    if not all(oks):
        sys.exit("chip_smoke.py: a phase failed")
    print(result_line(jax.devices()), flush=True)


if __name__ == "__main__":
    main()
