"""Headline benchmark: batched Roberts parameter sweep (BASELINE.md config 3).

Measures aggregate integrator throughput — internal BDF steps per second
summed over an ensemble of Roberts DAE instances with perturbed
chemistry — on the accelerator JAX exposes (one GPU), and compares
against the single-core native C++ IDA oracle (ida_tpu/native — the
serial "CPU IDA" baseline, which reproduces the canonical C IDA Roberts
statistics exactly), co-measured on the same host.

Prints a compact JSON line:
  {"metric": ..., "value": N, "unit": "steps/sec", "vs_baseline": N}
where vs_baseline is aggregate-accelerator-steps/sec over CPU-single
steps/sec. If the headline leg fails, the run exits non-zero with the
error instead. The "detail" block carries the secondary legs, each
guarded by its own slice of the watchdog budget:

  * f32 throughput mode (same ensemble, float32 state) — unconditional
  * the canonical 12-decade horizon sweep to t = 4e10 (the h ~ 1e9
    step-growth regime, reference benches/dense.rs:273-287) — an on-device
    lax.scan at the headline batch, co-measured against the serial oracle
  * rootfinding at production batch (r_check3 + Illinois at B=65536)
  * batched adjoint gradients (IDAS-A role): per-lane losses + gradients
    through the adaptive attempt loop, B=4096
  * heat2d 100x100 matrix-free SPGMR (BASELINE.md config 4): single
    instance, a B=256 vmapped ensemble, and a serial single-thread
    JAX-CPU denominator
  * foodweb 20x20 SPGMR+prec+calc_ic (BASELINE.md config 5): single
    instance, a B=32 vmapped ensemble (calc_ic vmapped too), and the
    serial-CPU denominator

Usage: python bench.py [--smoke] [--batch B] [--tout T] [--f32]
                       [--problem roberts|heat2d] [--no-extras]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time

import numpy as np


def roberts_params(batch):
    """[batch, 3] rate constants of the headline ensemble: the canonical
    (k1, k2, k3) scaled by exp(-0.2 .. 0.2), sorted by stiffness."""
    from ida_tpu.models import ROBERTS_PARAMS

    return np.outer(np.exp(np.linspace(-0.2, 0.2, batch)), ROBERTS_PARAMS)


def build(batch, dtype):
    import jax.numpy as jnp
    from ida_tpu.models import ROBERTS_YY0, roberts_factory
    from ida_tpu.parallel import ensemble_init

    params = jnp.asarray(roberts_params(batch), dtype)
    yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0, dtype), (batch, 1))
    yp0 = params[:, 0:1] * jnp.asarray([-1.0, 1.0, 0.0], dtype)
    states = ensemble_init(roberts_factory, params, yy0, yp0, dtype=dtype)
    return states, params, yy0, yp0


def make_solver(dtype):
    import jax.numpy as jnp
    from ida_tpu.models import roberts_factory
    from ida_tpu.parallel import make_ensemble_solve
    from ida_tpu.tol_control import tol_sv

    tol = tol_sv(1.0e-4, jnp.asarray([1e-8, 1e-6, 1e-6], dtype), dtype=dtype)
    return make_ensemble_solve(roberts_factory, donate=False), tol


def _native_setup(batch, dtype, with_roots=False):
    """Shared batch-native (batch-last, no-vmap) harness: unlike the vmapped
    path, lax.while_loop keeps its scalar cond here, so the self-masked loop
    body needs no per-leaf select merge (vmap's while batching rule
    re-inserts one)."""
    import jax
    import jax.numpy as jnp
    from ida_tpu.models import roberts_factory
    from ida_tpu.tol_control import TolControl

    states, params, yy0, yp0 = build(batch, dtype)
    if with_roots:
        from ida_tpu.parallel import ensemble_init

        states = ensemble_init(
            lambda p: roberts_factory(p, with_roots=True), params, yy0, yp0,
            dtype=dtype,
        )
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    prob_T = roberts_factory(jnp.moveaxis(params, 0, -1), with_roots=with_roots)
    atol = jnp.asarray([1e-8, 1e-6, 1e-6], dtype)
    tol_T = TolControl(
        rtol=jnp.full((batch,), 1e-4, dtype),
        atol=jnp.tile(atol[:, None], (1, batch)),
    )
    return states_T, prob_T, tol_T


def native_ensemble_solver(batch, dtype, ls_precision="full",
                           fast_math=False):
    """The batch-native (batch-last, no-vmap) headline program:
    ``fn(states_T, tout=tout_T) -> (states_T, tret[B], istate[B])`` and a
    fresh ``states_T`` to start it from."""
    import jax
    from functools import partial
    from ida_tpu.core.solve import solve as core_solve, TASK_NORMAL
    from ida_tpu.core.state import IdaOptions

    states_T, prob_T, tol_T = _native_setup(batch, dtype)
    fn = jax.jit(
        partial(
            core_solve, problem=prob_T,
            opts=IdaOptions(ls_precision=ls_precision, fast_math=fast_math),
            tol=tol_T,
            itask=TASK_NORMAL,
        )
    )
    return fn, states_T


def run_ensemble_native(batch, tout, dtype, reps=5, ls_precision="full",
                        pipeline=3, fast_math=False):
    """Headline: batch-native ensemble solve, ``reps`` timed regions of
    ``pipeline`` back-to-back dispatches from fresh states each time
    (identical work — same total steps per run). Returns
    (steps, walls, ok, lanes, counters); callers report best AND median so
    the run-to-run wall spread is visible in the artifact.

    ``pipeline>1`` enqueues that many independent solves in stream order
    and syncs once, reporting wall/pipeline per run — the same amortized
    methodology as the oracle side (oracle_roberts_bench times thousands
    of sequential solves in one region, so its ~O(us) call overhead
    vanishes). The wall/pipeline division assumes strictly in-order,
    non-overlapping device execution; whether ``pipeline=3`` is the right
    amortization on the GPU has not been measured yet. Note the memory
    cost: ``pipeline`` full input state pytrees are resident at once,
    which is negligible for Roberts (N=3) but scales with batch and state
    size if this harness is pointed at a larger system."""
    import jax
    import jax.numpy as jnp
    from ida_tpu import constants as C

    fn, states_T = native_ensemble_solver(
        batch, dtype, ls_precision=ls_precision, fast_math=fast_math
    )
    tout_T = jnp.full((batch,), tout, dtype)
    jax.block_until_ready(fn(states_T, tout=tout_T))  # compile + warm up

    walls = []
    for _ in range(reps):
        inputs = []
        for _p in range(pipeline):
            st_in, _, _ = _native_setup(batch, dtype)
            inputs.append(jax.block_until_ready(st_in))
        t0 = time.perf_counter()
        outs = [fn(st_in, tout=tout_T) for st_in in inputs]  # stream order
        st, tret, istate = jax.block_until_ready(outs[-1])
        walls.append((time.perf_counter() - t0) / pipeline)
    # result arrays are fetched to the host outside the timed region
    nst = np.asarray(st.nst)
    ist = np.asarray(istate)
    ok = ist == C.SUCCESS
    # BASELINE.md primary metric names "batched Newton-LU solves/sec"
    # alongside steps/sec: each Newton iteration (nni) is one batched LU
    # back-substitution; each lsetup (nje) one batched LU factorization.
    counters = {
        "nni_total": float(np.asarray(st.nni, np.float64).sum()),
        "nje_total": float(np.asarray(st.nje, np.float64).sum()),
        "nre_total": float(np.asarray(st.nre, np.float64).sum()),
    }
    return float(nst.sum()), walls, int(ok.sum()), len(ist), counters


def run_ensemble(batch, tout, dtype):
    import jax
    import jax.numpy as jnp
    from ida_tpu import constants as C

    solve, tol = make_solver(dtype)
    states, params, _, _ = build(batch, dtype)
    # compile + warm up
    jax.block_until_ready(solve(states, params, tol, jnp.asarray(tout, dtype)))
    # timed run from fresh states, inputs resident before the clock starts
    states, params, _, _ = jax.block_until_ready(build(batch, dtype))
    t0 = time.perf_counter()
    states, tret, istate = jax.block_until_ready(
        solve(states, params, tol, jnp.asarray(tout, dtype))
    )
    dt = time.perf_counter() - t0
    nst = np.asarray(states.nst)
    ist = np.asarray(istate)
    ok = ist == C.SUCCESS
    return float(nst.sum()), dt, int(ok.sum()), len(ist)


def _native_setup_slice(scale, dtype):
    """Batch-native ensemble over an explicit rate-constant scale slice;
    params are returned separately so they can enter the compiled program
    as a runtime ARGUMENT (one executable serves every same-shape chunk)."""
    import jax
    import jax.numpy as jnp
    from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
    from ida_tpu.parallel import ensemble_init
    from ida_tpu.tol_control import TolControl

    batch = len(scale)
    params = jnp.asarray(np.outer(scale, ROBERTS_PARAMS), dtype)
    yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0, dtype), (batch, 1))
    yp0 = params[:, 0:1] * jnp.asarray([-1.0, 1.0, 0.0], dtype)
    states = ensemble_init(roberts_factory, params, yy0, yp0, dtype=dtype)
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    atol = jnp.asarray([1e-8, 1e-6, 1e-6], dtype)
    tol_T = TolControl(
        rtol=jnp.full((batch,), 1e-4, dtype),
        atol=jnp.tile(atol[:, None], (1, batch)),
    )
    return states_T, jnp.moveaxis(params, 0, -1), tol_T


def run_decades_sweep(batch, dtype, n_decades=12, reps=3, fused=True,
                      chunks=4):
    """The canonical multi-horizon differential benchmark (reference
    benches/dense.rs:273-287): integrate the ensemble decade by decade to
    t = 0.4 * 10^(n-1) — the h ~ 1e9 extreme step-growth regime IS in the
    timed path. The decade loop runs ON DEVICE on the batch-native path,
    so the 12 legs cost zero host dispatches (VERDICT r2 item 2).

    ``fused=True`` uses core.solve.solve_dense — ONE while loop in which
    each lane advances through its own output rows the moment it crosses
    them. The scan form (``fused=False``) synchronizes the whole lockstep
    batch at every decade boundary, which costs ~40% occupancy on this
    workload (each decade averages only ~36 steps/lane, PERF.md round 3);
    both forms produce bit-identical rows (tests/test_dense_output.py).

    ``chunks=4`` runs the same ``batch`` total lanes as 4 sequential
    sorted sub-batches through ONE compiled executable (params enter as a
    runtime argument; the chunk programs are dispatched back-to-back and
    execute in stream order, so the timed region has no host round-trips
    between chunks). The chunk count was tuned on an earlier accelerator
    and has not been measured on the GPU yet. ``chunks=1`` reproduces the
    whole-batch form."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from ida_tpu import constants as C
    from ida_tpu.core.solve import solve as core_solve, solve_dense, TASK_NORMAL
    from ida_tpu.core.state import IdaOptions
    from ida_tpu.models import roberts_factory

    bc = batch // chunks
    scale_all = np.exp(np.linspace(-0.2, 0.2, batch))  # sorted by stiffness
    slices = [scale_all[c * bc:(c + 1) * bc] for c in range(chunks)]
    touts = jnp.asarray([0.4 * 10.0 ** d for d in range(n_decades)], dtype)
    _, _, tol_T = _native_setup_slice(slices[0], dtype)

    if fused:
        def sweep(st, params_T):
            prob_T = roberts_factory(params_T)
            st, _tret, ist, _yy, _yp, nst_rows = solve_dense(
                st, prob_T, IdaOptions(), tol_T, touts
            )
            return (
                jnp.sum(nst_rows, axis=1),
                jnp.sum((ist == C.SUCCESS).astype(jnp.int32), axis=1),
            )
    else:
        def sweep(st, params_T):
            prob_T = roberts_factory(params_T)
            solve1 = partial(
                core_solve, problem=prob_T, opts=IdaOptions(), tol=tol_T,
                itask=TASK_NORMAL,
            )

            def one(st, tout):
                st, tret, ist = solve1(st, tout=jnp.full((bc,), tout, dtype))
                return st, (
                    jnp.sum(st.nst),
                    jnp.sum((ist == C.SUCCESS).astype(jnp.int32)),
                )

            _st, (nst_cum, ok_leg) = jax.lax.scan(one, st, touts)
            return nst_cum, ok_leg

    fn = jax.jit(sweep)
    setups = [_native_setup_slice(s, dtype) for s in slices]
    out = fn(setups[0][0], setups[0][1])
    _ = np.asarray(out[0])  # compile + sync

    walls = []
    for _ in range(reps):
        setups = jax.block_until_ready(
            [_native_setup_slice(s, dtype) for s in slices]
        )
        t0 = time.perf_counter()
        outs = [fn(st_c, p_c) for st_c, p_c, _ in setups]  # in-order stream
        jax.block_until_ready(outs)
        walls.append(time.perf_counter() - t0)
    # per-decade stats fetched off the clock
    nst_cum = np.sum([np.asarray(o[0], float) for o in outs], axis=0)
    ok_leg = np.sum([np.asarray(o[1]) for o in outs], axis=0)
    wall = min(walls)
    total = float(nst_cum[-1])
    per_leg = np.diff(np.concatenate([[0.0], nst_cum]))
    legs = [
        {
            "decade": d + 1,
            "tout": float(touts[d]),
            "steps": float(per_leg[d]),
            "ok_lanes": int(ok_leg[d]),
        }
        for d in range(n_decades)
    ]

    # differential leg: the native C++ oracle runs the SAME 12-decade
    # trajectory serially (the role of reference benches/dense.rs:273-287,
    # which times C SUNDIALS vs rust-ida per output horizon); best-of-3
    # like the device side
    from ida_tpu.native import oracle_roberts_bench

    touts_12 = [0.4 * 10.0 ** d for d in range(n_decades)]
    oracle_roberts_bench(touts_12, reps=1)  # warm
    orates = []
    for _ in range(3):
        t0 = time.perf_counter()
        osteps, _ = oracle_roberts_bench(touts_12, reps=1000)
        orates.append(osteps / (time.perf_counter() - t0))
    orate = max(orates)

    return {
        "n_decades": n_decades,
        "batch": batch,
        "chunks": chunks,
        "fused_dense_output": bool(fused),
        "total_steps": total,
        "total_wall_s": round(wall, 4),
        "wall_runs_s": [round(w, 4) for w in walls],
        "agg_steps_per_sec": round(total / wall, 1),
        "agg_steps_per_sec_median": round(
            total / sorted(walls)[len(walls) // 2], 1
        ),
        "oracle_12dec_steps_per_sec": round(orate, 1),
        "oracle_runs": [round(r, 1) for r in orates],
        "vs_oracle": round(total / wall / orate, 2),
        "ok_lanes": int(ok_leg[-1]),
        "legs": legs,
    }


def fast_accuracy_table(n_decades=12, batch=8):
    """Trajectory-accuracy table for the NON-PARITY fast_math mode (VERDICT
    r3 item 2's gate): the canonical-parameter Roberts lane swept over the
    12-decade grid in BOTH modes, every row compared against the native C++
    oracle trajectory in the solver's own ewt metric. Acceptance is the
    idaRoberts_dns check_ans criterion (wrms < 1) at EVERY row. Runs in the
    calling process (see run_fast_accuracy for the CPU-subprocess wrapper
    the accelerator bench uses)."""
    import jax
    import jax.numpy as jnp
    from ida_tpu import constants as C
    from ida_tpu.core.solve import solve_dense
    from ida_tpu.core.state import IdaOptions
    from ida_tpu.models import roberts_factory
    from ida_tpu.native import oracle_roberts_trajectory

    dtype = jnp.float64
    touts_np = 0.4 * 10.0 ** np.arange(n_decades)
    ret, y_ref, _nst = oracle_roberts_trajectory(touts_np)
    if ret != 0:
        return {"ok": False, "error": f"oracle trajectory ret={ret}"}
    touts = jnp.asarray(touts_np, dtype)
    w = 1.0 / (1e-4 * np.abs(y_ref) + np.array([1e-8, 1e-6, 1e-6]))

    wrms_rows = {}
    for fm in (False, True):
        st, params_T, tol_T = _native_setup_slice(np.ones(batch), dtype)
        prob_T = roberts_factory(params_T)
        opts = IdaOptions(fast_math=fm)

        def sweep(st, params_T):
            prob = roberts_factory(params_T)
            return solve_dense(st, prob, opts, tol_T, touts)

        out = jax.jit(sweep)(st, params_T)
        ist = np.asarray(out[2])
        if not np.all(ist == C.SUCCESS):
            return {"ok": False,
                    "error": f"fast_math={fm} rows not all SUCCESS: "
                             f"{np.unique(ist).tolist()}"}
        y = np.asarray(out[3])[:, :, 0]  # canonical lane, [T, 3]
        wrms_rows[fm] = np.sqrt(np.mean(((y - y_ref) * w) ** 2, axis=1))

    table = [
        {
            "tout": float(t),
            "wrms_vs_oracle_parity": round(float(p), 5),
            "wrms_vs_oracle_fast": round(float(f), 5),
        }
        for t, p, f in zip(touts_np, wrms_rows[False], wrms_rows[True])
    ]
    return {
        "ok": bool(np.max(wrms_rows[True]) < 1.0),
        "criterion": "check_ans wrms < 1 vs native oracle at every decade",
        "max_wrms_fast": round(float(np.max(wrms_rows[True])), 5),
        "max_wrms_parity": round(float(np.max(wrms_rows[False])), 5),
        "table": table,
    }


def _run_cpu_child(argv, timeout_s, xla_flags=""):
    """Run ``bench.py <argv>`` in a child pinned to the CPU by
    ``JAX_PLATFORMS=cpu``, so only this process opens the accelerator (a
    second JAX process on the card would fail for want of memory). Returns
    the child's last JSON line, or None."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if xla_flags:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + xla_flags).strip()
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)] + argv,
            capture_output=True, text=True, timeout=timeout_s, env=env,
        )
    except subprocess.TimeoutExpired:
        return None
    rec = None
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
    return rec


def run_fast_accuracy(timeout_s=900):
    """CPU-subprocess wrapper for fast_accuracy_table: a correctness-only
    leg that need not spend accelerator compiles."""
    return _run_cpu_child(["--fast-accuracy"], timeout_s)


def run_roberts_roots(batch, tout, dtype):
    """Rootfinding at production batch (VERDICT r2 item 5): the g-function
    is evaluated every step (r_check3) and the Illinois loop + per-iteration
    interpolation run at full ensemble width. Roberts hits root 1
    (y1 = 1e-4, t ~ 0.264) inside [0, 400]: every lane returns ROOT_RETURN
    once and is re-entered to tout. Reference impl_r_check.rs:343-576."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from ida_tpu import constants as C
    from ida_tpu.core.solve import solve as core_solve, TASK_NORMAL
    from ida_tpu.core.state import IdaOptions

    states_T, prob_T, tol_T = _native_setup(batch, dtype, with_roots=True)
    fn = jax.jit(
        partial(
            core_solve, problem=prob_T, opts=IdaOptions(), tol=tol_T,
            itask=TASK_NORMAL,
        )
    )
    tout_T = jnp.full((batch,), tout, dtype)

    def full_run(states_T):
        st = states_T
        nroots = 0
        for _ in range(4):  # root re-entry loop (one crossing expected)
            st, tret, ist = fn(st, tout=tout_T)
            ist_h = np.asarray(ist)
            n_root = int((ist_h == C.ROOT_RETURN).sum())
            nroots += n_root
            if n_root == 0:
                break
        return st, ist_h, nroots

    st, ist_h, _ = full_run(states_T)  # compile + warm
    states_T, _, _ = _native_setup(batch, dtype, with_roots=True)
    _ = np.asarray(states_T.nst[:1])
    t0 = time.perf_counter()
    st, ist_h, nroots = full_run(states_T)
    # full_run's istate fetches drive the root re-entry loop, so the final
    # one already synced the device; fetch the big counters off the clock
    dt = time.perf_counter() - t0
    nst = float(np.asarray(st.nst).sum())

    # serial denominator: the native oracle running the SAME rooted config
    # (built-in root functions, no Python callbacks) — best of 3
    from ida_tpu.native import oracle_roberts_roots_bench

    oracle_roberts_roots_bench([tout], reps=1)  # build/warm
    orates = []
    for _ in range(3):
        t1 = time.perf_counter()
        osteps, _ev = oracle_roberts_roots_bench([tout], reps=2000)
        orates.append(osteps / (time.perf_counter() - t1))
    return {
        "batch": batch,
        "steps": nst,
        "steps_per_sec": round(nst / dt, 1),
        "wall_s": round(dt, 4),
        "root_returns": nroots,
        "nge": float(np.asarray(st.nge).sum()),
        "ok_lanes": int((ist_h == C.SUCCESS).sum()),
        "oracle_rooted_steps_per_sec": round(max(orates), 1),
        "vs_comeasured_oracle": round(nst / dt / max(orates), 2),
    }


def run_adjoint_batched(B, dtype=None):
    """Batched discrete-adjoint gradients on the accelerator (the IDAS
    adjoint/IDAA role — beyond the reference, which has no sensitivity
    machinery at all): one compiled program computing per-lane losses AND
    per-lane gradients d<w, y(tout)>/d(rate constants) for a spread of
    Roberts parameter sets — the multi-start parameter-estimation shape.
    The reverse pass differentiates the whole adaptive attempt loop
    (bounded scan of max_attempts, unrolled Newton), so wall time covers
    forward + backward through ~120 BDF attempts."""
    import jax.numpy as jnp
    from ida_tpu.models import roberts_factory, ROBERTS_PARAMS, ROBERTS_YY0
    from ida_tpu.sensitivity import batched_adjoint_gradient
    from ida_tpu.tol_control import tol_sv

    dtype = dtype or jnp.float64
    tol = tol_sv(1.0e-4, jnp.asarray([1e-8, 1e-6, 1e-6], dtype), dtype=dtype)
    scale = np.exp(np.linspace(-0.05, 0.05, B))
    params = jnp.asarray(np.outer(scale, ROBERTS_PARAMS), dtype)
    yy0_of = lambda p: jnp.asarray(ROBERTS_YY0, dtype)  # noqa: E731
    yp0_of = lambda p: p[0] * jnp.asarray([-1.0, 1.0, 0.0], dtype)  # noqa: E731
    w = jnp.asarray([1.0, 2.0, 3.0], dtype)
    loss_of = lambda y: jnp.sum(y * w)  # noqa: E731

    def run():
        vals, grads, ist = batched_adjoint_gradient(
            roberts_factory, params, yy0_of, yp0_of, tol, 4.0, loss_of,
            max_attempts=120, dtype=dtype,
        )
        return np.asarray(vals), np.asarray(grads), np.asarray(ist)

    run()  # compile + warm
    t0 = time.perf_counter()
    vals, grads, ist = run()
    dt = time.perf_counter() - t0
    ok = int((ist == 0).sum())
    return {
        "batch": B,
        "tout": 4.0,
        "grads_per_sec": round(B / dt, 1),
        "wall_s": round(dt, 4),
        "ok_lanes": ok,
        "finite_grads": int(np.isfinite(grads).all(axis=1).sum()),
    }


def run_adjoint_continuous(B, dtype=None):
    """Batched CONTINUOUS-adjoint gradients (sensitivity.continuous_adjoint
    — the IDAS adjoint-module strategy: forward dense-output checkpoints,
    adjoint DAE integrated backwards, gradient via backward quadratures).
    Same loss/ensemble shape as run_adjoint_batched so the two strategies'
    costs are directly comparable: the continuous path is ~2 solves per
    lane instead of a full reverse tape through every attempt."""
    import jax
    import jax.numpy as jnp
    from ida_tpu.core.state import IdaOptions
    from ida_tpu.models import roberts_factory, ROBERTS_PARAMS, ROBERTS_YY0
    from ida_tpu.sensitivity import continuous_adjoint
    from ida_tpu.tol_control import tol_sv

    dtype = dtype or jnp.float64
    tol = tol_sv(1.0e-4, jnp.asarray([1e-8, 1e-6, 1e-6], dtype), dtype=dtype)
    scale = np.exp(np.linspace(-0.05, 0.05, B))
    params = jnp.asarray(np.outer(scale, ROBERTS_PARAMS), dtype)
    yy0 = jnp.asarray(ROBERTS_YY0, dtype)
    w = jnp.asarray([1.0, 2.0, 3.0], dtype)
    grid = jnp.asarray(np.logspace(-4, np.log10(4.0), 64), dtype)
    opts = IdaOptions(mxstep=20000)

    def one(p):
        loss, gp, gy0, istf, istb = continuous_adjoint(
            roberts_factory, p, yy0,
            p[0] * jnp.asarray([-1.0, 1.0, 0.0], dtype),
            tol, 4.0, lambda y: jnp.sum(y * w), grid=grid, opts=opts,
            dtype=dtype,
        )
        return loss, gp, jnp.abs(istf) + jnp.abs(istb)

    fn = jax.jit(jax.vmap(one))

    def run():
        vals, grads, ist = fn(params)
        return np.asarray(vals), np.asarray(grads), np.asarray(ist)

    run()  # compile + warm
    t0 = time.perf_counter()
    vals, grads, ist = run()
    dt = time.perf_counter() - t0
    return {
        "batch": B,
        "tout": 4.0,
        "grads_per_sec": round(B / dt, 1),
        "wall_s": round(dt, 4),
        "ok_lanes": int((ist == 0).sum()),
        "finite_grads": int(np.isfinite(grads).all(axis=1).sum()),
    }


def run_heat2d(m, tout, mxstep=20000, ls_precision="full",
               krylov_storage="compute", krylov_maxl=5,
               krylov_gs="modified"):
    """BASELINE.md config 4: idaHeat2D-style grid DAE, matrix-free SPGMR."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from ida_tpu.core.solve import solve as core_solve
    from ida_tpu.core.state import IdaOptions, init_state
    from ida_tpu.models.heat2d import heat2d_problem, heat2d_ic
    from ida_tpu.tol_control import tol_ss

    prob = heat2d_problem(m, use_prec=True)
    u0, up0 = heat2d_ic(m)
    opts = IdaOptions(linear_solver="spgmr", mxstep=mxstep,
                      ls_precision=ls_precision,
                      krylov_storage=krylov_storage,
                      krylov_maxl=krylov_maxl,
                      krylov_gs=krylov_gs)
    fn = jax.jit(partial(core_solve, problem=prob, opts=opts, tol=tol_ss(1e-5, 1e-8)))

    st = init_state(prob, u0, up0, opts=opts)
    out = fn(st, tout=jnp.asarray(tout))
    _ = np.asarray(out[0].nst)  # compile + sync
    # best-of-3: this leg is a SINGLE small system (sub-second wall,
    # latency-bound tiny kernels) — the most sensitive leg in the bench
    # to shared-part load, measured swinging 410-662 steps/s run-to-run
    # on identical step counts. Same discipline as the headline
    # (best-of-N walls, every wall recorded).
    walls = []
    for _ in range(3):
        st = init_state(prob, u0, up0, opts=opts)
        t0 = time.perf_counter()
        st, tret, istate = fn(st, tout=jnp.asarray(tout))
        nst = int(np.asarray(st.nst))
        walls.append(time.perf_counter() - t0)
    nli = int(np.asarray(st.nli))
    ok = int(np.asarray(istate)) == 0
    dt = min(walls)
    return {
        "grid": f"{m}x{m}",
        "n": prob.n,
        "nst": nst,
        "nli": nli,
        "steps_per_sec": round(nst / dt, 2),
        "wall_s": round(dt, 3),
        "walls_s": [round(w, 4) for w in walls],
        "ok": ok,
    }


def run_heat2d_batched(
    m, tout, B=64, mxstep=20000, ls_precision="full", krylov_storage="compute"
):
    """DP x large-N composition (VERDICT r2 item 3): B heat2d instances
    (initial-condition family u0 * scale — the heat equation is linear, so
    each lane is a genuine distinct solve), SPGMR, on one chip — on the
    BATCH-NATIVE path (trailing-batch state, no vmap while-merge; the
    heat2d residual/preconditioner are trailing-batch aware). The aggregate
    steps/sec over B instances is the number the serial-CPU denominator
    divides.

    ls_precision="single" runs the whole Krylov iteration in f32 inside the
    f64 Newton loop (IdaOptions.ls_precision; the f64 error test still
    gates every step) — the mixed-precision mode of NEXT.md lever 1b."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from ida_tpu import constants as C
    from ida_tpu.core.solve import solve as core_solve, TASK_NORMAL
    from ida_tpu.core.state import IdaOptions
    from ida_tpu.models.heat2d import heat2d_problem, heat2d_ic
    from ida_tpu.parallel import ensemble_init
    from ida_tpu.tol_control import tol_ss

    prob = heat2d_problem(m, use_prec=True)
    u0, up0 = heat2d_ic(m)
    opts = IdaOptions(
        linear_solver="spgmr", mxstep=mxstep, ls_precision=ls_precision,
        krylov_storage=krylov_storage,
    )
    scales = jnp.linspace(0.9, 1.1, B)
    u0b = jnp.asarray(u0)[None, :] * scales[:, None]
    up0b = jnp.asarray(up0)[None, :] * scales[:, None]
    states = ensemble_init(lambda s: prob, scales, u0b, up0b, opts=opts)
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    fn = jax.jit(
        partial(core_solve, problem=prob, opts=opts, tol=tol_ss(1e-5, 1e-8),
                itask=TASK_NORMAL)
    )
    tout_T = jnp.full((B,), tout)
    out = fn(states_T, tout=tout_T)
    _ = np.asarray(out[0].nst)  # compile + sync
    states = ensemble_init(lambda s: prob, scales, u0b, up0b, opts=opts)
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    _ = np.asarray(states_T.nst)
    t0 = time.perf_counter()
    st, tret, istate = fn(states_T, tout=tout_T)
    nst = np.asarray(st.nst)
    ist = np.asarray(istate)
    dt = time.perf_counter() - t0
    return {
        "grid": f"{m}x{m}",
        "n": prob.n,
        "batch": B,
        "total_steps": float(nst.sum()),
        "agg_steps_per_sec": round(float(nst.sum()) / dt, 2),
        "wall_s": round(dt, 3),
        "ok_lanes": int((ist == 0).sum()),
    }


def run_foodweb(m=20):
    """BASELINE.md config 5: foodweb predator-prey reaction-diffusion DAE,
    SPGMR with the block-diagonal preconditioner + calc_ic for the algebraic
    predator species (the idaFoodWeb_kry configuration)."""
    from ida_tpu import IDA, IdaOptions
    from ida_tpu.models import foodweb_problem, foodweb_ic
    from ida_tpu.tol_control import tol_ss

    prob = foodweb_problem(m, m)
    c0, cp0 = foodweb_ic(m, m)
    opts = IdaOptions(
        linear_solver="spgmr", mxstep=5000, krylov_maxl=12, krylov_max_restarts=10
    )
    ida = IDA(prob, c0, cp0, tol_ss(1e-5, 1e-5), options=opts)
    ida.calc_ic("ya_ydp", tout1=1e-3)
    _, st0 = ida.solve(1e-3)  # compile + first leg
    ok = st0.name == "Success"
    t0 = time.perf_counter()
    t = 4e-3
    for _ in range(3):
        _, status = ida.solve(t)
        # each leg must actually reach its tout (VERDICT r2: the old
        # hardcoded ok=True would have recorded a green leg on any return)
        ok = ok and status.name == "Success"
        t *= 4
    dt = time.perf_counter() - t0
    nst = ida.get_num_steps()
    return {
        "grid": f"{m}x{m}",
        "n": prob.n,
        "nst": nst,
        "nli": ida.get_num_lin_iters(),
        "steps_per_sec": round(nst / dt, 2),
        "wall_s": round(dt, 3),
        "ok": ok,
    }


def run_foodweb_batched(m=20, B=32, ls_precision="full", krylov_storage="compute"):
    """Batched foodweb (BASELINE config 5 at ensemble width): B instances
    with perturbed prey initial conditions, each running calc_ic (YA_YDP —
    vmapped consistent-IC computation) then four output legs via an
    on-device scan. The aggregate steps/sec is what one chip earns on the
    config; the serial-CPU denominator divides it."""
    import jax
    import jax.numpy as jnp
    from ida_tpu import constants as C
    from ida_tpu.core.calc_ic import calc_ic, IC_YA_YDP_INIT
    from ida_tpu.core.solve import solve as core_solve, TASK_NORMAL
    from ida_tpu.core.state import IdaOptions, init_state
    from ida_tpu.models import foodweb_problem, foodweb_ic
    from ida_tpu.tol_control import tol_ss

    prob = foodweb_problem(m, m)
    c0, cp0 = foodweb_ic(m, m)
    opts = IdaOptions(
        linear_solver="spgmr", mxstep=5000, krylov_maxl=12,
        krylov_max_restarts=10, ls_precision=ls_precision,
        krylov_storage=krylov_storage,
    )
    tol = tol_ss(1e-5, 1e-5)
    scales = jnp.linspace(0.95, 1.05, B)
    touts = jnp.asarray([1e-3, 4e-3, 1.6e-2, 6.4e-2])

    # consistent ICs once per lane (vmapped calc_ic), then the four output
    # legs run BATCH-NATIVE (trailing-batch state, no vmap while-merge;
    # the foodweb residual/preconditioner and SPGMR are trailing-batch
    # aware) via one on-device scan
    def ic_one(scale):
        c = c0 * jnp.where(prob.id, scale, 1.0)  # perturb the prey species
        st = init_state(prob, c, cp0, opts=opts)
        return calc_ic(st, prob, opts, tol, IC_YA_YDP_INIT, touts[0])

    def ic_all(scales):
        states, ok = jax.vmap(ic_one)(scales)
        return jax.tree_util.tree_map(
            lambda x: jnp.moveaxis(x, 0, -1), states
        ), ok

    def legs(st):
        def leg(st, tout):
            st, tret, ist = core_solve(
                st, prob, opts, tol, jnp.full((B,), tout), TASK_NORMAL
            )
            return st, ist

        st, ists = jax.lax.scan(leg, st, touts)
        return st.nst, ists

    ic_fn = jax.jit(ic_all)
    legs_fn = jax.jit(legs)
    st0, ok = ic_fn(scales)
    out = legs_fn(st0)
    _ = np.asarray(out[0])  # compile + sync
    # IC preparation is outside the timed region, matching the
    # single-instance leg (ida.calc_ic happens before its timer too)
    st0, ok = ic_fn(scales)
    okh = np.asarray(ok)
    t0 = time.perf_counter()
    nst, ists = legs_fn(st0)
    nst = np.asarray(nst)
    ists = np.asarray(ists)  # [nout, B]
    dt = time.perf_counter() - t0
    return {
        "grid": f"{m}x{m}",
        "n": prob.n,
        "batch": B,
        "total_steps": float(nst.sum()),
        "agg_steps_per_sec": round(float(nst.sum()) / dt, 2),
        "wall_s": round(dt, 3),
        "ok_lanes": int(
            (okh & (ists == C.SUCCESS).all(axis=0)).sum()
        ),
    }


def run_cpu_serial(which, timeout_s=1200):
    """Serial-CPU denominator for the PDE legs (VERDICT r2 item 3): the same
    solver configuration on the host CPU, single XLA thread, one instance —
    the role the native C++ oracle plays for dense Roberts. Runs in a CPU
    child process (see _run_cpu_child)."""
    return _run_cpu_child(
        ["--cpu-serial", which], timeout_s,
        xla_flags="--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1",
    )


def os_environ_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _Budget:
    """Global deadline with per-leg SIGALRM slices; a leg that overruns is
    dropped (returns None) and the remaining legs still get their shot.
    Every drop is RECORDED: ``errors[name]`` carries the exception string
    and ``skipped[name]`` the out-of-budget reason, so a crashed leg is
    distinguishable from a skipped one in the artifact (VERDICT r3 weak 3).
    """

    #: extra slack past the SIGALRM slice before a leg is declared WEDGED.
    WEDGE_SLACK_S = 90.0

    def __init__(self, total_s, on_wedge=None):
        self.deadline = time.monotonic() + total_s
        self.errors = {}
        self.skipped = {}
        #: called from a TIMER THREAD as on_wedge(leg_name) when a leg is
        #: still blocked WEDGE_SLACK_S after its SIGALRM fired. Python
        #: signal handlers only run between bytecodes of the main thread,
        #: so a main thread stuck inside a C call that never returns can
        #: NEVER see SIGALRM — only another thread can break the wedge.
        #: The handler must not return control to the wedged leg: it
        #: should persist what it knows and os._exit.
        self.on_wedge = on_wedge or (lambda name: os._exit(3))
        signal.signal(signal.SIGALRM, self._raise)

    @staticmethod
    def _raise(signum, frame):
        raise TimeoutError("bench leg exceeded watchdog budget")

    def remaining(self):
        return max(0.0, self.deadline - time.monotonic())

    def leg(self, fn, *args, min_s=30.0, cap_s=None, name=None, retries=0,
            **kwargs):
        """Run one leg under a SIGALRM slice.

        ``retries`` re-runs the leg after a non-watchdog exception while
        budget remains, recording every failed attempt (a recovered one
        moves to ``<name>:recovered``). TimeoutError (our own watchdog) is
        never retried.
        """
        name = name or getattr(fn, "__name__", "leg")
        attempt = 0
        while True:
            rem = self.remaining()
            if rem < min_s:
                self.skipped[name] = (
                    f"budget: {rem:.0f}s remaining < min_s={min_s:.0f}s"
                    + (f" (on retry {attempt})" if attempt else "")
                )
                return None
            budget = int(min(rem, cap_s) if cap_s else rem)
            signal.alarm(budget)
            wedge = threading.Timer(
                budget + self.WEDGE_SLACK_S, self.on_wedge, args=(name,)
            )
            wedge.daemon = True
            wedge.start()
            t0 = time.monotonic()
            try:
                out = fn(*args, **kwargs)
                if name in self.errors:  # succeeded on a retry
                    self.errors[name + ":recovered"] = self.errors.pop(name)
                return out
            except Exception as e:  # noqa: BLE001 — recorded, not swallowed
                msg = (
                    f"{type(e).__name__}: {e!s}"[:300]
                    + f" (after {time.monotonic() - t0:.0f}s, slice {budget}s)"
                )
                self.errors[name] = (
                    self.errors[name] + f" | retry {attempt}: {msg}"
                    if name in self.errors else msg
                )
                if attempt >= retries or isinstance(e, TimeoutError):
                    return None
                attempt += 1
            finally:
                signal.alarm(0)
                wedge.cancel()


def run_heat2d_bench(args, platform):
    m = 20 if args.smoke else 100
    tout = 0.04 if args.smoke else 0.16
    rec = run_heat2d(m, tout)
    print(
        json.dumps(
            {
                "metric": f"heat2d {m}x{m} SPGMR integrator steps/sec "
                f"(N={rec['n']}, f64, {platform})",
                "value": rec["steps_per_sec"],
                "unit": "steps/sec",
                "vs_baseline": 1.0 if rec["ok"] else 0.0,
                "detail": rec,
            }
        )
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny CPU-only sanity run")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--tout", type=float, default=400.0)
    ap.add_argument("--f32", action="store_true", help="float32 throughput mode")
    ap.add_argument("--native", action="store_true", default=None,
                    help="batch-native (batch-last, no-vmap) ensemble path "
                         "(default on accelerators)")
    ap.add_argument("--vmapped", action="store_true",
                    help="force the vmapped batch-leading path")
    ap.add_argument(
        "--problem", default="roberts", choices=["roberts", "heat2d"],
        help="roberts = batched ensemble sweep; heat2d = one large SPGMR system",
    )
    ap.add_argument("--no-extras", action="store_true",
                    help="headline + baseline only (skip f32/decades/pde legs)")
    ap.add_argument("--cpu-serial", choices=["heat2d", "foodweb"], default=None,
                    help="internal: serial single-thread CPU denominator run")
    ap.add_argument("--fast-accuracy", action="store_true",
                    help="internal: CPU fast_math trajectory-accuracy table")
    args = ap.parse_args()

    import jax

    # the two internal modes run in children that _run_cpu_child pins to
    # the CPU through JAX_PLATFORMS
    if args.cpu_serial:
        if args.cpu_serial == "heat2d":
            rec = run_heat2d(100, 0.16)
        else:
            rec = run_foodweb(20)
        print(json.dumps(rec))
        return

    if args.fast_accuracy:
        print(json.dumps(fast_accuracy_table()))
        return

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    platform = jax.devices()[0].platform
    if (platform == "cpu" and not args.smoke
            and (jax.config.jax_platforms or "").split(",")[0] != "cpu"):
        sys.exit("bench.py: JAX found no accelerator; use --smoke, or "
                 "JAX_PLATFORMS=cpu to measure the CPU on purpose")
    if platform != "cpu":
        # CPU runs compile fresh, as the tests do (tests/conftest.py)
        from ida_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    # B=262144 is the headline width carried over from an earlier
    # accelerator; it has not been swept on the GPU yet
    batch = args.batch or (64 if args.smoke else (262144 if platform != "cpu" else 1024))
    dtype = jnp.float32 if args.f32 else jnp.float64
    if args.native is None:
        args.native = platform != "cpu" and not args.vmapped
    if args.vmapped:
        args.native = False

    if args.problem == "heat2d":
        run_heat2d_bench(args, platform)
        return

    # ---- artifact-safe orchestration --------------------------------------
    # A caller that keeps only the tail of the output, or kills the run at
    # its own deadline, must still find a complete record:
    #   * a COMPACT (<1500 B) headline line is printed IMMEDIATELY after
    #     the headline leg + oracle, then re-printed after EVERY extras leg
    #     (so whatever instant the run dies, the nearest-to-EOF JSON line
    #     is a complete, current record), and once more as the final line;
    #   * the full per-leg detail goes to BENCH_DETAIL.json (atomic
    #     rewrite after every leg), never to stdout;
    #   * SIGTERM prints the best-known record on the way out;
    #   * the in-process budget defaults to 2400 s.
    budget = _Budget(os_environ_float("IDA_BENCH_WATCHDOG_S", 2400))
    detail_path = os.environ.get("IDA_BENCH_DETAIL") or (
        os.path.join(tempfile.gettempdir(), "BENCH_DETAIL_smoke.json")
        if args.smoke
        else os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "BENCH_DETAIL.json"
        )
    )
    art = {"compact": None, "detail": {}}

    def write_detail():
        art["detail"]["leg_errors"] = budget.errors
        art["detail"]["legs_skipped"] = budget.skipped
        try:
            tmp = detail_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(art["detail"], f, indent=1)
            os.replace(tmp, detail_path)
        except OSError:
            pass

    def print_compact():
        if art["compact"] is not None:
            c = dict(art["compact"])
            c["detail"] = dict(c["detail"])
            c["detail"]["legs_err"] = sorted(budget.errors)
            c["detail"]["legs_skipped"] = len(budget.skipped)
            print(json.dumps(c), flush=True)

    def _on_term(signum, frame):
        art["detail"]["terminated"] = "SIGTERM"
        write_detail()
        print_compact()
        os._exit(0 if art["compact"] is not None else 143)

    signal.signal(signal.SIGTERM, _on_term)

    def _on_wedge(name):
        # Timer-thread path (_Budget.on_wedge): the MAIN thread is stuck
        # in a C call, so neither SIGALRM nor SIGTERM handlers can run.
        # Persist what we know, print the best-known record and exit.
        art["detail"]["wedged"] = (
            f"leg '{name}' blocked {_Budget.WEDGE_SLACK_S:.0f}s past its "
            f"slice; main thread unresponsive to signals"
        )
        write_detail()
        print_compact()
        os._exit(0 if art["compact"] is not None else 3)

    budget.on_wedge = _on_wedge

    # wall/pipeline assumes in-order device execution; pipeline=3 has not
    # been measured on the GPU yet
    pipeline = 1 if platform == "cpu" else 3
    if args.native:
        native_out = budget.leg(
            run_ensemble_native, batch, args.tout, dtype, min_s=10.0,
            pipeline=pipeline, name="headline", retries=2, cap_s=1500,
        )
        headline = None
        headline_counters = {}
        if native_out is not None:
            steps_n, walls_n, ok_n, lanes_n, headline_counters = native_out
            headline = (steps_n, min(walls_n), ok_n, lanes_n)
    else:
        headline_counters = {}
        headline = budget.leg(
            run_ensemble, batch, args.tout, dtype, min_s=10.0,
            name="headline", retries=2, cap_s=1500,
        )
        walls_n = [headline[1]] if headline is not None else []
    if headline is None:
        # no fallback: a failed headline is a failed run
        err = budget.errors.get("headline") or budget.skipped.get(
            "headline", "leg returned None"
        )
        write_detail()
        print(f"bench.py: headline leg failed on {platform}: {err}",
              file=sys.stderr, flush=True)
        sys.exit(1)
    steps, dt, n_ok, n = headline
    agg = steps / dt

    # serial CPU IDA baseline: the native C++ oracle (ida_tpu/native),
    # single core, built-in Roberts problem — the same role the reference's
    # sundials-sys FFI oracle plays in its benchmark (benches/dense.rs).
    # Measured IMMEDIATELY after the headline so the compact record is
    # complete as early as possible. The measurement wobbles with machine
    # load, so take the BEST of five longer runs; every run stays in the
    # artifact.
    from ida_tpu.native import oracle_roberts_bench

    touts = [args.tout]
    oracle_roberts_bench(touts, reps=1)  # build/warm
    reps = 50 if args.smoke else 3000
    cpu_rates = []
    for _ in range(1 if args.smoke else 5):
        t0 = time.perf_counter()
        osteps, _ = oracle_roberts_bench(touts, reps=reps)
        cpu_rates.append(osteps / (time.perf_counter() - t0))
    cpu_rate = max(cpu_rates)
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    def refresh_compact():
        """(Re)build the compact headline record from current walls,
        PRESERVING any extra detail keys the extras legs inserted (the
        final re-print is the line a tail-reading caller captures — a
        from-scratch rebuild silently dropped f32_mode/fast_f64 there)."""
        steps_, dt_, n_ok_, n_ = headline
        agg_ = steps_ / dt_
        ws = sorted(walls_n) if walls_n else [dt_]
        prev_extra = dict((art.get("compact") or {}).get("detail", {}))
        art["compact"] = {
            "metric": f"batched Roberts aggregate integrator steps/sec "
            f"(B={batch}, tout={args.tout:g}, "
            f"{'f32' if args.f32 else 'f64'}"
            f"{', native' if args.native else ''}, "
            f"{platform})",
            "value": round(agg_, 1),
            "unit": "steps/sec",
            "vs_baseline": round(agg_ / cpu_rate, 2),
            # the median sits at TOP level so the best-of-N
            # headline can't be read as a typical rate
            "value_median": round(steps_ / ws[len(ws) // 2], 1),
            "detail": {
                "total_steps": steps_,
                "wall_best_s": round(dt_, 4),
                "wall_median_s": round(ws[len(ws) // 2], 4),
                "n_walls": len(ws),
                "pipeline": pipeline,
                "ok_lanes": n_ok_,
                "lanes": n_,
                "oracle_best": round(cpu_rate, 1),
                "device": device,
                "detail_file": "BENCH_DETAIL.json",
            },
        }
        for k, v in prev_extra.items():
            art["compact"]["detail"].setdefault(k, v)
        art["detail"]["headline"] = {
            **art["compact"],
            "wall_runs_s": [round(w, 4) for w in walls_n],
            "native_cpu_ida_runs": [round(r, 1) for r in cpu_rates],
            "native_cpu_ida_steps_per_sec_median": round(
                sorted(cpu_rates)[len(cpu_rates) // 2], 1
            ),
            "newton_lu_solves_per_sec": round(
                headline_counters.get("nni_total", 0.0) / dt_, 1
            ) if headline_counters else None,
            "lu_factorizations_per_sec": round(
                headline_counters.get("nje_total", 0.0) / dt_, 1
            ) if headline_counters else None,
            "residual_evals_per_sec": round(
                headline_counters.get("nre_total", 0.0) / dt_, 1
            ) if headline_counters else None,
        }

    refresh_compact()
    write_detail()
    print_compact()  # EARLY print: the record exists from this instant on

    def extra(key, fn, *args_, **kw):
        """Run one extras leg; record it and refresh the on-disk/on-stdout
        artifact immediately (a later wedge cannot lose this leg)."""
        rec = budget.leg(fn, *args_, name=key, **kw)
        if rec is not None:
            art["detail"][key] = rec
        write_detail()
        print_compact()
        return rec

    if not args.smoke and not args.f32 and not args.no_extras:
        # f32 throughput mode alongside the f64 headline (every lane still
        # satisfies its own error test)
        if args.native:
            r32 = budget.leg(run_ensemble_native, batch, args.tout,
                             jnp.float32, reps=3, pipeline=pipeline,
                             name="f32_mode", min_s=120.0, cap_s=900)
            if r32 is not None and r32[2] == r32[3]:
                v32 = round(r32[0] / min(r32[1]), 1)
                art["compact"]["detail"]["f32_mode_steps_per_sec"] = v32
                art["detail"]["f32_mode"] = {
                    "steps_per_sec": v32, "total_steps": r32[0],
                    "wall_runs_s": [round(w, 4) for w in r32[1]],
                    "vs_oracle": round(v32 / cpu_rate, 2),
                }
        else:
            r32 = budget.leg(run_ensemble, batch, args.tout, jnp.float32,
                             name="f32_mode", min_s=120.0, cap_s=900)
            if r32 is not None and r32[2] == r32[3]:
                art["compact"]["detail"]["f32_mode_steps_per_sec"] = round(
                    r32[0] / r32[1], 1
                )
        write_detail()
        print_compact()
        # NON-PARITY fast_math f64 leg (VERDICT r3 item 2): same program
        # shape as the headline with the phi-star scaling folded into its
        # consumers; reported separately, parity mode stays the headline
        if args.native:
            rfm = budget.leg(run_ensemble_native, batch, args.tout, dtype,
                             reps=3, pipeline=pipeline, fast_math=True,
                             name="fast_f64", min_s=120.0, cap_s=900)
            if rfm is not None and rfm[2] == rfm[3]:
                vfm = round(rfm[0] / min(rfm[1]), 1)
                art["compact"]["detail"]["fast_f64_steps_per_sec"] = vfm
                art["compact"]["detail"]["fast_f64_vs_baseline"] = round(
                    vfm / cpu_rate, 2
                )
                art["detail"]["fast_f64"] = {
                    "steps_per_sec": vfm,
                    "total_steps": rfm[0],
                    "wall_runs_s": [round(w, 4) for w in rfm[1]],
                    "vs_oracle": round(vfm / cpu_rate, 2),
                    "vs_parity_headline": round(vfm / agg, 2),
                }
            acc = budget.leg(run_fast_accuracy, name="fast_f64_accuracy",
                             min_s=120.0, cap_s=900)
            if acc is not None:
                art["detail"].setdefault("fast_f64", {})["accuracy"] = acc
            write_detail()
            print_compact()
        # canonical 12-decade horizon sweep (reference benches/dense.rs):
        # on-device, batch-native, fused dense output, sorted chunks
        extra("decades_sweep", run_decades_sweep, batch, jnp.float64,
              min_s=300.0, cap_s=900)
        # rootfinding at production batch (r_check3 + Illinois at width)
        extra("roberts_roots", run_roberts_roots, min(batch, 65536),
              args.tout, jnp.float64, min_s=200.0, cap_s=600)
        # BASELINE.md configs 4-5 (one large system each; own compiles)
        h2 = extra("heat2d_100x100_spgmr", run_heat2d, 100, 0.16,
                   min_s=200.0, cap_s=600)
        # mixed-precision single-instance config-4 leg (VERDICT r4 item 5):
        # f32 Krylov inside the f64 Newton loop + CGS2 Arnoldi (the best
        # single-instance mode on an earlier accelerator; not yet measured
        # on the GPU)
        h2s = extra("heat2d_100x100_spgmr_mixed", run_heat2d, 100, 0.16,
                    ls_precision="single", krylov_gs="classical",
                    min_s=150.0, cap_s=500)
        h2b = extra("heat2d_100x100_batched", run_heat2d_batched, 100, 0.16,
                    B=64, min_s=200.0, cap_s=600)
        h2c = budget.leg(run_cpu_serial, "heat2d", min_s=90.0, cap_s=420,
                         name="heat2d_cpu_serial")
        if h2c is not None and h2c.get("ok"):
            for rec in (h2, h2s, h2b):
                if rec is not None:
                    key = ("agg_steps_per_sec" if "agg_steps_per_sec" in rec
                           else "steps_per_sec")
                    rec["cpu_serial_steps_per_sec"] = h2c["steps_per_sec"]
                    rec["vs_cpu_serial"] = round(
                        rec[key] / h2c["steps_per_sec"], 2
                    )
        # mixed-precision leg (IdaOptions.ls_precision="single"): the f32
        # Krylov iteration inside the f64 Newton loop; B=128 was tuned on
        # an earlier accelerator and has not been swept on the GPU yet
        h2m = extra("heat2d_100x100_batched_mixed", run_heat2d_batched,
                    100, 0.16, B=128, ls_precision="single",
                    min_s=150.0, cap_s=500)
        if h2m is not None:
            if h2c is not None and h2c.get("ok"):
                h2m["cpu_serial_steps_per_sec"] = h2c["steps_per_sec"]
                h2m["vs_cpu_serial"] = round(
                    h2m["agg_steps_per_sec"] / h2c["steps_per_sec"], 2
                )
            if h2b is not None:
                h2m["vs_full_precision"] = round(
                    h2m["agg_steps_per_sec"] / h2b["agg_steps_per_sec"], 2
                )
        fw = extra("foodweb_20x20", run_foodweb, 20, min_s=150.0, cap_s=500)
        # B=128: the width carried over from an earlier accelerator, where
        # larger widths faulted; not yet swept on the GPU
        fwb = extra("foodweb_20x20_batched", run_foodweb_batched, 20, B=128,
                    min_s=150.0, cap_s=500)
        fwc = budget.leg(run_cpu_serial, "foodweb", min_s=90.0, cap_s=420,
                         name="foodweb_cpu_serial")
        if fwc is not None and fwc.get("ok"):
            for rec in (fw, fwb):
                if rec is not None:
                    key = ("agg_steps_per_sec" if "agg_steps_per_sec" in rec
                           else "steps_per_sec")
                    rec["cpu_serial_steps_per_sec"] = fwc["steps_per_sec"]
                    rec["vs_cpu_serial"] = round(
                        rec[key] / fwc["steps_per_sec"], 2
                    )
        # mixed-precision foodweb leg (f32 Krylov in the f64 Newton loop)
        fwm = extra("foodweb_20x20_batched_mixed", run_foodweb_batched, 20,
                    B=128, ls_precision="single", min_s=120.0, cap_s=400)
        if fwm is not None and fwb is not None:
            fwm["vs_full_precision"] = round(
                fwm["agg_steps_per_sec"] / fwb["agg_steps_per_sec"], 2
            )
        if fwm is not None and fwc is not None and fwc.get("ok"):
            # give the mixed leg its serial-CPU denominator too
            fwm["cpu_serial_steps_per_sec"] = fwc["steps_per_sec"]
            fwm["vs_cpu_serial"] = round(
                fwm["agg_steps_per_sec"] / fwc["steps_per_sec"], 2
            )
        # batched adjoint gradients (IDAS-A role; forward + reverse sweep
        # through the adaptive attempt loop, per-lane grads at width)
        adj = extra("adjoint_batched", run_adjoint_batched, 4096,
                    min_s=300.0, cap_s=700)
        # the continuous-adjoint strategy on the same ensemble (IDAS
        # adjoint-module role): ~2 solves/lane vs the discrete tape.
        # B=1024 (was 4096 in r3 — that leg plausibly contributed to the
        # r3 watchdog kill; the strategy comparison doesn't need width)
        adjc = extra("adjoint_continuous", run_adjoint_continuous, 1024,
                     min_s=240.0, cap_s=600)
        if adjc is not None and adj is not None:
            adjc["vs_discrete_adjoint"] = round(
                adjc["grads_per_sec"] / adj["grads_per_sec"], 2
            )
        write_detail()

    # second headline sampling window: the shared part's load varies on a
    # minutes scale, and the extras block above takes ~10-20 min, so
    # re-sampling the (already compiled) headline here and merging walls
    # makes best-of-N span two well-separated load windows instead of one
    # instant — a fairer shot at the machine's true (uncontended) rate.
    # Identical program + inputs; every wall still lands in the artifact.
    if args.native and not args.smoke and headline is not None:
        resample = budget.leg(
            run_ensemble_native, batch, args.tout, dtype, reps=3,
            pipeline=pipeline, min_s=30.0, cap_s=300, name="resample",
        )
        if resample is not None:
            steps_r, walls_r, ok_r, lanes_r, _c = resample
            if ok_r == lanes_r and steps_r == steps_n:
                walls_n = walls_n + walls_r
                headline = (steps_n, min(walls_n), ok_n, lanes_n)
            else:
                # ADVICE r3: a silently-dropped second window must be
                # visible — record WHY the merge guard refused it
                art["detail"]["resample_skipped"] = (
                    f"steps {steps_r} vs {steps_n}, ok {ok_r}/{lanes_r}"
                )

    refresh_compact()
    write_detail()
    print_compact()  # FINAL line: same compact record, freshest walls


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
