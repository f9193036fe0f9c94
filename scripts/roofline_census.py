"""Quantitative roofline for the f64 headline leg (VERDICT r4 item 2).

Puts the f64 headline program against the part's own ceilings:

1. BYTES PER STEP from the compiler itself: ``compiled.cost_analysis()``
   ("bytes accessed") of the exact headline program (B-lane Roberts
   ensemble, C-parity f64), divided by the measured internal steps the
   call takes.
2. ACHIEVED PROGRAM BANDWIDTH: bytes accessed / measured wall.
3. STREAM CEILING on the same chip: a pure f64 triad (y = a*x + y) over
   an HBM-resident array, timed the same way — the best any
   bandwidth-bound f64 program can do on the part.

Roofline ratio = (2) / (3). Output: one JSON line for PERF.md.

Usage:  python scripts/roofline_census.py [batch]   (default 262144)
"""

import json
import os
import sys
import time


def main():
    import jax

    from ida_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from functools import partial

    from bench import build
    from ida_tpu.core.solve import solve as core_solve, TASK_NORMAL
    from ida_tpu.core.state import IdaOptions
    from ida_tpu.models import roberts_factory
    from ida_tpu.tol_control import TolControl

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 262144
    dtype = jnp.float64
    tout = 400.0

    states, params, _, _ = build(batch, dtype)
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    prob_T = roberts_factory(jnp.moveaxis(params, 0, -1))
    atol = jnp.asarray([1e-8, 1e-6, 1e-6], dtype)
    tol_T = TolControl(
        rtol=jnp.full((batch,), 1e-4, dtype),
        atol=jnp.tile(atol[:, None], (1, batch)),
    )
    fn = jax.jit(
        partial(core_solve, problem=prob_T, opts=IdaOptions(), tol=tol_T,
                itask=TASK_NORMAL)
    )
    touts = jnp.full((batch,), tout, dtype)

    lowered = fn.lower(states_T, tout=touts)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    bytes_accessed = float(ca.get("bytes accessed", 0.0))
    flops = float(ca.get("flops", 0.0))

    # measured run (steady state: run once to settle, then time)
    st, tret, ist = fn(states_T, tout=touts)
    jax.block_until_ready(ist)
    states_T2 = jax.tree_util.tree_map(
        lambda x: jnp.moveaxis(x, 0, -1), build(batch, dtype)[0]
    )
    t0 = time.perf_counter()
    st, tret, ist = fn(states_T2, tout=touts)
    jax.block_until_ready(ist)
    wall = time.perf_counter() - t0
    nst = float(np.asarray(st.nst, np.float64).sum())
    att = float(
        np.asarray(st.nst + st.netf + st.ncfn, np.float64).sum()
    )

    # NOTE on semantics: XLA's "bytes accessed" counts one pass of the
    # while BODY's reads+writes per... it reports the whole-program static
    # estimate (loop bodies counted once), so the honest per-step figure
    # uses the body estimate x measured trip count. Derive trips from the
    # max attempts per lane (lockstep: every lane pays the max).
    att_max = float(np.asarray((st.nst + st.netf + st.ncfn)).max())

    # --- exact carry census: bytes/lane the attempt loop MUST read+write
    # per trip (the state pytree itself; the algorithmic lower bound on
    # HBM traffic if nothing stays resident on chip) ---
    leaves = jax.tree_util.tree_leaves(states_T)
    carry_bytes_per_lane = sum(
        l.size * l.dtype.itemsize for l in leaves
    ) / batch

    # --- stream ceiling: f64 triad over ~2 GiB resident ---
    nelem = 128 * 1024 * 1024  # 1 GiB per f64 array
    x = jnp.ones((nelem,), dtype)
    y = jnp.full((nelem,), 2.0, dtype)

    @jax.jit
    def triad(x, y):
        return 1.0001 * x + y

    z = triad(x, y)
    jax.block_until_ready(z)
    reps = 8
    t0 = time.perf_counter()
    for _ in range(reps):
        z = triad(z, y)
    jax.block_until_ready(z)
    tw = (time.perf_counter() - t0) / reps
    stream_gbs = 3 * nelem * 8 / tw / 1e9  # read x + read y + write z

    # --- arithmetic ceilings: K-deep dependent elementwise chains on a
    # resident vector — the sustained element-op rate the part gives a
    # program shaped like the solver body (long dependent chains of
    # small ops), NOT the matrix-unit peak. y=y*a+b is a non-reassociable
    # polynomial in y so XLA cannot collapse the chain; the div chain is
    # nonlinear. Each op counts 1 element-op (the same convention XLA's
    # cost_analysis "flops" uses), so these divide cleanly into the
    # program census below.
    def chain_rate(cdt, kind, nelem=8 * 1024 * 1024, K=64, reps=8):
        a = jnp.asarray(1.0000001, cdt)
        c = jnp.asarray(1e-9, cdt)

        if kind == "fma":
            def f(y):
                for _ in range(K):
                    y = y * a + c
                return y
        else:  # div
            def f(y):
                for _ in range(K):
                    y = a / (y + c)
                return y

        f = jax.jit(f)
        y = jnp.full((nelem,), 1.5, cdt)
        y = f(y)
        jax.block_until_ready(y)
        t0 = time.perf_counter()
        for _ in range(reps):
            y = f(y)
        jax.block_until_ready(y)
        dt = (time.perf_counter() - t0) / reps
        return 2 * K * nelem / dt  # 2 element-ops per chain link

    fma64 = chain_rate(dtype, "fma")
    div64 = chain_rate(dtype, "div")
    fma32 = chain_rate(jnp.float32, "fma")

    agg_steps_s = nst / wall
    rec = {
        "batch": batch,
        "program_bytes_accessed": bytes_accessed,
        "program_flops": flops,
        "wall_s": round(wall, 3),
        "total_steps": nst,
        "total_attempts": att,
        "max_attempts_per_lane": att_max,
        "agg_steps_per_sec": round(agg_steps_s, 1),
        "bytes_per_lane_attempt": (
            round(bytes_accessed / (att_max * batch), 1) if att_max else None
        ),
        # two interpretations of the static estimate (see NOTE above):
        # (a) whole-program as reported; (b) body-once x measured trips.
        # Whichever lands at/below the stream ceiling is the physical one.
        "program_achieved_GBs_as_reported": round(
            bytes_accessed / wall / 1e9, 1
        ),
        "program_achieved_GBs_body_x_trips": (
            round(bytes_accessed * att_max / wall / 1e9, 1) if att_max else None
        ),
        "stream_triad_GBs": round(stream_gbs, 1),
        # arithmetic side of the roofline (element-ops/s, cost_analysis
        # convention). The program's implied rate uses the as-reported
        # static flop census over the measured wall — same interpretation
        # rule as the bytes: whichever lands at/below its measured
        # ceiling is the physical one.
        "carry_bytes_per_lane": round(carry_bytes_per_lane, 1),
        "chain_f64_fma_Gops": round(fma64 / 1e9, 1),
        "chain_f64_div_Gops": round(div64 / 1e9, 1),
        "chain_f32_fma_Gops": round(fma32 / 1e9, 1),
        "f32_over_f64_fma": round(fma32 / fma64, 2),
        "program_f64_Gops_as_reported": round(flops / wall / 1e9, 1),
        "program_flops_per_lane_attempt": (
            round(flops / (att_max * batch), 1) if att_max else None
        ),
        "roofline_frac_arith_vs_fma_chain": round(flops / wall / fma64, 3),
        # pure-bandwidth bound from the exact carry census: even if
        # arithmetic were free, read+write of the state pytree per trip
        # at the triad rate caps lane-attempts/s at this
        "bw_bound_Mattempts_s": round(
            stream_gbs * 1e9 / (2 * carry_bytes_per_lane) / 1e6, 1
        ) if carry_bytes_per_lane else None,
        "measured_Mattempts_s": round(att_max * batch / wall / 1e6, 1),
    }
    for k in ("program_achieved_GBs_as_reported",
              "program_achieved_GBs_body_x_trips"):
        if rec[k] and stream_gbs:
            rec[k.replace("program_achieved", "roofline_frac")] = round(
                rec[k] / stream_gbs, 3
            )
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
