"""Aggregate a jax.profiler trace by named_scope: per-scope device time.

Usage:
  python scripts/profile_scopes.py --trace           # capture a fresh trace
  python scripts/profile_scopes.py [dir]             # aggregate newest trace

Traces (and the compiled HLO) go to ``traces/scopes`` in the checkout
(git-ignored) unless another directory is given.

Each HLO op event's name carries the jax.named_scope prefixes the source
computation was annotated with (utils/profiling.scope on every core
routine); summing device-track durations by first scope component gives the
per-lockstep-iteration cost table in PERF.md.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys

OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traces", "scopes"
)

SCOPES = (
    "set_coeffs", "predict", "restore", "reset", "nonlinear_solve",
    "newton_iterate", "lsetup", "error_test", "complete_step", "interpolate",
    "get_solution", "root_find", "r_check1", "r_check2", "r_check3",
)


def capture(out_dir=OUT_DIR, batch=262144):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial

    from ida_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from ida_tpu.core.solve import solve as core_solve, TASK_NORMAL
    from ida_tpu.core.state import IdaOptions
    from ida_tpu.models import roberts_factory
    from ida_tpu.tol_control import TolControl
    import bench

    dtype = jnp.float64
    states, params, _, _ = bench.build(batch, dtype)
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    prob_T = roberts_factory(jnp.moveaxis(params, 0, -1))
    atol = jnp.asarray([1e-8, 1e-6, 1e-6], dtype)
    tol_T = TolControl(
        rtol=jnp.full((batch,), 1e-4, dtype), atol=jnp.tile(atol[:, None], (1, batch))
    )
    fn = jax.jit(
        partial(core_solve, problem=prob_T, opts=IdaOptions(), tol=tol_T,
                itask=TASK_NORMAL)
    )
    tout_T = jnp.full((batch,), 400.0, dtype)
    out = fn(states_T, tout=tout_T)
    _ = np.asarray(out[0].nst)
    print("warm", flush=True)
    txt = fn.lower(states_T, tout=tout_T).compile().as_text()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "solve.hlo"), "w") as fh:
        fh.write(txt)
    states, params, _, _ = bench.build(batch, dtype)
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    import jax.profiler

    with jax.profiler.trace(out_dir):
        st, tret, ist = fn(states_T, tout=tout_T)
        _ = np.asarray(st.nst)
    print("traced ->", out_dir, flush=True)
    return out_dir


def aggregate(root):
    paths = sorted(glob.glob(f"{root}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        print(f"no trace under {root}")
        return
    with gzip.open(paths[-1], "rt") as fh:
        data = json.load(fh)
    events = data.get("traceEvents", [])
    # find device-track pids (GPU stream tracks, not host threads)
    device_pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name = e.get("args", {}).get("name", "")
            if "/device:" in name or "GPU" in name or "XLA" in name:
                device_pids.add(e["pid"])
    by_scope = collections.Counter()
    total = 0.0
    nev = 0
    for e in events:
        if e.get("ph") != "X" or (device_pids and e.get("pid") not in device_pids):
            continue
        dur = e.get("dur", 0)
        name = e.get("name", "")
        if not dur or name.startswith("Infeed") :
            continue
        total += dur
        nev += 1
        scope = "other"
        for s in SCOPES:
            if s in name:
                scope = s
                break
        by_scope[scope] += dur
    print(f"{paths[-1]}\n  device events: {nev}, total {total/1e3:.1f} ms")
    for s, us in by_scope.most_common():
        print(f"  {s:20s} {us/1e3:10.1f} ms  {100*us/total:5.1f}%")


if __name__ == "__main__":
    sys.path.insert(0, ".")
    if "--trace" in sys.argv:
        d = capture()
        aggregate(d)
    else:
        aggregate(sys.argv[1] if len(sys.argv) > 1 else OUT_DIR)
