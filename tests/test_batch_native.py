"""Batch-native (batch-LAST, no-vmap) core equivalence.

The solver core accepts states whose leaves carry one TRAILING batch axis
and runs WITHOUT vmap — scalar lane predicates broadcast against
trailing-batch data leaves. This layout avoids the vmap-of-while select
merge, and bench.py times it as the headline. The contract tested here:
the native path is BIT-IDENTICAL to the vmapped per-lane path.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ida_tpu.core.solve import solve as core_solve, TASK_NORMAL
from ida_tpu.core.state import IdaOptions
from ida_tpu.models import roberts_factory, ROBERTS_PARAMS, ROBERTS_YY0
from ida_tpu.parallel import ensemble_init, make_ensemble_solve
from ida_tpu.tol_control import tol_sv, TolControl


def test_batch_native_matches_vmap_bitwise():
    dtype = jnp.float64
    B = 4
    scale = np.linspace(0.9, 1.1, B)
    params = jnp.asarray(np.outer(scale, ROBERTS_PARAMS), dtype)
    yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0, dtype), (B, 1))
    yp0 = params[:, 0:1] * jnp.asarray([-1.0, 1.0, 0.0], dtype)
    tol = tol_sv(1e-4, jnp.asarray([1e-8, 1e-6, 1e-6], dtype), dtype=dtype)
    opts = IdaOptions()
    states = ensemble_init(roberts_factory, params, yy0, yp0, dtype=dtype, opts=opts)

    # vmapped reference path (batch-leading)
    ref = make_ensemble_solve(roberts_factory, opts, donate=False)
    st_r, tret_r, ist_r = ref(states, params, tol, jnp.asarray(0.4, dtype))

    # batch-native: every leaf transposed to batch-LAST, ONE core_solve call
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    prob_T = roberts_factory(jnp.moveaxis(params, 0, -1))
    tol_T = TolControl(
        rtol=jnp.full((B,), 1e-4, dtype),
        atol=jnp.tile(jnp.asarray([[1e-8], [1e-6], [1e-6]], dtype), (1, B)),
    )
    tout_T = jnp.full((B,), 0.4, dtype)
    st_T, tret_T, ist_T = jax.jit(
        lambda s: core_solve(s, prob_T, opts, tol_T, tout_T, TASK_NORMAL)
    )(states_T)

    assert np.array_equal(np.asarray(ist_T), np.asarray(ist_r))
    assert np.array_equal(np.asarray(tret_T), np.asarray(tret_r))
    assert np.array_equal(np.asarray(st_T.nst), np.asarray(st_r.nst))
    for name in ("yy", "yp", "ewt", "ee"):
        a = np.moveaxis(np.asarray(getattr(st_T, name)), -1, 0)
        b = np.asarray(getattr(st_r, name))
        assert np.array_equal(a, b), f"leaf {name} differs"
    phi_T = np.moveaxis(np.asarray(st_T.phi), -1, 0)
    assert np.array_equal(phi_T, np.asarray(st_r.phi))
