"""Multi-device CORRECTNESS (VERDICT r3 item 6) on the 8-virtual-CPU mesh.

MULTICHIP_r* proved the sharded programs compile and run; these tests
assert what they compute: (a) device-count invariance — the 8-device
dp-sharded and sharded-N runs land on the single-device trajectories;
(b) the 2-D (batch x state) mesh composition solves correctly; (c) the
dp inner loop compiles to ZERO collectives (the embarrassingly-parallel
claim of SURVEY.md §2.2: per-lane norms, no cross-lane reductions — so
nothing crosses the interconnect), while the sharded-N program's all-reduces are the
expected SPGMR dot-product psums.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ida_tpu import constants as C
from ida_tpu.core.solve import solve as core_solve
from ida_tpu.core.state import IdaOptions, init_state
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu.models.heat2d import heat2d_ic, heat2d_problem
from ida_tpu.parallel import (
    ensemble_init,
    make_ensemble_solve,
    make_mesh,
    make_mesh_2d,
    shard_ensemble,
    shard_ensemble_2d,
    shard_state_vector,
)
from ida_tpu.parallel.mesh import data_collectives
from ida_tpu.tol_control import tol_ss, tol_sv
from jax.sharding import NamedSharding, PartitionSpec as P

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)


def _roberts_ensemble(batch):
    scale = np.exp(np.linspace(-0.1, 0.1, batch))
    params = jnp.asarray(np.outer(scale, ROBERTS_PARAMS))
    yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0), (batch, 1))
    yp0 = params[:, 0:1] * jnp.asarray([-1.0, 1.0, 0.0])
    states = ensemble_init(roberts_factory, params, yy0, yp0)
    return states, params


def test_dp_sharded_trajectory_equals_per_shard_runs():
    """Device-count invariance for dp sharding, stated precisely: the
    8-device run of B=16 is BITWISE equal to eight independent 2-lane runs
    (each device's partition computes exactly what it would compute alone
    — no cross-lane contamination, no resharding artifacts). Against the
    UNSHARDED B=16 run the counters are identical and the trajectory
    agrees to ~2e-13: XLA:CPU vectorizes a width-16 batch with different
    fusion rounding than width-2, a compiler-layout effect unrelated to
    sharding (each lane's math is still lane-local either way)."""
    tol = tol_sv(1.0e-4, jnp.asarray([1e-8, 1e-6, 1e-6]))
    solve = make_ensemble_solve(roberts_factory, donate=False)

    states, params = _roberts_ensemble(16)
    st1, tret1, ist1 = solve(states, params, tol, jnp.asarray(4000.0))

    mesh = make_mesh(8)
    states_s, params_s = _roberts_ensemble(16)
    states_s = shard_ensemble(states_s, mesh)
    params_s = jax.device_put(params_s, NamedSharding(mesh, P("batch")))
    st8, tret8, ist8 = solve(states_s, params_s, tol, jnp.asarray(4000.0))

    assert len(st8.phi.sharding.device_set) == 8
    assert np.all(np.asarray(ist8) == C.SUCCESS)

    # (1) bitwise vs eight independent per-shard (B=2) runs
    scale = np.exp(np.linspace(-0.1, 0.1, 16))
    full_params = np.outer(scale, ROBERTS_PARAMS)
    yy_parts, nst_parts = [], []
    for k in range(8):
        p2 = jnp.asarray(full_params[2 * k: 2 * k + 2])
        yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0), (2, 1))
        yp0 = p2[:, 0:1] * jnp.asarray([-1.0, 1.0, 0.0])
        s2 = ensemble_init(roberts_factory, p2, yy0, yp0)
        s2o, _, _ = solve(s2, p2, tol, jnp.asarray(4000.0))
        yy_parts.append(np.asarray(s2o.yy))
        nst_parts.append(np.asarray(s2o.nst))
    np.testing.assert_array_equal(
        np.concatenate(yy_parts), np.asarray(st8.yy)
    )
    np.testing.assert_array_equal(
        np.concatenate(nst_parts), np.asarray(st8.nst)
    )

    # (2) vs the unsharded full batch: same statuses, step sequences and
    # counters; trajectory equal to vector-width rounding, far below the
    # 1e-4 integration tolerance
    np.testing.assert_array_equal(np.asarray(ist8), np.asarray(ist1))
    np.testing.assert_array_equal(np.asarray(tret8), np.asarray(tret1))
    for fld in ("nst", "nni", "nre", "nje", "netf", "ncfn"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st8, fld)), np.asarray(getattr(st1, fld)), fld
        )
    np.testing.assert_allclose(
        np.asarray(st8.yy), np.asarray(st1.yy), rtol=1e-11
    )


def test_dp_inner_loop_has_no_data_collectives():
    """The dp program's compiled HLO must move NO array data between
    devices: each lane's Newton/error-test norms are lane-local, so the
    ONLY collectives XLA may insert are the scalar pred[] all-reduces that
    evaluate the global while-loop conditions (`any lane still active`) —
    one predicate byte per loop trip, nothing proportional to batch or
    state size, hence nothing that could load the interconnect."""
    tol = tol_sv(1.0e-4, jnp.asarray([1e-8, 1e-6, 1e-6]))
    mesh = make_mesh(8)
    states, params = _roberts_ensemble(16)
    states = shard_ensemble(states, mesh)
    params = jax.device_put(params, NamedSharding(mesh, P("batch")))

    solve = make_ensemble_solve(roberts_factory, donate=False)
    hlo = solve.lower(
        states, params, tol, jnp.asarray(0.4)
    ).compile().as_text()
    bad = []
    for line in hlo.splitlines():
        if not any(op in line for op in _COLLECTIVES):
            continue
        # allowed: scalar predicate all-reduce (loop-condition OR/AND)
        if "all-reduce" in line and "pred[] all-reduce" in line:
            continue
        bad.append(line.strip()[:160])
    assert not bad, "dp program moves array data between devices:\n" + (
        "\n".join(bad)
    )


def test_data_collectives_reads_result_shapes():
    """The HLO audit flags collectives by their result shape: scalar
    predicates (alone, combined into a tuple, or as async start/done
    pairs) pass; anything carrying an array is reported, and with
    allow_scalar=False every collective is."""
    hlo = "\n".join([
        "%a = pred[] all-reduce(pred[] %p), to_apply=%or",
        "%b = (pred[], pred[]) all-reduce(pred[] %p, pred[] %q), to_apply=%or",
        "%c = pred[] all-reduce-start(pred[] %p), to_apply=%or",
        "%d = pred[] all-reduce-done(pred[] %c)",
        "%e = f64[4,3]{1,0} all-gather(f64[1,3]{1,0} %x), dimensions={0}",
        "%f = f32[128]{0} all-reduce-start(f32[128]{0} %y), to_apply=%add",
        "%g = (f64[8]{0}, u32[]) collective-permute-start(f64[8]{0} %z)",
        "%h = f64[8]{0} add(f64[8]{0} %u, f64[8]{0} %v)",
        "%i = f64[8]{0} fusion(f64[8]{0} %u), calls=%all-reduce_clone",
    ])
    bad = data_collectives(hlo)
    assert [ln.split(" =")[0] for ln in bad] == ["%e", "%f", "%g"]
    strict = data_collectives(hlo, allow_scalar=False)
    assert [ln.split(" =")[0] for ln in strict] == [
        "%a", "%b", "%c", "%d", "%e", "%f", "%g"]


def _heat2d_setup(m=16, mxstep=2000):
    prob = heat2d_problem(m, use_prec=True)
    u0, up0 = heat2d_ic(m)
    opts = IdaOptions(linear_solver="spgmr", mxstep=mxstep)
    st = init_state(prob, u0, up0, opts=opts)
    fn = jax.jit(
        partial(core_solve, problem=prob, opts=opts, tol=tol_ss(1e-5, 1e-8))
    )
    return prob, st, fn


def test_sharded_state_trajectory_matches_single_device():
    """Sharded-N (the TP analogue): the 8-way split changes only the
    REDUCTION ORDER of the SPGMR dot products (partial-sums-then-psum vs
    one sequential fold), so the step sequence must be identical and the
    trajectory equal to ~roundoff accumulation, not integration error."""
    prob, st, fn = _heat2d_setup()
    st1, tret1, ist1 = fn(st, tout=jnp.asarray(0.01))

    mesh = make_mesh(8)
    _, st8, _ = _heat2d_setup()
    st8 = shard_state_vector(st8, mesh, prob.n)
    st8, tret8, ist8 = fn(st8, tout=jnp.asarray(0.01))

    assert int(ist8) == C.SUCCESS and int(ist1) == C.SUCCESS
    assert int(st8.nst) == int(st1.nst)
    assert int(st8.nni) == int(st1.nni)
    np.testing.assert_allclose(
        np.asarray(st8.yy), np.asarray(st1.yy), rtol=0, atol=1e-12
    )

    # positive control for the dp zero-collective assertion: THIS program
    # genuinely contains all-reduces (the Krylov dot psums)
    hlo = fn.lower(st8, tout=jnp.asarray(0.01)).compile().as_text()
    assert "all-reduce" in hlo


def test_2d_mesh_batch_x_state_composition():
    """DP x TP on one program: 4 heat2d lanes (trailing-batch) over a
    (2 batch x 4 state) mesh — lanes split 2-way, each lane's N=256 state
    vector split 4-way — must solve every lane and match the unsharded
    batch-native run bit-for-bit on the step counters."""
    m, B = 16, 4
    prob = heat2d_problem(m, use_prec=True)
    u0, up0 = heat2d_ic(m)
    opts = IdaOptions(linear_solver="spgmr", mxstep=2000)
    scales = jnp.linspace(0.9, 1.1, B)
    u0b = jnp.asarray(u0)[None, :] * scales[:, None]
    up0b = jnp.asarray(up0)[None, :] * scales[:, None]
    states = ensemble_init(lambda s: prob, scales, u0b, up0b, opts=opts)
    states_T = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    fn = jax.jit(
        partial(core_solve, problem=prob, opts=opts, tol=tol_ss(1e-5, 1e-8))
    )
    tout = jnp.full((B,), 0.01)

    st1, tret1, ist1 = fn(states_T, tout=tout)

    mesh = make_mesh_2d(2, 4)
    states2 = ensemble_init(lambda s: prob, scales, u0b, up0b, opts=opts)
    states2_T = jax.tree_util.tree_map(
        lambda x: jnp.moveaxis(x, 0, -1), states2
    )
    states2_T = shard_ensemble_2d(states2_T, mesh, prob.n)
    st2, tret2, ist2 = fn(states2_T, tout=tout)

    assert len(st2.phi.sharding.device_set) == 8
    assert np.all(np.asarray(ist2) == C.SUCCESS)
    np.testing.assert_array_equal(np.asarray(st2.nst), np.asarray(st1.nst))
    np.testing.assert_array_equal(np.asarray(st2.nni), np.asarray(st1.nni))
    np.testing.assert_allclose(
        np.asarray(st2.yy), np.asarray(st1.yy), rtol=0, atol=1e-12
    )
