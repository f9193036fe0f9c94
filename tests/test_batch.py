"""Ensemble (vmap) and sharded-mesh integration tests.

The reference has no parallelism (SURVEY.md §2.2); these tests validate the
ensemble scale-out: the whole solver under vmap (lockstep batching with
per-lane step counts) and the batch axis sharded over a virtual 8-device
mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from ida_tpu import constants as C
from ida_tpu.models import roberts_factory, ROBERTS_PARAMS, ROBERTS_YY0, ROBERTS_YP0
from ida_tpu.parallel import EnsembleIDA, ensemble_init, make_ensemble_solve, make_mesh, shard_ensemble
from ida_tpu.tol_control import tol_sv


def _ensemble(b):
    scale = np.linspace(0.8, 1.25, b)
    params = jnp.asarray(np.outer(scale, ROBERTS_PARAMS))
    # lane with nominal chemistry for cross-checking
    params = params.at[0].set(jnp.asarray(ROBERTS_PARAMS))
    yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0), (b, 1))
    yp0 = params[:, 0:1] * jnp.asarray([-1.0, 1.0, 0.0])  # yp0 = [-k1, k1, 0]
    return params, yy0, yp0


def test_ensemble_matches_single():
    b = 8
    params, yy0, yp0 = _ensemble(b)
    tol = tol_sv(1.0e-4, jnp.array([1e-8, 1e-6, 1e-6]))
    ens = EnsembleIDA(roberts_factory, params, yy0, yp0, tol)
    tret, istate = ens.solve(0.4)
    assert np.all(istate == C.SUCCESS), ens.status_names(istate)
    np.testing.assert_allclose(tret, 0.4)

    # lane 0 (nominal params) must match a single-instance solve bit-for-bit:
    # lockstep masking must not alter any individual trajectory
    from ida_tpu import IDA
    from ida_tpu.models import roberts_problem

    ida = IDA(roberts_problem(with_roots=False), ROBERTS_YY0, ROBERTS_YP0, tol)
    ida.solve(0.4)
    np.testing.assert_allclose(ens.yy[0], ida.get_yy(), rtol=1e-12)
    assert int(ens.nst[0]) == ida.get_num_steps()

    # different chemistry -> different step counts, all finished
    assert len(set(ens.nst.tolist())) > 1


def test_ensemble_sharded_mesh():
    b = 16
    params, yy0, yp0 = _ensemble(b)
    tol = tol_sv(1.0e-4, jnp.array([1e-8, 1e-6, 1e-6]))
    states = ensemble_init(roberts_factory, params, yy0, yp0)

    mesh = make_mesh(8)
    states = shard_ensemble(states, mesh)
    solve = make_ensemble_solve(roberts_factory, donate=False)
    states, tret, istate = solve(states, params, tol, jnp.asarray(0.4))
    assert np.all(np.asarray(istate) == C.SUCCESS)
    np.testing.assert_allclose(np.asarray(tret), 0.4)
    # result really is distributed over 8 devices
    assert len(states.phi.sharding.device_set) == 8


def test_ensemble_lane_failure_isolated():
    # one lane gets absurd chemistry that cannot converge; others succeed
    b = 4
    params, yy0, yp0 = _ensemble(b)
    params = params.at[2].set(jnp.array([jnp.nan, 1e4, 3e7]))
    tol = tol_sv(1.0e-4, jnp.array([1e-8, 1e-6, 1e-6]))
    ens = EnsembleIDA(roberts_factory, params, yy0, yp0, tol)
    tret, istate = ens.solve(0.4)
    assert istate[2] < 0  # the poisoned lane fails with a status code
    ok = [i for i in range(b) if i != 2]
    assert np.all(istate[ok] == C.SUCCESS)
    np.testing.assert_allclose(tret[ok], 0.4)


def test_report_failures_poisoned_lane():
    """One poisoned lane (NaN rate constants) produces a readable per-lane
    failure report; healthy lanes are absent from it."""
    from ida_tpu.models import roberts_factory, ROBERTS_PARAMS, ROBERTS_YY0
    from ida_tpu.parallel import EnsembleIDA
    from ida_tpu.tol_control import tol_sv

    b = 4
    params = np.tile(np.asarray(ROBERTS_PARAMS), (b, 1))
    params[2] = np.nan  # poison lane 2
    yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0), (b, 1))
    yp0 = jnp.asarray(params[:, 0:1]) * jnp.asarray([-1.0, 1.0, 0.0])
    tol = tol_sv(1e-4, jnp.array([1e-8, 1e-6, 1e-6]))
    ens = EnsembleIDA(roberts_factory, jnp.asarray(params), yy0, yp0, tol)
    tret, istate = ens.solve(0.4)

    rows = ens.report_failures(istate)
    assert [r["lane"] for r in rows] == [2]
    r = rows[0]
    assert r["status"] < 0 and r["status_name"] != ""
    assert np.isfinite(r["t"]) or r["t"] == 0.0  # decoded, not garbage
    txt = ens.format_failures(istate)
    assert "lane 2" in txt and r["status_name"] in txt
    # healthy lanes solved fine
    assert all(istate[i] >= 0 for i in (0, 1, 3))
