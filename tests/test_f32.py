"""float32 throughput mode: the whole solver runs in f32 with appropriately
looser tolerances (throughput dtype; parity mode stays f64)."""

import jax.numpy as jnp
import numpy as np

from ida_tpu import IDA, IdaSolveStatus
from ida_tpu.models import roberts_problem, ROBERTS_YY0, ROBERTS_YP0
from ida_tpu.tol_control import tol_sv


def test_roberts_f32():
    tol = tol_sv(1e-4, jnp.asarray([1e-6, 1e-6, 1e-6], jnp.float32), dtype=jnp.float32)
    ida = IDA(
        roberts_problem(with_roots=False),
        ROBERTS_YY0,
        ROBERTS_YP0,
        tol,
        dtype=jnp.float32,
    )
    assert ida.state.phi.dtype == jnp.float32
    for tout in (0.4, 4.0, 40.0):
        tret, status = ida.solve(tout)
        assert status == IdaSolveStatus.Success
    # f64 reference values at t = 40
    np.testing.assert_allclose(
        ida.get_yy(), [7.15786e-01, 9.18378e-06, 2.84204e-01], rtol=2e-3
    )


def test_reinit():
    tol = tol_sv(1e-4, jnp.array([1e-8, 1e-6, 1e-6]))
    ida = IDA(roberts_problem(with_roots=False), ROBERTS_YY0, ROBERTS_YP0, tol)
    ida.solve(0.4)
    n1 = ida.get_num_steps()
    y1 = ida.get_yy().copy()

    ida.reinit(ROBERTS_YY0, ROBERTS_YP0)
    assert ida.get_num_steps() == 0
    tret, status = ida.solve(0.4)  # reuses the compiled solve
    assert status == IdaSolveStatus.Success
    assert ida.get_num_steps() == n1
    np.testing.assert_array_equal(ida.get_yy(), y1)
