"""Every bundled model's residual must preserve the state dtype.

A problem closure that captures f64 constant arrays silently promotes
f32 inputs to f64 THROUGH the jtimes jvp, so f32 and
ls_precision="single" modes quietly run f64 math (on an earlier
accelerator that emulated f64, the foodweb mixed bench leg gained 1.05x
instead of 2.42x before this was fixed). This pins
`res(f32).dtype == float32` (and jtimes) for every bundled model so a
future constant can't reintroduce the upcast.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ida_tpu.models import roberts_problem
from ida_tpu.models.foodweb import foodweb_ic, foodweb_problem
from ida_tpu.models.heat2d import heat2d_problem
from ida_tpu.models.lorenz63 import lorenz63_problem
from ida_tpu.models.slider_crank import slider_crank_problem


def _cases():
    fw = foodweb_problem(4, 4)
    c0, cp0 = foodweb_ic(4, 4)
    return [
        ("roberts", roberts_problem(with_roots=False),
         np.array([1.0, 0.0, 0.0]), np.array([-0.04, 0.04, 0.0])),
        ("foodweb", fw, c0, cp0),
        ("heat2d", heat2d_problem(8), np.zeros(64), np.zeros(64)),
        ("lorenz63", lorenz63_problem(),
         np.array([1.0, 1.0, 1.0]), np.zeros(3)),
        ("slider_crank", slider_crank_problem(), None, None),
    ]


@pytest.mark.parametrize("name,prob,y0,yp0",
                         _cases(), ids=[c[0] for c in _cases()])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_res_and_jtimes_preserve_dtype(name, prob, y0, yp0, dtype):
    n = prob.n
    yy = (jnp.ones((n,), dtype) if y0 is None
          else jnp.asarray(y0, dtype))
    yp = (jnp.zeros((n,), dtype) if yp0 is None
          else jnp.asarray(yp0, dtype))
    t = jnp.asarray(0.0, dtype)
    cj = jnp.asarray(1.0, dtype)
    r = prob.res(t, yy, yp)
    assert r.dtype == dtype, f"{name} res promoted to {r.dtype}"
    v = jnp.ones((n,), dtype)
    jv = prob.jtimes(t, cj, yy, yp, v, None)
    assert jv.dtype == dtype, f"{name} jtimes promoted to {jv.dtype}"
    # batch-native trailing-batch form must also hold the dtype
    rb = prob.res(t, jnp.tile(yy[:, None], (1, 4)), jnp.tile(yp[:, None], (1, 4)))
    assert rb.dtype == dtype, f"{name} batched res promoted to {rb.dtype}"
