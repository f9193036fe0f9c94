"""Slider-crank mechanism: stabilized index-2 DAE (GGL formulation).

The reference ships this model as a residual-only sample problem and never
integrates it (reference src/sample_problems/slider_crank.rs:26-155, itself
SUNDIALS ``idaSlCrank_dns`` by R. Serban). This driver actually runs it, the
way the C example does: consistent rest ICs, suppressalg (the algebraic
Lagrange multipliers are excluded from the local error test — required for
index-2), a trajectory table, and the time-averaged kinetic energy
accumulated as a QUADRATURE along the solution (the role the C idaSlCrank
FSA variant fills with IDAQuad).

Run: PYTHONPATH=. python examples/slider_crank.py
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from ida_tpu import IDA, IdaSolveStatus
from ida_tpu.core.state import IdaOptions
from ida_tpu.models import slider_crank_problem
from ida_tpu.models.slider_crank import slider_crank_ic
from ida_tpu.tol_control import tol_ss

A, J1, M2, J2 = 0.5, 1.0, 1.0, 2.0
TEND = 10.0
NOUT = 20


def kinetic_energy(yy):
    qd, xd, pd = yy[3], yy[4], yy[5]
    return 0.5 * (J1 * qd * qd + M2 * xd * xd + J2 * pd * pd)


def main():
    base = slider_crank_problem(a=A, J1=J1, m2=M2, J2=J2)
    prob = dataclasses.replace(
        base,
        quad=lambda t, yy, yp: jnp.stack([kinetic_energy(yy)]),
        nquad=1,
    )
    yy0, yp0 = slider_crank_ic(A, J1=J1, m2=M2, J2=J2)
    ida = IDA(
        prob, yy0, yp0, tol_ss(1e-6, 1e-6),
        options=IdaOptions(mxstep=100000, suppressalg=True),
    )

    print("slider-crank (GGL index-2), AD Jacobian, suppressalg")
    print(f"{'t':>6} {'q':>12} {'x':>12} {'p':>12} {'KE':>12} {'|g(pos)|':>10}")
    for tout in np.linspace(TEND / NOUT, TEND, NOUT):
        tret, status = ida.solve(float(tout))
        assert status == IdaSolveStatus.Success, status
        y = ida.get_yy()
        # position constraint residuals (GGL keeps them at the tolerance)
        g1 = y[1] - np.cos(y[2]) - A * np.cos(y[0])
        g2 = -np.sin(y[2]) - A * np.sin(y[0])
        gnorm = float(np.hypot(g1, g2))
        print(
            f"{tret:6.2f} {y[0]:12.6f} {y[1]:12.6f} {y[2]:12.6f} "
            f"{kinetic_energy(y):12.6f} {gnorm:10.2e}"
        )

    ke_avg = float(ida.get_quad()[0]) / TEND
    print(f"\ntime-averaged kinetic energy over [0, {TEND:g}]: {ke_avg:.8f}")

    print("\nFinal statistics:")
    print(f"  steps                    = {ida.get_num_steps()}")
    print(f"  residual evaluations     = {ida.get_num_res_evals()}")
    print(f"  Jacobian evaluations     = {ida.get_num_jac_evals()}")
    print(f"  nonlinear iterations     = {ida.get_num_nonlin_solv_iters()}")
    print(f"  error test failures      = {ida.get_num_err_test_fails()}")
    print(f"  last order / step        = {ida.get_last_order()}, "
          f"{ida.get_last_step():.3e}")

    assert gnorm < 1e-7, "position constraint drifted"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
