"""idaRoberts_dns replica: the reference's example binary
(reference examples/roberts.rs:58-176) — solve loop over 12 output decades,
root reporting, statistics table, and the WRMS acceptance check.

Run: PYTHONPATH=. python examples/roberts.py
"""

import jax.numpy as jnp
import numpy as np

from ida_tpu import IDA, IdaSolveStatus
from ida_tpu.models import roberts_problem, ROBERTS_YY0, ROBERTS_YP0
from ida_tpu.tol_control import tol_sv

RTOL = 1.0e-4
ATOL = np.array([1.0e-8, 1.0e-6, 1.0e-6])


def ans_wrms(y):
    """reference examples/roberts.rs:9-51: WRMS error of the final state
    vs the rtol=1e-8 reference solution, with loosened weights."""
    reference = np.array(
        [5.2083474251394888e-08, 2.0833390772616859e-13, 9.9999994791631752e-01]
    )
    ewt = 1.0 / (RTOL * np.abs(reference) + 10.0 * ATOL)
    return float(np.sqrt(np.mean((ewt * (y - reference)) ** 2)))


def check_ans(y):
    """The acceptance check: :func:`ans_wrms` must be < 1."""
    err = ans_wrms(y)
    print(f"check_ans: WRMS error vs reference solution = {err:.6f} "
          f"({'PASS' if err < 1.0 else 'FAIL'})")
    return err < 1.0


def main():
    print("idaRoberts_dns: Robertson kinetics DAE example for ida_tpu.")
    print("Three-equation chemical kinetics, dense Newton, analytic Jacobian.")
    print(f"Tolerances: rtol = {RTOL:g}, atol = {ATOL.tolist()}\n")

    ida = IDA(roberts_problem(), ROBERTS_YY0, ROBERTS_YP0,
              tol_sv(RTOL, jnp.asarray(ATOL)))

    hdr = f"{'t':>12} {'y1':>14} {'y2':>14} {'y3':>14} {'nst':>5} {'k':>2} {'h':>12}"
    print(hdr)
    print("-" * len(hdr))

    iout, tout = 0, 0.4
    while iout < 12:
        tret, status = ida.solve(tout)
        y = ida.get_yy()
        print(
            f"{tret:12.4e} {y[0]:14.5e} {y[1]:14.5e} {y[2]:14.5e} "
            f"{ida.get_num_steps():5d} {ida.get_last_order():2d} "
            f"{ida.get_last_step():12.4e}"
            + ("  <- root" if status == IdaSolveStatus.Root else "")
        )
        if status == IdaSolveStatus.Root:
            print(f"{'':12} roots found: {ida.get_root_info().tolist()}")
        elif status == IdaSolveStatus.Success:
            iout += 1
            tout *= 10.0

    print("\nFinal run statistics:")
    stats = [
        ("Number of steps", ida.get_num_steps()),
        ("Number of residual evaluations", ida.get_num_res_evals()),
        ("Number of Jacobian evaluations", ida.get_num_jac_evals()),
        ("Number of nonlinear iterations", ida.get_num_nonlin_solv_iters()),
        ("Number of error test failures", ida.get_num_err_test_fails()),
        ("Number of nonlinear conv. failures", ida.get_num_nonlin_solv_conv_fails()),
        ("Number of root fn. evaluations", ida.get_num_g_evals()),
    ]
    for name, v in stats:
        print(f"  {name:<38} {v}")

    ok = check_ans(ida.get_yy())
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
