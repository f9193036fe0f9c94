"""idaHeat2D_kry replica: 2-D heat DAE with matrix-free SPGMR + diagonal
preconditioner (C SUNDIALS example structure; BASELINE.md config 4).

Run: PYTHONPATH=. python examples/heat2d.py [grid_size]
"""

import sys

from ida_tpu import IDA, IdaOptions, IdaSolveStatus
from ida_tpu.models.heat2d import heat2d_problem, heat2d_ic
from ida_tpu.tol_control import tol_ss


def main():
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    prob = heat2d_problem(m, use_prec=True)
    u0, up0 = heat2d_ic(m)
    opts = IdaOptions(linear_solver="spgmr", mxstep=20000)
    ida = IDA(prob, u0, up0, tol_ss(1e-5, 1e-8), options=opts)

    print(f"idaHeat2D_kry: {m}x{m} grid heat DAE, matrix-free SPGMR, "
          f"diagonal preconditioner (N = {prob.n})\n")
    print(f"{'t':>10} {'max(u)':>12} {'nst':>5} {'k':>2} {'nli':>5} {'nps':>6} {'nre':>6}")

    tout = 0.01
    for _ in range(11):
        tret, status = ida.solve(tout)
        assert status == IdaSolveStatus.Success
        print(
            f"{tret:10.4f} {ida.get_yy().max():12.6e} {ida.get_num_steps():5d} "
            f"{ida.get_last_order():2d} {ida.get_num_lin_iters():5d} "
            f"{ida.get_num_prec_solves():6d} {ida.get_num_res_evals():6d}"
        )
        tout *= 2.0

    print("\nmatrix-free: Jacobian evaluations =", ida.get_num_jac_evals())


if __name__ == "__main__":
    main()
