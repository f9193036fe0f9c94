"""Hybrid-system (event-driven) integration: a bouncing ball.

Demonstrates the event → discrete update → reinit workflow that C IDA users
build from IDARootInit + IDAReInit (the reference exposes the pieces —
rootfinding impl_r_check.rs, though it has no reinit — but never shows the
loop). The continuous dynamics are a trivial index-0 DAE

    F1 = h' - v = 0
    F2 = v' + g = 0

with one root function g1(t, y) = h and a DOWNWARD root direction filter
(rootdir = -1, C IDASetRootDirection semantics). At each detected impact
the discrete restitution map v <- -e * v is applied and the integrator is
reinitialized at the event time (IDAReInit semantics: history and counters
reset, options and tolerances kept).

The detected bounce times are compared against the closed form
    t_1 = sqrt(2 h0 / g),   t_{k+1} = t_k + 2 e^k t_1.

Run:  PYTHONPATH=. python examples/bounce.py
"""

import numpy as np

import jax.numpy as jnp

from ida_tpu import IDA, IdaSolveStatus
from ida_tpu.problem import IdaProblem
from ida_tpu.tol_control import tol_ss

G = 9.81
E = 0.5  # coefficient of restitution
H0 = 10.0
N_BOUNCES = 5


def bounce_problem() -> IdaProblem:
    def res(t, y, yp):
        return jnp.stack([yp[0] - y[1], yp[1] + G])

    def root(t, y, yp):
        return y[0:1]  # g1 = h

    return IdaProblem(n=2, res=res, root=root, nroots=1)


def analytic_bounce_times(n: int) -> np.ndarray:
    t1 = np.sqrt(2.0 * H0 / G)
    times = [t1]
    for k in range(1, n):
        times.append(times[-1] + 2.0 * E**k * t1)
    return np.asarray(times)


def main() -> int:
    ida = IDA(
        bounce_problem(),
        jnp.asarray([H0, 0.0]),
        jnp.asarray([0.0, -G]),
        tol_ss(1e-10, 1e-12),
    )
    ida.set_root_direction([-1])  # impacts only (h decreasing)

    print("bouncing ball: h0 = %g m, e = %g, g = %g" % (H0, E, G))
    print(f"{'bounce':>6} {'t_event':>18} {'t_analytic':>18} {'|err|':>10}")

    t_end = 20.0
    events = []
    while len(events) < N_BOUNCES:
        tret, status = ida.solve(t_end)
        if status == IdaSolveStatus.Root:
            assert ida.get_root_info()[0] == -1  # downward crossing
            events.append(float(tret))
            h, v = np.asarray(ida.get_yy())
            # discrete restitution map + reinit at the event time
            v_new = -E * v
            ida.reinit(
                jnp.asarray([0.0, v_new]),
                jnp.asarray([v_new, -G]),
                t0=float(tret),
            )
        elif status == IdaSolveStatus.Success:
            break
        else:
            raise SystemExit(f"solver failure: {status}")

    ref = analytic_bounce_times(len(events))
    ok = True
    for k, (te, ta) in enumerate(zip(events, ref)):
        err = abs(te - ta)
        ok = ok and err < 1e-6
        print(f"{k + 1:>6} {te:18.12f} {ta:18.12f} {err:10.2e}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
