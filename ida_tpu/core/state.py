"""The integrator state pytree (L4 layer).

Behavioural spec: the reference's mutable ``Ida`` struct plus its nested
nonlinear/linear problem state (reference ``src/lib.rs:89-244``,
``src/ida_nls.rs:20-60``, ``src/ida_ls.rs:15-106``), flattened into one
immutable NamedTuple.

Design: every field is a statically-shaped array so the whole
state is a ``lax.while_loop`` carry and a ``vmap`` batch axis can be laid
over all of it. Rust ``Result`` early-exits become the ``status`` lane;
Python/host code never sees intermediate states.

Configuration that the reference fixes at compile time or hides without
setters (hin/hmax/tstop/maxord — SURVEY §5 "no public setters") is split
here into *static* options (``IdaOptions``: loop bounds, trace-time) and
*traced per-instance* fields (hin, hmax_inv, tstop — so a vmapped ensemble
can have heterogeneous settings).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..problem import IdaProblem


@dataclasses.dataclass(frozen=True)
class IdaOptions:
    """Static (trace-time) solver options.

    Mirrors the defaults set in ``Ida::new`` (reference src/lib.rs:309-317)
    plus the option surface the reference lacks public setters for
    (SURVEY.md §5 config).
    """

    maxord: int = C.MAXORD_DEFAULT  # max BDF order (1..5)
    mxstep: int = C.MXSTEP_DEFAULT  # max internal steps per solve() call
    maxncf: int = C.MXNCF  # max convergence failures per step
    maxnef: int = C.MXNEF  # max error-test failures per step
    maxnlsit: int = C.MAXNLSIT  # max Newton iterations per attempt
    suppressalg: bool = False  # exclude algebraic vars from error tests
    max_root_iters: int = 100  # hard bound on the Illinois root search loop
    # --- linear solver selection (reference stubs the iterative path,
    # crates/linear/src/lib.rs:15-20; SPGMR is in-scope per SURVEY.md §2.3)
    # "dense" (batched LU) | "band" (banded LU, the C IDA IDABand analogue
    # the reference never ported; ops/banded.py) | "spgmr" (Krylov)
    linear_solver: str = "dense"
    band_mu: int = 0  # upper half-bandwidth (linear_solver="band")
    band_ml: int = 0  # lower half-bandwidth (linear_solver="band")
    # --- linear-solver precision (beyond-reference, opt-in) ---
    # "full": the linear solve runs in the state dtype (C-parity default).
    # "single": the Jacobian evaluation, LU factor/solve (dense) or the
    # whole Krylov iteration (spgmr) run in float32 inside the f64 Newton
    # loop; corrections are cast back to f64. Mathematically an inexact
    # Newton: the fixed point (residual -> 0) and the f64 local error test
    # are unchanged, so trajectories stay within the requested tolerances,
    # but step counts are NOT bit-identical to C IDA — this mode trades
    # step-parity for float32's halved bytes. The lever was built for an
    # earlier accelerator that emulated f64; its gain on the GPU, which
    # has native f64, is not yet measured.
    # "refined": dense path only. The Jacobian is evaluated in f64,
    # FACTORED AND STORED in f32 (halving the factor's HBM footprint in
    # the loop carry), and every linear solve runs one step of f64
    # iterative refinement against the setup-point Jacobian applied
    # matrix-free (a jvp of the residual at the saved lsetup point):
    # x = x0 + LU32^{-1}(b - J x0). Correction error ~(kappa(J)*u32)^2,
    # so step decisions track the C-parity "full" mode through MODERATE
    # conditioning (Roberts decades 1-7, asserted in
    # tests/test_mixed_precision.py) but drift where kappa reaches ~1e6
    # (measured; PERF.md round 5) — an accuracy-passing mode strictly
    # tighter than "single", NOT a bit-parity mode. For problems whose
    # analytic `jac` differs from the AD Jacobian of `res`, the
    # refinement target is the AD Jacobian (identical for every bundled
    # model).
    ls_precision: str = "full"  # "full" | "single" | "refined"
    # --- Krylov-basis storage dtype (beyond-reference, opt-in) ---
    # "compute": the GMRES basis V lives in the linear-solve dtype (exact
    # baseline). "bfloat16": V is STORED in bf16 while all reductions (MGS
    # dot products, Hessenberg/Givens algebra, back substitution) stay in
    # the linear-solve dtype — halves the dominant [maxl+1, N, B] HBM
    # traffic of a bandwidth-bound Krylov lane at the cost of ~3 significant
    # digits of basis orthogonality. Inexact-Newton argument as for
    # ls_precision="single": the f64 residual/error test still gate every
    # step, so accuracy holds but step counts are not parity. Measured on
    # the heat2d leg in PERF.md (round 4 bf16-storage experiment).
    krylov_storage: str = "compute"  # "compute" | "bfloat16"
    krylov_maxl: int = 5  # GMRES subspace dimension (SUNDIALS default)
    krylov_max_restarts: int = 5  # GMRES restarts (SUNDIALS default)
    # Arnoldi orthogonalization (SUNLS_SPGMR gstype: MODIFIED_GS /
    # CLASSICAL_GS). "modified" is the SUNDIALS default and the parity
    # anchor. "classical" is CGS2 (classical Gram-Schmidt with one full
    # reorthogonalization pass — at least as orthogonal as MGS): the
    # j+1 sequential dot+axpy pairs per Arnoldi iteration collapse into
    # 2x2 batched whole-basis contractions, shortening the dependency
    # chain ~(j+1)/2-fold — measurably faster on the latency-bound
    # single-instance PDE configs (PERF.md round 5), at the price of
    # reading the full V each iteration (worse for bandwidth-bound
    # batched lanes).
    krylov_gs: str = "modified"  # "modified" | "classical"
    eplifac: float = 0.05  # linear tolerance factor (reference ida_ls.rs:211)
    # per-step-attempt state dumps into utils.trace.DataTrace (the
    # reference's data_trace feature, SURVEY.md §5)
    debug_trace: bool = False
    # statically unroll the Newton iteration to maxnlsit masked passes
    # (bit-identical results; sheds while-loop overhead — at large batch the
    # lockstep while runs near max iterations anyway, so the extra masked
    # passes are nearly free and the loop machinery isn't)
    unroll_newton: bool = False
    # use the static-trip-count (reverse-differentiable) form of the
    # Illinois root-search loop — lax.while_loop has no VJP, so the adjoint
    # path forces this on; arithmetic per lane is unchanged (masked no-op
    # passes after convergence)
    unroll_roots: bool = False
    # rematerialize each step attempt in the backward pass
    # (jax.checkpoint on the budgeted attempt-loop body): reverse-mode AD
    # then stores only the per-attempt loop CARRY instead of every Newton
    # iterate / LU factor / phi intermediate — the standard memory/compute
    # trade for long-horizon adjoints. No effect on forward-only solves.
    remat_attempts: bool = False
    # trace-time analogue of C IDA's free scalar `constraintsSet` branch
    # (ida.c IDANls): with False, the inequality-constraint block is not
    # traced at all. The block is an exact identity when no lane has
    # constraints set (ee/rr/nl_status pass through unchanged), so skipping
    # it is bit-identical for constraint-free problems — but in a lockstep
    # batch the discarded evaluation still costs real HBM bandwidth, which
    # a static flag (unlike the per-lane runtime `constraints_set`) can
    # remove. IDA.set_constraints refuses to run under this flag.
    enable_constraints: bool = True
    # NON-PARITY fast path (NEXT.md lever 1a / VERDICT r3 item 2): keep the
    # phi array UNSCALED and fold the phi -> phi-star beta scaling into its
    # consumers (predict's sums, error_test's row picks, complete_step's
    # recurrence) instead of materializing phi-star in set_coeffs and
    # un-materializing it in restore. Eliminates one full [K1,N,B]
    # write+read per attempt and the whole restore phi pass on failures.
    # Changes floating-point association ((phi*beta)*gamma becomes
    # phi*(beta*gamma)), so step sequences are NOT bit-identical to C IDA —
    # trajectories stay within the integration tolerance (validated by
    # tests/test_fast_math.py against parity mode and check_ans). Parity
    # mode (default) remains the correctness anchor.
    fast_math: bool = False


class IdaState(NamedTuple):
    """Complete integrator state. Shapes: N = problem size, R = max(nroots, 1),
    K1 = MXORDP1 = 6. All real fields share one dtype (float64 for parity)."""

    # --- BDF history and coefficients (reference src/lib.rs:104-116) ---
    phi: jax.Array  # [K1, N] divided differences
    psi: jax.Array  # [K1]
    alpha: jax.Array  # [K1]
    beta: jax.Array  # [K1]
    sigma: jax.Array  # [K1]
    gamma: jax.Array  # [K1]

    # --- work vectors (reference src/lib.rs:118-126, src/ida_nls.rs:25-39) ---
    ee: jax.Array  # [N] accumulated corrections / local error estimate
    yy: jax.Array  # [N]
    yp: jax.Array  # [N]
    yypredict: jax.Array  # [N]
    yppredict: jax.Array  # [N]
    ewt: jax.Array  # [N] error weights
    savres: jax.Array  # [N] saved residual

    # --- step data (reference src/lib.rs:140-194) ---
    tn: jax.Array  # current internal time
    hh: jax.Array  # current step size
    hused: jax.Array  # step size of last successful step
    rr: jax.Array  # hnext / hused
    h0u: jax.Array  # actual initial step size
    tretlast: jax.Array  # last tret returned
    tolsf: jax.Array  # tolerance scale factor
    kk: jax.Array  # int32 current order
    kused: jax.Array  # int32 order of last successful step
    knew: jax.Array  # int32 proposed order after decrease decision
    phase: jax.Array  # int32 0 = startup (raise order, double h)
    ns: jax.Array  # int32 steps at constant h and k

    # --- nonlinear-solver state (reference src/ida_nls.rs:41-48) ---
    cj: jax.Array
    cjlast: jax.Array
    cjold: jax.Array
    cjratio: jax.Array
    ss: jax.Array
    oldnrm: jax.Array
    eps_newt: jax.Array
    toldel: jax.Array

    # --- linear-solver state (reference src/ida_ls.rs:22-31) ---
    lu: jax.Array  # [N, N] factored J (dense path; [0,0] under spgmr);
    #               f32 storage when ls_precision != "full" (exact image)
    piv: jax.Array  # [N] int32 pivots (dense path)
    pdata: object  # preconditioner state pytree (spgmr path; () if unused)
    # --- lsetup linearization point (ls_precision="refined" only; [0]-
    # sized otherwise): the f64 refinement applies the factored Jacobian
    # matrix-free as a jvp of the residual at this saved point ---
    ls_tn: jax.Array  # [] time of the last lsetup
    ls_cj: jax.Array  # [] cj of the last lsetup
    ls_yy: jax.Array  # [N] y at the last lsetup ([0] unless refined)
    ls_yp: jax.Array  # [N] y' at the last lsetup ([0] unless refined)

    # --- traced options (per-instance; see module docstring) ---
    hin: jax.Array  # initial step (0 = auto)
    hmax_inv: jax.Array  # 1/hmax (0 = unlimited)
    epcon: jax.Array  # Newton convergence constant
    tstop: jax.Array  # stop time (value meaningful iff tstop_set)
    tstop_set: jax.Array  # bool
    constraints: jax.Array  # [N] inequality constraint codes (0 = none)
    constraints_set: jax.Array  # bool

    # --- counters (reference src/lib.rs:71-84, ida_ls.rs:44-59) ---
    nst: jax.Array  # int64 steps
    nre: jax.Array  # residual evaluations
    ncfn: jax.Array  # nonlinear convergence failures
    netf: jax.Array  # error test failures
    nni: jax.Array  # Newton iterations
    nsetups: jax.Array  # lsetup calls
    nje: jax.Array  # Jacobian evaluations
    nge: jax.Array  # root function evaluations
    nli: jax.Array  # linear (Krylov) iterations
    nps: jax.Array  # preconditioner solves
    ncfl: jax.Array  # linear convergence failures (reference ida_ls.rs:52)
    njtsetup: jax.Array  # jtimes-setup calls (reference ida_ls.rs:56)
    njtimes: jax.Array  # Jacobian-vector products (reference ida_ls.rs:58)

    # --- rootfinding (reference src/lib.rs:196-231) ---
    tlo: jax.Array
    thi: jax.Array
    trout: jax.Array
    ttol: jax.Array
    toutc: jax.Array
    glo: jax.Array  # [R]
    ghi: jax.Array  # [R]
    grout: jax.Array  # [R]
    iroots: jax.Array  # [R] int32 (sign of crossing, 0 = none)
    rootdir: jax.Array  # [R] int32 direction filter
    gactive: jax.Array  # [R] bool
    irfnd: jax.Array  # bool: last return was a root
    taskc: jax.Array  # int32 saved itask

    # --- quadrature accumulator (IDAS quadrature role; beyond reference) ---
    yQ: jax.Array  # [max(nquad,1)] running integral of quad() from t0 to tn

    # --- outcome lane (replaces Rust Result, reference src/error.rs) ---
    status: jax.Array  # int32, constants.CONTINUE while stepping

    @property
    def dtype(self):
        return self.phi.dtype


def _ls_store_dtype(opts: "IdaOptions", dtype):
    """Direct-solver factor storage dtype: f32 under the mixed-precision
    modes (exact image of the f32 factorization; see IdaOptions)."""
    if opts.linear_solver in ("dense", "band") and opts.ls_precision in (
        "single", "refined",
    ):
        return jnp.float32
    return dtype


def init_state(
    problem: IdaProblem,
    yy0: jax.Array,
    yp0: jax.Array,
    *,
    dtype=jnp.float64,
    opts: IdaOptions = IdaOptions(),
) -> IdaState:
    """Build the initial state (reference ``Ida::new``, src/lib.rs:278-405):
    phi[0] = y0, phi[1] = y'0, defaults everywhere else."""
    n = problem.n
    dense = opts.linear_solver == "dense"
    if opts.ls_precision == "refined" and not dense:
        raise ValueError(
            "ls_precision='refined' is implemented for the dense path only"
        )
    pdata = problem.prec_zero() if problem.prec_setup is not None else ()
    r = max(problem.nroots, 1)
    yy0 = jnp.asarray(yy0, dtype)
    yp0 = jnp.asarray(yp0, dtype)
    assert yy0.shape == (n,) and yp0.shape == (n,)

    zeros_k1 = jnp.zeros(C.MXORDP1, dtype)
    zeros_n = jnp.zeros(n, dtype)
    phi = jnp.zeros((C.MXORDP1, n), dtype).at[0].set(yy0).at[1].set(yp0)
    z = jnp.asarray(0.0, dtype)

    return IdaState(
        phi=phi,
        psi=zeros_k1,
        alpha=zeros_k1,
        beta=zeros_k1,
        sigma=zeros_k1,
        gamma=zeros_k1,
        ee=zeros_n,
        yy=yy0,
        yp=yp0,
        yypredict=zeros_n,
        yppredict=zeros_n,
        ewt=zeros_n,
        savres=zeros_n,
        tn=z,
        hh=z,
        hused=z,
        rr=z,
        h0u=z,
        tretlast=z,
        tolsf=jnp.asarray(1.0, dtype),
        kk=jnp.asarray(0, jnp.int32),
        kused=jnp.asarray(0, jnp.int32),
        knew=jnp.asarray(0, jnp.int32),
        phase=jnp.asarray(0, jnp.int32),
        ns=jnp.asarray(0, jnp.int32),
        cj=z,
        cjlast=z,
        cjold=z,
        cjratio=z,
        ss=z,
        oldnrm=z,
        eps_newt=z,
        toldel=z,
        # direct-solver workspace: dense [N,N] / band [2*ml+mu+1,N] (the
        # SUNDIALS band storage with ml fill rows) / spgmr none. Storage
        # dtype is f32 for the mixed-precision modes: the f32 factor's
        # image is exact there, and the carry buffer is the HBM traffic
        # every masked loop iteration pays (IdaOptions.ls_precision).
        lu=(
            jnp.zeros((n, n), _ls_store_dtype(opts, dtype))
            if dense
            else jnp.zeros(
                (2 * opts.band_ml + opts.band_mu + 1, n),
                _ls_store_dtype(opts, dtype),
            )
            if opts.linear_solver == "band"
            else jnp.zeros((0, 0), dtype)
        ),
        piv=jnp.zeros(
            n if opts.linear_solver in ("dense", "band") else 0, jnp.int32
        ),
        pdata=pdata,
        ls_tn=z,
        ls_cj=z,
        ls_yy=jnp.zeros(n if opts.ls_precision == "refined" else 0, dtype),
        ls_yp=jnp.zeros(n if opts.ls_precision == "refined" else 0, dtype),
        hin=z,
        hmax_inv=jnp.asarray(C.HMAX_INV_DEFAULT, dtype),
        epcon=jnp.asarray(C.EPCON, dtype),
        tstop=z,
        tstop_set=jnp.asarray(False),
        constraints=zeros_n,
        constraints_set=jnp.asarray(False),
        nst=jnp.asarray(0, jnp.int64),
        nre=jnp.asarray(0, jnp.int64),
        ncfn=jnp.asarray(0, jnp.int64),
        netf=jnp.asarray(0, jnp.int64),
        nni=jnp.asarray(0, jnp.int64),
        nsetups=jnp.asarray(0, jnp.int64),
        nje=jnp.asarray(0, jnp.int64),
        nge=jnp.asarray(0, jnp.int64),
        nli=jnp.asarray(0, jnp.int64),
        nps=jnp.asarray(0, jnp.int64),
        ncfl=jnp.asarray(0, jnp.int64),
        njtsetup=jnp.asarray(0, jnp.int64),
        njtimes=jnp.asarray(0, jnp.int64),
        tlo=z,
        thi=z,
        trout=z,
        ttol=z,
        toutc=z,
        glo=jnp.zeros(r, dtype),
        ghi=jnp.zeros(r, dtype),
        grout=jnp.zeros(r, dtype),
        iroots=jnp.zeros(r, jnp.int32),
        rootdir=jnp.zeros(r, jnp.int32),
        # C IDA semantics: roots start active; r_check1 deactivates exact
        # zeros at t0. (The reference inits these false — src/lib.rs:373 —
        # and re-activates lazily in r_check3, which can miss a root inside
        # the very first step; deviation documented, not replicated.)
        gactive=jnp.ones(r, bool),
        irfnd=jnp.asarray(False),
        taskc=jnp.asarray(0, jnp.int32),
        yQ=jnp.zeros(max(problem.nquad, 1), dtype),
        status=jnp.asarray(C.CONTINUE, jnp.int32),
    )
