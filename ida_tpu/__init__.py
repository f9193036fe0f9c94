"""ida_tpu — a JAX/XLA reimplementation of SUNDIALS IDA for accelerators.

A from-scratch, accelerator-first rebuild of the DAE solver capabilities of
``jondo2010/rust-ida`` (itself a Rust port of SUNDIALS IDA): the
variable-order, variable-step, fixed-leading-coefficient BDF integrator for
implicit differential-algebraic systems ``F(t, y, y') = 0``.

Design (the reference repository is the behavioural spec, SURVEY.md the map):

* The reference's mutable ``Ida`` struct (reference ``src/lib.rs:89-244``)
  becomes an immutable :class:`ida_tpu.core.state.IdaState` pytree threaded
  through ``lax.while_loop`` state machines — fully jittable and vmappable.
* The dense Newton/LU path (reference ``crates/linear/src/dense.rs``,
  ``crates/nonlinear/src/newton.rs``) becomes batched, branchless JAX;
  large ensembles of small systems factor in lockstep.
* Rust ``Result`` control flow becomes integer status lanes so thousands of
  independent DAE instances integrate in lockstep on one device.

Double precision is required for numerical parity with the reference; we
enable the x64 flag at import (opt out with ``IDA_TPU_NO_X64=1``).
"""

import os

import jax

if not os.environ.get("IDA_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

from . import constants  # noqa: E402
from .norms import wrms_norm, wrms_norm_masked  # noqa: E402
from .tol_control import TolControl, tol_ss, tol_sv  # noqa: E402
from .problem import IdaProblem  # noqa: E402
from .core.state import IdaOptions  # noqa: E402
from .solver import IDA, IdaTask, IdaSolveStatus, IdaError  # noqa: E402
from .api import solve_dae, DAESolution  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "constants",
    "wrms_norm",
    "wrms_norm_masked",
    "TolControl",
    "tol_ss",
    "tol_sv",
    "IdaProblem",
    "IdaOptions",
    "IDA",
    "IdaTask",
    "IdaSolveStatus",
    "IdaError",
    "solve_dae",
    "DAESolution",
]
