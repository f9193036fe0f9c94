"""Numerical data-trace: per-step-attempt state dumps for divergence hunting.

Behavioural spec: the reference's ``data_trace`` feature serializes the
entire ``Ida`` struct to JSON every step attempt (reference
src/lib.rs:635-639, analyzed against an instrumented C run in
scripts/data_trace.ipynb). SURVEY.md §4 calls this the tool that made
C-parity achievable; here it is a first-class debug mode.

Design: inside jit we can't write files, so the step-attempt loop
emits the trace via ``jax.debug.callback`` (ordered side effect) into a
host-side collector when ``IdaOptions.debug_trace`` is on. Works under jit;
under vmap every lane is dumped (the record carries whatever batch shape
the lanes have).
"""

from __future__ import annotations

import json
import threading
from typing import Any, Optional

import numpy as np

_lock = threading.Lock()
_collector: Optional["DataTrace"] = None

TRACE_FIELDS = (
    # the WHOLE integrator struct, mirroring the reference's derive(Serialize)
    # on Ida + its nested nonlinear/linear problem state (reference
    # src/lib.rs:50-51,635-639; ida_nls.rs:18-19; ida_ls.rs:13-14) —
    # everything except the user preconditioner workspace (pdata, an
    # arbitrary pytree outside the serializable schema) and the
    # beyond-reference quadrature accumulator (yQ — no reference field
    # to diff against)
    # --- BDF history and coefficients ---
    "phi", "psi", "alpha", "beta", "sigma", "gamma",
    # --- work vectors ---
    "ee", "yy", "yp", "yypredict", "yppredict", "ewt", "savres",
    # --- step data ---
    "tn", "hh", "hused", "rr", "h0u", "tretlast", "tolsf",
    "kk", "kused", "knew", "phase", "ns",
    # --- nonlinear-solver state ---
    "cj", "cjlast", "cjold", "cjratio", "ss", "oldnrm", "eps_newt", "toldel",
    # --- linear-solver state (dense factors; ida_ls.rs Serialize) ---
    "lu", "piv",
    # --- traced per-instance options ---
    "hin", "hmax_inv", "epcon", "tstop", "tstop_set",
    "constraints", "constraints_set",
    # --- counters ---
    "nst", "nre", "ncfn", "netf", "nni", "nsetups", "nje", "nge",
    "nli", "nps", "ncfl", "njtsetup", "njtimes",
    # --- rootfinding lanes ---
    "tlo", "thi", "trout", "ttol", "toutc",
    "glo", "ghi", "grout", "iroots", "rootdir", "gactive", "irfnd", "taskc",
    # --- outcome lane ---
    "status",
)


class DataTrace:
    """Host-side collector; use as a context manager around solve calls."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: list[dict] = []
        self._fh = None

    def __enter__(self):
        global _collector
        with _lock:
            _collector = self
        if self.path:
            self._fh = open(self.path, "w")
        return self

    def __exit__(self, *exc):
        global _collector
        with _lock:
            _collector = None
        if self._fh:
            self._fh.close()
            self._fh = None
        return False

    def emit(self, record: dict):
        rec = {
            k: (np.asarray(v).tolist() if np.asarray(v).ndim else float(np.asarray(v)))
            for k, v in record.items()
        }
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")


def trace_sink(**record: Any) -> None:
    """The jax.debug.callback target; drops records when no collector is
    active (so debug_trace=True costs little outside a DataTrace block)."""
    c = _collector
    if c is not None:
        c.emit(record)
