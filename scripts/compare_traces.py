"""Diff two ida_tpu data-trace JSONL files field-by-field, per step attempt.

Parity tool for the reference's ``scripts/data_trace.ipynb`` (which
np.allclose-diffs a Rust trace against an instrumented C SUNDIALS trace,
SURVEY.md §4.3b). Use it to localize the first diverging step attempt
between two runs (e.g. dense vs spgmr, f64 vs f32, this build vs a fixture
trace):

    python scripts/compare_traces.py a.jsonl b.jsonl --atol 1e-12
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def divergences(a, b, atol=1e-12, rtol=1e-10, fields=None):
    """Yield ``(attempt, field, what)`` for every field of every step
    attempt on which two traces disagree, in attempt order; ``fields``
    restricts the comparison to those names."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        keys = set(ra) & set(rb)
        if fields is not None:
            keys &= set(fields)
        for key in sorted(keys):
            va, vb = np.asarray(ra[key], float), np.asarray(rb[key], float)
            if va.shape != vb.shape:
                yield i, key, f"shape {va.shape} vs {vb.shape}"
            elif not np.allclose(va, vb, atol=atol, rtol=rtol, equal_nan=True):
                yield i, key, f"max |diff| = {np.max(np.abs(va - vb)):.6e}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_a")
    ap.add_argument("trace_b")
    ap.add_argument("--atol", type=float, default=1e-12)
    ap.add_argument("--rtol", type=float, default=1e-10)
    ap.add_argument("--max-report", type=int, default=10)
    args = ap.parse_args()

    a = load(args.trace_a)
    b = load(args.trace_b)
    n = min(len(a), len(b))
    if len(a) != len(b):
        print(f"note: different attempt counts: {len(a)} vs {len(b)}; comparing first {n}")

    bad = 0
    for i, key, what in divergences(a, b, args.atol, args.rtol):
        print(f"attempt {i}: {key}: {what}")
        bad += 1
        if bad >= args.max_report:
            print("... (truncated; first divergence localized above)")
            return 1
    if bad:
        return 1
    print(f"traces agree on {n} attempts (atol={args.atol}, rtol={args.rtol})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
