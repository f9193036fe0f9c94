"""The bench artifact must be CAPTURABLE by the driver (VERDICT r3 item 1).

The driver keeps only the last ~2000 bytes of combined stdout/stderr and
parses a JSON line out of that window; rounds 2 and 3 both lost their
evidence to this (overflowing single line; watchdog kill before any
print). These tests pin the two properties that make the artifact
un-losable:

  * every printed headline line is COMPACT (< 1500 bytes), and
  * the line is printed EARLY (more than once — once right after the
    headline leg, again at the end), so a later wedge cannot lose it.

Run via ``python bench.py --smoke`` (CPU, tiny batch) so this stays a
fast pure-CPU test. Reference role: the driver-facing half of
benches/dense.rs's criterion report.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def detail_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench") / "BENCH_DETAIL_test.json")


@pytest.fixture(scope="module")
def smoke_output(detail_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["IDA_BENCH_DETAIL"] = detail_path
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--smoke"],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _json_lines(stdout):
    recs = []
    for line in stdout.splitlines():
        if line.startswith("{"):
            recs.append(json.loads(line))
    return recs


def test_headline_lines_compact_and_repeated(smoke_output):
    recs = _json_lines(smoke_output)
    # printed at least twice: early (right after the headline leg) and
    # as the final line — a wedge between them cannot lose the record
    assert len(recs) >= 2
    for line in smoke_output.splitlines():
        if line.startswith("{"):
            assert len(line.encode()) < 1500, (
                f"headline line is {len(line.encode())} B; the driver tail "
                f"window is ~2000 B (BENCH_r02 overflowed it)"
            )


def test_headline_schema(smoke_output):
    recs = _json_lines(smoke_output)
    last = recs[-1]
    for key in ("metric", "value", "unit", "vs_baseline", "value_median"):
        assert key in last, key
    assert last["unit"] == "steps/sec"
    assert last["value"] > 0
    d = last["detail"]
    for key in ("total_steps", "wall_best_s", "pipeline", "ok_lanes",
                "oracle_best", "detail_file", "legs_err", "legs_skipped"):
        assert key in d, key
    # the wall/pipeline division is for accelerators; CPU must run
    # single-dispatch
    assert d["pipeline"] == 1
    # every result names the device it ran on
    assert d["device"]["platform"] == "cpu" and d["device"]["count"] >= 1
    # every smoke lane converged
    assert d["ok_lanes"] == d["lanes"]


def test_detail_file_written(smoke_output, detail_path):
    with open(detail_path) as f:
        detail = json.load(f)
    assert "headline" in detail
    assert "leg_errors" in detail and isinstance(detail["leg_errors"], dict)
    assert "legs_skipped" in detail


def test_failed_headline_exits_nonzero(tmp_path):
    """A failed headline leg is a failed run: it prints no record and
    exits 1 with the error (no CPU numbers stand in for it)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               IDA_BENCH_DETAIL=str(tmp_path / "detail.json"))
    code = (
        "import sys, bench\n"
        "def boom(*a, **k):\n"
        "    raise RuntimeError('injected headline failure')\n"
        "bench.run_ensemble = boom\n"
        "sys.argv = ['bench.py', '--smoke']\n"
        "bench.main()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env=env, cwd=REPO,
    )
    assert out.returncode == 1, out.stderr[-2000:]
    assert "injected headline failure" in out.stderr
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


# ---------------------------------------------------------------------------
# _Budget.leg retry semantics (round 4): a transient failure on the
# headline leg must be retried, recorded, and — on eventual success — moved
# to a ':recovered' key so the artifact shows both the hiccup and the save.


def _budget():
    sys.path.insert(0, REPO)
    import bench

    return bench._Budget(total_s=60.0)


def test_leg_retry_recovers_from_transient_failure():
    budget = _budget()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient runtime error")
        return "ok"

    assert budget.leg(flaky, name="headline", min_s=0.0, retries=2) == "ok"
    assert calls["n"] == 2
    assert "headline" not in budget.errors
    assert "transient runtime error" in budget.errors["headline:recovered"]


def test_leg_retry_exhaustion_records_every_attempt():
    budget = _budget()
    calls = {"n": 0}

    def always_fails():
        calls["n"] += 1
        raise RuntimeError(f"boom {calls['n']}")

    assert budget.leg(always_fails, name="leg", min_s=0.0, retries=2) is None
    assert calls["n"] == 3
    assert "boom 1" in budget.errors["leg"]
    assert "retry 2: RuntimeError: boom 3" in budget.errors["leg"]


def test_leg_no_retries_by_default():
    budget = _budget()
    calls = {"n": 0}

    def fails_once():
        calls["n"] += 1
        raise RuntimeError("once")

    assert budget.leg(fails_once, name="leg", min_s=0.0) is None
    assert calls["n"] == 1


def test_leg_timeout_never_retried():
    budget = _budget()
    calls = {"n": 0}

    def watchdog_fires():
        calls["n"] += 1
        raise TimeoutError("bench leg exceeded watchdog budget")

    assert budget.leg(watchdog_fires, name="leg", min_s=0.0, retries=5) is None
    assert calls["n"] == 1


def test_leg_wedge_timer_fires_from_thread():
    """A leg that never sees SIGALRM (blocked inside a C call) must trip
    the wedge timer THREAD, which is immune to the main thread's state."""
    import time as _time

    budget = _budget()
    budget.WEDGE_SLACK_S = 0.5  # instance override for the test
    fired = []
    budget.on_wedge = fired.append

    def signal_deaf():
        # simulate a C call that outlives its slice and never delivers
        # the watchdog exception: swallow the SIGALRM-raised TimeoutError
        end = _time.monotonic() + 3.0
        while _time.monotonic() < end:
            try:
                _time.sleep(0.05)
            except TimeoutError:
                pass
        return "finally returned"

    out = budget.leg(signal_deaf, name="headline", min_s=0.0, cap_s=1)
    assert fired == ["headline"]
    assert out == "finally returned"


def test_leg_wedge_timer_cancelled_on_normal_return():
    budget = _budget()
    budget.WEDGE_SLACK_S = 0.0
    fired = []
    budget.on_wedge = fired.append
    assert budget.leg(lambda: 42, name="quick", min_s=0.0, cap_s=1) == 42
    import time as _time

    _time.sleep(1.3)  # past slice+slack; cancelled timer must not fire
    assert fired == []
