"""chip_smoke.py: its checks on the CPU, its refusal to run without a GPU,
and (on a machine with an NVIDIA GPU) the whole script.

The phases themselves need the card; what runs here is the arithmetic
they judge by (WRMS, the oracle lanes, the float32 residual error, the
result line) and one phase end to end at B=8."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_to_run_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_wrms_criterion():
    ref = np.array([[1.0, 1e-3, 0.0], [2.0, 1e-3, 0.0]])
    atol = np.array([1e-8, 1e-6, 1e-6])
    np.testing.assert_array_equal(cs.wrms(ref, ref, 1e-4, atol), [0.0, 0.0])
    # one error weight on every component of row 1 -> exactly 1
    y = ref + np.array([[0.0, 0.0, 0.0], [1e-4 * 2.0 + 1e-8,
                                          1e-4 * 1e-3 + 1e-6, 1e-6]])
    np.testing.assert_allclose(cs.wrms(y, ref, 1e-4, atol), [0.0, 1.0])


def test_result_line_names_the_device():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev, dev, dev, dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 4}}')


def test_oracle_lanes_spread_over_the_parameter_range():
    import bench

    params = bench.roberts_params(8)
    lanes, refs = cs.oracle_lanes(params, 0.4, n_lanes=3)
    assert lanes.tolist() == [0, 4, 7]
    assert refs.shape == (3, 3) and np.all(np.isfinite(refs))
    # conservation: y1 + y2 + y3 = 1 at every lane
    np.testing.assert_allclose(refs.sum(axis=1), 1.0, rtol=1e-12)
    # stiffer chemistry (larger k1) consumes more y1
    assert refs[0, 0] > refs[1, 0] > refs[2, 0]


def test_ensemble_phase_at_b8_on_cpu(capsys):
    """The ensemble phase end to end at B=8: both ensemble paths, every
    lane against the oracle."""
    clock = cs.CompileClock()
    assert cs.phase_ensemble("cpu test", clock, batch=8, n_oracle=8)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[ensemble] PASS")
    assert "oracle_lanes=[0, 1, 2, 3, 4, 5, 6, 7]" in line


def test_first_divergence_against_the_oracle_trace(monkeypatch):
    """The parity phase's fallback report: no step attempt differs where
    parity holds (here, on the CPU), and a perturbed oracle residual is
    caught at a named attempt and field."""
    touts = cs.DECADES[:2]
    assert cs._first_divergence(touts) is None

    roberts_np = cs.roberts_np
    monkeypatch.setattr(cs, "roberts_np",
                        lambda k: roberts_np(np.asarray(k) * 1.001))
    attempt, field, what = cs._first_divergence(touts)
    assert field in cs.STEP_FIELDS and attempt >= 0 and what


def test_foodweb_f32_residual_matches_numpy_reference():
    """The float32 foodweb residual sits within a few float32 roundings of
    the float64 numpy reference; the same measure puts a product rounded
    to a 10-bit mantissa (TF32) far outside the limit."""
    err = cs.foodweb_f32_res_error()
    assert err < cs.F32_RES_LIMIT, err

    from ida_tpu.models.foodweb import foodweb_ic, foodweb_problem

    m = cs.FOODWEB_M
    rng = np.random.default_rng(0)
    c0, _ = foodweb_ic(m, m)
    c = (c0 * (1.0 + 0.1 * rng.standard_normal(c0.shape))).astype(np.float32)
    cp = (1e3 * rng.standard_normal(c0.shape)).astype(np.float32)
    ref, scale = cs.foodweb_res_np(c, cp, m)
    # the model agrees with the reference to float64 rounding
    got64 = np.asarray(foodweb_problem(m, m).res(
        0.0, np.asarray(c, np.float64), np.asarray(cp, np.float64)))
    assert np.max(np.abs(got64 - ref) / scale) < 1e-14
    # inputs cut to TF32's mantissa: thousands of float32 epsilons
    tf32 = (c.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    cut, _ = cs.foodweb_res_np(tf32, cp, m)
    assert np.max(np.abs(cut - ref) / (np.finfo(np.float32).eps * scale)) > (
        100 * cs.F32_RES_LIMIT
    )


def test_heat2d_exact_reference_solves_the_semi_discrete_system():
    """heat2d_exact starts at u0 and satisfies u' = A u (the model's own
    residual with yp = du/dt is zero), the reference the krylov phase
    measures heat2d's global error against."""
    from ida_tpu.models.heat2d import heat2d_ic, heat2d_problem

    m = 12
    u0, _ = heat2d_ic(m)
    np.testing.assert_allclose(cs.heat2d_exact(m, 0.0), u0, atol=1e-14)
    t, dt = 0.01, 1e-6
    u = cs.heat2d_exact(m, t)
    up = (cs.heat2d_exact(m, t + dt) - cs.heat2d_exact(m, t - dt)) / (2 * dt)
    r = np.asarray(heat2d_problem(m).res(t, u, up))
    assert np.max(np.abs(r)) < 1e-6 * np.max(np.abs(up))


@pytest.fixture
def nvidia_gpu():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
        [smi, "-L"], capture_output=True
    ).returncode != 0:
        pytest.skip("needs an NVIDIA GPU: chip_smoke.py runs the solver on it")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(nvidia_gpu):
    """The whole script on the card, from a child process: this test
    process stays on the CPU (tests/conftest.py), so the child is the one
    process that opens the GPU."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=1500,
    )
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
