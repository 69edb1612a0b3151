"""chip_smoke.py: refuses to run without a GPU; its checks on CPU at small size."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_exits_nonzero_without_gpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":  # a directory holding only the script
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_knn_phase_small():
    facts = chip_smoke.phase_knn(n=2000, extent=5000.0)
    assert facts["max_dist_rel_err"] <= 1e-5


def test_knn_mismatch_rule():
    import numpy as np

    ih = np.array([[0, 1, 2]])
    it = np.array([[0, 2, 3]])
    m = np.ones((1, 3), bool)
    dh = np.array([[1.0, 2.0, 3.0]])
    # position 1: a tie within 1e-3; position 2: a real miss
    dt = np.array([[1.0, 2.0005, 3.5]])
    bad = chip_smoke.knn_mismatches(ih, dh, m, it, dt, m, radius=10.0)
    assert bad.tolist() == [[False, False, True]]
    # one-sided entry at the radius edge is excused, elsewhere it is not
    edge = chip_smoke.knn_mismatches(
        np.array([[5]]), np.array([[9.9995]]), np.array([[True]]),
        np.array([[-1]]), np.array([[np.inf]]), np.array([[False]]), 10.0,
    )
    assert not edge.any()


def test_solve_phase_matches_highs_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "PLATFORM", "cpu")
    facts = chip_smoke.phase_solve()
    assert facts["highs_paying_triangles"] >= 1
    assert facts["default_rel_gap"] <= chip_smoke.MIP_GAP
    assert facts["sinkhorn_rel_gap"] <= chip_smoke.MIP_GAP
