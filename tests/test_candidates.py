import numpy as np
import pandas as pd
import pytest

from same_tpu.candidates import (
    find_knn_with_cell_type_priority,
    find_knn_within_radius,
    radius_knn,
)


def _frames(rng, n=40, m=50):
    a = pd.DataFrame(
        {
            "X": rng.uniform(0, 10, n),
            "Y": rng.uniform(0, 10, n),
            "cell_type": rng.choice(["a", "b"], n),
        }
    )
    r = pd.DataFrame(
        {
            "X": rng.uniform(0, 10, m),
            "Y": rng.uniform(0, 10, m),
            "cell_type": rng.choice(["a", "b"], m),
        }
    )
    return a, r


def _brute_force(aq, rq, radius, k):
    out = []
    for i in range(len(aq)):
        d = np.linalg.norm(rq - aq[i], axis=1)
        js = np.flatnonzero(d <= radius)
        js = js[np.lexsort((js, d[js]))][:k]
        out.append(js.tolist())
    return out


def test_radius_knn_matches_bruteforce(rng):
    aq = rng.uniform(0, 10, (40, 2))
    rq = rng.uniform(0, 10, (60, 2))
    idx, dist, mask = radius_knn(aq, rq, radius=2.0, k=5, backend="host")
    expect = _brute_force(aq, rq, 2.0, 5)
    for i in range(40):
        got = idx[i][mask[i]].tolist()
        assert got == expect[i]
        assert np.all(np.diff(dist[i][mask[i]]) >= 0)


@pytest.mark.parametrize("offset", [0.0, 13_000.0])
def test_radius_knn_tpu_backend_matches_host(rng, offset):
    # offset 13000 puts the points at tissue-scale coordinates, where float32
    # distance formulas that cancel (|q|^2 + |r|^2 - 2 q.r) lose 1e-4 and more.
    aq = rng.uniform(0, 10, (37, 2)) + offset
    rq = rng.uniform(0, 10, (53, 2)) + offset
    ih, dh, mh = radius_knn(aq, rq, radius=2.5, k=4, backend="host")
    it, dt, mt = radius_knn(aq, rq, radius=2.5, k=4, backend="tpu")
    assert (mh == mt).all()
    np.testing.assert_allclose(dt[mh], dh[mh], rtol=1e-5)
    # Allow index differences only where distances tie within float32 noise.
    diff = (ih != it) & mh
    if diff.any():
        assert np.allclose(dh[diff], dt[diff], atol=1e-3)


def test_find_knn_within_radius_reindexes(rng):
    a, r = _frames(rng)
    # Put one aligned point far away so it gets dropped.
    a.loc[0, ["X", "Y"]] = [1000.0, 1000.0]
    na, nr, pairs = find_knn_within_radius(a, r, radius=2.0, knn=4)
    assert len(na) < len(a)
    assert pairs[:, 0].max() < len(na)
    assert pairs[:, 1].max() < len(nr)
    # Every returned row participates in at least one pair.
    assert set(pairs[:, 0].tolist()) == set(range(len(na)))
    assert set(pairs[:, 1].tolist()) == set(range(len(nr)))
    # Pairs are grouped by aligned index in ascending order.
    assert (np.diff(pairs[:, 0]) >= 0).all()


def test_cell_type_priority(rng):
    a = pd.DataFrame(
        {
            "X": [0.0, 5.0],
            "Y": [0.0, 0.0],
            "cell_type": ["a", "b"],
        }
    )
    r = pd.DataFrame(
        {
            "X": [0.1, 0.5, 5.1, 5.5],
            "Y": [0.0, 0.0, 0.0, 0.0],
            "cell_type": ["a", "a", "a", "b"],
        }
    )
    na, nr, pairs = find_knn_with_cell_type_priority(a, r, radius=2.0, knn=3)
    pairs = [tuple(p) for p in np.asarray(pairs)]
    # Aligned 0: closest ref shares type 'a' and unclaimed -> single pair.
    assert pairs.count((0, 0)) == 1
    assert sum(1 for p in pairs if p[0] == 0) == 1
    # Aligned 1: closest ref (2) is type 'a' != 'b' -> keeps all pairs.
    assert sum(1 for p in pairs if p[0] == 1) == 2


def test_no_candidates_empty():
    a = pd.DataFrame({"X": [0.0], "Y": [0.0], "cell_type": ["a"]})
    r = pd.DataFrame({"X": [100.0], "Y": [100.0], "cell_type": ["a"]})
    na, nr, pairs = find_knn_within_radius(a, r, radius=1.0, knn=3)
    assert len(na) == 0 and len(nr) == 0 and len(pairs) == 0
