"""The synthetic generator's RBF kernel and its seed-8899 output.

``synthetic._rbf_kernel`` replaced scikit-learn's ``RBF`` kernel; the paper
data regenerates only if every GP draw sees the same covariance bits.
"""

import hashlib

import numpy as np
import pytest

from same_tpu.synthetic import _rbf_kernel, create_full_benchmark


def test_rbf_kernel_bitwise_equals_sklearn():
    kernels = pytest.importorskip("sklearn.gaussian_process.kernels")
    pts = np.random.default_rng(8899).uniform(1, 6, (100, 2))
    for ls in (1.5, 2.5):
        expect = kernels.RBF(length_scale=ls)(pts)
        assert np.array_equal(_rbf_kernel(pts, ls), expect)


# sha256 of DataFrame.to_csv() for (ref_df, query_df, ground_truth,
# expression['ref'], expression['query']), recorded with scikit-learn's RBF.
_SEED_8899_CSV_SHA256 = (
    "55902abc11b38c80d9f91b61cc2d749bbd18c957590d5e775966c8f6348e2b41",
    "6940643e0b2cb2e12147480534e32a402e2998f0ec09cdf598d9ad07d9f2bdee",
    "1360b75e4de1d04515ddb53488a7490ebde8817714b09f8943c7f54576b680a5",
    "4b8b432535e57002cecca3758d32cd55fd471dac4e47c7b331a60391b2ed26f4",
    "1bab7072a7c4ade8c49327c9d335672dd88ae44425b1d32d39fddf94a64f523a",
)


def test_seed_8899_output_bit_identical():
    ref_df, query_df, _quadrants, gt, expr = create_full_benchmark(seed=8899)
    frames = (ref_df, query_df, gt, expr["ref"], expr["query"])
    got = tuple(hashlib.sha256(f.to_csv().encode()).hexdigest() for f in frames)
    assert got == _SEED_8899_CSV_SHA256
