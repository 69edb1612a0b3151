import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from same_tpu.models.assignment import (
    build_assignment_problem,
    matching_objective,
)
from same_tpu.solver.auction import solve_assignment
from same_tpu.solver.milp_oracle import solve_mip_oracle


def _random_instance(rng, n=30, m=35, k=5, max_matches=1, nm=50.0, radius=3.0):
    aq = rng.uniform(0, 10, (n, 2))
    rq = rng.uniform(0, 10, (m, 2))
    from same_tpu.candidates import radius_knn

    idx, dist, mask = radius_knn(aq, rq, radius=radius, k=k)
    pairs, costs = [], []
    for i in range(n):
        for j, d in zip(idx[i][mask[i]], dist[i][mask[i]]):
            pairs.append((i, int(j)))
            costs.append(float(d) + rng.uniform(0, 5))
    pairs = np.asarray(pairs)
    costs = np.asarray(costs)
    limits = np.full(m, max_matches)
    nm_cost = np.full(n, nm)
    return pairs, costs, n, m, limits, nm_cost


def _solve_both(pairs, costs, n, m, limits, nm_cost, penalty_coeff=100.0):
    problem = build_assignment_problem(
        pairs, costs, n, m, limits, penalty_coeff, nm_cost
    )
    match_ref, match_pair, info = solve_assignment(problem, eps_final=1e-3)
    matched_costs = np.zeros(n)
    sel = match_pair >= 0
    matched_costs[sel] = costs[match_pair[sel]]
    obj = matching_objective(match_ref, matched_costs, m, penalty_coeff, nm_cost)

    oracle = solve_mip_oracle(
        pairs, costs, n, m, limits, penalty_coeff, nm_cost
    )
    return obj, oracle.objective, match_ref, oracle.match_ref


def test_auction_matches_milp_simple(rng):
    pairs, costs, n, m, limits, nm_cost = _random_instance(rng)
    obj, oracle_obj, _, _ = _solve_both(pairs, costs, n, m, limits, nm_cost)
    assert obj == pytest.approx(oracle_obj, rel=1e-3, abs=0.05)


def test_auction_matches_milp_scarce_refs(rng):
    # Fewer refs than aligned: no-match and congestion both in play.
    pairs, costs, n, m, limits, nm_cost = _random_instance(
        rng, n=40, m=15, k=6, nm=20.0, radius=6.0
    )
    obj, oracle_obj, _, _ = _solve_both(pairs, costs, n, m, limits, nm_cost)
    assert obj == pytest.approx(oracle_obj, rel=1e-3, abs=0.05)


def test_auction_max_matches_two(rng):
    # max_matches=2 engages the congestion penalty (synthetic benchmark config).
    pairs, costs, n, m, limits, nm_cost = _random_instance(
        rng, n=30, m=12, k=5, max_matches=2, nm=30.0, radius=6.0
    )
    obj, oracle_obj, _, _ = _solve_both(
        pairs, costs, n, m, limits, nm_cost, penalty_coeff=10.0
    )
    assert obj == pytest.approx(oracle_obj, rel=1e-3, abs=0.05)


def test_auction_vs_hungarian_dense(rng):
    # Dense square problem with huge no-match cost reduces to pure LSA.
    n = m = 20
    cost_mat = rng.uniform(0, 10, (n, m))
    pairs = np.array([(i, j) for i in range(n) for j in range(m)])
    costs = cost_mat.ravel()
    limits = np.ones(m, dtype=int)
    nm_cost = np.full(n, 1e5)
    problem = build_assignment_problem(pairs, costs, n, m, limits, 100.0, nm_cost)
    match_ref, match_pair, _ = solve_assignment(problem, eps_final=1e-4)
    assert (match_ref >= 0).all()
    got = cost_mat[np.arange(n), match_ref].sum()
    ri, ci = linear_sum_assignment(cost_mat)
    want = cost_mat[ri, ci].sum()
    assert got == pytest.approx(want, rel=1e-3, abs=n * 1e-3)


def test_auction_all_no_match(rng):
    # No-match cheaper than any pair -> nobody matches.
    pairs = np.array([(0, 0), (1, 0)])
    costs = np.array([10.0, 12.0])
    nm_cost = np.array([1.0, 1.0])
    problem = build_assignment_problem(
        pairs, costs, 2, 1, np.array([1]), 100.0, nm_cost
    )
    match_ref, _, _ = solve_assignment(problem)
    assert (match_ref == -1).all()


def test_metacell_ref_capacity(rng):
    # One metacell ref with limit 3 takes all three aligned, paying congestion.
    pairs = np.array([(0, 0), (1, 0), (2, 0)])
    costs = np.array([1.0, 1.0, 1.0])
    nm_cost = np.full(3, 1000.0)
    problem = build_assignment_problem(
        pairs, costs, 3, 1, np.array([3]), 5.0, nm_cost
    )
    match_ref, match_pair, _ = solve_assignment(problem)
    assert (match_ref == 0).all()
    matched_costs = costs[match_pair]
    obj = matching_objective(match_ref, matched_costs, 1, 5.0, nm_cost)
    # 3 matches at 1.0 + 2 * 5.0 congestion
    assert obj == pytest.approx(13.0)


def test_auction_budget_insensitive_natural_stop(rng):
    """Round budgets are a safety net, not the stop.

    A contested instance (more bidders than slots, near-tied costs) makes
    the forward auction churn holders within the eps tolerance; before the
    objective-plateau stop, the round budget terminated such solves and the
    matching depended on the budget. Now the natural stop fires first, so
    halving or doubling the budget must leave the matching IDENTICAL, and
    the rounds actually used must sit well under the smallest budget.
    """
    n, m, k = 512, 448, 8
    aq = rng.uniform(0, 10, (n, 2))
    rq = rng.uniform(0, 10, (m, 2))
    from same_tpu.candidates import radius_knn

    idx, dist, mask = radius_knn(aq, rq, radius=4.0, k=k)
    pairs, costs = [], []
    for i in range(n):
        for j, d in zip(idx[i][mask[i]], dist[i][mask[i]]):
            pairs.append((i, int(j)))
            # Near-tied costs: contested slots with eps-scale differences.
            costs.append(1.0 + 1e-3 * float(d) + rng.uniform(0, 1e-3))
    pairs, costs = np.asarray(pairs), np.asarray(costs)
    problem = build_assignment_problem(
        pairs, costs, n, m, np.ones(m, dtype=int), 100.0, np.full(n, 50.0)
    )

    base_budget = 8192
    results = {}
    for mult in (0.5, 1.0, 2.0):
        mr, mp, info = solve_assignment(
            problem, eps_final=1e-5, max_rounds=int(base_budget * mult),
            obj_patience=128,
        )
        results[mult] = (mr, mp, info["rounds"])
    rounds_used = {m_: r for m_, (_, _, r) in results.items()}
    # The natural stop, not the budget, terminated every solve.
    assert max(rounds_used.values()) < int(base_budget * 0.5), rounds_used
    for mult in (1.0, 2.0):
        np.testing.assert_array_equal(results[0.5][0], results[mult][0])
        np.testing.assert_array_equal(results[0.5][1], results[mult][1])
    # And quality did not regress: compare against the exact oracle.
    matched_costs = np.zeros(n)
    mr, mp, _ = results[1.0]
    sel = mp >= 0
    matched_costs[sel] = costs[mp[sel]]
    obj = matching_objective(mr, matched_costs, m, 100.0, np.full(n, 50.0))
    oracle = solve_mip_oracle(
        pairs, costs, n, m, np.ones(m, dtype=int), 100.0, np.full(n, 50.0)
    )
    assert obj <= oracle.objective * 1.02 + n * 1e-5 * 2
