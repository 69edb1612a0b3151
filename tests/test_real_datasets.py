"""Parity regression on the REAL paper datasets (slow; needs local data).

Pins the round-3 measured quality against the published numbers
(BASELINE.md):

  synthetic dp=10: 372/372 matched, 100% cell-type accuracy, violation
  nodes comparable to the published 46(+2);
  heart dp=10/knn8/MS1: 3162 matched, ~71.6% 1-NN accuracy, ~5% violations
  (run separately — ~10 min per run on this box, see
  examples/run_dataset.py and examples/results/*.json for recorded runs).

Only the synthetic dataset is asserted here to keep the suite's slow lane
bounded; heart/tongue parity is recorded by examples/run_dataset.py into
examples/results/ (committed) and checked by the driver's benches.
"""

import os
import sys

import numpy as np
import pytest

DATA = "/root/reference/examples/synthetic/data"

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        not os.path.exists(f"{DATA}/ref.csv"),
        reason="paper dataset not available locally",
    ),
]


def test_synthetic_paper_config_parity():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    import pandas as pd

    from run_dataset import evaluate_synthetic
    from same_tpu import greedy_triangle_collapse, sliding_window_matching

    ref = pd.read_csv(f"{DATA}/ref.csv", index_col=0)
    align = pd.read_csv(f"{DATA}/query.csv", index_col=0)

    mcs = {}
    for key, df in (("align", align), ("ref", ref)):
        mcs[key] = greedy_triangle_collapse(
            df, cell_type_col="cell_type", original_idx_col="cell_idx",
            x_col="X", y_col="Y", max_metacell_size=1, r_max=5,
            min_angle_deg=5, use_alpha_shape=False, return_object=True,
            verbose=False,
        )

    matches = sliding_window_matching(
        mcs["ref"], mcs["align"],
        optim_params=dict(
            window_size=100, overlap=0, min_cells_per_window=30,
            max_matches=2, radius=5, knn=8, no_match_penalty=10000,
            dist_ct_coeff=1, penalty_coeff=100, delaunay_penalty=10,
            cell_id_col="metacell_id", ref_metacell_match_multiplier=1,
            min_angle_deg=5, ignore_same_type_triangles=False,
        ),
        solver_params=dict(mip_gap=0.025, lazy_allowed_flip_fraction=0.0),
        verbose=False,
    )
    result = evaluate_synthetic(matches, mcs["ref"], mcs["align"])
    # Published (docs/tutorials/synthetic_benchmark.html): 372 matches,
    # 100.0% accuracy, 46(+2) violation nodes; the recovered Gurobi
    # solution (examples/recover_reference_matching.py) scores 12623.16
    # with 48 nodes under our objective. Idle-box measurements of this
    # exact config span 54-73 violation nodes / 12713-12997 objective
    # depending on device count and call path (1-dev direct 54; 1-dev
    # windowed 64; 8-dev windowed 73; accelerator 64) — search-trajectory
    # noise within ~1% of objective, i.e. well inside the 2.5% mip_gap both
    # solvers run at. Assert the band ceiling. NOTE: the wall-clock-budgeted HiGHS repair
    # degrades under host contention (a loaded 1-core box measures ~115)
    # — run this test on an otherwise idle machine.
    assert result["matches"] == 372
    assert result["ct_accuracy_pct"] >= 98.0
    assert result["violation_nodes"] <= 80


HEART_DATA = "/root/reference/examples/heart/data"
TONGUE_DATA = "/root/reference/examples/tongue/data"


def _run_dataset(dataset, data_dir):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    from run_dataset import run_and_evaluate

    return run_and_evaluate(
        dataset, data_dir, dp=10, knn=8, ms=1, return_artifacts=True
    )


def _objective_dominance(art, rec_csv):
    """Our exact objective vs the cheapest published-consistent solution.

    Round 4 recovered the published Gurobi heart/tongue alignments from the
    reference figures (examples/recover_published_alignment.py, committed
    CSVs) and showed our solutions score better under the reference's own
    exact objective. This turns that analysis into a regression gate.
    The committed machinery takes the MOST FAVORABLE
    interpretation of the figure — the per-type min-cost assignment onto
    exactly the recovered ref cells (its flip count reproduces the
    published solution's: 582 vs the 579 recovered in round 4). Our
    solves dominate even that best case (measured round 5: heart
    302,584 vs 305,814; tongue 10,897,911 vs 11,071,763).
    Returns (ours, published).
    """
    from run_dataset import (
        exact_window_objective,
        matching_from_matches_df,
        prepare_paper_window,
        published_consistent_matching,
    )

    # Heart/tongue are single-window solves; the full-extent window IS the
    # solved problem, so both matchings score on the same candidate graph.
    assert art["matches"]["window_id"].nunique() == 1
    pw = prepare_paper_window(
        art["mc_ref"], art["mc_align"], art["common"], art["cfg"],
        dp=art["dp"], knn=art["knn"], ms=art["ms"],
    )
    mr, mp, dropped = matching_from_matches_df(pw, art["matches"])
    assert dropped == 0, f"{dropped} of our matches outside the window graph"
    ours = exact_window_objective(pw, mr, mp)
    mr_p, mp_p, unmapped = published_consistent_matching(
        pw, rec_csv, art["ref"], art["cfg"]["id_col"]
    )
    # The recovery pins >99% of published matches onto candidate pairs;
    # a handful outside the graph fall to no-match (favoring neither side
    # materially).
    assert unmapped <= 25, f"{unmapped} published matches unmappable"
    published = exact_window_objective(pw, mr_p, mp_p)
    return ours, published


@pytest.mark.skipif(
    not os.path.exists(f"{HEART_DATA}/refAD_valis.csv"),
    reason="heart dataset not available locally",
)
def test_heart_paper_config_parity():
    """Gate the heart dp=10/knn8/MS1 quality triple.

    Published (docs/tutorials/heart_benchmark.html cell 21): 3162 matches,
    71.6% 1-NN accuracy, 5.0% same-type-skipped triangle violations.
    Committed round measurements: examples/results/heart_dp10_knn8_MS1.json
    (71.13% / 3.88%). The repair stage is wall-clock budgeted, so run on an
    idle box; the ceilings leave headroom for budget-induced jitter.
    """
    result, art = _run_dataset("heart", HEART_DATA)
    assert result["matches"] == 3162
    assert result["ct_accuracy_pct"] >= 71.0
    assert result["triangle_violations_pct"] <= 5.5
    ours, published = _objective_dominance(
        art,
        os.path.join(
            os.path.dirname(__file__), "..",
            "examples/results/reference_heart_fig3_matches.csv",
        ),
    )
    # Measured (round 5, idle box): ours 302,584 vs published 305,814 —
    # strict dominance with a 1.1% margin. The repair phase is wall-clock
    # budgeted, so a loaded box can eat the margin; run idle.
    print(f"heart exact objective: ours {ours:.0f} vs published {published:.0f}")
    assert ours <= published


@pytest.mark.skipif(
    not os.path.exists(f"{TONGUE_DATA}/mer_df.csv"),
    reason="tongue dataset not available locally",
)
def test_tongue_paper_config_parity():
    """Gate the tongue dp=10/knn8/MS1 quality triple.

    Published (docs/tutorials/tongue_benchmark.html cell 11): 3579 matches,
    84.2% 1-NN accuracy, 18.0% all-type triangle violations. Committed:
    examples/results/tongue_dp10_knn8_MS1.json (3596 / 83.59% / 12.72%).
    """
    result, art = _run_dataset("tongue", TONGUE_DATA)
    assert result["matches"] >= 3579
    assert result["ct_accuracy_pct"] >= 83.4
    assert result["triangle_violations_pct"] <= 18.0
    ours, published = _objective_dominance(
        art,
        os.path.join(
            os.path.dirname(__file__), "..",
            "examples/results/reference_tongue_fig4_matches.csv",
        ),
    )
    # Measured (round 5, idle box): ours 10,897,911 vs published
    # 11,071,763 — strict dominance with a 1.6% margin.
    print(f"tongue exact objective: ours {ours:.0f} vs published {published:.0f}")
    assert ours <= published
