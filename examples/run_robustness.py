#!/usr/bin/env python
"""Cell-type probability noise robustness sweep.

Equivalent of the reference's examples/heart/run_robustness.sh: inject
Dirichlet mixture noise into the query's type-probability columns at
increasing levels and measure matching accuracy degradation (the reference
reports 71.6% -> 54.9% over eta in [0, 1] on the ISS heart data).

By default runs on the synthetic 4-quadrant benchmark (self-contained);
pass --data DIR with heart CSVs to reproduce the paper sweep.

Usage: python examples/run_robustness.py [--noise 0 0.25 0.5 0.75 1.0] [--seed 2026]
"""

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def run_heart_sweep(args):
    """Real ISS-heart Dirichlet noise sweep (reference
    examples/heart/run_robustness.sh: dp=10, knn=8, MS=1, seed 2026; Fig S5
    reports accuracy 71.6% -> 54.9% over eta in [0, 1])."""
    import pandas as pd

    from run_dataset import load_heart
    from same_tpu import (
        add_dirichlet_mixture_noise,
        check_alignment,
        greedy_triangle_collapse,
        sliding_window_matching,
    )

    ref, align, common, cfg = load_heart(args.data)
    mc_ref = greedy_triangle_collapse(
        ref, cell_type_col="cell_type", original_idx_col=cfg["id_col"],
        x_col="X", y_col="Y", max_metacell_size=1, r_max=cfg["r_max"],
        min_angle_deg=15, use_alpha_shape=False, return_object=True,
        verbose=False,
    )
    ref_eval = mc_ref.metacell_df.copy()
    ref_eval["cell_type"] = ref_eval[common].idxmax(axis=1)
    ref_eval["SAME_X"] = ref_eval["X"]
    ref_eval["SAME_Y"] = ref_eval["Y"]

    results = []
    for eta in args.noise:
        rng = np.random.default_rng(args.seed)
        noisy = add_dirichlet_mixture_noise(
            align, common, eta, target_sum=100.0, rng=rng, inplace=False
        )
        noisy["cell_type_noise"] = noisy[common].idxmax(axis=1)
        mc_align = greedy_triangle_collapse(
            noisy, cell_type_col="cell_type", original_idx_col=cfg["id_col"],
            x_col="X", y_col="Y", max_metacell_size=1, r_max=cfg["r_max"],
            min_angle_deg=15, use_alpha_shape=False, return_object=True,
            verbose=False,
        )
        import time as _time

        t0 = _time.time()
        matches = sliding_window_matching(
            mc_ref, mc_align,
            optim_params=dict(
                window_size=cfg["window_size"], overlap=cfg["overlap"],
                min_cells_per_window=30, max_matches=1, radius=cfg["radius"],
                knn=args.knn, no_match_penalty=10000, penalty_coeff=100,
                dist_ct_coeff=1, delaunay_penalty=args.dp,
                cell_id_col="metacell_id", ref_metacell_match_multiplier=1,
            ),
            solver_params=dict(mip_gap=0.05, lazy_allowed_flip_fraction=0.05),
            verbose=False,
        )
        minutes = (_time.time() - t0) / 60
        # Accuracy vs ORIGINAL (pre-noise) labels, 1-NN at matched ref
        # positions (reference reproduce_figures.ipynb cell 13).
        m = matches.copy()
        m["cell_type"] = mc_align.metacell_df.loc[
            m["Aligned_metacell_id"], "cell_type"
        ].values
        m["cell_type_noise"] = mc_align.metacell_df.loc[
            m["Aligned_metacell_id"], "cell_type_noise"
        ].values if eta > 0 else m["cell_type"]
        m["SAME_X"] = m["ref_X"]
        m["SAME_Y"] = m["ref_Y"]
        eval_df, _ = check_alignment(
            m, ref_eval, xcol="SAME_X", ycol="SAME_Y",
            ctype_col="cell_type", kNN=1,
        )
        acc = 100 * eval_df["_1NN_match"].sum() / len(eval_df)
        flip = 100 * (
            (eval_df["cell_type_noise"] != eval_df["cell_type"]).sum()
            / len(eval_df)
        )
        row = {
            "noise": eta,
            "matches": int(len(matches)),
            "accuracy_pct": round(float(acc), 2),
            "label_change_pct": round(float(flip), 2),
            "minutes": round(minutes, 2),
        }
        results.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--noise", type=float, nargs="+",
                    default=[0.0, 0.25, 0.5, 0.75, 1.0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--dp", type=float, default=10.0)
    ap.add_argument("--knn", type=int, default=8)
    ap.add_argument("--data", default=None,
                    help="heart data dir -> run the real paper sweep")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    from same_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.data:
        run_heart_sweep(args)
        return

    from same_tpu import (
        add_dirichlet_mixture_noise,
        create_full_benchmark,
        run_same,
    )

    ref_df, query_df, _q, _gt, _e = create_full_benchmark(seed=8899)
    common = ["c1", "c2", "c3"]
    ref_in = ref_df.copy()
    ref_in["metacell_id"] = np.arange(len(ref_in))

    results = []
    for eta in args.noise:
        rng = np.random.default_rng(args.seed)
        noisy = add_dirichlet_mixture_noise(
            query_df, common, eta, target_sum=100.0, rng=rng, inplace=False
        )
        noisy["metacell_id"] = np.arange(len(noisy))
        matches, _v = run_same(
            ref_df=ref_in,
            aligned_df=noisy,
            commonCT=common,
            optim_params=dict(
                max_matches=2, radius=5, knn=8, no_match_penalty=10000,
                dist_ct_coeff=1, min_angle_deg=5, penalty_coeff=100,
                delaunay_penalty=args.dp, cell_id_col="metacell_id",
                ignore_same_type_triangles=False,
            ),
            solver_params=dict(mip_gap=0.025, lazy_allowed_flip_fraction=0.0),
            verbose=False,
        )
        # Accuracy against the TRUE (un-noised) cell types.
        acc = (
            query_df["cell_type"].to_numpy()[matches["Aligned_metacell_id"]]
            == ref_df["cell_type"].to_numpy()[matches["Ref_metacell_id"]]
        ).mean()
        row = {
            "noise": eta,
            "matches": int(len(matches)),
            "accuracy": round(float(acc), 4),
            "run_time_s": round(float(matches["run_time"].iloc[0]), 1),
        }
        results.append(row)
        print(json.dumps(row))

    accs = [r["accuracy"] for r in results]
    print(json.dumps({"sweep": args.noise, "accuracies": accs}))


if __name__ == "__main__":
    main()
