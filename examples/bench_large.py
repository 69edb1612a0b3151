#!/usr/bin/env python
"""LUAD33-scale benchmark: ~100k+~94k cells, MS=3 metacells, windowed solve.

Mirrors the reference's headline scale case (examples/luad/run_same.sh:
window=13000, overlap=250, radius=250, knn=8, MS=3, dp sweep). The reference
reports total Gurobi solve times of 0.5 / 1.8 / 608.9 minutes at
dp=0 / 10 / 50 (BASELINE.md, Fig S18). Synthetic LUAD-like tissue is used
(5 spatially coherent cell types over a 26k x 26k extent) since the Zenodo
data is not bundled.

Usage: python examples/bench_large.py [--dp 10] [--cells 100000]
Prints one JSON line per run.
"""

import argparse
import json
import sys
import time

import numpy as np
import pandas as pd

sys.path.insert(0, __file__.rsplit("/", 2)[0])

LUAD_BASELINE_MIN = {0: 0.5, 1: 0.6, 5: 0.7, 10: 1.8, 25: 249.9, 50: 608.9}


def make_tissue(n_cells, extent, n_types=5, seed=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, (n_cells, 2))
    centers = rng.uniform(0, extent, (n_types * 12, 2))
    center_type = rng.integers(0, n_types, len(centers))
    # Blobby spatially coherent regions (argmin distance to type centers).
    d = ((xy[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    types = center_type[np.argmin(d, axis=1)]
    names = ["B cell", "Epithelial", "Mesenchymal", "Myeloid", "T cell"]
    probs = np.full((n_cells, n_types), 2.0)
    probs[np.arange(n_cells), types] = 86.0
    probs += rng.uniform(0, 2, probs.shape)
    probs = probs / probs.sum(1, keepdims=True) * 100.0

    def frame(jseed, keep_frac=1.0):
        r = np.random.default_rng(jseed)
        keep = r.random(n_cells) < keep_frac
        df = pd.DataFrame(
            xy[keep] + r.normal(0, 15.0, (int(keep.sum()), 2)),
            columns=["X", "Y"],
        )
        df["cell_type"] = np.asarray(names)[types[keep]]
        for k, nm in enumerate(names):
            df[nm] = probs[keep, k]
        df["Cell_Num_Old"] = np.arange(len(df))
        return df

    return frame(1), frame(2, keep_frac=0.94), names


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=float, default=10)
    ap.add_argument("--cells", type=int, default=100000)
    ap.add_argument("--extent", type=float, default=26000)
    ap.add_argument("--ms", type=int, default=3)
    ap.add_argument("--window", type=int, default=13000)
    ap.add_argument("--mesh", type=int, default=None)
    args = ap.parse_args()
    from same_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from same_tpu import greedy_triangle_collapse, sliding_window_matching

    t0 = time.time()
    ref_df, qry_df, names = make_tissue(args.cells, args.extent)
    print(f"tissue: ref={len(ref_df)} query={len(qry_df)}", file=sys.stderr)

    mc_align = greedy_triangle_collapse(
        qry_df, original_idx_col="Cell_Num_Old", max_metacell_size=args.ms,
        r_max=250, min_angle_deg=15, return_object=True, verbose=False,
    )
    mc_ref = greedy_triangle_collapse(
        ref_df, original_idx_col="Cell_Num_Old", max_metacell_size=args.ms,
        r_max=250, min_angle_deg=15, return_object=True, verbose=False,
    )
    prep = time.time() - t0
    print(
        f"metacells: {len(mc_align.metacell_df)} / {len(mc_ref.metacell_df)} "
        f"({prep:.0f}s prep)", file=sys.stderr,
    )

    mesh = None
    if args.mesh:
        from same_tpu.parallel import make_mesh

        mesh = make_mesh(args.mesh)
    t1 = time.time()
    matches = sliding_window_matching(
        mc_ref, mc_align,
        optim_params=dict(
            window_size=args.window, overlap=250, min_cells_per_window=30,
            max_matches=1, radius=250, knn=8, no_match_penalty=10000,
            dist_ct_coeff=1, penalty_coeff=100, delaunay_penalty=args.dp,
            cell_id_col="metacell_id", ref_metacell_match_multiplier=args.ms,
        ),
        solver_params=dict(mip_gap=0.05, lazy_allowed_flip_fraction=0.05),
        mesh=mesh,
        verbose=False,
    )
    solve_min = (time.time() - t1) / 60.0
    baseline = LUAD_BASELINE_MIN.get(int(args.dp))
    print(
        json.dumps(
            {
                "metric": f"LUAD-scale windowed solve, dp={args.dp}, MS={args.ms}",
                "cells": args.cells,
                "matches": int(len(matches)),
                "violation_frac": round(
                    float(matches["triangle_violation"].mean()), 4
                ),
                "value": round(solve_min, 2),
                "unit": "min",
                "vs_baseline": round(baseline / solve_min, 2) if baseline else None,
            }
        )
    )


if __name__ == "__main__":
    main()
