#!/usr/bin/env python
"""Score the recovered Gurobi synthetic matching under the device solver's
exact objective (examples/recover_reference_matching.py output), giving the
precise target the tearing solver must reach.

Usage: python examples/score_reference_matching.py [--dp 10]
"""

import argparse
import sys

import numpy as np
import pandas as pd

sys.path.insert(0, __file__.rsplit("/", 2)[0])
sys.path.insert(0, __file__.rsplit("/", 1)[0])

from diagnose_synthetic import build_window, flip_report, objective_of

REC = "examples/results/reference_synthetic_matching.csv"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=float, default=10)
    args = ap.parse_args()

    pw, mc_ref, mc_align = build_window(args.dp, verbose=False)
    rec = pd.read_csv(REC)

    # Map original cell_idx -> window row indices (MS=1: each metacell's
    # ``members`` list holds exactly its original cell_idx).
    a_rows = pd.Series(
        np.arange(len(pw.aligned_df)),
        index=[m[0] for m in pw.aligned_df["members"]],
    )
    r_rows = pd.Series(
        np.arange(len(pw.ref_df)),
        index=[m[0] for m in pw.ref_df["members"]],
    )
    n = pw.problem.n_aligned
    match_ref = np.full(n, -1, np.int64)
    match_pair = np.full(n, -1, np.int64)

    # Pair lookup from valid_pairs.
    pair_of = {}
    for p, (i, j) in enumerate(np.asarray(pw.valid_pairs)):
        pair_of[(int(i), int(j))] = p

    missing = []
    for _, row in rec.iterrows():
        ai = a_rows.get(row["Aligned_cell_idx"])
        ri = r_rows.get(row["Ref_cell_idx"])
        if ai is None or ri is None:
            missing.append((row["Aligned_cell_idx"], row["Ref_cell_idx"], "row"))
            continue
        p = pair_of.get((int(ai), int(ri)))
        if p is None:
            missing.append((row["Aligned_cell_idx"], row["Ref_cell_idx"], "pair"))
            continue
        match_ref[ai] = ri
        match_pair[ai] = p
    if missing:
        print(f"WARNING: {len(missing)} matches outside candidate set: {missing[:5]}")

    flipped = flip_report(pw, match_ref, "gurobi(recovered)")
    base, mip = objective_of(pw, match_ref, match_pair, args.dp, flipped)
    print(f"  objective={mip:.3f} (assignment {base:.3f})")


if __name__ == "__main__":
    main()
