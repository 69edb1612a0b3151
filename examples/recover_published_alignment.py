#!/usr/bin/env python
"""Recover the published SAME alignments' (matched-ref, query-type) pairs
from the committed reference figures.

The reference repo ships no heart/tongue ``matchedDF.csv``, but its
alignment figures scatter, per query cell type, every matched query cell at
its SAME position — the exact coordinates of the matched REF cell:

- heart : ``examples/heart/figures/Fig3_spatial_alignment.svg`` panel b
  (reference heart/reproduce_figures.ipynb cell 22) — 3162 matches of the
  published dp=10/knn=8/MS=1 Gurobi run.
- tongue: ``examples/tongue/figures/Fig4_spatial_alignment.svg`` panel b
  (reference tongue/reproduce_figures.ipynb cell 13) — 3579 matches.

Because the ref CSV is known, the per-axes affine data->figure transform is
recoverable: panel a (the ref scatter) pins it directly for its axes; panel
b lives in a second axes, so a RANSAC over extreme-point correspondences
finds the transform under which EVERY plotted point snaps exactly onto a
ref cell. The result: for each match in the published solution, WHICH ref
cell was used and the TYPE of the query cell matched to it — which fully
determines the published 1-NN accuracy metric (reproduced exactly for both
datasets), giving a concrete target for the quality-parity analysis in
docs/benchmarks.md. The per-query-cell assignment is not in the figures, so
triangle violations are not recoverable — accuracy is.

Usage: python examples/recover_published_alignment.py heart|tongue [--out CSV]
"""

import argparse
import re
import sys

import numpy as np
import pandas as pd

sys.path.insert(0, __file__.rsplit("/", 2)[0])
sys.path.insert(0, __file__.rsplit("/", 1)[0])

from run_dataset import load_heart, load_tongue  # noqa: E402

DATASETS = {
    "heart": dict(
        svg="/root/reference/examples/heart/figures/Fig3_spatial_alignment.svg",
        data="/root/reference/examples/heart/data",
        loader=load_heart,
        published_acc=71.6,
    ),
    "tongue": dict(
        svg="/root/reference/examples/tongue/figures/Fig4_spatial_alignment.svg",
        data="/root/reference/examples/tongue/data",
        loader=load_tongue,
        published_acc=84.15,
    ),
}


def parse_collections(text):
    """[(group_id, [(x, y), ...])] for every PathCollection, in order."""
    out = []
    for m in re.finditer(r'<g id="(PathCollection_\d+)">', text):
        start = m.end()
        nxt = text.find('<g id="PathCollection_', start)
        blk = text[start: nxt if nxt > 0 else len(text)]
        pts = np.array(
            re.findall(r'<use xlink:href="[^"]*" x="([-\d.e]+)" y="([-\d.e]+)"', blk),
            dtype=float,
        ).reshape(-1, 2)
        out.append((m.group(1), pts))
    return out


def fit_panel_a(cols, ref, types):
    """Affine fit of the first axes from the known ref scatter."""
    k = len(types)
    ref_fig = np.concatenate([pts for _, pts in cols[0:k]])
    ref_data = np.concatenate(
        [ref.loc[ref["cell_type"] == t, ["X", "Y"]].to_numpy() for t in types]
    )
    assert len(ref_fig) == len(ref_data), (len(ref_fig), len(ref_data))
    ax = np.polyfit(ref_data[:, 0], ref_fig[:, 0], 1)
    ay = np.polyfit(ref_data[:, 1], ref_fig[:, 1], 1)
    resid = np.hypot(
        np.polyval(ax, ref_data[:, 0]) - ref_fig[:, 0],
        np.polyval(ay, ref_data[:, 1]) - ref_fig[:, 1],
    )
    print(f"panel-a affine residual: max {resid.max():.4f} px")
    assert resid.max() < 0.5, "panel-a transform fit failed"


def recover_panel_b(cols, ref, types):
    """RANSAC panel b's transform; return (query_type, ref_row, snap_dist)."""
    from scipy.spatial import cKDTree

    k = len(types)
    ref_xy = ref[["X", "Y"]].to_numpy()
    tree = cKDTree(ref_xy)
    panel_b = cols[k: 2 * k]
    fig_b = np.concatenate([pts for _, pts in panel_b])
    # Equal aspect => one scale; the extreme plotted points correspond to
    # matched refs near the data extremes. RANSAC over candidate
    # (leftmost, rightmost, topmost) ref assignments, scoring 2D inlier
    # snaps — the true transform snaps EVERY point to a ref exactly.
    figL, figR = fig_b[:, 0].min(), fig_b[:, 0].max()
    figT = fig_b[:, 1].min()
    xs = np.sort(np.unique(ref_xy[:, 0]))
    ys = np.sort(np.unique(ref_xy[:, 1]))
    best = None
    for xL in xs[:40]:
        for xR in xs[-40:]:
            s = (figR - figL) / (xR - xL)
            bxo = figL - s * xL
            for yT in ys[:40]:
                byo = figT - s * yT
                d, _ = tree.query(
                    np.c_[(fig_b[:, 0] - bxo) / s, (fig_b[:, 1] - byo) / s]
                )
                inl = int((d < 1.0).sum())
                if best is None or inl > best[0]:
                    best = (inl, s, bxo, byo)
    inl, s, bxo, byo = best
    print(f"panel-b RANSAC: {inl}/{len(fig_b)} exact snaps, scale {s:.6f}")
    assert inl == len(fig_b), "panel-b transform not exact"
    d, idx = tree.query(
        np.c_[(fig_b[:, 0] - bxo) / s, (fig_b[:, 1] - byo) / s]
    )
    rows = []
    off = 0
    for t, (_, pts) in zip(types, panel_b):
        for j in range(len(pts)):
            rows.append((t, int(idx[off + j]), float(d[off + j])))
        off += len(pts)
    return pd.DataFrame(rows, columns=["query_type", "ref_row", "snap_dist"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=sorted(DATASETS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cfg = DATASETS[args.dataset]

    ref, _align, types, _ = cfg["loader"](cfg["data"])
    cols = parse_collections(open(cfg["svg"]).read())
    fit_panel_a(cols, ref, types)
    rec = recover_panel_b(cols, ref, types)
    print(f"recovered {len(rec)} matches; worst snap {rec.snap_dist.max():.2e}")

    # Published-accuracy reproduction: 1-NN cell-type match of each matched
    # query placed at its ref position (= same_tpu.check_alignment kNN=1).
    from same_tpu import check_alignment

    ref_xy = ref[["X", "Y"]].to_numpy()
    matches = pd.DataFrame({
        "cell_type": rec["query_type"],
        "SAME_X": ref_xy[rec["ref_row"], 0],
        "SAME_Y": ref_xy[rec["ref_row"], 1],
    })
    ref_eval = ref[["X", "Y", "cell_type"]].copy()
    ref_eval["SAME_X"] = ref_eval["X"]
    ref_eval["SAME_Y"] = ref_eval["Y"]
    eval_df, _ = check_alignment(
        matches, ref_eval, xcol="SAME_X", ycol="SAME_Y",
        ctype_col="cell_type", kNN=1,
    )
    acc = 100 * eval_df["_1NN_match"].sum() / len(eval_df)
    print(f"recovered published accuracy: {acc:.2f}% "
          f"(published {cfg['published_acc']}%), matches {len(matches)}")

    if args.out:
        rec.to_csv(args.out, index=False)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
