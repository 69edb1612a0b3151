#!/usr/bin/env python
"""Recover Gurobi's exact synthetic-benchmark matching from the committed
reference figure.

The reference repo does not commit the synthetic `matchedDF.csv`, but
`examples/synthetic/figures/Fig2_triangle_violations.svg` (reference
reproduce_figures.ipynb cell 23) draws one line per match from the query
position (X, Y) to its matched ref position (ref_X, ref_Y) — black for
non-violating matches, magenta (#bf00bf) for the 46 violation nodes — plus
the full ref scatter in DataFrame order. Since the input CSVs are known,
the plot's affine data->figure transform can be fit exactly from the ref
scatter, every line endpoint inverted back to data coordinates, and each
endpoint snapped to the nearest query/ref cell. This reconstructs the
published Gurobi solution, giving an exact objective/flip-structure target
for the device solver.

Usage: python examples/recover_reference_matching.py [--out CSV]
"""

import argparse
import re
import sys

import numpy as np
import pandas as pd

sys.path.insert(0, __file__.rsplit("/", 2)[0])

SVG = "/root/reference/examples/synthetic/figures/Fig2_triangle_violations.svg"
DATA = "/root/reference/examples/synthetic/data"


def parse_svg(svg_path):
    text = open(svg_path).read()

    # Ref scatter: every <use> of the 'P' marker inside PathCollection_1,
    # emitted in ref_df row order by matplotlib.
    m = re.search(
        r'<g id="PathCollection_1">.*?</g>\s*</g>', text, re.DOTALL
    )
    block = m.group(0)
    ref_pts = np.array(
        re.findall(r'<use xlink:href="[^"]*" x="([-\d.e]+)" y="([-\d.e]+)"', block),
        dtype=float,
    )

    # Match lines: two-vertex paths "M x1 y1 L x2 y2" with black or
    # magenta stroke (good_matches then bad_matches, DataFrame order).
    lines = []
    for pm in re.finditer(
        r'<path d="M ([-\d.e]+) ([-\d.e]+)\s*L ([-\d.e]+) ([-\d.e]+)\s*"'
        r'[^>]*style="[^"]*stroke: (#000000|#bf00bf)',
        text,
    ):
        x1, y1, x2, y2, color = pm.groups()
        lines.append((float(x1), float(y1), float(x2), float(y2), color))
    return ref_pts, lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    ref_df = pd.read_csv(f"{DATA}/ref.csv", index_col=0)
    query_df = pd.read_csv(f"{DATA}/query.csv", index_col=0)

    ref_pts, lines = parse_svg(SVG)
    print(f"SVG: {len(ref_pts)} ref markers, {len(lines)} match lines")
    assert len(ref_pts) == len(ref_df), "ref scatter count mismatch"

    # Axis-aligned affine fit (aspect='equal', y flipped in SVG space):
    # sx*X + bx = px ; sy*Y + by = py. Least squares over the in-order
    # correspondence, then verify residuals are sub-pixel.
    X, Y = ref_df["X"].to_numpy(), ref_df["Y"].to_numpy()
    A = np.c_[X, np.ones_like(X)]
    (sx, bx), res_x, *_ = np.linalg.lstsq(A, ref_pts[:, 0], rcond=None)
    A = np.c_[Y, np.ones_like(Y)]
    (sy, by), res_y, *_ = np.linalg.lstsq(A, ref_pts[:, 1], rcond=None)
    rx = np.abs(sx * X + bx - ref_pts[:, 0]).max()
    ry = np.abs(sy * Y + by - ref_pts[:, 1]).max()
    print(f"affine fit: sx={sx:.6f} sy={sy:.6f} max residual=({rx:.2e},{ry:.2e})")
    assert rx < 0.05 and ry < 0.05, "affine fit is not exact — ordering broke"

    def inv(px, py):
        return (px - bx) / sx, (py - by) / sy

    qxy = query_df[["X", "Y"]].to_numpy()
    rxy = ref_df[["X", "Y"]].to_numpy()
    from scipy.spatial import cKDTree

    qt, rt = cKDTree(qxy), cKDTree(rxy)

    rows = []
    for x1, y1, x2, y2, color in lines:
        p1, p2 = inv(x1, y1), inv(x2, y2)
        # Endpoint 1 is the query position (notebook plots [X, ref_X]).
        dq, qi = qt.query(p1)
        dr, ri = rt.query(p2)
        rows.append((qi, ri, dq, dr, color == "#bf00bf"))
    rec = pd.DataFrame(
        rows, columns=["query_row", "ref_row", "q_resid", "r_resid", "violation"]
    )
    print(
        f"snap residuals: query max {rec.q_resid.max():.3e}, "
        f"ref max {rec.r_resid.max():.3e}"
    )
    assert rec.q_resid.max() < 0.05 and rec.r_resid.max() < 0.05
    dup_q = rec.query_row.duplicated().sum()
    print(
        f"recovered {len(rec)} matches, {rec.violation.sum()} violation-flagged, "
        f"{dup_q} duplicate query rows"
    )

    out = args.out or "examples/results/reference_synthetic_matching.csv"
    cols = {}
    cols["Aligned_cell_idx"] = query_df.index[rec.query_row].values
    cols["Ref_cell_idx"] = ref_df.index[rec.ref_row].values
    cols["violation"] = rec.violation.values
    pd.DataFrame(cols).to_csv(out, index=False)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
