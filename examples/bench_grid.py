#!/usr/bin/env python
"""LUAD-scale FULL-GRID benchmark: the reference's flagship workload shape.

The reference's headline scale result is the LUAD33 dp sweep: ~100K Xenium +
~94K PCF cells, MS=3 metacells both sides, window_size=13000 / overlap=250
over a ~26,000-unit tissue (3x3 = 9 windows), with total Gurobi solve times
0.5 / 1.8 / 249.9 / 608.9 min at dp = 0 / 10 / 25 / 50
(reference examples/luad/run_same.sh:88-104, luad_benchmark.html cell 9 /
Fig S18). The real data is Zenodo-only; this script builds a surrogate
tissue with the same extent, density, type structure (5 spatially coherent
types, probabilities x100) and pushes it through the ACTUAL product path:

    greedy_triangle_collapse(MS=3, both sides)
      -> sliding_window_matching(window=13000, overlap=250)  [pipelined]
      -> merge_window_matches_unique_ref
      -> unpack_metacell_matches(strategy='nearest')
      -> topk_type_match (Fig S19 semantics)

Usage:
  python examples/bench_grid.py --dp 25 [--out DIR] [--json FILE]
  python examples/bench_grid.py --dp 25 --resume-test   # kill/resume check
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LUAD_TYPES = ["B cell", "Epithelial", "Mesenchymal", "Myeloid", "T cell"]

# Reference totals (minutes) for the full 9-window grid, Fig S18.
REFERENCE_TOTAL_MIN = {0.0: 0.5, 1.0: 0.6, 5.0: 0.7, 10.0: 1.8, 25.0: 249.9,
                       50.0: 608.9}


def make_tissue(n_cells=100_000, extent=26_000.0, seed=3, query_keep=0.94):
    """Full-extent LUAD-like tissue (the 4x area of bench.py's one window)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, (n_cells, 2))
    centers = rng.uniform(0, extent, (len(LUAD_TYPES) * 24, 2))
    center_type = rng.integers(0, len(LUAD_TYPES), len(centers))
    # Chunked nearest-center assignment (the full [n, centers] matrix is fine
    # but chunking keeps peak memory flat).
    types = np.empty(n_cells, np.int64)
    for s in range(0, n_cells, 20000):
        d = ((xy[s:s + 20000, None, :] - centers[None, :, :]) ** 2).sum(-1)
        types[s:s + 20000] = center_type[np.argmin(d, axis=1)]
    probs = np.full((n_cells, len(LUAD_TYPES)), 2.0)
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
        df["cell_type"] = np.asarray(LUAD_TYPES)[types[keep]]
        for k, nm in enumerate(LUAD_TYPES):
            df[nm] = probs[keep, k]
        df["Cell_Num_Old"] = np.arange(len(df))
        return df

    return frame(1), frame(2, keep_frac=query_keep), list(LUAD_TYPES)


def collapse(df, verbose=False):
    from same_tpu import greedy_triangle_collapse

    return greedy_triangle_collapse(
        df, original_idx_col="Cell_Num_Old", max_metacell_size=3,
        r_max=250, min_angle_deg=15, return_object=True, verbose=verbose,
    )


def run_grid(
    mc_ref, mc_align, type_names, dp, out=None, verbose=True,
    solver_overrides=None,
):
    from same_tpu import sliding_window_matching

    solver = dict(
        mip_gap=0.05, lazy_allowed_flip_fraction=0.05,
        # Measured on this workload: the two largest grid windows ride
        # the 25-round tear cap on micro-gains far inside mip_gap; the
        # relative margin stops them rounds earlier at an unchanged final
        # flip fraction. Library default is 0.0.
        tpu_tear_plateau_tol=1e-4,
            # Auction natural termination (opt-in, like the plateau margin
            # above): cuts warm re-solve rounds ~6x on these windows; the
            # library default 0 keeps exact termination for the
            # parity-pinned datasets.
            tpu_auction_patience=128,
    )
    solver.update(solver_overrides or {})
    t0 = time.time()
    matches = sliding_window_matching(
        mc_ref, mc_align, outprefix=out,
        optim_params=dict(
            window_size=13000, overlap=250, min_cells_per_window=30,
            max_matches=1, radius=250, knn=8, no_match_penalty=10000,
            dist_ct_coeff=1, penalty_coeff=100, delaunay_penalty=dp,
            cell_id_col="metacell_id", ref_metacell_match_multiplier=3,
        ),
        solver_params=solver,
        verbose=verbose,
    )
    return time.time() - t0, matches


def harvest_stage_telemetry(out, wall_s):
    """Aggregate per-window stage telemetry.

    Each window's solver_state.json carries stage_times incl. device_time
    (host wall seconds its separation spent waiting on the device).
    """
    import glob

    dev = sep = rep = ev = 0.0
    n = 0
    for p in sorted(glob.glob(os.path.join(out, "window_*", "solver_state.json"))):
        try:
            st = json.load(open(p)).get("solve", {}).get("stage_times", {})
        except Exception:
            continue
        n += 1
        dev += float(st.get("device_time", 0.0))
        sep += float(st.get("separation_time", 0.0))
        rep += float(st.get("repair_time", 0.0))
        ev += float(st.get("incumbent_eval_time", 0.0))
    if not n:
        return {}
    return {
        "windows_with_telemetry": n,
        "device_busy_s": round(dev, 1),
        "separation_s": round(sep, 1),
        "repair_s": round(rep, 1),
        "incumbent_eval_s": round(ev, 1),
        "device_duty": round(dev / max(wall_s, 1e-9), 3),
    }


def evaluate(matches, mc_ref, mc_align, type_names):
    from same_tpu import (
        merge_window_matches_unique_ref,
        topk_type_match,
        unpack_metacell_matches,
    )

    t0 = time.time()
    merged = merge_window_matches_unique_ref(
        [matches], cell_id_col="metacell_id"
    )
    individual = unpack_metacell_matches(
        matches, mc_align.metacell_df, mc_ref.metacell_df,
        aligned_df=mc_align.original_df, ref_df=mc_ref.original_df,
        strategy="nearest",
        aligned_original_idx_col="Cell_Num_Old",
        ref_original_idx_col="Cell_Num_Old",
    )
    aligned_ct = mc_align.original_df.set_index("Cell_Num_Old")["cell_type"]
    ref_ct = mc_ref.original_df.set_index("Cell_Num_Old")["cell_type"]
    ind_acc = float(
        (
            individual["Aligned_cell_id"].map(aligned_ct).to_numpy()
            == individual["Ref_cell_id"].map(ref_ct).to_numpy()
        ).mean()
    )
    ref_probs = mc_ref.original_df.set_index("Cell_Num_Old")[type_names]
    _ind, topk = topk_type_match(individual, aligned_ct, ref_probs, type_names)
    return {
        "merged_matches": int(len(merged)),
        "individual_matches": int(len(individual)),
        "individual_ct_accuracy_pct": round(100 * ind_acc, 2),
        "top1_pct": round(100 * topk[1], 2),
        "top2_pct": round(100 * topk[2], 2),
        "top3_pct": round(100 * topk[3], 2),
        "downstream_seconds": round(time.time() - t0, 1),
    }


def _kill_after_n_windows(args, n_windows=2, poll_s=15):
    """Phase 1 of the resume test: run the grid in a child process and
    SIGKILL it (by pid) once ``n_windows`` windows have checkpointed to
    matchedDF.csv — simulating a mid-run crash.  Returns the set of
    window_ids that survived on disk."""
    import subprocess

    cmd = [
        sys.executable, os.path.abspath(__file__),
        "--dp", str(args.dp), "--out", args.out,
        "--cells", str(args.cells), "--skip-eval",
    ]
    mdf = os.path.join(args.out, "matchedDF.csv")
    child = subprocess.Popen(cmd)
    done = set()
    try:
        while child.poll() is None:
            time.sleep(poll_s)
            if os.path.exists(mdf):
                try:
                    done = set(pd.read_csv(mdf)["window_id"].unique())
                except Exception:
                    continue
                if len(done) >= n_windows:
                    child.kill()
                    break
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
    done = set(pd.read_csv(mdf)["window_id"].unique())
    print(f"resume-test: killed child after windows {sorted(done)}")
    return done


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--dp", type=str, default="25",
        help="delaunay_penalty, or a comma list (e.g. 0,1,5,10) sharing one "
        "tissue generation + collapse; with a list, --json/--out act as "
        "templates where '{dp}' is substituted",
    )
    ap.add_argument("--out", default=None, help="checkpoint dir (resume)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--cells", type=int, default=100_000)
    ap.add_argument(
        "--skip-eval", action="store_true",
        help="skip merge/unpack/top-k downstream evaluation",
    )
    ap.add_argument(
        "--resume-test", action="store_true",
        help="kill a child run mid-grid, then resume and verify the "
        "checkpointed windows are reused untouched",
    )
    ap.add_argument(
        "--solver", default=None,
        help="JSON dict of solver_params overrides (e.g. the speed profile "
        "'{\"tpu_max_tear_rounds\": 8, \"tpu_repair_budget\": 20}')",
    )
    args = ap.parse_args()
    from same_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.solver_overrides = json.loads(args.solver) if args.solver else None
    dps = [float(x) for x in str(args.dp).split(",")]
    args.dp = dps[0]

    resume_info = None
    if args.resume_test:
        if len(dps) > 1:
            ap.error("--resume-test takes a single --dp")
        if not args.out:
            ap.error("--resume-test requires --out")
        t_kill0 = time.time()
        pre_windows = _kill_after_n_windows(args)
        pre_rows = pd.read_csv(os.path.join(args.out, "matchedDF.csv"))
        resume_info = {
            "killed_after_windows": sorted(int(w) for w in pre_windows),
            "phase1_seconds": round(time.time() - t_kill0, 1),
        }

    t_gen0 = time.time()
    ref_df, qry_df, type_names = make_tissue(n_cells=args.cells)
    t_gen = time.time() - t_gen0
    print(f"tissue: ref={len(ref_df)} query={len(qry_df)} ({t_gen:.0f}s)")

    t_mc0 = time.time()
    mc_align = collapse(qry_df)
    mc_ref = collapse(ref_df)
    t_collapse = time.time() - t_mc0
    print(
        f"collapse MS=3: align {len(qry_df)}->{len(mc_align.metacell_df)}, "
        f"ref {len(ref_df)}->{len(mc_ref.metacell_df)} ({t_collapse:.0f}s)"
    )

    for dp in dps:
        _run_one_dp(
            args, dp, mc_ref, mc_align, type_names, t_collapse, resume_info,
            pre_rows if resume_info is not None else None,
            pre_windows if resume_info is not None else None,
        )


def _run_one_dp(
    args, dp, mc_ref, mc_align, type_names, t_collapse, resume_info,
    pre_rows, pre_windows,
):
    out = args.out
    if out and "{dp}" in out:
        out = out.format(dp=f"{dp:g}")
    if not out:
        # Telemetry (and resume artifacts) need a checkpoint dir.
        import tempfile

        out = tempfile.mkdtemp(prefix=f"same_grid_bench_dp{dp:g}_")
        print(f"checkpoints: {out}")
    t_solve, matches = run_grid(
        mc_ref, mc_align, type_names, dp, out=out,
        solver_overrides=getattr(args, "solver_overrides", None),
    )
    if resume_info is not None:
        # The checkpointed windows must come back byte-identical (they are
        # skipped, not recomputed) and the total must match a clean run's
        # window set.  Solve time is reported as the sum of per-window
        # run_time — the same per-window-runtime-sum metric the reference's
        # Fig S18 totals use — so the kill/restart overhead doesn't count
        # twice.
        key = ["window_id", "Aligned_metacell_id", "Ref_metacell_id"]
        pre = pre_rows.sort_values(key).reset_index(drop=True)
        post = (
            matches[matches["window_id"].isin(pre_windows)]
            .sort_values(key)
            .reset_index(drop=True)
        )
        intact = len(pre) == len(post) and all(
            pre[k].tolist() == post[k].tolist() for k in key
        )
        resume_info["windows_resumed_intact"] = bool(intact)
        resume_info["phase2_seconds"] = round(t_solve, 1)
        if not intact:
            print("resume-test FAILED: checkpointed windows changed")
        t_solve = float(
            matches.groupby("window_id")["run_time"].first().sum()
        )
    ref_total_s = REFERENCE_TOTAL_MIN.get(dp, None)
    result = {
        "dp": dp,
        "windows": int(matches["window_id"].nunique()),
        "grid_matches": int(len(matches)),
        "collapse_seconds": round(t_collapse, 1),
        "grid_solve_seconds": round(t_solve, 1),
        "reference_total_minutes": ref_total_s,
        "vs_reference": (
            round(ref_total_s * 60.0 / t_solve, 2) if ref_total_s else None
        ),
    }
    if resume_info is not None:
        result["resume_test"] = resume_info
    if out:
        result.update(harvest_stage_telemetry(out, t_solve))
    if not args.skip_eval:
        result.update(evaluate(matches, mc_ref, mc_align, type_names))
    print(json.dumps(result))
    if args.json:
        jpath = args.json
        if "{dp}" in jpath:
            jpath = jpath.format(dp=f"{dp:g}")
        with open(jpath, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
