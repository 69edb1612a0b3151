#!/usr/bin/env python
"""Smoke test of the SAME solve path on an NVIDIA GPU.

Drives the main path through the entry points a user calls — metacell
collapse, ``run_same``, ``sliding_window_matching``, the uniqueness merge —
at the LUAD window scale (~11k metacells per side), and checks every device
computation against the repository's plain reference: scipy's cKDTree for
the device kNN, the HiGHS MIP oracle (``solver.milp_oracle``) for the
solver, and the exact host scorer (``solver.tearing.mip_objective``) for the
reported objective.

Phases, one line of facts each (seconds, compile seconds, numbers):

1. device   JAX must report a GPU backend; there is no CPU fallback.
2. knn      device radius-kNN vs cKDTree, ~11k x ~11k points.
3. solve    a small flipped window via run_same vs HiGHS, then again with
            the Sinkhorn warm start.
4. main     the LUAD-scale window (bench.py): collapse, run_same cold, warm.
5. windows  sliding_window_matching over a window grid, then the merge.

With ``--four-cards`` only phase 1 and the sharded grid run: the window
grid on a 4-device mesh against the same windows on one card.

Exits non-zero when any phase fails. The last line of standard output is a
JSON object naming the device. Run one such process per machine: a JAX
process reserves most of each card's memory.

Usage:
    python chip_smoke.py
    python chip_smoke.py --four-cards
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "examples"))

import numpy as np  # noqa: E402

MIP_GAP = 0.05
PLATFORM = "gpu"  # every solve must report this platform
_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_seconds = [0.0]


def _on_duration(event, duration, **_kwargs):
    if event in _COMPILE_EVENTS:
        _compile_seconds[0] += duration


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def _fmt(v):
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, dict):
        return json.dumps(v, sort_keys=True)
    return str(v)


def run_phase(name, fn, *args):
    """Run one phase, print its facts line, re-raise any failure."""
    t0, c0 = time.time(), _compile_seconds[0]
    try:
        facts = fn(*args)
    except BaseException:
        print(f"phase {name}: FAILED", flush=True)
        raise
    line = " ".join(f"{k}={_fmt(v)}" for k, v in facts.items())
    print(
        f"phase {name}: ok seconds={time.time() - t0!r} "
        f"compile_seconds={_compile_seconds[0] - c0!r} {line}",
        flush=True,
    )
    return facts


# ---------------------------------------------------------------- phase 1
def phase_device(n_cards):
    import jax

    import same_tpu
    from same_tpu.utils.compile_cache import enable_compile_cache

    check(
        os.path.dirname(os.path.abspath(same_tpu.__file__))
        == os.path.join(HERE, "same_tpu"),
        "same_tpu was not imported from this checkout",
    )
    backend = jax.default_backend()
    check(backend == PLATFORM, f"JAX backend is {backend!r}; this test needs a GPU")
    check(
        len(jax.devices()) >= n_cards,
        f"{len(jax.devices())} GPUs visible, {n_cards} needed",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    for row in smi:
        print(f"nvidia-smi: {row}", flush=True)
    return {
        "jax": jax.__version__,
        "backend": backend,
        "device_kind": jax.devices()[0].device_kind,
        "devices": len(jax.devices()),
        "compile_cache": enable_compile_cache(),
    }


# ---------------------------------------------------------------- phase 2
def knn_mismatches(ih, dh, mh, it, dt, mt, radius, tol=1e-3):
    """Entries where the device kNN differs from cKDTree beyond a tie.

    A position may hold another ref only where the two distances tie within
    ``tol`` (same rank, equidistant refs), and may be filled on one side
    only where that distance sits within ``tol`` of the radius.
    """
    differs = (ih != it) | (mh != mt)
    with np.errstate(invalid="ignore"):  # inf - inf at empty positions
        tie = mh & mt & (np.abs(dh - dt) <= tol)
    edge = (mh & ~mt & (np.abs(dh - radius) <= tol)) | (
        mt & ~mh & (np.abs(dt - radius) <= tol)
    )
    return differs & ~(tie | edge)


def phase_knn(n=11_000, extent=13_000.0, radius=250.0, k=8, seed=0):
    from same_tpu.candidates import radius_knn

    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.0, extent, (n, 2))
    qry = ref + rng.normal(0.0, 15.0, ref.shape)
    t0 = time.time()
    ih, dh, mh = radius_knn(qry, ref, radius, k, backend="host")
    t_host = time.time() - t0
    radius_knn(qry, ref, radius, k, backend="tpu")  # compile
    t0 = time.time()
    it, dt, mt = radius_knn(qry, ref, radius, k, backend="tpu")
    t_dev = time.time() - t0
    bad = knn_mismatches(ih, dh, mh, it, dt, mt, radius)
    check(not bad.any(), f"{int(bad.sum())} kNN entries differ from cKDTree")
    same = (ih == it) & mh & mt
    # Distances: float64 norms of the device's float32 selection (no
    # matmul, so TF32 never enters); they must match cKDTree to rtol 1e-5.
    rel = np.abs(dt[same] - dh[same]) / np.maximum(dh[same], 1e-300)
    check(rel.max(initial=0.0) <= 1e-5, f"distance rtol {rel.max()} > 1e-5")
    return {
        "points": f"{n}x{n}",
        "radius": radius,
        "k": k,
        "neighbours": int(mh.sum()),
        "tie_swaps": int(((ih != it) | (mh != mt)).sum()),
        "max_dist_rel_err": float(rel.max(initial=0.0)),
        "host_ckdtree_s": t_host,
        "device_warm_s": t_dev,
    }


# ---------------------------------------------------------------- phase 3
def small_window(seed=0, n_side=10):
    """Jittered labelled grid and a twin with three swapped pairs (flips)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side)), -1)
    g = g.reshape(-1, 2).astype(float)
    # Neighbours differ in type, so each swapped pair's type-optimal
    # matching crosses over and flips the triangles around it.
    types = ((g[:, 0] + g[:, 1]) % 3).astype(int)
    names = ["ct0", "ct1", "ct2"]

    def frame(xy):
        df = pd.DataFrame(xy, columns=["X", "Y"])
        for c, nm in enumerate(names):
            df[nm] = 100.0 * (types == c)
        df["cell_type"] = np.asarray(names)[types]
        df["Cell_Num_Old"] = np.arange(len(df))
        return df

    ref = g + rng.normal(0, 0.07, g.shape)
    qry = g + rng.normal(0, 0.07, g.shape)
    for a in (1, 2 * n_side + 4, 6 * n_side + 7):
        qry[[a, a + 1]] = qry[[a + 1, a]]
    return frame(ref), frame(qry), names


SMALL_OPTIM = dict(radius=2.5, knn=4, delaunay_penalty=5.0, no_match_penalty=100)
SMALL_SOLVER = dict(lazy_allowed_flip_fraction=0.0, mip_gap=MIP_GAP)


def oracle_objective(pw):
    from same_tpu.solver.milp_oracle import solve_mip_oracle

    n = pw.problem.n_aligned
    slot_ref = pw.problem.slot_ref
    limits = np.bincount(slot_ref[slot_ref >= 0], minlength=pw.problem.n_ref)
    res = solve_mip_oracle(
        pw.valid_pairs, pw.pair_costs, n, pw.problem.n_ref, limits,
        float(pw.optim["penalty_coeff"]),
        np.asarray(pw.problem.nm_cost[:n], np.float64),
        triangles=pw.tris, tri_weights=pw.tri_weights,
        source_signs=pw.source_signs, ref_coords=pw.ref_coords,
        delaunay_penalty=float(pw.optim["delaunay_penalty"]),
        lazy_allowed_flip_fraction=float(
            pw.solver["lazy_allowed_flip_fraction"]
        ),
    )
    return float(res.objective), int(np.round(np.asarray(res.q).sum()))


def phase_solve():
    from same_tpu import prepare_window, run_same

    ref, qry, names = small_window()
    pw = prepare_window(
        ref, qry, names, optim_params=SMALL_OPTIM, solver_params=SMALL_SOLVER,
        verbose=False,
    )
    t0 = time.time()
    oracle_obj, oracle_q = oracle_objective(pw)
    t_oracle = time.time() - t0
    facts = {
        "aligned": pw.problem.n_aligned,
        "triangles": len(pw.tris),
        "dp": SMALL_OPTIM["delaunay_penalty"],
        "highs_objective": oracle_obj,
        "highs_paying_triangles": oracle_q,
        "highs_s": t_oracle,
    }
    for init in (None, "sinkhorn"):
        solver = dict(SMALL_SOLVER, init_method=init)
        t0 = time.time()
        _matches, var_out = run_same(
            ref, qry, names, optim_params=SMALL_OPTIM, solver_params=solver,
            verbose=False,
        )
        t = var_out["tpu"]
        tag = init or "default"
        check(t["platform"] == PLATFORM, f"{tag} solve ran on {t['platform']}")
        gap = abs(t["objective"] - oracle_obj) / abs(oracle_obj)
        check(gap <= MIP_GAP, f"{tag} objective off HiGHS by {gap} > mip_gap")
        if init:
            check(
                t["warm_start"].get("method") == init,
                f"warm start ran as {t['warm_start']}",
            )
        facts.update({
            f"{tag}_objective": float(t["objective"]),
            f"{tag}_rel_gap": float(gap),
            f"{tag}_flip_fraction": float(t["flip_fraction"]),
            f"{tag}_tear_rounds": int(t["tear_rounds"]),
            f"{tag}_s": time.time() - t0,
        })
    return facts


# ---------------------------------------------------------------- phase 4
def rescore(pw, var_out):
    """Exact host objective of a returned matching (and its q_t vector)."""
    from same_tpu.solver.tearing import mip_objective

    pairs = pw.valid_pairs
    n = pw.problem.n_aligned
    x = np.asarray(var_out["x"])
    check(len(x) == len(pairs), "re-prepared window has other pairs")
    sel = np.flatnonzero(x > 0.5)
    match_pair = np.full(n, -1, np.int64)
    match_pair[pairs[sel, 0]] = sel
    match_ref = np.where(match_pair >= 0, pairs[np.clip(match_pair, 0, None), 1], -1)
    paying = np.asarray(var_out["area_penalty_vars"], np.float64) > 0.5
    _base, total = mip_objective(
        match_ref, match_pair, pw.pair_costs,
        np.asarray(pw.problem.nm_cost[:n], np.float64), pw.problem.n_ref,
        float(pw.optim["penalty_coeff"]), pw.tri_weights, paying,
        float(pw.optim["delaunay_penalty"]),
    )
    return total


def phase_main(dp=25.0):
    from bench import collapse, luad_params, make_instance, run_once

    from same_tpu import prepare_window

    t0 = time.time()
    ref_df, qry_df, types = make_instance()
    mc_align = collapse(qry_df)
    mc_ref = collapse(ref_df)
    t_collapse = time.time() - t0
    runs = []
    for label in ("cold", "warm"):
        c0 = _compile_seconds[0]
        wall, matches, var_out = run_once(mc_ref, mc_align, types, dp=dp)
        t = var_out["tpu"]
        check(t["platform"] == PLATFORM, f"{label} solve ran on {t['platform']}")
        check(t["device_time"] > 0, f"{label}: fused device loop did not run")
        check(t["tear_rounds"] >= 1, f"{label}: no tear round")
        rounds, dev = int(t["auction_rounds_total"]), float(t["device_time"])
        print(
            f"phase main {label} auction: rounds={rounds} device_time_s={dev!r} "
            f"rounds_per_s={rounds / dev!r} ms_per_round={1e3 * dev / rounds!r}",
            flush=True,
        )
        stage = {k: round(float(v), 3) for k, v in t["stage_times"].items()}
        print(
            f"phase main {label}: wall_s={wall!r} "
            f"compile_s={_compile_seconds[0] - c0!r} matches={len(matches)} "
            f"objective={float(t['objective'])!r} "
            f"flip_fraction={float(t['flip_fraction'])!r} "
            f"tear_rounds={t['tear_rounds']} stage_times={json.dumps(stage)}",
            flush=True,
        )
        runs.append((wall, matches, var_out))
    optim, solver = luad_params(dp)
    pw = prepare_window(
        mc_ref.metacell_df, mc_align, types, optim_params=optim,
        solver_params=solver, verbose=False,
    )
    for label, (_wall, _m, var_out) in zip(("cold", "warm"), runs):
        obj = float(var_out["tpu"]["objective"])
        host = rescore(pw, var_out)
        check(
            abs(host - obj) <= 1e-6 * abs(obj),
            f"{label}: reported objective {obj} != host re-score {host}",
        )
    same = runs[0][2]["x"] == runs[1][2]["x"]
    return {
        "cells": f"{len(ref_df)}+{len(qry_df)}",
        "metacells": f"{len(mc_ref.metacell_df)}+{len(mc_align.metacell_df)}",
        "aligned": pw.problem.n_aligned,
        "padded_shape": list(pw.problem.costs.shape),
        "dp": dp,
        "collapse_s": t_collapse,
        "rescore_matches_reported": True,
        "cold_warm_matchings_identical": same,
    }


# ---------------------------------------------------------------- phase 5
GRID_OPTIM = dict(
    window_size=4000, overlap=250, min_cells_per_window=30, max_matches=1,
    radius=250, knn=8, no_match_penalty=10000, dist_ct_coeff=1,
    penalty_coeff=100, delaunay_penalty=25.0, cell_id_col="metacell_id",
    ref_metacell_match_multiplier=3,
)


def window_states(out):
    paths = sorted(glob.glob(os.path.join(out, "window_*", "solver_state.json")))
    states = []
    for p in paths:
        with open(p) as f:
            states.append(json.load(f))
    return states


def phase_windows(n_cells=12_000, extent=8_000.0):
    from bench import collapse, luad_params
    from bench_grid import make_tissue

    from same_tpu import merge_window_matches_unique_ref, sliding_window_matching

    ref_df, qry_df, types = make_tissue(n_cells=n_cells, extent=extent, seed=5)
    mc_align, mc_ref = collapse(qry_df), collapse(ref_df)
    _optim, solver = luad_params(GRID_OPTIM["delaunay_penalty"])
    # Repair budgets are wall-clock seconds of host HiGHS work (up to 450 s
    # a window by default); a short fixed budget keeps this path check
    # inside the run's time limit.
    solver = dict(solver, tpu_repair_budget=10)
    with tempfile.TemporaryDirectory(prefix="same_smoke_grid_") as out:
        t0 = time.time()
        matches = sliding_window_matching(
            mc_ref, mc_align, types, outprefix=out, optim_params=GRID_OPTIM,
            solver_params=solver, verbose=False,
        )
        t_grid = time.time() - t0
        states = window_states(out)
    merged = merge_window_matches_unique_ref([matches], cell_id_col="metacell_id")
    expect = {
        "window_id", "Aligned_metacell_id", "Ref_metacell_id", "X", "Y",
        "ref_X", "ref_Y", "filtered_violation", "triangle_violation",
    } | set(types)
    check(expect <= set(merged.columns), f"merged lacks {expect - set(merged.columns)}")
    check(len(states) >= 4, f"{len(states)} windows solved, 4 needed")
    platforms = [s["solve"]["platform"] for s in states]
    check(all(p == PLATFORM for p in platforms), f"window platforms {platforms}")
    sizes = [s["model"]["n_aligned"] for s in states]
    check(min(sizes) < 512, f"no window under 512 aligned points: {sizes}")
    a = merged["Aligned_metacell_id"]
    r = merged["Ref_metacell_id"]
    check(a.is_unique and r.is_unique, "merge left a duplicate id")
    return {
        "windows": len(states),
        "window_aligned_points": sizes,
        "grid_s": t_grid,
        "window_matches": len(matches),
        "merged_matches": len(merged),
    }


# ------------------------------------------------------------ four cards
def phase_sharded(n_cards=4, n_cells=30_000, extent=25_500.0, window=13_000):
    """LUAD-scale 2x2 window grid on an n-card mesh vs one card."""
    import jax

    from bench import collapse, luad_params
    from bench_grid import make_tissue

    from same_tpu import merge_window_matches_unique_ref, sliding_window_matching
    from same_tpu.parallel import make_mesh

    ref_df, qry_df, types = make_tissue(n_cells=n_cells, extent=extent, seed=3)
    mc_align, mc_ref = collapse(qry_df), collapse(ref_df)
    optim = dict(GRID_OPTIM, window_size=window)
    _o, solver = luad_params(GRID_OPTIM["delaunay_penalty"])
    # Repair budgets are wall-clock seconds; one fixed budget on both sides
    # bounds the run and makes the host phase comparable. Both sides run
    # the fused device loop, which the batched path always uses, as in
    # tests/test_windows_sharded.py.
    solver = dict(solver, tpu_repair_budget=10, tpu_device_loop="force")
    results = {}
    for label, mesh in (("one_card", None), ("sharded", make_mesh(n_cards))):
        with tempfile.TemporaryDirectory(prefix=f"same_smoke_{label}_") as out:
            t0 = time.time()
            m = sliding_window_matching(
                mc_ref, mc_align, types, outprefix=out, optim_params=optim,
                solver_params=solver, mesh=mesh, verbose=False,
            )
            wall = time.time() - t0
            states = window_states(out)
        merged = merge_window_matches_unique_ref([m], cell_id_col="metacell_id")
        objs = [float(s["solve"]["objective"]) for s in states]
        plats = sorted({s["solve"]["platform"] for s in states})
        print(
            f"phase sharded {label}: wall_s={wall!r} windows={len(states)} "
            f"window_objectives={objs} merged_matches={len(merged)} "
            f"platforms={plats}",
            flush=True,
        )
        check(plats == [PLATFORM], f"{label} windows ran on {plats}")
        results[label] = (objs, merged, wall)
    (o1, m1, w1), (o4, m4, w4) = results["one_card"], results["sharded"]
    check(len(o1) >= 4 and len(o1) == len(o4), f"windows {len(o1)} vs {len(o4)}")
    gaps = [abs(a - b) / abs(a) for a, b in zip(o1, o4)]
    check(max(gaps) <= MIP_GAP, f"window objectives differ by {max(gaps)}")
    p1 = set(zip(m1["Aligned_metacell_id"], m1["Ref_metacell_id"]))
    p4 = set(zip(m4["Aligned_metacell_id"], m4["Ref_metacell_id"]))
    denom = max(len(p1), len(p4), 1)
    agree = len(p1 & p4) / denom
    # tests/test_windows_sharded.py's contract: wall-clock repair budgets
    # let near-tied windows settle on other equal-quality matchings.
    check(agree >= 0.90, f"merged pair agreement {agree} < 0.90")
    check(abs(len(p1) - len(p4)) <= 0.01 * denom + 2, "merged counts differ")
    return {
        "cards": n_cards,
        "devices": len(jax.devices()),
        "max_window_objective_rel_diff": max(gaps),
        "merged_pair_agreement": agree,
        "merged_matches_one_card": len(p1),
        "merged_matches_sharded": len(p4),
        "wall_one_card_s": w1,
        "wall_sharded_s": w4,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded window grid on 4 cards against 1 card",
    )
    args = ap.parse_args()
    import jax

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    n_cards = 4 if args.four_cards else 1
    run_phase("device", phase_device, n_cards)
    if args.four_cards:
        run_phase("sharded", phase_sharded, n_cards)
    else:
        run_phase("knn", phase_knn)
        run_phase("solve", phase_solve)
        run_phase("main", phase_main)
        run_phase("windows", phase_windows)
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
