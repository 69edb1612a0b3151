"""Multi-device window sharding: the primary parallel axis of SAME-TPU.

The reference processes sliding windows sequentially on one host (reference
src/same.py:507-593) and merely documents a process-pool recipe
(docs/tutorials/large_datasets.md:199-224). Windows are embarrassingly
parallel, so this design shards the *window batch* across a device mesh:
problems are padded to shared shape buckets (models/assignment.py), the
auction solver is vmapped over the batch dimension, and the batch axis is
laid out over the mesh with ``jax.sharding.NamedSharding`` — XLA then runs
each device's windows locally with no cross-device communication until the
final host-side merge (windows.merge_window_matches_unique_ref).

``make_mesh``/``solve_window_batch`` work identically on the GPUs of one
host and on the virtual CPU mesh used in tests
(``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.assignment import AssignmentProblem
from ..solver.auction import _auction_run, make_eps_schedule, natural_stop_args


def make_mesh(n_devices: Optional[int] = None, axis: str = "windows") -> Mesh:
    """1D device mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def stack_problems(problems: Sequence[AssignmentProblem]):
    """Stack same-shape problems into batched arrays.

    All problems must share (n, C) and n_slots — guaranteed for windows that
    fall into the same shape bucket.
    """
    shapes = {(p.costs.shape, p.n_slots) for p in problems}
    if len(shapes) != 1:
        raise ValueError(f"problems span multiple shape buckets: {shapes}")
    costs = np.stack([p.costs for p in problems])
    slots = np.stack([p.slots for p in problems])
    valid = np.stack([p.valid for p in problems])
    nm = np.stack([p.nm_cost for p in problems])
    P_max = max(p.slot_rows.shape[1] for p in problems)

    def pad_P(a, fill):
        out = np.full((a.shape[0], P_max), fill, a.dtype)
        out[:, : a.shape[1]] = a
        return out

    slot_rows = np.stack([pad_P(p.slot_rows, -1) for p in problems])
    slot_cols = np.stack([pad_P(p.slot_cols, 0) for p in problems])
    return costs, slots, valid, nm, slot_rows, slot_cols


def solve_window_batch(
    problems: Sequence[AssignmentProblem],
    mesh: Optional[Mesh] = None,
    eps_final: float = 1e-2,
    eps_scaling: float = 4.0,
    max_rounds: int = 500000,
    extra_costs: Optional[np.ndarray] = None,
):
    """Solve a batch of window assignment problems, sharded over ``mesh``.

    Returns per-problem ``(match_ref, match_pair)`` lists plus raw choices.
    The batch is padded to a multiple of the mesh size with copies of the
    last problem (discarded on return).
    """
    B = len(problems)
    costs, slots, valid, nm, slot_rows, slot_cols = stack_problems(problems)
    if extra_costs is not None:
        costs = costs + np.asarray(extra_costs, dtype=costs.dtype)

    finite = costs[valid]
    scale = [float(np.max(nm, initial=0.0))]
    if finite.size:
        scale.append(float(finite.max() - finite.min()))
    eps_schedule = jnp.asarray(
        make_eps_schedule(max(scale + [1.0]), eps_final, eps_scaling)
    )

    pad = 0
    if mesh is not None:
        n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        pad = (-B) % n_dev
        if pad:
            costs = np.concatenate([costs, np.repeat(costs[-1:], pad, axis=0)])
            slots = np.concatenate([slots, np.repeat(slots[-1:], pad, axis=0)])
            valid = np.concatenate([valid, np.repeat(valid[-1:], pad, axis=0)])
            nm = np.concatenate([nm, np.repeat(nm[-1:], pad, axis=0)])
            slot_rows = np.concatenate(
                [slot_rows, np.repeat(slot_rows[-1:], pad, axis=0)]
            )
            slot_cols = np.concatenate(
                [slot_cols, np.repeat(slot_cols[-1:], pad, axis=0)]
            )

    S = problems[0].n_slots

    obj_args = natural_stop_args(costs.shape[1], eps_final)

    def solve_one(c, s, v, n, sr, sc):
        prices0 = jnp.zeros(S + 1, dtype=c.dtype)
        res = _auction_run(
            c, s, v, n, prices0, eps_schedule, max_rounds=max_rounds,
            slot_rows=sr, slot_cols=sc,
            obj_patience=obj_args[0], obj_tol=obj_args[1], obj_band=obj_args[2],
        )
        return res.choice, res.prices, res.rounds

    fn = jax.vmap(solve_one)
    batch_arrays = (costs, slots, valid, nm, slot_rows, slot_cols)
    if mesh is not None:
        axis = mesh.axis_names[0]
        sharding = NamedSharding(mesh, P(axis))
        args = [jax.device_put(jnp.asarray(a), sharding) for a in batch_arrays]
        fn = jax.jit(fn)
        choices, prices, rounds = fn(*args)
    else:
        choices, prices, rounds = jax.jit(fn)(
            *[jnp.asarray(a) for a in batch_arrays]
        )

    choices = np.asarray(choices)[:B]
    prices = np.asarray(prices)[:B]
    out = []
    for b, p in enumerate(problems):
        n, C = p.costs.shape
        ch = choices[b][: p.n_aligned]
        col = np.clip(ch, 0, C - 1)
        rows = np.arange(p.n_aligned)
        is_match = ch < C
        match_ref = np.where(is_match, p.cand_ref[rows, col], -1).astype(np.int64)
        match_pair = np.where(is_match, p.pair_idx[rows, col], -1).astype(np.int64)
        out.append((match_ref, match_pair))
    return out, {"choices": choices, "prices": prices, "rounds": np.asarray(rounds)[:B]}


def solve_windows_sharded(
    prepared: Sequence,
    mesh: Optional[Mesh] = None,
    deadline: Optional[float] = None,
    verbose: bool = False,
) -> List:
    """Run the FULL device solve (auction + tearing separation) for a list of
    PreparedWindows, batched by shape bucket and sharded over ``mesh``.

    This is the multi-chip replacement for the reference's sequential
    per-window ``model.optimize`` loop (reference src/same.py:507-593): the
    batched fused tearing loop (tearing_device.run_tearing_device_batch)
    runs every window's separation rounds in lockstep across devices; the
    exact host-side incumbent evaluation and local repair then run per
    window. Returns a list of TearingResult aligned with ``prepared``.

    Windows whose triangulation is empty (no orientation constraints) fall
    back to the single-window path.
    """
    import time as _time

    from ..core import solve_prepared
    from ..solver.tearing import _finish_solve, incumbents_from_device_data
    from ..solver.tearing_device import run_tearing_device_batch

    results: List = [None] * len(prepared)
    groups: dict = {}
    for idx, pw in enumerate(prepared):
        if len(pw.tris) == 0:
            results[idx] = solve_prepared(pw, deadline=deadline, verbose=verbose)
            continue
        solver = pw.solver
        # Every solver knob consumed at batch (not per-window) granularity
        # must be part of the key, or one window's setting would silently
        # apply to the whole bucket. Per-window knobs (delaunay_penalty,
        # flip fraction, eps, patience, penalty_coeff, hard) are traced
        # arrays and need not match.
        key = (
            pw.problem.costs.shape,
            pw.problem.n_slots,
            pw.problem.n_slot_copies,
            solver["lazy_max_cuts"],
            solver["lazy_max_cuts_per_incumbent"],
            solver["tpu_max_tear_rounds"],
            solver["tpu_eps_scaling"],
        )
        groups.setdefault(key, []).append(idx)

    def _run_separation(pws):
        solver0 = pws[0].solver
        # Honor the per-window time_limit contract (reference
        # src/same.py:1245): the batch runs in lockstep, so its deadline is
        # the tightest window deadline in the group.
        batch_deadline = deadline
        for p in pws:
            if p.solver["time_limit"] is not None:
                d = p.t_start + float(p.solver["time_limit"])
                batch_deadline = d if batch_deadline is None else min(
                    batch_deadline, d
                )
        t_sep0 = _time.time()
        datas = run_tearing_device_batch(
            [p.problem for p in pws],
            [p.tris for p in pws],
            [p.tri_weights for p in pws],
            [p.source_signs for p in pws],
            [p.ref_coords for p in pws],
            delaunay_penalties=[
                float(p.optim["delaunay_penalty"]) for p in pws
            ],
            allowed_flip_fractions=[
                (
                    p.solver["lazy_allowed_flip_fraction"]
                    if p.optim["lazy_constraints"]
                    else 0.0
                )
                for p in pws
            ],
            hards=[bool(p.optim["hard_spatial_constraints"]) for p in pws],
            eps_finals=[p.eps_solver for p in pws],
            penalty_coeffs=[float(p.optim["penalty_coeff"]) for p in pws],
            eps_scaling=float(solver0["tpu_eps_scaling"]),
            max_cuts=solver0["lazy_max_cuts"],
            max_cuts_per_round=solver0["lazy_max_cuts_per_incumbent"],
            max_tear_rounds=solver0["tpu_max_tear_rounds"],
            mesh=mesh,
            prices0_list=[p.prices0 for p in pws],
            deadline=batch_deadline,
            plateau_patiences=[
                p.solver.get("tpu_tear_patience", 6) for p in pws
            ],
            plateau_tols=[
                p.solver.get("tpu_tear_plateau_tol", 0.0) for p in pws
            ],
            obj_patience=solver0.get("tpu_auction_patience", 128),
            mip_gaps=[
                (
                    float(p.solver["mip_gap"])
                    if p.solver.get("tpu_gap_certificate", True)
                    else None
                )
                for p in pws
            ],
        )
        return datas, t_sep0, _time.time() - t_sep0

    # Bucket-level pipeline: bucket k+1's batched device separation runs on
    # a device thread while bucket k's host finishes (incumbent eval +
    # repair, serialized under HOST_LOCK inside _finish_solve) run here.
    # With one bucket this degenerates to the plain sequential order.
    from concurrent.futures import ThreadPoolExecutor

    group_items = list(groups.items())
    with ThreadPoolExecutor(max_workers=1) as dev_pool:
        sep_futs = [
            dev_pool.submit(_run_separation, [prepared[i] for i in idxs])
            for _key, idxs in group_items
        ]
        finished = _finish_groups(
            group_items, sep_futs, prepared, results, deadline, verbose,
            solve_prepared, incumbents_from_device_data, _finish_solve,
        )
    return finished


def _finish_groups(
    group_items, sep_futs, prepared, results, deadline, verbose,
    solve_prepared, incumbents_from_device_data, _finish_solve,
):
    import time as _time  # noqa: F401  (kept for symmetry with callers)

    for (key, idxs), fut in zip(group_items, sep_futs):
        pws = [prepared[i] for i in idxs]
        datas, t_sep0, t_sep = fut.result()
        if verbose:
            print(
                f"Sharded batch of {len(pws)} windows "
                f"(bucket {key[0]}): separation {t_sep:.2f}s"
            )
        for i, pw, data in zip(idxs, pws, datas):
            inc = incumbents_from_device_data(
                pw.problem, len(pw.tris), data, verbose=False
            )
            res = _finish_solve(
                pw.problem,
                pw.pair_costs,
                pw.tris,
                pw.tri_weights,
                pw.source_signs,
                pw.ref_coords,
                float(pw.optim["delaunay_penalty"]),
                float(pw.optim["penalty_coeff"]),
                bool(pw.optim["hard_spatial_constraints"]),
                deadline,
                inc,
                data["cut_tris"],
                data["cut_verts"],
                data["cut_pairs"],
                data["cuts_added"],
                data["rounds_used"],
                data["time_limit_reached"],
                t_sep0,
                allowed_flip_fraction=(
                    pw.solver["lazy_allowed_flip_fraction"]
                    if pw.optim["lazy_constraints"]
                    else 0.0
                ),
                repair_budget_override=pw.solver.get("tpu_repair_budget"),
                repair_workers=pw.solver.get("tpu_repair_workers"),
                mip_gap=(
                    float(pw.solver["mip_gap"])
                    if pw.solver.get("tpu_gap_certificate", True)
                    else None
                ),
            )
            pw.stage_times["solve"] = t_sep / max(len(pws), 1)
            for k2 in (
                "separation_time", "repair_time", "incumbent_eval_time",
                "host_queue_time", "device_time",
            ):
                if k2 in res.info:
                    pw.stage_times[k2] = res.info[k2]
            pw.stage_times["separation_time"] = t_sep / max(len(pws), 1)
            if "device_time" in data:
                pw.stage_times["device_time"] = data["device_time"]
            res.info["platform"] = data["platform"]
            # Gap certification (mirrors solve_prepared): the auction bounds
            # suboptimality by n * eps; on the rare epsilon-sizing miss,
            # re-solve this one window finer through the sequential path.
            n = pw.problem.n_aligned
            gap = float(pw.solver["mip_gap"])
            eps = pw.eps_solver
            lb = max(res.assignment_objective - n * eps, pw.obj_lb)
            if (
                n * eps > gap * lb
                and eps > pw.eps_floor * 1.01
                and not res.info.get("time_limit_reached", False)
            ):
                eps2 = max(
                    pw.eps_floor, gap * lb / max(n, 1) / 1.5 if lb > 0 else 0.0
                )
                if eps2 < eps * 0.7:
                    if verbose:
                        print(
                            f"Window {i}: gap not certified "
                            f"(n*eps={n * eps:.4g} > {gap:.2g}*lb="
                            f"{gap * lb:.4g}); re-solving at eps={eps2:.3g}"
                        )
                    pw.eps_solver = eps2
                    res2 = solve_prepared(pw, deadline=deadline, verbose=False)
                    if res2.objective <= res.objective:
                        res = res2
                    res.info["eps_retry"] = eps2
            results[i] = res
    return results

