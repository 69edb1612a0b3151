"""Fully device-resident space-tearing loop.

The host separation loop (tearing.py) pulls every incumbent to the host and
pushes cut surcharges back each tear round. This module keeps the ENTIRE
loop on the device — auction re-solves, batched flip tests, cut
registration with per-triangle dedup memory, regret-directed surcharges —
as one jitted step per tear round over device-resident state, returning
every incumbent in a single transfer at the end.

Semantics match tearing.py (and hence the reference's lazy callback,
reference src/same.py:621-704) with one bounded deviation: per-triangle cut
dedup memory holds at most ``K`` distinct triples (a triangle that flips
under more than K different matched triples stops receiving new cuts).
The host wrapper reconstructs the cut registry from the returned memory and
reuses the exact host-side incumbent evaluation + local repair.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.assignment import AssignmentProblem
from ..ops.orient import matched_triangle_flips
from .auction import (
    _auction_run,
    default_eps_schedule,
    natural_stop_args,
    warm_eps_schedule,
)

_HARD_PENALTY = 1e7


@functools.partial(
    jax.jit,
    static_argnames=(
        "L", "K", "max_tear_rounds", "max_rounds", "warm_max_rounds",
        "max_cuts_per_round", "max_cuts_total", "carry",
    ),
)
def _tearing_loop(
    costs, slots, valid, nm, pair_idx, cand_ref, slot_rows, slot_cols,
    tris, tri_mask, src, ref_xy, tri_weights,
    full_schedule, warm_schedule,
    delaunay_penalty, allowed_flip_fraction, penalty_coeff, hard, patience,
    plateau_tol, obj_patience, obj_tol, obj_band, gap_stop, state, r_end,
    L: int, K: int, max_tear_rounds: int, max_rounds: int,
    max_cuts_per_round: int, max_cuts_total: int, carry: bool = True,
    warm_max_rounds: int = 0,
):
    """One tear round (state-in/state-out, device-resident).

    The host drives the rounds so it can check the deadline and start the
    speculative repair between them; all state (surcharges, prices, cut
    memory, incumbent buffers) stays on device between calls.
    """
    n, C = costs.shape
    T = tris.shape[0]
    R = max_tear_rounds
    rows = jnp.arange(n)
    tri_ids = jnp.arange(T)

    def body(state):
        (extra, prices, assigned_c, owner_c, r, cuts_added, stop, cut_mem,
         cut_cnt, all_choices, all_flipped, all_checked, all_rounds,
         best_score, since_improve, best_r) = state

        # Warm-carry assignments and ownership across tear rounds: only the
        # newly surcharged pairs violate eps-CS at the boundary, so re-solves
        # stay local instead of re-fighting every previous bidding war. Every
        # 4th round restarts from a cold assignment (prices kept) — the
        # diversification role branch-and-bound's incumbent stream plays.
        # Cold restarts re-solve the whole problem, so they use the full
        # coarse-to-fine schedule (its early phases converge in a handful of
        # rounds); warm rounds use the surcharge-sized schedule.
        if carry:
            cold = (r % 4) == 0
            # Round 0 builds prices from scratch with the full
            # coarse-to-fine schedule; later cold restarts reset the
            # ASSIGNMENT (diversification) but keep the near-equilibrium
            # prices, so the coarse price-building phases would only
            # re-inflate them — the surcharge-sized warm schedule suffices.
            sched = jnp.where(r == 0, full_schedule, warm_schedule)
            assigned_in = jnp.where(cold, -1, assigned_c)
            owner_in = jnp.where(cold, -1, owner_c)
            prices_in = prices
            # Warm re-solves only re-bid the surcharge-displaced holders
            # and their chains — a fraction of a cold solve's rounds; the
            # full budget on every re-solve dominated separation wall-clock
            # (measured 496s -> the cold/warm split recovers most of it).
            warm_b = warm_max_rounds if warm_max_rounds else max_rounds
            rounds_budget = jnp.where(
                cold,
                jnp.where(
                    r == 0, jnp.int32(max_rounds), jnp.int32(max_rounds // 2)
                ),
                jnp.int32(warm_b),
            )
        else:
            # Fresh solve of the surcharged problem each round: carried
            # prices from earlier rounds embed surcharge-driven overbids
            # that poison subsequent equilibria.
            sched = full_schedule
            assigned_in = jnp.full_like(assigned_c, -1)
            owner_in = jnp.full_like(owner_c, -1)
            prices_in = jnp.zeros_like(prices)
            rounds_budget = jnp.int32(max_rounds)
        res = _auction_run(
            costs + extra, slots, valid, nm, prices_in, sched,
            max_rounds=rounds_budget, assigned0=assigned_in, owner0=owner_in,
            slot_rows=slot_rows, slot_cols=slot_cols,
            obj_patience=obj_patience, obj_tol=obj_tol, obj_band=obj_band,
        )
        choice = res.choice
        col = jnp.clip(choice, 0, C - 1)
        is_match = choice < C
        match_pair = jnp.where(is_match, pair_idx[rows, col], -1)
        match_ref = jnp.where(is_match, cand_ref[rows, col], -1).astype(jnp.int32)

        checked, flipped = matched_triangle_flips(
            ref_xy, tris, tri_mask, match_ref, src
        )
        n_checked = checked.sum()
        n_flipped = flipped.sum()
        frac_ok = n_flipped.astype(jnp.float32) <= (
            allowed_flip_fraction * n_checked.astype(jnp.float32)
        )

        all_choices = all_choices.at[r].set(choice)
        all_flipped = all_flipped.at[r].set(flipped)
        all_checked = all_checked.at[r].set(checked)
        all_rounds = all_rounds.at[r].set(res.rounds)

        # Plateau detection on the flips-pay incumbent score — the same
        # objective _finish_solve ranks incumbents by (base assignment cost
        # + dp * flipped weight beyond the budget allowance). Flip COUNTS
        # oscillate and keep drifting down long after the score has
        # converged (measured on the ISS heart window: counts kept
        # "improving" through all 25 rounds while the best score was set by
        # round ~8); further rounds only churn — the incumbent evaluation
        # already has the best matchings.
        base_cost = jnp.sum(
            jnp.where(is_match, costs[rows, col], nm).astype(jnp.float32)
        )
        m_ref = ref_xy.shape[0]
        u_ref = jnp.zeros(m_ref, jnp.float32).at[
            jnp.clip(match_ref, 0, m_ref - 1)
        ].add(jnp.where(is_match, 1.0, 0.0))
        base_cost = base_cost + penalty_coeff * jnp.sum(
            jnp.maximum(u_ref - 1.0, 0.0)
        )
        flip_w = jnp.sum(jnp.where(flipped, tri_weights, 0.0))
        checkable_w = jnp.sum(
            jnp.where(tri_mask & (src != 0), tri_weights, 0.0)
        )
        allowance = (
            delaunay_penalty
            * jnp.maximum(allowed_flip_fraction, 0.0)
            * checkable_w
        )
        score = base_cost + jnp.maximum(
            0.0, delaunay_penalty * flip_w - allowance
        )
        # An "improvement" must beat the incumbent by a relative margin
        # (tpu_tear_plateau_tol): micro-gains far inside the mip_gap band
        # keep resetting the patience counter and burn full auction
        # re-solves (measured: two LUAD-grid windows rode ~0.001%-per-round
        # drifts all the way to the 25-round cap at an unchanged final
        # flip fraction).
        improved = score < best_score - plateau_tol * jnp.abs(best_score) - 1e-6
        best_score = jnp.minimum(best_score, score)
        since_improve = jnp.where(improved, 0, since_improve + 1)
        best_r = jnp.where(improved, r, best_r)

        # Round-0 mip_gap certificate (the low-dp fast path): if the
        # UNSURCHARGED assignment optimum's tearing hinge is already inside
        # the mip_gap band, no separation round (or repair) can improve the
        # objective by more than the gap Gurobi itself terminates within —
        # ship the first incumbent. Round 0 only: later incumbents under
        # cut surcharges can show a transiently small hinge mid-descent
        # (the ISS-heart regime), where stopping would forfeit real
        # flip-quality the reference's callback achieves.
        hinge = jnp.maximum(
            0.0, delaunay_penalty * flip_w - allowance
        )
        gap_certified = (
            (gap_stop > 0.0)
            & (r == 0)
            & ~hard
            & (hinge <= gap_stop * (base_cost + hinge))
        )

        stop_now = (
            (n_checked == 0)
            | (n_flipped == 0)
            | frac_ok
            | gap_certified
            | (cuts_added >= max_cuts_total)
            # Plateau patience is a traced scalar (tpu_tear_patience);
            # negative disables the plateau stop.
            | ((patience >= 0) & (since_improve >= patience))
            | (delaunay_penalty == 0.0) & ~hard
        )

        # --- Cut registration (vectorized over triangles) -------------------
        tri_pairs = match_pair[tris]                      # [T, 3]
        all_matched = jnp.all(tri_pairs >= 0, axis=1)
        is_dup = jnp.any(
            jnp.all(cut_mem == tri_pairs[:, None, :], axis=2), axis=1
        )
        can_store = cut_cnt < K
        new_cut = flipped & all_matched & ~is_dup & can_store & ~stop_now
        # Per-round + global caps, honored in triangle-index order.
        rank = jnp.cumsum(new_cut.astype(jnp.int32)) - 1
        new_cut = new_cut & (rank < max_cuts_per_round) & (
            cuts_added + rank < max_cuts_total
        )
        added = new_cut.sum()

        # Store triples into per-triangle memory.
        store_k = jnp.where(new_cut, cut_cnt, K)          # K row is discarded
        cut_mem = cut_mem.at[tri_ids, jnp.clip(store_k, 0, K - 1)].set(
            jnp.where(new_cut[:, None], tri_pairs, cut_mem[
                tri_ids, jnp.clip(store_k, 0, K - 1)
            ])
        )
        cut_cnt = cut_cnt + new_cut.astype(jnp.int32)

        # --- Regret-directed surcharge on the cheapest-to-move pair ---------
        p_slot = res.prices[slots]
        vals = jnp.where(valid, -(costs + extra + p_slot), -jnp.inf)
        held = jnp.where(is_match, vals[rows, col], -nm)
        alt_mask = valid & (pair_idx != match_pair[:, None])
        alt_best = jnp.maximum(
            jnp.max(jnp.where(alt_mask, vals, -jnp.inf), axis=1), -nm
        )
        regret = held - alt_best
        vmove = jnp.argmin(regret[jnp.clip(tris, 0, n - 1)], axis=1)
        v_t = tris[tri_ids, vmove]                        # [T] vertex to move
        col_t = jnp.clip(choice[jnp.clip(v_t, 0, n - 1)], 0, C - 1)
        blk_t = (col_t // L) * L                          # pair's column block
        surcharge = jnp.where(
            hard, _HARD_PENALTY, delaunay_penalty * tri_weights
        ).astype(costs.dtype)
        upd = jnp.where(new_cut, surcharge, 0.0)
        v_safe = jnp.where(new_cut, v_t, n - 1)
        for s in range(L):
            extra = extra.at[v_safe, jnp.clip(blk_t + s, 0, C - 1)].add(
                jnp.where(new_cut, upd, 0.0)
            )

        stop = stop_now | (added == 0)
        return (
            extra, res.prices, res.choice, res.owner, r + 1,
            cuts_added + added, stop, cut_mem, cut_cnt, all_choices,
            all_flipped, all_checked, all_rounds, best_score, since_improve,
            best_r,
        )

    def cond(state):
        (_extra, _prices, _a, _o, r, _cuts, stop, *_rest) = state
        return (~stop) & (r < jnp.minimum(r_end, R))

    # One guarded step per call: the callers drive tear rounds from the host,
    # so an outer lax.while_loop here would execute its body once per
    # invocation anyway, and nesting it around the auction's while_loop
    # multiplies XLA compile time.
    return jax.lax.cond(cond(state), body, lambda s: s, state)


def _init_state(n, C, T, K, R, prices0):
    return (
        jnp.zeros((n, C), prices0.dtype),
        prices0,
        jnp.full(n, -1, jnp.int32),            # carried assignments
        jnp.full(prices0.shape[0], -1, jnp.int32),  # carried slot owners
        jnp.int32(0),
        jnp.int32(0),
        jnp.bool_(False),
        jnp.full((T, K, 3), -2, jnp.int32),
        jnp.zeros(T, jnp.int32),
        jnp.full((R, n), C, jnp.int32),
        jnp.zeros((R, T), bool),
        jnp.zeros((R, T), bool),
        jnp.zeros(R, jnp.int32),
        jnp.float32(np.inf),                   # best incumbent score so far
        jnp.int32(0),                          # rounds since improvement
        jnp.int32(0),                          # round index of best incumbent
    )


def _registry_from_memory(tris, cut_mem, cut_cnt):
    """Decode the per-triangle cut-dedup memory into registry lists."""
    cut_tris, cut_verts, cut_pairs = [], [], []
    for t in np.flatnonzero(cut_cnt > 0):
        for k in range(int(cut_cnt[t])):
            cut_tris.append(int(t))
            cut_verts.append(np.asarray(tris[t]).copy())
            cut_pairs.append(cut_mem[t, k].astype(np.int64))
    return cut_tris, cut_verts, cut_pairs


def run_tearing_device(
    problem: AssignmentProblem,
    tris: np.ndarray,
    tri_weights: np.ndarray,
    source_signs: np.ndarray,
    ref_coords: np.ndarray,
    delaunay_penalty: float,
    allowed_flip_fraction: float,
    penalty_coeff: float = 100.0,
    max_cuts=None,
    max_cuts_per_round: int = 1000,
    max_tear_rounds: int = 25,
    eps_final: float = 1e-2,
    eps_scaling: float = 4.0,
    hard: bool = False,
    max_rounds: int = 60000,
    K: int = 6,
    prices0=None,
    deadline=None,
    carry: bool = True,
    plateau_patience=6,
    plateau_tol: float = 0.0,
    obj_patience: int = 128,
    mip_gap=None,
    on_round=None,
):
    """Run the fused device tearing loop; returns host-side round data.

    Returns a dict with per-round incumbents (choices [R_used, n_pad]),
    flipped/checked masks, auction round counts, and the reconstructed cut
    registry (tri indices, vertex triples, pair triples). ``prices0`` seeds
    slot prices (warm start); ``deadline`` (absolute time.time()) is checked
    between tear rounds — the loop stops with whatever incumbents it has and
    sets ``time_limit_reached`` in the result.
    """
    import time as _time
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    T = len(tris)
    if T == 0:
        raise ValueError("run_tearing_device requires at least one triangle")
    n_pad, C = problem.costs.shape
    L = int(problem.n_slot_copies)

    # Re-solve schedule sized to the cut surcharge (see warm_eps_schedule).
    finite = np.asarray(problem.costs)[np.asarray(problem.valid)]
    cost_scale = max(
        float(np.max(problem.nm_cost, initial=0.0)),
        float(finite.max() - finite.min()) if finite.size else 1.0,
    )
    surcharge = float(delaunay_penalty) * float(np.max(tri_weights, initial=1.0))
    warm_sched = warm_eps_schedule(eps_final, surcharge, cost_scale)
    # A warm price start skips the coarse price-building phases on round 0.
    full_sched = (
        warm_sched.copy()
        if prices0 is not None
        else default_eps_schedule(problem, eps_final, eps_scaling)
    )
    pad_len = max(len(warm_sched), len(full_sched))
    for name, s in (("warm", warm_sched), ("full", full_sched)):
        if len(s) < pad_len:
            padded = np.concatenate(
                [s, np.full(pad_len - len(s), eps_final, np.float32)]
            )
            if name == "warm":
                warm_sched = padded
            else:
                full_sched = padded

    costs_d = jnp.asarray(problem.costs)
    args = (
        costs_d,
        jnp.asarray(problem.slots),
        jnp.asarray(problem.valid),
        jnp.asarray(problem.nm_cost),
        jnp.asarray(problem.pair_idx),
        jnp.asarray(problem.cand_ref),
        jnp.asarray(problem.slot_rows),
        jnp.asarray(problem.slot_cols),
        jnp.asarray(tris),
        jnp.ones(T, bool),
        jnp.asarray(np.asarray(source_signs, np.int32)),
        jnp.asarray(np.asarray(ref_coords, np.float32)),
        jnp.asarray(np.asarray(tri_weights, np.float32)),
        jnp.asarray(full_sched),
        jnp.asarray(warm_sched),
        jnp.float32(delaunay_penalty),
        jnp.float32(
            allowed_flip_fraction if allowed_flip_fraction is not None else -1.0
        ),
        jnp.float32(penalty_coeff),
        jnp.bool_(hard),
        jnp.int32(-1 if plateau_patience is None else int(plateau_patience)),
        jnp.float32(plateau_tol),
        *natural_stop_args(n_pad, float(eps_final), obj_patience),
        jnp.float32(mip_gap if mip_gap is not None else -1.0),
    )
    # Round budget per re-solve: the auction with reverse-drain boundaries
    # reaches its optimality band and then churns within the eps tolerance
    # without tripping the fixed-point test, so a budget cap IS the
    # effective termination on contested instances. n_pad rounds (not
    # n_pad//4 — measured: the tongue window's round-0 solve is still
    # placing bidders at 2048 rounds); a capped solve resumes next round via
    # the warm-carried assignments/prices, and leftover bidders get the
    # final placement pass.
    max_rounds = max(1024, min(max_rounds, n_pad))
    kwargs = dict(
        L=L,
        K=K,
        max_tear_rounds=max_tear_rounds,
        max_rounds=max_rounds,
        warm_max_rounds=max(1024, max_rounds // 8),
        max_cuts_per_round=int(max_cuts_per_round),
        max_cuts_total=int(max_cuts) if max_cuts is not None else 1 << 30,
        carry=carry,
    )
    if prices0 is not None:
        prices_init = jnp.asarray(np.asarray(prices0, problem.costs.dtype))
    else:
        prices_init = jnp.zeros(problem.n_slots + 1, costs_d.dtype)
    state = _init_state(n_pad, C, T, K, max_tear_rounds, prices_init)
    r_host = 0
    time_limit_reached = False
    device_time = 0.0
    while r_host < max_tear_rounds:
        t_round = _time.time()
        state = _tearing_loop(*args, state, jnp.int32(r_host + 1), **kwargs)
        # Two tiny scalar pulls per round. The first synchronizes, so this
        # host wall slice covers the round's device execution and transfer.
        r_host = int(state[4])
        device_time += _time.time() - t_round
        if bool(state[6]) or r_host >= max_tear_rounds:
            break
        if deadline is not None and _time.time() > deadline:
            time_limit_reached = True
            break
        if on_round is not None:
            # Mid-loop hook (speculative repair overlap, tearing.py): gives
            # the host the round counter, stall counter, and device state
            # while the device keeps separating.
            on_round(r_host, int(state[14]), state)

    # Single bulk transfer of everything else the host needs.
    r = r_host
    (cuts_added, cut_mem, cut_cnt, all_choices, all_flipped, all_checked,
     all_rounds) = jax.device_get(
        (state[5], state[7], state[8], state[9], state[10], state[11],
         state[12])
    )

    # Reconstruct the cut registry from per-triangle memory.
    cut_tris, cut_verts, cut_pairs = _registry_from_memory(tris, cut_mem, cut_cnt)

    return {
        "rounds_used": r,
        "cuts_added": int(cuts_added),
        "time_limit_reached": time_limit_reached,
        "choices": all_choices[:r],
        "flipped": all_flipped[:r],
        "checked": all_checked[:r],
        "auction_rounds": all_rounds[:r],
        "cut_tris": cut_tris,
        "cut_verts": cut_verts,
        "cut_pairs": cut_pairs,
        "device_time": device_time,
        "platform": next(iter(state[0].devices())).platform,
    }


def snapshot_best_incumbent(state):
    """Pull the best-so-far incumbent + cut registry from live device state.

    Used by the speculative-repair hook (tearing.py): one [n] choice pull
    plus the compact cut memory, while the device keeps running subsequent
    tear rounds. Returns (best_r, choice, flipped, checked, cut_mem,
    cut_cnt, cuts_added).
    """
    br = int(state[15])
    choice, flipped, checked, cut_mem, cut_cnt, cuts_added = jax.device_get(
        (
            state[9][br], state[10][br], state[11][br],
            state[7], state[8], state[5],
        )
    )
    return br, choice, flipped, checked, cut_mem, cut_cnt, int(cuts_added)


def _round_up(x: int, step: int) -> int:
    return ((max(x, 1) + step - 1) // step) * step


def run_tearing_device_batch(
    problems,
    tris_list,
    tri_weights_list,
    source_signs_list,
    ref_coords_list,
    *,
    delaunay_penalties,
    allowed_flip_fractions,
    hards,
    eps_finals,
    penalty_coeffs=None,
    eps_scaling: float = 4.0,
    max_cuts=None,
    max_cuts_per_round: int = 1000,
    max_tear_rounds: int = 25,
    max_rounds: int = 60000,
    K: int = 6,
    mesh=None,
    prices0_list=None,
    deadline=None,
    plateau_patiences=None,
    plateau_tols=None,
    obj_patience: int = 128,
    mip_gaps=None,
):
    """Batched fused tearing loop over a window batch, sharded over ``mesh``.

    The multi-chip analog of the reference's sequential window loop
    (reference src/same.py:507-593): every window runs the FULL solve —
    auction re-solves, flip tests, cut registration — as one vmapped
    ``_tearing_loop`` whose batch axis is laid out over the device mesh.
    All problems must share (n_pad, C, S, L) — the caller groups windows by
    shape bucket. Triangle arrays are padded to a common T with
    ``source_signs = 0`` rows, which the orientation test already treats as
    unchecked. Returns a per-window list of dicts in the
    ``run_tearing_device`` format.
    """
    import time as _time

    B = len(problems)
    if B == 0:
        return []
    n_pad, C = problems[0].costs.shape
    S = problems[0].n_slots
    L = int(problems[0].n_slot_copies)
    for p in problems:
        if p.costs.shape != (n_pad, C) or p.n_slots != S or p.n_slot_copies != L:
            raise ValueError("run_tearing_device_batch: mixed shape buckets")

    T_pad = _round_up(max(len(t) for t in tris_list), 128)
    R_ref = max(len(r) for r in ref_coords_list)

    def pad_tri(a, fill, dtype):
        a = np.asarray(a, dtype=dtype)
        out = np.full((T_pad,) + a.shape[1:], fill, dtype=dtype)
        out[: len(a)] = a
        return out

    tris_b = np.stack([pad_tri(t.reshape(-1, 3), 0, np.int64) for t in tris_list])
    tri_mask_b = np.stack(
        [np.arange(T_pad) < len(t) for t in tris_list]
    )
    src_b = np.stack([pad_tri(s, 0, np.int32) for s in source_signs_list])
    tw_b = np.stack([pad_tri(w, 0.0, np.float32) for w in tri_weights_list])
    ref_b = np.zeros((B, R_ref, 2), np.float32)
    for b, rc in enumerate(ref_coords_list):
        ref_b[b, : len(rc)] = np.asarray(rc, np.float32)

    costs_b = np.stack([p.costs for p in problems])
    slots_b = np.stack([p.slots for p in problems])
    valid_b = np.stack([p.valid for p in problems])
    nm_b = np.stack([p.nm_cost for p in problems])
    pair_idx_b = np.stack([p.pair_idx for p in problems])
    cand_ref_b = np.stack([p.cand_ref for p in problems])
    # Slot-major maps may have different P across the batch; pad to max.
    P_max = max(p.slot_rows.shape[1] for p in problems)

    def pad_P(a, fill):
        out = np.full((a.shape[0], P_max), fill, a.dtype)
        out[:, : a.shape[1]] = a
        return out

    slot_rows_b = np.stack([pad_P(p.slot_rows, -1) for p in problems])
    slot_cols_b = np.stack([pad_P(p.slot_cols, 0) for p in problems])

    # Per-window epsilon schedules (warm-start windows skip coarse phases;
    # re-solve schedules sized to each window's cut surcharge).
    scheds, warms = [], []
    for b, p in enumerate(problems):
        ef = float(eps_finals[b])
        finite = np.asarray(p.costs)[np.asarray(p.valid)]
        cost_scale = max(
            float(np.max(p.nm_cost, initial=0.0)),
            float(finite.max() - finite.min()) if finite.size else 1.0,
        )
        surcharge = float(delaunay_penalties[b]) * float(
            np.max(tri_weights_list[b], initial=1.0)
        )
        warm = warm_eps_schedule(ef, surcharge, cost_scale)
        if prices0_list is not None and prices0_list[b] is not None:
            full = warm.copy()
        else:
            full = default_eps_schedule(p, ef, eps_scaling)
        scheds.append(full)
        warms.append(warm)
    LEN = max(len(s) for s in scheds + warms)

    def pad_sched(s):
        return np.concatenate(
            [s, np.full(LEN - len(s), s[-1], np.float32)]
        ) if len(s) < LEN else s

    sched_b = np.stack([pad_sched(s) for s in scheds])
    warm_b = np.stack([pad_sched(w) for w in warms])

    dp_b = np.asarray(delaunay_penalties, np.float32)
    aff_b = np.asarray(
        [(-1.0 if a is None else float(a)) for a in allowed_flip_fractions],
        np.float32,
    )
    pc_b = (
        np.asarray(penalty_coeffs, np.float32)
        if penalty_coeffs is not None
        else np.full(B, 100.0, np.float32)
    )
    hard_b = np.asarray(hards, bool)
    pat_b = np.asarray(
        [
            -1 if p is None else int(p)
            for p in (
                plateau_patiences
                if plateau_patiences is not None
                else [6] * B
            )
        ],
        np.int32,
    )
    tol_b = np.asarray(
        plateau_tols if plateau_tols is not None else [0.0] * B, np.float32
    )
    # Per-window natural-stop scalars (objective-plateau termination).
    _stop = [
        natural_stop_args(n_pad, float(eps_finals[b]), obj_patience)
        for b in range(B)
    ]
    op_b = np.asarray([int(s[0]) for s in _stop], np.int32)
    ot_b = np.asarray([float(s[1]) for s in _stop], np.float32)
    ob_b = np.asarray([float(s[2]) for s in _stop], np.float32)
    gs_b = np.asarray(
        [
            (-1.0 if g is None else float(g))
            for g in (mip_gaps if mip_gaps is not None else [None] * B)
        ],
        np.float32,
    )
    prices_b = np.zeros((B, S + 1), costs_b.dtype)
    if prices0_list is not None:
        for b, pr in enumerate(prices0_list):
            if pr is not None:
                prices_b[b] = np.asarray(pr, costs_b.dtype)

    # Per-re-solve round budget, as in run_tearing_device.
    max_rounds = max(1024, min(max_rounds, n_pad))
    kwargs = dict(
        L=L,
        K=K,
        max_tear_rounds=max_tear_rounds,
        max_rounds=max_rounds,
        warm_max_rounds=max(1024, max_rounds // 8),
        max_cuts_per_round=int(max_cuts_per_round),
        max_cuts_total=int(max_cuts) if max_cuts is not None else 1 << 30,
    )

    def one(costs, slots, valid, nm, pair_idx, cand_ref, slot_rows, slot_cols,
            tris, tri_mask, src, ref_xy, tw, sched, warm, dp, aff, pc, hard,
            pat, tol, op, ot, ob, gs, state, r_end):
        return _tearing_loop(
            costs, slots, valid, nm, pair_idx, cand_ref, slot_rows, slot_cols,
            tris, tri_mask, src, ref_xy, tw, sched, warm, dp, aff, pc, hard,
            pat, tol, op, ot, ob, gs, state, r_end, **kwargs
        )

    batched = jax.jit(jax.vmap(one, in_axes=(0,) * 26 + (None,)))

    # Pad the batch to a multiple of the mesh size with copies of the last
    # window; padded lanes are discarded on return.
    pad = 0
    arrays = [
        costs_b, slots_b, valid_b, nm_b, pair_idx_b, cand_ref_b,
        slot_rows_b, slot_cols_b, tris_b,
        tri_mask_b, src_b, ref_b, tw_b, sched_b, warm_b, dp_b, aff_b, pc_b,
        hard_b, pat_b, tol_b, op_b, ot_b, ob_b, gs_b,
    ]
    if mesh is not None:
        n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        pad = (-B) % n_dev
        if pad:
            arrays = [
                np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                for a in arrays
            ]
            prices_b = np.concatenate(
                [prices_b, np.repeat(prices_b[-1:], pad, axis=0)]
            )
    B_pad = B + pad

    # Stacked device state (mirrors _init_state, batch axis first).
    state = (
        jnp.zeros((B_pad, n_pad, C), costs_b.dtype),
        jnp.asarray(prices_b),
        jnp.full((B_pad, n_pad), -1, jnp.int32),
        jnp.full((B_pad, S + 1), -1, jnp.int32),
        jnp.zeros(B_pad, jnp.int32),
        jnp.zeros(B_pad, jnp.int32),
        jnp.zeros(B_pad, bool),
        jnp.full((B_pad, T_pad, K, 3), -2, jnp.int32),
        jnp.zeros((B_pad, T_pad), jnp.int32),
        jnp.full((B_pad, max_tear_rounds, n_pad), C, jnp.int32),
        jnp.zeros((B_pad, max_tear_rounds, T_pad), bool),
        jnp.zeros((B_pad, max_tear_rounds, T_pad), bool),
        jnp.zeros((B_pad, max_tear_rounds), jnp.int32),
        jnp.full(B_pad, np.inf, jnp.float32),
        jnp.zeros(B_pad, jnp.int32),
        jnp.zeros(B_pad, jnp.int32),
    )

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]
        sh = NamedSharding(mesh, P(axis))
        args_dev = [jax.device_put(jnp.asarray(a), sh) for a in arrays]
        state = jax.tree.map(lambda x: jax.device_put(x, sh), state)
    else:
        args_dev = [jnp.asarray(a) for a in arrays]

    r_host = 0
    time_limit_reached = [False] * B
    device_time = 0.0
    while r_host < max_tear_rounds:
        t_round = _time.time()
        state = batched(*args_dev, state, jnp.int32(r_host + 1))
        r_host += 1
        stops = np.asarray(state[6])  # sync point for this round
        device_time += _time.time() - t_round
        if bool(stops[:B].all()) or r_host >= max_tear_rounds:
            break
        if deadline is not None and _time.time() > deadline:
            time_limit_reached = [not bool(s) for s in stops[:B]]
            break

    (cuts_added_b, cut_mem_b, cut_cnt_b, choices_b, flipped_b, checked_b,
     rounds_b, r_b) = jax.device_get(
        (state[5], state[7], state[8], state[9], state[10], state[11],
         state[12], state[4])
    )

    platform = next(iter(state[0].devices())).platform
    out = []
    for b in range(B):
        r = int(r_b[b])
        T = len(tris_list[b])
        cut_tris, cut_verts, cut_pairs = _registry_from_memory(
            np.asarray(tris_list[b]).reshape(-1, 3),
            cut_mem_b[b][:T], cut_cnt_b[b][:T],
        )
        out.append(
            {
                "rounds_used": r,
                "cuts_added": int(cuts_added_b[b]),
                "time_limit_reached": bool(time_limit_reached[b]),
                "choices": choices_b[b][:r],
                "flipped": flipped_b[b][:r, :T],
                "checked": checked_b[b][:r, :T],
                "auction_rounds": rounds_b[b][:r],
                "cut_tris": cut_tris,
                "cut_verts": cut_verts,
                "cut_pairs": cut_pairs,
                "device_time": device_time / max(B, 1),
                "platform": platform,
            }
        )
    return out