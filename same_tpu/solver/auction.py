"""Jacobi auction solver with epsilon scaling (JAX, jit-compiled).

This is the device replacement for Gurobi's branch-and-bound core (reference
src/same.py:1240-1244). The window matching problem — after ref-capacity slot
expansion (models/assignment.py) — is a pure assignment problem with an
explicit per-bidder no-match (reservation) option, which forward auction
solves to near-optimality while staying integral by construction.

Design notes for the asymmetric (reservation-option) setting
------------------------------------------------------------
Plain forward auction with epsilon scaling is correct for symmetric
assignment but breaks with a reservation option: prices inflated by coarse
phases strand bidders on no-match, because forward prices never come down.
The scheme here restores the needed complementary slackness with three rules:

1. **No per-phase reset.** Prices *and* assignments carry across phases.
2. **Boundary sweep.** At every phase boundary (and in the polish loop),
   prices of slots without an owner are zeroed — the vectorized equivalent of
   a reverse-auction round — and any slot-holder whose held value violates the
   new epsilon-CS bound is released back into the bidding pool.
3. **Reservation re-evaluation.** No-match bidders re-enter bidding the
   moment some slot beats their reservation value at current prices (checked
   every round; prices fall only at boundary sweeps, rise during bidding).

After the epsilon schedule, the final phase is repeated (sweep + release +
bid) until a fixed point: no price changes, no releases, no moves. At that
point every slot-holder and every no-match bidder is eps-CS at prices under
which every positively priced slot is owned — the conditions that bound
suboptimality by ~n*eps_final. The MILP oracle tests in
tests/test_auction.py verify this against exact HiGHS solves.

All state lives in fixed-shape device arrays; one bidding round is a handful
of [n, C] vector ops plus two scatters, executed inside ``lax.while_loop``
so an entire solve is a single XLA computation with no host round-trips.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.assignment import AssignmentProblem


class AuctionResult(NamedTuple):
    choice: jax.Array   # [n] i32: winning column in [0, C) or C for no-match
    prices: jax.Array   # [S+1] f32: final slot prices (last entry is dummy)
    rounds: jax.Array   # [] i32: total bidding rounds executed
    owner: jax.Array    # [S+1] i32: per-slot holder (carryable warm state)
    phase: jax.Array    # [] i32: epsilon phase at exit (P = finished)
    polish: jax.Array   # [] i32: polish repetitions of the final phase


def _values(costs, slots, valid, nm_cost, prices):
    """[n, C+1] bidder values at current prices (last column = no-match)."""
    p_slot = prices[slots]
    vals = jnp.where(valid, -(costs + p_slot), -jnp.inf)
    return jnp.concatenate([vals, -nm_cost[:, None]], axis=1)


@functools.partial(jax.jit, static_argnames=("max_polish",))
def _auction_run(
    costs, slots, valid, nm_cost, prices0, eps_schedule, max_rounds,
    max_polish=64, assigned0=None, owner0=None,
    slot_rows=None, slot_cols=None,
    obj_patience=None, obj_tol=None, obj_band=None,
):
    """Fused auction: all epsilon phases + polish in ONE while_loop.

    Phase boundaries (eps-CS release of slot-holders + zeroing of unowned
    prices) are applied as masked steps inside the single bidding-round body,
    so the whole solve is one compiled loop body — ~3x less code to compile
    than a scan-of-phases + polish-loop structure, and identical semantics:

    - a phase ends when a round produces no assignment change and no bids;
    - the final epsilon phase repeats (up to ``max_polish`` times) until a
      full phase passes with no assignment change;
    - NATURAL TERMINATION (the quality-driven stop): once the final-eps
      phase's placement value (unplaced bidders costed at their
      reservation) has not improved by ``obj_tol`` for ``obj_patience``
      rounds AND the current round sits within ``obj_band`` of the best
      seen, the solve finishes. Contested instances otherwise churn
      holders within the eps tolerance without ever producing the
      no-move round the fixed-point test needs, which made the round
      budget the *effective* termination (and made solution quality
      budget-sensitive). With this stop the budgets are a safety net.
      ``obj_patience <= 0`` (or None) disables it.
    """
    n, C = costs.shape
    S = prices0.shape[0] - 1
    P = eps_schedule.shape[0]
    bidder_ids = jnp.arange(n, dtype=jnp.int32)
    NULL = jnp.int32(C)
    max_total = jnp.int32(max_rounds)
    if obj_patience is None:
        obj_patience = jnp.int32(0)
    if obj_tol is None:
        obj_tol = jnp.float32(0.0)
    if obj_band is None:
        obj_band = jnp.float32(0.0)

    def cond(state):
        (assigned, owner, prices, phase, boundary, changed_in_phase, polish,
         it, best_obj, since_obj, phase_start, last_stall_best) = state
        return (phase < P) & (it < max_total)

    def body(state):
        (assigned, owner, prices, phase, boundary, changed_in_phase, polish,
         it, best_obj, since_obj, phase_start, last_stall_best) = state
        eps = eps_schedule[jnp.minimum(phase, P - 1)]

        # --- Boundary step (first round of each phase only; lax.cond so the
        # extra [n, C] evaluation is skipped on ordinary bidding rounds).
        # Release of eps-CS-violating holders + one REVERSE auction round
        # (Bertsekas-Castanon asymmetric auction): each unowned slot finds
        # its best person at their exclusive profit level and, if it can
        # offer a strictly attractive price, takes that person directly.
        # Pure forward auction with a reservation option either strands
        # bidders behind coarse-phase price inflation (if unowned prices
        # are kept) or re-climbs every price from zero in eps increments
        # (the measured 10-20k-round pathology, if they are zeroed);
        # executing the reverse swap advances augmenting chains one hop per
        # boundary with no bidding war.
        def boundary_step(args):
            assigned, owner, prices, _changed = args
            vals_all = _values(costs, slots, valid, nm_cost, prices)
            best0 = vals_all.max(axis=1)
            held_col = jnp.clip(assigned, 0, C)
            held_val = vals_all[bidder_ids, held_col]
            holds_slot = (assigned >= 0) & (assigned < NULL)
            release = holds_slot & (held_val < best0 - eps)
            released_slots = jnp.where(
                release, slots[bidder_ids, jnp.clip(held_col, 0, C - 1)], S
            )
            assigned = jnp.where(release, -1, assigned)
            owner = owner.at[released_slots].set(-1, mode="drop")
            owner = owner.at[S].set(-1)
            # Unsold objects must carry price zero (LP complementary
            # slackness); without this, coarse-phase overbids leave prices
            # stranding bidders on no-match.
            prices = jnp.where(owner < 0, 0.0, prices)
            prices = prices.at[S].set(0.0)

            if slot_rows is None:
                return assigned, owner, prices, _changed

            # Reverse auction rounds at the zeroed prices, drained to a
            # fixed point: each unowned slot claims its best person
            # directly at the attract price, skipping the forward re-climb
            # war that zeroing alone causes (measured 10-20k bidding rounds
            # per tearing re-solve). Draining lets augmenting chains
            # resolve fully within one boundary — each claim frees the
            # person's previous slot, which claims its own best person in
            # the next iteration.
            slot_ids = jnp.arange(S, dtype=jnp.int32)
            i_sp = jnp.clip(slot_rows, 0, n - 1)
            ref_mask = slot_rows >= 0

            def reverse_once(carry):
                assigned, owner, prices, any_win = carry
                # Per-slot best person at exclusive profit pi_excl
                # (second-best when the slot is the person's current best —
                # else an overpriced slot reproduces its own price through
                # its captive bidder and never deflates).
                vals_all = _values(costs, slots, valid, nm_cost, prices)
                top2b, top2bi = jax.lax.top_k(vals_all, 2)
                best = top2b[:, 0]
                best_col = top2bi[:, 0]
                second = jnp.where(
                    jnp.isfinite(top2b[:, 1]), top2b[:, 1], best
                )
                is_best_col = best_col[i_sp] == slot_cols
                pi_excl = jnp.where(is_best_col, second[i_sp], best[i_sp])
                surplus = jnp.where(
                    ref_mask,
                    -costs[i_sp, slot_cols] - pi_excl,
                    -jnp.inf,
                )
                arg_p = jnp.argmax(surplus, axis=1)
                ms = surplus[slot_ids, arg_p]              # [S] best surplus
                person = slot_rows[slot_ids, arg_p]        # [S] (-1 if none)
                pcol = slot_cols[slot_ids, arg_p]
                unowned = owner[:S] < 0
                # 2*eps margin keeps the person strictly outside its eps-CS
                # band, so the swap actually executes instead of stalling.
                p_new = jnp.maximum(ms - 2.0 * eps, 0.0)
                eligible = unowned & (person >= 0) & (ms > 0.0)
                person_c = jnp.clip(person, 0, n - 1)

                # Person-side conflict resolution: highest surplus wins,
                # smallest slot id breaks ties.
                claim_tgt = jnp.where(eligible, person, n)
                best_ms = jnp.full(n, -jnp.inf, ms.dtype).at[claim_tgt].max(
                    jnp.where(eligible, ms, -jnp.inf), mode="drop"
                )
                cand = eligible & (best_ms[person_c] == ms)
                slot_min = jnp.full(n, S, jnp.int32).at[
                    jnp.where(cand, person, n)
                ].min(slot_ids, mode="drop")
                win = cand & (slot_min[person_c] == slot_ids)

                # Execute the swaps: winner slots take their person; the
                # person's old slot (if any) is freed at price zero.
                new_col = jnp.full(n, -1, jnp.int32).at[
                    jnp.where(win, person, n)
                ].set(pcol, mode="drop")
                got = new_col >= 0
                still_holds = (assigned >= 0) & (assigned < NULL)
                old_slot = jnp.where(
                    got & still_holds,
                    slots[bidder_ids, jnp.clip(assigned, 0, C - 1)],
                    S,
                )
                owner = owner.at[old_slot].set(-1, mode="drop")
                owner = owner.at[jnp.where(win, slot_ids, S)].set(
                    jnp.where(win, person, -1).astype(jnp.int32), mode="drop"
                )
                assigned = jnp.where(got, new_col, assigned)
                # Prices: claimed slots at their attract level; freed and
                # unclaimed unowned slots at zero (unsold complementary
                # slackness).
                p_tail = prices[S:]
                p_real = jnp.where(win, p_new, prices[:S])
                prices = jnp.concatenate([p_real, p_tail])
                prices = jnp.where(
                    jnp.concatenate([~win, jnp.zeros(1, bool)]) & (owner < 0),
                    0.0,
                    prices,
                )
                prices = prices.at[S].set(0.0)
                owner = owner.at[S].set(-1)
                return assigned, owner, prices, any_win | jnp.any(win)

            # Fixed unroll instead of an inner while_loop: a 4th nesting
            # level of lax.while multiplies XLA compile time of the fused
            # tearing loop. Chains longer than 4 hops resolve across
            # subsequent polish boundaries.
            carry = (assigned, owner, prices, jnp.bool_(False))
            for _ in range(4):
                carry = reverse_once(carry)
            assigned, owner, prices, any_win = carry
            return assigned, owner, prices, any_win

        assigned, owner, prices, boundary_moved = jax.lax.cond(
            boundary,
            boundary_step,
            lambda args: args,
            (assigned, owner, prices, jnp.bool_(False)),
        )

        # --- One bidding round --------------------------------------------
        active = (assigned < 0) | (assigned == NULL)
        p_slot = prices[slots]
        vals = jnp.where(valid, -(costs + p_slot), -jnp.inf)
        vals_all = jnp.concatenate([vals, -nm_cost[:, None]], axis=1)
        top2, top2i = jax.lax.top_k(vals_all, 2)
        v1, v2 = top2[:, 0], top2[:, 1]
        choice = top2i[:, 0].astype(jnp.int32)
        v2 = jnp.where(jnp.isfinite(v2), v2, v1 - 1.0)
        incr = v1 - v2 + eps

        is_null = choice == NULL
        new_assigned = jnp.where(active & is_null & (assigned < 0), NULL, assigned)

        bids_slot = active & ~is_null
        tgt = jnp.where(bids_slot, slots[bidder_ids, jnp.clip(choice, 0, C - 1)], S)
        bid = jnp.where(bids_slot, prices[tgt] + incr, -jnp.inf)

        newp = prices.at[tgt].max(bid)
        won = bids_slot & (bid >= newp[tgt])
        # Tie-break winners by smallest bidder index via a scatter-min.
        winner = jnp.full(S + 1, n, dtype=jnp.int32)
        winner = winner.at[jnp.where(won, tgt, S)].min(
            jnp.where(won, bidder_ids, n).astype(jnp.int32)
        )
        final_win = won & (winner[tgt] == bidder_ids)

        slot_changed = winner < n
        evict = slot_changed & (owner >= 0) & (owner != winner)
        evict_targets = jnp.where(evict, owner, n)
        new_assigned = new_assigned.at[evict_targets].set(-1, mode="drop")
        new_assigned = jnp.where(final_win, choice, new_assigned)

        new_owner = jnp.where(slot_changed, winner, owner)
        new_owner = new_owner.at[S].set(-1)
        newp = newp.at[S].set(0.0)

        moved = (
            jnp.any(new_assigned != assigned) | jnp.any(bids_slot) | boundary_moved
        )
        changed_in_phase = changed_in_phase | moved

        # --- Natural termination / phase-stall bookkeeping -----------------
        # Placement value of the CURRENT state, unplaced bidders at their
        # reservation cost — a genuine feasible-completion value. One [n]
        # gather per round, negligible next to the [n, C] bidding ops.
        col_cur = jnp.clip(new_assigned, 0, C - 1)
        on_slot = (new_assigned >= 0) & (new_assigned < NULL)
        cur_obj = jnp.sum(
            jnp.where(on_slot, costs[bidder_ids, col_cur], nm_cost)
        )
        obj_improved = cur_obj < best_obj - obj_tol
        best_obj = jnp.minimum(best_obj, cur_obj)
        since_obj = jnp.where(obj_improved, jnp.int32(0), since_obj + 1)
        # NOTE on completeness: a bidder at -1 is mid-eviction on an
        # augmenting chain, and a stall-finish at that moment can strand
        # it on no-match (measured on the ISS heart under an enabled stall
        # rule: 22 of 3162 cells). Gating the finish on completeness was
        # measured too: near-tie workloads rarely produce all-placed
        # rounds, and the dp=25 LUAD bench window paid many more bidding
        # rounds for a stranding that never occurs there (10,641/10,641
        # matched either way). Resolution: the stall rule is an OPT-IN throughput
        # dial (pipeline default obj_patience=0 keeps exact fixed-point
        # termination for parity-pinned data), and opting in accepts the
        # mid-chain-finish caveat.
        # A phase STALLS once the placement value hasn't improved for
        # max(obj_patience, rounds-in-phase / 3) rounds. Two measured
        # pathologies motivate the rule:
        # - contested instances churn evictions within a phase without ever
        #   producing the no-move round the fixed-point test needs (a
        #   512-bidder near-tie instance was still in phase 5/16 after 20k
        #   rounds — the epsilon schedule never descended and the round
        #   budget was the effective stop);
        # - genuine improvements can arrive tens of thousands of rounds
        #   apart (a 30-bidder congestion instance: 1.4% of objective after
        #   round 140k of 210k), so a FIXED patience either cuts real
        #   progress or never fires. Relative patience bounds wasted churn
        #   at ~1.5x the productive prefix of the phase.
        # A stalled non-final phase ADVANCES to the next epsilon (finer
        # price refinement is more productive than finishing a stuck war);
        # a stalled final phase finishes — the quality-driven termination
        # that makes round budgets a safety net instead of the stop.
        stall = (obj_patience > 0) & (
            since_obj >= jnp.maximum(obj_patience, (it - phase_start) // 3)
        )

        # --- Phase-transition logic (fixed point OR stall) -----------------
        fixed = ~moved
        is_last = phase >= P - 1
        fixed_or_stall = fixed | stall
        # A stalled FINAL phase is not finished outright: the stall first
        # triggers a boundary (release + reverse-auction drain — the step
        # that advances augmenting chains without eps-increment wars) and
        # the solve only finishes when a drain fails to unlock ANY further
        # improvement by the next stall. On a 30-bidder congestion
        # instance, finishing at the first stall forfeited 1.4% that
        # subsequent drains recover.
        drain_failed = best_obj >= last_stall_best - obj_tol
        stall_finish = stall & is_last & (
            drain_failed | (polish >= max_polish)
        )
        stall_repeat = stall & is_last & ~stall_finish
        # Advance through the schedule; on the last phase, repeat while the
        # phase still changed something (polish), else finish.
        repeat_last = (
            fixed & is_last & changed_in_phase & (polish < max_polish) & ~stall
        )
        finish = (
            fixed & is_last & (~changed_in_phase | (polish >= max_polish))
        ) | stall_finish
        advance = fixed_or_stall & ~is_last

        new_phase = jnp.where(finish, P, jnp.where(advance, phase + 1, phase))
        new_polish = jnp.where(repeat_last | stall_repeat, polish + 1, polish)
        new_boundary = fixed_or_stall  # next round starts a phase
        new_changed = jnp.where(fixed_or_stall, False, changed_in_phase)
        # The stall window restarts at each true phase advance and at each
        # stall-triggered drain of the final phase.
        new_phase_start = jnp.where(advance | stall_repeat, it + 1, phase_start)
        since_obj = jnp.where(advance | stall_repeat, jnp.int32(0), since_obj)
        last_stall_best = jnp.where(stall_repeat, best_obj, last_stall_best)

        return (
            new_assigned, new_owner, newp, new_phase, new_boundary,
            new_changed, new_polish, it + 1, best_obj, since_obj,
            new_phase_start, last_stall_best,
        )

    if assigned0 is None:
        assigned0 = jnp.full(n, -1, dtype=jnp.int32)
    if owner0 is None:
        owner0 = jnp.full(S + 1, -1, dtype=jnp.int32)
    state = (
        assigned0, owner0, prices0, jnp.int32(0), jnp.bool_(True),
        jnp.bool_(False), jnp.int32(0), jnp.int32(0),
        jnp.float32(np.inf), jnp.int32(0), jnp.int32(0), jnp.float32(np.inf),
    )
    (assigned, owner, prices, _ph, _b, _c, _po, it, _bo, _so, _ps, _lsb) = (
        jax.lax.while_loop(cond, body, state)
    )
    exit_phase, exit_polish = _ph, _po

    # Final placement for bidders still unassigned at the round cap: a
    # truncated contested solve can leave a handful of bidders who lost
    # every bidding war. Dumping them on no-match costs ~no_match_penalty
    # each (measured +75k on the tongue window = 8 x 10000, 0.7% off
    # optimum); instead let each take its best currently-FREE slot (or
    # no-match when genuinely better), with scatter-min conflict
    # resolution, for a few drained iterations.
    def place_once(carry):
        assigned, owner, prices = carry
        unplaced = assigned < 0
        free_slot = owner < 0
        p_slot = prices[slots]
        vals = jnp.where(
            valid & free_slot[slots], -(costs + p_slot), -jnp.inf
        )
        best = vals.max(axis=1)
        best_col = jnp.argmax(vals, axis=1).astype(jnp.int32)
        take_nm = (-nm_cost >= best) | ~jnp.isfinite(best)
        choice = jnp.where(take_nm, NULL, best_col)
        tgt = jnp.where(
            unplaced & ~take_nm,
            slots[bidder_ids, jnp.clip(best_col, 0, C - 1)],
            S,
        )
        winner = jnp.full(S + 1, n, dtype=jnp.int32)
        winner = winner.at[tgt].min(
            jnp.where(unplaced & ~take_nm, bidder_ids, n).astype(jnp.int32)
        )
        win = unplaced & ~take_nm & (winner[tgt] == bidder_ids)
        assigned = jnp.where(
            unplaced & (win | take_nm), choice, assigned
        )
        owner = owner.at[jnp.where(win, tgt, S)].set(
            jnp.where(win, bidder_ids, -1).astype(jnp.int32), mode="drop"
        )
        owner = owner.at[S].set(-1)
        return assigned, owner, prices

    for _ in range(4):
        assigned, owner, prices = place_once((assigned, owner, prices))
    assigned = jnp.where(assigned < 0, jnp.int32(C), assigned)
    return AuctionResult(
        choice=assigned, prices=prices, rounds=it, owner=owner,
        phase=exit_phase, polish=exit_polish,
    )


def natural_stop_args(n: int, eps_final: float, patience: int = 128):
    """Traced-scalar args for the auction's objective-plateau stop.

    The improvement tolerance and the near-best band scale with n * eps —
    the auction's optimality granularity — so the stop never forfeits more
    than a small fraction of the n*eps suboptimality bound the epsilon was
    sized for (core.prepare_window's mip_gap certification).
    ``patience <= 0`` disables the stop (budget-only termination).
    """
    import jax.numpy as _jnp

    p = 0 if patience is None else int(patience)
    return (
        _jnp.int32(p),
        _jnp.float32(float(eps_final) * max(n / 16.0, 1.0)),
        _jnp.float32(float(eps_final) * max(n / 8.0, 1.0)),
    )


SCHEDULE_LEN = 16


def make_eps_schedule(
    cost_scale: float, eps_final: float, scaling: float
) -> np.ndarray:
    """Geometric epsilon schedule from ~cost_scale/2 down to eps_final.

    Padded to a fixed length (trailing eps_final repeats, which are cheap
    no-op phases at the fixed point) so the jitted solver compiles once per
    problem shape regardless of the cost scale.
    """
    eps_final = max(float(eps_final), 1e-6)
    eps0 = max(cost_scale / 2.0, eps_final)
    n_phases = max(1, int(math.ceil(math.log(eps0 / eps_final) / math.log(scaling))) + 1)
    eps = eps0 / (scaling ** np.arange(n_phases))
    eps = np.maximum(eps, eps_final)
    if len(eps) < SCHEDULE_LEN:
        eps = np.concatenate([eps, np.full(SCHEDULE_LEN - len(eps), eps_final)])
    eps[-1] = eps_final
    return eps.astype(np.float32)


def default_eps_schedule(
    problem: AssignmentProblem, eps_final: float, eps_scaling: float = 4.0
) -> np.ndarray:
    """Epsilon schedule sized to the problem's cost scale."""
    finite = np.asarray(problem.costs)[np.asarray(problem.valid)]
    scale_candidates = [float(np.max(problem.nm_cost, initial=0.0))]
    if finite.size:
        scale_candidates.append(float(finite.max() - finite.min()))
    return make_eps_schedule(max(scale_candidates + [1.0]), eps_final, eps_scaling)


def warm_eps_schedule(
    eps_final: float, perturbation_scale: float, cost_scale: float,
    scaling: float = 8.0,
) -> np.ndarray:
    """Epsilon schedule for a warm re-solve after a bounded cost perturbation.

    After the tearing loop surcharges some pairs by ``perturbation_scale``
    (delaunay_penalty * tri_weight), only the displaced holders re-bid — but
    they must traverse value differences up to that scale. Restarting at
    eps ~ perturbation/2 lets them cross it in a handful of bids instead of
    thousands of eps_final-sized increments (the measured pathology: 10-30k
    bidding rounds per tear round with a fixed [64x, 8x, 1x] schedule).
    Capped at cost_scale/2 — a bidder never needs to out-bid more than the
    full value range.
    """
    eps_final = max(float(eps_final), 1e-7)
    eps0 = min(
        max(float(perturbation_scale), eps_final * 64.0),
        max(float(cost_scale) / 2.0, eps_final),
    )
    n_phases = max(
        2, int(math.ceil(math.log(max(eps0 / eps_final, 1.0001)) / math.log(scaling))) + 1
    )
    eps = eps0 / (scaling ** np.arange(n_phases))
    eps = np.maximum(eps, eps_final)
    eps[-1] = eps_final
    return eps.astype(np.float32)


def solve_assignment(
    problem: AssignmentProblem,
    eps_final: float = 1e-2,
    eps_scaling: float = 4.0,
    max_rounds: int = 500000,
    prices0: np.ndarray | None = None,
    extra_costs: np.ndarray | None = None,
    eps_schedule: np.ndarray | None = None,
    return_raw: bool = False,
    obj_patience: int = 0,
):
    """Solve a window assignment problem; returns (match_ref, match_pair, info).

    ``obj_patience`` enables the objective-stall termination (see
    ``_auction_run``): 0 keeps the exact fixed-point semantics — right for
    standalone/oracle use where wall-clock is cheap; the solve pipeline
    passes ``tpu_auction_patience`` (default 128) because its round
    budgets otherwise become the effective stop on contested instances.

    match_ref : [n] ref row matched to each aligned point, or -1.
    match_pair : [n] index into the original pair list, or -1.
    info : dict with prices / rounds / epsilon schedule.

    ``extra_costs`` ([n, C]) lets the space-tearing loop add pair-level
    penalties without rebuilding the problem.
    """
    costs = jnp.asarray(problem.costs)
    if extra_costs is not None:
        costs = costs + jnp.asarray(extra_costs, costs.dtype)
    valid = jnp.asarray(problem.valid)
    nm = jnp.asarray(problem.nm_cost)

    if eps_schedule is None and prices0 is not None:
        # Warm-started solve: the given prices approximate the equilibrium,
        # so the coarse epsilon phases (whose only job is to build prices
        # fast) are skipped. Solution quality is unaffected — the optimality
        # bound depends only on eps_final — and the boundary sweeps correct
        # any over-pricing in the warm start.
        eps_schedule = np.asarray(
            [eps_final * 64, eps_final * 8, eps_final], np.float32
        )
    if eps_schedule is None:
        finite = np.asarray(problem.costs)[np.asarray(problem.valid)]
        scale_candidates = [float(np.max(problem.nm_cost, initial=0.0))]
        if finite.size:
            scale_candidates.append(float(finite.max() - finite.min()))
        cost_scale = max(scale_candidates + [1.0])
        eps_schedule = make_eps_schedule(cost_scale, eps_final, eps_scaling)
    else:
        eps_schedule = np.asarray(eps_schedule, dtype=np.float32)
        if len(eps_schedule) < SCHEDULE_LEN:
            eps_schedule = np.concatenate(
                [
                    eps_schedule,
                    np.full(
                        SCHEDULE_LEN - len(eps_schedule),
                        eps_schedule[-1],
                        dtype=np.float32,
                    ),
                ]
            )

    S = problem.n_slots
    if prices0 is None:
        prices = jnp.zeros(S + 1, dtype=costs.dtype)
    else:
        prices = jnp.asarray(prices0, dtype=costs.dtype)

    obj_args = natural_stop_args(
        problem.costs.shape[0], float(eps_schedule[-1]), obj_patience
    )
    result = _auction_run(
        costs,
        jnp.asarray(problem.slots),
        valid,
        nm,
        prices,
        jnp.asarray(eps_schedule),
        max_rounds=max_rounds,
        slot_rows=jnp.asarray(problem.slot_rows),
        slot_cols=jnp.asarray(problem.slot_cols),
        obj_patience=obj_args[0],
        obj_tol=obj_args[1],
        obj_band=obj_args[2],
    )
    if return_raw:
        # Device-resident result; caller handles (minimal) host transfers.
        return result

    n = problem.n_aligned
    C = problem.costs.shape[1]
    choice = np.asarray(result.choice)[:n]
    col = np.clip(choice, 0, C - 1)
    rows = np.arange(n)
    is_match = choice < C
    match_ref = np.where(is_match, problem.cand_ref[rows, col], -1).astype(np.int64)
    match_pair = np.where(is_match, problem.pair_idx[rows, col], -1).astype(np.int64)
    # Rows beyond n_aligned are shape-bucket padding and already sliced off.
    info = {
        "prices": np.asarray(result.prices),
        "prices_dev": result.prices,  # device-resident copy for warm restarts
        "rounds": int(result.rounds),
        "phase": int(result.phase),
        "polish": int(result.polish),
        "eps_schedule": eps_schedule,
    }
    return match_ref, match_pair, info
