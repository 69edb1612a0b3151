"""Entropic optimal transport (Sinkhorn) on the device.

Complementary first-order solver to the auction (solver/auction.py): where
the auction produces integral matchings, Sinkhorn produces fractional
transport plans and smooth dual potentials in a fixed number of
matmul-friendly iterations. Two uses here:

- **warm start**: the ref-side dual potentials seed auction prices
  (``prices ~ -g``), shrinking bidding wars on contested regions;
- **soft matching**: a differentiable relaxation of ``run_same``'s
  assignment, useful for gradient-based extensions.

Log-domain updates for numerical stability; epsilon annealing like the
auction's epsilon scaling. The sparse variant works directly on the padded
[n, K] candidate tensors (segment-logsumexp over the ref axis via scatter),
so no dense [n, m] matrix is materialized.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("n_iters",))
def sinkhorn_dense(cost, a, b, eps: float = 0.1, n_iters: int = 200):
    """Log-domain Sinkhorn on a dense cost matrix.

    Parameters: cost [n, m]; marginals a [n], b [m] (need not be balanced —
    the final plan satisfies the row marginals exactly, column marginals
    approximately). Returns (plan [n, m], f [n], g [m]).
    """
    log_a = jnp.log(a)
    log_b = jnp.log(b)
    f = jnp.zeros_like(a)
    g = jnp.zeros_like(b)

    def body(_, fg):
        f, g = fg
        # f-update: row logsumexp of (g - cost)/eps
        f = eps * log_a - eps * jax.nn.logsumexp(
            (g[None, :] - cost) / eps, axis=1
        )
        g = eps * log_b - eps * jax.nn.logsumexp(
            (f[:, None] - cost) / eps, axis=0
        )
        return f, g

    f, g = jax.lax.fori_loop(0, n_iters, body, (f, g))
    plan = jnp.exp((f[:, None] + g[None, :] - cost) / eps)
    return plan, f, g


@functools.partial(jax.jit, static_argnames=("n_iters", "n_ref"))
def sinkhorn_sparse(
    cand_cost, cand_ref, cand_mask, nm_cost, n_ref: int,
    eps: float = 1.0, n_iters: int = 100,
):
    """Sinkhorn over padded [n, K] candidate tensors with a no-match column.

    Each aligned point has unit mass, split across its K candidates and an
    explicit no-match sink at cost ``nm_cost``; each ref has unit capacity
    enforced softly through its dual potential g. Returns
    (plan [n, K+1], g [n_ref]) where the last plan column is no-match mass.
    """
    n, K = cand_cost.shape
    safe_ref = jnp.clip(cand_ref, 0, n_ref - 1)
    costs_all = jnp.concatenate([cand_cost, nm_cost[:, None]], axis=1)
    valid_all = jnp.concatenate(
        [cand_mask, jnp.ones((n, 1), bool)], axis=1
    )
    g = jnp.zeros(n_ref, dtype=cand_cost.dtype)

    def body(_, g):
        # Row update implicit: each row normalizes over candidates + sink.
        g_cols = jnp.concatenate(
            [g[safe_ref], jnp.zeros((n, 1), g.dtype)], axis=1
        )
        logits = jnp.where(valid_all, (g_cols - costs_all) / eps, -jnp.inf)
        log_row = jax.nn.logsumexp(logits, axis=1, keepdims=True)
        log_plan = logits - log_row  # rows sum to 1
        # Column (ref) marginal: mass per ref via scatter-add in log space ->
        # do it in linear space (masses are bounded by 1 per row).
        plan = jnp.exp(log_plan[:, :K])
        mass = jnp.zeros(n_ref, g.dtype).at[safe_ref.reshape(-1)].add(
            jnp.where(cand_mask, plan, 0.0).reshape(-1)
        )
        # Soft capacity-1: lower g where over-subscribed.
        g = g - eps * jnp.log(jnp.maximum(mass, 1e-9))
        g = jnp.minimum(g, 0.0)  # potentials only push away, prices >= 0
        return g

    g = jax.lax.fori_loop(0, n_iters, body, g)
    g_cols = jnp.concatenate([g[safe_ref], jnp.zeros((n, 1), g.dtype)], axis=1)
    logits = jnp.where(valid_all, (g_cols - costs_all) / eps, -jnp.inf)
    plan = jnp.exp(logits - jax.nn.logsumexp(logits, axis=1, keepdims=True))
    return plan, g


def sinkhorn_prices(problem, eps: float = 1.0, n_iters: int = 100):
    """Auction price warm start from Sinkhorn ref potentials.

    Maps the sparse dual g (<= 0, per ref) to initial slot prices (-g >= 0)
    replicated across each ref's capacity slots.
    """
    import numpy as np

    n, C = problem.costs.shape
    K = C  # candidate columns (slot-expanded); treat each column separately
    plan, g = sinkhorn_sparse(
        jnp.asarray(problem.costs),
        jnp.asarray(jnp.clip(jnp.asarray(problem.cand_ref), 0, None)),
        jnp.asarray(problem.valid),
        jnp.asarray(problem.nm_cost),
        n_ref=int(problem.n_ref),
        eps=eps,
        n_iters=n_iters,
    )
    g = np.asarray(g)
    prices = np.zeros(problem.n_slots + 1, dtype=problem.costs.dtype)
    slot_ref = np.asarray(problem.slot_ref)
    real = slot_ref >= 0
    prices[: problem.n_slots][real] = -g[slot_ref[real]]
    return prices
