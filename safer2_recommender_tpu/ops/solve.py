"""Batched SPD solvers.

Replaces the reference's per-row Eigen solves — ``Eigen::LLT`` Cholesky
(ials.h:140-142) and ``Eigen::ConjugateGradient`` (ials.h:133-138) — with
batched device implementations. The direct path is ``spd_solve`` in
``ops/block_chol.py``, which picks its implementation from the backend
and the system width.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from safer2_recommender_tpu.ops.block_chol import spd_solve as cholesky_solve


def cg_solve(a: jax.Array, b: jax.Array, *, tol: float = 1e-10,
             max_iters: int = 100, ridge=None) -> jax.Array:
    """Batched conjugate gradient (reference --use_cg path, ials.h:133-138).

    Per-system convergence masking with a whole-batch early exit
    (``lax.while_loop``: static shapes, data-dependent trip count).
    Eigen's tolerance is relative — ||r||^2 <= tol^2 ||b||^2; converged
    systems freeze while the rest iterate, and the loop ends when every
    system has converged or at max_iters. ``ridge`` [N] adds reg * I
    inside the matvec (never materialized).
    """
    b_norm2 = jnp.sum(b * b, axis=-1)
    thresh = (tol * tol) * b_norm2

    def cond(state):
        i, _, _, _, rs = state
        return (i < max_iters) & jnp.any(rs > thresh)

    def body(state):
        i, x, r, p, rs = state
        ap = jnp.einsum("nde,ne->nd", a, p)
        if ridge is not None:
            rg = ridge[:, None] if jnp.ndim(ridge) == 1 else ridge
            ap = ap + rg * p
        denom = jnp.sum(p * ap, axis=-1)
        live = (rs > thresh) & (denom > 0)   # freeze converged systems
        alpha = jnp.where(live, rs / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rs_new = jnp.where(live, jnp.sum(r * r, axis=-1), rs)
        beta = jnp.where(live, rs_new / jnp.maximum(rs, 1e-30), 0.0)
        p = jnp.where(live[:, None], r + beta[:, None] * p, p)
        return i + 1, x, r, p, rs_new

    x0 = jnp.zeros_like(b)
    _, x, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x0, b, b, b_norm2))
    return x


def solve(a: jax.Array, b: jax.Array, *, use_cg: bool = False,
          tol: float = 1e-10, max_iters: int = 100,
          ridge=None) -> jax.Array:
    """Solve (a + diag(ridge)) x = b; the ridge (the normal equations'
    reg * I) is applied inside the solver, never as a slab-wide add."""
    if use_cg:
        return cg_solve(a, b, tol=tol, max_iters=max_iters, ridge=ridge)
    return cholesky_solve(a, b, ridge)
