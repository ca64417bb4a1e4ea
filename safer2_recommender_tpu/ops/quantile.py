"""Smoothed-quantile (CtS-VaR) estimation: Newton-Raphson with Armijo.

Vectorized port of the reference's xi machinery:
  EvaluateQuantile   (value, grad, Hessian of the smoothed objective, /alpha)
                     reference safer2.h:652-689
  ComputeXiDirection (Newton step + Armijo backtracking, c=1e-4, <=32
                     halvings) reference safer2.h:692-712
  ComputeXi          (NR loop; optional sub-sampled NR drawing
                     ratio*n users *with replacement*) safer2.h:716-742

The Armijo loop uses the gradient at the *trial* point (grad_fx), exactly
as the reference does (safer2.h:704) — this is unusual but is the
behavioral contract. Everything is jit-compatible (lax.while_loop /
fori_loop, static trip counts).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from safer2_recommender_tpu.ops import smoothing

_ARMIJO_C = 1e-4
_ARMIJO_MAX_HALVINGS = 32


def evaluate_quantile(xi: jax.Array, losses: jax.Array, *, bandwidth: float,
                      alpha: float, use_epanechnikov: bool
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Value / gradient / Hessian of the smoothed quantile objective."""
    pdf, cdf, loss_fn = smoothing.kernel_fns(use_epanechnikov)
    r = losses - xi
    grad = (-(1.0 - alpha) + jnp.mean(cdf(-r, bandwidth))) / alpha
    hess = jnp.mean(pdf(-r, bandwidth)) / alpha
    value = jnp.mean(loss_fn(r, bandwidth, alpha)) / alpha
    return value, grad, hess


def xi_direction(xi: jax.Array, losses: jax.Array, *, bandwidth: float,
                 alpha: float, use_epanechnikov: bool) -> jax.Array:
    """One damped Newton step: returns -gamma * (grad/H) after Armijo."""
    kw = dict(bandwidth=bandwidth, alpha=alpha,
              use_epanechnikov=use_epanechnikov)
    f0, g0, h0 = evaluate_quantile(xi, losses, **kw)
    # The Epanechnikov kernel's compact support makes the Hessian exactly
    # zero when no loss lies within bandwidth of xi (likelier under SNR
    # subsampling); the reference divides anyway (safer2.h:697) and xi
    # becomes inf permanently. Take no step instead — stalling until the
    # losses move is recoverable, an infinite xi is not.
    d = jnp.where(h0 > 0, g0 / jnp.where(h0 > 0, h0, 1.0), 0.0)

    def armijo_fails(gamma):
        x = xi + gamma * (-d)
        fx, gx, _ = evaluate_quantile(x, losses, **kw)
        return fx > f0 + _ARMIJO_C * gamma * gx * (-d)

    def cond(state):
        gamma, k = state
        return jnp.logical_and(k < _ARMIJO_MAX_HALVINGS, armijo_fails(gamma))

    def body(state):
        gamma, k = state
        return gamma * 0.5, k + 1

    gamma, _ = jax.lax.while_loop(
        cond, body, (jnp.float32(1.0), jnp.int32(0)))
    return -gamma * d


def compute_xi(losses: jax.Array, prev_xi: jax.Array, key: jax.Array, *,
               nr_iterations: int, bandwidth: float, alpha: float,
               use_epanechnikov: bool, use_snr: bool,
               sampling_ratio: float) -> jax.Array:
    """NR loop (reference safer2.h:716-742).

    With SNR, each iteration draws ``int(n * sampling_ratio)`` losses
    uniformly *with replacement* (safer2.h:733-737) using the explicit
    PRNG key instead of std::random_device.
    """
    n = losses.shape[0]
    num_samples = max(int(n * sampling_ratio), 1)
    kw = dict(bandwidth=bandwidth, alpha=alpha,
              use_epanechnikov=use_epanechnikov)

    def body(t, carry):
        xi, key = carry
        if use_snr:
            key, sub = jax.random.split(key)
            inds = jax.random.randint(sub, (num_samples,), 0, n)
            sample = losses[inds]
        else:
            sample = losses
        d = xi_direction(xi, sample, **kw)
        return xi + d, key

    xi, _ = jax.lax.fori_loop(
        0, nr_iterations, body, (jnp.float32(prev_xi), key))
    return xi


# Crossover between top_k(k) and a full sort for exact_quantile (k-wide
# top_k costs grow with k; a sort does not).
_TOPK_MAX_K = 1024


def exact_quantile(losses: jax.Array, alpha: float) -> jax.Array:
    """CVaR-MF's exact xi: the floor(n*alpha)-th largest loss.

    Reference cvar_mf.h:582-595: nth_element over negated losses at
    position Q = n*alpha; returns -vals[Q].
    """
    n = losses.shape[0]
    # alpha == 1.0 would index one past the end (the reference's
    # nth_element reads out of bounds there); clamp to the smallest loss.
    q = min(int(n * alpha), n - 1)
    if q + 1 > _TOPK_MAX_K:
        # top_k's cost grows with k (per-element insertion against a
        # k-wide running set); at MSD scale (n=571k, alpha=0.3) the
        # selection is 171k wide and a full k-independent sort wins.
        return jnp.sort(losses)[n - 1 - q]
    top = jax.lax.top_k(losses, q + 1)[0]
    return top[q]
