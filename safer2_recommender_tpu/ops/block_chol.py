"""Batched SPD solve for the normal equations.

One ALS sweep solves one small SPD system per user or item row (the
reference's per-row Eigen LLT, reference ials.h:133-143), here as one
batched solve per bucket: ``(a[n] + diag(ridge[n])) x[n] = b[n]`` for
``a`` [N, d, d]. The module holds two implementations of that solve,
and ``solver_for`` picks one from the backend and the width d:

* ``_native_solve``: XLA's own ``cholesky`` and two ``triangular_solve``
  calls. XLA lowers them to cuSOLVER/cuBLAS on the GPU and to LAPACK on
  the CPU.
* ``_factored_solve``: a blocked Cholesky factor by recursive 2x2
  blocking in batched matmuls, with the ``_DIAG_BLOCK``-wide diagonal
  blocks holding their explicit inverse (down to closed-form 2x2
  leaves),

      L = [[L11, 0], [L21, L22]],
      inv(L) = [[inv(L11), 0], [-inv(L22) L21 inv(L11), inv(L22)]],

  then block forward/backward substitution.

Which one wins was measured per backend at the sweeps' shapes
(``scripts/time_solver.py``): on an H100 the native path at every shape,
on the CPU LAPACK at d=32 and the factored recursion from d=128. A third
candidate, the full explicit inverse and two mat-vecs, won no shape on
either and was removed.

The factored path runs its dots at ``Precision.HIGHEST``: a TF32 or
bf16 product loses about three decimal digits on the factorization, far
above f32 solver error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

# Diagonal blocks at or below this width terminate the factored
# recursion with their explicit inverse (and the substitutions' leaf
# steps become mat-vecs against it).
_DIAG_BLOCK = 64


def _bdot(lhs: jax.Array, rhs: jax.Array, contract) -> jax.Array:
    return jax.lax.dot_general(
        lhs, rhs, dimension_numbers=(contract, ((0,), (0,))),
        preferred_element_type=jnp.float32, precision=HIGHEST)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _chol_inverse_rec(a: jax.Array, ridge: jax.Array) -> jax.Array:
    """inv(chol(a + diag(ridge))) (lower-triangular) for SPD a [N, R, R],
    R a power of 2, ridge [N, R] (per diagonal element). The ridge is
    applied where each diagonal element is first consumed (the closed
    forms), never as a slab-wide add."""
    n, r, _ = a.shape
    if r == 1:
        return jax.lax.rsqrt(
            jnp.maximum(a + ridge[:, :, None], 1e-30))
    if r == 2:
        a11 = a[:, 0:1, 0:1] + ridge[:, 0:1, None]
        a21 = a[:, 1:2, 0:1]
        a22 = a[:, 1:2, 1:2] + ridge[:, 1:2, None]
        i11 = jax.lax.rsqrt(jnp.maximum(a11, 1e-30))
        l21 = a21 * i11
        i22 = jax.lax.rsqrt(jnp.maximum(a22 - l21 * l21, 1e-30))
        i21 = -(i22 * l21 * i11)
        zero = jnp.zeros_like(a11)
        return jnp.concatenate([
            jnp.concatenate([i11, zero], axis=2),
            jnp.concatenate([i21, i22], axis=2),
        ], axis=1)
    h = r // 2
    inv11 = _chol_inverse_rec(a[:, :h, :h], ridge[:, :h])
    # L21 = A21 @ inv(L11)^T
    l21 = _bdot(a[:, h:, :h], inv11, (((2,), (2,))))
    # Schur complement S22 = A22 - L21 @ L21^T
    s22 = a[:, h:, h:] - _bdot(l21, l21, (((2,), (2,))))
    inv22 = _chol_inverse_rec(s22, ridge[:, h:])
    # inv21 = -inv(L22) @ (L21 @ inv(L11))
    t = _bdot(l21, inv11, (((2,), (1,))))
    inv21 = -_bdot(inv22, t, (((2,), (1,))))
    zero = jnp.zeros((n, h, h), a.dtype)
    return jnp.concatenate([
        jnp.concatenate([inv11, zero], axis=2),
        jnp.concatenate([inv21, inv22], axis=2),
    ], axis=1)


def _pad_pow2(a: jax.Array) -> jax.Array:
    """Pad [N, d, d] to the next power of two with identity blocks."""
    d = a.shape[1]
    d_pad = _next_pow2(d)
    if d_pad == d:
        return a
    pad_eye = jnp.zeros((d_pad, d_pad), a.dtype).at[
        jnp.arange(d, d_pad), jnp.arange(d, d_pad)].set(1.0)
    a = jnp.pad(a, ((0, 0), (0, d_pad - d), (0, d_pad - d)))
    return a + pad_eye[None]


def _ridge_vec(ridge: jax.Array, d: int, d_pad: int) -> jax.Array:
    """Normalize ridge ([N] or [N, d]) to [N, d_pad] (0 on the pad)."""
    if ridge.ndim == 1:
        ridge = jnp.broadcast_to(ridge[:, None], (ridge.shape[0], d))
    if d_pad != d:
        ridge = jnp.pad(ridge, ((0, 0), (0, d_pad - d)))
    return ridge


def _scrub_nonfinite(x: jax.Array) -> jax.Array:
    """Zero any solution row that came back nonfinite.

    A rank-deficient system with a NONZERO diagonal (reachable with
    l2_reg=0 and history shorter than dim) defeats both the all-zero
    bump and the blocked paths' per-pivot clamps (the clamped huge
    pivots feed inf - inf into the Schur complement), and a native
    potrf simply fails, so every path can produce NaN rows. A zero row
    (skip this row's update) is the one cheap answer that cannot poison
    the embedding table; genuinely bad numerics still surface through
    the models' NaN-loss abort (reference ials.h:291-296)."""
    ok = jnp.all(jnp.isfinite(x), axis=-1, keepdims=True)
    return jnp.where(ok, x, 0.0)


def _native_solve(a: jax.Array, b: jax.Array, ridge: jax.Array) -> jax.Array:
    """XLA's cholesky + two triangular solves; ridge [N] or [N, d] is
    materialized as a diagonal add. Systems whose shifted diagonal is
    all zero are bumped to the identity here too, which also covers a
    zero system with a nonzero b (``solve_path`` tests only b)."""
    d = a.shape[-1]
    if ridge.ndim == 1:
        ridge = ridge[:, None]
    diag = jnp.einsum("ndd->nd", a) + ridge
    zero_bump = jnp.where(jnp.all(diag == 0.0, axis=-1), 1.0, 0.0)
    a = a + (ridge + zero_bump[:, None])[:, :, None] * jnp.eye(d, dtype=a.dtype)
    chol = jnp.linalg.cholesky(a)
    y = jax.scipy.linalg.solve_triangular(chol, b[..., None], lower=True)
    x = jax.scipy.linalg.solve_triangular(chol, y, lower=True, trans=1)[..., 0]
    return _scrub_nonfinite(x)


def _trsm_right(s: jax.Array, x: jax.Array) -> jax.Array:
    """x @ L^-T for the solve factor ``s`` [N, r, r]; x [N, m, r]."""
    r = s.shape[1]
    if r <= _DIAG_BLOCK:
        return _bdot(x, s, (((2,), (2,))))        # x @ inv(L)^T
    h = r // 2
    y1 = _trsm_right(s[:, :h, :h], x[:, :, :h])
    rest = x[:, :, h:] - _bdot(y1, s[:, h:, :h], (((2,), (2,))))
    y2 = _trsm_right(s[:, h:, h:], rest)
    return jnp.concatenate([y1, y2], axis=2)


def _factor_rec(a: jax.Array, ridge: jax.Array) -> jax.Array:
    """Solve factor of a + diag(ridge): the L21 blocks of the blocked
    Cholesky factor below the diagonal, inv(chol(.)) on the
    <= _DIAG_BLOCK diagonal blocks, in one [N, r, r] buffer."""
    n, r, _ = a.shape
    if r <= _DIAG_BLOCK:
        return _chol_inverse_rec(a, ridge)   # diagonal-block terminal
    h = r // 2
    s11 = _factor_rec(a[:, :h, :h], ridge[:, :h])
    l21 = _trsm_right(s11, a[:, h:, :h])
    s22 = _factor_rec(a[:, h:, h:] - _bdot(l21, l21, (((2,), (2,)))),
                      ridge[:, h:])
    zero = jnp.zeros((n, h, h), a.dtype)
    return jnp.concatenate([
        jnp.concatenate([s11, zero], axis=2),
        jnp.concatenate([l21, s22], axis=2),
    ], axis=1)


def _fwd_sub(s: jax.Array, b: jax.Array) -> jax.Array:
    """y = L^-1 b by block forward substitution; b [N, r]."""
    r = s.shape[1]
    if r <= _DIAG_BLOCK:
        return jnp.sum(s * b[:, None, :], axis=2)            # inv @ b
    h = r // 2
    y1 = _fwd_sub(s[:, :h, :h], b[:, :h])
    t = b[:, h:] - jnp.sum(s[:, h:, :h] * y1[:, None, :], axis=2)
    y2 = _fwd_sub(s[:, h:, h:], t)
    return jnp.concatenate([y1, y2], axis=1)


def _bwd_sub(s: jax.Array, y: jax.Array) -> jax.Array:
    """x = L^-T y by block backward substitution; y [N, r]."""
    r = s.shape[1]
    if r <= _DIAG_BLOCK:
        return jnp.sum(s * y[:, :, None], axis=1)            # inv^T @ y
    h = r // 2
    x2 = _bwd_sub(s[:, h:, h:], y[:, h:])
    t = y[:, :h] - jnp.sum(s[:, h:, :h] * x2[:, :, None], axis=1)
    x1 = _bwd_sub(s[:, :h, :h], t)
    return jnp.concatenate([x1, x2], axis=1)


def _factored_solve(a: jax.Array, b: jax.Array, ridge: jax.Array) -> jax.Array:
    """Blocked Cholesky factor + block forward/backward substitution."""
    n, d = b.shape
    d_pad = _next_pow2(d)
    ridge = _ridge_vec(ridge, d, d_pad)
    if d_pad != d:
        a = _pad_pow2(a)
        b = jnp.pad(b, ((0, 0), (0, d_pad - d)))
    s = _factor_rec(a, ridge)
    x = _bwd_sub(s, _fwd_sub(s, b))
    return _scrub_nonfinite(x[:, :d])


# Every path computes the same solve; the keys are what ``solver_for``
# returns.
SOLVERS = {
    "native": _native_solve,
    "factored": _factored_solve,
}

# On the CPU the factored recursion beats LAPACK from this width up
# (LAPACK wins at d=32; see the module docstring).
_CPU_FACTORED_MIN_D = 128


def solver_for(backend: str, d: int) -> str:
    """The path ``spd_solve`` takes for d x d systems on ``backend``
    (``jax.default_backend()``; d is static under jit)."""
    if backend == "cpu" and d >= _CPU_FACTORED_MIN_D:
        return "factored"
    return "native"


def solve_path(path: str, a: jax.Array, b: jax.Array,
               ridge: jax.Array = None) -> jax.Array:
    """``spd_solve`` through the named path of ``SOLVERS``.

    Degenerate all-zero systems are bumped to the identity so the
    factorization stays finite; the zero test uses the RHS (for SPD a,
    b == 0 gives x == 0 with or without the bump, and a == 0 only arises
    on padded rows whose b is also 0). Rank-deficient systems that defeat
    the bump return zero rows instead of NaN (``_scrub_nonfinite``). Both
    the bump and the callers' reg * I ride the solver's diagonal shift,
    so no caller makes a slab-wide pass over the [N, d, d] systems for
    them.
    """
    bump = jnp.where(jnp.all(b == 0.0, axis=-1), 1.0, 0.0)
    if ridge is None:
        ridge = bump
    elif jnp.ndim(ridge) == 1:
        ridge = bump + ridge
    else:
        ridge = bump[:, None] + ridge
    return SOLVERS[path](a, b, ridge.astype(a.dtype))


@jax.jit
def spd_solve(a: jax.Array, b: jax.Array,
              ridge: jax.Array = None) -> jax.Array:
    """Solve (a[n] + diag(ridge[n])) x = b[n] for batched SPD a
    [N, d, d], b [N, d] -> [N, d]; ridge None, [N] (scalar shift per
    system) or [N, d] (full diagonal shift). The path comes from
    ``solver_for(backend, d)``; see ``solve_path``."""
    path = solver_for(jax.default_backend(), b.shape[1])
    return solve_path(path, a, b, ridge)
