"""Unit tests for the ops layer: kernels, solvers, quantile machinery."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safer2_recommender_tpu.ops import quantile, smoothing, solve


# ---- smoothing kernels (value parity with reference safer2.h:599-647) ----


def _gaussian_kernel_ref(u, h):
    return (2 * math.pi) ** -0.5 * math.exp(-((u / h) * 0.5 ** 0.5) ** 2) / h


def _gaussian_cdf_ref(u, h):
    return 0.5 * math.erfc(-(u / h) * 0.5 ** 0.5)


@pytest.mark.parametrize("h", [0.15, 0.7, 1.0])
def test_gaussian_kernel_values(h):
    us = np.linspace(-3, 3, 25)
    got_pdf = np.asarray(smoothing.gaussian_kernel(jnp.asarray(us), h))
    got_cdf = np.asarray(smoothing.gaussian_cdf(jnp.asarray(us), h))
    want_pdf = [_gaussian_kernel_ref(u, h) for u in us]
    want_cdf = [_gaussian_cdf_ref(u, h) for u in us]
    np.testing.assert_allclose(got_pdf, want_pdf, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_cdf, want_cdf, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("h", [0.15, 0.7])
def test_epanechnikov_cdf_properties(h):
    # CDF limits and symmetry; pdf integrates CDF (numeric check)
    us = np.linspace(-2 * h, 2 * h, 401)
    cdf = np.asarray(smoothing.epanechnikov_cdf(jnp.asarray(us), h))
    pdf = np.asarray(smoothing.epanechnikov_kernel(jnp.asarray(us), h))
    assert cdf[0] == 0.0 and cdf[-1] == 1.0
    assert np.all(np.diff(cdf) >= -1e-6)
    # central differences smear across the support-boundary kinks at
    # |u/h| == 1; exclude those two points
    num = np.gradient(cdf, us)
    interior = np.abs(np.abs(us / h) - 1.0) > 0.02
    np.testing.assert_allclose(num[interior][5:-5], pdf[interior][5:-5],
                               atol=2e-2)


def test_gaussian_loss_gradient_identity():
    # The reference's gaussian_loss (safer2.h:609-615) is *almost* the
    # integral of its CDF: its derivative carries an extra (u/2) K(u)
    # term relative to (1-alpha) - K_cdf(-u). This test pins that exact
    # behavior (the NR gradient in EvaluateQuantile uses the analytic
    # (1-alpha) - K_cdf(-u) form, NOT d(value)/dxi — reference semantics).
    h, alpha = 0.5, 0.3
    us = jnp.linspace(-2.0, 2.0, 11)
    g = jax.vmap(jax.grad(lambda u: smoothing.gaussian_loss(u, h, alpha)))(us)
    want = ((1 - alpha) - smoothing.gaussian_cdf(-us, h)
            + (us / 2) * smoothing.gaussian_kernel(us, h))
    np.testing.assert_allclose(np.asarray(g), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


# ---- solvers ----


def _random_spd(rng, n, d):
    m = rng.normal(size=(n, d, d)).astype(np.float32)
    return m @ m.transpose(0, 2, 1) + 0.5 * np.eye(d, dtype=np.float32)


def test_cholesky_solve_matches_numpy():
    rng = np.random.default_rng(0)
    a = _random_spd(rng, 16, 12)
    b = rng.normal(size=(16, 12)).astype(np.float32)
    x = np.asarray(solve.cholesky_solve(jnp.asarray(a), jnp.asarray(b)))
    want = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-4)


def test_cg_solve_matches_cholesky():
    rng = np.random.default_rng(1)
    a = _random_spd(rng, 8, 10)
    b = rng.normal(size=(8, 10)).astype(np.float32)
    x = np.asarray(solve.cg_solve(jnp.asarray(a), jnp.asarray(b),
                                  max_iters=50))
    want = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(x, want, rtol=1e-2, atol=1e-3)


def test_cholesky_solve_padded_rows_no_nan_leak():
    # padded rows carry all-zero systems; they must not produce NaNs
    a = np.zeros((4, 6, 6), dtype=np.float32)
    a[0] = np.eye(6) * 2
    b = np.ones((4, 6), dtype=np.float32)
    x = np.asarray(solve.cholesky_solve(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x[0], 0.5, rtol=1e-6)


# ---- quantile / xi machinery ----


def test_evaluate_quantile_hessian_is_grad_derivative():
    # grad and Hessian must be consistent: H == d(grad)/dxi
    # (grad = (-(1-a) + mean K_cdf(-(l-xi)))/a, safer2.h:674-681).
    rng = np.random.default_rng(2)
    losses = jnp.asarray(rng.normal(1.0, 0.5, 500).astype(np.float32))
    kw = dict(bandwidth=0.3, alpha=0.3, use_epanechnikov=False)

    def grad_fn(xi):
        return quantile.evaluate_quantile(xi, losses, **kw)[1]

    xi0 = jnp.float32(0.8)
    _, grad, hess = quantile.evaluate_quantile(xi0, losses, **kw)
    num_hess = jax.grad(grad_fn)(xi0)
    np.testing.assert_allclose(float(hess), float(num_hess),
                               rtol=1e-3, atol=1e-4)
    assert float(hess) > 0
    # grad is monotone increasing in xi and crosses zero at the smoothed
    # (1-alpha)-quantile
    gs = [float(grad_fn(jnp.float32(x))) for x in (-1.0, 1.0, 3.0)]
    assert gs[0] < gs[1] < gs[2]


def test_compute_xi_converges_to_quantile():
    # With a tight bandwidth, the smoothed quantile approaches the exact
    # (1-alpha)-upper quantile of the losses.
    rng = np.random.default_rng(3)
    alpha = 0.3
    losses = jnp.asarray(rng.normal(2.0, 1.0, 4000).astype(np.float32))
    xi = quantile.compute_xi(
        losses, jnp.mean(losses), jax.random.PRNGKey(0),
        nr_iterations=20, bandwidth=0.05, alpha=alpha,
        use_epanechnikov=False, use_snr=False, sampling_ratio=0.1)
    want = np.quantile(np.asarray(losses), 1 - alpha)
    assert abs(float(xi) - want) < 0.05


def test_compute_xi_snr_close_to_full():
    rng = np.random.default_rng(4)
    losses = jnp.asarray(rng.normal(0.0, 1.0, 4000).astype(np.float32))
    kw = dict(nr_iterations=10, bandwidth=0.2, alpha=0.3,
              use_epanechnikov=False)
    full = quantile.compute_xi(losses, jnp.float32(0.0),
                               jax.random.PRNGKey(0), use_snr=False,
                               sampling_ratio=1.0, **kw)
    snr = quantile.compute_xi(losses, jnp.float32(0.0),
                              jax.random.PRNGKey(0), use_snr=True,
                              sampling_ratio=0.5, **kw)
    assert abs(float(full) - float(snr)) < 0.1


def test_exact_quantile_matches_reference_semantics():
    # reference cvar_mf.h:582-595: xi = the floor(n*alpha)-th largest loss
    rng = np.random.default_rng(5)
    losses = rng.normal(size=257).astype(np.float32)
    alpha = 0.3
    got = float(quantile.exact_quantile(jnp.asarray(losses), alpha))
    q = int(len(losses) * alpha)
    want = np.sort(losses)[::-1][q]
    assert got == pytest.approx(want)


def test_exact_quantile_sort_path_matches_topk():
    # above _TOPK_MAX_K selections exact_quantile switches from top_k to
    # a full sort (k-independent; MSD-scale selections are 171k wide) —
    # both must produce the reference's nth_element answer, ties included
    rng = np.random.default_rng(6)
    n = 4 * quantile._TOPK_MAX_K
    losses = np.round(rng.normal(size=n) * 8).astype(np.float32)  # ties
    for alpha in (0.3, 0.9, 1.0):
        got = float(quantile.exact_quantile(jnp.asarray(losses), alpha))
        q = min(int(n * alpha), n - 1)
        assert q + 1 > quantile._TOPK_MAX_K  # sort path taken
        want = np.sort(losses)[::-1][q]
        assert got == pytest.approx(want)


# --------------------------------------------------------------------------
# Batched SPD solver (ops/block_chol.py)
# --------------------------------------------------------------------------


def _random_spd(rng, n, d, ridge=0.05):
    g = rng.normal(size=(n, d, d)).astype(np.float32)
    a = np.einsum("nij,nkj->nik", g, g) / d + ridge * np.eye(d,
                                                            dtype=np.float32)
    return jnp.asarray(a)


@pytest.fixture(params=["native", "factored"])
def spd_solve_path(request):
    """Each solver path of ``block_chol.SOLVERS``, jitted on its own with
    spd_solve's diagonal handling (``solve_path``): the CPU suite covers
    every path whichever one ``solver_for`` picks on this backend."""
    import functools

    from safer2_recommender_tpu.ops import block_chol

    return jax.jit(functools.partial(block_chol.solve_path, request.param))


@pytest.mark.parametrize("d", [1, 2, 5, 8, 16, 24, 32, 96, 128, 256])
def test_spd_solve_matches_numpy(d, spd_solve_path):
    rng = np.random.default_rng(d)
    a = _random_spd(rng, 17, d)
    b = jnp.asarray(rng.normal(size=(17, d)).astype(np.float32))
    x = np.asarray(spd_solve_path(a, b))
    want = np.linalg.solve(np.asarray(a), np.asarray(b)[..., None])[..., 0]
    np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-4)


def test_spd_solve_zero_rows_stay_finite(spd_solve_path):
    rng = np.random.default_rng(0)
    a = np.array(np.asarray(_random_spd(rng, 8, 16)))
    a[3] = 0.0  # padded row: all-zero system
    b = jnp.asarray(rng.normal(size=(8, 16)).astype(np.float32))
    x = np.asarray(spd_solve_path(jnp.asarray(a), b))
    assert np.isfinite(x).all()
    # non-padded rows still solved correctly
    want = np.linalg.solve(a[4:], np.asarray(b)[4:, :, None])[..., 0]
    np.testing.assert_allclose(x[4:], want, rtol=2e-3, atol=2e-4)


def test_spd_solve_rank_deficient_stays_finite(spd_solve_path):
    # l2_reg=0 is a legal config: a row with history L < dim then assembles
    # an exactly singular PSD system with a NONZERO diagonal (the all-zero
    # bump misses it). No path may leak NaN into the tables.
    rng = np.random.default_rng(2)
    v = rng.normal(size=(6, 3, 16)).astype(np.float32)  # L=3 < d=16
    a = jnp.asarray(np.einsum("nld,nle->nde", v, v))
    b = jnp.asarray(v.sum(1))
    x = np.asarray(spd_solve_path(a, b))
    assert np.isfinite(x).all()


def test_solver_for_picks_from_backend_and_width():
    # measured choice (scripts/time_solver.py): cuSOLVER/LAPACK on the
    # GPU at every width; on the CPU LAPACK below 128, factored above
    from safer2_recommender_tpu.ops import block_chol

    for d in (1, 32, 127, 128, 512, 1024):
        assert block_chol.solver_for("gpu", d) == "native"
    assert block_chol.solver_for("cpu", 32) == "native"
    assert block_chol.solver_for("cpu", 127) == "native"
    assert block_chol.solver_for("cpu", 128) == "factored"
    assert block_chol.solver_for("cpu", 512) == "factored"
    assert set(block_chol.SOLVERS) == {"native", "factored"}


@pytest.mark.parametrize("d", [32, 128])
def test_spd_solve_dispatches_to_chosen_path(d, monkeypatch):
    # spd_solve runs exactly the path solver_for names for this backend
    from safer2_recommender_tpu.ops import block_chol

    called = []
    for name, fn in list(block_chol.SOLVERS.items()):
        def spy(a, b, r, _name=name, _fn=fn):
            called.append(_name)
            return _fn(a, b, r)
        monkeypatch.setitem(block_chol.SOLVERS, name, spy)
    block_chol.spd_solve.clear_cache()
    rng = np.random.default_rng(d)
    a = _random_spd(rng, 4, d)
    b = jnp.asarray(rng.normal(size=(4, d)).astype(np.float32))
    block_chol.spd_solve(a, b)
    block_chol.spd_solve.clear_cache()
    assert called == [block_chol.solver_for(jax.default_backend(), d)]


def test_spd_solve_full_diagonal_ridge(spd_solve_path):
    # ridge [N, d]: a per-diagonal-element shift (the rotated direct path)
    rng = np.random.default_rng(8)
    d = 24
    a = _random_spd(rng, 7, d)
    b = jnp.asarray(rng.normal(size=(7, d)).astype(np.float32))
    ridge = rng.uniform(0.01, 0.5, (7, d)).astype(np.float32)
    x = np.asarray(spd_solve_path(a, b, jnp.asarray(ridge)))
    aa = np.asarray(a) + ridge[:, :, None] * np.eye(d)
    want = np.linalg.solve(aa, np.asarray(b)[..., None])[..., 0]
    np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-4)


def test_scrub_nonfinite_zeroes_bad_rows():
    from safer2_recommender_tpu.ops import block_chol

    x = jnp.asarray([[1.0, 2.0], [np.nan, 1.0], [np.inf, 0.0], [3.0, 4.0]])
    got = np.asarray(block_chol._scrub_nonfinite(x))
    np.testing.assert_array_equal(got, [[1, 2], [0, 0], [0, 0], [3, 4]])


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(4096, 32), (2048, 128), (1024, 256),
                                 (256, 512), (16, 512)])
def test_spd_solve_real_widths_on_gpu(gpu, n, d):
    # the sweeps' solve shapes on the card against float64 numpy
    from safer2_recommender_tpu.ops import block_chol

    rng = np.random.default_rng(n + d)
    g = rng.normal(size=(n, d, d)).astype(np.float32)
    a = np.einsum("nij,nkj->nik", g, g) / d
    b = rng.normal(size=(n, d)).astype(np.float32)
    ridge = rng.uniform(0.01, 0.5, n).astype(np.float32)
    x = np.asarray(block_chol.spd_solve(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(ridge)))
    want = np.linalg.solve(a.astype(np.float64)
                           + ridge[:, None, None] * np.eye(d),
                           b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-4)


# --------------------------------------------------------------------------
# Woodbury solves (ops/woodbury.py)
# --------------------------------------------------------------------------


def _woodbury_case(rng, n=12, l=6, d=128, uniform_wt=False):
    from safer2_recommender_tpu.ops.woodbury import SolveParams

    g = rng.normal(size=(d, d)).astype(np.float32)
    gram = jnp.asarray(g @ g.T / d)
    emb = rng.normal(size=(n, l, d)).astype(np.float32)
    length = rng.integers(1, l + 1, size=n)
    mask = (np.arange(l)[None, :] < length[:, None]).astype(np.float32)
    emb = emb * mask[:, :, None]
    wt = mask if uniform_wt else (
        rng.uniform(0.05, 2.0, size=(n, l)).astype(np.float32) * mask)
    r = rng.normal(size=(n, l)).astype(np.float32) * mask
    c0 = rng.uniform(0.01, 0.1, size=n).astype(np.float32)
    c1 = rng.uniform(0.001, 0.05, size=n).astype(np.float32)
    p = SolveParams(emb=jnp.asarray(emb), wt=jnp.asarray(wt),
                    r=jnp.asarray(r), c0=jnp.asarray(c0),
                    c1=jnp.asarray(c1))
    return p, gram


@pytest.mark.parametrize("uniform_wt", [True, False])
def test_woodbury_matches_direct(uniform_wt):
    from safer2_recommender_tpu.models import common
    from safer2_recommender_tpu.ops import woodbury

    rng = np.random.default_rng(0)
    p, gram = _woodbury_case(rng, uniform_wt=uniform_wt)
    a, rhs = common.assemble_from_params(p, gram)
    # assemble_from_params defers the ridge c0*I to the solver
    a = np.asarray(a) + np.asarray(p.c0)[:, None, None] * np.eye(a.shape[-1])
    want = np.linalg.solve(a, np.asarray(rhs)[..., None])[..., 0]

    eig = woodbury.maybe_eigh(gram, 128, use_cg=False)
    assert eig is not None
    got = np.asarray(woodbury.solve(p, *eig))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


def test_woodbury_gating():
    from safer2_recommender_tpu.ops import woodbury

    assert woodbury.maybe_eigh(jnp.eye(8), 8, use_cg=False) is None
    assert woodbury.maybe_eigh(jnp.eye(128), 128, use_cg=True) is None
    assert woodbury.applicable(64, 128)
    assert not woodbury.applicable(65, 128)


def test_grad_from_params_matches_dense():
    from safer2_recommender_tpu.models import common

    rng = np.random.default_rng(1)
    p, gram = _woodbury_case(rng, d=32)
    a, rhs = common.assemble_from_params(p, gram)
    a = np.asarray(a) + np.asarray(p.c0)[:, None, None] * np.eye(32)
    x = jnp.asarray(rng.normal(size=(12, 32)).astype(np.float32))
    want = np.einsum("nde,ne->nd", np.asarray(a), np.asarray(x)) - \
        np.asarray(rhs)
    got = np.asarray(common.grad_from_params(p, gram, x))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_solve_sweep_woodbury_matches_direct_path():
    # Same sweep through solve_sweep with and without the eigendecomposition
    # (dim=128 so the Woodbury gate is open; all histories < 64).
    from safer2_recommender_tpu import Dataset, DeviceData
    from safer2_recommender_tpu.models import common
    from safer2_recommender_tpu.ops import woodbury

    rng = np.random.default_rng(2)
    n = 3000
    pairs = np.unique(np.stack([rng.integers(0, 200, n),
                                rng.integers(0, 100, n)], 1), axis=0)
    ds = Dataset(pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32))
    dd = DeviceData.build(ds)
    d = 128
    key = jax.random.PRNGKey(0)
    table_other = jax.random.normal(key, (ds.num_items, d), jnp.float32) * 0.1
    gram = table_other.T @ table_other
    eig = woodbury.maybe_eigh(gram, d, use_cg=False)
    assert eig is not None

    def params_fn(b):
        reg = common.ials_reg(b.length, ds.num_items, 0.004, 1.0, 0.1)
        return common.params_ials(table_other, b, reg, 0.1)

    z = jnp.zeros((ds.num_users, d), jnp.float32)
    x_wood = np.asarray(common.solve_sweep(z, dd.by_user, params_fn, gram,
                                           eig=eig))
    x_direct = np.asarray(common.solve_sweep(z, dd.by_user, params_fn, gram,
                                             eig=None))
    np.testing.assert_allclose(x_wood, x_direct, rtol=5e-3, atol=5e-4)


def test_refresh_eigh_warm_and_cold_paths():
    # Warm-started spectral refresh (ops/woodbury.py::refresh_eigh):
    # after an ALS-sized Gramian drift, the warm (block-diagonal) path
    # must reconstruct the new Gramian about as well as f32 eigh itself,
    # with an orthogonal basis; a large jump must take the cold path.
    from safer2_recommender_tpu.ops import woodbury

    rng = np.random.default_rng(3)
    d = 256
    v = rng.normal(size=(2000, d)).astype(np.float32) / np.sqrt(d)
    v *= (1.0 / np.sqrt(np.arange(1, d + 1)))[None, :].astype(np.float32)
    g = jnp.asarray(v.T @ v)
    _, q = jnp.linalg.eigh(g)

    def rel_err(q_, lam_, g_):
        recon = np.asarray(q_) @ np.diag(np.asarray(lam_)) @ np.asarray(q_).T
        return np.linalg.norm(recon - g_) / np.linalg.norm(g_)

    qk = q
    for _ in range(4):
        v = v + 0.02 * rng.normal(size=v.shape).astype(np.float32) * np.abs(v)
        gk = v.T @ v
        # force the warm branch (tol=1: coupling check always passes)
        qk, lamk = woodbury.refresh_eigh(jnp.asarray(gk), qk, 1.0)
        assert np.linalg.norm(
            np.asarray(qk.T @ qk) - np.eye(d)) < 1e-3
        assert rel_err(qk, lamk, gk) < 5e-3

    # drifted-coupling detection: a completely different Gramian must
    # fall back to the full eigh under the default tolerance
    v2 = rng.normal(size=v.shape).astype(np.float32)
    g2 = v2.T @ v2
    q2, lam2 = woodbury.refresh_eigh(jnp.asarray(g2), qk, 2e-3)
    assert rel_err(q2, lam2, g2) < 1e-3
    # cold path sorts eigenvalues ascending (warm would not, and the old
    # basis cannot block-diagonalize an unrelated Gramian to 2e-3)
    assert np.all(np.diff(np.asarray(lam2)) >= -1e-4)


def test_spd_solve_ridge_param_matches_explicit(spd_solve_path):
    # the lazy diagonal shift must equal an explicit a + diag(ridge)
    rng = np.random.default_rng(7)
    for d in (16, 128):
        a = _random_spd(rng, 9, d)
        b = jnp.asarray(rng.normal(size=(9, d)).astype(np.float32))
        ridge = jnp.asarray(rng.uniform(0.01, 0.5, 9).astype(np.float32))
        x = np.asarray(spd_solve_path(a, b, ridge))
        aa = np.asarray(a) + np.asarray(ridge)[:, None, None] * np.eye(d)
        want = np.linalg.solve(aa, np.asarray(b)[..., None])[..., 0]
        np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("d", [16, 96, 128, 256])
def test_spd_solve_factored_path_matches_default(d):
    # the factored path agrees with the native one (the GPU's default)
    import functools

    from safer2_recommender_tpu.ops import block_chol

    rng = np.random.default_rng(11)
    a = _random_spd(rng, 13, d)
    b = jnp.asarray(rng.normal(size=(13, d)).astype(np.float32))
    ridge = jnp.asarray(rng.uniform(0.01, 0.3, 13).astype(np.float32))
    native, fact = (np.asarray(jax.jit(functools.partial(
        block_chol.solve_path, p))(a, b, ridge))
        for p in ("native", "factored"))
    np.testing.assert_allclose(fact, native, rtol=2e-3, atol=2e-4)


def test_epoch_eig_refresh_wiring_dim256():
    # At dim >= 256 the safer/ials epochs thread the warm eigenbasis
    # through MFState (eig_qu/eig_qv); the unit tests above cover
    # refresh_eigh itself — this covers the model wiring: bases update,
    # stay orthogonal, and training stays finite.
    from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model

    rng = np.random.default_rng(21)
    pairs = np.unique(np.stack([rng.integers(0, 120, 5000),
                                rng.integers(0, 60, 5000)], 1),
                      axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    dd = DeviceData.build(ds)
    d = 256
    m = get_model("safer2", Config(dim=d, bandwidth=0.15, alpha=0.3,
                                   seed=9, uobs_weight=0.01, l2_reg=0.01),
                  ds.num_users, ds.num_items)
    m.initialize(dd)
    eye = np.eye(d, dtype=np.float32)
    assert np.array_equal(np.asarray(m.state.eig_qu), eye)
    for _ in range(3):
        m.train_epoch(dd)
    qu = np.asarray(m.state.eig_qu)
    qv = np.asarray(m.state.eig_qv)
    assert not np.array_equal(qu, eye) and not np.array_equal(qv, eye)
    assert np.linalg.norm(qu.T @ qu - eye) < 1e-3
    assert np.linalg.norm(qv.T @ qv - eye) < 1e-3
    assert np.isfinite(np.asarray(m.state.user_loss)).all()
    # the basis must actually diagonalize the carried Gramian:
    # reconstruction through (qu, diag) should be close to item_gramian
    g = np.asarray(m.state.item_gramian)
    b = qu.T @ g @ qu
    off = b - np.diag(np.diag(b))
    assert np.linalg.norm(off) / np.linalg.norm(g) < 0.2


def test_epanechnikov_loss_matches_reference_tails():
    # The reference's epanechnikov_loss (safer2.h:636-647) gates the
    # out-of-support |u/h| term on `pos = uh > 1` ONLY: the LEFT tail
    # (uh < -1) gets ell = 0, not |uh| as He et al. 2021 Remark 3.1
    # would give. Pin both tails so the quirk stays replicated.
    h, alpha = 0.5, 0.3
    lin = (1.0 - alpha - 0.5)
    # right tail: ell = |uh| -> loss = h/2*|u/h| + lin*u
    u = jnp.float32(2.0)
    np.testing.assert_allclose(
        float(smoothing.epanechnikov_loss(u, h, alpha)),
        0.5 * h * (2.0 / h) + lin * 2.0, rtol=1e-6)
    # left tail: ell = 0 (the reference quirk) -> loss = lin*u only
    u = jnp.float32(-2.0)
    np.testing.assert_allclose(
        float(smoothing.epanechnikov_loss(u, h, alpha)),
        lin * -2.0, rtol=1e-6)


def test_solve_sweep_rotated_direct_matches_plain(monkeypatch):
    # Buckets too wide for Woodbury (width > dim/2) take the
    # eigenbasis-ROTATED direct path when eig is present (the c1*G term
    # becomes a [N, d] diagonal ridge); it must match the plain direct
    # path (eig=None) and the FRT_NO_ROTATE'd path.
    from safer2_recommender_tpu import Dataset, DeviceData
    from safer2_recommender_tpu.models import common
    from safer2_recommender_tpu.ops import woodbury

    rng = np.random.default_rng(4)
    # one hot user (width >> dim/2) + a tail of narrow ones
    hot = np.stack([np.zeros(150, np.int64), np.arange(150)], 1)
    tail = np.stack([rng.integers(1, 120, 2000),
                     rng.integers(0, 150, 2000)], 1)
    pairs = np.unique(np.concatenate([hot, tail]), axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    dd = DeviceData.build(ds)
    d = 128
    key = jax.random.PRNGKey(1)
    table_other = jax.random.normal(key, (ds.num_items, d), jnp.float32) * 0.1
    gram = table_other.T @ table_other
    eig = woodbury.maybe_eigh(gram, d, use_cg=False)
    widths = {b.width for b in dd.by_user}
    assert any(w > d // 2 for w in widths), widths   # direct bucket exists

    def params_fn(b, pre=None):
        reg = common.ials_reg(b.length, ds.num_items, 0.004, 1.0, 0.1)
        return common.params_ials(table_other, b, reg, 0.1, pre=pre)

    z = jnp.zeros((ds.num_users, d), jnp.float32)
    x_rot = np.asarray(common.solve_sweep(z, dd.by_user, params_fn, gram,
                                          eig=eig))
    x_plain = np.asarray(common.solve_sweep(z, dd.by_user, params_fn, gram,
                                            eig=None))
    np.testing.assert_allclose(x_rot, x_plain, rtol=5e-3, atol=5e-4)

    monkeypatch.setenv("FRT_NO_ROTATE", "1")
    x_norot = np.asarray(common.solve_sweep(z, dd.by_user, params_fn, gram,
                                            eig=eig))
    np.testing.assert_allclose(x_norot, x_plain, rtol=5e-3, atol=5e-4)
