"""Independent dense-numpy oracles for whole training epochs.

Every equivalence test elsewhere compares two of OUR code paths; these
re-derive an epoch per row with plain numpy linear algebra straight
from the reference's math (reference ials.h:88-144,187-224 and
safer2.h:104-221,266-334) and demand the bucketed/padded/solver-order
device pipeline reproduce it to float tolerance. Nothing is shared
with the implementation under test except the Config values.

Each ``oracle_*`` function trains the model one epoch (cvar_mf: two)
and returns its comparisons as ``(label, got, want, rtol, atol)``
tuples; the tests assert them, and ``chip_smoke.py`` runs the same
oracles on the card (``ORACLES``).
"""

import numpy as np
import pytest

from safer2_recommender_tpu import Config, Dataset, DeviceData, get_model


def small_dataset():
    """(Dataset, DeviceData): 90 users x 40 items, ~2k interactions."""
    rng = np.random.default_rng(42)
    pairs = np.unique(np.stack([rng.integers(0, 90, 2500),
                                rng.integers(0, 40, 2500)], 1),
                      axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return ds, DeviceData.build(ds)


@pytest.fixture()
def small():
    return small_dataset()


def assert_cases(cases):
    for label, got, want, rtol, atol in cases:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=label)


def _adj(ds):
    by_u, by_i = {}, {}
    for u, i in zip(np.asarray(ds.user_ids), np.asarray(ds.item_ids)):
        by_u.setdefault(int(u), []).append(int(i))
        by_i.setdefault(int(i), []).append(int(u))
    return by_u, by_i


def _init_tables(model, dd):
    """Model init tables exported to original id space."""
    out = model.export_state(dd)
    return (out["user_emb"].astype(np.float64),
            out["item_emb"].astype(np.float64))


@pytest.mark.parametrize("dim", [8, 128])
def test_ials_epoch_matches_numpy_oracle(small, dim):
    # dim 8 runs the direct batched-Cholesky path; dim 128 activates
    # the Woodbury exact solves + rotated direct assembly
    # (ops/woodbury.py MIN_DIM) — both must reproduce the dense oracle.
    assert_cases(oracle_ials(*small, dim=dim))


def oracle_ials(ds, dd, dim):
    cfg = Config(dim=dim, uobs_weight=0.1, l2_reg=0.003, l2_reg_exp=1.0,
                 stdev=0.1, compute_dtype="f32", seed=5)
    m = get_model("ials", cfg, ds.num_users, ds.num_items)
    u0, v0 = _init_tables(m, dd)
    by_u, by_i = _adj(ds)

    def reg(n_hist, n_choices):
        # reference ials.h:310-315
        return cfg.l2_reg * (n_hist + cfg.uobs_weight * n_choices)

    def sweep(table_self, table_other, adj, n_choices):
        # reference ials.h:317-365: G = V^T V once, then per-row exact
        # normal-equation solves against the FROZEN other side
        g = table_other.T @ table_other
        out = table_self.copy()
        for r, hist in adj.items():
            vh = table_other[hist]                       # [L, d]
            a = (cfg.uobs_weight * g + vh.T @ vh
                 + reg(len(hist), n_choices) * np.eye(cfg.dim))
            out[r] = np.linalg.solve(a, vh.sum(0))
        return out

    u1 = sweep(u0, v0, by_u, ds.num_items)
    v1 = sweep(v0, u1, by_i, ds.num_users)

    m.train_epoch(dd)
    got = m.export_state(dd)
    # f32 pipeline vs float64 oracle: absolute error grows with the
    # accumulation length (dim); observed max ~5e-5 at dim 128
    atol = 2e-5 * max(1, dim // 8)
    return [("user_emb", got["user_emb"], u1, 2e-4, atol),
            ("item_emb", got["item_emb"], v1, 2e-4, atol)]


def test_safer2_epoch_matches_numpy_oracle(small):
    # xi_iterations=0 keeps xi at its warm start (mean loss at epoch 0 —
    # safer2.h:819-838), so the oracle covers the z/U/V/Gramian/loss
    # wiring without re-deriving the Newton-Raphson machinery (that has
    # its own unit tests in test_ops.py).
    assert_cases(oracle_safer2(*small))


def oracle_safer2(ds, dd):
    cfg = Config(dim=8, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 bandwidth=0.15, xi_iterations=0, pd_iterations=1,
                 compute_dtype="f32", seed=5)
    m = get_model("safer2", cfg, ds.num_users, ds.num_items)
    m.initialize(dd)
    u0, v0 = _init_tables(m, dd)
    by_u, by_i = _adj(ds)
    nu, ni = ds.num_users, ds.num_items

    def losses(ue, ve):
        # reference safer2.h:85-101: mean observed + uobs u^T G u, / 2
        g = ve.T @ ve
        out = np.zeros(nu)
        for u, hist in by_u.items():
            p = ve[hist] @ ue[u]
            out[u] = 0.5 * (np.mean((p - 1.0) ** 2)
                            + cfg.uobs_weight * ue[u] @ g @ ue[u])
        return out

    loss0 = losses(u0, v0)
    xi = loss0.mean()       # warm start (epoch 0, steps == 0)

    # z-step (safer2.h:745-794, gaussian kernel cdf)
    from math import erf, sqrt
    dual = np.full(nu, cfg.alpha)
    for u in by_u:
        r = -(loss0[u] - xi) / cfg.bandwidth
        dual[u] = 1.0 - 0.5 * (1.0 + erf(r / sqrt(2.0)))

    # U-step (safer2.h:104-163): A = w (Σvv^T/|H| + uobs G) + reg I
    g = v0.T @ v0
    u_reg = cfg.l2_reg * (1.0 + cfg.uobs_weight * ni)
    u1 = u0.copy()
    for u, hist in by_u.items():
        vh = v0[hist]
        w = dual[u]
        a = (w * (vh.T @ vh / len(hist) + cfg.uobs_weight * g)
             + u_reg * np.eye(cfg.dim))
        u1[u] = np.linalg.solve(a, (w / len(hist)) * vh.sum(0))

    # V-step (safer2.h:166-221): dual-weighted Gramian + z/|H| weights
    gw = u1.T @ (u1 * dual[:, None])
    hist_size = np.zeros(nu)
    for u, hist in by_u.items():
        hist_size[u] = len(hist)
    item_reg_stat = np.zeros(ni)
    for i, users in by_i.items():
        item_reg_stat[i] = sum(1.0 / hist_size[u] for u in users)
    v1 = v0.copy()
    for i, users in by_i.items():
        uh = u1[users]
        wt = np.array([dual[u] / hist_size[u] for u in users])
        a = (cfg.uobs_weight * gw + (uh * wt[:, None]).T @ uh
             + cfg.l2_reg * (item_reg_stat[i] + cfg.alpha
                             * cfg.uobs_weight * nu) * np.eye(cfg.dim))
        v1[i] = np.linalg.solve(a, (uh * wt[:, None]).sum(0))

    m.train_epoch(dd)
    got = m.export_state(dd)
    present = hist_size > 0
    # the stored loss is phase-shifted: it describes the PRE-epoch model
    # (the reference's trailing ComputeUserLoss of the previous epoch)
    return [("user_emb", got["user_emb"], u1, 2e-4, 2e-5),
            ("item_emb", got["item_emb"], v1, 2e-4, 2e-5),
            ("dual_weight", got["dual_weight"][present], dual[present],
             1e-4, 1e-5),
            ("user_loss", got["user_loss"][present], loss0[present],
             2e-4, 2e-5)]


def test_erm_mf_epoch_matches_numpy_oracle(small):
    # Constant-alpha dual weighting + the item_reg sum(1/|H_u|) law
    # (reference erm_mf.h:91-210, :384-395, :580-586) — structurally the
    # safer2 oracle with z_u == alpha for every user and no xi machinery.
    assert_cases(oracle_erm_mf(*small))


def oracle_erm_mf(ds, dd):
    cfg = Config(dim=8, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 compute_dtype="f32", seed=5)
    m = get_model("erm_mf", cfg, ds.num_users, ds.num_items)
    m.initialize(dd)
    u0, v0 = _init_tables(m, dd)
    by_u, by_i = _adj(ds)
    nu, ni = ds.num_users, ds.num_items

    def losses(ue, ve):
        # reference erm_mf.h loss: (mean observed + uobs u^T G u) / 2
        g = ve.T @ ve
        out = np.zeros(nu)
        for u, hist in by_u.items():
            p = ve[hist] @ ue[u]
            out[u] = 0.5 * (np.mean((p - 1.0) ** 2)
                            + cfg.uobs_weight * ue[u] @ g @ ue[u])
        return out

    loss0 = losses(u0, v0)
    alpha = cfg.alpha

    # U-step (erm_mf.h:91-151): w == alpha for every user
    g = v0.T @ v0
    u_reg = cfg.l2_reg * (1.0 + cfg.uobs_weight * ni)
    u1 = u0.copy()
    for u, hist in by_u.items():
        vh = v0[hist]
        a = (alpha * (vh.T @ vh / len(hist) + cfg.uobs_weight * g)
             + u_reg * np.eye(cfg.dim))
        u1[u] = np.linalg.solve(a, (alpha / len(hist)) * vh.sum(0))

    # V-step (erm_mf.h:153-210): dual-weighted Gramian spans the FULL
    # table incl. id gaps (erm_mf.h:462-467); constant z == alpha
    gw = alpha * (u1.T @ u1)
    hist_size = np.zeros(nu)
    for u, hist in by_u.items():
        hist_size[u] = len(hist)
    item_reg_stat = np.zeros(ni)
    for i, users in by_i.items():
        item_reg_stat[i] = sum(1.0 / hist_size[u] for u in users)
    v1 = v0.copy()
    for i, users in by_i.items():
        uh = u1[users]
        wt = np.array([alpha / hist_size[u] for u in users])
        a = (cfg.uobs_weight * gw + (uh * wt[:, None]).T @ uh
             + cfg.l2_reg * (item_reg_stat[i] + cfg.alpha
                             * cfg.uobs_weight * nu) * np.eye(cfg.dim))
        v1[i] = np.linalg.solve(a, (uh * wt[:, None]).sum(0))

    m.train_epoch(dd)
    got = m.export_state(dd)
    present = hist_size > 0
    # dual weight is the CONSTANT alpha; stored loss is phase-shifted
    # (describes the pre-epoch model, PARITY.md section 5)
    return [("user_emb", got["user_emb"], u1, 2e-4, 2e-5),
            ("item_emb", got["item_emb"], v1, 2e-4, 2e-5),
            ("dual_weight", got["dual_weight"],
             np.full(nu, alpha), 1e-7, 1e-7),
            ("user_loss", got["user_loss"][present], loss0[present],
             2e-4, 2e-5)]


def test_cvar_mf_epoch_matches_numpy_oracle(small):
    # Two epochs: epoch 1 keeps the carried xi == 0 (steps == 0,
    # cvar_mf.h:710-726 computes only the loss) so every present user's
    # hard indicator is 1; epoch 2 exercises the exact alpha-quantile xi
    # (cvar_mf.h:582-595), the z indicator, the eta gradient steps
    # (cvar_mf.h:88-134) and the PRE-update-U V-step (cvar_mf.h:282-295).
    assert_cases(oracle_cvar_mf(*small))


def oracle_cvar_mf(ds, dd):
    cfg = Config(dim=8, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 stepsize=0.1, compute_dtype="f32", seed=5)
    m = get_model("cvar_mf", cfg, ds.num_users, ds.num_items)
    m.initialize(dd)
    u, v = _init_tables(m, dd)
    by_u, by_i = _adj(ds)
    nu, ni = ds.num_users, ds.num_items
    eta = cfg.stepsize
    u_reg = cfg.l2_reg * (1.0 + cfg.uobs_weight * ni)

    hist_size = np.zeros(nu)
    for uu, hist in by_u.items():
        hist_size[uu] = len(hist)
    present = hist_size > 0
    item_reg_stat = np.zeros(ni)
    for i, users in by_i.items():
        item_reg_stat[i] = sum(1.0 / hist_size[x] for x in users)
    item_reg = cfg.l2_reg * (item_reg_stat
                             + cfg.alpha * cfg.uobs_weight * nu)

    def losses(ue, ve):
        g = ve.T @ ve
        out = np.zeros(nu)
        for uu, hist in by_u.items():
            p = ve[hist] @ ue[uu]
            out[uu] = 0.5 * (np.mean((p - 1.0) ** 2)
                             + cfg.uobs_weight * ue[uu] @ g @ ue[uu])
        return out

    dual = np.full(nu, cfg.alpha)    # init value; gaps never updated
    xi = 0.0
    loss = None
    for epoch in range(2):
        loss = losses(u, v)
        if epoch > 0:
            # exact quantile: the floor(n*alpha)-th LARGEST loss over
            # the full vector (gaps included at 0), cvar_mf.h:582-595
            q = min(int(nu * cfg.alpha), nu - 1)
            xi = np.sort(loss)[nu - 1 - q]
        dual = np.where(present, (loss - xi >= 0.0).astype(float), dual)

        # U gradient step: u -= eta * (A u - rhs), A/rhs as in the
        # weighted-mean exact system (cvar_mf.h:88-134)
        g = v.T @ v
        u_prev = u.copy()
        for uu, hist in by_u.items():
            vh = v[hist]
            w = dual[uu]
            a_u = (w * (vh.T @ vh / len(hist) + cfg.uobs_weight * g)
                   @ u[uu] + u_reg * u[uu])
            rhs = (w / len(hist)) * vh.sum(0)
            u[uu] = u[uu] - eta * (a_u - rhs)

        # V gradient step against the PRE-update user embeddings
        # (cvar_mf.h:282-295) and the raw-dual-weighted full-table
        # Gramian (gap users contribute with their carried dual)
        gw = u_prev.T @ (u_prev * dual[:, None])
        v_new = v.copy()
        for i, users in by_i.items():
            uh = u_prev[users]
            wt = np.array([dual[x] / hist_size[x] for x in users])
            a_v = (cfg.uobs_weight * gw @ v[i]
                   + (uh * wt[:, None]).T @ (uh @ v[i])
                   + item_reg[i] * v[i])
            rhs = (uh * wt[:, None]).sum(0)
            v_new[i] = v[i] - eta * (a_v - rhs)
        v = v_new

        m.train_epoch(dd)

    got = m.export_state(dd)
    # epoch-2 indicator must be non-trivial or the test proves nothing
    assert 0 < dual[present].sum() < present.sum()
    return [("user_emb", got["user_emb"], u, 2e-4, 2e-5),
            ("item_emb", got["item_emb"], v, 2e-4, 2e-5),
            ("xi", got["xi"], xi, 1e-4, 1e-6),
            ("dual_weight", got["dual_weight"][present], dual[present],
             0.0, 0.0),
            ("user_loss", got["user_loss"][present], loss[present],
             2e-4, 2e-5)]


def _block_delta_step(x, vh, g, S, ch, cg, reg):
    """One reference block delta solve (ialspp.h:85-145 /
    safer2pp.h:97-159): A = ch*sum v_loc v_loc^T + cg*G_loc + reg*I,
    rhs = ch*sum v_loc (pred-1) + cg*G_lg@x + reg*x_loc,
    x_loc <- x_loc - A^-1 rhs. ``vh`` may carry per-slot weights via
    ``ch`` being a vector (SAFER2++ item sweep's z/|H_u|)."""
    pred = vh @ x
    vloc = vh[:, S]
    if np.ndim(ch) == 0:
        a = ch * (vloc.T @ vloc)
        r_h = ch * (vloc.T @ (pred - 1.0))
    else:
        a = (vloc * ch[:, None]).T @ vloc
        r_h = (vloc * ch[:, None]).T @ (pred - 1.0)
    a = a + cg * g[S, S] + reg * np.eye(S.stop - S.start)
    rhs = r_h + cg * (g[S, :] @ x) + reg * x[S]
    out = x.copy()
    out[S] = x[S] - np.linalg.solve(a, rhs)
    return out


def test_ialspp_frozen_epoch_matches_numpy_oracle(small):
    # The default (frozen-other-side) blockwise sweep: all U blocks
    # against frozen V, then all V blocks against the updated frozen U
    # (delta systems of ialspp.h:85-145; ordering argument in
    # models/common.py::block_sweep_frozen). dim 8 stays below the
    # Woodbury gate, so the genuine per-block path runs.
    assert_cases(oracle_ialspp(*small, interleaved=False))


def test_ialspp_interleaved_epoch_matches_numpy_oracle(small):
    # Reference-ORDER mode (--block_interleaved): per block s, StepU(s)
    # for all users then StepV(s) for all items, with the local /
    # local-global Gramians recomputed from the LIVE other table
    # (ialspp.h:208-261, :362-365).
    assert_cases(oracle_ialspp(*small, interleaved=True))


def oracle_ialspp(ds, dd, interleaved):
    if interleaved:
        return _oracle_ialspp_interleaved(ds, dd)
    cfg = Config(dim=8, block_size=4, uobs_weight=0.1, l2_reg=0.003,
                 l2_reg_exp=1.0, compute_dtype="f32", seed=5)
    m = get_model("ialspp", cfg, ds.num_users, ds.num_items)
    u0, v0 = _init_tables(m, dd)
    by_u, by_i = _adj(ds)
    blocks = [slice(k, k + cfg.block_size)
              for k in range(0, cfg.dim, cfg.block_size)]

    def reg(n_hist, n_choices):
        # freq-scaled iALS regularizer, exp 1 (ialspp RegularizationValue)
        return cfg.l2_reg * (n_hist + cfg.uobs_weight * n_choices)

    def sweep(table_self, table_other, adj, n_choices):
        g = table_other.T @ table_other
        out = table_self.copy()
        for r, hist in adj.items():
            x = out[r].copy()
            vh = table_other[hist]
            rg = reg(len(hist), n_choices)
            for S in blocks:
                x = _block_delta_step(x, vh, g, S, 1.0,
                                      cfg.uobs_weight, rg)
            out[r] = x
        return out

    u1 = sweep(u0, v0, by_u, ds.num_items)
    v1 = sweep(v0, u1, by_i, ds.num_users)

    m.train_epoch(dd)
    got = m.export_state(dd)
    return [("user_emb", got["user_emb"], u1, 2e-4, 2e-5),
            ("item_emb", got["item_emb"], v1, 2e-4, 2e-5)]


def _oracle_ialspp_interleaved(ds, dd):
    cfg = Config(dim=8, block_size=4, uobs_weight=0.1, l2_reg=0.003,
                 l2_reg_exp=1.0, compute_dtype="f32", seed=5,
                 block_interleaved=True)
    m = get_model("ialspp", cfg, ds.num_users, ds.num_items)
    u1, v1 = _init_tables(m, dd)
    by_u, by_i = _adj(ds)

    def reg(n_hist, n_choices):
        return cfg.l2_reg * (n_hist + cfg.uobs_weight * n_choices)

    for k in range(0, cfg.dim, cfg.block_size):
        S = slice(k, k + cfg.block_size)
        g = v1.T @ v1                      # live: previous blocks applied
        nxt = u1.copy()
        for r, hist in by_u.items():
            nxt[r] = _block_delta_step(u1[r], v1[hist], g, S, 1.0,
                                       cfg.uobs_weight,
                                       reg(len(hist), ds.num_items))
        u1 = nxt
        g = u1.T @ u1                      # live: includes this U block
        nxt = v1.copy()
        for r, hist in by_i.items():
            nxt[r] = _block_delta_step(v1[r], u1[hist], g, S, 1.0,
                                       cfg.uobs_weight,
                                       reg(len(hist), ds.num_users))
        v1 = nxt

    m.train_epoch(dd)
    got = m.export_state(dd)
    return [("user_emb", got["user_emb"], u1, 2e-4, 2e-5),
            ("item_emb", got["item_emb"], v1, 2e-4, 2e-5)]


def _safer2pp_setup(ds, cfg):
    by_u, by_i = _adj(ds)
    nu, ni = ds.num_users, ds.num_items
    hist_size = np.zeros(nu)
    for u, hist in by_u.items():
        hist_size[u] = len(hist)
    item_reg_stat = np.zeros(ni)
    for i, users in by_i.items():
        item_reg_stat[i] = sum(1.0 / hist_size[u] for u in users)
    item_reg = cfg.l2_reg * (item_reg_stat
                             + cfg.alpha * cfg.uobs_weight * nu)
    u_reg = cfg.l2_reg * (1.0 + cfg.uobs_weight * ni)

    def losses(ue, ve):
        g = ve.T @ ve
        out = np.zeros(nu)
        for u, hist in by_u.items():
            p = ve[hist] @ ue[u]
            out[u] = 0.5 * (np.mean((p - 1.0) ** 2)
                            + cfg.uobs_weight * ue[u] @ g @ ue[u])
        return out

    def dual_of(loss, xi):
        # vectorized gaussian z-step over ALL ids incl. gaps
        # (safer2pp.h:839-862)
        from math import erf, sqrt
        return np.array([1.0 - 0.5 * (1.0 + erf(
            (-(l - xi) / cfg.bandwidth) / sqrt(2.0))) for l in loss])

    return by_u, by_i, hist_size, item_reg, u_reg, losses, dual_of


@pytest.mark.parametrize("interleaved", [False, True])
def test_safer2pp_epoch_matches_numpy_oracle(small, interleaved):
    # Blockwise SAFER2: user blocks A = w(sum v_loc v_loc^T/|H| +
    # uobs G_loc) + reg I (safer2pp.h:97-159), item blocks against the
    # raw-dual-weighted Gramian with z/|H_u| slot weights
    # (safer2pp.h:161-216, :532-544). xi_iterations=0 keeps xi at its
    # epoch-0 warm start (mean loss), like the safer2 oracle. Frozen
    # order: all U blocks (V + V^TV frozen), then all V blocks;
    # interleaved order: per block StepU/StepV with LIVE Gramians
    # (safer2pp.h:303-319).
    assert_cases(oracle_safer2pp(*small, interleaved=interleaved))


def oracle_safer2pp(ds, dd, interleaved):
    cfg = Config(dim=8, block_size=4, uobs_weight=0.004, l2_reg=0.004,
                 alpha=0.3, bandwidth=0.15, xi_iterations=0,
                 pd_iterations=1, compute_dtype="f32", seed=5,
                 block_interleaved=interleaved)
    m = get_model("safer2pp", cfg, ds.num_users, ds.num_items)
    m.initialize(dd)
    u1, v1 = _init_tables(m, dd)
    (by_u, by_i, hist_size, item_reg, u_reg, losses,
     dual_of) = _safer2pp_setup(ds, cfg)

    loss0 = losses(u1, v1)
    xi = loss0.mean()                  # steps == 0 warm start
    dual = dual_of(loss0, xi)
    norm_dual = np.where(hist_size > 0,
                         dual / np.maximum(hist_size, 1.0), 0.0)
    blocks = [slice(k, k + cfg.block_size)
              for k in range(0, cfg.dim, cfg.block_size)]

    def u_block(S, u_tbl, v_tbl, g):
        nxt = u_tbl.copy()
        for r, hist in by_u.items():
            w = dual[r]
            nxt[r] = _block_delta_step(
                u_tbl[r], v_tbl[hist], g, S, w / len(hist),
                cfg.uobs_weight * w, u_reg)
        return nxt

    def v_block(S, v_tbl, u_tbl, gw):
        nxt = v_tbl.copy()
        for r, hist in by_i.items():
            wt = norm_dual[hist]
            nxt[r] = _block_delta_step(
                v_tbl[r], u_tbl[hist], gw, S, wt,
                cfg.uobs_weight, item_reg[r])
        return nxt

    if interleaved:
        for S in blocks:
            u1 = u_block(S, u1, v1, v1.T @ v1)              # live V^T V
            gw = u1.T @ (u1 * dual[:, None])                # live, raw z
            v1 = v_block(S, v1, u1, gw)
    else:
        g = v1.T @ v1                                       # frozen
        for S in blocks:
            u1 = u_block(S, u1, v1, g)
        gw = u1.T @ (u1 * dual[:, None])                    # frozen
        for S in blocks:
            v1 = v_block(S, v1, u1, gw)

    m.train_epoch(dd)
    got = m.export_state(dd)
    cases = [("user_emb", got["user_emb"], u1, 2e-4, 2e-5),
             ("item_emb", got["item_emb"], v1, 2e-4, 2e-5),
             ("dual_weight", got["dual_weight"], dual, 1e-4, 1e-5),
             ("xi", got["xi"], xi, 1e-4, 1e-6)]
    if interleaved:
        # interleaved mode stores the END-of-epoch loss (from the
        # carried prediction slots, safer2pp.h:611-652)
        present = hist_size > 0
        cases.append(("user_loss", got["user_loss"][present],
                      losses(u1, v1)[present], 2e-4, 2e-5))
    return cases


# Every oracle above, by name, with its arguments (chip_smoke.py).
ORACLES = {
    "ials_dim8": (oracle_ials, {"dim": 8}),
    "ials_dim128": (oracle_ials, {"dim": 128}),
    "safer2": (oracle_safer2, {}),
    "erm_mf": (oracle_erm_mf, {}),
    "cvar_mf": (oracle_cvar_mf, {}),
    "ialspp_frozen": (oracle_ialspp, {"interleaved": False}),
    "ialspp_interleaved": (oracle_ialspp, {"interleaved": True}),
    "safer2pp_frozen": (oracle_safer2pp, {"interleaved": False}),
    "safer2pp_interleaved": (oracle_safer2pp, {"interleaved": True}),
}
