"""chip_smoke.py's phases at tiny sizes on the CPU, and the GPU guards.

``chip_smoke.main`` itself refuses any backend but the GPU; these tests
drive each phase function directly so the script's control flow and
checks are exercised where there is no card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def smoke(monkeypatch, tmp_path):
    # keep the CLI phase's persistent compilation cache out of the repo
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    import chip_smoke

    return chip_smoke


def test_phase_solver_small_shapes(smoke):
    errs = smoke.phase_solver(((64, 16), (8, 40), (4, 130)))
    assert set(errs) == {(64, 16), (8, 40), (4, 130)}
    assert max(errs.values()) < smoke.SOLVER_RTOL


def test_phase_oracles_subset(smoke):
    out = smoke.phase_oracles(names=("ials_dim8", "safer2"))
    assert set(out) == {"ials_dim8", "safer2"}
    for high, default in out.values():
        assert high <= 1.0 and default <= 1.0


def test_tolerance_ratio():
    import chip_smoke

    cases = [("a", np.array([1.0, 2.0]), np.array([1.0, 2.002]), 1e-3, 0.0)]
    assert chip_smoke._tolerance_ratio(cases) == pytest.approx(
        0.002 / 0.002002, rel=1e-6)
    exact = [("b", np.array([3.0]), np.array([3.0]), 0.0, 0.0)]
    assert chip_smoke._tolerance_ratio(exact) == 0.0


def test_phase_cli_two_epochs(smoke):
    ndcg = smoke.phase_cli(epochs=2, min_ndcg=0.1)
    assert 0.1 <= ndcg <= 1.0


def test_phase_cli_rejects_low_ndcg(smoke):
    with pytest.raises(AssertionError, match="NDCG@20"):
        smoke.phase_cli(epochs=1, min_ndcg=0.99)


@pytest.fixture(scope="module")
def trained_small():
    import chip_smoke

    return chip_smoke.phase_full_width(users=400, items=300, dim=16,
                                       fold_users=60)


def test_phase_full_width_keeps_safer2(trained_small):
    model, ds = trained_small
    assert model.name == "safer2"
    assert ds.num_users == 400 and ds.num_items == 300


def test_phase_serving_small(trained_small):
    import chip_smoke

    model, ds = trained_small
    n = chip_smoke.phase_serving(model, ds, batch_sizes=(16, 64),
                                 widths=(32, 128), k=10,
                                 sizes=(16, 40, 64, 5))
    assert n == 4


def test_check_topk_rejects_wrong_ids(trained_small):
    import bench
    import chip_smoke

    model, ds = trained_small
    req = bench._serve_batch(ds, 8, seed=3)
    users, ids = model.recommend(req, k=10)
    chip_smoke._check_topk(model, req, users, (ids,), 10)
    # shifted ids land far from each user's top 10
    bad = (ids + 150) % ds.num_items
    with pytest.raises(AssertionError):
        chip_smoke._check_topk(model, req, users, (bad,), 10)


def test_phase_four_cards_on_cpu_mesh():
    import chip_smoke

    out = chip_smoke.phase_four_cards(users=400, items=300, dim=16,
                                      fold_users=64)
    assert set(out) == {"safer2", "safer2pp"}


def test_gathered_square_batches():
    import chip_smoke

    hlo = ("%ag = f32[64,512,512]{2,1,0} all-gather(%p), dimensions={0}\n"
           "%ag2 = f32[64,512]{1,0} all-gather(%q), dimensions={0}\n"
           "%ag3 = f32[8,16,16]{2,1,0} all-gather-done(%r)\n")
    assert chip_smoke.gathered_square_batches(hlo, 512) == [(64, 512, 512)]
    assert chip_smoke.gathered_square_batches(hlo, 16) == [
        (64, 512, 512), (8, 16, 16)]


def test_workload_fold_is_disjoint_split():
    import chip_smoke

    ds, tr, te = chip_smoke.workload(200, 100, 50, seed=4)
    assert ds.num_users == 200
    pairs = lambda d: set(zip(d.user_ids.tolist(), d.item_ids.tolist()))
    assert not pairs(tr) & pairs(te)
    assert tr.nnz > 3 * te.nnz


def test_main_refuses_cpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_script_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
