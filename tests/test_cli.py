"""CLI smoke tests (the reference's run_model surface,
tools/run_model.cc:125-274)."""

import os
import subprocess
import sys

import numpy as np
import pytest


def _write_csv(path, users, items):
    with open(path, "w") as f:
        f.write("uid,sid\n")
        for u, i in zip(users, items):
            f.write(f"{u},{i}\n")


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    rng = np.random.default_rng(0)
    pairs = np.unique(np.stack(
        [rng.integers(0, 60, 2000), rng.integers(0, 40, 2000)], 1), axis=0)
    u, i = pairs[:, 0], pairs[:, 1]
    _write_csv(d / "train.csv", u, i)
    # held-out users beyond the train id range, items within it
    vu = rng.integers(60, 80, 600)
    vi = rng.integers(0, 40, 600)
    _write_csv(d / "validation_tr.csv", vu, vi)
    _write_csv(d / "validation_te.csv", vu[:200], rng.integers(0, 40, 200))
    return d


def _run(args, csv_dir):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", "safer2_recommender_tpu.cli",
           "--train_data", str(csv_dir / "train.csv"),
           "--test_train_data", str(csv_dir / "validation_tr.csv"),
           "--test_test_data", str(csv_dir / "validation_te.csv"),
           ] + args
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)


def test_cli_end_to_end(csv_dir):
    res = _run(["--model_name", "safer2", "--dim", "8", "--epoch", "2",
                "--bandwidth", "0.3", "--print_train_stats", "0"], csv_dir)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Timer: Train=" in res.stderr
    assert "Mean NDCG@20=" in res.stderr
    assert "Rec CVaR (q=0.30)@5=" in res.stderr


def test_cli_rejects_unknown_model(csv_dir):
    res = _run(["--model_name", "nope"], csv_dir)
    assert res.returncode != 0
    assert "invalid choice" in res.stderr


def test_cli_rejects_missing_file(csv_dir):
    res = _run(["--model_name", "ials", "--train_data", "/no/such.csv"],
               csv_dir)
    assert res.returncode != 0
    assert "File does not exist" in res.stderr


def test_compilation_cache_in_checkout_when_env_unset(monkeypatch):
    import jax

    from safer2_recommender_tpu import cli

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cli.enable_compilation_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert os.path.isdir(path)
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compilation_cache_honors_env(monkeypatch, tmp_path):
    import jax

    from safer2_recommender_tpu import cli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    assert cli.enable_compilation_cache() == str(tmp_path / "c")
    # JAX reads the variable itself; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before
