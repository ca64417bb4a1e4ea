"""Test harness config.

Runs everything on a virtual 8-device CPU mesh (the reference has no
multi-device tests at all — SURVEY.md section 4; we add them) unless
``JAX_PLATFORMS`` names the platform: ``JAX_PLATFORMS=cuda`` lets the
tests marked ``gpu`` see the card (README "Tests"). XLA_FLAGS must be
set before first backend use.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from safer2_recommender_tpu import Dataset, DeviceData, FoldInData  # noqa: E402

# The bundled ML-1M split (tests/ml-1m/*.csv.gz: 388,246 train tuples /
# 4,034 users / 3,468 items; 1,000 eval users) — public MovieLens-derived
# data, shipped gzipped IN THIS REPO so a bare clone runs every quality
# gate (the reference bundles the same split as bazel test data,
# reference BUILD:42-46). Override with FRECSYS_ML1M_DIR.
ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))


def ml1m_available() -> bool:
    base = os.path.join(ML1M_DIR, "train.csv")
    return os.path.exists(base) or os.path.exists(base + ".gz")


requires_ml1m = pytest.mark.skipif(
    not ml1m_available(), reason="ML-1M fixture not available")


def pytest_collection_modifyitems(config, items):
    """Randomized test order (the reference CI injects GTEST_SHUFFLE /
    GTEST_RANDOM_SEED, reference .bazelrc:18-21, so inter-test state
    dependence surfaces). ``FRT_TEST_SHUFFLE=<seed>`` shuffles the
    module order and the order within each module — module grouping is
    kept so expensive module/session fixtures (ml1m trains a model) are
    not rebuilt per test. The seed is printed for reproduction."""
    import random

    seed_env = os.environ.get("FRT_TEST_SHUFFLE", "")
    if not seed_env:
        return
    seed = int(seed_env)
    print(f"\n[conftest] shuffled test order, FRT_TEST_SHUFFLE={seed}")
    rng = random.Random(seed)
    groups, order = {}, []
    for it in items:
        key = it.module.__name__
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(it)
    rng.shuffle(order)
    for key in order:
        rng.shuffle(groups[key])
    items[:] = [it for key in order for it in groups[key]]


@pytest.fixture(autouse=True)
def _package_logger_propagates():
    """In-process CLI runs call utils.logging.setup(), which sets
    propagate=False on the package logger (so embedding apps don't get
    every line twice); that silently blinds pytest's caplog (a root-
    logger handler) for every test that runs AFTER a CLI test. Re-enable
    propagation per test so log assertions are order-independent."""
    import logging

    logging.getLogger("safer2_recommender_tpu").propagate = True
    yield


@pytest.fixture(scope="session")
def ml1m():
    """(train Dataset, DeviceData, FoldInData) for the bundled split."""
    if not ml1m_available():
        pytest.skip("ML-1M fixture not available")
    train = Dataset.from_csv(os.path.join(ML1M_DIR, "train.csv"))
    val_tr = Dataset.from_csv(os.path.join(ML1M_DIR, "validation_tr.csv"))
    val_te = Dataset.from_csv(os.path.join(ML1M_DIR, "validation_te.csv"))
    dd = DeviceData.build(train)
    fold = FoldInData.build(val_tr, val_te, num_items=train.num_items)
    return train, dd, fold


@pytest.fixture
def gpu():
    """JAX's GPU devices; skips the test when the GPU is not JAX's
    default backend. Tests that use it carry ``@pytest.mark.gpu``."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")
    return jax.devices()


@pytest.fixture(scope="session")
def tiny():
    """Small synthetic dataset for fast unit tests."""
    rng = np.random.default_rng(42)
    n, num_u, num_i = 4000, 150, 80
    u = rng.integers(0, num_u, n).astype(np.int32)
    i = rng.integers(0, num_i, n).astype(np.int32)
    pairs = np.unique(np.stack([u, i], 1), axis=0)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    dd = DeviceData.build(ds)
    return ds, dd
