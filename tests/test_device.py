"""Device naming, GPU guards and device-scaled memory budgets."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_require_gpu_refuses_cpu():
    from safer2_recommender_tpu.utils.device import require_gpu

    if jax.default_backend() == "gpu":
        pytest.skip("a GPU is JAX's backend here")
    with pytest.raises(SystemExit, match="needs a GPU"):
        require_gpu()


@pytest.mark.gpu
def test_require_gpu_names_the_card(gpu):
    from safer2_recommender_tpu.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    dev = require_gpu()
    assert dev["platform"] == "gpu" and dev["count"] == len(gpu)
    assert "W" in card_name_and_power_limit()


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "needs a GPU" in res.stderr
    assert res.stdout.strip() == ""


def test_bench_time_epochs_blocks_on_state():
    import bench

    class Model:
        def __init__(self):
            self.calls = []
            self.state = jax.numpy.zeros(3)

        def train_epochs(self, dd, n):
            self.calls.append(n)
            self.state = self.state + n

    m = Model()
    per_epoch = bench.time_epochs(m, None, bench_epochs=4, reps=2)
    assert m.calls == [4, 4, 4]           # warm-up + two timed chains
    assert per_epoch >= 0.0
    np.testing.assert_array_equal(np.asarray(m.state), 12.0)


def test_memory_budget_keeps_value_without_stats():
    from safer2_recommender_tpu.parallel.mesh import memory_budget

    if jax.devices()[0].memory_stats():
        pytest.skip("this backend reports memory stats")
    assert memory_budget(2 << 30) == 2 << 30


@pytest.mark.parametrize("limit,expect", [(16 << 30, 2 << 30),
                                          (64 << 30, 8 << 30),
                                          (8 << 30, 1 << 30)])
def test_memory_budget_scales_with_device_memory(monkeypatch, limit, expect):
    from safer2_recommender_tpu.parallel import mesh as pmesh

    monkeypatch.setattr(jax, "devices",
                        lambda: [_FakeDevice({"bytes_limit": limit})])
    assert pmesh.memory_budget(2 << 30) == expect


def test_bucket_budgets_follow_device(monkeypatch):
    from safer2_recommender_tpu.data import dataset

    monkeypatch.setattr(jax, "devices",
                        lambda: [_FakeDevice({"bytes_limit": 32 << 30})])
    rows, tuples = dataset._bucket_budgets(512, None)
    assert rows == (4 << 30) // (512 * 512 * 4)
    assert tuples == (4 << 30) // (2 * 512 * 4)
    # an explicit budget is taken as given
    assert dataset._bucket_budgets(512, 2 << 30)[0] == 2048


def test_compute_dtype_auto_is_f32():
    # auto keeps f32 assembly on every backend (PERF.md: bf16 moved
    # dim-512 fold-ins too far on the GPU); bf16 stays an explicit choice
    from safer2_recommender_tpu import Config, get_model

    auto = get_model("ials", Config(dim=8, compute_dtype="auto"), 10, 10)
    assert auto.asm_dtype is None
    m = get_model("ials", Config(dim=8, compute_dtype="f32"), 10, 10)
    assert m.asm_dtype is None
    m = get_model("ials", Config(dim=8, compute_dtype="bf16"), 10, 10)
    assert m.asm_dtype == jax.numpy.bfloat16
