# Runnable image for CPU execution / dataset prep (the reference ships a
# python:3.8-slim + bazel image, reference Dockerfile:1-15). On an
# NVIDIA GPU host, install jax[cuda12] instead of jax[cpu].
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /workspace
COPY pyproject.toml README.md ./
COPY safer2_recommender_tpu ./safer2_recommender_tpu
RUN pip install --no-cache-dir -e .[data,checkpoint,test] jax[cpu]

COPY tests ./tests
COPY bench.py ./

ENTRYPOINT ["python", "-m", "safer2_recommender_tpu.cli"]
