"""safer2_recommender_tpu — an implicit-feedback recommender framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
riktor/safer2-recommender ("frecsys", the official SAFER2 implementation,
arXiv:2306.05292): six implicit-feedback matrix-factorization recommenders
(iALS, iALS++, ERM-MF, CVaR-MF, SAFER2, SAFER2++), a ranking-evaluation
engine (Recall@k / NDCG@k / metric-CVaR), a dataset pipeline, and a CLI.

Design (batched device programs, not a port):
  * The reference's per-user thread-pool loops (one d x d normal-equation
    solve per user, e.g. reference ials.h:317-365) become *batched* device
    programs: ragged user histories are bucketed into padded power-of-two
    tiles, normal equations are assembled as batched einsums and solved
    with batched Cholesky.
  * The reference's shared-memory Gramian reductions (ials.h:321,
    safer2.h:504-509) become full-table matmuls; on a device mesh they are
    sharded-batch matmuls whose partial results XLA all-reduces.
  * Scale-out is SPMD over a `jax.sharding.Mesh` ("data" axis = users/items
    rows); there is no separate communication backend — XLA collectives
    replace the reference's pthread mutexes (reference BUILD:46).

Public entry points:
  Dataset, DeviceData, FoldInData   — data layer
  IALS, IALSpp, ERMMF, CVaRMF, SAFER2, SAFER2pp — models
  Config                            — hyperparameter surface (reference
                                      tools/run_model.cc:129-231 parity)
"""

from safer2_recommender_tpu.config import Config
from safer2_recommender_tpu.data.dataset import Dataset, DeviceData, FoldInData
from safer2_recommender_tpu.evaluation.metrics import EvaluationResult
from safer2_recommender_tpu.serving import Server
from safer2_recommender_tpu.models import (
    CVaRMF,
    ERMMF,
    IALS,
    IALSpp,
    SAFER2,
    SAFER2pp,
    get_model,
)

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Dataset",
    "DeviceData",
    "FoldInData",
    "EvaluationResult",
    "IALS",
    "IALSpp",
    "ERMMF",
    "CVaRMF",
    "SAFER2",
    "SAFER2pp",
    "Server",
    "get_model",
    "__version__",
]
