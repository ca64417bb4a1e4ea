"""Hyperparameter configuration.

Mirrors the flag surface of the reference CLI (reference
tools/run_model.cc:129-231) so a user of the reference can port commands
1:1. Defaults equal the reference defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    """All model hyperparameters (hashable so it can be closed over by jit).

    Fields map to reference flags:
      dim               --dim              (run_model.cc:133)
      uobs_weight       --uobs_weight      (run_model.cc:136)
      l2_reg            --l2_reg           (run_model.cc:140)
      l2_reg_exp        --l2_reg_exp       (run_model.cc:143)
      stdev             --stdev            (run_model.cc:147)
      block_size        --block_size       (run_model.cc:174)
      alpha             --alpha            (run_model.cc:178)
      bandwidth         --bandwidth        (run_model.cc:179)
      stepsize          --stepsize         (run_model.cc:181)
      xi_iterations     --xi_iterations    (run_model.cc:183)
      sampling_ratio    --sampling_ratio   (run_model.cc:187)
      pd_iterations     --pd_iterations    (run_model.cc:192)
      use_epanechnikov  --use_epanechnikov (run_model.cc:196)
      use_snr           --use_snr          (run_model.cc:200)
      use_cg            --use_cg           (run_model.cc:172)
      cg_error_tolerance / cg_max_iterations (run_model.cc:165-170)
      epochs            --epoch            (run_model.cc:203)
    """

    dim: int = 8
    uobs_weight: float = 0.1
    l2_reg: float = 0.002
    l2_reg_exp: float = 1.0
    stdev: float = 0.1
    block_size: int = 64
    alpha: float = 0.3
    bandwidth: float = 1.0
    stepsize: float = 0.1
    xi_iterations: int = 5
    sampling_ratio: float = 0.1
    pd_iterations: int = 1
    use_epanechnikov: bool = False
    use_snr: bool = False
    use_cg: bool = False
    # History-embedding dtype for normal-equation assembly: "bf16"
    # gathers and multiplies the history slabs in bfloat16 with f32
    # accumulation; "f32" keeps float32; "auto" is f32 on every
    # backend (bf16 is faster on the GPU but moves dim-512 fold-in
    # embeddings too far, PERF.md).
    compute_dtype: str = "auto"   # "auto" | "f32" | "bf16"
    cg_error_tolerance: float = 1e-10
    cg_max_iterations: int = 100
    epochs: int = 50

    # --- knobs with no reference equivalent ---
    # Random seed for explicit PRNG keys. The reference seeds from
    # std::random_device (ials.h:48-49) and is non-reproducible by design;
    # we improve on that with explicit keys.
    seed: int = 0
    # Number of eval users scored per device program (full-catalog matmul
    # chunking; keeps the [chunk, num_items] score matrix in memory bounds).
    eval_chunk: int = 1024
    # Fold-in epochs for the blockwise (++) models' held-out evaluation;
    # the reference hard-codes 8 (ialspp.h:152, safer2pp.h:223).
    eval_fold_in_epochs: int = 8
    # Warm-started spectral refresh for the Woodbury path's shared-
    # Gramian eigendecomposition (ops/woodbury.py::refresh_eigh): reuse
    # the previous sweep's eigenbasis and re-diagonalize only 128-wide
    # blocks, falling back to a full eigh when the dropped cross-block
    # coupling exceeds this relative tolerance. Per-epoch Gramian drift
    # on ML-1M dim=512 is 2-7.5e-2 early in training; 8e-2 keeps the
    # warm path active from epoch 1 and stays in the noise class of the
    # bf16 normal-equation assembly (measured NDCG@20 0.3295 at 8e-2 /
    # 0.3287 at 3e-2 / 0.3291 with exact eigh, 10-epoch dim-512 ML-1M
    # head-to-head). 0 disables (always full eigh).
    eig_refresh_tol: float = 8e-2
    # Reference-ORDER blockwise training for the ++ models: per block,
    # StepU then StepV (ialspp.h:208-261, safer2pp.h:303-319), with
    # live per-block Gramians and cross-view prediction carries
    # (models/common.py::block_sweep_interleaved). Default off: the
    # phase-separated frozen sweep gathers each history slab once per
    # sweep instead of once per block and converges with the exact
    # solvers; this mode reproduces the reference's exact
    # update trajectory where that difference matters (BASELINE.md
    # round-3 head-to-head analysis). Requires dim % block_size == 0
    # (falls back to the frozen sweep otherwise).
    block_interleaved: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
