"""Hyperparameter configuration (a copy of
``safer2_recommender_tpu.config.Config``, so both packages read one
flag surface).

Mirrors the flag surface of the reference CLI (reference
tools/run_model.cc:129-231) so a user of the reference can port commands
1:1. Defaults equal the reference defaults.

Every field of the JAX package's Config is here, so its values carry
over unchanged.
"""

from __future__ import annotations

import dataclasses


# The JAX package's default ``eig_refresh_tol`` (its TPU trade between
# the warm refresh and a full eigh); the port's default is 0.
JAX_EIG_REFRESH_TOL = 8e-2


@dataclasses.dataclass(frozen=True)
class Config:
    """All model hyperparameters (frozen, so a model's config cannot
    drift under it).

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
    # History-embedding dtype for normal-equation assembly. "bf16"
    # gathers the history slabs in bfloat16 and accumulates their
    # products in float32, rounding where the JAX package rounds; the
    # tables, systems and solves stay float32. "f32" assembles in
    # float32. "auto" is "f32" in the port, bit for bit (the JAX package
    # picks bfloat16 on a TPU): choosing bfloat16 for it on the card
    # waits for an f32-vs-bf16 A/B on a benchmark cell (ROADMAP item 8).
    compute_dtype: str = "auto"   # "auto" | "f32" | "bf16"
    cg_error_tolerance: float = 1e-10
    cg_max_iterations: int = 100
    epochs: int = 50

    # --- additions of the JAX package (no reference equivalent) ---
    # Seed of the model's torch.Generator (initial tables, SNR draws).
    # The reference seeds from std::random_device (ials.h:48-49).
    seed: int = 0
    # Number of eval users scored per chunk (bounds the
    # [chunk, num_items] score matrix).
    eval_chunk: int = 1024
    # Fold-in sweeps of the blockwise (++) models' evaluation (the
    # reference hard-codes 8, ialspp.h:152).
    eval_fold_in_epochs: int = 8
    # Warm-started eigh refresh tolerance of the Woodbury path at
    # dim >= 256 (ops/woodbury.py::refresh_eigh); 0 takes a full eigh
    # every sweep, and is the port's default: on the H100 the full
    # float64 eigh is exact and faster at every measured shape (256 in
    # 2.21 ms where the warm [2, 128] blocks take 3.33; 512 in 4.91
    # where [4, 128] take 6.59; PERF.md), and the warm branch keeps
    # Q_prev blkdiag(B_kk) Q_prev^T, dropping up to the tolerance's
    # share of the Gramian's norm. The JAX package's 0.08
    # (JAX_EIG_REFRESH_TOL) is its TPU trade; passing it takes the
    # JAX package's warm branch, bit for bit.
    eig_refresh_tol: float = 0.0
    # Reference-order blockwise training of the ++ models (per block,
    # StepU then StepV); needs dim % block_size == 0, otherwise the
    # frozen sweep runs with a warning, as in the JAX package.
    block_interleaved: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
