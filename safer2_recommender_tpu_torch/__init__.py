"""safer2_recommender_tpu_torch: the PyTorch/CUDA port of
``safer2_recommender_tpu``.

The JAX package beside this one is the reference each part of the port
is held against. This package imports torch and numpy, never jax and
never ``safer2_recommender_tpu`` (whose ``__init__`` imports jax). Its
module names mirror the JAX package's, so each counterpart is easy to
find. Ported so far: SAFER2 from CSV to metrics and recommendations at
every dim (direct, Woodbury, rotated and wide solve paths), with the
batched small SPD solves on a hand-written CUDA kernel
(``csrc/chol_inverse.cu``) and the batched-dot probe's kernel
(``csrc/bdot.cu``). ROADMAP.md lists what is still to port.

Public entry points:
  Dataset, DeviceData, FoldInData   data layer
  SAFER2, get_model                 models
  Config                            hyperparameters
  EvaluationResult                  metrics
"""

from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.data.dataset import (Dataset, DeviceData,
                                                       FoldInData)
from safer2_recommender_tpu_torch.evaluation.metrics import EvaluationResult
from safer2_recommender_tpu_torch.models import SAFER2, get_model

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Dataset",
    "DeviceData",
    "FoldInData",
    "EvaluationResult",
    "SAFER2",
    "get_model",
    "__version__",
]
