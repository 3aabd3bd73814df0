"""Models ported so far, and the factory (the counterpart of
``safer2_recommender_tpu/models/__init__.py``)."""

from safer2_recommender_tpu_torch.models.base import MFState, Recommender
from safer2_recommender_tpu_torch.models.safer2 import SAFER2
from safer2_recommender_tpu_torch.utils.device import DEFAULT_DEVICE

MODEL_REGISTRY = {
    "safer2": SAFER2,
}


def get_model(name: str, cfg, num_users: int, num_items: int,
              device=DEFAULT_DEVICE):
    """A model of ``name`` on ``device`` (the card unless the caller
    passes ``device="cpu"``; without CUDA the default raises)."""
    try:
        cls = MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"model {name!r} is not ported to PyTorch; ported: "
            f"{sorted(MODEL_REGISTRY)} (ROADMAP Queue 1 lists the rest)"
        ) from None
    return cls(cfg, num_users, num_items, device=device)


__all__ = ["MFState", "Recommender", "SAFER2", "MODEL_REGISTRY",
           "get_model"]
