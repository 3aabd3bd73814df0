"""The six models and the factory (the counterpart of
``safer2_recommender_tpu/models/__init__.py``)."""

from safer2_recommender_tpu_torch.models.base import MFState, Recommender
from safer2_recommender_tpu_torch.models.cvar_mf import CVaRMF
from safer2_recommender_tpu_torch.models.erm_mf import ERMMF
from safer2_recommender_tpu_torch.models.ials import IALS
from safer2_recommender_tpu_torch.models.ialspp import IALSpp
from safer2_recommender_tpu_torch.models.safer2 import SAFER2
from safer2_recommender_tpu_torch.models.safer2pp import SAFER2pp
from safer2_recommender_tpu_torch.utils.device import DEFAULT_DEVICE

MODEL_REGISTRY = {
    "ials": IALS,
    "ialspp": IALSpp,
    "erm_mf": ERMMF,
    "cvar_mf": CVaRMF,
    "safer2": SAFER2,
    "safer2pp": SAFER2pp,
}


def get_model(name: str, cfg, num_users: int, num_items: int,
              device=DEFAULT_DEVICE, mesh=None):
    """A model of ``name`` on ``device`` (the card unless the caller
    passes ``device="cpu"``; without CUDA the default raises), its state
    replicated over ``mesh`` when one is given (``parallel/mesh.py``;
    the device is then the mesh's)."""
    try:
        cls = MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; choose from {sorted(MODEL_REGISTRY)}"
        ) from None
    return cls(cfg, num_users, num_items, device=device, mesh=mesh)


__all__ = ["MFState", "Recommender", "IALS", "IALSpp", "ERMMF", "CVaRMF",
           "SAFER2", "SAFER2pp", "MODEL_REGISTRY", "get_model"]
