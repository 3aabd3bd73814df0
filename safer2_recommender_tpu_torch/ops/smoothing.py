"""Smoothing kernels for the convolution-type smoothed CVaR objective
(the counterpart of ``safer2_recommender_tpu/ops/smoothing.py``).

  gaussian_kernel / _cdf / gaussian_loss         reference safer2.h:599-615
  epanechnikov_kernel / _cdf / epanechnikov_loss reference safer2.h:617-647

All functions are elementwise over tensors.
"""

from __future__ import annotations

import math

import torch

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_M_SQRT1_2 = math.sqrt(0.5)


def gaussian_kernel(u: torch.Tensor, h: float) -> torch.Tensor:
    z = (u / h) * _M_SQRT1_2
    return _INV_SQRT_2PI * torch.exp(-(z * z)) / h


def gaussian_cdf(u: torch.Tensor, h: float) -> torch.Tensor:
    return 0.5 * torch.special.erfc(-(u / h) * _M_SQRT1_2)


def gaussian_loss(u: torch.Tensor, h: float, alpha: float) -> torch.Tensor:
    ell = h * gaussian_kernel(u, h) + (u / h) * (
        1.0 - 2.0 * gaussian_cdf(-u, h))
    return (h / 2.0) * ell + ((1.0 - alpha) - 0.5) * u


def epanechnikov_kernel(u: torch.Tensor, h: float) -> torch.Tensor:
    uh = u / h
    in_supp = (torch.abs(uh) < 1.0).to(u.dtype)
    return (3.0 / 4.0) * (1.0 - uh * uh) * in_supp / h


def epanechnikov_cdf(u: torch.Tensor, h: float) -> torch.Tensor:
    uh = u / h
    in_supp = (torch.abs(uh) <= 1.0).to(u.dtype)
    pos = (uh > 1.0).to(u.dtype)
    h3 = h * h * h
    return ((1.0 / (4.0 * h3)) * ((3.0 * u * h * h - u * u * u) + 2.0 * h3)
            * in_supp) + (1.0 - in_supp) * pos


def epanechnikov_loss(u: torch.Tensor, h: float,
                      alpha: float) -> torch.Tensor:
    # The |uh| out-of-support term is gated on ``pos`` (uh > 1) ONLY:
    # for uh < -1 the reference returns ell = 0 although He et al. 2021
    # Remark 3.1 gives |uh| on both tails (safer2.h:636-647). The port
    # keeps the reference's left-tail discontinuity at u = -h.
    uh = u / h
    in_supp = (torch.abs(uh) <= 1.0).to(u.dtype)
    pos = (uh > 1.0).to(u.dtype)
    ell = ((3.0 / 4.0) * uh * uh - (1.0 / 8.0) * uh ** 4 + 3.0 / 8.0) \
        * in_supp + torch.abs(uh) * pos
    return 0.5 * h * ell + ((1.0 - alpha) - 0.5) * u


def kernel_fns(use_epanechnikov: bool):
    """(pdf, cdf, loss) triple selected like reference safer2.h:659-687."""
    if use_epanechnikov:
        return epanechnikov_kernel, epanechnikov_cdf, epanechnikov_loss
    return gaussian_kernel, gaussian_cdf, gaussian_loss


def dual_weight(loss: torch.Tensor, xi, h: float,
                use_epanechnikov: bool) -> torch.Tensor:
    """z-step weights: z_u = 1 - K_cdf(-(loss_u - xi); h)."""
    _, cdf, _ = kernel_fns(use_epanechnikov)
    return 1.0 - cdf(-(loss - xi), h)
