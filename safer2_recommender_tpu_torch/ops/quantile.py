"""Smoothed-quantile (CtS-VaR) estimation: Newton-Raphson with Armijo
(the counterpart of ``safer2_recommender_tpu/ops/quantile.py``).

  evaluate_quantile  value, gradient, Hessian of the smoothed objective,
                     / alpha                     reference safer2.h:652-689
  xi_direction       Newton step + Armijo backtracking (c = 1e-4, at most
                     32 halvings)                reference safer2.h:692-712
  compute_xi         the NR loop, optionally sub-sampled
                                                 reference safer2.h:716-742

The Armijo test uses the gradient at the TRIAL point, as the reference
does (safer2.h:704). The loops run on the host: each Armijo test reads
one scalar back from the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from safer2_recommender_tpu_torch.ops import smoothing

_ARMIJO_C = 1e-4
_ARMIJO_MAX_HALVINGS = 32


def evaluate_quantile(xi: torch.Tensor, losses: torch.Tensor, *,
                      bandwidth: float, alpha: float, use_epanechnikov: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Value / gradient / Hessian of the smoothed quantile objective."""
    pdf, cdf, loss_fn = smoothing.kernel_fns(use_epanechnikov)
    r = losses - xi
    grad = (-(1.0 - alpha) + torch.mean(cdf(-r, bandwidth))) / alpha
    hess = torch.mean(pdf(-r, bandwidth)) / alpha
    value = torch.mean(loss_fn(r, bandwidth, alpha)) / alpha
    return value, grad, hess


def xi_direction(xi: torch.Tensor, losses: torch.Tensor, *,
                 bandwidth: float, alpha: float,
                 use_epanechnikov: bool) -> torch.Tensor:
    """One damped Newton step: returns -gamma * (grad/H) after Armijo."""
    kw = dict(bandwidth=bandwidth, alpha=alpha,
              use_epanechnikov=use_epanechnikov)
    f0, g0, h0 = evaluate_quantile(xi, losses, **kw)
    # A zero Hessian (Epanechnikov's compact support with no loss within
    # bandwidth of xi) takes no step instead of an infinite one.
    pos = h0 > 0
    d = torch.where(pos, g0 / torch.where(pos, h0, torch.ones_like(h0)),
                    torch.zeros_like(g0))

    def armijo_fails(gamma: float) -> bool:
        x = xi + gamma * (-d)
        fx, gx, _ = evaluate_quantile(x, losses, **kw)
        return bool(fx > f0 + _ARMIJO_C * gamma * gx * (-d))

    gamma, k = 1.0, 0
    while k < _ARMIJO_MAX_HALVINGS and armijo_fails(gamma):
        gamma *= 0.5
        k += 1
    return -gamma * d


def compute_xi(losses: torch.Tensor, prev_xi, generator: Optional[
               torch.Generator], *, nr_iterations: int, bandwidth: float,
               alpha: float, use_epanechnikov: bool, use_snr: bool,
               sampling_ratio: float) -> torch.Tensor:
    """NR loop from ``prev_xi``; returns xi as a 0-d float32 tensor.

    With SNR, each iteration draws ``int(n * sampling_ratio)`` losses
    uniformly *with replacement* (safer2.h:733-737) from ``generator``
    (a torch.Generator on the losses' device; its draws differ from the
    JAX package's ``jax.random`` ones).
    """
    n = losses.shape[0]
    num_samples = max(int(n * sampling_ratio), 1)
    kw = dict(bandwidth=bandwidth, alpha=alpha,
              use_epanechnikov=use_epanechnikov)
    xi = torch.as_tensor(prev_xi, dtype=torch.float32,
                         device=losses.device).clone()
    for _ in range(nr_iterations):
        if use_snr:
            inds = torch.randint(0, n, (num_samples,), generator=generator,
                                 device=losses.device)
            sample = losses[inds]
        else:
            sample = losses
        xi = xi + xi_direction(xi, sample, **kw)
    return xi
