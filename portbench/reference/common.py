"""Plain PyTorch pieces of the reference epochs and fold-in.

Straight from the SAFER2 paper's updates (Togashi et al., arXiv:2306.05292)
as the reference C++ computes them (``safer2.h``, ``safer2pp.h``): every
row's normal equations are assembled densely and solved by a Cholesky
factorization, with no Woodbury identity, eigenbasis, bucketing or
kernel. Nothing here imports the measured program: the tables it starts
from are the benchmark's, and whatever the program derives (Gramians,
regularizer statistics) is worked out again here. One thing is taken as
given: the order in which the program numbers its users, which its
sub-sampled Newton draws index (``compute_xi``); the run reads it once
at set-up and hands it to both sides as shared input.

Precision: ``Prec(torch.float64)`` is the reference; ``Prec(torch.float32,
tf32=True)`` is the control (the nearest precision below the
configuration's float32 with TF32 off).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, Tuple

import numpy as np
import torch

# slots of one gathered [rows, width, dim] slab, and rows of one batch of
# dense [rows, dim, dim] systems
SLAB_SLOTS = 1 << 21
MAX_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class Prec:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    @contextlib.contextmanager
    def matmul(self):
        """Matrix products in TF32 (the control) or in full precision,
        by the CUDA backend's own knob."""
        be = torch.backends.cuda.matmul
        old = be.fp32_precision
        be.fp32_precision = "tf32" if self.tf32 else "ieee"
        try:
            yield
        finally:
            be.fp32_precision = old


class Side:
    """One side's histories in CSR form on the device: row r's columns
    are ``cols[indptr[r]:indptr[r + 1]]`` (duplicates kept, as slots)."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, num_rows: int,
                 device):
        r = torch.from_numpy(rows.astype(np.int64)).to(device)
        order = torch.sort(r, stable=True).indices
        self.lengths = np.bincount(rows, minlength=num_rows).astype(np.int64)
        self.indptr = np.concatenate(([0], np.cumsum(self.lengths)))
        self.num_rows = num_rows
        self.device = device
        self.cols = torch.from_numpy(cols.astype(np.int64)).to(device)[order]
        self.rows_of_slot = r[order]
        self.by_len = np.argsort(self.lengths, kind="stable")

    def groups(self, rows: np.ndarray = None) -> Iterator[np.ndarray]:
        """``rows`` (default: every row with a history) in batches of
        rows of similar length."""
        rows = self.by_len if rows is None else rows[
            np.argsort(self.lengths[rows], kind="stable")]
        rows = rows[self.lengths[rows] > 0]
        lo = 0
        while lo < rows.size:
            hi = min(lo + MAX_ROWS, rows.size)
            while hi - lo > 1 and (hi - lo) * self.lengths[rows[hi - 1]] \
                    > SLAB_SLOTS:
                hi = lo + max((hi - lo) // 2, 1)
            yield rows[lo:hi]
            lo = hi

    def slabs(self, rows: np.ndarray):
        """``(row index [N, w], slot mask [N, w])`` column chunks covering
        the histories of ``rows``."""
        dev = self.device
        lens = torch.from_numpy(self.lengths[rows]).to(dev)
        starts = torch.from_numpy(self.indptr[rows]).to(dev)
        width = int(self.lengths[rows].max())
        step = max(SLAB_SLOTS // rows.size, 1)
        for c0 in range(0, width, step):
            pos = c0 + torch.arange(min(step, width - c0), device=dev)
            mask = pos[None, :] < lens[:, None]
            slot = torch.where(mask, starts[:, None] + pos[None, :], 0)
            yield slot, mask


def row_systems(side: Side, other: torch.Tensor, rows: np.ndarray,
                slot_weight: torch.Tensor, prec: Prec
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row r of ``rows``: S_r = sum_h w_h o_h o_h^T and b_r = sum_h
    w_h o_h over its history h (``o`` the rows of ``other``, ``w`` the
    per-slot weights ``slot_weight``, indexed by slot)."""
    n, d = rows.size, other.shape[1]
    s = torch.zeros((n, d, d), dtype=prec.dtype, device=other.device)
    b = torch.zeros((n, d), dtype=prec.dtype, device=other.device)
    with prec.matmul():
        for slot, mask in side.slabs(rows):
            emb = other[side.cols[slot]]
            w = torch.where(mask, slot_weight[slot], 0.0).to(prec.dtype)
            we = emb * w[:, :, None]
            s.baddbmm_(we.transpose(1, 2), emb)
            b += we.sum(dim=1)
    return s, b


def spd_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve a x = rhs for SPD a [N, d, d] by Cholesky."""
    fac = torch.linalg.cholesky(a)
    return torch.cholesky_solve(rhs[:, :, None], fac)[:, :, 0]


def exact_rows(s, b, g, cg, reg, prec: Prec) -> torch.Tensor:
    """argmin of each row's system: (S + cg G + reg I) x = b; ``s`` is
    overwritten."""
    a = s.add_(cg[:, None, None] * g[None])
    a.diagonal(dim1=1, dim2=2).add_(reg[:, None])
    return spd_solve(a, b)


def block_rows(x, s, b, g, cg, reg, bs: int, prec: Prec) -> torch.Tensor:
    """One pass of block coordinate descent over the dim in blocks of
    ``bs`` (safer2pp.h:97-216): for each block, A = S_loc + cg G_loc +
    reg I, rhs = (S x - b)_loc + cg (G x)_loc + reg x_loc, x_loc -= A^-1 rhs."""
    x = x.clone()
    d = g.shape[0]
    with prec.matmul():
        for lo in range(0, d, bs):
            hi = min(lo + bs, d)
            eye = torch.eye(hi - lo, dtype=prec.dtype, device=g.device)
            a = (s[:, lo:hi, lo:hi] + cg[:, None, None] * g[lo:hi, lo:hi]
                 + reg[:, None, None] * eye)
            rhs = ((s[:, lo:hi, :] @ x[:, :, None])[:, :, 0] - b[:, lo:hi]
                   + cg[:, None] * (x @ g[lo:hi].T) + reg[:, None]
                   * x[:, lo:hi])
            x[:, lo:hi] = x[:, lo:hi] - spd_solve(a, rhs)
    return x


def user_losses(side: Side, u: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, uobs: float, prec: Prec) -> torch.Tensor:
    """Per-user halved loss 0.5 (mean_h (v_h . u - 1)^2 + uobs u^T G u)
    (safer2.h:85-101); users with no history 0."""
    out = torch.zeros(side.num_rows, dtype=prec.dtype, device=u.device)
    with prec.matmul():
        reg_term = ((u @ g) * u).sum(dim=1)
        for rows in side.groups():
            r = torch.from_numpy(rows).to(u.device)
            sq = torch.zeros(rows.size, dtype=prec.dtype, device=u.device)
            for slot, mask in side.slabs(rows):
                pred = (v[side.cols[slot]] * u[r][:, None, :]).sum(dim=2)
                sq += torch.where(mask, (pred - 1.0) ** 2, 0.0).sum(dim=1)
            lens = torch.from_numpy(side.lengths[rows]).to(u.device)
            out[r] = 0.5 * (sq / lens + uobs * reg_term[r])
    return out


# --------------------------------------------------------------------------
# the smoothed quantile (safer2.h:599-742) and the z-step (safer2.h:745-794)
# --------------------------------------------------------------------------

_SQRT1_2 = math.sqrt(0.5)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _pdf(u, h):
    z = (u / h) * _SQRT1_2
    return _INV_SQRT_2PI * torch.exp(-(z * z)) / h


def _cdf(u, h):
    return 0.5 * torch.special.erfc(-(u / h) * _SQRT1_2)


def _sloss(u, h, alpha):
    ell = h * _pdf(u, h) + (u / h) * (1.0 - 2.0 * _cdf(-u, h))
    return (h / 2.0) * ell + ((1.0 - alpha) - 0.5) * u


def dual_weight(loss, xi, h):
    """z_u = 1 - K_cdf(-(loss_u - xi); h), the gaussian kernel."""
    return 1.0 - _cdf(-(loss - xi), h)


def _quantile(xi, losses, h, alpha):
    r = losses - xi
    grad = (-(1.0 - alpha) + torch.mean(_cdf(-r, h))) / alpha
    hess = torch.mean(_pdf(-r, h)) / alpha
    value = torch.mean(_sloss(r, h, alpha)) / alpha
    return value, grad, hess


def xi_step(xi, losses, h, alpha):
    """One Newton step with Armijo backtracking (c = 1e-4, at most 32
    halvings; the test reads the gradient at the trial point, as
    safer2.h:704 does)."""
    f0, g0, h0 = _quantile(xi, losses, h, alpha)
    d = g0 / h0 if float(h0) > 0 else torch.zeros_like(g0)
    gamma = 1.0
    for _ in range(32):
        x = xi - gamma * d
        fx, gx, _ = _quantile(x, losses, h, alpha)
        if not bool(fx > f0 + 1e-4 * gamma * gx * (-d)):
            break
        gamma *= 0.5
    return xi - gamma * d


def compute_xi(loss, warm, cfg: dict, gen: torch.Generator,
               order: torch.Tensor):
    """The sub-sampled Newton-Raphson loop (safer2.h:716-742): each
    iteration draws int(n * sampling_ratio) losses uniformly with
    replacement; the draws are ``gen``'s, indexing the losses in
    ``order`` (position -> user id, the program's numbering)."""
    n = loss.shape[0]
    m = max(int(n * cfg["sampling_ratio"]), 1)
    xi = warm
    ordered = loss[order]
    for _ in range(cfg["xi_iterations"]):
        if cfg["use_snr"]:
            inds = torch.randint(0, n, (m,), generator=gen,
                                 device=loss.device)
            sample = ordered[inds]
        else:
            sample = loss
        xi = xi_step(xi, sample, cfg["bandwidth"], cfg["alpha"])
    return xi
