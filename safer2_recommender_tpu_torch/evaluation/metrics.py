"""Ranking metrics: Recall@k, NDCG@k, and across-user metric-CVaR (the
counterpart of ``safer2_recommender_tpu/evaluation/metrics.py``).

  * top-k with ascending-index tie-break, as ``lax.top_k`` and the
    reference's nth_element + stable_sort rank (recommender.h:143-153):
    ``torch.topk`` promises no order among ties, so ranking here is a
    STABLE descending sort;
  * Recall@k normalized by min(k, |gt|) (recommender.h:156-165);
  * NDCG@k with ideal-DCG normalization over min(k, |gt|) positions
    (recommender.h:167-181);
  * metric-CVaR: lower-tail running mean of the sorted per-user metric,
    sampled at positions floor(n * alpha) (evaluation.h:83-102).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import numpy as np
import torch

from safer2_recommender_tpu_torch.utils.logging import LOGGER_NAME

_log = logging.getLogger(LOGGER_NAME)

DEFAULT_K_LIST = (5, 10, 20, 50, 100)
DEFAULT_ALPHA_LIST = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def _mask_history(scores: torch.Tensor, excl: torch.Tensor) -> torch.Tensor:
    """Scores with each row's history items set to float lowest
    (recommender.h:137-140); ``excl`` pads (== num_items) land in a spare
    column that is cut off again, so no host read decides which entries
    are real (a CUDA graph can hold this)."""
    b, num_items = scores.shape
    masked = torch.cat([scores, scores.new_empty((b, 1))], dim=1)
    masked.scatter_(1, excl.clamp(max=num_items),
                    torch.finfo(scores.dtype).min)
    return masked[:, :num_items]


def _ranked_ids(masked: torch.Tensor, k: int) -> torch.Tensor:
    """Ids of the k best scores per row, lower index first on ties."""
    return torch.sort(masked, dim=1, descending=True,
                      stable=True).indices[:, :k]


def topk_metrics(scores: torch.Tensor, excl: torch.Tensor, gt: torch.Tensor,
                 gt_len: torch.Tensor, k_list: Sequence[int]):
    """Recall@k / NDCG@k for a chunk of users.

    scores [B, I] full-catalog scores; excl [B, H] history item ids
    (padded with I); gt [B, G] ground-truth ids (padded with I);
    gt_len [B]. Returns (recall [B, K], ndcg [B, K]).
    """
    num_items = scores.shape[1]
    # k beyond the catalog is clamped (the whole catalog is ranked)
    max_k = min(int(max(k_list)), num_items)
    top_ids = _ranked_ids(_mask_history(scores, excl), max_k)

    hits = (top_ids[:, :, None] == gt[:, None, :]).any(dim=-1).to(
        torch.float32)                                      # [B, max_k]
    cum_hits = torch.cumsum(hits, dim=1)
    gains = 1.0 / torch.log2(
        torch.arange(max_k, dtype=torch.float32, device=scores.device) + 2.0)
    cum_dcg = torch.cumsum(hits * gains[None, :], dim=1)
    cum_ideal = torch.cumsum(gains, dim=0)                  # [max_k]

    gt_f = gt_len.to(torch.float32)
    recalls, ndcgs = [], []
    for k in k_list:
        kk = min(k, max_k)
        denom_r = torch.clamp(gt_f, max=float(k))
        recalls.append(cum_hits[:, kk - 1] / torch.clamp(denom_r, min=1.0))
        ideal_idx = torch.clamp(torch.clamp(gt_len, max=k) - 1, 0, max_k - 1)
        ndcgs.append(cum_dcg[:, kk - 1] / cum_ideal[ideal_idx])
    return torch.stack(recalls, dim=1), torch.stack(ndcgs, dim=1)


def topk_ids(scores: torch.Tensor, excl: torch.Tensor, k: int,
             approx: bool = False) -> torch.Tensor:
    """Top-k item ids per row with training history masked out (the
    serving counterpart of ``topk_metrics``; same tie-break).

    ``approx=True`` ranks with ``torch.topk``, whose order among tied
    scores is unspecified; the JAX package takes the TPU's
    ``approx_max_k`` there. Evaluation always uses the exact path."""
    masked = _mask_history(scores, excl)
    k = min(k, scores.shape[1])
    if approx:
        return torch.topk(masked, k, dim=1).indices
    return _ranked_ids(masked, k)


def metric_cvar(values: np.ndarray,
                alpha_list: Sequence[float]) -> np.ndarray:
    """Lower-tail running mean at positions floor(n*alpha):
    cvar[j] = mean(sorted_values[0 .. floor(n*alpha_j)])."""
    ms = np.sort(np.asarray(values, dtype=np.float64))
    n = ms.size
    if n == 0:        # no evaluable users: report zeros, don't crash
        return np.zeros(len(alpha_list), dtype=np.float32)
    prefix = np.cumsum(ms)
    out = np.zeros(len(alpha_list), dtype=np.float32)
    for j, a in enumerate(alpha_list):
        pos = min(int(n * a), n - 1)
        out[j] = prefix[pos] / (pos + 1)
    return out


@dataclasses.dataclass
class EvaluationResult:
    """Per-user metric matrices + formatted reporting; ``recall`` and
    ``ndcg`` are [num_eval_users, len(k_list)] numpy arrays."""

    k_list: Sequence[int]
    alpha_list: Sequence[float]
    recall: np.ndarray
    ndcg: np.ndarray

    def format(self, measure_name: str, measurements) -> str:
        return " ".join(f"{measure_name}@{k}={m:.4f}"
                        for k, m in zip(self.k_list, measurements))

    def mean_recall(self) -> np.ndarray:
        return self.recall.mean(axis=0)

    def mean_ndcg(self) -> np.ndarray:
        return self.ndcg.mean(axis=0)

    def cvar(self, measurements) -> np.ndarray:
        return metric_cvar(measurements, self.alpha_list)

    def show(self) -> None:
        """Emit the reference's log lines (evaluation.h:61-81)."""
        _log.info(self.format("Mean Rec", self.mean_recall()))
        _log.info(self.format("Mean NDCG", self.mean_ndcg()))
        nk = len(self.k_list)
        rec_cvar = np.stack(
            [self.cvar(self.recall[:, i]) for i in range(nk)])
        ndcg_cvar = np.stack(
            [self.cvar(self.ndcg[:, i]) for i in range(nk)])
        for j, a in enumerate(self.alpha_list):
            _log.info(self.format(f"Rec CVaR (q={a:.2f})", rec_cvar[:, j]))
            _log.info(self.format(f"NDCG CVaR (q={a:.2f})", ndcg_cvar[:, j]))
