"""The port's assembly, smoothing, quantile and metric ops against the
JAX package's, on the same numpy inputs (rtol 1e-5 unless stated)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from safer2_recommender_tpu import Dataset as JDataset
from safer2_recommender_tpu import DeviceData as JDeviceData
from safer2_recommender_tpu.evaluation import metrics as jmetrics
from safer2_recommender_tpu.ops import assemble as jasm
from safer2_recommender_tpu.ops import quantile as jq
from safer2_recommender_tpu.ops import smoothing as jsm
from safer2_recommender_tpu_torch.data import dataset as tds
from safer2_recommender_tpu_torch.evaluation import metrics as tmetrics
from safer2_recommender_tpu_torch.ops import assemble as tasm
from safer2_recommender_tpu_torch.ops import quantile as tq
from safer2_recommender_tpu_torch.ops import smoothing as tsm

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def both():
    """(port DeviceData, JAX DeviceData, item table, user table) for a
    small dataset whose LAST user bucket overhangs the table (so both the
    contiguous and the scatter write-back run)."""
    rng = np.random.default_rng(5)
    pairs = np.unique(np.stack([rng.integers(0, 75, 1500),
                                rng.integers(0, 44, 1500)], 1), axis=0)
    u, i = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    tdd = tds.DeviceData.build(tds.Dataset(u, i), device="cpu")
    jdd = JDeviceData.build(JDataset(u, i))
    assert any(not b.contiguous for b in jdd.by_user + jdd.by_item)
    items = rng.normal(size=(jdd.num_items, 8)).astype(np.float32)
    users = rng.normal(size=(jdd.num_users, 8)).astype(np.float32)
    return tdd, jdd, items, users


def _bucket_pairs(tdd, jdd):
    """(port bucket, JAX bucket, rows of the table the bucket indexes)."""
    return ([(t, j, tdd.num_users) for t, j in zip(tdd.by_user, jdd.by_user)]
            + [(t, j, tdd.num_items)
               for t, j in zip(tdd.by_item, jdd.by_item)])


def test_gather_history_and_reductions_match_jax(both):
    tdd, jdd, items, users = both
    vec = np.linspace(0.1, 2.0, items.shape[0]).astype(np.float32)
    for tb, jb in zip(tdd.by_user, jdd.by_user):
        _close(tasm.history_mask(tb), jasm.history_mask(jb))
        temb, tmask = tasm.gather_history(_t(items), tb)
        jemb, jmask = jasm.gather_history(jnp.asarray(items), jb)
        _close(temb, jemb)
        _close(tmask, jmask)
        t3 = tasm.gather_history_extra(_t(items), _t(vec), tb)
        j3 = jasm.gather_history_extra(jnp.asarray(items), jnp.asarray(vec),
                                       jb)
        for a, b in zip(t3, j3):
            _close(a, b)
        w = t3[2]
        _close(tasm.row_gramians(temb, col_weight=w),
               jasm.row_gramians(jemb, col_weight=j3[2]), atol=1e-5)
        _close(tasm.row_gramians(temb), jasm.row_gramians(jemb), atol=1e-5)
        _close(tasm.row_sums(temb, col_weight=w),
               jasm.row_sums(jemb, col_weight=j3[2]), atol=1e-5)
        x = users[:tb.n_rows]
        _close(tasm.rowwise_dot(temb, _t(x)),
               jasm.rowwise_dot(jemb, jnp.asarray(x)), atol=1e-5)


def test_read_and_scatter_rows_match_jax(both):
    tdd, jdd, _, _ = both
    rng = np.random.default_rng(6)
    for tb, jb, n in _bucket_pairs(tdd, jdd):
        table = rng.normal(size=(n, 8)).astype(np.float32)
        vec = rng.normal(size=n).astype(np.float32)
        _close(tasm.read_rows(_t(table), tb),
               jasm.read_rows(jnp.asarray(table), jb))
        vals = rng.normal(size=(tb.n_rows, 8)).astype(np.float32)
        got = tasm.scatter_bucket(_t(table).clone(), tb, _t(vals))
        _close(got, jasm.scatter_bucket(jnp.asarray(table), jb,
                                        jnp.asarray(vals)))
        got = tasm.scatter_bucket_vector(_t(vec).clone(), tb, _t(vals[:, 0]))
        _close(got, jasm.scatter_bucket_vector(jnp.asarray(vec), jb,
                                               jnp.asarray(vals[:, 0])))


def test_is_wide_matches_jax_and_wide_buckets_raise(both, monkeypatch):
    tdd, jdd, items, _ = both
    for tb, jb, _ in _bucket_pairs(tdd, jdd):
        for dim in (2, 8, 64):
            assert tasm.is_wide(tb, dim) == jasm.is_wide(jb, dim)
    b = tdd.by_user[-1]
    big = tds.Bucket(row_ids=torch.zeros(64, dtype=torch.long),
                     col_ids=torch.zeros((64, 1 << 20), dtype=torch.long),
                     length=torch.ones(64, dtype=torch.long))
    assert tasm.is_wide(big, 8) and not tasm.is_wide(b, 8)
    # every model streams its wide buckets now (wide_assemble, wide_obs,
    # wide_matvec, wide_gram_resid), so nothing guards a whole-bucket
    # gather any more: as in the JAX package, it returns the slab
    assert not hasattr(tasm, "WIDE_NOT_PORTED")
    assert not hasattr(tasm, "_require_narrow")
    for mod in (tasm, jasm):
        monkeypatch.setattr(mod, "WIDE_SLAB_BYTES", 1)
    tb, jb = next((t, j) for t, j in zip(tdd.by_user, jdd.by_user)
                  if t.width > 2)
    assert tasm.is_wide(tb, 2) and jasm.is_wide(jb, 2)
    emb, mask = tasm.gather_history(_t(items[:, :2].copy()), tb)
    jemb, jmask = jasm.gather_history(jnp.asarray(items[:, :2]), jb)
    _close(emb, jemb)
    _close(mask, jmask)


@pytest.mark.parametrize("fn", ["gaussian_kernel", "gaussian_cdf",
                                "epanechnikov_kernel", "epanechnikov_cdf"])
@pytest.mark.parametrize("h", [0.15, 0.7])
def test_smoothing_kernels_match_jax(fn, h):
    u = np.linspace(-3, 3, 301).astype(np.float32)
    _close(getattr(tsm, fn)(_t(u), h), getattr(jsm, fn)(jnp.asarray(u), h))


@pytest.mark.parametrize("fn", ["gaussian_loss", "epanechnikov_loss"])
def test_smoothing_losses_match_jax(fn):
    # the Epanechnikov left-tail quirk (ell = 0 for u/h < -1) included
    u = np.linspace(-3, 3, 301).astype(np.float32)
    _close(getattr(tsm, fn)(_t(u), 0.5, 0.3),
           getattr(jsm, fn)(jnp.asarray(u), 0.5, 0.3))
    assert float(tsm.epanechnikov_loss(torch.tensor(-2.0), 0.5, 0.3)) == \
        pytest.approx(0.5 * (1 - 0.3 - 0.5) * -2.0 * 2, rel=1e-6)


@pytest.mark.parametrize("epan", [False, True])
def test_dual_weight_matches_jax(epan):
    rng = np.random.default_rng(8)
    loss = rng.gamma(2.0, 0.3, 500).astype(np.float32)
    _close(tsm.dual_weight(_t(loss), 0.6, 0.3, epan),
           jsm.dual_weight(jnp.asarray(loss), 0.6, 0.3, epan))


@pytest.mark.parametrize("epan,bandwidth,rtol", [
    (False, 0.5, RTOL),
    (True, 0.7, RTOL),
    # The README config's narrow Gaussian bandwidth: the reference's
    # gradient is not the derivative of its objective (tests/test_ops.py::
    # test_gaussian_loss_gradient_identity), so near the fixed point Armijo
    # halves the step until it is noise, and which halving is accepted
    # hangs on the f32 rounding of the mean losses: the two packages sum
    # in different orders and stall up to ~4e-5 apart (measured over
    # seeds and sizes), the JAX package no nearer the true quantile.
    (False, 0.15, 1e-4),
])
def test_compute_xi_matches_jax(epan, bandwidth, rtol):
    import jax

    rng = np.random.default_rng(9)
    loss = rng.gamma(2.0, 0.3, 2000).astype(np.float32)
    kw = dict(nr_iterations=5, bandwidth=bandwidth, alpha=0.3,
              use_epanechnikov=epan, use_snr=False, sampling_ratio=0.1)
    warm = float(loss.mean())
    got = tq.compute_xi(_t(loss), warm, None, **kw)
    want = jq.compute_xi(jnp.asarray(loss), jnp.float32(warm),
                         jax.random.PRNGKey(0), **kw)
    assert float(got) == pytest.approx(float(want), rel=rtol)
    qkw = dict(bandwidth=bandwidth, alpha=0.3, use_epanechnikov=epan)
    for xi in (0.2, 0.6, 1.5):
        for a, b in zip(tq.evaluate_quantile(torch.tensor(xi), _t(loss),
                                             **qkw),
                        jq.evaluate_quantile(jnp.float32(xi),
                                             jnp.asarray(loss), **qkw)):
            assert float(a) == pytest.approx(float(b), rel=RTOL, abs=1e-6)


def test_compute_xi_snr_draws_from_the_generator():
    loss = torch.from_numpy(
        np.random.default_rng(10).gamma(2.0, 0.3, 4000).astype(np.float32))
    kw = dict(nr_iterations=5, bandwidth=0.15, alpha=0.3,
              use_epanechnikov=False, use_snr=True, sampling_ratio=0.5)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a = tq.compute_xi(loss, float(loss.mean()), g1, **kw)
    b = tq.compute_xi(loss, float(loss.mean()), g2, **kw)
    assert float(a) == float(b)
    full = tq.compute_xi(loss, float(loss.mean()), None,
                         **{**kw, "use_snr": False})
    # a half-sample estimate of the same quantile
    assert float(a) == pytest.approx(float(full), rel=0.1)


def test_topk_metrics_and_ids_match_jax_with_ties():
    rng = np.random.default_rng(11)
    b, n_items = 16, 120
    # coarse scores: many exact ties, which must rank lower index first
    scores = rng.integers(0, 6, size=(b, n_items)).astype(np.float32)
    excl = np.full((b, 7), n_items, np.int64)
    excl[:, :5] = rng.integers(0, n_items, size=(b, 5))
    gt = np.full((b, 9), n_items, np.int64)
    gt_len = rng.integers(0, 10, size=b)
    for r in range(b):
        gt[r, :gt_len[r]] = rng.choice(n_items, gt_len[r], replace=False)
    k_list = (5, 10, 20, 50, 100)
    got = tmetrics.topk_metrics(_t(scores), _t(excl), _t(gt), _t(gt_len),
                                k_list)
    want = jmetrics.topk_metrics(jnp.asarray(scores), jnp.asarray(excl),
                                 jnp.asarray(gt), jnp.asarray(gt_len),
                                 k_list)
    for a, w in zip(got, want):
        _close(a, w)
    np.testing.assert_array_equal(
        tmetrics.topk_ids(_t(scores), _t(excl), 10).numpy(),
        np.asarray(jmetrics.topk_ids(jnp.asarray(scores),
                                     jnp.asarray(excl), 10)))


def test_metric_cvar_matches_jax():
    vals = np.random.default_rng(12).uniform(size=101)
    alphas = (0.1, 0.5, 0.9, 1.0)
    np.testing.assert_array_equal(tmetrics.metric_cvar(vals, alphas),
                                  jmetrics.metric_cvar(vals, alphas))
    assert (tmetrics.metric_cvar(np.zeros(0), alphas) == 0).all()
