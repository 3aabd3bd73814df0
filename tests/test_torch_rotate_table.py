"""The sweeps in an eigenbasis gather their slabs from the frozen table
rotated once (``models/common.py::rotate_table``): the rotated table's
rows are the rotated slab's, the sweeps rotate each frozen table once
and solve every Woodbury and rotated row from it, the ++ models'
full-dim Woodbury sums its float32 rhs from the rotated slab, and a
fold-in's rotated item table is state alone, made once by the prep
(``_fold_in_prep``) and held by the ``Server`` across requests. Port
only, on the CPU."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          get_model)
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.ops import assemble, woodbury
from safer2_recommender_tpu_torch.serving import Server
from safer2_recommender_tpu_torch.utils.logging import clear_spans, spans

DIM = 128
# the MSD hyperparameters (tests/test_torch_trace.py::_config)
CFG = dict(dim=DIM, uobs_weight=0.0004, l2_reg=0.0012, alpha=0.3,
           bandwidth=0.1, use_snr=True, sampling_ratio=0.1, block_size=32,
           seed=0)
DTYPES = {"f32": None, "bf16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes beside other worker processes: one intra-op thread
    (the results do not depend on it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def paths():
    woodbury.reset_solve_paths()
    yield woodbury.SOLVE_PATHS
    woodbury.reset_solve_paths()


def _pairs(rng, n_users, n_items, long_users):
    """``long_users`` users with 100 items (width 128: rotated direct at
    dim 128), the rest with 5-29 (Woodbury); items drawn by a power law,
    so the head items' widths pass 128 and the tail's stay under 64."""
    p = 1.0 / np.arange(1, n_items + 1) ** 0.8
    p /= p.sum()
    us, its = [], []
    for u in range(n_users):
        n = 100 if u < long_users else int(rng.integers(5, 30))
        its += list(rng.choice(n_items, size=n, replace=False, p=p))
        us += [u] * n
    return np.unique(np.stack([us, its], 1), axis=0).astype(np.int32)


@pytest.fixture(scope="module")
def data():
    pairs = _pairs(np.random.default_rng(23), 240, 160, 24)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return ds, DeviceData.build(ds, device="cpu", dim=DIM)


def _tables(ds, seed=3):
    g = torch.Generator().manual_seed(seed)
    users = torch.randn((ds.num_users, DIM), generator=g) * 0.1
    items = torch.randn((ds.num_items, DIM), generator=g) * 0.1
    dual = torch.rand((ds.num_users,), generator=g) * 0.9 + 0.1
    return users, items, dual


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rotated_table_rows_are_the_rotated_slab(data, dtype):
    # the product is row for row, so gathering from the rotated table is
    # rotating the gathered slab, rounded once in the slab's dtype
    ds, dd = data
    _, items, _ = _tables(ds)
    table = assemble.cast(items, DTYPES[dtype])
    q = torch.linalg.qr(torch.randn(DIM, DIM, dtype=torch.float64))[0]
    q = q.to(torch.float32)
    t_rot = common.rotate_table(table, q)
    assert t_rot.dtype == table.dtype
    for b in dd.by_user:
        want = assemble.matmul_lowp(table[b.col_ids], q)
        assert torch.equal(t_rot[b.col_ids], want)


def _sweep(dd, ds, side, dtype, pre, t_rot=False):
    users, items, dual = _tables(ds)
    if side == "user":
        buckets, frozen, n_rows = dd.by_user, items, ds.num_users
        gram = items.T @ items
    else:
        buckets, frozen, n_rows = dd.by_item, users, ds.num_items
        gram = users.T @ (users * dual[:, None])
    norm_dual = dual / dd.user_hist_size.clamp(min=1.0)
    other_t = assemble.cast(frozen, dtype)
    eig = woodbury.maybe_eigh(gram, DIM, use_cg=False)
    pre_list = None
    if pre:
        pre_list = common.gather_and_losses(
            items, buckets, users, gram, ds.num_users, 0.01, halve=True,
            dtype=dtype)[1]
        assert pre_list is not None

    def params_fn(b, pre, other):
        reg = torch.full((b.n_rows,), 0.05)
        if side == "user":
            w = dual[b.row_ids.clamp(max=dual.shape[0] - 1)]
            return common.params_weighted_mean(other, b, reg, 0.01, w,
                                               dtype=dtype, pre=pre)
        return common.params_weighted_item(other, b, reg, 0.01, norm_dual,
                                           dtype=dtype)

    z = torch.zeros((n_rows, DIM))
    return common.solve_sweep(
        z, buckets, params_fn, gram, table_other=other_t, eig=eig,
        t_rot=common.rotate_table(other_t, eig[0]) if t_rot else None,
        pre_list=pre_list)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("side,pre", [("user", False), ("user", True),
                                      ("item", False)])
def test_solve_sweep_solves_every_row_in_the_basis_from_one_rotation(
        data, paths, side, pre, dtype):
    # the item side gathers the dual weights beside the rotated rows
    # (extra_vec); the user side's loss-pass slabs feed only the rows
    # solved as gathered; a rotation handed in is the one it makes
    ds, dd = data
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = _sweep(dd, ds, side, DTYPES[dtype], pre)
    rot = [r for r in spans() if r.name == "sweep.rotate_table"]
    clear_spans()
    assert len(rot) == 1
    assert paths["woodbury"] > 0 and paths["rotated"] > 0
    assert paths["table_rotated"] == paths["woodbury"] + paths["rotated"]
    assert torch.equal(got, _sweep(dd, ds, side, DTYPES[dtype], pre,
                                   t_rot=True))


def test_block_sweep_full_dim_woodbury_is_the_exact_solve(data, paths):
    # SAFER2++'s user sweep with eig: every Woodbury row is the exact
    # solution of its normal equations, A = ch V^T V + cg G + reg I,
    # b = ch V^T 1, within float32 rounding of the float64 solve (the
    # rhs summed from the rotated slab that K is built from)
    ds, dd = data
    users, items, dual = _tables(ds, seed=4)
    gram = items.T @ items
    eig = woodbury.maybe_eigh(gram, DIM, use_cg=False)

    def spec_fn(b):
        w = dual[b.row_ids.clamp(max=dual.shape[0] - 1)]
        return common.BlockSpec(cg=w * 0.01, reg=torch.full(
            (b.n_rows,), 0.05), ch=w / common.safe_len(b))

    got = common.block_sweep_frozen(users, items, dd.by_user, gram,
                                    spec_fn, bs=32, eig=eig)
    assert paths["table_rotated"] == paths["woodbury"] > 0
    v64, g64 = items.double(), gram.double()
    err, scale = 0.0, 0.0
    for b in dd.by_user:
        if not woodbury.applicable(b.width, DIM):
            continue
        spec = spec_fn(b)
        emb, mask = assemble.gather_history(v64, b)
        ch, cg, reg = (spec.ch.double(), spec.cg.double(),
                       spec.reg.double())
        a = (ch[:, None, None] * torch.einsum("nld,nle->nde", emb, emb)
             + cg[:, None, None] * g64
             + reg[:, None, None] * torch.eye(DIM, dtype=torch.float64))
        rhs = ch[:, None] * (emb * mask[..., None].double()).sum(1)
        x = torch.linalg.solve(a, rhs)
        rows = b.row_ids < ds.num_users
        diff = got[b.row_ids[rows]].double() - x[rows]
        err = max(err, float(diff.abs().max()))
        scale = max(scale, float(x[rows].abs().max()))
    assert err <= 1e-5 * scale


def _trained(data, name):
    ds, dd = data
    model = get_model(name, Config(**CFG), ds.num_users, ds.num_items,
                      device="cpu")
    model.initialize(dd)
    model.train_epochs(dd, 1)
    return model


@pytest.mark.parametrize("name", ["safer2", "safer2pp", "ials", "erm_mf"])
def test_epoch_rotates_each_frozen_table_once(data, paths, name):
    ds, dd = data
    model = _trained(data, name)
    woodbury.reset_solve_paths()
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        model.train_epochs(dd, 2)
    recs = spans()
    clear_spans()
    rot = [r for r in recs if r.name == "sweep.rotate_table"]
    # one a sweep, inside the sweep's phase where the model marks them
    assert len(rot) == 4
    assert Counter(r.attrs["rows"] for r in rot) == {
        ds.num_items: 2, ds.num_users: 2}
    if name.startswith("safer2"):
        assert {recs[r.parent].name for r in rot} == {"epoch.u_sweep",
                                                      "epoch.v_sweep"}
    # the ++ block sweep counts its full-dim Woodbury rows, never rotated
    in_basis = paths["woodbury"] + paths["rotated"]
    assert paths["table_rotated"] == in_basis > 0


@pytest.mark.parametrize("name", ["safer2", "safer2pp", "ials", "ialspp",
                                  "cvar_mf"])
def test_served_requests_gather_from_the_preps_rotation(data, paths, name):
    # the prep holds the item table rotated into its basis; the Server
    # makes it once for its state, and no request rotates anything
    ds, dd = data
    model = _trained(data, name)
    prep = model._fold_in_prep(model.state)
    eig, t_rot = prep[0], prep[-1]
    want = common.rotate_table(
        assemble.cast(model.state.item_emb, model.asm_dtype), eig[0])
    assert torch.equal(t_rot, want)
    rng = np.random.default_rng(5)
    server = Server(model, k=5)
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (3, 40):
            req = Dataset(np.repeat(np.arange(n), 6).astype(np.int32),
                          rng.integers(0, ds.num_items,
                                       6 * n).astype(np.int32))
            users, ids = server.recommend(req)
            assert ids.shape == (len(users), 5)
    rot = [r for r in spans() if r.name == "sweep.rotate_table"]
    clear_spans()
    assert len(rot) == 1 and rot[0].attrs["rows"] == ds.num_items
    assert paths["table_rotated"] == (paths["woodbury"] + paths["rotated"]
                                      ) > 0
