"""CVaR-MF's gather-matvec kernel (``ops/grad_gather.py``,
``csrc/grad_gather.cu``) and its route through the gradient steps of
``models/cvar_mf.py``.

The tests marked ``cuda`` (they skip where no GPU is present) hold the
kernel's step, in its two forms (``user_step``: the dual weight by row
and a scalar ridge; ``item_step``: the normalized dual by column and a
ridge by row), to the plain route (``params_weighted_*``,
``grad_from_params``, ``scatter_bucket``) on the card, at float32, and
to a float64 computation of the same step: narrow and wide buckets,
contiguous and gathered rows, padded rows and rows of length 0, widths
1 to 4,097, every register width d = 8 to 1,024, a d that is no multiple
of 4, a table that is not 16-byte aligned, the two-pass route past
d = 1,024, one row of 200,003 slots split over blocks, two calls
bit-equal, and a CVaR-MF epoch routed against unrouted; and that every
CUDA float32 table takes the kernel (a d past 1,024, a d of 10, tables
that are not contiguous), never the plain route. The CPU tests hold the
CPU and the bfloat16 assembly dtype to the plain route, the fused
formula to the plain route's ``A_hist x - rhs``, the routing itself
(with the plain route standing in for the kernel) and the benchmark's
reader of the kernel's spans. This file imports no JAX: it runs on the
card."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.data.dataset import (Bucket, Dataset,
                                                       DeviceData)
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.models import common, get_model
from safer2_recommender_tpu_torch.ops import assemble, grad_gather, woodbury

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A step of the kernel against one of the plain route, both float32:
# within this share of the plain step's largest entry (the two sum h in
# different orders), plus one rounding of the new rows each.
PLAIN_TOL = 1e-5
# Against the float64 step of the same float32 inputs: within this share
# of its largest entry. Each slot's term is one dot of d products and one
# axpy; a block sums a warp's slots in order (at most CHUNK / 8 = 128
# terms), its 8 warps and then a row's chunks in groups of 16, so the
# rounding stays near 1e-7 of the largest entry at these widths.
F64_TOL = 2e-6
WIDTHS = [1, 31, 512, 513, 4097]
DIM = 512
UOBS, ETA, REG = 0.0004, 0.4, 0.05


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda", 0)


def _bucket(rng, n, width, self_rows, other_rows, contiguous, device,
            long_row=None):
    """A bucket of ``n`` rows (the last two padded, one real row of
    length 0, row 0 full) of histories up to ``width`` slots drawn from
    ``other_rows`` ids; ``long_row`` gives row 0 that many slots."""
    length = rng.integers(1, width + 1, n)
    length[0] = width if long_row is None else long_row
    if n > 3:
        length[1] = 0
    length[-2:] = 0
    if contiguous:
        start = int(rng.integers(0, self_rows - n))
        row_ids = np.arange(start, start + n)
    else:
        start = None
        row_ids = rng.choice(self_rows, n, replace=False)
    row_ids[n - 2:] = self_rows
    cols = rng.integers(0, other_rows, (n, width))
    cols[np.arange(width)[None, :] >= length[:, None]] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
        device)
    return Bucket(row_ids=t(row_ids), col_ids=t(cols), length=t(length),
                  row_start=start, contiguous=contiguous)


def _table(rng, rows, d, device):
    """A table at the MSD start's scale, N(0, 0.1 / sqrt(d)), plus an
    offset so that v . x - 1 is not -1 everywhere."""
    return torch.from_numpy(
        (rng.normal(size=(rows, d)) * 0.1 / np.sqrt(d) + 0.5 / np.sqrt(d))
        .astype(np.float32)).to(device)


def _side(side, rng, self_rows, other_rows, device):
    """The keyword arguments of the step of one side, as the CVaR-MF
    steps give them: users a dual weight by row and a scalar ridge;
    items a ridge by row and the normalized dual by column."""
    vec = lambda n, hi: torch.from_numpy(
        rng.uniform(hi / 10, hi, n).astype(np.float32)).to(device)
    if side == "user":
        return dict(reg=REG, uobs=UOBS, dual=vec(self_rows, 1.0))
    return dict(reg=vec(self_rows, 0.1), uobs=UOBS,
                norm_dual=vec(other_rows, 0.2))


def _kernel_step(side, self, other, b, gram, kw):
    """The kernel's step of one bucket, in place on ``self``."""
    step = grad_gather.user_step if side == "user" else grad_gather.item_step
    return step(self, other, b, gram, ETA, **kw)


def _by_row(v, b):
    return v[b.row_ids.clamp(max=v.shape[0] - 1)]


def _plain_step(side, self, other, b, gram, kw):
    """The plain route's step of one bucket, in place on ``self``."""
    if side == "user":
        p = common.params_weighted_mean(
            other, b, torch.full((b.n_rows,), kw["reg"], device=self.device),
            kw["uobs"], _by_row(kw["dual"], b))
    else:
        p = common.params_weighted_item(other, b, _by_row(kw["reg"], b),
                                        kw["uobs"], kw["norm_dual"])
    x = assemble.read_rows(self, b)
    grad = common.grad_from_params(p, gram, x)
    return assemble.scatter_bucket(self, b, x - ETA * grad)


def _history(other, b, x, rc=None, vec=None, slab_bytes=256 << 20):
    """The kernel's formula in plain torch: h [N, d] = sum over the real
    slots of s (v . x - 1) v, s = rc[n] vec[col] (either factor may be
    absent), in the dtype of ``other`` and ``x``, over column chunks
    whose gathered slab stays under ``slab_bytes``."""
    n, l = b.n_rows, b.width
    d = other.shape[1]
    out = torch.zeros((n, d), dtype=other.dtype, device=other.device)
    w = max(1, min(l, slab_bytes // max(1, n * d * other.element_size())))
    for off in range(0, l, w):
        cols = b.col_ids[:, off:off + w]
        pos = torch.arange(off, off + cols.shape[1], device=b.length.device)
        s = (pos[None, :] < b.length[:, None]).to(other.dtype)
        if vec is not None:
            s = s * vec[cols].to(other.dtype)
        if rc is not None:
            s = s * rc[:, None].to(other.dtype)
        v = other[cols]
        t = s * ((v * x[:, None, :]).sum(dim=2) - 1.0)
        out += (t[..., None] * v).sum(dim=1)
    return out


def _ref_step(side, self, other, b, gram, kw, dtype=torch.float64):
    """The step by the kernel's formula in plain torch, in ``dtype``,
    from the same inputs; returns a new table."""
    self = self.to(dtype, copy=True)
    x = assemble.read_rows(self, b)
    ones = torch.ones((b.n_rows,), dtype=dtype, device=self.device)
    if side == "user":
        w = _by_row(kw["dual"], b).to(dtype)
        rc, vec = w / b.length.clamp(min=1).to(dtype), None
        c0, c1 = kw["reg"] * ones, kw["uobs"] * w
    else:
        rc, vec = None, kw["norm_dual"]
        c0, c1 = _by_row(kw["reg"], b).to(dtype), kw["uobs"] * ones
    h = _history(other.to(dtype), b, x, rc, vec)
    grad = c0[:, None] * x + c1[:, None] * (x @ gram.to(dtype)) + h
    return assemble.scatter_bucket(self, b, x - ETA * grad)


def _written(b, rows):
    """Rows of a table of ``rows`` that the step writes."""
    out = torch.zeros(rows, dtype=torch.bool, device=b.row_ids.device)
    if b.contiguous:
        out[b.row_start:b.row_start + b.n_rows] = b.length > 0
    else:
        ids = b.row_ids[b.row_ids < rows]
        out[ids] = True
    return out


def _step_err(got, want, start):
    """max|got - want| over the largest entry of want's step."""
    got, want, start = got.double(), want.double(), start.double()
    return float((got - want).abs().max() / (want - start).abs().max())


def _check_step(got, plain, want64, start, b):
    # untouched rows keep their bits; written rows within the bounds
    rows = start.shape[0]
    written = _written(b, rows)
    assert torch.equal(got[~written], start[~written])
    ulp = 2.0 ** -23 * float(plain.abs().max()) / float(
        (plain.double() - start.double()).abs().max())
    assert _step_err(got, plain, start) <= PLAIN_TOL + ulp
    assert _step_err(got, want64, start) <= F64_TOL + ulp


# --------------------------------------------------------------------------
# CPU: the plain route, the fused formula, the routing, the reader
# --------------------------------------------------------------------------


def test_route_needs_a_cuda_float32_table():
    t = torch.zeros((4, 8))
    assert not grad_gather.applies(t)
    assert not grad_gather.applies(t.to(torch.bfloat16))
    assert grad_gather.splits(1) == grad_gather.splits(grad_gather.CHUNK) == 1
    assert grad_gather.splits(grad_gather.CHUNK + 1) == 2


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("case", ["cpu", "float64", "bfloat16"])
def test_wrapper_raises_where_the_kernel_does_not_run(case, side):
    rng = np.random.default_rng(0)
    b = _bucket(rng, 6, 5, 20, 30, False, "cpu")
    dtype = torch.float32 if case == "cpu" else getattr(torch, case)
    other = torch.zeros((30, 8), dtype=dtype)
    self = torch.zeros((20, 8))
    with pytest.raises((TypeError, ValueError)):
        _kernel_step(side, self, other, b, torch.eye(8),
                     _side(side, rng, 20, 30, "cpu"))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("side", ["user", "item"])
def test_fused_formula_equals_the_plain_route(monkeypatch, side, wide):
    # sum s (v.x - 1) v, the kernel's formula in plain torch, is the
    # plain route's A_hist x - rhs on the narrow and the wide path, and
    # the whole step by that formula is the plain route's step
    if wide:
        monkeypatch.setattr(assemble, "WIDE_SLAB_BYTES", 1)
        monkeypatch.setattr(assemble, "WIDE_CHUNK", 16)
    rng = np.random.default_rng(4)
    b = _bucket(rng, 16, 70, 50, 60, True, "cpu")
    t_self, other = _table(rng, 50, 16, "cpu"), _table(rng, 60, 16, "cpu")
    kw = _side(side, rng, 50, 60, "cpu")
    gram = other.T @ other
    plain = _plain_step(side, t_self.clone(), other, b, gram, kw)
    ref = _ref_step(side, t_self, other, b, gram, kw, torch.float32)
    assert _step_err(ref, plain, t_self) <= 1e-6
    x = assemble.read_rows(t_self, b)
    zeros = torch.zeros(16)
    if side == "user":
        w = _by_row(kw["dual"], b)
        p = common.params_weighted_mean(other, b, zeros, 0.0, w)
        rc, vec = w / b.length.clamp(min=1).to(torch.float32), None
    else:
        p = common.params_weighted_item(other, b, zeros, 0.0,
                                        kw["norm_dual"])
        rc, vec = None, kw["norm_dual"]
    assert (p.wide is not None) == wide
    want = common.grad_from_params(p, torch.zeros((16, 16)), x)
    got = _history(other, b, x, rc, vec)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.parametrize("use_vec", [False, True])
@pytest.mark.parametrize("use_rc", [False, True])
def test_plain_version_is_the_sum_it_names(use_rc, use_vec):
    # the formula in float64 against the sum written out slot by slot,
    # with either factor of s present or not, over several chunks
    rng = np.random.default_rng(5)
    b = _bucket(rng, 9, 37, 40, 25, False, "cpu")
    table = torch.from_numpy(rng.normal(size=(25, 6)))
    x = torch.from_numpy(rng.normal(size=(9, 6)))
    rc = torch.from_numpy(rng.uniform(0.1, 1, 9)) if use_rc else None
    vec = torch.from_numpy(rng.uniform(0, 1, 25)) if use_vec else None
    got = _history(table, b, x, rc=rc, vec=vec, slab_bytes=9 * 6 * 8 * 5)
    want = np.zeros((9, 6))
    for n in range(9):
        for l in range(int(b.length[n])):
            c = int(b.col_ids[n, l])
            v = table[c].numpy()
            s = (float(rc[n]) if use_rc else 1.0) * (
                float(vec[c]) if use_vec else 1.0)
            want[n] += s * (v @ x[n].numpy() - 1.0) * v
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def _cvar_epoch(ds, dd, dim, dtype="f32", tables=None):
    """(start, end) states of one CVaR-MF epoch; ``tables`` may replace
    the initialized state's tables."""
    cfg = Config(dim=dim, uobs_weight=UOBS, l2_reg=0.0012, alpha=0.3,
                 stepsize=ETA, compute_dtype=dtype, seed=0)
    model = get_model("cvar_mf", cfg, ds.num_users, ds.num_items,
                      device=dd.device)
    model.initialize(dd)
    if tables is not None:
        model.state = model.state.replace(**tables(model.state))
    start = model.state
    model.train_epochs(dd, 1)
    return start, model.state


def _steps_refused(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(grad_gather, "user_step", refuse)
    monkeypatch.setattr(grad_gather, "item_step", refuse)


@pytest.fixture(scope="module")
def cpu_data():
    ds = Dataset(*powerlaw_dataset(400, 150, mean_hist=30, seed=2))
    return ds, DeviceData.build(ds, device="cpu", dim=32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cpu_epoch_never_reaches_the_kernel(monkeypatch, cpu_data, dtype):
    # a CVaR-MF epoch on the CPU takes the plain route at either dtype
    _steps_refused(monkeypatch)
    ds, dd = cpu_data
    start, end = _cvar_epoch(ds, dd, 32, dtype)
    assert end.steps == start.steps + 1
    assert bool(torch.isfinite(end.user_emb).all())


def test_routing_on_the_cpu_with_the_plain_version(monkeypatch, cpu_data):
    # the route's control flow, rehearsed on the CPU: every bucket of
    # both sweeps is one step of its side, and the epoch equals the plain
    # route's; the plain route's step stands in for the kernel
    ds, dd = cpu_data
    monkeypatch.setattr(assemble, "WIDE_SLAB_BYTES", 1 << 16)
    start, plain = _cvar_epoch(ds, dd, 32)
    calls = []

    def stand_in(side):
        def step(self, other, bucket, gram, eta, **kw):
            assert eta == ETA
            calls.append((side, bucket.n_rows))
            return _plain_step(side, self, other, bucket, gram, kw)
        return step

    monkeypatch.setattr(grad_gather, "applies", lambda t: True)
    monkeypatch.setattr(grad_gather, "user_step", stand_in("user"))
    monkeypatch.setattr(grad_gather, "item_step", stand_in("item"))
    start2, routed = _cvar_epoch(ds, dd, 32)
    assert calls == ([("user", b.n_rows) for b in dd.by_user]
                     + [("item", b.n_rows) for b in dd.by_item])
    assert any(assemble.is_wide(b, 32) for b in dd.by_item)
    assert torch.equal(start.user_emb, start2.user_emb)
    assert torch.equal(routed.dual_weight, plain.dual_weight)
    for leaf in ("user_emb", "item_emb"):
        assert _step_err(getattr(routed, leaf), getattr(plain, leaf),
                         getattr(start, leaf)) <= 1e-5, leaf


def test_benchmark_reader_counts_the_kernels_spans():
    path = os.path.join(REPO, "portbench", "metrics",
                        "grad_gather.launches.train.py")
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ops = [("epoch", 0, 1), ("sweep.grad", 0, 1), ("kernel.grad_gather", 0, 1),
           ("epoch", 1, 2), ("sweep.grad", 1, 2), ("kernel.grad_gather", 1, 2)]
    assert mod.read({"units": 2, "host_ops": ops}, None) == 1.0
    # the parent's epochs: marked, but no kernel span
    assert mod.read({"units": 2, "host_ops": ops[:2]}, None) is None
    assert mod.read({"units": 2, "host_ops": [("aten::mm", 0, 1)]},
                    None) is None


# --------------------------------------------------------------------------
# The card: the kernel against the plain route and float64
# --------------------------------------------------------------------------


def _three_steps(side, b, t_self, other, gram, kw):
    """(kernel step, plain step, float64 step) from one table."""
    got = _kernel_step(side, t_self.clone(), other, b, gram, kw)
    plain = _plain_step(side, t_self.clone(), other, b, gram, kw)
    want64 = _ref_step(side, t_self, other, b, gram, kw)
    torch.cuda.synchronize()
    return got, plain, want64


@pytest.mark.cuda
@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("side", ["user", "item"])
def test_kernel_matches_the_plain_route_on_cuda(side, width, contiguous):
    dev = _cuda()
    rng = np.random.default_rng(width * 7 + contiguous)
    n, self_rows, other_rows = 128, 4000, 6000
    b = _bucket(rng, n, width, self_rows, other_rows, contiguous, dev)
    t_self = _table(rng, self_rows, DIM, dev)
    other = _table(rng, other_rows, DIM, dev)
    kw = _side(side, rng, self_rows, other_rows, dev)
    gram = other.T @ other
    before = grad_gather.LAUNCHES
    got, plain, want64 = _three_steps(side, b, t_self, other, gram, kw)
    assert grad_gather.LAUNCHES == before + 1
    _check_step(got, plain, want64, t_self, b)
    # a real row of length 0 (gathered buckets write it): no history
    # term, so the two routes' steps are the same bits
    if not contiguous:
        row = b.row_ids[1]
        assert torch.equal(got[row], plain[row])


def _misaligned(t):
    """``t``'s values in a contiguous table 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("d", [8, 64, 256, 1024, 10, 1028, 2050,
                               "misaligned"])
def test_kernel_at_every_lane_width_on_cuda(d, side):
    # 1, 2, 4 and 8 float4 columns a lane; a d that is no multiple of 4
    # and tables off a 16-byte boundary (one float at a time); the
    # two-pass route past 1,024 (float4 tiles at 1,028, single floats at
    # 2,050): each form of the step against the plain route over a split
    # bucket
    dev = _cuda()
    rng = np.random.default_rng(hash(str(d)) % 1000 + (side == "item"))
    dim = 512 if d == "misaligned" else d
    b = _bucket(rng, 40, 2500, 100, 3000, False, dev)
    t_self, other = _table(rng, 100, dim, dev), _table(rng, 3000, dim, dev)
    if d == "misaligned":
        t_self, other = _misaligned(t_self), _misaligned(other)
    kw = _side(side, rng, 100, 3000, dev)
    gram = other.T @ other
    before = grad_gather.LAUNCHES
    got, plain, want64 = _three_steps(side, b, t_self, other, gram, kw)
    assert grad_gather.LAUNCHES == before + 1
    _check_step(got, plain, want64, t_self, b)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["user", "item"])
def test_long_row_is_split_and_summed_in_order_on_cuda(side):
    # one row of 200,003 slots (196 chunks), one short row, a row of
    # length 0 and a padded row: a wide bucket, against the plain route's
    # column chunks, and two calls give the same bits
    dev = _cuda()
    rng = np.random.default_rng(11)
    width = 200_003
    b = _bucket(rng, 4, width, 1000, 50_000, False, dev, long_row=width)
    assert assemble.is_wide(b, DIM)
    assert grad_gather.splits(width) == 196
    t_self = _table(rng, 1000, DIM, dev)
    other = _table(rng, 50_000, DIM, dev)
    kw = _side(side, rng, 1000, 50_000, dev)
    gram = other.T @ other
    woodbury.reset_solve_paths()
    got, plain, want64 = _three_steps(side, b, t_self, other, gram, kw)
    assert woodbury.SOLVE_PATHS["wide"] == 2 * b.n_rows
    woodbury.reset_solve_paths()
    again = _kernel_step(side, t_self.clone(), other, b, gram, kw)
    assert torch.equal(got, again)
    _check_step(got, plain, want64, t_self, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [DIM, 1028])
def test_two_calls_are_bit_equal_on_cuda(d):
    dev = _cuda()
    rng = np.random.default_rng(12)
    b = _bucket(rng, 300, 3000, 1000, 8000, True, dev)
    t_self, other = _table(rng, 1000, d, dev), _table(rng, 8000, d, dev)
    kw = _side("item", rng, 1000, 8000, dev)
    gram = other.T @ other
    first = _kernel_step("item", t_self.clone(), other, b, gram, kw)
    for _ in range(3):
        again = _kernel_step("item", t_self.clone(), other, b, gram, kw)
        assert torch.equal(again, first)


@pytest.mark.cuda
def test_cvar_mf_epoch_routed_against_unrouted_on_cuda(monkeypatch):
    # one CVaR-MF epoch from the same state at dim 512: every bucket of
    # both sweeps launches the kernel once, and the tables' change
    # matches the plain route's within 1e-5 (the first epoch's z comes
    # from the carried xi, so both take the same z)
    dev = _cuda()
    ds = Dataset(*powerlaw_dataset(20_000, 8_000, mean_hist=40, seed=3))
    dd = DeviceData.build(ds, device=dev, dim=DIM)
    before = grad_gather.LAUNCHES
    start, routed = _cvar_epoch(ds, dd, DIM)
    launches = grad_gather.LAUNCHES - before
    with monkeypatch.context() as m:
        m.setattr(grad_gather, "applies", lambda t: False)
        start2, plain = _cvar_epoch(ds, dd, DIM)
    torch.cuda.synchronize()
    assert launches == len(dd.by_user) + len(dd.by_item)
    assert grad_gather.LAUNCHES - before == launches
    assert torch.equal(start.user_emb, start2.user_emb)
    assert torch.equal(routed.dual_weight, plain.dual_weight)
    for leaf in ("user_emb", "item_emb"):
        assert _step_err(getattr(routed, leaf), getattr(plain, leaf),
                         getattr(start, leaf)) <= 1e-5, leaf


def _strided(t):
    """``t``'s values in a table that is not contiguous (a column slice
    of a wider one)."""
    wide = torch.zeros((t.shape[0], t.shape[1] + 3), dtype=t.dtype,
                       device=t.device)
    out = wide[:, :t.shape[1]]
    out.copy_(t)
    assert not out.is_contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d1028", "d10", "noncontiguous"])
def test_every_cuda_float32_table_takes_the_kernel_on_cuda(monkeypatch,
                                                           case):
    # a CVaR-MF epoch on the card at a d past 1,024, a d that is no
    # multiple of 4, and from tables that are not contiguous: every
    # bucket launches the kernel and the plain route is never reached
    dev = _cuda()
    dim = {"d1028": 1028, "d10": 10, "noncontiguous": 64}[case]
    ds = Dataset(*powerlaw_dataset(3_000, 1_200, mean_hist=30, seed=4))
    dd = DeviceData.build(ds, device=dev, dim=dim)

    def refuse(*a, **k):
        raise AssertionError("a CUDA float32 table took the plain route")

    monkeypatch.setattr(common, "grad_from_params", refuse)
    tables = None
    if case == "noncontiguous":
        tables = lambda st: dict(user_emb=_strided(st.user_emb),
                                 item_emb=_strided(st.item_emb))
    before = grad_gather.LAUNCHES
    start, end = _cvar_epoch(ds, dd, dim, tables=tables)
    torch.cuda.synchronize()
    assert grad_gather.LAUNCHES - before == len(dd.by_user) + len(dd.by_item)
    assert bool(torch.isfinite(end.user_emb).all())
    assert bool(torch.isfinite(end.item_emb).all())
    assert not torch.equal(end.item_emb, start.item_emb)


@pytest.mark.cuda
def test_wrapper_raises_on_a_table_it_cannot_take_on_cuda():
    # a table that is not contiguous is refused, never stepped by the
    # plain route
    dev = _cuda()
    rng = np.random.default_rng(13)
    b = _bucket(rng, 20, 40, 100, 300, False, dev)
    t_self, other = _table(rng, 100, 64, dev), _table(rng, 300, 64, dev)
    kw = _side("user", rng, 100, 300, dev)
    for s, o in ((_strided(t_self), other), (t_self, _strided(other))):
        with pytest.raises(ValueError, match="contiguous"):
            _kernel_step("user", s, o, b, o.T @ o, kw)
