"""Checkpoint and resume in the port (checkpoint.py, the model's id
sidecar, the CLI's --checkpoint_dir), on the CPU: the npz cases of
tests/test_checkpoint.py (the two orbax-only ones have no counterpart;
the rebucketing cases live in tests/test_torch_safer2.py::
test_rebucketed_data_remaps_trained_tables), a directory that the JAX
package's CheckpointManager wrote restoring into the port, and a resumed
SAFER2 run that draws its xi samples from the restored generator."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.checkpoint import \
    CheckpointManager as JCheckpointManager
from safer2_recommender_tpu_torch import (CheckpointManager, Config, Dataset,
                                          DeviceData, FoldInData, get_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Records(logging.Handler):
    """The port's log records while attached (its logger stops
    propagating once the CLI has set it up, so caplog cannot see them)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self._log = logging.getLogger("safer2_recommender_tpu_torch")
        self._level = self._log.level
        self._log.setLevel(logging.DEBUG)
        self._log.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._log.removeHandler(self)
        self._log.setLevel(self._level)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes and several worker processes side by side: one
    intra-op thread per process (results do not depend on it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    # a small synthetic set: 200 users x 120 items
    rng = np.random.default_rng(0)
    pairs = np.unique(np.stack([rng.integers(0, 200, 3000),
                                rng.integers(0, 120, 3000)], 1),
                      axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return ds, DeviceData.build(ds, device="cpu")


def _model(ds, name="ials", **cfg):
    return get_model(name, Config(**dict(dict(dim=8), **cfg)), ds.num_users,
                     ds.num_items, device="cpu")


def _csv(ds, path):
    with open(path, "w") as f:
        f.write("uid,sid\n")
        f.writelines(f"{u},{i}\n" for u, i in
                     zip(ds.user_ids.tolist(), ds.item_ids.tolist()))
    return path


def test_restored_state_without_perms_warns(tiny):
    # a trained state with no recorded permutation (a checkpoint restored
    # without its sidecar) evaluates with a one-time warning instead of
    # a silent identity remap
    ds, dd = tiny
    m = _model(ds)
    m.state = m.state.replace(steps=3)
    hist = Dataset(ds.user_ids[:50], ds.item_ids[:50])
    empty = Dataset(ds.user_ids[:0], ds.item_ids[:0])
    fold = FoldInData.build(hist, empty, num_items=ds.num_items,
                            device="cpu")
    with _Records() as logged:
        m._permute_fold(fold)
        m._permute_fold(fold)
    hits = [msg for msg in logged.messages
            if "no recorded id permutation" in msg]
    assert len(hits) == 1


def test_export_state_raises_on_trained_state_without_perms(tiny):
    ds, _ = tiny
    m = _model(ds)
    m.state = m.state.replace(steps=2)     # a restore without the sidecar
    with pytest.raises(ValueError, match="no recorded id permutation"):
        m.export_state()


def test_export_state_rejects_mismatched_dd(tiny):
    ds, dd = tiny
    m = _model(ds)
    m.initialize(dd)
    m.train_epoch(dd)
    dd2 = DeviceData.build(ds, device="cpu", min_bucket=4, growth=4)
    with pytest.raises(ValueError, match="does not match"):
        m.export_state(dd2)


_RESTORE_SCRIPT = r"""
import sys

sys.path.insert(0, sys.argv[7])
import numpy as np

ckpt_dir, tr_csv, te_csv, out_path, num_users, num_items = sys.argv[1:7]
num_users, num_items = int(num_users), int(num_items)

from safer2_recommender_tpu_torch import (CheckpointManager, Config,
                                          Dataset, FoldInData, Server,
                                          get_model)

# NO DeviceData is built in this process: the checkpoint alone carries
# what id-correct evaluation, serving and export need
model = get_model("safer2", Config(dim=8, bandwidth=0.3), num_users,
                  num_items, device="cpu")
state, epoch, meta = CheckpointManager(ckpt_dir).restore_with_meta(
    model.state, generator=model.generator)
assert state is not None and meta is not None
model.state = state
model.load_checkpoint_meta(meta)

tr, te = Dataset.from_csv(tr_csv), Dataset.from_csv(te_csv)
fold = FoldInData.build(tr, te, num_items=num_items, device="cpu")
res = model.evaluate_dataset(fold)
users, recs = model.recommend(tr, k=5)
susers, srecs = Server(model, k=5).recommend(tr)
exp = model.export_state()
np.savez(out_path, ndcg=res.ndcg, recall=res.recall, users=users,
         recs=recs, susers=susers, srecs=srecs, user_emb=exp["user_emb"],
         item_emb=exp["item_emb"], epoch=epoch)
"""


def test_self_contained_restore_subprocess_bit_identical(tmp_path, tiny):
    # train -> save -> restore in a FRESH process that never builds a
    # DeviceData -> evaluate, recommend, serve and export bit-identically
    # to the training process, with no id-space warning
    ds, dd = tiny
    m = _model(ds, "safer2", bandwidth=0.3)
    m.initialize(dd)
    m.train_epoch(dd)
    m.train_epoch(dd)
    ckpt_dir = str(tmp_path / "ckpt")
    CheckpointManager(ckpt_dir).save(m.state, epoch=2,
                                     meta=m.checkpoint_meta(),
                                     generator=m.generator)

    n = ds.nnz // 2
    tr_csv = _csv(Dataset(ds.user_ids[:n], ds.item_ids[:n]),
                  str(tmp_path / "tr.csv"))
    te_csv = _csv(Dataset(ds.user_ids[n:], ds.item_ids[n:]),
                  str(tmp_path / "te.csv"))
    tr, te = Dataset.from_csv(tr_csv), Dataset.from_csv(te_csv)
    fold = FoldInData.build(tr, te, num_items=ds.num_items, device="cpu")
    want = m.evaluate_dataset(fold)
    want_users, want_recs = m.recommend(tr, k=5)
    want_exp = m.export_state()

    script = str(tmp_path / "restore_eval.py")
    with open(script, "w") as f:
        f.write(_RESTORE_SCRIPT)
    out_path = str(tmp_path / "out.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, script, ckpt_dir, tr_csv, te_csv, out_path,
         str(ds.num_users), str(ds.num_items), REPO],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no recorded id permutation" not in proc.stderr
    assert "id sidecar" not in proc.stderr
    assert "jax" not in proc.stderr.lower()

    got = np.load(out_path)
    assert int(got["epoch"]) == 2
    np.testing.assert_array_equal(got["ndcg"], want.ndcg)
    np.testing.assert_array_equal(got["recall"], want.recall)
    np.testing.assert_array_equal(got["users"], want_users)
    np.testing.assert_array_equal(got["recs"], want_recs)
    np.testing.assert_array_equal(got["susers"], want_users)
    np.testing.assert_array_equal(got["srecs"], want_recs)
    np.testing.assert_array_equal(got["user_emb"], want_exp["user_emb"])
    np.testing.assert_array_equal(got["item_emb"], want_exp["item_emb"])


def test_checkpoint_roundtrip(tmp_path, tiny):
    ds, dd = tiny
    m = _model(ds, "safer2", bandwidth=0.3)
    m.initialize(dd)
    m.train_epoch(dd)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(m.state, epoch=1)

    m2 = _model(ds, "safer2", bandwidth=0.3)
    restored, epoch = mgr.restore(m2.state)
    assert epoch == 1
    assert restored.steps == 1 and isinstance(restored.steps, int)
    for name in ("user_emb", "user_loss", "xi", "eig_qu"):
        assert torch.equal(getattr(restored, name), getattr(m.state, name))
    assert restored.user_emb.device == m2.state.user_emb.device
    # resumed training proceeds as continued training does
    m2.state = restored
    m2.train_epoch(dd)
    m.train_epoch(dd)
    np.testing.assert_allclose(m.state.user_emb.numpy(),
                               m2.state.user_emb.numpy(), atol=1e-6)


def test_restore_empty_dir(tmp_path, tiny):
    ds, _ = tiny
    m = _model(ds)
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_epoch() is None
    restored, epoch = mgr.restore(m.state)
    assert restored is None and epoch == 0
    assert mgr.restore_with_meta(m.state) == (None, 0, None)


def test_cli_checkpoint_cadence_with_chained_dispatch(tmp_path, tiny):
    # --epochs_per_dispatch lands a dispatch boundary on every
    # --checkpoint_every multiple
    from safer2_recommender_tpu_torch.cli import main as cli_main

    ds, _ = tiny
    tr = _csv(ds, str(tmp_path / "tr.csv"))
    ck = str(tmp_path / "ckpt")
    rc = cli_main([
        "--model_name", "ials", "--train_data", tr,
        "--test_train_data", tr, "--test_test_data", tr, "--device", "cpu",
        "--dim", "4", "--epoch", "6", "--epochs_per_dispatch", "4",
        "--checkpoint_dir", ck, "--checkpoint_every", "2"])
    assert rc == 0
    assert CheckpointManager(ck).latest_epoch() == 6
    kept = sorted(p for p in os.listdir(ck) if p.startswith("state_"))
    assert kept == ["state_2.npz", "state_4.npz", "state_6.npz"]


def test_npz_restore_fills_missing_fields_from_template(tmp_path, tiny):
    # a checkpoint written before a field existed still resumes: absent
    # leaves come from the template
    ds, dd = tiny
    m = _model(ds)
    m.initialize(dd)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(m.state, epoch=3)
    path = os.path.join(str(tmp_path), "state_3.npz")
    data = dict(np.load(path))
    data.pop("eig_qu"), data.pop("eig_qv")
    np.savez(path, **data)

    m2 = _model(ds)
    with _Records() as logged:
        restored, epoch = mgr.restore(m2.state)
    assert epoch == 3
    assert torch.equal(restored.user_emb, m.state.user_emb)
    assert torch.equal(restored.eig_qu, m2.state.eig_qu)
    assert "Checkpoint lacks field 'eig_qu'; using template" in \
        logged.messages


def test_npz_prunes_to_three(tmp_path, tiny):
    ds, dd = tiny
    m = _model(ds)
    m.initialize(dd)
    mgr = CheckpointManager(str(tmp_path))
    for e in range(1, 6):
        mgr.save(m.state, epoch=e, meta=m.checkpoint_meta())
    for prefix in ("state", "meta"):
        kept = sorted(p for p in os.listdir(str(tmp_path))
                      if p.startswith(prefix + "_"))
        assert kept == [f"{prefix}_{e}.npz" for e in (3, 4, 5)]
    restored, epoch = mgr.restore(m.state)
    assert epoch == 5


def test_cli_saves_final_checkpoint(tmp_path, tiny):
    # --checkpoint_every need not divide --epoch (or be set at all): the
    # final state is saved
    from safer2_recommender_tpu_torch.cli import main as cli_main

    ds, _ = tiny
    tr = _csv(ds, str(tmp_path / "tr.csv"))
    base = ["--model_name", "ials", "--train_data", tr,
            "--test_train_data", tr, "--test_test_data", tr,
            "--device", "cpu", "--dim", "4"]
    ck = str(tmp_path / "ck_a")
    assert cli_main(base + ["--epoch", "5", "--checkpoint_dir", ck,
                            "--checkpoint_every", "2"]) == 0
    assert CheckpointManager(ck).latest_epoch() == 5
    ck2 = str(tmp_path / "ck_b")   # --checkpoint_dir without _every
    assert cli_main(base + ["--epoch", "2", "--checkpoint_dir", ck2]) == 0
    assert CheckpointManager(ck2).latest_epoch() == 2
    assert sorted(os.listdir(ck2)) == ["latest.json", "meta_2.npz",
                                       "state_2.npz"]


def test_jax_npz_checkpoint_restores_into_the_port(tmp_path, tiny):
    # a directory that the JAX package's CheckpointManager wrote through
    # its npz backend (state with a PRNG ``key`` field and an int32
    # ``steps``, plus the v2 sidecar) restores into the port, which then
    # exports exactly the JAX model's state
    ds, dd = tiny
    jds = jx.Dataset(ds.user_ids, ds.item_ids)
    jdd = jx.DeviceData.build(jds)
    cfg = dict(dim=8, bandwidth=0.3)
    jm = jx.get_model("safer2", jx.Config(**cfg), ds.num_users,
                      ds.num_items)
    jm.initialize(jdd)
    jm.train_epoch(jdd)
    jmgr = JCheckpointManager(str(tmp_path))
    jmgr._mgr = None                 # the npz backend, as orbax imports here
    jmgr.save(jm.state, epoch=1, meta=jm.checkpoint_meta())

    tm = get_model("safer2", Config(**cfg), ds.num_users, ds.num_items,
                   device="cpu")
    state, epoch, meta = CheckpointManager(str(tmp_path)).restore_with_meta(
        tm.state, generator=tm.generator)
    assert epoch == 1 and meta is not None
    tm.state = state
    tm.load_checkpoint_meta(meta)
    assert tm.state.steps == 1
    got, want = tm.export_state(), jm.export_state()
    assert sorted(got) == sorted(want)
    for key in ("user_emb", "item_emb", "user_loss", "dual_weight"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["xi"] == want["xi"]
    # and the port checkpoints it back in the layout the JAX package
    # restores
    out = str(tmp_path / "back")
    CheckpointManager(out).save(tm.state, epoch=1, meta=tm.checkpoint_meta(),
                                generator=tm.generator)
    jm2 = jx.get_model("safer2", jx.Config(**cfg), ds.num_users,
                       ds.num_items)
    jmgr2 = JCheckpointManager(out)
    jmgr2._mgr = None
    jstate, jepoch, jmeta = jmgr2.restore_with_meta(jm2.state)
    jm2.state = jstate
    jm2.load_checkpoint_meta(jmeta)
    np.testing.assert_array_equal(np.asarray(jm2.export_state()["user_emb"]),
                                  np.asarray(want["user_emb"]))


def test_resumed_safer2_equals_continued_with_the_generator(tmp_path, tiny):
    # sub-sampled Newton (use_snr) draws its samples from the model's
    # torch.Generator: a run resumed from a checkpoint, whose generator
    # state was saved beside the tables, ends where a continued run ends
    ds, dd = tiny
    cfg = dict(bandwidth=0.3, use_snr=True, sampling_ratio=0.5)
    m = _model(ds, "safer2", **cfg)
    m.initialize(dd)
    m.train_epoch(dd)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(m.state, epoch=1, meta=m.checkpoint_meta(),
             generator=m.generator)
    m.train_epoch(dd)
    m.train_epoch(dd)

    resumed = _model(ds, "safer2", **cfg)
    state, _, meta = mgr.restore_with_meta(resumed.state,
                                           generator=resumed.generator)
    resumed.state = state
    resumed.load_checkpoint_meta(meta)
    resumed.train_epoch(dd)
    resumed.train_epoch(dd)
    for key in ("user_emb", "item_emb", "dual_weight"):
        np.testing.assert_array_equal(resumed.export_state()[key],
                                      m.export_state()[key])
    assert float(resumed.state.xi) == float(m.state.xi)

    # without the generator's state the draws differ: the check has teeth
    fresh = _model(ds, "safer2", **cfg)
    state, _, meta = mgr.restore_with_meta(fresh.state)
    fresh.state = state
    fresh.load_checkpoint_meta(meta)
    fresh.train_epoch(dd)
    fresh.train_epoch(dd)
    assert float(fresh.state.xi) != float(m.state.xi)
