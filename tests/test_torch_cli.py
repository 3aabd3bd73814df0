"""The port's CLI (python -m safer2_recommender_tpu_torch.cli) on the
bundled ML-1M split, on the CPU: the JAX CLI's line formats, refused
arguments, --profile_dir, --compute_dtype bf16, and no silent fall-back
from CUDA. --mesh and --distributed run in
tests/test_torch_distributed.py."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300, model="safer2"):
    cmd = [sys.executable, "-m", "safer2_recommender_tpu_torch.cli",
           "--model_name", model,
           "--train_data", os.path.join(ML1M_DIR, "train.csv"),
           "--test_train_data", os.path.join(ML1M_DIR, "validation_tr.csv"),
           "--test_test_data", os.path.join(ML1M_DIR, "validation_te.csv"),
           ] + args
    # one intra-op thread: the shapes are small, and the suite's worker
    # processes run side by side
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          timeout=timeout, env=env)


def test_cli_two_epochs_on_ml1m_prints_the_jax_line_formats():
    res = _run(["--dim", "8", "--uobs_weight", "0.004", "--l2_reg", "0.004",
                "--alpha", "0.3", "--bandwidth", "0.15", "--epoch", "2",
                "--print_var_stats", "1", "--device", "cpu"])
    assert res.returncode == 0, res.stderr[-3000:]
    err = res.stderr
    prefix = r"^I\d{4} \d\d:\d\d:\d\d safer2_recommender_tpu_torch\] "
    for pattern in (
            r"max_user=\d+\tmax_item=\d+\tdistinct user=\d+\t"
            r"distinct item=\d+\tnum_tuples=388246$",
            r"Loss=[\d.]+ Loss_observed=[\d.]+ Loss_unobserved=[\d.]+ "
            r"Loss_reg=[\d.]+ Loss_reg \(user\)=[\d.]+ "
            r"Loss_reg \(item\)=[\d.]+$",
            r"Time=\d+$",
            r"Weighted Loss: [\d.e-]+$",
            r"Xi:[\d.e-]+$",
            r"VaR: [\d.e-]+ CVaR: [\d.e-]+$",
            r"Min: \d\.\d{3}, Mean: \d\.\d{3}, Max: \d\.\d{3}$",
            r"Epoch: 1, Timer: Train=\d+$",
            r"Validation Results$",
            r"Epoch 2:$",
            r"Mean Rec@5=\d\.\d{4} Mean Rec@10=\d\.\d{4} Mean Rec@20=\d\.\d{4}"
            r" Mean Rec@50=\d\.\d{4} Mean Rec@100=\d\.\d{4}$",
            r"Mean NDCG@5=\d\.\d{4} .* Mean NDCG@100=\d\.\d{4}$",
            r"Rec CVaR \(q=0\.30\)@5=\d\.\d{4} ",
            r"NDCG CVaR \(q=0\.90\)@5=\d\.\d{4} .*"
            r"NDCG CVaR \(q=0\.90\)@100=\d\.\d{4}$"):
        assert re.search(prefix + pattern, err, re.M), pattern
    ndcg20 = float(re.search(r"Mean NDCG@20=(\d\.\d{4})", err).group(1))
    assert ndcg20 >= 0.2


def _refused(argv, capsys):
    """Run the CLI in-process on arguments it must refuse; its stderr."""
    from safer2_recommender_tpu_torch import cli

    base = ["--train_data", os.path.join(ML1M_DIR, "train.csv"),
            "--test_train_data", os.path.join(ML1M_DIR, "validation_tr.csv"),
            "--test_test_data", os.path.join(ML1M_DIR, "validation_te.csv")]
    with pytest.raises(SystemExit) as exc:
        cli.run(base + argv)
    assert exc.value.code != 0
    return capsys.readouterr().err


def test_cli_profile_dir_writes_a_trace_of_the_training_loop(tmp_path):
    # --profile_dir is ported (it was refused with item 7): a 2-epoch run
    # writes one torch.profiler Chrome trace under the directory, and it
    # holds the epochs' ops
    import json

    prof = tmp_path / "prof"
    res = _run(["--dim", "8", "--uobs_weight", "0.004", "--l2_reg", "0.004",
                "--alpha", "0.3", "--bandwidth", "0.15", "--epoch", "2",
                "--print_train_stats", "0", "--device", "cpu",
                "--profile_dir", str(prof)])
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"Profile trace of the training loop written under {prof}" \
        in res.stderr
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::bmm" in n for n in names)


def test_cli_checkpoint_dir_saves_and_resumes(tmp_path, capsys):
    # --checkpoint_dir is ported (it was refused with item 16): a run of 2
    # epochs saves, a run to 3 resumes from epoch 2 and trains one more,
    # and ends where an uninterrupted 3-epoch run ends
    from safer2_recommender_tpu_torch import cli
    from safer2_recommender_tpu_torch.checkpoint import CheckpointManager

    base = ["--model_name", "safer2", "--device", "cpu", "--dim", "8",
            "--uobs_weight", "0.004", "--l2_reg", "0.004", "--alpha", "0.3",
            "--bandwidth", "0.15", "--print_train_stats", "0",
            "--train_data", os.path.join(ML1M_DIR, "train.csv"),
            "--test_train_data", os.path.join(ML1M_DIR, "validation_tr.csv"),
            "--test_test_data", os.path.join(ML1M_DIR, "validation_te.csv")]
    ck = str(tmp_path / "ckpt")
    torch.set_num_threads(1)
    cli.run(base + ["--epoch", "2", "--checkpoint_dir", ck])
    assert CheckpointManager(ck).latest_epoch() == 2
    capsys.readouterr()
    resumed = cli.run(base + ["--epoch", "3", "--checkpoint_dir", ck])
    assert "Restored checkpoint at epoch 2" in capsys.readouterr().err
    assert CheckpointManager(ck).latest_epoch() == 3
    assert len(resumed.epoch_ms) == 1            # one epoch was trained
    straight = cli.run(base + ["--epoch", "3"])
    got, want = resumed.model.export_state(), straight.model.export_state()
    for key in ("user_emb", "item_emb", "dual_weight"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(resumed.metrics.ndcg,
                                  straight.metrics.ndcg)


@pytest.mark.parametrize("name,flags,message", [
    # all six names are accepted; an unknown name is refused by the
    # parser
    ("nope", [], "invalid choice")])
def test_cli_refuses_unported_models_and_unknown_ones(name, flags, message,
                                                      capsys):
    err = _refused(["--model_name", name, "--device", "cpu"] + flags, capsys)
    assert message in err
    from safer2_recommender_tpu_torch import MODEL_REGISTRY, cli
    assert sorted(cli.MODEL_CHOICES) == sorted(MODEL_REGISTRY)


@pytest.mark.parametrize("name,flags", [
    ("safer2", ["--use_cg", "1", "--uobs_weight", "0.004", "--l2_reg",
                "0.004", "--bandwidth", "0.15"]),
    ("ials", ["--use_cg", "1", "--uobs_weight", "0.1", "--l2_reg", "0.003"]),
    ("erm_mf", ["--use_cg", "1", "--uobs_weight", "0.004", "--l2_reg",
                "0.005"]),
    ("ialspp", ["--block_interleaved", "1", "--block_size", "4",
                "--uobs_weight", "0.1", "--l2_reg", "0.003"]),
    ("safer2pp", ["--block_interleaved", "1", "--block_size", "4",
                  "--uobs_weight", "0.004", "--l2_reg", "0.004",
                  "--bandwidth", "0.15"]),
], ids=["safer2-cg", "ials-cg", "erm_mf-cg", "ialspp-interleaved",
        "safer2pp-interleaved"])
def test_cli_runs_cg_and_the_interleaved_order_end_to_end(name, flags,
                                                          monkeypatch):
    # --use_cg (the exact models) and --block_interleaved (the ++ models,
    # dim % block_size == 0) train 2 epochs at dim 8 and evaluate; CG
    # never reaches the inverse-Cholesky kernel's wrapper, the
    # interleaved order's block solves do
    from safer2_recommender_tpu_torch import cli
    from safer2_recommender_tpu_torch.ops import block_chol

    calls = []
    wrapper = block_chol.chol_inverse_small
    monkeypatch.setattr(block_chol, "chol_inverse_small",
                        lambda a, r: calls.append(1) or wrapper(a, r))
    torch.set_num_threads(1)
    res = cli.run(["--model_name", name, "--device", "cpu", "--dim", "8",
                   "--alpha", "0.3", "--epoch", "2",
                   "--print_train_stats", "0",
                   "--train_data", os.path.join(ML1M_DIR, "train.csv"),
                   "--test_train_data",
                   os.path.join(ML1M_DIR, "validation_tr.csv"),
                   "--test_test_data",
                   os.path.join(ML1M_DIR, "validation_te.csv")] + flags)
    cfg = res.model.cfg
    assert cfg.use_cg == ("--use_cg" in flags)
    assert cfg.block_interleaved == ("--block_interleaved" in flags)
    assert res.model._loss_lags_one_epoch == cfg.use_cg
    s = res.model.state
    assert torch.isfinite(s.user_emb).all() and torch.isfinite(s.item_emb).all()
    assert len(res.epoch_ms) == 2 and s.steps == 2
    assert bool(calls) != cfg.use_cg
    assert float(res.metrics.mean_ndcg()[2]) > 0.1


_PREFIX = r"^I\d{4} \d\d:\d\d:\d\d safer2_recommender_tpu_torch\] "
_LOSS_LINE = (r"Loss=[\d.]+ Loss_observed=[\d.]+ Loss_unobserved=[\d.]+ "
              r"Loss_reg=[\d.]+ Loss_reg \(user\)=[\d.]+ "
              r"Loss_reg \(item\)=[\d.]+$")
_NUM = r"[\d.e-]+"


@pytest.mark.parametrize("model,args,lines,absent", [
    ("ials", ["--uobs_weight", "0.1", "--l2_reg", "0.003"],
     [], ["Weighted Loss", "Xi:"]),
    ("ialspp", ["--uobs_weight", "0.1", "--l2_reg", "0.003",
                "--block_size", "4"], [], ["Weighted Loss", "Xi:"]),
    ("erm_mf", ["--uobs_weight", "0.004", "--l2_reg", "0.005"],
     [rf"Weighted Loss: {_NUM}$"], ["Xi:", "Mean weights"]),
    ("cvar_mf", ["--uobs_weight", "0.008", "--l2_reg", "0.002",
                 "--stepsize", "0.4"],
     [rf"Weighted Loss: {_NUM}$", rf"Mean weights: {_NUM}$", rf"Xi:{_NUM}$"],
     []),
    ("safer2pp", ["--uobs_weight", "0.004", "--l2_reg", "0.004",
                  "--bandwidth", "0.15", "--block_size", "4"],
     [rf"Weighted Loss: {_NUM}$", rf"Xi:{_NUM}$"], ["Mean weights"]),
])
def test_cli_two_epochs_of_each_new_model_print_the_jax_line_formats(
        model, args, lines, absent):
    res = _run(["--dim", "8", "--alpha", "0.3", "--epoch", "2",
                "--print_var_stats", "1", "--device", "cpu"] + args,
               model=model)
    assert res.returncode == 0, res.stderr[-3000:]
    err = res.stderr
    for pattern in [_LOSS_LINE, r"Time=\d+$",
                    rf"VaR: {_NUM} CVaR: {_NUM}$",
                    r"Min: \d\.\d{3}, Mean: \d\.\d{3}, Max: \d\.\d{3}$",
                    r"note: loss-derived stats lag one epoch",
                    r"Epoch: 0, Timer: Train=\d+$",
                    r"Epoch: 1, Timer: Train=\d+$", r"Validation Results$",
                    r"Epoch 2:$",
                    r"Mean NDCG@5=\d\.\d{4} .* Mean NDCG@100=\d\.\d{4}$",
                    ] + lines:
        assert len(re.findall(_PREFIX + pattern, err, re.M)) >= 1, pattern
    for word in absent:
        assert word not in err, word
    # the loss decomposition is printed once per epoch
    assert len(re.findall(_PREFIX + _LOSS_LINE, err, re.M)) == 2
    assert float(re.search(r"Mean NDCG@20=(\d\.\d{4})", err).group(1)) > 0.0


def test_cli_rejects_missing_file(capsys):
    # tests/test_cli.py::test_cli_rejects_missing_file: the parser checks
    # that the file (or its .gz twin) exists before anything is read
    from safer2_recommender_tpu_torch import cli

    with pytest.raises(SystemExit) as exc:
        cli.run(["--model_name", "ials", "--train_data", "/no/such.csv",
                 "--device", "cpu"])
    assert exc.value.code != 0
    assert "File does not exist: /no/such.csv" in capsys.readouterr().err


def test_cli_print_residual_stats_prints_the_jax_line_each_epoch():
    # the JAX CLI's residual line (safer2_recommender_tpu/models/base.py:
    # 447), once per epoch, after the epoch's own lines
    res = _run(["--dim", "8", "--alpha", "0.3", "--bandwidth", "0.15",
                "--uobs_weight", "0.004", "--l2_reg", "0.004",
                "--block_size", "4", "--epoch", "2", "--print_train_stats",
                "0", "--print_residual_stats", "1", "--device", "cpu"],
               model="safer2pp")
    assert res.returncode == 0, res.stderr[-3000:]
    found = re.findall(_PREFIX + rf"U residual: ({_NUM}), V residual: "
                       rf"({_NUM}), z residual: ({_NUM})$", res.stderr, re.M)
    assert len(found) == 2, res.stderr[-3000:]
    for row in found:
        u, v, z = (float(x) for x in row)
        # both tables move in an epoch from random tables
        assert u > 0 and v > 0 and z >= 0


def test_pyproject_names_the_ports_console_script():
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    targets = sorted(scripts.values())
    assert targets == ["safer2_recommender_tpu.cli:main",
                       "safer2_recommender_tpu_torch.cli:main"]
    name = next(k for k, v in scripts.items()
                if v == "safer2_recommender_tpu_torch.cli:main")
    module, func = scripts[name].split(":")
    assert callable(getattr(importlib.import_module(module), func))


def test_cli_fails_without_cuda_instead_of_using_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # --device defaults to cuda
    err = _refused(["--model_name", "safer2", "--epoch", "1"], capsys)
    assert "CUDA is not available" in err


def test_cli_runs_the_woodbury_path_at_dim_128(tmp_path):
    # dim >= 128 trains and evaluates through the Woodbury and rotated
    # solves (a small synthetic set, in-process, on the CPU)
    import numpy as np

    from safer2_recommender_tpu_torch import cli
    from safer2_recommender_tpu_torch.data.synth import write_csv
    from safer2_recommender_tpu_torch.ops import woodbury

    rng = np.random.default_rng(0)
    pairs = np.unique(np.concatenate([
        np.stack([rng.integers(0, 300, 9000), rng.integers(0, 30, 9000)], 1),
        np.stack([rng.integers(0, 300, 1500), rng.integers(30, 80, 1500)], 1),
    ]), axis=0).astype(np.int32)
    held = pairs[:, 0] < 40
    even = pairs[:, 1] % 2 == 0
    paths = {}
    for name, sel in (("train", ~held), ("test_tr", held & even),
                      ("test_te", held & ~even)):
        paths[name] = str(tmp_path / f"{name}.csv")
        write_csv(paths[name], pairs[sel, 0], pairs[sel, 1])
    woodbury.reset_solve_paths()
    res = cli.run(["--model_name", "safer2", "--train_data", paths["train"],
                   "--test_train_data", paths["test_tr"],
                   "--test_test_data", paths["test_te"], "--dim", "128",
                   "--uobs_weight", "0.004", "--l2_reg", "0.004",
                   "--alpha", "0.3", "--bandwidth", "0.15", "--epoch", "2",
                   "--device", "cpu"])
    assert woodbury.SOLVE_PATHS["woodbury"] > 0
    assert woodbury.SOLVE_PATHS["rotated"] > 0
    s = res.model.state
    assert torch.isfinite(s.user_emb).all() and torch.isfinite(s.item_emb).all()
    assert len(res.epoch_ms) == 2
    assert all(0.0 < w < 1.0 for w in res.mean_weights)
    assert np.isfinite(res.metrics.mean_ndcg()).all()


def test_cli_bf16_trains_ml1m_to_the_quality_gates():
    # --compute_dtype bf16 is ported: SAFER2 at the reference test's
    # config reaches the ML-1M gates (tests/test_models_ml1m.py). Last in
    # the file: the first in-process run binds the package logger to the
    # stderr of its test, and test_cli_checkpoint_dir_saves_and_resumes
    # reads its own
    from safer2_recommender_tpu_torch import cli

    torch.set_num_threads(1)
    res = cli.run([
        "--model_name", "safer2", "--device", "cpu", "--dim", "8",
        "--uobs_weight", "0.004", "--l2_reg", "0.004", "--alpha", "0.3",
        "--bandwidth", "0.15", "--epoch", "10", "--print_train_stats", "0",
        "--compute_dtype", "bf16",
        "--train_data", os.path.join(ML1M_DIR, "train.csv"),
        "--test_train_data", os.path.join(ML1M_DIR, "validation_tr.csv"),
        "--test_test_data", os.path.join(ML1M_DIR, "validation_te.csv")])
    assert res.model.asm_dtype == torch.bfloat16
    assert res.metrics.mean_ndcg()[2] >= 0.2
    assert len(res.mean_weights) == 10
    for w in res.mean_weights:
        assert w == pytest.approx(0.3, abs=0.02)
