"""The port's CLI (python -m safer2_recommender_tpu_torch.cli) on the
bundled ML-1M split, on the CPU: the JAX CLI's line formats, refused
flags of unported features, and no silent fall-back from CUDA."""

import os
import re
import subprocess
import sys

import pytest
import torch

ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300):
    cmd = [sys.executable, "-m", "safer2_recommender_tpu_torch.cli",
           "--model_name", "safer2",
           "--train_data", os.path.join(ML1M_DIR, "train.csv"),
           "--test_train_data", os.path.join(ML1M_DIR, "validation_tr.csv"),
           "--test_test_data", os.path.join(ML1M_DIR, "validation_te.csv"),
           ] + args
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          timeout=timeout)


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


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "2"], "item 19"),
    (["--distributed", "1"], "item 19"),
    (["--checkpoint_dir", "ckpt"], "item 16"),
    (["--profile_dir", "prof"], "item 7"),
    (["--use_cg", "1"], "item 14"),
    (["--block_interleaved", "1"], "item 12"),
])
def test_cli_refuses_unported_flags(flags, item, capsys):
    err = _refused(["--model_name", "safer2", "--device", "cpu"] + flags,
                   capsys)
    assert "not ported to PyTorch yet" in err and item in err


@pytest.mark.parametrize("name,message", [
    ("ials", "ported: safer2"), ("nope", "invalid choice")])
def test_cli_refuses_unported_models_and_unknown_ones(name, message, capsys):
    err = _refused(["--model_name", name, "--device", "cpu"], capsys)
    assert message in err


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
