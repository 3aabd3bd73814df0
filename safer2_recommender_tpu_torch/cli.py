"""Command-line entry point of the PyTorch port, flag for flag the JAX
package's (``safer2_recommender_tpu/cli.py``, itself the reference's
``run_model``):

    python -m safer2_recommender_tpu_torch.cli \
        --model_name safer2 --train_data ml-1m/train.csv \
        --test_train_data ml-1m/validation_tr.csv \
        --test_test_data ml-1m/validation_te.csv \
        --dim 32 --uobs_weight 0.004 --l2_reg 0.004 --alpha 0.3 \
        --bandwidth 0.15 --epoch 50 --device cuda

The log lines are the JAX CLI's. ``--device`` (default ``cuda``) picks
the device; a missing CUDA device is an error, never a silent switch to
the CPU. Flags of features not ported yet are refused with the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.evaluation.metrics import (
    DEFAULT_ALPHA_LIST,
    DEFAULT_K_LIST,
    EvaluationResult,
)
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       DeviceUnavailable,
                                                       resolve_device)
from safer2_recommender_tpu_torch.utils.logging import Timer, setup

MODEL_CHOICES = ("ials", "ialspp", "safer2", "safer2pp", "cvar_mf",
                 "erm_mf")

# flag -> (is it set?, ROADMAP Queue 1 item that ports it)
_NOT_PORTED = {
    "--mesh": (lambda a: a.mesh != 0, 19),
    "--distributed": (lambda a: a.distributed != 0, 19),
    "--checkpoint_dir": (lambda a: a.checkpoint_dir is not None, 16),
    "--profile_dir": (lambda a: a.profile_dir is not None, 7),
    "--use_cg": (lambda a: a.use_cg != 0, 14),
    "--block_interleaved": (lambda a: a.block_interleaved != 0, 12),
}


def _existing_file(path: str) -> str:
    """``foo.csv`` with only ``foo.csv.gz`` present passes: Dataset.
    from_csv reads the gzipped twin (the bundled ML-1M fixture)."""
    import os

    if not os.path.isfile(path) and not os.path.isfile(path + ".gz"):
        raise argparse.ArgumentTypeError(f"File does not exist: {path}")
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="safer2_recommender_tpu_torch",
        description="frecsys experimentation utility (PyTorch/CUDA port)")
    # reference flags (run_model.cc:129-231)
    p.add_argument("-n", "--model_name", required=True,
                   type=str.lower, choices=MODEL_CHOICES)
    p.add_argument("--train_data", required=True, type=_existing_file)
    p.add_argument("--test_train_data", required=True, type=_existing_file)
    p.add_argument("--test_test_data", required=True, type=_existing_file)
    p.add_argument("-d", "--dim", type=int, default=8)
    p.add_argument("--uobs_weight", type=float, default=0.1)
    p.add_argument("-r", "--l2_reg", type=float, default=0.002)
    p.add_argument("--l2_reg_exp", type=float, default=1.0)
    p.add_argument("-s", "--stdev", type=float, default=0.1)
    p.add_argument("-e", "--epoch", type=int, default=50)
    p.add_argument("--block_size", type=int, default=64)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--bandwidth", type=float, default=1.0)
    p.add_argument("--stepsize", type=float, default=0.1)
    p.add_argument("--xi_iterations", type=int, default=5)
    p.add_argument("--pd_iterations", type=int, default=1)
    p.add_argument("--sampling_ratio", type=float, default=0.1)
    p.add_argument("--use_epanechnikov", type=int, default=0)
    p.add_argument("--use_snr", type=int, default=0)
    p.add_argument("--use_cg", type=int, default=0)
    p.add_argument("--cg_error_tolerance", type=float, default=1e-10)
    p.add_argument("--cg_max_iterations", type=int, default=100)
    p.add_argument("--print_train_stats", type=int, default=1)
    p.add_argument("--print_evaluation_stats", type=int, default=0)
    # accepted-but-unused, matching the reference exactly
    p.add_argument("--print_test_results", type=int, default=0)
    p.add_argument("--print_residual_stats", type=int, default=0)
    p.add_argument("--print_var_stats", type=int, default=0)
    # additions of the JAX package (the unported ones are refused)
    p.add_argument("--distributed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eig_refresh_tol", type=float, default=8e-2)
    p.add_argument("--block_interleaved", type=int, default=0)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--epochs_per_dispatch", type=int, default=1,
                   help="train this many epochs between log lines (>1 "
                        "skips the per-epoch stats lines)")
    p.add_argument("--compute_dtype", choices=("auto", "f32", "bf16"),
                   default="auto",
                   help="normal-equation assembly dtype; the port computes "
                        "in f32 ('bf16' is not ported yet)")
    # addition of the port
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to run on (default cuda; fails when "
                        "CUDA is absent rather than fall back to the CPU)")
    return p


@dataclasses.dataclass
class RunResult:
    """What one CLI run produced: the trained model, the final
    validation metrics, each logged train span in ms (one per dispatch
    of ``--epochs_per_dispatch`` epochs) and the mean dual weight after
    each span."""

    model: object
    metrics: EvaluationResult
    epoch_ms: List[int]
    mean_weights: List[float]


def run(argv: Optional[List[str]] = None) -> RunResult:
    """Parse ``argv``, train, evaluate; the body of ``main``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, (is_set, item) in _NOT_PORTED.items():
        if is_set(args):
            parser.error(f"{flag} is not ported to PyTorch yet (ROADMAP "
                         f"Queue 1 item {item})")
    if args.model_name != "safer2":
        parser.error(f"--model_name {args.model_name} is not ported to "
                     "PyTorch yet; ported: safer2 (ROADMAP Queue 1)")
    try:
        device = resolve_device(args.device)
    except DeviceUnavailable as e:
        parser.error(f"--device {args.device}: {e}")
    log = setup()

    from safer2_recommender_tpu_torch.data.dataset import (
        Dataset,
        DeviceData,
        FoldInData,
    )
    from safer2_recommender_tpu_torch.models import get_model

    cfg = Config(
        dim=args.dim, uobs_weight=args.uobs_weight, l2_reg=args.l2_reg,
        l2_reg_exp=args.l2_reg_exp, stdev=args.stdev,
        block_size=args.block_size, alpha=args.alpha,
        bandwidth=args.bandwidth, stepsize=args.stepsize,
        xi_iterations=args.xi_iterations,
        sampling_ratio=args.sampling_ratio,
        pd_iterations=args.pd_iterations,
        use_epanechnikov=bool(args.use_epanechnikov),
        use_snr=bool(args.use_snr), use_cg=bool(args.use_cg),
        cg_error_tolerance=args.cg_error_tolerance,
        cg_max_iterations=args.cg_max_iterations,
        eig_refresh_tol=args.eig_refresh_tol,
        compute_dtype=args.compute_dtype,
        block_interleaved=bool(args.block_interleaved),
        epochs=args.epoch, seed=args.seed,
    )

    train = Dataset.from_csv(args.train_data)
    test_tr = Dataset.from_csv(args.test_train_data)
    test_te = Dataset.from_csv(args.test_test_data)
    for name, ds in (("--test_train_data", test_tr),
                     ("--test_test_data", test_te)):
        # an out-of-range item id would index past the item table or
        # collide with the padding sentinel
        if ds.item_ids.size and int(ds.item_ids.max()) >= train.num_items:
            raise SystemExit(
                f"{name} contains item id {int(ds.item_ids.max())} "
                f">= the training catalog size {train.num_items}")

    dd = DeviceData.build(train, device=device, dim=args.dim)
    fold = FoldInData.build(test_tr, test_te, num_items=train.num_items,
                            device=device, dim=args.dim)

    model = get_model(args.model_name, cfg, train.num_users,
                      train.num_items, device=device)
    model.set_print_train_stats(bool(args.print_train_stats))
    model.set_print_residual_stats(bool(args.print_residual_stats))
    model.set_print_var_stats(bool(args.print_var_stats))
    model.initialize(dd)

    def evaluate(epoch: int) -> EvaluationResult:
        metrics = model.evaluate_dataset(fold, DEFAULT_K_LIST,
                                         DEFAULT_ALPHA_LIST)
        log.info("Epoch %d:", epoch)
        metrics.show()
        return metrics

    step = max(1, args.epochs_per_dispatch)
    epoch_ms, mean_weights = [], []
    epoch = 0
    while epoch < cfg.epochs:
        n = min(step, cfg.epochs - epoch)
        with Timer(device) as t:
            if n == 1:
                model.train_epoch(dd)
            else:
                model.train_epochs(dd, n)
        log.info("Epoch: %d, Timer: Train=%d", epoch + n - 1, t.ms // n)
        epoch_ms.append(t.ms // n)
        mean_weights.append(model.get_mean_weight())
        if args.print_evaluation_stats:
            evaluate(epoch + n - 1)
        epoch += n

    log.info("Validation Results")
    metrics = evaluate(cfg.epochs)
    return RunResult(model=model, metrics=metrics, epoch_ms=epoch_ms,
                     mean_weights=mean_weights)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
