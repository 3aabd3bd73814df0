"""Command-line entry point of the PyTorch port, flag for flag the JAX
package's (``safer2_recommender_tpu/cli.py``, itself the reference's
``run_model``):

    python -m safer2_recommender_tpu_torch.cli \
        --model_name safer2 --train_data ml-1m/train.csv \
        --test_train_data ml-1m/validation_tr.csv \
        --test_test_data ml-1m/validation_te.csv \
        --dim 32 --uobs_weight 0.004 --l2_reg 0.004 --alpha 0.3 \
        --bandwidth 0.15 --epoch 50 --device cuda

All six models run (``ials``, ``ialspp``, ``erm_mf``, ``cvar_mf``,
``safer2``, ``safer2pp``), and the log lines are the JAX CLI's.
``--checkpoint_dir`` resumes from the newest checkpoint there (with its
id sidecar) and saves every ``--checkpoint_every`` epochs and at the
end. ``--compute_dtype bf16`` assembles the normal equations from
bfloat16 history slabs (``"auto"`` is float32 in the port).
``--profile_dir DIR`` writes a ``torch.profiler`` trace of the training
loop (CPU activity, and CUDA activity on the card) under DIR as
``<host>_<pid>.<ns>.pt.trace.json``, a Chrome trace (chrome://tracing,
Perfetto, TensorBoard's profiler plugin). ``--device`` (default
``cuda``) picks the device; a missing CUDA device is an error, never a
silent switch to the CPU.

Multi-device runs (``parallel/mesh.py``), one process per device:
``--mesh N`` spawns N local ranks (``--device cpu``: N gloo processes; on
CUDA one card each, NCCL); ``--distributed 1`` joins the process group
that torchrun's environment describes, one rank per process::

    torchrun --nproc_per_node 2 -m safer2_recommender_tpu_torch.cli \
        --distributed 1 --model_name safer2 ...

Every rank logs the JAX CLI's lines, its rank in the prefix.
"""

from __future__ import annotations

import argparse
import contextlib
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
    # additions of the JAX package
    p.add_argument("--distributed", type=int, default=0,
                   help="join the process group of torchrun's environment "
                        "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) "
                        "and shard over all its ranks")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard over this many devices, one spawned local "
                        "process each (0 = single device)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eig_refresh_tol", type=float, default=0.0,
                   help="warm eigenbasis refresh tolerance at dim >= 256: "
                        "0 (default) takes a full eigh every sweep; 0.08 "
                        "is the JAX package's default and its warm branch")
    p.add_argument("--block_interleaved", type=int, default=0)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the training loop "
                        "under this directory (the reference only has "
                        "wall-clock timers, run_model.cc:258-266)")
    p.add_argument("--epochs_per_dispatch", type=int, default=1,
                   help="train this many epochs between log lines (>1 "
                        "skips the per-epoch stats lines)")
    p.add_argument("--compute_dtype", choices=("auto", "f32", "bf16"),
                   default="auto",
                   help="normal-equation assembly dtype: 'bf16' gathers "
                        "the history slabs in bfloat16 and accumulates in "
                        "f32; 'auto' is 'f32' in the port")
    # addition of the port
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to run on (default cuda; fails when "
                        "CUDA is absent rather than fall back to the CPU)")
    return p


@contextlib.contextmanager
def profiled(profile_dir: Optional[str], device):
    """A ``torch.profiler`` trace of the body (CPU activity, and CUDA
    activity on the card) written under ``profile_dir`` when the body
    ends; nothing when ``profile_dir`` is None."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield


@dataclasses.dataclass
class RunResult:
    """What one CLI run produced: the trained model, the final
    validation metrics, each logged train span in ms (one per dispatch
    of ``--epochs_per_dispatch`` epochs) and the mean dual weight after
    each span. A ``--mesh`` run returns rank 0's, without the model
    (it stays in its process)."""

    model: object
    metrics: EvaluationResult
    epoch_ms: List[int]
    mean_weights: List[float]


def run(argv: Optional[List[str]] = None) -> RunResult:
    """Parse ``argv``, train, evaluate; the body of ``main``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except DeviceUnavailable as e:
        parser.error(f"--device {args.device}: {e}")
    if args.mesh < 0:
        parser.error(f"--mesh {args.mesh}: must be >= 0")
    from safer2_recommender_tpu_torch import parallel

    if args.distributed:
        mesh = parallel.init_distributed(args.device)
        if args.mesh and args.mesh != mesh.world_size:
            parser.error(f"--mesh {args.mesh} with --distributed 1: the "
                         f"process group has {mesh.world_size} ranks")
        setup(mesh=mesh).info(
            "distributed: process %d/%d, %d global devices", mesh.rank,
            mesh.world_size, mesh.world_size)
        return _train(args, mesh.device, mesh)
    if args.mesh:
        import torch

        count = torch.cuda.device_count()
        if device.type == "cuda" and args.mesh > count:
            raise SystemExit(f"--mesh {args.mesh} exceeds the {count} "
                             "available devices")
        try:
            return parallel.spawn(_mesh_rank, args.mesh, device=args.device,
                                  args=(argv,))[0]
        except RuntimeError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from e
    return _train(args, device, None)


def _mesh_rank(mesh, argv: Optional[List[str]]) -> RunResult:
    """One rank of a ``--mesh`` run (``parallel.spawn``)."""
    res = _train(build_parser().parse_args(argv), mesh.device, mesh)
    return dataclasses.replace(res, model=None)


def _train(args, device, mesh) -> RunResult:
    """Train and evaluate as ``args`` say, on ``device`` (and ``mesh``,
    None for one device)."""
    log = setup(mesh=mesh)

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

    dd = DeviceData.build(train, device=device, dim=args.dim, mesh=mesh)
    fold = FoldInData.build(test_tr, test_te, num_items=train.num_items,
                            device=device, dim=args.dim, mesh=mesh)

    model = get_model(args.model_name, cfg, train.num_users,
                      train.num_items, device=device, mesh=mesh)
    model.set_print_train_stats(bool(args.print_train_stats))
    model.set_print_residual_stats(bool(args.print_residual_stats))
    model.set_print_var_stats(bool(args.print_var_stats))

    ckpt, restored, start_epoch = None, None, 0
    if args.checkpoint_dir:
        from safer2_recommender_tpu_torch.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir, mesh=mesh)
        restored, start_epoch, meta = ckpt.restore_with_meta(
            model.state, generator=model.generator)
    if restored is not None:
        model.state = restored
        model.load_checkpoint_meta(meta)
        log.info("Restored checkpoint at epoch %d", start_epoch)
    else:
        # the SAFER-family warm start is a full-dataset pass: skip it
        # when a checkpoint overwrites the state anyway
        model.initialize(dd)

    def save(epoch: int) -> None:
        ckpt.save(model.state, epoch, meta=model.checkpoint_meta(),
                  generator=model.generator)

    def evaluate(epoch: int) -> EvaluationResult:
        metrics = model.evaluate_dataset(fold, DEFAULT_K_LIST,
                                         DEFAULT_ALPHA_LIST)
        log.info("Epoch %d:", epoch)
        metrics.show()
        return metrics

    step = max(1, args.epochs_per_dispatch)
    epoch_ms, mean_weights = [], []
    epoch = last_saved = start_epoch
    with profiled(args.profile_dir, device):
        while epoch < cfg.epochs:
            n = min(step, cfg.epochs - epoch)
            if ckpt is not None and args.checkpoint_every:
                # land a dispatch boundary on every checkpoint multiple
                k = args.checkpoint_every
                n = min(n, k - epoch % k)
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
            if ckpt is not None and args.checkpoint_every and (
                    (epoch + n) % args.checkpoint_every == 0):
                save(epoch + n)
                last_saved = epoch + n
            epoch += n
    if args.profile_dir is not None:
        log.info("Profile trace of the training loop written under %s",
                 args.profile_dir)

    # persist the final state: --checkpoint_every may not divide --epoch
    # (or may be unset while --checkpoint_dir is given)
    if ckpt is not None and cfg.epochs > start_epoch \
            and last_saved != cfg.epochs:
        save(cfg.epochs)

    log.info("Validation Results")
    metrics = evaluate(cfg.epochs)
    return RunResult(model=model, metrics=metrics, epoch_ms=epoch_ms,
                     mean_weights=mean_weights)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
