"""Training entry point of the port (counterpart of the root train_cli.py).

Config-driven model and criterion, WarmUpPolyLR + AdamW, an epoch loop over
the threaded TrainLoader with per-epoch loss logging, checkpoints at the
config's cadence and resume with -c, on the card unless `--device cpu`.
`-d 0,1,2,3` trains data-parallel, one process per card (parallel/
launch.py; `--mesh dp` takes the largest count of them that divides the
global batch, `dp:N` exactly N), with the JAX data mesh's semantics: the
global batch of --batch_size is split over the ranks and a step computes
what one process computes on it. `--mesh 2d:D,S` takes D x S of them, data
x spatial: the global batch is split over D data ranks and each image's
rows over the S ranks of its data rank (parallel/spatial.py; the mit_*
and mit_*pp towers, remat on or off, the MLPDecoder and the cross-entropy
loss). `--mesh tp:D,M` takes
D x M of them, data x model: the global batch is split over D data ranks
and the hidden width of every Mix-FFN and Swin MLP over the M ranks of a
data rank (parallel/tensor.py; every family: where no layer splits, the M
ranks run as replicas). On the CPU
`--device cpu -d 0,1` runs two gloo ranks. Under torchrun the command runs
as the rank it is given.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.train_cli --config mfnet \\
        --dataset_root /path/to/MFNet [--niters N --epochs E] [-c] [-d 0,1]

Checkpoints go to <log_dir>/<tag>/checkpoint/epoch-N.pth (the original
repo's format: {"model", "optimizer", "epoch", "iteration"}, with an
epoch-last.pth link), scalars to <log_dir>/<tag>/metrics.jsonl.
`-p DIR` writes a torch.profiler trace of the run's last epoch to DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="mfnet",
                        help="preset name: mfnet | pst900 | nyu")
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--train_source", default=None,
                        help="override split file, e.g. train.txt")
    parser.add_argument("--eval_source", default=None,
                        help="override eval split file, e.g. test.txt")
    parser.add_argument("--backbone", default=None)
    parser.add_argument("--decoder", default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--niters", type=int, default=None,
                        help="override niters_per_epoch (short epochs for "
                             "smoke runs; also rescales the LR schedule "
                             "horizon, which is epochs x niters)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--pretrained", default=None,
                        help=".pth single-tower backbone checkpoint")
    parser.add_argument("-d", "--devices", default="",
                        help="device indices, e.g. '1' or '0,1,2,3' / '0-3' "
                             "(one process per device; with --device cpu, "
                             "'0,1' = two CPU ranks)")
    parser.add_argument("--mesh", default="dp",
                        help="dp (the largest count of the -d devices that "
                             "divides the batch) | dp:N (exactly N) | 2d:D,S "
                             "(D x S of them: D data ranks, each image's "
                             "rows over S) | tp:D,M (D x M of them: D data "
                             "ranks, the MLP hidden widths over M)")
    parser.add_argument("-c", "--continue", dest="resume", action="store_true")
    parser.add_argument("-p", "--profile_dir", default=None,
                        help="write a torch.profiler trace of the last "
                             "epoch here")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def build_config(args):
    """The preset with the command line's overrides."""
    import dataclasses

    from rgbx_semantic_segmentation_tpu_torch import config as config_lib

    try:
        cfg = config_lib.get_config(args.config)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    ds_kw = {k: v for k, v in (("train_source", args.train_source),
                               ("eval_source", args.eval_source)) if v}
    if ds_kw:
        cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, **ds_kw))
    model_kw = {k: v for k, v in (("backbone", args.backbone),
                                  ("decoder", args.decoder),
                                  ("pretrained_model", args.pretrained)) if v}
    if model_kw:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    train_kw = {k: v for k, v in (("nepochs", args.epochs),
                                  ("niters_per_epoch", args.niters),
                                  ("batch_size", args.batch_size),
                                  ("lr", args.lr)) if v}
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    return cfg


def main(argv=None):
    """Train; returns one record per epoch run: {"epoch", "loss", "lr",
    "seconds", "img_per_s"}, and on the last the profile summary when
    `-p` was given (rank 0's records in a data-parallel run)."""
    from rgbx_semantic_segmentation_tpu_torch.parallel import launch

    args = parse_args(argv)
    cfg = build_config(args)
    devices = launch.cli_devices(args.device, args.devices, args.mesh,
                                 cfg.train.batch_size)
    return launch.run(train, args.device, devices, (args, cfg),
                      mesh=args.mesh)


def train(world, args, cfg):
    """The training run of one rank of `world` (parallel/dist.World; one
    process is World.solo); returns main()'s records."""
    import os

    from rgbx_semantic_segmentation_tpu_torch import convert, optim
    from rgbx_semantic_segmentation_tpu_torch.data.loader import TrainLoader
    from rgbx_semantic_segmentation_tpu_torch.engine import Engine
    from rgbx_semantic_segmentation_tpu_torch.logger import get_logger
    from rgbx_semantic_segmentation_tpu_torch.metrics_writer import (
        MetricsWriter)
    from rgbx_semantic_segmentation_tpu_torch.train import Trainer

    logger = get_logger()
    records = []
    with Engine(cfg, args, world) as engine:
        # Resume without a pretrained load restores every tensor from the
        # checkpoint: skip the init (the weights are left unset).
        trainer = Trainer(
            cfg, device=engine.device, world=world,
            init_values=not (args.resume and not cfg.model.pretrained_model))
        if cfg.model.pretrained_model:
            convert.load_dualpath_pretrained(
                cfg.model.pretrained_model, trainer.model,
                family=convert.family_for_backbone(cfg.model.backbone),
                logger=logger)

        start_epoch = 1
        if args.resume:
            start_epoch = engine.restore_checkpoint(trainer)
        # The spatial (model) ranks of a data rank load its images alike
        # (each decodes them all); a spatial rank's step keeps its rows.
        loader = TrainLoader(cfg, root=args.dataset_root,
                             rank=world.data_rank, world=world.data_size)
        # Scalar logging (lr + epoch loss, matching reference train.py:226-229,
        # 306-307): JSONL always, TensorBoard mirror when available; rank 0.
        writer = (MetricsWriter(os.path.join(cfg.log_dir, cfg.tag()))
                  if world.is_main() else None)
        engine.install_preemption_handler()
        logger.info("training %s: %d epochs x %d iters, batch %d on %s",
                    cfg.tag(), cfg.train.nepochs, loader.niters,
                    cfg.train.batch_size, engine.device)
        try:
            for epoch in range(start_epoch, cfg.train.nepochs + 1):
                last = epoch == cfg.train.nepochs
                t0 = time.time()
                trainer.epoch = epoch
                # closing: a stop mid-epoch (preemption) stops the workers
                with contextlib.closing(loader.epoch(epoch)) as batches, \
                        (engine.profile("train") if last
                         else contextlib.nullcontext()):
                    avg_loss = trainer.fit_epoch(
                        batches, loader.niters, logger=logger,
                        should_stop=lambda: engine.preempted)
                seconds = time.time() - t0
                engine.drain_preemption(epoch, trainer)
                # The lr of the last update, read from the optimizer itself
                # (LBFGS: None, its constant lr scales the line search's
                # step; the writer gets cfg.train.lr, as the JAX CLI's).
                lr_now = optim.applied_lr(trainer.optimizer)
                if writer is not None:
                    writer.scalar("train/epoch_loss", avg_loss, epoch)
                    writer.scalar("train/learning_rate",
                                  cfg.train.lr if lr_now is None else lr_now,
                                  trainer.global_step)
                img_per_s = loader.niters * cfg.train.batch_size / seconds
                logger.info("epoch %d/%d loss %.4f (%.1fs, %.2f img/s)",
                            epoch, cfg.train.nepochs, avg_loss, seconds,
                            img_per_s)
                records.append({"epoch": epoch, "loss": avg_loss,
                                "lr": lr_now, "seconds": seconds,
                                "img_per_s": img_per_s})
                engine.save_checkpoint_if_due(epoch, trainer)
        finally:
            if writer is not None:
                writer.close()
        if records and engine.last_profile is not None:
            records[-1]["profile"] = engine.last_profile
    return records


if __name__ == "__main__":
    main()
