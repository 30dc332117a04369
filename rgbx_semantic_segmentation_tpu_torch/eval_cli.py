"""Evaluation entry point of the port (counterpart of the root eval_cli.py):
the preset's protocol (sliding window, scales, flip; SegEvaluator).

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.eval_cli --config mfnet \\
        --dataset_root /path/to/MFNet -e last [-p OUT] [-s] [--device cuda]

-e takes an epoch spec ('last' | '300' | '250-400' | '250-') over the
checkpoints of <log_dir>/<tag>/checkpoint (or --checkpoint_dir), a
checkpoint directory (its latest epoch), or a .pth/.pt whole-model
checkpoint of the original repo (erf GELU is then forced, as the original
trains with it; port checkpoints are named by epoch or directory).
--weights is a port state dict saved with torch.save(model.state_dict()).
With neither, the model is initialised from seed 0 (random weights: only the
path is exercised, the mIoU means nothing). --compat-stride-swap and
--compat-double-normalize replicate the original repo's sliding grid and
the original fork's double normalisation.
"""
from __future__ import annotations

import argparse
import os

def main(argv=None):
    """Evaluate; prints each result table and returns {checkpoint label:
    (scores, confusion matrix)}."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="mfnet")
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--train_source", default=None,
                        help="override split file, e.g. train.txt")
    parser.add_argument("--eval_source", default=None,
                        help="override eval split file, e.g. test.txt")
    parser.add_argument("--backbone", default=None)
    parser.add_argument("--decoder", default=None)
    parser.add_argument("-e", "--epochs", default=None,
                        help="'last' | '300' | '250-400' | '250-' | a "
                             "checkpoint directory | a .pth/.pt file")
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--weights", default=None,
                        help="port .pt state dict (instead of -e)")
    parser.add_argument("--save_path", "-p", default=None,
                        help="dump raw + palettised prediction PNGs here")
    parser.add_argument("-s", "--show_image", action="store_true",
                        help="save [img|pred|gt] composites in "
                             "<save_path>_compare")
    parser.add_argument("--eval_batch", type=int, default=8,
                        help="images per batched forward (1 = per image)")
    parser.add_argument("--val_log", default=None,
                        help="append the tables here (default with -e: "
                             "<log_dir>/<tag>/val_last.log)")
    parser.add_argument("-d", "--devices", default="",
                        help="the CUDA device index (one device; more is "
                             "ROADMAP M9)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="log the running metric after every image")
    parser.add_argument("--compat-stride-swap", action="store_true",
                        help="the original repo's swapped h/w stride and "
                             "crop-extent indices in the sliding grid (to "
                             "score its checkpoints under the published "
                             "protocol; a no-op for square crops)")
    parser.add_argument("--compat-double-normalize", action="store_true",
                        help="normalise twice, as the original fork's eval "
                             "did")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.epochs and args.weights:
        parser.error("-e and --weights are exclusive")

    import dataclasses

    import torch

    from rgbx_semantic_segmentation_tpu_torch import config as config_lib
    from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
        resolve_weights)
    from rgbx_semantic_segmentation_tpu_torch.data.loader import ValLoader
    from rgbx_semantic_segmentation_tpu_torch.engine import select_device
    from rgbx_semantic_segmentation_tpu_torch.evaluator import (
        evaluate_weights)
    from rgbx_semantic_segmentation_tpu_torch.logger import get_logger

    try:
        cfg = config_lib.get_config(args.config)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    ds_kw = {k: v for k, v in (("train_source", args.train_source),
                               ("eval_source", args.eval_source)) if v}
    if ds_kw:
        cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, **ds_kw))
    model_kw = {k: v for k, v in (("backbone", args.backbone),
                                  ("decoder", args.decoder)) if v}
    if model_kw:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    logger = get_logger()
    device = select_device(args.device, args.devices)

    # What to evaluate: [(label, load(model))].
    if args.epochs:
        cfg, targets = resolve_weights(cfg, args.epochs, args.checkpoint_dir,
                                       logger)
    elif args.weights:
        targets = [(os.path.basename(args.weights),
                    lambda m: m.load_state_dict(torch.load(
                        args.weights, map_location=device, weights_only=True),
                        strict=True))]
    else:
        targets = [("seed 0 init", None)]

    show_dir = None
    if args.show_image:
        show_dir = (args.save_path or os.path.join(
            cfg.log_dir, cfg.tag(), "preds")) + "_compare"
    val_log = args.val_log
    if val_log is None and args.epochs:
        val_log = os.path.join(cfg.log_dir, cfg.tag(), "val_last.log")
    return evaluate_weights(
        cfg, ValLoader(cfg, root=args.dataset_root).dataset, targets,
        val_log=val_log, logger=logger, device=device,
        compat_double_normalize=args.compat_double_normalize,
        compat_stride_swap=args.compat_stride_swap,
        eval_batch=args.eval_batch, save_path=args.save_path,
        show_image_dir=show_dir, verbose=args.verbose)


if __name__ == "__main__":
    main()
