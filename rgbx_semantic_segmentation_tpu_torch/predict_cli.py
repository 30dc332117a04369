"""Inference entry point of the port: segment unlabeled RGB-X image pairs
(counterpart of the root predict_cli.py).

The eval path needs a label for every image; this CLI runs the same
inference (the same BGR/normalisation pipeline and the preset's protocol:
sliding window, scales, flip; batched forwards of BATCH images where every
scale fits one crop, eval_cli's default) without labels, and writes raw
class-index PNGs plus palettised PNGs (and optional [image | prediction]
composites).

Inputs: either `--dataset_root` + `--source names.txt` (names resolved
through the config's rgb/x folder layout, like training), or a single
`--rgb img.png --x modal.png` pair.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.predict_cli --config mfnet \\
        --dataset_root /data/MFNet --source predict.txt -e last -p out/
    python -m rgbx_semantic_segmentation_tpu_torch.predict_cli --config mfnet \\
        --rgb 1.png --x 1_th.png -e last
"""
from __future__ import annotations

import argparse
import os
import time

BATCH = 8   # images a forward: eval_cli's default, so both write the same maps


def main(argv=None):
    """Predict; returns the names written."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="mfnet")
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--source", default=None,
                        help="file of image names (no extensions), resolved "
                             "through the config's rgb/x folders; default: "
                             "the config's eval_source")
    parser.add_argument("--rgb", default=None,
                        help="single RGB image path (with --x; bypasses "
                             "--dataset_root/--source)")
    parser.add_argument("--x", default=None,
                        help="single modal image path (thermal/HHA/...)")
    parser.add_argument("--backbone", default=None)
    parser.add_argument("--decoder", default=None)
    parser.add_argument("-e", "--epochs", default="last",
                        help="'last' | '300' | a checkpoint directory | a "
                             "whole-model .pth/.pt of the original repo")
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--save_path", "-p", default=None,
                        help="output dir (default logs/<tag>/predict); raw "
                             "class PNGs here, palettised in <dir>_color")
    parser.add_argument("-s", "--composite", action="store_true",
                        help="also save [image | prediction] composites in "
                             "<save_path>_compare")
    parser.add_argument("-d", "--devices", default="",
                        help="the CUDA device index (one device; more is "
                             "ROADMAP M9)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if (args.rgb is None) != (args.x is None):
        parser.error("--rgb and --x must be given together")

    import dataclasses

    import numpy as np

    from rgbx_semantic_segmentation_tpu_torch import config as config_lib
    from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
        resolve_weights)
    from rgbx_semantic_segmentation_tpu_torch.data.dataset import (
        RGBXDataset, _imread, load_modal_image, load_rgbx_pair)
    from rgbx_semantic_segmentation_tpu_torch.engine import select_device
    from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
    from rgbx_semantic_segmentation_tpu_torch.logger import get_logger
    from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model

    try:
        cfg = config_lib.get_config(args.config)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    model_kw = {k: v for k, v in (("backbone", args.backbone),
                                  ("decoder", args.decoder)) if v}
    if model_kw:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    logger = get_logger()
    device = select_device(args.device, args.devices)

    cfg, targets = resolve_weights(cfg, args.epochs, args.checkpoint_dir,
                                   logger)
    if len(targets) > 1:
        raise SystemExit(
            f"predict_cli takes ONE checkpoint; -e {args.epochs!r} matches "
            f"{[label for label, _ in targets]} — use eval_cli for sweeps")
    ckpt_label, load = targets[0]
    model = build_model(cfg, device=device, seed=None)
    load(model)

    # Work list: names, and the raw BGR uint8 pairs decoded lazily, a batch
    # at a time: thousands of images must not be resident at once.
    if args.rgb is not None:
        names = [os.path.splitext(os.path.basename(args.rgb))[0]]

        def load(name):
            return _imread(args.rgb), load_modal_image(cfg.dataset, args.x)
    else:
        root = args.dataset_root or cfg.dataset.dataset_path
        source = args.source or cfg.dataset.eval_source
        source = source if os.path.isabs(source) else os.path.join(root, source)
        with open(source) as f:
            names = [line.strip() for line in f if line.strip()]

        def load(name):
            return load_rgbx_pair(cfg.dataset, root, name)

    save_path = args.save_path or os.path.join(cfg.log_dir, cfg.tag(),
                                               "predict")
    evaluator = SegEvaluator(cfg, model, device=device)
    colors = RGBXDataset.get_class_colors(cfg.dataset.dataset_name)
    logger.info("predicting %d image(s) with %s -> %s", len(names),
                ckpt_label, save_path)
    t0 = time.time()
    for i in range(0, len(names), BATCH):
        group = []
        for name in names[i:i + BATCH]:
            rgb, x = load(name)
            group.append({"fn": name, "rgb": rgb, "modal_x": x})
        # Batched forwards for a run of same-size images that fit the crop
        # at every scale; anything else image by image (the sliding grid).
        if (len(group) > 1
                and all(evaluator._one_shot_all_scales(it) for it in group)
                and len({it["rgb"].shape for it in group}) == 1):
            preds = evaluator._batched_whole_image(group).cpu().numpy()
        else:
            preds = [evaluator.sliding_eval_rgbx(it["rgb"], it["modal_x"])
                     .cpu().numpy() for it in group]
        for item, pred in zip(group, preds):
            evaluator._save_prediction(pred, item["fn"], save_path)
            if args.composite:
                from PIL import Image

                from rgbx_semantic_segmentation_tpu_torch import visualize

                # Paint class colors into the RGB-order photo: get_class_colors
                # triples are RGB while the pipeline's images are BGR.
                rgb_view = item["rgb"][:, :, ::-1]
                painted = visualize.show_prediction(
                    colors, cfg.dataset.background, rgb_view, pred, pred)
                comp = np.concatenate([rgb_view, painted], axis=1)
                out_dir = save_path + "_compare"
                os.makedirs(out_dir, exist_ok=True)
                Image.fromarray(comp.astype(np.uint8)).save(
                    os.path.join(out_dir, item["fn"] + ".png"))
        done = min(i + BATCH, len(names))
        logger.info("predict %d/%d (%.2f img/s)", done, len(names),
                    done / max(time.time() - t0, 1e-9))
    return names


if __name__ == "__main__":
    main()
