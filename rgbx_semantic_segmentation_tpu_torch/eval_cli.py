"""Evaluation entry point of the port (counterpart of the root eval_cli.py,
whole-image protocol only).

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.eval_cli --config mfnet \
        --dataset_root /path/to/MFNet [--weights model.pt] [--device cuda]

--weights is a port state dict saved with torch.save(model.state_dict());
without it the model is initialised from seed 0 (random weights: only the
path is exercised, the mIoU means nothing).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="mfnet")
    parser.add_argument("--dataset_root", required=True)
    parser.add_argument("--weights", default=None,
                        help="port .pt state dict; seeded init when absent")
    parser.add_argument("--eval_batch", type=int, default=8,
                        help="images per batched forward (1 = per image)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from rgbx_semantic_segmentation_tpu.data.dataset import RGBXDataset
    from rgbx_semantic_segmentation_tpu.logger import get_logger
    from rgbx_semantic_segmentation_tpu_torch.config import get_config
    from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
    from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model

    try:
        cfg = get_config(args.config)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    logger = get_logger()
    model = build_model(cfg, device=args.device,
                        seed=None if args.weights else 0)
    if args.weights:
        sd = torch.load(args.weights, map_location=args.device,
                        weights_only=True)
        model.load_state_dict(sd, strict=True)
    dataset = RGBXDataset(cfg.dataset, "val", root=args.dataset_root)
    evaluator = SegEvaluator(cfg, model, device=args.device)
    _, line = evaluator.evaluate(dataset, logger=logger,
                                 eval_batch=args.eval_batch)
    print(line)


if __name__ == "__main__":
    main()
