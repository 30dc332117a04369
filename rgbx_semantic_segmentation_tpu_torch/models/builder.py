"""Config-driven model assembly (counterpart of
rgbx_semantic_segmentation_tpu/models/builder.py).

This slice builds the MiT family (mit_tiny, mit_b0..b5) with FRM/FFM fusion
and the MLPDecoder head. Every other backbone or decoder name the JAX
registry knows raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.config import Config, torch_dtype
from rgbx_semantic_segmentation_tpu_torch.device import resolve_device
from rgbx_semantic_segmentation_tpu_torch.models.decoders.mlp_decoder import (
    MLPDecoder)
from rgbx_semantic_segmentation_tpu_torch.models.encoders import dual_segformer
from rgbx_semantic_segmentation_tpu_torch.ops.layers import init_weights
from rgbx_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear

MIT_FACTORIES = {
    "mit_tiny": dual_segformer.mit_tiny,
    "mit_b0": dual_segformer.mit_b0, "mit_b1": dual_segformer.mit_b1,
    "mit_b2": dual_segformer.mit_b2, "mit_b3": dual_segformer.mit_b3,
    "mit_b4": dual_segformer.mit_b4, "mit_b5": dual_segformer.mit_b5,
}
# Names of the JAX registry (models/builder.py BACKBONES / build_decoder)
# that this port does not build yet, with the ROADMAP item that ports them.
_LATER_BACKBONES = {
    "_w_aspp": "M10 item 1 (ASPP variants)",
    "_w_ef_aspp": "M10 item 1 (ASPP variants)",
    "pp": "M10 item 4 (IFRM/IFFM, needs K5)",
    "swin": "M10 item 5 (dual Swin, needs K3/K4)",
    "segnext": "M10 item 6 (SegNeXt)",
    "resnet": "M10 item 7 (ResNet)",
}
_LATER_DECODERS = {
    "UPernet": "M10 item 1", "deeplabv3+": "M10 item 2",
    "MLPDecoderpp": "M10 item 2", "mask2former": "M10 item 3",
    None: "M10 item 1 (FCNHead)", "None": "M10 item 1 (FCNHead)",
    "fcn": "M10 item 1 (FCNHead)",
}


def build_backbone(cfg: Config) -> Tuple[nn.Module, Sequence[int]]:
    name = cfg.model.backbone
    if cfg.model.remat:
        raise NotImplementedError(
            "ModelConfig.remat (activation checkpointing) is not ported "
            "yet: ROADMAP M5 rest")
    if name not in MIT_FACTORIES:
        for key, item in _LATER_BACKBONES.items():
            if key in name:
                raise NotImplementedError(
                    f"backbone {name!r} is not ported yet: ROADMAP {item}")
        raise KeyError(f"unknown backbone {name!r}; have {sorted(MIT_FACTORIES)}")
    module = MIT_FACTORIES[name](
        frm=cfg.model.feature_rectify_module,
        ffm=cfg.model.feature_fusion_module,
        drop_path_rate=cfg.model.drop_path_rate,
        use_pallas=cfg.model.use_pallas_kernels,
        gelu_approximate=cfg.model.gelu_approximate,
        dtype=torch_dtype(cfg.model))
    return module, dual_segformer.CHANNELS[name]


def build_decoder(cfg: Config, channels: Sequence[int]) -> nn.Module:
    name = cfg.model.decoder
    if name == "MLPDecoder":
        drop_kw = ({} if cfg.model.decoder_dropout_ratio is None
                   else {"dropout_ratio": cfg.model.decoder_dropout_ratio})
        return MLPDecoder(channels, cfg.dataset.num_classes,
                          embed_dim=cfg.model.decoder_embed_dim,
                          bn_momentum=cfg.model.bn_momentum,
                          bn_eps=cfg.model.bn_eps, **drop_kw)
    if name in _LATER_DECODERS:
        raise NotImplementedError(f"decoder {name!r} is not ported yet: "
                                  f"ROADMAP {_LATER_DECODERS[name]}")
    raise KeyError(f"unknown decoder {name!r}")


class EncoderDecoder(nn.Module):
    """Dual-branch encoder + decode head. forward(rgb, modal_x) takes NHWC
    inputs and returns NHWC logits upsampled to the input resolution, like
    the JAX EncoderDecoder.__call__.

    With cfg.model.use_mixed_precision the forward runs under bf16 autocast
    (fp32 params, bf16 compute: the JAX dtype policy)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.model)
        self.backbone, channels = build_backbone(cfg)
        self.decode_head = build_decoder(cfg, channels)

    def forward(self, rgb: torch.Tensor, modal_x: torch.Tensor) -> torch.Tensor:
        size = rgb.shape[1:3]
        x = rgb.permute(0, 3, 1, 2)
        e = modal_x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            out = self.decode_head(self.backbone(x, e))
            logits = resize_bilinear(out, size)
        return logits.permute(0, 2, 3, 1)


def build_model(cfg: Config, device=None, seed: Optional[int] = 0
                ) -> EncoderDecoder:
    """The model on `device` (None: the card; see device.resolve_device) in
    eval mode. With a seed, weights are
    initialised from torch.Generator(seed) (see ops/layers.init_weights);
    with seed=None they are left unset, for a state dict to be loaded."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = EncoderDecoder(cfg)
    model.to_empty(device="cpu")
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
