"""Config-driven model assembly (counterpart of
rgbx_semantic_segmentation_tpu/models/builder.py).

Built so far: the MiT family (mit_tiny, mit_b0..b5, with the config's
FRM/FFM or IFRM/IFFM fusion; the `mit_*pp` names that hardwire IFRM/IFFM;
the `mit_*_w_aspp` and `mit_*_w_ef_aspp` names with a per-stage ASPP or one
eASPP) and the dual Swin family (swin_s, swin_b) with FRM/FFM; the heads
MLPDecoder, UPernet and deeplabv3+ (both with the aux FCNHead on feature 2:
the model then returns (logits, aux), as the JAX EncoderDecoder does in
train and eval mode) and fcn / None (an FCNHead on feature 3). The Swin
knobs `swin_ape` and `swin_frozen_stages` and the shared `remat` pass
through to the encoders. The dual ResNet family (resnet50/101/152, the
config's FRM/FFM) and the dual SegNeXt family (segnext_tiny/small/base/large
and the original's spellings segnext_s / segnext_b, IFRM/IFFM hardwired,
drop path 0: the JAX builder passes SegNeXt no rate) complete the JAX
registry.

One routing deviation from the JAX builder: the ResNet and SegNeXt IFFMs
take `use_pallas = cfg.model.use_pallas_kernels`, as the MiT ones do, where
the JAX modules pass none and their cross-attention always runs the plain
`_sdpa`. In fp32 the two routes agree to summation order; in bf16 they
differ by where p is rounded (ops/attention.py), the deviation that stands
for long-kv shapes with the kernels off.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.config import Config, torch_dtype
from rgbx_semantic_segmentation_tpu_torch.device import resolve_device
from rgbx_semantic_segmentation_tpu_torch.models.decoders.deeplabv3plus import (
    DeepLabV3Plus)
from rgbx_semantic_segmentation_tpu_torch.models.decoders.fcnhead import FCNHead
from rgbx_semantic_segmentation_tpu_torch.models.decoders.mask2former import (
    Mask2Former, semantic_inference)
from rgbx_semantic_segmentation_tpu_torch.models.decoders.mlp_decoder import (
    MLPDecoder)
from rgbx_semantic_segmentation_tpu_torch.models.decoders.mlp_decoderpp import (
    MLPDecoderpp)
from rgbx_semantic_segmentation_tpu_torch.models.decoders.upernet import UPerHead
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_resnet, dual_segformer, dual_segnext, dual_swin)
from rgbx_semantic_segmentation_tpu_torch.ops.layers import init_weights
from rgbx_semantic_segmentation_tpu_torch.ops.resize import (
    resize_bilinear, resize_bilinear_rows)
from rgbx_semantic_segmentation_tpu_torch.parallel import spatial, tensor

MIT_FACTORIES = {
    "mit_tiny": dual_segformer.mit_tiny,
    "mit_b0": dual_segformer.mit_b0, "mit_b1": dual_segformer.mit_b1,
    "mit_b2": dual_segformer.mit_b2, "mit_b3": dual_segformer.mit_b3,
    "mit_b4": dual_segformer.mit_b4, "mit_b5": dual_segformer.mit_b5,
}
SWIN_FACTORIES = {"swin_s": dual_swin.swin_s, "swin_b": dual_swin.swin_b}
# The encoder-side ASPP variants: name suffix -> RGBXTransformer `aspp`.
ASPP_SUFFIXES = {"_w_aspp": "aspp", "_w_ef_aspp": "easpp"}
RESNET_FACTORIES = {"resnet50": dual_resnet.dual_resnet50,
                    "resnet101": dual_resnet.dual_resnet101,
                    "resnet152": dual_resnet.dual_resnet152}
SEGNEXT_FACTORIES = {
    "segnext_tiny": dual_segnext.segnext_tiny,
    "segnext_small": dual_segnext.segnext_small,
    "segnext_base": dual_segnext.segnext_base,
    "segnext_large": dual_segnext.segnext_large,
}
# The original's spellings (its builder imports names its encoder module
# lacks), aliased as the JAX registry does.
SEGNEXT_ALIASES = {"segnext_s": "segnext_small", "segnext_b": "segnext_base"}
# Decoders that carry the aux FCNHead on feature AUX_INDEX; its loss
# weighs AUX_RATE (the JAX builder's constants).
AUX_DECODERS = {"UPernet", "deeplabv3+"}
AUX_INDEX = 2
AUX_RATE = 0.4


def is_mit_pp(name: str) -> bool:
    """True for the `mit_*pp` names (a MiT factory's name + "pp"), which
    hardwire IFRM/IFFM; false for every other name that ends in "pp", such
    as the ASPP variants `mit_b2_w_aspp` and `mit_b2_w_ef_aspp`."""
    base = name[:-2]
    return base in MIT_FACTORIES and name == base + "pp"


def build_backbone(cfg: Config) -> Tuple[nn.Module, Sequence[int]]:
    name = cfg.model.backbone
    if name in SWIN_FACTORIES:
        return _build_swin(cfg), dual_swin.CHANNELS[name]
    if name in RESNET_FACTORIES:
        module = RESNET_FACTORIES[name](
            frm=cfg.model.feature_rectify_module,
            ffm=cfg.model.feature_fusion_module,
            use_pallas=cfg.model.use_pallas_kernels)
        return module, module.channels
    segnext = SEGNEXT_ALIASES.get(name, name)
    if segnext in SEGNEXT_FACTORIES:
        module = SEGNEXT_FACTORIES[segnext](
            use_pallas=cfg.model.use_pallas_kernels)
        return module, module.channels
    # mit_*pp: the same towers with IFRM/IFFM whatever the config names.
    pp = is_mit_pp(name)
    fusion = ({"frm": "IFRM", "ffm": "IFFM"} if pp else
              {"frm": cfg.model.feature_rectify_module,
               "ffm": cfg.model.feature_fusion_module})
    base, aspp = (name[:-2] if pp else name), None
    for suffix, kind in ASPP_SUFFIXES.items():
        if name.endswith(suffix) and name[:-len(suffix)] in MIT_FACTORIES:
            base, aspp = name[:-len(suffix)], kind
    if base not in MIT_FACTORIES:
        raise KeyError(f"unknown backbone {name!r}; have "
                       f"{sorted(MIT_FACTORIES) + sorted(SWIN_FACTORIES)}"
                       f" + {sorted(RESNET_FACTORIES)}"
                       f" + {sorted(SEGNEXT_FACTORIES)}"
                       f" + {sorted(SEGNEXT_ALIASES)}")
    module = MIT_FACTORIES[base](
        **fusion, aspp=aspp,
        drop_path_rate=cfg.model.drop_path_rate,
        use_pallas=cfg.model.use_pallas_kernels,
        gelu_approximate=cfg.model.gelu_approximate,
        dtype=torch_dtype(cfg.model), remat=cfg.model.remat)
    return module, dual_segformer.CHANNELS[base]


def _build_swin(cfg: Config) -> nn.Module:
    return SWIN_FACTORIES[cfg.model.backbone](
        frm=cfg.model.feature_rectify_module,
        ffm=cfg.model.feature_fusion_module,
        drop_path_rate=cfg.model.drop_path_rate,
        ape=cfg.model.swin_ape,
        frozen_stages=cfg.model.swin_frozen_stages,
        remat=cfg.model.remat,
        use_pallas=cfg.model.use_pallas_kernels,
        dtype=torch_dtype(cfg.model))


def build_decoder(cfg: Config, channels: Sequence[int]) -> nn.Module:
    name = cfg.model.decoder
    num_classes = cfg.dataset.num_classes
    bn = {"bn_momentum": cfg.model.bn_momentum, "bn_eps": cfg.model.bn_eps}
    drop_kw = ({} if cfg.model.decoder_dropout_ratio is None
               else {"dropout_ratio": cfg.model.decoder_dropout_ratio})
    if name == "MLPDecoder":
        return MLPDecoder(channels, num_classes,
                          embed_dim=cfg.model.decoder_embed_dim, **bn,
                          **drop_kw)
    if name == "MLPDecoderpp":
        return MLPDecoderpp(channels, num_classes,
                            embed_dim=cfg.model.decoder_embed_dim, **bn,
                            **drop_kw)
    if name == "mask2former":
        # The JAX builder passes neither the config's BatchNorm settings nor
        # its decoder dropout to this head.
        return Mask2Former(channels, num_classes)
    if name == "UPernet":
        return UPerHead(channels, num_classes, channels=512, **bn)
    if name == "deeplabv3+":
        return DeepLabV3Plus(channels, num_classes, **bn)
    if name in (None, "None", "fcn"):
        return FCNHead(channels[3], num_classes, in_index=3, **bn)
    raise KeyError(f"unknown decoder {name!r}")


class EncoderDecoder(nn.Module):
    """Dual-branch encoder + decode head. forward(rgb, modal_x) takes NHWC
    inputs and returns NHWC logits upsampled to the input resolution, like
    the JAX EncoderDecoder.__call__; (logits, aux logits) when the decoder
    carries the aux FCNHead (AUX_DECODERS), in train and eval mode alike.
    mask2former: in train mode (`self.training`) the dict {"pred_logits",
    "pred_masks"} with the masks (NCHW, fp32 logits) resized to the input
    resolution, for losses.mask2former_loss; in eval mode the fp32
    log-scores of its `semantic_inference`, resized.

    With cfg.model.use_mixed_precision the forward runs under bf16 autocast
    (fp32 params, bf16 compute: the JAX dtype policy)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.model)
        self.backbone, channels = build_backbone(cfg)
        self.decode_head = build_decoder(cfg, channels)
        self.aux_head = None
        if cfg.model.decoder in AUX_DECODERS:
            self.aux_head = FCNHead(
                channels[AUX_INDEX], cfg.dataset.num_classes,
                in_index=AUX_INDEX, channels=256,
                bn_momentum=cfg.model.bn_momentum, bn_eps=cfg.model.bn_eps)
        # A stage that no head reads leaves its fusion module out of the
        # loss, without a gradient, as does a Swin downsample that feeds a
        # frozen stage alone (data parallelism must then look for such
        # parameters: Trainer).
        read = set(self.decode_head.in_stages)
        if self.aux_head is not None:
            read |= set(self.aux_head.in_stages)
        self.every_param_in_loss = (
            read == set(range(len(channels)))
            and getattr(self.backbone, "every_param_in_loss", True))
        self.spatial: Optional[spatial.SpatialGroup] = None
        # The data x model mesh (set_tensor_parallel): the model group and
        # {parameter name: dim} of the split parameters.
        self.model_group: Optional[tensor.ModelGroup] = None
        self.tp_dims: Dict[str, int] = {}

    def set_tensor_parallel(self, mg: tensor.ModelGroup) -> None:
        """Run on one rank of the model axis of `--mesh tp:D,M`: each
        Mix-FFN (MiT, mit_*pp) and Swin MLP keeps its slice of the hidden
        width (parallel/tensor.py); every other parameter stays whole, and
        families with no such layer (SegNeXt, ResNet) run as M replicas, as
        under JAX's _tp_spec. Call it once, on the whole model, before an
        optimizer takes the parameters. Raises if a parameter that the
        rules split (tensor.split_dim) lies outside the split layers."""
        if self.model_group is not None:
            raise RuntimeError("the model is split already")
        want = {n for n, p in self.named_parameters()
                if tensor.split_dim(n, p.shape, mg.size) is not None}
        dims = {}
        for name, m in self.named_modules():
            if isinstance(m, (dual_segformer.Mlp, dual_swin.SwinMlp)):
                dims.update({f"{name}.{k}": d for k, d in
                             m.set_tensor_parallel(mg).items()})
        if set(dims) != want:
            raise RuntimeError(f"tensor parallel split rules name "
                               f"{sorted(want - set(dims))[:4]} outside the "
                               "split layers")
        self.model_group, self.tp_dims = mg, dims

    def set_spatial(self, sp: Optional[spatial.SpatialGroup]) -> None:
        """Run on one rank of the spatial axis of `--mesh 2d:D,S` (None:
        whole images): forward then takes the rank's row block of the
        images and returns the logits of those rows
        (parallel/spatial.py). Ported for the MiT towers (FRM/FFM and the
        mit_*pp IFRM/IFFM, `remat` on or off), the dual Swin towers with
        FRM/FFM and the MLPDecoder under the cross-entropy loss
        (spatial_support); the rest raises NotImplementedError naming its
        ROADMAP item."""
        if sp is not None:
            spatial_support(self.cfg)
        self.spatial = sp

    def forward(self, rgb: torch.Tensor, modal_x: torch.Tensor
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                           Dict[str, torch.Tensor]]:
        size = rgb.shape[1:3]
        x = rgb.permute(0, 3, 1, 2)
        e = modal_x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            if self.spatial is not None:
                return self._forward_rows(x, e)
            feats = self.backbone(x, e)
            out = self.decode_head(feats)
            if isinstance(out, dict):
                if self.training:
                    return {"pred_logits": out["pred_logits"],
                            "pred_masks": resize_bilinear(out["pred_masks"],
                                                          size)}
                sem = semantic_inference(out["pred_logits"],
                                         out["pred_masks"])
                return resize_bilinear(sem.permute(0, 3, 1, 2),
                                       size).permute(0, 2, 3, 1)
            logits = resize_bilinear(out, size)
            if self.aux_head is None:
                return logits.permute(0, 2, 3, 1)
            aux = resize_bilinear(self.aux_head(feats), size)
        return logits.permute(0, 2, 3, 1), aux.permute(0, 2, 3, 1)

    def _forward_rows(self, x, e) -> torch.Tensor:
        """forward on one rank of the spatial axis (under the autocast of
        forward): x, e the rank's row block of the NCHW images; the NHWC
        logits of those rows, each upsampled from the whole 1/4 map with
        the whole resize's taps."""
        sp = self.spatial
        sharded = self.backbone.spatial_layout(x.shape[2] * sp.size,
                                               x.shape[3], sp)
        out = self.decode_head(self.backbone(x, e, sp), sp, sharded)
        if sharded[0]:
            out = spatial.gather_rows(out, sp, 2)
        size = (x.shape[2] * sp.size, x.shape[3])
        logits = resize_bilinear_rows(out, size, spatial.row_range(size[0],
                                                                   sp))
        return logits.permute(0, 2, 3, 1)


def spatial_support(cfg: Config) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a config
    that `--mesh 2d` does not run: it runs the MiT towers (mit_tiny,
    mit_b0..b5 with FRM/FFM or IFRM/IFFM, mit_b0pp..b5pp; `remat` on or
    off), the dual Swin towers (swin_s, swin_b) with FRM/FFM (`remat`,
    `swin_ape` and `swin_frozen_stages` on or off), the MLPDecoder and the
    cross-entropy loss."""
    m = cfg.model
    swin = m.backbone in SWIN_FACTORIES
    if m.backbone not in MIT_FACTORIES and not is_mit_pp(m.backbone) \
            and not swin:
        raise NotImplementedError(f"--mesh 2d with backbone {m.backbone!r} "
                                  "(ROADMAP Queue 1 item 5d)")
    if swin and (m.feature_rectify_module, m.feature_fusion_module) != (
            "FRM", "FFM"):
        raise NotImplementedError(
            f"--mesh 2d with backbone {m.backbone!r} and "
            f"{m.feature_rectify_module}/{m.feature_fusion_module} "
            "(ROADMAP Queue 1 item 5d)")
    if m.decoder != "MLPDecoder":
        raise NotImplementedError(f"--mesh 2d with decoder {m.decoder!r} "
                                  "(ROADMAP Queue 1 item 5d)")
    if cfg.train.criterion != "CrossEntropyLoss":
        raise NotImplementedError(f"--mesh 2d with criterion "
                                  f"{cfg.train.criterion!r} (ROADMAP Queue 1 "
                                  "item 5d)")


def main_logits(out) -> torch.Tensor:
    """The logits of a model output: the first of an (logits, aux) pair."""
    return out[0] if isinstance(out, tuple) else out


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
