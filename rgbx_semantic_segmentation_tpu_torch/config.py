"""Typed configuration system (the port's own copy of
rgbx_semantic_segmentation_tpu/config.py: same dataclasses, fields, defaults
and presets; tests/test_torch_config.py holds the two equal). The one
difference: `ModelConfig.compute_dtype`, which returns a jax dtype there, is
the function `torch_dtype` here.

Replaces the reference's process-global EasyDict singleton (`config.py:9-114` in the
reference) with explicit, immutable dataclasses passed down the stack. Knob names and
semantics match the reference 1:1 so MFNet / PST900 / NYU configs map directly
(reference `config.py`, `configs/mfnet_config.py`, `configs/pst900_config.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

# ImageNet normalisation stats (reference config.py:45-46).
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Dataset paths / formats (reference config.py:19-46)."""

    dataset_name: str = "MFNet"
    dataset_path: str = "datasets/MFNet"
    rgb_folder: str = "RGB"
    rgb_format: str = ".png"
    gt_folder: str = "Label"
    gt_format: str = ".png"
    gt_transform: bool = False  # when True: gt -> gt - 1 (reference RGBXDataset.py:111-113)
    x_folder: str = "Thermal"
    x_format: str = ".png"
    x_is_single_channel: bool = True
    train_source: str = "train_val.txt"
    eval_source: str = "test.txt"
    num_train_imgs: int = 1176
    num_eval_imgs: int = 393
    num_classes: int = 9
    class_names: Sequence[str] = (
        "Unlabeled", "Car", "Person", "Bike", "Curve",
        "Car Stop", "Guardrail", "Color Cone", "Bump",
    )
    background: int = 255  # ignore label (reference config.py:42)
    image_height: int = 480
    image_width: int = 640
    norm_mean: Tuple[float, float, float] = IMAGENET_MEAN
    norm_std: Tuple[float, float, float] = IMAGENET_STD


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network selection knobs (reference config.py:48-65)."""

    backbone: str = "mit_b2"
    pretrained_model: Optional[str] = None
    decoder: str = "MLPDecoder"
    decoder_embed_dim: int = 512
    # Head dropout (reference MLPDecoder.__init__ dropout_ratio=0.1); None
    # keeps each decoder's reference default.
    decoder_dropout_ratio: Optional[float] = None
    # Fusion module selection (reference config.py:57-58).
    feature_rectify_module: str = "FRM"  # FRM | IFRM
    feature_fusion_module: str = "FFM"   # FFM | IFFM
    # BatchNorm hyper-params (reference config.py:79-81).
    bn_eps: float = 1e-3
    bn_momentum: float = 0.1
    # Focal loss parameters (reference config.py:63-65).
    fl_gamma: float = 4.0
    fl_alpha: float = 0.25
    # Stochastic depth (per-backbone defaults live in the encoder factories).
    drop_path_rate: float = 0.1
    # Swin-only knobs (reference dual_swin.py:462-483; defaults off in every
    # reference config). `ape`: learnable absolute position embedding added
    # after patch embed (bicubic-resized to the token grid). `frozen_stages`:
    # freeze the first N stages — stop_gradient in the forward + masked
    # optimizer updates (reference sets requires_grad=False + eval mode).
    # The reference's use_checkpoint maps to the shared `remat` knob below.
    swin_ape: bool = False
    swin_frozen_stages: int = -1
    # Tanh-approximate GELU in the MiT Mix-FFN (the JAX package's default;
    # the original repo's nn.GELU is erf-exact, max |tanh-erf| delta ~1e-3).
    # Set False for bit-parity with converted original-repo checkpoints.
    gelu_approximate: bool = True
    # Compute dtype policy (reference config.py:61): bf16 autocast with fp32
    # params and no loss scaling when True, fp32 otherwise (see torch_dtype).
    use_mixed_precision: bool = True
    # Hand-written attention kernels (the name is the JAX package's, kept so
    # configs carry over). Short-kv SR shapes (M <= 1024) go to
    # ops/sr_attention.py, long-kv shapes (the IFFM cross-attention) to
    # ops/flash_attention.py, Swin windows to ops/window_attention.py: the
    # CUDA kernels keep the fp32 logits and probs on chip and the backward
    # recomputes the probs (see ops/attention.multi_head_attention).
    use_pallas_kernels: bool = True
    # Activation checkpointing of transformer blocks: each MiT and Swin block
    # runs under torch.utils.checkpoint (ops/layers.checkpointed) in
    # training. SegNeXt and ResNet ignore it, as the JAX builder does.
    remat: bool = False


def torch_dtype(model_cfg: ModelConfig) -> torch.dtype:
    """Compute dtype for `use_mixed_precision`: bf16 compute with fp32
    params, as the JAX package's policy, else fp32."""
    return torch.bfloat16 if model_cfg.use_mixed_precision else torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation schedule (reference config.py:67-81)."""

    optimizer: str = "AdamW"          # AdamW | SGDM | LBFGS (reference train.py:114-135)
    criterion: str = "CrossEntropyLoss"
    lr: float = 6e-5
    lr_power: float = 0.9
    momentum: float = 0.9
    weight_decay: float = 0.01
    # LR schedule selection (reference utils/lr_policy.py:19-107; the reference
    # hardcodes WarmUpPolyLR in train.py:138-139 — the other 6 schedules exist
    # but have no config knob there; all 7 are selectable here).
    lr_policy: str = "WarmUpPolyLR"   # WarmUpPolyLR | PolyLR | MultiStageLR |
    #                                   LinearIncreaseLR | CyclicLR | StepLR
    lr_stages: Sequence[Tuple[int, float]] = ()  # MultiStageLR [(epoch, lr), ...]
    end_lr: float = 1e-4              # LinearIncreaseLR target
    min_lr: float = 1e-6              # CyclicLR floor (max = lr)
    cycle_epochs: int = 50            # CyclicLR restart period
    lr_step_size: int = 50            # StepLR epoch period
    lr_gamma: float = 0.5             # StepLR decay factor
    # OHEM knobs (reference loss_opr.py:205-215 exposes thresh/min_kept
    # per-config).
    ohem_thresh: float = 0.6
    ohem_min_kept: int = 256
    # TopologyAwareLoss: the connected-component term is XLA-native
    # (losses._count_components_xla, min-label flooding) so the full loss
    # jits on TPU — the reference round-trips every step's masks to CPU
    # scipy (loss_opr.py:472-476). False trains with the boundary term only.
    topology_with_connectivity: bool = True
    batch_size: int = 8
    nepochs: int = 200
    niters_per_epoch: int = 148       # num_train_imgs // batch_size + 1
    warm_up_epoch: int = 10
    train_scale_array: Optional[Sequence[float]] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
    num_workers: int = 16
    # Checkpointing cadence (reference config.py:91-92).
    checkpoint_start_epoch: int = 350
    checkpoint_step: int = 50
    seed: int = 12345

    @property
    def total_iters(self) -> int:
        return self.nepochs * self.niters_per_epoch

    @property
    def warmup_iters(self) -> int:
        return self.warm_up_epoch * self.niters_per_epoch


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Sliding-window evaluation protocol (reference config.py:83-88)."""

    eval_stride_rate: float = 2.0 / 3.0
    eval_scale_array: Sequence[float] = (0.75, 1.0, 1.25)
    eval_flip: bool = False
    eval_crop_size: Tuple[int, int] = (480, 640)  # (height, width)
    eval_iter: int = 25


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level experiment config."""

    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    log_dir: str = "logs"

    @property
    def num_classes(self) -> int:
        return self.dataset.num_classes

    @property
    def background(self) -> int:
        return self.dataset.background

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def tag(self) -> str:
        """Experiment tag mirroring the reference's derived log path naming
        (reference config.py:100-103)."""
        m = self.model
        parts = [self.dataset.dataset_name, m.backbone, m.decoder,
                 m.feature_rectify_module, m.feature_fusion_module,
                 self.train.criterion]
        if self.train.criterion == "SigmoidFocalLoss":
            parts += [f"gamma{m.fl_gamma}", f"alpha{m.fl_alpha}"]
        return "_".join(parts)


def mfnet_config(**overrides) -> Config:
    """MFNet RGB-Thermal, 9 classes, 480x640 (reference configs/mfnet_config.py)."""
    cfg = Config(
        dataset=DatasetConfig(),
        model=ModelConfig(backbone="mit_b2", decoder="MLPDecoder"),
        train=TrainConfig(lr=6e-5, batch_size=8, nepochs=200,
                          niters_per_epoch=1176 // 8 + 1),
        # MFNet eval uses single scale (reference configs/mfnet_config.py:80-83).
        eval=EvalConfig(eval_scale_array=(1.0,), eval_flip=False,
                        eval_crop_size=(480, 640)),
    )
    return cfg.replace(**overrides) if overrides else cfg


def pst900_config(**overrides) -> Config:
    """PST900 RGB-Thermal, 5 classes (reference configs/pst900_config.py:13-70)."""
    cfg = Config(
        dataset=DatasetConfig(
            dataset_name="PST900",
            dataset_path="datasets/PST900",
            num_train_imgs=597,
            num_eval_imgs=288,
            num_classes=5,
            class_names=("Background", "Fire-Extinguisher", "Backpack",
                         "Hand-Drill", "Survivor"),
        ),
        model=ModelConfig(backbone="mit_b2_w_aspp", decoder="UPernet"),
        train=TrainConfig(lr=2e-4, batch_size=8, nepochs=300,
                          niters_per_epoch=597 // 8 + 1, seed=42),
        eval=EvalConfig(eval_scale_array=(1.0,), eval_flip=False,
                        eval_crop_size=(480, 640)),
    )
    return cfg.replace(**overrides) if overrides else cfg


def nyu_config(**overrides) -> Config:
    """NYU Depth V2 RGB-D (HHA), 40 classes (reference README.md:147-151 protocol)."""
    cfg = Config(
        dataset=DatasetConfig(
            dataset_name="NYUDepthv2",
            dataset_path="datasets/NYUDepthv2",
            rgb_folder="RGB",
            rgb_format=".jpg",
            gt_folder="Label",
            gt_transform=True,
            x_folder="HHA",
            x_format=".jpg",
            x_is_single_channel=False,
            train_source="train.txt",
            eval_source="test.txt",
            num_train_imgs=795,
            num_eval_imgs=654,
            num_classes=40,
            class_names=tuple(f"class_{i}" for i in range(40)),
            image_height=480,
            image_width=640,
        ),
        model=ModelConfig(backbone="mit_b2", decoder="MLPDecoder"),
        train=TrainConfig(lr=6e-5, batch_size=8, nepochs=500,
                          niters_per_epoch=795 // 8 + 1),
        eval=EvalConfig(eval_scale_array=(0.75, 1.0, 1.25), eval_flip=False,
                        eval_crop_size=(480, 640)),
    )
    return cfg.replace(**overrides) if overrides else cfg


PRESETS = {
    "mfnet": mfnet_config,
    "pst900": pst900_config,
    "nyu": nyu_config,
}


def get_config(name: str, **overrides) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown config preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](**overrides)
