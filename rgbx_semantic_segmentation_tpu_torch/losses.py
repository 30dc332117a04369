"""Segmentation losses (counterpart of rgbx_semantic_segmentation_tpu/
losses.py): every criterion of the JAX build_criterion and the Mask2Former
loss.

Functions take `logits` in NHWC layout (B, H, W, C), as the model returns
them, and integer `labels` (B, H, W), and respect `ignore_index`
(= config.background = 255). They compute in fp32 whatever the logits'
dtype, or in float64 when given float64 (the tests' exact references).

Data parallelism: a rank holds its share of the global batch, and the
ranks' losses must add up to the loss of the global batch (the JAX data
mesh's semantics; see train.py). Each loss that is a sum over pixels,
images or queries divided by a count takes `denom_reduce`, which maps a
count (or a sum of weights, or a per-class sum whose sign matters) to its
sum over the ranks; it is applied to detached tensors only, so no gradient
flows through it. With `denom_reduce=None` a loss is that of the batch it
is given. Two criteria need an order statistic of the global batch as
well: OHEM the k-th smallest target probability, which it takes from the
target probabilities gathered from every rank (`gather`, all_gather_ranks),
and berHu the largest residual, an all-reduce MAX whose gradient goes, as
JAX's `max` VJP sends it, in equal shares to every element equal to the
global max on any rank (`global_max`, max_over_ranks). build_criterion
binds both, over more than one rank, to the process group of the batch
(the default group, or on the data x model mesh the data group: its model
ranks hold the same images, which must count once).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]
# -log of the clamped one-hot of RCE's reverse term, the constants rounded
# to fp32 before the log as the JAX version's jnp.log of a Python float:
# log(1 - 1e-9) is then exactly 0.
_RCE_AGREE = -float(np.log(np.float32(1.0 - 1e-9)))
_RCE_DISAGREE = -float(np.log(np.float32(1e-9)))


def _global(t: torch.Tensor, denom_reduce: Reduce) -> torch.Tensor:
    """`t` summed over the ranks (itself without a reduce)."""
    return t if denom_reduce is None else denom_reduce(t)


def all_gather_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' 1-D `t`s (each the same length: the ranks hold equal
    shares of the global batch) concatenated in rank order over `group`
    (None: the default process group). No gradient flows through it."""
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group=group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class _MaxOverRanks(torch.autograd.Function):
    """The largest element of `x` over every rank's `x` (all-reduce MAX).
    Backward: every rank's loss depends on the max, so its cotangent is
    first summed over the ranks; the sum then goes in equal shares to the
    elements equal to the max, counted over all ranks (JAX's `max` VJP:
    jax.grad(jnp.max)([1, 3, 3]) = [0, .5, .5]). The data-parallel SUM of
    the parameter gradients then adds each rank's part once."""

    @staticmethod
    def forward(ctx, x, group):
        m = x.max().clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        ties = x == m
        count = ties.sum().to(x.dtype)
        dist.all_reduce(count, group=group)
        ctx.save_for_backward(ties, count)
        ctx.group = group
        return m

    @staticmethod
    def backward(ctx, g):
        ties, count = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return ties.to(g.dtype) * (g / count), None


def max_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The global max of `x` over the ranks of `group` (None: the default
    process group), differentiable as JAX's `max` of the global batch
    (_MaxOverRanks)."""
    return _MaxOverRanks.apply(x, group)


def _upcast(x: torch.Tensor) -> torch.Tensor:
    """fp32, or float64 kept as it is."""
    return x if x.dtype == torch.float64 else x.float()


def _valid_mask(labels: torch.Tensor, ignore_index: int) -> torch.Tensor:
    return (labels != ignore_index).float()


def _one_hot_safe(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """One-hot (fp32) with out-of-range labels clamped, as the JAX
    version (the original repo clamps before one_hot)."""
    return F.one_hot(labels.long().clamp(0, num_classes - 1),
                     num_classes).float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean",
                       denom_reduce: Reduce = None) -> torch.Tensor:
    """Softmax cross-entropy with ignore_index: fp32 log-softmax over the
    trailing class axis; matches nn.CrossEntropyLoss(ignore_index=...).

    With class weights the mean is normalised by the summed weights of the
    kept targets (torch's rule). When every pixel is ignored the mean is 0,
    where F.cross_entropy gives NaN. Out-of-range labels are clamped, as in
    the JAX version. reduction: "mean" | "sum" | anything else = per-pixel.
    The mean divides by the normaliser summed over the ranks
    (`denom_reduce`, see the module docstring).
    """
    logits = _upcast(logits)
    num_classes = logits.shape[-1]
    valid = (labels != ignore_index).float()
    logp = torch.log_softmax(logits, dim=-1)
    target = labels.long().clamp(0, num_classes - 1)
    nll = -logp.gather(-1, target.unsqueeze(-1)).squeeze(-1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=logits.device)[target]
        nll = nll * w
        denom = (w * valid).sum()
    else:
        denom = valid.sum()
    denom = _global(denom, denom_reduce)
    nll = nll * valid
    if reduction == "mean":
        # Guard only the empty case: the weighted mean divides by
        # sum(w * valid) even when it is < 1.
        return nll.sum() / torch.where(denom > 0, denom,
                                       torch.ones_like(denom))
    if reduction == "sum":
        return nll.sum()
    return nll


def focal_loss(logits, labels, ignore_index: int = 255, gamma: float = 2.0,
               alpha: float = 0.25, reduction: str = "mean",
               denom_reduce: Reduce = None):
    """One-hot focal loss over the classes, normalised by the valid pixels:
    -alpha_t (1 - p_t)^gamma log(p_t + 1e-8) with p_t = p for the target
    class and 1 - p otherwise."""
    logits = _upcast(logits)
    num_classes = logits.shape[-1]
    valid = _valid_mask(labels, ignore_index)
    probs = torch.softmax(logits, dim=-1)
    oh = _one_hot_safe(labels, num_classes)
    target = oh == 1.0
    pt = torch.where(target, probs, 1.0 - probs)
    alpha_w = torch.where(target, alpha, 1.0 - alpha)
    loss = -alpha_w * (1.0 - pt) ** gamma * torch.log(pt + 1e-8)
    loss = loss * valid[..., None]
    if reduction == "mean":
        return loss.sum() / (_global(valid.sum(), denom_reduce) + 1e-8)
    if reduction == "sum":
        return loss.sum()
    return loss.sum(-1)


def focal_loss_2d(logits, labels, ignore_index: int = 255,
                  weight: Optional[torch.Tensor] = None,
                  reduction: str = "mean", denom_reduce: Reduce = None):
    """NLL of (1 - softmax)^2 * log_softmax (the exponent is 2 whatever the
    original's gamma argument), with ignore and torch's weighted mean."""
    logits = _upcast(logits)
    num_classes = logits.shape[-1]
    mod = (1.0 - torch.softmax(logits, dim=-1)) ** 2 * torch.log_softmax(
        logits, dim=-1)
    valid = _valid_mask(labels, ignore_index)
    target = labels.long().clamp(0, num_classes - 1)
    nll = -mod.gather(-1, target.unsqueeze(-1)).squeeze(-1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=logits.device)[target]
        nll = nll * w
        denom = (w * valid).sum()
    else:
        denom = valid.sum()
    denom = _global(denom, denom_reduce)
    nll = nll * valid
    if reduction == "mean":
        return nll.sum() / torch.where(denom > 0, denom,
                                       torch.ones_like(denom))
    if reduction == "sum":
        return nll.sum()
    return nll


def rce_loss(logits, labels, ignore_index: int = 255, beta: float = 0.01,
             denom_reduce: Reduce = None):
    """Reverse cross-entropy: CE + beta * the mean over all pixels of
    -log(clamp(one-hot gt, 1e-9, 1 - 1e-9))[argmax pred] on the valid ones
    (the JAX version's aligned masked mean, which fixes the original's
    (B, B, H, W) broadcast)."""
    logits = _upcast(logits)
    valid = _valid_mask(labels, ignore_index)
    loss1 = cross_entropy_loss(logits, labels, ignore_index,
                               denom_reduce=denom_reduce)
    pred_id = logits.argmax(-1)
    safe_labels = torch.where(valid > 0, labels.long(), 0)
    agree = (pred_id == safe_labels).float()
    loss2_px = agree * _RCE_AGREE + (1.0 - agree) * _RCE_DISAGREE
    count = _global(torch.tensor(float(valid.numel()), device=logits.device),
                    denom_reduce)
    return loss1 + beta * (loss2_px * valid).sum() / count


def balance_loss(logits, labels, ignore_index: int = 255,
                 denom_reduce: Reduce = None):
    """Focal-weighted NLL whose modulation is (1 - softmax(exp(logits)))^2:
    the original's double exponential, kept as the JAX version keeps it."""
    logits = _upcast(logits)
    num_classes = logits.shape[-1]
    prob = torch.softmax(torch.exp(logits), dim=-1)
    weighted = torch.log_softmax(logits, dim=-1) * (1.0 - prob) ** 2
    valid = _valid_mask(labels, ignore_index)
    oh = _one_hot_safe(labels, num_classes)
    nll = -(oh * weighted).sum(-1) * valid
    return nll.sum() / torch.clamp(_global(valid.sum(), denom_reduce), min=1.0)


def berhu_loss(pred, target, ignore_index: int = 0, delta: float = 0.2,
               normalizer=None, denom_reduce: Reduce = None,
               global_max: Optional[Callable] = None):
    """Reverse Huber regression loss with the original's masks: the linear
    part where the TARGET (not the residual) is <= delta x the largest
    valid residual, the quadratic part elsewhere. `normalizer`: divide the
    sum by it (summed over the ranks by `denom_reduce`) instead of taking
    the mean over all elements (of the global batch). `global_max` takes
    the largest residual over the ranks (max_over_ranks; None: this
    batch's)."""
    pred = _upcast(pred)
    target = _upcast(target)
    valid = (target != ignore_index).float()
    valid_delta = (pred - target).abs() * valid
    d = delta * (valid_delta.max() if global_max is None
                 else global_max(valid_delta))
    f_mask = (target <= d).float() * valid
    s_mask = (1.0 - f_mask) * valid
    f_term = valid_delta * f_mask
    s_term = (valid_delta ** 2 + d ** 2) / (2.0 * d + 1e-12) * s_mask
    if normalizer is None:
        count = _global(torch.tensor(float(valid.numel()),
                                     device=valid.device), denom_reduce)
        return (f_term + s_term).sum() / count
    return (f_term + s_term).sum() / torch.clamp(
        _global(normalizer.detach(), denom_reduce), min=1.0)


def berhu_seg_loss(logits, labels, ignore_index: int = 255,
                   denom_reduce: Reduce = None,
                   global_max: Optional[Callable] = None):
    """The JAX package's adaptation of berHu to segmentation (the
    original's subtracts (B, H, W) labels from (B, C, H, W) logits, a
    broadcast error): berHu between the softmax probabilities and the
    one-hot target over the valid pixels, normalised by valid pixels x C
    (of the global batch, with the largest residual of the global batch
    where `denom_reduce` and `global_max` are given)."""
    logits = _upcast(logits)
    num_classes = logits.shape[-1]
    valid = _valid_mask(labels, ignore_index)[..., None]
    probs = torch.softmax(logits, dim=-1) * valid
    oh = _one_hot_safe(torch.where(valid[..., 0] > 0, labels.long(), 0),
                       num_classes) * valid
    # One-hot targets are in {0, 1}: ignore_index=-1 disables berHu's own
    # target masking (validity is applied above).
    return berhu_loss(probs, oh, ignore_index=-1,
                      normalizer=valid.sum() * num_classes,
                      denom_reduce=denom_reduce, global_max=global_max)


def dice_loss(logits, labels, ignore_index: int = 255, smooth: float = 1e-6,
              reduction: str = "mean", denom_reduce: Reduce = None):
    """Soft dice of the softmax probabilities per image and class; "mean"
    is 1 - the mean over images (of the global batch) and classes."""
    logits = _upcast(logits)
    num_classes = logits.shape[-1]
    valid = _valid_mask(labels, ignore_index)[..., None]
    probs = torch.softmax(logits, dim=-1) * valid
    oh = _one_hot_safe(labels, num_classes) * valid
    intersection = (probs * oh).sum((1, 2))
    union = probs.sum((1, 2)) + oh.sum((1, 2))
    dice = (2.0 * intersection + smooth) / (union + smooth)
    if reduction == "mean":
        count = _global(torch.tensor(float(dice.numel()),
                                     device=logits.device), denom_reduce)
        return (1.0 - dice).sum() / count
    if reduction == "sum":
        return (1.0 - dice).sum()
    return 1.0 - dice


def dice_ce_loss(logits, labels, ignore_index: int = 255, alpha: float = 0.5,
                 denom_reduce: Reduce = None):
    """alpha * dice + (1 - alpha) * CE."""
    return (alpha * dice_loss(logits, labels, ignore_index,
                              denom_reduce=denom_reduce)
            + (1.0 - alpha) * cross_entropy_loss(
                logits, labels, ignore_index, denom_reduce=denom_reduce))


def prob_ohem_cross_entropy(logits, labels, ignore_index: int = 255,
                            thresh: float = 0.6, min_kept: int = 256,
                            weight: Optional[torch.Tensor] = None,
                            denom_reduce: Reduce = None,
                            gather: Optional[Callable] = None):
    """Online hard example mining CE: keeps the valid pixels whose target
    probability is <= max(thresh, the min_kept-th smallest target
    probability), all valid pixels when fewer than min_kept are valid; the
    rest count as ignored. No host sync: the branches are selects.

    Over ranks the statistics are the global batch's: `gather`
    (all_gather_ranks) brings every rank's target probabilities for the
    k-th smallest (an order statistic, the same on every rank), the valid
    count is summed by `denom_reduce`, and so is the kept pixels' CE
    normaliser."""
    logits = _upcast(logits)
    num_classes = logits.shape[-1]
    flat_logits = logits.reshape(-1, num_classes)
    flat_labels = labels.reshape(-1).long()
    valid = flat_labels != ignore_index
    with torch.no_grad():
        probs = torch.softmax(flat_logits, dim=-1)
        tgt = torch.where(valid, flat_labels, 0)
        tgt_prob = probs.gather(-1, tgt[:, None])[:, 0]
        # Ignored pixels get probability 1: they sort last.
        tgt_prob = torch.where(valid, tgt_prob, 1.0)
        every = tgt_prob if gather is None else gather(tgt_prob)
        k = min(min_kept, every.numel())
        kth = torch.kthvalue(every, k).values
        kept = valid & (tgt_prob <= torch.clamp(kth, min=thresh))
        n_valid = _global(valid.sum(), denom_reduce)
        kept = torch.where(n_valid < min_kept, valid, kept)
    new_labels = torch.where(kept, flat_labels, ignore_index)
    return cross_entropy_loss(flat_logits, new_labels, ignore_index,
                              weight=weight, denom_reduce=denom_reduce)


# -------------------------------------------------------- Mask2Former --


def mask2former_loss(pred_logits, pred_masks, labels, num_classes: int,
                     ignore_index: int = 255, eos_coef: float = 0.1,
                     class_weight: float = 2.0, mask_weight: float = 5.0,
                     dice_weight: float = 5.0, denom_reduce: Reduce = None):
    """Greedy pixel -> query assignment loss of the JAX package.

    pred_logits: (B, Q, num_classes + 1); pred_masks: (B, Q, H, W) mask
    logits; labels: (B, H, W). Each valid pixel goes to the query of the
    largest sigmoid (first on ties: fp32 sigmoids of logits above ~17 are
    exactly 1, so the sigmoid, not the logit, decides); counts[b, q, c] =
    the pixels of class c query q took; a query's target is its most
    frequent class (smallest on ties), the no-object class when it took
    none, and that one is left out of the focal-weighted class CE
    (eos_coef 0.1, the mean over all (B, Q)). The mask terms: CE with the
    query index as the class, over the valid pixels, and the dice of every
    query's sigmoid against every present class's mask, averaged over
    (B, Q) and summed over the classes / num_classes.

    Over ranks (`denom_reduce`): the means over (B, Q) and over the valid
    pixels take the global counts, and a class is present if any rank's
    images hold it, so the ranks' losses add up to the global batch's.
    """
    pred_logits = _upcast(pred_logits)
    pred_masks = _upcast(pred_masks)
    B, Q = pred_logits.shape[:2]
    device = pred_logits.device
    valid = labels != ignore_index
    safe_lab = torch.where(valid, labels.long(), 0)

    # --- loss_labels ------------------------------------------------------
    sim = torch.sigmoid(pred_masks)                         # (B, Q, H, W)
    with torch.no_grad():
        assignment = sim.argmax(dim=1)                      # (B, H, W)
        # Integer counts by scatter-add; ignored pixels land in a last,
        # dropped bin (no host sync).
        flat = ((torch.arange(B, device=device)[:, None] * Q
                 + assignment.reshape(B, -1)) * num_classes
                + safe_lab.reshape(B, -1))
        flat = torch.where(valid.reshape(B, -1), flat, B * Q * num_classes)
        counts = torch.zeros(B * Q * num_classes + 1, dtype=torch.long,
                             device=device)
        counts.scatter_add_(0, flat.reshape(-1),
                            torch.ones_like(flat.reshape(-1)))
        counts = counts[:-1].reshape(B, Q, num_classes)
        has_pixels = counts.sum(-1) > 0                     # (B, Q)
        target = torch.where(has_pixels, counts.argmax(-1), num_classes)
    empty_weight = torch.ones(num_classes + 1, device=device)
    empty_weight[-1] = eos_coef
    logp = torch.log_softmax(pred_logits, dim=-1)
    ce = -logp.gather(-1, target[..., None])[..., 0] * empty_weight[target]
    ce = ce * (target != num_classes).float()
    p = torch.exp(-ce)
    bq = _global(torch.tensor(float(B * Q), device=device), denom_reduce)
    loss_ce = ((1.0 - p) ** 2.0 * ce).sum() / bq

    # --- loss_masks -------------------------------------------------------
    ce_mask = cross_entropy_loss(pred_masks.permute(0, 2, 3, 1), labels,
                                 ignore_index, denom_reduce=denom_reduce)
    src_sum = sim.sum((2, 3))                               # (B, Q)
    # The class masks (the valid-masked one-hot labels) and every query's
    # intersection with every class in one batched product over H * W.
    tmc = (_one_hot_safe(safe_lab, num_classes)
           * valid[..., None].float()).to(sim)
    inter = torch.bmm(sim.flatten(2), tmc.flatten(1, 2))    # (B, Q, C)
    tm_sum = tmc.sum((1, 2))                                # (B, C)
    dice_score = 2.0 * inter / (src_sum[:, :, None] + tm_sum[:, None, :]
                                + 1e-8)
    present = _global(tm_sum.detach().sum(0), denom_reduce) > 0   # (C,)
    # present x (1 - the mean of the dice over (B, Q)), as this batch's
    # share: its (B, Q) terms of the global mean.
    per_class = torch.where(present, (1.0 - dice_score).sum((0, 1)) / bq,
                            0.0)
    dice_total = per_class.sum() / num_classes
    return (class_weight * loss_ce + mask_weight * ce_mask
            + dice_weight * dice_total)


# ------------------------------------------------------ Topology-aware --

_LAPLACIAN = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], np.float32)
COMPONENT_SWEEPS = 4   # 4-neighbour min sweeps per pointer jump


def _boundary_map(x: torch.Tensor) -> torch.Tensor:
    """|laplacian(x)| > 0.1 as float, per channel of an NHWC map (a
    depthwise conv with zero padding)."""
    C = x.shape[-1]
    kern = torch.from_numpy(_LAPLACIAN).to(x).expand(C, 1, 3, 3)
    y = F.conv2d(x.permute(0, 3, 1, 2), kern, padding=1, groups=C)
    return (y.abs() > 0.1).float().permute(0, 2, 3, 1)


def max_component_rounds(H: int, W: int) -> int:
    """The round cap of `count_components`: a few multiples of the
    O(log2(H * W)) rounds pointer jumping needs, a fail-fast backstop (the
    JAX version's)."""
    return 4 * (int(np.ceil(np.log2(max(H * W, 2)))) + 2)


@torch.no_grad()
def count_components(masks: torch.Tensor, return_rounds: bool = False):
    """4-connected component counts of binary maps (..., H, W) -> (...)
    fp32, on the device (the JAX `_count_components_xla`; scipy's
    `ndimage.label` with its default cross structure is the oracle).

    Min-label flooding with pointer jumping: every pixel starts as its own
    linear index; COMPONENT_SWEEPS 4-neighbour min sweeps (foreground only)
    hook pixels onto smaller labels of their component, then a two-step
    jump lab = lab[lab[lab]] compresses the chains (a label always indexes
    a pixel of the same component with a smaller or equal label). A round
    is the sweeps and the jump; rounds repeat until nothing changes, one
    host read of "changed?" a round, at most `max_component_rounds`. A
    component's minimum survives at exactly one pixel (label == own
    index): the count of such foreground pixels. Integer labels: no
    gradient, as the original's host round trip. With `return_rounds`,
    also the number of rounds run."""
    H, W = masks.shape[-2:]
    lead = masks.shape[:-2]
    fg = masks > 0.5
    sentinel = H * W   # the min-identity for masked-out neighbours
    idx = torch.arange(H * W, device=masks.device).reshape(H, W).expand(
        masks.shape)

    def sweep(lab):
        labm = torch.where(fg, lab, sentinel)
        # Neighbour below / above / right / left, the border padded with
        # the sentinel.
        m = torch.minimum(
            torch.minimum(F.pad(labm[..., 1:, :], (0, 0, 0, 1),
                                value=sentinel),
                          F.pad(labm[..., :-1, :], (0, 0, 1, 0),
                                value=sentinel)),
            torch.minimum(F.pad(labm[..., :, 1:], (0, 1), value=sentinel),
                          F.pad(labm[..., :, :-1], (1, 0), value=sentinel)))
        # Background keeps its own index: the jump's gather stays in bounds.
        return torch.where(fg, torch.minimum(lab, m), idx)

    def round_(lab):
        for _ in range(COMPONENT_SWEEPS):
            lab = sweep(lab)
        flat = lab.reshape(*lead, H * W)
        flat = torch.gather(flat, -1, flat)
        flat = torch.gather(flat, -1, flat)
        return flat.reshape(lab.shape)

    cap = max_component_rounds(H, W)
    lab, rounds = round_(idx), 1
    while rounds < cap:
        nxt = round_(lab)
        rounds += 1
        changed = bool((nxt != lab).any())
        lab = nxt
        if not changed:
            break
    counts = (fg & (lab == idx)).sum((-2, -1)).float()
    return (counts, rounds) if return_rounds else counts


def topology_aware_loss(logits, labels, ignore_index: int = 255,
                        boundary_weight: float = 1.0,
                        connectivity_weight: float = 0.1,
                        with_connectivity: bool = True,
                        denom_reduce: Reduce = None):
    """Laplacian-boundary BCE + the connected-component-count penalty:
    boundary_weight * sum BCE(boundary(softmax), boundary(one-hot)) /
    valid pixels + connectivity_weight * sum over present (image, class)
    of |components(softmax > 0.5) - components(target)| / (B * C). The
    boundaries are thresholded and the counts integers: neither carries a
    gradient (as in the original and the JAX version)."""
    logits = _upcast(logits)
    num_classes = logits.shape[-1]
    B = logits.shape[0]
    pred_soft = torch.softmax(logits, dim=-1)
    valid = _valid_mask(labels, ignore_index)
    oh = _one_hot_safe(torch.where(valid > 0, labels.long(), 0),
                       num_classes) * valid[..., None]
    vb = valid[..., None]
    x, y = _boundary_map(pred_soft) * vb, _boundary_map(oh) * vb
    # BCE with logits, elementwise (torch's formula).
    bce = x.clamp(min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    boundary = bce.sum() / (_global(valid.sum(), denom_reduce) + 1e-8)
    loss = boundary_weight * boundary
    if with_connectivity:
        pred_mask = (pred_soft > 0.5).float() * vb
        tgt_mask = oh * vb
        present = (tgt_mask.sum((1, 2)) > 0).float()       # (B, C)
        n_pred = count_components(pred_mask.permute(0, 3, 1, 2))
        n_tgt = count_components(tgt_mask.permute(0, 3, 1, 2))
        count = _global(torch.tensor(float(B * num_classes),
                                     device=logits.device), denom_reduce)
        conn = ((n_pred - n_tgt).abs() * present).sum() / (count + 1e-8)
        loss = loss + connectivity_weight * conn
    return loss


# ------------------------------------------------------------ factory --

def build_criterion(cfg, world_size: int = 1,
                    denom_reduce: Reduce = None, group=None) -> Callable[
                        [torch.Tensor, torch.Tensor], torch.Tensor]:
    """loss_fn(logits, labels) -> scalar from a Config: the criterion
    selection of the JAX build_criterion, every name of it. `denom_reduce`
    (see the module docstring) binds the global normalisers of a rank of
    `world_size` ranks of the batch; over more than one such rank OHEM and
    berHu also take their order statistic of the global batch over `group`
    (None: the default process group; all_gather_ranks, max_over_ranks)."""
    name = cfg.train.criterion
    ignore = cfg.dataset.background
    ranks = world_size > 1
    gather, global_max = all_gather_ranks, max_over_ranks
    if group is not None:
        gather = functools.partial(all_gather_ranks, group=group)
        global_max = functools.partial(max_over_ranks, group=group)
    glob = {"ignore_index": ignore, "denom_reduce": denom_reduce}
    focal = dict(glob, gamma=cfg.model.fl_gamma, alpha=cfg.model.fl_alpha)
    if name == "CrossEntropyLoss":
        return functools.partial(cross_entropy_loss, **glob)
    if name in ("SigmoidFocalLoss", "FocalLoss"):
        # The original documents 'SigmoidFocalLoss' and keys on 'FocalLoss':
        # both are accepted (the JAX version's rule).
        return functools.partial(focal_loss, **focal)
    if name == "DiceLoss":
        return functools.partial(dice_loss, **glob)
    if name == "DiceCELoss":
        return functools.partial(dice_ce_loss, **glob)
    if name == "RCELoss":
        return functools.partial(rce_loss, **glob)
    if name == "BalanceLoss":
        return functools.partial(balance_loss, **glob)
    if name == "FocalLoss2d":
        return functools.partial(focal_loss_2d, **glob)
    if name == "OhemCrossEntropy":
        return functools.partial(prob_ohem_cross_entropy, **glob,
                                 thresh=cfg.train.ohem_thresh,
                                 min_kept=cfg.train.ohem_min_kept,
                                 gather=gather if ranks else None)
    if name == "berHuLoss":
        return functools.partial(berhu_seg_loss, **glob,
                                 global_max=global_max if ranks else None)
    if name == "CE_Focal":
        # CE + 0.2 x focal (the original's tuple criterion and its fixed
        # second-term weight).
        def ce_focal(logits, labels):
            return (cross_entropy_loss(logits, labels, **glob)
                    + 0.2 * focal_loss(logits, labels, **focal))
        return ce_focal
    if name in ("TopologyAwareLoss", "TopologyAwareCE"):
        # 'TopologyAwareCE' is the original's spelling, the loss class's
        # name an alias: CE + 0.2 x topology_aware_loss.
        with_conn = cfg.train.topology_with_connectivity

        def combined(logits, labels):
            return (cross_entropy_loss(logits, labels, **glob)
                    + 0.2 * topology_aware_loss(
                        logits, labels, with_connectivity=with_conn, **glob))
        return combined
    raise KeyError(f"unknown criterion {name!r}")
