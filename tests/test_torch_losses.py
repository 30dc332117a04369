"""The port's cross-entropy (rgbx_semantic_segmentation_tpu_torch/losses.py)
against the JAX package's, on the CPU in fp32, with the same numpy inputs.

Tolerance 1e-5 relative (2e-6 absolute for per-pixel values): both sides
take an fp32 log-softmax and sum in fp32; only the summation order differs.
"""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import losses as jlosses
from rgbx_semantic_segmentation_tpu.config import TrainConfig, mfnet_config
from rgbx_semantic_segmentation_tpu_torch import losses as tlosses

torch.set_num_threads(2)


def _inputs(seed=0, ignore_frac=0.1, shape=(2, 12, 10), classes=9):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(*shape, classes)).astype(np.float32)
    labels = rng.randint(0, classes, shape).astype(np.int32)
    labels[rng.rand(*shape) < ignore_frac] = 255
    return logits, labels


def _both(logits, labels, **kw):
    jkw = dict(kw)
    if kw.get("weight") is not None:
        jkw["weight"] = jnp.asarray(kw["weight"])
        kw = dict(kw, weight=torch.from_numpy(kw["weight"]))
    ref = np.asarray(jlosses.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), **jkw))
    got = tlosses.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), **kw).numpy()
    return got, ref


@pytest.mark.parametrize("ignore_frac", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(ignore_frac, reduction):
    logits, labels = _inputs(ignore_frac=ignore_frac)
    got, ref = _both(logits, labels, reduction=reduction)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_weighted_cross_entropy_matches_jax(reduction):
    logits, labels = _inputs(seed=1)
    weight = np.random.RandomState(2).uniform(0.2, 2.0, 9).astype(np.float32)
    got, ref = _both(logits, labels, weight=weight, reduction=reduction)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # torch's own weighted-mean rule, on NCHW logits
    t = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits).permute(0, 3, 1, 2),
        torch.from_numpy(labels).long(), weight=torch.from_numpy(weight),
        ignore_index=255, reduction=reduction).numpy()
    np.testing.assert_allclose(got, t, rtol=1e-5)


def test_all_ignored_is_zero_not_nan():
    logits, labels = _inputs(seed=3)
    labels[:] = 255
    got, ref = _both(logits, labels)
    assert got == 0.0 and ref == 0.0
    t = torch.from_numpy(logits).requires_grad_()
    tlosses.cross_entropy_loss(t, torch.from_numpy(labels)).backward()
    assert torch.isfinite(t.grad).all() and not t.grad.any()


def test_bf16_logits_are_upcast():
    logits, labels = _inputs(seed=4)
    lo = torch.from_numpy(logits).bfloat16()
    got = tlosses.cross_entropy_loss(lo, torch.from_numpy(labels))
    want = tlosses.cross_entropy_loss(lo.float(), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got == want


def test_gradient_matches_jax():
    import jax

    logits, labels = _inputs(seed=5)
    ref = np.asarray(jax.grad(lambda x: jlosses.cross_entropy_loss(
        x, jnp.asarray(labels)))(jnp.asarray(logits)))
    t = torch.from_numpy(logits).requires_grad_()
    tlosses.cross_entropy_loss(t, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-7, rtol=1e-5)


def test_build_criterion():
    cfg = mfnet_config()
    logits, labels = _inputs(seed=6)
    got = tlosses.build_criterion(cfg)(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    ref = jlosses.build_criterion(cfg)(jnp.asarray(logits),
                                       jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    # Every name the JAX build_criterion accepts, read off its source: the
    # port builds it and agrees (tests/test_torch_criteria.py holds each
    # loss and its gradient).
    names = set()
    for one, many in re.findall(r'name (?:== "(\w+)"|in \(([^)]*)\))',
                                inspect.getsource(jlosses.build_criterion)):
        names.update([one] if one else re.findall(r'"(\w+)"', many))
    assert {"CrossEntropyLoss", "CE_Focal", "TopologyAwareCE",
            "TopologyAwareLoss", "SigmoidFocalLoss", "berHuLoss"} <= names
    assert len(names) == 13
    for name in sorted(names):
        named = cfg.replace(train=TrainConfig(criterion=name))
        fn = tlosses.build_criterion(named)
        np.testing.assert_allclose(
            fn(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
            np.asarray(jlosses.build_criterion(named)(
                jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-5)
    with pytest.raises(KeyError):
        tlosses.build_criterion(cfg.replace(train=TrainConfig(criterion="x")))
