"""Every criterion of build_criterion, the Mask2Former loss and the
connected-component count of the port (rgbx_semantic_segmentation_tpu_torch/
losses.py) against the JAX package's, on the CPU in fp32, same numpy inputs.

Tolerances: a loss at rtol 1e-5 (fp32 both sides, summation order apart);
its gradient w.r.t. the logits within 1e-4 of the gradient's largest
magnitude, against jax.grad; component counts equal as integers, to the
JAX `_count_components_xla` and to scipy's `ndimage.label` (the oracle).
Two exceptions are measured and stated at their tests: the topology loss,
whose JAX value carries its own fp32 summation error, and the focal
losses at confident logits, where both packages' fp32 gradients lie
further than 1e-4 from the exact one (the port's losses run in float64
when given float64: the exact reference).
"""
import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import losses as jlosses
from rgbx_semantic_segmentation_tpu.config import TrainConfig, mfnet_config
from rgbx_semantic_segmentation_tpu_torch import losses as tlosses

torch.set_num_threads(2)

C = 9   # MFNet's classes


def _names():
    """Every criterion name the JAX build_criterion accepts, read off its
    source."""
    names = set()
    for one, many in re.findall(r'name (?:== "(\w+)"|in \(([^)]*)\))',
                                inspect.getsource(jlosses.build_criterion)):
        names.update([one] if one else re.findall(r'"(\w+)"', many))
    return sorted(names)


NAMES = _names()


def _inputs(seed=0, shape=(2, 24, 20), classes=C, scale=1.0,
            ignore_frac=0.1):
    """Logits with blobs of one class (so that the topology loss counts
    real components) plus noise, and labels with ignored pixels. At the
    default scale the logits are of the size a network's are at its
    initialisation (largest softmax probabilities ~0.99)."""
    rng = np.random.RandomState(seed)
    logits = scale * rng.randn(*shape, classes)
    labels = rng.randint(0, classes, shape)
    B, H, W = shape
    for b in range(B):
        for _ in range(4):
            y, x = rng.randint(0, H - 6), rng.randint(0, W - 6)
            c = rng.randint(classes)
            labels[b, y:y + 6, x:x + 6] = c
            logits[b, y:y + 5, x:x + 5, c] += 3 * scale
    labels[rng.rand(*shape) < ignore_frac] = 255
    return logits.astype(np.float32), labels.astype(np.int32)


def _value_and_grad(jfn, tfn, logits, labels):
    """(port loss, JAX loss, port grad, JAX grad) w.r.t. the logits."""
    jl, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    tl = tfn(t, torch.from_numpy(labels))
    tl.backward()
    return float(tl.detach()), float(jl), t.grad.numpy(), np.asarray(jg)


def _assert_close(got, want, grad, jgrad):
    assert got == pytest.approx(want, rel=1e-5)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, jgrad, rtol=0,
                               atol=1e-4 * np.abs(jgrad).max())


def _named(name, **train):
    cfg = mfnet_config()
    return cfg.replace(train=dataclasses.replace(
        TrainConfig(criterion=name), **train))


def _jax_boundary_sum_error(logits, labels, ignore=255):
    """|JAX's fp32 sum of its boundary BCE terms - their exact sum|, from
    the JAX package's own pieces: the rounding of the sum its
    topology_aware_loss divides by the valid count."""
    valid = (labels != ignore).astype(np.float32)
    soft = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    oh = jlosses._one_hot_safe(np.where(valid > 0, labels, 0),
                               logits.shape[-1]) * valid[..., None]
    vb = valid[..., None]
    bce = jlosses._bce_with_logits(jlosses._boundary_map(soft) * vb,
                                   jlosses._boundary_map(oh) * vb)
    return abs(float(jnp.sum(bce)) - np.asarray(bce, np.float64).sum())


@pytest.mark.parametrize("name", NAMES)
def test_criterion_matches_jax(name):
    """Each of the 13 names, through both build_criterion's. The topology
    criteria (CE + 0.2 x boundary BCE / valid pixels + ...): the loss
    within 1e-5 plus the rounding of JAX's fp32 sum of its BCE terms
    (measured here; ~1e-4 of the loss at these shapes, where the port's
    sum lies within 1e-7 of the exact one), and within 1e-5 of the port's
    own float64 value."""
    assert len(NAMES) == 13
    cfg = _named(name)
    logits, labels = _inputs(seed=NAMES.index(name))
    got, want, grad, jgrad = _value_and_grad(
        jlosses.build_criterion(cfg), tlosses.build_criterion(cfg),
        logits, labels)
    if name.startswith("Topology"):
        slack = 0.2 * _jax_boundary_sum_error(logits, labels) / (
            labels != 255).sum()
        assert abs(got - want) <= 1e-5 * abs(want) + slack
        exact = float(tlosses.build_criterion(cfg)(
            torch.from_numpy(logits).double(), torch.from_numpy(labels)))
        assert got == pytest.approx(exact, rel=1e-5)
        got = want
    _assert_close(got, want, grad, jgrad)


@pytest.mark.parametrize("name", ["FocalLoss", "CE_Focal"])
def test_focal_at_confident_logits(name):
    """Logits three times larger (probabilities up to 1 - 1e-4): the focal
    term's 1 - p of a confident wrong class loses ~3 digits in fp32, in
    both packages, so their fp32 gradients lie up to ~4e-4 of the largest
    from the exact one (measured: port 2.6e-4, JAX 3.7e-4). Held to the
    exact (float64) gradient: the port within twice JAX's distance plus
    1e-5 of the largest; the losses at rtol 1e-5."""
    cfg = _named(name)
    logits, labels = _inputs(seed=NAMES.index(name), scale=3.0)
    got, want, grad, jgrad = _value_and_grad(
        jlosses.build_criterion(cfg), tlosses.build_criterion(cfg),
        logits, labels)
    assert got == pytest.approx(want, rel=1e-5)
    t = torch.from_numpy(logits).double().requires_grad_()
    tlosses.build_criterion(cfg)(t, torch.from_numpy(labels)).backward()
    exact = t.grad.numpy()
    scale = np.abs(exact).max()
    port, ref = (np.abs(g - exact).max() / scale for g in (grad, jgrad))
    assert port <= 2 * ref + 1e-5, (port, ref)


@pytest.mark.parametrize("case", [
    "focal_gamma2", "focal_2d_weighted", "dice_sum", "ohem_few_valid",
    "ohem_min_kept_large", "rce_beta", "berhu_plain"])
def test_loss_options_match_jax(case):
    """The options the criteria do not reach from a config: other gamma /
    alpha, class weights, reductions, OHEM's fall-back to all valid pixels
    (fewer valid than min_kept) and a min_kept above the pixel count,
    RCE's beta, berHu on its own."""
    logits, labels = _inputs(seed=20)
    weight = np.random.RandomState(3).uniform(0.2, 2.0, C).astype(np.float32)
    few = labels.copy()
    few[:, 2:] = 255
    fns = {
        "focal_gamma2": (lambda m, x, y: m.focal_loss(x, y, gamma=2.0,
                                                      alpha=0.6), labels),
        "focal_2d_weighted": (lambda m, x, y: m.focal_loss_2d(
            x, y, weight=(jnp.asarray(weight) if m is jlosses
                          else torch.from_numpy(weight))), labels),
        "dice_sum": (lambda m, x, y: m.dice_loss(x, y, reduction="sum"),
                     labels),
        "ohem_few_valid": (lambda m, x, y: m.prob_ohem_cross_entropy(
            x, y, min_kept=200), few),
        "ohem_min_kept_large": (lambda m, x, y: m.prob_ohem_cross_entropy(
            x, y, thresh=0.1, min_kept=10 ** 6), labels),
        "rce_beta": (lambda m, x, y: m.rce_loss(x, y, beta=0.5), labels),
        "berhu_plain": (lambda m, x, y: m.berhu_loss(
            x[..., 0], (y % 3).astype(x.dtype) if m is jlosses
            else (y % 3).to(x.dtype)), labels),
    }
    fn, lab = fns[case]
    assert (lab != 255).sum() < 200 or case != "ohem_few_valid"
    _assert_close(*_value_and_grad(lambda x, y: fn(jlosses, x, y),
                                   lambda x, y: fn(tlosses, x, y),
                                   logits, lab))


@pytest.mark.parametrize("with_connectivity", [True, False])
def test_topology_loss_alone(with_connectivity):
    """topology_aware_loss by itself, with and without the component term:
    the value as test_criterion_matches_jax holds it (1e-5 plus JAX's own
    summation error); the thresholded boundaries and integer counts carry
    no gradient, in JAX (exact zeros) as in the port (no graph)."""
    logits, labels = _inputs(seed=21)
    jfn = lambda x: jlosses.topology_aware_loss(
        x, jnp.asarray(labels), with_connectivity=with_connectivity)
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = tlosses.topology_aware_loss(t, torch.from_numpy(labels),
                                      with_connectivity=with_connectivity)
    slack = _jax_boundary_sum_error(logits, labels) / (labels != 255).sum()
    assert abs(float(got) - float(want)) <= 1e-5 * float(want) + slack
    assert not np.asarray(jgrad).any() and not got.requires_grad


def test_ohem_keeps_the_hard_pixels():
    """The kept set is the JAX version's: the CE over the kept pixels
    equals the plain CE over the pixels whose target probability is at
    most max(thresh, the k-th smallest), and excludes the easy ones."""
    logits, labels = _inputs(seed=5, scale=4.0)
    got = float(tlosses.prob_ohem_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), thresh=0.3,
        min_kept=100))
    p = torch.softmax(torch.from_numpy(logits), -1)
    valid = labels != 255
    tgt = np.where(valid, labels, 0)
    prob = np.take_along_axis(p.numpy(), tgt[..., None], -1)[..., 0]
    prob = np.where(valid, prob, 1.0)
    kth = np.sort(prob.ravel())[99]
    kept = valid & (prob <= max(kth, 0.3))
    assert 100 <= kept.sum() < valid.sum()
    want = float(tlosses.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(np.where(kept, labels,
                                                            255))))
    assert got == pytest.approx(want, rel=1e-6)


def test_build_criterion_over_ranks():
    """Over several ranks the two order-statistic criteria raise, naming
    their ROADMAP item; the others build (tests/test_torch_ddp_criteria.py
    holds them against one process)."""
    for name in NAMES:
        if name in ("OhemCrossEntropy", "berHuLoss"):
            with pytest.raises(NotImplementedError,
                               match=r"ROADMAP M11 \(order statistics"):
                tlosses.build_criterion(_named(name), world_size=2)
        else:
            tlosses.build_criterion(_named(name), world_size=2)
        tlosses.build_criterion(_named(name), world_size=1)


# -------------------------------------------------------- Mask2Former --


def _m2f_inputs(seed=0, B=2, Q=7, H=16, W=12, classes=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, Q, classes + 1).astype(np.float32)
    masks = (8 * rng.randn(B, Q, H, W)).astype(np.float32)
    # Saturated sigmoids: fp32 sigmoid(x) == 1 for x above ~17, so these
    # pixels tie across queries and go to the first of them.
    masks[:, 2:5, :4, :] = rng.uniform(20, 40, (B, 3, 4, W))
    labels = rng.randint(0, classes, (B, H, W))
    labels[rng.rand(B, H, W) < 0.1] = 255
    return logits, masks, labels.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask2former_loss_matches_jax(seed):
    """The loss and its gradients w.r.t. both inputs. The assignment (the
    argmax of the sigmoid over queries, first on ties) is the JAX one on
    these inputs, the saturated ties included; a query with no pixel
    keeps the no-object class (seed 2 leaves some queries empty)."""
    logits, masks, labels = _m2f_inputs(seed)
    if seed == 2:
        masks[:, 5:] -= 50.0
    ties = (torch.sigmoid(torch.from_numpy(masks)) == 1.0).sum(1) > 1
    assert int(ties.sum()) > 0
    t_assign = torch.sigmoid(torch.from_numpy(masks)).argmax(1).numpy()
    j_assign = np.asarray(jnp.argmax(jax.nn.sigmoid(masks), axis=1))
    np.testing.assert_array_equal(t_assign, j_assign)
    jfn = lambda lo, m: jlosses.mask2former_loss(lo, m, labels, 5)
    jl, (jgl, jgm) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(masks))
    tl_, tm = (torch.from_numpy(a).requires_grad_() for a in (logits, masks))
    loss = tlosses.mask2former_loss(tl_, tm, torch.from_numpy(labels), 5)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    for got, want in ((tl_.grad, jgl), (tm.grad, jgm)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    if seed == 2:
        # Queries 5 and 6 took no pixel: their class target is no-object,
        # left out of the class CE (its gradient there is exactly 0).
        assert not tl_.grad[:, 5:].any()


def test_mask2former_loss_all_ignored_is_finite():
    logits, masks, labels = _m2f_inputs(3)
    labels[:] = 255
    t = torch.from_numpy(masks).requires_grad_()
    loss = tlosses.mask2former_loss(torch.from_numpy(logits), t,
                                    torch.from_numpy(labels), 5)
    loss.backward()
    want = float(jlosses.mask2former_loss(logits, masks, labels, 5))
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    assert torch.isfinite(t.grad).all()


# ------------------------------------------------ connected components --


def _spiral(n):
    """A one-pixel-wide square spiral inward from the corner of an n x n
    grid, one pixel apart from its previous turn: one component whose
    min-label chain runs the spiral's whole length."""
    m = np.zeros((n, n), np.float32)
    y = x = d = turns = 0
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    m[0, 0] = 1
    while turns < 2:
        dy, dx = dirs[d]
        y1, x1, y2, x2 = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        if (0 <= y1 < n and 0 <= x1 < n and not m[y1, x1]
                and not (0 <= y2 < n and 0 <= x2 < n and m[y2, x2])):
            y, x, turns = y1, x1, 0
            m[y, x] = 1
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def _masks():
    rng = np.random.RandomState(0)
    cases = {
        "random_sparse": (rng.rand(3, 4, 40, 36) < 0.3),
        "random_dense": (rng.rand(3, 4, 40, 36) < 0.55),
        "spiral": _spiral(41)[None],
        "spanning": np.ones((2, 48, 64)),
        "empty": np.zeros((2, 9, 7)),
        "checkerboard": (np.indices((17, 19)).sum(0) % 2 == 0)[None],
    }
    return {k: v.astype(np.float32) for k, v in cases.items()}


@pytest.mark.parametrize("name", sorted(_masks()))
def test_count_components_matches_jax_and_scipy(name):
    """Equal as integers to the JAX `_count_components_xla` and to scipy,
    in at most the round cap (the spiral's chain is the longest)."""
    m = _masks()[name]
    got, rounds = tlosses.count_components(torch.from_numpy(m),
                                           return_rounds=True)
    assert got.dtype == torch.float32 and got.shape == m.shape[:-2]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlosses._count_components_xla(m)))
    np.testing.assert_array_equal(got.numpy(),
                                  jlosses._count_components_host(m))
    assert 1 <= rounds < tlosses.max_component_rounds(*m.shape[-2:])
    if name == "spanning":
        assert (got == 1).all()
    if name == "spiral":
        assert int(got) == 1 and rounds > 2


def test_topology_counts_hold_the_cap():
    """The round cap is JAX's: 4 * (ceil(log2(H * W)) + 2)."""
    assert tlosses.max_component_rounds(480, 640) == 4 * (19 + 2)
    assert tlosses.max_component_rounds(1, 1) == 4 * (1 + 2)
