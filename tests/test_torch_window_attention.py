"""The port's window attention (rgbx_semantic_segmentation_tpu_torch/ops/
window_attention.py), forward and backward, against the JAX Pallas kernels,
its Philox keep mask, and its CUDA kernels against their plain versions.

On the CPU the wrappers take the plain versions: here they are held, in
fp32 at rate 0, against the JAX kernels run in Pallas interpret mode as
tests/test_window_attention.py runs them. The port's op takes the whole
image (B, Hp, Wp, 3C) and a (nW, h, N, N) bias; the JAX kernel takes packed
slices (S, B, P*N, 3C) and a (S, h, P, N, N) bias, so the pack and unpack
transposes of the JAX WindowAttention are done here. Forward atol 1e-5 (fp32
summation order at outputs of magnitude ~1); gradients 1e-4 of each
tensor's largest magnitude. The JAX kernel's dropout uses the TPU's
generator, which has no counterpart: the port's mask is held to the
published Philox4x32-10 vectors, to its rate, and forward against backward.

The `cuda` tests need the card and skip without one; they import no jax, so
on the GPU machine they run with
`python -m pytest --noconftest -m cuda tests/test_torch_window_attention.py`.
"""
import os

import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as W

torch.set_num_threads(2)
os.environ.setdefault("RGBX_PALLAS_INTERPRET", "1")

# (B, ni, nj, h, d, ws, shifted): window grid ni x nj. The JAX pack factor
# (windows per block-diagonal slice) follows from ni: 3 -> P = 3, 2 -> 2,
# 1 -> 1, 7 -> 1 (7 * 49 > 256, prime); ws = 12 never packs, ws = 8 (N = 64)
# and 11 (N = 121) pack two windows at ni = 2. Windows 8, 11 and 12 span the
# range 56 < N <= 144 of the bf16 backward's cluster kernel on the card,
# whose plain version these hold to JAX.
SHAPES = [
    (2, 3, 2, 3, 32, 7, True),
    (2, 3, 2, 3, 32, 7, False),
    (1, 1, 5, 2, 32, 7, True),
    (1, 7, 1, 2, 16, 7, False),
    (2, 2, 3, 4, 8, 7, True),
    (1, 2, 1, 4, 32, 12, True),
    (1, 1, 2, 2, 32, 12, False),
    (1, 2, 2, 2, 32, 8, True),
    (1, 2, 1, 2, 16, 11, False),
]


def _inputs(B, ni, nj, h, d, ws, shifted, seed=0):
    """fp32 qkv image, a bias made as the model makes it (a per-head table
    term shared by all windows, plus 0 / -100 mask blocks when shifted) and
    a non-uniform cotangent."""
    rng = np.random.RandomState(seed)
    N, nW = ws * ws, ni * nj
    qkv = rng.randn(B, ni * ws, nj * ws, 3 * h * d).astype(np.float32)
    bias = np.broadcast_to(rng.randn(1, h, N, N), (nW, h, N, N))
    bias = bias.astype(np.float32).copy()
    if shifted:
        mask = np.where(rng.rand(nW, 1, N, 1) < 0.3, 1.0, 0.0)
        bias += np.where(mask != mask.transpose(0, 1, 3, 2), -100.0,
                         0.0).astype(np.float32)
    g = rng.randn(B, ni * ws, nj * ws, h * d).astype(np.float32)
    return qkv, bias, g


def _jax_pack(qkv, bias, ws):
    """Whole-image inputs in the JAX kernel's packed layout, as the JAX
    WindowAttention (dual_swin.py) packs them: qkv (S, B, P*N, 3C), bias
    (S, h, P, N, N); returns them with the unpack of a packed (S, B, T, c)
    image and of a packed (S, h, P, N, N) bias gradient."""
    from rgbx_semantic_segmentation_tpu.ops import window_attention as WA

    B, Hp, Wp, c3 = qkv.shape
    nW, h, N, _ = bias.shape
    ni, nj = Hp // ws, Wp // ws
    P = WA.pack_factor(ni, N)
    nip = ni // P
    S = nip * nj
    x = qkv.reshape(B, nip, P, ws, nj, ws, c3)
    x = x.transpose(1, 4, 0, 2, 3, 5, 6).reshape(S, B, P * N, c3)
    comb = (bias.reshape(nip, P, nj, h, N, N).transpose(0, 2, 3, 1, 4, 5)
            .reshape(S, h, P, N, N))

    def unpack(y):
        c = y.shape[-1]
        return (y.reshape(nip, nj, B, P, ws, ws, c)
                .transpose(2, 0, 3, 4, 1, 5, 6).reshape(B, Hp, Wp, c))

    def unpack_bias(db):
        return (db.reshape(nip, nj, h, P, N, N).transpose(0, 3, 1, 2, 4, 5)
                .reshape(nW, h, N, N))

    return x, comb, unpack, unpack_bias


def _jax_window_attention(qkv, bias, ws):
    """The JAX kernel on whole-image inputs: the pack / unpack transposes
    of the JAX WindowAttention (dual_swin.py) around WA.window_attention in
    interpret mode, rate 0. jnp arrays in and out (differentiable)."""
    import jax.numpy as jnp

    from rgbx_semantic_segmentation_tpu.ops import window_attention as WA

    C = qkv.shape[-1] // 3
    h = bias.shape[1]
    x, comb, unpack, _ = _jax_pack(qkv, bias, ws)
    seed = jnp.zeros((1,), jnp.int32)
    return unpack(WA.window_attention(x, comb, seed, (C // h) ** -0.5, 0.0,
                                      True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,ni,nj,h,d,ws,shifted", SHAPES)
def test_forward_matches_jax_kernel(B, ni, nj, h, d, ws, shifted):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    qkv, bias, _ = _inputs(B, ni, nj, h, d, ws, shifted)
    ref = np.asarray(jax.device_get(_jax_window_attention(
        jnp.asarray(qkv), jnp.asarray(bias), ws)))
    before = W.window_attention.launches
    got = W.window_attention(torch.from_numpy(qkv), torch.from_numpy(bias),
                             None, d ** -0.5, 0.0, ws)
    assert W.window_attention.launches == before  # CPU: the plain version
    assert got.shape == (B, ni * ws, nj * ws, h * d)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,ni,nj,h,d,ws,shifted", SHAPES)
def test_gradients_match_jax_kernel(B, ni, nj, h, d, ws, shifted):
    """dqkv and db through the port's autograd function (plain backward on
    the CPU) against jax.grad of the interpret-mode kernel; db sums over
    the batch, unscaled."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    qkv, bias, g = _inputs(B, ni, nj, h, d, ws, shifted, seed=1)

    def loss(qkv, bias):
        return jnp.sum(_jax_window_attention(qkv, bias, ws) * g)

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    before = W.window_attention_bwd.launches
    out = W.window_attention(tq, tb, None, d ** -0.5, 0.0, ws)
    (out * torch.from_numpy(g)).sum().backward()
    assert W.window_attention_bwd.launches == before
    for name, a, b in zip(("dqkv", "db"), (tq.grad, tb.grad), ref):
        b = np.asarray(jax.device_get(b))
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("B,ni,nj,h,d,ws,shifted", [
    (2, 3, 2, 3, 32, 7, True), (2, 2, 3, 4, 32, 7, False)])
def test_bf16_plain_versions_round_as_the_jax_kernels(B, ni, nj, h, d, ws,
                                                      shifted):
    """bf16 at rate 0: the plain forward and backward (what the kernels are
    held to on the card) against the JAX `_wfwd_call` and `_wbwd_call` in
    interpret mode, on the same bf16 inputs and fp32 bias. Both take fp32
    logits with the scale on them, an fp32 softmax pf, p = bf16(pf), fp32
    sums of bf16 products, dl from the unrounded pf and dlf = bf16(dl *
    scale); they differ in the last bits of exp and in summation order, so
    a rounding to bf16 flips now and then. The bounds are those the card
    holds the kernels to (chip_smoke.py): the output within 2 bf16 ulps of
    its largest magnitude and at most 1% of it differing at all (unrounded
    p: ~40%), dqkv within 4 bf16 ulps of its largest magnitude, db (fp32
    in both) within 1e-3 of its largest."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from rgbx_semantic_segmentation_tpu.ops import window_attention as WA

    qkv, bias, g = _inputs(B, ni, nj, h, d, ws, shifted, seed=7)
    scale = d ** -0.5
    x, comb, unpack, unpack_bias = _jax_pack(jnp.asarray(qkv, jnp.bfloat16),
                                             jnp.asarray(bias), ws)
    gp = _jax_pack(jnp.asarray(g, jnp.bfloat16), jnp.asarray(bias), ws)[0]
    seed = jnp.zeros((1,), jnp.int32)
    out = WA._wfwd_call(x, comb, seed, scale, 0.0, True)
    dqkv, db = WA._wbwd_call(x, comb, seed, gp, scale, 0.0, True)
    assert out.dtype == dqkv.dtype == jnp.bfloat16

    def to_torch(y):
        return torch.from_numpy(np.array(jax.device_get(y).astype(np.float32)))

    ref_out, ref_dqkv = to_torch(unpack(out)), to_torch(unpack(dqkv))
    ref_db = to_torch(unpack_bias(db))
    tq = torch.from_numpy(qkv).bfloat16()
    tb = torch.from_numpy(bias)
    got = W.window_attention_reference(tq, tb, None, scale, 0.0, ws)
    got_dqkv, got_db = W.window_attention_bwd_reference(
        tq, tb, None, torch.from_numpy(g).bfloat16(), scale, 0.0, ws)
    assert got.dtype == got_dqkv.dtype == torch.bfloat16
    got, got_dqkv = got.float(), got_dqkv.float()
    assert float((got - ref_out).abs().max()) <= _bf16_ulps(ref_out, 2)
    assert float((got != ref_out).float().mean()) <= 0.01
    assert float((got_dqkv - ref_dqkv).abs().max()) <= _bf16_ulps(ref_dqkv, 4)
    assert float((got_db - ref_db).abs().max()) <= (
        1e-3 * float(ref_db.abs().max()))


@pytest.mark.parametrize("n,d", [(49, 32), (144, 32), (256, 128), (257, 32),
                                 (49, 129), (1, 1)])
def test_usable_matches_jax_shape_gate(n, d):
    """Same shape gate as the JAX predicate (its platform gate aside)."""
    pytest.importorskip("jax")
    from rgbx_semantic_segmentation_tpu.ops import window_attention as WA

    assert W.usable(n, d) == WA.usable(n, d)


def test_bwd_reference_matches_autograd_of_the_naive_composition():
    """In fp32 no rounding point separates the backward's formulas from
    autograd of softmax(q k^T * scale + bias) v: 1e-5 of the magnitude."""
    B, ni, nj, h, d, ws = 2, 2, 2, 2, 16, 7
    qkv, bias, g = (torch.from_numpy(a) for a in
                    _inputs(B, ni, nj, h, d, ws, True, seed=2))
    qkv.requires_grad_()
    bias.requires_grad_()
    x = W._split_windows(qkv, ws, 3, h)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    p = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5 + bias[None], -1)
    out = W._merge_windows((p @ v)[:, :, None], ws, ni * ws, nj * ws)
    (out * g).sum().backward()
    dqkv, db = W.window_attention_bwd(qkv.detach(), bias.detach(), None, g,
                                      d ** -0.5, 0.0, ws)
    for name, a, b in (("dqkv", dqkv, qkv.grad), ("db", db, bias.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()),
                                   err_msg=name)


def test_expanded_bias_gets_a_full_gradient():
    """An unshifted block hands one (h, N, N) block expanded over the
    windows; db comes back per window and autograd sums it."""
    B, ni, nj, h, d, ws = 1, 2, 2, 2, 8, 7
    qkv, bias, g = (torch.from_numpy(a) for a in
                    _inputs(B, ni, nj, h, d, ws, False, seed=3))
    table = bias[:1].clone().requires_grad_()
    out = W.window_attention(qkv, table.expand(ni * nj, -1, -1, -1), None,
                             d ** -0.5, 0.0, ws)
    (out * g).sum().backward()
    _, db = W.window_attention_bwd(qkv, bias, None, g, d ** -0.5, 0.0, ws)
    np.testing.assert_allclose(table.grad.numpy(), db.sum(0, keepdim=True),
                               atol=1e-6)


# -------------------------------------------------------------- Philox ----

# Known-answer vectors of Philox4x32-10 (Random123 kat_vectors).
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = W.philox4x32([torch.tensor([c], dtype=torch.int64) for c in counter],
                       [torch.tensor(k, dtype=torch.int64) for k in key])
    assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_keep_mask_rate_and_determinism(rate):
    seed = torch.tensor([1234567890123], dtype=torch.int64)
    a = W.keep_mask(seed, 4, 6, 3, 49, rate)
    assert a.shape == (4, 6, 3, 49, 49) and a.dtype == torch.bool
    assert abs(float(a.float().mean()) - (1.0 - rate)) < 0.01
    assert torch.equal(a, W.keep_mask(seed, 4, 6, 3, 49, rate))
    # two independent masks differ in 2 * rate * (1 - rate) of their bits:
    # another seed, and every image, window and head, draws its own mask
    other = W.keep_mask(seed + 1, 4, 6, 3, 49, rate)
    for x, y in ((a, other), (a[0], a[1]), (a[:, 0], a[:, 1]),
                 (a[:, :, 0], a[:, :, 1])):
        differ = float((x != y).float().mean())
        assert abs(differ - 2 * rate * (1 - rate)) < 0.02
    # a negative seed is its two's-complement bit pattern
    neg = W.keep_mask(torch.tensor([-5], dtype=torch.int64), 1, 1, 1, 49, rate)
    assert abs(float(neg.float().mean()) - (1.0 - rate)) < 0.05


def test_keep_mask_element_layout():
    """Element (r, c) reads word 2 * ((r % 16) // 8) + c % 2 of the call
    with counter (c // 2, 8 * (r // 16) + r % 8, window * h + head, image)."""
    seed = torch.tensor([(7 << 32) | 9], dtype=torch.int64)
    B, nW, h, N, rate = 2, 3, 2, 49, 0.3
    mask = W.keep_mask(seed, B, nW, h, N, rate)
    thr = W.dropout_threshold(rate)
    for b, w, i, r, c in [(0, 0, 0, 0, 0), (1, 2, 1, 48, 48), (0, 1, 1, 9, 6),
                          (1, 0, 0, 24, 31), (0, 2, 0, 33, 17)]:
        counter = [torch.tensor([v], dtype=torch.int64) for v in
                   (c // 2, 8 * (r // 16) + r % 8, w * h + i, b)]
        words = W.philox4x32(counter, [torch.tensor(9), torch.tensor(7)])
        bits = int(words[2 * ((r % 16) // 8) + c % 2])
        assert bool(mask[b, w, i, r, c]) == (bits >= thr)


def test_dropout_scales_kept_probabilities():
    """With v = 1 every output is the row sum of pd: about 1, and exactly
    the kept share of the row times 1 / (1 - rate)."""
    B, ni, nj, h, d, ws, rate = 2, 2, 2, 2, 8, 7, 0.3
    qkv, bias, _ = (torch.from_numpy(a) for a in
                    _inputs(B, ni, nj, h, d, ws, False, seed=4))
    qkv[..., 2 * h * d:] = 1.0
    qkv[..., :2 * h * d] = 0.0   # uniform probabilities 1 / N
    seed = torch.tensor([42], dtype=torch.int64)
    out = W.window_attention(qkv, torch.zeros_like(bias), seed, d ** -0.5,
                             rate, ws)
    keep = W.keep_mask(seed, B, ni * nj, h, ws * ws, rate)
    want = keep.float().mean(-1) / (1.0 - rate)        # (B, nW, h, N)
    got = W._split_windows(out, ws, 1, h)[:, :, 0, :, :, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert abs(float(out.mean()) - 1.0) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropped_probabilities_match_jax_expression(dtype):
    """pd at rate 0.3 under a fixed keep mask against the JAX kernel's own
    expression (`_fwd_kernel`: round p, where(keep, p * 1 / (1 - rate), 0),
    round again). fp32: the same factor on both sides, 1e-6 relative. bf16:
    JAX multiplies by the factor rounded to bf16 (1.4297 for 1.428571, 0.08%
    off), the port by the fp32 factor, so a kept element may round to the
    neighbouring bf16 value: at most one bf16 ulp (2^-7 relative) apart,
    dropped elements exactly 0 on both sides."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    rate, N = 0.3, 49
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 3, 2, N, N).astype(np.float32) * 2
    pf = torch.softmax(torch.from_numpy(logits), -1)
    keep = W.keep_mask(torch.tensor([99], dtype=torch.int64), 2, 3, 2, N, rate)
    dt = jnp.dtype(dtype)
    p = jnp.asarray(pf.numpy()).astype(dt)
    ref = jnp.where(jnp.asarray(keep.numpy()), p * (1.0 / (1.0 - rate)),
                    0.0).astype(dt)
    ref = np.asarray(ref.astype(jnp.float32))
    got = W._dropped(pf, keep, rate, getattr(torch, dtype)).numpy()
    assert np.array_equal(got == 0, ~keep.numpy())
    assert np.array_equal(ref == 0, ~keep.numpy())
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
    if dtype == "bfloat16":
        # the two factors do round some elements apart: the difference the
        # module docstring states is real, and small
        assert 0 < float((got != ref).mean()) < 0.5


def test_dropout_bwd_mask_matches_fwd():
    """The backward regenerates the mask from the seed: the directional
    derivative matches finite differences of the same-seed forward (as the
    JAX test_dropout_bwd_mask_matches_fwd), in float64-free fp32: rtol 5e-3."""
    B, ni, nj, h, d, ws, rate = 2, 2, 1, 2, 16, 7, 0.3
    qkv, bias, _ = (torch.from_numpy(a) for a in
                    _inputs(B, ni, nj, h, d, ws, True, seed=5))
    seed = torch.tensor([42], dtype=torch.int64)

    def f(x):
        out = W.window_attention(x, bias, seed, d ** -0.5, rate, ws)
        return (out * out).sum()

    x = qkv.clone().requires_grad_()
    f(x).backward()
    tang = torch.from_numpy(
        np.random.RandomState(0).randn(*qkv.shape).astype(np.float32))
    eps = 1e-3
    with torch.no_grad():
        num = (f(qkv + eps * tang) - f(qkv - eps * tang)) / (2 * eps)
    ana = (x.grad * tang).sum()
    np.testing.assert_allclose(float(num), float(ana), rtol=5e-3)
    # and the mask matters: another seed gives another gradient
    y = qkv.clone().requires_grad_()
    out = W.window_attention(y, bias, seed + 1, d ** -0.5, rate, ws)
    (out * out).sum().backward()
    assert float((y.grad - x.grad).abs().max()) > 1e-3


def test_no_grad_forward_skips_autograd():
    qkv, bias, _ = (torch.from_numpy(a) for a in _inputs(1, 1, 1, 1, 8, 7, False))
    with torch.no_grad():
        assert W.window_attention(qkv, bias, None, 1.0, 0.0, 7).grad_fn is None
    assert W.window_attention(qkv, bias, None, 1.0, 0.0, 7).grad_fn is None
    out = W.window_attention(qkv, bias.requires_grad_(), None, 1.0, 0.0, 7)
    assert out.grad_fn is not None


def test_wrapper_rejects_bad_inputs():
    qkv, bias, g = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 2, 8, 7, False))
    with pytest.raises(ValueError, match="expected"):
        W.window_attention(qkv, bias[:1], None, 1.0, 0.0, 7)
    with pytest.raises(ValueError, match="does not split"):
        W.window_attention(qkv[:, :13], bias, None, 1.0, 0.0, 7)
    with pytest.raises(ValueError, match="float32"):
        W.window_attention(qkv, bias.double(), None, 1.0, 0.0, 7)
    with pytest.raises(ValueError, match="seed"):
        W.window_attention(qkv, bias, None, 1.0, 0.3, 7)
    with pytest.raises(ValueError, match="seed"):
        W.window_attention(qkv, bias, torch.tensor([1], dtype=torch.int32),
                           1.0, 0.3, 7)
    with pytest.raises(ValueError, match="cotangent"):
        W.window_attention_bwd(qkv, bias, None, g[:, :7], 1.0, 0.0, 7)


# ------------------------------------------------------------ on the card ----

# (B, Hp, Wp, h, d, ws): the four swin_s stages at 480x640 with a small
# batch, window 12 (swin_b), d = 64, one image, a single window, and the
# four swin_b stages at 480x640 with a small batch.
CUDA_SHAPES = [(2, 126, 161, 3, 32, 7), (2, 63, 84, 6, 32, 7),
               (2, 35, 42, 12, 32, 7), (2, 21, 21, 24, 32, 7),
               (2, 24, 36, 4, 32, 12), (1, 14, 21, 2, 64, 7),
               (3, 7, 7, 1, 16, 7), (1, 14, 14, 2, 24, 7),
               (1, 16, 16, 1, 128, 16), (2, 120, 168, 4, 32, 12),
               (2, 60, 84, 8, 32, 12), (2, 36, 48, 16, 32, 12),
               (2, 24, 24, 32, 32, 12)]


def _cuda_inputs(shape, dtype, dev, shifted, seed=0):
    B, Hp, Wp, h, d, ws = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    N, nW = ws * ws, (Hp // ws) * (Wp // ws)
    qkv = torch.randn(B, Hp, Wp, 3 * h * d, device=dev, generator=g).to(dtype)
    bias = torch.randn(1, h, N, N, device=dev, generator=g)
    if shifted:
        part = (torch.rand(nW, 1, N, 1, device=dev, generator=g) < 0.3).float()
        bias = bias + torch.where(part != part.transpose(-1, -2), -100.0, 0.0)
    else:
        bias = bias.expand(nW, -1, -1, -1)
    cot = torch.randn(B, Hp, Wp, h * d, device=dev, generator=g).to(dtype)
    return qkv, bias, cot, torch.tensor([20240 + seed], device=dev)


def _bf16_ulps(ref, ulps):
    mag = ref.float().abs().max().item()
    return ulps * 2.0 ** (np.floor(np.log2(mag)) - 7) if mag > 0 else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype, shifted, rate):
    """The forward kernel against its plain version on the card, same mask.
    bf16: two ulps at the output's magnitude (fp32 summation order may flip
    one rounding of a prob and one of the output); fp32 (TF32 off): 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, bias, _, seed = _cuda_inputs(shape, dtype, cuda, shifted)
    d, ws = shape[4], shape[5]
    ref = W.window_attention_reference(qkv, bias, seed, d ** -0.5, rate, ws)
    before = W.window_attention.launches
    got = W.window_attention(qkv, bias, seed, d ** -0.5, rate, ws)
    torch.cuda.synchronize()
    assert W.window_attention.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    tol = _bf16_ulps(ref, 2) if dtype == torch.bfloat16 else 1e-5
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol, (err, tol)
    if dtype == torch.bfloat16:
        # rounding points and mask: a kernel that kept p unrounded, or drew
        # another mask, differs in far more than 1% of its outputs
        assert (got != ref).float().mean().item() <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_backward_kernel_matches_plain(cuda, shape, dtype, shifted, rate):
    """The backward kernel against its plain version on the card. fp32
    (TF32 off): 2e-5 of the gradient's magnitude (summation order). bf16:
    dqkv 4 bf16 ulps of its largest magnitude (sums of products whose bf16
    factors pd and dlf may each round the other way); db is fp32 in both but
    inherits bf16 inputs' products: 1e-3 of its largest magnitude. No
    atomics: two runs give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, bias, cot, seed = _cuda_inputs(shape, dtype, cuda, shifted, seed=1)
    d, ws = shape[4], shape[5]
    ref = W.window_attention_bwd_reference(qkv, bias, seed, cot, d ** -0.5,
                                           rate, ws)
    before = W.window_attention_bwd.launches
    got = W.window_attention_bwd(qkv, bias, seed, cot, d ** -0.5, rate, ws)
    again = W.window_attention_bwd(qkv, bias, seed, cot, d ** -0.5, rate, ws)
    torch.cuda.synchronize()
    assert W.window_attention_bwd.launches == before + 2
    for name, a, b, c in zip(("dqkv", "db"), got, ref, again):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a).all() and torch.equal(a, c)
        mag = max(1e-30, b.float().abs().max().item())
        if dtype == torch.float32:
            tol = 2e-5 * max(1.0, mag)
        else:
            tol = _bf16_ulps(b, 4) if name == "dqkv" else 1e-3 * mag
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


# (B, Hp, Wp, h, d, ws): the swin_s stage-3 and stage-4 shapes at the
# model's batch 8, and batches 1, 3, 5 and 13, odd counts of images for the
# two-stage ring a block walks (batch 1: the first image alone); the four
# swin_b stages at batch 8, and the backward's cluster kernel (56 < N <=
# 144) at windows 8 and 11 (padded key tiles and rows) and at window 12 with
# d 16, 24 and 64, at batches 1, 3 and 5.
TC_SHAPES = [(8, 35, 42, 12, 32, 7), (8, 21, 21, 24, 32, 7),
             (1, 21, 21, 24, 32, 7), (3, 35, 42, 12, 32, 7),
             (5, 21, 21, 24, 32, 7), (5, 14, 21, 2, 64, 7),
             (13, 7, 14, 1, 32, 7), (8, 120, 168, 4, 32, 12),
             (8, 60, 84, 8, 32, 12), (8, 36, 48, 16, 32, 12),
             (8, 24, 24, 32, 32, 12), (3, 16, 24, 2, 32, 8),
             (1, 22, 33, 3, 32, 11), (5, 24, 36, 4, 16, 12),
             (1, 24, 36, 4, 24, 12), (3, 24, 24, 2, 64, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_kernels_at_model_batches_and_ragged_shares(
        cuda, shape, shifted, rate):
    """bf16 forward and backward kernels at the model's batch and at ragged
    batches, against their plain versions under the bounds of
    test_kernel_matches_plain and test_backward_kernel_matches_plain, and
    each run twice with the same bits (forward; dqkv and db)."""
    qkv, bias, cot, seed = _cuda_inputs(shape, torch.bfloat16, cuda, shifted,
                                        seed=3)
    d, ws = shape[4], shape[5]
    args = (qkv, bias, seed, d ** -0.5, rate, ws)
    ref = W.window_attention_reference(*args)
    got = W.window_attention(*args)
    again = W.window_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() <= _bf16_ulps(ref, 2)
    assert (got != ref).float().mean().item() <= 0.01
    bargs = (qkv, bias, seed, cot, d ** -0.5, rate, ws)
    ref = W.window_attention_bwd_reference(*bargs)
    got = W.window_attention_bwd(*bargs)
    again = W.window_attention_bwd(*bargs)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dqkv", "db"), got, ref, again):
        assert torch.isfinite(a).all() and torch.equal(a, c), name
        tol = (_bf16_ulps(b, 4) if name == "dqkv"
               else 1e-3 * b.abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 35, 42, 12, 32, 7),
                                   (5, 21, 21, 24, 32, 7),
                                   (1, 24, 36, 4, 32, 12)])
def test_tensor_core_forward_draws_keep_mask(cuda, shape):
    """At rate 0.3 the mask the bf16 forward kernel applies, read off its
    outputs, is `keep_mask`, bit for bit, whichever block computes an
    image."""
    from rgbx_semantic_segmentation_tpu_torch.tools import (
        bench_window_attention as T)

    seed = torch.tensor([987654321012], device=cuda)
    B, Hp, Wp, h, _, ws = shape
    want = W.keep_mask(seed, B, (Hp // ws) * (Wp // ws), h, ws * ws, 0.3)
    assert torch.equal(T.kernel_mask(shape, seed, 0.3), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 35, 42, 12, 32, 7),
                                   (8, 36, 48, 16, 32, 12),
                                   (3, 22, 33, 3, 32, 11)])
def test_tensor_core_backward_draws_keep_mask(cuda, shape):
    """At rate 0.3 the mask the bf16 backward kernel applies (window 7: the
    one-block kernel; windows 11 and 12: the cluster kernel), read off its
    dv, is `keep_mask`, bit for bit."""
    from rgbx_semantic_segmentation_tpu_torch.tools import (
        bench_window_attention as T)

    seed = torch.tensor([987654321012], device=cuda)
    B, Hp, Wp, h, _, ws = shape
    want = W.keep_mask(seed, B, (Hp // ws) * (Wp // ws), h, ws * ws, 0.3)
    assert torch.equal(T.kernel_bwd_mask(shape, seed, 0.3), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,fwd,bwd", [
    ((2, 35, 42, 12, 32, 7), torch.bfloat16, "fwd_tc", "bwd_tc"),
    ((2, 24, 36, 4, 32, 12), torch.bfloat16, "fwd_tc", "bwd_cluster"),
    ((1, 14, 21, 2, 64, 7), torch.bfloat16, "fwd_tc", "bwd_tc"),
    ((2, 24, 36, 4, 32, 12), torch.float32, "fwd_scalar", "bwd_scalar")])
def test_bf16_shapes_take_the_tensor_core_kernels(cuda, shape, dtype, fwd,
                                                  bwd):
    """The device kernels a call launches, by name: bf16 window 7 (swin_s)
    takes the tensor-core forward and backward, bf16 window 12 (swin_b, N =
    144) the tensor-core forward and the backward's cluster kernel; fp32
    window 12 the scalar kernels."""
    from torch.profiler import ProfilerActivity, profile

    qkv, bias, cot, seed = _cuda_inputs(shape, dtype, cuda, True)
    d, ws = shape[4], shape[5]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        W.window_attention(qkv, bias, seed, d ** -0.5, 0.3, ws)
        W.window_attention_bwd(qkv, bias, seed, cot, d ** -0.5, 0.3, ws)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if "window_attention" in e.key]
    assert any(f"window_attention_{fwd}" in n for n in names), names
    assert any(f"window_attention_{bwd}" in n for n in names), names


@pytest.mark.cuda
def test_kernel_gradients_through_autograd(cuda):
    """fp32 on the card: gradients of qkv and of an expanded bias through
    the kernels against autograd of the naive composition."""
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (2, 14, 21, 2, 32, 7)
    qkv, bias, cot, _ = _cuda_inputs(shape, torch.float32, cuda, False, seed=2)
    h, d, ws = shape[3:]
    grads = []
    for kernel in (True, False):
        x = qkv.clone().requires_grad_()
        t = bias[:1].clone().requires_grad_()
        full = t.expand(bias.shape[0], -1, -1, -1)
        if kernel:
            out = W.window_attention(x, full, None, d ** -0.5, 0.0, ws)
        else:
            w = W._split_windows(x, ws, 3, h)
            p = torch.softmax(w[:, :, 0] @ w[:, :, 1].transpose(-1, -2)
                              * d ** -0.5 + full[None], -1)
            out = W._merge_windows((p @ w[:, :, 2])[:, :, None], ws,
                                   shape[1], shape[2])
        (out * cot).sum().backward()
        grads.append((x.grad, t.grad))
    for a, b in zip(*grads):
        tol = 2e-5 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_raises_on_what_it_cannot_take(cuda):
    qkv, bias, _, _ = _cuda_inputs((1, 7, 7, 1, 16, 7), torch.float32, cuda,
                                   False)
    with pytest.raises(TypeError):
        W.window_attention(qkv.half(), bias, None, 1.0, 0.0, 7)
    with pytest.raises(ValueError, match="contiguous qkv"):
        W.window_attention(qkv.transpose(1, 2), bias, None, 1.0, 0.0, 7)
    big = torch.zeros(1, 17, 17, 3 * 8, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        W.window_attention(big, torch.zeros(1, 1, 289, 289, device=cuda),
                           None, 1.0, 0.0, 17)
    with pytest.raises(ValueError, match="seed"):
        W.window_attention(qkv, bias, torch.tensor([1]), 1.0, 0.3, 7)


@pytest.mark.cuda
def test_swin_block_raises_on_a_window_the_kernels_do_not_take(cuda):
    """use_pallas alone routes a block to the op: on the card a head dim
    above 128 raises, it does not run the plain composition; with
    use_pallas off the same block runs."""
    from rgbx_semantic_segmentation_tpu_torch.models.encoders import dual_swin

    x = torch.zeros(1, 49, 160, device=cuda)
    blk = dual_swin.SwinBlock(160, 1, 7, 0, use_pallas=True).to(cuda).eval()
    with torch.no_grad():
        with pytest.raises(ValueError, match="does not take"):
            blk(x, 7, 7)
        blk.use_pallas = False
        assert blk(x, 7, 7).shape == x.shape
