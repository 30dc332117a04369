"""The port's long-kv flash attention (rgbx_semantic_segmentation_tpu_torch/
ops/flash_attention.py), forward and backward, against the upstream Pallas
TPU kernels the JAX package calls, the dispatch of
ops/attention.multi_head_attention, and the CUDA kernels against their plain
versions.

On the CPU the wrappers take the plain versions. Here they are held against
the JAX package's `attention._flash_attention`, i.e. the upstream
jax.experimental.pallas.ops.tpu.flash_attention kernels (forward, dk/dv and
dq under their custom VJP), run on the CPU under
`pltpu.force_tpu_interpret_mode()`, in fp32, with ragged N and M > 1024 (the
JAX wrapper pads both to 128 and masks the padding; the port masks the
ragged tile). Inputs are numpy from a seed. Forward atol 1e-5, gradients
atol 1e-4 (fp32 on both sides: summation order, exp(s - m) / l against
exp(s - lse), and the TPU kernel's per-tile renormalisation).

The `cuda` tests need the card and skip without one; they import no jax, so
on the GPU machine they run with
`python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py`.
"""
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch.ops import attention as A
from rgbx_semantic_segmentation_tpu_torch.ops import flash_attention as FA
from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S

torch.set_num_threads(2)

# (B, h, N, M, d): ragged N and M > 1024; N == M with h > 1; d = 64.
SHAPES = [(1, 2, 200, 1300, 32), (2, 2, 333, 333, 32), (1, 1, 130, 1025, 64)]
# The kernels' cases on the card: ragged tiles, M = 1025, d = 32 / 40 / 128,
# h > 1, B = 1, a single tile, one long shape, N, M one row either side of
# the forward's blocks of 192 (d = 128: 128) q rows and kv tiles of 128
# (d = 128: 64) rows, kv walks of 33 tiles or more, which the forward
# splits across a cluster of blocks (d = 128 too), and SegNeXt's narrow
# heads (d = 8, 16, 40 of segnext_b, 24 and 48 of segnext_large: the
# columns past d of the 64-wide panel zeros).
CUDA_SHAPES = [(1, 2, 200, 130, 32), (2, 1, 77, 1025, 64),
               (1, 3, 1030, 65, 40), (2, 2, 64, 64, 128),
               (1, 1, 130, 300, 64), (2, 5, 1200, 1200, 64),
               (1, 2, 191, 127, 64), (1, 1, 193, 129, 32),
               (2, 3, 385, 257, 64), (1, 1, 257, 385, 128),
               (1, 1, 200, 4100, 64), (2, 2, 130, 4097, 32),
               (1, 1, 130, 2100, 128), (2, 2, 130, 4097, 128),
               (2, 8, 1200, 1200, 8), (1, 8, 1100, 1030, 16),
               (1, 8, 1030, 1100, 40), (1, 8, 1030, 1100, 24),
               (2, 8, 300, 1200, 48)]
# Head dims that reach the kernels zero-padded to a multiple of 8 on the
# model's path (ops/attention.multi_head_attention, which sends N >= 1024
# here): segnext_large's d = 12 and segnext_tiny's d = 20, ragged.
PADDED_CUDA_SHAPES = [(1, 8, 1030, 1100, 12), (2, 8, 1040, 1030, 20)]
# bf16, the plain version against the upstream Pallas forward: ragged N and
# M > 1024 (the JAX wrapper walks kv in 128-row blocks here), d = 32 and 64.
BF16_SHAPES = [(1, 2, 1030, 1300, 32), (1, 1, 1100, 1025, 64)]


def _mk(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _inputs(B, h, N, M, d, seed=0):
    q, k, v = (_mk((B, h, n, d), seed + i) for i, n in enumerate((N, M, M)))
    return q, k, v, _mk((B, h, N, d), seed + 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _torch_out_and_grads(fn, q, k, v, w):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(w))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_out_and_grads(fn, q, k, v, w):
    import jax
    import jax.numpy as jnp

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * w), out

    grads, out = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_forward_and_gradients_match_upstream_pallas_kernels(B, h, N, M, d):
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    from rgbx_semantic_segmentation_tpu.ops import attention as JA

    q, k, v, w = _inputs(B, h, N, M, d)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref, ref_grads = _jax_out_and_grads(
            lambda q, k, v: JA._flash_attention(q, k, v, scale), q, k, v, w)
    before = (FA.flash_attention.launches, FA.flash_attention_dkv.launches,
              FA.flash_attention_dq.launches)
    got, grads = _torch_out_and_grads(
        lambda q, k, v: FA.flash_attention(q, k, v, scale), q, k, v, w)
    # CPU: the plain versions, no launch counted.
    assert before == (FA.flash_attention.launches,
                      FA.flash_attention_dkv.launches,
                      FA.flash_attention_dq.launches)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    for name, a, b in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("B,h,N,M,d", BF16_SHAPES)
def test_bf16_forward_rounds_as_the_upstream_pallas_kernel(B, h, N, M, d):
    """bf16: the plain forward (what the kernel is held to on the card)
    against the JAX package's `_flash_attention`, the upstream Pallas TPU
    forward in interpret mode, on the same bf16 inputs. Both round p to
    bf16 before p @ v and sum the unrounded p; the TPU kernel rounds p
    against the running max of its kv blocks and renormalises its
    accumulator every block, the plain version uses the row max. So each
    p_j rounds differently by <= 2^-9 p_j, and on independent inputs these
    errors add like noise of size 2^-9 R over a row, R = sqrt(sum_j p_j^2
    v_j^2). chip_smoke.py's bound of the kernel against the plain version:
    every element within 2 bf16 ulps of itself + 4 * 2^-8 R, the tensor
    within 5e-3 relative L2."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from rgbx_semantic_segmentation_tpu.ops import attention as JA

    q, k, v, _ = _inputs(B, h, N, M, d, seed=11)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref = JA._flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in (q, k, v)), scale)
    assert ref.dtype == jnp.bfloat16
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got, lse = FA.flash_attention_reference(tq, tk, tv, scale)
    assert got.dtype == torch.bfloat16
    got = got.float()
    out2, lse2 = FA.flash_attention_reference(tq.float(), tk.float(),
                                              tv.float().square(), 2 * scale)
    noise = (out2 * torch.exp(lse2 - 2 * lse).unsqueeze(-1)).sqrt()
    err = (got - ref).abs()
    tol = 2 * _ulp(torch.maximum(got.abs(), ref.abs())) + 4 * 2.0 ** -8 * noise
    assert float((err / tol).max()) <= 1.0
    assert float(err.norm() / ref.norm()) <= 5e-3
    # The two do round differently: not bit-equal.
    assert float((got != ref).float().mean()) > 0


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_matches_jax_sdpa(B, h, N, M, d):
    """Against the JAX `_sdpa` (the composition the kernels replace), fp32:
    forward 1e-5, gradients 1e-4."""
    pytest.importorskip("jax")
    from rgbx_semantic_segmentation_tpu.ops import attention as JA

    q, k, v, w = _inputs(B, h, N, M, d, seed=4)
    scale = d ** -0.5
    ref, ref_grads = _jax_out_and_grads(
        lambda q, k, v: JA._sdpa(q, k, v, scale), q, k, v, w)
    for fn in (FA.flash_attention, FA.flash_attention_plain):
        got, grads = _torch_out_and_grads(
            lambda q, k, v: fn(q, k, v, scale), q, k, v, w)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        for name, a, b in zip("qkv", grads, ref_grads):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                       err_msg=f"d{name}")


def test_row_chunks_do_not_change_the_result(monkeypatch):
    """The plain versions walk q in chunks of rows; rows are independent in
    the forward and dk, dv sum over the chunks in fp32: 1e-6 against one
    chunk, and the statistics equal."""
    B, h, N, M, d = 2, 2, 150, 70, 32
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(B, h, N, M, d, seed=8))
    scale = d ** -0.5
    out, lse = FA.flash_attention_reference(q, k, v, scale)
    whole = FA.flash_attention_bwd_reference(q, k, v, out, lse, w, scale)
    monkeypatch.setattr(FA, "CHUNK_ELEMS", B * h * M * 37)
    assert len(FA._row_chunks(q, M)) == 5
    out2, lse2 = FA.flash_attention_reference(q, k, v, scale)
    torch.testing.assert_close(out2, out, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse2, lse, atol=1e-6, rtol=0)
    for a, b in zip(FA.flash_attention_bwd_reference(q, k, v, out, lse, w,
                                                     scale), whole):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_plain_version_rounds_p_before_pv():
    """bf16: p is rounded to bf16 before p @ v and the row sum adds the
    unrounded p. On a row with a few comparable logits the rounded and the
    unrounded versions differ, and the rounded one is the hand computation."""
    q = torch.tensor([[[[1.0, 0.0]]]]).bfloat16().expand(1, 1, 1, 2)
    k = torch.tensor([[[[0.0, 0.0], [-0.3, 0.0], [-0.7, 0.0]]]]).bfloat16()
    v = torch.tensor([[[[1.0, 3.0], [1.0, -5.0], [1.0, 7.0]]]]).bfloat16()
    out, lse = FA.flash_attention_reference(q, k, v, 1.0)
    s = (q.float() @ k.float().transpose(-1, -2))[0, 0, 0]
    p = torch.exp(s - s.max())
    want = (p.bfloat16().float() @ v[0, 0].float()) / p.sum()
    torch.testing.assert_close(out[0, 0, 0].float(), want.bfloat16().float(),
                               atol=0, rtol=0)
    # Column 0 of v is all ones: out = sum(bf16(p)) / sum(p), not exactly 1.
    assert float(lse) == pytest.approx(float(s.max() + p.sum().log()), abs=1e-6)
    unrounded, _ = FA.flash_attention_reference(q, k, v, 1.0, round_p=False)
    exact = (p @ v[0, 0].float()) / p.sum()
    torch.testing.assert_close(unrounded[0, 0, 0].float(),
                               exact.bfloat16().float(), atol=0, rtol=0)


def test_supported_is_the_jax_gate():
    """`supported` is the JAX `flash_supported`'s N >= 1024 without its TPU
    test and without the upstream TPU kernel's d >= 32, d % 8 == 0 (the
    CUDA kernels take any multiple of 8, and the dispatch pads the other
    head dims to one), plus the kernels' d <= 128."""
    assert FA.supported((8, 1, 19200, 64), (8, 1, 19200, 64))
    assert FA.supported((8, 5, 1200, 64), (8, 5, 1200, 64))
    assert FA.supported((1, 1, 1024, 32), (1, 1, 5, 32))
    assert not FA.supported((8, 8, 300, 64), (8, 8, 300, 64))   # N < 1024
    # segnext_b's stage 1-3 heads and segnext_tiny's / segnext_large's
    # padded ones.
    for d in (8, 16, 40, 4, 12, 20, 36):
        assert FA.supported((1, 8, 2048, d), (1, 8, 2048, d))
    assert not FA.supported((1, 1, 2048, 256), (1, 1, 2048, 256))


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        for name, mod, attr in (("flash", FA, "flash_attention"),
                                ("plain", FA, "flash_attention_plain"),
                                ("sr", S, "sr_attention"),
                                ("sdpa", A, "_sdpa")):
            monkeypatch.setattr(mod, attr, self._wrap(name, getattr(mod, attr)))

    def _wrap(self, name, fn):
        def spy(q, k, v, scale):
            self.calls.append(name)
            return fn(q, k, v, scale)
        return spy


@pytest.mark.parametrize("shape,kernels,want", [
    ((1, 1, 1200, 1200, 32), True, "flash"),    # long kv: K5
    ((1, 1, 1030, 1100, 64), True, "flash"),
    ((1, 8, 300, 300, 64), True, "sr"),         # mit_b2pp stage 4: K1/K2
    ((1, 1, 1200, 300, 64), True, "sr"),        # SR is tried first
    ((1, 1, 200, 1100, 16), True, "sdpa"),      # passes neither gate
    ((1, 8, 1200, 1200, 8), True, "flash"),     # SegNeXt's narrow heads
    ((1, 2, 1100, 1030, 4), True, "flash"),     # padded to d = 8
    ((1, 2, 1030, 1030, 20), True, "flash"),    # padded to d = 24
    ((1, 1, 1200, 1200, 32), False, "plain"),   # kernels off, long kv
    ((1, 2, 1100, 1030, 4), False, "plain"),
    ((1, 8, 300, 300, 64), False, "sdpa"),
])
def test_dispatch(monkeypatch, shape, kernels, want):
    """multi_head_attention sends each shape to one path, as the JAX
    dispatch does on its accelerator (short kv first, then long kv, else
    `_sdpa`); with kernels off the long-kv shapes take the chunked plain
    versions. The result is the `_sdpa` composition either way (fp32 1e-5)."""
    B, h, N, M, d = shape
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, h, N, M, d, seed=5))
    ref = A.multi_head_attention(q, k, v, d ** -0.5)
    spy = _Spy(monkeypatch)
    got = A.multi_head_attention(q, k, v, d ** -0.5, use_kernels=kernels)
    assert spy.calls == [want]
    assert got.shape == (B, N, h * d)
    if want != "sdpa":
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [4, 12, 20])
def test_padded_head_dim_is_exact(monkeypatch, d):
    """A head dim that is not a multiple of 8 reaches the kernel wrapper
    zero-padded to one, with the scale of the true d: the output and the
    gradients of q, k and v equal the unpadded `_sdpa` composition's (fp32,
    1e-5 of each tensor's largest), and the wrapper saw the padded d."""
    B, h, N, M = 1, 2, 1030, 1100
    arrays = _inputs(B, h, N, M, d, seed=7)
    seen = []
    real = FA.flash_attention

    def spy(q, k, v, scale):
        seen.append((q.shape[3], scale))
        return real(q, k, v, scale)

    monkeypatch.setattr(FA, "flash_attention", spy)
    results = []
    for kernels in (True, False):
        q, k, v, g = (torch.from_numpy(a).requires_grad_(i < 3)
                      for i, a in enumerate(arrays))
        out = (A.multi_head_attention(q, k, v, d ** -0.5, use_kernels=True)
               if kernels else A._sdpa(q, k, v, d ** -0.5).transpose(1, 2)
               .reshape(B, N, h * d))
        out.backward(g.transpose(1, 2).reshape(B, N, h * d))
        results.append([out.detach()] + [t.grad for t in (q, k, v)])
    assert seen == [(d + (-d % 8), d ** -0.5)]
    for got, want in zip(*results):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_kernel_route_never_falls_to_sdpa(monkeypatch):
    """Kernels on, a tensor that says it lies on the card: a long-kv shape
    reaches the kernel wrapper's launch (which raises here: the build needs
    nvcc, or the library has no such device) and never `_sdpa`, the plain
    versions or torch's own attention."""
    q = torch.zeros(1, 1, 1100, 32, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 1, 1200, 32, dtype=torch.bfloat16)

    def forbidden(*a, **kw):
        raise AssertionError("the kernel route fell back to a plain path")

    for mod, attr in ((A, "_sdpa"), (FA, "flash_attention_reference"),
                      (FA, "flash_attention_plain"),
                      (torch.nn.functional, "scaled_dot_product_attention")):
        monkeypatch.setattr(mod, attr, forbidden)
    reached = []

    def fake_kernel():
        reached.append(True)
        raise RuntimeError("no kernel here")

    monkeypatch.setattr(FA, "_kernel", fake_kernel)
    monkeypatch.setattr(FA, "_check_kernel_inputs", lambda *a: None)
    fake_cuda = torch.device("cuda", 0)
    real_forward = FA._forward

    class OnCard(torch.Tensor):
        """A CPU tensor whose `.device.type` reads "cuda"."""

        @property
        def device(self):
            return fake_cuda

    def as_card(t):
        return t.as_subclass(OnCard)

    with pytest.raises(RuntimeError, match="no kernel here"):
        A.multi_head_attention(as_card(q), as_card(k), as_card(v), 32 ** -0.5,
                               use_kernels=True)
    assert reached == [True] and FA._forward is real_forward


@pytest.mark.parametrize("through", ["flash_attention_bwd", "autograd"])
def test_backward_kernel_route_never_falls_back(monkeypatch, through):
    """A bf16 cotangent on a tensor that says it lies on the card, through
    `flash_attention_bwd` and through autograd: it reaches the backward
    kernels' launch (which raises here) and never the plain versions or
    torch's own attention."""
    q = torch.randn(1, 1, 1100, 32).bfloat16()
    k = v = torch.randn(1, 1, 1200, 32).bfloat16()

    def forbidden(*a, **kw):
        raise AssertionError("the backward kernel route fell back")

    for mod, attr in ((A, "_sdpa"), (FA, "flash_attention_reference"),
                      (FA, "flash_attention_bwd_reference"),
                      (FA, "flash_attention_plain"),
                      (torch.nn.functional, "scaled_dot_product_attention")):
        monkeypatch.setattr(mod, attr, forbidden)
    reached = []

    def fake_bwd_kernels():
        reached.append(True)
        raise RuntimeError("no backward kernel here")

    monkeypatch.setattr(FA, "_bwd_kernels", fake_bwd_kernels)
    monkeypatch.setattr(FA, "_check_kernel_inputs", lambda *a: None)
    fake_cuda = torch.device("cuda", 0)

    class OnCard(torch.Tensor):
        """A CPU tensor whose `.device.type` reads "cuda"."""

        @property
        def device(self):
            return fake_cuda

    def as_card(t):
        return t.as_subclass(OnCard)

    out = torch.zeros(1, 1, 1100, 32).bfloat16()
    lse = torch.zeros(1, 1, 1100)
    g = torch.randn(1, 1, 1100, 32).bfloat16()
    if through == "flash_attention_bwd":
        with pytest.raises(RuntimeError, match="no backward kernel here"):
            FA.flash_attention_bwd(*(as_card(t) for t in (q, k, v, out, lse,
                                                          g)), 32 ** -0.5)
    else:
        # The forward's kernel is faked too: it hands back the residual the
        # backward then sends to its kernels.
        monkeypatch.setattr(FA, "_forward",
                            lambda q, k, v, scale: (as_card(out), as_card(lse)))
        leaves = [as_card(t).requires_grad_() for t in (q, k, v)]
        res = FA.flash_attention(*leaves, 32 ** -0.5)
        with pytest.raises(RuntimeError, match="no backward kernel here"):
            torch.autograd.grad(res, leaves, as_card(g))
    assert reached == [True]


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 1, 64, 32)
    with pytest.raises(ValueError, match="4-D"):
        FA.flash_attention(q[0], q[0], q[0], 1.0)
    with pytest.raises(ValueError, match="shape mismatch"):
        FA.flash_attention(q, torch.zeros(1, 2, 64, 32),
                           torch.zeros(1, 2, 64, 32), 1.0)
    with pytest.raises(ValueError, match="mixed dtypes"):
        FA.flash_attention(q, q.bfloat16(), q, 1.0)
    out, lse = FA.flash_attention_reference(q, q, q, 1.0)
    with pytest.raises(ValueError, match="cotangent"):
        FA.flash_attention_bwd(q, q, q, out, lse, torch.zeros(1, 1, 63, 32),
                               1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        FA._check_kernel_inputs("flash_attention", q)


def test_no_grad_forward_skips_autograd():
    q = torch.zeros(1, 1, 64, 32, requires_grad=True)
    with torch.no_grad():
        assert FA.flash_attention(q, q, q, 1.0).grad_fn is None
    assert FA.flash_attention(q, q, q, 1.0).grad_fn is not None
    assert FA.flash_attention(q.detach(), q.detach(), q.detach(),
                              1.0).grad_fn is None


# ------------------------------------------------------------ on the card --


def _model_layout(B, h, N, M, d, dtype, device, seed):
    """q, k, v and the cotangent as ImprovedCrossAttention and autograd hand
    them over: head-split views of (B, N, h*d) and (B, M, 2, h, d)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, N, h * d, device=device, generator=g).to(dtype)
    kv = torch.randn(B, M, 2, h, d, device=device, generator=g).to(dtype)
    w = torch.randn(B, N, h * d, device=device, generator=g).to(dtype)
    k, v = (t.transpose(1, 2) for t in kv.unbind(2))
    return (x.reshape(B, N, h, d).transpose(1, 2), k, v,
            w.reshape(B, N, h, d).transpose(1, 2))


def _ulp(x):
    return 2.0 ** (torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _forward_against_plain(q, k, v, sc):
    """The forward kernel against the plain version, one launch. bf16: the
    running max rounds each p_j elsewhere than the row max (<= 2^-9 p_j
    each, noise of size 2^-9 R over a row, R = sqrt(sum_j p_j^2 v_j^2)) and
    the output's own rounding adds an ulp: every element within 2 bf16 ulps
    of itself + 4 * 2^-8 R, the tensor within 5e-3 relative L2. fp32: 1e-5.
    lse: 1e-5."""
    ref, lse_ref = FA.flash_attention_reference(q, k, v, sc)
    before = FA.flash_attention.launches
    got, lse = FA._forward(q, k, v, sc)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert got.transpose(1, 2).is_contiguous()
    err = (got.float() - ref.float()).abs()
    if q.dtype == torch.bfloat16:
        out2, lse2 = FA.flash_attention_reference(
            q.float(), k.float(), v.float().square(), 2 * sc)
        noise = (out2 * torch.exp(lse2 - 2 * lse_ref).unsqueeze(-1)).sqrt()
        tol = (2 * _ulp(torch.maximum(got.float().abs(), ref.float().abs()))
               + 4 * 2.0 ** -8 * noise)
        assert float((err / tol).max()) <= 1.0
        assert float(err.norm() / ref.float().norm()) <= 5e-3
    else:
        assert float(err.max()) <= 1e-5
    assert float((lse - lse_ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,h,N,M,d", CUDA_SHAPES)
def test_forward_kernel_matches_plain(cuda, B, h, N, M, d, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = _model_layout(B, h, N, M, d, dtype, cuda, 0)
    _forward_against_plain(q, k, v, d ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("B,h,N,M,d", [(1, 2, 200, 4100, 64),
                                       (1, 1, 130, 2100, 128)])
def test_forward_kernel_takes_any_scale(cuda, B, h, N, M, d, scale):
    """A negative or zero scale, ragged, with the split tail (the plain
    version and the JAX forward take any scale)."""
    q, k, v, _ = _model_layout(B, h, N, M, d, torch.bfloat16, cuda, 4)
    _forward_against_plain(q, k, v, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["q", "k", "v"])
@pytest.mark.parametrize("axis", ["batch", "head", "row", "overlapping rows"])
def test_forward_kernel_takes_broadcast_operands(cuda, operand, axis):
    """An operand expanded along one axis (stride 0), or with rows that
    overlap (a row stride below d), as the wrapper's checks let through."""
    B, h, N, M, d = 2, 2, 200, 300, 64
    ops = dict(zip("qkv", _model_layout(B, h, N, M, d, torch.bfloat16, cuda,
                                        5)[:3]))
    t = ops[operand]
    if axis == "overlapping rows":
        t = torch.randn(B * h * t.shape[2] * 8 + d, device=cuda).bfloat16()
        t = t.as_strided(ops[operand].shape, (h * 8 * ops[operand].shape[2],
                                              8 * ops[operand].shape[2], 8, 1))
    else:
        dim = ("batch", "head", "row").index(axis)
        t = t.narrow(dim, 0, 1).expand_as(t)
        assert t.stride(dim) == 0
    ops[operand] = t
    _forward_against_plain(ops["q"], ops["k"], ops["v"], d ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,h,N,M,d", CUDA_SHAPES)
def test_backward_kernels_match_plain(cuda, B, h, N, M, d, dtype):
    """Same residual into both. bf16: 2 bf16 ulps of each gradient's largest
    magnitude; fp32: 2e-5 of it. No atomics: two runs, the same bits. dq
    lands in the q projection's layout, dk and dv side by side."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, w = _model_layout(B, h, N, M, d, dtype, cuda, 1)
    sc = d ** -0.5
    out, lse = FA.flash_attention_reference(q, k, v, sc)
    ref = FA.flash_attention_bwd_reference(q, k, v, out, lse, w, sc)
    before = (FA.flash_attention_dkv.launches, FA.flash_attention_dq.launches)
    got = FA.flash_attention_bwd(q, k, v, out, lse, w, sc)
    again = FA.flash_attention_bwd(q, k, v, out, lse, w, sc)
    torch.cuda.synchronize()
    assert (FA.flash_attention_dkv.launches,
            FA.flash_attention_dq.launches) == (before[0] + 2, before[1] + 2)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, again):
        mag = b.float().abs().max()
        tol = (2 * float(_ulp(mag)) if dtype == torch.bfloat16
               else 2e-5 * max(1.0, float(mag)))
        assert float((a.float() - b.float()).abs().max()) <= tol, name
        assert torch.equal(a, c), name
    assert got[0].transpose(1, 2).is_contiguous()
    assert got[1].data_ptr() + h * d * got[1].element_size() == \
        got[2].data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,N,M,d", PADDED_CUDA_SHAPES)
def test_padded_route_on_the_card(cuda, B, h, N, M, d):
    """bf16 through multi_head_attention under autograd: the output and dq,
    dk, dv equal bit for bit the kernels' on the zero-padded operands, which
    are held to their plain version by the bounds of the two tests above
    (the padded columns of every result exactly 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, w = _model_layout(B, h, N, M, d, torch.bfloat16, cuda, 6)
    sc = d ** -0.5
    padded = [torch.nn.functional.pad(t, (0, -d % 8)) for t in (q, k, v, w)]
    _forward_against_plain(*padded[:3], sc)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = FA.flash_attention.launches
    out = A.multi_head_attention(*leaves, sc, use_kernels=True)
    assert FA.flash_attention.launches == before + 1
    out.backward(w.transpose(1, 2).reshape(B, N, h * d))
    kout, lse = FA._forward(*padded[:3], sc)
    grads = FA.flash_attention_bwd(*padded[:3], kout, lse, padded[3], sc)
    ref = FA.flash_attention_bwd_reference(*padded[:3], kout, lse, padded[3],
                                           sc)
    assert torch.equal(out, kout[..., :d].transpose(1, 2).reshape(
        B, N, h * d))
    assert not kout[..., d:].any()
    for name, leaf, a, b in zip(("dq", "dk", "dv"), leaves, grads, ref):
        assert torch.equal(leaf.grad, a[..., :d]), name
        assert not a[..., d:].any(), name
        tol = 2 * float(_ulp(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) <= tol, name


@pytest.mark.cuda
def test_backward_kernels_bit_equal_at_stage1(cuda):
    """The first mit_b2pp stage's bf16 backward, five runs: the same bits
    every run (no atomics; every sum in a fixed order)."""
    q, k, v, w = _model_layout(8, 1, 19200, 19200, 64, torch.bfloat16, cuda, 3)
    sc = 64 ** -0.5
    out, lse = FA._forward(q, k, v, sc)
    first = FA.flash_attention_bwd(q, k, v, out, lse, w, sc)
    for _ in range(4):
        again = FA.flash_attention_bwd(q, k, v, out, lse, w, sc)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_kernels_under_autograd_match_plain(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, w = _model_layout(2, 2, 1100, 1300, 32, torch.float32, cuda, 2)
    grads = []
    for fn in (FA.flash_attention, FA.flash_attention_plain):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, 32 ** -0.5), leaves, w))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 2e-5 * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_kernel_raises_on_what_it_cannot_take(cuda):
    q = torch.zeros(1, 1, 64, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        FA.flash_attention(q, q, q, 1.0)
    q = torch.zeros(1, 1, 64, 36, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        FA.flash_attention(q, q, q, 1.0)
    q = torch.zeros(1, 1, 64, 128, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous head dim"):
        FA.flash_attention(q, q, q, 1.0)
    q = torch.zeros(1, 1, 65, 36, device=cuda, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(q, q, q, 1.0)


# K5 on the spatial axis (`--mesh 2d:D,S`): a rank's N / S query rows of a
# mit_b2pp IFFM stage against the whole map's keys. (B, h, N, M, d) of the
# whole stage and S: the second stage at 2d:1,2 and 2d:1,4 (2,400 and
# 1,200 rows a rank against 4,800 keys).
SPATIAL_CUDA_CASES = [((8, 2, 4800, 4800, 64), 2), ((8, 2, 4800, 4800, 64), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, S", SPATIAL_CUDA_CASES)
def test_kernels_on_row_blocks(cuda, shape, S):
    """Each of S row blocks of q against the whole k, v, bf16: the forward
    by _forward_against_plain's bounds, dq and the block's partial dk, dv
    against the plain backward on the block by 2 bf16 ulps of each
    gradient's largest, two runs bit-equal; the S partial dk, dv summed in
    fp32 within 2 bf16 ulps of the whole call's largest (and 5e-3 relative
    L2) of the whole image's dk, dv."""
    B, h, N, M, d = shape
    q, k, v, w = _model_layout(B, h, N, M, d, torch.bfloat16, cuda, 7)
    sc = d ** -0.5
    out, lse = FA._forward(q, k, v, sc)
    _, dk_whole, dv_whole = FA.flash_attention_bwd(q, k, v, out, lse, w, sc)
    n = N // S
    sums = [0.0, 0.0]
    for s in range(S):
        qs, ws = q[:, :, s * n:(s + 1) * n], w[:, :, s * n:(s + 1) * n]
        _forward_against_plain(qs, k, v, sc)
        out_s, lse_s = FA._forward(qs, k, v, sc)
        got = FA.flash_attention_bwd(qs, k, v, out_s, lse_s, ws, sc)
        again = FA.flash_attention_bwd(qs, k, v, out_s, lse_s, ws, sc)
        ref = FA.flash_attention_bwd_reference(qs, k, v, out_s, lse_s, ws, sc)
        for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, again):
            tol = 2 * float(_ulp(b.float().abs().max()))
            assert float((a.float() - b.float()).abs().max()) <= tol, name
            assert torch.equal(a, c), name
        sums = [sums[0] + got[1].float(), sums[1] + got[2].float()]
    for name, got, want in zip(("dk", "dv"), sums, (dk_whole, dv_whole)):
        want = want.float()
        tol = 2 * float(_ulp(want.abs().max()))
        assert float((got - want).abs().max()) <= tol, name
        assert float((got - want).norm() / want.norm()) <= 5e-3, name
