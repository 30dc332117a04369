"""The port's short-kv SR-attention (rgbx_semantic_segmentation_tpu_torch/
ops/sr_attention.py), forward and backward, against the JAX Pallas kernels,
and its CUDA kernels against their plain versions.

On the CPU the wrappers take the plain versions: here they are held against
the JAX kernels run in Pallas interpret mode, in bf16, at the shapes of
tests/test_sr_attention.py (M = 1, and N, M not multiples of 8). Forward:
atol 2e-3 as in that test: both sides round the probs and the output to
bf16, and fp32 summation order can move a bf16 rounding by one ulp.
Gradients: atol 5e-2, rtol 2e-2 as in that test (bf16 gradients of
magnitude up to ~10; a flipped rounding of dl or p moves a sum by about one
bf16 ulp of it).

The `cuda` tests need the card and skip without one; they import no jax,
so on the GPU machine they run with
`python -m pytest --noconftest -m cuda tests/test_torch_sr_attention.py`.
"""
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S

torch.set_num_threads(2)

SHAPES = [
    (2, 1, 480, 300, 64),   # stage-1-like: big N, h=1
    (2, 2, 300, 300, 64),   # N == M
    (1, 5, 96, 24, 32),     # d=32, h=5
    (2, 1, 8, 1, 64),       # M=1
    (1, 8, 75, 19, 64),     # N and M both non-multiples of 8
    (1, 3, 75, 19, 96),     # d=96 (segnext_large stage 4): two d panels
]
# (B, h, N, M, d) of the stage-4 IFFM attentions of segnext_tiny (d = 32)
# and segnext_large (d = 96) at 480x640, batch 8.
SEGNEXT_STAGE4 = [(8, 8, 300, 300, 32), (8, 8, 300, 300, 96)]
# (B*h, N, M, d) of the four mit_b2 stages at 480x640, batch 8.
FLAGSHIP = [(8, 19200, 300, 64), (16, 4800, 300, 64), (40, 1200, 300, 64),
            (64, 300, 300, 64)]


def _mk(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_forward_matches_jax_kernel(B, h, N, M, d):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from rgbx_semantic_segmentation_tpu.ops import sr_attention as JS

    q, k, v = (_mk((B, h, n, d), s) for n, s in ((N, 0), (M, 1), (M, 2)))
    scale = d ** -0.5
    bf = jnp.bfloat16
    ref = JS.sr_attention(jnp.asarray(q, bf), jnp.asarray(k, bf),
                          jnp.asarray(v, bf), scale, interpret=True)
    ref = np.asarray(jax.device_get(ref).astype(np.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    before = S.sr_attention.launches
    got = S.sr_attention(tq, tk, tv, scale)
    assert S.sr_attention.launches == before  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (B, h, N, d)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-3, rtol=0)


@pytest.mark.parametrize("q_shape,k_shape", [
    ((8, 1, 19200, 64), (8, 1, 300, 64)),
    ((8, 8, 300, 128), (8, 8, 300, 128)),
    ((8, 1, 4096, 64), (8, 1, 4096, 64)),
    ((8, 1, 1024, 256), (8, 1, 300, 256)),
    ((1, 1, 64, 64), (1, 1, 1024, 64)),
    ((1, 1, 64, 64), (1, 1, 1025, 64)),
])
def test_supported_matches_jax(q_shape, k_shape):
    pytest.importorskip("jax")
    from rgbx_semantic_segmentation_tpu.ops import sr_attention as JS

    assert S.supported(q_shape, k_shape) == JS.supported(q_shape, k_shape)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        S.sr_attention(q, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8), 1.0)
    with pytest.raises(ValueError, match="mixed dtypes"):
        S.sr_attention(q, torch.zeros(1, 2, 4, 16).bfloat16(),
                       torch.zeros(1, 2, 4, 16).bfloat16(), 1.0)
    with pytest.raises(ValueError, match="4-D"):
        S.sr_attention(q[0], q[0], q[0], 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, None),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("G,N,M,d", FLAGSHIP[1:] + [
    (B * h, N, M, d) for B, h, N, M, d in SHAPES + SEGNEXT_STAGE4] + [
    (4, 333, 1000, 128)])
def test_kernel_matches_plain(cuda, G, N, M, d, dtype, atol):
    """The kernel against its plain version on the card. bf16: two ulps at
    the output's magnitude (fp32 summation order may flip one rounding of a
    prob and one of the output); fp32 (TF32 off): 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, G, n, d, device=cuda, generator=g).to(dtype)
               for n in (N, M, M))
    ref = S.sr_attention_reference(q, k, v, d ** -0.5)
    before = S.sr_attention.launches
    got = S.sr_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert S.sr_attention.launches == before + 1
    if atol is None:
        mag = ref.float().abs().max().item()
        atol = 2 * 2.0 ** (np.floor(np.log2(mag)) - 7)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= atol, (err, atol)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_cannot_take(cuda):
    q = torch.zeros(1, 1, 64, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        S.sr_attention(q, q, q, 1.0)
    k = torch.zeros(1, 1, 2048, 64, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        S.sr_attention(q.float(), k, k, 1.0)
    with pytest.raises(ValueError, match="contiguous head dim"):
        qs = torch.zeros(1, 2, 64, 128, device=cuda)[..., ::2]
        assert qs.stride(3) == 2
        S.sr_attention(qs, qs, qs, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,h,N,M,d", [(2, 2, 4800, 300, 64),
                                       (1, 5, 96, 24, 32)])
def test_kernel_takes_head_split_views(cuda, B, h, N, M, d, dtype):
    """The views the model passes (q from (B, N, h*d) tokens, k and v from
    the (B, M, 2, h*d) kv projection) go in without a copy, and the output
    merges back to (B, N, h*d) as a view; same bits as contiguous inputs."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(B, N, h * d, device=cuda, generator=g).to(dtype)
    kv = torch.randn(B, M, 2 * h * d, device=cuda, generator=g).to(dtype)
    q = x.reshape(B, N, h, d).transpose(1, 2)
    kv = kv.reshape(B, M, 2, h, d)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = S.sr_attention(q, k, v, d ** -0.5)
    want = S.sr_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    merged = got.transpose(1, 2).reshape(B, N, h * d)
    assert merged.data_ptr() == got.data_ptr() and merged.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,M,d", [FLAGSHIP[1], (8, 75, 19, 64),
                                     (4, 333, 1000, 128)])
def test_kernel_rounds_probs_before_pv(cuda, G, N, M, d):
    """bf16: p is rounded to bf16 after normalising and before p @ v. The
    kernel differs from the plain version in <= 1% of its outputs (fp32
    summation order; ~0.1% measured), while a kernel that kept p in fp32
    would differ in ~40% of them: the 2-ulp max-abs bound cannot see that."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(1, G, n, d, device=cuda, generator=g).bfloat16()
               for n in (N, M, M))
    sc = d ** -0.5
    got = S.sr_attention(q, k, v, sc)
    ref = S.sr_attention_reference(q, k, v, sc)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sc
    unrounded = torch.matmul(torch.softmax(logits, -1), v.float()).bfloat16()
    right = (got != ref).float().mean().item()
    wrong = (got != unrounded).float().mean().item()
    assert right <= 0.01 and right < wrong, (right, wrong)


# ------------------------------------------------------------ backward ----


def _grad_inputs(B, h, N, M, d):
    return (_mk((B, h, N, d), 3), _mk((B, h, M, d), 4), _mk((B, h, M, d), 5),
            _mk((B, h, N, d), 6))  # non-uniform cotangent


def _torch_grads(fn, q, k, v, w, dtype):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = fn(tq, tk, tv)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad for t in (tq, tk, tv)]


def _jax_grads(fn, q, k, v, w, dtype):
    import jax
    import jax.numpy as jnp

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    got = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(jax.device_get(a).astype(np.float32)) for a in got]


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_gradients_match_jax_kernel(B, h, N, M, d):
    """Port sr_attention on the CPU (forward and backward through their
    plain versions) against jax.grad of the JAX kernel, interpret mode."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from rgbx_semantic_segmentation_tpu.ops import sr_attention as JS

    q, k, v, w = _grad_inputs(B, h, N, M, d)
    scale = d ** -0.5
    ref = _jax_grads(
        lambda q, k, v: JS.sr_attention(q, k, v, scale, interpret=True),
        q, k, v, w, jnp.bfloat16)
    before = S.sr_attention_bwd.launches
    got = _torch_grads(lambda q, k, v: S.sr_attention(q, k, v, scale),
                       q, k, v, w, torch.bfloat16)
    assert S.sr_attention_bwd.launches == before  # CPU: the plain version
    for name, a, b in zip("qkv", got, ref):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b, atol=5e-2, rtol=2e-2,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_sdpa_backward_matches_jax(B, h, N, M, d):
    """The plain `_sdpa` (rounded probs in the softmax backward) against
    jax.grad of the JAX `_sdpa`, bf16, same tolerances."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from rgbx_semantic_segmentation_tpu.ops.attention import _sdpa as jsdpa
    from rgbx_semantic_segmentation_tpu_torch.ops.attention import _sdpa

    q, k, v, w = _grad_inputs(B, h, N, M, d)
    scale = d ** -0.5
    ref = _jax_grads(lambda q, k, v: jsdpa(q, k, v, scale), q, k, v, w,
                     jnp.bfloat16)
    got = _torch_grads(lambda q, k, v: _sdpa(q, k, v, scale), q, k, v, w,
                       torch.bfloat16)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.float().numpy(), b, atol=5e-2, rtol=2e-2,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_plain_backwards_agree_in_fp32(B, h, N, M, d):
    """In fp32 no rounding point separates the kernel's backward from
    `_sdpa`'s, and both are the autograd gradient of the naive composition:
    1e-5 (fp32 summation order at gradients of magnitude ~1)."""
    from rgbx_semantic_segmentation_tpu_torch.ops.attention import _sdpa

    q, k, v, w = _grad_inputs(B, h, N, M, d)
    scale = d ** -0.5

    def naive(q, k, v):
        return torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v

    a = _torch_grads(lambda q, k, v: S.sr_attention(q, k, v, scale),
                     q, k, v, w, torch.float32)
    b = _torch_grads(lambda q, k, v: _sdpa(q, k, v, scale), q, k, v, w,
                     torch.float32)
    c = _torch_grads(naive, q, k, v, w, torch.float32)
    for name, x, y, z in zip("qkv", a, b, c):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(x.numpy(), z.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"d{name} vs autograd")


def test_no_grad_forward_skips_autograd():
    q = torch.randn(1, 1, 8, 16)
    with torch.no_grad():
        assert S.sr_attention(q, q, q, 0.25).grad_fn is None
    assert S.sr_attention(q, q, q, 0.25).grad_fn is None  # nothing to train
    out = S.sr_attention(q.requires_grad_(), q, q, 0.25)
    assert out.grad_fn is not None


def test_backward_wrapper_rejects_bad_cotangent():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="cotangent"):
        S.sr_attention_bwd(q, q, q, torch.zeros(1, 2, 4, 16), 1.0)


def _model_layout(B, h, N, M, d, dtype, device, seed):
    """q, k, v as the model hands them over (head-split views) and the
    cotangent as autograd hands it back: a view of a (B, N, h*d) tensor."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, N, h * d, device=device, generator=g).to(dtype)
    kv = torch.randn(B, M, 2, h, d, device=device, generator=g).to(dtype)
    w = torch.randn(B, N, h * d, device=device, generator=g).to(dtype)
    return (x.reshape(B, N, h, d).transpose(1, 2), kv[:, :, 0].transpose(1, 2),
            kv[:, :, 1].transpose(1, 2), w.reshape(B, N, h, d).transpose(1, 2))


def _bf16_ulps(ref, ulps):
    mag = ref.float().abs().max().item()
    return ulps * 2.0 ** (np.floor(np.log2(mag)) - 7) if mag > 0 else 0.0


BWD_SHAPES = [(8, 2, 4800, 300, 64), (8, 5, 1200, 300, 64),
              (8, 8, 300, 300, 64)] + SEGNEXT_STAGE4 + SHAPES + [
                  (1, 4, 333, 1000, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,h,N,M,d", BWD_SHAPES)
def test_backward_kernel_matches_plain(cuda, B, h, N, M, d, dtype):
    """The backward kernel against its plain version on the card, on the
    model's layouts. fp32 (TF32 off): 2e-5 of the gradient's magnitude
    (summation order only). bf16: 4 bf16 ulps of the gradient's largest
    magnitude: a gradient element is a sum over up to N (dk, dv) or M (dq)
    products whose bf16 factors p and dl may each round the other way."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, w = _model_layout(B, h, N, M, d, dtype, cuda, 0)
    ref = S.sr_attention_bwd_reference(q, k, v, w, d ** -0.5)
    before = S.sr_attention_bwd.launches
    got = S.sr_attention_bwd(q, k, v, w, d ** -0.5)
    torch.cuda.synchronize()
    assert S.sr_attention_bwd.launches == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        tol = (_bf16_ulps(b, 4) if dtype == torch.bfloat16
               else 2e-5 * max(1.0, b.abs().max().item()))
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,N,M,d", [(2, 2, 300, 300, 64),
                                       (1, 5, 96, 24, 32), (1, 8, 75, 19, 64)])
def test_backward_kernel_matches_autograd_fp32(cuda, B, h, N, M, d):
    """fp32 on the card: gradients through the kernels against autograd of
    the naive composition, 2e-5 of the gradient's magnitude."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, w = (t.detach().clone().requires_grad_() for t in _model_layout(
        B, h, N, M, d, torch.float32, cuda, 1))
    scale = d ** -0.5
    (S.sr_attention(q, k, v, scale) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v * w).sum().backward()
    for name, a, t in zip("qkv", got, (q, k, v)):
        tol = 2e-5 * max(1.0, t.grad.abs().max().item())
        assert (a - t.grad).abs().max().item() <= tol, name


@pytest.mark.cuda
def test_backward_lands_in_projection_layouts(cuda):
    """dq is a view of a (B, N, h, d) buffer and dk, dv are the halves of one
    (B, M, 2, h, d) buffer, so the gradients of the q and kv projections'
    outputs need no copy; the counters count one launch each."""
    B, h, N, M, d = 2, 2, 300, 75, 64
    q, k, v, w = _model_layout(B, h, N, M, d, torch.bfloat16, cuda, 2)
    dq, dk, dv = S.sr_attention_bwd(q, k, v, w, d ** -0.5)
    torch.cuda.synchronize()
    assert dq.transpose(1, 2).is_contiguous()
    assert dk.transpose(1, 2).stride() == (M * 2 * h * d, 2 * h * d, d, 1)
    assert dv.data_ptr() == dk.data_ptr() + h * d * dk.element_size()
    again = S.sr_attention_bwd(q, k, v, w, d ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip((dq, dk, dv), again):
        assert torch.equal(a, b)  # no atomics: the same bits every run


@pytest.mark.cuda
def test_backward_raises_before_the_backward(cuda):
    """What the backward kernel cannot take is refused by the forward."""
    q = torch.zeros(1, 1, 64, 64, device=cuda, dtype=torch.float16,
                    requires_grad=True)
    with pytest.raises(TypeError):
        S.sr_attention(q, q, q, 1.0)
    k = torch.zeros(1, 1, 2048, 64, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="does not take"):
        S.sr_attention(q.float(), k, k, 1.0)
    with pytest.raises(ValueError, match="does not take"):
        S.sr_attention_bwd(q.float(), k, k, q.float(), 1.0)


# ------------------------------------- tensor-core route and residual ----


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_plain_lse_matches_jax_logits(B, h, N, M, d):
    """The forward's saved statistic: the plain version's base-2 logsumexp
    of each q row against logsumexp of the JAX side's fp32 logits, times
    log2(e); fp32, 1e-5 (summation order)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    q, k, v = (_mk((B, h, n, d), s) for n, s in ((N, 0), (M, 1), (M, 2)))
    scale = d ** -0.5
    logits = jnp.einsum("bhnd,bhmd->bhnm", jnp.asarray(q), jnp.asarray(k),
                        precision=jax.lax.Precision.HIGHEST) * scale
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1)) * S.LOG2E
    out, lse = S.sr_attention_reference(*(torch.from_numpy(a) for a in
                                          (q, k, v)), scale, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, h, N)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-6)
    assert torch.equal(out, S.sr_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), scale))


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_residual_backward_matches_jax_kernel(B, h, N, M, d):
    """The plain backward from the residual (q, k, v, lse2), the CPU
    counterpart of the tensor-core backward, against jax.grad of the JAX
    kernel (interpret mode), bf16, at the tolerances of
    test_gradients_match_jax_kernel; the autograd path saves that residual."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from rgbx_semantic_segmentation_tpu.ops import sr_attention as JS

    q, k, v, w = _grad_inputs(B, h, N, M, d)
    scale = d ** -0.5
    ref = _jax_grads(
        lambda q, k, v: JS.sr_attention(q, k, v, scale, interpret=True),
        q, k, v, w, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    g = torch.from_numpy(w).bfloat16()
    _, lse = S.sr_attention_reference(tq, tk, tv, scale, return_lse=True)
    got = S.sr_attention_bwd(tq, tk, tv, g, scale, lse=lse)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.float().numpy(), b, atol=5e-2, rtol=2e-2,
                                   err_msg=f"d{name}")
    tq.requires_grad_()
    out = S.sr_attention(tq, tk, tv, scale)
    saved = [t for t in out.grad_fn.saved_tensors if t.dim() == 3]
    assert len(saved) == 1 and torch.equal(saved[0], lse)


@pytest.mark.parametrize("B,h,N,M,d", SHAPES)
def test_residual_backward_matches_plain_fp32(B, h, N, M, d):
    """fp32: the residual backward and the yardstick differ only in the
    summation order of pf and delta: 1e-5 of the gradient's magnitude."""
    q, k, v, w = (torch.from_numpy(a) for a in _grad_inputs(B, h, N, M, d))
    scale = d ** -0.5
    _, lse = S.sr_attention_reference(q, k, v, scale, return_lse=True)
    a = S.sr_attention_bwd(q, k, v, w, scale, lse=lse)
    b = S.sr_attention_bwd_reference(q, k, v, w, scale)
    for name, x, y in zip("qkv", a, b):
        tol = 1e-5 * max(1.0, y.abs().max().item())
        assert (x - y).abs().max().item() <= tol, name


def test_route_on_cpu_tensors():
    """The route depends on dtype, head dim and alignment only; here it is
    only read (the CPU takes the plain versions whatever it says)."""
    x = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    assert S.route(x, x, x) == "tensor_cores"
    assert S.route(x.float(), x.float(), x.float()) == "scalar"
    y = torch.zeros(1, 2, 64, 40, dtype=torch.bfloat16)[..., :36]
    assert S.route(y, y, y) == "scalar"  # head dim 36, row stride 40
    z = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16)[1:].view(
        1, 2, 64, 64)
    assert S.route(z, x, x) == "scalar"  # 2 bytes off a 16-byte boundary


def _check_tc(q, k, v, w, scale, fwd_ulps=2, bwd_ulps=4):
    """Forward and backward of the tensor-core route against the plain
    versions at the bounds of chip_smoke.py: forward 2 bf16 ulps of the
    output and <= 1% of outputs differing (fewer than from the unrounded-p
    version), lse 1e-5; backward 4 bf16 ulps of each gradient's largest."""
    assert S.route(q, k, v) == "tensor_cores"
    ref, ref_lse = S.sr_attention_reference(q, k, v, scale, return_lse=True)
    got, lse = S._forward(q, k, v, scale, with_lse=True)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref, fwd_ulps), ("out", err)
    assert (lse - ref_lse).abs().max().item() <= 1e-5 * max(
        1.0, ref_lse.abs().max().item())
    if k.shape[2] > 1:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        unrounded = torch.matmul(torch.softmax(logits, -1),
                                 v.float()).bfloat16()
        right = (got != ref).float().mean().item()
        wrong = (got != unrounded).float().mean().item()
        assert right <= 0.01 and right < wrong, (right, wrong)
    dref = S.sr_attention_bwd_reference(q, k, v, w, scale)
    dgot = S.sr_attention_bwd(q, k, v, w, scale, lse=lse)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), dgot, dref):
        assert torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= _bf16_ulps(b, bwd_ulps), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 15, 16, 17, 300, 304, 320, 321, 880, 1024])
def test_tensor_cores_across_kv_lengths(cuda, M):
    """Both sides of the one-pass / two-pass split (M = 320) and the ragged
    edges of the 64-wide kv tiles, on the model's layouts."""
    B, h, N, d = 1, 2, 200, 64
    q, k, v, w = _model_layout(B, h, N, M, d, torch.bfloat16, cuda, 3)
    assert S._kernel().sr_attention_fwd_tc_passes(M, d) == (
        1 if M <= 320 else 2)
    _check_tc(q, k, v, w, d ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 7, 63, 65, 130])
def test_tensor_cores_short_and_ragged_q(cuda, N):
    q, k, v, w = _model_layout(2, 2, N, 300, 64, torch.bfloat16, cuda, 4)
    _check_tc(q, k, v, w, 64 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [300, 880])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_tensor_cores_head_dims(cuda, d, M):
    q, k, v, w = _model_layout(1, 3, 333, M, d, torch.bfloat16, cuda, 5)
    _check_tc(q, k, v, w, d ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,N,M,d", [(2, 2, 4800, 300, 64),
                                       (1, 5, 96, 24, 32), (2, 1, 700, 880, 64)])
def test_backward_takes_head_split_views(cuda, B, h, N, M, d):
    """The model's views into the backward give the same bits as contiguous
    copies of them."""
    q, k, v, w = _model_layout(B, h, N, M, d, torch.bfloat16, cuda, 6)
    lse = S._forward(q, k, v, d ** -0.5, with_lse=True)[1]
    got = S.sr_attention_bwd(q, k, v, w, d ** -0.5, lse=lse)
    want = S.sr_attention_bwd(*(t.contiguous() for t in (q, k, v, w)),
                              d ** -0.5, lse=lse)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_unaligned_views_take_the_scalar_route(cuda):
    """A bf16 view whose rows are not 16-byte aligned goes to the scalar
    kernels by the wrapper's rule (no quiet switch inside a kernel), and
    they hold the plain versions' bounds."""
    B, h, N, M, d = 1, 2, 100, 75, 64
    gen = torch.Generator(device=cuda).manual_seed(7)
    flat = torch.randn(B * h * N * d + 1, device=cuda,
                       generator=gen).bfloat16()
    q = flat[1:].view(B, h, N, d)  # 2 bytes off a 16-byte boundary
    k = torch.randn(B, h, M, 68, device=cuda, generator=gen).bfloat16()[
        ..., :d]  # row stride 68: rows 8 bytes apart from 16-byte multiples
    v = torch.randn(B, h, M, d, device=cuda, generator=gen).bfloat16()
    w = torch.randn(B, h, N, d, device=cuda, generator=gen).bfloat16()
    assert S.route(q, k, v) == "scalar"
    got = S.sr_attention(q, k, v, d ** -0.5)
    ref = S.sr_attention_reference(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= _bf16_ulps(ref, 2)
    dgot = S.sr_attention_bwd(q, k, v, w, d ** -0.5)
    dref = S.sr_attention_bwd_reference(q, k, v, w, d ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(dgot, dref):
        assert (a.float() - b.float()).abs().max().item() <= _bf16_ulps(b, 4)


@pytest.mark.cuda
def test_backward_bit_equal_at_stage_one(cuda):
    """No atomics: two runs of the backward at the first mit_b2 stage's
    shape give the same bits (the cluster sums partials in a fixed order)."""
    B, h, N, M, d = 8, 1, 19200, 300, 64
    q, k, v, w = _model_layout(B, h, N, M, d, torch.bfloat16, cuda, 8)
    lse = S._forward(q, k, v, d ** -0.5, with_lse=True)[1]
    a = S.sr_attention_bwd(q, k, v, w, d ** -0.5, lse=lse)
    b = S.sr_attention_bwd(q, k, v, w, d ** -0.5, lse=lse)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [64, 300])
def test_one_and_two_passes_agree(cuda, M):
    """Where one pass fits, the two-pass kernel computes the same function:
    both within the plain version's bounds, and within 2 ulps of each
    other."""
    q, k, v, _ = _model_layout(2, 2, 500, M, 64, torch.bfloat16, cuda, 9)
    one = S._forward(q, k, v, 0.125, passes=1)
    two = S._forward(q, k, v, 0.125, passes=2)
    ref = S.sr_attention_reference(q, k, v, 0.125)
    torch.cuda.synchronize()
    for got in (one, two):
        assert (got.float() - ref.float()).abs().max().item() <= _bf16_ulps(
            ref, 2)
    assert (one.float() - two.float()).abs().max().item() <= _bf16_ulps(
        ref, 2)
