"""The port's short-kv SR-attention (rgbx_semantic_segmentation_tpu_torch/
ops/sr_attention.py) against the JAX Pallas kernel, and its CUDA kernel
against its plain version.

On the CPU the wrapper takes the plain version: here it is held against the
JAX kernel run in Pallas interpret mode, in bf16, at the shapes of
tests/test_sr_attention.py (M = 1, and N, M not multiples of 8). atol 2e-3
as in that test: both sides round the probs and the output to bf16, and
fp32 summation order can move a bf16 rounding by one ulp.

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
]
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
    (B * h, N, M, d) for B, h, N, M, d in SHAPES] + [(4, 333, 1000, 128)])
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
