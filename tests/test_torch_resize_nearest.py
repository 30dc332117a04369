"""The port's `ops/resize.resize_nearest` against the JAX `resize_nearest`
(jax.image.resize, method "nearest") on the CPU: bit for bit, on label maps
(B, H, W) and with trailing dims, in uint8, int32 and float32, up- and
down-scaling, at fixed size pairs (among them ones where
F.interpolate(mode="nearest") disagrees with JAX) and at seeded random
sizes; the input itself back when the size is equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu.ops.resize import (
    resize_nearest as jax_resize_nearest)
from rgbx_semantic_segmentation_tpu_torch.ops.resize import (
    nearest_indices, resize_nearest)

# (in (H, W), out (h, w)): odd ratios both ways, the half-size eval map and
# mixed up/down per axis.
PAIRS = [((7, 9), (3, 4)), ((5, 5), (12, 13)), ((480, 640), (240, 320)),
         ((10, 10), (15, 6)), ((3, 7), (7, 3))]
DTYPES = [np.uint8, np.int32, np.float32]


def _labels(rng, shape, dtype):
    if dtype == np.float32:
        return rng.randn(*shape).astype(np.float32)
    return rng.randint(0, 256 if dtype == np.uint8 else 1 << 20,
                       shape).astype(dtype)


def _hold(x, size):
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), size))
    got = resize_nearest(torch.from_numpy(x), size).numpy()
    assert got.dtype == want.dtype == x.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("pair", PAIRS, ids=str)
def test_resize_nearest_matches_jax(pair, dtype):
    (H, W), size = pair
    rng = np.random.RandomState(H * 1000 + W)
    _hold(_labels(rng, (2, H, W), dtype), size)
    _hold(_labels(rng, (1, H, W, 3), dtype), size)


@pytest.mark.parametrize("seed", range(4))
def test_resize_nearest_random_sizes_match_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(6):
        H, W, h, w = (int(n) for n in rng.randint(1, 700, 4))
        dtype = DTYPES[int(rng.randint(len(DTYPES)))]
        _hold(_labels(rng, (1, H, W), dtype), (h, w))


def test_resize_nearest_equal_size_is_identity():
    x = torch.arange(24, dtype=torch.uint8).reshape(2, 3, 4)
    assert resize_nearest(x, (3, 4)) is x


def test_nearest_indices_match_jax():
    """The source indices alone: an index map in, its gather out, at 30
    seeded size pairs up to 3000 and at pairs where (i + 0.5) * n_in /
    n_out, divided as written, lands one index off JAX's."""
    rng = np.random.RandomState(11)
    pairs = [tuple(int(n) for n in rng.randint(1, 3000, 2))
             for _ in range(30)]
    pairs += [(2, 97), (12, 681), (34, 31), (54, 193), (480, 1280)]
    for n_in, n_out in pairs:
        x = jnp.arange(n_in, dtype=jnp.int32)[None, None]
        want = np.asarray(jax_resize_nearest(x, (1, n_out)))[0, 0]
        np.testing.assert_array_equal(nearest_indices(n_in, n_out), want,
                                      err_msg=f"{n_in} -> {n_out}")
