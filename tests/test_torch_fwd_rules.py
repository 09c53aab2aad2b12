"""Host-side rules of K1's Hopper forward (``csrc/spatial_attention.cu``:
K1f, K1sp, K1p), held at every shape its kernel takes, and the rounding
point of the MViT forward's plain versions (K5f / K6f / K6sp) against the
JAX package.

K1's ring rule is written out in the wrapper
(``spatial_attention.fwd_geometry`` and ``ring_depth``);
``tests/test_torch_kernels_cuda.py`` holds it against
the built library on the card.  The bf16 plain MViT forward (which rounds
e = exp(min(s, 80)) to bf16 before P V, as the one-sweep kernel does, where
the TPU kernel rounds p = e / l; ``mvit_attention.rounds_e``) is held
against JAX's ``flash_attention_mvit`` / ``flash_attention_mvit_hl`` in bf16
(Pallas in interpret mode) to atol 2e-3, rtol 2e-2: both round each
probability term to bf16 once, in other places, and round the output to
bf16 (a bf16 ulp is 2^-8 of a value; outputs here reach ~1); float32 is
unchanged (``test_torch_mvit_attention`` holds it to 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops.pallas_mvit_attention import (
    flash_attention_mvit, flash_attention_mvit_hl,
)
from procedurevrl_torch.ops import mvit_attention as k5
from procedurevrl_torch.ops import spatial_attention as k1

# every frame K1's own kernels take: N = 1 .. 207 patches (+ CLS)
K1_FRAMES = range(1, k1.MAX_LEN)


@pytest.mark.parametrize("save_probs", [False, True])
@pytest.mark.parametrize("nbuf", [1, 2, 3, 8, 9])
def test_k1_ring_fits_and_is_the_deepest_that_does(save_probs, nbuf):
    for n in K1_FRAMES:
        lp, wgs, stage, extra = k1.fwd_geometry(n, save_probs)
        depth = k1.ring_depth(n, nbuf, save_probs)
        want = min(nbuf, k1.MAX_DEPTH)
        assert 1 <= depth <= want, n
        assert depth * stage + extra <= k1.MAX_SMEM, n
        assert depth == want or (depth + 1) * stage + extra > k1.MAX_SMEM, n


@pytest.mark.parametrize("save_probs", [False, True])
def test_k1_tiles_cover_the_frame_within_the_stage(save_probs):
    for n in K1_FRAMES:
        L = n + 1
        lp, wgs, stage, extra = k1.fwd_geometry(n, save_probs)
        assert L <= lp and stage == 3 * lp * k1.HEAD_DIM * 2
        tiles = 1 if lp == 64 else 4  # 64-row query tiles
        assert tiles * 64 >= lp >= L and tiles % wgs == 0
        # the last tile's rows past LP read the stage's k rows, never past it
        assert tiles * 64 <= 3 * lp
        # a staging tile holds 64 rows of LS columns
        ls = k1.probs_stride(L)
        assert L <= ls <= lp
        staged = wgs * 64 * lp * 2 if save_probs else 0
        assert extra == staged + 2 * k1.MAX_DEPTH * 8


def test_k1_ring_takes_no_frame_past_its_kernels():
    assert k1.ring_depth(k1.MAX_LEN, 3) == 0
    assert k1.ring_depth(0, 3) == 0
    # the TimeSformer-B frame: K1f / K1sp two stages, K1p's default request
    # of 3 clamped to 2; short frames up to MAX_DEPTH
    assert k1.ring_depth(196, k1.FWD_DEPTH) == 2
    assert k1.ring_depth(196, k1.FWD_DEPTH, True) == 2
    assert k1.ring_depth(196, 3) == 2
    assert k1.ring_depth(48, 9) == k1.MAX_DEPTH


def test_mvit_rounding_point_follows_the_kernel():
    for d in range(1, 257):
        assert k5.rounds_e(torch.bfloat16, d) == k5.on_tensor_cores(d)
        assert not k5.rounds_e(torch.float32, d)


def _mvit_inputs(seed, b, h, qn, k_shape, d=96, hot=True):
    rng = np.random.RandomState(seed)
    kn, kcat, c = int(np.prod(k_shape)), sum(k_shape), h * d
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    x = [mk(b, qn, c), mk(b, kn, c), mk(b, kn, c), mk(b, 1, c), mk(b, 1, c),
         mk(b, qn, h * kcat)]
    if hot:
        x[0][0, 5] = x[1][0, 3] * 40.0  # q.k * scale well above 80
    return [a.astype(jnp.bfloat16) for a in x]


BF16_JAX_TOL = dict(atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("head_last", [True, False])
@pytest.mark.parametrize("hot", [False, True])
def test_bf16_plain_forward_stays_near_jax(head_last, hot):
    k_shape, h, scale = (2, 3, 4), 2, 96 ** -0.5
    x = _mvit_inputs(3, 2, h, 70, k_shape, hot=hot)
    t = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in x]
    if head_last:
        ref = flash_attention_mvit_hl(*x, k_shape, h, scale)
        out, _ = k5.mvit_attention_hl_fwd_plain(*t, k_shape, h, scale)
    else:
        t = [k5._split(a, h) for a in t]
        xs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in t]
        ref = flash_attention_mvit(*xs, k_shape, scale)
        out, _ = k5.mvit_attention_fwd_plain(*t, k_shape, scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_JAX_TOL)
