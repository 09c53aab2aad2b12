"""The PyTorch port's TimeSformer against the JAX package's.

JAX side: ``TimeSformer(use_pallas=True)`` in fp32, with both attention
kernels in interpret mode (``PALLAS_MIN_LEN=1`` engages the spatial kernel
at these tiny patch grids).  Its parameter tree, filled from a numpy seed
(non-zero biases, non-unit LayerNorm scales), moves to the port through
``params_from_jax``.  Depth 2, width 128, 2 heads of 64.
Tolerance: fp32, atol = rtol = 2e-5 (the repository's parity tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.models.timesformer import TimeSformer as JaxTimeSformer
from procedurevrl_torch.models.timesformer import TimeSformer
from procedurevrl_torch.utils.weights import params_from_jax

TOL = dict(atol=2e-5, rtol=2e-5)
GEOM = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            num_frames=4, drop_path_rate=0.0)


def random_params(jmodel, x, rng):
    """The model's parameter tree (shapes only traced) filled from ``rng``:
    weights N(0, 0.05^2), LayerNorm scales 1 + N(0, 0.1^2)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]

    def fill(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        scale = 0.1 if path[-1].key == "scale" else 0.05
        return (base + scale * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# (crop, frames): the trained geometry, then a larger crop and fewer frames
# (nearest-resized position and time embeddings)
@pytest.mark.parametrize("crop,frames", [(32, 4), (48, 2)])
def test_timesformer_matches_jax(crop, frames, monkeypatch):
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    rng = np.random.RandomState(crop + frames)
    x = rng.randn(2, frames, crop, crop, 3).astype(np.float32)
    jmodel = JaxTimeSformer(**GEOM, dtype=jnp.float32, use_pallas=True)
    params = random_params(jmodel, x, rng)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                  deterministic=True))

    model = TimeSformer(**GEOM).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == (2, GEOM["embed_dim"])
    np.testing.assert_allclose(out, ref, **TOL)


def test_random_init_is_seeded_and_jax_shaped():
    """The port's random init draws from an explicit generator: the same
    seed gives the same parameters, and every parameter has the shape
    the JAX tree maps to."""
    a, b = TimeSformer(**GEOM), TimeSformer(**GEOM)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    params = random_params(JaxTimeSformer(**GEOM), np.zeros((1, 4, 32, 32, 3)),
                           np.random.RandomState(0))
    port = params_from_jax(params)
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(v.shape) for k, v in a.state_dict().items()}
    w = a.blocks[0].attn.qkv.weight
    assert w.abs().max() <= 0.04 + 1e-7 and 0.01 < w.std() < 0.03
