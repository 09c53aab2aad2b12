"""The port's MViT-v2 remat policy against the JAX package's, as
``test_torch_remat.py`` holds TimeSformer's: the encoder of
``test_torch_mvit.py`` whose blocks all take K5, with and without
``GELU_STORED``, under ``TPU.REMAT``.  JAX's MViT policy is fixed
(``models/mvit.py:953-963``: the attention outputs, lse and probabilities
and the GELU derivative; it reads no ``REMAT_SAVE_*`` knob), and so is the
port's (``models/mvit.py:REMAT_NAMES``).  Gradients of ``sum(out * G)``
against JAX's (its kernels in interpret mode) at fp32 2e-5 and against the
port's without remat at 1e-6; K5's forward runs once per block a step;
block 0's qkv is not kept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procedurevrl_tpu.models import layers as jax_layers
from procedurevrl_tpu.models import mvit as jm
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.ops import mvit_attention as ma
from procedurevrl_torch.utils import weights
from test_torch_remat import (
    B, SAME, TOL, _compare, _count, _jax_grads, _np_params, _port_run,
)

MVIT_CFG = dict(temporal_size=4, embed_dim=16, num_heads=1, depth=3,
                dim_mul=((1, 2.0),), head_mul=((1, 2.0),),
                pool_kvq_kernel=(3, 3, 3), spatial_size=64,
                pool_q_stride=((0, 1, 1, 1), (1, 1, 2, 2), (2, 1, 1, 1)),
                pool_kv_stride_adaptive=(1, 4, 4))


@pytest.fixture(scope="module")
def mvit_jax():
    """The JAX MViT encoder's parameters and gradients under its remat
    policy, with and without ``GELU_STORED`` (the only knob its remat
    reads no value of changes: JAX's MViT policy is fixed)."""
    x = np.random.RandomState(7).randn(B, 4, 64, 64, 3).astype(np.float32)
    jmod = jm.MViTEncoder(cfg=jm.MViTConfig(**MVIT_CFG), use_pallas=True,
                          remat=True)
    params = _np_params(jmod, jnp.asarray(x), seed=8)
    shape = jax.eval_shape(jmod.apply, params, jnp.asarray(x)).shape
    g = (0.05 * np.random.RandomState(9).randn(*shape)).astype(np.float32)
    out = {}
    for gelu in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_layers, "_GELU_STORED", gelu)
            out[gelu] = _jax_grads(jmod, params, jnp.asarray(x),
                                   jnp.asarray(g))
    return x, g, params, out


@pytest.mark.parametrize("gelu", [False, True])
def test_mvit_remat_matches_jax(gelu, mvit_jax, monkeypatch):
    """The MViT policy keeps every block's attention kernel outputs (and
    under ``GELU_STORED`` the GELU derivative); the ``REMAT_SAVE_*`` knobs
    reach neither encoder's MViT, JAX's or the port's."""
    x, g, params, jout = mvit_jax
    jgrads, jdx = jout[gelu]
    state, want = {}, {}
    weights._mvit_encoder(jax.tree_util.tree_map(np.asarray,
                                                 params["params"]),
                          state, pre="")
    weights._mvit_encoder(jax.tree_util.tree_map(np.asarray,
                                                 jgrads["params"]),
                          want, pre="")
    calls: dict = {}
    _count(monkeypatch, ma, ("mvit_attention_hl_fwd", "mvit_attention_fwd"),
           calls)
    cfg = pm.MViTConfig(**MVIT_CFG)
    plan, dims, _ = cfg.block_schedule()
    qkv_numel = B * (int(np.prod(dims)) + 1) * 3 * plan[0]["dim"]
    runs = {}
    for remat in (False, True):
        model = pm.MViTEncoder(cfg, remat=remat, gelu_stored=gelu)
        model.load_state_dict(state, strict=True)
        calls.clear()
        runs[remat] = _port_run(model, x, g, qkv_numel) + (dict(calls),)
    (grads, dx, alive, n), (g0, dx0, _, n0) = runs[True], runs[False]
    _compare(grads, want, dx, jdx, TOL)
    _compare(grads, g0, dx, dx0, SAME)
    # every block takes K5 and runs it once a step
    assert n == n0 == {"mvit_attention_hl_fwd": cfg.depth}
    assert alive == 0  # JAX's MViT policy names no qkv
