"""The pretraining pieces of the PyTorch port against the JAX package: the
frozen CLIP text tower, the diffusion order transformer's ``pretrain``
with fixed draws, the pretraining loss, the new elementwise ops, the LR
schedule, and the AdamW update against optax's.

Inputs are made with numpy from a seed and given to both sides; parameters
are the JAX module's own init, moved into the port through
``procedurevrl_torch.utils.weights``.  Tolerance: fp32, atol = rtol = 2e-5
(the repository's parity tolerance) unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.engine import losses as jax_losses
from procedurevrl_tpu.models.clip_text import CLIPTextEncoder as JaxCLIPText
from procedurevrl_tpu.models.order_transformer import (
    OrderTransformer as JaxOrderTransformer,
)
from procedurevrl_tpu.ops import common as jax_common
from procedurevrl_tpu.solver import lr_policy as jax_lr_policy
from procedurevrl_torch.config import get_cfg
from procedurevrl_torch.engine import losses
from procedurevrl_torch.models.clip_text import CLIPTextEncoder
from procedurevrl_torch.models.order_transformer import OrderTransformer
from procedurevrl_torch.ops import common
from procedurevrl_torch.solver import lr_policy
from procedurevrl_torch.utils import weights

TOL = dict(atol=2e-5, rtol=2e-5)


def _init(module, *args, **kw):
    params = jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.PRNGKey(0))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_state(convert, tree, prefix):
    out = {}
    convert(tree, out)
    return {k[len(prefix):]: v for k, v in out.items()}


@pytest.mark.parametrize("layers", [1, 2])
def test_clip_text_encoder_matches_jax(layers):
    rng = np.random.RandomState(layers)
    vocab, width, heads, embed = 120, 64, 2, 48
    ids = rng.randint(1, vocab - 1, (3, 77)).astype(np.int32)
    ids[0, 10] = vocab - 1  # EOT: the largest id of its row
    jmodel = JaxCLIPText(vocab_size=vocab, width=width, heads=heads,
                         layers=layers, embed_dim=embed)
    params = _init(jmodel, jnp.asarray(ids))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))

    model = CLIPTextEncoder(vocab_size=vocab, width=width, heads=heads,
                            layers=layers, embed_dim=embed)
    model.load_state_dict(_port_state(weights._text_model, params,
                                      "text_model."), strict=True)
    assert not any(p.requires_grad for p in model.parameters())
    out = model(torch.from_numpy(ids).long())
    assert out.shape == (3, embed)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _order_models(layers=2, hidden=64, heads=8):
    jmodel = JaxOrderTransformer(num_seg=8, tfm_layers=layers, tfm_heads=heads,
                                 hidden_size=hidden, max_len=9)
    x = jnp.zeros((2 * 9, hidden))
    params = _init(jmodel, x, mask_inds=jnp.zeros(2, jnp.int32),
                   pad_start=jnp.full(2, 9), level_noise=jnp.zeros(
                       (layers, 2, hidden)), method=JaxOrderTransformer.pretrain)
    model = OrderTransformer(num_seg=8, tfm_layers=layers, tfm_heads=heads,
                             hidden_size=hidden, max_len=9)
    model.load_state_dict(_port_state(weights._order_tfm, params,
                                      "order_tfm."), strict=True)
    return jmodel, params, model


@pytest.mark.parametrize("layers", [2, 4])
def test_order_transformer_pretrain_matches_jax(layers):
    rng = np.random.RandomState(40 + layers)
    B, C = 4, 64
    jmodel, params, model = _order_models(layers, C)
    x = rng.randn(B * 9, C).astype(np.float32)
    mask_inds = np.array([0, 4, 8, 2])
    pad_start = np.array([3, 6, 9, 5])  # 9 == max_len: no padding
    level_noise = rng.randn(layers, B, C).astype(np.float32)
    jf, jm, (jx0, jall), jinter = jmodel.apply(
        {"params": params}, jnp.asarray(x), mask_inds=jnp.asarray(mask_inds),
        pad_start=jnp.asarray(pad_start), level_noise=jnp.asarray(level_noise),
        method=JaxOrderTransformer.pretrain)
    t = torch.from_numpy
    f, m, (x0, alld), inter = model.pretrain(t(x), t(mask_inds), t(pad_start),
                                            t(level_noise))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert alld.shape == (layers * B, C)
    for got, ref in ((f, jf), (x0, jx0), (alld, jall), (inter, jinter)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_order_transformer_random_draws_follow_the_pad_rule():
    _, _, model = _order_models()
    gen = torch.Generator().manual_seed(3)
    B, C = 64, 64
    x = torch.randn(B * 9, C, generator=gen)
    f, m, (x0, alld), _ = model.pretrain(x, generator=gen)
    assert f.shape == (B, C) and alld.shape == (2 * B, C)
    assert torch.isfinite(alld).all()
    assert ((m >= 0) & (m < 9)).all() and (m == 8).any()
    # the same generator state gives the same draws
    gen.manual_seed(3)
    x = torch.randn(B * 9, C, generator=gen)
    f2, m2, _, _ = model.pretrain(x, generator=gen)
    assert torch.equal(m, m2) and torch.equal(f, f2)


def test_order_transformer_renoising_stops_the_gradient():
    """Each level is re-noised from the previous level's estimate with no
    gradient through it (JAX ``order_transformer.py:259``): the input gets
    a gradient only through the context tokens and x0 of level 0."""
    _, _, model = _order_models()
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(18, 64).astype(np.float32))
    x.requires_grad_(True)
    draws = dict(mask_inds=torch.tensor([2, 8]), pad_start=torch.tensor([5, 9]),
                 level_noise=torch.from_numpy(rng.randn(2, 2, 64).astype(
                     np.float32)))
    _, _, (x0, alld), _ = model.pretrain(x, **draws)
    alld[2:].sum().backward()  # the last level only
    g = x.grad.view(2, 9, 64)
    # the masked clip's own embedding feeds the last level only through the
    # stopped re-noising: no gradient
    assert not g[0, 2].any() and not g[1, 8].any()
    # context clips before the padding do get one
    assert g[0, 0].abs().sum() > 0 and g[1, 0].abs().sum() > 0


def test_topk_sharpen_and_pretrain_loss_match_jax():
    rng = np.random.RandomState(8)
    student = (3 * rng.randn(6, 30)).astype(np.float32)
    teacher = (3 * rng.randn(6, 30)).astype(np.float32)
    teacher[1, :7] = 5.0  # a 7-way tie across the top 5
    teacher[2, 3] = teacher[2, 4] = teacher[2].max() + 1.0
    x0 = rng.randn(8, 16).astype(np.float32)
    pred = rng.randn(8, 16).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(teacher), axis=1)
    for k in (0, 1, 5):
        ref = np.asarray(jax_losses.topk_sharpen(probs, k))
        got = losses.topk_sharpen(torch.from_numpy(np.array(probs)), k)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the tie keeps all 7 entries
    sharp = losses.topk_sharpen(torch.softmax(torch.from_numpy(teacher), 1), 5)
    assert int((sharp[1] > 0).sum()) == 7
    ref = jax_losses.pretrain_loss(jnp.asarray(student), jnp.asarray(teacher),
                                   (jnp.asarray(x0), jnp.asarray(pred)), 5)
    t = torch.from_numpy
    got = losses.pretrain_loss(t(student), t(teacher), (t(x0), t(pred)), 5)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(g_.item(), float(r_), **TOL)


def test_kl_div_batchmean_zero_target_terms():
    logp = torch.log_softmax(torch.randn(3, 5, generator=torch.Generator()
                                         .manual_seed(0)), dim=1)
    t = torch.tensor([[1.0, 0, 0, 0, 0], [0.5, 0.5, 0, 0, 0],
                      [0.2, 0.2, 0.2, 0.2, 0.2]])
    ref = torch.nn.functional.kl_div(logp, t, reduction="batchmean")
    np.testing.assert_allclose(losses.kl_div_batchmean(logp, t).item(),
                               ref.item(), **TOL)


def test_quick_gelu_and_time_embedding_match_jax():
    rng = np.random.RandomState(2)
    x = (3 * rng.randn(5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        common.quick_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jax_common.quick_gelu(jnp.asarray(x))), **TOL)
    t = np.array([0, 1, 3, 7])
    np.testing.assert_allclose(
        common.sinusoidal_time_embedding(torch.from_numpy(t), 128).numpy(),
        np.asarray(jax_common.sinusoidal_time_embedding(jnp.asarray(t), 128)),
        **TOL)


@pytest.mark.parametrize("policy", ["steps_with_relative_lrs", "cosine"])
def test_lr_schedule_matches_jax(policy):
    cfgs = [get_cfg(), jax_get_cfg()]
    for cfg in cfgs:
        cfg.SOLVER.LR_POLICY = policy
        cfg.SOLVER.BASE_LR = 5e-5
        cfg.SOLVER.COSINE_END_LR = 1e-6
        cfg.SOLVER.STEPS = [0, 15, 23]
        cfg.SOLVER.LRS = [1, 0.1, 0.01]
        cfg.SOLVER.MAX_EPOCH = 25
        cfg.SOLVER.WARMUP_EPOCHS = 2.0
        cfg.SOLVER.WARMUP_START_LR = 1e-7
    port, ref = lr_policy.lr_schedule(cfgs[0], 7), jax_lr_policy.lr_schedule(
        cfgs[1], 7)
    for step in (0, 1, 13, 14, 50, 104, 105, 160, 174):
        np.testing.assert_allclose(port(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6)


def test_adamw_update_matches_optax():
    """torch AdamW (eps 1e-8, decoupled decay) over three steps equals the
    JAX package's chain scale_by_adam -> add_decayed_weights -> scale(-lr)."""
    rng = np.random.RandomState(9)
    p0 = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-4]
    wd = 1e-2
    tx = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                     optax.add_decayed_weights(wd),
                     optax.scale_by_schedule(lambda s: -jnp.asarray(lrs)[s]))
    p, state = jnp.asarray(p0), None
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)

    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.AdamW([tp], lr=lrs[0], betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    for g, lr in zip(grads, lrs):
        opt.param_groups[0]["lr"] = lr
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p), atol=1e-6,
                               rtol=1e-6)
