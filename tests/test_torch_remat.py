"""The port's selective remat (``ops/remat.py``) against the JAX package's
``save_only_these_names`` policies: TimeSformer here, MViT-v2 in
``test_torch_remat_mvit.py``.

Each remat setting (the default knobs, ``TPU.REMAT_SAVE_ATTN False``,
``REMAT_SAVE_QKV True``, ``REMAT_SAVE_TEMPORAL False``, ``GELU_STORED=1``)
builds the port's encoder under ``TPU.REMAT`` and checks, for one
forward and backward of ``sum(out * G)`` (G a fixed numpy cotangent):

- the gradients of every parameter and of the input equal the same
  port encoder's without remat, and the JAX encoder's under the same
  knobs (remat on, its parameters moved through ``utils/weights.py``);
- the attention forwards (the port's wrappers, counted) run once per block
  where the policy keeps their outputs and twice where it recomputes them;
- after the forward no qkv-sized tensor is still alive unless
  ``REMAT_SAVE_QKV`` keeps K1's projection, one per block.  Liveness is
  read from the storages of every operation's outputs (a dispatch mode
  outside the model, weak references): the checkpoint's own
  saved-tensor hooks hide a block's saved tensors from an outer
  ``saved_tensors_hooks``, and the policy keeps its values outside
  autograd, so the storages are what shows what a step keeps.

TimeSformer: width 128, 2 heads of 64, depth 1, 32^2 crops, 20 frames (so
the temporal pass takes the plain path and ``temporal_out`` exists; K1
through ``PALLAS_MIN_LEN=1``), and 4 frames for K2's forward count (port
only: its numerics are held against JAX in ``test_torch_train.py``).
JAX's Pallas kernels run in interpret mode.
Tolerances: fp32 atol = rtol = 2e-5 against JAX; against the port without
remat, 1e-6 (the same arithmetic, recomputed).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from procedurevrl_tpu.models import layers as jax_layers
from procedurevrl_tpu.models.timesformer import TimeSformer as JaxTimeSformer
from procedurevrl_torch.models.timesformer import TimeSformer
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2
from procedurevrl_torch.ops.attention_route import AttentionRoute
from procedurevrl_torch.utils import weights

TOL = dict(atol=2e-5, rtol=2e-5)
SAME = dict(atol=1e-6, rtol=1e-6)
B, S, C, HEADS = 2, 32, 128, 2
# setting -> (TimeSformer keyword arguments, GELU_STORED)
SETTINGS = {
    "default": ({"remat_save_temporal": True}, False),
    "save_attn_off": ({"remat_save_attn": False,
                       "remat_save_temporal": True}, False),
    "save_qkv": ({"remat_save_qkv": True, "remat_save_temporal": True},
                 False),
    "save_temporal_off": ({}, False),
    "gelu_stored": ({"remat_save_temporal": True}, True),
}


class _Storages(TorchDispatchMode):
    """Weak references to the storages of every operation output of
    ``numel`` elements."""

    def __init__(self, numel: int):
        super().__init__()
        self.numel = numel
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel() == self.numel:
                st = t.untyped_storage()
                self.refs[st.data_ptr()] = StorageWeakRef(st)
        return out

    def alive(self) -> int:
        gc.collect()
        return sum(not r.expired() for r in self.refs.values())


def _count(monkeypatch, mod, names, calls: dict) -> None:
    for name in names:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw:
                            calls.__setitem__(_n, calls.get(_n, 0) + 1)
                            or _f(*a, **kw))


def _np_params(module, x, seed):
    """The JAX module's parameters drawn with numpy (no JAX init to
    compile): N(0, 0.05), LayerNorm scales around 1."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.05 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_grads(module, params, x, g, **apply_kw):
    def loss(p, xx):
        return jnp.sum(module.apply(p, xx, **apply_kw) * g)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)


def _port_run(model, x, g, numel):
    """One forward (its qkv-sized storages tracked) and backward; returns
    (parameter gradients, input gradient, storages alive after the
    forward)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    with _Storages(numel) as track:
        out = model(xt)
    assert track.refs, "no qkv-sized tensor was made"
    alive = track.alive()
    (out * torch.from_numpy(g)).sum().backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return grads, xt.grad.detach().clone(), alive


def _compare(grads, want, dx, want_dx, tol):
    assert set(grads) == set(want)
    for name, gr in grads.items():
        np.testing.assert_allclose(gr.numpy(), np.asarray(want[name]), **tol,
                                   err_msg=name)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **tol)


def _timesformer(t, remat, kw, gelu):
    return TimeSformer(img_size=S, embed_dim=C, depth=1, num_heads=HEADS,
                       num_frames=t, drop_path_rate=0.0, remat=remat,
                       route=AttentionRoute.from_env(), gelu_stored=gelu,
                       **kw)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_timesformer_remat_matches_jax(setting, monkeypatch):
    kw, gelu = SETTINGS[setting]
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    monkeypatch.setattr(jax_layers, "_GELU_STORED", gelu)
    t = 20
    x = np.random.RandomState(1).randn(B, t, S, S, 3).astype(np.float32)
    jmod = JaxTimeSformer(img_size=S, embed_dim=C, depth=1, num_heads=HEADS,
                          num_frames=t, drop_path_rate=0.0, use_pallas=True,
                          remat=True, **kw)
    params = _np_params(jmod, jnp.asarray(x), seed=2)
    g = (0.05 * np.random.RandomState(3).randn(B, C)).astype(np.float32)
    jgrads, jdx = _jax_grads(jmod, params, jnp.asarray(x), jnp.asarray(g),
                             deterministic=True)
    want = weights.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jgrads["params"]))

    calls: dict = {}
    _count(monkeypatch, k1, ("spatial_attention_fwd_probs",), calls)
    state = weights.params_from_jax(jax.tree_util.tree_map(
        np.asarray, params["params"]))
    numel = B * t * (S // 16) ** 2 * 3 * C  # K1's qkv [B*T, N, 3C]
    runs = {}
    for remat in (False, True):
        model = _timesformer(t, remat, kw, gelu)
        model.load_state_dict(state, strict=True)
        calls.clear()
        runs[remat] = _port_run(model, x, g, numel) + (dict(calls),)
    (grads, dx, alive, n), (g0, dx0, alive0, n0) = runs[True], runs[False]
    _compare(grads, want, dx, jdx, TOL)
    _compare(grads, g0, dx, dx0, SAME)
    keeps_attn = kw.get("remat_save_attn", True)
    assert n0 == {"spatial_attention_fwd_probs": 1}
    assert n == {"spatial_attention_fwd_probs": 1 if keeps_attn else 2}
    # one block: K1's projection alone under REMAT_SAVE_QKV, else none;
    # without remat autograd keeps K1's for its backward
    assert alive == (1 if kw.get("remat_save_qkv") else 0)
    assert alive0 >= 1


@pytest.mark.parametrize("keeps_attn", [True, False])
def test_timesformer_kernels_run_once_per_block_under_the_policy(
        keeps_attn, monkeypatch):
    """At 4 frames the temporal pass takes K2: K1sp and K2f run once per
    block a step under ``REMAT_SAVE_ATTN``, twice without it, and once
    without remat; each backward once; the gradients equal the port's
    without remat."""
    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    calls: dict = {}
    _count(monkeypatch, k1, ("spatial_attention_fwd_probs",
                             "spatial_attention_bwd"), calls)
    _count(monkeypatch, k2, ("temporal_attention", "temporal_attention_bwd"),
           calls)
    t, depth = 4, 2
    x = np.random.RandomState(4).randn(B, t, S, S, 3).astype(np.float32)
    g = np.random.RandomState(5).randn(B, C).astype(np.float32)
    runs = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = TimeSformer(img_size=S, embed_dim=C, depth=depth,
                            num_heads=HEADS, num_frames=t,
                            drop_path_rate=0.0, remat=remat,
                            route=AttentionRoute.from_env(),
                            remat_save_attn=keeps_attn)
        model.reset_parameters(torch.Generator().manual_seed(6))
        calls.clear()
        runs[remat] = _port_run(model, x, g, B * t * 4 * 3 * C) + (
            dict(calls),)
    _compare(runs[True][0], runs[False][0], runs[True][1], runs[False][1],
             SAME)
    fwd = depth * (1 if keeps_attn else 2)
    assert runs[True][3] == {"spatial_attention_fwd_probs": fwd,
                             "temporal_attention": fwd,
                             "spatial_attention_bwd": depth,
                             "temporal_attention_bwd": depth}
    assert set(runs[False][3].values()) == {depth}
    assert runs[True][2] == 0  # neither K1's nor K2's qkv is kept
