"""The softmax shift knobs ``SPATIAL_SHIFT``, ``TEMPORAL_SHIFT`` and
``MVIT_SHIFT`` under ``max`` and ``none``: every attention family's plain
version (what the port runs on the CPU, and what the card's kernels are
held to) against the JAX kernel function under the same knob, forward and
gradient.

Each JAX function reaches its Pallas kernel, in interpret mode here, and
reads the knob when it traces, so every call clears JAX's caches first.
The inputs are numpy, from a seed; one query row in three keeps small
logits, the others are aimed at two keys so that the row's top logit lies
in (80, 88) and, under ``max`` only, in (88, 300): there the shifts differ
(``none`` overflows past ~88.7, where JAX's compact temporal layout spreads
the NaN to other heads, so its rows stay below 88).  Each case first holds
that JAX under the knob differs from JAX under ``clamp`` by more than 1e-3
on those inputs.  Tolerances: fp32, atol = rtol = 2e-5 for outputs, 5e-5
for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops.attention import qkv_window_perm
from procedurevrl_tpu.ops.pallas_attention import (
    _heads_per_block, flash_attention_cls, flash_attention_cls_qkv,
    flash_attention_headfused, flash_attention_temporal,
)
from procedurevrl_tpu.ops.pallas_mvit_attention import (
    flash_attention_mvit, flash_attention_mvit_hl,
)
from procedurevrl_torch.ops import flash_attention as fa
from procedurevrl_torch.ops import mvit_attention as ma
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops import temporal_attention as k2
from procedurevrl_torch.ops.attention_route import AttentionRoute

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
# the top logit each query row is aimed at (None: left small), per shift
TARGETS = {"max": (None, 84.0, 96.0), "none": (None, 84.0, 86.0)}


def aim(q, k, scale, targets, rng):
    """Aim query rows q [G, Lq, d] at the keys k [G, Lk, d] in place: row
    i takes targets[i % len(targets)]; an aimed row is two random keys a +
    0.95 b, scaled so that its largest logit q.k * scale is the target."""
    for g in range(q.shape[0]):
        for i in range(q.shape[1]):
            t = targets[i % len(targets)]
            if t is None:
                continue
            a, b = rng.choice(k.shape[1], 2, replace=False)
            row = k[g, a] + 0.95 * k[g, b]
            q[g, i] = row * (t / ((k[g] @ row).max() * scale))
    return q


def _fresh(monkeypatch, knob, value):
    monkeypatch.setenv(knob, value)
    jax.clear_caches()


def _jax_vjp(fn, args, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    grads = vjp(tuple(jnp.asarray(x) for x in g) if isinstance(out, tuple)
                else jnp.asarray(g))
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out], [np.asarray(x) for x in grads]


def _jax_both(monkeypatch, knob, shift, fn, args, g):
    """JAX's outputs and gradients under the knob, after holding that its
    outputs differ from its clamp outputs by more than 1e-3."""
    _fresh(monkeypatch, knob, "clamp")
    clamp = fn(*(jnp.asarray(a) for a in args))
    clamp = [np.asarray(c) for c in (clamp if isinstance(clamp, tuple)
                                     else (clamp,))]
    _fresh(monkeypatch, knob, shift)
    out, grads = _jax_vjp(fn, args, g)
    diff = max(float(np.nanmax(np.abs(o - c))) for o, c in zip(out, clamp))
    assert diff > 1e-3, f"{knob}={shift} does not differ from clamp ({diff})"
    return out, grads


def _port_grads(fn, args, g):
    """The port's outputs and gradients through autograd (its plain
    versions on the CPU)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, [torch.from_numpy(x) for x in g])
    return [o.detach().numpy() for o in out], [t.grad.numpy() for t in ts]


def _close(got, want, tol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, **tol, err_msg=f"{what} {i}")


# ------------------------------------------------------------------- K1

@pytest.mark.parametrize("save_probs", ["1", "0"])
@pytest.mark.parametrize("shift", ["max", "none"])
def test_k1_shift_matches_jax(shift, save_probs, monkeypatch):
    """K1 (K1sp + K1b, or K1f + K1br) against ``flash_attention_cls_qkv``
    (JAX ``_facq_fwd`` / ``_facq_bwd``) under ``SPATIAL_SHIFT``."""
    rng = np.random.RandomState(31)
    bt, n, heads, d = 1, 24, 2, 64
    scale = d ** -0.5
    c = heads * d
    x = (0.5 * rng.randn(bt, n + 1, 3, heads, d)).astype(np.float32)
    q = x[:, :, 0].transpose(0, 2, 1, 3).reshape(bt * heads, n + 1, d)
    k = x[:, :, 1].transpose(0, 2, 1, 3).reshape(bt * heads, n + 1, d)
    aim(q, k, scale, TARGETS[shift], rng)
    x[:, :, 0] = q.reshape(bt, heads, n + 1, d).transpose(0, 2, 1, 3)
    x = x.reshape(bt, n + 1, 3 * c)
    qkv, qkv_c = np.ascontiguousarray(x[:, :n]), np.ascontiguousarray(x[:, n:])
    g = [(0.5 * rng.randn(bt, n, c)).astype(np.float32),
         (0.5 * rng.randn(bt, 1, c)).astype(np.float32)]
    perm = np.asarray(qkv_window_perm(c, heads, _heads_per_block(d, heads)))
    inv = np.argsort(perm)
    monkeypatch.setenv("SPATIAL_SAVE_PROBS", save_probs)
    out, grads = _jax_both(
        monkeypatch, "SPATIAL_SHIFT", shift,
        lambda a, b: flash_attention_cls_qkv(a, b, heads, scale),
        (qkv[..., perm], qkv_c[..., perm]), g)
    grads = [gr[..., inv] for gr in grads]
    route = AttentionRoute(save_probs=save_probs == "1", spatial_shift=shift)
    got, got_grads = _port_grads(
        lambda a, b: k1.spatial_attention_autograd(a, b, heads, scale, route),
        (qkv, qkv_c), g)
    _close(got, out, TOL, "K1 out")
    _close(got_grads, grads, GRAD_TOL, "K1 grad")


# ------------------------------------------------------------------- K2

@pytest.mark.parametrize("shift", ["max", "none"])
def test_k2_shift_matches_jax(shift, monkeypatch):
    """K2 (K2f + K2b) against ``flash_attention_temporal`` under
    ``TEMPORAL_SHIFT``."""
    rng = np.random.RandomState(32)
    b, t, n, heads, d = 1, 8, 4, 2, 64
    scale = d ** -0.5
    x = (0.5 * rng.randn(b, t, n, 3, heads, d)).astype(np.float32)
    q = x[:, :, :, 0].transpose(0, 2, 3, 1, 4).reshape(-1, t, d)
    k = x[:, :, :, 1].transpose(0, 2, 3, 1, 4).reshape(-1, t, d)
    aim(q, k, scale, TARGETS[shift], rng)
    x[:, :, :, 0] = q.reshape(b, n, heads, t, d).transpose(0, 3, 1, 2, 4)
    qkv = np.ascontiguousarray(x.reshape(b, t, n, 3 * heads * d))
    g = (0.5 * rng.randn(b, t, n, heads * d)).astype(np.float32)
    out, grads = _jax_both(
        monkeypatch, "TEMPORAL_SHIFT", shift,
        lambda a: flash_attention_temporal(a, heads, scale), (qkv,), g)
    route = AttentionRoute(temporal_shift=shift)
    got, got_grads = _port_grads(
        lambda a: k2.temporal_attention_autograd(a, heads, scale, route),
        (qkv,), [g])
    _close(got, out, TOL, "K2 out")
    _close(got_grads, grads, GRAD_TOL, "K2 grad")


# ------------------------------------------------------- the pair: K4, K3

@pytest.mark.parametrize("cls", [False, True])
@pytest.mark.parametrize("shift", ["max", "none"])
def test_pair_shift_matches_jax(shift, cls, monkeypatch):
    """The key-tiled pair: K4 against ``flash_attention_headfused``, K3
    against ``flash_attention_cls``, under ``SPATIAL_SHIFT``."""
    rng = np.random.RandomState(33 + cls)
    b, n, heads, d = 1, 24, 2, 64
    scale = d ** -0.5
    L = n + cls
    x = (0.5 * rng.randn(3, b, L, heads, d)).astype(np.float32)
    q = x[0].transpose(0, 2, 1, 3).reshape(b * heads, L, d)
    k = x[1].transpose(0, 2, 1, 3).reshape(b * heads, L, d)
    aim(q, k, scale, TARGETS[shift], rng)
    x[0] = q.reshape(b, heads, L, d).transpose(0, 2, 1, 3)
    x = x.reshape(3, b, L, heads * d)
    if cls:
        args = (*(np.ascontiguousarray(t[:, :n]) for t in x),
                *(np.ascontiguousarray(t[:, n:]) for t in x))
        g = [(0.5 * rng.randn(b, n, heads * d)).astype(np.float32),
             (0.5 * rng.randn(b, 1, heads * d)).astype(np.float32)]
        jfn = lambda *a: flash_attention_cls(*a, heads, scale)
        pfn = lambda *a: fa.flash_attention_cls_autograd(*a, heads, scale,
                                                         shift)
    else:
        args = tuple(np.ascontiguousarray(t) for t in x)
        g = [(0.5 * rng.randn(b, n, heads * d)).astype(np.float32)]
        jfn = lambda *a: flash_attention_headfused(*a, heads, scale)
        pfn = lambda *a: fa.flash_attention_autograd(*a, heads, scale, shift)
    out, grads = _jax_both(monkeypatch, "SPATIAL_SHIFT", shift, jfn, args,
                           g if cls else g[0])
    got, got_grads = _port_grads(pfn, args, g)
    _close(got, out, TOL, "pair out")
    _close(got_grads, grads, GRAD_TOL, "pair grad")


# -------------------------------------------------------- MViT: K5, K6

MV_B, MV_H, MV_D, MV_QN = 1, 2, 96, 24
MV_K = (2, 3, 4)


@pytest.mark.parametrize("route", ["hl", "split", "split_saved"])
@pytest.mark.parametrize("shift", ["max", "none"])
def test_mvit_shift_matches_jax(shift, route, monkeypatch):
    """K5 against ``flash_attention_mvit_hl``, K6 (and K6sp + K6bs under
    ``MVIT_SAVE_PROBS=1``) against ``flash_attention_mvit`` under
    ``MVIT_SHIFT``."""
    rng = np.random.RandomState(34)
    kn, kcat = int(np.prod(MV_K)), sum(MV_K)
    scale = MV_D ** -0.5
    g_ = MV_B * MV_H
    mk = lambda *s: (0.5 * rng.randn(*s)).astype(np.float32)
    q, k, v = mk(g_, MV_QN, MV_D), mk(g_, kn, MV_D), mk(g_, kn, MV_D)
    kc, vc, rel = mk(g_, 1, MV_D), mk(g_, 1, MV_D), mk(g_, MV_QN, kcat)
    aim(q, np.concatenate([k, kc], axis=1), scale, TARGETS[shift], rng)
    g = mk(g_, MV_QN, MV_D)
    if route == "hl":
        merge = lambda a: np.ascontiguousarray(
            a.reshape(MV_B, MV_H, a.shape[1], -1).transpose(0, 2, 1, 3)
            .reshape(MV_B, a.shape[1], -1))
        args = tuple(merge(a) for a in (q, k, v, kc, vc, rel))
        g = merge(g)
        jfn = lambda *a: flash_attention_mvit_hl(*a, MV_K, MV_H, scale)
        pfn = lambda *a: ma.mvit_attention_hl(*a, MV_K, MV_H, scale,
                                              shift=shift)
    else:
        saved = route == "split_saved"
        if saved:
            monkeypatch.setenv("MVIT_SAVE_PROBS", "1")
        args = (q, k, v, kc, vc, rel)
        jfn = lambda *a: flash_attention_mvit(*a, MV_K, scale)
        pfn = lambda *a: ma.mvit_attention(*a, MV_K, scale,
                                           save_probs=saved, shift=shift)
    out, grads = _jax_both(monkeypatch, "MVIT_SHIFT", shift, jfn, args, g)
    got, got_grads = _port_grads(pfn, args, [g])
    _close(got, out, TOL, "MViT out")
    _close(got_grads, grads, GRAD_TOL, "MViT grad")


def test_aimed_rows_reach_the_ranges():
    """The aimed rows' top logits are the targets, past the clamp."""
    rng = np.random.RandomState(1)
    q = (0.5 * rng.randn(1, 6, 64)).astype(np.float32)
    k = (0.5 * rng.randn(1, 9, 64)).astype(np.float32)
    aim(q, k, 0.125, TARGETS["max"], rng)
    top = (q[0] @ k[0].T * 0.125).max(axis=1)
    np.testing.assert_allclose(top[[1, 2, 4, 5]], [84, 96, 84, 96], rtol=1e-5)
    assert np.all(top[[0, 3]] < 10)


@pytest.mark.parametrize("shift", ["clamp", "max"])
def test_mvit_entry_under_checkpoint(shift):
    """The K5 entry under activation checkpointing (the models' remat),
    where the backward may unpack its saved tensors only once: under
    ``max`` it also saved the output.  The same gradients as without."""
    rng = np.random.RandomState(35)
    kn, kcat = int(np.prod(MV_K)), sum(MV_K)
    c = MV_H * MV_D
    mk = lambda *s: torch.from_numpy(
        (0.5 * rng.randn(*s)).astype(np.float32))
    args = [mk(MV_B, MV_QN, c), mk(MV_B, kn, c), mk(MV_B, kn, c),
            mk(MV_B, 1, c), mk(MV_B, 1, c), mk(MV_B, MV_QN, MV_H * kcat)]
    fn = lambda *a: ma.mvit_attention_hl(*a, MV_K, MV_H, MV_D ** -0.5,
                                         shift=shift).sum()
    grads = []
    for remat in (False, True):
        ts = [a.clone().requires_grad_(True) for a in args]
        out = (torch.utils.checkpoint.checkpoint(fn, *ts, use_reentrant=False)
               if remat else fn(*ts))
        out.backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
