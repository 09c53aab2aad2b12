"""K3 and K4 of the PyTorch port (``ops/flash_attention.py``) against the
JAX package, and the routes that reach them: ``mhsa`` (K4), ``mhsa_cls``
with ``SPATIAL_FUSED_QKV=0`` (K3) and K1's long range.

On the CPU the port's wrappers run their plain versions; the JAX side is
``flash_attention_headfused`` / ``flash_attention_cls`` with the Pallas
kernels in interpret mode, fed the same numpy inputs, and each JAX-side
test asserts that JAX took the kernel it is meant to test.  Tolerances:
fp32, atol = rtol = 2e-5 (the repository's parity tolerance), 5e-5 for
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops import pallas_attention as pa
from procedurevrl_tpu.ops.attention import mhsa as jax_mhsa
from procedurevrl_tpu.ops.attention import mhsa_cls as jax_mhsa_cls
from procedurevrl_torch.ops import _build
from procedurevrl_torch.ops import flash_attention as fa
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.ops.attention import mhsa, mhsa_cls
from procedurevrl_torch.ops.attention_route import AttentionRoute

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
D = 64


def _count(monkeypatch, names):
    """Wrap the JAX kernel bodies ``names`` of ``pallas_attention`` with a
    counter; returns the dict of counts (each trace of a kernel adds one)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(pa, name)
        monkeypatch.setattr(pa, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **kw)))
    return calls


def _inputs(rng, b, n, c, cls):
    x = [rng.randn(b, n, c).astype(np.float32) for _ in range(3)]
    xc = [rng.randn(b, 1, c).astype(np.float32) for _ in range(3)] if cls else []
    g = [rng.randn(b, n, c).astype(np.float32)]
    gc = [rng.randn(b, 1, c).astype(np.float32)] if cls else []
    return x + xc, g + gc


@pytest.mark.parametrize("n", [130, 197])
def test_k4_plain_matches_jax_kernel(n, monkeypatch):
    heads, b = 2, 2
    c, scale = heads * D, D ** -0.5
    rng = np.random.RandomState(n)
    (q, k, v), (g,) = _inputs(rng, b, n, c, cls=False)
    calls = _count(monkeypatch, ["_fwd_kernel", "_bwd_kernel"])
    j = [jnp.asarray(t) for t in (q, k, v)]
    ref, vjp = jax.vjp(lambda q, k, v: pa.flash_attention_headfused(
        q, k, v, heads, scale), *j)
    jgrads = vjp(jnp.asarray(g))
    assert calls["_fwd_kernel"] > 0 and calls["_bwd_kernel"] > 0

    t = [torch.from_numpy(a) for a in (q, k, v)]
    launches = dict(_build.LAUNCHES)
    out = fa.flash_attention(*t, heads, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    grads = fa.flash_attention_bwd(*t, torch.from_numpy(g), None, heads, scale)
    for name, a, r in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL,
                                   err_msg=f"d{name}")
    # the autograd entry differentiates through the same backward
    tg = [x.clone().requires_grad_(True) for x in t]
    (fa.flash_attention_autograd(*tg, heads, scale)
     * torch.from_numpy(g)).sum().backward()
    for a, r in zip(tg, grads):
        np.testing.assert_allclose(a.grad.numpy(), r.numpy(), **GRAD_TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert _build.LAUNCHES == launches


@pytest.mark.parametrize("n", [130, 196])
def test_k3_plain_matches_jax_kernel(n, monkeypatch):
    heads, b = 2, 2
    c, scale = heads * D, D ** -0.5
    rng = np.random.RandomState(n + 1)
    x, (g, gc) = _inputs(rng, b, n, c, cls=True)
    calls = _count(monkeypatch, ["_fwd_cls_kernel", "_bwd_cls_kernel"])
    (ref, ref_c), vjp = jax.vjp(lambda *a: pa.flash_attention_cls(
        *a, heads, scale), *(jnp.asarray(a) for a in x))
    jgrads = vjp((jnp.asarray(g), jnp.asarray(gc)))
    assert calls["_fwd_cls_kernel"] > 0 and calls["_bwd_cls_kernel"] > 0

    t = [torch.from_numpy(a) for a in x]
    out, out_c = fa.flash_attention_cls(*t, heads, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_c), **TOL)
    grads = fa.flash_attention_cls_bwd(*t, torch.from_numpy(g),
                                       torch.from_numpy(gc), None, heads,
                                       scale)
    for name, a, r in zip(("dq", "dk", "dv", "dqc", "dkc", "dvc"), grads,
                          jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL,
                                   err_msg=name)
    tg = [a.clone().requires_grad_(True) for a in t]
    o, oc = fa.flash_attention_cls_autograd(*tg, heads, scale)
    ((o * torch.from_numpy(g)).sum() + (oc * torch.from_numpy(gc)).sum()
     ).backward()
    for a, r in zip(tg, grads):
        np.testing.assert_allclose(a.grad.numpy(), r.numpy(), **GRAD_TOL)


def test_k3_clamp_shift_matches_kernel_not_row_max():
    """Logits above 80: the plain version follows the TPU kernel's
    exp(min(s, 80)), where two saturated keys weigh the same."""
    heads, b, n = 2, 2, 130
    c, scale = heads * D, D ** -0.5
    rng = np.random.RandomState(5)
    x, _ = _inputs(rng, b, n, c, cls=True)
    x = [0.3 * a for a in x]
    q, k, v = x[:3]
    q[1, 5, :D] = 4.0          # frame query 5, head 0 of sample 1
    k[1, 10, :D] = 3.0         # logit 96
    x[4][1, 0, :D] = 2.66      # the CLS key: logit ~85
    ref, _ = pa.flash_attention_cls(*(jnp.asarray(a) for a in x), heads,
                                    scale)
    out, _ = fa.flash_attention_cls(*(torch.from_numpy(a) for a in x),
                                    heads, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy()[1, 5, :D],
                               0.5 * (v[1, 10, :D] + x[5][1, 0, :D]),
                               atol=1e-4)


def _weights(rng, c):
    """qkv_w [C, 3C], qkv_b, proj_w [C, C], proj_b in JAX's [in, out]."""
    return [(0.05 * rng.randn(*s)).astype(np.float32)
            for s in ((c, 3 * c), (3 * c,), (c, c), (c,))]


def _torch_weights(w):
    qkv_w, qkv_b, proj_w, proj_b = w
    return [torch.from_numpy(a) for a in (qkv_w.T.copy(), qkv_b,
                                          proj_w.T.copy(), proj_b)]


# (N, use_pallas, PALLAS_MIN_LEN, masking, whether both sides take K4)
@pytest.mark.parametrize("n,use_pallas,min_len,masking,kernel", [
    pytest.param(197, True, None, "none", True, id="197"),
    pytest.param(20, True, "1", "none", True, id="20-min-len-1"),
    pytest.param(20, True, None, "none", False, id="20-below-min-len"),
    pytest.param(197, False, None, "none", False, id="197-no-pallas"),
    pytest.param(197, True, None, "key_padding", False, id="197-masked"),
    pytest.param(197, True, None, "causal", False, id="197-causal")])
def test_mhsa_matches_jax(n, use_pallas, min_len, masking, kernel,
                          monkeypatch):
    if min_len is not None:
        monkeypatch.setenv("PALLAS_MIN_LEN", min_len)
    calls = {"jax": 0, "port": 0}
    jax_k4, port_k4 = pa.flash_attention_headfused, fa.flash_attention_autograd
    monkeypatch.setattr(pa, "flash_attention_headfused", lambda *a, **kw: (
        calls.__setitem__("jax", calls["jax"] + 1) or jax_k4(*a, **kw)))
    monkeypatch.setattr(fa, "flash_attention_autograd", lambda *a, **kw: (
        calls.__setitem__("port", calls["port"] + 1) or port_k4(*a, **kw)))
    route = AttentionRoute.from_env(use_pallas)
    rng = np.random.RandomState(n)
    b, heads = 2, 2
    c = heads * D
    x = rng.randn(b, n, c).astype(np.float32)
    w = _weights(rng, c)
    mask = None
    if masking == "key_padding":
        mask = np.zeros((b, n), bool)
        mask[0, -5:] = True
    causal = masking == "causal"
    ref = jax_mhsa(jnp.asarray(x), *(jnp.asarray(a) for a in w), heads,
                   key_padding_mask=None if mask is None else jnp.asarray(mask),
                   causal=causal, use_pallas=use_pallas)
    out = mhsa(torch.from_numpy(x), *_torch_weights(w), heads,
               key_padding_mask=None if mask is None else torch.from_numpy(mask),
               causal=causal, use_pallas=route.use_pallas,
               min_len=route.min_len)
    assert calls == {"jax": int(kernel), "port": int(kernel)}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_multihead_self_attention_never_takes_k4(monkeypatch):
    """The CLIP-style block (text tower, order transformer) keeps
    ``use_pallas`` False, as JAX's ``Attention`` defaults: an unmasked pass
    takes the plain path even where the environment would let K4 run."""
    from procedurevrl_torch.models.layers import ResidualAttentionBlock

    monkeypatch.setenv("PALLAS_MIN_LEN", "1")
    seen = []
    port_k4 = fa.flash_attention_autograd
    monkeypatch.setattr(fa, "flash_attention_autograd", lambda *a, **kw: (
        seen.append(1) or port_k4(*a, **kw)))
    torch.manual_seed(0)
    for causal in (False, True):
        blk = ResidualAttentionBlock(128, 2, causal)
        blk.reset_parameters(torch.Generator().manual_seed(1), 0.05, 0.05,
                             0.05)
        x = torch.randn(2, 197, 128, requires_grad=True)
        blk(x).sum().backward()
    assert seen == []


def test_mhsa_cls_split_projection_matches_jax(monkeypatch):
    """``SPATIAL_FUSED_QKV=0``: JAX's ``_qkv_project`` + ``flash_attention_cls``
    (K3, as JAX's ``tests/test_pallas_attention.py:200`` drives it) against
    the port's K3 on the thirds of its projection, forward and gradients."""
    monkeypatch.setenv("SPATIAL_FUSED_QKV", "0")
    calls = _count(monkeypatch, ["_fwd_cls_kernel", "_bwd_cls_kernel",
                                 "_fwd_cls_qkv_kernel"])
    seen = []
    port_k3, port_k1 = fa.flash_attention_cls_autograd, k1.spatial_attention_autograd
    monkeypatch.setattr(fa, "flash_attention_cls_autograd", lambda *a, **kw: (
        seen.append("k3") or port_k3(*a, **kw)))
    monkeypatch.setattr(k1, "spatial_attention_autograd", lambda *a, **kw: (
        seen.append("k1") or port_k1(*a, **kw)))
    route = AttentionRoute.from_env()
    assert not route.fused_qkv
    rng = np.random.RandomState(23)
    bt, n, heads = 2, 196, 2
    c = heads * D
    x = rng.randn(bt, n, c).astype(np.float32)
    cls_x = rng.randn(bt, 1, c).astype(np.float32)
    w = _weights(rng, c)
    g = rng.randn(bt, n, c).astype(np.float32)
    gc = rng.randn(bt, 1, c).astype(np.float32)

    def jax_loss(x, cls_x, *w):
        f, cl = jax_mhsa_cls(x, cls_x, *w, heads, use_pallas=True)
        return (f * g).sum() + (cl * gc).sum(), (f, cl)

    (_, (jf, jcl)), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), jnp.asarray(cls_x), *(jnp.asarray(a) for a in w))
    assert calls["_fwd_cls_kernel"] > 0 and calls["_bwd_cls_kernel"] > 0
    assert calls["_fwd_cls_qkv_kernel"] == 0

    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(cls_x).requires_grad_(True)
    tw = [a.requires_grad_(True) for a in _torch_weights(w)]
    f, cl = mhsa_cls(tx, tc, *tw, heads, route=route)
    ((f * torch.from_numpy(g)).sum() + (cl * torch.from_numpy(gc)).sum()
     ).backward()
    assert seen == ["k3"]
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(cl.detach().numpy(), np.asarray(jcl), **TOL)
    for name, a, r in (("x", tx.grad, jgrads[0]), ("cls", tc.grad, jgrads[1]),
                       ("qkv_w", tw[0].grad.T, jgrads[2]),
                       ("qkv_b", tw[1].grad, jgrads[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL,
                                   err_msg=name)


# N + 1 tokens per frame -> whether K1's own kernels carry it (else the
# key-tiled pair on the fused layout)
@pytest.mark.parametrize("n1,own", [(208, True), (209, False), (1025, False)])
@pytest.mark.parametrize("save_probs,delta,pipe", [(True, False, False),
                                                   (True, True, False),
                                                   (False, False, True)])
def test_k1_long_range_route(n1, own, save_probs, delta, pipe):
    """K1's route choice on the shape alone: up to N + 1 = 208 the route's
    own kernels, past it the pair's forward and recompute backward on every
    knob route; both hold K1's plain function."""
    route = AttentionRoute(save_probs=save_probs, delta=delta, pipe=pipe)
    heads = 1
    c = heads * D
    rng = np.random.RandomState(n1)
    qkv = torch.from_numpy(rng.randn(1, n1 - 1, 3 * c).astype(np.float32))
    qkv_c = torch.from_numpy(rng.randn(1, 1, 3 * c).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, n1 - 1, c).astype(np.float32))
    seen = []
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        for mod, name in ((fa, "flash_attention_qkv_fwd"),
                          (fa, "flash_attention_qkv_bwd"),
                          (k1, "spatial_attention"),
                          (k1, "spatial_attention_pipe"),
                          (k1, "spatial_attention_fwd_probs"),
                          (k1, "spatial_attention_bwd"),
                          (k1, "spatial_attention_bwd_recompute"),
                          (k1, "spatial_attention_bwd_delta")):
            fn = getattr(mod, name)
            m.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw: (
                seen.append(_n) or _f(*a, **kw)))
        a = qkv.clone().requires_grad_(True)
        out, out_c = k1.spatial_attention_autograd(a, qkv_c, heads,
                                                   D ** -0.5, route)
        (out * g).sum().backward()
        with torch.no_grad():
            k1.spatial_attention_autograd(qkv, qkv_c, heads, D ** -0.5, route)
    pair = {"flash_attention_qkv_fwd", "flash_attention_qkv_bwd"}
    assert (pair.isdisjoint(seen) if own else set(seen) == pair), seen
    ref, ref_c = k1.spatial_attention_plain(qkv, qkv_c, heads, D ** -0.5)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(out_c.detach().numpy(), ref_c.numpy(), **TOL)
    want, _ = k1.spatial_attention_bwd_recompute_plain(
        qkv, qkv_c, g, torch.zeros(1, 1, c), heads, D ** -0.5)
    np.testing.assert_allclose(a.grad.numpy(), want.numpy(), **GRAD_TOL)


def test_the_qkv_layout_is_k3_on_the_thirds():
    """K1's long range in the fused layout is K3 on the column thirds of
    qkv and qkv_c, forward and backward."""
    rng = np.random.RandomState(3)
    heads, n = 2, 40
    c = heads * D
    qkv = torch.from_numpy(rng.randn(2, n, 3 * c).astype(np.float32))
    qkv_c = torch.from_numpy(rng.randn(2, 1, 3 * c).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, n, c).astype(np.float32))
    gc = torch.from_numpy(rng.randn(2, 1, c).astype(np.float32))
    thirds = [*qkv.split(c, -1), *qkv_c.split(c, -1)]
    out, out_c, rowsum = fa.flash_attention_qkv_fwd(qkv, qkv_c, heads, 0.125)
    want = fa.flash_attention_cls_fwd(*thirds, heads, 0.125)
    for a, r in zip((out, out_c, rowsum), want):
        assert torch.equal(a, r)
    assert rowsum.shape == (2, heads, n + 1)
    dqkv, dqkv_c = fa.flash_attention_qkv_bwd(qkv, qkv_c, g, gc, rowsum,
                                              heads, 0.125)
    grads = fa.flash_attention_cls_bwd(*thirds, g, gc, rowsum, heads, 0.125)
    assert torch.equal(dqkv, torch.cat(grads[:3], -1))
    assert torch.equal(dqkv_c, torch.cat(grads[3:], -1))


@pytest.mark.parametrize("bad", ["width", "cls", "dtype"])
def test_the_wrappers_check_their_inputs(bad):
    q = torch.zeros(2, 8, 128)
    cls = [torch.zeros(2, 1, 128) for _ in range(3)]
    if bad == "width":
        with pytest.raises(ValueError, match="heads"):
            fa.flash_attention(q, q, q, 3, 0.125)
    elif bad == "cls":
        with pytest.raises(ValueError, match=r"\[B, 1, C\]"):
            fa.flash_attention_cls(q, q, q, cls[0], cls[1], q, 2, 0.125)
    else:
        with pytest.raises(ValueError, match="dtype"):
            fa.flash_attention_cls(q, q, q.double(), *cls, 2, 0.125)
