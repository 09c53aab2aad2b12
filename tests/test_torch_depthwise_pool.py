"""K8 of the PyTorch port (MViT's depthwise 3x3x3 attention pool) against
the JAX package.

The port's plain versions (and ``DepthwisePool3DFunction``, which on the
CPU runs them) are held against ``pallas_pool.depthwise_pool3d`` with the
Pallas kernel in interpret mode, forward and ``jax.grad`` with respect to x
and w27, on ``[2, 4, 10, 10, C]`` with C in {64, 160} (160 crosses the
JAX kernel's 128-lane chunk boundary) at strides 1 and 2.  The JAX
``DepthwisePool3D`` module never reaches the kernel in these tests: the
conftest's 8 host devices fail its ``jax.device_count() == 1`` gate, so
under ``MVIT_POOL=kernel`` it runs the conv, the same function (and
``tests/test_pallas_pool.py::test_model_pool_knob_matches_conv`` compares
the conv with itself); the port's module is held against it all the same.
Tolerances: forward fp32 atol = rtol = 2e-5, gradients 5e-5 (as the JAX
pool tests).  The CUDA kernels' tiling is planned in Python
(``pool_plan``), so its coverage is held here: every output of the five
stride-1 pool shapes of the MViT-v2-S training step and of the edge cases
is written exactly once, within the kernels' thread and shared-memory
limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.models import mvit as jm
from procedurevrl_tpu.ops import pallas_pool
from procedurevrl_torch.config import get_cfg
from procedurevrl_torch.models import mvit as pm
from procedurevrl_torch.ops import depthwise_pool as dp
from procedurevrl_torch.utils import weights

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
B, T, H, W = 2, 4, 10, 10


def _inputs(seed, c, s):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, H, W, c).astype(np.float32)
    w = (0.3 * rng.randn(27, c)).astype(np.float32)
    g = rng.randn(B, T, dp.out_hw(H, s), dp.out_hw(W, s), c).astype(
        np.float32)
    return x, w, g


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("c", [64, 160])
def test_plain_forward_matches_jax(s, c):
    x, w, _ = _inputs(c + s, c, s)
    ref = pallas_pool.depthwise_pool3d(jnp.asarray(x), jnp.asarray(w), s,
                                       True)
    out = dp.depthwise_pool3d_fwd(torch.from_numpy(x), torch.from_numpy(w), s)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("c", [64, 160])
def test_grads_match_jax_grad(s, c):
    """dx and dw through the port's autograd Function (at s = 1 the K8 pair
    on the CPU: the forward with reversed taps and the plain dw; at s = 2
    the tap formulas) against ``jax.vjp`` of the JAX op."""
    x, w, g = _inputs(10 + c + s, c, s)
    _, vjp = jax.vjp(lambda a, b: pallas_pool.depthwise_pool3d(a, b, s, True),
                     jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    dp.depthwise_pool3d(xt, wt, s).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rdx), **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(rdw), **GRAD_TOL)


def test_stride1_dx_is_the_forward_with_reversed_taps():
    """The Function's stride-1 dx is K8f's plain version on g with
    ``w27.flip(0)`` exactly, and the transposed pool of the tap formulas."""
    x, w, g = _inputs(3, 64, 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt, gt = torch.from_numpy(w), torch.from_numpy(g)
    dp.depthwise_pool3d(xt, wt, 1).backward(gt)
    assert torch.equal(xt.grad, dp.depthwise_pool3d_taps(gt, wt.flip(0),
                                                         (1, 1, 1)))
    assert torch.equal(xt.grad, dp.depthwise_pool3d_dx(gt, wt))
    torch.testing.assert_close(xt.grad, dp.taps_dx(gt, wt, (1, 1, 1),
                                                   (T, H, W)), **FWD_TOL)


@pytest.mark.parametrize("s", [1, 4, 8])
def test_taps_match_the_conv(s):
    """The plain forward and dw at every kernel stride against PyTorch's
    depthwise conv3d on the [B, C, T, H, W] layout."""
    x, w, g = _inputs(20 + s, 16, s)
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    wc = wt.t().reshape(16, 1, 3, 3, 3)
    xc = xt.permute(0, 4, 1, 2, 3).requires_grad_(True)
    wc.requires_grad_(True)
    ref = torch.nn.functional.conv3d(xc, wc, None, (1, s, s), 1, groups=16)
    torch.testing.assert_close(dp.depthwise_pool3d_taps(xt, wt, (1, s, s)),
                               ref.permute(0, 2, 3, 4, 1), **FWD_TOL)
    ref.backward(gt.permute(0, 4, 1, 2, 3))
    torch.testing.assert_close(dp.taps_dw(xt, gt, (1, s, s)),
                               wc.grad.reshape(16, 27).t(), **GRAD_TOL)
    torch.testing.assert_close(dp.taps_dx(gt, wt, (1, s, s), (T, H, W)),
                               xc.grad.permute(0, 2, 3, 4, 1), **GRAD_TOL)


def test_the_qkv_view_needs_no_copy():
    """The model hands the pool a view of its fused qkv product (token-row
    stride 3C); the kernels' geometry takes it as it is, and the plain
    forward of the view equals that of a contiguous copy."""
    c, thw = 32, (2, 5, 6)
    qkv = torch.randn(2, 1 + 60, 3 * c)
    k = qkv.chunk(3, dim=-1)[1][:, 1:].reshape(2, *thw, c)
    assert not k.is_contiguous()
    assert dp._geometry(k) == (3 * c, 61 * 3 * c)
    w = torch.randn(27, c)
    assert torch.equal(dp.depthwise_pool3d_taps(k, w, (1, 1, 1)),
                       dp.depthwise_pool3d_taps(k.contiguous(), w, (1, 1, 1)))
    with pytest.raises(ValueError, match="evenly spaced"):
        dp._geometry(k.transpose(2, 3))


@pytest.mark.parametrize("thw", [(1, 1, 1), (2, 1, 1), (1, 3, 1), (1, 1, 4),
                                 (3, 1, 5), (2, 5, 1)])
def test_the_qkv_view_with_unit_axes_needs_no_copy(thw):
    """An axis of length 1 is never stepped, so its stride says nothing:
    the kernels' geometry takes the qkv view at any (T, H, W), the row
    stride from the innermost longer axis (3C; C with none)."""
    c, n = 16, thw[0] * thw[1] * thw[2]
    qkv = torch.randn(2, 1 + n, 3 * c)
    k = qkv.chunk(3, dim=-1)[1][:, 1:].reshape(2, *thw, c)
    assert dp._geometry(k) == (3 * c if n > 1 else c, (1 + n) * 3 * c)


# the five stride-1 pools of the MViT-v2-S training step ([H, W, C] of
# blocks 0, 2, 4-13, 14 and 15) and the edge cases of the kernels' tiling:
# C = 8 and 40 (not a multiple of the 32-channel slice), H = W = 1, an odd
# W that is not a multiple of the 7-column strip, a band that does not
# divide H, a row wider than one CTA
PLAN_GEOMS = {"block 0": (56, 56, 96), "block 2": (28, 28, 192),
              "block 4": (14, 14, 384), "block 14": (14, 14, 768),
              "block 15": (7, 7, 768), "C 8": (9, 11, 8), "C 40": (10, 13, 40),
              "H W 1": (1, 1, 32), "odd W": (5, 9, 64), "band": (61, 23, 32),
              "wide": (3, 300, 16)}


@pytest.mark.parametrize("kind", ["fwd 1", "fwd 2", "fwd 4", "fwd 8", "dw"])
@pytest.mark.parametrize("geom", sorted(PLAN_GEOMS))
def test_the_plan_covers_every_output_once(geom, kind):
    h, w, c = PLAN_GEOMS[geom]
    dw = kind == "dw"
    s = 1 if dw else int(kind.split()[1])
    for esize in (2, 4):
        plan = dp.pool_plan(h, w, c, s, esize, dw)
        cover = dp.plan_cover(plan, dp.out_hw(h, s), dp.out_hw(w, s), c)
        assert bool((cover == 1).all()), (plan, esize)
        assert plan.threads <= dp.MAX_THREADS
        smem = dp.smem_bytes(plan.band, plan.strips, s, esize, dw)
        assert smem <= dp.SMEM_MAX
        assert smem <= dp.RING_BYTES or plan.band == plan.strips == 1


def test_wrappers_check_their_inputs():
    x = torch.zeros(1, 2, 4, 4, 8)
    with pytest.raises(ValueError, match=r"\[27, C\]"):
        dp.depthwise_pool3d_fwd(x, torch.zeros(9, 8), 1)
    with pytest.raises(ValueError, match="stride 3"):
        dp.depthwise_pool3d_fwd(x, torch.zeros(27, 8), 3)
    with pytest.raises(ValueError, match="differ"):
        dp.depthwise_pool3d_dw(x, torch.zeros(1, 2, 4, 4, 16))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        dp._check_kernel(x, torch.zeros(27, 8))


def test_supported_gate_matches_jax():
    for kernel, stride in [((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (1, 2, 2)),
                           ((3, 3, 3), (1, 8, 8)), ((3, 3, 3), (2, 1, 1)),
                           ((3, 3, 3), (1, 2, 1)), ((3, 3, 3), (1, 3, 3)),
                           ((1, 3, 3), (1, 1, 1)), ((3, 3, 3), (1, 16, 16))]:
        assert dp.supported(kernel, stride) == pallas_pool.supported(
            kernel, stride), (kernel, stride)


@pytest.mark.parametrize("route", ["kernel", "taps"])
def test_module_route_matches_jax_module(route, monkeypatch):
    """``DepthwisePool3D`` on the pool-op route, 2 heads of 64, against the
    JAX module with ``MVIT_POOL`` set (which runs the conv here, see the
    module docstring): values and the gradients of x and of the
    head-shared weight, whose JAX tree is converted by ``utils/weights``."""
    monkeypatch.setenv("MVIT_POOL", route)
    heads, hd = 2, 64
    jmod = jm.DepthwisePool3D(hd, (3, 3, 3), (1, 1, 1), jnp.float32,
                              heads=heads)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 14, 14, heads * hd).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out, vjp = jax.vjp(lambda p, a: jmod.apply(p, a), params, jnp.asarray(x))
    jgrads, jdx = vjp(jnp.asarray(g))

    port = pm.DepthwisePool3D(hd, (3, 3, 3), (1, 1, 1), heads, route)
    port.weight.data = weights._conv(np.asarray(params["params"]["kernel"]))
    assert port.takes_pool_op()
    seen = []
    orig = dp.DepthwisePool3DFunction.apply
    monkeypatch.setattr(dp.DepthwisePool3DFunction, "apply",
                        lambda *a: seen.append(a[3]) or orig(*a))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt)
    assert seen == [route == "kernel"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **GRAD_TOL)
    np.testing.assert_allclose(
        port.weight.grad.numpy(),
        weights._conv(np.asarray(jgrads["params"]["kernel"])).numpy(),
        **GRAD_TOL)


def test_module_route_gate(monkeypatch):
    """Only stride-1 3x3x3 pools on the kernel or taps route, in a process
    that is not one of a distributed group of more than one, take the pool
    op; the rest stay on conv3d."""
    take = lambda stride, route: pm.DepthwisePool3D(
        8, (3, 3, 3), stride, 2, route).takes_pool_op()
    assert take((1, 1, 1), "kernel") and take((1, 1, 1), "taps")
    assert not take((1, 1, 1), "conv")
    assert not take((1, 2, 2), "kernel") and not take((1, 8, 8), "taps")
    assert not pm.DepthwisePool3D(8, (1, 3, 3), (1, 1, 1), 2,
                                  "kernel").takes_pool_op()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    assert not take((1, 1, 1), "kernel")
    with pytest.raises(ValueError, match="pool route"):
        pm.DepthwisePool3D(8, (3, 3, 3), (1, 1, 1), 2, "conv3d")


@pytest.mark.parametrize("value,route", [(None, "conv"), ("", "conv"),
                                         ("conv", "conv"),
                                         ("kernel", "kernel"),
                                         ("taps", "taps")])
def test_the_knob_is_read_when_the_config_is_built(value, route, monkeypatch):
    if value is None:
        monkeypatch.delenv("MVIT_POOL", raising=False)
    else:
        monkeypatch.setenv("MVIT_POOL", value)
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "MViT"
    assert pm.MViTConfig.from_cfg(cfg).route.pool == route


@pytest.mark.parametrize("value", ["Kernel", "pallas", "1"])
def test_an_unknown_pool_route_raises(value, monkeypatch):
    monkeypatch.setenv("MVIT_POOL", value)
    with pytest.raises(ValueError, match="MVIT_POOL"):
        pm.MViTConfig.from_cfg(get_cfg())
