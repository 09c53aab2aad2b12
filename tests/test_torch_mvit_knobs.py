"""K5bd, K6bd, K6sp and K6bs of the PyTorch port (the MViT knob variants of
``MVIT_DELTA=1`` and ``MVIT_SAVE_PROBS=1``) against the JAX package.

The port's plain versions are held against the JAX functions that reach
those Pallas kernels, run in interpret mode: ``_bwd_hl_delta`` (K5bd),
``_bwd_delta`` (K6bd), ``_fwd(save_probs=True)`` (K6sp) and ``_bwd_saved``
(K6bs).  The inputs are those of ``tests/test_torch_mvit_attention.py``
(B = 2, H = 2 heads of 96, qN = 70, key grid (2, 3, 4), so kN + 1 = 25 is
ragged against both the port's 8-column probability rows and JAX's 128;
one query row's logits pass 80, the others stay below).  The saved
probabilities are compared on their kN + 1 valid columns.  Tolerance: fp32
atol = rtol = 2e-5, gradients 5e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procedurevrl_tpu.ops import pallas_mvit_attention as pm
from procedurevrl_torch.ops import mvit_attention as ma
from test_torch_mvit_attention import (
    ARGS, B, H, K_SHAPE, KN, QN, SCALE, TOL, _fold, _inputs, _torch,
)

GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
GRADS = ("dq", "dk", "dv", "dkc", "dvc", "drel")


def _jax(x, *keys):
    return [jnp.asarray(x[k]) for k in keys]


def _check_grads(got, want):
    for name, a, b in zip(GRADS, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)


def test_k5bd_plain_matches_jax():
    x = _inputs(11)
    o = np.array(pm._fwd_hl(*_jax(x, *ARGS), K_SHAPE, H, SCALE))
    want = pm._bwd_hl_delta(*_jax(x, *ARGS), jnp.asarray(o), K_SHAPE, H,
                            SCALE, jnp.asarray(x["g"]))
    t = _torch(x)
    _, rowsum = ma.mvit_attention_hl_fwd_plain(*(t[k] for k in ARGS),
                                               K_SHAPE, H, SCALE)
    got = ma.mvit_attention_hl_bwd_delta_plain(
        *(t[k] for k in ARGS), rowsum, torch.from_numpy(o), t["g"], K_SHAPE,
        H, SCALE)
    _check_grads(got, want)


def test_k6bd_plain_matches_jax():
    x = {k: _fold(v) for k, v in _inputs(12).items()}
    o = np.array(pm._fwd(*_jax(x, *ARGS), K_SHAPE, SCALE))
    want = pm._bwd_delta(*_jax(x, *ARGS), jnp.asarray(o), K_SHAPE, SCALE,
                         jnp.asarray(x["g"]))
    t = _torch(x)
    _, rowsum = ma.mvit_attention_fwd_plain(*(t[k] for k in ARGS), K_SHAPE,
                                            SCALE)
    got = ma.mvit_attention_bwd_delta_plain(
        *(t[k] for k in ARGS), rowsum, torch.from_numpy(o), t["g"], K_SHAPE,
        SCALE)
    _check_grads(got, want)


def test_k6sp_plain_matches_jax():
    x = {k: _fold(v) for k, v in _inputs(13).items()}
    ref, ref_p = pm._fwd(*_jax(x, *ARGS), K_SHAPE, SCALE, save_probs=True)
    t = _torch(x)
    out, rowsum, probs = ma.mvit_attention_fwd_probs_plain(
        *(t[k] for k in ARGS), K_SHAPE, SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert probs.shape == (B * H, QN, ma.probs_stride(KN)) == (B * H, QN, 32)
    np.testing.assert_allclose(probs[..., :KN + 1].numpy(),
                               np.asarray(ref_p)[..., :KN + 1], **TOL)
    assert not probs[..., KN + 1:].any()
    # the cls key is column kN and carries weight on every row
    assert (probs[..., KN] > 0).all()
    # K6f's outputs and row sums are K6sp's
    out6, rs6 = ma.mvit_attention_fwd_plain(*(t[k] for k in ARGS), K_SHAPE,
                                            SCALE)
    assert torch.equal(out6, out) and torch.equal(rs6, rowsum)


def test_k6bs_plain_matches_jax():
    x = {k: _fold(v) for k, v in _inputs(14).items()}
    _, ref_p = pm._fwd(*_jax(x, *ARGS), K_SHAPE, SCALE, save_probs=True)
    want = pm._bwd_saved(*_jax(x, *ARGS), ref_p, K_SHAPE, SCALE,
                         jnp.asarray(x["g"]))
    t = _torch(x)
    _, _, probs = ma.mvit_attention_fwd_probs_plain(*(t[k] for k in ARGS),
                                                    K_SHAPE, SCALE)
    got = ma.mvit_attention_bwd_probs(*(t[k] for k in ARGS), probs, t["g"],
                                      K_SHAPE, SCALE)
    _check_grads(got, want)


# (head_last, MVIT_DELTA, MVIT_SAVE_PROBS) -> the forward and backward
# wrappers the entry calls under grad (JAX _vjp_fwd / _vjp_hl_fwd)
ROUTES = {
    (True, False, False): ("mvit_attention_hl_fwd", "mvit_attention_hl_bwd"),
    (True, True, False): ("mvit_attention_hl_fwd",
                          "mvit_attention_hl_bwd_delta"),
    (True, False, True): ("mvit_attention_hl_fwd", "mvit_attention_hl_bwd"),
    (True, True, True): ("mvit_attention_hl_fwd",
                         "mvit_attention_hl_bwd_delta"),
    (False, False, False): ("mvit_attention_fwd", "mvit_attention_bwd"),
    (False, True, False): ("mvit_attention_fwd", "mvit_attention_bwd_delta"),
    (False, False, True): ("mvit_attention_fwd_probs",
                           "mvit_attention_bwd_probs"),
    (False, True, True): ("mvit_attention_fwd_probs",
                          "mvit_attention_bwd_probs"),
}
WRAPPERS = ("mvit_attention_hl_fwd", "mvit_attention_hl_bwd",
            "mvit_attention_hl_bwd_delta", "mvit_attention_fwd",
            "mvit_attention_bwd", "mvit_attention_bwd_delta",
            "mvit_attention_fwd_probs", "mvit_attention_bwd_probs")


@pytest.mark.parametrize("route", sorted(ROUTES),
                         ids=lambda r: "hl%d_delta%d_save%d" % r)
def test_entries_take_the_knob_kernels(route, monkeypatch):
    head_last, delta, save_probs = route
    seen = []
    for name in WRAPPERS:
        fn = getattr(ma, name)
        monkeypatch.setattr(ma, name, lambda *a, _f=fn, _n=name:
                            seen.append(_n) or _f(*a))
    x = _inputs(15)
    if not head_last:
        x = {k: _fold(v) for k, v in x.items()}
    t = {k: v.requires_grad_(k in ARGS) for k, v in _torch(x).items()}
    args = [t[k] for k in ARGS]
    if head_last:
        out = ma.mvit_attention_hl(*args, K_SHAPE, H, SCALE, delta)
    else:
        out = ma.mvit_attention(*args, K_SHAPE, SCALE, delta, save_probs)
    out.backward(t["g"])
    assert seen == list(ROUTES[route])
    seen.clear()
    with torch.no_grad():
        if head_last:
            ma.mvit_attention_hl(*args, K_SHAPE, H, SCALE, delta)
        else:
            ma.mvit_attention(*args, K_SHAPE, SCALE, delta, save_probs)
    # without grad every route is the plain forward (JAX's primal)
    assert seen == ["mvit_attention_hl_fwd" if head_last
                    else "mvit_attention_fwd"]


def test_k6bs_wrapper_checks_the_probabilities():
    x = _torch({k: _fold(v) for k, v in _inputs(16).items()})
    with pytest.raises(ValueError, match="probs"):
        ma.mvit_attention_bwd_probs(*(x[k] for k in ARGS),
                                    torch.zeros(B * H, QN, KN + 1), x["g"],
                                    K_SHAPE, SCALE)
