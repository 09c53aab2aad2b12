"""The BatchNorm video family: SlowFast, Slow / C2D / I3D (``ResNet``) and
X3D (counterpart of ``procedurevrl_tpu/models/resnet_video.py``; reference
``lib/models/video_model_builder.py:152,424,623`` with
``resnet_helper.py``, ``stem_helper.py``, ``head_helper.py``,
``nonlocal_helper.py``, ``operators.py``, ``batchnorm_helper.py``).

Layout: the model takes JAX's ``[B, T, H, W, C]`` clip, splits it into
pathways (:func:`pack_pathways`) and copies each to a contiguous
``[B, C, T, H, W]`` (NCDHW) once; every layer after that stays NCDHW.
NCDHW is the reference's layout, so the parameters keep its shapes and
names (``s1.pathway0_stem.conv.weight``, ``s2.pathway0_res0.branch2.a_bn.
running_mean``, ``headClassification.projection.weight`` ...) and
``procedurevrl_tpu/utils/converter.py:convert_resnet_video`` reads the
port's ``state_dict()`` as a reference file; it is also the layout
``F.conv3d`` takes without a copy on both devices (a channels-last 3-D
layout for cuDNN is untried).  No layer of
the family reaches a Pallas kernel in JAX: convolutions, pools and the
non-local products are PyTorch calls here, in the compute dtype with the
float32 weights cast at each product, as flax's ``dtype``.

BatchNorm is :class:`VideoBatchNorm`, a plain function on tensors with
float32 statistics (not ``nn.BatchNorm3d``'s update): over the global
batch with ``splits == 1``, over ``splits`` contiguous groups of it
otherwise (``parallel/collectives.py:batch_norm_stats``, which all-reduces
in a group of processes, so N ranks normalise as one process would); the
torch momentum convention, the unbiased variance of the group's count for
the running variance, and at eval the split statistics aggregated
(mean of means, mean of variances plus the variance of the means).  The
running statistics are buffers (``running_mean``, ``running_var``: ``[C]``,
or ``[splits, C]``) updated in place by a train-mode forward, once per
call.  ``BN.FROZEN`` normalises with them in train mode too and never
updates them.

Random draws (drop-connect of ``MODEL.DROPCONNECT_RATE`` over the batch,
the heads' dropout) come from the step's ``droppath`` and ``dropout``
generators at the global batch's shape (``draw_rows``, F11).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from procedurevrl_torch.parallel.collectives import (
    batch_norm_stats, draw_rows,
)

Gens = Optional[Dict[str, torch.Generator]]

# blocks per stage of a depth (reference video_model_builder.py:26)
_MODEL_STAGE_DEPTH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# temporal kernel basis per arch (reference video_model_builder.py:29-79)
_TEMPORAL_KERNEL_BASIS = {
    "c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d_nopool": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "i3d_nopool": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow": [[[1]], [[1]], [[1]], [[3]], [[3]]],
    "slowfast": [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]],
    "x3d": [[[5]], [[3]], [[3]], [[3]], [[3]]],
}

# the max pool after res2 per arch (reference video_model_builder.py:81-89)
_POOL1 = {
    "c2d": [[2, 1, 1]],
    "c2d_nopool": [[1, 1, 1]],
    "i3d": [[2, 1, 1]],
    "i3d_nopool": [[1, 1, 1]],
    "slow": [[1, 1, 1]],
    "slowfast": [[1, 1, 1], [1, 1, 1]],
    "x3d": [[1, 1, 1]],
}


def round_width(width, multiplier, min_width=8, divisor=8) -> int:
    """Filter-width rounding (reference video_model_builder.py:671-683,
    operators.py:38-57)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def pack_pathways(frames: torch.Tensor, arch: str, alpha: int,
                  reverse_channels: bool = False) -> List[torch.Tensor]:
    """``[B, T, H, W, C]`` -> the pathway inputs, each ``[B, T', H, W,
    C]``: the clip itself, and for SlowFast first its ``T // alpha`` frames
    at ``floor(linspace(0, T - 1, T // alpha))`` (the reference's
    ``torch.linspace(...).long()``, ``lib/datasets/utils.py:74-107``; JAX
    ``pack_pathways``)."""
    if reverse_channels:
        frames = frames.flip(-1)
    if arch in _POOL1 and arch != "slowfast":
        return [frames]
    t = frames.shape[1]
    idx = np.floor(np.linspace(0, t - 1, t // alpha)).astype(np.int64)
    return [frames[:, torch.from_numpy(idx).to(frames.device)], frames]


# ------------------------------------------------------------------ norms


def _at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 if it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def video_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, train: bool, splits: int = 1,
                     momentum: float = 0.1, eps: float = 1e-5
                     ) -> torch.Tensor:
    """BatchNorm of ``x [B, C, T, H, W]`` per channel in float32, output in
    x's dtype (JAX ``VideoBatchNorm.__call__``).  ``train``: the batch's
    statistics (per split), and the running buffers updated in place:
    ``(1 - m) old + m batch``, the variance unbiased over the split's count;
    else the running statistics, split ones aggregated."""
    xf = _at_least_fp32(x)
    c = x.shape[1]
    if train:
        mean, var, n, groups = batch_norm_stats(xf, splits)
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            rm, rv = mean.detach(), unbiased.detach()
            if splits == 1:
                rm, rv = rm[0], rv[0]
            running_mean.mul_(1 - momentum).add_(momentum * rm)
            running_var.mul_(1 - momentum).add_(momentum * rv)
        if splits == 1:
            mean, var = mean[0], var[0]
            shape = (1, c) + (1,) * (x.dim() - 2)
            x_hat = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
        else:
            shape = (x.shape[0], c) + (1,) * (x.dim() - 2)
            x_hat = ((xf - mean[groups].view(shape))
                     * torch.rsqrt(var[groups].view(shape) + eps))
    else:
        mean, var = running_mean, running_var
        if splits > 1:
            agg = mean.mean(dim=0)
            var = var.mean(dim=0) + (mean - agg).square().mean(dim=0)
            mean = agg
        shape = (1, c) + (1,) * (x.dim() - 2)
        x_hat = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return (x_hat * weight.view(shape) + bias.view(shape)).to(x.dtype)


class VideoBatchNorm(nn.Module):
    """The parameters and running statistics of one BatchNorm (the
    reference's ``BatchNorm3d`` names, without ``num_batches_tracked``);
    the forward is :func:`video_batch_norm`."""

    def __init__(self, channels: int, splits: int = 1, frozen: bool = False,
                 zero_init: bool = False, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.splits, self.frozen, self.zero_init = splits, frozen, zero_init
        self.momentum, self.eps = momentum, eps
        stat = (splits, channels) if splits > 1 else (channels,)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(stat))
        self.register_buffer("running_var", torch.ones(stat))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_init else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return video_batch_norm(x, self.weight, self.bias, self.running_mean,
                                self.running_var, train and not self.frozen,
                                self.splits, self.momentum, self.eps)


def get_norm_builder(norm_type: str, num_splits: int, num_groups: int,
                     frozen: bool = False) -> Callable[..., VideoBatchNorm]:
    """``norm(channels, zero_init=False)`` of a norm type (reference
    ``batchnorm_helper.py:14-33``, JAX ``get_norm_builder``): ``batchnorm``
    the global batch, ``sub_batchnorm`` ``NUM_SPLITS`` groups,
    ``sync_batchnorm`` ``world // NUM_SYNC_DEVICES`` groups."""
    splits = {"batchnorm": 1, "sub_batchnorm": num_splits,
              "sync_batchnorm": max(1, num_groups)}
    if norm_type not in splits:
        raise NotImplementedError(f"Norm type {norm_type} is not supported")
    return partial(VideoBatchNorm, splits=splits[norm_type], frozen=frozen)


# -------------------------------------------------------------- operators


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (reference operators.py:9-32)."""
    return F.silu(x)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` (bias off unless asked) whose float32 weights are cast
    to the input's dtype at the product; ``padding`` defaults to k // 2."""

    def __init__(self, dim_in: int, dim_out: int, kernel, stride=(1, 1, 1),
                 padding=None, groups: int = 1, dilation=(1, 1, 1),
                 bias: bool = False):
        kernel = tuple(kernel)
        if padding is None:
            padding = tuple(k // 2 for k in kernel)
        super().__init__(dim_in, dim_out, kernel, tuple(stride),
                         tuple(padding), tuple(dilation), groups, bias)

    def reset_parameters(self, generator=None) -> None:
        """c2_msra_fill (reference weight_init_helper.py:17-26; JAX
        ``msra_init``): normal of std sqrt(2 / fan_out), zero bias."""
        fan_out = self.weight.shape[0] * int(np.prod(self.weight.shape[2:]))
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        self.stride, self.padding, self.dilation, self.groups)


def max_pool3d(x: torch.Tensor, window, stride=None, padding=(0, 0, 0)
               ) -> torch.Tensor:
    """MaxPool3d over (T, H, W) with symmetric -inf padding; a unit window
    is the identity."""
    if all(w == 1 for w in window):
        return x
    return F.max_pool3d(x, tuple(window), tuple(stride or window),
                        tuple(padding))


def dropout(x: torch.Tensor, rate: float, train: bool, gens: Gens
            ) -> torch.Tensor:
    """flax ``Dropout``: keep each value with 1 - rate, scaled by
    1 / (1 - rate); the mask drawn from the ``dropout`` generator at the
    global batch's shape."""
    if not train or rate <= 0.0:
        return x
    gen = None if gens is None else gens["dropout"]
    keep = 1.0 - rate
    u = draw_rows(lambda n: torch.rand((n,) + tuple(x.shape[1:]),
                                       generator=gen, device=x.device),
                  x.shape[0])
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class SE(nn.Module):
    """Squeeze-and-Excitation (reference operators.py:35-81): the mean
    over (T, H, W), two 1x1x1 convolutions with bias."""

    def __init__(self, dim_in: int, ratio: float, relu_act: bool = True):
        super().__init__()
        dim_fc = round_width(dim_in, ratio)
        self.relu_act = relu_act
        self.fc1 = Conv3d(dim_in, dim_fc, (1, 1, 1), bias=True)
        self.fc2 = Conv3d(dim_fc, dim_in, (1, 1, 1), bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc1(x.mean(dim=(2, 3, 4), keepdim=True))
        s = F.relu(s) if self.relu_act else swish(s)
        return x * torch.sigmoid(self.fc2(s))


# ----------------------------------------------- transformation functions


class BasicTransform(nn.Module):
    """Tx3x3 + 1x3x3 (reference resnet_helper.py:37-120)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride,
                 dim_inner=None, num_groups=1, stride_1x1=False, dilation=1,
                 norm=VideoBatchNorm, zero_init_final_bn=False, block_idx=0):
        super().__init__()
        tk = temp_kernel_size
        self.a = Conv3d(dim_in, dim_out, (tk, 3, 3), (1, stride, stride),
                        (tk // 2, 1, 1))
        self.a_bn = norm(dim_out)
        self.b = Conv3d(dim_out, dim_out, (1, 3, 3), (1, 1, 1), (0, 1, 1))
        self.b_bn = norm(dim_out, zero_init=zero_init_final_bn)

    def forward(self, x, train):
        x = F.relu(self.a_bn(self.a(x), train))
        return self.b_bn(self.b(x), train)


class BottleneckTransform(nn.Module):
    """Tx1x1 + 1x3x3 + 1x1x1 (reference resnet_helper.py:263-396)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups=1, stride_1x1=False, dilation=1,
                 norm=VideoBatchNorm, zero_init_final_bn=False, block_idx=0):
        super().__init__()
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        tk, d = temp_kernel_size, dilation
        self.a = Conv3d(dim_in, dim_inner, (tk, 1, 1), (1, s1, s1),
                        (tk // 2, 0, 0))
        self.a_bn = norm(dim_inner)
        self.b = Conv3d(dim_inner, dim_inner, (1, 3, 3), (1, s3, s3),
                        (0, d, d), groups=num_groups, dilation=(1, d, d))
        self.b_bn = norm(dim_inner)
        self.c = Conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out, zero_init=zero_init_final_bn)

    def forward(self, x, train):
        x = F.relu(self.a_bn(self.a(x), train))
        x = F.relu(self.b_bn(self.b(x), train))
        return self.c_bn(self.c(x), train)


class X3DTransform(nn.Module):
    """1x1x1 + Tx3x3 channelwise (+ SE on every other block) + swish +
    1x1x1 (reference resnet_helper.py:123-261)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                 num_groups=1, stride_1x1=False, dilation=1,
                 norm=VideoBatchNorm, zero_init_final_bn=False, block_idx=0,
                 se_ratio=0.0625, swish_inner=True):
        super().__init__()
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        tk, d = temp_kernel_size, dilation
        self.swish_inner = swish_inner
        self.a = Conv3d(dim_in, dim_inner, (1, 1, 1), (1, s1, s1))
        self.a_bn = norm(dim_inner)
        self.b = Conv3d(dim_inner, dim_inner, (tk, 3, 3), (1, s3, s3),
                        (tk // 2, d, d), groups=num_groups, dilation=(1, d, d))
        self.b_bn = norm(dim_inner)
        self.se = (SE(dim_inner, se_ratio)
                   if se_ratio > 0.0 and (block_idx + 1) % 2 else None)
        self.c = Conv3d(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out, zero_init=zero_init_final_bn)

    def forward(self, x, train):
        x = F.relu(self.a_bn(self.a(x), train))
        x = self.b_bn(self.b(x), train)
        if self.se is not None:
            x = self.se(x)
        x = swish(x) if self.swish_inner else F.relu(x)
        return self.c_bn(self.c(x), train)


_TRANS_FUNCS = {"bottleneck_transform": BottleneckTransform,
                "basic_transform": BasicTransform,
                "x3d_transform": X3DTransform}


def get_trans_func(name: str):
    """reference resnet_helper.py:20-32."""
    if name not in _TRANS_FUNCS:
        raise NotImplementedError(
            f"Transformation function '{name}' not supported")
    return _TRANS_FUNCS[name]


# -------------------------------------------------------------- non-local


class Nonlocal(nn.Module):
    """Non-local block (reference nonlocal_helper.py:9-147): theta over
    every position, phi and g over the (max-pooled) positions, softmax or
    dot-product normalisation in float32, the output conv, BN and the
    residual."""

    def __init__(self, dim, dim_inner, pool_size=None,
                 instantiation="softmax", zero_init_final_norm=True,
                 norm=VideoBatchNorm, zero_init_final_bn=False):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(f"Unknown norm type {instantiation}")
        self.dim_inner, self.instantiation = dim_inner, instantiation
        self.pool_size = (tuple(pool_size) if pool_size is not None
                          and any(s > 1 for s in pool_size) else None)
        conv = partial(Conv3d, kernel=(1, 1, 1), bias=True)
        self.conv_theta = conv(dim, dim_inner)
        self.conv_phi = conv(dim, dim_inner)
        self.conv_g = conv(dim, dim_inner)
        self.conv_out = conv(dim_inner, dim)
        self.bn = norm(dim, zero_init=zero_init_final_norm
                       and zero_init_final_bn)

    def forward(self, x, train):
        b, _, t, h, w = x.shape
        theta = self.conv_theta(x).flatten(2)              # [b, ci, thw]
        xp = x if self.pool_size is None else max_pool3d(x, self.pool_size)
        phi = self.conv_phi(xp).flatten(2)                 # [b, ci, p]
        g = self.conv_g(xp).flatten(2)
        attn = torch.einsum("bct,bcp->btp", _at_least_fp32(theta),
                            _at_least_fp32(phi))
        if self.instantiation == "softmax":
            attn = torch.softmax(attn * self.dim_inner ** -0.5, dim=2)
        else:
            attn = attn / phi.shape[2]
        out = torch.einsum("btp,bcp->bct", attn, _at_least_fp32(g)).to(
            x.dtype)
        out = self.conv_out(out.reshape(b, self.dim_inner, t, h, w))
        return x + self.bn(out, train)


# ------------------------------------------------- residual blocks, stages


class ResBlock(nn.Module):
    """Residual block with a projection shortcut where the shape changes
    (reference resnet_helper.py:399-536); per-sample drop-connect on the
    residual branch in training."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride,
                 trans_func=BottleneckTransform, dim_inner=64, num_groups=1,
                 stride_1x1=False, dilation=1, norm=VideoBatchNorm,
                 zero_init_final_bn=False, block_idx=0,
                 drop_connect_rate=0.0):
        super().__init__()
        self.drop_connect_rate = drop_connect_rate
        if dim_in != dim_out or stride != 1:
            self.branch1 = Conv3d(dim_in, dim_out, (1, 1, 1),
                                  (1, stride, stride), (0, 0, 0))
            self.branch1_bn = norm(dim_out)
        else:
            self.branch1 = None
        self.branch2 = trans_func(
            dim_in, dim_out, temp_kernel_size, stride, dim_inner=dim_inner,
            num_groups=num_groups, stride_1x1=stride_1x1, dilation=dilation,
            norm=norm, zero_init_final_bn=zero_init_final_bn,
            block_idx=block_idx)

    def forward(self, x, train, gens: Gens = None):
        f_x = self.branch2(x, train)
        if train and self.drop_connect_rate > 0.0:
            keep = 1.0 - self.drop_connect_rate
            gen = None if gens is None else gens["droppath"]
            u = draw_rows(lambda n: torch.rand(n, generator=gen,
                                               device=x.device), x.shape[0])
            mask = (u < keep).view(-1, 1, 1, 1, 1)
            f_x = torch.where(mask, f_x / keep, torch.zeros_like(f_x))
        if self.branch1 is not None:
            return F.relu(self.branch1_bn(self.branch1(x), train) + f_x)
        return F.relu(x + f_x)


class ResStage(nn.Module):
    """One multi-pathway stage (reference resnet_helper.py:539-745): blocks
    ``pathway{p}_res{i}``, non-local blocks ``pathway{p}_nonlocal{i}`` after
    the blocks ``nonlocal_inds`` names, over groups of frames where
    ``nonlocal_group`` > 1."""

    def __init__(self, dim_in, dim_out, stride, temp_kernel_sizes,
                 num_blocks, dim_inner, num_groups, num_block_temp_kernel,
                 nonlocal_inds, nonlocal_group, nonlocal_pool, dilation,
                 instantiation="softmax",
                 trans_func_name="bottleneck_transform", stride_1x1=False,
                 norm=VideoBatchNorm, zero_init_final_bn=False,
                 drop_connect_rate=0.0):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.nonlocal_inds = tuple(tuple(i) for i in nonlocal_inds)
        self.nonlocal_group = tuple(nonlocal_group)
        trans = get_trans_func(trans_func_name)
        for p in range(len(num_blocks)):
            if num_block_temp_kernel[p] > num_blocks[p]:
                raise ValueError("NUM_BLOCK_TEMP_KERNEL exceeds the blocks")
            tks = (list(temp_kernel_sizes[p]) * num_blocks[p])[
                :num_block_temp_kernel[p]]
            tks += [1] * (num_blocks[p] - num_block_temp_kernel[p])
            for i in range(num_blocks[p]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p], tks[i],
                    stride[p] if i == 0 else 1, trans, dim_inner[p],
                    num_groups[p], stride_1x1, dilation[p], norm,
                    zero_init_final_bn, i, drop_connect_rate))
                if i in self.nonlocal_inds[p]:
                    self.add_module(f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], dim_out[p] // 2, nonlocal_pool[p],
                        instantiation, norm=norm,
                        zero_init_final_bn=zero_init_final_bn))

    def forward(self, inputs, train, gens: Gens = None):
        out = []
        for p, x in enumerate(inputs):
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x, train, gens)
                if i in self.nonlocal_inds[p]:
                    nln = getattr(self, f"pathway{p}_nonlocal{i}")
                    group = self.nonlocal_group[p]
                    if group > 1:
                        # fold groups of frames into the batch
                        b, c, t, h, w = x.shape
                        x = x.permute(0, 2, 1, 3, 4).reshape(
                            b * group, t // group, c, h, w).permute(
                            0, 2, 1, 3, 4)
                        x = nln(x, train)
                        x = x.permute(0, 2, 1, 3, 4).reshape(
                            b, t, c, h, w).permute(0, 2, 1, 3, 4)
                    else:
                        x = nln(x, train)
            out.append(x)
        return out


# ------------------------------------------------------------------ stems


class ResNetBasicStem(nn.Module):
    """Conv + BN + ReLU + the 1x3x3 / 1x2x2 max pool (reference
    stem_helper.py:117-193)."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding,
                 norm=VideoBatchNorm):
        super().__init__()
        self.conv = Conv3d(dim_in, dim_out, kernel, stride, padding)
        self.bn = norm(dim_out)

    def forward(self, x, train):
        x = F.relu(self.bn(self.conv(x), train))
        return max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class X3DStem(nn.Module):
    """A 1xkxk conv, then a channelwise kx1x1 conv, BN, ReLU (reference
    stem_helper.py:196-279)."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding,
                 norm=VideoBatchNorm):
        super().__init__()
        kt, kh, kw = kernel
        st, sh, sw = stride
        pt, ph, pw = padding
        self.conv_xy = Conv3d(dim_in, dim_out, (1, kh, kw), (1, sh, sw),
                              (0, ph, pw))
        self.conv = Conv3d(dim_out, dim_out, (kt, 1, 1), (st, 1, 1),
                           (pt, 0, 0), groups=dim_out)
        self.bn = norm(dim_out)

    def forward(self, x, train):
        return F.relu(self.bn(self.conv(self.conv_xy(x)), train))


_STEM_FUNCS = {"x3d_stem": X3DStem, "basic_stem": ResNetBasicStem}


class VideoModelStem(nn.Module):
    """One stem per pathway, ``pathway{p}_stem`` (reference
    stem_helper.py:19-114)."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding,
                 norm=VideoBatchNorm, stem_func_name="basic_stem"):
        super().__init__()
        self.num_pathways = len(dim_out)
        for p in range(self.num_pathways):
            self.add_module(f"pathway{p}_stem", _STEM_FUNCS[stem_func_name](
                dim_in[p], dim_out[p], kernel[p], stride[p], padding[p],
                norm))

    def forward(self, x, train):
        if len(x) != self.num_pathways:
            raise ValueError(f"Input tensor does not contain "
                             f"{self.num_pathways} pathway")
        return [getattr(self, f"pathway{p}_stem")(x[p], train)
                for p in range(self.num_pathways)]


class FuseFastToSlow(nn.Module):
    """Fast -> slow lateral: a strided temporal conv of the fast pathway,
    BN, ReLU, concatenated onto the slow channels (reference
    video_model_builder.py:92-149)."""

    def __init__(self, dim_in, fusion_conv_channel_ratio, fusion_kernel,
                 alpha, norm=VideoBatchNorm):
        super().__init__()
        self.conv_f2s = Conv3d(dim_in, dim_in * fusion_conv_channel_ratio,
                               (fusion_kernel, 1, 1), (alpha, 1, 1),
                               (fusion_kernel // 2, 0, 0))
        self.bn = norm(dim_in * fusion_conv_channel_ratio)

    def forward(self, x, train):
        x_s, x_f = x
        fuse = F.relu(self.bn(self.conv_f2s(x_f), train))
        return [torch.cat([x_s, fuse], dim=1), x_f]


# ------------------------------------------------------------------ heads


def _activate(x: torch.Tensor, act: str, dim: int) -> torch.Tensor:
    if act == "softmax":
        return torch.softmax(x, dim=dim)
    if act == "sigmoid":
        return torch.sigmoid(x)
    raise NotImplementedError(
        f"{act} is not supported as an activation function.")


def _head_pool(x: torch.Tensor, pool_size) -> torch.Tensor:
    if pool_size is None:
        return x.mean(dim=(2, 3, 4), keepdim=True)
    return F.avg_pool3d(x, tuple(pool_size), stride=1)


class ResNetBasicHead(nn.Module):
    """Average pool per pathway, concatenate, dropout, the float32
    projection; at eval the activation averaged over what positions remain
    (reference head_helper.py:8-95)."""

    def __init__(self, dim_in, num_classes, pool_size, dropout_rate=0.0,
                 act_func="softmax"):
        super().__init__()
        self.pool_size = tuple(None if p is None else tuple(p)
                               for p in pool_size)
        self.dropout_rate, self.act_func = dropout_rate, act_func
        self.projection = nn.Linear(sum(dim_in), num_classes)

    def forward(self, inputs, train, gens: Gens = None):
        if len(inputs) != len(self.pool_size):
            raise ValueError(f"Input tensor does not contain "
                             f"{len(self.pool_size)} pathway")
        x = torch.cat([_head_pool(x, p) for x, p in
                       zip(inputs, self.pool_size)], dim=1)
        x = dropout(x.permute(0, 2, 3, 4, 1), self.dropout_rate, train, gens)
        x = F.linear(_at_least_fp32(x), self.projection.weight,
                     self.projection.bias)
        if not train:
            x = _activate(x, self.act_func, 4).mean(dim=(1, 2, 3))
        return x.reshape(x.shape[0], -1)


class X3DHead(nn.Module):
    """conv_5 + BN + ReLU, pool, lin_5 (+ BN) + ReLU, dropout, the float32
    projection (reference head_helper.py:98-235)."""

    def __init__(self, dim_in, dim_inner, dim_out, num_classes, pool_size,
                 dropout_rate=0.0, act_func="softmax", bn_lin5_on=False,
                 norm=VideoBatchNorm):
        super().__init__()
        self.pool_size = None if pool_size is None else tuple(pool_size)
        self.dropout_rate, self.act_func = dropout_rate, act_func
        self.conv_5 = Conv3d(dim_in, dim_inner, (1, 1, 1))
        self.conv_5_bn = norm(dim_inner)
        self.lin_5 = Conv3d(dim_inner, dim_out, (1, 1, 1))
        self.lin_5_bn = norm(dim_out) if bn_lin5_on else None
        self.projection = nn.Linear(dim_out, num_classes)

    def forward(self, inputs, train, gens: Gens = None):
        if len(inputs) != 1:
            raise ValueError("Input tensor does not contain 1 pathway")
        x = F.relu(self.conv_5_bn(self.conv_5(inputs[0]), train))
        x = self.lin_5(_head_pool(x, self.pool_size))
        if self.lin_5_bn is not None:
            x = self.lin_5_bn(x, train)
        x = dropout(F.relu(x).permute(0, 2, 3, 4, 1), self.dropout_rate,
                    train, gens)
        x = F.linear(_at_least_fp32(x), self.projection.weight,
                     self.projection.bias)
        if not train:
            x = _activate(x, self.act_func, 4).mean(dim=(1, 2, 3))
        return x.reshape(x.shape[0], -1)


class ResNetRoIHead(nn.Module):
    """The RoI-pooled detection head (JAX ``ResNetRoIHead``; upstream
    PySlowFast's): per pathway the mean over time, ROIAlign of each box
    at the feature stride, a spatial max, then concatenation, dropout, the
    float32 projection and the activation (in training too)."""

    def __init__(self, dim_in, num_classes, pool_size, resolution,
                 scale_factor, dropout_rate=0.0, act_func="sigmoid",
                 aligned=True):
        super().__init__()
        self.pool_size, self.resolution = tuple(pool_size), tuple(resolution)
        self.scale_factor = tuple(scale_factor)
        self.dropout_rate, self.act_func = dropout_rate, act_func
        self.aligned = aligned
        self.projection = nn.Linear(sum(dim_in), num_classes)

    def forward(self, inputs, bboxes, train, gens: Gens = None):
        from procedurevrl_torch.ops.roi_align import roi_align

        if bboxes is None:
            raise ValueError("the detection forward needs bboxes [N, 5] "
                             "(batch_idx, x1, y1, x2, y2)")
        pooled = []
        for p, x in enumerate(inputs):
            fmap = x.mean(dim=2).permute(0, 2, 3, 1)     # [B, H, W, C]
            r = roi_align(fmap, bboxes.to(fmap.dtype), self.resolution[p][0],
                          spatial_scale=1.0 / self.scale_factor[p],
                          aligned=self.aligned)
            pooled.append(r.amax(dim=(1, 2)))
        x = dropout(torch.cat(pooled, dim=-1), self.dropout_rate, train, gens)
        x = F.linear(_at_least_fp32(x), self.projection.weight,
                     self.projection.bias)
        return _activate(x, self.act_func, -1)


# ---------------------------------------------------------- configuration


def _t(x):
    """Lists to tuples, recursively."""
    if isinstance(x, (list, tuple)):
        return tuple(_t(e) for e in x)
    return x


@dataclasses.dataclass(frozen=True)
class ResNetFamilyConfig:
    """The architecture knobs of the config tree (JAX
    ``ResNetFamilyConfig``)."""

    arch: str = "slow"
    depth: int = 50
    num_groups: int = 1
    width_per_group: int = 64
    trans_func: str = "bottleneck_transform"
    stride_1x1: bool = False
    zero_init_final_bn: bool = False
    num_block_temp_kernel: Any = ((3,), (4,), (6,), (3,))
    spatial_strides: Any = ((1,), (2,), (2,), (2,))
    spatial_dilations: Any = ((1,), (1,), (1,), (1,))
    nonlocal_location: Any = (((),), ((),), ((),), ((),))
    nonlocal_group: Any = ((1,), (1,), (1,), (1,))
    nonlocal_pool: Any = (((1, 2, 2), (1, 2, 2)),) * 4
    nonlocal_instantiation: str = "dot_product"
    num_classes: int = 400
    dropout_rate: float = 0.5
    head_act: str = "softmax"
    fc_init_std: float = 0.01
    dropconnect_rate: float = 0.0
    num_frames: int = 8
    crop_size: int = 224
    short_cycle: bool = False
    alpha: int = 8
    beta_inv: int = 8
    fusion_conv_channel_ratio: int = 2
    fusion_kernel_sz: int = 5
    x3d_width_factor: float = 1.0
    x3d_depth_factor: float = 1.0
    x3d_bottleneck_factor: float = 1.0
    x3d_dim_c1: int = 12
    x3d_dim_c5: int = 2048
    x3d_scale_res2: bool = False
    x3d_bn_lin5: bool = False
    x3d_channelwise: bool = True
    norm_type: str = "batchnorm"
    bn_num_splits: int = 1
    bn_num_groups: int = 1
    bn_frozen: bool = False
    task: str = "Classification"
    reverse_input_channel: bool = False
    detection_enable: bool = False
    detection_aligned: bool = True
    roi_xform_resolution: int = 7
    spatial_scale_factor: int = 16

    @classmethod
    def from_cfg(cls, cfg) -> "ResNetFamilyConfig":
        world = max(1, cfg.NUM_GPUS * cfg.NUM_SHARDS)
        return cls(
            arch=cfg.MODEL.ARCH, depth=cfg.RESNET.DEPTH,
            num_groups=cfg.RESNET.NUM_GROUPS,
            width_per_group=cfg.RESNET.WIDTH_PER_GROUP,
            trans_func=cfg.RESNET.TRANS_FUNC,
            stride_1x1=cfg.RESNET.STRIDE_1X1,
            zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
            num_block_temp_kernel=_t(cfg.RESNET.NUM_BLOCK_TEMP_KERNEL),
            spatial_strides=_t(cfg.RESNET.SPATIAL_STRIDES),
            spatial_dilations=_t(cfg.RESNET.SPATIAL_DILATIONS),
            nonlocal_location=_t(cfg.NONLOCAL.LOCATION),
            nonlocal_group=_t(cfg.NONLOCAL.GROUP),
            nonlocal_pool=_t(cfg.NONLOCAL.POOL),
            nonlocal_instantiation=cfg.NONLOCAL.INSTANTIATION,
            num_classes=cfg.MODEL.NUM_CLASSES,
            dropout_rate=cfg.MODEL.DROPOUT_RATE, head_act=cfg.MODEL.HEAD_ACT,
            fc_init_std=cfg.MODEL.FC_INIT_STD,
            dropconnect_rate=cfg.MODEL.DROPCONNECT_RATE,
            num_frames=cfg.DATA.NUM_FRAMES, crop_size=cfg.DATA.TRAIN_CROP_SIZE,
            short_cycle=cfg.MULTIGRID.SHORT_CYCLE,
            alpha=cfg.SLOWFAST.ALPHA, beta_inv=cfg.SLOWFAST.BETA_INV,
            fusion_conv_channel_ratio=cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO,
            fusion_kernel_sz=cfg.SLOWFAST.FUSION_KERNEL_SZ,
            x3d_width_factor=cfg.X3D.WIDTH_FACTOR,
            x3d_depth_factor=cfg.X3D.DEPTH_FACTOR,
            x3d_bottleneck_factor=cfg.X3D.BOTTLENECK_FACTOR,
            x3d_dim_c1=cfg.X3D.DIM_C1, x3d_dim_c5=cfg.X3D.DIM_C5,
            x3d_scale_res2=cfg.X3D.SCALE_RES2, x3d_bn_lin5=cfg.X3D.BN_LIN5,
            x3d_channelwise=cfg.X3D.CHANNELWISE_3x3x3,
            norm_type=cfg.BN.NORM_TYPE, bn_num_splits=cfg.BN.NUM_SPLITS,
            bn_num_groups=max(1, world // max(1, cfg.BN.NUM_SYNC_DEVICES)),
            bn_frozen=cfg.BN.FROZEN, task=cfg.TASK,
            reverse_input_channel=cfg.DATA.REVERSE_INPUT_CHANNEL,
            detection_enable=cfg.DETECTION.ENABLE,
            detection_aligned=cfg.DETECTION.ALIGNED,
            roi_xform_resolution=cfg.DETECTION.ROI_XFORM_RESOLUTION,
            spatial_scale_factor=cfg.DETECTION.SPATIAL_SCALE_FACTOR)

    def norm_builder(self):
        return get_norm_builder(self.norm_type, self.bn_num_splits,
                                self.bn_num_groups, self.bn_frozen)


def _stage_args(rc: ResNetFamilyConfig, stage: int, norm, **over) -> dict:
    """The ResStage arguments the stages share, stage 0..3 (res2..res5)."""
    base = dict(stride=_t(rc.spatial_strides[stage]),
                num_block_temp_kernel=_t(rc.num_block_temp_kernel[stage]),
                nonlocal_inds=_t(rc.nonlocal_location[stage]),
                nonlocal_group=_t(rc.nonlocal_group[stage]),
                nonlocal_pool=_t(rc.nonlocal_pool[stage]),
                instantiation=rc.nonlocal_instantiation,
                trans_func_name=rc.trans_func, stride_1x1=rc.stride_1x1,
                dilation=_t(rc.spatial_dilations[stage]), norm=norm,
                zero_init_final_bn=rc.zero_init_final_bn)
    base.update(over)
    return base


# ----------------------------------------------------------------- models


class _VideoModel(nn.Module):
    """What the three models share: the input's pathways in the compute
    dtype, the JAX init, the entry point of the train and eval steps."""

    has_batch_stats = True
    match_lang_emb = False

    def __init__(self, rc: ResNetFamilyConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rc, self.compute_dtype = rc, compute_dtype

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """JAX's init: c2_msra_fill convolutions, BN scale 1 (0 where
        zero-initialised) and bias 0, running statistics 0 and 1, the
        projection normal(``MODEL.FC_INIT_STD``) with a zero bias."""
        for m in self.modules():
            if isinstance(m, (Conv3d, VideoBatchNorm)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                with torch.no_grad():
                    m.weight.normal_(0.0, self.rc.fc_init_std,
                                     generator=generator)
                    m.bias.zero_()

    def pathways(self, x) -> List[torch.Tensor]:
        """``[B, T, H, W, C]`` (or a list of pathways) -> contiguous NCDHW
        pathways in the compute dtype."""
        rc = self.rc
        if not isinstance(x, (list, tuple)):
            x = pack_pathways(x, rc.arch, rc.alpha, rc.reverse_input_channel)
        return [p.to(self.compute_dtype).permute(0, 4, 1, 2, 3).contiguous()
                for p in x]

    def bn_state(self) -> Dict[str, torch.Tensor]:
        """The running statistics by name (JAX's ``batch_stats``)."""
        return {n: b for n, b in self.named_buffers()
                if n.endswith(("running_mean", "running_var"))}


class SlowFastModel(_VideoModel):
    """SlowFast (reference video_model_builder.py:152-421): a slow pathway
    of ``T // ALPHA`` frames and a fast one of ``T`` frames at ``1 /
    BETA_INV`` of the width, fused fast to slow after the stem and after
    res2-res4."""

    def __init__(self, rc: ResNetFamilyConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(rc, compute_dtype)
        if rc.arch != "slowfast" or rc.depth not in _MODEL_STAGE_DEPTH:
            raise ValueError(f"SlowFast of arch {rc.arch}, depth {rc.depth}")
        norm = rc.norm_builder()
        self.pool_size = _POOL1[rc.arch]
        d2, d3, d4, d5 = _MODEL_STAGE_DEPTH[rc.depth]
        wpg, bi = rc.width_per_group, rc.beta_inv
        dim_inner = rc.num_groups * wpg
        out_ratio = bi // rc.fusion_conv_channel_ratio
        tk = _TEMPORAL_KERNEL_BASIS[rc.arch]
        fuse = partial(FuseFastToSlow,
                       fusion_conv_channel_ratio=rc.fusion_conv_channel_ratio,
                       fusion_kernel=rc.fusion_kernel_sz, alpha=rc.alpha,
                       norm=norm)
        self.s1 = VideoModelStem(
            (3, 3), (wpg, wpg // bi),
            (tuple(tk[0][0]) + (7, 7), tuple(tk[0][1]) + (7, 7)),
            ((1, 2, 2),) * 2,
            ((tk[0][0][0] // 2, 3, 3), (tk[0][1][0] // 2, 3, 3)), norm)
        self.s1_fuse = fuse(wpg // bi)
        for s, (m_in, m_out, blocks) in enumerate(
                ((1, 4, d2), (4, 8, d3), (8, 16, d4), (16, 32, d5))):
            inner = dim_inner * (1, 2, 4, 8)[s]
            # the slow pathway takes the fused fast channels
            dim_in = (wpg * m_in + wpg * m_in // out_ratio, wpg * m_in // bi)
            self.add_module(f"s{s + 2}", ResStage(
                dim_in=dim_in, dim_out=(wpg * m_out, wpg * m_out // bi),
                dim_inner=(inner, inner // bi),
                temp_kernel_sizes=_t(tk[s + 1]), num_blocks=(blocks, blocks),
                num_groups=(rc.num_groups,) * 2,
                **_stage_args(rc, s, norm)))
            if s < 3:
                self.add_module(f"s{s + 2}_fuse", fuse(wpg * m_out // bi))
        ps = self.pool_size
        if rc.detection_enable:
            self.head = ResNetRoIHead(
                (wpg * 32, wpg * 32 // bi), rc.num_classes,
                ((rc.num_frames // rc.alpha // ps[0][0], 1, 1),
                 (rc.num_frames // ps[1][0], 1, 1)),
                ((rc.roi_xform_resolution,) * 2,) * 2,
                (rc.spatial_scale_factor,) * 2, rc.dropout_rate, rc.head_act,
                rc.detection_aligned)
        else:
            head_pool = ((None, None) if rc.short_cycle else (
                (rc.num_frames // rc.alpha // ps[0][0],
                 rc.crop_size // 32 // ps[0][1], rc.crop_size // 32 // ps[0][2]),
                (rc.num_frames // ps[1][0], rc.crop_size // 32 // ps[1][1],
                 rc.crop_size // 32 // ps[1][2])))
            self.add_module(f"head{rc.task}", ResNetBasicHead(
                (wpg * 32, wpg * 32 // bi), rc.num_classes, head_pool,
                rc.dropout_rate, rc.head_act))

    def forward(self, x, label_emb=None, train: bool = False,
                generators: Gens = None, draws=None, bboxes=None):
        x = self.pathways(x)
        x = self.s1_fuse(self.s1(x, train), train)
        x = self.s2_fuse(self.s2(x, train, generators), train)
        x = [max_pool3d(p, self.pool_size[i]) for i, p in enumerate(x)]
        x = self.s3_fuse(self.s3(x, train, generators), train)
        x = self.s4_fuse(self.s4(x, train, generators), train)
        x = self.s5(x, train, generators)
        if self.rc.detection_enable:
            return self.head(x, bboxes, train, generators)
        return getattr(self, f"head{self.rc.task}")(x, train, generators)


class ResNetModel(_VideoModel):
    """One pathway: C2D, I3D, Slow (reference
    video_model_builder.py:424-620)."""

    def __init__(self, rc: ResNetFamilyConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(rc, compute_dtype)
        if rc.arch not in _POOL1 or rc.depth not in _MODEL_STAGE_DEPTH:
            raise ValueError(f"ResNet of arch {rc.arch}, depth {rc.depth}")
        norm = rc.norm_builder()
        self.pool_size = _POOL1[rc.arch]
        d2, d3, d4, d5 = _MODEL_STAGE_DEPTH[rc.depth]
        wpg = rc.width_per_group
        dim_inner = rc.num_groups * wpg
        tk = _TEMPORAL_KERNEL_BASIS[rc.arch]
        self.s1 = VideoModelStem((3,), (wpg,), (tuple(tk[0][0]) + (7, 7),),
                                 ((1, 2, 2),), ((tk[0][0][0] // 2, 3, 3),),
                                 norm)
        dims = [(wpg, wpg * 4, dim_inner, d2), (wpg * 4, wpg * 8,
                                                dim_inner * 2, d3),
                (wpg * 8, wpg * 16, dim_inner * 4, d4),
                (wpg * 16, wpg * 32, dim_inner * 8, d5)]
        for s, (din, dout, dinner, blocks) in enumerate(dims):
            self.add_module(f"s{s + 2}", ResStage(
                dim_in=(din,), dim_out=(dout,), dim_inner=(dinner,),
                temp_kernel_sizes=_t(tk[s + 1]), num_blocks=(blocks,),
                num_groups=(rc.num_groups,), **_stage_args(rc, s, norm)))
        ps = self.pool_size
        if rc.detection_enable:
            self.head = ResNetRoIHead(
                (wpg * 32,), rc.num_classes,
                ((rc.num_frames // ps[0][0], 1, 1),),
                ((rc.roi_xform_resolution,) * 2,), (rc.spatial_scale_factor,),
                rc.dropout_rate, rc.head_act, rc.detection_aligned)
        else:
            head_pool = ((None,) if rc.short_cycle else (
                (rc.num_frames // ps[0][0], rc.crop_size // 32 // ps[0][1],
                 rc.crop_size // 32 // ps[0][2]),))
            self.add_module(f"head{rc.task}", ResNetBasicHead(
                (wpg * 32,), rc.num_classes, head_pool, rc.dropout_rate,
                rc.head_act))

    def forward(self, x, label_emb=None, train: bool = False,
                generators: Gens = None, draws=None, bboxes=None):
        x = self.s1(self.pathways(x), train)
        x = self.s2(x, train, generators)
        x = [max_pool3d(p, self.pool_size[i]) for i, p in enumerate(x)]
        for s in (3, 4, 5):
            x = getattr(self, f"s{s}")(x, train, generators)
        if self.rc.detection_enable:
            return self.head(x, bboxes, train, generators)
        return getattr(self, f"head{self.rc.task}")(x, train, generators)


class X3DModel(_VideoModel):
    """X3D (reference video_model_builder.py:623-780): widths and depths
    scaled by ``X3D.WIDTH_FACTOR`` / ``DEPTH_FACTOR``, channelwise 3x3x3
    convolutions, SE and swish, the X3D head."""

    def __init__(self, rc: ResNetFamilyConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(rc, compute_dtype)
        if rc.arch not in _POOL1 or rc.depth not in _MODEL_STAGE_DEPTH:
            raise ValueError(f"X3D of arch {rc.arch}, depth {rc.depth}")
        norm = rc.norm_builder()
        tk = _TEMPORAL_KERNEL_BASIS[rc.arch]
        w_mul, d_mul = rc.x3d_width_factor, rc.x3d_depth_factor
        dim_res1 = round_width(rc.x3d_dim_c1, w_mul)
        self.s1 = VideoModelStem((3,), (dim_res1,),
                                 (tuple(tk[0][0]) + (3, 3),), ((1, 2, 2),),
                                 ((tk[0][0][0] // 2, 1, 1),), norm,
                                 "x3d_stem")
        dim_in = dim_res1
        blocks = self._dims()
        for stage, (reps, width, stride) in enumerate(blocks):
            dim_out = round_width(width, w_mul)
            dim_inner = int(rc.x3d_bottleneck_factor * dim_out)
            n_rep = int(math.ceil(d_mul * reps))
            self.add_module(f"s{stage + 2}", ResStage(
                dim_in=(dim_in,), dim_out=(dim_out,), dim_inner=(dim_inner,),
                temp_kernel_sizes=_t(tk[1]), num_blocks=(n_rep,),
                num_groups=((dim_inner,) if rc.x3d_channelwise
                            else (rc.num_groups,)),
                **_stage_args(
                    rc, stage, norm, stride=(stride,),
                    num_block_temp_kernel=(n_rep,),
                    nonlocal_inds=_t(rc.nonlocal_location[0]),
                    nonlocal_group=_t(rc.nonlocal_group[0]),
                    nonlocal_pool=_t(rc.nonlocal_pool[0]),
                    drop_connect_rate=(rc.dropconnect_rate * (stage + 2)
                                       / (len(blocks) + 1)))))
            dim_in = dim_out
        spat = int(math.ceil(rc.crop_size / 32.0))
        self.head = X3DHead(dim_in, dim_inner, rc.x3d_dim_c5, rc.num_classes,
                            (rc.num_frames, spat, spat), rc.dropout_rate,
                            rc.head_act, rc.x3d_bn_lin5, norm)

    def _dims(self):
        rc = self.rc
        res2 = (round_width(rc.x3d_dim_c1, 2.0, divisor=8)
                if rc.x3d_scale_res2 else rc.x3d_dim_c1)
        res3 = round_width(res2, 2.0, divisor=8)
        res4 = round_width(res3, 2.0, divisor=8)
        res5 = round_width(res4, 2.0, divisor=8)
        return [(1, res2, 2), (2, res3, 2), (5, res4, 2), (3, res5, 2)]

    def forward(self, x, label_emb=None, train: bool = False,
                generators: Gens = None, draws=None, bboxes=None):
        x = self.s1(self.pathways(x), train)
        for s in (2, 3, 4, 5):
            x = getattr(self, f"s{s}")(x, train, generators)
        return self.head(x, train, generators)


MODELS = {"SlowFast": SlowFastModel, "ResNet": ResNetModel, "X3D": X3DModel}
