"""Diffusion transformer over clip-embedding sequences, the "order
transformer" (counterpart of ``procedurevrl_tpu/models/order_transformer.py``;
reference ``lib/models/tfm_model.py:70-329``).

A CLIP-style pre-LN transformer (QuickGELU MLP, fp32 LayerNorm) over
sequences of up to ``max_len`` clip embeddings, trained as a denoiser over
a DDPM schedule with ``total_levels == tfm_layers`` time levels evaluated
through the x0 property: each level's noisy input is re-noised from the
previous level's denoised estimate, with no gradient through the
re-noising.  Layout is batch-major ``[B, L, C]``; the masked clip is
blended in with a one-hot, as in the JAX package.  Parameter names are the
reference's (``pad_embedding.weight``, ``type_embedding.weight``,
``temporalEmbedding.weight``, ``time_mlp.1/3.*``,
``temporalModelling.resblocks.{i}.*``).  Attention is plain PyTorch (the
JAX model does not ask for its kernels here).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from procedurevrl_torch.models.layers import Linear, ResidualAttentionBlock
from procedurevrl_torch.ops.common import gelu_exact, sinusoidal_time_embedding
from procedurevrl_torch.parallel.collectives import draw_rows


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """reference lib/models/diffusion_model.py:328-331"""
    return np.linspace(np.float32(1e-4), np.float32(0.02), timesteps,
                       dtype=np.float32)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """reference lib/models/diffusion_model.py:317-326"""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float32)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0.0001, 0.9999)


def quadratic_beta_schedule(timesteps: int) -> np.ndarray:
    """reference lib/models/diffusion_model.py:333-336"""
    return np.linspace(1e-4 ** 0.5, 0.02 ** 0.5, timesteps,
                       dtype=np.float32) ** 2


def sigmoid_beta_schedule(timesteps: int) -> np.ndarray:
    """reference lib/models/diffusion_model.py:338-342"""
    betas = np.linspace(-6, 6, timesteps, dtype=np.float32)
    return 1 / (1 + np.exp(-betas)) * (0.02 - 1e-4) + 1e-4


_SCHEDULES = {"linear": linear_beta_schedule, "cosine": cosine_beta_schedule,
              "quadratic": quadratic_beta_schedule,
              "sigmoid": sigmoid_beta_schedule}


class DiffusionSchedule:
    """Precomputed DDPM coefficients (reference lib/models/tfm_model.py:106-127),
    float32 tensors on the CPU (moved with :meth:`to`)."""

    def __init__(self, timesteps: int, schedule: str = "linear"):
        betas = _SCHEDULES[schedule](timesteps)
        alphas = (1.0 - betas).astype(np.float32)
        ac = np.cumprod(alphas, dtype=np.float32)
        ac_prev = np.concatenate([[1.0], ac[:-1]])

        def f32(a) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, dtype=np.float32))

        self.betas = f32(betas)
        self.sqrt_recip_alphas = f32(np.sqrt(1.0 / alphas))
        self.sqrt_alphas_cumprod = f32(np.sqrt(ac))
        self.sqrt_one_minus_alphas_cumprod = f32(np.sqrt(1.0 - ac))
        self.posterior_variance = f32(betas * (1.0 - ac_prev) / (1.0 - ac))

    def ennoise(self, x0: torch.Tensor, noise: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """q_sample via property 1 (reference lib/models/tfm_model.py:291-302):
        ``t`` [B] int levels, x0 / noise [B, C] -> float32 [B, C]."""
        a = self.sqrt_alphas_cumprod.to(x0.device)[t][:, None]
        b = self.sqrt_one_minus_alphas_cumprod.to(x0.device)[t][:, None]
        return a * x0.float() + b * noise.float()


class TemporalModelling(nn.Module):
    """``temporalModelling.resblocks.{i}`` of the reference checkpoint."""

    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList([
            ResidualAttentionBlock(width, heads) for _ in range(layers)])


class OrderTransformer(nn.Module):
    """Clip-level diffusion transformer.  :meth:`pretrain` masks one clip
    per sample and denoises it across all levels; :meth:`forecast` denoises
    a clip appended after ``num_seg`` observed ones."""

    def __init__(self, num_seg: int = 8, tfm_layers: int = 4,
                 tfm_heads: int = 8, hidden_size: int = 512, max_len: int = 9,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        C = hidden_size
        self.num_seg = num_seg
        self.tfm_layers = tfm_layers
        self.hidden_size = C
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.pad_embedding = nn.Embedding(1, C)
        self.type_embedding = nn.Embedding(2, C)
        self.temporalEmbedding = nn.Embedding(max_len, C)
        self.temporalModelling = TemporalModelling(C, tfm_heads, tfm_layers)
        # time_mlp.0 is the parameter-free sinusoidal embedding, .2 the GELU
        self.time_mlp = nn.ModuleDict({"1": Linear(C // 4, C), "3": Linear(C, C)})
        self.schedule = DiffusionSchedule(tfm_layers, "linear")

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The JAX package's random init: normal(0.01) embeddings, the CLIP
        scales in every block (reference ``tfm_model.py:251-263``), flax
        default (lecun-normal) time MLP weights, zero biases."""
        C, layers = self.hidden_size, self.tfm_layers
        proj_std = (C ** -0.5) * ((2 * layers) ** -0.5)
        with torch.no_grad():
            for emb in (self.pad_embedding, self.type_embedding,
                        self.temporalEmbedding):
                emb.weight.normal_(0.0, 0.01, generator=generator)
            for lin in self.time_mlp.values():
                nn.init.trunc_normal_(lin.weight, 0.0, lin.in_features ** -0.5,
                                      -2 * lin.in_features ** -0.5,
                                      2 * lin.in_features ** -0.5,
                                      generator=generator)
                lin.bias.zero_()
        for blk in self.temporalModelling.resblocks:
            blk.reset_parameters(generator, C ** -0.5, proj_std,
                                 (2 * C) ** -0.5)

    def _time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """Diffusion-time embedding MLP (reference tfm_model.py:89-94)."""
        emb = sinusoidal_time_embedding(t, self.hidden_size // 4)
        emb = self.time_mlp["1"](emb.to(self.compute_dtype))
        return self.time_mlp["3"](gelu_exact(emb))

    def _level_forward(self, feats: torch.Tensor, mask_onehot: torch.Tensor,
                       t: torch.Tensor, pad_mask: Optional[torch.Tensor]
                       ) -> torch.Tensor:
        """One denoising level: add type, position and time embeddings, run
        the transformer, read out the masked position (reference
        ``tfm_model.py:186-197``).  feats [B, L, C], mask_onehot [B, L, 1]
        float32, t [B] -> [B, C]."""
        dt = feats.dtype
        type_w = self.type_embedding.weight
        type_emb = (type_w[0][None, None] * (1.0 - mask_onehot)
                    + type_w[1][None, None] * mask_onehot)
        x = feats + type_emb.to(dt)
        x = x + self.temporalEmbedding.weight[None, :x.shape[1]].to(dt)
        x = x + self._time_embedding(t)[:, None].to(dt)
        for blk in self.temporalModelling.resblocks:
            x = blk(x, pad_mask)
        return (x * mask_onehot.to(dt)).sum(dim=1)

    def pretrain(self, x: torch.Tensor, mask_inds: Optional[torch.Tensor] = None,
                 pad_start: Optional[torch.Tensor] = None,
                 level_noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Masked-clip denoising over all levels in sequence (JAX
        ``order_transformer.py:202-269``).

        x: [B * max_len, C] clip embeddings, sample-major.  ``mask_inds`` [B],
        ``pad_start`` [B] and ``level_noise`` [levels, B, C] are drawn from
        ``generator`` (on x's device) where None.  Returns
        (final denoised [B, C], mask_inds [B],
        (x0 tiled [levels * B, C], denoised of every level [levels * B, C]),
        the same denoised [levels * B, C])."""
        L, C = self.max_len, self.hidden_size
        B = x.shape[0] // L
        dev = x.device
        feats = x.reshape(B, L, C)
        if mask_inds is None:
            mask_inds = draw_rows(lambda n: torch.randint(
                0, L, (n,), generator=generator, device=dev), B)
        mask_inds = mask_inds.to(dev).long()
        positions = torch.arange(L, device=dev)[None, :]
        mask_onehot = (positions == mask_inds[:, None]).float()[..., None]
        x0 = (feats * mask_onehot.to(feats.dtype)).sum(dim=1)  # [B, C]

        # randomly pad the suffix after the masked clip (reference
        # :272-289): pad_start uniform in [mask + 1, L - 1] when the mask is
        # not last, else L (no padding)
        if pad_start is None:
            lo = mask_inds + 1
            hi = torch.clamp(mask_inds + 2, min=L)
            u = draw_rows(lambda n: torch.rand(n, generator=generator,
                                               device=dev), B)
            rand_start = torch.minimum(lo + (u * (hi - lo)).long(), hi - 1)
            pad_start = torch.where(mask_inds + 1 == L,
                                    torch.full_like(mask_inds, L), rand_start)
        pad_start = pad_start.to(dev).long()
        if level_noise is None:
            level_noise = draw_rows(lambda n: torch.randn(
                self.tfm_layers, n, C, generator=generator, device=dev), B,
                dim=1)
        pad_mask = positions >= pad_start[:, None]  # [B, L] True = padded
        feats = torch.where(pad_mask[..., None],
                            self.pad_embedding.weight[0].to(feats.dtype), feats)

        keep_ctx = (1.0 - mask_onehot).to(feats.dtype)
        denoised_levels = []
        denoised = None
        for time_i in range(self.tfm_layers):
            t = torch.full((B,), self.tfm_layers - 1 - time_i, dtype=torch.long,
                           device=dev)
            noise = level_noise[time_i].to(dev).to(feats.dtype)
            src = x0 if time_i == 0 else denoised
            noisy = self.schedule.ennoise(src.detach(), noise, t)
            level_feats = (feats * keep_ctx
                           + noisy[:, None].to(feats.dtype)
                           * mask_onehot.to(feats.dtype))
            denoised = self._level_forward(level_feats, mask_onehot, t,
                                           pad_mask)
            denoised_levels.append(denoised)

        denoised_all = torch.cat(denoised_levels, dim=0)  # [levels * B, C]
        x0_expanded = x0.repeat(self.tfm_layers, 1)
        return denoised, mask_inds, (x0_expanded, denoised_all), denoised_all

    def forecast(self, x: torch.Tensor) -> torch.Tensor:
        """Denoise a future-clip token appended after the ``num_seg``
        observed clips (JAX ``order_transformer.py:271-309``; reference
        ``tfm_model.py:206-249``).

        x: [B * num_seg, C] clip embeddings, sample-major -> [B, C].  A zero
        token sits at position ``num_seg``, the masked position; level 0
        takes the features as they are, each later level re-noises the
        detached estimate with zero noise (a pure sqrt(alpha_bar) scale);
        nothing is padded."""
        S, C = self.num_seg, self.hidden_size
        L = S + 1
        if L > self.max_len:
            raise ValueError(f"forecast of {S} clips needs {L} positions, "
                             f"the temporal embedding has {self.max_len}")
        B = x.shape[0] // S
        dev = x.device
        feats = torch.cat([x.reshape(B, S, C), x.new_zeros(B, 1, C)], dim=1)
        mask_onehot = (torch.arange(L, device=dev) == S).float()
        mask_onehot = mask_onehot[None, :, None].expand(B, L, 1)
        keep_ctx = (1.0 - mask_onehot).to(feats.dtype)
        denoised = None
        for time_i in range(self.tfm_layers):
            t = torch.full((B,), self.tfm_layers - 1 - time_i,
                           dtype=torch.long, device=dev)
            if time_i == 0:
                level_feats = feats
            else:
                src = denoised.detach()
                noisy = self.schedule.ennoise(src, torch.zeros_like(src), t)
                level_feats = (feats * keep_ctx
                               + noisy[:, None].to(feats.dtype)
                               * mask_onehot.to(feats.dtype))
            denoised = self._level_forward(level_feats, mask_onehot, t, None)
        return denoised
