"""ProcedureVRL: a video encoder (TimeSformer or MViT-v2) with its 512-d
projection head, the diffusion order transformer and the frozen CLIP text
tower (counterpart of ``procedurevrl_tpu/models/procedurevrl.py``;
reference ``lib/models/vit.py:183-358``, ``lib/models/mvit.py``).

Ported branches of the forward dispatch:

- **order pretraining** (train, ``order_pretrain``): encode B*M clips, match
  them against the step bank, build CLIP pseudo-labels from the ASR text
  (through the frozen text tower) and the precomputed CLIP visual features,
  denoise a masked clip across all diffusion levels, and return (student
  logits, teacher logits, MSE pair);
- **zero-shot step classification** (eval, ``match_lang_emb``): normalised
  head embedding @ step bank / temp, softmax.

Forecasting (``num_seg > 0``) and the finetuning heads (``match_lang_emb``
False) raise: they come with later slices.  The state dict carries the
reference ``.pyth`` keys: for TimeSformer the encoder is the base class
(``patch_embed.*``, ``blocks.*``, ``norm.*``, ``cls_token``, ``pos_embed``,
``time_embed`` at the root), for MViT it sits under ``video_encoder.``;
both add ``head.*``, ``order_tfm.*`` and ``text_model.*``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from procedurevrl_torch.models.clip_text import CLIPTextEncoder
from procedurevrl_torch.models.layers import Linear, init_linear
from procedurevrl_torch.models.mvit import MViTConfig, MViTEncoder
from procedurevrl_torch.models.order_transformer import OrderTransformer
from procedurevrl_torch.models.timesformer import TimeSformer
from procedurevrl_torch.ops.attention_route import AttentionRoute

_LATER = ("not ported yet: forecasting and the finetuning heads come with "
          "later slices")


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    # torch x.norm(dim=1, keepdim=True) of the reference: no epsilon
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _match(emb: torch.Tensor, bank: torch.Tensor, temp: float) -> torch.Tensor:
    """emb @ bank^T / temp: products of emb-dtype values, accumulated in
    fp32, float32 result."""
    return emb.float() @ bank.to(emb.dtype).float().t() / temp


class _Heads:
    """What the encoders share: the ``head`` projection, the order
    transformer, the text tower, the teacher and the forward dispatch.  A
    model class mixes it into an ``nn.Module`` and provides ``_encode``
    (video -> [N, D] feature) and ``_reset_encoder``.

    ``forward(x, text, label_emb, train, generators, draws)``:

    - eval: ``x`` [B, T, H, W, 3] normalised frames (cast to the compute
      dtype here), ``label_emb`` [K, label_dim] L2-normalised step bank ->
      post-softmax float32 predictions [B, K];
    - order pretraining (``train`` with ``text``): ``x`` [B, M, T, H, W, 3],
      ``text`` = {"clip_text_ids": [B*M, 77], "clip_vis_feat": [B*M, 512]}
      -> (student [B*M' + levels*B, K], teacher [same], (x0, denoised)).
    ``generators`` maps "diffusion", "subset" and "droppath" to
    ``torch.Generator``s on x's device; ``draws`` may fix "mask_inds",
    "pad_start", "level_noise" and "perm" (the recognition subset)."""

    def _init_heads(self, feat_dim: int, label_dim: int, temp: float,
                    match_lang_emb: bool, order_pretrain: bool,
                    order_max_len: int, order_tfm_layers: int,
                    order_recog_batch: int, num_seg: int,
                    with_text_model: bool, text_vocab: int, text_width: int,
                    text_heads: int, text_layers: int,
                    compute_dtype: torch.dtype) -> None:
        if not match_lang_emb or num_seg > 0:
            raise NotImplementedError(_LATER)
        self.temp = temp
        self.compute_dtype = compute_dtype
        self.order_max_len = order_max_len
        self.order_recog_batch = order_recog_batch
        self.head = Linear(feat_dim, label_dim)
        self.order_tfm = (OrderTransformer(
            num_seg=order_max_len - 1, tfm_layers=order_tfm_layers,
            hidden_size=label_dim, max_len=order_max_len,
            compute_dtype=compute_dtype) if order_pretrain else None)
        self.text_model = (CLIPTextEncoder(
            vocab_size=text_vocab, width=text_width, heads=text_heads,
            layers=text_layers, embed_dim=label_dim,
            compute_dtype=compute_dtype) if with_text_model else None)

    def _encode(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        raise NotImplementedError

    def _reset_encoder(self, generator: Optional[torch.Generator]) -> None:
        raise NotImplementedError

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self._reset_encoder(generator)
        init_linear(self.head, generator)
        for sub in (self.order_tfm, self.text_model):
            if sub is not None:
                sub.reset_parameters(generator)

    def get_pseudo_labels(self, text: Mapping[str, torch.Tensor],
                          label_emb: torch.Tensor) -> torch.Tensor:
        """CLIP teacher logits [B*M, K]: (text(ASR) + precomputed visual) / 2,
        L2-normalised, matched to the step bank (reference
        ``lib/models/vit.py:425-433``).  The text tower runs without grad;
        without a tower the teacher is the visual features alone."""
        emb = text["clip_vis_feat"].float()
        if self.text_model is not None:
            with torch.no_grad():
                text_emb = self.text_model(text["clip_text_ids"]).float()
            emb = (text_emb + emb) / 2.0
        return _match(_l2norm(emb), label_emb.float(), self.temp)

    def forward(self, x: torch.Tensor,
                text: Optional[Mapping[str, torch.Tensor]] = None,
                label_emb: Optional[torch.Tensor] = None, train: bool = False,
                generators: Optional[Dict[str, torch.Generator]] = None,
                draws: Optional[Mapping[str, torch.Tensor]] = None):
        if label_emb is None:
            raise ValueError("match_lang_emb requires a step bank")
        gens = generators or {}
        draws = draws or {}
        batch_size = x.shape[0]
        pretrain = self.order_tfm is not None and train
        if pretrain:
            x = x.reshape((-1,) + x.shape[2:])  # [B*M, T, H, W, 3]
        feat = self._encode(x.to(self.compute_dtype),
                            gens.get("droppath"))  # [N, D]
        emb = _l2norm(self.head(feat))
        logits = _match(emb, label_emb, self.temp)
        if not train:
            return torch.softmax(logits, dim=-1)
        if not pretrain or text is None:
            return logits

        # order pretraining branch (reference lib/models/vit.py:325-352)
        teacher = self.get_pseudo_labels(text, label_emb)  # [B*M, K]
        _, mask_inds, mse_pair, intermediate = self.order_tfm.pretrain(
            emb, mask_inds=draws.get("mask_inds"),
            pad_start=draws.get("pad_start"),
            level_noise=draws.get("level_noise"),
            generator=gens.get("diffusion"))
        inter_pred = _match(_l2norm(intermediate), label_emb, self.temp)

        # teacher logits of the masked-out clip, tiled across levels
        M = self.order_max_len
        B = teacher.shape[0] // M
        onehot = (torch.arange(M, device=teacher.device)[None, :]
                  == mask_inds[:, None]).to(teacher.dtype)
        masked_teacher = torch.einsum("bmk,bm->bk", teacher.view(B, M, -1),
                                      onehot)
        inter_teacher = masked_teacher.repeat(self.order_tfm.tfm_layers, 1)

        # random recognition subset to bound memory (reference
        # lib/models/vit.py:345-347)
        n_total = logits.shape[0]
        n_keep = min(batch_size * self.order_recog_batch, n_total)
        perm = draws.get("perm")
        if perm is None:
            perm = torch.randperm(n_total, generator=gens.get("subset"),
                                  device=logits.device)[:n_keep]
        student = torch.cat([logits[perm], inter_pred], dim=0)
        teacher_out = torch.cat([teacher[perm], inter_teacher], dim=0)
        return student, teacher_out, mse_pair


_HEAD_DEFAULTS = dict(
    label_dim=512, temp=0.02, match_lang_emb=True, order_pretrain=False,
    order_max_len=9, order_tfm_layers=4, order_recog_batch=9, num_seg=0,
    with_text_model=False, text_vocab=49408, text_width=512, text_heads=8,
    text_layers=12, compute_dtype=torch.float32)


class ProcedureVRL(_Heads, TimeSformer):
    """TimeSformer encoder + ``head`` projection (+ ``order_tfm`` and
    ``text_model`` for order pretraining); the encoder is the base class,
    so its parameters sit at the root of the state dict, as in the
    reference's ViT checkpoints.  Head keyword arguments: see
    ``_HEAD_DEFAULTS``; forward: see :class:`_Heads`."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_frames: int = 8,
                 attention_type: str = "divided_space_time",
                 drop_path_rate: float = 0.1, remat: bool = False,
                 route: Optional[AttentionRoute] = None, **heads):
        TimeSformer.__init__(self, img_size=img_size, patch_size=patch_size,
                             embed_dim=embed_dim, depth=depth,
                             num_heads=num_heads, num_frames=num_frames,
                             attention_type=attention_type,
                             drop_path_rate=drop_path_rate, remat=remat,
                             route=route)
        self._init_heads(embed_dim, **{**_HEAD_DEFAULTS, **heads})

    def _encode(self, x, generator):
        return TimeSformer.forward(self, x, generator=generator)

    def _reset_encoder(self, generator):
        TimeSformer.reset_parameters(self, generator)


class ProcedureVRLMViT(_Heads, nn.Module):
    """MViT-v2 encoder under ``video_encoder`` (reference
    ``lib/models/mvit.py:67``, the prefix ``convert_procedurevrl`` reads) +
    the same heads."""

    def __init__(self, mvit_cfg: MViTConfig, remat: bool = False, **heads):
        nn.Module.__init__(self)
        self.video_encoder = MViTEncoder(mvit_cfg, remat=remat)
        feat_dim = mvit_cfg.block_schedule()[2]
        self._init_heads(feat_dim, **{**_HEAD_DEFAULTS, **heads})

    def _encode(self, x, generator):
        return self.video_encoder(x, generator=generator)

    def _reset_encoder(self, generator):
        self.video_encoder.reset_parameters(generator)
