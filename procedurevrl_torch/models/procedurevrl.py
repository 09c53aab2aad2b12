"""ProcedureVRL: a video encoder (TimeSformer or MViT-v2) with its 512-d
projection head, the diffusion order transformer, the frozen CLIP text
tower and the finetuning head (counterpart of
``procedurevrl_tpu/models/procedurevrl.py``; reference
``lib/models/vit.py:183-358``, ``lib/models/mvit.py``).

Branches of the forward dispatch:

- **order pretraining** (train, ``order_pretrain``): encode B*M clips, match
  them against the step bank, build CLIP pseudo-labels from the ASR text
  (through the frozen text tower) and the precomputed CLIP visual features,
  denoise a masked clip across all diffusion levels, and return (student
  logits, teacher logits, MSE pair);
- **zero-shot step classification** (``match_lang_emb``): normalised head
  embedding @ step bank / temp;
- **zero-shot step forecasting** (``match_lang_emb``, ``num_seg > 0``): the
  normalised head embeddings of the ``num_seg`` observed clips through
  ``order_tfm.forecast``, normalised, @ step bank / temp;
- **finetuning** (``match_lang_emb`` False): ``head_cls`` on the normalised
  head embedding, / temp (COIN step and task classification), or on the
  forecast of the ``num_seg`` clips with no temperature (COIN forecasting);
  with ``epic_heads`` (EPIC-Kitchens) ``head_v`` (97 verbs) and ``head_n``
  (300 nouns) on the normalised head embedding, each / temp.
Eval returns the softmax, but for the EPIC heads, whose ``(verb, noun)``
logits it returns as they are (JAX ``models/procedurevrl.py:213-217``
returns them before its softmax).  Where no encoder parameter requires grad (the
linear probe, ``TRAIN.LINEAR``) the encoder runs without autograd: no
recomputation under remat, the forward kernels only, and no backward
through it, as the JAX package's ``stop_frozen_gradients`` removes it.

The state dict carries the reference ``.pyth`` keys: for TimeSformer the
encoder is the base class (``patch_embed.*``, ``blocks.*``, ``norm.*``,
``cls_token``, ``pos_embed``, ``time_embed`` at the root), for MViT it sits
under ``video_encoder.``; both add ``head.*``, ``order_tfm.*``,
``text_model.*`` and ``head_cls.*`` (``head_v.*`` and ``head_n.*`` for
EPIC-Kitchens).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from procedurevrl_torch.models.clip_text import CLIPTextEncoder
from procedurevrl_torch.models.layers import Linear, init_linear
from procedurevrl_torch.models.mvit import MViTConfig, MViTEncoder
from procedurevrl_torch.models.order_transformer import OrderTransformer
from procedurevrl_torch.models.timesformer import TimeSformer
from procedurevrl_torch.ops.attention_route import AttentionRoute
from procedurevrl_torch.parallel.collectives import get_rank, get_world_size
from procedurevrl_torch.solver.optimizer import is_encoder


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    # torch x.norm(dim=1, keepdim=True) of the reference: no epsilon
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _match(emb: torch.Tensor, bank: torch.Tensor, temp: float) -> torch.Tensor:
    """emb @ bank^T / temp: products of emb-dtype values, accumulated in
    fp32, float32 result."""
    return emb.float() @ bank.to(emb.dtype).float().t() / temp


def _recognition_subset(n_total: int, n_keep: int,
                        generator: Optional[torch.Generator],
                        device: torch.device) -> torch.Tensor:
    """The recognition subset (reference ``lib/models/vit.py:345-347``):
    ``n_keep`` of the ``n_total`` rows, in a random order.  In a group of
    processes the order is a permutation of the global batch's rows,
    which every rank draws alike, and this rank keeps its own rows in that
    order (as JAX draws it for the global batch).  A subset smaller than
    the batch would split unevenly over the ranks, and raises there."""
    world = get_world_size()
    if world == 1:
        return torch.randperm(n_total, generator=generator,
                              device=device)[:n_keep]
    if n_keep < n_total:
        raise NotImplementedError(
            "DEV.ORDER_RECOG_BATCH below the clips of a sample: a "
            "recognition subset smaller than the batch would split unevenly "
            "over the processes")
    perm = torch.randperm(n_total * world, generator=generator,
                          device=device)
    rank = get_rank()
    theirs = (perm // n_total != rank).to(torch.int8)
    mine = torch.argsort(theirs, stable=True)[:n_total]
    return perm[mine] - rank * n_total


class _Heads:
    """What the encoders share: the ``head`` projection, the order
    transformer, the text tower, the finetuning head and the forward
    dispatch.  A model class mixes it into an ``nn.Module`` and provides
    ``_encode`` (video -> [N, D] feature) and ``_reset_encoder``.

    ``forward(x, text, label_emb, train, generators, draws)``:

    - classification: ``x`` [B, T, H, W, 3] normalised frames (cast to the
      compute dtype here); forecasting (``num_seg`` M > 0): [B, M*T, H, W,
      3]; ``label_emb`` [K, label_dim] the L2-normalised step bank, needed
      where ``match_lang_emb`` holds -> float32 logits [B, K] in train
      mode, their softmax in eval; with ``epic_heads`` the float32 (verb
      [B, 97], noun [B, 300]) logits in both modes;
    - order pretraining (``train`` with ``text``): ``x`` [B, M, T, H, W, 3],
      ``text`` = {"clip_text_ids": [B*M, 77], "clip_vis_feat": [B*M, 512]}
      -> (student [B*M' + levels*B, K], teacher [same], (x0, denoised)).
    ``generators`` maps "diffusion", "subset" and "droppath" to
    ``torch.Generator``s on x's device; ``draws`` may fix "mask_inds",
    "pad_start", "level_noise" and "perm" (the recognition subset)."""

    def _init_heads(self, feat_dim: int, label_dim: int, num_classes: int,
                    temp: float, match_lang_emb: bool, order_pretrain: bool,
                    order_max_len: int, order_tfm_layers: int,
                    order_recog_batch: int, num_seg: int,
                    with_text_model: bool, text_vocab: int, text_width: int,
                    text_heads: int, text_layers: int,
                    compute_dtype: torch.dtype, epic_heads: bool) -> None:
        # the encoder's parameters, by the optimizer's grouping rule
        self._encoder_params = [p for n, p in self.named_parameters()
                                if is_encoder(n)]
        self.temp = temp
        self.compute_dtype = compute_dtype
        self.match_lang_emb = match_lang_emb
        self.order_pretrain = order_pretrain
        self.num_seg = num_seg
        self.order_max_len = order_max_len
        self.order_recog_batch = order_recog_batch
        self.head = Linear(feat_dim, label_dim)
        self.order_tfm = (OrderTransformer(
            num_seg=num_seg if num_seg > 0 else order_max_len - 1,
            tfm_layers=order_tfm_layers, hidden_size=label_dim,
            max_len=order_max_len, compute_dtype=compute_dtype)
            if order_pretrain or num_seg > 0 else None)
        self.text_model = (CLIPTextEncoder(
            vocab_size=text_vocab, width=text_width, heads=text_heads,
            layers=text_layers, embed_dim=label_dim,
            compute_dtype=compute_dtype) if with_text_model else None)
        finetune = not match_lang_emb
        self.head_cls = (Linear(label_dim, num_classes)
                         if finetune and not epic_heads else None)
        epic = finetune and epic_heads
        self.head_v = Linear(label_dim, EPIC_VERBS) if epic else None
        self.head_n = Linear(label_dim, EPIC_NOUNS) if epic else None

    def _encode(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        raise NotImplementedError

    def _encoder_grad(self):
        """``torch.no_grad()`` where no encoder parameter requires grad (a
        frozen encoder: nothing before it needs a gradient either), else a
        no-op.  Train mode still draws the drop-path masks."""
        if any(p.requires_grad for p in self._encoder_params):
            return contextlib.nullcontext()
        return torch.no_grad()

    def _reset_encoder(self, generator: Optional[torch.Generator]) -> None:
        raise NotImplementedError

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self._reset_encoder(generator)
        init_linear(self.head, generator)
        for head in (self.head_cls, self.head_v, self.head_n):
            if head is not None:
                init_linear(head, generator)
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
        if self.match_lang_emb and label_emb is None:
            raise ValueError("match_lang_emb requires a step bank")
        gens = generators or {}
        draws = draws or {}
        batch_size = x.shape[0]
        pretrain = self.order_pretrain and train
        if pretrain:
            x = x.reshape((-1,) + x.shape[2:])  # [B*M, T, H, W, 3]
        elif self.num_seg > 0:  # [B, M*T, ...] -> [B*M, T, ...]
            x = x.reshape((batch_size * self.num_seg,
                           x.shape[1] // self.num_seg) + x.shape[2:])
        with self._encoder_grad():
            feat = self._encode(x.to(self.compute_dtype),
                                gens.get("droppath"))  # [N, D]
        emb = _l2norm(self.head(feat))
        if self.match_lang_emb:
            match_emb = emb
            if self.num_seg > 0:  # zero-shot step forecasting
                match_emb = _l2norm(self.order_tfm.forecast(emb))
            logits = _match(match_emb, label_emb, self.temp)
        elif self.num_seg > 0:  # forecasting head: no temperature
            logits = self.head_cls(self.order_tfm.forecast(emb)).float()
        elif self.head_v is not None:  # EPIC-Kitchens: no softmax in eval
            return (self.head_v(emb).float() / self.temp,
                    self.head_n(emb).float() / self.temp)
        else:
            logits = self.head_cls(emb).float() / self.temp
        if not train:
            return torch.softmax(logits, dim=-1)
        if not (pretrain and self.match_lang_emb and text is not None):
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
            perm = _recognition_subset(n_total, n_keep, gens.get("subset"),
                                       logits.device)
        student = torch.cat([logits[perm], inter_pred], dim=0)
        teacher_out = torch.cat([teacher[perm], inter_teacher], dim=0)
        return student, teacher_out, mse_pair


_HEAD_DEFAULTS = dict(
    label_dim=512, num_classes=1000, temp=0.02, match_lang_emb=True,
    order_pretrain=False, order_max_len=9, order_tfm_layers=4,
    order_recog_batch=9, num_seg=0, with_text_model=False, text_vocab=49408,
    text_width=512, text_heads=8, text_layers=12, compute_dtype=torch.float32,
    epic_heads=False)
# the EPIC-Kitchens-100 verb and noun classes (JAX procedurevrl.py:137-141)
EPIC_VERBS, EPIC_NOUNS = 97, 300


class ProcedureVRL(_Heads, TimeSformer):
    """TimeSformer encoder + ``head`` projection (+ ``order_tfm`` and
    ``text_model`` for order pretraining, ``order_tfm`` for forecasting,
    ``head_cls`` for finetuning); the encoder is the base class,
    so its parameters sit at the root of the state dict, as in the
    reference's ViT checkpoints.  Head keyword arguments: see
    ``_HEAD_DEFAULTS``; the remat switches: see :class:`TimeSformer`;
    forward: see :class:`_Heads`."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_frames: int = 8,
                 attention_type: str = "divided_space_time",
                 drop_path_rate: float = 0.1, remat: bool = False,
                 route: Optional[AttentionRoute] = None,
                 remat_save_attn: bool = True, remat_save_qkv: bool = False,
                 remat_save_temporal: bool = False, **heads):
        TimeSformer.__init__(self, img_size=img_size, patch_size=patch_size,
                             embed_dim=embed_dim, depth=depth,
                             num_heads=num_heads, num_frames=num_frames,
                             attention_type=attention_type,
                             drop_path_rate=drop_path_rate, remat=remat,
                             route=route, remat_save_attn=remat_save_attn,
                             remat_save_qkv=remat_save_qkv,
                             remat_save_temporal=remat_save_temporal)
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
