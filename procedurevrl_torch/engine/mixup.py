"""Mixup / CutMix on the device (counterpart of
``procedurevrl_tpu/engine/mixup.py``; timm's ``Mixup`` in batch mode, the
reference's ``lib/datasets/mixup.py:97``).

One lambda per batch: with probability ``prob`` the batch is mixed with
its flip along the batch axis (the global batch's flip: in a group of
processes row ``i`` pairs with row ``B - 1 - i`` of the mirror rank,
``parallel/collectives.py:flip_batch``, as JAX flips its global batch), by mixup (``lam x + (1 - lam) x_flipped``,
lam ~ Beta(mixup_alpha, mixup_alpha)) or, with probability
``switch_prob`` when both alphas are positive, by CutMix (a box of about
``1 - lam`` of the frame, lam ~ Beta(cutmix_alpha, cutmix_alpha), pasted
from the flipped batch into every frame, timm's ``rand_bbox``, and lam
corrected to the box's true area).  The targets are the label-smoothed
one-hots mixed with the same lambda.  Every draw comes from one
``torch.Generator`` (the ``mixup`` stream of ``engine/steps.py``) and
stays on the device: the host reads nothing.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from procedurevrl_torch.parallel.collectives import flip_batch

# the draws of one call, which ``draws`` may fix
DRAWS = ("apply", "switch", "lam", "cy", "cx")


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float) -> torch.Tensor:
    """Label-smoothed one-hots [B, num_classes] in float32: 1 - smoothing +
    smoothing / K on the label, smoothing / K elsewhere."""
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    oh = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    return oh * (on - off) + off


class Mixup:
    """timm ``Mixup`` in batch mode (JAX ``engine/mixup.py:28-96``)."""

    def __init__(self, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 label_smoothing: float = 0.1, num_classes: int = 1000):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.prob = prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    def draw(self, generator: Optional[torch.Generator],
             device: torch.device, h: int, w: int
             ) -> Mapping[str, torch.Tensor]:
        """The draws of one call, 0-d tensors on ``device``: ``apply`` and
        ``switch`` uniform in [0, 1), ``lam`` ~ Beta(alpha, alpha) of the
        branch ``switch`` picks, ``cy`` / ``cx`` the box centre, uniform
        in [0, h) / [0, w)."""
        u = torch.rand(2, generator=generator, device=device)
        use_cutmix = self._use_cutmix(u[1])
        alpha = torch.where(use_cutmix, self.cutmix_alpha, self.mixup_alpha)
        # Beta(a, a) = X / (X + Y), X, Y ~ Gamma(a); in float64, where a
        # small a's draws do not both underflow to 0
        gamma = torch._standard_gamma(
            alpha.double().expand(2).contiguous(), generator=generator)
        centre = [torch.randint(0, n, (), generator=generator, device=device)
                  for n in (h, w)]
        return {"apply": u[0], "switch": u[1],
                "lam": (gamma[0] / (gamma[0] + gamma[1])).float(),
                "cy": centre[0], "cx": centre[1]}

    def _use_cutmix(self, switch: torch.Tensor) -> torch.Tensor:
        if self.cutmix_alpha > 0.0 and self.mixup_alpha > 0.0:
            return switch < self.switch_prob
        return torch.full_like(switch, self.mixup_alpha <= 0.0,
                               dtype=torch.bool)

    def _cut_box(self, h: int, w: int, lam: torch.Tensor, cy: torch.Tensor,
                 cx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A box of about ``1 - lam`` of the [h, w] frame around (cy, cx),
        clipped to the frame: (mask [h, w], lam corrected to its area)."""
        ratio = torch.sqrt(1.0 - lam)
        cut_h = (h * ratio).to(torch.int32)
        cut_w = (w * ratio).to(torch.int32)
        y0 = (cy - cut_h // 2).clamp(0, h)
        y1 = (cy + cut_h // 2).clamp(0, h)
        x0 = (cx - cut_w // 2).clamp(0, w)
        x1 = (cx + cut_w // 2).clamp(0, w)
        rows = torch.arange(h, device=lam.device)[:, None]
        cols = torch.arange(w, device=lam.device)[None, :]
        box = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
        area = ((y1 - y0) * (x1 - x0)).float()
        return box, 1.0 - area / (h * w)

    def __call__(self, frames: torch.Tensor, labels: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames [B, ..., H, W, C], labels [B] int -> (mixed frames in the
        frames' dtype, soft targets [B, num_classes] float32).  ``draws``
        fixes the draws (:data:`DRAWS`, as :meth:`draw` returns them)."""
        h, w = frames.shape[-3], frames.shape[-2]
        if draws is None:
            draws = self.draw(generator, frames.device, h, w)
        d = {k: torch.as_tensor(draws[k], device=frames.device)
             for k in DRAWS}
        apply = d["apply"] < self.prob
        use_cutmix = self._use_cutmix(d["switch"].float())
        lam = d["lam"].float()

        flipped = flip_batch(frames)
        box, lam_cut = self._cut_box(h, w, lam, d["cy"], d["cx"])
        box = box[..., None].to(frames.dtype)  # [H, W, 1]
        mixed_mix = (lam * frames + (1.0 - lam) * flipped).to(frames.dtype)
        mixed_cut = frames * (1.0 - box) + flipped * box
        mixed = torch.where(use_cutmix, mixed_cut, mixed_mix)
        lam_eff = torch.where(use_cutmix, lam_cut, lam)
        lam_eff = torch.where(apply, lam_eff, torch.ones_like(lam_eff))
        mixed = torch.where(apply, mixed, frames)

        y1 = one_hot_smooth(labels, self.num_classes, self.label_smoothing)
        y2 = one_hot_smooth(flip_batch(labels), self.num_classes,
                            self.label_smoothing)
        return mixed, lam_eff * y1 + (1.0 - lam_eff) * y2
