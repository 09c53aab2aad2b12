"""ROIAlign, channels-last, in plain PyTorch (counterpart of
``procedurevrl_tpu/ops/roi_align.py:28-107``; no Pallas kernel there, and
no ``torchvision`` on the card machine).

Boxes are ``[N, 5]`` rows ``(batch_idx, x1, y1, x2, y2)`` in input-image
coordinates (the reference's AVA format).  Each output bin averages a
fixed ``sampling_ratio x sampling_ratio`` grid of bilinear samples (JAX
fixes the grid where torchvision takes ``ceil(roi / out)`` samples);
``aligned`` subtracts the half-pixel offset (``DETECTION.ALIGNED``), and
without it a malformed box is forced to 1x1, as the legacy op does.
"""

from __future__ import annotations

import torch


def _bilinear(features: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Sample ``features [N, H, W, C]`` (one map per box) at fractional
    points ``y, x [N, ...]``; points outside the map clamp to its edge
    (JAX ``_bilinear``)."""
    n, h, w, c = features.shape
    y = y.clamp(0.0, h - 1.0)
    x = x.clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    wy1, wx1 = y - y0, x - x0
    flat = features.reshape(n, h * w, c)
    shape = y.shape

    def take(yi, xi):
        idx = (yi.long() * w + xi.long()).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*shape, c)

    w00 = ((1 - wy1) * (1 - wx1))[..., None]
    w01 = ((1 - wy1) * wx1)[..., None]
    w10 = (wy1 * (1 - wx1))[..., None]
    w11 = (wy1 * wx1)[..., None]
    return (take(y0, x0) * w00 + take(y0, x1) * w01 + take(y1, x0) * w10
            + take(y1, x1) * w11)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """``features [B, H, W, C]``, ``boxes [N, 5]`` -> ``[N, output_size,
    output_size, C]`` (JAX ``roi_align``)."""
    offset = 0.5 if aligned else 0.0
    dtype, device = features.dtype, features.device
    idx = boxes[:, 0].long()
    x1 = boxes[:, 1] * spatial_scale - offset
    y1 = boxes[:, 2] * spatial_scale - offset
    x2 = boxes[:, 3] * spatial_scale - offset
    y2 = boxes[:, 4] * spatial_scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:  # legacy: a malformed ROI becomes 1x1
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    bin_w, bin_h = roi_w / output_size, roi_h / output_size
    s = sampling_ratio
    frac = (torch.arange(s, dtype=dtype, device=device) + 0.5) / s
    bins = torch.arange(output_size, dtype=dtype, device=device)
    offs = bins[None, :, None] + frac[None, None, :]          # [1, out, s]
    ys = y1[:, None, None] + offs * bin_h[:, None, None]      # [N, out, s]
    xs = x1[:, None, None] + offs * bin_w[:, None, None]
    n = boxes.shape[0]
    grid = (n, output_size, s, output_size, s)
    yy = ys[:, :, :, None, None].expand(grid)
    xx = xs[:, None, None, :, :].expand(grid)
    sampled = _bilinear(features[idx], yy, xx)  # [N, out, s, out, s, C]
    return sampled.mean(dim=(2, 4))
