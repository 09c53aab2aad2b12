"""Host-side video transforms, numpy, channels-last ``[T, H, W, C]``
(counterpart of ``procedurevrl_tpu/datasets/transform.py``: the part the
HowTo100M / COIN dataset takes, and the colour and lighting jitters).

Numpy versions of the reference's tensor transforms (reference
``lib/datasets/transform.py``, ``lib/datasets/utils.py:110-161,
309-326``).  They run on the loader's worker threads; channels-last is the
model's input layout.  Resize is ``cv2`` bilinear where ``cv2`` imports,
else ``F.interpolate(mode="bilinear", align_corners=False)``, which it
matches.  ``spatial_sampling_fused`` takes uint8 frames through the native
preprocess (``videoproc.py``) in one pass, which raises if the library
cannot be built; float frames take the numpy chain.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from procedurevrl_torch.datasets.decoder import _cv2


def _resize_clip(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear resize of ``[T, H, W, C]`` frames."""
    cv2 = _cv2()
    if cv2 is not None:
        return np.stack(
            [cv2.resize(f, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
             for f in frames]
        )
    import torch
    import torch.nn.functional as F

    t = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).float()
    t = F.interpolate(t, size=(new_h, new_w), mode="bilinear", align_corners=False)
    return t.permute(0, 2, 3, 1).numpy()


def random_short_side_scale_jitter(
    frames: np.ndarray,
    min_size: int,
    max_size: int,
    inverse_uniform_sampling: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """reference ``lib/datasets/transform.py:8-62``."""
    rng = rng or np.random
    if inverse_uniform_sampling:
        size = int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(rng.uniform(min_size, max_size)))
    t, height, width, c = frames.shape
    if (width <= height and width == size) or (height <= width and height == size):
        return frames
    if width < height:
        new_width = size
        new_height = int(math.floor((float(height) / width) * size))
    else:
        new_height = size
        new_width = int(math.floor((float(width) / height) * size))
    return _resize_clip(frames, new_height, new_width)


def random_crop(
    frames: np.ndarray, size: int, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """reference ``lib/datasets/transform.py:84-115``."""
    rng = rng or np.random
    t, height, width, c = frames.shape
    if height == size and width == size:
        return frames
    y = 0 if height == size else int(rng.randint(0, height - size))
    x = 0 if width == size else int(rng.randint(0, width - size))
    return frames[:, y : y + size, x : x + size, :]


def horizontal_flip(
    prob: float, frames: np.ndarray, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """reference ``lib/datasets/transform.py:118-147``."""
    rng = rng or np.random
    if rng.uniform() < prob:
        return frames[:, :, ::-1, :]
    return frames


def uniform_crop(frames: np.ndarray, size: int, spatial_idx: int) -> np.ndarray:
    """reference ``lib/datasets/transform.py:150-195``."""
    assert spatial_idx in (0, 1, 2)
    t, height, width, c = frames.shape
    y_offset = int(math.ceil((height - size) / 2))
    x_offset = int(math.ceil((width - size) / 2))
    if height > width:
        if spatial_idx == 0:
            y_offset = 0
        elif spatial_idx == 2:
            y_offset = height - size
    else:
        if spatial_idx == 0:
            x_offset = 0
        elif spatial_idx == 2:
            x_offset = width - size
    return frames[:, y_offset : y_offset + size, x_offset : x_offset + size, :]


def color_jitter(
    frames: np.ndarray,
    img_brightness: float = 0,
    img_contrast: float = 0,
    img_saturation: float = 0,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Random-order brightness/contrast/saturation jitter on float frames
    in [0, 1] (reference ``lib/datasets/transform.py:276-330``)."""
    rng = rng or np.random
    jitter = []
    if img_brightness != 0:
        jitter.append("brightness")
    if img_contrast != 0:
        jitter.append("contrast")
    if img_saturation != 0:
        jitter.append("saturation")
    if not jitter:
        return frames
    order = rng.permutation(len(jitter))
    for idx in order:
        kind = jitter[idx]
        if kind == "brightness":
            alpha = 1.0 + rng.uniform(-img_brightness, img_brightness)
            frames = blend(frames, np.zeros_like(frames), alpha)
        elif kind == "contrast":
            alpha = 1.0 + rng.uniform(-img_contrast, img_contrast)
            gray = grayscale(frames)
            mean = gray.mean(axis=(1, 2, 3), keepdims=True) * np.ones_like(gray)
            frames = blend(frames, mean, alpha)
        else:
            alpha = 1.0 + rng.uniform(-img_saturation, img_saturation)
            frames = blend(frames, grayscale(frames), alpha)
    return frames


def blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    return alpha * a + (1.0 - alpha) * b


def grayscale(frames: np.ndarray) -> np.ndarray:
    """R/G/B -> luminance, replicated to 3 channels (RGB order;
    reference ``transform.py:356-374``)."""
    r, g, b = frames[..., 0], frames[..., 1], frames[..., 2]
    gray = 0.299 * r + 0.587 * g + 0.114 * b
    return np.repeat(gray[..., None], 3, axis=-1)


def lighting_jitter(
    frames: np.ndarray,
    alphastd: float,
    eigval: List[float],
    eigvec: List[List[float]],
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """PCA lighting noise (reference ``transform.py:377-410``)."""
    rng = rng or np.random
    if alphastd == 0:
        return frames
    alphas = rng.normal(0, alphastd, size=(1, 3))
    ev = np.asarray(eigval).reshape(1, 3)
    evec = np.asarray(eigvec)  # [3, 3]
    rgb = (evec * alphas * ev).sum(axis=1)  # [3]
    return frames + rgb.reshape(1, 1, 1, 3)


def tensor_normalize(
    frames: np.ndarray, mean: List[float], std: List[float]
) -> np.ndarray:
    """uint8 [0,255] -> float [0,1], then (x - mean) / std
    (reference ``lib/datasets/utils.py:309-326``)."""
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    return (frames - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _jitter_target_size(
    frames_hw, min_size, max_size, inverse_uniform_sampling, rng
):
    """Sample the short-side target and return (new_h, new_w); mirrors
    ``random_short_side_scale_jitter`` geometry."""
    rng = rng or np.random
    if inverse_uniform_sampling:
        size = int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(rng.uniform(min_size, max_size)))
    height, width = frames_hw
    if (width <= height and width == size) or (height <= width and height == size):
        return height, width
    if width < height:
        return int(math.floor((float(height) / width) * size)), size
    return size, int(math.floor((float(width) / height) * size))


def spatial_sampling_fused(
    frames: np.ndarray,
    spatial_idx: int,
    min_scale: int,
    max_scale: int,
    crop_size: int,
    mean,
    std,
    random_horizontal_flip: bool = True,
    inverse_uniform_sampling: bool = False,
    rng: Optional[np.random.RandomState] = None,
    n_threads: int = 4,
    output_uint8: bool = False,
) -> np.ndarray:
    """Normalise, resize, crop and flip in one native pass (uint8 ``[T, H,
    W, C]`` in, float32 out), with the random draws of ``tensor_normalize``
    + ``spatial_sampling`` in the same order.  Frames that are not uint8
    take that numpy chain.

    With ``output_uint8`` the normalise is skipped and the crop comes back
    as uint8, its bilinear values rounded to nearest (the card normalises:
    ``engine/steps.py:normalize_frames``)."""
    from procedurevrl_torch.datasets import videoproc

    if output_uint8:
        # keep values in [0, 255]: mean 0, std 1/255 undoes the /255
        mean, std = [0.0, 0.0, 0.0], [1 / 255.0, 1 / 255.0, 1 / 255.0]

    if frames.dtype != np.uint8:
        if not output_uint8:
            frames = tensor_normalize(frames, mean, std)
        out = spatial_sampling(
            frames, spatial_idx=spatial_idx, min_scale=min_scale,
            max_scale=max_scale, crop_size=crop_size,
            random_horizontal_flip=random_horizontal_flip,
            inverse_uniform_sampling=inverse_uniform_sampling, rng=rng,
        ).astype(np.float32)
        if output_uint8:
            return np.clip(np.rint(out), 0, 255).astype(np.uint8)
        return out

    rng = rng or np.random
    t, h, w, c = frames.shape
    if spatial_idx == -1:
        new_h, new_w = _jitter_target_size(
            (h, w), min_scale, max_scale, inverse_uniform_sampling, rng
        )
        y = 0 if new_h == crop_size else int(rng.randint(0, new_h - crop_size))
        x = 0 if new_w == crop_size else int(rng.randint(0, new_w - crop_size))
        flip = bool(random_horizontal_flip and rng.uniform() < 0.5)
    else:
        new_h, new_w = _jitter_target_size(
            (h, w), min_scale, max_scale, False, rng
        )
        y = int(math.ceil((new_h - crop_size) / 2))
        x = int(math.ceil((new_w - crop_size) / 2))
        if new_h > new_w:
            y = {0: 0, 1: y, 2: new_h - crop_size}[spatial_idx]
        else:
            x = {0: 0, 1: x, 2: new_w - crop_size}[spatial_idx]
        flip = False
    out = videoproc.fused_preprocess(
        frames, new_h, new_w, y, x, crop_size, flip, mean, std, n_threads
    )
    if output_uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def spatial_sampling(
    frames: np.ndarray,
    spatial_idx: int = -1,
    min_scale: int = 256,
    max_scale: int = 320,
    crop_size: int = 224,
    random_horizontal_flip: bool = True,
    inverse_uniform_sampling: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Random (train) or deterministic (test) spatial sampling
    (reference ``lib/datasets/utils.py:110-161``). [T, H, W, C] in/out."""
    assert spatial_idx in (-1, 0, 1, 2)
    if spatial_idx == -1:
        frames = random_short_side_scale_jitter(
            frames, min_scale, max_scale, inverse_uniform_sampling, rng=rng
        )
        frames = random_crop(frames, crop_size, rng=rng)
        if random_horizontal_flip:
            frames = horizontal_flip(0.5, frames, rng=rng)
    else:
        frames = random_short_side_scale_jitter(frames, min_scale, max_scale, rng=rng)
        frames = uniform_crop(frames, crop_size, spatial_idx)
    return np.ascontiguousarray(frames)
