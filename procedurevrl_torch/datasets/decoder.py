"""Host-side video decoding (counterpart of
``procedurevrl_tpu/datasets/decoder.py``; reference
``lib/datasets/decoder.py``, ``lib/datasets/howto100m.py:497-533``).

Decoding is CPU work on the loader's worker threads, as in the reference.
Backends, picked at run time:

- the ``ffmpeg`` binary through a rawvideo pipe, the reference's
  pretraining decode (fps filter to ~num_frames / (end - start), scale
  640x360, rgb24);
- PyAV's selective stream decode (reference ``decoder.py:63-102``);
- ``cv2.VideoCapture``.

``cv2`` and ``av`` are imported inside the functions that use them, so the
module imports where neither is installed.  Outputs are channels-last
uint8 ``[T, H, W, C]`` numpy arrays.
"""

from __future__ import annotations

import math
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_FFMPEG = shutil.which("ffmpeg")


def _cv2():
    """``cv2`` where it imports, else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _av():
    """PyAV where it imports, else None."""
    try:
        import av
    except ImportError:
        return None
    return av


def temporal_sampling(
    frames: np.ndarray, start_idx: float, end_idx: float, num_samples: int
) -> np.ndarray:
    """Equal-interval frame sampling in [start, end]
    (reference ``lib/datasets/decoder.py:10-30``). [T, ...] -> [num_samples, ...]."""
    index = np.linspace(start_idx, end_idx, num_samples)
    index = np.clip(index, 0, frames.shape[0] - 1).astype(np.int64)
    return frames[index]


def get_start_end_idx(
    video_size: int, clip_size: float, clip_idx: int, num_clips: int,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[float, float]:
    """reference ``lib/datasets/decoder.py:32-60``."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        start_idx = (rng or np.random).uniform(0, delta)
    else:
        start_idx = delta * clip_idx / num_clips
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx


def decode_ffmpeg_window(
    video_path: str, start: float, end: float, num_frames: int,
    scale_wh: Tuple[int, int] = (640, 360),
) -> np.ndarray:
    """The reference pretraining decode (``howto100m.py:497-514``): decode
    [start, end) seconds at ~num_frames/(end-start) fps, scaled to 640x360
    rawvideo RGB, then equal-interval sample ``num_frames``."""
    assert _FFMPEG, "ffmpeg binary not found"
    w, h = scale_wh
    fps = math.ceil(num_frames / max(end - start, 1e-6))
    cmd = [
        _FFMPEG, "-nostdin", "-loglevel", "error",
        "-ss", str(start), "-t", str(end - start),
        "-i", video_path,
        "-vf", f"fps={fps},scale={w}:{h}",
        "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:",
    ]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, check=True).stdout
    video = np.frombuffer(out, np.uint8)
    n = video.size // (h * w * 3)
    video = video[: n * h * w * 3].reshape(n, h, w, 3)
    if n == 0:
        raise RuntimeError(f"ffmpeg produced no frames for {video_path}")
    return temporal_sampling(video, 0, video.shape[0], num_frames)


def decode_pyav_window(
    video_path: str, start: float, end: float, num_frames: int
) -> np.ndarray:
    """Selective-seek PyAV decode of a [start, end) second window
    (reference ``decoder.py:63-102`` stream decode)."""
    av = _av()
    assert av is not None, "pyav not available"
    container = av.open(video_path)
    stream = container.streams.video[0]
    tb = stream.time_base
    container.seek(int(start / tb), stream=stream, any_frame=False)
    frames = []
    for frame in container.decode(stream):
        t = float(frame.pts * tb)
        if t < start:
            continue
        if t > end:
            break
        frames.append(frame.to_rgb().to_ndarray())
    container.close()
    if not frames:
        raise RuntimeError(f"pyav produced no frames for {video_path}")
    video = np.stack(frames)
    return temporal_sampling(video, 0, video.shape[0], num_frames)


def decode_cv2_window(
    video_path: str, start: float, end: float, num_frames: int
) -> np.ndarray:
    """cv2.VideoCapture decode of a [start, end) second window (fallback
    backend; BGR -> RGB)."""
    cv2 = _cv2()
    assert cv2 is not None, "cv2 not available"
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 cannot open {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    start_f = int(start * fps)
    end_f = max(int(end * fps), start_f + 1)
    # sample target indices up front, decode sequentially
    want = np.linspace(start_f, end_f - 1, num_frames).astype(np.int64)
    want_set = set(want.tolist())
    frames = {}
    last = None
    if (end_f - start_f) > 16 * len(want_set):
        # sparse window: per-index seek beats decoding every frame (the
        # seek lands on the nearest keyframe and decodes <= one GOP,
        # instead of the full window; measured 2-3x on long FD windows)
        for idx in sorted(want_set):
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, img = cap.read()
            if not ok:
                continue
            frames[idx] = img[:, :, ::-1]
            last = img
    else:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start_f)
        cur = start_f
        while cur < end_f and len(frames) < len(want_set):
            if cur in want_set:
                ok, img = cap.read()   # decode + retrieve
                if not ok:
                    break
                frames[cur] = img[:, :, ::-1]
                last = img
            else:
                # grab() decodes but skips the color-convert/copy of
                # retrieval — unsampled frames only advance the stream
                if not cap.grab():
                    break
            cur += 1
    cap.release()
    if not frames:
        if last is None:
            raise RuntimeError(f"cv2 produced no frames for {video_path}")
        frames[start_f] = last[:, :, ::-1]
    out = [frames.get(i, frames[min(frames, key=lambda k: abs(k - i))]) for i in want]
    return np.ascontiguousarray(np.stack(out))


def decode_window(
    video_path: str, start: float, end: float, num_frames: int,
    backend: str = "auto",
) -> np.ndarray:
    """Decode ``num_frames`` RGB frames from [start, end) seconds."""
    if backend == "auto":
        if _FFMPEG:
            backend = "ffmpeg"
        elif _av() is not None:
            backend = "pyav"
        else:
            backend = "cv2"
    if backend == "ffmpeg":
        return decode_ffmpeg_window(video_path, start, end, num_frames)
    if backend == "pyav":
        return decode_pyav_window(video_path, start, end, num_frames)
    if backend == "cv2":
        return decode_cv2_window(video_path, start, end, num_frames)
    raise ValueError(f"unknown decode backend {backend}")


def decode_full(
    video_path: str,
    sampling_rate: int,
    num_frames: int,
    clip_idx: int,
    num_clips: int,
    target_fps: int = 30,
    backend: str = "auto",
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Kinetics-style decode: sample a clip of ``num_frames`` frames at
    ``sampling_rate`` stride (reference ``decoder.py:105-220`` contract)."""
    cv2 = _cv2()
    if backend == "auto":
        backend = ("cv2" if cv2 is not None
                   else ("pyav" if _av() is not None else "ffmpeg"))
    if backend == "cv2":
        assert cv2 is not None, "cv2 not available"
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            raise RuntimeError(f"cv2 cannot open {video_path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or target_fps
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        clip_size = sampling_rate * num_frames / target_fps * fps
        start_idx, end_idx = get_start_end_idx(total, clip_size, clip_idx, num_clips, rng)
        want = np.clip(
            np.linspace(start_idx, end_idx, num_frames), 0, max(total - 1, 0)
        ).astype(np.int64)
        frames = []
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(want[0]))
        cur = int(want[0])
        need = list(want)
        got = {}
        while need and cur <= int(want[-1]):
            ok, img = cap.read()
            if not ok:
                break
            while need and need[0] == cur:
                got[cur] = img[:, :, ::-1]
                need.pop(0)
            cur += 1
        cap.release()
        if not got:
            raise RuntimeError(f"no frames decoded from {video_path}")
        fallback = next(iter(got.values()))
        frames = [got.get(int(i), fallback) for i in want]
        return np.ascontiguousarray(np.stack(frames))
    # window-based fallback via seconds
    duration_guess = 10.0
    start, end = 0.0, duration_guess
    video = decode_window(video_path, start, end, num_frames, backend)
    return video
