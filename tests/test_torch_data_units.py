"""The host data pipeline's parts, the PyTorch port against the JAX
package on the CPU: the per-sample random streams, the decoder (``cv2`` on
clips written by ``cv2.VideoWriter``, the ``ffmpeg`` pipe on bytes a fake
``subprocess.run`` hands both packages), the native preprocess, the
transforms, the BPE and hash tokenizers, and the port's import boundary
(no ``pandas`` or ``PIL``; ``cv2`` and ``av`` only inside the functions
that use them).

Every comparison is bit for bit (the same numpy draws, the same ``cv2`` and
the same native arithmetic on the same bytes), except the ``F.interpolate``
resize, which both packages run as the same torch call.  Clips are 64x48 at
30 fps, 12 s.
"""

import ast
import gzip
import os
import subprocess

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from procedurevrl_tpu.datasets import decoder as jax_decoder
from procedurevrl_tpu.datasets import rng as jax_rng
from procedurevrl_tpu.datasets import tokenizer as jax_tokenizer
from procedurevrl_tpu.datasets import transform as jax_transform
from procedurevrl_tpu.datasets import videoproc as jax_videoproc
from procedurevrl_torch.datasets import decoder, rng, tokenizer, transform
from procedurevrl_torch.datasets import videoproc
from procedurevrl_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPS, W, H, DUR = 30.0, 64, 48, 12
MEAN, STD = [0.45, 0.45, 0.45], [0.225, 0.225, 0.225]


def _write_video(path: str) -> None:
    """Frame i: a gray ramp over x shifted by i, so that frames and
    columns differ through the codec."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    assert w.isOpened()
    ramp = np.arange(W, dtype=np.int64)[None, :, None]
    for i in range(int(FPS * DUR)):
        img = ((ramp * 3 + i) % 256).astype(np.uint8)
        w.write(np.broadcast_to(img, (H, W, 3)).copy())
    w.release()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clips") / "clip.mp4")
    _write_video(path)
    return path


@pytest.mark.parametrize("text", ["video0", "synthetic://video17", "ü"])
def test_stable_hash_and_sample_rng(text):
    assert rng.stable_hash(text) == jax_rng.stable_hash(text)
    ours, theirs = rng.EpochRNG(), jax_rng.EpochRNG()
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for index, det in ((0, False), (17, False), (17, True), (10**6, True)):
            a = ours.sample_rng(index, 1000003, det).randint(0, 2**31, 8)
            b = theirs.sample_rng(index, 1000003, det).randint(0, 2**31, 8)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("args", [(0, 29, 8), (2.5, 7.1, 4), (-3, 100, 5)])
def test_temporal_sampling_and_start_end(args):
    frames = np.arange(30 * 2).reshape(30, 2)
    np.testing.assert_array_equal(decoder.temporal_sampling(frames, *args),
                                  jax_decoder.temporal_sampling(frames, *args))
    for clip_idx in (-1, 0, 2):
        a = decoder.get_start_end_idx(120, 9.0, clip_idx, 3,
                                      np.random.RandomState(5))
        b = jax_decoder.get_start_end_idx(120, 9.0, clip_idx, 3,
                                          np.random.RandomState(5))
        assert a == b


@pytest.mark.parametrize("window", [(2.0, 3.0, 8), (2.0, 10.0, 4),
                                    (0.0, 0.01, 2)],
                         ids=["sequential", "sparse_seek", "one_frame"])
def test_decode_cv2_window_is_bit_for_bit(clip, window):
    """Both branches: a dense window decoded in order, and a window longer
    than 16 frames per wanted frame, one seek per frame."""
    a = decoder.decode_cv2_window(clip, *window)
    b = jax_decoder.decode_cv2_window(clip, *window)
    assert a.shape == (window[2], H, W, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        decoder.decode_window(clip, *window, backend="cv2"), b)


def test_decode_failures_raise_alike(clip, tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    for mod in (decoder, jax_decoder):
        with pytest.raises(RuntimeError, match="cannot open"):
            mod.decode_cv2_window(str(bad), 0.0, 1.0, 2)
        with pytest.raises(RuntimeError, match="no frames"):
            mod.decode_cv2_window(clip, 40.0, 41.0, 2)
        with pytest.raises(ValueError, match="unknown decode backend"):
            mod.decode_window(clip, 0.0, 1.0, 2, backend="gpu")


@pytest.mark.parametrize("clip_idx", [-1, 0, 2])
def test_decode_full_is_bit_for_bit(clip, clip_idx):
    a = decoder.decode_full(clip, 4, 8, clip_idx, 3, backend="cv2",
                            rng=np.random.RandomState(3))
    b = jax_decoder.decode_full(clip, 4, 8, clip_idx, 3, backend="cv2",
                                rng=np.random.RandomState(3))
    assert a.shape == (8, H, W, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_raw", [5, 1, 0])
def test_decode_ffmpeg_window_same_command_and_frames(monkeypatch, n_raw):
    """The ffmpeg pipe: a fake ``subprocess.run`` hands both packages the
    same rawvideo bytes (640x360 rgb24, plus a torn last frame); the
    command lines and the sampled frames are equal, and no frame raises."""
    raw = np.random.RandomState(n_raw).randint(
        0, 256, n_raw * 360 * 640 * 3 + 100, np.uint8).tobytes()
    calls = []

    def fake_run(cmd, stdout=None, check=False):
        calls.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0, stdout=raw)

    monkeypatch.setattr(subprocess, "run", fake_run)
    outs = []
    for mod in (decoder, jax_decoder):
        monkeypatch.setattr(mod, "_FFMPEG", "/usr/bin/ffmpeg")
        if n_raw == 0:
            with pytest.raises(RuntimeError, match="no frames"):
                mod.decode_window("v.mp4", 12.5, 21.5, 8, backend="auto")
        else:
            outs.append(mod.decode_window("v.mp4", 12.5, 21.5, 8,
                                          backend="auto"))
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0][calls[0].index("-vf") + 1] == "fps=1,scale=640:360"
    if outs:
        assert outs[0].shape == (8, 360, 640, 3)
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("geom", [
    (360, 640, 256, 455, 10, 120, 224, True),
    (48, 64, 36, 48, 0, 0, 32, False),
    (64, 48, 53, 40, 21, 8, 32, True),
    (48, 64, 48, 64, 16, 32, 32, False)])
def test_native_preprocess_equals_the_jax_library(geom):
    h, w, new_h, new_w, y, x, crop, flip = geom
    frames = np.random.RandomState(h + w).randint(0, 256, (3, h, w, 3),
                                                  np.uint8)
    a = videoproc.fused_preprocess(frames, new_h, new_w, y, x, crop, flip,
                                   MEAN, STD)
    assert jax_videoproc.available()
    b = jax_videoproc.fused_preprocess(frames, new_h, new_w, y, x, crop,
                                       flip, MEAN, STD)
    assert a.dtype == np.float32 and a.shape == (3, crop, crop, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(videoproc.resize_bilinear(frames, 40, 50),
                                  jax_videoproc.resize_bilinear(frames, 40, 50))


def test_the_library_is_the_ports_own_build():
    """Built from ``csrc/videoproc.cpp`` into ``build/torch_kernels``,
    never ``native/libvideoproc.so``; and a run counts its fused passes."""
    path = videoproc.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith(
        "videoproc-")
    videoproc.load()
    assert path.exists()
    assert (_build.CSRC / "videoproc.cpp").read_text().count(
        "vp_fused_preprocess") == 2
    before = videoproc.PASSES["fused_preprocess"]
    videoproc.fused_preprocess(np.zeros((1, 4, 4, 3), np.uint8), 4, 4, 0, 0,
                               4, False, MEAN, STD)
    assert videoproc.PASSES["fused_preprocess"] == before + 1


def test_a_failed_build_raises_with_the_compiler_error(monkeypatch, tmp_path):
    """No silent numpy fallback: a source that does not compile raises,
    naming g++'s error."""
    (tmp_path / "videoproc.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for videoproc.cpp"):
        _build.build_host("videoproc")
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("spatial_idx", [-1, 0, 1, 2])
@pytest.mark.parametrize("hw", [(360, 640), (64, 48)],
                         ids=["landscape", "portrait"])
def test_spatial_sampling_fused_is_bit_for_bit(uint8, spatial_idx, hw):
    """The fused pass in train (-1) and at the three test crops, uint8 and
    normalised outputs, scale jitter with inverse-uniform sampling in
    train: the port's library and draws equal JAX's."""
    frames = np.random.RandomState(spatial_idx + 7).randint(
        0, 256, (2, *hw, 3), np.uint8)
    kw = dict(spatial_idx=spatial_idx, min_scale=40, max_scale=52,
              crop_size=32, mean=MEAN, std=STD,
              inverse_uniform_sampling=spatial_idx == -1,
              output_uint8=uint8)
    a = transform.spatial_sampling_fused(frames, rng=np.random.RandomState(1),
                                         **kw)
    b = jax_transform.spatial_sampling_fused(
        frames, rng=np.random.RandomState(1), **kw)
    assert a.dtype == (np.uint8 if uint8 else np.float32)
    assert a.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spatial_idx", [-1, 0, 1, 2])
def test_spatial_sampling_on_float_frames(spatial_idx):
    """Float frames take the numpy chain (``tensor_normalize`` +
    ``spatial_sampling``, ``cv2`` resize), in ``spatial_sampling_fused``
    too."""
    frames = np.random.RandomState(3).rand(2, 50, 70, 3).astype(np.float32)
    kw = dict(spatial_idx=spatial_idx, min_scale=36, max_scale=44,
              crop_size=32)
    a = transform.spatial_sampling(frames, rng=np.random.RandomState(2), **kw)
    b = jax_transform.spatial_sampling(frames, rng=np.random.RandomState(2),
                                       **kw)
    np.testing.assert_array_equal(a, b)
    a = transform.spatial_sampling_fused(frames, mean=MEAN, std=STD,
                                         rng=np.random.RandomState(2), **kw)
    b = jax_transform.spatial_sampling_fused(frames, mean=MEAN, std=STD,
                                             rng=np.random.RandomState(2),
                                             **kw)
    np.testing.assert_array_equal(a, b)


def test_resize_without_cv2_takes_interpolate(monkeypatch):
    frames = np.random.RandomState(4).randint(0, 256, (2, 30, 40, 3),
                                              np.uint8)
    monkeypatch.setattr(transform, "_cv2", lambda: None)
    monkeypatch.setattr(jax_transform, "_HAS_CV2", False)
    a = transform._resize_clip(frames, 21, 33)
    b = jax_transform._resize_clip(frames, 21, 33)
    assert a.shape == (2, 21, 33, 3)
    np.testing.assert_allclose(a, b, rtol=0, atol=0)


def test_colour_and_lighting_jitter():
    frames = np.random.RandomState(5).rand(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(transform.grayscale(frames),
                                  jax_transform.grayscale(frames))
    for args in ((0.4, 0.4, 0.4), (0.0, 0.3, 0.0), (0.0, 0.0, 0.0)):
        np.testing.assert_array_equal(
            transform.color_jitter(frames, *args,
                                   rng=np.random.RandomState(6)),
            jax_transform.color_jitter(frames, *args,
                                       rng=np.random.RandomState(6)))
    eigval = [0.2175, 0.0188, 0.0045]
    eigvec = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
              [-0.5836, -0.6948, 0.4203]]
    np.testing.assert_array_equal(
        transform.lighting_jitter(frames, 0.1, eigval, eigvec,
                                  rng=np.random.RandomState(7)),
        jax_transform.lighting_jitter(frames, 0.1, eigval, eigvec,
                                      rng=np.random.RandomState(7)))
    u8 = (frames * 255).astype(np.uint8)
    np.testing.assert_array_equal(transform.tensor_normalize(u8, MEAN, STD),
                                  jax_transform.tensor_normalize(u8, MEAN, STD))


def _write_merges(path) -> str:
    """A merges file of CLIP's layout: a header, merges building a few
    words, fillers to the table's length."""
    pairs = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "</w>"),
             ("hell", "o</w>"), ("t", "h"), ("th", "e</w>"), ("c", "u"),
             ("cu", "t</w>")]
    alphabet = [chr(c) for c in range(ord("α"), ord("α") + 80)]
    fillers = []
    i = 0
    while len(pairs) + len(fillers) < 49152 - 256 - 2:
        a = alphabet[i % len(alphabet)] * (1 + i // len(alphabet) % 3 + 1)
        fillers.append(f"{a} {alphabet[(i * 7 + 3) % len(alphabet)]}{i}")
        i += 1
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + [" ".join(p) for p in pairs]
                          + fillers) + "\n")
    return str(path)


TEXTS = ["hello the cut", "Hello, THE  cut!! &amp; it's 2 cuts",
         "naïve café", " ", "word " * 100]


def test_bpe_tokenizer_matches_jax(tmp_path):
    path = _write_merges(tmp_path / "merges.txt.gz")
    ours, theirs = tokenizer.BPETokenizer(path), jax_tokenizer.BPETokenizer(
        path)
    assert ours.encoder == theirs.encoder
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text)
    a = tokenizer.tokenize(ours, TEXTS)
    np.testing.assert_array_equal(a, jax_tokenizer.tokenize(theirs, TEXTS))
    assert a.shape == (len(TEXTS), 77) and a.max() < 49408
    assert a[-1, 76] == tokenizer.EOT  # truncated, EOT kept
    with pytest.raises(RuntimeError, match="too long"):
        tokenizer.tokenize(ours, TEXTS[-1], truncate=False)
    assert isinstance(tokenizer.build_tokenizer(path),
                      tokenizer.BPETokenizer)


def test_hash_tokenizer_and_the_fallback_rule(tmp_path):
    missing = str(tmp_path / "absent.txt.gz")
    for mod in (tokenizer, jax_tokenizer):
        with pytest.raises(FileNotFoundError, match="DATA.BPE_PATH"):
            mod.build_tokenizer(missing)
        with pytest.raises(FileNotFoundError):
            mod.build_tokenizer("")
    ours = tokenizer.build_tokenizer(missing, allow_fallback=True)
    theirs = jax_tokenizer.build_tokenizer(missing, allow_fallback=True)
    assert isinstance(ours, tokenizer.HashTokenizer)
    a = tokenizer.tokenize(ours, TEXTS)
    np.testing.assert_array_equal(a, jax_tokenizer.tokenize(theirs, TEXTS))
    assert 0 < a[:, 1].min() and a.max() < 49408


def _port_modules():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "procedurevrl_torch")):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_port_modules()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_pandas_pil_or_module_level_decoders(path):
    """The port imports no ``pandas`` or ``PIL`` anywhere but inside the
    functions of the EPIC-Kitchens dataset (its annotation pickles) and
    RandAugment (PIL's ops), and ``cv2`` / ``av`` only inside functions,
    so it imports on a machine without them."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)

    def names(node):
        if isinstance(node, ast.Import):
            return [a.name.split(".")[0] for a in node.names]
        if isinstance(node, ast.ImportFrom):
            return [(node.module or "").split(".")[0]]
        return []

    inside_only = {"cv2", "av"}
    if os.path.relpath(path, ROOT) in PANDAS_PIL_INSIDE:
        inside_only |= {"pandas", "PIL"}
    else:
        for node in ast.walk(tree):
            assert not {"pandas", "PIL"} & set(names(node)), (path,
                                                               node.lineno)
    top = [n for n in tree.body]
    top += [n for t in tree.body if isinstance(t, (ast.Try, ast.If))
            for n in ast.walk(t)]
    for node in top:
        assert not inside_only & set(names(node)), (path, node.lineno)


# the modules that read pandas pickles or run PIL's ops, inside functions
PANDAS_PIL_INSIDE = {"procedurevrl_torch/datasets/epickitchens.py",
                     "procedurevrl_torch/datasets/rand_augment.py"}
