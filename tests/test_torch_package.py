"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "procedurevrl_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "procedurevrl_tpu")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import procedurevrl_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'procedurevrl_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "print(len(mods))\n" % (FORBIDDEN,))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch,
                                                        tmp_path):
    from procedurevrl_torch.config import get_cfg
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.tools import run_net
    from procedurevrl_torch.tools.test_net import test
    from procedurevrl_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "vit_base_patch16_224_develop"
    cfg.DEV.LOAD_DUMMY_DATA = True
    cfg.OUTPUT_DIR = str(tmp_path)
    for call in (lambda: resolve_device(None), lambda: resolve_device("cuda"),
                 lambda: build_model(cfg), lambda: test(cfg),
                 lambda: run_net.main(["TRAIN.ENABLE", "False",
                                       "DEV.LOAD_DUMMY_DATA", "True",
                                       "OUTPUT_DIR", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    from procedurevrl_torch.ops.spatial_attention import spatial_attention
    from procedurevrl_torch.ops.temporal_attention import temporal_attention

    qkv = torch.empty(2, 196, 3 * 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spatial_attention(qkv, torch.empty(2, 1, 3 * 128, device="meta"), 2,
                          0.125)
    with pytest.raises(ValueError, match="no kernel"):
        temporal_attention(qkv.view(2, 1, 196, 384), 2, 0.125)
    with pytest.raises(ValueError, match="do not fit"):
        spatial_attention(torch.zeros(2, 196, 3 * 128),
                          torch.zeros(2, 1, 3 * 100), 2, 0.125)


def test_chip_smoke_refuses_without_a_card():
    """No card: the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
