"""Weights across the PyTorch port and the JAX package.

- JAX parameter tree -> ``params_from_jax`` -> port ``state_dict()`` ->
  JAX ``convert_procedurevrl`` gives back the same tree, bit for bit;
- a reference-style ``.pyth`` checkpoint (``model.``-prefixed keys, keys of
  branches the port does not run) loads into the port; a parameter the file
  lacks keeps its init and is logged, as JAX ``load_reference_params`` has
  it.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from procedurevrl_tpu.models.procedurevrl import ProcedureVRL as JaxProcedureVRL
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.models.procedurevrl import ProcedureVRL
from procedurevrl_torch.utils import weights

GEOM = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            num_frames=4, drop_path_rate=0.0)


def _jax_params():
    model = JaxProcedureVRL(**GEOM, num_classes=778, label_dim=512,
                            match_lang_emb=True)
    x = jnp.zeros((1, 4, 32, 32, 3))
    bank = jnp.zeros((778, 512))
    params = jax.jit(lambda k: model.init(k, x, label_emb=bank))(
        jax.random.PRNGKey(0))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_params_round_trip_bit_for_bit():
    params = _jax_params()
    model = ProcedureVRL(**GEOM)
    model.load_state_dict(weights.params_from_jax(params), strict=True)
    back = convert_procedurevrl(model.state_dict())
    flat, flat_back = flatten_dict(params), flatten_dict(back)
    assert set(flat) == set(flat_back)
    for key, val in flat.items():
        assert flat_back[key].dtype == np.float32
        assert np.array_equal(flat_back[key], val), key


def test_reference_checkpoint_loads(tmp_path):
    src = ProcedureVRL(**GEOM)
    src.reset_parameters(torch.Generator().manual_seed(5))
    state = {"model." + k: v for k, v in src.state_dict().items()}
    state["model.order_tfm.pad_embedding.weight"] = torch.zeros(1, 512)
    path = tmp_path / "checkpoint_epoch_00001.pyth"
    torch.save({"model_state": state, "epoch": 1}, path)

    loaded = weights.load_reference_checkpoint(str(path))
    assert all(not k.startswith("model.") for k in loaded)
    dst = ProcedureVRL(**GEOM)
    ignored = weights.load_into(dst, loaded)
    assert ignored == ["order_tfm.pad_embedding.weight"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k

    # JAX's rule: a parameter the file lacks keeps its init, and is logged
    del state["model.head.weight"]
    torch.save({"model_state": state, "epoch": 1}, path)
    dst = ProcedureVRL(**GEOM)
    dst.reset_parameters(torch.Generator().manual_seed(6))
    init = dst.head.weight.detach().clone()
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("procedurevrl_torch")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        assert weights.load_reference_params(dst, str(path)) == 1
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    assert torch.equal(dst.head.weight, init)
    for k, v in src.state_dict().items():
        if k != "head.weight":
            assert torch.equal(dst.state_dict()[k], v), k
    assert any("kept at init" in r.getMessage()
               and "head.weight" in r.getMessage() for r in records)
