"""Data parallel over processes in the PyTorch port (``parallel/``,
``utils/misc.py:launch_job``) on the CPU: two gloo ranks against one
process on the global batch, and against the JAX package on a 2-device
mesh.

One group of two ranks is launched for the module (``launch_job`` with
``NUM_GPUS 2``, ``file://`` rendezvous in ``tmp_path``, joined with a
time limit of its own); it runs the programs of ``torch_ddp_ranks.py``,
which the parent runs again as one process:

- the order-pretraining step with every random stream on (drop path 0.2,
  the diffusion draws, the recognition subset: F11), once with one
  micro-batch and once accumulating 2 under ``no_sync``;
- the same step under ``TPU.SHARD_OPT_STATE`` (ZeRO-1), with the
  checkpoint each run writes;
- the EK step (``MIXUP.ENABLED`` as the config sets it, which the EPIC
  branch does not apply, in JAX as here) and the COIN head under mixup
  and CutMix, whose pairs cross the ranks;
- the pretraining step on fixed draws, held against JAX's step on a
  2-device mesh;
- ``test_net.test`` on the COIN and EK dummy splits (the meters take
  every rank's rows);
- ``train_net.train`` resumed after its first epoch against a straight
  run, under ZeRO.

Tolerances (fp32): metrics 2e-5, gradients 5e-5 (atol = rtol), updated
parameters 5e-5, or within 2 lr where a gradient is below 1e-6 (AdamW's
first step is about lr x sign(g) there, ``test_torch_train.py``).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_ranks as ranks
from procedurevrl_tpu.config import get_cfg as jax_get_cfg
from procedurevrl_tpu.datasets.loader import Loader as JaxLoader
from procedurevrl_tpu.engine.steps import TrainState
from procedurevrl_tpu.engine.steps import make_train_step as jax_make_train_step
from procedurevrl_tpu.parallel.mesh import (
    batch_sharding, build_mesh, replicated, shard_batch,
)
from procedurevrl_tpu.solver import construct_optimizer as jax_optimizer
from procedurevrl_tpu.solver import lr_schedule as jax_lr_schedule
from procedurevrl_tpu.utils.converter import convert_procedurevrl
from procedurevrl_torch.config import load_config
from procedurevrl_torch.datasets import howto100m
from procedurevrl_torch.datasets.loader import construct_loader
from procedurevrl_torch.ops import spatial_attention as k1
from procedurevrl_torch.parallel import collectives, ddp
from procedurevrl_torch.tools import train_net
from procedurevrl_torch.utils import misc, weights
from test_torch_train import (
    GEOM, TOWERS, JaxOrderTransformer, _bank, _batch, _cfg, _draws, _flat,
    _jax_params,
)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
GROUP_SECONDS = 600  # the whole group, spawn to join


def _launch(programs, out_dir, join_timeout=GROUP_SECONDS):
    cfg = load_config(None, ["NUM_GPUS", "2"])
    misc.launch_job(cfg, f"file://{out_dir}/group",
                    functools.partial(ranks.run_programs, programs=programs,
                                      out_dir=str(out_dir)),
                    "cpu", timeout=120, join_timeout=join_timeout)


def _result(out_dir, name, rank=0):
    return torch.load(os.path.join(out_dir, f"{name}.{rank}.pt"),
                      weights_only=False)


@pytest.fixture(scope="module")
def fixed_inputs():
    """``test_torch_train.py``'s model, bank, batch and fixed draws, and
    the JAX parameters."""
    bank = _bank()
    jmodel, params = _jax_params(bank)
    state = {k: v.numpy() for k, v in weights.params_from_jax(params).items()}
    return dict(bank=bank, batch=_batch(2), draws=_draws(3), jmodel=jmodel,
                params=params, state=state)


@pytest.fixture(scope="module")
def group(tmp_path_factory, fixed_inputs):
    out = tmp_path_factory.mktemp("ddp")
    for sub in ("plain", "zero", "test_coin", "test_epic", "resume"):
        os.makedirs(out / sub)
    coin = [ranks.STEP_CLS, ["DEV.LOAD_DUMMY_DATA", "True", "TRAIN.ENABLE",
                             "False", "DEV.MATCH_LANG_EMB", "True",
                             "DEV.TEST_LANG_EMB", ranks.BANK,
                             "TEST.BATCH_SIZE", "6",
                             "TEST.NUM_ENSEMBLE_VIEWS", "2"]]
    ek = [ranks.EK, ["DEV.LOAD_DUMMY_DATA", "True", "TEST.BATCH_SIZE", "24",
                     "TEST.NUM_ENSEMBLE_VIEWS", "1",
                     "TEST.NUM_SPATIAL_CROPS", "1"]]
    fixed = str(out / "fixed_inputs.pt")
    torch.save({"geom": GEOM, "towers": TOWERS, **{
        k: fixed_inputs[k] for k in ("state", "bank", "batch", "draws")}},
        fixed)
    programs = [
        ("pretrain", "pretrain", dict(save_dir=str(out / "plain"))),
        ("accum", "pretrain", dict(accum=2)),
        ("zero", "pretrain", dict(opts=("TPU.SHARD_OPT_STATE", "True"),
                                  save_dir=str(out / "zero"))),
        ("epic", "epic", {}),
        ("mixup", "mixup", {}),
        ("fixed", "fixed", dict(path=fixed)),
        ("test_coin", "run_test", dict(config=coin[0], opts=coin[1],
                                       out_dir=str(out / "test_coin"),
                                       videos=5)),
        ("test_epic", "run_test", dict(config=ek[0], opts=ek[1],
                                       out_dir=str(out / "test_epic"))),
        ("resume", "resume", dict(out_dir=str(out / "resume"),
                                  opts=("TPU.SHARD_OPT_STATE", "True"))),
    ]
    _launch(programs, out)
    return out


def _one(name):
    """The program ``name`` as one process."""
    if name == "accum":
        return ranks.pretrain(accum=2)
    return getattr(ranks, name)()


def _same_step(got, want, lr):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, **TOL, err_msg=k)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                   **GRAD_TOL, err_msg=k)
        sure = g.abs() > 1e-6
        p, q = got["params"][k], want["params"][k]
        np.testing.assert_allclose(p[sure].numpy(), q[sure].numpy(),
                                   atol=5e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(p[~sure].numpy(), q[~sure].numpy(),
                                   atol=2 * lr + 5e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["pretrain", "accum", "epic", "mixup"])
def test_two_ranks_equal_one_process(name, group):
    """Both ranks hold the parameters of one process on the global batch,
    every random stream on: the draws are the global batch's (F11), the
    gradients averaged once after the accumulated micro-batches, and
    under mixup row i pairs with row B - 1 - i across the ranks."""
    want = _one(name)
    for rank in (0, 1):
        got = _result(group, name, rank)
        if name == "mixup":
            for branch in ("mixup", "cutmix"):
                _same_step(got[branch], want[branch],
                           want[branch]["metrics"]["lr"])
        else:
            _same_step(got, want, want["metrics"]["lr"])


def test_the_draws_are_the_global_batchs():
    """F11 at its root: under a group every draw over the batch axis is
    the global batch's rows of this rank (``draw_rows``), and the
    single-process draw is what it was."""
    gen = torch.Generator().manual_seed(3)
    whole = torch.rand(6, generator=gen)
    gen.manual_seed(3)
    assert torch.equal(collectives.draw_rows(
        lambda n: torch.rand(n, generator=gen), 6), whole)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.distributed, "is_initialized", lambda: True)
        mp.setattr(torch.distributed, "get_world_size", lambda: 3)
        mp.setattr(torch.distributed, "get_rank", lambda: 1)
        gen.manual_seed(3)
        got = collectives.draw_rows(lambda n: torch.rand(n, generator=gen), 2)
        assert torch.equal(got, whole[2:4])
        gen.manual_seed(3)
        noise = torch.randn(2, 6, 4, generator=gen)
        gen.manual_seed(3)
        got = collectives.draw_rows(
            lambda n: torch.randn(2, n, 4, generator=gen), 2, dim=1)
        assert torch.equal(got, noise[:, 2:4])


def test_zero_keeps_the_parameters_and_the_file(group):
    """``TPU.SHARD_OPT_STATE``: each rank keeps about half the optimizer
    state, the parameters are those of the plain optimizer, and the
    checkpoint holds the one-process layout of the plain run's file."""
    plain, zero = _result(group, "pretrain"), _result(group, "zero")
    for k, p in plain["params"].items():
        assert torch.equal(zero["params"][k], p), k
    z0, z1 = (_result(group, "zero", r)["optimizer_bytes"] for r in (0, 1))
    assert z0 + z1 == plain["optimizer_bytes"]
    assert max(z0, z1) < 0.75 * plain["optimizer_bytes"]
    files = [torch.load(os.path.join(group, d, "checkpoints",
                                     "checkpoint_epoch_00001.pyth"),
                        weights_only=False) for d in ("plain", "zero")]
    a, b = files
    assert set(a) == set(b)
    for k in a["model_state"]:
        assert torch.equal(a["model_state"][k], b["model_state"][k]), k
    sa, sb = a["optimizer_state"], b["optimizer_state"]
    assert sa["param_groups"] == sb["param_groups"]
    assert set(sa["state"]) == set(sb["state"])
    for i, st in sa["state"].items():
        assert set(st) == set(sb["state"][i])
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert (a["epoch"], a["step"]) == (b["epoch"], b["step"])


def test_two_ranks_match_jax_on_a_two_device_mesh(group, fixed_inputs,
                                                  monkeypatch):
    """The port's two ranks against JAX's step over a 2-device data mesh
    (the batch sharded, the parameters replicated), on fixed draws."""
    fx = fixed_inputs
    orig = JaxOrderTransformer.pretrain
    draws = fx["draws"]

    def fixed_pretrain(self, x, mask_inds=None, pad_start=None,
                       level_noise=None):
        return orig(self, x, jnp.asarray(draws["mask_inds"]),
                    jnp.asarray(draws["pad_start"]),
                    jnp.asarray(draws["level_noise"]))

    monkeypatch.setattr(JaxOrderTransformer, "pretrain", fixed_pretrain)
    jcfg = _cfg(jax_get_cfg())
    sched = jax_lr_schedule(jcfg, 10)
    tx = jax_optimizer(fx["params"], jcfg, sched)
    jstep = jax_make_train_step(fx["jmodel"], tx, jcfg, fx["bank"], sched, 1)
    mesh = build_mesh(devices=jax.devices()[:2], data=-1, model=1)
    step = jax.jit(jstep, in_shardings=(replicated(mesh),
                                        batch_sharding(mesh),
                                        replicated(mesh)))
    with mesh:
        state, metrics = step(TrainState.create(fx["params"], tx),
                              shard_batch(mesh, fx["batch"]),
                              jax.random.PRNGKey(5))
    new = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    got = _result(group, "fixed")
    for k in ("loss", "kl", "mse", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], float(metrics[k]),
                                   **TOL, err_msg=k)
    after = _flat(convert_procedurevrl(got["params"]))
    grads = _flat(convert_procedurevrl(got["grads"]))
    lr = got["metrics"]["lr"]
    for k, p in after.items():
        sure = np.abs(grads[k]) > 1e-6
        np.testing.assert_allclose(p[sure], new[k][sure], atol=5e-5, rtol=0,
                                   err_msg=str(k))
        np.testing.assert_allclose(p[~sure], new[k][~sure],
                                   atol=2 * lr + 5e-5, rtol=0, err_msg=str(k))


@pytest.mark.parametrize("name", ["test_coin", "test_epic"])
def test_rank0_test_meter_equals_one_process(name, group, tmp_path):
    """``test_net.test`` on two ranks: rank 0's stats and written results
    are one process's (the last batch is padded on one rank only)."""
    got, other = _result(group, name), _result(group, name, 1)
    assert {k: v for k, v in other["stats"].items() if k != "clips_per_sec"
            } == {k: v for k, v in got["stats"].items()
                  if k != "clips_per_sec"}
    config, opts = ((ranks.STEP_CLS, ["DEV.LOAD_DUMMY_DATA", "True",
                                      "TRAIN.ENABLE", "False",
                                      "DEV.MATCH_LANG_EMB", "True",
                                      "DEV.TEST_LANG_EMB", ranks.BANK,
                                      "TEST.BATCH_SIZE", "6",
                                      "TEST.NUM_ENSEMBLE_VIEWS", "2"])
                    if name == "test_coin" else
                    (ranks.EK, ["DEV.LOAD_DUMMY_DATA", "True",
                                "TEST.BATCH_SIZE", "24",
                                "TEST.NUM_ENSEMBLE_VIEWS", "1",
                                "TEST.NUM_SPATIAL_CROPS", "1"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(howto100m, "NUM_SYNTHETIC", 5)
        want = ranks.run_test(config, opts, str(tmp_path))
    for k, v in want["stats"].items():
        if k == "clips_per_sec":
            continue
        assert got["stats"][k] == v, k
    assert set(got["results"]) == set(want["results"])
    for k, v in want["results"].items():
        np.testing.assert_allclose(got["results"][k], v, **TOL, err_msg=k)


def test_resume_on_two_ranks_is_bit_for_bit(group):
    """Two ranks under ZeRO: one epoch, then a run resumed from its file
    (the consolidated optimizer state, each rank keeping its share) ends
    where two straight epochs end, bit for bit."""
    got = _result(group, "resume")
    assert got["resumed_start"] == (1, 2) and got["straight_start"] == (0, 0)
    for k, p in got["straight"].items():
        assert torch.equal(got["resumed"][k], p), k


def _rank_batch(monkeypatch, world, rank, num_gpus, num_shards, split):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: world)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
    cfg = load_config(ranks.STEP_CLS, [
        "DEV.LOAD_DUMMY_DATA", "True", "DATA.NUM_FRAMES", "2",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "DATA.TRAIN_JITTER_SCALES", "[36, 40]", "DATA_LOADER.NUM_WORKERS",
        "2", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4",
        "NUM_GPUS", str(num_gpus), "NUM_SHARDS", str(num_shards),
        "GLOBAL_BATCH_SIZE", "32"])
    loader = construct_loader(cfg, split)
    return cfg, loader, next(iter(loader))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_rank_rows_are_jax_device_rows(split, num_shards, monkeypatch):
    """F12: the global batch is ``BATCH_SIZE x hosts`` (JAX
    ``datasets/loader.py:260-271``), and rank ``h x NUM_GPUS + d`` holds
    the rows JAX's ``batch_sharding`` gives device ``d`` of host ``h``;
    the accumulation count is ``GLOBAL_BATCH_SIZE // (BATCH_SIZE x
    hosts)``."""
    num_gpus = 2
    world = num_gpus * num_shards
    if True:
        jcfg = jax_get_cfg()
        jcfg.merge_from_file(ranks.STEP_CLS)
        jcfg.merge_from_list(["DEV.LOAD_DUMMY_DATA", "True",
                              "DATA.NUM_FRAMES", "2", "DATA.TRAIN_CROP_SIZE",
                              "32", "DATA.TEST_CROP_SIZE", "32",
                              "DATA.TRAIN_JITTER_SCALES", "[36, 40]"])
        from procedurevrl_tpu.datasets.build import build_dataset
        dataset = build_dataset(jcfg.TRAIN.DATASET, jcfg, split)
        mesh = build_mesh(devices=jax.devices()[:num_gpus], data=-1, model=1)
        for host in range(num_shards):
            jloader = JaxLoader(dataset, global_batch_size=4 * num_shards,
                                shuffle=split == "train",
                                drop_last=split == "train", num_workers=2,
                                num_hosts=num_shards, host_id=host,
                                seed=jcfg.RNG_SEED)
            jbatch = next(iter(jloader))[0]
            sharded = shard_batch(mesh, {"index": jbatch["index"]})["index"]
            for shard in sharded.addressable_shards:
                d = shard.device.id - mesh.devices.flat[0].id
                rank = host * num_gpus + d
                cfg, loader, (batch, n_valid, _) = _rank_batch(
                    monkeypatch, world, rank, num_gpus, num_shards, split)
                assert len(loader) == len(jloader)
                np.testing.assert_array_equal(batch["index"],
                                              np.asarray(shard.data))
                assert n_valid == 2
                if split == "train":
                    assert ddp.accumulation(cfg) == 32 // (4 * num_shards)


def test_the_k1_route_follows_the_group(monkeypatch):
    """Under grad one process takes K1sp + K1b (the saved probabilities),
    a group of two the recompute pair K1f + K1br (JAX
    ``pallas_attention.py:1205``); without grad K1f either way."""
    taken = []
    for name in ("SpatialAttention", "SpatialAttentionRecompute"):
        fn = getattr(k1, name)
        monkeypatch.setattr(fn, "apply", functools.partial(
            lambda name, orig, *a: taken.append(name) or orig(*a), name,
            fn.apply))
    qkv = torch.randn(2, 16, 3 * 128, requires_grad=True)
    qkv_c = torch.randn(2, 1, 3 * 128, requires_grad=True)
    k1.spatial_attention_autograd(qkv, qkv_c, 2, 0.125)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    out, out_c = k1.spatial_attention_autograd(qkv, qkv_c, 2, 0.125)
    (out.sum() + out_c.sum()).backward()
    with torch.no_grad():
        k1.spatial_attention_autograd(qkv, qkv_c, 2, 0.125)
    assert taken == ["SpatialAttention", "SpatialAttentionRecompute"]


def test_the_mesh_and_the_group_refusals(tmp_path, monkeypatch):
    """``TPU.MESH_MODEL 2`` raises naming Queue 1 item 7; a group that is
    not ``NUM_GPUS x NUM_SHARDS`` raises; NCCL needs a card; one process
    of ``NUM_GPUS 1, NUM_SHARDS 1`` runs in place with no group."""
    cfg = load_config(None, ["TPU.MESH_MODEL", "2", "OUTPUT_DIR",
                             str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 7"):
        train_net.train(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="MESH_MODEL"):
        ddp.check_mesh(cfg)
    cfg = load_config(None, ["NUM_GPUS", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl needs a CUDA device"):
        misc.backend_of("cuda", cfg)
    assert misc.backend_of("cpu", cfg) == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        misc.launch_job(cfg, "file:///nowhere", print, "cuda")
    seen = []
    misc.launch_job(load_config(None, []), "file:///nowhere",
                    lambda c, d: seen.append((d, collectives.in_group())),
                    "cpu")
    assert seen == [(torch.device("cpu"), False)]
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    with pytest.raises(ValueError, match="NUM_GPUS 2 x NUM_SHARDS 1"):
        ddp.num_hosts(cfg)


def test_a_failing_rank_fails_the_group(tmp_path):
    """A rank that raises ends the group and the launch raises; a group
    past its time limit is killed and raises."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        _launch([("f", "fails", dict(seconds=60))], tmp_path)
    with pytest.raises(TimeoutError):
        _launch([("s", "sleeps", dict(seconds=120))], tmp_path,
                join_timeout=8)
