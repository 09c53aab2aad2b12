#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build the CUDA kernels from ``procedurevrl_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the build time;
2. K1 (spatial attention forward) and 3. K2 (temporal attention forward)
   against their plain PyTorch versions at the main-path shapes of
   TimeSformer-B with 16 views (bf16), plus a small float32 case each;
   time the kernel, the plain version and one PyTorch library call that
   computes the same function (the yardstick; the port never calls it);
   compute the bound from the shapes;
4. the slice: ``procedurevrl_torch.tools.test_net.test`` on
   ``configs/COIN/step_classification.yaml`` with synthetic data, full
   TimeSformer-B in bf16, 192 clips in batches of 16; launch counts of
   both kernels must be 12 per batch; one batch is held against the same
   model run through the plain versions.
The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, data sheet
BF16_FLOPS = 989e12         # dense tensor-core peak
# bf16 kernel vs plain version: both round p and the output to bf16; sums
# run in another order, so outputs may differ by a bf16 ulp or two
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
# post-softmax predictions of 12 bf16 blocks, kernels vs plain versions
PRED_ATOL = 1e-2
DEPTH = 12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, iters: int = 20, reps: int = 21) -> float:
    """Device time of one call in ms: the median over ``reps`` of CUDA-event
    time around ``iters`` back-to-back calls, divided by ``iters``.  A device
    sleep is queued first, so the host enqueues the whole run before the
    card reaches it and host launch overhead does not count."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms of device time
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def profile_step(torch, step, batch, top: int = 12) -> None:
    """Device time by kernel for one eval step (torch.profiler), and the
    device busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile of one eval step (16 clips): wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:100]}")


def compare(torch, name, got, ref, tol) -> float:
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-3)).max().item()
    ok = torch.allclose(got, ref, **tol) and bool(torch.isfinite(got).all())
    print(f"{name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(tol atol {tol['atol']} rtol {tol['rtol']}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def phase_k1(torch, F, k1) -> dict:
    bt, n, heads, d = 8 * 16, 196, 12, 64
    c = heads * d
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(bt, n, 3 * c, generator=g, device="cuda").bfloat16()
    qkv_c = torch.randn(bt, 1, 3 * c, generator=g, device="cuda").bfloat16()
    out, out_c = k1.spatial_attention(qkv, qkv_c, heads, scale)
    ref, ref_c = k1.spatial_attention_plain(qkv, qkv_c, heads, scale)
    err = max(compare(torch, "K1 bf16 frames", out, ref, BF16_TOL),
              compare(torch, "K1 bf16 cls", out_c, ref_c, BF16_TOL))
    # float32 (scalar kernel) at a smaller batch
    q32, qc32 = qkv[:4].float(), qkv_c[:4].float()
    o32, oc32 = k1.spatial_attention(q32, qc32, heads, scale)
    r32, rc32 = k1.spatial_attention_plain(q32, qc32, heads, scale)
    compare(torch, "K1 fp32 frames", o32, r32, FP32_TOL)
    compare(torch, "K1 fp32 cls", oc32, rc32, FP32_TOL)

    ms = time_ms(torch, lambda: k1.spatial_attention(qkv, qkv_c, heads, scale))
    plain_ms = time_ms(torch, lambda: k1.spatial_attention_plain(
        qkv, qkv_c, heads, scale), iters=10)
    # yardstick: SDPA on [BT, H, N+1, d] with the CLS concatenated (the
    # same function while every logit stays below 80)
    x = torch.cat([qkv, qkv_c], dim=1).view(bt, n + 1, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
    nbytes = bt * (n + 1) * (3 * c + c) * 2
    flops = 2 * 2 * bt * heads * (n + 1) ** 2 * d
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    print(f"K1 [{bt},{n},{3 * c}] bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return {"name": k1.KERNEL, "route": "cuda",
            "source": "procedurevrl_torch/csrc/spatial_attention.cu",
            "replaces": "procedurevrl_tpu/ops/pallas_attention.py:536",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def phase_k2(torch, F, k2) -> dict:
    b, t, n, heads, d = 16, 8, 196, 12, 64
    c = heads * d
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(b, t, n, 3 * c, generator=g, device="cuda").bfloat16()
    out = k2.temporal_attention(qkv, heads, scale)
    ref = k2.temporal_attention_plain(qkv, heads, scale)
    err = compare(torch, "K2 bf16", out, ref, BF16_TOL)
    for tt in (8, 3):
        q32 = qkv[:2, :tt].float().contiguous()
        compare(torch, f"K2 fp32 T={tt}", k2.temporal_attention(q32, heads, scale),
                k2.temporal_attention_plain(q32, heads, scale), FP32_TOL)

    ms = time_ms(torch, lambda: k2.temporal_attention(qkv, heads, scale))
    plain_ms = time_ms(torch, lambda: k2.temporal_attention_plain(
        qkv, heads, scale), iters=10)
    # yardstick: SDPA on [B*N, H, T, d]
    x = qkv.view(b, t, n, 3, heads, d).permute(3, 0, 2, 4, 1, 5)
    q, k, v = (x[i].reshape(b * n, heads, t, d).contiguous() for i in range(3))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
    nbytes = b * t * n * (3 * c + c) * 2
    flops = 2 * 2 * b * n * heads * t * t * d
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    print(f"K2 [{b},{t},{n},{3 * c}] bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": k2.KERNEL, "route": "cuda",
            "source": "procedurevrl_torch/csrc/temporal_attention.cu",
            "replaces": "procedurevrl_tpu/ops/pallas_attention.py:1486",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


@contextlib.contextmanager
def plain_attention(k1, k2):
    """Route the model through the plain versions (reference run only)."""
    saved = k1.spatial_attention, k2.temporal_attention
    k1.spatial_attention = k1.spatial_attention_plain
    k2.temporal_attention = k2.temporal_attention_plain
    try:
        yield
    finally:
        k1.spatial_attention, k2.temporal_attention = saved


def phase_slice(torch, k1, k2, _build) -> dict:
    """Drive the slice; return the launch counts of its run."""
    from procedurevrl_torch.config import load_config
    from procedurevrl_torch.datasets.synthetic import SyntheticClips
    from procedurevrl_torch.engine.steps import make_eval_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.tools.test_net import test

    cfg = load_config(os.path.join(ROOT, "configs/COIN/step_classification.yaml"),
                      ["TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
                       "DEV.LOAD_DUMMY_DATA", "True", "TEST.BATCH_SIZE", "16",
                       "DEV.TEST_LANG_EMB",
                       os.path.join(ROOT, "data/clip_step_emb_coin.pth")])
    dataset = SyntheticClips(cfg, "test")
    n_batches = dataset.num_batches(cfg.TEST.BATCH_SIZE)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    stats = test(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: {len(dataset)} clips in {n_batches} batches, top1 "
          f"{stats['top1_acc']} top5 {stats['top5_acc']}, "
          f"{stats['clips_per_sec']:.2f} clips/s over batches 2..{n_batches}, "
          f"wall {wall:.1f} s (model build included), peak memory "
          f"{peak / 2 ** 30:.3f} GiB, launches {launches}")
    for key in (k1.KERNEL, k2.KERNEL):
        if launches.get(key, 0) != DEPTH * n_batches:
            fail(f"{key} launched {launches.get(key, 0)} times, expected "
                 f"{DEPTH} x {n_batches}")
    for key in ("top1_acc", "top5_acc"):
        if not math.isfinite(float(stats[key])):
            fail(f"{key} is not finite")

    # one batch: kernels vs the same model through the plain versions
    model, bank = build_model(cfg, "cuda")
    step = make_eval_step(model, cfg, bank)
    batch = next(dataset.batches(cfg.TEST.BATCH_SIZE, "cuda"))
    preds = step(batch)
    with plain_attention(k1, k2):
        ref = step(batch)
    torch.cuda.synchronize()
    if preds.shape != (cfg.TEST.BATCH_SIZE, cfg.MODEL.NUM_CLASSES):
        fail(f"predictions have shape {tuple(preds.shape)}")
    if not bool(torch.isfinite(preds).all()):
        fail("predictions are not finite")
    diff = (preds - ref).abs().max().item()
    agree = (preds.argmax(1) == ref.argmax(1)).float().mean().item()
    print(f"slice batch vs plain versions: max |dpred| {diff:.3e} "
          f"(atol {PRED_ATOL}), top-1 agreement {agree:.3f}, "
          f"max pred {preds.max().item():.4f}")
    if diff > PRED_ATOL:
        fail("predictions through the kernels disagree with the plain path")
    profile_step(torch, step, batch)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from procedurevrl_torch.ops import _build
    from procedurevrl_torch.ops import spatial_attention as k1
    from procedurevrl_torch.ops import temporal_attention as k2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(report)} (parallel nvcc)")
    for name, rep in report.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = [phase_k1(torch, F, k1), phase_k2(torch, F, k2)]
    launches = phase_slice(torch, k1, k2, _build)
    for rec in kernels:
        rec["launches"] = launches.get(rec["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi_line)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
