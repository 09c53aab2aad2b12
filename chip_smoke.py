#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build the CUDA kernels from ``procedurevrl_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the build time;
2. K1f (spatial attention forward) and 3. K2f (temporal attention forward)
   against their plain PyTorch versions at the eval shapes of
   TimeSformer-B with 16 views (bf16), plus a small float32 case each (K2f
   also bf16 cases of its ring's other tilings: an odd N at T = 1, 3, 9 and
   16, groups of 3 and 1 heads); time the kernel, the plain version and
   one PyTorch library call that computes the same function (the
   yardstick; the port never calls it); compute the bound from the shapes;
4. K1sp (forward that saves the probabilities; its outputs must equal
   K1f's bit for bit, one kernel) and K1b (its backward), and 5. K2b
   (temporal backward), the same way at the training shapes (18 clips x 8
   frames, bf16) plus small float32 cases (K2b also phase 3's tilings);
6. slice 1: ``procedurevrl_torch.tools.test_net.test`` on
   ``configs/COIN/step_classification.yaml`` with synthetic data
   (``DEV.LOAD_DUMMY_DATA``: since slice 18 every train and test run of a
   HowTo100M / COIN config reads the dataset's ``synthetic://`` index
   through the host loader, and a batch held against the plain path is
   the loader's first, copied to the card), full
   TimeSformer-B in bf16, 192 clips in batches of 16; launch counts of
   both forward kernels must be 12 per batch; one batch is held against
   the same model run through the plain versions;
7. slice 2: ``procedurevrl_torch.tools.train_net.train`` on
   ``configs/HowTo100M/procedurevrl_adamw.yaml`` with synthetic data, full
   TimeSformer-B + CLIP text tower + order transformer, AdamW, bf16,
   2 samples x 9 clips per step, ``TPU.REMAT`` as the config sets it:
   2 warm-up + 4 timed steps with finite losses and asserted launch
   counts, then 1 timed step without remat; one step is held against the
   same step through the plain versions; one step is profiled (device
   time by kernel group, K2's kernels a group of their own);
8. K5f/K5b (MViT pooled attention, head-last) at blocks 0 and 4 and
   K6f/K6b (head-split) at block 1 of MViT-v2-S with 18 clips (bf16), plus
   small float32 and bf16 cases with logits above 80, against their plain
   versions; timed beside SDPA with the bias as a float mask;
9. slice 3: ``train_net.train`` on
   ``configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml`` with synthetic
   data, full MViT-v2-S (16 frames at 224^2) + CLIP text tower + order
   transformer, AdamW, bf16, remat, 2 samples x 9 clips: 2 warm-up + 4
   timed steps with finite losses and asserted launch counts (per step 13
   K5f, 3 K6f, 13 K5b, 3 K6b, and no K7 or K8); one step against the plain
   path; one step profiled with its peak memory;
10. K8f (MViT's depthwise 3x3x3 pool, stride 1 and 2, and its stride-1 dx
   with reversed taps) and K8dw at the five stride-1 pool shapes of the
   MViT-v2-S training step (blocks 0, 2, 4-13, 14, 15), K8dw twice bit for
   bit, and the edge cases of the pool's tiling in bf16 and float32 (every
   stride), and K7f/K7b (key-tiled pooled attention, row-max softmax) at
   blocks 1 and 3 (18 clips, bf16), plus small float32 cases and a bf16
   case with logits above 80, against their plain versions; timed beside
   ``conv3d(groups=C)`` (K8 also beside its byte bound and fp32 FMA floor)
   and SDPA with the bias as a float mask;
11. slice 4: the same MViT-v2-S training as phase 9 with ``MVIT_POOL=kernel``
   and ``MVIT_KT=1`` set while the model is built (and restored after):
   2 warm-up + 4 timed steps with finite losses and asserted launch counts
   (per step 34 K8f, 17 K8f dx, 17 K8dw, 2 K7f, 2 K7b, 13 K5f, 1 K6f, 13
   K5b, 1 K6b); one step against the plain path; one step profiled;
12. K1br (recompute backward), K1bd (delta backward) and K1p (pipelined
   forward) at the training shape (K1p also at the eval shape), plus small
   float32 cases and a bf16 case with a logit above 80, against their plain
   versions; K1br must equal K1b on K1sp's probabilities and K1p must equal
   K1f bit for bit (one softmax device function); timed beside K1b / K1f
   and SDPA;
13. K2v3f / K2v3b (the saved-probability temporal pair) at the training
   shape, plus float32 cases at T = 8 and 3 and a bf16 case with a logit
   above 80, against their plain versions; timed beside K2f / K2b and SDPA;
   then in bf16 at T = 16 and 11 (one position per tensor-core tile) and
   at the training geometry with 16 frames, timed beside K2f / K2b; at
   both training geometries K2f must equal K2v3f and K2b must equal K2v3b
   fed K2v3f's p, bit for bit (one set of device functions);
14. slice 5, eval: phase 6's zero-shot test with ``SPATIAL_PIPE=1
   TEMPORAL_BATCHED=1`` set while the model is built (12 K1p and 12 K2v3f
   per batch, no K1f or K2f); one batch against the plain path;
15. slice 5, route A: phase 7's training (6 steps, remat) with
   ``SPATIAL_SAVE_PROBS=0 SPATIAL_PIPE=1 TEMPORAL_BATCHED=1`` (per step 12
   K1p, 12 K1br, 12 K2v3f, 12 K2v3b, and none of K1f, K1sp, K1b, K1bd, K2f
   or K2b); one step against the plain path; one step profiled;
16. slice 5, route B: the same with ``SPATIAL_DELTA=1`` (per step 12 K1sp,
   12 K1bd, 12 K2f, 12 K2b, no K1b); one step against the plain path;
   one step profiled;
17. K5bd (the delta backward, ``MVIT_DELTA=1``) at MViT-v2-S blocks 0 and 4,
   and K6bd, K6sp (the forward that saves bf16 p) and K6bs (the backward
   from it) at block 1 (18 clips, bf16), plus small float32 and bf16 cases
   with logits above 80, against their plain versions; K6sp's output must
   equal K6f's bit for bit; timed beside K5b / K6f / K6b and SDPA with the
   bias as a float mask;
18. slice 6, route C: ``train_net.train`` on
   ``configs/HowTo100M/procedurevrl_mvitv2_sgd.yaml`` (SGD, momentum 0.9,
   remat) with ``MVIT_DELTA=1`` set while the model is built: 2 warm-up
   + 4 timed steps with finite losses and asserted launch counts (per step
   13 K5f, 3 K6f, 13 K5bd, 3 K6bd, and no K5b, K6b, K6sp, K6bs, K7 or K8);
   one step against the plain path; one step profiled;
19. slice 6, route D: the same with ``MVIT_SAVE_PROBS=1 MVIT_DELTA=1`` (per
   step 13 K5f, 3 K6sp, 13 K5bd, 3 K6bs, and no K6f, K5b, K6b, K6bd, K7
   or K8: under remat the recomputation takes K6sp's kept outputs); one step against the plain path; one step profiled with its
   peak memory;
20. K4f / K4b (whole-sequence attention, ``ops/flash_attention.py``) and
   K3f / K3b (the same with a separate CLS stream) at the TimeSformer-B
   training shapes (``[144, 197, 768]``; ``[144, 196, 768]`` + CLS, q, k, v
   the thirds of one projection) and K4f at the eval shape (``[128, 197,
   768]``), plus N = 130, 333 and 1024, a small float32 case and a bf16
   case with a logit above 80, against their plain versions; timed beside
   SDPA;
21. K1's long range (the same pair on the fused qkv for 208 < N + 1 <=
   1025): every K1 route at N + 1 = 257 and 1025 against K1's plain
   versions and the pair's own, then one divided train step at
   ``DATA.TRAIN_CROP_SIZE 256`` against the plain path, asserting that the
   pair carries the spatial pass (no K1 kernel runs);
22. slice 7, eval: phase 6's zero-shot test with
   ``TIMESFORMER.ATTENTION_TYPE space_only`` on one view and crop per video
   (4 batches: 12 K4f per batch, no K1 or K2); one batch against the plain
   path;
23. slice 7, ``space_only`` training: phase 7's training (remat) with
   ``TIMESFORMER.ATTENTION_TYPE space_only`` (2 warm-up + 4 timed steps; per
   step 12 K4f and 12 K4b, no K1 or K2); one step against the plain path;
   one step profiled with its peak memory;
24. slice 7, ``SPATIAL_FUSED_QKV=0``: phase 7's training with the knob set
   while the model is built (per step 12 K3f, 12 K3b, 12 K2f, 12 K2b, no K1
   kernel); one step against the plain path; one step profiled with its
   peak memory;
25. slice 8: the pair at head dim 32 on the shapes of the next step (K2's
   function on the time-major qkv ``[18, 8, 196, 2304]``, K1's on the fused
   qkv ``[144, 196, 2304]`` + CLS) against their plain versions, K2's
   function timed beside SDPA; then phase 7's training at TimeSformer-B's
   width in 24 heads of 32 (3 steps; per step 12 + 12 launches of the pair
   for K1's function and as many for K2's, no K1 or K2 kernel); one step
   against the plain path;
26. slice 8: K5f/K5b at block 0 and K6f/K6b at block 1 of MViT-v2-S at
   width 144 in 2 heads of 72 (tile width 96) against their plain versions;
   then phase 9's MViT-v2-S training at that width (3 steps; every block on
   K5 or K6, no other MViT kernel); one step against the plain path.
27. slice 9: the head dims the tensor-core kernels do not take (their
   scalar kernels, in column groups past the widest): the pair at d = 12 in
   32 heads and d = 320 in 2 heads as K4, K3 (``[16, 196, C]``), K1
   (fused qkv + CLS) and K2 (``[2, 8, 196, 3C]``), and K5f/K5b, K7f/K7b
   (block 0) and K6f/K6b, K6sp/K6bs (block 1) of MViT-v2-S's token counts
   at d = 20 and 136 (2 clips), forward and backward against their plain
   versions, bf16 (the pair also float32).
28. slice 14, zero-shot step forecasting: ``test_net.test`` on
   ``configs/COIN/step_forecasting.yaml`` (TimeSformer-B, bf16, 8 observed
   clips of 8 frames a sample, the order transformer's forecast, the
   778-step COIN bank) at one view a video: 64 samples in 4 batches of 16
   x 8 clips (K1f on [1024, 196, 2304]), 12 K1f and 12 K2f per batch and
   no other port kernel; one batch against the plain path; clips/s and
   the peak memory;
29. slice 14, the MViT-v2-S zero-shot eval: ``test_net.test`` on
   ``configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml`` (16 frames at
   224^2, 64 videos x 4 views in batches of 16, the COIN bank) on the
   default route (13 K5f and 3 K6f per batch) and with ``MVIT_POOL=kernel
   MVIT_KT=1`` set while the model is built (13 K5f, 1 K6f, 2 K7f and 17
   K8f per batch), no other port kernel; one batch of each against the
   plain path; one eval step of each profiled;
30. slice 14, the COIN finetunes on the frozen encoder (``TRAIN.LINEAR``,
   SGD): ``train_net.train`` on ``step_forecasting.yaml`` and
   ``task_classification.yaml`` (2 samples x 8 clips a step, 2 warm-up +
   2 timed steps) and ``step_classification.yaml`` (16 clips a step, 3
   steps), each cut there and so ending with one val epoch; finite losses
   and val errors; 12 K1f and 12 K2f per micro-batch and val batch, and
   none of K1sp, K1b, K1br, K1bd, K2b, K2v3b or any other port kernel;
   one step of each against the plain path (phase 7's limits) and one
   step of each profiled with its peak memory;
31. slice 15, checkpoints, through files: TimeSformer-B order pretraining
   (``procedurevrl_adamw.yaml``, bf16, remat, 4 samples a micro-batch, 4
   micro-batches a step, since slice 19 16 synthetic videos so 1 step an
   epoch, 2 epochs, a checkpoint after
   each) uninterrupted (run A), and cut after epoch 1 then resumed by
   AUTO_RESUME from its ``OUTPUT_DIR`` (run B: asserted to start at epoch 2
   and step 1); B's epoch-2 losses and final parameters against A's
   (phase 7's limits; whether bit for bit is printed); 12 K1sp, 12 K2f,
   12 K1b and 12 K2b per micro-batch and no other port kernel; one
   checkpoint written by the blocking and by the thread writer (equal
   tensors; file size, the loop's stall in each ``save``, the load time);
   then the COIN forecasting linear probe from A's last file with
   ``CHECKPOINT_EPOCH_RESET`` (encoder and order transformer the file's,
   ``head_cls`` at its seeded init), one epoch, which saves (12 K1f and 12
   K2f per micro-batch, no backward kernel); then ``test_net.test`` with
   no model, which loads that checkpoint from ``OUTPUT_DIR`` (its
   predictions on one batch equal the in-memory model's) and writes
   ``TEST.SAVE_RESULTS_PATH``, read back.  Each leg's wall time.
32. slice 16, the softmax shifts (``SPATIAL_SHIFT``, ``TEMPORAL_SHIFT``,
   ``MVIT_SHIFT``) under ``max`` and ``none``: every variant a route
   reaches (K1f, K1sp, K1p, K1br; K2f, K2v3f, K2b; the pair as K4, K3, K1's
   long range and K2's function at head dim 32; K5f, K6f, K6sp, K5b, K6b
   and under none K5bd, K6bd) against its plain version in bf16 at the
   training shapes and in float32 at a smaller one, on queries aimed so
   that a row's top logit lies in (80, 88) or (88, 300) (under none only
   the first count and the port must be non-finite on exactly the plain
   version's non-finite rows; its backwards take no row past 88), with
   K1sp == K1f, K1p == K1f, K1br == K1b(K1sp p), K2f == K2v3f and K2b ==
   K2v3b(K2v3f p) bit for bit under each shift; then TimeSformer-B order
   pretraining under ``SPATIAL_SHIFT=max TEMPORAL_SHIFT=max`` (3 steps; per
   step 12 K1sp, 12 K1b, 12 K2f, 12 K2b), MViT-v2-S order pretraining under
   ``MVIT_SHIFT=max`` (3 steps; per step 13 K5f, 3 K6f, 13 K5b, 3 K6b) and
   the zero-shot COIN test under all three knobs ``none`` (2 batches of 32
   clips; 12 K1f and 12 K2f per batch), each against the plain path; the
   variants these paths launch are timed at their clamp rows' shapes beside
   the clamp kernel.
33. slice 17, the EPIC-Kitchens-100 full finetune at its shipped width
   (``configs/EK/egocentric_action_classification.yaml``), since slice 19
   on the EPIC dataset's dummy split through the host loader (RandAugment
   on; phase 36 times the loader alone; the split cut to 32 segments, 4
   times over): 1 optimizer step (2 until slice 19) of 4 micro-batches of
   32 clips x 32 frames
   through ``train_net.train`` and its val epoch (per micro-batch 12 K1sp
   and 12 K1b, per val batch 12 K1f, no K2), one micro-batch step against
   the plain path and profiled, ``test_net.test`` in 2 batches of 16 clips
   (12 K1f a batch) with the verb and noun logits of one batch against the
   plain path relative to their scale, the peak memory of one micro-batch
   step under the default policy and ``REMAT_SAVE_ATTN False`` (without
   remat it does not fit, slice 17), and K1sp / K1b / K1f at EK's shapes
   against their plain versions,
   timed beside SDPA with their bounds;
34. slice 17, the remat policies: the default TimeSformer-B pretraining
   step under ``TPU.REMAT_SAVE_ATTN True`` and ``False`` (one step's
   launches, asserted, and its peak memory above the resident state;
   device busy profiled in the order True, False, False, True), then 2
   steps of
   ``configs/HowTo100M/procedurevrl_sgd.yaml``;
35. slice 18, the host data pipeline: which of ``cv2``, ``av``, ``PIL``,
   ``pandas`` and ``ffmpeg`` this machine has, and its cores; the native
   preprocess must be the build of ``csrc/videoproc.cpp`` and must run;
   the loader alone (host arrays, then pinned and copied to the card) on
   the pretraining train split (2 samples of 9 clips x 8 frames at 224^2,
   ``NUM_WORKERS`` 8) and the COIN test split, 5 batches each (12 and all
   until slice 19); two passes of one loader
   give identical batches; ``train_net.train`` on ``procedurevrl_adamw.yaml``
   through the loader (2 warm-up + 2 timed steps, per step 12 K1sp, 12
   K2f, 12 K1b, 12 K2b); one model's step fed by the loader and by
   ``SyntheticPretrain``'s device-drawn batch (loader, device, device,
   loader: clips/s and one profiled step each); ``test_net.test`` on
   ``step_classification.yaml`` (12 K1f + 12 K2f a batch); every copied
   tensor pinned; where the machine has ``cv2`` or ``ffmpeg``, a test on
   clips it writes, decoded by each decoder found;
36. slice 19, the EPIC-Kitchens dataset and the extract tools: a tree of
   two ``cv2`` MP4s at 456x256 (a 50 and a 60 fps video id), their
   ``rgb_frames`` JPGs and a pickled list of 16 segments; the loader alone
   at EK's train shape with RandAugment (samples/s on the host, then
   pinned and copied), decoding and reading the JPGs; ``train_net.train``
   on the EK config through it (one step of 4 micro-batches of 32, then a
   val epoch: 12 K1sp + 12 K1b a micro-batch, 12 K1f a val batch, no K2)
   and ``test_net.test`` in 2 batches (12 K1f each); ``emb_extract`` on a
   seeded ViT-B/16-shaped text tower (12 layers, width 512) over
   ``data/step_coin_text.txt`` on the card, its first steps against
   ``--device cpu``; ``feat_extract`` on ``step_classification.yaml``,
   whose per-view predictions summed per video are ``test_net``'s;
37. slice 19, data parallel (``utils/misc.py:launch_job``): 2 ranks
   sharing the card over gloo (NCCL where there are 2 cards) take their
   rows of the global batches of TimeSformer-B order pretraining (3 steps,
   one sample a rank), of one such step under ``TPU.SHARD_OPT_STATE``
   (ZeRO-1; each rank's optimizer bytes) and of one EK step (2 micro-batches of 32
   clips, 16 a rank); rank 0 launches per micro-batch 12 K1f + 12 K1br (12
   K2f + 12 K2b where T = 8) and no K1sp or K1b (JAX's multi-device
   route), and its losses, gradients and parameters are held against one
   process on the global batch within phase 7's limits (the first step's
   gradients; every parameter after it within AdamW's 2 lr); ZeRO-1's
   parameters equal the plain optimizer's; ``tools/dryrun.py`` on 2 ranks;
   ``run_net``'s zero-shot COIN test at ``NUM_GPUS`` = the cards over NCCL
   (one card: one NCCL rank).  To stay in time, slice 19 cut the step
   counts of phases 7, 9, 11, 15, 16, 18, 19, 30 and 35, the synthetic
   index of phases 30 and 31, and the repeats a kernel time is the median
   of (21 -> 11).
Every phase that trains or tests gives ``OUTPUT_DIR`` a temporary
directory of its own (the shipped configs name ``.``, and AUTO_RESUME would
pick up a checkpoint left there), and sends the port's log lines, which
``setup_logging`` puts on stdout, to that directory only.
The kernels of each attention wrapper are timed apart, and every case
against another checkout, by ``python -m procedurevrl_torch.tools.kernel_ab``.
Phases 6 and 7 assert that none of slice 5's kernels runs without the
knobs, phases 9 and 11 none of slice 6's, and every TimeSformer phase
before 20 none of slice 7's.
Each phase prints its wall time, and the script its total.  The last two
lines are the
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, data sheet
BF16_FLOPS = 989e12         # dense tensor-core peak
FP32_FLOPS = 67e12          # fp32 outside the tensor cores (K8's FMAs)
# bf16 kernel vs plain version: both round p and the output to bf16; sums
# run in another order, so outputs may differ by a bf16 ulp or two
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# K1p outputs (inputs 0.5 N(0, 1), logits of std 0.25) and K2v3f's
# outputs against P V of its own probabilities, and those probabilities, in
# bf16: one bf16 ulp (<= 2^-7 of the value) apart at most, the atol for the
# fp32 order noise of values near zero.  (The kernels' exp2f and reciprocal
# may round a probability to the neighbouring bf16 value where the plain
# version's expf and division do not; against the plain output that moves
# an element by ulp(p) |v|, up to ~8e-3 for K2 at N(0, 1) inputs, so K2v3f's
# output is also held to BF16_TOL against the plain output.)  A typical K1
# output is ~0.035 here, so one missing key (~p v ~ 0.0025) fails, which
# BF16_TOL lets through (procedurevrl_torch/tools/mutation_check.py).
K1K2_FWD_TOL = dict(atol=1e-3, rtol=1e-2)
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
# K5f/K6f bf16 outputs: kernel and plain version round the same fp32 sums,
# which differ only in summation order, so an element may sit one bf16 ulp
# (<= 2^-7 of its magnitude) apart; the atol covers the fp32 order noise
# of outputs near zero.  A typical |output| is 0.014-0.027 here, so one
# missing key column (the cls, or the last key of a ragged tile) fails.
MVIT_FWD_TOL = dict(atol=1e-3, rtol=1e-2)
# the fp32 row sums l of K5f/K6f: sums of the same exponentials in another
# order (relative differences ~1e-6; one missing column moves l by ~1/kN)
ROWSUM_TOL = dict(atol=0.0, rtol=1e-4)
# K6sp's bf16 probabilities: kernel and plain version round the same p
# (its logits differ by fp32 summation order) to bf16, so an element may
# sit one bf16 ulp (<= 2^-7 of it) apart, and zeros agree exactly.  The cls
# probability averages ~5e-4 at blocks 1 and 3, under MVIT_FWD_TOL's atol,
# which sees it vanish only on the few rows where it passes 1e-3
# (procedurevrl_torch/tools/mutation_check.py).
PROBS_TOL = dict(atol=1e-5, rtol=1e-2)
# bf16 gradients of K5bd, K6bd and K6bs, each against its own scale
# (own_tol): kernel and plain version round the same fp32 sums, so an
# element sits a bf16 ulp or two apart (<= 2^-6 of it, the rtol), and a ds
# that rounds to the neighbouring bf16 value moves every product it feeds
# by a small fraction of that gradient's own largest magnitude (the atol).
# dq and dkc stay far below 1 here, so grad_tol's floor of 1 let a K6bs
# that drops the cls column through on dq, dkc and drel.  The sound
# kernels pass from atol 7.5e-4 x, that K6bs fails from 7.8e-3 x on drel
# and more on dq, dkc and dvc (procedurevrl_torch/tools/mutation_check.py
# prints both; PERF.md section 6).
MVIT_GRAD_TOL = dict(atol=2e-3, rtol=1e-2)
# post-softmax predictions of 12 bf16 blocks, kernels vs plain versions
PRED_ATOL = 1e-2
# one bf16 train step, kernels vs plain versions: relative loss and global
# gradient-norm difference, and the least cosine similarity of any trained
# tensor's gradient (bf16 rounding of activations and gradients differs
# between the two paths, so the step agrees only to bf16 precision)
STEP_LOSS_RTOL = 1e-2
STEP_NORM_RTOL = 5e-2
STEP_MIN_COS = 0.99
# A gradient that is zero in exact arithmetic (MViT's key-norm bias adds
# one vector to every key of a softmax, which leaves it unchanged; the last
# block's q pool and rel-pos tables feed only body queries, which the CLS
# readout never sees) comes back as nought or rounding noise, which has no
# direction to compare.  A tensor
# whose plain-path gradient norm is at most ROUNDING_RTOL x the global norm
# counts as such, and the kernel path's norm of it must stay at most
# ZERO_GRAD_RTOL x the global norm.
ROUNDING_RTOL = 1e-5
ZERO_GRAD_RTOL = 1e-4
DEPTH = 12
# step counts were cut in slice 19 to keep the script inside its time
TRAIN_STEPS = 6            # 2 warm-up + 4 timed
NO_REMAT_STEPS = 3         # 2 warm-up + 1 timed
CLIPS_PER_SAMPLE = 9
MVIT_CFG = "configs/HowTo100M/procedurevrl_mvitv2_adamw.yaml"
MVIT_HL_BLOCKS, MVIT_HS_BLOCKS = 13, 3  # MViT-v2-S blocks routed to K5 / K6
MVIT_STEPS = 6                          # 2 warm-up + 4 timed
# slice 4, MViT-v2-S under MVIT_POOL=kernel MVIT_KT=1: blocks routed to K7
# (1 and 3) and K6 (14), and stride-1 pools on K8 (17)
KNOBS = {"MVIT_POOL": "kernel", "MVIT_KT": "1"}
MVIT_KNOBS = ("MVIT_POOL", "MVIT_KT", "MVIT_DELTA", "MVIT_SAVE_PROBS")
# slice 5, TimeSformer on the JAX package's attention knobs
TS_EVAL_KNOBS = {"SPATIAL_PIPE": "1", "TEMPORAL_BATCHED": "1"}
ROUTE_A = {"SPATIAL_SAVE_PROBS": "0", "SPATIAL_PIPE": "1",
           "TEMPORAL_BATCHED": "1"}
ROUTE_B = {"SPATIAL_DELTA": "1"}
TS_KNOBS = ("SPATIAL_SAVE_PROBS", "SPATIAL_DELTA", "SPATIAL_PIPE",
            "SPATIAL_PIPE_NBUF", "TEMPORAL_BATCHED", "SPATIAL_FUSED_QKV")
KT_BLOCKS, KNOB_HS_BLOCKS = 2, 1
KNOB_STEPS = 6                          # 2 warm-up + 4 timed
# slice 6, MViT-v2-S SGD pretraining on the JAX package's backward knobs
MVIT_SGD_CFG = "configs/HowTo100M/procedurevrl_mvitv2_sgd.yaml"
ROUTE_C = {"MVIT_DELTA": "1"}
ROUTE_D = {"MVIT_SAVE_PROBS": "1", "MVIT_DELTA": "1"}
ROUTE_STEPS = 6                         # 2 warm-up + 4 timed
# K8f bf16 output: kernel and plain version round the same fp32 sums of 27
# exact products (fused multiply-adds against products then adds) to bf16,
# so an element may sit one bf16 ulp (<= 2^-8 of it) apart; the atol covers
# the fp32 order noise of outputs near zero.  Outputs are ~0.5 here, so a
# skipped tap plane moves an element by ~0.3.
POOL_TOL = dict(atol=1e-3, rtol=1e-2)
# K8 at the five stride-1 pools of the MViT-v2-S training step, 18 clips:
# (label, [T, H, W], C, pools per pass): block 0's q, 2's q, the q of
# blocks 4-13, the k and v of 14, the q, k and v of 15
POOL_SHAPES = (("block 0", (8, 56, 56), 96, 1), ("block 2", (8, 28, 28), 192, 1),
               ("block 4", (8, 14, 14), 384, 10),
               ("block 14", (8, 14, 14), 768, 2),
               ("block 15", (8, 7, 7), 768, 3))
K8_POOLS = sum(n for *_, n in POOL_SHAPES)  # 17 stride-1 pools per pass
# the edge cases of K8's window tiling (label, B, [T, H, W], C): channels
# not a multiple of its 32-channel slice, unit axes, an odd W that is no
# multiple of its 7-column strip, a band of rows that does not divide H
POOL_EDGES = (("C 8", 2, (3, 9, 11), 8), ("C 40", 2, (4, 10, 13), 40),
              ("H W 1", 3, (2, 1, 1), 32), ("T 1", 2, (1, 12, 9), 64),
              ("odd W", 2, (3, 5, 9), 64), ("band", 2, (3, 61, 23), 32))
# K7f's fp32 log-sum-exp: the same exponentials summed in another order,
# per key tile; one missing key column of kN + 1 ~ 1569 moves it by ~6e-4
LSE_TOL = dict(atol=1e-4, rtol=0.0)
# slice 7: K3 / K4 bf16 outputs, kernel against plain version: both round
# e = exp(min(s, 80)) to bf16 and divide the fp32 P V sums by l after, so an
# element sits a bf16 ulp or two apart (<= 2^-7 of it); the atol covers the
# fp32 order noise of outputs near zero.  Their gradients: MVIT_GRAD_TOL
# against each gradient's own largest value.  Against K1's plain versions,
# which round e / l (one bf16 rounding of each probability in another
# place), K1's long range is held at 0.5 N(0, 1) inputs to K1K2_FWD_TOL, as
# K1p is.
FLASH_FWD_TOL = dict(atol=1e-3, rtol=1e-2)
SLICE7_STEPS = 6                        # 2 warm-up + 4 timed
SPACE_ONLY = ("TIMESFORMER.ATTENTION_TYPE", "space_only")
SPLIT_QKV = {"SPATIAL_FUSED_QKV": "0"}
# analytic count (utils/misc.py:39 flops_count_timesformer + temporal_fc):
# ~391 GFLOP per clip forward; a train step is ~3x that (forward + backward)
FWD_GFLOP_PER_CLIP = 391.0
# slice 8: head dims other than the shipped models' on the full-width
# models: TimeSformer-B's width 768 in 24 heads of 32 (K1's and K2's
# function on the pair), and MViT-v2-S's block plan at MViT-v2-L's width
# 144 in 2 heads of 72 (every MViT kernel at tile width 96)
TS_HEADS_32 = 24
MVIT_D72 = ("MVIT.EMBED_DIM", "144", "MVIT.NUM_HEADS", "2")
HEAD_DIM_STEPS = 3                      # 2 warm-up + 1 timed
MVIT_BLOCKS = MVIT_HL_BLOCKS + MVIT_HS_BLOCKS
# slice 14: the 778-step COIN bank; the COIN finetunes on the frozen
# encoder, 2 warm-up + 2 timed steps (4 until slice 19) of 2 samples (phase 7's step size)
# each for the heads on 8 clips, 2 + 1 of 16 one-clip samples for step
# classification
COIN_BANK = os.path.join(ROOT, "data/clip_step_emb_coin.pth")
FINETUNES = (("step_forecasting", 2, 4), ("task_classification", 2, 4),
             ("step_classification", 16, 3))
FINETUNE_VIDEOS = 32  # the synthetic index in phase 30 (64 until slice 19)
# phase 31: RESUME_VIDEOS synthetic videos (64 until slice 19), 4 a
# micro-batch, 4 micro-batches a step (2 and 8 until slice 18): each
# micro-batch reads the host loader, and fewer keep the script in time
RESUME_OPTS = ("TRAIN.BATCH_SIZE", "4", "GLOBAL_BATCH_SIZE", "16",
               "SOLVER.MAX_EPOCH", "2", "TRAIN.CHECKPOINT_PERIOD", "1")
RESUME_VIDEOS = 16
RESUME_STEPS, RESUME_ACCUM = 1, 4   # an epoch's optimizer steps, micro-batches
# slice 16: the softmax shifts SPATIAL_SHIFT, TEMPORAL_SHIFT and MVIT_SHIFT
# under max and none.  The top logit each query row is aimed at, in turn:
# left small, in (80, 88) and in (88, 300), where the shifts part (the clamp
# saturates, none overflows past ~88.7); the backwards under none take the
# first two only (one overflowing query's NaN reaches every key's gradient)
# (The aimed rows put probabilities near 1, where one bf16 ulp of p times
# |v| ~ 2 is ~8e-3, and make ds O(1), where one bf16 ulp of a ds moves a
# sum of them by ~4e-3 whatever the sum's own scale: the shift checks hold
# bf16 outputs to BF16_TOL, probabilities to K1K2_FWD_TOL and every bf16
# gradient to grad_tol(BF16_TOL), as K1's and K2's.)
EK_CFG = "configs/EK/egocentric_action_classification.yaml"
# 64 synthetic videos make 2 micro-batches of 32 an epoch, fewer than the
# 4 that GLOBAL_BATCH_SIZE 128 accumulates: the epoch is taken twice
EK_OPTS = ("DEV.LOAD_DUMMY_DATA", "True", "TRAIN.EPOCH_MUL", "2")
# phase 33 since slice 19 (the dataset's loader feeds it, ~11 samples/s):
# one step, and the dummy split cut to 32 segments (epochs 4 times over)
# for a shorter val and test; the shapes are the config's
EK_STEPS = 1
EK_VIDEOS = 32
EK_SPLIT_OPTS = ("TRAIN.EPOCH_MUL", "4")
EK_TEST_OPTS = ("TRAIN.ENABLE", "False", "TEST.NUM_ENSEMBLE_VIEWS", "1",
                "TEST.NUM_SPATIAL_CROPS", "1")
# the EPIC heads' logits (divided by DEV.TEMP, no softmax) through the
# kernels against the plain path: max |d| over the plain logits' max |x|.
# The bf16 encoder's rounding differences reach the logits multiplied by
# 1 / DEV.TEMP = 50: a first card run read 1.55e-2 on a sound path
EPIC_LOGIT_RTOL = 5e-2
SGD_CFG = "configs/HowTo100M/procedurevrl_sgd.yaml"
POLICY_STEPS = 2                        # warm-up steps before the reads
SHIFTS = ("max", "none")
SHIFT_KNOBS = ("SPATIAL_SHIFT", "TEMPORAL_SHIFT", "MVIT_SHIFT")
HOT_TARGETS = (None, 84.0, 200.0)
COOL_TARGETS = (None, 84.0)
SHIFT_STEPS = 3                         # 2 warm-up + 1 timed
TS_MAX = {"SPATIAL_SHIFT": "max", "TEMPORAL_SHIFT": "max"}
MVIT_MAX = {"MVIT_SHIFT": "max"}
ALL_NONE = dict.fromkeys(SHIFT_KNOBS, "none")
# slice 18, the host data pipeline: the loader alone over this many
# pretraining batches; train_net.train through it for LOADER_STEPS steps;
# the step fed by the loader and by SyntheticPretrain's device-drawn batch,
# WARMUP_STEPS + LOADER_TIMED steps each, twice
LOADER_BATCHES = 5
LOADER_STEPS = 4                        # 2 warm-up + 2 timed
LOADER_TIMED = 2
# slice 19: the EPIC-Kitchens tree phase 36 writes (video, frame rate: a
# three-digit id is EPIC-100's 50 fps, a two-digit one 60), 8 segments of
# EPIC_SEG_S seconds a video, EPIC_SPACING_S apart, at 456x256
EPIC_VIDEOS = (("P01_101", 50), ("P02_03", 60))
EPIC_SEGMENTS, EPIC_SEG_S, EPIC_SPACING_S = 8, 1.2, 1.25
EPIC_W, EPIC_H = 456, 256
# 16 segments 8 times over: 128 samples, one optimizer step of 4 x 32
EPIC_TREE_OPTS = ("DEV.LOAD_DUMMY_DATA", "False", "TRAIN.EPOCH_MUL", "8",
                  "DATA.DECODING_BACKEND", "cv2",
                  "EPICKITCHENS.TRAIN_LIST", "segments.pkl",
                  "EPICKITCHENS.VAL_LIST", "segments.pkl",
                  "EPICKITCHENS.TEST_LIST", "segments.pkl")
EPIC_TREE_TEST = ("TRAIN.ENABLE", "False", "TEST.NUM_ENSEMBLE_VIEWS", "2",
                  "TEST.NUM_SPATIAL_CROPS", "1")
# the CLIP bank on the card against --device cpu: max |d| over max |x|
EMB_RTOL = 1e-4
EMB_CPU_STEPS = 2
# feat_extract's per-view predictions summed per video against test_net's
FEAT_ATOL = 1e-6
FEAT_VIDEOS = 8                         # 8 videos x 3 views, 2 batches
# slice 19, data parallel: optimizer steps of each program (EK's of 2
# micro-batches), and the ranks
DDP_STEPS = {"plain": 3, "zero": 1, "ek": 1}
DDP_RANKS = 2



def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


@contextlib.contextmanager
def quiet():
    """The port's log lines, which its entry points put on stdout, off
    stdout while inside (they still reach ``OUTPUT_DIR/stdout.log``)."""
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


@contextlib.contextmanager
def job_dir(cfg):
    """``cfg.OUTPUT_DIR`` a temporary directory for one train or test run
    (checkpoints, ``stdout.log``), its logs off stdout, the directory
    removed afterwards."""
    out = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg.OUTPUT_DIR = out
    try:
        with quiet():
            yield out
    finally:
        shutil.rmtree(out, ignore_errors=True)


def time_ms(torch, fn, iters: int = 20, reps: int = 11) -> float:
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


def profile_step(torch, label: str, fn, top: int = 12) -> float:
    """Device time by kernel for one call of ``fn`` (torch.profiler), and
    the device busy share of its wall time (the rest is the host gap);
    returns the device busy ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # user annotations (e.g. "Optimizer.step#AdamW.step") span kernels that
    # are counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile of {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), host gap "
          f"{wall_ms - busy_ms:.3f} ms, "
          f"{sum(e.count for e in kernels)} kernel launches")
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(kernel_group(e.key), [0.0, 0])
        g[0] += e.self_device_time_total / 1e3
        g[1] += e.count
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {name}: {ms:.3f} ms ({100 * ms / busy_ms:.1f} % of "
              f"busy), {n} launches")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:100]}")
    return busy_ms


# profile groups: the first pattern found in a kernel's name decides
KERNEL_GROUPS = (("port pool kernels (K8)", ("dwpool_",)),
                 ("port temporal kernels (K2)", ("temporal_",)),
                 ("port kernels", ("spatial_", "temporal_", "mvit_",
                                   "flash_")),
                 ("convolutions", ("conv", "depthwise")),
                 ("GEMM", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
                 ("LayerNorm", ("layer_norm",)),
                 ("optimizer", ("multi_tensor", "adam", "foreach")),
                 ("copies and casts", ("copy", "cat", "index")),
                 ("reductions", ("reduce",)),
                 ("elementwise", ("elementwise",)))


def kernel_group(key: str) -> str:
    low = key.lower()
    for name, patterns in KERNEL_GROUPS:
        if any(p in low for p in patterns):
            return name
    return "other"


def timed(label: str, phase, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def compare(torch, name, got, ref, tol) -> float:
    torch.cuda.synchronize()
    if got.numel() == 0 and ref.numel() == 0:
        print(f"{name}: nothing left to compare")
        return 0.0
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


def grad_tol(tol: dict, ref) -> dict:
    """``tol`` with the atol scaled by the reference's largest magnitude: a
    ds value that rounds to the neighbouring bf16 value moves every product
    it feeds by one ulp of that product's scale."""
    return dict(tol, atol=tol["atol"] * max(ref.float().abs().max().item(), 1.0))


def own_tol(tol: dict, ref) -> dict:
    """``tol`` with the atol scaled by the reference's largest magnitude,
    however small: for gradients whose whole scale lies far below 1."""
    return dict(tol, atol=tol["atol"] * ref.float().abs().max().item())


def sdpa_ms(torch, F, q, k, v, g):
    """The library yardstick for a backward: SDPA forward, and SDPA forward
    + backward less the forward, on inputs that require grad."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
    both = time_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q, k, v), (q, k, v), g))
    return fwd, both - fwd


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


def k2_ring_cases(torch, gen, grad=False):
    """Inputs of the K2f / K2b ring's other tilings, bf16: 3 clips of an odd
    N (each clip's last 16-row tile holds one position) at T = 1, 3, 9 (one
    position a tile past 8 frames) and 16, and head counts that split into
    groups of 3 (6 heads) and 1 (5 heads); (qkv, heads, name), and with
    ``grad`` (qkv, g, heads, name)."""
    cases = []
    for tt, n, heads in ((1, 49, 12), (3, 49, 12), (9, 49, 12), (16, 49, 12),
                         (8, 49, 6), (5, 21, 5)):
        c = heads * 64
        x = torch.randn(3, tt, n, 3 * c, generator=gen, device="cuda")
        name = f"[3,{tt},{n},{3 * c}] {heads} heads"
        if grad:
            gy = torch.randn(3, tt, n, c, generator=gen, device="cuda")
            cases.append((x.bfloat16(), gy.bfloat16(), heads, name))
        else:
            cases.append((x.bfloat16(), heads, name))
    return cases


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
    for x, hh, name in k2_ring_cases(torch, g):
        compare(torch, f"K2 bf16 {name}", k2.temporal_attention(x, hh, scale),
                k2.temporal_attention_plain(x, hh, scale), BF16_TOL)

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
def plain_attention(k1, k2, k5, k8):
    """Route the models through the plain versions (reference runs only):
    the models' attention entries become the plain forwards, which autograd
    differentiates under grad, on every knob route (the TimeSformer entries
    ignore the route they are given, the MViT entries the backward knobs
    they are given), and the pool entry takes its plain
    versions (the tap forward, and the tap formulas for its backward).
    Each plain forward takes the shift its entry is given (the route's)."""
    from procedurevrl_torch.ops import flash_attention as fa

    from procedurevrl_torch.ops.attention_route import DEFAULT_ROUTE

    pool = k8.depthwise_pool3d
    shift = lambda a, i: a[i] if len(a) > i else "clamp"
    swaps = [(fa, "flash_attention_autograd", fa.flash_attention_plain),
             (fa, "flash_attention_cls_autograd", fa.flash_attention_cls_plain),
             (k1, "spatial_attention_autograd",
              lambda qkv, qkv_c, h, s, route=DEFAULT_ROUTE:
              k1.spatial_attention_plain(qkv, qkv_c, h, s,
                                         route.spatial_shift)),
             (k2, "temporal_attention_autograd",
              lambda qkv, h, s, route=DEFAULT_ROUTE:
              k2.temporal_attention_plain(qkv, h, s, route.temporal_shift)),
             (k5, "mvit_attention_hl",
              lambda *a: k5.mvit_attention_hl_plain(*a[:9], shift(a, 10))),
             (k5, "mvit_attention",
              lambda *a: k5.mvit_attention_plain(*a[:8], shift(a, 10))),
             (k5, "mvit_attention_kt", k5.mvit_attention_kt_plain),
             (k8, "depthwise_pool3d",
              lambda x5, w27, s, use_kernel=True: pool(x5, w27, s, False))]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), entry in zip(swaps, saved):
            setattr(mod, name, entry)


def phase_k1_train(torch, F, k1) -> list:
    """K1sp and K1b at the training shape (2 samples x 9 clips x 8 frames)."""
    bt, n, heads, d = 2 * CLIPS_PER_SAMPLE * 8, 196, 12, 64
    c, L = heads * d, n + 1
    ls = k1.probs_stride(L)
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(3)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    qkv, qkv_c, g, gc = r(bt, n, 3 * c), r(bt, 1, 3 * c), r(bt, n, c), r(bt, 1, c)
    out, out_c, probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, heads, scale)
    ref, ref_c, ref_p = k1.spatial_attention_fwd_probs_plain(qkv, qkv_c, heads,
                                                             scale)
    err_sp = max(compare(torch, "K1sp bf16 frames", out, ref, BF16_TOL),
                 compare(torch, "K1sp bf16 cls", out_c, ref_c, BF16_TOL),
                 compare(torch, "K1sp bf16 probs", probs, ref_p,
                         K1K2_FWD_TOL))
    if probs[..., L:].any():
        fail("K1sp wrote non-zero padding columns")
    # K1f and K1sp are one forward kernel: the same outputs bit for bit
    f, fc = k1.spatial_attention(qkv, qkv_c, heads, scale)
    torch.cuda.synchronize()
    if not (torch.equal(f, out) and torch.equal(fc, out_c)):
        fail("K1sp's outputs differ from K1f's")
    dx, dx_c = k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, heads, scale)
    rdx, rdx_c = k1.spatial_attention_bwd_plain(qkv, qkv_c, probs, g, gc,
                                                heads, scale)
    err_b = max(compare(torch, "K1b bf16 dqkv", dx, rdx, grad_tol(BF16_TOL, rdx)),
                compare(torch, "K1b bf16 dqkv_c", dx_c, rdx_c,
                        grad_tol(BF16_TOL, rdx_c)))
    # float32 (scalar kernels) at a smaller batch
    q32, qc32, g32, gc32 = (t[:4].float() for t in (qkv, qkv_c, g, gc))
    o32, oc32, p32 = k1.spatial_attention_fwd_probs(q32, qc32, heads, scale)
    r32, rc32, rp32 = k1.spatial_attention_fwd_probs_plain(q32, qc32, heads,
                                                           scale)
    compare(torch, "K1sp fp32 frames", o32, r32, FP32_TOL)
    compare(torch, "K1sp fp32 cls", oc32, rc32, FP32_TOL)
    compare(torch, "K1sp fp32 probs", p32, rp32, FP32_TOL)
    d32, dc32 = k1.spatial_attention_bwd(q32, qc32, p32, g32, gc32, heads, scale)
    rd32, rdc32 = k1.spatial_attention_bwd_plain(q32, qc32, p32, g32, gc32,
                                                 heads, scale)
    compare(torch, "K1b fp32 dqkv", d32, rd32, grad_tol(FP32_TOL, rd32))
    compare(torch, "K1b fp32 dqkv_c", dc32, rdc32, grad_tol(FP32_TOL, rdc32))

    ms_sp = time_ms(torch, lambda: k1.spatial_attention_fwd_probs(
        qkv, qkv_c, heads, scale))
    plain_sp = time_ms(torch, lambda: k1.spatial_attention_fwd_probs_plain(
        qkv, qkv_c, heads, scale), iters=10)
    ms_b = time_ms(torch, lambda: k1.spatial_attention_bwd(
        qkv, qkv_c, probs, g, gc, heads, scale))
    plain_b = time_ms(torch, lambda: k1.spatial_attention_bwd_plain(
        qkv, qkv_c, probs, g, gc, heads, scale), iters=5)
    # yardstick: SDPA on [BT, H, L, d] with the CLS concatenated
    x = torch.cat([qkv, qkv_c], dim=1).view(bt, L, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    gy = torch.cat([g, gc], dim=1).view(bt, L, heads, d).transpose(1, 2)
    lib_fwd, lib_bwd = sdpa_ms(torch, F, q, k, v, gy.contiguous())

    e = 2  # bf16 bytes
    nb_sp = bt * L * (3 * c + c) * e + bt * heads * L * ls * e
    fl_sp = 2 * 2 * bt * heads * L * L * d
    nb_b = bt * L * (3 * c + c + 3 * c) * e + bt * heads * L * ls * e
    fl_b = 4 * 2 * bt * heads * L * L * d
    b_sp, by_sp = bound_ms(nb_sp, fl_sp, BF16_FLOPS)
    b_b, by_b = bound_ms(nb_b, fl_b, BF16_FLOPS)
    print(f"K1sp [{bt},{n},{3 * c}] bf16: kernel {ms_sp:.4f} ms, plain "
          f"{plain_sp:.4f} ms, SDPA fwd {lib_fwd:.4f} ms, bound {b_sp:.4f} ms "
          f"({by_sp}: {nb_sp / 1e6:.1f} MB, {fl_sp / 1e9:.2f} GFLOP)")
    print(f"K1b [{bt},{n},{3 * c}] bf16: kernel {ms_b:.4f} ms, plain "
          f"{plain_b:.4f} ms, SDPA bwd {lib_bwd:.4f} ms, bound {b_b:.4f} ms "
          f"({by_b}: {nb_b / 1e6:.1f} MB, {fl_b / 1e9:.2f} GFLOP)")
    src = "procedurevrl_torch/csrc/spatial_attention.cu"
    return [{"name": k1.KERNEL_PROBS, "route": "cuda", "source": src,
             "replaces": "procedurevrl_tpu/ops/pallas_attention.py:917",
             "max_abs_err": err_sp, "ms": ms_sp, "plain_ms": plain_sp,
             "bound_ms": b_sp, "bound_by": by_sp, "library_ms": lib_fwd},
            {"name": k1.KERNEL_BWD, "route": "cuda", "source": src,
             "replaces": "procedurevrl_tpu/ops/pallas_attention.py:941",
             "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
             "bound_ms": b_b, "bound_by": by_b, "library_ms": lib_bwd}]


def phase_k2_train(torch, F, k2) -> dict:
    """K2b at the training shape (18 clips x 8 frames)."""
    b, t, n, heads, d = 2 * CLIPS_PER_SAMPLE, 8, 196, 12, 64
    c = heads * d
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(b, t, n, 3 * c, generator=gen, device="cuda").bfloat16()
    g = torch.randn(b, t, n, c, generator=gen, device="cuda").bfloat16()
    dx = k2.temporal_attention_bwd(qkv, g, heads, scale)
    ref = k2.temporal_attention_bwd_plain(qkv, g, heads, scale)
    err = compare(torch, "K2b bf16", dx, ref, grad_tol(BF16_TOL, ref))
    for tt in (8, 3):
        q32 = qkv[:2, :tt].float().contiguous()
        g32 = g[:2, :tt].float().contiguous()
        r32 = k2.temporal_attention_bwd_plain(q32, g32, heads, scale)
        compare(torch, f"K2b fp32 T={tt}",
                k2.temporal_attention_bwd(q32, g32, heads, scale), r32,
                grad_tol(FP32_TOL, r32))
    for x, gy, hh, name in k2_ring_cases(torch, gen, grad=True):
        r = k2.temporal_attention_bwd_plain(x, gy, hh, scale)
        compare(torch, f"K2b bf16 {name}",
                k2.temporal_attention_bwd(x, gy, hh, scale), r,
                grad_tol(BF16_TOL, r))

    ms = time_ms(torch, lambda: k2.temporal_attention_bwd(qkv, g, heads, scale))
    plain_ms = time_ms(torch, lambda: k2.temporal_attention_bwd_plain(
        qkv, g, heads, scale), iters=5)
    # yardstick: SDPA on [B*N, H, T, d]
    x = qkv.view(b, t, n, 3, heads, d).permute(3, 0, 2, 4, 1, 5)
    q, k, v = (x[i].reshape(b * n, heads, t, d).contiguous() for i in range(3))
    gy = g.view(b, t, n, heads, d).permute(0, 2, 3, 1, 4).reshape(
        b * n, heads, t, d).contiguous()
    _, lib_bwd = sdpa_ms(torch, F, q, k, v, gy)
    nbytes = b * t * n * (3 * c + c + 3 * c) * 2
    flops = 5 * 2 * b * n * heads * t * t * d
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    print(f"K2b [{b},{t},{n},{3 * c}] bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA bwd {lib_bwd:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": k2.KERNEL_BWD, "route": "cuda",
            "source": "procedurevrl_torch/csrc/temporal_attention.cu",
            "replaces": "procedurevrl_tpu/ops/pallas_attention.py:1512",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_bwd}


def k1_inputs(torch, gen, bt, n, heads, dtype, hot=False, sd=1.0, d=64):
    """qkv, qkv_c, g, gc of one K1 call with heads of ``d``, sd N(0, 1);
    ``hot`` (d = 64) puts one query's logit against one key above 80 (frame
    0, patch query 5, key 3, head 0)."""
    c = heads * d

    def r(*shape):
        return (sd * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    x = [r(bt, n, 3 * c), r(bt, 1, 3 * c), r(bt, n, c), r(bt, 1, c)]
    if hot:
        x[0][0, 5, :64] = 3.0
        x[0][0, 3, c:c + 64] = 4.0  # logit 3 * 4 * 64 / 8 = 96
    return x


def phase_k1_knobs(torch, F, k1) -> list:
    """K1br, K1bd and K1p (slice 5) against their plain versions, K1br
    against K1b on K1sp's probabilities and K1p against K1f bit for bit;
    timed beside their default-route twins and SDPA.  Returns the records
    of K1br, K1bd (training shape) and K1p (eval shape)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    heads, d = 12, 64
    c, scale = heads * d, d ** -0.5
    # small cases: float32 (scalar kernels) at 2 frames, and bf16 with a
    # logit above 80, at N = 196 and at N = 48 (the 64-row tile)
    for dtype, n, tol in ((torch.float32, 196, FP32_TOL),
                          (torch.float32, 48, FP32_TOL),
                          (torch.bfloat16, 196, K1K2_FWD_TOL),
                          (torch.bfloat16, 48, K1K2_FWD_TOL)):
        x = k1_inputs(torch, gen, 2, n, heads, dtype, hot=True, sd=0.5)
        name = f"K1 knobs small {str(dtype)[6:]} N={n} logit > 80"
        out, out_c, probs = k1.spatial_attention_fwd_probs(*x[:2], heads, scale)
        for nbuf in (1, 3):
            o, oc = k1.spatial_attention_pipe(*x[:2], heads, scale, nbuf)
            ro, roc = k1.spatial_attention_pipe_plain(*x[:2], heads, scale)
            compare(torch, f"{name} K1p nbuf={nbuf} frames", o, ro, tol)
            compare(torch, f"{name} K1p nbuf={nbuf} cls", oc, roc, tol)
            if not (torch.equal(o, out) and torch.equal(oc, out_c)):
                fail(f"{name}: K1p differs from K1sp's outputs")
        gtol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        got = k1.spatial_attention_bwd_recompute(*x, heads, scale)
        want = k1.spatial_attention_bwd_recompute_plain(*x, heads, scale)
        for part, a, r in zip(("dqkv", "dqkv_c"), got, want):
            compare(torch, f"{name} K1br {part}", a, r, grad_tol(gtol, r))
        got = k1.spatial_attention_bwd_delta(*x[:2], probs, out, out_c,
                                             *x[2:], heads, scale)
        want = k1.spatial_attention_bwd_delta_plain(*x[:2], probs, out, out_c,
                                                    *x[2:], heads, scale)
        for part, a, r in zip(("dqkv", "dqkv_c"), got, want):
            compare(torch, f"{name} K1bd {part}", a, r, grad_tol(gtol, r))

    # the training shape (2 samples x 9 clips x 8 frames)
    bt, n = 2 * CLIPS_PER_SAMPLE * 8, 196
    L = n + 1
    qkv, qkv_c, g, gc = k1_inputs(torch, gen, bt, n, heads, torch.bfloat16)
    out, out_c, probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, heads, scale)
    dx_b = k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, heads, scale)
    dx_r = k1.spatial_attention_bwd_recompute(qkv, qkv_c, g, gc, heads, scale)
    same = all(torch.equal(a, b) for a, b in zip(dx_r, dx_b))
    print(f"K1br == K1b(K1sp probs) bit for bit: {same}")
    if not same:
        fail("K1br differs from K1b on K1sp's probabilities")
    want = k1.spatial_attention_bwd_recompute_plain(qkv, qkv_c, g, gc, heads,
                                                    scale)
    err_r = max(compare(torch, f"K1br bf16 {part}", a, r,
                        grad_tol(BF16_TOL, r))
                for part, a, r in zip(("dqkv", "dqkv_c"), dx_r, want))
    dx_d = k1.spatial_attention_bwd_delta(qkv, qkv_c, probs, out, out_c, g, gc,
                                          heads, scale)
    want = k1.spatial_attention_bwd_delta_plain(qkv, qkv_c, probs, out, out_c,
                                                g, gc, heads, scale)
    err_d = max(compare(torch, f"K1bd bf16 {part}", a, r,
                        grad_tol(BF16_TOL, r))
                for part, a, r in zip(("dqkv", "dqkv_c"), dx_d, want))
    del dx_b, dx_r, dx_d, want
    # K1p at 0.5 N(0, 1) inputs (see K1K2_FWD_TOL)
    xp = [0.5 * t for t in (qkv, qkv_c)]
    o, oc = k1.spatial_attention_pipe(*xp, heads, scale)
    ro, roc = k1.spatial_attention_pipe_plain(*xp, heads, scale)
    compare(torch, "K1p train bf16 frames", o, ro, K1K2_FWD_TOL)
    compare(torch, "K1p train bf16 cls", oc, roc, K1K2_FWD_TOL)
    fo, foc = k1.spatial_attention(*xp, heads, scale)
    if not (torch.equal(o, fo) and torch.equal(oc, foc)):
        fail("K1p differs from K1f at the training shape")
    del xp, fo, foc
    depth = k1.pipe_depth(n, torch.bfloat16, 3)
    print(f"K1p ring depth at N = {n}: {depth} of the 3 asked for")

    ms = {"br": time_ms(torch, lambda: k1.spatial_attention_bwd_recompute(
              qkv, qkv_c, g, gc, heads, scale)),
          "b": time_ms(torch, lambda: k1.spatial_attention_bwd(
              qkv, qkv_c, probs, g, gc, heads, scale)),
          "bd": time_ms(torch, lambda: k1.spatial_attention_bwd_delta(
              qkv, qkv_c, probs, out, out_c, g, gc, heads, scale)),
          "p": time_ms(torch, lambda: k1.spatial_attention_pipe(
              qkv, qkv_c, heads, scale)),
          "f": time_ms(torch, lambda: k1.spatial_attention(
              qkv, qkv_c, heads, scale))}
    plain = {"br": time_ms(torch, lambda: k1.spatial_attention_bwd_recompute_plain(
                 qkv, qkv_c, g, gc, heads, scale), iters=5),
             "bd": time_ms(torch, lambda: k1.spatial_attention_bwd_delta_plain(
                 qkv, qkv_c, probs, out, out_c, g, gc, heads, scale), iters=5)}
    x = torch.cat([qkv, qkv_c], dim=1).view(bt, L, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    gy = torch.cat([g, gc], dim=1).view(bt, L, heads, d).transpose(1, 2)
    _, lib_bwd = sdpa_ms(torch, F, q, k, v, gy.contiguous())
    e, ls = 2, k1.probs_stride(L)
    rows = bt * L * e
    nb = {"br": rows * (3 * c + c + 3 * c),
          "bd": rows * (3 * c + c + c + 3 * c) + bt * heads * L * ls * e}
    fl = {"br": 5 * 2 * bt * heads * L * L * d, "bd": 4 * 2 * bt * heads * L * L * d}
    bound = {key: bound_ms(nb[key], fl[key], BF16_FLOPS) for key in nb}
    for key, what in (("br", "K1br"), ("bd", "K1bd")):
        print(f"{what} [{bt},{n},{3 * c}] bf16: kernel {ms[key]:.4f} ms, "
              f"K1b {ms['b']:.4f} ms, plain {plain[key]:.4f} ms, SDPA bwd "
              f"{lib_bwd:.4f} ms, bound {bound[key][0]:.4f} ms "
              f"({bound[key][1]}: {nb[key] / 1e6:.1f} MB, "
              f"{fl[key] / 1e9:.2f} GFLOP)")
    print(f"K1p [{bt},{n},{3 * c}] bf16 (training shape): kernel "
          f"{ms['p']:.4f} ms, K1f {ms['f']:.4f} ms")
    del q, k, v, gy, x

    # K1p at the eval shape (16 views x 8 frames), the record's
    bt = 8 * 16
    qkv, qkv_c, _, _ = k1_inputs(torch, gen, bt, n, heads, torch.bfloat16,
                                 sd=0.5)
    o, oc = k1.spatial_attention_pipe(qkv, qkv_c, heads, scale)
    ro, roc = k1.spatial_attention_pipe_plain(qkv, qkv_c, heads, scale)
    err_p = max(compare(torch, "K1p eval bf16 frames", o, ro, K1K2_FWD_TOL),
                compare(torch, "K1p eval bf16 cls", oc, roc, K1K2_FWD_TOL))
    fo, foc = k1.spatial_attention(qkv, qkv_c, heads, scale)
    if not (torch.equal(o, fo) and torch.equal(oc, foc)):
        fail("K1p differs from K1f at the eval shape")
    ms_p = time_ms(torch, lambda: k1.spatial_attention_pipe(qkv, qkv_c, heads,
                                                            scale))
    ms_f = time_ms(torch, lambda: k1.spatial_attention(qkv, qkv_c, heads,
                                                       scale))
    plain_p = time_ms(torch, lambda: k1.spatial_attention_pipe_plain(
        qkv, qkv_c, heads, scale), iters=10)
    x = torch.cat([qkv, qkv_c], dim=1).view(bt, L, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    lib_p = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
    nb_p = bt * L * (3 * c + c) * e
    fl_p = 2 * 2 * bt * heads * L * L * d
    b_p, by_p = bound_ms(nb_p, fl_p, BF16_FLOPS)
    print(f"K1p [{bt},{n},{3 * c}] bf16 (eval shape): kernel {ms_p:.4f} ms, "
          f"K1f {ms_f:.4f} ms, plain {plain_p:.4f} ms, SDPA {lib_p:.4f} ms, "
          f"bound {b_p:.4f} ms ({by_p}: {nb_p / 1e6:.1f} MB, "
          f"{fl_p / 1e9:.2f} GFLOP)")
    src = "procedurevrl_torch/csrc/spatial_attention.cu"
    where = "procedurevrl_tpu/ops/pallas_attention.py:"
    return [{"name": k1.KERNEL_BWD_RECOMPUTE, "route": "cuda", "source": src,
             "replaces": f"{where}586", "max_abs_err": err_r, "ms": ms["br"],
             "plain_ms": plain["br"], "bound_ms": bound["br"][0],
             "bound_by": bound["br"][1], "library_ms": lib_bwd},
            {"name": k1.KERNEL_BWD_DELTA, "route": "cuda", "source": src,
             "replaces": f"{where}1065", "max_abs_err": err_d, "ms": ms["bd"],
             "plain_ms": plain["bd"], "bound_ms": bound["bd"][0],
             "bound_by": bound["bd"][1], "library_ms": lib_bwd},
            {"name": k1.KERNEL_PIPE, "route": "cuda", "source": src,
             "replaces": f"{where}699", "max_abs_err": err_p, "ms": ms_p,
             "plain_ms": plain_p, "bound_ms": b_p, "bound_by": by_p,
             "library_ms": lib_p}]


def v3_pv(torch, qkv, probs, heads):
    """P V of K2v3f's probabilities [B, N, H, T, T], accumulated in fp32
    and rounded to the value dtype: its output up to summation order."""
    b, t, n, c3 = qkv.shape
    v = qkv.view(b, t, n, 3, heads, -1)[:, :, :, 2].float()
    o = torch.einsum("bnhts,bsnhd->btnhd", probs.float(), v)
    return o.to(qkv.dtype).reshape(b, t, n, c3 // 3)


def k2_twins(torch, k2, qkv, g, out_v3, dx_v3, shape: str) -> None:
    """K2f and K2b share K2v3's device functions in one arithmetic order:
    in bf16 K2f's output must be K2v3f's bit for bit, and K2b's gradient
    K2v3b's fed K2v3f's p (an even N pairs the same positions)."""
    heads = qkv.shape[-1] // 3 // 64
    if not torch.equal(k2.temporal_attention(qkv, heads, 0.125), out_v3):
        fail(f"K2f differs from K2v3f at {shape}")
    if not torch.equal(k2.temporal_attention_bwd(qkv, g, heads, 0.125), dx_v3):
        fail(f"K2b differs from K2v3b on K2v3f's p at {shape}")
    print(f"K2f = K2v3f and K2b = K2v3b (K2v3f's p) bit for bit at {shape}")


def phase_k2_v3(torch, F, k2) -> list:
    """K2v3f / K2v3b (slice 5) against their plain versions, timed beside
    K2f / K2b and SDPA at the training shape; returns their records."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    heads, d = 12, 64
    c, scale = heads * d, d ** -0.5
    # small cases: float32 at T = 8 and 3, bf16 at T = 8 and 3 with a
    # logit above 80 (b 0, frame 1, patch 4, head 0 against frame 2)
    for dtype, tt in ((torch.float32, 8), (torch.float32, 3),
                      (torch.bfloat16, 8), (torch.bfloat16, 3)):
        qkv = torch.randn(2, tt, 21, 3 * c, generator=gen, device="cuda").to(dtype)
        g = torch.randn(2, tt, 21, c, generator=gen, device="cuda").to(dtype)
        qkv[0, 1, 4, :64] = 3.0
        qkv[0, 2, 4, c:c + 64] = 4.0
        name = f"K2v3 small {str(dtype)[6:]} T={tt} logit > 80"
        ftol = FP32_TOL if dtype == torch.float32 else K1K2_FWD_TOL
        gtol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        out, probs = k2.temporal_attention_v3(qkv, heads, scale)
        ro, rp = k2.temporal_attention_v3_fwd_plain(qkv, heads, scale)
        compare(torch, f"{name} out", out, ro,
                FP32_TOL if dtype == torch.float32 else BF16_TOL)
        compare(torch, f"{name} probs", probs, rp, ftol)
        compare(torch, f"{name} out vs P V of its probs", out,
                v3_pv(torch, qkv, probs, heads), ftol)
        o2, none = k2.temporal_attention_v3(qkv, heads, scale, save_probs=False)
        if none is not None or not torch.equal(o2, out):
            fail(f"{name}: the forward without the store differs")
        r = k2.temporal_attention_v3_bwd_plain(qkv, rp, g, heads, scale)
        compare(torch, f"{name} dqkv", k2.temporal_attention_v3_bwd(
            qkv, rp, g, heads, scale), r, grad_tol(gtol, r))

    b, t, n = 2 * CLIPS_PER_SAMPLE, 8, 196
    qkv = torch.randn(b, t, n, 3 * c, generator=gen, device="cuda").bfloat16()
    g = torch.randn(b, t, n, c, generator=gen, device="cuda").bfloat16()
    out, probs = k2.temporal_attention_v3(qkv, heads, scale)
    ro, rp = k2.temporal_attention_v3_fwd_plain(qkv, heads, scale)
    err_f = max(compare(torch, "K2v3f bf16 out", out, ro, BF16_TOL),
                compare(torch, "K2v3f bf16 probs", probs, rp, K1K2_FWD_TOL),
                compare(torch, "K2v3f bf16 out vs P V of its probs", out,
                        v3_pv(torch, qkv, probs, heads), K1K2_FWD_TOL))
    dx = k2.temporal_attention_v3_bwd(qkv, probs, g, heads, scale)
    r = k2.temporal_attention_v3_bwd_plain(qkv, probs, g, heads, scale)
    err_b = compare(torch, "K2v3b bf16 dqkv", dx, r, grad_tol(BF16_TOL, r))
    k2_twins(torch, k2, qkv, g, out, dx, f"[{b},{t},{n},{3 * c}]")
    del ro, rp, dx, r
    ms = {"v3f": time_ms(torch, lambda: k2.temporal_attention_v3(qkv, heads, scale)),
          "v3b": time_ms(torch, lambda: k2.temporal_attention_v3_bwd(
              qkv, probs, g, heads, scale)),
          "f": time_ms(torch, lambda: k2.temporal_attention(qkv, heads, scale)),
          "b": time_ms(torch, lambda: k2.temporal_attention_bwd(
              qkv, g, heads, scale))}
    plain = {"v3f": time_ms(torch, lambda: k2.temporal_attention_v3_fwd_plain(
                 qkv, heads, scale), iters=10),
             "v3b": time_ms(torch, lambda: k2.temporal_attention_v3_bwd_plain(
                 qkv, probs, g, heads, scale), iters=5)}
    x = qkv.view(b, t, n, 3, heads, d).permute(3, 0, 2, 4, 1, 5)
    q, k, v = (x[i].reshape(b * n, heads, t, d).contiguous() for i in range(3))
    gy = g.view(b, t, n, heads, d).permute(0, 2, 3, 1, 4).reshape(
        b * n, heads, t, d).contiguous()
    lib_f, lib_b = sdpa_ms(torch, F, q, k, v, gy)
    e = 2
    nb_p = b * n * heads * t * t * e
    nb = {"v3f": b * t * n * (3 * c + c) * e + nb_p,
          "v3b": b * t * n * (3 * c + c + 3 * c) * e + nb_p}
    fl = {"v3f": 2 * 2 * b * n * heads * t * t * d,
          "v3b": 4 * 2 * b * n * heads * t * t * d}
    bound = {key: bound_ms(nb[key], fl[key], BF16_FLOPS) for key in nb}
    for key, what, twin, lib in (("v3f", "K2v3f", "f", lib_f),
                                 ("v3b", "K2v3b", "b", lib_b)):
        print(f"{what} [{b},{t},{n},{3 * c}] bf16: kernel {ms[key]:.4f} ms, "
              f"K2{twin} {ms[twin]:.4f} ms, plain {plain[key]:.4f} ms, SDPA "
              f"{'fwd' if twin == 'f' else 'bwd'} {lib:.4f} ms, bound "
              f"{bound[key][0]:.4f} ms ({bound[key][1]}: {nb[key] / 1e6:.1f} "
              f"MB, {fl[key] / 1e9:.3f} GFLOP)")
    v3_t16(torch, k2, gen)
    src = "procedurevrl_torch/csrc/temporal_attention.cu"
    where = "procedurevrl_tpu/ops/pallas_attention.py:"
    return [{"name": k2.KERNEL_V3, "route": "cuda", "source": src,
             "replaces": f"{where}1377", "max_abs_err": err_f,
             "ms": ms["v3f"], "plain_ms": plain["v3f"],
             "bound_ms": bound["v3f"][0], "bound_by": bound["v3f"][1],
             "library_ms": lib_f},
            {"name": k2.KERNEL_V3_BWD, "route": "cuda", "source": src,
             "replaces": f"{where}1421", "max_abs_err": err_b,
             "ms": ms["v3b"], "plain_ms": plain["v3b"],
             "bound_ms": bound["v3b"][0], "bound_by": bound["v3b"][1],
             "library_ms": lib_b}]


def v3_t16(torch, k2, gen) -> None:
    """K2v3f / K2v3b in bf16 past 8 frames (one position per 16-row tile):
    small cases at T = 16 and 11 with a logit above 80, then the training
    geometry with 16 frames, timed beside K2f / K2b at the same shape."""
    heads, d = 12, 64
    c, scale = heads * d, d ** -0.5
    for tt in (16, 11):
        qkv = torch.randn(2, tt, 21, 3 * c, generator=gen,
                          device="cuda").bfloat16()
        g = torch.randn(2, tt, 21, c, generator=gen, device="cuda").bfloat16()
        qkv[0, 1, 4, :64] = 3.0
        qkv[0, tt - 1, 4, c:c + 64] = 4.0  # the last key frame, above 80
        name = f"K2v3 small bf16 T={tt} logit > 80"
        out, probs = k2.temporal_attention_v3(qkv, heads, scale)
        ro, rp = k2.temporal_attention_v3_fwd_plain(qkv, heads, scale)
        compare(torch, f"{name} out", out, ro, BF16_TOL)
        compare(torch, f"{name} probs", probs, rp, K1K2_FWD_TOL)
        compare(torch, f"{name} out vs P V of its probs", out,
                v3_pv(torch, qkv, probs, heads), K1K2_FWD_TOL)
        o2, none = k2.temporal_attention_v3(qkv, heads, scale, save_probs=False)
        if none is not None or not torch.equal(o2, out):
            fail(f"{name}: the forward without the store differs")
        r = k2.temporal_attention_v3_bwd_plain(qkv, rp, g, heads, scale)
        compare(torch, f"{name} dqkv", k2.temporal_attention_v3_bwd(
            qkv, rp, g, heads, scale), r, grad_tol(BF16_TOL, r))

    b, t, n = 2 * CLIPS_PER_SAMPLE, 16, 196
    qkv = torch.randn(b, t, n, 3 * c, generator=gen, device="cuda").bfloat16()
    g = torch.randn(b, t, n, c, generator=gen, device="cuda").bfloat16()
    out, probs = k2.temporal_attention_v3(qkv, heads, scale)
    ro, rp = k2.temporal_attention_v3_fwd_plain(qkv, heads, scale)
    compare(torch, "K2v3f bf16 T=16 out", out, ro, BF16_TOL)
    compare(torch, "K2v3f bf16 T=16 probs", probs, rp, K1K2_FWD_TOL)
    compare(torch, "K2v3f bf16 T=16 out vs P V of its probs", out,
            v3_pv(torch, qkv, probs, heads), K1K2_FWD_TOL)
    r = k2.temporal_attention_v3_bwd_plain(qkv, probs, g, heads, scale)
    dx = k2.temporal_attention_v3_bwd(qkv, probs, g, heads, scale)
    compare(torch, "K2v3b bf16 T=16 dqkv", dx, r, grad_tol(BF16_TOL, r))
    k2_twins(torch, k2, qkv, g, out, dx, f"[{b},{t},{n},{3 * c}]")
    del ro, rp, r, dx
    ms = {"v3f": time_ms(torch, lambda: k2.temporal_attention_v3(qkv, heads, scale)),
          "v3b": time_ms(torch, lambda: k2.temporal_attention_v3_bwd(
              qkv, probs, g, heads, scale)),
          "f": time_ms(torch, lambda: k2.temporal_attention(qkv, heads, scale)),
          "b": time_ms(torch, lambda: k2.temporal_attention_bwd(
              qkv, g, heads, scale))}
    e, nb_p = 2, b * n * heads * t * t * 2
    nb = {"v3f": b * t * n * (3 * c + c) * e + nb_p,
          "v3b": b * t * n * (3 * c + c + 3 * c) * e + nb_p}
    fl = {"v3f": 2 * 2 * b * n * heads * t * t * d,
          "v3b": 4 * 2 * b * n * heads * t * t * d}
    for key, what, twin in (("v3f", "K2v3f", "f"), ("v3b", "K2v3b", "b")):
        bms, bby = bound_ms(nb[key], fl[key], BF16_FLOPS)
        print(f"{what} [{b},{t},{n},{3 * c}] bf16 (T = 16): kernel "
              f"{ms[key]:.4f} ms, K2{twin} {ms[twin]:.4f} ms, bound "
              f"{bms:.4f} ms ({bby}: {nb[key] / 1e6:.1f} MB, "
              f"{fl[key] / 1e9:.3f} GFLOP)")


def mvit_inputs(torch, gen, b, heads, qn, k_shape, dtype, hot=False, d=96):
    """q, k, v, kc, vc, rel, g of one K5 call ([B, L, H*d]; a K6 call is
    the same with B*H and one head); ``hot`` puts one query row's logits
    above 80."""
    kn, kcat, c = k_shape[0] * k_shape[1] * k_shape[2], sum(k_shape), heads * d

    def r(*shape):
        return (0.5 * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    x = [r(b, qn, c), r(b, kn, c), r(b, kn, c), r(b, 1, c), r(b, 1, c),
         r(b, qn, heads * kcat), r(b, qn, c)]
    if hot:
        x[0][0, 5] = x[1][0, 3] * 40
    return x


def mvit_sdpa_ms(torch, F, k5, x, heads, k_shape, scale):
    """The library yardstick: SDPA on [B, H, qN, 96] against the kN + 1 keys
    [body; cls], with the decomposed bias expanded into a float mask (zero
    on the cls column); forward, and forward + backward less the forward.
    It is the same function while every logit stays below 80, and it
    returns no gradient of rel."""
    q, k, v, kc, vc, rel, g = x
    b, qn, c = q.shape
    split = lambda t: t.reshape(b, t.shape[1], heads, 96).transpose(1, 2)
    kk, vv = split(torch.cat([k, kc], 1)), split(torch.cat([v, vc], 1))
    it, ih, iw = k5._axis_index(k_shape, q.device)
    r = rel.reshape(b, qn, heads, -1).transpose(1, 2).float()
    bias = (r[..., it] + r[..., ih]) + r[..., iw]
    mask = torch.cat([bias, bias.new_zeros(b, heads, qn, 1)], -1).to(q.dtype)
    qs = split(q).detach().requires_grad_(True)
    kk, vv = (t.detach().requires_grad_(True) for t in (kk, vv))
    sdpa = lambda: F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask,
                                                  scale=scale)
    fwd = time_ms(torch, sdpa, iters=5, reps=5)
    gy = split(g)
    both = time_ms(torch, lambda: torch.autograd.grad(sdpa(), (qs, kk, vv), gy),
                   iters=5, reps=5)
    return fwd, both - fwd


def phase_mvit_kernels(torch, F, k5) -> list:
    """K5f/K5b at blocks 0 and 4 and K6f/K6b at block 1 of MViT-v2-S (18
    clips, bf16), plus small float32 and bf16 cases with logits above 80;
    returns the records of K5 at block 0 and K6 at block 1."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    scale = 96 ** -0.5
    records = []
    cases = [("block 0", True, 18, 1, 25088, (8, 7, 7)),
             ("block 4", True, 18, 4, 1568, (8, 7, 7)),
             ("block 1", False, 36, 1, 6272, (8, 14, 14))]
    for label, head_last, b, heads, qn, k_shape in cases:
        if head_last:
            fwd, fwd_plain = k5.mvit_attention_hl_fwd, k5.mvit_attention_hl_fwd_plain
            bwd, bwd_plain = k5.mvit_attention_hl_bwd, k5.mvit_attention_hl_bwd_plain
            hs = (heads,)
        else:
            fwd, fwd_plain = k5.mvit_attention_fwd, k5.mvit_attention_fwd_plain
            bwd, bwd_plain = k5.mvit_attention_bwd, k5.mvit_attention_bwd_plain
            hs = ()
        tag = f"K{5 if head_last else 6}"
        # small cases: float32 (scalar kernels) and bf16, one hot row each
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            sb, sh = (2, 2) if head_last else (4, 1)
            xs = mvit_inputs(torch, gen, sb, sh, 70, (2, 3, 4), dtype, hot=True)
            shs = (sh,) if head_last else ()
            o, rs = fwd(*xs[:6], (2, 3, 4), *shs, scale)
            ro, rrs = fwd_plain(*xs[:6], (2, 3, 4), *shs, scale)
            name = f"{tag} small {str(dtype)[6:]} logits > 80"
            compare(torch, f"{name} out", o, ro,
                    tol if dtype == torch.float32 else MVIT_FWD_TOL)
            compare(torch, f"{name} rowsum", rs, rrs, ROWSUM_TOL)
            got = bwd(*xs[:6], rrs, xs[6], (2, 3, 4), *shs, scale)
            want = bwd_plain(*xs[:6], rrs, xs[6], (2, 3, 4), *shs, scale)
            for gname, a, r in zip(("dq", "dk", "dv", "dkc", "dvc", "drel"),
                                   got, want):
                compare(torch, f"{name} {gname}", a, r,
                        grad_tol(tol, r) if dtype == torch.float32
                        else own_tol(MVIT_GRAD_TOL, r))
        # the slice shape
        x = mvit_inputs(torch, gen, b, heads, qn, k_shape, torch.bfloat16)
        args = (*x[:6], k_shape, *hs, scale)
        out, rowsum = fwd(*args)
        ref, ref_rs = fwd_plain(*args)
        err_f = compare(torch, f"{tag}f {label} bf16 out", out, ref,
                        MVIT_FWD_TOL)
        compare(torch, f"{tag}f {label} rowsum", rowsum, ref_rs, ROWSUM_TOL)
        bargs = (*x[:6], ref_rs, x[6], k_shape, *hs, scale)
        got, want = bwd(*bargs), bwd_plain(*bargs)
        err_b = max(compare(torch, f"{tag}b {label} bf16 {n}", a, r,
                            own_tol(MVIT_GRAD_TOL, r))
                    for n, a, r in zip(("dq", "dk", "dv", "dkc", "dvc", "drel"),
                                       got, want))
        del out, ref, got, want
        ms_f = time_ms(torch, lambda: fwd(*args))
        ms_b = time_ms(torch, lambda: bwd(*bargs))
        plain_f = time_ms(torch, lambda: fwd_plain(*args), iters=2, reps=5)
        plain_b = time_ms(torch, lambda: bwd_plain(*bargs), iters=2, reps=5)
        lib_f, lib_b = mvit_sdpa_ms(torch, F, k5, x, heads, k_shape, scale)
        kn, kcat, c, e = x[1].shape[1], sum(k_shape), heads * 96, 2
        ins = e * (b * qn * c + 2 * b * kn * c + 2 * b * c + b * qn * heads * kcat)
        nb_f = ins + e * b * qn * c + 4 * b * heads * qn
        nb_b = (ins + 4 * b * heads * qn + e * b * qn * c
                + e * (b * qn * c + 2 * b * kn * c + 2 * b * c
                       + b * qn * heads * kcat))
        pairs = b * heads * qn * (kn + 1) * 96
        bf_ms, bf_by = bound_ms(nb_f, 4 * pairs, BF16_FLOPS)
        bb_ms, bb_by = bound_ms(nb_b, 10 * pairs, BF16_FLOPS)
        shape = f"[{b},{qn},{c}] x kN {kn}"
        print(f"{tag}f {label} {shape} bf16: kernel {ms_f:.4f} ms, plain "
              f"{plain_f:.4f} ms, SDPA+mask fwd {lib_f:.4f} ms, bound "
              f"{bf_ms:.4f} ms ({bf_by}: {nb_f / 1e6:.1f} MB, "
              f"{4 * pairs / 1e9:.2f} GFLOP)")
        print(f"{tag}b {label} {shape} bf16: kernel {ms_b:.4f} ms, plain "
              f"{plain_b:.4f} ms, SDPA+mask bwd {lib_b:.4f} ms (no d(rel)), "
              f"bound {bb_ms:.4f} ms ({bb_by}: {nb_b / 1e6:.1f} MB, "
              f"{10 * pairs / 1e9:.2f} GFLOP)")
        if label == "block 4":
            continue
        src = "procedurevrl_torch/csrc/mvit_attention.cu"
        where = "procedurevrl_tpu/ops/pallas_mvit_attention.py:"
        lines = (694, 715) if head_last else (197, 221)
        names = ((k5.KERNEL_HL, k5.KERNEL_HL_BWD) if head_last
                 else (k5.KERNEL, k5.KERNEL_BWD))
        for name, line, err, ms, plain, lib, bms, bby in (
                (names[0], lines[0], err_f, ms_f, plain_f, lib_f, bf_ms, bf_by),
                (names[1], lines[1], err_b, ms_b, plain_b, lib_b, bb_ms, bb_by)):
            records.append({"name": name, "route": "cuda", "source": src,
                            "replaces": f"{where}{line}", "max_abs_err": err,
                            "ms": ms, "plain_ms": plain, "bound_ms": bms,
                            "bound_by": bby, "library_ms": lib})
    return records


def pool_inputs(torch, gen, b, thw, c, dtype):
    """x as the model hands it to K8 (the k slot of a fused qkv product
    [B, 1 + T*H*W, 3C] past its CLS token: token-row stride 3C), w27
    [27, C] and g [B, T, H, W, C]."""
    n = thw[0] * thw[1] * thw[2]

    def r(*shape, sd=1.0):
        return (sd * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    x = r(b, 1 + n, 3 * c)[:, 1:, c:2 * c].reshape(b, *thw, c)
    return x, r(27, c, sd=0.1), r(b, *thw, c)


def conv_ms(torch, F, x, w, g):
    """The library yardstick of K8: ``conv3d(groups=C)`` on contiguous
    [B, C, T, H, W] copies, stride 1; forward, and the autograd backward
    for the input alone and for the weight alone, each less the forward."""
    c = x.shape[-1]
    xc = x.permute(0, 4, 1, 2, 3).contiguous()
    gc = g.permute(0, 4, 1, 2, 3).contiguous()
    wc = w.t().reshape(c, 1, 3, 3, 3).contiguous()
    xg, wg = xc.detach().requires_grad_(True), wc.detach().requires_grad_(True)
    conv = lambda a, b: F.conv3d(a, b, None, 1, 1, groups=c)
    fwd = time_ms(torch, lambda: conv(xc, wc))
    dx = time_ms(torch, lambda: torch.autograd.grad(conv(xg, wc), xg, gc))
    dw = time_ms(torch, lambda: torch.autograd.grad(conv(xc, wg), wg, gc))
    return fwd, dx - fwd, dw - fwd


def pool_bounds(b, thw, c) -> tuple:
    """K8's bounds at x [b, *thw, c] in bf16: (bytes of K8f and of its dx,
    bytes of K8dw, flops): each input read once and each output written
    once, and the products the zero padding leaves, (3d - 2) taps per axis
    of length d."""
    n = b * math.prod(thw) * c
    return (2 * (2 * n + 27 * c), 2 * 2 * n + 4 * 27 * c,
            2 * b * c * math.prod(3 * d - 2 for d in thw))


def phase_pool_kernels(torch, F, k8) -> list:
    """K8f (every stride), its stride-1 dx and K8dw on the edge cases of
    the window tiling (bf16 and float32), then K8f (stride 1 and 2), dx and
    K8dw at the five stride-1 pool shapes of the MViT-v2-S training step
    (18 clips, bf16), K8dw twice bit for bit, each timed beside its plain
    version, ``conv3d(groups=C)`` and its bound (bytes, and the fp32 FMA
    floor); returns the records of block 0."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    taps = k8.depthwise_pool3d_taps
    for label, b, thw, c in POOL_EDGES:
        for dtype, tol in ((torch.bfloat16, POOL_TOL),
                           (torch.float32, FP32_TOL)):
            name = f"{label} [{b},{','.join(map(str, thw))},{c}] {str(dtype)[6:]}"
            x, w, g = pool_inputs(torch, gen, b, thw, c, dtype)
            for s in k8.STRIDES if dtype == torch.float32 else (1, 2):
                compare(torch, f"K8f {name} s={s}", k8.depthwise_pool3d_fwd(
                    x, w, s), taps(x, w, (1, s, s)), tol)
            rdx = taps(g, w.flip(0), (1, 1, 1))
            compare(torch, f"K8f dx {name}", k8.depthwise_pool3d_dx(g, w), rdx,
                    grad_tol(tol, rdx))
            rdw = k8.taps_dw(x, g, (1, 1, 1))
            compare(torch, f"K8dw {name}", k8.depthwise_pool3d_dw(x, g), rdw,
                    grad_tol(FP32_TOL, rdw))
    records = []
    for label, thw, c, _ in POOL_SHAPES:
        b = 2 * CLIPS_PER_SAMPLE
        x, w, g = pool_inputs(torch, gen, b, thw, c, torch.bfloat16)
        err = {"f": compare(torch, f"K8f {label} bf16", k8.depthwise_pool3d_fwd(
            x, w, 1), taps(x, w, (1, 1, 1)), POOL_TOL)}
        compare(torch, f"K8f {label} bf16 s=2", k8.depthwise_pool3d_fwd(x, w, 2),
                taps(x, w, (1, 2, 2)), POOL_TOL)
        rdx = taps(g, w.flip(0), (1, 1, 1))
        err["x"] = compare(torch, f"K8f dx {label} bf16",
                           k8.depthwise_pool3d_dx(g, w), rdx,
                           grad_tol(POOL_TOL, rdx))
        rdw = k8.taps_dw(x, g, (1, 1, 1))
        dw = k8.depthwise_pool3d_dw(x, g)
        err["w"] = compare(torch, f"K8dw {label} bf16 (fp32 out)", dw, rdw,
                           grad_tol(FP32_TOL, rdw))
        if not torch.equal(dw, k8.depthwise_pool3d_dw(x, g)):
            fail(f"K8dw {label}: two runs on the same inputs differ")
        print(f"K8dw {label}: two runs agree bit for bit")
        del rdx, rdw, dw
        ms = {"f": time_ms(torch, lambda: k8.depthwise_pool3d_fwd(x, w, 1)),
              "x": time_ms(torch, lambda: k8.depthwise_pool3d_dx(g, w)),
              "w": time_ms(torch, lambda: k8.depthwise_pool3d_dw(x, g))}
        plain = {"f": time_ms(torch, lambda: taps(x, w, (1, 1, 1)), iters=2,
                              reps=5),
                 "x": time_ms(torch, lambda: taps(g, w.flip(0), (1, 1, 1)),
                              iters=2, reps=5),
                 "w": time_ms(torch, lambda: k8.taps_dw(x, g, (1, 1, 1)),
                              iters=2, reps=5)}
        lib = dict(zip("fxw", conv_ms(torch, F, x, w, g)))
        nb_f, nb_w, flops = pool_bounds(b, thw, c)
        fma_ms = flops / FP32_FLOPS * 1e3
        bound = {"f": bound_ms(nb_f, flops, FP32_FLOPS),
                 "w": bound_ms(nb_w, flops, FP32_FLOPS)}
        bound["x"] = bound["f"]
        shape = f"[{b},{thw[0]},{thw[1]},{thw[2]},{c}]"
        for key, what, nb in (("f", "K8f", nb_f), ("x", "K8f dx", nb_f),
                              ("w", "K8dw", nb_w)):
            print(f"{what} {label} {shape} bf16: kernel {ms[key]:.4f} ms, "
                  f"plain {plain[key]:.4f} ms, conv3d {lib[key]:.4f} ms, "
                  f"bound {bound[key][0]:.4f} ms ({bound[key][1]}; bytes "
                  f"{nb / 1e6:.1f} MB: {nb / HBM_BYTES_PER_S * 1e3:.4f} ms; "
                  f"fp32 FMA floor {flops / 1e9:.2f} GFLOP at "
                  f"{FP32_FLOPS / 1e12:.0f} TFLOP/s: {fma_ms:.4f} ms)")
        if label != "block 0":
            continue
        src = "procedurevrl_torch/csrc/depthwise_pool.cu"
        where = "procedurevrl_tpu/ops/pallas_pool.py:"
        for name, key, line in ((k8.KERNEL, "f", 149), (k8.KERNEL_DX, "x", 149),
                                (k8.KERNEL_DW, "w", 186)):
            records.append({"name": name, "route": "cuda", "source": src,
                            "replaces": f"{where}{line}",
                            "max_abs_err": err[key], "ms": ms[key],
                            "plain_ms": plain[key], "bound_ms": bound[key][0],
                            "bound_by": bound[key][1],
                            "library_ms": lib[key]})
    return records


def phase_kt_kernels(torch, F, k5) -> list:
    """K7f/K7b at MViT-v2-S blocks 1 and 3 (18 clips, bf16), plus small
    float32 and bf16 cases with two logits of a row above 80, against their
    plain versions; returns the records of block 1."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    scale = 96 ** -0.5
    fwd, fwd_plain = k5.mvit_attention_kt_fwd, k5.mvit_attention_kt_fwd_plain
    bwd, bwd_plain = k5.mvit_attention_kt_bwd, k5.mvit_attention_kt_bwd_plain
    rounded = k5.mvit_attention_kt_bwd_rounded_plain
    names = ("dq", "dk", "dv", "dkc", "dvc", "drel")
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        xs = mvit_inputs(torch, gen, 2, 2, 70, (2, 3, 4), dtype, hot=True)
        xs[0][0, 5] += xs[1][0, 4] * 30  # a second key above 80
        args = (*xs[:6], (2, 3, 4), 2, scale)
        o, lse = fwd(*args)
        ro, rlse = fwd_plain(*args)
        name = f"K7 small {str(dtype)[6:]} logits > 80"
        compare(torch, f"{name} out", o, ro,
                tol if dtype == torch.float32 else MVIT_FWD_TOL)
        compare(torch, f"{name} lse", lse, rlse, LSE_TOL)
        bargs = (*xs[:6], ro, rlse, xs[6], (2, 3, 4), 2, scale)
        got = bwd(*bargs)
        for gname, a, r in zip(names, got, bwd_plain(*bargs)):
            compare(torch, f"{name} {gname}", a, r, grad_tol(tol, r))
        if dtype == torch.bfloat16:
            for gname, a, r in zip(names, got, rounded(*bargs)):
                compare(torch, f"{name} {gname} (kernel rounding)", a, r,
                        own_tol(MVIT_GRAD_TOL, r))
    records = []
    for label, heads, qn in (("block 1", 2, 6272), ("block 3", 4, 1568)):
        b, k_shape = 2 * CLIPS_PER_SAMPLE, (8, 14, 14)
        x = mvit_inputs(torch, gen, b, heads, qn, k_shape, torch.bfloat16)
        args = (*x[:6], k_shape, heads, scale)
        out, lse = fwd(*args)
        ref, ref_lse = fwd_plain(*args)
        err_f = compare(torch, f"K7f {label} bf16 out", out, ref, MVIT_FWD_TOL)
        compare(torch, f"K7f {label} lse", lse, ref_lse, LSE_TOL)
        bargs = (*x[:6], ref, ref_lse, x[6], k_shape, heads, scale)
        got, want = bwd(*bargs), bwd_plain(*bargs)
        for n, a, r in zip(names, got, want):
            compare(torch, f"K7b {label} bf16 {n}", a, r,
                    grad_tol(BF16_TOL, r))
        err_b = max(compare(torch, f"K7b {label} bf16 {n} (kernel rounding)",
                            a, r, own_tol(MVIT_GRAD_TOL, r))
                    for n, a, r in zip(names, got, rounded(*bargs)))
        del out, lse, got, want
        ms_f = time_ms(torch, lambda: fwd(*args))
        ms_b = time_ms(torch, lambda: bwd(*bargs))
        plain_f = time_ms(torch, lambda: fwd_plain(*args), iters=2, reps=5)
        plain_b = time_ms(torch, lambda: bwd_plain(*bargs), iters=2, reps=5)
        lib_f, lib_b = mvit_sdpa_ms(torch, F, k5, x, heads, k_shape, scale)
        kn, kcat, c, e = x[1].shape[1], sum(k_shape), heads * 96, 2
        ins = e * (b * qn * c + 2 * b * kn * c + 2 * b * c + b * qn * heads * kcat)
        nb_f = ins + e * b * qn * c + 4 * b * heads * qn
        nb_b = (ins + 4 * b * heads * qn + 2 * e * b * qn * c
                + e * (b * qn * c + 2 * b * kn * c + 2 * b * c
                       + b * qn * heads * kcat))
        pairs = b * heads * qn * (kn + 1) * 96
        bf_ms, bf_by = bound_ms(nb_f, 4 * pairs, BF16_FLOPS)
        bb_ms, bb_by = bound_ms(nb_b, 10 * pairs, BF16_FLOPS)
        shape = f"[{b},{qn},{c}] x kN {kn}"
        print(f"K7f {label} {shape} bf16: kernel {ms_f:.4f} ms, plain "
              f"{plain_f:.4f} ms, SDPA+mask fwd {lib_f:.4f} ms, bound "
              f"{bf_ms:.4f} ms ({bf_by}: {nb_f / 1e6:.1f} MB, "
              f"{4 * pairs / 1e9:.2f} GFLOP)")
        print(f"K7b {label} {shape} bf16: kernel {ms_b:.4f} ms, plain "
              f"{plain_b:.4f} ms, SDPA+mask bwd {lib_b:.4f} ms (no d(rel)), "
              f"bound {bb_ms:.4f} ms ({bb_by}: {nb_b / 1e6:.1f} MB, "
              f"{10 * pairs / 1e9:.2f} GFLOP)")
        if label != "block 1":
            continue
        src = "procedurevrl_torch/csrc/mvit_attention.cu"
        where = "procedurevrl_tpu/ops/pallas_mvit_attention.py:"
        for name, line, err, ms, plain, lib, bms, bby in (
                (k5.KERNEL_KT, 1036, err_f, ms_f, plain_f, lib_f, bf_ms, bf_by),
                (k5.KERNEL_KT_BWD, 1078, err_b, ms_b, plain_b, lib_b, bb_ms,
                 bb_by)):
            records.append({"name": name, "route": "cuda", "source": src,
                            "replaces": f"{where}{line}", "max_abs_err": err,
                            "ms": ms, "plain_ms": plain, "bound_ms": bms,
                            "bound_by": bby, "library_ms": lib})
    return records


def phase_mvit_knob_kernels(torch, F, k5) -> list:
    """Slice 6: K5bd at MViT-v2-S blocks 0 and 4, K6bd, K6sp and K6bs at
    block 1 (18 clips, bf16), plus small float32 and bf16 cases with logits
    above 80, against their plain versions; timed beside K5b / K6f / K6b
    and SDPA with the bias as a float mask; returns their records (K5bd at
    block 0)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    scale = 96 ** -0.5
    names = ("dq", "dk", "dv", "dkc", "dvc", "drel")
    f32, b16 = torch.float32, torch.bfloat16

    def grads(label, got, want, dtype=b16) -> float:
        return max(compare(torch, f"{label} {n}", a, r,
                           grad_tol(FP32_TOL, r) if dtype == f32
                           else own_tol(MVIT_GRAD_TOL, r))
                   for n, a, r in zip(names, got, want))

    def probs_pad(label, p, kn) -> None:
        if p[..., kn + 1:].any():
            fail(f"{label} wrote non-zero padding columns")

    # kN 24 and 27: the cls column opens a row of 8 or sits inside one
    for ks, dtype in itertools.product(((2, 3, 4), (3, 3, 3)), (f32, b16)):
        ftol = FP32_TOL if dtype == f32 else MVIT_FWD_TOL
        ptol = FP32_TOL if dtype == f32 else PROBS_TOL
        kn = ks[0] * ks[1] * ks[2]
        tag = f"small kN {kn} {str(dtype)[6:]} logits > 80"
        xs = mvit_inputs(torch, gen, 2, 2, 70, ks, dtype, hot=True)
        ro, rrs = k5.mvit_attention_hl_fwd_plain(*xs[:6], ks, 2, scale)
        bargs = (*xs[:6], rrs, ro, xs[6], ks, 2, scale)
        grads(f"K5bd {tag}", k5.mvit_attention_hl_bwd_delta(*bargs),
              k5.mvit_attention_hl_bwd_delta_plain(*bargs), dtype)
        xs = mvit_inputs(torch, gen, 4, 1, 70, ks, dtype, hot=True)
        o, rs, p = k5.mvit_attention_fwd_probs(*xs[:6], ks, scale)
        ro, rrs, rp = k5.mvit_attention_fwd_probs_plain(*xs[:6], ks, scale)
        compare(torch, f"K6sp {tag} out", o, ro, ftol)
        compare(torch, f"K6sp {tag} rowsum", rs, rrs, ROWSUM_TOL)
        compare(torch, f"K6sp {tag} probs", p, rp, ptol)
        probs_pad(f"K6sp {tag}", p, kn)
        bargs = (*xs[:6], rrs, ro, xs[6], ks, scale)
        grads(f"K6bd {tag}", k5.mvit_attention_bwd_delta(*bargs),
              k5.mvit_attention_bwd_delta_plain(*bargs), dtype)
        bargs = (*xs[:6], rp, xs[6], ks, scale)
        grads(f"K6bs {tag}", k5.mvit_attention_bwd_probs(*bargs),
              k5.mvit_attention_bwd_probs_plain(*bargs), dtype)

    e = 2

    def io_bytes(b, heads, qn, kn, kcat, rel=True):
        """bf16 bytes of q, k, v, kc, vc (and rel), and of the gradients
        dq, dk, dv, dkc, dvc, drel."""
        c = heads * 96
        qkv = e * (b * qn * c + 2 * b * kn * c + 2 * b * c)
        return (qkv + (e * b * qn * heads * kcat if rel else 0),
                qkv + e * b * qn * heads * kcat)

    src = "procedurevrl_torch/csrc/mvit_attention.cu"
    where = "procedurevrl_tpu/ops/pallas_mvit_attention.py:"

    def record(name, line, err, ms, plain, lib, bound):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"{where}{line}", "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": lib}

    records = []
    for label, heads, qn in (("block 0", 1, 25088), ("block 4", 4, 1568)):
        b, k_shape = 2 * CLIPS_PER_SAMPLE, (8, 7, 7)
        x = mvit_inputs(torch, gen, b, heads, qn, k_shape, b16)
        out, rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, heads, scale)
        bargs = (*x[:6], rs, out, x[6], k_shape, heads, scale)
        err = grads(f"K5bd {label} bf16", k5.mvit_attention_hl_bwd_delta(*bargs),
                    k5.mvit_attention_hl_bwd_delta_plain(*bargs))
        ms = time_ms(torch, lambda: k5.mvit_attention_hl_bwd_delta(*bargs))
        twin = time_ms(torch, lambda: k5.mvit_attention_hl_bwd(
            *x[:6], rs, x[6], k_shape, heads, scale))
        plain = time_ms(torch, lambda: k5.mvit_attention_hl_bwd_delta_plain(
            *bargs), iters=2, reps=5)
        _, lib = mvit_sdpa_ms(torch, F, k5, x, heads, k_shape, scale)
        kn, c = x[1].shape[1], heads * 96
        ins, outs = io_bytes(b, heads, qn, kn, sum(k_shape))
        nb = ins + 4 * b * heads * qn + 2 * e * b * qn * c + outs
        pairs = b * heads * qn * (kn + 1) * 96
        bound = bound_ms(nb, 10 * pairs, BF16_FLOPS)
        print(f"K5bd {label} [{b},{qn},{c}] x kN {kn} bf16: kernel {ms:.4f} "
              f"ms, K5b {twin:.4f} ms, plain {plain:.4f} ms, SDPA+mask bwd "
              f"{lib:.4f} ms (no d(rel)), bound {bound[0]:.4f} ms "
              f"({bound[1]}: {nb / 1e6:.1f} MB, {10 * pairs / 1e9:.2f} GFLOP)")
        if label == "block 0":
            records.append(record(k5.KERNEL_HL_BWD_DELTA, 766, err, ms, plain,
                                  lib, bound))
        del out, rs, bargs, x

    b, qn, k_shape = 4 * CLIPS_PER_SAMPLE, 6272, (8, 14, 14)  # block 1, B*H
    x = mvit_inputs(torch, gen, b, 1, qn, k_shape, b16)
    kn, c = x[1].shape[1], 96
    args = (*x[:6], k_shape, scale)
    out, rs, p = k5.mvit_attention_fwd_probs(*args)
    ref, ref_rs, ref_p = k5.mvit_attention_fwd_probs_plain(*args)
    err_sp = max(compare(torch, "K6sp block 1 bf16 out", out, ref,
                         MVIT_FWD_TOL),
                 compare(torch, "K6sp block 1 bf16 probs", p, ref_p, PROBS_TOL))
    compare(torch, "K6sp block 1 rowsum", rs, ref_rs, ROWSUM_TOL)
    probs_pad("K6sp block 1", p, kn)
    if not torch.equal(out, k5.mvit_attention_fwd(*args)[0]):
        fail("K6sp's output differs from K6f's")
    print("K6sp block 1: output equals K6f's bit for bit")
    del out, rs, p
    bargs_d = (*x[:6], ref_rs, ref, x[6], k_shape, scale)
    err_bd = grads("K6bd block 1 bf16", k5.mvit_attention_bwd_delta(*bargs_d),
                   k5.mvit_attention_bwd_delta_plain(*bargs_d))
    bargs_s = (*x[:6], ref_p, x[6], k_shape, scale)
    err_bs = grads("K6bs block 1 bf16", k5.mvit_attention_bwd_probs(*bargs_s),
                   k5.mvit_attention_bwd_probs_plain(*bargs_s))
    ms = {"sp": time_ms(torch, lambda: k5.mvit_attention_fwd_probs(*args)),
          "f": time_ms(torch, lambda: k5.mvit_attention_fwd(*args)),
          "bd": time_ms(torch, lambda: k5.mvit_attention_bwd_delta(*bargs_d)),
          "bs": time_ms(torch, lambda: k5.mvit_attention_bwd_probs(*bargs_s)),
          "b": time_ms(torch, lambda: k5.mvit_attention_bwd(
              *x[:6], ref_rs, x[6], k_shape, scale))}
    plain = {"sp": time_ms(torch, lambda: k5.mvit_attention_fwd_probs_plain(
                 *args), iters=2, reps=5),
             "bd": time_ms(torch, lambda: k5.mvit_attention_bwd_delta_plain(
                 *bargs_d), iters=2, reps=5),
             "bs": time_ms(torch, lambda: k5.mvit_attention_bwd_probs_plain(
                 *bargs_s), iters=2, reps=5)}
    lib_f, lib_b = mvit_sdpa_ms(torch, F, k5, x, 1, k_shape, scale)
    ins, outs = io_bytes(b, 1, qn, kn, sum(k_shape))
    ins_s, _ = io_bytes(b, 1, qn, kn, sum(k_shape), rel=False)
    nb_p = e * b * qn * (kn + 1)  # the kN + 1 valid columns of p
    pairs = b * qn * (kn + 1) * 96
    nb = {"sp": ins + e * b * qn * c + 4 * b * qn + nb_p,
          "bd": ins + 4 * b * qn + 2 * e * b * qn * c + outs,
          "bs": ins_s + nb_p + e * b * qn * c + outs}
    fl = {"sp": 4 * pairs, "bd": 10 * pairs, "bs": 8 * pairs}
    bound = {key: bound_ms(nb[key], fl[key], BF16_FLOPS) for key in nb}
    shape = f"[{b},{qn},{c}] x kN {kn}"
    for key, what, twin, lib in (("sp", "K6sp", "K6f", lib_f),
                                 ("bd", "K6bd", "K6b", lib_b),
                                 ("bs", "K6bs", "K6b", lib_b)):
        tw = ms["f"] if twin == "K6f" else ms["b"]
        print(f"{what} block 1 {shape} bf16: kernel {ms[key]:.4f} ms, {twin} "
              f"{tw:.4f} ms, plain {plain[key]:.4f} ms, SDPA+mask "
              f"{'fwd' if key == 'sp' else 'bwd'} {lib:.4f} ms, bound "
              f"{bound[key][0]:.4f} ms ({bound[key][1]}: "
              f"{nb[key] / 1e6:.1f} MB, {fl[key] / 1e9:.2f} GFLOP)")
    records += [record(k5.KERNEL_BWD_DELTA, 268, err_bd, ms["bd"], plain["bd"],
                       lib_b, bound["bd"]),
                record(k5.KERNEL_PROBS, 206, err_sp, ms["sp"], plain["sp"],
                       lib_f, bound["sp"]),
                record(k5.KERNEL_BWD_PROBS, 316, err_bs, ms["bs"], plain["bs"],
                       lib_b, bound["bs"])]
    return records


def flash_kernel_names() -> tuple:
    """The launch-count names of the key-tiled pair: K4, K3, K1's function
    (long frames, head dims other than 64) and K2's (head dims other than
    64)."""
    from procedurevrl_torch.ops import flash_attention as fa

    return (fa.KERNEL, fa.KERNEL_BWD, fa.KERNEL_CLS, fa.KERNEL_CLS_BWD,
            fa.KERNEL_QKV, fa.KERNEL_QKV_BWD, fa.KERNEL_T, fa.KERNEL_T_BWD)


def k1_kernel_names(k1) -> tuple:
    """Every K1 kernel's launch-count name."""
    return (k1.KERNEL, k1.KERNEL_PROBS, k1.KERNEL_BWD, k1.KERNEL_PIPE,
            k1.KERNEL_BWD_RECOMPUTE, k1.KERNEL_BWD_DELTA)


def k1k2_kernels(k1, k2) -> tuple:
    """Every TimeSformer attention kernel's launch-count name: K1, K2, and
    the pair that carries K3, K4 and K1's long range."""
    return (k1_kernel_names(k1) + (k2.KERNEL, k2.KERNEL_BWD, k2.KERNEL_V3,
                                   k2.KERNEL_V3_BWD) + flash_kernel_names())


def mvit_kernel_names(k5, k8) -> tuple:
    """Every MViT kernel's launch-count name."""
    return (k5.KERNEL_HL, k5.KERNEL_HL_BWD, k5.KERNEL_HL_BWD_DELTA, k5.KERNEL,
            k5.KERNEL_BWD, k5.KERNEL_BWD_DELTA, k5.KERNEL_PROBS,
            k5.KERNEL_BWD_PROBS, k5.KERNEL_KT, k5.KERNEL_KT_BWD, k8.KERNEL,
            k8.KERNEL_DX, k8.KERNEL_DW)


def check_launches(launches: dict, expected: dict, what: str) -> None:
    for key, n in expected.items():
        if launches.get(key, 0) != n:
            fail(f"{key} launched {launches.get(key, 0)} times in {what}, "
                 f"expected {n}")


def coin_cfg(name: str, *opts):
    """``configs/COIN/<name>.yaml`` with synthetic data and ``opts``."""
    from procedurevrl_torch.config import load_config

    return load_config(os.path.join(ROOT, f"configs/COIN/{name}.yaml"),
                       ["DEV.LOAD_DUMMY_DATA", "True", *opts])


def zero_shot_opts(*opts) -> tuple:
    """The zero-shot test's overrides: no training, the 778-step COIN bank,
    16 samples a batch."""
    return ("TRAIN.ENABLE", "False", "DEV.MATCH_LANG_EMB", "True",
            "TEST.BATCH_SIZE", "16", "DEV.TEST_LANG_EMB", COIN_BANK, *opts)


def test_loader(cfg):
    """The test split's loader (``datasets/loader.py:construct_loader``)."""
    from procedurevrl_torch.datasets.loader import construct_loader

    return construct_loader(cfg, "test")


def first_batch(loader) -> dict:
    """The first batch of ``loader``, copied to the card (pinned, on the
    prefetch stream), its producer stopped."""
    from procedurevrl_torch.datasets.loader import prefetch_to_device

    batches = prefetch_to_device(loader, "cuda", size=1)
    with contextlib.closing(batches):
        return next(batches)[0]


def eval_phase(torch, k1, k2, k5, k8, _build, cfg, label: str, knobs,
               per_batch: dict, profile: bool = True) -> dict:
    """Drive ``test_net.test`` on ``cfg`` with ``knobs`` set while the
    models are built: the port kernels ``per_batch`` launch that many times
    per batch and no other port kernel launches; finite stats; one batch
    held against the same model through the plain versions; optionally one
    eval step profiled.  Clips and batches are the test loader's; the batch
    held against the plain path is its first, copied to the card.  Returns
    the launch counts of the test's run."""
    from procedurevrl_torch.engine.steps import make_eval_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.tools.test_net import test

    knobs = knobs or {}
    stray = [k for k in TS_KNOBS + MVIT_KNOBS
             if os.environ.get(k) and k not in knobs]
    if stray:
        fail(f"{label} runs with its own knobs only: unset {stray}")
    loader = test_loader(cfg)
    dataset = loader.dataset
    n_batches = len(loader)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    with knobs_set(knobs), job_dir(cfg):
        stats = test(cfg, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    clips = len(dataset) * dataset.clips
    print(f"{label}: {clips} clips ({len(dataset)} samples of "
          f"{dataset.clips}) in {n_batches} batches, top1 "
          f"{stats['top1_acc']} top5 {stats['top5_acc']}, "
          f"{stats['clips_per_sec']:.2f} clips/s "
          f"over batches 2..{n_batches}, wall {wall:.1f} s (model build "
          f"included), peak memory {peak / 2 ** 30:.3f} GiB, launches "
          f"{launches}")
    check_launches(launches, {
        key: per_batch.get(key, 0) * n_batches
        for key in k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8)},
        f"the {label} test")
    for key in ("top1_acc", "top5_acc"):
        if not math.isfinite(float(stats[key])):
            fail(f"{key} is not finite")

    # one batch: kernels vs the same model through the plain versions
    with knobs_set(knobs):
        model, bank = build_model(cfg, "cuda")
    step = make_eval_step(model, cfg, bank)
    batch = first_batch(loader)
    preds = step(batch)
    with plain_attention(k1, k2, k5, k8):
        ref = step(batch)
    torch.cuda.synchronize()
    if preds.shape != (cfg.TEST.BATCH_SIZE, cfg.MODEL.NUM_CLASSES):
        fail(f"predictions have shape {tuple(preds.shape)}")
    if not bool(torch.isfinite(preds).all()):
        fail("predictions are not finite")
    diff = (preds - ref).abs().max().item()
    agree = (preds.argmax(1) == ref.argmax(1)).float().mean().item()
    print(f"{label} batch vs plain versions: max |dpred| {diff:.3e} "
          f"(atol {PRED_ATOL}), top-1 agreement {agree:.3f}, "
          f"max pred {preds.max().item():.4f}")
    if diff > PRED_ATOL:
        fail("predictions through the kernels disagree with the plain path")
    if profile:
        profile_step(torch, f"one eval step ({cfg.TEST.BATCH_SIZE * dataset.clips}"
                     f" clips, {label})", lambda: step(batch))
    return launches


def phase_slice(torch, k1, k2, k5, k8, _build, knobs=None, opts=(),
                fwd=None) -> dict:
    """Drive the zero-shot test (slice 1; slice 5's eval with ``knobs``, set
    while the models are built; slice 7's with config ``opts``, asserting
    the forward kernels ``fwd`` once per block and batch); return the
    launch counts of its run."""
    cfg = coin_cfg("step_classification", *zero_shot_opts(*opts))
    named = [f"{k}={v}" for k, v in (knobs or {}).items()]
    named += [f"{k} {v}" for k, v in zip(opts[::2], opts[1::2])]
    label = f"slice ({' '.join(named)})" if named else "slice"
    # the forward kernels of the route, once per block and batch; no other
    # port kernel (no training kernel, no kernel of the other route)
    if fwd is None:
        fwd = ((k1.KERNEL_PIPE, k2.KERNEL_V3) if knobs
               else (k1.KERNEL, k2.KERNEL))
    return eval_phase(torch, k1, k2, k5, k8, _build, cfg, label, knobs,
                      dict.fromkeys(fwd, DEPTH))


def phase_forecast(torch, k1, k2, k5, k8, _build) -> dict:
    """Slice 14, zero-shot step forecasting: ``test_net.test`` on
    ``configs/COIN/step_forecasting.yaml`` at one view a video (64 samples
    of 8 clips x 8 frames, 4 batches of 128 clips: K1f on [1024, 196,
    2304]), 12 K1f and 12 K2f per batch and no other port kernel; one batch
    against the plain path."""
    cfg = coin_cfg("step_forecasting",
                   *zero_shot_opts("TEST.NUM_ENSEMBLE_VIEWS", "1"))
    return eval_phase(torch, k1, k2, k5, k8, _build, cfg,
                      "zero-shot forecasting", None,
                      {k1.KERNEL: DEPTH, k2.KERNEL: DEPTH}, profile=False)


def phase_mvit_eval(torch, k1, k2, k5, k8, _build) -> list:
    """Slice 14, the MViT-v2-S zero-shot eval (16 frames at 224^2, the
    778-step COIN bank, 64 videos x 4 views in batches of 16) on the
    default route (13 K5f and 3 K6f per batch) and with ``MVIT_POOL=kernel
    MVIT_KT=1`` (13 K5f, 1 K6f, 2 K7f and 17 K8f per batch); one batch of
    each against the plain path.  ``TRAIN.LABEL_EMB`` is cleared, so the
    bank is the COIN one the test names rather than the pretraining
    config's, and ``TRAIN.TEXT``, so the test split holds one clip a
    sample, not the pretraining config's 9 ASR windows."""
    from procedurevrl_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, MVIT_CFG), [
        "DEV.LOAD_DUMMY_DATA", "True", "TEST.ENABLE", "True",
        "TRAIN.LABEL_EMB", "", "TRAIN.TEXT", "", "MODEL.NUM_CLASSES", "778",
        *zero_shot_opts()])
    hl, hs = MVIT_HL_BLOCKS, MVIT_HS_BLOCKS
    return [eval_phase(torch, k1, k2, k5, k8, _build, cfg, "MViT eval", None,
                       {k5.KERNEL_HL: hl, k5.KERNEL: hs}),
            eval_phase(torch, k1, k2, k5, k8, _build, cfg,
                       "MViT eval (MVIT_POOL=kernel MVIT_KT=1)", KNOBS,
                       {k5.KERNEL_HL: hl, k5.KERNEL: KNOB_HS_BLOCKS,
                        k5.KERNEL_KT: KT_BLOCKS, k8.KERNEL: K8_POOLS})]


def train_cfg(remat: bool, *opts):
    from procedurevrl_torch.config import load_config

    return load_config(
        os.path.join(ROOT, "configs/HowTo100M/procedurevrl_adamw.yaml"),
        ["DEV.LOAD_DUMMY_DATA", "True", "TRAIN.BATCH_SIZE", "2",
         "GLOBAL_BATCH_SIZE", "2", "TPU.REMAT", str(remat), *opts])


def mvit_cfg(path: str = MVIT_CFG, *opts):
    from procedurevrl_torch.config import load_config

    return load_config(os.path.join(ROOT, path),
                       ["DEV.LOAD_DUMMY_DATA", "True", "TRAIN.BATCH_SIZE", "2",
                        "GLOBAL_BATCH_SIZE", "2", *opts])


def run_train(torch, _build, cfg, steps: int):
    """``train_net.train`` for ``steps`` steps from zeroed launch counts and
    peak memory; returns (stats, launches, peak bytes)."""
    from procedurevrl_torch.tools.train_net import train

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with job_dir(cfg):
        stats = train(cfg, device="cuda", max_steps=steps)
        torch.cuda.synchronize()
    return stats, dict(_build.LAUNCHES), torch.cuda.max_memory_allocated()


def step_vs_plain(torch, cfg, k1, k2, k5, k8, batch=None):
    """One train step of ``cfg`` through the kernels and the same step
    (params, batch, generator seeds) through the plain versions; returns
    the kernel path's step function and batch for the profile.  Without
    ``batch``, pretraining takes ``SyntheticPretrain``'s first batch (2
    samples), a COIN or EPIC-Kitchens finetune the first batch of its
    train loader, copied to the card.  Every trained
    tensor must hold a gradient after the step on both paths."""
    from procedurevrl_torch.datasets.loader import construct_loader
    from procedurevrl_torch.datasets.synthetic import SyntheticPretrain
    from procedurevrl_torch.engine.steps import make_train_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.solver.lr_policy import lr_schedule
    from procedurevrl_torch.solver.optimizer import construct_optimizer

    gen = torch.Generator(device="cuda")
    if batch is not None:
        pass
    elif cfg.TRAIN.TEXT:
        batch = SyntheticPretrain(cfg).batch(2, 0, gen)
    else:
        batch = first_batch(construct_loader(cfg, "train"))
        batch.pop("index")

    def one_step():
        model, bank = build_model(cfg, "cuda")
        step = make_train_step(model, construct_optimizer(model, cfg), cfg,
                               bank, lr_schedule(cfg, 1))
        m = step(batch)
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.requires_grad}
        missing = sorted(n for n, g in grads.items() if g is None)
        if missing:
            fail(f"trained tensors without a gradient: {missing}")
        return step, {k: float(v) for k, v in m.items()}, {
            n: g.float().clone() for n, g in grads.items()}

    step, mk, gk = one_step()
    with plain_attention(k1, k2, k5, k8):
        _, mp, gp = one_step()
    if set(gk) != set(gp):
        fail(f"trained tensors differ between the paths: "
             f"{sorted(set(gk) ^ set(gp))}")
    worst_cos, worst, least = 1.0, "", math.inf
    zero = {}  # name -> (kernel-path, plain-path norm) / global norm
    for name, g in gk.items():
        a, b = g.flatten(), gp[name].flatten()
        na, nb = (x.norm().item() / mp["grad_norm"] for x in (a, b))
        if nb <= ROUNDING_RTOL:
            zero[name] = (na, nb)
            continue
        least = min(least, nb)
        cos = (a @ b).item() / max(a.norm().item() * b.norm().item(), 1e-30)
        if cos < worst_cos:
            worst_cos, worst = cos, name
    zero_k = max((z[0] for z in zero.values()), default=0.0)
    zero_p = max((z[1] for z in zero.values()), default=0.0)
    kinds = sorted({re.sub(r"\.\d+\.", ".*.", n) for n in zero})
    d_loss = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    d_norm = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    parts = "".join(f"{k} {mk[k]:.6f} / {mp[k]:.6f}, " for k in ("kl", "mse")
                    if k in mk)
    print(f"train step vs plain versions: loss {mk['loss']:.6f} / "
          f"{mp['loss']:.6f} (rel {d_loss:.2e}, tol {STEP_LOSS_RTOL}), "
          f"{parts}grad norm {mk['grad_norm']:.6f} / "
          f"{mp['grad_norm']:.6f} (rel {d_norm:.2e}, tol {STEP_NORM_RTOL}), "
          f"least gradient cosine {worst_cos:.6f} ({worst}; min "
          f"{STEP_MIN_COS}) over {len(gk) - len(zero)} trained tensors, "
          f"whose least plain-path norm is {least:.2e} of the global norm; "
          f"{len(zero)} gradients nought to rounding on the plain path "
          f"(norm <= {ROUNDING_RTOL} of the global) {kinds}: largest norm "
          f"{zero_k:.2e} through the kernels (max {ZERO_GRAD_RTOL}), "
          f"{zero_p:.2e} through the plain versions")
    if not all(math.isfinite(v) for v in mk.values()):
        fail("train step metrics are not finite")
    if d_loss > STEP_LOSS_RTOL or d_norm > STEP_NORM_RTOL:
        fail("the train step through the kernels disagrees with the plain path")
    if worst_cos < STEP_MIN_COS:
        fail(f"gradient of {worst} disagrees with the plain path "
             f"(cosine {worst_cos:.4f})")
    if zero_k > ZERO_GRAD_RTOL:
        fail("a gradient that is nought on the plain path is not small "
             "through the kernels")
    return step, batch


def phase_train(torch, k1, k2, k5, k8, _build) -> dict:
    """Drive slice 2; return the launch counts of its main run."""
    from procedurevrl_torch.datasets.loader import construct_loader
    from procedurevrl_torch.tools.train_net import WARMUP_STEPS

    if any(os.environ.get(k) for k in TS_KNOBS):
        fail(f"phase 7 runs the default route: unset {list(TS_KNOBS)}")
    stats, launches, peak = run_train(torch, _build, train_cfg(True),
                                      TRAIN_STEPS)
    clips = stats["clips_per_step"]
    for i, h in enumerate(stats["history"]):
        print(f"train step {i + 1}: loss {h['loss']:.6f} kl {h['kl']:.6f} "
              f"mse {h['mse']:.6f} grad_norm {h['grad_norm']:.4f} "
              f"lr {h['lr']:.3e}")
        if not all(math.isfinite(h[k]) for k in ("loss", "kl", "mse")):
            fail(f"train step {i + 1} has a non-finite loss")
    if len(stats["history"]) != TRAIN_STEPS:
        fail(f"{len(stats['history'])} train steps, expected {TRAIN_STEPS}")
    rate = stats["clips_per_sec"]
    print(f"train slice (remat): {clips} clips/step, {rate:.2f} clips/s over "
          f"steps {WARMUP_STEPS + 1}..{TRAIN_STEPS} (~"
          f"{3 * FWD_GFLOP_PER_CLIP * rate / 1e3:.1f} model TFLOP/s), peak "
          f"memory {peak / 2 ** 30:.3f} GiB, launches {launches}")
    # under remat JAX's policy keeps the attention kernels' outputs: every
    # forward kernel runs once per block and step (the recomputation takes
    # its kept outputs), each backward kernel once
    expected = dict.fromkeys(k1k2_kernels(k1, k2), 0)
    expected.update({k1.KERNEL_PROBS: DEPTH * TRAIN_STEPS,
                     k2.KERNEL: DEPTH * TRAIN_STEPS,
                     k1.KERNEL_BWD: DEPTH * TRAIN_STEPS,
                     k2.KERNEL_BWD: DEPTH * TRAIN_STEPS})
    check_launches(launches, expected, f"{TRAIN_STEPS} steps")

    stats2, launches2, peak2 = run_train(torch, _build, train_cfg(False),
                                         NO_REMAT_STEPS)
    rate2 = stats2["clips_per_sec"]
    print(f"train slice (no remat): {rate2:.2f} clips/s over steps "
          f"{WARMUP_STEPS + 1}..{NO_REMAT_STEPS}, peak memory "
          f"{peak2 / 2 ** 30:.3f} GiB, launches {launches2}, losses "
          f"{[round(h['loss'], 6) for h in stats2['history']]}")
    for key in (k1.KERNEL_PROBS, k2.KERNEL, k1.KERNEL_BWD, k2.KERNEL_BWD):
        if launches2.get(key, 0) != DEPTH * NO_REMAT_STEPS:
            fail(f"{key} launched {launches2.get(key, 0)} times without "
                 f"remat, expected {DEPTH * NO_REMAT_STEPS}")

    # one batch of the train loader, copied to the card
    batch = first_batch(construct_loader(train_cfg(True), "train"))
    batch.pop("index")
    step, batch = step_vs_plain(torch, train_cfg(True), k1, k2, k5, k8, batch)
    profile_step(torch, f"one train step ({clips} clips, remat)",
                 lambda: float(step(batch)["loss"]))
    return launches


def phase_finetune(torch, k1, k2, k5, k8, _build) -> dict:
    """Slice 14, the COIN finetunes (``TRAIN.LINEAR``, SGD, the encoder
    frozen): ``train_net.train`` on each of ``FINETUNES`` for its steps,
    cut there, so that the run ends with one val epoch (batches of
    ``TRAIN.BATCH_SIZE``); finite losses and val errors; per micro-batch
    and val batch 12 K1f and 12 K2f and no other port kernel (no K1sp, no
    backward kernel: the frozen encoder runs without autograd, so nothing
    is recomputed); one step against the plain path and one step profiled.
    Returns the launch counts summed over the runs."""
    from procedurevrl_torch.datasets.loader import construct_loader
    from procedurevrl_torch.tools.train_net import WARMUP_STEPS

    from procedurevrl_torch.datasets import howto100m

    if any(os.environ.get(k) for k in TS_KNOBS):
        fail(f"phase 30 runs the default route: unset {list(TS_KNOBS)}")
    videos, howto100m.NUM_SYNTHETIC = howto100m.NUM_SYNTHETIC, FINETUNE_VIDEOS
    try:
        return finetunes(torch, k1, k2, k5, k8, _build, construct_loader,
                         WARMUP_STEPS)
    finally:
        howto100m.NUM_SYNTHETIC = videos


def finetunes(torch, k1, k2, k5, k8, _build, construct_loader,
              WARMUP_STEPS) -> dict:
    """The body of :func:`phase_finetune`."""
    total: dict = {}
    for name, batch_size, steps in FINETUNES:
        cfg = coin_cfg(name, "TRAIN.BATCH_SIZE", str(batch_size),
                       "GLOBAL_BATCH_SIZE", str(batch_size))
        if not cfg.TRAIN.LINEAR:
            fail(f"{name} is no linear probe")
        stats, launches, peak = run_train(torch, _build, cfg, steps)
        for i, h in enumerate(stats["history"]):
            print(f"{name} step {i + 1}: loss {h['loss']:.6f} grad_norm "
                  f"{h['grad_norm']:.4f} top1_err {h['top1_err']:.1f} lr "
                  f"{h['lr']:.3e}")
            if not all(math.isfinite(h[k]) for k in ("loss", "grad_norm")):
                fail(f"{name} step {i + 1} is not finite")
        if len(stats["history"]) != steps or len(stats["val"]) != 1:
            fail(f"{name}: {len(stats['history'])} steps and "
                 f"{len(stats['val'])} val epochs, expected {steps} and 1")
        val = stats["val"][0]
        if not all(math.isfinite(val[k]) for k in ("top1_err", "top5_err")):
            fail(f"{name}: the val errors are not finite")
        n_val = len(construct_loader(cfg, "val"))
        print(f"{name} (linear probe): {stats['clips_per_step']} clips/step, "
              f"{stats['clips_per_sec']:.2f} clips/s over steps "
              f"{WARMUP_STEPS + 1}..{steps}, val epoch of {n_val} batches: "
              f"top1_err {val['top1_err']:.3f} top5_err "
              f"{val['top5_err']:.3f}, peak memory {peak / 2 ** 30:.3f} GiB, "
              f"launches {launches}")
        forwards = DEPTH * (steps + n_val)
        check_launches(launches, {
            key: forwards if key in (k1.KERNEL, k2.KERNEL) else 0
            for key in k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8)},
            f"{steps} {name} steps and a val epoch")
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
        step, batch = step_vs_plain(torch, cfg, k1, k2, k5, k8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profile_step(torch, f"one {name} step ({stats['clips_per_step']} "
                     f"clips, linear probe)", lambda: float(step(batch)["loss"]))
        print(f"{name} profiled step peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    return total


def resume_run(torch, k1, k2, k5, k8, _build, out: str, label: str,
               max_steps=None) -> dict:
    """One ``train_net.train`` of phase 31's pretraining in ``out``;
    asserts finite metrics and, per micro-batch, 12 K1sp, 12 K2f, 12 K1b
    and 12 K2b (remat) and no other port kernel.  Returns its stats."""
    from procedurevrl_torch.tools.train_net import train

    cfg = train_cfg(True, *RESUME_OPTS)
    cfg.OUTPUT_DIR = out
    _build.reset_launches()
    t0 = time.perf_counter()
    with quiet():
        stats = train(cfg, device="cuda", max_steps=max_steps)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for h in stats["history"]:
        if not all(math.isfinite(h[k]) for k in ("loss", "kl", "mse",
                                                 "grad_norm")):
            fail(f"run {label} has a non-finite step: {h}")
    micro = stats["steps"] * RESUME_ACCUM
    per_micro = {k1.KERNEL_PROBS: DEPTH, k2.KERNEL: DEPTH,
                 k1.KERNEL_BWD: DEPTH, k2.KERNEL_BWD: DEPTH}
    check_launches(launches, {
        key: per_micro.get(key, 0) * micro
        for key in k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8)},
        f"run {label}")
    print(f"run {label}: epochs {stats['start_epoch'] + 1}.."
          f"{stats['start_epoch'] + stats['steps'] // RESUME_STEPS} from "
          f"optimizer step {stats['start_step']}, {stats['steps']} steps of "
          f"{stats['clips_per_step']} clips in {wall:.1f} s (model build and "
          f"checkpoint writes included), losses "
          f"{[round(h['loss'], 6) for h in stats['history']]}, checkpoints "
          f"{[os.path.basename(p) for p in stats['checkpoints']]}, launches "
          f"{launches}")
    return stats


def same_state(torch, a: dict, b: dict, what: str) -> None:
    """Every tensor of ``a`` (nested dicts of tensors) equals ``b``'s."""
    if isinstance(a, dict):
        if set(a) != set(b):
            fail(f"{what}: keys differ")
        for k in a:
            same_state(torch, a[k], b[k], f"{what}.{k}")
    elif torch.is_tensor(a):
        if not torch.equal(a, b):
            fail(f"{what} differs")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            same_state(torch, x, y, f"{what}[{i}]")


def phase_checkpoints(torch, k1, k2, k5, k8, _build) -> None:
    """Slice 15 (phase 31): pretrain, resume, finetune from the file, and
    test from ``OUTPUT_DIR``, all through files (see the module's list)."""
    from procedurevrl_torch.datasets.loader import construct_loader
    from procedurevrl_torch.engine.steps import make_eval_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.solver.optimizer import construct_optimizer
    from procedurevrl_torch.tools.test_net import test
    from procedurevrl_torch.tools.train_net import train
    from procedurevrl_torch.utils import checkpoint as cu
    from procedurevrl_torch.utils.metrics import topks_correct

    if any(os.environ.get(k) for k in TS_KNOBS):
        fail(f"phase 31 runs the default route: unset {list(TS_KNOBS)}")
    from procedurevrl_torch.datasets import howto100m

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    videos, howto100m.NUM_SYNTHETIC = howto100m.NUM_SYNTHETIC, RESUME_VIDEOS
    try:
        # 1. pretraining: A straight, B cut after epoch 1 and resumed
        t0 = time.perf_counter()
        run = functools.partial(resume_run, torch, k1, k2, k5, k8, _build)
        a = run(os.path.join(root, "a"), "A")
        names = [os.path.basename(p) for p in a["checkpoints"]]
        if names != ["checkpoint_epoch_00001.pyth",
                     "checkpoint_epoch_00002.pyth"]:
            fail(f"run A wrote {names}")
        b1 = run(os.path.join(root, "b"), "B (cut after epoch 1)",
                 RESUME_STEPS)
        if [os.path.basename(p) for p in b1["checkpoints"]] != [
                "checkpoint_epoch_00001.pyth"]:
            fail(f"run B's first part wrote {b1['checkpoints']}")
        b2 = run(os.path.join(root, "b"), "B (resumed)")
        if (b2["start_epoch"], b2["start_step"]) != (1, RESUME_STEPS):
            fail(f"run B resumed at epoch {b2['start_epoch'] + 1}, step "
                 f"{b2['start_step']}, expected epoch 2, step "
                 f"{RESUME_STEPS}")
        ha, hb = a["history"][RESUME_STEPS:], b2["history"]
        if len(hb) != RESUME_STEPS or any(x["lr"] != y["lr"]
                                          for x, y in zip(ha, hb)):
            fail("run B's epoch 2 is not run A's (steps or LR)")
        d_loss = max(abs(x["loss"] - y["loss"]) / abs(x["loss"])
                     for x, y in zip(ha, hb))
        d_norm = max(abs(x["grad_norm"] - y["grad_norm"]) / x["grad_norm"]
                     for x, y in zip(ha, hb))
        pa, pb = a["model"].state_dict(), b2["model"].state_dict()
        d_param = max((pa[k].float() - pb[k].float()).abs().max().item()
                      for k in pa)
        d_rel = max(((pa[k].float() - pb[k].float()).norm()
                     / pa[k].float().norm().clamp_min(1e-30)).item()
                    for k in pa)
        exact = (all(x == y for x, y in zip(ha, hb))
                 and all(torch.equal(pa[k], pb[k]) for k in pa)
                 and all(x == y for x, y in zip(a["history"][:RESUME_STEPS],
                                                b1["history"])))
        print(f"resume: run B's epoch 2 vs run A's: max loss rel diff "
              f"{d_loss:.3e} (tol {STEP_LOSS_RTOL}), max grad norm rel diff "
              f"{d_norm:.3e} (tol {STEP_NORM_RTOL}), final parameters max "
              f"|d| {d_param:.3e}, max per-tensor rel norm diff {d_rel:.3e} "
              f"(tol {STEP_NORM_RTOL}); bit for bit: {exact}")
        if d_loss > STEP_LOSS_RTOL or d_norm > STEP_NORM_RTOL:
            fail("the resumed run's epoch 2 disagrees with the straight run")
        if d_rel > STEP_NORM_RTOL:
            fail("the resumed run's parameters disagree with the straight "
                 "run's")
        del b1, b2, pb
        shutil.rmtree(os.path.join(root, "b"))
        os.remove(a["checkpoints"][0])
        print(f"phase 31 leg 1 (pretrain, resume): "
              f"{time.perf_counter() - t0:.1f} s")

        # the writers and the load, on run A's last file
        t0 = time.perf_counter()
        path_a = a["checkpoints"][-1]
        cfg = train_cfg(True, *RESUME_OPTS)
        with quiet():
            model, _ = build_model(cfg, "cuda")
            opt = construct_optimizer(model, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            epoch, step = cu.load_checkpoint(path_a, model, opt)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t1
            if (epoch, step) != (1, 2 * RESUME_STEPS):
                fail(f"{path_a} holds epoch {epoch}, step {step}")
            same_state(torch, model.state_dict(), pa, "the loaded model")
            t1 = time.perf_counter()
            sync_path = cu.save_checkpoint(os.path.join(root, "sync"), model,
                                           opt, cfg, epoch, step)
            t_sync = time.perf_counter() - t1
            writer = cu.AsyncCheckpointer()
            t1 = time.perf_counter()
            async_path = writer.save(os.path.join(root, "async"), model, opt,
                                     cfg, epoch, step)
            t_async = time.perf_counter() - t1
            writer.wait()
            t_async_all = time.perf_counter() - t1
        size = os.path.getsize(sync_path)
        blobs = [torch.load(p, map_location="cpu", weights_only=False)
                 for p in (sync_path, async_path)]
        same_state(torch, blobs[0], blobs[1], "the thread writer's file")
        if blobs[0]["step"] != step or blobs[1]["cfg"] != blobs[0]["cfg"]:
            fail("the two writers' files differ")
        file_state = blobs[0]["model_state"]
        print(f"checkpoint of TimeSformer-B pretraining (model + AdamW): "
              f"{size} bytes ({size / 2 ** 30:.3f} GiB); the loop's stall "
              f"in save: blocking writer {t_sync:.3f} s, thread writer "
              f"{t_async:.4f} s (its write done {t_async_all:.3f} s after "
              f"the call); load (read + restore onto the card) "
              f"{t_load:.3f} s; the two files' tensors equal")
        del blobs, model, opt, a, pa
        shutil.rmtree(os.path.join(root, "sync"))
        shutil.rmtree(os.path.join(root, "async"))
        torch.cuda.empty_cache()
        print(f"phase 31 leg 2 (writers, load): "
              f"{time.perf_counter() - t0:.1f} s")

        # 3. the COIN forecasting linear probe from run A's last file
        t0 = time.perf_counter()
        ft = os.path.join(root, "ft")
        cfg = coin_cfg("step_forecasting", "TRAIN.BATCH_SIZE", "2",
                       "GLOBAL_BATCH_SIZE", "16", "SOLVER.MAX_EPOCH", "1",
                       "TRAIN.CHECKPOINT_FILE_PATH", path_a,
                       "TRAIN.CHECKPOINT_EPOCH_RESET", "True",
                       "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.BATCH_SIZE",
                       "16", "TEST.SAVE_RESULTS_PATH", "results.pkl",
                       "OUTPUT_DIR", ft)
        if not cfg.TRAIN.LINEAR:
            fail("step_forecasting.yaml is no linear probe")
        with quiet():  # the load train_net makes, on a model of its own
            model, _ = build_model(cfg, "cuda")
            head_cls = {k: v.clone() for k, v in model.state_dict().items()
                        if k.startswith("head_cls.")}
            start = cu.load_train_checkpoint(cfg, model,
                                             construct_optimizer(model, cfg))
        if start != (0, 0):
            fail(f"the finetune starts at (epoch, step) {start}")
        for k, v in model.state_dict().items():
            want = head_cls.get(k, file_state.get(k))
            if want is None or not torch.equal(v.cpu(), want.cpu()):
                fail(f"the finetune's {k} is not "
                     f"{'its init' if k in head_cls else 'from the file'}")
        n_order = sum(k.startswith("order_tfm.") for k in model.state_dict())
        del model, file_state
        _build.reset_launches()
        t1 = time.perf_counter()
        with quiet():
            stats = train(cfg, device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(_build.LAUNCHES)
        # TRAIN.EPOCH_MUL 2: an epoch is twice the index, 2 samples a batch
        micro = len(construct_loader(cfg, "train"))
        accum = cfg.GLOBAL_BATCH_SIZE // cfg.TRAIN.BATCH_SIZE
        check_launches(launches, {
            key: DEPTH * micro if key in (k1.KERNEL, k2.KERNEL) else 0
            for key in k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8)},
            "the finetune from the pretraining file")
        saved = [os.path.basename(p) for p in stats["checkpoints"]]
        if stats["steps"] != micro // accum or saved != [
                "checkpoint_epoch_00001.pyth"]:
            fail(f"the finetune ran {stats['steps']} steps and wrote {saved}")
        if not all(math.isfinite(h["loss"]) for h in stats["history"]):
            fail("the finetune has a non-finite loss")
        print(f"finetune from {os.path.basename(path_a)}: encoder, head and "
              f"{n_order} order_tfm tensors the file's, head_cls at its "
              f"seeded init; {stats['steps']} steps of "
              f"{stats['clips_per_step']} clips in {wall:.1f} s, losses "
              f"{[round(h['loss'], 6) for h in stats['history']]}, wrote "
              f"{saved}, launches {launches}")
        print(f"phase 31 leg 3 (finetune): {time.perf_counter() - t0:.1f} s")

        # 4. the test, from OUTPUT_DIR's last checkpoint
        t0 = time.perf_counter()
        loader = test_loader(cfg)
        dataset = loader.dataset
        n_batches = len(loader)
        _build.reset_launches()
        with quiet():
            tstats = test(cfg, device="cuda")
            torch.cuda.synchronize()
            model, _ = build_model(cfg, "cuda")
            loaded = cu.load_test_checkpoint(cfg, model)
        launches = dict(_build.LAUNCHES)
        check_launches(launches, {
            key: DEPTH * n_batches if key in (k1.KERNEL, k2.KERNEL) else 0
            for key in k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8)},
            "the test from OUTPUT_DIR")
        if loaded != stats["checkpoints"][-1]:
            fail(f"the test loaded {loaded}, not the finetune's checkpoint")
        batch = first_batch(loader)
        p_file = make_eval_step(model, cfg, None)(batch)
        p_mem = make_eval_step(stats["model"], cfg, None)(batch)
        torch.cuda.synchronize()
        if not torch.equal(p_file, p_mem):
            fail(f"the loaded model predicts other than the trained one: max "
                 f"|d| {(p_file - p_mem).abs().max().item():.3e}")
        with open(os.path.join(ft, "results.pkl"), "rb") as f:
            res = pickle.load(f)
        preds, labels = (torch.from_numpy(res[k]) for k in ("preds",
                                                            "labels"))
        top1 = float(topks_correct(preds, labels, (1,))[0]) / len(labels)
        if (preds.shape != (len(dataset), cfg.MODEL.NUM_CLASSES)
                or not bool(torch.isfinite(preds).all())
                or "{:.2f}".format(top1 * 100) != tstats["top1_acc"]):
            fail(f"TEST.SAVE_RESULTS_PATH holds preds {tuple(preds.shape)}, "
                 f"top1 {top1 * 100:.2f} against {tstats['top1_acc']}")
        print(f"test from {os.path.basename(loaded)} in OUTPUT_DIR: "
              f"{n_batches} batches of {cfg.TEST.BATCH_SIZE} x "
              f"{dataset.clips} clips, top1 {tstats['top1_acc']} top5 "
              f"{tstats['top5_acc']}, clips/s {tstats['clips_per_sec']} (none "
              f"for a single batch); "
              f"one batch's predictions equal the in-memory model's bit for "
              f"bit (max {p_file.max().item():.4f}); results.pkl read back "
              f"({tuple(preds.shape)}, top1 {top1 * 100:.2f}); launches "
              f"{launches}")
        print(f"phase 31 leg 4 (test): {time.perf_counter() - t0:.1f} s")
    finally:
        howto100m.NUM_SYNTHETIC = videos
        shutil.rmtree(root, ignore_errors=True)


def mvit_train(torch, k1, k2, k5, k8, _build, label: str, steps: int,
               expected: dict, cfg_path: str = MVIT_CFG) -> dict:
    """MViT-v2-S order pretraining through ``train_net.train`` on
    ``cfg_path`` for ``steps`` steps with asserted launch counts (every
    MViT kernel not in ``expected`` 0), one step against the plain path,
    and a profiled step; returns the launch counts of the main run."""
    from procedurevrl_torch.tools.train_net import WARMUP_STEPS

    cfg = mvit_cfg(cfg_path)
    stats, launches, peak = run_train(torch, _build, cfg, steps)
    clips = stats["clips_per_step"]
    for i, h in enumerate(stats["history"]):
        print(f"{label} step {i + 1}: loss {h['loss']:.6f} kl "
              f"{h['kl']:.6f} mse {h['mse']:.6f} grad_norm "
              f"{h['grad_norm']:.4f} lr {h['lr']:.3e}")
        if not all(math.isfinite(h[k]) for k in ("loss", "kl", "mse",
                                                 "grad_norm")):
            fail(f"{label} step {i + 1} is not finite")
    if len(stats["history"]) != steps:
        fail(f"{len(stats['history'])} {label} steps, expected {steps}")
    print(f"{label} (remat): {clips} clips/step, "
          f"{stats['clips_per_sec']:.2f} clips/s over steps "
          f"{WARMUP_STEPS + 1}..{steps}, peak memory "
          f"{peak / 2 ** 30:.3f} GiB, launches {launches}")
    full = dict.fromkeys(k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8), 0)
    full.update(expected)
    check_launches(launches, full, f"{steps} {label} steps")
    step, batch = step_vs_plain(torch, cfg, k1, k2, k5, k8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profile_step(torch, f"one {label} step ({clips} clips, remat)",
                 lambda: float(step(batch)["loss"]))
    print(f"{label} profiled step peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    return launches


def phase_mvit_train(torch, k1, k2, k5, k8, _build) -> dict:
    """Drive slice 3, the MViT-v2-S order-pretraining step on the default
    route; return the launch counts of its main run."""
    if any(os.environ.get(k) for k in MVIT_KNOBS):
        fail(f"phase 9 runs the default route: unset {list(MVIT_KNOBS)}")
    # remat keeps the attention kernels' outputs (JAX's MViT policy): each
    # forward and each backward kernel runs once per block and step; no
    # kernel of slices 4 and 6 runs
    n = MVIT_STEPS
    expected = {k5.KERNEL_HL: MVIT_HL_BLOCKS * n,
                k5.KERNEL: MVIT_HS_BLOCKS * n,
                k5.KERNEL_HL_BWD: MVIT_HL_BLOCKS * n,
                k5.KERNEL_BWD: MVIT_HS_BLOCKS * n}
    return mvit_train(torch, k1, k2, k5, k8, _build, "MViT train", n,
                      expected)


@contextlib.contextmanager
def knobs_set(knobs: dict):
    """The environment knobs ``knobs`` for the models built inside, the
    environment as it was afterwards."""
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_knob_train(torch, k1, k2, k5, k8, _build) -> dict:
    """Drive slice 4, the MViT-v2-S step on the JAX package's
    ``MVIT_POOL=kernel`` / ``MVIT_KT=1`` route; return the launch counts of
    its main run."""
    if any(os.environ.get(k) for k in ROUTE_D):
        fail(f"phase 11 runs without slice 6's knobs: unset {sorted(ROUTE_D)}")
    n = KNOB_STEPS
    hl = MVIT_HL_BLOCKS  # blocks 1 and 3 leave K6 for K7; K5's are as before
    # the policy keeps the attention kernels' outputs, not the pools': the
    # pool forward still runs twice a step (forward and recomputation)
    expected = {k5.KERNEL_HL: hl * n, k5.KERNEL_HL_BWD: hl * n,
                k5.KERNEL_KT: KT_BLOCKS * n, k5.KERNEL_KT_BWD: KT_BLOCKS * n,
                k5.KERNEL: KNOB_HS_BLOCKS * n,
                k5.KERNEL_BWD: KNOB_HS_BLOCKS * n,
                k8.KERNEL: 2 * K8_POOLS * n, k8.KERNEL_DX: K8_POOLS * n,
                k8.KERNEL_DW: K8_POOLS * n}
    with knobs_set(KNOBS):
        return mvit_train(torch, k1, k2, k5, k8, _build, "MViT knob train",
                          n, expected)


def phase_route_train(torch, k1, k2, k5, k8, _build, label: str, knobs: dict,
                      expected: dict) -> dict:
    """Slice 6: MViT-v2-S SGD pretraining (``MVIT_SGD_CFG``) with ``knobs``
    set while the models are built; returns the launch counts of its run."""
    if any(os.environ.get(k) for k in MVIT_KNOBS):
        fail(f"{label} runs with its own knobs only: unset {list(MVIT_KNOBS)}")
    with knobs_set(knobs):
        return mvit_train(torch, k1, k2, k5, k8, _build, label, ROUTE_STEPS,
                          expected, MVIT_SGD_CFG)


def phase_ts_knob_train(torch, k1, k2, k5, k8, _build, label: str,
                        knobs: dict, expected: dict, profile: bool,
                        opts=(), steps: int = TRAIN_STEPS) -> dict:
    """Slices 5 and 7: phase 7's TimeSformer training (remat) with
    ``knobs`` set while the models are built and config ``opts``: ``steps``
    steps with finite losses and the launch counts ``expected`` per step
    (every other TimeSformer attention kernel 0), one step against the
    plain path, and optionally a profiled step with its peak memory;
    returns the launch counts."""
    from procedurevrl_torch.tools.train_net import WARMUP_STEPS

    full = dict.fromkeys(k1k2_kernels(k1, k2), 0)
    full.update({key: n * steps for key, n in expected.items()})
    cfg = train_cfg(True, *opts)
    with knobs_set(knobs):
        stats, launches, peak = run_train(torch, _build, cfg, steps)
        for i, h in enumerate(stats["history"]):
            print(f"{label} step {i + 1}: loss {h['loss']:.6f} kl "
                  f"{h['kl']:.6f} mse {h['mse']:.6f} grad_norm "
                  f"{h['grad_norm']:.4f}")
            if not all(math.isfinite(h[k]) for k in ("loss", "kl", "mse",
                                                     "grad_norm")):
                fail(f"{label} step {i + 1} is not finite")
        if len(stats["history"]) != steps:
            fail(f"{len(stats['history'])} {label} steps, expected {steps}")
        print(f"{label} (remat): {stats['clips_per_step']} clips/step, "
              f"{stats['clips_per_sec']:.2f} clips/s over steps "
              f"{WARMUP_STEPS + 1}..{steps}, peak memory "
              f"{peak / 2 ** 30:.3f} GiB, launches {launches}")
        check_launches(launches, full, f"{steps} {label} steps")
        step, batch = step_vs_plain(torch, cfg, k1, k2, k5, k8)
        if profile:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            profile_step(torch, f"one {label} step "
                         f"({stats['clips_per_step']} clips, remat)",
                         lambda: float(step(batch)["loss"]))
            print(f"{label} profiled step peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    return launches

def flash_inputs(torch, gen, b, n, heads, dtype, cls, hot=False, sd=1.0):
    """The inputs of one K4 (``cls`` False) or K3 call: q, k, v as the
    thirds of one projection [B, N, 3C] (and qc, kc, vc of [B, 1, 3C]), g
    (and gc), sd N(0, 1); ``hot`` puts one logit above 80 (sample 0, query
    5, head 0, against key 3, or the CLS key)."""
    c = heads * 64

    def r(*shape):
        return (sd * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    qkv, g = r(b, n, 3 * c), r(b, n, c)
    qkv_c, gc = (r(b, 1, 3 * c), r(b, 1, c)) if cls else (None, None)
    if hot:
        qkv[0, 5, :64] = 3.0
        (qkv_c[0, 0] if cls else qkv[0, 3])[c:c + 64] = 4.0  # logit 96
    x = list(qkv.split(c, dim=-1))
    if cls:
        x += list(qkv_c.split(c, dim=-1))
    return x, g, gc


def flash_calls(fa, x, g, gc, heads, scale=0.125):
    """The kernel and plain callables of one K4 / K3 case: (forward under
    grad, forward without l, backward from l, plain forward, plain
    backward)."""
    if len(x) == 6:
        return (lambda: fa.flash_attention_cls_fwd(*x, heads, scale),
                lambda: fa.flash_attention_cls(*x, heads, scale),
                lambda l: fa.flash_attention_cls_bwd(*x, g, gc, l, heads, scale),
                lambda: fa.flash_attention_cls_fwd_plain(*x, heads, scale),
                lambda: fa.flash_attention_cls_bwd_plain(*x, g, gc, heads,
                                                         scale))
    return (lambda: fa.flash_attention_fwd(*x, heads, scale),
            lambda: (fa.flash_attention(*x, heads, scale),),
            lambda l: fa.flash_attention_bwd(*x, g, l, heads, scale),
            lambda: fa.flash_attention_fwd_plain(*x, heads, scale),
            lambda: fa.flash_attention_bwd_plain(*x, g, heads, scale))


def check_flash(torch, fa, name, x, g, gc, heads) -> tuple:
    """One K4 / K3 case against its plain version: the outputs (bf16
    ``FLASH_FWD_TOL``, fp32 ``FP32_TOL``), l (``ROWSUM_TOL``), the forward
    without l (bit for bit) and the gradients (bf16 ``MVIT_GRAD_TOL`` of
    each gradient's own scale, fp32 ``FP32_TOL`` scaled); returns the
    largest output and gradient errors."""
    fp32 = x[0].dtype == torch.float32
    fwd, fwd_no_l, bwd, plain_fwd, plain_bwd = flash_calls(fa, x, g, gc, heads)
    got, want = fwd(), plain_fwd()
    parts = ("out", "outc")[:len(got) - 1]
    ftol = FP32_TOL if fp32 else FLASH_FWD_TOL
    err_f = max(compare(torch, f"{name} {p}", a, r, ftol)
                for p, a, r in zip(parts, got, want))
    compare(torch, f"{name} l", got[-1], want[-1], ROWSUM_TOL)
    if not all(torch.equal(a, b) for a, b in zip(fwd_no_l(), got)):
        fail(f"{name}: the forward without l differs")
    grads = ("dq", "dk", "dv", "dqc", "dkc", "dvc")
    err_b = max(compare(torch, f"{name} {p}", a, r,
                        grad_tol(FP32_TOL, r) if fp32
                        else own_tol(MVIT_GRAD_TOL, r))
                for p, a, r in zip(grads, bwd(got[-1]), plain_bwd()))
    return err_f, err_b


def sdpa_operands(torch, x, g, gc, heads):
    """q, k, v, g as contiguous [B, H, L, d] with the CLS appended: SDPA's
    operands for the same function (while every logit stays below 80)."""
    def heads_first(t, tc):
        t = t if tc is None else torch.cat([t, tc], dim=1)
        b, n, c = t.shape
        return t.reshape(b, n, heads, c // heads).transpose(1, 2).contiguous()

    cls = x[3:] if len(x) == 6 else (None,) * 3
    return ([heads_first(t, tc) for t, tc in zip(x[:3], cls)]
            + [heads_first(g, gc)])


def flash_records(bt, L, c, labels, names, replaces, measured) -> list:
    """Prints the forward and backward lines of one bf16 attention pair over
    ``bt`` x ``L`` rows of width ``c`` (any head dim) and returns their two
    records. The bounds count each input read once and each output written
    once (q, k, v, o; q, k, v, g, dq, dk, dv): the row sums l the forward
    keeps for the backward are the kernel's own traffic, not the function's.
    ``measured`` holds (max_abs_err, ms, plain_ms, library_ms) for each."""
    e, pairs = 2, bt * L * L * c
    src = "procedurevrl_torch/csrc/flash_attention.cu"
    records = []
    for label, name, where, (err, ms, plain, lib), rows, flop, lib_name in zip(
            labels, names, replaces, measured, (4, 7), (4, 10),
            ("SDPA fwd", "SDPA bwd")):
        nb, fl = bt * L * rows * c * e, flop * pairs
        b_ms, b_by = bound_ms(nb, fl, BF16_FLOPS)
        print(f"{label} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"{lib_name} {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"{nb / 1e6:.1f} MB, {fl / 1e9:.2f} GFLOP)")
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": where, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib})
    return records


def phase_flash_kernels(torch, F, fa) -> list:
    """K4f / K4b and K3f / K3b against their plain versions at the slice 7
    shapes and small ones, timed beside SDPA; returns their records (the
    training shapes)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    heads, scale = 12, 0.125
    c = heads * 64
    f32, b16 = torch.float32, torch.bfloat16
    for dtype, n, cls, hot in ((f32, 130, False, True), (f32, 196, True, True),
                               (b16, 197, False, True), (b16, 196, True, True),
                               (b16, 130, False, False), (b16, 130, True, False),
                               (b16, 333, False, False), (b16, 333, True, False),
                               (b16, 1024, False, False),
                               (b16, 1024, True, False)):
        x, g, gc = flash_inputs(torch, gen, 2, n, heads, dtype, cls, hot)
        name = (f"{'K3' if cls else 'K4'} small {str(dtype)[6:]} N={n}"
                + (" logit > 80" if hot else ""))
        check_flash(torch, fa, name, x, g, gc, heads)

    records = []
    where = "procedurevrl_tpu/ops/pallas_attention.py:"
    e = 2
    for cls, n, tag, lines in ((False, 197, "K4", (177, 240)),
                               (True, 196, "K3", (354, 404))):
        bt, L = 2 * CLIPS_PER_SAMPLE * 8, n + cls
        x, g, gc = flash_inputs(torch, gen, bt, n, heads, b16, cls)
        err_f, err_b = check_flash(torch, fa, f"{tag} train bf16", x, g, gc,
                                   heads)
        fwd, _, bwd, plain_fwd, plain_bwd = flash_calls(fa, x, g, gc, heads)
        l = fwd()[-1]
        ms_f, ms_b = time_ms(torch, fwd), time_ms(torch, lambda: bwd(l))
        plain_f = time_ms(torch, plain_fwd, iters=5)
        plain_b = time_ms(torch, plain_bwd, iters=3)
        q, k, v, gy = sdpa_operands(torch, x, g, gc, heads)
        lib_f, lib_b = sdpa_ms(torch, F, q, k, v, gy)
        del q, k, v, gy
        names = ((fa.KERNEL_CLS, fa.KERNEL_CLS_BWD) if cls
                 else (fa.KERNEL, fa.KERNEL_BWD))
        shape = f"[{bt},{n},{c}]" + (" + CLS" if cls else "")
        records += flash_records(
            bt, L, c, (f"{tag}f {shape}", f"{tag}b {shape}"), names,
            [f"{where}{line}" for line in lines],
            ((err_f, ms_f, plain_f, lib_f), (err_b, ms_b, plain_b, lib_b)))
        del x, g, gc, l

    # K4f at the eval shape (16 views x 8 frames), without l
    bt = 8 * 16
    x, _, _ = flash_inputs(torch, gen, bt, 197, heads, b16, False)
    compare(torch, "K4 eval bf16 out", fa.flash_attention(*x, heads, scale),
            fa.flash_attention_plain(*x, heads, scale), FLASH_FWD_TOL)
    ms = time_ms(torch, lambda: fa.flash_attention(*x, heads, scale))
    plain = time_ms(torch, lambda: fa.flash_attention_plain(*x, heads, scale),
                    iters=5)
    q, k, v, _ = sdpa_operands(torch, x, x[0], None, heads)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
    nb, fl = bt * 197 * 4 * c * e, 4 * bt * heads * 197 * 197 * 64
    b_ms, b_by = bound_ms(nb, fl, BF16_FLOPS)
    print(f"K4f [{bt},197,{c}] bf16 (eval shape): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
          f"{nb / 1e6:.1f} MB, {fl / 1e9:.2f} GFLOP)")
    return records


def phase_k1_long(torch, F, k1, k2, k5, k8, fa, _build) -> list:
    """K1's long range: every K1 route at N + 1 = 257 and 1025 takes the
    pair (launch counts) and holds K1's function; the pair timed at
    N + 1 = 257 (the training batch); then one divided train step at a
    256^2 crop against the plain path, the spatial pass on the pair.
    Returns the pair's records in K1's layout, launches from that step."""
    from procedurevrl_torch.ops.attention_route import AttentionRoute

    gen = torch.Generator(device="cuda").manual_seed(21)
    heads, scale = 12, 0.125
    c = heads * 64
    routes = {"default": AttentionRoute(),
              "SPATIAL_DELTA=1": AttentionRoute(delta=True),
              "SPATIAL_SAVE_PROBS=0 SPATIAL_PIPE=1":
                  AttentionRoute(save_probs=False, pipe=True)}
    only_pair = dict.fromkeys(k1_kernel_names(k1), 0)
    only_pair.update({fa.KERNEL_QKV: 2, fa.KERNEL_QKV_BWD: 1})
    for n, bt in ((256, 2 * CLIPS_PER_SAMPLE * 8), (1024, 16)):
        qkv, qkv_c, g, gc = k1_inputs(torch, gen, bt, n, heads, torch.bfloat16)
        name = f"K1 long N+1={n + 1}"
        ro, roc, _ = fa.flash_attention_qkv_fwd_plain(qkv, qkv_c, heads, scale)
        rd = fa.flash_attention_qkv_bwd_plain(qkv, qkv_c, g, gc, heads, scale)
        for label, route in routes.items():
            _build.reset_launches()
            a, ac = (t.detach().clone().requires_grad_(True)
                     for t in (qkv, qkv_c))
            out, out_c = k1.spatial_attention_autograd(a, ac, heads, scale,
                                                       route)
            torch.autograd.backward((out, out_c), (g, gc))
            with torch.no_grad():
                o2, oc2 = k1.spatial_attention_autograd(qkv, qkv_c, heads,
                                                        scale, route)
            torch.cuda.synchronize()
            check_launches(dict(_build.LAUNCHES), only_pair,
                           f"{name} on the {label} route")
            if not (torch.equal(o2, out) and torch.equal(oc2, out_c)):
                fail(f"{name} {label}: the forward without grad differs")
            err_f = max(compare(torch, f"{name} {label} out", out, ro,
                                FLASH_FWD_TOL),
                        compare(torch, f"{name} {label} out_c", out_c, roc,
                                FLASH_FWD_TOL))
            err_b = max(compare(torch, f"{name} {label} {p}", t.grad, r,
                                own_tol(MVIT_GRAD_TOL, r))
                        for p, t, r in zip(("dqkv", "dqkv_c"), (a, ac), rd))
        del a, ac, out, out_c, o2, oc2, ro, roc, rd
        # K1's own plain versions, which round e / l, at 0.5 N(0, 1)
        half = [0.5 * t for t in (qkv, qkv_c)]
        with torch.no_grad():
            o, oc = k1.spatial_attention_autograd(*half, heads, scale)
        for p, a, r in zip(("out", "out_c"), (o, oc),
                           k1.spatial_attention_plain(*half, heads, scale)):
            compare(torch, f"{name} {p} vs K1f plain", a, r, K1K2_FWD_TOL)
        l = fa.flash_attention_qkv_fwd(*half, heads, scale)[2]
        for p, a, r in zip(("dqkv", "dqkv_c"),
                           fa.flash_attention_qkv_bwd(*half, g, gc, l, heads,
                                                      scale),
                           k1.spatial_attention_bwd_recompute_plain(
                               *half, g, gc, heads, scale)):
            compare(torch, f"{name} {p} vs K1br plain", a, r,
                    own_tol(MVIT_GRAD_TOL, r))
        if n == 256:
            L = n + 1
            l = fa.flash_attention_qkv_fwd(qkv, qkv_c, heads, scale)[2]
            ms_f = time_ms(torch, lambda: fa.flash_attention_qkv_fwd(
                qkv, qkv_c, heads, scale))
            ms_b = time_ms(torch, lambda: fa.flash_attention_qkv_bwd(
                qkv, qkv_c, g, gc, l, heads, scale))
            plain_f = time_ms(torch, lambda: fa.flash_attention_qkv_fwd_plain(
                qkv, qkv_c, heads, scale), iters=5)
            plain_b = time_ms(torch, lambda: fa.flash_attention_qkv_bwd_plain(
                qkv, qkv_c, g, gc, heads, scale), iters=3)
            x = torch.cat([qkv, qkv_c], dim=1).view(bt, L, 3, heads, 64)
            q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
            gy = torch.cat([g, gc], dim=1).view(bt, L, heads, 64).transpose(1, 2)
            lib_f, lib_b = sdpa_ms(torch, F, q, k, v, gy.contiguous())
            del x, q, k, v, gy
            shape = f"[{bt},{n},{3 * c}]"
            records = flash_records(
                bt, L, c, (f"K1 long fwd {shape}", f"K1 long bwd {shape}"),
                (fa.KERNEL_QKV, fa.KERNEL_QKV_BWD),
                ("procedurevrl_tpu/ops/pallas_attention.py:536",
                 "procedurevrl_tpu/ops/pallas_attention.py:586"),
                ((err_f, ms_f, plain_f, lib_f), (err_b, ms_b, plain_b, lib_b)))
        del qkv, qkv_c, g, gc, half

    # one divided train step at a 256^2 crop (N + 1 = 257), remat
    cfg = train_cfg(True, "DATA.TRAIN_CROP_SIZE", "256")
    _build.reset_launches()
    step_vs_plain(torch, cfg, k1, k2, k5, k8)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    expected = dict.fromkeys(k1k2_kernels(k1, k2), 0)
    expected.update({fa.KERNEL_QKV: DEPTH, fa.KERNEL_QKV_BWD: DEPTH,
                     k2.KERNEL: DEPTH, k2.KERNEL_BWD: DEPTH})
    check_launches(launches, expected, "the divided step at crop 256")
    print(f"divided train step at crop 256: launches {launches}")
    for rec in records:
        rec["launches"] = launches.get(rec["name"], 0)
    return records


@contextlib.contextmanager
def timesformer_heads(heads: int):
    """TimeSformer-B built with ``heads`` heads of the same width: the
    model class ``models/build.py`` constructs, with its head count
    replaced."""
    from procedurevrl_torch.models import procedurevrl

    cls = procedurevrl.ProcedureVRL
    procedurevrl.ProcedureVRL = lambda *a, **kw: cls(*a, **{**kw,
                                                           "num_heads": heads})
    try:
        yield
    finally:
        procedurevrl.ProcedureVRL = cls


def check_ts_heads_32(torch, F, fa) -> list:
    """The pair at head dim 32 on the shapes of phase 25's step (18 clips x
    8 frames, width 768 in 24 heads): K2's function on the time-major qkv
    [18, 8, 196, 2304] and K1's on the fused qkv [144, 196, 2304] + CLS,
    against their plain versions; returns the records of K2's function on
    the pair, timed."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    heads, scale, c = TS_HEADS_32, 32 ** -0.5, 768
    b16 = torch.bfloat16
    b, t, n = 2 * CLIPS_PER_SAMPLE, 8, 196

    qkv, qkv_c, g, gc = k1_inputs(torch, gen, b * t, n, heads, b16, d=32)
    name = f"K1 on the pair d 32 [{b * t},{n},{3 * c}]"
    out, out_c, l = fa.flash_attention_qkv_fwd(qkv, qkv_c, heads, scale)
    ro, roc, rl = fa.flash_attention_qkv_fwd_plain(qkv, qkv_c, heads, scale)
    for p, a, r, tol in (("out", out, ro, FLASH_FWD_TOL),
                         ("out_c", out_c, roc, FLASH_FWD_TOL),
                         ("l", l, rl, ROWSUM_TOL)):
        compare(torch, f"{name} {p}", a, r, tol)
    for p, a, r in zip(("dqkv", "dqkv_c"),
                       fa.flash_attention_qkv_bwd(qkv, qkv_c, g, gc, l, heads,
                                                  scale),
                       fa.flash_attention_qkv_bwd_plain(qkv, qkv_c, g, gc,
                                                        heads, scale)):
        compare(torch, f"{name} {p}", a, r, own_tol(MVIT_GRAD_TOL, r))
    del qkv, qkv_c, g, gc, out, out_c, l, ro, roc, rl

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(b16)

    qkv, g = rand(b, t, n, 3 * c), rand(b, t, n, c)
    name = f"K2 on the pair d 32 [{b},{t},{n},{3 * c}]"
    fwd = lambda: fa.flash_attention_temporal_fwd(qkv, heads, scale)
    out, l = fwd()
    ro, rl = fa.flash_attention_temporal_fwd_plain(qkv, heads, scale)
    # N(0, 1) inputs over 8 keys: p rounded to bf16 moves an output by up
    # to ~ulp(p) |v|, as for K2f, which phase 3 holds to BF16_TOL here
    err_f = compare(torch, f"{name} out", out, ro, BF16_TOL)
    compare(torch, f"{name} l", l, rl, ROWSUM_TOL)
    bwd = lambda: fa.flash_attention_temporal_bwd(qkv, g, l, heads, scale)
    ref = fa.flash_attention_temporal_bwd_plain(qkv, g, heads, scale)
    err_b = compare(torch, f"{name} dqkv", bwd(), ref,
                    own_tol(MVIT_GRAD_TOL, ref))
    del out, ro, rl, ref
    ms_f, ms_b = time_ms(torch, fwd), time_ms(torch, bwd)
    plain_f = time_ms(torch, lambda: fa.flash_attention_temporal_fwd_plain(
        qkv, heads, scale), iters=5)
    plain_b = time_ms(torch, lambda: fa.flash_attention_temporal_bwd_plain(
        qkv, g, heads, scale), iters=3)
    # SDPA on [B*N, H, T, 32]
    seq = lambda x: x.permute(0, 2, 1, 3).reshape(b * n, t, heads, -1
                                                   ).transpose(1, 2)
    q, k, v = (seq(x).contiguous() for x in qkv.split(c, dim=-1))
    lib_f, lib_b = sdpa_ms(torch, F, q, k, v, seq(g).contiguous())
    del q, k, v
    where = "procedurevrl_tpu/ops/pallas_attention.py:"
    return flash_records(
        b * n, t, c, (f"K2 on the pair fwd [{b},{t},{n},{3 * c}] d 32",
                      f"K2 on the pair bwd [{b},{t},{n},{3 * c}] d 32"),
        (fa.KERNEL_T, fa.KERNEL_T_BWD), (f"{where}1486", f"{where}1512"),
        ((err_f, ms_f, plain_f, lib_f), (err_b, ms_b, plain_b, lib_b)))


def phase_ts_heads_32(torch, F, k1, k2, k5, k8, fa, _build) -> list:
    """Slice 8: the pair at head dim 32 against its plain versions
    (:func:`check_ts_heads_32`), then the TimeSformer-B train step at width
    768 in 24 heads of 32 (remat): K1's and K2's function on the pair (per
    step 24 + 12 of each, no K1 or K2 kernel), one step against the plain
    path; returns the records of K2's function on the pair with their
    launches."""
    records = check_ts_heads_32(torch, F, fa)
    with timesformer_heads(TS_HEADS_32):
        launches = phase_ts_knob_train(
            torch, k1, k2, k5, k8, _build, "TimeSformer 24 heads of 32", {},
            {fa.KERNEL_QKV: DEPTH, fa.KERNEL_QKV_BWD: DEPTH,
             fa.KERNEL_T: DEPTH, fa.KERNEL_T_BWD: DEPTH}, False, (),
            HEAD_DIM_STEPS)
    for rec in records:
        rec["launches"] = launches.get(rec["name"], 0)
    return records


# MViT-v2-S blocks 0 (head-last, K5) and 1 (head-split, K6) at width 144 in
# 2 heads of 72: (label, head-last, batch, heads, qN, k_shape)
MVIT_D72_BLOCKS = (("block 0", True, 18, 2, 25088, (8, 7, 7)),
                   ("block 1", False, 72, 1, 6272, (8, 14, 14)))


def check_mvit_d72(torch, k5) -> None:
    """K5f/K5b and K6f/K6b at head dim 72 (tile width 96) on the shapes of
    phase 26's step, against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    scale = 72 ** -0.5
    for label, head_last, b, heads, qn, k_shape in MVIT_D72_BLOCKS:
        if head_last:
            fwd, fwd_plain = k5.mvit_attention_hl_fwd, k5.mvit_attention_hl_fwd_plain
            bwd, bwd_plain = k5.mvit_attention_hl_bwd, k5.mvit_attention_hl_bwd_plain
            hs = (heads,)
        else:
            fwd, fwd_plain = k5.mvit_attention_fwd, k5.mvit_attention_fwd_plain
            bwd, bwd_plain = k5.mvit_attention_bwd, k5.mvit_attention_bwd_plain
            hs = ()
        tag = f"K{5 if head_last else 6}"
        x = mvit_inputs(torch, gen, b, heads, qn, k_shape, torch.bfloat16,
                        d=72)
        args = (*x[:6], k_shape, *hs, scale)
        out, rowsum = fwd(*args)
        ref, ref_rs = fwd_plain(*args)
        name = f"{tag} d 72 {label} [{b},{qn},{heads * 72}]"
        compare(torch, f"{name} out", out, ref, MVIT_FWD_TOL)
        compare(torch, f"{name} rowsum", rowsum, ref_rs, ROWSUM_TOL)
        bargs = (*x[:6], ref_rs, x[6], k_shape, *hs, scale)
        for p, a, r in zip(("dq", "dk", "dv", "dkc", "dvc", "drel"),
                           bwd(*bargs), bwd_plain(*bargs)):
            compare(torch, f"{name} {p}", a, r, own_tol(MVIT_GRAD_TOL, r))
        del x, out, ref
        torch.cuda.empty_cache()


def phase_mvit_d72(torch, k1, k2, k5, k8, _build) -> dict:
    """Slice 8: K5 and K6 at head dim 72 against their plain versions
    (:func:`check_mvit_d72`), then MViT-v2-S's block plan at width 144 in 2
    heads of 72 (remat): every block on K5 or K6 (one forward and one
    backward a step), no other MViT kernel; one step against the plain
    path."""
    check_mvit_d72(torch, k5)
    cfg = mvit_cfg(MVIT_CFG, *MVIT_D72)
    stats, launches, peak = run_train(torch, _build, cfg, HEAD_DIM_STEPS)
    for i, h in enumerate(stats["history"]):
        print(f"MViT d 72 step {i + 1}: loss {h['loss']:.6f} grad_norm "
              f"{h['grad_norm']:.4f}")
        if not all(math.isfinite(h[k]) for k in ("loss", "kl", "mse",
                                                 "grad_norm")):
            fail(f"MViT d 72 step {i + 1} is not finite")
    print(f"MViT d 72 (remat): {stats['clips_per_step']} clips/step, peak "
          f"memory {peak / 2 ** 30:.3f} GiB, launches {launches}")
    n = HEAD_DIM_STEPS
    fwd = launches.get(k5.KERNEL_HL, 0) + launches.get(k5.KERNEL, 0)
    bwd = launches.get(k5.KERNEL_HL_BWD, 0) + launches.get(k5.KERNEL_BWD, 0)
    if fwd != MVIT_BLOCKS * n or bwd != MVIT_BLOCKS * n:
        fail(f"MViT d 72: {fwd} K5f/K6f and {bwd} K5b/K6b launches, "
             f"expected {MVIT_BLOCKS * n} and {MVIT_BLOCKS * n}")
    others = set(mvit_kernel_names(k5, k8)) - {
        k5.KERNEL_HL, k5.KERNEL, k5.KERNEL_HL_BWD, k5.KERNEL_BWD}
    check_launches(launches, dict.fromkeys(others, 0), "the MViT d 72 steps")
    step_vs_plain(torch, cfg, k1, k2, k5, k8)
    return launches


# Phase 27's head dims: the pair's (d, heads), admitted by JAX's
# _heads_per_block, and the MViT kernels' d; MViT-v2-S blocks 0 (head-last,
# K5) and 1 (head-split, K6) at 2 clips: (label, head-last, batch, heads,
# qN, k_shape)
PAIR_ODD = ((12, 32), (320, 2))
MVIT_ODD = (20, 136)
MVIT_ODD_BLOCKS = (("block 0", True, 2, 1, 25088, (8, 7, 7)),
                   ("block 1", False, 2, 1, 6272, (8, 14, 14)))


def check_pair_odd(torch, fa) -> None:
    """The pair at d = 12 in 32 heads and d = 320 in 2 heads (its scalar
    kernels; d = 320 in column groups of 256 and 64) on its four callers,
    forward and backward against the plain versions, bf16 and float32."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    for (d, heads), dtype in itertools.product(PAIR_ODD, (torch.bfloat16,
                                                         torch.float32)):
        c, scale = heads * d, d ** -0.5
        fp32 = dtype == torch.float32
        ftol = FP32_TOL if fp32 else FLASH_FWD_TOL

        def gtol(ref):
            return grad_tol(FP32_TOL, ref) if fp32 else own_tol(MVIT_GRAD_TOL,
                                                                 ref)

        def r(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        tag = f"pair d {d} x {heads} {str(dtype)[6:]}"
        qkv, qkv_c, g, gc = r(16, 196, 3 * c), r(16, 1, 3 * c), r(16, 196, c), r(16, 1, c)
        x, xc = list(qkv.split(c, dim=-1)), list(qkv_c.split(c, dim=-1))
        for name, cls in (("K4", False), ("K3", True)):
            fwd, _, bwd, plain_fwd, plain_bwd = flash_calls(
                fa, x + xc if cls else x, g, gc, heads, scale)
            got, want = fwd(), plain_fwd()
            for p, a, ref in zip(("out", "outc"), got[:-1], want[:-1]):
                compare(torch, f"{tag} {name} {p}", a, ref, ftol)
            compare(torch, f"{tag} {name} l", got[-1], want[-1], ROWSUM_TOL)
            for p, a, ref in zip(("dq", "dk", "dv", "dqc", "dkc", "dvc"),
                                 bwd(got[-1]), plain_bwd()):
                compare(torch, f"{tag} {name} {p}", a, ref, gtol(ref))
        out, out_c, l = fa.flash_attention_qkv_fwd(qkv, qkv_c, heads, scale)
        want = fa.flash_attention_qkv_fwd_plain(qkv, qkv_c, heads, scale)
        for p, a, ref, tol in zip(("out", "out_c", "l"), (out, out_c, l), want,
                                  (ftol, ftol, ROWSUM_TOL)):
            compare(torch, f"{tag} K1 {p}", a, ref, tol)
        for p, a, ref in zip(("dqkv", "dqkv_c"),
                             fa.flash_attention_qkv_bwd(qkv, qkv_c, g, gc, l,
                                                        heads, scale),
                             fa.flash_attention_qkv_bwd_plain(qkv, qkv_c, g,
                                                              gc, heads, scale)):
            compare(torch, f"{tag} K1 {p}", a, ref, gtol(ref))
        qkv, g = r(2, 8, 196, 3 * c), r(2, 8, 196, c)
        out, l = fa.flash_attention_temporal_fwd(qkv, heads, scale)
        ro, rl = fa.flash_attention_temporal_fwd_plain(qkv, heads, scale)
        compare(torch, f"{tag} K2 out", out, ro, FP32_TOL if fp32 else BF16_TOL)
        compare(torch, f"{tag} K2 l", l, rl, ROWSUM_TOL)
        ref = fa.flash_attention_temporal_bwd_plain(qkv, g, heads, scale)
        compare(torch, f"{tag} K2 dqkv",
                fa.flash_attention_temporal_bwd(qkv, g, l, heads, scale), ref,
                gtol(ref))
        del qkv, qkv_c, g, gc, x, xc


def check_mvit_odd(torch, k5) -> None:
    """K5f/K5b, K6f/K6b, K6sp/K6bs and K7f/K7b at d = 20 and 136 (the scalar
    kernels; d = 136 in column groups of 128 and 8) on MViT-v2-S's block 0
    and 1 token counts, against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(127)
    for d, (label, head_last, b, heads, qn, k_shape) in itertools.product(
            MVIT_ODD, MVIT_ODD_BLOCKS):
        scale = d ** -0.5
        x = mvit_inputs(torch, gen, b, heads, qn, k_shape, torch.bfloat16, d=d)
        tag = f"MViT d {d} {label} [{b},{qn},{heads * d}]"
        if head_last:
            fwd, fwd_plain = k5.mvit_attention_hl_fwd, k5.mvit_attention_hl_fwd_plain
            bwd, bwd_plain = k5.mvit_attention_hl_bwd, k5.mvit_attention_hl_bwd_plain
            hs = (heads,)
        else:
            fwd, fwd_plain = k5.mvit_attention_fwd, k5.mvit_attention_fwd_plain
            bwd, bwd_plain = k5.mvit_attention_bwd, k5.mvit_attention_bwd_plain
            hs = ()
        args = (*x[:6], k_shape, *hs, scale)
        out, rs = fwd(*args)
        ref, ref_rs = fwd_plain(*args)
        compare(torch, f"{tag} out", out, ref, MVIT_FWD_TOL)
        compare(torch, f"{tag} rowsum", rs, ref_rs, ROWSUM_TOL)
        bargs = (*x[:6], ref_rs, x[6], k_shape, *hs, scale)
        for p, a, r in zip(("dq", "dk", "dv", "dkc", "dvc", "drel"),
                           bwd(*bargs), bwd_plain(*bargs)):
            compare(torch, f"{tag} {p}", a, r, own_tol(MVIT_GRAD_TOL, r))
        if head_last:  # K7 takes the head-last layout
            out, lse = k5.mvit_attention_kt_fwd(*x[:6], k_shape, heads, scale)
            ref, ref_lse = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape,
                                                          heads, scale)
            compare(torch, f"{tag} K7f out", out, ref, MVIT_FWD_TOL)
            compare(torch, f"{tag} K7f lse", lse, ref_lse, LSE_TOL)
            kargs = (*x[:6], ref, ref_lse, x[6], k_shape, heads, scale)
            for p, a, r in zip(("dq", "dk", "dv", "dkc", "dvc", "drel"),
                               k5.mvit_attention_kt_bwd(*kargs),
                               k5.mvit_attention_kt_bwd_rounded_plain(*kargs)):
                compare(torch, f"{tag} K7b {p}", a, r, own_tol(MVIT_GRAD_TOL, r))
        else:  # K6sp / K6bs take the head-split layout
            out, _, p = k5.mvit_attention_fwd_probs(*x[:6], k_shape, scale)
            ref, _, ref_p = k5.mvit_attention_fwd_probs_plain(*x[:6], k_shape,
                                                              scale)
            compare(torch, f"{tag} K6sp out", out, ref, MVIT_FWD_TOL)
            compare(torch, f"{tag} K6sp probs", p, ref_p, PROBS_TOL)
            pargs = (*x[:6], ref_p, x[6], k_shape, scale)
            for q, a, r in zip(("dq", "dk", "dv", "dkc", "dvc", "drel"),
                               k5.mvit_attention_bwd_probs(*pargs),
                               k5.mvit_attention_bwd_probs_plain(*pargs)):
                compare(torch, f"{tag} K6bs {q}", a, r, own_tol(MVIT_GRAD_TOL, r))
        del x, out, ref
        torch.cuda.empty_cache()


def phase_odd_head_dims(torch, fa, k5) -> None:
    """Slice 9: the head dims the tensor-core kernels do not take, on the
    pair (:func:`check_pair_odd`) and the MViT kernels
    (:func:`check_mvit_odd`)."""
    check_pair_odd(torch, fa)
    check_mvit_odd(torch, k5)


def aim_rows(torch, gen, q, k, scale, targets):
    """q [G, Lq, d] with its rows aimed at the keys k [G, Lk, d]: row i
    takes targets[i % len(targets)] (None: kept); an aimed row is k_a +
    0.95 k_b for two random keys, scaled so that its largest logit (q.k)
    scale is the target (to the rounding of q's dtype): the top two logits
    of the row lie ~5 % apart, so the clamp saturates both past 80 and a
    row max or no shift weighs them apart."""
    g, lq, d = q.shape
    lk = k.shape[1]
    kf = k.float()
    a = torch.randint(0, lk, (g, lq), generator=gen, device=q.device)
    b = (a + torch.randint(1, lk, (g, lq), generator=gen,
                           device=q.device)) % lk
    pick = lambda i: torch.gather(kf, 1, i[..., None].expand(g, lq, d))
    rows = pick(a) + 0.95 * pick(b)
    top = torch.einsum("gid,gjd->gij", rows, kf).amax(-1) * scale
    t = torch.tensor([0.0 if x is None else x for x in targets],
                     device=q.device)
    t = t[torch.arange(lq, device=q.device) % len(targets)]
    aimed = (rows * (t / top)[..., None]).to(q.dtype)
    return torch.where((t > 0)[None, :, None], aimed, q)


def finite_rows(torch, got, ref, width: int):
    """Under the ``none`` shift: the rows (of ``width`` elements) that are
    non-finite in the plain version ``ref`` must be exactly the kernel's
    non-finite rows; then both without those rows (the rows of (80, 88)
    and the small ones), else both whole, which the comparison rejects.
    Also returns the count of non-finite rows."""
    torch.cuda.synchronize()
    g2, r2 = got.float().reshape(-1, width), ref.float().reshape(-1, width)
    bad = ~torch.isfinite(r2).all(1)
    if not torch.equal(bad, ~torch.isfinite(g2).all(1)):
        return g2, r2, -1
    return g2[~bad], r2[~bad], int(bad.sum())


def same_bits(torch, a, b) -> bool:
    """Whether a and b are the same bits (NaNs included)."""
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(bits),
                                              b.contiguous().view(bits))


def shift_pair(torch, shift, name, got, ref, tol, width):
    """One comparison (name, got, want, tol) of a variant's output under
    ``shift``: under ``none`` through :func:`finite_rows`."""
    if shift != "none":
        return (name, got, ref, tol)
    g2, r2, bad = finite_rows(torch, got, ref, width)
    note = "rows non-finite in one only" if bad < 0 else (
        f"{bad} overflowing rows non-finite in both")
    return (f"{name} ({note})", g2, r2, tol)


def k1_shift_inputs(torch, gen, bt, n, heads, dtype, targets, d=64):
    """qkv [BT, N, 3C], qkv_c [BT, 1, 3C] (0.5 N(0, 1), the queries of
    [patches; CLS] aimed by :func:`aim_rows`), g, gc."""
    c = heads * d
    r = lambda *s: (0.5 * torch.randn(*s, generator=gen, device="cuda")
                    ).to(dtype)
    x = r(bt, n + 1, 3, heads, d)
    split = lambda i: x[:, :, i].permute(0, 2, 1, 3).reshape(-1, n + 1, d)
    q = aim_rows(torch, gen, split(0), split(1), d ** -0.5, targets)
    x[:, :, 0] = q.view(bt, heads, n + 1, d).permute(0, 2, 1, 3)
    x = x.reshape(bt, n + 1, 3 * c)
    return (x[:, :n].contiguous(), x[:, n:].contiguous(), r(bt, n, c),
            r(bt, 1, c))


def k1_shift_checks(torch, gen, k1, shift, dtype, bt, n):
    """K1f, K1sp, K1p and K1br under ``shift`` at [BT, N] + CLS, 12 heads
    of 64, against their plain versions; returns (comparisons, bit-for-bit
    pairs): K1sp's outputs K1f's, K1p's K1f's (bf16), K1br K1b's on K1sp's
    p."""
    heads, scale = 12, 0.125
    fp32 = dtype == torch.float32
    ftol, ptol = (FP32_TOL, FP32_TOL) if fp32 else (BF16_TOL, K1K2_FWD_TOL)
    gtol = FP32_TOL if fp32 else BF16_TOL
    label = f"K1 {str(dtype)[6:]} [{bt},{n}] {shift}"
    qkv, qkv_c, _, _ = k1_shift_inputs(torch, gen, bt, n, heads, dtype,
                                       HOT_TARGETS)
    f, fc = k1.spatial_attention(qkv, qkv_c, heads, scale, shift)
    rf, rfc = k1.spatial_attention_plain(qkv, qkv_c, heads, scale, shift)
    o, oc, p = k1.spatial_attention_fwd_probs(qkv, qkv_c, heads, scale, shift)
    _, _, rp = k1.spatial_attention_fwd_probs_plain(qkv, qkv_c, heads, scale,
                                                    shift)
    po, poc = k1.spatial_attention_pipe(qkv, qkv_c, heads, scale, 3, shift)
    pairs = [shift_pair(torch, shift, f"{label} K1f frames", f, rf, ftol, 64),
             shift_pair(torch, shift, f"{label} K1f cls", fc, rfc, ftol, 64),
             shift_pair(torch, shift, f"{label} K1sp probs", p, rp, ptol,
                        p.shape[-1]),
             shift_pair(torch, shift, f"{label} K1p frames", po, rf, ftol, 64)]
    twins = [(f"{label} K1sp out == K1f out", (o, oc), (f, fc))]
    if not fp32:
        twins.append((f"{label} K1p == K1f", (po, poc), (f, fc)))
    # the backward: under none from rows that do not overflow
    qkv, qkv_c, g, gc = k1_shift_inputs(
        torch, gen, bt, n, heads, dtype,
        COOL_TARGETS if shift == "none" else HOT_TARGETS)
    dx, dxc = k1.spatial_attention_bwd_recompute(qkv, qkv_c, g, gc, heads,
                                                 scale, shift)
    rdx, rdxc = k1.spatial_attention_bwd_recompute_plain(qkv, qkv_c, g, gc,
                                                         heads, scale, shift)
    pairs += [(f"{label} K1br dqkv", dx, rdx, grad_tol(gtol, rdx)),
              (f"{label} K1br dqkv_c", dxc, rdxc, grad_tol(gtol, rdxc))]
    _, _, p = k1.spatial_attention_fwd_probs(qkv, qkv_c, heads, scale, shift)
    twins.append((f"{label} K1br == K1b(K1sp p)", (dx, dxc),
                  k1.spatial_attention_bwd(qkv, qkv_c, p, g, gc, heads,
                                           scale)))
    return pairs, twins


def k2_shift_inputs(torch, gen, b, t, n, heads, dtype, targets, d=64):
    """The time-major qkv [B, T, N, 3C] (0.5 N(0, 1), the query rows
    aimed) and g."""
    r = lambda *s: (0.5 * torch.randn(*s, generator=gen, device="cuda")
                    ).to(dtype)
    x = r(b, t, n, 3, heads, d)
    split = lambda i: x[:, :, :, i].permute(0, 2, 3, 1, 4).reshape(-1, t, d)
    q = aim_rows(torch, gen, split(0), split(1), d ** -0.5, targets)
    x[:, :, :, 0] = q.view(b, n, heads, t, d).permute(0, 3, 1, 2, 4)
    return x.reshape(b, t, n, 3 * heads * d).contiguous(), r(b, t, n,
                                                            heads * d)


def k2_shift_checks(torch, gen, k2, shift, dtype, b, t, n):
    """K2f, K2v3f and K2b under ``shift`` against their plain versions;
    bit for bit (bf16): K2f K2v3f's output, K2b K2v3b's fed K2v3f's p."""
    heads, scale = 12, 0.125
    fp32 = dtype == torch.float32
    ftol, ptol = (FP32_TOL, FP32_TOL) if fp32 else (BF16_TOL, K1K2_FWD_TOL)
    gtol = FP32_TOL if fp32 else BF16_TOL
    label = f"K2 {str(dtype)[6:]} [{b},{t},{n}] {shift}"
    qkv, _ = k2_shift_inputs(torch, gen, b, t, n, heads, dtype, HOT_TARGETS)
    f = k2.temporal_attention(qkv, heads, scale, shift)
    o3, p3 = k2.temporal_attention_v3(qkv, heads, scale, shift=shift)
    rf, rp = k2.temporal_attention_v3_fwd_plain(qkv, heads, scale, shift)
    pairs = [shift_pair(torch, shift, f"{label} K2f", f, rf, ftol, 64),
             shift_pair(torch, shift, f"{label} K2v3f probs", p3, rp, ptol,
                        t)]
    twins = [] if fp32 else [(f"{label} K2f == K2v3f", (f,), (o3,))]
    qkv, g = k2_shift_inputs(torch, gen, b, t, n, heads, dtype,
                             COOL_TARGETS if shift == "none" else HOT_TARGETS)
    dx = k2.temporal_attention_bwd(qkv, g, heads, scale, shift)
    rdx = k2.temporal_attention_bwd_plain(qkv, g, heads, scale, shift)
    pairs.append((f"{label} K2b", dx, rdx, grad_tol(gtol, rdx)))
    if not fp32:
        _, p3 = k2.temporal_attention_v3(qkv, heads, scale, shift=shift)
        twins.append((f"{label} K2b == K2v3b(K2v3f p)", (dx,),
                      (k2.temporal_attention_v3_bwd(qkv, p3, g, heads,
                                                    scale),)))
    return pairs, twins


def pair_shift_checks(torch, gen, fa, shift, dtype, b, n, cls):
    """K4 (``cls`` False) or K3 under ``shift`` at [B, N, 768] (+ CLS), 12
    heads of 64: out and the row statistic (l, lse under max), and the
    gradients, against the plain versions."""
    heads, scale = 12, 0.125
    fp32 = dtype == torch.float32
    label = f"{'K3' if cls else 'K4'} {str(dtype)[6:]} [{b},{n}] {shift}"
    pairs = []
    for part, targets in (("fwd", HOT_TARGETS), ("bwd", COOL_TARGETS
                                                  if shift == "none"
                                                  else HOT_TARGETS)):
        x, g, gc = flash_inputs(torch, gen, b, n, heads, dtype, cls, sd=0.5)
        seq = lambda t: t.reshape(b, -1, heads, 64).transpose(1, 2).reshape(
            b * heads, -1, 64)
        cat = (lambda i: torch.cat([x[i], x[i + 3]], 1)) if cls else (
            lambda i: x[i])
        q = aim_rows(torch, gen, seq(cat(0)), seq(cat(1)), scale, targets)
        q = q.reshape(b, heads, -1, 64).transpose(1, 2).reshape(b, n + cls,
                                                                 -1)
        x[0].copy_(q[:, :n])
        if cls:
            x[3].copy_(q[:, n:])
        if part == "fwd":
            fwd = (fa.flash_attention_cls_fwd if cls
                   else fa.flash_attention_fwd)
            got = fwd(*x, heads, scale, shift)
            want = (fa.flash_attention_cls_fwd_plain if cls
                    else fa.flash_attention_fwd_plain)(*x, heads, scale, shift)
            names = ("out", "outc")[:len(got) - 1] + ("stat",)
            for p, a, r in zip(names, got, want):
                tol = ROWSUM_TOL if p == "stat" else (
                    FP32_TOL if fp32 else BF16_TOL)
                pairs.append(shift_pair(torch, shift, f"{label} {p}", a, r,
                                        tol, 1 if p == "stat" else 64))
            continue
        l = (fa.flash_attention_cls_fwd_plain if cls
             else fa.flash_attention_fwd_plain)(*x, heads, scale, shift)[-1]
        if cls:
            got = fa.flash_attention_cls_bwd(*x, g, gc, l, heads, scale, shift)
            want = fa.flash_attention_cls_bwd_plain(*x, g, gc, heads, scale,
                                                    shift)
        else:
            got = fa.flash_attention_bwd(*x, g, l, heads, scale, shift)
            want = fa.flash_attention_bwd_plain(*x, g, heads, scale, shift)
        for p, a, r in zip(("dq", "dk", "dv", "dqc", "dkc", "dvc"), got, want):
            pairs.append((f"{label} {p}", a, r,
                          grad_tol(FP32_TOL if fp32 else BF16_TOL, r)))
    return pairs


def pair_layout_checks(torch, gen, fa, shift):
    """The pair's other layouts under ``shift``, bf16: K1's long range (the
    fused qkv at N + 1 = 257: the query-major and key-major backward) and
    K2's function at head dim 32 (the time-major qkv, 16 sequences packed
    to a slice)."""
    pairs = []
    targets = COOL_TARGETS if shift == "none" else HOT_TARGETS
    qkv, qkv_c, g, gc = k1_shift_inputs(torch, gen, 2, 256, 12, torch.bfloat16,
                                        targets)
    got = fa.flash_attention_qkv_fwd(qkv, qkv_c, 12, 0.125, shift=shift)
    want = fa.flash_attention_qkv_fwd_plain(qkv, qkv_c, 12, 0.125, shift)
    label = f"K1 long bf16 [2,256] {shift}"
    pairs += [(f"{label} out", got[0], want[0], BF16_TOL),
              (f"{label} out_c", got[1], want[1], BF16_TOL),
              (f"{label} stat", got[2], want[2], ROWSUM_TOL)]
    dx = fa.flash_attention_qkv_bwd(qkv, qkv_c, g, gc, want[2], 12, 0.125,
                                    shift)
    rdx = fa.flash_attention_qkv_bwd_plain(qkv, qkv_c, g, gc, 12, 0.125,
                                           shift)
    pairs += [(f"{label} dqkv", dx[0], rdx[0], grad_tol(BF16_TOL, rdx[0])),
              (f"{label} dqkv_c", dx[1], rdx[1], grad_tol(BF16_TOL, rdx[1]))]
    scale = 32 ** -0.5
    qkv, g = k2_shift_inputs(torch, gen, 2, 8, 49, 24, torch.bfloat16,
                             targets, d=32)
    out, l = fa.flash_attention_temporal_fwd(qkv, 24, scale, shift=shift)
    rout, rl = fa.flash_attention_temporal_fwd_plain(qkv, 24, scale, shift)
    dx = fa.flash_attention_temporal_bwd(qkv, g, rl, 24, scale, shift)
    rdx = fa.flash_attention_temporal_bwd_plain(qkv, g, 24, scale, shift)
    label = f"K2 on the pair d 32 bf16 [2,8,49] {shift}"
    return pairs + [(f"{label} out", out, rout, BF16_TOL),
                    (f"{label} stat", l, rl, ROWSUM_TOL),
                    (f"{label} dqkv", dx, rdx, grad_tol(BF16_TOL, rdx))]


def mvit_shift_inputs(torch, gen, b, heads, qn, k_shape, dtype, targets,
                      d=96):
    """:func:`mvit_inputs` with the query rows aimed at [body; cls]."""
    x = mvit_inputs(torch, gen, b, heads, qn, k_shape, dtype, d=d)
    seq = lambda t: t.reshape(b, t.shape[1], heads, d).transpose(1, 2).reshape(
        b * heads, t.shape[1], d)
    q = aim_rows(torch, gen, seq(x[0]), seq(torch.cat([x[1], x[3]], 1)),
                 d ** -0.5, targets)
    x[0] = q.reshape(b, heads, qn, d).transpose(1, 2).reshape(b, qn,
                                                              heads * d)
    return x


def mvit_shift_checks(torch, gen, k5, shift, dtype, label, head_last, b,
                      heads, qn, k_shape, saved=False):
    """K5f / K6f (``saved``: K6sp, out, statistic and p) under ``shift``
    against the plain versions, and the backward (under max K5b / K6b's
    ``kRowMax`` from the forward's lse and output; under none K5b / K6b and
    K5bd / K6bd)."""
    scale = 96 ** -0.5
    fp32 = dtype == torch.float32
    ftol = FP32_TOL if fp32 else BF16_TOL
    label = f"{label} {str(dtype)[6:]} {shift}"
    hs = (heads,) if head_last else ()
    x = mvit_shift_inputs(torch, gen, b, heads, qn, k_shape, dtype,
                          HOT_TARGETS)
    args = (*x[:6], k_shape, *hs, scale)
    if saved:
        got = k5.mvit_attention_fwd_probs(*args, shift)
        want = k5.mvit_attention_fwd_probs_plain(*args, shift)
        names, tols = ("out", "stat", "probs"), (ftol, ROWSUM_TOL,
                                                 FP32_TOL if fp32
                                                 else PROBS_TOL)
    else:
        fwd = k5.mvit_attention_hl_fwd if head_last else k5.mvit_attention_fwd
        fwd_plain = (k5.mvit_attention_hl_fwd_plain if head_last
                     else k5.mvit_attention_fwd_plain)
        got, want = fwd(*args, shift), fwd_plain(*args, shift)
        names, tols = ("out", "stat"), (ftol, ROWSUM_TOL)
    pairs = [shift_pair(torch, shift, f"{label} {n}", a, r, t,
                        {"out": 96, "stat": 1}.get(n, r.shape[-1]))
             for n, a, r, t in zip(names, got, want, tols)]
    if saved:
        return pairs
    x = mvit_shift_inputs(torch, gen, b, heads, qn, k_shape, dtype,
                          COOL_TARGETS if shift == "none" else HOT_TARGETS)
    args = (*x[:6], k_shape, *hs, scale)
    out, stat = fwd_plain(*args, shift)
    bargs = (*x[:6], stat, x[6], k_shape, *hs, scale, shift)
    gtol = (lambda r: grad_tol(FP32_TOL if fp32 else BF16_TOL, r))
    bwds = [("b", k5.mvit_attention_hl_bwd if head_last
             else k5.mvit_attention_bwd,
             k5.mvit_attention_hl_bwd_plain if head_last
             else k5.mvit_attention_bwd_plain, dict(out=out))]
    if shift == "none":
        bwds.append(("bd", None, None, None))
    for tag, bwd, bwd_plain, kw in bwds:
        if tag == "bd":
            dargs = (*x[:6], stat, out, x[6], k_shape, *hs, scale, shift)
            got = (k5.mvit_attention_hl_bwd_delta if head_last
                   else k5.mvit_attention_bwd_delta)(*dargs)
            want = (k5.mvit_attention_hl_bwd_delta_plain if head_last
                    else k5.mvit_attention_bwd_delta_plain)(*dargs)
        else:
            kw = kw if shift == "max" else {}
            got, want = bwd(*bargs, **kw), bwd_plain(*bargs, **kw)
        pairs += [(f"{label} {tag} {n}", a, r, gtol(r))
                  for n, a, r in zip(("dq", "dk", "dv", "dkc", "dvc", "drel"),
                                     got, want)]
    return pairs


def shift_kernel_checks(torch, gen, k1, k2, fa, k5, shift):
    """Every ``shift`` variant a route reaches against its plain version:
    bf16 at the training shapes of ``PERF.md`` section 6 and a short or
    packed case, float32 at a smaller shape; yields (family, comparisons,
    bit-for-bit pairs)."""
    b16, f32 = torch.bfloat16, torch.float32
    for dtype, bt, n in ((b16, 2 * CLIPS_PER_SAMPLE * 8, 196), (b16, 4, 48),
                         (f32, 4, 196)):
        yield ("k1", *k1_shift_checks(torch, gen, k1, shift, dtype, bt, n))
    for dtype, b, t, n in ((b16, 2 * CLIPS_PER_SAMPLE, 8, 196),
                           (b16, 2, 16, 49), (f32, 2, 8, 49)):
        yield ("k2", *k2_shift_checks(torch, gen, k2, shift, dtype, b, t, n))
    for dtype, b, n, cls in ((b16, 2 * CLIPS_PER_SAMPLE * 8, 197, False),
                             (b16, 2 * CLIPS_PER_SAMPLE * 8, 196, True),
                             (f32, 2, 130, True)):
        yield ("pair", pair_shift_checks(torch, gen, fa, shift, dtype, b, n,
                                         cls), [])
    yield ("pair", pair_layout_checks(torch, gen, fa, shift), [])
    for args in ((b16, "K5 block 0", True, 18, 1, 25088, (8, 7, 7)),
                 (b16, "K6 block 1", False, 36, 1, 6272, (8, 14, 14)),
                 (f32, "K5 small", True, 2, 2, 70, (2, 3, 4)),
                 (f32, "K6 small", False, 4, 1, 70, (2, 3, 4))):
        yield ("mvit", mvit_shift_checks(torch, gen, k5, shift, *args), [])
    for dtype, qn, k_shape, b in ((b16, 6272, (8, 14, 14), 36),
                                  (f32, 70, (2, 3, 4), 4)):
        yield ("mvit", mvit_shift_checks(torch, gen, k5, shift, dtype,
                                         "K6sp", False, b, 1, qn, k_shape,
                                         saved=True), [])


def shift_records(torch, k1, k2, k5, clamp: dict) -> list:
    """The records of the variants phase 32's three paths launch, timed at
    the shapes of their clamp rows, whose bound and library time they
    carry: K1sp, K2f, K2b, K5f, K5b, K6f and K6b under max, K1f and K2f
    under none (phases 2-8's shapes; random inputs)."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").bfloat16()
    heads, scale, c = 12, 0.125, 768
    bt, b = 2 * CLIPS_PER_SAMPLE * 8, 2 * CLIPS_PER_SAMPLE
    qkv, qkv_c = r(bt, 196, 3 * c), r(bt, 1, 3 * c)
    ev, ev_c = r(8 * 16, 196, 3 * c), r(8 * 16, 1, 3 * c)
    t_ev, t_tr, t_g = (r(16, 8, 196, 3 * c), r(b, 8, 196, 3 * c),
                       r(b, 8, 196, c))
    calls = [
        (k1.KERNEL_PROBS, "max",
         lambda s: k1.spatial_attention_fwd_probs(qkv, qkv_c, heads, scale, s),
         lambda s: k1.spatial_attention_fwd_probs_plain(qkv, qkv_c, heads,
                                                        scale, s)),
        (k1.KERNEL, "none",
         lambda s: k1.spatial_attention(ev, ev_c, heads, scale, s),
         lambda s: k1.spatial_attention_plain(ev, ev_c, heads, scale, s))]
    for shift in ("max", "none"):
        calls.append((k2.KERNEL, shift,
                      lambda s: k2.temporal_attention(t_ev, heads, scale, s),
                      lambda s: k2.temporal_attention_plain(t_ev, heads,
                                                            scale, s)))
    calls.append((k2.KERNEL_BWD, "max",
                  lambda s: k2.temporal_attention_bwd(t_tr, t_g, heads, scale,
                                                      s),
                  lambda s: k2.temporal_attention_bwd_plain(t_tr, t_g, heads,
                                                            scale, s)))
    mscale = 96 ** -0.5
    for head_last, b_, qn, k_shape, fname, bname in (
            (True, 18, 25088, (8, 7, 7), k5.KERNEL_HL, k5.KERNEL_HL_BWD),
            (False, 36, 6272, (8, 14, 14), k5.KERNEL, k5.KERNEL_BWD)):
        x = mvit_inputs(torch, gen, b_, 1, qn, k_shape, torch.bfloat16)
        hs = (1,) if head_last else ()
        args = (*x[:6], k_shape, *hs, mscale)
        fwd = k5.mvit_attention_hl_fwd if head_last else k5.mvit_attention_fwd
        fwd_plain = (k5.mvit_attention_hl_fwd_plain if head_last
                     else k5.mvit_attention_fwd_plain)
        bwd = k5.mvit_attention_hl_bwd if head_last else k5.mvit_attention_bwd
        bwd_plain = (k5.mvit_attention_hl_bwd_plain if head_last
                     else k5.mvit_attention_bwd_plain)
        out, lse = fwd_plain(*args, "max")
        bargs = (*x[:6], lse, x[6], k_shape, *hs, mscale)
        calls += [(fname, "max",
                   lambda s, a=args, f=fwd: f(*a, s),
                   lambda s, a=args, f=fwd_plain: f(*a, s)),
                  (bname, "max",
                   lambda s, a=bargs, f=bwd, o=out: f(*a, s, o),
                   lambda s, a=bargs, f=bwd_plain, o=out: f(*a, s, o))]
    knob = {"spatial": "SPATIAL_SHIFT", "temporal": "TEMPORAL_SHIFT",
            "mvit": "MVIT_SHIFT"}
    records = []
    for name, shift, kernel, plain in calls:
        base = clamp[name]
        kernel(shift)
        got = kernel(shift)
        want = plain(shift)
        got, want = (got, want) if isinstance(got, tuple) else ((got,),
                                                                (want,))
        err = max(((a.float() - r.float()).abs().max().item()
                   for a, r in zip(got, want)), default=0.0)
        del got, want
        ms = time_ms(torch, lambda: kernel(shift))
        plain_ms = time_ms(torch, lambda: plain(shift), iters=2, reps=5)
        clamp_ms = time_ms(torch, lambda: kernel("clamp"))
        family = name.split("_")[0]
        rec = dict(base, name=f"{name}:{knob[family]}={shift}",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"{rec['name']}: kernel {ms:.4f} ms ({ms / clamp_ms:.3f} x the "
              f"clamp kernel's {clamp_ms:.4f} ms in this call), plain "
              f"{plain_ms:.4f} ms, bound {base['bound_ms']:.4f} ms, library "
              f"{base['library_ms']} ms (the clamp row's), max_abs_err "
              f"{err:.3e} on random inputs")
        records.append(rec)
    return records


def phase_shifts(torch, k1, k2, k5, k8, fa, _build, clamp: dict) -> list:
    """Slice 16: every ``max`` and ``none`` variant against its plain
    version (:func:`shift_kernel_checks`); then three paths at full width
    against the plain path with asserted launches: TimeSformer-B order
    pretraining under ``SPATIAL_SHIFT=max TEMPORAL_SHIFT=max`` and
    MViT-v2-S order pretraining under ``MVIT_SHIFT=max`` (``SHIFT_STEPS``
    each), and the zero-shot COIN test under all three knobs ``none`` (2
    batches).  Returns the records of the variants those paths launch
    (:func:`shift_records`), with their launches."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    for shift in SHIFTS:
        for _, pairs, twins in shift_kernel_checks(torch, gen, k1, k2, fa, k5,
                                                   shift):
            for name, got, want, tol in pairs:
                compare(torch, name, got, want, tol)
            for name, got, twin in twins:
                torch.cuda.synchronize()
                if not all(same_bits(torch, a, b) for a, b in zip(got, twin)):
                    fail(f"{name}: not bit for bit")
                print(f"{name}: bit for bit")
            del pairs, twins
            torch.cuda.empty_cache()
    records = shift_records(torch, k1, k2, k5, clamp)
    hl, hs, n = MVIT_HL_BLOCKS, MVIT_HS_BLOCKS, SHIFT_STEPS
    ts = phase_ts_knob_train(
        torch, k1, k2, k5, k8, _build,
        "TimeSformer SPATIAL_SHIFT=max TEMPORAL_SHIFT=max", TS_MAX,
        {k1.KERNEL_PROBS: DEPTH, k1.KERNEL_BWD: DEPTH,
         k2.KERNEL: DEPTH, k2.KERNEL_BWD: DEPTH}, False, (), n)
    with knobs_set(MVIT_MAX):
        mv = mvit_train(torch, k1, k2, k5, k8, _build, "MViT MVIT_SHIFT=max",
                        n, {k5.KERNEL_HL: hl * n, k5.KERNEL: hs * n,
                            k5.KERNEL_HL_BWD: hl * n, k5.KERNEL_BWD: hs * n})
    ev = phase_slice(torch, k1, k2, k5, k8, _build, ALL_NONE,
                     ("TEST.NUM_ENSEMBLE_VIEWS", "1",
                      "TEST.NUM_SPATIAL_CROPS", "1", "TEST.BATCH_SIZE", "32"),
                     (k1.KERNEL, k2.KERNEL))
    for rec in records:
        base, shift = rec["name"].split(":")[0], rec["name"].split("=")[1]
        runs = ev if shift == "none" else (mv if base.startswith("mvit")
                                           else ts)
        rec["launches"] = runs.get(base, 0)
        if not rec["launches"]:
            fail(f"{rec['name']} was not launched on the slice 16 paths")
    return records


def ek_cfg(*opts):
    """``configs/EK/egocentric_action_classification.yaml`` at its shipped
    width with synthetic data (``EK_OPTS``) and ``opts``."""
    from procedurevrl_torch.config import load_config

    return load_config(os.path.join(ROOT, EK_CFG), [*EK_OPTS, *opts])


def ek_kernels(torch, F, k1, train: dict, test: dict) -> list:
    """K1sp and K1b on EK's training micro-batch (32 clips x 32 frames:
    ``[1024, 196, 2304]`` + CLS) and K1f on its test batch (16 clips:
    ``[512, 196, 2304]``) against their plain versions, timed beside the
    plain versions and SDPA, with their bounds; ``kernels`` records named
    ``<kernel>@EK`` with the launches of the EK train and test runs."""
    heads, d, n = 12, 64, 196
    c, L = heads * d, n + 1
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(17)
    src = "procedurevrl_torch/csrc/spatial_attention.cu"
    e = 2  # bf16 bytes
    records = []
    for bt, kind in ((1024, "train"), (512, "test")):
        def r(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

        qkv, qkv_c = r(bt, n, 3 * c), r(bt, 1, 3 * c)
        x = torch.cat([qkv, qkv_c], dim=1).view(bt, L, 3, heads, d)
        q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        shape = f"[{bt},{n},{3 * c}]"
        if kind == "test":
            out, out_c = k1.spatial_attention(qkv, qkv_c, heads, scale)
            ref, ref_c = k1.spatial_attention_plain(qkv, qkv_c, heads, scale)
            err = max(compare(torch, f"K1f EK {shape} frames", out, ref,
                              BF16_TOL),
                      compare(torch, f"K1f EK {shape} cls", out_c, ref_c,
                              BF16_TOL))
            ms = time_ms(torch, lambda: k1.spatial_attention(
                qkv, qkv_c, heads, scale))
            plain = time_ms(torch, lambda: k1.spatial_attention_plain(
                qkv, qkv_c, heads, scale), iters=3, reps=5)
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v))
            nb, fl = bt * L * 4 * c * e, 2 * 2 * bt * heads * L * L * d
            b_ms, b_by = bound_ms(nb, fl, BF16_FLOPS)
            print(f"K1f EK {shape} bf16: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}: {nb / 1e6:.1f} MB, {fl / 1e9:.2f} GFLOP)")
            records.append({
                "name": f"{k1.KERNEL}@EK", "route": "cuda", "source": src,
                "replaces": "procedurevrl_tpu/ops/pallas_attention.py:536",
                "launches": test.get(k1.KERNEL, 0), "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib})
            continue
        g, gc = r(bt, n, c), r(bt, 1, c)
        out, out_c, probs = k1.spatial_attention_fwd_probs(qkv, qkv_c, heads,
                                                           scale)
        ref, ref_c, ref_p = k1.spatial_attention_fwd_probs_plain(
            qkv, qkv_c, heads, scale)
        err_sp = max(compare(torch, f"K1sp EK {shape} frames", out, ref,
                             BF16_TOL),
                     compare(torch, f"K1sp EK {shape} cls", out_c, ref_c,
                             BF16_TOL),
                     compare(torch, f"K1sp EK {shape} probs", probs, ref_p,
                             K1K2_FWD_TOL))
        del ref, ref_c, ref_p
        dx, dx_c = k1.spatial_attention_bwd(qkv, qkv_c, probs, g, gc, heads,
                                            scale)
        rdx, rdx_c = k1.spatial_attention_bwd_plain(qkv, qkv_c, probs, g, gc,
                                                    heads, scale)
        err_b = max(compare(torch, f"K1b EK {shape} dqkv", dx, rdx,
                            grad_tol(BF16_TOL, rdx)),
                    compare(torch, f"K1b EK {shape} dqkv_c", dx_c, rdx_c,
                            grad_tol(BF16_TOL, rdx_c)))
        del rdx, rdx_c
        ms_sp = time_ms(torch, lambda: k1.spatial_attention_fwd_probs(
            qkv, qkv_c, heads, scale))
        plain_sp = time_ms(torch, lambda: k1.spatial_attention_fwd_probs_plain(
            qkv, qkv_c, heads, scale), iters=3, reps=5)
        ms_b = time_ms(torch, lambda: k1.spatial_attention_bwd(
            qkv, qkv_c, probs, g, gc, heads, scale))
        plain_b = time_ms(torch, lambda: k1.spatial_attention_bwd_plain(
            qkv, qkv_c, probs, g, gc, heads, scale), iters=2, reps=5)
        gy = torch.cat([g, gc], dim=1).view(bt, L, heads, d).transpose(1, 2)
        lib_fwd, lib_bwd = sdpa_ms(torch, F, q, k, v, gy.contiguous())
        ls = k1.probs_stride(L)
        nb_sp = bt * L * 4 * c * e + bt * heads * L * ls * e
        fl_sp = 2 * 2 * bt * heads * L * L * d
        nb_b = bt * L * 7 * c * e + bt * heads * L * ls * e
        fl_b = 4 * 2 * bt * heads * L * L * d
        b_sp, by_sp = bound_ms(nb_sp, fl_sp, BF16_FLOPS)
        b_b, by_b = bound_ms(nb_b, fl_b, BF16_FLOPS)
        print(f"K1sp EK {shape} bf16: kernel {ms_sp:.4f} ms, plain "
              f"{plain_sp:.4f} ms, SDPA fwd {lib_fwd:.4f} ms, bound "
              f"{b_sp:.4f} ms ({by_sp}: {nb_sp / 1e6:.1f} MB)")
        print(f"K1b EK {shape} bf16: kernel {ms_b:.4f} ms, plain "
              f"{plain_b:.4f} ms, SDPA bwd {lib_bwd:.4f} ms, bound "
              f"{b_b:.4f} ms ({by_b}: {nb_b / 1e6:.1f} MB)")
        records += [
            {"name": f"{k1.KERNEL_PROBS}@EK", "route": "cuda", "source": src,
             "replaces": "procedurevrl_tpu/ops/pallas_attention.py:917",
             "launches": train.get(k1.KERNEL_PROBS, 0), "max_abs_err": err_sp,
             "ms": ms_sp, "plain_ms": plain_sp, "bound_ms": b_sp,
             "bound_by": by_sp, "library_ms": lib_fwd},
            {"name": f"{k1.KERNEL_BWD}@EK", "route": "cuda", "source": src,
             "replaces": "procedurevrl_tpu/ops/pallas_attention.py:941",
             "launches": train.get(k1.KERNEL_BWD, 0), "max_abs_err": err_b,
             "ms": ms_b, "plain_ms": plain_b, "bound_ms": b_b,
             "bound_by": by_b, "library_ms": lib_bwd}]
        del qkv, qkv_c, g, gc, probs, dx, dx_c, out, out_c, x, q, k, v, gy
        torch.cuda.empty_cache()
    return records


def step_peak(torch, cfg):
    """Peak device memory (bytes) of building ``cfg``'s model and taking one
    micro-batch train step, None where the card runs out of memory."""
    import gc

    from procedurevrl_torch.datasets.synthetic import SyntheticClips
    from procedurevrl_torch.engine.steps import make_train_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.solver.lr_policy import lr_schedule
    from procedurevrl_torch.solver.optimizer import construct_optimizer

    batch = SyntheticClips(cfg, "train").batch(
        cfg.TRAIN.BATCH_SIZE, 0, torch.Generator(device="cuda"))
    model = step = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        model, _ = build_model(cfg, "cuda")
        step = make_train_step(model, construct_optimizer(model, cfg), cfg,
                               None, lr_schedule(cfg, 1))
        float(step(batch)["loss"])
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        del model, step, batch
        gc.collect()
        torch.cuda.empty_cache()


def phase_ek(torch, F, k1, k2, k5, k8, _build) -> list:
    """Slice 17, the EPIC-Kitchens-100 full finetune at its shipped width:
    ``train_net.train`` on ``EK_CFG`` (TimeSformer-B, 32 frames at 224^2,
    verb + noun heads, AdamW, bf16, remat under the default policy, mixup
    set and not applied) for ``EK_STEPS`` optimizer steps of 4 micro-batches
    of 32 clips through the EPIC dataset's dummy split (cut to
    ``EK_VIDEOS`` segments), which ends with a val epoch (1 batch of 32);
    per micro-batch 12 K1sp and 12 K1b, per val batch 12 K1f, and no K2 (T
    > 16 takes the plain temporal pass) or other port kernel; one
    micro-batch step against the plain path and profiled; then
    ``test_net.test`` on 32 videos x 1 view in 2 batches of 16 clips (12
    K1f a batch), its verb and
    noun logits on one batch against the plain path relative to their
    scale; the peak memory of one micro-batch step under the default
    policy and ``REMAT_SAVE_ATTN False``; K1sp / K1b / K1f
    at EK's shapes (:func:`ek_kernels`)."""
    from procedurevrl_torch.datasets import loader as loader_mod
    from procedurevrl_torch.engine.steps import make_eval_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.tools.test_net import test

    from procedurevrl_torch.datasets import epickitchens

    if any(os.environ.get(k) for k in TS_KNOBS):
        fail(f"phase 33 runs the default route: unset {list(TS_KNOBS)}")
    segments, epickitchens.NUM_DUMMY = epickitchens.NUM_DUMMY, EK_VIDEOS
    try:
        return ek_phase(torch, F, k1, k2, k5, k8, _build, loader_mod,
                        make_eval_step, build_model, test)
    finally:
        epickitchens.NUM_DUMMY = segments


def ek_phase(torch, F, k1, k2, k5, k8, _build, loader_mod, make_eval_step,
             build_model, test) -> list:
    """The body of :func:`phase_ek`, on the cut dummy split."""
    cfg = ek_cfg(*EK_SPLIT_OPTS)
    if cfg.TRAIN.DATASET != "Epickitchens" or not cfg.MIXUP.ENABLED:
        fail(f"{EK_CFG} is no EPIC finetune with mixup")
    accum = cfg.GLOBAL_BATCH_SIZE // cfg.TRAIN.BATCH_SIZE
    t0 = time.perf_counter()
    stats, launches, peak = run_train(torch, _build, cfg, EK_STEPS)
    wall = time.perf_counter() - t0
    for i, h in enumerate(stats["history"]):
        print(f"EK step {i + 1}: loss {h['loss']:.6f} verb_loss "
              f"{h['verb_loss']:.6f} noun_loss {h['noun_loss']:.6f} "
              f"grad_norm {h['grad_norm']:.4f} verb_top1_acc "
              f"{h['verb_top1_acc']:.2f} noun_top1_acc "
              f"{h['noun_top1_acc']:.2f} top1_acc {h['top1_acc']:.2f} lr "
              f"{h['lr']:.3e}")
        if not all(math.isfinite(h[k]) for k in ("loss", "verb_loss",
                                                 "noun_loss", "grad_norm")):
            fail(f"EK step {i + 1} is not finite")
    if len(stats["history"]) != EK_STEPS or len(stats["val"]) != 1:
        fail(f"EK: {len(stats['history'])} steps and {len(stats['val'])} "
             f"val epochs, expected {EK_STEPS} and 1")
    val = stats["val"][0]
    for k in ("verb_top1_acc", "noun_top1_acc", "top1_acc", "top5_acc"):
        if not 0.0 <= val[k] <= 100.0:
            fail(f"EK val {k} {val[k]}")
    n_val = len(loader_mod.construct_loader(cfg, "val"))
    micro = EK_STEPS * accum
    print(f"EK train through the dataset: {EK_STEPS} steps of {accum} "
          f"micro-batches x {cfg.TRAIN.BATCH_SIZE} clips x "
          f"{cfg.DATA.NUM_FRAMES} frames at {cfg.DATA.TRAIN_CROP_SIZE}^2, "
          f"{EK_STEPS * accum * cfg.TRAIN.BATCH_SIZE / wall:.2f} clips/s "
          f"over the wall below, a val epoch of "
          f"{n_val} batches (verb / noun / action top-1 "
          f"{val['verb_top1_acc']:.2f} / {val['noun_top1_acc']:.2f} / "
          f"{val['top1_acc']:.2f}), wall {wall:.1f} s (model build and val "
          f"included), peak memory {peak / 2 ** 30:.3f} GiB, launches "
          f"{launches}")
    expected = dict.fromkeys(k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8),
                             0)
    expected.update({k1.KERNEL_PROBS: DEPTH * micro,
                     k1.KERNEL_BWD: DEPTH * micro, k1.KERNEL: DEPTH * n_val})
    check_launches(launches, expected, f"{EK_STEPS} EK steps and a val epoch")
    step, batch = step_vs_plain(torch, cfg, k1, k2, k5, k8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profile_step(torch, f"one EK micro-batch step ({cfg.TRAIN.BATCH_SIZE} "
                 f"clips x {cfg.DATA.NUM_FRAMES} frames, remat)",
                 lambda: float(step(batch)["loss"]))
    print(f"EK profiled micro-batch step peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    del step, batch
    torch.cuda.empty_cache()

    tcfg = ek_cfg(*EK_SPLIT_OPTS, *EK_TEST_OPTS)
    tloader = test_loader(tcfg)
    n_batches = len(tloader)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with job_dir(tcfg):
        tstats = test(tcfg, device="cuda")
        torch.cuda.synchronize()
    tl = dict(_build.LAUNCHES)
    print(f"EK test: {len(tloader.dataset)} clips in {n_batches} batches of "
          f"{tcfg.TEST.BATCH_SIZE}, {tstats['clips_per_sec']:.2f} clips/s "
          f"over batches 2..{n_batches}, stats "
          f"{ {k: v for k, v in tstats.items() if k.endswith('_acc')} }, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB, launches {tl}")
    if n_batches < 2:
        fail(f"EK test: {n_batches} batches, expected at least 2")
    expected = dict.fromkeys(k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8),
                             0)
    expected[k1.KERNEL] = DEPTH * n_batches
    check_launches(tl, expected, "the EK test")
    for key in ("verb", "noun", "action"):
        if not 0.0 <= float(tstats[f"{key}_top1_acc"]) <= float(
                tstats[f"{key}_top5_acc"]) <= 100.0:
            fail(f"EK test {key} accuracies {tstats}")
    model, _ = build_model(tcfg, "cuda")
    estep = make_eval_step(model, tcfg, None)
    b = first_batch(tloader)
    got = estep(b)
    with plain_attention(k1, k2, k5, k8):
        ref = estep(b)
    torch.cuda.synchronize()
    for name, classes, gv, rv in zip(("verb", "noun"), (97, 300), got, ref):
        if gv.shape != (tcfg.TEST.BATCH_SIZE, classes):
            fail(f"EK {name} logits have shape {tuple(gv.shape)}")
        if not bool(torch.isfinite(gv).all()):
            fail(f"EK {name} logits are not finite")
        scale = rv.abs().max().item()
        rel = (gv - rv).abs().max().item() / scale
        agree = (gv.argmax(1) == rv.argmax(1)).float().mean().item()
        print(f"EK test batch {name} logits vs plain versions: max |d| "
              f"{rel * scale:.3e} over max |x| {scale:.4f} = {rel:.3e} "
              f"(max {EPIC_LOGIT_RTOL}), top-1 agreement {agree:.3f}")
        if rel > EPIC_LOGIT_RTOL:
            fail(f"EK {name} logits through the kernels disagree with the "
                 f"plain path")
    del model, estep, b, got, ref
    torch.cuda.empty_cache()

    # (without remat the micro-batch does not fit: slice 17; not probed since
    # slice 19, to keep the script in time)
    for label, opts in (("default policy", ()),
                        ("REMAT_SAVE_ATTN False",
                         ("TPU.REMAT_SAVE_ATTN", "False"))):
        mem = step_peak(torch, ek_cfg(*opts))
        print(f"EK one micro-batch step, {label}: peak memory "
              + ("does not fit (OutOfMemoryError)" if mem is None
                 else f"{mem / 2 ** 30:.3f} GiB"))
    return ek_kernels(torch, F, k1, launches, tl)


def phase_remat(torch, k1, k2, k5, k8, _build) -> None:
    """Slice 17, the remat policies: the default TimeSformer-B
    order-pretraining step (``procedurevrl_adamw.yaml``, 2 samples x 9
    clips) under ``TPU.REMAT_SAVE_ATTN True`` (K1sp and K2f once per block
    a step) and ``False`` (twice), each after ``POLICY_STEPS`` warm-up
    steps: one step's launches and its peak memory above the resident
    state, and device busy profiled in the order True, False, False, True;
    then 2 steps of
    ``configs/HowTo100M/procedurevrl_sgd.yaml``."""
    from procedurevrl_torch.datasets.synthetic import SyntheticPretrain
    from procedurevrl_torch.engine.steps import make_train_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.solver.lr_policy import lr_schedule
    from procedurevrl_torch.solver.optimizer import construct_optimizer

    if any(os.environ.get(k) for k in TS_KNOBS):
        fail(f"phase 34 runs the default route: unset {list(TS_KNOBS)}")
    steps = {}
    for keep in (True, False):
        cfg = train_cfg(True, "TPU.REMAT_SAVE_ATTN", str(keep))
        model, bank = build_model(cfg, "cuda")
        step = make_train_step(model, construct_optimizer(model, cfg), cfg,
                               bank, lr_schedule(cfg, 1))
        batch = SyntheticPretrain(cfg).batch(2, 0,
                                             torch.Generator(device="cuda"))
        for _ in range(POLICY_STEPS):
            float(step(batch)["loss"])
        torch.cuda.synchronize()
        # the other policy's model stays resident: read the step's own
        # peak above what is allocated before it
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        loss = float(step(batch)["loss"])
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - resident
        fwd = DEPTH if keep else 2 * DEPTH
        expected = dict.fromkeys(k1k2_kernels(k1, k2), 0)
        expected.update({k1.KERNEL_PROBS: fwd, k2.KERNEL: fwd,
                         k1.KERNEL_BWD: DEPTH, k2.KERNEL_BWD: DEPTH})
        check_launches(launches, expected,
                       f"one step under REMAT_SAVE_ATTN {keep}")
        print(f"REMAT_SAVE_ATTN {keep}: loss {loss:.6f}, the step's peak "
              f"memory above the resident state {peak / 2 ** 30:.3f} GiB "
              f"(resident {resident / 2 ** 30:.3f} GiB), launches "
              f"{launches}")
        steps[keep] = (step, batch)
    busy = {True: [], False: []}
    for keep in (True, False, False, True):
        step, batch = steps[keep]
        busy[keep].append(profile_step(
            torch, f"one train step (18 clips, REMAT_SAVE_ATTN {keep})",
            lambda: float(step(batch)["loss"]), top=6))
    print(f"device busy by policy (ms): REMAT_SAVE_ATTN True {busy[True]}, "
          f"False {busy[False]}")
    del steps, step, batch
    torch.cuda.empty_cache()

    from procedurevrl_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, SGD_CFG), [
        "DEV.LOAD_DUMMY_DATA", "True", "TRAIN.BATCH_SIZE", "2",
        "GLOBAL_BATCH_SIZE", "2"])
    if cfg.SOLVER.OPTIMIZING_METHOD != "sgd":
        fail(f"{SGD_CFG} is no SGD config")
    stats, launches, peak = run_train(torch, _build, cfg, 2)
    for i, h in enumerate(stats["history"]):
        print(f"SGD pretraining step {i + 1}: loss {h['loss']:.6f} kl "
              f"{h['kl']:.6f} mse {h['mse']:.6f} grad_norm "
              f"{h['grad_norm']:.4f} lr {h['lr']:.3e}")
        if not all(math.isfinite(h[k]) for k in ("loss", "kl", "mse",
                                                 "grad_norm")):
            fail(f"SGD pretraining step {i + 1} is not finite")
    expected = dict.fromkeys(k1k2_kernels(k1, k2), 0)
    expected.update({key: 2 * DEPTH for key in (
        k1.KERNEL_PROBS, k2.KERNEL, k1.KERNEL_BWD, k2.KERNEL_BWD)})
    check_launches(launches, expected, "2 SGD pretraining steps")
    print(f"SGD pretraining ({SGD_CFG}): 2 steps, peak memory "
          f"{peak / 2 ** 30:.3f} GiB, launches {launches}")


def probe_host() -> dict:
    """Which decoders and readers this machine has, and its cores."""
    import importlib.util

    found = {m: importlib.util.find_spec(m) is not None
             for m in ("cv2", "av", "PIL", "pandas")}
    found["ffmpeg"] = shutil.which("ffmpeg") is not None
    print(f"host: os.cpu_count() {os.cpu_count()}; found "
          f"{', '.join(k for k, v in found.items() if v) or 'none'}; "
          f"missing {', '.join(k for k, v in found.items() if not v) or 'none'}")
    return found


def loader_rate(torch, loader, n_batches: int, to_card: bool) -> float:
    """Samples/s of ``loader`` alone over batches 2..``n_batches`` of an
    epoch (the first fills the pool), host arrays only or copied to the
    card by ``prefetch_to_device``."""
    from procedurevrl_torch.datasets.loader import prefetch_to_device

    batches = (prefetch_to_device(loader, "cuda", size=loader.prefetch_depth)
               if to_card else iter(loader))
    n = 0
    with contextlib.closing(batches):
        for i, item in enumerate(batches):
            if i == 0:
                t0 = time.perf_counter()
            else:
                n += item[1]
            if i + 1 == n_batches:
                break
        if to_card:
            torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def same_passes(loader, n_batches: int) -> None:
    """Two passes of ``loader`` at one epoch give identical batches."""
    passes = []
    for _ in range(2):
        batches = iter(loader)
        with contextlib.closing(batches):
            passes.append([b for b, _, _ in itertools.islice(batches,
                                                              n_batches)])
    for i, (a, b) in enumerate(zip(*passes)):
        for key in a:
            if not np_equal(a[key], b[key]):
                fail(f"two loader passes differ in batch {i}, key {key}")
    print(f"two passes of the pretraining loader: {n_batches} batches "
          f"identical in every key ({sorted(passes[0][0])})")


def np_equal(a, b) -> bool:
    import numpy as np

    return a.dtype == b.dtype and np.array_equal(a, b)


def check_pinned(what: str) -> dict:
    """Every tensor ``prefetch_to_device`` copied since the last reset came
    from pinned memory (a non-blocking copy from pageable memory would be
    synchronous)."""
    from procedurevrl_torch.datasets import loader as loader_mod

    copies = dict(loader_mod.COPIES)
    if not copies["tensors"] or copies["pinned"] != copies["tensors"]:
        fail(f"{what}: {copies['pinned']} of {copies['tensors']} copied "
             "tensors were pinned")
    return copies


def write_clips(folder: str, found: dict, n: int = 3) -> bool:
    """``n`` clips of 12 s at 30 fps, 320x180, and a windowed CSV index of
    them (``test.csv``), written by ``cv2.VideoWriter`` or the ``ffmpeg``
    binary; False if neither is there."""
    import numpy as np

    for i in range(n):
        path = os.path.join(folder, f"clip{i}.mp4")
        if found["cv2"]:
            import cv2

            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                                (320, 180))
            ramp = np.arange(320, dtype=np.int64)[None, :, None]
            for f in range(360):
                img = ((ramp * (i + 1) + f) % 256).astype(np.uint8)
                w.write(np.broadcast_to(img, (180, 320, 3)).copy())
            w.release()
        elif found["ffmpeg"]:
            subprocess.run([shutil.which("ffmpeg"), "-nostdin", "-loglevel",
                            "error", "-f", "lavfi", "-i",
                            "testsrc=duration=12:size=320x180:rate=30",
                            "-pix_fmt", "yuv420p", path], check=True,
                           timeout=120)
        else:
            return False
    with open(os.path.join(folder, "test.csv"), "w") as f:
        f.write("".join(f"clip{i} {i} 12 2 11\n" for i in range(n)))
    return True


def phase_loader(torch, k1, k2, k5, k8, _build) -> None:
    """Slice 18, the host data pipeline (see the module's list)."""
    from procedurevrl_torch.datasets import loader as loader_mod
    from procedurevrl_torch.datasets import videoproc
    from procedurevrl_torch.datasets.synthetic import SyntheticPretrain
    from procedurevrl_torch.engine.steps import make_train_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.solver.lr_policy import lr_schedule
    from procedurevrl_torch.solver.optimizer import construct_optimizer
    from procedurevrl_torch.tools.test_net import test
    from procedurevrl_torch.tools.train_net import WARMUP_STEPS

    if any(os.environ.get(k) for k in TS_KNOBS):
        fail(f"phase 35 runs the default route: unset {list(TS_KNOBS)}")
    found = probe_host()
    lib = videoproc.load()
    if (os.path.realpath(lib._name) != os.path.realpath(
            videoproc.library_path())
            or not str(videoproc.library_path()).startswith(
                str(_build.BUILD_DIR))):
        fail(f"the preprocess library is {lib._name}, not the build of "
             "csrc/videoproc.cpp")
    passes0 = videoproc.PASSES["fused_preprocess"]

    # the loader alone: pretraining (9 clips x 8 frames at 224) and the
    # COIN zero-shot test split
    pre_cfg = train_cfg(True)
    test_cfg = coin_cfg("step_classification", *zero_shot_opts())
    for label, cfg, split, n in (
            ("pretraining train split", pre_cfg, "train", LOADER_BATCHES),
            ("COIN test split", test_cfg, "test", LOADER_BATCHES)):
        loader = loader_mod.construct_loader(cfg, split)
        n = n or len(loader)
        host = loader_rate(torch, loader, n, False)
        loader_mod.reset_copies()
        card = loader_rate(torch, loader, n, True)
        copies = check_pinned(label)
        per_batch = loader.local_batch
        print(f"loader alone, {label} ({per_batch} samples of "
              f"{loader.dataset.clips} clips a batch, NUM_WORKERS "
              f"{cfg.DATA_LOADER.NUM_WORKERS}): {host:.2f} samples/s on the "
              f"host, {card:.2f} samples/s pinned and copied to the card "
              f"(batches 2..{n}; {copies['batches']} batches, "
              f"{copies['bytes'] / 2 ** 20:.1f} MiB copied, all pinned)")
    same_passes(loader_mod.construct_loader(pre_cfg, "train"), 3)

    # train_net.train through the loader, launches asserted
    loader_mod.reset_copies()
    stats, launches, peak = run_train(torch, _build, train_cfg(True),
                                      LOADER_STEPS)
    copies = check_pinned("train_net.train")
    if not all(math.isfinite(h["loss"]) for h in stats["history"]):
        fail("a train step through the loader is not finite")
    expected = dict.fromkeys(k1k2_kernels(k1, k2), 0)
    expected.update({key: DEPTH * LOADER_STEPS for key in (
        k1.KERNEL_PROBS, k2.KERNEL, k1.KERNEL_BWD, k2.KERNEL_BWD)})
    check_launches(launches, expected, f"{LOADER_STEPS} steps through the "
                   "loader")
    print(f"train_net.train through the loader: {stats['clips_per_sec']:.2f} "
          f"clips/s over steps {WARMUP_STEPS + 1}..{LOADER_STEPS}, losses "
          f"{[round(h['loss'], 6) for h in stats['history']]}, peak memory "
          f"{peak / 2 ** 30:.3f} GiB, {copies['batches']} batches copied "
          f"pinned, launches {launches}")

    # one model, its step fed by the loader and by SyntheticPretrain's
    # device-drawn batch, in the order loader, device, device, loader
    cfg = train_cfg(True)
    model, bank = build_model(cfg, "cuda")
    step = make_train_step(model, construct_optimizer(model, cfg), cfg, bank,
                           lr_schedule(cfg, 1))
    batches = loader_mod.prefetch_to_device(
        loader_mod.construct_loader(cfg, "train"), "cuda",
        size=cfg.TPU.PREFETCH_DEPTH)
    synthetic = SyntheticPretrain(cfg)
    gen = torch.Generator(device="cuda")
    drawn = itertools.count()

    def loader_batch():
        batch = next(batches)[0]
        batch.pop("index")
        return batch

    feeds = {"loader": loader_batch,
             "device": lambda: synthetic.batch(2, next(drawn), gen)}
    clips = 2 * CLIPS_PER_SAMPLE
    with contextlib.closing(batches):
        for name in ("loader", "device", "device", "loader"):
            feed = feeds[name]
            for _ in range(WARMUP_STEPS):
                float(step(feed())["loss"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = [step(feed()) for _ in range(LOADER_TIMED)]
            loss = [float(m["loss"]) for m in metrics]
            wall = time.perf_counter() - t0
            busy = profile_step(torch, f"one train step ({clips} clips, "
                                f"batch from the {name})",
                                lambda: float(step(feed())["loss"]), top=4)
            print(f"steps fed by the {name}: {LOADER_TIMED * clips / wall:.2f}"
                  f" clips/s over {LOADER_TIMED} steps, losses "
                  f"{[round(x, 6) for x in loss]}, device busy {busy:.3f} ms "
                  "a step (profile above)")
            if not all(math.isfinite(x) for x in loss):
                fail(f"a step fed by the {name} is not finite")
    del model, step, batches
    torch.cuda.empty_cache()

    # the zero-shot test through the loader
    loader_mod.reset_copies()
    n_batches = len(test_loader(test_cfg))
    _build.reset_launches()
    with job_dir(test_cfg):
        tstats = test(test_cfg, device="cuda")
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    copies = check_pinned("test_net.test")
    check_launches(launches, {
        key: DEPTH * n_batches if key in (k1.KERNEL, k2.KERNEL) else 0
        for key in k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8)},
        "the zero-shot test through the loader")
    print(f"test_net.test through the loader: {n_batches} batches, "
          f"{tstats['clips_per_sec']:.2f} clips/s over batches 2..{n_batches}, "
          f"top1 {tstats['top1_acc']}, {copies['batches']} batches copied "
          f"pinned, launches {launches}")
    passes = videoproc.PASSES["fused_preprocess"] - passes0
    if passes <= 0:
        fail("no frame went through the native fused preprocess")
    print(f"native preprocess: {passes} fused passes in this phase, library "
          f"{os.path.basename(lib._name)}")

    # real decoding, where this machine has a decoder
    backends = [b for b in ("cv2", "ffmpeg", "pyav")
                if found["av" if b == "pyav" else b]]
    folder = tempfile.mkdtemp(prefix="chip_smoke_clips_")
    try:
        if not backends or not write_clips(folder, found):
            print("real decoding: no decoder on this machine (cv2, av and "
                  "ffmpeg missing); left out")
            return
        for backend in backends:
            cfg = coin_cfg("step_classification", *zero_shot_opts(
                "DEV.LOAD_DUMMY_DATA", "False", "DATA.PATH_TO_DATA_DIR",
                folder, "DATA.PATH_PREFIX", folder, "DATA.DECODING_BACKEND",
                backend, "TEST.NUM_ENSEMBLE_VIEWS", "2"))
            _build.reset_launches()
            with job_dir(cfg):
                rstats = test(cfg, device="cuda")
                torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            check_launches(launches, {k1.KERNEL: DEPTH, k2.KERNEL: DEPTH},
                           f"the test on decoded clips ({backend})")
            if not math.isfinite(float(rstats["top1_acc"])):
                fail(f"the test on decoded clips ({backend}) is not finite")
            print(f"real decoding ({backend}): 3 written clips x 2 views in "
                  f"one batch, top1 {rstats['top1_acc']}, launches "
                  f"{launches}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def write_epic_tree(folder: str) -> None:
    """``<folder>/<participant>/videos/<video>.MP4`` (``cv2``, 456x256),
    ``<folder>/<participant>/rgb_frames/<video>/frame_{i:010d}.jpg`` and
    ``<folder>/annotations/segments.pkl``, a DataFrame of
    ``EPIC_SEGMENTS`` segments a video (the EPIC-100 list's columns)."""
    import cv2
    import numpy as np
    import pandas as pd

    rows, names = [], []
    ramp = np.arange(EPIC_W, dtype=np.int64)[None, :, None]
    for v, (video, fps) in enumerate(EPIC_VIDEOS):
        person = video.split("_")[0]
        vdir = os.path.join(folder, person, "videos")
        fdir = os.path.join(folder, person, "rgb_frames", video)
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(fdir)
        n = int(fps * EPIC_SPACING_S * (EPIC_SEGMENTS + 1))
        w = cv2.VideoWriter(os.path.join(vdir, video + ".MP4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), fps,
                            (EPIC_W, EPIC_H))
        for i in range(n):
            img = np.broadcast_to(((ramp * (v + 1) + 3 * i) % 256).astype(
                np.uint8), (EPIC_H, EPIC_W, 3)).copy()
            img[: EPIC_H // 2, :, 1] = (7 * i) % 256
            w.write(img)
            cv2.imwrite(os.path.join(fdir, f"frame_{i + 1:010d}.jpg"), img)
        w.release()
        for s in range(EPIC_SEGMENTS):
            start = 0.1 + s * EPIC_SPACING_S
            names.append(f"{video}_{s}")
            rows.append({"participant_id": person, "video_id": video,
                         "start_timestamp": "00:00:%05.2f" % start,
                         "stop_timestamp": "00:00:%05.2f" % (
                             start + EPIC_SEG_S),
                         "verb_class": (11 * len(rows)) % 97,
                         "noun_class": (29 * len(rows)) % 300})
    os.makedirs(os.path.join(folder, "annotations"))
    pd.DataFrame(rows, index=names).to_pickle(
        os.path.join(folder, "annotations", "segments.pkl"))


def write_merges(path: str) -> str:
    """A gzipped BPE merges file of CLIP's layout (a header, a few merges,
    fillers to the table's length): the real merges are not in the
    repository, and the tokenizer needs a table of that length."""
    import gzip

    pairs = ["h e", "l l", "he ll", "o </w>", "hell o</w>", "t h", "th e</w>"]
    alphabet = [chr(c) for c in range(0x3b1, 0x3b1 + 80)]
    fillers = [f"{alphabet[i % 80] * (2 + i // 80 % 3)} "
               f"{alphabet[(7 * i + 3) % 80]}{i}"
               for i in range(49152 - 256 - 2 - len(pairs))]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2", *pairs, *fillers]) + "\n")
    return path


def phase_epic_data(torch, k1, k2, k5, k8, _build) -> None:
    """Slice 19, the EPIC-Kitchens dataset and the two extract tools (see
    the module's list)."""
    import numpy as np

    from procedurevrl_torch.datasets import howto100m
    from procedurevrl_torch.datasets import loader as loader_mod
    from procedurevrl_torch.models.clip_text import CLIPTextEncoder
    from procedurevrl_torch.tools import emb_extract, feat_extract
    from procedurevrl_torch.tools.test_net import test

    if any(os.environ.get(k) for k in TS_KNOBS):
        fail(f"phase 36 runs the default route: unset {list(TS_KNOBS)}")
    folder = tempfile.mkdtemp(prefix="chip_smoke_epic_")
    try:
        t0 = time.perf_counter()
        write_epic_tree(folder)
        print(f"EPIC tree: {len(EPIC_VIDEOS)} videos of {EPIC_W}x{EPIC_H} "
              f"and their rgb_frames JPGs, {len(EPIC_VIDEOS) * EPIC_SEGMENTS}"
              f" segments, written in {time.perf_counter() - t0:.1f} s")
        tree = (*EPIC_TREE_OPTS, "EPICKITCHENS.VISUAL_DATA_DIR", folder,
                "EPICKITCHENS.ANNOTATIONS_DIR",
                os.path.join(folder, "annotations"))
        # the loader alone at EK's train shape, RandAugment on: on the
        # host over 2 batches by each reader, then pinned and copied over
        # 4 (batches 2-4: the copy runs 2 batches ahead, fewer would time
        # only the fill)
        for label, frames, copied in (("decoded (cv2)", "False", True),
                                      ("rgb_frames JPGs", "True", False)):
            cfg = ek_cfg(*tree, "DEV.EPIC_USE_FRAME_LOADER", frames,
                         "TRAIN.EPOCH_MUL", "4")  # 2 batches of 32
            loader = loader_mod.construct_loader(cfg, "train")
            host = loader_rate(torch, loader, len(loader), False)
            line = (f"EPIC loader alone, {label}: {loader.local_batch} clips "
                    f"x {cfg.DATA.NUM_FRAMES} frames at "
                    f"{cfg.DATA.TRAIN_CROP_SIZE}^2 a batch (RandAugment "
                    f"{cfg.DATA.USE_RAND_AUGMENT}, NUM_WORKERS "
                    f"{cfg.DATA_LOADER.NUM_WORKERS}): {host:.2f} samples/s "
                    f"on the host (batch 2)")
            if copied:
                cfg.TRAIN.EPOCH_MUL = 8  # 4 batches
                loader = loader_mod.construct_loader(cfg, "train")
                loader_mod.reset_copies()
                card = loader_rate(torch, loader, len(loader), True)
                copies = check_pinned(f"the EPIC loader ({label})")
                line += (f", {card:.2f} samples/s pinned and copied (batches "
                         f"2..{len(loader)}, {copies['bytes'] / 2 ** 20:.1f} "
                         "MiB)")
            print(line)

        # train_net.train on the tree: one step of 4 x 32, a val epoch
        cfg = ek_cfg(*tree)
        accum = cfg.GLOBAL_BATCH_SIZE // cfg.TRAIN.BATCH_SIZE
        n_val = len(loader_mod.construct_loader(cfg, "val"))
        t0 = time.perf_counter()
        stats, launches, peak = run_train(torch, _build, cfg, 1)
        wall = time.perf_counter() - t0
        h = stats["history"][0]
        if len(stats["history"]) != 1 or len(stats["val"]) != 1 or not all(
                math.isfinite(h[k]) for k in ("loss", "grad_norm")):
            fail(f"EK on the tree: {stats['history']} / {stats['val']}")
        expected = dict.fromkeys(k1k2_kernels(k1, k2)
                                 + mvit_kernel_names(k5, k8), 0)
        expected.update({k1.KERNEL_PROBS: DEPTH * accum,
                         k1.KERNEL_BWD: DEPTH * accum,
                         k1.KERNEL: DEPTH * n_val})
        check_launches(launches, expected, "the EK step on the tree")
        print(f"EK on the tree: one step of {accum} x "
              f"{cfg.TRAIN.BATCH_SIZE} decoded clips, loss {h['loss']:.6f}, "
              f"grad_norm {h['grad_norm']:.4f}, a val epoch of {n_val} batch "
              f"(top1 {stats['val'][0]['top1_acc']:.2f}), wall {wall:.1f} s "
              f"(model build included), peak {peak / 2 ** 30:.3f} GiB, "
              f"launches {launches}")
        tcfg = ek_cfg(*tree, *EPIC_TREE_TEST)
        n_test = len(loader_mod.construct_loader(tcfg, "test"))
        _build.reset_launches()
        with job_dir(tcfg):
            tstats = test(tcfg, device="cuda")
            torch.cuda.synchronize()
        tl = dict(_build.LAUNCHES)
        expected = dict.fromkeys(k1k2_kernels(k1, k2)
                                 + mvit_kernel_names(k5, k8), 0)
        expected[k1.KERNEL] = DEPTH * n_test
        check_launches(tl, expected, "the EK test on the tree")
        if n_test != 2:
            fail(f"the EK test on the tree took {n_test} batches, not 2")
        print(f"EK test on the tree: {n_test} batches, stats "
              f"{ {k: v for k, v in tstats.items() if k.endswith('_acc')} }, "
              f"launches {tl}")

        # emb_extract: a seeded ViT-B/16-shaped text tower over the COIN
        # steps, on the card and on the CPU
        gen = torch.Generator().manual_seed(19)
        tower = CLIPTextEncoder()
        tower.reset_parameters(gen)
        state = {**tower.state_dict(), "logit_scale": torch.tensor(4.6),
                 "visual.proj": torch.zeros(768, 512)}
        ckpt = os.path.join(folder, "clip.pt")
        torch.save(state, ckpt)
        bpe = write_merges(os.path.join(folder, "merges.txt.gz"))
        steps_file = os.path.join(ROOT, "data/step_coin_text.txt")
        with open(steps_file) as f:
            steps = [s.strip() for s in f if s.strip()]
        # the CPU takes the first EMB_CPU_STEPS (163 GFLOP a step)
        head = os.path.join(folder, "steps_head.txt")
        with open(head, "w") as f:
            f.write("\n".join(steps[:EMB_CPU_STEPS]) + "\n")
        banks = {}
        for dev, file in (("cuda", steps_file), ("cpu", head)):
            out = os.path.join(folder, f"bank_{dev}.pth")
            t0 = time.perf_counter()
            with quiet():
                emb_extract.main(["--steps", file, "--out", out,
                                  "--clip_ckpt", ckpt, "--bpe", bpe,
                                  "--device", dev])
            banks[dev] = (np.load(out[:-4] + ".npy"),
                          time.perf_counter() - t0)
        got, want = banks["cuda"][0], banks["cpu"][0]
        rel = float(np.abs(got[:EMB_CPU_STEPS] - want).max()
                    / np.abs(want).max())
        print(f"emb_extract: {len(steps)} steps x 28 prompts through 12 "
              f"layers of width 512 on the card, bank {got.shape}, "
              f"{banks['cuda'][1]:.1f} s; the first {EMB_CPU_STEPS} with "
              f"--device cpu {banks['cpu'][1]:.1f} s, max |d| / max |x| "
              f"{rel:.2e} (max {EMB_RTOL})")
        if got.shape != (len(steps), 512) or not np.isfinite(got).all() \
                or rel > EMB_RTOL:
            fail("emb_extract on the card disagrees with --device cpu")
    finally:
        shutil.rmtree(folder, ignore_errors=True)

    # feat_extract's per-view predictions against test_net's ensemble
    saved = howto100m.NUM_SYNTHETIC
    howto100m.NUM_SYNTHETIC = FEAT_VIDEOS
    try:
        cfg = coin_cfg("step_classification", *zero_shot_opts(
            "TEST.SAVE_RESULTS_PATH", "results.pkl"))
        n_batches = len(test_loader(cfg))
        _build.reset_launches()
        with job_dir(cfg):
            feats = feat_extract.extract(cfg, "cuda")
            torch.cuda.synchronize()
        fl = dict(_build.LAUNCHES)
        check_launches(fl, {key: DEPTH * n_batches if key in (
            k1.KERNEL, k2.KERNEL) else 0 for key in k1k2_kernels(k1, k2)},
            "feat_extract")
        with job_dir(cfg) as out:
            test(cfg, device="cuda")
            with open(os.path.join(out, "results.pkl"), "rb") as f:
                tested = pickle.load(f)
        views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        per_video = np.zeros_like(tested["preds"])
        np.add.at(per_video, feats["index"] // views, feats["preds"])
        err = float(np.abs(per_video - tested["preds"]).max())
        print(f"feat_extract: {feats['preds'].shape[0]} views in {n_batches} "
              f"batches, launches {fl}; summed per video against test_net's "
              f"ensemble: max |d| {err:.3e} (max {FEAT_ATOL})")
        if err > FEAT_ATOL or not np.array_equal(
                feats["labels"][::views], tested["labels"]):
            fail("feat_extract's predictions are not test_net's")
    finally:
        howto100m.NUM_SYNTHETIC = saved


def ddp_cfg(name: str):
    """Phase 37's programs: TimeSformer-B order pretraining (phase 7's
    config: 2 samples of 9 clips a step, one a rank), under ZeRO-1, and
    the EK step (2 micro-batches of 32 clips x 32 frames, 16 a rank;
    mixup set, not applied), each with ``NUM_GPUS`` the ranks."""
    ranks = ("NUM_GPUS", str(DDP_RANKS))
    if name == "ek":
        return ek_cfg("GLOBAL_BATCH_SIZE", "64", *ranks)
    zero = ("TPU.SHARD_OPT_STATE", "True") if name == "zero" else ()
    return train_cfg(True, *ranks, *zero)


def ddp_steps(torch, _build, name: str, device, profile: bool = False
              ) -> dict:
    """``DDP_STEPS[name]`` optimizer steps of ``ddp_cfg(name)`` on this
    process's rows of the device-drawn global batches one process takes
    whole: each step's metrics and wall, the launches, this process's
    optimizer bytes, and the first step's update and gradient of each
    trained tensor (from the same initial parameters on every path), on
    the host in bf16 (an update is at most about 2 lr, so bf16 keeps it to
    2^-8 of that)."""
    from procedurevrl_torch.datasets.synthetic import (
        SyntheticClips, SyntheticPretrain,
    )
    from procedurevrl_torch.engine.steps import make_train_step
    from procedurevrl_torch.models.build import build_model
    from procedurevrl_torch.parallel import ddp
    from procedurevrl_torch.parallel.collectives import (
        get_rank, get_world_size,
    )
    from procedurevrl_torch.solver.lr_policy import lr_schedule

    cfg = ddp_cfg(name)
    model, bank = build_model(cfg, device)
    optimizer = ddp.build_optimizer(model, cfg)
    accum = ddp.accumulation(cfg)
    step = make_train_step(ddp.wrap_model(model), optimizer, cfg, bank,
                           lr_schedule(cfg, 1), accum)
    size = ddp.batch_plan(cfg.TRAIN.BATCH_SIZE, cfg)[0]
    rows = ddp.local_batch_slice(size, get_world_size(), get_rank())
    gen = torch.Generator(device=device)
    source = (SyntheticClips(cfg, "train") if name == "ek"
              else SyntheticPretrain(cfg))

    def micro(i):
        batch = source.batch(size, i, gen)
        batch.pop("index", None)
        return {k: v[rows] for k, v in batch.items()}

    def one(s):
        mb = [micro(s * accum + j) for j in range(accum)]
        return step(mb if accum > 1 else mb[0])

    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    before = {n: p.detach().clone() for n, p in trained.items()}
    history, walls, first = [], [], {}
    _build.reset_launches()
    for s in range(DDP_STEPS[name]):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        history.append({k: float(v) for k, v in one(s).items()})
        walls.append(time.perf_counter() - t0)
        if s == 0:
            first = {"update": {n: (p.detach() - before[n]).bfloat16().cpu()
                                for n, p in trained.items()},
                     "grads": {n: p.grad.bfloat16().cpu()
                               for n, p in trained.items()}}
            del before
    launches = dict(_build.LAUNCHES)
    busy = (profile_step(torch, f"one {name} step on rank {get_rank()} of "
                         f"{get_world_size()}", lambda: float(
                             one(DDP_STEPS[name])["loss"]), top=4)
            if profile else None)
    return {"history": history, "walls": walls, "launches": launches,
            "busy_ms": busy, "accum": accum,
            "optimizer_bytes": ddp.optimizer_bytes(optimizer), **first}


def ddp_rank(cfg, device, names, out_dir: str) -> None:
    """A rank of phase 37 (``utils/misc.py:launch_job``): each program of
    ``names`` in turn; rank 0 keeps its results in ``out_dir``."""
    import torch

    from procedurevrl_torch.ops import _build
    from procedurevrl_torch.parallel.collectives import get_rank

    import gc

    del cfg
    for name in names:
        # every rank takes the profiled step: its gradients are all-reduced
        result = ddp_steps(torch, _build, name, device,
                           profile=name == "plain")
        print(f"rank {get_rank()} {name}: step walls "
              f"{[round(w, 3) for w in result['walls']]} s, losses "
              f"{[round(h['loss'], 6) for h in result['history']]}, "
              f"optimizer state {result['optimizer_bytes'] / 2 ** 20:.1f} "
              f"MiB, device busy of a step "
              f"{result['busy_ms'] if result['busy_ms'] else '-'} ms, "
              f"launches {result['launches']}", flush=True)
        if get_rank() == 0:
            torch.save(result, os.path.join(out_dir, f"{name}.pt"))
        del result
        gc.collect()
        torch.cuda.empty_cache()


def same_training(torch, label: str, got: dict, want: dict, lr: float
                  ) -> None:
    """Phase 7's limits between a group's rank 0 and one process: each
    step's loss and gradient norm; the first step's gradient (both from the
    same parameters and batch), cosine per trained tensor, and a tensor
    whose gradient is nought to rounding on one process (<= ROUNDING_RTOL
    of the global norm) must stay so on the ranks (<= ZERO_GRAD_RTOL);
    every parameter after that step within the 2 lr that AdamW's first
    step (lr g / (|g| + eps) each way) leaves between two gradients."""
    for i, (a, b) in enumerate(zip(got["history"], want["history"])):
        d_loss = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        d_norm = abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
        if d_loss > STEP_LOSS_RTOL or d_norm > STEP_NORM_RTOL:
            fail(f"{label} step {i + 1}: loss {a['loss']} / {b['loss']}, "
                 f"grad norm {a['grad_norm']} / {b['grad_norm']}")
    norm = want["history"][0]["grad_norm"]
    worst_cos, worst, skipped = 1.0, "", 0
    for n, g in want["grads"].items():
        g, h = g.float(), got["grads"][n].float()
        if g.norm().item() <= ROUNDING_RTOL * norm:
            skipped += 1
            if h.norm().item() > ZERO_GRAD_RTOL * norm:
                fail(f"{label}: {n}'s gradient is nought to rounding on one "
                     f"process, {h.norm().item() / norm:.2e} of the norm "
                     "on the ranks")
            continue
        cos = (h.flatten() @ g.flatten()).item() / max(
            h.norm().item() * g.norm().item(), 1e-30)
        if cos < worst_cos:
            worst_cos, worst = cos, n
    moved = max((got["update"][n].float() - u.float()).abs().max().item()
                for n, u in want["update"].items())
    bound = 2 * lr * 1.001 + 1e-6
    print(f"{label} vs one process on the global batch: losses "
          f"{[round(h['loss'], 6) for h in got['history']]} / "
          f"{[round(h['loss'], 6) for h in want['history']]}, the first "
          f"step's least gradient cosine {worst_cos:.6f} ({worst}; min "
          f"{STEP_MIN_COS}, {skipped} nought to rounding), largest "
          f"parameter difference after it {moved:.3e} (max {bound:.3e}: "
          f"AdamW's first step, lr {lr:.2e} each way)")
    if worst_cos < STEP_MIN_COS or moved > bound:
        fail(f"{label} disagrees with one process on the global batch")


def quiet_run_net(cfg, device) -> None:
    """``run_net.run`` with its log lines off stdout (a spawned rank)."""
    from procedurevrl_torch.tools import run_net

    with quiet():
        run_net.run(cfg, device)


def phase_ddp(torch, k1, k2, k5, k8, _build) -> None:
    """Slice 19, data parallel over processes (see the module's list)."""
    import functools

    from procedurevrl_torch.tools import dryrun
    from procedurevrl_torch.utils import misc

    if any(os.environ.get(k) for k in TS_KNOBS):
        fail(f"phase 37 runs the default route: unset {list(TS_KNOBS)}")
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DDP_RANKS else "gloo"
    names = ("plain", "zero", "ek")
    want = {}
    for name in ("plain", "ek"):
        want[name] = ddp_steps(torch, _build, name, torch.device("cuda"))
        print(f"one process, {name}: step walls "
              f"{[round(w, 3) for w in want[name]['walls']]} s, losses "
              f"{[round(h['loss'], 6) for h in want[name]['history']]}, "
              f"launches {want[name]['launches']}")
        torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    try:
        cfg = ddp_cfg("plain")
        cfg.DIST_BACKEND = backend
        t0 = time.perf_counter()
        misc.launch_job(cfg, f"file://{out}/group", functools.partial(
            ddp_rank, names=names, out_dir=out), "cuda", timeout=120,
            join_timeout=900)
        print(f"{DDP_RANKS} ranks over {backend} on {cards} card(s): "
              f"{time.perf_counter() - t0:.1f} s for {list(names)} (spawn "
              "and model builds included)")
        got = {n: torch.load(os.path.join(out, f"{n}.pt"), weights_only=False)
               for n in names}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    silent = dict.fromkeys(k1k2_kernels(k1, k2) + mvit_kernel_names(k5, k8),
                           0)
    for name in names:
        micro = DDP_STEPS[name] * got[name]["accum"]
        expected = dict(silent)
        expected.update({k1.KERNEL: DEPTH * micro,
                         k1.KERNEL_BWD_RECOMPUTE: DEPTH * micro})
        if name != "ek":  # EK's 32 frames take the plain temporal pass
            expected.update({k2.KERNEL: DEPTH * micro,
                             k2.KERNEL_BWD: DEPTH * micro})
        check_launches(got[name]["launches"], expected,
                       f"{name} on rank 0 of {DDP_RANKS}")
        lr = want["ek" if name == "ek" else "plain"]["history"][0]["lr"]
        same_training(torch, f"{name} on {DDP_RANKS} ranks",
                      got[name], want["ek" if name == "ek" else "plain"], lr)
    one = want["plain"]["optimizer_bytes"]
    zero = got["zero"]["optimizer_bytes"]
    print(f"optimizer state: one process {one / 2 ** 20:.1f} MiB, rank 0 "
          f"under ZeRO-1 {zero / 2 ** 20:.1f} MiB ({100 * zero / one:.1f} %)")
    if zero >= 0.75 * one:
        fail("ZeRO-1 did not split the optimizer state")
    diff = max((got["zero"]["update"][n].float() - u.float()).abs().max()
               .item() for n, u in got["plain"]["update"].items())
    print(f"ZeRO-1 against the plain optimizer on {DDP_RANKS} ranks: largest "
          f"difference of the first step's update {diff:.3e}")
    del got, want

    t0 = time.perf_counter()
    with quiet():
        report = dryrun.dryrun_multichip(DDP_RANKS, "cuda")
    print(f"tools/dryrun.py on {DDP_RANKS} ranks: "
          f"{json.dumps(report)} ({time.perf_counter() - t0:.1f} s)")

    # run_net over NCCL at NUM_GPUS = the cards; one card is one NCCL rank
    # of its own group (launch_job keeps 1 x 1 a process with no group)
    cfg = coin_cfg("step_classification", *zero_shot_opts(
        "TEST.NUM_ENSEMBLE_VIEWS", "1", "NUM_GPUS", str(cards)))
    t0 = time.perf_counter()
    with job_dir(cfg) as job:
        if cards > 1:
            misc.launch_job(cfg, f"file://{job}/group", quiet_run_net,
                            "cuda", timeout=120, join_timeout=600)
        else:
            misc.spawn_group(misc.run_rank, 1, (
                quiet_run_net, cfg, f"file://{job}/group", "nccl", "cuda",
                120.0), timeout=600)
        with open(os.path.join(job, "stdout.log")) as f:
            logged = f.read()
    print(f"run_net over NCCL, {cards} rank(s): the zero-shot COIN test in "
          f"{time.perf_counter() - t0:.1f} s")
    if '"split": "test_final"' not in logged:
        fail("run_net over NCCL logged no final test stats")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "procedurevrl_torch")):
        print("chip_smoke: the procedurevrl_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from procedurevrl_torch.ops import _build
    from procedurevrl_torch.ops import depthwise_pool as k8
    from procedurevrl_torch.ops import flash_attention as fa
    from procedurevrl_torch.ops import mvit_attention as k5
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
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(report)} (parallel nvcc)")
    for name, rep in report.items():
        for line in rep["ptxas"].splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    eval_kernels = [timed("2 K1f", phase_k1, torch, F, k1),
                    timed("3 K2f", phase_k2, torch, F, k2)]
    train_kernels = (timed("4 K1sp/K1b", phase_k1_train, torch, F, k1)
                     + [timed("5 K2b", phase_k2_train, torch, F, k2)])
    mvit_kernels = timed("8 K5/K6", phase_mvit_kernels, torch, F, k5)
    knob_kernels = (timed("10 K8", phase_pool_kernels, torch, F, k8)
                    + timed("10 K7", phase_kt_kernels, torch, F, k5))
    launches = timed("6 slice 1", phase_slice, torch, k1, k2, k5, k8, _build)
    for rec in eval_kernels:
        rec["launches"] = launches.get(rec["name"], 0)
    launches = timed("7 slice 2", phase_train, torch, k1, k2, k5, k8, _build)
    for rec in train_kernels:
        rec["launches"] = launches.get(rec["name"], 0)
    launches = timed("9 slice 3", phase_mvit_train, torch, k1, k2, k5, k8,
                     _build)
    for rec in mvit_kernels:
        rec["launches"] = launches.get(rec["name"], 0)
    launches = timed("11 slice 4", phase_knob_train, torch, k1, k2, k5, k8,
                     _build)
    for rec in knob_kernels:
        rec["launches"] = launches.get(rec["name"], 0)
        if not rec["launches"]:
            fail(f"{rec['name']} was not launched on the slice 4 path")
    ts_knob_kernels = (timed("12 K1br/K1bd/K1p", phase_k1_knobs, torch, F, k1)
                       + timed("13 K2v3", phase_k2_v3, torch, F, k2))
    by_name = {rec["name"]: rec for rec in ts_knob_kernels}
    launches = timed("14 slice 5 eval", phase_slice, torch, k1, k2, k5, k8,
                     _build, TS_EVAL_KNOBS)
    by_name[k1.KERNEL_PIPE]["launches"] = launches.get(k1.KERNEL_PIPE, 0)
    launches = timed("15 slice 5 route A", phase_ts_knob_train, torch, k1, k2,
                     k5, k8, _build, "route A", ROUTE_A,
                     {k1.KERNEL_PIPE: DEPTH, k1.KERNEL_BWD_RECOMPUTE: DEPTH,
                      k2.KERNEL_V3: DEPTH, k2.KERNEL_V3_BWD: DEPTH}, True)
    for key in (k1.KERNEL_BWD_RECOMPUTE, k2.KERNEL_V3, k2.KERNEL_V3_BWD):
        by_name[key]["launches"] = launches.get(key, 0)
    launches = timed("16 slice 5 route B", phase_ts_knob_train, torch, k1, k2,
                     k5, k8, _build, "route B", ROUTE_B,
                     {k1.KERNEL_PROBS: DEPTH, k1.KERNEL_BWD_DELTA: DEPTH,
                      k2.KERNEL: DEPTH, k2.KERNEL_BWD: DEPTH}, True)
    by_name[k1.KERNEL_BWD_DELTA]["launches"] = launches.get(
        k1.KERNEL_BWD_DELTA, 0)
    for rec in ts_knob_kernels:
        if not rec["launches"]:
            fail(f"{rec['name']} was not launched on the slice 5 path")
    route_kernels = timed("17 K5bd/K6bd/K6sp/K6bs", phase_mvit_knob_kernels,
                          torch, F, k5)
    by_name = {rec["name"]: rec for rec in route_kernels}
    n, hl, hs = ROUTE_STEPS, MVIT_HL_BLOCKS, MVIT_HS_BLOCKS
    # remat keeps the forward kernels' outputs: each K6 block runs K6sp
    # (route D) or K6f (route C) once a step
    launches = timed("18 slice 6 route C", phase_route_train, torch, k1, k2,
                     k5, k8, _build, "MViT route C", ROUTE_C,
                     {k5.KERNEL_HL: hl * n, k5.KERNEL: hs * n,
                      k5.KERNEL_HL_BWD_DELTA: hl * n,
                      k5.KERNEL_BWD_DELTA: hs * n})
    for key in (k5.KERNEL_HL_BWD_DELTA, k5.KERNEL_BWD_DELTA):
        by_name[key]["launches"] = launches.get(key, 0)
    launches = timed("19 slice 6 route D", phase_route_train, torch, k1, k2,
                     k5, k8, _build, "MViT route D", ROUTE_D,
                     {k5.KERNEL_HL: hl * n, k5.KERNEL_PROBS: hs * n,
                      k5.KERNEL_HL_BWD_DELTA: hl * n,
                      k5.KERNEL_BWD_PROBS: hs * n})
    for key in (k5.KERNEL_PROBS, k5.KERNEL_BWD_PROBS):
        by_name[key]["launches"] = launches.get(key, 0)
    for rec in route_kernels:
        if not rec["launches"]:
            fail(f"{rec['name']} was not launched on the slice 6 path")
    flash_kernels = timed("20 K4/K3", phase_flash_kernels, torch, F, fa)
    long_kernels = timed("21 K1 long range", phase_k1_long, torch, F, k1, k2,
                         k5, k8, fa, _build)
    timed("22 slice 7 eval", phase_slice, torch, k1, k2, k5, k8, _build, None,
          SPACE_ONLY + ("TEST.NUM_ENSEMBLE_VIEWS", "1"), (fa.KERNEL,))
    launches = timed("23 slice 7 space_only", phase_ts_knob_train, torch, k1,
                     k2, k5, k8, _build, "space_only train", {},
                     {fa.KERNEL: DEPTH, fa.KERNEL_BWD: DEPTH}, True,
                     SPACE_ONLY, SLICE7_STEPS)
    by_name = {rec["name"]: rec for rec in flash_kernels}
    for key in (fa.KERNEL, fa.KERNEL_BWD):
        by_name[key]["launches"] = launches.get(key, 0)
    launches = timed("24 slice 7 split qkv", phase_ts_knob_train, torch, k1,
                     k2, k5, k8, _build, "SPATIAL_FUSED_QKV=0 train",
                     SPLIT_QKV, {fa.KERNEL_CLS: DEPTH,
                                 fa.KERNEL_CLS_BWD: DEPTH,
                                 k2.KERNEL: DEPTH, k2.KERNEL_BWD: DEPTH},
                     True, (), SLICE7_STEPS)
    for key in (fa.KERNEL_CLS, fa.KERNEL_CLS_BWD):
        by_name[key]["launches"] = launches.get(key, 0)
    for rec in flash_kernels + long_kernels:
        if not rec["launches"]:
            fail(f"{rec['name']} was not launched on the slice 7 path")
    head_dim_kernels = timed("25 TimeSformer 24 heads of 32",
                             phase_ts_heads_32, torch, F, k1, k2, k5, k8, fa,
                             _build)
    for rec in head_dim_kernels:
        if not rec["launches"]:
            fail(f"{rec['name']} was not launched on the 24-head step")
    timed("26 MViT heads of 72", phase_mvit_d72, torch, k1, k2, k5, k8,
          _build)
    timed("27 head dims past the tensor cores", phase_odd_head_dims, torch,
          fa, k5)
    timed("28 slice 14 forecasting", phase_forecast, torch, k1, k2, k5, k8,
          _build)
    timed("29 slice 14 MViT eval", phase_mvit_eval, torch, k1, k2, k5, k8,
          _build)
    timed("30 slice 14 COIN finetunes", phase_finetune, torch, k1, k2, k5,
          k8, _build)
    timed("31 slice 15 checkpoints", phase_checkpoints, torch, k1, k2, k5,
          k8, _build)
    clamp = {rec["name"]: rec for rec in eval_kernels + train_kernels
             + mvit_kernels}
    shift_kernels = timed("32 slice 16 shifts", phase_shifts, torch, k1, k2,
                          k5, k8, fa, _build, clamp)
    ek_kernel_recs = timed("33 slice 17 EPIC-Kitchens", phase_ek, torch, F,
                           k1, k2, k5, k8, _build)
    timed("34 slice 17 remat policies", phase_remat, torch, k1, k2, k5, k8,
          _build)
    timed("35 slice 18 host data pipeline", phase_loader, torch, k1, k2, k5,
          k8, _build)
    timed("36 slice 19 EPIC-Kitchens data, extract tools", phase_epic_data,
          torch, k1, k2, k5, k8, _build)
    timed("37 slice 19 data parallel", phase_ddp, torch, k1, k2, k5, k8,
          _build)
    kernels = (eval_kernels + train_kernels + mvit_kernels + knob_kernels
               + ts_knob_kernels + route_kernels + flash_kernels
               + long_kernels + head_dim_kernels + shift_kernels
               + ek_kernel_recs)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi_line)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
