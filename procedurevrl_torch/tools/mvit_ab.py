"""Time the MViT attention kernels on one CUDA card: the backward pair's
two passes apart, and an A/B of every MViT kernel against another
checkout.

    python -m procedurevrl_torch.tools.mvit_ab [--ab DIR]

Without ``--ab``, for each backward case of :data:`CASES` (K5b / K6b and
its variants K5bd, K6bd, K7b, K6bs at the MViT-v2-S shapes of
``chip_smoke.py``'s kernel phases, 18 clips, bf16) it prints the time of
the query-major pass and of the key-major pass (with its reduction)
separately, from CUDA events around each pass, through the timing-only
entry point of the library (``mvit_attention_bwd_time``); each kernel's
registers and local (spill) bytes from ``cudaFuncGetAttributes`` and its
resident CTAs per SM from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.

With ``--ab DIR`` (another checkout of the repository, for example an
unpacked ``git archive`` of an earlier commit) it times every case of
:data:`CASES`, forwards and backwards, through the kernel wrappers of
``ops/mvit_attention.py`` in four processes, in the order DIR, this tree,
this tree, DIR; each process imports the wrappers of its own checkout and
builds its kernels there.  Both sides read the same inputs (made from one
seed) and must have the same wrapper signatures.  The speed-up of a case is
the ratio of the two sides' means.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# (label, kind, variant, head-last, batch, heads, qN, k_shape); kind "fwd"
# (variant 0 K5f / K6f, 1 K7f, 3 K6sp) or "bwd" (variant 0 K5b / K6b, 1
# K7b, 2 K5bd / K6bd, 3 K6bs: the ``enum Bwd`` of the source); a head-split
# case has one head per slice
CASES = (("K5f block 0", "fwd", 0, True, 18, 1, 25088, (8, 7, 7)),
         ("K5f block 4", "fwd", 0, True, 18, 4, 1568, (8, 7, 7)),
         ("K6f block 1", "fwd", 0, False, 36, 1, 6272, (8, 14, 14)),
         ("K6sp block 1", "fwd", 3, False, 36, 1, 6272, (8, 14, 14)),
         ("K7f block 1", "fwd", 1, True, 18, 2, 6272, (8, 14, 14)),
         ("K7f block 3", "fwd", 1, True, 18, 4, 1568, (8, 14, 14)),
         ("K5b block 0", "bwd", 0, True, 18, 1, 25088, (8, 7, 7)),
         ("K5b block 4", "bwd", 0, True, 18, 4, 1568, (8, 7, 7)),
         ("K6b block 1", "bwd", 0, False, 36, 1, 6272, (8, 14, 14)),
         ("K5bd block 0", "bwd", 2, True, 18, 1, 25088, (8, 7, 7)),
         ("K6bd block 1", "bwd", 2, False, 36, 1, 6272, (8, 14, 14)),
         ("K7b block 1", "bwd", 1, True, 18, 2, 6272, (8, 14, 14)),
         ("K6bs block 1", "bwd", 3, False, 36, 1, 6272, (8, 14, 14)))
HEAD_DIM = 96
SCALE = HEAD_DIM ** -0.5


def case_inputs(torch, k5, variant, head_last, b, heads, qn, k_shape,
                seed=0):
    """q, k, v, kc, vc, rel, g ([B, L, H*96]) and the backward residuals of
    the variant from its plain forward: (out, stats, probs)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kn, kcat = k_shape[0] * k_shape[1] * k_shape[2], sum(k_shape)
    c = heads * HEAD_DIM

    def r(*shape):
        return (0.5 * torch.randn(*shape, generator=gen, device="cuda")
                ).to(torch.bfloat16)

    x = [r(b, qn, c), r(b, kn, c), r(b, kn, c), r(b, 1, c), r(b, 1, c),
         r(b, qn, heads * kcat), r(b, qn, c)]
    probs = None
    with torch.no_grad():
        if variant == 1:
            out, stats = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape, heads,
                                                        SCALE)
        elif variant == 3:
            out, stats, probs = k5.mvit_attention_fwd_probs_plain(
                *x[:6], k_shape, SCALE)
        elif head_last:
            out, stats = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, heads,
                                                        SCALE)
        else:
            out, stats = k5.mvit_attention_fwd_plain(*x[:6], k_shape, SCALE)
    return x, (out, stats.contiguous(), probs)


def wrapper_call(k5, kind, variant, head_last, x, res, heads, k_shape):
    """One call of the case's kernel through its wrapper (a closure)."""
    q, k, v, kc, vc, rel, g = x
    out, stats, probs = res
    if kind == "fwd":
        if variant == 1:
            return lambda: k5.mvit_attention_kt_fwd(q, k, v, kc, vc, rel,
                                                    k_shape, heads, SCALE)
        if variant == 3:
            return lambda: k5.mvit_attention_fwd_probs(q, k, v, kc, vc, rel,
                                                       k_shape, SCALE)
        if head_last:
            return lambda: k5.mvit_attention_hl_fwd(q, k, v, kc, vc, rel,
                                                    k_shape, heads, SCALE)
        return lambda: k5.mvit_attention_fwd(q, k, v, kc, vc, rel, k_shape,
                                             SCALE)
    if variant == 1:
        return lambda: k5.mvit_attention_kt_bwd(q, k, v, kc, vc, rel, out,
                                                stats, g, k_shape, heads, SCALE)
    if variant == 3:
        return lambda: k5.mvit_attention_bwd_probs(q, k, v, kc, vc, rel, probs,
                                                   g, k_shape, SCALE)
    if head_last:
        if variant == 2:
            return lambda: k5.mvit_attention_hl_bwd_delta(
                q, k, v, kc, vc, rel, stats, out, g, k_shape, heads, SCALE)
        return lambda: k5.mvit_attention_hl_bwd(q, k, v, kc, vc, rel, stats, g,
                                                k_shape, heads, SCALE)
    if variant == 2:
        return lambda: k5.mvit_attention_bwd_delta(q, k, v, kc, vc, rel, stats,
                                                   out, g, k_shape, SCALE)
    return lambda: k5.mvit_attention_bwd(q, k, v, kc, vc, rel, stats, g,
                                         k_shape, SCALE)


def events_ms(torch, fn, iters=10, reps=5) -> float:
    """Median device ms of one call (CUDA events around ``iters`` calls
    queued behind a device sleep, as ``chip_smoke.time_ms``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def split_times(torch) -> list:
    """Print the backward cases' query-major and key-major times with the
    kernels' registers, local bytes and CTAs per SM; returns one dict per
    case."""
    from procedurevrl_torch.ops import mvit_attention as k5

    rows = []
    for label, kind, variant, head_last, b, heads, qn, k_shape in CASES:
        if kind != "bwd":
            continue
        x, res = case_inputs(torch, k5, variant, head_last, b, heads, qn,
                             k_shape)
        qms, kms, info = k5.bwd_split_times(variant, *x[:6], *res, x[6],
                                            k_shape,
                                            heads if head_last else None)
        print(f"{label}: query-major {qms:.4f} ms, key-major {kms:.4f} ms "
              f"(sum {qms + kms:.4f}); CTAs/SM {info[0]} / {info[1]}, "
              f"registers {info[2]} / {info[3]}, local bytes {info[4]} / "
              f"{info[5]}", flush=True)
        rows.append({"case": label, "query_ms": qms, "key_ms": kms,
                     "info": info})
        del x, res
        torch.cuda.empty_cache()
    return rows


def wrapper_times(torch) -> dict:
    """{label: ms} of every case through the wrappers of the checkout on
    ``sys.path``."""
    from procedurevrl_torch.ops import mvit_attention as k5

    times = {}
    for label, kind, variant, head_last, b, heads, qn, k_shape in CASES:
        x, res = case_inputs(torch, k5, variant, head_last, b, heads, qn,
                             k_shape)
        times[label] = events_ms(torch, wrapper_call(
            k5, kind, variant, head_last, x, res, heads, k_shape))
        del x, res
        torch.cuda.empty_cache()
    return times


def ab(other: Path) -> list:
    """Time every case in ``other``, this tree, this tree, ``other`` (one
    process each) and print each case's four times and speed-up."""
    runs = []
    for side in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--time-in", str(side)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"mvit_ab: timing in {side} failed:\n"
                               + proc.stdout[-4000:] + proc.stderr[-4000:])
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    rows = []
    for label, *_ in CASES:
        a1, b1, b2, a2 = (run[label] for run in runs)
        old, new = (a1 + a2) / 2, (b1 + b2) / 2
        print(f"A/B {label}: other {a1:.4f} / {a2:.4f} ms, this {b1:.4f} / "
              f"{b2:.4f} ms, speed-up {old / new:.3f}x", flush=True)
        rows.append({"case": label, "other_ms": old, "this_ms": new})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="DIR", help="another checkout of the "
                    "repository to time the wrappers against")
    ap.add_argument("--time-in", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mvit_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.time_in:
        sys.path.insert(0, str(Path(args.time_in).resolve()))
        print(json.dumps(wrapper_times(torch)))
        return 0
    sys.path.insert(0, str(ROOT))
    if args.ab:
        ab(Path(args.ab).resolve())
    else:
        split_times(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
