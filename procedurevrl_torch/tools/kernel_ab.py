"""Time the port's attention kernels on one CUDA card: each kernel of a
wrapper call apart, and an A/B of every case against another checkout.

    python -m procedurevrl_torch.tools.kernel_ab [--family pair|mvit|all]
        [--split-in DIR] [--ab DIR]

Two families of cases (bf16, the shapes of ``chip_smoke.py``'s kernel
phases): ``pair``, the key-tiled pair of ``ops/flash_attention.py`` as K4
(``[144, 197, 768]``), K3 (``[144, 196, 768]`` + CLS), K1's long range
(``[144, 256, 2304]`` + CLS, N + 1 = 257) and K2's function at head dim 32
(``[18, 8, 196, 2304]``, 24 heads), each forward and backward; ``mvit``,
the MViT kernels of ``ops/mvit_attention.py`` (K5f, K6f, K6sp, K7f and the
backward K5b / K6b with its variants K5bd, K6bd, K7b, K6bs) at MViT-v2-S's
blocks, 18 clips.

Without ``--ab`` it runs each case's wrapper under ``torch.profiler`` in
one process per checkout (this tree, or DIR with ``--split-in``) and
prints, for every CUDA kernel the call launches (the forward; the
backward's passes, the chunk sum), its device time per call and its
shared memory and block size (from the trace), and from the CUDA driver
on the built library's cubin (:func:`function_attributes`) its registers
per thread and local (spill) bytes, as ``cudaFuncGetAttributes`` gives
them, and its resident CTAs per SM at that launch, as
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them ("n/a"
where the toolkit lacks ``cuobjdump`` or ``c++filt``).

With ``--ab DIR`` (another checkout, for example an unpacked ``git
archive`` of an earlier commit) it times every case through the wrappers
in four processes, in the order DIR, this tree, this tree, DIR; each
process imports the wrappers of its own checkout and builds its kernels
there.  Both sides read the same inputs (made from one seed) and must have
the same wrapper signatures.  The speed-up of a case is the ratio of the
two sides' means, and the spread of a side the difference of its two
runs.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# (label, kind, variant, head-last, batch, heads, qN, k_shape); kind "fwd"
# (variant 0 K5f / K6f, 1 K7f, 3 K6sp) or "bwd" (variant 0 K5b / K6b, 1
# K7b, 2 K5bd / K6bd, 3 K6bs: the ``enum Bwd`` of the source); a head-split
# case has one head per slice
MVIT_CASES = (("K5f block 0", "fwd", 0, True, 18, 1, 25088, (8, 7, 7)),
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
MVIT_HEAD_DIM = 96
MVIT_SCALE = MVIT_HEAD_DIM ** -0.5

# (label, caller, kind, batch, rows, heads, head dim): the pair's callers
# K4 ([B, N, C] thirds of one projection), K3 (the same + CLS), K1's long
# range (the fused qkv [B, N, 3C] + CLS) and K2 (the time-major qkv [B, T,
# N, 3C]: rows = T, 196 positions)
PAIR_CASES = tuple(
    (f"{tag} {kind}", caller, kind, b, n, heads, d)
    for tag, caller, b, n, heads, d in (
        ("K4 [144,197,768]", "k4", 144, 197, 12, 64),
        ("K3 [144,196,768]+CLS", "k3", 144, 196, 12, 64),
        ("K1 long [144,256,2304]+CLS", "qkv", 144, 256, 12, 64),
        ("K2 d 32 [18,8,196,2304]", "temporal", 18, 8, 24, 32))
    for kind in ("fwd", "bwd"))
K2_POSITIONS = 196


def mvit_inputs(torch, k5, variant, head_last, b, heads, qn, k_shape,
                seed=0):
    """q, k, v, kc, vc, rel, g ([B, L, H*96]) and the backward residuals of
    the variant from its plain forward: (out, stats, probs)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kn, kcat = k_shape[0] * k_shape[1] * k_shape[2], sum(k_shape)
    c = heads * MVIT_HEAD_DIM

    def r(*shape):
        return (0.5 * torch.randn(*shape, generator=gen, device="cuda")
                ).to(torch.bfloat16)

    x = [r(b, qn, c), r(b, kn, c), r(b, kn, c), r(b, 1, c), r(b, 1, c),
         r(b, qn, heads * kcat), r(b, qn, c)]
    probs = None
    with torch.no_grad():
        if variant == 1:
            out, stats = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape, heads,
                                                        MVIT_SCALE)
        elif variant == 3:
            out, stats, probs = k5.mvit_attention_fwd_probs_plain(
                *x[:6], k_shape, MVIT_SCALE)
        elif head_last:
            out, stats = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape, heads,
                                                        MVIT_SCALE)
        else:
            out, stats = k5.mvit_attention_fwd_plain(*x[:6], k_shape,
                                                     MVIT_SCALE)
    return x, (out, stats.contiguous(), probs)


def mvit_call(torch, case):
    """One call of an MViT case's kernel through its wrapper (a closure)."""
    from procedurevrl_torch.ops import mvit_attention as k5

    _, kind, variant, head_last, b, heads, qn, k_shape = case
    x, (out, stats, probs) = mvit_inputs(torch, k5, variant, head_last, b,
                                         heads, qn, k_shape)
    q, k, v, kc, vc, rel, g = x
    s = MVIT_SCALE
    if kind == "fwd":
        if variant == 1:
            return lambda: k5.mvit_attention_kt_fwd(q, k, v, kc, vc, rel,
                                                    k_shape, heads, s)
        if variant == 3:
            return lambda: k5.mvit_attention_fwd_probs(q, k, v, kc, vc, rel,
                                                       k_shape, s)
        if head_last:
            return lambda: k5.mvit_attention_hl_fwd(q, k, v, kc, vc, rel,
                                                    k_shape, heads, s)
        return lambda: k5.mvit_attention_fwd(q, k, v, kc, vc, rel, k_shape, s)
    if variant == 1:
        return lambda: k5.mvit_attention_kt_bwd(q, k, v, kc, vc, rel, out,
                                                stats, g, k_shape, heads, s)
    if variant == 3:
        return lambda: k5.mvit_attention_bwd_probs(q, k, v, kc, vc, rel, probs,
                                                   g, k_shape, s)
    if head_last:
        if variant == 2:
            return lambda: k5.mvit_attention_hl_bwd_delta(
                q, k, v, kc, vc, rel, stats, out, g, k_shape, heads, s)
        return lambda: k5.mvit_attention_hl_bwd(q, k, v, kc, vc, rel, stats, g,
                                                k_shape, heads, s)
    if variant == 2:
        return lambda: k5.mvit_attention_bwd_delta(q, k, v, kc, vc, rel, stats,
                                                   out, g, k_shape, s)
    return lambda: k5.mvit_attention_bwd(q, k, v, kc, vc, rel, stats, g,
                                         k_shape, s)


def pair_call(torch, case, seed=0):
    """One call of a pair case through its wrapper (a closure), the
    backward fed the forward's l."""
    from procedurevrl_torch.ops import flash_attention as fa

    _, caller, kind, b, n, heads, d = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c, scale = heads * d, d ** -0.5

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    if caller == "temporal":
        qkv, g = r(b, n, K2_POSITIONS, 3 * c), r(b, n, K2_POSITIONS, c)
        if kind == "fwd":
            return lambda: fa.flash_attention_temporal_fwd(qkv, heads, scale)
        l = fa.flash_attention_temporal_fwd(qkv, heads, scale)[1]
        return lambda: fa.flash_attention_temporal_bwd(qkv, g, l, heads, scale)
    qkv, g = r(b, n, 3 * c), r(b, n, c)
    qkv_c, gc = r(b, 1, 3 * c), r(b, 1, c)
    if caller == "qkv":
        if kind == "fwd":
            return lambda: fa.flash_attention_qkv_fwd(qkv, qkv_c, heads, scale)
        l = fa.flash_attention_qkv_fwd(qkv, qkv_c, heads, scale)[2]
        return lambda: fa.flash_attention_qkv_bwd(qkv, qkv_c, g, gc, l, heads,
                                                  scale)
    x = qkv.split(c, dim=-1)
    if caller == "k3":
        xc = qkv_c.split(c, dim=-1)
        if kind == "fwd":
            return lambda: fa.flash_attention_cls_fwd(*x, *xc, heads, scale)
        l = fa.flash_attention_cls_fwd(*x, *xc, heads, scale)[2]
        return lambda: fa.flash_attention_cls_bwd(*x, *xc, g, gc, l, heads,
                                                  scale)
    if kind == "fwd":
        return lambda: fa.flash_attention_fwd(*x, heads, scale)
    l = fa.flash_attention_fwd(*x, heads, scale)[1]
    return lambda: fa.flash_attention_bwd(*x, g, l, heads, scale)


FAMILIES = {"pair": (PAIR_CASES, pair_call, "flash_attention"),
            "mvit": (MVIT_CASES, mvit_call, "mvit_attention")}
def family_cases(family: str, only: str = ""):
    """The cases of ``family`` whose label holds ``only``."""
    return [c for c in FAMILIES[family][0] if only in c[0]]


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


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespace and
    parameters: ``flash_fwd_wg<64>``."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    depth, out = 0, []
    for ch in name:  # drop the parameter list, keep template arguments
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()


def function_attributes(lib: Path, tmp: str):
    """A function (short kernel name, threads, shared bytes of a launch) ->
    (registers, local bytes, resident CTAs per SM) for the kernels of a
    built library, through the CUDA driver on the library's cubin
    (extracted by ``cuobjdump -xelf``, names from ``cuobjdump -res-usage``
    demangled by ``c++filt``): ``cuFuncGetAttribute``, the driver's
    ``cudaFuncGetAttributes``, and
    ``cuOccupancyMaxActiveBlocksPerMultiprocessor``.  None where the
    toolkit lacks cuobjdump or c++filt; the query gives None for a kernel
    it does not find."""
    dump_bin = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    if not (os.path.exists(dump_bin) and filt):
        return None
    subprocess.run([dump_bin, "-xelf", "all", str(lib)], cwd=tmp,
                   capture_output=True)
    dump = subprocess.run([dump_bin, "-res-usage", str(lib)],
                          capture_output=True, text=True).stdout
    mangled = re.findall(r"Function (\S+):", dump)
    names = subprocess.run([filt], input="\n".join(mangled) + "\n",
                           capture_output=True, text=True).stdout.splitlines()
    if len(names) != len(mangled):
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuInit(0)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    cu.cuModuleLoad.argtypes = [ctypes.POINTER(ptr), ctypes.c_char_p]
    cu.cuModuleGetFunction.argtypes = [ctypes.POINTER(ptr), ptr,
                                       ctypes.c_char_p]
    cu.cuFuncGetAttribute.argtypes = [ctypes.POINTER(cint), cint, ptr]
    cu.cuFuncSetAttribute.argtypes = [ptr, cint, cint]
    cu.cuOccupancyMaxActiveBlocksPerMultiprocessor.argtypes = [
        ctypes.POINTER(cint), ptr, cint, ctypes.c_size_t]
    funcs = {}
    for cubin in sorted(Path(tmp).glob("*.cubin")):
        mod = ptr()
        if cu.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()):
            continue
        for name, m in zip(names, mangled):
            f = ptr()
            if not cu.cuModuleGetFunction(ctypes.byref(f), mod, m.encode()):
                funcs.setdefault(short_name(name), f)

    def attr(f, which):
        v = cint()
        cu.cuFuncGetAttribute(ctypes.byref(v), which, f)
        return v.value

    def query(name: str, threads: int, smem: int):
        f = funcs.get(name)
        if f is None:
            return None
        # CU_FUNC_ATTRIBUTE_NUM_REGS 4, _LOCAL_SIZE_BYTES 3,
        # _SHARED_SIZE_BYTES 1 (static), _MAX_DYNAMIC_SHARED_SIZE_BYTES 8
        regs, local, dyn = attr(f, 4), attr(f, 3), max(smem - attr(f, 1), 0)
        cu.cuFuncSetAttribute(f, 8, dyn)
        n = cint()
        rc = cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(n), f, threads, dyn)
        return regs, local, n.value if rc == 0 else "n/a"

    return query


def split_times(torch, family: str, only: str = "", calls: int = 10) -> list:
    """Print every kernel of each case's wrapper call with its device time
    per call, registers, local bytes, shared memory and CTAs per SM (the
    checkout on ``sys.path``); returns one dict per case."""
    from torch.profiler import ProfilerActivity, profile

    from procedurevrl_torch.ops import _build

    _, make_call, source = FAMILIES[family]
    cases = family_cases(family, only)
    _build.build([source])
    rows = []
    torch.zeros(1, device="cuda")  # the runtime's context, current here
    with tempfile.TemporaryDirectory() as cubins:
        query = function_attributes(_build.library_path(source), cubins)
        for case in cases:
            fn = make_call(torch, case)
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            kernels = {}
            for ev in events:
                if ev.get("cat") != "kernel":
                    continue
                k = kernels.setdefault(short_name(ev["name"]),
                                       {"us": 0.0, "args": ev.get("args", {})})
                k["us"] += ev["dur"]
            found = []
            for name, k in kernels.items():
                args = k["args"]
                smem = args.get("shared memory", 0)
                block = args.get("block", [0, 1, 1])
                threads = block[0] * block[1] * block[2]
                got = query(name, threads, smem) if query else None
                regs, local, ctas = got or (
                    args.get("registers per thread", "n/a"), "n/a", "n/a")
                row = {"kernel": name, "ms": k["us"] / calls / 1000.0,
                       "registers": regs, "local_bytes": local,
                       "shared_bytes": smem, "threads": threads,
                       "ctas_per_sm": ctas}
                found.append(row)
                print(f"{case[0]}: {name} {row['ms']:.4f} ms, registers "
                      f"{regs}, local bytes {local}, shared {smem} B, "
                      f"{threads} threads, CTAs/SM {ctas}", flush=True)
            print(f"{case[0]}: all kernels "
                  f"{sum(r['ms'] for r in found):.4f} ms", flush=True)
            rows.append({"case": case[0], "kernels": found})
            del fn
            torch.cuda.empty_cache()
    return rows


def wrapper_times(torch, family: str, only: str = "") -> dict:
    """{label: ms} of every case through the wrappers of the checkout on
    ``sys.path``."""
    make_call = FAMILIES[family][1]
    times = {}
    for case in family_cases(family, only):
        fn = make_call(torch, case)
        times[case[0]] = events_ms(torch, fn)
        del fn
        torch.cuda.empty_cache()
    return times


def _in_checkout(side: Path, only: str, *args) -> str:
    """Run this tool in a fresh process on the checkout ``side``; its
    standard output."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--in", str(side), "--only", only, *args],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"kernel_ab: {args} in {side} failed:\n"
                           + proc.stdout[-4000:] + proc.stderr[-4000:])
    return proc.stdout


def ab(other: Path, family: str, only: str = "") -> list:
    """Time every case in ``other``, this tree, this tree, ``other`` (one
    process each) and print each case's four times and speed-up."""
    runs = [json.loads(_in_checkout(side, only, "--time", family).strip()
                       .splitlines()[-1])
            for side in (other, ROOT, ROOT, other)]
    rows = []
    for label, *_ in family_cases(family, only):
        a1, b1, b2, a2 = (run[label] for run in runs)
        old, new = (a1 + a2) / 2, (b1 + b2) / 2
        print(f"A/B {label}: other {a1:.4f} / {a2:.4f} ms, this {b1:.4f} / "
              f"{b2:.4f} ms, speed-up {old / new:.3f}x", flush=True)
        rows.append({"case": label, "other_ms": old, "this_ms": new,
                     "other_spread_ms": abs(a1 - a2),
                     "this_spread_ms": abs(b1 - b2)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("pair", "mvit", "all"),
                    default="all")
    ap.add_argument("--ab", metavar="DIR", help="another checkout of the "
                    "repository to time the wrappers against")
    ap.add_argument("--split-in", metavar="DIR", help="time the kernels of "
                    "another checkout apart (default: this tree)")
    ap.add_argument("--only", metavar="TEXT", default="",
                    help="the cases whose label holds TEXT")
    ap.add_argument("--in", dest="in_dir", metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", choices=sorted(FAMILIES), help=argparse.SUPPRESS)
    ap.add_argument("--split", choices=sorted(FAMILIES),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.in_dir:
        sys.path.insert(0, str(Path(args.in_dir).resolve()))
        if args.time:
            print(json.dumps(wrapper_times(torch, args.time, args.only)))
        else:
            print(json.dumps(split_times(torch, args.split, args.only)))
        return 0
    families = sorted(FAMILIES) if args.family == "all" else [args.family]
    for family in families:
        if args.ab:
            ab(Path(args.ab).resolve(), family, args.only)
        else:
            side = Path(args.split_in).resolve() if args.split_in else ROOT
            out = _in_checkout(side, args.only, "--split", family)
            print("\n".join(line for line in out.splitlines()
                            if not line.startswith("[")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
