"""Show that ``chip_smoke.py``'s limits reject kernels with planted faults:
K5f/K6f and K7f missing key columns, K8f missing a halo plane and K8dw
missing a batch.

    python -m procedurevrl_torch.tools.mutation_check

For each fault in :data:`MUTANTS` this copies the package and
``chip_smoke.py`` into a temporary directory, plants the fault in the copy
of its CUDA source, builds it, and holds the mutated kernel at two
MViT-v2-S shapes of the 18-clip training step against its plain version,
with ``chip_smoke.py``'s limit and, for comparison, with the looser
``BF16_TOL``.  The inputs are those of ``chip_smoke.py``'s kernel phases:
K5f at block 0 (B 18, qN 25088, kN 392) and K6f at block 1 (B*H 36, qN
6272, kN 1568), out against ``MVIT_FWD_TOL`` and the row sums against
``ROWSUM_TOL``, each of which must reject; K7f at blocks 1 and 3 (kN 1568,
so the last key tile is ragged), out against ``MVIT_FWD_TOL`` and lse
against ``LSE_TOL``; K8f at blocks 0 and 4 against ``POOL_TOL``; K8dw at
blocks 0 and 4 against the fp32 limit scaled by the largest gradient.  For
K7 and K8 the mutant counts as rejected at a shape when the check of that
shape fails, as ``chip_smoke.py`` then fails.  Exits non-zero unless the
limits reject every mutant at both shapes.  Needs a CUDA card; the
repository's own sources are not modified.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the keep-mask of the exponentials in the K5/K6 tensor-core logits
# (``exp_logits8``): columns 0..kN-1 are body keys, column kN the cls key
_MASK = "s[e] = col + (e & 1) <= kn ? exp2f"
# the keep-mask of K7's logits (``logits8``) and its loop over key tiles
_KT_MASK = "s[e] = col + (e & 1) <= kn ? fmaf"
_KT_TILES = "for (int j0 = 0; j0 < kcols; j0 += BN) {"
# K8f's bounds check of the input plane t + dt - 1, and K8dw's last position
_POOL_PLANE = "if (ti < 0 || ti > g.t - 1) continue;"
_DW_END = "min(p0 + per_block, g.npos)"


@dataclass(frozen=True)
class Mutant:
    source: str   # file under csrc/
    anchor: str   # text planted over, found once in the source
    line: str     # what replaces it
    check: str    # the check run in the copy (a key of CHECKS)


MUTANTS = {
    "cls column skipped": Mutant(
        "mvit_attention.cu", _MASK, "s[e] = col + (e & 1) < kn ? exp2f",
        "mvit"),
    # the last body key lies in the ragged last key tile at both shapes
    "last body key skipped": Mutant(
        "mvit_attention.cu", _MASK,
        "s[e] = (col + (e & 1) <= kn && col + (e & 1) != kn - 1) ? exp2f",
        "mvit"),
    "K7f cls column skipped": Mutant(
        "mvit_attention.cu", _KT_MASK, "s[e] = col + (e & 1) < kn ? fmaf",
        "kt"),
    # kN + 1 = 1569 keys: the last tile holds keys 1536..1567 and the cls
    "K7f ragged last key tile skipped": Mutant(
        "mvit_attention.cu", _KT_TILES,
        "for (int j0 = 0; j0 + BN <= kcols; j0 += BN) {", "kt"),
    # output plane T-2 loses its taps on plane T-1
    "K8f halo plane T-1 skipped": Mutant(
        "depthwise_pool.cu", _POOL_PLANE,
        "if (ti < 0 || ti > g.t - 1 || (dt == 2 && ti == g.t - 1)) continue;",
        "pool"),
    "K8dw last batch dropped": Mutant(
        "depthwise_pool.cu", _DW_END,
        "min(p0 + per_block, g.npos - g.npos / g.b)", "pool_dw"),
}


def _judge(cs, torch, label, pairs, need_all: bool) -> bool:
    """Compare each (name, got, want, limit) with its limit and with
    ``BF16_TOL``; returns whether the limits reject the mutant at this
    shape (every limit if ``need_all``, else any)."""
    caught = []
    for name, got, want, strict in pairs:
        for limit, tol in (("strict", strict), ("bf16", cs.BF16_TOL)):
            try:
                cs.compare(torch, f"  mutant {label} {name} ({limit})", got,
                           want, tol)
                hit = False
            except SystemExit:
                hit = True
            print(f"  -> {'rejected' if hit else 'let through'}")
            if limit == "strict":
                caught.append(hit)
    return all(caught) if need_all else any(caught)


def _check_mvit(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 96 ** -0.5
    for label, head_last, b, heads, qn, k_shape in (
            ("block 0", True, 18, 1, 25088, (8, 7, 7)),
            ("block 1", False, 36, 1, 6272, (8, 14, 14))):
        x = cs.mvit_inputs(torch, gen, b, heads, qn, k_shape, torch.bfloat16)
        if head_last:
            out, rs = k5.mvit_attention_hl_fwd(*x[:6], k_shape, heads, scale)
            ref, ref_rs = k5.mvit_attention_hl_fwd_plain(*x[:6], k_shape,
                                                         heads, scale)
        else:
            out, rs = k5.mvit_attention_fwd(*x[:6], k_shape, scale)
            ref, ref_rs = k5.mvit_attention_fwd_plain(*x[:6], k_shape, scale)
        print(f"{label}: |out| mean {ref.float().abs().mean().item():.3e}, "
              f"max {ref.float().abs().max().item():.3e}")
        yield _judge(cs, torch, label, [("out", out, ref, cs.MVIT_FWD_TOL),
                                        ("rowsum", rs, ref_rs,
                                         cs.ROWSUM_TOL)], True)


def _check_kt(cs, torch, gen):
    from procedurevrl_torch.ops import mvit_attention as k5

    scale = 96 ** -0.5
    for label, heads, qn in (("block 1", 2, 6272), ("block 3", 4, 1568)):
        k_shape = (8, 14, 14)
        x = cs.mvit_inputs(torch, gen, 18, heads, qn, k_shape,
                           torch.bfloat16)
        out, lse = k5.mvit_attention_kt_fwd(*x[:6], k_shape, heads, scale)
        ref, ref_lse = k5.mvit_attention_kt_fwd_plain(*x[:6], k_shape, heads,
                                                      scale)
        print(f"{label}: |out| mean {ref.float().abs().mean().item():.3e}")
        yield _judge(cs, torch, label, [("out", out, ref, cs.MVIT_FWD_TOL),
                                        ("lse", lse, ref_lse, cs.LSE_TOL)],
                     False)


POOL_SHAPES = (("block 0", (8, 56, 56), 96), ("block 4", (8, 14, 14), 384))


def _check_pool(cs, torch, gen):
    from procedurevrl_torch.ops import depthwise_pool as k8

    for label, thw, c in POOL_SHAPES:
        x, w, _ = cs.pool_inputs(torch, gen, 18, thw, c, torch.bfloat16)
        yield _judge(cs, torch, label, [
            ("out", k8.depthwise_pool3d_fwd(x, w, 1),
             k8.depthwise_pool3d_taps(x, w, (1, 1, 1)), cs.POOL_TOL)], False)


def _check_pool_dw(cs, torch, gen):
    from procedurevrl_torch.ops import depthwise_pool as k8

    for label, thw, c in POOL_SHAPES:
        x, _, g = cs.pool_inputs(torch, gen, 18, thw, c, torch.bfloat16)
        ref = k8.taps_dw(x, g, (1, 1, 1))
        yield _judge(cs, torch, label, [
            ("dw", k8.depthwise_pool3d_dw(x, g), ref,
             cs.grad_tol(cs.FP32_TOL, ref))], False)


CHECKS = {"mvit": _check_mvit, "kt": _check_kt, "pool": _check_pool,
          "pool_dw": _check_pool_dw}


def check_copy(check: str) -> int:
    """In a mutated copy: the mutated kernel at both shapes against its
    plain version; returns the number of shapes the limits let through."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from procedurevrl_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("mutation_check: needs a CUDA device")
    _build.build(["mvit_attention", "depthwise_pool"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    return sum(not caught for caught in CHECKS[check](cs, torch, gen))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--in-copy", choices=sorted(CHECKS),
                        help=argparse.SUPPRESS)
    check = parser.parse_args(argv).in_copy
    if check:
        return 1 if check_copy(check) else 0
    failed = []
    for name, m in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(ROOT / "procedurevrl_torch",
                            Path(tmp) / "procedurevrl_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            cu = Path(tmp) / "procedurevrl_torch" / "csrc" / m.source
            src = cu.read_text()
            if src.count(m.anchor) != 1:
                raise SystemExit(f"mutation_check: {m.anchor!r} not found "
                                 f"once in {m.source}")
            cu.write_text(src.replace(m.anchor, m.line))
            print(f"mutant: {name}", flush=True)
            rc = subprocess.run([sys.executable, "-m",
                                 "procedurevrl_torch.tools.mutation_check",
                                 "--in-copy", m.check], cwd=tmp).returncode
        if rc:
            failed.append(name)
    print(f"mutation_check: {len(MUTANTS) - len(failed)} of {len(MUTANTS)} "
          f"mutants rejected at both shapes"
          + (f"; let through: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
