"""Show that ``chip_smoke.py``'s limits for the MViT forward kernels reject
a kernel that misses one key column.

    python -m procedurevrl_torch.tools.mutation_check

For each fault in :data:`MUTANTS` this copies the package and
``chip_smoke.py`` into a temporary directory, plants the fault in the copy
of ``csrc/mvit_attention.cu``, builds it, and holds K5f at MViT-v2-S block
0 (B 18, qN 25088, kN 392) and K6f at block 1 (B*H 36, qN 6272, kN 1568)
against their plain versions, with ``MVIT_FWD_TOL`` / ``ROWSUM_TOL`` and,
for comparison, with the looser ``BF16_TOL``.  The inputs are those of
``chip_smoke.py``'s kernel phase.  Exits non-zero unless ``MVIT_FWD_TOL``
and ``ROWSUM_TOL`` reject every mutant at both shapes.  Needs a CUDA card;
the repository's own sources are not modified.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the keep-mask of the exponentials in the kernels' tensor-core logits
# (``exp_logits8``): columns 0..kN-1 are body keys, column kN the cls key
_MASK = "s[e] = col + (e & 1) <= kn ? exp2f"
MUTANTS = {
    "cls column skipped": "s[e] = col + (e & 1) < kn ? exp2f",
    # the last body key lies in the ragged last key tile at both shapes
    "last body key skipped": ("s[e] = (col + (e & 1) <= kn && "
                              "col + (e & 1) != kn - 1) ? exp2f"),
}
SHAPES = (("block 0", True, 18, 1, 25088, (8, 7, 7)),
          ("block 1", False, 36, 1, 6272, (8, 14, 14)))


def check_copy() -> int:
    """In a mutated copy: the forward at both shapes against the plain
    versions; returns the number of (shape, output) pairs the strict limits
    let through."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from procedurevrl_torch.ops import _build
    from procedurevrl_torch.ops import mvit_attention as k5

    if not torch.cuda.is_available():
        raise SystemExit("mutation_check: needs a CUDA device")
    _build.build(["mvit_attention"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    scale = 96 ** -0.5
    missed = 0
    for label, head_last, b, heads, qn, k_shape in SHAPES:
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
        for name, got, want, strict in (("out", out, ref, cs.MVIT_FWD_TOL),
                                        ("rowsum", rs, ref_rs, cs.ROWSUM_TOL)):
            for limit, tol in (("strict", strict), ("bf16", cs.BF16_TOL)):
                try:
                    cs.compare(torch, f"  mutant {label} {name} ({limit})",
                               got, want, tol)
                    caught = False
                except SystemExit:
                    caught = True
                print(f"  -> {'rejected' if caught else 'let through'}")
                missed += limit == "strict" and not caught
    return missed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--in-copy", action="store_true",
                        help=argparse.SUPPRESS)
    if parser.parse_args(argv).in_copy:
        return 1 if check_copy() else 0
    failed = []
    for name, line in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(ROOT / "procedurevrl_torch",
                            Path(tmp) / "procedurevrl_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            cu = Path(tmp) / "procedurevrl_torch" / "csrc" / "mvit_attention.cu"
            src = cu.read_text()
            if src.count(_MASK) != 1:
                raise SystemExit(f"mutation_check: {_MASK!r} not found once")
            cu.write_text(src.replace(_MASK, line))
            print(f"mutant: {name}", flush=True)
            rc = subprocess.run([sys.executable, "-m",
                                 "procedurevrl_torch.tools.mutation_check",
                                 "--in-copy"], cwd=tmp).returncode
        if rc:
            failed.append(name)
    print(f"mutation_check: {len(MUTANTS) - len(failed)} of {len(MUTANTS)} "
          f"mutants rejected at both shapes"
          + (f"; let through: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
