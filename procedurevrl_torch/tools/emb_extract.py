"""CLIP text embeddings of a step vocabulary (counterpart of
``tools/emb_extract.py:23-82``; reference ``tools/emb_extract.py:9-60``).

Each step description fills the 28 prompt templates, the CLIP text tower
of an OpenAI CLIP checkpoint encodes them, and the bank row is their
mean: a ``[num_steps, embed_dim]`` float32 bank, saved as ``.npy`` and as
a tensor by ``torch.save`` (the ``.pth`` every zero-shot path reads).

    python -m procedurevrl_torch.tools.emb_extract \\
        --clip_ckpt ViT-B-16.pt --bpe bpe_simple_vocab_16e6.txt.gz \\
        --steps data/step_coin_text.txt --out data/clip_step_emb_coin.pth

The checkpoint is a state dict or a module with one (``visual.*`` is
dropped); its text keys are ``models/clip_text.py``'s names.  The tower
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Sequence, Union

import numpy as np
import torch

from procedurevrl_torch.datasets.tokenizer import build_tokenizer, tokenize
from procedurevrl_torch.models.clip_text import CLIPTextEncoder
from procedurevrl_torch.utils.device import resolve_device

PROMPTS = [
    t.format(stem=stem)
    for stem in ("a photo of", "a video of", "a example of",
                 "a demonstration of")
    for t in ("{stem} {{}}.", "{stem} a person {{}}.",
              "{stem} a person using {{}}.", "{stem} a person doing {{}}.",
              "{stem} a person during {{}}.",
              "{stem} a person performing {{}}.",
              "{stem} a person practicing {{}}.")
]
assert len(PROMPTS) == 28


def load_clip_text_tower(clip_ckpt: str,
                         device: Union[str, torch.device]) -> CLIPTextEncoder:
    """The text tower of an OpenAI CLIP checkpoint on ``device``, in
    float32: its geometry read from the tensors (heads of 64), its
    weights loaded strictly (keys the tower lacks, such as
    ``logit_scale``, are left)."""
    blob = torch.load(clip_ckpt, map_location="cpu", weights_only=False)
    sd = blob.state_dict() if hasattr(blob, "state_dict") else blob
    sd = {k: v for k, v in sd.items() if not k.startswith("visual.")}
    layers = 1 + max(int(k.split(".")[2]) for k in sd
                     if k.startswith("transformer.resblocks."))
    width = sd["ln_final.weight"].shape[0]
    model = CLIPTextEncoder(
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0], width=width,
        heads=width // 64, layers=layers,
        embed_dim=sd["text_projection"].shape[1])
    own = model.state_dict()
    model.load_state_dict({k: sd[k].float() for k in own}, strict=True)
    return model.to(device).eval()


def get_step_emb(input_step_list: Sequence[str], output_emb_file: str,
                 clip_ckpt: str, bpe_path: str = "",
                 device: Union[str, torch.device, None] = None) -> np.ndarray:
    """The bank of ``input_step_list``, saved to ``output_emb_file`` (the
    tensor) and beside it as ``.npy`` (JAX ``get_step_emb``)."""
    device = resolve_device(device)
    model = load_clip_text_tower(clip_ckpt, device)
    tokenizer = build_tokenizer(bpe_path)
    feats: List[np.ndarray] = []
    with torch.inference_mode():
        for x in input_step_list:
            ids = tokenize(tokenizer, [p.format(x) for p in PROMPTS],
                           truncate=True)
            embs = model(torch.from_numpy(ids).to(device)).float()
            feats.append(embs.mean(0, keepdim=True).cpu().numpy())
    bank = np.concatenate(feats, axis=0)
    np.save(os.path.splitext(output_emb_file)[0] + ".npy", bank)
    torch.save(torch.from_numpy(bank), output_emb_file)
    return bank


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", default="data/step_coin_text.txt",
                   help="newline-separated step descriptions")
    p.add_argument("--out", default="data/clip_step_emb_coin.pth")
    p.add_argument("--clip_ckpt", required=True,
                   help="OpenAI CLIP checkpoint (ViT-B/16 text tower)")
    p.add_argument("--bpe", default="", help="bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--device", default=None, help="cuda (default) or cpu.")
    args = p.parse_args(argv)
    with open(args.steps) as f:
        steps = [line.strip() for line in f if line.strip()]
    bank = get_step_emb(steps, args.out, args.clip_ckpt, args.bpe,
                        args.device)
    print(f"saved {bank.shape} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
