"""CLIP text tokenization, context length 77 with SOT/EOT framing
(counterpart of ``procedurevrl_tpu/datasets/tokenizer.py``).

The reference calls ``clip.tokenize`` (external OpenAI package) on ASR
sentences (reference ``lib/datasets/howto100m.py:393``).  Two backends:

- ``BPETokenizer``: the standard CLIP byte-level BPE, loading the
  ``bpe_simple_vocab_16e6.txt.gz`` merges file from ``DATA.BPE_PATH`` —
  numerically identical token ids to ``clip.tokenize`` when given the same
  vocab file;
- ``HashTokenizer``: a deterministic hashing fallback for environments
  without the vocab file (smoke tests, dummy-data runs) — NOT CLIP ids.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = VOCAB_SIZE - 2  # 49406  <|startoftext|>
EOT = VOCAB_SIZE - 1  # 49407  <|endoftext|>


@lru_cache()
def bytes_to_unicode():
    """GPT-2 reversible byte <-> unicode mapping (standard algorithm)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class BPETokenizer:
    """CLIP's byte-level BPE over a merges file."""

    def __init__(self, bpe_path: str):
        assert os.path.exists(bpe_path), bpe_path
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # CLIP's exact pre-tokenization pattern (needs the `regex` module
        # for \p{L}/\p{N}); falls back to ASCII classes without it, which
        # deviates on non-ASCII letters/digits.
        try:
            import regex

            self.pat = regex.compile(
                r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
                regex.IGNORECASE,
            )
        except ImportError:
            self.pat = re.compile(
                r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
                re.IGNORECASE,
            )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens


class HashTokenizer:
    """Deterministic non-CLIP fallback: stable hash of each whitespace word
    into [1, SOT). Only for smoke/dummy runs."""

    def encode(self, text: str) -> List[int]:
        import hashlib

        out = []
        for w in whitespace_clean(basic_clean(text)).lower().split(" "):
            if not w:
                continue
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            out.append(1 + h % (SOT - 1))
        return out


def build_tokenizer(bpe_path: str = "", allow_fallback: bool = False):
    """CLIP BPE tokenizer from a merges file.

    A missing merges file hard-fails unless ``allow_fallback`` (dummy/smoke
    runs only): silently hashing words would feed garbage token ids to the
    CLIP teacher and corrupt the pretraining signal
    (reference bundles the file with the clip package,
    ``lib/datasets/howto100m.py:393``; see DATASET.md for fetching it).
    """
    if bpe_path and os.path.exists(bpe_path):
        return BPETokenizer(bpe_path)
    if not allow_fallback:
        raise FileNotFoundError(
            f"DATA.BPE_PATH={bpe_path!r} not found; fetch "
            "bpe_simple_vocab_16e6.txt.gz (see DATASET.md) or set "
            "DEV.LOAD_DUMMY_DATA for synthetic smoke runs"
        )
    return HashTokenizer()


def tokenize(tokenizer, texts, context_length: int = CONTEXT_LENGTH,
             truncate: bool = True) -> np.ndarray:
    """``clip.tokenize`` semantics: [SOT] + bpe + [EOT], zero-padded to 77;
    truncate keeps the EOT at position 76."""
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), np.int64)
    for i, text in enumerate(texts):
        tokens = [SOT] + tokenizer.encode(text) + [EOT]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = EOT
            else:
                raise RuntimeError(f"Input {text} too long for context length")
        result[i, : len(tokens)] = tokens
    return result
