"""Per-sample random streams of the datasets (counterpart of
``procedurevrl_tpu/datasets/rng.py``).

The reference draws fresh global randomness in every ``__getitem__``
(reference ``lib/datasets/howto100m.py:476-520``).  The threaded loader
cannot share global state without races, so each sample gets its own
``np.random.RandomState``, seeded from stable inputs:

- test mode: the raw index alone, so multi-view ensembles repeat from run
  to run;
- train and val: the loader's epoch (``set_epoch``) and the raw index
  (before any ``TRAIN.EPOCH_MUL`` fold), so augmentation and ASR windows
  change between epochs and between the repeats of one clip.

A sample's draws depend only on (``RNG_SEED`` through the loader's
order, epoch, raw index), never on thread timing: a resumed run sees the
batches of the straight one.  ``stable_hash`` replaces Python's
``hash()``, which is salted per process.
"""

from __future__ import annotations

import zlib

import numpy as np


def stable_hash(s: str) -> int:
    """Process-stable 31-bit hash of a string (crc32, not ``hash()``)."""
    return zlib.crc32(s.encode("utf-8")) & 0x7FFFFFFF


class EpochRNG:
    """Mixin: epoch-aware per-sample ``RandomState``; ``Loader.set_epoch``
    passes the epoch down (reference ``loader.py:142-160``)."""

    _epoch: int = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def sample_rng(self, index: int, salt: int,
                   deterministic: bool) -> np.random.RandomState:
        """The ``RandomState`` of one ``__getitem__`` call: ``index`` is the
        raw dataset index, ``salt`` an odd per-dataset multiplier,
        ``deterministic`` True in test mode (seed from the index alone)."""
        if deterministic:
            seed = (index * salt) % 2**31
        else:
            seed = (index * salt + (self._epoch + 1) * 1_000_000_007) % 2**31
        return np.random.RandomState(seed)
