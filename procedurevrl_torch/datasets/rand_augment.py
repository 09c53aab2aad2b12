"""RandAugment for video clips (counterpart of
``procedurevrl_tpu/datasets/rand_augment.py``; reference
``lib/datasets/autoaugment.py``, timm's ``rand-m*-n*-mstd*`` policy).

The ops run on uint8 RGB frames through PIL, and one clip takes the same
sampled ops and magnitudes on every frame (timm's video semantics, the
EPIC finetune's, reference ``lib/datasets/epickitchens.py:149-162``).  The
draws come from the sample's ``RandomState`` in JAX's order: the op
indices, then per op its magnitude and its level's sign.  PIL is imported
where an op runs, not when the module is.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

_MAX_LEVEL = 10.0
_FILL = (124, 116, 104)


def _pil():
    from PIL import Image, ImageEnhance, ImageOps

    return Image, ImageEnhance, ImageOps


def _randomly_negate(v: float, rng) -> float:
    return -v if rng.uniform() > 0.5 else v


def _rotate(img, deg):
    return img.rotate(deg, fillcolor=_FILL)


def _affine(img, coeffs):
    Image = _pil()[0]
    return img.transform(img.size, Image.AFFINE, coeffs, fillcolor=_FILL)


def _shear_x(img, f):
    return _affine(img, (1, f, 0, 0, 1, 0))


def _shear_y(img, f):
    return _affine(img, (1, 0, 0, f, 1, 0))


def _translate_x(img, pct):
    return _affine(img, (1, 0, pct * img.size[0], 0, 1, 0))


def _translate_y(img, pct):
    return _affine(img, (1, 0, 0, 0, 1, pct * img.size[1]))


def _enhance(name: str) -> Callable:
    def op(img, f):
        return getattr(_pil()[1], name)(img).enhance(f)
    return op


def _ops(name: str) -> Callable:
    def op(img, arg):
        fn = getattr(_pil()[2], name)
        return fn(img) if arg is None else fn(img, int(arg))
    return op


def _level_30deg(level, rng):
    return _randomly_negate(level / _MAX_LEVEL * 30.0, rng)


def _level_09(level, rng):
    return 1.0 + _randomly_negate(level / _MAX_LEVEL * 0.9, rng)


def _level_shear(level, rng):
    return _randomly_negate(level / _MAX_LEVEL * 0.3, rng)


def _level_translate(level, rng):
    return _randomly_negate(level / _MAX_LEVEL * 0.45, rng)


# name -> (op(img, arg), level(magnitude, rng) -> arg, or None: no arg);
# the order is the draw's (JAX rand_augment.py:_OPS)
OPS: Dict[str, Tuple[Callable, Optional[Callable]]] = {
    "AutoContrast": (_ops("autocontrast"), None),
    "Equalize": (_ops("equalize"), None),
    "Invert": (_ops("invert"), None),
    "Rotate": (_rotate, _level_30deg),
    # timm's 'rand' policy: 4..8 bits
    "Posterize": (_ops("posterize"),
                  lambda level, rng: 4 + int((level / _MAX_LEVEL) * 4)),
    "Solarize": (_ops("solarize"),
                 lambda level, rng: int((level / _MAX_LEVEL) * 256)),
    "Color": (_enhance("Color"), _level_09),
    "Contrast": (_enhance("Contrast"), _level_09),
    "Brightness": (_enhance("Brightness"), _level_09),
    "Sharpness": (_enhance("Sharpness"), _level_09),
    "ShearX": (_shear_x, _level_shear),
    "ShearY": (_shear_y, _level_shear),
    "TranslateX": (_translate_x, _level_translate),
    "TranslateY": (_translate_y, _level_translate),
}


class RandAugment:
    """The ``rand-mM-nN-mstdS`` policy applied clip-consistently."""

    def __init__(self, magnitude: int = 9, num_layers: int = 2,
                 magnitude_std: float = 0.5):
        self.magnitude = magnitude
        self.num_layers = num_layers
        self.magnitude_std = magnitude_std
        self.op_names = list(OPS)

    @classmethod
    def from_config_str(cls, config: str) -> "RandAugment":
        """Parse timm's ``rand-m9-n2-mstd0.5``; a part left out keeps its
        default (m 9, n 2, mstd 0.5)."""
        m, n, mstd = 9, 2, 0.5
        for part in config.split("-")[1:]:
            if part.startswith("mstd"):
                mstd = float(part[4:])
            elif part.startswith("m"):
                m = int(part[1:])
            elif part.startswith("n"):
                n = int(part[1:])
        return cls(m, n, mstd)

    def plan(self, rng: np.random.RandomState):
        """The clip's ops and their arguments, drawn from ``rng``."""
        chosen = [self.op_names[i] for i in
                  rng.randint(0, len(self.op_names), self.num_layers)]
        plans = []
        for name in chosen:
            fn, level_fn = OPS[name]
            mag = self.magnitude
            if self.magnitude_std > 0:
                mag = min(_MAX_LEVEL, max(0, rng.normal(mag,
                                                        self.magnitude_std)))
            plans.append((fn, level_fn(mag, rng) if level_fn else None))
        return plans

    def __call__(self, frames: np.ndarray,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        """frames [T, H, W, C] uint8 -> the same, augmented."""
        Image = _pil()[0]
        plans = self.plan(rng or np.random)
        out = []
        for frame in frames:
            img = Image.fromarray(frame)
            for fn, arg in plans:
                img = fn(img, arg)
            out.append(np.asarray(img))
        return np.stack(out)
