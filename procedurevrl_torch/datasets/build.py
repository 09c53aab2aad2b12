"""Dataset registry (counterpart of ``procedurevrl_tpu/datasets/build.py``;
reference ``lib/datasets/build.py:5-31``)."""

from __future__ import annotations

from typing import Callable, Dict

DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls

    return deco


def build_dataset(dataset_name: str, cfg, split: str):
    """The dataset ``dataset_name`` names, capitalised as the reference does
    (``howto100m_develop`` -> ``Howto100m_develop``), for ``split``."""
    name = dataset_name.capitalize()
    if name not in DATASET_REGISTRY:
        raise KeyError(f"Unknown dataset {name}; registered: "
                       f"{list(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name](cfg, split)
