from typing import Optional, Sequence

from .cfg_node import CfgNode
from .defaults import _assert_and_infer_cfg, get_cfg


def load_config(cfg_file: Optional[str] = None,
                opts: Sequence[str] = ()) -> CfgNode:
    """Defaults -> YAML overlay -> ``KEY VALUE`` overrides, validated after
    the merge (``procedurevrl_tpu/utils/parser.py:load_config`` without the
    JAX platform setup)."""
    cfg = get_cfg()
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(list(opts))
    return _assert_and_infer_cfg(cfg)


__all__ = ["CfgNode", "get_cfg", "load_config"]
