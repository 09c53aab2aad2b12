"""Boolean environment knobs (the port's own copy of JAX
``utils/env.py:env_flag``)."""

from __future__ import annotations

import os

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def env_flag(name: str, default: bool) -> bool:
    """Read a boolean environment knob: unset or empty gives ``default``;
    0/1/true/false/yes/no/on/off (any case) give their value; anything else
    raises, so that a mistyped knob cannot select the default route
    unnoticed."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    low = raw.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise ValueError(f"{name}={raw!r} is not a recognized boolean "
                     f"({'/'.join(_TRUE)} or {'/'.join(_FALSE)})")
