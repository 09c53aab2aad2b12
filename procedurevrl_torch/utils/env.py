"""Environment knobs: booleans (the port's own copy of JAX
``utils/env.py:env_flag``) and integers."""

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


def env_int(name: str, default: int, minimum: int = 1) -> int:
    """Read an integer environment knob: unset or empty gives ``default``;
    a value that is not an integer, or is below ``minimum``, raises."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        value = int(raw.strip())
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None
    if value < minimum:
        raise ValueError(f"{name}={value} is below {minimum}")
    return value
