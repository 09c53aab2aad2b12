"""Logging (counterpart of ``procedurevrl_tpu/utils/logging.py``; reference
``lib/utils/logging.py:18-95``).

The port logs through one logger, ``procedurevrl_torch``.  Until
:func:`setup_logging` runs it has no handler of its own (Python's last
resort prints warnings to stderr); the entry points call it with
``OUTPUT_DIR``, which puts the logger on stdout and, with a directory, on
``OUTPUT_DIR/stdout.log`` too.  Stats are logged as ``json_stats: {...}``
lines, the reference's format, so log-scraping tools keep working.  In a
group of processes only rank 0 logs (reference ``logging.py:36-57``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict

from procedurevrl_torch.parallel.collectives import is_master_proc

NAME = "procedurevrl_torch"
_FORMAT = logging.Formatter(
    "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s",
    datefmt="%m/%d %H:%M:%S")


class _Stdout(logging.StreamHandler):
    """A handler on whatever ``sys.stdout`` is when a record is emitted, so
    that a redirected or captured stdout that has since closed is never
    written to."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, _value) -> None:
        pass


def setup_logging(output_dir: str = "") -> logging.Logger:
    """Put the port's logger on stdout, and on ``output_dir/stdout.log``
    where ``output_dir`` is given; on a rank other than 0 nowhere.  A
    second call replaces the handlers of the first instead of stacking
    them (JAX ``utils/logging.py:43-67``)."""
    logger = logging.getLogger(NAME)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    if not is_master_proc():
        logger.addHandler(logging.NullHandler())
        return logger
    handlers = [_Stdout()]
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(output_dir, "stdout.log")))
    for handler in handlers:
        handler.setFormatter(_FORMAT)
        logger.addHandler(handler)
    return logger


def get_logger(name: str = "") -> logging.Logger:
    """The port's logger (one for every module, as in JAX)."""
    del name
    return logging.getLogger(NAME)


def log_json_stats(stats: Dict[str, Any]) -> None:
    """One ``json_stats: {...}`` line, floats rounded to 5 places, keys
    sorted (reference ``lib/utils/logging.py:83-95``)."""
    stats = {k: round(v, 5) if isinstance(v, float) else v
             for k, v in stats.items()}
    get_logger().info("json_stats: %s", json.dumps(stats, sort_keys=True))
