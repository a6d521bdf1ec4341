"""Structured logging (the JAX package's ``utils/log.py``; it replaces
the reference's std::cout prints).

The port's loggers hang under their own root, ``lpt_torch``, not the
JAX package's ``lpt``: a process that imports both packages then has
one handler on each root and prints every line once."""

from __future__ import annotations

import logging
import sys

ROOT = "lpt_torch"

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    """The logger ``lpt_torch.<name>``; the first call gives the root a
    stderr handler at INFO."""
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s",
            datefmt="%H:%M:%S"))
        root = logging.getLogger(ROOT)
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logging.getLogger(f"{ROOT}.{name}")
