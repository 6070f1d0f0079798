"""Structured logging with live-reloadable level.

Ref: cmd/controller/main.go:101-115 — the reference builds a zap logger whose
level re-reads from the config-logging ConfigMap at runtime; named sub-loggers
per controller. We expose named loggers and a set_level() that takes effect
immediately (the runtime watches its config source and calls it).
"""

from __future__ import annotations

import logging
import sys

_ROOT_NAME = "karpenter"
_configured = False


def setup(level: str = "info") -> logging.Logger:
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s"
            )
        )
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    set_level(level)
    return root


def set_level(level: str) -> None:
    """Live level reload (ref: the config-logging ConfigMap watcher)."""
    logging.getLogger(_ROOT_NAME).setLevel(
        getattr(logging, level.upper(), logging.INFO)
    )


def get_level() -> str:
    """The current root level name, lowercased — what /debug/loglevel GETs.
    An unset root (no setup() yet) reads as the effective default, info."""
    level = logging.getLogger(_ROOT_NAME).level
    if level == logging.NOTSET:
        return "info"
    return logging.getLevelName(level).lower()


def named(name: str) -> logging.Logger:
    """Named sub-logger per controller (ref: provisioning/controller.go:65)."""
    return logging.getLogger(f"{_ROOT_NAME}.{name}")
