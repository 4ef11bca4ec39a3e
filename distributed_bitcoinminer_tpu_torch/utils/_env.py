"""Shared environment-variable parsing (one copy for config and metrics).

Kept dependency-free: ``utils.metrics`` must stay importable mid-way
through the ``utils.config`` -> ``lsp`` -> ``_engine`` import chain, so
neither module can import the other — both pull these helpers from here.
Malformed values fall back to the default silently, matching the knob
philosophy everywhere else (a bad override must never crash an endpoint).
"""

from __future__ import annotations

import os


def int_env(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def float_env(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def str_env(name: str, default=None):
    """Raw string knob (``default`` when unset — callers parse/compare).

    Exists so EVERY ``DBMT_*`` read in the package routes through this module
    (the dbmlint knob-hygiene analyzer enforces it): one grep target for
    the full knob surface, one place where read semantics can change.
    """
    raw = os.environ.get(name)
    return default if raw is None else raw
