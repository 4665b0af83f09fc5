"""Hydra-style ``++key=value`` command-line overrides without the hydra dependency (a
copy of ``funasr_tpu/bin/train.py::parse_overrides``), shared by the port's
``inference`` and ``benchmark`` CLIs."""

from __future__ import annotations

import ast
from typing import Any, Dict


def parse_overrides(argv) -> Dict[str, Any]:
    """``++a.b=1 --c=x`` -> ``{"a": {"b": 1}, "c": "x"}``: values go through
    ``ast.literal_eval`` when they parse, dotted keys nest; other arguments are ignored."""
    cfg: Dict[str, Any] = {}
    for arg in argv:
        if arg.startswith("++"):
            key, _, value = arg[2:].partition("=")
        elif arg.startswith("--"):
            key, _, value = arg[2:].partition("=")
        else:
            continue
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg
