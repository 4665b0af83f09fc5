"""Small host-side helpers (a framework-free copy of ``funasr_tpu/utils/misc.py``'s
``deep_update``)."""

from __future__ import annotations

from typing import Any, Dict


def deep_update(original: Dict[str, Any], update: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``update`` into ``original`` in place (reference
    ``funasr/utils/misc.py:90`` semantics: nested dicts merge, other values replace)."""
    for key, value in update.items():
        if isinstance(value, dict) and isinstance(original.get(key), dict):
            deep_update(original[key], value)
        else:
            original[key] = value
    return original
