"""Central name->class registry of the PyTorch port.

A copy of ``funasr_tpu/register.py``, kept separate so that registering the port's
classes never imports the JAX package (whose ``__init__`` imports jax and fills its own
``tables``). Same public contract — ``tables.model_classes["Paraformer"]`` resolves the
class named in a hub ``config.yaml`` (FunASR ``funasr/register.py:8-92``).
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable, Dict


class RegisterTables:
    """Holds one dict per extension point.

    Attribute access for an unknown ``*_classes`` name lazily creates the table, so new
    extension points need no code change here.
    """

    _TABLE_SUFFIX = "_classes"

    # Pre-declared tables (mirrors the reference's extension points).
    model_classes: Dict[str, Any]
    frontend_classes: Dict[str, Any]
    encoder_classes: Dict[str, Any]
    decoder_classes: Dict[str, Any]
    predictor_classes: Dict[str, Any]
    joint_network_classes: Dict[str, Any]
    tokenizer_classes: Dict[str, Any]
    specaug_classes: Dict[str, Any]
    normalize_classes: Dict[str, Any]
    dataloader_classes: Dict[str, Any]
    batch_sampler_classes: Dict[str, Any]
    dataset_classes: Dict[str, Any]
    index_ds_classes: Dict[str, Any]
    preprocessor_classes: Dict[str, Any]
    optim_classes: Dict[str, Any]
    scheduler_classes: Dict[str, Any]

    def __init__(self) -> None:
        for name, ann in self.__class__.__annotations__.items():
            if name.endswith(self._TABLE_SUFFIX):
                setattr(self, name, {})
        self._meta: Dict[str, Dict[str, str]] = {}

    def __getattr__(self, name: str) -> Any:
        # Only called when normal lookup fails: lazily create unknown tables.
        if name.endswith(self._TABLE_SUFFIX) and not name.startswith("_"):
            table: Dict[str, Any] = {}
            object.__setattr__(self, name, table)
            return table
        raise AttributeError(name)

    def register(self, table_name: str, key: str | None = None) -> Callable:
        """Class decorator: ``@tables.register("model_classes", "Paraformer")``."""

        def decorator(target: Any) -> Any:
            name = key if key is not None else target.__name__
            table = getattr(self, table_name)
            if name in table and table[name] is not target:
                logging.debug("registry: overriding %s/%s", table_name, name)
            table[name] = target
            try:
                src = inspect.getsourcefile(target) or "?"
                line = inspect.getsourcelines(target)[1]
            except (OSError, TypeError):
                src, line = "?", 0
            self._meta.setdefault(table_name, {})[name] = f"{src}:{line}"
            return target

        return decorator

    def print(self, table_name: str | None = None) -> str:
        """Human-readable dump of one or all tables."""
        lines = []
        names = [table_name] if table_name else sorted(
            n for n in vars(self) if n.endswith(self._TABLE_SUFFIX)
        )
        for tname in names:
            table = getattr(self, tname, {})
            lines.append(f"----------- ** {tname} ** -----------")
            for key in sorted(table):
                where = self._meta.get(tname, {}).get(key, "?")
                lines.append(f"  {key:40s} {where}")
        out = "\n".join(lines)
        print(out)
        return out


tables = RegisterTables()
