"""Central name->class registry of the PyTorch port.

A copy of ``funasr_tpu/register.py``, kept separate so that registering the port's
classes never imports the JAX package (whose ``__init__`` imports jax and fills its own
``tables``). Same public contract — ``tables.model_classes["Paraformer"]`` resolves the
class named in a hub ``config.yaml`` (FunASR ``funasr/register.py:8-92``).
"""

from __future__ import annotations

import importlib
import inspect
import logging
from typing import Any, Callable, Dict


# The modules whose import registers the port's classes, imported at the first lookup
# in ``tables``: importing the package imports no model module, so a process that only
# runs exported programs (``export_runtime.py``) holds no model code. ``parity`` binds the
# aliases after every class.
REGISTRABLE = tuple(f"funasr_tpu_torch.{m}" for m in (
    "frontends.wav_frontend", "frontends.whisper_frontend", "models.bicif_paraformer.model",
    "models.campplus.model", "models.contextual_paraformer.model",
    "models.ct_transformer.model", "models.ct_transformer_streaming.model",
    "models.ctc.model", "models.e_paraformer.model", "models.fsmn_vad_streaming.model",
    "models.fun_asr_nano.model", "models.llm_asr.model", "models.monotonic_aligner.model",
    "models.paraformer.cif_predictor", "models.paraformer.decoder",
    "models.paraformer.model", "models.paraformer.san_decoder",
    "models.paraformer_streaming.model", "models.paraformer_v2.model",
    "models.seaco_paraformer.model", "models.sanm.encoder", "models.sense_voice.model",
    "models.whisper.encoders", "models.whisper.model", "tokenizer.char_tokenizer",
    "tokenizer.extra_tokenizers", "tokenizer.hf_tokenizer",
    "tokenizer.sentencepiece_tokenizer", "parity"))


class RegisterTables:
    """Holds one dict per extension point, read as ``tables.<name>_classes``.

    The first read of a table imports ``REGISTRABLE``, whose classes register
    themselves. Reading an unknown ``*_classes`` name creates the table, so new
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
        self._tables: Dict[str, Dict[str, Any]] = {
            name: {} for name in self.__class__.__annotations__
            if name.endswith(self._TABLE_SUFFIX)}
        self._meta: Dict[str, Dict[str, str]] = {}
        self._filled = None  # None: not yet; False: importing; True: done

    def __getattr__(self, name: str) -> Any:
        # Only called when normal lookup fails, as it does for every table.
        if not name.endswith(self._TABLE_SUFFIX) or name.startswith("_"):
            raise AttributeError(name)
        self._fill()
        return self._tables.setdefault(name, {})

    def _fill(self) -> None:
        """Import the registering modules once; a lookup during their import (their
        own module-level reads) sees the tables as they stand."""
        if self._filled is not None:
            return
        self._filled = False
        try:
            for module in REGISTRABLE:
                importlib.import_module(module)
        except BaseException:
            self._filled = None
            raise
        self._filled = True

    def register(self, table_name: str, key: str | None = None) -> Callable:
        """Class decorator: ``@tables.register("model_classes", "Paraformer")``."""

        def decorator(target: Any) -> Any:
            name = key if key is not None else target.__name__
            table = self._tables.setdefault(table_name, {})  # starts no import
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
        self._fill()
        names = [table_name] if table_name else sorted(self._tables)
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
