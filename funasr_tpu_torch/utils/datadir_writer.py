"""Kaldi-style output directory writer (a copy of ``funasr_tpu/utils/datadir_writer.py``;
counterpart of FunASR
``funasr/utils/datadir_writer.py:6``): ``writer["1best_recog"]["text"][key] = value``
appends ``key\\tvalue`` lines to ``<dir>/1best_recog/text``."""

from __future__ import annotations

import os
from typing import Dict


class _FileProxy:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a", encoding="utf-8")

    def __setitem__(self, key: str, value):
        self.f.write(f"{key}\t{value}\n")
        self.f.flush()

    def close(self):
        self.f.close()


class _DirProxy:
    def __init__(self, base: str):
        self.base = base
        self.files: Dict[str, _FileProxy] = {}

    def __getitem__(self, name: str) -> _FileProxy:
        if name not in self.files:
            self.files[name] = _FileProxy(os.path.join(self.base, name))
        return self.files[name]

    def close(self):
        for f in self.files.values():
            f.close()


class DatadirWriter:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.dirs: Dict[str, _DirProxy] = {}

    def __getitem__(self, name: str) -> _DirProxy:
        if name not in self.dirs:
            self.dirs[name] = _DirProxy(os.path.join(self.output_dir, name))
        return self.dirs[name]

    def close(self):
        for d in self.dirs.values():
            d.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
