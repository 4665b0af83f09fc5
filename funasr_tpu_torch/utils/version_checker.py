"""Startup version check (a copy of ``funasr_tpu/utils/version_checker.py``; counterpart
of FunASR ``funasr/utils/version_checker.py``), against the port's version.
Network access is optional and failures are silent; disable via ``disable_update``."""

from __future__ import annotations

import logging


def check_for_update(disable: bool = False, timeout: float = 2.0):
    if disable:
        return None
    try:
        import json
        import urllib.request

        import funasr_tpu_torch
        with urllib.request.urlopen(
                "https://pypi.org/pypi/funasr-tpu/json", timeout=timeout) as r:
            latest = json.loads(r.read())["info"]["version"]
        if latest != funasr_tpu_torch.__version__:
            logging.info("funasr-tpu %s is available (you have %s)", latest,
                         funasr_tpu_torch.__version__)
        return latest
    except Exception:  # noqa: BLE001 — never break startup on network issues
        return None
