"""Text-level fuzzy hotword correction after decoding.

Counterpart of FunASR ``funasr/utils/postprocess_hotwords.py`` (rapidfuzz-based):
hotwords given as target words or explicit ``wrong=>right`` mappings; decoded text
spans within a similarity threshold of a target are replaced. Uses stdlib
``difflib`` similarity (no rapidfuzz dependency).

Framework-free copy of ``funasr_tpu/utils/postprocess_hotwords.py``, held to the
original by ``tests/test_torch_auto_model.py``.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, List, Mapping, Optional


def _similarity(a: str, b: str) -> float:
    return difflib.SequenceMatcher(None, a, b).ratio()


class HotwordMatcher:
    def __init__(self, mappings: Dict[str, str], targets: List[str],
                 threshold: float = 0.85, enable_fuzzy: bool = True):
        self.mappings = mappings      # explicit wrong -> right
        self.targets = targets        # fuzzy-match targets
        self.threshold = threshold
        self.enable_fuzzy = enable_fuzzy

    def apply(self, text: str):
        matches = []
        for wrong, right in self.mappings.items():
            if wrong in text:
                text = text.replace(wrong, right)
                matches.append({"from": wrong, "to": right, "score": 1.0})
        if self.enable_fuzzy:
            for target in self.targets:
                n = len(target)
                if n < 2 or target in text:
                    continue
                best, best_i = 0.0, -1
                for i in range(0, max(len(text) - n + 1, 0) + 1):
                    span = text[i: i + n]
                    s = _similarity(span, target)
                    if s > best:
                        best, best_i = s, i
                if best >= self.threshold and best < 1.0 and best_i >= 0:
                    span = text[best_i: best_i + n]
                    text = text[:best_i] + target + text[best_i + n:]
                    matches.append({"from": span, "to": target,
                                    "score": round(best, 4)})
        return text, matches

    def apply_result(self, result: Dict[str, Any], return_matches: bool = False):
        if "text" in result and isinstance(result["text"], str):
            new_text, matches = self.apply(result["text"])
            result["text"] = new_text
            if return_matches:
                result["postprocess_hotword_matches"] = matches
        if "sentence_info" in result:
            for sent in result["sentence_info"]:
                if isinstance(sent.get("text"), str):
                    sent["text"], _ = self.apply(sent["text"])
        return result


def _parse_entries(entries) -> (dict, list):
    mappings, targets = {}, []
    for entry in entries:
        entry = entry.strip()
        if not entry or entry.startswith("#"):
            continue
        if "=>" in entry:
            wrong, right = entry.split("=>", 1)
            mappings[wrong.strip()] = right.strip()
        else:
            targets.append(entry)
    return mappings, targets


def build_postprocess_hotword_matcher(postprocess_hotwords=None,
                                      postprocess_hotword_file: Optional[str] = None,
                                      postprocess_hotword_threshold: float = 0.85,
                                      enable_fuzzy: bool = True
                                      ) -> Optional[HotwordMatcher]:
    entries: List[str] = []
    if isinstance(postprocess_hotwords, str):
        entries.extend(postprocess_hotwords.split())
    elif isinstance(postprocess_hotwords, Mapping):
        entries.extend(f"{k}=>{v}" for k, v in postprocess_hotwords.items())
    elif isinstance(postprocess_hotwords, (list, tuple)):
        entries.extend(str(e) for e in postprocess_hotwords)
    if postprocess_hotword_file:
        with open(postprocess_hotword_file, encoding="utf-8") as f:
            entries.extend(line.rstrip("\n") for line in f)
    if not entries:
        return None
    mappings, targets = _parse_entries(entries)
    return HotwordMatcher(mappings, targets, postprocess_hotword_threshold,
                          enable_fuzzy)


def apply_postprocess_hotwords_to_results(results: List[Dict[str, Any]],
                                          cfg: Mapping[str, Any]
                                          ) -> List[Dict[str, Any]]:
    matcher = build_postprocess_hotword_matcher(
        postprocess_hotwords=cfg.get("postprocess_hotwords"),
        postprocess_hotword_file=cfg.get("postprocess_hotword_file"),
        postprocess_hotword_threshold=cfg.get("postprocess_hotword_threshold", 0.85),
        enable_fuzzy=cfg.get("postprocess_hotword_fuzzy", True))
    if matcher is None:
        return results
    return_matches = bool(cfg.get("return_postprocess_hotword_matches", False))
    for result in results:
        if isinstance(result, dict):
            matcher.apply_result(result, return_matches=return_matches)
    return results
