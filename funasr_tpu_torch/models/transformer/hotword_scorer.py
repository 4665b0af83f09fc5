"""Decode-time hotword biasing for beam search, copied from
``funasr_tpu/models/transformer/hotword_scorer.py`` (host code, no JAX; the port keeps its
own copy).

The bias-LM role of the reference C++ WFST hotword machinery
(``runtime/onnxruntime/src/wfst-decoder.cpp:114`` + ``bias-lm.cpp``) for models without
SeACo / Contextual bias layers: an Aho-Corasick automaton over hotword token sequences
scores every beam step with incremental per-token credit along matching paths and
rollback when a partial match dies, so a hotword's total boost is ``weight *
len(hotword)`` exactly when it is fully emitted, and net zero otherwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class HotwordScorer:
    ROOT = 0

    def __init__(self, hotword_ids: Sequence[Sequence[int]],
                 weight: float = 3.0, vocab_size: Optional[int] = None):
        """hotword_ids: token-id sequences; weight: per-token credit."""
        self.weight = float(weight)
        self.vocab_size = vocab_size
        # trie: children[node] = {token: node}, depth[node]
        self.children: List[Dict[int, int]] = [{}]
        self.depth: List[int] = [0]
        self.terminal: List[bool] = [False]
        for seq in hotword_ids:
            node = self.ROOT
            for tok in seq:
                tok = int(tok)
                if tok not in self.children[node]:
                    self.children.append({})
                    self.depth.append(self.depth[node] + 1)
                    self.terminal.append(False)
                    self.children[node][tok] = len(self.children) - 1
                node = self.children[node][tok]
            self.terminal[node] = True
        # Aho-Corasick failure links (BFS), like the C++ trie (hotword.cc)
        self.fail = [self.ROOT] * len(self.children)
        queue = list(self.children[self.ROOT].values())
        while queue:
            node = queue.pop(0)
            for tok, child in self.children[node].items():
                f = self.fail[node]
                while f != self.ROOT and tok not in self.children[f]:
                    f = self.fail[f]
                cand = self.children[f].get(tok, self.ROOT)
                self.fail[child] = cand if cand != child else self.ROOT
                queue.append(child)

    # ------------------------------------------------------------------

    def goto(self, node: int, tok: int) -> int:
        while node != self.ROOT and tok not in self.children[node]:
            node = self.fail[node]
        return self.children[node].get(tok, self.ROOT)

    def _credit(self, node: int) -> float:
        return self.weight * self.depth[node]

    def init_state(self) -> int:
        return self.ROOT

    def score_step(self, node: int, vocab_size: int) -> np.ndarray:
        """Per-token score deltas (V,) from ``node``: credit difference of the
        Aho-Corasick transition, banking full credit at word completion."""
        out = np.full((vocab_size,), -self._credit(node), np.float32)
        # tokens continuing some match (own children or via failure chain)
        seen = set()
        n = node
        while True:
            for tok, child in self.children[n].items():
                if tok in seen:
                    continue
                seen.add(tok)
                nxt = self.goto(node, tok)
                # credit difference of the automaton transition; at a word end
                # the full hotword credit is banked (depth of the terminal),
                # net of whatever partial credit was already granted
                out[tok] = self._credit(nxt) - self._credit(node)
            if n == self.ROOT:
                break
            n = self.fail[n]
        return out

    def advance(self, node: int, tok: int) -> int:
        nxt = self.goto(node, int(tok))
        # after banking a completed word, fall back along the automaton
        return self.fail[nxt] if self.terminal[nxt] else nxt


def build_hotword_scorer(hotword, tokenizer, weight: float = 3.0) \
        -> Optional[HotwordScorer]:
    """Parse the reference hotword formats: a string "word1 word2" or
    "word weight" lines / list of words; tokenize each to ids."""
    if not hotword:
        return None
    if isinstance(hotword, str):
        words = [w for w in hotword.replace("\n", " ").split() if w]
    else:
        words = list(hotword)
    seqs = []
    for w in words:
        try:
            ids = tokenizer.encode(w) if hasattr(tokenizer, "encode") else \
                tokenizer.tokens2ids(list(w))
        except Exception:  # noqa: BLE001 — skip un-tokenizable entries
            continue
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        if ids:
            seqs.append(ids)
    return HotwordScorer(seqs, weight=weight) if seqs else None
