"""KWS decode utilities in the PyTorch port: the CTC prefix-beam keyword detector.

A copy of ``funasr_tpu/utils/kws_utils.py`` (host code, numpy only; FunASR
``funasr/utils/kws_utils.py``), kept in the port so that it imports nothing of the JAX
package: ``split_mixed_label`` / ``query_token_set`` keyword tokenization (ref :13-87),
the prefix beam with per-token (frame, prob) node tracking (ref :125-229), and sublist
keyword hit scoring with sqrt-compressed confidence (ref :256-292). The encoder and the
CTC softmax run on the model's device; the posteriors come to the host in one copy.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SYMBOL_STRIP = re.compile(r"[^\w一-鿿]+")


def split_mixed_label(input_str: str) -> List[str]:
    """Mixed zh/en label -> tokens: latin runs stay words, CJK split per char."""
    tokens: List[str] = []
    s = input_str.lower()
    while len(s) > 0:
        match = re.match(r"[A-Za-z!?,<>()']+", s)
        word = match.group(0) if match is not None else s[0:1]
        tokens.append(word)
        s = s.replace(word, "", 1).strip(" ")
    return tokens


def query_token_set(txt: str, symbol_table: Dict[str, int],
                    lexicon_table: Optional[Dict[str, Sequence[str]]] = None):
    """Keyword text -> (token strings, token ids) against the vocab, with
    lexicon expansion and sil/noise aliases (ref kws_utils.py:32-87)."""
    lexicon_table = lexicon_table or {}
    if txt in symbol_table:
        return (txt,), (symbol_table[txt],)
    tokens_str: Tuple[str, ...] = ()
    for part in split_mixed_label(txt):
        if part in ("!sil", "(sil)", "<sil>"):
            tokens_str += ("!sil",)
        elif part == "<blank>":
            tokens_str += ("<blank>",)
        elif part in ("(noise)", "noise)", "(noise", "<noise>"):
            tokens_str += ("<unk>",)
        elif part in symbol_table:
            tokens_str += (part,)
        elif part in lexicon_table:
            tokens_str += tuple(lexicon_table[part])
        else:
            tokens_str += tuple(_SYMBOL_STRIP.sub("", part))
    tokens_idx: Tuple[int, ...] = ()
    for ch in tokens_str:
        if ch in symbol_table:
            tokens_idx += (symbol_table[ch],)
        elif ch == "!sil":
            tokens_idx += (symbol_table.get("sil", symbol_table.get("<blank>",
                                                                    0)),)
        else:
            tokens_idx += (symbol_table.get("<unk>",
                                            symbol_table.get("<blank>", 0)),)
    return tokens_str, tokens_idx


class KwsCtcPrefixDecoder:
    """Keyword detector over CTC posteriors (ref kws_utils.py:90-308)."""

    def __init__(self, keywords: str, token_list: Sequence[str],
                 seg_dict: Optional[Dict] = None, blank_id: int = 0):
        self.blank_id = blank_id
        token_table = {tok: i for i, tok in enumerate(token_list)}
        self.keywords_idxset = {blank_id}
        self.keywords_token: Dict[str, Dict] = {}
        for keyword in keywords.strip().replace(" ", "").split(","):
            if not keyword:
                continue
            _, idxs = query_token_set(keyword, token_table, seg_dict)
            self.keywords_token[keyword] = {"token_id": list(idxs)}
            self.keywords_idxset.update(idxs)

    # ------------------------------------------------------------------

    def beam_search(self, probs: np.ndarray, keywords_tokenset=None,
                    score_beam_size: int = 3, path_beam_size: int = 20):
        """probs: (T, V) CTC posteriors. Returns [(prefix, score, nodes)] with
        nodes carrying per-token best (frame, prob)."""
        cur_hyps = [((), (1.0, 0.0, []))]
        for t in range(probs.shape[0]):
            p_t = probs[t]
            top = np.argsort(-p_t)[:score_beam_size]
            filt = [int(i) for i in top
                    if p_t[i] > 0.05 and (keywords_tokenset is None
                                          or int(i) in keywords_tokenset)]
            if not filt:
                continue
            next_hyps = defaultdict(lambda: (0.0, 0.0, []))
            for s in filt:
                ps = float(p_t[s])
                for prefix, (pb, pnb, cur_nodes) in cur_hyps:
                    last = prefix[-1] if prefix else None
                    if s == self.blank_id:
                        n_pb, n_pnb, nodes = next_hyps[prefix]
                        next_hyps[prefix] = (n_pb + (pb + pnb) * ps, n_pnb,
                                             list(cur_nodes))
                    elif s == last:
                        if not math.isclose(pnb, 0.0, abs_tol=1e-6):
                            n_pb, n_pnb, nodes = next_hyps[prefix]
                            nodes = [dict(n) for n in cur_nodes]
                            if ps > nodes[-1]["prob"]:
                                nodes[-1].update(prob=ps, frame=t)
                            next_hyps[prefix] = (n_pb, n_pnb + pnb * ps, nodes)
                        if not math.isclose(pb, 0.0, abs_tol=1e-6):
                            n_prefix = prefix + (s,)
                            n_pb, n_pnb, _ = next_hyps[n_prefix]
                            nodes = list(cur_nodes) + [dict(token=s, frame=t,
                                                            prob=ps)]
                            next_hyps[n_prefix] = (n_pb, n_pnb + pb * ps,
                                                   nodes)
                    else:
                        n_prefix = prefix + (s,)
                        n_pb, n_pnb, nodes = next_hyps[n_prefix]
                        if nodes:
                            nodes = [dict(n) for n in nodes]
                            if ps > nodes[-1]["prob"]:
                                nodes[-1].update(prob=ps, frame=t)
                        else:
                            nodes = list(cur_nodes) + [dict(token=s, frame=t,
                                                            prob=ps)]
                        next_hyps[n_prefix] = (n_pb, n_pnb + (pb + pnb) * ps,
                                               nodes)
            cur_hyps = sorted(next_hyps.items(),
                              key=lambda x: x[1][0] + x[1][1],
                              reverse=True)[:path_beam_size]
        return [(prefix, pb + pnb, nodes)
                for prefix, (pb, pnb, nodes) in cur_hyps]

    @staticmethod
    def is_sublist(main_list, check_list) -> int:
        if len(main_list) < len(check_list):
            return -1
        for i in range(len(main_list) - len(check_list) + 1):
            if list(main_list[i: i + len(check_list)]) == list(check_list):
                return i
        return -1

    def decode(self, probs: np.ndarray):
        """(T, V) posteriors -> (detected, keyword, score, (start_f, end_f))."""
        hyps = self.beam_search(np.asarray(probs), self.keywords_idxset)
        for prefix_ids, _, nodes in hyps:
            for word, info in self.keywords_token.items():
                lab = info["token_id"]
                offset = self.is_sublist(list(prefix_ids), lab)
                if offset != -1:
                    score = 1.0
                    for idx in range(offset, offset + len(lab)):
                        score *= nodes[idx]["prob"]
                    span = (nodes[offset]["frame"],
                            nodes[offset + len(lab) - 1]["frame"])
                    return True, word, math.sqrt(score), span
        return False, None, None, None
