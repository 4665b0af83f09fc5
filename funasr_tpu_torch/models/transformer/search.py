"""Beam search for attention decoders in PyTorch (counterpart of
``funasr_tpu/models/transformer/search.py``; FunASR ``transformer/search.py`` and
``paraformer/search.py``).

Each step scores every live hypothesis at once with the decoder's ``score_step`` (the
whole prefix recomputed, padded to ``bucket_length(step + 1, minimum=8, multiple=8)`` as
the JAX package pads it) and fetches the (N, V) log-probs to the host, where the
bookkeeping is numpy and Python, copied call for call: each hypothesis's candidates are
``np.argsort(-logp)[:beam_size]`` (ties fall as numpy's sort puts them, so no
``torch.topk``), the stable ``list.sort`` on the score, at most 2 x beam_size candidates
examined, leftovers force-ended, the final ranking by score / length. ``max_len``
defaults to the encoder's valid length. ``lm`` adds ``lm_weight`` x its ``score_step``
log-probs (shallow fusion), ``hotword_scorer`` its per-hypothesis credits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from funasr_tpu_torch.utils.bucket import bucket_length


@dataclass
class Hypothesis:
    yseq: List[int]
    score: float = 0.0
    states: dict = field(default_factory=dict)


@torch.inference_mode()
def beam_search(decoder, memory, memory_mask, sos: int, eos: int, beam_size: int = 10,
                max_len: Optional[int] = None, penalty: float = 0.0,
                maxlenratio: float = 0.0, minlenratio: float = 0.0, lm=None,
                lm_weight: float = 0.3, hotword_scorer=None) -> List[Hypothesis]:
    """memory (1, T, D) and memory_mask (1, T) bool of one utterance -> the ended
    hypotheses, best first. ``lm``: a module with ``score_step(ys, ys_len)`` ->
    (N, V) log-probs (``TransformerLM``, ``SeqRNNLM``)."""
    t_mem = int(memory_mask.sum())
    max_len = max_len or (int(t_mem * maxlenratio) if maxlenratio > 0 else t_mem)
    max_len = max(max_len, 2)
    min_len = int(t_mem * minlenratio)
    dev = memory.device

    hyps = [Hypothesis(yseq=[sos], score=0.0)]
    ended: List[Hypothesis] = []
    for step in range(max_len):
        n = len(hyps)
        lmax = bucket_length(step + 1, minimum=8, multiple=8)
        ys = np.zeros((n, lmax), np.int32)
        ylen = np.zeros((n,), np.int32)
        for i, h in enumerate(hyps):
            ys[i, : len(h.yseq)] = h.yseq
            ylen[i] = len(h.yseq)
        ys_t = torch.from_numpy(ys).to(dev)
        ylen_t = torch.from_numpy(ylen).to(dev)
        logp = decoder.score_step(ys_t, ylen_t, memory.expand(n, -1, -1),
                                  memory_mask.expand(n, -1)).cpu().numpy()
        if lm is not None and lm_weight != 0.0:
            logp = logp + lm_weight * lm.score_step(ys_t, ylen_t).cpu().numpy()
        if hotword_scorer is not None:
            v = logp.shape[-1]
            for i, h in enumerate(hyps):
                node = h.states.get("hw", hotword_scorer.init_state())
                logp[i] = logp[i] + hotword_scorer.score_step(node, v)
        cand: List[Hypothesis] = []
        for i, h in enumerate(hyps):
            top = np.argsort(-logp[i])[:beam_size]
            for tok in top:
                states = dict(h.states)
                if hotword_scorer is not None:
                    node = h.states.get("hw", hotword_scorer.init_state())
                    states["hw"] = hotword_scorer.advance(node, int(tok))
                cand.append(Hypothesis(yseq=h.yseq + [int(tok)],
                                       score=h.score + float(logp[i][tok]), states=states))
        cand.sort(key=lambda h: h.score, reverse=True)
        hyps = []
        for h in cand[: beam_size * 2]:
            if h.yseq[-1] == eos:
                if len(h.yseq) - 2 >= min_len:
                    h.score += penalty * len(h.yseq)
                    ended.append(h)
            else:
                hyps.append(h)
            if len(hyps) >= beam_size:
                break
        if not hyps:
            break
    for h in hyps:  # force-end leftovers
        ended.append(Hypothesis(yseq=h.yseq + [eos], score=h.score))
    ended.sort(key=lambda h: h.score / max(len(h.yseq), 1), reverse=True)
    return ended


def beam_search_para(am_scores, beam_size: int = 5, penalty: float = 0.0):
    """NAR rescoring beam over per-position log-probs (L, V) numpy (``BeamSearchPara``):
    the top-k tokens of each position explored jointly."""
    beams = [([], 0.0)]
    for t in range(am_scores.shape[0]):
        top = np.argsort(-am_scores[t])[:beam_size]
        new = []
        for seq, sc in beams:
            for tok in top:
                new.append((seq + [int(tok)], sc + float(am_scores[t][tok])))
        new.sort(key=lambda x: x[1], reverse=True)
        beams = new[:beam_size]
    return [Hypothesis(yseq=seq, score=sc + penalty * len(seq)) for seq, sc in beams]
