"""CTC forced alignment on the host (viterbi over the blank-interleaved label graph).

Framework-free copy of ``funasr_tpu/ops/ctc_align.py``'s numpy functions
(``ctc_forced_align``, ``ctc_forced_align_batch``; FunASR ``funasr/utils/
ctc_forced_align.py``), held to the original by ``tests/test_torch_ctc_family.py``. The
alignment tables are small (T x 2L + 1) beside the model's work. The JAX package's device
viterbi, ``ctc_forced_align_jax``, serves only Paraformer-v2's training loss
(``paraformer_v2/model.py::forward_jit``) and comes with the training slice.
"""

from __future__ import annotations

import numpy as np

NEG_INF = -1e30


def ctc_forced_align(log_probs: np.ndarray, targets: np.ndarray,
                     input_length: int = None, target_length: int = None,
                     blank_id: int = 0) -> np.ndarray:
    """log_probs: (T, V) log-softmax; targets: (L,) label ids ->
    per-frame aligned label ids (T,) with blanks (the viterbi path)."""
    log_probs = np.asarray(log_probs, np.float64)
    targets = np.asarray(targets, np.int64)
    t_len = input_length if input_length is not None else log_probs.shape[0]
    l_len = target_length if target_length is not None else targets.shape[0]
    log_probs = log_probs[:t_len]
    targets = targets[:l_len]

    # extended sequence: blank l1 blank l2 ... blank lL blank
    ext = np.full((2 * l_len + 1,), blank_id, np.int64)
    ext[1::2] = targets
    s = len(ext)

    dp = np.full((t_len, s), NEG_INF)
    bp = np.zeros((t_len, s), np.int64)
    dp[0, 0] = log_probs[0, ext[0]]
    if s > 1:
        dp[0, 1] = log_probs[0, ext[1]]

    for t in range(1, t_len):
        prev = dp[t - 1]
        # candidates: stay (j), from j-1, from j-2 (only if labels differ & non-blank)
        stay = prev
        from1 = np.concatenate([[NEG_INF], prev[:-1]])
        from2 = np.concatenate([[NEG_INF, NEG_INF], prev[:-2]])
        can_skip = np.zeros(s, bool)
        can_skip[2:] = (ext[2:] != blank_id) & (ext[2:] != ext[:-2])
        from2 = np.where(can_skip, from2, NEG_INF)
        stacked = np.stack([stay, from1, from2])  # (3, S)
        best = np.argmax(stacked, axis=0)
        dp[t] = stacked[best, np.arange(s)] + log_probs[t, ext]
        bp[t] = np.arange(s) - best

    # end at last blank or last label
    j = s - 1 if s == 1 or dp[-1, s - 1] >= dp[-1, s - 2] else s - 2
    path = np.zeros(t_len, np.int64)
    for t in range(t_len - 1, -1, -1):
        path[t] = ext[j]
        j = bp[t, j] if t > 0 else j
    return path


def ctc_forced_align_batch(log_probs, targets, input_lengths, target_lengths,
                           blank_id: int = 0, ignore_id: int = -1):
    """(B, T, V), (B, L) -> (B, T) aligned paths (padded frames = blank)."""
    b, t, _ = log_probs.shape
    out = np.full((b, t), blank_id, np.int64)
    for i in range(b):
        tl = int(input_lengths[i])
        ll = int(target_lengths[i])
        tg = np.asarray(targets[i][:ll])
        tg = tg[tg != ignore_id]
        out[i, :tl] = ctc_forced_align(np.asarray(log_probs[i]), tg, tl, len(tg),
                                       blank_id)
    return out
