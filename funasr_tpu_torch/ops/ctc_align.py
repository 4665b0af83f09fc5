"""CTC forced alignment on the host (viterbi over the blank-interleaved label graph).

Framework-free copy of ``funasr_tpu/ops/ctc_align.py``'s numpy functions
(``ctc_forced_align``, ``ctc_forced_align_batch``; FunASR ``funasr/utils/
ctc_forced_align.py``), held to the original by ``tests/test_torch_ctc_family.py``. The
alignment tables are small (T x 2L + 1) beside the model's work.

``ctc_forced_align_device`` is the counterpart of the JAX package's device viterbi
(``ctc_forced_align_jax``, ``ctc_align.py:81-148``), which Paraformer-v2's training loss
runs: the whole batch's (B, 2L + 1) states on the tensors' device, T - 1 steps of tensor
ops and a backtrack of T gathers, with no host sync.

One departure from the JAX copy: an empty target aligns to the all-blank path. The JAX
function raises there (its skip candidates are built two states wide for a graph of one
blank state), and so does ``ctc_forced_align_batch`` for a row whose target is all
padding.
"""

from __future__ import annotations

import numpy as np
import torch

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
    if l_len == 0:  # one blank state: every frame is blank
        return np.full(t_len, blank_id, np.int64)

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


def ctc_forced_align_device(log_probs, targets, input_lengths, target_lengths,
                            blank_id: int = 0):
    """The batched viterbi on the tensors' device (``ctc_forced_align_jax``).

    log_probs: (B, T, V) fp32 log-softmax; targets: (B, L) label ids, L >= 1 (padding any
    valid id); lengths (B,). Returns (B, T) int32 target indices: the position in [0, L) each
    frame aligns to, -1 for blank and padded frames. Its rules are JAX's: the states past
    2 ``target_lengths`` stay at -1e30, a frame at or past a row's length keeps the
    row's scores and records the "stay" move, each move is the first maximum of (stay,
    from the state before, from two before where a label may skip its blank), and a row
    ends at its last blank or last label, whichever scores higher (the blank on a tie or
    an empty target)."""
    b, t_max, _ = log_probs.shape
    l_max = targets.shape[1]
    dev = log_probs.device
    s_max = 2 * l_max + 1
    s_idx = torch.arange(s_max, device=dev)
    is_lab = (s_idx % 2) == 1
    t_len = input_lengths.to(dev, torch.long)[:, None]
    l_len = target_lengths.to(dev, torch.long)[:, None]
    tgt = targets.to(dev, torch.long)
    lab = tgt[:, torch.clamp((s_idx - 1) // 2, 0, l_max - 1)]
    ext = torch.where(is_lab, lab, blank_id)
    prev_lab = tgt[:, torch.clamp((s_idx - 3) // 2, 0, l_max - 1)]
    can_skip = is_lab & (s_idx >= 2) & (lab != prev_lab)
    state_valid = s_idx[None] <= 2 * l_len
    neg = torch.full((b, 1), NEG_INF, dtype=torch.float32, device=dev)
    emits = torch.gather(log_probs.float(), 2, ext[:, None, :].expand(b, t_max, s_max))
    alpha = torch.where((s_idx == 0) | ((s_idx == 1) & (l_len > 0)), emits[:, 0], NEG_INF)
    alpha = torch.where(state_valid, alpha, NEG_INF)
    choices = torch.zeros((max(t_max - 1, 0), b, s_max), dtype=torch.long, device=dev)
    for t in range(1, t_max):
        from1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        from2 = torch.where(can_skip, torch.cat([neg, neg, alpha[:, :-2]], dim=1)[:, :s_max],
                            NEG_INF)
        take1 = from1 > alpha
        best = torch.where(take1, from1, alpha)
        take2 = from2 > best
        best = torch.where(take2, from2, best)
        choice = torch.where(take2, 2, take1.long())
        frozen = t >= t_len
        alpha = torch.where(frozen, alpha,
                            torch.where(state_valid, best + emits[:, t], NEG_INF))
        choices[t - 1] = torch.where(frozen, 0, choice)
    end_hi = torch.clamp(2 * l_len, 0, s_max - 1)
    end_a = torch.gather(alpha, 1, end_hi)
    end_b = torch.gather(alpha, 1, torch.clamp(2 * l_len - 1, 0, s_max - 1))
    s = torch.where((l_len == 0) | (end_a >= end_b), 2 * l_len, 2 * l_len - 1)
    states = torch.empty((b, t_max), dtype=torch.long, device=dev)
    for t in range(t_max - 1, -1, -1):
        states[:, t] = s[:, 0]
        if t >= 1:
            s = s - torch.gather(choices[t - 1], 1, s)
    idx = torch.where(states % 2 == 1, (states - 1) // 2, -1)
    idx = torch.where(torch.arange(t_max, device=dev)[None] < t_len, idx, -1)
    return idx.to(torch.int32)
