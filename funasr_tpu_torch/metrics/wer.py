"""CER/WER computation (a copy of ``funasr_tpu/metrics/wer.py``; counterpart of FunASR
``funasr/metrics/wer.py`` / ``compute_wer.py`` tools)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


def edit_distance(ref: List, hyp: List) -> Tuple[int, Dict[str, int]]:
    """Levenshtein with op counts: returns (distance, {sub, del, ins})."""
    m, n = len(ref), len(hyp)
    dp = [[0] * (n + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        dp[i][0] = i
    for j in range(n + 1):
        dp[0][j] = j
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                dp[i][j] = dp[i - 1][j - 1]
            else:
                dp[i][j] = 1 + min(dp[i - 1][j - 1], dp[i - 1][j], dp[i][j - 1])
    # backtrace for op counts
    i, j = m, n
    ops = {"sub": 0, "del": 0, "ins": 0}
    while i > 0 or j > 0:
        if i > 0 and j > 0 and ref[i - 1] == hyp[j - 1] \
                and dp[i][j] == dp[i - 1][j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + 1:
            ops["sub"] += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            ops["del"] += 1
            i -= 1
        else:
            ops["ins"] += 1
            j -= 1
    return dp[m][n], ops


def compute_cer(refs: Iterable[str], hyps: Iterable[str],
                remove_space: bool = True) -> Dict[str, float]:
    """Character error rate over paired utterances."""
    total_err = total_len = 0
    subs = dels = ins = 0
    for ref, hyp in zip(refs, hyps):
        if remove_space:
            ref = ref.replace(" ", "")
            hyp = hyp.replace(" ", "")
        d, ops = edit_distance(list(ref), list(hyp))
        total_err += d
        total_len += len(ref)
        subs += ops["sub"]
        dels += ops["del"]
        ins += ops["ins"]
    n = max(total_len, 1)
    return {"cer": total_err / n, "sub": subs / n, "del": dels / n, "ins": ins / n,
            "n_char": total_len}


def compute_wer(refs: Iterable[str], hyps: Iterable[str]) -> Dict[str, float]:
    total_err = total_len = 0
    for ref, hyp in zip(refs, hyps):
        d, _ = edit_distance(ref.split(), hyp.split())
        total_err += d
        total_len += len(ref.split())
    return {"wer": total_err / max(total_len, 1), "n_word": total_len}
