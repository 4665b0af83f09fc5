"""CTC loss in PyTorch with optax's numerics (a copy of ``optax.ctc_loss``'s alpha
recursion, which the JAX package's ``models/ctc/ctc.py`` and ``losses/cr_ctc.py`` call).

Per sequence the negative log-likelihood over blank-inserted alignments, in log space
with ``log_epsilon`` (-1e5) standing for log(0). On a feasible alignment it equals
``F.ctc_loss(reduction="none")``; on an infeasible one (more labels, with their
repeats, than frames) it is a large finite value with finite gradients, where
``F.ctc_loss`` gives ``inf`` (and a NaN gradient norm that the trainer's guard turns
into a zero update). The recursion is one step per frame over (B, 2 N + 1) states;
the paraformer recipes do not train CTC (``ctc_weight`` 0).
"""

from __future__ import annotations

import torch


def ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id: int = 0,
             log_epsilon: float = -1e5):
    """logits (B, T, K); logit_paddings (B, T) 1.0 at padded frames; labels (B, N)
    right-padded; label_paddings (B, N) 1.0 at padding -> per-sequence loss (B,)."""
    b, _, k = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - label_paddings.sum(dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype)
    repeat = torch.nn.functional.pad(repeat, (0, 1))
    logprobs_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)  # (T, B, 1)
    # jax.nn.one_hot: a label outside [0, K) is a row of zeros (an LLM's token ids against
    # a smaller CTC vocabulary, Fun-ASR-Nano's CTC branch), where F.one_hot raises
    labels = labels.long()
    inside = ((labels >= 0) & (labels < k))[..., None]
    one_hot = (torch.nn.functional.one_hot(labels.clamp(0, k - 1), k) * inside).to(logprobs.dtype)
    logprobs_emit = torch.einsum("btk,bnk->btn", logprobs, one_hot).transpose(0, 1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=logprobs.dtype, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), log_epsilon, dtype=logprobs.dtype, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=-1)

    pads = logit_paddings.transpose(0, 1).to(logprobs.dtype)
    for t in range(logprobs_emit.shape[0]):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi, pad = logprobs_emit[t], logprobs_phi[t], pads[t][:, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    pick = torch.nn.functional.one_hot(labellens, n + 1).to(logprobs.dtype)
    return -(phi_last * pick).sum(dim=-1)
