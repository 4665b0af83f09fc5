"""RNN-T (transducer) loss over the (T, U + 1) lattice (counterpart of
``funasr_tpu/ops/rnnt_loss.py``; FunASR's reference calls warp-rnnt / torchaudio).

The arithmetic is the JAX function's, cell for cell: log-softmax in fp32;
alpha(0, 0) = 0 and row 0 the cumulative sum of the emissions; every other cell
alpha(t, u) = logaddexp(alpha(t - 1, u) + blank(t - 1, u), alpha(t, u - 1) + emit(t, u - 1))
(the blank move alone at u = 0); cells past each target length set to ``NEG_INF`` (a
large finite -1e30, not -inf, so an infeasible alignment gives a large finite loss with
finite gradients); the loss -(alpha(T_b - 1, U_b) + blank(T_b - 1, U_b)), rows past each
logit length never read (JAX freezes them, which reads the same cell). A row of logit
length 0 takes JAX's reading: alpha(0, U_b) and the blank at frame T - 1, where JAX's
index T_b - 1 = -1 wraps.

The order differs: JAX scans T rows with an inner scan over U, T U sequential steps. Here
the lattice runs by anti-diagonals t + u = d, T + U - 1 steps, each one vectorised op
over the diagonal's cells (B, T), whose two terms are those of the row order, so every
cell but row 0's cumulative sum rounds as JAX's does. Plain PyTorch: the JAX package has
no Pallas kernel for it, and autograd gives the gradient.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def rnnt_loss(logits, targets, logit_lengths, target_lengths, blank_id: int = 0):
    """logits (B, T, U + 1, V) joint outputs (pre-softmax); targets (B, U) ids;
    logit_lengths / target_lengths (B,) -> per-sequence negative log-likelihood (B,) fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    b, t_max, u1, _ = logp.shape
    u_max = u1 - 1
    dev = logp.device
    t_len = logit_lengths.long()
    u_len = target_lengths.long()
    blank = logp[..., blank_id]  # (B, T, U + 1)
    tgt = torch.where(torch.arange(u_max, device=dev)[None] < u_len[:, None], targets.long(), 0)
    emit = torch.gather(logp[:, :, :u_max], 3,
                        tgt[:, None, :, None].expand(b, t_max, u_max, 1))[..., 0]  # (B, T, U)
    row0 = torch.cat([torch.zeros(b, 1, device=dev), torch.cumsum(emit[:, 0], dim=1)], dim=1)

    # diagonal d holds alpha(t, d - t) at index t: the terms of its cells, gathered once
    n_diag = t_max + u_max
    ts = torch.arange(t_max, device=dev)
    us = torch.arange(n_diag, device=dev)[:, None] - ts[None]  # (D, T): u of each cell
    in_lattice = (us >= 0) & (us <= u_max)
    from_blank = torch.gather(  # blank(t - 1, u)
        blank.reshape(b, -1), 1,
        ((ts - 1).clamp(min=0) * u1 + us.clamp(0, u_max)).reshape(1, -1).expand(b, -1)
    ).reshape(b, n_diag, t_max)
    from_emit = torch.gather(  # emit(t, u - 1)
        emit.reshape(b, -1), 1,
        (ts * max(u_max, 1) + (us - 1).clamp(0, max(u_max - 1, 0))).reshape(1, -1).expand(b, -1)
    ).reshape(b, n_diag, t_max) if u_max else None
    valid = in_lattice[None] & (us[None] <= u_len[:, None, None])  # (B, D, T)

    neg = torch.full((b, 1), NEG_INF, device=dev)
    alpha = torch.where(valid[:, 0], torch.cat([row0[:, :1], neg.expand(b, t_max - 1)], 1),
                        NEG_INF)
    diags = [alpha]
    for d in range(1, n_diag):
        prev_t = torch.cat([neg, alpha[:, :-1]], dim=1)  # alpha(t - 1, u) at index t
        fb = prev_t + from_blank[:, d]
        if u_max:
            cell = torch.where(us[d] >= 1, torch.logaddexp(fb, alpha + from_emit[:, d]), fb)
        else:
            cell = fb
        first = row0[:, d:d + 1] if d <= u_max else neg  # t = 0: row 0
        alpha = torch.where(valid[:, d], torch.cat([first, cell[:, 1:]], dim=1), NEG_INF)
        diags.append(alpha)
    lattice = torch.stack(diags, dim=1)  # (B, D, T)
    rows = torch.arange(b, device=dev)
    # a row of logit length 0 reads what JAX reads: alpha at (0, U_b), row 0 (its scan
    # never moves that row), and the blank at frame -1, which wraps to the last frame
    last_t = (t_len - 1).clamp(min=0)
    last_alpha = lattice[rows, last_t + u_len, last_t]
    last_blank = blank[rows, (t_len - 1) % t_max, u_len]
    return -(last_alpha + last_blank)
