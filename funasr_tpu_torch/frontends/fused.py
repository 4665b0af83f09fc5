"""FusedFrontends: several frontends combined by linear projection and temporal
re-alignment, in PyTorch (counterpart of ``funasr_tpu/frontends/fused.py``; FunASR
``funasr/frontends/fused.py``).

Each sub-frontend's features are projected to ``factor * proj_dim`` (factor = its hop
over the gcd of all hops), reshaped to the common frame rate, truncated to the shortest
stream and concatenated: ``proj_dim * n_frontends`` features. "default" is
``DefaultFrontend``; any other ``frontend_type`` is a registered frontend built with
``fs`` (``S3prlFrontend`` among them). The projections are this module's ``nn.Linear``
parameters (``projections.{i}``), drawn from a CPU generator seeded with 0. ``device``
is where they run when ``extract`` names no device: the card unless the caller asks for
the CPU (``AutoModel`` passes its own).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.register import tables


@tables.register("frontend_classes", "FusedFrontends")
@tables.register("frontend_classes", "fused")
class FusedFrontends(nn.Module):
    def __init__(self, frontends: Optional[List[dict]] = None,
                 align_method: str = "linear_projection", proj_dim: int = 100,
                 fs: int = 16000, device=None, **kwargs):
        super().__init__()
        if align_method != "linear_projection":
            raise NotImplementedError(align_method)
        self.proj_dim, self.fs = proj_dim, fs
        self.device = torch.device(device or "cuda")
        self.frontends, self.hops = [], []
        for conf in (frontends or []):
            conf = dict(conf)
            ftype = conf.pop("frontend_type", "default")
            if ftype == "default":
                from funasr_tpu_torch.frontends.default import DefaultFrontend
                fe = DefaultFrontend(fs=fs, **conf)
                hop = conf.get("hop_length", 128)
            elif ftype in tables.frontend_classes:
                fe = tables.frontend_classes[ftype](fs=fs, **conf)
                hop = conf.get("hop_length", getattr(fe, "frame_shift", 160))
            else:
                raise NotImplementedError(f"frontend_type {ftype!r} is not registered")
            self.frontends.append(fe)
            self.hops.append(int(hop))
        if not self.frontends:
            raise ValueError("FusedFrontends needs at least one sub-frontend")
        self.gcd = math.gcd(*self.hops) if len(self.hops) > 1 else self.hops[0]
        self.factors = [h // self.gcd for h in self.hops]
        self.projections = nn.ModuleList([
            nn.Linear(fe.output_size(), f * proj_dim)
            for fe, f in zip(self.frontends, self.factors)])
        init_weights(self, torch.Generator().manual_seed(0))  # JAX: init(PRNGKey(0))

    def output_size(self) -> int:
        return len(self.frontends) * self.proj_dim

    def forward(self, waveforms, lengths, device=None):
        """(B, N) waveforms + (B,) lengths -> ((B, T, proj_dim * n_frontends), (B,) lens)
        on ``device`` (the frontend's own when None)."""
        wavs = [np.asarray(waveforms[i][: int(lengths[i])]) for i in range(len(lengths))]
        dev = self.device if device is None else torch.device(device)
        if self.projections[0].weight.device != dev:
            self.to(dev)
        streams = []
        for fe, proj, f in zip(self.frontends, self.projections, self.factors):
            feats, _ = fe.extract(wavs, device=dev)
            y = apply_linear(proj, torch.as_tensor(feats, device=dev))
            b, nf, dim = y.shape
            streams.append(y.reshape(b, nf * f, dim // f))
        m = min(int(s.shape[1]) for s in streams)
        fused = torch.cat([s[:, :m] for s in streams], dim=-1)
        return fused, torch.full((fused.shape[0],), m, dtype=torch.int32, device=dev)

    def extract(self, waveforms, device=None):
        """Waveforms -> (feats, lens) computed on ``device`` (the frontend's own without
        one): host numpy without ``device``, tensors left on it with one."""
        maxn = max(int(np.asarray(w).shape[0]) for w in waveforms)
        batch = np.zeros((len(waveforms), maxn), np.float32)
        lens = np.zeros((len(waveforms),), np.int32)
        for i, w in enumerate(waveforms):
            batch[i, : len(w)] = w
            lens[i] = len(w)
        with torch.inference_mode():
            feats, flens = self.forward(batch, lens, device)
        if device is None:
            return feats.cpu().numpy(), flens.cpu().numpy()
        return feats, flens
