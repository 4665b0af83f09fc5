"""SANMVadEncoder in PyTorch: the SAN-M encoder of the streaming punctuation model
(counterpart of ``funasr_tpu/models/ct_transformer_streaming/encoder.py``; FunASR
``funasr/models/ct_transformer_streaming/encoder.py:175-430``).

Every layer attends causally except the last, whose mask is the "VAD corner": query
rows r <= vad_pos - 2 (the carried pre-text) do not see keys from vad_pos on (the new
text); vad_pos <= 1 or >= T masks nothing (JAX ``vad_corner_mask``). Both masks meet the
pad mask, and the JAX package applies them as (B, T, T) masks beside it; here each is
the flash kernel's per-row key limit (``ops/flash_attention.py::key_limits``: causal
``min(r + 1, len)``, corner ``min(vp, len)`` on the pre-text rows), so no mask tensor
is built. The FSMN memory keeps the plain pad mask. Parameters and names are
``SANMEncoder``'s.
"""

from __future__ import annotations

import torch

from funasr_tpu_torch.core.layers import add_sinusoidal_pe, make_pad_mask
from funasr_tpu_torch.models.sanm.encoder import SANMEncoder
from funasr_tpu_torch.register import tables


@tables.register("encoder_classes", "SANMVadEncoder")
class SANMVadEncoder(SANMEncoder):
    def forward(self, xs_pad, ilens, vad_indexes=None):
        """xs_pad (B, T, input_size), ilens (B,), vad_indexes (B,) int (0 when None) ->
        ((B, T, out) masked, ilens)."""
        cfg = self.cfg
        b, t = xs_pad.shape[:2]
        if vad_indexes is None:
            vad_indexes = torch.zeros(b, dtype=torch.int32, device=xs_pad.device)
        mask = make_pad_mask(ilens, t)
        x = xs_pad * (cfg.output_size ** 0.5)
        if cfg.input_layer == "pe":
            x = add_sinusoidal_pe(x)
        layers = (*self.encoders0, *self.encoders)
        for i, layer in enumerate(layers):
            if 0 < i == len(layers) - 1:
                x = layer(x, mask, ilens, "corner", vad_indexes)
            else:
                x = layer(x, mask, ilens, "causal")
        if cfg.normalize_before:
            x = self.after_norm(x)
        return x * mask[..., None].to(x.dtype), ilens
