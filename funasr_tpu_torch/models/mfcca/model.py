"""MFCCA in PyTorch: multi-frame cross-channel attention ASR for multichannel meetings
(counterpart of ``funasr_tpu/models/mfcca/model.py``; FunASR
``funasr/models/mfcca/e2e_asr_mfcca.py:53``).

The port's Transformer AED (``models/transformer/model.py``: attention decoder, CTC,
``ctc_weight`` mixing, beam search) over ``MFCCAEncoder``. (B, C, T, F) multichannel
features run through the encoder with the channels flattened into the batch (ref
``mfcca_encoder.py:391``), whose conv stack fuses them; (B, T, F) is one channel.
"""

from __future__ import annotations

import torch

import funasr_tpu_torch.models.mfcca.encoder  # noqa: F401 (registers MFCCAEncoder)
from funasr_tpu_torch.models.transformer.model import Transformer
from funasr_tpu_torch.register import tables


@tables.register("model_classes", "MFCCA")
class MFCCA(Transformer):
    def __init__(self, encoder: str = "MFCCAEncoder", encoder_conf=None,
                 mask_channel: bool = False, **kwargs):
        enc_conf = dict(encoder_conf or {})
        enc_conf.setdefault("pos_enc_layer_type", "rel_pos")
        enc_conf.setdefault("selfattention_layer_type", "rel_selfattn")
        super().__init__(encoder=encoder, encoder_conf=enc_conf, **kwargs)
        # channel-dropout augmentation (ref e2e_asr_mfcca.py:166-170) is a training-data
        # choice; the flag is kept for config parity, as in the JAX package
        self.mask_channel = mask_channel

    @staticmethod
    def flatten_channels(speech, speech_lengths):
        """(B, C, T, F) -> ((B C, T, F), lengths repeated, C); (B, T, F) is one channel."""
        if speech.dim() == 4:
            b, c, t, f = speech.shape
            return speech.reshape(b * c, t, f), speech_lengths.repeat_interleave(c), c
        return speech, speech_lengths, 1

    def encode(self, speech, speech_lengths, generator=None):
        flat, lens, c = self.flatten_channels(speech, speech_lengths)
        if self.specaug is not None and self.training and generator is not None:
            flat, lens = self.specaug(flat, lens, generator)
        if self.normalize is not None:
            flat, lens = self.normalize(flat, lens)
        return self.encoder(flat, lens, channel_size=c)
