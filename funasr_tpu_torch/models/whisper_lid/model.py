"""Whisper-encoder + ERes2NetV2 language identification in PyTorch (counterpart of
``funasr_tpu/models/whisper_lid/model.py``; FunASR ``funasr/models/whisper_lid/
model.py:524`` ``OpenAIWhisperLIDModel``).

The Whisper encoder (``models/whisper/model.py``'s, at ``whisper-small`` by default; its
attention is plain PyTorch, as the JAX package computes it with einsums) gives frame
features, ``proj_layer`` maps them to ``proj_dim`` (when the widths differ), the port's
``ERes2NetV2`` (registered here as ``LidPredictor`` in ``lid_predictor_classes``) pools
them into one utterance embedding, and ``output_layer`` classifies the language.
``clip_frames`` keeps the first frames only. ``forward`` is the cross-entropy on the
first label (``acc_lid``), the predictor's batch norms on their running statistics in
training too, as in the JAX package; ``inference`` gives {"key", "text" (the label),
"lid_logits"}.
Parameter names: ``encoder.*`` (the Whisper encoder under Hugging Face names),
``lid_predictor.*`` (ERes2NetV2's FunASR names), ``proj_layer``, ``output_layer``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.losses.label_smoothing_loss import label_smoothing_loss
from funasr_tpu_torch.models.eres2net.model import ERes2NetV2
from funasr_tpu_torch.models.whisper.model import (SIZES, WhisperConfig, WhisperEncoder,
                                                   encode_mel)
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video

tables.register("lid_predictor_classes", "LidPredictor")(ERes2NetV2)


@tables.register("model_classes", "OpenAIWhisperLIDModel")
@tables.register("model_classes", "WhisperLID")
class OpenAIWhisperLIDModel(nn.Module):
    def __init__(self, vocab_size: int, encoder: str = "whisper-small",
                 encoder_conf: Optional[Dict] = None, lid_predictor: str = "LidPredictor",
                 lid_predictor_conf: Optional[Dict] = None, proj_dim: int = 80,
                 clip_frames: Optional[int] = None, random_clip: bool = False, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        enc_conf = dict(encoder_conf or {})
        size = enc_conf.pop("whisper_size", encoder if encoder.startswith("whisper")
                            else "whisper-small")
        conf = dict(SIZES.get(size, {}))
        conf.update({k: v for k, v in enc_conf.items() if k in WhisperConfig._fields})
        self.cfg = WhisperConfig(**conf)
        self.encoder = WhisperEncoder(self.cfg, device)
        pred_conf = dict(lid_predictor_conf or {})
        pred_conf.setdefault("feat_dim", proj_dim)
        self.lid_predictor = tables.lid_predictor_classes[lid_predictor](device=device,
                                                                         **pred_conf)
        self.proj_dim = proj_dim
        self.vocab_size = vocab_size
        self.clip_frames = clip_frames
        self.random_clip = random_clip
        self.d_model = self.cfg.d_model
        self.output_layer = nn.Linear(self.lid_predictor.embedding_size, vocab_size,
                                      device=device)
        self.proj_layer = (nn.Linear(self.d_model, proj_dim, device=device)
                           if self.d_model != proj_dim else None)
        if generator is not None:
            init_weights(self, generator)

    def train(self, mode: bool = True):
        """The batch norms of the LID predictor stay in eval mode (their running
        statistics), as the JAX package's ERes2NetV2 always applies them."""
        super().train(mode)
        self.lid_predictor.eval()
        return self

    @property
    def device(self) -> torch.device:
        return self.output_layer.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.output_layer.weight.dtype

    def features(self, speech, speech_lengths=None):
        enc = encode_mel(self.encoder, speech)
        if self.proj_layer is not None:
            enc = apply_linear(self.proj_layer, enc)
        if self.clip_frames is not None:
            enc = enc[:, : self.clip_frames]
        return enc

    def logits(self, speech, speech_lengths=None):
        """mel (B, T, n_mels) -> (B, vocab) language logits."""
        emb = self.lid_predictor(self.features(speech, speech_lengths))
        return apply_linear(self.output_layer, emb)

    def forward(self, speech, speech_lengths, lid, lid_lengths=None, generator=None,
                **kwargs):
        logits = self.logits(speech, speech_lengths)
        loss = label_smoothing_loss(logits[:, None, :], lid[:, :1], ignore_id=-1,
                                    smoothing=0.0, vocab_size=self.vocab_size,
                                    normalize_length=False)
        acc = (logits.argmax(-1) == lid[:, 0]).float().mean()
        b = speech.shape[0]
        return loss, {"loss": loss, "acc_lid": acc, "batch_size": torch.tensor(b)}, b

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs if frontend else 16000, audio_fs=kwargs.get("fs", 16000))
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend)
        with torch.inference_mode():
            logits = self.logits(torch.from_numpy(speech).to(self.device, self.dtype)
                                 ).float().cpu().numpy()
        ids = logits.argmax(-1)
        if key is None:
            key = [f"rand_key_{i}" for i in range(len(ids))]
        results = []
        for i, lid in enumerate(ids):
            text = (tokenizer.ids2tokens([int(lid)])[0] if tokenizer is not None
                    else str(int(lid)))
            results.append({"key": key[i], "text": text, "lid_logits": logits[i].tolist()})
        return results, {}
