"""EEND-OLA in PyTorch: end-to-end neural diarization with encoder-decoder attractors
and power-set encoding (counterpart of ``funasr_tpu/models/eend/model.py``; FunASR
``funasr/models/eend/e2e_diar_eend_ola.py:90``, ``encoder.py:124``,
``encoder_decoder_attractor.py:7``, ``utils/power.py``), under FunASR's state-dict names
(``enc.linear_in``, ``enc.lnorm1_{i}``, ``enc.self_att_{i}.linearQ``, ``enc.ff_{i}``,
``encoder_decoder_attractor.{encoder,decoder,counter}``, ``postnet``, ``output_layer``),
which the JAX package's ``convert_eend_ola`` reads.

* Encoder: linear_in -> N x [lnorm1 -> MHSA (+res) -> lnorm2 -> FF (+res)] -> lnorm_out,
  the LayerNorms at eps 1e-5 (``nn.LayerNorm``'s, not the package's 1e-12). The attention
  is softmax(QK^T / sqrt(D)) V under the key-padding mask: ``ops/flash_attention.py::
  flash_attention`` in mode "none" with the utterances' lengths (T without them), the
  flash kernel on CUDA (4 heads x 64 at the published width). The JAX package fills
  masked scores with -1e9, the kernel with -1e30: the same softmax, and a row of length 0
  gets the uniform average of V in both.
* EDA: an LSTM over the frame embeddings, whose final (h, c) seeds an LSTM decoder over
  zero inputs; one attractor a step and a linear existence counter. The LSTMs and the
  PostNet run on ``core/layers.py::lstm_apply``.
* ``activities``, ``estimate_sequential`` (attractors cut at the first existence
  probability under the threshold, the PostNet's power-set argmax, an OOV frame carrying
  the previous one), ``inference`` (segments in ms) and the PIT loss ``forward`` (BCE over
  the speaker permutations, attractor existence, power-set CE; the stats under JAX's
  names).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, layer_norm, lstm_apply, make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.ops.flash_attention import flash_attention
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video

LN_EPS_TORCH = 1e-5  # the reference's nn.LayerNorm default


def generate_mapping_dict(max_speaker_num: int = 8, max_olp_speaker_num: int = 3) -> Dict:
    """Power-set labels for up to ``max_olp_speaker_num`` overlapping speakers: each
    allowed activity bitmask (little-endian speaker bits) gets a dense label id; everything
    else maps to ``oov``."""
    kinds = {0}
    for n_olp in range(1, max_olp_speaker_num + 1):
        for com in itertools.combinations(range(max_speaker_num), n_olp):
            kinds.add(sum(1 << s for s in com))
    ordered = sorted(kinds)
    return {"dec2label": {dec: i for i, dec in enumerate(ordered)},
            "label2dec": {i: dec for i, dec in enumerate(ordered)},
            "oov": len(ordered)}


def powerlabel_table(mapping_dict: Dict, max_speaker_num: int) -> np.ndarray:
    """Dense (2^S,) bitmask -> label table (oov elsewhere)."""
    table = np.full((1 << max_speaker_num,), mapping_dict["oov"], np.int32)
    for dec, label in mapping_dict["dec2label"].items():
        table[dec] = label
    return table


def label_to_bits_table(mapping_dict: Dict, max_speaker_num: int) -> np.ndarray:
    """(n_labels+1, S) label -> activity bits (oov row = zeros)."""
    out = np.zeros((mapping_dict["oov"] + 1, max_speaker_num), np.float32)
    for label, dec in mapping_dict["label2dec"].items():
        for s in range(max_speaker_num):
            out[label, s] = (dec >> s) & 1
    return out


def _ln(x, norm: nn.LayerNorm):
    return layer_norm(x, norm.weight, norm.bias, LN_EPS_TORCH)


@tables.register("encoder_classes", "EENDOLATransformerEncoder")
class EENDOLATransformerEncoder(nn.Module):
    def __init__(self, idim: int, n_layers: int = 4, n_units: int = 256,
                 e_units: int = 2048, h: int = 4, device=None, **kwargs):
        super().__init__()
        self.idim, self.n_layers, self.n_units, self.e_units, self.h = (
            idim, n_layers, n_units, e_units, h)
        self.linear_in = nn.Linear(idim, n_units, device=device)
        for i in range(n_layers):
            setattr(self, f"lnorm1_{i}", nn.LayerNorm(n_units, eps=LN_EPS_TORCH, device=device))
            att = nn.Module()
            for name in ("linearQ", "linearK", "linearV", "linearO"):
                setattr(att, name, nn.Linear(n_units, n_units, device=device))
            setattr(self, f"self_att_{i}", att)
            setattr(self, f"lnorm2_{i}", nn.LayerNorm(n_units, eps=LN_EPS_TORCH, device=device))
            ff = nn.Module()
            ff.linear1 = nn.Linear(n_units, e_units, device=device)
            ff.linear2 = nn.Linear(e_units, n_units, device=device)
            setattr(self, f"ff_{i}", ff)
        self.lnorm_out = nn.LayerNorm(n_units, eps=LN_EPS_TORCH, device=device)

    def output_size(self) -> int:
        return self.n_units

    def _mhsa(self, att, x, lengths):
        b, t, d = x.shape
        dk = d // self.h

        def split(y):  # (B, H, T, dk) head views of the (B, T, D) projection
            return y.reshape(b, t, self.h, dk).transpose(1, 2)

        q, k, v = (split(apply_linear(getattr(att, n), x))
                   for n in ("linearQ", "linearK", "linearV"))
        ctx = flash_attention(q, k, v, lengths)
        return apply_linear(att.linearO, ctx.transpose(1, 2).reshape(b, t, d))

    def forward(self, x, ilens=None):
        """x: (B, T, idim) -> ((B, T, n_units), ilens)."""
        b, t = x.shape[:2]
        lengths = (torch.full((b,), t, dtype=torch.int32, device=x.device) if ilens is None
                   else ilens.to(device=x.device, dtype=torch.int32))
        e = apply_linear(self.linear_in, x)
        for i in range(self.n_layers):
            e = _ln(e, getattr(self, f"lnorm1_{i}"))
            e = e + self._mhsa(getattr(self, f"self_att_{i}"), e, lengths)
            e = _ln(e, getattr(self, f"lnorm2_{i}"))
            ff = getattr(self, f"ff_{i}")
            e = e + apply_linear(ff.linear2, torch.relu(apply_linear(ff.linear1, e)))
        return _ln(e, self.lnorm_out), ilens


@tables.register("model_classes", "DiarEENDOLA")
@tables.register("model_classes", "EENDOLA")
class DiarEENDOLA(nn.Module):
    def __init__(self, encoder: str = "EENDOLATransformerEncoder",
                 encoder_conf: Optional[dict] = None, input_size: int = 345,
                 n_units: int = 256, max_n_speaker: int = 8,
                 attractor_threshold: float = 0.5, frame_shift_ms: int = 100,
                 attractor_loss_weight: float = 1.0, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        enc_conf = dict(encoder_conf or {})
        enc_conf.setdefault("n_units", n_units)
        self.enc = tables.encoder_classes[encoder](idim=input_size, device=device, **enc_conf)
        d = self.n_units = self.enc.output_size()
        self.max_n_speaker = max_n_speaker
        self.attractor_threshold = attractor_threshold
        self.frame_shift_ms = frame_shift_ms
        self.attractor_loss_weight = attractor_loss_weight
        self.mapping_dict = generate_mapping_dict(max_speaker_num=max_n_speaker)
        self._power_table = powerlabel_table(self.mapping_dict, max_n_speaker)
        self._bits_table = label_to_bits_table(self.mapping_dict, max_n_speaker)
        eda = self.encoder_decoder_attractor = nn.Module()
        eda.encoder = nn.LSTM(d, d, 1, batch_first=True, device=device)
        eda.decoder = nn.LSTM(d, d, 1, batch_first=True, device=device)
        eda.counter = nn.Linear(d, 1, device=device)
        self.postnet = nn.LSTM(max_n_speaker, d, 1, batch_first=True, device=device)
        self.output_layer = nn.Linear(d, self.mapping_dict["oov"] + 1, device=device)
        if generator is not None:
            init_weights(self, generator)

    @property
    def encoder(self):
        return self.enc

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _attractors(self, emb, n_att: int):
        """emb: (B, T, D) -> (attractors (B, n_att, D), existence logits (B, n_att))."""
        eda = self.encoder_decoder_attractor
        _, state = lstm_apply(eda.encoder, emb, return_state=True)
        zeros = torch.zeros(emb.shape[0], n_att, self.n_units, device=emb.device)
        attractors = lstm_apply(eda.decoder, zeros, init=state)
        return attractors, apply_linear(eda.counter, attractors)[..., 0]

    def forward_post_net(self, logits):
        """(B, T, max_n_speaker) activity logits -> power-set label logits."""
        return apply_linear(self.output_layer, lstm_apply(self.postnet, logits))

    def activities(self, speech, speech_lengths, n_spk: Optional[int] = None):
        """-> (per-frame speaker activity probs (B, T, S), existence probs (B, S+1),
        enc_lens)."""
        s = n_spk if n_spk is not None else self.max_n_speaker
        logits, exist_logits, _, enc_lens = self._speaker_logits(speech, speech_lengths, s)
        return torch.sigmoid(logits), torch.sigmoid(exist_logits), enc_lens

    def _speaker_logits(self, speech, speech_lengths, s: int):
        """-> (frame x attractor logits (B, T, s), existence logits (B, s + 1), frame
        embeddings, enc_lens): the encoder, s + 1 attractors, their products."""
        emb, enc_lens = self.enc(speech, speech_lengths)
        attractors, exist_logits = self._attractors(emb, s + 1)
        logits = torch.einsum("btd,bsd->bts", emb.float(), attractors[:, :s])
        return logits, exist_logits, emb, enc_lens

    def forward(self, speech, speech_lengths, labels, label_lengths=None, **kwargs):
        """labels: (B, T, S) binary speaker activities -> (loss, stats, B). Loss = PIT BCE
        over the speaker permutations + attractor existence BCE + power-set CE through the
        PostNet (``forward_jit``; exact permutations, for S <= 4 training labels)."""
        s = labels.shape[-1]
        logits, exist_logits, emb, enc_lens = self._speaker_logits(speech, speech_lengths, s)
        probs = torch.sigmoid(logits)
        t = probs.shape[1]
        mask = make_pad_mask(enc_lens.to(emb.device), t)[..., None].float()
        labels = labels[:, :t].float()
        eps = 1e-7

        def bce(p, y):
            per = -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
            return (per * mask).sum((1, 2))

        perms = list(itertools.permutations(range(s)))
        losses = torch.stack([bce(probs[:, :, list(p)], labels) for p in perms], 1)
        pit, best = losses.min(1)
        loss_diar = pit.sum() / mask.sum().clamp_min(1.0)

        exist = torch.sigmoid(exist_logits)
        n_active = (labels.amax(1) > 0.5).sum(-1)
        tgt_exist = (torch.arange(exist.shape[1], device=exist.device)[None]
                     < n_active[:, None]).float()
        loss_exist = -(tgt_exist * torch.log(exist + eps)
                       + (1 - tgt_exist) * torch.log(1 - exist + eps)).mean()

        # the best permutation's labels as power-set labels (the dense bitmask table)
        perm_arr = torch.tensor(perms, device=labels.device)
        labels_pit = labels.gather(2, perm_arr[best][:, None, :].expand(-1, t, -1))
        bits = (labels_pit > 0.5).long()
        dec = (bits * (2 ** torch.arange(s, device=labels.device))).sum(-1)
        power_tgt = torch.from_numpy(self._power_table).to(labels.device).long()[dec]
        logits_pad = F.pad(logits, (0, self.max_n_speaker - s))
        logp = torch.log_softmax(self.forward_post_net(logits_pad).float(), -1)
        pse_ce = -logp.gather(-1, power_tgt[..., None])[..., 0]
        loss_pse = (pse_ce * mask[..., 0]).sum() / mask[..., 0].sum().clamp_min(1.0)

        loss = loss_pse + loss_diar + self.attractor_loss_weight * loss_exist
        return loss, {"loss": loss, "pit_loss": loss_diar, "pse_loss": loss_pse,
                      "attractor_loss": loss_exist}, speech.shape[0]

    def speaker_counts(self, exist_probs, n_speakers: Optional[int] = None,
                       threshold: float = 0.5) -> List[int]:
        """Each utterance's speaker count: ``n_speakers`` when given (>= 0), else the index
        of its first existence probability under ``threshold`` (max_n_speaker if none)."""
        if n_speakers is not None and n_speakers >= 0:
            return [n_speakers] * len(exist_probs)
        counts = []
        for p in np.asarray(exist_probs):
            silent = np.nonzero(p < threshold)[0]
            counts.append(int(silent[0]) if silent.size else self.max_n_speaker)
        return counts

    def power_logits(self, emb, attractors, lengths, n_spks):
        """Each utterance's frame activities against its first n_spk attractors (zero
        attractors beyond), through the PostNet at its own length -> a list of (T_i,
        n_labels) power-set logits."""
        out = []
        for i, n_spk in enumerate(n_spks):
            pad_att = torch.zeros(self.max_n_speaker, self.n_units, device=emb.device)
            n = min(n_spk, self.max_n_speaker)
            pad_att[:n] = attractors[i, :n].float()
            ys = emb[i, : int(lengths[i])].float() @ pad_att.T
            out.append(self.forward_post_net(ys[None])[0])
        return out

    def estimate_sequential(self, speech, speech_lengths, n_speakers: Optional[int] = None,
                            threshold: float = 0.5):
        """``estimate_sequential:235`` with shuffle=False: up to max_n_speaker attractors,
        the speaker count (``speaker_counts``), the PostNet's power-set argmax
        (``power_logits``), an OOV frame carrying the previous one (reference
        ``:296-321``). Returns a list of (T_i, n_spk_i) numpy activity matrices."""
        with torch.inference_mode():
            emb, enc_lens = self.enc(speech, speech_lengths)
            attractors, exist_logits = self._attractors(emb, self.max_n_speaker)
            n_spks = self.speaker_counts(torch.sigmoid(exist_logits).cpu().numpy(),
                                         n_speakers, threshold)
            lengths = ([emb.shape[1]] * emb.shape[0] if enc_lens is None
                       else enc_lens.cpu().tolist())
            preds = [lg.argmax(-1).cpu().numpy()
                     for lg in self.power_logits(emb, attractors, lengths, n_spks)]
        oov = self.mapping_dict["oov"]
        decisions = []
        for pred, n_spk in zip(preds, n_spks):
            for tt in range(len(pred)):
                if pred[tt] == oov:
                    pred[tt] = pred[tt - 1] if tt > 0 else 0
            decisions.append(self._bits_table[pred][:, :n_spk])
        return decisions

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs if frontend else 8000, audio_fs=kwargs.get("fs", 16000))
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend,
                                               device=self.device)
        decisions = self.estimate_sequential(
            speech, speech_lengths, n_speakers=kwargs.get("n_speakers"),
            threshold=kwargs.get("threshold", self.attractor_threshold))
        if key is None:
            key = [f"rand_key_{i}" for i in range(len(decisions))]
        return [{"key": key[i], "n_speakers": act.shape[1],
                 "value": activity_segments(act, self.frame_shift_ms)}
                for i, act in enumerate(decisions)], {}


def activity_segments(act: np.ndarray, frame_shift_ms: int):
    """(T, S) 0/1 activities -> [[speaker, start ms, end ms], ...] sorted by start."""
    segments = []
    for s in range(act.shape[1]):
        on = None
        for t in range(act.shape[0]):
            if act[t, s] > 0.5 and on is None:
                on = t
            elif act[t, s] <= 0.5 and on is not None:
                segments.append([s, on * frame_shift_ms, t * frame_shift_ms])
                on = None
        if on is not None:
            segments.append([s, on * frame_shift_ms, act.shape[0] * frame_shift_ms])
    return sorted(segments, key=lambda x: x[1])
