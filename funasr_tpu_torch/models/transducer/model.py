"""Transducer (RNN-T) ASR in PyTorch (counterpart of
``funasr_tpu/models/transducer/model.py``; FunASR ``funasr/models/transducer/model.py:39``):
an encoder, the LSTM prediction net over the label prefix (``RNNTDecoder``) and the
joint network ``W_out tanh(W_enc enc + W_pred pred)``.

``forward(speech, speech_lengths, text, text_lengths, generator=)`` is the training loss
(``forward_jit``, ``model.py:114-128``): the targets zeroed past each length, a leading
blank, the joint over the whole (B, T, U + 1, V) lattice in fp32 and ``ops/rnnt_loss.py``;
the loss is the batch mean of the NLL, not normalised by length. ``greedy_decode`` is the
batched greedy decode as a loop on the device (``_greedy_decode_jit_impl``, ``:149-185``:
at most 3 symbols a frame, emission masking, ``max_tokens``), with no host read inside
it: one copy of the (B, max_tokens) ids and counts at the end.
``_greedy_decode_host`` (``:187``), one utterance and one host read a symbol at a time,
is its plain version. ``init_stream`` / ``decode_chunk`` (``:215-254``) carry the
prediction net's state over the chunks of a ``ChunkConformerEncoder``, so the chunks'
emissions join into the offline greedy ids over the chunk-causal encoder output.

State-dict names are FunASR's: ``encoder.*``, ``decoder.embed``, ``decoder.rnn.{i}``
(one-layer ``nn.LSTM``s: ``weight_ih_l0`` ...), ``joint_network.lin_{enc,dec,out}``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
from torch import nn

from funasr_tpu_torch.core.layers import (apply_linear, embedding, lstm_apply, lstm_step,
                                          make_pad_mask)
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.ops.rnnt_loss import rnnt_loss
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video


class JointNetwork(nn.Module):
    """joint(enc, pred) = W_out tanh(W_enc enc + W_pred pred) (``JointNetwork``,
    ``model.py:26-47``); enc (..., E) and pred (..., D) broadcast -> (..., V)."""

    def __init__(self, vocab_size: int, encoder_size: int, decoder_size: int,
                 joint_space_size: int = 640, device=None):
        super().__init__()
        self.lin_enc = nn.Linear(encoder_size, joint_space_size, device=device)
        self.lin_dec = nn.Linear(decoder_size, joint_space_size, device=device)
        self.lin_out = nn.Linear(joint_space_size, vocab_size, device=device)

    def forward(self, enc, dec):
        h = torch.tanh(apply_linear(self.lin_enc, enc) + apply_linear(self.lin_dec, dec))
        return apply_linear(self.lin_out, h)


@tables.register("decoder_classes", "rnnt_decoder")
@tables.register("decoder_classes", "RNNTDecoder")
class RNNTDecoder(nn.Module):
    """The prediction network (``RNNTDecoder``, ``model.py:288-316``; FunASR
    ``transducer/rnnt_decoder.py:15``): an embedding and a stack of one-layer LSTMs over
    the label prefix. ``forward(ys)`` runs the prefix, ``init_state`` / ``step`` one label
    a step (``_predict_init`` / ``_predict_step``)."""

    def __init__(self, vocab_size: int, embed_size: int = 256, hidden_size: int = 256,
                 num_layers: int = 1, device=None, **kwargs):
        super().__init__()
        self.hidden_size = hidden_size
        self.embed = nn.Embedding(vocab_size, embed_size, device=device)
        # a Sequential, not a ModuleList: lstm_apply / lstm_step read the weights without
        # calling the LSTMs, so FSDP2 must keep them with the root
        # (parallel/sharding.py::layer_units); the names stay rnn.{i}.weight_ih_l0
        self.rnn = nn.Sequential(*(
            nn.LSTM(embed_size if i == 0 else hidden_size, hidden_size, batch_first=True,
                    device=device) for i in range(num_layers)))

    def output_size(self) -> int:
        return self.hidden_size

    def forward(self, ys, ys_lens=None):
        """(B, U) ids -> ((B, U, H) fp32, ys_lens)."""
        x = embedding(ys, self.embed.weight)
        for lstm in self.rnn:
            x = lstm_apply(lstm, x)
        return x, ys_lens

    def init_state(self, batch: int, device=None):
        """A zero (h, c) per layer, each (B, H) fp32."""
        device = device if device is not None else self.embed.weight.device
        return [(torch.zeros(batch, self.hidden_size, device=device),
                 torch.zeros(batch, self.hidden_size, device=device)) for _ in self.rnn]

    def step(self, token, states):
        """token (B,) -> ((B, H), the new states)."""
        x = embedding(token, self.embed.weight)
        new = []
        for lstm, st in zip(self.rnn, states):
            x, st = lstm_step(lstm, x, st)
            new.append(st)
        return x, new


@tables.register("model_classes", "Transducer")
class Transducer(nn.Module):
    def __init__(self, encoder: str = "ConformerEncoder", encoder_conf: Optional[Dict] = None,
                 decoder_conf: Optional[Dict] = None,
                 joint_network_conf: Optional[Dict] = None, specaug: Optional[str] = None,
                 specaug_conf: Optional[Dict] = None, input_size: int = 80,
                 vocab_size: int = -1, blank_id: int = 0, ignore_id: int = -1, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: when given, every weight is drawn from it (the JAX package's init
        rules, ``core/module.py::init_weights``)."""
        super().__init__()
        self.encoder = tables.encoder_classes[encoder](input_size=input_size, device=device,
                                                       **(encoder_conf or {}))
        dec = dict(decoder_conf or {})
        self.decoder = RNNTDecoder(vocab_size, dec.get("embed_size", 256),
                                   dec.get("hidden_size", 256), dec.get("num_layers", 1),
                                   device=device)
        self.joint_network = JointNetwork(
            vocab_size, self.encoder.output_size(), self.decoder.output_size(),
            dict(joint_network_conf or {}).get("joint_space_size", 640), device=device)
        self.specaug = (tables.specaug_classes[specaug](**(specaug_conf or {}))
                        if specaug else None)
        self.vocab_size = vocab_size
        self.blank_id = blank_id
        self.ignore_id = ignore_id
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def encode(self, speech, speech_lengths, generator=None):
        """SpecAug (``train()`` mode with a generator), then the encoder."""
        if self.specaug is not None and self.training and generator is not None:
            speech, speech_lengths = self.specaug(speech, speech_lengths, generator)
        return self.encoder(speech, speech_lengths, generator=generator)

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        """One batch's training loss -> (loss, {"loss"}, batch size)."""
        enc, enc_lens = self.encode(speech, speech_lengths, generator)
        b, u = text.shape
        tgt = torch.where(make_pad_mask(text_lengths, u), text, 0)
        ys_in = torch.cat([torch.full((b, 1), self.blank_id, dtype=tgt.dtype,
                                      device=tgt.device), tgt], dim=1)
        pred, _ = self.decoder(ys_in)  # (B, U + 1, H)
        logits = self.joint_network(enc[:, :, None, :].float(), pred[:, None])
        nll = rnnt_loss(logits, tgt, enc_lens, text_lengths, self.blank_id)
        loss = nll.mean()
        return loss, {"loss": loss}, b

    # ---- greedy decoding -------------------------------------------------------------

    def _greedy_loop(self, enc, enc_lens, pred, states, max_symbols_per_step: int,
                     max_tokens: int):
        """The frame loop of ``_greedy_decode_jit_impl`` on enc's device: every step runs
        the joint, the argmax and the prediction step for the whole batch and keeps the
        new state only where a symbol was emitted. -> (ids (B, max_tokens), counts (B,),
        pred, states), all on the device."""
        b = enc.shape[0]
        dev = enc.device
        out = torch.zeros(b, max_tokens, dtype=torch.int32, device=dev)
        n = torch.zeros(b, dtype=torch.int32, device=dev)
        rows = torch.arange(b, device=dev)
        enc_lens = enc_lens.to(dev)
        for t in range(enc.shape[1]):
            active = t < enc_lens
            enc_t = enc[:, t].float()
            for _ in range(max_symbols_per_step):
                tok = self.joint_network(enc_t, pred).argmax(-1).to(torch.int32)
                emit = active & (tok != self.blank_id) & (n < max_tokens)
                idx = torch.clamp(n, max=max_tokens - 1).long()
                out[rows, idx] = torch.where(emit, tok, out[rows, idx])
                n = n + emit.to(torch.int32)
                new_pred, new_states = self.decoder.step(tok, states)
                keep = emit[:, None]
                pred = torch.where(keep, new_pred, pred)
                states = [(torch.where(keep, h2, h1), torch.where(keep, c2, c1))
                          for (h1, c1), (h2, c2) in zip(states, new_states)]
                active = emit
        return out, n, pred, states

    def _start(self, batch: int):
        states = self.decoder.init_state(batch)
        return self.decoder.step(torch.full((batch,), self.blank_id, dtype=torch.int32,
                                            device=self.device), states)

    @torch.no_grad()
    def greedy_decode(self, enc, enc_lens, max_symbols_per_step: int = 3) -> List[List[int]]:
        """Batched greedy transducer decode (``greedy_decode``, ``model.py:131-147``) ->
        token ids per utterance."""
        b, tmax, _ = enc.shape
        pred, states = self._start(b)
        out, n, _, _ = self._greedy_loop(enc, torch.as_tensor(enc_lens), pred, states,
                                         max_symbols_per_step, tmax * max_symbols_per_step)
        out, n = out.cpu(), n.cpu()
        return [out[i, : int(n[i])].tolist() for i in range(b)]

    @torch.no_grad()
    def _greedy_decode_host(self, enc, enc_lens, max_symbols_per_step: int = 3):
        """The plain version: one utterance, one frame and one symbol at a time, a host
        read a symbol (``_greedy_decode_host``, ``model.py:187-212``)."""
        results = []
        for i in range(enc.shape[0]):
            tokens: List[int] = []
            pred, states = self._start(1)
            for t in range(int(enc_lens[i])):
                for _ in range(max_symbols_per_step):
                    logits = self.joint_network(enc[i, t].float()[None], pred)
                    tok = int(logits[0].argmax())
                    if tok == self.blank_id:
                        break
                    tokens.append(tok)
                    pred, states = self.decoder.step(
                        torch.full((1,), tok, dtype=torch.int32, device=enc.device), states)
            results.append(tokens)
        return results

    # ---- streaming -------------------------------------------------------------------

    @torch.no_grad()
    def init_stream(self, batch: int = 1):
        """The state ``decode_chunk`` carries (``init_stream``, ``model.py:215-231``): the
        encoder's caches (an encoder with ``init_cache`` / ``forward_chunk``, e.g.
        ``ChunkConformerEncoder``), the prediction net's state after the leading blank and
        the tokens so far."""
        if not hasattr(self.encoder, "forward_chunk"):
            raise ValueError(f"encoder {type(self.encoder).__name__} has no forward_chunk; "
                             "use ChunkConformerEncoder")
        pred, states = self._start(batch)
        return {"encoder": self.encoder.init_cache(batch, device=self.device),
                "tokens": [[] for _ in range(batch)], "pred_states": states, "preds": pred}

    @torch.no_grad()
    def decode_chunk(self, chunk, state, max_symbols_per_step: int = 3):
        """chunk (B, chunk_size, D) after the subsampling -> (the tokens it emitted per
        utterance, the state) (``decode_chunk``, ``model.py:233-254``): one copy of the
        chunk's ids to the host."""
        enc, state["encoder"] = self.encoder.forward_chunk(chunk, state["encoder"])
        b, t_chunk = enc.shape[:2]
        out, n, state["preds"], state["pred_states"] = self._greedy_loop(
            enc, torch.full((b,), t_chunk, dtype=torch.int32), state["preds"],
            state["pred_states"], max_symbols_per_step, t_chunk * max_symbols_per_step)
        out, n = out.cpu(), n.cpu()
        new_tokens = []
        for i in range(b):
            emitted = out[i, : int(n[i])].tolist()
            state["tokens"][i].extend(emitted)
            new_tokens.append(emitted)
        return new_tokens, state

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """waveforms -> text: one batch encode, then ``greedy_decode`` (``inference``,
        ``model.py:256-285``). Returns (results, meta): one ``{"key", "text"}`` per input
        (``{"key", "token_int"}`` without a tokenizer)."""
        meta: Dict = {}
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend,
                                               device=self.device)
        # the frontend pads the frames to its bucket; the batch is cut back to its longest
        # utterance, as the JAX package batches it
        speech = speech[:, : int(speech_lengths.max())]
        meta["batch_data_time"] = (float(speech_lengths.sum()) * frontend.frame_shift_ms
                                   * getattr(frontend, "lfr_n", 1) / 1000)
        with torch.inference_mode():
            enc, enc_lens = self.encoder(speech.to(self.dtype), speech_lengths)
            token_lists = self.greedy_decode(enc, enc_lens)
        if key is None:
            key = [f"rand_key_{i}" for i in range(len(token_lists))]
        results = []
        for i, ids in enumerate(token_lists):
            if tokenizer is not None:
                text, _ = postprocess_utils.sentence_postprocess(tokenizer.ids2tokens(ids))
                results.append({"key": key[i], "text": text})
            else:
                results.append({"key": key[i], "token_int": ids})
        return results, meta
