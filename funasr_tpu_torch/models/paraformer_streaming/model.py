"""ParaformerStreaming in PyTorch: chunked low-latency NAR ASR, 600 ms a chunk by default
(counterpart of ``funasr_tpu/models/paraformer_streaming/model.py:66-378``; FunASR
``funasr/models/paraformer_streaming/model.py``).

``inference`` is the JAX package's stride loop: the call's audio after the carried
``prev_samples``, cut into ``chunk_size[1] * 960``-sample chunks (600 ms at
``[0, 10, 5]``), each through ``WavFrontendOnline`` (``extract_fbank`` with the
frontend's cache, on the host) and ``generate_chunk``; a final chunk under 960 samples
re-runs the encoder's carried rows instead (the tail chunk); ``is_final`` resets the
cache afterwards. ``generate_chunk`` runs the chunk encoder (``SANMEncoderChunkOpt``),
the streaming CIF (``CifPredictorV2.forward_chunk``, its fired count left on the device)
and the streaming decoder over the padded ``t + 1`` token bucket, then the argmax; the
fired count and the ids come to the host together in the chunk's one device-to-host
copy, as ``_fused_chunk_jit``'s single fetch does (``:29-63``). The features go up
from pinned memory without a wait. Kernel launches per chunk at Paraformer-large width
(50 + 16 blocks): 50 flash attention (15 query rows over the cached keys), 50 FSMN at
k = 11 / pads (5, 5) in the encoder and 16 at pads (10, 0) in the decoder.

The cache is the JAX package's dict ({"encoder", "decoder", "frontend",
"prev_samples"}) with torch tensors on the model's device; the per-layer K/V caches are
lists.

``forward`` is the training loss under overlap-chunk masks (``forward_jit``, ``:76-218``),
-> (loss, stats, weight) as ``Paraformer.forward``: one chunk config of the encoder's
``overlap_chunk_cls`` drawn from the step's generator (or given, ``chunk_index``), its
masks built on the host at the batch's padded length and padded to the configs' common
shape (``chunk_masks``, the encoder's, kept per length and device), the chunked lengths from JAX's
formula, SpecAug (``train()`` mode with a generator) and normalize, the encoder's
``forward_train_chunk`` (every self-attention on the flash kernels' chunk mode, no
dropout), CTC on ``remove_chunk``'s output, the CIF predictor on the chunked output times
the FSMN-shift mask under the pad and stride-region mask (a mask with holes), the glancing
sampler and the decoder on the un-chunked memory, the loss, stats and weight.

One departure: an int16 waveform is scaled to [-1, 1) before the stride loop (as
``load_audio``'s other outputs are). The JAX loop casts it to float32 unscaled, so its
features come out 32768 times too loud (ROADMAP section 3); float input, the
reference's, is unchanged.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from funasr_tpu_torch.core.layers import make_pad_mask
from funasr_tpu_torch.models.paraformer.model import Paraformer, add_sos_eos_out
from funasr_tpu_torch.models.scama import encoder as _scama_encoder  # noqa: F401 (registers)
from funasr_tpu_torch.models.scama.chunk_utils import remove_chunk
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.load_utils import (as_unit_f32, extract_fbank,
                                               load_audio_text_image_video)


def upload(array, device, dtype):
    """Host features -> ``device`` in ``dtype``; to a GPU from pinned memory without a
    host wait."""
    x = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x.to(dtype)


@tables.register("model_classes", "ParaformerStreaming")
class ParaformerStreaming(Paraformer):
    def __init__(self, encoder: str = "SANMEncoderChunkOpt", **kwargs):
        super().__init__(encoder=encoder, **kwargs)

    # ------------------------------------------------------------------
    # training with overlap-chunk masks
    # ------------------------------------------------------------------

    def chunk_masks(self, l_max: int, ind: int, device):
        """Config ``ind``'s masks at ``l_max``, padded to the configs' common shape
        (``SANMEncoderChunkOpt.chunk_masks`` with ``stacked``, as ``forward_jit`` pads
        them)."""
        return self.encoder.chunk_masks(l_max, ind, device, stacked=True)

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None,
                sampler_uniform=None, chunk_index=None):
        """One batch's training loss under overlap-chunk masks (``forward_jit``): as
        ``Paraformer.forward`` -> (loss, stats, weight). The chunk config is drawn from
        ``generator`` (uniformly over the encoder's configs, on the generator's device), or
        ``chunk_index`` pins it; ``sampler_uniform`` replaces the sampler's draws."""
        oc = self.encoder.overlap_chunk_cls
        if chunk_index is None:
            dev = generator.device if generator is not None else speech.device
            chunk_index = int(torch.randint(len(oc.chunk_size), (), generator=generator,
                                            device=dev))
        masks = dict(self.chunk_masks(int(speech.shape[1]), chunk_index, speech.device))
        masks["x_len_chunk"] = self.encoder.chunk_lengths(speech_lengths, masks)
        if self.specaug is not None and self.training and generator is not None:
            speech, speech_lengths = self.specaug(speech, speech_lengths, generator)
        if self.normalize is not None:
            speech, speech_lengths = self.normalize(speech, speech_lengths)
        enc_chunk, enc_chunk_lens = self.encoder.forward_train_chunk(speech, speech_lengths,
                                                                     masks)
        # CTC, the sampler and the decoder on the un-chunked sequence
        enc_plain = remove_chunk(enc_chunk, enc_chunk_lens, masks["tables"])
        loss_ctc = None
        if self.ctc is not None and self.ctc_weight > 0.0:
            loss_ctc = self.ctc.loss(enc_plain, speech_lengths, text, text_lengths)

        ys_pad, ys_pad_lens = text, text_lengths
        if self.predictor_bias == 1:
            ys_pad = add_sos_eos_out(text, text_lengths, self.eos, self.ignore_id)
            ys_pad_lens = text_lengths + 1

        # the predictor on the chunked sequence: alphas only in the stride regions
        pad_ok = make_pad_mask(enc_chunk_lens, enc_chunk.shape[1])
        pred_mask = pad_ok & masks["mask_chunk_predictor"][None]
        hidden = enc_chunk * masks["mask_shfit_chunk"][None, :, None].to(enc_chunk.dtype)
        pre_acoustic_embeds, pre_token_length, _, _ = self.predictor(
            hidden, pred_mask, ys_pad.shape[1], target_length=ys_pad_lens)
        return self.decoder_loss(enc_plain, speech_lengths, ys_pad, ys_pad_lens,
                                 pre_acoustic_embeds, pre_token_length, loss_ctc, text_lengths,
                                 generator, sampler_uniform)

    # ------------------------------------------------------------------
    # streaming inference
    # ------------------------------------------------------------------

    def init_cache(self, cache: Optional[Dict] = None, **kwargs) -> Dict:
        if cache is None:
            cache = {}
        chunk_size = kwargs.get("chunk_size", [0, 10, 5])
        enc = self.encoder.cfg
        cache["encoder"] = {
            "start_idx": 0,
            "cif_state": self.predictor.init_state(1, enc.output_size, self.device),
            "chunk_size": chunk_size,
            "encoder_chunk_look_back": kwargs.get("encoder_chunk_look_back", 0),
            "last_chunk": False,
            "opt": None,
            "feats": torch.zeros(1, chunk_size[0] + chunk_size[2], enc.input_size,
                                 dtype=self.dtype, device=self.device),
            "tail_chunk": False,
        }
        cache["decoder"] = {
            "decode_fsmn": None,
            "decoder_chunk_look_back": kwargs.get("decoder_chunk_look_back", 0),
            "opt": None,
            "chunk_size": chunk_size,
        }
        cache["frontend"] = {}
        cache["prev_samples"] = np.zeros((0,), np.float32)
        return cache

    def chunk_outputs(self, x, cache, is_final: bool):
        """The chunk's device work: features x (1, T, D) -> (encoder output, n_fired (1,)
        int32, decoder logits (1, tmax, vocab)); the caches are updated in place."""
        enc_cache = cache["encoder"]
        y = self.encoder.forward_chunk(x, enc_cache)
        embeds, n_fired, enc_cache["cif_state"] = self.predictor.forward_chunk(
            y, enc_cache["cif_state"], y.shape[1] + 1, is_final, tuple(enc_cache["chunk_size"]))
        logits = self.decoder.forward_chunk(y, embeds, n_fired[0], cache["decoder"])
        return y, n_fired, logits

    def generate_chunk(self, speech, speech_lengths=None, key=None, tokenizer=None,
                       frontend=None, cache: Optional[Dict] = None, **kwargs):
        """One streaming chunk: the device work and ONE device-to-host copy (the fired
        count and the ids together). ``speech``: host features (1, T, D), or the
        carried rows (a device tensor) for a tail chunk. Returns the chunk's tokens."""
        with torch.inference_mode():
            x = (speech if torch.is_tensor(speech)
                 else upload(speech, self.device, self.dtype))
            _, n_fired, logits = self.chunk_outputs(x, cache, kwargs.get("is_final", False))
            packed = torch.cat([n_fired, logits[0].argmax(dim=-1).to(torch.int32)])
            host = packed.cpu().numpy()
        n = int(host[0])
        if n < 1:
            return []
        token_int = [int(v) for v in host[1:1 + n]
                     if v not in (self.blank_id, self.sos, self.eos)]
        return tokenizer.ids2tokens(token_int) if tokenizer is not None else token_int

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, cache: Optional[Dict] = None, **kwargs):
        """One call of the stream (``model.py:316-378``): -> ([{"key", "text"}], meta)."""
        if cache is None:
            cache = {}
        if len(cache) == 0:
            self.init_cache(cache, **kwargs)

        meta: Dict = {}
        chunk_size = kwargs.get("chunk_size", [0, 10, 5])
        stride_samples = int(chunk_size[1] * 960)

        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000),
            data_type=kwargs.get("data_type", "sound"))
        is_final = kwargs.get("is_final", False) or isinstance(data_in, (str, bytes))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        if len(audio_list) != 1:
            raise ValueError("streaming batch_size must be 1")

        audio = np.concatenate([cache["prev_samples"], as_unit_f32(audio_list[0])])
        n = int(len(audio) // stride_samples + int(is_final))
        m = int(len(audio) % stride_samples * (1 - int(is_final)))

        tokens: List[str] = []
        for i in range(n):
            final_i = is_final and i == n - 1
            chunk = audio[i * stride_samples: (i + 1) * stride_samples]
            if final_i and len(chunk) < 960:
                cache["encoder"]["tail_chunk"] = True
                feats = cache["encoder"]["feats"]
                flens = np.asarray([feats.shape[1]], np.int32)
            else:
                feats, flens = extract_fbank([chunk], frontend=frontend,
                                             cache=cache["frontend"], is_final=final_i)
            if feats.shape[1] == 0 and not final_i:
                continue
            meta["batch_data_time"] = (float(np.sum(flens)) * frontend.frame_shift_ms
                                       * frontend.lfr_n / 1000)
            chunk_kwargs = {k: v for k, v in kwargs.items() if k != "is_final"}
            tokens.extend(self.generate_chunk(feats, flens, key=key, tokenizer=tokenizer,
                                              frontend=frontend, cache=cache,
                                              is_final=final_i, **chunk_kwargs))

        if tokenizer is not None:
            text, _ = postprocess_utils.sentence_postprocess(tokens)
        else:
            text = tokens
        cache["prev_samples"] = audio[-m:] if m > 0 else np.zeros((0,), np.float32)
        if is_final:
            self.init_cache(cache, **kwargs)
        if key is None:
            key = ["rand_key"]
        return [{"key": key[0], "text": text}], meta
