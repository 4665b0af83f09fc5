"""S3prlFrontend: the SSL-upstream feature frontend of the PyTorch port (counterpart of
``funasr_tpu/frontends/s3prl.py``; FunASR ``funasr/frontends/s3prl.py:36``).

The reference wraps the s3prl hub; the JAX package backs the same surface with its own
SSL trunks (data2vec by default: any registered model with ``extract_features(speech,
lengths)``), and so does the port, with its data2vec (``models/data2vec/model.py``): the
trunk runs on the device ``extract`` is given, so its attention runs on the flash kernel.

* ``multilayer_feature``: the softmax-weighted sum of every layer's output (the s3prl
  Featurizer role; the weights start at zero, a uniform average); else the trunk's last
  output. ``tile_factor`` repeats each frame. ``frame_shift_ms`` 20 and ``lfr_n`` 1 for
  ``AutoModel``'s bookkeeping.
* ``upstream_ckpt``: a FunASR torch state dict, loaded with ``load_state_dict`` (the JAX
  package converts it with ``convert_state_dict``). Without one the trunk takes a seeded
  init from a CPU ``torch.Generator`` (``seed`` in ``frontend_conf``, 0 by default).
* ``device``: where the trunk runs when ``extract`` names no device, the card unless the
  caller asks for the CPU (``AutoModel`` passes its own). So the models whose
  ``inference`` takes ``extract_fbank``'s host numpy still run the trunk there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import as_unit_f32


@tables.register("frontend_classes", "S3prlFrontend")
class S3prlFrontend:
    def __init__(self, fs: int = 16000, frontend_conf: Optional[dict] = None,
                 download_dir: Optional[str] = None, multilayer_feature: bool = False,
                 device=None, **kwargs):
        conf = dict(frontend_conf or {})
        self.fs = int(fs) if not isinstance(fs, str) else int(
            fs.lower().replace("k", "000").replace("hz", "") or 16000)
        self.multilayer_feature = multilayer_feature
        self.tile_factor = int(conf.get("tile_factor", 1))
        model_cls = tables.model_classes[conf.get("upstream", "data2vec")]
        ckpt = conf.get("upstream_ckpt")
        generator = None if ckpt else torch.Generator().manual_seed(int(conf.get("seed", 0)))
        self.upstream = model_cls(**dict(conf.get("upstream_conf") or {}),
                                  generator=generator).eval()
        if ckpt:
            from funasr_tpu_torch.utils.load_utils import load_pretrained
            load_pretrained(self.upstream, ckpt)
        enc = getattr(self.upstream, "encoder", None)
        self._d = enc.output_size() if hasattr(enc, "output_size") else None
        n_layers = getattr(enc, "encoder_layers", 1)
        # the featurizer's softmax layer weights (zeros: a uniform average)
        self.layer_weights = torch.zeros(n_layers) if multilayer_feature else None
        self.frame_shift_ms = 20
        self.lfr_n = 1
        self.device = torch.device(device or "cuda")

    def output_size(self) -> int:
        return self._d or 768

    def _features(self, wav, lens):
        enc = self.upstream.encoder
        if self.multilayer_feature and hasattr(enc, "front"):
            feats, out_lens, valid = enc.front(wav, lens)
            _, layer_results = enc.encoder.extract_features(feats, valid)
            stack = torch.stack([x for x, _ in layer_results])  # (L, B, T, D)
            w = torch.softmax(self.layer_weights.to(stack.device), 0)
            return torch.einsum("l,lbtd->btd", w, stack), out_lens
        return self.upstream.extract_features(wav, lens)

    def extract(self, audio_list, device=None):
        """Waveforms (int16 PCM taken as x / 32768, as ``extract_fbank`` hands a frontend
        without a PCM16 path) -> (feats (B, T, D), lens (B,)): computed on ``device``, or on
        the frontend's own device without one; host numpy without ``device``, tensors left
        on it with one."""
        wavs = [as_unit_f32(a) for a in audio_list]
        lens = np.asarray([len(a) for a in wavs], np.int32)
        batch = np.zeros((len(wavs), int(lens.max())), np.float32)
        for i, a in enumerate(wavs):
            batch[i, : len(a)] = a
        dev = self.device if device is None else torch.device(device)
        if self.upstream.device != dev:
            self.upstream.to(dev)
        with torch.inference_mode():
            feats, out_lens = self._features(torch.from_numpy(batch).to(dev),
                                             torch.from_numpy(lens).to(dev))
            if self.tile_factor != 1:
                feats = feats.repeat_interleave(self.tile_factor, dim=1)
                out_lens = out_lens * self.tile_factor
        if device is None:
            return feats.cpu().numpy(), out_lens.cpu().numpy()
        return feats, out_lens

    __call__ = extract
