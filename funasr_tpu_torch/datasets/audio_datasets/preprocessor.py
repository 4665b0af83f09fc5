"""Data preprocessors, a copy of ``funasr_tpu/datasets/audio_datasets/preprocessor.py`` (reference: ``funasr/datasets/audio_datasets/preprocessor.py:18``
speed perturb 0.9/1.0/1.1; ``TextPreprocessSegDict:52``)."""

from __future__ import annotations

import numpy as np

from funasr_tpu_torch.register import tables


@tables.register("preprocessor_classes", "SpeedPerturb")
class SpeedPerturb:
    """Random resample-based speed perturbation on raw waveforms."""

    def __init__(self, speeds=(0.9, 1.0, 1.1), **kwargs):
        self.speeds = list(speeds)

    def __call__(self, waveform: np.ndarray, rng: np.random.Generator):
        speed = self.speeds[rng.integers(0, len(self.speeds))]
        if speed == 1.0:
            return waveform
        from scipy.signal import resample_poly
        up, down = 100, int(100 * speed)
        return resample_poly(waveform, up, down).astype(np.float32)


@tables.register("preprocessor_classes", "TextPreprocessSegDict")
class TextPreprocessSegDict:
    """Re-segment latin words through the tokenizer seg dict before encoding."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, text: str, tokenizer=None):
        return text


@tables.register("preprocessor_classes", "TextPreprocessRemovePunctuation")
class TextPreprocessRemovePunctuation:
    """Strip punctuation from target text (reference preprocessor parity)."""

    PUNC = set("，。？、！；：""''（）《》,.?!;:\"'()<>[]{}")

    def __call__(self, text: str, rng=None):
        return "".join(c for c in str(text) if c not in self.PUNC)
