"""SpecAugment in PyTorch (counterpart of ``funasr_tpu/models/specaug/specaug.py``):
frequency and time masks of random widths and positions, drawn from a
``torch.Generator``.

``SpecAugLFR`` repeats each frequency mask over the ``lfr_rate + 1`` stacked copies of
the LFR features (FunASR ``mask_along_axis_lfr``), so the same mel bands of every stacked
frame are masked. ``apply_time_warp`` is accepted and ignored, as in the JAX package
(``specaug.py:42-58``: no warp is applied). ``draw`` and ``apply`` split a call, so a
test can feed both packages the same positions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from funasr_tpu_torch.register import tables


def _rand_masks(generator, b: int, num_mask: int, d: int, width_range, device):
    """(pos, lengths), each (B, num_mask) int64: widths in [lo, hi), starts in
    [0, max(1, d - hi)) (``_rand_masks``)."""
    lo, hi = width_range
    lengths = torch.randint(lo, max(hi, lo + 1), (b, num_mask), generator=generator,
                            device=device)
    pos = torch.randint(0, max(1, d - hi), (b, num_mask), generator=generator, device=device)
    return pos, lengths


def _apply_axis_mask(spec, pos, lengths, axis: int):
    """Zero ``spec`` (B, T, D) where any mask [pos, pos + length) covers the index along
    ``axis`` (1: time, 2: frequency)."""
    d = spec.shape[axis]
    aran = torch.arange(d, device=spec.device)[None, None, :]
    mask = (pos[..., None] <= aran) & (aran < (pos + lengths)[..., None])
    mask = mask.any(dim=1)  # (B, D)
    mask = mask[:, :, None] if axis == 1 else mask[:, None, :]
    return torch.where(mask, torch.zeros((), dtype=spec.dtype, device=spec.device), spec)


@tables.register("specaug_classes", "SpecAug")
class SpecAug:
    def __init__(self, apply_time_warp: bool = True, time_warp_window: int = 5,
                 time_warp_mode: str = "bicubic", apply_freq_mask: bool = True,
                 freq_mask_width_range: Union[int, Sequence[int]] = (0, 20),
                 num_freq_mask: int = 2, apply_time_mask: bool = True,
                 time_mask_width_range: Optional[Sequence[int]] = None,
                 time_mask_width_ratio_range=None, num_time_mask: int = 2,
                 lfr_rate: int = 0, **kwargs):
        if isinstance(freq_mask_width_range, int):
            freq_mask_width_range = (0, freq_mask_width_range)
        if isinstance(time_mask_width_range, int):
            time_mask_width_range = (0, time_mask_width_range)
        self.apply_freq_mask = apply_freq_mask
        self.apply_time_mask = apply_time_mask
        self.freq_mask_width_range = tuple(freq_mask_width_range)
        self.time_mask_width_range = tuple(time_mask_width_range or (0, 40))
        self.num_freq_mask = num_freq_mask
        self.num_time_mask = num_time_mask
        self.lfr_rate = 1  # plain SpecAug: no stride replication

    def draw(self, b: int, t: int, d: int, generator=None, device=None):
        """The masks of one call: {"freq": (pos, lengths) over one LFR copy's D /
        lfr_rate bands, "time": (pos, lengths)}, each present when enabled."""
        masks = {}
        if self.apply_freq_mask:
            masks["freq"] = _rand_masks(generator, b, self.num_freq_mask, d // self.lfr_rate,
                                        self.freq_mask_width_range, device)
        if self.apply_time_mask:
            masks["time"] = _rand_masks(generator, b, self.num_time_mask, t,
                                        self.time_mask_width_range, device)
        return masks

    def apply(self, spec, masks):
        """spec (B, T, D) with ``draw``'s masks -> masked spec."""
        b, _, d = spec.shape
        if "freq" in masks:
            pos, lengths = masks["freq"]
            if self.lfr_rate > 1:
                offs = torch.arange(self.lfr_rate, device=pos.device) * (d // self.lfr_rate)
                pos = (pos[:, None, :] + offs[None, :, None]).reshape(b, -1)
                lengths = lengths.repeat(1, self.lfr_rate)
            spec = _apply_axis_mask(spec, pos, lengths, axis=2)
        if "time" in masks:
            spec = _apply_axis_mask(spec, *masks["time"], axis=1)
        return spec

    def __call__(self, spec, spec_lengths, generator=None):
        """spec: (B, T, D) -> (masked spec, spec_lengths)."""
        b, t, d = spec.shape
        return self.apply(spec, self.draw(b, t, d, generator, spec.device)), spec_lengths


@tables.register("specaug_classes", "SpecAugLFR")
class SpecAugLFR(SpecAug):
    def __init__(self, lfr_rate: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.lfr_rate = lfr_rate + 1
