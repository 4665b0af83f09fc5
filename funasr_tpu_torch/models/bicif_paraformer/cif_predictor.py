"""CifPredictorV3 in PyTorch: CIF plus an upsampled second alpha head for per-token
timestamps (counterpart of ``funasr_tpu/models/bicif_paraformer/cif_predictor.py``;
FunASR ``funasr/models/bicif_paraformer/cif_predictor.py:121-360``).

The head under FunASR's names: ``upsample_cnn`` (``nn.ConvTranspose1d(d, d, k,
stride=k)``, run as one GEMM), ``blstm`` (``nn.LSTM(d, d, bidirectional=True,
batch_first=True)`` for ``upsample_type="cnn_blstm"``) and ``cif_output2``. The BLSTM
runs over every upsampled frame of the bucket, padding included, and is masked after,
as in the JAX package: the backward direction starts in the padding, so the sequence
is never packed.
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, conv1d, conv_transpose1d_stride_eq_kernel
from funasr_tpu_torch.models.paraformer.cif_predictor import CifPredictorV2
from funasr_tpu_torch.ops.cif import fires_thr
from funasr_tpu_torch.register import tables


@tables.register("predictor_classes", "CifPredictorV3")
class CifPredictorV3(CifPredictorV2):
    def __init__(self, idim: int, *args, smooth_factor2: float = 1.0,
                 noise_threshold2: float = 0.0, upsample_times: int = 5,
                 upsample_type: str = "cnn", use_cif1_cnn: bool = True, device=None,
                 **kwargs):
        super().__init__(idim, *args, device=device, **kwargs)
        if upsample_type not in ("cnn", "cnn_blstm"):
            raise ValueError(f"upsample_type={upsample_type!r} (cnn, cnn_blstm)")
        self.smooth_factor2 = smooth_factor2
        self.noise_threshold2 = noise_threshold2
        self.upsample_times = upsample_times
        self.upsample_type = upsample_type
        self.use_cif1_cnn = use_cif1_cnn
        self.upsample_cnn = nn.ConvTranspose1d(idim, idim, upsample_times,
                                               stride=upsample_times, device=device)
        out_dim = idim
        if upsample_type == "cnn_blstm":
            self.blstm = nn.LSTM(idim, idim, 1, bias=True, batch_first=True,
                                 bidirectional=True, device=device)
            out_dim = 2 * idim
        self.cif_output2 = nn.Linear(out_dim, 1, device=device)

    def get_upsample_timestamp(self, hidden, mask=None, token_num=None):
        """hidden (B, T, D), mask (B, T) bool, token_num (B,) -> (ds_alphas (B, T),
        ds_peak (B, T), us_alphas (B, T * up), us_peaks (B, T * up)), fp32."""
        b, t, _ = hidden.shape
        up = self.upsample_times
        src = hidden
        if self.use_cif1_cnn:
            src = torch.relu(conv1d(hidden, self.cif_conv1d.weight, self.cif_conv1d.bias,
                                    left_pad=self.l_order, right_pad=self.r_order))
        h = conv_transpose1d_stride_eq_kernel(src, self.upsample_cnn.weight,
                                              self.upsample_cnn.bias)
        if self.upsample_type == "cnn_blstm":
            h, _ = self.blstm(h.to(self.blstm.weight_ih_l0.dtype))
        alphas2 = torch.sigmoid(apply_linear(self.cif_output2, h)[..., 0].float())
        alphas2 = torch.relu(alphas2 * self.smooth_factor2 - self.noise_threshold2)
        if mask is not None:
            alphas2 = alphas2 * mask.float().repeat_interleave(up, dim=1)
        if token_num is not None:
            total = alphas2.sum(dim=-1)
            alphas2 = alphas2 * (token_num.float() / torch.clamp_min(total, 1e-9))[:, None]
        ds_alphas = alphas2.reshape(b, t, up).sum(dim=-1)
        thr = self.threshold - 1e-4
        return ds_alphas, fires_thr(ds_alphas, thr), alphas2, fires_thr(alphas2, thr)
