"""E-Paraformer in PyTorch: Paraformer with the PIF predictor (counterpart of
``funasr_tpu/models/e_paraformer/model.py``; FunASR ``funasr/models/e_paraformer/
model.py:28``). The encoder and decoder are Paraformer's (FunASR's E-Paraformer decoder
has the ParaformerSANMDecoder layout), ``predictor_bias`` 2 (training's). The PIF
predictor fires nothing, so the decode hands no timestamps to the dispatch / fetch
pair's one copy (``decode_outputs``); the JAX package's fetch fails on the missing
fires instead (ROADMAP section 3).
"""

from __future__ import annotations

import funasr_tpu_torch.models.e_paraformer.pif_predictor  # noqa: F401 (registers)
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.register import tables


@tables.register("model_classes", "EParaformer")
class EParaformer(Paraformer):
    def __init__(self, predictor: str = "PifPredictor", **kwargs):
        super().__init__(predictor=predictor, **kwargs)

    def decode_outputs(self, sp, ln, max_tokens: int, timestamps: bool, context=None):
        """Paraformer's, without timestamps: PIF has no fires."""
        yseq, token_lens, enc_lens, _ = super().decode_outputs(sp, ln, max_tokens, False,
                                                               context)
        return yseq, token_lens, enc_lens, None
