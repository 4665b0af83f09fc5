"""Conformer AED in PyTorch: a Transformer AED over the ``ConformerEncoder`` (counterpart
of ``funasr_tpu/models/conformer/model.py``; FunASR ``funasr/models/conformer/model.py``)."""

import funasr_tpu_torch.models.conformer.encoder  # noqa: F401 (registers ConformerEncoder)
from funasr_tpu_torch.models.transformer.model import Transformer
from funasr_tpu_torch.register import tables


@tables.register("model_classes", "Conformer")
class Conformer(Transformer):
    def __init__(self, encoder: str = "ConformerEncoder", **kwargs):
        super().__init__(encoder=encoder, **kwargs)
