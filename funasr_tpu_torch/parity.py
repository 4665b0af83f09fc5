"""Registry-name parity with the reference: alias names bound to the port's classes
(counterpart of ``funasr_tpu/parity.py``, which the port may not import).

FunASR registers export wrappers (``*Export``) and recipe spellings of the same code
under names of their own. The alias list below is the JAX package's
(``funasr_tpu/parity.py:23-54``) for the encoder and decoder tables; as there, an alias
is bound only when its target is registered and the name is not, so it grows with the
port. Two entries are left out because the reference binds their names to classes of
their own, which the port does not have yet: ``FsmnDecoderSCAMAOpt`` (the SCAMA decoder
of the autoregressive SCAMA model, deferred when streaming Paraformer was ported) and
``FsmnDecoder`` through it. Binding them here would build a Paraformer decoder for a
SCAMA config.
"""

from __future__ import annotations

from funasr_tpu_torch.register import tables

ALIASES = {
    "encoder_classes": [
        ("SANMEncoderExport", "SANMEncoder"),
        ("SANMEncoderChunkOptExport", "SANMEncoderChunkOpt"),
        ("SANMVadEncoderExport", "SANMVadEncoder"),
        ("FSMNExport", "FSMN"),
        ("FSMNConvert", "FSMN"),
        ("FSMNMT", "FSMN"),
        ("FSMNMTConvert", "FSMN"),
    ],
    "decoder_classes": [
        ("ParaformerSANMDecoderExport", "ParaformerSANMDecoder"),
        ("ParaformerSANMDecoderOnlineExport", "ParaformerSANMDecoder"),
        ("ParaformerSANMDecoder_v2_community", "ParaformerSANMDecoder"),
        ("ContextualParaformerDecoderExport", "ContextualParaformerDecoder"),
        ("TransformerRWKVDecoder", "TransformerDecoder"),
        ("OpenAIWhisperDecoderWarp", "TransformerDecoder"),
        ("rnn_decoder", "TransformerDecoder"),
    ],
}


def _alias(table: str, name: str, target: str):
    tbl = getattr(tables, table)
    if name not in tbl and target in tbl:
        tbl[name] = tbl[target]


def register_parity_aliases():
    for table, pairs in ALIASES.items():
        for name, target in pairs:
            _alias(table, name, target)


register_parity_aliases()
