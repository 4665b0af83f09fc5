"""Registry-name parity with the reference: alias names bound to the port's classes
(counterpart of ``funasr_tpu/parity.py``, which the port may not import).

FunASR registers export wrappers (``*Export``) and recipe spellings of the same code
under names of their own. The alias list below is the JAX package's
(``funasr_tpu/parity.py:23-54``) for the encoder and decoder tables, its model keys
(``:63-84``: whisper spellings, the LLM family's hub paths) and its training tables
(``:86-120``: samplers, datasets, the dataloader, a preprocessor); as there, an alias
is bound only when its target is registered and the name is not, so it grows with the
port. ``FsmnDecoder`` (FunASR's AR embed + FSMN decoder, ``sanm/decoder.py:203``) binds to
the SCAMA decoder, which has its layout. The JAX list's ``FsmnDecoderSCAMAOpt`` ->
``ParaformerSANMDecoder`` entry is left out: the SCAMA decoder registers that name itself.
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
        ("FsmnDecoder", "FsmnDecoderSCAMAOpt"),
        ("TransformerRWKVDecoder", "TransformerDecoder"),
        ("OpenAIWhisperDecoderWarp", "TransformerDecoder"),
        ("rnn_decoder", "TransformerDecoder"),
    ],
    # the training tables (``parity.py:86-120``): recipe spellings of the two sampler
    # strategies, the dataset, index, dataloader and preprocessor names
    "batch_sampler_classes": [
        ("CustomDistributedBatchSampler", "BatchSampler"),
        ("RankFullLocalShuffleBatchSampler", "BatchSampler"),
        ("CustomDistributedDynamicBatchSampler", "CustomDistributedBufferDynamicBatchSampler"),
        ("DynamicBatchLocalShuffleSampler", "CustomDistributedBufferDynamicBatchSampler"),
        ("RankFullLocalShuffleDynamicBatchSampler",
         "CustomDistributedBufferDynamicBatchSampler"),
        ("EspnetStyleBatchSampler", "CustomDistributedBufferDynamicBatchSampler"),
        ("BatchSamplerEpoch", "BatchSampler"),
    ],
    "dataset_classes": [
        ("FunASR", "AudioDataset"),
        ("AudioLLMDataset", "LLMDataset"),
        ("AudioLLMARDataset", "LLMDataset"),
        ("AudioLLMNARDataset", "LLMDataset"),
        ("AudioLLMQwenAudioDataset", "LLMQwenAudioDataset"),
        ("AudioLLMVicunaDataset", "LLMVicunaDataset"),
        ("SenseVoiceCTCDataset", "SenseVoiceDataset"),
        ("KwsMTDataset", "KWSDataset"),
    ],
    "index_ds_classes": [("FunASR", "IndexDSJsonl")],
    "dataloader_classes": [("DataloaderIterable", "DataloaderMapStyle")],
    "preprocessor_classes": [("SpeechPreprocessSpeedPerturb", "SpeedPerturb")],
}


def _alias(table: str, name: str, target: str):
    tbl = getattr(tables, table)
    if name not in tbl and target in tbl:
        tbl[name] = tbl[target]


# model keys (``parity.py:63-84``): whisper size spellings, each to its size or else to
# large-v3, and hub paths / brand spellings of the LLM family
WHISPER_SPELLINGS = ["tiny", "tiny.en", "base", "base.en", "small", "small.en", "medium",
                     "medium.en", "large-v1", "large-v2", "large-v3", "large-v3-turbo"]
MODEL_ALIASES = [
    ("Qwen-Audio", "QwenAudio"), ("Qwen/Qwen-Audio", "QwenAudio"),
    ("Qwen/QwenAudio", "QwenAudio"), ("Qwen-Audio-Chat", "QwenAudioChat"),
    ("Qwen/Qwen-Audio-Chat", "QwenAudioChat"), ("Qwen/QwenAudioChat", "QwenAudioChat"),
    ("QwenAudioChatWarp", "QwenAudioChat"),
    ("Qwen/Qwen3-ASR-0.6B", "Qwen3ASR"), ("Qwen/Qwen3-ASR-1.7B", "Qwen3ASR"),
    ("ZhipuAI/GLM-ASR-Nano-2512", "GLMASR"), ("zai-org/GLM-ASR-Nano-2512", "GLMASR"),
    ("iic/speech_eres2netv2_sv_zh-cn_16k-common", "ERes2NetV2"),
]


def register_parity_aliases():
    for table, pairs in ALIASES.items():
        for name, target in pairs:
            _alias(table, name, target)
    for size in WHISPER_SPELLINGS:
        _alias("model_classes", f"Whisper-{size}", f"whisper-{size}")
        _alias("model_classes", f"Whisper-{size}", "whisper-large-v3")
    for name, target in MODEL_ALIASES:
        _alias("model_classes", name, target)


register_parity_aliases()
