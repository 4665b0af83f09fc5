"""Model alias maps (reference: ``funasr/download/name_maps_from_hub.py:1-60``); a copy
of ``funasr_tpu/download/name_maps_from_hub.py``."""

name_maps_ms = {
    "paraformer-zh": "iic/speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-pytorch",
    "paraformer-zh-spk": "iic/speech_paraformer-large-vad-punc-spk_asr_nat-zh-cn",
    "paraformer-zh-online": "iic/speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-online",
    "paraformer-zh-streaming": "iic/speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-online",
    "paraformer-en": "iic/speech_paraformer-large-vad-punc_asr_nat-en-16k-common-vocab10020",
    "conformer-en": "iic/speech_conformer_asr-en-16k-vocab4199-pytorch",
    "ct-punc": "iic/punc_ct-transformer_cn-en-common-vocab471067-large",
    "ct-punc-c": "iic/punc_ct-transformer_zh-cn-common-vocab272727-pytorch",
    "fsmn-vad": "iic/speech_fsmn_vad_zh-cn-16k-common-pytorch",
    "fa-zh": "iic/speech_timestamp_prediction-v1-16k-offline",
    "cam++": "iic/speech_campplus_sv_zh-cn_16k-common",
    "eres2netv2": "iic/speech_eres2netv2_sv_zh-cn_16k-common",
    "Whisper-large-v3": "iic/speech_whisper-large_asr_multilingual",
    "sensevoice-small": "iic/SenseVoiceSmall",
    "sensevoicesmall": "iic/SenseVoiceSmall",
    "paraformer-zh-hotword": "iic/speech_paraformer-large-contextual_asr_nat-zh-cn-16k-common-vocab8404",
    "emotion2vec_plus_large": "iic/emotion2vec_plus_large",
}

name_maps_hf = {
    "paraformer-zh": "funasr/paraformer-zh",
    "paraformer-zh-streaming": "funasr/paraformer-zh-streaming",
    "paraformer-en": "funasr/paraformer-en",
    "ct-punc": "funasr/ct-punc",
    "fsmn-vad": "funasr/fsmn-vad",
    "cam++": "funasr/campplus",
    "sensevoice-small": "FunAudioLLM/SenseVoiceSmall",
    "fun-asr-nano": "FunAudioLLM/Fun-ASR-Nano-2512",
    "glm-asr-nano": "zai-org/GLM-ASR-Nano-2512",
    "qwen3-asr": "Qwen/Qwen3-ASR-1.7B",
}

name_maps_openai = {
    "whisper-large-v3": "openai/whisper-large-v3",
}
