"""funasr_tpu_torch: the PyTorch + CUDA port of funasr_tpu (slices 1-11: offline
Paraformer, ``AutoModel`` with bf16 and int8 / W8A8 quantization, the VAD -> ASR ->
punctuation pipeline with FSMN-VAD and CT-Transformer, speaker-attributed
transcription: BiCif-Paraformer timestamps, CAM++ and its clustering, hotword
transcription: SeACo-Paraformer and the Contextual Paraformer through ``hotword=``,
streaming: ParaformerStreaming and the realtime punctuation model through ``cache=``,
and SenseVoice-Small with the CTC family: the CTC model, Paraformer's CTC head,
Paraformer-v2, E-Paraformer and the fa-zh aligner, and serving: the OpenAI-compatible
HTTP server with cross-request batching, the 2-pass and realtime WebSocket servers, the
inference and benchmark CLIs under ``funasr_tpu_torch.bin``, and ``AutoFrontend``, and
LLM-based ASR: Qwen2 / Qwen3 under the continuous-batching ``LLMEngine``, Fun-ASR-Nano
through ``AutoModel`` and ``AutoModelVLLM``, the LLMASR family and Whisper).

Imports torch, numpy and scipy, never jax, ``funasr_tpu`` or scikit-learn. The public
entry point:

    from funasr_tpu_torch import AutoModel
    model = AutoModel(model="<bicif asr dir>", vad_model="<vad dir>",
                      punc_model="<punc dir>", spk_model="<cam++ dir>", device="cuda")
    results = model.generate(input=["meeting.wav"], batch_size_s=300, preset_spk_num=2)
    # results[0]["sentence_info"]: [{"text", "start", "end", "spk", "timestamp"}, ...]

    model = AutoModel(model="<seaco or contextual dir>", device="cuda")
    results = model.generate(input=["a.wav"], hotword="w1 w2 w3")

    model = AutoModel(model="<sensevoice dir>", vad_model="<vad dir>",
                      vad_kwargs={"max_single_segment_time": 30000}, device="cuda")
    res = model.generate(input="a.wav", language="auto", use_itn=True, batch_size_s=60,
                         merge_vad=True, merge_length_s=15)
    text = rich_transcription_postprocess(res[0]["text"])  # utils/postprocess_utils.py

    model = AutoModel(model="<fa-zh dir>", device="cuda")
    res = model.generate(input=[("a.wav", "transcript of a")])  # res[0]["timestamp"]

    model = AutoModel(model="<fun-asr-nano dir>", device="cuda")
    res = model.generate(input=["a.wav"], batch_size=16, num_slots=16, max_new_tokens=256)

    model = AutoModel(model="<paraformer streaming dir>", device="cuda")
    cache = {}
    for i, chunk in enumerate(chunks_of_9600_samples):  # 600 ms each
        res = model.generate(input=chunk, cache=cache, is_final=i == last,
                             chunk_size=[0, 10, 5], encoder_chunk_look_back=4,
                             decoder_chunk_look_back=1)

The first lookup in ``tables`` imports the model modules, whose classes register
themselves (importing the package imports none of them):

    from funasr_tpu_torch import tables
    model = tables.model_classes["Paraformer"](**conf, device="cuda", generator=g)
    frontend = tables.frontend_classes["WavFrontend"](fs=16000, lfr_m=7, lfr_n=6)
    tokenizer = tables.tokenizer_classes["CharTokenizer"](token_list=tokens)
    results, meta = model.inference(waves, tokenizer=tokenizer, frontend=frontend)

On a CUDA device the encoders' attention (SenseVoice's 70 blocks included), every FSMN
memory block (the VAD's included) and every W8A8 linear run hand-written kernels (``csrc/``, built with nvcc at first use);
on the CPU they run their plain PyTorch versions.
"""

import torch

from funasr_tpu_torch.register import tables

__version__ = "0.1.0"

# The JAX package runs its fp32 products at full precision (the fbank DFT explicitly at
# HIGHEST). PyTorch defaults CUDA fp32 convolutions to TF32; state both switches.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["AutoFrontend", "AutoModel", "tables"]


def __getattr__(name):
    if name == "AutoModel":
        from funasr_tpu_torch.auto.auto_model import AutoModel
        return AutoModel
    if name == "AutoFrontend":
        from funasr_tpu_torch.auto.auto_frontend import AutoFrontend
        return AutoFrontend
    raise AttributeError(f"module 'funasr_tpu_torch' has no attribute {name!r}")
