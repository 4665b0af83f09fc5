"""funasr_tpu_torch: the PyTorch + CUDA port of funasr_tpu (slices 1-9: offline
Paraformer, ``AutoModel`` with bf16 and int8 / W8A8 quantization, the VAD -> ASR ->
punctuation pipeline with FSMN-VAD and CT-Transformer, speaker-attributed
transcription: BiCif-Paraformer timestamps, CAM++ and its clustering, hotword
transcription: SeACo-Paraformer and the Contextual Paraformer through ``hotword=``,
streaming: ParaformerStreaming and the realtime punctuation model through ``cache=``,
and SenseVoice-Small with the CTC family: the CTC model, Paraformer's CTC head,
Paraformer-v2, E-Paraformer and the fa-zh aligner).

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

    model = AutoModel(model="<paraformer streaming dir>", device="cuda")
    cache = {}
    for i, chunk in enumerate(chunks_of_9600_samples):  # 600 ms each
        res = model.generate(input=chunk, cache=cache, is_final=i == last,
                             chunk_size=[0, 10, 5], encoder_chunk_look_back=4,
                             decoder_chunk_look_back=1)

Importing the package registers its classes in its own ``tables``:

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

# The JAX package runs its fp32 products at full precision (the fbank DFT explicitly at
# HIGHEST). PyTorch defaults CUDA fp32 convolutions to TF32; state both switches.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from funasr_tpu_torch.frontends import wav_frontend  # noqa: E402,F401
from funasr_tpu_torch.models.bicif_paraformer import model as bicif_model  # noqa: E402,F401
from funasr_tpu_torch.models.campplus import model as campplus_model  # noqa: E402,F401
from funasr_tpu_torch.models.contextual_paraformer import model as ctx_model  # noqa: E402,F401
from funasr_tpu_torch.models.ct_transformer import model as ct_model  # noqa: E402,F401
from funasr_tpu_torch.models.ct_transformer_streaming import model as ct_stream  # noqa: E402,F401
from funasr_tpu_torch.models.ctc import model as ctc_model  # noqa: E402,F401
from funasr_tpu_torch.models.e_paraformer import model as e_paraformer  # noqa: E402,F401
from funasr_tpu_torch.models.fsmn_vad_streaming import model as vad_model  # noqa: E402,F401
from funasr_tpu_torch.models.monotonic_aligner import model as aligner  # noqa: E402,F401
from funasr_tpu_torch.models.paraformer import cif_predictor, decoder, model  # noqa: E402,F401
from funasr_tpu_torch.models.paraformer import san_decoder  # noqa: E402,F401
from funasr_tpu_torch.models.paraformer_streaming import model as stream_model  # noqa: E402,F401
from funasr_tpu_torch.models.paraformer_v2 import model as paraformer_v2  # noqa: E402,F401
from funasr_tpu_torch.models.seaco_paraformer import model as seaco_model  # noqa: E402,F401
from funasr_tpu_torch.models.sanm import encoder  # noqa: E402,F401
from funasr_tpu_torch.models.sense_voice import model as sense_voice  # noqa: E402,F401
from funasr_tpu_torch.tokenizer import char_tokenizer  # noqa: E402,F401
from funasr_tpu_torch.tokenizer import sentencepiece_tokenizer  # noqa: E402,F401
from funasr_tpu_torch import parity  # noqa: E402,F401  (aliases, after every class)
from funasr_tpu_torch.auto.auto_model import AutoModel  # noqa: E402

__all__ = ["AutoModel", "tables"]
