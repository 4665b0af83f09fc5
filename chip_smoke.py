"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels, holds each
against its plain PyTorch version, checks the port on CUDA against the port on the CPU,
and drives the offline Paraformer decode, ``AutoModel(quant="w8a8")``, the default
(fp32) ``AutoModel`` at Paraformer-large width, the VAD -> ASR -> punctuation pipeline
``AutoModel(model=, vad_model=, punc_model=)``, speaker-attributed transcription
``AutoModel(model=bicif, vad_model=, punc_model=, spk_model=)``, hotword transcription
``AutoModel(model=seaco | contextual).generate(hotword=...)``, streaming
``AutoModel(model=paraformer_streaming).generate(input=chunk, cache=cache, ...)`` and
SenseVoice-Small ``AutoModel(model=sensevoice[, vad_model=])`` with the CTC family, and
the three servers over real localhost sockets: the OpenAI-compatible HTTP app with its
cross-request batcher, the 2-pass WebSocket server and the realtime WebSocket server, and
LLM-based ASR: Fun-ASR-Nano (Qwen3-0.6B on the port's ``LLMEngine``) through ``AutoModel`` and
``AutoModelVLLM``, and Whisper-large-v3, and text normalization and deployment:
``generate(itn=True)``, ``AutoModel.export`` run by ``ExportedModel`` and the MCP server, and
Paraformer-large fine-tuning through ``bin/data_tools`` and ``bin/train`` with the backward
kernels, then SenseVoice-Small's and the other models' training losses, then streaming
Paraformer's fine-tuning with the flash kernels in chunk mode.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: CUDA must be available; prints ``nvidia-smi`` name and power limit;
2. build: compiles ``funasr_tpu_torch/csrc/*.cu`` with nvcc, one process per source in
   parallel (seconds printed);
3. kernels: flash attention at (32, 4, 384, 128) and (1, 4, 1408, 128), bf16 and fp32,
   ragged lengths, valid query rows; FSMN memory at (32, 384, 512) and (32, 208, 512),
   k = 11; and at the pipeline's shapes (``pipeline_kernel_rows``): the VAD's FSMN at
   (1, 6019, 128) fp32, k = 20, pads (19, 0), no mask; the punctuation encoder's FSMN
   at (1, 64, 256) fp32, k = 11, a prefix mask; its flash at (1, 8, 64, 32) fp32 and
   bf16 with a ragged length; and the SeACo decoder's FSMN (``hotword_kernel_rows``) at
   (32, 208, 512), k = 21, pads (10, 10), fp32 and bf16, also against the generic
   instantiation (its time, the kernel's before its k = 21 instantiation); each against
   its plain version;
4. w8a8 kernel: the W8A8 linear at every (M, K, N) of the W8A8 path (ragged K = 560 and
   M = 720 included), bf16 and fp32 x, bit-exact to its plain version (a mismatch
   raises);
5. CUDA vs CPU: a small config (2 + 2 blocks, d = 64), same weights, fp32: token ids
   equal, encoder output within ``CPU_GPU_ENC_TOL``; then d = 256 under W8A8 (the
   kernel on CUDA, its plain version on the CPU): every W8A8 call of the CUDA decode
   bit-exact to the plain version on its own input, encoder within
   ``W8A8_ENC_REL_TOL`` relative L2, token agreement printed (see the constants);
6. main path: Paraformer-large width (``bench.py``'s PROD_CONF: 50 encoder blocks,
   16 decoder blocks, vocab 8404) in bf16 with seeded random weights: 32 x 15 s int16
   PCM and one 70 s utterance through WavFrontend -> model.inference -> text; the
   kernel launch counts of that run must show every encoder attention and every FSMN
   block went through the kernels; RTFx at B = 32 x 15 s, and one decode under
   torch.profiler: device time by kernel and the device's idle share;
7. AutoModel (``phase_automodel``): a model directory at PROD_CONF width (config.yaml,
   8404 tokens, identity am.mvn, model.pt of a seeded port Paraformer) through
   ``AutoModel(model=dir, device="cuda", bf16=True, quant="w8a8", batch_size=32)
   .generate(32 x 15 s int16 PCM)``: 32 non-empty texts, finite scores, and launch
   counts of >= 282 W8A8 linears, 50 flash and 66 FSMN per decode; RTFx; then the same
   directory at ``quant=None`` in the same call: its RTFx and the token agreement
   (printed, not gated: with random weights the argmax margins are degenerate,
   ``tests/test_w8a8_production.py``); one profiled ``generate`` of each; then the
   public default from the same directory, ``AutoModel(model=dir, device="cuda",
   batch_size=32)`` (no bf16, no quant: fp32): 32 non-empty texts, finite scores, >= 50
   flash and >= 66 FSMN launches per decode, and its profile showing them in the fp32
   kernels (``FP32_KERNELS``); RTFx and one profiled ``generate``;
8. pipeline (``phase_pipeline``): three model directories written from the port's
   seeded modules (the PROD_CONF Paraformer; fsmn-vad at its published widths crafted
   into an energy detector with small seeded memory taps; ct-punc-c at its published
   widths, vocab 272727) through ``AutoModel(model=asr, vad_model=vad, punc_model=punc,
   device="cuda")`` (fp32, the public default), 2 requests of 300 s of synthetic speech
   bursts (3-14 s) and near silence (1-3 s), one ``generate`` each. Gates per request:
   one row with its key and a text ending in sentence-final punctuation, >= 10 VAD
   segments equal to the port's VAD on the CPU to the ms, the first 3 punctuation
   windows' logits within ``PUNC_LOGIT_TOL`` of the CPU port's, and each stage's kernel
   launches (``kernel_sites`` x its calls). Prints RTFx per request, the wall ms of each
   stage (VAD, ASR, punctuation) and one profiled request (device ms by kernel, idle
   share);
9. speaker (``phase_speaker``): a BiCifParaformer at PROD_CONF width with the published
   CifPredictorV3 head, phase 8's VAD and punctuation, CAM++ at speech_campplus_sv's
   widths, through ``AutoModel(model=, vad_model=, punc_model=, spk_model=,
   device="cuda")`` on 1 meeting of 60 s of two synthetic voices (300 s before phase
   17 came, 90 s before phase 18), one ``generate(**SPEAKER_CALL)`` each. Gates: integer speakers on every
   sentence and timestamps rising inside the meeting; each stage's launches at their sites; the
   timestamp head and CAM++ embeddings against the CPU port; request 0 whole through
   the CPU port (VAD segments to the ms, token boundaries, the voices separating on its
   embeddings, cluster labels equal). Prints RTFx and the stage split per meeting, the
   speaker stage at ``spk_kwargs`` batch 64, CAM++ alone at B = 1 / 11 / 64 and one
   profiled meeting;
10. hotword (``phase_hotword``): SeACo-Paraformer (PROD_CONF, the published V3 head, a
   SeACo decoder of 6 + 1 layers at kernel_size 21, inner_dim 512) and the Contextual
   Paraformer, seeded, with seeded hotword lists of 2-6 tokens a word; 32 x 15 s through
   ``AutoModel(model=dir, device="cuda").generate(hotword=...)``: SeACo without
   hotwords equal to a BiCifParaformer over the same base weights, with 20 hotwords and
   with 200 (attention-score filtering), fp32 and ``bf16=True``; Contextual with 20,
   fp32. Gates: 32 texts, every kernel site launched, the k = 21 FSMN instantiation 12
   times a SeACo decode (18 under filtering) by count and by profile. Prints RTFx, device
   spans by stage (CUDA events), tokens the gate gave the hotword head, launches, one
   profile each. Then CUDA against the CPU port on 4 x 15 s (log-probs within
   ``HOTWORD_LOGP_TOL``, the kept set, timestamps), and the pipeline with 20 hotwords:
   ``HOTWORD_REQUESTS`` requests of 300 s through ``AutoModel(model=seaco, vad_model=,
   punc_model=)``, RTFx and the stage split;
11. streaming (``phase_streaming``): kernel rows at the streaming shapes
   (``streaming_kernel_rows``: flash with a key cache, (1, 4, 15, 128) over 15 / 55 / 1005
   keys, and with causal / corner key limits at (1, 8, 64, 32); FSMN (11, 10) at (1, 25 /
   26, 512) against its generic instantiation); ParaformerStreaming at PROD_CONF width
   (the chunk encoder, decoder sanm_shfit 5, WavFrontendOnline) through
   ``AutoModel.generate`` 600 ms a call as the demo calls it, 2 streams of 12 s, fp32 and
   ``bf16=True``: gated on non-empty texts (a whole-array call's text equal to the
   chunked stream's), exactly 50 flash, 50 FSMN (11, 5) and 16 FSMN (11, 10) launches a
   chunk and one device-to-host copy a chunk; per-chunk wall p50 / p95 (cold apart), RTF,
   device ms a chunk and idle share from a profiled stream, taken in a process of its own
   (``chip_smoke.py --stream-profile``, waited for); CUDA against the CPU port
   chunk by chunk (full width for 10 chunks, the small config for a stream: encoder
   within ``CPU_GPU_ENC_TOL``, fire counts and ids equal, caches within
   ``STREAM_CACHE_TOL``); the realtime punctuation model (ct-punc widths,
   CTTransformerStreaming) over the demo's pieces against the CPU port (texts, the first
   3 windows' logits within ``PUNC_LOGIT_TOL``); ``DynamicStreamingVAD`` over phase 8's
   VAD in 60 ms feeds, events equal to the CPU port's;
12. SenseVoice (``phase_sensevoice``): kernel rows at its shapes (``sense_voice_kernel_
   rows``: flash (32, 4, 388, 128) and FSMN (11, 5) at (32, 388, 512), fp32 and bf16; the
   blocks' five W8A8 products at M = 12416 and the W8A8 CTC head (12416, 512, 25055),
   bf16, bit-exact, with the wrapper's slice copy of the 25,056-pitch output timed); SenseVoiceSmall at its published widths (50 + 20
   blocks, d 512, vocab 25055 with the rich tags at their ids) written as a model dir,
   32 x 15 s through ``AutoModel.generate`` at fp32, ``bf16=True`` and ``bf16=True,
   quant="w8a8"`` (``sense_voice_batch``): gated on 32 keyed texts, exactly 70 flash, 70
   FSMN and (W8A8) 281 W8A8 launches a decode by counter and by profile (fp32 in the
   fp32 kernels), one host wait a batch; RTFx, device ms by kernel, idle share. CUDA
   against the CPU port (``sense_voice_cuda_vs_cpu``): the small config's ids equal, at
   full width on 2 x 15 s the encoder within ``CPU_GPU_ENC_TOL``, log-probs within
   ``SV_LOGP_TOL`` and ids equal where the top-2 margin clears 10x the error. The demo's
   call (``sense_voice_demo``): ``AutoModel(model=, vad_model=, vad_kwargs=
   {"max_single_segment_time": 30000})``, 2 requests of 300 s, ``generate(language="auto",
   use_itn=True, batch_size_s=60, merge_vad=True, merge_length_s=15)``: one row each, VAD
   segments equal to the CPU port's, the ASR stage's launches at its sites, no tag left
   by ``rich_transcription_postprocess``; then request 0 once more with the ASR stage's
   inputs kept (``sense_voice_demo_kernels``): flash and FSMN at each VAD-merged batch's
   shape against their plain versions, and the longest batch against the CPU port. The CTC family at a small config
   (``family_cuda_vs_cpu``): CTCModel, ParaformerV2, EParaformer ids and MonotonicAligner
   timestamps equal to the CPU port's, every kernel site launched.
13. serving (``phase_serving``): kernel rows at the serving shapes
   (``serving_kernel_rows``: flash (8, 4, 384, 128) and FSMN (8, 384, 512), the HTTP
   batches; (1, 4, T, 128) and (1, T, 512) at T = 128, 256, 384, 1,024 and 5,120, the
   partial windows, the finals and a 300 s forced final; fp32), then, over the model dirs
   phases 8, 9 and 11 kept (``keep_dirs``), fp32 on the card, in this process, each
   server's kernel counts set to 0 just before its traffic and read just after it, at
   least the kernel sites of each model call it made (``served``):
   ``TranscriptionApp(AutoModel(model=asr))`` (max_batch 8, batch_wait_ms 15) under 16
   clients at once with 10-15 s each: every response 200 with a text equal to its row of
   a direct ``generate`` over its batcher group, fewer ``generate`` calls than requests
   and a batch of >= 2, launches at the kernel sites, the smallest group against the CPU
   port (log-probs, ids where the margin clears the error); the server CLI's deployment
   ``AutoModel(model=, vad_model=, punc_model=)`` under 4 clients of 60 s, one
   ``verbose_json`` with its segments; ``WSServer`` 2-pass (Paraformer + punctuation,
   ParaformerStreaming, realtime punctuation, the VAD), 2 sessions of 15 s at once, then
   one after the other: equal messages, every model call replayed directly equal;
   ``RealtimeWSServer`` (VAD endpoints, CAM++ speakers) with a server-mode session of 20 s
   at real time and a client-mode session committing 10 s and 60 s: finals in order with
   speakers, partials never after their final, COMMIT finals equal to direct decodes. Prints
   requests/s, latency p50 / p95, the batches, one profiled ``generate`` of a group, the
   2-pass online message's server time per chunk and ``is_speaking: false`` -> final, the
   realtime partial latency.
14. LLM (``phase_llm``): kernel rows at the LLM path's shapes (``llm_kernel_rows``: flash
   (16, 4, 289, 128) and FSMN (16, 289, 512), 250 frames valid a row, fp32 and bf16,
   Fun-ASR-Nano's encoder on 16 x 15 s; ``llm_w8a8_rows``: W8A8 at every (M, K, N) that
   the counted W8A8 run launched, recorded there by ``w8a8_shapes``: the encoder's and
   adaptor's linears, fp32 with bias, and each Qwen3-0.6B linear at a decode step's M =
   16 and each prefill chunk's M, bf16, each with a zero row, bit-exact); a Fun-ASR-Nano
   dir at full width and depth
   (``NANO_FULL``: the 50-block SAN-M, the Linear adaptor, Qwen3-0.6B as published; the
   script's own tokenizer, ``SmokeChatTokenizer``) through ``AutoModel(model=dir,
   device="cuda").generate`` on 16 x 15 s, 64 new tokens, 16 slots, at fp32 (the
   default), ``bf16=True`` and ``quant="w8a8"`` (``nano_run``): 16 keyed texts of 64 tokens,
   each kernel's launches exactly its sites x calls (flash and FSMN 50 an encode, W8A8 202
   an encode + 196 an LLM forward), no host wait inside the decode step (fp32); RTFx,
   decode tokens/s, engine steps and host fetches, device ms and idle share of a profiled
   8-token ``generate`` (decode chunk 8); ``AutoModelVLLM.generate`` on 4 x 15 s, its
   launches exactly its sites x calls; the CUDA port against the CPU port at a small
   config (``nano_cuda_vs_cpu``: audio rows, prompt logits within ``LLM_LOGIT_TOL``,
   greedy ids where the margin clears); Whisper-large-v3 at full width,
   depth cut to 4 + 4 layers, 2 x 30 s, 32 tokens through ``AutoModel(model=
   "Whisper-large-v3")`` (``whisper_run``: cached decode = prefix oracle).
15. text and export (``phase_export``): a PROD_CONF Paraformer dir whose token list puts
   the numerals first and whose head lifts them (``number_tokens``, ``lift_numerals``),
   so that seeded decodes hold numbers: ``generate(itn=True)`` on 32 x 15 s equal to the
   port's ``InverseNormalizer`` over ``generate()``'s texts, some rewritten, launches
   exactly 50 flash + 66 FSMN (``itn_check``); the same for SenseVoice-Small from phase
   12's dir, 8 x 15 s, ``language="zh"``, 70 + 70. ``AutoModel.export`` at fp32
   (buckets ``EXPORT_BUCKETS``) and under ``quant="w8a8"`` (``EXPORT_W8A8_BUCKETS``),
   each directory loaded by ``ExportedModel`` in a process of its own that imports no
   model module (``chip_smoke.py --exported``): every program call and every
   ``transcribe`` launches exactly 50 flash + 66 FSMN (+ 282 W8A8), ids and token counts
   equal to eager ``infer_core``'s on the same features, the score within
   ``EXPORT_SCORE_TOL``, texts equal to ``generate``'s; each kernel held against its
   plain version at every shape a counted program call launched, recorded there by
   ``KernelShapes`` (``export_kernel_rows``: the program's own lengths and masks);
   prints each trace's seconds, each directory's bytes, one program call's wall ms and
   device kernel ms next to eager ``infer_core``'s, and EXPORT_UNBOUND's call as
   ``program.module()`` runs it. The MCP
   server (``bin/mcp_server.py``, on the card by its default) in a process of its own:
   ``tools/list``, ``transcribe`` with and without ``itn`` equal to ``AutoModel``'s text,
   ``inverse_normalize`` of 三百二十五 -> 325. Each kernel's lone call through its custom op
   against the wrapper's direct call (``op_dispatch_rows``).
16. training (``phase_training``): (a) the backward kernels at the recipe's first batch
   shape (``train_kernel_rows``: flash backward at (B, 4, T, 128) fp32 with the batch's
   ragged lengths in modes none / causal / corner, FSMN dx (the forward kernel with the
   taps reversed) and dw at (B, T, 512), k 11, pads 5 / 5) against autograd through
   their plain versions (relative L2 ``FLASH_BWD_REL_TOL`` / ``FSMN_BWD_REL_TOL``), two
   runs bit-equal, with the library call's backward time beside; flash's backward takes
   the (m, l) of the forward's stats instantiation, whose output must equal the plain
   instantiation's bit for bit (both forwards' ms beside); (b) one training step
   of a PROD_CONF-width Paraformer cut to 4 + 2 blocks on the card against the CPU
   (``train_cuda_vs_cpu``: loss within ``TRAIN_LOSS_RTOL``, every gradient within
   ``TRAIN_GRAD_REL_TOL``, launches exactly the step's sites); (c) finetune.sh's recipe:
   ``python -m funasr_tpu_torch.bin.data_tools scp2jsonl`` and ``python -m
   funasr_tpu_torch.bin.train`` (the ``funasr-tpu-torch-data-tools`` / ``-train`` console
   scripts) as subprocesses on a seeded PROD_CONF Paraformer-large (50 + 16 blocks, d
   512, vocab 8404) with the training keys (SpecAugLFR, dropout 0.1, dither 1.0,
   ``sampling_ratio`` 0.75, ``lsm_weight`` 0.1), 16 + 4 generated wavs of 10-15 s, token
   batches of 6,000 and lr 0.0002: one epoch (a mid-epoch checkpoint with its
   validation, the epoch's), then resumed for a second (its epoch's checkpoint, the
   average of the 2 best). Gated on a
   finite loss every step, every step's and validation's launches exactly their sites
   (the trainer's per-step counts), the resumed run going on from its step, every encoder
   linear_q_k_v's q / k rows and every fsmn_block reached by a gradient (the
   checkpoint's Adam moments) and the average decoding through ``AutoModel(model=<output
   dir>)``. Prints ms a step, steps/s, audio seconds a second, peak memory and one
   profiled step's device time and idle share. (d) a kernel-vs-plain row at every
   signature (shapes, strides, lengths) the recipe's runs launched, from the trainer's
   ``kernel_shapes`` (``recipe_kernel_rows``), each with the kernel's ms, a lone call's,
   the plain version's, the library call's and the bound.
17. training family (``phase_training_family``): (c) one training step (loss +
   backward) of each new loss on the card against the CPU port at PROD_CONF width cut to
   4 + 2 blocks (``train_family_cuda_vs_cpu``: SenseVoice, CTC, Paraformer-v2 with its
   device viterbi, E-Paraformer, BiCif, SeACo, Contextual, the fa-zh aligner,
   CT-Transformer at ct-punc's widths): the loss within ``TRAIN_LOSS_RTOL``, every gradient within
   ``FAMILY_TRAIN_GRAD_REL_TOL``, launches exactly ``family_train_sites``, the viterbi's
   indices on the card equal to the CPU's; (a) SenseVoice-Small's recipe as subprocesses:
   ``bin/data_tools sensevoice2jsonl`` (string tags) and ``bin/train
   ++dataset=SenseVoiceDataset`` on a seeded SenseVoiceSmall at its published width (50
   + 20 blocks, d 512, vocab 25,055) with SpecAugLFR, one epoch of token batches of 6,000
   (a mid-epoch checkpoint with its validation, the epoch's, the 2 best averaged), gated
   on a finite loss every step, launches exactly 70 flash + 70 flash backward + 70 FSMN
   + 70 dx + 70 dw a step and 70 + 70 a validation batch, every q / k row, FSMN tap and
   the prompt embed's rows of the data's tags reached by a gradient, the n-best metric
   the loss, the average decoding through ``AutoModel`` at 70 + 70 launches; prints ms a
   step, audio seconds a second, peak memory, a profiled step's device time and idle
   share; (b) a kernel-vs-plain row at every signature the recipe launched and at
   CT-Transformer's (16, 8, L, 32) flash backward and (16, L, 256) FSMN dx / dw.

18. streaming training (``phase_streaming_training``): (c) one training step of a
   PROD_CONF-width ParaformerStreaming cut to 4 + 2 blocks under each chunk config, on the
   card and on the CPU (loss within TRAIN_LOSS_RTOL, every gradient within
   ``STREAM_TRAIN_GRAD_REL_TOL`` relative L2, launches exactly ``train_sites``); (a)
   paraformer_streaming's ``finetune.sh`` flags through ``bin/train`` on a seeded
   paraformer-zh-streaming dir at full width (50 + 16 blocks, d 512, vocab 8,404; chunk
   sizes [12, 15], strides [8, 10], look-back 4; decoder sanm_shfit 5) over phase 16's
   wavs, one epoch of token batches of 6,000 (a mid-epoch checkpoint with its
   validation, the epoch's, the 2 best averaged), gated on a finite loss every step,
   both chunk configs drawn over the steps, each step's launches exactly phase 16's with
   every flash launch in chunk mode, every q / k row and FSMN tap reached by a gradient,
   and the average decoding through ``AutoModel``'s streaming ``generate`` at phase 11's
   launches a chunk; prints ms a step, audio seconds a second, peak memory, a profiled
   step's device time and idle share; (b) a kernel-vs-plain row at every signature the
   recipe launched (chunk mode under each config; FSMN, dx and dw under the holed frame
   mask at (5, 5) and the decoder's (10, 0)), each within 1e-5 relative L2 and bit-equal
   across two runs.

``python3 chip_smoke.py --recipe-ab [TREE]`` (not part of the run above): the recipe's
``bin/train`` six times in one process, alternating this tree with the kernel-shape log on
and the same tree with it off, or, given TREE (another checkout), this tree and that one
with the log off on both: ms a step of each run and pooled (``recipe_ab``), to compare
two versions within one call.

Kernel times (phases 3-4): ``ms`` is device time per launch over 20 back-to-back
launches between one pair of CUDA events, queued behind a spin kernel so that host
overhead leaves no gaps (``device_ms``, median of 5); ``call_ms`` one lone call
between events, so the wrapper's host overhead is in it; ``plain_ms`` the plain PyTorch
version and ``library_ms`` one PyTorch call computing the same function
(``LIBRARY_CALLS``; for W8A8 the integer product alone, with cuBLAS bf16 ``F.linear``
beside it as ``cublas_bf16_ms``), both timed like ``ms``; ``bound_ms`` the least time
the card could take (``bound_ms()``, from the bytes and operations of ``*_work()`` at
the H100's published peaks; fp32 flash on the 3xTF32 route, ``flash_bound()``, with the
CUDA-core figure beside it as ``cuda_core_bound_ms``). The W8A8 lines add its quantize / GEMM split from
torch.profiler. No L2 flush between launches: on the path each kernel reads what the
op before it just wrote.

The second-to-last line is the kernels' JSON record (``kernels_line``: each kernel at
its main path shape, with ``launches`` of the main path's run and
``launches_per_decode``; flash and FSMN add their fp32 figures under ``fp32``, launches
from the fp32 ``AutoModel`` decode, and their rows at the pipeline's shapes under
``pipeline``, launches from phase 8's two requests; every kernel's launches on phase 9's
meetings under ``speaker``, on phase 10's decodes under ``hotword``, where FSMN adds its
k = 21 rows, phase 11's under ``streaming``, with the rows at the streaming shapes,
phase 12's under ``sensevoice``, with the rows at SenseVoice's shapes, phase 13's under
``serving``, by server, with the rows at the serving shapes, and phase 14's under ``llm``,
by run, with the rows at the LLM path's shapes, and phase 15's under ``export``: launches
of each counted call of an exported program, with the rows at the shapes those calls
launched, and phase 16's under ``training``, with three more kernels, the backward
launches ``flash_attention_bwd``, ``fsmn_memory_bwd_input`` and ``fsmn_memory_bwd_weight``,
and phase 17's under ``training_family`` and phase 18's under ``streaming_training`` in
those five), the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# tolerances of the kernel phase (kernel vs plain on the same inputs, max abs error)
FLASH_TOL = {torch.float32: 1e-4,    # fp32 products, sums in another order
             torch.bfloat16: 2e-2}   # bf16 output rounding + P rounded to bf16
FSMN_TOL = {torch.float32: 1e-5,     # fp32 taps, FMA vs separate multiply-add
            torch.bfloat16: 2e-2}    # one bf16 ulp of outputs up to 4 in magnitude
CPU_GPU_ENC_TOL = 1e-3               # fp32 encoder output, cuBLAS vs CPU sum order
# W8A8, CUDA vs CPU (d = 256): the fp32 ops upstream of each W8A8 linear (LayerNorm,
# attention, cuBLAS) differ in the last bits between the devices, and an activation that
# sits within that of a rounding boundary of x / sx moves its int8 value by one. At
# this config 3 of 126,000 first-layer activations do so for most inputs, and the
# difference grows through the quantized layers: encoder drift 2.0e-3-3.5e-3 relative L2
# over 12 input seeds on the H100 (1.8e-7 where none crosses), with random-weight argmax
# margins that flip tokens. So the kernel is held bit-exact per call on the path's own
# activations, the drift to a bound above the measured range, and the agreement only
# against a broken path (random tokens agree 1 in 304).
W8A8_ENC_REL_TOL = 1e-2
W8A8_MIN_AGREEMENT = 0.5
W8A8_TOL = 0                         # the W8A8 kernel is bit-exact to its plain version

PROD_CONF = dict(
    input_size=560, vocab_size=8404,
    encoder_conf=dict(output_size=512, attention_heads=4, linear_units=2048,
                      num_blocks=50, kernel_size=11, sanm_shfit=0, dropout_rate=0.0),
    decoder_conf=dict(attention_heads=16, linear_units=2048, num_blocks=16,
                      att_layer_num=16, kernel_size=11, sanm_shfit=0),
    predictor_conf=dict(idim=512, l_order=1, r_order=1, tail_threshold=0.45),
    sos=1, eos=2, predictor_bias=1)

SMALL_CONF = dict(
    input_size=560, vocab_size=41,
    encoder_conf=dict(output_size=64, attention_heads=4, linear_units=96, num_blocks=2),
    decoder_conf=dict(attention_heads=4, linear_units=96, num_blocks=2, att_layer_num=2,
                      sanm_shfit=0),
    predictor_conf=dict(idim=64), sos=1, eos=2, predictor_bias=1)

# the W8A8 CUDA-vs-CPU config: every linear large enough to quantize (min dim 256)
D256_CONF = dict(
    input_size=560, vocab_size=304,
    encoder_conf=dict(output_size=256, attention_heads=4, linear_units=256, num_blocks=2),
    decoder_conf=dict(attention_heads=4, linear_units=256, num_blocks=2, att_layer_num=2,
                      sanm_shfit=0),
    predictor_conf=dict(idim=256), sos=1, eos=2, predictor_bias=1)

FRONTEND_CONF = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, cmvn_file=None, dither=0.0)

# (M, K, N) of every W8A8 linear on the path at B = 32 x 15 s (encoder M = 32 x 384,
# decoder M = 32 x 208) and of the long-form decoder (M = 1408 / 2 + 16)
W8A8_SHAPES = [(12288, 560, 1536), (12288, 512, 1536), (12288, 512, 512), (12288, 512, 2048),
               (12288, 2048, 512), (6656, 512, 512), (6656, 512, 2048), (6656, 2048, 512),
               (12288, 512, 1024), (720, 512, 2048)]


def log(*args):
    print(*args, flush=True)


def device_ms(fn, launches=20, repeats=5, warmup=3):
    """Device time of one call: `launches` back-to-back calls between one pair of CUDA
    events, divided by their number; median over `repeats` after warm-up. A spin kernel
    ahead of the first event holds the stream until the host has queued every launch,
    so the wrapper's host overhead never leaves the device idle between them. If the
    spin had already ended when the host finished queueing, the repeat is dropped and
    the spin doubled."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, spin = [], 1 << 21
    while len(times) < repeats:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        starved = e0.query() and spin < 1 << 31
        e1.synchronize()
        if starved:
            spin *= 2
        else:
            times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)


def quick_ms(fn):
    """``device_ms`` with 3 launches and 3 repeats: for the plain versions of phase 16's
    rows (the recipe's 27 signatures among them), host-bound calls whose 20-launch runs
    cost ~2 s each."""
    return device_ms(fn, launches=3, repeats=3, warmup=1)


def call_ms(fn, iters=20, warmup=3):
    """Wall time of one lone call, host overhead included (the wrapper's checks, ctypes
    marshalling, allocations): CUDA events around each single call; median."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def wall_ms(fn, runs=5):
    """Host-clock wall time of `fn` ending in a synchronize: (median ms, all runs)."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def profile_kernels(fn, calls=1):
    """Device time in ms and launches of each kernel over `calls` calls of `fn`, from
    torch.profiler: {kernel name: (ms, launches)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


# A profile that shows fewer launches of a kernel than its counter gave is taken again,
# at most PROFILE_TRIES times in all, each try printed, before its launches are gated
PROFILE_TRIES = 3


def profile_once(fn, label, wall):
    """One call of `fn` under torch.profiler: device kernel time in all and by kernel,
    and the device's idle share against `wall`, the unprofiled median wall ms. Returns
    {kernel name: (ms, launches)}."""
    t0 = time.perf_counter()
    by_name = profile_kernels(fn)
    kernels = sorted(((t, n, name) for name, (t, n) in by_name.items()), reverse=True)
    device = sum(t for t, _, _ in kernels)
    log(f"profile {label}: device kernel time {device:.2f} ms, unprofiled wall {wall:.2f} ms, "
        f"idle share {1 - device / wall:.1%} (profiled and summed in "
        f"{time.perf_counter() - t0:.1f} s); by kernel (ms, launches):")
    for t, n, name in kernels[:14]:
        log(f"  {t:8.3f} {n:5d}  {name[:110]}")
    for group, keys in PORT_KERNELS.items():  # the port's kernels, all instantiations
        rows = [(t, n) for t, n, name in kernels if any(k in name for k in keys)]
        log(f"  port {group}: {sum(t for t, _ in rows):.3f} ms over {sum(n for _, n in rows)} "
            f"launches")
    return by_name


def kernel_totals(by_name, key):
    """(device ms, launches) summed over the profiled kernels whose name holds `key`."""
    rows = [v for name, v in by_name.items() if key in name]
    return sum(t for t, _ in rows), sum(n for _, n in rows)


# the device kernels of each wrapper, by name
PORT_KERNELS = {"flash_attention": ("flash_bf16_kernel", "flash_f32_kernel"),
                "fsmn_memory": ("fsmn_kernel",),
                "w8a8_linear": ("quantize_rows_kernel", "gemm_kernel")}
# the fp32 instantiations, which the default (fp32) AutoModel must launch
FP32_KERNELS = {"flash_attention": "flash_f32_kernel", "fsmn_memory": "fsmn_kernel<float"}


# NVIDIA H100 SXM, published dense peaks (data sheet) at the full 700 W power limit;
# "fp32" is the CUDA cores' rate, "tf32" the tensor cores'
H100_PEAK = {"bytes": 3.35e12, "bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
             "fp32": 67e12}


def bound_ms(n_bytes, n_ops, op_type, peak=H100_PEAK):
    """The least time the card could take: the larger of the bytes over the memory rate
    and the operations over the peak rate of their type; (ms, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / peak["bytes"] * 1e3, n_ops / peak[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_work(b, h, t, d, lengths, elem_bytes, limits=None):
    """Bytes and flops of flash attention with T query rows over (B, H, ., D): q read and
    o written in full, k and v read up to the keys each batch row needs (its length; all
    T keys for a length-0 row, which averages V), the int32 lengths; 4 D flops per query
    row and key it sees. ``limits``: each batch row's per-query-row key limits (a key
    cache, Tk > T, or the causal / corner modes), else every row sees its length."""
    if limits is None:
        limits = [[n if n > 0 else t] * t for n in lengths]
    n_bytes = elem_bytes * h * d * sum(2 * len(r) + 2 * max(r) for r in limits) + 4 * b
    return n_bytes, 4 * h * d * sum(sum(r) for r in limits)


def flash_bound(b, h, t, d, lengths, dtype, limits=None):
    """The flash bound (ms, by) for `dtype`. fp32 takes the card's fastest route to
    fp32-accurate products: the 3xTF32 split, three TF32 products per product, on the
    tensor cores."""
    n_bytes, n_ops = flash_work(b, h, t, d, lengths, 2 if dtype == torch.bfloat16 else 4,
                                limits)
    if dtype == torch.bfloat16:
        return bound_ms(n_bytes, n_ops, "bf16")
    return bound_ms(n_bytes, 3 * n_ops, "tf32")


def fsmn_work(b, t, c, k, elem_bytes):
    """Bytes and flops of the FSMN memory block: x read and out written once, the
    (C, k) taps, the bool mask; k multiply-adds and the residual add per element."""
    return elem_bytes * (2 * b * t * c + c * k) + b * t, (2 * k + 1) * b * t * c


def w8a8_work(m, k, n, x_bytes, bias_bytes):
    """Bytes and int8 operations of the W8A8 linear: x read, int8 weights, fp32 scales
    and the bias read, out (x's dtype) written; 2 M N K integer operations."""
    return m * k * x_bytes + n * k + 4 * n + bias_bytes * n + m * n * x_bytes, 2 * m * n * k


LIBRARY_CALLS = {
    "flash_attention": "torch.nn.functional.scaled_dot_product_attention(q, k, v, "
                       "attn_mask=key_valid)",
    "fsmn_memory": "torch.nn.functional.conv1d(xm, w, padding=5, groups=C)",
    "w8a8_linear": "torch._int_mm(x_q, w_q8.t())",
}


def pcm(rng, seconds, fs=16000):
    return np.asarray(rng.standard_normal(int(seconds * fs)) * 0.1 * 32767, np.int16)


def phase_kernels(dev):
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from funasr_tpu_torch.ops.fsmn import fsmn_memory, fsmn_memory_ref

    g = torch.Generator(device="cpu").manual_seed(0)
    record = {}
    for shape in ((32, 4, 384, 128), (1, 4, 1408, 128)):
        b, h, t, d = shape
        for dtype in (torch.bfloat16, torch.float32):
            # q | k | v as strided head views of one fused projection, as on the path
            qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev, dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            lens_list = [t - 37 * (i % 2) for i in range(b)]
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            out = flash_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v, lens)
            err = max((out[i, :, :n] - ref[i, :, :n]).abs().max().item()
                      for i, n in enumerate(lens_list))
            row = dict(shape=shape, max_abs_err=err,
                       ms=device_ms(lambda: flash_attention(q, k, v, lens)),
                       call_ms=call_ms(lambda: flash_attention(q, k, v, lens)),
                       plain_ms=device_ms(lambda: flash_attention_ref(q, k, v, lens)))
            row["bound_ms"], row["bound_by"] = flash_bound(b, h, t, d, lens_list, dtype)
            if dtype == torch.float32:  # the CUDA-core bound, beside the 3xTF32 one
                row["cuda_core_bound_ms"] = bound_ms(
                    *flash_work(b, h, t, d, lens_list, 4), "fp32")[0]
            key_valid = torch.arange(t, device=dev)[None, :] < lens[:, None].long()
            mask = key_valid[:, None, None, :]
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            log(f"flash {shape} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"(tol {FLASH_TOL[dtype]:g}) " + timing_line(row))
            if not (math.isfinite(err) and err <= FLASH_TOL[dtype]):
                raise AssertionError(f"flash kernel disagrees at {shape} {dtype}: {err}")
            if shape == (32, 4, 384, 128):
                record[("flash_attention", dtype)] = row

    for shape in ((32, 384, 512), (32, 208, 512)):
        b, t, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(b, t, 3 * c, generator=g).to(dev, dtype)[..., 2 * c:]
            w = (torch.rand(c, 1, 11, generator=g) - 0.5).to(dev, dtype)
            lens = torch.tensor([t - 17 * (i % 3) for i in range(b)], device=dev)
            mask = torch.arange(t, device=dev)[None] < lens[:, None]
            out = fsmn_memory(x, w, mask, 5, 5)
            torch.cuda.synchronize()
            err = (out - fsmn_memory_ref(x, w, mask, 5, 5)).abs().max().item()
            xm = (x * mask[..., None].to(dtype)).transpose(1, 2).contiguous()  # (B, C, T)
            row = dict(shape=shape, max_abs_err=err,
                       ms=device_ms(lambda: fsmn_memory(x, w, mask, 5, 5)),
                       call_ms=call_ms(lambda: fsmn_memory(x, w, mask, 5, 5)),
                       plain_ms=device_ms(lambda: fsmn_memory_ref(x, w, mask, 5, 5)),
                       library_ms=device_ms(lambda: F.conv1d(xm, w, padding=5, groups=c)))
            row["bound_ms"], row["bound_by"] = bound_ms(
                *fsmn_work(b, t, c, 11, x.element_size()), "fp32")
            log(f"fsmn {shape} k=11 {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"(tol {FSMN_TOL[dtype]:g}) " + timing_line(row))
            if not (math.isfinite(err) and err <= FSMN_TOL[dtype]):
                raise AssertionError(f"fsmn kernel disagrees at {shape} {dtype}: {err}")
            if shape == (32, 384, 512):
                record[("fsmn_memory", dtype)] = row
    record.update(pipeline_kernel_rows(dev, g))
    record.update(hotword_kernel_rows(dev, g))
    record.update(streaming_kernel_rows(dev, g))
    record.update(sense_voice_kernel_rows(dev, g))
    return record


def fsmn_row(x, w, mask, left, right, timed=True, plain_timer=None):
    """One FSMN kernel row against its plain version, with the library call
    ``F.conv1d(groups=C)`` (zero padding max(left, right), the causal output sliced) plus
    the residual. Untimed: the error only."""
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.fsmn import fsmn_memory, fsmn_memory_ref

    b, t, c = x.shape
    k = w.shape[-1]
    out = fsmn_memory(x, w, mask, left, right)
    torch.cuda.synchronize()
    err = (out - fsmn_memory_ref(x, w, mask, left, right)).abs().max().item()
    if not timed:
        return dict(shape=(b, t, c), k=k, pads=(left, right), max_abs_err=err)
    xm = x if mask is None else x * mask[..., None].to(x.dtype)
    xm = xm.transpose(1, 2).contiguous()  # (B, C, T)
    pad, off = max(left, right), max(left, right) - left
    row = dict(shape=(b, t, c), k=k, pads=(left, right), max_abs_err=err,
               library_call=f"F.conv1d(xm, w, padding={pad}, groups=C)[..., {off}:{off} + T]"
                            " + xm",
               ms=device_ms(lambda: fsmn_memory(x, w, mask, left, right)),
               call_ms=call_ms(lambda: fsmn_memory(x, w, mask, left, right)),
               plain_ms=(plain_timer or device_ms)(
                   lambda: fsmn_memory_ref(x, w, mask, left, right)),
               library_ms=device_ms(
                   lambda: F.conv1d(xm, w, padding=pad, groups=c)[..., off:off + t] + xm))
    row["bound_ms"], row["bound_by"] = bound_ms(*fsmn_work(b, t, c, k, x.element_size()),
                                                "fp32")
    return row


def chunk_library_mask(lens, t, chunk):
    """Chunk mode's (B, Tq, Tk) mask for the library call: SDPA gives a row with no live key
    NaN, so each such row (an FSMN shift row) gets its key 0 live; the kernel's time is
    that of the chunk mask itself."""
    from funasr_tpu_torch.ops.flash_attention import chunk_mask
    live = chunk_mask(lens, t, t, chunk)
    dead = ~live.any(-1)
    live[..., 0] |= dead
    return live


def chunk_flash_work(b, h, t, d, lens, chunk, elem_bytes=4):
    """Bytes and flops of chunk mode over (B, H, T, D): q read and o written in full, k and
    v read up to each batch row's length, the lengths; 4 D flops per live score (the
    predicate's, ``chunk_mask``), which is what the work needs. Returns (bytes, flops, live
    scores)."""
    from funasr_tpu_torch.ops.flash_attention import chunk_mask
    live = int(chunk_mask(lens, t, t, chunk).sum())
    n_bytes = elem_bytes * h * d * (2 * b * t + 2 * int(lens.sum())) + 4 * b
    return n_bytes, 4 * h * d * live, live


def flash_row(q, k, v, lens_list, mode="none", vad_pos=None, timed=True, plain_timer=None,
              chunk=None):
    """One flash kernel row against its plain version and scaled_dot_product_attention
    (with the explicit (B, 1, Tq, Tk) mask of the same key limits); the error over each
    row's valid queries. q (B, H, Tq, D), k and v (B, H, Tk, D); ``mode`` / ``vad_pos``
    the per-row key limits, or ``mode="chunk"`` with ``chunk``: then also the relative L2
    error over every row, whether fully masked rows are 0 and whether two runs are
    bit-equal, the library call on ``chunk_library_mask`` and the bound over the live
    scores. Untimed: the error only."""
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.flash_attention import (chunk_mask, flash_attention,
                                                      flash_attention_ref, key_limits)

    b, h, t, d = q.shape
    tk = k.shape[2]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=q.device)
    vp = None if vad_pos is None else torch.tensor(vad_pos, dtype=torch.int32, device=q.device)
    out = flash_attention(q, k, v, lens, mode, vp, chunk)
    again = None if chunk is None else flash_attention(q, k, v, lens, mode, vp, chunk)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, lens, mode, vp, chunk)
    err = max((out[i, :, :min(n, t)] - ref[i, :, :min(n, t)]).abs().max().item()
              for i, n in enumerate(lens_list))
    row = dict(shape=(b, h, t, d), max_abs_err=err)
    if tk != t:
        row["keys"] = tk
    if mode != "none":
        row.update(mode=mode, vad_pos=vad_pos)
    if chunk is not None:
        dead = ~chunk_mask(lens, t, t, chunk).any(-1)
        row.update(chunk=list(chunk), rel_l2=rel_l2(out, ref), deterministic=torch.equal(
            out, again), dead_rows_zero=bool((out.permute(0, 2, 1, 3)[dead] == 0).all()))
    if not timed:
        return row
    if chunk is not None:
        mask = chunk_library_mask(lens, t, chunk)[:, None]
    else:
        limits = key_limits(lens, t, mode, vp)
        mask = (torch.arange(tk, device=q.device)[None, None, :] < limits[:, :, None])[:, None]
    row.update(library_call=LIBRARY_CALLS["flash_attention"],
               ms=device_ms(lambda: flash_attention(q, k, v, lens, mode, vp, chunk)),
               call_ms=call_ms(lambda: flash_attention(q, k, v, lens, mode, vp, chunk)),
               plain_ms=(plain_timer or device_ms)(
                   lambda: flash_attention_ref(q, k, v, lens, mode, vp, chunk)),
               library_ms=device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)))
    if chunk is not None:
        n_bytes, n_ops, row["live_scores"] = chunk_flash_work(b, h, t, d, lens, chunk)
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 3 * n_ops, "tf32")
        # the mode-0 kernel on the same inputs and lengths: what chunk mode's tile ranges save
        row["mode_none_ms"] = device_ms(lambda: flash_attention(q, k, v, lens))
    else:
        row["bound_ms"], row["bound_by"] = flash_bound(b, h, t, d, lens_list, q.dtype,
                                                       limits.tolist())
    return row


def pipeline_kernel_rows(dev, g):
    """The kernels at the shapes of the VAD -> ASR -> punctuation pipeline (phase 8):
    the VAD's causal FSMN memory over cache + one 60 s chunk (k = 20, pads 19 / 0, no
    mask, C = 128, fp32), the punctuation encoder's FSMN (v slice, k = 11, prefix mask,
    C = 256) and its flash attention (8 heads x 32, strided head views of q|k|v, a ragged
    length), each against its plain version. Raises on a disagreement."""
    rows = {}
    x = torch.randn(1, 6019, 128, generator=g).to(dev)  # concat(cache, h), contiguous
    w = ((torch.rand(128, 1, 20, generator=g) - 0.5) * 2e-3).to(dev)
    rows[("fsmn_memory", "vad")] = fsmn_row(x, w, None, 19, 0)
    x = torch.randn(1, 64, 3 * 256, generator=g).to(dev)[..., 2 * 256:]
    w = (torch.rand(256, 1, 11, generator=g) - 0.5).to(dev)
    mask = torch.arange(64, device=dev)[None] < 57
    rows[("fsmn_memory", "punc")] = fsmn_row(x, w, mask, 5, 5)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(1, 64, 3, 8, 32, generator=g).to(dev, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rows[("flash_attention", "punc", dtype)] = flash_row(q, k, v, [57])
    for key, row in rows.items():
        dtype = key[2] if len(key) > 2 else torch.float32
        tol = (FLASH_TOL if key[0] == "flash_attention" else FSMN_TOL)[dtype]
        log(f"{key[0]} {key[1]} {row['shape']} {str(dtype)[6:]}: max_abs_err "
            f"{row['max_abs_err']:.3e} (tol {tol:g}) " + timing_line(row))
        if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= tol):
            raise AssertionError(f"{key} kernel disagrees: {row['max_abs_err']}")
    return rows


def hotword_kernel_rows(dev, g):
    """The FSMN kernel at the SeACo decoder's shape (phase 10): k = 21, pads 10 / 10, its
    contiguous (32, 208, 512) input with a prefix mask, fp32 and bf16, against its plain
    version and against the generic instantiation (``generic_ms``: the kernel before its
    k = 21 instantiation), which must agree with it exactly. Raises on a disagreement."""
    from funasr_tpu_torch.ops.fsmn import fsmn_memory

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(32, 208, 512, generator=g).to(dev, dtype)
        w = (torch.rand(512, 1, 21, generator=g) - 0.5).to(dev, dtype)
        lens = torch.tensor([208 - 17 * (i % 3) for i in range(32)], device=dev)
        mask = torch.arange(208, device=dev)[None] < lens[:, None]
        row = fsmn_row(x, w, mask, 10, 10)
        generic = fsmn_memory(x, w, mask, 10, 10, generic=True)
        same = torch.equal(generic, fsmn_memory(x, w, mask, 10, 10))
        row["generic_ms"] = device_ms(lambda: fsmn_memory(x, w, mask, 10, 10, generic=True))
        log(f"fsmn_memory hotword (32, 208, 512) k=21 {str(dtype)[6:]}: max_abs_err "
            f"{row['max_abs_err']:.3e} (tol {FSMN_TOL[dtype]:g}) " + timing_line(row)
            + f"; generic instantiation {row['generic_ms']:.4f} ms, equal {same}")
        if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= FSMN_TOL[dtype]
                and same):
            raise AssertionError(f"the k = 21 FSMN kernel disagrees ({dtype}): "
                                 f"{row['max_abs_err']}, equal to the generic one {same}")
        rows[("fsmn_memory", "hotword", dtype)] = row
    return rows


def timing_line(row):
    return (f"kernel {row['ms']:.4f} ms (back-to-back launches; lone call, host overhead "
            f"included, {row['call_ms']:.4f}) plain {row['plain_ms']:.4f} library "
            f"{row['library_ms']:.4f} "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.1%} of it)"
            + (f"; CUDA-core fp32 bound {row['cuda_core_bound_ms']:.4f} ms"
               if "cuda_core_bound_ms" in row else "")
            + (f"; mode 0 on the same inputs {row['mode_none_ms']:.4f} ms"
               if "mode_none_ms" in row else ""))


def w8a8_row(x, w_q8, scale, bias, label="w8a8"):
    """One W8A8 kernel row, bit-exact against its plain version, with the library's integer
    product alone (``torch._int_mm`` on the padded int8 operands) and cuBLAS bf16
    ``F.linear``; bf16 rows print the profile's quantize / GEMM split. ``bias`` may be
    None (Qwen's linears have none). Raises on a disagreement."""
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.w8a8 import (plan_w8a8, quantize_rows_int8, w8a8_linear,
                                           w8a8_linear_ref)

    (m, k), n, dtype = x.shape, w_q8.shape[0], x.dtype
    out = w8a8_linear(x, w_q8, scale, bias)
    torch.cuda.synchronize()
    ref = w8a8_linear_ref(x, w_q8, scale, bias)
    err = (out.float() - ref.float()).abs().max().item()
    row = dict(shape=(m, k, n), max_abs_err=err,
               ms=device_ms(lambda: w8a8_linear(x, w_q8, scale, bias)),
               call_ms=call_ms(lambda: w8a8_linear(x, w_q8, scale, bias)),
               plain_ms=device_ms(lambda: w8a8_linear_ref(x, w_q8, scale, bias), launches=5))
    kp = plan_w8a8(m, k, n, dtype).kp
    # torch._int_mm takes more than 16 rows: a decode step's M = 16 goes in padded to 32
    x_q = F.pad(quantize_rows_int8(x)[0], (0, kp - k, 0, max(0, 32 - m) if m <= 16 else 0))
    w_p = F.pad(w_q8, (0, kp - k))
    row["library_rows"] = x_q.shape[0]
    row["library_ms"] = device_ms(lambda: torch._int_mm(x_q, w_p.t()))
    w_bf16 = (w_q8.float() * scale[:, None]).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    bb = None if bias is None else bias.to(torch.bfloat16)
    row["cublas_bf16_ms"] = device_ms(lambda: F.linear(xb, w_bf16, bb))
    row["bound_ms"], row["bound_by"] = bound_ms(*w8a8_work(
        m, k, n, x.element_size(), 0 if bias is None else bias.element_size()), "int8")
    log(f"{label} ({m}, {k}, {n}) {str(dtype)[6:]}: max_abs_err {err:.3e} "
        f"(tol {W8A8_TOL}) " + timing_line(row)
        + f"; cuBLAS bf16 F.linear {row['cublas_bf16_ms']:.4f}")
    if dtype == torch.bfloat16:
        split = profile_kernels(lambda: w8a8_linear(x, w_q8, scale, bias), calls=10)
        log("  profile, ms per call: " + ", ".join(
            f"{name.split('<')[0].split('::')[-1]} {t / 10:.4f}"
            for name, (t, _) in split.items()))
    if not torch.equal(out, ref):
        raise AssertionError(f"w8a8 kernel disagrees at {(m, k, n)} {dtype}: {err}")
    return row


def phase_w8a8_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    record = None
    for m, k, n in W8A8_SHAPES:
        w_q8 = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(n, generator=g, device=dev) * 1e-3
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(m, k, generator=g, device=dev).to(dtype)
            x[-1] = 0  # a zero-padded bucket row
            bias = torch.randn(n, generator=g, device=dev).to(dtype)
            row = w8a8_row(x, w_q8, scale, bias)
            if (m, k, n) == (12288, 512, 2048) and dtype == torch.bfloat16:
                record = row
    return record


def compare_cuda_cpu(dev, cpu_model, gpu_model, seed):
    """The same weights on the CPU and on CUDA, 3 utterances: encoder max abs and
    relative L2 errors, whether the token ids are equal, the share of equal tokens, and
    the CUDA token counts."""
    from funasr_tpu_torch import tables

    rng = np.random.default_rng(seed)
    waves = [pcm(rng, s) for s in (3.0, 4.5, 2.2)]
    frontend = tables.frontend_classes["WavFrontend"](**FRONTEND_CONF)
    feats, flens = frontend.extract(waves)
    with torch.inference_mode():
        enc_cpu, _ = cpu_model.encode(torch.from_numpy(feats), torch.from_numpy(flens))
        enc_gpu, _ = gpu_model.encode(torch.from_numpy(feats).to(dev),
                                      torch.from_numpy(flens).to(dev))
    diff = enc_gpu.cpu() - enc_cpu
    out_cpu = cpu_model.infer_bucketed(feats, flens)
    out_gpu = gpu_model.infer_bucketed(feats, flens)
    same_lens = np.array_equal(out_cpu[1], out_gpu[1])
    seqs = [(out_cpu[0][i, :n], out_gpu[0][i, :m])
            for i, (n, m) in enumerate(zip(out_cpu[1], out_gpu[1]))]
    n_same = sum(int((a[:len(b)] == b[:len(a)]).sum()) for a, b in seqs)
    return dict(enc_err=diff.abs().max().item(), enc_rel=(diff.norm() / enc_cpu.norm()).item(),
                same_ids=same_lens and all(np.array_equal(a, b) for a, b in seqs),
                agree=n_same / max(sum(max(len(a), len(b)) for a, b in seqs), 1),
                counts=out_gpu[1].tolist())


def phase_cuda_vs_cpu(dev):
    from funasr_tpu_torch import tables

    g = torch.Generator().manual_seed(0)
    cpu_model = tables.model_classes["Paraformer"](**SMALL_CONF, generator=g).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    r = compare_cuda_cpu(dev, cpu_model, gpu_model, seed=1)
    log(f"cuda vs cpu (2+2 blocks, d=64, fp32): encoder max_abs_err {r['enc_err']:.3e} "
        f"(tol {CPU_GPU_ENC_TOL:g}); token counts {r['counts']} ids equal {r['same_ids']}")
    if not (r["enc_err"] <= CPU_GPU_ENC_TOL and r["same_ids"]):
        raise AssertionError("the port on CUDA disagrees with the port on the CPU")


def phase_cuda_vs_cpu_w8a8(dev, seed=2):
    """W8A8 at d = 256 (every linear quantized), the kernel on CUDA against the plain
    version on the CPU. Gates: every W8A8 call of the CUDA run (encoder and decoder)
    launched the kernel and equals, bit for bit, the CPU plain version applied to that
    call's own CUDA input; the encoder drift within W8A8_ENC_REL_TOL; the token
    agreement at least W8A8_MIN_AGREEMENT. Token ids equal is printed, not gated."""
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.ops.quant import Int8Linear, quantize_params_int8
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear, w8a8_linear_ref

    g = torch.Generator().manual_seed(0)
    cpu_model = quantize_params_int8(
        tables.model_classes["Paraformer"](**D256_CONF, generator=g).eval(), mode="w8a8")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    calls = []  # (layer name, CUDA input, CUDA output) of every W8A8 call
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: calls.append((name, inp[0].cpu(), out.cpu())))
        for name, m in gpu_model.named_modules() if isinstance(m, Int8Linear) and m.key == "w_q8"]
    before = w8a8_linear.launches
    r = compare_cuda_cpu(dev, cpu_model, gpu_model, seed)
    launched = w8a8_linear.launches - before
    for h in hooks:
        h.remove()
    cpu_layers = dict(cpu_model.named_modules())
    differ = [name for name, x, y in calls
              if not torch.equal(w8a8_linear_ref(x, cpu_layers[name].w_q8, cpu_layers[name].scale,
                                                 cpu_layers[name].bias), y)]
    log(f"cuda vs cpu W8A8 (2+2 blocks, d=256, fp32, seed {seed}): {len(calls)} W8A8 calls on "
        f"CUDA, {launched} kernel launches, {len(differ)} differ from the CPU plain version "
        f"on their own input; encoder rel L2 {r['enc_rel']:.3e} (tol {W8A8_ENC_REL_TOL:g}), "
        f"max_abs_err {r['enc_err']:.3e}; token counts {r['counts']}, ids equal "
        f"{r['same_ids']}, agreement {r['agree']:.4f} (min {W8A8_MIN_AGREEMENT:g})")
    if differ or not calls or launched != len(calls):
        raise AssertionError(f"W8A8 kernel calls on the path disagree or bypass it: {differ}")
    if not (r["enc_rel"] <= W8A8_ENC_REL_TOL and r["agree"] >= W8A8_MIN_AGREEMENT):
        raise AssertionError("the W8A8 port on CUDA disagrees with the port on the CPU")


def phase_main_path(dev, tables, counters, card):
    from funasr_tpu_torch.core.module import cast_floats

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    model = tables.model_classes["Paraformer"](**PROD_CONF, device=dev, generator=g)
    model = cast_floats(model, torch.bfloat16).eval()
    frontend = tables.frontend_classes["WavFrontend"](**FRONTEND_CONF)
    token_list = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(8400)] + ["<unk>"]
    tokenizer = tables.tokenizer_classes["CharTokenizer"](token_list=token_list)
    log(f"main path: Paraformer-large width, bf16, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
        f"built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    batch = [pcm(rng, 15.0) for _ in range(32)]
    long_form = [pcm(rng, 70.0)]

    # warm-up (cuBLAS handles, allocator), outside the counted run
    model.inference(batch, tokenizer=tokenizer, frontend=frontend)
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    results, _ = model.inference(batch, tokenizer=tokenizer, frontend=frontend)
    long_results, _ = model.inference(long_form, tokenizer=tokenizer, frontend=frontend)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    n_decodes = 2
    log(f"main path launches over {n_decodes} decodes: {launches}")
    if len(results) != 32 or len(long_results) != 1:
        raise AssertionError(f"expected 32 + 1 results, got {len(results)} + {len(long_results)}")
    if not all(isinstance(r["text"], str) and r["text"] for r in results + long_results):
        raise AssertionError("empty transcript on the main path")
    if launches["flash_attention"] < 50 * n_decodes or launches["fsmn_memory"] < 66 * n_decodes:
        raise AssertionError(f"the main path bypassed a kernel: {launches}")

    # finite outputs of the expected shapes, at both buckets
    for waves, t_bucket in ((batch, 384), (long_form, 1408)):
        feats, flens = frontend.extract(waves, device=dev)
        yseq, token_lens, score, alphas, _ = model.infer_bucketed(feats, flens)
        if alphas.shape != (len(waves), t_bucket + 1):
            raise AssertionError(f"alphas shape {alphas.shape}, expected T bucket {t_bucket}")
        if not (np.isfinite(score).all() and np.isfinite(alphas).all()):
            raise AssertionError("NaN or inf on the main path")
        log(f"bucket T={t_bucket}: token counts {token_lens.tolist()[:8]}..., "
            f"decoded width {yseq.shape[1]}, mean score {float(score.mean()):.3f}")

    def decode():
        model.inference(batch, tokenizer=tokenizer, frontend=frontend)

    t_med, times = wall_ms(decode)
    log(f"main path B=32 x 15 s: waves -> text median {t_med:.2f} ms "
        f"(runs {[round(x, 2) for x in times]}), RTFx {32 * 15e3 / t_med:.1f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    profile_once(decode, "main path bf16, model.inference", t_med)
    return launches


def identity_cmvn(dim):
    return (f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n<AddShift> {dim} {dim}\n"
            f"<LearnRateCoef> 0 [ {' '.join(['0.0'] * dim)} ]\n<Rescale> {dim} {dim}\n"
            f"<LearnRateCoef> 0 [ {' '.join(['1.0'] * dim)} ]\n</Nnet>\n")


def write_model_dir(d, dev, model_name="Paraformer", predictor="CifPredictorV2",
                    predictor_conf=PROD_CONF["predictor_conf"],
                    decoder="ParaformerSANMDecoder", extra=None, encoder="SANMEncoder",
                    encoder_conf=PROD_CONF["encoder_conf"],
                    decoder_conf=PROD_CONF["decoder_conf"], frontend="WavFrontend",
                    tokens=None, craft=None):
    """A FunASR-layout model directory at PROD_CONF width with seeded random weights;
    `extra`: the model's own config keys (a hotword model's), in ``model_conf``; the
    streaming model names its own encoder, decoder shift and frontend; `tokens`: the token
    list (8,401 CJK characters by default); `craft`: applied to the model before it is
    saved."""
    import yaml
    from funasr_tpu_torch import tables

    g = torch.Generator(device=dev).manual_seed(0)
    conf = dict(PROD_CONF, predictor_conf=predictor_conf, encoder_conf=encoder_conf,
                decoder_conf=decoder_conf)
    model = tables.model_classes[model_name](**conf, encoder=encoder, predictor=predictor,
                                             decoder=decoder, device=dev, generator=g,
                                             **(extra or {}))
    if craft is not None:
        craft(model)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, os.path.join(d, "model.pt"))
    tokens = tokens or (["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(8400)]
                        + ["<unk>"])
    with open(os.path.join(d, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    with open(os.path.join(d, "am.mvn"), "w") as f:
        f.write(identity_cmvn(PROD_CONF["input_size"]))
    cfg = dict(model=model_name, model_conf=dict(sos=1, eos=2, predictor_bias=1, ctc_weight=0.0,
                                                 **(extra or {})),
               encoder=encoder, encoder_conf=encoder_conf,
               decoder=decoder, decoder_conf=decoder_conf,
               predictor=predictor, predictor_conf=predictor_conf,
               frontend=frontend, frontend_conf=dict(FRONTEND_CONF, cmvn_file="am.mvn"),
               tokenizer="CharTokenizer",
               tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>"))
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)


def token_agreement(texts_a, texts_b):
    """Share of aligned positions with the same character (one token per character)."""
    same = sum(sum(x == y for x, y in zip(a, b)) for a, b in zip(texts_a, texts_b))
    return same / max(sum(max(len(a), len(b)) for a, b in zip(texts_a, texts_b)), 1)


def phase_automodel(dev, counters, card):
    """AutoModel at PROD_CONF width from one model directory: W8A8 (bf16), quant=None
    (bf16), then the public default, fp32. Returns the launches of one W8A8 decode and
    of one fp32 decode."""
    import tempfile

    rng = np.random.default_rng(0)
    batch = [pcm(rng, 15.0) for _ in range(32)]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_model_dir(d, dev)
        log(f"AutoModel: model dir written in {time.perf_counter() - t0:.1f} s")
        w8a8_launches = automodel_w8a8(d, batch, dev, counters, card)
        fp32_launches = automodel_fp32(d, batch, dev, counters, card)
    return w8a8_launches, fp32_launches


def automodel_w8a8(d, batch, dev, counters, card):
    from funasr_tpu_torch import AutoModel

    t1 = time.perf_counter()
    am = AutoModel(model=d, device="cuda", bf16=True, quant="w8a8", batch_size=32,
                   log_level="WARNING")
    log(f"AutoModel W8A8: built in {time.perf_counter() - t1:.1f} s")
    am.generate(input=batch)  # warm-up, outside the counted run
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    results = am.generate(input=batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    log(f"AutoModel W8A8 launches over 1 decode: {launches}")
    if len(results) != 32 or not all(isinstance(r["text"], str) and r["text"]
                                     for r in results):
        raise AssertionError("AutoModel W8A8: expected 32 non-empty texts")
    if (launches["w8a8_linear"] < 282 or launches["flash_attention"] < 50
            or launches["fsmn_memory"] < 66):
        raise AssertionError(f"AutoModel W8A8 bypassed a kernel: {launches}")

    feats, flens = am.kwargs["frontend"].extract(batch, device=dev)
    _, token_lens, score, alphas, _ = am.model.infer_bucketed(feats, flens)
    if not (np.isfinite(score).all() and np.isfinite(alphas).all()):
        raise AssertionError("NaN or inf on the AutoModel W8A8 path")

    t_med, times = wall_ms(lambda: am.generate(input=batch))
    log(f"AutoModel W8A8 B=32 x 15 s: generate median {t_med:.2f} ms "
        f"(runs {[round(x, 2) for x in times]}), RTFx {32 * 15e3 / t_med:.1f}, "
        f"token counts {token_lens.tolist()[:8]}..., mean score {float(score.mean()):.3f} "
        f"on {card}")
    profile_once(lambda: am.generate(input=batch), "AutoModel W8A8 generate", t_med)
    del am
    ref = AutoModel(model=d, device="cuda", bf16=True, batch_size=32, log_level="WARNING")
    ref_results = ref.generate(input=batch)
    r_med, times = wall_ms(lambda: ref.generate(input=batch))
    log(f"AutoModel quant=None (bf16) B=32 x 15 s, same call: generate median {r_med:.2f} "
        f"ms (runs {[round(x, 2) for x in times]}), RTFx {32 * 15e3 / r_med:.1f}; W8A8 "
        f"takes {t_med / r_med:.3f}x its time")
    profile_once(lambda: ref.generate(input=batch), "AutoModel quant=None generate", r_med)
    del ref
    agree = token_agreement([r["text"] for r in results], [r["text"] for r in ref_results])
    log(f"AutoModel W8A8 vs quant=None (bf16): token agreement {agree:.4f} (not gated: "
        f"random weights)")
    return launches


def automodel_fp32(d, batch, dev, counters, card):
    """The public default, ``AutoModel(model=d, device="cuda")`` with no bf16 and no
    quant: the whole model in fp32, so every encoder attention and every FSMN block
    takes the fp32 kernels. Gates: 32 non-empty texts, finite scores, >= 50 flash and
    >= 66 FSMN launches per decode, and the profile showing those launches in the fp32
    kernels (``FP32_KERNELS``)."""
    from funasr_tpu_torch import AutoModel

    t1 = time.perf_counter()
    am = AutoModel(model=d, device="cuda", batch_size=32, log_level="WARNING")
    dtype = next(am.model.parameters()).dtype
    log(f"AutoModel fp32 (default dtype {dtype}): built in {time.perf_counter() - t1:.1f} s")
    if dtype != torch.float32:
        raise AssertionError(f"the default AutoModel runs in {dtype}, not float32")
    am.generate(input=batch)  # warm-up, outside the counted run
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    results = am.generate(input=batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    log(f"AutoModel fp32 launches over 1 decode: {launches}")
    if len(results) != 32 or not all(isinstance(r["text"], str) and r["text"]
                                     for r in results):
        raise AssertionError("AutoModel fp32: expected 32 non-empty texts")
    if launches["flash_attention"] < 50 or launches["fsmn_memory"] < 66:
        raise AssertionError(f"AutoModel fp32 bypassed a kernel: {launches}")

    feats, flens = am.kwargs["frontend"].extract(batch, device=dev)
    _, token_lens, score, alphas, _ = am.model.infer_bucketed(feats, flens)
    if not (np.isfinite(score).all() and np.isfinite(alphas).all()):
        raise AssertionError("NaN or inf on the AutoModel fp32 path")

    t_med, times = wall_ms(lambda: am.generate(input=batch))
    log(f"AutoModel fp32 B=32 x 15 s: generate median {t_med:.2f} ms "
        f"(runs {[round(x, 2) for x in times]}), RTFx {32 * 15e3 / t_med:.1f}, "
        f"token counts {token_lens.tolist()[:8]}..., mean score {float(score.mean()):.3f} "
        f"on {card}")
    by_name = profile_once(lambda: am.generate(input=batch), "AutoModel fp32 generate", t_med)
    fp32 = {name: kernel_totals(by_name, key) for name, key in FP32_KERNELS.items()}
    log("AutoModel fp32 profile, fp32 kernels (ms, launches) per decode: " + ", ".join(
        f"{FP32_KERNELS[name]} {ms:.3f} ms / {n}" for name, (ms, n) in fp32.items()))
    if fp32["flash_attention"][1] < 50 or fp32["fsmn_memory"][1] < 66:
        raise AssertionError(f"AutoModel fp32 did not run the fp32 kernels: {fp32}")
    del am
    return launches


# ---- phase 8: the VAD -> ASR -> punctuation pipeline -----------------------------------

# fsmn-vad and ct-punc-c at their published widths (benchmarks/bench_realtime_ws.py:63-83)
VAD_CONF = dict(input_dim=400, input_affine_dim=140, fsmn_layers=4, linear_dim=250,
                proj_dim=128, lorder=20, rorder=0, lstride=1, rstride=1,
                output_affine_dim=140, output_dim=248)
PUNC_ENC = dict(input_size=256, output_size=256, attention_heads=8, linear_units=1024,
                num_blocks=4, input_layer="pe", kernel_size=11, sanm_shfit=0)
PUNC_MODEL_CONF = dict(punc_list=["<unk>", "_", "，", "。", "？", "、"], embed_unit=256,
                       att_unit=256, sentence_end_id=3)
PUNC_VOCAB = 272727
PIPELINE_REQUESTS = 2  # cut from 4, for the run's time limit beside phase 13
REQUEST_SECONDS = 300.0
MIN_SEGMENTS = 10
PUNC_LOGIT_TOL = 1e-3  # fp32 logits, CUDA against the CPU: cuBLAS and kernel sum order


def write_config(d, cfg):
    import yaml
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)


def craft_energy_vad(vad, g, tap=1e-3):
    """A deterministic energy detector at fsmn-vad width: every layer averages its input,
    the output affine maps the mean log-mel energy m to logits sil = 3 - 2m, speech = 2m
    (every other pdf -10). The memory taps are seeded values in +-tap, so the FSMN kernel's
    output enters the scores."""
    enc, c = vad.encoder, vad.encoder.cfg
    with torch.no_grad():
        for lin, fan_in in ((enc.in_linear1.linear, c.input_dim),
                            (enc.in_linear2.linear, c.input_affine_dim),
                            (enc.out_linear1.linear, c.linear_dim)):
            lin.weight.fill_(1.0 / fan_in)
            lin.bias.zero_()
        for blk in enc.fsmn:
            blk.linear.linear.weight.fill_(1.0 / c.linear_dim)
            w = blk.fsmn_block.conv_left.weight
            w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * tap)
            blk.affine.linear.weight.fill_(1.0 / c.proj_dim)
            blk.affine.linear.bias.zero_()
        out = enc.out_linear2.linear
        out.weight.zero_()
        out.weight[0].fill_(-2.0 / c.output_affine_dim)
        out.weight[1].fill_(2.0 / c.output_affine_dim)
        out.bias.fill_(-10.0)
        out.bias[0] = 3.0
        out.bias[1] = 0.0


def write_pipeline_dirs(root, dev, asr_writer=None):
    """FunASR-layout model directories under `root`: the PROD_CONF Paraformer (or what
    `asr_writer` writes), fsmn-vad (crafted energy detector) and ct-punc-c (the ASR's
    8404 tokens first, then filler tokens up to 272727), all from the port's seeded
    modules."""
    dirs = {name: os.path.join(root, name) for name in ("asr", "vad", "punc")}
    for d in dirs.values():
        os.makedirs(d)
    (asr_writer or write_model_dir)(dirs["asr"], dev)
    write_vad_dir(dirs["vad"])
    write_punc_dir(dirs["punc"])
    return dirs


def write_vad_dir(d):
    from funasr_tpu_torch import tables

    g = torch.Generator().manual_seed(1)
    vad = tables.model_classes["FsmnVADStreaming"](encoder_conf=VAD_CONF, generator=g)
    craft_energy_vad(vad, g)
    torch.save(vad.state_dict(), os.path.join(d, "model.pt"))
    with open(os.path.join(d, "am.mvn"), "w") as f:
        f.write(identity_cmvn(VAD_CONF["input_dim"]))
    write_config(d, dict(
        model="FsmnVADStreaming",
        model_conf=dict(max_end_silence_time=800, speech_noise_thres=0.6, sil_pdf_ids=[0]),
        encoder="FSMN", encoder_conf=VAD_CONF, frontend="WavFrontendOnline",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=5, lfr_n=1, cmvn_file="am.mvn",
                           dither=0.0)))


def write_punc_dir(d):
    from funasr_tpu_torch import tables

    asr_tokens = (["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(8400)]
                  + ["<unk>"])
    tokens = asr_tokens + [f"<filler_{i}>" for i in range(PUNC_VOCAB - len(asr_tokens))]
    punc = tables.model_classes["CTTransformer"](
        encoder_conf=PUNC_ENC, vocab_size=len(tokens), **PUNC_MODEL_CONF,
        generator=torch.Generator().manual_seed(2))
    torch.save(punc.state_dict(), os.path.join(d, "model.pt"))
    with open(os.path.join(d, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    write_config(d, dict(
        model="CTTransformer", model_conf=PUNC_MODEL_CONF, encoder="SANMEncoder",
        encoder_conf=PUNC_ENC, tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


def long_recording(rng, seconds=REQUEST_SECONDS, fs=16000):
    """Synthetic long-form speech (the idea of tests/pipeline_parity_util.py's
    multi_segment_wav at request length): 3-14 s bursts of noise or amplitude-modulated
    tones, 1-3 s of near silence (a 1e-6 noise floor) between them; float32 in [-1, 1)."""
    wav = (rng.standard_normal(int(seconds * fs)) * 1e-6).astype(np.float32)
    t0 = rng.uniform(0.3, 1.5)
    while t0 + 3.0 < seconds:
        i, j = int(t0 * fs), int(min(t0 + rng.uniform(3.0, 14.0), seconds - 0.5) * fs)
        tt = np.arange(j - i) / fs
        if rng.random() < 0.5:
            burst = 0.1 * rng.standard_normal(j - i)
        else:
            f0 = rng.uniform(120.0, 450.0)
            burst = 0.3 * np.sin(2 * np.pi * f0 * tt) * (1 + 0.4 * np.sin(2 * np.pi * 3 * tt))
        wav[i:j] += burst.astype(np.float32)
        t0 = j / fs + rng.uniform(1.0, 3.0)
    return wav


class Stage:
    """Wraps ``obj.attr`` (an instance attribute shadows the method, so its callers call
    the wrapper): per call, wall ms up to a synchronize and the kernel launches made
    inside it; with ``keep``, the results (the first item of what it returns)."""

    def __init__(self, obj, attr, counters, keep=False):
        self.counters, self.keep, self.inner = counters, keep, getattr(obj, attr)
        self.reset()
        setattr(obj, attr, self)

    def reset(self):
        self.calls, self.ms, self.results = 0, 0.0, []
        self.launches = {c.__name__: 0 for c in self.counters}

    def __call__(self, *args, **kwargs):
        before = {c.__name__: c.launches for c in self.counters}
        t0 = time.perf_counter()
        out = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.ms += (time.perf_counter() - t0) * 1e3
        self.calls += 1
        for c in self.counters:
            self.launches[c.__name__] += c.launches - before[c.__name__]
        if self.keep:
            self.results.extend(out[0])
        return out


def kernel_sites(model):
    """Launches of each kernel per forward of `model`: one flash per SAN-M self-attention,
    one FSMN per SAN-M attention, decoder FSMN block and VAD memory block."""
    from funasr_tpu_torch.models.fsmn_vad_streaming.encoder import FSMNBlock
    from funasr_tpu_torch.models.sanm.attention import (MultiHeadedAttentionSANM,
                                                        MultiHeadedAttentionSANMDecoder)

    def count(*kinds):
        return sum(isinstance(m, kinds) for m in model.modules())
    sites = {"fsmn_memory": count(MultiHeadedAttentionSANM, MultiHeadedAttentionSANMDecoder,
                                  FSMNBlock)}
    if count(MultiHeadedAttentionSANM):
        sites["flash_attention"] = count(MultiHeadedAttentionSANM)
    return sites


def forward_counter(module):
    """A list that grows by one per forward call of `module`."""
    calls = []
    module.register_forward_hook(lambda *_: calls.append(1))
    return calls


def phase_pipeline(dev, counters, card, keep=None):
    """AutoModel(model=asr, vad_model=vad, punc_model=punc, device="cuda"), the public
    default (fp32 everywhere), answering PIPELINE_REQUESTS requests of ~300 s, one
    ``generate`` each. Gates per request: one row with its key and text ending in
    sentence-final punctuation; >= MIN_SEGMENTS VAD segments, equal to the port's VAD
    on the CPU to the ms; the first 3 punctuation windows' logits within PUNC_LOGIT_TOL
    of the CPU port's; launches per stage at least the model's kernel sites times its
    calls (``kernel_sites``; FSMN 4 per VAD encoder call, 66 per ASR batch, 4 per
    punctuation window; flash 50 per ASR batch, 4 per window).
    Returns the launches per request of each stage. ``keep``: see ``keep_dirs``."""
    import tempfile
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.frontends import wav_frontend
    from funasr_tpu_torch.models.ct_transformer.utils import split_to_mini_sentence, split_words

    rng = np.random.default_rng(5)
    requests = [long_recording(rng) for _ in range(PIPELINE_REQUESTS)]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dirs = write_pipeline_dirs(root, dev)
        keep_dirs(keep, dirs, {"asr": "asr", "vad": "vad", "punc": "punc"})
        log(f"pipeline: model dirs written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        am = AutoModel(model=dirs["asr"], vad_model=dirs["vad"], punc_model=dirs["punc"],
                       device="cuda", log_level="WARNING")
        log(f"pipeline: AutoModel(model, vad_model, punc_model, device='cuda') built in "
            f"{time.perf_counter() - t0:.1f} s")
    dtypes = {name: next(m.parameters()).dtype for name, m in
              (("asr", am.model), ("vad", am.vad_model), ("punc", am.punc_model))}
    if set(dtypes.values()) != {torch.float32}:
        raise AssertionError(f"the default pipeline is not fp32: {dtypes}")
    # kernel launches per VAD encoder call, ASR batch and punctuation window: 4 FSMN;
    # 50 flash + 66 FSMN (PROD_CONF); 4 flash + 4 FSMN
    sites = {"vad": kernel_sites(am.vad_model), "asr": kernel_sites(am.model),
             "punc": kernel_sites(am.punc_model)}
    log(f"pipeline: kernel launches per VAD encoder call / ASR batch / punctuation window: "
        f"{sites}")
    cpu_vad = copy.deepcopy(am.vad_model).cpu()
    cpu_punc = copy.deepcopy(am.punc_model).cpu()
    stages = {"vad": Stage(am.vad_model, "inference", counters, keep=True),
              "asr": Stage(am.model, "inference", counters),
              "punc": Stage(am.punc_model, "inference", counters),
              # inside the VAD: the fbank (on the card) + LFR / CMVN (host), and the
              # encoder on the card with the scores' copy to the host; inside the
              # punctuation stage: each window's forward and its logits' copy
              "vad_fbank": Stage(am.vad_kwargs["frontend"], "forward_streaming", counters),
              "vad_fbank_only": Stage(wav_frontend, "fbank", counters),
              "vad_scores": Stage(am.vad_model, "silence_scores", counters),
              "punc_windows": Stage(am.punc_model, "window_logits", counters)}
    vad_calls = forward_counter(am.vad_model.encoder)
    windows = forward_counter(am.punc_model.encoder)
    am.generate(input=[requests[0][:16000 * 60]], key=["warm-up"])  # outside the counts
    torch.cuda.synchronize()

    per_request = []
    for r, wav in enumerate(requests):
        for st in stages.values():
            st.reset()
        vad_calls.clear()
        windows.clear()
        key = f"request_{r}"
        t0 = time.perf_counter()
        rows = am.generate(input=[wav], key=[key], return_raw_text=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        audio_s = len(wav) / 16000
        segments = stages["vad"].results[0]["value"]
        stats = dict(wall_ms=wall * 1e3, rtfx=audio_s / wall, segments=len(segments),
                     vad_calls=len(vad_calls), asr_batches=stages["asr"].calls,
                     windows=len(windows),
                     **{f"{name}_ms": st.ms for name, st in stages.items()},
                     **{f"{name}_launches": st.launches for name, st in stages.items()})
        per_request.append(stats)
        log(f"pipeline {key}: {audio_s:.1f} s of audio, wall {stats['wall_ms']:.2f} ms, "
            f"RTFx {stats['rtfx']:.1f}; stages: VAD {stats['vad_ms']:.2f} ms "
            f"({stats['vad_calls']} encoder calls, {len(segments)} segments), ASR "
            f"{stats['asr_ms']:.2f} ms ({stats['asr_batches']} batches), punctuation "
            f"{stats['punc_ms']:.2f} ms ({stats['windows']} windows); launches "
            f"VAD {stats['vad_launches']} ASR {stats['asr_launches']} "
            f"punc {stats['punc_launches']}; text {len(rows[0]['text'])} chars on {card}")
        log(f"  inside the stages: VAD fbank + LFR {stats['vad_fbank_ms']:.2f} ms (the fbank "
            f"on the card and back {stats['vad_fbank_only_ms']:.2f}), VAD "
            f"encoder + scores to the host {stats['vad_scores_ms']:.2f} ms, VAD host rest "
            f"(decibel loop, state machine) "
            f"{stats['vad_ms'] - stats['vad_fbank_ms'] - stats['vad_scores_ms']:.2f} ms; "
            f"punctuation window forwards + logits to the host {stats['punc_windows_ms']:.2f}"
            f" ms, host rest {stats['punc_ms'] - stats['punc_windows_ms']:.2f} ms")

        if len(rows) != 1 or rows[0]["key"] != key:
            raise AssertionError(f"{key}: expected one row with its key, got {rows}")
        text = rows[0]["text"]
        if not (isinstance(text, str) and text and text[-1] in "。？.?"):
            raise AssertionError(f"{key}: text {text[-20:]!r} does not end a sentence")
        if len(segments) < MIN_SEGMENTS:
            raise AssertionError(f"{key}: {len(segments)} VAD segments < {MIN_SEGMENTS}")
        cpu_segments = am.inference([wav], model=cpu_vad, kwargs=am.vad_kwargs)[0]["value"]
        if cpu_segments != segments:
            raise AssertionError(f"{key}: VAD segments on CUDA differ from the CPU port's: "
                                 f"{segments} vs {cpu_segments}")
        tok = am.punc_kwargs["tokenizer"]
        ids = [tok.token2id.get(w, tok.unk_id) for w in split_words(rows[0]["raw_text"])]
        err = max(np.abs(am.punc_model.window_logits(np.asarray(w, np.int32))
                         - cpu_punc.window_logits(np.asarray(w, np.int32))).max()
                  for w in split_to_mini_sentence(ids, 20)[:3])
        log(f"  VAD segments equal to the CPU port's ({len(segments)}); punctuation logits "
            f"of the first 3 windows: max_abs_err {err:.3e} (tol {PUNC_LOGIT_TOL:g})")
        if not err <= PUNC_LOGIT_TOL:
            raise AssertionError(f"{key}: punctuation logits on CUDA differ by {err}")
        need = {(stage, kernel): n * calls for stage, calls in
                (("vad", stats["vad_calls"]), ("asr", stats["asr_batches"]),
                 ("punc", stats["windows"])) for kernel, n in sites[stage].items()}
        short = {k: (stats[f"{k[0]}_launches"][k[1]], n) for k, n in need.items()
                 if stats[f"{k[0]}_launches"][k[1]] < n or n == 0}
        if short:
            raise AssertionError(f"{key}: a stage bypassed a kernel (launches, needed): "
                                 f"{short}")

    walls = [s["wall_ms"] for s in per_request]
    total_audio = sum(len(w) for w in requests) / 16000
    log(f"pipeline: {PIPELINE_REQUESTS} requests, {total_audio:.1f} s of audio, RTFx "
        f"{[round(s['rtfx'], 1) for s in per_request]} (all {total_audio * 1e3 / sum(walls):.1f}); "
        f"stage wall ms, mean per request: " + ", ".join(
            f"{name} {statistics.mean(s[f'{name}_ms'] for s in per_request):.2f}"
            for name in stages) + f" on {card}")
    profile_once(lambda: am.generate(input=[requests[0]], key=["profiled"]),
                 "pipeline request 0 (VAD + ASR + punctuation)", walls[0])
    return per_request


# ---- phase 9: speaker-attributed transcription ------------------------------------------

# the published timestamp head of speech_paraformer-large-vad-punc_asr_nat-zh-cn-16k-
# common-vocab8404 (CifPredictorV3: upsample 3 by a transposed conv, then a BLSTM)
BICIF_PREDICTOR = dict(PROD_CONF["predictor_conf"], smooth_factor2=0.25, noise_threshold2=0.01,
                       upsample_times=3, use_cif1_cnn=False, upsample_type="cnn_blstm")
# speech_campplus_sv_zh-cn_16k-common: the CAMPPlus defaults (feat 80, embedding 192,
# growth 32, bn_size 4, init 128, blocks 12 / 24 / 16)
SPK_CONF = dict(feat_dim=80, embedding_size=192, growth_rate=32, bn_size=4, init_channels=128)
SPEAKER_REQUESTS = 1  # cut from 2, for the run's time limit beside phase 13
SPEAKER_SECONDS = 60.0   # the meeting's length (cut from 300 s to 90 s, for the run's time
#                          limit beside phase 17: the CPU port re-runs it whole; to 60 s
#                          beside phase 18)
SPEAKER_PROFILE_SECONDS = 30  # the profiled request: request 0's first 30 s (cut from 60 s,
#                               for the run's time limit beside phase 14)
US_ALPHAS_TOL = 1e-4      # fp32 upsampled alphas, CUDA against the CPU (cuDNN LSTM, cuBLAS)
US_FIRES_MIN_SHARE = 0.99  # fires of running sums within rounding of an integer may move
SPK_EMB_REL_TOL = 1e-3    # CAM++ embeddings, per chunk, relative L2 (cuDNN conv sum order)
BOUNDARY_MIN_SHARE = 0.99  # token boundaries equal to the ms, on segments whose ids agree
BOUNDARY_MAX_MS = 20       # one upsampled frame: 60 ms / 3
MIN_VOICE_AGREEMENT = 0.9  # chunk labels (2 speakers) against the voice that spoke there
# every request's call: a fixed 800 ms end silence (the VAD config's own figure). Without
# it the VAD's dynamic schedule ends a segment at any silence once it has been in speech
# for a 60 s chunk, and the voices' syllable gaps would cut a turn into ~1 s segments.
SPEAKER_CALL = dict(batch_size_s=300, preset_spk_num=2, max_end_silence_time=800)


def write_bicif_dir(d, dev):
    write_model_dir(d, dev, model_name="BiCifParaformer", predictor="CifPredictorV3",
                    predictor_conf=BICIF_PREDICTOR)


def seed_batchnorm(model, seed):
    """Every batch norm's running statistics and affine parameters drawn from a numpy
    seed (tests/torch_parity_util.py::seed_batchnorm)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
                if m.affine:
                    m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, n).astype(np.float32)))
                    m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
    return model


def write_spk_dir(d):
    """cam++ as FunASR lays it out (its config names a WavFrontend, which CAM++ does not
    use), seeded conv weights and batch-norm statistics."""
    from funasr_tpu_torch import tables

    os.makedirs(d)
    model = seed_batchnorm(tables.model_classes["CAMPPlus"](
        **SPK_CONF, generator=torch.Generator().manual_seed(3)), 3)
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    write_config(d, dict(
        model="CAMPPlus", model_conf=dict(SPK_CONF, config_str="batchnorm-relu",
                                          memory_efficient=False, output_level="segment"),
        frontend="WavFrontend", frontend_conf=dict(fs=16000, window="hamming", n_mels=80,
                                                   frame_length=25, frame_shift=10, lfr_m=1,
                                                   lfr_n=1, dither=0.0)))


def voice_burst(rng, voice, n, fs=16000):
    """Voice A (0): 100-200 Hz harmonic tones with a 3 Hz AM in 2 Hz syllables (75 %
    voiced); voice B (1): 2-4 kHz band-limited noise bursts at 8 Hz (35 % on)
    (tests/torch_parity_util.py::voice_burst). The short silences inside each voice make
    a segment's first chunk, which starts in silence, look like the rest of its voice to a
    CAM++ with random weights."""
    tt = np.arange(n) / fs
    rate, duty = (2.0, 0.75) if voice == 0 else (8.0, 0.35)
    gate = ((tt * rate + rng.uniform()) % 1.0) < duty
    if voice == 0:
        f0 = rng.uniform(100.0, 200.0)
        tone = sum(np.sin(2 * np.pi * f0 * h * tt) / h for h in range(1, 12))
        return (0.12 * tone * (1 + 0.5 * np.sin(2 * np.pi * 3 * tt)) * gate).astype(np.float32)
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    spec[(freqs < 2000.0) | (freqs > 4000.0)] = 0.0
    noise = np.fft.irfft(spec, n)
    return (0.3 * noise / (np.abs(noise).max() + 1e-9) * gate).astype(np.float32)


def two_voice_recording(rng, seconds=REQUEST_SECONDS, fs=16000):
    """A meeting of two synthetic voices taking turns of 3-14 s with 1-3 s of near
    silence (a 1e-6 noise floor) between them; (float32 waveform, [(start s, end s,
    voice)])."""
    wav = (rng.standard_normal(int(seconds * fs)) * 1e-6).astype(np.float32)
    turns, t0, voice = [], rng.uniform(0.3, 1.5), 0
    while t0 + 3.0 < seconds:
        t1 = min(t0 + rng.uniform(3.0, 14.0), seconds - 0.5)
        i, j = int(t0 * fs), int(t1 * fs)
        wav[i:j] += voice_burst(rng, voice, j - i, fs)
        turns.append((t0, t1, voice))
        t0, voice = t1 + rng.uniform(1.0, 3.0), 1 - voice
    return wav, turns


def chunk_voices(chunks, turns):
    """The voice that overlaps each [start s, end s, samples] chunk most."""
    def overlap(c, t):
        return max(min(c[1], t[1]) - max(c[0], t[0]), 0.0)
    return np.asarray([max(turns, key=lambda t: overlap(c, t))[2] for c in chunks])


class Span:
    """CUDA events and a ``torch.profiler`` range named `label` around every call of
    ``obj.attr`` (an instance attribute shadows the method; a module's global is
    replaced): ``take`` gives (device span ms, calls); under a profiler the range's
    ``device_time_total`` is the device time of the kernels launched inside it."""

    def __init__(self, obj, attr, label):
        self.obj, self.attr, self.own, self.label = obj, attr, attr in vars(obj), label
        self.inner, self.pairs = getattr(obj, attr), []
        setattr(obj, attr, self)

    def __call__(self, *args, **kwargs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        with torch.profiler.record_function(self.label):
            out = self.inner(*args, **kwargs)
        e1.record()
        self.pairs.append((e0, e1))
        return out

    def take(self):
        torch.cuda.synchronize()
        ms, n, self.pairs = sum(a.elapsed_time(b) for a, b in self.pairs), len(self.pairs), []
        return ms, n

    def remove(self):
        if self.own:
            setattr(self.obj, self.attr, self.inner)
        else:
            delattr(self.obj, self.attr)


class Recorder:
    """Wraps ``obj.attr`` and keeps (args, kwargs), what it returned and its wall ms of
    every call, appended together when the call returns (under a lock), so that the calls
    of executor threads stay paired with their results."""

    def __init__(self, obj, attr):
        import threading
        self.inner, self.calls, self.outputs, self.ms = getattr(obj, attr), [], [], []
        self.lock = threading.Lock()
        setattr(obj, attr, self)

    def __call__(self, *args, **kwargs):
        call, t0 = (args, dict(kwargs)), time.perf_counter()
        out = self.inner(*args, **kwargs)
        with self.lock:
            self.calls.append(call)
            self.outputs.append(out)
            self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def log(self):
        """[(kwargs, result, ms)] of every call, in the order they returned."""
        return [(kw, out, ms) for (_, kw), out, ms in zip(self.calls, self.outputs, self.ms)]


def sync_points(fn):
    """The Python lines of `fn` that make the host wait for the device
    (``torch.cuda.set_sync_debug_mode``), with their counts."""
    import collections
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught)


def campplus_alone(model, dev, card):
    """CAM++ forwards on 1.5 s chunks' features (148 frames) at B = 1, 11 (a segment's
    chunks) and 64: the wall of one lone forward, the device's kernel time and launches a
    forward (torch.profiler over 3 forwards), and the calls that synchronise the host
    with the device."""
    x = torch.randn(64, 148, 80, generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.inference_mode():
        for b in (1, 11, 64):
            def forward():
                model(x[:b])
            lone, _ = wall_ms(forward, runs=5)
            by_name = profile_kernels(forward, calls=3)
            busy = sum(t for t, _ in by_name.values()) / 3
            launches = sum(n for _, n in by_name.values()) / 3
            syncs = sync_points(forward)
            log(f"speaker: CAM++ alone at B = {b}: lone forward wall {lone:.3f} ms, device "
                f"kernel time {busy:.3f} ms a forward over {launches:.0f} launches "
                f"({lone * 1e3 / launches:.1f} us of wall each); host waits for the device "
                f"{sum(syncs.values())} times a forward {dict(syncs.most_common(4))} on {card}")


def segment_boundaries(results):
    """Per ASR segment result: (text, token boundaries in ms)."""
    return [(r["text"], [b for ts in r.get("timestamp", []) for b in ts]) for r in results]


def phase_speaker(dev, counters, card, keep=None):
    """AutoModel(model=bicif, vad_model=vad, punc_model=punc, spk_model=cam++,
    device="cuda") at the fp32 default: a BiCif Paraformer-large (PROD_CONF with the
    published CifPredictorV3 head), phase 8's fsmn-vad and ct-punc-c, CAM++ at
    speech_campplus_sv's widths, all seeded; SPEAKER_REQUESTS meetings of SPEAKER_SECONDS of
    two synthetic voices, one ``generate(**SPEAKER_CALL)`` each (``batch_size_s=300,
    preset_spk_num=2``, a fixed 800 ms end silence). Gates
    (raised errors): every request's ``sentence_info`` has an int ``spk`` on every
    sentence and timestamps rising inside the meeting; each stage's kernel launches at
    their sites; the timestamp head on the card against the CPU port on request 0's first
    ASR batch (``us_alphas`` within US_ALPHAS_TOL, fires equal on US_FIRES_MIN_SHARE);
    CAM++ embeddings of request 0's chunks against the CPU port (SPK_EMB_REL_TOL per
    chunk); request 0 whole through the CPU port: VAD segments equal to the ms, token
    boundaries on segments whose ids agree (BOUNDARY_MIN_SHARE equal, all within
    BOUNDARY_MAX_MS), the voices separate on the CPU port's embeddings
    (MIN_VOICE_AGREEMENT), and the card's cluster labels equal the CPU port's. Prints
    RTFx and the stage split per request, the speaker stage at ``spk_kwargs`` batch 64,
    and one profiled request. Returns the launches per request of each stage. ``keep``: see
    ``keep_dirs``."""
    import tempfile
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.models.campplus import utils as spk_utils

    rng = np.random.default_rng(9)
    requests = [two_voice_recording(rng, SPEAKER_SECONDS) for _ in range(SPEAKER_REQUESTS)]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dirs = write_pipeline_dirs(root, dev, asr_writer=write_bicif_dir)
        dirs["spk"] = os.path.join(root, "spk")
        write_spk_dir(dirs["spk"])
        keep_dirs(keep, dirs, {"spk": "spk"})
        log(f"speaker: model dirs written in {time.perf_counter() - t0:.1f} s")
        kw = dict(model=dirs["asr"], vad_model=dirs["vad"], punc_model=dirs["punc"],
                  spk_model=dirs["spk"], log_level="WARNING")
        t0 = time.perf_counter()
        am = AutoModel(**kw, device="cuda")
        log(f"speaker: AutoModel(model, vad_model, punc_model, spk_model, device='cuda') "
            f"built in {time.perf_counter() - t0:.1f} s")
        cpu_am = AutoModel(**kw, device="cpu")
    models = {"asr": am.model, "vad": am.vad_model, "punc": am.punc_model, "spk": am.spk_model}
    dtypes = {name: next(m.parameters()).dtype for name, m in models.items()}
    if set(dtypes.values()) != {torch.float32} or type(am.model).__name__ != "BiCifParaformer":
        raise AssertionError(f"the speaker path is not the fp32 BiCif default: {dtypes}")
    sites = {"vad": kernel_sites(am.vad_model), "asr": kernel_sites(am.model),
             "punc": kernel_sites(am.punc_model)}
    log(f"speaker: CAM++ {sum(p.numel() for p in am.spk_model.parameters()) / 1e6:.2f}M "
        f"params; kernel launches per VAD encoder call / ASR batch / punctuation window: "
        f"{sites}")

    backend = am.cb_model
    # what the pipeline clustered: the chunk embeddings (chronological) and the chunks
    clustered = Recorder(am, "cb_model")
    assembled = Recorder(am, "_speaker_sentences")
    stages = {"vad": Stage(am.vad_model, "inference", counters, keep=True),
              "asr": Stage(am.model, "inference", counters, keep=True),
              "punc": Stage(am.punc_model, "inference", counters),
              "speaker": Stage(am, "_speaker_embeddings", counters),
              "sv_chunk": Stage(spk_utils, "sv_chunk", counters),
              "campplus": Stage(am.spk_model, "inference", counters),
              "clustering": Stage(am, "cb_model", counters),
              "sentences": Stage(am, "_speaker_sentences", counters)}
    cpu_stages = {"vad": Stage(cpu_am.vad_model, "inference", (), keep=True),
                  "asr": Stage(cpu_am.model, "inference", (), keep=True)}
    blstm = Span(am.model.predictor.blstm, "forward", "BLSTM")
    campplus = Span(am.spk_model, "forward", "CAM++")
    head = Recorder(am.model.predictor, "get_upsample_timestamp")
    vad_calls = forward_counter(am.vad_model.encoder)
    windows = forward_counter(am.punc_model.encoder)
    am.generate(input=[requests[0][0][:16000 * 60]], key=["warm-up"], **SPEAKER_CALL)
    torch.cuda.synchronize()
    blstm.take()
    campplus.take()

    per_request, first = [], None
    for r, (wav, turns) in enumerate(requests):
        for st in stages.values():
            st.reset()
        vad_calls.clear()
        windows.clear()
        for rec in (head, clustered, assembled):
            rec.calls.clear()
        key = f"meeting_{r}"
        t0 = time.perf_counter()
        rows = am.generate(input=[wav], key=[key], **SPEAKER_CALL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        blstm_ms, blstm_n = blstm.take()
        cam_ms, cam_n = campplus.take()
        stats = dict(wall_ms=wall * 1e3, rtfx=len(wav) / 16000 / wall,
                     segments=len(stages["vad"].results[0]["value"]),
                     vad_calls=len(vad_calls), asr_batches=stages["asr"].calls,
                     windows=len(windows), blstm_ms=blstm_ms, blstm_calls=blstm_n,
                     campplus_device_ms=cam_ms, campplus_forwards=cam_n,
                     **{f"{name}_ms": st.ms for name, st in stages.items()},
                     **{f"{name}_launches": st.launches for name, st in stages.items()})
        per_request.append(stats)
        row = rows[0] if rows else {}
        info = row.get("sentence_info", [])
        log(f"speaker {key}: {len(wav) / 16000:.1f} s, wall {stats['wall_ms']:.2f} ms, RTFx "
            f"{stats['rtfx']:.1f}; {stats['segments']} segments, {stats['asr_batches']} ASR "
            f"batches, {cam_n} CAM++ forwards, {len(info)} sentences, speakers "
            f"{sorted({s.get('spk') for s in info}, key=str)} on {card}")
        log(f"  stages (wall ms): VAD {stats['vad_ms']:.2f} / ASR {stats['asr_ms']:.2f} "
            f"(BLSTM event span {blstm_ms:.2f} over {blstm_n} calls) / speaker "
            f"{stats['speaker_ms']:.2f} (sv_chunk {stats['sv_chunk_ms']:.2f}, CAM++ "
            f"{cam_n} forwards: event span {cam_ms:.2f}, wall {stats['campplus_ms']:.2f}) / "
            f"clustering {stats['clustering_ms']:.2f} / punctuation {stats['punc_ms']:.2f} / "
            f"assembly {stats['sentences_ms'] - stats['clustering_ms']:.2f}")

        if len(rows) != 1 or row.get("key") != key or not info:
            raise AssertionError(f"{key}: expected one row with sentence_info, got {rows}")
        if not all(isinstance(s.get("spk"), int) for s in info):
            raise AssertionError(f"{key}: a sentence without an integer speaker")
        bounds = [b for ts in row["timestamp"] for b in ts]
        starts = [s["start"] for s in info]
        if not (bounds == sorted(bounds) and starts == sorted(starts) and bounds
                and 0 <= bounds[0] and bounds[-1] <= SPEAKER_SECONDS * 1e3):
            raise AssertionError(f"{key}: timestamps do not rise inside the meeting")
        need = {(stage, kernel): n * calls for stage, calls in
                (("vad", stats["vad_calls"]), ("asr", stats["asr_batches"]),
                 ("punc", stats["windows"])) for kernel, n in sites[stage].items()}
        short = {k: (stats[f"{k[0]}_launches"][k[1]], n) for k, n in need.items()
                 if stats[f"{k[0]}_launches"][k[1]] < n or n == 0}
        if short:
            raise AssertionError(f"{key}: a stage bypassed a kernel (launches, needed): "
                                 f"{short}")
        if r == 0:
            first = dict(row=row, head=head.calls[0], emb=clustered.calls[0][0][0],
                         chunks=sorted(assembled.calls[0][0][1], key=lambda c: c[0]),
                         segments=stages["vad"].results[0]["value"],
                         asr=segment_boundaries(stages["asr"].results))

    walls = [s["wall_ms"] for s in per_request]
    total_audio = sum(len(w) for w, _ in requests) / 16000
    log(f"speaker: {SPEAKER_REQUESTS} requests, {total_audio:.1f} s of audio, RTFx "
        f"{[round(s['rtfx'], 1) for s in per_request]} (all {total_audio * 1e3 / sum(walls):.1f})"
        f"; stage wall ms, mean per request: " + ", ".join(
            f"{name} {statistics.mean(s[f'{name}_ms'] for s in per_request):.2f}"
            for name in stages) + f"; event spans: BLSTM "
        f"{statistics.mean(s['blstm_ms'] for s in per_request):.2f}, CAM++ "
        f"{statistics.mean(s['campplus_device_ms'] for s in per_request):.2f} on {card}")

    # the timestamp head, CUDA against the CPU port, on request 0's first ASR batch
    (hidden, mask), token_num = first["head"][0], first["head"][1]["token_num"]
    with torch.inference_mode():  # the CPU port's AutoModel holds the same weights
        card_out = head.inner(hidden, mask, token_num=token_num)
        cpu_out = cpu_am.model.predictor.get_upsample_timestamp(
            hidden.cpu(), mask.cpu(), token_num=token_num.cpu())
    err = (card_out[2].cpu() - cpu_out[2]).abs().max().item()
    fires = [set(zip(*np.nonzero(x.cpu().numpy() >= 1 - 1e-4))) for x in (card_out[3], cpu_out[3])]
    share = len(fires[0] & fires[1]) / max(len(fires[0] | fires[1]), 1)
    log(f"speaker: timestamp head {tuple(hidden.shape)} CUDA vs CPU: us_alphas max_abs_err "
        f"{err:.3e} (tol {US_ALPHAS_TOL:g}), fires equal {share:.4f} of {len(fires[1])} "
        f"(min {US_FIRES_MIN_SHARE})")
    if not (err <= US_ALPHAS_TOL and share >= US_FIRES_MIN_SHARE):
        raise AssertionError("the timestamp head on CUDA disagrees with the CPU port")

    # request 0 whole through the CPU port
    wav, turns = requests[0]
    t0 = time.perf_counter()
    cpu_rows = cpu_am.generate(input=[wav], key=["meeting_0"], **SPEAKER_CALL)
    log(f"speaker: request 0 through the CPU port in {time.perf_counter() - t0:.1f} s")
    cpu_segments = cpu_stages["vad"].results[0]["value"]
    if cpu_segments != first["segments"]:
        raise AssertionError(f"VAD segments on CUDA differ from the CPU port's: "
                             f"{first['segments']} vs {cpu_segments}")
    cpu_asr = segment_boundaries(cpu_stages["asr"].results)
    agree = token_agreement([t for t, _ in first["asr"]], [t for t, _ in cpu_asr])
    same = [(a, b) for (ta, a), (tb, b) in zip(first["asr"], cpu_asr) if ta == tb]
    diffs = np.abs(np.concatenate([np.subtract(a, b) for a, b in same])) if same else np.zeros(0)
    equal_share = float((diffs == 0).mean()) if len(diffs) else 0.0
    log(f"speaker: request 0 CUDA vs CPU: token agreement {agree:.4f}; {len(same)} of "
        f"{len(cpu_asr)} segments with equal ids, token boundaries equal to the ms "
        f"{equal_share:.4f} (min {BOUNDARY_MIN_SHARE}), largest difference "
        f"{diffs.max() if len(diffs) else 0} ms (max {BOUNDARY_MAX_MS}); texts equal "
        f"{cpu_rows[0]['text'] == first['row']['text']}")
    if not same or equal_share < BOUNDARY_MIN_SHARE or diffs.max() > BOUNDARY_MAX_MS:
        raise AssertionError("token boundaries on CUDA differ from the CPU port's")

    # CAM++ over the chunks request 0 clustered (B = 1 on the card, as the pipeline ran
    # them), against the CPU port; the voices separate; the card's labels equal the CPU's
    chunks, card_emb = first["chunks"], first["emb"]
    cpu_emb = np.concatenate([cpu_am.spk_model.inference([c[2] for c in chunks[i:i + 64]])[0][0]
                              ["spk_embedding"] for i in range(0, len(chunks), 64)])
    rel = np.linalg.norm(card_emb - cpu_emb, axis=1) / np.linalg.norm(cpu_emb, axis=1)
    log(f"speaker: CAM++ embeddings of request 0's {len(chunks)} chunks, CUDA (B = 1) vs "
        f"CPU (B = 64): relative L2 max {rel.max():.3e} (tol {SPK_EMB_REL_TOL:g})")
    if len(card_emb) != len(chunks) or not rel.max() <= SPK_EMB_REL_TOL:
        raise AssertionError("CAM++ on CUDA disagrees with the CPU port")
    voices = chunk_voices(chunks, turns)
    labels = {}
    for name, emb in (("cpu", cpu_emb), ("card", card_emb)):
        np.random.seed(0)
        labels[name] = spk_utils.correct_labels(backend(emb, oracle_num=2))
    np.random.seed(0)
    found = backend(cpu_emb).max() + 1
    voice_share = max(float((labels["cpu"] == voices).mean()),
                      float((labels["cpu"] != voices).mean()))
    log(f"speaker: the CPU port's labels (2 speakers) match the voices on {voice_share:.4f} "
        f"of {len(chunks)} chunks (min {MIN_VOICE_AGREEMENT}); without preset_spk_num the "
        f"backend finds {found}; card labels equal the CPU port's: "
        f"{np.array_equal(labels['card'], labels['cpu'])}")
    if voice_share < MIN_VOICE_AGREEMENT:
        raise AssertionError("the two voices do not separate on the CPU port's embeddings")
    if not np.array_equal(labels["card"], labels["cpu"]):
        raise AssertionError("cluster labels from the card's embeddings differ from the CPU's")

    # the speaker stage at spk_kwargs batch_size 64 (every chunk is 1.5 s: same results)
    am.spk_kwargs["batch_size"] = 64
    for st in stages.values():
        st.reset()
    campplus.take()
    t0 = time.perf_counter()
    rows64 = am.generate(input=[wav], key=["meeting_0"], **SPEAKER_CALL)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    cam_ms, cam_n = campplus.take()
    emb64 = clustered.calls[-1][0][0]
    log(f"speaker: request 0 at spk_kwargs batch_size 64: embeddings against batch 1: "
        f"max_abs_err {np.abs(emb64 - card_emb).max():.3e}")
    log(f"speaker: request 0 at spk_kwargs batch_size 64: wall {wall:.2f} ms, RTFx "
        f"{len(wav) / 16 / wall:.1f}; speaker stage {stages['speaker'].ms:.2f} ms (was "
        f"{per_request[0]['speaker_ms']:.2f}), CAM++ {cam_n} forwards (one per ASR segment "
        f"at most), event span {cam_ms:.2f} ms, wall {stages['campplus'].ms:.2f}; "
        f"sentence_info equal to batch 1: "
        f"{rows64[0]['sentence_info'] == first['row']['sentence_info']}")
    am.spk_kwargs["batch_size"] = 1
    campplus_alone(am.spk_model, dev, card)
    # the profile takes request 0's first SPEAKER_PROFILE_SECONDS (cut from the whole meeting,
    # ~380,000 CAM++ launches at B = 1, for the run's time limit)
    clip = wav[:16000 * SPEAKER_PROFILE_SECONDS]
    clip_ms, _ = wall_ms(lambda: am.generate(input=[clip], key=["clip"], **SPEAKER_CALL), runs=1)
    profile_once(lambda: am.generate(input=[clip], key=["profiled"], **SPEAKER_CALL),
                 f"speaker request 0's first {SPEAKER_PROFILE_SECONDS} s (VAD + BiCif ASR + "
                 f"CAM++ + punctuation)", clip_ms)
    return per_request


# ---- phase 10: hotword transcription -----------------------------------------------------

# speech_seaco_paraformer_large_asr_nat-zh-cn-16k-common-vocab8404-pytorch: BiCif's
# CifPredictorV3 head, inner_dim 512 (the bias LSTM reads decoder.embed rows and the SeACo
# decoder's memory is the hotword matrix, so the shapes force it), the seaco_decoder_conf of
# that model card's config.yaml (att_layer_num left at its default of 6: 6 cross-attention
# layers + the FFN-only layer, no decoders2) and NO_BIAS 8377. The Contextual Paraformer
# (paraformer-zh-hotword): PROD_CONF's decoder widths, inner_dim 512 (its bias attention
# reads the memory through linear_k_v of width d).
SEACO_EXTRA = dict(inner_dim=512, NO_BIAS=8377, seaco_decoder="ParaformerSANMDecoder",
                   seaco_decoder_conf=dict(attention_heads=4, linear_units=1024, num_blocks=4,
                                           kernel_size=21, sanm_shfit=0, use_output_layer=False))
CONTEXTUAL_EXTRA = dict(inner_dim=512)
HOTWORD_COUNTS = (20, 200)  # N + 1 = 21 < nfilter 50: no filtering; 201: ASF keeps 51
HOTWORD_LOGP_TOL = 1e-3     # fp32 log-probs, CUDA against the CPU port (sum orders)
HOTWORD_REQUESTS = 1  # cut from 2, for the run's time limit beside phase 13
FSMN_K21 = ", 21, 10, 4>"   # the k = 21 instantiation's template arguments, demangled


def hotword_list(rng, n):
    """n hotwords of 2-6 tokens drawn from the 8400 CJK tokens, as one string."""
    return " ".join("".join(chr(0x4E00 + int(i)) for i in rng.integers(0, 8400, rng.integers(2, 7)))
                    for _ in range(n))


def write_seaco_dir(d, dev):
    write_model_dir(d, dev, model_name="SeacoParaformer", predictor="CifPredictorV3",
                    predictor_conf=BICIF_PREDICTOR, extra=SEACO_EXTRA)


def base_dir_of(seaco_dir, d):
    """A BiCifParaformer directory over the SeACo directory's model.pt (its extra tensors
    are dropped on load): the same base weights."""
    import yaml
    os.makedirs(d)
    for name in ("model.pt", "tokens.txt", "am.mvn"):
        os.symlink(os.path.join(seaco_dir, name), os.path.join(d, name))
    with open(os.path.join(seaco_dir, "config.yaml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg["model"] = "BiCifParaformer"
    for key in SEACO_EXTRA:
        cfg["model_conf"].pop(key)
    write_config(d, cfg)


def hotword_spans(model):
    """The decode's stages, each a Span: {label: Span}."""
    import funasr_tpu_torch.models.contextual_paraformer.model as ctx_mod
    import funasr_tpu_torch.models.seaco_paraformer.model as seaco_mod

    sites = {"encoder": (model, "encode"), "CIF": (model, "calc_predictor"),
             "main decoder": (model.decoder, "forward")}
    if hasattr(model, "seaco_decoder"):
        sites.update({"hotword LSTM": (seaco_mod, "encode_hotwords"),
                      "SeACo total": (model, "_seaco_decode_with_asf"),
                      "SeACo decoder": (model.seaco_decoder, "forward"),
                      "probe": (model.seaco_decoder, "forward_asf"),
                      "gate": (model, "no_bias_gate"),
                      "timestamp head": (model.predictor, "get_upsample_timestamp")})
    else:
        sites["hotword LSTM"] = (ctx_mod, "encode_hotwords")
    return {label: Span(obj, attr, label) for label, (obj, attr) in sites.items()}


def stage_device_ms(fn, labels):
    """Device kernel time (ms) inside each profiler range of `labels` (``Span``) over
    one call of `fn`, from torch.profiler with CPU and CUDA activity: each range's
    kernels and its children's, summed over its calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(labels, 0.0)
    for e in prof.events():
        if e.name in out and e.device_type == DeviceType.CPU:
            out[e.name] += e.device_time_total / 1e3
    return out


def k21_sites(model):
    """(a list that grows by one per forward of the SeACo decoder's FSMN blocks, each a
    launch of the FSMN kernel's k = 21 instantiation on the card; the hooks' handles)."""
    from funasr_tpu_torch.models.sanm.attention import MultiHeadedAttentionSANMDecoder
    calls = []
    handles = [m.register_forward_hook(lambda *_: calls.append(1))
               for m in getattr(model, "seaco_decoder", torch.nn.Module()).modules()
               if isinstance(m, MultiHeadedAttentionSANMDecoder)]
    return calls, handles


def hotword_run(am, batch, counters, card, label, **call):
    """One configuration of ``am.generate(input=batch, **call)``: a warm-up, one counted
    run (kernel launches, k = 21 FSMN launches, gate picks, event spans of each stage),
    one profiled with a range per stage (device kernel ms by stage; host ms of dispatch
    and fetch), 5 timed runs (wall median, RTFx), one profile (device time, the k = 21
    instantiation's launches). Returns (figures, the counted run's results)."""
    model = am.model
    k21, hooks = k21_sites(model)
    picks, lens = [], []
    gate = getattr(model, "no_bias_gate", None)
    if gate is not None:
        decode = model.cal_decoder_with_predictor
        model.cal_decoder_with_predictor = lambda *a: lens.append(a[3]) or decode(*a)
        model.no_bias_gate = lambda dec, dha, lmbd: picks.append(dha.argmax(-1)) or gate(dec, dha, lmbd)
    spans = hotword_spans(model)
    am.generate(input=batch, **call)  # warm-up, outside the counts
    for sp in spans.values():
        sp.take()
    k21.clear()
    picks.clear()
    lens.clear()
    for c in counters:
        c.launches = 0
    results = am.generate(input=batch, **call)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    k21_launches, gate_runs = len(k21), list(zip(picks, lens))
    split = {name: sp.take() for name, sp in spans.items()}
    host = {name: Stage(model, name, ()) for name in ("inference_dispatch", "inference_fetch")}
    staged = stage_device_ms(lambda: am.generate(input=batch, **call), spans)
    host = {name: st.ms for name, st in host.items()}
    for handle in (*hooks, *spans.values()):
        handle.remove()
    del model.inference_dispatch, model.inference_fetch
    if gate is not None:
        del model.no_bias_gate, model.cal_decoder_with_predictor
    head = no_bias = 0
    for ids, n in gate_runs:
        valid = torch.arange(ids.shape[1], device=ids.device)[None] < n[:, None]
        no_bias += int(((ids == model.NO_BIAS) & valid).sum())
        head += int(valid.sum())
    t_med, times = wall_ms(lambda: am.generate(input=batch, **call))
    by_name = profile_once(lambda: am.generate(input=batch, **call), label, t_med)
    k21_ms, k21_n = (sum(v[i] for name, v in by_name.items()
                         if "fsmn_kernel" in name and FSMN_K21 in name) for i in (0, 1))
    stats = dict(wall_ms=t_med, rtfx=len(batch) * 15e3 / t_med, launches=launches,
                 k21_launches=k21_launches, k21_profile=(k21_ms, k21_n), gate_head=head - no_bias,
                 gate_no_bias=no_bias, split=split, staged=staged, host=host,
                 device_ms=sum(t for t, _ in by_name.values()))
    log(f"hotword {label}: generate median {t_med:.2f} ms (runs {[round(x, 2) for x in times]}), "
        f"RTFx {stats['rtfx']:.1f}, device kernel time {stats['device_ms']:.2f} ms; launches "
        f"{launches}, FSMN k = 21 {k21_launches} (profile: {k21_n} launches of the k = 21 "
        f"instantiation, {k21_ms:.3f} ms); gate: {head - no_bias} tokens took the hotword "
        f"head, {no_bias} NO_BIAS, on {card}")
    log("  device kernel ms by stage (profiled decode; event span ms / calls of the counted "
        "one): " + ", ".join(f"{name} {staged[name]:.2f} ({ms:.2f} / {n})"
                             for name, (ms, n) in split.items()))
    log(f"  host (profiled decode, wall ms to a synchronize): dispatch (load, fbank, every "
        f"launch, waits) {host['inference_dispatch']:.2f}, fetch (copy, detokenize, "
        f"timestamps) {host['inference_fetch']:.2f}")
    return stats, results


def hotword_checks(label, model, stats, results, n, asf):
    """Gates of one hotword run: n non-empty texts; the encoder's and main decoder's kernel
    sites launched (``kernel_sites``: 50 flash and 66 FSMN at PROD_CONF) plus the SeACo
    decoder's FSMN blocks twice (three times under ASF: the probe), and those last on the
    k = 21 instantiation, counted and profiled (12 or 18 a decode at its 6 blocks)."""
    if len(results) != n or not all(isinstance(r["text"], str) and r["text"] for r in results):
        raise AssertionError(f"hotword {label}: expected {n} non-empty texts")
    seaco = getattr(model, "seaco_decoder", None)
    sites = kernel_sites(model)
    k21_sites_n = kernel_sites(seaco)["fsmn_memory"] if seaco is not None else 0
    k21_needed = k21_sites_n * (3 if asf else 2)
    launches = stats["launches"]
    if (launches["flash_attention"] < sites["flash_attention"]
            or launches["fsmn_memory"] < sites["fsmn_memory"] - k21_sites_n + k21_needed):
        raise AssertionError(f"hotword {label}: a kernel was bypassed: {launches}, sites {sites}")
    if stats["k21_launches"] != k21_needed or stats["k21_profile"][1] < k21_needed:
        raise AssertionError(f"hotword {label}: the k = 21 FSMN instantiation ran "
                             f"{stats['k21_launches']} / {stats['k21_profile'][1]} times, "
                             f"expected {k21_needed}")


def hotword_cuda_vs_cpu(am, cpu_am, waves, hotword):
    """The same model and 4 x 15 s on the card and on the CPU port (fp32) through
    ``model.inference``: the merged (or Contextual) log-probs of the decode within
    HOTWORD_LOGP_TOL on valid tokens of rows whose token counts agree, the ASF kept set
    equal, token flips, and the results (texts, ms timestamps) equal. Returns a dict."""
    out = {}
    for name, a in (("card", am), ("cpu", cpu_am)):
        model = a.model
        logp = Recorder(model, "cal_decoder_with_predictor")
        probe = (Recorder(model.seaco_decoder, "forward_asf")
                 if hasattr(model, "seaco_decoder") else None)
        with torch.inference_mode():
            results, _ = model.inference(waves, tokenizer=a.kwargs["tokenizer"],
                                         frontend=a.kwargs["frontend"], hotword=hotword)
        del model.cal_decoder_with_predictor
        kept = None
        if probe is not None:
            del model.seaco_decoder.forward_asf
            if probe.outputs:
                scores = probe.outputs[-1][0].sum(dim=(0, 1)).float().cpu().numpy()
                kept = set(np.argsort(-scores)[: min(50, len(scores) - 1)].tolist())
        out[name] = dict(results=results, logp=logp.outputs[-1][0].float().cpu(),
                         lens=logp.calls[-1][0][3].cpu(), kept=kept)
    card, cpu = out["card"], out["cpu"]
    b = len(waves)
    same = (card["lens"][:b] == cpu["lens"][:b]).tolist()
    err, flips, tokens = 0.0, 0, 0
    for i in range(b):
        n = int(cpu["lens"][i])
        if not same[i]:
            continue
        a_, b_ = card["logp"][i, :n], cpu["logp"][i, :n]
        err = max(err, (a_ - b_).abs().max().item())
        flips += int((a_.argmax(-1) != b_.argmax(-1)).sum())
        tokens += n
    pairs = list(zip(card["results"], cpu["results"]))
    same_text = [x for x, y in pairs if x["text"] == y["text"]]
    return dict(err=err, flips=flips, tokens=tokens, same_lens=same,
                kept_equal=card["kept"] == cpu["kept"], kept=card["kept"],
                rows_equal=[x == y for x, y in pairs], same_text=len(same_text),
                ts_equal=all(x.get("timestamp") == y.get("timestamp") for x, y in pairs
                             if x["text"] == y["text"]))


def phase_hotword(dev, counters, card):
    """Hotword transcription at PROD_CONF width, ``device="cuda"``, seeded weights and
    hotwords (words of 2-6 tokens of the 8,404-token list):
    - SeACo-Paraformer, 32 x 15 s through ``AutoModel(model=seaco).generate``: with no
      hotword (results equal, texts and ms timestamps, to a BiCifParaformer over the same
      base weights), with 20 hotwords (no filtering) and 200 (ASF: the probe and top 50),
      fp32 and ``bf16=True``; gates: 32 texts, >= 50 flash and >= 66 + 12 FSMN launches,
      the k = 21 instantiation 12 times a decode (18 under ASF), counted and profiled;
    - the Contextual Paraformer, 20 hotwords, fp32, the same figures;
    - CUDA against the CPU port, 4 x 15 s fp32: SeACo (200 hotwords) and Contextual (20)
      log-probs within HOTWORD_LOGP_TOL, the ASF kept set equal, results equal; token
      flips printed;
    - the pipeline with 20 hotwords: HOTWORD_REQUESTS requests of 300 s through
      ``AutoModel(model=seaco, vad_model=, punc_model=)`` (phase 8's VAD and punctuation):
      per request a row with its key, sentence-final text and rising timestamps, each
      stage's launches at its sites; RTFx and the stage split.
    Returns {label: figures} for the kernels line."""
    import tempfile
    from funasr_tpu_torch import AutoModel

    rng = np.random.default_rng(10)
    batch = [pcm(rng, 15.0) for _ in range(32)]
    keys = [f"utt_{i}" for i in range(32)]
    hotwords = {n: hotword_list(rng, n) for n in HOTWORD_COUNTS}
    small = batch[:4]
    figures = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dirs = write_pipeline_dirs(root, dev, asr_writer=write_seaco_dir)
        dirs["bicif"] = os.path.join(root, "bicif")
        base_dir_of(dirs["asr"], dirs["bicif"])
        dirs["ctx"] = os.path.join(root, "ctx")
        os.makedirs(dirs["ctx"])
        write_model_dir(dirs["ctx"], dev, model_name="ContextualParaformer",
                        decoder="ContextualParaformerDecoder", extra=CONTEXTUAL_EXTRA)
        log(f"hotword: model dirs written in {time.perf_counter() - t0:.1f} s")
        kw = dict(device="cuda", batch_size=32, log_level="WARNING")

        # SeACo, fp32: no hotword against BiCif over the same weights, then 20 and 200
        am = AutoModel(model=dirs["asr"], **kw)
        base = AutoModel(model=dirs["bicif"], **kw)
        n_params = sum(p.numel() for p in am.model.parameters()) / 1e6
        plain = am.generate(input=batch, key=keys)
        want = base.generate(input=batch, key=keys)
        log(f"hotword: SeACo {n_params:.1f}M params (fp32); no hotword against BiCif over the "
            f"same base weights: results equal {plain == want}")
        if plain != want or not all(r["timestamp"] for r in plain):
            raise AssertionError("SeACo without hotwords differs from BiCif")
        del base
        for n in HOTWORD_COUNTS:
            label = f"SeACo fp32, {n} hotwords"
            stats, results = hotword_run(am, batch, counters, card, label, key=keys,
                                         hotword=hotwords[n])
            hotword_checks(label, am.model, stats, results, 32, n + 1 > 50)
            if results == plain:
                raise AssertionError(f"{label}: the hotwords changed nothing")
            figures[("seaco", "fp32", n)] = stats
        cpu_am = AutoModel(model=dirs["asr"], device="cpu", log_level="WARNING")
        r = hotword_cuda_vs_cpu(am, cpu_am, small, hotwords[200])
        log(f"hotword: SeACo 4 x 15 s, 200 hotwords, CUDA vs CPU port (fp32): merged "
            f"log-probs max_abs_err {r['err']:.3e} (tol {HOTWORD_LOGP_TOL:g}) over "
            f"{r['tokens']} tokens, token counts equal {r['same_lens']}, flips {r['flips']}; "
            f"ASF kept set equal {r['kept_equal']} ({len(r['kept'] or ())} of 201); rows "
            f"equal (texts, ms timestamps) {r['rows_equal']}; ms timestamps equal on the "
            f"{r['same_text']} rows of equal text {r['ts_equal']}")
        if not (r["err"] <= HOTWORD_LOGP_TOL and r["kept_equal"] and r["kept"]
                and all(r["same_lens"]) and r["same_text"] and r["ts_equal"]):
            raise AssertionError("SeACo on CUDA disagrees with the CPU port")
        figures["seaco_cuda_vs_cpu"] = r
        del am, cpu_am

        # SeACo, bf16
        am = AutoModel(model=dirs["asr"], bf16=True, **kw)
        for n in HOTWORD_COUNTS:
            label = f"SeACo bf16, {n} hotwords"
            stats, results = hotword_run(am, batch, counters, card, label, key=keys,
                                         hotword=hotwords[n])
            hotword_checks(label, am.model, stats, results, 32, n + 1 > 50)
            figures[("seaco", "bf16", n)] = stats
        del am

        # Contextual, fp32
        am = AutoModel(model=dirs["ctx"], **kw)
        label = "Contextual fp32, 20 hotwords"
        stats, results = hotword_run(am, batch, counters, card, label, key=keys,
                                     hotword=hotwords[20])
        hotword_checks(label, am.model, stats, results, 32, False)
        figures[("contextual", "fp32", 20)] = stats
        cpu_am = AutoModel(model=dirs["ctx"], device="cpu", log_level="WARNING")
        r = hotword_cuda_vs_cpu(am, cpu_am, small, hotwords[20])
        log(f"hotword: Contextual 4 x 15 s, 20 hotwords, CUDA vs CPU port (fp32): log-probs "
            f"max_abs_err {r['err']:.3e} (tol {HOTWORD_LOGP_TOL:g}) over {r['tokens']} "
            f"tokens, token counts equal {r['same_lens']}, flips {r['flips']}; rows equal "
            f"{r['rows_equal']}")
        if not (r["err"] <= HOTWORD_LOGP_TOL and all(r["same_lens"])):
            raise AssertionError("the Contextual Paraformer on CUDA disagrees with the CPU port")
        del am, cpu_am

        # the pipeline with hotwords
        am = AutoModel(model=dirs["asr"], vad_model=dirs["vad"], punc_model=dirs["punc"],
                       device="cuda", log_level="WARNING")
    figures["pipeline"] = hotword_pipeline(am, counters, card, hotwords[20])
    return figures


def hotword_pipeline(am, counters, card, hotword):
    """HOTWORD_REQUESTS requests of 300 s, one ``generate(hotword=...)`` each."""
    rng = np.random.default_rng(11)
    requests = [long_recording(rng) for _ in range(HOTWORD_REQUESTS)]
    sites = {"vad": kernel_sites(am.vad_model), "asr": kernel_sites(am.model),
             "punc": kernel_sites(am.punc_model)}
    stages = {"vad": Stage(am.vad_model, "inference", counters),
              "asr": Stage(am.model, "inference", counters),
              "punc": Stage(am.punc_model, "inference", counters)}
    vad_calls = forward_counter(am.vad_model.encoder)
    windows = forward_counter(am.punc_model.encoder)
    am.generate(input=[requests[0][:16000 * 60]], key=["warm-up"], hotword=hotword)
    torch.cuda.synchronize()
    per_request = []
    for r, wav in enumerate(requests):
        for st in stages.values():
            st.reset()
        vad_calls.clear()
        windows.clear()
        key = f"hotword_request_{r}"
        t0 = time.perf_counter()
        rows = am.generate(input=[wav], key=[key], hotword=hotword)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = dict(wall_ms=wall * 1e3, rtfx=len(wav) / 16000 / wall, vad_calls=len(vad_calls),
                     asr_batches=stages["asr"].calls, windows=len(windows),
                     **{f"{name}_ms": st.ms for name, st in stages.items()},
                     **{f"{name}_launches": st.launches for name, st in stages.items()})
        per_request.append(stats)
        log(f"hotword pipeline {key}: {len(wav) / 16000:.1f} s, wall {stats['wall_ms']:.2f} ms, "
            f"RTFx {stats['rtfx']:.1f}; stages: VAD {stats['vad_ms']:.2f} ms "
            f"({stats['vad_calls']} encoder calls), ASR {stats['asr_ms']:.2f} ms "
            f"({stats['asr_batches']} batches), punctuation {stats['punc_ms']:.2f} ms "
            f"({stats['windows']} windows); launches VAD {stats['vad_launches']} ASR "
            f"{stats['asr_launches']} punc {stats['punc_launches']} on {card}")
        row = rows[0] if len(rows) == 1 else {}
        bounds = [b for ts in row.get("timestamp", []) for b in ts]
        if row.get("key") != key or not (row.get("text") and row["text"][-1] in "。？.?"):
            raise AssertionError(f"{key}: expected one row with a sentence-final text")
        if not (bounds and bounds == sorted(bounds) and bounds[-1] <= REQUEST_SECONDS * 1e3):
            raise AssertionError(f"{key}: timestamps do not rise inside the request")
        need = {(stage, kernel): n * calls for stage, calls in
                (("vad", stats["vad_calls"]), ("asr", stats["asr_batches"]),
                 ("punc", stats["windows"])) for kernel, n in sites[stage].items()}
        short = {k: (stats[f"{k[0]}_launches"][k[1]], n) for k, n in need.items()
                 if stats[f"{k[0]}_launches"][k[1]] < n or n == 0}
        if short:
            raise AssertionError(f"{key}: a stage bypassed a kernel (launches, needed): {short}")
    walls = [s["wall_ms"] for s in per_request]
    total = sum(len(w) for w in requests) / 16000
    log(f"hotword pipeline: {HOTWORD_REQUESTS} requests, {total:.1f} s of audio, RTFx "
        f"{[round(s['rtfx'], 1) for s in per_request]} (all {total * 1e3 / sum(walls):.1f}); "
        f"stage wall ms, mean per request: " + ", ".join(
            f"{name} {statistics.mean(s[f'{name}_ms'] for s in per_request):.2f}"
            for name in stages) + f" on {card}")
    return per_request


# ---- phase 11: streaming ------------------------------------------------------------------

# paraformer-zh-streaming's own parts at PROD_CONF width (tests/test_streaming_e2e.py:12-34):
# the chunk encoder (input_layer pe_online), the decoder's sanm_shfit 5, WavFrontendOnline
STREAM_ENCODER_CONF = dict(PROD_CONF["encoder_conf"], input_layer="pe_online")
STREAM_DECODER_CONF = dict(PROD_CONF["decoder_conf"], sanm_shfit=5)
STREAM_SMALL_CONF = dict(SMALL_CONF, encoder="SANMEncoderChunkOpt",
                         encoder_conf=dict(SMALL_CONF["encoder_conf"], input_layer="pe_online"),
                         decoder_conf=dict(SMALL_CONF["decoder_conf"], sanm_shfit=5))
# the demo's call (examples/industrial_data_pretraining/paraformer_streaming/demo.py:21-40)
STREAM_CALL = dict(chunk_size=[0, 10, 5], encoder_chunk_look_back=4, decoder_chunk_look_back=1)
STREAM_STRIDE = 9600       # samples a generate: 600 ms
STREAM_SECONDS = 12.0      # (cut from 30 s to 20 s for the run's time limit beside phase 17,
#                            to 12 s beside phase 18)
STREAMS = 2
STREAM_COLD = 5            # the first chunks of the first stream: the look-back fills
STREAM_CPU_CHUNKS = 10     # full-width chunks held against the CPU port
STREAM_CACHE_TOL = 1e-3    # fp32 caches, CUDA against the CPU: as CPU_GPU_ENC_TOL
STREAM_FLASH_KEYS = (15, 55, 1005)  # the first chunk, a full look-back of 4, look-back -1
STREAM_FSMN_ROWS = (25, 26)  # 10 cached + a chunk's 15 (16 when final) token rows
FSMN_K11 = ", 11, 5, "     # the encoder's FSMN instantiation, demangled
FSMN_STEP = ", 11, 10, "   # the streaming decoder's step (pads 10 / 0)
# the demo's pieces (examples/industrial_data_pretraining/ct_transformer_streaming/demo.py)
PUNC_DEMO = ("跨境河流是养育沿岸|人民的生命之源长期以来为帮助下游地区防灾减灾中方技术人员|"
             "在上游地区极为恶劣的自然条件下克服巨大困难甚至冒着生命危险|"
             "向印方提供汛期水文资料处理紧急事件中方重视印方在跨境河流>问题上的关切|"
             "愿意进一步完善双方联合工作机制|凡是|中方能做的我们|"
             "都会去做而且会做得更好我请印度朋友们放心中国在上游的|任何开发利用都会经过科学|"
             "规划和论证兼顾上下游的利益")


def streaming_kernel_rows(dev, g):
    """The kernels at the streaming shapes (phase 11), each against its plain version:
    flash with a key cache, (1, 4, 15, 128) queries over Tk = 15 / 55 / 1005 keys, fp32
    and bf16; flash with per-row key limits at the realtime punctuation encoder's (1, 8,
    64, 32), length 57: causal, and the VAD corner at vad_pos 0, 1, 30, 64 (timed at 30);
    the streaming decoder's FSMN step, k = 11 with pads (10, 0), no mask, at (1, 25, 512)
    and (1, 26, 512), also against the generic instantiation (``generic_ms``: the kernel
    before its (11, 10) instantiation), which it must equal. Raises on a disagreement."""
    from funasr_tpu_torch.ops.fsmn import fsmn_memory

    rows = {}
    for tk in STREAM_FLASH_KEYS:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(1, 15, 3, 4, 128, generator=g).to(dev, dtype)[:, :, 0].transpose(1, 2)
            kv = torch.randn(1, tk, 2, 4, 128, generator=g).to(dev, dtype)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
            rows[("flash_attention", "streaming", f"keys{tk}", dtype)] = flash_row(q, k, v, [tk])
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(1, 64, 3, 8, 32, generator=g).to(dev, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rows[("flash_attention", "streaming", "causal", dtype)] = flash_row(q, k, v, [57],
                                                                            "causal")
        for vp in (0, 1, 30, 64):
            rows[("flash_attention", "streaming", f"corner{vp}", dtype)] = flash_row(
                q, k, v, [57], "corner", [vp], timed=vp == 30)
    for t in STREAM_FSMN_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(1, t, 512, generator=g).to(dev, dtype)  # concat(cache, x)
            w = (torch.rand(512, 1, 11, generator=g) - 0.5).to(dev, dtype)
            row = fsmn_row(x, w, None, 10, 0)
            row["generic_equal"] = torch.equal(fsmn_memory(x, w, None, 10, 0, generic=True),
                                               fsmn_memory(x, w, None, 10, 0))
            row["generic_ms"] = device_ms(lambda: fsmn_memory(x, w, None, 10, 0, generic=True))
            rows[("fsmn_memory", "streaming", f"step{t}", dtype)] = row
    for key, row in rows.items():
        dtype = key[3]
        tol = (FLASH_TOL if key[0] == "flash_attention" else FSMN_TOL)[dtype]
        line = f"{key[0]} streaming {key[2]} {row['shape']} {str(dtype)[6:]}: max_abs_err " \
               f"{row['max_abs_err']:.3e} (tol {tol:g})"
        if "ms" in row:
            line += " " + timing_line(row)
        if "generic_ms" in row:
            line += (f"; generic instantiation {row['generic_ms']:.4f} ms, equal "
                     f"{row['generic_equal']}")
        log(line)
        if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= tol
                and row.get("generic_equal", True)):
            raise AssertionError(f"{key} kernel disagrees: {row['max_abs_err']}")
    return rows


def percentile(values, q):
    return float(np.percentile(np.asarray(values), q)) if values else float("nan")


class FsmnSplit:
    """Counts the SAN-M modules' FSMN kernel calls by (k, left pad): each is one launch of
    that instantiation on the card (the wrapper launches or raises). Wraps the module
    global that ``models/sanm/attention.py`` calls; ``remove`` restores it."""

    def __init__(self):
        from funasr_tpu_torch.models.sanm import attention
        self.module, self.inner = attention, attention.fsmn_memory
        self.counts = {}
        attention.fsmn_memory = self

    def __call__(self, x, weight, mask, left, right, **kwargs):
        key = (weight.shape[-1], left)
        self.counts[key] = self.counts.get(key, 0) + 1
        return self.inner(x, weight, mask, left, right, **kwargs)

    def remove(self):
        self.module.fsmn_memory = self.inner


def stream_calls(wav):
    """The demo's 600 ms pieces of `wav` (the last one is_final)."""
    return [wav[i:i + STREAM_STRIDE] for i in range(0, len(wav), STREAM_STRIDE)]


def run_stream(am, wav, profiled=None):
    """One stream through ``am.generate`` 600 ms a call, the caller's cache carried:
    (joined text, wall ms per call). With a dict ``profiled``, each call runs under a
    profile of its own and its {kernel name: (ms, launches)} is added into the dict."""
    cache, texts, walls = {}, [], []
    pieces = stream_calls(wav)
    for j, piece in enumerate(pieces):
        res = []

        def call():
            res.append(am.generate(input=piece, cache=cache, is_final=j == len(pieces) - 1,
                                   **STREAM_CALL))
        t0 = time.perf_counter()
        if profiled is None:
            call()
        else:
            for name, (ms, n) in profile_kernels(call).items():
                total_ms, total_n = profiled.get(name, (0.0, 0))
                profiled[name] = (total_ms + ms, total_n + n)
        walls.append((time.perf_counter() - t0) * 1e3)
        texts.append(res[0][0]["text"])
    return "".join(texts), walls


def streaming_asr(am, streams, counters, card, label, model_dir, bf16):
    """ParaformerStreaming through ``AutoModel.generate`` 600 ms a call (the demo loop):
    one whole-array call (is_final: it streams internally) as warm-up, then the counted
    streams. Gates: non-empty texts, the whole-array call's text equal to stream 0's;
    exactly 50 flash and 66 FSMN launches a chunk by count, 50 FSMN at (11, 5) and 16 at
    (11, 10) by call (``FsmnSplit``), no W8A8; one device-to-host copy a chunk
    (``sync_points``); the profile of stream 1, one per call, taken in a process of its
    own (``stream_profile``), showing those instantiations within one launch in a
    hundred. Prints per-chunk wall (cold / steady p50, p95), RTF,
    device ms a chunk and the idle share from one profiled stream, launches a chunk by
    kernel."""
    enc, dec = (PROD_CONF[f"{part}_conf"]["num_blocks"] for part in ("encoder", "decoder"))
    model = am.model
    inner, chunk_ms = model.generate_chunk, []

    def timed_chunk(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)  # ends in the chunk's one copy to the host
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    model.generate_chunk = timed_chunk
    split = FsmnSplit()
    try:
        whole = am.generate(input=streams[0], cache={}, is_final=True, **STREAM_CALL)
        for c in counters:
            c.launches = 0
        chunk_ms.clear()
        split.counts.clear()
        runs = [run_stream(am, wav) for wav in streams]
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        by_call = dict(split.counts)
        chunks, walls = len(chunk_ms), list(chunk_ms)
        chunk_ms.clear()
        syncs = sync_points(lambda: run_stream(am, streams[1]))
        sync_chunks = len(chunk_ms)
    finally:
        del model.generate_chunk
        split.remove()
    texts = [text for text, _ in runs]
    reset_ms = wall_ms(am._reset_runtime_configs, runs=5)[0]  # host work of every generate
    profiled = stream_profile_child(model_dir, bf16, label)
    by_name, prof_chunks = profiled["by_name"], profiled["chunks"]
    audio_s = sum(len(w) for w in streams) / 16000
    call_walls = [w for _, ws in runs for w in ws]
    stream1_wall = profiled["wall_ms"]
    device = sum(t for t, _ in by_name.values())
    per_chunk = {name: n / chunks for name, n in launches.items()}
    flash, k11, step = stream_profile_totals(by_name)
    all_launches = sum(n for _, n in by_name.values())
    cold, steady = walls[:STREAM_COLD], walls[STREAM_COLD:]
    stats = dict(chunks=chunks, launches=launches, launches_per_chunk=per_chunk,
                 fsmn_per_chunk={f"{k}_{left}": n / chunks for (k, left), n in by_call.items()},
                 cold_ms=cold, p50_ms=percentile(steady, 50), p95_ms=percentile(steady, 95),
                 call_p50_ms=percentile(call_walls, 50), call_p95_ms=percentile(call_walls, 95),
                 rtf=sum(call_walls) / 1e3 / audio_s,
                 device_ms_per_chunk=device / prof_chunks,
                 idle_share=1 - device / stream1_wall,
                 kernel_launches_per_chunk=all_launches / prof_chunks,
                 profile_per_chunk={"flash": flash[1] / prof_chunks,
                                    "fsmn_11_5": k11[1] / prof_chunks,
                                    "fsmn_11_10": step[1] / prof_chunks},
                 profile_ms_per_chunk={"flash": flash[0] / prof_chunks,
                                       "fsmn_11_5": k11[0] / prof_chunks,
                                       "fsmn_11_10": step[0] / prof_chunks},
                 d2h_per_chunk=sum(syncs.values()) / max(sync_chunks, 1), reset_ms=reset_ms,
                 sync_lines=dict(syncs))
    log(f"streaming {label}: {len(streams)} streams of {STREAM_SECONDS:.0f} s, {chunks} chunks "
        f"({len(call_walls)} generate calls); chunk wall (generate_chunk) cold "
        f"{[round(x, 2) for x in cold]} ms, steady p50 {stats['p50_ms']:.2f} p95 "
        f"{stats['p95_ms']:.2f} ms; generate call p50 {stats['call_p50_ms']:.2f} p95 "
        f"{stats['call_p95_ms']:.2f} ms (of it AutoModel's config reset, a deepcopy of its "
        f"build kwargs, {reset_ms:.2f} ms); RTF {stats['rtf']:.4f} on {card}")
    log(f"  launches a chunk (counters): {per_chunk}, FSMN by (k, left pad) "
        f"{stats['fsmn_per_chunk']}; by profile (stream 1, {prof_chunks} "
        f"chunks): every kernel {stats['kernel_launches_per_chunk']:.1f}, flash "
        f"{stats['profile_per_chunk']['flash']:.1f} ({stats['profile_ms_per_chunk']['flash']:.4f} "
        f"ms), FSMN (11, 5) {stats['profile_per_chunk']['fsmn_11_5']:.1f} "
        f"({stats['profile_ms_per_chunk']['fsmn_11_5']:.4f} ms), FSMN (11, 10) "
        f"{stats['profile_per_chunk']['fsmn_11_10']:.1f} "
        f"({stats['profile_ms_per_chunk']['fsmn_11_10']:.4f} ms); device kernel time "
        f"{stats['device_ms_per_chunk']:.3f} ms a chunk, idle share {stats['idle_share']:.1%} "
        f"(stream 1 unprofiled wall {stream1_wall:.1f} ms in the profile's process)")
    log(f"  host waits for the device: {stats['d2h_per_chunk']:.2f} a chunk over "
        f"{sync_chunks} chunks {dict(syncs.most_common(4))}; texts {[len(x) for x in texts]} "
        f"chars")
    if not all(isinstance(x, str) and x for x in texts) or whole[0]["text"] != texts[0]:
        raise AssertionError(f"streaming {label}: empty text, or the whole-array call's text "
                             f"differs from the chunked stream's")
    if (launches["flash_attention"] != enc * chunks
            or launches["fsmn_memory"] != (enc + dec) * chunks or launches["w8a8_linear"] != 0
            or by_call != {(11, 5): enc * chunks, (11, 10): dec * chunks}):
        raise AssertionError(f"streaming {label}: launches {launches}, FSMN by (k, left pad) "
                             f"{by_call} over {chunks} chunks")
    if profiled["launches"] != {"flash_attention": enc * prof_chunks, "fsmn_memory": (enc + dec)
                                * prof_chunks, "w8a8_linear": 0}:
        raise AssertionError(f"streaming {label}: the profile's process counted "
                             f"{profiled['launches']} over {prof_chunks} chunks")
    if not all(abs(n - want * prof_chunks) <= want * prof_chunks // 100 and n > 0
               for n, want in ((flash[1], enc), (k11[1], enc), (step[1], dec))):
        raise AssertionError(f"streaming {label}: profiled launches flash {flash[1]}, FSMN "
                             f"(11, 5) {k11[1]}, (11, 10) {step[1]} over {prof_chunks} chunks "
                             f"({profiled['tries']} profiles)")
    if sum(syncs.values()) != sync_chunks:
        raise AssertionError(f"streaming {label}: {sum(syncs.values())} host waits over "
                             f"{sync_chunks} chunks: {syncs}")
    return stats


def stream_waves():
    """Phase 11's streams, from their seed."""
    rng = np.random.default_rng(11)
    return [long_recording(rng, STREAM_SECONDS) for _ in range(STREAMS)]


def stream_profile(model_dir, bf16):
    """Phase 11's profile (``python3 chip_smoke.py --stream-profile <dir> <fp32|bf16>``), in
    a process of its own: late in the script, one profile per call of the streaming path
    lost ~2 % of its kernel records (1,317.4 of 1,341.2 a chunk, flash and FSMN among
    them), where a fresh process lost none in 18 profiles. Stream 1 through ``model_dir``:
    stream 0 as warm-up, stream 1 unprofiled (its wall), then stream 1 with one profile
    per ``generate`` call, taken again (``PROFILE_TRIES``) while it shows fewer launches
    than the counters. Prints each try, then as its last line a JSON object: chunks,
    counters, {kernel name: (ms, launches)}, the unprofiled wall ms, tries."""
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.ops.flash_attention import flash_attention
    from funasr_tpu_torch.ops.fsmn import fsmn_memory
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    counters = (flash_attention, fsmn_memory, w8a8_linear)
    streams = stream_waves()
    am = AutoModel(model=model_dir, device="cuda", bf16=bf16, log_level="WARNING")
    model, chunks = am.model, []
    inner = model.generate_chunk

    def counted(*args, **kwargs):
        chunks.append(1)
        return inner(*args, **kwargs)
    model.generate_chunk = counted
    run_stream(am, streams[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_stream(am, streams[1])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for tries in range(1, PROFILE_TRIES + 1):
        for c in counters:
            c.launches = 0
        chunks.clear()
        by_name = {}
        run_stream(am, streams[1], profiled=by_name)
        launches = {c.__name__: c.launches for c in counters}
        flash, fsmn = (kernel_totals(by_name, key)[1] for key in ("flash_", "fsmn_kernel"))
        log(f"try {tries}: {len(chunks)} chunks; launches by counter {launches}, by profile "
            f"flash {flash}, FSMN {fsmn}")
        if flash >= launches["flash_attention"] and fsmn >= launches["fsmn_memory"]:
            break
    print(json.dumps(dict(chunks=len(chunks), launches=launches, by_name=by_name,
                          wall_ms=wall, tries=tries)))


def stream_profile_child(model_dir, bf16, label):
    """``stream_profile`` in a process of its own, waited for; its lines relayed, its last
    line's JSON object returned."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--stream-profile",
                           model_dir, "bf16" if bf16 else "fp32"],
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  streaming {label} profile process: {line}")
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"streaming {label}: the profile process exited with "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def stream_profile_totals(by_name):
    """(device ms, launches) of flash, FSMN (11, 5) and FSMN (11, 10) in a profile."""
    fsmn = {k: v for k, v in by_name.items() if "fsmn_kernel" in k}
    return (kernel_totals(by_name, "flash_"), kernel_totals(fsmn, FSMN_K11),
            kernel_totals(fsmn, FSMN_STEP))


def stream_cuda_vs_cpu(gpu_model, wav, chunks, label):
    """The CUDA model against its copy on the CPU (fp32, TF32 off), chunk by chunk on the
    same host features (``chunk_outputs``): the encoder output within CPU_GPU_ENC_TOL,
    fire counts and token ids equal, every cache tensor within STREAM_CACHE_TOL.
    Returns the largest differences."""
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.models.paraformer_streaming.model import upload

    cpu_model = copy.deepcopy(gpu_model).cpu()
    frontend = tables.frontend_classes["WavFrontendOnline"](**FRONTEND_CONF)
    gc, cc, fcache = gpu_model.init_cache({}, **STREAM_CALL), cpu_model.init_cache(
        {}, **STREAM_CALL), {}
    worst = dict(encoder=0.0, cache=0.0, fired=0, tokens=0)
    for i, piece in enumerate(stream_calls(wav)[:chunks]):
        feats, _ = frontend.forward_streaming([piece], cache=fcache, is_final=False)
        with torch.inference_mode():
            yg, ng, lg = gpu_model.chunk_outputs(upload(feats, gpu_model.device, torch.float32),
                                                 gc, False)
            yc, nc, lc = cpu_model.chunk_outputs(upload(feats, cpu_model.device, torch.float32),
                                                 cc, False)
        n = int(nc[0])
        ids_g, ids_c = lg[0, :n].argmax(-1).cpu(), lc[0, :n].argmax(-1)
        enc_err = (yg.cpu() - yc).abs().max().item()
        pairs = [(gc["encoder"]["cif_state"][k], cc["encoder"]["cif_state"][k])
                 for k in ("integrate", "frame")]
        pairs += [(a[k], b[k]) for a, b in zip(gc["encoder"]["opt"], cc["encoder"]["opt"])
                  for k in ("k", "v")]
        pairs += list(zip(gc["decoder"]["decode_fsmn"], cc["decoder"]["decode_fsmn"]))
        pairs += [(a[k], b[k]) for a, b in zip(gc["decoder"]["opt"], cc["decoder"]["opt"])
                  for k in ("k", "v")]
        cache_err = max((a.cpu() - b).abs().max().item() for a, b in pairs)
        worst = dict(encoder=max(worst["encoder"], enc_err), cache=max(worst["cache"], cache_err),
                     fired=worst["fired"] + n, tokens=worst["tokens"] + len(ids_c))
        if not (enc_err <= CPU_GPU_ENC_TOL and cache_err <= STREAM_CACHE_TOL
                and int(ng[0]) == n and torch.equal(ids_g, ids_c)):
            raise AssertionError(f"streaming {label} chunk {i}: CUDA vs CPU encoder {enc_err}, "
                                 f"caches {cache_err}, fired {int(ng[0])} vs {n}, ids "
                                 f"{ids_g.tolist()} vs {ids_c.tolist()}")
    log(f"streaming CUDA vs CPU {label}: {chunks} chunks, encoder max_abs_err "
        f"{worst['encoder']:.3e} (tol {CPU_GPU_ENC_TOL:g}), caches {worst['cache']:.3e} (tol "
        f"{STREAM_CACHE_TOL:g}), fire counts and {worst['tokens']} token ids equal")
    del cpu_model
    return worst


def write_punc_realtime_dir(d):
    """The realtime punctuation model at ct-punc's widths (phase 8's PUNC_ENC, vocab
    272727) as CTTransformerStreaming with SANMVadEncoder: the ASR's tokens, the demo's
    characters, then filler tokens."""
    from funasr_tpu_torch import tables

    asr_tokens = (["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(8400)]
                  + ["<unk>"])
    demo = sorted(set(PUNC_DEMO) - set(asr_tokens) - {"|"})
    tokens = asr_tokens + demo
    tokens += [f"<filler_{i}>" for i in range(PUNC_VOCAB - len(tokens))]
    punc = tables.model_classes["CTTransformerStreaming"](
        encoder_conf=PUNC_ENC, vocab_size=len(tokens), **PUNC_MODEL_CONF,
        generator=torch.Generator().manual_seed(2))
    torch.save(punc.state_dict(), os.path.join(d, "model.pt"))
    with open(os.path.join(d, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    write_config(d, dict(
        model="CTTransformerStreaming", model_conf=PUNC_MODEL_CONF, encoder="SANMVadEncoder",
        encoder_conf=PUNC_ENC, tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


def realtime_punctuation(d, counters, card):
    """The demo's pieces through ``AutoModel(model=d, device="cuda").generate(input=piece,
    cache=cache)`` and the same on the CPU port. Gates: texts equal after every piece; the
    first 3 windows' logits within PUNC_LOGIT_TOL; 4 flash (3 causal, 1 corner) and 4 FSMN
    launches a window."""
    from funasr_tpu_torch import AutoModel

    am = AutoModel(model=d, device="cuda", log_level="WARNING")
    cpu = AutoModel(model=d, device="cpu", log_level="WARNING")
    gpu_windows, cpu_windows = Recorder(am.model, "window_logits"), Recorder(cpu.model,
                                                                              "window_logits")
    window_ms = []

    def timed_window(*args, **kwargs):
        t0 = time.perf_counter()
        out = gpu_windows(*args, **kwargs)  # ends in the logits' copy to the host
        window_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    am.model.window_logits = timed_window
    am.generate(input=PUNC_DEMO.split("|")[0], cache={})  # warm-up
    gpu_windows.calls.clear()
    gpu_windows.outputs.clear()
    window_ms.clear()
    for c in counters:
        c.launches = 0
    outputs, walls = {"cuda": [], "cpu": []}, []
    for name, model in (("cuda", am), ("cpu", cpu)):
        cache = {}
        for piece in PUNC_DEMO.split("|"):
            t0 = time.perf_counter()
            outputs[name].append((model.generate(input=piece, cache=cache)[0]["text"],
                                  list(cache["pre_text"])))
            if name == "cuda":
                walls.append((time.perf_counter() - t0) * 1e3)
        if name == "cuda":
            launches = {c.__name__: c.launches for c in counters}
    if outputs["cuda"] != outputs["cpu"]:
        raise AssertionError(f"realtime punctuation: CUDA {outputs['cuda']} vs CPU "
                             f"{outputs['cpu']}")
    windows = len(gpu_windows.calls)
    err = max(np.abs(a - b).max() for a, b in zip(gpu_windows.outputs[:3],
                                                   cpu_windows.outputs[:3]))
    del am.model.window_logits, cpu.model.window_logits
    reset_ms = wall_ms(am._reset_runtime_configs, runs=5)[0]
    log(f"realtime punctuation: {len(walls)} pieces, {windows} windows, wall per piece p50 "
        f"{percentile(walls, 50):.2f} ms (all {[round(x, 2) for x in walls]}); window forwards "
        f"+ logits to the host {sum(window_ms):.2f} ms in all; AutoModel's config reset "
        f"{reset_ms:.2f} ms a generate; texts equal to "
        f"the CPU port's, logits of the first 3 windows max_abs_err {err:.3e} (tol "
        f"{PUNC_LOGIT_TOL:g}); launches {launches} on {card}")
    blocks = PUNC_ENC["num_blocks"]
    if not (err <= PUNC_LOGIT_TOL and launches["flash_attention"] == blocks * windows
            and launches["fsmn_memory"] == blocks * windows):
        raise AssertionError(f"realtime punctuation: logits {err}, launches {launches} over "
                             f"{windows} windows")
    return dict(windows=windows, launches=launches, piece_p50_ms=percentile(walls, 50),
                window_ms=sum(window_ms), reset_ms=reset_ms, max_abs_err=float(err))


def dynamic_vad(vad_dir, wav, card):
    """``DynamicStreamingVAD`` over phase 8's VAD dir, 60 ms feeds, on the card and on the
    CPU port. Gate: the events equal, at least one endpoint."""
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.models.fsmn_vad_streaming.dynamic_vad import DynamicStreamingVAD

    events, walls = {}, []
    for device in ("cuda", "cpu"):
        vad = DynamicStreamingVAD(AutoModel(model=vad_dir, device=device, log_level="WARNING"))
        events[device] = []
        for i in range(0, len(wav), vad.chunk_samples):
            t0 = time.perf_counter()
            events[device] += vad.feed(wav[i:i + vad.chunk_samples],
                                       is_final=i + vad.chunk_samples >= len(wav))
            if device == "cuda":
                walls.append((time.perf_counter() - t0) * 1e3)
    ends = sum(e[1] != -1 for e in events["cuda"])
    log(f"dynamic VAD: {len(walls)} feeds of 60 ms, wall per feed p50 "
        f"{percentile(walls, 50):.2f} p95 {percentile(walls, 95):.2f} ms; {len(events['cuda'])} "
        f"events ({ends} endpoints), equal to the CPU port's {events['cuda'] == events['cpu']} "
        f"on {card}")
    if events["cuda"] != events["cpu"] or ends < 1:
        raise AssertionError(f"dynamic VAD: CUDA {events['cuda']} vs CPU {events['cpu']}")
    return dict(feeds=len(walls), events=len(events["cuda"]), feed_p50_ms=percentile(walls, 50))


def phase_streaming(dev, counters, card, keep=None):
    """Phase 11: ParaformerStreaming at PROD_CONF width through ``AutoModel.generate``
    600 ms a call, fp32 then ``bf16=True`` (``streaming_asr``); the CUDA port against
    the CPU port at full width for the first chunks and at the small config for a whole
    stream (``stream_cuda_vs_cpu``); the realtime punctuation model over the demo's
    pieces; ``DynamicStreamingVAD``. Returns its figures. ``keep``: see ``keep_dirs``."""
    import tempfile
    from funasr_tpu_torch import AutoModel, tables

    streams = stream_waves()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        dirs = {name: os.path.join(root, name) for name in ("asr", "punc", "vad")}
        for d in dirs.values():
            os.makedirs(d)
        t0 = time.perf_counter()
        write_model_dir(dirs["asr"], dev, model_name="ParaformerStreaming",
                        predictor_conf=PROD_CONF["predictor_conf"],
                        encoder="SANMEncoderChunkOpt", encoder_conf=STREAM_ENCODER_CONF,
                        decoder_conf=STREAM_DECODER_CONF, frontend="WavFrontendOnline")
        write_punc_realtime_dir(dirs["punc"])
        write_vad_dir(dirs["vad"])
        keep_dirs(keep, dirs, {"asr": "online", "punc": "punc_online"})
        log(f"streaming: model dirs written in {time.perf_counter() - t0:.1f} s")
        for bf16, label in ((False, "fp32"), (True, "bf16")):
            am = AutoModel(model=dirs["asr"], device="cuda", bf16=bf16, log_level="WARNING")
            out[label] = streaming_asr(am, streams, counters, card, label, dirs["asr"], bf16)
            if not bf16:
                out["cuda_vs_cpu"] = stream_cuda_vs_cpu(am.model, streams[0], STREAM_CPU_CHUNKS,
                                                        "PROD_CONF fp32")
            del am
        g = torch.Generator(device=dev).manual_seed(3)
        small = tables.model_classes["ParaformerStreaming"](**STREAM_SMALL_CONF, device=dev,
                                                            generator=g).eval()
        out["cuda_vs_cpu_small"] = stream_cuda_vs_cpu(
            small, streams[1], len(stream_calls(streams[1])), "small config fp32")
        out["punc"] = realtime_punctuation(dirs["punc"], counters, card)
        out["vad"] = dynamic_vad(dirs["vad"], streams[0], card)
    return out


# ---- phase 12: SenseVoice-Small and the CTC family ---------------------------------------

# SenseVoiceSmall's published config as benchmarks/bench_zoo.py:47-53 records it (50 + 20
# SAN-M blocks, d 512, 4 heads, FFN 2048, k 11, vocab 25055), not cut
SV_CONF = dict(input_size=560, vocab_size=25055, blank_id=0, encoder="SenseVoiceEncoderSmall",
               encoder_conf=dict(output_size=512, attention_heads=4, linear_units=2048,
                                 num_blocks=50, tp_blocks=20, kernel_size=11, sanm_shfit=0))
SV_SMALL_CONF = dict(SV_CONF, encoder_conf=dict(SV_CONF["encoder_conf"], output_size=64,
                                                linear_units=96, num_blocks=2, tp_blocks=1))
# the published tag ids (SenseVoiceSmall.LID_INT_DICT / TEXTNORM_INT_DICT); the emotion
# and event tags of the copied tag tables (utils/postprocess_utils.py) placed beside
# EMO_UNK, 25009, which stays a plain token: those tables name no unknown-emotion tag
SV_TAGS = {24884: "<|zh|>", 24885: "<|en|>", 24888: "<|yue|>", 24892: "<|ja|>",
           24896: "<|ko|>", 24992: "<|nospeech|>", 25016: "<|withitn|>", 25017: "<|woitn|>",
           24993: "<|Speech|>", 24994: "<|BGM|>", 24995: "<|Applause|>",
           24996: "<|Laughter|>", 24997: "<|Cry|>", 24998: "<|Sneeze|>", 24999: "<|Breath|>",
           25000: "<|Cough|>", 25001: "<|HAPPY|>", 25002: "<|SAD|>", 25003: "<|ANGRY|>",
           25004: "<|NEUTRAL|>", 25005: "<|FEARFUL|>", 25006: "<|DISGUSTED|>",
           25007: "<|SURPRISED|>", 25008: "<|Event_UNK|>"}
SV_SETTINGS = (("fp32", {}), ("bf16", dict(bf16=True)), ("w8a8", dict(bf16=True, quant="w8a8")))
SV_T = 388                 # a 15 s batch: the 384-frame bucket + the 4 prompt rows
SV_BATCH = 32              # utterances of 15 s a decode
SV_HEAD = (SV_BATCH * SV_T, 512, 25055)  # the CTC head's W8A8 product
# (K, N) of the blocks' W8A8 products at M = SV_BATCH x SV_T: the first block's q/k/v from
# the 560-wide features, then q/k/v, out, FFN in and out (1 + 69 + 70 + 70 + 70 a decode)
SV_W8A8_BLOCKS = ((560, 1536), (512, 1536), (512, 512), (512, 2048), (2048, 512))
SV_LOGP_TOL = 1e-3         # fp32 CTC log-probs, CUDA against the CPU: as HOTWORD_LOGP_TOL
SV_MARGIN_FACTOR = 10      # ids gated where the top-2 margin exceeds 10x the log-prob error
SV_DEMO_REQUESTS = 2
SV_DEMO_CALL = dict(language="auto", use_itn=True, batch_size_s=60, merge_vad=True,
                    merge_length_s=15)
# the CTC family at a small config (2 + 2 blocks, d 64), CUDA against the CPU port
FAMILY = {
    "CTC": dict(input_size=560, vocab_size=41, encoder="SANMEncoder",
                encoder_conf=SMALL_CONF["encoder_conf"]),
    "ParaformerV2": dict({k: v for k, v in SMALL_CONF.items() if k != "predictor_conf"},
                         ctc_weight=0.5),
    "EParaformer": dict(SMALL_CONF, predictor_conf=dict(idim=64, sigma_heads=4)),
    "MonotonicAligner": dict(input_size=560, encoder="SANMEncoder",
                             encoder_conf=SMALL_CONF["encoder_conf"],
                             predictor="CifPredictorV3",
                             predictor_conf=dict(idim=64, upsample_times=3,
                                                 upsample_type="cnn_blstm",
                                                 use_cif1_cnn=False, smooth_factor2=0.25,
                                                 noise_threshold2=0.01)),
}


def sv_tokens(n=SV_CONF["vocab_size"]):
    tokens = [chr(0x4E00 + i) for i in range(n)]
    tokens[:4] = ["<blank>", "<s>", "</s>", "<unk>"]
    for i, tag in SV_TAGS.items():
        tokens[i] = tag
    return tokens


def write_sense_voice_dir(d, dev, conf=None):
    """A SenseVoiceSmall directory (config.yaml, 25055 tokens with the tags at their ids,
    identity am.mvn, model.pt of a seeded port model at ``conf``, SV_CONF by default)."""
    from funasr_tpu_torch import tables

    conf = conf or SV_CONF
    g = torch.Generator(device=dev).manual_seed(0)
    model = tables.model_classes["SenseVoiceSmall"](**conf, device=dev, generator=g)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, os.path.join(d, "model.pt"))
    with open(os.path.join(d, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(sv_tokens(conf["vocab_size"])) + "\n")
    with open(os.path.join(d, "am.mvn"), "w") as f:
        f.write(identity_cmvn(conf["input_size"]))
    write_config(d, dict(
        model="SenseVoiceSmall", model_conf=dict(blank_id=0, sos=1, eos=2),
        encoder=conf["encoder"], encoder_conf=conf["encoder_conf"], frontend="WavFrontend",
        frontend_conf=dict(FRONTEND_CONF, cmvn_file="am.mvn"), tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))
    return model


def sense_voice_kernel_rows(dev, g):
    """The kernels at SenseVoice's shapes: flash (32, 4, 388, 128) over strided head views
    with ragged lengths and FSMN (11, 5) at (32, 388, 512) on the v slice with a prefix
    mask, fp32 and bf16; the blocks' five W8A8 products at M = 12416 (``SV_W8A8_BLOCKS``)
    and the W8A8 CTC head (12416, 512, 25055), in bf16 and bit-exact, the head with the
    time of the wrapper's slice copy of the padded (12416, 25056) output
    (``slice_copy_ms``). Raises on a disagreement."""
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.w8a8 import (plan_w8a8, quantize_rows_int8, w8a8_linear,
                                           w8a8_linear_ref)

    b, h, t, d = 32, 4, SV_T, 128
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rows[("flash_attention", "sensevoice", dtype)] = flash_row(
            q, k, v, [t - 37 * (i % 2) for i in range(b)])
        x = torch.randn(b, t, 3 * 512, generator=g).to(dev, dtype)[..., 2 * 512:]
        w = (torch.rand(512, 1, 11, generator=g) - 0.5).to(dev, dtype)
        lens = torch.tensor([t - 17 * (i % 3) for i in range(b)], device=dev)
        rows[("fsmn_memory", "sensevoice", dtype)] = fsmn_row(
            x, w, torch.arange(t, device=dev)[None] < lens[:, None], 5, 5)
    for key, row in rows.items():
        tol = (FLASH_TOL if key[0] == "flash_attention" else FSMN_TOL)[key[2]]
        log(f"{key[0]} sensevoice {row['shape']} {str(key[2])[6:]}: max_abs_err "
            f"{row['max_abs_err']:.3e} (tol {tol:g}) " + timing_line(row))
        if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= tol):
            raise AssertionError(f"{key} kernel disagrees: {row['max_abs_err']}")

    m, k, n = SV_HEAD
    gb = torch.Generator(device=dev).manual_seed(2)
    for kb, nb in SV_W8A8_BLOCKS:
        w_q8 = torch.randint(-127, 128, (nb, kb), generator=gb, device=dev, dtype=torch.int8)
        scale = torch.rand(nb, generator=gb, device=dev) * 1e-3
        x = torch.randn(m, kb, generator=gb, device=dev).to(torch.bfloat16)
        x[-1] = 0  # a zero-padded bucket row
        bias = torch.randn(nb, generator=gb, device=dev).to(torch.bfloat16)
        rows[("w8a8_linear", "sensevoice", (kb, nb))] = w8a8_row(
            x, w_q8, scale, bias, label="w8a8 sensevoice block")
    gd = torch.Generator(device=dev).manual_seed(1)
    w_q8 = torch.randint(-127, 128, (n, k), generator=gd, device=dev, dtype=torch.int8)
    scale = torch.rand(n, generator=gd, device=dev) * 1e-3
    x = torch.randn(m, k, generator=gd, device=dev).to(torch.bfloat16)
    bias = torch.randn(n, generator=gd, device=dev).to(torch.bfloat16)
    out = w8a8_linear(x, w_q8, scale, bias)
    torch.cuda.synchronize()
    ref = w8a8_linear_ref(x, w_q8, scale, bias)
    exact = torch.equal(out, ref)
    row = dict(shape=SV_HEAD, max_abs_err=(out.float() - ref.float()).abs().max().item(),
               ms=device_ms(lambda: w8a8_linear(x, w_q8, scale, bias)),
               call_ms=call_ms(lambda: w8a8_linear(x, w_q8, scale, bias)),
               plain_ms=device_ms(lambda: w8a8_linear_ref(x, w_q8, scale, bias), launches=5))
    del ref, out  # 1.2 GB of the card's memory between them
    # the library's integer product alone, on operands padded to K % 16 and N % 8
    # (torch._int_mm takes no odd N)
    p = plan_w8a8(m, k, n, torch.bfloat16)
    x_q = F.pad(quantize_rows_int8(x)[0], (0, p.kp - k))
    w_p = F.pad(w_q8, (0, p.kp - k, 0, -n % 8))
    row["library_ms"] = device_ms(lambda: torch._int_mm(x_q, w_p.t()))
    w_bf16 = (w_q8.float() * scale[:, None]).to(torch.bfloat16)
    row["cublas_bf16_ms"] = device_ms(lambda: F.linear(x, w_bf16, bias))
    padded = torch.empty(m, p.out_pitch, dtype=torch.bfloat16, device=dev)
    row["out_pitch"] = p.out_pitch
    row["slice_copy_ms"] = device_ms(lambda: padded[:, :n].contiguous())
    row["bound_ms"], row["bound_by"] = bound_ms(*w8a8_work(m, k, n, 2, 2), "int8")
    split = profile_kernels(lambda: w8a8_linear(x, w_q8, scale, bias), calls=10)
    log(f"w8a8 sensevoice head {SV_HEAD} bf16: max_abs_err {row['max_abs_err']:.3e} (tol "
        f"{W8A8_TOL}) " + timing_line(row) + f"; cuBLAS bf16 F.linear "
        f"{row['cublas_bf16_ms']:.4f}; the wrapper's slice copy of the ({m}, {p.out_pitch}) "
        f"output {row['slice_copy_ms']:.4f} ms; profile, ms per call: " + ", ".join(
            f"{name.split('<')[0].split('::')[-1].split('(')[0]} {ms / 10:.4f}"
            for name, (ms, _) in split.items()))
    if not exact:
        raise AssertionError(f"w8a8 kernel disagrees at the SenseVoice head: "
                             f"{row['max_abs_err']}")
    rows[("w8a8_linear", "sensevoice", torch.bfloat16)] = row
    return rows


def sense_voice_batch(am, batch, counters, card, label, sites):
    """One setting of the offline batch (path 1): SV_BATCH x 15 s through ``am.generate``.
    Gates: a row with its key and text per utterance; exactly ``sites`` launches per decode by
    counter and (within 1 %) by profile, the fp32 setting's in the fp32 kernels; one
    device-to-host copy per batch (``sync_points``, beside the frontend's three pageable
    uploads, which the sync debug mode reports too). Prints RTFx (median of 5 walls),
    device ms by kernel and the idle share from one profiled ``generate``."""
    keys = [f"utt{i}" for i in range(len(batch))]
    am.generate(input=batch, key=keys)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    results = am.generate(input=batch, key=keys, language="auto", use_itn=False)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    syncs = sync_points(lambda: am.generate(input=batch, key=keys))
    # the frontend's pageable uploads (waveforms, lengths, CMVN) register as waits too
    d2h = sum(n for line, n in syncs.items() if not line.startswith("wav_frontend.py"))
    t_med, times = wall_ms(lambda: am.generate(input=batch, key=keys))
    kernels = {"flash_attention": "flash_f32_kernel" if label == "fp32" else "flash_",
               "fsmn_memory": "fsmn_kernel<float" if label == "fp32" else "fsmn_kernel",
               "w8a8_linear": "quantize_rows_kernel"}
    for tries in range(1, PROFILE_TRIES + 1):
        by_name = profile_once(lambda: am.generate(input=batch, key=keys),
                               f"SenseVoice {label} generate", t_med)
        profiled = {name: kernel_totals(by_name, key) for name, key in kernels.items()}
        log(f"  SenseVoice {label} profile {tries}: launches "
            f"{ {name: n for name, (_, n) in profiled.items()} } (counters {sites})")
        if all(profiled[name][1] >= n for name, n in sites.items()):
            break
    device = sum(ms for ms, _ in by_name.values())
    stats = dict(launches=launches, wall_ms=t_med, walls=times, rtfx=len(batch) * 15e3 / t_med,
                 device_ms=device, idle_share=1 - device / t_med,
                 profile={name: dict(ms=ms, launches=n) for name, (ms, n) in profiled.items()},
                 d2h_per_batch=d2h, sync_lines=dict(syncs))
    log(f"SenseVoice {label} B={len(batch)} x 15 s: generate median {t_med:.2f} ms (runs "
        f"{[round(x, 2) for x in times]}), RTFx {stats['rtfx']:.1f}, device {device:.2f} ms, "
        f"idle share {stats['idle_share']:.1%}; launches {launches}; profile "
        f"{stats['profile']}; host waits {dict(syncs)} ({d2h} outside the frontend's "
        f"uploads); texts "
        f"{[len(r['text']) for r in results[:6]]}... chars on {card}")
    if [r["key"] for r in results] != keys or not all(
            isinstance(r["text"], str) and r["text"] for r in results):
        raise AssertionError(f"SenseVoice {label}: expected {len(keys)} keyed non-empty texts")
    if launches != sites:
        raise AssertionError(f"SenseVoice {label}: launches {launches}, expected {sites}")
    for name, want in sites.items():
        n = profiled[name][1]
        if abs(n - want) > want // 100 or (want and n == 0):
            raise AssertionError(f"SenseVoice {label}: the profile shows {n} launches of "
                                 f"{kernels[name]}, expected {want} ({tries} profiles)")
    if d2h != 1:
        raise AssertionError(f"SenseVoice {label}: {d2h} device-to-host waits a batch: "
                             f"{syncs}")
    return stats


def sense_voice_cuda_vs_cpu(gpu_model, waves, label, gate_all, textnorm=15):
    """The CUDA model against its copy on the CPU (fp32) on the same host features and
    prompt (language "auto", ``textnorm``'s query row: 15 "woitn", 14 "withitn"): the
    encoder output at the valid frames within CPU_GPU_ENC_TOL, the CTC
    log-probs within SV_LOGP_TOL; the ids equal everywhere (``gate_all``) or wherever the
    top-2 log-prob margin exceeds SV_MARGIN_FACTOR x the measured log-prob error, the
    agreement at the rest printed (random weights make margins degenerate)."""
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.utils.bucket import pad_feats_bucketed

    cpu_model = copy.deepcopy(gpu_model).cpu()
    # the features at the waveform bucket's frame count, as ``inference`` extracts them
    feats, flens = tables.frontend_classes["WavFrontend"](**FRONTEND_CONF).extract(
        waves, device="cpu")
    sp, ln, b = pad_feats_bucketed(feats, flens)
    lid = torch.zeros(sp.shape[0], dtype=torch.long)
    tn = torch.full_like(lid, textnorm)
    outs = {}
    with torch.inference_mode():
        for name, model in (("cpu", cpu_model), ("gpu", gpu_model)):
            dev = model.device
            x, lens = model.with_prompt(sp.to(dev), ln.to(dev), lid.to(dev), tn.to(dev))
            enc, _ = model.encoder(x, lens)
            logp = model.ctc.log_softmax(enc)  # ``infer``'s, on the encoder output kept
            outs[name] = (enc.cpu(), logp.argmax(dim=-1).cpu(), logp.cpu())
    valid = torch.arange(sp.shape[1] + 4)[None] < (ln + 4)[:, None]
    enc_err = (outs["gpu"][0] - outs["cpu"][0])[valid].abs().max().item()
    logp_err = (outs["gpu"][2] - outs["cpu"][2])[valid].abs().max().item()
    top2 = outs["cpu"][2].topk(2, dim=-1).values
    sure = valid & (top2[..., 0] - top2[..., 1] > SV_MARGIN_FACTOR * logp_err)
    same = outs["gpu"][1] == outs["cpu"][1]
    r = dict(enc_err=enc_err, logp_err=logp_err, frames=int(valid.sum()),
             sure=int(sure.sum()), sure_equal=bool(same[sure].all()),
             agree_rest=float(same[valid & ~sure].float().mean()) if (valid & ~sure).any()
             else 1.0, ids_equal=bool(same[valid].all()))
    seconds = sum(len(w) for w in waves) / 16000
    log(f"SenseVoice cuda vs cpu ({label}, fp32, {len(waves)} waves, {seconds:.1f} s, "
        f"encoded T {sp.shape[1] + 4}): encoder max_abs_err "
        f"{enc_err:.3e} (tol {CPU_GPU_ENC_TOL:g}), CTC log-probs {logp_err:.3e} (tol "
        f"{SV_LOGP_TOL:g}); ids equal on {r['sure']} of {r['frames']} frames whose top-2 "
        f"margin exceeds {SV_MARGIN_FACTOR}x the log-prob error: {r['sure_equal']}; agreement "
        f"at the rest {r['agree_rest']:.4f}; all equal {r['ids_equal']}")
    if not (enc_err <= CPU_GPU_ENC_TOL and logp_err <= SV_LOGP_TOL and r["sure_equal"]
            and (r["ids_equal"] or not gate_all)):
        raise AssertionError(f"SenseVoice on CUDA disagrees with the CPU port ({label}): {r}")
    return r


def keep_sanm_kernel_inputs():
    """Patches the SAN-M attention's calls of the flash and FSMN wrappers
    (``models/sanm/attention.py``) to keep a copy, strides kept, of the inputs of the first
    call at each distinct set of shapes, and to call through (the wrappers count their
    launches as ever). Returns (kernel -> {shapes: args}, a function that undoes the
    patch)."""
    from funasr_tpu_torch.models.sanm import attention

    kept = {"flash_attention": {}, "fsmn_memory": {}}
    inner = {name: getattr(attention, name) for name in kept}

    def copy_of(a):
        return a.new_empty_strided(a.shape, a.stride()).copy_(a) if torch.is_tensor(a) else a

    def keeper(name):
        def call(*args, **kwargs):
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            if key not in kept[name]:
                kept[name][key] = [copy_of(a) for a in args]
            return inner[name](*args, **kwargs)
        return call

    for name in kept:
        setattr(attention, name, keeper(name))

    def restore():
        for name, fn in inner.items():
            setattr(attention, name, fn)
    return kept, restore


def sense_voice_demo_kernels(am, wav):
    """One more demo call on ``wav`` with the ASR stage's kernel inputs and batches kept:
    flash and FSMN at every shape the VAD-merged ASR batches gave them against their plain
    versions (within FLASH_TOL / FSMN_TOL; the largest shape timed), and the longest ASR
    batch on the CUDA model against the CPU port (``sense_voice_cuda_vs_cpu``, the call's
    "withitn" prompt). Returns the rows at the largest shapes and the comparison."""
    kept, restore = keep_sanm_kernel_inputs()
    batches, asr_stage = [], am.model.inference

    def asr_inference(*args, **kwargs):
        batches.append(kwargs["data_in"] if "data_in" in kwargs else args[0])
        return asr_stage(*args, **kwargs)
    am.model.inference = asr_inference
    try:
        am.generate(input=[wav], key=["kept"], **SV_DEMO_CALL)
        torch.cuda.synchronize()
    finally:
        restore()
        am.model.inference = asr_stage
    rows = {}
    for name, calls in kept.items():
        largest = max(calls, key=lambda key: math.prod(key[0]))
        for key, args in calls.items():
            if name == "flash_attention":
                q, k, v, lengths, *rest = args
                row = flash_row(q, k, v, lengths.tolist(), *rest, timed=key == largest)
                tol = FLASH_TOL[q.dtype]
            else:
                row = fsmn_row(*args, timed=key == largest)
                tol = FSMN_TOL[args[0].dtype]
            log(f"{name} sensevoice demo ASR batch {row['shape']} {str(args[0].dtype)[6:]}: "
                f"max_abs_err {row['max_abs_err']:.3e} (tol {tol:g})"
                + (" " + timing_line(row) if key == largest else ""))
            if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= tol):
                raise AssertionError(f"{name} disagrees at the demo's ASR shape {key}: "
                                     f"{row['max_abs_err']}")
            if key == largest:
                rows[name] = row
    longest = max(batches, key=lambda b: max(len(w) for w in b))
    textnorm = am.model.query_ids(SV_DEMO_CALL)[1]
    del am.model.inference  # the Stage wrapper: the copy for the CPU takes the bare model
    cmp = sense_voice_cuda_vs_cpu(am.model, longest, "the demo's longest ASR batch",
                                  gate_all=False, textnorm=textnorm)
    return dict(rows=rows, shapes={name: [list(k[0]) for k in calls]
                                   for name, calls in kept.items()}, cuda_vs_cpu=cmp)


def sense_voice_demo(sv_dir, vad_dir, counters, card):
    """The demo's call (``sense_voice/demo.py:19-28``) over phase 8's VAD, fp32, on
    SV_DEMO_REQUESTS requests of 300 s. Gates per request: one row with its key; the VAD
    segments (before ``merge_vad``) equal to the CPU port's VAD to the ms; the ASR stage's
    launches at their sites (``kernel_sites`` x its calls); ``rich_transcription_
    postprocess`` leaves no ``<|...|>``. Prints RTFx per request and the VAD / ASR split.
    (The VAD's launches are gated at least at their sites, as phase 8 gates them.) Then
    ``sense_voice_demo_kernels`` on request 0. Returns (per-request stats, its figures)."""
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.utils.postprocess_utils import rich_transcription_postprocess

    am = AutoModel(model=sv_dir, vad_model=vad_dir,
                   vad_kwargs={"max_single_segment_time": 30000}, device="cuda",
                   log_level="WARNING")
    sites = {"vad": kernel_sites(am.vad_model), "asr": kernel_sites(am.model)}
    cpu_vad = copy.deepcopy(am.vad_model).cpu()
    stages = {"vad": Stage(am.vad_model, "inference", counters),
              "asr": Stage(am.model, "inference", counters)}
    raw_segments, vad_stage = [], stages["vad"]

    def vad_inference(*args, **kwargs):  # keeps the segments before merge_vad
        out = vad_stage(*args, **kwargs)
        raw_segments.append([[list(s) for s in r["value"]] for r in out[0]])
        return out
    am.vad_model.inference = vad_inference
    vad_calls = forward_counter(am.vad_model.encoder)
    rng = np.random.default_rng(12)
    requests = [long_recording(rng) for _ in range(SV_DEMO_REQUESTS)]
    am.generate(input=[requests[0][:16000 * 60]], key=["warm-up"], **SV_DEMO_CALL)
    torch.cuda.synchronize()
    per_request = []
    for r, wav in enumerate(requests):
        for st in stages.values():
            st.reset()
        raw_segments.clear()
        vad_calls.clear()
        key = f"request_{r}"
        t0 = time.perf_counter()
        rows = am.generate(input=[wav], key=[key], **SV_DEMO_CALL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = rich_transcription_postprocess(rows[0]["text"]) if rows else ""
        stats = dict(wall_ms=wall * 1e3, rtfx=len(wav) / 16000 / wall,
                     segments=len(raw_segments[0][0]), asr_batches=stages["asr"].calls,
                     vad_calls=len(vad_calls),
                     **{f"{name}_ms": st.ms for name, st in stages.items()},
                     **{f"{name}_launches": st.launches for name, st in stages.items()},
                     tags=rows[0]["text"].count("<|") if rows else 0, chars=len(text))
        per_request.append(stats)
        log(f"SenseVoice demo {key}: {len(wav) / 16000:.1f} s, wall {stats['wall_ms']:.2f} ms, "
            f"RTFx {stats['rtfx']:.1f}; VAD {stats['vad_ms']:.2f} ms ({stats['vad_calls']} "
            f"encoder calls, {stats['segments']} segments), ASR {stats['asr_ms']:.2f} ms "
            f"({stats['asr_batches']} batches); launches VAD {stats['vad_launches']} ASR "
            f"{stats['asr_launches']}; {stats['tags']} tags in the raw text, "
            f"{stats['chars']} chars after rich_transcription_postprocess on {card}")
        if len(rows) != 1 or rows[0]["key"] != key or not rows[0]["text"]:
            raise AssertionError(f"SenseVoice demo {key}: expected one row with its key")
        if "<|" in text or "|>" in text:
            raise AssertionError(f"SenseVoice demo {key}: a tag survived: {text[:200]!r}")
        cpu = am.inference([wav], model=cpu_vad, kwargs=am.vad_kwargs)[0]["value"]
        if [list(s) for s in cpu] != raw_segments[0][0]:
            raise AssertionError(f"SenseVoice demo {key}: VAD segments differ from the CPU "
                                 f"port's: {raw_segments[0][0]} vs {cpu}")
        need = {(stage, kernel): n * calls for stage, calls in
                (("vad", stats["vad_calls"]), ("asr", stats["asr_batches"]))
                for kernel, n in sites[stage].items()}
        # the ASR stage exactly at its sites; the VAD at least (as phase 8 gates it)
        short = {k: (stats[f"{k[0]}_launches"][k[1]], n) for k, n in need.items()
                 if n == 0 or stats[f"{k[0]}_launches"][k[1]] < n
                 or (k[0] == "asr" and stats["asr_launches"][k[1]] != n)}
        if short:
            raise AssertionError(f"SenseVoice demo {key}: launches off their sites "
                                 f"(launches, sites x calls): {short}")
    kernels = sense_voice_demo_kernels(am, requests[0])
    del am
    return per_request, kernels


def family_cuda_vs_cpu(dev, counters):
    """The CTC family at a small config, each seeded on the CPU and copied to CUDA:
    ``CTCModel``, ``ParaformerV2`` and ``EParaformer`` ids equal on 3 utterances,
    ``MonotonicAligner`` timestamps equal on 3 (audio, text) pairs; each model's kernel
    sites launched per call (``kernel_sites``)."""
    from funasr_tpu_torch import tables

    rng = np.random.default_rng(13)
    waves = [pcm(rng, s) for s in (3.0, 4.5, 2.2)]
    frontend = tables.frontend_classes["WavFrontend"](**FRONTEND_CONF)
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(37)] + ["<unk>"]
    tokenizer = tables.tokenizer_classes["CharTokenizer"](token_list=tokens)
    out = {}
    for name, conf in FAMILY.items():
        cpu_model = tables.model_classes[name](
            **conf, generator=torch.Generator().manual_seed(0)).eval()
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        data = ([(w, "".join(tokens[3 + (i * 7 + j) % 37] for j in range(3 + 2 * i)))
                 for i, w in enumerate(waves)] if name == "MonotonicAligner" else waves)
        results = {"cpu": cpu_model.inference(data, tokenizer=tokenizer, frontend=frontend)[0]}
        for c in counters:
            c.launches = 0
        results["gpu"] = gpu_model.inference(data, tokenizer=tokenizer, frontend=frontend)[0]
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        field = "timestamp" if name == "MonotonicAligner" else "text"
        same = [r[field] for r in results["gpu"]] == [r[field] for r in results["cpu"]]
        sites = kernel_sites(gpu_model)
        log(f"CTC family {name} (small, fp32): CUDA {field}s equal to the CPU port's: {same}; "
            f"launches {launches} (sites per call {sites}); {[r[field] for r in results['gpu']][:1]}")
        if not same or any(launches[k] != n for k, n in sites.items()):
            raise AssertionError(f"CTC family {name}: CUDA disagrees with the CPU port or "
                                 f"bypassed a kernel site: {launches} vs {sites}")
        out[name] = dict(launches=launches, sites=sites)
    return out


def phase_sensevoice(dev, counters, card, keep=None):
    """Phase 12: SenseVoiceSmall at its published widths through ``AutoModel`` (32 x 15 s
    at fp32, bf16 and W8A8: ``sense_voice_batch``), the CUDA port against the CPU port
    (small config and full width), the demo's VAD call (``sense_voice_demo``) and the CTC
    family at a small config (``family_cuda_vs_cpu``). Keeps its SenseVoice dir for phase
    15 (``keep_dirs``). Returns its figures."""
    import tempfile
    from funasr_tpu_torch import AutoModel, tables
    from funasr_tpu_torch.utils.bucket import pad_feats_bucketed

    rng = np.random.default_rng(10)
    batch = [pcm(rng, 15.0) for _ in range(SV_BATCH)]
    blocks = SV_CONF["encoder_conf"]["num_blocks"] + SV_CONF["encoder_conf"]["tp_blocks"]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        dirs = {name: os.path.join(root, name) for name in ("sv", "vad")}
        for d in dirs.values():
            os.makedirs(d)
        t0 = time.perf_counter()
        write_sense_voice_dir(dirs["sv"], dev)
        write_vad_dir(dirs["vad"])
        keep_dirs(keep, dirs, {"sv": "sv"})
        log(f"SenseVoice: model dirs written in {time.perf_counter() - t0:.1f} s")
        for label, extra in SV_SETTINGS:
            am = AutoModel(model=dirs["sv"], device="cuda", batch_size=32, log_level="WARNING",
                           **extra)
            sites = {"flash_attention": blocks, "fsmn_memory": blocks,
                     "w8a8_linear": 4 * blocks + 1 if "quant" in extra else 0}
            out[label] = sense_voice_batch(am, batch, counters, card, label, sites)
            if label == "fp32":
                out["cuda_vs_cpu"] = sense_voice_cuda_vs_cpu(am.model, batch[:2],
                                                             "full width", gate_all=False)
                feats, flens = am.kwargs["frontend"].extract(batch, device=dev)
                with torch.inference_mode():
                    sp, ln, _ = pad_feats_bucketed(feats, flens)
                    lid = torch.zeros(sp.shape[0], dtype=torch.long, device=dev)
                    ids, lens, logp = am.model.infer(sp, ln, lid, lid + 15)
                log(f"SenseVoice fp32: encoded T = {ids.shape[1]} (bucket {sp.shape[1]} + 4 "
                    f"prompt rows), log-probs {tuple(logp.shape)} finite "
                    f"{bool(torch.isfinite(logp).all())}")
                if ids.shape[1] != SV_T or not torch.isfinite(logp).all():
                    raise AssertionError(f"SenseVoice: T {ids.shape[1]} (expected {SV_T}) or "
                                         f"non-finite log-probs")
                del logp
            del am
            torch.cuda.empty_cache()
        g = torch.Generator().manual_seed(0)
        small = tables.model_classes["SenseVoiceSmall"](**SV_SMALL_CONF, generator=g).eval()
        out["cuda_vs_cpu_small"] = sense_voice_cuda_vs_cpu(small.to(dev), batch[:4],
                                                           "2 + 1 blocks, d 64", gate_all=True)
        out["demo"], out["demo_kernels"] = sense_voice_demo(dirs["sv"], dirs["vad"],
                                                            counters, card)
    out["family"] = family_cuda_vs_cpu(dev, counters)
    return out


# ---- phase 13: serving ------------------------------------------------------------------

# the traffic of each server: the OpenAI HTTP API, the 2-pass and the realtime WebSocket services
SERVE_HTTP_CLIENTS = 16            # the model alone: 16 clients at once, 10-15 s each
SERVE_HTTP_SECONDS = (10.0, 15.0)
SERVE_PIPE_CLIENTS = 4             # the server CLI's deployment (VAD + punctuation): 60 s
SERVE_PIPE_SECONDS = 60.0
SERVE_MAX_BATCH, SERVE_WAIT_MS = 8, 15.0  # TranscriptionApp's defaults
SERVE_2PASS = dict(mode="2pass", chunk_size=[5, 10, 5])
SERVE_2PASS_SESSIONS = 2
SERVE_2PASS_SECONDS = 15.0         # (cut from 30 s for the run's time limit beside phase 17)
SERVE_2PASS_FRAME = 9600           # 600 ms of PCM16 a binary frame
SERVE_RT_SECONDS = 20.0            # the server-mode session, 60 ms frames at real time
SERVE_RT_FRAME = 960               # (cut from 30 s for the run's time limit: one VAD
                                   # endpoint, at 10.1 s, and the STOP final)
SERVE_RT_COMMITS = (10.0, 60.0)    # the client-mode session's COMMITs: the second at T 1,024
# B = 1 kernel rows: partial windows (0.48-15 s: T 128 / 256 / 384), the 60 s COMMIT
# (T 1,024) and the forced final at max_utterance_sec = 300 s (T 5,120)
SERVE_T = (128, 256, 384, 1024, 5120)
SERVE_LOGP_TOL = 1e-3              # fp32 decoder log-probs, CUDA against the CPU port
SERVE_MARGIN_FACTOR = 10           # ids gated where the top-2 margin exceeds 10x the error
# the model dirs phase 13 serves, which the earlier phases keep: phase 8's Paraformer, VAD
# and punctuation, phase 11's streaming Paraformer and realtime punctuation, phase 9's CAM++
SERVE_ROLES = ("asr", "vad", "punc", "online", "punc_online", "spk")
SERVERS = ("http", "http_pipeline", "two_pass", "realtime")


def keep_dirs(keep, dirs, roles):
    """Hard-link the model dirs ``dirs[role]`` of an earlier phase into ``keep["root"]``
    (they outlive the phase's temporary directory) as ``keep[role]``; ``keep`` None: no-op.
    ``roles``: {role in dirs: role in keep}."""
    import shutil
    if keep is None:
        return
    for src, dst in roles.items():
        keep[dst] = os.path.join(keep["root"], dst)
        shutil.copytree(dirs[src], keep[dst], copy_function=os.link)


def serving_kernel_rows(dev, g):
    """Flash and FSMN (fp32, the servers' dtype) at the serving shapes, each against its
    plain version: the model-alone server's batches, (8, 4, 384, 128) with ragged lengths
    and FSMN (8, 384, 512) k 11 with a prefix mask; B = 1 at T = SERVE_T (a window or an
    utterance of T - 24 valid frames): (1, 4, T, 128) and (1, T, 512). q | k | v and the
    FSMN input are strided slices of one fused projection, as on the path. Raises on a
    disagreement."""
    rows = {}
    shapes = [(8, 384)] + [(1, t) for t in SERVE_T]
    for b, t in shapes:
        lens = [t - 37 * (i % 2) for i in range(b)] if b > 1 else [t - 24]
        qkv = torch.randn(b, t, 3, 4, 128, generator=g).to(dev)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rows[("flash_attention", "serving", (b, t))] = flash_row(q, k, v, lens)
        del qkv, q, k, v
        x = torch.randn(b, t, 3 * 512, generator=g).to(dev)[..., 2 * 512:]
        w = (torch.rand(512, 1, 11, generator=g) - 0.5).to(dev)
        mask = torch.arange(t, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
        rows[("fsmn_memory", "serving", (b, t))] = fsmn_row(x, w, mask, 5, 5)
    for key, row in rows.items():
        tol = (FLASH_TOL if key[0] == "flash_attention" else FSMN_TOL)[torch.float32]
        log(f"{key[0]} serving {row['shape']} fp32: max_abs_err {row['max_abs_err']:.3e} "
            f"(tol {tol:g}) " + timing_line(row))
        if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= tol):
            raise AssertionError(f"{key} kernel disagrees: {row['max_abs_err']}")
    return rows


def wav_bytes(wave16, fs=16000):
    """A PCM16 WAV container, as a client uploads it."""
    import io
    import wave
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(wave16.tobytes())
    return buf.getvalue()


def to_pcm16(wav):
    return np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)


def http_post(port, data, **fields):
    """One ``/v1/audio/transcriptions`` request, multipart as ``tests/test_serving.py``
    builds it: (status, payload, seconds)."""
    import urllib.request
    boundary = "x123"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() + data
    for name, value in fields.items():
        body += (f"\r\n--{boundary}\r\nContent-Disposition: form-data; "
                 f"name=\"{name}\"\r\n\r\n{value}").encode()
    body += f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/audio/transcriptions", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read()), time.perf_counter() - t0


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_burst(app, requests):
    """``app`` on a free localhost port, every request ([(wav bytes, fields)]) sent at once
    from a client thread each: ([(status, payload, seconds)], wall seconds of the burst,
    {"batcher": ms each request spent in the batcher (queue, wait, decode), "handle": ms
    the server spent on each connection}). The clients are threads of this process, so
    their latency also holds their turns at the interpreter lock."""
    import asyncio
    import concurrent.futures
    port = free_port()
    batcher_ms, handle_ms, submit = [], [], app.batcher.submit

    async def timed_submit(audio, **kwargs):
        t0 = time.perf_counter()
        result = await submit(audio, **kwargs)
        batcher_ms.append((time.perf_counter() - t0) * 1e3)
        return result
    app.batcher.submit = timed_submit

    async def timed_handle(reader, writer):
        t0 = time.perf_counter()
        await app.handle(reader, writer)
        handle_ms.append((time.perf_counter() - t0) * 1e3)

    async def scenario():
        server = await asyncio.start_server(timed_handle, "127.0.0.1", port)
        loop = asyncio.get_running_loop()
        async with server:
            with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
                t0 = time.perf_counter()
                out = await asyncio.gather(*[
                    loop.run_in_executor(pool, lambda r=r: http_post(port, r[0], **r[1]))
                    for r in requests])
                return out, time.perf_counter() - t0, dict(batcher=batcher_ms, handle=handle_ms)

    return asyncio.run(scenario())


def served(label, counters, targets, traffic):
    """``traffic()``, a server's run, with every kernel's count set to 0 just before it and
    read just after it, and the calls of each ``targets[name]`` = (module, method) counted
    meanwhile from any thread (an instance attribute shadows the method). Raises unless
    flash and FSMN each launched at least ``kernel_sites(module)`` times each counted
    call, and at least once. Returns (what ``traffic`` returned, {kernel: launches},
    {name: calls})."""
    calls = {name: [] for name in targets}
    for name, (module, attr) in targets.items():
        def counted(*args, _inner=getattr(module, attr), _calls=calls[name], **kwargs):
            _calls.append(1)
            return _inner(*args, **kwargs)
        setattr(module, attr, counted)
    try:
        for c in counters:
            c.launches = 0
        out = traffic()
        launches = {c.__name__: c.launches for c in counters}
    finally:
        for module, attr in targets.values():
            delattr(module, attr)
    need = {}
    for name, (module, _) in targets.items():
        for kernel, n in kernel_sites(module).items():
            need[kernel] = need.get(kernel, 0) + n * len(calls[name])
    short = {k: (launches[k], need.get(k, 0)) for k in ("flash_attention", "fsmn_memory")
             if not 0 < need.get(k, 0) <= launches[k]}
    if short:
        raise AssertionError(f"{label}: the server bypassed a kernel (launches, needed by its "
                             f"model calls {({n: len(c) for n, c in calls.items()})}): {short}")
    return out, launches, {name: len(c) for name, c in calls.items()}


def asr_targets(name, am):
    """``served`` targets of an offline AutoModel: its encoder and decoder forwards, and
    its punctuation model's encoder forward if it has one."""
    targets = {f"{name} encoder": (am.model.encoder, "forward"),
               f"{name} decoder": (am.model.decoder, "forward")}
    if am.punc_model is not None:
        targets[f"{name} punctuation"] = (am.punc_model.encoder, "forward")
    return targets


def check_http(label, out, data, calls, am):
    """Gates of one HTTP run: every response 200 with a non-empty text, and equal to its
    row of a direct ``generate`` over its batcher group (``calls``: the groups'
    ``generate`` calls) in the same order."""
    bad = [(s, p) for s, p, _ in out if s != 200 or not p.get("text")]
    if bad:
        raise AssertionError(f"{label}: responses not 200 with a text: {bad[:3]}")
    index = {x: i for i, x in enumerate(data)}
    for kwargs, _, _ in calls:
        group = kwargs["input"]
        direct = am.generate(input=group, **{k: v for k, v in kwargs.items() if k != "input"})
        for audio, row in zip(group, direct):
            got = out[index[audio]][1]["text"]
            if got != row["text"]:
                raise AssertionError(f"{label}: a response is not its row of the group: "
                                     f"{got[:40]!r} vs {row['text'][:40]!r}")


def http_group_vs_cpu(am, cpu_am, group):
    """One group of the model-alone server's on the card and on the CPU port (fp32) through
    ``generate``: the decoder log-probs within SERVE_LOGP_TOL on rows whose token counts
    agree; ids equal wherever the CPU's top-2 margin exceeds SERVE_MARGIN_FACTOR x that
    error; the texts equal on every row whose tokens all clear it."""
    out = {}
    for name, a in (("card", am), ("cpu", cpu_am)):
        rec = Recorder(a.model, "cal_decoder_with_predictor")
        rows = a.generate(input=group, batch_size=len(group))
        del a.model.cal_decoder_with_predictor
        out[name] = (rows, rec.outputs[-1][0].float().cpu(), rec.calls[-1][0][3].cpu())
    (rows_g, lp_g, ln_g), (rows_c, lp_c, ln_c) = out["card"], out["cpu"]
    err, sure_equal, rows_sure, texts_equal, tokens, sure_n = 0.0, True, 0, True, 0, 0
    for i in range(len(group)):
        n = int(ln_c[i])
        if int(ln_g[i]) != n:
            continue
        err = max(err, (lp_g[i, :n] - lp_c[i, :n]).abs().max().item() if n else 0.0)
    for i in range(len(group)):
        n = int(ln_c[i])
        if int(ln_g[i]) != n:
            continue
        top2 = lp_c[i, :n].topk(2, dim=-1).values
        sure = top2[:, 0] - top2[:, 1] > SERVE_MARGIN_FACTOR * err
        same = lp_g[i, :n].argmax(-1) == lp_c[i, :n].argmax(-1)
        tokens, sure_n = tokens + n, sure_n + int(sure.sum())
        sure_equal &= bool(same[sure].all())
        if bool(sure.all()):
            rows_sure += 1
            texts_equal &= rows_g[i]["text"] == rows_c[i]["text"]
    r = dict(rows=len(group), logp_err=err, tokens=tokens, sure_tokens=sure_n,
             sure_equal=sure_equal, rows_all_sure=rows_sure, texts_equal_there=texts_equal,
             same_lens=int((ln_g[:len(group)] == ln_c[:len(group)]).sum()),
             texts_equal=sum(a["text"] == b["text"] for a, b in zip(rows_g, rows_c)))
    if not (err <= SERVE_LOGP_TOL and sure_equal and texts_equal):
        raise AssertionError(f"HTTP group on the card disagrees with the CPU port: {r}")
    return r


def serve_http_model(d, counters, card):
    """The model-alone server: ``TranscriptionApp(AutoModel(model=asr, device="cuda"))``
    (max_batch 8, batch_wait_ms 15), SERVE_HTTP_CLIENTS clients at once, one 10-15 s WAV
    each (``json``). Gated by ``check_http``; the smallest group of >= 2 against the CPU
    port (``http_group_vs_cpu``). Prints requests/s, p50 / p95 latency, the batches, and
    one profiled ``generate`` of the largest group."""
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.bin._server_app import TranscriptionApp

    rng = np.random.default_rng(13)
    waves = [long_recording(rng, rng.uniform(*SERVE_HTTP_SECONDS))
             for _ in range(SERVE_HTTP_CLIENTS)]
    data = [wav_bytes(to_pcm16(w)) for w in waves]
    am = AutoModel(model=d["asr"], device="cuda", log_level="WARNING")
    sites = kernel_sites(am.model)
    am.generate(input=data[:2], batch_size=2)  # warm-up, outside the counts
    torch.cuda.synchronize()
    calls = Recorder(am, "generate")
    app = TranscriptionApp(am, batch_wait_ms=SERVE_WAIT_MS, max_batch=SERVE_MAX_BATCH)
    (out, wall, server_ms), launches, model_calls = served(
        "HTTP model alone", counters, asr_targets("asr", am),
        lambda: http_burst(app, [(x, {}) for x in data]))
    del am.generate
    stats = app.batcher.stats()
    lat = [s * 1e3 for _, _, s in out]
    log(f"HTTP model alone: {len(out)} requests of {sum(len(w) for w in waves) / 16000:.1f} s "
        f"in {wall * 1e3:.2f} ms: {len(out) / wall:.2f} requests/s, latency p50 "
        f"{percentile(lat, 50):.2f} p95 {percentile(lat, 95):.2f} ms (the server's handler p50 "
        f"{percentile(server_ms['handle'], 50):.2f} p95 {percentile(server_ms['handle'], 95):.2f}"
        f", in the batcher p50 {percentile(server_ms['batcher'], 50):.2f} p95 "
        f"{percentile(server_ms['batcher'], 95):.2f}); batches "
        f"{app.batcher.batch_sizes} (mean {stats['mean_batch']:.2f}), generate wall ms "
        f"{[round(ms, 2) for ms in calls.ms]}; launches {launches} (sites a generate "
        f"{sites}; model calls {model_calls}) on {card}")
    check_http("HTTP model alone", out, data, calls.log(), am)
    if not (stats["generate_calls"] < stats["requests"] and stats["max_batch_seen"] >= 2):
        raise AssertionError(f"HTTP model alone: the batcher did not batch: {stats}")
    inputs = [kw["input"] for _, kw in calls.calls]
    largest = max(inputs, key=len)
    g_med, _ = wall_ms(lambda: am.generate(input=largest, batch_size=len(largest)), runs=3)
    by_name = profile_once(lambda: am.generate(input=largest, batch_size=len(largest)),
                           f"HTTP generate of a group of {len(largest)}", g_med)
    small = min((x for x in inputs if len(x) >= 2), key=len, default=min(inputs, key=len))
    cpu_am = AutoModel(model=d["asr"], device="cpu", log_level="WARNING")
    vs_cpu = http_group_vs_cpu(am, cpu_am, small)
    log(f"HTTP group of {len(small)} vs the CPU port: decoder log-probs max_abs_err "
        f"{vs_cpu['logp_err']:.3e} (tol {SERVE_LOGP_TOL:g}) on {vs_cpu['same_lens']} rows of "
        f"equal token counts; ids equal on the {vs_cpu['sure_tokens']} of "
        f"{vs_cpu['tokens']} tokens whose top-2 margin exceeds {SERVE_MARGIN_FACTOR}x it: "
        f"{vs_cpu['sure_equal']}; texts equal on the {vs_cpu['rows_all_sure']} rows all of "
        f"whose tokens clear it; all texts equal on {vs_cpu['texts_equal']} of "
        f"{vs_cpu['rows']} rows")
    del cpu_am
    return dict(stats=stats, requests_per_s=len(out) / wall, p50_ms=percentile(lat, 50),
                p95_ms=percentile(lat, 95), launches=launches, sites=sites,
                model_calls=model_calls,
                handle_p50_ms=percentile(server_ms["handle"], 50),
                batcher_p50_ms=percentile(server_ms["batcher"], 50),
                batch_sizes=app.batcher.batch_sizes, group_wall_ms=g_med,
                group=len(largest), vs_cpu=vs_cpu,
                profile={name: kernel_totals(by_name, key) for name, key in FP32_KERNELS.items()})


def serve_http_pipeline(d, counters, card):
    """The server CLI's deployment: ``TranscriptionApp(AutoModel(model=asr, vad_model=vad,
    punc_model=punc, device="cuda"))``, built with ``pred_timestamp`` and
    ``sentence_timestamp`` (the plain Paraformer's timestamps, which paraformer-zh's BiCif
    head gives natively, so ``verbose_json`` has sentence segments), SERVE_PIPE_CLIENTS
    clients at once with 60 s each, one asking for ``verbose_json``. Gated by
    ``check_http`` (the VAD segments of each input batch inside ``inference_with_vad``)
    and on the segments."""
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.bin._server_app import TranscriptionApp

    rng = np.random.default_rng(14)
    waves = [long_recording(rng, SERVE_PIPE_SECONDS) for _ in range(SERVE_PIPE_CLIENTS)]
    data = [wav_bytes(to_pcm16(w)) for w in waves]
    am = AutoModel(model=d["asr"], vad_model=d["vad"], punc_model=d["punc"], device="cuda",
                   pred_timestamp=True, sentence_timestamp=True, log_level="WARNING")
    am.generate(input=data[:1])  # warm-up, outside the counts
    torch.cuda.synchronize()
    calls = Recorder(am, "generate")
    app = TranscriptionApp(am, batch_wait_ms=SERVE_WAIT_MS, max_batch=SERVE_MAX_BATCH)
    fields = [{"response_format": "verbose_json"}] + [{}] * (len(data) - 1)
    (out, wall, server_ms), launches, model_calls = served(
        "HTTP pipeline", counters,
        {**asr_targets("asr", am), "vad encoder": (am.vad_model.encoder, "forward")},
        lambda: http_burst(app, list(zip(data, fields))))
    n_asr = model_calls["asr encoder"]
    del am.generate
    stats = app.batcher.stats()
    lat = [s * 1e3 for _, _, s in out]
    segments = out[0][1].get("segments") or []
    log(f"HTTP VAD + ASR + punctuation: {len(out)} requests of {SERVE_PIPE_SECONDS:.0f} s in "
        f"{wall * 1e3:.2f} ms: {len(out) / wall:.2f} requests/s, latency p50 "
        f"{percentile(lat, 50):.2f} p95 {percentile(lat, 95):.2f} ms (the server's handler p50 "
        f"{percentile(server_ms['handle'], 50):.2f}, in the batcher p50 "
        f"{percentile(server_ms['batcher'], 50):.2f}), RTFx "
        f"{len(out) * SERVE_PIPE_SECONDS / wall:.1f}; batches {app.batcher.batch_sizes}, "
        f"{n_asr} ASR batches of VAD segments; verbose_json {len(segments)} "
        f"segments; launches {launches} (model calls {model_calls}) on {card}")
    check_http("HTTP pipeline", out, data, calls.log(), am)
    if not segments or not all(isinstance(s["text"], str) and s["end"] >= 0 for s in segments):
        raise AssertionError(f"HTTP pipeline: verbose_json segments {segments[:3]}")
    return dict(stats=stats, requests_per_s=len(out) / wall, p50_ms=percentile(lat, 50),
                p95_ms=percentile(lat, 95), launches=launches, segments=len(segments),
                asr_batches=n_asr, model_calls=model_calls)


async def two_pass_client(port, wav, name):
    """The FunASR 2-pass client: the config frame, PCM16 in SERVE_2PASS_FRAME frames as
    fast as the socket takes them, ``is_speaking: false``; every message up to the final
    with its arrival time, and the time ``is_speaking: false`` was sent."""
    import asyncio
    from funasr_tpu_torch.serving.ws_protocol import connect

    ws = await connect("127.0.0.1", port)
    await ws.send(json.dumps(dict(SERVE_2PASS, wav_name=name, is_speaking=True)))
    data = to_pcm16(wav)
    for i in range(0, len(data), SERVE_2PASS_FRAME):
        await ws.send(data[i:i + SERVE_2PASS_FRAME].tobytes())
    t_end = time.perf_counter()
    await ws.send(json.dumps({"is_speaking": False}))
    msgs = []
    while not (msgs and msgs[-1][0]["is_final"]):
        msgs.append((json.loads(await asyncio.wait_for(ws.recv(), 300)), time.perf_counter()))
    await ws.close()
    return [m for m, _ in msgs], (msgs[-1][1] - t_end) * 1e3


def run_two_pass(server, waves, concurrent):
    """Each wave through a 2-pass session of its own, all at once or one after the
    other: [(messages, ms from is_speaking false to the final)]."""
    import asyncio
    from funasr_tpu_torch.serving.ws_protocol import serve
    port = free_port()

    async def scenario():
        srv = await serve(server.handle, "127.0.0.1", port)
        try:
            sessions = [two_pass_client(port, w, f"s{i}") for i, w in enumerate(waves)]
            if concurrent:
                return await asyncio.gather(*sessions)
            return [await s for s in sessions]
        finally:
            srv.close()
            await srv.wait_closed()

    return asyncio.run(scenario())


def replay_two_pass(online, punc_online, offline, chunk_calls, punc_calls, final_calls):
    """The server's model calls, replayed directly on the same AutoModels: each streaming
    cache's 9,600-sample chunks in order from a fresh cache (``generate``), each punctuation
    cache's texts (``inference`` with the model's kwargs), each final's audio through the
    offline AutoModel (``generate``). Returns the mismatches."""
    bad = []
    for calls, run in ((chunk_calls, lambda kw, cache: online.generate(
            input=kw["input"], cache=cache, is_final=kw["is_final"],
            chunk_size=kw["chunk_size"])),
                       (punc_calls, lambda kw, cache: punc_online.inference(
            kw["input"], model=punc_online.model, kwargs=punc_online.kwargs, cache=cache))):
        caches = {}
        for kw, res, _ in calls:
            cache = caches.setdefault(id(kw["cache"]), {})
            got = run(kw, cache)[0]["text"]
            if got != res[0]["text"]:
                bad.append((got, res[0]["text"]))
    for kw, res, _ in final_calls:
        got = offline.generate(input=kw["input"])[0]["text"]
        if got != res[0]["text"]:
            bad.append((got, res[0]["text"]))
    return bad


def serve_two_pass(d, counters, card, offline, vad):
    """The 2-pass server: ``WSServer(asr=Paraformer + punctuation, asr_online=
    ParaformerStreaming, punc_online=CTTransformerStreaming, vad=fsmn-vad)`` on the card,
    SERVE_2PASS_SESSIONS sessions of SERVE_2PASS_SECONDS at once (``2pass``, chunk_size
    [5, 10, 5]), then the same sessions one after the other. Gates: each session has
    online and offline messages and ends in a final; the two runs' messages equal; the
    concurrent run's model calls replayed directly equal (``replay_two_pass``), and the
    offline messages are the offline AutoModel's outputs. Prints the online message's
    server time per chunk (streaming ``generate`` + punctuation) and the ms from
    ``is_speaking: false`` to the final."""
    import collections
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.bin.funasr_wss_server import WSServer

    def stats(calls, name):
        return percentile([ms for _, _, ms in calls[name]], 50)

    rng = np.random.default_rng(15)
    waves = [long_recording(rng, SERVE_2PASS_SECONDS) for _ in range(SERVE_2PASS_SESSIONS)]
    online = AutoModel(model=d["online"], device="cuda", log_level="WARNING")
    punc_online = AutoModel(model=d["punc_online"], device="cuda", log_level="WARNING")
    server = WSServer(asr_model=offline, asr_model_online=online, vad_model=vad,
                      punc_model_online=punc_online)
    run_two_pass(server, [waves[0][:16000 * 3]], concurrent=False)  # warm-up
    # an online message's server time: its chunk's streaming call to its punctuation's end
    starts, chunk_ms = {}, []
    online_chunk, punc_chunk = server._online_chunk, server._punc_online

    def timed_online(sess, chunk, is_final):
        starts[id(sess)] = time.perf_counter()
        return online_chunk(sess, chunk, is_final)

    def timed_punc(sess, text):
        out = punc_chunk(sess, text)
        chunk_ms.append((time.perf_counter() - starts[id(sess)]) * 1e3)
        return out
    server._online_chunk, server._punc_online = timed_online, timed_punc
    logs = {name: Recorder(am, "generate") for name, am in
            (("online", online), ("punc", punc_online), ("offline", offline))}
    targets = {**asr_targets("offline", offline),
               "streaming encoder": (online.model.encoder, "forward_chunk"),
               "streaming decoder": (online.model.decoder, "forward_chunk"),
               "realtime punctuation": (punc_online.model.encoder, "forward"),
               "vad encoder": (vad.model.encoder, "forward")}
    t0 = time.perf_counter()
    together, launches, model_calls = served(
        "2-pass", counters, targets, lambda: run_two_pass(server, waves, concurrent=True))
    wall = time.perf_counter() - t0
    calls = {name: lg.log() for name, lg in logs.items()}
    for am in (online, punc_online, offline):
        del am.generate
    final_ms = [ms for _, ms in together]
    chunk_p50, chunk_p95 = percentile(chunk_ms, 50), percentile(chunk_ms, 95)
    msgs = [m for m, _ in together]
    log(f"2-pass: {len(waves)} sessions of {SERVE_2PASS_SECONDS:.0f} s at once in "
        f"{wall * 1e3:.2f} ms; messages per session "
        f"{[collections.Counter(x['mode'] for x in m) for m in msgs]}; online message "
        f"server ms per chunk (streaming generate + punctuation) p50 "
        f"{chunk_p50:.2f} p95 {chunk_p95:.2f} over {len(chunk_ms)}, streaming "
        f"generate p50 {stats(calls, 'online'):.2f}, punctuation p50 {stats(calls, 'punc'):.2f} "
        f"(each AutoModel's lock wait included); offline finals {len(calls['offline'])}, "
        f"generate p50 {stats(calls, 'offline'):.2f} ms; is_speaking false -> "
        f"final {[round(x, 2) for x in final_ms]} ms; launches {launches} (model calls "
        f"{model_calls}) on {card}")
    for m in msgs:
        modes = [x["mode"] for x in m]
        if not ("2pass-online" in modes and "2pass-offline" in modes
                and m[-1]["is_final"] is True and m[-1]["mode"] == "2pass-offline"):
            raise AssertionError(f"2-pass: a session's messages {modes}")
    bad = replay_two_pass(online, punc_online, offline, calls["online"], calls["punc"],
                          calls["offline"])
    offline_texts = collections.Counter(x["text"] for m in msgs for x in m
                                        if x["mode"] == "2pass-offline")
    outputs = collections.Counter(res[0]["text"] for _, res, _ in calls["offline"])
    spare = sum(offline_texts.values()) - sum(outputs.values())
    if bad or spare < 0 or offline_texts != outputs + collections.Counter({"": spare}):
        raise AssertionError(f"2-pass: served texts differ from the direct calls: {bad[:3]}; "
                             f"offline {offline_texts} vs {outputs}")
    log(f"2-pass: {len(calls['online'])} streaming chunks, {len(calls['punc'])} punctuation "
        f"calls and {len(calls['offline'])} finals replayed directly: equal")
    # the same sessions one after the other: their messages, and the same timings without
    # the other session's calls in the way (the AutoModels' locks, the interpreter lock)
    logs = {name: Recorder(am, "generate") for name, am in
            (("online", online), ("punc", punc_online), ("offline", offline))}
    n_together, t0 = len(chunk_ms), time.perf_counter()
    one_by_one = run_two_pass(server, waves, concurrent=False)
    alone_wall = time.perf_counter() - t0
    alone = {name: lg.log() for name, lg in logs.items()}
    for am in (online, punc_online, offline):
        del am.generate
    alone_ms = chunk_ms[n_together:]
    log(f"2-pass, the sessions one after the other: {alone_wall * 1e3:.2f} ms; online message "
        f"server ms per chunk p50 {percentile(alone_ms, 50):.2f} p95 "
        f"{percentile(alone_ms, 95):.2f}, streaming generate p50 {stats(alone, 'online'):.2f}, "
        f"punctuation p50 {stats(alone, 'punc'):.2f}, offline generate p50 "
        f"{stats(alone, 'offline'):.2f} ms; is_speaking false -> final "
        f"{[round(ms, 2) for _, ms in one_by_one]} ms; messages equal to the concurrent "
        f"run's: {[m for m, _ in one_by_one] == msgs}")
    if [m for m, _ in one_by_one] != msgs:
        raise AssertionError("2-pass: concurrent sessions differ from the same sessions run "
                             "one after the other")
    return dict(launches=launches, model_calls=model_calls, wall_ms=wall * 1e3,
                chunk_p50_ms=chunk_p50,
                chunk_p95_ms=chunk_p95, final_ms=final_ms,
                online_calls=len(calls["online"]), finals=len(calls["offline"]),
                alone=dict(wall_ms=alone_wall * 1e3, chunk_p50_ms=percentile(alone_ms, 50),
                           chunk_p95_ms=percentile(alone_ms, 95),
                           final_ms=[ms for _, ms in one_by_one],
                           generate_p50_ms={k: stats(alone, k) for k in alone}))


async def realtime_server_session(ws, data, fs=16000):
    """SERVE_RT_FRAME frames at real time (frame i leaves when i frames of audio have
    played), then STOP: every message."""
    import asyncio
    from funasr_tpu_torch.serving.ws_protocol import ConnectionClosed

    t0 = time.perf_counter()
    for i in range(0, len(data), SERVE_RT_FRAME):
        await asyncio.sleep(max(t0 + i / fs - time.perf_counter(), 0.0))
        await ws.send(data[i:i + SERVE_RT_FRAME].tobytes())
    await asyncio.sleep(1.0)  # the VAD worker's queue drains
    await ws.send("STOP")
    msgs = []
    try:
        while True:
            msgs.append(json.loads(await asyncio.wait_for(ws.recv(), 300)))
    except ConnectionClosed:
        return msgs


async def realtime_client_session(ws, utterances):
    """``endpoint_mode: client``: each utterance in SERVE_RT_FRAME frames as fast as the
    socket takes them, then COMMIT, waiting for its final; STOP."""
    import asyncio
    msgs = []
    await ws.send(json.dumps({"endpoint_mode": "client"}))
    for data in utterances:
        for i in range(0, len(data), SERVE_RT_FRAME):
            await ws.send(data[i:i + SERVE_RT_FRAME].tobytes())
        await ws.send("COMMIT")
        while True:
            msgs.append(json.loads(await asyncio.wait_for(ws.recv(), 300)))
            if msgs[-1].get("is_final"):
                break
    await ws.send("STOP")
    return msgs


def realtime_order(msgs):
    """Finals in order from utterance 0 with rising spans; partials with ``stable`` >= 1,
    never after their utterance's final. Returns the finals."""
    finals, seen = [], set()
    for m in msgs:
        if m["type"] == "final":
            finals.append(m)
            seen.add(m["utt"])
        elif m["type"] != "partial" or m["stable"] < 1 or m["utt"] in seen:
            raise AssertionError(f"realtime: a partial out of order: {m}")
    if [f["utt"] for f in finals] != list(range(len(finals))) or any(
            not (a["end_ms"] == b["start_ms"] < b["end_ms"]) for a, b in zip(finals, finals[1:])):
        raise AssertionError(f"realtime: finals out of order: {finals}")
    return finals


def serve_realtime(d, counters, card, asr, vad):
    """The realtime server: ``RealtimeWSServer(asr=Paraformer + punctuation,
    vad_model=fsmn-vad, spk_model=CAM++)`` on the card. One ``server``-mode session (VAD
    endpoints, speakers) of SERVE_RT_SECONDS of two voices, and one ``client``-mode session
    committing SERVE_RT_COMMITS seconds. Gates: finals in order with rising spans, an
    integer ``spk`` on every server-mode final; partials in order (``realtime_order``); the
    COMMIT finals equal direct decodes of the committed audio. Prints the partial latency
    (cadence point to message, executor wait included)."""
    import asyncio
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.bin.realtime_ws import RealtimeWSServer
    from funasr_tpu_torch.serving.ws_protocol import connect, serve

    rng = np.random.default_rng(16)
    wav, _ = two_voice_recording(rng, SERVE_RT_SECONDS)
    wav[-24000:] += voice_burst(rng, 0, 24000)  # speech up to STOP: the last final has a voice
    commits = [to_pcm16(long_recording(rng, s)) for s in SERVE_RT_COMMITS]
    server = RealtimeWSServer(
        asr, vad_model=vad,
        spk_model=AutoModel(model=d["spk"], device="cuda", log_level="WARNING"))
    partial_ms, partial_task = [], server._partial_task

    async def timed_partial(*args):
        t0 = time.perf_counter()
        await partial_task(*args)
        partial_ms.append((time.perf_counter() - t0) * 1e3)
    server._partial_task = timed_partial
    port = free_port()

    async def scenario():
        srv = await serve(server.handle, "127.0.0.1", port)
        try:
            out = []
            for script, arg in ((realtime_server_session, to_pcm16(wav)),
                                (realtime_client_session, commits)):
                ws = await connect("127.0.0.1", port)
                t0 = time.perf_counter()
                out.append((await script(ws, arg), time.perf_counter() - t0))
                await ws.close()
            return out
        finally:
            srv.close()
            await srv.wait_closed()

    asr.generate(input=commits[0][:16000])  # warm-up
    ((server_msgs, server_s), (client_msgs, client_s)), launches, model_calls = served(
        "realtime", counters, {**asr_targets("asr", asr),
                               "vad encoder": (vad.model.encoder, "forward")},
        lambda: asyncio.run(scenario()))
    server_finals, client_finals = realtime_order(server_msgs), realtime_order(client_msgs)
    log(f"realtime: server mode {SERVE_RT_SECONDS:.0f} s in {server_s * 1e3:.2f} ms: "
        f"{len(server_finals)} finals (spk {[f.get('spk') for f in server_finals]}, spans "
        f"{[(f['start_ms'], f['end_ms']) for f in server_finals]}), "
        f"{len(server_msgs) - len(server_finals)} partials; client mode "
        f"{sum(SERVE_RT_COMMITS):.0f} s in {client_s * 1e3:.2f} ms: {len(client_finals)} "
        f"finals, {len(client_msgs) - len(client_finals)} partials; partial latency p50 "
        f"{percentile(partial_ms, 50):.2f} p95 {percentile(partial_ms, 95):.2f} ms over "
        f"{len(partial_ms)} (server mode at real time); launches {launches} (model calls "
        f"{model_calls}) on {card}")
    if len(server_finals) < 2 or not all(isinstance(f.get("spk"), int) for f in server_finals):
        raise AssertionError(f"realtime server mode: finals {server_finals}")
    direct = [asr.generate(input=c.astype(np.float32) / 32768)[0]["text"] for c in commits]
    if [f["text"] for f in client_finals] != direct:
        raise AssertionError(f"realtime: COMMIT finals {[f['text'][:30] for f in client_finals]}"
                             f" differ from direct decodes {[t[:30] for t in direct]}")
    return dict(launches=launches, model_calls=model_calls, server_finals=len(server_finals),
                client_finals=len(client_finals), partial_p50_ms=percentile(partial_ms, 50),
                partial_p95_ms=percentile(partial_ms, 95), partials=len(partial_ms))


def unmask_ms(n, runs=5):
    """Host ms of ``WebSocket._read_frame`` over one masked n-byte client frame (126 <= n <
    65,536): the server unmasks each payload byte by byte in Python. Median of ``runs``."""
    import asyncio
    import struct
    from funasr_tpu_torch.serving.ws_protocol import WebSocket

    payload, mask = np.random.default_rng(0).bytes(n), b"\x12\x34\x56\x78"
    frame = (bytes([0x82, 0xFE]) + struct.pack(">H", n) + mask
             + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))

    async def read_once():
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        t0 = time.perf_counter()
        _, _, out = await WebSocket(reader, None)._read_frame()
        if out != payload:
            raise AssertionError("ws_protocol: a frame did not unmask to its payload")
        return (time.perf_counter() - t0) * 1e3

    return statistics.median(asyncio.run(read_once()) for _ in range(runs))


def phase_serving(dev, counters, card, keep):
    """Phase 13: the port's three servers on the card over real localhost sockets, in this
    process, at PROD_CONF width, fp32 (the public default), seeded weights: kernel rows at
    the serving shapes (``serving_kernel_rows``), the model-alone HTTP server and the
    server CLI's VAD + punctuation deployment (``serve_http_model``,
    ``serve_http_pipeline``), the 2-pass WebSocket server (``serve_two_pass``) and the
    realtime WebSocket server (``serve_realtime``), over the model dirs SERVE_ROLES of
    ``keep`` (phases 8, 9 and 11 keep them). Each server's kernel counts are set to 0 just
    before its traffic and read just after it (``served``); the phase's launches are their
    sum."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(13)
    rows = serving_kernel_rows(dev, g)
    d = {role: keep[role] for role in SERVE_ROLES}
    log(f"serving: kernel rows in {time.perf_counter() - t0:.1f} s")
    from funasr_tpu_torch import AutoModel

    unmask = {n: unmask_ms(n) for n in (2 * SERVE_RT_FRAME, 2 * SERVE_2PASS_FRAME)}
    log("ws_protocol: reading one client frame, its per-byte unmask included: " + ", ".join(
        f"{n:,} bytes {ms:.3f} ms" for n, ms in unmask.items()) + " on the host")

    out = dict(rows=rows, unmask_ms=unmask)
    for name, run in (("http", serve_http_model), ("http_pipeline", serve_http_pipeline)):
        t1 = time.perf_counter()
        out[name] = run(d, counters, card)
        torch.cuda.empty_cache()
        log(f"serving: {name} in {time.perf_counter() - t1:.1f} s")
    # the WebSocket servers share the offline ASR (Paraformer + punctuation) and the VAD
    shared = (AutoModel(model=d["asr"], punc_model=d["punc"], device="cuda",
                        log_level="WARNING"),
              AutoModel(model=d["vad"], device="cuda", log_level="WARNING"))
    for name, run in (("two_pass", serve_two_pass), ("realtime", serve_realtime)):
        t1 = time.perf_counter()
        out[name] = run(d, counters, card, *shared)
        log(f"serving: {name} in {time.perf_counter() - t1:.1f} s")
    del shared
    torch.cuda.empty_cache()
    out["launches"] = {c.__name__: sum(out[srv]["launches"][c.__name__] for srv in SERVERS)
                       for c in counters}
    log(f"serving: launches over the four server runs {out['launches']}, "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return out


# ---- phase 14: LLM-based ASR --------------------------------------------------------------

# Fun-ASR-Nano at full width and depth: benchmarks/bench_zoo.py:104-108's SAN-M encoder (50 x
# 512, 4 heads, FFN 2048, k 11, input 560), the Linear adaptor (downsample 2, FFN 2048) and
# Qwen3-0.6B as Hugging Face publishes it (Qwen/Qwen3-0.6B config.json)
NANO_ENCODER = dict(output_size=512, attention_heads=4, linear_units=2048, num_blocks=50,
                    kernel_size=11, sanm_shfit=0, dropout_rate=0.0)
QWEN3_0_6B = dict(vocab_size=151936, hidden_size=1024, intermediate_size=3072,
                  num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
                  head_dim=128, qk_norm=True, tie_word_embeddings=True, rope_theta=1000000.0,
                  rms_norm_eps=1e-6)
NANO_FULL = dict(input_size=560, audio_encoder="SANMEncoder", audio_encoder_conf=NANO_ENCODER,
                 audio_adaptor="Linear",
                 audio_adaptor_conf=dict(downsample_rate=2, encoder_dim=512, llm_dim=1024,
                                         ffn_dim=2048),
                 llm_conf=QWEN3_0_6B)
# the CUDA-vs-CPU config: 2 encoder blocks at d 64, a 2-layer Qwen3 at d 128 (GQA 4 / 2)
NANO_SMALL = dict(NANO_FULL, audio_encoder_conf=dict(NANO_ENCODER, output_size=64,
                                                     linear_units=96, num_blocks=2),
                  audio_adaptor_conf=dict(downsample_rate=2, encoder_dim=64, llm_dim=128,
                                          ffn_dim=128),
                  llm_conf=dict(QWEN3_0_6B, vocab_size=1000, hidden_size=128,
                                intermediate_size=256, num_hidden_layers=2,
                                num_attention_heads=4, num_key_value_heads=2, head_dim=32))
LLM_SETTINGS = (("fp32", {}), ("bf16", dict(bf16=True)), ("w8a8", dict(quant="w8a8")))
LLM_BATCH = 16             # utterances of 15 s a generate
# a fixed-length decode: the random weights' ids never hit an EOS id past the vocabulary
LLM_CALL = dict(max_new_tokens=64, num_slots=LLM_BATCH,
                eos_token_ids=(QWEN3_0_6B["vocab_size"],))
LLM_VLLM_BATCH = 4
LLM_PROFILE_TOKENS = 8     # the profiled generate's new tokens and decode chunk (nano_run)
LLM_LOGIT_TOL = 1e-3       # fp32 logits, CUDA against the CPU: as PUNC_LOGIT_TOL
LLM_MARGIN_FACTOR = 10     # ids gated where the top-2 margin clears 10x the logit error
# Whisper-large-v3 at full width (d 1280, 20 heads, FFN 5120, 128 mels, vocab 51,866), its
# depth cut from 32 + 32 to 4 + 4 layers for the run's time limit
WHISPER_CONF = dict(encoder_layers=4, decoder_layers=4)
WHISPER_BATCH = 2          # utterances of 30 s
WHISPER_TOKENS = 32
WHISPER_PROMPT = [50258, 50259, 50360, 50364]  # <|startoftranscript|><|en|><|transcribe|>...
WHISPER_EOT = -1           # a fixed-length decode: an id the argmax never gives


class SmokeChatTokenizer:
    """The script's own tokenizer (it must run where ``transformers`` is absent): Qwen's ids
    for the ChatML specials, one id a character for the rest (its code point modulo
    150,000); ``decode`` gives one CJK character an id, so a text's length is its ids'."""
    SPECIAL = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645}

    def __init__(self, **kwargs):
        import re
        self._split = re.compile("(" + "|".join(re.escape(t) for t in self.SPECIAL) + ")")

    def encode(self, text):
        ids = []
        for piece in self._split.split(text):
            ids += ([self.SPECIAL[piece]] if piece in self.SPECIAL
                    else [ord(c) % 150000 for c in piece])
        return ids

    def decode(self, ids):
        return "".join(chr(0x4E00 + int(i) % 20000) for i in ids)

    def get_vocab_size(self):
        return QWEN3_0_6B["vocab_size"]


class SmokeWhisperTokenizer(SmokeChatTokenizer):
    sot_sequence = tuple(WHISPER_PROMPT)


def write_nano_dir(d, dev, conf=NANO_FULL):
    """A FunASRNano directory: config.yaml (``SmokeChatTokenizer``, WavFrontend with an
    identity am.mvn) and model.pt of a port model seeded on the card."""
    from funasr_tpu_torch import tables

    g = torch.Generator(device=dev).manual_seed(0)
    model = tables.model_classes["FunASRNano"](**conf, device=dev, generator=g)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, os.path.join(d, "model.pt"))
    with open(os.path.join(d, "am.mvn"), "w") as f:
        f.write(identity_cmvn(conf["input_size"]))
    write_config(d, dict(model="FunASRNano",
                         **{k: v for k, v in conf.items() if k != "input_size"},
                         frontend="WavFrontend",
                         frontend_conf=dict(FRONTEND_CONF, cmvn_file="am.mvn"),
                         tokenizer="SmokeChatTokenizer"))
    del model
    torch.cuda.empty_cache()


def llm_kernel_rows(dev, g, t, lens):
    """Flash (B, 4, T, 128) and FSMN (11, 5) at (B, T, 512) on the v slice, fp32 and
    bf16, at Fun-ASR-Nano's encoder shapes: B = len(lens) utterances whose features the
    frontend pads to T frames (its waveform bucket), ``lens`` valid each. Raises on a
    disagreement."""
    b, h, d = len(lens), 4, 128
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rows[("flash_attention", "llm", dtype)] = flash_row(q, k, v, lens)
        x = torch.randn(b, t, 3 * 512, generator=g).to(dev, dtype)[..., 2 * 512:]
        w = (torch.rand(512, 1, 11, generator=g) - 0.5).to(dev, dtype)
        rows[("fsmn_memory", "llm", dtype)] = fsmn_row(
            x, w, torch.arange(t, device=dev)[None] < torch.tensor(lens, device=dev)[:, None],
            5, 5)
    for key, row in rows.items():
        tol = (FLASH_TOL if key[0] == "flash_attention" else FSMN_TOL)[key[2]]
        log(f"{key[0]} llm {row['shape']} {str(key[2])[6:]}: max_abs_err "
            f"{row['max_abs_err']:.3e} (tol {tol:g}) " + timing_line(row))
        if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= tol):
            raise AssertionError(f"{key} kernel disagrees: {row['max_abs_err']}")
    return rows


@contextlib.contextmanager
def w8a8_shapes():
    """Yields a set that gathers (M, K, N, x dtype, bias dtype or None) of every W8A8
    launch through ``ops/quant.py::qlinear``, the path's only caller of the wrapper,
    while the block runs."""
    from funasr_tpu_torch.ops import quant

    inner, seen = quant.w8a8_linear, set()

    def recorded(x, w_q8, scale, bias=None):
        seen.add((x.numel() // x.shape[-1], x.shape[-1], w_q8.shape[0], x.dtype,
                  None if bias is None else bias.dtype))
        return inner(x, w_q8, scale, bias)

    quant.w8a8_linear = recorded
    try:
        yield seen
    finally:
        quant.w8a8_linear = inner


def llm_w8a8_rows(dev, shapes):
    """One W8A8 row (``w8a8_row``: bit-exact against the plain version) at each (M, K, N,
    x dtype, bias dtype) of ``shapes``, as the W8A8 run launched them: random int8 weights
    and scales, a bias where the launch had one, the last row zero."""
    g = torch.Generator(device=dev).manual_seed(14)
    rows = {}
    for m, k, n, dtype, bias_dtype in shapes:
        w_q8 = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(n, generator=g, device=dev) * 1e-3
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        x[-1] = 0
        bias = (None if bias_dtype is None
                else torch.randn(n, generator=g, device=dev).to(bias_dtype))
        rows[("w8a8_linear", "llm", (m, k, n, dtype, bias_dtype))] = w8a8_row(
            x, w_q8, scale, bias, label="w8a8 llm path")
    return rows


def w8a8_label(shape):
    """A W8A8 row's label in the kernels line, e.g. "4624x512x1536_float32_bias"."""
    m, k, n, dtype, bias_dtype = shape
    return f"{m}x{k}x{n}_{str(dtype)[6:]}" + ("" if bias_dtype is None else "_bias")


def count_w8a8(module):
    from funasr_tpu_torch.ops.quant import Int8Linear
    return sum(isinstance(m, Int8Linear) and m.key == "w_q8" for m in module.modules())


def llm_sites(model, enc_calls, llm_calls):
    """Launches each kernel must make: flash and FSMN at the encoder's sites a call, W8A8
    at every W8A8 linear of the encoder and adaptor a call and of the LLM's 28 layers a
    forward (the vocab head is the tied table, no linear)."""
    sites = {k: n * enc_calls for k, n in kernel_sites(model.audio_encoder).items()}
    sites["w8a8_linear"] = ((count_w8a8(model.audio_encoder) + count_w8a8(model.audio_adaptor))
                            * enc_calls + count_w8a8(model.llm) * llm_calls)
    return sites


def device_loop_lines():
    """(file, first line, last line) of the functions a decode step runs on the device:
    ``sync_points`` must find no host wait in them."""
    import inspect

    from funasr_tpu_torch.llm import engine
    from funasr_tpu_torch.models.llm import qwen

    spans = []
    for fn in (qwen.rms_norm, qwen.rope_tables, qwen.apply_rope, qwen.step_tables,
               qwen.QwenAttention.forward, qwen.QwenMLP.forward, qwen.QwenDecoderLayer.forward,
               qwen.QwenLM.forward_hidden, qwen.QwenLM.logits_head,
               engine.LLMEngine._decode_multi):
        lines, first = inspect.getsourcelines(fn)
        spans.append((os.path.basename(inspect.getsourcefile(fn)), first, first + len(lines)))
    return spans


def nano_run(am, batch, counters, card, label, seconds):
    """One setting of Fun-ASR-Nano through ``am.generate`` (16 x 15 s, 64 new tokens each),
    one counted and timed call (the engine built before it with the call's slots, so that
    its steps are timed too), the shapes of its W8A8 launches recorded (``w8a8_shapes``,
    for ``llm_w8a8_rows``). Gates: keyed texts of 64 tokens; each kernel's launches
    exactly at its sites x calls (``llm_sites``); no host wait inside the decode step
    (``device_loop_lines``; fp32). Prints RTFx, decode tokens/s over the engine's steps,
    engine steps and host fetches; device ms and the idle share of one profiled
    ``generate`` of LLM_PROFILE_TOKENS new tokens with the engine's decode chunk at
    LLM_PROFILE_TOKENS too (10 LLM forwards where 64 tokens take 66, the same steps: the
    profiler's processing of a whole call took ~40 s, of a 32-token one 12-17 s)."""
    keys = [f"utt{i}" for i in range(len(batch))]
    model = am.model
    enc_calls = forward_counter(model.audio_encoder)
    llm_calls = forward_counter(model.llm.model.layers[0])
    engine = model.engine(num_slots=LLM_CALL["num_slots"])
    step_ms = []
    inner_step = engine.step

    def timed_step():
        t0 = time.perf_counter()
        out = inner_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.step = timed_step
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    try:
        with w8a8_shapes() as shapes:
            t_med = time.perf_counter()
            results = am.generate(input=batch, key=keys, **LLM_CALL)
            torch.cuda.synchronize()
            t_med = (time.perf_counter() - t_med) * 1e3
    finally:
        del engine.step
    launches = {c.__name__: c.launches for c in counters}
    n_enc, n_llm = len(enc_calls), len(llm_calls)
    sites = llm_sites(model, n_enc, n_llm)
    steps, fetches = engine.n_steps, engine.n_syncs
    tokens = sum(len(r["text"]) for r in results)
    llm_ms = sum(step_ms)
    syncs, in_loop = {}, []
    short = dict(LLM_CALL, max_new_tokens=LLM_PROFILE_TOKENS)
    chunk, engine.decode_chunk = engine.decode_chunk, LLM_PROFILE_TOKENS
    try:
        if label == "fp32":
            syncs = sync_points(lambda: am.generate(input=batch, key=keys, **short))
            spans = device_loop_lines()
            in_loop = [line for line in syncs if any(
                line.split(":")[0] == f and a <= int(line.split(":")[1]) < b
                for f, a, b in spans)]
        t_short, _ = wall_ms(lambda: am.generate(input=batch, key=keys, **short), runs=1)
        by_name = profile_once(lambda: am.generate(input=batch, key=keys, **short),
                               f"Fun-ASR-Nano {label} generate of {LLM_PROFILE_TOKENS} tokens",
                               t_short)
    finally:
        engine.decode_chunk = chunk
    device = sum(ms for ms, _ in by_name.values())
    profiled = {name: kernel_totals(by_name, key) for name, key in (
        ("flash_attention", "flash_"), ("fsmn_memory", "fsmn_kernel"),
        ("w8a8_linear", "quantize_rows_kernel"))}
    stats = dict(launches=launches, sites=sites, encoder_calls=n_enc, llm_forwards=n_llm,
                 wall_ms=t_med, rtfx=len(batch) * seconds * 1e3 / t_med, tokens=tokens,
                 llm_steps_ms=llm_ms, decode_tokens_per_s=tokens / llm_ms * 1e3,
                 engine_steps=steps, host_fetches=fetches, sync_lines=dict(syncs),
                 w8a8_shapes=sorted(shapes, key=str),
                 profile_tokens=LLM_PROFILE_TOKENS, profile_wall_ms=t_short, device_ms=device,
                 idle_share=1 - device / t_short,
                 profile={name: dict(ms=ms, launches=n) for name, (ms, n) in profiled.items()})
    log(f"Fun-ASR-Nano {label} B={len(batch)} x {seconds:g} s, {LLM_CALL['max_new_tokens']} "
        f"new tokens: generate {t_med:.2f} ms, RTFx {stats['rtfx']:.1f}; {tokens} tokens over "
        f"{steps} engine "
        f"steps ({llm_ms:.2f} ms, {stats['decode_tokens_per_s']:.1f} tokens/s), {fetches} host "
        f"fetches; {n_enc} encoder calls, {n_llm} LLM forwards; launches {launches} (sites x "
        f"calls {sites}); {LLM_PROFILE_TOKENS} tokens: wall {t_short:.2f} ms, device "
        f"{device:.2f} ms, idle share {stats['idle_share']:.1%}, profile {stats['profile']}; "
        f"host waits {dict(syncs)} on {card}")
    if [r["key"] for r in results] != keys or not all(
            len(r["text"]) == LLM_CALL["max_new_tokens"] for r in results):
        raise AssertionError(f"Fun-ASR-Nano {label}: expected {len(keys)} keyed texts of "
                             f"{LLM_CALL['max_new_tokens']} tokens: "
                             f"{[(r['key'], len(r['text'])) for r in results]}")
    if launches != sites or not all(sites[k] for k in ("flash_attention", "fsmn_memory")):
        raise AssertionError(f"Fun-ASR-Nano {label}: launches {launches}, expected {sites}")
    if in_loop:
        raise AssertionError(f"Fun-ASR-Nano {label}: the decode step waits for the device at "
                             f"{in_loop}")
    return stats


def nano_cuda_vs_cpu(dev):
    """NANO_SMALL on the card against its copy on the CPU (fp32, engine in fp32), 2 x 15 s
    on the same host features: the audio rows within CPU_GPU_ENC_TOL, the LLM's logits over
    the assembled prompt within LLM_LOGIT_TOL, and the card's greedy ids (16 new tokens)
    equal to the CPU's argmax over the same teacher-forced sequence on every step up to
    the first whose top-2 margin does not clear LLM_MARGIN_FACTOR x the logit error."""
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
    from funasr_tpu_torch.llm.engine import LLMEngine
    from funasr_tpu_torch.models.fun_asr_nano.model import assemble_prompts

    g = torch.Generator().manual_seed(5)
    cpu = tables.model_classes["FunASRNano"](**NANO_SMALL, generator=g).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    waves = [pcm(np.random.default_rng(21 + i), 15.0) for i in range(2)]
    feats, flens = WavFrontend(**FRONTEND_CONF).extract(waves)
    tok = SmokeChatTokenizer()
    prefix_ids, suffix_ids = cpu.build_chatml_ids(tok, cpu.get_prompt())
    out = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        with torch.no_grad():
            audio, lens = m.encode_audio(torch.from_numpy(feats).to(m.device),
                                         torch.from_numpy(flens).to(m.device))
            prompts = assemble_prompts(m.llm.embed(prefix_ids, torch.float32), audio, lens,
                                       m.llm.embed(suffix_ids, torch.float32))
            logits = m.llm.forward_embeds(prompts)
        out[name] = (audio.cpu(), logits.cpu(), prompts, lens.cpu().numpy())
    enc_err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    logit_err = (out["cpu"][1] - out["cuda"][1]).abs().max().item()
    prompts, lens = out["cuda"][2], out["cuda"][3]
    engine = LLMEngine(gpu.llm, num_slots=2, max_len=1024, dtype=torch.float32)
    p_lens = len(prefix_ids) + lens + len(suffix_ids)
    reqs = engine.submit_prompt_batch(prompts, p_lens, max_new_tokens=16)
    while any(not r.done for r in reqs):
        if not engine.step():
            break
    held = total = 0
    for i, r in enumerate(reqs):  # the CPU's argmax along the card's own ids
        seq = torch.cat([out["cpu"][2][i, :p_lens[i]],
                         cpu.llm.embed(r.output_ids[:-1], torch.float32)])
        with torch.no_grad():
            rows = cpu.llm.forward_embeds(seq[None])[0, p_lens[i] - 1:]
        top2 = rows.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LLM_MARGIN_FACTOR * logit_err
        for step, tok_id in enumerate(r.output_ids):
            if not clear[step]:
                break
            if int(rows[step].argmax()) != tok_id:
                raise AssertionError(f"LLM CUDA vs CPU: row {i} step {step}: the card's id "
                                     f"{tok_id}, the CPU's {int(rows[step].argmax())}")
            held += 1
        total += len(r.output_ids)
    log(f"Fun-ASR-Nano CUDA vs CPU (2 + 2 blocks d 64, Qwen3 2 layers d 128, fp32): audio rows "
        f"max abs {enc_err:.3e} (tol {CPU_GPU_ENC_TOL:g}), prompt logits max abs "
        f"{logit_err:.3e} (tol {LLM_LOGIT_TOL:g}), greedy ids equal on {held} of {total} "
        f"tokens (gated where the top-2 margin clears {LLM_MARGIN_FACTOR}x the logit error)")
    if not (enc_err <= CPU_GPU_ENC_TOL and logit_err <= LLM_LOGIT_TOL and held > 0):
        raise AssertionError(f"LLM CUDA vs CPU: audio {enc_err}, logits {logit_err}, held "
                             f"{held}")
    return dict(audio_max_abs=enc_err, logit_max_abs=logit_err, ids_held=held, ids=total)


def whisper_run(dev, card):
    """Whisper-large-v3 at full width, depth cut to WHISPER_CONF, seeded, through
    ``AutoModel(model="Whisper-large-v3")``: 2 x 30 s, 32 tokens by the cached greedy decode.
    Gates: 2 texts of 32 tokens; the cached decode's ids equal to the prefix-recompute
    oracle's on the same encoder output. Prints RTFx, wall, device ms, idle share."""
    from funasr_tpu_torch import AutoModel

    t0 = time.perf_counter()
    am = AutoModel(model="Whisper-large-v3", model_conf={}, **WHISPER_CONF,
                   frontend="WhisperFrontend", frontend_conf=dict(n_mels=128),
                   tokenizer=SmokeWhisperTokenizer(), device="cuda", log_level="WARNING")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(30)
    batch = [pcm(rng, 30.0) for _ in range(WHISPER_BATCH)]
    call = dict(max_new_tokens=WHISPER_TOKENS, batch_size=WHISPER_BATCH, eot_id=WHISPER_EOT)
    am.generate(input=batch, **call)  # warm-up
    results = am.generate(input=batch, **call)
    t_med, times = wall_ms(lambda: am.generate(input=batch, **call), runs=2)
    by_name = profile_once(lambda: am.generate(input=batch, **call), "Whisper generate", t_med)
    device = sum(ms for ms, _ in by_name.values())
    m = am.model
    mel, _ = am.kwargs["frontend"].extract(batch, device=dev)
    with torch.no_grad():
        enc, _ = m.encode(mel)
    cached = m.greedy_decode(enc, WHISPER_PROMPT, WHISPER_EOT, WHISPER_TOKENS)
    oracle = m.greedy_decode_prefix(enc, WHISPER_PROMPT, WHISPER_EOT, WHISPER_TOKENS)
    stats = dict(wall_ms=t_med, walls=times, rtfx=WHISPER_BATCH * 30e3 / t_med,
                 device_ms=device, idle_share=1 - device / t_med, build_s=build_s,
                 cached_equals_oracle=cached == oracle)
    log(f"Whisper-large-v3 ({WHISPER_CONF['encoder_layers']} + {WHISPER_CONF['decoder_layers']} "
        f"layers, d {m.cfg.d_model}) B={WHISPER_BATCH} x 30 s, {WHISPER_TOKENS} tokens: generate "
        f"median {t_med:.2f} ms (runs {[round(x, 2) for x in times]}), RTFx {stats['rtfx']:.1f}, "
        f"device {device:.2f} ms, idle share {stats['idle_share']:.1%}; built in {build_s:.1f} s; "
        f"cached decode = prefix oracle: {cached == oracle} on {card}")
    if not (len(results) == WHISPER_BATCH and all(len(r["text"]) == WHISPER_TOKENS
                                                  for r in results) and cached == oracle):
        raise AssertionError(f"Whisper: texts {[len(r['text']) for r in results]}, cached "
                             f"{cached} vs oracle {oracle}")
    return stats


def phase_llm(dev, counters, card):
    """Phase 14: Fun-ASR-Nano at full width (``NANO_FULL``: the 50-block SAN-M, the Linear
    adaptor, Qwen3-0.6B) through ``AutoModel(model=dir).generate`` on 16 x 15 s, 64 new
    tokens, at fp32 (the default), ``bf16=True`` and ``quant="w8a8"`` (``nano_run``) and
    ``AutoModelVLLM.generate`` once; kernel rows at the path's new shapes
    (``llm_kernel_rows``); the CUDA port against the CPU port at NANO_SMALL
    (``nano_cuda_vs_cpu``); Whisper-large-v3 at full width, depth cut (``whisper_run``).
    Returns its figures."""
    from funasr_tpu_torch import AutoModel, tables
    from funasr_tpu_torch.auto.auto_model_vllm import AutoModelVLLM

    t0 = time.perf_counter()
    tables.register("tokenizer_classes", "SmokeChatTokenizer")(SmokeChatTokenizer)
    rng = np.random.default_rng(14)
    batch = [pcm(rng, 15.0) for _ in range(LLM_BATCH)]
    # the encoder's (B, T) as the path's frontend gives it: T padded, the valid lengths
    feats, flens = tables.frontend_classes["WavFrontend"](**FRONTEND_CONF).extract(batch,
                                                                                 device=dev)
    out = {"rows": llm_kernel_rows(dev, torch.Generator().manual_seed(14), feats.shape[1],
                                   flens.tolist())}
    del feats
    log(f"LLM: kernel rows in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        write_nano_dir(d, dev)
        log(f"LLM: Fun-ASR-Nano dir written in {time.perf_counter() - t1:.1f} s")
        for label, extra in LLM_SETTINGS:
            t1 = time.perf_counter()
            am = AutoModel(model=d, device="cuda", batch_size=LLM_BATCH, log_level="WARNING",
                           **extra)
            log(f"LLM: AutoModel {label} built in {time.perf_counter() - t1:.1f} s")
            out[label] = nano_run(am, batch, counters, card, label, 15.0)
            del am
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out["rows"].update(llm_w8a8_rows(dev, out["w8a8"]["w8a8_shapes"]))
        log(f"LLM: W8A8 rows at the {len(out['w8a8']['w8a8_shapes'])} shapes of the W8A8 run "
            f"in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        vllm = AutoModelVLLM(model=d, device="cuda", max_num_seqs=LLM_BATCH, log_level="WARNING")
        enc_calls = forward_counter(vllm.model.audio_encoder)
        llm_calls = forward_counter(vllm.model.llm.model.layers[0])
        for c in counters:
            c.launches = 0
        res = vllm.generate(batch[:LLM_VLLM_BATCH], max_new_tokens=LLM_CALL["max_new_tokens"],
                            eos_token_ids=LLM_CALL["eos_token_ids"])
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        sites = llm_sites(vllm.model, len(enc_calls), len(llm_calls))
        out["vllm"] = dict(launches=launches, sites=sites, encoder_calls=len(enc_calls),
                           llm_forwards=len(llm_calls), seconds=time.perf_counter() - t1)
        log(f"LLM: AutoModelVLLM.generate {LLM_VLLM_BATCH} x 15 s (built and run in "
            f"{out['vllm']['seconds']:.1f} s): texts {[len(r['text']) for r in res]} tokens, "
            f"{len(enc_calls)} encoder calls, {len(llm_calls)} LLM forwards, launches "
            f"{launches} (sites x calls {sites})")
        if len(res) != LLM_VLLM_BATCH or not all(r["text"] for r in res) or launches != sites \
                or not all(sites[k] for k in ("flash_attention", "fsmn_memory")):
            raise AssertionError(f"AutoModelVLLM: {res}, {out['vllm']}")
        del vllm
        torch.cuda.empty_cache()
    out["cuda_vs_cpu"] = nano_cuda_vs_cpu(dev)
    out["whisper"] = whisper_run(dev, card)
    torch.cuda.empty_cache()
    out["launches"] = {c.__name__: sum(out[label]["launches"][c.__name__]
                                       for label, _ in LLM_SETTINGS)
                       + out["vllm"]["launches"][c.__name__] for c in counters}
    log(f"LLM: launches over the three AutoModel runs and AutoModelVLLM {out['launches']}, "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return out


# ---- phase 15: text normalization and export ---------------------------------------------

EXPORT_BUCKETS = [(4, 168), (32, 384)]  # AutoModel.export at fp32: the JAX default, then B 32
EXPORT_W8A8_BUCKETS = [(32, 384)]       # and under quant="w8a8"
# each bucket's transcribed waves: 9 s give 150 frames (the 168-frame program), 15 s give
# 250 (the 384-frame program: eager generate pads 15 s to 384 frames as well)
EXPORT_WAVE_SECONDS = {(4, 168): 9.0, (32, 384): 15.0}
EXPORT_SCORE_TOL = 1e-6  # the program's score against eager infer_core's, same device
# the program also timed as ``program.module()`` runs it (the weights flattened and checked
# on every call, an assert before each dtype cast), against ``bind_weights``' call
EXPORT_UNBOUND = ("fp32", (4, 168))
# the numerals that ITN rewrites, first in the phase's token list; the output heads' biases
# at their ids are lifted by NUMBER_LIFT (a unit-RMS input through a uniform(+-1/sqrt(d))
# head gives logits of std ~0.58) so that seeded decodes emit numerals for ITN to rewrite
NUMBER_CHARS = "零一二三四五六七八九十百千万亿两点"
NUMBER_LIFT = 2.0
ITN_SV_BATCH = 8                        # SenseVoice utterances of 15 s in the ITN check
MCP_ITN = ("三百二十五", "325")         # the MCP inverse_normalize call and its answer


def number_tokens(n=None):
    """A PROD_CONF token list (``n`` tokens, the vocabulary by default) with the numerals
    first (ids 3-20), then other CJK characters."""
    n = n or PROD_CONF["vocab_size"]
    rest = [c for c in map(chr, range(0x4E00, 0x4E00 + n + len(NUMBER_CHARS)))
            if c not in NUMBER_CHARS]
    return (["<blank>", "<s>", "</s>"] + list(NUMBER_CHARS)
            + rest[:n - 4 - len(NUMBER_CHARS)] + ["<unk>"])


def lift_numerals(linear, tokens):
    """Add NUMBER_LIFT to the output head ``linear``'s bias at the numerals' ids."""
    ids = [i for i, tok in enumerate(tokens) if tok in NUMBER_CHARS]
    with torch.no_grad():
        linear.bias[ids] += NUMBER_LIFT


def op_dispatch_rows(dev):
    """A lone call's ms (``call_ms``, host work included) through each kernel's custom op
    against the wrapper's direct call, same inputs, same kernel, outputs equal: flash and
    FSMN at the main path's fp32 shapes, W8A8 at a Qwen3 decode step (M = 16, bf16), where
    the host paces the kernel. The op's dispatch is why eager calls go direct."""
    from funasr_tpu_torch.ops import flash_attention as fa
    from funasr_tpu_torch.ops import fsmn, w8a8

    g = torch.Generator().manual_seed(15)
    q = torch.randn(32, 4, 384, 128, generator=g).to(dev)
    lens = torch.full((32,), 384, dtype=torch.int32, device=dev)
    x = torch.randn(32, 384, 512, generator=g).to(dev)
    w = (torch.rand(512, 1, 11, generator=g) - 0.5).to(dev)
    mask = torch.ones(32, 384, dtype=torch.bool, device=dev)
    xq = torch.randn(16, 1024, generator=g).to(dev, torch.bfloat16)
    wq = torch.randint(-127, 128, (2048, 1024), generator=g, dtype=torch.int8).to(dev)
    sq = torch.rand(2048, generator=g).to(dev)
    cases = {"flash_attention": (lambda: fa.flash_attention(q, q, q, lens),
                                 lambda: fa.flash_attention_op(q, q, q, lens, "none", None)),
             "fsmn_memory": (lambda: fsmn.fsmn_memory(x, w, mask, 5, 5),
                             lambda: fsmn.fsmn_memory_op(x, w, mask, 5, 5, False)),
             "w8a8_linear": (lambda: w8a8.w8a8_linear(xq, wq, sq),
                             lambda: w8a8.w8a8_linear_op(xq, wq, sq, None))}
    rows = {}
    for name, (direct, op) in cases.items():
        equal = torch.equal(direct(), op())
        rows[name] = dict(direct_call_ms=call_ms(direct), op_call_ms=call_ms(op))
        log(f"{name} lone call: direct {rows[name]['direct_call_ms']:.4f} ms, through the "
            f"custom op {rows[name]['op_call_ms']:.4f} ms; outputs equal {equal}")
        if not equal:
            raise AssertionError(f"{name}: the custom op's output is not the wrapper's")
    return rows


def itn_check(am, waves, label, counters, sites, **call):
    """``am.generate(itn=True)`` against the port's ``InverseNormalizer`` over the texts of
    ``am.generate()`` on the same waves, one decode each. Gates: equal texts, at least one
    rewritten, the ITN decode's launches (counts set to 0 just before it) exactly
    ``sites``. Returns its figures."""
    from funasr_tpu_torch.text.inverse_normalize import InverseNormalizer

    call = dict(call, batch_size=len(waves))
    plain = [r["text"] for r in am.generate(input=waves, **call)]
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    got = [r["text"] for r in am.generate(input=waves, itn=True, **call)]
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    inv = InverseNormalizer(lang=call.get("language", "zh")[:2])
    t0 = time.perf_counter()
    want = [inv.inverse_normalize(text) for text in plain]
    host_ms = (time.perf_counter() - t0) * 1e3
    rewritten = [i for i, (w, p) in enumerate(zip(want, plain)) if w != p]
    numerals = sum(ch in NUMBER_CHARS for text in plain for ch in text)
    log(f"ITN {label} B={len(waves)}: {len(rewritten)} of {len(plain)} texts rewritten "
        f"(numerals {numerals} of {sum(map(len, plain))} characters; ITN on the host "
        f"{host_ms:.2f} ms); e.g. {plain[rewritten[0]][:40] if rewritten else ''!r} -> "
        f"{got[rewritten[0]][:40] if rewritten else ''!r}; launches {launches} (sites {sites})")
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"ITN {label}: generate(itn=True) text {bad} {got[bad]!r} is not "
                             f"InverseNormalizer's {want[bad]!r}")
    if not rewritten or launches != sites:
        raise AssertionError(f"ITN {label}: {len(rewritten)} texts rewritten; launches "
                             f"{launches}, expected {sites}")
    return dict(rewritten=rewritten, texts=len(plain), numerals=numerals, host_ms=host_ms,
                launches=launches)


def kernel_signature(name, *args):
    """(key, inputs) of one call of a kernel's custom op: ``key`` the shape it launches at
    (dtype, shapes, strides and the op's other arguments; W8A8's (M, K, N, x dtype, bias
    dtype)), ``inputs`` the small tensors that set its limits (flash's lengths and
    vad_pos, FSMN's mask), copied to the CPU."""
    if name == "flash_attention":
        q, k, v, lengths, mode, vad_pos = args
        return ((name, q.dtype, tuple(q.shape), tuple(k.shape),
                 tuple(x.stride() for x in (q, k, v)), mode),
                dict(lengths=lengths.cpu(), vad_pos=None if vad_pos is None else vad_pos.cpu()))
    if name == "fsmn_memory":
        x, w, mask, left, right, generic = args
        return ((name, x.dtype, tuple(x.shape), x.stride(), w.shape[-1], left, right, generic,
                 mask is None), dict(mask=None if mask is None else mask.cpu()))
    x, w_q8, scale, bias = args
    return (name, (x.numel() // x.shape[-1], x.shape[-1], w_q8.shape[0], x.dtype,
                   None if bias is None else bias.dtype)), {}


class KernelShapes(TorchDispatchMode):
    """While this mode is on, every call of the kernels' custom ops (an exported program's
    launches) is counted by the shape it launches at (``kernel_signature``): ``seen``
    maps each key to its calls, ``inputs`` to its first call's small tensors."""

    def __init__(self):
        super().__init__()
        from funasr_tpu_torch.ops import flash_attention, fsmn, w8a8  # noqa: F401 (the ops)

        ops = torch.ops.funasr_tpu_torch
        self.ops = {ops.flash_attention.default: "flash_attention",
                    ops.fsmn_memory.default: "fsmn_memory",
                    ops.w8a8_linear.default: "w8a8_linear"}
        self.seen, self.inputs = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = self.ops.get(func)
        if name is not None:
            schema = func._schema.arguments
            key, inputs = kernel_signature(name, *args, *(
                kwargs.get(a.name, a.default_value) for a in schema[len(args):]))
            self.seen[key] = self.seen.get(key, 0) + 1
            self.inputs.setdefault(key, inputs)
        return func(*args, **kwargs)


def export_label(key):
    """A row's label in the kernels line: flash "4x4x168x128_float32", FSMN
    "4x168x512_k11_float32", W8A8 ``w8a8_label``."""
    if key[0] == "w8a8_linear":
        return w8a8_label(key[1])
    shape = "x".join(map(str, key[2]))
    if key[0] == "flash_attention":
        return f"{shape}_{str(key[1])[6:]}" + ("" if key[5] == "none" else f"_{key[5]}")
    return f"{shape}_k{key[4]}_{str(key[1])[6:]}"


def strided_randn(shape, stride, dtype, g, dev):
    """Random values at ``shape`` laid out with ``stride``: a view into a larger buffer
    where the strides leave gaps, as a head split out of a fused projection is."""
    size = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    return torch.randn(size, generator=g, device=dev).to(dtype).as_strided(shape, stride)


def export_kernel_rows(dev, shapes):
    """One row per shape that the exported programs' counted calls launched
    (``KernelShapes``), each against its plain version with its tolerance: flash and FSMN
    with random values at the program's own shapes and strides and its own lengths and
    mask (``flash_row``, ``fsmn_row``); W8A8 bit-exact at the program's (M, K, N)
    (``w8a8_row``). ``shapes``: {key: {"inputs", "programs": {program: launches}}}.
    Returns {kernel: {label: row with its launches by program}}; raises on a
    disagreement."""
    g = torch.Generator(device=dev).manual_seed(15)
    rows = {}
    for key, info in shapes.items():
        name, inputs = key[0], info["inputs"]
        if name == "flash_attention":
            _, dtype, q_shape, k_shape, strides, mode = key
            q, k, v = (strided_randn(shape, st, dtype, g, dev)
                       for shape, st in zip((q_shape, k_shape, k_shape), strides))
            vp = inputs["vad_pos"]
            row = flash_row(q, k, v, inputs["lengths"].tolist(), mode,
                            None if vp is None else vp.tolist())
            tol = FLASH_TOL[dtype]
        elif name == "fsmn_memory":
            _, dtype, x_shape, x_stride, k, left, right, generic, _ = key
            if generic:
                raise AssertionError("an exported program launched the generic FSMN kernel")
            x = strided_randn(x_shape, x_stride, dtype, g, dev)
            w = (torch.rand(x_shape[-1], 1, k, generator=g, device=dev) - 0.5).to(dtype)
            mask = None if inputs["mask"] is None else inputs["mask"].to(dev)
            row = fsmn_row(x, w, mask, left, right)
            tol = FSMN_TOL[dtype]
        else:
            m, k, n, dtype, bias_dtype = key[1]
            w_q8 = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
            scale = torch.rand(n, generator=g, device=dev) * 1e-3
            x = torch.randn(m, k, generator=g, device=dev).to(dtype)
            bias = (None if bias_dtype is None
                    else torch.randn(n, generator=g, device=dev).to(bias_dtype))
            row = w8a8_row(x, w_q8, scale, bias, label="w8a8 exported program")
            tol = W8A8_TOL
        if name != "w8a8_linear":
            log(f"{name} exported program {export_label(key)}: max_abs_err "
                f"{row['max_abs_err']:.3e} (tol {tol:g}) " + timing_line(row)
                + f"; launches a call {info['programs']}")
        if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= tol):
            raise AssertionError(f"{name} kernel disagrees at the exported program's "
                                 f"{export_label(key)}: {row['max_abs_err']}")
        label, by_name = export_label(key), rows.setdefault(name, {})
        while label in by_name:  # the same shape at other strides
            label += "'"
        by_name[label] = dict(row, launches_per_call=info["programs"])
    return rows


def export_inputs(bucket, seed):
    """Seeded (B, T, 560) features and ragged (B,) lengths for a bucket's program."""
    b, t = bucket
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([t - (17 * i) % (t // 2) for i in range(b)], dtype=torch.int32)
    return torch.randn(b, t, PROD_CONF["input_size"], generator=g), lengths


def export_setting(am, out_dir, buckets, waves, label, dev):
    """``am.export`` of one setting at ``buckets``, and the eager references its programs
    are held to: each bucket's ``infer_core(...)[:3]`` on seeded features and
    ``generate``'s texts on the bucket's waves. Returns them with the trace seconds and
    the directory's bytes by file."""
    t0 = time.perf_counter()
    functions = am.export(output_dir=out_dir, buckets=buckets)
    seconds = time.perf_counter() - t0
    size = {f: os.path.getsize(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))}
    calls = []
    for i, bucket in enumerate(buckets):
        speech, lengths = export_inputs(bucket, i)
        sp, ln = speech.to(dev), lengths.to(dev)
        with torch.inference_mode():
            eager = am.model.infer_core(sp, ln, am.model._max_tokens_for(bucket[1]))[:3]
        calls.append(dict(bucket=bucket, speech=speech, lengths=lengths,
                          eager=[x.cpu() for x in eager]))
    texts = {b: [r["text"] for r in am.generate(input=waves[b], batch_size=b[0])]
             for b in buckets}
    log(f"export {label}: AutoModel.export in {seconds:.1f} s, traces "
        f"{ {f['file']: f['trace_s'] for f in functions} } s; directory "
        f"{sum(size.values())} bytes {size}")
    return dict(dir=out_dir, seconds=seconds, functions=functions, bytes=size, calls=calls,
                texts=texts, waves={b: waves[b] for b in buckets})


def eager_ms(am, setting, dev):
    """Each bucket's eager ``infer_core``: wall ms (median of 5) and the device's kernel ms
    of one profiled call, into ``setting``'s calls."""
    for call in setting["calls"]:
        sp, ln = call["speech"].to(dev), call["lengths"].to(dev)
        mt = am.model._max_tokens_for(call["bucket"][1])
        with torch.inference_mode():
            call["eager_ms"] = wall_ms(lambda: am.model.infer_core(sp, ln, mt))[0]
            call["eager_device_ms"] = device_total_ms(
                lambda: am.model.infer_core(sp, ln, mt))


def device_total_ms(fn):
    """The device's kernel ms over one call of ``fn``, from torch.profiler."""
    return sum(t for t, _ in profile_kernels(fn).values())


def exported_child(io_path):
    """``python3 chip_smoke.py --exported <io.pt>``, in a process of its own: loads each
    export directory of ``io.pt`` with ``ExportedModel`` (and EXPORT_UNBOUND's program as
    ``program.module()``), waits for ``<io.pt>.go`` (the parent's device work done), calls
    each bucket's program on the parent's features (warm-up, then one call with the counts
    set to 0 just before it and read just after, the shapes of its launches recorded by
    ``KernelShapes``, then its wall ms and the device's kernel ms of one profiled call),
    and transcribes each bucket's waves, counted alike. Writes its figures to
    ``<io.pt>.out``, with the model modules the process imported (there must be none)."""
    from funasr_tpu_torch.export_runtime import ExportedModel
    from funasr_tpu_torch.ops.flash_attention import flash_attention
    from funasr_tpu_torch.ops.fsmn import fsmn_memory
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear

    counters = (flash_attention, fsmn_memory, w8a8_linear)
    io = torch.load(io_path, weights_only=False)
    dev = torch.device(io["device"])

    def counted(fn):
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {c.__name__: c.launches for c in counters}

    models, out = {}, {}
    for label, setting in io["settings"].items():
        t0 = time.perf_counter()
        models[label] = ExportedModel(setting["dir"], device=dev.type)
        out[label] = dict(load_s=time.perf_counter() - t0)
        log(f"{label}: loaded in {out[label]['load_s']:.1f} s")
    label, (b, t) = EXPORT_UNBOUND
    unbound = torch.export.load(os.path.join(io["settings"][label]["dir"],
                                             f"model_b{b}_t{t}.pt2")).module()
    while not os.path.exists(io_path + ".go"):
        time.sleep(0.05)
    for label, setting in io["settings"].items():
        em, calls = models.pop(label), []
        for call in setting["calls"]:
            sp, ln = call["speech"].to(dev), call["lengths"].to(dev)
            em(sp, ln)  # warm-up
            with KernelShapes() as shapes:
                res, launches = counted(lambda: em(sp, ln))
            calls.append(dict(out=[x.cpu() for x in res], launches=launches,
                              shapes=shapes.seen, inputs=shapes.inputs,
                              ms=wall_ms(lambda: em(sp, ln))[0],
                              device_ms=device_total_ms(lambda: em(sp, ln))))
            if (label, tuple(sp.shape[:2])) == EXPORT_UNBOUND:
                with torch.inference_mode():
                    same = all(torch.equal(x, y)
                               for x, y in zip(unbound(em.params, sp, ln), res))
                    calls[-1].update(unbound_equal=same, unbound_ms=wall_ms(
                        lambda: unbound(em.params, sp, ln))[0])
        transcribe = {}
        for bucket, waves in setting["waves"].items():
            texts, launches = counted(lambda: em.transcribe(waves))
            transcribe[bucket] = dict(texts=texts, launches=launches)
        out[label].update(calls=calls, transcribe=transcribe)
        log(f"{label}: program calls {[c['launches'] for c in calls]}")
        del em
    out["modules"] = sorted(m for m in sys.modules
                            if m.startswith("funasr_tpu_torch.models")
                            or m.split(".")[0] in ("jax", "funasr_tpu"))
    torch.save(out, io_path + ".out")


def exported_in_child(io_path):
    """Starts ``exported_child`` in a process of its own; returns a function that lets it
    run its calls, waits for it, relays its lines and returns its figures."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--exported", io_path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish():
        open(io_path + ".go", "w").close()
        stdout, stderr = proc.communicate(timeout=900)
        for line in stdout.strip().splitlines():
            log(f"  export process: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"the export process exited with {proc.returncode}: "
                                 f"{stderr[-3000:]}")
        return torch.load(io_path + ".out", weights_only=False)
    return finish


def check_exported(label, setting, got, sites, card):
    """Gates one setting's programs: launches of each call and each transcription exactly
    ``sites``, ids and token counts equal to eager ``infer_core``'s, the score within
    ``EXPORT_SCORE_TOL``, texts equal to ``generate``'s, every launch of a counted call
    at a recorded shape, and EXPORT_UNBOUND's ``program.module()`` call equal to the
    bound one. Returns its figures, with each call's shapes under ``shapes``: {key:
    {"inputs", "programs": {program: launches}}}."""
    calls, shapes = [], {}
    for call, res in zip(setting["calls"], got["calls"]):
        (yseq, tl, score), (eyseq, etl, escore) = res["out"], call["eager"]
        err = (score - escore).abs().max().item()
        b, t = call["bucket"]
        program = f"{label}_b{b}_t{t}"
        by_kernel = {name: sum(n for key, n in res["shapes"].items() if key[0] == name)
                     for name in sites}
        unbound = (f"; as program.module() runs it {res['unbound_ms']:.2f} ms, outputs equal "
                   f"{res['unbound_equal']}" if "unbound_ms" in res else "")
        log(f"export {label} program b{b} t{t}: launches {res['launches']} (sites {sites}) at "
            f"{len(res['shapes'])} shapes; ids equal {torch.equal(yseq, eyseq)}, token counts "
            f"equal {torch.equal(tl, etl)} ({tl.tolist()[:8]}...), score max abs diff "
            f"{err:.3e}; one call {res['ms']:.2f} ms (device kernels {res['device_ms']:.2f} "
            f"ms), eager infer_core {call['eager_ms']:.2f} ms (device kernels "
            f"{call['eager_device_ms']:.2f} ms){unbound} on {card}")
        if res["launches"] != sites or by_kernel != sites or not (
                torch.equal(yseq, eyseq) and torch.equal(tl, etl) and err <= EXPORT_SCORE_TOL
                and res.get("unbound_equal", True)):
            raise AssertionError(f"export {label} b{b} t{t}: launches {res['launches']} "
                                 f"(expected {sites}, at recorded shapes {by_kernel}), ids / "
                                 f"counts / score diff {err}, module() equal "
                                 f"{res.get('unbound_equal')}")
        for key, n in res["shapes"].items():
            entry = shapes.setdefault(key, dict(inputs=res["inputs"][key], programs={}))
            entry["programs"][program] = n
        calls.append(dict(bucket=(b, t), launches=res["launches"], ms=res["ms"],
                          device_ms=res["device_ms"], eager_ms=call["eager_ms"],
                          eager_device_ms=call["eager_device_ms"], score_err=err,
                          **{k: res[k] for k in ("unbound_ms",) if k in res}))
    for bucket, res in got["transcribe"].items():
        want = setting["texts"][bucket]
        same = sum(x == y for x, y in zip(res["texts"], want))
        log(f"export {label} ExportedModel.transcribe {bucket[0]} waves ({bucket}): "
            f"{same} of {len(want)} texts equal to generate's; launches {res['launches']}")
        if res["texts"] != want or res["launches"] != sites:
            raise AssertionError(f"export {label} transcribe {bucket}: {res['texts']} vs "
                                 f"{want}, launches {res['launches']}")
    return dict(calls=calls, shapes=shapes, load_s=got["load_s"], seconds=setting["seconds"],
                trace_s={f["file"]: f["trace_s"] for f in setting["functions"]},
                bytes=sum(setting["bytes"].values()))


def mcp_check(model_dir, wav_path, dev):
    """Starts the port's MCP server (``bin/mcp_server.py``) in a process of its own, on the
    card by its default, with its requests: ``initialize``, ``tools/list``, ``transcribe``
    of a wav without and with ``itn``, ``inverse_normalize`` of MCP_ITN. Returns a function
    of an ``AutoModel`` over the same dir that waits for the server and gates: the two
    tools, the texts equal to the ``AutoModel``'s on the same wav, MCP_ITN's answer."""
    def call(i, name, **arguments):
        return {"jsonrpc": "2.0", "id": i, "method": "tools/call",
                "params": {"name": name, "arguments": arguments}}

    reqs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
            {"jsonrpc": "2.0", "method": "notifications/initialized"},
            {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
            call(3, "transcribe", audio_path=wav_path),
            call(4, "transcribe", audio_path=wav_path, itn=True),
            call(5, "inverse_normalize", text=MCP_ITN[0], language="zh")]
    cmd = [sys.executable, "-m", "funasr_tpu_torch.bin.mcp_server", "--model", model_dir]
    if dev.type != "cuda":
        cmd += ["--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    proc.stdin.write("".join(json.dumps(r, ensure_ascii=False) + "\n" for r in reqs))
    proc.stdin.flush()  # communicate() closes it: the server then ends

    def finish(am):
        stdout, stderr = proc.communicate(timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"MCP server exited with {proc.returncode}: {stderr[-3000:]}")
        resp = {r["id"]: r for r in map(json.loads, stdout.strip().splitlines())}
        tools = [t["name"] for t in resp[2]["result"]["tools"]]
        texts = [resp[i]["result"]["content"][0]["text"] for i in (3, 4, 5)]
        want = [am.generate(input=wav_path)[0]["text"],
                am.generate(input=wav_path, itn=True)[0]["text"], MCP_ITN[1]]
        log(f"MCP server (started {seconds:.1f} s before its result was read): tools "
            f"{tools}; transcribe {texts[0][:30]!r}..., with itn {texts[1][:30]!r}..., "
            f"inverse_normalize {MCP_ITN[0]} -> {texts[2]!r}; equal to AutoModel's "
            f"{texts == want}")
        if tools != ["transcribe", "inverse_normalize"] or texts != want \
                or texts[0] == texts[1] or any(resp[i]["result"].get("isError")
                                               for i in (3, 4, 5)):
            raise AssertionError(f"MCP: tools {tools}, texts {texts}, expected {want}")
        return dict(seconds=seconds, tools=tools)
    return finish


def phase_export(dev, counters, card, keep):
    """Phase 15: text normalization and export at Paraformer-large width (PROD_CONF, seeded,
    the numerals first in its tokens and lifted in its head): ``generate(itn=True)``
    against ``InverseNormalizer`` (``itn_check``), then ``AutoModel.export`` at fp32
    (EXPORT_BUCKETS) and under ``quant="w8a8"`` (EXPORT_W8A8_BUCKETS), each directory
    loaded by ``ExportedModel`` in a process of its own that imports no model module
    (``exported_child``): exact launches a program call, ids equal to eager
    ``infer_core``'s, texts equal to ``generate``'s (``check_exported``), each kernel
    against its plain version at every shape those calls launched
    (``export_kernel_rows``); the MCP server
    (``mcp_check``); SenseVoice-Small's ITN from phase 12's dir (``keep["sv"]``); and each
    op's lone call against the wrapper's direct one (``op_dispatch_rows``). The
    MCP server runs beside the exports; the SenseVoice check and eager ``infer_core``'s
    timing while the export process loads its programs, whose calls wait for them.
    Returns its figures."""
    from funasr_tpu_torch import AutoModel

    t0 = time.perf_counter()
    rng = np.random.default_rng(15)
    waves = {b: [pcm(rng, s) for _ in range(b[0])] for b, s in EXPORT_WAVE_SECONDS.items()}
    tokens = number_tokens()
    out = {"op_dispatch": op_dispatch_rows(dev)}
    with tempfile.TemporaryDirectory() as root:
        d = os.path.join(root, "asr")
        os.makedirs(d)
        write_model_dir(d, dev, tokens=tokens,
                        craft=lambda m: lift_numerals(m.decoder.output_layer, tokens))
        am = AutoModel(model=d, device=dev.type, log_level="WARNING")
        log(f"text and export: Paraformer-large dir written and built in "
            f"{time.perf_counter() - t0:.1f} s")
        sites = dict(kernel_sites(am.model), w8a8_linear=0)
        batch = waves[(32, 384)]
        out["itn"] = {"paraformer": itn_check(am, batch, "Paraformer-large fp32", counters,
                                              sites)}
        wav_path = os.path.join(root, "mcp.wav")
        with open(wav_path, "wb") as f:
            f.write(wav_bytes(np.asarray(batch[out["itn"]["paraformer"]["rewritten"][0]],
                                         np.int16)))
        mcp = mcp_check(d, wav_path, dev)
        settings = {"fp32": export_setting(am, os.path.join(root, "fp32"), EXPORT_BUCKETS,
                                           waves, "fp32", dev)}
        am_q = AutoModel(model=d, device=dev.type, quant="w8a8", log_level="WARNING")
        sites_q = dict(sites, w8a8_linear=count_w8a8(am_q.model))
        settings["w8a8"] = export_setting(am_q, os.path.join(root, "w8a8"),
                                          EXPORT_W8A8_BUCKETS, waves, "w8a8", dev)
        io_path = os.path.join(root, "io.pt")
        torch.save(dict(device=dev.type, settings={
            label: {k: s[k] for k in ("dir", "waves")}
            | {"calls": [{k: c[k] for k in ("speech", "lengths")} for c in s["calls"]]}
            for label, s in settings.items()}), io_path)
        exported = exported_in_child(io_path)
        sv = AutoModel(model=keep["sv"], device=dev.type, log_level="WARNING")
        lift_numerals(sv.model.ctc.ctc_lo, sv_tokens())
        sv_waves = [pcm(rng, 15.0) for _ in range(ITN_SV_BATCH)]
        out["itn"]["sensevoice"] = itn_check(sv, sv_waves, "SenseVoice-Small fp32", counters,
                                             dict(kernel_sites(sv.model), w8a8_linear=0),
                                             language="zh")
        del sv
        out["mcp"] = mcp(am)
        eager_ms(am, settings["fp32"], dev)
        eager_ms(am_q, settings["w8a8"], dev)
        del am, am_q
        torch.cuda.empty_cache()
        got = exported()
        if got["modules"]:
            raise AssertionError(f"the export process imported model code: {got['modules']}")
        for label, site in (("fp32", sites), ("w8a8", sites_q)):
            out[label] = check_exported(label, settings[label], got[label], site, card)
    torch.cuda.empty_cache()
    shapes = {}
    for label in ("fp32", "w8a8"):
        for key, entry in out[label].pop("shapes").items():
            shapes.setdefault(key, dict(inputs=entry["inputs"], programs={}))[
                "programs"].update(entry["programs"])
    out["rows"] = export_kernel_rows(dev, shapes)
    out["launches"] = {c.__name__: sum(call["launches"][c.__name__] for label in ("fp32", "w8a8")
                                       for call in out[label]["calls"]) for c in counters}
    log(f"text and export: program launches {out['launches']}, "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return out


# the kernel rows at the streaming shapes: kernel -> [(label, record key)]
# ---------------------------------------------------------------------------------------
# phase 16: training: the backward kernels, CUDA against the CPU, and the
# finetune recipe through bin/data_tools and bin/train
# ---------------------------------------------------------------------------------------

# the training keys of paraformer-large's config.yaml (FunASR's template: SpecAugLFR,
# dropout 0.1, dither 1.0, lsm_weight 0.1, the glancing sampler at 0.75)
TRAIN_MODEL_CONF = dict(lsm_weight=0.1, predictor_weight=1.0, length_normalized_loss=True,
                        sampling_ratio=0.75)
TRAIN_SPECAUG_CONF = dict(apply_time_warp=False, time_warp_window=5, time_warp_mode="bicubic",
                          apply_freq_mask=True, freq_mask_width_range=[0, 30], lfr_rate=6,
                          num_freq_mask=1, apply_time_mask=True, time_mask_width_range=[0, 12],
                          num_time_mask=1)
TRAIN_UTTS = 16            # train utterances of 10-15 s: about 4 token batches of 6,000 frames
TRAIN_VAL_UTTS = 4
TRAIN_SECONDS = (10.0, 15.0)
# finetune.sh's flags, with the run cut to one epoch (then one more, resumed)
TRAIN_RECIPE = ["++dataset_conf.batch_size=6000", "++dataset_conf.batch_type=token",
                "++optim_conf.lr=0.0002", "++train_conf.keep_nbest_models=10",
                "++train_conf.log_interval=1", "++train_conf.use_tensorboard=False",
                "++train_conf.log_kernel_shapes=True"]
# the first run adds a mid-epoch checkpoint (step 3) and the profiled step (the second);
# the resumed run checkpoints at its epoch's end and averages the 2 best
TRAIN_FIRST = ["++train_conf.max_epoch=1", "++train_conf.save_checkpoint_interval=3",
               "++train_conf.profile_start_step=1", "++train_conf.profile_steps=1"]
TRAIN_RESUMED = ["++train_conf.max_epoch=2", "++train_conf.save_checkpoint_interval=0",
                 "++train_conf.avg_nbest_model=2"]
TRAIN_CPU_DEPTH = (4, 2)   # encoder / decoder blocks of the CUDA-vs-CPU step (PROD_CONF width)
TRAIN_CPU_T = 10.0         # seconds of each of the step's 2 utterances
TRAIN_LOSS_RTOL = 1e-5     # the step's loss, CUDA against the CPU (fp32)
# each parameter's gradient, CUDA against the CPU, relative L2: fp32 on both, the kernels'
# 3xTF32 sums and cuBLAS against the CPU's order, through 4 + 2 blocks
TRAIN_GRAD_REL_TOL = 1e-3
FLASH_BWD_REL_TOL = 1e-5   # dq / dk / dv against autograd through the plain version (fp32)
FSMN_BWD_REL_TOL = 1e-5    # dx / dw against autograd through the plain version (fp32)
CIF_TIE_SCALE = 1 + 1e-5   # the training CIF's last-fire tie moved alike on both devices


def train_sites(enc_blocks, dec_blocks):
    """Launches of each kernel in one training step of Paraformer (every decoder layer but
    the last has an FSMN; the glancing sampler's first decoder pass runs them again under
    no_grad) and in one validation batch."""
    step = {"flash_attention": enc_blocks, "flash_attention_bwd": enc_blocks,
            "fsmn_memory": enc_blocks + 2 * dec_blocks,
            "fsmn_memory_bwd_input": enc_blocks + dec_blocks,
            "fsmn_memory_bwd_weight": enc_blocks + dec_blocks, "w8a8_linear": 0}
    val = dict(step, flash_attention_bwd=0, fsmn_memory_bwd_input=0, fsmn_memory_bwd_weight=0)
    return step, val


def flash_bwd_work(b, h, t, tk, d, limits):
    """Bytes and flops of the flash backward (fp32): q, o, dO read and dq written (Tq rows),
    k, v read and dk, dv written (Tk rows), the lengths; 10 D flops per query row and key
    it sees (S, dO V^T, dV, dQ, dK: five products of 2 D each)."""
    n_bytes = 4 * b * h * d * (4 * t + 4 * tk) + 4 * b
    return n_bytes, 10 * h * d * sum(sum(r) for r in limits)


def fsmn_dw_work(b, t, c, k):
    """Bytes and flops of the FSMN weight gradient (fp32): x and dout read once, the mask,
    dw (C, k) written; 2 k flops a value (one multiply-add a tap)."""
    return 4 * (2 * b * t * c + c * k) + b * t, 2 * k * b * t * c


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


FLASH_BWD_LIBRARY = ("torch.autograd.grad(scaled_dot_product_attention(q, k, v, "
                     "attn_mask=key_valid), (q, k, v), dout)")


def flash_bwd_timing(q, k, v, out, stats, dout, ln, mode, vp, chunk=None):
    """The flash backward kernel's ms (with the forward's (m, l), as FlashAttentionFn
    runs it), a lone call's ms, the plain version's (the plain forward + autograd, by
    ``quick_ms``), SDPA's backward with the same key mask (in chunk mode
    ``chunk_library_mask``), and the bound (3xTF32 and CUDA-core; in chunk mode over the
    live scores)."""
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.flash_attention import (chunk_mask, flash_attention_bwd,
                                                      flash_attention_bwd_ref,
                                                      flash_attention_with_stats, key_limits)

    b, h, t, d = q.shape
    tk = k.shape[2]
    if chunk is not None:
        key_valid = chunk_library_mask(ln, t, chunk)
    else:
        limits = key_limits(ln, t, mode, vp)
        key_valid = torch.arange(tk, device=q.device)[None, None, :] < limits[:, :, None]
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=key_valid[:, None])
    kernel = lambda: flash_attention_bwd(q, k, v, out, dout, ln, mode, vp, stats=stats,  # noqa: E731
                                         chunk=chunk)
    row = dict(library_call=FLASH_BWD_LIBRARY, ms=device_ms(kernel), call_ms=call_ms(kernel),
               plain_ms=quick_ms(lambda: flash_attention_bwd_ref(q, k, v, dout, ln, mode, vp,
                                                                 chunk)),
               library_ms=device_ms(lambda: torch.autograd.grad(
                   sdpa, (qs, ks, vs), dout, retain_graph=True)))
    if chunk is not None:
        lim_rows = chunk_mask(ln, t, t, chunk).sum(-1).tolist()
        _, stats0 = flash_attention_with_stats(q, k, v, ln)  # mode 0 on the same inputs
        row["mode_none_ms"] = device_ms(lambda: flash_attention_bwd(q, k, v, out, dout, ln,
                                                                    stats=stats0))
    else:
        lim_rows = [[n if n > 0 else tk for n in r] for r in limits.tolist()]
    n_bytes, n_ops = flash_bwd_work(b, h, t, tk, d, lim_rows)
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 3 * n_ops, "tf32")
    row["cuda_core_bound_ms"] = bound_ms(n_bytes, n_ops, "fp32")[0]
    return row


def fsmn_bwd_timing(name, fn, x, dout, w, mask, left, right):
    """An FSMN backward kernel's ms (``fn``), a lone call's, the plain version's (autograd
    through the plain forward, for x or the weight, by ``quick_ms``), the library call's
    (``conv1d_input`` + g for dx, ``conv1d_weight`` for dw, on the masked (B, C, T)
    tensors; symmetric pads, as the training path's) and the bound."""
    from torch.nn.grad import conv1d_input, conv1d_weight
    from funasr_tpu_torch.ops.fsmn import fsmn_memory_ref

    b, t, c = dout.shape
    kk = w.shape[-1]
    m = (torch.ones(b, t, device=dout.device) if mask is None else mask.float())[:, None, :]
    g_bct = (dout.transpose(1, 2) * m).contiguous()   # the library calls' (B, C, T) layout
    xm_bct = (x.transpose(1, 2) * m).contiguous()
    wrt = 0 if name == "fsmn_memory_bwd_input" else 1

    def plain():
        with torch.enable_grad():
            x_, w_ = x.detach().requires_grad_(wrt == 0), w.detach().requires_grad_(wrt == 1)
            out = fsmn_memory_ref(x_, w_, mask, left, right)
            return torch.autograd.grad(out, (x_, w_)[wrt], dout)

    if wrt == 0:
        lib = lambda: conv1d_input((b, c, t), w, g_bct, padding=left, groups=c) + g_bct  # noqa: E731
        lib_call = f"torch.nn.grad.conv1d_input(xm.shape, w, g, padding={left}, groups=C) + g"
        work = fsmn_work(b, t, c, kk, 4)
    else:
        lib = lambda: conv1d_weight(xm_bct, w.shape, g_bct, padding=left, groups=c)  # noqa: E731
        lib_call = f"torch.nn.grad.conv1d_weight(xm, w.shape, g, padding={left}, groups=C)"
        work = fsmn_dw_work(b, t, c, kk)
    row = dict(library_call=lib_call, ms=device_ms(fn), call_ms=call_ms(fn),
               plain_ms=quick_ms(plain), library_ms=device_ms(lib))
    row["bound_ms"], row["bound_by"] = bound_ms(*work, "fp32")
    return row


def train_kernel_rows(dev, g, b, t, lens):
    """(a) The backward kernels at the training batch's shapes against autograd through
    their plain versions: flash at (B, 4, T, 128) fp32 (strided head views of q|k|v, the
    batch's ragged lengths) in each mode, with the forward's (m, l) as FlashAttentionFn
    passes them; FSMN dx and dw at (B, T, 512), k 11, pads 5 / 5, the batch's mask. Each
    with ms, call_ms, plain ms (the plain forward + autograd), the library call's ms and
    the bound; flash also the forward's ms without and with its (m, l)."""
    from funasr_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                      flash_attention_bwd_ref,
                                                      flash_attention_with_stats)
    from funasr_tpu_torch.ops.fsmn import (fsmn_memory_bwd_input, fsmn_memory_bwd_ref,
                                           fsmn_memory_bwd_weight)

    rows = {}
    h, d = PROD_CONF["encoder_conf"]["attention_heads"], 128
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    for mode, vp_list in (("none", None), ("causal", None), ("corner", [t // 3] * b)):
        vp = None if vp_list is None else torch.tensor(vp_list, dtype=torch.int32, device=dev)
        with torch.no_grad():
            out, stats = flash_attention_with_stats(q, k, v, ln, mode, vp)
            same_fwd = torch.equal(out, flash_attention(q, k, v, ln, mode, vp))
        dout = torch.randn(out.shape, generator=g).to(dev)
        got = flash_attention_bwd(q, k, v, out, dout, ln, mode, vp, stats=stats)
        again = flash_attention_bwd(q, k, v, out, dout, ln, mode, vp, stats=stats)
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(q, k, v, dout, ln, mode, vp)
        rel = max(rel_l2(a, w) for a, w in zip(got, want))
        err = max((a - w).abs().max().item() for a, w in zip(got, want))
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        row = dict(shape=(b, h, t, d), mode=mode, lengths=list(lens), max_abs_err=err,
                   rel_l2=rel, deterministic=same,
                   **flash_bwd_timing(q, k, v, out, stats, dout, ln, mode, vp),
                   fwd_ms=device_ms(lambda: flash_attention(q, k, v, ln, mode, vp)),
                   fwd_stats_ms=device_ms(lambda: flash_attention_with_stats(q, k, v, ln, mode,
                                                                             vp)))
        if vp_list is not None:
            row["vad_pos"] = vp_list
        log(f"flash backward {row['shape']} fp32 {mode}: rel L2 {rel:.2e} (tol "
            f"{FLASH_BWD_REL_TOL:g}) max_abs_err {err:.3e}, two runs bit-equal {same}, forward "
            f"with (m, l) equal to without {same_fwd} ({row['fwd_stats_ms']:.4f} / "
            f"{row['fwd_ms']:.4f} ms); " + timing_line(row))
        if not (rel <= FLASH_BWD_REL_TOL and same and same_fwd):
            raise AssertionError(f"flash backward kernel disagrees ({mode}): {rel}, {same}, "
                                 f"{same_fwd}")
        rows[("flash_attention_bwd", mode)] = row

    c, kk, left = 512, 11, 5
    x = torch.randn(b, t, 3 * c, generator=g).to(dev)[..., 2 * c:]
    w = (torch.rand(c, 1, kk, generator=g) - 0.5).to(dev)
    mask = torch.arange(t, device=dev)[None] < ln[:, None]
    dout = torch.randn(b, t, c, generator=g).to(dev)
    want_dx, want_dw = fsmn_memory_bwd_ref(x, w, mask, left, left, dout)
    for name, fn, want in (
            ("fsmn_memory_bwd_input", lambda: fsmn_memory_bwd_input(dout, w, mask, left, left),
             want_dx),
            ("fsmn_memory_bwd_weight", lambda: fsmn_memory_bwd_weight(x, dout, mask, left, left),
             want_dw.reshape(c, kk))):
        got, again = fn(), fn()
        torch.cuda.synchronize()
        rel, err = rel_l2(got, want), (got - want).abs().max().item()
        same = torch.equal(got, again)
        row = dict(shape=(b, t, c), k=kk, pads=(left, left), max_abs_err=err, rel_l2=rel,
                   deterministic=same, **fsmn_bwd_timing(name, fn, x, dout, w, mask, left, left))
        log(f"{name} {row['shape']} k=11 fp32: rel L2 {rel:.2e} (tol {FSMN_BWD_REL_TOL:g}) "
            f"max_abs_err {err:.3e}, two runs bit-equal {same}; " + timing_line(row))
        if not (rel <= FSMN_BWD_REL_TOL and same):
            raise AssertionError(f"{name} disagrees: {rel}, {same}")
        rows[(name,)] = row
    return rows


def recipe_launch_shapes(lines):
    """Every signature the recipe's counted runs launched, from the trainer's log lines
    (steps and validations; ``++train_conf.log_kernel_shapes``): {(kernel, ((shape,
    strides), ...), args): {"launches", "lengths" (the first launch's)}}. Raises where a
    line's signatures do not add up to its launches."""
    shapes = {}
    for x in lines:
        by_kernel = {}
        for e in x["kernel_shapes"]:
            key = (e["kernel"], tuple((tuple(sh), tuple(st)) for sh, st in e["tensors"]),
                   tuple(e["args"]))
            entry = shapes.setdefault(key, dict(launches=0, lengths=e["lengths"]))
            if "mask_runs" in e:  # a holed mask (``cuda_lib.take_launch_shapes``)
                entry["mask_runs"] = e["mask_runs"]
            entry["launches"] += e["launches"]
            by_kernel[e["kernel"]] = by_kernel.get(e["kernel"], 0) + e["launches"]
        if any(by_kernel.get(k, 0) != n for k, n in x["launches"].items()):
            raise AssertionError(f"step {x['step']}: launches by shape {by_kernel} do not "
                                 f"add up to {x['launches']}")
    return shapes


def recipe_label(key):
    """A recipe row's label: the first tensor's shape, the FSMN's k ("5x190x512_k11"), chunk
    mode's integers ("5x4x402x128_chunk17-5-8-4") and an FSMN's pads where they are not the
    encoder's (5, 5) ("_pads10-0")."""
    name, tensors, args = key
    shape = "x".join(map(str, tensors[0][0]))
    if name.startswith("flash"):
        return shape + ("_chunk" + "-".join(map(str, args[1:])) if args[0] == "chunk" else "")
    return f"{shape}_k{args[0]}" + ("" if tuple(args[1:3]) == (5, 5) else
                                    f"_pads{args[1]}-{args[2]}")


def recipe_kernel_rows(dev, shapes, strict=False):
    """(d) One row per signature the recipe's runs launched (``recipe_launch_shapes``):
    random values at the launch's shapes and strides (``strided_randn``), its lengths
    (flash's key lengths, and chunk mode's integers; the FSMN's mask: the recorded runs of
    a holed mask, else the prefix mask of the row sums), against the plain version.
    Forward kernels within FLASH_TOL / FSMN_TOL (fp32, max abs); backward kernels within
    FLASH_BWD_REL_TOL / FSMN_BWD_REL_TOL relative L2 and bit-equal across two runs (flash
    with the forward's (m, l), as FlashAttentionFn runs it); ``strict``: the forward kernels
    too within those relative L2 limits and bit-equal (phase 18). Each row with its kernel
    ms, a lone call's ms, the plain version's ms (``quick_ms``), the library call's ms, the
    bound and its launches in the runs. Returns {kernel: {label: row}}; raises on a
    disagreement."""
    from funasr_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                      flash_attention_bwd_ref,
                                                      flash_attention_ref,
                                                      flash_attention_with_stats)
    from funasr_tpu_torch.ops.fsmn import (fsmn_memory, fsmn_memory_bwd_input,
                                           fsmn_memory_bwd_ref, fsmn_memory_bwd_weight,
                                           fsmn_memory_ref)

    g = torch.Generator(device=dev).manual_seed(17)
    f32 = torch.float32
    rows = {}
    for key, info in shapes.items():
        name, tensors, args = key
        lens = info["lengths"]
        made = [strided_randn(sh, st, f32, g, dev) for sh, st in tensors]
        chunk = None
        if name.startswith("flash"):
            if args[0] not in ("none", "chunk"):
                raise AssertionError(f"the recipe launched {name} in mode {args[0]}")
            chunk = tuple(args[1:]) if args[0] == "chunk" else None
            q, k, v = made[:3]
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        else:
            kk, left, right = args[:3]
            b, t, c = tensors[0][0]
            w = torch.rand(c, 1, kk, generator=g, device=dev) - 0.5
            mask = (None if lens is None else torch.arange(t, device=dev)[None]
                    < torch.tensor(lens, device=dev)[:, None])
            if info.get("mask_runs") is not None:
                mask = torch.zeros(b, t, dtype=torch.bool, device=dev)
                for i, runs in enumerate(info["mask_runs"]):
                    for s0, s1 in runs:
                        mask[i, s0:s1] = True
        if name == "flash_attention":
            row = flash_row(q, k, v, lens, "chunk" if chunk else "none", plain_timer=quick_ms,
                            chunk=chunk)
            tol = FLASH_BWD_REL_TOL if strict else FLASH_TOL[f32]
            if strict and "rel_l2" not in row:
                out = flash_attention(q, k, v, ln)
                row.update(rel_l2=rel_l2(out, flash_attention_ref(q, k, v, ln)),
                           deterministic=torch.equal(out, flash_attention(q, k, v, ln)))
        elif name == "fsmn_memory":
            if args[3]:
                raise AssertionError("the recipe launched the generic FSMN kernel")
            row = fsmn_row(made[0], w, mask, left, right, plain_timer=quick_ms)
            tol = FSMN_BWD_REL_TOL if strict else FSMN_TOL[f32]
            if strict:
                out = fsmn_memory(made[0], w, mask, left, right)
                row.update(rel_l2=rel_l2(out, fsmn_memory_ref(made[0], w, mask, left, right)),
                           deterministic=torch.equal(out, fsmn_memory(made[0], w, mask, left,
                                                                      right)))
        else:
            if name == "flash_attention_bwd":
                out, dout = made[3:]
                mode = "chunk" if chunk else "none"
                with torch.no_grad():
                    fwd, stats = flash_attention_with_stats(q, k, v, ln, mode, chunk=chunk)
                    out.copy_(fwd)
                fn = lambda: flash_attention_bwd(q, k, v, out, dout, ln, mode,  # noqa: E731
                                                 stats=stats, chunk=chunk)
                want = flash_attention_bwd_ref(q, k, v, dout, ln, mode, chunk=chunk)
                tol = FLASH_BWD_REL_TOL
            elif name == "fsmn_memory_bwd_input":
                dout = made[0]
                x = torch.randn_like(dout)
                fn = lambda: (fsmn_memory_bwd_input(dout, w, mask, left, right),)  # noqa: E731
                want = fsmn_memory_bwd_ref(x, w, mask, left, right, dout)[:1]
                tol = FSMN_BWD_REL_TOL
            elif name == "fsmn_memory_bwd_weight":
                x, dout = made
                fn = lambda: (fsmn_memory_bwd_weight(x, dout, mask, left, right),)  # noqa: E731
                want = (fsmn_memory_bwd_ref(x, w, mask, left, right, dout)[1].reshape(c, kk),)
                tol = FSMN_BWD_REL_TOL
            else:
                raise AssertionError(f"the recipe launched {name}")
            got, again = fn(), fn()
            torch.cuda.synchronize()
            row = dict(shape=tensors[0][0], rel_l2=max(rel_l2(a, w_) for a, w_ in zip(got, want)),
                       max_abs_err=max((a - w_).abs().max().item() for a, w_ in zip(got, want)),
                       deterministic=all(torch.equal(a, a2) for a, a2 in zip(got, again)))
            if name == "flash_attention_bwd":
                row.update(flash_bwd_timing(q, k, v, out, stats, dout, ln, mode, None, chunk))
                if chunk is not None:
                    row["chunk"] = list(chunk)
            else:
                row.update(fsmn_bwd_timing(name, fn, x, dout, w, mask, left, right))
        row.update(strides=[st for _, st in tensors], launches=info["launches"])
        if lens is not None:
            row["lengths"] = lens
        if info.get("mask_runs") is not None:
            row["mask"] = "holed (the frame mask's recorded runs)"
        err = row.get("rel_l2", row["max_abs_err"])
        ok = (math.isfinite(err) and err <= tol and row.get("deterministic", True)
              and row.get("dead_rows_zero", True))
        log(f"  {name} {recipe_label(key)}: {'rel L2' if 'rel_l2' in row else 'max_abs_err'} "
            f"{err:.2e} (tol {tol:g}){'' if row.get('deterministic', True) else ' NOT bit-equal'}"
            f", {info['launches']} launches; " + timing_line(row))
        if not ok:
            raise AssertionError(f"{name} disagrees at the recipe's {recipe_label(key)}: {row}")
        label, by_name = recipe_label(key), rows.setdefault(name, {})
        while label in by_name:  # the same shape at other strides
            label += "'"
        by_name[label] = row
    return rows


@contextlib.contextmanager
def cif_tie_moved():
    """The training CIF's rescaled alphas times CIF_TIE_SCALE, on every device alike: they
    sum to the target count exactly, and whether the last token fires is a tie that
    rounding decides, in another order on each device."""
    import funasr_tpu_torch.models.paraformer.cif_predictor as cif_mod
    cif = cif_mod.cif
    cif_mod.cif = lambda h, a, k, thr=1.0: cif(h, a * CIF_TIE_SCALE, k, thr)
    try:
        yield
    finally:
        cif_mod.cif = cif


def train_cuda_vs_cpu(dev, counters, model_name="Paraformer", encoder_conf=None,
                      decoder_conf=None, grad_tol=TRAIN_GRAD_REL_TOL, **call):
    """(b) One training step (loss + backward) of a PROD_CONF-width Paraformer cut to 4 + 2
    blocks, on the card and on the CPU: the same weights and features, dropout and SpecAug
    off, the sampler's draws fed equal. Gates: the loss within TRAIN_LOSS_RTOL, every
    parameter's gradient within ``grad_tol`` relative L2, the step's launches exactly its
    sites, the q / k rows of every linear_q_k_v and every fsmn_block non-zero on the card.
    ``model_name`` / ``encoder_conf`` / ``decoder_conf`` (cut to the same depth) / ``call``
    (extra arguments of the step, e.g. ``chunk_index``): another model (phase 18's)."""
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.frontends.wav_frontend import WavFrontend

    enc_n, dec_n = TRAIN_CPU_DEPTH
    extra = {} if model_name == "Paraformer" else {"encoder": "SANMEncoderChunkOpt"}
    conf = dict(PROD_CONF, **TRAIN_MODEL_CONF, **extra,
                encoder_conf=dict(encoder_conf or PROD_CONF["encoder_conf"], num_blocks=enc_n,
                                  dropout_rate=0.0),
                decoder_conf=dict(decoder_conf or PROD_CONF["decoder_conf"], num_blocks=dec_n,
                                  att_layer_num=dec_n))
    cpu = tables.model_classes[model_name](**conf, generator=torch.Generator().manual_seed(5))
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(5)
    waves = [pcm(rng, TRAIN_CPU_T), pcm(rng, TRAIN_CPU_T * 0.7)]
    feats, flens = WavFrontend(**dict(FRONTEND_CONF, cmvn_file=None)).extract(waves)
    feats, flens = torch.from_numpy(np.ascontiguousarray(feats)), torch.from_numpy(flens)
    tl = torch.tensor([40, 31])
    text = torch.full((2, 40), -1, dtype=torch.long)
    for i, n in enumerate(tl.tolist()):
        text[i, :n] = torch.from_numpy(rng.integers(3, conf["vocab_size"] - 1, n))
    uniform = torch.from_numpy(rng.random((2, 41), dtype=np.float32))
    out = {}
    with cif_tie_moved():
        for name, model in (("cpu", cpu), ("cuda", gpu)):
            model.train()
            d = next(model.parameters()).device
            for c in counters:
                c.launches = 0
            loss, stats, _ = model(feats.to(d), flens.to(d), text.to(d), tl.to(d),
                                   sampler_uniform=uniform.to(d), **call)
            loss.backward()
            if d.type == "cuda":
                torch.cuda.synchronize()
            out[name] = (loss.item(), {k: float(v.detach()) for k, v in stats.items()},
                         {n: p.grad for n, p in model.named_parameters()},
                         {c.__name__: c.launches for c in counters})
    (cl, cst, cg, _), (gl, gst, gg, launches) = out["cpu"], out["cuda"]
    sites, _ = train_sites(enc_n, dec_n)
    worst, worst_name = 0.0, None
    for n, want in cg.items():
        got = gg[n]
        if want is None or got is None:
            if (want is None) != (got is None):
                raise AssertionError(f"{n}: a gradient on one device only")
            continue
        r = rel_l2(got.cpu(), want) if want.norm() > 0 else got.abs().max().item()
        if r > worst:
            worst, worst_name = r, n
    zero = [n for n, gr in gg.items()
            if ("linear_q_k_v.weight" in n and n.startswith("encoder.")
                and gr[:2 * 512].abs().max() == 0)
            or ("fsmn_block" in n and gr.abs().max() == 0)]
    log(f"{model_name} training step CUDA vs CPU (PROD_CONF width, {enc_n} + {dec_n} blocks, "
        f"2 x {TRAIN_CPU_T:g} s{', ' + str(call) if call else ''}): loss {gl:.7f} vs {cl:.7f} "
        f"(rel {abs(gl - cl) / abs(cl):.2e}, tol {TRAIN_LOSS_RTOL:g}); worst gradient rel L2 "
        f"{worst:.2e} ({worst_name}, tol {grad_tol:g}); launches {launches} (sites {sites})")
    if abs(gl - cl) > TRAIN_LOSS_RTOL * abs(cl) or not worst <= grad_tol:
        raise AssertionError("training step: CUDA disagrees with the CPU")
    if launches != sites:
        raise AssertionError(f"training step launches {launches} != sites {sites}")
    if zero:
        raise AssertionError(f"zero attention / FSMN weight gradients on CUDA: {zero[:4]}")
    return dict(loss_cuda=gl, loss_cpu=cl, worst_grad_rel_l2=worst, worst_param=worst_name,
                launches=launches, depth=TRAIN_CPU_DEPTH)


def write_train_data(root, rng, tokens):
    """Generated wavs of 10-15 s with random texts of ~4 characters a second, as wav.scp
    + text.txt pairs for train and val (finetune.sh's inputs)."""
    lists = {}
    for split, n in (("train", TRAIN_UTTS), ("val", TRAIN_VAL_UTTS)):
        scp, txt = [], []
        for i in range(n):
            seconds = float(rng.uniform(*TRAIN_SECONDS))
            path = os.path.join(root, f"{split}{i}.wav")
            with open(path, "wb") as f:
                f.write(wav_bytes(pcm(rng, seconds)))
            chars = [tokens[int(j)] for j in rng.integers(3, len(tokens) - 1, int(seconds * 4))]
            scp.append(f"{split}{i} {path}")
            txt.append(f"{split}{i} {''.join(chars)}")
        for kind, lines in (("wav.scp", scp), ("text.txt", txt)):
            with open(os.path.join(root, f"{split}_{kind}"), "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
        lists[split] = (os.path.join(root, f"{split}_wav.scp"),
                        os.path.join(root, f"{split}_text.txt"))
    return lists


def run_cli(args, label, timeout=600, tree=None):
    """A console script of the port as finetune.sh runs it (``python -m`` of the module
    its entry point names), from the root of this checkout (or of ``tree``); its
    output's tail on failure."""
    t0 = time.perf_counter()
    tree = tree or os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run([sys.executable, "-m", *args], cwd=tree,
                         env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
                         text=True, timeout=timeout)
    log(f"{label}: exit {run.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in run.stderr.splitlines():  # the CLI's timestamped milestones
        if any(k in line for k in ("loading pretrained", "saved checkpoint", "resumed from",
                                   "validate epoch", "averaged", "profiler trace")):
            log("  " + line[:160])
    if run.returncode != 0:
        raise AssertionError(f"{label} failed:\n{run.stdout[-3000:]}\n{run.stderr[-6000:]}")
    return run


def run_clis(jobs, timeout=600):
    """``run_cli`` of each (args, label) in ``jobs`` at once, each in a process of its own
    (finetune.sh's data_tools calls of the train and val splits); raises as ``run_cli``."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(lambda job: run_cli(*job, timeout=timeout), jobs))


def read_train_log(out):
    with open(os.path.join(out, "train.log.jsonl"), encoding="utf-8") as f:
        lines = [json.loads(line) for line in f]
    return ([x for x in lines if "validate" not in x], [x for x in lines if "validate" in x])


def grads_reached(ckpt_path):
    """From a checkpoint's Adam state: the encoder's linear_q_k_v weights whose q / k rows
    and the fsmn_block weights whose taps never had a non-zero gradient (the second
    moment stays 0 only then), and how many of each were checked."""
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True, mmap=True)
    names = list(state["state_dict"])
    opt = state["optimizer"]
    params = opt["param_groups"][0]["params"]
    if len(params) != len(names):
        raise AssertionError(f"{len(params)} optimizer params for {len(names)} tensors")
    checked, zero = 0, []
    for idx, name in zip(params, names):
        if not (("linear_q_k_v.weight" in name and name.startswith("encoder."))
                or "fsmn_block" in name):
            continue
        v = opt["state"][idx]["exp_avg_sq"]
        part = v[:2 * PROD_CONF["encoder_conf"]["output_size"]] if "q_k_v" in name else v
        checked += 1
        if part.abs().max() == 0:
            zero.append(name)
    return checked, zero


def recipe_batches(jsonl):
    """The audio seconds of each batch the trainer's sampler gives in epochs 0 and 1 (the
    same seed and token budget)."""
    from funasr_tpu_torch.datasets.audio_datasets.datasets import AudioDataset
    from funasr_tpu_torch.datasets.audio_datasets.samplers import BatchSampler
    ds = AudioDataset("IndexDSJsonl", {"path": jsonl})
    sampler = BatchSampler(ds, batch_size=6000, batch_type="token", shuffle=True)
    seconds = []
    for epoch in (0, 1):
        sampler.set_epoch(epoch)
        seconds += [sum(ds.get_source_len(i) for i in b) / 100.0 for b in sampler]
    return seconds


def recipe_setup(root, dev):
    """finetune.sh's inputs under ``root``: a seeded PROD_CONF Paraformer-large model dir
    whose config carries the training keys, 16 + 4 generated wavs and their jsonl, written
    by ``bin/data_tools scp2jsonl``, a subprocess a split, both at once. Returns (model
    dir, tokens, {split: jsonl})."""
    import yaml
    rng = np.random.default_rng(16)
    md = os.path.join(root, "paraformer-large")
    os.makedirs(md)
    t0 = time.perf_counter()
    write_model_dir(md, dev, extra=TRAIN_MODEL_CONF,
                    encoder_conf=dict(PROD_CONF["encoder_conf"], dropout_rate=0.1))
    with open(os.path.join(md, "config.yaml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg.update(specaug="SpecAugLFR", specaug_conf=TRAIN_SPECAUG_CONF)
    cfg["frontend_conf"]["dither"] = 1.0
    write_config(md, cfg)
    with open(os.path.join(md, "tokens.txt"), encoding="utf-8") as f:
        tokens = f.read().split("\n")[:-1]
    lists = write_train_data(root, rng, tokens)
    log(f"training: model dir and {TRAIN_UTTS} + {TRAIN_VAL_UTTS} wavs written in "
        f"{time.perf_counter() - t0:.1f} s")
    jsonl = {split: os.path.join(root, f"{split}.jsonl") for split in lists}
    run_clis([(["funasr_tpu_torch.bin.data_tools", "scp2jsonl",
                f'++scp_file_list=["{scp}","{txt}"]', '++data_type_list=["source","target"]',
                f"++jsonl_file_out={jsonl[split]}"], f"data_tools scp2jsonl {split}")
              for split, (scp, txt) in lists.items()])
    return md, tokens, jsonl


def run_step_ms(steps):
    """ms of each whole step in one run's log lines: the differences of ``time`` between
    consecutive lines of one epoch (the epoch's end, with its validation and checkpoint,
    left out)."""
    return [(y["time"] - x["time"]) * 1e3 for x, y in zip(steps, steps[1:])
            if x["epoch"] == y["epoch"]]


def recipe_ab(other=None):
    """``--recipe-ab [TREE]``: the recipe's ``bin/train`` (2 epochs, checkpoints only at
    their ends) six times, alternating this tree with ``log_kernel_shapes`` on and off
    or, given ``other``, this tree and that checkout (its own kernel build), both with
    the log off: ms a step of each run (``run_step_ms``: median) and of each side
    pooled."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    log(card)
    here = os.path.dirname(os.path.abspath(__file__))
    sides = ({"this": here, "other": os.path.abspath(other)} if other
             else {"shapes_on": here, "shapes_off": here})
    recipe = [a for a in TRAIN_RECIPE if "log_kernel_shapes" not in a]
    pooled = {side: [] for side in sides}
    with tempfile.TemporaryDirectory() as root:
        md, _, jsonl = recipe_setup(root, torch.device("cuda"))
        for i, side in enumerate(list(sides) * 3):
            out = os.path.join(root, f"exp{i}")
            args = ["funasr_tpu_torch.bin.train", f"++model={md}",
                    f"++train_data_set_list={jsonl['train']}",
                    f"++valid_data_set_list={jsonl['val']}", *recipe, f"++output_dir={out}",
                    "++train_conf.max_epoch=2", "++train_conf.save_checkpoint_interval=0",
                    "++train_conf.keep_nbest_models=1"]
            if side == "shapes_on":
                args.append("++train_conf.log_kernel_shapes=True")
            run_cli(args, f"bin/train run {i} ({side})", tree=sides[side])
            ms = run_step_ms(read_train_log(out)[0])
            pooled[side] += ms
            log(f"run {i} {side}: ms a step {[round(x, 1) for x in ms]}, median "
                f"{statistics.median(ms):.1f}")
    log(f"recipe A/B ({card}): " + "; ".join(
        f"{side} median {statistics.median(v):.1f} ms a step over {len(v)} steps"
        for side, v in pooled.items()))


def phase_training(dev, counters, card, keep=None):
    """Phase 16: (a) the backward kernels at the recipe's first batch shape, (b) a training
    step on the card against the CPU, (c) finetune.sh's recipe: ``bin/data_tools
    scp2jsonl`` and ``bin/train`` as subprocesses on a seeded PROD_CONF Paraformer-large
    (50 + 16 blocks, d 512, vocab 8404) whose config carries the training keys, one epoch
    (about 4 token batches of 6,000, a mid-epoch checkpoint with its validation at step
    3, the epoch's checkpoint), then the run resumed for a second epoch (its checkpoint,
    the average of the 2 best). Gates: a finite loss every step, each step's launches exactly
    ``train_sites`` and each validation's its batches x the forward sites, the resumed run
    going on from the step it stopped at, every encoder linear_q_k_v's q / k rows and
    every fsmn_block reached by a gradient (the checkpoint's Adam moments), the averaged
    checkpoint decoding through ``AutoModel`` with 50 flash + 66 FSMN launches a decode;
    (d) a kernel-vs-plain row at every shape and stride the recipe's runs launched (the
    trainer's ``kernel_shapes``, ``recipe_kernel_rows``). ``keep``: {"root": a directory
    that outlives the phase}: the generated wavs and their jsonl stay there for phase 18
    (``keep["train_data"]`` = (tokens, {split: jsonl})), the model dir and the run's
    output are removed."""
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
    from funasr_tpu_torch.ops.flash_attention import flash_attention_bwd
    from funasr_tpu_torch.ops.fsmn import fsmn_memory_bwd_input, fsmn_memory_bwd_weight

    counters = (*counters, flash_attention_bwd, fsmn_memory_bwd_input, fsmn_memory_bwd_weight)
    torch.cuda.empty_cache()
    figures = {}
    enc_n = PROD_CONF["encoder_conf"]["num_blocks"]
    dec_n = PROD_CONF["decoder_conf"]["num_blocks"]
    step_sites, val_sites = train_sites(enc_n, dec_n)
    with contextlib.ExitStack() as stack:
        root = keep["root"] if keep else stack.enter_context(tempfile.TemporaryDirectory())
        md, tokens, jsonl = recipe_setup(root, dev)
        if keep is not None:
            keep["train_data"] = (tokens, jsonl)
            stack.callback(shutil.rmtree, md)

        # (a) the kernels at the first batch's shape (the frontend's frames of it)
        from funasr_tpu_torch.datasets.audio_datasets.datasets import AudioDataset
        from funasr_tpu_torch.datasets.audio_datasets.samplers import BatchSampler
        from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
        ds = AudioDataset("IndexDSJsonl", {"path": jsonl["train"]},
                          tokenizer=CharTokenizer(token_list=tokens))
        first = next(iter(BatchSampler(ds, batch_size=6000, batch_type="token", shuffle=True)))
        batch = ds.collator([ds[i] for i in first])
        with torch.no_grad():
            feats, flens = WavFrontend(**FRONTEND_CONF).forward(
                torch.from_numpy(batch["speech"]).to(dev),
                torch.from_numpy(batch["speech_lengths"]).to(dev))
        b, t = feats.shape[:2]
        lens = flens.tolist()
        log(f"training batch 0: B {b}, T {t}, lengths {lens}")
        g = torch.Generator().manual_seed(16)
        t_part = time.perf_counter()
        figures["rows"] = train_kernel_rows(dev, g, b, t, lens)
        log(f"training (a): kernel rows in {time.perf_counter() - t_part:.1f} s")

        # (b) CUDA against the CPU
        t_part = time.perf_counter()
        figures["cuda_vs_cpu"] = train_cuda_vs_cpu(dev, counters)
        log(f"training (b): CUDA against the CPU in {time.perf_counter() - t_part:.1f} s")

        # (c) the recipe
        out = os.path.join(root, "exp")
        profile_dir = os.path.join(root, "profile")
        if keep is not None:
            stack.callback(shutil.rmtree, out)
        base = ["funasr_tpu_torch.bin.train", f"++model={md}",
                f"++train_data_set_list={jsonl['train']}",
                f"++valid_data_set_list={jsonl['val']}", *TRAIN_RECIPE, f"++output_dir={out}"]
        t0 = time.perf_counter()
        run_cli(base + TRAIN_FIRST + [f"++train_conf.profile_dir={profile_dir}"],
                "bin/train (epoch 0)")
        first_wall = time.perf_counter() - t0
        steps1, vals1 = read_train_log(out)
        n1 = len(steps1)
        t0 = time.perf_counter()
        run_cli(base + TRAIN_RESUMED, "bin/train (resumed, epoch 1)")
        second_wall = time.perf_counter() - t0
        steps, vals = read_train_log(out)
        resumed = steps[n1:]
        if not resumed or resumed[0]["step"] != steps1[-1]["step"] + 1 or resumed[0]["epoch"] != 1:
            raise AssertionError(f"the resumed run did not go on from step {steps1[-1]['step']}")
        bad = [x["step"] for x in steps if not math.isfinite(x["loss"])]
        wrong = [(x["step"], x["launches"]) for x in steps if x["launches"] != step_sites]
        wrong += [("val", x["step"], x["launches"]) for x in vals
                  if x["launches"] != {k: v * x["batches"] for k, v in val_sites.items()}]
        for x in steps:
            log(f"  step {x['step']} (epoch {x['epoch']}): loss {x['loss']:.4f} loss_att "
                f"{x['loss_att']:.4f} loss_pre {x['loss_pre']:.4f} acc {x['acc']:.4f} "
                f"grad_norm {x['grad_norm']:.3f} batch {x['batch_size']:g} "
                f"peak {x.get('peak_mem_mib', 0):.0f} MiB")
        if bad or wrong:
            raise AssertionError(f"training: non-finite loss at {bad}; launches off the "
                                 f"sites {wrong[:3]}")
        latest = open(os.path.join(out, "model.pt.latest")).read().strip()
        checked, zero = grads_reached(os.path.join(out, latest))
        log(f"training: {checked} attention / FSMN weights checked in {latest}, "
            f"{len(zero)} never reached by a gradient")
        if zero or checked != 2 * enc_n + dec_n:
            raise AssertionError(f"weights without a gradient: {zero[:4]} ({checked} checked)")

        # (d) every shape the recipe launched, against the plain versions
        shapes = recipe_launch_shapes(steps + vals)
        log(f"training: {len(shapes)} kernel signatures launched over the recipe's "
            f"{len(steps)} steps and {len(vals)} validations")
        t_part = time.perf_counter()
        figures["recipe_rows"] = recipe_kernel_rows(dev, shapes)
        log(f"training (d): recipe rows in {time.perf_counter() - t_part:.1f} s")

        # the average decodes
        avg = os.path.join(out, "model.pt.avg")
        am = AutoModel(model=out, init_param=avg, device="cuda")
        waves = [np.asarray(pcm(np.random.default_rng(99), 12.0))]
        for c in counters:
            c.launches = 0
        res = am.generate(input=waves)
        torch.cuda.synchronize()
        dec_launches = {c.__name__: c.launches for c in counters}
        log(f"averaged checkpoint through AutoModel(model=<output dir>): {res[0]['key']} "
            f"text of {len(res[0]['text'])} characters; launches {dec_launches}")
        if not isinstance(res[0]["text"], str) or dec_launches["flash_attention"] != enc_n \
                or dec_launches["fsmn_memory"] != enc_n + dec_n:
            raise AssertionError("the averaged checkpoint did not decode through the kernels")
        del am

        # speed: whole steps between log lines (the first, with its warm-up, the profiled
        # one and those after a checkpoint left out), audio seconds of each step's batch
        seconds = recipe_batches(jsonl["train"])
        wall = [y["time"] - x["time"] for run in (steps1, resumed) for x, y in zip(run, run[1:])
                if y["step"] != 2 and x["step"] != 3]  # not the profiled step, nor a checkpoint's
        step_ms = statistics.median(wall) * 1e3 if wall else float("nan")
        audio = statistics.mean(seconds) if seconds else float("nan")
        with open(os.path.join(profile_dir, "summary.json")) as f:
            prof = json.load(f)
        idle = 1 - prof["device_ms"] / step_ms  # against the unprofiled median step
        peak = max(x.get("peak_mem_mib", 0) for x in steps)
        launches = {k: sum(x["launches"][k] for x in steps + vals) for k in step_sites}
        log(f"training ({card}): {len(steps)} steps ({n1} + {len(resumed)} resumed), "
            f"{step_ms:.1f} ms a step (median of {len(wall)}), {1e3 / step_ms:.2f} steps/s, "
            f"{audio * 1e3 / step_ms:.1f} audio s a second ({audio:.1f} s a batch), peak "
            f"{peak:.0f} MiB; profiled step: device {prof['device_ms']:.1f} ms ({prof['wall_ms']:.1f}"
            f" ms wall under the profiler), idle share {idle:.1%}; runs {first_wall:.1f} s + "
            f"{second_wall:.1f} s; launches {launches}")
        top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0])[:8]
        for name, (ms, n) in top:
            log(f"  {ms:8.3f} {n:5d}  {name[:110]}")
        figures.update(steps=len(steps), step_ms=step_ms, steps_per_s=1e3 / step_ms,
                       audio_s_per_s=audio * 1e3 / step_ms, peak_mem_mib=peak,
                       profile=dict(device_ms=prof["device_ms"], wall_ms=prof["wall_ms"],
                                    idle_share=idle),
                       launches=launches, launches_per_step=steps[0]["launches"],
                       decode_launches=dec_launches, batch=(b, t))
    return figures


# ---- phase 17: training SenseVoice and the Paraformer variants -----------------------

# SenseVoice's training keys. The repo holds no published SenseVoice value for them: the
# JAX class's defaults (lsm_weight 0, length_normalized_loss off, ignore_id -1), FunASR's
# template SpecAugLFR (TRAIN_SPECAUG_CONF, paraformer-large's) and phase 12's frontend
# (dither 0); the encoder has no dropout (the JAX loss passes it no key)
SV_TRAIN_MODEL_CONF = dict(lsm_weight=0.0, length_normalized_loss=False, ignore_id=-1)
# finetune.sh's flags (TRAIN_RECIPE) for one epoch of about 4 steps: the mid-epoch
# checkpoint and its validation at step 3, the profiled step the second, the epoch's
# checkpoint, the 2 best averaged
SV_TRAIN_RUN = ["++dataset=SenseVoiceDataset", "++train_conf.max_epoch=1",
                "++train_conf.save_checkpoint_interval=3", "++train_conf.avg_nbest_model=2",
                "++train_conf.profile_start_step=1", "++train_conf.profile_steps=1"]
SV_QUERY_ROWS = [1, 2, 3, 15]  # the prompt embed's rows sensevoice2jsonl's tags reach:
#                                event, emotion, <|zh|> -> 3, <|woitn|> -> 15
# (c) the losses at PROD_CONF width cut to 4 + 2 blocks (TRAIN_CPU_DEPTH), one step each on
# the card and on the CPU: 2 utterances of FAMILY_TRAIN_T seconds, ~4 characters a second
FAMILY_TRAIN_T = (6.0, 4.2)
FAMILY_TRAIN_TEXT = (24, 17)
FAMILY_TRAIN_GRAD_REL_TOL = 1e-4  # each gradient, CUDA against the CPU, relative L2
FAMILY_ZERO_SHARE = 1e-6  # a gradient under this share of the global norm is zero (PIF bias)
CT_TRAIN = (16, 100)      # CT-Transformer's batch: 16 windows of up to 100 tokens


def sv_train_sites(blocks):
    """Launches of each kernel in one SenseVoice training step (every block's attention
    and FSMN, forward and backward) and in one validation batch."""
    step = {"flash_attention": blocks, "flash_attention_bwd": blocks, "fsmn_memory": blocks,
            "fsmn_memory_bwd_input": blocks, "fsmn_memory_bwd_weight": blocks,
            "w8a8_linear": 0}
    val = dict(step, flash_attention_bwd=0, fsmn_memory_bwd_input=0, fsmn_memory_bwd_weight=0)
    return step, val


def family_train_sites(name, enc, dec):
    """Launches of each kernel in one training step (forward and backward) of ``name`` at
    ``enc`` encoder and ``dec`` decoder blocks: Paraformer's sites (the glancing sampler's
    no-grad decoder pass adds the decoder's FSMNs again); Paraformer-v2 has no sampler;
    BiCif and SeACo encode a second time, with gradients, for ``loss_pre2``; the
    encoder-only models their encoder's."""
    if name in ("SenseVoiceSmall", "CTC", "MonotonicAligner", "CTTransformer"):
        return sv_train_sites(enc)[0]
    twice = 2 if name in ("BiCifParaformer", "SeacoParaformer") else 1
    sampler = 0 if name == "ParaformerV2" else dec
    step, _ = train_sites(enc, dec)
    return dict(step, flash_attention=twice * enc, flash_attention_bwd=twice * enc,
                fsmn_memory=twice * enc + dec + sampler,
                fsmn_memory_bwd_input=twice * enc + dec,
                fsmn_memory_bwd_weight=twice * enc + dec)


def family_train_confs():
    """The nine losses' configs: PROD_CONF width at TRAIN_CPU_DEPTH (SenseVoice's 4 + 2
    SAN-M and tp blocks), the published heads of phases 9, 10 and 12, PROD_CONF's training
    keys (TRAIN_MODEL_CONF: the sampler at 0.75, lsm 0.1); CT-Transformer at ct-punc's
    published widths (4 blocks, d 256, 8 heads)."""
    enc_n, dec_n = TRAIN_CPU_DEPTH
    enc = dict(PROD_CONF["encoder_conf"], num_blocks=enc_n)
    para = dict(PROD_CONF, **TRAIN_MODEL_CONF, encoder_conf=enc,
                decoder_conf=dict(PROD_CONF["decoder_conf"], num_blocks=dec_n,
                                  att_layer_num=dec_n))
    v3 = dict(BICIF_PREDICTOR)
    return {
        "SenseVoiceSmall": dict(SV_CONF, lsm_weight=0.1, encoder_conf=dict(
            SV_CONF["encoder_conf"], num_blocks=enc_n, tp_blocks=dec_n)),
        "CTC": dict(input_size=560, vocab_size=PROD_CONF["vocab_size"], encoder_conf=enc),
        "ParaformerV2": dict({k: v for k, v in para.items() if k != "predictor_conf"},
                             ctc_weight=0.5),
        "EParaformer": dict({k: v for k, v in para.items() if k != "predictor_bias"},
                            predictor_conf=dict(idim=enc["output_size"], sigma_heads=4)),
        "BiCifParaformer": dict(para, predictor_conf=v3),
        "SeacoParaformer": dict(para, predictor_conf=v3, **SEACO_EXTRA),
        "ContextualParaformer": dict(para, **CONTEXTUAL_EXTRA),
        "MonotonicAligner": dict(input_size=560, encoder_conf=enc, predictor="CifPredictorV3",
                                 predictor_conf=v3, predictor_bias=1),
        "CTTransformer": dict(PUNC_MODEL_CONF, vocab_size=PUNC_VOCAB,
                              encoder_conf=dict(PUNC_ENC, dropout_rate=0.0)),
    }


def family_train_batch(name, model, rng):
    """One step's inputs: (feats, lengths, text, text lengths, the glancing sampler's
    uniforms or None) for the ASR models, (token ids, punctuation ids, lengths) for
    CT-Transformer."""
    from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
    if name == "CTTransformer":
        b, l = CT_TRAIN
        lens = torch.from_numpy(rng.integers(l // 3, l + 1, b)).int()
        lens[0] = l
        valid = torch.arange(l)[None] < lens[:, None].long()
        text = torch.from_numpy(rng.integers(0, model.embed.num_embeddings, (b, l))) * valid
        punc = torch.where(valid, torch.from_numpy(rng.integers(1, 6, (b, l))), -1)
        return text.long(), punc.long(), lens
    waves = [pcm(rng, s) for s in FAMILY_TRAIN_T]
    feats, flens = WavFrontend(**FRONTEND_CONF).extract(waves)
    tl = torch.tensor(FAMILY_TRAIN_TEXT)
    text = torch.full((2, max(FAMILY_TRAIN_TEXT)), -1, dtype=torch.long)
    for i, n in enumerate(FAMILY_TRAIN_TEXT):
        text[i, :n] = torch.from_numpy(rng.integers(3, 8000, n))
    uniform = None
    if name == "SenseVoiceSmall":
        tags = torch.tensor([[24884, 24993, 25004, 25017], [24885, 24994, 25001, 25016]])
        text, tl = torch.cat([tags, text], dim=1), tl + 4
    elif getattr(model, "sampling_ratio", 0) > 0 and name != "ParaformerV2":
        uniform = torch.from_numpy(rng.random((2, text.shape[1] + model.predictor_bias),
                                              dtype=np.float32))
    return (torch.from_numpy(np.ascontiguousarray(feats)), torch.from_numpy(flens), text, tl,
            uniform)


def grad_rel_errors(cpu_grads, gpu_grads):
    """Each parameter's gradient, CUDA against the CPU, relative L2; a gradient under
    FAMILY_ZERO_SHARE of the global norm on the CPU (zero in exact arithmetic: the PIF
    predictor's per-head bias, under which softmax does not move) is held to that floor
    on both instead. -> (worst relative error, its name, names over the floor's rule)."""
    total = math.sqrt(sum(float(g.double().square().sum()) for g in cpu_grads.values()
                          if g is not None))
    floor = FAMILY_ZERO_SHARE * total
    worst, worst_name, bad = 0.0, None, []
    for n, want in cpu_grads.items():
        got = gpu_grads[n]
        if want is None or got is None:
            if (want is None) != (got is None):
                bad.append(n)
            continue
        got = got.cpu()
        if want.norm() <= floor:
            if got.norm() > floor:
                bad.append(n)
            continue
        r = rel_l2(got, want)
        if not r <= worst:
            worst, worst_name = r, n
    return worst, worst_name, bad


@contextlib.contextmanager
def recorded_alignments():
    """Each Paraformer-v2 step's forced alignment: the log-probs and targets it was given
    and the indices it returned (on their device)."""
    import funasr_tpu_torch.models.paraformer_v2.model as v2
    align, calls = v2.ctc_forced_align_device, []

    def record(*args, **kwargs):
        out = align(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    v2.ctc_forced_align_device = record
    try:
        yield calls
    finally:
        v2.ctc_forced_align_device = align


def train_family_cuda_vs_cpu(dev, counters):
    """(c) One training step (loss + backward) of each new loss on the card and on the
    CPU, the same weights and inputs, dropout and SpecAug off, the sampler's draws fed
    equal, the CIF's last-fire tie moved alike (``cif_tie_moved``). Gates: the loss within
    TRAIN_LOSS_RTOL, every gradient within FAMILY_TRAIN_GRAD_REL_TOL relative L2
    (``grad_rel_errors``), the step's launches exactly ``family_train_sites``; on the card
    the device viterbi's indices equal the CPU's on the CPU step's log-probs, and
    Paraformer-v2's alignment inside the two steps alike. CT-Transformer's launches are
    recorded by signature for (b). Returns {name: figures} and CT's launch shapes."""
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.ops import cuda_lib
    from funasr_tpu_torch.ops.ctc_align import ctc_forced_align_device

    enc_n, dec_n = TRAIN_CPU_DEPTH
    out, ct_shapes = {}, None
    for name, conf in family_train_confs().items():
        t0 = time.perf_counter()
        rng = np.random.default_rng(17)
        cpu = tables.model_classes[name](**conf, generator=torch.Generator().manual_seed(17))
        gpu = copy.deepcopy(cpu).to(dev)
        batch = family_train_batch(name, cpu, rng)
        res = {}
        tie = cif_tie_moved() if name in ("BiCifParaformer", "SeacoParaformer",
                                          "ContextualParaformer") else contextlib.nullcontext()
        with tie, recorded_alignments() as aligned:
            for label, model in (("cpu", cpu), ("cuda", gpu)):
                model.train()
                d = next(model.parameters()).device
                if name == "CTTransformer":
                    args, kwargs = [x.to(d) for x in batch], {}
                else:
                    args = [x.to(d) for x in batch[:4]]
                    kwargs = {} if batch[4] is None else {"sampler_uniform": batch[4].to(d)}
                for c in counters:
                    c.launches = 0
                if label == "cuda" and name == "CTTransformer":
                    cuda_lib.record_launch_shapes()
                loss, stats, weight = model(*args, **kwargs)
                loss.backward()
                if d.type == "cuda":
                    torch.cuda.synchronize()
                if label == "cuda" and name == "CTTransformer":
                    lines = [dict(step=0, launches={c.__name__: c.launches for c in counters},
                                  kernel_shapes=cuda_lib.take_launch_shapes())]
                    cuda_lib.stop_recording_launch_shapes()
                    ct_shapes = recipe_launch_shapes(lines)
                res[label] = (loss.item(), {k: float(v.detach()) for k, v in stats.items()
                                            if torch.is_tensor(v) and v.dim() == 0},
                              int(weight), {n: p.grad for n, p in model.named_parameters()},
                              {c.__name__: c.launches for c in counters})
        (cl, cst, cw, cg, _), (gl, gst, gw, gg, launches) = res["cpu"], res["cuda"]
        worst, worst_name, bad = grad_rel_errors(cg, gg)
        # the losses among the stats (an accuracy is an argmax, whose near-ties may flip)
        stat_err = max(abs(gst[k] - v) / max(abs(v), 1.0) for k, v in cst.items()
                       if k.startswith("loss"))
        sites = family_train_sites(name, 6 if name == "SenseVoiceSmall" else
                                   PUNC_ENC["num_blocks"] if name == "CTTransformer"
                                   else enc_n, dec_n)
        fig = dict(loss_cpu=cl, loss_cuda=gl, loss_rel=abs(gl - cl) / abs(cl), stats_err=stat_err,
                   worst_grad_rel_l2=worst, worst_param=worst_name, launches=launches,
                   seconds=time.perf_counter() - t0)
        if name == "ParaformerV2":
            (cpu_args, cpu_kw, cpu_idx), (_, _, gpu_idx) = aligned
            again = ctc_forced_align_device(*[a.to(dev) for a in cpu_args], **cpu_kw)
            fig.update(viterbi_equal=bool(torch.equal(again.cpu(), cpu_idx)),
                       step_alignments_equal=bool(torch.equal(gpu_idx.cpu(), cpu_idx)),
                       viterbi_frames=int((cpu_idx >= 0).sum()))
        log(f"training step CUDA vs CPU, {name}: loss {gl:.7f} vs {cl:.7f} (rel "
            f"{fig['loss_rel']:.2e}, tol {TRAIN_LOSS_RTOL:g}; stats {stat_err:.2e}); worst "
            f"gradient rel L2 {worst:.2e} ({worst_name}, tol {FAMILY_TRAIN_GRAD_REL_TOL:g}); "
            f"launches {launches}" + (f"; viterbi on the card equal {fig['viterbi_equal']}, "
                                      f"the steps' alignments equal "
                                      f"{fig['step_alignments_equal']}"
                                      if name == "ParaformerV2" else "")
            + f" ({fig['seconds']:.1f} s)")
        if fig["loss_rel"] > TRAIN_LOSS_RTOL or stat_err > TRAIN_LOSS_RTOL or cw != gw:
            raise AssertionError(f"{name}: the CUDA loss disagrees with the CPU's")
        if not worst <= FAMILY_TRAIN_GRAD_REL_TOL or bad:
            raise AssertionError(f"{name}: gradients disagree ({worst_name} {worst}; {bad[:4]})")
        if launches != sites:
            raise AssertionError(f"{name}: launches {launches} != sites {sites}")
        if name == "ParaformerV2" and not (fig["viterbi_equal"] and fig["step_alignments_equal"]):
            raise AssertionError("the device viterbi on the card disagrees with the CPU's")
        out[name] = fig
        del cpu, gpu
    return out, ct_shapes


def sv_recipe_setup(root, dev):
    """SenseVoice's recipe inputs under ``root``: a seeded SenseVoiceSmall dir at its
    published width (phase 12's ``write_sense_voice_dir``, tags at their ids) whose config
    carries the training keys, and 16 + 4 generated wavs of 10-15 s written to jsonl by
    ``bin/data_tools sensevoice2jsonl`` (string tags: zh, NEUTRAL, Speech, with_itn
    false), a subprocess a split, both at once. Returns (model dir, {split: jsonl})."""
    md = os.path.join(root, "sensevoice-small")
    os.makedirs(md)
    t0 = time.perf_counter()
    write_sense_voice_dir(md, dev)
    with open(os.path.join(md, "config.yaml"), encoding="utf-8") as f:
        import yaml
        cfg = yaml.safe_load(f)
    cfg.update(specaug="SpecAugLFR", specaug_conf=TRAIN_SPECAUG_CONF)
    cfg["model_conf"].update(SV_TRAIN_MODEL_CONF)
    write_config(md, cfg)
    # characters only: the tag tokens sit at 24884 and after
    lists = write_train_data(root, np.random.default_rng(17), sv_tokens()[1:24884])
    log(f"SenseVoice training: model dir and {TRAIN_UTTS} + {TRAIN_VAL_UTTS} wavs written in "
        f"{time.perf_counter() - t0:.1f} s")
    jsonl = {split: os.path.join(root, f"sv_{split}.jsonl") for split in lists}
    run_clis([(["funasr_tpu_torch.bin.data_tools", "sensevoice2jsonl",
                f'++scp_file_list=["{scp}","{txt}"]', '++data_type_list=["source","target"]',
                f"++jsonl_file_out={jsonl[split]}"], f"data_tools sensevoice2jsonl {split}")
              for split, (scp, txt) in lists.items()])
    return md, jsonl


def embed_rows_reached(ckpt_path):
    """The prompt embed's rows that had a non-zero gradient (their Adam second moment)."""
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True, mmap=True)
    idx = list(state["state_dict"]).index("embed.weight")
    opt = state["optimizer"]
    v = opt["state"][opt["param_groups"][0]["params"][idx]]["exp_avg_sq"]
    return [i for i in range(v.shape[0]) if v[i].abs().max() > 0]


def phase_training_family(dev, counters, card):
    """Phase 17: (a) SenseVoice-Small's recipe: ``bin/data_tools sensevoice2jsonl`` and
    ``bin/train ++dataset=SenseVoiceDataset`` as subprocesses on a seeded SenseVoiceSmall
    at its published width (50 + 20 blocks, d 512, vocab 25,055) with its training keys,
    one epoch of token batches of 6,000 frames (a mid-epoch checkpoint with its
    validation, the epoch's, the 2 best averaged). Gates: a finite loss every step, every
    step's launches exactly 70 flash + 70 flash backward + 70 FSMN + 70 dx + 70 dw and
    every validation batch's 70 + 70, every linear_q_k_v's q / k rows, every fsmn_block
    and the prompt embed's rows of the data's tags reached by a gradient (the
    checkpoint's Adam moments), the average decoding through ``AutoModel`` at 70 + 70
    launches a batch. (b) a kernel-vs-plain row at every signature the recipe launched
    and at CT-Transformer's (16, 8, L, 32) flash backward and (16, L, 256) FSMN dx / dw,
    from (c)'s step (``recipe_kernel_rows``). (c) one step of each new loss on the card
    against the CPU (``train_family_cuda_vs_cpu``)."""
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.ops.flash_attention import flash_attention_bwd
    from funasr_tpu_torch.ops.fsmn import fsmn_memory_bwd_input, fsmn_memory_bwd_weight

    counters = (*counters, flash_attention_bwd, fsmn_memory_bwd_input, fsmn_memory_bwd_weight)
    torch.cuda.empty_cache()
    figures = {}
    blocks = SV_CONF["encoder_conf"]["num_blocks"] + SV_CONF["encoder_conf"]["tp_blocks"]
    step_sites, val_sites = sv_train_sites(blocks)

    # (c) first: its CT-Transformer step gives (b) its signatures
    t_part = time.perf_counter()
    figures["cuda_vs_cpu"], ct_shapes = train_family_cuda_vs_cpu(dev, counters)
    log(f"training family (c): CUDA against the CPU in {time.perf_counter() - t_part:.1f} s")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        md, jsonl = sv_recipe_setup(root, dev)
        out = os.path.join(root, "exp")
        profile_dir = os.path.join(root, "profile")
        t0 = time.perf_counter()
        run_cli(["funasr_tpu_torch.bin.train", f"++model={md}",
                 f"++train_data_set_list={jsonl['train']}",
                 f"++valid_data_set_list={jsonl['val']}", *TRAIN_RECIPE, *SV_TRAIN_RUN,
                 f"++output_dir={out}", f"++train_conf.profile_dir={profile_dir}"],
                "bin/train SenseVoice (epoch 0)")
        run_wall = time.perf_counter() - t0
        steps, vals = read_train_log(out)
        bad = [x["step"] for x in steps if not math.isfinite(x["loss"])]
        wrong = [(x["step"], x["launches"]) for x in steps if x["launches"] != step_sites]
        wrong += [("val", x["step"], x["launches"]) for x in vals
                  if x["launches"] != {k: v * x["batches"] for k, v in val_sites.items()}]
        for x in steps:
            log(f"  step {x['step']}: loss {x['loss']:.4f} loss_ctc {x['loss_ctc']:.4f} "
                f"loss_rich {x['loss_rich']:.4f} acc_rich {x['acc_rich']:.4f} grad_norm "
                f"{x['grad_norm']:.3f} peak {x.get('peak_mem_mib', 0):.0f} MiB")
        for x in vals:
            log(f"  validation at step {x['step']}: {x['batches']} batches, loss "
                f"{x['validate']['loss']:.4f}, launches {x['launches']}")
        if bad or wrong or len(vals) != 2:
            raise AssertionError(f"SenseVoice training: non-finite loss at {bad}; launches "
                                 f"off the sites {wrong[:3]}; {len(vals)} validations")
        latest = open(os.path.join(out, "model.pt.latest")).read().strip()
        ckpt = os.path.join(out, latest)
        checked, zero = grads_reached(ckpt)
        rows = embed_rows_reached(ckpt)
        metric_name = torch.load(ckpt, map_location="cpu", weights_only=True,
                                 mmap=True)["metric_name"]
        log(f"SenseVoice training: {checked} attention / FSMN weights checked in {latest}, "
            f"{len(zero)} never reached by a gradient; prompt embed rows reached {rows}; "
            f"n-best metric {metric_name!r}")
        if zero or checked != 2 * blocks or rows != SV_QUERY_ROWS or metric_name != "loss":
            raise AssertionError(f"SenseVoice weights without a gradient: {zero[:4]} "
                                 f"({checked} checked), embed rows {rows}, {metric_name}")

        # (b) every signature the recipe and CT-Transformer's step launched
        shapes = recipe_launch_shapes(steps + vals)
        log(f"SenseVoice training: {len(shapes)} kernel signatures over {len(steps)} steps "
            f"and {len(vals)} validations; CT-Transformer's step {len(ct_shapes)}")
        t_part = time.perf_counter()
        figures["recipe_rows"] = recipe_kernel_rows(dev, shapes)
        figures["ct_rows"] = recipe_kernel_rows(dev, ct_shapes)
        log(f"training family (b): kernel rows in {time.perf_counter() - t_part:.1f} s")

        # the average decodes
        am = AutoModel(model=out, init_param=os.path.join(out, "model.pt.avg"), device="cuda")
        waves = [np.asarray(pcm(np.random.default_rng(98), 12.0))]
        for c in counters:
            c.launches = 0
        res = am.generate(input=waves, language="auto")
        torch.cuda.synchronize()
        dec_launches = {c.__name__: c.launches for c in counters}
        log(f"averaged SenseVoice checkpoint through AutoModel(model=<output dir>): "
            f"{res[0]['key']} text of {len(res[0]['text'])} characters; launches {dec_launches}")
        if not isinstance(res[0]["text"], str) or dec_launches["flash_attention"] != blocks \
                or dec_launches["fsmn_memory"] != blocks:
            raise AssertionError("the averaged SenseVoice checkpoint did not decode through "
                                 "the kernels")
        del am

        seconds = recipe_batches(jsonl["train"])[:len(steps)]
        wall = [y["time"] - x["time"] for x, y in zip(steps, steps[1:])
                if y["step"] != 2 and x["step"] != 3]  # not the profiled step, nor a checkpoint's
        step_ms = statistics.median(wall) * 1e3 if wall else float("nan")
        audio = statistics.mean(seconds)
        with open(os.path.join(profile_dir, "summary.json")) as f:
            prof = json.load(f)
        idle = 1 - prof["device_ms"] / step_ms
        peak = max(x.get("peak_mem_mib", 0) for x in steps)
        launches = {k: sum(x["launches"][k] for x in steps + vals) for k in step_sites}
        log(f"SenseVoice training ({card}): {len(steps)} steps, {step_ms:.1f} ms a step "
            f"(median of {len(wall)}), {audio * 1e3 / step_ms:.1f} audio s a second "
            f"({audio:.1f} s a batch), peak {peak:.0f} MiB; profiled step: device "
            f"{prof['device_ms']:.1f} ms ({prof['wall_ms']:.1f} ms wall under the profiler), "
            f"idle share {idle:.1%}; the run {run_wall:.1f} s; launches {launches}")
        top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0])[:8]
        for name, (ms, n) in top:
            log(f"  {ms:8.3f} {n:5d}  {name[:110]}")
        figures.update(steps=len(steps), step_ms=step_ms, audio_s_per_s=audio * 1e3 / step_ms,
                       peak_mem_mib=peak, run_s=run_wall,
                       profile=dict(device_ms=prof["device_ms"], wall_ms=prof["wall_ms"],
                                    idle_share=idle),
                       launches=launches, launches_per_step=step_sites,
                       decode_launches=dec_launches)
    return figures


# ---- phase 18: streaming fine-tuning (paraformer-zh-streaming) ------------------------

# paraformer-zh-streaming as published (SURVEY.md:635-640; its template.yaml's training
# chunks): PROD_CONF widths, SANMEncoderChunkOpt with chunk sizes [12, 15], strides [8, 10],
# look-back 4 (dropout 0.1 as published: the chunk path applies none, as the JAX loss),
# the decoder at sanm_shfit 5
STREAM_TRAIN_CHUNKS = dict(chunk_size=[12, 15], stride=[8, 10], pad_left=[0, 0],
                           encoder_att_look_back_factor=[4, 4],
                           decoder_att_look_back_factor=[1, 1])
STREAM_TRAIN_ENCODER_CONF = dict(STREAM_ENCODER_CONF, dropout_rate=0.1, **STREAM_TRAIN_CHUNKS)
STREAM_TRAIN_SEED = 0      # the trainer's seed: its steps draw both chunk configs
# finetune.sh's flags (TRAIN_RECIPE) for one epoch of about 4 steps over phase 16's wavs:
# the mid-epoch checkpoint and its validation at step 3, the profiled step the second, the
# epoch's checkpoint, the 2 best averaged
STREAM_TRAIN_RUN = ["++train_conf.max_epoch=1", "++train_conf.save_checkpoint_interval=3",
                    "++train_conf.profile_start_step=1", "++train_conf.profile_steps=1",
                    "++train_conf.avg_nbest_model=2", f"++seed={STREAM_TRAIN_SEED}"]
STREAM_TRAIN_GRAD_REL_TOL = 1e-4  # each gradient, CUDA against the CPU, relative L2
STREAM_TRAIN_DECODE_S = 6.0       # the averaged checkpoint's stream, 600 ms a generate


def chunk_configs(kernel_shapes):
    """The chunk configs (the flash kernels' chunk-mode integers) a log line's launches ran,
    and whether every flash launch of it was in chunk mode."""
    flash = [e for e in kernel_shapes if e["kernel"].startswith("flash")]
    return ({tuple(e["args"][1:]) for e in flash if e["args"][0] == "chunk"},
            all(e["args"][0] == "chunk" for e in flash))


def streaming_decode_launches(am, counters, wav):
    """One stream through the averaged model's streaming ``generate`` (phase 11's call):
    (texts, chunks, launches, FSMN calls by (k, left pad))."""
    model = am.model
    inner, chunks = model.generate_chunk, []

    def counted(*args, **kwargs):
        chunks.append(1)
        return inner(*args, **kwargs)
    model.generate_chunk = counted
    split = FsmnSplit()
    try:
        for c in counters:
            c.launches = 0
        text, _ = run_stream(am, wav)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    finally:
        del model.generate_chunk
        split.remove()
    return text, len(chunks), launches, dict(split.counts)


def phase_streaming_training(dev, counters, card, keep):
    """Phase 18: streaming Paraformer's fine-tuning. (a) ``finetune.sh`` (the
    paraformer_streaming recipe's flags, sharding dp) through ``bin/train`` as a
    subprocess on a seeded paraformer-zh-streaming dir at full width (50 + 16 blocks, d
    512, vocab 8404, its training keys as phase 16's) over phase 16's generated wavs
    (``keep["train_data"]``), one epoch of token batches of 6,000 frames. Gates: a finite
    loss every step; both chunk configs drawn over the steps; each step's launches exactly
    phase 16's (``train_sites``) with every flash launch in chunk mode, each validation's
    its batches x the forward sites; every encoder linear_q_k_v's q / k rows and every
    fsmn_block reached by a gradient; the average of the 2 best checkpoints decoding
    through ``AutoModel``'s streaming ``generate`` at phase 11's launches a chunk (50 flash,
    50 FSMN (11, 5) and 16 (11, 10)). (b) a kernel-vs-plain row at every signature the
    recipe launched (chunk mode under each config, FSMN, dx, dw under the holed frame mask
    at (5, 5) and the decoder's (10, 0)), each within 1e-5 relative L2 and bit-equal across
    two runs (``recipe_kernel_rows(strict=True)``). (c) one step of each config on the card
    against the CPU at 4 + 2 blocks: the loss within TRAIN_LOSS_RTOL, every gradient within
    STREAM_TRAIN_GRAD_REL_TOL relative L2."""
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.ops.flash_attention import flash_attention_bwd
    from funasr_tpu_torch.ops.fsmn import fsmn_memory_bwd_input, fsmn_memory_bwd_weight

    counters = (*counters, flash_attention_bwd, fsmn_memory_bwd_input, fsmn_memory_bwd_weight)
    torch.cuda.empty_cache()
    figures = {}
    enc_n = PROD_CONF["encoder_conf"]["num_blocks"]
    dec_n = PROD_CONF["decoder_conf"]["num_blocks"]
    step_sites, val_sites = train_sites(enc_n, dec_n)

    # (c) first, while the card is clear of the recipe's process
    t_part = time.perf_counter()
    figures["cuda_vs_cpu"] = {
        f"config{ind}": train_cuda_vs_cpu(
            dev, counters, "ParaformerStreaming", STREAM_TRAIN_ENCODER_CONF, STREAM_DECODER_CONF,
            STREAM_TRAIN_GRAD_REL_TOL, chunk_index=ind)
        for ind in range(len(STREAM_TRAIN_CHUNKS["chunk_size"]))}
    log(f"streaming training (c): CUDA against the CPU in {time.perf_counter() - t_part:.1f} s")

    _, jsonl = keep["train_data"]
    with tempfile.TemporaryDirectory(dir=keep["root"]) as root:
        md = os.path.join(root, "paraformer-zh-streaming")
        os.makedirs(md)
        t0 = time.perf_counter()
        write_model_dir(md, dev, model_name="ParaformerStreaming", extra=TRAIN_MODEL_CONF,
                        encoder="SANMEncoderChunkOpt", encoder_conf=STREAM_TRAIN_ENCODER_CONF,
                        decoder_conf=STREAM_DECODER_CONF, frontend="WavFrontendOnline")
        import yaml
        with open(os.path.join(md, "config.yaml"), encoding="utf-8") as f:
            cfg = yaml.safe_load(f)
        cfg.update(specaug="SpecAugLFR", specaug_conf=TRAIN_SPECAUG_CONF)
        cfg["frontend_conf"]["dither"] = 1.0
        write_config(md, cfg)
        log(f"streaming training: model dir written in {time.perf_counter() - t0:.1f} s")
        out = os.path.join(root, "exp")
        profile_dir = os.path.join(root, "profile")
        t0 = time.perf_counter()
        run_cli(["funasr_tpu_torch.bin.train", f"++model={md}",
                 f"++train_data_set_list={jsonl['train']}",
                 f"++valid_data_set_list={jsonl['val']}", *TRAIN_RECIPE, *STREAM_TRAIN_RUN,
                 f"++output_dir={out}", f"++train_conf.profile_dir={profile_dir}"],
                "bin/train paraformer-zh-streaming (epoch 0)")
        run_wall = time.perf_counter() - t0
        steps, vals = read_train_log(out)
        bad = [x["step"] for x in steps if not math.isfinite(x["loss"])]
        wrong = [(x["step"], x["launches"]) for x in steps if x["launches"] != step_sites]
        wrong += [("val", x["step"], x["launches"]) for x in vals
                  if x["launches"] != {k: v * x["batches"] for k, v in val_sites.items()}]
        drawn, not_chunk = [], []
        for x in steps + vals:
            configs, all_chunk = chunk_configs(x["kernel_shapes"])
            drawn.append(sorted(configs))
            if not all_chunk:
                not_chunk.append(x["step"])
        for x, cfgs in zip(steps, drawn):
            log(f"  step {x['step']}: loss {x['loss']:.4f} loss_att {x['loss_att']:.4f} "
                f"loss_pre {x['loss_pre']:.4f} acc {x['acc']:.4f} grad_norm "
                f"{x['grad_norm']:.3f} chunk config {cfgs} peak "
                f"{x.get('peak_mem_mib', 0):.0f} MiB")
        for x in vals:
            log(f"  validation at step {x['step']}: {x['batches']} batches, loss "
                f"{x['validate']['loss']:.4f}, launches {x['launches']}")
        step_configs = set().union(*(set(c) for c in drawn[:len(steps)]))
        if bad or wrong or not_chunk or len(step_configs) != len(STREAM_TRAIN_CHUNKS["chunk_size"]):
            raise AssertionError(f"streaming training: non-finite loss at {bad}; launches off "
                                 f"the sites {wrong[:3]}; flash not in chunk mode at "
                                 f"{not_chunk}; chunk configs drawn {drawn}")
        latest = open(os.path.join(out, "model.pt.latest")).read().strip()
        checked, zero = grads_reached(os.path.join(out, latest))
        log(f"streaming training: {checked} attention / FSMN weights checked in {latest}, "
            f"{len(zero)} never reached by a gradient; chunk configs by step {drawn}")
        if zero or checked != 2 * enc_n + dec_n:
            raise AssertionError(f"weights without a gradient: {zero[:4]} ({checked} checked)")

        # (b) every signature the recipe launched
        shapes = recipe_launch_shapes(steps + vals)
        log(f"streaming training: {len(shapes)} kernel signatures over {len(steps)} steps and "
            f"{len(vals)} validations")
        t_part = time.perf_counter()
        figures["recipe_rows"] = recipe_kernel_rows(dev, shapes, strict=True)
        log(f"streaming training (b): kernel rows in {time.perf_counter() - t_part:.1f} s")
        holed = {name: [label for label, row in rows.items() if "mask" in row]
                 for name, rows in figures["recipe_rows"].items() if name.startswith("fsmn")}
        chunk_rows = {tuple(row["chunk"]) for name in ("flash_attention", "flash_attention_bwd")
                      for row in figures["recipe_rows"].get(name, {}).values() if "chunk" in row}
        if len(chunk_rows) < len(step_configs) or not all(holed.values()) or len(holed) != 3:
            raise AssertionError(f"streaming training: rows in chunk mode {chunk_rows}, under "
                                 f"the holed mask {holed}")

        # the average decodes through the streaming generate
        am = AutoModel(model=out, init_param=os.path.join(out, "model.pt.avg"), device="cuda",
                       log_level="WARNING")
        wav = np.asarray(pcm(np.random.default_rng(97), STREAM_TRAIN_DECODE_S), np.float32) / 32768
        text, chunks, dec_launches, by_call = streaming_decode_launches(am, counters, wav)
        log(f"averaged streaming checkpoint through AutoModel's streaming generate: "
            f"{chunks} chunks, text of {len(text)} characters; launches {dec_launches}, FSMN "
            f"by (k, left pad) {by_call}")
        if not isinstance(text, str) or dec_launches["flash_attention"] != enc_n * chunks \
                or dec_launches["fsmn_memory"] != (enc_n + dec_n) * chunks \
                or by_call != {(11, 5): enc_n * chunks, (11, 10): dec_n * chunks}:
            raise AssertionError("the averaged streaming checkpoint did not decode through "
                                 "the kernels at phase 11's launches")
        del am

        seconds = recipe_batches(jsonl["train"])[:len(steps)]
        wall = [y["time"] - x["time"] for x, y in zip(steps, steps[1:])
                if y["step"] != 2 and x["step"] != 3]  # not the profiled step, nor a checkpoint's
        step_ms = statistics.median(wall) * 1e3 if wall else float("nan")
        audio = statistics.mean(seconds)
        with open(os.path.join(profile_dir, "summary.json")) as f:
            prof = json.load(f)
        idle = 1 - prof["device_ms"] / step_ms
        peak = max(x.get("peak_mem_mib", 0) for x in steps)
        launches = {k: sum(x["launches"][k] for x in steps + vals) for k in step_sites}
        log(f"streaming training ({card}): {len(steps)} steps, {step_ms:.1f} ms a step (median "
            f"of {len(wall)}), {audio * 1e3 / step_ms:.1f} audio s a second ({audio:.1f} s a "
            f"batch), peak {peak:.0f} MiB; profiled step: device {prof['device_ms']:.1f} ms "
            f"({prof['wall_ms']:.1f} ms wall under the profiler), idle share {idle:.1%}; the "
            f"run {run_wall:.1f} s; launches {launches}")
        top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0])[:8]
        for name, (ms, n) in top:
            log(f"  {ms:8.3f} {n:5d}  {name[:110]}")
        figures.update(steps=len(steps), step_ms=step_ms, audio_s_per_s=audio * 1e3 / step_ms,
                       peak_mem_mib=peak, run_s=run_wall, chunk_configs=drawn,
                       profile=dict(device_ms=prof["device_ms"], wall_ms=prof["wall_ms"],
                                    idle_share=idle),
                       launches=launches, launches_per_step=step_sites,
                       decode_launches=dec_launches, decode_chunks=chunks)
    return figures


STREAMING_ENTRIES = {
    "flash_attention": [(f"{key}_{dt}", ("flash_attention", "streaming", key, dtype))
                        for key in [f"keys{tk}" for tk in STREAM_FLASH_KEYS] + ["causal",
                                                                                 "corner30"]
                        for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))],
    "fsmn_memory": [(f"{key}_{dt}", ("fsmn_memory", "streaming", key, dtype))
                    for key in [f"step{t}" for t in STREAM_FSMN_ROWS]
                    for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))],
}


# the kernel rows at SenseVoice's shapes: kernel -> [(label, record key)]
SENSEVOICE_ENTRIES = {
    "flash_attention": [(dt, ("flash_attention", "sensevoice", dtype))
                        for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))],
    "fsmn_memory": [(dt, ("fsmn_memory", "sensevoice", dtype))
                    for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))],
    "w8a8_linear": [(f"block_{k}x{n}_bf16", ("w8a8_linear", "sensevoice", (k, n)))
                    for k, n in SV_W8A8_BLOCKS]
                   + [("ctc_head_bf16", ("w8a8_linear", "sensevoice", torch.bfloat16))],
}


# the kernel rows at the serving shapes: kernel -> [(label, record key)]
SERVING_ENTRIES = {name: [(f"{b}x{t}_fp32", (name, "serving", (b, t)))
                          for b, t in [(8, 384)] + [(1, t) for t in SERVE_T]]
                   for name in ("flash_attention", "fsmn_memory")}


# the kernel rows at the pipeline's shapes: kernel -> [(label, record key, the phase 8
# stage whose launches they are, None where the default fp32 pipeline does not run it)]
PIPELINE_ENTRIES = {
    "flash_attention": [("punc_fp32", ("flash_attention", "punc", torch.float32), "punc"),
                        ("punc_bf16", ("flash_attention", "punc", torch.bfloat16), None)],
    "fsmn_memory": [("vad", ("fsmn_memory", "vad"), "vad"),
                    ("punc", ("fsmn_memory", "punc"), "punc")],
}


# flash's and FSMN's rows at the LLM path's shapes: kernel -> [(label, record key)]; the
# W8A8 rows are those of the shapes the W8A8 run launched (``llm_w8a8_rows``, ``w8a8_label``)
LLM_ENTRIES = {
    "flash_attention": [(dt, ("flash_attention", "llm", dtype))
                        for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))],
    "fsmn_memory": [(dt, ("fsmn_memory", "llm", dtype))
                    for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))],
}


def kernels_line(record, launches, am_launches, fp32_launches, pipeline=None, speaker=None,
                 hotword=None, streaming=None, sensevoice=None, serving=None, llm=None,
                 export=None, training=None, training_family=None, streaming_training=None):
    """The kernels' JSON record: one entry per kernel at its main-path shape, ``launches``
    of the main path's run (2 decodes; W8A8: one AutoModel W8A8 decode) and
    ``launches_per_decode``; flash and FSMN carry their fp32 figures under ``fp32``, with
    the launches of one decode of the default (fp32) AutoModel, and their rows at the
    pipeline's shapes under ``pipeline``, with the launches of phase 8's requests
    (``pipeline``: its per-request stats). Every kernel carries phase 9's launches under
    ``speaker`` (``speaker``: its per-request stats), by stage, and phase 10's under
    ``hotword`` (``hotword``: its figures), per counted decode; FSMN adds there its k = 21
    rows (the SeACo decoder's memory) with their launches per decode. Phase 11's figures
    (``streaming``) go under ``streaming``: launches of the fp32 and bf16 streams and per
    chunk, the realtime punctuation's, and the kernel rows at the streaming shapes
    (``STREAMING_ENTRIES``); FSMN splits its chunk launches into (11, 5) and (11, 10).
    Phase 12's (``sensevoice``) go under ``sensevoice``: launches of one SenseVoice decode at
    each setting, their sum, the profile's device ms per decode, and the kernel's rows at
    SenseVoice's shapes (``SENSEVOICE_ENTRIES``). Phase 13's (``serving``) go under
    ``serving``: each kernel's launches over the four server runs, by server, and flash's and FSMN's
    rows at the serving shapes (``SERVING_ENTRIES``). Phase 14's (``llm``) go under ``llm``:
    launches of each Fun-ASR-Nano setting and of AutoModelVLLM, the sites x calls each run
    was held to, and the rows at the LLM path's shapes (``LLM_ENTRIES``; W8A8's at the
    shapes of the W8A8 run, labelled by ``w8a8_label``). Phase 15's (``export``) go under
    ``export``: launches of the exported programs' counted calls, by setting and bucket, the
    rows at every shape those calls launched (``export_kernel_rows``, labelled by
    ``export_label``, each with its launches a call by program), and a lone call's ms
    through the custom op and directly (``op_dispatch_rows``). Phase 16's (``training``):
    each forward kernel's launches in the recipe's runs under ``training``, and three more
    kernels, the backward launches (``TRAIN_BACKWARD``), each at the recipe's first batch
    shape, ``launches`` those of the recipe's runs (the sums of the trainer's per-step and
    per-validation counts), flash's rows in each mode under ``rows``; each of the five
    kernels' rows at every shape the recipe launched (``recipe_kernel_rows``, labelled by
    ``recipe_label``) under ``recipe_rows`` (the forward kernels': in ``training``). Phase
    17's (``training_family``) go under ``training_family`` in each of those five
    (``family_entry``), phase 18's (``streaming_training``) under ``streaming_training``
    (``streaming_training_entry``)."""
    per_decode = {"flash_attention": launches["flash_attention"] / 2,
                  "fsmn_memory": launches["fsmn_memory"] / 2,
                  "w8a8_linear": am_launches["w8a8_linear"]}
    sources = {
        "flash_attention": ("funasr_tpu_torch/csrc/flash_attention.cu",
                            "funasr_tpu/ops/flash_attention.py:63", launches),
        "fsmn_memory": ("funasr_tpu_torch/csrc/fsmn.cu", "benchmarks/bench_pallas_dwconv.py:21",
                        launches),
        "w8a8_linear": ("funasr_tpu_torch/csrc/w8a8.cu", "benchmarks/bench_pallas_w8a8.py:18",
                        am_launches),
    }
    kernels = []
    for name, (src, tpu, counts) in sources.items():
        entry = dict(name=name, route="cuda", source=src, replaces=tpu, launches=counts[name],
                     launches_per_decode=per_decode[name], library_call=LIBRARY_CALLS[name],
                     **record[(name, torch.bfloat16)])
        if (name, torch.float32) in record:
            entry["fp32"] = dict(launches=fp32_launches[name],
                                 launches_per_decode=fp32_launches[name],
                                 **record[(name, torch.float32)])
        for label, key, stage in PIPELINE_ENTRIES.get(name, ()) if pipeline else ():
            n = sum(r[f"{stage}_launches"][name] for r in pipeline) if stage else 0
            entry.setdefault("pipeline", {})[label] = dict(
                launches=n, launches_per_request=n / len(pipeline), **record[key])
        if speaker:
            by_stage = {st: sum(r[f"{st}_launches"][name] for r in speaker)
                        for st in ("vad", "asr", "punc")}
            total = sum(by_stage.values())
            entry["speaker"] = dict(launches=total, launches_per_request=total / len(speaker),
                                    by_stage=by_stage)
        if hotword:
            runs = {"_".join(map(str, key)): v for key, v in hotword.items()
                    if isinstance(key, tuple)}  # ("seaco", "fp32", 20) -> "seaco_fp32_20"
            decodes = {k: v["launches"][name] for k, v in runs.items()}
            entry["hotword"] = dict(launches=sum(decodes.values()), launches_per_decode=decodes,
                                    pipeline_launches=sum(r["asr_launches"][name]
                                                          for r in hotword["pipeline"]))
            if name == "fsmn_memory":
                for dtype, dt in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
                    k21 = {k: v["k21_launches"] for k, v in runs.items() if f"_{dt}_" in k}
                    entry["hotword"][f"k21_{dt}"] = dict(
                        launches=sum(k21.values()), launches_per_decode=k21,
                        **record[("fsmn_memory", "hotword", dtype)])
        if streaming and name in STREAMING_ENTRIES:
            runs = {dt: streaming[dt] for dt in ("fp32", "bf16")}
            entry["streaming"] = dict(
                launches=sum(r["launches"][name] for r in runs.values()),
                launches_per_chunk={dt: r["launches_per_chunk"][name] for dt, r in runs.items()},
                punc_launches=streaming["punc"]["launches"][name],
                rows={label: record[key] for label, key in STREAMING_ENTRIES[name]})
            if name == "fsmn_memory":
                entry["streaming"]["profile_per_chunk"] = {
                    dt: {k: v for k, v in r["profile_per_chunk"].items() if "fsmn" in k}
                    for dt, r in runs.items()}
        if sensevoice:
            decodes = {label: sensevoice[label]["launches"][name] for label, _ in SV_SETTINGS}
            entry["sensevoice"] = dict(
                launches=sum(decodes.values()), launches_per_decode=decodes,
                profile_ms_per_decode={label: sensevoice[label]["profile"][name]["ms"]
                                       for label, _ in SV_SETTINGS},
                demo_asr_launches=sum(r["asr_launches"][name] for r in sensevoice["demo"]),
                rows={label: record[key] for label, key in SENSEVOICE_ENTRIES[name]})
            if name in sensevoice["demo_kernels"]["rows"]:
                entry["sensevoice"]["rows"]["demo_asr_fp32"] = (
                    sensevoice["demo_kernels"]["rows"][name])
        if serving:
            entry["serving"] = dict(
                launches=serving["launches"][name],
                by_server={srv: serving[srv]["launches"][name] for srv in SERVERS},
                rows={label: serving["rows"][key] for label, key in SERVING_ENTRIES.get(name, ())})
        if llm:
            runs = [label for label, _ in LLM_SETTINGS]
            entry["llm"] = dict(
                launches=llm["launches"][name],
                by_run={**{label: llm[label]["launches"][name] for label in runs},
                        "vllm": llm["vllm"]["launches"][name]},
                sites_x_calls={**{label: llm[label]["sites"][name] for label in runs},
                               "vllm": llm["vllm"]["sites"][name]},
                rows={label: llm["rows"][key] for label, key in LLM_ENTRIES.get(name, ())})
            if name == "w8a8_linear":
                entry["llm"]["rows"] = {w8a8_label(key[2]): row for key, row in llm["rows"].items()
                                        if key[0] == name}
        if export:
            entry["export"] = dict(launches=export["launches"][name], launches_per_call={
                f"{label}_b{c['bucket'][0]}_t{c['bucket'][1]}": c["launches"][name]
                for label in ("fp32", "w8a8") for c in export[label]["calls"]},
                rows=export["rows"].get(name, {}), **export["op_dispatch"][name])
        if training:
            entry["training"] = dict(launches=training["launches"][name],
                                     launches_per_step=training["launches_per_step"][name],
                                     recipe_rows=training["recipe_rows"].get(name, {}))
        if training_family:
            entry["training_family"] = family_entry(training_family, name)
        if streaming_training and name != "w8a8_linear":
            entry["streaming_training"] = streaming_training_entry(streaming_training, name)
        kernels.append(entry)
    for name, (src, keys) in (TRAIN_BACKWARD.items() if training else ()):
        rows = training["rows"]
        entry = dict(name=name, route="cuda", source=src, replaces=sources[
            "flash_attention" if "flash" in name else "fsmn_memory"][1],
            gradient_of=("the kernel of that TPU kernel's port; the JAX package takes its "
                         "gradient by XLA autodiff of the einsum path "
                         "(funasr_tpu/models/sanm/attention.py:121-133)"),
            launches=training["launches"][name],
            launches_per_step=training["launches_per_step"][name], **rows[keys[0]],
            recipe_rows=training["recipe_rows"][name])
        if len(keys) > 1:
            entry["rows"] = {key[1]: rows[key] for key in keys}
        if training_family:
            entry["training_family"] = family_entry(training_family, name)
        if streaming_training:
            entry["streaming_training"] = streaming_training_entry(streaming_training, name)
        kernels.append(entry)
    return {"kernels": kernels}


def streaming_training_entry(fig, name):
    """A kernel's phase 18 figures: its launches in the streaming recipe's run (steps and
    validations) and a step, its rows at every signature that run launched (chunk mode's
    under each config, the holed mask's), its launches in each config's CUDA step of (c)
    and in the averaged checkpoint's streaming decode."""
    return dict(launches=fig["launches"][name], launches_per_step=fig["launches_per_step"][name],
                recipe_rows=fig["recipe_rows"].get(name, {}),
                cuda_vs_cpu_launches={k: f["launches"][name]
                                      for k, f in fig["cuda_vs_cpu"].items()},
                decode_launches=fig["decode_launches"][name], decode_chunks=fig["decode_chunks"])


def family_entry(family, name):
    """A kernel's phase 17 figures: its launches in SenseVoice's recipe run (steps and
    validations) and a step, its rows at every signature that run launched
    (``recipe_rows``) and at CT-Transformer's step (``ct_rows``), and its launches in
    each loss's CUDA step of (c)."""
    return dict(launches=family["launches"][name],
                launches_per_step=family["launches_per_step"][name],
                recipe_rows=family["recipe_rows"].get(name, {}),
                ct_rows=family["ct_rows"].get(name, {}),
                cuda_vs_cpu_launches={m: f["launches"][name]
                                      for m, f in family["cuda_vs_cpu"].items()})


# phase 16's backward kernels: name -> (source, record keys; the first is the line's row)
TRAIN_BACKWARD = {
    "flash_attention_bwd": ("funasr_tpu_torch/csrc/flash_attention_bwd.cu",
                            [("flash_attention_bwd", m) for m in ("none", "causal", "corner")]),
    "fsmn_memory_bwd_input": ("funasr_tpu_torch/csrc/fsmn.cu (the forward kernel, taps "
                              "reversed, pads swapped)", [("fsmn_memory_bwd_input",)]),
    "fsmn_memory_bwd_weight": ("funasr_tpu_torch/csrc/fsmn.cu", [("fsmn_memory_bwd_weight",)]),
}


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    import funasr_tpu_torch
    from funasr_tpu_torch.ops import cuda_lib
    from funasr_tpu_torch.ops.flash_attention import flash_attention
    from funasr_tpu_torch.ops.fsmn import fsmn_memory
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear

    lib = cuda_lib.load_library()
    log(f"build: {lib.build_seconds:.1f} s (nvcc, sm_90a, one process per source) -> "
        f"{lib._name}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  " + line.strip())

    counters = (flash_attention, fsmn_memory, w8a8_linear)

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{label} done in {time.perf_counter() - t0:.1f} s ({time.perf_counter() - t_start:.1f}"
            f" s since the start)")
        return out

    record = timed("kernels", phase_kernels, dev)
    record[("w8a8_linear", torch.bfloat16)] = timed("w8a8 kernel", phase_w8a8_kernel, dev)
    timed("CUDA vs CPU", phase_cuda_vs_cpu, dev)
    timed("CUDA vs CPU W8A8", phase_cuda_vs_cpu_w8a8, dev)
    launches = timed("main path", phase_main_path, dev, funasr_tpu_torch.tables, counters, card)
    am_launches, fp32_launches = timed("AutoModel", phase_automodel, dev, counters, card)
    # the model dirs phase 13 serves, kept from phases 8, 9 and 11 (removed at the end)
    with tempfile.TemporaryDirectory() as keep_root:
        keep = {"root": keep_root}
        pipeline = timed("pipeline", phase_pipeline, dev, counters, card, keep)
        speaker = timed("speaker", phase_speaker, dev, counters, card, keep)
        hotword = timed("hotword", phase_hotword, dev, counters, card)
        streaming = timed("streaming", phase_streaming, dev, counters, card, keep)
        sensevoice = timed("SenseVoice", phase_sensevoice, dev, counters, card, keep)
        serving = timed("serving", phase_serving, dev, counters, card, keep)
        llm = timed("LLM", phase_llm, dev, counters, card)
        export = timed("text and export", phase_export, dev, counters, card, keep)
    # phase 16's generated wavs serve phase 18 (removed at the end)
    with tempfile.TemporaryDirectory() as train_root:
        keep_train = {"root": train_root}
        training = timed("training", phase_training, dev, counters, card, keep_train)
        family = timed("training family", phase_training_family, dev, counters, card)
        stream_training = timed("streaming training", phase_streaming_training, dev, counters,
                                card, keep_train)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line(record, launches, am_launches, fp32_launches, pipeline,
                                  speaker, hotword, streaming, sensevoice, serving, llm,
                                  export, training, family, stream_training),
                     default=str))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--stream-profile"]:
        stream_profile(sys.argv[2], sys.argv[3] == "bf16")
    elif sys.argv[1:2] == ["--exported"]:
        exported_child(sys.argv[2])
    elif sys.argv[1:2] == ["--recipe-ab"]:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; needs an "
                             "NVIDIA GPU")
        recipe_ab(*sys.argv[2:3])
    else:
        main()
