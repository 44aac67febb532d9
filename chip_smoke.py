#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py [--profile DIR]

Phases (any failure exits non-zero; nothing is caught and skipped):

1. print the card's name and power limit, build the CUDA kernels from
   ``funasr_torch/csrc`` with ``nvcc`` for ``sm_90a`` (one process per
   source, in parallel);
2. hold each kernel against its plain PyTorch twin on the card at the main
   paths' shapes and time kernel, twin and, where one exists, a library
   call the port never calls (the yardstick):
   - fbank at 64 x 15 s, ragged, with and without the energy column,
     against its twin and against the float64 exact value
     (``fbank_fft_route``), timed also in a CUDA graph (bar 0.40 ms) and
     beside the float32 cuFFT route (several library calls);
     encoder self-attention and decoder cross-attention in bf16 and
     float32 (yardstick ``scaled_dot_product_attention``), the float32
     encoder self-attention within ``F32_SDPA_BAR`` (1.25) x SDPA's time
     (here at d = 128, in ``check_head64_kernels`` at d = 64); every
     float32 case records beside ``bound_ms`` the split-TF32 tensor-core
     bound (``split_tf32_bound_ms``);
   - the int8 GEMM at every (M, K, N) of the int8 path and at edge
     shapes (ragged M, K below one stage, fewer tiles than SMs), its int32
     accumulator and its epilogue bit-equal to the twin (yardstick
     ``torch._int_mm`` where its shape rules allow); each served shape
     within 2x ``torch._int_mm``, or 4x its bound where that does not run
     (``ctc_lo``'s N = 25055: 2x ``torch._int_mm`` at N = 25056);
   - the int8 SANM encoder layer (B=64, T=256, lengths 250/200), the int8
     decoder layer (B=64, U=128, T=256) and the int8 FFN (M=16384,
     512 -> 2048 -> 512); the layers' float32-context attention alone at
     both layers' shapes, bit-equal (yardstick ``scaled_dot_product_attention``
     on the same bf16-rounded q, k, v), and at T=1000 with its scores in the
     device scratch, row-chunked;
   - the CTC prefix recurrence at the beam's shape (B=32, K=10, W=16,
     T=383), bit-equal to its twin (bar 1e-6 * max(1, |ref|)); the beam's
     whole CTC prefix step in one launch (gather, phi, recurrence, sigma)
     at that shape, at step 0 and at edges, r_new and sigma against the
     twin at the same bar, timed by events and CUDA graph (bar 0.10 ms) beside the unfused
     composition it replaced and the chain floor (``ctc_chain_floor``);
   - the fused int8 matmul (qmm) at the three gated contractions of the
     BiCif path and edge shapes (K up to 3072), bit-equal to its twin
     (beside it the rowquant + int8 GEMM pair of the XLA route and
     ``torch._int_mm``), the three timed within the GEMM's bars;
     the int8-score attention at the SANM shape and edges (T=1000 with the
     scores in the scratch), bit-equal, and
     the SANM layer with ``int8_attn``; the bf16 and float32 FFN at
     (16384, 512) -> 2048 -> 512 and ragged edges (M = 1 and 65, H = 544
     and 8192) within FFN_TOL, timed by events and CUDA graph beside its
     yardstick (two ``F.linear`` and a relu, which the bf16 kernel must beat
     by CUDA graph), one kernel a call in a profile, its only launches in
     this script;
   - edge shapes: ragged T and U, one frame, lengths of 0, fbank at 40
     mels and with fewer samples than a frame; every float32 attention
     instance (d = 128, 64, 32, ALiBi) at its tiles' edges
     (``check_f32_edges``) and a misaligned float32 k refused; for the CTC
     kernel rows not a multiple of its block, T=1, rows NEG_INF throughout
     and T=1500 (60 s);
   - the int8 GEMM's row-quantizing entry (``int8_gemm_rq``: the SANM
     layer's ctx -> wout, the row quantize in its A producer and the FSMN
     memory in its epilogue) at the served shape and edges (M=37, T=1,
     lengths of 0, tiles straddling utterances, K=16 and 640, no residual
     or bias), bit-equal to its twin, timed (CUDA graphs, ``graph_ms``)
     beside the rowquant + FSMN + int8 GEMM launches it replaces; the
     decoder's LN + FSMN (``fsmn_ln``) the same way beside the
     layer-norm-only rowquant + FSMN; the standalone rowquant and FSMN
     kernels against their twins (the FSMN kernel has no caller on a
     path: the SANM layer folds it into its wout GEMM, the decoder into
     ``fsmn_ln``);
3. build full-width Paraformer-large (vocab 8404, 50 + 16 layers, D=512)
   with seeded random weights and serve three batches of mixed 2-15 s
   requests through ``ParaformerEngine.transcribe``, first in bf16, then
   int8 (``quantize=True``), each with the kernels' launch counters set to
   0 just before and read just after and held to the exact count of each
   kernel on that path (the int8 layers' building blocks,
   ``layer_launches``); compare float32 kernels against
   twins and int8 kernels against their twins on the same weights; time
   both device programs at B=64 x 15 s (the shape of ``bench.py``);
   then build the full-width Conformer of ``configs/conformer_hybrid.yaml``
   (12 x 256 encoder, 6-layer decoder, vocab 4233) and serve the same three
   batches through ``HybridEngine.transcribe`` in the serving configuration
   of ``bench_beam.py`` (bf16, ``quantize=True``, int8 KV cache, beam 10,
   maxlen 96, CTC weight 0.3) with the counters read the same way (one CTC
   prefix step launch per decode step, no launch of the recurrence entry);
   compare the float32 beam with the step kernel and with its twin; time
   the beam at B=32 x 15 s (kernel launches per decode step from its
   profile);
   then build full-width int8 BiCif Paraformer-large with both opt-in
   routes (``qmm=True, int8_attn=True``) and serve the same three batches
   with 20 ms timestamps through ``BiCifEngine.transcribe``, counters read
   the same way (qmm once per gated contraction, the int8-score attention
   in encoder layers 1-49, the float32-context attention only in the
   decoder); compare route kernels against twins and the float32 BiCif's
   kernels against twins (tokens, fires and timestamps equal); decode five
   segments of a 60 s recording from its shared fbank grid
   (``transcribe_from_fbank``) against ``transcribe`` of the sliced
   waveforms; serve one batch of the "cnn_blstm" variant; time the B=64 x
   15 s BiCif program with the routes on and off, in turns;
   then the long-audio pipeline, the main path:
   ``AutoModel(model=int8 BiCif, vad_model=FSMN-VAD,
   punc_model=CT-Transformer, quantize=True).generate`` of a 600 s
   recording (bursts of tone over noise, one of 20 s) at full width on
   seeded random weights, (a) as it is and (b) with the state machine's
   output replaced by the recording's burst plan merged to <= 15 s; each
   with every counter held to its exact count (fbank once, the int8
   layers' blocks per ASR batch, punctuation's head-size-32 attention once a
   layer a window round) and no host sync inside a batch's dispatch
   (``torch.cuda.set_sync_debug_mode("error")``); (b) again with the int8
   layers' and punctuation's attention twins (BiCif bars; punctuation
   labels agree >= 0.99); the VAD stage with the fbank kernel against its
   twin (posteriors abs 5e-3, decibels abs 1e-3); the head-size-32
   attention at punctuation's shape and edges (T = 1, ragged, a length of
   0) in bf16 and float32 against its twin, timed beside SDPA; stage times
   (VAD device and host, ASR device and host, punctuation) by CUDA events
   and wall clock, and audio-s/s of each ``generate``; pipeline run (c)
   (``end_to_end_pipeline_c``): ``AutoModel(model=int8 SeACo-Paraformer,
   vad_model=FSMN-VAD, punc_model=CT-Transformer, spk_model=CAM++,
   quantize=True).generate(hotword=<10 words of 2-4 tokens>,
   preset_spk_num=2)`` of a 600 s two-voice recording (the burst plan for
   segments, as (b); the bias head's no-bias logit raised by the median
   margin of a probe batch so both merge branches run), its counters exact
   (fbank once for the VAD, once per ASR batch on the waveform path, once
   for the speaker chunks; per batch the int8 layers' blocks plus the SeACo
   decoder's 3 layers twice over the H + 1 = 11 hotword rows and its gated
   FFN-only tail) with no host sync inside a batch's or the speaker chunks'
   dispatch; again on the twins (int8 layers, punctuation's attention, fbank
   of the speaker chunks): tokens >= 0.99, token lengths and fire counts
   equal, merged log-probs abs 1e-3 where the merge branch did not flip
   (flips counted), timestamps equal when none flipped, every speaker
   embedding at cosine >= 0.999 to its twin's, ``spk_info`` equal; fbank on
   the speaker-chunk batch against its twin (1e-3) and the exact value
   (1e-4); the int8 decoder layer and its attention at the SeACo shapes
   (H + 1 = 2, 11, 51 memory rows, 1024 units) against their twins; stage
   times (VAD, ASR dispatch, punctuation, speaker embedding by events and
   wall, clustering on the host);
   then streaming (``end_to_end_streaming``): the float32 attention kernel
   at the window step's shapes (15 queries over a 40-frame KV cache plus
   the 15-frame window, the cache empty, partial, full and a final window
   of 3 frames; 18 decoder rows over 15 frames, prefixes 5 and 15) and the
   fbank kernel on one 600 ms step, against their twins; full-width
   float32 streaming Paraformer-large (``ParaformerStreaming``, chunk
   (0, 10, 5), look-back 4) over a 60 s recording in 600 ms chunks, its
   counters exact (attention 66 a window step, fbank once a frontend step
   that yields frames) with no host sync inside a step's dispatch, and
   again with the twins (per-window token counts equal, tokens >= 0.99,
   log-probs abs 1e-2); the step's span, wall time, launches, real-time
   factor and byte bound; one offline, one online and four concurrent
   2pass sessions through ``AsrWebSocketServer`` (the pipeline's
   ``AutoModel`` for the offline pass) with their replies checked;
   then SenseVoiceSmall at the width and depth of
   configs/sensevoice_small.yaml (50 + 20 SANM layers, D = 512, vocab 25055
   with the generated token list, a CMVN file of the recording's features):
   a SANM layer and encoders0's attention at a 16 x 15 s batch (T + 4 =
   260) and the int8 GEMM at ``ctc_lo``'s (4160, 512) x (25055, 512),
   against their twins and timed (the GEMM within 2x ``torch._int_mm``
   on one more weight row, where its shape rules let it run); (a) ``SenseVoiceEngine.transcribe`` with
   timestamps of three mixed 2-15 s batches in float32 and in int8, the
   counters exact (int8: fbank 1, SANM layer 69, FFN 1, d = 128 attention
   1 a batch plus the gated QDense) with no host sync in a dispatch,
   kernels against twins (float32 log-probs 1e-2, frames >= 0.99; int8
   1e-3, >= 0.99, token lengths equal; timestamps equal on every row whose
   tokens are); (b) FunASR's README call ``AutoModel(model=SenseVoiceSmall,
   vad_model=FSMN-VAD, max_single_segment_time 30 s, quantize=True)
   .generate(language="auto", use_itn=True, batch_size_s=60, merge_vad=True,
   merge_length_s=15)`` of the 600 s recording on (b)'s burst plan, its
   counters exact, again on the int8 twins (text and timestamps equal),
   with ``language="zh"`` (ITN rewrites segments: ``ctc_lo``'s number-word
   bias is raised by a probe batch's median margin), and warm, profiled:
   wall, audio-s/s, stages (VAD, ASR dispatch and span, alignment and ITN
   on the host), idle share, launches;
   then (d) int8 ContextualParaformer at Paraformer-large width
   (``end_to_end_contextual``; 16 decoder layers, the last one with the
   hotword bias attention) through ``AutoModel(model=ContextualParaformer,
   vad_model=FSMN-VAD, punc_model=CT-Transformer, quantize=True)`` with run
   (c)'s 10 hotwords (no no-bias row): (d1) ``HotwordEngine(seaco=False)
   .transcribe_async(hotword=...)`` of three mixed 2-15 s batches, the
   counters exact (a batch: fbank 1, SANM layer 49, FFN 1, decoder layer
   15, d = 128 attention 3, the blocks and gated QDense by
   ``contextual_launches``) with no host sync in a dispatch, each of a
   batch's 15 fused decoder layers bit-equal to its twin on its own inputs,
   log-probs on the int8 twins within 1e-3 with tokens >= 0.99 and token
   lengths equal, the bias attention over 1, 2, 10 and 51 keys with no key
   mask against its twin (3e-2) and SDPA; (d2) ``generate`` of the 600 s
   recording on (b)'s plan with the hotwords (the waveform path; no
   timestamps) and without (CIF-peak stamps), each counter exact, no host
   sync in a dispatch, the record equal on the int8 twins, wall, stages
   and the idle share of a profile; then (e) the Conformer of
   ``configs/conformer_hybrid.yaml`` through ``AutoModel(model=Conformer,
   vad_model=FSMN-VAD, punc_model=CT-Transformer, quantize=True)``
   (``end_to_end_hybrid``): (e1) ``HybridEngine.transcribe(nbest=3,
   with_timestamp=True)`` of the beam cell's B = 32 x 15 s batch (its
   serving, int8 KV), counters exact (the CTC prefix step one a decode
   step), timed beside the call without timestamps with the host Viterbi's
   seconds and the bytes read back, and on the twins (CTC step, int8
   blocks) tokens equal, scores within 1e-3, alignments and timestamps
   equal; (e2) ``generate`` with CTC-alignment timestamps of the 600 s
   recording on (b)'s plan, counters exact, wall and stages, and its first
   120 s on the kernels and on the twins, the records equal; then (f)
   the four aishell recipes, each built from its YAML
   (``examples/aishell/*/conf/``: 12-block encoders of D = 256, 6-block
   decoders, vocab 4234) through ``AutoModel(quantize=True)``
   (``end_to_end_aishell``): (f1) Transformer, Branchformer and
   E-Branchformer, ``HybridEngine.transcribe(nbest=3,
   with_timestamp=True)`` of the beam cell's B = 32 x 15 s batch (int8 KV),
   (f2) the Conformer with the RWKV decoder (the full-prefix beam) on
   B = 8 x 15 s, each with its counters exact (fbank 1, the CTC step one a
   decode step, the fused int8 FFNs and the gated QDense pairs of each
   recipe's stated layout, ``HYBRID_INT8``: 12 FFNs a batch for the
   Transformer, 24 QDense for the E-Branchformer, none for the
   Branchformer, 24 QDense and per decoder call 6 FFNs and the output layer
   for the Conformer-RWKV), the batch's dispatch under
   ``torch.cuda.set_sync_debug_mode("error")`` but for the beam's one sync a
   step and the read back, the wall and the decode steps, and on the twins
   tokens equal, scores within 1e-3, alignments and timestamps equal; (f2)
   also times one full-prefix decoder call and counts its launches; (f3)
   the E-Branchformer behind FSMN-VAD and CT-Transformer: ``generate`` of
   the 600 s recording on (b)'s plan, as (e2). The kernel phase also holds
   the int8 FFN at 256 -> 2048 -> 256 (the Transformer encoder's 12256 rows,
   the RWKV decoder's 7760) and the int8 GEMM at those FFNs', the
   E-Branchformer's macaron (N = 1024) and the RWKV output layer's
   (N = 4234) shapes, bit-equal to their twins; then (g) the 256-wide SANM
   family and the aishell Paraformer-Conformer (``end_to_end_sanm_family``;
   4 heads: head size 64), each from its YAML: (g1) E-Paraformer (SANM
   encoder, PIF predictor, SAN decoder) on B = 32 x 15 s through
   ``ParaformerEngine``, int8 and float32, (g2) the Paraformer-Conformer
   (linear input layer, CIF, SAN decoder), int8, (g3) the SANM hybrid (the
   Transformer recipe with ``model: SANM``, ``encoder: SANMEncoder``) as
   (f1), (g4) E-Paraformer behind FSMN-VAD and CT-Transformer on the 600 s
   recording; counters exact by the stated layouts (``PARAFORMER256_INT8``,
   ``HYBRID_INT8["sanm"]``), no host sync in a dispatch, the records equal
   on the int8 twins (float32: log-probs within 1e-2, tokens >= 0.99).  The
   kernel phase holds the head-size-64 instances at those models' shapes
   (``check_head64_kernels``): ``attention_forward<64>`` bf16 and float32
   against its twin beside SDPA, the exact-sum entries, ``int8_gemm_rq`` at
   (8000, 256, 256) with the FSMN and the SANM layer at D = 256 bit-equal;
   then (h) Whisper large-v3 at full width (``end_to_end_whisper``; D =
   1280, 32 + 32 blocks, 20 heads of 64, 128 mels, vocab 51866, seeded
   random weights) through ``AutoModel(model={"model": "Whisper", "size":
   "large-v3"}, vad_model=FSMN-VAD, punc_model=CT-Transformer)``, bf16: (h0)
   ``attention_forward<64>`` at its three shapes (the encoder's (8, 1500,
   1280), one query over the 1500 encoder states, one over the 65-key
   cache) in bf16 and float32 against its twin, timed by events and CUDA
   graph beside SDPA, the float32 encoder self-attention within 1.25 x
   SDPA's time; (h1) ``WhisperEngine.transcribe`` of B = 8 windows of
   30-2 s audio, 64 tokens, the d = 64 kernel launched exactly 32 + 64 x 32
   x 2 times and nothing else, no host sync in the frontend's or the
   decode's dispatch, the kernels' tokens against the twins' (fed the
   kernels' prefix, >= 0.9 equal, every difference at a twin top-2 margin
   within 2^-4: a bf16 tie), >= 16 distinct tokens, the batch's
   wall, encoder and decode spans and a profile (launches a step, idle
   share); float32 on two rows (log-probs within 1e-2, predictions equal
   but at ties within 1e-3); (h2)
   ``WhisperLID`` over the 100 language tokens (probabilities within 1e-2
   of the twins', ``transcribe_with_lid`` counters exact, tokens at the
   (h1) rule); (h3) ``generate`` of the 600 s recording's first 150 s on
   pipeline (b)'s plan (one batch), each segment one 30 s window, counters exact, no host sync in a
   dispatch, each batch's tokens at the (h1) rule; punctuation gets no
   text (the repository has no Whisper tokenizer); then (i) the transducer
   family and emotion2vec: (i0) the WKV kernel bit-equal to its twin at
   RWKV-BAT's (8, 1536, 256), the RWKV decoder's (80, 97, 256) and edges,
   timed beside its chain floor (``wkv_chain_floor``), and the float32
   d = 64 attention with ALiBi at emotion2vec base's (8, 759, 768), 12
   heads, 10 extra tokens, ragged keys, within 1e-4 of its twin (at zero
   slopes bit-equal to the kernel without ALiBi) beside SDPA with the same
   float bias, at or under SDPA's time; (i1) the Transducer over the aishell Conformer encoder
   (``TRANSDUCER_YAML``: 12 x 256, conv2d; the JAX prediction network and
   joint at 256; vocab 4234) through ``AutoModel``,
   ``TransducerEngine.transcribe`` of the beam cell's B = 32 x 15 s batch
   in int8 and float32 under a stated weight rule (``weight_rule``:
   random joints emit at every attempt), counters exact (fbank 1, int8: 24
   gated FFN ``w_1``), no host sync in the dispatch, int8 tokens and
   records equal on the int8 twins, float32 decisions fed the kernels'
   decisions equal on >= 0.99 on the fbank twin, >= 16 distinct tokens,
   at most half the rows at 128 tokens; (i2) RWKV-BAT (the JAX
   ``RWKVEncoder`` defaults: 256 wide, 6 blocks) on B = 8 x 15 s, float32,
   WKV 6 launches a batch, tokens equal on the WKV twin; (i3) the int8
   Transducer behind FSMN-VAD and CT-Transformer on pipeline (b)'s plan,
   counters exact, the record equal on the int8 twins; (i4) emotion2vec base
   (768 wide, 4 + 8 blocks, 12 heads of 64, 9 labels) through
   ``AutoModel(model={"model": "Emotion2vec"})`` on B = 8 utterances of
   15-2 s, float32: the ALiBi kernel launched 12 times a batch, no host
   sync in the dispatch, scores within 1e-4 of the twins', labels equal
   where the twins' top-2 margin exceeds it, feats within 1e-4 x max
   |twin|.  Phase (f2)'s counters include the RWKV decoder's 6 WKV
   launches a decoder call; then (j) SCAMA and the streaming
   punctuation: the SCAMA path's int8 kernels at its B = 32 x 15 s shapes
   (QDense's rowquant and int8 GEMM at encoders0's and a layer's QKV and
   the decoder's cross K/V, bit-equal; the fused int8 FFN); (j1) SCAMA at
   Paraformer-large's widths (``scama_configs``: 50 SANM layers under the
   chunk mask, the 16-layer causal ``FsmnDecoderSCAMAOpt``, beam 5,
   maxlen 96) through ``AutoModel.generate``, int8 on three batches of
   mixed 2-15 s requests, counters exact (fbank one a batch, the 50 fused
   int8 FFNs and the gated QDense pairs of ``scama_batch_launches``), no
   host sync in a dispatch but the beam's one a step, the records equal on
   the int8 twins; float32 tokens on the twins equal on >= 0.99; the
   B = 32 x 15 s batch timed and profiled (ms and launches a decode step,
   the idle share); (j2) the int8 SCAMA behind FSMN-VAD and CT-Transformer
   on pipeline (b)'s plan with ``with_timestamp=False``, counters exact,
   the record equal on the int8 twins, and with timestamps the error that
   names the cause; (j3) the streaming CT-Transformer at
   ``configs/ct_transformer_punc.yaml``'s widths in bf16, 60 calls of 5-25
   words and the flush, each masked forward under the guard, no kernel
   launched, labels equal to float32's on >= 0.99, the ms a call; then (k)
   Paraformer training (``end_to_end_training``, ``end_to_end_train_smoke``):
   (k0) three ``accum_grad`` = 2 float32 steps of the width-512, depth
   4 + 2 Paraformer on the card and on the CPU from the same weights, losses
   and ``grad_norm`` within 1e-4, the parameter updates within 1 % in
   2-norm; (k1) bench_train.py's Paraformer-large (remat, dropout 0.1, the
   sampler at 0.75) in bf16 on float32 parameters, AdamW, clip 5, 2 x 32
   raw 15 s waveforms a step featurized by the fbank kernel: one warm-up and
   five timed steps dispatched under the sync guard, the step's ms,
   audio-s/s, peak memory, launches and idle share, every loss and grad
   norm finite; (k2) the eval step on the attention kernel (66 launches),
   its loss within the bf16 attention bar of the twin's; (k3) the
   examples/smoke recipe (the port's data generator, CMVN on the fbank
   kernel, ``python -m funasr_torch.bin.train`` on the tiny config at 128
   wide, two epochs), the loss falling, ``model.avg.pt`` served int8
   through ``AutoModel`` with tokens equal to the int8 twins'.  Every
   phase's first call dispatches under the sync guard as its timed calls
   do;
4. print one ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes ``torch.profiler`` tables of one B=64 x 15 s
batch, bf16 and int8, of one B=32 x 15 s beam batch and of one B=64 x 15 s
BiCif batch with the routes on and off to ``DIR/profile_e2e.txt``,
``DIR/profile_e2e_int8.txt``, ``DIR/profile_beam.txt``,
``DIR/profile_bicif_on.txt``, ``DIR/profile_bicif_off.txt``, for one
``generate`` (b) of the pipeline, ``DIR/profile_pipeline.txt`` (its stage
times and segments in ``DIR/pipeline.json``), for one streaming window
step, ``DIR/profile_streaming.txt`` and, for one SenseVoice README call,
``DIR/profile_sensevoice.txt`` and, for one contextual ``generate`` with
hotwords, ``DIR/profile_contextual.txt``, for one Whisper batch,
``DIR/profile_whisper.txt``, for one int8 Transducer batch,
``DIR/profile_transducer.txt``, for one emotion2vec batch,
``DIR/profile_emotion2vec.txt`` and, for one Paraformer-large training
step, ``DIR/profile_train.txt`` (those seven are profiled in every run).  Device
time by kernel group, and the share of each batch's span spent in kernels,
is printed for every batch profiled;
the beam batch is always profiled (its device time beside its host time).
Without CUDA, or without the rest of the repository beside it, the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
            "float64": 67e12,  # float64: the tensor cores' rate
            "tf32": 495e12}

FBANK_TOL = 1e-3  # log-mel and dB, abs (the JAX package's "highest" bar)
# the fbank kernel against the float64 exact value (chip_smoke.fbank_fft_route
# in float64), log-mel abs: its arithmetic is float64 up to the log
FBANK_EXACT_TOL = 1e-4
FBANK_MS_BAR = 0.40  # the fbank kernel at B=64 x 15 s, CUDA graph, ms
ATTN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # abs, output in that dtype
# the float32 attention (split TF32 on the tensor cores) at the served
# encoder self-attention shapes: ms <= this x SDPA's in the same run; at
# emotion2vec's ALiBi shape ms <= SDPA's with its (B, H, T, T) float bias
F32_SDPA_BAR = 1.25
E2E_F32_LOGP_TOL = 1e-2  # kernels vs twins through 66 float32 layers
E2E_F32_MIN_AGREE = 0.99  # greedy-token agreement, kernels vs twins
# int8 layers against their twins, bf16 output, abs.  Kernel and twin do the
# same float32 operations and sum in float64 where order could matter, so
# they are expected bit-equal; the bar allows one bf16 ulp at |x| < 16 for a
# float64 sum that lands on a float32 rounding tie.
INT8_LAYER_TOL = 0.0625
# int8 model, this slice's kernels against their twins (fbank and attention
# kernels in both runs): expected bit-equal, so a near-zero bar.  An int8
# rounding tie that lands apart spreads through the later layers, so any
# difference at all shows up as a large one.
E2E_INT8_LOGP_TOL = 1e-3
E2E_INT8_MIN_AGREE = 0.99
# CTC prefix kernel against its twin: the same IEEE operations in the same
# order with the same expf/logf, so bit-equal is expected
CTC_REL_TOL = 1e-6  # |kernel - twin| <= CTC_REL_TOL * max(1, |twin|)
CTC_STEP_MS_BAR = 0.10  # the CTC prefix step at the beam's shape, CUDA graph, ms
BEAM_F32_SCORE_TOL = 1e-3  # float32 beam, CTC kernel vs twin: |dscore|
# bf16/float32 FFN against its twin, times max|twin|: the kernel sums in
# another order (tensor-core tiles, or k-ordered FMA), which can move a bf16
# rounding of the hidden value and then of an output: two bf16 ulps at the
# output's magnitude; float32 sums of 2048 terms: 2e-5
FFN_TOL = {"bfloat16": 2.0 ** -6, "float32": 2e-5}

FLAGSHIP = dict(  # __graft_entry__.py:13 _flagship (Paraformer-large)
    vocab_size=8404, input_size=560,
    encoder_conf=dict(output_size=512, attention_heads=4, linear_units=2048,
                      num_blocks=50, dropout_rate=0.1,
                      attention_dropout_rate=0.1, kernel_size=11,
                      sanm_shfit=0),
    decoder_conf=dict(attention_heads=4, linear_units=2048, num_blocks=16,
                      att_layer_num=16, kernel_size=11, sanm_shfit=0,
                      dropout_rate=0.1, self_attention_dropout_rate=0.1,
                      src_attention_dropout_rate=0.1),
    predictor_conf=dict(idim=512, threshold=1.0, l_order=1, r_order=1,
                        tail_threshold=0.45),
    lsm_weight=0.1, length_normalized_loss=True, predictor_weight=1.0,
    predictor_bias=1, sampling_ratio=0.75,
)
CONFORMER_HYBRID = dict(  # configs/conformer_hybrid.yaml, built as bench_beam.py:51-62
    vocab_size=4233, input_size=80, ctc_weight=0.3, lsm_weight=0.1,
    encoder_conf=dict(output_size=256, attention_heads=4, linear_units=2048,
                      num_blocks=12, cnn_module_kernel=15),
    decoder_conf=dict(attention_heads=4, linear_units=2048, num_blocks=6),
)
BEAM_SERVING = dict(beam=10, maxlen=96, decoding_ctc_weight=0.3, int8_kv=True)
FS = 16000


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of ``fn`` in ms without the host's share: ``iters`` calls
    captured in one CUDA graph (after two warm-up calls outside it), the
    graph replayed ``replays`` times between CUDA events."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(nbytes: float, ops: dict):
    """Least time for the work: the larger of the bytes over the memory rate
    and the operations over the peak rate of their type, the operation
    times of several types added (``ops``: {dtype: count})."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS[dt] for dt, n in ops.items()) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def split_tf32_bound_ms(ops: float) -> float:
    """The float32 attention's tensor-core bound, labelled as such beside
    ``bound_ms``: its products as three tf32 products of split operands (3 x
    ``ops``) at the tf32 peak."""
    return 3.0 * ops / PEAK_OPS["tf32"] * 1e3


def fbank_ops_per_frame(n_mels: int, with_energy: bool) -> float:
    """Least float32 operations of kaldi log-mel fbank for one 400-sample
    frame, whatever the algorithm: DC removal, preemphasis and window (5
    per sample), a 512-point real FFT (2.5 N log2 N), the power spectrum (3
    per bin), the mel bank's nonzeros (2 each; each bin feeds at most two
    triangles), one log per mel bin, and with the energy column one FMA per
    sample and a log.  The kernel's dense (400, 512) operator product is
    far more work (2 x 400 x 512 per frame) than the function needs."""
    import numpy as np

    from funasr_torch.ops.fbank import kaldi_mel_banks

    mel_nnz = int(np.count_nonzero(kaldi_mel_banks(n_mels, 512, float(FS))[:256]))
    ops = 5 * 400 + 2.5 * 512 * np.log2(512) + 3 * 256 + 2 * mel_nnz + n_mels
    return float(ops + (2 * 400 + 1 if with_energy else 0))


def fbank_fft_route(torch, wav, dtype, n_mels: int = 80, window: str = "hamming"):
    """kaldi log-mel by ``torch.fft.rfft``, every step in ``dtype``: the same
    preprocessing (scale, DC removal, preemphasis with the first sample
    duplicated, window), the 512-point real FFT, the power, a dense mel
    product and the log.  In float64 it is the exact value the kernel and
    its twin are held to; in float32 it is the cuFFT yardstick (several
    library calls, never on a path)."""
    from funasr_torch.ops.fbank import LOG_EPS, _window, kaldi_mel_banks

    dev = wav.device
    T = (wav.shape[1] - 400) // 160 + 1
    fr = (wav.to(dtype) * 32768.0).unfold(1, 400, 160)[:, :T]
    fr = fr - fr.mean(dim=-1, keepdim=True)
    fr = fr - 0.97 * torch.cat([fr[..., :1], fr[..., :-1]], dim=-1)
    fr = fr * torch.as_tensor(_window(window, 400), dtype=dtype, device=dev)
    spec = torch.fft.rfft(fr, n=512)[..., :256]
    power = spec.real * spec.real + spec.imag * spec.imag
    mel = torch.as_tensor(kaldi_mel_banks(n_mels, 512, float(FS))[:256],
                          dtype=dtype, device=dev)
    return torch.log(torch.clamp_min(power @ mel, LOG_EPS))


def waveform(rng, n: int, f0: float):
    import numpy as np

    t = np.arange(n) / FS
    return (0.1 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * np.sin(2 * np.pi * 2.7 * f0 * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


# ------------------------------------------------------------------ phase 2
def check_fbank(torch, FK, rng):
    import numpy as np

    B, N = 64, 15 * FS
    lens = np.where(np.arange(B) % 2 == 0, N,
                    rng.integers(2 * FS, N, B)).astype(np.int32)
    wav = np.zeros((B, N), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = waveform(rng, int(n), 150.0 + 5 * i)
    wav_d = torch.from_numpy(wav).cuda()
    lens_d = torch.from_numpy(lens).cuda()
    T = (N - 400) // 160 + 1
    exact = fbank_fft_route(torch, wav_d, torch.float64)
    cufft = fbank_fft_route(torch, wav_d, torch.float32)
    twin_exact = float((FK.fbank_ref(wav_d, lens_d)[0].double() - exact).abs().max())
    cufft_exact = float((cufft.double() - exact).abs().max())
    del cufft
    route = cuda_ms(lambda: fbank_fft_route(torch, wav_d, torch.float32), iters=5)
    cases = []
    for with_energy in (False, True):
        got = FK.fused_fbank(wav_d, lens_d, with_energy=with_energy)
        want = FK.fbank_ref(wav_d, lens_d, with_energy=with_energy)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]), "fbank frame lengths")
        err = max(float((g - w).abs().max()) for g, w in
                  zip((got[0],) + got[2:], (want[0],) + want[2:]))
        check(bool(all(torch.isfinite(g).all() for g in (got[0],) + got[2:])),
              "fbank output finite")
        check(err <= FBANK_TOL, f"fbank(with_energy={with_energy}) max err "
              f"{err} > {FBANK_TOL}")
        err_exact = float((got[0].double() - exact).abs().max())
        check(err_exact <= FBANK_EXACT_TOL, f"fbank(with_energy={with_energy}) "
              f"against the float64 exact value {err_exact} > {FBANK_EXACT_TOL}")
        ms = cuda_ms(lambda: FK.fused_fbank(wav_d, lens_d, with_energy=with_energy))
        graph = graph_ms(lambda: FK.fused_fbank(wav_d, lens_d, with_energy=with_energy))
        plain = cuda_ms(lambda: FK.fbank_ref(wav_d, lens_d, with_energy=with_energy),
                        iters=5)
        n_out = 80 + (1 if with_energy else 0)
        nbytes = B * N * 4 + B * T * n_out * 4 + 2 * B * 4  # + lengths in, out
        ops = B * T * fbank_ops_per_frame(80, with_energy)
        bnd, by = bound_ms(nbytes, {"float32": ops})
        case = dict(case=f"B=64 x 15 s ragged, with_energy={with_energy}",
                    max_abs_err=err, tolerance=FBANK_TOL, ms=ms, graph_ms=graph,
                    plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by,
                    err_vs_exact=err_exact, exact_tolerance=FBANK_EXACT_TOL,
                    twin_err_vs_exact=twin_exact, cufft_route_ms=route,
                    cufft_route_err_vs_exact=cufft_exact)
        log(f"fbank {case}")
        check(graph <= FBANK_MS_BAR, f"fbank(with_energy={with_energy}) "
              f"{graph} ms > {FBANK_MS_BAR} ms")
        cases.append(case)
    return cases


def check_attention(torch, A, B=64, D=512, seed=0):
    """The fused attention against its twin at the served shapes of width D
    with 4 heads (d = 128 at Paraformer-large's B=64 batch; d = 64 at the
    256-wide models' B=32 one), timed beside the twin and SDPA; the float32
    encoder self-attention within ``F32_SDPA_BAR`` x SDPA's time."""
    import torch.nn.functional as F

    cases = []
    H = 4
    d = D // H
    T = 256  # 15 s -> 250 LFR frames -> padded to 256
    # the B=64 batch of bench.py: 15 s rows (250 frames), every other row
    # 12 s (200 frames); ragged lengths are held in check_edges
    lens = torch.full((B,), 250, device="cuda")
    lens[1::2] = 200
    bias = (1.0 - (torch.arange(T, device="cuda")[None] < lens[:, None]).float()) * -1e30
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, U, kv_cols in (("encoder self-attention", T, 3 * D),
                             ("decoder cross-attention", 128, 2 * D)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = "bfloat16" if dtype == torch.bfloat16 else "float32"
            # k, v are column slices of the fused projection, as in the model
            proj = torch.randn((B, T, kv_cols), generator=gen, device="cuda").to(dtype)
            k, v = proj[..., -2 * D:-D], proj[..., -D:]
            q = (torch.randn((B, U, D), generator=gen, device="cuda").to(dtype)
                 * d ** -0.5)
            got = A.fused_attention(q, k, v, bias, H)
            want = A.attention_ref(q, k, v, bias, H)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got).all()), f"attention {name} finite")
            check(err <= ATTN_TOL[dn], f"attention {name} {dn} max err {err} "
                  f"> {ATTN_TOL[dn]}")
            # tens of microseconds a call: 50 calls after 10 warm-ups, so that
            # the card's clock has left an idle gap's low state
            ms = cuda_ms(lambda: A.fused_attention(q, k, v, bias, H), iters=50, warmup=10)
            plain = cuda_ms(lambda: A.attention_ref(q, k, v, bias, H), iters=5)
            q4 = q.view(B, U, H, d).transpose(1, 2)
            k4 = k.unflatten(-1, (H, d)).transpose(1, 2)
            v4 = v.unflatten(-1, (H, d)).transpose(1, 2)
            mask = bias[:, None, None, :].to(dtype)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=1.0), iters=50, warmup=10)
            # q, out and the bias in full; k, v and both products only for
            # the valid keys: a padded key contributes exactly nothing
            n_keys = float(lens.clamp(max=T).sum())
            el = q.element_size()
            nbytes = el * (2 * B * U * D + 2 * n_keys * D) + 4 * B * T
            ops = 4.0 * U * D * n_keys
            bnd, by = bound_ms(nbytes, {dn: ops})
            case = dict(case=f"{name} q({B},{U},{D}) kv({B},{T},{D}) {dn}, "
                             "keys 250/200",
                        max_abs_err=err, tolerance=ATTN_TOL[dn], ms=ms,
                        plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
            if dn == "float32":
                case["split_tf32_bound_ms"] = split_tf32_bound_ms(ops)
            log(f"attention {case}")
            if dn == "float32" and name == "encoder self-attention":
                check(ms <= F32_SDPA_BAR * lib, f"attention {name} float32 d={d}: {ms:.4f} ms "
                      f"> {F32_SDPA_BAR} x SDPA {lib:.4f} ms")
            cases.append(case)
    return cases


def check_edges(torch, FK, A, rng):
    """Shapes the main path does not reach at 15 s: ragged tiles (T, U not
    multiples of the kernels' 16/32/64 tiles), one frame, a row with one
    valid key and a row with none, eight heads, strided k/v.  Returns the
    largest error seen."""
    import numpy as np

    worst = 0.0
    for B, N in ((3, 16000 + 123), (1, 400), (2, 560)):
        lens = np.minimum(N, rng.integers(300, N + 1, B)).astype(np.int32)
        wav = torch.from_numpy(rng.standard_normal((B, N)).astype(np.float32)
                               * 0.1).cuda()
        lens_d = torch.from_numpy(lens).cuda()
        for with_energy in (False, True):
            got = FK.fused_fbank(wav, lens_d, with_energy=with_energy)
            want = FK.fbank_ref(wav, lens_d, with_energy=with_energy)
            check(torch.equal(got[1], want[1]), "fbank edge frame lengths")
            err = max(float((g - w).abs().max()) for g, w in
                      zip((got[0],) + got[2:], (want[0],) + want[2:]))
            check(err <= FBANK_TOL, f"fbank edge B={B} N={N} err {err}")
            worst = max(worst, err)
    for window in ("hanning", "povey", "rectangular"):  # another operator
        got = FK.fused_fbank(wav, lens_d, window=window)
        want = FK.fbank_ref(wav, lens_d, window=window)
        err = float((got[0] - want[0]).abs().max())
        check(err <= FBANK_TOL, f"fbank edge window={window} err {err}")
        worst = max(worst, err)
    # 40 mels (another range table), against the twin and the exact value;
    # and N = 399, no frame at all.  A generator of their own leaves the
    # main one's stream, which later phases draw from, as it was.
    erng = np.random.default_rng(9)
    wav = torch.from_numpy(np.stack([waveform(erng, 16123, f0) for f0 in (120.0, 230.0)])
                           ).cuda()
    lens_d = torch.tensor([16123, 9000], device="cuda")
    got = FK.fused_fbank(wav, lens_d, num_mel_bins=40)
    want = FK.fbank_ref(wav, lens_d, num_mel_bins=40)
    err = float((got[0] - want[0]).abs().max())
    err_exact = float((got[0].double() - fbank_fft_route(torch, wav, torch.float64, 40))
                      .abs().max())
    check(torch.equal(got[1], want[1]) and err <= FBANK_TOL
          and err_exact <= FBANK_EXACT_TOL,
          f"fbank edge n_mels=40 err {err}, against the exact value {err_exact}")
    worst = max(worst, err)
    wav = torch.from_numpy(erng.standard_normal((2, 399)).astype(np.float32)).cuda()
    lens_d = torch.tensor([399, 250], device="cuda")
    before = FK.fused_fbank.launches
    got = FK.fused_fbank(wav, lens_d, with_energy=True)
    want = FK.fbank_ref(wav, lens_d, with_energy=True)
    check(FK.fused_fbank.launches == before and got[0].shape == want[0].shape == (2, 0, 80)
          and got[2].shape == (2, 0) and torch.equal(got[1], want[1]),
          "fbank edge N=399: no frame, no launch")
    for B, U, T, H, d in ((3, 37, 250, 4, 128), (2, 1, 1, 4, 128),
                          (3, 100, 300, 8, 128), (2, 64, 63, 2, 128),
                          (3, 77, 203, 4, 128)):
        gen = torch.Generator(device="cuda").manual_seed(U * T)
        D = H * d
        lens = torch.from_numpy(rng.integers(1, T + 1, B)).cuda()
        if B > 2:
            lens[1] = 1  # one valid key
        lens[-1] = 0  # no valid key: uniform weights in kernel and twin
        bias = (1.0 - (torch.arange(T, device="cuda")[None] < lens[:, None])
                .float()) * -1e30
        for dtype in (torch.bfloat16, torch.float32):
            kv = torch.randn((B, T, 2 * D), generator=gen,
                             device="cuda").to(dtype)
            k, v = kv.split(D, dim=-1)
            q = (torch.randn((B, U, D), generator=gen, device="cuda").to(dtype)
                 * d ** -0.5)
            got = A.fused_attention(q, k, v, bias, H)
            want = A.attention_ref(q, k, v, bias, H)
            dn = "bfloat16" if dtype == torch.bfloat16 else "float32"
            err = float((got.float() - want.float()).abs().max())
            check(err <= ATTN_TOL[dn],
                  f"attention edge B={B} U={U} T={T} H={H} d={d} {dn} err {err}")
            worst = max(worst, err)
    torch.cuda.synchronize()
    log(f"edge shapes: fbank (3 shapes, 4 windows, 40 mels, N=399) and attention "
        f"(5 shapes x 2 dtypes) within tolerance, worst abs err {worst:.3e}")
    return worst


def check_f32_edges(torch, A):
    """Every float32 instance of ``fused_attention`` (d = 128, 64 and 32, and
    d = 64 with ALiBi and 3 extra tokens) against the twin (``ATTN_TOL``) at
    the edges of its tiles: one query, queries not a multiple of 16 (or 3
    blocks, the last ragged), keys not a multiple of 8, of the 64-key tile
    or of the 32-key tile of d = 128, a single key, one key past two whole
    tiles; in every shape a row with all keys, one with one valid key (B > 2)
    and one with none (uniform weights), k and v strided column slices of one
    (B, T, 3 H d) projection.  A float32 k whose rows are not 16-byte aligned
    raises ``ValueError`` naming ``fused_attention`` and launches nothing.
    Returns the case with the largest error."""
    from funasr_torch.models.emotion2vec.model import alibi_slopes

    H, extra = 4, 3
    gen = torch.Generator(device="cuda").manual_seed(23)
    worst, n = 0.0, 0
    for d, alibi in ((128, False), (64, False), (32, False), (64, True)):
        D = H * d
        for B, U, T in ((3, 1, 57), (3, 37, 203), (2, 19, 1), (4, 130, 95), (3, 66, 129)):
            lens = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
            lens[0] = T
            if B > 2:
                lens[1] = 1  # one valid key
            lens[-1] = 0  # no valid key: uniform weights in kernel and twin
            bias = torch.where(torch.arange(T, device="cuda")[None] < lens[:, None], 0.0, -1e30)
            qkv = torch.randn((B, T, 3 * D), generator=gen, device="cuda")
            k, v = qkv[..., D:2 * D], qkv[..., 2 * D:]
            q = torch.randn((B, U, D), generator=gen, device="cuda") * d ** -0.5
            kw = {}
            if alibi:
                kw = dict(alibi_slopes=torch.as_tensor(alibi_slopes(H), dtype=torch.float32,
                                                       device="cuda"), extra=extra)
            got = A.fused_attention(q, k, v, bias, H, **kw)
            want = A.attention_ref(q, k, v, bias, H, **kw)
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL["float32"],
                  f"attention float32 edge d={d}{' ALiBi' if alibi else ''} B={B} U={U} T={T}: "
                  f"err {err} > {ATTN_TOL['float32']}")
            worst, n = max(worst, err), n + 1
    q = torch.randn((2, 20, 256), generator=gen, device="cuda")
    buf = torch.randn((2, 20, 2 * 256 + 1), generator=gen, device="cuda")
    bias = torch.zeros((2, 20), device="cuda")
    before = A.fused_attention.launches
    try:
        A.fused_attention(q, buf[..., 1:257], buf[..., 257:], bias, H)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    check(refused.startswith("fused_attention") and A.fused_attention.launches == before,
          f"attention float32 k at a 4-byte offset: not refused ({refused!r})")
    torch.cuda.synchronize()
    case = dict(case=f"float32 edges: d = 128, 64, 32 and ALiBi 64 at {n // 4} shapes each "
                     "(U = 1, 37, 19, 130, 66; T = 57, 203, 1, 95, 129), strided k/v, a row "
                     "with one key and one with none; a 4-byte offset k refused",
                max_abs_err=worst, tolerance=ATTN_TOL["float32"])
    log(f"attention {case}")
    return case


# (M, K, N) of every int8 GEMM of the int8 path at B=64 x 15 s: 64 x 256
# encoder frames, 64 x 128 decoder tokens
GEMM_SHAPES = (
    (16384, 560, 1536, "encoders0 QKV (QDense, K=560)"),
    (16384, 512, 1536, "SANM layer QKV"),
    (16384, 512, 512, "SANM layer out"),
    (16384, 512, 2048, "FFN w1"),
    (16384, 2048, 512, "FFN w2"),
    (8192, 512, 2048, "decoder FFN w1, decoders3 w_1"),
    (8192, 2048, 512, "decoder FFN w2"),
    (8192, 512, 512, "decoder q, out"),
    (16384, 512, 1024, "decoder memory K/V"),
    (8192, 512, 8404, "output layer (QDense, N=8404)"),
    (12256, 256, 2048, "Conformer FFN w_1 (QDense, beam path, B=32 x 383 frames); the "
                       "Transformer encoder's fused FFN w_1"),
    (12256, 2048, 256, "Transformer encoder's fused FFN w_2 (B=32 x 383 frames)"),
    (12256, 256, 1024, "E-Branchformer macaron FFN w_1 (QDense, N=1024)"),
    (7760, 256, 2048, "RWKV decoder's fused FFN w_1 (B=8 x beam 10 x 97 tokens)"),
    (7760, 2048, 256, "RWKV decoder's fused FFN w_2"),
    (7760, 256, 4234, "RWKV decoder output layer (QDense, N=4234)"),
    (37, 560, 100, "edge: ragged M, K and N"),
    (1000, 512, 1536, "edge: M not a multiple of the 128-row tile"),
    (8192, 16, 512, "edge: K below one 128-byte stage"),
    (300, 512, 512, "edge: fewer tiles than SMs"),
)
# the served rows' bar: ms <= LIB_BAR x torch._int_mm where it runs, else
# <= BOUND_BAR x the bound (looser than the predictions, so noise never
# trips it); the edge rows are held for bits only
LIB_BAR = 2.0
BOUND_BAR = 4.0


def speed_bar(case):
    """Fail unless a timed case is within its bar (``LIB_BAR``/``BOUND_BAR``)."""
    lib, ms = case["library_ms"], case["ms"]
    if lib is not None:
        check(ms <= LIB_BAR * lib, f"{case['case']}: {ms:.4f} ms > {LIB_BAR} x "
              f"torch._int_mm {lib:.4f} ms")
    else:
        check(ms <= BOUND_BAR * case["bound_ms"], f"{case['case']}: {ms:.4f} ms > "
              f"{BOUND_BAR} x its bound {case['bound_ms']:.4f} ms")


def check_int8_gemm(torch, G):
    """The int8 GEMM against its twin at every shape of the int8 path: the
    int32 accumulator (unit scales) and the full epilogue (scales, bias,
    relu, a bf16 residual, a float32 addend, bf16 out) must be bit-equal;
    the QDense epilogue too (round before the bias)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for M, K, N, where in GEMM_SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        sa = torch.rand(M, generator=gen, device="cuda") * 0.01
        sb = torch.rand(N, generator=gen, device="cuda") * 0.01
        bias = torch.randn(N, generator=gen, device="cuda")
        res = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
        add = torch.randn((M, N), generator=gen, device="cuda")
        one = lambda n: torch.ones(n, device="cuda")
        acc_equal = torch.equal(G.int8_gemm(a, one(M), b, one(N)),
                                G.int8_gemm_ref(a, one(M), b, one(N)))
        full = dict(bias=bias, relu=True, res=res, add=add, out_dtype=torch.bfloat16)
        epi_equal = torch.equal(G.int8_gemm(a, sa, b, sb, **full),
                                G.int8_gemm_ref(a, sa, b, sb, **full))
        qd = dict(bias=bias, round_bf16=True, out_dtype=torch.bfloat16)
        qdense_equal = torch.equal(G.int8_gemm(a, sa, b, sb, **qd),
                                   G.int8_gemm_ref(a, sa, b, sb, **qd))
        torch.cuda.synchronize()
        check(acc_equal and epi_equal and qdense_equal,
              f"int8 GEMM {where} ({M}, {K}, {N}) bit-equal to its twin: acc "
              f"{acc_equal}, epilogue {epi_equal}, QDense {qdense_equal}")
        ms = cuda_ms(lambda: G.int8_gemm(a, sa, b, sb, bias=bias))
        plain = cuda_ms(lambda: G.int8_gemm_ref(a, sa, b, sb, bias=bias), iters=3)
        lib = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:  # torch._int_mm's shape rules
            lib = cuda_ms(lambda: torch._int_mm(a, b.t()))
        nbytes = M * K + N * K + 4 * (M + 2 * N) + 4 * M * N
        bnd, by = bound_ms(nbytes, {"int8": 2.0 * M * N * K})
        plan = G.gemm_plan(M, N, K, G.sm_count(0))
        case = dict(case=f"{where}: ({M}, {K}) x ({N}, {K}) int8 -> f32",
                    max_abs_err=0.0, tolerance=0.0, ms=ms, plain_ms=plain,
                    library_ms=lib, ms_over_library=None if lib is None else ms / lib,
                    bound_ms=bnd, bound_by=by, ms_over_bound=ms / bnd,
                    tops=2.0 * M * N * K / ms / 1e9,
                    plan=f"BM={plan.bm} BN={plan.bn} stages={plan.stages} "
                         f"grid={plan.grid} tiles={plan.tiles}")
        log(f"int8 gemm {case}")
        if not where.startswith("edge"):
            speed_bar(case)
        cases.append(case)
    return cases


def int8_layer_weights(torch, SL, DL, FF, D=512, H=2048, K=11, seed=3):
    """Seeded random float32 parameters of one SANM layer, one decoder layer
    and one FFN, quantized as the model quantizes them.  Weights are
    LeCun-normal over their last (input) axis; vectors are scaled by sc."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, sc=None):
        return (torch.randn(shape, generator=gen, device="cuda")
                * (shape[-1] ** -0.5 if sc is None else sc))
    ln = lambda w: (1 + r(w, sc=0.1), r(w, sc=0.1))
    sanm = SL.quantize_sanm_layer(ln(D), r(3 * D, D), r(3 * D, sc=0.1),
                                  r(D, 1, K, sc=0.3), r(D, D), r(D, sc=0.1), ln(D),
                                  r(H, D), r(H, sc=0.1), r(D, H), r(D, sc=0.1))
    dec = DL.quantize_decoder_layer(ln(D), r(H, D), r(H, sc=0.1), ln(H), r(D, H),
                                    ln(D), r(D, 1, K, sc=0.3), ln(D), r(D, D),
                                    r(D, sc=0.1), r(2 * D, D), r(2 * D, sc=0.1),
                                    r(D, D), r(D, sc=0.1))
    ffn = FF.quantize_ffn(r(H, D), r(H, sc=0.1), r(D, H), r(D, sc=0.1))
    return sanm, dec, ffn


def _layer_case(torch, name, got, want, valid, ms, plain, nbytes, ops, run=None):
    """One layer row; ``run`` (the timed rows' kernel call) also gets its
    device time alone (``graph_ms``: a layer is a chain of launches, whose
    event time reads the host's speed)."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs() * valid
    err = float(diff.max())
    n_diff = int(((got != want) & valid.bool()).sum())
    check(bool(torch.isfinite(got).all()), f"{name} finite")
    check(err <= INT8_LAYER_TOL, f"{name} max err {err} > {INT8_LAYER_TOL}")
    bnd, by = bound_ms(nbytes, ops)
    return dict(case=name, max_abs_err=err, elements_differing=n_diff,
                tolerance=INT8_LAYER_TOL, ms=ms,
                device_ms=None if run is None else graph_ms(run, iters=10, replays=3),
                plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by)


def check_int8_layers(torch, SL, DL, FF, D=512, B=64, seed=3, aishell_ffn=True):
    """The three int8 layer kernels against their twins at width D (4 heads,
    FFN 2048): the main path's shapes (bench.py's B=64 batch at D = 512; the
    256-wide models' B=32 one at D = 256, head size 64) and edge shapes.  On the main shapes the
    decoder layer takes its memory row-quantized, as the decoder stack
    passes it (once per batch); on the edges it quantizes the memory itself.
    Bounds count the valid rows only (frames within the lengths, tokens
    within the token lengths, and for attention each valid query row against
    its valid keys): padded rows are not part of the layers' contract."""
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops.masks import key_bias

    H, K, NH, LEFT = 2048, 11, 4, 5
    sanm_w, dec_w, ffn_w = int8_layer_weights(torch, SL, DL, FF, D=D, seed=seed)
    wbytes_sanm = 4 * D * D + 2 * D * H + 4 * (3 * D + D + H + D) * 2 + 4 * K * D
    wbytes_dec = 4 * D * D + 2 * D * H + 4 * (2 * D + 2 * D + H) * 2 + 4 * K * D
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = {"sanm_layer": [], "sanm_layer_i8": [], "decoder_layer": [], "ffn": []}

    def run(B, T, U, lens, tlens, timed):
        lens_d = torch.tensor(lens, device="cuda", dtype=torch.int32)
        tl_d = torch.tensor(tlens, device="cuda", dtype=torch.int32)
        x = torch.randn((B, T, D), generator=gen, device="cuda").to(torch.bfloat16)
        tgt = torch.randn((B, U, D), generator=gen, device="cuda").to(torch.bfloat16)
        mem = torch.randn((B, T, D), generator=gen, device="cuda").to(torch.bfloat16)
        kb = key_bias(lens_d, T)
        frames = lens_d.clamp(max=T).double()
        toks = tl_d.clamp(max=U).double()
        n_rows, n_tok = float(frames.sum()), float(toks.sum())
        t_rng = torch.arange(T, device="cuda")[None, :, None]
        u_rng = torch.arange(U, device="cuda")[None, :, None]
        tag = f"B={B} T={T} U={U} lengths {sorted(set(lens))[:4]}"

        sanm = lambda f: f(x, lens_d, sanm_w, NH, LEFT, kb)
        got, want = sanm(SL.fused_sanm_layer), sanm(SL.sanm_layer_ref)
        ms = cuda_ms(lambda: sanm(SL.fused_sanm_layer)) if timed else None
        plain = cuda_ms(lambda: sanm(SL.sanm_layer_ref), iters=3) if timed else None
        ops = {"int8": 2.0 * n_rows * (3 * D * D + D * D + 2 * D * H),
               "bfloat16": 4.0 * D * float((frames * frames).sum()),
               "float32": 2.0 * K * D * n_rows}  # the FSMN taps
        cases["sanm_layer"].append(_layer_case(
            torch, f"SANM layer {tag}", got, want, t_rng < lens_d[:, None, None],
            ms, plain, 2 * 2 * n_rows * D + 4 * B * T + wbytes_sanm, ops,
            (lambda: sanm(SL.fused_sanm_layer)) if timed else None))

        sanm8 = lambda f: f(x, lens_d, sanm_w, NH, LEFT, kb, int8_attn=True)
        got, want = sanm8(SL.fused_sanm_layer), sanm8(SL.sanm_layer_ref)
        ms = cuda_ms(lambda: sanm8(SL.fused_sanm_layer)) if timed else None
        plain = cuda_ms(lambda: sanm8(SL.sanm_layer_ref), iters=3) if timed else None
        pairs = float((frames * frames).sum())
        ops = {"int8": 2.0 * n_rows * (3 * D * D + D * D + 2 * D * H) + 2.0 * D * pairs,
               "bfloat16": 2.0 * D * pairs, "float32": 2.0 * K * D * n_rows}
        cases["sanm_layer_i8"].append(_layer_case(
            torch, f"SANM layer int8_attn {tag}", got, want, t_rng < lens_d[:, None, None],
            ms, plain, 2 * 2 * n_rows * D + 4 * B * T + wbytes_sanm, ops,
            (lambda: sanm8(SL.fused_sanm_layer)) if timed else None))

        # the main shapes take the memory quantized as the decoder stack does
        mq_k = DL.quantize_memory(mem) if timed else None
        mq_r = RQ.rowquant_ref(mem.reshape(B * T, D)) if timed else None
        dec = lambda f, mq: f(tgt, mem, tl_d, lens_d, dec_w, NH, LEFT, kb, mq)
        got = dec(DL.fused_decoder_layer, mq_k)
        want = dec(DL.decoder_layer_ref, mq_r)
        ms = cuda_ms(lambda: dec(DL.fused_decoder_layer, mq_k)) if timed else None
        plain = (cuda_ms(lambda: dec(DL.decoder_layer_ref, mq_r), iters=3)
                 if timed else None)
        mem_bytes = (D + 4) * n_rows if timed else 2 * D * n_rows
        ops = {"int8": 2.0 * n_tok * (2 * D * H + 2 * D * D) + 2.0 * n_rows * D * 2 * D,
               "bfloat16": 4.0 * D * float((toks * frames).sum()),
               "float32": 2.0 * K * D * n_tok}
        cases["decoder_layer"].append(_layer_case(
            torch, f"decoder layer {tag} token lengths {sorted(set(tlens))[:4]}"
            + (", memory quantized once per batch" if timed else ""),
            got, want, u_rng < tl_d[:, None, None], ms, plain,
            2 * 2 * n_tok * D + mem_bytes + 4 * B * T + wbytes_dec, ops,
            (lambda: dec(DL.fused_decoder_layer, mq_k)) if timed else None))

        x2 = x.reshape(B * T, D)
        got, want = FF.fused_ffn_int8(x2, ffn_w), FF.ffn_int8_ref(x2, ffn_w)
        ms = cuda_ms(lambda: FF.fused_ffn_int8(x2, ffn_w)) if timed else None
        plain = cuda_ms(lambda: FF.ffn_int8_ref(x2, ffn_w), iters=3) if timed else None
        cases["ffn"].append(_layer_case(
            torch, f"FFN M={B * T} {D} -> {H} -> {D}", got, want,
            torch.ones_like(got, dtype=torch.float32), ms, plain,
            2 * 2 * B * T * D + 2 * D * H + 4 * (2 * H + 2 * D),
            {"int8": 2.0 * B * T * 2 * D * H},
            (lambda: FF.fused_ffn_int8(x2, ffn_w)) if timed else None))

    # the main path: bench.py's batch, 15 s rows (250 frames), every other 12 s
    run(B, 256, 128, [250, 200] * (B // 2), [110, 90] * (B // 2), timed=True)
    # the aishell recipes' fused FFN, 256 -> 2048 -> 256: the Transformer
    # encoder's B=32 x 383 frames, the RWKV decoder's B=8 x beam 10 x 97 tokens
    g5 = torch.Generator(device="cuda").manual_seed(5)
    r = lambda *shape, sc: torch.randn(shape, generator=g5, device="cuda") * sc  # noqa: E731
    ffn256 = FF.quantize_ffn(r(H, 256, sc=256 ** -0.5), r(H, sc=0.1), r(256, H, sc=H ** -0.5),
                             r(256, sc=0.1))
    for M in (12256, 7760, 1) if aishell_ffn else ():
        x2 = torch.randn((M, 256), generator=gen, device="cuda").to(torch.bfloat16)
        timed = M > 1
        got, want = FF.fused_ffn_int8(x2, ffn256), FF.ffn_int8_ref(x2, ffn256)
        ms = cuda_ms(lambda: FF.fused_ffn_int8(x2, ffn256)) if timed else None
        plain = cuda_ms(lambda: FF.ffn_int8_ref(x2, ffn256), iters=3) if timed else None
        cases["ffn"].append(_layer_case(
            torch, f"FFN M={M} 256 -> {H} -> 256", got, want,
            torch.ones_like(got, dtype=torch.float32), ms, plain,
            2 * 2 * M * 256 + 2 * 256 * H + 4 * (2 * H + 2 * 256),
            {"int8": 2.0 * M * 2 * 256 * H},
            (lambda: FF.fused_ffn_int8(x2, ffn256)) if timed else None))
        check(cases["ffn"][-1]["elements_differing"] == 0,
              f"int8 FFN M={M} 256 -> {H} -> 256 bit-equal to its twin")
    # edges: ragged T and U, an empty utterance, a token length of 0, one frame
    run(3, 250, 37, [250, 137, 0], [37, 0, 20], timed=False)
    run(2, 1, 1, [1, 1], [1, 0], timed=False)
    for group in cases.values():
        for case in group:
            log(f"int8 layer {case}")
    return cases


def ctc_inputs(torch, gen, B, K, W, T, neg_rows=False):
    """xg, xb, phi_shift as the beam makes them: emission rows of log-probs,
    a phi whose first column is NEG_INF (a non-empty prefix)."""
    from funasr_torch.ops.ctc_prefix import NEG_INF

    logp = lambda *s: torch.log_softmax(
        torch.randn((*s, 16), generator=gen, device="cuda") * 2, -1)[..., 0]
    xg, xb = logp(B, K, W, T), logp(B, T)
    phi = torch.randn((B, K, W, T), generator=gen, device="cuda") * 3 - 20
    phi[..., 0] = NEG_INF
    if neg_rows:  # candidate slots with no path at all
        xg[0] = NEG_INF
        phi[0] = NEG_INF
    return xg, xb, phi


def check_ctc_prefix(torch, CP):
    """The CTC prefix recurrence against its twin: the beam's shape (B=32 x
    15 s: K=10, W=16, T=383 frames) and edges.  Bound: bytes, xg and phi
    read and the (r_nb, r_b) output written once, plus xb."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for B, K, W, T, neg, what in ((32, 10, 16, 383, False, "beam step, B=32 x 15 s"),
                                  (3, 5, 7, 45, True, "edge: R=105 rows, not a multiple "
                                   "of the block; NEG_INF rows"),
                                  (1, 1, 1, 1, False, "edge: one row, T=1"),
                                  (2, 3, 5, 1500, True, "edge: T=1500 (60 s)"),
                                  (2, 10, 16, 383, True, "edge: NEG_INF rows at the "
                                   "beam's width")):
        xg, xb, phi = ctc_inputs(torch, gen, B, K, W, T, neg)
        got, want = CP.ctc_recurrence(xg, xb, phi), CP.ctc_recurrence_ref(xg, xb, phi)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"ctc prefix {what} finite")
        err = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        check(err <= CTC_REL_TOL, f"ctc prefix {what}: relative err {err} > {CTC_REL_TOL}")
        case = dict(case=f"{what}: xg/phi ({B}, {K}, {W}, {T}) f32, xb ({B}, {T})",
                    max_abs_err=float((got - want).abs().max()), max_rel_err=err,
                    bit_equal=bool(torch.equal(got, want)), tolerance=CTC_REL_TOL)
        if not cases:  # time the main shape
            R = B * K * W
            case.update(ms=cuda_ms(lambda: CP.ctc_recurrence(xg, xb, phi), iters=20),
                        graph_ms=graph_ms(lambda: CP.ctc_recurrence(xg, xb, phi)),
                        plain_ms=cuda_ms(lambda: CP.ctc_recurrence_ref(xg, xb, phi),
                                         iters=3),
                        library_ms=None)
            # ~10 float32 operations and 6 exp/log per row and frame
            bnd, by = bound_ms(4.0 * (2 * R * T + B * T) + 4.0 * 2 * R * T,
                               {"float32": 16.0 * R * T})
            case.update(bound_ms=bnd, bound_by=by)
        log(f"ctc prefix {case}")
        cases.append(case)
    return cases


def step_inputs(torch, gen, B, K, W, T, V, step0=False, neg_rows=False):
    """x_t, r_prev, last, cand of the beam's CTC prefix step: masked
    log-probs, time-minor (blank 0, eos V - 1, the last third of the frames
    of every other row masked); the step-0 state broadcast over K (stride 0)
    or a random one; candidates that repeat the last token, blank and eos;
    ``neg_rows``: a token and a hypothesis with no mass at all."""
    from funasr_torch.ops.beam_search import ctc_init_state, mask_ctc_frames
    from funasr_torch.ops.ctc_prefix import NEG_INF

    logp = torch.log_softmax(torch.randn((B, T, V), generator=gen, device="cuda") * 2, -1)
    lens = torch.full((B,), T, dtype=torch.int64, device="cuda")
    lens[1::2] = max(1, T - T // 3)
    x = mask_ctc_frames(logp, lens, 0)
    if neg_rows:
        x[:, :, V - 2] = NEG_INF
    x_t = x.transpose(1, 2).contiguous()
    if step0:
        r_prev = ctc_init_state(x, 0)[0][:, None].expand(B, K, T, 2)
    else:
        r_prev = torch.log(torch.rand((B, K, T, 2), generator=gen, device="cuda")) * 3 - 20
        if neg_rows:
            r_prev[:, K - 1] = NEG_INF
    last = torch.randint(1, V - 1, (B, K), generator=gen, device="cuda")
    cand = torch.randint(1, V, (B, K, W), generator=gen, device="cuda")
    cand[..., 0] = last
    for w, tok in enumerate((0, V - 1, V - 2)[:W - 1]):
        cand[..., w + 1] = tok
    return x_t, r_prev, last, cand


def check_ctc_prefix_step(torch, CP):
    """The beam's CTC prefix step in one launch against its twin, at the
    beam's shape (B=32 x 15 s: K=10, W=16, T=383, V=4233) and edges.  Main
    shape: events and CUDA graph (bar
    CTC_STEP_MS_BAR), the unfused composition the beam ran before (the
    twin's prologue and sigma around the recurrence kernel) by CUDA graph
    (``tools/port_ab.py`` times the parent checkout's own), the twin, and
    the chain floor (``ctc_chain_floor``: T frames of the dependent lse
    chain in one warp, operands in registers).  Bound: bytes, the gathered
    rows, r_prev, xb, cand and last read once, r_new and sigma written once."""
    import ctypes

    from funasr_torch.ops import cuda_build

    floor_fn = cuda_build.function("ctc_prefix", "ctc_chain_floor",
                                   [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    stream = lambda: torch.cuda.current_stream().cuda_stream

    gen = torch.Generator(device="cuda").manual_seed(6)
    V = CONFORMER_HYBRID["vocab_size"]
    cases = []
    for B, K, W, T, step0, neg, what in (
            (32, 10, 16, 383, False, False, "beam step, B=32 x 15 s"),
            (32, 10, 16, 383, True, False, "step 0 (state broadcast over K, stride 0)"),
            (2, 10, 16, 383, False, True, "edge: no-mass token and hypothesis"),
            (3, 5, 7, 45, False, True, "edge: R=105 rows, 4 hypotheses a block"),
            (1, 1, 1, 1, True, False, "edge: one row, T=1"),
            (2, 3, 5, 1500, False, True, "edge: T=1500 (60 s)"),
            (3, 2, 1, 13, False, False, "edge: W=1, T=13"),
            (2, 2, 40, 70, False, True, "edge: W=40, two blocks a hypothesis")):
        a = (*step_inputs(torch, gen, B, K, W, T, V, step0, neg), step0, 0)
        got, want = CP.ctc_prefix_step(*a), CP.ctc_prefix_step_ref(*a)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got), f"ctc step {what} finite")
        err = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                  for x, y in zip(got, want))
        check(err <= CTC_REL_TOL, f"ctc step {what}: relative err {err} > {CTC_REL_TOL}")
        case = dict(case=f"{what}: x_t ({B}, {V}, {T}) f32, K={K}, W={W}",
                    max_abs_err=max(float((x - y).abs().max()) for x, y in zip(got, want)),
                    max_rel_err=err, bit_equal=all(torch.equal(x, y) for x, y in zip(got, want)),
                    tolerance=CTC_REL_TOL)
        if not cases:  # time the main shape
            R, H = B * K * W, B * K
            out = torch.empty((32, 2), device="cuda")
            floor = lambda: cuda_build.check(floor_fn(T, out.data_ptr(), stream()),
                                             "ctc chain floor launch")
            # the unfused step that the beam ran before: the twin's prologue
            # and sigma around this checkout's recurrence kernel (through its
            # launcher, so that the swapped-in name never reaches the twin)
            with swapped([(CP, "ctc_recurrence_ref", CP._launch)]):
                unfused = graph_ms(lambda: CP.ctc_prefix_step_ref(*a), iters=10, replays=3)
            case.update(ms=cuda_ms(lambda: CP.ctc_prefix_step(*a), iters=20),
                        graph_ms=graph_ms(lambda: CP.ctc_prefix_step(*a)),
                        unfused_graph_ms=unfused,
                        plain_ms=cuda_ms(lambda: CP.ctc_prefix_step_ref(*a), iters=2,
                                         warmup=1),
                        chain_floor_ms=graph_ms(floor), library_ms=None)
            # about 20 float32 operations per row and frame (two lse, two adds),
            # 9 per hypothesis and frame (phi_all)
            nbytes = (4.0 * (R * T + 2 * H * T + B * T) + 8.0 * (R + H)
                      + 4.0 * (2 * R * T + R))
            bnd, by = bound_ms(nbytes, {"float32": 20.0 * R * T + 9.0 * H * T})
            case.update(bound_ms=bnd, bound_by=by)
            check(case["graph_ms"] <= CTC_STEP_MS_BAR,
                  f"ctc step {what}: {case['graph_ms']:.4f} ms by CUDA graph > "
                  f"{CTC_STEP_MS_BAR}")
        log(f"ctc step {case}")
        cases.append(case)
    return cases


# (M, K, N) of the qmm route's gated contractions at B=64 x 15 s (64 x 256
# encoder frames, 64 x 128 tokens), then edge shapes
QMM_SHAPES = (
    (16384, 560, 1536, "encoders0 QKV (K=560)"),
    (8192, 512, 2048, "decoders3 w_1"),
    (8192, 512, 8404, "output layer (N=8404)"),
    (1000, 560, 1536, "edge: M not a multiple of the 64-row block"),
    (12256, 256, 2048, "edge: K=256 (the Conformer's w_1)"),
    (37, 512, 8404, "edge: 37 rows, N=8404"),
    (256, 3072, 512, "edge: K=3072, the largest K (64-row band)"),
)
QMM_TIMED = 3


def check_qmm(torch, QM, Q, RQ, G):
    """The fused int8 matmul against its twin, bit-equal: bf16 with and
    without the bias, and float32.  At the main shapes, beside it the XLA
    route's rowquant + int8 GEMM pair ("div" form) and ``torch._int_mm`` on
    the operands quantized beforehand."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = []
    for i, (M, K, N, where) in enumerate(QMM_SHAPES):
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5
        w8, sw = Q.quantize_weight(w.to(torch.bfloat16))
        bias = (0.1 * torch.randn(N, generator=gen, device="cuda")).to(torch.bfloat16).float()
        equal = {}
        for name, args in (("bf16 + bias", (x, w8, sw, bias)), ("bf16", (x, w8, sw)),
                           ("float32 + bias", (x.float(), w8, sw, bias))):
            equal[name] = bool(torch.equal(QM.quant_matmul(*args), QM.quant_matmul_ref(*args)))
        torch.cuda.synchronize()
        check(all(equal.values()), f"qmm {where} ({M}, {K}, {N}) bit-equal to its twin: {equal}")
        case = dict(case=f"{where}: x ({M}, {K}) bf16, w ({N}, {K}) int8 -> bf16 + bias",
                    max_abs_err=0.0, tolerance=0.0, bit_equal=equal)
        if i < QMM_TIMED:
            ms = cuda_ms(lambda: QM.quant_matmul(x, w8, sw, bias))
            plain = cuda_ms(lambda: QM.quant_matmul_ref(x, w8, sw, bias), iters=3)
            pair = cuda_ms(lambda: Q.int8_linear(x, w8, sw, bias))
            lib = None
            if M > 16 and K % 8 == 0 and N % 8 == 0:  # torch._int_mm's shape rules
                q, _ = RQ.rowquant(x, form="mul")
                lib = cuda_ms(lambda: torch._int_mm(q, w8.t()))
            # x read once in bf16, w8 once, the scales and bias, out written once
            nbytes = 2 * M * K + N * K + 8 * N + 2 * M * N
            bnd, by = bound_ms(nbytes, {"int8": 2.0 * M * N * K})
            plan = QM.qmm_plan(M, N, K, G.sm_count(0))
            case.update(ms=ms, plain_ms=plain, rowquant_int8_gemm_ms=pair, library_ms=lib,
                        ms_over_library=None if lib is None else ms / lib,
                        bound_ms=bnd, bound_by=by, ms_over_bound=ms / bnd,
                        tops=2.0 * M * N * K / ms / 1e9,
                        plan=f"BM={plan.bm} BN={plan.bn} stages={plan.stages} "
                             f"grid={plan.grid} units={plan.units}")
        log(f"qmm {case}")
        if i < QMM_TIMED:
            speed_bar(case)
        cases.append(case)
    return cases


# The row-quantizing int8 GEMM (``int8_gemm_rq``): the SANM wout at B=64 x
# 15 s (64 x 256 frames), then edges: (M, K, N, residual dtype or None,
# bias, FSMN (B, T, lengths), where).
RQ_CASES = (
    (16384, 512, 512, "bf16", True, (64, 256, [250, 200] * 32),
     "SANM ctx -> wout + FSMN in the epilogue"),
    (37, 512, 512, "bf16", True, (1, 37, [25]), "edge: M=37, T=37"),
    (5, 512, 512, "f32", True, (5, 1, [1, 0, 1, 1, 0]), "edge: T=1, lengths of 0"),
    (750, 512, 512, "bf16", True, (3, 250, [250, 137, 0]),
     "edge: ragged tiles across utterances, a length of 0"),
    (37, 16, 8, None, False, (1, 37, [37]), "edge: K=16, N=8, no residual or bias"),
    (1000, 640, 1536, "f32", True, (4, 250, [250, 3, 249, 1]),
     "edge: K=640 (the widest band), ragged M"),
)
RQ_TIMED = 1  # the served row


def check_int8_rq(torch, G, RQ, FM, rq_cases=RQ_CASES):
    """The int8 GEMM's row-quantizing entry against its twin
    (``int8_gemm_rq_ref``: ``rowquant_ref`` "mul", ``fsmn_ref``, then
    ``int8_gemm_ref``), bit-equal, at every row of ``RQ_CASES``; the served
    row timed beside the three launches it replaces (rowquant, the FSMN
    kernel, the int8 GEMM with the memory as ``add``) and beside the int8
    GEMM alone on rows quantized and a memory made beforehand."""
    from funasr_torch.ops.quant import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(12)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = []
    for i, (M, K, N, res_dt, has_bias, (B, T, lens), where) in enumerate(rq_cases):
        x = torch.randn((M, K), generator=gen, device="cuda") * 2
        x[min(3, M - 1)] = 0  # an all-zero row
        w = torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5
        w8, sw = quantize_weight(w)
        bias = 0.1 * torch.randn(N, generator=gen, device="cuda") if has_bias else None
        res = (None if res_dt is None else
               torch.randn((M, N), generator=gen, device="cuda").to(dtypes[res_dt]))
        qkv = torch.randn((B, T, 3 * N), generator=gen, device="cuda")
        taps = 0.3 * torch.randn((11, N), generator=gen, device="cuda")
        fsmn = G.Fsmn(qkv[..., 2 * N:], torch.tensor(lens, device="cuda", dtype=torch.int32),
                      taps, 5)
        got = G.int8_gemm_rq(x, w8, sw, fsmn, bias=bias, res=res)
        want = G.int8_gemm_rq_ref(x, w8, sw, fsmn, bias=bias, res=res)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        check(equal and bool(torch.isfinite(got).all()),
              f"int8_gemm_rq {where} ({M}, {K}, {N}) bit-equal to its twin: "
              f"{int((got != want).sum())} elements differ")
        plan = G.rq_plan(M, N, K, G.sm_count(0))
        case = dict(case=f"{where}: x ({M}, {K}) f32, w ({N}, {K}) int8, "
                         f"res {res_dt}, bias {has_bias}, FSMN B={B} T={T}",
                    max_abs_err=0.0, tolerance=0.0, bit_equal=equal,
                    plan=f"BM={G.RQ_BM} BN={G.RQ_BN} stages={plan.stages} grid={plan.grid} "
                         f"units={plan.units}")
        if i < RQ_TIMED:
            def pair():
                add = FM.fsmn(fsmn.v, fsmn.lengths, fsmn.taps, fsmn.left).view(M, N)
                q, s = RQ.rowquant(x)
                return G.int8_gemm(q, s, w8, sw, bias=bias, res=res, add=add)
            ms = graph_ms(lambda: G.int8_gemm_rq(x, w8, sw, fsmn, bias=bias, res=res))
            pair_ms = graph_ms(pair)
            plain = cuda_ms(lambda: G.int8_gemm_rq_ref(x, w8, sw, fsmn, bias=bias, res=res),
                            iters=3)
            nbytes = (M * K * 4 + N * K + 8 * N + M * N * 4
                      + (0 if res is None else M * N * res.element_size())
                      + 4 * M * N + 4 * 11 * N + 4 * B)
            # the int8 GEMM alone on the rows quantized and the FSMN memory
            # made beforehand: what the fused entry adds to it is its band's
            # quantize and its FSMN
            q, s = RQ.rowquant(x)
            add = FM.fsmn(fsmn.v, fsmn.lengths, fsmn.taps, fsmn.left).view(M, N)
            gemm_ms = graph_ms(lambda: G.int8_gemm(q, s, w8, sw, bias=bias, res=res, add=add))
            bnd, by = bound_ms(nbytes, {"int8": 2.0 * M * N * K, "float32": 2.0 * 11 * M * N})
            case.update(ms=ms, plain_ms=plain, library_ms=None, replaced_pair_ms=pair_ms,
                        ms_over_pair=ms / pair_ms, gemm_alone_ms=gemm_ms,
                        bound_ms=bnd, bound_by=by, ms_over_bound=ms / bnd)
        log(f"int8 gemm rq {case}")
        cases.append(case)
    return cases


def check_fsmn_ln(torch, FM, RQ):
    """The decoder layer's fused LN2 + FSMN (+ the residual) against its
    twin, bit-equal: the main path's shape (B=64, U=128, D=512, token
    lengths 110/90, bf16 residual) timed beside the two launches it
    replaced (rowquant LN-only + FSMN), and edges: ragged U with lengths 37,
    1 and 0, U=1, a float32 residual, no residual."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    D, K, LEFT = 512, 11, 5
    ln = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda"),
          0.1 * torch.randn(D, generator=gen, device="cuda"))
    taps = 0.3 * torch.randn((K, D), generator=gen, device="cuda")
    cases = []
    for B, U, lens, res_dt, what in ((64, 128, [110, 90] * 32, torch.bfloat16,
                                      "decoder layer, B=64 x 128 tokens, lengths 110/90"),
                                     (3, 37, [37, 1, 0], torch.float32,
                                      "edge: U=37, lengths 37/1/0, float32 residual"),
                                     (2, 1, [1, 0], None, "edge: U=1, lengths 1/0, no residual")):
        h = torch.randn((B, U, D), generator=gen, device="cuda") * 2
        res = (None if res_dt is None
               else torch.randn((B, U, D), generator=gen, device="cuda").to(res_dt))
        lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
        got = FM.fsmn_ln(h, ln, lengths, taps, LEFT, res=res)
        want = FM.fsmn_ln_ref(h, ln, lengths, taps, LEFT, res=res)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        check(equal, f"fsmn_ln {what} bit-equal to its twin: "
              f"{int((got != want).sum())} elements differ")
        case = dict(case=f"{what}: h ({B}, {U}, {D}) f32", max_abs_err=0.0, tolerance=0.0,
                    bit_equal=equal)
        if not cases:
            def pair():
                y = RQ.rowquant(h.view(B * U, D), ln, quantize=False)
                return FM.fsmn(y.view(B, U, D), lengths, taps, LEFT, res=res)
            nbytes = B * U * D * (4 + 2 + 4) + 4 * (K + 2) * D + 4 * B
            bnd, by = bound_ms(nbytes, {"float32": B * U * D * (8.0 + 2 * K)})
            ms = graph_ms(lambda: FM.fsmn_ln(h, ln, lengths, taps, LEFT, res=res))
            pair_ms = graph_ms(pair)
            case.update(ms=ms, plain_ms=cuda_ms(lambda: FM.fsmn_ln_ref(
                h, ln, lengths, taps, LEFT, res=res), iters=3), library_ms=None,
                replaced_pair_ms=pair_ms, ms_over_pair=ms / pair_ms, bound_ms=bnd,
                bound_by=by, ms_over_bound=ms / bnd)
        log(f"fsmn_ln {case}")
        cases.append(case)
    return cases


def check_rowquant_fsmn(torch, RQ, FM):
    """The standalone rowquant and FSMN kernels against their twins,
    bit-equal.  rowquant: the decoder memory's quantize (B=64 x 256 frames,
    bf16, once per batch), QDense's "div" form at encoders0 (K=560), the
    layer-norm-only call (no longer on a path) and an edge; FSMN (no caller
    on a path since the SANM layer folds it into its wout GEMM and the
    decoder takes fsmn_ln): the SANM shape, v a column slice of the QKV
    output, with and without a bf16 residual, and edges."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {"rowquant": [], "fsmn": []}
    for M, W, dt, norm, form, quant, what in (
            (16384, 512, torch.bfloat16, False, "mul", True,
             "decoder memory, B=64 x 256 frames (once per batch)"),
            (16384, 560, torch.bfloat16, False, "div", True, "QDense encoders0 QKV (div)"),
            (8192, 512, torch.float32, True, "mul", False, "layer norm only"),
            (37, 16, torch.float32, True, "mul", True, "edge: 37 rows of 16, LN")):
        x = (torch.randn((M, W), generator=gen, device="cuda") * 2).to(dt)
        ln = ((1 + 0.1 * torch.randn(W, generator=gen, device="cuda"),
               0.1 * torch.randn(W, generator=gen, device="cuda")) if norm else None)
        got = RQ.rowquant(x, ln, form, quant)
        want = RQ.rowquant_ref(x, ln, form, quant)
        torch.cuda.synchronize()
        equal = (all(torch.equal(g, w) for g, w in zip(got, want)) if quant
                 else bool(torch.equal(got, want)))
        check(equal, f"rowquant {what} bit-equal to its twin")
        case = dict(case=f"{what}: ({M}, {W}) {str(dt)[6:]}, form {form}"
                         f"{', LN' if norm else ''}{'' if quant else ', no quantize'}",
                    max_abs_err=0.0, tolerance=0.0, bit_equal=equal)
        if not out["rowquant"]:
            bnd, by = bound_ms(M * W * x.element_size() + M * W + 4 * M, {})
            case.update(ms=graph_ms(lambda: RQ.rowquant(x, ln, form, quant)),
                        plain_ms=cuda_ms(lambda: RQ.rowquant_ref(x, ln, form, quant), iters=3),
                        library_ms=None, bound_ms=bnd, bound_by=by)
        log(f"rowquant {case}")
        out["rowquant"].append(case)
    D, K, LEFT = 512, 11, 5
    taps = 0.3 * torch.randn((K, D), generator=gen, device="cuda")
    for B, T, lens, res_dt, what in ((64, 256, [250, 200] * 32, None,
                                      "SANM shape, v the QKV slice, lengths 250/200"),
                                     (64, 256, [250, 200] * 32, torch.bfloat16,
                                      "SANM shape with a bf16 residual"),
                                     (3, 37, [37, 1, 0], torch.float32,
                                      "edge: T=37, lengths 37/1/0"),
                                     (2, 1, [1, 0], None, "edge: T=1")):
        qkv = torch.randn((B, T, 3 * D), generator=gen, device="cuda")
        v = qkv[..., 2 * D:]
        res = (None if res_dt is None
               else torch.randn((B, T, D), generator=gen, device="cuda").to(res_dt))
        lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
        got = FM.fsmn(v, lengths, taps, LEFT, res=res)
        want = FM.fsmn_ref(v, lengths, taps, LEFT, res=res)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        check(equal, f"fsmn {what} bit-equal to its twin")
        case = dict(case=f"{what}: v ({B}, {T}, {D}) f32", max_abs_err=0.0, tolerance=0.0,
                    bit_equal=equal)
        if not out["fsmn"]:
            bnd, by = bound_ms(2 * 4 * B * T * D + 4 * K * D + 4 * B,
                               {"float32": 2.0 * (K + 1) * B * T * D})
            case.update(ms=graph_ms(lambda: FM.fsmn(v, lengths, taps, LEFT, res=res)),
                        plain_ms=cuda_ms(lambda: FM.fsmn_ref(v, lengths, taps, LEFT, res=res),
                                         iters=3),
                        library_ms=None, bound_ms=bnd, bound_by=by)
        log(f"fsmn {case}")
        out["fsmn"].append(case)
    return out


def exact_scratch_edge(torch, A, name, gen, D=512):
    """Past EXACT_ONCHIP_MAX_T keys the int8 layers' attention keeps its
    scores in a device scratch: at T=1000 (60 s of LFR frames, ragged
    lengths) one launch, launches one batch row at a time (the scratch cap
    made small) and the twin are bit-equal (width D, 4 heads)."""
    from funasr_torch.ops.masks import key_bias

    NH, U, T = 4, 40, 1000
    check(T > A.EXACT_ONCHIP_MAX_T, "the long-T edge is past the on-chip limit")
    fn, ref = getattr(A, name), getattr(A, name + "_ref")
    q = torch.randn((3, U, D), generator=gen, device="cuda")
    kv = torch.randn((3, T, 2 * D), generator=gen, device="cuda")
    lens3 = torch.tensor([T, 33, 0], device="cuda", dtype=torch.int32)
    args = (q, kv[..., :D], kv[..., D:], key_bias(lens3, T), NH, (D // NH) ** -0.5, lens3)
    whole = fn(*args)
    saved = A.F32CTX_SCRATCH_BYTES
    A.F32CTX_SCRATCH_BYTES = 4 * NH * U * A.exact_scores_ld(T)  # one row a launch
    try:
        check(A.exact_attention_plan(3, NH, U, T)[1] == 3, "the small cap chunks by rows")
        chunked = fn(*args)
    finally:
        A.F32CTX_SCRATCH_BYTES = saved
    check(torch.equal(whole, chunked) and torch.equal(whole, ref(*args)),
          f"{name}: scores in the scratch at T={T}, row-chunked launches, one launch and "
          "twin equal")


def check_f32ctx(torch, A, D=512, B=64, seed=9):
    """The float32-context attention of the int8 layers alone, bit-equal to
    its twin: the SANM shape (q, k, v column slices of one float32 (B, T, 3D)
    projection, v zero past the lengths) and the decoder's cross-attention
    (U=128, k/v column slices of the memory's (B, T, 2D) projection, no
    v_lengths), timed beside its twin and ``scaled_dot_product_attention`` on
    the same bf16-rounded q, k, v (the yardstick: bf16 products with float32
    sums, not the exact sums); edges: T=70 with a length-1 row, T=1, T=1000
    with the scores in the scratch, also row-chunked
    (``exact_scratch_edge``); width D with 4 heads, the main shapes at
    batch B.  Returns {"sanm_layer": [case], "decoder_layer": [case]}."""
    import torch.nn.functional as F

    from funasr_torch.ops.masks import key_bias

    gen = torch.Generator(device="cuda").manual_seed(seed)
    NH = 4
    d = D // NH
    cases = {"sanm_layer": [], "decoder_layer": []}
    B0 = B
    for B, U, T, lens, kv_cols, vlen, entry, what in (
            (B0, 256, 256, [250, 200] * (B0 // 2), 3 * D, True, "sanm_layer",
             f"SANM layer attention alone, B={B0} x 15 s, lengths 250/200"),
            (B0, 128, 256, [250, 200] * (B0 // 2), 2 * D, False, "decoder_layer",
             f"decoder cross-attention alone, B={B0}, U=128, memory lengths 250/200"),
            (3, 70, 70, [70, 1, 33], 3 * D, True, None, "edge: T=70, a length-1 row"),
            (2, 1, 1, [1, 1], 3 * D, True, None, "edge: T=1"),
            (2, 1000, 1000, [1000, 613], 3 * D, True, None,
             "edge: T=1000 (60 s), scores in the scratch")):
        proj = torch.randn((B, T, kv_cols), generator=gen, device="cuda")
        q = proj[..., :D] if U == T else torch.randn((B, U, D), generator=gen, device="cuda")
        lens_d = torch.tensor(lens, device="cuda", dtype=torch.int32)
        bias = key_bias(lens_d, T)
        args = (q, proj[..., -2 * D:-D], proj[..., -D:], bias, NH, d ** -0.5,
                lens_d if vlen else None)
        got, want = A.attention_f32ctx(*args), A.attention_f32ctx_ref(*args)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        check(bool(torch.isfinite(got).all()) and equal,
              f"float32-context attention {what}: bit-equal to its twin")
        case = dict(case=f"{what}: q ({B}, {U}, {D}), k/v ({B}, {T}, {D}) f32, H={NH}",
                    max_abs_err=float((got - want).abs().max()), tolerance=0.0,
                    bit_equal=equal)
        if entry:
            bf = torch.bfloat16
            vm = args[2] * (torch.arange(T, device="cuda")[None, :, None]
                            < lens_d[:, None, None]) if vlen else args[2]
            heads = lambda x: x.to(bf).unflatten(-1, (NH, d)).transpose(1, 2)
            q4, k4, v4 = heads(q * d ** -0.5), heads(args[1]), heads(vm)
            mask = bias[:, None, None, :].to(bf)
            rows = lens_d.clamp(max=T).double()
            n_q = float(rows.sum()) if U == T else float(B * U)
            pairs = float((rows * rows).sum()) if U == T else float(U * rows.sum())
            # q, k, v read and the context written for the valid rows; the
            # bf16 products of the function (the exact sums are the port's
            # contract; their float64 tensor-core floor is beside it)
            bnd, by = bound_ms(4.0 * D * (2 * n_q + 2 * float(rows.sum())) + 4 * B * T,
                               {"bfloat16": 4.0 * D * pairs})
            case.update(ms=cuda_ms(lambda: A.attention_f32ctx(*args), iters=20, warmup=10),
                        plain_ms=cuda_ms(lambda: A.attention_f32ctx_ref(*args), iters=3),
                        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=mask, scale=1.0), iters=50, warmup=10),
                        bound_ms=bnd, bound_by=by,
                        f64_tensor_core_floor_ms=4.0 * D * pairs / PEAK_OPS["float64"] * 1e3)
            cases[entry].append(case)
        log(f"float32-context attention {case}")
    exact_scratch_edge(torch, A, "attention_f32ctx", gen, D)
    return cases


def check_i8qk(torch, A, D=512, B=64, seed=7):
    """The int8-score attention against its twin, bit-equal: the SANM shape
    (q, k, v column slices of one float32 (B, T, 3D) projection, as in the
    layer), T not a multiple of the 64-key tile with a length-1 row, T=1,
    and T=1000 with the scores in the scratch (``exact_scratch_edge``).  At
    the main shape, the float32-context attention on the same inputs beside
    it.  Width D with 4 heads, the main shape at batch B."""
    from funasr_torch.ops.masks import key_bias

    gen = torch.Generator(device="cuda").manual_seed(seed)
    NH = 4
    cases = []
    for B, T, lens, what in ((B, 256, [250, 200] * (B // 2), f"SANM layer attention, B={B} x "
                              "15 s, lengths 250/200"),
                             (3, 70, [70, 1, 33], "edge: T=70, a length-1 row"),
                             (2, 1, [1, 1], "edge: T=1"),
                             (2, 1000, [1000, 613], "edge: T=1000 (60 s), scores in the "
                              "scratch")):
        qkv = torch.randn((B, T, 3 * D), generator=gen, device="cuda")
        lens_d = torch.tensor(lens, device="cuda", dtype=torch.int32)
        args = (qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], key_bias(lens_d, T), NH,
                (D // NH) ** -0.5, lens_d)
        got, want = A.attention_i8qk(*args), A.attention_i8qk_ref(*args)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        check(bool(torch.isfinite(got).all()) and equal,
              f"int8-score attention {what}: bit-equal to its twin")
        case = dict(case=f"{what}: q/k/v ({B}, {T}, {D}) f32, H={NH}",
                    max_abs_err=float((got - want).abs().max()), tolerance=0.0,
                    bit_equal=equal)
        if not cases:
            rows = lens_d.clamp(max=T).double()
            n_rows, pairs = float(rows.sum()), float((rows * rows).sum())
            # q, k, v read and the context written for the valid rows
            bnd, by = bound_ms(4.0 * D * 4 * n_rows + 4 * B * T,
                               {"int8": 2.0 * D * pairs, "bfloat16": 2.0 * D * pairs})
            case.update(ms=cuda_ms(lambda: A.attention_i8qk(*args), iters=20, warmup=10),
                        plain_ms=cuda_ms(lambda: A.attention_i8qk_ref(*args), iters=3),
                        f32ctx_ms=cuda_ms(lambda: A.attention_f32ctx(*args), iters=20,
                                          warmup=10),
                        library_ms=None, bound_ms=bnd, bound_by=by)
        log(f"int8-score attention {case}")
        cases.append(case)
    exact_scratch_edge(torch, A, "attention_i8qk", gen, D)
    return cases


# (M, K, H, N) of the bf16/float32 FFN: the encoder FFN's shape, the shape
# that was its first ragged edge, and edges of the hidden-chunk design (one
# row, a band and one row, a hidden chunk of 32 columns, H = 8192)
FFN_SHAPES = [(16384, 512, 2048, 512), (37, 256, 512, 100), (1, 512, 2048, 512),
              (65, 512, 2048, 512), (300, 512, 544, 512), (300, 512, 8192, 512)]


def kernels_per_call(torch, fn, name, calls=5):
    """(launches of kernels whose name holds ``name``, all kernel launches)
    per call of ``fn``, from a torch.profiler trace of ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in p.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total
               and not ev.key.lower().startswith(("memcpy", "memset"))]
    return (sum(ev.count for ev in kernels if name in ev.key) / calls,
            sum(ev.count for ev in kernels) / calls)


def check_ffn(torch, FF):
    """The bf16 and float32 FFN against its twin within FFN_TOL at
    FFN_SHAPES, each call counted in ``fused_ffn.launches``.  At the
    encoder FFN's shape: kernel, twin and the yardstick (two ``F.linear``
    and a relu) by events and by CUDA graph, a profile that shows one
    kernel a call, the bar (the bf16 kernel faster than the yardstick by
    CUDA graph) and b1 given as a view that does not start on 16 bytes.
    No model routes this kernel (the JAX package's neither): these are its
    only launches."""
    import torch.nn.functional as F

    from funasr_torch.ops import int8_gemm as G

    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for M, K, H, N in FFN_SHAPES:
        for dtype, dn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
            x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
            w1 = (torch.randn((H, K), generator=gen, device="cuda") * K ** -0.5).to(dtype)
            w2 = (torch.randn((N, H), generator=gen, device="cuda") * H ** -0.5).to(dtype)
            b1 = 0.1 * torch.randn(H, generator=gen, device="cuda")
            b2 = 0.1 * torch.randn(N, generator=gen, device="cuda")
            launches = FF.fused_ffn.launches
            got, want = FF.fused_ffn(x, w1, b1, w2, b2), FF.ffn_ref(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            check(FF.fused_ffn.launches == launches + 1, "fused_ffn counts its launch")
            tol = FFN_TOL[dn] * float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= tol,
                  f"FFN ({M}, {K}) -> {H} -> {N} {dn}: max err {err} > {tol}")
            plan = FF.ffn_plan(M, K, H, N, dtype, G.sm_count(0))
            case = dict(case=f"FFN ({M}, {K}) -> {H} -> {N} {dn}", max_abs_err=err,
                        tolerance=tol, elements_differing=int((got != want).sum()),
                        plan=plan._asdict())
            if M == 16384:
                el = x.element_size()
                bnd, by = bound_ms(el * (M * K + M * N + K * H + H * N) + 4 * (H + N),
                                   {dn: 2.0 * M * K * H + 2.0 * M * H * N})
                run = lambda: FF.fused_ffn(x, w1, b1, w2, b2)
                b1d, b2d = b1.to(dtype), b2.to(dtype)
                lib = lambda: F.linear(torch.relu(F.linear(x, w1, b1d)), w2, b2d)
                case.update(ms=cuda_ms(run), graph_ms=graph_ms(run),
                            plain_ms=cuda_ms(lambda: FF.ffn_ref(x, w1, b1, w2, b2), iters=3),
                            library_ms=cuda_ms(lib), library_graph_ms=graph_ms(lib),
                            bound_ms=bnd, bound_by=by)
                if dtype == torch.bfloat16:
                    ours, every = kernels_per_call(torch, run, "ffn_wgmma_kernel")
                    check(ours == 1 and every == 1, f"bf16 FFN: {ours} FFN kernels and "
                          f"{every} kernels a call, want 1 and 1")
                    case["kernels_per_call"] = every
                    check(case["graph_ms"] < case["library_graph_ms"],
                          f"bf16 FFN {case['graph_ms']} ms by CUDA graph, not under two "
                          f"F.linear and a relu ({case['library_graph_ms']} ms)")
                # b1 4 bytes into a buffer: the wrapper copies it aligned
                b1_off = torch.empty(H + 1, device="cuda")[1:].copy_(b1)
                got = FF.fused_ffn(x, w1, b1_off, w2, b2)
                err_off = float((got.float() - want.float()).abs().max())
                check(b1_off.data_ptr() % 16 and bool(torch.isfinite(got).all())
                      and err_off <= tol, f"FFN {dn} with b1 off 16 bytes: max err "
                      f"{err_off} > {tol}")
                case["b1_offset_max_abs_err"] = err_off
            log(f"ffn {case}")
            cases.append(case)
    return cases


# ------------------------------------------------------------------ phase 3
@contextlib.contextmanager
def swapped(pairs):
    """Route the model through plain twins: (module, name, twin) triples."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, twin in pairs:
        setattr(m, n, twin)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def plain_twins(FK, A):
    """The PR 1 kernels' twins: fbank and attention."""
    return swapped([(FK, "fused_fbank", FK.fbank_ref),
                    (A, "fused_attention", A.attention_ref)])


def int8_twins():
    """This slice's kernels' twins: the three int8 layers and, for the QDense
    projections, the rowquant and int8 GEMM building blocks."""
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL

    return swapped([(SL, "fused_sanm_layer", SL.sanm_layer_ref),
                    (DL, "fused_decoder_layer", DL.decoder_layer_ref),
                    (FF, "fused_ffn_int8", FF.ffn_int8_ref),
                    (RQ, "rowquant", RQ.rowquant_ref),
                    (G, "int8_gemm", G.int8_gemm_ref),
                    (G, "int8_gemm_rq", G.int8_gemm_rq_ref),
                    (FM, "fsmn_ln", FM.fsmn_ln_ref)])


def end_to_end(torch, rng, FK, A, profile_dir, card, shared):
    import numpy as np

    from funasr_torch.auto.engines import FrontendConfig, ParaformerEngine
    from funasr_torch.models.paraformer.model import Paraformer, init_random_
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.tokenizer.char_tokenizer import CharTokenizer

    t0 = time.time()
    f32 = Paraformer(**FLAGSHIP, dtype=torch.float32)
    init_random_(f32, torch.Generator(device="cuda").manual_seed(2024))
    bf16 = Paraformer(**FLAGSHIP, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict(), strict=True)
    n_params = sum(p.numel() for p in f32.parameters())
    tokens = (["<blank>", "<s>", "</s>"]
              + [chr(0x4E00 + i) for i in range(FLAGSHIP["vocab_size"] - 4)]
              + ["<unk>"])
    tok = CharTokenizer(tokens)
    engine = ParaformerEngine(bf16, FrontendConfig(), tok)
    engine32 = ParaformerEngine(f32, FrontendConfig(), tok)
    log(f"e2e: Paraformer-large {n_params / 1e6:.1f} M params built in "
        f"{time.time() - t0:.1f} s")

    batches = []
    for size in (8, 16, 5):
        n = rng.integers(2 * FS, 15 * FS + 1, size)
        batches.append([waveform(rng, int(m), float(rng.uniform(100, 400)))
                        for m in n])
    engine.transcribe(batches[0][:2])  # warm-up (cuBLAS/cuDNN handles)
    torch.cuda.synchronize()

    # ---- the main path: counters at 0 just before, read just after
    counters = {"fbank": FK.fused_fbank, "attention": A.fused_attention,
                "int8_gemm": G.int8_gemm, "int8_gemm_rq": G.int8_gemm_rq,
                "rowquant": RQ.rowquant, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    results = [engine.transcribe(b) for b in batches]
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"e2e: served {sum(map(len, batches))} requests in 3 batches in "
        f"{serve_s:.3f} s; kernel launches {launches}")
    want = dict(fbank=len(batches), attention=len(batches) * (50 + 16), int8_gemm=0,
                int8_gemm_rq=0, rowquant=0, fsmn=0, fsmn_ln=0)
    check(launches == want, f"bf16 path launches {launches}, want {want}: fbank once a "
          "batch, attention in every encoder and decoder layer, no int8 kernel")
    for batch, res in zip(batches, results):
        check(len(res) == len(batch), "one result per request")
        check(all(isinstance(r.get("text"), str) for r in res),
              "every result has a text")
    log(f"e2e: sample texts {[r['text'][:12] for r in results[0][:3]]}")

    # ---- float32 on the card: kernels vs plain twins on the same weights
    b = batches[1]
    wav_d, lens_d = engine32._pack(b)
    max_tokens = engine32._max_tokens(wav_d.shape[1])

    def logits(eng):
        feats, flens = eng.frontend.device_features(wav_d, lens_d)
        return eng.module.inference_logits(feats, flens, max_tokens=max_tokens)

    lp_k, tl_k, pred_k = logits(engine32)
    with plain_twins(FK, A):
        lp_r, tl_r, pred_r = logits(engine32)
    lp_b, tl_b, _ = logits(engine)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lp_k).all()), "float32 log-probs finite")
    check(lp_k.shape == (len(b), max_tokens, FLAGSHIP["vocab_size"]),
          f"log-prob shape {tuple(lp_k.shape)}")
    check(torch.equal(tl_k, tl_r), f"float32 token lengths kernels {tl_k.tolist()}"
          f" vs twins {tl_r.tolist()}")
    valid = (torch.arange(max_tokens, device="cuda")[None] < tl_k[:, None])
    logp_err = float((lp_k - lp_r).abs()[valid].max())
    agree = float((lp_k.argmax(-1) == lp_r.argmax(-1))[valid].float().mean())
    peaks_equal = bool(torch.equal(pred_k.peaks, pred_r.peaks))
    bvalid = valid & (torch.arange(max_tokens, device="cuda")[None] < tl_b[:, None])
    agree_bf16 = float((lp_b.argmax(-1) == lp_k.argmax(-1))[bvalid].float().mean())
    log(f"e2e float32 kernels vs twins: max |dlogp| {logp_err:.3e} "
        f"(tol {E2E_F32_LOGP_TOL}), token agreement {agree:.5f}, token "
        f"lengths equal, peaks equal {peaks_equal}; bf16 vs float32 token "
        f"agreement {agree_bf16:.5f}, token lengths equal "
        f"{bool(torch.equal(tl_b, tl_k))}")
    check(logp_err <= E2E_F32_LOGP_TOL, "float32 log-probs kernels vs twins")
    check(agree >= E2E_F32_MIN_AGREE, "float32 token agreement")
    e2e = dict(f32_logp_max_abs_diff=logp_err, f32_token_agreement=agree,
               f32_peaks_equal=peaks_equal, bf16_vs_f32_token_agreement=agree_bf16,
               serve_3_batches_s=serve_s)

    # ---- throughput: B=64 x 15 s, half the rows at 12 s (bench.py)
    B, N = 64, 15 * FS
    lens = np.full((B,), N, np.int64)
    lens[1::2] = int(N * 0.8)
    base = waveform(np.random.default_rng(0), N, 300.0)
    wav = np.stack([base * (np.arange(N) < n) for n in lens]).astype(np.float32)
    wav_d = torch.from_numpy(wav).cuda()
    lens_d = torch.from_numpy(lens.astype(np.int32)).cuda()
    max_tokens = engine._max_tokens(N)
    ms = cuda_ms(lambda: engine.run(wav_d, lens_d, max_tokens), iters=5)
    audio_s = float(lens.sum()) / FS
    wavs = [w[:n] for w, n in zip(wav, lens)]
    t0 = time.time()
    engine.transcribe(wavs)
    host_s = time.time() - t0
    e2e.update(batch_ms=ms, audio_s_per_s=audio_s / (ms / 1e3),
               transcribe_b64_s=host_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"e2e bf16 B=64 x 15 s (bench.py shape): device program {ms:.2f} ms "
        f"-> {audio_s / (ms / 1e3):.1f} audio-s/s on {card}; transcribe() "
        f"incl. host {host_s * 1e3:.1f} ms")
    if profile_dir:
        e2e["profile"] = profile(torch, lambda: engine.run(wav_d, lens_d, max_tokens),
                                 profile_dir, ms, "profile_e2e.txt")
    shared.update(f32_state=f32.state_dict(), tok=tok, batches=batches,
                  engine_bf16=engine, b64=(wav_d, lens_d, max_tokens, audio_s))
    return launches, e2e


def end_to_end_int8(torch, FK, A, profile_dir, card, shared):
    """int8 Paraformer-large (``quantize=True``) on the same random weights:
    three served batches with the launch counters read, kernels against
    twins, and the B=64 x 15 s device program beside the bf16 one."""
    from funasr_torch.auto.engines import FrontendConfig, ParaformerEngine
    from funasr_torch.models.paraformer.model import Paraformer
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL

    t0 = time.time()
    model = Paraformer(**FLAGSHIP, dtype=torch.bfloat16, quantize=True)
    model.load_state_dict(shared["f32_state"], strict=True)
    model.quantize_weights()
    engine = ParaformerEngine(model, FrontendConfig(), shared["tok"])
    batches = shared["batches"]
    log(f"e2e int8: model built and quantized in {time.time() - t0:.1f} s")
    engine.transcribe(batches[0][:2])  # warm-up
    torch.cuda.synchronize()

    # ---- the int8 main path: counters at 0 just before, read just after
    counters = {"fbank": FK.fused_fbank, "attention": A.fused_attention,
                "sanm_layer": SL.fused_sanm_layer,
                "decoder_layer": DL.fused_decoder_layer, "ffn": FF.fused_ffn_int8,
                "int8_gemm": G.int8_gemm, "int8_gemm_rq": G.int8_gemm_rq,
                "rowquant": RQ.rowquant, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln,
                "qmm": QM.quant_matmul}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    results = [engine.transcribe(b) for b in batches]
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"e2e int8: served {sum(map(len, batches))} requests in 3 batches in "
        f"{serve_s:.3f} s; kernel launches {launches}")
    # per batch: the layers' building blocks by their plans
    # (layer_launches), and the QDense projections that pass the gate each a
    # rowquant ("div") and an int8 GEMM; qmm never
    want = dict.fromkeys(counters, 0)
    for b in batches:
        n_qdense = qdense_gated(Q, served_shape(engine, b))
        per = layer_launches()
        per["int8_gemm"] += n_qdense
        per["rowquant"] += n_qdense
        for name, n in (("fbank", 1), ("attention", 1), ("ffn", 1), ("sanm_layer", 49),
                        ("decoder_layer", 16), *per.items()):
            want[name] += n
    check(launches == want, f"int8 path launches {launches}, want {want}")
    for batch, res in zip(batches, results):
        check(len(res) == len(batch) and all(isinstance(r.get("text"), str)
                                             for r in res), "int8 results")

    # ---- kernels against twins on the same weights
    b = batches[1]
    wav_d, lens_d = engine._pack(b)
    max_tokens = engine._max_tokens(wav_d.shape[1])

    def logits(eng):
        feats, flens = eng.frontend.device_features(wav_d, lens_d)
        return eng.module.inference_logits(feats, flens, max_tokens=max_tokens)

    lp_k, tl_k, pred_k = logits(engine)
    with int8_twins():
        lp_r, tl_r, pred_r = logits(engine)
    with int8_twins(), plain_twins(FK, A):
        lp_a, tl_a, _ = logits(engine)
    lp_b, tl_b, _ = logits(shared["engine_bf16"])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lp_k).all()), "int8 log-probs finite")
    check(lp_k.shape == (len(b), max_tokens, FLAGSHIP["vocab_size"]),
          f"int8 log-prob shape {tuple(lp_k.shape)}")
    check(torch.equal(tl_k, tl_r), f"int8 token lengths kernels {tl_k.tolist()} "
          f"vs twins {tl_r.tolist()}")
    valid = torch.arange(max_tokens, device="cuda")[None] < tl_k[:, None]
    logp_err = float((lp_k - lp_r).abs()[valid].max())
    agree = float((lp_k.argmax(-1) == lp_r.argmax(-1))[valid].float().mean())
    both = valid & (torch.arange(max_tokens, device="cuda")[None] < tl_a[:, None])
    agree_all = float((lp_k.argmax(-1) == lp_a.argmax(-1))[both].float().mean())
    both = valid & (torch.arange(max_tokens, device="cuda")[None] < tl_b[:, None])
    agree_bf16 = float((lp_k.argmax(-1) == lp_b.argmax(-1))[both].float().mean())
    log(f"e2e int8 kernels vs twins: max |dlogp| {logp_err:.3e} (tol "
        f"{E2E_INT8_LOGP_TOL}), token agreement {agree:.5f}, peaks equal "
        f"{bool(torch.equal(pred_k.peaks, pred_r.peaks))}; with the fbank and "
        f"attention twins too: token agreement {agree_all:.5f}, token lengths "
        f"equal {bool(torch.equal(tl_k, tl_a))}; int8 vs bf16 token agreement "
        f"{agree_bf16:.5f}, token lengths equal {bool(torch.equal(tl_k, tl_b))}")
    check(logp_err <= E2E_INT8_LOGP_TOL, "int8 log-probs kernels vs twins")
    check(agree >= E2E_INT8_MIN_AGREE, "int8 token agreement kernels vs twins")
    e2e = dict(int8_logp_max_abs_diff=logp_err, int8_token_agreement=agree,
               int8_peaks_equal=bool(torch.equal(pred_k.peaks, pred_r.peaks)),
               int8_vs_all_twins_token_agreement=agree_all,
               int8_vs_bf16_token_agreement=agree_bf16,
               int8_serve_3_batches_s=serve_s)

    # ---- B=64 x 15 s: int8 and bf16 device programs in turns
    wav64, lens64, mt64, audio_s = shared["b64"]
    times = {}
    engines = {"bf16": shared["engine_bf16"], "int8": engine}
    for name in ("bf16", "int8", "int8", "bf16"):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: engines[name].run(wav64, lens64, mt64), iters=5)
        times.setdefault(name, []).append(ms)
        e2e[f"{name}_activation_peak_gb"] = (torch.cuda.max_memory_allocated()
                                             - base) / 1e9
    e2e["all_models_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    for name, ts in times.items():
        e2e[f"{name}_batch_ms"] = ts
        e2e[f"{name}_audio_s_per_s"] = audio_s / (min(ts) / 1e3)
    log(f"e2e B=64 x 15 s device program on {card}: bf16 {times['bf16']} ms, "
        f"int8 {times['int8']} ms (runs in turns bf16, int8, int8, bf16)")
    if profile_dir:
        e2e["profile_int8"] = profile(torch, lambda: engine.run(wav64, lens64, mt64),
                                      profile_dir, min(times["int8"]),
                                      "profile_e2e_int8.txt")
        check(e2e["profile_int8"]["aten::round calls"] == 1,
              "int8 batch: the token count is the only round (weights are "
              "quantized once per model load, not per batch)")
    return launches, e2e


def padded_frames(n_samples: int) -> int:
    """Fbank frames of a batch padded to ``n_samples``: the bucket, padded to
    a multiple of 128 (no LFR)."""
    from funasr_torch.auto.engines import quantize

    return -(-((quantize(n_samples) - 400) // 160 + 1) // 128) * 128


def encoder_frames(n_samples: int) -> int:
    """Encoder frames of a batch padded to ``n_samples``: the bucket, fbank
    frames padded to a multiple of 128, then two stride-2 3x3 convs."""
    t = padded_frames(n_samples)
    return ((t - 3) // 2 + 1 - 3) // 2 + 1


def beam_engine(torch):
    """The full-width Conformer of ``configs/conformer_hybrid.yaml`` on seeded
    random weights: (the float32 model, the served ``HybridEngine``: bf16,
    int8 weights and KV cache, ``BEAM_SERVING``)."""
    from funasr_torch.auto.engines import FrontendConfig, HybridEngine
    from funasr_torch.models.paraformer.model import init_random_
    from funasr_torch.models.transformer.model import Conformer
    from funasr_torch.tokenizer.char_tokenizer import CharTokenizer

    f32 = Conformer(**CONFORMER_HYBRID, dtype=torch.float32)
    init_random_(f32, torch.Generator(device="cuda").manual_seed(2025))
    served = Conformer(**CONFORMER_HYBRID, dtype=torch.bfloat16, quantize=True)
    served.load_state_dict(f32.state_dict(), strict=True)
    served.quantize_weights()
    V = CONFORMER_HYBRID["vocab_size"]
    tok = CharTokenizer(["<blank>", "<s>", "</s>"]
                        + [chr(0x4E00 + i) for i in range(V - 4)] + ["<unk>"])
    frontend = FrontendConfig(n_mels=80, lfr_m=1, lfr_n=1)
    return f32, HybridEngine(served, frontend, tok, **BEAM_SERVING)


def end_to_end_beam(torch, FK, CP, profile_dir, card, shared):
    """Conformer CTC/attention beam serving (``HybridEngine``) at full width
    on seeded random weights: three served batches with the launch counters
    read, the float32 beam with the CTC kernel against its twin, and the
    B=32 x 15 s batch of ``bench_beam.py`` timed and profiled."""
    import numpy as np

    from funasr_torch.auto.engines import HybridEngine
    from funasr_torch.ops import attention as A
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL

    t0 = time.time()
    f32, engine = beam_engine(torch)
    frontend, tok = engine.frontend, engine.tokenizer
    n_params = sum(p.numel() for p in f32.parameters())
    log(f"e2e beam: Conformer hybrid {n_params / 1e6:.1f} M params built and "
        f"quantized in {time.time() - t0:.1f} s; serving {BEAM_SERVING}")
    batches = shared["batches"]
    engine.transcribe(batches[0][:2])  # warm-up
    torch.cuda.synchronize()

    # ---- the beam main path: counters at 0 just before, read just after
    counters = {"ctc_prefix_step": CP.ctc_prefix_step, "ctc_prefix": CP.ctc_recurrence,
                "fbank": FK.fused_fbank,
                "int8_gemm": G.int8_gemm, "rowquant": RQ.rowquant,
                # Paraformer kernels, off this path
                "attention": A.fused_attention, "sanm_layer": SL.fused_sanm_layer,
                "decoder_layer": DL.fused_decoder_layer, "ffn": FF.fused_ffn_int8,
                "int8_gemm_rq": G.int8_gemm_rq, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln}
    for fn in counters.values():
        fn.launches = 0
    engine.steps = 0
    t0 = time.time()
    results = [engine.transcribe(b, nbest=3 if i == 2 else 1)
               for i, b in enumerate(batches)]
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = engine.steps
    log(f"e2e beam: served {sum(map(len, batches))} requests in 3 batches in "
        f"{serve_s:.3f} s, {steps} decode steps; kernel launches {launches}")
    check(steps > 0 and launches["ctc_prefix_step"] == steps and not launches["ctc_prefix"],
          f"ctc prefix step kernel launched once per decode step, the recurrence entry "
          f"never: {launches['ctc_prefix_step']} and {launches['ctc_prefix']} launches, "
          f"{steps} steps")
    check(launches["fbank"] == len(batches), "fbank kernel launched per batch")
    check(not any(launches[k] for k in ("attention", "sanm_layer", "decoder_layer", "ffn",
                                        "int8_gemm_rq", "fsmn", "fsmn_ln")),
          f"no Paraformer kernel on the beam path: {launches}")
    # 24 FFN w_1 per batch (12 layers x 2 FFNs) pass the int8 gate when the
    # batch has >= MIN_M encoder frames
    n_ffn = 2 * CONFORMER_HYBRID["encoder_conf"]["num_blocks"]
    want_int8 = sum(n_ffn for b in batches if Q.gate(
        len(b) * encoder_frames(max(len(w) for w in b)),
        CONFORMER_HYBRID["encoder_conf"]["linear_units"]))
    check(want_int8 > 0 and launches["int8_gemm"] == want_int8
          and launches["rowquant"] == want_int8,
          f"int8 GEMM and rowquant launched for every gated FFN w_1: {launches}, "
          f"want {want_int8}")
    for batch, res in zip(batches, results):
        check(len(res) == len(batch) and all(isinstance(r.get("text"), str)
                                             for r in res), "beam results have texts")
    for r in results[2]:
        scores = [h["score"] for h in r["nbest"]]
        check(len(scores) == 3 and scores == sorted(scores, reverse=True)
              and all(np.isfinite(scores)), f"nbest=3 sorted: {scores}")
    log(f"e2e beam: sample texts {[r['text'][:12] for r in results[0][:3]]}, "
        f"nbest scores {[h['score'] for h in results[2][0]['nbest']]}")

    # ---- float32 beam: CTC kernel against its twin on the same inputs
    engine32 = HybridEngine(f32, frontend, tok, **dict(BEAM_SERVING, int8_kv=False))
    wav_d, lens_d = engine32._pack(batches[2])
    res_k = engine32.run(wav_d, lens_d)
    with swapped([(CP, "ctc_prefix_step", CP.ctc_prefix_step_ref)]):
        res_r = engine32.run(wav_d, lens_d)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(res_k.scores).all()), "float32 beam scores finite")
    d_score = float((res_k.scores - res_r.scores).abs().max())
    same = dict(tokens=bool(torch.equal(res_k.tokens, res_r.tokens)),
                lengths=bool(torch.equal(res_k.lengths, res_r.lengths)),
                scores=bool(torch.equal(res_k.scores, res_r.scores)))
    log(f"e2e beam float32, CTC kernel vs twin ({len(batches[2])} requests, "
        f"{res_k.steps} steps): equal {same}, max |dscore| {d_score:.3e} "
        f"(tol {BEAM_F32_SCORE_TOL})")
    check(same["tokens"] and same["lengths"] and res_k.steps == res_r.steps,
          "float32 beam: tokens and lengths with the CTC kernel equal the twin's")
    check(d_score <= BEAM_F32_SCORE_TOL, "float32 beam scores, CTC kernel vs twin")
    e2e = dict(beam_launches=launches, beam_steps_3_batches=steps,
               beam_serve_3_batches_s=serve_s, beam_f32_equal=same,
               beam_f32_max_abs_dscore=d_score)
    del engine32, res_k, res_r

    # ---- B=32 x 15 s (bench_beam.py's headline batch)
    B, N = 32, 15 * FS
    rng = np.random.default_rng(1)
    wavs = [waveform(rng, N, 150.0 + 7 * i) for i in range(B)]
    wav_d, lens_d = engine._pack(wavs)
    torch.cuda.reset_peak_memory_stats()
    # host-bound (one sync per step), so each batch is timed on its own
    times = [cuda_ms(lambda: engine.run(wav_d, lens_d), iters=1, warmup=2 if i == 0 else 0)
             for i in range(5)]
    ms = sum(times) / len(times)
    res = engine.run(wav_d, lens_d)
    t0 = time.time()
    engine.transcribe(wavs)
    host_ms = (time.time() - t0) * 1e3
    audio_s = B * N / FS
    e2e.update(beam_batch_ms=ms, beam_batch_ms_each=times,
               beam_audio_s_per_s=audio_s / (ms / 1e3),
               beam_b32_steps=res.steps, beam_ms_per_step=ms / max(res.steps, 1),
               beam_transcribe_b32_host_ms=host_ms,
               beam_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    prof = profile(torch, lambda: engine.run(wav_d, lens_d), profile_dir, ms,
                   "profile_beam.txt")
    prof["ctc prefix kernel share of kernel time"] = (
        prof.get("ctc prefix kernel", 0.0) / prof["kernels total"])
    prof["kernel launches per decode step"] = prof["kernel launches"] / max(res.steps, 1)
    e2e["profile_beam"] = prof
    log(f"e2e beam B=32 x 15 s on {card}: {ms:.2f} ms per batch (CUDA events, mean "
        f"of 5 batches after 2 warm-ups: {[round(t, 1) for t in times]}) -> "
        f"{audio_s / (ms / 1e3):.1f} audio-s/s, "
        f"{res.steps} decode steps ({ms / max(res.steps, 1):.3f} ms per step, "
        f"{prof['kernel launches per decode step']:.1f} kernel launches per step); "
        f"device kernels {prof['kernels total']:.2f} ms of it; transcribe() incl. "
        f"host {host_ms:.1f} ms")
    return launches, e2e


def route_twins():
    """The BiCif routes' twins: the fused int8 matmul and the int8-score
    attention."""
    from funasr_torch.ops import attention as A
    from funasr_torch.ops import qmm as QM

    return swapped([(QM, "quant_matmul", QM.quant_matmul_ref),
                    (A, "attention_i8qk", A.attention_i8qk_ref)])


def served_shape(engine, wavs):
    """(B, encoder frames T, token grid U) of one served batch: the bucket,
    fbank frames, LFR by 6, padded to a multiple of 128."""
    from funasr_torch.auto.engines import quantize

    n = quantize(max(len(w) for w in wavs))
    lfr = -(-((n - 400) // 160 + 1) // 6)
    return len(wavs), -(-lfr // 128) * 128, engine._max_tokens(n)


def layer_launches():
    """Launches of each building-block kernel per batch from the int8 layers
    (49 SANM layers, 16 decoder layers, one FFN): a SANM layer makes three
    rowquant + int8 GEMM pairs (QKV, w1, w2) and one int8_gemm_rq (wout
    with the FSMN); a decoder layer four pairs (w1, w2, wq, wout), the int8
    GEMM on the memory (which the stack row-quantizes once) and one
    fsmn_ln; the FFN two pairs."""
    return {"int8_gemm_rq": 49, "rowquant": 49 * 3 + 16 * 4 + 1 + 2,
            "int8_gemm": 49 * 3 + 16 * 5 + 2, "fsmn": 0, "fsmn_ln": 16}


def qdense_gated(Q, shape, D=512, H=2048):
    """The QDense contractions off the fused layers that pass the int8 gate
    for a served (B, T, U): encoders0's QKV and out projections,
    decoders3's w_1 and w_2, the output layer."""
    B, T, U = shape
    V = FLAGSHIP["vocab_size"]
    return sum(Q.gate(m, n) for m, n in ((B * T, 3 * D), (B * T, D), (B * U, H), (B * U, D),
                                         (B * U, V)))


def exact_attention_launches(A, B, U, T, n_head=4):
    """Launches of an int8 layer's attention for B rows, by the wrapper's own
    rule (``exact_attention_plan``): one while the scores stay on chip."""
    return A.exact_attention_plan(B, n_head, U, T)[1]


def end_to_end_bicif(torch, FK, A, profile_dir, card, shared):
    """int8 BiCif Paraformer-large with 20 ms timestamps and both opt-in
    routes (``qmm``, ``int8_attn``) on seeded random weights: three served
    batches with the launch counters read, route kernels and float32
    kernels against twins, the shared-fbank path against sliced waveforms,
    one "cnn_blstm" batch, and the B=64 x 15 s program with the routes on
    and off."""
    import numpy as np

    from funasr_torch.auto.engines import BiCifEngine, FrontendConfig
    from funasr_torch.models.bicif_paraformer.model import BiCifParaformer
    from funasr_torch.models.paraformer.model import init_random_
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL

    t0 = time.time()
    f32 = BiCifParaformer(**FLAGSHIP, dtype=torch.float32)
    init_random_(f32, torch.Generator(device="cuda").manual_seed(2026))

    def int8_model(routes, state=f32.state_dict(), conf=FLAGSHIP):
        model = BiCifParaformer(**conf, dtype=torch.bfloat16, quantize=True, qmm=routes,
                                int8_attn=routes)
        model.load_state_dict(state, strict=True)
        return model.quantize_weights()

    tok, fe, batches = shared["tok"], FrontendConfig(), shared["batches"]
    engine = BiCifEngine(int8_model(True), fe, tok)
    log(f"e2e bicif: BiCif Paraformer-large float32 and int8 (qmm, int8_attn) built in "
        f"{time.time() - t0:.1f} s")
    engine.transcribe(batches[0][:2])  # warm-up
    torch.cuda.synchronize()

    # ---- the BiCif main path: counters at 0 just before, read just after
    counters = {"fbank": FK.fused_fbank, "attention": A.fused_attention,
                "sanm_layer": SL.fused_sanm_layer, "decoder_layer": DL.fused_decoder_layer,
                "ffn": FF.fused_ffn_int8, "qmm": QM.quant_matmul,
                "attention_i8qk": A.attention_i8qk, "attention_f32ctx": A.attention_f32ctx,
                "ffn_bf16": FF.fused_ffn, "int8_gemm": G.int8_gemm, "rowquant": RQ.rowquant,
                "int8_gemm_rq": G.int8_gemm_rq, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    results = [engine.transcribe(b) for b in batches]
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"e2e bicif: served {sum(map(len, batches))} requests with timestamps in 3 "
        f"batches in {serve_s:.3f} s; kernel launches {launches}")
    D, V = 512, FLAGSHIP["vocab_size"]
    want = dict.fromkeys(counters, 0)
    for b in batches:
        B, T, U = served_shape(engine, b)
        # the int8 layer chains as on the int8 path; the gated QDense
        # projections through qmm
        for name, n in (("fbank", 1), ("attention", 1), ("ffn", 1), ("sanm_layer", 49),
                        ("decoder_layer", 16), *layer_launches().items()):
            want[name] += n
        want["qmm"] += qdense_gated(Q, (B, T, U))
        want["attention_i8qk"] += 49 * exact_attention_launches(A, B, T, T)
        want["attention_f32ctx"] += 16 * exact_attention_launches(A, B, U, T)  # decoder only
    check(want["qmm"] > 0 and launches == want,
          f"bicif path launches {launches}, want {want}")
    for batch, res in zip(batches, results):
        check(len(res) == len(batch), "one result per request")
        for r in res:
            starts = [b for b, _ in r["timestamp"]]
            check(isinstance(r.get("text"), str)
                  and len(r["timestamp"]) == len(r["raw_tokens"])
                  and starts == sorted(starts) and all(b <= e for b, e in r["timestamp"]),
                  f"bicif result: a timestamp per kept token, starts non-decreasing: {r}")
    log(f"e2e bicif: sample {results[0][0]['text'][:8]} {results[0][0]['timestamp'][:3]}")

    # ---- route kernels against their twins on the same weights
    b = batches[1]
    wav_d, lens_d = engine._pack(b)
    max_tokens = engine._max_tokens(wav_d.shape[1])

    def logits(eng):
        feats, flens = eng.frontend.device_features(wav_d, lens_d)
        return eng.module.inference_logits(feats, flens, max_tokens=max_tokens)

    lp_k, tl_k, pred_k = logits(engine)
    served_k = engine.transcribe(b)
    with int8_twins(), route_twins():
        lp_r, tl_r, pred_r = logits(engine)
        served_r = engine.transcribe(b)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lp_k).all()) and lp_k.shape == (len(b), max_tokens, V),
          f"bicif log-probs finite, shape {tuple(lp_k.shape)}")
    valid = torch.arange(max_tokens, device="cuda")[None] < tl_k[:, None]
    logp_err = float((lp_k - lp_r).abs()[valid].max())
    agree = float((lp_k.argmax(-1) == lp_r.argmax(-1))[valid].float().mean())
    same = dict(token_lengths=bool(torch.equal(tl_k, tl_r)),
                peaks=bool(torch.equal(pred_k.base.peaks, pred_r.base.peaks)),
                us_peaks=bool(torch.equal(pred_k.us_peaks, pred_r.us_peaks)),
                timestamps=served_k == served_r)
    log(f"e2e bicif int8 routes, kernels vs twins: max |dlogp| {logp_err:.3e} (tol "
        f"{E2E_INT8_LOGP_TOL}), token agreement {agree:.5f}, equal {same}")
    check(logp_err <= E2E_INT8_LOGP_TOL and agree >= E2E_INT8_MIN_AGREE and all(same.values()),
          "bicif int8 routes: kernels against twins")
    e2e = dict(bicif_launches=launches, bicif_serve_3_batches_s=serve_s,
               bicif_int8_logp_max_abs_diff=logp_err, bicif_int8_token_agreement=agree,
               bicif_int8_equal=same)

    # ---- float32 BiCif: the fbank and attention kernels against twins
    engine32 = BiCifEngine(f32, fe, tok)
    out_k, served_k = engine32.run_ts(wav_d, lens_d, max_tokens), engine32.transcribe(b)
    with plain_twins(FK, A):
        out_r, served_r = engine32.run_ts(wav_d, lens_d, max_tokens), engine32.transcribe(b)
    torch.cuda.synchronize()
    tok_valid = torch.arange(max_tokens, device="cuda")[None] < out_k[1][:, None]
    same32 = dict(token_lengths=bool(torch.equal(out_k[1], out_r[1])),
                  tokens=bool(torch.equal(out_k[0][tok_valid], out_r[0][tok_valid])),
                  us_peaks=bool(torch.equal(out_k[3], out_r[3])),
                  timestamps=served_k == served_r)
    log(f"e2e bicif float32, kernels vs twins: equal {same32}, max |d us_alphas| "
        f"{float((out_k[2] - out_r[2]).abs().max()):.3e}")
    check(all(same32.values()), "bicif float32: kernels against twins")
    e2e["bicif_f32_equal"] = same32
    del engine32, out_k, out_r

    # ---- five segments of a 60 s recording from one shared fbank grid
    rec = waveform(np.random.default_rng(3), 60 * FS, 210.0)
    raw, n_frames = engine.frontend.raw_fbank(
        torch.from_numpy(rec).cuda()[None], torch.tensor([len(rec)], device="cuda"))
    segments = [[1230, 7010], [8000, 12500], [15020, 22500], [30000, 33330], [45670, 52000]]
    offsets = [s for s, _ in segments]
    from_grid = engine.transcribe_from_fbank(raw[0], segments, vad_offsets=offsets,
                                             total_frames=int(n_frames[0]))
    sliced = engine.transcribe([rec[s * 16:e * 16] for s, e in segments], vad_offsets=offsets)
    log(f"e2e bicif transcribe_from_fbank on a 60 s grid, 5 segments: equal to "
        f"transcribe of the sliced waveforms {from_grid == sliced}")
    check(from_grid == sliced and all(r["text"] for r in from_grid),
          "bicif transcribe_from_fbank equals transcribe of the sliced waveforms")
    e2e["bicif_from_fbank_equal"] = True

    # ---- the published "cnn_blstm" head: one served batch
    conf = dict(FLAGSHIP, predictor_conf=dict(FLAGSHIP["predictor_conf"],
                                              upsample_type="cnn_blstm"))
    blstm = BiCifParaformer(**conf, dtype=torch.float32)
    init_random_(blstm, torch.Generator(device="cuda").manual_seed(2027))
    blstm_engine = BiCifEngine(int8_model(True, blstm.state_dict(), conf), fe, tok)
    res = blstm_engine.transcribe(batches[2])
    check(len(res) == len(batches[2]) and all(
        r["text"] and len(r["timestamp"]) == len(r["raw_tokens"]) for r in res),
        "cnn_blstm BiCif served with timestamps")
    log(f"e2e bicif cnn_blstm: served {len(res)} requests, sample "
        f"{res[0]['text'][:8]} {res[0]['timestamp'][:3]}")
    del blstm, blstm_engine

    # ---- B=64 x 15 s: the routes off (the int8 layer chain alone) and on, in turns
    off = BiCifEngine(int8_model(False), fe, tok)
    wav64, lens64, mt64, audio_s = shared["b64"]
    engines = {"off": off, "on": engine}
    times = {}
    for name in ("off", "on", "on", "off"):
        times.setdefault(name, []).append(
            cuda_ms(lambda: engines[name].run_ts(wav64, lens64, mt64), iters=5))
    for name, ts in times.items():
        e2e[f"bicif_routes_{name}_batch_ms"] = ts
        e2e[f"bicif_routes_{name}_audio_s_per_s"] = audio_s / (min(ts) / 1e3)
    log(f"e2e bicif B=64 x 15 s device program on {card}: routes off {times['off']} ms, "
        f"routes on {times['on']} ms (in turns off, on, on, off)")
    if profile_dir:
        for name in ("on", "off"):
            e2e[f"profile_bicif_{name}"] = profile(
                torch, lambda: engines[name].run_ts(wav64, lens64, mt64), profile_dir,
                min(times[name]), f"profile_bicif_{name}.txt")
    return launches, e2e


# ------------------------------------------------------------ the pipeline
PIPELINE_AUDIO_S = 600  # one recording, as bench_pipeline.py
FSMN_VAD = dict(  # configs/fsmn_vad.yaml
    model="FsmnVADStreaming",
    model_conf=dict(sample_rate=16000, detect_mode=1, max_end_silence_time=800,
                    max_start_silence_time=3000, window_size_ms=200,
                    speech_to_sil_time_thres=150, speech_noise_thres=0.6),
    encoder="FSMN",
    encoder_conf=dict(input_dim=400, input_affine_dim=140, fsmn_layers=4, linear_dim=250,
                      proj_dim=128, lorder=20, rorder=0, lstride=1, rstride=1,
                      output_affine_dim=140, output_dim=248),
    frontend_conf=dict(fs=16000, n_mels=80, lfr_m=5, lfr_n=1))
CT_PUNC = dict(  # configs/ct_transformer_punc.yaml
    model="CTTransformer", vocab_size=272727,
    punc_list=["<unk>", "_", "，", "。", "？", "、"], embed_unit=256, att_unit=256,
    encoder="SANMEncoder",
    encoder_conf=dict(output_size=256, attention_heads=8, linear_units=1024, num_blocks=4,
                      kernel_size=11))
# VAD posteriors with the fbank kernel against the fbank twin (whose log-mel
# sits within FBANK_TOL of the kernel's), abs: the float32 scorer moves a
# posterior by at most about a quarter of its logits' change
VAD_POST_TOL = 5e-3
PUNC_MIN_AGREE = 0.99  # punctuation labels, d = 32 attention kernel vs its twin


def pipeline_configs():
    """The pipeline's three configs as dicts (the card has no YAML package):
    int8 BiCif Paraformer-large (configs/paraformer_large.yaml with
    ``CifPredictorV3``, as bench_pipeline.py builds it; a single-CJK-char
    vocabulary, so punctuation re-tokenizes the text one token a char), the
    FSMN-VAD of configs/fsmn_vad.yaml and the CT-Transformer of
    configs/ct_transformer_punc.yaml (vocab 272727, D = 256, 8 heads)."""
    V = FLAGSHIP["vocab_size"]
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(V - 3)]
    asr = dict(model="BiCifParaformer", predictor="CifPredictorV3", vocab_size=V,
               input_size=FLAGSHIP["input_size"], encoder_conf=FLAGSHIP["encoder_conf"],
               decoder_conf=FLAGSHIP["decoder_conf"],
               predictor_conf=FLAGSHIP["predictor_conf"],
               model_conf={k: FLAGSHIP[k] for k in ("lsm_weight", "length_normalized_loss",
                                                    "predictor_weight", "predictor_bias",
                                                    "sampling_ratio")},
               frontend_conf=dict(fs=FS, n_mels=80, lfr_m=7, lfr_n=6, window="hamming"),
               tokenizer_conf=dict(token_list=tokens))
    punc = dict(CT_PUNC, tokenizer_conf=dict(token_list=tokens))
    return asr, FSMN_VAD, punc


def pipeline_recording(rng, seconds=PIPELINE_AUDIO_S, two_voices=False):
    """A 600 s (``seconds``), 16 kHz recording as bench_pipeline.py draws its
    segment plan: bursts of a 260 Hz sine over noise, 2-12 s long (the sixth
    20 s), 0.3-0.8 s gaps of faint noise alone, boundaries on 10 ms.
    ``two_voices``: the same plan and noise, the bursts alternately a 260 Hz
    sine under a 4 Hz swell and a glide of 200 +- 80 Hz at 1.5 Hz, two
    "speakers" whose fbank varies over time (each speaker chunk's mean is
    taken out before CAM++, so a steady tone alone would tell nothing).
    Returns (waveform, the bursts as [start_ms, end_ms])."""
    import numpy as np

    n = seconds * FS
    wav = 0.002 * rng.standard_normal(n)
    plan, t = [], 0.3
    while t < seconds - 2.0:
        dur = 20.0 if len(plan) == 5 else float(rng.uniform(2.0, 12.0))
        end = min(t + dur, seconds - 0.1)
        seg = [int(t * 100) * 10, int(end * 100) * 10]
        i0, i1 = seg[0] * FS // 1000, seg[1] * FS // 1000
        ts = np.arange(i1 - i0) / FS
        if not two_voices:
            voice = np.sin(2 * np.pi * 260 * np.arange(i1 - i0) / FS)
        elif len(plan) % 2 == 0:
            voice = (0.6 + 0.4 * np.sin(2 * np.pi * 4 * ts)) * np.sin(2 * np.pi * 260 * ts)
        else:
            voice = np.sin(2 * np.pi * np.cumsum(200 + 80 * np.sin(2 * np.pi * 1.5 * ts)) / FS)
        wav[i0:i1] += 0.1 * voice + 0.02 * rng.standard_normal(i1 - i0)
        plan.append(seg)
        t = end + float(rng.uniform(0.3, 0.8))
    return wav.astype(np.float32), plan


def pipeline_batch_shapes(am, segments, total_frames):
    """(B, T, U) of each ASR batch of the shared-grid path: the segment
    batches of ``AutoModel.batches``, each's frames padded to 96, LFR by 6,
    padded to 128, and its token budget."""
    eng, shapes = am.engine, []
    for batch in am.batches(segments, FS, 300):
        _, nframes = eng.pack_segments_frames([segments[i] for i in batch], total_frames)
        fmax = eng.quantize_frames(int(nframes.max()))
        T = -(-(-(-fmax // 6)) // 128) * 128
        shapes.append((len(batch), T, eng._max_tokens(int(nframes.max()) * 160 + 240)))
    return shapes


def check_attention_d32(torch, A, B, T=208):
    """The head-size-32 attention at punctuation's shape (B windows, T <= 208
    tokens padded to a multiple of 8, 8 heads, D = 256) and edges (T = 1,
    ragged lengths, a length of 0), bf16 and float32, against the twin; the
    main shape timed beside SDPA with its bound."""
    import torch.nn.functional as F

    H, d = 8, 32
    D = H * d
    gen = torch.Generator(device="cuda").manual_seed(32)
    cases = []
    for b, t, name in ((B, T, "punctuation windows"), (3, 1, "T=1"),
                       (5, 45, "ragged"), (4, 130, "ragged, a length of 0")):
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        lens[0] = t
        if name.endswith("of 0"):
            lens[-1] = 0
        bias = (1.0 - (torch.arange(t, device="cuda")[None] < lens[:, None]).float()) * -1e30
        for dtype in (torch.bfloat16, torch.float32):
            dn = "bfloat16" if dtype == torch.bfloat16 else "float32"
            qkv = torch.randn((b, t, 3 * D), generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.split(D, dim=-1)
            q = q * d ** -0.5
            got = A.fused_attention(q, k, v, bias, H)
            want = A.attention_ref(q, k, v, bias, H)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL[dn],
                  f"attention d=32 {name} B={b} T={t} {dn}: err {err} > {ATTN_TOL[dn]}")
            case = dict(case=f"d=32 {name} q/k/v ({b},{t},{D}) {dn}, H=8", max_abs_err=err,
                        tolerance=ATTN_TOL[dn])
            if name == "punctuation windows":
                q4, k4, v4 = (x.unflatten(-1, (H, d)).transpose(1, 2) for x in (q, k, v))
                mask = bias[:, None, None, :].to(dtype)
                n_keys = float(lens.sum())
                el = q.element_size()
                bnd, by = bound_ms(el * (2 * b * t * D + 2 * n_keys * D) + 4 * b * t,
                                   {dn: 4.0 * t * D * n_keys})
                case.update(
                    ms=cuda_ms(lambda: A.fused_attention(q, k, v, bias, H), iters=50,
                               warmup=10),
                    graph_ms=graph_ms(lambda: A.fused_attention(q, k, v, bias, H)),
                    plain_ms=cuda_ms(lambda: A.attention_ref(q, k, v, bias, H), iters=5),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask, scale=1.0), iters=50, warmup=10),
                    bound_ms=bnd, bound_by=by)
                if dn == "float32":
                    case["split_tf32_bound_ms"] = split_tf32_bound_ms(4.0 * t * D * n_keys)
            log(f"attention d=32 {case}")
            cases.append(case)
    return cases


class StageClock:
    """Wraps bound methods to time them: wall clock on the host (``wall``)
    and CUDA events around the call (``spans``, read after a synchronize)."""

    def __init__(self, torch):
        self.torch, self.wall, self.spans, self._saved = torch, {}, {}, []

    def wrap(self, obj, name, stage, events=False):
        fn = getattr(obj, name)
        torch = self.torch

        def timed(*a, **k):
            if events:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.wall[stage] = self.wall.get(stage, 0.0) + time.perf_counter() - t0
            if events:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                self.spans.setdefault(stage, []).append((e0, e1))
            return out

        self._saved.append((obj, name, fn))
        setattr(obj, name, timed)

    def device_ms(self, stage, span=False):
        """Summed event time of a stage's calls, or (``span``) first start
        to last end."""
        ev = self.spans.get(stage, [])
        if not ev:
            return 0.0
        if span:
            return ev[0][0].elapsed_time(ev[-1][1])
        return sum(a.elapsed_time(b) for a, b in ev)

    def restore(self):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved.clear()


def end_to_end_pipeline(torch, FK, A, profile_dir, card):
    """The long-audio pipeline on the card: ``AutoModel(model=BiCif,
    vad_model=FSMN-VAD, punc_model=CT-Transformer, quantize=True).generate``
    of a 600 s recording, at full width on seeded random weights.  (a) as it
    is, on whatever segments the random VAD finds; (b) with only the state
    machine's output replaced by the recording's burst plan merged to <= 15
    s (random weights make the VAD's decisions meaningless), the fbank and
    the scorer still run.  Each run with every kernel's launch counter set
    to 0 just before and held to its exact count just after; (b) again with
    the int8 layers' twins and punctuation's attention twin, held to phase
    3's BiCif bars and the punctuation bar; the VAD stage with the fbank
    kernel against the fbank twin; the head-size-32 attention at
    punctuation's shape; stage times by CUDA events and wall clock."""
    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL
    from funasr_torch.utils.vad_utils import merge_vad

    t0 = time.time()
    asr_cfg, vad_cfg, punc_cfg = pipeline_configs()
    am = AutoModel(model=asr_cfg, vad_model=vad_cfg, punc_model=punc_cfg, quantize=True,
                   seed=2028)
    eng, ve, pm = am.engine, am.vad_engine, am.punc_engine.model
    n_blocks = CT_PUNC["encoder_conf"]["num_blocks"]
    log(f"e2e pipeline: AutoModel (int8 BiCif, FSMN-VAD, CT-Transformer) built in "
        f"{time.time() - t0:.1f} s")
    wav, bursts = pipeline_recording(np.random.default_rng(12))
    plan = merge_vad(bursts, 15000)
    with guarded_entries(torch, (am.engine, "transcribe_async"), (am.vad_engine, "front")):
        am.warmup(seconds=(2,))  # the first calls, dispatched under the guard
    torch.cuda.synchronize()

    counters = {"fbank": FK.fused_fbank, "attention": A.fused_attention,
                "sanm_layer": SL.fused_sanm_layer, "decoder_layer": DL.fused_decoder_layer,
                "ffn": FF.fused_ffn_int8, "qmm": QM.quant_matmul,
                "attention_i8qk": A.attention_i8qk, "attention_f32ctx": A.attention_f32ctx,
                "ffn_bf16": FF.fused_ffn, "int8_gemm": G.int8_gemm, "rowquant": RQ.rowquant,
                "int8_gemm_rq": G.int8_gemm_rq, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln}
    seen = {}

    def run(name, replace=None, twins=False):
        """One ``generate`` with the counters read; returns (result, launches,
        the punctuation device calls, the segments, per-batch outputs,
        punctuation labels, the clock)."""
        clock = StageClock(torch)
        rounds, outs, labels = [0], [], []
        real_argmax, real_batch = pm._argmax, pm.inference_batch
        real_run = eng.run_ts_fbank

        def counted_argmax(text, lens):
            rounds[0] += 1
            if not twins:
                return real_argmax(text, lens)
            with swapped([(A, "fused_attention", A.attention_ref)]):
                return real_argmax(text, lens)

        def kept_batch(texts, tok):
            res = real_batch(texts, tok)
            labels.extend(r["punc_array"] for r in res)
            return res

        def kept_run(*a):
            out = real_run(*a)
            outs.append([x.clone() for x in out])
            return out

        def dispatch_no_sync(*a, f=eng.transcribe_from_fbank_async):
            torch.cuda.set_sync_debug_mode("error")  # a host sync here raises
            try:
                return f(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        pm._argmax, pm.inference_batch, eng.run_ts_fbank = counted_argmax, kept_batch, kept_run
        eng.transcribe_from_fbank_async = dispatch_no_sync
        real_segs = ve.model.segments_from_posteriors
        segs_seen = []

        def segs(post, db):
            out = real_segs(post, db)
            segs_seen.append(out)
            return replace if replace is not None else out

        ve.model.segments_from_posteriors = segs
        clock.wrap(ve, "front_shared", "vad_device", events=True)
        clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
        clock.wrap(eng, "run_ts_fbank", "asr_device", events=True)
        clock.wrap(eng, "_ts_results", "asr_host")
        clock.wrap(pm, "inference_batch", "punc")
        clock.wrap(pm, "_argmax", "punc_device", events=True)
        for fn in counters.values():
            fn.launches = 0
        A.fused_attention.launches_by_head = dict.fromkeys(A.HEAD_SIZES, 0)
        try:
            stack = int8_twins() if twins else contextlib.nullcontext()
            with stack:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = am.generate(wav, key=[name])[0]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            clock.restore()
            for obj, attr in ((pm, "_argmax"), (pm, "inference_batch"), (eng, "run_ts_fbank"),
                              (eng, "transcribe_from_fbank_async"),
                              (ve.model, "segments_from_posteriors")):
                delattr(obj, attr)
        launches = {k: fn.launches for k, fn in counters.items()}
        launches["attention_d32"] = A.fused_attention.launches_by_head[32]
        times = dict(generate_wall_s=wall, audio_s_per_s=PIPELINE_AUDIO_S / wall,
                     vad_device_ms=clock.device_ms("vad_device"),
                     vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                     asr_device_span_ms=clock.device_ms("asr_device", span=True),
                     asr_device_ms=clock.device_ms("asr_device"),
                     asr_dispatch_wall_s=clock.wall.get("asr_device", 0.0),
                     asr_host_wall_s=clock.wall.get("asr_host", 0.0),
                     punc_wall_s=clock.wall.get("punc", 0.0),
                     punc_device_ms=clock.device_ms("punc_device"),
                     punc_rounds=rounds[0])
        seen[name] = dict(segments=segs_seen[0], times=times)
        return res, launches, rounds[0], outs, labels, times

    def want_launches(segments, rounds):
        """The exact count of every kernel on the path: one fbank launch for
        the recording; per ASR batch the int8 layers' blocks
        (``layer_launches``), the gated QDense contractions (a rowquant and an
        int8 GEMM each, the routes being off), the float32-context attention
        of the 49 encoder and 16 decoder layers, the bf16 attention of
        encoder layer 0 (d = 128); punctuation's d = 32 attention once a
        layer a window round."""
        want = dict.fromkeys(counters, 0)
        want["fbank"] = 1
        shapes = pipeline_batch_shapes(am, segments, total_frames)
        for B, T, U in shapes:
            per = layer_launches()
            n_qdense = qdense_gated(Q, (B, T, U))
            per["int8_gemm"] += n_qdense
            per["rowquant"] += n_qdense
            for k, n in (("attention", 1), ("ffn", 1), ("sanm_layer", 49),
                         ("decoder_layer", 16), *per.items()):
                want[k] += n
            want["attention_f32ctx"] += (49 * exact_attention_launches(A, B, T, T)
                                         + 16 * exact_attention_launches(A, B, U, T))
        want["attention"] += rounds * n_blocks
        want["attention_d32"] = rounds * n_blocks
        return want, shapes

    total_frames = (len(wav) - 400) // 160 + 1
    e2e = {}
    results = {}
    for name, replace in (("a", None), ("b", plan)):
        res, launches, rounds, outs, labels, times = run(name, replace)
        segments = merge_vad(seen[name]["segments"], 15000) if replace is None else plan
        want, shapes = want_launches(segments, rounds)
        log(f"e2e pipeline ({name}): {len(segments)} segments, ASR batches (B, T, U) "
            f"{shapes}, {rounds} punctuation rounds; kernel launches {launches}")
        check(launches == want, f"pipeline ({name}) launches {launches}, want {want}")
        check(isinstance(res.get("text"), str) and res["text"]
              and len(res["timestamp"]) > 0 and res.get("sentence_info"),
              f"pipeline ({name}): text, timestamps and sentence_info")
        ts = res["timestamp"]
        check(all(b <= e for b, e in ts) and all(
            0 <= b and e <= PIPELINE_AUDIO_S * 1000 for b, e in ts),
            f"pipeline ({name}): timestamps within the recording")
        check(all(np.isfinite(np.asarray(o[2].float().cpu())).all() for o in outs),
              f"pipeline ({name}): finite fire tracks")
        log(f"e2e pipeline ({name}) on {card}: {json.dumps(times)}; text "
            f"{res['text'][:24]}... {len(ts)} stamps, {len(res['sentence_info'])} "
            f"sentences")
        e2e[f"pipeline_{name}"] = dict(times, segments=len(segments), batches=shapes,
                                       launches=launches)
        results[name] = (res, launches, outs, labels)

    # ---- (b) again with the twins: int8 layers in ASR, attention in punctuation
    res_t, _, _, outs_t, labels_t, _ = run("b_twins", plan, twins=True)
    res_k, launches_b, outs_k, labels_k = results["b"]
    same = dict(
        token_lengths=all(torch.equal(a[1], b[1]) for a, b in zip(outs_k, outs_t)),
        us_peaks=all(torch.equal(a[3], b[3]) for a, b in zip(outs_k, outs_t)),
        timestamps=res_k["timestamp"] == res_t["timestamp"])
    n_ok = n_all = 0
    for a, b in zip(outs_k, outs_t):
        valid = torch.arange(a[0].shape[1], device="cuda")[None] < a[1][:, None]
        n_ok += int((a[0] == b[0])[valid].sum())
        n_all += int(valid.sum())
    agree = n_ok / max(n_all, 1)
    lk, lt = np.concatenate(labels_k), np.concatenate(labels_t)
    punc_agree = float((lk == lt).mean()) if len(lk) == len(lt) else 0.0
    log(f"e2e pipeline (b), kernels vs twins: equal {same}, token agreement {agree:.5f}, "
        f"punctuation label agreement {punc_agree:.5f} over {len(lk)} labels")
    check(all(same.values()) and agree >= E2E_INT8_MIN_AGREE,
          "pipeline (b): int8 BiCif kernels against twins")
    check(punc_agree >= PUNC_MIN_AGREE, "pipeline (b): punctuation labels, d = 32 "
          "attention kernel against its twin")
    e2e["pipeline_b_twins"] = dict(equal=same, token_agreement=agree,
                                   punc_label_agreement=punc_agree)

    # ---- the VAD stage: the fbank kernel against its twin
    wav_d = torch.from_numpy(wav).cuda()[None]
    lens_d = torch.tensor([len(wav)], device="cuda")
    _, _, post_k, _, db_k = ve.front_shared(wav_d, lens_d)
    with swapped([(FK, "fused_fbank", FK.fbank_ref)]):
        _, _, post_r, _, db_r = ve.front_shared(wav_d, lens_d)
    torch.cuda.synchronize()
    post_err = float((post_k - post_r).abs().max())
    db_err = float((db_k - db_r).abs().max())
    log(f"e2e pipeline VAD stage, fbank kernel vs twin: posteriors max |d| {post_err:.3e} "
        f"(tol {VAD_POST_TOL}), decibels max |d| {db_err:.3e} (tol {FBANK_TOL})")
    check(post_err <= VAD_POST_TOL and db_err <= FBANK_TOL,
          "pipeline VAD stage: posteriors and decibels, kernel against twin")
    e2e["pipeline_vad_post_max_abs_diff"] = post_err
    e2e["pipeline_vad_db_max_abs_diff"] = db_err

    d32_cases = check_attention_d32(torch, A, len(plan))
    if profile_dir:
        ve.model.segments_from_posteriors = lambda post, db: plan
        try:
            e2e["profile_pipeline"] = profile(
                torch, lambda: am.generate(wav), profile_dir,
                e2e["pipeline_b"]["generate_wall_s"] * 1e3, "profile_pipeline.txt")
        finally:
            del ve.model.segments_from_posteriors
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "pipeline.json"), "w") as f:
            json.dump(dict(e2e=e2e, plan=plan, segments_a=seen["a"]["segments"],
                           text_b=res_k["text"], sentence_info_b=res_k["sentence_info"][:20]),
                      f, ensure_ascii=False, indent=1)
    return launches_b, e2e, d32_cases, am


# ------------------------------------------- pipeline run (c): hotwords, speakers
N_HOTWORDS = 10  # run (c)'s hotword list: 10 words of 2-4 tokens
SPK_COS_MIN = 0.999  # each speaker embedding against its twin's, cosine
SEACO_MEMORY_ROWS = (2, 11, 51)  # H + 1: the no-bias row alone, run (c)'s list, 50 words


def seaco_spk_configs():
    """Run (c)'s configs: ``pipeline_configs()``'s BiCif dict as
    SeacoParaformer (Paraformer-large widths and the class's SeACo defaults:
    inner_dim 512, no-bias id 8377, a 3-block bias decoder of 4 heads and
    1024 units; the JAX package carries no SeACo YAML), the FSMN-VAD and
    CT-Transformer of the pipeline, and configs/campplus_diar.yaml's CAM++
    (the published widths: 80 mels in, 192-d embeddings)."""
    asr, vad, punc = pipeline_configs()
    spk = dict(model="CAMPPlus", model_conf=dict(feat_dim=80, embedding_size=192))
    return dict(asr, model="SeacoParaformer"), vad, punc, spk


def hotword_list(rng, tokens, no_bias_id, n=N_HOTWORDS):
    """``n`` words of 2-4 distinct tokens drawn from the vocabulary (not the
    specials, not the no-bias class)."""
    ids = [i for i in range(3, len(tokens)) if i != no_bias_id]
    return ["".join(tokens[i] for i in rng.choice(ids, size=int(rng.integers(2, 5)),
                                                  replace=False)) for _ in range(n)]


def check_seaco_decoder_layer(torch, SL, DL, FF, A, B, U):
    """The int8 decoder layer at the SeACo decoder's shapes (D = 512, 4
    heads, 1024 units, the memory H + 1 hotword rows, the same for every
    batch row, quantized once as the stack does) against its twin, and its
    float32-context attention alone over those keys, bit-equal: H + 1 = 2
    (the no-bias row alone), 11 (run (c)'s list) and 51."""
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops.masks import key_bias

    D, H, K, NH, LEFT = 512, 1024, 11, 4, 5
    _, dec_w, _ = int8_layer_weights(torch, SL, DL, FF, D=D, H=H, seed=14)
    gen = torch.Generator(device="cuda").manual_seed(15)
    wbytes = 4 * D * D + 2 * D * H + 4 * (2 * D + 2 * D + H) * 2 + 4 * K * D
    cases = []
    for T in SEACO_MEMORY_ROWS:
        tl = torch.randint(1, U + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
        tl[0] = U
        ml = torch.full((B,), T, device="cuda", dtype=torch.int32)
        x = torch.randn((B, U, D), generator=gen, device="cuda").to(torch.bfloat16)
        mem = torch.randn((1, T, D), generator=gen, device="cuda").expand(B, T, D).to(
            torch.bfloat16)
        kb = key_bias(ml, T)
        got = DL.fused_decoder_layer(x, mem, tl, ml, dec_w, NH, LEFT, kb,
                                     DL.quantize_memory(mem))
        want = DL.decoder_layer_ref(x, mem, tl, ml, dec_w, NH, LEFT, kb,
                                    RQ.rowquant_ref(mem.reshape(B * T, D)))
        n_tok = float(tl.double().sum())
        cases.append(_layer_case(
            torch, f"SeACo decoder layer B={B} U={U} memory H+1={T}, units {H}", got, want,
            torch.arange(U, device="cuda")[None, :, None] < tl[:, None, None], None, None,
            2 * 2 * n_tok * D + (D + 4) * B * T + 4 * B * T + wbytes,
            {"int8": 2.0 * n_tok * (2 * D * H + 2 * D * D) + 2.0 * B * T * D * 2 * D,
             "bfloat16": 4.0 * D * n_tok * T, "float32": 2.0 * K * D * n_tok}))
        q = torch.randn((B, U, D), generator=gen, device="cuda")
        kv = torch.randn((B, T, 2 * D), generator=gen, device="cuda")
        args = (q, kv[..., :D], kv[..., D:], kb, NH, 128 ** -0.5, None)
        got, want = A.attention_f32ctx(*args), A.attention_f32ctx_ref(*args)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        check(bool(torch.isfinite(got).all()) and equal,
              f"float32-context attention over {T} hotword rows: bit-equal to its twin")
        cases.append(dict(case=f"SeACo cross-attention alone: q ({B}, {U}, {D}), k/v "
                               f"({B}, {T}, {D}) f32, H={NH}",
                          max_abs_err=float((got - want).abs().max()), tolerance=0.0,
                          bit_equal=equal))
    for case in cases:
        log(f"SeACo decoder layer {case}")
    return cases


def check_spk_fbank(torch, FK, wav):
    """The fbank kernel on the speaker-chunk batch (N x 1.5 s, hamming, 80
    mels, no energy) against its float32 twin (``FBANK_TOL``) and the float64
    exact value (``FBANK_EXACT_TOL``)."""
    lens = torch.full((wav.shape[0],), wav.shape[1], device=wav.device, dtype=torch.int32)
    got, _ = FK.fused_fbank(wav, lens)
    want, _ = FK.fbank_ref(wav, lens)
    exact = fbank_fft_route(torch, wav, torch.float64)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_exact = float((got.double() - exact).abs().max())
    twin_exact = float((want.double() - exact).abs().max())
    log(f"fbank on the speaker chunks {tuple(wav.shape)}: kernel vs twin {err:.3e} (tol "
        f"{FBANK_TOL}), kernel vs exact {err_exact:.3e} (tol {FBANK_EXACT_TOL}), twin vs "
        f"exact {twin_exact:.3e}")
    check(err <= FBANK_TOL and err_exact <= FBANK_EXACT_TOL,
          "fbank kernel on the speaker chunks against its twin and the exact value")
    return dict(case=f"speaker chunks {tuple(wav.shape)} hamming, 80 mels", max_abs_err=err,
                tolerance=FBANK_TOL, max_abs_err_exact=err_exact,
                twin_max_abs_err_exact=twin_exact)


def end_to_end_pipeline_c(torch, FK, A, card):
    """Pipeline run (c): ``AutoModel(model=SeACo, vad_model=FSMN-VAD,
    punc_model=CT-Transformer, spk_model=CAM++, quantize=True).generate(wav,
    hotword=<10 words>, preset_spk_num=2)`` of a 600 s two-voice
    ``pipeline_recording`` at full width on seeded random weights, the VAD's
    state machine output replaced by the burst plan merged to <= 15 s (as
    run (b)).  The bias head's no-bias logit is raised by the median margin
    of one probe batch so that both branches of the merge run.  Twice: on
    the kernels, with every counter held to its exact count and no host sync
    inside a batch's or the speaker chunks' dispatch; then on the twins of
    the int8 layers (ASR), of the d = 32 attention (punctuation) and of
    fbank (speaker chunks), the ASR fbank and encoder layer 0's attention
    staying kernels as in run (b): tokens agree >= 0.99, token lengths and
    fire counts equal, merged log-probs within 1e-3 where the merge took
    the same branch (the flips counted), timestamps equal when none flipped,
    every speaker embedding at cosine >= 0.999 to its twin's, ``spk_info``
    equal.  Returns (launches, e2e record, kernel cases)."""
    import numpy as np

    from funasr_torch.auto import auto_model as AM
    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.models.campplus import cluster as CL
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL
    from funasr_torch.utils.vad_utils import merge_vad, slice_audio_by_segments

    def tok_mask(out):
        """The valid token positions of one batch's (tokens, lengths, ...)."""
        return (torch.arange(out[0].shape[1], device=out[0].device)[None]
                < out[1][:, None])

    t0 = time.time()
    asr_cfg, vad_cfg, punc_cfg, spk_cfg = seaco_spk_configs()
    am = AutoModel(model=asr_cfg, vad_model=vad_cfg, punc_model=punc_cfg, spk_model=spk_cfg,
                   quantize=True, seed=2028)
    eng, ve, pm, spk = am.engine, am.vad_engine, am.punc_engine.model, am.spk_engine
    model = eng.module
    nb = model.no_bias_id
    n_blocks = CT_PUNC["encoder_conf"]["num_blocks"]
    n_seaco = len(model.seaco_decoder.decoders)
    seaco_units = model.seaco_decoder.decoders[0].feed_forward.w_1.out_features
    log(f"e2e pipeline (c): AutoModel (int8 SeACo, FSMN-VAD, CT-Transformer, CAM++) built "
        f"in {time.time() - t0:.1f} s; SeACo decoder {n_seaco} layers x {seaco_units} units, "
        f"CAM++ {sum(p.numel() for p in spk.model.parameters())} parameters")
    wav, bursts = pipeline_recording(np.random.default_rng(12), two_voices=True)
    plan = merge_vad(bursts, 15000)
    words = hotword_list(np.random.default_rng(14), asr_cfg["tokenizer_conf"]["token_list"], nb)
    hotword = " ".join(words)
    grid = eng.encode_hotwords(hotword)
    n_rows = int(grid.pad.shape[0])
    check(n_rows == N_HOTWORDS + 1, f"hotword grid rows {n_rows}")

    # the no-bias logit raised by the median margin on one probe batch (15 s)
    probe = [wav[s * 16: e * 16] for s, e in plan[:4]]
    seen = {}
    real_merge = model.merge_logprobs

    def margin_spy(dec, dha):
        seen["dha"] = dha.float()
        return real_merge(dec, dha)

    model.merge_logprobs = margin_spy
    try:
        wav_d, lens_d = eng._pack(probe)
        _, tl, _, _ = eng.run_hw(wav_d, lens_d, grid, eng._max_tokens(wav_d.shape[1]))
    finally:
        del model.merge_logprobs
    dha = seen["dha"]
    valid = torch.arange(dha.shape[1], device=dha.device)[None] < tl[:, None]
    others = torch.cat([dha[..., :nb], dha[..., nb + 1:]], -1).amax(-1)
    shift = float((others - dha[..., nb])[valid].median())
    with torch.no_grad():
        model.hotword_output_layer.bias[nb] += shift
    with guarded_entries(torch, (eng, "transcribe_async"), (am.vad_engine, "front"),
                         (am.spk_engine, "embed_async")):
        am.warmup(seconds=(2,))  # the first calls, dispatched under the guard
        eng.transcribe(probe[:1], hotword=grid)  # the hotword path's first call
    torch.cuda.synchronize()
    log(f"e2e pipeline (c): hotwords {words}; no-bias logit raised by {shift:.3f}")

    counters = {"fbank": FK.fused_fbank, "attention": A.fused_attention,
                "sanm_layer": SL.fused_sanm_layer, "decoder_layer": DL.fused_decoder_layer,
                "ffn": FF.fused_ffn_int8, "qmm": QM.quant_matmul,
                "attention_i8qk": A.attention_i8qk, "attention_f32ctx": A.attention_f32ctx,
                "ffn_bf16": FF.fused_ffn, "int8_gemm": G.int8_gemm, "rowquant": RQ.rowquant,
                "int8_gemm_rq": G.int8_gemm_rq, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln}

    def guarded(f):
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode("error")  # a host sync here raises
            try:
                return f(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    def run(twins):
        """One ``generate`` with the counters read -> (result, launches,
        punctuation rounds, per-batch outputs, merged log-probs and branches,
        speaker embeddings and chunk batches, stage times)."""
        clock = StageClock(torch)
        rounds, outs, merges, embs, chunk_wavs = [0], [], [], [], []
        real_argmax, real_run, real_spk = pm._argmax, eng.run_hw, spk.run

        def counted_argmax(text, lens):
            rounds[0] += 1
            if not twins:
                return real_argmax(text, lens)
            with swapped([(A, "fused_attention", A.attention_ref)]):
                return real_argmax(text, lens)

        def kept_run(*a):
            out = real_run(*a)
            outs.append([x.clone() for x in out])
            return out

        def kept_merge(dec, dha):
            out = real_merge(dec, dha)
            merges.append((out.clone(), torch.argmax(dha, -1) == nb))
            return out

        def kept_spk(wav_d, lens_d):
            chunk_wavs.append(wav_d)
            if not twins:
                emb = real_spk(wav_d, lens_d)
            else:
                with swapped([(FK, "fused_fbank", FK.fbank_ref)]):
                    emb = real_spk(wav_d, lens_d)
            embs.append(emb.clone())
            return emb

        pm._argmax, eng.run_hw, spk.run = counted_argmax, kept_run, kept_spk
        model.merge_logprobs = kept_merge
        for obj, name in ((eng, "transcribe_async"), (eng, "encode_hotwords"),
                          (spk, "embed_async")):
            setattr(obj, name, guarded(getattr(obj, name)))
        # the state machine runs, its segments replaced by the plan
        ve.model.segments_from_posteriors = (
            lambda post, db, f=ve.model.segments_from_posteriors: (f(post, db), plan)[1])
        clock.wrap(ve, "front", "vad_device", events=True)
        clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
        clock.wrap(eng, "run_hw", "asr_device", events=True)
        clock.wrap(eng, "_ts_results", "asr_host")
        clock.wrap(pm, "inference_batch", "punc")
        clock.wrap(pm, "_argmax", "punc_device", events=True)
        clock.wrap(spk, "run", "spk_device", events=True)
        clock.wrap(spk, "embed_async", "spk_dispatch")
        clock.wrap(CL.ClusterBackend, "__call__", "cluster")
        clock.wrap(AM, "sv_chunk", "spk_chunking")
        clock.wrap(AM, "distribute_spk", "spk_distribute")
        clock.wrap(AM, "timestamp_sentence", "sentences")
        for fn in counters.values():
            fn.launches = 0
        A.fused_attention.launches_by_head = dict.fromkeys(A.HEAD_SIZES, 0)
        try:
            stack = int8_twins() if twins else contextlib.nullcontext()
            with stack:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = am.generate(wav, key=["c"], hotword=hotword, preset_spk_num=2)[0]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            clock.restore()
            for obj, attr in ((pm, "_argmax"), (eng, "run_hw"), (spk, "run"),
                              (model, "merge_logprobs"), (eng, "transcribe_async"),
                              (eng, "encode_hotwords"), (spk, "embed_async"),
                              (ve.model, "segments_from_posteriors")):
                delattr(obj, attr)
        launches = {k: fn.launches for k, fn in counters.items()}
        launches["attention_d32"] = A.fused_attention.launches_by_head[32]
        times = dict(generate_wall_s=wall, audio_s_per_s=PIPELINE_AUDIO_S / wall,
                     vad_device_ms=clock.device_ms("vad_device"),
                     vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                     asr_device_span_ms=clock.device_ms("asr_device", span=True),
                     asr_device_ms=clock.device_ms("asr_device"),
                     asr_dispatch_wall_s=clock.wall.get("asr_device", 0.0),
                     asr_host_wall_s=clock.wall.get("asr_host", 0.0),
                     punc_wall_s=clock.wall.get("punc", 0.0),
                     punc_device_ms=clock.device_ms("punc_device"), punc_rounds=rounds[0],
                     spk_device_ms=clock.device_ms("spk_device"),
                     spk_dispatch_wall_s=clock.wall.get("spk_dispatch", 0.0),
                     cluster_host_s=clock.wall.get("cluster", 0.0),
                     spk_chunking_host_s=clock.wall.get("spk_chunking", 0.0),
                     spk_distribute_host_s=clock.wall.get("spk_distribute", 0.0),
                     sentence_info_host_s=clock.wall.get("sentences", 0.0))
        return res, launches, rounds[0], outs, merges, embs, chunk_wavs, times

    # one run first: the first call at the speaker batch's and the ASR
    # batches' shapes (cuDNN plans, allocations) is not the one timed
    first = run(twins=False)[-1]
    log(f"e2e pipeline (c), the first call at these shapes: {json.dumps(first)}")
    res, launches, rounds, outs, merges, embs, chunk_wavs, times = run(twins=False)
    segments = plan
    clips = slice_audio_by_segments(wav, segments, FS)
    batches = am.batches(segments, FS, 300)
    n_chunks = sum(len(CL.sv_chunk([s / 1000.0, e / 1000.0, c], fs=FS))
                   for (s, e), c in zip(segments, clips))
    want = dict.fromkeys(counters, 0)
    # fbank: the VAD (the waveform path: no shared grid under a hotword), each
    # ASR batch, the speaker chunks (one length: one call)
    want["fbank"] = 1 + len(batches) + 1
    shapes = []
    for batch in batches:
        B, T, U = served_shape(eng, [clips[i] for i in batch])
        shapes.append((B, T, U))
        per = layer_launches()
        # the gated QDense contractions: the main model's, and the SeACo
        # decoder's FFN-only tail w_1 in each of its two passes (its w_2 has
        # 512 columns, under the gate; hotword_output_layer is never int8)
        n_q = qdense_gated(Q, (B, T, U)) + 2 * Q.gate(B * U, seaco_units)
        # each SeACo pass: its memory row-quantized once, per full layer 4
        # rowquant + int8 GEMM pairs, the GEMM on the memory and one fsmn_ln
        per["rowquant"] += n_q + 2 * (1 + 4 * n_seaco)
        per["int8_gemm"] += n_q + 2 * 5 * n_seaco
        per["fsmn_ln"] += 2 * n_seaco
        for k, n in (("attention", 1), ("ffn", 1), ("sanm_layer", 49),
                     ("decoder_layer", 16 + 2 * n_seaco), *per.items()):
            want[k] += n
        want["attention_f32ctx"] += (49 * exact_attention_launches(A, B, T, T)
                                     + 16 * exact_attention_launches(A, B, U, T)
                                     + 2 * n_seaco * exact_attention_launches(A, B, U, n_rows))
    want["attention"] += rounds * n_blocks
    want["attention_d32"] = rounds * n_blocks
    log(f"e2e pipeline (c): {len(segments)} segments, ASR batches (B, T, U) {shapes}, "
        f"memory {n_rows} hotword rows, {rounds} punctuation rounds, {n_chunks} speaker "
        f"chunks in {len(chunk_wavs)} batch(es) of {[tuple(w.shape) for w in chunk_wavs]}; "
        f"kernel launches {launches}")
    check(launches == want, f"pipeline (c) launches {launches}, want {want}")
    check(len(chunk_wavs) == 1 and chunk_wavs[0].shape == (n_chunks, int(1.5 * FS)),
          "pipeline (c): the speaker chunks in one batch")
    ts = res["timestamp"]
    spk_info = res.get("spk_info", [])
    check(isinstance(res.get("text"), str) and res["text"] and len(ts) > 0
          and res.get("sentence_info") and all("spk" in s for s in res["sentence_info"]),
          "pipeline (c): text, timestamps and sentence_info with speakers")
    check(all(b <= e for b, e in ts) and all(0 <= b and e <= PIPELINE_AUDIO_S * 1000
                                            for b, e in ts),
          "pipeline (c): timestamps within the recording")
    labels = [lab for _, _, lab in spk_info]
    check(len(spk_info) == n_chunks and set(labels) == {0, 1},
          f"pipeline (c): spk_info of {len(spk_info)} chunks, speakers {sorted(set(labels))}")
    emb_k = torch.cat(embs)
    check(emb_k.shape == (n_chunks, 192) and bool(torch.isfinite(emb_k).all()),
          "pipeline (c): finite 192-d speaker embeddings")
    # speakers against the voices: chunks wholly inside one burst
    voice_of = []
    for (c0, c1, lab) in spk_info:
        hit = [i % 2 for i, (b0, b1) in enumerate(bursts) if b0 <= c0 and c1 <= b1]
        if hit:
            voice_of.append((hit[0], lab))
    pure = max(np.mean([v == lab for v, lab in voice_of]),
               np.mean([v != lab for v, lab in voice_of])) if voice_of else 0.0
    branch_share = float(np.mean([float(b[tok_mask(o)].float().mean()) for (_, b), o in
                                  zip(merges, outs)]))
    log(f"e2e pipeline (c) on {card}: {json.dumps(times)}; text {res['text'][:24]}... "
        f"{len(ts)} stamps, {len(res['sentence_info'])} sentences, speakers per chunk "
        f"{np.bincount(labels).tolist()}, label purity against the two voices "
        f"{pure:.4f} over {len(voice_of)} chunks inside one burst; the merge kept the "
        f"decoder at {branch_share:.4f} of the positions")
    e2e = {"pipeline_c": dict(times, first_call=first, segments=len(segments), batches=shapes,
                              hotword_rows=n_rows, speaker_chunks=n_chunks,
                              speaker_batch=[tuple(w.shape) for w in chunk_wavs],
                              launches=launches, no_bias_shift=shift,
                              speaker_label_purity=pure, decoder_branch_share=branch_share)}
    spk_case = check_spk_fbank(torch, FK, chunk_wavs[0])

    # ---- the same run on the twins
    res_t, _, _, outs_t, merges_t, embs_t, _, times_t = run(twins=True)
    same_len = all(torch.equal(a[1], b[1]) for a, b in zip(outs, outs_t))
    same_fires = all(torch.equal(a[3].sum(-1), b[3].sum(-1)) for a, b in zip(outs, outs_t))
    n_ok = n_all = flips = 0
    logp_err = 0.0
    for (a, (ma, ba)), (b, (mb, bb)) in zip(zip(outs, merges), zip(outs_t, merges_t)):
        valid = tok_mask(a)
        n_ok += int((a[0] == b[0])[valid].sum())
        n_all += int(valid.sum())
        flip = (ba != bb) & valid
        flips += int(flip.sum())
        keep = valid & ~flip
        if keep.any():
            logp_err = max(logp_err, float((ma - mb).abs()[keep].max()))
    agree = n_ok / max(n_all, 1)
    same_ts = res["timestamp"] == res_t["timestamp"]
    emb_t = torch.cat(embs_t)
    cos = torch.nn.functional.cosine_similarity(emb_k.double(), emb_t.double(), dim=-1)
    mean = emb_k.double().mean(0)
    cos_c = torch.nn.functional.cosine_similarity(emb_k.double() - mean,
                                                  emb_t.double() - mean, dim=-1)
    same_spk = res.get("spk_info") == res_t.get("spk_info")
    log(f"e2e pipeline (c), kernels vs twins: token lengths equal {same_len}, fire counts "
        f"equal {same_fires}, token agreement {agree:.5f} over {n_all}, merge branches "
        f"flipped at {flips} positions, merged max |dlogp| {logp_err:.3e} where not "
        f"(tol {E2E_INT8_LOGP_TOL}), timestamps equal {same_ts}; speaker embeddings "
        f"cosine min {float(cos.min()):.7f} (bar {SPK_COS_MIN}), centered on the mean "
        f"{float(cos_c.min()):.7f}; spk_info equal {same_spk}; twins' run "
        f"{json.dumps(times_t)}")
    check(same_len and same_fires and agree >= E2E_INT8_MIN_AGREE
          and logp_err <= E2E_INT8_LOGP_TOL and (same_ts or flips > 0),
          "pipeline (c): int8 SeACo kernels against twins")
    check(float(cos.min()) >= SPK_COS_MIN and same_spk,
          "pipeline (c): speaker embeddings and spk_info, fbank kernel against its twin")
    e2e["pipeline_c_twins"] = dict(token_lengths_equal=same_len, fire_counts_equal=same_fires,
                                   token_agreement=agree, branch_flips=flips,
                                   merged_logp_max_abs_diff=logp_err, timestamps_equal=same_ts,
                                   spk_cos_min=float(cos.min()),
                                   spk_centered_cos_min=float(cos_c.min()),
                                   spk_info_equal=same_spk)
    B0, _, U0 = shapes[0]
    cases = check_seaco_decoder_layer(torch, SL, DL, FF, A, B0, U0)
    del am
    torch.cuda.empty_cache()
    return launches, e2e, cases, spk_case


# ------------------------------------------------------------------ streaming
STREAM_CHUNK = (0, 10, 5)  # (lookback, current, lookahead) LFR frames: 600 ms
STREAM_LOOK_BACK = 4  # encoder_chunk_look_back: a KV cache of 4 x 10 frames
STREAM_STEP = 9600  # samples a chunk: 600 ms at 16 kHz
STREAM_AUDIO_S = 60
STREAM_SEED = 19  # the 60 s recording's six bursts are each 5-20 s long


def check_streaming_kernels(torch, FK, A):
    """(a) The attention kernel, float32 d = 128, at the window step's two
    shapes: the encoder's 15 queries over [KV cache (40) | window (15)] with
    the cache empty, partly filled and full and on a final window of 3 real
    frames, k and v column slices of the (1, 55, 1024) [k | v]; the
    decoder's 18 query rows over the 15 window frames with prefixes of 5 and
    15.  Against the twin at abs 1e-4, timed by events and CUDA graph beside
    SDPA.  The fbank kernel on one 600 ms step's buffer against its twin."""
    import torch.nn.functional as F

    H, d, D = 4, 128, 512
    l, c, r = STREAM_CHUNK
    C, W, U = STREAM_LOOK_BACK * c, l + c + r, c + r + 3
    gen = torch.Generator(device="cuda").manual_seed(13)
    attn_cases = []
    shapes = [("encoder self-attention, cache empty", W, C, 0, W),
              ("encoder self-attention, cache partial", W, C, c, W),
              ("encoder self-attention, cache full", W, C, C, W),
              ("encoder self-attention, final window of 3 frames", W, C, C, l + r + 3),
              ("decoder cross-attention, prefix 5", U, 0, 0, 5),
              ("decoder cross-attention, prefix 15", U, 0, 0, W)]
    for name, nq, cache, kv_valid, win_valid in shapes:
        T = cache + W
        kv = torch.randn((1, T, 2 * D), generator=gen, device="cuda")
        k, v = kv[..., :D], kv[..., D:]
        q = torch.randn((1, nq, D), generator=gen, device="cuda") * d ** -0.5
        bias = torch.full((1, T), -1e30, device="cuda")
        bias[:, cache - kv_valid:cache + win_valid] = 0.0
        got = A.fused_attention(q, k, v, bias, H)
        want = A.attention_ref(q, k, v, bias, H)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL["float32"],
              f"streaming attention {name}: err {err} > {ATTN_TOL['float32']}")
        q4, k4, v4 = (x.unflatten(-1, (H, d)).transpose(1, 2) for x in (q, k, v))
        n_keys = float(kv_valid + win_valid)
        bnd, by = bound_ms(4 * (2 * nq * D + 2 * n_keys * D) + 4 * T,
                           {"float32": 4.0 * nq * D * n_keys})
        case = dict(case=f"streaming {name}: q (1, {nq}, {D}), k/v (1, {T}, {D}) of "
                         f"(1, {T}, {2 * D}), float32, {int(n_keys)} keys",
                    max_abs_err=err, tolerance=ATTN_TOL["float32"],
                    ms=cuda_ms(lambda: A.fused_attention(q, k, v, bias, H), iters=50,
                               warmup=10),
                    graph_ms=graph_ms(lambda: A.fused_attention(q, k, v, bias, H)),
                    plain_ms=cuda_ms(lambda: A.attention_ref(q, k, v, bias, H), iters=20),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=bias[:, None, None, :], scale=1.0),
                        iters=50, warmup=10),
                    bound_ms=bnd, bound_by=by,
                    split_tf32_bound_ms=split_tf32_bound_ms(4.0 * nq * D * n_keys))
        log(f"attention {case}")
        attn_cases.append(case)

    # the first 600 ms step: 58 frames of a 9520-sample buffer
    import numpy as np

    n = (STREAM_STEP - 400) // 160 * 160 + 400
    wav = torch.from_numpy(waveform(np.random.default_rng(5), n, 260.0)).cuda()[None]
    lens = torch.full((1,), n, dtype=torch.int32, device="cuda")
    got = FK.fused_fbank(wav, lens)[0]
    want = FK.fbank_ref(wav, lens)[0]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    T = got.shape[1]
    check(bool(torch.isfinite(got).all()) and err <= FBANK_TOL,
          f"streaming fbank step: err {err} > {FBANK_TOL}")
    bnd, by = bound_ms(n * 4 + T * 80 * 4 + 8, {"float32": T * fbank_ops_per_frame(80, False)})
    fb_case = dict(case=f"streaming fbank: one 600 ms step, wav (1, {n}) -> (1, {T}, 80)",
                   max_abs_err=err, tolerance=FBANK_TOL,
                   ms=cuda_ms(lambda: FK.fused_fbank(wav, lens), iters=50, warmup=10),
                   graph_ms=graph_ms(lambda: FK.fused_fbank(wav, lens)),
                   plain_ms=cuda_ms(lambda: FK.fbank_ref(wav, lens), iters=20),
                   library_ms=None, bound_ms=bnd, bound_by=by,
                   cufft_route_ms=cuda_ms(lambda: fbank_fft_route(torch, wav, torch.float32),
                                          iters=20))
    log(f"fbank {fb_case}")
    return attn_cases, fb_case


def fbank_step_launches(chunk_lens) -> int:
    """Steps of the streaming frontend that yield frames (one fbank launch
    each), reckoned from the chunk lengths alone: the sample cache below a
    frame boundary carries over, 400-sample frames at hop 160."""
    cached = launches = 0
    for n in chunk_lens:
        buf = cached + n
        frames = max(0, (buf - 400) // 160 + 1)
        launches += frames > 0
        cached = buf - frames * 160
    return launches


def end_to_end_streaming(torch, FK, A, am, profile_dir, card):
    """The streaming phase.  (a) ``check_streaming_kernels``.  (b)
    Full-width streaming Paraformer-large (float32, seeded random weights,
    chunk (0, 10, 5), look-back 4, B = 1) streams a 60 s recording in 600
    ms chunks with a final flush: counters exact (attention 66 a window
    step, fbank once a frontend step that yields frames), no host sync
    inside a window step's dispatch; the same stream with the kernels'
    twins: the same token count in every window, tokens agreeing >= 0.99,
    log-probs within 1e-2; the window step's device span (events), wall
    time, launches (one profiled step), real-time factor and byte bound.
    (c) ``AsrWebSocketServer(am, streaming_model)``: one offline, one
    online and four concurrent 2pass sessions through ``on_text`` /
    ``on_binary``, each a burst of 5-20 s in 600 ms PCM16 frames, the
    replies checked against the protocol."""
    import threading

    import numpy as np

    from funasr_torch.models.paraformer.model import Paraformer, init_random_
    from funasr_torch.models.paraformer_streaming.model import ParaformerStreaming
    from funasr_torch.runtime.websocket_server import AsrWebSocketServer, WsSession

    attn_cases, fb_case = check_streaming_kernels(torch, FK, A)

    t0 = time.time()
    f32 = Paraformer(**FLAGSHIP, dtype=torch.float32)
    init_random_(f32, torch.Generator(device="cuda").manual_seed(2029))
    sm = ParaformerStreaming(f32, chunk_size=STREAM_CHUNK,
                             encoder_chunk_look_back=STREAM_LOOK_BACK)
    wav, bursts = pipeline_recording(np.random.default_rng(STREAM_SEED), STREAM_AUDIO_S)
    chunks = [wav[i:i + STREAM_STEP] for i in range(0, len(wav), STREAM_STEP)]
    log(f"e2e streaming: Paraformer-large float32 built in {time.time() - t0:.1f} s; "
        f"{STREAM_AUDIO_S} s in {len(chunks)} chunks of 600 ms + a final flush")

    def stream(check_sync):
        """One stream; per window (n_tok, tokens, log_probs, events, wall s)."""
        windows = []
        real_step, real_run = sm._step, sm._run_window

        def step(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if check_sync:
                torch.cuda.set_sync_debug_mode("error")  # a host sync here raises
            try:
                out = real_step(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            windows.append(dict(out=out[0], log_probs=out[1], events=(e0, e1)))
            return out

        def run(*a, **k):
            t = time.perf_counter()
            out = real_run(*a, **k)
            windows[-1]["wall_s"] = time.perf_counter() - t
            return out

        sm._step, sm._run_window = step, run
        try:
            cache = sm.init_cache()
            t = time.perf_counter()
            for ch in chunks:
                sm.generate_chunk(cache, ch, False)
            sm.generate_chunk(cache, wav[:0], True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            del sm._step, sm._run_window
        for w in windows:
            row = w.pop("out")[0][0][0]
            w["n_tok"], w["tokens"] = int(row[0]), row[1:]
        return cache.tokens, windows, wall

    stream(True)  # the first stream (the pinned pool), its steps under the guard
    for fn in (FK.fused_fbank, A.fused_attention):
        fn.launches = 0
    toks, win_k, wall = stream(True)
    launches = {"fbank": FK.fused_fbank.launches, "attention": A.fused_attention.launches}
    n_win = len(win_k)
    want = {"fbank": fbank_step_launches([len(ch) for ch in chunks] + [0]),
            "attention": n_win * (sm.n_enc_layers + sm.n_dec_layers)}
    log(f"e2e streaming: {n_win} window steps, {len(toks)} tokens in {wall:.3f} s; kernel "
        f"launches {launches}, want {want}")
    check(launches == want, f"streaming launches {launches}, want {want}")
    n_lfr = -(-((len(wav) - 400) // 160 + 1) // 6)  # LFR frames of the whole stream
    check(n_win == n_lfr // STREAM_CHUNK[1] + 1,
          f"streaming: {n_win} window steps for {n_lfr} LFR frames")
    check(all(np.isfinite(w["log_probs"].cpu().numpy()).all() for w in win_k),
          "streaming log-probs finite")
    check(len(toks) > 0 and all(0 <= t < FLAGSHIP["vocab_size"] for t in toks),
          "streaming tokens within the vocabulary")

    with plain_twins(FK, A):
        toks_t, win_t, _ = stream(False)
    same_counts = [a["n_tok"] for a in win_k] == [b["n_tok"] for b in win_t]
    n_ok = n_all = 0
    lp_err = 0.0
    for a, b in zip(win_k, win_t):
        n = a["n_tok"]
        n_ok += int((a["tokens"][:n] == b["tokens"][:n]).sum())
        n_all += n
        if n:
            lp_err = max(lp_err, float((a["log_probs"][0, :n] - b["log_probs"][0, :n])
                                       .abs().max()))
    agree = n_ok / max(n_all, 1)
    log(f"e2e streaming, kernels vs twins: per-window token counts equal {same_counts}, "
        f"token agreement {agree:.5f} over {n_all}, max |dlogp| {lp_err:.3e} "
        f"(tol {E2E_F32_LOGP_TOL})")
    check(same_counts and len(win_t) == n_win, "streaming: per-window token counts, "
          "kernels against twins")
    check(agree >= E2E_F32_MIN_AGREE, "streaming: token agreement, kernels against twins")
    check(lp_err <= E2E_F32_LOGP_TOL, "streaming: log-probs, kernels against twins")

    # ---- the window step: time, launches, bound
    span = [w["events"][0].elapsed_time(w["events"][1]) for w in win_k]
    step_wall = [w["wall_s"] * 1e3 for w in win_k]
    used = [m for name, m in f32.named_children() if name in ("encoder", "predictor")]
    n_param = sum(p.numel() for m in used for p in m.parameters()) + sum(
        p.numel() for n, p in f32.decoder.named_parameters() if not n.startswith("embed"))
    l, c, r = STREAM_CHUNK
    W, U, C, D = l + c + r, c + r + 3, STREAM_LOOK_BACK * c, 512
    enc_p = sum(p.numel() for p in f32.encoder.parameters())
    # the weights once; each encoder layer's KV cache and each decoder layer's
    # FSMN tail in and out; the window in, the log-probs out
    nbytes = (4 * n_param + 50 * 2 * 4 * C * 2 * D + 16 * 2 * 4 * (sm.dec_kernel - 1) * D
              + 4 * (W * 560 + U * FLAGSHIP["vocab_size"]))
    ops = (2.0 * enc_p * W + 2.0 * (n_param - enc_p) * U
           + 50 * 4.0 * W * D * (C + W) + 16 * 4.0 * U * D * W)
    bnd, by = bound_ms(nbytes, {"float32": ops})
    cache_p = sm.init_cache()
    feats = np.random.default_rng(3).standard_normal((c, 560)).astype(np.float32)
    for _ in range(STREAM_LOOK_BACK + 1):  # a full KV cache
        sm._run_window(cache_p, feats, final=False)
    med = float(np.median(step_wall))
    prof = profile(torch, lambda: sm._run_window(cache_p, feats, final=False), profile_dir,
                   med, "profile_streaming.txt")
    e2e = dict(window_steps=n_win, tokens=len(toks), stream_wall_s=wall,
               step_span_ms_median=float(np.median(span)), step_span_ms_mean=float(np.mean(span)),
               step_wall_ms_median=med, step_wall_ms_mean=float(np.mean(step_wall)),
               step_wall_ms_max=float(np.max(step_wall)),
               rtf_median=med / 600.0, audio_s_per_s=STREAM_AUDIO_S / wall,
               launches_per_step=dict(attention=66, kernels=prof["kernel launches"]),
               kernel_ms_per_step=prof["kernels total"],
               step_bound_ms=bnd, step_bound_by=by, step_bytes=nbytes, weight_params=n_param,
               twins=dict(counts_equal=same_counts, token_agreement=agree,
                          logp_max_abs_diff=lp_err),
               launches=launches)
    log(f"e2e streaming window step on {card}: span {e2e['step_span_ms_median']:.3f} ms "
        f"(events, median), wall {med:.3f} ms (median; mean {e2e['step_wall_ms_mean']:.3f}), "
        f"RTF {med / 600.0:.4f}, {prof['kernel launches']} kernel launches a step "
        f"(attention 66), kernels {prof['kernels total']:.3f} ms; bound {bnd:.4f} ms ({by}, "
        f"{nbytes / 1e9:.3f} GB)")

    # ---- (c) sessions through the protocol
    server = AsrWebSocketServer(am, streaming_model=sm)
    spans = [b for b in bursts if 5000 <= b[1] - b[0] <= 20000]
    check(len(spans) >= 6, f"streaming: {len(spans)} bursts of 5-20 s, want 6")

    def session(mode, span, name, out):
        sess = WsSession(server)
        msgs = server.on_text(sess, json.dumps({
            "mode": mode, "wav_name": name, "is_speaking": True, "wav_format": "pcm",
            "audio_fs": FS}))
        seg = wav[span[0] * FS // 1000:span[1] * FS // 1000]
        pcm = (np.clip(seg, -1.0, 1.0) * 32767).astype("<i2").tobytes()
        for i in range(0, len(pcm), 2 * STREAM_STEP):
            msgs += server.on_binary(sess, pcm[i:i + 2 * STREAM_STEP])
        t = time.perf_counter()
        msgs += server.on_text(sess, json.dumps({"is_speaking": False}))
        out[name] = dict(mode=mode, seconds=len(seg) / FS, msgs=[json.loads(m) for m in msgs],
                         end_to_final_s=time.perf_counter() - t)

    results = {}
    try:
        session("offline", spans[0], "offline", results)
        session("online", spans[1], "online", results)
        threads = [threading.Thread(target=session, args=("2pass", spans[2 + i],
                                                          f"2pass{i}", results))
                   for i in range(4)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        two_pass_wall = time.perf_counter() - t
        check(not any(th.is_alive() for th in threads), "streaming: 2pass sessions ended")
    finally:
        server.decode_model.close()
    check(len(results) == 6, f"streaming: {sorted(results)} sessions answered")
    for name, res in results.items():
        msgs, mode = res["msgs"], res["mode"]
        check(all(m.get("wav_name") == name and isinstance(m.get("text"), str) for m in msgs),
              f"session {name}: wav_name and text in every reply")
        if mode == "offline":
            check(len(msgs) == 1 and msgs[0]["mode"] == "offline" and msgs[0]["is_final"]
                  and msgs[0]["text"], f"session {name}: one final offline reply")
        elif mode == "online":
            check(len(msgs) > 1 and all(m["mode"] == "online" for m in msgs)
                  and msgs[-1]["is_final"] is True
                  and not any(m["is_final"] for m in msgs[:-1]),
                  f"session {name}: online partials, the last final")
        else:
            part = [m for m in msgs if m["mode"] == "2pass-online"]
            fin = [m for m in msgs if m["mode"] == "2pass-offline"]
            check(part and all(m["is_final"] is False for m in part),
                  f"session {name}: 2pass-online partials, not final")
            check(len(fin) == 1 and fin[0]["is_final"] is True and fin[0]["text"]
                  and fin[0].get("timestamp") and fin[0].get("stamp_sents"),
                  f"session {name}: one 2pass-offline with text, timestamp, stamp_sents")
    sessions = {n: dict(mode=r["mode"], seconds=r["seconds"], replies=len(r["msgs"]),
                        end_to_final_s=r["end_to_final_s"],
                        final_text=r["msgs"][-1]["text"][:16]) for n, r in results.items()}
    batch_sizes = list(server.decode_model.batcher.batch_sizes)
    log(f"e2e streaming sessions on {card}: {json.dumps(sessions, ensure_ascii=False)}; "
        f"offline batcher batch_sizes {batch_sizes}; four 2pass sessions in "
        f"{two_pass_wall:.3f} s")
    e2e.update(sessions=sessions, batch_sizes=batch_sizes, two_pass_wall_s=two_pass_wall)
    return launches, {"streaming": e2e}, attn_cases, fb_case


# ------------------------------------------- SenseVoiceSmall: engine and README call
SENSEVOICE = dict(  # configs/sensevoice_small.yaml
    model="SenseVoiceSmall", vocab_size=25055, input_size=560,
    encoder="SenseVoiceEncoderSmall",
    encoder_conf=dict(output_size=512, attention_heads=4, linear_units=2048, num_blocks=50,
                      tp_blocks=20, kernel_size=11),
    frontend_conf=dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6))
SV_LAYERS = 69  # fused int8 SANM layers: encoders 49 + tp_encoders 20
# FunASR's README call: AutoModel(model="iic/SenseVoiceSmall", vad_model="fsmn-vad",
# vad_kwargs={"max_single_segment_time": 30000}).generate(input, ...)
SV_README_KW = dict(language="auto", use_itn=True, batch_size_s=60, merge_vad=True,
                    merge_length_s=15)
SV_VAD_CONF = {"model_conf": {"max_single_segment_time": 30000}}


def sensevoice_config(torch, FK, wav, build_dir):
    """SenseVoiceSmall's config as a dict: the generated 25055-entry token
    list (``CharTokenizer``; the card has no sentencepiece) and a CMVN file
    of the recording's LFR feature statistics (the released ``am.mvn`` is
    not in the repo; without one, random weights read every frame alike)."""
    import numpy as np

    from funasr_torch.auto.engines import FrontendConfig
    from funasr_torch.ops import fbank as F
    from funasr_torch.tokenizer.sensevoice_tokenizer import generated_token_list

    fe = FrontendConfig()
    with torch.inference_mode():
        wav_d = torch.from_numpy(wav).cuda()[None]
        raw, rl = fe.raw_fbank(wav_d, torch.tensor([len(wav)], device="cuda"))
        feats, fl = F.apply_lfr(raw, rl, fe.lfr_m, fe.lfr_n)
        v = feats[0, : int(fl[0])].double()
        mean, std = v.mean(0).cpu().numpy(), v.std(0).cpu().numpy()
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, "am.mvn")
    row = lambda x: "<LearnRateCoef> 0 [ " + " ".join(f"{a:.8g}" for a in x) + " ]"
    n = len(mean)
    with open(path, "w") as f:
        f.write("\n".join(["<Nnet>", f"<AddShift> {n} {n}", row(-mean), f"<Rescale> {n} {n}",
                           row(1.0 / (std + 1e-5)), "</Nnet>", ""]))
    return dict(SENSEVOICE, tokenizer="CharTokenizer", cmvn_file=path,
                tokenizer_conf=dict(token_list=generated_token_list(SENSEVOICE["vocab_size"])))


def sensevoice_shape(wavs):
    """(B, T + 4) of a served SenseVoice batch: the bucket, fbank frames,
    LFR by 6, padded to a multiple of 128, the 4 prompt rows."""
    from funasr_torch.auto.engines import quantize

    frames = (quantize(max(len(w) for w in wavs)) - 400) // 160 + 1
    lfr = -(-frames // 6)
    return len(wavs), -(-lfr // 128) * 128 + 4


def sensevoice_launches(Q, A, shapes, fbank):
    """The exact launches of the int8 SenseVoice path: ``fbank`` fbank launches
    and per (B, T) batch 69 SANM layers (each three rowquant + int8 GEMM
    pairs, one ``int8_gemm_rq`` and its float32-context attention by the
    wrapper's plan), ``encoders0``'s bf16 d = 128 attention and int8 FFN (two
    pairs), and a pair for each QDense contraction the gate admits
    (``encoders0``'s QKV and out, ``ctc_lo``)."""
    D, V = 512, SENSEVOICE["vocab_size"]
    want = dict(fbank=fbank, attention=0, sanm_layer=0, ffn=0, int8_gemm_rq=0, rowquant=0,
                int8_gemm=0, attention_f32ctx=0, decoder_layer=0, fsmn=0, fsmn_ln=0, qmm=0,
                attention_i8qk=0, ffn_bf16=0)
    for B, T in shapes:
        n_qdense = sum(Q.gate(B * T, n) for n in (3 * D, D, V))
        for k, n in (("attention", 1), ("sanm_layer", SV_LAYERS), ("ffn", 1),
                     ("int8_gemm_rq", SV_LAYERS), ("rowquant", 3 * SV_LAYERS + 2 + n_qdense),
                     ("int8_gemm", 3 * SV_LAYERS + 2 + n_qdense),
                     ("attention_f32ctx", SV_LAYERS * exact_attention_launches(A, B, T, T))):
            want[k] += n
    return want


def check_sensevoice_kernels(torch, SL, DL, FF, G, A):
    """The kernels of the SenseVoice path at its own shapes, against their
    twins: a SANM layer and encoders0's bf16 attention at a 16 x 15 s batch
    (T + 4 = 260 rows, lengths 254/204: T never a multiple of 8), and the
    int8 GEMM of ``ctc_lo`` (4160 rows x 512 -> 25055, the QDense
    epilogue), each timed beside its twin and bound.  Returns the cases."""
    import torch.nn.functional as F

    from funasr_torch.ops.masks import key_bias

    D, H, K, NH, LEFT, V = 512, 2048, 11, 4, 5, SENSEVOICE["vocab_size"]
    B, T = 16, 260
    sanm_w, _, _ = int8_layer_weights(torch, SL, DL, FF, seed=15)
    gen = torch.Generator(device="cuda").manual_seed(15)
    lens = torch.tensor([254, 204] * (B // 2), device="cuda", dtype=torch.int32)
    kb = key_bias(lens, T)
    x = torch.randn((B, T, D), generator=gen, device="cuda").to(torch.bfloat16)
    frames = lens.double()
    n_rows = float(frames.sum())
    sanm = lambda f: f(x, lens, sanm_w, NH, LEFT, kb)
    ops = {"int8": 2.0 * n_rows * (3 * D * D + D * D + 2 * D * H),
           "bfloat16": 4.0 * D * float((frames * frames).sum()), "float32": 2.0 * K * D * n_rows}
    wbytes = 4 * D * D + 2 * D * H + 4 * (3 * D + D + H + D) * 2 + 4 * K * D
    layer = _layer_case(
        torch, f"SenseVoice SANM layer B={B} T={T} lengths 254/204", sanm(SL.fused_sanm_layer),
        sanm(SL.sanm_layer_ref), torch.arange(T, device="cuda")[None, :, None] < lens[:, None, None],
        cuda_ms(lambda: sanm(SL.fused_sanm_layer)), cuda_ms(lambda: sanm(SL.sanm_layer_ref), iters=3),
        2 * 2 * n_rows * D + 4 * B * T + wbytes, ops, lambda: sanm(SL.fused_sanm_layer))
    log(f"sensevoice kernel {layer}")

    qkv = torch.randn((B, T, 3 * D), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    q = q * (D // NH) ** -0.5
    got, want = A.fused_attention(q, k, v, kb, NH), A.attention_ref(q, k, v, kb, NH)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL["bfloat16"],
          f"SenseVoice encoders0 attention: err {err}")
    q4, k4, v4 = (t.unflatten(-1, (NH, D // NH)).transpose(1, 2) for t in (q, k, v))
    mask = kb[:, None, None, :].to(torch.bfloat16)
    bnd, by = bound_ms(2 * (2 * B * T * D + 2 * n_rows * D) + 4 * B * T,
                       {"bfloat16": 4.0 * D * float((frames * frames).sum())})
    attn = dict(case=f"SenseVoice encoders0 attention q/k/v ({B},{T},{D}) bf16, H=4, keys "
                     "254/204", max_abs_err=err, tolerance=ATTN_TOL["bfloat16"],
                ms=cuda_ms(lambda: A.fused_attention(q, k, v, kb, NH), iters=20),
                graph_ms=graph_ms(lambda: A.fused_attention(q, k, v, kb, NH)),
                plain_ms=cuda_ms(lambda: A.attention_ref(q, k, v, kb, NH), iters=3),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, scale=1.0), iters=20),
                bound_ms=bnd, bound_by=by)
    log(f"sensevoice kernel {attn}")

    M = B * T
    a = torch.randint(-127, 128, (M, D), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (V, D), generator=gen, device="cuda", dtype=torch.int8)
    sa = torch.rand(M, generator=gen, device="cuda") * 0.01
    sw = torch.rand(V, generator=gen, device="cuda") * 0.01
    bias = torch.randn(V, generator=gen, device="cuda")
    qd = dict(bias=bias, round_bf16=True, out_dtype=torch.bfloat16)
    equal = torch.equal(G.int8_gemm(a, sa, w, sw, **qd), G.int8_gemm_ref(a, sa, w, sw, **qd))
    torch.cuda.synchronize()
    check(equal, "int8 GEMM at ctc_lo's shape bit-equal to its twin")
    bnd, by = bound_ms(M * D + V * D + 4 * (M + 2 * V) + 2 * M * V, {"int8": 2.0 * M * V * D})
    ms = cuda_ms(lambda: G.int8_gemm(a, sa, w, sw, **qd))
    plan = G.gemm_plan(M, V, D, G.sm_count(0))
    # torch._int_mm's shape rules need N % 8 == 0: it runs on one more
    # weight row (the same work to 0.004 %), and the kernel beside it
    Vp = -(-V // 8) * 8
    wp = torch.cat([w, w[:Vp - V]])
    swp, bp = torch.cat([sw, sw[:Vp - V]]), torch.cat([bias, bias[:Vp - V]])
    ms_aligned = cuda_ms(lambda: G.int8_gemm(a, sa, wp, swp, bias=bp, round_bf16=True,
                                             out_dtype=torch.bfloat16))
    lib = cuda_ms(lambda: torch._int_mm(a, wp.t()))
    gemm = dict(case=f"ctc_lo (QDense, N={V}): ({M}, {D}) x ({V}, {D}) int8 -> bf16",
                max_abs_err=0.0, tolerance=0.0, ms=ms,
                plain_ms=cuda_ms(lambda: G.int8_gemm_ref(a, sa, w, sw, **qd), iters=3),
                library_ms=lib, library=f"torch._int_mm at N={Vp}", ms_over_library=ms / lib,
                bound_ms=bnd, bound_by=by, ms_over_bound=ms / bnd,
                tops=2.0 * M * V * D / ms / 1e9, ms_at_n_multiple_of_8=ms_aligned,
                plan=f"BM={plan.bm} BN={plan.bn} stages={plan.stages} grid={plan.grid} "
                     f"tiles={plan.tiles}")
    log(f"sensevoice kernel {gemm}")
    speed_bar(gemm)  # a served shape: SenseVoice's batches reach M >= 1024
    return dict(sanm_layer=[layer], attention=[attn], int8_gemm=[gemm])


def end_to_end_sensevoice(torch, FK, A, profile_dir, card):
    """SenseVoiceSmall at the full width and depth of configs/sensevoice_small.yaml
    on seeded random weights.  (a) ``SenseVoiceEngine``: three mixed 2-15 s
    batches in float32 and in int8 (``quantize=True``), each with the
    counters read around it and no host sync inside a batch's dispatch;
    float32 kernels against their twins (log-probs 1e-2, frames' argmax
    >= 0.99), int8 kernels against theirs (token lengths equal, log-probs
    1e-3, tokens >= 0.99); alignments and timestamps equal on every row
    whose tokens are equal.  (b) FunASR's README call, ``AutoModel(model=
    SenseVoiceSmall, vad_model=FSMN-VAD, vad_conf=max_single_segment_time
    30 s, quantize=True).generate(wav, language="auto", use_itn=True,
    batch_size_s=60, merge_vad=True, merge_length_s=15)`` of the 600 s
    recording, the VAD's state machine output replaced by the burst plan as
    pipeline run (b) does; counters exact; again on the int8 twins at the
    same bars, the record's text and timestamps equal; once more with
    ``language="zh"``, where the text ITN rewrites at least one segment
    (with "auto" it passes every text through, as in the JAX package).
    ``ctc_lo``'s bias of the number words is raised by the median margin of
    a probe batch, so the random model emits numerals for ITN to rewrite.
    Returns (the launches of every run on the path, summed; e2e record)."""
    import numpy as np

    from funasr_torch.auto import auto_model as AM
    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.auto.engines import SenseVoiceEngine
    from funasr_torch.models.sense_voice.model import N_PROMPT, SenseVoiceSmall
    from funasr_torch.ops import ctc_align as CA
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL
    from funasr_torch.text import inverse_normalize
    from funasr_torch.tokenizer.sensevoice_tokenizer import NUMBER_WORDS
    from funasr_torch.utils.postprocess import join_segment_texts
    from funasr_torch.utils.vad_utils import merge_vad, slice_audio_by_segments

    counters = {"fbank": FK.fused_fbank, "attention": A.fused_attention,
                "sanm_layer": SL.fused_sanm_layer, "decoder_layer": DL.fused_decoder_layer,
                "ffn": FF.fused_ffn_int8, "qmm": QM.quant_matmul,
                "attention_i8qk": A.attention_i8qk, "attention_f32ctx": A.attention_f32ctx,
                "ffn_bf16": FF.fused_ffn, "int8_gemm": G.int8_gemm, "rowquant": RQ.rowquant,
                "int8_gemm_rq": G.int8_gemm_rq, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    t0 = time.time()
    wav, bursts = pipeline_recording(np.random.default_rng(12))
    plan = merge_vad(bursts, 15000)
    cfg = sensevoice_config(torch, FK, wav, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "sensevoice"))
    vad_cfg = dict(FSMN_VAD, model_conf=dict(FSMN_VAD["model_conf"]))  # vad_conf merges in
    am = AutoModel(model=cfg, vad_model=vad_cfg, vad_conf=SV_VAD_CONF, quantize=True, seed=2030)
    eng8, ve = am.engine, am.vad_engine
    model8 = eng8.module
    check(isinstance(eng8, SenseVoiceEngine) and len(model8.encoder.encoders) == 49
          and len(model8.encoder.tp_encoders) == 20 and model8.vocab_size == 25055,
          "SenseVoiceSmall at full width and depth")
    check(ve.model.opts.max_single_segment_time == 30000, "the README call's VAD setting")
    n_params = sum(p.numel() for p in model8.parameters())

    # the number words' ctc_lo bias raised by the median margin of a probe batch
    tok = eng8.tokenizer
    ids = torch.tensor(tok.tokens2ids(NUMBER_WORDS), device="cuda")
    probe = [wav[s * 16: e * 16] for s, e in plan[:4]]
    wav_d, lens_d = eng8._pack(probe)
    with torch.inference_mode():
        feats, flens = eng8.frontend.device_features(wav_d, lens_d)
        enc, el = model8.encode(feats, flens, *eng8._prompts(len(probe), "auto", False))
        logits = model8.ctc.ctc_lo(enc).float()[:, N_PROMPT:]
        valid = torch.arange(logits.shape[1], device="cuda")[None] < (el - N_PROMPT)[:, None]
        margin = (logits.max(-1).values - logits[..., ids].max(-1).values)[valid]
        shift = float(margin.median())
    with torch.no_grad():
        model8.ctc.ctc_lo.bias[ids] += shift
    model8.quantize_weights()
    f32 = SenseVoiceSmall(**{k: cfg[k] for k in ("vocab_size", "input_size", "encoder_conf")},
                          dtype=torch.float32)
    f32.load_state_dict(model8.state_dict(), strict=True)
    eng32 = SenseVoiceEngine(f32, eng8.frontend, tok)
    log(f"e2e sensevoice: AutoModel (int8 SenseVoiceSmall {n_params / 1e6:.1f} M params, "
        f"FSMN-VAD) and the float32 model built in {time.time() - t0:.1f} s; number words' "
        f"ctc_lo bias raised by {shift:.3f}")

    # ---- (a) the engine: three mixed 2-15 s batches, float32 and int8
    rng = np.random.default_rng(30)
    batches = []
    for size in (8, 16, 5):
        n = rng.integers(2 * FS, 15 * FS + 1, size)
        batches.append([waveform(rng, int(m), float(rng.uniform(100, 400))) for m in n])
    e2e = {}
    runs, path_launches = {}, {}
    for name, eng in (("f32", eng32), ("int8", eng8)):
        with guarded_entries(torch, (eng, "transcribe_async")):
            eng.transcribe(batches[0][:2], with_timestamp=True)  # the first call
        torch.cuda.synchronize()
        outs = []
        real_run = eng.run

        def kept(*a, real_run=real_run, outs=outs, **k):
            out = real_run(*a, **k)
            outs.append([t.clone() for t in out])
            return out

        eng.run = kept
        zero()
        t0 = time.time()
        try:
            pending = []
            for b in batches:
                torch.cuda.set_sync_debug_mode("error")  # a host sync here raises
                try:
                    pending.append(eng.transcribe_async(b, with_timestamp=True))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            results = [fin() for fin in pending]
        finally:
            del eng.run
        torch.cuda.synchronize()
        serve_s = time.time() - t0
        launches = read()
        shapes = [sensevoice_shape(b) for b in batches]
        if name == "int8":
            want = sensevoice_launches(Q, A, shapes, len(batches))
        else:
            want = dict.fromkeys(counters, 0)
            want.update(fbank=len(batches), attention=70 * len(batches))
        log(f"e2e sensevoice (a) {name}: served {sum(map(len, batches))} requests in 3 "
            f"batches {shapes} in {serve_s:.3f} s; kernel launches {launches}")
        check(launches == want, f"sensevoice (a) {name} launches {launches}, want {want}")
        for b, res in zip(batches, results):
            check(len(res) == len(b) and all(isinstance(r["text"], str) and r["raw_text"]
                                             and len(r["timestamp"]) == len(r["raw_tokens"])
                                             for r in res), f"sensevoice (a) {name} results")
        runs[name] = (outs, results)
        path_launches[name] = launches
        e2e[f"sensevoice_a_{name}_serve_3_batches_s"] = serve_s
    log(f"e2e sensevoice (a): sample {runs['int8'][1][1][0]['text'][:16]!r} "
        f"{runs['int8'][1][1][0]['timestamp'][:3]}")

    def compare(name, eng, twins, bar_logp, bar_agree, lengths_equal):
        """Kernels against twins on batch 1 (log-probs, frames' argmax) and on
        all three served batches (tokens, alignments, timestamps)."""
        b = batches[1]
        wav_d, lens_d = eng._pack(b)
        prompts = eng._prompts(len(b), "auto", False)

        def log_probs():
            with torch.inference_mode():
                feats, flens = eng.frontend.device_features(wav_d, lens_d)
                return eng.module.log_probs(feats, flens, *prompts)

        lp_k, el = log_probs()
        with twins():
            lp_r, _ = log_probs()
            res_t = [eng.transcribe(bb, with_timestamp=True) for bb in batches]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lp_k).all()), f"sensevoice {name} log-probs finite")
        valid = torch.arange(lp_k.shape[1], device="cuda")[None] < el[:, None]
        err = float((lp_k - lp_r).abs()[valid].max())
        agree = float((lp_k.argmax(-1) == lp_r.argmax(-1))[valid].float().mean())
        rows = same_tok = same_ts = same_len = 0
        for res_k, res_r in zip(runs[name][1], res_t):
            for a, r in zip(res_k, res_r):
                rows += 1
                same_len += len(a["raw_tokens"]) == len(r["raw_tokens"])
                if a["raw_text"] == r["raw_text"]:
                    same_tok += 1
                    same_ts += a["timestamp"] == r["timestamp"]
        rec = dict(logp_max_abs_diff=err, frame_agreement=agree, rows=rows,
                   rows_tokens_equal=same_tok, rows_timestamps_equal_of_those=same_ts,
                   rows_token_lengths_equal=same_len)
        log(f"e2e sensevoice (a) {name} kernels vs twins: {json.dumps(rec)} (tol {bar_logp}, "
            f"agreement >= {bar_agree})")
        check(err <= bar_logp and agree >= bar_agree, f"sensevoice {name}: kernels vs twins")
        check(same_ts == same_tok, f"sensevoice {name}: timestamps equal wherever tokens are")
        if lengths_equal:
            check(same_len == rows, f"sensevoice {name}: token lengths equal")
        return rec

    e2e["sensevoice_a_f32"] = compare("f32", eng32, lambda: plain_twins(FK, A),
                                      E2E_F32_LOGP_TOL, E2E_F32_MIN_AGREE, False)
    e2e["sensevoice_a_int8"] = compare("int8", eng8, int8_twins, E2E_INT8_LOGP_TOL,
                                       E2E_INT8_MIN_AGREE, True)
    del eng32, f32
    torch.cuda.empty_cache()

    # ---- (b) FunASR's README call on the 600 s recording
    texts_seen = []

    def run(name, twins=False, language="auto"):
        clock = StageClock(torch)
        outs = []
        real_segs = ve.model.segments_from_posteriors
        real_run, real_host = eng8.run, eng8._host_results

        def kept_run(*a, **k):
            out = real_run(*a, **k)
            outs.append([t.clone() for t in out])
            return out

        def kept_host(*a, **k):
            res = real_host(*a, **k)
            texts_seen.append((name, [r["text"] for r in res]))
            return res

        def dispatch_no_sync(*a, f=eng8.transcribe_async, **k):
            torch.cuda.set_sync_debug_mode("error")  # a host sync here raises
            try:
                return f(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        segs_seen = []

        def segs(post, db):
            segs_seen.append(real_segs(post, db))
            return plan

        ve.model.segments_from_posteriors = segs
        eng8.run, eng8._host_results = kept_run, kept_host
        eng8.transcribe_async = dispatch_no_sync
        clock.wrap(ve, "front", "vad_device", events=True)
        clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
        clock.wrap(eng8, "transcribe_async", "asr_dispatch")
        clock.wrap(eng8, "run", "asr_device", events=True)
        clock.wrap(eng8, "_host_results", "asr_host")
        clock.wrap(CA, "viterbi", "align_host")
        clock.wrap(AM, "inverse_normalize", "itn_host")
        zero()
        try:
            stack = int8_twins() if twins else contextlib.nullcontext()
            with stack:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = am.generate(wav, key=[name], **dict(SV_README_KW, language=language))[0]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            clock.restore()
            for obj, attr in ((eng8, "run"), (eng8, "_host_results"), (eng8, "transcribe_async"),
                              (ve.model, "segments_from_posteriors")):
                delattr(obj, attr)
        launches = read()
        times = dict(generate_wall_s=wall, audio_s_per_s=PIPELINE_AUDIO_S / wall,
                     vad_device_ms=clock.device_ms("vad_device"),
                     vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                     asr_dispatch_wall_s=clock.wall.get("asr_dispatch", 0.0),
                     asr_device_span_ms=clock.device_ms("asr_device", span=True),
                     asr_host_wall_s=clock.wall.get("asr_host", 0.0),
                     align_host_wall_s=clock.wall.get("align_host", 0.0),
                     itn_host_wall_s=clock.wall.get("itn_host", 0.0))
        return res, launches, outs, times, segs_seen

    res_k, launches_b, outs_k, times_first, segs_seen = run("b")  # new shapes: a first call
    clips = slice_audio_by_segments(wav, plan, FS)
    shapes = [sensevoice_shape([clips[i] for i in batch]) for batch in am.batches(plan, FS, 60)]
    want = sensevoice_launches(Q, A, shapes, 1 + len(shapes))
    log(f"e2e sensevoice (b): the VAD found {len(segs_seen[0])} segments, served the "
        f"{len(plan)} of the burst plan in ASR batches (B, T + 4) {shapes}; kernel launches "
        f"{launches_b}")
    check(launches_b == want, f"sensevoice (b) launches {launches_b}, want {want}")
    ts = res_k["timestamp"]
    check(isinstance(res_k.get("text"), str) and res_k["text"] and len(ts) > 0,
          "sensevoice (b): text and timestamps")
    check(all(a <= b for a, b in ts) and all(0 <= a and b <= PIPELINE_AUDIO_S * 1000
                                             for a, b in ts),
          "sensevoice (b): timestamps within the recording")
    seg_texts = texts_seen[-len(shapes):]
    n_changed_auto = sum(inverse_normalize(t, "auto") != t for _, ts_ in seg_texts for t in ts_)
    check(n_changed_auto == 0, "sensevoice (b): 'auto' names no ITN language")
    res_t, _, outs_t, _, _ = run("b_twins", twins=True)
    same_len = all(torch.equal(a[1], b[1]) for a, b in zip(outs_k, outs_t))
    n_ok = n_all = 0
    em_err = 0.0
    for a, b in zip(outs_k, outs_t):
        valid = torch.arange(a[0].shape[1], device="cuda")[None] < a[1][:, None]
        n_ok += int((a[0] == b[0])[valid].sum())
        n_all += int(valid.sum())
        em_err = max(em_err, float((a[2] - b[2]).abs().max()))
    agree = n_ok / max(n_all, 1)
    same = dict(token_lengths=same_len, text=res_k["text"] == res_t["text"],
                timestamps=ts == res_t["timestamp"])
    log(f"e2e sensevoice (b), kernels vs twins: equal {same}, token agreement {agree:.5f} "
        f"over {n_all} tokens, alignment emissions max |d| {em_err:.3e}")
    check(same_len and agree >= E2E_INT8_MIN_AGREE and em_err <= E2E_INT8_LOGP_TOL,
          "sensevoice (b): int8 kernels against twins")
    check(n_ok < n_all or (same["text"] and same["timestamps"]),
          "sensevoice (b): text and timestamps equal when the tokens are")

    res_zh, _, _, times_zh, _ = run("b_zh", language="zh")
    res_w, _, _, times, _ = run("b_warm")  # the same call again, warm
    zh_texts = [t for name, ts_ in texts_seen if name == "b_zh" for t in ts_]
    n_changed = sum(inverse_normalize(t, "zh") != t for t in zh_texts)
    check(n_changed >= 1, "sensevoice (b) zh: ITN rewrote at least one segment")
    by_segment = dict(zip([i for batch in am.batches(plan, FS, 60) for i in batch], zh_texts))
    joined = join_segment_texts([by_segment[i] for i in range(len(plan)) if by_segment[i]])
    check(res_zh["text"] == inverse_normalize(joined, "zh") != joined,
          "sensevoice (b) zh: the joined text, normalized")
    check(dict(res_w, key="b") == res_k, "sensevoice (b): the warm call gives the first "
          "call's record")
    ve.model.segments_from_posteriors = lambda post, db: plan
    try:
        prof = profile(torch, lambda: am.generate(wav, **SV_README_KW), profile_dir,
                       times["generate_wall_s"] * 1e3, "profile_sensevoice.txt")
    finally:
        del ve.model.segments_from_posteriors
    times.update(idle_share=1.0 - prof["kernel share of batch_ms"],
                 kernel_ms=prof["kernels total"], kernel_launches=prof["kernel launches"])
    log(f"e2e sensevoice (b) on {card}: warm {json.dumps(times)}; the first call "
        f"{json.dumps(times_first)}; language zh: ITN rewrote {n_changed} of {len(zh_texts)} "
        f"segments, itn host {times_zh['itn_host_wall_s']:.4f} s; text {res_k['text'][:24]!r}... "
        f"{len(ts)} stamps")
    e2e["sensevoice_b"] = dict(times, first_call=times_first, zh_call=times_zh,
                               segments=len(plan), batches=shapes, launches=launches_b,
                               vad_segments_found=len(segs_seen[0]), twins_equal=same,
                               twins_token_agreement=agree, emission_max_abs_diff=em_err,
                               itn_segments_changed_zh=n_changed, itn_segments_changed_auto=0,
                               ctc_lo_number_bias_shift=shift)
    e2e["sensevoice_a_launches"] = path_launches
    path_launches["b"] = launches_b
    total = {k: sum(d.get(k, 0) for d in path_launches.values()) for k in counters}
    return total, e2e


# ------------------------- ContextualParaformer hotwords (d), the hybrid's timestamps (e)
CTX_DECODER_LAYERS = 15  # fused int8 decoder layers: att_layer_num 16, the last one contextual
CTX_BIAS_KEYS = (1, 2, 10, 51)  # hotword rows of the bias attention: 1, 2, run (d)'s 10, 50 + 1


def sync_guarded(torch, f):
    """``f`` with ``torch.cuda.set_sync_debug_mode("error")`` around it: a
    host sync inside raises."""
    def call(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return f(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return call


@contextlib.contextmanager
def guarded_entries(torch, *entries):
    """Inside the block each ``(object, method name)`` of ``entries`` runs
    under ``sync_guarded``: a phase's first call (its warm-up) dispatches
    under the guard as its timed calls do, so a host sync on a first call
    (an upload made lazily) fails the run."""
    saved = [(obj, name, name in vars(obj), getattr(obj, name)) for obj, name in entries]
    for obj, name, _, f in saved:
        setattr(obj, name, sync_guarded(torch, f))
    try:
        yield
    finally:
        for obj, name, own, f in reversed(saved):
            if own:
                setattr(obj, name, f)
            else:
                delattr(obj, name)


def contextual_configs():
    """Phase (d)'s configs: ``pipeline_configs()``'s Paraformer-large dict as
    ContextualParaformer (``_flagship``'s widths, its CIF predictor,
    ``inner_dim`` 512, 16 decoder layers of which the last is the contextual
    one; the JAX package carries no contextual YAML), the FSMN-VAD and the
    CT-Transformer of the pipeline."""
    asr, vad, punc = pipeline_configs()
    asr = {k: v for k, v in asr.items() if k != "predictor"}
    return dict(asr, model="ContextualParaformer", decoder="ContextualParaformerDecoder",
                model_conf=dict(asr["model_conf"], inner_dim=512)), vad, punc


def contextual_launches(Q, A, shapes, n_rows, fbank, rounds=0, n_blocks=4):
    """The exact launches of the int8 contextual path: ``fbank`` launches
    and, per served (B, T, U), the int8 layers' blocks (``layer_launches``
    with 15 fused decoder layers), a rowquant + int8 GEMM pair for each
    gated QDense contraction (``qdense_gated``; the last layer's FFN w_1
    and cross-attention k/v; with a hotword memory of ``n_rows`` rows the
    bias attention's k/v, under the gate at these shapes), the bf16 d = 128
    attention of encoder layer 0, of the last layer's cross-attention and,
    with hotwords, of the bias attention; punctuation's d = 32 attention
    ``n_blocks`` a window round."""
    D, H, nd = 512, 2048, CTX_DECODER_LAYERS
    want = dict(fbank=fbank, attention=0, sanm_layer=0, decoder_layer=0, ffn=0, qmm=0,
                attention_i8qk=0, attention_f32ctx=0, ffn_bf16=0, int8_gemm=0, rowquant=0,
                int8_gemm_rq=0, fsmn=0, fsmn_ln=0, attention_d32=rounds * n_blocks)
    for B, T, U in shapes:
        gated = qdense_gated(Q, (B, T, U)) + Q.gate(B * U, H) + Q.gate(B * T, 2 * D)
        if n_rows:
            gated += Q.gate(B * n_rows, 2 * D)
        for k, n in (("attention", 3 if n_rows else 2), ("ffn", 1), ("sanm_layer", 49),
                     ("decoder_layer", nd), ("int8_gemm_rq", 49), ("fsmn_ln", nd),
                     ("rowquant", 49 * 3 + nd * 4 + 1 + 2 + gated),
                     ("int8_gemm", 49 * 3 + nd * 5 + 2 + gated),
                     ("attention_f32ctx", 49 * exact_attention_launches(A, B, T, T)
                      + nd * exact_attention_launches(A, B, U, T))):
            want[k] += n
    want["attention"] += rounds * n_blocks
    return want


def check_bias_attention(torch, A, B, U):
    """The bf16 d = 128 attention at the bias branch's shapes: q (B, U, 512)
    over H = 1, 2, 10 and 51 hotword keys with no key mask (a zero bias), k
    and v column slices of one projection, against its twin (``ATTN_TOL``),
    timed beside the twin and SDPA."""
    import torch.nn.functional as F

    D, NH = 512, 4
    d = D // NH
    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = []
    for H in CTX_BIAS_KEYS:
        q = torch.randn((B, U, D), generator=gen, device="cuda").to(torch.bfloat16) * d ** -0.5
        kv = torch.randn((B, H, 2 * D), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = kv[..., :D], kv[..., D:]
        bias = torch.zeros((B, H), device="cuda")
        got, want = A.fused_attention(q, k, v, bias, NH), A.attention_ref(q, k, v, bias, NH)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL["bfloat16"],
              f"bias attention over {H} hotword keys: err {err}")
        q4, k4, v4 = (t.unflatten(-1, (NH, d)).transpose(1, 2) for t in (q, k, v))
        bnd, by = bound_ms(2 * (2 * B * U * D + 2 * B * H * D) + 4 * B * H,
                           {"bfloat16": 4.0 * D * B * U * H})
        case = dict(case=f"bias attention q ({B}, {U}, {D}) over {H} hotword keys, bf16, "
                         "H=4, no key mask",
                    max_abs_err=err, tolerance=ATTN_TOL["bfloat16"],
                    ms=cuda_ms(lambda: A.fused_attention(q, k, v, bias, NH), iters=20),
                    plain_ms=cuda_ms(lambda: A.attention_ref(q, k, v, bias, NH), iters=5),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, scale=1.0), iters=20),
                    bound_ms=bnd, bound_by=by)
        log(f"contextual kernel {case}")
        cases.append(case)
    return cases


def end_to_end_contextual(torch, FK, A, profile_dir, card):
    """Phase (d): int8 ContextualParaformer at Paraformer-large width on
    seeded random weights, through ``AutoModel(model=ContextualParaformer,
    vad_model=FSMN-VAD, punc_model=CT-Transformer, quantize=True)``, with
    run (c)'s 10 hotwords (no no-bias row: H = 10).  (d1) its
    ``HotwordEngine(seaco=False)``: three mixed 2-15 s batches with the
    hotwords, counters exact (fbank 1, SANM layer 49, FFN 1, decoder layer
    15, d = 128 attention 3 a batch, the blocks and gated QDense) with no
    host sync in a batch's dispatch; each of the first batch's 15 fused
    decoder layers bit-equal to its twin on the same inputs; log-probs of
    the three batches on the int8 twins within 1e-3, tokens >= 0.99, token
    lengths equal; the bias attention at 1-51 keys against its twin.  (d2)
    ``generate`` of the 600 s recording on pipeline (b)'s plan with the
    hotwords (the waveform path; no timestamps: the contextual decode yields
    none), then without (the guarded path, CIF-peak stamps), each with its
    counters exact and no host sync in a dispatch, and each again on the int8
    twins with the record equal; wall, stages and, from a profile of the
    hotword call, the idle share.  Returns (launches of every run on the
    path, summed; e2e record; kernel cases)."""
    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.auto.engines import HotwordEngine
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL
    from funasr_torch.utils.vad_utils import merge_vad, slice_audio_by_segments

    counters = {"fbank": FK.fused_fbank, "attention": A.fused_attention,
                "sanm_layer": SL.fused_sanm_layer, "decoder_layer": DL.fused_decoder_layer,
                "ffn": FF.fused_ffn_int8, "qmm": QM.quant_matmul,
                "attention_i8qk": A.attention_i8qk, "attention_f32ctx": A.attention_f32ctx,
                "ffn_bf16": FF.fused_ffn, "int8_gemm": G.int8_gemm, "rowquant": RQ.rowquant,
                "int8_gemm_rq": G.int8_gemm_rq, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        A.fused_attention.launches_by_head = dict.fromkeys(A.HEAD_SIZES, 0)

    def read():
        out = {k: fn.launches for k, fn in counters.items()}
        out["attention_d32"] = A.fused_attention.launches_by_head[32]
        return out

    t0 = time.time()
    asr_cfg, vad_cfg, punc_cfg = contextual_configs()
    am = AutoModel(model=asr_cfg, vad_model=vad_cfg, punc_model=punc_cfg, quantize=True,
                   seed=2031)
    eng, ve, pm = am.engine, am.vad_engine, am.punc_engine.model
    model = eng.module
    check(isinstance(eng, HotwordEngine) and not eng.seaco and not eng.from_fbank
          and len(model.encoder.encoders) == 49 and model.vocab_size == FLAGSHIP["vocab_size"]
          and len(model.decoder.decoders) == CTX_DECODER_LAYERS
          and model.decoder.last_decoder.int8 is None,
          "ContextualParaformer at Paraformer-large width, 15 fused decoder layers")
    words = hotword_list(np.random.default_rng(14), asr_cfg["tokenizer_conf"]["token_list"], -1)
    hotword = " ".join(words)
    grid = eng.encode_hotwords(hotword)
    n_rows = int(grid.pad.shape[0])
    check(n_rows == N_HOTWORDS, f"contextual hotword grid rows {n_rows} (no no-bias row)")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"e2e contextual: AutoModel (int8 ContextualParaformer {n_params / 1e6:.1f} M params, "
        f"FSMN-VAD, CT-Transformer) built in {time.time() - t0:.1f} s; hotwords {words}")

    # ---- (d1) the engine: three mixed 2-15 s batches with the hotwords
    rng = np.random.default_rng(31)
    batches = []
    for size in (8, 16, 5):
        n = rng.integers(2 * FS, 15 * FS + 1, size)
        batches.append([waveform(rng, int(m), float(rng.uniform(100, 400))) for m in n])
    with guarded_entries(torch, (eng, "transcribe_async")):
        eng.transcribe(batches[0][:2], hotword=grid)  # the first call, under the guard
    torch.cuda.synchronize()
    dec_calls = []

    def kept_dec(layer, args, out):
        if len(dec_calls) < CTX_DECODER_LAYERS:  # the first batch's layers
            dec_calls.append((layer, args, out.clone()))

    hooks = [layer.register_forward_hook(kept_dec) for layer in model.decoder.decoders]
    zero()
    t0 = time.time()
    try:
        dispatch = sync_guarded(torch, eng.transcribe_async)
        pending = [dispatch(b, hotword=grid) for b in batches]
        results = [fin() for fin in pending]
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches_d1 = read()
    shapes = [served_shape(eng, b) for b in batches]
    want = contextual_launches(Q, A, shapes, n_rows, len(batches))
    log(f"e2e contextual (d1): served {sum(map(len, batches))} requests in 3 batches (B, T, U) "
        f"{shapes} in {serve_s:.3f} s; kernel launches {launches_d1}")
    check(launches_d1 == want, f"contextual (d1) launches {launches_d1}, want {want}")
    for b, res in zip(batches, results):
        check(len(res) == len(b) and all(isinstance(r["text"], str) and "timestamp" not in r
                                         for r in res), "contextual (d1) results")
    # DecoderLayerSANM.forward(tgt, tgt_mask, memory, mem_bias, tgt_lengths,
    # mem_lengths, memory_q) -> its fused layer's twin on the same operands
    n_equal = sum(bool(torch.equal(out, DL.decoder_layer_ref(
        x.to(layer.dtype), mem.to(layer.dtype), tl, ml, layer.int8(layer), layer.n_head,
        layer.self_attn.left, mb, mq))) for layer, (x, _, mem, mb, tl, ml, mq), out in dec_calls)
    check(len(dec_calls) == CTX_DECODER_LAYERS and n_equal == len(dec_calls),
          f"contextual (d1): {n_equal} of {len(dec_calls)} fused decoder layers bit-equal")
    B0, T0, U0 = shapes[0]
    dec_case = dict(case=f"the contextual decoder's {CTX_DECODER_LAYERS} fused layers on served "
                         f"batch 0 (B={B0}, U={U0}, T={T0}), each on its own inputs",
                    max_abs_err=0.0 if n_equal == len(dec_calls) else None, tolerance=0.0,
                    bit_equal_layers=n_equal)
    log(f"contextual kernel {dec_case}")

    def logprobs(b):
        wav_d, lens_d = eng._pack(b)
        with torch.inference_mode():
            feats, flens = eng.frontend.device_features(wav_d, lens_d)
            return model.hotword_logprobs(feats, flens, grid.pad, grid.lengths,
                                          eng._max_tokens(wav_d.shape[1]))[:2]

    err = 0.0
    n_ok = n_all = 0
    same_len = True
    for b in batches:
        lp_k, tl_k = logprobs(b)
        with int8_twins():
            lp_r, tl_r = logprobs(b)
        valid = torch.arange(lp_k.shape[1], device="cuda")[None] < tl_k[:, None]
        check(bool(torch.isfinite(lp_k[valid]).all()), "contextual log-probs finite")
        err = max(err, float((lp_k - lp_r).abs()[valid].max()))
        n_ok += int((lp_k.argmax(-1) == lp_r.argmax(-1))[valid].sum())
        n_all += int(valid.sum())
        same_len = same_len and bool(torch.equal(tl_k, tl_r))
    agree = n_ok / max(n_all, 1)
    log(f"e2e contextual (d1), int8 kernels vs twins: max |dlogp| {err:.3e} (tol "
        f"{E2E_INT8_LOGP_TOL}), token agreement {agree:.5f} over {n_all}, token lengths "
        f"equal {same_len}")
    check(err <= E2E_INT8_LOGP_TOL and agree >= E2E_INT8_MIN_AGREE and same_len,
          "contextual (d1): int8 kernels against twins")
    attn_cases = check_bias_attention(torch, A, B0, U0)
    e2e = {"contextual_d1": dict(serve_3_batches_s=serve_s, batches=shapes, launches=launches_d1,
                                 logp_max_abs_diff=err, token_agreement=agree,
                                 token_lengths_equal=same_len, decoder_layers_bit_equal=n_equal)}

    # ---- (d2) the pipeline on the 600 s recording, with and without hotwords
    wav, bursts = pipeline_recording(np.random.default_rng(12))
    plan = merge_vad(bursts, 15000)
    clips = slice_audio_by_segments(wav, plan, FS)
    pshapes = [served_shape(eng, [clips[i] for i in batch])
               for batch in am.batches(plan, FS, 300)]

    def run(name, hw, twins=False):
        clock = StageClock(torch)
        rounds = [0]
        real_argmax = pm._argmax

        def counted_argmax(text, lens):
            rounds[0] += 1
            return real_argmax(text, lens)

        pm._argmax = counted_argmax
        eng.transcribe_async = sync_guarded(torch, eng.transcribe_async)
        ve.model.segments_from_posteriors = (
            lambda post, db, f=ve.model.segments_from_posteriors: (f(post, db), plan)[1])
        clock.wrap(ve, "front", "vad_device", events=True)
        clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
        clock.wrap(eng, "transcribe_async", "asr_dispatch")
        clock.wrap(eng, "run_hw" if hw else "run", "asr_device", events=True)
        clock.wrap(eng, "_text_results" if hw else "_host_results", "asr_host")
        clock.wrap(pm, "inference_batch", "punc")
        zero()
        try:
            with int8_twins() if twins else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = am.generate(wav, key=["d2"], **({"hotword": hw} if hw else {}))[0]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            clock.restore()
            for obj, attr in ((pm, "_argmax"), (eng, "transcribe_async"),
                              (ve.model, "segments_from_posteriors")):
                delattr(obj, attr)
        times = dict(generate_wall_s=wall, audio_s_per_s=PIPELINE_AUDIO_S / wall,
                     vad_device_ms=clock.device_ms("vad_device"),
                     vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                     asr_dispatch_wall_s=clock.wall.get("asr_dispatch", 0.0),
                     asr_device_span_ms=clock.device_ms("asr_device", span=True),
                     asr_host_wall_s=clock.wall.get("asr_host", 0.0),
                     punc_wall_s=clock.wall.get("punc", 0.0), punc_rounds=rounds[0])
        return res, read(), rounds[0], times

    first = run("first", hotword)[-1]  # the first call at these shapes
    path_launches = {"d1": launches_d1}
    for name, hw, rows in (("hotword", hotword, n_rows), ("no_hotword", None, None)):
        res, launches, rounds, times = run(name, hw)
        want = contextual_launches(Q, A, pshapes, rows, 1 + len(pshapes), rounds)
        log(f"e2e contextual (d2) {name}: {len(plan)} segments in ASR batches (B, T, U) "
            f"{pshapes}, {rounds} punctuation rounds; kernel launches {launches}")
        check(launches == want, f"contextual (d2) {name} launches {launches}, want {want}")
        ts = res.get("timestamp")
        # with hotwords the decode yields no stamps, so no sentence has a span
        check(isinstance(res.get("text"), str) and res["text"]
              and (ts == [] == res["sentence_info"] if hw else ts and res["sentence_info"]),
              f"contextual (d2) {name}: the record")
        check(all(0 <= b <= e <= PIPELINE_AUDIO_S * 1000 for b, e in ts),
              f"contextual (d2) {name}: timestamps within the recording")
        res_t, _, _, times_t = run(name + "_twins", hw, twins=True)
        check(res_t == res, f"contextual (d2) {name}: the record on the int8 twins equals it")
        log(f"e2e contextual (d2) {name} on {card}: {json.dumps(times)}; text "
            f"{res['text'][:24]}... {len(ts)} stamps, {len(res['sentence_info'])} sentences; "
            f"equal on the twins (their run {times_t['generate_wall_s']:.3f} s)")
        e2e[f"contextual_d2_{name}"] = dict(times, segments=len(plan), batches=pshapes,
                                            launches=launches, twins_record_equal=True)
        path_launches[name] = launches
    e2e["contextual_d2_hotword"]["first_call"] = first
    ve.model.segments_from_posteriors = lambda post, db: plan
    try:
        prof = profile(torch, lambda: am.generate(wav, hotword=hotword), profile_dir,
                       e2e["contextual_d2_hotword"]["generate_wall_s"] * 1e3,
                       "profile_contextual.txt")
    finally:
        del ve.model.segments_from_posteriors
    e2e["contextual_d2_hotword"].update(idle_share=1.0 - prof["kernel share of batch_ms"],
                                        kernel_ms=prof["kernels total"],
                                        kernel_launches=prof["kernel launches"])
    log(f"e2e contextual (d2) hotword: idle share "
        f"{e2e['contextual_d2_hotword']['idle_share']:.4f}")
    del am
    torch.cuda.empty_cache()
    total = {k: sum(d.get(k, 0) for d in path_launches.values()) for k in read()}
    return total, e2e, dict(attention=attn_cases, decoder_layer=[dec_case])


def hybrid_configs():
    """Phase (e)'s configs: ``configs/conformer_hybrid.yaml`` as a dict (the
    AutoModel defaults: beam 10, maxlen 96, CTC weight 0.3; 80 mels, no LFR;
    a single-CJK-char vocabulary of 4233), the pipeline's FSMN-VAD and
    CT-Transformer."""
    _, vad, punc = pipeline_configs()
    c = CONFORMER_HYBRID
    V = c["vocab_size"]
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(V - 4)] + ["<unk>"]
    hybrid = dict(model="Conformer", vocab_size=V, input_size=c["input_size"],
                  encoder_conf=c["encoder_conf"], decoder_conf=c["decoder_conf"],
                  model_conf=dict(ctc_weight=c["ctc_weight"], lsm_weight=c["lsm_weight"]),
                  frontend_conf=dict(fs=FS, n_mels=80, lfr_m=1, lfr_n=1),
                  decoding_conf=dict(beam_size=10, maxlenratio_tokens=96,
                                     decoding_ctc_weight=0.3),
                  tokenizer_conf=dict(token_list=tokens))
    return hybrid, vad, punc


def beam_twins(CP):
    """The beam path's twins: the CTC prefix step, the WKV recurrence (the
    RWKV decoder) and the int8 blocks."""
    from funasr_torch.ops import wkv as W

    stack = contextlib.ExitStack()
    stack.enter_context(swapped([(CP, "ctc_prefix_step", CP.ctc_prefix_step_ref),
                                 (W, "wkv", W.wkv_ref)]))
    stack.enter_context(int8_twins())
    return stack


def hybrid_counters(FK, A, CP):
    """The hybrid phases' launch counters: (zero, read)."""
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL

    from funasr_torch.ops import wkv as W

    counters = {"ctc_prefix_step": CP.ctc_prefix_step, "ctc_prefix": CP.ctc_recurrence,
                "fbank": FK.fused_fbank, "int8_gemm": G.int8_gemm, "rowquant": RQ.rowquant,
                "attention": A.fused_attention, "sanm_layer": SL.fused_sanm_layer,
                "decoder_layer": DL.fused_decoder_layer, "ffn": FF.fused_ffn_int8,
                "int8_gemm_rq": G.int8_gemm_rq, "fsmn": FM.fsmn, "fsmn_ln": FM.fsmn_ln,
                "attention_f32ctx": A.attention_f32ctx, "wkv": W.wkv}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        A.fused_attention.launches_by_head = dict.fromkeys(A.HEAD_SIZES, 0)
        A.fused_attention.launches_alibi = 0
        A.attention_f32ctx.launches_by_head = dict.fromkeys(A.EXACT_HEAD_SIZES, 0)

    def read():
        out = {k: fn.launches for k, fn in counters.items()}
        out["attention_d32"] = A.fused_attention.launches_by_head[32]
        out["attention_d64"] = A.fused_attention.launches_by_head[64]
        out["attention_alibi64"] = A.fused_attention.launches_alibi
        out["attention_f32ctx_d64"] = A.attention_f32ctx.launches_by_head[64]
        return out

    return zero, read


# The int8 layers of each served hybrid under quantize=True, stated from the
# JAX package's QDense / nn.Dense layout at the served widths (D = 256, 12
# encoder blocks, 6 decoder blocks, vocab 4233 or 4234): the fused int8 FFNs
# (``sanm.PositionwiseFeedForward``, fused at every row count) and the output
# widths N of the QDense layers with N >= 1024, the only ones the int8 gate
# can pass.  Every other projection has N <= 512 or is a plain ``nn.Dense``
# that never takes int8 (the cgMLP's channel_proj1/2, merge_proj, the
# Branchformer linear embed, ``ctc.ctc_lo``, the RWKV time mix).  ``enc``:
# one encoder pass; ``dec``: one full-prefix decoder call (the cached
# scorer's B x beam rows pass no gate).
HYBRID_INT8 = {
    # 12 blocks x 2 macaron FFN w_1 (linear_units 2048)
    "conformer": dict(enc_ffn=0, enc_dense=(2048,) * 24, dec_ffn=0, dec_dense=()),
    # 12 position-wise FFNs, 256 -> 2048 -> 256
    "transformer": dict(enc_ffn=12, enc_dense=(), dec_ffn=0, dec_dense=()),
    # none: the cgMLP and merge_proj are plain
    "branchformer": dict(enc_ffn=0, enc_dense=(), dec_ffn=0, dec_dense=()),
    # 12 blocks x 2 macaron FFN w_1 (linear_units 1024; w_2 has N = 256)
    "ebranchformer": dict(enc_ffn=0, enc_dense=(1024,) * 24, dec_ffn=0, dec_dense=()),
    # the Conformer's 24 w_1; a decoder call: 6 position-wise FFNs, the
    # output layer (N = 4234) and (not int8) 6 WKV launches, one a time mix
    "conformer_rwkv": dict(enc_ffn=0, enc_dense=(2048,) * 24, dec_ffn=6, dec_dense=(4234,),
                           dec_wkv=6),
    # the SANM encoder (phase (g3)): encoders0 off the fused path (its
    # attention the d = 64 kernel, its FFN fused int8, its projections of N
    # 768 and 256 under the gate), then 11 fused int8 SANM layers; 4 heads
    "sanm": dict(enc_ffn=1, enc_dense=(), dec_ffn=0, dec_dense=(), enc_sanm=11,
                 enc_attention=1),
}
INT8_MIN_ROWS = INT8_MIN_N = 1024  # the JAX package's int8 gate (ops/quant.py:69-70)


def hybrid_batch_launches(layout, B, n_samples, beam, maxlen, dec_calls):
    """The int8 (and WKV) launches of one hybrid batch of B x ``n_samples`` by the
    stated layout ``HYBRID_INT8[layout]``: a fused int8 FFN is one ``ffn``
    launch of two rowquant and two int8 GEMM launches; a QDense of N
    outputs whose rows M pass the gate (M, N >= 1024) is one rowquant and
    one int8 GEMM, the encoder's at B x frames rows, the full-prefix
    decoder's at B x beam x (maxlen + 1) rows once a call."""
    lay = HYBRID_INT8[layout]

    def gated(rows, widths):
        return sum(rows >= INT8_MIN_ROWS and n >= INT8_MIN_N for n in widths)

    f = lay["enc_ffn"] + dec_calls * lay["dec_ffn"]
    q = (gated(B * encoder_frames(n_samples), lay["enc_dense"])
         + dec_calls * gated(B * beam * (maxlen + 1), lay["dec_dense"]))
    s = lay.get("enc_sanm", 0)  # a fused SANM layer: three pairs, wout, attention
    out = dict(ffn=f, int8_gemm=2 * f + q + 3 * s, rowquant=2 * f + q + 3 * s,
               wkv=dec_calls * lay.get("dec_wkv", 0))
    if s:
        from funasr_torch.ops import attention as A

        T = padded_frames(n_samples)  # no subsampling
        n_att = s * exact_attention_launches(A, B, T, T)
        out.update(sanm_layer=s, int8_gemm_rq=s, attention_f32ctx=n_att,
                   attention_f32ctx_d64=n_att, attention=lay["enc_attention"],
                   attention_d64=lay["enc_attention"])
    return out


def hybrid_generate(torch, CP, am, zero, read, wav, plan, name, layout, twins=False):
    """One ``generate`` of ``wav`` by a hybrid ``AutoModel`` behind its VAD
    and punctuation, the VAD's segments replaced by ``plan``: every counter
    held to its exact count (fbank once for the VAD and once a batch, the
    CTC step one a decode step, the int8 launches of each batch by
    ``hybrid_batch_launches`` of ``layout``, punctuation's d = 32 attention
    once a layer a window round); ``twins`` swaps the CTC step and the int8 blocks for
    their twins.  Returns (record, launches, stage times, batch shapes)."""
    from funasr_torch.models.transformer import model as TM
    from funasr_torch.utils.vad_utils import slice_audio_by_segments

    eng, ve, pm = am.engine, am.vad_engine, am.punc_engine.model
    clock = StageClock(torch)
    rounds = [0]
    real_argmax = pm._argmax

    def counted_argmax(text, lens):
        rounds[0] += 1
        return real_argmax(text, lens)

    pm._argmax = counted_argmax
    ve.model.segments_from_posteriors = (
        lambda post, db, f=ve.model.segments_from_posteriors: (f(post, db), plan)[1])
    clock.wrap(ve, "front", "vad_device", events=True)
    clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
    clock.wrap(eng, "run", "asr_beam", events=True)
    clock.wrap(TM, "viterbi", "align_host")
    clock.wrap(pm, "inference_batch", "punc")
    zero()
    steps0 = eng.steps
    try:
        with beam_twins(CP) if twins else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = am.generate(wav, key=["e2"])[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        clock.restore()
        for obj, attr in ((pm, "_argmax"), (ve.model, "segments_from_posteriors")):
            delattr(obj, attr)
    clips = slice_audio_by_segments(wav, plan, FS)
    shapes = [(len(batch), max(len(clips[i]) for i in batch))
              for batch in am.batches(plan, FS, 300)]
    steps = eng.steps - steps0
    n_blocks = 4  # punctuation's layers
    want = dict.fromkeys(read(), 0)
    want.update(ctc_prefix_step=steps, fbank=1 + len(shapes),
                attention=rounds[0] * n_blocks, attention_d32=rounds[0] * n_blocks)
    if not twins:  # the swapped kernels launch nothing
        for B, N in shapes:
            for k, v in hybrid_batch_launches(layout, B, N, eng.beam, eng.maxlen,
                                              0).items():
                want[k] += v
    else:
        want.update(ctc_prefix_step=0)
    times = dict(generate_wall_s=wall, audio_s_per_s=len(wav) / FS / wall,
                 vad_device_ms=clock.device_ms("vad_device"),
                 vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                 asr_beam_wall_s=clock.wall.get("asr_beam", 0.0),
                 asr_beam_span_ms=clock.device_ms("asr_beam", span=True),
                 align_host_wall_s=clock.wall.get("align_host", 0.0),
                 punc_wall_s=clock.wall.get("punc", 0.0), punc_rounds=rounds[0],
                 decode_steps=steps)
    launches = read()
    log(f"e2e hybrid {name}: {len(plan)} segments in batches (B, samples) {shapes}; "
        f"kernel launches {launches}")
    check(launches == want, f"hybrid {name} launches {launches}, want {want}")
    ts = res.get("timestamp", [])
    check(isinstance(res.get("text"), str) and res["text"] and len(ts) > 0
          and res.get("sentence_info"), f"hybrid {name}: text, stamps, sentence_info")
    check(all(0 <= b <= e <= len(wav) // 16 for b, e in ts),
          f"hybrid {name}: timestamps within the recording")
    return res, launches, times, shapes


def hybrid_pipeline(torch, CP, am, zero, read, tag, layout, cut=120):
    """``generate`` with CTC-alignment timestamps of the 600 s recording on
    pipeline (b)'s plan, twice (the first call at these shapes, then the
    timed one), and its first ``cut`` s on the kernels and on the twins,
    the records equal.  Returns (launches of the three kernel runs, record)."""
    import numpy as np

    from funasr_torch.utils.vad_utils import merge_vad

    wav, bursts = pipeline_recording(np.random.default_rng(12))
    plan = merge_vad(bursts, 15000)
    first = hybrid_generate(torch, CP, am, zero, read, wav, plan, f"{tag} first", layout)[2]
    res, launches, times, shapes = hybrid_generate(torch, CP, am, zero, read, wav, plan,
                                                   f"{tag} 600 s", layout)
    log(f"e2e hybrid {tag} 600 s: {json.dumps(times)}; the first call {json.dumps(first)}; "
        f"text {res['text'][:24]}... {len(res['timestamp'])} stamps, "
        f"{len(res['sentence_info'])} sentences")
    wav_c, plan_c = wav[: cut * FS], [s for s in plan if s[1] <= cut * 1000]
    res_c, launches_c, times_c, shapes_c = hybrid_generate(
        torch, CP, am, zero, read, wav_c, plan_c, f"{tag} first {cut} s", layout)
    res_ct, _, times_ct, _ = hybrid_generate(torch, CP, am, zero, read, wav_c, plan_c,
                                             f"{tag} first {cut} s on the twins", layout,
                                             twins=True)
    check(res_ct == res_c, f"hybrid {tag}: the first {cut} s' record on the twins equals it")
    log(f"e2e hybrid {tag} first {cut} s ({len(plan_c)} segments, batches {shapes_c}): "
        f"kernels {times_c['generate_wall_s']:.3f} s, twins "
        f"{times_ct['generate_wall_s']:.3f} s; records equal")
    total = {k: launches[k] + launches_c[k] for k in launches}
    return total, {tag: dict(times, first_call=first, segments=len(plan), batches=shapes,
                             launches=launches),
                   f"{tag}_cut": dict(times_c, seconds=cut, segments=len(plan_c),
                                      batches=shapes_c,
                                      twins_wall_s=times_ct["generate_wall_s"],
                                      twins_record_equal=True)}


def expected_stamps(words, ids, blank=0):
    """The stamps of one hypothesis (``words`` its token strings, ``ids``
    its ids; a vocabulary without '▁'): its CTC alignment gives each
    non-blank id one label run and each run a stamp, the runs taking the
    words in order from the first (``_ctc_align_timestamps``), and
    ``sentence_postprocess`` keeps a stamp where it keeps the word at its
    index (not a ``<...>`` token).  A blank id among the ids is a word
    (``<blank>``) but no run, so such a hypothesis's stamps fall short of
    its words: the first (non-blank ids) words, the kept ones counted."""
    n_runs = sum(i != blank for i in ids)
    return sum(1 for w in words[:n_runs]
               if w.strip() and not (w.strip().startswith("<") and w.strip().endswith(">")))


def compare_nbest(res_k, res_t, al_k, al_t, K, tag, tokenizer):
    """Kernels against twins, hypothesis by hypothesis (``K`` a row): tokens
    equal, |dscore| within ``BEAM_F32_SCORE_TOL``, alignments and timestamps
    equal; the 1-best equal to nbest[0]; each hypothesis's stamps exactly
    ``expected_stamps`` (a stamp a kept token where it holds no blank id;
    the beam takes blank as a candidate, as the JAX package's prefix scorer
    does, and the alignment gives that token no run).  Returns (hypotheses,
    max |dscore|)."""
    import numpy as np

    tok_ok = ts_ok = al_ok = rows = with_blank = 0
    d_score = 0.0
    for i, (rk, rt) in enumerate(zip(res_k, res_t)):
        check(rk["timestamp"] == rk["nbest"][0]["timestamp"], f"{tag}: 1-best = nbest[0]")
        for k, (hk, ht) in enumerate(zip(rk["nbest"], rt["nbest"])):
            rows += 1
            has_blank = 0 in hk["tokens"]
            with_blank += has_blank
            words = tokenizer.ids2tokens(hk["tokens"])
            want = expected_stamps(words, hk["tokens"])
            check(len(hk["timestamp"]) == want
                  and (has_blank or want == len(hk["raw_tokens"])),
                  f"{tag}: row {i} hypothesis {k}: {len(hk['timestamp'])} stamps, want "
                  f"{want} (a stamp a token but for blank ids), tokens {hk['tokens']}")
            d_score = max(d_score, abs(hk["score"] - ht["score"]))
            if hk["tokens"] == ht["tokens"]:
                tok_ok += 1
                ts_ok += hk["timestamp"] == ht["timestamp"]
                al_ok += bool(np.array_equal(al_k[i * K + k], al_t[i * K + k]))
    log(f"{tag} twins: {tok_ok} of {rows} hypotheses' tokens equal, alignments {al_ok} and "
        f"timestamps {ts_ok} of those equal, max |dscore| {d_score:.3e} "
        f"(tol {BEAM_F32_SCORE_TOL}); {with_blank} hypotheses hold the blank id, their "
        f"stamps held to the count of their non-blank runs")
    check(tok_ok == rows and al_ok == rows and ts_ok == rows
          and d_score <= BEAM_F32_SCORE_TOL, f"{tag}: kernels against twins")
    return rows, d_score


def end_to_end_hybrid(torch, FK, A, CP, card):
    """Phase (e): the Conformer of ``configs/conformer_hybrid.yaml`` (int8
    weights, bf16) on seeded random weights through ``AutoModel(model=
    Conformer, vad_model=FSMN-VAD, punc_model=CT-Transformer,
    quantize=True)``.  (e1) the beam cell's B = 32 x 15 s batch through
    ``HybridEngine.transcribe(nbest=3, with_timestamp=True)`` (the beam
    cell's serving, int8 KV, on the same module): counters exact (CTC prefix
    step one a decode step, fbank 1, the gated FFN w_1 pairs), timed beside
    the call without timestamps, the host Viterbi's seconds and the bytes
    read back; on the twins (CTC step, int8 blocks) tokens equal, scores
    within ``BEAM_F32_SCORE_TOL``, alignments and timestamps equal on every
    row whose tokens are.  (e2) ``generate`` with timestamps of the 600 s
    recording on pipeline (b)'s plan, counters exact, timed by wall clock
    and stages; its first 120 s (the plan's segments inside them) on the
    kernels and on the twins, the records equal.  Returns (launches, e2e
    record)."""
    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.auto.engines import HybridEngine
    from funasr_torch.models.transformer import model as TM

    zero, read = hybrid_counters(FK, A, CP)
    t0 = time.time()
    hybrid_cfg, vad_cfg, punc_cfg = hybrid_configs()
    am = AutoModel(model=hybrid_cfg, vad_model=vad_cfg, punc_model=punc_cfg, quantize=True,
                   seed=2032)
    eng = am.engine
    check(isinstance(eng, HybridEngine) and eng.beam == 10 and eng.maxlen == 96
          and len(eng.module.encoder.encoders) == 12, "the hybrid at conformer_hybrid.yaml")
    served = HybridEngine(eng.module, eng.frontend, eng.tokenizer, **BEAM_SERVING)
    log(f"e2e hybrid: AutoModel (int8 Conformer hybrid, FSMN-VAD, CT-Transformer) built in "
        f"{time.time() - t0:.1f} s")

    # ---- (e1) the beam cell's batch with timestamps
    B, N, K = 32, 15 * FS, 3
    rng = np.random.default_rng(1)
    wavs = [waveform(rng, N, 150.0 + 7 * i) for i in range(B)]
    served.transcribe(wavs[:2], nbest=K, with_timestamp=True)  # warm-up
    torch.cuda.synchronize()
    seen = {"em": [], "align": [], "viterbi_s": []}
    real_em, real_vit = TM.align_emissions, TM.viterbi

    def kept_em(*a, **k):
        out = real_em(*a, **k)
        seen["em"].append(tuple(out.shape))
        return out

    def kept_vit(*a, **k):
        t = time.perf_counter()
        out = real_vit(*a, **k)
        seen["viterbi_s"].append(time.perf_counter() - t)
        seen["align"].append(out)
        return out

    def timed(f):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    TM.align_emissions, TM.viterbi = kept_em, kept_vit
    zero()
    steps0 = served.steps
    try:
        res_k, ms_ts = timed(lambda: served.transcribe(wavs, nbest=K, with_timestamp=True))
        launches_e1 = read()
        steps = served.steps - steps0
        _, ms_plain = timed(lambda: served.transcribe(wavs, nbest=K))
        with beam_twins(CP):
            res_t = served.transcribe(wavs, nbest=K, with_timestamp=True)
    finally:
        TM.align_emissions, TM.viterbi = real_em, real_vit
    want = dict.fromkeys(read(), 0)
    want.update(ctc_prefix_step=steps, fbank=1,
                **hybrid_batch_launches("conformer", B, N, served.beam, served.maxlen, 0))
    log(f"e2e hybrid (e1): B={B} x 15 s, nbest={K} with timestamps, {steps} decode steps; "
        f"kernel launches {launches_e1}")
    check(steps > 0 and launches_e1 == want, f"hybrid (e1) launches {launches_e1}, want {want}")
    em_shape = seen["em"][0]
    read_back = 4 * int(np.prod(em_shape))
    log(f"e2e hybrid (e1) on {card}: transcribe with timestamps {ms_ts:.1f} ms, without "
        f"{ms_plain:.1f} ms (wall); host Viterbi {seen['viterbi_s'][:1]} s a batch; "
        f"emissions {em_shape} float32 = {read_back} bytes read back")
    rows, d_score = compare_nbest(res_k, res_t, seen["align"][0], seen["align"][-1], K,
                                  "hybrid (e1)", served.tokenizer)
    e2e = {"hybrid_e1": dict(transcribe_ts_ms=ms_ts, transcribe_ms=ms_plain,
                             steps=steps, viterbi_host_s=seen["viterbi_s"][:1],
                             emissions_shape=em_shape, bytes_read_back=read_back,
                             launches=launches_e1, twins_hypotheses_equal=rows,
                             twins_max_abs_dscore=d_score)}

    # ---- (e2) the pipeline with timestamps: 600 s, then its first 120 s on the twins
    launches_e2, rec = hybrid_pipeline(torch, CP, am, zero, read, "hybrid_e2", "conformer")
    e2e.update(rec)
    del am, served
    torch.cuda.empty_cache()
    total = {k: launches_e1[k] + launches_e2[k] for k in launches_e1}
    return total, e2e


# phase (f): the aishell recipes, each with its served batch (B x 15 s)
AISHELL_RECIPES = (
    ("transformer", "examples/aishell/transformer/conf/transformer_12e_6d_2048_256.yaml", 32),
    ("branchformer", "examples/aishell/branchformer/conf/branchformer_12e_6d_2048_256.yaml",
     32),
    ("ebranchformer",
     "examples/aishell/e_branchformer/conf/e_branchformer_12e_6d_2048_256.yaml", 32),
    ("conformer_rwkv", "examples/aishell/conformer/conf/conformer_rwkv.yaml", 8),
)


def aishell_model(name, path, **kw):
    """``AutoModel(model=<the recipe's YAML>, quantize=True)`` on seeded
    random weights, with a 4234-entry single-CJK-char token list (the
    recipes name ``CharTokenizer`` and no list)."""
    from funasr_torch.auto.auto_model import AutoModel

    V = 4234
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(V - 4)] + ["<unk>"]
    here = os.path.dirname(os.path.abspath(__file__))
    seed = 2040 + [r[0] for r in AISHELL_RECIPES].index(name)
    return AutoModel(model=os.path.join(here, path),
                     model_conf=dict(tokenizer_conf=dict(token_list=tokens)),
                     quantize=True, seed=seed, **kw)


def hybrid_recipe_batch(torch, A, CP, card, am, name, B, zero, read, tag):
    """One aishell-width hybrid (``am`` its ``AutoModel``, ``name`` its layout
    in ``HYBRID_INT8``) on B x 15 s through ``HybridEngine(**BEAM_SERVING)
    .transcribe(nbest=3, with_timestamp=True)``: counters exact, no host sync
    in the batch's dispatch but the beam's one a step and the read back, the
    twins' hypotheses equal (``compare_nbest``); a full-prefix decoder also
    timed and profiled one call.  Returns (launches, record)."""
    import numpy as np

    from funasr_torch.auto.engines import HybridEngine
    from funasr_torch.models.transformer import model as TM
    from funasr_torch.ops import beam_search as TB

    N, K = 15 * FS, 3

    def lifted(f):
        """``f`` with the sync debug mode off: the beam's allowed syncs."""
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return f(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    eng = am.engine
    module = eng.module
    encoder = module.encoder
    check(isinstance(eng, HybridEngine) and (eng.beam, eng.maxlen) == (10, 96)
          and len(getattr(encoder, "encoders0", ())) + len(encoder.encoders) == 12
          and len(module.decoder.decoders) == 6
          and encoder.output_size() == 256 and module.vocab_size == 4234,
          f"{tag} {name}: the recipe's widths and decoding")
    full_prefix = type(module.decoder).__name__ == "TransformerRWKVDecoder"
    served = HybridEngine(module, eng.frontend, eng.tokenizer, **BEAM_SERVING)
    log(f"e2e {tag} {name}: {type(module).__name__} + {type(module.encoder).__name__} + "
        f"{type(module.decoder).__name__}")
    rng = np.random.default_rng(3)
    wavs = [waveform(rng, N, 150.0 + 7 * i) for i in range(B)]
    real = dict(all_finished=TB.all_finished, fetched=TM.fetched, viterbi=TM.viterbi,
                forward=module.decoder.forward)
    # the first call, its dispatch under the guard but for the beam's syncs
    # (the full-prefix beam on an 8-step engine: its 96 steps take seconds
    # whatever the batch)
    first = HybridEngine(module, eng.frontend, eng.tokenizer,
                         **dict(BEAM_SERVING, maxlen=8 if full_prefix else 96))
    TB.all_finished, TM.fetched = lifted(real["all_finished"]), lifted(real["fetched"])
    try:
        with guarded_entries(torch, (first, "run")):
            first.transcribe(wavs[:2], nbest=K, with_timestamp=True)
    finally:
        TB.all_finished, TM.fetched = real["all_finished"], real["fetched"]
    torch.cuda.synchronize()
    aligns, dec_calls = [], [0]

    def kept_vit(*a, **k):
        out = real["viterbi"](*a, **k)
        aligns.append(out)
        return out

    def counted_forward(*a, **k):
        dec_calls[0] += 1
        return real["forward"](*a, **k)

    def transcribe():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = served.transcribe(wavs, nbest=K, with_timestamp=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    TM.viterbi, module.decoder.forward = kept_vit, counted_forward
    try:
        # the main path: counters from 0, a host sync in the dispatch raises
        TB.all_finished, TM.fetched = lifted(real["all_finished"]), lifted(real["fetched"])
        served.run = sync_guarded(torch, served.run)
        zero()
        steps0 = served.steps
        try:
            res_k, wall = transcribe()
        finally:
            TB.all_finished, TM.fetched = real["all_finished"], real["fetched"]
            del served.run
        launches = read()
        steps, n_dec = served.steps - steps0, dec_calls[0]
        walls = [wall]
        if not full_prefix:  # a second reading
            walls.append(transcribe()[1])
        with beam_twins(CP):
            res_t = served.transcribe(wavs, nbest=K, with_timestamp=True)
    finally:
        TM.viterbi = real["viterbi"]
        del module.decoder.forward
    want = dict.fromkeys(launches, 0)
    want.update(ctc_prefix_step=steps, fbank=1,
                **hybrid_batch_launches(name, B, N, served.beam, served.maxlen, n_dec))
    log(f"e2e {tag} {name}: B={B} x 15 s, nbest={K} with timestamps, {steps} decode "
        f"steps, {n_dec} full-prefix decoder calls; kernel launches {launches}")
    check(steps > 0 and launches == want, f"{tag} {name} launches {launches}, want {want}")
    check((n_dec >= steps) if full_prefix else n_dec == 0,
          f"{tag} {name}: the {'full-prefix' if full_prefix else 'cached'} scorer")
    rows, d_score = compare_nbest(res_k, res_t, aligns[0], aligns[-1], K,
                                  f"e2e {tag} {name}", served.tokenizer)
    rec = dict(B=B, transcribe_ts_wall_s=walls, steps=steps, decoder_calls=n_dec,
               launches=launches, twins_hypotheses_equal=rows,
               twins_max_abs_dscore=d_score,
               audio_s_per_s=[B * N / FS / w for w in walls])
    if full_prefix:
        # one decode step's decoder call at the served shape: time and launches
        M = B * served.beam
        with torch.inference_mode():
            enc, enc_lens = module.encode(*eng.frontend.device_features(
                *served._pack(wavs)))
            enc_rep = enc.repeat_interleave(served.beam, dim=0)
            lens_rep = enc_lens.repeat_interleave(served.beam, dim=0)
            ys = torch.randint(3, module.vocab_size, (M, served.maxlen + 1),
                               device=enc.device)
            lens = torch.full((M,), served.maxlen + 1, device=enc.device)
            call = lambda: module.decoder(enc_rep, lens_rep, ys, lens)  # noqa: E731
            ms = cuda_ms(call, iters=3, warmup=1)
            prof = profile(torch, call, None, ms, "profile_rwkv_decoder.txt")
        rec.update(decoder_call_ms=ms, decoder_call_launches=prof["kernel launches"],
                   decoder_call_profile=prof)
        log(f"e2e {tag} {name} on {card}: one full-prefix decoder call ({M} x "
            f"{served.maxlen + 1} tokens) {ms:.2f} ms, {prof['kernel launches']} kernel "
            f"launches (13820 when the WKV recurrence was a Python loop)")
        del enc, enc_rep
    log(f"e2e {tag} {name} on {card}: transcribe with timestamps "
        f"{[round(w, 3) for w in walls]} s wall, {steps} decode steps "
        f"({1e3 * walls[0] / steps:.1f} ms a step)")
    return launches, rec


def end_to_end_aishell(torch, FK, A, CP, card):
    """Phase (f): the four aishell recipes at full width (12-block encoders
    of D = 256, 6-block decoders, vocab 4234), each from its YAML through
    ``AutoModel(quantize=True)`` on seeded random weights.  (f1)
    Transformer, Branchformer and E-Branchformer, (f2) the Conformer with
    the RWKV decoder (the full-prefix beam) on B = 8: ``HybridEngine(...,
    beam 10, maxlen 96, CTC 0.3, int8 KV).transcribe(nbest=3,
    with_timestamp=True)`` of B x 15 s, the counters exact (fbank 1, the
    CTC step one a decode step, the fused int8 FFNs and gated QDense pairs
    of ``hybrid_batch_launches``), the batch's dispatch under
    ``torch.cuda.set_sync_debug_mode("error")`` but for the beam's one sync
    a step (``beam_search.all_finished``) and the read back
    (``device.fetched``), the wall and the decode steps; on the twins (CTC
    step, int8 blocks) tokens equal, scores within ``BEAM_F32_SCORE_TOL``,
    alignments and timestamps equal.  (f2) also times one full-prefix
    decoder call at the served shape and counts its kernel launches (a
    profile).  (f3) the E-Branchformer behind FSMN-VAD and CT-Transformer:
    ``generate`` of the 600 s recording on pipeline (b)'s plan, as (e2).
    Returns (launches, e2e record)."""
    zero, read = hybrid_counters(FK, A, CP)
    e2e, total = {}, dict.fromkeys(read(), 0)
    for name, path, B in AISHELL_RECIPES:
        t0 = time.time()
        am = aishell_model(name, path)
        log(f"e2e aishell {name}: built in {time.time() - t0:.1f} s")
        launches, rec = hybrid_recipe_batch(torch, A, CP, card, am, name, B, zero, read, "(f)")
        e2e[f"aishell_{name}"] = rec
        for k in total:
            total[k] += launches[k]
        if name == "ebranchformer":
            # ---- (f3) behind FSMN-VAD and CT-Transformer
            _, vad_cfg, punc_cfg = pipeline_configs()
            am = aishell_model(name, path, vad_model=vad_cfg, punc_model=punc_cfg)
            launches_f3, rec3 = hybrid_pipeline(torch, CP, am, zero, read, "aishell_f3", name)
            e2e.update(rec3)
            for k in total:
                total[k] += launches_f3[k]
        del am
        torch.cuda.empty_cache()
    return total, e2e


# phase (g): the 256-wide SANM family and the aishell Paraformer-Conformer
EPARAFORMER_YAML = "examples/aishell/e_paraformer/conf/e_paraformer_conformer_12e_6d_2048_256.yaml"
PARAFORMER_CONFORMER_YAML = ("examples/aishell/paraformer/conf/"
                             "paraformer_conformer_12e_6d_2048_256.yaml")
# the SANM hybrid: the aishell Transformer recipe with the SANM encoder and
# E-Paraformer's encoder_conf (the repo has no SANM recipe)
SANM_HYBRID_CONF = dict(model="SANM", encoder="SANMEncoder",
                        encoder_conf=dict(output_size=256, attention_heads=4, linear_units=2048,
                                          num_blocks=12, kernel_size=11, dropout_rate=0.1))
# D = 256 at B = 32 x 15 s: the SANM wout with the FSMN (11 taps) in its epilogue
RQ_CASES_D256 = ((32 * 250, 256, 256, "bf16", True, (32, 250, [250, 200] * 16),
                  "SANM ctx -> wout + FSMN, D = 256"),)
# The int8 launches of the two Paraformers a served (B, T, U), stated from
# the JAX package's layout at the recipes' widths (D = 256, 4 heads, FFN
# 2048, 12 encoder and 6 decoder blocks, vocab 4234): ``sanm`` fused SANM
# layers (encoder blocks 1-11), ``attention`` bf16 attention calls
# (E-Paraformer's encoders0; the SAN decoder's self- and cross-attention,
# key masks both), ``ffn`` fused int8 position-wise FFNs
# (encoders0's, the SAN decoder's), and the output widths N of the QDense
# layers with N >= 1024 over the encoder's or the decoder's rows (the
# Conformer's 24 macaron w_1; the output layer).
PARAFORMER256_INT8 = {
    "e_paraformer": dict(sanm=11, attention=1 + 12, ffn=1 + 6, enc_dense=(),
                         dec_dense=(4234,)),
    "paraformer_conformer": dict(sanm=0, attention=12, ffn=6, enc_dense=(2048,) * 24,
                                 dec_dense=(4234,)),
}


def recipe_model(path, seed, quantize=True, conf=None, **kw):
    """``AutoModel(model=<a repo YAML>)`` on seeded random weights with
    ``aishell_model``'s 4234-entry token list; ``conf`` overrides the YAML."""
    from funasr_torch.auto.auto_model import AutoModel

    V = 4234
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(V - 4)] + ["<unk>"]
    here = os.path.dirname(os.path.abspath(__file__))
    return AutoModel(model=os.path.join(here, path),
                     model_conf=dict(conf or {}, tokenizer_conf=dict(token_list=tokens)),
                     quantize=quantize, seed=seed, **kw)


def paraformer256_launches(A, layout, shapes, fbank, rounds=0, n_blocks=4):
    """The exact launches of a 256-wide Paraformer's int8 path by the stated
    layout ``PARAFORMER256_INT8[layout]``: ``fbank`` launches and, per served
    (B, T, U), the fused SANM layers (three rowquant + int8 GEMM pairs, the
    row-quantizing wout, the exact-sum attention at d = 64), the fused FFNs
    (two pairs each), the gated QDense pairs, the d = 64 attention calls;
    punctuation's d = 32 attention ``n_blocks`` a window round."""
    lay = PARAFORMER256_INT8[layout]
    want = dict(fbank=fbank, attention=rounds * n_blocks, attention_d32=rounds * n_blocks,
                attention_d64=0, sanm_layer=0, int8_gemm_rq=0, attention_f32ctx=0,
                attention_f32ctx_d64=0, ffn=0, rowquant=0, int8_gemm=0)

    def gated(rows, widths):
        return sum(rows >= INT8_MIN_ROWS and n >= INT8_MIN_N for n in widths)

    for B, T, U in shapes:
        s, f = lay["sanm"], lay["ffn"]
        q = gated(B * T, lay["enc_dense"]) + gated(B * U, lay["dec_dense"])
        n_att = s * exact_attention_launches(A, B, T, T)
        for k, n in (("attention", lay["attention"]), ("attention_d64", lay["attention"]),
                     ("sanm_layer", s), ("int8_gemm_rq", s), ("attention_f32ctx", n_att),
                     ("attention_f32ctx_d64", n_att), ("ffn", f),
                     ("rowquant", 3 * s + 2 * f + q), ("int8_gemm", 3 * s + 2 * f + q)):
            want[k] += n
    return want


def check_head64_kernels(torch, A, G, RQ, FM, SL, DL, FF):
    """The head-size-64 instances and the int8 layers at D = 256 at the
    256-wide models' served shapes (B = 32 x 15 s: T = 256 LFR frames, keys
    250/200; the SAN decoder's U = 128): ``attention_forward<64>`` bf16 and
    float32 against its twin (``ATTN_TOL``), timed beside the twin and SDPA;
    the exact-sum entries at d = 64 bit-equal to their twins (and their
    edges: a length-1 row, T = 1, T = 1000 with the scores in the scratch);
    ``int8_gemm_rq`` at (8000, 256, 256) with the FSMN's 11 taps bit-equal;
    the SANM layer (both routes), the decoder layer (``fsmn_ln`` at D = 256)
    and the FFN against their twins, the SANM layer bit-equal."""
    cases = dict(attention=check_attention(torch, A, B=32, D=256, seed=20))
    cases["f32ctx"] = check_f32ctx(torch, A, D=256, B=32, seed=19)
    cases["i8qk"] = check_i8qk(torch, A, D=256, B=32, seed=17)
    cases["rq"] = check_int8_rq(torch, G, RQ, FM, RQ_CASES_D256)
    cases["layers"] = check_int8_layers(torch, SL, DL, FF, D=256, B=32, seed=21,
                                        aishell_ffn=False)
    main = cases["layers"]["sanm_layer"][0]
    check(main["elements_differing"] == 0 and cases["layers"]["sanm_layer_i8"][0][
        "elements_differing"] == 0, "the SANM layer at D = 256 bit-equal to its twin")
    return cases


def paraformer256_batch(torch, A, eng, wavs, zero, read, tag, layout=None):
    """One B x 15 s batch through ``ParaformerEngine.transcribe_async`` with
    no host sync in its dispatch; counters exact (``layout`` None: the
    float32 path, fbank and the 24 d = 64 attention calls); the wall of the
    call and a second reading.  Returns (records, launches, walls)."""
    zero()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = sync_guarded(torch, eng.transcribe_async)(wavs)()
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t]
    launches = read()
    shape = served_shape(eng, wavs)
    if layout is None:
        want = dict.fromkeys(launches, 0)
        want.update(fbank=1, attention=24, attention_d64=24)
    else:
        want = dict.fromkeys(launches, 0)
        want.update(paraformer256_launches(A, layout, [shape], 1))
    log(f"e2e {tag}: B={len(wavs)} x 15 s, (B, T, U) {shape}; kernel launches {launches}")
    check(launches == want, f"{tag} launches {launches}, want {want}")
    check(all(isinstance(r["text"], str) for r in res) and any(r["text"] for r in res),
          f"{tag}: texts")
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.transcribe(wavs)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
    return res, launches, walls


def end_to_end_sanm_family(torch, FK, A, CP, card, B=32):
    """Phase (g): the 256-wide SANM family and the aishell
    Paraformer-Conformer at full width (12 encoder and 6 decoder blocks, D =
    256, 4 heads: head size 64, vocab 4234) from their YAMLs through
    ``AutoModel`` on seeded random weights.  (g1) E-Paraformer (SANM
    encoder, PIF predictor, SAN decoder) on B = 32 x 15 s through
    ``ParaformerEngine``: int8 (``quantize=True``) and float32, counters
    exact by ``paraformer256_launches`` (float32: fbank 1, attention 24 at d
    = 64), no host sync in the dispatch; int8 on the int8 twins (bit-equal
    blocks) gives the same records, float32 on the plain twins log-probs
    within ``E2E_F32_LOGP_TOL``, tokens >= ``E2E_F32_MIN_AGREE``, token
    lengths equal.  (g2) the Paraformer-Conformer (linear input layer, CIF,
    SAN decoder), int8, the same batch, as (g1).  (g3) the SANM hybrid (the
    Transformer recipe with ``model: SANM``, ``encoder: SANMEncoder`` and
    E-Paraformer's encoder conf) through ``hybrid_recipe_batch``: beam 10,
    maxlen 96, nbest 3 with timestamps on the beam cell's batch.  (g4)
    E-Paraformer behind FSMN-VAD and CT-Transformer: ``generate`` of the
    600 s recording on pipeline (b)'s plan, counters exact, no host sync in
    a dispatch, the record on the int8 twins equal.  Returns (launches,
    e2e record)."""
    import numpy as np

    from funasr_torch.auto.engines import ParaformerEngine
    from funasr_torch.models.e_paraformer.model import EParaformer
    from funasr_torch.models.paraformer.decoder import ParaformerSANDecoder
    from funasr_torch.utils.vad_utils import merge_vad, slice_audio_by_segments

    zero, read = hybrid_counters(FK, A, CP)
    e2e, paths = {}, {}
    N = 15 * FS
    rng = np.random.default_rng(6)
    wavs = [waveform(rng, N, 150.0 + 7 * i) for i in range(B)]
    _, vad_cfg, punc_cfg = pipeline_configs()

    # ---- (g1) E-Paraformer, int8 (with the VAD and punctuation of (g4)) and float32
    t0 = time.time()
    am = recipe_model(EPARAFORMER_YAML, 2050, vad_model=vad_cfg, punc_model=punc_cfg)
    eng = am.engine
    module = eng.module
    check(isinstance(eng, ParaformerEngine) and type(module) is EParaformer
          and type(module.decoder) is ParaformerSANDecoder
          and len(module.encoder.encoders) == 11 and len(module.decoder.decoders) == 6
          and module.encoder.output_size() == 256 and module.vocab_size == 4234
          and module.encoder.encoders[0].n_head == 4, "(g1) E-Paraformer at the recipe's widths")
    log(f"e2e (g1) E-Paraformer: AutoModel (int8, FSMN-VAD, CT-Transformer) built in "
        f"{time.time() - t0:.1f} s")
    with guarded_entries(torch, (eng, "transcribe_async")):
        eng.transcribe(wavs[:2])  # the first call, under the guard
    res_k, launches, walls = paraformer256_batch(torch, A, eng, wavs, zero, read,
                                                 "(g1) E-Paraformer int8", "e_paraformer")
    with int8_twins():
        res_t = eng.transcribe(wavs)
    check(res_t == res_k, "(g1) E-Paraformer int8: the records on the int8 twins equal")
    paths["g1_int8"] = launches
    e2e["sanm_g1_int8"] = dict(B=B, transcribe_wall_s=walls, launches=launches,
                               audio_s_per_s=[B * N / FS / w for w in walls],
                               twins_records_equal=True)
    log(f"e2e (g1) E-Paraformer int8 on {card}: {[round(w, 4) for w in walls]} s wall; "
        f"records equal on the twins")

    am32 = recipe_model(EPARAFORMER_YAML, 2050, quantize=False)
    eng32 = am32.engine
    check(eng32.module.dtype == torch.float32, "(g1) the float32 E-Paraformer")
    eng32.transcribe(wavs[:2])
    res32, launches32, walls32 = paraformer256_batch(torch, A, eng32, wavs, zero, read,
                                                     "(g1) E-Paraformer float32")
    paths["g1_f32"] = launches32
    wav_d, lens_d = eng32._pack(wavs)
    max_tokens = eng32._max_tokens(wav_d.shape[1])

    def logits():
        with torch.inference_mode():
            feats, flens = eng32.frontend.device_features(wav_d, lens_d)
            return eng32.module.inference_logits(feats, flens, max_tokens=max_tokens)[:2]

    lp_k, tl_k = logits()
    with plain_twins(FK, A):
        lp_r, tl_r = logits()
    valid = torch.arange(max_tokens, device=tl_k.device)[None] < tl_k[:, None]
    logp_err = float((lp_k - lp_r).abs()[valid].max())
    agree = float((lp_k.argmax(-1) == lp_r.argmax(-1))[valid].float().mean())
    log(f"e2e (g1) E-Paraformer float32 on {card}: {[round(w, 4) for w in walls32]} s wall; "
        f"kernels vs twins max |dlogp| {logp_err:.3e} (tol {E2E_F32_LOGP_TOL}), token "
        f"agreement {agree:.5f}, token lengths equal {bool(torch.equal(tl_k, tl_r))}")
    check(bool(torch.isfinite(lp_k[valid]).all()) and torch.equal(tl_k, tl_r)
          and logp_err <= E2E_F32_LOGP_TOL and agree >= E2E_F32_MIN_AGREE,
          "(g1) E-Paraformer float32: kernels against twins")
    e2e["sanm_g1_f32"] = dict(B=B, transcribe_wall_s=walls32, launches=launches32,
                              logp_max_abs_diff=logp_err, token_agreement=agree)
    del am32, eng32, lp_k, lp_r
    torch.cuda.empty_cache()

    # ---- (g2) the aishell Paraformer-Conformer, int8, the same batch
    amc = recipe_model(PARAFORMER_CONFORMER_YAML, 2051)
    engc = amc.engine
    check(type(engc.module.encoder).__name__ == "ConformerEncoder"
          and engc.module.encoder.input_layer == "linear"
          and type(engc.module.decoder) is ParaformerSANDecoder
          and len(engc.module.encoder.encoders) == 12, "(g2) the Paraformer-Conformer")
    engc.transcribe(wavs[:2])
    res_c, launches_c, walls_c = paraformer256_batch(torch, A, engc, wavs, zero, read,
                                                     "(g2) Paraformer-Conformer int8",
                                                     "paraformer_conformer")
    with int8_twins():
        check(engc.transcribe(wavs) == res_c,
              "(g2) Paraformer-Conformer int8: the records on the int8 twins equal")
    paths["g2"] = launches_c
    e2e["sanm_g2"] = dict(B=B, transcribe_wall_s=walls_c, launches=launches_c,
                          audio_s_per_s=[B * N / FS / w for w in walls_c],
                          twins_records_equal=True)
    log(f"e2e (g2) Paraformer-Conformer int8 on {card}: {[round(w, 4) for w in walls_c]} s "
        f"wall; records equal on the twins")
    del amc, engc
    torch.cuda.empty_cache()

    # ---- (g3) the SANM hybrid: beam 10, maxlen 96, nbest 3 with timestamps
    t0 = time.time()
    amh = recipe_model(AISHELL_RECIPES[0][1], 2052, conf=SANM_HYBRID_CONF)
    log(f"e2e (g3) SANM hybrid: built in {time.time() - t0:.1f} s")
    paths["g3"], e2e["sanm_g3"] = hybrid_recipe_batch(torch, A, CP, card, amh, "sanm", B,
                                                      zero, read, "(g3)")
    del amh
    torch.cuda.empty_cache()

    # ---- (g4) E-Paraformer behind FSMN-VAD and CT-Transformer, 600 s
    ve, pm = am.vad_engine, am.punc_engine.model
    wav, bursts = pipeline_recording(np.random.default_rng(12))
    plan = merge_vad(bursts, 15000)
    clips = slice_audio_by_segments(wav, plan, FS)
    pshapes = [served_shape(eng, [clips[i] for i in batch])
               for batch in am.batches(plan, FS, 300)]

    def generate(twins=False):
        clock = StageClock(torch)
        rounds = [0]
        real_argmax = pm._argmax

        def counted_argmax(text, lens):
            rounds[0] += 1
            return real_argmax(text, lens)

        pm._argmax = counted_argmax
        eng.transcribe_async = sync_guarded(torch, eng.transcribe_async)
        ve.model.segments_from_posteriors = (
            lambda post, db, f=ve.model.segments_from_posteriors: (f(post, db), plan)[1])
        clock.wrap(ve, "front", "vad_device", events=True)
        clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
        clock.wrap(eng, "transcribe_async", "asr_dispatch")
        clock.wrap(eng, "run", "asr_device", events=True)
        clock.wrap(eng, "_host_results", "asr_host")
        clock.wrap(pm, "inference_batch", "punc")
        zero()
        try:
            with int8_twins() if twins else contextlib.nullcontext():
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = am.generate(wav, key=["g4"])[0]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
        finally:
            clock.restore()
            for obj, attr in ((pm, "_argmax"), (eng, "transcribe_async"),
                              (ve.model, "segments_from_posteriors")):
                delattr(obj, attr)
        times = dict(generate_wall_s=wall, audio_s_per_s=PIPELINE_AUDIO_S / wall,
                     vad_device_ms=clock.device_ms("vad_device"),
                     vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                     asr_dispatch_wall_s=clock.wall.get("asr_dispatch", 0.0),
                     asr_device_span_ms=clock.device_ms("asr_device", span=True),
                     asr_host_wall_s=clock.wall.get("asr_host", 0.0),
                     punc_wall_s=clock.wall.get("punc", 0.0), punc_rounds=rounds[0])
        return res, read(), rounds[0], times

    first = generate()[-1]  # the first call at these shapes
    res, launches4, rounds, times = generate()
    want = dict.fromkeys(launches4, 0)
    want.update(paraformer256_launches(A, "e_paraformer", pshapes, 1 + len(pshapes), rounds))
    log(f"e2e (g4) E-Paraformer 600 s: {len(plan)} segments in ASR batches (B, T, U) "
        f"{pshapes}, {rounds} punctuation rounds; kernel launches {launches4}")
    check(launches4 == want, f"(g4) launches {launches4}, want {want}")
    ts = res.get("timestamp") or []
    check(isinstance(res.get("text"), str) and res["text"] and res.get("sentence_info"),
          "(g4): the record")
    check(all(0 <= b <= e <= PIPELINE_AUDIO_S * 1000 for b, e in ts),
          "(g4): timestamps within the recording")
    res_t, _, _, times_t = generate(twins=True)
    check(res_t == res, "(g4): the record on the int8 twins equals it")
    log(f"e2e (g4) on {card}: {json.dumps(times)}; the first call {json.dumps(first)}; "
        f"text {res['text'][:24]}... {len(ts)} stamps, {len(res['sentence_info'])} "
        f"sentences; equal on the twins (their run {times_t['generate_wall_s']:.3f} s)")
    paths["g4"] = launches4
    e2e["sanm_g4"] = dict(times, first_call=first, segments=len(plan), batches=pshapes,
                          launches=launches4, twins_record_equal=True)
    del am, eng, module
    torch.cuda.empty_cache()
    total = {k: sum(d.get(k, 0) for d in paths.values()) for k in read()}
    return total, e2e


# ------------------------------------------------------------------ phase (h)
WHISPER_CFG = dict(model="Whisper", size="large-v3", max_tokens=64)  # the JAX AutoModel's route
WHISPER_SEED = 2060
WHISPER_AUDIO_S = (30, 27, 22, 18, 12, 9, 5, 2)  # (h1)'s batch: one 30 s window a row
WHISPER_LANGS = tuple(range(50259, 50359))  # large-v3's language tokens
WHISPER_F32_ROWS = 2  # (h1)'s float32 run: its first rows
# bf16, kernels against twins, both fed the kernels' tokens (so one tie does
# not carry into the rest of its row): every logit within WHISPER_LOGIT_TOL
# of the twin's (measured 0.0503-0.0547).  At a vocabulary of 51866 random bf16 logits under 4 in
# magnitude (spaced 2^-6) tie or nearly tie on a few steps a row, so the
# predictions may differ, but only where the twins' top-2 margin is within
# WHISPER_TIE_MARGIN (measured 0 to 2^-5), and they agree on at least
# WHISPER_MIN_AGREE of the steps (measured 0.960-0.971)
WHISPER_LOGIT_TOL = 0.1
WHISPER_TIE_MARGIN = 2.0 ** -5
WHISPER_MIN_AGREE = 0.95
WHISPER_MIN_DISTINCT = 16  # distinct tokens in (h1)'s batch: no fixed point
# (h3) decodes the 600 s recording's first 150 s (one batch; all of it took 3
# batches and put the script past 700 s once phase (i) came)
WHISPER_H3_S = 150
WHISPER_LID_TOL = 1e-2  # detect_language probabilities, kernels against twins, abs
# float32 log-probs on the same prefix, kernels against twins (measured
# 2.9e-6); a prediction may differ only where the twins' top-2 margin is
# within twice that bar
WHISPER_F32_LOGP_TOL = 3e-5


def whisper_launches(config, steps, calls=1):
    """``fused_attention`` launches of ``calls`` greedy decodes of ``steps``
    steps: the encoder's self-attention once a layer, then each step the
    decoder's self- and cross-attention once a layer."""
    return calls * (config.encoder_layers + 2 * config.decoder_layers * steps)


def check_whisper_kernels(torch, A):
    """(h0) ``fused_attention`` at head size 64 at Whisper large-v3's shapes
    (B = 8, 20 heads of 64, one 30 s window: T = 1500 keys): the encoder's
    self-attention (8, 1500, 1280) with no key masked, the cross-attention of
    one query over the encoder states (edge: only the keys of the last,
    ragged 64-key tile, 1472-1499) and the cached self-attention of one query
    over the (8, 65, 1280) cache with keys <= 32 (edges: <= 0, one key, and
    <= 64, every key), bf16 and float32 against the twin, timed by events and
    CUDA graph beside the twin and SDPA.  The bar is ``ATTN_TOL`` of the
    output's scale: x min(1, max |twin|), since at 1500 keys an output
    averages many values and is a few hundredths in size.  The float32
    encoder self-attention runs within ``F32_SDPA_BAR`` x SDPA's time."""
    import torch.nn.functional as F

    B, T, D, H, L = 8, 1500, 1280, 20, 65
    gen = torch.Generator(device="cuda").manual_seed(30)
    d = D // H
    ragged = T - T % 64
    cases = []
    # (name, queries, keys, the timed case's key range, the edges' key ranges)
    for name, U, Tk, keys, edges in (
            ("encoder self-attention", T, T, (0, T), ()),
            ("cross-attention", 1, T, (0, T), ((ragged, T),)),
            ("cache self-attention", 1, L, (0, 33), ((0, 1), (0, L)))):
        for dtype in (torch.bfloat16, torch.float32):
            dn = "bfloat16" if dtype == torch.bfloat16 else "float32"

            def rand(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            def key_bias(lo, hi):
                bias = torch.full((B, Tk), -1e30, device="cuda")
                bias[:, lo:hi] = 0.0
                return bias

            q, k, v = rand(B, U, D) / d ** 0.5, rand(B, Tk, D), rand(B, Tk, D)
            errs, bars = [], []
            for lo, hi in (keys,) + edges:
                bias = key_bias(lo, hi)
                got = A.fused_attention(q, k, v, bias, H)
                want = A.attention_ref(q, k, v, bias, H)
                check(bool(torch.isfinite(got).all()), f"(h0) attention {name} finite")
                errs.append(float((got.float() - want.float()).abs().max()))
                bars.append(ATTN_TOL[dn] * min(1.0, float(want.float().abs().max())))
                check(errs[-1] <= bars[-1], f"(h0) attention {name} {dn} at keys {lo}-{hi - 1}:"
                      f" max err {errs[-1]} > {bars[-1]}")
            n_keys = keys[1] - keys[0]
            bias = key_bias(*keys)
            run = lambda: A.fused_attention(q, k, v, bias, H)  # noqa: E731
            q4, k4, v4 = (x.unflatten(-1, (H, d)).transpose(1, 2) for x in (q, k, v))
            mask = None if n_keys == Tk else bias[:, None, None, :].to(dtype)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, attn_mask=mask, scale=1.0)
            el = q.element_size()
            nbytes = el * (2 * B * U * D + 2 * B * n_keys * D) + 4 * B * Tk
            bnd, by = bound_ms(nbytes, {dn: 4.0 * B * U * n_keys * D})
            case = dict(case=f"{name} q({B},{U},{D}) kv({B},{Tk},{D}) {dn}, H={H}, "
                             f"{n_keys} keys", max_abs_err=errs[0], tolerance=bars[0],
                        ms=cuda_ms(run, iters=20, warmup=5),
                        graph_ms=graph_ms(run), plain_ms=cuda_ms(
                            lambda: A.attention_ref(q, k, v, bias, H), iters=3, warmup=1),
                        library_ms=cuda_ms(sdpa, iters=20, warmup=5),
                        library_graph_ms=graph_ms(sdpa), bound_ms=bnd, bound_by=by)
            if edges:
                case["edges"] = [dict(keys=f"{lo}-{hi - 1}", max_abs_err=e, tolerance=t)
                                 for (lo, hi), e, t in zip(edges, errs[1:], bars[1:])]
            if dn == "float32":
                case["split_tf32_bound_ms"] = split_tf32_bound_ms(4.0 * B * U * n_keys * D)
            log(f"attention (h0) {case}")
            cases.append(case)
            if dn == "float32" and name == "encoder self-attention":
                check(case["ms"] <= F32_SDPA_BAR * case["library_ms"],
                      f"(h0) attention {name} float32: {case['ms']:.4f} ms > {F32_SDPA_BAR} x "
                      f"SDPA {case['library_ms']:.4f} ms")
    return cases


def whisper_forced(torch, FK, A, wrap, feats, tokens, forced=()):
    """``wrap.greedy_decode`` fed ``tokens`` after the start token and
    ``forced``, on the kernels and on their twins: (kernels' predictions,
    kernels' logits, twins' predictions, twins' logits), logits float32."""
    pred_k, logits_k = wrap.greedy_decode(feats, forced_tokens=forced, tokens=tokens,
                                          return_logits=True)
    with plain_twins(FK, A):
        pred_t, logits_t = wrap.greedy_decode(feats, forced_tokens=forced, tokens=tokens,
                                              return_logits=True)
    return pred_k, logits_k.float(), pred_t, logits_t.float()


def whisper_agreement(torch, FK, A, wrap, feats, tokens, tag, forced=()):
    """The served bf16 decode's ``tokens`` fed back on the kernels and on
    the twins: the kernels predict ``tokens`` again, every logit within
    ``WHISPER_LOGIT_TOL`` of the twins', the twins' predictions equal on at
    least ``WHISPER_MIN_AGREE`` of the steps and, where they differ, the
    twins' top-2 margin within ``WHISPER_TIE_MARGIN`` (a bf16 tie)."""
    pred_k, logits_k, pred, logits_t = whisper_forced(torch, FK, A, wrap, feats, tokens, forced)
    dlogit = float((logits_k - logits_t).abs().max())
    top2 = logits_t.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    del logits_k, logits_t
    differ = pred != tokens
    agree = 1.0 - float(differ.float().mean())
    worst = float(margin[differ].max()) if bool(differ.any()) else 0.0
    firsts = []
    for b in range(tokens.shape[0]):
        bad = differ[b].nonzero()
        if len(bad):
            t = int(bad[0])
            firsts.append(dict(row=b, step=t, twin_margin=float(margin[b, t])))
    log(f"e2e (h) {tag}: kernels vs twins, tokens fed the kernels' prefix: max |dlogit| "
        f"{dlogit} (bar {WHISPER_LOGIT_TOL}); agreement {agree:.5f} (bar {WHISPER_MIN_AGREE}); "
        f"largest twin margin where they differ {worst} (bar {WHISPER_TIE_MARGIN}); first "
        f"differing steps {firsts}")
    check(torch.equal(pred_k, tokens), f"(h) {tag}: the kernels fed their own tokens predict "
          "other ones")
    check(dlogit <= WHISPER_LOGIT_TOL and agree >= WHISPER_MIN_AGREE
          and worst <= WHISPER_TIE_MARGIN, f"(h) {tag}: max |dlogit| {dlogit}, token "
          f"agreement {agree}, twin margin {worst} where they differ")
    return dict(agreement=agree, logit_max_abs_diff=dlogit, first_differences=firsts)


def end_to_end_whisper(torch, FK, A, CP, profile_dir, card):
    """Phase (h): Whisper large-v3 at full width (D = 1280, 32 + 32 layers,
    20 heads of 64, 128 mels, vocab 51866) on seeded random weights
    (``init_weights_``), served through ``AutoModel(model={"model":
    "Whisper", "size": "large-v3"}, vad_model=FSMN-VAD,
    punc_model=CT-Transformer)``, bf16.  (h1) ``WhisperEngine.transcribe``
    of B = 8 windows (30, 27, 22, 18, 12, 9, 5 and 2 s of audio), 64
    tokens: ``fused_attention`` at d = 64 launched exactly 32 + 64 x 32 x 2
    times and nothing else, no host sync in the frontend's or the decode's
    dispatch, the kernels against the twins fed the kernels' tokens
    (:func:`whisper_agreement`: logits within ``WHISPER_LOGIT_TOL``, >=
    ``WHISPER_MIN_AGREE`` equal, each difference a bf16 tie of the twins'
    logits, ``WHISPER_TIE_MARGIN``), >= ``WHISPER_MIN_DISTINCT`` distinct
    tokens; the batch's wall, the encoder's and the decode's spans and, in a
    profile, launches a step and the idle share; float32 on
    ``WHISPER_F32_ROWS`` rows: log-probs on the twins' tokens within
    ``WHISPER_F32_LOGP_TOL``, the predictions equal but at ties within twice
    that.  (h2) ``WhisperLID`` over large-v3's 100 language tokens:
    ``detect_language`` within ``WHISPER_LID_TOL`` of the twins',
    ``transcribe_with_lid`` counters exact and its tokens at the (h1) rule.
    (h3) ``generate`` of the 600 s recording's first ``WHISPER_H3_S`` s on
    pipeline (b)'s plan (one batch): each segment one 30 s window, counters exact (fbank once for the VAD, d = 64
    attention per batch), no host sync in a dispatch, each batch's tokens at
    the (h1) rule; punctuation gets no text (no Whisper tokenizer in the
    repository).  Returns (launches, e2e record)."""
    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.auto.engines import WhisperEngine
    from funasr_torch.models.whisper.model import WhisperLID, WhisperWrap
    from funasr_torch.utils.vad_utils import merge_vad, slice_audio_by_segments

    zero, read = hybrid_counters(FK, A, CP)
    e2e, paths = {}, {}
    _, vad_cfg, punc_cfg = pipeline_configs()
    t0 = time.time()
    am = AutoModel(model=WHISPER_CFG, vad_model=vad_cfg, punc_model=punc_cfg, seed=WHISPER_SEED)
    eng = am.engine
    wrap, config = eng.model, eng.model.config
    blocks = (len(wrap.model.encoder.blocks), len(wrap.model.decoder.blocks))
    n_params = sum(p.numel() for p in wrap.model.parameters())
    check(isinstance(eng, WhisperEngine) and wrap.dtype == torch.bfloat16
          and blocks == (32, 32) and config.d_model == 1280
          and config.encoder_attention_heads == 20 and config.num_mel_bins == 128
          and config.vocab_size == 51866 and config.max_source_positions == 1500,
          "(h) Whisper large-v3 at full width built through AutoModel, bf16")
    log(f"e2e (h) Whisper {WHISPER_CFG['size']}: AutoModel (bf16, FSMN-VAD, CT-Transformer) "
        f"built in {time.time() - t0:.1f} s; {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    steps = eng.max_tokens
    per_batch = whisper_launches(config, steps)
    rng = np.random.default_rng(7)
    wavs = [waveform(rng, int(s * FS), 110.0 + 13 * i) for i, s in enumerate(WHISPER_AUDIO_S)]
    B = len(wavs)

    # ---- (h1) WhisperEngine.transcribe, bf16, B = 8
    with guarded_entries(torch, (eng.frontend, "batch"), (wrap, "greedy_decode")):
        eng.transcribe(wavs[:2])  # the first call (the frontend's tables), under the guard
    eng.frontend.batch = sync_guarded(torch, eng.frontend.batch)
    guarded = sync_guarded(torch, wrap.greedy_decode)
    walls, spans, outs = [], [], []

    def decode(f, **kw):  # the guarded decode, its tokens kept
        outs.append(guarded(f, **kw))
        return outs[-1]

    wrap.greedy_decode = decode
    try:
        for _ in range(2):
            clock = StageClock(torch)
            clock.wrap(wrap, "encode", "encoder", events=True)
            clock.wrap(wrap, "greedy_decode", "decode", events=True)
            zero()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = eng.transcribe(wavs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            clock.restore()
            spans.append((clock.device_ms("encoder"), clock.device_ms("decode")))
            launches = read()
            want = dict.fromkeys(launches, 0)
            want.update(attention=per_batch, attention_d64=per_batch)
            check(launches == want, f"(h1) launches {launches}, want {want}")
    finally:
        for obj, attr in ((eng.frontend, "batch"), (wrap, "greedy_decode")):
            delattr(obj, attr)
    paths["h1"] = launches
    feats, toks = eng.frontend.batch(wavs), outs[-1]
    eos = config.eos_token_id
    for r, row in zip(res, toks.tolist()):
        check(r["text"] == "" and r["raw_tokens"] == (row[: row.index(eos)] if eos in row
                                                      else row), "(h1) records")
    distinct = len(set(toks.flatten().tolist()))
    check(distinct >= WHISPER_MIN_DISTINCT, f"(h1) {distinct} distinct tokens in the batch "
          f"(< {WHISPER_MIN_DISTINCT}): a fixed point")
    agreement = whisper_agreement(torch, FK, A, wrap, feats, toks, "(h1) bf16")
    enc_ms = [e for e, _ in spans]
    step_ms = [(dd - e) / steps for e, dd in spans]
    log(f"e2e (h1) Whisper on {card}: B={B} windows of {list(WHISPER_AUDIO_S)} s audio, "
        f"{steps} tokens: wall {[round(w, 4) for w in walls]} s, encoder span "
        f"{[round(x, 3) for x in enc_ms]} ms, decode {[round(x, 3) for x in step_ms]} ms a "
        f"step; launches {launches}; {distinct} distinct tokens")
    e2e["whisper_h1"] = dict(B=B, audio_s=list(WHISPER_AUDIO_S), max_tokens=steps,
                             transcribe_wall_s=walls, encoder_span_ms=enc_ms,
                             decode_ms_per_step=step_ms, launches=launches,
                             distinct_tokens=distinct, twins=agreement, parameters=n_params)
    batch_ms = 1e3 * min(walls)
    prof = profile(torch, lambda: eng.transcribe(wavs), profile_dir, batch_ms,
                   "profile_whisper.txt")
    prof["kernel launches a decode step"] = prof["kernel launches"] / steps
    prof["idle share"] = 1.0 - prof["kernel share of batch_ms"]
    e2e["whisper_h1"]["profile"] = prof

    # float32 on WHISPER_F32_ROWS rows: the same seeded draws, unrounded
    w32 = WhisperWrap(size=WHISPER_CFG["size"], dtype=torch.float32, seed=WHISPER_SEED)
    f2 = feats[:WHISPER_F32_ROWS]
    zero()
    toks32 = w32.greedy_decode(f2, max_tokens=steps)
    launches32 = read()
    check(launches32["attention_d64"] == launches32["attention"] == per_batch,
          f"(h1) float32 launches {launches32}")
    paths["h1_f32"] = launches32
    with plain_twins(FK, A):  # the twins' own greedy decode
        toks32_t = w32.greedy_decode(f2, max_tokens=steps)
    pred_k, logits_k, pred_t, logits_t = whisper_forced(torch, FK, A, w32, f2, toks32_t)
    dlogp = float((logits_k.log_softmax(-1) - logits_t.log_softmax(-1)).abs().max())
    top2 = logits_t.topk(2, dim=-1).values
    differ = pred_k != toks32_t
    worst = float((top2[..., 0] - top2[..., 1])[differ].max()) if bool(differ.any()) else 0.0
    free = bool(torch.equal(toks32, toks32_t))
    check(torch.equal(pred_t, toks32_t) and bool(torch.isfinite(logits_k).all())
          and dlogp <= WHISPER_F32_LOGP_TOL and worst <= 2 * WHISPER_F32_LOGP_TOL,
          f"(h1) float32: kernels against twins (|dlogp| {dlogp}, predictions differ at "
          f"{int(differ.sum())} steps, twin margin up to {worst} there)")
    log(f"e2e (h1) float32 B={WHISPER_F32_ROWS}: on the twins' tokens max |dlogp| {dlogp:.3e} "
        f"(tol {WHISPER_F32_LOGP_TOL}), predictions differ at {int(differ.sum())} steps (twin "
        f"margin up to {worst}, bar {2 * WHISPER_F32_LOGP_TOL}); greedy tokens equal {free}")
    e2e["whisper_h1_f32"] = dict(B=WHISPER_F32_ROWS, logp_max_abs_diff=dlogp,
                                 predictions_differing=int(differ.sum()),
                                 greedy_tokens_equal=free)
    del w32, logits_k, logits_t
    torch.cuda.empty_cache()

    # ---- (h2) WhisperLID over large-v3's language tokens
    lid = WhisperLID(size=WHISPER_CFG["size"], seed=WHISPER_SEED,
                     language_token_ids=WHISPER_LANGS)
    zero()
    probs = sync_guarded(torch, lid.detect_language)(feats, WHISPER_LANGS)
    check(read()["attention_d64"] == whisper_launches(config, 1), "(h2) detect_language launches")
    with plain_twins(FK, A):
        probs_t = lid.detect_language(feats, WHISPER_LANGS)
    perr = float((probs - probs_t).abs().max())
    check(perr <= WHISPER_LID_TOL, f"(h2) detect_language |dprob| {perr} > {WHISPER_LID_TOL}")
    zero()
    toks_l, probs_l = lid.transcribe_with_lid(feats, max_tokens=steps)
    launches_l = read()
    best = probs_l.argmax(-1).cpu()
    groups = sorted(set(best.tolist()))
    want_l = whisper_launches(config, 1) + whisper_launches(config, steps + 1, len(groups))
    check(launches_l["attention_d64"] == launches_l["attention"] == want_l,
          f"(h2) transcribe_with_lid launches {launches_l}, want {want_l}")
    paths["h2"] = launches_l
    lid_agree = []
    for g in groups:
        rows = (best == g).nonzero()[:, 0].to(feats.device)
        lid_agree.append(whisper_agreement(torch, FK, A, lid, feats[rows], toks_l[rows],
                                           f"(h2) language {WHISPER_LANGS[g]}",
                                           forced=[WHISPER_LANGS[g]]))
    log(f"e2e (h2) WhisperLID: detect_language max |dprob| {perr:.3e} (tol "
        f"{WHISPER_LID_TOL}); languages {[WHISPER_LANGS[g] for g in best.tolist()]}; "
        f"launches {launches_l}")
    e2e["whisper_h2"] = dict(prob_max_abs_diff=perr, groups=len(groups),
                             twins=lid_agree, launches=launches_l)
    del lid
    torch.cuda.empty_cache()

    # ---- (h3) behind FSMN-VAD and CT-Transformer: the 600 s recording's first
    # WHISPER_H3_S s on (b)'s plan (one batch: the script's time)
    ve, pm = am.vad_engine, am.punc_engine.model
    wav, bursts = pipeline_recording(np.random.default_rng(12))
    wav = wav[: WHISPER_H3_S * FS]
    plan = [s for s in merge_vad(bursts, 15000) if s[1] <= WHISPER_H3_S * 1000]
    clips = slice_audio_by_segments(wav, plan, FS)
    shapes = [len(batch) for batch in am.batches(plan, FS, 300)]

    def generate():
        clock, captured = StageClock(torch), []
        real = wrap.greedy_decode

        def decode(f, **kw):
            out = real(f, **kw)
            captured.append((f, out))
            return out

        wrap.greedy_decode = sync_guarded(torch, decode)
        eng.frontend.batch = sync_guarded(torch, eng.frontend.batch)
        ve.model.segments_from_posteriors = (
            lambda post, db, f=ve.model.segments_from_posteriors: (f(post, db), plan)[1])
        clock.wrap(ve, "front", "vad_device", events=True)
        clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
        clock.wrap(eng, "transcribe", "asr")
        clock.wrap(wrap, "encode", "encoder", events=True)
        clock.wrap(wrap, "greedy_decode", "asr_device", events=True)
        clock.wrap(pm, "inference_batch", "punc")
        zero()
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = am.generate(wav, key=["h3"])[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            clock.restore()
            for obj, attr in ((wrap, "greedy_decode"), (eng.frontend, "batch"),
                              (ve.model, "segments_from_posteriors")):
                delattr(obj, attr)
        times = dict(generate_wall_s=wall, audio_s_per_s=WHISPER_H3_S / wall,
                     vad_device_ms=clock.device_ms("vad_device"),
                     vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                     asr_wall_s=clock.wall.get("asr", 0.0),
                     asr_device_span_ms=clock.device_ms("asr_device", span=True),
                     encoder_ms=clock.device_ms("encoder"),
                     punc_wall_s=clock.wall.get("punc", 0.0))
        return res, read(), times, captured

    first = generate()[2]  # the first call at these shapes
    res, launches3, times, captured = generate()
    want = dict.fromkeys(launches3, 0)
    want.update(fbank=1, attention=len(shapes) * per_batch, attention_d64=len(shapes) * per_batch)
    log(f"e2e (h3) Whisper {WHISPER_H3_S} s: {len(plan)} segments in batches of {shapes} windows; "
        f"kernel launches {launches3}")
    check(launches3 == want, f"(h3) launches {launches3}, want {want}")
    check(res == {"key": "h3", "text": "", "timestamp": []} and times["punc_wall_s"] == 0.0,
          f"(h3) the record {res}: no text, so no punctuation")
    check([f.shape[0] for f, _ in captured] == shapes and sum(shapes) == len(clips),
          "(h3) every segment decoded")
    agree3 = [whisper_agreement(torch, FK, A, wrap, f, tk, f"(h3) batch {i} of {len(shapes)}")
              for i, (f, tk) in enumerate(captured)]
    log(f"e2e (h3) on {card}: {json.dumps(times)}; the first call {json.dumps(first)}; "
        "punctuation got no text: the repository has no Whisper tokenizer, so every "
        "record's text is empty")
    paths["h3"] = launches3
    e2e["whisper_h3"] = dict(times, first_call=first, segments=len(plan), batches=shapes,
                             launches=launches3, twins=agree3)
    del am, eng, wrap
    torch.cuda.empty_cache()
    total = {k: sum(d.get(k, 0) for d in paths.values()) for k in read()}
    return total, e2e


# ---------------------------------------------- phase (i): transducers and emotion2vec
TRANSDUCER_YAML = "examples/aishell/conformer/conf/conformer_12e_6d_2048_256.yaml"
TRANSDUCER_SEED, BAT_SEED, E2V_SEED = 2070, 2071, 2072
TRANSDUCER_V = 4234  # the aishell vocabulary, a single-CJK-char token list
TRANSDUCER_B, BAT_B = 32, 8  # rows of 15 s: the beam cell's batch; BAT's
# The weight rule of (i1)-(i3), fixed before any comparison: with random
# joint weights a non-blank token wins almost every emit attempt, so every
# row would stop at max_tokens (and a blank bias from the first attempt's
# margins alone stops the decode after a token: the synthetic frames barely
# vary; a random encoder's output barely varies over time either: its spread
# over frames is a few hundredths of its size).  So ``weight_rule``
# recentres the joint's ``lin_enc`` on a probe batch's mean encoder frame
# (8 rows of 15 s, pitches across the batch's range: the random Conformer's
# mean frame depends on the length),
# scaled to unit spread, and raises the blank logit's bias
# by the shift that makes the probe emit TR_TOKENS_PER_S tokens a second,
# by bisection over TR_RULE_STEPS greedy decodes: once on the int8
# Transducer (the float32 one and (i3) take its tensors: the same seeded
# weights) and once on RWKV-BAT (the probe's first 5 s).
TR_TOKENS_PER_S = 2.0
TR_RULE_STEPS = 8
TR_PROBE_SEED = 99
TR_MIN_DISTINCT = 16  # distinct tokens a batch: no fixed point
TR_F32_MIN_AGREE = 0.99  # float32 decisions, twins fed the kernels' decisions
E2V_AUDIO_S = (15, 13, 11, 9, 7, 5, 3, 2)  # (i4)'s batch
E2V_TOL = 1e-4  # scores abs; feats x max |twin|; the ALiBi kernel's float32 bar


def check_wkv(torch):
    """(i0) the WKV kernel against its twin, bit for bit, at BAT's served
    shape (8 x 15 s: 1536 frames, C = 256), the RWKV decoder's (B K = 80
    hypotheses, maxlen + 1 = 97) and edges (T = 1, C = 33, one row, keys far
    above and below the running max, -1e30 keys); the served shape timed by
    events and CUDA graph beside the twin and the chain floor
    (``wkv_chain_floor``).  Bound: the larger of the bytes (k and v read
    once, out written once) and the chain floor (T dependent steps), which
    the chain reaches first."""
    import ctypes

    from funasr_torch.ops import cuda_build
    from funasr_torch.ops import wkv as W

    floor_fn = cuda_build.function("wkv", "wkv_chain_floor",
                                   [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    gen = torch.Generator(device="cuda").manual_seed(20)
    cases = []
    for B, T, C, scale, what in ((BAT_B, 1536, 256, 1.0, "BAT encoder, 8 x 15 s"),
                                 (80, 97, 256, 1.0, "RWKV decoder call, B K = 80"),
                                 (2, 1, 64, 1.0, "edge: T = 1"),
                                 (3, 40, 33, 3.0, "edge: C = 33"),
                                 (1, 77, 256, 1.0, "edge: one row"),
                                 (2, 50, 64, 60.0, "edge: keys x 60, some at -1e30")):
        k = scale * torch.randn((B, T, C), generator=gen, device="cuda")
        if scale > 10:
            k[:, ::7] = -1e30
        v = torch.randn((B, T, C), generator=gen, device="cuda")
        w = torch.exp(torch.randn(C, generator=gen, device="cuda"))
        u = torch.randn(C, generator=gen, device="cuda")
        got, want = W.wkv(k, v, w, u), W.wkv_ref(k, v, w, u)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"wkv {what} finite")
        check(torch.equal(got, want), f"wkv {what}: not bit-equal to its twin (max err "
              f"{float((got - want).abs().max())})")
        case = dict(case=f"{what}: k, v ({B}, {T}, {C}) f32", max_abs_err=0.0, tolerance=0.0,
                    bit_equal=True)
        if not cases:
            out = torch.empty(32, device="cuda")
            floor = lambda: cuda_build.check(floor_fn(  # noqa: E731
                T, out.data_ptr(), torch.cuda.current_stream().cuda_stream), "wkv chain floor")
            chain = graph_ms(floor)
            t_bytes, _ = bound_ms(12.0 * B * T * C + 8.0 * C, {})
            case.update(ms=cuda_ms(lambda: W.wkv(k, v, w, u), iters=20),
                        graph_ms=graph_ms(lambda: W.wkv(k, v, w, u)),
                        plain_ms=cuda_ms(lambda: W.wkv_ref(k, v, w, u), iters=1, warmup=1),
                        chain_floor_ms=chain, bytes_bound_ms=t_bytes,
                        bound_ms=max(t_bytes, chain),
                        bound_by="operations" if chain >= t_bytes else "bytes",
                        library_ms=None)
        log(f"wkv {case}")
        cases.append(case)
    return cases


def check_alibi_attention(torch, A):
    """(i0) the float32 d = 64 attention with ALiBi at emotion2vec base's
    shape (B = 8, T = 759: 749 frames of 15 s and 10 extra tokens, 12 heads
    of 64, ragged key masks), within ``ATTN_TOL`` of the twin; edges: no
    extra tokens, all slopes 0 (bit-equal to the kernel without ALiBi) and
    one valid key; the served shape timed by events and CUDA graph beside
    the twin and SDPA with the same (B, H, T, T) float bias, and held at or
    under SDPA's time by events."""
    import torch.nn.functional as F

    from funasr_torch.models.emotion2vec.model import alibi_slopes

    B, T, H, d, ex = 8, 759, 12, 64, 10
    D = H * d
    gen = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn((B, T, D), generator=gen, device="cuda") / d ** 0.5
    k = torch.randn((B, T, D), generator=gen, device="cuda")
    v = torch.randn((B, T, D), generator=gen, device="cuda")
    scale = torch.rand(H, generator=gen, device="cuda") * 2 - 0.3
    slopes = torch.as_tensor(alibi_slopes(H), dtype=torch.float32, device="cuda") * scale.clamp(
        min=0)
    lens = torch.tensor([T, 700, 640, 555, 460, 300, 160, 110], device="cuda")

    def bias_of(n):
        return torch.where(torch.arange(T, device="cuda")[None] < n[:, None], 0.0, -1e30)

    cases = []
    for what, kb, sl, extra in (
            ("emotion2vec base, ragged keys", bias_of(lens), slopes, ex),
            ("edge: no extra tokens", bias_of(lens), slopes, 0),
            ("edge: all slopes 0", bias_of(lens), torch.zeros_like(slopes), ex),
            ("edge: one valid key", bias_of(torch.ones_like(lens)), slopes, ex)):
        got = A.fused_attention(q, k, v, kb, H, alibi_slopes=sl, extra=extra)
        want = A.attention_ref(q, k, v, kb, H, alibi_slopes=sl, extra=extra)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL["float32"],
              f"attention ALiBi {what}: max err {err} > {ATTN_TOL['float32']}")
        case = dict(case=f"{what}: q/k/v ({B}, {T}, {D}) f32, H={H}, extra {extra}",
                    max_abs_err=err, tolerance=ATTN_TOL["float32"])
        if "slopes 0" in what:
            plain = A.fused_attention(q, k, v, kb, H)
            check(torch.equal(got, plain), "attention ALiBi at zero slopes: not bit-equal to "
                  "the kernel without ALiBi")
            case["bit_equal_to_plain"] = True
        if not cases:
            run = lambda: A.fused_attention(q, k, v, kb, H, alibi_slopes=sl,  # noqa: E731
                                            extra=extra)
            full = (kb[:, None, None, :] + A.alibi_bias(sl, T, T, extra)[None]).contiguous()
            q4, k4, v4 = (x.unflatten(-1, (H, d)).transpose(1, 2) for x in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, attn_mask=full, scale=1.0)
            n_keys = float(lens.sum())
            nbytes = 4.0 * (2 * B * T * D + 2 * n_keys * D) + 4 * B * T + 4 * H
            bnd, by = bound_ms(nbytes, {"float32": 4.0 * T * n_keys * D})
            case.update(ms=cuda_ms(run, iters=10, warmup=3), graph_ms=graph_ms(run, iters=10),
                        plain_ms=cuda_ms(lambda: A.attention_ref(
                            q, k, v, kb, H, alibi_slopes=sl, extra=extra), iters=3, warmup=1),
                        library_ms=cuda_ms(sdpa, iters=10, warmup=3),
                        library_graph_ms=graph_ms(sdpa, iters=10), bound_ms=bnd, bound_by=by,
                        split_tf32_bound_ms=split_tf32_bound_ms(4.0 * T * n_keys * D))
            del full
            check(case["ms"] <= case["library_ms"],
                  f"attention ALiBi (i0) {what}: {case['ms']:.4f} ms > SDPA "
                  f"{case['library_ms']:.4f} ms with its float bias")
        log(f"attention ALiBi (i0) {case}")
        cases.append(case)
    return cases


def transducer_configs():
    """Phase (i)'s configs as dicts: the Transducer over the aishell
    Conformer encoder of ``TRANSDUCER_YAML`` (12 x 256, 4 heads, 2048,
    kernel 15, conv2d; 80 fbank bins, no LFR) with the JAX package's
    prediction-network and joint defaults (256), and RWKV-BAT with the JAX
    ``RWKVEncoder`` defaults (256 wide, 6 blocks, 1024 hidden) on the same
    frontend; vocab 4234, a single-CJK-char token list."""
    from funasr_torch.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    recipe = load_config(os.path.join(here, TRANSDUCER_YAML))
    V = TRANSDUCER_V
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(V - 4)] + ["<unk>"]
    common = dict(vocab_size=V, input_size=80, frontend_conf=recipe["frontend_conf"],
                  tokenizer_conf=dict(token_list=tokens))
    return (dict(common, model="Transducer", encoder_conf=recipe["encoder_conf"]),
            dict(common, model="RWKVBAT", encoder_conf={}))


def syllables(rng, n: int, f0: float):
    """A speech-like test signal for the transducers: a tone whose pitch
    glides by +-25 % at 1.3 Hz, under a 4 Hz syllable envelope with pauses,
    over noise.  A steady tone gives frames that barely vary, and a greedy
    RNN-T decode over them either stops after a few tokens or repeats one
    to ``max_tokens``, whatever its blank bias."""
    import numpy as np

    t = np.arange(n) / FS
    f = f0 * (1.0 + 0.25 * np.sin(2 * np.pi * 1.3 * t + rng.uniform(0, 2 * np.pi)))
    phase = 2 * np.pi * np.cumsum(f) / FS
    env = np.clip(np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 2 * np.pi)), 0, None) ** 2
    return (0.1 * env * (np.sin(phase) + 0.4 * np.sin(2.7 * phase))
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def set_joint(torch, module, rule) -> None:
    """Load a weight rule's joint tensors (``weight_rule``) into ``module``."""
    jn = module.joint_network
    with torch.no_grad():
        for name, value in rule.items():
            jn.get_parameter(name).copy_(value)


def weight_rule(torch, eng, probe):
    """The weight rule (``TR_TOKENS_PER_S``) on ``eng.module``'s joint, from
    the ``probe`` waveforms: ``lin_enc`` recentred on the probe's mean
    encoder frame and scaled so its output spreads by 1 over the probe's
    valid frames, then the blank bias shift that makes the probe's greedy
    decode emit ``TR_TOKENS_PER_S`` tokens a second on average, by bisection
    (``TR_RULE_STEPS`` decodes) between the shifts where the first attempt
    at the post-blank state emits on every valid frame and on none.
    Applies it; returns the joint's new tensors, by name."""
    module = eng.module
    jn = module.joint_network
    target = TR_TOKENS_PER_S * sum(len(w) for w in probe) / FS / len(probe)
    with torch.inference_mode():
        feats, flens = eng.frontend.device_features(*eng._pack(probe))
        enc, enc_lens = module.encode(feats, flens)
        B, T = enc.shape[:2]
        frames = enc[torch.arange(T, device=enc.device)[None] < enc_lens[:, None]].float()
        mu = frames.mean(dim=0)
        w = jn.lin_enc.weight.detach().float()
        k = 1.0 / float(((frames - mu) @ w.T).std())
        rule = {"lin_enc.weight": k * w, "lin_enc.bias": -k * (w @ mu)}
        set_joint(torch, module, rule)
        dec = module.decoder
        _, g = dec.step(dec.init_state(B, enc.device),
                        torch.full((B,), module.blank_id, dtype=torch.int64, device=enc.device))
        lg = jn(enc, g[:, None, :]).float()[
            torch.arange(T, device=enc.device)[None] < enc_lens[:, None]]
        blank = lg[:, module.blank_id].clone()
        lg[:, module.blank_id] = -float("inf")
        margin = lg.max(dim=-1).values - blank
        lo, hi = float(margin.min()) - 1.0, float(margin.max()) + 1.0
        bias = jn.lin_out.bias.detach().clone()
        for _ in range(TR_RULE_STEPS):
            mid = 0.5 * (lo + hi)
            set_joint(torch, module, {"lin_out.bias": bias + mid * (
                torch.arange(len(bias), device=bias.device) == module.blank_id)})
            emitted = float(module.greedy_decode(feats, flens, eng.max_tokens)[1].float().mean())
            lo, hi = (mid, hi) if emitted > target else (lo, mid)
        rule["lin_out.bias"] = bias + hi * (torch.arange(len(bias), device=bias.device)
                                            == module.blank_id)
        set_joint(torch, module, rule)
    return rule


def transducer_batch(torch, FK, A, CP, eng, wavs, zero, read, tag, twins, want_extra):
    """One ``TransducerEngine.transcribe`` of ``wavs``: the dispatch (``run``)
    under ``torch.cuda.set_sync_debug_mode("error")``, the counters from 0
    and held to fbank 1 plus ``want_extra``; the tokens' non-degeneracy
    (>= ``TR_MIN_DISTINCT`` distinct, at most half the rows at
    ``max_tokens``); then ``twins`` (a context) and the batch again: the
    tokens and records equal.  Returns (record, launches, tokens, counts)."""
    outs = []
    real = eng.run

    def kept(*a, **k):
        outs.append(real(*a, **k))
        return outs[-1]

    with guarded_entries(torch, (eng, "run")):
        eng.transcribe([w[: 2 * FS] for w in wavs[:2]])  # the first call, under the guard
    eng.run = sync_guarded(torch, kept)
    try:
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.transcribe(wavs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
    finally:
        del eng.run
    want = dict.fromkeys(launches, 0)
    want.update(fbank=1, **want_extra)
    check(launches == want, f"{tag} launches {launches}, want {want}")
    toks, counts = outs[-1]
    toks, counts = toks.cpu(), counts.cpu()
    emitted = [t for b in range(len(wavs)) for t in toks[b, : int(counts[b])].tolist()]
    distinct, capped = len(set(emitted)), int((counts == eng.max_tokens).sum())
    check(distinct >= TR_MIN_DISTINCT and 2 * capped <= len(wavs) and 0 not in emitted,
          f"{tag}: {distinct} distinct tokens, {capped} of {len(wavs)} rows at max_tokens")
    rec = dict(B=len(wavs), transcribe_wall_s=wall, launches=launches,
               tokens_per_row=counts.tolist(), distinct_tokens=distinct, rows_capped=capped,
               audio_s_per_s=sum(len(w) for w in wavs) / FS / wall)
    if twins is not None:
        eng.run = kept
        try:
            with twins:
                res_t = eng.transcribe(wavs)
        finally:
            del eng.run
        toks_t, counts_t = (x.cpu() for x in outs[-1])
        same = torch.equal(toks_t, toks) and torch.equal(counts_t, counts) and res_t == res
        check(same, f"{tag}: tokens or records differ on the twins")
        rec["twins_equal"] = True
    log(f"e2e {tag}: B={len(wavs)}, wall {wall:.3f} s, tokens a row {counts.tolist()}, "
        f"{distinct} distinct; launches {launches}")
    return rec, launches, res


def transducer_generate(torch, am, zero, read, wav, plan, tag, twins=None):
    """One ``generate`` of ``wav`` by a transducer ``AutoModel`` behind its VAD
    and punctuation, the VAD's segments replaced by ``plan``, every batch's
    dispatch under sync debug mode "error": counters exact (fbank once for
    the VAD and once a batch, the Conformer's gated int8 FFN ``w_1`` a batch,
    punctuation's d = 32 attention once a layer a window round; ``twins``
    launches none of the swapped kernels).  Returns (record, launches, stage
    times, batch shapes)."""
    from funasr_torch.utils.vad_utils import slice_audio_by_segments

    eng, ve, pm = am.engine, am.vad_engine, am.punc_engine.model
    clock, rounds = StageClock(torch), [0]
    real_argmax = pm._argmax

    def counted_argmax(text, lens):
        rounds[0] += 1
        return real_argmax(text, lens)

    pm._argmax = counted_argmax
    ve.model.segments_from_posteriors = (
        lambda post, db, f=ve.model.segments_from_posteriors: (f(post, db), plan)[1])
    eng.run = sync_guarded(torch, eng.run)
    clock.wrap(ve, "front", "vad_device", events=True)
    clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
    clock.wrap(eng, "run", "asr_dispatch", events=True)
    clock.wrap(pm, "inference_batch", "punc")
    zero()
    try:
        with twins if twins is not None else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = am.generate(wav, key=[tag])[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        clock.restore()
        for obj, attr in ((pm, "_argmax"), (ve.model, "segments_from_posteriors"),
                          (eng, "run")):
            delattr(obj, attr)
    clips = slice_audio_by_segments(wav, plan, FS)
    shapes = [(len(batch), max(len(clips[i]) for i in batch))
              for batch in am.batches(plan, FS, 300)]
    launches = read()
    want = dict.fromkeys(launches, 0)
    want.update(fbank=1 + len(shapes), attention=4 * rounds[0], attention_d32=4 * rounds[0])
    if twins is None:
        for B, N in shapes:
            for k, v in hybrid_batch_launches("conformer", B, N, 0, 0, 0).items():
                want[k] += v
    times = dict(generate_wall_s=wall, audio_s_per_s=len(wav) / FS / wall,
                 vad_device_ms=clock.device_ms("vad_device"),
                 vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                 asr_dispatch_wall_s=clock.wall.get("asr_dispatch", 0.0),
                 asr_device_span_ms=clock.device_ms("asr_dispatch", span=True),
                 punc_wall_s=clock.wall.get("punc", 0.0), punc_rounds=rounds[0])
    log(f"e2e {tag}: {len(plan)} segments in batches (B, samples) {shapes}; kernel launches "
        f"{launches}")
    check(launches == want, f"{tag} launches {launches}, want {want}")
    check(isinstance(res.get("text"), str) and res["text"] and res.get("timestamp") == []
          and "sentence_info" in res, f"{tag}: text, no stamps, sentence_info")
    return res, launches, times, shapes


def end_to_end_transducer(torch, FK, A, CP, profile_dir, card):
    """Phase (i1)-(i3): the transducer family at full width on seeded random
    weights under the weight rule (``weight_rule``, ``TR_TOKENS_PER_S``).  (i1) the Transducer
    (``transducer_configs``) through ``AutoModel``, ``TransducerEngine
    .transcribe`` of the beam cell's B = 32 x 15 s batch, int8
    (``quantize=True``: the Conformer's 24 gated FFN ``w_1`` on the int8
    GEMM) and float32, counters exact (fbank 1; int8: 24 rowquant + int8
    GEMM pairs), no host sync in the dispatch, the int8 tokens and records
    equal on the int8 twins, the float32 decisions on the fbank twin fed
    the kernels' decisions equal on >= ``TR_F32_MIN_AGREE`` of them; the
    wall and kernel launches a frame (a profile).  (i2) RWKV-BAT (float32,
    the JAX defaults) on B = 8 x 15 s: WKV launched 6 times a batch, tokens
    equal on the WKV twin, the encoder timed alone.  (i3) the int8
    Transducer behind FSMN-VAD and CT-Transformer: ``generate`` of the
    600 s recording on pipeline (b)'s plan, counters exact, no host sync in
    a dispatch, the record equal on the int8 twins.  Returns (launches,
    e2e record)."""
    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.auto.engines import TransducerEngine
    from funasr_torch.models.rwkv import RWKVBAT, RWKVEncoder
    from funasr_torch.models.transducer.model import Transducer
    from funasr_torch.ops import wkv as W
    from funasr_torch.utils.vad_utils import merge_vad

    zero, read = hybrid_counters(FK, A, CP)
    tr_cfg, bat_cfg = transducer_configs()
    N = 15 * FS
    rng = np.random.default_rng(3)
    wavs = [syllables(rng, N, 150.0 + 7 * i) for i in range(TRANSDUCER_B)]
    rng = np.random.default_rng(TR_PROBE_SEED)
    probe = [syllables(rng, N, 146.0 + 31 * i) for i in range(8)]
    e2e, paths, rule = {}, {}, None

    # ---- (i1) the Transducer, int8 then float32
    for tag, quantize in (("int8", True), ("float32", False)):
        t0 = time.time()
        am = AutoModel(model=tr_cfg, quantize=quantize, seed=TRANSDUCER_SEED)
        eng, module = am.engine, am.engine.module
        enc, dec, jn = module.encoder, module.decoder, module.joint_network
        check(isinstance(eng, TransducerEngine) and type(module) is Transducer
              and len(enc.encoders) == 12 and enc.output_size() == 256
              and enc.encoders[0].self_attn.n_head == 4
              and enc.encoders[0].conv_module.depthwise_conv.kernel_size == (15,)
              and dec.hidden_size == 256 and jn.lin_out.out_features == TRANSDUCER_V
              and eng.max_tokens == 128,
              f"(i1) {tag}: the recipe's Conformer, the JAX heads' widths, vocab 4234")
        if rule is None:
            rule = weight_rule(torch, eng, probe)
        else:
            set_joint(torch, module, rule)
        shift = float(rule["lin_out.bias"][module.blank_id])
        log(f"e2e (i1) Transducer {tag}: built in {time.time() - t0:.1f} s; the weight rule: "
            f"blank bias {shift:+.4f}, lin_enc x {float(rule['lin_enc.weight'].norm()):.3f}")
        int8 = (hybrid_batch_launches("conformer", TRANSDUCER_B, N, 0, 0, 0) if quantize
                else {})
        twins = int8_twins() if quantize else None
        rec, launches, res = transducer_batch(torch, FK, A, CP, eng, wavs, zero, read,
                                              f"(i1) Transducer {tag}", twins, int8)
        rec["blank_shift"] = shift
        T_enc = encoder_frames(N)
        steps = T_enc * module.max_symbols_per_frame
        if quantize:  # a profile: launches a frame
            prof = profile(torch, lambda: eng.transcribe(wavs), profile_dir,
                           1e3 * rec["transcribe_wall_s"], "profile_transducer.txt")
            prof["kernel launches a frame"] = prof["kernel launches"] / T_enc
            prof["kernel launches an emit step"] = prof["kernel launches"] / steps
            prof["idle share"] = 1.0 - prof["kernel share of batch_ms"]
            rec["profile"] = prof
        else:  # the fbank twin, the decisions teacher-forced
            with torch.inference_mode():
                wav_d, lens_d = eng._pack(wavs)
                feats, flens = eng.frontend.device_features(wav_d, lens_d)
                with plain_twins(FK, A):
                    feats_t, flens_t = eng.frontend.device_features(wav_d, lens_d)
            toks, counts, picks, live = module.greedy_decode(feats, flens, 128,
                                                             return_decisions=True)
            served = eng.run(wav_d, lens_d)
            check(torch.equal(toks, served[0]) and torch.equal(counts, served[1]),
                  "(i1) float32: the decode with its decisions is the served decode")
            picks_t = module.greedy_decode(feats_t, flens_t, 128, forced=picks,
                                           return_decisions=True)[2]
            agree = float((picks_t == picks)[live].float().mean())
            n_live = int(live.sum())
            check(agree >= TR_F32_MIN_AGREE, f"(i1) float32: decisions on the fbank twin "
                  f"agree {agree} < {TR_F32_MIN_AGREE}")
            rec.update(twins_decision_agreement=agree, decisions=n_live,
                       fbank_feature_max_abs_diff=float((feats - feats_t).abs().max()))
            log(f"e2e (i1) float32: {n_live} decisions, {agree:.6f} equal on the fbank twin fed "
                "the kernels' decisions")
        rec.update(encoder_frames=T_enc, emit_steps=steps)
        log(f"e2e (i1) Transducer {tag} on {card}: {json.dumps(rec)}")
        e2e[f"transducer_i1_{tag}"] = rec
        paths[f"i1_{tag}"] = launches
        del am, eng, module
        torch.cuda.empty_cache()

    # ---- (i2) RWKV-BAT, float32, B = 8
    t0 = time.time()
    am = AutoModel(model=bat_cfg, seed=BAT_SEED)
    eng, module = am.engine, am.engine.module
    enc = module.encoder
    check(type(module) is RWKVBAT and type(enc) is RWKVEncoder and len(enc.blocks) == 6
          and enc.output_size() == 256 and enc.blocks[0].ffn.key.out_features == 1024
          and module.decoder.hidden_size == 256, "(i2) RWKV-BAT at the JAX defaults")
    # the causal RWKV encoder's mean frame does not depend on the length: 5 s rows
    bat_shift = float(weight_rule(torch, eng, [w[: 5 * FS] for w in probe])[
        "lin_out.bias"][module.blank_id])
    bat_wavs = wavs[:BAT_B]
    rec, launches, _ = transducer_batch(torch, FK, A, CP, eng, bat_wavs, zero, read,
                                        "(i2) RWKV-BAT float32",
                                        swapped([(W, "wkv", W.wkv_ref)]),
                                        {"wkv": len(enc.blocks)})
    with torch.inference_mode():
        feats, flens = eng.frontend.device_features(*eng._pack(bat_wavs))
        enc_ms = cuda_ms(lambda: module.encoder(feats, flens), iters=5, warmup=2)
    rec.update(blank_shift=bat_shift, encoder_ms=enc_ms, frames=int(feats.shape[1]),
               built_s=time.time() - t0)
    log(f"e2e (i2) RWKV-BAT on {card}: {json.dumps(rec)}")
    e2e["bat_i2"] = rec
    paths["i2"] = launches
    del am, eng, module, feats
    torch.cuda.empty_cache()

    # ---- (i3) the int8 Transducer behind FSMN-VAD and CT-Transformer
    _, vad_cfg, punc_cfg = pipeline_configs()
    am = AutoModel(model=tr_cfg, vad_model=vad_cfg, punc_model=punc_cfg, quantize=True,
                   seed=TRANSDUCER_SEED)
    set_joint(torch, am.engine.module, rule)
    wav, bursts = pipeline_recording(np.random.default_rng(12))
    plan = merge_vad(bursts, 15000)
    first = transducer_generate(torch, am, zero, read, wav, plan, "(i3) first")[2]
    res, launches3, times, shapes = transducer_generate(torch, am, zero, read, wav, plan,
                                                        "(i3) 600 s")
    res_t, launches_t, _, _ = transducer_generate(torch, am, zero, read, wav, plan,
                                                  "(i3) on the int8 twins", int8_twins())
    check(res_t == dict(res, key=res_t["key"]), "(i3) the record differs on the int8 twins")
    log(f"e2e (i3) on {card}: {json.dumps(times)}; first call {json.dumps(first)}; text "
        f"{res['text'][:24]}..., {len(res['sentence_info'])} sentences; record equal on the "
        "int8 twins")
    e2e["transducer_i3"] = dict(times, first_call=first, segments=len(plan), batches=shapes,
                                launches=launches3, twins_record_equal=True)
    paths["i3"] = launches3
    paths["i3_twins"] = launches_t
    del am
    torch.cuda.empty_cache()
    total = {k: sum(d.get(k, 0) for d in paths.values()) for k in read()}
    return total, e2e


def end_to_end_emotion2vec(torch, FK, A, CP, profile_dir, card):
    """Phase (i4): emotion2vec base at the JAX defaults (768 wide, 4 + 8
    blocks, 12 heads of 64, MLP 3072, 9 labels; float32) on seeded random
    weights (``init_weights_``) through ``AutoModel(model={"model":
    "Emotion2vec"})``: ``generate`` of B = 8 utterances of 15-2 s with
    ``extract_embedding=True``, the ALiBi attention launched exactly 12
    times a batch and nothing else counted, no host sync in the dispatch
    (``Emotion2vec.run``); on the twins (fbank is not on this path: the
    attention's) scores within ``E2V_TOL``, labels equal wherever the
    twins' top-2 margin exceeds it, feats within ``E2V_TOL`` x max |twin|;
    the wall and a profile (``DIR/profile_emotion2vec.txt``).  Returns
    (launches, e2e record)."""
    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.auto.engines import SerEngine

    zero, read = hybrid_counters(FK, A, CP)
    t0 = time.time()
    am = AutoModel(model={"model": "Emotion2vec"}, seed=E2V_SEED)
    eng, model = am.engine, am.engine.model
    enc = model.modality_encoders["AUDIO"]
    blocks = (len(enc.context_encoder.blocks), len(model.blocks))
    check(isinstance(eng, SerEngine) and blocks == (4, 8) and model.n_head == 12
          and model.proj.in_features == 768 and model.blocks[0].mlp.fc1.out_features == 3072
          and len(model.labels) == 9 and enc.extra_tokens.shape[1] == 10,
          "(i4) emotion2vec base at the JAX defaults")
    rng = np.random.default_rng(8)
    wavs = [waveform(rng, s * FS, 120.0 + 17 * i) for i, s in enumerate(E2V_AUDIO_S)]
    with guarded_entries(torch, (model, "run")):
        eng.transcribe(wavs[:2])  # the first call (cuDNN's plans), under the guard
    real = model.run
    model.run = sync_guarded(torch, real)
    walls = []
    try:
        for _ in range(2):
            zero()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = eng.transcribe(wavs, extract_embedding=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            launches = read()
            want = dict.fromkeys(launches, 0)
            want.update(attention_alibi64=sum(blocks))
            check(launches == want, f"(i4) launches {launches}, want {want}")
    finally:
        del model.run
    with plain_twins(FK, A):
        res_t = eng.transcribe(wavs, extract_embedding=True)
    scores = np.array([r["scores"] for r in res])
    scores_t = np.array([r["scores"] for r in res_t])
    feats = np.stack([r["feats"] for r in res])
    feats_t = np.stack([r["feats"] for r in res_t])
    d_score = float(np.abs(scores - scores_t).max())
    d_feat = float(np.abs(feats - feats_t).max())
    top2 = np.sort(scores_t, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > E2V_TOL
    labels_equal = [r["text"] == rt["text"] for r, rt in zip(res, res_t)]
    check(np.isfinite(scores).all() and np.allclose(scores.sum(-1), 1.0, atol=1e-5)
          and d_score <= E2V_TOL and d_feat <= E2V_TOL * float(np.abs(feats_t).max())
          and all(eq for eq, s in zip(labels_equal, sure) if s),
          f"(i4) kernels against twins: |dscore| {d_score}, |dfeat| {d_feat}, labels "
          f"{labels_equal} where sure {sure.tolist()}")
    prof = profile(torch, lambda: eng.transcribe(wavs), profile_dir, 1e3 * min(walls),
                   "profile_emotion2vec.txt")
    prof["idle share"] = 1.0 - prof["kernel share of batch_ms"]
    rec = dict(B=len(wavs), audio_s=list(E2V_AUDIO_S), generate_wall_s=walls,
               launches=launches, score_max_abs_diff=d_score, feats_max_abs_diff=d_feat,
               labels=[r["text"] for r in res], labels_equal=labels_equal,
               built_s=time.time() - t0, profile=prof,
               audio_s_per_s=[sum(E2V_AUDIO_S) / w for w in walls])
    log(f"e2e (i4) emotion2vec on {card}: {json.dumps(rec)}")
    del am, eng, model
    torch.cuda.empty_cache()
    return launches, {"emotion2vec_i4": rec}


# phase (j): SCAMA and the streaming punctuation
SCAMA_SEED = 2070
SCAMA_B = 32  # (j1)'s timed batch: the beam cell's B x 15 s
SCAMA_LAYERS = 50  # encoder layers (encoders0 + 49): a fused int8 FFN and a QDense QKV each
SCAMA_CROSS = 16  # the decoder's cross K/V projections (QDense), once a batch
SCAMA_F32_MIN_AGREE = 0.99  # float32 top-hypothesis tokens, kernels against the twins
SCAMA_MIN_DISTINCT = 16  # distinct tokens a set of batches: no fixed point
PUNC_STREAM_CALLS = 60  # (j3): calls of 5-25 words, then the final flush
PUNC_STREAM_SEED = 2072


def scama_configs():
    """Phase (j)'s configs as dicts.  SCAMA: the repository holds no SCAMA
    YAML, so the widths are Paraformer-large's (``FLAGSHIP``,
    ``__graft_entry__.py:13``): vocab 8404, 560 inputs, 50 SANM encoder
    layers of 512 (4 heads, 2048 units, kernel 11), the CIF predictor; the
    decoder ``FsmnDecoderSCAMAOpt`` with 16 full layers and no FSMN-only
    one, kernel 11, its causal FSMN (the flagship decoder's ``sanm_shfit``
    0 left out); chunks of 10 frames, no look-back limit; decoding beam 5,
    maxlen 96, CTC weight 0 (the JAX AutoModel's defaults); the pipeline's
    frontend and single-CJK-char token list.  With it the pipeline's
    FSMN-VAD and CT-Transformer."""
    asr, vad, punc = pipeline_configs()
    dec = {k: v for k, v in FLAGSHIP["decoder_conf"].items() if k != "sanm_shfit"}
    scama = dict(model="SCAMA", vocab_size=asr["vocab_size"], input_size=asr["input_size"],
                 encoder_conf=asr["encoder_conf"], decoder_conf=dec,
                 predictor_conf=asr["predictor_conf"], model_conf=asr["model_conf"],
                 frontend_conf=asr["frontend_conf"], tokenizer_conf=asr["tokenizer_conf"],
                 decoding_conf=dict(beam_size=5, maxlenratio_tokens=96,
                                    decoding_ctc_weight=0.0))
    return scama, vad, punc


def lfr_frames(n_samples: int) -> int:
    """Encoder frames of a batch padded to ``n_samples``: the bucket's fbank
    frames, LFR by 6, padded to a multiple of 128."""
    from funasr_torch.auto.engines import quantize

    lfr = -(-((quantize(n_samples) - 400) // 160 + 1) // 6)
    return -(-lfr // 128) * 128


def scama_batch_launches(B, n_samples):
    """The int8 launches of one SCAMA batch of B x ``n_samples`` under
    ``quantize=True``, stated from the JAX layout: every encoder layer on the
    module path under the chunk mask (sanm.py:510-516), its FFN one fused
    int8 FFN (two rowquant and two int8 GEMM launches) and its QKV (N =
    1536) a QDense pair when the B x T rows pass the int8 gate; the
    decoder's 16 cross K/V projections (N = 1024) pairs on the same rows,
    once a batch; the decode steps' B x beam rows pass no gate; no attention
    kernel (every attention has a per-query mask)."""
    gated = B * lfr_frames(n_samples) >= INT8_MIN_ROWS
    pairs = 2 * SCAMA_LAYERS + (SCAMA_LAYERS + SCAMA_CROSS) * gated
    return dict(ffn=SCAMA_LAYERS, rowquant=pairs, int8_gemm=pairs)


def sync_lifted(torch, f):
    """``f`` with the sync debug mode off: a documented host sync inside a
    guarded dispatch (the beam's ``all_finished``, one a step)."""
    def call(*a, **k):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return f(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    return call


def check_scama_kernels(torch, G, RQ, FF, Q):
    """The SCAMA path's int8 kernels at its B = 32 x 15 s shapes (M = 32 x 256
    LFR frames): QDense's row quantize ("div") and the int8 GEMM with the
    QDense epilogue at encoders0's QKV (K = 560), a layer's QKV (512 ->
    1536) and the decoder's cross K/V (512 -> 1024), each bit-equal to its
    twin; the fused int8 FFN (512 -> 2048 -> 512) against its twin within
    ``INT8_LAYER_TOL``.  -> {"int8_gemm", "rowquant", "ffn"} case lists."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    M = SCAMA_B * lfr_frames(15 * FS)
    out = {"int8_gemm": [], "rowquant": [], "ffn": []}
    for K, N, what in ((560, 1536, "SCAMA encoders0 QKV"), (512, 1536, "SCAMA layer QKV"),
                       (512, 1024, "SCAMA decoder cross K/V")):
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        w8, sw = Q.quantize_weight(torch.randn((N, K), generator=gen, device="cuda")
                                   * K ** -0.5)
        bias = (0.1 * torch.randn(N, generator=gen, device="cuda")).to(torch.bfloat16).float()
        qd = dict(bias=bias, round_bf16=True, out_dtype=torch.bfloat16)
        q, sx = RQ.rowquant(x, form="div")
        q_r, sx_r = RQ.rowquant_ref(x, form="div")
        y, y_r = G.int8_gemm(q, sx, w8, sw, **qd), G.int8_gemm_ref(q_r, sx_r, w8, sw, **qd)
        torch.cuda.synchronize()
        rq_equal = torch.equal(q, q_r) and torch.equal(sx, sx_r)
        check(rq_equal and torch.equal(y, y_r), f"{what}: rowquant and int8 GEMM bit-equal "
              f"to their twins (rowquant {rq_equal})")
        bnd, by = bound_ms(M * K + N * K + 4 * (M + 2 * N) + 2 * M * N,
                           {"int8": 2.0 * M * N * K})
        case = dict(case=f"{what}: ({M}, {K}) x ({N}, {K}) int8 -> bf16 (QDense)",
                    max_abs_err=0.0, tolerance=0.0,
                    ms=cuda_ms(lambda: G.int8_gemm(q, sx, w8, sw, **qd)),
                    plain_ms=cuda_ms(lambda: G.int8_gemm_ref(q, sx, w8, sw, **qd), iters=3),
                    library_ms=cuda_ms(lambda: torch._int_mm(q, w8.t())),
                    bound_ms=bnd, bound_by=by)
        log(f"int8 gemm {case}")
        out["int8_gemm"].append(case)
        bnd, by = bound_ms(3 * M * K + 4 * M, {})
        case = dict(case=f"{what}: ({M}, {K}) bf16, form div", max_abs_err=0.0,
                    tolerance=0.0, bit_equal=rq_equal,
                    ms=graph_ms(lambda: RQ.rowquant(x, form="div")),
                    plain_ms=cuda_ms(lambda: RQ.rowquant_ref(x, form="div"), iters=3),
                    library_ms=None, bound_ms=bnd, bound_by=by)
        log(f"rowquant {case}")
        out["rowquant"].append(case)
    D, H = 512, 2048
    r = lambda *shape, sc: torch.randn(shape, generator=gen, device="cuda") * sc  # noqa: E731
    w = FF.quantize_ffn(r(H, D, sc=D ** -0.5), r(H, sc=0.1), r(D, H, sc=H ** -0.5), r(D, sc=0.1))
    x = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
    got, want = FF.fused_ffn_int8(x, w), FF.ffn_int8_ref(x, w)
    out["ffn"].append(_layer_case(
        torch, f"SCAMA encoder FFN M={M} {D} -> {H} -> {D}", got, want,
        torch.ones_like(got, dtype=torch.float32), cuda_ms(lambda: FF.fused_ffn_int8(x, w)),
        cuda_ms(lambda: FF.ffn_int8_ref(x, w), iters=3),
        2 * 2 * M * D + 2 * D * H + 4 * (2 * H + 2 * D), {"int8": 2.0 * M * 2 * D * H},
        lambda: FF.fused_ffn_int8(x, w)))
    log(f"int8 layer {out['ffn'][-1]}")
    return out


def scama_serve(torch, am, zero, read, batches, tag, want_fn, twins=None):
    """``am.generate`` of each batch in ``batches`` (one batch a call), the
    engine's dispatch (``run``) under the sync guard but for the beam's one
    sync a step, the counters from 0 and held to ``want_fn(B, n_samples)``
    summed over the batches; ``twins`` (a context) swaps kernels.
    -> (records, top-hypothesis tokens and lengths a batch, launches, wall
    s, decode steps)."""
    from funasr_torch.ops import beam_search as TB

    eng = am.engine
    outs, real_all = [], TB.all_finished
    real_run = eng.run

    def kept(*a, **k):
        outs.append(real_run(*a, **k))
        return outs[-1]

    eng.run = sync_guarded(torch, kept)
    TB.all_finished = sync_lifted(torch, real_all)
    zero()
    steps0 = eng.steps
    try:
        with twins if twins is not None else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [am.generate(b, key=[f"r{i}" for i in range(len(b))], batch_size=len(b))
                   for b in batches]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        TB.all_finished = real_all
        del eng.run
    launches = read()
    want = dict.fromkeys(launches, 0)
    for b in batches:
        for k, v in want_fn(len(b), max(len(w) for w in b)).items():
            want[k] += v
    check(launches == want, f"{tag} launches {launches}, want {want}")
    toks = [(o.tokens[:, 0].cpu(), o.lengths[:, 0].cpu()) for o in outs]
    return res, toks, launches, wall, eng.steps - steps0


def scama_generate(torch, am, zero, read, wav, plan, tag, twins=None):
    """One ``generate(with_timestamp=False)`` of ``wav`` by the SCAMA
    ``AutoModel`` behind its VAD and punctuation, the VAD's segments replaced
    by ``plan``, every batch's dispatch under the sync guard but for the
    beam's one sync a step: counters exact (fbank once for the VAD and once
    a batch, each batch's int8 launches by ``scama_batch_launches``,
    punctuation's d = 32 attention once a layer a window round; ``twins``
    launches none of the swapped kernels).  Returns (record, launches, stage
    times, batch shapes)."""
    from funasr_torch.ops import beam_search as TB
    from funasr_torch.utils.vad_utils import slice_audio_by_segments

    eng, ve, pm = am.engine, am.vad_engine, am.punc_engine.model
    clock, rounds = StageClock(torch), [0]
    real_argmax, real_all = pm._argmax, TB.all_finished

    def counted_argmax(text, lens):
        rounds[0] += 1
        return real_argmax(text, lens)

    pm._argmax = counted_argmax
    ve.model.segments_from_posteriors = (
        lambda post, db, f=ve.model.segments_from_posteriors: (f(post, db), plan)[1])
    eng.run = sync_guarded(torch, eng.run)
    TB.all_finished = sync_lifted(torch, real_all)
    clock.wrap(ve, "front", "vad_device", events=True)
    clock.wrap(ve.model, "segments_from_posteriors", "vad_host")
    clock.wrap(eng, "run", "asr_beam", events=True)
    clock.wrap(pm, "inference_batch", "punc")
    zero()
    steps0 = eng.steps
    try:
        with twins if twins is not None else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = am.generate(wav, key=[tag], with_timestamp=False)[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        clock.restore()
        TB.all_finished = real_all
        for obj, attr in ((pm, "_argmax"), (ve.model, "segments_from_posteriors"),
                          (eng, "run")):
            delattr(obj, attr)
    clips = slice_audio_by_segments(wav, plan, FS)
    shapes = [(len(batch), max(len(clips[i]) for i in batch))
              for batch in am.batches(plan, FS, 300)]
    launches = read()
    want = dict.fromkeys(launches, 0)
    want.update(fbank=1 + len(shapes), attention=4 * rounds[0], attention_d32=4 * rounds[0])
    if twins is None:
        for B, N in shapes:
            for k, v in scama_batch_launches(B, N).items():
                want[k] += v
    times = dict(generate_wall_s=wall, audio_s_per_s=len(wav) / FS / wall,
                 vad_device_ms=clock.device_ms("vad_device"),
                 vad_host_wall_s=clock.wall.get("vad_host", 0.0),
                 asr_beam_wall_s=clock.wall.get("asr_beam", 0.0),
                 asr_beam_span_ms=clock.device_ms("asr_beam", span=True),
                 punc_wall_s=clock.wall.get("punc", 0.0), punc_rounds=rounds[0],
                 decode_steps=eng.steps - steps0)
    log(f"e2e {tag}: {len(plan)} segments in batches (B, samples) {shapes}; kernel launches "
        f"{launches}")
    check(launches == want, f"{tag} launches {launches}, want {want}")
    check(isinstance(res.get("text"), str) and res["text"] and "timestamp" not in res,
          f"{tag}: a text, no stamps")
    return res, launches, times, shapes


def end_to_end_scama(torch, FK, A, CP, profile_dir, card):
    """Phase (j1)-(j2): SCAMA at Paraformer-large's widths (``scama_configs``)
    on seeded random weights through ``AutoModel``.  (j1) int8
    (``quantize=True``) ``generate`` of three batches of mixed 2-15 s
    requests, the counters exact (fbank one a batch, the fused int8 FFN and
    the QDense pairs of ``scama_batch_launches``), no host sync in a
    dispatch but the beam's ``all_finished``, the records equal on the int8
    twins, >= ``SCAMA_MIN_DISTINCT`` distinct tokens; float32 the same
    batches on the kernels (fbank one a batch, nothing else) and on the
    twins, top-hypothesis tokens equal on >= ``SCAMA_F32_MIN_AGREE``; the
    B = 32 x 15 s batch timed (wall, decode steps, ms a step) and profiled
    (launches a step, the idle share).  (j2) the int8 SCAMA behind FSMN-VAD
    and CT-Transformer: ``generate(with_timestamp=False)`` of the 600 s
    recording on pipeline (b)'s plan, counters exact, the record equal on
    the int8 twins; with timestamps (the pipeline's default) it raises, as
    the JAX package fails there.  Returns (launches, e2e record)."""
    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.auto.engines import HybridEngine
    from funasr_torch.models.scama.decoder import FsmnDecoderSCAMAOpt
    from funasr_torch.models.scama.model import SCAMA
    from funasr_torch.utils.vad_utils import merge_vad

    zero, read = hybrid_counters(FK, A, CP)
    scama_cfg, vad_cfg, punc_cfg = scama_configs()
    rng = np.random.default_rng(40)
    batches = []
    for size in (8, 16, 5):
        n = rng.integers(2 * FS, 15 * FS + 1, size)
        batches.append([waveform(rng, int(m), float(rng.uniform(100, 400))) for m in n])
    e2e, paths = {}, {}
    served = lambda B, n: dict(fbank=1, **scama_batch_launches(B, n))  # noqa: E731
    fbank_only = lambda B, n: {"fbank": 1}  # noqa: E731

    # ---- (j1) int8, then float32
    for tag, quantize in (("int8", True), ("float32", False)):
        t0 = time.time()
        am = AutoModel(model=scama_cfg, quantize=quantize, seed=SCAMA_SEED)
        eng, module = am.engine, am.engine.module
        enc, dec = module.encoder, module.decoder
        check(isinstance(eng, HybridEngine) and type(module) is SCAMA
              and (eng.beam, eng.maxlen, eng.decoding_ctc_weight) == (5, 96, 0.0)
              and len(enc.encoders0) + len(enc.encoders) == SCAMA_LAYERS
              and enc.output_size() == 512 and enc.encoders[0].self_attn.n_head == 4
              and type(dec) is FsmnDecoderSCAMAOpt and len(dec.decoders) == SCAMA_CROSS
              and dec.decoders2 is None and dec.kernel_size == 11
              and dec.decoders[0].self_attn.left == 10 and module.vocab_size == 8404
              and (module.chunk_size, module.left_chunks) == (10, -1),
              f"(j1) {tag}: SCAMA at Paraformer-large's widths, the causal FSMN decoder")
        log(f"e2e (j1) SCAMA {tag}: built in {time.time() - t0:.1f} s")
        res, toks, launches, wall, steps = scama_serve(
            torch, am, zero, read, batches, f"(j1) {tag}", served if quantize else fbank_only)
        emitted = [t for tk, ln in toks for b in range(len(ln))
                   for t in tk[b, : int(ln[b])].tolist()]
        distinct = len(set(emitted))
        check(distinct >= SCAMA_MIN_DISTINCT and all(r["text"] for rs in res for r in rs),
              f"(j1) {tag}: {distinct} distinct tokens, every record a text")
        rec = dict(requests=sum(map(len, batches)), generate_wall_s=wall, decode_steps=steps,
                   launches=launches, distinct_tokens=distinct,
                   tokens_per_row=[ln.tolist() for _, ln in toks])
        if quantize:
            res_t, toks_t, _, _, _ = scama_serve(torch, am, zero, read, batches,
                                                 f"(j1) {tag} twins", fbank_only, int8_twins())
            same = res_t == res and all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                                        for a, b in zip(toks, toks_t))
            check(same, "(j1) int8: tokens or records differ on the int8 twins")
            rec["twins_equal"] = True
            # the timed B = 32 x 15 s batch, its dispatch under the guard
            wavs = [waveform(np.random.default_rng(41 + i), 15 * FS, 150.0 + 7 * i)
                    for i in range(SCAMA_B)]
            _, _, launches32, wall32, steps32 = scama_serve(
                torch, am, zero, read, [wavs], "(j1) B=32", served)
            prof = profile(torch, lambda: eng.transcribe(wavs), profile_dir, 1e3 * wall32,
                           "profile_scama.txt")
            rec["b32"] = dict(wall_s=wall32, decode_steps=steps32,
                              ms_a_step=1e3 * wall32 / max(steps32, 1), launches=launches32,
                              kernel_launches_a_step=prof["kernel launches"] / max(steps32, 1),
                              idle_share=1.0 - prof["kernel share of batch_ms"],
                              profile=prof, audio_s_per_s=SCAMA_B * 15 / wall32)
            log(f"e2e (j1) SCAMA B=32 x 15 s on {card}: wall {wall32:.3f} s, {steps32} decode "
                f"steps, {rec['b32']['ms_a_step']:.2f} ms and "
                f"{rec['b32']['kernel_launches_a_step']:.0f} kernel launches a step, idle "
                f"share {rec['b32']['idle_share']:.3f}")
            paths["j1_b32"] = launches32
        else:
            res_t, toks_t, _, _, _ = scama_serve(torch, am, zero, read, batches,
                                                 f"(j1) {tag} twins", lambda B, n: {},
                                                 plain_twins(FK, A))
            same = total = 0
            for (tk, ln), (tt, lt) in zip(toks, toks_t):
                for b in range(len(ln)):
                    n = max(int(ln[b]), int(lt[b]), 1)
                    same += int((tk[b, :n] == tt[b, :n]).sum())
                    total += n
            agree = same / total
            check(agree >= SCAMA_F32_MIN_AGREE, f"(j1) float32: tokens on the twins agree "
                  f"{agree} < {SCAMA_F32_MIN_AGREE}")
            rec.update(twins_token_agreement=agree, twins_records_equal=res_t == res)
        log(f"e2e (j1) SCAMA {tag} on {card}: {json.dumps(rec)}")
        e2e[f"scama_j1_{tag}"] = rec
        paths[f"j1_{tag}"] = launches
        del am, eng, module
        torch.cuda.empty_cache()

    # ---- (j2) behind FSMN-VAD and CT-Transformer, no timestamps
    am = AutoModel(model=scama_cfg, vad_model=vad_cfg, punc_model=punc_cfg, quantize=True,
                   seed=SCAMA_SEED)
    wav, bursts = pipeline_recording(np.random.default_rng(12))
    plan = merge_vad(bursts, 15000)
    first = scama_generate(torch, am, zero, read, wav, plan, "(j2) first")[2]
    res, launches2, times, shapes = scama_generate(torch, am, zero, read, wav, plan,
                                                   "(j2) 600 s")
    res_t, launches_t, _, _ = scama_generate(torch, am, zero, read, wav, plan,
                                             "(j2) on the int8 twins", int8_twins())
    check(res_t == dict(res, key=res_t["key"]), "(j2) the record differs on the int8 twins")
    # with timestamps (the pipeline's default) the call raises, naming the cause
    ve, raised = am.vad_engine, None
    ve.model.segments_from_posteriors = (
        lambda post, db, f=ve.model.segments_from_posteriors: (f(post, db), plan[:2])[1])
    try:
        am.generate(wav[: 60 * FS], key=["ts"])
    except NotImplementedError as err:
        raised = str(err)
    finally:
        del ve.model.segments_from_posteriors
    check(raised is not None and "SCAMA has no timestamps" in raised,
          f"(j2) with timestamps SCAMA raises, naming the cause: {raised}")
    log(f"e2e (j2) on {card}: {json.dumps(times)}; first call {json.dumps(first)}; text "
        f"{res['text'][:24]}...; record equal on the int8 twins")
    e2e["scama_j2"] = dict(times, first_call=first, segments=len(plan), batches=shapes,
                           launches=launches2, twins_record_equal=True)
    paths["j2"] = launches2
    paths["j2_twins"] = launches_t
    del am
    torch.cuda.empty_cache()
    total = {k: sum(d.get(k, 0) for d in paths.values()) for k in read()}
    return total, e2e


def end_to_end_stream_punc(torch, FK, A, CP, card):
    """Phase (j3): the streaming CT-Transformer at
    ``configs/ct_transformer_punc.yaml``'s widths (vocab 272727, 256, 8
    heads, 4 blocks) through ``AutoModel(model=CTTransformerStreaming,
    quantize=True)`` (bf16) on seeded random weights, and the same weights
    in float32: ``punctuate_streaming`` of ``PUNC_STREAM_CALLS`` calls of
    5-25 words, then the final flush, each masked forward dispatched under
    the sync guard; the path launches none of the port's kernels (the
    masked attention is the JAX package's XLA path); every word committed
    once, the bf16 labels equal to the float32 ones on >=
    ``PUNC_MIN_AGREE``; the ms a call.  Returns (launches, e2e record)."""
    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.models.ct_transformer.streaming import CTTransformerStreamingModel

    zero, read = hybrid_counters(FK, A, CP)
    _, _, punc = pipeline_configs()
    cfg = dict(punc, model="CTTransformerStreaming")
    am = AutoModel(model=cfg, quantize=True, seed=PUNC_STREAM_SEED)
    am32 = AutoModel(model=cfg, seed=PUNC_STREAM_SEED)
    m, m32 = am.engine.model, am32.engine.model
    enc = m.module.encoder
    check(type(m) is CTTransformerStreamingModel and m.module.dtype == torch.bfloat16
          and m32.module.dtype == torch.float32
          and m.module.embed.num_embeddings == 272727 and enc.output_size() == 256
          and len(enc.encoders0) + len(enc.encoders) == 4
          and enc.encoders[0].self_attn.n_head == 8,
          "(j3) the streaming punctuation at ct_transformer_punc.yaml's widths, bf16")
    m32.module.load_state_dict(m.module.state_dict())  # the bf16 weights, exactly
    tokens = cfg["tokenizer_conf"]["token_list"]
    rng = np.random.default_rng(PUNC_STREAM_SEED)
    texts = ["".join(tokens[int(i)] for i in rng.integers(3, len(tokens), int(n)))
             for n in rng.integers(5, 26, PUNC_STREAM_CALLS)]

    def stream(model):
        cache, labels, ms = {}, [], []
        real = model.module.forward
        model.module.forward = sync_guarded(torch, real)
        try:
            for i, text in enumerate(texts + [""]):
                t = time.perf_counter()
                out = model.punctuate_streaming(text, cache, is_final=i == len(texts))
                ms.append(1e3 * (time.perf_counter() - t))
                labels.append(out["punc_array"])
        finally:
            del model.module.forward
        return np.concatenate(labels), ms

    zero()
    labels, ms = stream(m)
    launches = read()
    labels32, ms32 = stream(m32)
    n_words = sum(len(t) for t in texts)
    check(len(labels) == len(labels32) == n_words,
          f"(j3) every word committed once: {len(labels)}, {len(labels32)} of {n_words}")
    check(not any(launches.values()), f"(j3) no kernel on this path: launches {launches}")
    agree = float((labels == labels32).mean())
    check(agree >= PUNC_MIN_AGREE, f"(j3) bf16 labels agree {agree} < {PUNC_MIN_AGREE}")
    hist = np.bincount(labels, minlength=len(m.punc_list)).tolist()
    rec = dict(calls=len(texts) + 1, words=n_words, label_agreement_f32=agree,
               labels_by_class=hist, ms_a_call=float(np.mean(ms)),
               ms_a_call_median=float(np.median(ms)), ms_first_call=ms[0],
               ms_a_call_f32=float(np.mean(ms32)), launches=launches)
    log(f"e2e (j3) streaming punctuation on {card}: {json.dumps(rec)}")
    del am, am32
    torch.cuda.empty_cache()
    return launches, {"stream_punc_j3": rec}


# Phase (k): Paraformer training.  bench_train.py:102-124's Paraformer-large
# (FLAGSHIP with the encoder's remat), bf16 compute on float32 parameters,
# AdamW 1e-4 with weight decay 1e-6, clip 5, accum_grad 2 x 32 utterances of
# 15 s with 48 tokens each.
TRAIN_LARGE = dict(FLAGSHIP, encoder_conf=dict(FLAGSHIP["encoder_conf"], remat=True))
TRAIN_OPTIM = ("adamw", dict(lr=1e-4, weight_decay=1e-6), "constant", {}, 5.0)
TRAIN_MICRO_B, TRAIN_ACCUM, TRAIN_UTT_S, TRAIN_TOKENS = 32, 2, 15, 48
TRAIN_TIMED = 5  # timed steps after one warm-up step
TRAIN_SEED = 2080
# (k0): width 512 at depth 4 + 2, float32, dropout 0, card against CPU
TRAIN_K0 = dict(FLAGSHIP, encoder_conf=dict(FLAGSHIP["encoder_conf"], num_blocks=4,
                                            dropout_rate=0.0, attention_dropout_rate=0.0),
                decoder_conf=dict(FLAGSHIP["decoder_conf"], num_blocks=2, att_layer_num=2,
                                  dropout_rate=0.0, self_attention_dropout_rate=0.0,
                                  src_attention_dropout_rate=0.0),
                predictor_conf=dict(FLAGSHIP["predictor_conf"], dropout=0.0),
                sampling_ratio=0.0)
TRAIN_K0_SHAPE = (2, 4, 60, 12)  # accum, B, LFR frames, tokens
# The three steps take SGD with momentum, whose update is linear in the
# gradient: Adam's first updates are sign(g) * lr, so an element whose
# gradient is float noise (the key projections' biases, to which softmax is
# invariant) moves a whole learning rate either way in two correct runs.
# The AdamW update itself is held apart: card and CPU given the same
# gradients.
TRAIN_K0_OPTIM = ("sgd", dict(lr=0.01, momentum=0.9), "constant", {}, 5.0)
# Card against CPU, float32 with TF32 off: the first step's losses (a
# forward on equal weights), then every loss and ``grad_norm``, rtol; the
# parameter updates apart by at most this share of their 2-norm; the AdamW
# update on equal gradients, abs against its largest element.  Measured
# (NVIDIA H100 80GB HBM3): 1.0e-7, 3.9e-7, 6.0e-6 and 3.6e-7.
TRAIN_K0_FIRST_RTOL = 1e-5
TRAIN_K0_RTOL = 1e-4
TRAIN_K0_UPDATE_TOL = 1e-3
TRAIN_K0_ADAM_TOL = 1e-5
# (k2): the eval call on the attention kernel against the same call on its
# twin, on the valid rows: the encoder output's and the decoder logits'
# relative 2-norm error, and the loss's abs error, on the model (k1)
# trained.  Measured (NVIDIA H100 80GB HBM3, two runs, equal to the last
# digit): encoder 8.2e-3, logits 1.1e-2 (max abs 0.109 and 0.0625), loss
# 6.0e-5.
TRAIN_K2_ENC_TOL = 3e-2
TRAIN_K2_LOGITS_TOL = 4e-2
TRAIN_K2_LOSS_TOL = 2e-3
# (k3): the examples/smoke recipe; the tiny config's widths run 2 heads of 16,
# which no attention kernel instance takes (head sizes 32, 64, 128; the int8
# layers 64, 128), so the encoder and predictor are 128 wide (2 heads of 64)
SMOKE_YAML = "examples/smoke/conf/tiny_paraformer.yaml"
SMOKE_TOKENS = ["<blank>", "<s>", "</s>", "一", "二", "三", "四", "五", "<unk>"]
SMOKE_WIDTHS = {"encoder_conf": {"output_size": 128}, "predictor_conf": {"idim": 128},
                "tokenizer_conf": {"token_list": SMOKE_TOKENS}}


def train_waveforms(rng, B: int, seconds: float, tokens: int, vocab: int):
    """A collated batch of B raw waveforms of up to ``seconds`` (the last
    0-2 s of some rows padding) with ``tokens`` random targets each."""
    import numpy as np

    n = int(seconds * FS)
    lens = (n - rng.integers(0, 2 * FS, B) * (rng.random(B) < 0.5)).astype(np.int32)
    lens[0] = n
    wav = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    wav *= np.arange(n)[None] < lens[:, None]
    return {"speech": wav, "speech_lengths": lens,
            "text": rng.integers(3, vocab, (B, tokens)).astype(np.int32),
            "text_lengths": np.full(B, tokens, np.int32)}


def train_k0(torch, card):
    """(k0): three ``accum_grad`` = 2 steps (``TRAIN_K0_OPTIM``) of the
    width-512, depth 4 + 2 Paraformer in float32 (dropout 0, no sampler) on
    the card and on the CPU from the same weights and features: the bars
    ``TRAIN_K0_*`` on losses, ``grad_norm`` and updates; then two
    ``TRAIN_OPTIM`` (AdamW) updates of those parameters from the same
    gradients on both, within ``TRAIN_K0_ADAM_TOL``."""
    import numpy as np

    from funasr_torch.models.paraformer.model import Paraformer, init_random_
    from funasr_torch.train.optim import build_optimizer
    from funasr_torch.train.train_step import create_train_state, make_train_step

    acc, B, T, U = TRAIN_K0_SHAPE
    rng = np.random.default_rng(TRAIN_SEED)
    feats = rng.standard_normal((acc, B, T, 560)).astype(np.float32)
    flens = np.array([[T, T - 7, T - 20, T - 33], [T - 3, T, T - 11, T - 41]], np.int32)
    text = rng.integers(3, 8404, (acc, B, U)).astype(np.int32)
    tlens = np.array([[U, U - 2, U - 5, U - 1], [U - 3, U, U, U - 7]], np.int32)
    text[np.arange(U)[None, None] >= tlens[..., None]] = -1
    runs = []
    sd = None
    for dev in ("cuda", "cpu"):
        model = Paraformer(**TRAIN_K0, dtype=torch.float32, param_dtype=torch.float32,
                           device=dev)
        if sd is None:
            init_random_(model, torch.Generator(device=dev).manual_seed(TRAIN_SEED))
            sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(sd)
        tx, _ = build_optimizer(*TRAIN_K0_OPTIM)
        state = create_train_state(model, tx)
        start = state.params.detach().cpu().clone()
        step = make_train_step(model, tx, accum_grad=acc)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in dict(
            speech=feats, speech_lengths=flens, text=text, text_lengths=tlens).items()}
        stats = []
        for i in range(3):
            state, st = step(state, batch, i)
            stats.append({k: float(v) for k, v in st.items()})
        runs.append((state, stats, start, model))
    (sk, stk, start, mk), (sc, stc, _, mc) = runs
    err = {k: [abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(stk, stc)]
           for k in ("loss", "loss_att", "loss_pre", "grad_norm")}
    upd_k, upd_c = (sk.params.cpu() - start).double(), (sc.params - start).double()
    rel = float((upd_k - upd_c).norm() / upd_c.norm())
    # AdamW on equal gradients, twice (the moments and the count in play)
    tx, _ = build_optimizer(*TRAIN_OPTIM)
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    grads = [1e-3 * torch.randn(start.shape, generator=gen) for _ in range(2)]
    adam = []
    for dev in ("cuda", "cpu"):
        p = sc.params.to(dev)
        st = tx.init(p)
        for g in grads:
            u, st = tx.update(g.to(dev), st, p)
        adam.append(u.cpu())
    adam_err = float((adam[0] - adam[1]).abs().max() / adam[1].abs().max())
    rec = dict(steps=3, accum_grad=acc, micro_batch=B, frames=T, tokens=U,
               optimizer=TRAIN_K0_OPTIM[0], rel_err=err, update_rel_err=rel,
               adamw_update_rel_err=adam_err,
               losses_card=[s["loss"] for s in stk], losses_cpu=[s["loss"] for s in stc],
               n_params=int(sk.params.numel()))
    log(f"e2e (k0) training, card against CPU on {card}: {json.dumps(rec)}")
    check(all(np.isfinite(s["loss"]) and s["finite"] == 1.0 for s in stk),
          "(k0) finite steps on the card")
    check(max(err[k][0] for k in ("loss", "loss_att", "loss_pre")) <= TRAIN_K0_FIRST_RTOL,
          f"(k0) the first step's losses: {err}")
    check(max(max(v) for v in err.values()) <= TRAIN_K0_RTOL,
          f"(k0) losses and grad_norm: {err}")
    check(rel <= TRAIN_K0_UPDATE_TOL, f"(k0) parameter updates: {rel} (bar "
          f"{TRAIN_K0_UPDATE_TOL})")
    check(adam_err <= TRAIN_K0_ADAM_TOL, f"(k0) AdamW update on equal gradients: "
          f"{adam_err} (bar {TRAIN_K0_ADAM_TOL})")
    check(int(sk.step) == 3 and int(sk.opt_state["count"]) == 3, "(k0) step and count")
    del runs, sk, sc, mk, mc
    return rec


def end_to_end_training(torch, FK, A, CP, profile_dir, card):
    """Phase (k): Paraformer training.  (k0) ``train_k0``; (k1)
    ``TRAIN_LARGE`` (bench_train.py:102-124: vocab 8404, 50 + 16 layers,
    dropout 0.1, sampling_ratio 0.75, remat) in bf16 on float32 parameters
    through ``make_train_step`` with ``TRAIN_OPTIM``, each step
    ``TRAIN_ACCUM`` x ``TRAIN_MICRO_B`` raw 15 s waveforms featurized by the
    fbank kernel (``FrontendConfig.featurize``) with 48 random tokens each:
    one warm-up step, ``TRAIN_TIMED`` timed steps, every one dispatched
    under the sync guard; the step's ms, audio-s/s, peak memory, kernel
    launches and idle share (profiled step); every loss and ``grad_norm``
    finite.  (k2) the eval step (``make_eval_step``: the attention kernel
    in all 50 encoder layers and the 16 cross-attentions) on one micro-batch
    of those features against the same eval with the attention twin: the
    encoder output and the decoder logits on their valid rows, and the
    loss, within ``TRAIN_K2_*``.  Counters: zero before (k1), read
    after (k2): fbank one a featurize, attention 66 an eval call.
    Returns (launches, e2e record)."""
    import numpy as np

    from funasr_torch.auto.engines import FrontendConfig
    from funasr_torch.bin.train import split_micro
    from funasr_torch.models.paraformer.model import Paraformer, init_random_
    from funasr_torch.train.optim import build_optimizer
    from funasr_torch.train.train_step import (create_train_state, make_eval_step,
                                               make_train_step)

    t_k = time.time()
    rec0 = train_k0(torch, card)
    torch.cuda.empty_cache()
    log(f"(k0) done in {time.time() - t_k:.1f} s")

    # ---- (k1) full width
    t1 = time.time()
    model = Paraformer(**TRAIN_LARGE, dtype=torch.bfloat16, param_dtype=torch.float32,
                       device="cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(TRAIN_SEED))
    enc, dec = model.encoder, model.decoder
    check(len(enc.encoders0) + len(enc.encoders) == 50 and len(dec.decoders) == 16
          and enc.remat and enc.encoders[0].dropout_rate == 0.1
          and model.sampling_ratio == 0.75 and dec.output_layer.out_features == 8404,
          "(k1) bench_train.py's Paraformer-large")
    optim, conf, sched, sconf, clip = TRAIN_OPTIM
    tx, _ = build_optimizer(optim, conf, sched, sconf, clip)
    state = create_train_state(model, tx)
    n_params = int(state.params.numel())
    step = make_train_step(model, tx, accum_grad=TRAIN_ACCUM)
    frontend = FrontendConfig(device="cuda")
    rng = np.random.default_rng(TRAIN_SEED)
    B = TRAIN_MICRO_B * TRAIN_ACCUM
    batches = [train_waveforms(rng, B, TRAIN_UTT_S, TRAIN_TOKENS, 8404) for _ in range(2)]
    guarded_featurize = sync_guarded(torch, frontend.featurize)
    guarded_step = sync_guarded(torch, step)
    zero, read = hybrid_counters(FK, A, CP)
    seeds = iter(range(10 ** 6))

    def one_step(i):
        feats = guarded_featurize(batches[i % 2])
        return guarded_step(state, split_micro(feats, TRAIN_ACCUM), next(seeds))

    zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, warm = one_step(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    stats = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for i in range(TRAIN_TIMED):
        stats.append(one_step(i + 1)[1])
    end.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
    device_ms = start.elapsed_time(end) / TRAIN_TIMED
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = [{k: float(v) for k, v in s.items()} for s in [warm] + stats]
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) and s["finite"] == 1.0
              for s in stats), f"(k1) finite losses and grad norms: {stats}")
    groups = profile(torch, lambda: one_step(0), profile_dir, wall_ms, "profile_train.txt")
    rec1 = dict(n_params=n_params, global_batch=B, accum_grad=TRAIN_ACCUM,
                micro_batch=TRAIN_MICRO_B, utt_s=TRAIN_UTT_S, tokens=TRAIN_TOKENS,
                step_ms=wall_ms, step_device_span_ms=device_ms,
                audio_s_per_s=B * TRAIN_UTT_S / (wall_ms / 1e3), warmup_step_s=warm_s,
                peak_memory_gib=peak_gb, kernel_launches_a_step=groups["kernel launches"],
                kernel_ms_a_step=groups["kernels total"],
                idle_share=1.0 - groups["kernel share of batch_ms"],
                losses=[s["loss"] for s in stats], grad_norms=[s["grad_norm"] for s in stats],
                accs=[s["acc"] for s in stats], groups=groups)
    log(f"e2e (k1) training step, Paraformer-large on {card}: {json.dumps(rec1)}")
    log(f"(k1) done in {time.time() - t1:.1f} s")

    # ---- (k2) the eval step on the kernels, and on the attention twin
    t1 = time.time()
    eval_step = make_eval_step(model)
    feats = {k: v[0] for k, v in split_micro(frontend.featurize(batches[0]),
                                             TRAIN_ACCUM).items()}
    caught = {}  # what the eval call's encoder and decoder give, on their valid rows
    hooks = [model.encoder.register_forward_hook(
                 lambda mod, args, out: caught.update(enc=out[0], enc_lens=out[1])),
             model.decoder.register_forward_hook(
                 lambda mod, args, out: caught.update(logits=out, ys_lens=args[3]))]
    try:
        before = A.fused_attention.launches_by_head[128]
        out_k = sync_guarded(torch, eval_step)(feats)
        eval_attention = A.fused_attention.launches_by_head[128] - before
        launches = read()
        kern = dict(caught)
        with swapped([(A, "fused_attention", A.attention_ref)]):
            out_t = eval_step(feats)
        twin = dict(caught)
    finally:
        for h in hooks:
            h.remove()

    def valid_err(key, lens_key):
        rows = torch.arange(twin[key].shape[1], device="cuda")[None] < twin[lens_key][:, None]
        a, b = kern[key][rows].double(), twin[key][rows].double()
        return float((a - b).norm() / b.norm()), float((a - b).abs().max())

    enc_rel, enc_abs = valid_err("enc", "enc_lens")
    logit_rel, logit_abs = valid_err("logits", "ys_lens")
    loss_k, loss_t = float(out_k["loss"]), float(out_t["loss"])
    rec2 = dict(batch=TRAIN_MICRO_B, loss=loss_k, loss_twin=loss_t, acc=float(out_k["acc"]),
                acc_twin=float(out_t["acc"]), attention_launches=eval_attention,
                encoder_rel_err=enc_rel, encoder_max_abs_err=enc_abs,
                logits_rel_err=logit_rel, logits_max_abs_err=logit_abs)
    log(f"e2e (k2) eval step on {card}: {json.dumps(rec2)}")
    check(eval_attention == 50 + 16, f"(k2) attention launches {eval_attention}, want 66")
    check(torch.equal(kern["enc_lens"], twin["enc_lens"])
          and torch.equal(kern["ys_lens"], twin["ys_lens"]), "(k2) equal lengths")
    check(enc_rel <= TRAIN_K2_ENC_TOL and logit_rel <= TRAIN_K2_LOGITS_TOL,
          f"(k2) kernel against twin: encoder output {enc_rel} (bar {TRAIN_K2_ENC_TOL}), "
          f"decoder logits {logit_rel} (bar {TRAIN_K2_LOGITS_TOL})")
    check(abs(loss_k - loss_t) <= TRAIN_K2_LOSS_TOL and np.isfinite(loss_k),
          f"(k2) eval loss {loss_k} against the attention twin's {loss_t} "
          f"(bar {TRAIN_K2_LOSS_TOL})")
    n_feat = 1 + TRAIN_TIMED + 2 + 1  # warm-up, timed, profiled twice, (k2)
    check(launches["fbank"] == n_feat and launches["attention"] == eval_attention
          and sum(launches.values()) == n_feat + eval_attention,
          f"(k1)-(k2) launches {launches}: fbank {n_feat}, attention {eval_attention}")
    log(f"(k2) done in {time.time() - t1:.1f} s")
    del state, model, step, eval_step, feats, batches
    torch.cuda.empty_cache()
    return launches, {"train_k0": rec0, "train_k1": rec1, "train_k2": rec2}


def end_to_end_train_smoke(torch, FK, A, CP, card):
    """Phase (k3): the examples/smoke recipe through the port's entry points:
    ``bin.make_smoke_data`` (the recipe's generator, copied) ->
    ``bin.scp2jsonl`` -> ``bin.compute_audio_cmvn`` (the fbank kernel) ->
    ``bin.train`` on the tiny config (``SMOKE_WIDTHS``) for its two epochs,
    validating on the training set -> ``model.avg.pt`` served int8 through
    ``AutoModel(quantize=True)``: the training loss at the end below the
    start, the served tokens equal to the int8 twins' (token agreement >=
    ``E2E_INT8_MIN_AGREE``, the lengths equal).  Returns (launches, record)."""
    import shutil

    import numpy as np

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.bin import compute_audio_cmvn, make_smoke_data, scp2jsonl
    from funasr_torch.bin import train as bin_train
    from funasr_torch.utils.audio import load_audio

    t1 = time.time()
    work = "build/train_smoke"
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    make_smoke_data.main(data)
    jsonl = os.path.join(data, "train.jsonl")
    scp2jsonl.main(["--scp_file_list", os.path.join(data, "wav.scp"),
                    os.path.join(data, "text"), "--jsonl_file_out", jsonl])
    cmvn = os.path.join(data, "am.mvn")
    zero, read = hybrid_counters(FK, A, CP)
    zero()
    compute_audio_cmvn.main(["--train-jsonl", jsonl, "--output", cmvn, "--device", "cuda"])
    overrides = [f"++frontend_conf.cmvn_file={cmvn}", "++encoder_conf.output_size=128",
                 "++predictor_conf.idim=128", "++train_conf.log_interval=1",
                 "++tokenizer_conf.token_list=[" + ",".join(SMOKE_TOKENS) + "]"]
    trainer = bin_train.main(["--config", SMOKE_YAML, "--train-jsonl", jsonl,
                              "--valid-jsonl", jsonl, "--output-dir",
                              os.path.join(work, "exp"), "--device", "cuda"] + overrides)
    losses = [r["loss"] for r in trainer.history if "loss" in r]
    valid = [r["valid_loss"] for r in trainer.history if "valid_loss" in r]
    steps = int(trainer.state.step)
    check(len(losses) == steps and steps > 0 and all(np.isfinite(losses)),
          f"(k3) {steps} logged steps: {losses}")
    check(losses[-1] < losses[0], f"(k3) the training loss falls: {losses}")
    train_launches = read()
    del trainer
    with open(os.path.join(data, "wav.scp"), encoding="utf-8") as f:
        wavs = [load_audio(line.split()[1]) for line in f if line.strip()]
    am = AutoModel(model=SMOKE_YAML, model_conf=dict(
        SMOKE_WIDTHS, frontend_conf={"cmvn_file": cmvn}), quantize=True,
        init_param=os.path.join(work, "exp", "model.avg.pt"), device="cuda")
    eng = am.engine
    check(eng.module.quantize and eng.module._int8_ready, "(k3) served int8")
    wav_d, lens_d = eng._pack(wavs)
    max_tokens = eng._max_tokens(wav_d.shape[1])
    zero()
    out_k = sync_guarded(torch, eng.run)(wav_d, lens_d, max_tokens)
    serve_launches = read()
    with int8_twins():
        out_t = eng.run(wav_d, lens_d, max_tokens)
    texts = [r["text"] for r in am.generate(wavs[0])] + [
        r["text"] for r in eng.transcribe(wavs)]
    valid_tok = torch.arange(max_tokens, device="cuda")[None] < out_k[1][:, None]
    agree = float((out_k[0] == out_t[0])[valid_tok].float().mean()) if valid_tok.any() else 1.0
    rec = dict(steps=steps, losses=losses, valid_losses=valid, utterances=len(wavs),
               token_lengths=out_k[1].tolist(), token_agreement_twins=agree,
               lengths_equal=bool(torch.equal(out_k[1], out_t[1])), texts=texts[:4],
               train_launches=train_launches, serve_launches=serve_launches,
               seconds=time.time() - t1)
    log(f"e2e (k3) train then serve, the smoke recipe on {card}: {json.dumps(rec)}")
    check(rec["lengths_equal"] and agree >= E2E_INT8_MIN_AGREE,
          f"(k3) served tokens against the int8 twins: {agree}")
    check(train_launches["fbank"] > 0 and train_launches["attention"] > 0,
          f"(k3) the recipe ran the fbank and attention kernels: {train_launches}")
    del am, eng
    torch.cuda.empty_cache()
    launches = {k: train_launches[k] + serve_launches[k] for k in train_launches}
    return launches, {"train_k3": rec}


def profile(torch, run, out_dir, batch_ms, fname):
    """Device kernel time by group for one batch (``run()``), and the share
    of the batch's span (``batch_ms``, CUDA events) spent in kernels.  The
    table goes to ``out_dir/fname`` when ``out_dir`` is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    run()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        run()
        torch.cuda.synchronize()
    events = p.key_averages()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    groups, n_kernels = {}, 0
    for ev in events:  # kernels only: a CPU op's device time repeats them
        if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
            continue
        name = ev.key.lower()
        if not name.startswith(("memcpy", "memset")):
            n_kernels += ev.count
        if "ctc_prefix_kernel" in name:
            g = "ctc prefix kernel"
        elif "wkv_kernel" in name:
            g = "wkv kernel"
        elif "attention_kernel" in name and "true" in name:
            g = "attention kernel, ALiBi"
        elif "attention_i8qk_kernel" in name:
            g = "attention (int8 scores) kernel"
        elif "qmm_kernel" in name:
            g = "qmm kernel"
        elif "ffn_kernel" in name:
            g = "ffn kernel"
        elif "attention_f32ctx_kernel" in name:
            g = "attention (int8 layers) kernel"
        elif "attention_kernel" in name and "<32>" in name:
            g = "attention kernel, d = 32"
        elif "attention_kernel" in name:
            g = "attention kernel"
        elif "int8_gemm_rq_kernel" in name:
            g = "int8 GEMM row-quantizing kernel"
        elif "int8_gemm_kernel" in name:
            g = "int8 GEMM kernel"
        elif "rowquant" in name:
            g = "rowquant kernel"
        elif "fsmn_ln_kernel" in name:
            g = "LN + FSMN kernel"
        elif "fsmn_kernel" in name:
            g = "FSMN kernel"
        elif "fbank_kernel" in name:
            g = "fbank kernel"
        elif any(s in name for s in ("gemm", "nvjet", "cutlass", "xmma")):
            g = "gemm"
        elif "conv_depthwise" in name:
            g = "depthwise conv"
        elif "sort" in name:
            g = "sort (top-k)"
        elif "index" in name or "gather" in name or "scatter" in name:
            g = "gather / index"
        elif "softmax" in name:
            g = "softmax"
        elif "layer_norm" in name:
            g = "layer norm"
        elif "copy" in name:
            g = "copy / cast"
        elif "elementwise" in name:
            g = "elementwise"
        else:
            g = "other"
        groups[g] = groups.get(g, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(groups.values())
    groups["kernels total"] = busy
    groups["rowquant + FSMN groups"] = sum(groups.get(g, 0.0) for g in (
        "rowquant kernel", "FSMN kernel", "LN + FSMN kernel"))
    groups["kernel share of batch_ms"] = busy / batch_ms
    groups["kernel launches"] = n_kernels
    groups["aten::round calls"] = sum(ev.count for ev in events
                                      if ev.key == "aten::round")
    log(f"profile ({fname}) device ms by group: {json.dumps(groups, sort_keys=True)}")
    return groups


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler table of one batch here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from funasr_torch.ops import attention as A
    from funasr_torch.ops import ctc_prefix as CP
    from funasr_torch.ops import cuda_build
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import fbank_kernel as FK
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import fsmn as FM
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import qmm as QM
    from funasr_torch.ops import quant as Q
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    # serving computes no gradients (the engines run under inference mode);
    # phase (k), training, turns grad mode on for itself
    torch.set_grad_enabled(False)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.time()
    logs = cuda_build.build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"nvcc {name}: {line.strip()}")
    log(f"built {sorted(logs) or 'nothing (cached)'} in {time.time() - t0:.1f} s")

    rng = np.random.default_rng(0)
    t0 = time.time()
    fbank_cases = check_fbank(torch, FK, rng)
    attn_cases = check_attention(torch, A)
    check_edges(torch, FK, A, rng)
    attn_cases.append(check_f32_edges(torch, A))
    gemm_cases = check_int8_gemm(torch, G)
    layer_cases = check_int8_layers(torch, SL, DL, FF)
    ctc_cases = check_ctc_prefix(torch, CP)
    step_cases = check_ctc_prefix_step(torch, CP)
    qmm_cases = check_qmm(torch, QM, Q, RQ, G)
    f32ctx_cases = check_f32ctx(torch, A)
    i8qk_cases = check_i8qk(torch, A)
    ffn_cases = check_ffn(torch, FF)
    rq_cases = check_int8_rq(torch, G, RQ, FM)
    fsmn_ln_cases = check_fsmn_ln(torch, FM, RQ)
    block_cases = check_rowquant_fsmn(torch, RQ, FM)
    d64 = check_head64_kernels(torch, A, G, RQ, FM, SL, DL, FF)
    log(f"kernel checks done in {time.time() - t0:.1f} s")

    t0 = time.time()
    shared = {}
    launches_bf16, e2e = end_to_end(torch, rng, FK, A, args.profile, smi, shared)
    launches_int8, e2e8 = end_to_end_int8(torch, FK, A, args.profile, smi, shared)
    e2e.update(e2e8)
    launches_beam, e2e_beam = end_to_end_beam(torch, FK, CP, args.profile, smi, shared)
    e2e.update(e2e_beam)
    launches_bicif, e2e_bicif = end_to_end_bicif(torch, FK, A, args.profile, smi, shared)
    e2e.update(e2e_bicif)
    shared.clear()
    torch.cuda.empty_cache()
    launches_pipe, e2e_pipe, d32_cases, am = end_to_end_pipeline(torch, FK, A, args.profile,
                                                                 smi)
    e2e.update(e2e_pipe)
    launches_c, e2e_c, seaco_cases, spk_fbank_case = end_to_end_pipeline_c(torch, FK, A, smi)
    e2e.update(e2e_c)
    launches_stream, e2e_stream, stream_attn, stream_fbank = end_to_end_streaming(
        torch, FK, A, am, args.profile, smi)
    e2e.update(e2e_stream)
    del am
    torch.cuda.empty_cache()
    sv_cases = check_sensevoice_kernels(torch, SL, DL, FF, G, A)
    launches_sv, e2e_sv = end_to_end_sensevoice(torch, FK, A, args.profile, smi)
    e2e.update(e2e_sv)
    launches_ctx, e2e_ctx, ctx_cases = end_to_end_contextual(torch, FK, A, args.profile, smi)
    e2e.update(e2e_ctx)
    launches_hyb, e2e_hyb = end_to_end_hybrid(torch, FK, A, CP, smi)
    e2e.update(e2e_hyb)
    launches_ais, e2e_ais = end_to_end_aishell(torch, FK, A, CP, smi)
    e2e.update(e2e_ais)
    t1 = time.time()
    launches_g, e2e_g = end_to_end_sanm_family(torch, FK, A, CP, smi)
    e2e.update(e2e_g)
    log(f"phase (g) done in {time.time() - t1:.1f} s")
    t1 = time.time()
    whisper_cases = check_whisper_kernels(torch, A)
    launches_h, e2e_h = end_to_end_whisper(torch, FK, A, CP, args.profile, smi)
    e2e.update(e2e_h)
    log(f"phase (h) done in {time.time() - t1:.1f} s")
    t1 = time.time()
    wkv_cases = check_wkv(torch)
    alibi_cases = check_alibi_attention(torch, A)
    launches_tr, e2e_tr = end_to_end_transducer(torch, FK, A, CP, args.profile, smi)
    e2e.update(e2e_tr)
    launches_e2v, e2e_e2v = end_to_end_emotion2vec(torch, FK, A, CP, args.profile, smi)
    e2e.update(e2e_e2v)
    log(f"phase (i) done in {time.time() - t1:.1f} s")
    t1 = time.time()
    scama_cases = check_scama_kernels(torch, G, RQ, FF, Q)
    launches_j, e2e_j = end_to_end_scama(torch, FK, A, CP, args.profile, smi)
    e2e.update(e2e_j)
    launches_j3, e2e_j3 = end_to_end_stream_punc(torch, FK, A, CP, smi)
    e2e.update(e2e_j3)
    log(f"phase (j) done in {time.time() - t1:.1f} s")
    t1 = time.time()
    with torch.enable_grad():
        launches_k, e2e_k = end_to_end_training(torch, FK, A, CP, args.profile, smi)
        launches_k3, e2e_k3 = end_to_end_train_smoke(torch, FK, A, CP, smi)
    e2e.update(e2e_k)
    e2e.update(e2e_k3)
    log(f"phase (k) done in {time.time() - t1:.1f} s")
    log(f"end to end done in {time.time() - t0:.1f} s")
    log(f"e2e summary {json.dumps(e2e, sort_keys=True)}")

    def entry(name, sources, replaces, main_case, cases, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        by_path = {"bf16": launches_bf16.get(name, 0),
                   "int8": launches_int8.get(name, 0),
                   "beam": launches_beam.get(name, 0),
                   "bicif": launches_bicif.get(name, 0),
                   "pipeline": launches_pipe.get(name, 0),
                   "pipeline_c": launches_c.get(name, 0),
                   "streaming": launches_stream.get(name, 0),
                   "sensevoice": launches_sv.get(name, 0),
                   "contextual": launches_ctx.get(name, 0),
                   "hybrid_align": launches_hyb.get(name, 0),
                   "aishell": launches_ais.get(name, 0),
                   "sanm_family": launches_g.get(name, 0),
                   "whisper": launches_h.get(name, 0),
                   "transducer": launches_tr.get(name, 0),
                   "emotion2vec": launches_e2v.get(name, 0),
                   "scama": launches_j.get(name, 0),
                   "stream_punc": launches_j3.get(name, 0),
                   "train": launches_k.get(name, 0),
                   "train_smoke": launches_k3.get(name, 0)}
        return dict(name=name, route="cuda", source=sources[0], sources=sources,
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path, shape=main_case["case"],
                    tolerance=main_case["tolerance"],
                    **{k: main_case[k] for k in keys}, **extra, cases=cases)

    gemm_src = ["funasr_torch/csrc/int8_gemm.cu", "funasr_torch/csrc/int8_wgmma.cuh"]
    attn_src = ["funasr_torch/csrc/attention.cu"]
    dec_src = gemm_src + ["funasr_torch/csrc/fsmn.cu", "funasr_torch/csrc/rowquant.cu"] + attn_src
    kernels = [
        entry("fbank", ["funasr_torch/csrc/fbank.cu"],
              "funasr_tpu/ops/fbank_pallas.py:97", fbank_cases[0],
              fbank_cases + [stream_fbank, spk_fbank_case]),
        entry("attention", ["funasr_torch/csrc/attention.cu"],
              "funasr_tpu/ops/attention_pallas.py:37", attn_cases[0],
              attn_cases + stream_attn + sv_cases["attention"] + ctx_cases["attention"]),
        # the same kernel's head-size-32 instance: punctuation's attention
        entry("attention_d32", ["funasr_torch/csrc/attention.cu"],
              "funasr_tpu/ops/attention_pallas.py:37", d32_cases[0], d32_cases),
        # its head-size-64 instance: the 256-wide models (4 heads) and Whisper
        # (20 heads at large-v3)
        entry("attention_d64", ["funasr_torch/csrc/attention.cu"],
              "funasr_tpu/ops/attention_pallas.py:37", d64["attention"][0],
              d64["attention"] + whisper_cases),
        # the int8 layers' exact-sum attention at head size 64 (the
        # float32-context entry on the main path; the int8-score one beside)
        entry("attention_f32ctx_d64", ["funasr_torch/csrc/attention.cu"],
              "funasr_tpu/ops/sanm_layer_pallas.py:118", d64["f32ctx"]["sanm_layer"][0],
              d64["f32ctx"]["sanm_layer"] + d64["f32ctx"]["decoder_layer"] + d64["i8qk"]),
        entry("sanm_layer", gemm_src + attn_src, "funasr_tpu/ops/sanm_layer_pallas.py:189",
              layer_cases["sanm_layer"][0],
              layer_cases["sanm_layer"] + f32ctx_cases["sanm_layer"] + sv_cases["sanm_layer"]
              + d64["layers"]["sanm_layer"] + d64["layers"]["sanm_layer_i8"]),
        entry("decoder_layer", dec_src, "funasr_tpu/ops/decoder_layer_pallas.py:165",
              layer_cases["decoder_layer"][0],
              layer_cases["decoder_layer"] + f32ctx_cases["decoder_layer"] + seaco_cases
              + ctx_cases["decoder_layer"] + d64["layers"]["decoder_layer"]),
        entry("ffn", gemm_src, "funasr_tpu/ops/ffn_pallas.py:113",
              layer_cases["ffn"][0],
              layer_cases["ffn"] + d64["layers"]["ffn"] + scama_cases["ffn"]),
        # the building block of rows sanm_layer, decoder_layer and ffn (and
        # QDense): the int8 contraction inside each of those TPU kernels
        entry("int8_gemm", ["funasr_torch/csrc/int8_gemm.cu",
                            "funasr_torch/csrc/int8_wgmma.cuh"],
              "funasr_tpu/ops/sanm_layer_pallas.py:89", gemm_cases[1],
              gemm_cases + sv_cases["int8_gemm"] + scama_cases["int8_gemm"],
              also_replaces=["funasr_tpu/ops/decoder_layer_pallas.py:49",
                             "funasr_tpu/ops/ffn_pallas.py:54",
                             "funasr_tpu/ops/quant.py int8_dot_general"]),
        entry("ctc_prefix", ["funasr_torch/csrc/ctc_prefix.cu"],
              "funasr_tpu/ops/ctc_prefix_pallas.py:47", ctc_cases[0], ctc_cases),
        # the same TPU kernel with the prologue that XLA fuses around it in
        # the JAX beam step: the beam's path
        entry("ctc_prefix_step", ["funasr_torch/csrc/ctc_prefix.cu"],
              "funasr_tpu/ops/ctc_prefix_pallas.py:47", step_cases[0], step_cases,
              also_replaces=["funasr_tpu/ops/beam_search.py:125"]),
        entry("qmm", ["funasr_torch/csrc/qmm.cu", "funasr_torch/csrc/int8_wgmma.cuh"],
              "funasr_tpu/ops/quant_pallas.py:37",
              qmm_cases[0], qmm_cases),
        entry("attention_i8qk", ["funasr_torch/csrc/attention.cu"],
              "funasr_tpu/ops/sanm_layer_pallas.py:112", i8qk_cases[0],
              i8qk_cases + layer_cases["sanm_layer_i8"]),
        entry("ffn_bf16", ["funasr_torch/csrc/ffn.cu", "funasr_torch/csrc/int8_wgmma.cuh"],
              "funasr_tpu/ops/ffn_pallas.py:39", ffn_cases[0], ffn_cases[0::2]),
        # the same TPU kernel's float32 entry: the CUDA cores
        entry("ffn_f32", ["funasr_torch/csrc/ffn.cu"], "funasr_tpu/ops/ffn_pallas.py:39",
              ffn_cases[1], ffn_cases[1::2]),
        # the SANM layer's ctx row quantize, FSMN memory and wout
        # contraction: the row quantize in the GEMM's A producer, the FSMN in
        # its epilogue
        entry("int8_gemm_rq", gemm_src, "funasr_tpu/ops/sanm_layer_pallas.py:133",
              rq_cases[0], rq_cases + d64["rq"],
              also_replaces=["funasr_tpu/ops/sanm_layer_pallas.py:93"]),
        entry("fsmn_ln", ["funasr_torch/csrc/fsmn.cu"],
              "funasr_tpu/ops/decoder_layer_pallas.py:74", fsmn_ln_cases[0], fsmn_ln_cases),
        entry("rowquant", ["funasr_torch/csrc/rowquant.cu"], "funasr_tpu/ops/quant.py:150",
              block_cases["rowquant"][0], block_cases["rowquant"] + scama_cases["rowquant"]),
        entry("fsmn", ["funasr_torch/csrc/fsmn.cu"], "funasr_tpu/ops/sanm_layer_pallas.py:93",
              block_cases["fsmn"][0], block_cases["fsmn"]),
        # port-only kernels: what they replace is XLA code, not a TPU kernel
        entry("wkv", ["funasr_torch/csrc/wkv.cu"], "funasr_tpu/models/rwkv.py:32",
              wkv_cases[0], wkv_cases, replaces_kind="lax.scan (XLA), not a TPU kernel"),
        # the float32 d = 64 attention instance with emotion2vec's ALiBi
        entry("attention_alibi64", ["funasr_torch/csrc/attention.cu"],
              "funasr_tpu/models/emotion2vec/model.py:136", alibi_cases[0], alibi_cases,
              replaces_kind="AltAttention's XLA attention, not a TPU kernel"),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
