#!/usr/bin/env python3
"""Drive the PyTorch port (vcvits_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

1. Prints the card's name and power limit, and the torch/CUDA versions.
2. Builds the CUDA kernels from vcvits_tpu_torch/csrc/ (one nvcc per
   source, all at once) and prints ptxas's register/spill report; counts
   the HMMA/HGMMA (tensor-core) instructions in the mrf and flow_coupling
   libraries' SASS (cuobjdump -sass), and the IMMA (int8 tensor-core)
   instructions in int8_conv's, and fails if one has none.
3. Kernel phases at the main path's shapes, each kernel against its plain
   PyTorch version on the card, TF32 off:
   * K2 (flow_coupling.cu) in its three modes, each 4 launches: the
     coupling reverse and forward (4 couplings with flips) and wn_segment
     (a 16-layer WaveNet, 4 layers a launch), on [1, 930, 128] and a ragged
     batch of 2 (930 and 700 frames), hidden 128, and the reverse at hidden
     256 ([1, 930, 256]); random non-zero weights; float32, max |err| <=
     1e-4 x output RMS; the plan against the library's flow_plan; the
     kernel's device time from torch.profiler, its 3xTF32 bound beside the
     CUDA-core fp32 one, and the weight bytes its CTAs stream from L2. The
     reverse also with bf16 in and out ([1, 930, 128], as a bf16
     validation runs it): error RMS <= 2e-2 x output RMS.
   * mrf (K1): the four decoder stages of a 10 s utterance, [1, 7440, 256]
     ... [1, 476160, 32], random weights; float32 (max |err| <= 1e-4 x
     output RMS) and bf16 weights (error RMS <= 2e-2 x output RMS), 9
     launches a stage; per stage the tile `plan` chose, the kernel's device
     time from torch.profiler beside the CUDA-event time, and the bound's
     share of each.
   Each prints its time, the plain version's time and the least time the
   card could take (the larger of bytes / 3.35 TB/s and operations / peak:
   67 TFLOP/s float32 CUDA cores, 989 TFLOP/s bf16 tensor cores; K1's
   fp32 bound is the lesser of the CUDA-core figure and 3xTF32's, three
   TF32 products per multiply-add at 495 TFLOP/s, and both are printed).
   * stft_mel (K3): the train step's 16 x 4 s targets (spec + log-mel) and
     one padded 10 s voice_conversion source (spec only); spec max |err|
     <= 1e-4 x max |spec| against the plain version, log-mel max |err|
     <= 1e-4 against the plain version (a direct DFT summed in float64)
     and against a float64 FFT on the host (the plain version's distance
     from it is printed too); also the time of
     torch.stft + one fbank matmul (library_ms, a yardstick only), the
     ratio kernel_ms / library_ms, the bound's share of the kernel's time,
     and the kernel's device time from torch.profiler (device_ms, without
     the host's cost per call), at the tile the wrapper picks and at each
     frame tile. The bound of K3 and K4
     counts the work of the function, a real FFT per frame and the mel
     sums over the fbank's non-zeros (stft_bound_ms).
   * fused_gate (K5): forward and backward on [16, 375, 256], against the
     plain op and its autograd, max |err| <= 1e-6 (grad_b, a sum over 375
     frames, <= 375e-6), and in bf16 (as a bf16 train step runs it) error
     RMS <= 1e-2 x RMS for out, grad_a and grad_b; the kernels' device
     times with L2 flushed before
     each launch (so that their inputs come from HBM, as the bound
     assumes) and the bound's share of them, and the host
     microseconds a launch costs (1000 launches, no sync), beside a replica
     of the earlier host path.
   * mel_spectrogram (K4, the mel-only instance of stft_mel): the
     validation shape, one 10 s clip at 48 kHz (937 frames), and 16 x 4 s;
     log-mel max |err| <= 1e-4 against the plain version and a float64
     FFT, as for K3, and <=
     1e-6 against K3's mel on the same input; also torch.stft + one fbank
     matmul (library_ms), the ratios and the tiles as for K3.
3b. Kernels at the serving daemon's largest batch, 16 rows: K1 on the four
   decoder stages of 16 x 10 s ([16, 7440, 256] ... [16, 476160, 32]) in
   fp32 and bf16, K2's reverse (4 couplings) on [16, 930, 128] with each
   row's own length drawn from 186-930; each against its plain version at
   the tolerances above, with its time, device time and bound at B = 16.
3c. The int8 decoder's kernels (csrc/int8_conv.cu), at every distinct
   decoder conv of a 10 s W8A8 request (conv_pre, each upsampler as its
   phase-decomposed conv, the MRF's (k, d) convs, conv_post: 42 shapes),
   at B = 1 and 16, fp32 and bf16 inputs, random weights from a seed: Q2's
   row maxima (and, at B = 1, their scales and the weight scales against
   the host's) bit-equal to the plain version, Q1 within 1 ulp of its plain
   version (exact integer sums in float64); plan against the library's
   int8_conv_plan; per shape and per request (78 launches each) Q1's and
   Q2's times, Q1's bound (the larger of its bytes at 3.35 TB/s and its
   multiply-adds at 1,979 int8 TOP/s), the plain version's time, and
   im2col + torch._int_mm's (library_ms, a yardstick only, its integer
   sums checked against the plain version's once); at conv_pre's input,
   the one launch with no fused activation, Q2 beside
   torch.linalg.vector_norm(ord=inf) (the only instance one PyTorch call
   computes; checked equal).
3d. M1 (monotonic_align.cu), the TTS step's MAS: at its shape, B = 16,
   text bucket 192, 750 frames (8 s), ragged lengths, and at T_x 600 (above
   the 256-thread block), B = 4, 1500 frames: the path bit-equal to the
   plain version (0 differing entries), kernel ms, device ms, the plain
   version's ms and the bound (the valid scores read once and the path
   written once at 3.35 TB/s; no PyTorch call computes MAS).
4. Slice phase (convert): VoiceConverter at the full configs/48k_base.json widths
   with seeded random weights. A 0.48 s input is converted on the card and
   with the plain path on the CPU, same weights and noise, and must agree
   (atol 1e-3). Then the main path: 3 synthetic 10 s WAVs through
   convert_many with distinct speakers, in float32 and then bf16, with the
   launch counters set to 0 just before and read just after; output lengths
   must equal y_mask.sum() * hop, outputs must be finite, and both kernels
   must have launched the expected number of times per request. A per-part
   time breakdown of one 10 s request follows.
5. Path A (voice_conversion), full widths: a 0.48 s input on the card and
   on the CPU, same perturbed weights and eps (atol 1e-3); then 3 synthetic
   10 s 48 kHz sources with distinct (source, target) speakers through
   VoiceConverter.voice_conversion in float32 and bf16. Per request: output
   length = y_mask.sum() * hop, finite, and launches K3 1, K5 0 (the gate
   is K2's epilogue), K2 reverse 4, forward 4 and wn_segment 4, K1 36. ms
   and real-time factor; a breakdown that also times the module paths the
   posterior and the flow forward no longer take.
5b. Serving (`serving.py`), full widths, perturbed seeded weights (as path
   A), fp32 then bf16: a ServingDaemon(max_batch=16, window_ms=25) fed by
   16 client threads, each submitting 2 prepared requests in turn (2-10 s
   from np.random.default_rng(0), speakers 3/77/411, noise_scale 0), the
   launch counters set to 0 just before and read just after (K2 4 and K1 36
   a batch); requests/s, seconds of audio per second, latency p50/p95/max,
   mean batch and the batch-size histogram. Held: every output as long as
   its solo convert_array, and in each batch the rows as long as the batch
   within 1e-3 of their solo runs (bf16: error RMS <= 2e-2 x RMS, where a
   batch's and a row's GEMMs round differently). Then 16 equal 10 s
   requests as one batch, profiled (device busy, idle share), every row
   held the same way; a lone request at noise_scale 1 equal to
   convert_array with its seed (<= 1e-6; another seed is > 1e-3 away);
   and, in fp32, one 10 s request per wire format: f16 and i16 within
   2e-3 of f32, mu-law within 0.0225 |x| + 3e-3.
5c. Streaming (`streaming.py`, `streaming_conv.py`), fp32 and bf16: one
   10 s source pushed in 0.1 s pieces through the windowed and the
   incremental StreamingConverter (chunk 2 s, context 0.16 s, noise 0):
   compute ms per chunk (p50, max) against the chunk's audio, the time to
   the first output, the length against its contract (incremental exact,
   windowed within the crossfade), launches (windowed K2 4 and K1 36 a
   window; incremental none: its flow and decoder are plain convs). Held:
   StreamingFlowDecoder on 5 chunks of the source's z_p, after its delay,
   within 1e-3 of the offline flow reverse (K2) + decoder (K1) (bf16:
   error RMS <= 2e-2 x RMS).
5d. HTTP (`serve_http` on 127.0.0.1, an ephemeral port, fp32): POST
   /convert of a 10 s WAV equal to the daemon's output within PCM_24
   rounding (1e-5); POST /stream chunked, windowed and incremental, f32
   within 1e-4 of a direct StreamingConverter (twice: the second connection
   takes the pooled session) and i16 within 2e-2 (PCM-16 both ways); GET
   /stats; 400 on rate=8000; 503 from a server with no stream sessions.
5e. int8 decoder modes, full widths, path A's weights (`perturbed_state`):
   the W8A8 decoder alone (45 frames, the same z and g) on the card and
   on the CPU in fp32 and bf16, SNR >= 40 dB and the count of differing
   int8 activation codes (hooks on every conv); convert_array and
   voice_conversion_array of 10 s at noise 0 in float, W8A8 and w8, fp32
   and bf16: exact lengths, finite, launches per request (W8A8: Q1 and Q2
   78 each and no K1; w8: K1 36 on the int8-grid weights), ms per request
   and the decoder's device ms, profiled; against the float decode on
   convert, W8A8 >= 24 dB from fp32 in both dtypes and w8 above W8A8
   (JAX's W8A8 gate; on these weights JAX's own decoder misses its w8 and
   mel limits, tests/int8_path_a_reference.py), the flow swap's numbers
   printed beside the share of its float output that is clipped. Then
   JAX's gates in JAX's own setting (tests/test_int8_decoder.py:93-140):
   the decoder alone at full width on the seeded initial weights, W8A8
   bf16 >= 24 dB from fp32 and mel-L1 <= 0.05 from the bf16 float decode,
   w8 fp32 >= 32 dB and above W8A8.
5f. A ServingDaemon in W8A8, fp32 and bf16: the closed-loop round (16
   clients x 2 requests of 2-10 s; Q1 and Q2 78 launches a batch, K1
   none), one profiled batch of 16 x 10 s (rows >= 24 dB from their float
   convert_array), and a lone request equal to convert_array at its padded
   length.
6. Path B (TrainStep), full widths: 5 steps at batch 16 of paired synthetic
   2-4 s clips (x_pitch from the known f0), segment 16384, in float32 and
   then in bfloat16 (what "fp16_run": true selects). Every loss finite;
   after step 1 every trainable parameter changed and HuBERT did not;
   launches per step K3 1, K5 64 forward and 32 backward. ms/step over
   steps 2-5 and peak memory. Then one step at B=2 x 1 s, dropout off,
   injected draws, on the card and on the CPU, in each dtype: in float32
   every loss and both grad norms agree to rtol 1e-3; in bf16 the totals,
   the G terms and both grad norms to rtol 0.1 (TRAIN_RTOL_BF16: the
   port's CPU bf16 step is up to 4.9e-2 from JAX's, tests/
   test_torch_train_step_bf16.py), beside each one's distance over the
   CPU's own bf16-vs-fp32 distance. Per-part device times of one path A
   request and of a train step (CUDA events), and one of each under
   torch.profiler (device-busy time, idle share, costliest kernels),
   follow each path's counted run.
6b. Gradient accumulation, full widths, bf16: accumulate_grad_batches 2 at
   B=8, 4 mini-steps; the parameters are bit-equal to the ones before
   after mini-steps 1 and 3 and move after 2 and 4 (HuBERT never); AdamW's
   step is 2 after mini-step 4; ms per mini-step with and without the
   update.
7. Path C (the training loop), configs/48k_base.json as shipped
   ("fp16_run": true: bf16 compute, TF32 off for what stays float32), only
   the step counts, the intervals and the corpus changed: 40 training and
   8 validation synthetic 2-4 s WAVs at 48 kHz (a known f0 contour, 4
   speakers), `preprocess` in 8 processes with the C++ host DSP, and the
   validation clips again with its NumPy version (each timed, the caches
   equal), then
   Trainer.fit(max_steps=6) with log_interval 1 and validation and
   checkpoints every 3 steps. The default device_data_cache "auto" must
   pick DeviceBatcher; launches around the fit are per step K3 1, K5 64
   forward and 32 backward, per validation K4 4, K1 36, K2 4. A second
   Trainer on the workdir resumes at 6 with every tensor as saved and
   reaches 8; request_stop() before a fit saves step 0; epoch 0 of
   BucketedLoader copied to the card equals DeviceBatcher's bit for bit;
   validate's metrics are in range; VoiceConverter.from_checkpoint
   converts a validation file with length y_mask.sum() * hop. A run at
   accumulate_grad_batches 2 checkpoints after mini-step 3 (mid-update);
   a second Trainer restores the accumulator (mini-step, update count,
   G's and D's running means) and the moments as saved and lands the
   update at mini-step 4. Last, `python -m vcvits_tpu_torch.cli.train`'s
   main on the shipped config with only the data paths changed trains 2
   steps in bf16. Prints ms/step, the loader-wait share, ms per validate,
   the checkpoint's blocking ms, write seconds and size, restore seconds
   and peak memory.
7b. The TTS path, full widths, seeded weights with the flows' and the
   SDP's zero kernels made random, the decoder's gains x 3 and a token
   about 5 frames long (`perturbed_tts_state`). Synthesis:
   TTSSynthesizer.synthesize on the card and on the CPU plain path on a
   short text at noise 0 (atol 1e-3); a 203-id English text at noise 0.667
   / 0.8 with the length_scale that puts it at 9-11 s, in fp32 and bf16, 3
   counted calls each (K1 36 and K2 4 a call; the decoder runs over JAX's
   static budget, 20 frames a padded id), with its wall ms, real-time
   factor (the three calls' audio over their wall time), profile (device
   busy, idle share), a breakdown (text encoder, SDP sampler, alignment +
   prior, flow K2, decoder and K1 in it) and the same call capped at its
   valid frames; one SynthesizerTTS.voice_conversion of 10 s (K2 4 + 4 +
   4, K1 36). Train step: TTSTrainStep at B = 16, text bucket 192, 8 s
   audio, segment 16384, 4 steps in bf16 and in fp32 (every tensor moves
   in step 1; launches a step K3 1, K5 32 forward and 32 backward, M1 1),
   ms/step, peak memory, _Sections, a profile; a B = 2 step card vs CPU
   with dropout off and injected draws, every loss and grad norm to rtol
   1e-3 fp32 and 0.1 bf16. Loop: TTSTrainer on the shipped config (bf16,
   batch 4) and 8 synthetic path|sid|text WAVs, fit to 2 steps with one
   validation and a checkpoint (launches K3 2, K5 64 + 64, M1 2, K1 36, K2
   4, K4 1), a second trainer resumes at 2 with every tensor as saved and
   reaches 3, then `python -m vcvits_tpu_torch.cli.train_tts` resumes to 4
   and `python -m vcvits_tpu_torch.cli.infer_tts` writes a finite WAV from
   the workdir. On each of these paths (a synthesis call of each dtype,
   voice_conversion, step 1 of each dtype, the fit) every kernel wrapper
   the path calls keeps a host copy of its inputs at each distinct shape
   (`kernel_inputs`), and after the path's counts are read each is run
   again on them against its plain version at its kernel phase's
   tolerance: K1 at the synthesis budget's four stages (1e-4 fp32, 2e-2
   bf16), K2's modes (1e-4 fp32, 2e-2 bf16), K3 on the 16 x 8 s batch
   (1e-4), K5 forward and backward at [16, 750, 2H] (1e-6, 1e-2 bf16), K4
   (1e-4), M1 bit-equal; the worst max |err| of each goes into the
   kernels line as `max_abs_err_tts_inputs` (on the base_json paths below
   as `max_abs_err_base_json_inputs`). Path C ends with (i) of the multi-GPU
   checks: `torchrun --nproc-per-node <cards> -m vcvits_tpu_torch.cli.train
   --distributed` (NCCL, one rank a card; `--model-parallel 2` when the
   card count is even and above 1) on the shipped config with the data
   paths changed and batch 4, 2 steps, then again to 3, restoring step 2.
7c. base_json: configs/base.json at full width (HuBERT XTRALARGE 48 x
   1280, hidden and inter 256, 256 mels), seeded weights drawn on the card
   (`init_on_device`) with `perturbed_state`'s changes, the init seconds;
   convert_array and voice_conversion_array of 10 s in fp32 and bf16 with
   their ms and a breakdown (HuBERT + prior, flow K2, upsamplers, K1,
   conv_post); a daemon batch of 4 x 10 s (fp32, noise 0); the validation
   log-mel of a converted clip (K4 at 256 mels); 2 train steps at the
   config's batch 4 in bf16 and fp32 (ms/step, peak memory, _Sections,
   a profile with the idle share); every kernel held to its plain version
   on these paths' own inputs (`kernel_inputs`); a 1 s input on the card
   and on the CPU plain path at full depth (fp32, atol 1e-3). Then the two
   open measurements: K1's fp32 max |err| / RMS per decoder stage at 930
   and 4,480 frames (random z, each stage on the plain path's input), and
   a device profile of HuBERT + prior in fp32 and bf16 for one 10 s
   request at both HuBERT sizes (48k_base's 12 x 768, base.json's 48 x
   1280).
7d. multi_gpu, two ranks over gloo sharing the card when there is one
   card (NCCL refuses two ranks on one card), over NCCL on two cards
   otherwise; the ranks are spawned after the kernels are built, and
   load them, and run under deterministic algorithms (`_rank_device`):
   (ii) DP = 2, one 48k_base fp32 step at B = 16 against the one-process
   step with the same seed and batch, learning rate 0 so that both D
   halves see one generator; the one-process step run twice must be equal
   bit for bit, and against it the metrics hold rtol 1e-5 and each
   parameter group's (gen.enc_p, gen.flow, ..., disc.msd) gradients
   ||err|| / ||grad|| its limit (`grad_limit`: 3e-2 enc_p, 5e-3 dec, 5e-4
   each discriminator, 1e-4 the rest; max |err| over the group's RMS and
   largest printed beside it), then a timed step;
   (iii) TP = 2 on base.json: a 10 s convert (noise 0) against world 1
   (max |err| <= 1e-4 x RMS), one fp32 step at B = 4 against world 1 (the
   checks of (ii)), K1 and K2 held to their
   plain versions on the TP
   inference's own inputs (K2's weights gathered from the shards), each
   rank's peak memory; (iv) a ServingDaemon with 2 replicas against 1, 4 x
   10 s in one batch (atol 1e-5), requests/s; (v) dryrun_multigpu(2).
   Each phase prints its seconds.
8. Prints the launches of each path (serve: the first round of both
   dtypes; stream: the windowed runs) (counters set to 0 just before each
   path and read just after; the multi-GPU ranks' counts are rank 0's,
   read around its own step or call), a `kernels` JSON line (with M1, and
   each kernel's launches on the TTS paths as `launches_tts` and on the
   new paths as `launches_base_json` and `launches_multi_gpu`), then,
   last, the result line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero; without a GPU it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FLOW_TOL = 1e-4
MRF_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SLICE_ATOL = 1e-3
STAGE_SHAPES = ((7440, 256), (59520, 128), (238080, 64), (476160, 32))  # 930 frames, 10 s
FLOW_FRAMES, FLOW_CH, FLOW_HID, FLOW_LAYERS, FLOW_K, N_FLOWS = 930, 128, 128, 4, 5, 4
SPEAKERS = (3, 77, 411)
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "48k_base.json")
STFT_TOL = 1e-4   # spec: x max |spec|; log-mel: absolute; against the plain version and float64
MEL_K3_TOL = 1e-6  # K4's log-mel against K3's, same sums: absolute
GATE_TOL = 1e-6   # absolute, fp32 elementwise
TRAIN_RTOL = 1e-3  # card vs CPU, one train step, every loss and grad norm
TRAIN_RTOL_BF16 = 0.1  # card vs CPU, one bf16 train step, BF16_KEYS
BF16_KEYS = ("loss/g/total", "loss/g/mel", "loss/g/kl", "loss/g/p_fm", "loss/g/s_fm",
             "loss/g/p_gen", "loss/g/s_gen", "loss/d/total", "grad_norm_g", "grad_norm_d")
GATE_TOL_BF16 = 1e-2  # error RMS / RMS, bf16 out and gradients
ACC_K, ACC_BATCH, ACC_MINI_STEPS = 2, 8, 4
PATH_A_PADDED = 483840  # a 10 s 48 kHz source padded to the 7680-sample unit
GATE_SHAPE = (16, 375, 128)  # the train step's posterior WN: B, spectrogram frames, H
N_TRAIN_STEPS = 5
PATH_C_STEPS, PATH_C_RESUME_TO = 6, 8
SERVE_BATCH, SERVE_WINDOW_MS = 16, 25.0  # the daemon's max_batch and latency window
SERVE_CLIENTS, SERVE_PER_CLIENT = 16, 2
STREAM_CHUNK_S, STREAM_PIECE_S = 2.0, 0.1  # a 2 s chunk, pushed as a microphone would
INT8_TOPS = 1979e12
INT8_FRAMES = 930  # decoder frames of a 10 s request, as STAGE_SHAPES
INT8_ULPS = 1  # Q1 against its plain version, units in the last place of the output type
INT8_CARD_CPU_SNR = 40.0  # dB, the W8A8 decoder alone, card vs the CPU plain path
INT8_W8A8_SNR = 24.0  # dB against the fp32 float decode (tests/test_int8_decoder.py:115-140)
INT8_MEL_L1 = 0.05  # W8A8 in bf16 against the bf16 float decode, mel-L1 (same test)
INT8_W8_SNR = 32.0  # dB, w8 against the fp32 float decode, and above W8A8's (:93-112)
INT8_MODES = (("float", False), ("w8a8", True), ("w8", "w8"))


def cuda_ms(fn, reps: int = 3) -> float:
    """Device time of fn() in ms: one warm-up call, then CUDA events around
    `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn, _build, name: str, reps: int = 3):
    """(cuda_ms(fn), launches of kernel `name` per call of fn, counted)."""
    n0 = _build.LAUNCHES[name]
    ms = cuda_ms(fn, reps)
    return ms, (_build.LAUNCHES[name] - n0) / (reps + 1)


def rel_err(got: torch.Tensor, ref: torch.Tensor, bf16: bool = False):
    """(max |err|, the error measure relative to the output's RMS): the
    largest error in float32, the error's RMS with bf16 weights (there,
    which bf16 step an input rounds to differs between the two sums, and
    that spreads through the chained convs)."""
    diff = got.float() - ref.float()
    d = diff.abs().max().item()
    rms = ref.float().pow(2).mean().sqrt().item()
    measure = diff.pow(2).mean().sqrt().item() if bf16 else d
    return d, measure / max(rms, 1e-12)


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stft_bound_ms(b: int, t: int, rows: int, n_fft: int, n_mels: int, nnz: int, spec: bool,
                  mel: bool):
    """The least time for |STFT| (spec) and/or log-mel (mel) of y [b, t]
    over `rows` frames, counted on the work the function needs: per frame
    a real FFT (2.5 n_fft log2 n_fft operations), the window, the magnitude
    (4 per bin), and for the mel the product with the fbank over its `nnz`
    non-zeros (2 each: the filterbank is sparse, and a sparse product counts
    what its inputs need) and the log; bytes: y once, each output once, the
    fbank's non-zeros once."""
    n_freq = n_fft // 2 + 1
    per_frame = 2.5 * n_fft * float(np.log2(n_fft)) + n_fft + 4 * n_freq
    nbytes = b * t + (rows * n_freq if spec else 0)
    if mel:
        per_frame += 2 * nnz + n_mels
        nbytes += nnz + rows * n_mels
    return bound_ms(rows * per_frame, 4 * nbytes, FP32_FLOPS)


def log_mel_f64(y: torch.Tensor, n_fft: int, hop: int, win: int, n_mels: int, sr: int):
    """The log-mel in float64 NumPy on the host (reflect pad, rfft, the 1e-6
    floor, the dense fbank product), on y's device: a second reference for
    the K3 and K4 log-mels beside the plain version, independent of its
    direct DFT."""
    from vcvits_tpu_torch.dsp.spectrogram import _padded_window, mel_filterbank

    pad = (n_fft - hop) // 2
    yp = np.pad(y.double().cpu().numpy(), ((0, 0), (pad, pad)), mode="reflect")
    nf = 1 + (yp.shape[1] - n_fft) // hop
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft, axis=1)[:, ::hop][:, :nf]
    x = np.fft.rfft(frames * _padded_window(n_fft, win, np.float64), axis=-1)
    spec = np.sqrt(x.real ** 2 + x.imag ** 2 + 1e-6)
    fbank = mel_filterbank(sr, n_fft, n_mels).astype(np.float64)
    return torch.as_tensor(np.log(np.maximum(spec @ fbank.T, 1e-5)), device=y.device)


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def kernel_device_ms(fn, name: str, reps: int = 5, flush_l2: bool = False) -> float:
    """Device time per call of fn of the kernels whose name holds `name`,
    from torch.profiler (device events only, `reps` calls after a warm-up):
    the kernel alone, without the host's cost per call that CUDA events
    around a short call take in. With `flush_l2`, a 256 MB buffer is
    written before each call, so that fn reads its inputs from device
    memory as its bytes bound assumes, not from the L2 its previous call
    left them in (the buffer's fill kernel is not counted). NaN where the
    profiler saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if flush_l2 else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if scratch is not None:
                scratch.zero_()
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(spans) / reps / 1e3 if spans else float("nan")


def stft_report(label: str, ms: float, device_ms: float, library_ms: float, b_ms: float,
                tile_ms) -> str:
    """For a K3 or K4 phase: the ratio to the library call, the bound's share
    of the kernel's time (CUDA events around the call, and the kernel's
    device time from the profiler) and the device time at each frame tile."""
    tiles = ", ".join(f"{tile}: {t_ms:.4f}" for tile, t_ms in tile_ms.items())
    return (f"{label}: kernel_ms / library_ms = {ms / library_ms:.3f}, bound_ms / kernel_ms = "
            f"{b_ms / ms:.4f}; device_ms={device_ms:.4f} (bound share {b_ms / device_ms:.4f}); "
            f"device_ms by frame tile {{{tiles}}}")


def info_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def build_phase(_build) -> None:
    took = _build.build()
    print(f"build: {json.dumps({k: round(v, 1) for k, v in took.items()})} s")
    for name in _build.KERNEL_SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        regs = [int(line.split("Used ")[1].split()[0]) for line in log.splitlines()
                if "registers" in line and "Used" in line]
        spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                     for line in log.splitlines() if "spill stores" in line)
        print(f"ptxas {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"spill stores {spills} bytes")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name, ops in (("mrf", ("HMMA", "HGMMA")), ("flow_coupling", ("HMMA", "HGMMA")),
                      ("int8_conv", ("IMMA", "IGMMA"))):
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))], capture_output=True,
                              text=True, check=True, timeout=120).stdout.splitlines()
        found = {op: sum(f" {op}." in line for line in sass) for op in ops}
        print(f"SASS {name}: " + ", ".join(f"{n} {op}" for op, n in found.items())
              + " instructions (tensor cores)")
        if not any(found.values()):
            raise AssertionError(f"{name}: the library's SASS has no {' or '.join(ops)} "
                                 f"instruction")


def flow_weights(rng, dev, half: int, h: int):
    """Random non-zero folded weights of one coupling, the last WN layer's
    res_skip packed into the skip half (its res half zero)."""
    n_l, k = FLOW_LAYERS, FLOW_K
    shapes = ((half, h), (h,), (n_l, k, h, 2 * h), (n_l, 2 * h), (n_l, h, 2 * h), (n_l, 2 * h),
              (h, half), (half,))
    ws = tuple(torch.tensor(rng.standard_normal(s) / np.sqrt(s[-2] * (k if len(s) == 4 else 1))
                            if len(s) > 1 else rng.standard_normal(s) * 0.1,
                            dtype=torch.float32, device=dev) for s in shapes)
    ws[4][-1, :, :h] = 0
    ws[5][-1, :h] = 0
    return ws


def flow_bounds(mode: str, b: int, t: int, c: int, h: int):
    """K2's least time for 4 launches of `mode` on [b, t, c] (4 couplings, or
    a 16-layer WaveNet as 4 segments): bytes of the inputs, outputs and
    weights once; operations 2 * multiply-adds a frame (pre, the K-tap
    convs, res_skip without the packed zero half, post). Returns (3xTF32
    bound and what bounds it, the CUDA-core fp32 bound, L2 weight bytes a
    launch: each CTA of each tile streams its slice of the weights)."""
    from vcvits_tpu_torch.ops.flow_coupling import plan

    n_l, k, half = FLOW_LAYERS, FLOW_K, c // 2
    wn = n_l * k * h * 2 * h + (n_l - 1) * h * 2 * h + h * h
    coupling = mode != "wn_segment"
    macs = b * t * N_FLOWS * (wn + (half * h + h * half if coupling else 0))
    n_w = (n_l * k * h * 2 * h + n_l * h * 2 * h + 4 * n_l * h
           + ((half * h + h + h * half + half) if coupling else 0))
    act = b * t * (2 * c if coupling else 4 * h) + b * t
    nbytes = 4 * N_FLOWS * (act + n_w + b * n_l * 2 * h)
    tc_ms, tc_by = bound_ms(3 * 2 * macs, nbytes, TF32_FLOPS)
    cores_ms, _ = bound_ms(2 * macs, nbytes, FP32_FLOPS)
    p = plan(h, k, n_l, half if coupling else None)
    ctas = b * -(-t // p.tile) * p.cluster
    per_cta = 4 * (n_l * (k + 1) * h * 2 * p.pairs + ((half * p.pairs + h * half) if coupling
                                                      else 0))
    return tc_ms, tc_by, cores_ms, ctas * per_cta


def flow_phase(rng, dev, _build):
    """K2's three modes at the paths' shapes against their plain versions:
    4 couplings reverse and forward, and the posterior's 16-layer WaveNet as
    4 wn_segment launches, on [1, 930, 128] and a ragged batch of 2; the
    reverse also at hidden 256 (configs/base.json's flow)."""
    from vcvits_tpu_torch.ops.flow_coupling import (
        KERNEL_NAMES, WN_SEGMENT_LAYERS, coupling_forward, coupling_forward_plain,
        coupling_reverse, coupling_reverse_plain, kernel_plan, plan, wn_segment,
        wn_segment_plain)

    modes = {"flow_coupling_reverse": (coupling_reverse, coupling_reverse_plain),
             "flow_coupling_forward": (coupling_forward, coupling_forward_plain),
             "wn_segment": (wn_segment, wn_segment_plain)}
    assert set(modes) == set(KERNEL_NAMES.values())
    for h, half in ((FLOW_HID, FLOW_CH // 2), (256, 128)):
        for n_l, hf in ((FLOW_LAYERS, half), (WN_SEGMENT_LAYERS, None)):
            p = plan(h, FLOW_K, n_l, hf)
            if (p.cluster, p.tile, p.smem) != kernel_plan(h, FLOW_K, n_l, hf):
                raise AssertionError(f"flow plan {p} differs from the library's flow_plan")
    out = {}
    cases = [(name, b, FLOW_FRAMES, FLOW_CH, FLOW_HID) for name in modes for b in (1, 2)]
    cases.append(("flow_coupling_reverse", 1, FLOW_FRAMES, 256, 256))
    for name, b, t, c, h in cases:
        kernel, plain = modes[name]
        couplings = [flow_weights(rng, dev, c // 2, h) for _ in range(N_FLOWS)]
        conds = [torch.tensor(rng.standard_normal((b, FLOW_LAYERS * 2 * h)) * 0.3,
                              dtype=torch.float32, device=dev) for _ in range(N_FLOWS)]
        lens = torch.tensor([t - 230 * i for i in range(b)], device=dev)
        mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()[..., None]
        if name == "wn_segment":
            x = torch.tensor(rng.standard_normal((b, t, h)), dtype=torch.float32,
                             device=dev) * mask

            def chain(fn):
                y, skip = x, torch.zeros_like(x)
                for w, cnd in zip(couplings, conds):
                    y, skip = fn(y, skip, mask, cnd, w[2:6])
                return skip * mask
        else:
            x = torch.tensor(rng.standard_normal((b, t, c)), dtype=torch.float32, device=dev)

            def chain(fn):
                y = x
                for w, cnd in zip(couplings, conds):
                    y = fn(torch.flip(y, dims=[-1]).contiguous(), mask, cnd, w)
                return y

        got, ref = chain(kernel), chain(plain)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        label = f"{name} [{b},{t},{c}] hidden {h}"
        if not (rel <= FLOW_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"{label}: max |err| {err:.3e} = {rel:.3e} x RMS > {FLOW_TOL}")
        ms, launches = timed(lambda: chain(kernel), _build, name)
        device_ms = kernel_device_ms(lambda: chain(kernel), "wn_stack_kernel")
        plain_ms = cuda_ms(lambda: chain(plain))
        b_ms, b_by, cores_ms, l2_bytes = flow_bounds(name, b, t, c, h)
        print(f"{label} x{N_FLOWS} launches fp32: kernel_ms={ms:.4f} device_ms={device_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, 3xTF32; CUDA-core fp32 "
              f"{cores_ms:.4f}) bound share {b_ms / ms:.4f} (device {b_ms / device_ms:.4f}) "
              f"launches={launches:g} max_abs_err={err:.3e} rel={rel:.3e}; "
              f"L2 weight bytes a launch {l2_bytes / 1e6:.2f} MB")
        out[(name, b, h)] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "bound_ms_cuda_cores": cores_ms,
                             "l2_weight_bytes": l2_bytes, "max_abs_err": err, "rel_err": rel}
        if (name, b, h) == ("flow_coupling_reverse", 1, FLOW_HID):
            # bf16 in and out, as a bf16 validation's flow reverse runs it
            x32 = x
            x = x32.bfloat16()
            got, ref = chain(kernel), chain(plain)
            torch.cuda.synchronize()
            err16, rel16 = rel_err(got, ref, bf16=True)
            if not (got.dtype == torch.bfloat16 and rel16 <= MRF_TOL[torch.bfloat16]
                    and torch.isfinite(got.float()).all()):
                raise AssertionError(f"{label} bf16 in/out: error RMS {rel16:.3e} x RMS > "
                                     f"{MRF_TOL[torch.bfloat16]} (dtype {got.dtype})")
            ms16, launches16 = timed(lambda: chain(kernel), _build, name)
            print(f"{label} x{N_FLOWS} launches bf16 in/out: kernel_ms={ms16:.4f} "
                  f"launches={launches16:g} max_abs_err={err16:.3e} rel_rms={rel16:.3e}")
            out[(name + "_bf16", b, h)] = {"ms": ms16, "max_abs_err": err16, "rel_err": rel16}
            x = x32
        del couplings, conds, x, got, ref
    return out


def mrf_bound_ms(t: int, c: int, n_w: int, wdt, b: int = 1):
    """K1's least time for one stage [b, t, c]: bytes of x, the output and
    the weights once; operations 2 * n_w * c^2 * t * b. bf16 at the tensor
    cores' bf16 rate; fp32 the lesser of the CUDA cores' fp32 FMAs and
    3xTF32 (three TF32 products per multiply-add) on the tensor cores.
    Returns (bound_ms, bound_by, cuda_core_ms, tf32x3_ms)."""
    isz = 4 if wdt == torch.float32 else 2
    nbytes = 2 * b * t * c * isz + (n_w * c * c + 2 * 9 * c) * isz
    flops = 2 * n_w * c * c * t * b
    if wdt == torch.bfloat16:
        return (*bound_ms(flops, nbytes, BF16_FLOPS), None, None)
    cores, cores_by = bound_ms(flops, nbytes, FP32_FLOPS)
    tc, tc_by = bound_ms(3 * flops, nbytes, TF32_FLOPS)
    return (cores, cores_by, cores, tc) if cores <= tc else (tc, tc_by, cores, tc)


def mrf_phase(rng, dev, _build):
    from vcvits_tpu_torch.ops.mrf import launches_per_stage, mrf, mrf_plain, plan

    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    n_w = 2 * sum(k * len(d) for k, d in zip(ks, ds))  # 126 taps of C x C
    out = {}
    for wdt in (torch.float32, torch.bfloat16):
        label = str(wdt)[6:]
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0, "max_abs_err": 0.0,
               "bound_ms_cuda_cores": 0.0, "bound_ms_3xtf32": 0.0}
        for t, c in STAGE_SHAPES:
            xdt = torch.float32 if wdt == torch.float32 else torch.bfloat16
            x = torch.tensor(rng.standard_normal((1, t, c)), dtype=torch.float32,
                             device=dev).to(xdt)
            blocks = []
            for k, dil in zip(ks, ds):
                n = len(dil)
                blocks.append(tuple(
                    torch.tensor(rng.standard_normal(s) * sc, dtype=torch.float32, device=dev)
                    .to(wdt).contiguous()
                    for s, sc in (((n, k, c, c), 1 / np.sqrt(k * c)), ((n, c), 0.1),
                                  ((n, k, c, c), 1 / np.sqrt(k * c)), ((n, c), 0.1))))
            got = mrf(x, blocks, ks, ds)
            ref = mrf_plain(x, blocks, ks, ds)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref, bf16=wdt == torch.bfloat16)
            if not (rel <= MRF_TOL[wdt] and torch.isfinite(got.float()).all()):
                raise AssertionError(f"mrf C={c} T={t} {wdt}: max |err| {err:.3e}, "
                                     f"relative error {rel:.3e} > {MRF_TOL[wdt]}")
            kernel = lambda: mrf(x, blocks, ks, ds)  # noqa: E731
            ms, launches = timed(kernel, _build, "mrf")
            if launches != launches_per_stage(ds):
                raise AssertionError(f"mrf C={c}: {launches} launches a stage, expected "
                                     f"{launches_per_stage(ds)}")
            device_ms = kernel_device_ms(kernel, "mrf_pair_kernel")
            plain_ms = cuda_ms(lambda: mrf_plain(x, blocks, ks, ds))
            b_ms, b_by, cores_ms, tc_ms = mrf_bound_ms(t, c, n_w, wdt)
            tiles = {k: plan(c, k, max(d), wdt) for k, d in zip(ks, ds)}
            p = tiles[ks[-1]]
            bound_note = (f"bound_ms={b_ms:.4f} ({b_by})" if cores_ms is None else
                          f"bound_ms={b_ms:.4f} ({b_by}; CUDA-core fp32 {cores_ms:.4f}, "
                          f"3xTF32 {tc_ms:.4f})")
            print(f"mrf [1,{t},{c}] {label}: kernel_ms={ms:.4f} device_ms={device_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} {bound_note} bound share {b_ms / ms:.4f} "
                  f"(device {b_ms / device_ms:.4f}) launches={launches:g} "
                  f"max_abs_err={err:.3e} rel={rel:.3e}; tile {p.rows} conv1 rows, "
                  f"{'/'.join(str(tiles[k].out_rows) for k in ks)} output rows for k "
                  f"{'/'.join(map(str, ks))}, {p.threads} threads, {p.smem} B shared memory "
                  f"at k {ks[-1]} d {max(ds[-1])}")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                           ("device_ms", device_ms), ("bound_ms_cuda_cores", cores_ms or 0.0),
                           ("bound_ms_3xtf32", tc_ms or 0.0)):
                tot[key] += v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bound_by"] = b_by
            del x, blocks, got, ref
        extra = ("" if wdt == torch.bfloat16 else
                 f" (CUDA-core fp32 {tot['bound_ms_cuda_cores']:.4f}, 3xTF32 "
                 f"{tot['bound_ms_3xtf32']:.4f})")
        print(f"mrf all 4 stages {label}: kernel_ms={tot['ms']:.4f} "
              f"device_ms={tot['device_ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
              f"bound_ms={tot['bound_ms']:.4f}{extra}")
        out[wdt] = tot
    return out


def write_sources(tmp: str, n: int = 3, seconds: float = 10.0, sr: int = 22050):
    """Synthetic voiced sources: a gliding harmonic tone with vibrato and
    breath noise, one per speaker, from a fixed seed."""
    from vcvits_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(11)
    t = np.arange(int(seconds * sr)) / sr
    paths = []
    for i in range(n):
        f0 = 140.0 * (1 + 0.3 * i) * (1 + 0.2 * t / seconds) * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wav = sum(0.3 / (h + 1) * np.sin((h + 1) * phase) for h in range(6))
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t) ** 2) + 0.01 * rng.standard_normal(len(t))
        p = os.path.join(tmp, f"src{i}.wav")
        write_wav(p, wav.astype(np.float32), sr, subtype="PCM_16")
        paths.append(p)
    return paths


def reference_check(cfg, dev) -> None:
    """A short input through the card (kernels) and the CPU (plain path),
    same weights (`perturbed_state`) and noise."""
    from vcvits_tpu_torch.infer import VoiceConverter

    sd = perturbed_state(cfg)
    rng = np.random.default_rng(5)
    n = 7680
    t = np.arange(n) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(n)).astype(np.float32)
    pitch = np.full(n // 320, 120, np.int64)
    eps = rng.standard_normal((1, 45, cfg.model.inter_channels)).astype(np.float32)
    outs = []
    for device in (dev, "cpu"):
        vc = VoiceConverter(cfg, sd, device=device)
        outs.append(vc.convert_array(wav, pitch, 7, noise_scale=0.8, eps=eps))
        del vc
    gpu, cpu = outs
    diff = float(np.abs(gpu - cpu).max())
    level = float(np.abs(cpu).mean())
    print(f"slice reference (0.48 s, card kernels vs CPU plain path, fp32): samples={len(gpu)} "
          f"max_abs_err={diff:.3e} mean|y|={level:.3e}")
    if len(gpu) != len(cpu) or not diff <= SLICE_ATOL or not level > 1e-2:
        raise AssertionError(f"slice: card and CPU outputs differ by {diff:.3e} (limit "
                             f"{SLICE_ATOL}) at mean |y| {level:.3e}")


def breakdown(vc, wav, pitch, label) -> None:
    """Device time of each part of one 10 s request (CUDA events)."""
    from vcvits_tpu_torch.ops.mrf import mrf
    from vcvits_tpu_torch.models.layers import leaky_relu
    from vcvits_tpu_torch.utils.masking import nearest_interp, sequence_mask

    g_mod, dev = vc.gen, vc.device
    x = torch.as_tensor(wav, device=dev)[None]
    lens = torch.tensor([len(wav)], device=dev)
    pit = torch.as_tensor(pitch, device=dev)[None]
    sid = torch.tensor([3], device=dev)
    parts = {}
    with torch.no_grad():
        enc = g_mod.enc_p(x, lens, pit)
        parts["hubert+prior"] = cuda_ms(lambda: g_mod.enc_p(x, lens, pit), 2)
        g = g_mod.emb_g(sid)
        t_out = int(round(x.shape[1] * 3 / 512))
        y_mask = sequence_mask((lens.float() * (3 / 512)).int(), t_out).to(enc[1].dtype)
        z_p = nearest_interp(enc[1], t_out)
        parts["flow (K2)"] = cuda_ms(lambda: g_mod.flow.kernel_reverse(z_p, y_mask, g), 2)
        dec = g_mod.dec
        h = dec.conv_pre(z_p) + dec.cond(g)[:, None, :]
        for i, blocks in enumerate(dec.mrf_weights()):
            up = getattr(dec, f"up_{i}")
            parts[f"up_{i}"] = cuda_ms(lambda: up(leaky_relu(h)), 2)
            h = up(leaky_relu(h)).contiguous()
            parts[f"mrf_{i} (K1)"] = cuda_ms(lambda: mrf(h, blocks, dec.kernel_sizes,
                                                          dec.dilations), 2)
            h = mrf(h, blocks, dec.kernel_sizes, dec.dilations)
        parts["conv_post"] = cuda_ms(lambda: dec.conv_post(leaky_relu(h, 0.01)), 2)
    total = sum(parts.values())
    print(f"breakdown {label} (device ms, one 10 s request): " + ", ".join(
        f"{k}={v:.3f}" for k, v in parts.items()) + f"; sum={total:.3f}")


def slice_phase(dev, _build, card: str):
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.dsp.resample import resample
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    from vcvits_tpu_torch.utils.audio_io import read_wav

    cfg = load_config(CONFIG)
    reference_check(cfg, dev)
    m = cfg.model
    per_req = {"mrf": len(m.upsample_rates) * launches_per_stage(m.resblock_dilation_sizes),
               "flow_coupling_reverse": 4}
    hop = cfg.data.hop_length
    ls = (cfg.data.target_sampling_rate / hop) / cfg.data.source_sampling_rate
    with tempfile.TemporaryDirectory() as tmp:
        srcs = write_sources(tmp)
        true_lens = [len(resample(*read_wav(p), cfg.data.source_sampling_rate)) for p in srcs]
        jobs = [(s, os.path.join(tmp, f"out{i}.wav"), sid)
                for i, (s, sid) in enumerate(zip(srcs, SPEAKERS))]
        vcs = {}
        _build.LAUNCHES.clear()
        runs = 0
        for dtype in (torch.float32, torch.bfloat16):
            vc = VoiceConverter(cfg, dtype=dtype, device=dev, seed=0)
            vcs[dtype] = vc
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            outs = vc.convert_many(jobs, collect_audio=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs += len(jobs)
            for (_, dst, _), out, true_len in zip(jobs, outs, true_lens):
                y_len = int((torch.tensor([true_len], dtype=torch.float32) * ls)
                            .to(torch.int32).item())
                written, sr = read_wav(dst)
                if len(out) != y_len * hop or len(written) != len(out) or sr != 48000:
                    raise AssertionError(f"{dst}: {len(out)} samples, expected {y_len * hop}")
                if not np.isfinite(out).all():
                    raise AssertionError(f"{dst}: non-finite output")
            for name, n in per_req.items():
                rose = _build.LAUNCHES[name] - before.get(name, 0)
                if rose != n * len(jobs):
                    raise AssertionError(f"{name}: {rose} launches for {len(jobs)} requests, "
                                         f"expected {n * len(jobs)}")
            secs = sum(len(o) for o in outs) / 48000
            label = str(dtype)[6:]
            print(f"slice {label}: convert_many 3 x 10 s, {wall * 1e3 / len(jobs):.1f} ms per "
                  f"request incl. host prep, rtf={secs / wall:.2f}x real time on {card}; "
                  f"launches { {k: _build.LAUNCHES[k] - before.get(k, 0) for k in per_req} }")
        counts = dict(_build.LAUNCHES)
        # device-side numbers after the counted run: one prepared request
        wav, true_len, pitch = vcs[torch.float32].prepare_source(srcs[0])
        for dtype, vc in vcs.items():
            label = str(dtype)[6:]
            def one():
                vc.convert_array(wav, pitch, 3, true_len)
            one()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                one()
            torch.cuda.synchronize()
            per = (time.perf_counter() - t0) / 3
            print(f"slice {label}: convert_array (prepared 10 s source) {per * 1e3:.1f} ms per "
                  f"request, rtf={true_len / 16000 / per:.2f}x real time on {card}")
            breakdown(vc, wav, pitch, label)
    for name, n in per_req.items():
        if counts.get(name, 0) != n * runs:
            raise AssertionError(f"{name}: launched {counts.get(name, 0)} times on the main "
                                 f"path, expected {n * runs}")
    return counts


def stft_phase(rng, dev, _build):
    """K3 at the main paths' shapes: the train step's 16 x 4 s targets
    (spec + mel) and one padded 10 s voice_conversion source (spec only)."""
    import torch.nn.functional as F

    from vcvits_tpu_torch.dsp.spectrogram import hann_window, mel_filterbank
    from vcvits_tpu_torch.ops.stft_mel import (
        _TILES, SPEC_MEL, SPEC_ONLY, _launch, spectrogram, spectrogram_mel,
        spectrogram_mel_plain, spectrogram_plain)

    n_fft, hop, n_mels, sr = 2048, 512, 128, 48000
    fbank = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels).T.copy(), device=dev)
    nnz = int((fbank != 0).sum().item())
    window = torch.as_tensor(hann_window(n_fft), device=dev)
    n_freq = n_fft // 2 + 1
    out = {}
    for label, b, t, with_mel in (("train 16 x 4 s", 16, 4 * 48000, True),
                                  ("vc 1 x 10.08 s", 1, PATH_A_PADDED, False)):
        n = np.arange(t) / sr
        tone = sum(0.2 / (h + 1) * np.sin(2 * np.pi * 150.0 * (h + 1) * n) for h in range(10))
        y = torch.tensor(tone[None, :] + 0.02 * rng.standard_normal((b, t)), dtype=torch.float32,
                         device=dev)
        if with_mel:
            kernel = lambda: spectrogram_mel(y, n_fft, n_mels, sr, hop, n_fft)  # noqa: E731
            plain = lambda: spectrogram_mel_plain(y, n_fft, n_mels, sr, hop, n_fft)  # noqa: E731
        else:
            kernel = lambda: (spectrogram(y, n_fft, hop, n_fft), None)  # noqa: E731
            plain = lambda: (spectrogram_plain(y, n_fft, hop, n_fft), None)  # noqa: E731

        def library():
            yp = F.pad(y[:, None, :], ((n_fft - hop) // 2,) * 2, mode="reflect")[:, 0]
            st = torch.stft(yp, n_fft, hop, n_fft, window=window, center=False,
                            return_complex=True)
            spec = torch.sqrt(st.real ** 2 + st.imag ** 2 + 1e-6).transpose(1, 2)
            return spec, torch.log(torch.clamp_min(spec @ fbank, 1e-5)) if with_mel else None

        (spec, mel), (rspec, rmel), (lspec, lmel) = kernel(), plain(), library()
        torch.cuda.synchronize()
        top = rspec.abs().max().item()
        err = (spec - rspec).abs().max().item()
        mel_err = mel_f64_err = plain_f64_err = 0.0
        if with_mel:
            exact = log_mel_f64(y, n_fft, hop, n_fft, n_mels, sr)
            mel_err = (mel - rmel).abs().max().item()
            mel_f64_err = (mel.double() - exact).abs().max().item()
            plain_f64_err = (rmel.double() - exact).abs().max().item()
        lib_err = (lspec - rspec).abs().max().item()
        if not (err <= STFT_TOL * top and mel_err <= STFT_TOL and mel_f64_err <= STFT_TOL
                and torch.isfinite(spec).all()):
            raise AssertionError(f"stft_mel {label}: spec max |err| {err:.3e} (limit "
                                 f"{STFT_TOL * top:.3e}), log-mel max |err| {mel_err:.3e} "
                                 f"against the plain version and {mel_f64_err:.3e} against "
                                 f"float64 (limit {STFT_TOL})")
        ms, launches = timed(kernel, _build, "stft_mel")
        plain_ms, library_ms = cuda_ms(plain), cuda_ms(library)
        mode = SPEC_MEL if with_mel else SPEC_ONLY
        device_ms = kernel_device_ms(kernel, "stft_mel_kernel")
        tile_ms = {tile: kernel_device_ms(lambda: _launch(y, mode, n_fft, hop, n_fft, n_mels, sr,
                                                          tile=tile), "stft_mel_kernel")
                   for tile in _TILES}
        b_ms, b_by = stft_bound_ms(b, t, spec.shape[0] * spec.shape[1], n_fft, n_mels, nnz,
                                   spec=True, mel=with_mel)
        print(f"stft_mel {label} [{b},{t}] -> [{spec.shape[0]},{spec.shape[1]},{n_freq}]"
              f"{' + mel' if with_mel else ''}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (torch.stft + matmul, max |diff| {lib_err:.3e}) "
              f"bound_ms={b_ms:.4f} ({b_by}) launches={launches:g} max_abs_err={err:.3e} "
              f"(max |spec| {top:.3e}) mel_max_abs_err={mel_err:.3e} (against float64: the "
              f"kernel {mel_f64_err:.3e}, the plain version {plain_f64_err:.3e})")
        print(stft_report(f"stft_mel {label}", ms, device_ms, library_ms, b_ms, tile_ms))
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms, "max_abs_err": max(err, mel_err)}
    return out


def gate_phase(rng, dev, _build):
    """K5 forward and backward at the train step's posterior WN shape."""
    from vcvits_tpu_torch.ops.fused_gate import (
        fused_add_tanh_sigmoid_multiply, fused_gate, launch_backward, launch_forward)

    b, t, h = GATE_SHAPE
    a = torch.tensor(rng.standard_normal((b, t, 2 * h)), dtype=torch.float32, device=dev)
    bb = torch.tensor(rng.standard_normal((b, 1, 2 * h)), dtype=torch.float32, device=dev)
    go = torch.tensor(rng.standard_normal((b, t, h)), dtype=torch.float32, device=dev)

    def graph(fn):
        a_, b_ = a.clone().requires_grad_(), bb.clone().requires_grad_()
        return fn(a_, b_, h), a_, b_

    res = {}
    for fn in (fused_gate, fused_add_tanh_sigmoid_multiply):
        out, a_, b_ = graph(fn)
        out.backward(go)
        res[fn] = (out.detach(), a_.grad, b_.grad)
    torch.cuda.synchronize()
    got, ref = res[fused_gate], res[fused_add_tanh_sigmoid_multiply]
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    limits = (GATE_TOL, GATE_TOL, GATE_TOL * t)  # grad_b sums t terms
    if not all(e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError(f"fused_gate: max |err| out/grad_a/grad_b {errs} > {limits}")
    # the kernels alone (one launch each), then through the autograd wrapper
    b2 = bb.reshape(b, 2 * h)
    ms, launches = timed(lambda: launch_forward(a, b2, h), _build, "fused_gate", reps=20)
    wrap_ms = cuda_ms(lambda: fused_gate(a, bb, h), reps=20)
    plain_ms = cuda_ms(lambda: fused_add_tanh_sigmoid_multiply(a, bb, h), reps=20)
    bwd_ms, bwd_launches = timed(lambda: launch_backward(go, a, b2, h), _build,
                                 "fused_gate_backward", reps=20)

    def backward_of(fn):
        out, _, _ = graph(fn)
        return lambda: out.backward(go, retain_graph=True)

    bwd_wrap_ms = cuda_ms(backward_of(fused_gate), reps=20)
    bwd_plain_ms = cuda_ms(backward_of(fused_add_tanh_sigmoid_multiply), reps=20)
    dev_ms = kernel_device_ms(lambda: launch_forward(a, b2, h), "gate_fwd_kernel", reps=20,
                              flush_l2=True)
    bwd_dev_ms = kernel_device_ms(lambda: launch_backward(go, a, b2, h), "gate_bwd_kernel",
                                  reps=20, flush_l2=True)
    host_us, host_us_before = gate_host_us(a, b2, h, _build)
    # bf16 forward and backward, as a bf16 train step's WaveNets run them
    a32, bb32, go32 = a, bb, go
    a, bb, go = a32.bfloat16(), bb32.bfloat16(), go32.bfloat16()
    res16 = {}
    for fn in (fused_gate, fused_add_tanh_sigmoid_multiply):
        out16, a_, b_ = graph(fn)
        out16.backward(go)
        res16[fn] = (out16.detach(), a_.grad, b_.grad)
    torch.cuda.synchronize()
    got16, ref16 = res16[fused_gate], res16[fused_add_tanh_sigmoid_multiply]
    rel16 = [rel_err(g, r, bf16=True)[1] for g, r in zip(got16, ref16)]
    if not (all(g.dtype == torch.bfloat16 for g in got16)
            and all(e <= GATE_TOL_BF16 for e in rel16)):
        raise AssertionError(f"fused_gate bf16: error RMS / RMS out/grad_a/grad_b {rel16} > "
                             f"{GATE_TOL_BF16} (dtypes {[g.dtype for g in got16]})")
    ms16, _ = timed(lambda: fused_gate(a, bb, h), _build, "fused_gate", reps=20)
    bwd16 = cuda_ms(backward_of(fused_gate), reps=20)
    print(f"fused_gate [{b},{t},{2 * h}] bf16: forward wrapper_ms={ms16:.4f}, backward "
          f"autograd_ms={bwd16:.4f}; error RMS / RMS out {rel16[0]:.3e} grad_a {rel16[1]:.3e} "
          f"grad_b {rel16[2]:.3e} (limit {GATE_TOL_BF16})")
    a, bb, go = a32, bb32, go32
    rows = b * t
    f_bytes = 4 * (rows * 2 * h + b * 2 * h + rows * h)
    b_bytes = 4 * (rows * h + rows * 2 * h + b * 2 * h + rows * 2 * h + b * 2 * h)
    fwd_bound, fwd_by = bound_ms(6 * rows * h, f_bytes, FP32_FLOPS)
    bwd_bound, bwd_by = bound_ms(12 * rows * h, b_bytes, FP32_FLOPS)
    print(f"fused_gate [{b},{t},{2 * h}] fp32 forward: kernel_ms={ms:.4f} "
          f"device_ms={dev_ms:.4f} (L2 flushed before each launch; bound share "
          f"{fwd_bound / dev_ms:.3f}) wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={fwd_bound:.4f} ({fwd_by}) launches={launches:g} "
          f"max_abs_err={errs[0]:.3e}; host us per launch {host_us:.2f} (the earlier host path, "
          f"replicated: {host_us_before:.2f})")
    print(f"fused_gate [{b},{t},{2 * h}] fp32 backward: kernel_ms={bwd_ms:.4f} "
          f"device_ms={bwd_dev_ms:.4f} (L2 flushed; bound share {bwd_bound / bwd_dev_ms:.3f}) "
          f"autograd_ms={bwd_wrap_ms:.4f} "
          f"plain_autograd_ms={bwd_plain_ms:.4f} bound_ms={bwd_bound:.4f} ({bwd_by}) "
          f"launches={bwd_launches:g} grad_a max_abs_err={errs[1]:.3e} "
          f"grad_b max_abs_err={errs[2]:.3e}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": fwd_bound,
            "bound_by": fwd_by, "max_abs_err": errs[0], "wrapper_ms": wrap_ms,
            "host_us_per_launch": host_us, "host_us_per_launch_before": host_us_before,
            "ms_backward": bwd_ms, "device_ms_backward": bwd_dev_ms,
            "autograd_ms_backward": bwd_wrap_ms, "plain_autograd_ms_backward": bwd_plain_ms,
            "bound_ms_backward": bwd_bound, "max_abs_err_backward": max(errs[1:]),
            "wrapper_ms_bf16": ms16, "autograd_ms_backward_bf16": bwd16,
            "rel_rms_err_bf16": max(rel16)}


def gate_host_us(a, b2, h: int, _build, n: int = 1000):
    """Host microseconds a K5 forward launch costs, perf_counter over n
    launches with no sync: the wrapper's `launch_forward`, and a replica of
    the host path it had earlier (a torch.cuda.device context,
    the library looked up and its types checked, a torch.cuda.Stream built
    for its handle) calling the same library entry. The replica is a
    timing aid outside every counted run, not a wrapper."""
    from vcvits_tpu_torch.ops.fused_gate import _lib, launch_forward

    bsz, t, _ = a.shape
    lib = _lib()

    def before():
        out = torch.empty(bsz, t, h, dtype=a.dtype, device=a.device)
        with torch.cuda.device(a.device):
            old = _build.load("fused_gate")
            getattr(old, "_vc_typed", False)
            err = lib.fused_gate_fwd(a.data_ptr(), b2.data_ptr(), out.data_ptr(), bsz, t, h, 0,
                                     torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(err, "fused_gate_fwd")
        return out

    res = {}
    for label, fn in (("after", lambda: launch_forward(a, b2, h)), ("before", before)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        res[label] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return res["after"], res["before"]


def mel_phase(rng, dev, _build):
    """K4 at the validation shape (one 10 s clip, 937 frames) and 16 x 4 s."""
    import torch.nn.functional as F

    from vcvits_tpu_torch.dsp.spectrogram import hann_window, mel_filterbank
    from vcvits_tpu_torch.ops.stft_mel import (
        _TILES, MEL_ONLY, _launch, mel_spectrogram, mel_spectrogram_plain, spectrogram_mel)

    n_fft, hop, n_mels, sr = 2048, 512, 128, 48000
    fbank = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels).T.copy(), device=dev)
    nnz = int((fbank != 0).sum().item())
    window = torch.as_tensor(hann_window(n_fft), device=dev)
    out = {}
    for label, b, t in (("validation 1 x 10 s", 1, 10 * 48000), ("16 x 4 s", 16, 4 * 48000)):
        n = np.arange(t) / sr
        tone = sum(0.2 / (h + 1) * np.sin(2 * np.pi * 170.0 * (h + 1) * n) for h in range(10))
        y = torch.tensor(tone[None, :] + 0.02 * rng.standard_normal((b, t)), dtype=torch.float32,
                         device=dev)
        kernel = lambda: mel_spectrogram(y, n_fft, n_mels, sr, hop, n_fft)  # noqa: E731
        plain = lambda: mel_spectrogram_plain(y, n_fft, n_mels, sr, hop, n_fft)  # noqa: E731

        def library():
            yp = F.pad(y[:, None, :], ((n_fft - hop) // 2,) * 2, mode="reflect")[:, 0]
            st = torch.stft(yp, n_fft, hop, n_fft, window=window, center=False,
                            return_complex=True)
            spec = torch.sqrt(st.real ** 2 + st.imag ** 2 + 1e-6).transpose(1, 2)
            return torch.log(torch.clamp_min(spec @ fbank, 1e-5))

        mel, ref, k3_mel, lib = kernel(), plain(), spectrogram_mel(y, n_fft, n_mels, sr, hop,
                                                                   n_fft)[1], library()
        torch.cuda.synchronize()
        exact = log_mel_f64(y, n_fft, hop, n_fft, n_mels, sr)
        err = (mel - ref).abs().max().item()
        f64_err = (mel.double() - exact).abs().max().item()
        plain_f64_err = (ref.double() - exact).abs().max().item()
        k3_err = (mel - k3_mel).abs().max().item()
        lib_err = (lib - ref).abs().max().item()
        if not (err <= STFT_TOL and f64_err <= STFT_TOL and k3_err <= MEL_K3_TOL
                and torch.isfinite(mel).all() and mel.shape == ref.shape):
            raise AssertionError(f"mel_spectrogram {label}: log-mel max |err| {err:.3e} against "
                                 f"the plain version and {f64_err:.3e} against float64 (limit "
                                 f"{STFT_TOL}), against K3's mel {k3_err:.3e} (limit "
                                 f"{MEL_K3_TOL})")
        ms, launches = timed(kernel, _build, "mel_spectrogram")
        plain_ms, library_ms = cuda_ms(plain), cuda_ms(library)
        device_ms = kernel_device_ms(kernel, "stft_mel_kernel")
        tile_ms = {tile: kernel_device_ms(lambda: _launch(y, MEL_ONLY, n_fft, hop, n_fft, n_mels,
                                                          sr, tile=tile), "stft_mel_kernel")
                   for tile in _TILES}
        b_ms, b_by = stft_bound_ms(b, t, mel.shape[0] * mel.shape[1], n_fft, n_mels, nnz,
                                   spec=False, mel=True)
        print(f"mel_spectrogram (K4) {label} [{b},{t}] -> [{mel.shape[0]},{mel.shape[1]},"
              f"{n_mels}]: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"(torch.stft + matmul, max |diff| {lib_err:.3e}) bound_ms={b_ms:.4f} ({b_by}) "
              f"launches={launches:g} max_abs_err={err:.3e} (against float64: the kernel "
              f"{f64_err:.3e}, the plain version {plain_f64_err:.3e}) vs_k3_mel={k3_err:.3e}")
        print(stft_report(f"mel_spectrogram (K4) {label}", ms, device_ms, library_ms, b_ms,
                          tile_ms))
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms, "max_abs_err": err, "vs_k3": k3_err}
    return out


def perturbed_state(cfg):
    """Seeded weights with the flow's zero `post` made random and the
    decoder's weight-norm gains x 3: JAX's initialisers leave the flow an
    identity and the decoder near silent, which would make a comparison of
    outputs check little."""
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

    model = SynthesizerSVC.from_config(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("flow.") and ".post." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.startswith("dec.") and name.endswith(".g"):
                p.mul_(3.0)
    return model.state_dict()


# kernel-name classes a profile sums: cuDNN's and CUTLASS's convolution
# backward (data and weight gradients), their forward, and the layout
# transposes cuDNN puts around its NHWC tensor-core kernels
KERNEL_CLASSES = {"conv backward (dgrad + wgrad)": ("dgrad", "wgrad"),
                  "conv forward": ("convolve", "fprop"),
                  "NCHW <-> NHWC": ("nchwToNhwc", "nhwcToNchw")}


def device_profile(fn, label: str, card: str, top: int = 6) -> None:
    """One call of fn under torch.profiler, tracing the device only: the
    host-clock wall time, the device-busy time (the union of the device
    events' intervals, so work that overlaps counts once, beside their
    plain sum), the idle share 1 - busy / wall, the costliest kernels and
    the device ms of each KERNEL_CLASSES class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"{label} profile: torch.profiler recorded no device time; idle share not "
              f"measured")
        return
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy = (busy + hi - lo) / 1e3
    total = sum(end - start for start, end in spans) / 1e3
    rows = sorted((r for r in prof.key_averages() if r.device_type == DeviceType.CUDA),
                  key=lambda r: r.self_device_time_total, reverse=True)
    classes = {name: sum(r.self_device_time_total for r in rows
                         if any(k in r.key for k in keys)) / 1e3
               for name, keys in KERNEL_CLASSES.items()}
    print(f"{label} profile: wall {wall:.3f} ms, device busy {busy:.3f} ms (events' sum "
          f"{total:.3f} ms, {len(spans)} events), idle share {1 - busy / wall:.3f} on {card}; "
          "costliest kernels: " + "; ".join(
              f"{r.key[:70]} {r.self_device_time_total / 1e3:.3f} ms x{r.count}"
              for r in rows[:top]) + "; by class: " + ", ".join(
              f"{name} {ms:.3f} ms ({ms / busy:.3f} of busy)" for name, ms in classes.items()))


def path_a_breakdown(vc, wav48, s_src: int, s_tgt: int, label: str) -> None:
    """Device time of each part of one 10 s voice_conversion (CUDA events)."""
    from vcvits_tpu_torch.ops.stft_mel import spectrogram

    d, g_mod, dev = vc.cfg.data, vc.gen, vc.device
    unit_y = vc.unit * d.target_sampling_rate // d.source_sampling_rate
    padded = -(-len(wav48) // unit_y) * unit_y
    y = torch.zeros(1, padded, device=dev)
    y[0, :len(wav48)] = torch.as_tensor(wav48, device=dev)
    lens = torch.tensor([len(wav48) // d.hop_length], dtype=torch.int32, device=dev)
    parts = {}
    with torch.no_grad():
        g_src = g_mod.emb_g(torch.tensor([s_src], device=dev))
        g_tgt = g_mod.emb_g(torch.tensor([s_tgt], device=dev))
        spec = spectrogram(y, d.filter_length, d.hop_length, d.win_length)
        parts["spec (K3)"] = cuda_ms(lambda: spectrogram(y, d.filter_length, d.hop_length,
                                                         d.win_length), 2)
        spec = spec.to(g_mod.dtype)
        z, _, _, y_mask = g_mod.enc_q(spec, lens, g=g_src, fused_wn=True)
        parts["posterior (K2 wn_segment x4)"] = cuda_ms(
            lambda: g_mod.enc_q(spec, lens, g=g_src, fused_wn=True), 2)
        z_p = g_mod.flow.kernel_forward(z, y_mask, g=g_src)
        parts["flow forward (K2 x4)"] = cuda_ms(
            lambda: g_mod.flow.kernel_forward(z, y_mask, g=g_src), 2)
        z_hat = g_mod.flow.kernel_reverse(z_p, y_mask, g=g_tgt).to(z_p.dtype)
        parts["flow reverse (K2)"] = cuda_ms(
            lambda: g_mod.flow.kernel_reverse(z_p, y_mask, g=g_tgt), 2)
        parts["decoder (K1)"] = cuda_ms(
            lambda: g_mod.dec(z_hat * y_mask, g=g_tgt, fused_mrf=True), 2)
        # the module paths these replaced (training's), timed in the same call
        modules = {"posterior modules (K5 x16)": cuda_ms(
            lambda: g_mod.enc_q(spec, lens, g=g_src), 2),
            "flow forward modules (K5 x16)": cuda_ms(lambda: g_mod.flow(z, y_mask, g=g_src), 2)}
    print(f"path A breakdown {label} (device ms, one 10 s request): " + ", ".join(
        f"{k}={v:.3f}" for k, v in parts.items()) + f"; sum={sum(parts.values()):.3f}; "
        "module paths, not run by voice_conversion: " + ", ".join(
            f"{k}={v:.3f}" for k, v in modules.items()))


def path_a_phase(dev, _build, card: str):
    """Flow-swap conversion, VoiceConverter.voice_conversion, at full widths."""
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.utils.audio_io import read_wav

    cfg = load_config(CONFIG)
    hop = cfg.data.hop_length
    sd = perturbed_state(cfg)
    rng = np.random.default_rng(6)
    n = 23040  # 0.48 s at 48 kHz
    t = np.arange(n) / 48000
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(n)).astype(np.float32)
    eps = rng.standard_normal((1, n // hop, cfg.model.inter_channels)).astype(np.float32)
    outs = []
    for device in (dev, "cpu"):
        vc = VoiceConverter(cfg, sd, device=device)
        outs.append(vc.voice_conversion_array(wav, 7, 300, eps=eps))
        del vc
    gpu, cpu = outs
    diff = float(np.abs(gpu - cpu).max())
    level = float(np.abs(cpu).mean())
    print(f"path A reference (0.48 s, card kernels vs CPU plain path, fp32): samples={len(gpu)} "
          f"max_abs_err={diff:.3e} mean|y|={level:.3e}")
    if len(gpu) != len(cpu) or not diff <= SLICE_ATOL or not level > 1e-2:
        raise AssertionError(f"path A: card and CPU outputs differ by {diff:.3e} (limit "
                             f"{SLICE_ATOL}) at mean |y| {level:.3e}")

    m = cfg.model
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    # K2 in its three modes: the reverse and forward flows, the posterior's
    # 16 WaveNet layers 4 a launch; no standalone K5 (the gate is K2's epilogue)
    per_req = {"stft_mel": 1, "fused_gate": 0, "flow_coupling_reverse": 4,
               "flow_coupling_forward": 4, "wn_segment": 4,
               "mrf": len(m.upsample_rates) * launches_per_stage(m.resblock_dilation_sizes)}
    with tempfile.TemporaryDirectory() as tmp:
        srcs = write_sources(tmp, sr=48000)
        pairs = list(zip(SPEAKERS, SPEAKERS[1:] + SPEAKERS[:1]))
        counts = dict.fromkeys(per_req, 0)  # the requests' launches, not the timing runs'
        for dtype in (torch.float32, torch.bfloat16):
            vc = VoiceConverter(cfg, sd, dtype=dtype, device=dev)
            label = str(dtype)[6:]
            walls = []
            for i, (src, (s_src, s_tgt)) in enumerate(zip(srcs, pairs)):
                _build.LAUNCHES.clear()
                dst = os.path.join(tmp, f"vc{i}_{label}.wav")
                t0 = time.perf_counter()
                out = vc.voice_conversion(src, dst, s_src, s_tgt, rng_seed=i)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                true_len = len(read_wav(src)[0])
                if len(out) != (true_len // hop) * hop or not np.isfinite(out).all():
                    raise AssertionError(f"path A {dst}: {len(out)} samples (expected "
                                         f"{(true_len // hop) * hop}) or non-finite output")
                rose = {k: _build.LAUNCHES[k] for k in per_req}
                if rose != per_req:
                    raise AssertionError(f"path A {dst}: launches {rose}, expected {per_req}")
                for k, n in rose.items():
                    counts[k] += n
            secs = len(out) / 48000
            print(f"path A {label}: voice_conversion 3 x 10 s (src->tgt {pairs}), "
                  f"{np.mean(walls[1:]) * 1e3:.1f} ms per request incl. file read/write over "
                  f"requests 2-3 (first {walls[0] * 1e3:.1f}), "
                  f"rtf={secs / np.mean(walls[1:]):.2f}x real time on {card}")
            wav48 = read_wav(srcs[0])[0]
            vc.voice_conversion_array(wav48, *pairs[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                vc.voice_conversion_array(wav48, *pairs[0])
            torch.cuda.synchronize()
            per = (time.perf_counter() - t0) / 3
            print(f"path A {label}: voice_conversion_array (10 s array) {per * 1e3:.1f} ms per "
                  f"request, rtf={len(wav48) / 48000 / per:.2f}x real time on {card}")
            path_a_breakdown(vc, wav48, *pairs[0], label)
            device_profile(lambda: vc.voice_conversion_array(wav48, *pairs[0]),
                           f"path A {label} voice_conversion_array", card)
            del vc
    return counts


def batch_phase(rng, dev, _build):
    """K1 and K2 at the serving daemon's largest batch, 16 rows: K1 on the
    four decoder stages of 16 x 10 s ([16, 7440, 256] ... [16, 476160, 32])
    with fp32 and bf16 weights, K2's reverse (4 couplings with flips) on
    [16, 930, 128] with each row's own length drawn from 186-930; each
    against its plain version at MRF_TOL / FLOW_TOL, with its time, device
    time and bound at B = 16."""
    from vcvits_tpu_torch.ops.flow_coupling import coupling_reverse, coupling_reverse_plain
    from vcvits_tpu_torch.ops.mrf import launches_per_stage, mrf, mrf_plain

    b = SERVE_BATCH
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    n_w = 2 * sum(k * len(d) for k, d in zip(ks, ds))
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {}
    for wdt in (torch.float32, torch.bfloat16):
        label = str(wdt)[6:]
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
        for t, c in STAGE_SHAPES:
            x = torch.randn((b, t, c), generator=gen, device=dev).to(wdt)
            blocks = [tuple(
                torch.tensor(rng.standard_normal(s) * sc, dtype=torch.float32, device=dev)
                .to(wdt).contiguous()
                for s, sc in (((len(d), k, c, c), 1 / np.sqrt(k * c)), ((len(d), c), 0.1),
                              ((len(d), k, c, c), 1 / np.sqrt(k * c)), ((len(d), c), 0.1)))
                for k, d in zip(ks, ds)]
            got = mrf(x, blocks, ks, ds)
            ref = mrf_plain(x, blocks, ks, ds)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref, bf16=wdt == torch.bfloat16)
            del ref
            if not (rel <= MRF_TOL[wdt] and torch.isfinite(got.float()).all()):
                raise AssertionError(f"mrf B={b} C={c} T={t} {label}: max |err| {err:.3e}, "
                                     f"relative {rel:.3e} > {MRF_TOL[wdt]}")
            del got
            kernel = lambda: mrf(x, blocks, ks, ds)  # noqa: E731
            ms, launches = timed(kernel, _build, "mrf", reps=2)
            if launches != launches_per_stage(ds):
                raise AssertionError(f"mrf B={b}: {launches} launches a stage")
            device_ms = kernel_device_ms(kernel, "mrf_pair_kernel", reps=2)
            plain_ms = cuda_ms(lambda: mrf_plain(x, blocks, ks, ds), reps=1)
            b_ms, b_by, _, _ = mrf_bound_ms(t, c, n_w, wdt, b=b)
            print(f"mrf [{b},{t},{c}] {label}: kernel_ms={ms:.4f} device_ms={device_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) bound share "
                  f"{b_ms / ms:.4f} (device {b_ms / device_ms:.4f}) launches={launches:g} "
                  f"max_abs_err={err:.3e} rel={rel:.3e}")
            for key, v in (("ms", ms), ("device_ms", device_ms), ("plain_ms", plain_ms),
                           ("bound_ms", b_ms)):
                tot[key] += v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bound_by"] = b_by
            del x, blocks
            torch.cuda.empty_cache()
        print(f"mrf all 4 stages B={b} {label}: kernel_ms={tot['ms']:.4f} "
              f"device_ms={tot['device_ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
              f"bound_ms={tot['bound_ms']:.4f} ({tot['ms'] / b:.4f} kernel ms a row; B=1 "
              f"rows of the mrf phase above)")
        out[("mrf", wdt)] = tot
    t, c, h = FLOW_FRAMES, FLOW_CH, FLOW_HID
    couplings = [flow_weights(rng, dev, c // 2, h) for _ in range(N_FLOWS)]
    conds = [torch.tensor(rng.standard_normal((b, FLOW_LAYERS * 2 * h)) * 0.3,
                          dtype=torch.float32, device=dev) for _ in range(N_FLOWS)]
    lens = torch.tensor(rng.integers(FLOW_FRAMES // 5, FLOW_FRAMES + 1, b), device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()[..., None]
    x = torch.randn((b, t, c), generator=gen, device=dev)

    def chain(fn):
        y = x
        for w, cnd in zip(couplings, conds):
            y = fn(torch.flip(y, dims=[-1]).contiguous(), mask, cnd, w)
        return y

    got, ref = chain(coupling_reverse), chain(coupling_reverse_plain)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    if not (rel <= FLOW_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"flow_coupling_reverse B={b} ragged: max |err| {err:.3e} = "
                             f"{rel:.3e} x RMS > {FLOW_TOL}")
    ms, launches = timed(lambda: chain(coupling_reverse), _build, "flow_coupling_reverse")
    device_ms = kernel_device_ms(lambda: chain(coupling_reverse), "wn_stack_kernel")
    plain_ms = cuda_ms(lambda: chain(coupling_reverse_plain))
    b_ms, b_by, cores_ms, _ = flow_bounds("flow_coupling_reverse", b, t, c, h)
    print(f"flow_coupling_reverse [{b},{t},{c}] hidden {h}, row lengths "
          f"{int(lens.min())}-{int(lens.max())} x{N_FLOWS} launches fp32: kernel_ms={ms:.4f} "
          f"device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
          f"3xTF32; CUDA-core fp32 {cores_ms:.4f}) bound share {b_ms / ms:.4f} (device "
          f"{b_ms / device_ms:.4f}) launches={launches:g} max_abs_err={err:.3e} rel={rel:.3e}")
    out["flow_coupling_reverse"] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                                    "bound_ms": b_ms, "max_abs_err": err}
    return out


def serve_sources(cfg, rng, seconds):
    """Prepared sources for the daemon, one per entry of `seconds`: a
    harmonic tone with a known f0 contour and breath noise at 16 kHz,
    padded to the alignment unit, its pitch coarse_f0 of the known f0 (no
    pYIN); (wav, pitch, true_len, speaker)."""
    from vcvits_tpu_torch.data.collate import alignment_unit
    from vcvits_tpu_torch.dsp.pitch import coarse_f0

    sr, unit = cfg.data.source_sampling_rate, alignment_unit(cfg.data)
    out = []
    for i, secs in enumerate(seconds):
        n = int(secs * sr)
        t = np.arange(n) / sr
        f0 = 110.0 * (1 + rng.random()) * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wav = sum(0.25 / (k + 1) * np.sin((k + 1) * phase) for k in range(6))
        wav = wav + 0.01 * rng.standard_normal(n)
        padded = -(-n // unit) * unit
        frames = np.zeros(padded // 320)
        frames[: -(-n // 320)] = f0[::320]
        out.append((np.pad(wav, (0, padded - n)).astype(np.float32),
                    coarse_f0(frames, f0_bin=cfg.data.num_pitch), n, SPEAKERS[i % len(SPEAKERS)]))
    return out


def recording_daemon(vc, **kw):
    """A ServingDaemon that keeps every batch it gathers (`batches`), so the
    checks know which requests rode together."""
    from vcvits_tpu_torch.serving import ServingDaemon

    class Recording(ServingDaemon):
        def __init__(self, *args, **kwargs):
            self.batches = []
            super().__init__(*args, **kwargs)

        def _gather(self):
            batch = super()._gather()
            if batch is not None:
                self.batches.append(batch)
            return batch

    return Recording(vc, **kw)


def close_to(got: np.ndarray, want: np.ndarray, bf16: bool):
    """(max |err|, within the phase's bound): fp32 max |err| <= SLICE_ATOL;
    bf16 (where rounding lands differently in a batch's and a row's GEMMs
    and spreads through the net) error RMS <= 2e-2 x RMS."""
    d = got - want
    err = float(np.abs(d).max()) if len(d) else 0.0
    if not bf16:
        return err, err <= SLICE_ATOL
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    return err, float(np.sqrt(np.mean(d.astype(np.float64) ** 2))) <= MRF_TOL[torch.bfloat16] * rms


def serve_phase(dev, _build, card: str, sd):
    """The serving daemon at full widths, fp32 then bf16: 16 client threads
    x 2 requests of 2-10 s, then 16 equal 10 s requests as one batch
    (profiled), the wire formats and a lone request with noise."""
    import collections
    import threading

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    from vcvits_tpu_torch.serving import ServingDaemon

    cfg = load_config(CONFIG)
    m = cfg.model
    per_batch = {"flow_coupling_reverse": 4,
                 "mrf": len(m.upsample_rates) * launches_per_stage(m.resblock_dilation_sizes)}
    hop = cfg.data.hop_length
    counts = dict.fromkeys(per_batch, 0)
    for dtype in (torch.float32, torch.bfloat16):
        label, bf16 = str(dtype)[6:], dtype == torch.bfloat16
        vc = VoiceConverter(cfg, sd, dtype=dtype, device=dev)
        rng = np.random.default_rng(0)
        reqs = serve_sources(cfg, rng, rng.uniform(2.0, 10.0, SERVE_CLIENTS * SERVE_PER_CLIENT))
        vc.convert_array(*reqs[0][:2], reqs[0][3], reqs[0][2], noise_scale=0.0)  # warm-up
        with recording_daemon(vc, max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS) as daemon:
            results, errors = [None] * len(reqs), []

            def client(i):
                try:
                    for j in range(i * SERVE_PER_CLIENT, (i + 1) * SERVE_PER_CLIENT):
                        w, p, n, sid = reqs[j]
                        results[j] = daemon.submit(w, p, n, sid, noise_scale=0.0).result(
                            timeout=600)
                except Exception as e:  # noqa: BLE001 - raised below, in this thread
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            wall = time.perf_counter() - t0
            rose = {k: _build.LAUNCHES[k] for k in per_batch}
            if errors or any(th.is_alive() for th in threads):
                raise AssertionError(f"serve {label}: client errors {errors[:3]}")
            stats, batches = daemon.stats(), list(daemon.batches)
        expect = {k: v * len(batches) for k, v in per_batch.items()}
        if rose != expect:
            raise AssertionError(f"serve {label}: launches {rose} for {len(batches)} batches, "
                                 f"expected {expect}")
        for k, v in rose.items():
            counts[k] += v
        audio_s = sum(r[2] for r in reqs) / cfg.data.source_sampling_rate
        hist = dict(sorted(collections.Counter(len(bt) for bt in batches).items()))
        print(f"serve {label}: {len(reqs)} requests of 2-10 s from {SERVE_CLIENTS} client "
              f"threads ({SERVE_PER_CLIENT} each, closed loop), max_batch {SERVE_BATCH}, window "
              f"{SERVE_WINDOW_MS} ms: wall {wall:.3f} s, {len(reqs) / wall:.2f} requests/s, "
              f"{audio_s / wall:.2f} s of audio per s; latency p50 {stats['latency_p50_ms']} ms, "
              f"p95 {stats['latency_p95_ms']} ms, max {stats['latency_max_ms']} ms; mean batch "
              f"{stats['mean_batch']}, batch sizes {hist}; launches {rose} on {card}")
        # held: every length, and in each batch the rows as long as the batch
        index = {id(r[0]): i for i, r in enumerate(reqs)}
        solo = [vc.convert_array(w, p, sid, n, noise_scale=0.0) for w, p, n, sid in reqs]
        worst = 0.0
        for i, (out, want) in enumerate(zip(results, solo)):
            if out.shape != want.shape or not np.isfinite(out).all():
                raise AssertionError(f"serve {label} request {i}: {out.shape} samples, solo "
                                     f"{want.shape}, or non-finite")
        for bt in batches:
            pad_len = max(len(r.wav16k) for r in bt)
            for r in bt:
                i = index[id(r.wav16k)]
                if len(r.wav16k) == pad_len:
                    err, ok = close_to(results[i], solo[i], bf16)
                    worst = max(worst, err)
                    if not ok:
                        raise AssertionError(f"serve {label}: longest row {i} of a batch of "
                                             f"{len(bt)} is {err:.3e} from its solo run")
        print(f"serve {label}: every output as long as its solo convert_array; the longest "
              f"rows of the {len(batches)} batches within max |err| {worst:.3e} of solo")
        # 16 equal 10 s requests in one batch, profiled
        eq = serve_sources(cfg, rng, [10.0] * SERVE_BATCH)
        solo = [vc.convert_array(w, p, sid, n, noise_scale=0.0) for w, p, n, sid in eq]
        with recording_daemon(vc, max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS) as daemon:
            outs = []

            def one_batch():
                futs = [daemon.submit(w, p, n, sid, noise_scale=0.0) for w, p, n, sid in eq]
                outs[:] = [f.result(timeout=600) for f in futs]

            one_batch()  # warm-up at this shape
            device_profile(one_batch, f"serve {label} one batch of {SERVE_BATCH} x 10 s", card)
            sizes = [len(bt) for bt in daemon.batches]
            t0 = time.perf_counter()
            one_batch()
            batch_wall = time.perf_counter() - t0
        if sizes != [SERVE_BATCH, SERVE_BATCH]:
            raise AssertionError(f"serve {label}: 16 requests at once made batches {sizes}")
        worst = 0.0
        for i, (out, want) in enumerate(zip(outs, solo)):
            err, ok = close_to(out, want, bf16)
            worst = max(worst, err)
            if out.shape != want.shape or not ok:
                raise AssertionError(f"serve {label}: row {i} of a batch of 16 equal requests "
                                     f"is {err:.3e} from its solo run")
        print(f"serve {label}: a batch of {SERVE_BATCH} x 10 s in {batch_wall * 1e3:.1f} ms "
              f"wall ({SERVE_BATCH * 10 / batch_wall:.1f}x real time), every row within max "
              f"|err| {worst:.3e} of its solo convert_array")
        # a lone request at noise 1 equals convert_array with its seed
        w, p, n, sid = eq[1]
        with ServingDaemon(vc, max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS) as daemon:
            lone = daemon.submit(w, p, n, sid, noise_scale=1.0, rng_seed=11).result(timeout=600)
        want = vc.convert_array(w, p, sid, n, noise_scale=1.0, rng_seed=11)
        other = vc.convert_array(w, p, sid, n, noise_scale=1.0, rng_seed=12)
        err = float(np.abs(lone - want).max())
        apart = float(np.abs(other - want).max())
        if lone.shape != want.shape or err > 1e-6 or apart <= SLICE_ATOL:
            raise AssertionError(f"serve {label}: a lone request at noise 1 is {err:.3e} from "
                                 f"convert_array with its seed (another seed {apart:.3e})")
        print(f"serve {label}: a lone request at noise_scale 1, seed 11, max |err| {err:.3e} "
              f"from convert_array with that seed (seed 12 is {apart:.3e} away)")
        if not bf16:
            wire_formats(vc, eq[0], label)
        del vc
        torch.cuda.empty_cache()
    return counts


def wire_formats(vc, req, label: str) -> None:
    """One 10 s request per wire format against the f32 wire: f16 and i16
    within 2e-3, mu-law within 0.0225 |x| + 3e-3 (the JAX package's
    bounds)."""
    from vcvits_tpu_torch.serving import ServingDaemon

    w, p, n, sid = req
    outs = {}
    for fmt in ("f32", "f16", "i16", "mulaw"):
        with ServingDaemon(vc, max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS,
                           transfer=fmt) as daemon:
            outs[fmt] = daemon.submit(w, p, n, sid, noise_scale=0.0).result(timeout=600)
    ref = outs["f32"]
    notes = []
    for fmt in ("f16", "i16", "mulaw"):
        err = np.abs(outs[fmt] - ref)
        bound = 0.0225 * np.abs(ref) + 3e-3 if fmt == "mulaw" else 2e-3
        if outs[fmt].shape != ref.shape or not np.all(err <= bound):
            raise AssertionError(f"serve {label} wire {fmt}: max excess over its bound "
                                 f"{float(np.max(err - bound)):.3e}")
        notes.append(f"{fmt} max |err| {float(err.max()):.3e}")
    print(f"serve {label} wire formats against f32 (10 s, mean |y| "
          f"{float(np.abs(ref).mean()):.3e}): " + ", ".join(notes))


def streaming_phase(dev, _build, card: str, sd):
    """StreamingConverter at full widths, fp32 and bf16: a 10 s source pushed
    in 0.1 s pieces through the windowed and the incremental modes (chunk
    2 s, context 0.16 s); then StreamingFlowDecoder's streamed output on the
    same z_p against the offline flow reverse (K2) + decoder (K1)."""
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    from vcvits_tpu_torch.streaming import StreamingConverter

    cfg = load_config(CONFIG)
    d, m = cfg.data, cfg.model
    sr = d.source_sampling_rate
    per_window = {"flow_coupling_reverse": 4,
                  "mrf": len(m.upsample_rates) * launches_per_stage(m.resblock_dilation_sizes)}
    counts = dict.fromkeys(per_window, 0)
    wav, pitch, n, sid = serve_sources(cfg, np.random.default_rng(3), [10.0])[0]
    src = wav[:n]
    piece = int(STREAM_PIECE_S * sr)
    for dtype in (torch.float32, torch.bfloat16):
        label, bf16 = str(dtype)[6:], dtype == torch.bfloat16
        vc = VoiceConverter(cfg, sd, dtype=dtype, device=dev)
        for incremental in (False, True):
            mode = "incremental" if incremental else "windowed"
            t0 = time.perf_counter()
            sc = StreamingConverter(vc, speaker_id=sid, chunk_seconds=STREAM_CHUNK_S,
                                    context_seconds=0.16, noise_scale=0.0,
                                    incremental=incremental)
            setup_ms = (time.perf_counter() - t0) * 1e3
            list(sc.convert_stream([src[:sc.chunk + sc.ctx]]))  # warm-up, then a fresh stream
            sc.reset()
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            chunk_ms, outs, first = [], [], None
            for start in range(0, n, piece):
                t0 = time.perf_counter()
                got = list(sc.push(src[start:start + piece]))
                dt = (time.perf_counter() - t0) * 1e3
                if got:
                    chunk_ms.append(dt)
                    if first is None:
                        first = (min(start + piece, n) / sr, dt)
                outs += got
            t0 = time.perf_counter()
            outs += list(sc.flush())
            flush_ms = (time.perf_counter() - t0) * 1e3
            rose = {k: _build.LAUNCHES[k] for k in per_window}
            out = np.concatenate(outs)
            windows = -(-n // sc.chunk)  # a window per chunk, the last in flush
            if incremental:
                expect_len = (n * d.target_sampling_rate // (sr * d.hop_length)) * d.hop_length
                ok_len = len(out) == expect_len
                expect_launch = dict.fromkeys(per_window, 0)  # plain convs, no kernel
            else:
                expect_len = 3 * n
                ok_len = abs(len(out) - expect_len) <= sc.xfade + 3
                expect_launch = {k: v * windows for k, v in per_window.items()}
            if not ok_len or not np.isfinite(out).all() or rose != expect_launch:
                raise AssertionError(f"stream {label} {mode}: {len(out)} samples (expected "
                                     f"{expect_len}), launches {rose} (expected {expect_launch})")
            if not incremental:
                for k, v in rose.items():
                    counts[k] += v
            print(f"stream {label} {mode}: 10 s pushed in {STREAM_PIECE_S} s pieces, chunk "
                  f"{sc.chunk / sr:.2f} s + context {sc.ctx / sr:.2f} s: compute per chunk p50 "
                  f"{np.median(chunk_ms):.1f} ms, max {max(chunk_ms):.1f} ms against "
                  f"{sc.chunk / sr * 1e3:.0f} ms of audio ({len(chunk_ms)} chunks, flush "
                  f"{flush_ms:.1f} ms); first output after {first[0]:.2f} s of audio + "
                  f"{first[1]:.1f} ms; {len(out)} samples (contract {expect_len}); set-up "
                  f"{setup_ms:.1f} ms; launches {rose} on {card}")
        streamed_vs_offline(vc, cfg, sid, wav, n, pitch, bf16, label)
        del vc, sc
        torch.cuda.empty_cache()
    return counts


def streamed_vs_offline(vc, cfg, speaker, wav, n, pitch, bf16, label):
    """StreamingFlowDecoder (plain convs, chunk 2 s) against the offline flow
    reverse (K2) + decoder (K1) on the same z_p: the prior mean of a 10 s
    source, its first 5 chunks (900 frames)."""
    from vcvits_tpu_torch.data.collate import alignment_unit
    from vcvits_tpu_torch.streaming_conv import StreamingFlowDecoder

    gen, dev, d = vc.gen, vc.device, cfg.data
    unit = alignment_unit(d)
    chunk = max(unit, int(round(STREAM_CHUNK_S * d.source_sampling_rate / unit)) * unit)
    f = chunk * d.target_sampling_rate // (d.source_sampling_rate * d.hop_length)
    with torch.no_grad():
        _, _, (_, z_p, _, _) = gen.infer(
            torch.as_tensor(wav, device=dev)[None], torch.tensor([n], device=dev),
            torch.as_tensor(pitch, device=dev)[None], torch.tensor([speaker], device=dev),
            noise_scale=0.0)
    frames = f * 5  # 5 chunks of the 2 s stream
    z_p = z_p[:, :frames].contiguous()
    sid = torch.tensor([speaker], device=dev)
    with torch.no_grad():
        g = gen.emb_g(sid)
        mask = torch.ones((1, frames, 1), dtype=z_p.dtype, device=dev)
        z = gen.flow.kernel_reverse(z_p, mask, g=g).to(z_p.dtype) * mask
        ref = gen.dec(z, g=g, fused_mrf=True)[0, :, 0].float().cpu().numpy()
    t0 = time.perf_counter()
    sfd = StreamingFlowDecoder(cfg.model, f, dtype=gen.dtype).bind(gen)
    bind_ms = (time.perf_counter() - t0) * 1e3
    state, pieces, step_ms = sfd.init_state(), [], []
    gv = gen.emb_g.weight.detach()[sid]
    for i in range(frames // f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, state = sfd.step(state, z_p[:, i * f:(i + 1) * f],
                            gv)
        pieces.append(y[0, :, 0].float().cpu().numpy())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    zeros = torch.zeros_like(z_p[:, :f])
    for _ in range(sfd.flush_chunks()):
        y, state = sfd.step(state, zeros, gv, total_frames=frames)
        pieces.append(y[0, :, 0].float().cpu().numpy())
    got = np.concatenate(pieces)[sfd.delay_samples:][:len(ref)]
    err, ok = close_to(got, ref, bf16)
    if len(got) != len(ref) or not ok or not np.isfinite(got).all():
        raise AssertionError(f"stream {label}: StreamingFlowDecoder is {err:.3e} from the "
                             f"offline flow + decoder (limit {SLICE_ATOL if not bf16 else 'bf16'})")
    state_mb = sum(v.numel() * v.element_size() for k, v in state.items() if k != "__n") / 1e6
    print(f"stream {label}: StreamingFlowDecoder on {frames} frames of z_p (chunks of "
          f"{f}) against the offline flow reverse (K2) + decoder (K1): max "
          f"|err| {err:.3e}, mean |y| {float(np.abs(ref).mean()):.3e}; delay "
          f"{sfd.delay_samples} samples, state {state_mb:.2f} MB, bind {bind_ms:.1f} ms, step "
          f"p50 {np.median(step_ms):.1f} ms")


def http_phase(dev, _build, card: str, sd):
    """serve_http on 127.0.0.1 (an ephemeral port) in a thread, fp32: POST
    /convert of a 10 s WAV, POST /stream (chunked, f32 and i16, windowed and
    incremental, a second connection on the pooled session), GET /stats,
    400 on another input rate, and 503 from a server with no stream
    sessions."""
    import http.client
    import threading
    import urllib.request

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.serving import ServingDaemon, serve_http
    from vcvits_tpu_torch.streaming import StreamingConverter
    from vcvits_tpu_torch.utils.audio_io import read_wav, write_wav

    cfg = load_config(CONFIG)
    sr = cfg.data.source_sampling_rate
    vc = VoiceConverter(cfg, sd, device=dev)
    rng = np.random.default_rng(4)
    wav10, _, n10, _ = serve_sources(cfg, rng, [10.0])[0]
    wav4, _, n4, _ = serve_sources(cfg, rng, [4.0])[0]
    src4 = wav4[:n4]

    def stream_once(port, path, payload: bytes, piece=6400):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.putrequest("POST", path)
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            for i in range(0, len(payload), piece):
                p = payload[i:i + piece]
                conn.send(f"{len(p):x}\r\n".encode() + p + b"\r\n")
            conn.send(b"0\r\n\r\n")
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def serve(daemon, sessions):
        server = serve_http(daemon, host="127.0.0.1", port=0, max_stream_sessions=sessions)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread

    def stop(server, thread):
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    notes = []
    q = "sid=3&chunk_seconds=2.0&context_seconds=0.16&noise_scale=0"
    with tempfile.TemporaryDirectory() as tmp, \
            ServingDaemon(vc, max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS) as daemon:
        path = os.path.join(tmp, "in.wav")
        write_wav(path, wav10[:n10], sr, subtype="FLOAT")
        wav, true_len, pitch = vc.prepare_source(path)
        want = daemon.submit(wav, pitch, true_len, 3, noise_scale=0.0).result(timeout=600)
        server, thread = serve(daemon, 1)
        port = server.server_address[1]
        try:
            t0 = time.perf_counter()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/convert?sid=3&noise_scale=0",
                                         data=open(path, "rb").read(), method="POST")
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, body = resp.status, resp.read()
            convert_ms = (time.perf_counter() - t0) * 1e3
            out_path = os.path.join(tmp, "out.wav")
            with open(out_path, "wb") as f:
                f.write(body)
            out, out_sr = read_wav(out_path)
            err = float(np.abs(out - want).max())
            if status != 200 or out_sr != 48000 or out.shape != want.shape or err > 1e-5:
                raise AssertionError(f"http /convert: status {status}, {out.shape} samples at "
                                     f"{out_sr} Hz, {err:.3e} from the daemon's output")
            notes.append(f"/convert 10 s {convert_ms:.1f} ms (host DSP included), max |err| "
                         f"{err:.3e} from the daemon")
            f32 = src4.astype("<f4").tobytes()
            for incremental in (0, 1):
                direct = StreamingConverter(vc, speaker_id=3, chunk_seconds=2.0,
                                            context_seconds=0.16, noise_scale=0.0,
                                            incremental=bool(incremental))
                ref = np.concatenate(list(direct.convert_stream([src4])))
                mode = "incremental" if incremental else "windowed"
                stream_path = f"/stream?{q}&incremental={incremental}&format=f32"
                for attempt in ("", ", pooled session again"):
                    t0 = time.perf_counter()
                    status, body = stream_once(port, stream_path, f32)
                    ms = (time.perf_counter() - t0) * 1e3
                    got = np.frombuffer(body, dtype="<f4")
                    err = float(np.abs(got - ref).max()) if got.shape == ref.shape else np.inf
                    if status != 200 or err > 1e-4:
                        raise AssertionError(f"http /stream {mode} f32{attempt}: status {status},"
                                             f" {got.shape} vs {ref.shape}, max |err| {err:.3e}")
                    notes.append(f"/stream {mode} f32{attempt} 4 s in {ms:.1f} ms, max |err| "
                                 f"{err:.3e} from a direct StreamingConverter")
                i16 = (np.clip(src4, -1, 1) * 32767).astype("<i2").tobytes()
                status, body = stream_once(port, f"/stream?{q}&incremental={incremental}", i16)
                got = np.frombuffer(body, dtype="<i2").astype(np.float32) / 32767
                err = float(np.abs(got - ref).max()) if got.shape == ref.shape else np.inf
                if status != 200 or err > 2e-2:  # PCM-16 in and out (the JAX package's bound)
                    raise AssertionError(f"http /stream {mode} i16: status {status}, max |err| "
                                         f"{err:.3e}")
                notes.append(f"/stream {mode} i16 max |err| {err:.3e}")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as resp:
                stats = json.loads(resp.read())
            status, _ = stream_once(port, f"/stream?{q}&rate=8000", b"")
            if stats.get("requests", 0) < 2 or status != 400:
                raise AssertionError(f"http: /stats {stats}, rate=8000 gave {status}")
            notes.append(f"/stats {stats}; rate=8000 -> {status}")
        finally:
            stop(server, thread)
        server, thread = serve(daemon, 0)
        try:
            status, _ = stream_once(server.server_address[1], f"/stream?{q}", b"")
        finally:
            stop(server, thread)
        if status != 503:
            raise AssertionError(f"http: max_stream_sessions=0 gave {status}, not 503")
        notes.append(f"max_stream_sessions=0 -> {status}")
    print("http (127.0.0.1, fp32): " + "; ".join(notes) + f" on {card}")
    del vc
    torch.cuda.empty_cache()


def train_batch(cfg, b, lo_s, hi_s, rng, dev):
    """Paired synthetic clips: a harmonic tone with a known f0 contour and
    breath noise at 48 kHz (target) and 16 kHz (source), padded to the
    longest; x_pitch is coarse_f0 of the known f0 (no pYIN)."""
    from vcvits_tpu_torch.dsp.pitch import coarse_f0

    d = cfg.data
    lens16 = (rng.uniform(lo_s, hi_s, b) * d.source_sampling_rate).astype(int) // 320 * 320
    t16 = int(lens16.max())
    x = np.zeros((b, t16), np.float32)
    y = np.zeros((b, t16 * 3), np.float32)
    pitch = np.ones((b, t16 // 320), np.int64)
    for i, n16 in enumerate(lens16):
        f0_base = rng.uniform(100, 300)
        for sr, out in ((d.source_sampling_rate, x), (d.target_sampling_rate, y)):
            n = n16 * sr // d.source_sampling_rate
            tt = np.arange(n) / sr
            f0 = f0_base * (1 + 0.1 * np.sin(2 * np.pi * 0.8 * tt))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            wav = sum(0.25 / (k + 1) * np.sin((k + 1) * phase) for k in range(6))
            out[i, :n] = wav + 0.01 * rng.standard_normal(n)
        frames = np.arange(n16 // 320) * 320 / d.source_sampling_rate
        pitch[i, :n16 // 320] = coarse_f0(f0_base * (1 + 0.1 * np.sin(2 * np.pi * 0.8 * frames)),
                                          f0_bin=d.num_pitch)
    as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return {"x_wav": as_t(x), "x_wav_lengths": as_t(lens16, torch.int32),
            "x_pitch": as_t(pitch), "y_wav": as_t(y), "y_wav_lengths": as_t(lens16 * 3, torch.int32),
            "sid": as_t(rng.integers(0, d.n_speakers, b), torch.int64)}


def train_steps(cfg, g_state, batch, dev, _build, card: str, dtype,
                n_steps: int = N_TRAIN_STEPS, path: str = "path B") -> tuple:
    """`n_steps` steps of TrainStep in `dtype` on `batch`, counted ->
    (launch counts, ms/step over steps 2-N, peak GiB)."""
    from vcvits_tpu_torch.train.state import is_frozen
    from vcvits_tpu_torch.train.step import TrainStep

    label = str(dtype)[6:]
    step = TrainStep(cfg, device=dev, g_state=g_state, dtype=dtype)
    named = {f"gen.{n}": p for n, p in step.gen.named_parameters()}
    named.update({f"disc.{n}": p for n, p in step.disc.named_parameters()})
    before = {n: p.detach().clone() for n, p in named.items()}
    per_step = {"stft_mel": 1, "fused_gate": 2 * 2 * 16, "fused_gate_backward": 2 * 16}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    walls, last = [], None
    for i in range(n_steps):
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise AssertionError(f"{path} {label} step {i + 1}: non-finite {bad}")
        if i == 0:
            frozen = [n for n in named if is_frozen(n)]
            moved = [n for n in frozen if not torch.equal(named[n], before[n])]
            still = [n for n in named if n not in frozen and torch.equal(named[n], before[n])]
            if moved or still or not frozen:
                raise AssertionError(f"{path} {label} step 1: HuBERT moved {moved[:5]}, "
                                     f"trainable unchanged {still[:5]} ({len(still)})")
            print(f"{path} {label} step 1: {len(named) - len(frozen)} trainable tensors all "
                  f"changed, {len(frozen)} HuBERT tensors unchanged")
            del before
        last = metrics
    counts = dict(_build.LAUNCHES)
    for k, n in per_step.items():
        if counts.get(k, 0) != n * n_steps:
            raise AssertionError(f"{path} {label}: {k} launched {counts.get(k, 0)} times in "
                                 f"{n_steps} steps, expected {n * n_steps}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = np.mean(walls[1:]) * 1e3
    print(f"{path} {label}: {n_steps} steps at B={cfg.train.batch_size}, 2-4 s clips padded "
          f"to {batch['y_wav'].shape[1] / 48000:.2f} s, segment {cfg.train.segment_size}: "
          f"{ms:.1f} ms/step over steps 2-{n_steps} (step 1 {walls[0] * 1e3:.1f} ms), "
          f"peak memory {peak:.2f} GiB on {card}; launches per step "
          f"{ {k: counts.get(k, 0) / n_steps for k in per_step} }")
    print(f"{path} {label} step {n_steps} metrics: " + ", ".join(
        f"{k}={float(v):.5g}" for k, v in last.items() if not k.startswith("loss/d_")))
    parts = {}
    for _ in range(2):  # after the counted run: device ms per section of a step
        step(batch, timings=parts)
    print(f"{path} {label} breakdown (device ms per step, mean of 2 steps): " + ", ".join(
        f"{k}={v / 2:.3f}" for k, v in parts.items()) + f"; sum={sum(parts.values()) / 2:.3f}")
    device_profile(lambda: step(batch), f"{path} {label} train step", card)
    del step
    torch.cuda.empty_cache()
    return {k: counts.get(k, 0) for k in per_step}, ms, peak


def path_b_phase(dev, _build, card: str):
    """The GAN train step at full widths: 5 steps at the config's batch in
    float32 and in bf16, then a B=2 step on the card against the CPU in
    each."""
    from vcvits_tpu_torch.config import Config, load_config
    from vcvits_tpu_torch.train.step import StepDraws, TrainStep

    cfg = load_config(CONFIG)
    rng = np.random.default_rng(8)
    batch = train_batch(cfg, cfg.train.batch_size, 2.0, 4.0, rng, dev)
    # perturbed: with the flow's zero `post` every flow parameter but `post`
    # would get a zero gradient in step 1, as in JAX
    g_state = perturbed_state(cfg)
    counts, runs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        c, ms, peak = train_steps(cfg, g_state, batch, dev, _build, card, dtype)
        runs[str(dtype)[6:]] = {"ms_per_step": ms, "peak_gib": peak}
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    del batch
    print(f"path B: float32 {runs['float32']['ms_per_step']:.1f} ms/step, "
          f"{runs['float32']['peak_gib']:.2f} GiB; bfloat16 "
          f"{runs['bfloat16']['ms_per_step']:.1f} ms/step, {runs['bfloat16']['peak_gib']:.2f} "
          f"GiB; bf16 / fp32 time {runs['bfloat16']['ms_per_step'] / runs['float32']['ms_per_step']:.3f} "
          f"on {card}")

    # one step on the card and on the CPU: same weights, batch and draws
    raw = cfg.to_dict()
    raw["model"]["p_dropout"] = 0.0
    cfg0 = Config.from_dict(raw)
    small = train_batch(cfg0, 2, 1.0, 1.0, rng, "cpu")
    t_spec = small["y_wav"].shape[1] // cfg0.data.hop_length
    seg = cfg0.train.segment_size // cfg0.data.hop_length
    draws = StepDraws(*(torch.as_tensor(a) for a in (
        rng.standard_normal((2, t_spec, cfg0.model.inter_channels)).astype(np.float32),
        rng.integers(0, t_spec - seg + 1, 2),
        rng.standard_normal((2, t_spec, cfg0.model.inter_channels)).astype(np.float32),
        rng.integers(0, t_spec - seg + 1, 2))))
    on = lambda d, dev_: {k: v.to(dev_) for k, v in d.items()}  # noqa: E731
    cpu_ref = {}
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype)[6:]
        cpu_step = TrainStep(cfg0, device="cpu", g_state=g_state, dtype=dtype)
        card_step = TrainStep(cfg0, device=dev, g_state=cpu_step.gen.state_dict(),
                              d_state=cpu_step.disc.state_dict(), dtype=dtype)
        got = card_step(on(small, dev), StepDraws(*(v.to(dev) for v in vars(draws).values())))
        ref = cpu_step(small, draws)
        cpu_ref[dtype] = ref
        del cpu_step, card_step
        torch.cuda.empty_cache()
        keys = ([k for k in ref if k.startswith("loss/") or k.startswith("grad_norm")]
                if dtype == torch.float32 else list(BF16_KEYS))
        tol = TRAIN_RTOL if dtype == torch.float32 else TRAIN_RTOL_BF16
        rel = {k: abs(float(got[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-6) for k in keys}
        worst = max(rel, key=rel.get)
        extra = ""
        if dtype == torch.bfloat16:
            r32 = cpu_ref[torch.float32]
            ratio = {k: abs(float(got[k]) - float(ref[k]))
                     / max(abs(float(ref[k]) - float(r32[k])), 1e-12) for k in keys}
            wr = max(ratio, key=ratio.get)
            extra = (f"; card-vs-CPU over the CPU's own bf16-vs-fp32 distance: largest "
                     f"{ratio[wr]:.3f} ({wr}), " + ", ".join(f"{k} {v:.3f}"
                                                              for k, v in ratio.items()))
        print(f"path B reference {label} (B=2 x 1 s, dropout off, injected draws, card kernels vs "
              f"CPU plain path): {len(keys)} losses and grad norms, worst rel diff "
              f"{rel[worst]:.3e} ({worst}, limit {tol}); grad_norm_g "
              f"{float(got['grad_norm_g']):.6g} vs {float(ref['grad_norm_g']):.6g}, grad_norm_d "
              f"{float(got['grad_norm_d']):.6g} vs {float(ref['grad_norm_d']):.6g}{extra}")
        if not rel[worst] <= tol:
            raise AssertionError(f"path B {label}: {worst} differs by {rel[worst]:.3e} > {tol} "
                                 f"between the card and the CPU")
    return counts, runs


def accumulation_phase(dev, _build, card: str):
    """accumulate_grad_batches 2 in bf16 at B=8: the parameters move only on
    every second mini-step, and AdamW counts the updates."""
    from vcvits_tpu_torch.config import Config, load_config
    from vcvits_tpu_torch.train.state import is_frozen
    from vcvits_tpu_torch.train.step import TrainStep

    raw = load_config(CONFIG).to_dict()
    raw["trainer"]["accumulate_grad_batches"] = ACC_K
    cfg = Config.from_dict(raw)
    dtype = torch.bfloat16 if cfg.train.fp16_run else torch.float32
    batch = train_batch(cfg, ACC_BATCH, 2.0, 4.0, np.random.default_rng(9), dev)
    step = TrainStep(cfg, device=dev, g_state=perturbed_state(cfg), dtype=dtype)
    named = {f"gen.{n}": p for n, p in step.gen.named_parameters()}
    named.update({f"disc.{n}": p for n, p in step.disc.named_parameters()})
    per_step = {"stft_mel": 1, "fused_gate": 2 * 2 * 16, "fused_gate_backward": 2 * 16}
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    walls = []
    for i in range(1, ACC_MINI_STEPS + 1):
        before = {n: p.detach().clone() for n, p in named.items()}
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not all(torch.isfinite(v).all() for v in metrics.values()):
            raise AssertionError(f"accumulation mini-step {i}: non-finite metrics")
        moved = [n for n in named if not torch.equal(named[n], before[n])]
        frozen_moved = [n for n in moved if is_frozen(n)]
        n_trainable = sum(not is_frozen(n) for n in named)
        if i % ACC_K:
            if moved:
                raise AssertionError(f"accumulation mini-step {i}: {len(moved)} tensors moved "
                                     f"without an update ({moved[:3]})")
        elif frozen_moved or len(moved) < 0.9 * n_trainable:
            raise AssertionError(f"accumulation mini-step {i}: {len(moved)} of {n_trainable} "
                                 f"trainable tensors moved, HuBERT {frozen_moved[:3]}")
        del before
    counts = dict(_build.LAUNCHES)
    for k, n in per_step.items():
        if counts.get(k, 0) != n * ACC_MINI_STEPS:
            raise AssertionError(f"accumulation: {k} launched {counts.get(k, 0)} times in "
                                 f"{ACC_MINI_STEPS} mini-steps, expected {n * ACC_MINI_STEPS}")
    adam = {float(s["step"]) for s in step.g_opt.state.values()} | \
        {float(s["step"]) for s in step.d_opt.state.values()}
    n_up = ACC_MINI_STEPS // ACC_K
    if adam != {float(n_up)} or step.updates != n_up or step.mini_step:
        raise AssertionError(f"accumulation: AdamW steps {adam}, expected {{{n_up}}}; updates "
                             f"{step.updates}, mini-step {step.mini_step}")
    # mini-step 1 pays the first call at B=8 (cuDNN's choices): timed from 2
    no_update = np.mean([w for i, w in enumerate(walls, 1) if i > 1 and i % ACC_K]) * 1e3
    with_update = np.mean([w for i, w in enumerate(walls, 1) if not i % ACC_K]) * 1e3
    print(f"accumulation: k={ACC_K}, B={ACC_BATCH}, {str(dtype)[6:]}, {ACC_MINI_STEPS} "
          f"mini-steps: parameters bit-equal after mini-steps 1 and 3, moved after 2 and 4 "
          f"(HuBERT never); AdamW step {sorted(adam)} after mini-step {ACC_MINI_STEPS}; "
          f"{np.mean(walls[1:]) * 1e3:.1f} ms per mini-step over mini-steps 2-{ACC_MINI_STEPS} "
          f"({no_update:.1f} without the update, {with_update:.1f} with it; mini-step 1 "
          f"{walls[0] * 1e3:.1f}) on {card}; launches per mini-step "
          f"{ {k: counts.get(k, 0) / ACC_MINI_STEPS for k in per_step} }")
    del step, batch
    torch.cuda.empty_cache()
    return {k: counts.get(k, 0) for k in per_step}


def write_corpus(tmp: str, n_train: int = 40, n_val: int = 8, n_speakers: int = 4):
    """Synthetic 2-4 s clips at 48 kHz for the trainer: a harmonic tone on a
    known f0 contour (a speaker's base f0, a slow glide and vibrato) with
    breath noise; the train and validation filelists."""
    from vcvits_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(21)
    sr = 48000
    lists = {}
    for split, n in (("train", n_train), ("valid", n_val)):
        lines = []
        for i in range(n):
            sid = i % n_speakers
            t = np.arange(int(rng.uniform(2.05, 4.0) * sr)) / sr
            f0 = (110.0 + 45.0 * sid) * (1 + 0.15 * t / t[-1]) * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            wav = sum(0.25 / (h + 1) * np.sin((h + 1) * phase) for h in range(6))
            wav = wav * (0.7 + 0.3 * np.sin(2 * np.pi * 0.5 * t)) + 0.01 * rng.standard_normal(len(t))
            path = os.path.join(tmp, f"{split}{i}.wav")
            write_wav(path, wav.astype(np.float32), sr, subtype="PCM_16")
            lines.append(f"{path}|{sid}")
        lists[split] = os.path.join(tmp, f"{split}.txt")
        with open(lists[split], "w") as f:
            f.write("\n".join(lines) + "\n")
    return lists["train"], lists["valid"]


def path_c_phase(dev, _build, card: str):
    """The training loop at full widths: Trainer.fit, resume, stop,
    validation and from_checkpoint."""
    import dataclasses

    from vcvits_tpu_torch.config import Config, load_config
    from vcvits_tpu_torch.data.dataset import VoiceConversionDataset, preprocess
    from vcvits_tpu_torch.data.device_cache import DeviceBatcher
    from vcvits_tpu_torch.data.loader import BucketedLoader, to_device
    from vcvits_tpu_torch.dsp.resample import resample
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    from vcvits_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
    from vcvits_tpu_torch.train.trainer import Trainer
    from vcvits_tpu_torch.utils.audio_io import read_wav

    with tempfile.TemporaryDirectory() as tmp:
        train_fl, val_fl = write_corpus(tmp)
        raw = load_config(CONFIG).to_dict()
        # as shipped ("fp16_run": true) but for the step counts and intervals
        raw["train"].update(steps_per_epoch=None, log_interval=1, eval_interval=3,
                            checkpoint_interval=3)
        raw["data"].update(training_files=train_fl, validation_files=val_fl,
                           cache_dir=os.path.join(tmp, "cache"))
        cfg = Config.from_dict(raw)
        dtype = torch.bfloat16 if cfg.train.fp16_run else torch.float32
        prep_s = {}
        t0 = time.perf_counter()
        for fl in (train_fl, val_fl):  # the C++ host DSP
            preprocess(VoiceConversionDataset(fl, cfg.data), num_workers=8, log_every=0)
            prep_s[fl] = time.perf_counter() - t0
        # its NumPy version on the 8 validation clips only: the whole corpus
        # costs about 30 s more for the same comparison
        t0 = time.perf_counter()
        preprocess(VoiceConversionDataset(val_fl, cfg.data, cache_dir=os.path.join(
            tmp, "cache_numpy"), plain_dsp=True), num_workers=8, log_every=0)
        prep_s["numpy"] = time.perf_counter() - t0
        differ = []
        for fl in (val_fl,):
            cpp = VoiceConversionDataset(fl, cfg.data)
            ref = VoiceConversionDataset(fl, cfg.data, cache_dir=os.path.join(tmp, "cache_numpy"))
            for i in range(len(cpp)):
                a, b = cpp.get_item(i), ref.get_item(i)
                differ += [(fl, i, k) for k in ("x_wav", "y_wav", "x_pitch")
                           if not np.array_equal(a[k], b[k])]
        if differ:
            raise AssertionError(f"path C: the C++ and NumPy host DSP caches differ: {differ[:5]}")
        val_s = prep_s[val_fl] - prep_s[train_fl]
        print(f"path C: preprocess of 48 clips (resample, pYIN, 8 processes) on the host: "
              f"{prep_s[val_fl]:.2f} s with the C++ host DSP; the 8 validation clips "
              f"{val_s:.2f} s with it, {prep_s['numpy']:.2f} s with its NumPy version "
              f"({prep_s['numpy'] / val_s:.2f}x); every cached array equal")

        # request_stop() before fit: a checkpoint at the first boundary, step 0
        stop_dir = os.path.join(tmp, "stopped")
        tr = Trainer(cfg, workdir=stop_dir, device=dev, dtype=dtype)
        tr.request_stop("chip_smoke")
        if tr.fit(max_steps=PATH_C_STEPS) != 0 or tr.ckpt.latest_step() != 0 or tr.history:
            raise AssertionError("path C: request_stop before fit did not stop at step 0 with a "
                                 "checkpoint")
        del tr
        shutil.rmtree(stop_dir)
        torch.cuda.empty_cache()

        workdir = os.path.join(tmp, "run")
        trainer = Trainer(cfg, workdir=workdir, device=dev, dtype=dtype)
        per_step = {"stft_mel": 1, "fused_gate": 2 * 2 * 16, "fused_gate_backward": 2 * 16}
        m = cfg.model
        per_val = {"mel_spectrogram": 4, "flow_coupling_reverse": 4,
                   "mrf": len(m.upsample_rates) * launches_per_stage(m.resblock_dilation_sizes)}
        n_val = PATH_C_STEPS // cfg.train.eval_interval
        expect = {**{k: n * PATH_C_STEPS for k, n in per_step.items()},
                  **{k: n * n_val for k, n in per_val.items()}}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        final = trainer.fit(max_steps=PATH_C_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = {k: _build.LAUNCHES[k] for k in expect}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if final != PATH_C_STEPS or trainer.ckpt.latest_step() != PATH_C_STEPS:
            raise AssertionError(f"path C: fit ended at {final}, latest checkpoint "
                                 f"{trainer.ckpt.latest_step()}")
        if trainer.loader_kind != "device_cache":
            raise AssertionError(f"path C: the auto gate chose {trainer.loader_kind}, expected "
                                 f"the device cache")
        if counts != expect:
            raise AssertionError(f"path C: launches {counts}, expected {expect}")
        hist = trainer.history
        plain = [r["run_s"] for r in hist[1:] if "validate_s" not in r and "checkpoint_s" not in r]
        busy = sum(r["wait_s"] + r["run_s"] + r.get("validate_s", 0) + r.get("checkpoint_s", 0)
                   for r in hist)
        wait_share = sum(r["wait_s"] for r in hist) / busy
        val_ms = [r["validate_s"] * 1e3 for r in hist if "validate_s" in r]
        ckpt_ms = [r["checkpoint_s"] * 1e3 for r in hist if "checkpoint_s" in r]
        size = os.path.getsize(os.path.join(trainer.ckpt.step_dir(PATH_C_STEPS), STATE_FILE))
        write_s = trainer.ckpt.timings["write_s"]
        print(f"path C: fit({PATH_C_STEPS}) at B={cfg.train.batch_size}, {str(dtype)[6:]} "
              f"(\"fp16_run\": {str(cfg.train.fp16_run).lower()}), DeviceBatcher, "
              f"{fit_s:.1f} s in all: {np.mean(plain) * 1e3:.1f} ms/step over the {len(plain)} "
              f"steps after the first without validation or checkpoint (first "
              f"{hist[0]['run_s'] * 1e3:.1f} ms), loader wait {wait_share:.4f} of the loop, "
              f"validate {', '.join(f'{v:.1f}' for v in val_ms)} ms, checkpoint blocking "
              f"{', '.join(f'{v:.1f}' for v in ckpt_ms)} ms, last write {write_s:.2f} s in the "
              f"background, {size / 2 ** 30:.3f} GiB on disk, peak memory {peak:.2f} GiB on {card}; "
              f"launches {counts}")

        # epoch 0 of the streaming loader, copied to the card == the device batcher's
        ds = VoiceConversionDataset(train_fl, cfg.data)
        want = [to_device(b, dev) for b in BucketedLoader(ds, cfg.data,
                                                          cfg.train.batch_size).epoch_batches(0)]
        got = list(DeviceBatcher(ds, cfg.data, cfg.train.batch_size,
                                 device=dev).epoch_batches(0))
        same = len(got) == len(want) > 0 and all(
            set(g) == set(w) and all(g[k].dtype == w[k].dtype and torch.equal(g[k], w[k])
                                     for k in w) for g, w in zip(got, want))
        if not same:
            raise AssertionError("path C: DeviceBatcher's epoch 0 differs from BucketedLoader's")
        print(f"path C: epoch 0, {len(got)} batches of BucketedLoader copied to the card equal "
              f"DeviceBatcher's bit for bit")

        val_loader = BucketedLoader(VoiceConversionDataset(val_fl, cfg.data), cfg.data,
                                    min(cfg.train.batch_size, 8), shuffle=False, drop_last=False)
        scalars = trainer.validate(val_loader, PATH_C_STEPS)
        if not (scalars and np.isfinite(scalars["val/mcd_db"]) and scalars["val/mcd_db"] >= 0
                and 0.0 <= scalars["val/voicing_f1"] <= 1.0):
            raise AssertionError(f"path C: validation metrics {scalars}")
        print(f"path C: validate metrics {scalars}")
        del trainer
        torch.cuda.empty_cache()

        # resume: every restored tensor as saved, then on to step 8
        again = Trainer(cfg, workdir=workdir, device=dev, dtype=dtype)
        saved = CheckpointManager(os.path.join(workdir, "checkpoints")).restore(PATH_C_STEPS)
        if again.resume_or_init() != PATH_C_STEPS:
            raise AssertionError("path C: the second trainer did not resume at step 6")
        state = again.train_step.state_dict()
        bad = [f"{side}.{k}" for side in ("gen", "disc") for k, v in saved[side].items()
               if not torch.equal(state[side][k].cpu(), v)]
        bad += [f"{opt}.{n}.{k}" for opt in ("g_opt", "d_opt") for n, m in saved[opt].items()
                for k, v in m.items() if not torch.equal(state[opt][n][k].cpu(), v)]
        n_opt = sum(len(saved[o]) for o in ("g_opt", "d_opt"))
        if bad or set(state["g_opt"]) != set(saved["g_opt"]) or not n_opt:
            raise AssertionError(f"path C: restored tensors differ from the saved ones: {bad[:5]}")
        del saved, state
        if again.fit(max_steps=PATH_C_RESUME_TO) != PATH_C_RESUME_TO:
            raise AssertionError("path C: the resumed fit did not reach step 8")
        print(f"path C: resumed at {PATH_C_STEPS} with every tensor as saved ({n_opt} AdamW "
              f"states), restore {again.restore_s:.2f} s, reached {PATH_C_RESUME_TO}; "
              f"checkpoints {again.ckpt.all_steps()}")
        del again
        torch.cuda.empty_cache()

        vc = VoiceConverter.from_checkpoint(workdir, device=dev)
        src = open(val_fl).readline().split("|")[0]
        out = vc.convert(src, os.path.join(tmp, "converted.wav"), speaker_id=2)
        true_len = len(resample(*read_wav(src), cfg.data.source_sampling_rate))
        ls = (cfg.data.target_sampling_rate / cfg.data.hop_length) / cfg.data.source_sampling_rate
        y_len = int((torch.tensor([true_len], dtype=torch.float32) * ls).to(torch.int32).item())
        if len(out) != y_len * cfg.data.hop_length or not np.isfinite(out).all():
            raise AssertionError(f"path C: from_checkpoint converted {len(out)} samples, expected "
                                 f"{y_len * cfg.data.hop_length}")
        print(f"path C: VoiceConverter.from_checkpoint (step {PATH_C_RESUME_TO}) converted "
              f"{len(out)} samples, finite")
        del vc
        torch.cuda.empty_cache()
        accumulation_resume(cfg, dtype, os.path.join(tmp, "accum"), dev, card)
        cli_run(train_fl, val_fl, os.path.join(tmp, "cache"), os.path.join(tmp, "cli"), card)
        torchrun_phase(train_fl, val_fl, os.path.join(tmp, "cache"), tmp, card)
    return counts


def accumulation_resume(cfg, dtype, workdir: str, dev, card: str) -> None:
    """accumulate_grad_batches 2: a checkpoint after mini-step 3 holds half
    an update; a second Trainer restores the accumulator and the moments
    as saved and lands the update at mini-step 4."""
    import dataclasses

    from vcvits_tpu_torch.train.checkpoint import CheckpointManager
    from vcvits_tpu_torch.train.trainer import Trainer

    cfg2 = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer,
                                                                accumulate_grad_batches=2),
                               train=dataclasses.replace(cfg.train, eval_interval=1000))
    tr = Trainer(cfg2, workdir=workdir, device=dev, dtype=dtype)
    if tr.fit(max_steps=3) != 3 or tr.train_step.mini_step != 1 or tr.train_step.updates != 1:
        raise AssertionError("path C accumulation: fit(3) did not stop after mini-step 1 of "
                             "the second update")
    del tr
    torch.cuda.empty_cache()
    saved = CheckpointManager(os.path.join(workdir, "checkpoints")).restore(3)
    again = Trainer(cfg2, workdir=workdir, device=dev, dtype=dtype)
    if again.resume_or_init() != 3:
        raise AssertionError("path C accumulation: the second trainer did not resume at 3")
    state = again.train_step.state_dict()
    acc, want = state["accum"], saved["accum"]
    bad = [k for k in ("mini_step", "updates") if acc[k] != want[k]]
    bad += [f"{side}.{n}" for side in ("g", "d") for n, v in want[side].items()
            if not torch.equal(acc[side][n].cpu(), v)]
    bad += [f"{opt}.{n}.{k}" for opt in ("g_opt", "d_opt") for n, m in saved[opt].items()
            for k, v in m.items() if not torch.equal(state[opt][n][k].cpu(), v)]
    n_means = len(want["g"]) + len(want["d"])
    nonzero = sum(bool(v.any()) for side in ("g", "d") for v in want[side].values())
    if bad or want["mini_step"] != 1 or not n_means or nonzero < 0.9 * n_means:
        raise AssertionError(f"path C accumulation: restored state differs: {bad[:5]} "
                             f"(mini-step {want['mini_step']}, {nonzero} of {n_means} means "
                             f"non-zero)")
    del saved, state, acc, want
    if again.fit(max_steps=4) != 4 or again.train_step.updates != 2 or again.train_step.mini_step:
        raise AssertionError("path C accumulation: the resumed fit did not land update 2 at 4")
    print(f"path C accumulation: k=2, checkpoint after mini-step 3 (half of update 2) restored "
          f"with its accumulator ({n_means} running means, mini-step 1, 1 update) and every "
          f"moment as saved; the resumed fit landed update 2 at mini-step 4 on {card}")
    del again
    torch.cuda.empty_cache()


def cli_run(train_fl: str, val_fl: str, cache: str, workdir: str, card: str) -> None:
    """`python -m vcvits_tpu_torch.cli.train`'s main on configs/48k_base.json
    with only the data paths changed: 2 steps in bf16 ("fp16_run": true)."""
    from vcvits_tpu_torch.cli import train as cli
    from vcvits_tpu_torch.train import trainer as trainer_mod
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager

    with open(CONFIG) as f:
        raw = json.load(f)
    raw["data"].update(training_files=train_fl, validation_files=val_fl, cache_dir=cache)
    cfg_path = os.path.join(os.path.dirname(workdir), "48k_base_data_paths.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    built = []

    class Recorded(trainer_mod.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    original = trainer_mod.Trainer
    trainer_mod.Trainer = Recorded
    t0 = time.perf_counter()
    try:
        cli.main(["-c", cfg_path, "--workdir", workdir, "--max-steps", "2"])
    finally:
        trainer_mod.Trainer = original
    wall = time.perf_counter() - t0
    (tr,) = built
    saved = CheckpointManager(os.path.join(workdir, "checkpoints")).restore()
    if tr.dtype != torch.bfloat16 or saved["step"] != 2 or tr.train_step.step != 2:
        raise AssertionError(f"cli.train: dtype {tr.dtype}, checkpoint step {saved['step']}")
    print(f"cli.train -c <configs/48k_base.json, data paths changed> --max-steps 2: trained in "
          f"{str(tr.dtype)[6:]} (fp16_run {raw['train']['fp16_run']}), checkpoint at step 2, "
          f"{wall:.1f} s in all (preprocess of the cached corpus, build, 2 steps, checkpoint) "
          f"on {card}")
    del tr, built, saved
    torch.cuda.empty_cache()


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    err = float(np.mean((ref.astype(np.float64) - test) ** 2))
    return 10.0 * float(np.log10(float(np.mean(ref.astype(np.float64) ** 2)) / max(err, 1e-30)))


def ulps(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Largest distance in units in the last place of the tensors' type."""
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    top = 1 << (31 if bits == torch.int32 else 15)
    a, b = (t.contiguous().view(bits).long() for t in (got, ref))
    a, b = (torch.where(v < 0, -top - v, v) for v in (a, b))  # ordered like the floats
    return int((a - b).abs().max().item())


def int8_convs_per_request(cfg) -> int:
    """Q1 (and Q2) launches of one W8A8 decode: conv_pre, each upsampler,
    both convs of every (block, dilation), conv_post."""
    from vcvits_tpu_torch.ops.mrf import launches_per_stage

    m = cfg.model
    return 2 + len(m.upsample_rates) * (1 + 2 * launches_per_stage(m.resblock_dilation_sizes))


def out_samples(cfg, n16: int) -> int:
    """The valid 48 kHz samples of a source of n16 samples at 16 kHz: frames
    counted in float32 as the converter counts them, times the hop."""
    hop = cfg.data.hop_length
    ls = (cfg.data.target_sampling_rate / hop) / cfg.data.source_sampling_rate
    return int((torch.tensor([n16], dtype=torch.float32) * ls).to(torch.int32).item()) * hop


def int8_conv_shapes(cfg, frames: int):
    """Every distinct Q1 launch of a W8A8 decode of `frames` frames:
    (name, Ci, Co' (columns), k, dilation, pad, T in, slope, launches a
    request, multiply-adds the function needs at B = 1). An upsampler is
    its phase-decomposed conv (Co' = stride x Co) but counts only its real
    taps."""
    from vcvits_tpu_torch.models.layers import fold_transpose_kernel

    m = cfg.model
    c, t = m.upsample_initial_channel, frames
    out = [("conv_pre", m.inter_channels, c, 7, 1, (3, 3), t, None, 1,
            t * m.inter_channels * c * 7)]
    for i, (u, k) in enumerate(zip(m.upsample_rates, m.upsample_kernel_sizes)):
        co = c // 2
        wf, pad = fold_transpose_kernel(torch.zeros(c, co, k), u, (k - u) // 2)
        out.append((f"up_{i}", c, u * co, wf.shape[2], 1, pad, t, 0.1, 1, t * c * co * k))
        c, t = co, t * u
        for rk, rd in zip(m.resblock_kernel_sizes, m.resblock_dilation_sizes):
            for d in rd:  # c1 at each dilation; the c2 convs are the d = 1 shape
                n = 1 + (len(rd) if d == 1 else 0)
                p = (rk - 1) // 2 * d
                out.append((f"mrf_{i} k{rk} d{d}", c, c, rk, d, (p, p), t, 0.1, n, t * c * c * rk))
    out.append(("conv_post", c, 1, 7, 1, (3, 3), t, 0.01, 1, t * c * 7))
    return out


def int8_library_ms(xq: torch.Tensor, qw, pad, dilation: int) -> float:
    """The yardstick: im2col of the int8 codes xq [B, T, Ci] (a strided view
    copied to [B * T', k * Ci]) and one torch._int_mm (cuBLASLt int8) with
    the codes [k * Ci, Co] (columns padded to 8), timed with CUDA events;
    never on the path. The int32 result is checked against the plain
    version's integer sums once, at B = 1."""
    import torch.nn.functional as F

    b, _, ci = xq.shape
    k = qw.k
    xp = F.pad(xq, (0, 0, *pad))
    t_out = xp.shape[1] - (k - 1) * dilation
    s0, s1, s2 = xp.stride()
    co8 = -(-qw.co // 8) * 8
    wmat = torch.zeros(co8, k * ci, dtype=torch.int8, device=xq.device)
    wmat[:qw.co] = qw.codes().permute(0, 2, 1).reshape(qw.co, k * ci)
    wt = wmat.t()  # column-major [k * Ci, Co]

    def run():  # the copy is the im2col (at dilation 1 the strided view's rows overlap)
        cols = xp.as_strided((b, t_out, k, ci), (s0, s1, dilation * s1, s2))
        return torch._int_mm(cols.reshape(b * t_out, k * ci).contiguous(), wt)

    if b == 1:
        acc = F.conv1d(xp.double().transpose(1, 2), qw.codes().double(), dilation=dilation)
        got = run()[:, :qw.co].double()
        if not torch.equal(got, acc[0].t()):
            raise AssertionError("im2col + torch._int_mm does not give the plain version's sums")
    return cuda_ms(run)


def int8_kernel_phase(dev, _build):
    """Q2 and Q1 against their plain versions at every distinct decoder conv
    of a 10 s W8A8 request (configs/48k_base.json), B = 1 and the daemon's
    16, fp32 and bf16 inputs; their times, bounds and the library's."""
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.ops.int8_conv import (
        act_scale, conv1d_w8a8_plain, kernel_plan, launch_conv, plan, prepare_w8a8,
        quantize_act_per_row, row_absmax, row_absmax_plain)

    cfg = load_config(CONFIG)
    gen = torch.Generator(device=dev).manual_seed(8)
    tot = {}
    for name, ci, co, k, d, pad, t, slope, mult, macs in int8_conv_shapes(cfg, INT8_FRAMES):
        if kernel_plan(ci, co, k, d) != plan(ci, co, k, d).smem:
            raise AssertionError(f"int8 {name}: plan and the library's int8_conv_plan differ")
        w = torch.randn((co, ci, k), generator=gen, device=dev) / float(np.sqrt(k * ci))
        bias = torch.randn((co,), generator=gen, device=dev) * 0.1
        qw = prepare_w8a8(w)
        if not torch.equal(qw.scale.cpu(), prepare_w8a8(w.cpu()).scale):
            raise AssertionError(f"int8 {name}: weight scales on the card differ from the host's")
        notes = []
        for b in (1, SERVE_BATCH):
            x32 = torch.randn((b, t, ci), generator=gen, device=dev)
            lib_ms = None
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                es = x.element_size()
                amax = row_absmax(x, slope)
                if not torch.equal(amax, row_absmax_plain(x, slope)) or (b == 1 and not (
                        torch.equal(act_scale(amax).cpu(),
                                    act_scale(row_absmax_plain(x.cpu(), slope))))):
                    raise AssertionError(f"int8 {name} B={b} {dtype}: Q2's row maxima or "
                                         f"scales not bit-equal to the plain version's")
                got = launch_conv(x, qw, pad, bias, d, slope, amax)
                ref = conv1d_w8a8_plain(x, qw, pad, bias, d, slope)
                torch.cuda.synchronize()
                u = ulps(got, ref)
                err = float((got.float() - ref.float()).abs().max())
                if u > INT8_ULPS or not torch.isfinite(got.float()).all():
                    raise AssertionError(f"int8 {name} B={b} {dtype}: Q1 {u} ulps from the "
                                         f"plain version (max |err| {err:.3e})")
                del got, ref
                n0 = _build.LAUNCHES["int8_conv1d"]
                q1 = cuda_ms(lambda: launch_conv(x, qw, pad, bias, d, slope, amax))
                if _build.LAUNCHES["int8_conv1d"] - n0 != 4:
                    raise AssertionError(f"int8 {name}: Q1 launched "
                                         f"{_build.LAUNCHES['int8_conv1d'] - n0} times in 4 calls")
                q2 = cuda_ms(lambda: row_absmax(x, slope))
                if slope is None:
                    # no fused activation (conv_pre's input): one PyTorch call computes
                    # Q2's function; a fused leaky ReLU has none
                    def q2_lib():
                        return torch.linalg.vector_norm(x, ord=float("inf"), dim=(1, 2))
                    if not torch.equal(q2_lib().float(), amax):
                        raise AssertionError(f"int8 {name}: vector_norm(ord=inf) is not Q2's "
                                             f"row maxima")
                    extra = {"q2_ms_conv_pre": q2, "q2_library_ms_conv_pre": cuda_ms(q2_lib)}
                else:
                    extra = {}
                plain = cuda_ms(lambda: conv1d_w8a8_plain(x, qw, pad, bias, d, slope), 1) \
                    if b == 1 else float("nan")
                q2_plain = cuda_ms(lambda: row_absmax_plain(x, slope), 1) \
                    if b == 1 else float("nan")
                if lib_ms is None:
                    lib_ms = int8_library_ms(quantize_act_per_row(x, slope)[0], qw, pad, d)
                t_out = t + pad[0] + pad[1] - (k - 1) * d
                q1_b, q1_by = bound_ms(2 * b * macs, b * (t * ci + t_out * co) * es
                                       + k * co * ci + 8 * co, INT8_TOPS)
                q2_b, _ = bound_ms(0.0, b * t * ci * es, INT8_TOPS)
                key = (b, dtype)
                acc = tot.setdefault(key, {"q1_ms": 0.0, "q2_ms": 0.0, "plain_ms": 0.0,
                                           "q2_plain_ms": 0.0,
                                           "bound_ms": 0.0, "q2_bound_ms": 0.0,
                                           "library_ms": 0.0, "max_abs_err": 0.0, "ulps": 0,
                                           "ops_bound_ms": 0.0, "bytes_bound_ms": 0.0})
                ops_ms = 2 * b * macs / INT8_TOPS * 1e3
                for kk, v in (("q1_ms", q1), ("q2_ms", q2), ("plain_ms", plain),
                              ("q2_plain_ms", q2_plain),
                              ("bound_ms", q1_b), ("q2_bound_ms", q2_b), ("library_ms", lib_ms),
                              ("ops_bound_ms", ops_ms),
                              ("bytes_bound_ms", q1_b if q1_by == "bytes" else 0.0)):
                    acc[kk] += mult * v
                acc.update(extra)
                acc["bound_by"] = ("bytes" if acc["bytes_bound_ms"] >= acc["bound_ms"] / 2
                                   else "operations")
                acc["max_abs_err"] = max(acc["max_abs_err"], err)
                acc["ulps"] = max(acc["ulps"], u)
                notes.append(f"B={b} {str(dtype)[6:]} Q1 {q1:.4f} Q2 {q2:.4f}"
                             + (f" plain {plain:.3f}" if b == 1 else "")
                             + f" bound {q1_b:.4f} ({q1_by}) ulps {u}")
                del x
            notes[-1] += f" library {lib_ms:.4f}"
            del x32
            torch.cuda.empty_cache()
        print(f"int8 {name} [{ci}->{co}, k {k}, d {d}, T {t}] x{mult} a request: "
              + "; ".join(notes))
    n = int8_convs_per_request(cfg)
    for (b, dtype), acc in tot.items():
        print(f"int8 per {'request' if b == 1 else f'batch of {b}'} x 10 s {str(dtype)[6:]} "
              f"({n} Q1 + {n} Q2 launches): Q1 {acc['q1_ms']:.4f} ms, Q2 {acc['q2_ms']:.4f} ms, "
              f"bound Q1 {acc['bound_ms']:.4f} ms (operations alone {acc['ops_bound_ms']:.4f}) "
              f"Q2 {acc['q2_bound_ms']:.4f}, bound share Q1 {acc['bound_ms'] / acc['q1_ms']:.4f}; "
              + (f"plain {acc['plain_ms']:.3f} ms (Q2's {acc['q2_plain_ms']:.3f}); "
                 if b == 1 else "")
              + f"im2col + torch._int_mm {acc['library_ms']:.4f} ms; Q2 bit-equal, Q1 max "
              f"{acc['ulps']} ulp (max |err| {acc['max_abs_err']:.3e}); Q2 at conv_pre's "
              f"input (no activation) {acc['q2_ms_conv_pre']:.4f} ms against "
              f"torch.linalg.vector_norm(ord=inf) {acc['q2_library_ms_conv_pre']:.4f} ms")
    return tot


def decoder_codes(dec, z, g):
    """Run the decoder, recording every int8 conv's input codes (as its
    quantizer makes them, on the host): (wave, [codes per conv])."""
    from vcvits_tpu_torch.models.layers import Conv1d, ConvTranspose1d
    from vcvits_tpu_torch.ops.int8_conv import quantize_act_per_row

    codes, hooks = [], []

    def hook(module, args, kwargs):
        x = args[0].to(module.dtype)
        codes.append(quantize_act_per_row(x.cpu(), kwargs.get("act_slope"))[0])

    for mod in dec.modules():
        if isinstance(mod, (Conv1d, ConvTranspose1d)):
            hooks.append(mod.register_forward_pre_hook(hook, with_kwargs=True))
    try:
        with torch.no_grad():
            wave = dec(z, g)[0, :, 0].float().cpu().numpy()
    finally:
        for h in hooks:
            h.remove()
    return wave, codes


def int8_convert_phase(dev, _build, card: str, sd):
    """The int8 decoder modes at full width on path A's weights: the W8A8
    decoder alone on the card against the CPU plain path; convert_array and
    voice_conversion_array of 10 s in float, W8A8 and w8, fp32 and bf16, at
    noise 0, held to JAX's gates against the float decode; ms per request."""
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    from vcvits_tpu_torch.ops.stft_mel import mel_spectrogram_plain
    from vcvits_tpu_torch.utils.audio_io import read_wav

    cfg = load_config(CONFIG)
    m = cfg.model
    n_convs = int8_convs_per_request(cfg)
    n_mrf = len(m.upsample_rates) * launches_per_stage(m.resblock_dilation_sizes)
    rng = np.random.default_rng(9)
    z = torch.tensor(rng.standard_normal((1, 45, m.inter_channels)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((1, m.gin_channels)), dtype=torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for device in (dev, "cpu"):
            dec = VoiceConverter(cfg, sd, dtype=dtype, device=device, quant_int8=True).gen.dec
            runs.append(decoder_codes(dec, z.to(device, dtype), g.to(device, dtype)))
            del dec
        (card_y, card_codes), (cpu_y, cpu_codes) = runs
        diff = sum(int((a != b).sum()) for a, b in zip(card_codes, cpu_codes))
        total = sum(a.numel() for a in cpu_codes)
        snr = snr_db(cpu_y, card_y)
        print(f"int8 decoder alone (W8A8, {str(dtype)[6:]}, 45 frames = 0.48 s, the same z and "
              f"g): card vs CPU plain path SNR {snr:.2f} dB, {len(card_codes)} convs, {diff} of "
              f"{total} int8 activation codes differ, max |err| "
              f"{float(np.abs(card_y - cpu_y).max()):.3e}")
        if len(card_codes) != n_convs or card_y.shape != cpu_y.shape or snr < INT8_CARD_CPU_SNR:
            raise AssertionError(f"int8 decoder alone {dtype}: {len(card_codes)} convs, SNR "
                                 f"{snr:.2f} dB < {INT8_CARD_CPU_SNR}")

    def mel(y):  # on the host, in float64 sums (the plain K4)
        return mel_spectrogram_plain(torch.as_tensor(y)[None], 2048, 128, 48000, 512, 2048)[0]

    hop = cfg.data.hop_length
    reqs_per = {"float": {"mrf": n_mrf, "int8_conv1d": 0, "row_absmax": 0},
                "w8a8": {"mrf": 0, "int8_conv1d": n_convs, "row_absmax": n_convs},
                "w8": {"mrf": n_mrf, "int8_conv1d": 0, "row_absmax": 0}}
    counts = {"int8_conv1d": 0, "row_absmax": 0}
    with tempfile.TemporaryDirectory() as tmp:
        wav48 = read_wav(write_sources(tmp, n=1, sr=48000)[0])[0]
    src = serve_sources(cfg, np.random.default_rng(4), [10.0])[0]
    outs, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype)[6:]
        for mode, quant in INT8_MODES:
            vc = VoiceConverter(cfg, sd, dtype=dtype, device=dev, quant_int8=quant)
            w, p, n, sid = src
            runs = {"convert": lambda: vc.convert_array(w, p, sid, n, noise_scale=0.0),
                    "vc": lambda: vc.voice_conversion_array(wav48, 3, 77)}
            for what, fn in runs.items():
                _build.LAUNCHES.clear()
                y = fn()
                torch.cuda.synchronize()
                rose = {k: _build.LAUNCHES[k] for k in reqs_per[mode]}
                if rose != reqs_per[mode]:
                    raise AssertionError(f"int8 {what} {mode} {label}: launches {rose}, "
                                         f"expected {reqs_per[mode]}")
                for k in counts:
                    counts[k] += rose[k]
                want = out_samples(cfg, n) if what == "convert" else len(wav48) // hop * hop
                if len(y) != want or not np.isfinite(y).all():
                    raise AssertionError(f"int8 {what} {mode} {label}: {len(y)} samples "
                                         f"(expected {want}) or non-finite")
                outs[(what, mode, dtype)] = y
            fn = runs["convert"]
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            times[(mode, dtype)] = (time.perf_counter() - t0) / 3 * 1e3
            with torch.no_grad():
                zt = torch.randn((1, INT8_FRAMES, m.inter_channels), device=dev).to(dtype)
                gt = vc.gen.emb_g(torch.tensor([3], device=dev))
                dec_ms = cuda_ms(lambda: vc.gen.dec(zt, gt), 2)
            print(f"int8 {mode} {label}: convert_array (prepared 10 s source) "
                  f"{times[(mode, dtype)]:.1f} ms per request, decoder alone {dec_ms:.3f} "
                  f"device ms on {card}")
            device_profile(fn, f"int8 {mode} {label} convert_array", card)
            del vc
            torch.cuda.empty_cache()
    notes = []
    for what in ("convert", "vc"):
        ref32 = outs[(what, "float", torch.float32)]
        ref16 = outs[(what, "float", torch.bfloat16)]
        s = {(mode, dt): snr_db(ref32, outs[(what, mode, dt)]) for mode, _ in INT8_MODES[1:]
             for dt in (torch.float32, torch.bfloat16)}
        mel_l1 = float((mel(outs[(what, "w8a8", torch.bfloat16)]) - mel(ref16)).abs().mean())
        mel_bf16 = float((mel(ref16) - mel(ref32)).abs().mean())
        clipped = float(np.mean(np.abs(ref32) > 0.99))
        notes.append(f"{what}: SNR vs the fp32 float decode W8A8 fp32 "
                     f"{s[('w8a8', torch.float32)]:.2f} dB, bf16 {s[('w8a8', torch.bfloat16)]:.2f}; "
                     f"w8 fp32 {s[('w8', torch.float32)]:.2f}, bf16 {s[('w8', torch.bfloat16)]:.2f}; "
                     f"float bf16 {snr_db(ref32, ref16):.2f}; mel-L1 W8A8 bf16 vs float bf16 "
                     f"{mel_l1:.4f} (float bf16 vs fp32 {mel_bf16:.4f}); float fp32 mean |y| "
                     f"{float(np.abs(ref32).mean()):.3f}, share |y| > 0.99 {clipped:.3f}")
        # Held on convert: W8A8's limit and w8 above W8A8. On these weights
        # JAX's own decoder misses the w8 and mel limits too
        # (tests/int8_path_a_reference.py); the flow swap's float decode is
        # saturated here (the share above), where an SNR measures the tanh's
        # clipping more than the quantizer: printed, not held.
        if what == "convert" and not (
                min(s[("w8a8", dt)] for dt in (torch.float32, torch.bfloat16)) >= INT8_W8A8_SNR
                and s[("w8", torch.float32)] > s[("w8a8", torch.float32)]):
            raise AssertionError(f"int8 on path A's weights: {notes[-1]}")
    print("int8 against the same weights' float decode (10 s, noise 0, path A weights): "
          + "; ".join(notes))
    print("int8 ms per 10 s convert_array (same call): " + ", ".join(
        f"{mode} {str(dt)[6:]} {times[(mode, dt)]:.1f}" for dt in (torch.float32, torch.bfloat16)
        for mode, _ in INT8_MODES) + f" on {card}")
    int8_jax_gates(dev, cfg)
    return counts


def int8_jax_gates(dev, cfg) -> None:
    """JAX's gates in JAX's own setting (tests/test_int8_decoder.py:93-140):
    the decoder alone at full width on the seeded initial weights (JAX's
    initialisers), fed x [1, 20, 128] and g from a seed, on the card: W8A8
    in bf16 >= INT8_W8A8_SNR dB from the fp32 float decode and mel-L1 <=
    INT8_MEL_L1 from the bf16 float decode; w8 in fp32 >= INT8_W8_SNR dB and
    above W8A8 in fp32."""
    from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator
    from vcvits_tpu_torch.models.layers import init_weights
    from vcvits_tpu_torch.ops.stft_mel import mel_spectrogram_plain

    m = cfg.model
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((1, 20, m.inter_channels)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((1, m.gin_channels)), dtype=torch.float32)
    ys = {}
    for name, quant, dtype in (("float fp32", False, torch.float32),
                               ("float bf16", False, torch.bfloat16),
                               ("w8a8 bf16", True, torch.bfloat16),
                               ("w8a8 fp32", True, torch.float32), ("w8 fp32", "w8", torch.float32)):
        dec = init_weights(HiFiGANGenerator(
            m.inter_channels, m.resblock, m.resblock_kernel_sizes, m.resblock_dilation_sizes,
            m.upsample_rates, m.upsample_initial_channel, m.upsample_kernel_sizes,
            gin_channels=m.gin_channels, quant_int8=quant, dtype=dtype), 0).to(dev)
        with torch.no_grad():
            ys[name] = dec(x.to(dev, dtype), g.to(dev, dtype))[0, :, 0].float().cpu().numpy()

    def mel(y):
        return mel_spectrogram_plain(torch.as_tensor(y)[None], 2048, 128, 48000, 512, 2048)[0]

    s8 = snr_db(ys["float fp32"], ys["w8a8 bf16"])
    s8f = snr_db(ys["float fp32"], ys["w8a8 fp32"])
    sw = snr_db(ys["float fp32"], ys["w8 fp32"])
    mel_l1 = float((mel(ys["w8a8 bf16"]) - mel(ys["float bf16"])).abs().mean())
    print(f"int8 JAX gates (decoder alone, full width, seeded initial weights, 20 frames): W8A8 "
          f"bf16 {s8:.2f} dB (>= {INT8_W8A8_SNR}), mel-L1 vs float bf16 {mel_l1:.4f} (<= "
          f"{INT8_MEL_L1}); w8 fp32 {sw:.2f} dB (>= {INT8_W8_SNR}, above W8A8 fp32 {s8f:.2f}); "
          f"mean |y| {float(np.abs(ys['float fp32']).mean()):.3e}")
    if not (s8 >= INT8_W8A8_SNR and mel_l1 <= INT8_MEL_L1 and sw >= INT8_W8_SNR and sw > s8f):
        raise AssertionError("int8: JAX's gates failed in JAX's setting")


def int8_serve_phase(dev, _build, card: str, sd):
    """A ServingDaemon in W8A8 at full widths, fp32 and bf16: the closed-loop
    round of 16 clients x 2 requests, one batch of 16 x 10 s (profiled), and
    a lone request equal to convert_array at its padded length."""
    import threading

    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.serving import ServingDaemon

    cfg = load_config(CONFIG)
    counts = {"int8_conv1d": 0, "row_absmax": 0}
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype)[6:]
        vc = VoiceConverter(cfg, sd, dtype=dtype, device=dev, quant_int8=True)
        rng = np.random.default_rng(0)
        reqs = serve_sources(cfg, rng, rng.uniform(2.0, 10.0, SERVE_CLIENTS * SERVE_PER_CLIENT))
        vc.convert_array(*reqs[0][:2], reqs[0][3], reqs[0][2], noise_scale=0.0)  # warm-up
        with recording_daemon(vc, max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS) as daemon:
            results, errors = [None] * len(reqs), []

            def client(i):
                try:
                    for j in range(i * SERVE_PER_CLIENT, (i + 1) * SERVE_PER_CLIENT):
                        w, p, n, sid = reqs[j]
                        results[j] = daemon.submit(w, p, n, sid, noise_scale=0.0).result(
                            timeout=600)
                except Exception as e:  # noqa: BLE001 - raised below, in this thread
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            wall = time.perf_counter() - t0
            rose = {k: _build.LAUNCHES[k] for k in counts}
            mrf_launches = _build.LAUNCHES["mrf"]
            if errors or any(th.is_alive() for th in threads):
                raise AssertionError(f"int8 serve {label}: client errors {errors[:3]}")
            stats, batches = daemon.stats(), list(daemon.batches)
        expect = {k: int8_convs_per_request(cfg) * len(batches) for k in counts}
        if rose != expect or mrf_launches:
            raise AssertionError(f"int8 serve {label}: launches {rose} (mrf {mrf_launches}) for "
                                 f"{len(batches)} batches, expected {expect}")
        for k, v in rose.items():
            counts[k] += v
        for i, (out, (w, p, n, sid)) in enumerate(zip(results, reqs)):
            if len(out) != out_samples(cfg, n) or not np.isfinite(out).all():
                raise AssertionError(f"int8 serve {label} request {i}: {len(out)} samples or "
                                     f"non-finite")
        audio_s = sum(r[2] for r in reqs) / cfg.data.source_sampling_rate
        print(f"int8 serve W8A8 {label}: {len(reqs)} requests of 2-10 s from {SERVE_CLIENTS} "
              f"closed-loop clients: wall {wall:.3f} s, {len(reqs) / wall:.2f} requests/s, "
              f"{audio_s / wall:.2f} s of audio per s; latency p50 {stats['latency_p50_ms']} ms, "
              f"p95 {stats['latency_p95_ms']} ms, max {stats['latency_max_ms']} ms; mean batch "
              f"{stats['mean_batch']}; launches {rose} on {card}")
        eq = serve_sources(cfg, rng, [10.0] * SERVE_BATCH)
        with recording_daemon(vc, max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS) as daemon:
            outs = []

            def one_batch():
                futs = [daemon.submit(w, p, n, sid, noise_scale=0.0) for w, p, n, sid in eq]
                outs[:] = [f.result(timeout=600) for f in futs]

            one_batch()  # warm-up at this shape
            device_profile(one_batch, f"int8 serve W8A8 {label} one batch of {SERVE_BATCH} x 10 s",
                           card)
            t0 = time.perf_counter()
            one_batch()
            batch_wall = time.perf_counter() - t0
            sizes = [len(bt) for bt in daemon.batches]
        if sizes != [SERVE_BATCH] * 3:
            raise AssertionError(f"int8 serve {label}: 16 requests at once made batches {sizes}")
        # a row's z differs from its solo run's by the batched float ops'
        # rounding, and W8A8 carries a moved code on to many: a row is held
        # to W8A8's limit against the float decode of the same request
        flt = VoiceConverter(cfg, sd, dtype=dtype, device=dev)
        snrs = [(snr_db(flt.convert_array(w, p, sid, n, noise_scale=0.0), out),
                 snr_db(vc.convert_array(w, p, sid, n, noise_scale=0.0), out))
                for (w, p, n, sid), out in zip(eq[:4], outs[:4])]
        del flt
        if min(s for s, _ in snrs) < INT8_W8A8_SNR:
            raise AssertionError(f"int8 serve {label}: batch rows vs the float decode {snrs}")
        w, p, n, sid = eq[1]
        with ServingDaemon(vc, max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS) as daemon:
            lone = daemon.submit(w, p, n, sid, noise_scale=0.0).result(timeout=600)
        want = vc.convert_array(w, p, sid, n, noise_scale=0.0)
        err = float(np.abs(lone - want).max())
        if lone.shape != want.shape or err > 1e-6:
            raise AssertionError(f"int8 serve {label}: a lone request is {err:.3e} from "
                                 f"convert_array at the same padded length")
        print(f"int8 serve W8A8 {label}: a batch of {SERVE_BATCH} x 10 s in "
              f"{batch_wall * 1e3:.1f} ms wall ({SERVE_BATCH * 10 / batch_wall:.1f}x real time); "
              f"4 rows vs their float convert_array SNR {min(s for s, _ in snrs):.2f}-"
              f"{max(s for s, _ in snrs):.2f} dB (>= {INT8_W8A8_SNR}), vs their W8A8 solo runs "
              f"{min(s for _, s in snrs):.2f}-{max(s for _, s in snrs):.2f} dB; a lone request max "
              f"|err| {err:.3e} from convert_array")
        del vc
        torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ TTS
TTS_TEXT = ("The north wind and the sun were disputing which was the stronger, when a traveler "
            "came along wrapped in a warm cloak. They agreed that the one who first made the "
            "traveler take off his cloak was stronger.")  # 203 ids
TTS_SECONDS = (9.0, 11.0)  # the synthesized utterance's length, set by length_scale
TTS_NOISE, TTS_NOISE_W = 0.667, 0.8
TTS_SHORT = "Hello world."
MAS_SHAPES = (("train 16 x 192 x 750", 16, 192, 750),  # the TTS step's B, text bucket, frames
              ("T_x 600 > block", 4, 600, 1500))


def perturbed_tts_state(cfg):
    """Seeded TTS weights with the zero-initialised kernels (the flow's
    `post`, the SDP's ConvFlow `proj`) made random, the decoder's
    weight-norm gains x 3, and the SDP's log-duration offset set to 1.5
    (pre_affine.m[0] = -1.5: about 5 frames a token at length_scale 1, as
    a trained model's): JAX's initialisers leave the flows identities, the
    decoder near silent and a token about 2 frames long."""
    from vcvits_tpu_torch.models.synthesizer_tts import SynthesizerTTS

    model = SynthesizerTTS.from_config(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (name.startswith("flow.") and ".post." in name) or (
                    name.startswith("duration_predictor.") and ".proj." in name
                    and "flow" in name):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.startswith("dec.") and name.endswith(".g"):
                p.mul_(3.0)
        model.duration_predictor.pre_affine.m[0] = -1.5
    return model.state_dict()


# Where the TTS paths call each kernel's wrapper: (the calling module, the
# name it calls the wrapper by, the kernel's name in the kernels line)
KERNEL_SITES = (("vcvits_tpu_torch.models.hifigan", "mrf", "mrf"),
                ("vcvits_tpu_torch.models.flow", "coupling_reverse", "flow_coupling_reverse"),
                ("vcvits_tpu_torch.models.flow", "coupling_forward", "flow_coupling_forward"),
                ("vcvits_tpu_torch.models.wavenet", "wn_segment", "wn_segment"),
                ("vcvits_tpu_torch.models.wavenet", "fused_gate", "fused_gate"),
                ("vcvits_tpu_torch.train.tts_step", "spectrogram_mel", "stft_mel"),
                ("vcvits_tpu_torch.train.tts_trainer", "mel_spectrogram", "mel_spectrogram"),
                ("vcvits_tpu_torch.models.synthesizer_tts", "maximum_path", "monotonic_align"),
                ("vcvits_tpu_torch.train.step", "spectrogram_mel", "stft_mel"),
                ("vcvits_tpu_torch.train.trainer", "mel_spectrogram", "mel_spectrogram"))


def _moved(v, device):
    """A detached copy on `device` of a wrapper's argument (tensors, and
    tuples and lists of them)."""
    if torch.is_tensor(v):
        return v.detach().to(device, copy=True)
    if isinstance(v, (tuple, list)):
        return type(v)(_moved(u, device) for u in v)
    return v


@contextlib.contextmanager
def kernel_inputs():
    """While the block runs, each wrapper of KERNEL_SITES is called through
    a recorder that keeps a host copy of the arguments of its first call at
    each distinct shape and dtype (so the card's peak memory is the path's
    own), then makes the call (one launch, counted as before). Yields {kernel name: {signature: (args, kwargs)}}: the inputs
    the path gave each kernel, for check_kernel_inputs."""
    seen, saved = {}, []
    for mod_name, attr, kernel in KERNEL_SITES:
        mod = importlib.import_module(mod_name)
        fn, calls = getattr(mod, attr), seen.setdefault(kernel, {})

        def record(*args, _fn=fn, _calls=calls, **kw):
            key = tuple((tuple(a.shape), a.dtype) for a in args if torch.is_tensor(a))
            if key not in _calls:
                _calls[key] = (_moved(args, "cpu"), _moved(kw, "cpu"))
            return _fn(*args, **kw)
        saved.append((mod, attr, fn))
        setattr(mod, attr, record)
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def held_to_plain(kernel: str, args, kw):
    """One wrapper call again on recorded inputs, against its plain version
    on the same inputs, at the kernel phases' tolerances -> (max |err|,
    [(measure, value, limit)])."""
    from vcvits_tpu_torch.ops import flow_coupling as fc, fused_gate as fg, mrf as mr, \
        monotonic_align as ma, stft_mel as sm

    pairs = {"mrf": (mr.mrf, mr.mrf_plain),
             "flow_coupling_reverse": (fc.coupling_reverse, fc.coupling_reverse_plain),
             "flow_coupling_forward": (fc.coupling_forward, fc.coupling_forward_plain),
             "wn_segment": (fc.wn_segment, fc.wn_segment_plain),
             "stft_mel": (sm.spectrogram_mel, sm.spectrogram_mel_plain),
             "mel_spectrogram": (sm.mel_spectrogram, sm.mel_spectrogram_plain)}
    if kernel == "fused_gate":
        a, b, h = args
        go = torch.randn(a.shape[:-1] + (h,), device=a.device,
                         generator=torch.Generator(device=a.device).manual_seed(5)).to(a.dtype)
        res = []
        for fn in (fg.fused_gate, fg.fused_add_tanh_sigmoid_multiply):
            a_ = a.clone().requires_grad_()
            b_ = None if b is None else b.clone().requires_grad_()
            out = fn(a_, b_, h)
            out.backward(go)
            res.append([out.detach(), a_.grad] + ([] if b is None else [b_.grad]))
        names = ("out", "grad_a", "grad_b")
        if a.dtype == torch.bfloat16:
            rels = [rel_err(g, r, bf16=True) for g, r in zip(*res)]
            return max(e for e, _ in rels), [(f"{n} error RMS / RMS", r, GATE_TOL_BF16)
                                             for n, (_, r) in zip(names, rels)]
        errs = [(g - r).abs().max().item() for g, r in zip(*res)]
        limits = (GATE_TOL, GATE_TOL, GATE_TOL * a.shape[1])  # grad_b sums T rows
        return max(errs), [(f"{n} max |err|", e, lim) for n, e, lim in zip(names, errs, limits)]
    with torch.inference_mode():
        if kernel == "monotonic_align":
            neg, xl, yl = args
            t_y, t_x = neg.shape[1:]
            path = ma.maximum_path(neg, xl, yl)
            ref = ma.maximum_path_plain(neg.transpose(1, 2), ma.length_mask(xl, yl, t_x, t_y))
            return 0.0, [("differing entries", int((path != ref).sum()), 0)]
        kernel_fn, plain_fn = pairs[kernel]
        got, ref = kernel_fn(*args, **kw), plain_fn(*args, **kw)
    if kernel == "stft_mel":
        (spec, mel), (rspec, rmel) = got, ref
        top = rspec.abs().max().item()
        err, mel_err = (spec - rspec).abs().max().item(), (mel - rmel).abs().max().item()
        return max(err, mel_err), [("spec max |err| / max |spec|", err / top, STFT_TOL),
                                   ("log-mel max |err|", mel_err, STFT_TOL)]
    if kernel == "mel_spectrogram":
        err = (got - ref).abs().max().item()
        return err, [("log-mel max |err|", err, STFT_TOL)]
    if kernel == "wn_segment":
        m = args[2].float()
        got, ref = torch.cat([got[0] * m, got[1] * m], -1), torch.cat([ref[0] * m, ref[1] * m], -1)
        bf16 = args[0].dtype == torch.bfloat16
    elif kernel == "mrf":
        bf16 = args[1][0][0].dtype == torch.bfloat16
    else:
        bf16 = args[0].dtype == torch.bfloat16
    err, rel = rel_err(got, ref, bf16=bf16)
    if kernel == "mrf":
        limit = MRF_TOL[torch.bfloat16 if bf16 else torch.float32]
    else:
        limit = MRF_TOL[torch.bfloat16] if bf16 else FLOW_TOL
    return err, [("error RMS / RMS" if bf16 else "max |err| / RMS", rel, limit)]


def check_kernel_inputs(seen: dict, label: str, expect, held: dict) -> None:
    """Every kernel in `expect` was called on the path, and each recorded
    call is held to its plain version (held_to_plain); the worst max |err|
    of each kernel goes into `held`. Raises on a miss."""
    missing = [k for k in expect if not seen.get(k)]
    if missing:
        raise AssertionError(f"{label}: the path called no {missing}")
    for kernel, calls in seen.items():
        for args, kw in calls.values():
            args, kw = _moved(args, "cuda"), _moved(kw, "cuda")
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            dtype = next(a.dtype for a in args if torch.is_tensor(a))
            err, checks = held_to_plain(kernel, args, kw)
            held[kernel] = max(held.get(kernel, 0.0), err)
            print(f"{label}: {kernel} on the path's inputs {shapes} {str(dtype)[6:]} against its "
                  f"plain version: max_abs_err={err:.3e}; " + ", ".join(
                      f"{n} {v:.3e} (limit {lim:g})" for n, v, lim in checks))
            bad = [(n, v, lim) for n, v, lim in checks if not v <= lim]
            if bad:
                raise AssertionError(f"{label}: {kernel} at {shapes} differs from its plain "
                                     f"version: {bad}")
    seen.clear()
    torch.cuda.empty_cache()


def mas_phase(rng, dev, _build):
    """M1 at the TTS step's shapes (B 16, text bucket 192, 750 frames of 8 s,
    ragged lengths) and with T_x above the 256-thread block: bit-equal to
    the plain version on the card; kernel ms, device ms, plain ms and the
    bytes bound."""
    from vcvits_tpu_torch.ops.monotonic_align import length_mask, maximum_path, \
        maximum_path_plain

    res = {}
    for label, b, t_x, t_y in MAS_SHAPES:
        value = torch.tensor(rng.standard_normal((b, t_y, t_x)) * 30, dtype=torch.float32,
                             device=dev)
        xl = rng.integers(t_x // 3, t_x + 1, b)
        yl = np.maximum(rng.integers(t_y // 2, t_y + 1, b), xl)
        xl[-1], yl[-1] = t_x, t_y
        xl_t, yl_t = (torch.tensor(a, dtype=torch.int32, device=dev) for a in (xl, yl))
        n0 = _build.LAUNCHES["monotonic_align"]
        path = maximum_path(value, xl_t, yl_t)
        torch.cuda.synchronize()
        if _build.LAUNCHES["monotonic_align"] - n0 != 1:
            raise AssertionError("M1: maximum_path did not launch its kernel once")
        ref = maximum_path_plain(value.transpose(1, 2), length_mask(xl_t, yl_t, t_x, t_y))
        ndiff = int((path != ref).sum())
        if ndiff or not torch.equal(path.sum(1), length_mask(xl_t, yl_t, t_x, t_y)[:, 0]):
            raise AssertionError(f"M1 {label}: {ndiff} entries differ from the plain version, "
                                 f"or a valid frame has no single x")
        ms, _ = timed(lambda: maximum_path(value, xl_t, yl_t), _build, "monotonic_align", 10)
        dev_ms = kernel_device_ms(lambda: maximum_path(value, xl_t, yl_t), "mas_kernel")
        plain_ms = cuda_ms(lambda: maximum_path_plain(
            value.transpose(1, 2), length_mask(xl_t, yl_t, t_x, t_y)), 1)
        nbytes = 4 * float(np.sum(xl * yl)) + 4 * b * t_x * t_y
        b_ms, by = bound_ms(2 * float(np.sum(xl * yl)), nbytes, FP32_FLOPS)
        res[label] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": by, "differing": ndiff}
        print(f"M1 maximum_path {label} (B={b}, T_x={t_x}, T_y={t_y}, ragged): 0 of "
              f"{path.numel()} entries differ from the plain version; kernel_ms={ms:.4f} "
              f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.2f} bound_ms={b_ms:.5f} ({by}: "
              f"{nbytes / 1e6:.1f} MB) bound / device {b_ms / dev_ms:.4f}; library_ms none (no "
              f"PyTorch call computes MAS)")
    return res


def tts_length_scale(tts, sid: int) -> tuple:
    """The length_scale that puts TTS_TEXT at 9-11 s with this model's
    seeded draws (a few fixed-point steps toward 10 s) and its frames."""
    hop, sr = tts.cfg.data.hop_length, tts.cfg.data.target_sampling_rate
    scale = 1.0
    for _ in range(6):
        n = len(tts.synthesize(TTS_TEXT, sid=sid, noise_scale=TTS_NOISE,
                               noise_scale_w=TTS_NOISE_W, length_scale=scale)) // hop
        secs = n * hop / sr
        if TTS_SECONDS[0] + 0.25 <= secs <= TTS_SECONDS[1] - 0.25:
            return scale, n
        scale *= 10.0 / max(secs, 0.1)
    raise AssertionError(f"TTS: no length_scale put the text at 9-11 s (last {secs:.2f} s)")


def tts_breakdown(tts, sid: int, scale: float, label: str) -> None:
    """Device ms of each part of one synthesis (CUDA events): the text
    encoder, the SDP sampler, the alignment and prior, the flow reverse
    (K2), the decoder (and K1's device time inside it, torch.profiler)."""
    from vcvits_tpu_torch.utils.masking import generate_path, sequence_mask

    gen, dev = tts.gen, tts.device
    seq = tts.encode_text(TTS_TEXT)
    padded = -(-len(seq) // tts.text_unit) * tts.text_unit
    x = torch.zeros(1, padded, dtype=torch.int64, device=dev)
    x[0, :len(seq)] = torch.as_tensor(seq, device=dev)
    xl = torch.tensor([len(seq)], device=dev)
    budget = tts.frame_budget(len(seq), scale)
    rng = torch.Generator(device=dev).manual_seed(0)
    parts = {}
    with torch.inference_mode():
        g = gen.emb_g(torch.tensor([sid], device=dev))
        parts["text encoder"] = cuda_ms(lambda: gen.enc_p(x, xl), 3)
        h, m_p, logs_p, x_mask = gen.enc_p(x, xl)

        def sdp():
            return gen.duration_predictor(h, x_mask, g=g, reverse=True,
                                          noise_scale=TTS_NOISE_W, generator=rng)
        parts["SDP sampler"] = cuda_ms(sdp, 3)
        logw = sdp()

        def align():
            w_ceil = torch.ceil(torch.exp(logw) * x_mask * scale)[..., 0]
            y_len = torch.clamp(w_ceil.sum(1), 1, budget).to(torch.int32)
            y_mask = sequence_mask(y_len, budget).to(m_p.dtype)
            attn = generate_path(w_ceil.to(torch.int32), y_mask, x_mask)
            mp, lp = torch.matmul(attn, m_p), torch.matmul(attn, logs_p)
            eps = torch.randn(mp.shape, generator=rng, device=dev, dtype=mp.dtype)
            return mp + eps * torch.exp(lp) * TTS_NOISE, y_mask
        parts["alignment + prior"] = cuda_ms(align, 3)
        z_p, y_mask = align()
        parts["flow reverse (K2)"] = cuda_ms(lambda: gen.flow.kernel_reverse(z_p, y_mask, g=g), 3)
        z = gen.flow.kernel_reverse(z_p, y_mask, g=g).to(z_p.dtype) * y_mask
        parts["decoder"] = cuda_ms(lambda: gen.dec(z, g=g, fused_mrf=True), 3)
        k1 = kernel_device_ms(lambda: gen.dec(z, g=g, fused_mrf=True), "mrf", reps=2)
    print(f"TTS synthesis breakdown {label} (device ms, CUDA events, {budget}-frame budget, "
          f"{len(seq)} ids padded to {padded}): " + ", ".join(
              f"{k}={v:.3f}" for k, v in parts.items()) + f"; sum={sum(parts.values()):.3f}; "
          f"K1's device time in the decoder {k1:.3f}, the rest of the decoder "
          f"{parts['decoder'] - k1:.3f}")


def tts_synthesis_phase(dev, _build, card: str, sd, held: dict):
    """TTSSynthesizer.synthesize at full widths: card vs the CPU plain path
    on a short text at noise 0; the 203-id text at 9-11 s in fp32 and bf16,
    noise 0.667 / 0.8, counted (K1 36, K2 4 a call); K1 and K2 on the
    inputs a call gave them (the 4480-frame budget) against their plain
    versions; wall, RTF, profile, breakdown; one SynthesizerTTS.
    voice_conversion of 10 s, its K1 and K2 modes held the same way."""
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer_tts import TTSSynthesizer
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    from vcvits_tpu_torch.ops.stft_mel import spectrogram

    cfg = load_config(CONFIG)
    hop, sr, m = cfg.data.hop_length, cfg.data.target_sampling_rate, cfg.model
    outs = []
    for device in (dev, "cpu"):
        tts = TTSSynthesizer(cfg, sd, device=device)
        outs.append(tts.synthesize(TTS_SHORT, sid=7, noise_scale=0.0, noise_scale_w=0.0,
                                   max_frames=120))
        del tts
    gpu, cpu = outs
    diff = float(np.abs(gpu - cpu).max()) if len(gpu) == len(cpu) else float("inf")
    level = float(np.abs(cpu).mean())
    print(f"TTS reference ('{TTS_SHORT}', noise 0, 120-frame budget, card kernels vs CPU plain "
          f"path, fp32): samples={len(gpu)} (CPU {len(cpu)}) max_abs_err={diff:.3e} "
          f"mean|y|={level:.3e}")
    if not diff <= SLICE_ATOL or not level > 1e-2 or len(gpu) == 0:
        raise AssertionError(f"TTS: card and CPU outputs differ by {diff:.3e} (limit "
                             f"{SLICE_ATOL}) at mean |y| {level:.3e}")

    per_call = {"mrf": len(m.upsample_rates) * launches_per_stage(m.resblock_dilation_sizes),
                "flow_coupling_reverse": 4}
    counts = dict.fromkeys(list(per_call) + ["flow_coupling_forward", "wn_segment"], 0)
    sid = SPEAKERS[1]
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype)[6:]
        tts = TTSSynthesizer(cfg, sd, dtype=dtype, device=dev)
        scale, frames = tts_length_scale(tts, sid)
        budget = tts.frame_budget(len(tts.encode_text(TTS_TEXT)), scale)

        def synth(seed=0):
            return tts.synthesize(TTS_TEXT, sid=sid, noise_scale=TTS_NOISE,
                                  noise_scale_w=TTS_NOISE_W, length_scale=scale, seed=seed)
        with kernel_inputs() as seen:
            synth()
        walls, samples = [], []
        for i in range(3):
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = synth(seed=i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            samples.append(len(wav))
            rose = {k: _build.LAUNCHES[k] for k in per_call}
            if rose != per_call:
                raise AssertionError(f"TTS {label}: launches {rose}, expected {per_call}")
            secs = len(wav) / sr
            if len(wav) % hop or not np.isfinite(wav).all() or not (
                    TTS_SECONDS[0] - 0.5 <= secs <= TTS_SECONDS[1] + 0.5):
                raise AssertionError(f"TTS {label}: {len(wav)} samples ({secs:.2f} s) or "
                                     f"non-finite output")
            for k, n in rose.items():
                counts[k] += n
        wall = float(np.mean(walls))
        print(f"TTS {label}: synthesize '{TTS_TEXT[:24]}...' ({len(tts.encode_text(TTS_TEXT))} "
              f"ids), noise {TTS_NOISE} / {TTS_NOISE_W}, length_scale {scale:.4f}: {frames} "
              f"frames = {frames * hop / sr:.2f} s (seed 0) in a {budget}-frame budget; "
              f"{wall * 1e3:.1f} ms per call over seeds 0-2 (" + ", ".join(
                  f"{n / sr:.2f} s" for n in samples) + f"), rtf={sum(samples) / sr / sum(walls):.2f}"
              f"x real time (their audio over their wall time) on {card}; launches a call "
              f"{per_call}")
        check_kernel_inputs(seen, f"TTS {label} synthesize", ("mrf", "flow_coupling_reverse"),
                            held)
        device_profile(synth, f"TTS {label} synthesize", card)
        tts_breakdown(tts, sid, scale, label)
        capped = frames + 16
        cuda_ms(lambda: tts.synthesize(TTS_TEXT, sid=sid, noise_scale=TTS_NOISE,
                                       noise_scale_w=TTS_NOISE_W, length_scale=scale,
                                       max_frames=capped), 1)
        t0 = time.perf_counter()
        for _ in range(3):
            tts.synthesize(TTS_TEXT, sid=sid, noise_scale=TTS_NOISE, noise_scale_w=TTS_NOISE_W,
                           length_scale=scale, max_frames=capped)
        torch.cuda.synchronize()
        print(f"TTS {label}: the same call with max_frames={capped} (the valid frames + 16, "
              f"not the default budget): {(time.perf_counter() - t0) / 3 * 1e3:.1f} ms per call "
              f"on {card}")
        del tts
        torch.cuda.empty_cache()

    # the flow swap of the TTS model: 10 s of speaker 3 to speaker 77, fp32
    tts = TTSSynthesizer(cfg, sd, device=dev)
    t = np.arange(PATH_A_PADDED) / sr
    wav = 0.3 * np.sin(2 * np.pi * 150 * t * (1 + 0.1 * t / t[-1]))
    y = torch.tensor(wav, dtype=torch.float32, device=dev)[None]
    spec = spectrogram(y, cfg.data.filter_length, hop, cfg.data.win_length)
    t_spec = spec.shape[1]
    _build.LAUNCHES.clear()
    with kernel_inputs() as seen, torch.inference_mode():
        o, y_mask, _ = tts.gen.voice_conversion(
            spec, torch.tensor([t_spec], device=dev), torch.tensor([3], device=dev),
            torch.tensor([77], device=dev),
            generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    vc_want = {"flow_coupling_reverse": 4, "flow_coupling_forward": 4, "wn_segment": 4,
               "mrf": per_call["mrf"]}
    rose = {k: _build.LAUNCHES[k] for k in vc_want}
    if rose != vc_want or o.shape[1] != t_spec * hop or not torch.isfinite(o).all():
        raise AssertionError(f"TTS voice_conversion: launches {rose} (expected {vc_want}), "
                             f"{o.shape[1]} samples for {t_spec} frames")
    for k, n in rose.items():
        counts[k] += n
    print(f"TTS voice_conversion (SynthesizerTTS, {t_spec} frames = {t_spec * hop / sr:.2f} s, "
          f"3 -> 77, fp32): finite, {o.shape[1]} samples, launches {rose} on {card}")
    check_kernel_inputs(seen, "TTS voice_conversion", vc_want, held)
    del tts
    torch.cuda.empty_cache()
    return counts


def tts_batch(cfg, b, rng, dev, text_bucket=192, seconds=8.0, lo_s=4.0):
    """A TTS batch as collate_tts pads it: random ids (60 .. text_bucket
    of them), harmonic tones on known f0 contours at 48 kHz (lo_s ..
    seconds long, hop-aligned) padded to `seconds`, the frame F0 target,
    speakers."""
    from vcvits_tpu_torch.text.symbols import symbols

    d = cfg.data
    hop, sr = d.hop_length, d.target_sampling_rate
    bucket = int(seconds * sr) // hop * hop
    text = np.zeros((b, text_bucket), np.int64)
    t_lens = rng.integers(min(60, text_bucket), text_bucket + 1, b)
    y = np.zeros((b, bucket), np.float32)
    y_lens = (rng.uniform(lo_s, seconds, b) * sr).astype(int) // hop * hop
    y_lens[0] = bucket
    pitch = np.zeros((b, bucket // hop), np.float32)
    for i in range(b):
        text[i, :t_lens[i]] = rng.integers(1, len(symbols), t_lens[i])
        n = y_lens[i]
        tt = np.arange(n) / sr
        f0 = rng.uniform(100, 300) * (1 + 0.1 * np.sin(2 * np.pi * 0.8 * tt))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        y[i, :n] = sum(0.25 / (k + 1) * np.sin((k + 1) * phase) for k in range(6)) \
            + 0.01 * rng.standard_normal(n)
        pitch[i, :n // hop] = f0[::hop][:n // hop]
    as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return {"text": as_t(text), "text_lengths": as_t(t_lens, torch.int32), "y_wav": as_t(y),
            "y_wav_lengths": as_t(y_lens, torch.int32), "pitch": as_t(pitch),
            "sid": as_t(rng.integers(0, d.n_speakers, b), torch.int64)}


TTS_TRAIN_STEPS = 4


def tts_train_steps(cfg, g_state, batch, dev, _build, card: str, dtype, held: dict):
    """TTS_TRAIN_STEPS steps of TTSTrainStep in `dtype`, counted, with K3,
    K5 and M1 held to their plain versions on the inputs step 1 gave them
    -> (launch counts, ms/step over steps 2-N, peak GiB)."""
    from vcvits_tpu_torch.train.tts_step import TTSTrainStep

    label = str(dtype)[6:]
    step = TTSTrainStep(cfg, device=dev, g_state=g_state, dtype=dtype)
    named = {f"gen.{n}": p for n, p in step.gen.named_parameters()}
    named.update({f"disc.{n}": p for n, p in step.disc.named_parameters()})
    before = {n: p.detach().clone() for n, p in named.items()}
    per_step = {"stft_mel": 1, "fused_gate": 2 * 16, "fused_gate_backward": 2 * 16,
                "monotonic_align": 1, "mrf": 0, "flow_coupling_reverse": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    walls, last = [], None
    for i in range(TTS_TRAIN_STEPS):
        t0 = time.perf_counter()
        with kernel_inputs() if i == 0 else contextlib.nullcontext(seen) as seen:
            metrics = step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise AssertionError(f"TTS step {label} {i + 1}: non-finite {bad}")
        if i == 0:
            still = [n for n in named if torch.equal(named[n], before[n])]
            if still:
                raise AssertionError(f"TTS step {label} 1: unchanged {still[:5]} ({len(still)})")
            print(f"TTS step {label} 1: all {len(named)} tensors changed")
            del before
        last = metrics
    counts = dict(_build.LAUNCHES)
    for k, n in per_step.items():
        if counts.get(k, 0) != n * TTS_TRAIN_STEPS:
            raise AssertionError(f"TTS step {label}: {k} launched {counts.get(k, 0)} times in "
                                 f"{TTS_TRAIN_STEPS} steps, expected {n * TTS_TRAIN_STEPS}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = np.mean(walls[1:]) * 1e3
    b, tx = batch["text"].shape
    print(f"TTS step {label}: {TTS_TRAIN_STEPS} steps at B={b}, text bucket {tx}, "
          f"{batch['y_wav'].shape[1] / 48000:.2f} s audio bucket, segment "
          f"{cfg.train.segment_size}: {ms:.1f} ms/step over steps 2-{TTS_TRAIN_STEPS} (step 1 "
          f"{walls[0] * 1e3:.1f} ms), peak memory {peak:.2f} GiB on {card}; launches per step "
          f"{ {k: counts.get(k, 0) / TTS_TRAIN_STEPS for k in per_step} }")
    print(f"TTS step {label} {TTS_TRAIN_STEPS} metrics: " + ", ".join(
        f"{k}={float(v):.5g}" for k, v in last.items()))
    check_kernel_inputs(seen, f"TTS step {label}", ("stft_mel", "fused_gate", "monotonic_align"),
                        held)
    parts = {}
    for _ in range(2):
        step(batch, timings=parts)
    print(f"TTS step {label} breakdown (_Sections, device ms per step, mean of 2 steps): "
          + ", ".join(f"{k}={v / 2:.3f}" for k, v in parts.items())
          + f"; sum={sum(parts.values()) / 2:.3f}")
    device_profile(lambda: step(batch), f"TTS step {label}", card)
    del step
    torch.cuda.empty_cache()
    return {k: counts.get(k, 0) for k in per_step}, ms, peak


def tts_train_phase(dev, _build, card: str, sd, held: dict):
    """TTSTrainStep at full widths: B 16, text bucket 192, 8 s audio,
    segment 16384, in bf16 (the shipped config) and fp32; then one B = 2
    step on the card and on the CPU, dropout off, injected draws."""
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.train.tts_step import TTSStepDraws, TTSTrainStep

    cfg = load_config(CONFIG)
    rng = np.random.default_rng(31)
    batch = tts_batch(cfg, cfg.train.batch_size, rng, dev)
    counts, runs = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        c, ms, peak = tts_train_steps(cfg, sd, batch, dev, _build, card, dtype, held)
        runs[str(dtype)[6:]] = (ms, peak)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    del batch
    print(f"TTS step: bfloat16 {runs['bfloat16'][0]:.1f} ms/step, {runs['bfloat16'][1]:.2f} GiB; "
          f"float32 {runs['float32'][0]:.1f} ms/step, {runs['float32'][1]:.2f} GiB on {card}")

    small = tts_batch(cfg, 2, rng, "cpu", text_bucket=40, seconds=1.0, lo_s=0.8)
    t_spec = small["y_wav"].shape[1] // cfg.data.hop_length
    seg = cfg.train.segment_size // cfg.data.hop_length
    draws = TTSStepDraws(
        eps=torch.tensor(rng.standard_normal((2, t_spec, cfg.model.inter_channels)),
                         dtype=torch.float32),
        e_q=torch.tensor(rng.standard_normal((2, 40, 2)), dtype=torch.float32),
        ids_str=torch.as_tensor(rng.integers(0, t_spec - seg + 1, 2)))
    cpu_ref = {}
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype)[6:]
        cpu_step = TTSTrainStep(cfg, device="cpu", g_state=sd, dtype=dtype, dropout=False)
        card_step = TTSTrainStep(cfg, device=dev, g_state=sd, d_state=cpu_step.disc.state_dict(),
                                 dtype=dtype, dropout=False)
        on_dev = TTSStepDraws(*(v.to(dev) for v in vars(draws).values()))
        got = card_step({k: v.to(dev) for k, v in small.items()}, on_dev)
        ref = cpu_step(small, draws)
        cpu_ref[dtype] = ref
        del cpu_step, card_step
        torch.cuda.empty_cache()
        keys = [k for k in ref if k.startswith("loss/") or k.startswith("grad_norm")]
        tol = TRAIN_RTOL if dtype == torch.float32 else TRAIN_RTOL_BF16
        rel = {k: abs(float(got[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-6)
               for k in keys}
        worst = max(rel, key=rel.get)
        print(f"TTS step reference {label} (B=2 x 1 s, 40 ids, dropout off, injected draws, card "
              f"kernels vs CPU plain path): {len(keys)} losses and grad norms, worst rel diff "
              f"{rel[worst]:.3e} ({worst}, limit {tol}); " + ", ".join(
                  f"{k} {float(got[k]):.6g} vs {float(ref[k]):.6g}" for k in keys))
        if not rel[worst] <= tol:
            raise AssertionError(f"TTS step {label}: {worst} differs by {rel[worst]:.3e} > {tol} "
                                 f"between the card and the CPU")
    return counts


def write_tts_corpus(tmp: str, n: int = 8, n_speakers: int = 4) -> str:
    """Synthetic 2-4 s clips at 48 kHz with a sentence each: path|sid|text."""
    from vcvits_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(41)
    words = TTS_TEXT.split()
    sr = 48000
    lines = []
    for i in range(n):
        t = np.arange(int(rng.uniform(2.05, 4.0) * sr)) / sr
        f0 = (110.0 + 45.0 * (i % n_speakers)) * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wav = sum(0.25 / (h + 1) * np.sin((h + 1) * phase) for h in range(6))
        wav = wav * (0.7 + 0.3 * np.sin(2 * np.pi * 0.5 * t)) + 0.01 * rng.standard_normal(len(t))
        path = os.path.join(tmp, f"tts{i}.wav")
        write_wav(path, wav.astype(np.float32), sr, subtype="PCM_16")
        start = int(rng.integers(0, max(len(words) - 12, 1)))
        lines.append(f"{path}|{i % n_speakers}|{' '.join(words[start:start + 12])}")
    fl = os.path.join(tmp, "tts_train.txt")
    with open(fl, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fl


def tts_loop_phase(dev, _build, card: str, held: dict):
    """TTSTrainer on configs/48k_base.json as shipped (bf16), batch 4, on 8
    synthetic WAVs: fit to 2 steps with validation and a checkpoint at 2,
    a second trainer resumes to 3, then `python -m
    vcvits_tpu_torch.cli.train_tts` to 4 and `python -m
    vcvits_tpu_torch.cli.infer_tts` from the workdir."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.ops.mrf import launches_per_stage
    from vcvits_tpu_torch.train.tts_trainer import TTSTrainer
    from vcvits_tpu_torch.utils.audio_io import read_wav

    with open(CONFIG) as f:
        raw = json.load(f)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        fl = write_tts_corpus(tmp)
        raw["train"].update(batch_size=4, log_interval=1, eval_interval=2,
                            checkpoint_interval=2)
        raw["data"]["cache_dir"] = os.path.join(tmp, "cache")
        cfg_path = os.path.join(tmp, "48k_base_tts.json")
        with open(cfg_path, "w") as f:
            json.dump(raw, f, indent=1)
        cfg = Config.from_dict(raw)
        workdir = os.path.join(tmp, "logs_tts")
        dtype = torch.bfloat16 if cfg.train.fp16_run else torch.float32
        trainer = TTSTrainer(cfg, workdir=workdir, device=dev, dtype=dtype)
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with kernel_inputs() as seen:
            end = trainer.fit(fl, max_steps=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        m = cfg.model
        per_fit = {"stft_mel": 2, "fused_gate": 64, "fused_gate_backward": 64,
                   "monotonic_align": 2, "mrf": len(m.upsample_rates) * launches_per_stage(
                       m.resblock_dilation_sizes), "flow_coupling_reverse": 4,
                   "mel_spectrogram": 1}
        rose = {k: counts.get(k, 0) for k in per_fit}
        if end != 2 or trainer.ckpt.all_steps() != [2] or rose != per_fit:
            raise AssertionError(f"TTSTrainer.fit: ended at {end}, checkpoints "
                                 f"{trainer.ckpt.all_steps()}, launches {rose} (expected "
                                 f"{per_fit}: 2 steps, one validation)")
        saved = trainer.ckpt.restore(2)
        print(f"TTS loop ({str(dtype)[6:]}, B=4, 8 WAVs): fit to step 2 with one validation "
              f"(synthesize + its mel) and a checkpoint, {wall:.1f} s incl. data prep (resample, "
              f"pYIN) on {card}; launches {rose}")
        # K5's backward is held through the inputs its forward recorded
        check_kernel_inputs(seen, "TTS loop fit",
                            [k for k in per_fit if k != "fused_gate_backward"], held)
        del trainer
        torch.cuda.empty_cache()
        resumed = TTSTrainer(cfg, workdir=workdir, device=dev, dtype=dtype)
        start = resumed.resume_or_init()
        bad = [k for k, v in saved["gen"].items()
               if not torch.equal(resumed.train_step.gen.state_dict()[k].cpu(), v)]
        end2 = resumed.fit(fl, max_steps=3)
        if start != 2 or bad or end2 != 3:
            raise AssertionError(f"TTS resume: from {start}, {len(bad)} tensors not as saved, "
                                 f"ended at {end2}")
        del resumed, saved
        torch.cuda.empty_cache()
        env = dict(os.environ)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "vcvits_tpu_torch.cli.train_tts", "-c", cfg_path,
                        "--filelist", fl, "--workdir", workdir, "--max-steps", "4"],
                       cwd=root, env=env, check=True, timeout=600)
        t_train = time.perf_counter() - t0
        out = os.path.join(tmp, "tts_out.wav")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "vcvits_tpu_torch.cli.infer_tts", TTS_TEXT, out,
                        "--workdir", workdir, "--sid", "2", "--max-frames", "400"],
                       cwd=root, env=env, check=True, timeout=600)
        t_infer = time.perf_counter() - t0
        from vcvits_tpu_torch.train.checkpoint import CheckpointManager

        last = CheckpointManager(os.path.join(workdir, "checkpoints")).latest_step()
        wav, sr = read_wav(out)
        if last != 4 or sr != 48000 or not 0 < len(wav) <= 400 * 512 or len(wav) % 512 \
                or not np.isfinite(wav).all():
            raise AssertionError(f"TTS CLIs: checkpoint {last}, output {len(wav)} samples at "
                                 f"{sr} Hz")
        print(f"TTS loop: resumed at 2 with every tensor as saved, reached 3; cli.train_tts "
              f"resumed to 4 in {t_train:.1f} s and cli.infer_tts wrote {len(wav) / sr:.2f} s "
              f"in {t_infer:.1f} s (each a new process: torch import, model, checkpoint) on "
              f"{card}")
    return {k: counts.get(k, 0) for k in per_fit}


# ------------------------------------------------------------------ base.json

BASE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "base.json")
BASE_BATCH = 4  # configs/base.json's train.batch_size
BASE_TRAIN_STEPS = 2
K1_FRAMES = (930, 4480)  # a 10 s conversion's decoder frames, and the TTS budget's
TP_TOL = 1e-4  # TP inference against world 1, max |err| / RMS, fp32
MULTI_RTOL = 1e-5  # a multi-rank step's metrics against the one-process step's
# ||grad err|| / ||grad|| per parameter group, a multi-rank step against the
# one-process step, both under deterministic algorithms: about 10x the
# largest faultless reading of (ii) and (iii) on the card, far below a
# collective left out (tools/torch_tp_precision.py). The ReLUs of the
# prior's FFNs and the decoder's leaky ReLUs turn the layout's
# rounding-sized change of the forward into larger gradient moves.
MULTI_GRAD_L2 = {"gen.enc_p": 3e-2, "gen.dec": 5e-3, "disc.mpd": 5e-4, "disc.msd": 5e-4}
MULTI_GRAD_L2_REST = 1e-4  # gen.flow, gen.emb_g, gen.enc_q


def grad_limit(group: str) -> float:
    return MULTI_GRAD_L2.get(group, MULTI_GRAD_L2_REST)


def off_groups(rec: dict) -> list:
    """The parameter groups of a multi-rank step (`_compare_steps` against
    one process) whose gradients are further off than their limit
    (`grad_limit`) in relative L2 norm."""
    return [g for g, r in rec["groups"].items() if r["l2"] > grad_limit(g)]


def repeats_itself(rec: dict) -> bool:
    """The one-process step run twice (`_compare_steps`) gave equal metrics
    and gradients, bit for bit."""
    return rec["metric_rel"] == 0.0 and all(r["top"] == 0.0 for r in rec["groups"].values())


def groups_line(groups: dict) -> str:
    """Per parameter group: relative L2 (its limit), max |err| / RMS, max
    |err| / largest, and the tensor with the largest |err|."""
    return "; ".join(f"{k} {r['l2']:.2e} ({grad_limit(k):g}) / {r['rms']:.2e} / {r['top']:.2e} "
                     f"({r['where']})" for k, r in groups.items())


REPLICA_ATOL = 1e-5  # the daemon's rows, 2 replicas against 1


def base_model(cfg, dev):
    """configs/base.json's seeded generator built on the card (init_weights
    draws there: about 1 B parameters), perturbed as `perturbed_state` does
    -> (model, seconds)."""
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = SynthesizerSVC.from_config(cfg, device=dev, seed=0, init_on_device=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("flow.") and ".post." in name:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.05)
            elif name.startswith("dec.") and name.endswith(".g"):
                p.mul_(3.0)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def k1_stage_errors(dec, dev) -> dict:
    """K1 in fp32 against its plain version per decoder stage, at each of
    K1_FRAMES latent frames (random z from a seed; each stage's input is
    the plain path's): {frames: [max |err| / RMS per stage]}."""
    from vcvits_tpu_torch.ops.mrf import mrf, mrf_plain

    out = {}
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.inference_mode():
        stages = dec.mrf_weights()
        for frames in K1_FRAMES:
            x = dec.conv_pre(torch.randn(1, frames, dec.conv_pre.v.shape[1], generator=gen,
                                         device=dev))
            errs = []
            for i, blocks in enumerate(stages):
                x = getattr(dec, f"up_{i}")(x, act_slope=0.1).contiguous()
                ref = mrf_plain(x, blocks, dec.kernel_sizes, dec.dilations)
                errs.append(rel_err(mrf(x, blocks, dec.kernel_sizes, dec.dilations), ref)[1])
                x = ref
            out[frames] = errs
    return out


def prior_profiles(vcs, wav, pitch, label: str, card: str) -> None:
    """An op-level device profile of HuBERT + prior (`enc_p`) of one 10 s
    request, in each dtype of `vcs`, one after the other in this call."""
    for dtype, vc in vcs.items():
        dev = vc.device
        x = torch.as_tensor(wav, device=dev)[None]
        lens = torch.tensor([len(wav)], device=dev)
        pit = torch.as_tensor(pitch, device=dev)[None]
        with torch.no_grad():
            vc.gen.enc_p(x, lens, pit)  # warm
            device_profile(lambda: vc.gen.enc_p(x, lens, pit),
                           f"HuBERT + prior {label} {str(dtype)[6:]}", card, top=8)


def base_json_phase(dev, _build, card: str, held: dict):
    """configs/base.json at full width on the card: seeded weights built on
    the card, convert and voice_conversion of 10 s in fp32 and bf16 with a
    breakdown, a daemon batch of 4 x 10 s, BASE_TRAIN_STEPS train steps at
    the config's batch in bf16 and fp32, the validation log-mel (K4), every
    kernel held to its plain version on these paths' own inputs, the card
    against the CPU plain path on 1 s at full depth, and the two open
    measurements (K1's fp32 error per stage at 930 and 4480 frames; HuBERT
    + prior's op profile in fp32 and bf16 at both HuBERT sizes)."""
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.dsp.resample import resample
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.models.synthesizer import hubert_config_for
    from vcvits_tpu_torch.train import trainer as trainer_mod
    from vcvits_tpu_torch.utils.audio_io import read_wav

    cfg = load_config(BASE_CONFIG)
    hc = hubert_config_for(cfg.model.hubert_channels)
    model, init_s = base_model(cfg, dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"base_json: configs/base.json at full width, HuBERT {hc.num_layers} x "
          f"{hc.hidden_size} ({hc.num_heads} heads, FFN {hc.intermediate_size}), hidden "
          f"{cfg.model.hidden_channels}, inter {cfg.model.inter_channels}, "
          f"{cfg.data.n_mel_channels} mels: {n_params / 1e9:.4f} B parameters seeded on the "
          f"card in {init_s:.2f} s on {card}")
    sd = model.state_dict()
    vcs = {dt: VoiceConverter(cfg, sd, dtype=dt, device=dev)
           for dt in (torch.float32, torch.bfloat16)}
    d = cfg.data
    counts = {}

    def add(delta):
        for k, v in delta.items():
            counts[k] = counts.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp, kernel_inputs() as seen:
        src = write_sources(tmp, n=1)[0]
        wav, true_len, pitch = vcs[torch.float32].prepare_source(src)
        wav48 = resample(*read_wav(src), d.target_sampling_rate)
        _build.LAUNCHES.clear()
        outs = {}
        for dtype, vc in vcs.items():
            label = str(dtype)[6:]
            out = vc.convert_array(wav, pitch, 3, true_len)
            vco = vc.voice_conversion_array(wav48, 3, 77)
            torch.cuda.synchronize()
            for what, o in (("convert", out), ("voice_conversion", vco)):
                if not np.isfinite(o).all() or len(o) == 0:
                    raise AssertionError(f"base_json {label} {what}: {len(o)} samples, finite "
                                         f"{np.isfinite(o).all()}")
            outs[dtype] = out
            for what, fn in (("convert_array", lambda: vc.convert_array(wav, pitch, 3, true_len)),
                             ("voice_conversion_array",
                              lambda: vc.voice_conversion_array(wav48, 3, 77))):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                print(f"base_json {label}: {what} of 10 s {ms:.1f} ms, rtf "
                      f"{10000 / ms:.2f}x real time on {card}")
            breakdown(vc, wav, pitch, f"base_json {label}")
        # a daemon batch of 4 x 10 s, fp32
        reqs = serve_sources(cfg, np.random.default_rng(12), (10.0,) * BASE_BATCH)
        with recording_daemon(vcs[torch.float32], max_batch=BASE_BATCH,
                              window_ms=1000.0) as daemon:
            t0 = time.perf_counter()
            futs = [daemon.submit(w, p, n, speaker_id=s, noise_scale=0.0)
                    for w, p, n, s in reqs]
            res = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            sizes = [len(b) for b in daemon.batches]
        if sizes != [BASE_BATCH] or not all(np.isfinite(r).all() for r in res):
            raise AssertionError(f"base_json daemon: batches {sizes}")
        print(f"base_json daemon fp32: one batch of {BASE_BATCH} x 10 s in {wall * 1e3:.1f} ms "
              f"({BASE_BATCH / wall:.2f} requests/s) on {card}")
        # the validation log-mel of a converted clip (K4 at 256 mels)
        y = torch.as_tensor(outs[torch.float32][None, : len(outs[torch.float32]) // d.hop_length
                                                 * d.hop_length], device=dev)
        mel = trainer_mod.mel_spectrogram(y, d.filter_length, d.n_mel_channels,
                                          d.target_sampling_rate, d.hop_length, d.win_length,
                                          d.mel_fmin, d.mel_fmax)
        if mel.shape[-1] != d.n_mel_channels or not torch.isfinite(mel).all():
            raise AssertionError(f"base_json validation mel: {tuple(mel.shape)}")
        add(dict(_build.LAUNCHES))
        batch = train_batch(cfg, BASE_BATCH, 2.0, 4.0, np.random.default_rng(13), dev)
        for dtype in (torch.bfloat16, torch.float32):
            c, ms, peak = train_steps(cfg, sd, batch, dev, _build, card, dtype,
                                      n_steps=BASE_TRAIN_STEPS, path="base_json")
            add(c)
        del batch
        seen_calls = {k: len(v) for k, v in seen.items() if v}
        check_kernel_inputs(seen, "base_json", ("mrf", "flow_coupling_reverse",
                                                "flow_coupling_forward", "wn_segment",
                                                "fused_gate", "stft_mel", "mel_spectrogram"),
                            held)
    print(f"base_json: kernels held on the path's inputs at {seen_calls} distinct shapes; "
          f"launches {json.dumps(counts)}")
    # the card against the CPU plain path, 1 s at full depth, fp32
    rng = np.random.default_rng(14)
    n = 16000
    t = np.arange(n) / 16000
    w1 = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(n)).astype(np.float32)
    p1 = np.full(n // 320, 120, np.int64)
    eps = rng.standard_normal((1, 94, cfg.model.inter_channels)).astype(np.float32)
    gpu = vcs[torch.float32].convert_array(w1, p1, 7, noise_scale=0.8, eps=eps)
    del vcs[torch.bfloat16]
    t0 = time.perf_counter()
    cpu_vc = VoiceConverter(cfg, {k: v.cpu() for k, v in sd.items()}, device="cpu")
    cpu = cpu_vc.convert_array(w1, p1, 7, noise_scale=0.8, eps=eps)
    cpu_s = time.perf_counter() - t0
    del cpu_vc
    diff = float(np.abs(gpu - cpu).max())
    print(f"base_json reference (1 s at full depth, card kernels vs CPU plain path, fp32): "
          f"samples={len(gpu)} max_abs_err={diff:.3e} (limit {SLICE_ATOL}) mean|y|="
          f"{float(np.abs(cpu).mean()):.3e}; the CPU took {cpu_s:.1f} s")
    if len(gpu) != len(cpu) or not diff <= SLICE_ATOL or not np.abs(cpu).mean() > 1e-2:
        raise AssertionError(f"base_json: card and CPU differ by {diff:.3e}")
    # K1's fp32 error against T, and HuBERT + prior's profile in each dtype
    for frames, errs in k1_stage_errors(vcs[torch.float32].gen.dec, dev).items():
        print(f"K1 fp32 max |err| / RMS per decoder stage at {frames} frames (base.json's "
              f"perturbed decoder): " + ", ".join(f"stage {i} {e:.3e}" for i, e in enumerate(errs))
              + f" (limit {MRF_TOL[torch.float32]})")
    base_vcs = {dt: VoiceConverter(load_config(CONFIG), perturbed_state(load_config(CONFIG)),
                                   dtype=dt, device=dev) for dt in (torch.float32, torch.bfloat16)}
    prior_profiles(base_vcs, wav, pitch, "HuBERT base 12 x 768 (48k_base)", card)
    del base_vcs
    vcs[torch.bfloat16] = VoiceConverter(cfg, sd, dtype=torch.bfloat16, device=dev)
    prior_profiles(vcs, wav, pitch, "HuBERT XTRALARGE 48 x 1280 (base.json)", card)
    del vcs, sd, model
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ multi-GPU

def frozen_lr(path: str):
    """The config at `path` with learning rate 0: the step's gradients are
    the same, and its D half sees the same generator on both sides of a
    comparison (AdamW's first update moves a parameter by about lr x
    sign(g), and a near-zero generator gradient whose sign differs between
    two summation orders would move the D half's input by 2 lr)."""
    from vcvits_tpu_torch.config import Config, load_config

    raw = load_config(path).to_dict()
    raw["train"]["learning_rate"] = 0.0
    return Config.from_dict(raw)


def _rank_device(rank: int) -> torch.device:
    """A rank's card (its own under NCCL, shared round-robin under gloo),
    TF32 off, deterministic algorithms. By default the one-process base.json
    step differs from itself run again: HuBERT XTRALARGE's forward by
    5.6e-6 of its largest output, and the ReLUs of the prior's FFNs turn
    that into gradients 7.8e-3 of enc_p's largest apart
    (tools/torch_grad_determinism.py). Deterministic, it repeats itself bit
    for bit, so a multi-rank step's distance from it is the layout's."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS starts
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    # the one op flagged: each sample of a reflection pad's input takes at
    # most two addends, whose sum does not depend on their order
    warnings.filterwarnings("ignore", message="reflection_pad1d_backward_out_cuda")
    return dev


def _grads(step) -> dict:
    """Every gradient of a step, whole (gathered where sharded), on the host."""
    from vcvits_tpu_torch.parallel.mesh import full_tensor

    out = {}
    for side, module, tp in (("gen", step.gen, step.g_tp), ("disc", step.disc, step.d_tp)):
        for name, p in module.named_parameters():
            if p.grad is not None:
                out[f"{side}.{name}"] = full_tensor(p.grad, tp.get(name), step.mesh).cpu()
    return out


def _compare_steps(m, g, ref_m, ref_g) -> dict:
    """A multi-rank step against one process: the worst metric's relative
    error, and per parameter group (a model's top-level module: gen.enc_p,
    gen.flow, ..., disc.mpd, disc.msd) the gradients' relative L2 error
    ||err|| / ||grad|| (held), max |err| over the group's RMS and over its
    largest gradient, and the tensor with the largest |err|. Max |err|
    alone cannot be held tight: a rounding-sized change of the forward
    flips a ReLU somewhere, and the heavy-tailed gradients (max / RMS up
    to 1e3) move a whole row by a share of their largest."""
    worst_m = max(((abs(m[k] - v) / max(abs(v), 1e-12), k) for k, v in ref_m.items()
                   if abs(v) > 1e-6), default=(0.0, ""))
    acc = {}
    for k, v in ref_g.items():
        name = ".".join(k.split(".")[:2])
        d = (g[k] - v).double()
        e2, g2, n, top, err, where = acc.get(name, (0.0, 0.0, 0, 0.0, -1.0, ""))
        e = float(d.abs().max())
        acc[name] = (e2 + float(d.pow(2).sum()), g2 + float(v.double().pow(2).sum()),
                     n + v.numel(), max(top, float(v.abs().max())),
                     max(err, e), k if e > err else where)
    groups = {name: {"l2": (e2 / max(g2, 1e-300)) ** 0.5,
                     "rms": err / max((g2 / n) ** 0.5, 1e-30),
                     "top": err / max(top, 1e-30), "where": where}
              for name, (e2, g2, n, top, err, where) in acc.items()}
    return {"metric_rel": worst_m[0], "metric": worst_m[1], "n_grads": len(ref_g),
            "same_grads": set(g) == set(ref_g), "groups": groups,
            "worst": max(groups, key=lambda k: groups[k]["l2"])}


def dp_rank(rank: int, n: int, batch_size: int) -> dict:
    """(ii) One 48k_base fp32 step at `batch_size` over n data ranks against
    the one-process step with the same seed and batch (rank 0 runs both;
    learning rate 0, `frozen_lr`), then a second step timed."""
    from vcvits_tpu_torch.ops import _build
    from vcvits_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vcvits_tpu_torch.train.step import TrainStep

    dev = _rank_device(rank)
    cfg = frozen_lr(CONFIG)
    batch = train_batch(cfg, batch_size, 2.0, 4.0, np.random.default_rng(31), dev)
    out = {}
    if rank == 0:
        ref = TrainStep(cfg, device=dev, seed=0)
        ref_m = {k: float(v) for k, v in ref(batch).items()}
        ref_g = _grads(ref)
        del ref
        again = TrainStep(cfg, device=dev, seed=0)  # the one process against itself
        out["self"] = _compare_steps({k: float(v) for k, v in again(batch).items()},
                                     _grads(again), ref_m, ref_g)
        del again
        torch.cuda.empty_cache()
    mesh = make_mesh(n, 1)
    step = TrainStep(cfg, device=dev, seed=0, mesh=mesh)
    local = shard_batch(batch, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.LAUNCHES.clear()
    m = {k: float(v) for k, v in step(local).items()}
    torch.cuda.synchronize()
    out["launches"] = dict(_build.LAUNCHES)
    if rank == 0:
        out.update(_compare_steps(m, _grads(step), ref_m, ref_g))
    t0 = time.perf_counter()
    step(local)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    mesh.agree(False)
    return out


def tp_rank(rank: int, n: int) -> dict:
    """(iii) base.json over n model ranks: a 10 s convert (noise 0) and one
    fp32 step at the config's batch (learning rate 0, `frozen_lr`) against
    world 1 (rank 0 runs those first); K1 and K2 held on the TP
    inference's own inputs (K2's weights gathered from the shards)."""
    from vcvits_tpu_torch.ops import _build
    from vcvits_tpu_torch.parallel.mesh import make_mesh
    from vcvits_tpu_torch.train.step import TrainStep

    dev = _rank_device(rank)
    cfg = frozen_lr(BASE_CONFIG)
    model, init_s = base_model(cfg, dev)
    sd = model.state_dict()
    (wav, pitch, true_len, spk), = serve_sources(cfg, np.random.default_rng(41), (10.0,))
    x = torch.as_tensor(wav, device=dev)[None]
    lens = torch.tensor([true_len], dtype=torch.int32, device=dev)
    pit = torch.as_tensor(pitch, device=dev)[None]
    sid = torch.tensor([spk], device=dev)
    batch = train_batch(cfg, BASE_BATCH, 2.0, 4.0, np.random.default_rng(42), dev)
    out = {"init_s": init_s}
    if rank == 0:
        model.eval()
        with torch.no_grad():
            o_ref = model.infer(x, lens, pit, sid, noise_scale=0.0)[0].float()
        ref = TrainStep(cfg, device=dev, g_state=sd)
        ref_m = {k: float(v) for k, v in ref(batch).items()}
        ref_g = _grads(ref)
        del ref
        again = TrainStep(cfg, device=dev, g_state=sd)  # world 1 against itself
        out["self"] = _compare_steps({k: float(v) for k, v in again(batch).items()},
                                     _grads(again), ref_m, ref_g)
        del again
    del model
    torch.cuda.empty_cache()
    mesh = make_mesh(1, n)
    step = TrainStep(cfg, device=dev, g_state=sd, mesh=mesh)
    del sd
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.LAUNCHES.clear()
    with kernel_inputs() as seen:
        step.gen.eval()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = step.gen.infer(x, lens, pit, sid, noise_scale=0.0)[0].float()
            torch.cuda.synchronize()
            out["infer_ms"] = (time.perf_counter() - t0) * 1e3
        step.gen.train()
        m = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        out["launches"] = dict(_build.LAUNCHES)
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        g = _grads(step)
        held = {}
        check_kernel_inputs(seen, f"multi_gpu TP rank {rank}",
                            ("mrf", "flow_coupling_reverse"), held)
        out["held"] = held
    if rank == 0:
        out.update(_compare_steps(m, g, ref_m, ref_g))
        out["infer_rel"] = rel_err(o, o_ref)[1]
        out["n_sharded"] = len(step.g_tp) + len(step.d_tp)
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    mesh.agree(False)
    return out


def replica_phase(dev, card: str) -> dict:
    """(iv) ServingDaemon with 2 replicas against 1 on 48k_base's perturbed
    weights: 4 x 10 s requests at noise 0 in one batch, fp32."""
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.ops import _build
    from vcvits_tpu_torch.serving import ServingDaemon

    cfg = load_config(CONFIG)
    vc = VoiceConverter(cfg, perturbed_state(cfg), device=dev)
    reqs = serve_sources(cfg, np.random.default_rng(51), (10.0,) * 4)
    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i % n_cards}" for i in range(2)]
    outs, counts = {}, {}
    for label, devs in (("1 replica", None), ("2 replicas", devices)):
        with ServingDaemon(vc, max_batch=4, window_ms=1000.0, devices=devs) as daemon:
            warm = [daemon.submit(w, p, n, speaker_id=s, noise_scale=0.0) for w, p, n, s in reqs]
            [f.result(timeout=600) for f in warm]
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            futs = [daemon.submit(w, p, n, speaker_id=s, noise_scale=0.0) for w, p, n, s in reqs]
            outs[label] = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        for k, v in _build.LAUNCHES.items():
            counts[k] = counts.get(k, 0) + v - before.get(k, 0)
        print(f"multi_gpu (iv) daemon, {label} on {devs or [str(vc.device)]}: one batch of 4 x "
              f"10 s in {wall * 1e3:.1f} ms, {4 / wall:.2f} requests/s on {card}")
    errs = [float(np.abs(a - b).max()) for a, b in zip(outs["2 replicas"], outs["1 replica"])
            if a.shape == b.shape]
    if len(errs) != 4 or max(errs) > REPLICA_ATOL:
        raise AssertionError(f"multi_gpu (iv): 2 replicas differ from 1 by {errs} "
                             f"(limit {REPLICA_ATOL})")
    print(f"multi_gpu (iv): 2 replicas against 1, max |err| {max(errs):.3e} (limit "
          f"{REPLICA_ATOL})")
    del vc
    torch.cuda.empty_cache()
    return counts


def multi_gpu_phase(dev, _build, card: str) -> dict:
    """(ii)-(v) of the multi-GPU slice: two ranks over gloo sharing the card
    when there is one (NCCL refuses two ranks on one card), over NCCL on
    two cards otherwise; every rank loads the kernels built before."""
    from vcvits_tpu_torch.parallel.dryrun import dryrun_multigpu, launch

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    counts = {}

    def add(delta):
        for k, v in delta.items():
            counts[k] = counts.get(k, 0) + v

    t0 = time.perf_counter()
    dp = launch(dp_rank, 2, 16, backend=backend, timeout=900)
    r0 = dp[0]
    add(r0["launches"])
    print(f"multi_gpu (ii) DP=2 over {backend}, 48k_base fp32 step at B=16 (8 rows a rank) "
          f"against one process, deterministic algorithms: worst metric rel err "
          f"{r0['metric_rel']:.3e} ({r0['metric']}; limit {MULTI_RTOL}), worst group's grad "
          f"||err|| / ||grad|| {r0['groups'][r0['worst']]['l2']:.3e} ({r0['worst']}; limit "
          f"{grad_limit(r0['worst'])}; {r0['n_grads']} tensors); the one process run twice equal: "
          f"{repeats_itself(r0['self'])}; step {r0['step_ms']:.1f} ms; peak GiB per rank "
          f"{[round(r['peak_gib'], 3) for r in dp]} on {card} ({time.perf_counter() - t0:.1f} s)")
    print(f"multi_gpu (ii) per group (||err|| / ||grad|| (limit), max |err| / RMS, max |err| / "
          f"largest (where)): {groups_line(r0['groups'])}")
    if not repeats_itself(r0["self"]):
        raise AssertionError(f"multi_gpu (ii): the one-process step differs from itself: "
                             f"{r0['self']}")
    if not (r0["same_grads"] and r0["metric_rel"] <= MULTI_RTOL and not off_groups(r0)):
        raise AssertionError(f"multi_gpu (ii): the DP step is off: {off_groups(r0)} {r0}")
    t0 = time.perf_counter()
    tp = launch(tp_rank, 2, backend=backend, timeout=1200)
    r0 = tp[0]
    add(r0["launches"])
    print(f"multi_gpu (iii) TP=2 over {backend}, base.json ({r0['n_sharded']} tensors sharded): "
          f"10 s convert max |err| / RMS {r0['infer_rel']:.3e} (limit {TP_TOL}) in "
          f"{r0['infer_ms']:.1f} ms; fp32 step at B={BASE_BATCH} against world 1, deterministic "
          f"algorithms: worst metric rel err {r0['metric_rel']:.3e} ({r0['metric']}; limit "
          f"{MULTI_RTOL}), worst group's grad ||err|| / ||grad|| "
          f"{r0['groups'][r0['worst']]['l2']:.3e} ({r0['worst']}; limit "
          f"{grad_limit(r0['worst'])}); world 1 "
          f"run twice equal: {repeats_itself(r0['self'])}; step {r0['step_ms']:.1f} ms; peak GiB "
          f"per rank {[round(r['peak_gib'], 3) for r in tp]}; K1/K2 held {r0['held']} on {card} "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"multi_gpu (iii) per group (||err|| / ||grad|| (limit), max |err| / RMS, max |err| / "
          f"largest (where)): {groups_line(r0['groups'])}")
    if not repeats_itself(r0["self"]):
        raise AssertionError(f"multi_gpu (iii): world 1 differs from itself: {r0['self']}")
    if not (r0["same_grads"] and r0["infer_rel"] <= TP_TOL and r0["metric_rel"] <= MULTI_RTOL
            and not off_groups(r0)):
        raise AssertionError(f"multi_gpu (iii): the TP paths are off: {off_groups(r0)} {r0}")
    add(replica_phase(dev, card))
    t0 = time.perf_counter()
    rec = dryrun_multigpu(2)
    add(rec["launches"])
    print(f"multi_gpu (v) dryrun_multigpu(2) over {rec['backend']}: "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    return counts


def torchrun_phase(train_fl: str, val_fl: str, cache: str, tmp: str, card: str) -> None:
    """(i) cli.train --distributed under torchrun over NCCL, one rank a card
    (world = the card count), on configs/48k_base.json with its data paths
    changed (batch 4): 2 steps, then a second run that restores them and
    takes one."""
    n = torch.cuda.device_count()
    with open(CONFIG) as f:
        raw = json.load(f)
    raw["data"].update(training_files=train_fl, validation_files=val_fl, cache_dir=cache)
    cfg_path = os.path.join(tmp, "48k_base_torchrun.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    workdir = os.path.join(tmp, "torchrun")
    extra = ["--model-parallel", "2"] if n % 2 == 0 and n >= 2 else []
    for steps in (2, 3):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n}", "-m", "vcvits_tpu_torch.cli.train", "-c", cfg_path,
               "--workdir", workdir, "--max-steps", str(steps), "--batch-size", "4", "-s",
               "--distributed", *extra]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                             env={**os.environ, "OMP_NUM_THREADS": "1"})
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            print(run.stdout[-3000:], run.stderr[-6000:], file=sys.stderr)
            raise AssertionError(f"multi_gpu (i): torchrun exited {run.returncode}")
        ckpts = os.path.join(workdir, "checkpoints")
        done = sorted(int(s) for s in os.listdir(ckpts) if s.isdigit()) or [None]
        resumed = "resumed from step 2" in run.stderr
        print(f"multi_gpu (i) torchrun --nproc-per-node={n} cli.train --distributed {' '.join(extra)}"
              f" --max-steps {steps} over NCCL: exit 0 in {wall:.1f} s, checkpoints {done}"
              + (f", resumed from step 2: {resumed}" if steps == 3 else "") + f" on {card}")
        if done[-1] != steps or (steps == 3 and not resumed):
            raise AssertionError(f"multi_gpu (i): checkpoints {done} after --max-steps {steps}")


def batch_keys(res, suffix: str = "") -> dict:
    """A kernel's figures at the daemon's batch of 16 for the kernels line."""
    return {f"{k}_b16{suffix}": res[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                  "max_abs_err")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = info_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_phase(_build)
    rng = np.random.default_rng(0)
    flow = flow_phase(rng, dev, _build)
    mrf_res = mrf_phase(rng, dev, _build)
    stft = stft_phase(rng, dev, _build)
    gate = gate_phase(rng, dev, _build)
    mel = mel_phase(rng, dev, _build)
    batch16 = batch_phase(rng, dev, _build)
    int8 = int8_kernel_phase(dev, _build)
    mas = mas_phase(rng, dev, _build)
    paths = {"convert": slice_phase(dev, _build, card), "voice_conversion": path_a_phase(
        dev, _build, card)}
    sd = perturbed_state(load_config(CONFIG))
    paths["serve"] = serve_phase(dev, _build, card, sd)
    paths["stream"] = streaming_phase(dev, _build, card, sd)
    http_phase(dev, _build, card, sd)
    paths["int8_convert"] = int8_convert_phase(dev, _build, card, sd)
    paths["int8_serve"] = int8_serve_phase(dev, _build, card, sd)
    del sd
    paths["train_step"], _ = path_b_phase(dev, _build, card)
    paths["accumulation"] = accumulation_phase(dev, _build, card)
    paths["training_loop"] = path_c_phase(dev, _build, card)
    tts_sd = perturbed_tts_state(load_config(CONFIG))
    held = {}  # each kernel's worst max |err| on the TTS paths' own inputs
    paths["tts_synthesis"] = tts_synthesis_phase(dev, _build, card, tts_sd, held)
    paths["tts_train_step"] = tts_train_phase(dev, _build, card, tts_sd, held)
    paths["tts_loop"] = tts_loop_phase(dev, _build, card, held)
    del tts_sd
    t_phase = time.perf_counter()
    held_base = {}  # the same on the base_json paths' inputs
    paths["base_json"] = base_json_phase(dev, _build, card, held_base)
    print(f"phase base_json: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    paths["multi_gpu"] = multi_gpu_phase(dev, _build, card)
    print(f"phase multi_gpu: {time.perf_counter() - t_phase:.1f} s")
    counts, tts, new = {}, {}, {"base_json": {}, "multi_gpu": {}}
    for path, path_counts in paths.items():
        for k, v in path_counts.items():
            counts[k] = counts.get(k, 0) + v
            if path.startswith("tts_"):
                tts[k] = tts.get(k, 0) + v
            if path in new:
                new[path][k] = new[path].get(k, 0) + v
    print(f"main-path launches by path: {json.dumps(paths)}; all phases "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    f32, b16 = mrf_res[torch.float32], mrf_res[torch.bfloat16]
    # K2's modes: the coupling reverse replaces the Pallas kernel; the
    # forward and the WaveNet segment replace flax module paths whose gate is K5
    REPLACES = {
        "flow_coupling_reverse": ("vcvits_tpu/ops/flow_pallas.py:137",
                                  "vcvits_tpu/ops/flow_pallas.py:126 (_coupling_reverse)"),
        "flow_coupling_forward": ("vcvits_tpu/ops/fused_gate.py:44",
                                  "vcvits_tpu/models/flow.py:34 (ResidualCouplingLayer, "
                                  "forward), its WN's gate K5"),
        "wn_segment": ("vcvits_tpu/ops/fused_gate.py:44",
                       "vcvits_tpu/models/wavenet.py:33 (WN, the posterior's), its gate K5")}
    kernels = [
        {"name": "mrf", "route": "cuda", "source": "vcvits_tpu_torch/csrc/mrf.cu",
         "replaces": "vcvits_tpu/ops/mrf_pallas.py:134", "launches": counts.get("mrf", 0),
         "launches_tts": tts.get("mrf", 0),
         "max_abs_err": f32["max_abs_err"], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
         "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"], "library_ms": None,
         "device_ms": f32["device_ms"], "bound_ms_cuda_cores": f32["bound_ms_cuda_cores"],
         "bound_ms_3xtf32": f32["bound_ms_3xtf32"], "ms_bf16": b16["ms"],
         "device_ms_bf16": b16["device_ms"], "plain_ms_bf16": b16["plain_ms"],
         "bound_ms_bf16": b16["bound_ms"], "max_abs_err_bf16": b16["max_abs_err"],
         **batch_keys(batch16[("mrf", torch.float32)]),
         **batch_keys(batch16[("mrf", torch.bfloat16)], "_bf16")},
    ]
    for name in ("flow_coupling_reverse", "flow_coupling_forward", "wn_segment"):
        one, two = flow[(name, 1, FLOW_HID)], flow[(name, 2, FLOW_HID)]
        entry = {"name": name, "route": "cuda", "source": "vcvits_tpu_torch/csrc/flow_coupling.cu",
                 "replaces": REPLACES[name][0], "replaces_path": REPLACES[name][1],
                 "launches": counts.get(name, 0), "launches_tts": tts.get(name, 0),
                 "max_abs_err": max(one["max_abs_err"], two["max_abs_err"]), "ms": one["ms"],
                 "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
                 "bound_by": one["bound_by"], "library_ms": None, "device_ms": one["device_ms"],
                 "bound_ms_cuda_cores": one["bound_ms_cuda_cores"],
                 "l2_weight_bytes": one["l2_weight_bytes"], "ms_b2": two["ms"],
                 "device_ms_b2": two["device_ms"], "bound_ms_b2": two["bound_ms"]}
        if name == "flow_coupling_reverse":
            wide, b16 = flow[(name, 1, 256)], flow[(name + "_bf16", 1, FLOW_HID)]
            entry.update(ms_h256=wide["ms"], device_ms_h256=wide["device_ms"],
                         bound_ms_h256=wide["bound_ms"], max_abs_err_h256=wide["max_abs_err"],
                         ms_bf16_io=b16["ms"], max_abs_err_bf16_io=b16["max_abs_err"],
                         rel_rms_err_bf16_io=b16["rel_err"],
                         **batch_keys(batch16["flow_coupling_reverse"]))
        kernels.append(entry)
    train, vc = stft["train 16 x 4 s"], stft["vc 1 x 10.08 s"]
    kernels.append(
        {"name": "stft_mel", "route": "cuda", "source": "vcvits_tpu_torch/csrc/stft_mel.cu",
         "replaces": "vcvits_tpu/ops/stft_pallas.py:196", "launches": counts.get("stft_mel", 0),
         "launches_tts": tts.get("stft_mel", 0),
         "max_abs_err": max(train["max_abs_err"], vc["max_abs_err"]), "ms": train["ms"],
         "plain_ms": train["plain_ms"], "bound_ms": train["bound_ms"],
         "bound_by": train["bound_by"], "library_ms": train["library_ms"],
         "ms_vc": vc["ms"], "plain_ms_vc": vc["plain_ms"], "bound_ms_vc": vc["bound_ms"],
         "library_ms_vc": vc["library_ms"]})
    kernels.append(
        {"name": "fused_gate", "route": "cuda", "source": "vcvits_tpu_torch/csrc/fused_gate.cu",
         "replaces": "vcvits_tpu/ops/fused_gate.py:44", "launches": counts.get("fused_gate", 0),
         "launches_backward": counts.get("fused_gate_backward", 0),
         "launches_tts": tts.get("fused_gate", 0),
         "launches_backward_tts": tts.get("fused_gate_backward", 0), **gate,
         "library_ms": None})
    val, big = mel["validation 1 x 10 s"], mel["16 x 4 s"]
    kernels.append(
        {"name": "mel_spectrogram", "route": "cuda", "source": "vcvits_tpu_torch/csrc/stft_mel.cu",
         "replaces": "vcvits_tpu/ops/stft_pallas.py:107",
         "launches": counts.get("mel_spectrogram", 0),
         "launches_tts": tts.get("mel_spectrogram", 0),
         "max_abs_err": max(val["max_abs_err"], big["max_abs_err"]), "ms": val["ms"],
         "plain_ms": val["plain_ms"], "bound_ms": val["bound_ms"], "bound_by": val["bound_by"],
         "library_ms": val["library_ms"], "max_abs_err_vs_k3": max(val["vs_k3"], big["vs_k3"]),
         "ms_16x4s": big["ms"], "plain_ms_16x4s": big["plain_ms"],
         "bound_ms_16x4s": big["bound_ms"], "library_ms_16x4s": big["library_ms"]})
    for name, key in (("int8_conv1d", "q1"), ("row_absmax", "q2")):
        f32, b16 = int8[(1, torch.float32)], int8[(1, torch.bfloat16)]
        big = int8[(SERVE_BATCH, torch.float32)]
        bound = "bound_ms" if key == "q1" else "q2_bound_ms"
        kernels.append(
            {"name": name, "route": "cuda", "source": "vcvits_tpu_torch/csrc/int8_conv.cu",
             "replaces": "vcvits_tpu/ops/int8_conv.py:89 (an XLA conv_general_dilated of int8 "
                         "operands; no Pallas kernel)",
             "launches": counts.get(name, 0), "max_abs_err": f32["max_abs_err"] if key == "q1"
             else 0.0, "ms": f32[f"{key}_ms"],
             "plain_ms": f32["plain_ms" if key == "q1" else "q2_plain_ms"],
             "bound_ms": f32[bound], "bound_by": f32["bound_by"] if key == "q1" else "bytes",
             "library_ms": f32["library_ms"] if key == "q1" else None,
             "max_ulps": f32["ulps"] if key == "q1" else 0, "ms_bf16": b16[f"{key}_ms"],
             **({} if key == "q1" else {
                 "ms_conv_pre": f32["q2_ms_conv_pre"],
                 "library_ms_conv_pre": f32["q2_library_ms_conv_pre"],
                 "ms_conv_pre_bf16": b16["q2_ms_conv_pre"],
                 "library_ms_conv_pre_bf16": b16["q2_library_ms_conv_pre"],
                 "library_note": "torch.linalg.vector_norm(x, ord=inf, dim=(1, 2)) computes "
                                 "Q2 only at conv_pre's input; the other 77 launches fuse a "
                                 "leaky ReLU, which no one PyTorch call does"}),
             "plain_ms_bf16": b16["plain_ms" if key == "q1" else "q2_plain_ms"],
             "bound_ms_bf16": b16[bound],
             "max_abs_err_bf16": b16["max_abs_err"] if key == "q1" else 0.0,
             "ms_b16": big[f"{key}_ms"], "bound_ms_b16": big[bound],
             "library_ms_b16": big["library_ms"] if key == "q1" else None,
             "ms_b16_bf16": int8[(SERVE_BATCH, torch.bfloat16)][f"{key}_ms"],
             "per": "the 78 convs of one 10 s W8A8 request, fp32 unless named"})
    train, long = mas[MAS_SHAPES[0][0]], mas[MAS_SHAPES[1][0]]
    kernels.append(
        {"name": "monotonic_align", "route": "cuda",
         "source": "vcvits_tpu_torch/csrc/monotonic_align.cu",
         "replaces": "vcvits_tpu/ops/monotonic_align.py:24 (maximum_path: two lax.scans, no "
                     "Pallas kernel)",
         "launches": counts.get("monotonic_align", 0),
         "launches_tts": tts.get("monotonic_align", 0), "max_abs_err": 0.0,
         "differing_entries": train["differing"] + long["differing"], "ms": train["ms"],
         "device_ms": train["device_ms"], "plain_ms": train["plain_ms"],
         "bound_ms": train["bound_ms"], "bound_by": train["bound_by"], "library_ms": None,
         "ms_tx600": long["ms"], "device_ms_tx600": long["device_ms"],
         "plain_ms_tx600": long["plain_ms"], "bound_ms_tx600": long["bound_ms"]})
    for entry in kernels:
        for key, errs in (("tts", held), ("base_json", held_base)):
            if entry["name"] in errs:
                entry[f"max_abs_err_{key}_inputs"] = errs[entry["name"]]
        for path, path_counts in new.items():
            entry[f"launches_{path}"] = path_counts.get(entry["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
