#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``egregora_tpu_torch``) on one
NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py

Phases, one line each on standard output:

1. the card's name and power limit (``nvidia-smi``); the builds of the
   six sources under ``egregora_tpu_torch/csrc/`` (``attn_rows``,
   ``mrf``, ``iir_lowpass``, ``attn_online``, ``conv_edge``, ``snake``;
   ``utils.cuda_build.SOURCES``), one ``nvcc`` each, at once, through the
   bootstrap's build step (``install.build_native``); for each instantiation of the bf16 attention
   core (``attn_core.cuh``) and of the bf16 MRF core (``mrf_core.cuh``),
   its registers, spills and stack from ``ptxas -v`` and its block (the
   library's layout query, held to the wrappers' plan); the same for K3's
   three kernels and K4's (``ptxas conv_edge`` / ``ptxas iir_lowpass``
   lines: K3's blocks at ``K3_SHAPES`` and K4's tile held to the
   wrappers'), and the SASS lines (``cuobjdump -sass``) that show K3's
   bf16 route on the tensor cores (HGMMA) fed by TMA (UTMALDG);
1b. the pcm16 wire's input (``wire_phase``): ``core.audio.pcm16_roundtrip_``
   on the card against the host's numpy path it replaced, bit for bit,
   on a 240 s stereo song and a 12 s mono voice file above full scale,
   beside two planted faults that must change some sample (halves
   rounded away from zero; the peak divided as a host scalar, which the
   card turns into a product with its reciprocal), and the dequantising
   constant for 2^20 peaks; the card's time, the host's and the
   pageable copies up of float32 and int16;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at a ragged length, beside planted
   faults that the limits must reject, with the kernel's, the plain
   version's and (attention) the library call's or (MRF) the module
   path's times:
   - ``attn_rows`` (including the published VAE mid block, 3 x 8192 x
     512): relative L2 1e-2 and two bf16 ulps of the largest output;
     fault: the last key tile dropped (64 keys, or the kernel's tile
     where that is smaller: 32 at D = 512); each row also gives the
     tile, the share of the bf16 peak and the previous design's time at
     that shape with the speed-up over it (``BEFORE_MS``; in the log
     text only, not in the ``kernels`` line);
   - ``mrf_fused_cm`` and ``mrf_rows`` (every branch of an MRF block in
     one launch, or one a launch), at the served and the full config's
     stages (C = 16 to 256): relative L2 1e-2 and four bf16 ulps, over
     the block and over its first and last 120 samples; faults: the
     per-layer re-zeroing outside the signal skipped, the last
     dilation's residual dropped, every conv's last tap dropped (what a
     weight slot released one tap early gives); each row also gives the
     share of the bf16 peak and the previous design's time at that shape
     with the speed-up over it (``BEFORE_MS``, in the log text only);
3. the repaired shapes: ``attn_rows`` at head sizes 24, 40 and 320
   (bf16) and in float32 (D up to 512), the MRF entries at C = 8 and 24
   (bf16) and in float32 (float32 limits: relative L2 and max |d| 1e-5
   of the largest output), with the same planted faults; the upscaler
   node on a ``channel_floor=8`` HiFi-GAN config with the fused vocoder;
4. K4 (``iir_lowpass``) against its plain version and float64 ``lfilter``
   (max |d| 2e-6) at the meter's 300 s of 48 kHz stereo and at ragged
   and near-unit-pole shapes; faults: the cross-tile carry dropped, and a
   look-back that stops after one predecessor's aggregate (invisible at
   the 48 kHz pole, rejected at 0.9999); each row also gives the share of
   the bytes bound and the previous design's time at that shape with the
   speed-up over it (``BEFORE_MS``, in the log text only);
4b. Snake (``snake``, ``snake_phase``) at the DAC 44 kHz decoder's last
   stage (past 2^31 elements) and first stage, bf16 in and out, in both
   layouts the kernel reads (NCW, and NWC: channels-last, the DAC's):
   every element within one bf16 ulp of the plain version rounded to
   bf16, the bit-equal share; fault: ``sin(a x) / a``; the kernel's time
   beside the plain version's and its bytes bound, and its twelve
   instantiations' ``ptxas`` lines; the DAC phases (18 and 28) count a
   launch for every Snake they run on the card;
5. K1b (``flash_online``) at the attention lab's shapes and a ragged N
   (bf16 limits; fault: the last key tile dropped) and K3
   (``conv3x3_out1``) at the decoders' C = 24/64/128, the edge lab's
   shapes, ragged F and M and its tile edges (float32 limits; faults: the
   bottom halo row dropped, and the tensor-core route's left column of
   tap partials zeroed at every strip edge, where M spans two strips or
   more), with SDPA's or cuDNN's time; K3's rows also give the share of
   the bytes bound and the previous design's time;
6. a reference check of the full config (seeded weights) on one chunk:
   bf16 on the card against float32 arithmetic on the CPU with the same
   weights, and against the card pipeline with float32 plain attention
   (decoded mel, vocoder wave, the output's band above the crossover),
   and each attention call against the float32 plain version on its own
   inputs; the attention fault must fail every limit;
7. the ``EgregoraAudioUpscaler`` node on a comfy AUDIO dict (a seeded
   12 s, 16 kHz signal, 3 chunks, to 48 kHz) with the shipped weights:
   the HiFi-GAN trio with the fused MRF kernel, the same trio with the
   rows kernel (``EGREGORA_MRF_PATH=rows``), and the default istft trio;
   one-shot through ``run`` and streaming (``max_batch=2``), with every
   kernel's launches counted by shape around each run; the kernels'
   vocoder wave against the module path's;
8. the same reference check for one chunk of each shipped trio, with
   its own planted fault;
9. the full-config pipeline (seeded weights) one-shot and streaming, with
   the attention launches counted by shape;
10. the node on a converted reference trio at the published geometry: a
   seeded upstream-layout ``.pth`` trio (weight-norm pairs in the
   vocoder) in a temporary ``EGREGORA_TPU_WEIGHTS``, resolved as
   "converted", on the module-path, fused and rows vocoders, with
   ``attn_rows`` counted at D = 512 and the MRF kernels at C = 256/128/64;
   one chunk bf16 on the card against float32 on the CPU beside the
   attention fault;
11. the eval-pack and null-suite nodes at real sizes (the meter on 300 s
   of 48 kHz stereo, the pair nodes on 60 s with a planted 37.25-sample
   delay and -3 dB gain), each held to the same code on the CPU, with
   K4's calls counted by shape and the warm wall time of each node;
12. the two lab tools once (``tools/attn_flash_lab.py``,
   ``tools/edge_conv_lab.py``), where K1b and K3 launch;
13. RNNoise (``rnnoise_phase``): the node's shipped weights asserted
   loaded (the random-init branch fails the run); the engine on 12 s of
   seeded 48 kHz speech-like stereo with silent gaps on the card against
   the same code on the CPU (wave relative L2 1e-3 and max |d| 2e-3, VAD
   5e-3, pitch periods exact on every frame non-silent on both, silence
   flags), beside two planted faults the limits must reject (the silence
   freeze dropped; z and r swapped in the GRU); the node in both stereo
   modes and at 16 kHz against the CPU; the sequential frame loop's time
   and operations a step; ``segments=16`` on 60 s of stereo as RTF;
14. Fat Llama (``fatllama_phase``): the GPU node on 30 s of 16 kHz mono
   at its defaults (the fold loop, 300 iterations) as iterations a
   second; 20 iterations on the card against the CPU (max |d| 1e-4) on
   the fold loop and on a length padded to 2^22, beside observations
   clamped one sample late; the CPU node once, asserted on the CPU;
15. WPE (``wpe_phase``): 20 s of seeded reverberant 48 kHz stereo,
   ``wpe_dereverb`` directly and the node at its defaults on the card;
   the node equal to the direct call, changed from its input, with less
   late-reverb energy, and within 1e-3 of the CPU;
16. the full chain (``chain_phase``): 120 s of seeded 16 kHz mono through
   the RNNoise node (``EGREGORA_RNNOISE_SEGMENTS=16``), the upscaler
   (istft trio) to 48 kHz, the Fat Llama GPU node (factor 2, 50
   iterations) to 96 kHz, the loudness meter and LSD / SI-SDR against the
   input at 96 kHz: finite, of the right length and rate; warm wall time
   and RTF of the chain and of each stage; ``attn_rows`` and K4 counted
   by shape (the attention shapes not met before are measured as in
   phase 2);
17. DeepFilterNet (``dfn_phase``; plain PyTorch, no kernel): both
   shipped weight sets asserted served by the node (its random-init
   branch fails the run); the engine per variant on 60 s of seeded
   48 kHz mono noise (``bench.py``'s ``dfn2_rtf_48k`` input) as RTF, the
   GRU calls timed apart; one such GRU recurrence as the served cuDNN
   call and as a step loop (time; max |d| 1e-5); ``enhance_mono_full``
   on 10 s of noisy
   speech-like 48 kHz on the card against the CPU: wave relative L2 5e-6
   and ERB gains max |d| 5e-5 (the first run read 1.7e-7 and 4.4e-6),
   beside three planted faults the limits must reject (z and r swapped
   in the GRU; ``_conv_t`` without the kernel flip; the deep filter
   reading frame t+1 for t-1, which moves the wave by 3e-5 only); the
   node at its defaults with the post-filter on, 12 s of 16 kHz stereo,
   VAD sources rms and rnnoise, card against CPU relative L2 1e-3;
18. the DAC codec (``dac_phase``; plain PyTorch but Snake's kernel): each shipped
   codec on 10 s of speech-like stereo at its rate, encode and decode as
   RTF, card against CPU (bf16 on both): latents and the share of codes
   that agree (reported), decode of the CPU's latents relative L2 2e-2,
   roundtrip SNR within 0.5 dB; the published 44 kHz geometry (76.6M
   parameters, a seeded ``dac_44khz.npz`` in a temporary
   ``EGREGORA_TPU_WEIGHTS``) through the encode and decode nodes, which
   must resolve it as converted, on 30 s of stereo: RTF and peak memory;
   one encode and decode of 60 s of stereo traced, each conv's kernels
   logged, failing where cuDNN's legacy NCW conv or its NCHW<->NHWC
   transposes run under the encoder's or decoder's span or a layout copy
   is counted (``dac_conv_trace``);
   a 2 s piece bf16 on the card against float32 on the CPU, latents and
   decode relative L2 3e-2 (the first run read 1.4e-2 and 1.3e-2),
   beside the transposed convs' kernels left unflipped (1.10); the
   published 24 kHz geometry's encoder likewise, beside its stride-5
   'SAME' pads reversed to (3, 2) (0.68); neither phase may launch a
   kernel;
19. the entry points (``entry_phase``), with ``EGREGORA_TPU_OFFLINE=1``
   (set for the whole run): the CLI (``egregora_tpu_torch.cli.main``) in
   this process on seeded WAVs in a temporary directory: ``flashsr`` on
   the istft trio (12 s of 16 kHz mono), on the HiFi-GAN trio with
   ``EGREGORA_FUSED_VOCODER=1`` and ``EGREGORA_MRF_PATH`` pallas, rows,
   dense and packed (3 chunks, an odd batch), packed again on 8 s (2
   chunks), and on the published geometry from a seeded ``--ckpt-dir``
   (``flashsr_params.npz`` + sidecar); ``enhance`` (50 iterations),
   ``eval``, ``nulltest`` and ``loudness`` on a 60 s 48 kHz stereo pair,
   ``codec`` at 16 kHz.  Each output is held to the same node called
   directly on the card: within one PCM16 step (``flashsr``), one step
   plus 1e-4 (``enhance``), 1e-4 relative on the printed JSON, relative
   L2 2e-2 (``codec``); dense and packed to pallas within 5e-2.  Each
   call's launches are counted: ``attn_rows`` on every ``flashsr``, the
   MRF kernels on pallas and rows and on packed only at the odd batch,
   none on dense, K4 on ``loudness`` and ``nulltest``; ``flashsr`` under
   ``EGREGORA_ATTN_PATH=chunked`` launches no ``attn_rows`` and agrees
   with the kernel path within 5e-2.  The example workflow through the
   executor (``max_iterations`` 50) must equal the direct node chain,
   with its ``timing_summary()``; one ``flashsr`` under
   ``utils.profiling.trace`` must leave a trace that names the attn_rows
   kernel; each subcommand's warm wall time beside the card;
19b. the bootstrap (``bootstrap_phase``): ``python -m
   egregora_tpu_torch.install --offline`` in a subprocess, warm (the
   libraries of phase 1 load at once), in a temporary weights root: exit
   0, the card line, capability (9, 0), every source's library present,
   the shipped weight rows as the files on disk, the five warmups "ok",
   ``[install] done`` last; three planted faults (a source that does not
   exist; nvcc unreachable through ``CUDA_HOME``, ``PATH`` and the default
   path; no card visible), each of which must exit non-zero, name its
   cause and print neither a warmup line nor ``[install] done``; then the
   warmups in this process with K4's launches counted (4 at [1, 4800]);
19c. the full-chain example (``example_phase``,
   ``examples.full_chain``) on seeded speech-like 16 kHz stereo WAVs (a
   50 ms lead-in, no gap): on 6 s, the card against the same function on
   the CPU (96 kHz output relative L2 ``EXAMPLE_WAVE_REL``; each printed
   metric within ``EXAMPLE_KEY_LIMITS``; the printed JSON has the JAX
   example's keys); on 120 s, cold, then warm with each stage timed and
   ``attn_rows`` and K4 counted (K4 4 at [2, 11 520 000]); ``main``
   through a WAV round trip (96 kHz, 2 x 11 520 000, finite);
20. training (``train_phase``), bf16 on the card: the distilled
   config at ``distill()``'s defaults (batch 8 x 61 440 samples) from
   ``init_params(0)``, five AdamW steps on one fixed batch, whose loss must
   fall; every parameter with a finite gradient, beside the planted fault
   of the attention kernel detached (launched with no ``grad_fn``),
   which must leave parameters without one; the same step on 2 items
   against float32 on the CPU (loss and each sub-model's gradient,
   relative, ``TRAIN_LOSS_LIMIT`` / ``TRAIN_GRAD_LIMITS``); the full config
   at batch 2 (hop 480, 256 mels) with ``attn_rows`` counted by shape in
   the step; ``distill(steps=3)`` at its defaults, written where the
   trainer writes by default in a weights root of its own; step time, the host's draws (data and noise), the card's
   synthesis time and peak memory of each;
21. the attention gradient (``attn_grad_phase``) at every training shape:
   the ``AttnRows`` backward against autograd through ``attn_rows_plain`` in
   float32 (dq, dk, dv relative L2 ``ATTN_GRAD_LIMIT``), beside the planted
   fault ``dS = P * dP`` (row term dropped), with its time and SDPA's
   backward at the same shape;
22. ``distill_vocoder`` (``vocoder_distill_phase``) for 4 steps at its
   defaults in the same weights root: from the served HiFi-GAN trio's
   frozen VAE/UNet, which is phase 20's, with the shipped istft head's
   geometry, the frozen StudentUNet's ``attn_rows`` counted;
22b. the trained trios served (``served_trained_phase``): the trio phase
   20 distilled and the one phase 22 distilled, both at the trainers'
   default paths in a weights root of their own, served by the upscaler
   node through the resolver (``served_trio``: "distilled" and
   "distilled-istft" from the trained files) on each ``NODE_PATHS`` path:
   the launches counted (attn_rows, and the fused or rows MRF kernels),
   the output equal to a pipeline built straight from the trained file
   (``SERVED_SAME_ABS``; planted fault: the shipped file served), each
   launch against its plain version on the inputs the path gave it;
23. a checkpoint (``checkpoint_phase``) written at step 2 and read back
   exactly (weights, moments, count), then step 3 resumed against the run
   that went on (each parameter within ``RESUME_LR_SHARE`` of the lr);
24. ``evaluate`` on both shipped trios beside their json records, and the
   gate pair (seed 123) held to ``tests/test_flashsr_distilled.py``'s bars;
25. the mesh (``mesh_phase``): ``process(mesh=make_chunk_mesh())`` equal to
   ``mesh=None``, two slots of the card (two streams) against one device at
   the same forward batches, then two ranks on the card over gloo in
   subprocesses: a sharded float32 train step against the one-process step
   (``MESH_STEP_LIMIT``), and the sharded ``process`` one-shot and with
   ``max_batch`` against one device (``MESH_PROCESS_LIMIT``), the fused MRF
   kernels counted on each rank;
26. the RNNoise trainer (``rnnoise_train_phase``; plain PyTorch, no
   kernel): ``train_device(steps=3)`` and ``train(steps=3)`` at their
   defaults; warm steps at 16 x 50 frames with the host's draws and the
   card's synthesis timed apart, peak memory; one fixed batch (a quiet
   lead-in, as the CPU tests) card against CPU, float32: the loss relative
   ``TRAINER_LOSS_REL`` and every leaf's gradient relative L2
   ``TRAINER_GRAD_REL``, every leaf with a gradient, beside the planted
   fault of the GRU carries detached every frame; the shipped weights' SNR
   gain on ``synth_batch(default_rng(4242), 4, 40)`` above +5 dB;
27. the DeepFilterNet trainer (``dfn_train_phase``), DFN2 and DFN3:
   ``train_device(steps=3)`` at its defaults (4 x 50 frames), warm steps
   timed as in 26; card against CPU on one batch within the same limits,
   every leaf with a gradient, beside the planted fault of the GRU run
   under ``no_grad`` as it ran before its repair (it leaves the GRUs and the
   encoder without one);
28. the DAC trainer (``dac_train_phase``): ``train(distilled_config(
   "44khz"), steps=10, batch=8, length=16384)`` in bf16 (ae 5, proj 1, vq
   4, the held-out evaluations) and ``finetune("44khz", steps=2)``; warm vq
   steps timed as in 26; the distilled geometry in float32 with
   ``seeded_dac_tree``'s weights card against CPU: ``ae_loss_fn``,
   ``proj_loss_fn`` (rvq only) and ``ema_loss_fn`` (loss ``DAC_LOSS_REL``,
   each sub-model's gradients ``DAC_GRAD_REL``) and one
   ``ema_codebook_update`` from one key (max |d| 1e-4); one rvq-only step
   with a visible decay, encoder and decoder card against CPU
   (``DAC_DECAY_REL``), beside the planted fault of ``None`` gradients
   skipped as ``torch.optim`` skips them; ``gate_metrics`` of the three
   shipped codecs on the card against the CPU (``DAC_GATE_SNR_DB``),
   printed beside the JAX test's record;
28b. two guarded fine-tunes of the 44 kHz codec in a row
   (``dac_guarded_phase``): the gate before and after, the decision
   (``should_ship``) and the file written, which ``build_dac`` then serves
   ("trained"); the second run (at an lr that wrecks the codec) judged
   against what the first left served and writing nothing; planted fault:
   a ``_guarded_ship`` that writes whatever the gate says.  Phases 26-28b
   run in a temporary ``EGREGORA_TPU_WEIGHTS``, launch no kernel, and hash
   every file under ``egregora_tpu/`` before and after (equal);
29. the kernels' ``FLOP_LOG`` sums (``ops.attn_rows``, which
   ``ops.attn_flash`` shares, ``ops.mrf_rows``, ``ops.conv_edge``) over
   phases 2 and 5 and each path of 22b, each equal to the FLOPs this
   script reckons for the launches counted in the same span
   (``flop_check``); a JSON line ``{"kernels": [...]}`` of all seven kernels,
   whose times are the per-shape times of phases 2, 4 and 5 times the
   launches that phases 7, 9, 10, 11, 12, 16, 19, 19b, 19c, 20, 22 and 22b counted
   (Snake's: one call at each shape of 4b, beside the launches of phases
   18 and 28), and, last, ``{"ok": true, ...}``.

Any failure exits non-zero and prints no ``"ok"`` line.  With no CUDA
device it exits non-zero at once.
"""
from __future__ import annotations

import collections
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3 rate, H100 SXM
SECONDS = 12.0               # test signal: 3 chunks of 5.12 s at 48 kHz
BATCH = 3                    # chunks in the one-shot batch of that signal
# attention calls of one chunk batch on the main path: (heads, N, D) -> calls
PATH_CALLS = {(8, 2048, 32): 5, (8, 512, 64): 6, (1, 8192, 256): 2}
# and in the served trios' StudentUNet: one call, mid block, 4 heads
SERVED_ATTN = (4, 512, 32)
# the published checkpoints' VAE mid block: one head of 512 (2 calls a
# batch); their UNet's attention is PATH_CALLS's
CONVERTED_MID = (1, 8192, 512)
RAGGED = [(8, 1000, 32), (8, 1000, 64), (1, 1000, 256)]
KEY_TILE = 64                # keys the planted attention fault drops (fewer
                             # where the kernel's key tile is smaller)
ATTN_REL_L2 = 1e-2           # kernel vs plain, relative L2 over the output
# device times (ms) of the kernels' previous designs at these shapes,
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the yardstick of the
# warpgroup-MMA cores in the log lines (not in the ``kernels`` line, which
# holds this run's measurements).  Attention (WMMA with S, P and O through
# shared memory; K1b on mma.sync with an O slab at D >= 256) by (bh, n, d,
# dtype), from PERF.md's kernel table
BEFORE_MS = {
    "attn_rows": {(24, 2048, 32, "bfloat16"): 0.4681, (24, 512, 64, "bfloat16"): 0.0662,
                  (3, 8192, 256, "bfloat16"): 5.3136, (12, 512, 32, "bfloat16"): 0.0441,
                  (3, 8192, 512, "bfloat16"): 24.7507, (24, 1000, 32, "bfloat16"): 0.1174,
                  (24, 1000, 64, "bfloat16"): 0.1591, (3, 1000, 256, "bfloat16"): 0.2158,
                  (12, 512, 24, "bfloat16"): 0.1708, (8, 1000, 40, "bfloat16"): 0.1461,
                  (12, 512, 32, "float32"): 0.0732, (2, 1000, 320, "bfloat16"): 0.4907,
                  (1, 2048, 512, "float32"): 3.0898, (2, 300, 320, "float32"): 0.5223},
    "flash_online": {(26, 8192, 256, "bfloat16"): 27.4618, (208, 2048, 32, "bfloat16"): 0.8395,
                     (26, 8192, 512, "bfloat16"): 190.9238, (6, 1000, 64, "bfloat16"): 0.0432},
    # the MRF kernels' previous design (mma.sync m16n8k16, weights through
    # L1, 16-row tiles), by (b, c, t): tools/mrf_lab.py --root on that
    # checkout, the same card; mrf_rows is its three branch launches
    "mrf_fused_cm": {(3, 64, 5120): 1.4082, (3, 32, 40960): 1.6983, (3, 16, 245760): 2.8966,
                     (3, 64, 245760): 26.8346, (3, 128, 40960): 31.6933, (3, 256, 5120): 35.2718},
    "mrf_rows": {(3, 64, 5120): 1.0964, (3, 32, 40960): 1.0190, (3, 16, 245760): 2.5749,
                 (3, 64, 245760): 16.7464, (3, 128, 40960): 16.6623, (3, 256, 5120): 14.9814},
    # K3's previous design (staged halo, FMA on the CUDA cores, 32 x 8 tiles)
    # by (b, f, m, c, dtype), and K4's (two or three launches a call) by (c,
    # n): the final chip_smoke.py run of that code, the same card model
    "conv3x3_out1": {(3, 512, 256, 24, "bfloat16"): 0.0602, (3, 512, 256, 64, "bfloat16"): 0.1167,
                     (3, 512, 256, 128, "bfloat16"): 0.2224,
                     (26, 512, 256, 64, "bfloat16"): 0.5456,
                     (26, 512, 256, 128, "bfloat16"): 1.0743, (2, 37, 45, 64, "bfloat16"): 0.0630,
                     (1, 19, 70, 200, "bfloat16"): 0.0925, (3, 100, 77, 24, "float32"): 0.0380},
    "iir_lowpass": {(2, 14_400_000): 0.1728, (2, 2_880_000): 0.0376, (1, 100): 0.0219,
                    (3, 32_769): 0.0359, (1, 4_194_304): 0.0251},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    from egregora_tpu_torch.utils.device import card_line as line
    return line()


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn()`` without the host's launch path: a CUDA graph
    of ``reps`` calls (``tools.graph_ms``)."""
    from egregora_tpu_torch.tools import graph_ms as timed
    return timed(fn, reps)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def bf16_agreement(got, ref):
    """``(ok, rel_l2, max |d|, max-|d| limit)`` of a bf16 result against
    its plain version.  Both round their output to bf16 once, so sound
    runs differ by at most an ulp here and there: the limits are a
    relative L2 of ``ATTN_REL_L2`` and two bf16 ulps of ``max |ref|``
    (bf16 keeps 8 significant bits: ulp(m) = 2^(floor(log2 m) - 7))."""
    import math
    ref_max = float(ref.float().abs().max())
    limit = 2.0 ** (math.floor(math.log2(ref_max)) - 6) if ref_max > 0 else 0.0
    err = float((got.float() - ref.float()).abs().max())
    rel = rel_l2(got.float(), ref.float())
    ok = bool(got.float().isfinite().all()) and rel <= ATTN_REL_L2 and err <= limit
    return ok, rel, err, limit


# float32 kernels against their float32 plain versions: both sum in
# float32 in other orders, so sound runs differ by a few ulps of the
# values summed; relative L2 and max |d| over max |plain| within F32_REL
F32_REL = 1e-5


def f32_agreement(got, ref):
    """``(ok, rel_l2, max |d|)`` of a float32 result against its plain
    version: relative L2 and max |d| / max |ref| within ``F32_REL``."""
    ref_max = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    rel = rel_l2(got.float(), ref.float())
    ok = bool(got.isfinite().all()) and rel <= F32_REL and err <= F32_REL * ref_max
    return ok, rel, err


# K4 against its plain version (or float64 lfilter) on a signal of scale
# ~0.5: max |d| within IIR_ABS.  The float32 recurrence drifts ~1e-7 from
# float64 (the plain version's blocks) and ~1e-8 (the kernel's 16-sample
# runs); a dropped cross-tile carry reads 1e-2 and more
IIR_ABS = 2e-6


def iir_agreement(got, ref):
    """``(ok, max |d|)`` of an IIR low-pass result against a reference."""
    err = float((got.double() - ref.double()).abs().max())
    return bool(got.isfinite().all()) and err <= IIR_ABS, err


def fault_tile(d: int) -> int:
    """Keys the planted fault drops at head size ``d``: ``KEY_TILE``, or the
    bf16 kernel's key tile where that is smaller (32 at D = 512)."""
    from egregora_tpu_torch.ops import attn_rows as ar
    return min(KEY_TILE, ar.kernel_tile(d)[2])


def drop_last_tile(q, k, v):
    """A planted fault: attention that skips the last K/V tile (what a
    kernel that loses its tail tile computes), from the plain version."""
    from egregora_tpu_torch.ops.attn_rows import attn_rows_plain
    tile = fault_tile(q.shape[-1])
    m = (k.shape[1] - 1) // tile * tile
    return attn_rows_plain(q, k[:, :m].contiguous(), v[:, :m].contiguous())


def bound_share(kernel: str, row: dict, key) -> str:
    """Adds to ``row`` the share of its bound (``bound_ms / ms``, and over
    ``graph_ms``, the device time without the host's launch path); returns
    them as text for the log line, with the previous design's time at the
    row's shape (``BEFORE_MS[kernel][key]``, events around back-to-back
    calls as ``ms``) and the speed-up over it, which stay in the text
    only."""
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["graph_bound_share"] = row["bound_ms"] / row["graph_ms"]
    text = (f"{100 * row['bound_share']:.1f}% of the bound; device {row['graph_ms']:.4f} ms "
            f"in a CUDA graph, {100 * row['graph_bound_share']:.1f}%")
    before = BEFORE_MS[kernel].get(key)
    if before is not None:
        text += f", previous design {before:.4f} ms ({before / row['ms']:.2f}x faster now)"
    return text


def against_before(kernel: str, row: dict, flops: float, peak: float, key=None) -> str:
    """Adds to ``row`` the share of the dtype's peak; returns it as text for
    the log line, with the previous design's time at the row's shape
    (``BEFORE_MS``; ``key``, or attention's (bh, n, d, dtype)) and the
    speed-up over it, which stay in the text: the ``kernels`` line holds
    only this run's measurements.  Both times are CUDA events around
    back-to-back calls: at the smallest shapes the host's launch path, not
    the kernel, sets them."""
    if key is None:
        key = (row["bh"], row["n"], row["d"], row.get("dtype", "bfloat16"))
    before = BEFORE_MS[kernel].get(key)
    row["peak_share"] = flops / (row["ms"] * 1e-3) / peak
    text = f"{100 * row['peak_share']:.1f}% of the peak"
    if before is not None:
        text += f", previous design {before:.4f} ms ({before / row['ms']:.2f}x faster now)"
    return text


def bf16_layout(lib_name: str, d: int, bk: int):
    """``(q rows, threads, dynamic shared memory bytes)`` of the bf16
    attention block at tile (d, bk), from the library's own query
    (``<lib>_bf16_layout``); None where that tile is not built."""
    import ctypes

    from egregora_tpu_torch.utils import cuda_build
    out = (ctypes.c_int * 3)()
    fn = getattr(cuda_build.load(lib_name), f"{lib_name}_bf16_layout")
    return tuple(out) if fn(ctypes.c_int(d), ctypes.c_int(bk), out) == 0 else None


def ptxas_report() -> list:
    """Each instantiation of the bf16 attention core in both libraries:
    registers, spills and stack from ``ptxas -v`` (kept beside each
    build), and the block's q rows, threads and dynamic shared memory from
    the library's layout query; logged one line each.  Fails where the
    instantiations differ from the tiles the wrappers call
    (``BF16_TILES``)."""
    import re

    from egregora_tpu_torch.ops import attn_flash as af
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.utils import cuda_build

    wanted = {"attn_rows": {(d, bq, bk) for d, (bq, bk) in ar.BF16_TILES.items()},
              "attn_online": {(d, bq, bk) for d, (bqs, bks) in af.BF16_TILES.items()
                              for bq in bqs for bk in bks}}
    rows = []
    for lib_name in ("attn_rows", "attn_online"):
        cur = None
        for line in cuda_build.build_log(lib_name).splitlines():
            m = re.search(r"attn_kernelILi(\d+)ELi(\d+)E", line)
            if "Compiling entry function" in line:
                cur = None
                if m:
                    d, bk = map(int, m.groups())
                    layout = bf16_layout(lib_name, d, bk)
                    if layout is None:
                        raise RuntimeError(f"{lib_name}: no layout for the built tile {d}/{bk}")
                    cur = {"library": lib_name, "d": d, "bk": bk,
                           **dict(zip(("bq", "threads", "smem_bytes"), layout))}
                    rows.append(cur)
            elif cur is not None and "spill stores" in line:
                st, sp, ld = map(int, re.findall(r"(\d+) bytes", line)[:3])
                cur.update(stack_bytes=st, spill_store_bytes=sp, spill_load_bytes=ld)
            elif cur is not None and "registers" in line:
                cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        built = {(r["d"], r["bq"], r["bk"]) for r in rows if r["library"] == lib_name}
        if built != wanted[lib_name]:
            raise RuntimeError(f"{lib_name}: built tiles {sorted(built)} differ from the "
                               f"wrapper's BF16_TILES {sorted(wanted[lib_name])}")
    for r in rows:
        # beside two consumer warpgroups the producer is a whole warpgroup,
        # whose registers setmaxnreg moves to the consumers
        rebalanced = r["threads"] % 128 == 0
        log(f"ptxas {r['library']} bf16 D={r['d']} BQ={r['bq']} BK={r['bk']}: "
            f"{r.get('registers')} registers"
            + (" at entry (setmaxnreg: consumers 240, producer 24)" if rebalanced else "")
            + f", spill stores {r.get('spill_store_bytes')} B, loads "
            f"{r.get('spill_load_bytes')} B, stack {r.get('stack_bytes')} B; "
            f"{r['smem_bytes']} B dynamic shared memory; {r['threads']} threads")
    return rows


def mrf_bf16_layout(c: int, t: int, halo: int, nb: int, cm: bool):
    """The bf16 MRF block the library launches for C channels, T samples,
    a halo, ``nb`` branches, channel-major or not, from its own query
    (``mrf_bf16_layout``): (channels run, time tile, threads, dynamic
    shared memory bytes, weight slots, wgmma N, taps a weight slice, leaky
    tile kept), the order of ``ops.mrf_fused.Bf16Plan``; None where no
    tile fits."""
    import ctypes

    from egregora_tpu_torch.utils import cuda_build
    out = (ctypes.c_int * 8)()
    fn = cuda_build.load("mrf").mrf_bf16_layout
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return tuple(out) if fn(c, t, halo, nb, int(cm), out) == 0 else None


# the bf16 MRF core's instantiations, (wgmma N, rounding, channel-major):
# the fused entry's _conv_circ on [B, C, T], the rows entry's _conv_rows on
# [B, T, C]
MRF_INSTANCES = {(nc, r, cm) for nc in (16, 32, 64, 128)
                 for r, cm in (("Circ", True), ("Rows", False))}


def mrf_ptxas_report() -> list:
    """Each instantiation of the bf16 MRF core (``mrf_core.cuh``):
    registers, spills and stack from ``ptxas -v``, whether ptxas
    serialised its wgmma (C7511), and the blocks it runs at the main
    paths' shapes (the fused entry at C <= 64, the rows entry's three
    branch launches at every C) from the library's layout query; logged
    one line each.  Fails where the instantiations differ from
    ``MRF_INSTANCES`` or a layout from the wrappers' ``bf16_plan``."""
    import re

    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.utils import cuda_build

    pat = re.compile(r"mrf_kernelILi(\d+)E\w*?(Circ|Rows)RoundingELb([01])E")
    rows, cur, serialized = {}, None, set()
    for line in cuda_build.build_log("mrf").splitlines():
        m = pat.search(line)
        key = (int(m.group(1)), m.group(2), m.group(3) == "1") if m else None
        if "C7511" in line or "C7512" in line:
            if key:
                serialized.add(key)
        elif "Compiling entry function" in line:
            cur = rows.setdefault(key, {"nc": key[0], "rounding": key[1], "cm": key[2],
                                        "tiles": []}) if key else None
        elif cur is not None and "spill stores" in line:
            st, sp, ld = map(int, re.findall(r"(\d+) bytes", line)[:3])
            cur.update(stack_bytes=st, spill_store_bytes=sp, spill_load_bytes=ld)
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    if set(rows) != MRF_INSTANCES:
        raise RuntimeError(f"mrf: built instantiations {sorted(rows)} differ from "
                           f"{sorted(MRF_INSTANCES)}")
    for key, r in rows.items():
        r["wgmma_serialized"] = key in serialized
    for c, t in MRF_SHAPES:
        launches = [("Circ", True, MRF_HALO, len(MRF_KERNELS))] if c <= 64 else []
        launches += [("Rows", False, mf.branch_halo(k, MRF_DILS), 1) for k in MRF_KERNELS]
        for rounding, cm, halo, nb in launches:
            plan = mf.bf16_plan(c, t, halo, nb, cm)
            got = mrf_bf16_layout(c, t, halo, nb, cm)
            if plan is None or got != tuple(plan):
                raise RuntimeError(f"mrf: the library's block {got} at C={c} T={t} halo {halo} "
                                   f"differs from the wrappers' plan {plan}")
            rows[(plan.nc, rounding, cm)]["tiles"].append(
                {"c": c, "t": t, "halo": halo, "nb": nb, "tt": plan.tt, "threads": plan.threads,
                 "smem_bytes": plan.smem_bytes, "stages": plan.stages, "q": plan.q})
    out = [rows[k] for k in sorted(rows)]
    for r in out:
        tiles = "; ".join(f"C={b['c']} T={b['t']} halo {b['halo']}: TT={b['tt']}, "
                          f"{b['threads']} threads, {b['smem_bytes']} B, {b['stages']} "
                          f"slots of {b['q']} taps" for b in r["tiles"]) or "no main-path shape"
        log(f"ptxas mrf bf16 N={r['nc']} {r['rounding']} "
            f"{'[B,C,T]' if r['cm'] else '[B,T,C]'}: {r.get('registers')} registers"
            f", spill stores "
            f"{r.get('spill_store_bytes')} B, loads {r.get('spill_load_bytes')} B, stack "
            f"{r.get('stack_bytes')} B{', wgmma serialised (C7511)' if r['wgmma_serialized'] else ''}"
            f"; {tiles}")
    return out


def conv_edge_layout(c: int, aligned: bool = True):
    """The block K3's library launches for a bf16 x of C channels (16-byte
    aligned or not), from its own query (``conv_edge_bf16_layout``): the
    order of ``ops.conv_edge.Plan``; None for an invalid C."""
    import ctypes

    from egregora_tpu_torch.utils import cuda_build
    out = (ctypes.c_int * 6)()
    fn = cuda_build.load("conv_edge").conv_edge_bf16_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return tuple(out) if fn(c, int(aligned), out) == 0 else None


def ptxas_entries(name: str) -> dict:
    """Registers, spills and stack of each kernel of ``csrc/<name>.cu``
    from its build's ``ptxas -v`` report, by mangled name."""
    import re

    from egregora_tpu_torch.utils import cuda_build
    rows, cur = {}, None
    for line in cuda_build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = rows.setdefault(m.group(1), {})
        elif cur is not None and "spill stores" in line:
            st, sp, ld = map(int, re.findall(r"(\d+) bytes", line)[:3])
            cur.update(stack_bytes=st, spill_store_bytes=sp, spill_load_bytes=ld)
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return rows


def sass_lines(name: str, opcodes) -> dict:
    """The first SASS line of each opcode in the built ``csrc/<name>.cu``
    (``cuobjdump -sass``, beside ``nvcc``), None where it has none."""
    import os

    from egregora_tpu_torch.utils import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    out = {}
    for op in opcodes:
        hit = next((ln for ln in sass.splitlines() if f" {op}" in ln), None)
        out[op] = None if hit is None else " ".join(hit.split("/*")[1].split("*/")[1].split())
    return out


def edge_ptxas_report() -> dict:
    """K3's and K4's kernels: registers, spills and stack from ``ptxas -v``;
    K3's blocks at ``K3_SHAPES`` from the library's layout query, held to
    the wrapper's plan, and the SASS lines that show the bf16 route on the
    tensor cores (HGMMA) fed by TMA (UTMALDG); K4's tile, threads and
    look-back window from its layout query, held to the wrapper's; logged
    one line each.  Fails where a layout differs from the plan or the SASS
    lacks either instruction."""
    import torch

    from egregora_tpu_torch.ops import conv_edge as ce
    from egregora_tpu_torch.ops import iir_lowpass as il
    entries = ptxas_entries("conv_edge")
    kernels = {"tensor cores": "conv_edge_tc", "CUDA cores bf16": "conv_edge_kernelI13__nv_bfloat16",
               "CUDA cores float32": "conv_edge_kernelIf"}
    k3 = {}
    for label, key in kernels.items():
        found = [r for mangled, r in entries.items() if key in mangled]
        if len(found) != 1:
            raise RuntimeError(f"conv_edge: {len(found)} built kernels match {key}")
        k3[label] = dict(found[0])
    blocks = []
    for b, f, m, c, dt, _ in K3_SHAPES:
        if dt != "bfloat16":
            continue
        plan = ce.bf16_plan(c)
        got = conv_edge_layout(c)
        if got != tuple(plan):
            raise RuntimeError(f"conv_edge: the library's block {got} at C={c} differs from "
                               f"the wrapper's plan {tuple(plan)}")
        rows = ce.segment_rows(b, f, m, 64, plan,
                               torch.cuda.get_device_properties(0).multi_processor_count)
        blocks.append({"b": b, "f": f, "m": m, "c": c, "route": plan.route, "rows": rows,
                       "threads": plan.threads, "smem_bytes": plan.smem_bytes,
                       "stages": plan.stages,
                       "blocks": -(-m // plan.cols) * -(-f // rows) * b})
    sass = sass_lines("conv_edge", ("HGMMA", "UTMALDG", "HMMA"))
    for label, r in k3.items():
        log(f"ptxas conv_edge {label}: {r.get('registers')} registers, spill stores "
            f"{r.get('spill_store_bytes', 0)} B, loads {r.get('spill_load_bytes', 0)} B, stack "
            f"{r.get('stack_bytes', 0)} B")
    log("ptxas conv_edge blocks (library layout = wrapper plan): " + "; ".join(
        f"[{k['b']},{k['f']},{k['m']},{k['c']}] route {k['route']}, {k['rows']} rows a segment, "
        f"{k['blocks']} blocks of {k['threads']} threads, {k['smem_bytes']} B, {k['stages']} stages"
        for k in blocks))
    log(f"sass conv_edge: HGMMA {sass['HGMMA']!r}; UTMALDG {sass['UTMALDG']!r}; "
        f"HMMA {sass['HMMA']!r}")
    if not (sass["HGMMA"] and sass["UTMALDG"]):
        raise RuntimeError(f"conv_edge: the built library lacks HGMMA or UTMALDG: {sass}")
    k4 = [dict(r) for mangled, r in ptxas_entries("iir_lowpass").items() if "iir_lookback" in mangled]
    out = il.layout()
    if len(k4) != 1 or out != (il.TILE, il.THREADS, il.WINDOW):
        raise RuntimeError(f"iir_lowpass: kernels {k4}, layout {out} against the "
                           f"wrapper's {(il.TILE, il.THREADS, il.WINDOW)}")
    r = k4[0]
    log(f"ptxas iir_lowpass iir_lookback: {r.get('registers')} registers, spill stores "
        f"{r.get('spill_store_bytes', 0)} B, loads {r.get('spill_load_bytes', 0)} B, stack "
        f"{r.get('stack_bytes', 0)} B; tile {out[0]} samples, {out[1]} threads, look-back "
        f"window {out[2]} (library layout = wrapper's)")
    return {"conv3x3_out1": {"kernels": k3, "blocks": blocks, "sass": sass},
            "iir_lowpass": {"kernel": r, "tile": out[0], "threads": out[1], "window": out[2]}}


def attention_phase() -> list:
    """attn_rows against its plain version at the FlashSR path shapes of
    one-shot's chunk batch (BATCH items) and at ragged N, beside the
    planted fault ``drop_last_tile``, which the limits must reject."""
    import torch

    gen = torch.Generator().manual_seed(0)
    return [attn_shape_row(BATCH, heads, n, d, gen)
            for heads, n, d in list(PATH_CALLS) + [SERVED_ATTN, CONVERTED_MID] + RAGGED]


def attn_shape_row(batch: int, heads: int, n: int, d: int, gen) -> dict:
    """attn_rows at [batch * heads, n, d] bf16 against its plain version
    and the planted fault (which the limits must reject), with the
    kernel's, the plain version's and SDPA's times and the bound."""
    import torch
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops.attn_rows import attn_rows_plain

    bh = batch * heads
    q, k, v = (torch.randn(bh, n, d, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))
    got = ar.attn_rows(q, k, v)
    torch.cuda.synchronize()
    plain = attn_rows_plain(q, k, v)
    ok, rel, err, limit = bf16_agreement(got, plain)
    bad_ok, bad_rel, bad_err, _ = bf16_agreement(drop_last_tile(q, k, v), plain)
    flops = 4.0 * bh * n * n * d
    nbytes = 4.0 * bh * n * d * 2
    bound_ms = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / H100_BF16_FLOPS >= nbytes / H100_BYTES_PER_S else "bytes"
    reps = max(3, min(50, int(2e11 / flops)))
    ms = cuda_ms(lambda: ar.attn_rows(q, k, v), reps)
    plain_ms = cuda_ms(lambda: attn_rows_plain(q, k, v), max(2, reps // 4), 1)
    q4, k4, v4 = (t.view(batch, heads, n, d) for t in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)
    row = {"bh": bh, "n": n, "d": d, "tile": list(ar.kernel_tile(d)),
           "max_abs_err": err, "rel_l2": rel,
           "max_abs_limit": limit, "planted_max_abs_err": bad_err,
           "planted_rel_l2": bad_rel, "planted_keys_dropped": fault_tile(d), "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "tflops": flops / ms / 1e9}
    before = against_before("attn_rows", row, flops, H100_BF16_FLOPS)
    log(f"attn_rows [{bh},{n},{d}] tile {row['tile']}: vs plain max|d| {err:.3e} (limit "
        f"{limit:.3e}), rel L2 {rel:.3e} (limit {ATTN_REL_L2:g}) {'ok' if ok else 'FAIL'}; "
        f"planted fault (last {fault_tile(d)}-key tile dropped) max|d| {bad_err:.3e}, "
        f"rel L2 {bad_rel:.3e} {'rejected' if not bad_ok else 'NOT REJECTED'}; "
        f"kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, {before}), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not ok:
        raise RuntimeError(f"attn_rows disagrees with its plain version at "
                           f"[{bh},{n},{d}]: max |d| {err}, rel L2 {rel}")
    if bad_ok:
        raise RuntimeError(f"the attention limits do not reject a dropped last "
                           f"key tile at [{bh},{n},{d}]")
    del q, k, v, got, plain
    return row


def attn_entry(rows: list, counts: dict, by_path: dict) -> dict:
    """The ``kernels`` line's attn_rows entry: times and bound of the
    launches the main paths' one-shot runs made, shape by shape as
    ``counts`` measured them (``by_path``: launches of each run)."""
    by_shape = {(r["bh"], r["n"], r["d"]): r for r in rows}

    def total(key):
        return sum(by_shape[s][key] * c for s, c in counts.items())

    ops_ms = sum(4.0 * bh * n * n * d * c for (bh, n, d), c in counts.items()) \
        / H100_BF16_FLOPS * 1e3
    byte_ms = sum(8.0 * bh * n * d * c for (bh, n, d), c in counts.items()) \
        / H100_BYTES_PER_S * 1e3
    return {
        "name": "attn_rows", "route": "cuda",
        "source": "egregora_tpu_torch/csrc/attn_rows.cu",
        "replaces": "egregora_tpu/ops/attn_pallas.py:92",
        "launches": sum(counts.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(ops_ms, byte_ms),
        "bound_by": "operations" if ops_ms >= byte_ms else "bytes",
        "library_ms": total("library_ms"),
        "launches_by_shape": {f"{bh}x{n}x{d}": c for (bh, n, d), c in counts.items()},
        "launches_by_path": by_path,
        "shapes": rows,
    }


def mrf_entry(name: str, rows: list, counts: dict, by_path: dict) -> dict:
    """The ``kernels`` line's entry of an MRF kernel: ``counts`` maps (b,
    c, t) to the blocks the main path ran (one launch a block for
    mrf_fused_cm, one a branch for mrf_rows); times are the measured
    per-shape times of phase 2 at B = 3 (every counted launch is at B=3);
    the module path's time is kept beside them, as no single PyTorch call
    computes an MRF block."""
    by_shape = {(r["b"], r["c"], r["t"]): r for r in rows if r["entry"] == name}
    per_block = 1 if name == "mrf_fused_cm" else len(MRF_KERNELS)

    def total(key):
        return sum(by_shape[s][key] * n / per_block for s, n in counts.items())

    bounds = [mrf_bound_ms(c, t, b, [MRF_KERNELS] if per_block == 1
                           else [(k,) for k in MRF_KERNELS])[0] * n / per_block
              for (b, c, t), n in counts.items()]
    ops = sum(mrf_flops(c, t, b) * n / per_block for (b, c, t), n in counts.items())
    byte = sum(4.0 * b * c * t * n for (b, c, t), n in counts.items())
    return {
        "name": name, "route": "cuda", "source": "egregora_tpu_torch/csrc/mrf.cu",
        "replaces": ("egregora_tpu/ops/mrf_pallas.py:203" if name == "mrf_fused_cm"
                     else "egregora_tpu/ops/mrf_rows.py:128"),
        "launches": sum(counts.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["entry"] == name),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": sum(bounds),
        "bound_by": ("operations" if ops / H100_BF16_FLOPS >= byte / H100_BYTES_PER_S
                     else "bytes"),
        "library_ms": None, "module_path_ms": total("module_ms"),
        "launches_by_shape": {"x".join(map(str, s)): n for s, n in counts.items()},
        "launches_by_path": by_path,
        "shapes": [r for r in rows if r["entry"] == name],
    }


# MRF blocks of the vocoder on the main paths, one-shot (B = 3 chunks):
# (C, T) -> where.  The served HiFi-GAN trio's three stages and the full
# config's last stage (the one of C <= 64)
MRF_SHAPES = {(64, 5120): "HiFi-GAN trio, stage 1", (32, 40960): "HiFi-GAN trio, stage 2",
              (16, 245760): "HiFi-GAN trio, stage 3", (64, 245760): "full config, stage 3",
              (256, 5120): "full config, stage 1", (128, 40960): "full config, stage 2"}
MRF_RAGGED_T = 5000
MRF_KERNELS, MRF_DILS = (3, 7, 11), (1, 3, 5)
MRF_HALO = 60                # per-side reach of the k=11 branch
# max |d| limits of the MRF checks, in bf16 ulps of max |plain|: each
# conv rounds its output, so a sum-order flip of one ulp early in a
# branch's six convs reaches the output as up to two (the sound reading
# on an H100); the planted faults read 22 ulps and more (PERF.md)
MRF_ULPS = 4
# the planted faults the MRF limits must reject (``mrf_planted``)
MRF_FAULTS = ("no_rezero", "drop_residual", "drop_last_tap")


def mrf_flops(c: int, t: int, b: int, kernels=MRF_KERNELS) -> float:
    """Two FLOPs a multiply-add, 2 convs x 3 dilations a branch."""
    return sum(2.0 * 2 * len(MRF_DILS) * k * c * c * t * b for k in kernels)


def mrf_bound_ms(c: int, t: int, b: int, launches_kernels) -> tuple:
    """(bound ms, bound_by) of launches each reading its [B, C, T] bf16
    input once and writing its output once; ``launches_kernels`` lists
    the branch kernel sizes each launch computes."""
    ops_s = sum(mrf_flops(c, t, b, ks) for ks in launches_kernels) / H100_BF16_FLOPS
    byte_s = len(launches_kernels) * 4.0 * b * c * t / H100_BYTES_PER_S
    return max(ops_s, byte_s) * 1e3, "operations" if ops_s >= byte_s else "bytes"


def mrf_module(c: int, seed: int, dtype=None):
    """A port ``MRF`` at width C in ``dtype`` (bf16 by default) with
    seeded weights and biases."""
    import torch

    from egregora_tpu_torch.models.flashsr.layers import seeded_init_
    from egregora_tpu_torch.models.flashsr.vocoder import MRF
    gen = torch.Generator().manual_seed(seed)
    m = MRF(c, MRF_KERNELS, (MRF_DILS,) * 3, dtype or torch.bfloat16)
    seeded_init_(m, gen)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return m


def mrf_planted(x_cm, w, bias, fault: str, round_then_bias: bool):
    """A planted fault of the MRF block on ``[B, C, T]``, from plain
    PyTorch: ``"no_rezero"`` runs the chains on the signal zero-extended
    by the halo without re-zeroing each layer outside [0, T) (what a
    kernel that skips its per-layer mask computes near the edges);
    ``"drop_residual"`` leaves the last dilation's residual add out of
    every branch; ``"drop_last_tap"`` leaves every conv's last tap out
    (what a kernel that releases a weight slot one tap early computes)."""
    import torch.nn.functional as F

    from egregora_tpu_torch.ops.mrf_fused import _conv, _leaky, branch_weights
    c, t = x_cm.shape[1], x_cm.shape[2]
    pad = MRF_HALO if fault == "no_rezero" else 0
    xe = F.pad(x_cm, (pad, pad))
    acc = None
    def taps(wk):
        if fault != "drop_last_tap":
            return wk
        wk = wk.clone()
        wk[-1] = 0
        return wk

    for bi, wb in enumerate(branch_weights(w, c, MRF_KERNELS, len(MRF_DILS))):
        h = xe
        for m, d in enumerate(MRF_DILS):
            a = _conv(_leaky(h), taps(wb[m, 0]), bias[bi, m, 0], d, round_then_bias)
            a = _conv(_leaky(a), taps(wb[m, 1]), bias[bi, m, 1], 1, round_then_bias)
            if not (fault == "drop_residual" and m == len(MRF_DILS) - 1):
                h = h + a
        acc = h if acc is None else acc + h
    return (acc / len(MRF_KERNELS))[..., pad: pad + t]


def mrf_agreement(got, ref):
    """A bf16 MRF block against its plain version: relative L2 within
    ``ATTN_REL_L2``, max |d| within ``MRF_ULPS`` bf16 ulps of max |ref|
    over the whole block and, separately, over the first and last 2*halo
    samples: an error confined to the edges barely moves a relative L2
    over 245760 samples.  ``(ok, rel_l2, max |d|, edge max |d|, limit)``."""
    import math
    ref_max = float(ref.float().abs().max())
    limit = MRF_ULPS * 2.0 ** (math.floor(math.log2(ref_max)) - 7) if ref_max > 0 else 0.0
    d = (got.float() - ref.float()).abs()
    err, rel = float(d.max()), rel_l2(got.float(), ref.float())
    e = 2 * MRF_HALO
    edge = float(max(d[..., :e].max(), d[..., -e:].max()))
    ok = bool(got.float().isfinite().all()) and rel <= ATTN_REL_L2 and max(err, edge) <= limit
    return ok, rel, err, edge, limit


def mrf_phase() -> list:
    """Both MRF entry points of ``csrc/mrf.cu`` against their plain
    versions on the card, at the main paths' shapes and at a ragged T,
    beside the planted faults (``MRF_FAULTS``) that the limits must
    reject; times of the kernel, the plain version and the module path
    (``MRF.forward``'s cuDNN convs, the same function with the module's
    rounding)."""
    import torch

    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr

    shapes = list(MRF_SHAPES) + [(c, MRF_RAGGED_T) for c in (16, 32, 64)]
    rows, failures = [], []
    for c, t in shapes:
        m = mrf_module(c, seed=c).to("cuda")
        w, bias = mf.pack_resblock_weights(m, torch.bfloat16)
        gen = torch.Generator().manual_seed(t + c)
        x = (0.5 * torch.randn(BATCH, c, t, generator=gen)).to("cuda", torch.bfloat16)
        x_rows = x.transpose(1, 2).contiguous()
        flops = mrf_flops(c, t, BATCH)
        branch_w = mf.branch_weights(w, c, MRF_KERNELS, len(MRF_DILS))
        for entry in ("mrf_fused_cm", "mrf_rows"):
            if entry == "mrf_fused_cm":
                def run():
                    return mf.mrf_fused_cm(x, w, bias, MRF_KERNELS, MRF_DILS)

                def plain():
                    return mf.mrf_fused_cm_plain(x, w, bias, MRF_KERNELS, MRF_DILS)
                launch_fns = [run]
                circ, launches_kernels = True, [MRF_KERNELS]
            else:        # mrf_rows: one mrf_branch_rows launch a branch, then the mean
                def run():
                    return mr.mrf_rows(x_rows, w, bias, MRF_KERNELS, MRF_DILS).transpose(1, 2)

                def plain():
                    acc = None
                    for bi, wb in enumerate(branch_w):
                        h = mr.mrf_branch_rows_plain(x_rows, wb, bias[bi], MRF_DILS)
                        acc = h if acc is None else acc + h
                    return (acc / len(MRF_KERNELS)).transpose(1, 2)
                launch_fns = [lambda bi=bi: mr.mrf_branch_rows(x_rows, branch_w[bi], bias[bi],
                                                               MRF_DILS)
                              for bi in range(len(MRF_KERNELS))]
                circ, launches_kernels = False, [(k,) for k in MRF_KERNELS]
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            ok, rel, err, edge, limit = mrf_agreement(got, ref)
            planted = {}
            for fault in MRF_FAULTS:
                bad = mrf_planted(x, w, bias, fault, round_then_bias=circ)
                b_ok, b_rel, b_err, b_edge, _ = mrf_agreement(bad, ref)
                planted[fault] = {"ok": b_ok, "rel_l2": b_rel, "max_abs_err": b_err,
                                  "edge_max_abs_err": b_edge}
            reps = max(2, min(20, int(2e11 / flops)))
            launch_ms = [cuda_ms(fn, reps) for fn in launch_fns]
            ms = sum(launch_ms)
            plain_ms = cuda_ms(plain, max(1, reps // 4), 1)
            module_ms = cuda_ms(lambda: m(x), max(1, reps // 2), 1)
            bound_ms, bound_by = mrf_bound_ms(c, t, BATCH, launches_kernels)
            row = {"entry": entry, "b": BATCH, "c": c, "t": t,
                   "where": MRF_SHAPES.get((c, t), "ragged T"), "max_abs_err": err,
                   "edge_max_abs_err": edge, "rel_l2": rel, "max_abs_limit": limit,
                   "planted": planted, "ms": ms, "launch_ms": launch_ms,
                   "plain_ms": plain_ms,
                   "module_ms": module_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflops": flops / ms / 1e9}
            before = against_before(entry, row, flops, H100_BF16_FLOPS, key=(BATCH, c, t))
            rows.append(row)
            rejected = all(not p["ok"] for p in planted.values())
            log(f"{entry} [{BATCH},{c},{t}] ({row['where']}): vs plain max|d| {err:.3e}, "
                f"edges {edge:.3e} (limit {limit:.3e}), rel L2 {rel:.3e} (limit "
                f"{ATTN_REL_L2:g}) {'ok' if ok else 'FAIL'}; planted "
                + ", ".join(f"{f}: rel L2 {p['rel_l2']:.3e} max|d| {p['max_abs_err']:.3e} "
                            f"edges {p['edge_max_abs_err']:.3e}" for f, p in planted.items())
                + f" {'rejected' if rejected else 'NOT REJECTED'}; kernel {ms:.4f} ms "
                f"({row['tflops']:.1f} TFLOP/s, {before}), plain {plain_ms:.4f} ms, module "
                f"path (cuDNN) {module_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if not ok:
                failures.append(f"{entry} disagrees with its plain version at "
                                f"[{BATCH},{c},{t}]: rel L2 {rel}, max |d| {err}, edges {edge}")
            if not rejected:
                failures.append(f"the MRF limits do not reject a planted fault at "
                                f"{entry} [{BATCH},{c},{t}]: {planted}")
            del got, ref
        del x, x_rows, m
    if failures:
        raise RuntimeError("; ".join(failures))
    return rows


def test_signal(seconds: float, sr: int, seed: int):
    """Seeded harmonic test signal with a little noise, peak 0.5."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = np.zeros_like(t)
    for h in range(1, 30):
        f = 196.0 * h
        if f >= sr / 2:
            break
        x += np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) / h
    x += 0.01 * rng.standard_normal(t.shape)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)[None, :]


# relative L2 limits of the full config in bf16 on the card against
# float32 arithmetic on the CPU, one chunk, seeded weights: each lies
# between the sound reading (1.61e-2, 1.55e-2, 2.14e-2) and the planted
# fault's (2.26e-2, 2.08e-2, 2.88e-2) on an H100 (PERF.md, Findings)
REF_LIMITS = {"mel_hr": 1.9e-2, "wave": 1.8e-2, "high_band": 2.5e-2}
# relative L2 limits of the same comparison with attention the only
# difference: the card's bf16 pipeline through attn_rows against the same
# card pipeline whose attention is the plain version in float32; each
# lies between the sound reading (1.93e-2, 1.92e-2, 2.65e-2) and that of
# every attention dropping its last key tile (2.61e-2, 2.46e-2, 3.40e-2)
# on an H100 (PERF.md, Findings).  The bf16 layers after each attention
# carry any change of its rounding to ~2% of the output, so this gap is
# no wider than the CPU comparison's; the per-call check below is wide
ATTN_ONLY_LIMITS = {"mel_hr": 2.25e-2, "wave": 2.15e-2, "high_band": 3.0e-2}
# each attention call of that chunk against the float32 plain version on
# its own inputs, relative L2: the kernel reads at most 1.7e-3, the
# dropped last key tile at least 5.6e-3 (the path's softmax rows are
# peaked, so the last 64 keys carry little weight in some calls) on an H100
ATTN_CALL_LIMIT = 3e-3


def legacy_init(mods, seed: int):
    """The seeded weights the earlier phases' limits were measured on:
    flax-like scales drawn from a torch generator in module order
    (``layers.seeded_init_``), the draw ``FlashSRModules.init_params`` made
    before it took the JAX package's (``fast_init_like``).  Their bf16
    against float32 readings sit between the sound run and the planted
    fault for these weights; other weights move them."""
    import torch

    from egregora_tpu_torch.models.flashsr.layers import seeded_init_
    gen = torch.Generator().manual_seed(int(seed))
    for m in mods.all():
        seeded_init_(m, gen)
    return mods


def reference_phase() -> None:
    """The full config on one chunk, seeded weights: bf16 on the card
    (through the kernel) against float32 arithmetic on the CPU (plain
    versions) with the same weights (rounded to bf16), and against the
    same card pipeline with its attention in float32 (the plain version):
    the second comparison sees the attention kernel alone.
    Compared: the decoded mel, the vocoder's wave and the output's band
    above the crossover (what the model adds; below it the output is the
    input).  A planted fault, every attention dropping its last key tile,
    gives the control reading, which the limits must reject."""
    import dataclasses

    import torch

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.ops import attention
    from egregora_tpu_torch.ops.attn_rows import attn_rows_plain

    def cfg(dtype):
        c = P.FlashSRConfig()
        return dataclasses.replace(c, **{k: dataclasses.replace(getattr(c, k), dtype=dtype)
                                         for k in ("vae", "unet", "vocoder")})

    x = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=2)[:, :P.CHUNK_SAMPLES])

    def outputs(pipe):
        t = time.perf_counter()
        mel, wav = pipe.synthesize(x.to(pipe.device))
        y = pipe.chunk_forward(x)
        high = y - P.lowpass_fir(y, P.REQ_SR, pipe.cfg.crossover_hz)
        log(f"reference: one chunk on {pipe.device.type}: {time.perf_counter() - t:.1f} s")
        return {"mel_hr": mel.float().cpu(), "wave": wav.float().cpu(),
                "high_band": high.float().cpu()}

    cpu = P.FlashSRPipeline(cfg(torch.float32), seed=1, device="cpu")
    legacy_init(cpu.modules, 1)
    with torch.no_grad():     # the card's weights: the same draw, rounded to bf16
        for m in cpu.modules.all():
            for p in m.parameters():
                p.copy_(p.bfloat16().float())
    ref = outputs(cpu)
    card = P.FlashSRPipeline(cfg(torch.bfloat16), seed=1, device="cuda")
    legacy_init(card.modules, 1)
    sound = outputs(card)
    kernel = attention.attn_rows
    calls = []

    def f32_attention(q, k, v):
        return attn_rows_plain(q.float(), k.float(), v.float())

    def checked(q, k, v):
        """The kernel, held on the spot to the float32 plain version on the
        pipeline's own inputs, beside the dropped last key tile."""
        got = kernel(q, k, v)
        ref32 = f32_attention(q, k, v)
        calls.append((tuple(q.shape), rel_l2(got.float(), ref32),
                      rel_l2(drop_last_tile(q, k, v).float(), ref32)))
        return got

    try:
        attention.attn_rows = checked
        outputs(card)
        attention.attn_rows = drop_last_tile
        planted = outputs(card)
        attention.attn_rows = lambda q, k, v: f32_attention(q, k, v).to(q.dtype)
        attn_ref = outputs(card)
    finally:
        attention.attn_rows = kernel
    failures = []
    good = max(c[1] for c in calls)
    bad = min(c[2] for c in calls)
    log(f"reference attention per call ({len(calls)} calls of one chunk, shapes "
        f"{sorted(set(c[0] for c in calls))}): attn_rows vs float32 plain on the same inputs, "
        f"relative L2 at most {good:.3e} (limit {ATTN_CALL_LIMIT:g}) "
        f"{'ok' if good <= ATTN_CALL_LIMIT else 'FAIL'}; planted fault (last key tile dropped) "
        f"at least {bad:.3e} {'rejected' if bad > ATTN_CALL_LIMIT else 'NOT REJECTED'}")
    if not good <= ATTN_CALL_LIMIT:
        failures.append(f"attention per call: {good}")
    if not bad > ATTN_CALL_LIMIT:
        failures.append("attention per call: the dropped key tile passes")
    for label, limits, base in (("bf16 card vs f32 cpu", REF_LIMITS, ref),
                                ("attention only: attn_rows vs f32 plain on the card",
                                 ATTN_ONLY_LIMITS, attn_ref)):
        for key, limit in limits.items():
            good, bad = rel_l2(sound[key], base[key]), rel_l2(planted[key], base[key])
            log(f"reference {key}, {label}: relative L2 {good:.3e} (limit {limit:g}) "
                f"{'ok' if good <= limit else 'FAIL'}; planted fault (last key tile dropped) "
                f"{bad:.3e} {'rejected' if bad > limit else 'NOT REJECTED'}")
            if not good <= limit:
                failures.append(f"{label}: {key} reads {good}")
            if not bad > limit:
                failures.append(f"{label}: the {key} limit does not reject a dropped last key tile")
    if failures:
        raise RuntimeError("; ".join(failures))


def reset_counts() -> None:
    """Every kernel's launch counts to 0 (Snake's too), and the kernels' FLOP logs
    (``FLOP_LOG`` of ``ops.attn_rows``, which ``ops.attn_flash`` shares,
    ``ops.mrf_rows`` and ``ops.conv_edge``) emptied."""
    from egregora_tpu_torch.ops import attn_flash as af
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops import conv_edge as ce
    from egregora_tpu_torch.ops import iir_lowpass as il
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    from egregora_tpu_torch.ops import snake as sn
    for mod in (ar, mf, mr, il, af, ce):
        mod.launches = 0
        mod.launches_by_shape.clear()
    ce.launches_by_route.clear()
    sn.launches = 0
    for mod in (ar, mr, ce):
        mod.FLOP_LOG.clear()


def read_counts() -> dict:
    """Launches since ``reset_counts`` by kernel and shape; mrf_rows's
    (b, t, c) shapes are given as (b, c, t), as mrf_fused_cm's."""
    from egregora_tpu_torch.ops import attn_flash as af
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops import conv_edge as ce
    from egregora_tpu_torch.ops import iir_lowpass as il
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    return {"attn_rows": dict(ar.launches_by_shape),
            "mrf_fused_cm": dict(mf.launches_by_shape),
            "mrf_rows": {(b, c, t): n for (b, t, c), n in mr.launches_by_shape.items()},
            "iir_lowpass": dict(il.launches_by_shape),
            "flash_online": dict(af.launches_by_shape),
            "conv3x3_out1": dict(ce.launches_by_shape)}


def flop_check(phase: str, counts: dict) -> dict:
    """The FLOP logs' sums since ``reset_counts`` against this script's
    own FLOPs for the launches ``counts`` (``read_counts()``) holds since
    the same reset: attention ``4 BH N^2 D`` (attn_rows and flash_online,
    one log), ``mrf_flops`` a block (three launches, one a branch),
    ``18 B F M C`` a K3 launch.  Every call of a wrapper on the card
    launches its kernel, so they must be equal (to float rounding)."""
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops import conv_edge as ce
    from egregora_tpu_torch.ops import mrf_rows as mr
    got = {"attn_rows": float(sum(ar.FLOP_LOG)), "mrf_rows": float(sum(mr.FLOP_LOG)),
           "conv3x3_out1": float(sum(ce.FLOP_LOG))}
    want = {"attn_rows": sum(4.0 * bh * n * n * d * k for kernel in ("attn_rows", "flash_online")
                             for (bh, n, d), k in counts[kernel].items()),
            "mrf_rows": sum(k / len(MRF_KERNELS) * mrf_flops(c, t, b)
                            for (b, c, t), k in counts["mrf_rows"].items()),
            "conv3x3_out1": sum(18.0 * b * f * m * c * k
                                for (b, f, m, c), k in counts["conv3x3_out1"].items())}
    ok = all(abs(got[k] - want[k]) <= 1e-9 * max(want[k], 1.0) for k in got)
    log(f"FLOP_LOG {phase}: " + "; ".join(f"{k} {got[k]:.6e} (reckoned {want[k]:.6e})"
                                          for k in got) + (" equal" if ok else " DIFFERENT"))
    if not ok:
        raise RuntimeError(f"{phase}: the FLOP logs {got} differ from the launches' FLOPs {want}")
    return {"flop_log": got, "reckoned": want}


def flop_checked(phase: str, fn):
    """``fn()`` between ``reset_counts`` and ``flop_check``; (its result,
    the check)."""
    from egregora_tpu_torch.utils import profiling
    reset_counts()
    with profiling.recording():           # the FLOP logs append only while recording
        out = fn()
    return out, flop_check(phase, read_counts())


class weights_root:
    """``EGREGORA_TPU_WEIGHTS`` set to ``root`` for the span and restored
    after, with the upscaler node's cached pipeline dropped at both edges
    (the cache, like the JAX node's, outlives a change of weights)."""

    def __init__(self, root):
        self.root = str(root)

    def __enter__(self):
        import os

        from egregora_tpu_torch.nodes import super_resolution
        self.prev = os.environ.get("EGREGORA_TPU_WEIGHTS")
        os.environ["EGREGORA_TPU_WEIGHTS"] = self.root
        super_resolution.EgregoraAudioSuperResolution._PIPE = None
        return self

    def __exit__(self, *exc):
        import os

        from egregora_tpu_torch.nodes import super_resolution
        if self.prev is None:
            os.environ.pop("EGREGORA_TPU_WEIGHTS", None)
        else:
            os.environ["EGREGORA_TPU_WEIGHTS"] = self.prev
        super_resolution.EgregoraAudioSuperResolution._PIPE = None
        return False


def set_env(**values) -> None:
    """Set (a string) or unset (None) the port's environment switches."""
    import os
    for key, val in values.items():
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val


def shipped_trio(name: str):
    """(config, state dicts) of a shipped trio; a missing file fails."""
    from egregora_tpu_torch.models.flashsr import distill
    path = distill.SHIPPED_DIR / name
    loaded = distill.load_pretrained_with_cfg(path)
    if loaded is None:
        raise RuntimeError(f"the shipped weights {path} are missing")
    return loaded


def unscaled_attention(q, k, v):
    """A planted fault: attention without its D^-1/2 score scale, from
    the plain version."""
    from egregora_tpu_torch.ops.attn_rows import attn_rows_plain
    return attn_rows_plain(q * q.shape[-1] ** 0.5, k, v)


def planted_mrf(x, w, bias, kernels, dils):
    """``mrf_fused_cm`` with the last dilation's residual dropped."""
    return mrf_planted(x, w, bias, "drop_residual", round_then_bias=True)


# relative L2 limits of each shipped trio in bf16 on the card (the
# HiFi-GAN trio through the fused MRF kernel) against float32 arithmetic
# on the CPU with the card's bf16-rounded weights, one chunk; each lies
# between the sound reading and the planted fault's (PERF.md, Findings)
SERVED_REF_LIMITS = {
    "pretrained.npz": {"mel_hr": 9e-3, "wave": 0.1, "high_band": 0.35},
    "pretrained_istft.npz": {"mel_hr": 9e-3, "wave": 2.5e-3, "high_band": 3e-2},
}


def served_reference_phase() -> dict:
    """One chunk of each shipped trio, bf16 on the card against float32
    arithmetic on the CPU with the same (bf16-rounded) weights: the
    decoded mel, the vocoder's wave and the output's band above the
    crossover.  The planted fault, which the limits must reject: the
    attention without its score scale and, in the HiFi-GAN trio, the
    fused MRF without its last dilation's residual.  The HiFi-GAN trio's
    module-path vocoder is read beside it (bf16's own share)."""
    import dataclasses

    import torch

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr import vocoder as V
    from egregora_tpu_torch.ops import attention

    x = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=2)[:, :P.CHUNK_SAMPLES])

    def outputs(pipe):
        mel, wav = pipe.synthesize(x.to(pipe.device))
        y = pipe.chunk_forward(x)
        high = y - P.lowpass_fir(y, P.REQ_SR, pipe.cfg.crossover_hz)
        return {"mel_hr": mel.float().cpu(), "wave": wav.float().cpu(),
                "high_band": high.float().cpu()}

    readings, failures = {}, []
    for name in SERVED_REF_LIMITS:
        cfg, sd = shipped_trio(name)
        f32 = dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k),
                                                                 dtype=torch.float32)
                                          for k in ("vae", "unet", "vocoder")})
        rounded = {m: {k: v.bfloat16().float() for k, v in d.items()} for m, d in sd.items()}
        t = time.perf_counter()
        ref = outputs(P.FlashSRPipeline(f32, params=rounded, device="cpu"))
        log(f"served reference {name}: one chunk f32 on the CPU {time.perf_counter() - t:.1f} s")
        card = P.FlashSRPipeline(cfg, params=sd, device="cuda")
        hifigan = cfg.vocoder.kind == "hifigan"
        fault = "unscaled attention" + (", MRF residual dropped" if hifigan else "")
        set_env(EGREGORA_FUSED_VOCODER="1", EGREGORA_MRF_PATH=None)
        try:
            sound = outputs(card)
            real = attention.attn_rows, V.mrf_fused_cm
            attention.attn_rows = unscaled_attention
            if hifigan:
                V.mrf_fused_cm = planted_mrf
            try:
                planted = outputs(card)
            finally:
                attention.attn_rows, V.mrf_fused_cm = real
            if hifigan:
                set_env(EGREGORA_FUSED_VOCODER=None)
                module = outputs(card)
                log(f"served reference {name}: the module-path vocoder (cuDNN) in bf16 "
                    "reads " + ", ".join(f"{key} {rel_l2(module[key], ref[key]):.3e}"
                                         for key in ref))
        finally:
            set_env(EGREGORA_FUSED_VOCODER=None)
        for key, limit in SERVED_REF_LIMITS[name].items():
            good, bad = rel_l2(sound[key], ref[key]), rel_l2(planted[key], ref[key])
            readings[f"{name}:{key}"] = (good, bad)
            log(f"served reference {name} {key}: bf16 card vs f32 cpu relative L2 {good:.3e} "
                f"(limit {limit:g}) {'ok' if good <= limit else 'FAIL'}; planted fault "
                f"({fault}) {bad:.3e} {'rejected' if bad > limit else 'NOT REJECTED'}")
            if not good <= limit:
                failures.append(f"{name}: card and CPU disagree on {key}: {good}")
            if not bad > limit:
                failures.append(f"{name}: the {key} limit does not reject the planted fault")
        del card
    if failures:
        raise RuntimeError("; ".join(failures))
    return readings


# the node's paths, one-shot on the 12 s input (BATCH = 3 chunks): label,
# trio, switches, launches by kernel and shape
NODE_PATHS = [
    ("HiFi-GAN trio, fused MRF", "hifigan",
     {"EGREGORA_FUSED_VOCODER": "1", "EGREGORA_MRF_PATH": None},
     {"mrf_fused_cm": {(1, 64, 5120): 1, (1, 32, 40960): 1, (1, 16, 245760): 1}}),
    ("HiFi-GAN trio, rows MRF", "hifigan",
     {"EGREGORA_FUSED_VOCODER": "1", "EGREGORA_MRF_PATH": "rows"},
     {"mrf_rows": {(1, 64, 5120): 3, (1, 32, 40960): 3, (1, 16, 245760): 3}}),
    ("istft trio (default)", "",
     {"EGREGORA_FUSED_VOCODER": None, "EGREGORA_MRF_PATH": None}, {}),
]
# one-shot (pcm16 wire, batch 3) against streaming (float32, batches of
# 2) on the node's paths, relative L2: the bf16 convs of the VAE and the
# UNet take other cuDNN algorithms at another batch size, so the decoded
# mel moves by a bf16 ulp (0.094 at |mel| ~ 8 on an H100), and the
# input by the wire's step; the served trios carry that to 1.5e-2
# (HiFi-GAN, max |d| 0.24) and 1.3e-2 (istft, whose phase features of
# the empty band above 8 kHz follow rounding noise).  A chunk stitched
# in the wrong place reads ~1.
NODE_STREAM_REL_L2 = 5e-2
# relative L2 limit of the fused vocoder's wave against its module path
# (bf16 on the card, one chunk), between the sound reading and that of
# the planted fault (PERF.md, Findings)
FUSED_WAVE_LIMIT = 2e-2


def expected_counts(per_item: dict, b: int, batches: int) -> dict:
    """A path's launches at batch ``b`` over ``batches`` chunk batches,
    from its per-batch launches at batch 1 (the attention adds one
    ``SERVED_ATTN`` call a batch)."""
    heads, n, d = SERVED_ATTN
    out = {"attn_rows": {(b * heads, n, d): batches}, "mrf_fused_cm": {}, "mrf_rows": {},
           "iir_lowpass": {}, "flash_online": {}, "conv3x3_out1": {}}
    for kernel, shapes in per_item.items():
        out[kernel] = {(b, c, t): k * batches for (_, c, t), k in shapes.items()}
    return out


# the wire gate's arrays: (label, channels, seconds, rate, peak); a song
# as the music cell serves, and a voice file above full scale (peak > 1)
WIRE_CASES = (("song", 2, 240.0, 44100, 0.93), ("voice", 1, 12.0, 16000, 1.7))
WIRE_FAULTS = ("half_away", "host_divisor")


def host_wire(xs):
    """The pcm16 wire's input as the host computed it before it moved to
    the card: the numpy peak scan and ``pcm16_encode`` on the host, the
    int16 copy up, the dequantising product on the card (left there)."""
    import numpy as np
    import torch

    from egregora_tpu_torch.core.audio import pcm16_encode
    in_scale = max(1.0, float(np.max(np.abs(xs))) if xs.size else 1.0)
    q = pcm16_encode(xs / np.float32(in_scale))
    return torch.from_numpy(q).to("cuda").float() * np.float32(in_scale / 32767.0)


def planted_wire(x, fault: str):
    """A planted fault of ``core.audio.pcm16_roundtrip_`` on a copy of card
    tensor ``x``: ``half_away`` rounds halves away from zero where
    ``np.rint`` rounds them to even; ``host_divisor`` divides by the peak
    as a host scalar, which the card turns into a product with its
    reciprocal."""
    import torch
    x = x.clone()
    lo, hi = torch.aminmax(x)
    s = torch.maximum(hi, lo.neg()).clamp_(min=1.0)
    x.div_(float(s) if fault == "host_divisor" else s).clamp_(-1.0, 1.0).mul_(32767.0)
    x = torch.sign(x) * torch.floor(x.abs() + 0.5) if fault == "half_away" else x.round_()
    return x.add_(0.0).mul_((s.double() / 32767.0).float())


def wire_phase() -> dict:
    """The pcm16 wire's input quantisation on the card
    (``core.audio.pcm16_roundtrip_``, what ``FlashSRPipeline.process``
    runs on its one-shot path) against the host path it replaced
    (``host_wire``), bit for bit, on a song-length stereo array and a
    voice-length mono one above full scale, each seeded uniform noise
    (which puts thousands of samples on exact half steps); beside the
    planted faults (``WIRE_FAULTS``), each of which must change some
    sample (``host_divisor`` only where the peak is above 1); and the
    dequantising constant ``float32(s / 32767)`` for 2^20 float32 peaks
    in [1, 10^4) against numpy's.  Times: the card's quantisation (CUDA
    events), the host path (``host_wire``, host clock), and the pageable
    copy up of the float32 samples and of the int16 samples it replaced."""
    import numpy as np
    import torch

    from egregora_tpu_torch.core.audio import pcm16_roundtrip_

    def bits(t):
        return t.numpy().view(np.int32)

    def wall_ms(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    out, failures = {}, []
    for i, (label, c, seconds, sr, peak) in enumerate(WIRE_CASES):
        rng = np.random.default_rng(2100 + i)
        xs = (peak * rng.uniform(-1.0, 1.0, (c, int(seconds * sr)))).astype(np.float32)
        xs[-1, 11] = -peak                  # the peak on a negative sample
        s = max(1.0, float(np.abs(xs).max()))
        y = np.clip(xs / np.float32(s), -1.0, 1.0) * np.float32(32767.0)
        ties = int(np.count_nonzero(y - np.floor(y) == 0.5))
        want = host_wire(xs).cpu()
        xd = torch.from_numpy(xs).to("cuda", copy=True)
        got = pcm16_roundtrip_(xd.clone()).cpu()
        differ = int(np.count_nonzero(bits(got) != bits(want)))
        planted = {}
        for fault in WIRE_FAULTS:
            if fault == "host_divisor" and s == 1.0:
                continue
            planted[fault] = int(np.count_nonzero(bits(planted_wire(xd, fault).cpu())
                                                  != bits(want)))
        card_ms = cuda_ms(lambda: pcm16_roundtrip_(xd), 10)
        host_ms = wall_ms(lambda: host_wire(xs))      # numpy passes, int16 copy, product
        q16 = np.zeros(xs.shape, np.int16)
        up32 = wall_ms(lambda: torch.from_numpy(xs).to("cuda"))
        up16 = wall_ms(lambda: torch.from_numpy(q16).to("cuda"))
        out[label] = {"shape": list(xs.shape), "scale": s, "half_steps": ties,
                      "differ": differ, "planted_differ": planted, "card_ms": card_ms,
                      "host_path_ms": host_ms, "h2d_f32_ms": up32, "h2d_i16_ms": up16}
        log(f"pcm16 wire input, {label} {list(xs.shape)} (peak {s:g}, {ties} samples on half "
            f"steps): card against host {differ} samples differ "
            f"({'ok' if differ == 0 else 'FAIL'}); planted " + ", ".join(
                f"{f} {n} differ ({'rejected' if n else 'NOT REJECTED'})"
                for f, n in planted.items())
            + f"; card {card_ms:.3f} ms, host path {host_ms:.1f} ms; pageable copy up "
              f"float32 {up32:.2f} ms, int16 {up16:.2f} ms")
        if differ:
            failures.append(f"{label}: {differ} samples differ from the host path")
        failures += [f"{label}: the planted fault {f} changed no sample"
                     for f, n in planted.items() if not n]
        if ties == 0:
            failures.append(f"{label}: no sample on a half step, so half_away cannot show")
    peaks = (1.0 + np.random.default_rng(2199).uniform(0.0, 1e4, 1 << 20)).astype(np.float32)
    want_c = np.array([np.float32(float(p) / 32767.0) for p in peaks])
    got_c = (torch.from_numpy(peaks).to("cuda").double() / 32767.0).float().cpu().numpy()
    c_differ = int(np.count_nonzero(got_c.view(np.int32) != want_c.view(np.int32)))
    out["constant_differ"] = c_differ
    log(f"pcm16 wire constant float32(s / 32767), {len(peaks)} peaks: {c_differ} differ "
        f"({'ok' if c_differ == 0 else 'FAIL'})")
    if c_differ:
        failures.append(f"the dequantising constant differs for {c_differ} peaks")
    if failures:
        raise RuntimeError("pcm16 wire gate: " + "; ".join(failures))
    return out


def node_phase() -> dict:
    """The ``EgregoraAudioUpscaler`` node on a comfy AUDIO dict (the
    seeded 12 s 16 kHz signal to 48 kHz) on each path of ``NODE_PATHS``,
    one-shot through ``run`` and streaming (``max_batch=2``) through the
    node's pipeline, with every kernel's launches counted by shape; the
    fused and rows vocoders against the module path on one chunk's wave,
    beside the planted fault."""
    import numpy as np
    import torch

    from egregora_tpu_torch.core.audio import from_any
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr import vocoder as V
    from egregora_tpu_torch.nodes import super_resolution

    node_cls = super_resolution.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]
    sr_in, sr_out = 16000, 48000
    x = test_signal(SECONDS, sr_in, seed=0)
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": sr_in}
    n_out = int(SECONDS * sr_out)
    results, trio = {}, None
    for label, variant, switches, per_item in NODE_PATHS:
        set_env(EGREGORA_FLASHSR_VARIANT=variant, **switches)
        if variant != trio:
            node_cls._PIPE = None
            trio = variant
        node = node_cls()
        t = time.perf_counter()
        pipe = node._pipeline()
        want = "distilled" if variant == "hifigan" else "distilled-istft"
        if pipe.weight_source != want or pipe.device.type != "cuda":
            raise RuntimeError(f"{label}: the node resolved {pipe.weight_source} on "
                               f"{pipe.device}, not the shipped {want} trio on the card")
        log(f"node {label}: pipeline ({pipe.weight_source}, {pipe.cfg.vocoder.kind} "
            f"vocoder) ready in {time.perf_counter() - t:.1f} s")
        one = None
        for run_no in ("cold", "warm"):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            (out,) = node.run(audio, lowpass_input=False, output_sr=str(sr_out))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = read_counts()
            one = out["waveform"].numpy()
            finite = bool(np.isfinite(one).all())
            log(f"node {label} one-shot ({run_no}): {wall:.3f} s wall, RTF "
                f"{SECONDS / wall:.1f}x real time, out {one.shape} @ {out['sample_rate']} Hz, "
                f"finite {finite}, launches {counts}")
            if one.shape != (1, 1, n_out) or not finite or out["sample_rate"] != sr_out:
                raise RuntimeError(f"node {label}: bad output {one.shape}, finite={finite}")
            expect = expected_counts(per_item, BATCH, 1)
            if counts != expect:
                raise RuntimeError(f"node {label}: launches {counts}, expected {expect}")
        results[label] = {"wall_s": wall, "rtf": SECONDS / wall, "counts": counts}
        reset_counts()
        t = time.perf_counter()
        stream = pipe.process(from_any(audio), output_sr=sr_out, max_batch=2).numpy()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        counts_s = read_counts()
        expect = expected_counts(per_item, 2, 2)
        diff = float(np.abs(one[0] - stream).max())
        rel = rel_l2(torch.from_numpy(stream), torch.from_numpy(one[0]))
        log(f"node {label} streaming max_batch=2: {wall_s:.3f} s wall, launches {counts_s}; "
            f"one-shot vs streaming relative L2 {rel:.3e} (limit {NODE_STREAM_REL_L2:g}), "
            f"max|d| {diff:.3e}")
        if counts_s != expect:
            raise RuntimeError(f"node {label} streaming: launches {counts_s}, expected {expect}")
        if stream.shape != (1, n_out) or not rel <= NODE_STREAM_REL_L2:
            raise RuntimeError(f"node {label}: one-shot and streaming disagree: {rel}")
        results[label]["streaming_wall_s"] = wall_s
        if variant == "hifigan":      # the kernels' vocoder against the module path
            chunk = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=3)).to("cuda")
            wav = pipe.synthesize(chunk)[1]
            set_env(EGREGORA_FUSED_VOCODER=None)
            module = pipe.synthesize(chunk)[1]
            set_env(**switches)
            rel = rel_l2(wav.float(), module.float())
            line = (f"node {label}: vocoder wave vs the module path relative L2 {rel:.3e} "
                    f"(limit {FUSED_WAVE_LIMIT:g})")
            if switches["EGREGORA_MRF_PATH"] is None:
                real, V.mrf_fused_cm = V.mrf_fused_cm, planted_mrf
                try:
                    bad = rel_l2(pipe.synthesize(chunk)[1].float(), module.float())
                finally:
                    V.mrf_fused_cm = real
                line += (f"; planted fault (last dilation's residual dropped) {bad:.3e} "
                         f"{'rejected' if bad > FUSED_WAVE_LIMIT else 'NOT REJECTED'}")
                if not bad > FUSED_WAVE_LIMIT:
                    raise RuntimeError(f"the fused-wave limit does not reject the planted fault")
                results[label]["planted_wave_rel_l2"] = bad
            log(line)
            if not rel <= FUSED_WAVE_LIMIT:
                raise RuntimeError(f"node {label}: the vocoder wave is {rel} from the module path")
            results[label]["wave_rel_l2"] = rel
    set_env(EGREGORA_FLASHSR_VARIANT=None, EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)
    node_cls._PIPE = None
    return results


def pipeline_phase() -> dict:
    import numpy as np
    import torch

    from egregora_tpu_torch.core.audio import AudioBuffer
    from egregora_tpu_torch.models.flashsr.pipeline import (
        CHUNK_SAMPLES, HOP_SAMPLES, FlashSRConfig, FlashSRPipeline)
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops.wola import num_chunks

    sr_in, sr_out = 16000, 48000
    x = test_signal(SECONDS, sr_in, seed=0)
    n_out = int(SECONDS * sr_out)
    k = num_chunks(n_out, CHUNK_SAMPLES, HOP_SAMPLES)
    if k != BATCH:
        raise RuntimeError(f"the test signal makes {k} chunks, not {BATCH}")
    t0 = time.perf_counter()
    pipe = FlashSRPipeline(FlashSRConfig(), seed=0, device="cuda")
    legacy_init(pipe.modules, 0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in pipe.modules.all() for p in m.parameters())
    log(f"pipeline: full config, {n_params / 1e6:.1f}M params from seed 0 "
        f"in {time.perf_counter() - t0:.1f} s; input {SECONDS:g} s @ {sr_in} Hz "
        f"-> {k} chunks @ {sr_out} Hz")

    def run(max_batch):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.process(AudioBuffer(x, sr_in), output_sr=sr_out,
                           max_batch=max_batch).numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        if counts["mrf_fused_cm"] or counts["mrf_rows"]:
            raise RuntimeError(f"the full config's module-path vocoder launched {counts}")
        return out, wall, ar.launches, counts["attn_rows"]

    results = {}
    for label, b, batches in (("one-shot", k, 1), ("streaming max_batch=2", 2, -(-k // 2))):
        expect = {(b * h, n, d): c * batches for (h, n, d), c in PATH_CALLS.items()}
        for run_no in ("cold", "warm"):      # the first call sets up cuDNN/cuBLAS
            out, wall, launches, counts = run(None if b == k else b)
            finite = bool(np.isfinite(out).all())
            log(f"pipeline {label} ({run_no}): {wall:.3f} s wall, RTF "
                f"{SECONDS / wall:.1f}x real time, out {out.shape}, finite {finite}, "
                f"attn_rows launches {launches} by (bh, n, d) {counts}")
            if out.shape != (1, n_out) or not finite:
                raise RuntimeError(f"pipeline {label}: bad output {out.shape}, "
                                   f"finite={finite}")
            if counts != expect or launches != sum(expect.values()):
                raise RuntimeError(f"pipeline {label}: attn_rows launches {launches} "
                                   f"{counts}, expected {expect}")
        results[label] = (out, launches, counts)
    one, stream = results["one-shot"][0], results["streaming max_batch=2"][0]
    diff = float(np.abs(one - stream).max())
    log(f"pipeline one-shot vs streaming: max|d| {diff:.3e}")
    if diff > 5e-2:
        raise RuntimeError(f"one-shot and streaming disagree: max |d| {diff}")
    return {"launches": results["one-shot"][1], "counts": results["one-shot"][2],
            "launches_streaming": results["streaming max_batch=2"][1]}


def kernel_agreement(got, ref):
    """``(ok, rel_l2, max |d|, max-|d| limit)``: ``bf16_agreement`` for a
    bf16 result, ``f32_agreement``'s limits for a float32 one."""
    import torch
    if got.dtype == torch.bfloat16:
        return bf16_agreement(got, ref)
    ok, rel, err = f32_agreement(got, ref)
    return ok, rel, err, F32_REL * float(ref.float().abs().max())


def bound(flops: float, nbytes: float, peak: float) -> tuple:
    """(bound ms, bound_by): the larger of operations at ``peak`` and
    bytes at the HBM rate."""
    ops_s, byte_s = flops / peak, nbytes / H100_BYTES_PER_S
    return max(ops_s, byte_s) * 1e3, "operations" if ops_s >= byte_s else "bytes"


# the repaired kernels' new shapes: attention (bh, n, d, dtype) -- the
# legacy geometry's mid block (4 heads of 24 at B = 3), a ragged head
# size, float32, head sizes above 256 (320 is padded to 512; 512 runs
# 32 q rows a block in bf16, 16 in float32); MRF (c, t, dtype) at B = 3 -- channel_floor=8 and C = 24
# in bf16 (padded to 16 and 32 channels), C = 16 in float32
REPAIR_ATTN = [(12, 512, 24, "bfloat16"), (8, 1000, 40, "bfloat16"), (12, 512, 32, "float32"),
               (2, 1000, 320, "bfloat16"), (1, 2048, 512, "float32"), (2, 300, 320, "float32")]
REPAIR_MRF = [(8, 40960, "bfloat16"), (24, 40960, "bfloat16"), (16, 40960, "float32")]


def repair_phase() -> dict:
    """``attn_rows`` and both MRF entries at the shapes and dtypes they
    refused before (head sizes outside 32/64/256, C not a multiple of 16,
    float32), each against its plain version beside the planted faults;
    then the ``EgregoraAudioUpscaler`` node on a ``channel_floor=8``
    HiFi-GAN config with the fused vocoder."""
    import torch
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    from egregora_tpu_torch.ops.attn_rows import attn_rows_plain

    attn, mrf, failures = [], [], []
    gen = torch.Generator().manual_seed(5)
    for bh, n, d, dt in REPAIR_ATTN:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(bh, n, d, generator=gen).to("cuda", dtype) for _ in range(3))
        got = ar.attn_rows(q, k, v)
        torch.cuda.synchronize()
        plain = attn_rows_plain(q, k, v)
        ok, rel, err, limit = kernel_agreement(got, plain)
        bad_ok, bad_rel, bad_err, _ = kernel_agreement(drop_last_tile(q, k, v), plain)
        size = q.element_size()
        bound_ms, bound_by = bound(4.0 * bh * n * n * d, 4.0 * bh * n * d * size,
                                   H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS)
        ms = cuda_ms(lambda: ar.attn_rows(q, k, v), 20)
        plain_ms = cuda_ms(lambda: attn_rows_plain(q, k, v), 5, 1)
        heads = 4 if d == 24 else max(1, bh // BATCH)
        q4, k4, v4 = (t.view(-1, heads, n, d) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
        row = {"bh": bh, "n": n, "d": d, "dtype": dt, "max_abs_err": err, "rel_l2": rel,
               "max_abs_limit": limit, "planted_rel_l2": bad_rel, "planted_max_abs_err": bad_err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        before = against_before("attn_rows", row, 4.0 * bh * n * n * d,
                                H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS)
        attn.append(row)
        log(f"repair attn_rows [{bh},{n},{d}] {dt}: vs plain max|d| {err:.3e} (limit "
            f"{limit:.3e}), rel L2 {rel:.3e} {'ok' if ok else 'FAIL'}; planted fault (last "
            f"{fault_tile(d)}-key tile dropped) max|d| {bad_err:.3e}, rel L2 {bad_rel:.3e} "
            f"{'rejected' if not bad_ok else 'NOT REJECTED'}; kernel {ms:.4f} ms ({before}), "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        if not ok:
            failures.append(f"attn_rows [{bh},{n},{d}] {dt} disagrees: {rel}, {err}")
        if bad_ok:
            failures.append(f"attn_rows [{bh},{n},{d}] {dt}: the planted fault passes")

    for c, t, dt in REPAIR_MRF:
        dtype = getattr(torch, dt)
        m = mrf_module(c, seed=c, dtype=dtype).to("cuda")
        w, bias = mf.pack_resblock_weights(m, dtype)
        g = torch.Generator().manual_seed(t + c)
        x = (0.5 * torch.randn(BATCH, c, t, generator=g)).to("cuda", dtype)
        x_rows = x.transpose(1, 2).contiguous()
        branch_w = mf.branch_weights(w, c, MRF_KERNELS, len(MRF_DILS))

        def agree(got, ref):
            if dtype == torch.bfloat16:
                ok, rel, err, edge, limit = mrf_agreement(got, ref)
                return ok, rel, max(err, edge), limit
            return kernel_agreement(got, ref)

        def rows_plain():
            acc = None
            for bi, wb in enumerate(branch_w):
                h = mr.mrf_branch_rows_plain(x_rows, wb, bias[bi], MRF_DILS)
                acc = h if acc is None else acc + h
            return (acc / len(MRF_KERNELS)).transpose(1, 2)

        for entry, run, plain, circ in (
                ("mrf_fused_cm", lambda: mf.mrf_fused_cm(x, w, bias, MRF_KERNELS, MRF_DILS),
                 lambda: mf.mrf_fused_cm_plain(x, w, bias, MRF_KERNELS, MRF_DILS), True),
                ("mrf_rows", lambda: mr.mrf_rows(x_rows, w, bias, MRF_KERNELS,
                                                 MRF_DILS).transpose(1, 2), rows_plain, False)):
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            ok, rel, err, limit = agree(got, ref)
            planted = {f: agree(mrf_planted(x, w, bias, f, round_then_bias=circ), ref)
                       for f in MRF_FAULTS}
            rejected = all(not p[0] for p in planted.values())
            flops = mrf_flops(c, t, BATCH)
            launches = 1 if entry == "mrf_fused_cm" else len(MRF_KERNELS)
            bound_ms, bound_by = bound(flops, launches * 2.0 * BATCH * c * t * x.element_size(),
                                       H100_BF16_FLOPS if dtype == torch.bfloat16
                                       else H100_F32_FLOPS)
            ms = cuda_ms(run, 5)
            plain_ms = cuda_ms(plain, 2, 1)
            module_ms = cuda_ms(lambda: m(x), 3, 1)
            row = {"entry": entry, "b": BATCH, "c": c, "t": t, "dtype": dt, "max_abs_err": err,
                   "rel_l2": rel, "max_abs_limit": limit,
                   "planted": {f: {"rel_l2": p[1], "max_abs_err": p[2]} for f, p in planted.items()},
                   "ms": ms, "plain_ms": plain_ms, "module_ms": module_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "tflops": flops / ms / 1e9}
            mrf.append(row)
            log(f"repair {entry} [{BATCH},{c},{t}] {dt}: vs plain max|d| {err:.3e} (limit "
                f"{limit:.3e}), rel L2 {rel:.3e} {'ok' if ok else 'FAIL'}; planted "
                + ", ".join(f"{f}: rel L2 {p[1]:.3e} max|d| {p[2]:.3e}" for f, p in planted.items())
                + f" {'rejected' if rejected else 'NOT REJECTED'}; kernel {ms:.4f} ms "
                f"({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, module path "
                f"{module_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if not ok:
                failures.append(f"{entry} [{BATCH},{c},{t}] {dt} disagrees: {rel}, {err}")
            if not rejected:
                failures.append(f"{entry} [{BATCH},{c},{t}] {dt}: a planted fault passes")
        del x, x_rows, m
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"attn": attn, "mrf": mrf, "node": narrow_node_run()}


def narrow_node_run() -> dict:
    """The upscaler node on a seeded narrow HiFi-GAN config whose vocoder
    stages all have ``channel_floor=8`` channels, bf16, with the fused
    vocoder (``EGREGORA_FUSED_VOCODER=1``): every stage through
    ``mrf_fused_cm`` padded to 16 channels, the StudentUNet's 4-head mid
    attention at D = 8 through ``attn_rows``; its vocoder wave against the
    module path's."""
    import numpy as np
    import torch

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr import unet as U
    from egregora_tpu_torch.models.flashsr import vocoder as V
    from egregora_tpu_torch.nodes import super_resolution

    cfg = P.FlashSRConfig(
        vae=P.VAEConfig(base_channels=8, channel_mults=(1, 2, 4), latent_channels=16,
                        num_res_blocks=1, groups=4, mid_attn=False, use_quant_conv=False),
        unet=U.UNetConfig(base_channels=16, channel_mults=(1, 2, 2), num_res_blocks=1,
                          attn_levels=(), num_heads=4, time_dim=32, groups=4),
        vocoder=V.VocoderConfig(upsample_initial=16, channel_floor=8))
    node_cls = super_resolution.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]
    node_cls._PIPE = pipe = P.FlashSRPipeline(cfg, seed=0, device="cuda")
    legacy_init(pipe.modules, 0)
    x = test_signal(SECONDS, 16000, seed=0)
    set_env(EGREGORA_FUSED_VOCODER="1", EGREGORA_MRF_PATH=None)
    try:
        for _ in ("cold", "warm"):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            (out,) = node_cls().run({"waveform": torch.from_numpy(x[None]), "sample_rate": 16000},
                                    False, "48000")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = read_counts()
        y = out["waveform"].numpy()
        chunk = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=3)).to("cuda")
        wav = pipe.synthesize(chunk)[1]
        set_env(EGREGORA_FUSED_VOCODER=None)
        module = pipe.synthesize(chunk)[1]
    finally:
        set_env(EGREGORA_FUSED_VOCODER=None)
        node_cls._PIPE = None
    rel = rel_l2(wav.float(), module.float())
    fused = counts["mrf_fused_cm"]
    log(f"repair node (channel_floor=8, fused vocoder, bf16): warm {wall:.3f} s, out {y.shape}, "
        f"finite {bool(np.isfinite(y).all())}, launches {counts}; vocoder wave vs the module "
        f"path relative L2 {rel:.3e} (limit {FUSED_WAVE_LIMIT:g})")
    if y.shape != (1, 1, int(SECONDS * 48000)) or not np.isfinite(y).all():
        raise RuntimeError(f"the channel_floor=8 node gave {y.shape}, finite={np.isfinite(y).all()}")
    if sum(fused.values()) != 3 or any(c != 8 for (_, c, _) in fused):
        raise RuntimeError(f"the channel_floor=8 node's fused vocoder launched {fused}")
    if not counts["attn_rows"] or any(d != 8 for (_, _, d) in counts["attn_rows"]):
        raise RuntimeError(f"the channel_floor=8 node's attention launched {counts['attn_rows']}")
    if not rel <= FUSED_WAVE_LIMIT:
        raise RuntimeError(f"the channel_floor=8 fused vocoder is {rel} from the module path")
    return {"wall_s": wall, "wave_rel_l2": rel, "counts": {k: {str(s): n for s, n in v.items()}
                                                           for k, v in counts.items()}}


# K4: the K-weighting pole at 48 kHz and the shapes it runs at -- (C, N),
# pole, where
K48 = math.exp(-2.0 * math.pi * 60.0 / 24000.0)
K96 = math.exp(-2.0 * math.pi * 60.0 / 48000.0)
K4_SHAPES = [((2, 14_400_000), K48, "300 s of 48 kHz stereo (the meter)"),
             ((1, 11_520_000), K96, "120 s of 96 kHz mono (the full chain's meter)"),
             ((2, 2_880_000), K48, "60 s of 48 kHz stereo (gain match, null test)"),
             ((1, 100), K48, "shorter than a tile"),
             ((3, 32_769), K48, "a ragged tile edge"),
             ((1, 4_194_304), 0.9999, "a pole near 1"),
             ((2, 11_520_000), K96, "120 s of 96 kHz stereo (the full-chain example's meter)"),
             ((1, 4_800), K48, "100 ms of 48 kHz (the bootstrap's loudness warmup)")]


def dropped_carry(x, k):
    """A planted fault of K4: every tile (``TILE`` samples) scanned from a zero
    state (the cross-tile carry dropped), from the plain version."""
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import iir_lowpass as il
    c, n = x.shape
    nt = -(-n // il.TILE)
    xp = F.pad(x, (0, nt * il.TILE - n)).reshape(c * nt, il.TILE)
    return il.iir_lowpass_plain(xp, k).reshape(c, nt * il.TILE)[:, :n]


def one_step_lookback(x, k):
    """A planted fault of K4's look-back: it stops after one predecessor's
    aggregate, so each tile's carry is the previous tile's end state from
    a zero state (the carry into that tile left out), from the plain
    version and the float64 powers.  It differs from the sound scan by
    p^TILE times that left-out carry: invisible at the 48 kHz pole
    (p^8192 ~ 1e-56), about 0.44 of it at pole 0.9999."""
    import torch
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import iir_lowpass as il
    c, n = x.shape
    nt = -(-n // il.TILE)
    xp = F.pad(x, (0, nt * il.TILE - n)).reshape(c * nt, il.TILE)
    local = il.iir_lowpass_plain(xp, k).reshape(c, nt, il.TILE)
    carry = torch.zeros_like(local[..., 0])
    carry[:, 1:] = local[:, :-1, -1]
    pw = torch.from_numpy(il.pole_tables(float(k))[1:il.TILE + 1]).to(x.device)
    return (local + carry[..., None] * pw).reshape(c, nt * il.TILE)[:, :n]


def one_step_visible(k: float) -> bool:
    """Whether ``one_step_lookback`` must fail the limit at pole k: where
    k^TILE times a carry of the signal's scale is above it."""
    from egregora_tpu_torch.ops import iir_lowpass as il
    return k ** il.TILE > 1e-3


def k4_phase() -> list:
    """``iir_lowpass`` (K4) against its plain version on the card and
    against float64 ``scipy.signal.lfilter`` on the host, beside two
    planted faults (which need more than one tile to show): the cross-tile
    carry dropped, and a look-back that stops after one predecessor's
    aggregate (rejected where the pole makes it visible,
    ``one_step_visible``), with its time, the plain version's and the
    bound: 8 bytes a sample (one float32 read, one written) at the HBM
    rate.  No PyTorch call computes a first-order recurrence, so there is
    no library time."""
    import torch
    from scipy.signal import lfilter

    from egregora_tpu_torch.ops import iir_lowpass as il

    rows, failures = [], []
    for (c, n), k, where in K4_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = 0.5 * torch.randn(c, n, generator=gen, device="cuda")
        got = il.iir_lowpass(x, k)
        torch.cuda.synchronize()
        plain = il.iir_lowpass_plain(x, k)
        ok, err = iir_agreement(got, plain)
        got_h = got.cpu()
        ref64 = torch.from_numpy(lfilter([1.0 - k], [1.0, -k], x.cpu().double().numpy(), axis=-1))
        ok64, err64 = iir_agreement(got_h, ref64)
        plain_err64 = iir_agreement(plain.cpu(), ref64)[1]
        tiles = -(-n // il.TILE)
        bad_ok, bad_err = iir_agreement(dropped_carry(x, k), plain) if tiles > 1 else (None, None)
        one_ok, one_err = (iir_agreement(one_step_lookback(x, k), plain) if tiles > 2
                           else (None, None))
        reps = max(3, min(200, int(2e9 / (c * n))))
        ms = cuda_ms(lambda: il.iir_lowpass(x, k), reps)
        dev_ms = graph_ms(lambda: il.iir_lowpass(x, k), min(reps, 20))
        plain_ms = cuda_ms(lambda: il.iir_lowpass_plain(x, k), 2, 1)
        bound_ms = 8.0 * c * n / H100_BYTES_PER_S * 1e3
        row = {"c": c, "n": n, "k": k, "where": where, "max_abs_err": err,
               "max_abs_err_f64": err64, "plain_max_abs_err_f64": plain_err64,
               "planted_max_abs_err": bad_err, "planted_one_step_max_abs_err": one_err,
               "limit": IIR_ABS, "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes", "gb_per_s": 8.0 * c * n / ms / 1e6}
        share = bound_share("iir_lowpass", row, (c, n))
        rows.append(row)
        planted = ("n/a (one tile)" if bad_ok is None else
                   f"{bad_err:.3e} {'rejected' if not bad_ok else 'NOT REJECTED'}")
        visible = one_step_visible(k)
        one = ("n/a (two tiles or fewer)" if one_ok is None else
               f"{one_err:.3e} " + ("rejected" if not one_ok else
                                    "NOT REJECTED" if visible else
                                    f"passes, invisible at this pole (p^{il.TILE} = "
                                    f"{k ** il.TILE:.1e})"))
        log(f"iir_lowpass [{c},{n}] k={k:.6f} ({where}): vs plain max|d| {err:.3e}, vs float64 "
            f"lfilter {err64:.3e} (plain {plain_err64:.3e}; limit {IIR_ABS:g}) "
            f"{'ok' if ok and ok64 else 'FAIL'}; planted faults: cross-tile carry dropped "
            f"{planted}, one-step look-back {one}; kernel {ms:.4f} ms "
            f"({row['gb_per_s']:.0f} GB/s, {share}), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms (bytes)")
        if not (ok and ok64):
            failures.append(f"iir_lowpass [{c},{n}] disagrees: {err} / {err64}")
        if bad_ok:
            failures.append(f"iir_lowpass [{c},{n}]: the dropped carry passes")
        if one_ok and visible:
            failures.append(f"iir_lowpass [{c},{n}] k={k}: the one-step look-back passes")
        del x, got, plain
    if failures:
        raise RuntimeError("; ".join(failures))
    return rows


def iir_entry(rows: list, counts: dict, by_path: dict) -> dict:
    """The ``kernels`` line's K4 entry: times and bound of the calls the
    eval path made, shape by shape (``counts``: (c, n) -> calls)."""
    by_shape = {(r["c"], r["n"]): r for r in rows}

    def total(key):
        return sum(by_shape[s][key] * n for s, n in counts.items())

    return {
        "name": "iir_lowpass", "route": "cuda",
        "source": "egregora_tpu_torch/csrc/iir_lowpass.cu",
        "replaces": "egregora_tpu/ops/pallas_iir.py:110",
        "launches": sum(counts.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": sum(8.0 * c * n * k for (c, n), k in counts.items())
        / H100_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "library_note": "no PyTorch call computes a first-order recurrence",
        "launches_by_shape": {f"{c}x{n}": k for (c, n), k in counts.items()},
        "launches_by_path": by_path,
        "shapes": rows,
    }



# ---- Snake (csrc/snake.cu) ----

# the DAC 44 kHz decoder's last stage (96 channels at the sample rate, past
# 2^31 elements) and its first (1536 channels at the frame rate), stereo,
# at the frames of the longest song of the benchmark's music traffic
SNAKE_FRAMES = 25356
SNAKE_SHAPES = [(2, 96, SNAKE_FRAMES * 512, "decoder last stage"),
                (2, 1536, SNAKE_FRAMES, "decoder first stage")]
SNAKE_CHUNK = 1 << 28       # elements the plain version computes at once in a check


def snake_ulps(got, ref) -> tuple:
    """``(largest distance, elements equal bit for bit)`` of two bf16 or
    float32 tensors of one shape, the distance counted in ulps of their
    dtype (the gap between their bit patterns in the order of the values)."""
    import torch
    bits, lo = ((torch.int16, -(1 << 15)) if got.dtype == torch.bfloat16
                else (torch.int32, -(1 << 31)))

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, lo - i, i)

    d = (ordered(got) - ordered(ref)).abs()
    return int(d.max()), int((d == 0).sum())


def snake_check(x, alpha, floor: float, y) -> tuple:
    """``(largest distance in ulps, share equal bit for bit)`` of the
    kernel's ``y`` against ``snake_plain(x, alpha, floor)`` rounded to
    ``y``'s dtype, computed a few channels of one batch row at a time."""
    from egregora_tpu_torch.ops import snake as sn
    b, c, t = x.shape
    step = max(1, SNAKE_CHUNK // t)
    worst, equal = 0, 0
    for i in range(b):
        for c0 in range(0, c, step):
            ref = sn.snake_plain(x[i:i + 1, c0:c0 + step], alpha[c0:c0 + step], floor).to(y.dtype)
            w, e = snake_ulps(y[i:i + 1, c0:c0 + step], ref)
            worst, equal = max(worst, w), equal + e
            del ref
    return worst, equal / x.numel()


def snake_phase() -> list:
    """The Snake kernel (``csrc/snake.cu``) on the card at ``SNAKE_SHAPES``
    (bf16 in, bf16 out, alphas U(0.5, 1.5) as the benchmark draws them),
    on a contiguous (NCW) input and on a channels-last (NWC) one, the
    layout of the DAC's activations: every element within one bf16 ulp of
    the plain version rounded to bf16, with the share equal bit for bit,
    and the output in the input's layout; beside it a planted fault (the
    divisor without its 1e-9 and the square dropped: ``sin(a x) / a``)
    that the limit must reject; the kernel's time, the plain version's and
    the bound: 4 bytes an element (bf16 in, bf16 out) at the HBM rate.  No
    PyTorch call computes Snake, so there is no library time."""
    import torch

    from egregora_tpu_torch.ops import snake as sn

    rows, failures = [], []
    for (b, c, t, where), layout in [(s, lay) for s in SNAKE_SHAPES for lay in ("ncw", "nwc")]:
        gen = torch.Generator(device="cuda").manual_seed(c)
        shape = (b, t, c) if layout == "nwc" else (b, c, t)
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16).mul_(3.0)
        if layout == "nwc":
            x = x.transpose(1, 2)
        alpha = 0.5 + torch.rand(c, generator=gen, device="cuda")
        before = sn.launches
        y = sn.snake_kernel(x, alpha, 0.0, torch.bfloat16)
        torch.cuda.synchronize()
        worst, equal = snake_check(x, alpha, 0.0, y)
        a = alpha[:, None]
        bad = (x[:, :, :4096].float() + torch.sin(a * x[:, :, :4096].float()) / a).bfloat16()
        bad_worst = snake_ulps(y[:, :, :4096], bad)[0]
        n = b * c * t
        reps = max(3, min(50, int(2e10 / n)))
        ms = cuda_ms(lambda: sn.snake_kernel(x, alpha, 0.0, torch.bfloat16), reps)
        plain_ms = cuda_ms(lambda: sn.snake_plain(x, alpha, 0.0).to(torch.bfloat16), 1, 1)
        bound_ms = 4.0 * n / H100_BYTES_PER_S * 1e3
        row = {"b": b, "c": c, "t": t, "layout": layout, "elements": n, "where": where,
               "max_ulps": worst, "bit_equal_share": equal, "planted_max_ulps": bad_worst,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "bound_share": bound_ms / ms, "gb_per_s": 4.0 * n / ms / 1e6}
        rows.append(row)
        ok = (worst <= 1 and sn.launches == before + 1 + reps + 2
              and y.stride() == x.stride())
        log(f"snake {layout} [{b},{c},{t}] ({where}, {n} elements): vs plain rounded to bf16 max "
            f"{worst} ulp, bit-equal {100 * equal:.4f}% (limit 1 ulp) {'ok' if ok else 'FAIL'}; "
            f"planted fault (sin(a x) / a): {bad_worst} ulp "
            f"{'rejected' if bad_worst > 1 else 'NOT REJECTED'}; kernel {ms:.4f} ms "
            f"({row['gb_per_s']:.0f} GB/s, {100 * row['bound_share']:.1f}% of the bound), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes)")
        if not ok:
            failures.append(f"snake {layout} [{b},{c},{t}]: {worst} ulp, launches "
                            f"{sn.launches - before}, strides {y.stride()} for {x.stride()}")
        if bad_worst <= 1:
            failures.append(f"snake {layout} [{b},{c},{t}]: the planted fault passes")
        del x, y, bad
        torch.cuda.empty_cache()
    ptxas = [{"kernel": k, **r} for k, r in ptxas_entries("snake").items()]
    if len(ptxas) != 12:
        failures.append(f"snake: {len(ptxas)} built kernels, expected 12 (bf16/float32 in and "
                        f"out; NCW, NWC by vectors and NWC by channels)")
    for r in ptxas:
        log(f"ptxas snake {r['kernel']}: {r.get('registers')} registers, spill stores "
            f"{r.get('spill_store_bytes')} B, stack {r.get('stack_bytes')} B")
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"shapes": rows, "ptxas": ptxas}


def snake_entry(phase: dict, by_path: dict) -> dict:
    """The ``kernels`` line's Snake entry: the launches the DAC paths made
    (``by_path``) and one call's times and bound at each of
    ``SNAKE_SHAPES`` in the DAC's channels-last layout, summed (the paths
    launch at every stage of songs of other lengths); the agreement over
    both layouts."""
    rows = phase["shapes"]
    nwc = [r for r in rows if r["layout"] == "nwc"]
    return {
        "name": "snake", "route": "cuda",
        "source": "egregora_tpu_torch/csrc/snake.cu",
        "replaces": "none (the JAX package's Snake is plain jnp: "
                    "egregora_tpu/models/dac/model.py::snake)",
        "launches": sum(by_path.values()),
        "max_ulps": max(r["max_ulps"] for r in rows),
        "bit_equal_share": min(r["bit_equal_share"] for r in rows),
        "ms": sum(r["ms"] for r in nwc), "plain_ms": sum(r["plain_ms"] for r in nwc),
        "bound_ms": sum(r["bound_ms"] for r in nwc), "bound_by": "bytes",
        "library_ms": None, "library_note": "no single PyTorch call computes Snake",
        "times_at": "one call at each of the shapes, channels-last",
        "launches_by_path": by_path,
        "shapes": rows, "ptxas": phase["ptxas"],
    }


EVAL_SR = 48000
METER_SECONDS = 300.0       # the meter on 300 s of 48 kHz stereo
PAIR_SECONDS = 60.0         # the pair nodes on 60 s of 48 kHz stereo
PLANTED_DELAY = 37.25       # samples: B is A delayed ...
PLANTED_GAIN_DB = -3.0      # ... and scaled
# card (K4, cuFFT, the card's matmuls) against the same port code on the
# CPU (plain versions): LUFS and dB readings within 1e-3, delays within
# 1e-3 samples, the null's RMS within 0.1 dB (a -20 dB null amplifies the
# signals' relative rounding ten times), audio within 1e-5
EVAL_DB, EVAL_DELAY, EVAL_NULL_DB, EVAL_AUDIO = 1e-3, 1e-3, 0.1, 1e-5
# the planted delay and gain recovered: the parabola through the
# whitened GCC-PHAT peak leans ~0.1 sample toward the integer lag
RECOVER_DELAY, RECOVER_GAIN_DB = 0.15, 0.05
# K4 calls a node makes, by shape: four K-weightings a meter reading
# set, two a LUFS-I gain match, three in "Null Test (Full)"'s defaults
METER_N = int(METER_SECONDS * EVAL_SR)
PAIR_N = int(PAIR_SECONDS * EVAL_SR)


def eval_signal(seconds: float, seed: int):
    """Seeded music-like stereo at 48 kHz, made on the card: 12 harmonics
    of 196 Hz under a slow level swing (so the loudness range is not 0),
    the right channel 0.8 of the left, a little noise; peak 0.5.
    Returns host float32 ``[2, N]``."""
    import torch
    n = int(seconds * EVAL_SR)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(n, device="cuda", dtype=torch.float64) / EVAL_SR
    ph = torch.rand(12, generator=g, device="cuda", dtype=torch.float64) * 2 * math.pi
    x = torch.zeros(n, device="cuda", dtype=torch.float64)
    for h in range(1, 13):
        x += torch.sin(2 * math.pi * 196.0 * h * t + ph[h - 1]) / h
    x *= 0.55 + 0.45 * torch.sin(2 * math.pi * t / 23.0)
    y = torch.stack([x, 0.8 * x]) + 0.01 * torch.randn(2, n, generator=g, device="cuda",
                                                        dtype=torch.float64)
    return (0.5 * y / y.abs().max()).float().cpu().numpy()


def frac_delayed(x, delay: float, gain_db: float):
    """``x [C, N]`` delayed by ``delay`` samples (a band-limited shift
    through the FFT of the zero-padded signal, on the card in float64)
    and scaled by ``gain_db``."""
    import torch
    xd = torch.from_numpy(x).to("cuda", torch.float64)
    m = 2 * xd.shape[-1]
    f = torch.fft.rfftfreq(m, device="cuda", dtype=torch.float64)
    y = torch.fft.irfft(torch.fft.rfft(xd, m) * torch.exp(-2j * math.pi * f * delay), m)
    return (10 ** (gain_db / 20) * y[:, : x.shape[-1]]).float().cpu().numpy()


def eval_phase() -> dict:
    """The eval-pack and null-suite nodes on the card at real sizes: the
    meter on 300 s of 48 kHz stereo; Metrics, Gain Match (1770), Resample
    Audio (HQ) and Null Test (Full) (GCC-PHAT with the centre fixed,
    draws off) on a 60 s pair whose B is A delayed by 37.25 samples and
    scaled by -3 dB; the plotter with draws on where matplotlib is
    installed; ABX once.  Each node runs cold, then warm with the launch
    counts set to 0 before and read after; its readings are held to the
    same port code on the CPU (plain versions), the recovered delay and
    gain to the planted ones."""
    import importlib.util

    import numpy as np
    import torch

    from egregora_tpu_torch.nodes import eval_pack as ep
    from egregora_tpu_torch.nodes import null_suite as ns
    from egregora_tpu_torch.nodes.base import DeviceNode

    t0 = time.perf_counter()
    song = eval_signal(METER_SECONDS, seed=11)
    a = eval_signal(PAIR_SECONDS, seed=12)
    b = frac_delayed(a, PLANTED_DELAY, PLANTED_GAIN_DB)
    A = {"waveform": torch.from_numpy(a[None]), "sample_rate": EVAL_SR}
    B = {"waveform": torch.from_numpy(b[None]), "sample_rate": EVAL_SR}
    SONG = {"waveform": torch.from_numpy(song[None]), "sample_rate": EVAL_SR}
    log(f"eval: signals made in {time.perf_counter() - t0:.1f} s ({METER_SECONDS:g} s and "
        f"2 x {PAIR_SECONDS:g} s of {EVAL_SR} Hz stereo)")
    off = dict(draw_waveforms=False, draw_spectrograms=False, draw_diffspec=False)
    nodes = [  # label, node class, args, kwargs, K4 calls by shape
        ("Loudness Meter (BS1770)", ep.Loudness_Meter_1770, (SONG,), {}, {(2, METER_N): 4}),
        ("Metrics (LSD + SI-SDR)", ep.Metrics_LSD_SISDR, (A, B), {}, {}),
        ("Audio Gain Match (1770)", ep.Audio_Gain_Match_1770, (A, B), {}, {(2, PAIR_N): 2}),
        ("Resample Audio (HQ)", ep.Resample_Audio_HQ, (A,), {"target_sr": 44100}, {}),
        ("Null Test (Full)", ns.Null_Test_Full, (A, B), dict(align_method="gcc-phat-fixed", **off),
         {(2, PAIR_N): 3}),
    ]
    results, failures, k4_counts, by_path = {}, [], collections.Counter(), {}
    try:
        for label, cls, args, kw, k4_expect in nodes:
            DeviceNode.DEVICE = "cuda"
            for run_no in ("cold", "warm"):
                reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                card = getattr(cls(), cls.FUNCTION)(*args, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                counts = read_counts()
            DeviceNode.DEVICE = "cpu"
            t = time.perf_counter()
            cpu = getattr(cls(), cls.FUNCTION)(*args, **kw)
            cpu_wall = time.perf_counter() - t
            k4 = counts["iir_lowpass"]
            k4_counts.update(k4)
            by_path[label] = sum(k4.values())
            others = {name: c for name, c in counts.items() if name != "iir_lowpass" and c}
            readings = compare_eval_node(label, card, cpu, failures)
            results[label] = {"warm_wall_s": wall, "cpu_wall_s": cpu_wall, "k4": k4,
                              "readings": readings}
            log(f"eval node {label}: warm {wall:.4f} s on the card (CPU plain {cpu_wall:.2f} s); "
                f"K4 calls {k4} (expected {k4_expect}); readings {readings}")
            if k4 != k4_expect or others:
                failures.append(f"{label}: launches {counts}, expected K4 {k4_expect} only")
        DeviceNode.DEVICE = "cuda"
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        if has_mpl:
            null_card = ns.Null_Test_Full().execute(A, B, align_method="gcc-phat-fixed", **off)
            t = time.perf_counter()
            imgs = ns.Audio_Plotter().execute(A, null_card[0], null_card[1])
            wall = time.perf_counter() - t
            shapes = [tuple(i.shape) for i in imgs]
            log(f"eval node Audio Plotter: matplotlib found, draws on: images {shapes} in "
                f"{wall:.2f} s")
            if any(s[1] < 100 or s[3] != 3 for s in shapes):
                failures.append(f"Audio Plotter drew {shapes}")
            results["Audio Plotter"] = {"wall_s": wall, "images": shapes}
        else:
            log("eval node Audio Plotter: matplotlib not installed here, so the plotter runs "
                "with draws off only (inside Null Test (Full))")
        abx = ep.ABX_Prepare().execute(A, B, clip_seconds=5.0, random_seed=3)
        judged = ep.ABX_Judge().execute(abx[3], abx[3]["x_is"])[0]
        log(f"eval node ABX Prepare/Judge: X is {abx[3]['x_is']}, clips "
            f"{[tuple(x['waveform'].shape) for x in abx[:3]]}, judged {judged}")
        if not judged["correct"] or abx[0]["waveform"].shape[-1] != 5 * EVAL_SR:
            failures.append(f"ABX: {abx[3]}, {judged}")
    finally:
        DeviceNode.DEVICE = "cuda"
    full = results["Null Test (Full)"]["readings"]
    d_err = abs(full["delay_samples"] - PLANTED_DELAY)
    g_err = abs(full["gain_db"] + PLANTED_GAIN_DB)
    log(f"eval: planted delay {PLANTED_DELAY} read {full['delay_samples']:.4f} (|d| {d_err:.4f}, "
        f"limit {RECOVER_DELAY}); planted gain {PLANTED_GAIN_DB} dB undone by "
        f"{full['gain_db']:+.4f} dB (|d| {g_err:.4f}, limit {RECOVER_GAIN_DB})")
    if not (d_err <= RECOVER_DELAY and g_err <= RECOVER_GAIN_DB):
        failures.append(f"the planted delay/gain were not recovered: {full}")
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"nodes": results, "k4_counts": dict(k4_counts), "k4_by_path": by_path}


def compare_eval_node(label: str, card, cpu, failures: list) -> dict:
    """An eval node's card outputs against its CPU outputs: every DICT
    reading and FLOAT within its limit, every AUDIO within ``EVAL_AUDIO``;
    returns the card's readings (Null Test (Full): with its delay)."""
    import numpy as np

    def lim(key):
        if key in ("null_rms_dbfs", "null_lufs"):
            return EVAL_NULL_DB
        if key in ("corr_coef", "scale_k"):
            return 1e-4
        return 0 if key == "overshoot_count" else EVAL_DB

    readings = {}

    def check(key, got, ref, limit):
        readings[key] = got
        if not abs(got - ref) <= limit or not np.isfinite(got):
            failures.append(f"{label} {key}: card {got}, CPU {ref} (limit {limit})")

    for i, (g, r) in enumerate(zip(card, cpu)):
        if isinstance(g, dict) and "waveform" in g:
            gw, rw = g["waveform"].numpy(), r["waveform"].numpy()
            if gw.shape != rw.shape or not np.abs(gw - rw).max() <= EVAL_AUDIO:
                failures.append(f"{label} output {i}: audio {gw.shape} vs {rw.shape}, max|d| "
                                f"{np.abs(gw - rw).max() if gw.shape == rw.shape else 'n/a'}")
        elif isinstance(g, dict):
            for key in g:
                check(key, float(g[key]), float(r[key]), lim(key))
        elif isinstance(g, float):
            name = {"Null Test (Full)": ("", "", "delay_ms", "gain_db"),
                    "Audio Gain Match (1770)": ("", "gain_db", "ref_level", "in_level")}[label][i]
            check(name, g, r, EVAL_DELAY * 1e3 / EVAL_SR if name == "delay_ms" else EVAL_DB)
    if "delay_ms" in readings:
        readings["delay_samples"] = readings["delay_ms"] * EVAL_SR / 1e3
    return readings


# ---- the converted reference checkpoints at the published geometry ----

def published_cfg():
    """The published FlashSR checkpoints' geometry (what a user's real
    vae.pth / student_ldm.pth / sr_vocoder.pth trio carries): VAE base 128,
    mults (1, 2, 4), 2 res blocks, mid attention and quant convs; the
    CompVis UNet of 128 channels, attention at ds 2 and 4, 8 heads; the
    weight-normalised HiFi-GAN of 512 initial channels, floor 64."""
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr.vocoder import VocoderConfig
    return P.FlashSRConfig(
        vae=P.VAEConfig(base_channels=128, channel_mults=(1, 2, 4), latent_channels=16,
                        num_res_blocks=2, groups=32, mid_attn=True, use_quant_conv=True),
        unet=P.LDMUNetConfig(in_channels=32, out_channels=16, model_channels=128,
                             channel_mult=(1, 2, 4), num_res_blocks=2,
                             attention_resolutions=(2, 4), num_heads=8, groups=32),
        vocoder=VocoderConfig(n_mels=256, upsample_initial=512, upsample_factors=(10, 8, 6),
                              upsample_kernels=(20, 16, 12), resblock_kernels=(3, 7, 11),
                              resblock_dilations=((1, 3, 5),) * 3, channel_floor=64))


def upstream_state_dicts(cfg, seed: int) -> dict:
    """Seeded weights for ``cfg`` as the three upstream state dicts: the
    port's modules drawn from ``seed``, carried to the JAX package's flax
    layout (``flax_tree``) and from there to each checkpoint's torch keys
    and layouts by inverting the name maps: the CompVis fused qkv
    head-major, 1D convs for qkv and proj_out, Linear ``[out, in]``, convs
    ``[out, in, *k]``, ConvTranspose ``[in, out, k]``; the vocoder's
    weights as ``weight_g`` / ``weight_v`` pairs; an upstream-only extra
    key in the VAE, which the converter drops."""
    import numpy as np

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr.ldm_unet import ldm_unet_name_map
    from egregora_tpu_torch.models.flashsr.vae import audioldm_vae_name_map
    from egregora_tpu_torch.models.flashsr.vocoder import hifigan_name_map
    from egregora_tpu_torch.utils import weights

    mods = legacy_init(P.FlashSRModules(cfg), seed)
    maps = {"vae": audioldm_vae_name_map(cfg.vae).__self__,
            "student_ldm": ldm_unet_name_map(cfg.unet).__self__,
            "sr_vocoder": hifigan_name_map(cfg.vocoder).__self__}
    heads = cfg.unet.num_heads
    out = {}
    for name, module in mods.by_name().items():
        flat = weights._flatten(weights.flax_tree(module, values=True))
        sd = {}
        for tk, fk in maps[name].items():
            tr = None
            if isinstance(fk, tuple):
                fk, tr = fk
            w = flat[fk]
            if tk.endswith("qkv.weight"):      # flax [Cin, 3C] slot-major -> [3C, Cin, 1]
                oc = w.shape[1]
                t = (w.T.reshape(3, heads, oc // (3 * heads), -1).transpose(1, 0, 2, 3)
                     .reshape(oc, -1)[:, :, None])
            elif tk.endswith("qkv.bias"):
                t = w.reshape(3, heads, -1).transpose(1, 0, 2).reshape(-1)
            elif callable(tr):                 # dense from a Linear or a 1D conv
                t = w.T[:, :, None] if "proj_out" in tk else w.T
            elif tr is not None:               # ConvTranspose1d
                t = np.transpose(w, np.argsort(tr))
            elif w.ndim >= 3 and tk.endswith("weight"):
                t = np.transpose(w, np.argsort(tuple(range(2, w.ndim)) + (1, 0)))
            elif w.ndim == 2 and tk.endswith("weight"):
                t = w.T
            else:
                t = w
            t = np.ascontiguousarray(t, np.float32)
            if name == "sr_vocoder" and tk.endswith("weight") and t.ndim >= 2:
                g = np.sqrt(np.sum(t ** 2, axis=tuple(range(1, t.ndim)), keepdims=True))
                sd[tk[:-len("weight")] + "weight_v"] = 3.0 * t
                sd[tk[:-len("weight")] + "weight_g"] = g
            else:
                sd[tk] = t
        out[name] = sd
    out["vae"]["loss.logvar"] = np.zeros((1,), np.float32)
    return out


def write_reference_trio(cfg, d, seed: int = 0) -> None:
    """``upstream_state_dicts(cfg, seed)`` as ``vae.pth``,
    ``student_ldm.pth`` and ``sr_vocoder.pth`` in ``d`` (``torch.save``)."""
    import torch
    d.mkdir(parents=True, exist_ok=True)
    for name, sd in upstream_state_dicts(cfg, seed).items():
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(d / f"{name}.pth"))


# the converted node's paths, one-shot on the 12 s input: label, switches,
# MRF launches by (b, c, t) at batch 1 (the attention's are CONVERTED_CALLS)
CONVERTED_PATHS = [
    ("module-path vocoder", {"EGREGORA_FUSED_VOCODER": None, "EGREGORA_MRF_PATH": None}, {}),
    ("fused MRF", {"EGREGORA_FUSED_VOCODER": "1", "EGREGORA_MRF_PATH": None},
     {"mrf_fused_cm": {(1, 64, 245760): 1}}),
    ("rows MRF", {"EGREGORA_FUSED_VOCODER": "1", "EGREGORA_MRF_PATH": "rows"},
     {"mrf_rows": {(1, 256, 5120): 3, (1, 128, 40960): 3, (1, 64, 245760): 3}}),
]
CONVERTED_CALLS = dict(PATH_CALLS)
CONVERTED_CALLS.pop((1, 8192, 256))
CONVERTED_CALLS[CONVERTED_MID] = 2
# relative L2 limits of the converted published trio, bf16 on the card
# against float32 on the CPU with the same (bf16-rounded) weights, one
# chunk; each lies between the sound reading (1.467e-2, 2.148e-2,
# 2.144e-2) and that of every attention dropping its last 64 keys
# (1.927e-2, 2.696e-2, 2.685e-2) on an H100 (PERF.md, Findings)
CONVERTED_REF_LIMITS = {"mel_hr": 1.7e-2, "wave": 2.4e-2, "high_band": 2.4e-2}


def converted_counts(per_item: dict, b: int, batches: int) -> dict:
    """The converted node's launches at batch ``b`` over ``batches``."""
    out = {k: {} for k in ("attn_rows", "mrf_fused_cm", "mrf_rows", "iir_lowpass",
                           "flash_online", "conv3x3_out1")}
    out["attn_rows"] = {(b * h, n, d): c * batches for (h, n, d), c in CONVERTED_CALLS.items()}
    for kernel, shapes in per_item.items():
        out[kernel] = {(b, c, t): k * batches for (_, c, t), k in shapes.items()}
    return out


def converted_phase() -> dict:
    """The node on a converted reference trio at the published geometry.
    A seeded upstream-layout trio is written to a temporary
    ``$EGREGORA_TPU_WEIGHTS/flashsr``; the node resolves it ("converted":
    geometry inferred from the shapes, converted, cached; later builds
    read the cache) and runs the 12 s input one-shot on each path of
    ``CONVERTED_PATHS`` (streaming ``max_batch=2`` on the first), with
    launches counted by shape: ``attn_rows`` at D = 512 in the VAE mid
    blocks, the MRF kernels at C = 256/128/64 on the rows path.  Then one
    chunk, bf16 on the card against float32 on the CPU, beside every
    attention dropping its last key tile, which the limits must reject,
    and each attention call against the float32 plain version on its own
    inputs."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from egregora_tpu_torch.core.audio import from_any
    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.nodes import super_resolution
    from egregora_tpu_torch.ops import attention

    cfg = published_cfg()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_weights_"))
    node_cls = super_resolution.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]
    sr_in, sr_out = 16000, 48000
    x = test_signal(SECONDS, sr_in, seed=0)
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": sr_in}
    n_out = int(SECONDS * sr_out)
    results = {"paths": {}}
    try:
        t = time.perf_counter()
        write_reference_trio(cfg, root / "flashsr", seed=7)
        results["write_s"] = time.perf_counter() - t
        set_env(EGREGORA_TPU_WEIGHTS=str(root), EGREGORA_FLASHSR_VARIANT=None,
                EGREGORA_FLASHSR_NUM_HEADS=None)
        for i, (label, switches, per_item) in enumerate(CONVERTED_PATHS):
            set_env(**switches)
            node_cls._PIPE = None
            t = time.perf_counter()
            node = node_cls()
            pipe = node._pipeline()
            ready = time.perf_counter() - t
            if pipe.weight_source != "converted" or pipe.cfg != cfg or pipe.device.type != "cuda":
                raise RuntimeError(f"converted {label}: the node resolved {pipe.weight_source} "
                                   f"on {pipe.device}, config {pipe.cfg}")
            cached = (root / "flashsr" / distill.CACHE).exists()
            log(f"converted {label}: pipeline ready in {ready:.1f} s "
                f"({'converted from the .pth trio' if i == 0 else 'from the cache'}; "
                f"cache written: {cached})")
            for run_no in ("cold", "warm"):
                reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                (out,) = node.run(audio, lowpass_input=False, output_sr=str(sr_out))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                counts = read_counts()
                one = out["waveform"].numpy()
                finite = bool(np.isfinite(one).all())
                log(f"converted {label} one-shot ({run_no}): {wall:.3f} s wall, RTF "
                    f"{SECONDS / wall:.1f}x real time, out {one.shape}, finite {finite}, "
                    f"launches {counts}")
                if one.shape != (1, 1, n_out) or not finite:
                    raise RuntimeError(f"converted {label}: bad output {one.shape}, "
                                       f"finite={finite}")
                expect = converted_counts(per_item, BATCH, 1)
                if counts != expect:
                    raise RuntimeError(f"converted {label}: launches {counts}, expected {expect}")
            results["paths"][label] = {"wall_s": wall, "rtf": SECONDS / wall, "counts": counts}
            if i == 0:
                reset_counts()
                t = time.perf_counter()
                stream = pipe.process(from_any(audio), output_sr=sr_out, max_batch=2).numpy()
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t
                counts_s = read_counts()
                rel = rel_l2(torch.from_numpy(stream), torch.from_numpy(one[0]))
                log(f"converted {label} streaming max_batch=2: {wall_s:.3f} s wall, launches "
                    f"{counts_s}; one-shot vs streaming relative L2 {rel:.3e} "
                    f"(limit {NODE_STREAM_REL_L2:g})")
                if counts_s != converted_counts(per_item, 2, 2):
                    raise RuntimeError(f"converted streaming: launches {counts_s}")
                if stream.shape != (1, n_out) or not rel <= NODE_STREAM_REL_L2:
                    raise RuntimeError(f"converted: one-shot and streaming disagree: {rel}")
                results["paths"][label]["streaming_wall_s"] = wall_s
                module_pipe = pipe
            else:        # the kernels' vocoder wave against the module path's
                chunk = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=3)).to("cuda")
                wav = pipe.synthesize(chunk)[1]
                set_env(EGREGORA_FUSED_VOCODER=None)
                module = pipe.synthesize(chunk)[1]
                set_env(**switches)
                rel = rel_l2(wav.float(), module.float())
                log(f"converted {label}: vocoder wave vs the module path relative L2 "
                    f"{rel:.3e} (limit {FUSED_WAVE_LIMIT:g})")
                if not rel <= FUSED_WAVE_LIMIT:
                    raise RuntimeError(f"converted {label}: the vocoder wave is {rel} "
                                       "from the module path")
                results["paths"][label]["wave_rel_l2"] = rel
        set_env(EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)
        results["reference"] = converted_reference(module_pipe, root / "flashsr")
    finally:
        set_env(EGREGORA_TPU_WEIGHTS=None, EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)
        node_cls._PIPE = None
        shutil.rmtree(root, ignore_errors=True)
    return results


def converted_reference(card, ckpt_dir) -> dict:
    """One chunk of the converted pipeline ``card`` (bf16) against float32
    arithmetic on the CPU with the same weights rounded to bf16: the
    decoded mel, the vocoder's wave and the output's band above the
    crossover; planted fault: every attention drops its last 64 keys.
    Each attention call of the card's chunk is also held to the float32
    plain version on its own inputs (``ATTN_CALL_LIMIT``)."""
    import dataclasses

    import torch

    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.ops import attention
    from egregora_tpu_torch.ops.attn_rows import attn_rows_plain

    cfg, sd = distill.load_converted_flashsr(ckpt_dir)
    x = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=2)[:, :P.CHUNK_SAMPLES])

    def outputs(pipe):
        xd = x.to(pipe.device)
        with torch.inference_mode():
            mel, wav = pipe.synthesize(xd)
            y = pipe._postprocess(xd, wav, mel).float()
        high = y - P.lowpass_fir(y, P.REQ_SR, pipe.cfg.crossover_hz)
        return {"mel_hr": mel.float().cpu(), "wave": wav.float().cpu(),
                "high_band": high.float().cpu()}

    f32 = dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), dtype=torch.float32)
                                      for k in ("vae", "unet", "vocoder")})
    rounded = {m: {k: v.bfloat16().float() for k, v in d.items()} for m, d in sd.items()}
    t = time.perf_counter()
    ref = outputs(P.FlashSRPipeline(f32, params=rounded, device="cpu"))
    log(f"converted reference: one chunk f32 on the CPU {time.perf_counter() - t:.1f} s")
    kernel, calls = attention.attn_rows, []

    def checked(q, k, v):
        got = kernel(q, k, v)
        ref32 = attn_rows_plain(q.float(), k.float(), v.float())
        calls.append((tuple(q.shape), rel_l2(got.float(), ref32),
                      rel_l2(drop_last_tile(q, k, v).float(), ref32)))
        return got

    try:
        attention.attn_rows = checked
        sound = outputs(card)
        attention.attn_rows = drop_last_tile
        planted = outputs(card)
    finally:
        attention.attn_rows = kernel
    readings, failures, nan = {}, [], float("nan")
    good, bad = max(c[1] for c in calls), min(c[2] for c in calls)
    mid = [c for c in calls if c[0][-1] == 512]
    log(f"converted reference attention per call ({len(calls)} calls, shapes "
        f"{sorted(set(c[0] for c in calls))}): attn_rows vs float32 plain on the same inputs, "
        f"relative L2 at most {good:.3e} (D = 512: {max((c[1] for c in mid), default=nan):.3e}; "
        f"limit {ATTN_CALL_LIMIT:g}) {'ok' if good <= ATTN_CALL_LIMIT else 'FAIL'}; planted "
        f"fault (last key tile dropped) at least {bad:.3e} (D = 512: "
        f"{min((c[2] for c in mid), default=nan):.3e}) "
        f"{'rejected' if bad > ATTN_CALL_LIMIT else 'NOT REJECTED'}")
    readings["attn_call"] = (good, bad)
    if len(mid) != 2:
        failures.append(f"{len(mid)} attention calls at D = 512, expected 2")
    if not good <= ATTN_CALL_LIMIT:
        failures.append(f"attention per call: {good}")
    if not bad > ATTN_CALL_LIMIT:
        failures.append("attention per call: the dropped key tile passes")
    for key, limit in CONVERTED_REF_LIMITS.items():
        g, b = rel_l2(sound[key], ref[key]), rel_l2(planted[key], ref[key])
        readings[key] = (g, b)
        log(f"converted reference {key}: bf16 card vs f32 cpu relative L2 {g:.3e} "
            f"(limit {limit:g}) {'ok' if g <= limit else 'FAIL'}; planted fault (last key "
            f"tile dropped) {b:.3e} {'rejected' if b > limit else 'NOT REJECTED'}")
        if not g <= limit:
            failures.append(f"converted: card and CPU disagree on {key}: {g}")
        if not b > limit:
            failures.append(f"converted: the {key} limit does not reject the planted fault")
    if failures:
        raise RuntimeError("; ".join(failures))
    return readings


# ---- K1b (flash_online) and K3 (conv3x3_out1) against their plain versions ----

# K1b: the attention lab's shapes (bh, n, d) and a ragged N, at the JAX
# defaults (block_q 512, block_k 1024: the largest tile built for each D)
K1B_SHAPES = [(26, 8192, 256), (208, 2048, 32), (26, 8192, 512), (6, 1000, 64)]
# K3: (b, f, m, c, dtype, where) -- the decoders' last conv on one-shot's
# chunk batch (C = 24 compact trios, 64 full config, 128 published), the
# edge lab's geometry, ragged F and M, C off the vector and over a chunk
K3_SHAPES = [(3, 512, 256, 24, "bfloat16", "compact trios' decoder"),
             (3, 512, 256, 64, "bfloat16", "full config's decoder"),
             (3, 512, 256, 128, "bfloat16", "published decoder"),
             (26, 512, 256, 64, "bfloat16", "edge lab"),
             (26, 512, 256, 128, "bfloat16", "edge lab, published width"),
             (2, 37, 45, 64, "bfloat16", "ragged F and M"),
             (1, 19, 70, 200, "bfloat16", "C over one chunk, off the vector"),
             (3, 100, 77, 24, "float32", "float32")]
# K3's tile edges: the CUDA-core route's 8 x 32 block tile; the tensor-core
# route's 64-column strips and its F segments (multiples of 8 rows where
# the grid shortens them) lie on the same edges
K3_ROWS, K3_COLS = 8, 32


def drop_bottom_halo(x, w, bias):
    """A planted fault of K3: every 8-row tile without the halo row below
    it (its last row's taps of the next row left out), from the plain
    version."""
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import conv_edge as ce
    out = ce.conv3x3_out1_plain(x, w, bias)
    f, m = x.shape[1], x.shape[2]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wr = w[2, :, :, 0].to(x.dtype).float()                   # taps of the row below
    below = sum(xp[:, 2:2 + f, dj:dj + m] @ wr[dj] for dj in range(3))
    rows = [r for r in range(K3_ROWS - 1, f - 1, K3_ROWS)]
    out[:, rows, :, 0] -= below[:, rows]
    return out


def drop_strip_left(x, w, bias):
    """A planted fault of K3's tensor-core route: the stencil's left
    column of tap partials taken as zero at every strip edge (the outputs
    at columns 64j, j >= 1, without their taps of column 64j - 1), from
    the plain version.  Only an M above one strip shows it."""
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import conv_edge as ce
    out = ce.conv3x3_out1_plain(x, w, bias)
    f, m = x.shape[1], x.shape[2]
    cols = list(range(ce.STRIP, m, ce.STRIP))
    if not cols:
        return out
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wl = w[:, 0, :, 0].to(x.dtype).float()                   # taps of the column to the left
    left = sum(xp[:, di:di + f, cols] @ wl[di] for di in range(3))
    out[:, :, cols, 0] -= left
    return out


def k3_edges(y):
    """K3's output at its tiles' edges: rows 8i and 8i + 7, columns 32j
    and 32j + 31 (where a halo fault shows)."""
    import torch
    f, m = y.shape[1], y.shape[2]
    rows = sorted({r for i in range(0, f, K3_ROWS) for r in (i, min(i + K3_ROWS, f) - 1)})
    cols = sorted({c for j in range(0, m, K3_COLS) for c in (j, min(j + K3_COLS, m) - 1)})
    return torch.cat([y[:, rows].flatten(), y[:, :, cols].flatten()])


def edge_kernels_phase() -> dict:
    """K1b and K3 against their plain versions on the card, beside planted
    faults the limits must reject (K1b: the last key tile dropped; K3: the
    bottom halo row dropped), with the kernel's, the plain version's and
    the library call's times (SDPA; cuDNN ``F.conv2d`` on the same
    channels-last input, bf16 out) and the bound."""
    import torch
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import attn_flash as af
    from egregora_tpu_torch.ops import conv_edge as ce

    k1b, k3, failures = [], [], []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for bh, n, d in K1B_SHAPES:
        q, k, v = (torch.randn(bh, n, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        got = af.flash_online(q, k, v)
        torch.cuda.synchronize()
        plain = af.flash_online_plain(q, k, v)
        ok, rel, err, limit = bf16_agreement(got, plain)
        tile = af.kernel_tile(q.dtype, d, 512, 1024)[2]
        m = (n - 1) // tile * tile or n // 2       # one key tile: drop half of it
        bad = af.flash_online_plain(q, k[:, :m].contiguous(), v[:, :m].contiguous())
        bad_ok, bad_rel, bad_err, _ = bf16_agreement(bad, plain)
        flops = 4.0 * bh * n * n * d
        bound_ms, bound_by = bound(flops, 8.0 * bh * n * d, H100_BF16_FLOPS)
        reps = max(2, min(20, int(2e12 / flops)))
        ms = cuda_ms(lambda: af.flash_online(q, k, v), reps)
        plain_ms = cuda_ms(lambda: af.flash_online_plain(q, k, v), 1, 1)
        q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)
        row = {"bh": bh, "n": n, "d": d, "tile": list(af.kernel_tile(q.dtype, d, 512, 1024)),
               "max_abs_err": err, "rel_l2": rel, "max_abs_limit": limit,
               "planted_max_abs_err": bad_err, "planted_rel_l2": bad_rel, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "tflops": flops / ms / 1e9}
        before = against_before("flash_online", row, flops, H100_BF16_FLOPS)
        k1b.append(row)
        log(f"flash_online [{bh},{n},{d}] tile {row['tile']}: vs plain max|d| {err:.3e} "
            f"(limit {limit:.3e}), rel L2 {rel:.3e} {'ok' if ok else 'FAIL'}; planted fault "
            f"(last key tile dropped) max|d| {bad_err:.3e}, rel L2 {bad_rel:.3e} "
            f"{'rejected' if not bad_ok else 'NOT REJECTED'}; kernel {ms:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s, {before}), plain {plain_ms:.3f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not ok:
            failures.append(f"flash_online [{bh},{n},{d}] disagrees: {rel}, {err}")
        if bad_ok:
            failures.append(f"flash_online [{bh},{n},{d}]: the planted fault passes")
        del q, k, v, q4, k4, v4, got, plain, bad

    for b, f, m, c, dt, where in K3_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(b, f, m, c, generator=gen, device="cuda").to(dtype)
        w = 0.1 * torch.randn(3, 3, c, 1, generator=gen, device="cuda")
        bias = torch.full((1,), 0.1, device="cuda")
        got = ce.conv3x3_out1(x, w, bias)
        torch.cuda.synchronize()
        plain = ce.conv3x3_out1_plain(x, w, bias)
        ok, rel, err = f32_agreement(got, plain)
        edge_err = float((k3_edges(got) - k3_edges(plain)).abs().max())
        bad_ok, bad_rel, bad_err = f32_agreement(drop_bottom_halo(x, w, bias), plain)
        strips = m > ce.STRIP
        strip_ok, strip_rel, strip_err = (f32_agreement(drop_strip_left(x, w, bias), plain)
                                          if strips else (None, None, None))
        elt = x.element_size()
        bound_ms, bound_by = bound(18.0 * b * f * m * c, b * f * m * (c * elt + 4.0),
                                   H100_F32_FLOPS)
        ms = cuda_ms(lambda: ce.conv3x3_out1(x, w, bias), 20)
        dev_ms = graph_ms(lambda: ce.conv3x3_out1(x, w, bias), 20)
        plain_ms = cuda_ms(lambda: ce.conv3x3_out1_plain(x, w, bias), 3, 1)
        xn, wn = x.permute(0, 3, 1, 2), w[..., 0].permute(2, 0, 1)[None].to(dtype)
        lib_ms = cuda_ms(lambda: F.conv2d(xn, wn, bias.to(dtype), padding=1), 20)
        row = {"b": b, "f": f, "m": m, "c": c, "dtype": dt, "where": where,
               "max_abs_err": err, "edge_max_abs_err": edge_err, "rel_l2": rel,
               "max_abs_limit": F32_REL * float(plain.abs().max()),
               "planted_max_abs_err": bad_err, "planted_rel_l2": bad_rel,
               "planted_strip_max_abs_err": strip_err, "planted_strip_rel_l2": strip_rel,
               "route": ce.TC if ce.plan_of(x).route else ce.CC, "ms": ms, "graph_ms": dev_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "gb_per_s": b * f * m * (c * elt + 4.0) / ms / 1e6}
        share = bound_share("conv3x3_out1", row, (b, f, m, c, dt))
        k3.append(row)
        strip = ("n/a (one strip)" if not strips else
                 f"max|d| {strip_err:.3e}, rel L2 {strip_rel:.3e} "
                 f"{'rejected' if not strip_ok else 'NOT REJECTED'}")
        log(f"conv3x3_out1 [{b},{f},{m},{c}] {dt} ({where}; {row['route']}): vs plain max|d| "
            f"{err:.3e}, tile edges {edge_err:.3e} (limit {row['max_abs_limit']:.3e}), rel L2 "
            f"{rel:.3e} {'ok' if ok else 'FAIL'}; planted faults: bottom halo row dropped max|d| "
            f"{bad_err:.3e}, rel L2 {bad_rel:.3e} {'rejected' if not bad_ok else 'NOT REJECTED'}; "
            f"strip edge's left partials zero {strip}; kernel {ms:.4f} ms "
            f"({row['gb_per_s']:.0f} GB/s, {share}), plain {plain_ms:.3f} ms, cudnn "
            f"{lib_ms:.4f} ms ({lib_ms / ms:.2f}x the kernel's time), bound {bound_ms:.4f} ms "
            f"({bound_by})")
        if not ok:
            failures.append(f"conv3x3_out1 [{b},{f},{m},{c}] {dt} disagrees: {rel}, {err}")
        if bad_ok:
            failures.append(f"conv3x3_out1 [{b},{f},{m},{c}]: the planted fault passes")
        if strip_ok:
            failures.append(f"conv3x3_out1 [{b},{f},{m},{c}]: the strip-edge fault passes")
        del x, got, plain
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"flash_online": k1b, "conv3x3_out1": k3}


def lab_phase() -> dict:
    """The two lab entry points (``python -m egregora_tpu_torch.tools.
    attn_flash_lab`` / ``edge_conv_lab``), once at one round, with the
    launches of every kernel counted: K1b and K3 run on no node path; the
    labs are where they launch."""
    from egregora_tpu_torch.ops import conv_edge as ce
    from egregora_tpu_torch.tools import attn_flash_lab, edge_conv_lab

    out = {}
    for name, lab in (("attn_flash_lab", attn_flash_lab), ("edge_conv_lab", edge_conv_lab)):
        reset_counts()
        t = time.perf_counter()
        # one timed launch a candidate (the edge lab in one turn)
        rows = lab.sweep(rounds=1, **({"turns": 1} if name == "edge_conv_lab" else {}))
        wall = time.perf_counter() - t
        counts = read_counts()
        routes = dict(ce.launches_by_route)
        log(f"{name}: {len(rows)} lines in {wall:.1f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }"
            + (f", K3 by route {routes}" if routes else ""))
        out[name] = {"rows": rows, "counts": counts, "wall_s": wall,
                     "conv3x3_out1_by_route": routes}
    if not out["attn_flash_lab"]["counts"]["flash_online"]:
        raise RuntimeError("attn_flash_lab launched no flash_online")
    if not out["edge_conv_lab"]["counts"]["conv3x3_out1"]:
        raise RuntimeError("edge_conv_lab launched no conv3x3_out1")
    return out


def edge_entry(name: str, rows: list, counts: dict, by_path: dict) -> dict:
    """The ``kernels`` line's entry of K1b or K3: ``counts`` maps a shape to
    the launches the labs made; times and bounds are phase (ii)'s at that
    shape (K1b at its default tile) times those launches."""
    if name == "flash_online":
        key = ("bh", "n", "d")
        src, rep = "attn_online.cu", "egregora_tpu/ops/attn_flash.py:81"
    else:
        key = ("b", "f", "m", "c")
        src, rep = "conv_edge.cu", "egregora_tpu/ops/conv_edge.py:66"
    by_shape = {tuple(r[k] for k in key): r for r in rows if r.get("dtype", "bfloat16") == "bfloat16"}
    missing = set(counts) - set(by_shape)
    if missing:
        raise RuntimeError(f"{name}: launches at shapes phase (ii) did not time: {missing}")

    def total(k):
        return sum(by_shape[s][k] * n for s, n in counts.items())

    bound_ms = total("bound_ms")
    by = collections.Counter()
    for s, n in counts.items():
        by[by_shape[s]["bound_by"]] += by_shape[s]["bound_ms"] * n
    return {
        "name": name, "route": "cuda", "source": f"egregora_tpu_torch/csrc/{src}",
        "replaces": rep, "launches": sum(counts.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": bound_ms,
        "bound_by": by.most_common(1)[0][0], "library_ms": total("library_ms"),
        "library_call": ("torch.nn.functional.scaled_dot_product_attention"
                         if name == "flash_online" else
                         "torch.nn.functional.conv2d (cuDNN, bf16 out)"),
        "launches_by_shape": {"x".join(map(str, s)): n for s, n in counts.items()},
        "launches_by_path": by_path, "node_path_launches": 0, "shapes": rows,
    }


# ---- the enhance chain: RNNoise, Fat Llama, WPE and the full chain ----

# card against the same port on the CPU: the RNNoise wave (relative L2
# and max |d|), its VAD (max |d|), and the pitch periods (exact) on every
# frame non-silent on both; silence flags equal on every frame whose band
# energy is not within 1e-3 relative of the threshold
RN_SECONDS, RN_LONG_SECONDS, RN_SEGMENTS = 12.0, 60.0, 16
RN_WAVE_REL, RN_WAVE_ABS, RN_VAD = 1e-3, 2e-3, 5e-3
# Fat Llama card against CPU at 20 iterations, max |d| (outputs of order 1)
FL_SECONDS, FL_ITERS, FL_CHECK_ITERS, FL_ABS = 30.0, 300, 20, 1e-4
# WPE: the node against the direct call (the same arithmetic on the card),
# and the card against the CPU, max |d| (|x| <= 0.5)
WPE_SECONDS, WPE_NODE_ABS, WPE_CPU_ABS = 20.0, 1e-6, 1e-3
CHAIN_SECONDS, CHAIN_ITERS = 120.0, 50


def speech_signal(seconds: float, sr: int, channels: int, seed: int,
                  gaps=((3.0, 3.6), (7.5, 8.0))):
    """Seeded speech-like stereo: gliding harmonic tones with a syllable
    envelope plus noise, a 50 ms lead-in and gaps at 1e-6 (silent to
    RNNoise, so its freeze path runs), faded over 50 ms; ``[C, S]``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = np.ones(n)
    for a, b in list(gaps) + [(-1.0, 0.05)]:
        d = np.clip(np.minimum(np.abs(t - a), np.abs(t - b)) / 0.05, 0, 1)
        env = np.where((t >= a) & (t < b), 0, np.minimum(env, 0.5 - 0.5 * np.cos(np.pi * d)))
    out = []
    for c in range(channels):
        ph = 2 * np.pi * np.cumsum(130 + 25 * c + 40 * np.sin(2 * np.pi * 0.7 * t + c)) / sr
        x = sum((0.25 / k) * np.sin(k * ph) for k in range(1, 8))
        x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t)) + 0.03 * rng.standard_normal(n)
        out.append(x * env + 1e-6 * rng.standard_normal(n))
    return np.stack(out).astype(np.float32)


def reverb_signal(seconds: float, sr: int, seed: int, rt60: float = 0.5):
    """Seeded stereo through a synthetic exponential-decay room response
    (-60 dB at ``rt60``), and the mask of its late reverb: samples more
    than 50 ms after the dry signal stopped, while it is off."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    gate = (np.sin(2 * np.pi * 0.8 * t) > 0.2).astype(np.float64)
    dry = gate * (0.3 * np.sin(2 * np.pi * 250 * t) + 0.1 * rng.standard_normal(n))
    k = int(rt60 * sr)
    wet = []
    for _ in range(2):
        h = rng.standard_normal(k) * np.exp(-6.9 * np.arange(k) / k)
        h[0] = 4.0
        wet.append(np.fft.irfft(np.fft.rfft(dry, 2 * n) * np.fft.rfft(h, 2 * n), 2 * n)[:n])
    x = np.stack(wet)
    x = (0.5 * x / np.abs(x).max()).astype(np.float32)
    since_off = np.zeros(n)
    run = 0
    for i in range(n):             # samples since the dry signal stopped
        run = 0 if gate[i] else run + 1
        since_off[i] = run
    return x, (gate == 0) & (since_off > 0.05 * sr)


def on_devices(module, name: str, seen: list):
    """Wrap ``module.name`` so that each call records the device of its
    first tensor argument in ``seen``; returns the undo."""
    import torch
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        seen.append(next(a.device.type for a in args if isinstance(a, torch.Tensor)))
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def ops_dispatched(fn) -> int:
    """PyTorch operations ``fn()`` dispatches, views left out: on the card
    each is one or a few kernel launches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def synced_wall(fn):
    """(result, host seconds) of ``fn()`` between two synchronisations."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def rnnoise_compare(card, cpu) -> dict:
    """RNNoise outputs (wave, VAD, periods, silence, band energy) of the
    card against the CPU's, within the RN_* limits."""
    import numpy as np
    wave_c, vad_c, per_c, sil_c, ex_c = card
    wave_h, vad_h, per_h, sil_h, ex_h = cpu
    near = np.abs(ex_h - 0.04) <= 1e-3 * 0.04
    voiced = ~sil_c & ~sil_h
    r = {"wave_rel_l2": float(np.linalg.norm(wave_c - wave_h) / np.linalg.norm(wave_h)),
         "wave_max_abs": float(np.abs(wave_c - wave_h).max()),
         "vad_max_abs": float(np.abs(vad_c - vad_h).max()),
         "period_flips": np.argwhere((per_c != per_h) & voiced).tolist(),
         "silence_flips": np.argwhere((sil_c != sil_h) & ~near).tolist(),
         "silent_frames": int(sil_h.sum()), "frames": int(sil_h.size)}
    r["ok"] = (r["wave_rel_l2"] <= RN_WAVE_REL and r["wave_max_abs"] <= RN_WAVE_ABS
               and r["vad_max_abs"] <= RN_VAD and not r["period_flips"]
               and not r["silence_flips"])
    return r


def rnnoise_run(params, x, device: str):
    """The engine and its pitch track on ``device``: (wave, VAD, periods,
    silence, band energy) as host arrays, for ``x [C, T]``."""
    import torch

    from egregora_tpu_torch.models.rnnoise import model as rn
    xd = torch.from_numpy(x).to(device)
    wave, vad, _, ex = rn.denoise_channel_full(params, xd)
    _, _, pb = rn._front_end(xd)
    sil = ex.sum(-1) < rn.SILENCE_E
    per, _ = rn._pitch_loop(rn._pitch_candidates(pb), sil)
    return tuple(a.cpu().numpy() for a in (wave, vad, per, sil, ex.sum(-1)))


def rnnoise_phase() -> dict:
    """The RNNoise node and engine on the card: the shipped weights
    asserted loaded (reaching the random-init branch fails); the engine on
    12 s of seeded 48 kHz speech-like stereo with silent gaps against the
    same port on the CPU (wave, VAD, periods, silence), beside two planted
    faults (the silence freeze dropped; z and r swapped in the GRU) that
    the limits must reject; the node in both stereo modes and at a 16 kHz
    input against the CPU; the sequential loop per frame step with the
    operations it dispatches a step, and ``segments=16`` on 60 s of stereo
    as RTF with the analysis and the two frame loops timed apart."""
    import numpy as np
    import torch

    from egregora_tpu_torch.models.rnnoise import model as rn
    from egregora_tpu_torch.models.rnnoise import train as rt
    from egregora_tpu_torch.nodes import enhance_extras as ee
    from egregora_tpu_torch.nodes.base import DeviceNode
    from egregora_tpu_torch.utils.weights import load_params

    node_cls = ee.Egregora_RNNoise_Denoise
    node_cls._PARAMS = None
    real_init = rn.init_params

    def refuse(*args, **kwargs):
        raise RuntimeError("the RNNoise node reached its random-init branch")

    rn.init_params = refuse
    try:
        params = node_cls._params()
    finally:
        rn.init_params = real_init
    shipped = load_params(rt.pretrained_path())
    if not all(np.array_equal(params[m][k], shipped[m][k]) for m in shipped for k in shipped[m]):
        raise RuntimeError("the RNNoise node does not serve the shipped weights")
    log(f"rnnoise: the node serves the shipped weights ({rt.pretrained_path().name}, "
        f"{rt.pretrained_path().stat().st_size} bytes)")

    failures, results = [], {}
    x = speech_signal(RN_SECONDS, 48000, 2, seed=21)
    cpu = rnnoise_run(params, x, "cpu")
    card = rnnoise_run(params, x, "cuda")
    r = rnnoise_compare(card, cpu)
    results["engine"] = r
    log(f"rnnoise engine, 12 s 48 kHz stereo, card vs CPU: wave rel L2 {r['wave_rel_l2']:.3e} "
        f"(limit {RN_WAVE_REL:g}), max|d| {r['wave_max_abs']:.3e} (limit {RN_WAVE_ABS:g}), VAD "
        f"max|d| {r['vad_max_abs']:.3e} (limit {RN_VAD:g}), period flips {r['period_flips']}, "
        f"silence flips {r['silence_flips']} ({r['silent_frames']} of {r['frames']} frames "
        f"silent) {'ok' if r['ok'] else 'FAIL'}")
    if not r["ok"]:
        failures.append(f"rnnoise engine card vs CPU: {r}")
    if not 0 < r["silent_frames"] < r["frames"]:
        failures.append(f"rnnoise: the test signal has {r['silent_frames']} silent frames")

    def swapped(h, xw, recurrent):
        u = h.shape[-1]
        perm = torch.cat([torch.arange(u, 2 * u), torch.arange(u),
                          torch.arange(2 * u, 3 * u)]).to(h.device)
        return real_update(h, xw[..., perm], recurrent[..., perm])

    real_update, real_hold = rn._gru_update, rn._hold
    for fault, name, planted in (("silence freeze dropped", "_hold", lambda s, old, new: new),
                                 ("z and r swapped in the GRU", "_gru_update", swapped)):
        setattr(rn, name, planted)
        try:
            bad = rnnoise_compare(rnnoise_run(params, x, "cuda"), cpu)
        finally:
            rn._gru_update, rn._hold = real_update, real_hold
        results[f"planted: {fault}"] = bad
        log(f"rnnoise planted fault ({fault}): wave rel L2 {bad['wave_rel_l2']:.3e}, VAD "
            f"max|d| {bad['vad_max_abs']:.3e} {'NOT REJECTED' if bad['ok'] else 'rejected'}")
        if bad["ok"]:
            failures.append(f"the RNNoise limits do not reject the planted fault: {fault}")

    seen = []
    undo = on_devices(rn, "denoise", seen)
    try:
        for label, sr, mode in (("48 kHz stereo, per_channel", 48000, "per_channel"),
                                ("48 kHz stereo, downmix_mono", 48000, "downmix_mono"),
                                ("16 kHz stereo, per_channel", 16000, "per_channel")):
            xs = x if sr == 48000 else speech_signal(RN_SECONDS, sr, 2, seed=22)
            audio = {"waveform": torch.from_numpy(xs[None]), "sample_rate": sr}
            outs = {}
            for dev in ("cuda", "cpu", "cuda"):
                DeviceNode.DEVICE = dev
                (out, wall) = synced_wall(lambda: node_cls().execute(audio, stereo_mode=mode))
                outs[dev] = (out[0]["waveform"].numpy(), wall)
            DeviceNode.DEVICE = "cuda"
            (g, wall), (h, cpu_wall) = outs["cuda"], outs["cpu"]
            rel = float(np.linalg.norm(g - h) / np.linalg.norm(h))
            shape = (1, 2 if mode == "per_channel" else 1, xs.shape[1])
            ok = g.shape == shape and bool(np.isfinite(g).all()) and rel <= RN_WAVE_REL
            results[f"node {label}"] = {"warm_wall_s": wall, "cpu_wall_s": cpu_wall,
                                        "rel_l2": rel, "rtf": RN_SECONDS / wall}
            log(f"rnnoise node {label}: warm {wall:.3f} s on the card (RTF "
                f"{RN_SECONDS / wall:.1f}x; CPU {cpu_wall:.2f} s), out {g.shape}, card vs CPU "
                f"rel L2 {rel:.3e} (limit {RN_WAVE_REL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"rnnoise node {label}: {g.shape}, rel L2 {rel}")
    finally:
        undo()
        DeviceNode.DEVICE = "cuda"
    if seen.count("cuda") != 6 or seen.count("cpu") != 3:
        failures.append(f"rnnoise node: the engine ran on {seen}")

    # timing: the sequential loop, and the segmented one on bench.py's shape
    xd = torch.from_numpy(x).cuda()
    frames = xd.shape[1] // rn.FRAME
    rn.denoise(params, xd, segments=1)
    _, seq_wall = synced_wall(lambda: rn.denoise(params, xd, segments=1))
    half = xd[:, : xd.shape[1] // 2]
    per_step = (ops_dispatched(lambda: rn.denoise(params, xd, segments=1))
                - ops_dispatched(lambda: rn.denoise(params, half, segments=1))) / (frames - frames // 2)
    results["sequential"] = {"wall_s": seq_wall, "frames": frames,
                             "ms_per_frame_step": 1e3 * seq_wall / frames,
                             "ops_per_frame_step": per_step, "rtf": RN_SECONDS / seq_wall}
    x60 = torch.from_numpy(speech_signal(RN_LONG_SECONDS, 48000, 2, seed=23)).cuda()
    rn.denoise(params, x60, segments=RN_SEGMENTS)
    loops = {"_pitch_loop": 0.0, "_gru_loop": 0.0}
    reals = {name: getattr(rn, name) for name in loops}

    def timed(name):
        def f(*args, **kwargs):
            out, wall = synced_wall(lambda: reals[name](*args, **kwargs))
            loops[name] += wall
            return out
        return f

    for name in loops:
        setattr(rn, name, timed(name))
    try:
        _, long_wall = synced_wall(lambda: rn.denoise(params, x60, segments=RN_SEGMENTS))
    finally:
        for name, fn in reals.items():
            setattr(rn, name, fn)
    _, long_plain = synced_wall(lambda: rn.denoise(params, x60, segments=RN_SEGMENTS))
    steps = -(-(x60.shape[1] // rn.FRAME) // RN_SEGMENTS) + 100
    results["segments_16"] = {"wall_s": long_plain, "rtf": RN_LONG_SECONDS / long_plain,
                              "pitch_loop_s": loops["_pitch_loop"],
                              "gru_loop_s": loops["_gru_loop"],
                              "rest_s": long_wall - sum(loops.values()), "steps": steps}
    log(f"rnnoise timing: segments=1 on 12 s stereo {seq_wall:.3f} s ({frames} frame steps, "
        f"{1e3 * seq_wall / frames:.3f} ms a step, {per_step:.1f} operations dispatched a step; "
        f"RTF {RN_SECONDS / seq_wall:.1f}x); segments={RN_SEGMENTS} on 60 s stereo "
        f"{long_plain:.3f} s (RTF {RN_LONG_SECONDS / long_plain:.1f}x; {steps} steps a loop; "
        f"timed apart: pitch loop {loops['_pitch_loop']:.3f} s, GRU loop "
        f"{loops['_gru_loop']:.3f} s, analysis and synthesis "
        f"{long_wall - sum(loops.values()):.3f} s)")
    if failures:
        raise RuntimeError("; ".join(failures))
    return results


def fatllama_phase() -> dict:
    """The Fat Llama GPU node on 30 s of 16 kHz mono at its defaults
    (factor 6, n_up 2 880 000 = 1600 x 1800, the fold loop, 300
    iterations), timed as iterations a second; the engine at 20 iterations
    on the card against the CPU, on the fold loop and on a length padded
    to a power of two (one cuFFT pair an iteration), beside the planted
    fault of observations clamped one sample late; the CPU node once, its
    engine asserted on the CPU."""
    import numpy as np
    import torch

    import tempfile
    import wave
    from pathlib import Path

    from egregora_tpu_torch.nodes import spectral_enhance as se
    from egregora_tpu_torch.ops import spectral as sp
    from egregora_tpu_torch.utils import native

    sr = 16000
    n = int(FL_SECONDS * sr)
    x = (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / sr)).astype(np.float32)[None]
    factor = sp.upscale_factor(sr, 1, 1411)
    if factor != 6 or not sp.fold_loop(n * factor, factor, True):
        raise RuntimeError(f"Fat Llama: factor {factor}, fold loop "
                           f"{sp.fold_loop(n * factor, factor, True)} at 30 s of 16 kHz mono")
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": sr}
    args = dict(target_format="wav", max_iterations=FL_ITERS, threshold_value=0.6,
                target_bitrate_kbps=1411)
    seen, failures, results = [], [], {}
    undo = on_devices(se, "spectral_enhance", seen)
    try:
        se.EgregoraFatLlamaGPU().run(**args, AUDIO=audio)
        (out,), wall = synced_wall(lambda: se.EgregoraFatLlamaGPU().run(**args, AUDIO=audio))
        y = out["waveform"].numpy()
        with tempfile.TemporaryDirectory() as d:     # the CPU node reads a WAV file
            path = Path(d) / "fatllama.wav"
            with wave.open(str(path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes((x[0, :2 * sr] * 32767).astype("<i2").tobytes())
            (cpu_out,), cpu_wall = synced_wall(lambda: se.EgregoraFatLlamaCPU().run(
                target_format="wav", max_iterations=FL_CHECK_ITERS, threshold_value=0.6,
                target_bitrate_kbps=1411, audio_path=str(path)))
    finally:
        undo()
    codec = native.load()
    log(f"fatllama: the CPU node read its WAV through "
        f"{'the native codec, built at ' + str(native.library_path()) if codec else 'the stdlib wave fallback (no native codec: ' + str(native.library_path()) + ' not built)'}")
    xd = torch.from_numpy(x).cuda()
    sp.spectral_enhance(xd, factor, FL_ITERS, 0.6, use_matmul_fft=True)
    _, engine_wall = synced_wall(lambda: sp.spectral_enhance(xd, factor, FL_ITERS, 0.6,
                                                             use_matmul_fft=True))
    per_iter = (ops_dispatched(lambda: sp.ist_upscale(xd, factor, 20, 0.6, True))
                - ops_dispatched(lambda: sp.ist_upscale(xd, factor, 10, 0.6, True))) / 10
    ok = (y.shape == (1, 1, n * factor) and out["sample_rate"] == sr * factor
          and bool(np.isfinite(y).all()) and seen == ["cuda", "cuda", "cpu"]
          and cpu_out["waveform"].shape == (1, 1, 2 * sr * factor))
    results["node"] = {"warm_wall_s": wall, "iters_per_s": FL_ITERS / wall,
                       "engine_wall_s": engine_wall, "engine_iters_per_s": FL_ITERS / engine_wall,
                       "ops_per_iteration": per_iter, "cpu_node_wall_s": cpu_wall}
    log(f"fatllama GPU node, 30 s 16 kHz mono to 96 kHz (n_up {n * factor}, fold loop, "
        f"{FL_ITERS} iterations): warm {wall:.3f} s, {FL_ITERS / wall:.0f} iterations/s; the "
        f"engine alone {engine_wall:.4f} s, {FL_ITERS / engine_wall:.0f} iterations/s, "
        f"{per_iter:.1f} operations dispatched an iteration; out {y.shape} @ "
        f"{out['sample_rate']} Hz; CPU node (2 s, {FL_CHECK_ITERS} iterations) {cpu_wall:.2f} s; "
        f"engine devices {seen} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"Fat Llama node: {y.shape}, engines on {seen}")

    def late(z, y_obs, f):
        z[:, 1: y_obs.shape[1] * f: f] = y_obs
        return z

    xp = np.concatenate([x, x[:, :1]], 1)        # 480001 samples: 4194304-point transforms
    for label, xx in (("fold loop", x), ("padded to 2^22, a cuFFT pair an iteration", xp)):
        n_up = xx.shape[1] * factor
        kw = dict(use_matmul_fft=True)
        host = sp.spectral_enhance(torch.from_numpy(xx), factor, FL_CHECK_ITERS, 0.6, **kw)
        card = sp.spectral_enhance(torch.from_numpy(xx).cuda(), factor, FL_CHECK_ITERS, 0.6, **kw)
        err = float((card.cpu() - host).abs().max())
        real = sp._clamp_observed
        sp._clamp_observed = late
        try:
            bad = sp.spectral_enhance(torch.from_numpy(xx).cuda(), factor, FL_CHECK_ITERS, 0.6, **kw)
        finally:
            sp._clamp_observed = real
        bad_err = float((bad.cpu() - host).abs().max())
        fold = sp.fold_loop(n_up, factor, True)
        results[label] = {"n_up": n_up, "transform": sp.transform_length(n_up), "fold": fold,
                          "max_abs_err": err, "planted_max_abs_err": bad_err}
        ok = err <= FL_ABS and bad_err > FL_ABS and fold == (label == "fold loop")
        log(f"fatllama engine {label} (n_up {n_up}, transform {sp.transform_length(n_up)}), "
            f"{FL_CHECK_ITERS} iterations, card vs CPU max|d| {err:.3e} (limit {FL_ABS:g}); "
            f"planted fault (observations clamped one sample late) {bad_err:.3e} "
            f"{'rejected' if bad_err > FL_ABS else 'NOT REJECTED'} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"Fat Llama {label}: {results[label]}")
    if failures:
        raise RuntimeError("; ".join(failures))
    return results


def wpe_phase() -> dict:
    """WPE on 20 s of seeded 48 kHz stereo through a synthetic
    exponential-decay room: ``wpe_dereverb`` called directly, then the
    node at its defaults (taps 10, delay 3, 3 iterations, n_fft 1024, hop
    256) on the card, which must equal the direct call (so its passthrough
    on an exception cannot hide a failure), differ from its input and
    lower the late-reverb energy; the card against the CPU."""
    import numpy as np
    import torch

    from egregora_tpu_torch.models import wpe as W
    from egregora_tpu_torch.nodes import enhance_extras as ee
    from egregora_tpu_torch.nodes.base import DeviceNode

    x, late = reverb_signal(WPE_SECONDS, 48000, seed=31)
    xd = torch.from_numpy(x).cuda()
    W.wpe_dereverb(xd)
    direct, direct_wall = synced_wall(lambda: W.wpe_dereverb(xd))
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": 48000}
    seen = []
    DeviceNode.DEVICE = "cuda"
    undo = on_devices(W, "wpe_dereverb", seen)
    try:
        (out,), node_wall = synced_wall(lambda: ee.Egregora_WPE_Dereverb().execute(audio))
    finally:
        undo()
    got = out["waveform"].numpy()[0]
    direct = direct.cpu().numpy()
    (host,), cpu_wall = synced_wall(lambda: (W.wpe_dereverb(torch.from_numpy(x)).numpy(),))
    node_err = float(np.abs(got - direct).max())
    cpu_err = float(np.abs(direct - host).max())
    change = float(np.abs(got - x).max())
    e_in, e_out = float(np.square(x[:, late]).sum()), float(np.square(got[:, late]).sum())
    ok = (seen == ["cuda"] and node_err <= WPE_NODE_ABS and cpu_err <= WPE_CPU_ABS
          and change > 1e-2 and e_out < e_in and bool(np.isfinite(got).all()))
    log(f"wpe, 20 s 48 kHz stereo (defaults): direct {direct_wall:.3f} s warm, node "
        f"{node_wall:.3f} s on the card (CPU {cpu_wall:.2f} s); node vs direct max|d| "
        f"{node_err:.3e} (limit {WPE_NODE_ABS:g}), card vs CPU {cpu_err:.3e} (limit "
        f"{WPE_CPU_ABS:g}); max change {change:.3f}; late-reverb energy {e_in:.4g} -> "
        f"{e_out:.4g} ({10 * math.log10(e_out / e_in):+.2f} dB); engine on {seen} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"wpe: node {node_err}, CPU {cpu_err}, change {change}, late "
                           f"{e_in} -> {e_out}, devices {seen}")
    return {"direct_wall_s": direct_wall, "node_wall_s": node_wall, "cpu_wall_s": cpu_wall,
            "node_max_abs_err": node_err, "cpu_max_abs_err": cpu_err,
            "late_reverb_db": 10 * math.log10(e_out / e_in)}


def chain_phase() -> dict:
    """The full chain as a user wires the nodes, on 120 s of seeded 16 kHz
    mono (``bench.py``'s input): the RNNoise node
    (``EGREGORA_RNNOISE_SEGMENTS=16``), the upscaler (the default istft
    trio) to 48 kHz, the Fat Llama GPU node (1411 kbps at 48 kHz mono:
    factor 2, n_up 11 520 000 = 3200 x 3600, 50 iterations) to 96 kHz,
    then the loudness meter and LSD / SI-SDR against the input resampled
    to 96 kHz; cold, then warm with every stage timed and the kernels'
    launches counted by shape."""
    import numpy as np
    import torch

    from egregora_tpu_torch.eval.metrics import lsd_sisdr_report
    from egregora_tpu_torch.nodes import enhance_extras as ee
    from egregora_tpu_torch.nodes import eval_pack as ep
    from egregora_tpu_torch.nodes import spectral_enhance as se
    from egregora_tpu_torch.nodes import super_resolution
    from egregora_tpu_torch.nodes.base import DeviceNode
    from egregora_tpu_torch.ops.resample import resample

    rng = np.random.default_rng(6)
    x16 = (rng.standard_normal((1, int(16000 * CHAIN_SECONDS))) * 0.1).astype(np.float32)
    audio = {"waveform": torch.from_numpy(x16[None]), "sample_rate": 16000}
    set_env(EGREGORA_RNNOISE_SEGMENTS=str(RN_SEGMENTS), EGREGORA_FLASHSR_VARIANT=None,
            EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)
    up_cls = super_resolution.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]
    up_cls._PIPE = None
    DeviceNode.DEVICE = "cuda"
    n96 = int(96000 * CHAIN_SECONDS)

    def chain():
        stages = {}
        (den,), stages["rnnoise"] = synced_wall(lambda: ee.Egregora_RNNoise_Denoise().execute(
            audio, strength=0.8))
        (up,), stages["flashsr"] = synced_wall(lambda: up_cls().run(den, False, "48000"))
        (out,), stages["fat llama"] = synced_wall(lambda: se.EgregoraFatLlamaGPU().run(
            "wav", CHAIN_ITERS, 0.6, 1411, True, True, AUDIO=up))
        (loud,), stages["loudness"] = synced_wall(lambda: ep.Loudness_Meter_1770().execute(out))

        def metrics():
            ref = resample(torch.from_numpy(x16).cuda(), 16000, 96000)
            y = out["waveform"][0].cuda()
            n = min(ref.shape[1], y.shape[1])
            return {k: float(v) for k, v in lsd_sisdr_report(ref[0, :n], y[0, :n]).items()}

        rep, stages["lsd / si-sdr"] = synced_wall(metrics)
        return den, up, out, loud, rep, stages

    try:
        _, cold = synced_wall(chain)
        reset_counts()
        (den, up, out, loud, rep, stages), wall = synced_wall(chain)
        counts = read_counts()
    finally:
        set_env(EGREGORA_RNNOISE_SEGMENTS=None)
    y = out["waveform"].numpy()
    finite = bool(np.isfinite(y).all()) and all(math.isfinite(v) for v in
                                                list(loud.values()) + list(rep.values()))
    others = {k: v for k, v in counts.items() if k not in ("attn_rows", "iir_lowpass") and v}
    k4_expect = {(1, n96): 4}
    ok = (y.shape == (1, 1, n96) and out["sample_rate"] == 96000 and finite
          and up["sample_rate"] == 48000 and den["sample_rate"] == 16000
          and counts["iir_lowpass"] == k4_expect and counts["attn_rows"] and not others)
    log(f"full chain, 120 s 16 kHz mono -> RNNoise -> FlashSR 48 kHz -> Fat Llama 96 kHz -> "
        f"loudness, LSD/SI-SDR: cold {cold:.3f} s, warm {wall:.3f} s (RTF "
        f"{CHAIN_SECONDS / wall:.1f}x); stages " + ", ".join(
            f"{k} {v:.3f} s (RTF {CHAIN_SECONDS / v:.0f}x)" for k, v in stages.items())
        + f"; out {y.shape} @ {out['sample_rate']} Hz, finite {finite}; loudness "
        f"{ {k: round(v, 3) for k, v in loud.items()} }; metrics {rep}; launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"full chain: out {y.shape} @ {out['sample_rate']}, finite {finite}, "
                           f"launches {counts} (K4 expected {k4_expect})")
    return {"cold_s": cold, "warm_s": wall, "rtf": CHAIN_SECONDS / wall, "stages": stages,
            "loudness": loud, "metrics": rep, "counts": counts}


# ---- DeepFilterNet and the DAC codec (plain PyTorch: no kernel) ----

DFN_VARIANTS = ("DeepFilterNet2", "DeepFilterNet3")
# DeepFilterNet, float32 end to end (its convs and GRUs in full float32):
# the card against the same port on the CPU on 10 s of 48 kHz, the wave's
# relative L2 and the ERB gains' max |d| (the first run read 1.7e-7 and
# 4.4e-6; the deep filter's fault moves the wave by 3e-5 only, its
# coefficients being small); the node on 12 s of 16 kHz stereo, relative
# L2; the engine's RTF on bench.py's dfn2_rtf_48k input
DFN_SECONDS, DFN_CHECK_SECONDS, DFN_NODE_SECONDS = 60.0, 10.0, 12.0
DFN_WAVE_REL, DFN_GAINS, DFN_NODE_REL = 5e-6, 5e-5, 1e-3
# the shipped DAC codecs, bf16 on both sides: decode of the CPU's latents,
# relative L2, and the roundtrip SNR against the CPU's, dB
DAC_SECONDS, DAC_DECODE_REL, DAC_SNR_DB = 10.0, 2e-2, 0.5
# the published geometry (seeded weights, converted path), bf16 on the
# card against float32 on the CPU on a 2 s piece: pre-quantisation latents
# and decode of the CPU's latents, relative L2 (the first run read 1.4e-2
# and 1.3e-2; the planted faults 0.68 and 1.10)
DAC_PUB_SECONDS, DAC_PIECE_SECONDS = 30.0, 2.0
DAC_PUB_LATENT_REL, DAC_PUB_DECODE_REL = 3e-2, 3e-2
# the published 44 kHz geometry's convs traced on a 60 s stereo clip: none of
# these kernels (cuDNN's legacy NCW conv, its NCHW<->NHWC transposes) may
# run under the encoder's or the decoder's span
DAC_TRACE_SECONDS = 60.0
DAC_SLOW_KERNELS = ("implicit_convolve_sgemm", "nchwToNhwcKernel", "nhwcToNchwKernel")


def noisy_speech(seconds: float, sr: int, channels: int, seed: int):
    """``speech_signal`` plus seeded white noise at 0.05 (what a denoiser
    is for); ``[C, S]`` float32."""
    import numpy as np
    x = speech_signal(seconds, sr, channels, seed)
    return (x + 0.05 * np.random.default_rng(seed + 1000).standard_normal(x.shape)
            ).astype(np.float32)


def same_tree(a, b) -> bool:
    import numpy as np
    if isinstance(b, dict):
        return set(a) == set(b) and all(same_tree(a[k], b[k]) for k in b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def no_launches(phase: str) -> None:
    """The phase ran none of the kernels ``read_counts`` counts (its modules
    hold none; the DAC phases' Snake kernel they count themselves)."""
    launched = {k: v for k, v in read_counts().items() if v}
    if launched:
        raise RuntimeError(f"{phase}: kernels launched {launched}")


def dfn_run(params, x, device: str):
    """(wave, ERB gains) of ``enhance_mono_full`` on ``device``, host arrays."""
    import torch

    from egregora_tpu_torch.models.deepfilternet import model as D
    y, gains, _ = D.enhance_mono_full(params, torch.from_numpy(x).to(device))
    return y.cpu().numpy(), gains.cpu().numpy()


def dfn_compare(card, cpu) -> dict:
    import numpy as np
    (wave_c, gains_c), (wave_h, gains_h) = card, cpu
    r = {"wave_rel_l2": float(np.linalg.norm(wave_c - wave_h) / np.linalg.norm(wave_h)),
         "gains_max_abs": float(np.abs(gains_c - gains_h).max())}
    r["ok"] = (r["wave_rel_l2"] <= DFN_WAVE_REL and r["gains_max_abs"] <= DFN_GAINS
               and bool(np.isfinite(wave_c).all()))
    return r


def dfn_unflipped_conv_t(p, x, stride_f: int = 2):
    """Planted fault: ``_conv_t`` with the kernel not flipped."""
    import torch.nn.functional as F
    t, f = x.shape[-2], x.shape[-1]
    y = F.conv_transpose2d(x, p["kernel"].permute(2, 3, 0, 1), stride=(1, stride_f))
    return y[..., :t, : f * stride_f] + p["bias"][:, None, None]


def dfn_future_frames(x, order: int):
    """Planted fault: the deep filter's stack reading frames t+1, t+2, ...
    where it should read t-1, t-2, ..."""
    import torch
    import torch.nn.functional as F
    t = x.shape[-2]
    return torch.stack([x] + [F.pad(x, (0, 0, 0, k))[..., k:k + t, :]
                              for k in range(1, order)], -1)


def dfn_phase(card: str) -> dict:
    """DeepFilterNet on the card: both shipped weight sets asserted loaded
    by the node (its random-init branch fails the run); the engine on
    60 s of seeded 48 kHz mono noise (``bench.py``'s ``dfn2_rtf_48k``
    input) per variant as RTF, its GRUs timed apart; one GRU recurrence of
    that length as the served cuDNN call and as a step loop of plain
    operations (time, max |d| 1e-5); ``enhance_mono_full``
    on 10 s of noisy speech-like 48 kHz on the card against the CPU (wave
    and ERB gains) beside three planted faults the limits must reject (z
    and r swapped in the GRU; ``_conv_t`` without the kernel flip; the
    deep filter reading frame t+1 for t-1); the node at its defaults with
    the post-filter on, on 12 s of 16 kHz stereo, with the rms and the
    rnnoise VAD source, each on the card against the CPU."""
    import numpy as np
    import torch

    from egregora_tpu_torch.models.deepfilternet import model as D
    from egregora_tpu_torch.models.deepfilternet import train as dtr
    from egregora_tpu_torch.models.rnnoise.model import params_on
    from egregora_tpu_torch.nodes import enhance_extras as ee
    from egregora_tpu_torch.nodes.base import DeviceNode
    from egregora_tpu_torch.ops.fir import exact_f32
    from egregora_tpu_torch.utils.weights import load_params

    reset_counts()
    node_cls = ee.Egregora_DeepFilterNet_Denoise
    node_cls._PARAMS = {}
    real_init = D.init_params

    def refuse(*args, **kwargs):
        raise RuntimeError("the DeepFilterNet node reached its random-init branch")

    D.init_params = refuse
    try:
        params = {v: node_cls._params(v) for v in DFN_VARIANTS}
    finally:
        D.init_params = real_init
    for v in DFN_VARIANTS:
        if not same_tree(params[v], load_params(dtr.pretrained_path(v))):
            raise RuntimeError(f"the DeepFilterNet node does not serve the shipped {v} weights")
    log(f"deepfilternet ({card}): the node serves the shipped weights (" + ", ".join(
        f"{dtr.pretrained_path(v).name} {dtr.pretrained_path(v).stat().st_size} bytes"
        for v in DFN_VARIANTS) + ")")

    failures, results = [], {}
    rng = np.random.default_rng(9)
    x60 = torch.from_numpy((rng.standard_normal((1, int(48000 * DFN_SECONDS))) * 0.1)
                           .astype(np.float32)).cuda()
    real_gru = D._torch_gru
    gru_s = [0.0]

    def timed_gru(*args):
        out, wall = synced_wall(lambda: real_gru(*args))
        gru_s[0] += wall
        return out

    for v in DFN_VARIANTS:
        pd = params_on(params[v], "cuda")
        D.enhance(pd, x60)
        wall = min(synced_wall(lambda: D.enhance(pd, x60))[1] for _ in range(2))
        D._torch_gru, gru_s[0] = timed_gru, 0.0
        try:
            _, split = synced_wall(lambda: D.enhance(pd, x60))
        finally:
            D._torch_gru = real_gru
        frames = int(x60.shape[1] + D.N_FFT) // D.HOP + 1
        results[f"{v} engine"] = {"wall_s": wall, "rtf": DFN_SECONDS / wall, "frames": frames,
                                  "gru_s": gru_s[0], "rest_s": split - gru_s[0]}
        log(f"deepfilternet {v} engine, 60 s 48 kHz mono ({frames} frames), {card}: warm "
            f"{wall:.4f} s (RTF {DFN_SECONDS / wall:.1f}x); timed apart: the GRU calls "
            f"{gru_s[0]:.4f} s, the rest {split - gru_s[0]:.4f} s")

    # the served GRU form (one cuDNN call a recurrence) against a step loop
    # of plain operations on one recurrence at 60 s: time, and agreement
    from egregora_tpu_torch.models.rnnoise.model import _gru_update
    g = params_on(params["DeepFilterNet2"]["df_dec"]["gru"], "cuda")
    gen = torch.Generator().manual_seed(53)
    xs = torch.tanh(torch.randn(1, frames, g["kernel"].shape[0], generator=gen)).cuda()

    def step_loop():
        xw, h, hs = xs @ g["kernel"] + g["bias"], xs.new_zeros(1, g["recurrent"].shape[0]), []
        for t in range(frames):
            h = _gru_update(h, xw[:, t], g["recurrent"])
            hs.append(h)
        return torch.stack(hs, 1)

    with exact_f32():
        real_gru(g["kernel"], g["recurrent"], g["bias"], xs)
        cudnn_out, cudnn_wall = synced_wall(lambda: real_gru(g["kernel"], g["recurrent"],
                                                             g["bias"], xs))
        step_loop()
        loop_out, loop_wall = synced_wall(step_loop)
    gru_err = float((cudnn_out - loop_out).abs().max())
    results["gru forms"] = {"frames": frames, "cudnn_s": cudnn_wall, "loop_s": loop_wall,
                            "max_abs_diff": gru_err}
    log(f"deepfilternet GRU (df decoder, 256 units, {frames} steps), {card}: one cuDNN call "
        f"{cudnn_wall:.4f} s ({1e6 * cudnn_wall / frames:.1f} us a step), a step loop of plain "
        f"operations {loop_wall:.4f} s ({1e6 * loop_wall / frames:.1f} us a step); max|d| "
        f"{gru_err:.2e} (limit 1e-5)")
    if not gru_err <= 1e-5:
        failures.append(f"deepfilternet: the cuDNN GRU and the step loop differ by {gru_err}")

    x10 = noisy_speech(DFN_CHECK_SECONDS, 48000, 1, seed=51)[0]
    cpu_ref = {}
    for v in DFN_VARIANTS:
        cpu_ref[v] = dfn_run(params[v], x10, "cpu")
        r = dfn_compare(dfn_run(params[v], x10, "cuda"), cpu_ref[v])
        results[f"{v} card vs CPU"] = r
        log(f"deepfilternet {v}, 10 s 48 kHz, card vs CPU ({card}): wave rel L2 "
            f"{r['wave_rel_l2']:.3e} (limit {DFN_WAVE_REL:g}), gains max|d| "
            f"{r['gains_max_abs']:.3e} (limit {DFN_GAINS:g}) {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failures.append(f"deepfilternet {v} card vs CPU: {r}")
    for fault, name, planted in (
            ("z and r swapped in the GRU", "_cudnn_gate_order", lambda w: w),
            ("_conv_t without the kernel flip", "_conv_t", dfn_unflipped_conv_t),
            ("the deep filter reading frame t+1 for t-1", "_shift_stack", dfn_future_frames)):
        real = getattr(D, name)
        setattr(D, name, planted)
        try:
            bad = dfn_compare(dfn_run(params["DeepFilterNet2"], x10, "cuda"),
                              cpu_ref["DeepFilterNet2"])
        finally:
            setattr(D, name, real)
        results[f"planted: {fault}"] = bad
        log(f"deepfilternet planted fault ({fault}; {card}): wave rel L2 "
            f"{bad['wave_rel_l2']:.3e}, gains max|d| {bad['gains_max_abs']:.3e} "
            f"{'NOT REJECTED' if bad['ok'] else 'rejected'}")
        if bad["ok"]:
            failures.append(f"the DeepFilterNet limits do not reject the planted fault: {fault}")

    xs = noisy_speech(DFN_NODE_SECONDS, 16000, 2, seed=52)
    audio = {"waveform": torch.from_numpy(xs[None]), "sample_rate": 16000}
    seen = []
    undo = on_devices(D, "enhance", seen)
    try:
        for vad in ("rms", "rnnoise"):
            outs = {}
            for dev in ("cuda", "cpu", "cuda"):
                DeviceNode.DEVICE = dev
                (out,), wall = synced_wall(lambda: node_cls().execute(
                    audio, adaptive_vad_source=vad, use_postfilter=True))
                outs[dev] = (out["waveform"].numpy(), wall, out["meta"]["deepfilternet"]["device"])
            DeviceNode.DEVICE = "cuda"
            (g, wall, ran), (h, cpu_wall, ran_h) = outs["cuda"], outs["cpu"]
            rel = float(np.linalg.norm(g - h) / np.linalg.norm(h))
            ok = (g.shape == (1, 2, xs.shape[1]) and bool(np.isfinite(g).all())
                  and rel <= DFN_NODE_REL and (ran, ran_h) == ("cuda", "cpu"))
            results[f"node {vad}"] = {"warm_wall_s": wall, "cpu_wall_s": cpu_wall, "rel_l2": rel,
                                      "rtf": DFN_NODE_SECONDS / wall}
            log(f"deepfilternet node, 12 s 16 kHz stereo, defaults + post-filter, VAD {vad}, "
                f"{card}: warm {wall:.3f} s on the card (RTF {DFN_NODE_SECONDS / wall:.1f}x; CPU "
                f"{cpu_wall:.2f} s), out {g.shape}, meta device {ran}, card vs CPU rel L2 "
                f"{rel:.3e} (limit {DFN_NODE_REL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"deepfilternet node ({vad}): {g.shape}, rel L2 {rel}, {ran}")
    finally:
        undo()
        DeviceNode.DEVICE = "cuda"
    if seen != ["cuda", "cpu", "cuda"] * 2:
        failures.append(f"deepfilternet node: the engine ran on {seen}")
    no_launches("deepfilternet")
    if failures:
        raise RuntimeError("; ".join(failures))
    return results


def seeded_dac_tree(cfg, seed: int) -> dict:
    """The JAX package's DAC parameter tree for ``cfg`` (its flax layout,
    numpy leaves; ``utils.weights.save_params`` writes it as the JAX
    package's ``save_params`` does) with seeded weights from a torch
    generator (``layers.seeded_init_``; quick at the published geometry,
    where the flax draws of ``DACModel.init_params`` take a while) kept out
    of tanh saturation: lecun-normal kernels with each residual unit's last conv
    scaled by 0.3 and the decoder's output conv by 0.1, biases N(0, 0.01),
    alphas U(0.5, 1.5), unit-normal codebooks."""
    import torch

    from egregora_tpu_torch.models.dac.model import DACModel
    from egregora_tpu_torch.models.flashsr.layers import seeded_init_
    from egregora_tpu_torch.utils.weights import flax_tree
    m = DACModel(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    seeded_init_(m, gen)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if ".codebook_" in name:
                p.copy_(torch.randn(p.shape, generator=gen))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("alpha"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            elif name.endswith("bias"):
                p.copy_(0.01 * torch.randn(p.shape, generator=gen))
        w = m.decoder.Conv_1.weight
        w.copy_(0.1 * torch.randn(w.shape, generator=gen) * w[0].numel() ** -0.5)
        for name, mod in m.named_modules():
            if "ResidualUnit" in name and name.endswith("Conv_1"):
                mod.weight.mul_(0.3)
    return {name: flax_tree(getattr(m, name), values=True) for name in ("encoder", "decoder", "rvq")}


def dac_rel(a, b) -> float:
    import torch
    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return float((a - b).norm() / b.norm())


def launched_under(prof, wanted) -> list:
    """``[(range, [(kernel, seconds), ...]), ...]``: each host range of the
    finished ``torch.profiler`` session ``prof`` whose name ``wanted``
    accepts, in the order they opened, with the card's kernels, copies and
    sets launched inside it (matched by the launching runtime call's
    correlation id)."""
    from torch.autograd import DeviceType
    ranges, launch_at, dev = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if wanted(name):
                ranges.append((e.start_ns(), e.end_ns(), name))
            elif name.startswith("cu"):
                launch_at[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            dev.append((e.correlation_id(), name, (e.end_ns() - e.start_ns()) * 1e-9))
    ranges.sort()
    out = [(name, []) for _, _, name in ranges]
    for corr, name, sec in dev:
        at = launch_at.get(corr)
        for i, (t0, t1, _) in enumerate(ranges):
            if at is not None and t0 <= at <= t1:
                out[i][1].append((name, sec))
    return out


def dac_conv_trace(model, card: str) -> dict:
    """One ``encode`` + ``decode`` of ``DAC_TRACE_SECONDS`` of stereo by the
    codec ``model`` on the card, warmed on the same clip first, under
    ``torch.profiler`` with a range around every DAC conv: each conv's
    kernels logged, and a failure where a kernel of ``DAC_SLOW_KERNELS``
    ran under ``egr.dac.encoder`` or ``egr.dac.decoder`` or the call
    counted a ``dac_layout_copies``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.utils import profiling

    x = torch.from_numpy(speech_signal(DAC_TRACE_SECONDS, model.cfg.sample_rate, 2, seed=75))
    model.decode(model.encode(x)[0])
    torch.cuda.synchronize()
    convs = {m: n for n, m in model.named_modules()
             if isinstance(m, (M.Conv1dNWC, M.ConvTranspose1dNWC))}
    opened = {}

    def enter(m, args):
        opened[m] = record_function(f"dac.conv {convs[m]}")
        opened[m].__enter__()

    def leave(m, args, out):
        opened.pop(m).__exit__(None, None, None)

    hooks = [h for m in convs for h in (m.register_forward_pre_hook(enter),
                                        m.register_forward_hook(leave))]
    copies = profiling.counters().get("dac_layout_copies", 0)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.decode(model.encode(x)[0])
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    copies = profiling.counters().get("dac_layout_copies", 0) - copies
    found = launched_under(prof, lambda n: n.startswith("dac.conv ")
                           or n in ("egr.dac.encoder", "egr.dac.decoder"))
    mods = dict((n, m) for m, n in convs.items())
    for name, ks in found:
        if not name.startswith("dac.conv "):
            continue
        m = mods[name[9:]]
        co, ci = ((m.weight.shape[1], m.weight.shape[0]) if isinstance(m, M.ConvTranspose1dNWC)
                  else m.weight.shape[:2])
        by = collections.defaultdict(float)
        for k, sec in ks:
            by[k] += sec
        log(f"dac conv {name[9:]} ({type(m).__name__} {ci}->{co}, k {m.k}, stride {m.stride}, "
            f"dilation {getattr(m, 'dilation', 1)}): "
            + "; ".join(f"{k[:90]} {1e3 * sec:.3f} ms" for k, sec in by.items()))
    slow, per_span = [], {}
    for name, ks in found:
        if name.startswith("egr.dac."):
            per_span[name] = per_span.get(name, 0.0) + sum(sec for _, sec in ks)
            slow += [(name, k) for k, _ in ks if any(b in k for b in DAC_SLOW_KERNELS)]
    ok = (not slow and copies == 0 and set(per_span) == {"egr.dac.encoder", "egr.dac.decoder"}
          and all(v > 0 for v in per_span.values()))
    log(f"dac conv trace, {DAC_TRACE_SECONDS:g} s stereo, {card}: device "
        + ", ".join(f"{n} {1e3 * v:.1f} ms" for n, v in per_span.items())
        + f"; {len(slow)} launches of {', '.join(DAC_SLOW_KERNELS)}"
        + (f" ({sorted(set(slow))[:6]})" if slow else "")
        + f"; dac_layout_copies {copies} {'ok' if ok else 'FAIL'}")
    return {"ok": ok, "device_s": per_span, "slow_launches": len(slow),
            "dac_layout_copies": copies}


def dac_phase(card: str) -> dict:
    """The DAC codec on the card.  Each shipped codec (the node's
    ``build_dac``, weights asserted shipped) on 10 s of seeded speech-like
    stereo at its rate: encode and decode timed as RTF on the card; card
    against the CPU (both bf16): latents relative L2 and the share of
    codes that agree (reported), decode of the CPU's latents (limit), the
    roundtrip SNR against the CPU's (limit).  The published 44 kHz
    geometry (76.6M parameters, seeded ``dac_44khz.npz`` in a temporary
    ``EGREGORA_TPU_WEIGHTS``) through the encode and decode nodes, which
    must resolve it as converted, on 30 s of stereo: RTF and peak memory;
    one encode and decode of 60 s of stereo traced (``dac_conv_trace``:
    every conv's kernels logged, none of cuDNN's legacy NCW conv or its
    layout transposes, no layout copy);
    a 2 s piece in bf16 on the card against float32 on the CPU (latents,
    decode of the CPU's latents), beside the transposed convs' kernels
    left unflipped; the published 24 kHz geometry likewise on its
    encoder, beside its stride-5 'SAME' pads reversed to (3, 2)."""
    import copy
    import dataclasses
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.models.dac import train as dtr
    from egregora_tpu_torch.models.flashsr import layers
    from egregora_tpu_torch.nodes import enhance_extras as ee
    from egregora_tpu_torch.nodes.base import DeviceNode
    from egregora_tpu_torch.utils.weights import _flatten, save_params

    from egregora_tpu_torch.ops import snake as sn

    reset_counts()
    failures, results = [], {}
    enc_cls, dec_cls = ee.Egregora_DAC_Encode, ee.Egregora_DAC_Decode
    card_snakes = [0]            # Snake modules called on a CUDA tensor

    def on_card(module, args):
        if isinstance(module, M.Snake) and args[0].is_cuda:
            card_snakes[0] += 1

    hook = torch.nn.modules.module.register_module_forward_pre_hook(on_card)
    DeviceNode.DEVICE = "cuda"
    for mt in ("16khz", "24khz", "44khz"):
        M._CACHE.pop(mt, None)
        enc_cls._MODELS.pop(mt, None)
        model, sr = enc_cls._model(mt)
        cpu = copy.deepcopy(model).to("cpu")
        model.to("cuda")
        x = speech_signal(DAC_SECONDS, sr, 2, seed=61)
        xt = torch.from_numpy(x)
        model.encode(xt)
        (zq_c, codes_c), enc_wall = synced_wall(lambda: model.encode(xt))
        zq_h, codes_h = cpu.encode(xt)
        model.decode(zq_h)
        y_c, dec_wall = synced_wall(lambda: model.decode(zq_h))
        y_h = cpu.decode(zq_h)
        snr_c, snr_h = dtr.roundtrip_snr_db(model, x), dtr.roundtrip_snr_db(cpu, x)
        r = {"encode_wall_s": enc_wall, "encode_rtf": DAC_SECONDS / enc_wall,
             "decode_wall_s": dec_wall, "decode_rtf": DAC_SECONDS / dec_wall,
             "latent_rel_l2": dac_rel(zq_c, zq_h),
             "codes_agree": float((codes_c.cpu() == codes_h).float().mean()),
             "decode_rel_l2": dac_rel(y_c, y_h), "snr_db": snr_c, "cpu_snr_db": snr_h}
        ok = (model.weight_source == "shipped" and r["decode_rel_l2"] <= DAC_DECODE_REL
              and abs(snr_c - snr_h) <= DAC_SNR_DB and bool(torch.isfinite(y_c).all()))
        results[f"shipped {mt}"] = r
        log(f"dac {mt} (shipped, {model.weight_source}), 10 s stereo, {card}: encode "
            f"{enc_wall:.4f} s (RTF {r['encode_rtf']:.1f}x), decode {dec_wall:.4f} s (RTF "
            f"{r['decode_rtf']:.1f}x); card vs CPU: latents rel L2 {r['latent_rel_l2']:.3e}, codes "
            f"agree {r['codes_agree']:.3f}, decode of the CPU's latents rel L2 "
            f"{r['decode_rel_l2']:.3e} (limit {DAC_DECODE_REL:g}), roundtrip SNR {snr_c:.3f} dB "
            f"(CPU {snr_h:.3f}, limit ±{DAC_SNR_DB:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"dac {mt}: {model.weight_source}, {r}")
        M._CACHE.pop(mt, None)
        enc_cls._MODELS.pop(mt, None)

    tmp = Path(tempfile.mkdtemp(prefix="dac_weights_"))
    env = os.environ.get("EGREGORA_TPU_WEIGHTS")
    os.environ["EGREGORA_TPU_WEIGHTS"] = str(tmp)
    try:
        cfg = M.MODEL_TYPES["44khz"]
        tree = seeded_dac_tree(cfg, seed=71)
        n_params = sum(v.size for v in _flatten(tree).values())
        save_params(tree, tmp / "dac_44khz.npz")
        x30 = speech_signal(DAC_PUB_SECONDS, 44100, 2, seed=72)
        audio = {"waveform": torch.from_numpy(x30[None]), "sample_rate": 44100}
        (codes, _), cold = synced_wall(lambda: enc_cls().execute(audio, model_type="44khz"))
        model = enc_cls._MODELS["44khz"][0]
        dec_cls().execute(codes)
        torch.cuda.reset_peak_memory_stats()
        (codes, enc_log), enc_wall = synced_wall(lambda: enc_cls().execute(audio, model_type="44khz"))
        enc_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (out, dec_log), dec_wall = synced_wall(lambda: dec_cls().execute(codes))
        dec_peak = torch.cuda.max_memory_allocated()
        y = out["waveform"].numpy()
        r = {"parameters": n_params, "weight_source": model.weight_source, "cold_encode_s": cold,
             "encode_wall_s": enc_wall, "encode_rtf": DAC_PUB_SECONDS / enc_wall,
             "encode_peak_bytes": enc_peak, "decode_wall_s": dec_wall,
             "decode_rtf": DAC_PUB_SECONDS / dec_wall, "decode_peak_bytes": dec_peak}
        ok = (model.weight_source == "converted" and n_params == 76_620_777
              and y.shape[:2] == (1, 2) and y.shape[2] >= x30.shape[1]
              and bool(np.isfinite(y).all()) and out["sample_rate"] == 44100)
        log(f"dac 44khz published geometry ({n_params} parameters, {model.weight_source} from "
            f"$EGREGORA_TPU_WEIGHTS/dac_44khz.npz), 30 s stereo through the nodes, {card}: "
            f"encode {enc_wall:.3f} s (RTF {r['encode_rtf']:.1f}x, peak "
            f"{enc_peak / 2 ** 30:.2f} GiB; cold {cold:.2f} s), decode {dec_wall:.3f} s (RTF "
            f"{r['decode_rtf']:.1f}x, peak {dec_peak / 2 ** 30:.2f} GiB), out {y.shape} "
            f"{'ok' if ok else 'FAIL'}; {enc_log}; {dec_log}")
        if not ok:
            failures.append(f"dac published 44khz through the nodes: {r}, out {y.shape}")
        r["trace"] = dac_conv_trace(model, card)
        if not r["trace"]["ok"]:
            failures.append(f"dac published 44khz conv trace: {r['trace']}")

        def latents(m, x):
            """Pre-quantisation latents of ``m`` on its device."""
            with torch.no_grad():
                return m.encoder(m.preprocess(x.to(m.device))[:, None])

        f32 = M.DACModel(dataclasses.replace(cfg, dtype=torch.float32)).load_jax(tree)
        xp = torch.from_numpy(np.ascontiguousarray(x30[:, :int(44100 * DAC_PIECE_SECONDS)]))
        z_c, z_h = latents(model, xp), latents(f32, xp)
        zq_h, _ = f32.rvq(z_h.transpose(1, 2))
        y_h = f32.decode(zq_h)
        lat, dec = dac_rel(z_c, z_h), dac_rel(model.decode(zq_h), y_h)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, layers.ConvTranspose1d):
                    m.weight.copy_(m.weight.flip(2))
            bad = dac_rel(model.decode(zq_h), y_h)
            for m in model.modules():
                if isinstance(m, layers.ConvTranspose1d):
                    m.weight.copy_(m.weight.flip(2))
        r.update(piece_latent_rel_l2=lat, piece_decode_rel_l2=dec, planted_unflipped_decode=bad)
        ok = lat <= DAC_PUB_LATENT_REL and dec <= DAC_PUB_DECODE_REL and bad > DAC_PUB_DECODE_REL
        log(f"dac 44khz published geometry, 2 s piece, bf16 on the card vs float32 on the CPU "
            f"({card}): latents rel L2 {lat:.3e} (limit {DAC_PUB_LATENT_REL:g}), decode of the "
            f"CPU's latents {dec:.3e} (limit {DAC_PUB_DECODE_REL:g}); planted fault (transposed "
            f"convs unflipped): decode {bad:.3e} {'rejected' if bad > DAC_PUB_DECODE_REL else 'NOT REJECTED'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"dac published 44khz piece: latents {lat}, decode {dec}, fault {bad}")
        results["published 44khz"] = r
        del f32, model, codes, out
        M._CACHE.pop("44khz", None)
        enc_cls._MODELS.pop("44khz", None)

        cfg24 = M.MODEL_TYPES["24khz"]
        tree24 = seeded_dac_tree(cfg24, seed=73)
        m24 = M.DACModel(cfg24).load_jax(tree24).cuda()
        f24 = M.DACModel(dataclasses.replace(cfg24, dtype=torch.float32)).load_jax(tree24)
        x24 = torch.from_numpy(speech_signal(DAC_PIECE_SECONDS, 24000, 2, seed=74))
        z_h24 = latents(f24, x24)
        lat24 = dac_rel(latents(m24, x24), z_h24)
        real_pads = layers.same_pads

        def reversed_at_5(size, k, stride=1, dilation=1):
            lo, hi = real_pads(size, k, stride, dilation)
            return (hi, lo) if stride == 5 else (lo, hi)

        layers.same_pads = reversed_at_5
        try:
            bad24 = dac_rel(latents(m24, x24), z_h24)
        finally:
            layers.same_pads = real_pads
        ok = lat24 <= DAC_PUB_LATENT_REL and bad24 > DAC_PUB_LATENT_REL
        results["published 24khz"] = {"piece_latent_rel_l2": lat24,
                                      "planted_pads_reversed_latent": bad24}
        log(f"dac 24khz published geometry, 2 s piece, bf16 on the card vs float32 on the CPU "
            f"({card}): latents rel L2 {lat24:.3e} (limit {DAC_PUB_LATENT_REL:g}); planted fault "
            f"(stride-5 'SAME' pads as (3, 2)): {bad24:.3e} "
            f"{'rejected' if bad24 > DAC_PUB_LATENT_REL else 'NOT REJECTED'} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"dac published 24khz piece: latents {lat24}, fault {bad24}")
    finally:
        if env is None:
            os.environ.pop("EGREGORA_TPU_WEIGHTS", None)
        else:
            os.environ["EGREGORA_TPU_WEIGHTS"] = env
        M._CACHE.pop("44khz", None)
        enc_cls._MODELS.pop("44khz", None)
        shutil.rmtree(tmp, ignore_errors=True)
    hook.remove()
    no_launches("dac")
    results["snake_launches"] = sn.launches
    log(f"dac: {sn.launches} Snake kernel launches for {card_snakes[0]} Snakes run on the card")
    if not card_snakes[0] or sn.launches != card_snakes[0]:
        failures.append(f"dac: {sn.launches} Snake launches for {card_snakes[0]} Snakes on the card")
    if failures:
        raise RuntimeError("; ".join(failures))
    return results


# ---- phase 19: the entry points (CLI, workflow executor, IO, profiler) ----

WAV_STEP = 1.0 / 32768.0     # one PCM16 step of a WAV written and read back
EVEN_SECONDS = 8.0           # 16 kHz input that makes 2 chunks (an even batch)
ENTRY_PAIR_SECONDS = 60.0    # the eval subcommands' pair: 60 s of 48 kHz stereo
ENTRY_ITERATIONS = 50        # Fat Llama iterations of `enhance` and the workflow
DENSE_PACKED_LIMIT = 5e-2    # dense / packed / chunked attention against the kernel path
# the HiFi-GAN trio's MRF paths through the CLI, on the 12 s input (3
# chunks): label, EGREGORA_MRF_PATH, MRF launches at batch 1 (those of
# NODE_PATHS; packed at this odd batch runs mrf_fused_cm, dense none)
ENTRY_MRF_PATHS = [("pallas", "pallas", NODE_PATHS[0][3]), ("rows", "rows", NODE_PATHS[1][3]),
                   ("dense", "dense", {}), ("packed", "packed", NODE_PATHS[0][3])]


def run_cli(argv: list) -> tuple:
    """``egregora_tpu_torch.cli.main(argv)`` in this process: (wall s, the
    printed lines, the last printed JSON object or None); the card is
    synchronised before the clock stops."""
    import contextlib
    import io

    import torch

    from egregora_tpu_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    lines = buf.getvalue().splitlines()
    if rc != 0:
        raise RuntimeError(f"cli {argv}: exit code {rc}: {lines}")
    obj = next((json.loads(ln) for ln in reversed(lines) if ln.startswith("{")), None)
    return wall, lines, obj


def read_wav(path):
    from egregora_tpu_torch.utils.wavio import read_audio
    return read_audio(path)


def json_agreement(label: str, got: dict, ref: dict, rel: float = 1e-4) -> float:
    """Largest |d| / max(1, |ref|) over the keys; raises where the keys
    differ or any exceeds ``rel``."""
    if set(got) != set(ref):
        raise RuntimeError(f"{label}: keys {sorted(got)} against {sorted(ref)}")
    worst = max(abs(float(got[k]) - float(ref[k])) / max(1.0, abs(float(ref[k]))) for k in ref)
    if not worst <= rel:
        raise RuntimeError(f"{label}: {got} against {ref} (worst {worst:.3e}, limit {rel:g})")
    return worst


def seeded_converted_dir(root, seed: int = 7):
    """``root/flashsr`` holding the published geometry's seeded weights as
    the resolver's cache (``flashsr_params.npz``) and geometry sidecar,
    the JAX package's format, as a user's ``--ckpt-dir`` would."""
    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.utils import weights

    cfg = published_cfg()
    mods = legacy_init(P.FlashSRModules(cfg), seed)
    d = root / "flashsr"
    d.mkdir(parents=True, exist_ok=True)
    weights.save_params({name: weights.flax_tree(m, values=True)
                         for name, m in mods.by_name().items()}, d / distill.CACHE)
    (d / distill.SIDECAR).write_text(distill._cfg_to_json(cfg))
    return cfg


def trace_kernel_names(logdir) -> list:
    """Names of the card kernels in the Chrome trace ``utils.profiling.trace``
    wrote into ``logdir``."""
    from pathlib import Path
    files = sorted(Path(logdir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise RuntimeError(f"profiler trace: expected one *.pt.trace.json in {logdir}, "
                           f"found {[f.name for f in files]}")
    events = json.loads(files[0].read_text()).get("traceEvents", [])
    return [ev.get("name", "") for ev in events if ev.get("cat") == "kernel"]


def entry_phase(card: str) -> dict:
    """The standalone entry points on the card, with ``EGREGORA_TPU_OFFLINE``
    set: the CLI in this process on seeded WAVs in a temporary directory
    (``flashsr`` on the istft trio, on the HiFi-GAN trio with the fused
    vocoder on each MRF path, at an even batch on the packed path, and on
    the published geometry from a seeded ``--ckpt-dir``; ``enhance``,
    ``eval``, ``nulltest``, ``loudness``, ``codec`` at 16 kHz), each output
    held to the same node called directly on the card (within one PCM16
    step, or the node limits above), each call's kernel launches counted;
    ``mha`` under ``EGREGORA_ATTN_PATH=chunked``; the example workflow
    through the executor against the direct node chain; one ``flashsr``
    under ``utils.profiling.trace``, whose trace must name the attn_rows
    kernel; each subcommand's warm wall time."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    import egregora_tpu_torch
    from egregora_tpu_torch.nodes import super_resolution
    from egregora_tpu_torch.nodes.base import comfy_audio
    from egregora_tpu_torch.pipeline.executor import WorkflowExecutor
    from egregora_tpu_torch.pipeline.run_workflow import EXAMPLE
    from egregora_tpu_torch.utils import profiling
    from egregora_tpu_torch.utils.wavio import write_audio

    reg = egregora_tpu_torch.NODE_CLASS_MAPPINGS
    up = super_resolution.EgregoraAudioSuperResolution
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_entry_"))
    sr_in = 16000
    wav12, wav8 = tmp / "in12.wav", tmp / "in8.wav"
    write_audio(wav12, test_signal(SECONDS, sr_in, seed=0), sr_in)
    write_audio(wav8, test_signal(EVEN_SECONDS, sr_in, seed=4), sr_in)
    pair_a = eval_signal(ENTRY_PAIR_SECONDS, seed=21)
    wav_a, wav_b = tmp / "a.wav", tmp / "b.wav"
    write_audio(wav_a, pair_a, EVAL_SR)
    write_audio(wav_b, frac_delayed(pair_a, PLANTED_DELAY, PLANTED_GAIN_DB), EVAL_SR)
    res = {"walls": {}, "paths": {}, "counts": {}}

    def cli_call(label: str, argv: list, cold: bool = False):
        """One CLI call counted from 0 (after a cold call when asked)."""
        if cold:
            run_cli(argv)
        reset_counts()
        wall, lines, obj = run_cli(argv)
        counts = read_counts()
        res["walls"][label] = wall
        res["counts"][label] = counts
        log(f"entry cli {label}: {wall:.3f} s wall{' (warm)' if cold else ''}, "
            f"launches {counts}; {' | '.join(ln for ln in lines if not ln.startswith('{'))}")
        return counts, obj

    def node_wave(audio_path, sr):
        """The upscaler node called directly on the card on the WAV's audio."""
        cs, _ = read_wav(audio_path)
        up._PIPE = None
        (out,) = up().run({"waveform": torch.from_numpy(cs[None]), "sample_rate": sr},
                          False, "48000")
        return out["waveform"][0].numpy()

    def held(label: str, got, ref, abs_limit: float = WAV_STEP, rel_limit=None) -> dict:
        """The CLI's WAV against a reference array: max |d| within
        ``abs_limit`` (one PCM16 step for the same node on the same path),
        or, given ``rel_limit``, relative L2 within it (another path)."""
        got = np.asarray(got, np.float32)
        ref = np.asarray(ref, np.float32)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError(f"entry {label}: output {got.shape} against {ref.shape}, "
                               f"finite {bool(np.isfinite(got).all())}")
        d = float(np.abs(got - ref).max())
        rel = rel_l2(torch.from_numpy(got), torch.from_numpy(ref))
        ok = d <= abs_limit if rel_limit is None else rel <= rel_limit
        limit = f"max|d| {abs_limit:.3e}" if rel_limit is None else f"relative L2 {rel_limit:g}"
        log(f"entry {label}: max|d| {d:.3e} ({d / WAV_STEP:.2f} PCM16 steps), relative L2 "
            f"{rel:.3e} (limit {limit}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"entry {label}: the CLI's output disagrees ({d}, {rel})")
        return {"max_abs_err": d, "rel_l2": rel}

    def expect(label: str, got: dict, want: dict) -> None:
        if got != want:
            raise RuntimeError(f"entry {label}: launches {got}, expected {want}")

    try:
        set_env(EGREGORA_TPU_WEIGHTS=str(tmp / "no_weights"), EGREGORA_FLASHSR_VARIANT=None,
                EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None, EGREGORA_ATTN_PATH=None)
        # flashsr, istft trio (the default)
        out = str(tmp / "sr_istft.wav")
        counts, _ = cli_call("flashsr istft", ["flashsr", "--in", str(wav12), "--out", out],
                             cold=True)
        expect("flashsr istft", counts, expected_counts({}, BATCH, 1))
        istft = read_wav(out)[0]
        res["paths"]["flashsr istft"] = held("flashsr istft vs the node", istft,
                                             node_wave(wav12, sr_in))
        # where a warm flashsr call goes: weights resolved, pipeline built, the file processed
        from egregora_tpu_torch.cli import _load
        from egregora_tpu_torch.models.flashsr.distill import resolve_flashsr
        from egregora_tpu_torch.models.flashsr.pipeline import FlashSRPipeline
        t0 = time.perf_counter()
        buf = _load(str(wav12))
        t1 = time.perf_counter()
        cfg_i, params_i, _ = resolve_flashsr()
        t2 = time.perf_counter()
        pipe = FlashSRPipeline(cfg_i, params=params_i, device="cuda")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pipe.process(buf).numpy()
        t4 = time.perf_counter()
        res["flashsr_breakdown_s"] = {"read": t1 - t0, "resolve": t2 - t1, "build": t3 - t2,
                                      "process": t4 - t3}
        log(f"entry flashsr istft, warm, by step: {json.dumps(res['flashsr_breakdown_s'])}")
        del pipe
        # the same under EGREGORA_ATTN_PATH=chunked: no attn_rows, near the kernel path
        set_env(EGREGORA_ATTN_PATH="chunked")
        counts, _ = cli_call("flashsr istft, attention chunked",
                             ["flashsr", "--in", str(wav12), "--out", str(tmp / "sr_chunked.wav")])
        set_env(EGREGORA_ATTN_PATH=None)
        expect("flashsr istft, attention chunked", counts, expected_counts({}, BATCH, 1)
               | {"attn_rows": {}})
        res["paths"]["attention chunked"] = held(
            "flashsr istft, attention chunked vs the kernel path",
            read_wav(tmp / "sr_chunked.wav")[0], istft, rel_limit=DENSE_PACKED_LIMIT)
        # flashsr under the profiler: the trace must name the attn_rows kernel
        logdir = tmp / "trace"
        with profiling.trace(str(logdir)):
            run_cli(["flashsr", "--in", str(wav12), "--out", str(tmp / "sr_traced.wav")])
        names = trace_kernel_names(logdir)
        rows_k = [n for n in names if "RowsNumerics" in n]
        log(f"entry profiler trace: {len(names)} kernel events, {len(rows_k)} of the attn_rows "
            f"kernel ({rows_k[0] if rows_k else 'none'})")
        if not rows_k:
            raise RuntimeError("entry: the profiler trace names no attn_rows kernel "
                               f"(kernel events: {sorted(set(names))[:10]})")
        res["trace"] = {"kernel_events": len(names), "attn_rows_events": len(rows_k)}

        # flashsr, HiFi-GAN trio with the fused vocoder on each MRF path
        set_env(EGREGORA_FLASHSR_VARIANT="hifigan", EGREGORA_FUSED_VOCODER="1")
        waves = {}
        for i, (label, path, per_item) in enumerate(ENTRY_MRF_PATHS):
            set_env(EGREGORA_MRF_PATH=path)
            out = str(tmp / f"sr_{label}.wav")
            counts, _ = cli_call(f"flashsr hifigan {label}",
                                 ["flashsr", "--in", str(wav12), "--out", out], cold=i == 0)
            expect(f"flashsr hifigan {label}", counts, expected_counts(per_item, BATCH, 1))
            waves[label] = read_wav(out)[0]
            res["paths"][f"flashsr hifigan {label}"] = held(
                f"flashsr hifigan {label} vs the node", waves[label], node_wave(wav12, sr_in))
            if label in ("dense", "packed"):
                res["paths"][f"flashsr hifigan {label}"]["vs_pallas_rel_l2"] = held(
                    f"flashsr hifigan {label} vs pallas", waves[label], waves["pallas"],
                    rel_limit=DENSE_PACKED_LIMIT)["rel_l2"]
        # packed at an even batch (8 s: 2 chunks) launches no MRF kernel
        set_env(EGREGORA_MRF_PATH="packed")
        counts, _ = cli_call("flashsr hifigan packed, even batch",
                             ["flashsr", "--in", str(wav8), "--out", str(tmp / "sr_even.wav")])
        expect("flashsr hifigan packed, even batch", counts, expected_counts({}, 2, 1))
        res["paths"]["flashsr hifigan packed, even batch"] = held(
            "flashsr hifigan packed, even batch vs the node", read_wav(tmp / "sr_even.wav")[0],
            node_wave(wav8, sr_in))
        set_env(EGREGORA_MRF_PATH="pallas")
        res["paths"]["flashsr hifigan packed, even batch"]["vs_pallas_rel_l2"] = held(
            "flashsr hifigan packed, even batch vs pallas", read_wav(tmp / "sr_even.wav")[0],
            node_wave(wav8, sr_in), rel_limit=DENSE_PACKED_LIMIT)["rel_l2"]
        set_env(EGREGORA_FLASHSR_VARIANT=None, EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)

        # flashsr, the published geometry from a seeded --ckpt-dir
        ckpt = tmp / "ckpt"
        t = time.perf_counter()
        cfg = seeded_converted_dir(ckpt)
        log(f"entry: seeded published-geometry --ckpt-dir written in "
            f"{time.perf_counter() - t:.1f} s")
        out = str(tmp / "sr_published.wav")
        counts, _ = cli_call("flashsr published", ["flashsr", "--ckpt-dir", str(ckpt), "--in",
                                                   str(wav12), "--out", out], cold=True)
        expect("flashsr published", counts, converted_counts({}, BATCH, 1))
        ref = node_wave(wav12, sr_in)
        if up._PIPE.weight_source != "converted" or up._PIPE.cfg != cfg:
            raise RuntimeError("entry: the node did not resolve the seeded --ckpt-dir")
        res["paths"]["flashsr published"] = held("flashsr published vs the node",
                                                 read_wav(out)[0], ref)
        set_env(EGREGORA_TPU_WEIGHTS=str(tmp / "no_weights"))
        up._PIPE = None

        # enhance: against the Fat Llama GPU node
        out = str(tmp / "enh.wav")
        counts, _ = cli_call("enhance", ["enhance", "--in", str(wav12), "--out", out,
                                         "--iterations", str(ENTRY_ITERATIONS)], cold=True)
        cs, _ = read_wav(wav12)
        (fl,) = reg["EgregoraFatLlamaGPU"]().run("wav", ENTRY_ITERATIONS, 0.6, 1411, True, True,
                                                 AUDIO=comfy_audio(sr_in, cs))
        got, sr = read_wav(out)
        if sr != fl["sample_rate"]:
            raise RuntimeError(f"entry enhance: {sr} Hz against the node's {fl['sample_rate']}")
        res["paths"]["enhance"] = held("enhance vs the Fat Llama GPU node", got, fl["samples"],
                                       WAV_STEP + 1e-4)

        # eval, nulltest, loudness: printed JSON against the nodes' on the same files
        a, sr_a = read_wav(wav_a)
        b, _ = read_wav(wav_b)
        _, rep = cli_call("eval", ["eval", "--ref", str(wav_a), "--proc", str(wav_b)], cold=True)
        (m,) = reg["Metrics (LSD + SI-SDR)"]().execute(comfy_audio(sr_a, a), comfy_audio(sr_a, b))
        res["paths"]["eval"] = {"worst_rel": json_agreement("eval", rep, m), "report": rep}
        counts, rep = cli_call("nulltest", ["nulltest", "--ref", str(wav_a), "--proc",
                                            str(wav_b)], cold=True)
        if not sum(counts["iir_lowpass"].values()):
            raise RuntimeError("entry nulltest: K4 (iir_lowpass) was not launched")
        _m, _n, delay_ms, gain_db, metrics, *_ = reg["Null Test (Full)"]().execute(
            comfy_audio(sr_a, a), comfy_audio(sr_a, b), draw_waveforms=False,
            draw_spectrograms=False, draw_diffspec=False)
        node_rep = {**dict(metrics), "delay_ms": delay_ms, "gain_db": gain_db}
        res["paths"]["nulltest"] = {"worst_rel": json_agreement("nulltest", rep, node_rep),
                                    "report": rep}
        counts, rep = cli_call("loudness", ["loudness", "--in", str(wav_a)], cold=True)
        if not sum(counts["iir_lowpass"].values()):
            raise RuntimeError("entry loudness: K4 (iir_lowpass) was not launched")
        (meter,) = reg["Loudness Meter (BS1770)"]().execute(comfy_audio(sr_a, a))
        res["paths"]["loudness"] = {"worst_rel": json_agreement("loudness", rep, meter),
                                    "report": rep}
        log("entry eval / nulltest / loudness: printed JSON equals the nodes' within 1e-4 "
            "relative: " + json.dumps({k: res["paths"][k]["worst_rel"]
                                        for k in ("eval", "nulltest", "loudness")}))

        # codec at 16 kHz: against the DAC encode and decode nodes
        out = str(tmp / "codec.wav")
        counts, rep = cli_call("codec 16khz", ["codec", "--in", str(wav12), "--out", out,
                                               "--model-type", "16khz"], cold=True)
        if any(sum(c.values()) for c in counts.values()):
            raise RuntimeError(f"entry codec: the DAC path launched a kernel: {counts}")
        codes, _ = reg["Egregora_DAC_Encode"]().execute(comfy_audio(sr_in, cs), "16khz")
        (dec, _) = reg["Egregora_DAC_Decode"]().execute(codes)
        got = read_wav(out)[0]
        res["paths"]["codec 16khz"] = held("codec 16khz vs the DAC nodes", got,
                                           dec["samples"][:, : got.shape[-1]], rel_limit=2e-2)
        res["paths"]["codec 16khz"]["report"] = rep

        # the example workflow through the executor against the direct node chain
        ex = WorkflowExecutor(timer=profiling.NodeTimer())
        ex.run(EXAMPLE, overrides={"1": {"path": str(wav12)},
                                   "4": {"max_iterations": ENTRY_ITERATIONS}})
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        results = ex.run(EXAMPLE, overrides={"1": {"path": str(wav12)},
                                             "4": {"max_iterations": ENTRY_ITERATIONS}})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        expect("workflow", counts, expected_counts({}, BATCH, 1))
        (up_out,) = up().run(comfy_audio(sr_in, cs), False, "48000")
        (chain,) = reg["EgregoraFatLlamaGPU"]().run("wav", ENTRY_ITERATIONS, 0.6, 1411, True,
                                                    True, AUDIO=up_out)
        wf_out = np.asarray(results["4"][0]["samples"])
        d = float(np.abs(wf_out - chain["samples"]).max()) if wf_out.shape == \
            chain["samples"].shape else float("inf")
        summary = ex.timing_summary()
        log(f"entry workflow (example, max_iterations {ENTRY_ITERATIONS}): {wall:.3f} s wall "
            f"warm, out {wf_out.shape} @ {results['4'][0]['sample_rate']} Hz, vs the direct "
            f"node chain max|d| {d:.3e}; launches {counts}; timing_summary "
            f"{json.dumps(summary)}")
        if d != 0.0:
            raise RuntimeError(f"entry workflow: the executor's output differs from the "
                               f"direct node chain by {d}")
        res["walls"]["workflow"] = wall
        res["counts"]["workflow"] = counts
        res["workflow"] = {"timing_summary": summary, "max_abs_err": d}
    finally:
        set_env(EGREGORA_TPU_WEIGHTS=None, EGREGORA_FLASHSR_VARIANT=None,
                EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None, EGREGORA_ATTN_PATH=None)
        up._PIPE = None
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"entry warm wall times on {card}: " + "; ".join(
        f"{k} {v:.3f} s" for k, v in res["walls"].items()))
    return res


def entry_launches(entry: dict, kernel: str) -> tuple:
    """(launches by shape, launches by path) of ``kernel`` over the entry
    phase's counted calls."""
    total, by_path = collections.Counter(), {}
    for label, counts in entry["counts"].items():
        n = sum(counts[kernel].values())
        if n:
            total.update(counts[kernel])
            by_path[f"entry: {label}"] = n
    return total, by_path


# ---- the bootstrap (egregora_tpu_torch.install) and the full-chain example ----

BOOTSTRAP_TIMEOUT = 600.0    # seconds: a cold bootstrap builds every source first
WARMUPS = ("loudness", "spectral enhance", "rnnoise", "deepfilternet", "dac")
# planted faults of the bootstrap, each run as a user would meet it: (label,
# code run before install.main, environment, what the output must name)
BOOTSTRAP_FAULTS = [
    ("a source that does not exist",
     "cuda_build.SOURCES = cuda_build.SOURCES + ('no_such_kernel',)", {},
     "no CUDA source 'no_such_kernel'"),
    ("nvcc unreachable (CUDA_HOME, PATH and the default path broken)",
     "cuda_build.NVCC_DEFAULT = '/nonexistent/bin/nvcc'", {"CUDA_HOME": "/nonexistent"},
     "[deps] nvcc: MISSING"),
    ("no card visible", "", {"CUDA_VISIBLE_DEVICES": ""}, "No CUDA device detected"),
]
BOOTSTRAP_FAULT_CODE = """import sys
from egregora_tpu_torch import install
from egregora_tpu_torch.utils import cuda_build
{patch}
sys.exit(install.main(['--offline']))
"""
# the example on 6 s of 16 kHz stereo, card against the same function on the
# CPU: the 96 kHz output's relative L2 (the node paths' limit: FlashSR runs
# bf16 on the card), and the printed metrics: loudness keys (LU / dB) at what
# that wave limit allows (20 log10(1.05) = 0.42 dB), the true peak (a maximum,
# not an energy) 1 dB, SI-SDR 0.25 dB, LSD 2 dB (~95 dB here: the output's high
# band over the input's empty one; the JAX example and the port read 0.4-0.6 dB
# apart on the CPU).  The first run read 2.1e-3, loudness 0.001, true peak 0.006,
# SI-SDR 0.003 and LSD 0.39-0.41
EXAMPLE_CHECK_SECONDS, EXAMPLE_WAVE_REL = 6.0, 5e-2
EXAMPLE_KEY_LIMITS = {"lufs_integrated": 0.45, "lufs_momentary": 0.45, "lufs_short_term": 0.45,
                      "lra": 0.45, "true_peak_dbfs": 1.0, "si_sdr_db": 0.25,
                      "lsd_mean_db": 2.0, "lsd_p95_db": 2.0}
EXAMPLE_KEYS = tuple(EXAMPLE_KEY_LIMITS) + ("wall_s", "realtime_factor")


def bootstrap_env(**extra) -> dict:
    """The environment of a bootstrap subprocess: this one's, offline, the
    checkout importable, plus ``extra``."""
    import os
    env = dict(os.environ, EGREGORA_TPU_OFFLINE="1", **extra)
    here = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = os.pathsep.join([here] + [p for p in (env.get("PYTHONPATH"),) if p])
    return env


def run_bootstrap(argv: list, env: dict) -> tuple:
    """(exit code, standard output, standard error, wall s) of a
    subprocess from the checkout's root."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable] + argv, cwd=Path(__file__).resolve().parent, env=env,
                       capture_output=True, text=True, timeout=BOOTSTRAP_TIMEOUT)
    return r.returncode, r.stdout, r.stderr, time.perf_counter() - t


def shipped_weight_rows() -> dict:
    """The bootstrap's ``[weights] shipped ...`` rows as the files on disk
    give them (the shipped files; no trained file is served here)."""
    from egregora_tpu_torch.models.dac import train as dac_train
    from egregora_tpu_torch.models.deepfilternet import train as dfn_train
    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.rnnoise import train as rn_train
    files = {"FlashSR distilled trio": distill.PRETRAINED, "RNNoise": rn_train.pretrained_path(),
             "DeepFilterNet2": dfn_train.pretrained_path("DeepFilterNet2"),
             "DeepFilterNet3": dfn_train.pretrained_path("DeepFilterNet3")}
    files.update({f"DAC {t}": p for t, p in sorted(dac_train.PRETRAINED.items())})
    return {name: f"[weights] shipped {name}: {'present' if p.exists() else 'MISSING'}"
            for name, p in files.items()}


def bootstrap_phase(card: str) -> dict:
    """``python -m egregora_tpu_torch.install --offline`` in a subprocess
    after the build step (so warm: every library loads at once), in a
    temporary weights root: exit 0, the card line and capability (9, 0),
    every source's library in ``_build/``, the weight rows equal to the
    files on disk, every warmup "ok", ``[install] done`` last.  Then the
    planted faults (``BOOTSTRAP_FAULTS``), each of which must exit non-zero,
    name its cause and never print ``[install] done`` or a warmup line.
    Last, the warmups in this process on the card, their kernel launches
    counted (K4 in the loudness meter)."""
    import os

    import torch

    from egregora_tpu_torch import install
    from egregora_tpu_torch.utils import cuda_build
    tmp = tempfile.mkdtemp(prefix="egregora_bootstrap_")
    try:
        rc, out, err, wall = run_bootstrap(["-m", "egregora_tpu_torch.install", "--offline"],
                                           bootstrap_env(EGREGORA_TPU_WEIGHTS=tmp))
        faults = []
        for label, patch, extra, cause in BOOTSTRAP_FAULTS:
            env = bootstrap_env(EGREGORA_TPU_WEIGHTS=tmp, **extra)
            if "CUDA_HOME" in extra:       # no directory with an nvcc left on PATH
                env["PATH"] = os.pathsep.join(
                    d for d in env.get("PATH", "").split(os.pathsep)
                    if not os.path.exists(os.path.join(d, "nvcc")))
            f_rc, f_out, f_err, f_wall = run_bootstrap(
                ["-c", BOOTSTRAP_FAULT_CODE.format(patch=patch)], env)
            text = f_out + f_err
            faults.append({"fault": label, "rc": f_rc, "wall_s": f_wall,
                           "names_cause": cause in text,
                           "done_printed": "[install] done" in f_out,
                           "warmed": "[warmup]" in f_out,
                           "last": (f_out.strip().splitlines() or [""])[-1]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = out.splitlines()
    rows = shipped_weight_rows()
    built = {n: cuda_build.library_path(n).exists() for n in cuda_build.SOURCES}
    problems = [what for what, bad in (
        (f"exit code {rc}", rc != 0),
        ("no card line", f"[deps] card: {card}" not in lines),
        ("capability not (9, 0)", "[deps] compute capability: (9, 0) (sm_90a)" not in lines),
        (f"libraries missing: {[n for n, b in built.items() if not b]}", not all(built.values())),
        (f"weight rows differ from the files: {rows}",
         any(r not in lines for r in rows.values()) or any("MISSING" in r for r in rows.values())),
        ("a warmup not ok", any(f"[warmup] {w}: ok" not in lines for w in WARMUPS)),
        ("no [install] done last", not lines or lines[-1] != "[install] done")) if bad]
    for f in faults:
        if f["rc"] == 0 or not f["names_cause"] or f["done_printed"] or f["warmed"]:
            problems.append(f"planted fault not caught: {f}")
    native = [ln for ln in lines if ln.startswith("[native] CUDA kernels")]
    log(f"bootstrap (python -m egregora_tpu_torch.install --offline) on {card}: exit {rc} in "
        f"{wall:.1f} s warm (every library built already); {native[0] if native else 'no build line'}; "
        f"capability (9, 0), {len(rows)} shipped weight rows as on disk, warmups "
        f"{', '.join(WARMUPS)} ok; planted faults: " + "; ".join(
            f"{f['fault']}: exit {f['rc']} in {f['wall_s']:.1f} s, "
            f"{'names its cause' if f['names_cause'] else 'DOES NOT NAME ITS CAUSE'}, "
            f"last line {f['last']!r}" for f in faults)
        + (" ok" if not problems else " FAIL"))
    if problems:
        raise RuntimeError(f"bootstrap: {problems}\n{out}\n{err[-4000:]}")
    reset_counts()
    warm_s = synced_wall(lambda: install.warmups(torch.device("cuda")))[1]
    counts = read_counts()
    others = {k: v for k, v in counts.items() if k != "iir_lowpass" and v}
    log(f"bootstrap warmups in this process on {card}: {warm_s:.3f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if counts["iir_lowpass"] != {(1, 4800): 4} or others:
        raise RuntimeError(f"bootstrap warmups: launches {counts} (K4 expected 4 at (1, 4800))")
    return {"wall_s": wall, "faults": faults, "warmups_s": warm_s, "counts": counts}


def example_phase(card: str) -> dict:
    """The full-chain example (``examples.full_chain``) on seeded
    speech-like 16 kHz stereo (a 50 ms lead-in, no gap): on 6 s, the card
    against the same function on the CPU (``EXAMPLE_WAVE_REL``,
    ``EXAMPLE_KEY_LIMITS``); on 120 s (the chain phase's length), cold,
    then warm with each stage timed and its ``attn_rows`` and K4 launches
    counted; then ``main`` through a real WAV round trip (the file's rate,
    length and finiteness)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from egregora_tpu_torch.examples import full_chain as fc
    from egregora_tpu_torch.utils.wavio import read_audio, write_audio

    set_env(EGREGORA_FLASHSR_VARIANT=None, EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None,
            EGREGORA_ATTN_PATH=None)

    def run(x, device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out, metrics, stages = fc.full_chain(x, 16000, device)
        text = buf.getvalue()
        printed = json.loads(text[text.index("{"): text.rindex("}") + 1])
        if tuple(sorted(printed)) != tuple(sorted(EXAMPLE_KEYS)) or printed != metrics:
            raise RuntimeError(f"example: printed {printed}, returned {metrics}")
        return out, metrics, stages, text

    tmp = tempfile.mkdtemp(prefix="egregora_example_")
    try:
        files = {}
        for name, secs, seed in (("short", EXAMPLE_CHECK_SECONDS, 17), ("long", CHAIN_SECONDS, 18)):
            files[name] = str(Path(tmp) / f"{name}.wav")
            write_audio(files[name], speech_signal(secs, 16000, 2, seed, gaps=()), 16000)
        xs, _ = read_audio(files["short"])
        card_out, card_m, _, _ = run(xs, "cuda")
        cpu_out, cpu_m, _, _ = run(xs, "cpu")
        rel = rel_l2(card_out.cpu(), cpu_out)
        diffs = {k: abs(card_m[k] - cpu_m[k]) for k in EXAMPLE_KEY_LIMITS}
        check_ok = (rel <= EXAMPLE_WAVE_REL and card_out.shape == cpu_out.shape
                    and all(diffs[k] <= lim for k, lim in EXAMPLE_KEY_LIMITS.items()))
        log(f"full-chain example, {EXAMPLE_CHECK_SECONDS:.0f} s 16 kHz stereo, card vs CPU: 96 kHz "
            f"output {tuple(card_out.shape)} rel L2 {rel:.3e} (limit {EXAMPLE_WAVE_REL:g}); "
            + ", ".join(f"{k} {card_m[k]:.3f} vs {cpu_m[k]:.3f} (|d| {diffs[k]:.3f}, limit "
                        f"{EXAMPLE_KEY_LIMITS[k]:g})" for k in EXAMPLE_KEY_LIMITS)
            + (" ok" if check_ok else " FAIL"))
        if not check_ok:
            raise RuntimeError(f"example: card vs CPU rel {rel}, metric gaps {diffs}")
        del card_out, cpu_out

        xl, _ = read_audio(files["long"])
        cold = synced_wall(lambda: run(xl, "cuda"))[1]
        reset_counts()
        (out, metrics, stages, text), wall = synced_wall(lambda: run(xl, "cuda"))
        counts = read_counts()
        n96 = int(96000 * CHAIN_SECONDS)
        finite = bool(torch.isfinite(out).all()) and all(math.isfinite(metrics[k])
                                                         for k in EXAMPLE_KEY_LIMITS)
        shape = tuple(out.shape)
        del out
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, main_wall = synced_wall(lambda: fc.main(files["long"], str(Path(tmp) / "out.wav")))
        y, sr = read_audio(str(Path(tmp) / "out.wav"))
        printed = buf.getvalue().splitlines()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    others = {k: v for k, v in counts.items() if k not in ("attn_rows", "iir_lowpass") and v}
    k4_expect = {(2, n96): 4}
    ok = (shape == (2, n96) and finite and counts["attn_rows"] and not others
          and counts["iir_lowpass"] == k4_expect and sr == 96000 and y.shape == (2, n96)
          and bool(np.isfinite(y).all()) and printed[0].startswith("[load] 120.0s @16000 (2 ch)")
          and printed[-1].startswith("[save]"))
    device_line = next((ln for ln in text.splitlines() if ln.startswith("[device]")), "")
    log(f"full-chain example, {CHAIN_SECONDS:.0f} s 16 kHz stereo -> RNNoise (adaptive mix) -> "
        f"FlashSR 48 kHz (max_batch 8) -> Fat Llama 50 -> 96 kHz -> loudness, LSD/SI-SDR on "
        f"{card}: cold {cold:.3f} s, warm {wall:.3f} s (RTF {CHAIN_SECONDS / wall:.1f}x); stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; {device_line}; out {shape}, finite {finite}; metrics {metrics}; launches "
        f"{ {k: v for k, v in counts.items() if v} }; main() through WAVs {main_wall:.3f} s, "
        f"file {y.shape} @ {sr} Hz " + ("ok" if ok else "FAIL"))
    if not ok:
        raise RuntimeError(f"example: out {shape}, finite {finite}, launches {counts} (K4 "
                           f"expected {k4_expect}), file {y.shape} @ {sr}, printed {printed[:2]}")
    return {"check": {"rel_l2": rel, "metric_gaps": diffs}, "cold_s": cold, "warm_s": wall,
            "rtf": CHAIN_SECONDS / wall, "stages": stages, "metrics": metrics,
            "main_wall_s": main_wall, "counts": counts}


# ---- training: the FlashSR trainers, the attention gradient, the mesh ----

TRAIN_BATCH, TRAIN_FRAMES = 8, 128          # distill()'s defaults: 8 x 61 440 samples
FULL_TRAIN_BATCH = 2                        # the full config at hop 480, 256 mels
TRAIN_STEPS = 5                             # steps on one fixed batch (loss must fall)
# one distilled step, bf16 on the card against float32 on the CPU, same weights, data
# and noise (the first TRAIN_CPU_ITEMS items): loss and each sub-model's gradient,
# relative.  The bring-up run on an H100 read 8.8e-4 and 3.1e-2 / 2.7e-2 / 0.137 (the
# HiFi-GAN vocoder's 50-odd bf16 convs; its high band reads 0.18 in inference too)
TRAIN_CPU_ITEMS = 2
TRAIN_LOSS_LIMIT = 5e-3
TRAIN_GRAD_LIMITS = {"vae": 0.1, "student_ldm": 0.1, "sr_vocoder": 0.3}
# the attention Function's gradient (bf16 inputs, float32 sums) against autograd
# through attn_rows_plain in float32, relative L2 of each of dq, dk, dv: read 1.7e-3
# (the bf16 rounding of the outputs); the planted fault >= 3.7e-2 on dq or dk
ATTN_GRAD_LIMIT = 1e-2
# a checkpoint resumed at step k against the run that went on: the weights and
# moments read back exactly; after one more step each parameter within this share
# of the learning rate (Adam moves a parameter by about lr a step; read 0.0)
RESUME_LR_SHARE = 0.5
# the mesh: a sharded process against one device running the same forward batches
# (relative L2; only the stitch's float32 sums can differ; read 0.0), and the
# two-rank float32 train step against the one-process step (loss and gradients,
# relative; read 0.0 and up to 5.5e-4, the vocoder's convs at batch 2 against 4)
MESH_PROCESS_LIMIT = 1e-4
MESH_STEP_LIMIT = 2e-3


def named_grads(mods) -> dict:
    """``{(sub-model, key): grad}`` of every parameter (None where autograd
    left none)."""
    return {(name, key): p.grad for name, m in mods.by_name().items()
            for key, p in m.named_parameters()}


def loss_and_grads(mods, lr_w, hr_w, kn, hop=480, n_mels=256):
    """The distillation loss of one batch and the gradients autograd gives
    (every ``.grad`` cleared first)."""
    from egregora_tpu_torch.models.flashsr import train
    for p in mods.parameters():
        p.grad = None
    loss = train.loss_fn(mods, lr_w, hr_w, kn, hop, n_mels, 2048)
    loss.backward()
    return float(loss.detach()), named_grads(mods)


def grad_holes(grads: dict) -> tuple:
    """(parameters without a gradient, parameters with a non-finite one)."""
    import torch
    missing = [k for k, g in grads.items() if g is None]
    bad = [k for k, g in grads.items() if g is not None and not bool(torch.isfinite(g).all())]
    return missing, bad


def detached_attention():
    """A planted fault: the attention kernel as it was before the autograd
    Function, launched by raw pointer with no ``grad_fn``."""
    from egregora_tpu_torch.ops import attn_rows as ar
    return lambda q, k, v: ar._attn_rows(q, k, v)


def sub_model_rel(a: dict, b: dict) -> dict:
    """Relative L2 of each sub-model's gradients, ``a`` against ``b``."""
    import torch
    out = {}
    for name in ("vae", "student_ldm", "sr_vocoder"):
        keys = [k for k in b if k[0] == name]
        ga = torch.cat([a[k].double().flatten().cpu() for k in keys])
        gb = torch.cat([b[k].double().flatten().cpu() for k in keys])
        out[name] = float((ga - gb).norm() / gb.norm())
    return out


def f32_cfg(cfg):
    import dataclasses
    import torch
    f = lambda c: dataclasses.replace(c, dtype=torch.float32)      # noqa: E731
    return dataclasses.replace(cfg, vae=f(cfg.vae), unet=f(cfg.unet), vocoder=f(cfg.vocoder))


def train_run(label: str, cfg, batch: int, seed_key: int, steps: int, lr: float) -> dict:
    """``steps`` AdamW steps of ``cfg`` (init_params(0), on the card) on one
    fixed synthetic batch: losses, warm step time, the host's draws (data
    and noise) and the card's synthesis time, peak memory, attn_rows
    launches by shape."""
    import torch

    from egregora_tpu_torch.models.flashsr import distill, pipeline as P, prng, train
    mods = P.FlashSRModules(cfg)
    mods.init_params(0)
    mods.to("cuda")
    kd, kn = prng.split(prng.prng_key(seed_key))
    length = 480 * TRAIN_FRAMES
    t0 = time.perf_counter()
    draws = distill.synth_draws(kd, batch, length)
    draws_s = time.perf_counter() - t0
    for _ in range(2):          # the second call is timed (the first sets up cuFFT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr_w, hr_w = distill.synth_from_draws(draws, length, device="cuda")
        torch.cuda.synchronize()
        synth_s = time.perf_counter() - t0
    with torch.no_grad():
        z_shape = (batch,) + tuple(mods.vae.encode(
            torch.zeros(1, TRAIN_FRAMES, 256, 1, device="cuda")).shape[1:])
    t0 = time.perf_counter()
    prng.normal_from_key(kn, z_shape)
    noise_s = time.perf_counter() - t0
    step = train.make_train_step(mods, train.make_optimizer(mods, lr), None, 480, 256, 2048)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(lr_w, hr_w, kn)))
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    attn = counts["attn_rows"]
    out = {"label": label, "batch": batch, "samples": length, "losses": losses,
           "step_s_warm": sum(walls[1:]) / max(len(walls) - 1, 1), "step_s_cold": walls[0],
           "draws_data_s": draws_s, "draws_noise_s": noise_s, "synth_card_s": synth_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "attn_counts": {"x".join(map(str, k)): v // steps for k, v in attn.items()},
           "attn_counts_all": attn,
           "params_m": sum(p.numel() for p in mods.parameters()) / 1e6}
    log(f"train {label}: {out['params_m']:.1f}M parameters, batch {batch} x {length}: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; warm step {out['step_s_warm']:.3f} s "
        f"(cold {walls[0]:.3f}); host draws {draws_s:.3f} s data + {noise_s:.3f} s noise, "
        f"synthesis on the card {synth_s:.4f} s; peak {out['peak_gib']:.2f} GiB; attn_rows a "
        f"step {out['attn_counts']}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train {label}: the loss did not fall on a fixed batch: {losses}")
    out.update(mods=mods, lr_w=lr_w, hr_w=hr_w, kn=kn)
    return out


def train_phase(card: str, root: str) -> dict:
    """The distilled config at distill()'s defaults and the full config, on
    the card: falling loss, a gradient on every parameter (planted fault: the
    detached attention), card against CPU, the trainer entry point (into
    ``root`` as ``EGREGORA_TPU_WEIGHTS``, where ``served_trained_phase``
    serves it)."""
    import torch

    from egregora_tpu_torch.models.flashsr import distill, pipeline as P
    from egregora_tpu_torch.ops import attention

    res = {"card": card}
    dist_run = train_run("distilled", distill.distilled_config(), TRAIN_BATCH, 1,
                         TRAIN_STEPS, 1e-3)
    mods, lr_w, hr_w, kn = (dist_run.pop(k) for k in ("mods", "lr_w", "hr_w", "kn"))
    # every parameter gets a finite gradient; the planted detached kernel must not
    loss, grads = loss_and_grads(mods, lr_w, hr_w, kn)
    missing, bad = grad_holes(grads)
    real = attention.attn_rows
    attention.attn_rows = detached_attention()
    try:
        _, planted = loss_and_grads(mods, lr_w, hr_w, kn)
    finally:
        attention.attn_rows = real
    p_missing, _ = grad_holes(planted)
    log(f"train distilled: {len(grads)} parameters, {len(missing)} without a gradient, "
        f"{len(bad)} non-finite {'ok' if not (missing or bad) else 'FAIL'}; planted fault "
        f"(the attention kernel detached): {len(p_missing)} without a gradient "
        f"({', '.join('/'.join(k) for k in p_missing[:4])}...) "
        f"{'rejected' if p_missing else 'NOT REJECTED'}")
    if missing or bad:
        raise RuntimeError(f"train: parameters without a finite gradient: {missing[:5]} {bad[:5]}")
    if not p_missing:
        raise RuntimeError("train: a detached attention kernel leaves every gradient in place")
    # the same step on the CPU in float32 (same weights, data, noise)
    n = TRAIN_CPU_ITEMS
    card_loss, card_grads = loss_and_grads(mods, lr_w[:n], hr_w[:n], kn)
    cpu = P.FlashSRModules(f32_cfg(mods.cfg))
    cpu.load_state_dicts({name: {k: v.cpu() for k, v in m.state_dict().items()}
                          for name, m in mods.by_name().items()})
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads(cpu, lr_w[:n].cpu(), hr_w[:n].cpu(), kn)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_rel = sub_model_rel(card_grads, cpu_grads)
    ok = loss_rel <= TRAIN_LOSS_LIMIT and all(grad_rel[k] <= TRAIN_GRAD_LIMITS[k]
                                              for k in grad_rel)
    log(f"train distilled, {n} items, bf16 card vs float32 CPU ({cpu_s:.1f} s there): loss "
        f"{card_loss:.5f} vs {cpu_loss:.5f} (rel {loss_rel:.3e}, limit {TRAIN_LOSS_LIMIT:g}); "
        f"gradient rel L2 " + ", ".join(f"{k} {v:.3e} (limit {TRAIN_GRAD_LIMITS[k]:g})"
                                        for k, v in grad_rel.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"train: card and CPU disagree: loss {loss_rel}, grads {grad_rel}")
    del cpu, cpu_grads, card_grads, grads, planted
    res["distilled"] = dict(dist_run, cpu_loss_rel=loss_rel, cpu_grad_rel=grad_rel,
                            params_without_grad=len(missing),
                            planted_params_without_grad=len(p_missing))
    del mods
    torch.cuda.empty_cache()
    # the full config at batch 2: attn_rows launched inside the step
    full = train_run("full config", P.FlashSRConfig(), FULL_TRAIN_BATCH, 2, 3, 1e-4)
    full_mods = full.pop("mods")
    for k in ("lr_w", "hr_w", "kn"):
        full.pop(k)
    if not full["attn_counts"]:
        raise RuntimeError("train full config: no attn_rows launch inside the step")
    res["full"] = full
    del full_mods
    torch.cuda.empty_cache()
    # the trainer's entry point: distill() at its defaults for a few steps,
    # written where the trainer writes by default
    with weights_root(root):
        reset_counts()
        t0 = time.perf_counter()
        m = distill.distill(steps=3, log_every=1)
        wall = time.perf_counter() - t0
        counts = read_counts()["attn_rows"]
        back = distill.load_pretrained_with_cfg(distill.weights_dir() / distill.PRETRAINED.name)
        if back is None or back[0] != distill.distilled_config():
            raise RuntimeError("distill(): the written trio does not load back")
    log(f"distill(steps=3) at its defaults: {wall:.1f} s with evaluate() of 4 chunks; "
        f"metrics {json.dumps({k: m[k] for k in ('loss_first', 'loss_last', 'lsd_model')})}; "
        f"attn_rows {counts}")
    res["distill_entry"] = {"wall_s": wall, "metrics": m, "attn_counts": counts}
    return res


def attn_grad_phase(shapes) -> list:
    """The attention Function's backward at the training shapes: against
    autograd through attn_rows_plain in float32 (dq, dk, dv), beside the
    planted fault (dS = P * dP, the row term dropped), with its time and
    SDPA's backward at the same shapes."""
    import torch
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import attn_rows as ar

    gen = torch.Generator().manual_seed(3)
    rows = []
    for bh, n, d in sorted(shapes):
        q, k, v, do = (torch.randn(bh, n, d, generator=gen).to("cuda", torch.bfloat16)
                       for _ in range(4))
        o = ar._attn_rows(q, k, v)
        got = ar.attn_rows_backward(q, k, v, o, do)
        qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
        want = torch.autograd.grad(ar.attn_rows_plain(qf, kf, vf), (qf, kf, vf), do.float())
        rel = [rel_l2(g.float(), w) for g, w in zip(got, want)]
        bad = [rel_l2(g.float(), w) for g, w in zip(planted_backward(q, k, v, do), want)]
        ok = all(r <= ATTN_GRAD_LIMIT for r in rel)
        rejected = any(r > ATTN_GRAD_LIMIT for r in bad)
        reps = max(3, min(30, int(1e11 / (8.0 * bh * n * n * d))))
        ms = cuda_ms(lambda: ar.attn_rows_backward(q, k, v, o, do), reps)
        q4, k4, v4 = (t.view(bh, 1, n, d).requires_grad_() for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4)
        do4 = do.view(bh, 1, n, d)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True),
                         reps)
        # the scores recomputed (2 n^2 d) and the dV, dP, dQ, dK products (8 n^2 d);
        # q, k, v, o, dO read and dq, dk, dv written once, bf16
        b_ms, b_by = bound(10.0 * bh * n * n * d, 2.0 * 8 * bh * n * d, H100_BF16_FLOPS)
        row = {"bh": bh, "n": n, "d": d, "rel_dq_dk_dv": rel, "planted_rel": bad,
               "backward_ms": ms, "sdpa_backward_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        log(f"attn_rows backward [{bh},{n},{d}]: dq/dk/dv rel L2 "
            f"{', '.join(f'{r:.2e}' for r in rel)} (limit {ATTN_GRAD_LIMIT:g}) "
            f"{'ok' if ok else 'FAIL'}; planted fault (row term dropped) "
            f"{', '.join(f'{r:.2e}' for r in bad)} {'rejected' if rejected else 'NOT REJECTED'}; "
            f"plain backward {ms:.4f} ms, SDPA backward {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, recomputing the scores)")
        if not ok:
            raise RuntimeError(f"attention backward disagrees at [{bh},{n},{d}]: {rel}")
        if not rejected:
            raise RuntimeError(f"the attention gradient limit does not reject the planted "
                               f"fault at [{bh},{n},{d}]")
        rows.append(row)
        del q, k, v, do, o, got, want, q4, k4, v4, o4
    return rows


def planted_backward(q, k, v, do, block: int = 256):
    """A planted fault: ``attn_rows_backward`` with ``dS = P * dP``, the
    row term ``rowsum(dO * O)`` dropped."""
    import torch
    n, d = q.shape[-2:]
    s = d ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq, dk, dv = torch.empty_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for i in range(0, n, block):
        r = slice(i, i + block)
        p = torch.softmax(qf[:, r] @ kf.transpose(1, 2) * s, dim=-1)
        dv += p.transpose(1, 2) @ dof[:, r]
        ds = p * (dof[:, r] @ vf.transpose(1, 2))
        dq[:, r] = ds @ kf * s
        dk += ds.transpose(1, 2) @ qf[:, r] * s
    return dq, dk, dv


def vocoder_distill_phase(root: str) -> dict:
    """distill_vocoder at its default paths in ``root`` (as
    ``EGREGORA_TPU_WEIGHTS``): from the served HiFi-GAN trio's frozen
    VAE/UNet, which is the trio phase 20 distilled there, with the shipped
    istft head's geometry (hidden 256, depth 6, phase_cond, exciter), a few
    steps, written where the trainer writes by default."""
    from egregora_tpu_torch.models.flashsr import distill
    with weights_root(root):
        src = distill.served_trio(distill.PRETRAINED)
        if src != distill.weights_dir() / distill.PRETRAINED.name:
            raise RuntimeError(f"distill_vocoder: the served HiFi-GAN trio is {src}, not the "
                               "one distill() wrote")
        out = distill.weights_dir() / distill.PRETRAINED_ISTFT.name
        reset_counts()
        t0 = time.perf_counter()
        m = distill.distill_vocoder(steps=4, hidden=256, depth=6, phase_cond=True,
                                    exciter=True)
        wall = time.perf_counter() - t0
        counts = read_counts()["attn_rows"]
        back = distill.load_pretrained_with_cfg(out)
    if back is None or not (back[0].vocoder.phase_cond and back[0].vocoder.exciter):
        raise RuntimeError("distill_vocoder: the written trio does not load back")
    if not all(math.isfinite(m[k]) for k in ("loss_first", "loss_last", "lsd_model")):
        raise RuntimeError(f"distill_vocoder: non-finite metrics {m}")
    if not counts:
        raise RuntimeError("distill_vocoder: the frozen StudentUNet launched no attn_rows")
    log(f"distill_vocoder(steps=4, hidden 256, depth 6, phase_cond, exciter) from {src}: "
        f"{wall:.1f} s "
        f"with evaluate(); losses {m['loss_first']:.4f} -> {m['loss_last']:.4f}, LSD "
        f"{m['lsd_model']:.2f} dB, SI-SDR {m['sisdr_model']:.2f} dB; attn_rows {counts}")
    return {"wall_s": wall, "metrics": m, "attn_counts": counts}


# the node's output against a pipeline built straight from the trained
# file, max |d| (the same weights and code on the same card: equal; a node
# that serves another file reads ~1e-1)
SERVED_SAME_ABS = 1e-6


def record_calls(module, name: str, calls: list):
    """``module.name`` wrapped to keep the arguments of every call (the
    kernels' inputs on a node path); returns the original."""
    real = getattr(module, name)

    def recording(*args):
        calls.append(args)
        return real(*args)

    setattr(module, name, recording)
    return real


def served_kernel_checks(label: str, calls: dict) -> list:
    """Each kernel launch recorded on a node path against its plain version
    on the same inputs (launches made here are not counted: the path's
    counts are read before)."""
    import torch

    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr

    rows = []
    for q, k, v in calls["attn_rows"]:
        ok, rel, err, limit = bf16_agreement(ar.attn_rows(q, k, v), ar.attn_rows_plain(q, k, v))
        rows.append({"kernel": "attn_rows", "shape": list(q.shape), "ok": ok, "rel_l2": rel,
                     "max_abs_err": err, "max_abs_limit": limit})
    for x, w, b, kernels, dils in calls["mrf_fused_cm"]:
        ok, rel, err, edge, limit = mrf_agreement(mf.mrf_fused_cm(x, w, b, kernels, dils),
                                                  mf.mrf_fused_cm_plain(x, w, b, kernels, dils))
        rows.append({"kernel": "mrf_fused_cm", "shape": list(x.shape), "ok": ok, "rel_l2": rel,
                     "max_abs_err": max(err, edge), "max_abs_limit": limit})
    for x, w, b, kernels, dils in calls["mrf_rows"]:
        branches = mf.branch_weights(w, x.shape[-1], kernels, len(dils))
        plain = sum(mr.mrf_branch_rows_plain(x, wb, b[i], dils)
                    for i, wb in enumerate(branches)) / len(kernels)
        got = mr.mrf_rows(x, w, b, kernels, dils)
        ok, rel, err, edge, limit = mrf_agreement(got.transpose(1, 2), plain.transpose(1, 2))
        rows.append({"kernel": "mrf_rows", "shape": list(x.shape), "ok": ok, "rel_l2": rel,
                     "max_abs_err": max(err, edge), "max_abs_limit": limit})
    torch.cuda.synchronize()
    for r in rows:
        log(f"served {label}: {r['kernel']} {r['shape']} against its plain version rel L2 "
            f"{r['rel_l2']:.3e}, max|d| {r['max_abs_err']:.3e} (limit {r['max_abs_limit']:.3e}) "
            f"{'ok' if r['ok'] else 'FAIL'}")
    return rows


def served_trained_phase(card: str, root: str) -> dict:
    """Phase 22b: the trios phases 20 and 22 distilled on the card into
    ``root`` (as ``EGREGORA_TPU_WEIGHTS``), served by the upscaler node
    through the resolver on the seeded 12 s input, one-shot, on each path
    of ``NODE_PATHS``: the trained HiFi-GAN trio ("distilled") with the
    fused and the rows MRF kernels, the trained istft trio
    ("distilled-istft") with its one attention.  Each path's launches
    counted (and its FLOP logs held to them), its output held to a pipeline
    built straight from the trained file (``SERVED_SAME_ABS``), beside the
    planted fault of a resolver that reads only the shipped file (the
    port before this phase existed), and each launch held to its plain
    version on the inputs the path gave it."""
    from pathlib import Path

    import numpy as np
    import torch

    from egregora_tpu_torch.core.audio import from_any
    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr import vocoder as V
    from egregora_tpu_torch.nodes import super_resolution
    from egregora_tpu_torch.ops import attention
    from egregora_tpu_torch.utils import profiling

    node_cls = super_resolution.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]
    sr_in, sr_out = 16000, 48000
    audio = {"waveform": torch.from_numpy(test_signal(SECONDS, sr_in, seed=0)[None]),
             "sample_rate": sr_in}
    results, failures = {}, []
    with weights_root(root):
        for label, variant, switches, per_item in NODE_PATHS:
            name = "pretrained.npz" if variant == "hifigan" else "pretrained_istft.npz"
            want = "distilled" if variant == "hifigan" else "distilled-istft"
            label = "trained " + label
            path = distill.served_trio(distill.SHIPPED_DIR / name)
            if path != Path(root) / "flashsr" / name:
                raise RuntimeError(f"{label}: the resolver serves {path}, not the trained file")
            cfg, sd = distill.load_pretrained_with_cfg(path)
            set_env(EGREGORA_FLASHSR_VARIANT=variant, **switches)
            node_cls._PIPE = None
            node = node_cls()
            pipe = node._pipeline()
            state = {n: m.state_dict() for n, m in pipe.modules.by_name().items()}
            same = pipe.cfg == cfg and all(
                torch.equal(v, sd[n][k].to(v.device, v.dtype)) for n in state
                for k, v in state[n].items())
            if pipe.weight_source != want or pipe.device.type != "cuda" or not same:
                raise RuntimeError(f"{label}: the node serves {pipe.weight_source} on "
                                   f"{pipe.device} (the trained file's weights: {same})")
            calls = {"attn_rows": [], "mrf_fused_cm": [], "mrf_rows": []}
            reals = [(attention, "attn_rows", record_calls(attention, "attn_rows",
                                                           calls["attn_rows"]))]
            reals += [(V, k, record_calls(V, k, calls[k])) for k in ("mrf_fused_cm", "mrf_rows")]
            reset_counts()
            try:
                with profiling.recording():   # the FLOP logs append only while recording
                    (out,) = node.run(audio, lowpass_input=False, output_sr=str(sr_out))
                torch.cuda.synchronize()
            finally:
                for mod, k, real in reals:
                    setattr(mod, k, real)
            counts = read_counts()
            flops = flop_check(label, counts)
            expect = expected_counts(per_item, BATCH, 1)
            if counts != expect:
                raise RuntimeError(f"{label}: launches {counts}, expected {expect}")
            got = out["waveform"].numpy()[0]
            direct = P.FlashSRPipeline(cfg, params=sd, device="cuda")
            ref = direct.process(from_any(audio), lowpass_input=False, output_sr=sr_out).numpy()
            shipped_cfg, shipped_sd = distill.load_pretrained_with_cfg(distill.SHIPPED_DIR / name)
            wrong = P.FlashSRPipeline(shipped_cfg, params=shipped_sd, device="cuda").process(
                from_any(audio), lowpass_input=False, output_sr=sr_out).numpy()
            err = float(np.abs(got - ref).max())
            bad = float(np.abs(wrong - ref).max())
            kernels = served_kernel_checks(label, calls)
            log(f"served {label} ({want} from {path}): one-shot launches {counts}; node vs the "
                f"trained file's pipeline max|d| {err:.3e} (limit {SERVED_SAME_ABS:g}) "
                f"{'ok' if err <= SERVED_SAME_ABS else 'FAIL'}; planted fault (the shipped "
                f"file served) {bad:.3e} {'rejected' if bad > SERVED_SAME_ABS else 'NOT REJECTED'}")
            if not (got.shape == ref.shape and np.isfinite(got).all() and err <= SERVED_SAME_ABS):
                failures.append(f"{label}: the node's output is {err} from the trained file's")
            if not bad > SERVED_SAME_ABS:
                failures.append(f"{label}: the served-file limit does not reject the shipped file")
            failures += [f"{label}: {r['kernel']} {r['shape']} disagrees with its plain version"
                         for r in kernels if not r["ok"]]
            results[label] = {"counts": counts, "flops": flops, "max_abs_vs_trained_file": err,
                              "planted_max_abs": bad, "kernels": kernels}
            del direct
    set_env(EGREGORA_FLASHSR_VARIANT=None, EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)
    if failures:
        raise RuntimeError("; ".join(failures))
    return results


def checkpoint_phase() -> dict:
    """A checkpoint written at step k and resumed against the run that went
    on to step k + 1 (distilled config, batch 2, the card)."""
    import tempfile

    import torch

    from egregora_tpu_torch.models.flashsr import distill, pipeline as P, prng, train
    cfg, lr, k = distill.distilled_config(), 2e-4, 2
    base = prng.prng_key(21)

    def run(mods, opt, i):
        return distill.make_distill_step(mods, opt, 2, 480 * TRAIN_FRAMES)(prng.fold_in(base, i))

    a = P.FlashSRModules(cfg)
    a.init_params(0)
    a.to("cuda")
    opt_a = train.make_optimizer(a, lr)
    for i in range(k):
        run(a, opt_a, i)
    with tempfile.TemporaryDirectory() as d:
        train.save_checkpoint(d, a, opt_a, k)
        b = P.FlashSRModules(cfg)
        b.init_params(1)
        b.to("cuda")
        opt_b = train.make_optimizer(b, lr)
        step = train.load_checkpoint(d, b, opt_b)
    same_state = step == k and all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    for x, y in zip(a.parameters(), b.parameters()):
        sa, sb = opt_a.state[x], opt_b.state[y]
        same_state &= all(torch.equal(sa[n].float(), sb[n].to(sa[n].device).float())
                          for n in ("step", "exp_avg", "exp_avg_sq"))
    la, lb = float(run(a, opt_a, k)), float(run(b, opt_b, k))
    moved = max(float((x - y).detach().abs().max()) for x, y in zip(a.parameters(),
                                                                     b.parameters()))
    ok = same_state and moved <= RESUME_LR_SHARE * lr
    log(f"checkpoint at step {k}: weights, moments and count read back exactly "
        f"{'ok' if same_state else 'FAIL'}; step {k + 1} resumed vs uninterrupted: loss "
        f"{lb:.5f} vs {la:.5f}, max |d param| {moved:.3e} (limit {RESUME_LR_SHARE} x lr = "
        f"{RESUME_LR_SHARE * lr:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"checkpoint resume differs: state {same_state}, moved {moved}")
    return {"loss_uninterrupted": la, "loss_resumed": lb, "max_param_diff": moved}


EVAL_BARS = {"pretrained.npz": 4.0, "pretrained_istft.npz": 8.79}   # gate-pair SI-SDR bars


def evaluate_phase() -> dict:
    """evaluate() on both shipped trios (seed 7, 4 chunks) beside their json
    records, and the gate pair (seed 123, one chunk) held to the bars of
    tests/test_flashsr_distilled.py: LSD < 7 dB, 20 dB under passthrough,
    SI-SDR above 4 dB (HiFi-GAN) / 8.79 dB (istft)."""
    from egregora_tpu_torch.eval.metrics import lsd_sisdr_report
    from egregora_tpu_torch.models.flashsr import distill, pipeline as P, prng
    out = {}
    for name, bar in EVAL_BARS.items():
        cfg, sds = shipped_trio(name)
        m = distill.evaluate(sds, cfg, seed=7, n=4)
        rec = json.loads((distill.SHIPPED_DIR / name).with_suffix(".json").read_text())
        pipe = P.FlashSRPipeline(cfg, params=sds)
        lr_w, hr_w = distill.synth_pair_batch(prng.prng_key(123), 1, P.CHUNK_SAMPLES)
        est = pipe.chunk_forward(lr_w)
        pt, md = lsd_sisdr_report(hr_w[0], lr_w[0]), lsd_sisdr_report(hr_w[0], est[0])
        gate = {"lsd_pt": float(pt["lsd_mean_db"]), "lsd": float(md["lsd_mean_db"]),
                "sisdr": float(md["si_sdr_db"])}
        ok = gate["lsd"] < 7.0 and gate["lsd"] < gate["lsd_pt"] - 20.0 and gate["sisdr"] > bar
        log(f"evaluate {name} (seed 7, 4 chunks): LSD {m['lsd_model']:.2f} dB (passthrough "
            f"{m['lsd_passthrough']:.2f}), SI-SDR {m['sisdr_model']:.2f} dB (passthrough "
            f"{m['sisdr_passthrough']:.2f}); the json record: "
            f"{json.dumps({k: rec[k] for k in rec if k in ('lsd_model', 'sisdr_model', 'gate_pair_seed123')})}; "
            f"gate pair (seed 123): LSD {gate['lsd']:.2f} dB (pt {gate['lsd_pt']:.2f}), SI-SDR "
            f"{gate['sisdr']:.2f} dB (bar > {bar}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"evaluate: {name} misses the quality bars: {gate}")
        out[name] = {"evaluate": m, "gate_pair": gate}
    return out


MESH_CHILD = r'''
import json, os, sys
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
rank, port = int(sys.argv[1]), sys.argv[2]
from egregora_tpu_torch.parallel import multihost as MH
MH.initialize_distributed(f"tcp://127.0.0.1:{port}", 2, rank)
import torch.distributed as dist
import chip_smoke as C
from egregora_tpu_torch.core.audio import AudioBuffer
from egregora_tpu_torch.models.flashsr import distill, pipeline as P, prng, train
mesh = MH.make_global_chunk_mesh()
out = {"rank": rank, "backend": dist.get_backend(), "mesh_size": mesh.size}
# one sharded train step (float32, full width) == the one-process step
cfg = C.f32_cfg(distill.distilled_config())
ref, sh = P.FlashSRModules(cfg), P.FlashSRModules(cfg)
ref.init_params(0); sh.init_params(0); ref.to("cuda"); sh.to("cuda")
lr_w, hr_w = distill.synth_pair_batch(prng.prng_key(31), 4, 480 * 128)
key = prng.prng_key(32)
l_ref = float(train.make_train_step(ref, train.make_optimizer(ref, 2e-4), None, 480, 256, 2048)(lr_w, hr_w, key))
l_sh = float(train.make_train_step(sh, train.make_optimizer(sh, 2e-4), mesh, 480, 256, 2048)(lr_w, hr_w, key))
gr, gs = C.named_grads(ref), C.named_grads(sh)
out["step"] = {"loss_ref": l_ref, "loss_sharded": l_sh, "loss_rel": abs(l_sh - l_ref) / abs(l_ref),
               "grad_rel": C.sub_model_rel(gs, gr)}
del ref, sh
torch.cuda.empty_cache()
# the sharded process == one device running the same forward batches
os.environ["EGREGORA_FUSED_VOCODER"] = "1"
os.environ["EGREGORA_FLASHSR_VARIANT"] = "hifigan"
cfg, sds = C.shipped_trio("pretrained.npz")
pipe = P.FlashSRPipeline(cfg, params=sds)
audio = AudioBuffer(C.test_signal(C.SECONDS, 16000, 0), 16000)
res = {}
for label, kw, ref_kw in (("one-shot", {}, {"max_batch": 2, "pad_to_multiple": 2}),
                          ("max_batch=2", {"max_batch": 2}, {"max_batch": 1, "pad_to_multiple": 2})):
    want = pipe.process(audio, output_sr=48000, mesh=None, wire="f32", **ref_kw).numpy()
    C.reset_counts()
    got = pipe.process(audio, output_sr=48000, mesh=mesh, wire="f32", **kw).numpy()
    counts = C.read_counts()
    res[label] = {"rel": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
                  "finite": bool(np.isfinite(got).all()), "shape_ok": got.shape == want.shape,
                  "mrf_fused_cm": sum(counts["mrf_fused_cm"].values()),
                  "attn_rows": sum(counts["attn_rows"].values())}
out["process"] = res
print("MESHRANK " + json.dumps(out), flush=True)
dist.destroy_process_group()
'''


def mesh_phase() -> dict:
    """process(mesh=...) in this process (the one-card mesh, and two slots
    on the card's streams) against mesh=None, then two ranks on the one
    card over gloo in subprocesses: a sharded train step against the
    one-process step, the sharded process (one-shot and max_batch) against
    one device, with the fused MRF kernels counted on each rank."""
    import os
    import socket
    from pathlib import Path

    import numpy as np

    from egregora_tpu_torch.core.audio import AudioBuffer
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.parallel.mesh import ChunkMesh, make_chunk_mesh

    set_env(EGREGORA_FUSED_VOCODER="1")
    try:
        cfg, sds = shipped_trio("pretrained.npz")
        pipe = P.FlashSRPipeline(cfg, params=sds)
        audio = AudioBuffer(test_signal(SECONDS, 16000, 0), 16000)
        one = pipe.process(audio, mesh=None, wire="f32").numpy()
        card_mesh = pipe.process(audio, mesh=make_chunk_mesh(), wire="f32").numpy()
        exact = bool(np.array_equal(card_mesh, one))
        want = pipe.process(audio, mesh=None, wire="f32", max_batch=2, pad_to_multiple=2).numpy()
        reset_counts()
        two = pipe.process(audio, mesh=ChunkMesh(("cuda:0", "cuda:0")), wire="f32").numpy()
        slot_counts = read_counts()
        slot_rel = float(np.linalg.norm(two - want) / np.linalg.norm(want))
    finally:
        set_env(EGREGORA_FUSED_VOCODER=None)
    ok = exact and slot_rel <= MESH_PROCESS_LIMIT
    log(f"mesh, one process: process(mesh=make_chunk_mesh()) == mesh=None bit for bit "
        f"{'ok' if exact else 'FAIL'}; two slots on the card's streams against one device at "
        f"the same forward batches rel L2 {slot_rel:.2e} (limit {MESH_PROCESS_LIMIT:g}) "
        f"{'ok' if slot_rel <= MESH_PROCESS_LIMIT else 'FAIL'}; fused MRF launches "
        f"{sum(slot_counts['mrf_fused_cm'].values())}")
    if not ok:
        raise RuntimeError(f"mesh: process(mesh=...) differs from one device ({exact}, {slot_rel})")
    root = Path(__file__).resolve().parent
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", MESH_CHILD, str(r), str(port)], cwd=root,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    ranks = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("MESHRANK ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"mesh rank {r} failed (rc {p.returncode}):\n{text[-3000:]}")
        ranks.append(json.loads(lines[-1][len("MESHRANK "):]))
    for r in ranks:
        st, pr = r["step"], r["process"]
        ok = (r["backend"] == "gloo" and r["mesh_size"] == 2
              and st["loss_rel"] <= MESH_STEP_LIMIT
              and all(v <= MESH_STEP_LIMIT for v in st["grad_rel"].values())
              and all(x["finite"] and x["shape_ok"] and x["rel"] <= MESH_PROCESS_LIMIT
                      and x["mrf_fused_cm"] > 0 and x["attn_rows"] > 0 for x in pr.values()))
        log(f"mesh rank {r['rank']} of 2 ({r['backend']}, one card): sharded float32 train step "
            f"loss rel {st['loss_rel']:.2e}, gradient rel "
            + ", ".join(f"{k} {v:.2e}" for k, v in st["grad_rel"].items())
            + f" (limit {MESH_STEP_LIMIT:g}); process " + "; ".join(
                f"{k}: rel {v['rel']:.2e} (limit {MESH_PROCESS_LIMIT:g}), mrf_fused_cm "
                f"{v['mrf_fused_cm']}, attn_rows {v['attn_rows']}" for k, v in pr.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"mesh rank {r['rank']}: {r}")
    log(f"mesh: two ranks in {wall:.1f} s (process start, CUDA set-up and both checks)")
    return {"one_process": {"exact": exact, "two_slot_rel": slot_rel}, "ranks": ranks,
            "wall_s": wall}


# ---- training: the RNNoise, DeepFilterNet and DAC trainers (plain PyTorch) ----

# card against CPU, float32 on both, one fixed batch: the loss (relative) and each
# leaf's gradient (relative L2); the RNNoise batch starts with the quiet lead-in of
# tests/test_torch_rnnoise_train.py (frame 0's pitch follows FFT roundoff otherwise)
TRAINER_LOSS_REL, TRAINER_GRAD_REL = 1e-4, 1e-3
RN_LEAD, RN_FADE = 960, 480
RN_SNR_GAIN_DB = 5.0          # tests/test_rnnoise_training.py's bar (the JAX record: +7.2)
# DAC: the rvq_only step's decay made visible (lr 1e-2, weight decay 0.1: 1e-3 of each
# weight a step; the trainer's 1.5e-4 x 1e-5 is below a float32 ulp), encoder and
# decoder card against CPU, relative L2; the gate's SNR card against CPU, dB
DAC_DECAY_LR, DAC_DECAY_WD, DAC_DECAY_REL = 1e-2, 0.1, 1e-5
# DAC's losses (float32, seeded weights) card against CPU: the loss, relative, and each
# sub-model's gradients, relative L2 (on the CPU, 1e-7 of input noise moves them by up to
# 2e-5 and 1e-5)
DAC_LOSS_REL, DAC_GRAD_REL = 1e-4, 1e-3
DAC_GATE_SNR_DB = 0.5
# tests/test_dac_distilled.py's record of the shipped codecs (the JAX package)
DAC_GATE_RECORD = {"44khz": (8.01, 4.41), "24khz": (11.23, 8.18), "16khz": (13.12, 10.66)}


def package_digest() -> str:
    """SHA-256 over every file under ``egregora_tpu/`` (names and bytes)."""
    import hashlib
    from pathlib import Path
    root = Path(__file__).resolve().parent
    h = hashlib.sha256()
    for p in sorted((root / "egregora_tpu").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def leaf_rel(card: list, cpu: list) -> list:
    """Relative L2 of each gradient, card against CPU (a missing gradient
    counts as zeros)."""
    out = []
    for a, b in zip(card, cpu):
        if a is None and b is None:
            out.append(0.0)
            continue
        a = b.new_zeros(b.shape) if a is None else a.double().cpu()
        b = a.new_zeros(a.shape) if b is None else b.double()
        out.append(float((a.double() - b).norm() / max(float(b.norm()), 1e-30)))
    return out


def zero_or_missing(grads: list, names: list) -> list:
    """The leaves whose gradient is missing or all zero."""
    return [n for n, g in zip(names, grads) if g is None or not bool(g.any())]


def tree_grads(loss, params: dict, batch, device: str):
    """(loss, [gradient of each leaf], leaf names) of ``loss(params on
    device, *batch on device)``."""
    import torch

    from egregora_tpu_torch.models.rnnoise.train import leaves, trainable
    from egregora_tpu_torch.ops.fir import exact_f32
    from egregora_tpu_torch.utils.weights import sorted_leaves
    tp = trainable(params, device)
    with exact_f32():                  # the trainers' step: forward and backward in float32
        lv = loss(tp, *(torch.as_tensor(a).to(device) for a in batch))
        grads = torch.autograd.grad(lv, leaves(tp), allow_unused=True)
    names = ["/".join(p) for p, _ in sorted_leaves(params)]
    return float(lv.detach()), [None if g is None else g.detach().cpu() for g in grads], names


def trainer_check(label: str, card, cpu, frozen: tuple = ()) -> dict:
    """Card against CPU of one (loss, grads, names): within the limits, and
    every leaf with a nonzero gradient but those named under a ``frozen``
    prefix (the rvq warm-up's zeroed encoder and decoder)."""
    (lc, gc, names), (lh, gh, _) = card, cpu
    rels = leaf_rel(gc, gh)
    worst = max(zip(rels, names))
    holes = [n for n in zero_or_missing(gc, names) if not n.startswith(frozen or ("\0",))]
    r = {"loss_rel": abs(lc - lh) / abs(lh), "grad_rel_worst": worst[0],
         "grad_rel_worst_leaf": worst[1], "leaves": len(names), "without_gradient": holes}
    r["ok"] = (r["loss_rel"] <= TRAINER_LOSS_REL and not holes and math.isfinite(lc)
               and all(x <= TRAINER_GRAD_REL for x in rels))
    log(f"{label}: loss {lc:.6f} (CPU {lh:.6f}, rel {r['loss_rel']:.2e}); {len(names)} leaves, "
        f"worst gradient rel {worst[0]:.2e} ({worst[1]}); without a gradient: "
        f"{holes or 'none'} {'ok' if r['ok'] else 'FAIL'}")
    return r


def rn_lead_in(x):
    """``x [B, T]`` with a quiet (1e-6 noise) lead-in and a raised-cosine fade."""
    import numpy as np
    i = np.arange(x.shape[-1])
    env = 0.5 - 0.5 * np.cos(np.pi * np.clip((i - RN_LEAD) / RN_FADE, 0.0, 1.0))
    return (x * env + 1e-6 * np.random.default_rng(9).standard_normal(x.shape)).astype(np.float32)


def timed_steps(make_batch, step, n: int) -> dict:
    """``n`` steps of ``step(*batch)``, each on ``make_batch(i) -> (host
    draws, card synthesis)``: the host's draw time, the card's synthesis and
    the step apart (warm: the steps after the first), peak memory."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    draws, synth, steps = [], [], []
    for i in range(n):
        t0 = time.perf_counter()
        d = make_batch[0](i)
        draws.append(time.perf_counter() - t0)
        batch, s = synced_wall(lambda: make_batch[1](d))
        synth.append(s)
        _, s = synced_wall(lambda: step(*batch))
        steps.append(s)
    warm = lambda xs: sum(xs[1:]) / max(len(xs) - 1, 1)      # noqa: E731
    return {"draws_s": warm(draws), "synth_card_s": warm(synth), "step_s_warm": warm(steps),
            "step_s_cold": steps[0], "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def rnnoise_train_phase(card: str) -> dict:
    """The RNNoise trainer on the card: ``train_device(steps=3)`` and
    ``train(steps=3)`` at their defaults from ``init_params(0)``; warm steps at
    ``train_device``'s defaults (16 x 50 frames) with the host's draws and the
    card's synthesis apart; one fixed batch (lead-in) card against CPU, loss
    and every leaf's gradient, every leaf with one, beside the planted fault
    of the GRU carries detached every frame; the shipped weights' SNR gain on
    ``synth_batch(default_rng(4242), 4, 40)``."""
    import numpy as np
    import torch

    from egregora_tpu_torch.models.flashsr import prng
    from egregora_tpu_torch.models.optim import AdamChain
    from egregora_tpu_torch.models.rnnoise import model as R
    from egregora_tpu_torch.models.rnnoise import train as rtr
    from egregora_tpu_torch.utils.weights import sorted_leaves

    reset_counts()
    out = {}
    for name, fn in (("train_device", rtr.train_device), ("train", rtr.train)):
        torch.cuda.reset_peak_memory_stats()
        tree, wall = synced_wall(lambda: fn(steps=3, log_every=0))
        finite = all(np.isfinite(v).all() for _, v in sorted_leaves(tree))
        out[name] = {"wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "finite": finite}
        if not finite:
            raise RuntimeError(f"rnnoise {name}: non-finite weights after 3 steps")
    params = rtr.trainable(R.init_params(0), "cuda")
    step = rtr.make_step(rtr.loss_fn, params, AdamChain(rtr.leaves(params), 3e-3, 4, 0.05))
    base = prng.prng_key(1)
    out["steps"] = timed_steps((lambda i: rtr.synth_draws(prng.fold_in(base, i), 16, 50),
                                lambda d: rtr.synth_from_draws(d, 50, "cuda")), step, 4)
    s = out["steps"]
    log(f"rnnoise train_device at 16 x 50 frames on {card}: warm step {s['step_s_warm']:.4f} s "
        f"(cold {s['step_s_cold']:.3f}); host draws {s['draws_s']:.4f} s, synthesis on the card "
        f"{s['synth_card_s']:.4f} s; peak {s['peak_gib']:.3f} GiB; train_device(steps=3) "
        f"{out['train_device']['wall_s']:.2f} s, train(steps=3) {out['train']['wall_s']:.2f} s")

    noisy, clean, vad = rtr.synth_batch(np.random.default_rng(7), 16, 50)
    batch = (rn_lead_in(noisy), rn_lead_in(clean), vad)
    init = R.init_params(0)
    cpu = tree_grads(rtr.loss_fn, init, batch, "cpu")
    out["card_vs_cpu"] = trainer_check("rnnoise loss_fn, card vs CPU", tree_grads(
        rtr.loss_fn, init, batch, "cuda"), cpu)
    real = R._gru_update
    R._gru_update = lambda h, xw, rec: real(h.detach(), xw, rec)
    try:
        planted = trainer_check("rnnoise loss_fn, planted: GRU carries detached",
                                tree_grads(rtr.loss_fn, init, batch, "cuda"), cpu)
    finally:
        R._gru_update = real
    out["planted_detached_carry"] = planted["grad_rel_worst"]
    if not out["card_vs_cpu"]["ok"] or planted["ok"]:
        raise RuntimeError("rnnoise train: card vs CPU failed or the planted fault passed")

    shipped = rtr.load_pretrained()
    noisy, clean, _ = rtr.synth_batch(np.random.default_rng(4242), 4, 40)
    clean = rtr.filtered_target(torch.from_numpy(clean)).numpy()
    with torch.no_grad():
        den, vads = R.denoise(shipped, torch.from_numpy(noisy).cuda())
    den, vads = den.cpu().numpy(), vads.cpu().numpy()
    f = R.FRAME
    snr = lambda ref, sig: 10 * np.log10(np.sum(ref ** 2) / (np.sum((ref - sig) ** 2) + 1e-12))  # noqa
    before = float(np.mean([snr(clean[i][f:-f], noisy[i][f:-f]) for i in range(4)]))
    after = float(np.mean([snr(clean[i][f:-f], den[i][2 * f:]) for i in range(4)]))
    out["shipped_snr_gain_db"] = after - before
    ok = after - before > RN_SNR_GAIN_DB and 0.05 < float(vads.mean()) < 0.95
    log(f"rnnoise shipped weights on {card}: SNR {before:+.2f} -> {after:+.2f} dB (gain "
        f"{after - before:+.2f} dB, bar +{RN_SNR_GAIN_DB}; the JAX record +7.2), VAD mean "
        f"{float(vads.mean()):.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("rnnoise train: the shipped weights miss the SNR bar")
    no_launches("rnnoise train")
    return out


def dfn_no_grad_gru(kernel, recurrent, bias, xs):
    """Planted fault: the GRU as it ran before, weights copied into an
    ``nn.GRU`` under ``no_grad`` (no gradient to the GRU or before it)."""
    import torch

    from egregora_tpu_torch.models.deepfilternet.model import _cudnn_gate_order
    gru = torch.nn.GRU(kernel.shape[0], recurrent.shape[0], batch_first=True,
                       device="meta").to_empty(device=xs.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(_cudnn_gate_order(kernel).T)
        gru.weight_hh_l0.copy_(_cudnn_gate_order(recurrent).T)
        gru.bias_ih_l0.copy_(_cudnn_gate_order(bias))
        gru.bias_hh_l0.zero_()
        return gru(xs)[0]


def dfn_train_phase(card: str) -> dict:
    """The DeepFilterNet trainer on the card, per variant: ``train_device(
    steps=3)`` at its defaults (4 x 50 frames) from ``init_params(0)``; warm
    steps with the host's draws and the card's synthesis apart; one fixed
    batch card against CPU, loss and every leaf's gradient (the GRUs' and the
    encoder's included), beside the planted fault of the GRU run under
    ``no_grad`` as it was, which must leave them without one."""
    import numpy as np
    import torch

    from egregora_tpu_torch.models.deepfilternet import model as D
    from egregora_tpu_torch.models.deepfilternet import train as dtr
    from egregora_tpu_torch.models.flashsr import prng
    from egregora_tpu_torch.models.optim import AdamChain
    from egregora_tpu_torch.models.rnnoise import train as rtr
    from egregora_tpu_torch.utils.weights import sorted_leaves

    reset_counts()
    out = {}
    noisy, clean, _ = rtr.synth_batch(np.random.default_rng(8), 4, 50)
    for variant in DFN_VARIANTS:
        cfg = D.DFNConfig.for_variant(variant)
        torch.cuda.reset_peak_memory_stats()
        tree, wall = synced_wall(lambda: dtr.train_device(steps=3, log_every=0, cfg=cfg))
        if not all(np.isfinite(v).all() for _, v in sorted_leaves(tree)):
            raise RuntimeError(f"dfn {variant}: non-finite weights after 3 steps")
        r = {"train_device_wall_s": wall,
             "train_device_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        params = rtr.trainable(D.init_params(0, cfg), "cuda")
        step = rtr.make_step(dtr.loss_fn, params, AdamChain(rtr.leaves(params), 1e-3, 4, 0.05))
        base = prng.prng_key(1)
        r["steps"] = timed_steps((lambda i: rtr.synth_draws(prng.fold_in(base, i), 4, 50),
                                  lambda d: rtr.synth_from_draws(d, 50, "cuda")[:2]), step, 4)
        s = r["steps"]
        log(f"dfn {variant} train_device at 4 x 50 frames on {card}: warm step "
            f"{s['step_s_warm']:.4f} s (cold {s['step_s_cold']:.3f}); host draws "
            f"{s['draws_s']:.4f} s, synthesis on the card {s['synth_card_s']:.4f} s; peak "
            f"{s['peak_gib']:.3f} GiB; train_device(steps=3) {wall:.2f} s")
        init = D.init_params(0, cfg)
        cpu = tree_grads(dtr.loss_fn, init, (noisy, clean), "cpu")
        r["card_vs_cpu"] = trainer_check(f"dfn {variant} loss_fn, card vs CPU",
                                         tree_grads(dtr.loss_fn, init, (noisy, clean), "cuda"), cpu)
        real = D._torch_gru
        D._torch_gru = dfn_no_grad_gru
        try:
            planted = trainer_check(f"dfn {variant} loss_fn, planted: the no_grad GRU",
                                    tree_grads(dtr.loss_fn, init, (noisy, clean), "cuda"), cpu)
        finally:
            D._torch_gru = real
        holes = planted["without_gradient"]
        r["planted_without_gradient"] = len(holes)
        caught = (not planted["ok"] and any("gru" in h for h in holes)
                  and any(h.startswith("enc/") for h in holes))
        if not r["card_vs_cpu"]["ok"] or not caught:
            raise RuntimeError(f"dfn {variant} train: card vs CPU failed or the planted fault "
                               f"was not caught ({holes})")
        out[variant] = r
    no_launches("dfn train")
    return out


def skip_none(opt):
    """Planted fault: ``torch.optim``'s rule in an ``AdamChain`` (a parameter
    whose gradient is ``None`` skips the step, decay and moments included)."""
    step = opt.step

    def skipping(grads):
        keep = [i for i, g in enumerate(grads) if g is not None]
        full = opt.params, opt.mu, opt.nu
        opt.params, opt.mu, opt.nu = ([x[i] for i in keep] for x in full)
        try:
            step([grads[i] for i in keep])
        finally:
            opt.params, opt.mu, opt.nu = full

    opt.step = skipping
    return opt


def dac_check(label: str, card, cpu, frozen: tuple) -> dict:
    """Card against CPU of one DAC loss: the loss (relative), each
    sub-model's gradients (relative L2 over all its leaves: a single leaf,
    such as the output conv's one bias, can sum to near zero), the share of
    RVQ codes that agree (a code at a near-tie flips with the matmul's
    summation order and moves that frame's quantized path), every leaf with
    a gradient but the ``frozen`` ones."""
    import torch
    (lc, gc, names, codes_c), (lh, gh, _, codes_h) = card, cpu
    r = {"loss_rel": abs(lc - lh) / abs(lh), "sub_model_rel": {},
         "without_gradient": [n for n in zero_or_missing(gc, names) if not n.startswith(frozen)]}
    for sub in ("encoder.", "decoder.", "rvq."):
        keys = [i for i, n in enumerate(names) if n.startswith(sub) and not n.startswith(frozen)
                and gh[i] is not None]
        if keys:
            a = torch.cat([gc[i].double().flatten() for i in keys])
            b = torch.cat([gh[i].double().flatten() for i in keys])
            r["sub_model_rel"][sub[:-1]] = float((a - b).norm() / b.norm())
    r["codes_agree"] = (None if codes_c is None else
                        float((codes_c == codes_h).double().mean()))
    r["ok"] = (r["loss_rel"] <= DAC_LOSS_REL and not r["without_gradient"]
               and all(v <= DAC_GRAD_REL for v in r["sub_model_rel"].values()))
    log(f"{label}: loss {lc:.6f} (CPU {lh:.6f}, rel {r['loss_rel']:.2e}); gradients rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in r["sub_model_rel"].items())
        + f"; codes agreeing {r['codes_agree']}; without a gradient: "
        f"{r['without_gradient'] or 'none'} {'ok' if r['ok'] else 'FAIL'}")
    return r


def dac_grads(model, loss, wav, rvq_only: bool = False):
    """(loss, [gradient of each parameter], names, codes or None) of one DAC
    loss (the rvq warm-up's mask where ``rvq_only``)."""
    import torch

    from egregora_tpu_torch.models.dac import train as dtr
    from egregora_tpu_torch.ops.fir import exact_f32
    params = list(model.parameters())
    with exact_f32():
        out = loss(model, wav)
        lv = out[0] if isinstance(out, tuple) else out
        grads = list(torch.autograd.grad(lv, params, allow_unused=True))
    if rvq_only:
        grads = dtr._zero_outside_rvq(model, grads)
    names = [n for n, _ in model.named_parameters()]
    codes = out[1][0].cpu() if isinstance(out, tuple) else None
    return (float(lv.detach()), [None if g is None else g.detach().cpu() for g in grads], names,
            codes)


def dac_train_phase(card: str) -> dict:
    """The DAC trainer on the card: ``train(distilled_config("44khz"),
    steps=10, batch=8, length=16384)`` (bf16: ae 5 steps, proj 1, vq 4, with
    the held-out evaluations) and ``finetune("44khz", steps=2)`` from the
    shipped codec; warm EMA steps at that size with the host's draws and the
    card's synthesis apart; the distilled 44 kHz geometry in float32 with
    seeded weights card against CPU on one batch: ``ae_loss_fn``, ``proj_loss_fn`` (rvq only) and
    ``ema_loss_fn`` with their gradients, and one ``ema_codebook_update``
    from one key; one rvq-only step with the decay made visible, encoder and
    decoder card against CPU, beside the planted fault of ``None``
    gradients skipped as ``torch.optim`` skips them; ``gate_metrics`` of the
    three shipped codecs, card against CPU."""
    import dataclasses

    import numpy as np
    import torch

    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.models.dac import train as dtr
    from egregora_tpu_torch.models.flashsr import distill, prng
    from egregora_tpu_torch.models.optim import AdamChain
    from egregora_tpu_torch.ops.fir import exact_f32
    from egregora_tpu_torch.utils.weights import sorted_leaves

    reset_counts()
    out = {}
    torch.cuda.reset_peak_memory_stats()
    (model, tree), wall = synced_wall(lambda: dtr.train(
        dtr.distilled_config("44khz"), steps=10, batch=8, length=16384, log_every=100))
    out["train"] = {"wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "params_m": sum(p.numel() for p in model.parameters()) / 1e6}
    if not all(np.isfinite(v).all() for _, v in sorted_leaves(tree)):
        raise RuntimeError("dac train: non-finite weights after 10 steps")
    opt = dtr.make_optimizer(model, 1.5e-4, 4)
    ema = [dtr.init_ema_state(model.cfg, model)]
    kb = prng.prng_key(3)

    def ema_step(hr, kr):
        with exact_f32():
            lv, (codes, r_stack) = dtr.ema_loss_fn(model, hr)
            dtr._grad_step(model, opt, lv, False)
        ema[0] = dtr.ema_codebook_update(model.cfg, model, ema[0], codes, r_stack, kr)

    keys = [prng.split(prng.fold_in(kb, i)) for i in range(4)]
    out["steps"] = timed_steps(
        (lambda i: (distill.synth_draws(keys[i][0], 8, 16384), keys[i][1]),
         lambda d: (distill.synth_from_draws(d[0], 16384, 44100, device="cuda")[1], d[1])),
        ema_step, 4)
    _, ft_wall = synced_wall(lambda: dtr.finetune("44khz", steps=2, log_every=100))
    out["finetune_wall_s"] = ft_wall
    s = out["steps"]
    log(f"dac train(distilled 44khz, {out['train']['params_m']:.2f}M parameters, bf16, steps=10, "
        f"batch 8 x 16384) on {card}: {wall:.2f} s with its three held-out evaluations, peak "
        f"{out['train']['peak_gib']:.3f} GiB; a warm vq step (gradient + EMA) "
        f"{s['step_s_warm']:.4f} s (cold {s['step_s_cold']:.3f}), host draws {s['draws_s']:.4f} s, "
        f"synthesis on the card {s['synth_card_s']:.4f} s, peak {s['peak_gib']:.3f} GiB; "
        f"finetune(44khz, steps=2) {ft_wall:.2f} s")

    # the distilled 44 kHz geometry in float32 with seeded_dac_tree's weights
    # (every layer live, where an init's zero output conv leaves the decoder
    # without a gradient; unit-normal codebooks far from any near-tie): the
    # shipped codec's losses are so ill-conditioned that 1e-7 of input noise
    # moves their gradients by up to 4% on the CPU itself
    cfg32 = dataclasses.replace(dtr.distilled_config("44khz"), dtype=torch.float32)
    _, wav = distill.synth_pair_batch(prng.prng_key(21), 2, 16384, sr=44100, device="cpu")
    base = M.DACModel(cfg32).load_jax(seeded_dac_tree(cfg32, 3))
    models = {"cpu": base, "cuda": M.DACModel(cfg32).to("cuda")}
    models["cuda"].load_state_dict(base.state_dict())
    checks = {}
    # each loss's leaves without a gradient by design: the quantizer outside
    # the autoencoder's loss, the encoder and decoder in the rvq warm-up (zeroed),
    # the codebooks where no codebook term is in the loss (EMA moves them)
    for name, loss, rvq_only, frozen in (
            ("ae_loss_fn", dtr.ae_loss_fn, False, ("rvq.",)),
            ("proj_loss_fn", dtr.proj_loss_fn, True, ("encoder.", "decoder.", "rvq.codebook_")),
            ("ema_loss_fn", dtr.ema_loss_fn, False, ("rvq.codebook_",))):
        got = [dac_grads(models[d], loss, wav.to(d), rvq_only) for d in ("cuda", "cpu")]
        checks[name] = dac_check(f"dac {name} (float32), card vs CPU", *got, frozen=frozen)
    with torch.no_grad():
        _, (codes, r_stack) = dtr.ema_loss_fn(base, wav)
    stats = dtr.init_ema_state(cfg32, base)
    stats["counts"][:, ::5] = 0.01                           # dead rows: restarted
    books = {}
    for d in ("cuda", "cpu"):
        m = M.DACModel(cfg32).to(d)
        m.load_state_dict(base.state_dict())
        dtr.ema_codebook_update(cfg32, m, {k: v.to(d) for k, v in stats.items()}, codes.to(d),
                                r_stack.to(d), prng.prng_key(5))
        books[d] = torch.cat([b.detach().cpu().flatten() for b in dtr._books(m)])
    ema_d = float((books["cuda"] - books["cpu"]).abs().max())
    checks["ema_codebook_update_max_abs"] = ema_d
    log(f"dac ema_codebook_update from one key, card vs CPU: books max |d| {ema_d:.2e}")

    def rvq_only_step(device: str, fault: bool):
        """The encoder and decoder after one rvq-only step from ``base``."""
        m = M.DACModel(cfg32).to(device)
        m.load_state_dict(base.state_dict())
        real = dtr.make_optimizer, dtr._zero_outside_rvq

        def make(mm, lr, steps):
            opt = AdamChain(mm.parameters(), DAC_DECAY_LR, steps, 0.1, clip=1.0,
                            weight_decay=DAC_DECAY_WD)
            return skip_none(opt) if fault else opt

        dtr.make_optimizer = make
        if fault:
            dtr._zero_outside_rvq = lambda mm, grads: grads
        try:
            dtr._run_phase(m, "proj", dtr.proj_loss_fn, 1, 2, 16384, DAC_DECAY_LR,
                           prng.prng_key(8), 1, 0, use_ema=True, rvq_only=True)
        finally:
            dtr.make_optimizer, dtr._zero_outside_rvq = real
        return torch.cat([p.detach().cpu().flatten() for n, p in m.named_parameters()
                          if n.startswith(("encoder.", "decoder."))])

    ref = rvq_only_step("cpu", False)
    start = torch.cat([p.detach().flatten() for n, p in base.named_parameters()
                       if n.startswith(("encoder.", "decoder."))])
    decay = {"cpu_norm_ratio": float(ref.norm() / start.norm())}
    for label, fault in (("as trained", False), ("planted: None gradients skipped", True)):
        decay[label] = float((rvq_only_step("cuda", fault) - ref).norm() / ref.norm())
        log(f"dac rvq-only step (lr {DAC_DECAY_LR}, weight decay {DAC_DECAY_WD}), {label}: "
            f"encoder and decoder card vs CPU rel {decay[label]:.2e} (limit {DAC_DECAY_REL})")
    decay_ok = (decay["as trained"] <= DAC_DECAY_REL < decay["planted: None gradients skipped"]
                and decay["cpu_norm_ratio"] < 1.0)
    out["rvq_only_decay"] = decay

    gates = {}
    for mt in ("44khz", "24khz", "16khz"):
        g_card = dtr.gate_metrics(dtr.shipped_model(mt, "cuda"))
        g_cpu = dtr.gate_metrics(dtr.shipped_model(mt, "cpu"))
        ok = (abs(g_card["mean_snr"] - g_cpu["mean_snr"]) <= DAC_GATE_SNR_DB
              and abs(g_card["worst_snr"] - g_cpu["worst_snr"]) <= DAC_GATE_SNR_DB)
        gates[mt] = {"card": g_card, "cpu": g_cpu, "ok": ok}
        rec = DAC_GATE_RECORD[mt]
        log(f"dac gate {mt} (bf16) on {card}: mean SNR {g_card['mean_snr']:+.2f} / worst "
            f"{g_card['worst_snr']:+.2f} dB, mean LSD {g_card['mean_lsd']:.2f} dB; CPU "
            f"{g_cpu['mean_snr']:+.2f} / {g_cpu['worst_snr']:+.2f} dB, {g_cpu['mean_lsd']:.2f} dB; "
            f"the JAX test's record {rec[0]:+.2f} / {rec[1]:+.2f} dB {'ok' if ok else 'FAIL'}")
    out.update(checks=checks, gates=gates)
    bad = [k for k, v in checks.items() if isinstance(v, dict) and not v["ok"]]
    if bad or ema_d > 1e-4 or not decay_ok or not all(g["ok"] for g in gates.values()):
        raise RuntimeError(f"dac train: failed {bad}, ema {ema_d:.2e}, decay {decay}, gates "
                           f"{ {k: g['ok'] for k, g in gates.items()} }")
    no_launches("dac train")
    from egregora_tpu_torch.ops import snake as sn
    out["snake_launches"] = sn.launches
    if not sn.launches:
        raise RuntimeError("dac train: the Snake kernel was not launched")
    return out


# the guarded DAC runs (``dac_guarded_phase``): a few fine-tune steps at
# the JAX CLI's fine-tune lr, then a run at an lr that wrecks the codec
# (Adam moves every weight by ~lr a step), which must not ship
DAC_GUARD_STEPS, DAC_GUARD_LR, DAC_GUARD_BAD_LR = 4, 5e-5, 1e-2
# a gate read on the shipped float16 file against the same codec's gate
# read in float32 before it was written, dB (and LSD dB): the float16
# round trip of the weights; an unshipped incumbent reads the same file
DAC_GUARD_F16_DB = 0.1


def file_digest(path) -> str:
    """SHA-256 of a file's bytes, or "absent"."""
    import hashlib
    from pathlib import Path
    p = Path(path)
    return hashlib.sha256(p.read_bytes()).hexdigest() if p.exists() else "absent"


def always_ship(model_type: str, before: dict, model, out=None) -> bool:
    """A planted fault of ``_guarded_ship``: the candidate is written
    whatever the gate says."""
    from egregora_tpu_torch.models.dac import train as dtr
    after = dtr.gate_metrics(model)
    print(f"[dac-guarded:{model_type}] AFTER  gate: {after}", flush=True)
    dtr.save_pretrained(model, dtr.output_path(model_type, out), cfg=model.cfg)
    return True


def dac_guarded_phase(card: str) -> dict:
    """Phase 28b, in the trainers' temporary ``EGREGORA_TPU_WEIGHTS``: two
    guarded fine-tunes of the 44 kHz codec in a row on the card.  The first
    (``DAC_GUARD_STEPS`` steps at ``DAC_GUARD_LR``) is judged against the
    shipped codec and writes ``output_path`` exactly where ``should_ship``
    says so; ``build_dac`` then serves what it wrote ("trained"), or still
    the shipped codec.  The second (2 steps at ``DAC_GUARD_BAD_LR``) is
    judged against what the first left served (its "before" within
    ``DAC_GUARD_F16_DB`` of the first's "after" where the first shipped, of
    its "before" where not) and must write nothing.  The planted fault, a
    ``_guarded_ship`` that writes whatever the gate says, must be caught by
    the same checks on the second run."""
    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.models.dac import train as dtr
    from egregora_tpu_torch.nodes.enhance_extras import Egregora_DAC_Encode

    mt = "44khz"
    path = dtr.output_path(mt)
    before_pkg = package_digest()
    gates = []
    real_gate, real_ship = dtr.gate_metrics, dtr._guarded_ship

    def recording(model):
        gates.append(real_gate(model))
        return gates[-1]

    def guarded(steps: int, lr: float):
        gates.clear()
        shipped, wall = synced_wall(lambda: dtr.guarded_finetune(
            mt, steps=steps, batch=8, length=16384, lr=lr, seed=10, scan_size=1))
        return shipped, wall, list(gates)

    def served():
        M._CACHE.pop(mt, None)
        Egregora_DAC_Encode._MODELS.pop(mt, None)
        return M.build_dac(mt)[0]

    def near(a: dict, b: dict) -> float:
        return max(abs(a[k] - b[k]) for k in ("mean_snr", "worst_snr", "mean_lsd"))

    def second_run_faults(shipped: bool, gate_before: dict, digest: str, ref: dict) -> list:
        out = []
        if shipped:
            out.append("the second run shipped a wrecked codec")
        if file_digest(path) != digest:
            out.append(f"the second run wrote {path}")
        if near(gate_before, ref) > DAC_GUARD_F16_DB:
            out.append(f"the second run's incumbent reads {gate_before}, not {ref}")
        return out

    dtr.gate_metrics = recording
    try:
        if served().weight_source != "shipped":
            raise RuntimeError("dac guarded: a trained codec is served before any guarded run")
        ship1, wall1, (before1, after1) = guarded(DAC_GUARD_STEPS, DAC_GUARD_LR)
        faults = []
        if ship1 != dtr.should_ship(before1, after1) or path.exists() != ship1:
            faults.append(f"the first run's decision {ship1} and file ({path.exists()}) disagree "
                          f"with should_ship {dtr.should_ship(before1, after1)}")
        model = served()
        want = "trained" if ship1 else "shipped"
        if model.weight_source != want:
            faults.append(f"build_dac serves {model.weight_source}, not {want}")
        if ship1 and not same_tree(dtr.params_tree(model), dtr.load_pretrained(mt, path)[1]):
            faults.append("build_dac's codec is not the file the first run wrote")
        digest = file_digest(path)
        ref = after1 if ship1 else before1
        ship2, wall2, (before2, after2) = guarded(2, DAC_GUARD_BAD_LR)
        faults += second_run_faults(ship2, before2, digest, ref)
        kept = file_digest(path) == digest
        dtr._guarded_ship = always_ship
        try:
            bad_ship, _, (bad_before, bad_after) = guarded(2, DAC_GUARD_BAD_LR)
        finally:
            dtr._guarded_ship = real_ship
        caught = second_run_faults(bad_ship, bad_before, digest, ref)
    finally:
        dtr.gate_metrics = real_gate
        M._CACHE.pop(mt, None)
        Egregora_DAC_Encode._MODELS.pop(mt, None)
    after_pkg = package_digest()

    def fmt(g):
        return f"{g['mean_snr']:+.3f} / {g['worst_snr']:+.3f} dB, LSD {g['mean_lsd']:.3f} dB"

    log(f"dac guarded run 1 (44khz, {DAC_GUARD_STEPS} steps at lr {DAC_GUARD_LR:g}, batch 8 x "
        f"16384) on {card}: gate before {fmt(before1)}, after {fmt(after1)}; "
        f"{'SHIPPED' if ship1 else 'not shipped'} in {wall1:.2f} s; build_dac serves "
        f"{model.weight_source} ({path if ship1 else 'the shipped file'})")
    log(f"dac guarded run 2 (2 steps at lr {DAC_GUARD_BAD_LR:g}): gate before {fmt(before2)} "
        f"(run 1's {'after' if ship1 else 'before'} {fmt(ref)}: max |d| {near(before2, ref):.2e}, "
        f"limit {DAC_GUARD_F16_DB:g}), after {fmt(after2)}; "
        f"{'SHIPPED' if ship2 else 'not shipped'} in {wall2:.2f} s; {path.name} "
        f"{('still absent' if digest == 'absent' else 'unchanged') if kept else 'CHANGED'}"
        f"; planted fault "
        f"(_guarded_ship writes whatever the gate says): "
        f"{'rejected: ' + '; '.join(caught) if caught else 'NOT REJECTED'}; egregora_tpu/ "
        f"sha256 {before_pkg[:16]} before, {after_pkg[:16]} after")
    if not caught:
        faults.append("the guarded-run checks do not reject the always-ship fault")
    if after_pkg != before_pkg:
        faults.append("a file under egregora_tpu/ changed")
    if faults:
        raise RuntimeError("dac guarded: " + "; ".join(faults))
    no_launches("dac guarded")
    return {"run1": {"before": before1, "after": after1, "shipped": ship1, "wall_s": wall1,
                     "served": model.weight_source},
            "run2": {"before": before2, "after": after2, "shipped": ship2, "wall_s": wall2},
            "planted_caught": caught}


def trainers_phase(card: str) -> dict:
    """Phases 26-28 in a temporary ``EGREGORA_TPU_WEIGHTS``, with the JAX
    package's files hashed before and after (equal)."""
    import os
    import shutil
    import tempfile
    from pathlib import Path
    before = package_digest()
    prev = os.environ.get("EGREGORA_TPU_WEIGHTS")
    tmp = tempfile.mkdtemp(prefix="egregora_train_")
    os.environ["EGREGORA_TPU_WEIGHTS"] = tmp
    try:
        t0 = time.perf_counter()
        out = {"rnnoise": rnnoise_train_phase(card)}
        out["rnnoise"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["deepfilternet"] = dfn_train_phase(card)
        out["deepfilternet"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dac"] = dac_train_phase(card)
        out["dac"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dac_guarded"] = dac_guarded_phase(card)
        out["dac_guarded"]["phase_s"] = time.perf_counter() - t0
        written = sorted(str(p.relative_to(tmp)) for p in Path(tmp).rglob("*") if p.is_file())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if prev is None:
            os.environ.pop("EGREGORA_TPU_WEIGHTS", None)
        else:
            os.environ["EGREGORA_TPU_WEIGHTS"] = prev
    after = package_digest()
    log(f"trainers: phases {out['rnnoise']['phase_s']:.1f} / {out['deepfilternet']['phase_s']:.1f}"
        f" / {out['dac']['phase_s']:.1f} / {out['dac_guarded']['phase_s']:.1f} s; files written "
        f"under the temporary weights dir: "
        f"{written or 'none'}; egregora_tpu/ sha256 {before[:16]} before, {after[:16]} after")
    if after != before:
        raise RuntimeError("trainers: a file under egregora_tpu/ changed")
    return out



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this script runs only on the card", file=sys.stderr, flush=True)
        return 2
    try:
        import egregora_tpu_torch.utils.cuda_build  # noqa: F401  (the package is here)
    except ImportError as e:
        print(f"chip_smoke: the egregora_tpu_torch package is missing ({e}); run "
              "from the root of a checkout of the repository", file=sys.stderr, flush=True)
        return 2

    import os
    os.environ["EGREGORA_TPU_OFFLINE"] = "1"     # hermetic: no first-use weight download
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    # the plain versions' float32 convs and matmuls in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the bootstrap's build step (one nvcc a source, together): on a fresh
    # checkout, the cold build as a user's first bootstrap meets it
    from egregora_tpu_torch import install
    t0 = time.perf_counter()
    built = install.build_native(torch.device("cuda"), card)
    log(f"build: {', '.join(f'{n} in {s:.1f} s' for n, s in built.items())} "
        f"(nvcc, sm_90a, in parallel: {time.perf_counter() - t0:.1f} s)")

    wire_phase()
    ptxas = ptxas_report()
    mrf_ptxas = mrf_ptxas_report()
    edge_ptxas = edge_ptxas_report()
    flops = {}
    attn_rows_, flops["attention"] = flop_checked("attention phase", attention_phase)
    mrf_rows_, flops["mrf"] = flop_checked("mrf phase", mrf_phase)
    repair = repair_phase()
    k4_rows = k4_phase()
    snake = snake_phase()
    edge, flops["edge kernels"] = flop_checked("edge kernels phase", edge_kernels_phase)
    reference_phase()
    nodes = node_phase()
    served_reference_phase()
    pipe = pipeline_phase()
    converted = converted_phase()
    evals = eval_phase()
    labs = lab_phase()
    enhance = {"rnnoise": rnnoise_phase(), "fat llama": fatllama_phase(), "wpe": wpe_phase()}
    chain = chain_phase()
    dfn = dfn_phase(card)
    dac = dac_phase(card)
    entry = entry_phase(card)
    bootstrap = bootstrap_phase(card)
    example = example_phase(card)
    # phases 20 and 22 write where the trainers write by default, in a
    # weights root of their own, which 22b serves through the node
    trained_root = tempfile.mkdtemp(prefix="egregora_trained_")
    try:
        trained = train_phase(card, trained_root)
        train_attn = collections.Counter()
        for key in ("distilled", "full"):
            train_attn.update(trained[key]["attn_counts_all"])
        attn_grads = attn_grad_phase(set(train_attn))
        voc_distill = vocoder_distill_phase(trained_root)
        served = served_trained_phase(card, trained_root)
    finally:
        shutil.rmtree(trained_root, ignore_errors=True)
    resumed = checkpoint_phase()
    evaluated = evaluate_phase()
    meshed = mesh_phase()
    trainers = trainers_phase(card)

    attn_counts = collections.Counter(pipe["counts"])
    attn_paths = {"full config (seeded weights)": pipe["launches"]}
    for label, r in list(nodes.items()) + [(f"converted trio, {k}", r) for k, r
                                           in converted["paths"].items()]:
        attn_counts.update(r["counts"]["attn_rows"])
        attn_paths[label] = sum(r["counts"]["attn_rows"].values())
    fused = collections.Counter(nodes["HiFi-GAN trio, fused MRF"]["counts"]["mrf_fused_cm"])
    conv_fused = converted["paths"]["fused MRF"]["counts"]["mrf_fused_cm"]
    fused.update(conv_fused)
    rows = collections.Counter(nodes["HiFi-GAN trio, rows MRF"]["counts"]["mrf_rows"])
    conv_rows = converted["paths"]["rows MRF"]["counts"]["mrf_rows"]
    rows.update(conv_rows)
    chain_attn = chain["counts"]["attn_rows"]
    attn_counts.update(chain_attn)
    attn_paths["full chain"] = sum(chain_attn.values())
    entry_attn, entry_attn_paths = entry_launches(entry, "attn_rows")
    attn_counts.update(entry_attn)
    attn_paths.update(entry_attn_paths)
    example_attn = example["counts"]["attn_rows"]
    attn_counts.update(example_attn)
    attn_paths["full-chain example"] = sum(example_attn.values())
    trainer_attn = {"train: distilled config, fixed batch": trained["distilled"]["attn_counts_all"],
                    "train: full config, fixed batch": trained["full"]["attn_counts_all"],
                    "train: distill() entry": trained["distill_entry"]["attn_counts"],
                    "train: distill_vocoder()": voc_distill["attn_counts"]}
    for label, counts in trainer_attn.items():
        attn_counts.update(counts)
        attn_paths[label] = sum(counts.values())
    served_fused, served_rows = collections.Counter(), collections.Counter()
    for label, r in served.items():
        attn_counts.update(r["counts"]["attn_rows"])
        attn_paths[f"served: {label}"] = sum(r["counts"]["attn_rows"].values())
        served_fused.update(r["counts"]["mrf_fused_cm"])
        served_rows.update(r["counts"]["mrf_rows"])
    gen = torch.Generator().manual_seed(1)
    heads = SERVED_ATTN[0]          # the istft trio's one attention block
    measured = {(r["bh"], r["n"], r["d"]) for r in attn_rows_}
    attn_rows_ += [attn_shape_row(bh // heads, heads, n, d, gen)
                   for bh, n, d in set(chain_attn) | set(entry_attn) | set(example_attn)
                   if (bh, n, d) not in measured]
    measured = {(r["bh"], r["n"], r["d"]) for r in attn_rows_}
    train_shapes = set().union(*(set(c) for c in trainer_attn.values()))
    attn_rows_ += [attn_shape_row(bh, 1, n, d, gen) for bh, n, d in sorted(train_shapes)
                   if (bh, n, d) not in measured]
    k4_counts = collections.Counter(evals["k4_counts"])
    k4_counts.update(chain["counts"]["iir_lowpass"])
    k4_paths = {**evals["k4_by_path"], "full chain": sum(chain["counts"]["iir_lowpass"].values())}
    entry_k4, entry_k4_paths = entry_launches(entry, "iir_lowpass")
    k4_counts.update(entry_k4)
    k4_paths.update(entry_k4_paths)
    for label, r in (("full-chain example", example), ("bootstrap warmups", bootstrap)):
        k4_counts.update(r["counts"]["iir_lowpass"])
        k4_paths[label] = sum(r["counts"]["iir_lowpass"].values())
    entry_fused, entry_fused_paths = entry_launches(entry, "mrf_fused_cm")
    entry_rows, entry_rows_paths = entry_launches(entry, "mrf_rows")
    k4_measured = {(r["c"], r["n"]) for r in k4_rows}
    mrf_measured = {(r["entry"], r["b"], r["c"], r["t"]) for r in mrf_rows_}
    unmeasured = ([("iir_lowpass",) + s for s in k4_counts if s not in k4_measured]
                  + [("mrf_fused_cm",) + s for s in entry_fused
                     if ("mrf_fused_cm",) + s not in mrf_measured]
                  + [("mrf_rows",) + s for s in entry_rows if ("mrf_rows",) + s not in mrf_measured])
    if unmeasured:
        raise RuntimeError(f"launches at shapes no kernel phase measured: {unmeasured}")
    k1b_counts = labs["attn_flash_lab"]["counts"]["flash_online"]
    k3_counts = labs["edge_conv_lab"]["counts"]["conv3x3_out1"]
    kernels = [attn_entry(attn_rows_, dict(attn_counts), attn_paths),
               mrf_entry("mrf_fused_cm", mrf_rows_, dict(fused + entry_fused + served_fused),
                         {"HiFi-GAN trio, fused MRF": sum(fused.values()) - sum(conv_fused.values()),
                          "converted trio, fused MRF": sum(conv_fused.values()),
                          **entry_fused_paths,
                          "served: trained HiFi-GAN trio, fused MRF": sum(served_fused.values())}),
               mrf_entry("mrf_rows", mrf_rows_, dict(rows + entry_rows + served_rows),
                         {"HiFi-GAN trio, rows MRF": sum(rows.values()) - sum(conv_rows.values()),
                          "converted trio, rows MRF": sum(conv_rows.values()),
                          **entry_rows_paths,
                          "served: trained HiFi-GAN trio, rows MRF": sum(served_rows.values())}),
               iir_entry(k4_rows, dict(k4_counts), k4_paths),
               edge_entry("flash_online", edge["flash_online"], k1b_counts,
                          {"attn_flash_lab": sum(k1b_counts.values())}),
               edge_entry("conv3x3_out1", edge["conv3x3_out1"], k3_counts,
                          {"edge_conv_lab": sum(k3_counts.values())})]
    kernels[5]["launches_by_route"] = labs["edge_conv_lab"]["conv3x3_out1_by_route"]
    kernels[0]["launches_streaming"] = pipe["launches_streaming"]
    kernels[0]["training_backward"] = attn_grads
    for k, lib in ((kernels[0], "attn_rows"), (kernels[4], "attn_online")):
        k["ptxas"] = [r for r in ptxas if r["library"] == lib]
    for k, rounding in ((kernels[1], "Circ"), (kernels[2], "Rows")):
        k["ptxas"] = [r for r in mrf_ptxas if r["rounding"] == rounding]
    kernels[3]["ptxas"] = edge_ptxas["iir_lowpass"]
    kernels[5]["ptxas"] = edge_ptxas["conv3x3_out1"]
    kernels.append(snake_entry(snake, {"dac phase": dac["snake_launches"],
                                       "dac train": trainers["dac"]["snake_launches"]}))
    kernels[0]["repair_shapes"] = repair["attn"]
    kernels[1]["repair_shapes"] = [r for r in repair["mrf"] if r["entry"] == "mrf_fused_cm"]
    kernels[2]["repair_shapes"] = [r for r in repair["mrf"] if r["entry"] == "mrf_rows"]
    for k in kernels:
        if not k["launches"]:
            raise RuntimeError(f"{k['name']} was not launched on its main path")
    log("node paths: " + "; ".join(f"{label}: warm one-shot {r['wall_s']:.3f} s wall "
                                   f"(RTF {r['rtf']:.1f}x)" for label, r in nodes.items()))
    log("converted trio (published geometry): " + "; ".join(
        f"{label}: warm one-shot {r['wall_s']:.3f} s wall (RTF {r['rtf']:.1f}x)"
        for label, r in converted["paths"].items()))
    log(f"eval nodes, warm on {card}: " + "; ".join(
        f"{label} {r['warm_wall_s']:.4f} s" for label, r in evals["nodes"].items()
        if "warm_wall_s" in r))
    log(f"enhance chain on {card}: " + json.dumps(
        {"rnnoise": {k: v for k, v in enhance["rnnoise"].items() if not k.startswith("planted")},
         "fat llama": enhance["fat llama"]["node"], "wpe": enhance["wpe"],
         "full chain": {k: v for k, v in chain.items() if k != "counts"}}))
    log(f"deepfilternet and dac on {card}: " + json.dumps(
        {"deepfilternet": {k: v for k, v in dfn.items() if not k.startswith("planted")},
         "dac": dac}))
    log(f"entry points on {card}: " + json.dumps(
        {"warm_wall_s": entry["walls"], "flashsr_breakdown_s": entry["flashsr_breakdown_s"],
         "trace": entry["trace"],
         "workflow_timing_summary": entry["workflow"]["timing_summary"]}))
    log(f"bootstrap and full-chain example on {card}: " + json.dumps(
        {"bootstrap_warm_wall_s": bootstrap["wall_s"], "warmups_in_process_s": bootstrap["warmups_s"],
         "planted": {f["fault"]: f["rc"] for f in bootstrap["faults"]},
         "example": {k: v for k, v in example.items() if k != "counts"}}))
    log(f"training on {card}: " + json.dumps(
        {"distilled": {k: v for k, v in trained["distilled"].items() if k != "attn_counts_all"},
         "full": {k: v for k, v in trained["full"].items() if k != "attn_counts_all"},
         "distill_entry_wall_s": trained["distill_entry"]["wall_s"],
         "distill_vocoder": {k: voc_distill[k] for k in ("wall_s", "metrics")},
         "checkpoint": resumed, "evaluate": evaluated,
         "mesh": {"one_process": meshed["one_process"], "wall_s": meshed["wall_s"],
                  "ranks": meshed["ranks"]}}, default=str))
    log(f"trainers on {card}: " + json.dumps(
        {"rnnoise": {k: trainers["rnnoise"][k] for k in ("train_device", "train", "steps",
                                                          "shipped_snr_gain_db", "phase_s")},
         "deepfilternet": {v: {k: trainers["deepfilternet"][v][k] for k in (
             "train_device_wall_s", "train_device_peak_gib", "steps")} for v in DFN_VARIANTS},
         "dac": {k: trainers["dac"][k] for k in ("train", "steps", "finetune_wall_s",
                                                  "rvq_only_decay", "phase_s")},
         "dac_gate": {mt: {"card": g["card"], "cpu": g["cpu"]}
                      for mt, g in trainers["dac"]["gates"].items()},
         "dac_guarded": {k: trainers["dac_guarded"][k] for k in ("run1", "run2", "phase_s")}},
        default=str))
    log(f"served trained trios on {card}: " + json.dumps(
        {label: {k: r[k] for k in ("max_abs_vs_trained_file", "planted_max_abs")}
         for label, r in served.items()}))
    for label, r in served.items():
        flops[label] = r["flops"]
    log("FLOP_LOG against the launches' FLOPs: " + json.dumps(
        {phase: {k: [f["flop_log"][k], f["reckoned"][k]] for k in f["flop_log"]}
         for phase, f in flops.items()}))
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
