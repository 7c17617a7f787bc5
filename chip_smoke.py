#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ditsep_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--group 1|2] [--phase NAME ...]

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, all at once) and runs thirty-six phases, each printing
JSON lines and, after it, ``{"phase": NAME, "phase_s": seconds}``; any
failure raises and the exit code is non-zero. ``--group 1`` runs phases
2-22 and ``--group 2`` phases 23-36 (``GROUPS``: each group fits one
900 s chip call); ``--phase`` runs the named phases alone:

1. device   -- card name and power limit (nvidia-smi), kernel build time;
2. kernel   -- fir_down2d against its plain PyTorch version at the 12
               distinct flagship shapes, f32 and bf16, NCHW and
               channels_last, plus an odd shape and an asymmetric kernel,
               and its scalar path against its vector path bit for bit
               wherever the plan takes the vector one; then
               ``scripts/fir_timing.py``: the kernel, the plain version,
               one library call and the byte bound at the 12 main-path
               shapes at batch 1 and 4 (NCHW, f32 and bf16; channels_last
               at level 0) and the sums over the 18 launches of a
               forward;
3. fused_bias_act -- fba_fwd and fba_bwd against their plain versions in
               f32 and bf16, channel axis -1 and 1, at an odd shape and at
               (4, 256, 576, 128) (a level-0 activation of the flagship
               U-Net at batch 4), each launch counted; times against the
               byte bound; then the op's path, ``ops.fused_act.
               fused_leaky_relu`` forward and backward through autograd;
4. conv3x3  -- the two kernels' launch plans (slice width, M tile, shared
               bytes, CTAs; ptxas registers and spills), conv3x3_9tap and
               conv3x3_async_halo against their plain version at two odd
               small shapes (ragged tiles, C2 = 48 and 160) and at the
               deepest C each took before (288 and 144), then the conv
               probe's path
               (``ditsep_tpu_torch.scripts.conv_probe``): both kernels at
               the probe shape, batch 1, against the plain version, borders
               exactly 0, and the three timed rows (cuDNN, 9-tap, async
               halo) at batch 16; then both kernels against the plain
               version at batch 16, the timed rows' own inputs;
5. parity   -- the trained nf=32 checkpoint separates a 1 s mixture with
               the same explicit noise on the card (TF32 off) and on the
               CPU; they agree within 1e-3 (and bf16 on the card is
               compared with f32 by SI-SDR);
6. flagship -- the nf=128 diffsep_icassp config with seeded random weights
               through ``ditsep_tpu_torch.cli.separate`` on 8.415 s, 8 kHz
               WAVs at N=30 (NFE 60), then ``DiffSepTrainer.separate`` on a
               batch in f32 and in bf16 with the same noise and weights
               (zero-init layers redrawn at unit scale; the stems'
               SI-SDR and one score forward's max|bf16 - f32| / max|f32|
               at three times printed; the same distance of a batch-1
               forward on seeded inputs held within 0.5-1.5x of the JAX
               package's, tests/test_torch_bf16.py), and a profile of
               one f32 forward; the CLI's ``separate`` calls are timed
               one by one, and one call of the CLI's trainer at N=2 is
               profiled (the device's idle share of a batch-1 call);
7. train    -- fir_up2d (fir_down2d's backward) against its plain version
               at the 12 down-block shapes of the train step, f32 and
               bf16, NCHW and channels_last, plus an odd shape and an
               asymmetric kernel, bit for bit, and its times
               (``scripts/fir_timing.py --backward``: kernel, plain,
               ``F.conv_transpose2d``, byte bound); the gradient through
               ``ops.fir.downsample_2d`` on the card; two train steps of
               the trained nf=32 checkpoint on the card (TF32 off) against
               the CPU with the same batch and draws; the flagship
               training path, ``ditsep_tpu_torch.cli.train_diffsep`` on
               diffsep_icassp at batch 6 x 40,960 samples for 4 steps
               (two epochs, each ending in a validation with a PC-10
               separation), its steps/s, peak memory, launches, checkpoints
               and EMA export (loaded back and separating a file); and a
               profile of one train step;
8. masked_parity -- the trained nf=32 checkpoint as it was trained
               (mask_padding on): two items of different lengths padded to
               one, with ``lengths``, on the card (TF32 off) against the CPU
               with the same noise, within 1e-3;
9. evaluate_trained -- ``ditsep_tpu_torch.cli.evaluate`` on that checkpoint
               over 8 synthetic items of 2-6 s: masked with the default
               buckets and with one bucket (every item padded past its own
               frame block), then unmasked on the first 4 items with the
               default buckets and with one; mean SI-SDR / SI-SIR /
               SI-SAR / PESQ / STOI, the buckets, runtime and launches of
               each, the masked ones held to the SI-SDR bars of PERF.md;
10. evaluate -- the same CLI at the flagship width (diffsep_icassp, seeded
               random weights) over 2 items, batch 4, N=30, unmasked and
               masked, without warm-up calls: the reference schema,
               finite metrics, runtime of each mode and the host seconds
               of the metrics;
11. longform -- ``cli.separate --chunk-seconds 4 --overlap-seconds 1`` at the
               flagship width on one 7 s file: its length and its windows'
               launches;
12. upsample_2d -- ``ops.fir.upsample_2d`` on the card against the CPU at the
               flagship's 6 up-path shapes, within 1e-5 (TF32 off);
13. families -- the other SDE families and samplers: on the card (TF32
               off) against the CPU with the same explicit noise, nf=32
               with 4 levels, seeded weights, 1 s, within 1e-3 relative:
               diffsep_ouve (PC with ald), diffsep_sb (the bridge's 'ode'
               and 'sde'), enhancement (PriorMix, PC with ald2, 16 kHz),
               ab2 on diffsep and ``ode_sample`` rk4 on diffsep_ouve; then
               each family at its config's full width through
               ``cli.separate`` on 2 written WAVs: diffsep_ouve and
               diffsep_sb (nf=64, 8.415 s at 8 kHz, NFE 60 / 30),
               enhancement (nf=128, 3 s at 16 kHz, NFE 60) and
               diffsep_icassp ``--sampler ab2`` (NFE 30): NFE, peak
               memory, 18 x NFE x 3 launches, each ``separate`` call's
               time (the steady state: the calls after the first) and a
               profiled call at N=2, as the flagship's;
14. families_train -- ``cli.train_diffsep`` on the card: diffsep_sb (the EDM
               loss) at batch 6 x 40,960 samples and enhancement (PriorMix,
               init hack 4) at batch 4 x 3 s crops of a VCTK-layout
               directory of synthetic WAVs, 2 steps each, validating at
               N=10: steps/s, peak memory, launches; then two EDM train
               steps at nf=32 on the card against the CPU with the same
               batches and draws, each step's gradient leaf by leaf within
               1e-3 of its max|ref|;
15. media   -- ``cli.train_diffsep --demo-every 1`` at the flagship
               width (diffsep_icassp, batch 6 x 40,960 samples, one step,
               a demo separation of the first two validation items, then
               the validation and its media, PC N=5): fir_down2d's
               launches grow by the demo's and validation's NFE x 18 (NFE
               from the sampler's return), fir_up2d launches in the step, no
               callback or media call failed; the TensorBoard events read
               back where tensorboardX is installed (the demo/* and val/*
               audio with JAX's names and lengths, val/spectrograms with
               matplotlib); the callback through the API with a recording
               logger, its stems ``trainer.separate``'s with the same
               generator state bit for bit; ``cli.evaluate --save-samples
               2 --save-figures 2`` at the flagship width (the wavs, and
               the PDFs where matplotlib is installed); ``cli.
               unwrap_model`` on the run's checkpoints, then ``cli.separate
               --params`` on its .npz against a direct separate with the
               run's EMA and the same generator, bit for bit;
16. import  -- a Lightning-layout DiffSep checkpoint at the flagship width
               (written with torch.save: the score network under
               ``score_model.backbone.``, the sigmas buffer, torch_ema's
               shadows in parameter order) loaded by
               ``import_diffsep_ema`` into a fresh nf=128 model on the
               card: the parameters are the shadows bit for bit, and a
               separation with matched noise equals the .npz-loaded
               weights'; ``utils.hub.load_reference_diffsep_params`` on
               the same file gives the ``import_params`` route's weights
               bit for bit; the full-width OobleckVAE from a weight_g /
               weight_v state dict, encode and decode equal to the
               .npz-loaded VAE's;
17. sepformer -- the SepFormer baseline at sepformer-wsj02mix's widths,
               seeded weights: ``ditsep_tpu_torch.cli.sepformer_baseline``
               on 4 written mixtures of 2-8.415 s at 8 kHz (the stems
               written, the parameter count, seconds a file, peak GiB, 0
               launches), then a small SepFormer card vs CPU (TF32 off,
               1e-3 relative);
18. backbones -- the Conv-TasNet TCN at its defaults, DPTNet with LSTM and
               with GRU, DiffuSE at 64 x 30: one forward each card vs CPU
               (1e-3 relative) and its time; 0 launches;
19. ncsnpp_options -- NCSN++'s DDPM blocks with FIR resampling and BigGAN
               blocks with both pyramids 'residual', each a score model at
               the flagship's width, one forward at batch 4 x 8.415 s in
               f32 (ms, fir_down2d 12 launches a forward as the code
               predicts), and at nf=16 card vs CPU (1e-3 relative);
20. streaming_bench -- ``scripts/streaming_bench.py`` on 8 s of stream
               (the flagship in bf16, N=30, 8 s windows): its JSON line and
               fir_down2d's launches, 18 x the NFE of every window;
21. facodec -- FACodec, which no kernel of the port lies on:
               ``ditsep_tpu_torch.cli.facodec_demo`` (its ``main``) at the
               shipped widths with seeded weights on 4 written 16 kHz
               files of 2-8.415 s (seconds a file after the first, peak
               GiB, codes in [0, 1024) of shape (T / 200, 6), finite audio
               of each input's length, 0 launches, the WAVs read through
               the native library), one forward of it profiled (device
               busy ms, idle share); a small codec card vs CPU, TF32 off
               (the encoder, the decoder's ``return_info`` with its codes
               equal wherever the top-2 cosine margin clears 1e-4,
               ``vq2emb`` and ``decode_with_timbre``, 1e-3 relative); then
               ``cli.model_info --facodec`` and ``--config diffsep_icassp``
               (the meta device) against the JAX package's counts;
22. learning -- fir_down2d and fir_up2d at the learning loop's shapes
               (batch 8, 256 frames) against their plain versions bit
               for bit, each vector path against its scalar path; then
               the loop: ``ditsep_tpu_torch.examples.
               train_synthetic`` (its ``main``) at the long run's widths
               (nf=32, 4 levels, attention at 32, batch 8 x 4 s, lr
               5e-4), seeded weights, 200 steps on 256 items, evaluated at
               PC N=5 after step 100 and at the end, its EMA written to a
               .npz: every loss finite, the mean of steps 151-200 below
               that of steps 1-50, fir_down2d 18 and fir_up2d 12 launches
               a step and fir_down2d 180 an evaluation, the export loaded
               into a model of other weights equal to the EMA bit for
               bit; then ``examples.nfe_study`` on that export with 2
               seeds of pc_N30 and pc_N15 (fir_down2d 9 x NFE a
               separation); steps/s;
23. latent_kernel -- fir_down2d and fir_up2d at every latent-U-Net shape
               (36 and 20 latent frames, batch 1, 4 and 16, f32 and bf16)
               against their plain versions bit for bit, fir_down2d on its
               scalar path (fir_up2d's vector path, at level 0 in f32,
               equal to its scalar one); their times there
               (``scripts/fir_timing.py --latent [--backward]``);
24. latent_parity -- a small latent_diffsep_ouve (VAE 32 channels, hop 64,
               16 latent channels; U-Net nf=32), seeded weights, on the
               card (TF32 off) against the CPU with the same draws: VAE
               encode (mode and sample), decode and ``separate_latent`` at
               N=3 within 1e-3 relative; two ``train_step_latent`` steps
               at the train-step bars;
25. latent_flagship -- latent_diffsep_ouve at full width (VAE hop 2048, 64
               latent channels; U-Net nf=128), seeded weights:
               ``cli.evaluate --latent`` on 4 synthetic 8.415 s items at
               batch 4, N=30; ``separate_latent`` at batch 4 in f32 and
               bf16 with the same draws (the bf16 stems at least
               ``BF16_SI_SDR_BAR_DB`` from the f32 ones by SI-SDR, the
               worst item and source); one call split into VAE encode,
               sampler and VAE decode; one replayed at N=2 under the
               profiler;
26. latent_train -- ``cli.train_diffsep_latent`` at the config's batch 16
               of 5 s crops, 4 steps and one validation (steps/s, peak
               memory, launches), then ``cli.cache_latents`` on 2 items
               at N=30;
27. ldm_parity -- the small latent config of latent_parity with a
               two-scale Encodec discriminator (filters 8), seeded weights,
               on the card (TF32 off) against the CPU with the same inputs
               and draws: the perceptual MRSTFT at the ldm config's 7
               resolutions and its gradient, the discriminator's logits
               and feature maps, gen -> disc -> gen ``LDMTrainer`` steps
               and an ``AutoencoderTrainer`` gen + disc pair at the
               train-step bars;
28. ldm_train -- the decoder finetune at full width (the ldm config:
               VAE hop 2048, 64 latent channels, 78.1 M decoder
               parameters; the nf=128 latent U-Net): ``cli.cache_latents``
               on 8 synthetic 5.12 s items at N=10 (fir_down2d's launches
               = items x 20 x 6), ``cli.train_ldm --use-disc`` at batch 4
               x 2 sources x 40,960 samples for 6 steps (gen and disc
               steps timed apart, peak memory, no kernel launched), then
               ``--resume`` to 8 steps; ``cli.validate_vae`` over the
               seeded and the finetuned VAE; one gen step profiled (the
               device's idle share); ``AutoencoderTrainer`` gen and disc
               steps at the VAE's sample_size of 247,808 samples, batch 2
               (halved on running out of memory, and why);
29. serving_parity -- ``cli.serve_api.build_engine`` on the trained nf=32
               checkpoint, masked, TF32 off: three requests of different
               lengths in one bucket at max_batch 4 (a padded row); each
               served stem equals the same row of a direct
               ``trainer.separate`` on the padded batch bit for bit (the
               engine's generator seeded alike, and its draws replayed by
               ``pc_generator_noise``), and the card the CPU within 1e-3;
30. serving -- the flagship behind ``SeparationAPIServer`` on 127.0.0.1
               (``scripts/serving_bench``'s lengths, one 65,153-sample
               bucket): every batch size warmed, then concurrency 1, 4 and
               8 over HTTP, one wave each (utt/s, wave latency, p50 / p95,
               occupancy from /v1/stats, batches, peak GiB, launches =
               batches x 60 x 18); one wave at 8 with pipeline_depth=1 and
               one with the int16 wire (N=5); /metrics parsed once;
31. serving_stream -- two concurrent /v1/stream sessions of 8 s on the
               same engine, pushed in real time in 0.5 s blocks, 4 s
               windows with 1 s overlap: emitted = pushed, the windows
               sharing batches, each response's wait; then ``cli.separate
               --chunk-seconds 4 --overlap-seconds 1
               --streaming-block-seconds 0.5`` on one 8 s file (N=10);
32. serving_latent -- ``build_engine(latent=True)`` on latent_diffsep_ouve
               at full width behind the API: the 65,536-sample bucket,
               concurrency 4 and 8, launches = batches x 60 x 6;
33. generation -- the stable-audio generation path, which no kernel of
               the port lies on (every launch count 0): a small config of
               Stable Audio Open's schema (Oobleck VAE pretransform, a
               t5-style prompt embedding and the two seconds conditioners,
               a DiT 128 wide, 2 layers) through
               ``GenerationApp.generate_conditional`` on the card and on
               the CPU with the card's initial noise, TF32 off, within
               1e-3 relative: the v sampler, k-heun, rectified-flow Euler,
               a variation with an inpaint mask; a ``DemoServer`` with
               that app on numbers only and ``cli.serve``'s autoencoder
               tab at the latent path's VAE widths: /api/generate_cond and
               /api/generate equal the direct calls' WAV bytes,
               /api/autoencoder round-trips 2 s; then Stable Audio Open
               1.0's published widths (DiT 1536 x 24, 1.07 B parameters)
               with seeded weights: 2 requests at batch 1, CFG 7, 8
               sampler steps (cut from the published 100), 2,097,152
               stereo samples: seconds a step (2 CFG rows x 1,025 tokens),
               a request and a decode, peak GiB, a profiled step's idle
               share, TFLOP/s, a bf16 step's distance from f32; and the
               DiT importer at full width, bit-equal to the same weights
               through ``params_from_jax``;
34. stable_models -- the rest of the stable-audio models, which no kernel
               of the port lies on (every launch count 0): card vs CPU
               (TF32 off, the card's draws) on small configs, an
               ``AudioLM`` (depth 2, width 64, 4 codebooks of 32,
               cross-attention, prepend and global conditioning) through
               ``lm_generate`` at CFG 3 replayed teacher-forced (every
               step's logits within 1e-4 of max|cpu|), its codes through
               a small ``DACPretransform.decode_tokens`` (1e-3), SEANet
               and TAAE autoencoders (1e-4), ``generate_diffusion_cond``
               through the 'adp_cfg_1d' U-Net and the diffusion
               autoencoder's ``reconstruct`` (1e-3); ``DemoServer(lm=
               LMApp(...))``: /api/lm's WAV (and, without a decoder, its
               JSON codes) equal to the direct call's; the token LM at
               MusicGen-small's widths (1024 x 24 layers, 16 heads) over
               DAC 44 kHz's 9 x 1024 codes, seeded, through ``LMApp``: a
               request of 172 frames (180 cached LM calls, top-k
               250), the prefill, a decode step's median and spread,
               frames per second, ``decode_tokens``, the request, peak
               GiB, 16 profiled decode steps' idle share, a step's byte
               bound; the last cached step against a full uncached pass
               (1e-4, TF32 off); DAU1d at the reference class's defaults
               (stereo, depth 14), 8 sampler steps of 65,536 samples, one
               step profiled, and its importer bit-equal to the
               ``params_from_jax`` load;
35. stable_train -- the stable-audio training path, which no kernel of
               the port lies on (every launch count 0): card vs CPU (TF32
               off, the card's draws) on small configs, two steps each of
               ``DiffusionTrainer`` (a DiT 64 wide with cross-attention,
               CFG dropout, inpainting and a padding mask),
               ``DiffAETrainer``, ``LMTrainer`` (the clip on) and a VAE-GAN
               gen + disc pair with a DAC and with an Oobleck
               discriminator, at the train-step bars, while
               ``cli.train_stable``'s children start: at full width, one a
               model type, started together, one training at a time (the
               LM at MusicGen-small's widths over DAC 44 kHz's codes,
               batch 4 x 86 frames, 4 steps; DAU1d at its defaults, batch 2 x
               65,536, 3 steps; the Stable Audio Open 1.0 VAE against
               DAC's published discriminator, batch 2 x 65,536, 4 steps),
               one demo each: s a step, peak GiB, the losses' first and
               last, 0 failed media calls; ``DiffusionTrainer`` on the
               conditional DiT at Stable Audio Open 1.0's widths (1.09 B
               parameters), batch 1, 2 steps;
36. mesh    -- data parallelism (``ditsep_tpu_torch.parallel``) in child
               processes on 127.0.0.1, each under a hard timeout, TF32
               off and deterministic cuDNN: ``cli.train_diffsep`` at the
               flagship width (batch 6 x 1 s, 2 steps, a validation)
               under ``python -m torch.distributed.run --nproc-per-node
               1 ... --mesh`` (NCCL, world size 1) against the same run
               without --mesh, losses, validation and EMA export bit
               for bit, the step times and peak memory of both (the two
               started together, one on the card at a time), and
               ``cli.evaluate --mesh`` on 1 item; beside that child and
               before the train children take the card, two gloo ranks
               sharing cuda:0: two train steps of the nf=32 checkpoint on
               a batch of 4 split 2 + 2 against one process at the
               train-step bars, and ``evaluate_dataset`` on 3 items
               against one process.

Every launch count is set to 0 just before each path (the fused bias-act
op, the conv probe, the separation CLI, the training CLI, each evaluate
run, the long-form CLI, each family's separation and training CLI, the
latent evaluate, separate, training and caching paths, the LDM's caching
and training CLIs, the media phase's training, evaluate and separate
CLIs and its API callback, the imported checkpoint's separations, each
serving
warmup and level, the stream sessions and the streaming CLI, the
generation, stable_models and stable_train paths (the stable_train
children count their own), the SepFormer CLI and its small parity, the
backbones, each NCSN++ option config's forward, the streaming bench, the
FACodec demo and its small parity, the learning loop's training and its
study; the mesh phase's children count their own) and read just after
it. The script
then prints the ``kernels`` JSON line (all six kernels; a group run, the
launches of the paths it ran), and as its last line
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CKPT = REPO / "examples" / "checkpoints" / "masked_synthetic_ema.npz"
FS = 8000
FLAGSHIP_SAMPLES = 67320          # 8.415 s at 8 kHz -> 576 frames after %64
N_STEPS = 30                      # NFE 60 with one corrector step
N_FILES = 4                       # WAVs through the CLI
BATCH = 4                         # batch of the direct separate calls
# 6 down blocks (on h and on x) + 6 input-pyramid levels
LAUNCHES_PER_FORWARD = 18
FBA_SHAPE = (4, 256, 576, 128)    # level-0 activation, batch 4, NHWC
CONV_STACK, CONV_REPS = 10, 5     # the conv probe's timed stacks
# the training path: diffsep_icassp, 12 synthetic items of 5 s, batch 6
TRAIN_ITEMS, TRAIN_LEN_S, TRAIN_BATCH, TRAIN_STEPS = 12, 5.0, 6, 4
TRAIN_EPOCHS = -(-TRAIN_STEPS // (TRAIN_ITEMS // TRAIN_BATCH))  # 2
VAL_BATCHES = 1                   # 4 validation items fill one batch of 6
TRAIN_VAL_N = 10  # the train CLIs' validation sampler steps (30 until PR 19)
# the trained nf=32 checkpoint: 3 down blocks + 3 input-pyramid levels
CKPT_LAUNCHES_PER_FORWARD = 9
CKPT_OVERRIDES = ["model.score_model.nf=32",
                  "model.score_model.ch_mult=(1,1,2,2)",
                  "model.score_model.attn_resolutions=(32,)"]
# the flagship's 4 seeded items land in 3 buckets, one of 2 items (a
# batch-2 call)
EVAL_TRAINED_ITEMS, EVAL_ITEMS, EVAL_BATCH = 8, 4, 4
# the trained checkpoint's unmasked runs (held to no bar): the first 4 of
# those items
EVAL_TRAINED_UNMASKED_ITEMS = 4
SI_SDR_BAR_DB, MASKED_RUNS_APART_DB = 8.5, 1.0  # the bars of PERF.md §2
# the latent path's bf16 stems against its f32 (TF32 convs) stems, same
# weights and draws, by SI-SDR, the worst item and source (PERF.md §2;
# stated before the first run held to it). The flagship's stems and its
# batch-4 forward are printed, not held (two bars guessed for them on
# seeded weights missed, PERF.md §6); the flagship is held to a witness
# instead: its score forward (nf=128, seeded weights, the zero-init layers
# at unit scale) at batch 1 x BF16_WITNESS_SAMPLES on the inputs of
# bf16_witness_inputs, max|bf16 - f32| / max|f32| at each time, within
# 0.5-1.5x of the JAX package's on the CPU at the same weights and inputs
# (BF16_WITNESS_JAX, which tests/test_torch_bf16.py measures and holds),
# the card's f32 in full f32 (TF32 off)
BF16_SI_SDR_BAR_DB = 20.0
BF16_WITNESS_SAMPLES = 4000
BF16_WITNESS_T = (0.9, 0.3, 0.05)
BF16_WITNESS_JAX = (4.257e-2, 3.527e-2, 4.498e-2)
BF16_WITNESS_RATIO = (0.5, 1.5)
LONGFORM_S, CHUNK_S, OVERLAP_S = 7.0, 4.0, 1.0
# a train step runs two forwards (init hack 5: the t=T PIT loss and the
# shuffled score loss); its backward takes fir_up2d for the 12 down-block
# downsamples of each (h and the skip x; the input pyramid acts on data)
UP_LAUNCHES_PER_BACKWARD = 12
# the phases in their order, in two groups that each run under the 900 s
# of one chip call (balanced from the phase_s of full runs, PERF.md);
# every phase that main runs is in exactly one (tests/
# test_torch_chip_smoke_groups.py). A phase stays in the group of the
# phase whose results it reads: families reads flagship's.
GROUPS = {
    1: ("phase_kernel", "phase_fused_bias_act", "phase_conv3x3",
        "phase_parity", "phase_flagship", "phase_train_kernel",
        "phase_train_parity", "phase_train_path", "phase_masked_parity",
        "phase_evaluate_trained", "phase_evaluate", "phase_longform",
        "phase_upsample", "phase_families", "phase_families_train",
        "phase_media", "phase_import", "phase_sepformer", "phase_backbones",
        "phase_ncsnpp_options", "phase_streaming_bench", "phase_facodec",
        "phase_learning"),
    2: ("phase_latent_kernel", "phase_latent_parity", "phase_latent_flagship",
        "phase_latent_train", "phase_ldm_parity", "phase_ldm_train",
        "phase_serving_parity", "phase_serving", "phase_serving_latent",
        "phase_generation", "phase_stable_models", "phase_stable_train",
        "phase_mesh"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    return {"fir_down2d": ck.fir_down2d, "fir_up2d": ck.fir_up2d,
            "fba_fwd": ck.fused_bias_act_fwd,
            "fba_bwd": ck.fused_bias_act_bwd,
            "conv3x3_9tap": ck.conv3x3_9tap,
            "conv3x3_async_halo": ck.conv3x3_async_halo}


def reset_counts() -> None:
    for w in wrappers().values():
        w.launches = 0


def counts() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


def ptxas_usage(log: str) -> dict:
    """Registers, stack and spills that ``-Xptxas -v`` reports, by kernel
    (the conv kernel's instances as conv3x3_kernel<NS, ASYNC>, the FIR
    kernel's as fir_down2d_nchw / _nhwc<dtype, V, path>)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            c = re.search(r"conv3x3_kernelILi(\d+)ELb([01])E", name)
            if c:
                name = (f"conv3x3_kernel<{c.group(1)}, "
                        f"{'true' if c.group(2) == '1' else 'false'}>")
            f = re.search(r"(fir_(?:down|up)2d_n(?:chw|hwc))"
                          r"I(f|13__nv_bfloat16)"
                          r"Li(\d+)ELb([01])E", name)
            if f:
                dtype = "float" if f.group(2) == "f" else "bf16"
                name = (f"{f.group(1)}<{dtype}, V={f.group(3)}, "
                        f"{'vector' if f.group(4) == '1' else 'scalar'}>")
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def build_all() -> dict:
    """Build every kernel library at once (one nvcc each); seconds and
    ptxas usage per source and kernel."""
    from concurrent.futures import ThreadPoolExecutor
    libs = {w.library.source.name: w.library for w in wrappers().values()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    out = {"build_s": time.perf_counter() - t0}
    for name, lib in libs.items():
        out[name] = ptxas_usage(lib.build_log)
    return out


def kernel_tol(ref, dtype) -> float:
    """A kernel's bar against its plain version: f32 1e-6 * max|ref|,
    bf16 1 ulp of max|ref|."""
    import torch
    from ditsep_tpu_torch.ops.cuda_kernels import bf16_ulp
    peak = ref.float().abs().max().item()
    return 1e-6 * peak if dtype == torch.float32 else bf16_ulp(peak)


def phase_kernel(ctx):
    """fir_down2d against downsample_2d_plain at every flagship shape, the
    forced vector and scalar paths bit for bit; then its times at every
    main-path shape (``scripts/fir_timing.py``)."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    from ditsep_tpu_torch.scripts import fir_timing

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [s for _, _, s in fir_timing.main_path_shapes(1)]
    cases = [(s, (1, 3, 3, 1), 1.0) for s in shapes]
    cases += [((2, 6, 17, 9), (1, 3, 3, 1), 1.0),
              ((2, 32, 64, 144), (1, 2, 3, 4), 2.5)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    paths = {"vector": 0, "scalar": 0}
    for shape, k, gain in cases:
        base = torch.randn(shape, generator=g, device="cuda")
        taps = ck.separable_taps(np.asarray(k, np.float64), gain)
        for dtype in (torch.float32, torch.bfloat16):
            for fmt in (torch.contiguous_format, torch.channels_last):
                x = base.to(dtype).contiguous(memory_format=fmt)
                y = ck.downsample_2d_cuda(x, k, 2, gain)
                ref = ck.downsample_2d_plain(x, k, 2, gain)
                torch.cuda.synchronize()
                check(y.shape == ref.shape and y.dtype == dtype
                      and y.is_contiguous(memory_format=fmt),
                      f"fir_down2d output shape/dtype/layout at {shape}")
                err = (y.float() - ref.float()).abs().max().item()
                tol = kernel_tol(ref, dtype)
                check(err <= tol, f"fir_down2d {shape} {dtype} {fmt}: "
                                  f"max err {err} > {tol}")
                worst[dtype] = max(worst[dtype], err)
                path = ck.fir_down2d.plan(x)["path"]
                paths[path] += 1
                if path == "vector":  # the scalar path gives the same bits
                    sca = ck.fir_down2d(x, *taps, force_path="scalar")
                    check(torch.equal(y, sca), f"fir_down2d {shape} {dtype} "
                                               f"{fmt}: the vector and "
                                               "scalar paths differ")

    rows = fir_timing.time_main_path(ctx["bandwidth"])
    timed = [r for r in rows if not r.get("per_forward")]
    level0 = {r["dtype"]: r for r in timed if r["layout"] == "nchw"
              and tuple(r["shape"]) == (1, 128, 256, 576)}
    ctx["kernel_times"] = level0
    ctx["kernel_err"] = worst
    emit({"phase": "kernel", "kernel": "fir_down2d", "cases": len(cases) * 4,
          "max_abs_err_f32": worst[torch.float32],
          "max_abs_err_bf16": worst[torch.bfloat16],
          "tolerance": "f32 1e-6*max|ref|, bf16 1 ulp of max|ref|",
          "paths": paths, "vector_equals_scalar_bits": paths["vector"],
          "shape": [1, 128, 256, 576],
          **{k: {m: v[m] for m in ("kernel_ms", "plain_ms", "library_ms",
                                   "bound_ms")} for k, v in level0.items()},
          "launches_per_forward": LAUNCHES_PER_FORWARD,
          "card": ctx["card"]})
    keys = ("kernel_ms", "bound_ms", "library_ms", "plain_ms", "call_ms",
            "library_call_ms", "in_l2")
    emit({"phase": "kernel_times", "kernel": "fir_down2d",
          "timing": "device ms: CUDA graph of at least 30 calls cycling "
                    "through twice the L2 where 256 calls can (else "
                    "in_l2); call ms: CUDA events around 30 back-to-back "
                    "calls",
          "columns": ["shape", "dtype", "layout", *keys],
          "rows": [[r["shape"], r["dtype"], r["layout"],
                    *(r[k] for k in keys)] for r in timed],
          "card": ctx["card"]})
    for r in rows:
        if r.get("per_forward"):
            emit({"phase": "kernel_per_forward", "kernel": "fir_down2d", **r,
                  "card": ctx["card"]})


def phase_fused_bias_act(ctx):
    """fba_fwd / fba_bwd against their plain versions; times; the op's
    path (fused_leaky_relu forward and backward through autograd)."""
    import torch
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    from ditsep_tpu_torch.ops.fused_act import fused_leaky_relu
    from ditsep_tpu_torch.utils.timing import call_ms

    g = torch.Generator(device="cuda").manual_seed(4)
    slope, scale = 0.2, math.sqrt(2.0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for shape in ((7919, 64), FBA_SHAPE):
        base = torch.randn(shape, generator=g, device="cuda")
        gbase = torch.randn(shape, generator=g, device="cuda")
        for axis in (-1, 1):
            bbase = torch.randn(shape[axis], generator=g, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                x, b, gy = base.to(dtype), bbase.to(dtype), gbase.to(dtype)
                before = counts()
                y = ck.fused_bias_act_fwd(x, b, slope, scale, axis)
                dx = ck.fused_bias_act_bwd(x, b, gy, slope, scale, axis)
                torch.cuda.synchronize()
                after = counts()
                check(after["fba_fwd"] - before["fba_fwd"] == 1
                      and after["fba_bwd"] - before["fba_bwd"] == 1,
                      f"fba launch counts at {shape} axis {axis}")
                for got, ref, what in (
                        (y, ck.fused_bias_act_plain(x, b, slope, scale,
                                                    axis), "fwd"),
                        (dx, ck.fused_bias_act_bwd_plain(x, b, gy, slope,
                                                         scale, axis),
                         "bwd")):
                    check(got.shape == ref.shape and got.dtype == dtype,
                          f"fba {what} shape/dtype at {shape}")
                    err = (got.float() - ref.float()).abs().max().item()
                    tol = kernel_tol(ref, dtype)
                    check(err <= tol, f"fba {what} {shape} axis {axis} "
                                      f"{dtype}: max err {err} > {tol}")
                    worst[dtype] = max(worst[dtype], err)
                n_cases += 1
                del x, b, gy, y, dx
    # times at the level-0 shape, channel axis last
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(FBA_SHAPE, generator=g, device="cuda").to(dtype)
        gy = torch.randn(FBA_SHAPE, generator=g, device="cuda").to(dtype)
        b = torch.randn(FBA_SHAPE[-1], generator=g, device="cuda").to(dtype)
        dx = ck.fused_bias_act_bwd(x, b, gy)
        esize = x.element_size()
        times[str(dtype).split(".")[-1]] = {
            "fwd_ms": call_ms(lambda: ck.fused_bias_act_fwd(x, b)),
            "fwd_plain_ms": call_ms(lambda: ck.fused_bias_act_plain(x, b)),
            "fwd_bound_ms": (2 * x.numel() + b.numel()) * esize
            / ctx["bandwidth"] * 1e3,
            "bwd_ms": call_ms(lambda: ck.fused_bias_act_bwd(x, b, gy)),
            "bwd_plain_ms": call_ms(
                lambda: ck.fused_bias_act_bwd_plain(x, b, gy)),
            "bwd_bound_ms": (3 * x.numel() + b.numel()) * esize
            / ctx["bandwidth"] * 1e3,
            # dbias = sum(dx), outside the kernel as in the JAX package
            "dbias_sum_ms": call_ms(lambda: dx.sum((0, 1, 2))),
        }
        del x, gy, b, dx
    # the op's path: forward and backward through autograd, f32
    x = torch.randn(FBA_SHAPE, generator=g, device="cuda",
                    requires_grad=True)
    b = torch.randn(FBA_SHAPE[-1], generator=g, device="cuda",
                    requires_grad=True)
    torch.cuda.synchronize()
    reset_counts()
    out = fused_leaky_relu(x, b)
    gx, gb = torch.autograd.grad((out ** 2).sum(), (x, b))
    torch.cuda.synchronize()
    path = counts()
    check(path["fba_fwd"] == 1 and path["fba_bwd"] == 1,
          f"fused_leaky_relu path launches {path}")
    check(bool(torch.isfinite(gx).all()) and gb.shape == b.shape,
          "fused_leaky_relu gradients")
    want_gb = (2 * out.detach() * ck.fused_bias_act_bwd_plain(
        x.detach(), b.detach(), torch.ones_like(out))).sum((0, 1, 2))
    gb_err = ((gb - want_gb).abs().max() / want_gb.abs().max()).item()
    check(gb_err <= 1e-4, f"dbias relative error {gb_err}")
    ctx["fba"] = {"times": times, "err": worst, "launches": path}
    emit({"phase": "fused_bias_act", "cases": n_cases,
          "max_abs_err_f32": worst[torch.float32],
          "max_abs_err_bf16": worst[torch.bfloat16],
          "tolerance": "f32 1e-6*max|ref|, bf16 1 ulp of max|ref|",
          "shape": list(FBA_SHAPE), "channel_axis": -1, **times,
          "path_launches": path, "dbias_rel_err": gb_err,
          "card": ctx["card"]})


def phase_conv3x3(ctx):
    """The conv kernels' launch plans; both kernels against their plain
    version at odd shapes; then the conv probe's path: parity at the probe
    shape and three timed rows at batch 16; then both kernels against the
    plain version at batch 16."""
    import torch
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    from ditsep_tpu_torch.ops.conv3x3 import (
        conv3x3_bordered, conv3x3_bordered_async,
    )
    from ditsep_tpu_torch.scripts import conv_probe
    from ditsep_tpu_torch.utils.timing import call_ms

    # the launch plans at the probe shape, and what ptxas said
    batch16 = {"n_tiles": 16 * -(-conv_probe.H // ck.CONV_TILE[0])
               * -(-conv_probe.W // ck.CONV_TILE[1])}
    plans = {k.entry: ck.conv3x3_plan(
        conv_probe.C, conv_probe.C2, padw, k.is_async,
        torch.cuda.get_device_properties(0).multi_processor_count,
        **batch16) for k, padw in ((ck.conv3x3_9tap, 1),
                                   (ck.conv3x3_async_halo, conv_probe.PADW))}
    emit({"phase": "conv3x3_plan", "shape": [16, conv_probe.H, conv_probe.W,
                                              conv_probe.C, conv_probe.C2],
          "plans": plans, "ptxas": ctx["ptxas"].get("conv3x3.cu"),
          "card": ctx["card"]})
    worst = 0.0
    both = ((1, conv3x3_bordered),
            (4, lambda x, w: conv3x3_bordered_async(x, w, 4)))
    for shape, kernels in (((2, 13, 37, 32, 48), both),
                           ((3, 9, 17, 16, 160), both),
                           ((1, 21, 40, 288, 48), both[:1]),
                           ((2, 11, 45, 144, 160), both[1:])):
        for padw, fn in kernels:
            x, x1, x4, w9 = conv_probe.make_inputs(*shape, 5, "cuda")
            xb = x1 if padw == 1 else x4
            y = fn(xb, w9)
            ref = ck.conv3x3_bordered_plain(xb, w9, padw)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            tol = ck.bf16_ulp(ref.float().abs().max().item())
            check(err <= tol, f"conv3x3 padw={padw} {shape}: {err} > {tol}")
            check(conv_probe.border_max(y, padw) == 0.0,
                  f"conv3x3 padw={padw} {shape}: nonzero border")
            worst = max(worst, err)
    # the conv probe's path, through its entry point
    torch.cuda.synchronize()
    reset_counts()
    probe = conv_probe.main(["--batch", "16", "--stack", str(CONV_STACK),
                             "--reps", str(CONV_REPS)])
    torch.cuda.synchronize()
    path = counts()
    per_variant = 1 + CONV_STACK * (CONV_REPS + 1)
    check(path["conv3x3_9tap"] == per_variant
          and path["conv3x3_async_halo"] == per_variant,
          f"conv probe launches {path}, want {per_variant} each")
    par = probe["parity"]
    worst = max(worst, par["max_abs_err_9tap"], par["max_abs_err_async_halo"])
    rows = {r["variant"]: r for r in probe["rows"]}
    # the timed shape (batch 16): the plain version's time, and both
    # kernels held against it there, where each persistent CTA walks about
    # 280 M tiles (the async kernel's two-stage ring wraps 279 times)
    x, x1, x4, w9 = conv_probe.make_inputs(16, conv_probe.H, conv_probe.W,
                                           conv_probe.C, conv_probe.C2, 6,
                                           "cuda")
    plain, timed_err = {}, {}
    for row, xb, padw, fn in (
            ("cuda_9tap", x1, 1, conv3x3_bordered),
            ("cuda_async_halo", x4, conv_probe.PADW,
             lambda x, w: conv3x3_bordered_async(x, w, conv_probe.PADW))):
        ref = ck.conv3x3_bordered_plain(xb, w9, padw)
        y = fn(xb, w9)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        tol = ck.bf16_ulp(ref.float().abs().max().item())
        check(err <= tol, f"conv3x3 {row} at batch 16: {err} > {tol}")
        check(conv_probe.border_max(y, padw) == 0.0,
              f"conv3x3 {row} at batch 16: nonzero border")
        timed_err[row] = err
        worst = max(worst, err)
        del ref, y
        plain[row] = call_ms(lambda: ck.conv3x3_bordered_plain(xb, w9, padw),
                             iters=2, warmup=1)
    del x, x1, x4, w9
    torch.cuda.empty_cache()
    ctx["conv"] = {"rows": rows, "plain": plain, "err": worst,
                   "launches": path}
    emit({"phase": "conv3x3", "max_abs_err": worst,
          "tolerance": "1 bf16 ulp of max|ref|; borders exactly 0",
          "probe_parity": par, "batch16_max_abs_err": timed_err,
          "plans": plans,
          "rows": probe["rows"], "plain_ms": plain,
          "path_launches": path, "card": ctx["card"]})


def parity_config(mask_padding: bool = False) -> dict:
    """The config of the trained nf=32 checkpoint (CKPT). The checkpoint
    was trained with mask_padding on (docs/pad_dilution_r03.md:132-136):
    the parity phase runs it unmasked, the reference semantics, and the
    masked_parity phase as it was trained."""
    from ditsep_tpu_torch.configs import diffsep, override
    return override(diffsep(), {
        "model.score_model.nf": 32,
        "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,),
        "model.score_model.mask_padding": mask_padding})


class full_f32:
    """cuDNN convs and matmuls in full float32 inside the block (PyTorch
    runs convs in TF32 by default)."""

    def __enter__(self):
        import torch
        self.prev = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev


def checkpoint_parity(mix, noise, n: int, lengths=None, bf16=False):
    """The trained nf=32 checkpoint separating ``mix`` at N=n on the card
    (TF32 off) and on the CPU with the same ``noise``: masked with
    ``lengths`` (as it was trained), unmasked without (the reference
    semantics). Checks the card's shape and finiteness, the NFE, 1e-3
    relative and fir_down2d's launches (9 a forward on the card, none on
    the CPU). Returns (relative error, card launches, card output, the
    card's bf16 output when ``bf16``)."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.configs import build_diffsep_trainer
    from ditsep_tpu_torch.ops import cuda_kernels as ck

    what = "unmasked" if lengths is None else "masked"
    cfg = parity_config(mask_padding=lengths is not None)
    out = {}
    with full_f32():
        for device, dtype in (("cuda", "f32"), ("cpu", "f32"),
                              *((("cuda", "bf16"),) if bf16 else ())):
            cfg["model"]["score_model"]["dtype"] = dtype
            trainer = build_diffsep_trainer(cfg, device=device,
                                            params_npz=str(CKPT))
            lens = (None if lengths is None
                    else torch.from_numpy(lengths).to(device))
            torch.cuda.synchronize()
            ck.fir_down2d.launches = 0
            est, nfe = trainer.separate(torch.from_numpy(mix).to(device),
                                        N=n, noise=noise, lengths=lens)
            torch.cuda.synchronize()
            out[device, dtype] = (est.cpu().numpy(), nfe,
                                  ck.fir_down2d.launches)
    (gpu, nfe_gpu, launches), (cpu, nfe_cpu, launches_cpu) = (
        out["cuda", "f32"], out["cpu", "f32"])
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    want = CKPT_LAUNCHES_PER_FORWARD * 2 * n
    check(gpu.shape == mix.shape[:1] + (2,) + mix.shape[2:]
          and np.isfinite(gpu).all(),
          f"{what} card output shape / finiteness")
    check(nfe_gpu == nfe_cpu == 2 * n, f"{what} NFE")
    check(rel <= 1e-3, f"{what} card vs CPU relative error {rel} > 1e-3")
    check(launches == want and launches_cpu == 0,
          f"{what} launches card {launches} (want {want}), CPU "
          f"{launches_cpu}")
    return rel, launches, gpu, out["cuda", "bf16"][0] if bf16 else None


def phase_parity(ctx):
    """Trained nf=32 checkpoint, unmasked: card (TF32 off) against CPU,
    same noise; and the card's bf16 run against its f32 one."""
    import numpy as np

    rng = np.random.default_rng(1)
    mix = (0.1 * rng.standard_normal((1, 1, FS))).astype(np.float32)
    n = 5
    noise = (rng.standard_normal((1, 2, FS)).astype(np.float32),
             rng.standard_normal((n, 1, 1, 2, FS)).astype(np.float32),
             rng.standard_normal((n, 1, 2, FS)).astype(np.float32))
    rel, launches, gpu, bf16 = checkpoint_parity(mix, noise, n, bf16=True)
    check(np.isfinite(bf16).all(), "card bf16 output finiteness")
    emit({"phase": "parity", "checkpoint": str(CKPT.relative_to(REPO)),
          "config": "nf=32 ch_mult=(1,1,2,2) attn=(32,) mask_padding=off",
          "samples": FS, "N": n, "tf32": False, "max_rel_err": rel,
          "tolerance": 1e-3, "launches_card": launches,
          "bf16_vs_f32_si_sdr_db": float(si_sdr_db(bf16, gpu).min()),
          "card": ctx["card"]})


def si_sdr_db(est, ref):
    """Scale-invariant SDR of est against ref (numpy, per item/source)."""
    import numpy as np
    est = est.astype(np.float64) - est.mean(-1, keepdims=True)
    ref = ref.astype(np.float64) - ref.mean(-1, keepdims=True)
    a = (est * ref).sum(-1, keepdims=True) / (ref * ref).sum(-1,
                                                             keepdims=True)
    t = a * ref
    return 10 * np.log10((t ** 2).sum(-1) / ((est - t) ** 2).sum(-1))


def bf16_witness_inputs():
    """The bf16 witness's (x, y): (1, 2, n) and (1, 1, n) float32 numpy
    arrays of 0.3 x standard normals from seed 0, x first."""
    import numpy as np
    rng = np.random.default_rng(0)
    return tuple((0.3 * rng.standard_normal((1, c, BF16_WITNESS_SAMPLES))
                  ).astype(np.float32) for c in (2, 1))


def unit_scale_zero_init_layers(model, seed: int) -> None:
    """Redraw the layers that DDPM init scales by 1e-10 (init_scale 0) at
    unit scale, on the CPU from a seeded generator. With them near zero
    the random-weight score is ~1e-10 and every dtype gives the same
    samples, so the bf16-vs-f32 comparison would test nothing."""
    import torch
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if getattr(m, "init_scale", None) == 0.0:
            m.init_scale = 1.0
            m.reset_parameters(g)


def profile_forward(trainer, mix, z):
    """One score-network forward at the flagship batch under
    torch.profiler: device time by kernel, the FIR kernel's share, and the
    device's idle share of the forward's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t = torch.full((mix.shape[0],), 0.5, device="cuda")
    xt = mix / 2 + 0.1 * z
    with torch.no_grad():
        trainer.model_fwd(xt, t, mix)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.model_fwd(xt, t, mix)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms)


def profile_summary(prof, wall_ms: float) -> dict:
    """Device time by kernel (device kernels only: the aten ops above them
    and the annotated ranges on the device, such as the optimizer's step,
    carry the same time), busy time, idle share of ``wall_ms``, and the
    FIR kernels' ms."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    fir = {name: sum(r[1] for r in rows if name in r[0])
           for name in ("fir_down2d", "fir_up2d")}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms) if wall_ms else None,
            "fir_down2d_ms": fir["fir_down2d"],
            "fir_down2d_share": fir["fir_down2d"] / busy_ms if busy_ms
            else None, "fir_up2d_ms": fir["fir_up2d"],
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:15]]}



@contextlib.contextmanager
def separate_calls():
    """Within it each ``DiffSepTrainer.separate`` call is recorded: its
    trainer, mix and keywords, its NFE, and its time on the host clock
    between two synchronizations."""
    import torch
    from ditsep_tpu_torch.training.diffsep import DiffSepTrainer

    calls = []
    real = DiffSepTrainer.separate

    def timed(self, mix, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est, nfe = real(self, mix, **kw)
        torch.cuda.synchronize()
        calls.append({"trainer": self, "mix": mix, "kw": kw, "nfe": nfe,
                      "s": time.perf_counter() - t0})
        return est, nfe

    DiffSepTrainer.separate = timed
    try:
        yield calls
    finally:
        DiffSepTrainer.separate = real


def separate_call_times(calls) -> dict:
    """Per call ms of recorded ``separate`` calls; the steady state is the
    calls after the first (which sets up cuDNN): ms a call, ms a score
    evaluation (a call / its NFE) and items/s."""
    ms = [1e3 * c["s"] for c in calls]
    steady = ms[1:]
    call_ms = sum(steady) / len(steady)
    nfe, items = calls[-1]["nfe"], calls[-1]["mix"].shape[0]
    return {"call_ms": ms, "steady_call_ms": call_ms,
            "steady_ms_per_score_call": call_ms / nfe,
            "steady_utt_per_s": items / (call_ms / 1e3)}


def profile_separate_call(call, n: int = 2) -> dict:
    """A recorded ``separate`` call replayed at N = n on its trainer and
    mix (``profile_replay``)."""
    trainer, mix, kw = call["trainer"], call["mix"], {**call["kw"], "N": n}
    return {"N": n, **profile_replay(
        lambda: trainer.separate(mix, **kw)[1])}


def profile_replay(run) -> dict:
    """``run()`` (one call; returns its NFE) warmed, timed unprofiled on
    the host clock, then once under torch.profiler, recording the device's
    activity alone (the summary reads nothing else, and recording
    thousands of host ops takes the profiler seconds). Device busy time,
    and the device's idle share of the unprofiled call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nfe = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    summary = profile_summary(prof, wall_ms)
    check(summary["device_busy_ms"] > 0, "the profiler saw no device time")
    return {"nfe": nfe, "wall_ms": wall_ms,
            "device_busy_ms": summary["device_busy_ms"],
            "busy_ms_per_score_call": summary["device_busy_ms"] / nfe,
            "idle_share": summary["idle_share"],
            "top": summary["top"][:5]}


def phase_flagship(ctx):
    import numpy as np
    import torch
    from ditsep_tpu_torch.cli import separate as cli
    from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep_icassp
    from ditsep_tpu_torch.data import read_wav, write_wav
    from ditsep_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(2)
    mixes = []
    for _ in range(N_FILES):
        # two band-limited random "sources", summed
        srcs = [np.convolve(rng.standard_normal(FLAGSHIP_SAMPLES),
                            np.hanning(9 + 8 * s), mode="same")
                for s in range(2)]
        mix = sum(srcs)
        mixes.append((0.3 * mix / np.abs(mix).max()).astype(np.float32))

    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = Path(tmp, "in"), Path(tmp, "out")
        inp.mkdir()
        for i, m in enumerate(mixes):
            write_wav(str(inp / f"mix{i}.wav"), m, FS)
        # -- the main path, through the entry point a user calls ----------
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with separate_calls() as calls:
            nfe_cli = cli.main(["--config", "diffsep_icassp", "--input",
                                str(inp), "--output", str(outp),
                                "--sampler-N", str(N_STEPS), "--seed", "0"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        ctx["flagship_cli_utt_per_s"] = N_FILES / cli_s
        ctx["main_path_launches"] = ck.fir_down2d.launches
        ctx["cli_launches"] = counts()
        check(len(calls) == N_FILES, f"CLI separate calls {len(calls)}")
        cli_calls = separate_call_times(calls)
        cli_calls["profiled_call"] = profile_separate_call(calls[-1])
        ctx["flagship_cli_calls"] = cli_calls
        del calls
        check(nfe_cli == 2 * N_STEPS, f"CLI NFE {nfe_cli}")
        check(ctx["main_path_launches"]
              == LAUNCHES_PER_FORWARD * nfe_cli * N_FILES,
              f"CLI kernel launches {ctx['main_path_launches']}")
        for s in ("s0", "s1"):
            for i in range(N_FILES):
                data, fs = read_wav(str(outp / s / f"mix{i}.wav"))
                check(fs == FS and data.shape == (FLAGSHIP_SAMPLES,)
                      and np.isfinite(data).all(), f"CLI output {s}/{i}")
        # the inputs are 16-bit WAVs: batch them as the CLI read them
        batch = np.stack([read_wav(str(inp / f"mix{i}.wav"))[0]
                          for i in range(BATCH)])[:, None, :]

    mix = torch.from_numpy(batch).cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    shape = (BATCH, 2, FLAGSHIP_SAMPLES)
    noise = (torch.randn(shape, generator=g, device="cuda"),
             torch.randn((N_STEPS, 1) + shape, generator=g, device="cuda"),
             torch.randn((N_STEPS,) + shape, generator=g, device="cuda"))
    results, forwards, witness = {}, {}, {}
    times = torch.tensor([0.9, 0.3, 0.05], device="cuda")
    wx, wy = (torch.from_numpy(a).cuda() for a in bf16_witness_inputs())
    for dtype in ("f32", "bf16"):
        cfg = diffsep_icassp()
        cfg["model"]["score_model"]["dtype"] = dtype
        trainer = build_diffsep_trainer(cfg, device="cpu", seed=0)
        unit_scale_zero_init_layers(trainer.model, seed=0)
        trainer.model.to("cuda")
        with torch.no_grad():
            forwards[dtype] = [trainer.model(
                0.3 * noise[0], t.expand(BATCH), mix).float()
                for t in times]
            with full_f32():
                witness[dtype] = [trainer.model(
                    wx, torch.full((1,), t, device="cuda"), wy).float()
                    for t in BF16_WITNESS_T]
        warm = (noise[0], noise[1][:2], noise[2][:2])  # 2 steps: cuDNN setup
        trainer.separate(mix, N=2, noise=warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.fir_down2d.launches = 0
        t0 = time.perf_counter()
        est, nfe = trainer.separate(mix, N=N_STEPS, noise=noise)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        check(nfe == 2 * N_STEPS, f"{dtype} NFE {nfe}")
        check(tuple(est.shape) == shape and bool(torch.isfinite(est).all()),
              f"{dtype} output shape / finiteness")
        check(ck.fir_down2d.launches == LAUNCHES_PER_FORWARD * nfe,
              f"{dtype} kernel launches {ck.fir_down2d.launches}")
        results[dtype] = {
            "seconds": sec, "utt_per_s": BATCH / sec,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": ck.fir_down2d.launches, "nfe": nfe,
            "est": est.float().cpu().numpy()}
        if dtype == "f32":
            ctx["profile"] = profile_forward(trainer, mix, noise[0])
            ctx["flagship_batch4_utt_per_s"] = BATCH / sec
        del trainer, est
        torch.cuda.empty_cache()
    agree = si_sdr_db(results["bf16"].pop("est"), results["f32"].pop("est"))
    forward_dist = [((b - f).abs().max() / f.abs().max()).item()
                    for b, f in zip(forwards["bf16"], forwards["f32"])]
    witness_dist = [((b - f).abs().max() / f.abs().max()).item()
                    for b, f in zip(witness["bf16"], witness["f32"])]
    del forwards, witness
    emit({"phase": "flagship", "config": "diffsep_icassp (nf=128, random "
          "weights seed 0)", "samples": FLAGSHIP_SAMPLES, "N": N_STEPS,
          "cli": {"files": N_FILES, "seconds": cli_s,
                  "utt_per_s": N_FILES / cli_s, "nfe_per_file": nfe_cli,
                  "launches": ctx["main_path_launches"],
                  "launches_by_kernel": ctx["cli_launches"],
                  "separate_calls": ctx["flagship_cli_calls"]},
          "batch": BATCH, "tf32_conv": True, **results,
          "bf16_vs_f32_si_sdr_db": {"mean": float(agree.mean()),
                                    "min": float(agree.min())},
          "bf16_vs_f32_forward": {"t": times.tolist(),
                                  "max_diff_of_max": forward_dist},
          "bf16_witness": {"t": list(BF16_WITNESS_T),
                           "samples": BF16_WITNESS_SAMPLES,
                           "max_diff_of_max": witness_dist,
                           "jax_cpu": list(BF16_WITNESS_JAX),
                           "ratio_bar": list(BF16_WITNESS_RATIO)},
          "card": ctx["card"]})
    lo, hi = BF16_WITNESS_RATIO
    for t, d, j in zip(BF16_WITNESS_T, witness_dist, BF16_WITNESS_JAX):
        check(lo * j <= d <= hi * j, f"bf16 witness at t={t}: {d:.3e}, "
              f"JAX's {j:.3e}")
    emit({"phase": "profile", "what": "one f32 score forward, batch "
          f"{BATCH}, {FLAGSHIP_SAMPLES} samples (TF32 convs)",
          **ctx["profile"], "card": ctx["card"]})


def phase_train_kernel(ctx):
    """fir_up2d against downsample_2d_bwd_plain, bit for bit, at the train
    step's down-block shapes and two odd cases, the scalar path against
    the vector path; its times; the gradient through ops.fir.downsample_2d
    on the card (the downsample had none on CUDA before fir_up2d)."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    from ditsep_tpu_torch.ops import fir
    from ditsep_tpu_torch.scripts import fir_timing

    g = torch.Generator(device="cuda").manual_seed(7)
    cases = [(s, (1, 3, 3, 1), 1.0) for _, s in fir_timing.train_path_shapes()]
    cases += [((2, 6, 17, 9), (1, 2, 3, 4), 2.5),
              ((2, 32, 64, 144), (1, 2, 3, 4), 2.5)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    paths = {"vector": 0, "scalar": 0}
    for shape, k, gain in cases:
        n, c, h, w = shape
        base = torch.randn((n, c, h // 2, w // 2), generator=g, device="cuda")
        taps = ck.separable_taps(np.asarray(k, np.float64), gain)
        for dtype in (torch.float32, torch.bfloat16):
            for fmt in (torch.contiguous_format, torch.channels_last):
                gy = base.to(dtype).contiguous(memory_format=fmt)
                dx = ck.fir_up2d(gy, *taps, (h, w))
                ref = ck.downsample_2d_bwd_plain(gy, k, (h, w), gain)
                torch.cuda.synchronize()
                check(dx.shape == shape and dx.dtype == dtype,
                      f"fir_up2d output shape/dtype at {shape}")
                err = (dx.float() - ref.float()).abs().max().item()
                check(err <= kernel_tol(ref, dtype)
                      and torch.equal(dx, ref),
                      f"fir_up2d {shape} {dtype} {fmt}: max err {err}, "
                      "not the plain version's bits")
                worst[dtype] = max(worst[dtype], err)
                path = ck.fir_up2d.plan(gy, (h, w))["path"]
                paths[path] += 1
                if path == "vector":
                    sca = ck.fir_up2d(gy, *taps, (h, w), force_path="scalar")
                    check(torch.equal(dx, sca), f"fir_up2d {shape} {dtype} "
                                                f"{fmt}: paths differ")
                del gy, dx, ref
        del base
    # the fault's own check: on the card, the gradient through the op
    x = torch.randn(cases[0][0], generator=g, device="cuda",
                    requires_grad=True)
    y = fir.downsample_2d(x, [1, 3, 3, 1])
    check(y.grad_fn is not None, "downsample_2d on CUDA gives no grad_fn")
    gy = torch.randn(y.shape, generator=g, device="cuda")
    y.backward(gy)
    want = ck.downsample_2d_bwd_plain(gy, [1, 3, 3, 1], tuple(x.shape[2:]))
    torch.cuda.synchronize()
    check(torch.equal(x.grad, want), "x.grad through downsample_2d on CUDA "
                                     "is not the plain version's")
    with torch.no_grad():
        check(fir.downsample_2d(x, [1, 3, 3, 1]).grad_fn is None,
              "no_grad downsample_2d went through the autograd Function")
    del x, y, gy, want
    torch.cuda.empty_cache()
    rows = fir_timing.time_train_path(ctx["bandwidth"])
    timed = [r for r in rows if not r.get("per_train_step")]
    level0 = {r["dtype"]: r for r in timed
              if tuple(r["shape"]) == fir_timing.train_path_shapes()[0][1]}
    ctx["up"] = {"err": worst, "level0": level0}
    keys = ("kernel_ms", "bound_ms", "plain_ms", "library_ms", "call_ms",
            "in_l2")
    emit({"phase": "train_kernel", "kernel": "fir_up2d",
          "cases": len(cases) * 4, "max_abs_err_f32": worst[torch.float32],
          "max_abs_err_bf16": worst[torch.bfloat16],
          "tolerance": "the plain version's bits (f32 1e-6*max|ref|, bf16 "
                       "1 ulp of max|ref|)",
          "paths": paths, "vector_equals_scalar_bits": paths["vector"],
          "grad_through_downsample_2d": "equal to the plain version's",
          "timing": "device ms by CUDA graphs cycling past twice the L2 "
                    "(scripts/fir_timing.py); library: F.conv_transpose2d "
                    "depthwise 4x4 stride 2",
          "columns": ["shape", "dtype", "layout", *keys],
          "rows": [[r["shape"], r["dtype"], r["layout"],
                    *(r[k] for k in keys)] for r in timed],
          "per_train_step": [r for r in rows if r.get("per_train_step")],
          "card": ctx["card"]})


def synthetic_batch(n: int, len_s: float, seed: int = 0):
    """(mix, target) numpy arrays: n synthetic items of len_s seconds,
    through the train loader's bucketing and collation."""
    from ditsep_tpu_torch.data import BucketedLoader, SyntheticMixDataset
    ds = SyntheticMixDataset(n_items=n, min_len_s=len_s, max_len_s=len_s,
                             seed=seed)
    return next(iter(BucketedLoader(ds, batch_size=n, n_buckets=6,
                                    multiple=4096, shuffle=False)))


def train_steps_card_vs_cpu(cfg, batches, draws, latent=False) -> dict:
    """Train steps of ``cfg`` on the CPU and on the card (TF32 off), over
    the same batches and draws (``checkpoint_steps``), and the trainer's
    config."""
    hist = {}
    for device in ("cpu", "cuda"):
        hist[device], hist["cfg"] = checkpoint_steps(cfg, device, batches,
                                                     draws, latent=latent)
    return hist


def checkpoint_steps(cfg, device, batches, draws, latent=False,
                     mesh=None):
    """Train steps of ``cfg`` on ``device``, TF32 off: from the trained
    nf=32 checkpoint's weights, or with ``latent`` from
    ``latent_trainer``'s seeded ones through ``train_step_latent``. With
    ``mesh`` this rank's rows of each global batch, the step and its
    gradient the global batch's (averaged over the ranks). Returns the
    initial parameters and, per step, the loss, the grad norm, the step's
    gradient, and the parameters and EMA after it; and the trainer's
    config."""
    import torch
    from ditsep_tpu_torch import parallel
    from ditsep_tpu_torch.configs import build_diffsep_trainer
    from ditsep_tpu_torch.utils.separate import normalize_batch

    with full_f32():
        if latent:
            trainer = latent_trainer(cfg, device)
            loss_fn, step_fn = (trainer.training_loss_latent,
                                trainer.train_step_latent)
        else:
            trainer = build_diffsep_trainer(cfg, device=device,
                                            params_npz=str(CKPT))
            loss_fn, step_fn = trainer.training_loss, trainer.train_step
        state = trainer.init_state()
        names = [k for k, _ in trainer.model.named_parameters()]
        params = [p for _, p in trainer.model.named_parameters()]
        snap = lambda sd: {k: v.detach().cpu().numpy().copy()  # noqa
                           for k, v in sd.items()}
        out = {"params0": snap(state.model.state_dict()), "steps": []}
        for (mix, tgt), d in zip(batches, draws):
            if mesh is None:
                batch = (torch.from_numpy(mix).to(device),
                         torch.from_numpy(tgt).to(device))
            else:
                batch = parallel.shard_batch(mesh, (mix, tgt))
            m, tg = batch if latent else normalize_batch(batch)[0]
            with parallel.sharded(mesh):
                loss = loss_fn(trainer.model, m, tg, draws=d)
            grads = list(torch.autograd.grad(loss, params))
            parallel.all_reduce_grads_(grads, mesh)
            state, met = step_fn(state, batch, draws=d, mesh=mesh)
            out["steps"].append({
                "loss": met["train/score_loss"].item(),
                "grad_norm": met["train/grad_norm"].item(),
                "grads": {k: g.cpu().numpy() for k, g in zip(names, grads)},
                "params": snap(state.model.state_dict()),
                "ema": snap(state.ema.state_dict())})
    return out, trainer.cfg


def adam_f64(p0: dict, grads: list, rates: list, clip: float,
             b1: float = 0.9, b2: float = 0.999,
             weight_decay: float = 0.0) -> dict:
    """optax's clip_by_global_norm + adam (adamw with ``weight_decay``) in
    float64 over a gradient history, step n at ``rates[n]``: the
    parameters after its last step."""
    import numpy as np
    p = {k: v.astype(np.float64) for k, v in p0.items() if k in grads[0]}
    m = {k: 0.0 for k in p}
    v = {k: 0.0 for k in p}
    for n, (g, lr) in enumerate(zip(grads, rates), start=1):
        norm = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                           for a in g.values()))
        scale = 1.0 if norm < clip else clip / norm
        for k in p:
            gk = g[k].astype(np.float64) * scale
            m[k] = b1 * m[k] + (1 - b1) * gk
            v[k] = b2 * v[k] + (1 - b2) * gk ** 2
            upd = (m[k] / (1 - b1 ** n)) / (
                np.sqrt(v[k] / (1 - b2 ** n)) + 1e-8)
            p[k] = p[k] - lr * (upd + weight_decay * p[k])
    return p


def grads_worst(ref: dict, got: dict, what: str, zero: tuple = (),
                scale: dict = None) -> float:
    """A step's gradient, the card's against the CPU's leaf by leaf,
    checked: within 1e-3 of the CPU leaf's max (or of ``scale[leaf]``
    where that is larger: a gradient that is a difference of two nearly
    equal terms, ``hinge_term_scales``); a leaf whose name ends in one of
    ``zero`` (its gradient is 0) within 1e-6 of the largest leaf's max. A
    parameter bar that takes the part the gradients explain cannot hold a
    wrong gradient to account: this check does. Returns the worst
    ratio."""
    import numpy as np
    top = max(np.abs(v).max() for v in ref.values())
    worst = 0.0
    for k, want in ref.items():
        if k.endswith(zero):
            ratio = max(np.abs(want).max(), np.abs(got[k]).max()) / (
                1e-6 * top)
        else:
            diff = np.abs(got[k] - want).max()
            bar = 1e-3 * max(np.abs(want).max(),
                             scale[k] if scale is not None else 0.0)
            ratio = diff / bar if bar > 0 else (0.0 if diff == 0 else np.inf)
        worst = max(worst, float(ratio))
        check(ratio <= 1, f"{what} gradient of {k}: {ratio} of the bar")
    return worst


def train_parity_worst(hist, explain: bool) -> dict:
    """The card's steps against the CPU's at the bars of
    tests/test_torch_train_step.py: loss and grad norm 1e-4 relative, and
    each step's gradient leaf by leaf within 1e-3 of the CPU leaf's max
    (the attention's key bias, whose gradient is 0, within 1e-6 of the
    largest leaf's max), as tests/test_torch_cuda.py holds one step's
    (checked here); after step n the parameters within n * 1e-3 * lr where
    the CPU gradient is significant, n * 2 * lr elsewhere, the EMA the same
    times (1 - decay) plus 2 ulps. With ``explain`` each parameter bar
    also takes twice the part of the difference that the two devices'
    gradients explain (float64 clip + Adam on each device's gradient
    history), as tests/test_torch_train_step_families.py does: Adam
    magnifies a gradient's round-off where its first moment nearly
    cancels. Returns the worst ratios (over_bar <= 1 passes)."""
    import numpy as np
    cfg = hist["cfg"]
    lr, decay = cfg.lr, cfg.ema_decay
    cpu, card = hist["cpu"]["steps"], hist["cuda"]["steps"]
    worst = {"loss_rel": 0.0, "grad_norm_rel": 0.0, "grad_over_bar": 0.0,
             "param_over_bar": 0.0, "ema_over_bar": 0.0}
    for n, (ref, got) in enumerate(zip(cpu, card), start=1):
        for key in ("loss", "grad_norm"):
            rel = abs(got[key] - ref[key]) / abs(ref[key])
            worst[f"{key}_rel"] = max(worst[f"{key}_rel"], rel)
            check(rel <= 1e-4, f"train step {n} {key}: card {got[key]} CPU "
                               f"{ref[key]}")
        worst["grad_over_bar"] = max(worst["grad_over_bar"], grads_worst(
            ref["grads"], got["grads"], f"train step {n}",
            zero=("NIN_1.b",)))  # the attention's key bias: 0
        explained = {}
        if explain:
            a = adam_f64(hist["cpu"]["params0"],
                         [h["grads"] for h in cpu[:n]], [lr] * n,
                         cfg.grad_clip)
            b = adam_f64(hist["cpu"]["params0"],
                         [h["grads"] for h in card[:n]], [lr] * n,
                         cfg.grad_clip)
            explained = {k: 2 * np.abs(a[k] - b[k]) for k in a}
        for k, want in ref["params"].items():
            bar = np.full(want.shape, 1e-9)  # buffers do not move
            if k in ref["grads"]:
                sig = np.ones(want.shape, bool)
                for h in cpu[:n]:
                    a = np.abs(h["grads"][k])
                    top = max(np.abs(v).max() for v in h["grads"].values())
                    sig &= (a >= 1e-3 * a.max()) & (a.max() >= 1e-6 * top)
                bar = np.where(sig, n * 1e-3 * lr, n * 2 * lr)
                bar = bar + explained.get(k, 0.0)
            ratio = (np.abs(got["params"][k] - want) / bar).max()
            worst["param_over_bar"] = max(worst["param_over_bar"], ratio)
            e_want = ref["ema"][k]
            slack = 2 * np.spacing(np.abs(e_want).astype(np.float32))
            e_ratio = (np.abs(got["ema"][k] - e_want)
                       / (bar * (1 - decay) + slack)).max()
            worst["ema_over_bar"] = max(worst["ema_over_bar"], e_ratio)
    return worst


def train_parity_draws(b: int, n_steps: int, seed: int):
    """Synthetic 1 s batches and the draws of init hack 5, one item on
    each branch of its mixture."""
    import numpy as np
    rng = np.random.default_rng(seed)
    batches, draws = [], []
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    for step in range(n_steps):
        mix, tgt = synthetic_batch(b, 1.0, seed=20 + step)
        t = mix.shape[-1]
        batches.append((mix, tgt))
        draws.append({"mask_u": f32(np.resize([0.05, 0.5], b)),
                      "pit_z": f32(rng.standard_normal((b, 2, t))),
                      "shuffle_u": f32(rng.random((b, 2))),
                      "time_u": f32(rng.random(b)),
                      "z": f32(rng.standard_normal((b, 2, t)))})
    return batches, draws


TRAIN_PARITY_TOLERANCE = (
    "loss and grad norm 1e-4 relative; each step's gradient per leaf 1e-3 "
    "of its max|CPU| (grad_over_bar); after step n, parameters "
    "n*1e-3*lr where the CPU gradient is significant, n*2*lr elsewhere; "
    "EMA the same times (1 - decay) plus 2 ulps (over_bar <= 1 passes)")


def phase_train_parity(ctx):
    """Two train steps of the trained nf=32 checkpoint on the CPU and on
    the card (TF32 off), the same batches and draws: loss, grad norm,
    parameters and EMA at the bars of tests/test_torch_train_step.py."""
    batches, draws = train_parity_draws(2, 2, seed=11)
    hist = train_steps_card_vs_cpu(parity_config(), batches, draws)
    worst = train_parity_worst(hist, explain=False)
    check(worst["param_over_bar"] <= 1 and worst["ema_over_bar"] <= 1,
          f"card vs CPU train steps: {worst}")
    emit({"phase": "train_parity", "checkpoint": str(CKPT.relative_to(REPO)),
          "config": "nf=32 ch_mult=(1,1,2,2) attn=(32,)", "batch": 2,
          "samples": int(batches[0][0].shape[-1]), "steps": len(batches),
          "tf32": False, **{k: float(v) for k, v in worst.items()},
          "losses_card": [h["loss"] for h in hist["cuda"]["steps"]],
          "losses_cpu": [h["loss"] for h in hist["cpu"]["steps"]],
          "tolerance": TRAIN_PARITY_TOLERANCE, "card": ctx["card"]})


def phase_train_path(ctx):
    """The flagship training path through its CLI; then the EMA export
    loaded back and separating a file; then one train step profiled."""
    import gc

    import numpy as np
    import torch
    from ditsep_tpu_torch.cli import separate as sep_cli
    from ditsep_tpu_torch.cli import train_diffsep
    from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep_icassp
    from ditsep_tpu_torch.data import read_wav, write_wav
    from ditsep_tpu_torch.training.diffsep import DiffSepTrainer

    spans, losses = [], []
    real_step = DiffSepTrainer.train_step

    def timed_step(self, state, batch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = real_step(self, state, batch, **kw)
        losses.append(met["train/score_loss"].item())  # syncs
        spans.append(time.perf_counter() - t0)
        return state, met

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp, "run")
        DiffSepTrainer.train_step = timed_step
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            state = train_diffsep.main([
                "--config", "diffsep_icassp", "--synthetic",
                "--synthetic-items", str(TRAIN_ITEMS), "--synthetic-len-s",
                str(TRAIN_LEN_S), "--max-steps", str(TRAIN_STEPS),
                "--workdir", str(work), "--override",
                f"model.sampler.N={TRAIN_VAL_N}"])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            DiffSepTrainer.train_step = real_step
        check(state.step == TRAIN_STEPS == len(losses),
              f"train steps {state.step}, timed {len(losses)}")
        check(all(math.isfinite(v) for v in losses), f"losses {losses}")
        # fir_down2d: 2 forwards a train step; a validation runs the score
        # loss (2 forwards) and a PC separation (2N) on its batch
        per_val = VAL_BATCHES * (2 + 2 * TRAIN_VAL_N) * LAUNCHES_PER_FORWARD
        want = {"fir_down2d": TRAIN_STEPS * 2 * LAUNCHES_PER_FORWARD
                + TRAIN_EPOCHS * per_val,
                "fir_up2d": TRAIN_STEPS * 2 * UP_LAUNCHES_PER_BACKWARD}
        want.update({k: 0 for k in launches if k not in want})
        check(launches == want, f"train path launches {launches}, want "
                                f"{want}")
        ctx["train_launches"] = launches
        vals = [json.loads(ln) for ln in open(work / "metrics.jsonl")
                if "val/si_sdr" in ln]
        check(len(vals) == TRAIN_EPOCHS and all(
            math.isfinite(v["val/si_sdr"]) and math.isfinite(
                v["val/score_loss"]) for v in vals), f"validations {vals}")
        ckdir = work / "checkpoints"
        index = json.loads((ckdir / "index.json").read_text())
        check((ckdir / "latest" / "state.pt").exists()
              and (ckdir / "best-model").exists()
              and len(index) == TRAIN_EPOCHS, f"checkpoints {index}")
        ema_npz = work / "ema.npz"
        check(ema_npz.exists(), "no EMA export")
        ema_sd = {k: v.detach().clone() for k, v
                  in state.ema.state_dict().items()}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        # the export loads back and separates a file
        back = build_diffsep_trainer(diffsep_icassp(), device="cuda",
                                     params_npz=str(ema_npz))
        check(all(torch.equal(v, ema_sd[k])
                  for k, v in back.model.state_dict().items()),
              "the EMA export does not load back to the EMA weights")
        del back, ema_sd
        inp, outp = Path(tmp, "in"), Path(tmp, "out")
        inp.mkdir()
        mix, _ = synthetic_batch(1, TRAIN_LEN_S, seed=3)
        write_wav(str(inp / "item.wav"), mix[0, 0], FS)
        nfe = sep_cli.main(["--config", "diffsep_icassp", "--input",
                            str(inp), "--output", str(outp), "--params",
                            str(ema_npz), "--sampler-N", "5"])
        for src in ("s0", "s1"):
            data, fs = read_wav(str(outp / src / "item.wav"))
            check(fs == FS and np.isfinite(data).all(),
                  f"separation with the EMA export: {src}")
    timed = spans[1:]  # steps 2-4: the first one warms cuDNN
    steps_per_s = len(timed) / sum(timed)
    emit({"phase": "train", "config": "diffsep_icassp (nf=128, random "
          "weights seed 0), train batch 6, 12 synthetic items of 5.0 s "
          "(40,960 samples a batch after bucketing, U-Net input 6 x 6 x "
          "256 x 384)", "steps": TRAIN_STEPS, "epochs": TRAIN_EPOCHS,
          "losses": losses, "step_s": spans,
          "steps_per_s_2_4": steps_per_s,
          "items_per_s_2_4": TRAIN_BATCH * steps_per_s,
          "total_s": total_s, "peak_gib": peak_gib,
          "timing": "host clock around each train_step, synchronized "
                    "before and after; TF32 convs",
          "validations": vals, "launches": launches,
          "ema_export_nfe": nfe, "card": ctx["card"]})
    # one train step under the profiler, after a warm one
    trainer = build_diffsep_trainer(diffsep_icassp(), device="cuda")
    state = trainer.init_state()
    mix, tgt = synthetic_batch(TRAIN_BATCH, TRAIN_LEN_S)
    batch = (torch.from_numpy(mix).cuda(), torch.from_numpy(tgt).cuda())
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer.train_step(state, batch, generator=gen)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "train_profile", "what": "one train step, diffsep_icassp,"
          f" batch {TRAIN_BATCH} x {mix.shape[-1]} samples (TF32 convs)",
          **profile_summary(prof, wall_ms), "card": ctx["card"]})
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()


def phase_masked_parity(ctx):
    """The trained nf=32 checkpoint as it was trained (mask_padding on): a
    batch of 2 items of 1 s and 0.75 s padded to 1 s, with ``lengths``;
    the card (TF32 off) against the CPU with the same noise."""
    import numpy as np

    rng = np.random.default_rng(4)
    lens = np.array([FS, 6000], np.int64)  # 66 and 50 STFT frames
    mix = np.zeros((2, 1, FS), np.float32)
    for i, n_valid in enumerate(lens):
        mix[i, 0, :n_valid] = 0.1 * rng.standard_normal(n_valid)
    n = 5
    noise = (rng.standard_normal((2, 2, FS)).astype(np.float32),
             rng.standard_normal((n, 1, 2, 2, FS)).astype(np.float32),
             rng.standard_normal((n, 2, 2, FS)).astype(np.float32))
    rel, launches, _, _ = checkpoint_parity(mix, noise, n, lengths=lens)
    emit({"phase": "masked_parity", "checkpoint": str(CKPT.relative_to(REPO)),
          "config": "nf=32 ch_mult=(1,1,2,2) attn=(32,) mask_padding=on",
          "lengths": lens.tolist(), "padded_to": FS, "N": n, "tf32": False,
          "max_rel_err": rel, "tolerance": 1e-3, "launches_card": launches,
          "launches_want": CKPT_LAUNCHES_PER_FORWARD * 2 * n,
          "card": ctx["card"]})


def run_evaluate(args, launches_per_call: int) -> dict:
    """One ``cli.evaluate`` run in a fresh output folder: its summary, the
    reference schema's key order checked in both files, finite metrics, the
    PESQ backend, and fir_down2d's launches against the plan (calls x NFE
    x launches a forward)."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.cli import evaluate as cli
    from ditsep_tpu_torch.ops import cuda_kernels as ck

    summary_keys = ["batch_idx", "si_sdr", "si_sir", "si_sar", "pesq",
                    "stoi", "nfe", "runtime", "len_s", "number",
                    "pesq_impl", "merged_utterances"]
    item_keys = ["batch_idx", "si_sdr", "si_sir", "si_sar", "pesq", "stoi",
                 "pesq_impl", "nfe", "runtime", "len_s"]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = cli.main([*args, "--out-dir", tmp])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = counts()
        split = "librimix_test"
        per = json.loads(Path(tmp, f"{split}.json").read_text())
        summary = json.loads(Path(tmp, f"{split}_summary.json").read_text())
    check(list(summary)[:len(summary_keys)] == summary_keys,
          f"summary keys {list(summary)}")
    for entry in per.values():
        check(list(entry)[:len(item_keys)] == item_keys,
              f"result keys {list(entry)}")
        check(all(np.isfinite(entry[k]).all() for k in
                  ("si_sdr", "si_sir", "si_sar", "pesq", "stoi")),
              f"non-finite metrics {entry}")
    check(summary["pesq_impl"] == "p862_numpy",
          f"PESQ backend {summary['pesq_impl']}")
    nfe = summary["nfe"]
    want = res["calls"] * nfe * launches_per_call
    check(launches["fir_down2d"] == want,
          f"evaluate launches {launches}, want fir_down2d {want} "
          f"({res['calls']} calls x {nfe} NFE x {launches_per_call})")
    check(all(v == 0 for k, v in launches.items() if k != "fir_down2d"),
          f"other kernels launched on the evaluate path: {launches}")
    return {**{k: summary[k] for k in ("si_sdr", "si_sir", "si_sar", "pesq",
                                       "stoi", "runtime", "number",
                                       "merged_utterances")},
            "buckets": res["buckets"], "calls": res["calls"],
            "launches": launches["fir_down2d"], "wall_s": wall_s,
            "metrics_s": res["metrics_s"]}


def phase_evaluate_trained(ctx):
    """cli.evaluate on the trained checkpoint: masked at the default
    buckets and at one (every item padded past its own frame block), then
    unmasked at both; the masked runs held to PERF.md's SI-SDR bars."""
    base = ["--config", "diffsep", "--synthetic", "--eval-batch-size",
            str(EVAL_BATCH), "--params", str(CKPT), "--seed", "0",
            "--override", *CKPT_OVERRIDES]
    masked = ["--synthetic-items", str(EVAL_TRAINED_ITEMS), "--mask-padding"]
    unmasked = ["--synthetic-items", str(EVAL_TRAINED_UNMASKED_ITEMS)]
    runs = {}
    for name, extra in (("masked", masked),
                        ("masked_max_buckets_1", [*masked, "--max-buckets",
                                                  "1"]),
                        ("unmasked", unmasked),
                        ("unmasked_max_buckets_1", [*unmasked,
                                                    "--max-buckets", "1"])):
        runs[name] = run_evaluate([*extra, *base], CKPT_LAUNCHES_PER_FORWARD)
    a, b = runs["masked"]["si_sdr"], runs["masked_max_buckets_1"]["si_sdr"]
    check(runs["masked_max_buckets_1"]["merged_utterances"] > 0,
          "one bucket merged no item past its frame block")
    check(min(a, b) >= SI_SDR_BAR_DB,
          f"masked mean SI-SDR {a:.3f} / {b:.3f} dB under the "
          f"{SI_SDR_BAR_DB} dB bar")
    check(abs(a - b) <= MASKED_RUNS_APART_DB,
          f"masked runs {a:.3f} and {b:.3f} dB more than "
          f"{MASKED_RUNS_APART_DB} dB apart")
    emit({"phase": "evaluate_trained",
          "checkpoint": str(CKPT.relative_to(REPO)),
          "config": "nf=32 ch_mult=(1,1,2,2) attn=(32,)",
          "items": {"masked": EVAL_TRAINED_ITEMS,
                    "unmasked": EVAL_TRAINED_UNMASKED_ITEMS},
          "batch": EVAL_BATCH, "N": N_STEPS,
          "bars": {"masked_si_sdr_db_min": SI_SDR_BAR_DB,
                   "masked_runs_apart_db_max": MASKED_RUNS_APART_DB},
          "runtime_unit": "s/utt", "runs": runs, "card": ctx["card"]})


def phase_evaluate(ctx):
    """cli.evaluate at the flagship width, seeded random weights, unmasked
    and masked, without warm-up calls (evaluate_trained runs them)."""
    base = ["--config", "diffsep_icassp", "--synthetic",
            "--synthetic-items", str(EVAL_ITEMS), "--eval-batch-size",
            str(EVAL_BATCH), "--sampler-N", str(N_STEPS), "--seed", "0",
            "--no-warmup"]
    runs = {name: run_evaluate([*extra, *base], LAUNCHES_PER_FORWARD)
            for name, extra in (("unmasked", []),
                                ("masked", ["--mask-padding"]))}
    for name, run in runs.items():
        check(max(run["buckets"].values()) > 1,
              f"{name}: no call batched two items, buckets {run['buckets']}")
    ctx["eval_launches"] = {k: v["launches"] for k, v in runs.items()}
    emit({"phase": "evaluate", "config": "diffsep_icassp (nf=128, random "
          "weights seed 0)", "items": EVAL_ITEMS, "batch": EVAL_BATCH,
          "N": N_STEPS, "tf32_conv": True, "runtime_unit": "s/utt",
          "runs": runs,
          "masked_over_unmasked_runtime": (runs["masked"]["runtime"]
                                           / runs["unmasked"]["runtime"]),
          "card": ctx["card"]})


def phase_longform(ctx):
    """cli.separate --chunk-seconds at the flagship width on one 7 s
    synthetic file written to build/."""
    import shutil

    import numpy as np
    import torch
    from ditsep_tpu_torch.cli import separate as cli
    from ditsep_tpu_torch.data import SyntheticMixDataset, read_wav, write_wav
    from ditsep_tpu_torch.inference.longform import window_starts

    mix, _ = SyntheticMixDataset(n_items=1, min_len_s=LONGFORM_S,
                                 max_len_s=LONGFORM_S, seed=5)[0]
    n_samples = mix.shape[-1]
    root = REPO / "build" / "chip_smoke_longform"
    shutil.rmtree(root, ignore_errors=True)
    inp, outp = root / "in", root / "out"
    inp.mkdir(parents=True)
    write_wav(str(inp / "long.wav"), mix[0], FS)
    windows = len(window_starts(n_samples, int(CHUNK_S * FS),
                                int(OVERLAP_S * FS)))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    nfe = cli.main(["--config", "diffsep_icassp", "--input", str(inp),
                    "--output", str(outp), "--sampler-N", str(N_STEPS),
                    "--chunk-seconds", str(CHUNK_S), "--overlap-seconds",
                    str(OVERLAP_S), "--seed", "0"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    want = LAUNCHES_PER_FORWARD * nfe * windows
    check(nfe == 2 * N_STEPS, f"long-form NFE {nfe}")
    check(launches["fir_down2d"] == want
          and all(v == 0 for k, v in launches.items() if k != "fir_down2d"),
          f"long-form launches {launches}, want fir_down2d {want}")
    for src in ("s0", "s1"):
        data, fs = read_wav(str(outp / src / "long.wav"))
        check(fs == FS and data.shape == (n_samples,)
              and np.isfinite(data).all(), f"long-form output {src}")
    shutil.rmtree(root, ignore_errors=True)
    ctx["longform_launches"] = launches["fir_down2d"]
    emit({"phase": "longform", "config": "diffsep_icassp (nf=128, random "
          "weights seed 0)", "samples": n_samples, "chunk_s": CHUNK_S,
          "overlap_s": OVERLAP_S, "windows": windows, "N": N_STEPS,
          "seconds": wall_s, "launches": launches["fir_down2d"],
          "launches_want": want, "card": ctx["card"]})


def phase_upsample(ctx):
    """ops.fir.upsample_2d on the card against its CPU run at the
    flagship's 6 up-path shapes (TF32 off), and with TF32 on as the main
    path runs it (reported, not barred)."""
    import torch
    from ditsep_tpu_torch.ops import fir

    g = torch.Generator().manual_seed(8)
    rows = []
    worst = 0.0
    for i in range(6, 0, -1):  # the up blocks of levels 6..1
        c = 256 if i > 1 else 128
        shape = (1, c, 256 >> i, 576 >> i)
        x = torch.randn(shape, generator=g)
        ref = fir.upsample_2d(x, [1, 3, 3, 1])
        with full_f32():
            err = (fir.upsample_2d(x.cuda(), [1, 3, 3, 1]).cpu()
                   - ref).abs().max().item()
        err_tf32 = (fir.upsample_2d(x.cuda(), [1, 3, 3, 1]).cpu()
                    - ref).abs().max().item()
        check(err <= 1e-5, f"upsample_2d {shape}: card vs CPU {err}")
        worst = max(worst, err)
        rows.append({"shape": list(shape), "max_abs_err": err,
                     "max_abs_err_tf32_default": err_tf32})
    emit({"phase": "upsample_2d", "tolerance": 1e-5, "max_abs_err": worst,
          "rows": rows, "card": ctx["card"]})


def family_trainer(family: str, device: str):
    """``family``'s config at nf=32 with 4 levels and seeded weights, the
    zero-init layers redrawn at unit scale, on ``device``."""
    from ditsep_tpu_torch.configs import (
        CONFIG_FAMILIES, build_diffsep_trainer, override,
    )
    cfg = override(CONFIG_FAMILIES[family](), {
        "model.score_model.nf": 32,
        "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,)})
    trainer = build_diffsep_trainer(cfg, device="cpu", seed=0)
    unit_scale_zero_init_layers(trainer.model, seed=0)
    trainer.model.to(device)
    return trainer


def family_case(name: str, fs: int, n: int, rng):
    """One card-vs-CPU case: (family, samples, a function of the trainer
    and the mix that samples with explicit noise, made here, and returns
    (x, nfe))."""
    import dataclasses

    import numpy as np
    from ditsep_tpu_torch.sdes import ode_sample
    shape = (1, 2, fs)
    z = lambda *lead: rng.standard_normal(lead + shape).astype(  # noqa
        np.float32)
    if name in ("diffsep_ouve_pc", "enhancement_pc"):
        noise = (z(), z(n, 1), z(n))
        return lambda tr, mix: tr.separate(mix, N=n, noise=noise)
    if name == "diffsep_ab2":
        noise = (z(), None)
        return lambda tr, mix: tr.separate(mix, N=n, sampler="ab2",
                                           noise=noise)
    if name.startswith("diffsep_sb_"):
        kind = name.rsplit("_", 1)[1]
        noise = z(n) if kind == "sde" else None

        def sb(tr, mix):
            tr = dataclasses.replace(tr, sde=dataclasses.replace(
                tr.sde, sampler_type=kind))
            return tr.separate(mix, N=n, noise=noise)
        return sb
    if name == "diffsep_ouve_ode_rk4":
        prior = z()
        return lambda tr, mix: ode_sample(tr.sde, tr.model_fwd, mix, N=n,
                                          method="rk4", noise=prior)
    raise ValueError(name)


# card-vs-CPU cases of the families phase: (case, family, fs, N). The
# bridge's 'ode' runs N = 1: past its first step it scales the convs'
# float32 round-off by thousands (tests/test_torch_samplers.py), at the
# first alone by 63
FAMILY_CASES = (("diffsep_ouve_pc", "diffsep_ouve", 8000, 3),
                ("diffsep_sb_ode", "diffsep_sb", 8000, 1),
                ("diffsep_sb_sde", "diffsep_sb", 8000, 3),
                ("enhancement_pc", "enhancement", 16000, 3),
                ("diffsep_ab2", "diffsep", 8000, 3),
                ("diffsep_ouve_ode_rk4", "diffsep_ouve", 8000, 2))
# each family at its config's full width through cli.separate: (config,
# --sampler, samples, fs, NFE); diffsep_sb takes its bridge sampler, and
# no --sampler applies
FAMILY_CLI_RUNS = (("diffsep_ouve", "pc", FLAGSHIP_SAMPLES, 8000, 60),
                   ("diffsep_sb", None, FLAGSHIP_SAMPLES, 8000, 30),
                   ("enhancement", "pc", 48000, 16000, 60),
                   ("diffsep_icassp", "ab2", FLAGSHIP_SAMPLES, 8000, 30))
FAMILY_FILES = 2  # the call after the first gives the steady state


def phase_families(ctx):
    """The other SDE families and samplers: each case on the card (TF32
    off) against the CPU with the same explicit noise, 1 s of audio at
    nf=32 with 4 levels, within 1e-3 relative at the output waveform;
    then each family at its config's full width through cli.separate on
    written WAVs, with its NFE, peak memory, launches, each separate
    call's time, and one call profiled at N=2."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(21)
    parity = {}
    with full_f32():
        for name, family, fs, n in FAMILY_CASES:
            mix = (0.1 * rng.standard_normal((1, 1, fs))).astype(np.float32)
            run = family_case(name, fs, n, rng)
            out = {}
            for device in ("cuda", "cpu"):
                trainer = family_trainer(family, device)
                torch.cuda.synchronize()
                ck.fir_down2d.launches = 0
                with torch.no_grad():
                    est, nfe = run(trainer, torch.from_numpy(mix).to(device))
                torch.cuda.synchronize()
                out[device] = (est.float().cpu().numpy(), nfe,
                               ck.fir_down2d.launches)
            (gpu, nfe, launches), (cpu, nfe_cpu, launches_cpu) = (
                out["cuda"], out["cpu"])
            rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
            want = CKPT_LAUNCHES_PER_FORWARD * nfe
            check(gpu.shape == (1, 2, fs) and np.isfinite(gpu).all(),
                  f"{name}: card output shape / finiteness")
            check(nfe == nfe_cpu, f"{name}: NFE card {nfe} CPU {nfe_cpu}")
            check(rel <= 1e-3, f"{name}: card vs CPU {rel} > 1e-3")
            check(launches == want and launches_cpu == 0,
                  f"{name}: launches card {launches} (want {want}), CPU "
                  f"{launches_cpu}")
            parity[name] = {"family": family, "fs": fs, "N": n, "nfe": nfe,
                            "max_rel_err": rel, "launches_card": launches}
    emit({"phase": "families_parity", "config": "nf=32 ch_mult=(1,1,2,2) "
          "attn=(32,), seeded weights, zero-init layers at unit scale, 1 s",
          "tf32": False, "tolerance": 1e-3, "cases": parity,
          "card": ctx["card"]})

    from ditsep_tpu_torch.cli import separate as cli
    from ditsep_tpu_torch.data import SyntheticMixDataset, read_wav, write_wav
    runs = {}
    ctx["families_launches"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for config, sampler, samples, fs, nfe_want in FAMILY_CLI_RUNS:
            inp, outp = Path(tmp, config, "in"), Path(tmp, config, "out")
            inp.mkdir(parents=True)
            ds = SyntheticMixDataset(n_items=FAMILY_FILES, fs=fs,
                                     min_len_s=samples / fs,
                                     max_len_s=samples / fs, seed=7)
            for i in range(FAMILY_FILES):
                write_wav(str(inp / f"mix{i}.wav"), ds[i][0][0], fs)
            args = ["--config", config, "--input", str(inp), "--output",
                    str(outp), "--sampler-N", str(N_STEPS), "--seed", "0"]
            if sampler:
                args += ["--sampler", sampler]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with separate_calls() as calls:
                nfe = cli.main(args)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            trainer = calls[-1]["trainer"]
            # the sampler that ran: the bridge's for SBVE, else --sampler
            key = (f"{config}_bridge_{trainer.sde.sampler_type}"
                   if trainer.is_edm else f"{config}_{sampler}")
            want = LAUNCHES_PER_FORWARD * nfe * FAMILY_FILES
            check(nfe == nfe_want, f"{key}: NFE {nfe}")
            check(len(calls) == FAMILY_FILES and all(
                c["nfe"] == nfe for c in calls), f"{key}: separate calls")
            check(launches["fir_down2d"] == want and all(
                v == 0 for k, v in launches.items() if k != "fir_down2d"),
                f"{key}: launches {launches}, want fir_down2d {want}")
            for src in ("s0", "s1"):
                for i in range(FAMILY_FILES):
                    data, rate = read_wav(str(outp / src / f"mix{i}.wav"))
                    check(rate == fs and data.shape == (samples,)
                          and np.isfinite(data).all(),
                          f"{config} output {src}/{i}")
            ctx["families_launches"][f"separate_cli_{key}"] = (
                launches["fir_down2d"])
            times = separate_call_times(calls)
            times["profiled_call"] = profile_separate_call(calls[-1])
            flagship = ctx["flagship_cli_calls"]
            runs[key] = {"samples": samples, "fs": fs, "files": FAMILY_FILES,
                         "nfe_per_file": nfe, "cli_seconds": sec,
                         "cli_utt_per_s": FAMILY_FILES / sec, **times,
                         "steady_utt_per_s_vs_flagship": (
                             times["steady_utt_per_s"]
                             / flagship["steady_utt_per_s"]),
                         "peak_gib": peak, "launches": launches["fir_down2d"],
                         "launches_want": want}
            del calls, trainer
            torch.cuda.empty_cache()
    emit({"phase": "families", "what": "cli.separate at each config's full "
          "width (diffsep_ouve / diffsep_sb nf=64, enhancement and "
          "diffsep_icassp nf=128; 7 levels; seeded random weights), one "
          "file a separate call; each call timed on the host clock between "
          "two synchronizations (steady: the calls after the first, which "
          "sets up cuDNN), the whole CLI call too (model build included); "
          "one call replayed at N=2 under torch.profiler (idle share of "
          "the unprofiled replay); TF32 convs", "N": N_STEPS, "runs": runs,
          "flagship_cli_utt_per_s": ctx["flagship_cli_utt_per_s"],
          "flagship_separate_calls": ctx["flagship_cli_calls"],
          "card": ctx["card"]})


def write_vctk(root: Path, n_train: int, n_test: int, seconds: float):
    """A VCTK-DEMAND layout of synthetic 16 kHz noisy / clean pairs:
    clean the first source of a synthetic mixture, noisy the mixture."""
    from ditsep_tpu_torch.data import SyntheticMixDataset, write_wav
    for part, n, seed in (("train", n_train, 30), ("test", n_test, 31)):
        for kind in ("noisy", "clean"):
            (root / f"{kind}_{part}set_wav").mkdir(parents=True)
        ds = SyntheticMixDataset(n_items=n, fs=16000, min_len_s=seconds,
                                 max_len_s=seconds + 0.5, seed=seed)
        for i in range(n):
            mix, tgt = ds[i]
            write_wav(str(root / f"noisy_{part}set_wav" / f"p{i:03d}.wav"),
                      mix[0], 16000)
            write_wav(str(root / f"clean_{part}set_wav" / f"p{i:03d}.wav"),
                      tgt[0], 16000)


# the families' training runs: diffsep_sb at the flagship train batch
# (12 synthetic items of 5 s, batch 6: two epochs), enhancement on a
# VCTK-layout directory of 13 synthetic pairs (12 train, 1 held out for
# validation), batch 4 x 3 s crops at 16 kHz: one epoch
FAMILY_TRAIN_STEPS = 2
ENH_TRAIN_FILES, ENH_BATCH = 13, 4


def phase_families_train(ctx):
    """Two training runs through cli.train_diffsep on the card: diffsep_sb
    (the EDM loss, init hack 5 with p = 0) and enhancement (PriorMix,
    init hack 4, its VCTK-DEMAND loader); steps/s, peak memory and
    launches. Then two EDM train steps at nf=32 on the card against the
    CPU with the same batches and draws."""
    import gc

    import torch
    from ditsep_tpu_torch.cli import train_diffsep
    from ditsep_tpu_torch.configs import diffsep_sb, override
    from ditsep_tpu_torch.data import NoisyDataset
    from ditsep_tpu_torch.training.diffsep import DiffSepTrainer

    spans = []
    real_step = DiffSepTrainer.train_step

    def timed_step(self, state, batch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = real_step(self, state, batch, **kw)
        met["train/score_loss"].item()  # syncs
        spans.append(time.perf_counter() - t0)
        return state, met

    runs = {}
    ctx["families_train_launches"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        vctk = Path(tmp, "vctk")
        write_vctk(vctk, ENH_TRAIN_FILES, 1, 3.5)
        n_val = len(NoisyDataset(str(vctk), "val", len_s=None))
        # per run: its arguments, the forwards of a train step, and the
        # forwards of its validations: each validation batch runs the
        # score loss, the first valid_max_sep_batches (2 and 1) of them a
        # separation too (SB: N evaluations, PC: 2N; N = TRAIN_VAL_N)
        val_batches = -(-n_val // ENH_BATCH)
        for config, args, forwards, val in (
                ("diffsep_sb", ["--synthetic", "--synthetic-items",
                                str(TRAIN_ITEMS), "--synthetic-len-s",
                                str(TRAIN_LEN_S), "--batch-size",
                                str(TRAIN_BATCH), "--override",
                                f"model.sde.N={TRAIN_VAL_N}"],
                 2, -(-FAMILY_TRAIN_STEPS // (TRAIN_ITEMS // TRAIN_BATCH))
                 * (2 + TRAIN_VAL_N)),
                ("enhancement", ["--data-path", str(vctk), "--batch-size",
                                 str(ENH_BATCH), "--override",
                                 f"model.sampler.N={TRAIN_VAL_N}"],
                 1, val_batches + min(val_batches, 1) * 2 * TRAIN_VAL_N)):
            spans.clear()
            DiffSepTrainer.train_step = timed_step
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                state = train_diffsep.main(
                    ["--config", config, *args, "--max-steps",
                     str(FAMILY_TRAIN_STEPS), "--workdir",
                     str(Path(tmp, config))])
                torch.cuda.synchronize()
                total_s = time.perf_counter() - t0
                launches = counts()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
            finally:
                DiffSepTrainer.train_step = real_step
            check(state.step == FAMILY_TRAIN_STEPS == len(spans),
                  f"{config}: steps {state.step}, timed {len(spans)}")
            want = {"fir_down2d": LAUNCHES_PER_FORWARD * (
                        FAMILY_TRAIN_STEPS * forwards + val),
                    "fir_up2d": FAMILY_TRAIN_STEPS * forwards
                    * UP_LAUNCHES_PER_BACKWARD}
            want.update({k: 0 for k in launches if k not in want})
            check(launches == want, f"{config} train launches {launches}, "
                                    f"want {want}")
            vals = [json.loads(ln) for ln in open(Path(tmp, config,
                                                       "metrics.jsonl"))
                    if "val/si_sdr" in ln]
            check(vals and all(math.isfinite(v["val/si_sdr"])
                               and math.isfinite(v["val/score_loss"])
                               for v in vals), f"{config} validations {vals}")
            timed = spans[1:]  # the first step warms cuDNN
            runs[config] = {"steps": FAMILY_TRAIN_STEPS,
                            "step_s": list(spans),
                            "steps_per_s_2_3": len(timed) / sum(timed),
                            "total_s": total_s, "peak_gib": peak,
                            "validations": vals, "launches": launches}
            ctx["families_train_launches"][config] = launches
            del state
            gc.collect()
            torch.cuda.empty_cache()
    emit({"phase": "families_train", "what": "cli.train_diffsep, seeded "
          "random weights: diffsep_sb nf=64 at batch 6 x 40,960 samples "
          "(12 synthetic items of 5 s), enhancement nf=128 at batch 4 x "
          "48,000 samples (3 s crops at 16 kHz of a VCTK-layout directory "
          "of synthetic pairs); host clock around each train_step, "
          "synchronized; TF32 convs", "runs": runs, "card": ctx["card"]})

    # two EDM train steps of the checkpoint's weights, card vs CPU
    cfg = override(diffsep_sb(), {
        "model.score_model.nf": 32,
        "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,)})
    batches, draws = train_parity_draws(2, 2, seed=12)
    hist = train_steps_card_vs_cpu(cfg, batches, draws)
    plain = train_parity_worst(hist, explain=False)
    worst = train_parity_worst(hist, explain=True)
    check(worst["param_over_bar"] <= 1 and worst["ema_over_bar"] <= 1,
          f"card vs CPU EDM train steps: {worst}")
    emit({"phase": "families_train_parity", "config": "diffsep_sb (EDM, "
          "init hack 5 with p 0) at nf=32 ch_mult=(1,1,2,2) attn=(32,), "
          "the checkpoint's weights", "batch": 2,
          "samples": int(batches[0][0].shape[-1]), "steps": len(batches),
          "tf32": False, **{k: float(v) for k, v in worst.items()},
          "plain_bar": {k: float(v) for k, v in plain.items()},
          "losses_card": [h["loss"] for h in hist["cuda"]["steps"]],
          "losses_cpu": [h["loss"] for h in hist["cpu"]["steps"]],
          "tolerance": TRAIN_PARITY_TOLERANCE + "; plus twice the part "
          "of the difference the devices' gradients explain through "
          "float64 clip + Adam (plain_bar: without it)",
          "card": ctx["card"]})


# the media path (phase media): cli.train_diffsep at the flagship width
# for one step of one batch of 6 x 5 s, a demo separation of the first
# two validation items after it (--demo-every 1), then the epoch's
# validation (its 4 items fill one batch of 6: the score loss and a PC
# separation) with its media; every separation at N=MEDIA_N
MEDIA_ITEMS, MEDIA_STEPS, MEDIA_DEMO_ITEMS = 6, 1, 2
MEDIA_EVAL_ITEMS, MEDIA_EVAL_LEN_S, MEDIA_N = 2, 2.0, 5
# the reference checkpoint (phase import): a short separation at N = 2
IMPORT_LEN_S, IMPORT_N = 2.0, 2


class RecordingLogger:
    """A MetricsLogger stand-in that keeps every audio call; its guard
    swallows nothing."""

    def __init__(self):
        self.audio = []

    def guarded(self, what, step, fn, *args, **kwargs):
        fn(*args, **kwargs)

    def log_audio(self, tag, wav, step, fs=8000):
        import numpy as np
        self.audio.append((tag, step, fs, np.asarray(wav, np.float32)))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms within (two runs of one call
    compared bit for bit)."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def media_events(work: Path, demo_len: int, have_mpl: bool) -> dict:
    """The TensorBoard events of the media run: the demo and validation
    audio tags with JAX's names, in JAX's order, the demo's lengths, and
    the validation's spectrogram figure where matplotlib is installed."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tb_events", REPO / "tests" / "tb_events.py")
    tb_events = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tb_events)
    ev = [e for e in tb_events.read_events(str(work / "tb"))
          if e["kind"] != "scalar"]
    want = [f"demo/mix/{i}" for i in range(MEDIA_DEMO_ITEMS)]
    for s in range(2):
        want += [f"demo/{k}_{s}/{i}" for k in ("est", "target")
                 for i in range(MEDIA_DEMO_ITEMS)]
    want += ["val/mix", "val/est_0", "val/est_1"]
    want += ["val/spectrograms"] if have_mpl else []
    check([e["tag"] for e in ev] == want and all(
        e["step"] == MEDIA_STEPS for e in ev),
        f"media events {[(e['step'], e['tag']) for e in ev]}")
    frames = {e["tag"]: e.get("frames") for e in ev}
    check(all(frames[t] == demo_len for t in want if t.startswith("demo")),
          f"demo lengths {frames}")
    val = {frames[t] for t in ("val/mix", "val/est_0", "val/est_1")}
    check(len(val) == 1 and val.pop() >= demo_len, f"val lengths {frames}")
    return {"tags": len(ev), "frames": frames}


def phase_media(ctx):
    """(a) cli.train_diffsep --demo-every 1 at the flagship width: the
    demo's and the validation's separations launch fir_down2d NFE x 18
    each (NFE from the sampler's return), the step fir_up2d; no callback
    or media failed; the event file read back where tensorboardX is
    installed; the callback through the API against ``trainer.separate``
    with the same generator state, bit for bit. (b) cli.evaluate
    --save-figures 2 --save-samples 2 at the flagship width: the PDFs
    (where matplotlib is installed) and the wavs. (c) cli.unwrap_model on
    (a)'s checkpoints, then cli.separate --params on its .npz against a
    direct separate with (a)'s EMA and the same generator, bit for bit."""
    import importlib.util

    import numpy as np
    import torch
    from ditsep_tpu_torch import viz
    from ditsep_tpu_torch.cli import evaluate as eval_cli
    from ditsep_tpu_torch.cli import separate as sep_cli
    from ditsep_tpu_torch.cli import train_diffsep, unwrap_model
    from ditsep_tpu_torch.cli.common import make_dataset, make_demo_callbacks
    from ditsep_tpu_torch.configs import diffsep_icassp
    from ditsep_tpu_torch.data import read_wav, write_wav

    have_tb = importlib.util.find_spec("tensorboardX") is not None
    have_mpl = viz.available()
    emit({"phase": "media_libraries", "tensorboardX": have_tb,
          "matplotlib": have_mpl})
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp, "run")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with separate_calls() as calls:
            state = train_diffsep.main([
                "--config", "diffsep_icassp", "--synthetic",
                "--synthetic-items", str(MEDIA_ITEMS), "--synthetic-len-s",
                str(TRAIN_LEN_S), "--batch-size", str(TRAIN_BATCH),
                "--max-steps", str(MEDIA_STEPS), "--demo-every", "1",
                "--override", f"model.sampler.N={MEDIA_N}",
                "--workdir", str(work)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches["media_train_cli"] = counts()
        check(state.step == MEDIA_STEPS, f"media steps {state.step}")
        check(state.media_failures == 0,
              f"{state.media_failures} callback / media failures")
        # the demo (its 2 items) then the validation (one batch of 6)
        sizes = [c["mix"].shape[0] for c in calls]
        check(sizes == [MEDIA_DEMO_ITEMS, TRAIN_BATCH],
              f"separate calls of batch {sizes}")
        nfes = [c["nfe"] for c in calls]
        check(all(n == 2 * MEDIA_N for n in nfes), f"NFE {nfes}")
        want = {"fir_down2d": LAUNCHES_PER_FORWARD * (
                    MEDIA_STEPS * 2 + VAL_BATCHES * 2 + sum(nfes)),
                "fir_up2d": MEDIA_STEPS * 2 * UP_LAUNCHES_PER_BACKWARD}
        want.update({k: 0 for k in launches["media_train_cli"]
                     if k not in want})
        check(launches["media_train_cli"] == want,
              f"media train launches {launches['media_train_cli']}, want "
              f"{want}")
        trainer = calls[0]["trainer"]
        del calls
        cfg = diffsep_icassp()
        (cb,) = make_demo_callbacks(make_dataset(
            cfg, "val", None, True, synthetic_len_s=TRAIN_LEN_S,
            synthetic_items=4), 1)
        demo_len = cb.demo_batch[0].shape[-1]
        events = (media_events(work, demo_len, have_mpl) if have_tb
                  else None)
        # the callback through the API: its stems are trainer.separate's
        # with the same generator state
        rec = RecordingLogger()
        with deterministic_cudnn():
            reset_counts()
            cb(rec, MEDIA_STEPS, trainer, state,
               torch.Generator(device="cuda").manual_seed(21))
            launches["media_demo_api"] = counts()
            est, nfe = trainer.separate(
                torch.from_numpy(cb.demo_batch[0]).cuda(), model=state.ema,
                generator=torch.Generator(device="cuda").manual_seed(21))
        est = est.float().cpu().numpy()
        stems = {t: w for t, _, _, w in rec.audio}
        check(all(np.array_equal(stems[f"demo/est_{s}/{i}"], est[i, s])
                  for s in range(2) for i in range(MEDIA_DEMO_ITEMS)),
              "the API callback's stems differ from trainer.separate's")
        check(launches["media_demo_api"]["fir_down2d"]
              == LAUNCHES_PER_FORWARD * nfe,
              f"demo API launches {launches['media_demo_api']}")
        emit({"phase": "media_train", "config": "diffsep_icassp (nf=128, "
              f"random weights seed 0), batch {TRAIN_BATCH} x "
              f"{TRAIN_LEN_S} s, {MEDIA_STEPS} step, --demo-every 1",
              "seconds": train_s, "separate_nfe": nfes,
              "launches": launches["media_train_cli"],
              "media_failures": state.media_failures,
              "events": events, "api_callback": {
                  "audio_calls": len(rec.audio), "nfe": nfe,
                  "stems_equal_separate": True,
                  "launches": launches["media_demo_api"]},
              "card": ctx["card"]})

        # (b) figures and samples of cli.evaluate at the flagship width
        out = Path(tmp, "eval")
        reset_counts()
        res = eval_cli.main([
            "--config", "diffsep_icassp", "--synthetic", "--synthetic-items",
            str(MEDIA_EVAL_ITEMS), "--synthetic-len-s",
            str(MEDIA_EVAL_LEN_S), "--eval-batch-size",
            str(MEDIA_EVAL_ITEMS), "--sampler-N", str(MEDIA_N),
            "--save-samples", str(MEDIA_EVAL_ITEMS), "--save-figures",
            str(MEDIA_EVAL_ITEMS), "--out-dir", str(out)])
        launches["media_evaluate"] = counts()
        names = sorted(p.name for p in (out / "librimix_test_media")
                       .iterdir())
        pdfs = [n for n in names if n.endswith(".pdf")]
        wavs = [n for n in names if n.endswith(".wav")]
        check(len(pdfs) == (MEDIA_EVAL_ITEMS if have_mpl else 0)
              and len(wavs) == 2 * MEDIA_EVAL_ITEMS, f"media files {names}")
        check(res["media_failures"] == 0,
              f"{res['media_failures']} figures failed")
        check(launches["media_evaluate"]["fir_down2d"]
              == res["calls"] * 2 * MEDIA_N * LAUNCHES_PER_FORWARD,
              f"evaluate launches {launches['media_evaluate']}")
        emit({"phase": "media_evaluate", "files": names,
              "media_failures": res["media_failures"],
              "calls": res["calls"], "launches": launches["media_evaluate"],
              "card": ctx["card"]})

        # (c) the unwrapped EMA through cli.separate --params
        npz = Path(tmp, "ema_unwrapped.npz")
        unwrap_model.main(["--ckpt-dir", str(work / "checkpoints"), "--out",
                           str(npz)])
        inp, outp = Path(tmp, "in"), Path(tmp, "out")
        inp.mkdir()
        mix, _ = synthetic_batch(1, MEDIA_EVAL_LEN_S, seed=4)
        write_wav(str(inp / "item.wav"), mix[0, 0], FS)
        with deterministic_cudnn():
            reset_counts()
            nfe = sep_cli.main(["--config", "diffsep_icassp", "--input",
                                str(inp), "--output", str(outp), "--params",
                                str(npz), "--sampler-N", str(MEDIA_N),
                                "--seed", "7"])
            launches["media_unwrapped_separate"] = counts()
            x, _ = read_wav(str(inp / "item.wav"))
            x = x.reshape(1, 1, -1).astype(np.float32)
            est, _ = trainer.separate(
                torch.from_numpy(x).cuda(), N=MEDIA_N, model=state.ema,
                generator=torch.Generator(device="cuda").manual_seed(7))
        est = sep_cli.scale_output(x[0], est[0].float().cpu().numpy())
        for s in range(2):
            write_wav(str(Path(tmp, f"direct{s}.wav")), est[s], FS)
            got, _ = read_wav(str(outp / f"s{s}" / "item.wav"))
            want, _ = read_wav(str(Path(tmp, f"direct{s}.wav")))
            check(np.array_equal(got, want),
                  f"unwrapped EMA stem {s} differs from the EMA's")
        check(launches["media_unwrapped_separate"]["fir_down2d"]
              == nfe * LAUNCHES_PER_FORWARD,
              f"unwrapped separate launches "
              f"{launches['media_unwrapped_separate']}")
        emit({"phase": "media_unwrap", "nfe": nfe,
              "stems_equal_ema": True,
              "launches": launches["media_unwrapped_separate"],
              "card": ctx["card"]})
    ctx["media_launches"] = launches
    del state, trainer
    torch.cuda.empty_cache()


def phase_import(ctx):
    """(d) A Lightning-layout DiffSep checkpoint at the flagship width
    (the score network under ``score_model.backbone.`` after the sigmas
    buffer, torch_ema's shadows in parameter order, each a distinct
    perturbation of its parameter) written with torch.save, read back and
    loaded by ``import_diffsep_ema`` into a fresh nf=128 model on the
    card: its parameters are the shadows bit for bit, and a separation
    with matched noise equals the same weights' from an .npz;
    ``utils.hub.load_reference_diffsep_params`` on the same file gives
    ``import_params(prefix="score_model.")``'s weights bit for bit. Then
    the full-width OobleckVAE from a ``weight_g`` / ``weight_v`` state
    dict: encode and decode equal the .npz-loaded VAE's."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.configs import (
        build_diffsep_trainer, diffsep_icassp, latent_diffsep_ouve,
    )
    from ditsep_tpu_torch.configs.build import build_oobleck_vae
    from ditsep_tpu_torch.models import (
        import_diffsep_ema, import_oobleck_params, import_params,
        load_torch_ckpt, save_params_npz,
    )
    from ditsep_tpu_torch.utils.hub import load_reference_diffsep_params

    cfg = diffsep_icassp()
    src = build_diffsep_trainer(cfg, device="cpu", seed=0)
    unit_scale_zero_init_layers(src.model, seed=0)
    bb = src.model.backbone
    sd = {"score_model.backbone.sigmas": torch.linspace(0.05, 0.5, 1000)}
    sd.update({f"score_model.backbone.{k}": v.clone()
               for k, v in bb.state_dict().items()})
    trainable = [k for k, _ in bb.named_parameters()]
    g = torch.Generator().manual_seed(5)
    shadows = [p.detach() + 1e-3 * (1 + i / len(trainable)) * torch.randn(
        p.shape, generator=g) for i, (_, p) in enumerate(
            bb.named_parameters())]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "epoch=029-si_sdr=14.804.ckpt")
        torch.save({"state_dict": sd, "ema": {"shadow_params": shadows},
                    "epoch": 29, "global_step": 0,
                    "hyper_parameters": {"nf": 128}}, path)
        t0 = time.perf_counter()
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        fresh = build_diffsep_trainer(cfg, device="cuda", seed=1)
        import_diffsep_ema(fresh.model, ckpt)
        out["import_s"] = time.perf_counter() - t0
        out["file_gib"] = path.stat().st_size / 2 ** 30
        flat = load_torch_ckpt(str(path))
        check(list(flat) == list(sd), "load_torch_ckpt's keys")
        del ckpt, flat
        got = fresh.model.backbone.state_dict()
        check(all(torch.equal(got[k].cpu(), s)
                  for k, s in zip(trainable, shadows)),
              "imported parameters are not the EMA shadows")
        check(torch.equal(got["all_modules.0.W"].cpu(),
                          sd["score_model.backbone.all_modules.0.W"]),
              "the Fourier W is not the state_dict's")
        # the same weights through the JAX package's .npz layout
        with torch.no_grad():
            for k, s in zip(trainable, shadows):
                bb.get_parameter(k).copy_(s)
        npz = Path(tmp, "ema.npz")
        save_params_npz(str(npz), src.model)
        via_npz = build_diffsep_trainer(cfg, device="cuda",
                                        params_npz=str(npz))
        del src
        mix = torch.from_numpy(synthetic_batch(2, IMPORT_LEN_S, seed=6)[0]
                               ).cuda()
        n = mix.shape[-1]
        gen = torch.Generator(device="cuda").manual_seed(8)
        shape = (2, 2, n)
        noise = (torch.randn(shape, generator=gen, device="cuda"),
                 torch.randn((IMPORT_N, 1) + shape, generator=gen,
                             device="cuda"),
                 torch.randn((IMPORT_N,) + shape, generator=gen,
                             device="cuda"))
        ests = {}
        with deterministic_cudnn():
            for name, tr in (("import", fresh), ("npz", via_npz)):
                reset_counts()
                ests[name], nfe = tr.separate(mix, N=IMPORT_N, noise=noise)
                out[f"{name}_launches"] = counts()
                check(out[f"{name}_launches"]["fir_down2d"]
                      == nfe * LAUNCHES_PER_FORWARD,
                      f"{name} launches {out[f'{name}_launches']}")
        check(bool(torch.isfinite(ests["import"]).all())
              and torch.equal(ests["import"], ests["npz"]),
              "the imported checkpoint separates unlike its .npz")
        ctx["media_launches"] = {**ctx.get("media_launches", {}),
                                 "import_separate": out["import_launches"]}
        del ests

        # the hub loader on the same file into the imported model, the
        # import_params route into the .npz one: the same bits
        t0 = time.perf_counter()
        check(load_reference_diffsep_params(fresh.model, str(path))
              is fresh.model, "the hub loader returns its model")
        out["hub_s"] = time.perf_counter() - t0
        import_params(via_npz.model, load_torch_ckpt(str(path)),
                      prefix="score_model.")
        got, want = fresh.model.state_dict(), via_npz.model.state_dict()
        check(got.keys() == want.keys()
              and all(torch.equal(v, want[k]) for k, v in got.items()),
              "the hub loader's weights are not import_params'")
        check(torch.equal(got[f"backbone.{trainable[0]}"].cpu(),
                          sd[f"score_model.backbone.{trainable[0]}"]),
              "the hub loader did not load the checkpoint's state_dict")
        del fresh, via_npz, got, want
        torch.cuda.empty_cache()

        # the OobleckVAE from a weight_g / weight_v state dict
        vcfg = latent_diffsep_ouve()["model"]["vae"]
        vsrc = build_oobleck_vae(vcfg, device="cpu", seed=3)
        vsd = {f"autoencoder.{k}": v for k, v in vsrc.state_dict().items()}
        vsd["autoencoder.bottleneck.noise_scale"] = torch.ones(1)
        vae = build_oobleck_vae(vcfg, device="cuda", seed=4)
        import_oobleck_params(vae, vsd, prefix="autoencoder.")
        vnpz = Path(tmp, "vae.npz")
        save_params_npz(str(vnpz), vsrc)
        vae_npz = build_oobleck_vae(vcfg, device="cuda",
                                    params_npz=str(vnpz))
        check(all(torch.equal(v, vae_npz.state_dict()[k])
                  for k, v in vae.state_dict().items()),
              "the imported VAE's weights are not the .npz's")
        audio = mix[:, :, :vae.downsampling_ratio * (
            n // vae.downsampling_ratio)]
        with torch.no_grad(), deterministic_cudnn():
            z, z_npz = vae.encode(audio), vae_npz.encode(audio)
            y, y_npz = vae.decode(z), vae_npz.decode(z)
        check(torch.equal(z, z_npz) and torch.equal(y, y_npz)
              and bool(torch.isfinite(y).all()),
              "the imported VAE encodes / decodes unlike its .npz")
        out["vae"] = {"latent": list(z.shape), "audio": list(y.shape)}
        del vae, vae_npz, vsrc
    emit({"phase": "import", "config": "diffsep_icassp (nf=128) from a "
          "Lightning-layout checkpoint, EMA shadows applied by parameter "
          f"order; separate at N={IMPORT_N} on 2 x {n} samples, matched "
          "noise, deterministic cuDNN; the hub loader on the same file; "
          "latent_diffsep_ouve's VAE (channels 128, hop 2048) from weight_g "
          "/ weight_v", **out,
          "card": ctx["card"]})
    torch.cuda.empty_cache()


# the baselines, backbones, NCSN++ options and the streaming bench (no kernel
# of the port lies on the SepFormer's or the backbones' paths; the option
# configs and the streaming bench run fir_down2d)
SEPFORMER_LENGTHS = (67320, 16000, 30976, 52815)  # 8.415 s first, 2-8.415 s
SEPFORMER_SMALL = dict(enc_channels=64, out_channels=64, chunk_size=50,
                       num_dp_layers=2, num_tf_layers=2, n_heads=4,
                       d_ffn=128)
CARD_CPU_REL = 1e-3  # card vs CPU, TF32 off, of max|cpu|
BACKBONE_FRAMES = 2000  # 2 s at the Conv-TasNet encoder's stride 8
DIFFUSE_SAMPLES = 8000
# the two NCSN++ option configs at the flagship's width (nf=128, 7 levels,
# attention at 16), each one score forward at batch 4 x 8.415 s, f32: DDPM
# blocks with FIR Downsample between levels (fir_down2d 6) and the
# input_skip pyramid (6); BigGAN blocks (12) with both pyramids residual
# (their resamplers conv-fused, no fir_down2d): 12 launches a forward each
OPTION_CONFIGS = {
    "ddpm_fir": {"resblock_type": "ddpm", "resamp_with_conv": False},
    "biggan_residual": {"progressive": "residual",
                        "progressive_input": "residual"}}
OPTION_LAUNCHES_PER_FORWARD = 12
OPTION_REPS = 5
OPTION_PARITY_SAMPLES = 16000
STREAM_BENCH_S = 8.0  # one 8 s window (12 until PR 19)


def card_vs_cpu(module, args: tuple, seed: int) -> float:
    """``module`` seeded from ``seed`` on the CPU, then moved to the card:
    max|card - cpu| / max|cpu| of one forward on the same inputs, TF32
    off. The module stays on the card."""
    import torch
    module.reset_parameters(torch.Generator().manual_seed(seed))
    module.eval()
    with torch.no_grad():
        want = module(*args)
        with full_f32():
            got = module.cuda()(*(a.cuda() for a in args))
    return _rel(got, want)


def phase_sepformer(ctx):
    """The SepFormer baseline at sepformer-wsj02mix's widths (seeded
    weights): ``ditsep_tpu_torch.cli.sepformer_baseline`` (its ``main``,
    the ``python -m`` entry) on 4 written mixtures of 2-8.415 s at 8 kHz
    (--bucket 8192): the written stems, its parameter count, each file's
    seconds (the steady state: those after the first), peak GiB, every
    launch count 0; then a small SepFormer card vs CPU."""
    import contextlib
    import io

    import numpy as np
    import torch
    from ditsep_tpu_torch.cli import sepformer_baseline
    from ditsep_tpu_torch.data import read_wav, write_wav
    from ditsep_tpu_torch.models.sepformer import SepFormer

    rng = np.random.default_rng(16)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ind, outd = Path(tmp, "in"), Path(tmp, "out")
        ind.mkdir()
        names = []
        for i, n in enumerate(SEPFORMER_LENGTHS):
            names.append(f"mix{i}.wav")
            write_wav(str(ind / names[-1]), (0.1 * rng.standard_normal(
                n)).astype(np.float32), FS)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            sepformer_baseline.main(["--input", str(ind), "--output",
                                     str(outd)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        summary = json.loads(out.getvalue().strip().splitlines()[-1])
        for name, n in zip(names, SEPFORMER_LENGTHS):
            for s in range(2):
                est, fs = read_wav(str(outd / f"s{s}" / name))
                check(fs == FS and est.shape == (n,)
                      and bool(np.isfinite(est).all()),
                      f"sepformer stem s{s}/{name}: {est.shape}")
    check(summary["files"] == len(SEPFORMER_LENGTHS)
          and "RANDOM weights" in out.getvalue(), f"sepformer: {summary}")
    g = torch.Generator().manual_seed(4)
    mix = 0.1 * torch.randn(2, 12000, generator=g)
    reset_counts()
    rel = card_vs_cpu(SepFormer(**SEPFORMER_SMALL), (mix,), 5)
    small_launches = counts()
    check(not any(launches.values()) and not any(small_launches.values()),
          f"sepformer launches {launches}, {small_launches}")
    check(rel <= CARD_CPU_REL, f"small SepFormer card vs CPU {rel}")
    ctx.setdefault("slice_launches", {}).update({
        "sepformer_cli": launches, "sepformer_parity": small_launches})
    torch.cuda.empty_cache()
    emit({"phase": "sepformer", "config": "sepformer-wsj02mix widths "
          "(encoder 256, kernel 16 / stride 8, chunk 250, 2 dual-path "
          "layers of 8-layer transformers, 8 heads, FFN 1024), seeded; "
          f"{len(SEPFORMER_LENGTHS)} files {list(SEPFORMER_LENGTHS)} samples "
          "at 8 kHz, bucket 8192", "params": summary["params"],
          "file_s": summary["file_s"],
          "s_per_file_steady": float(np.mean(summary["file_s"][1:])),
          "cli_s": cli_s, "peak_gib": peak, "launches": launches,
          "small_card_vs_cpu_rel": rel, "tolerance": CARD_CPU_REL,
          "card": ctx["card"]})


def phase_backbones(ctx):
    """One forward each of the alternative backbones card vs CPU (TF32
    off, within 1e-3 of max|cpu|), then its time on the card (TF32 convs,
    CUDA events): the Conv-TasNet TCN at its defaults (N=B=256, H=512,
    P=3, X=8, R=4) on 2 x 2,000 frames, DPTNet (64 wide, hidden 128, 4
    heads, 2 layers, chunk 100) with LSTM and with GRU, DiffuSE at 64 x 30
    on 2 x 8,000 samples. No kernel of the port lies on them."""
    import torch
    from ditsep_tpu_torch.models import backbones as B
    from ditsep_tpu_torch.utils.timing import call_ms

    g = torch.Generator().manual_seed(6)
    w = torch.randn(2, 256, BACKBONE_FRAMES, generator=g)
    d = torch.randn(2, 64, BACKBONE_FRAMES, generator=g)
    xt = torch.randn(2, 1, DIFFUSE_SAMPLES, generator=g)
    cases = {
        "tcn": (B.TemporalConvNet(), (w,)),
        "dptnet_lstm": (B.DPTNet(64, 128, rnn_type="lstm"), (d,)),
        "dptnet_gru": (B.DPTNet(64, 128, rnn_type="gru"), (d,)),
        "diffuse": (B.DiffuSE(64, 30),
                    (xt, torch.tensor([0.2, 0.7]),
                     torch.randn(2, 1, DIFFUSE_SAMPLES, generator=g)))}
    rows = {}
    reset_counts()
    for i, (name, (model, args)) in enumerate(cases.items()):
        rel = card_vs_cpu(model, args, 10 + i)
        check(rel <= CARD_CPU_REL, f"{name}: card vs CPU {rel}")
        cuda_args = [a.cuda() for a in args]
        with torch.no_grad():
            ms = call_ms(lambda: model(*cuda_args), iters=5, warmup=2)
        rows[name] = {"card_vs_cpu_rel": rel, "ms": ms,
                      "params": sum(p.numel() for p in model.parameters()),
                      "input": [list(a.shape) for a in args]}
        del model, cuda_args
    launches = counts()
    check(not any(launches.values()), f"backbones launches {launches}")
    ctx.setdefault("slice_launches", {})["backbones"] = launches
    torch.cuda.empty_cache()
    emit({"phase": "backbones", "rows": rows, "tolerance": CARD_CPU_REL,
          "launches": launches, "card": ctx["card"]})


def option_score_model(nf: int, opts: dict, seed: int):
    """The flagship score model (7 levels, attention at 16) at width
    ``nf`` with the NCSN++ options ``opts``, seeded on the CPU, the
    zero-init layers at unit scale, in eval mode."""
    import torch
    from ditsep_tpu_torch.models import NCSNpp
    from ditsep_tpu_torch.models.score_models import ScoreModelNCSNpp
    sm = ScoreModelNCSNpp(num_sources=2, nf=nf)
    sm.backbone = NCSNpp(nf=nf, ch_mult=(1, 1, 2, 2, 2, 2, 2),
                         num_res_blocks=2, attn_resolutions=(16,),
                         image_size=256, num_channels_in=6,
                         num_channels_out=4, **opts)
    sm.backbone.reset_parameters(torch.Generator().manual_seed(seed))
    unit_scale_zero_init_layers(sm, seed + 1)
    return sm.eval()


def phase_ncsnpp_options(ctx):
    """NCSN++'s other block options (OPTION_CONFIGS): each as a score
    model at the flagship's width, one forward at batch 4 x 8.415 s in
    f32 (TF32 convs) timed over OPTION_REPS after warm-up, its fir_down2d
    launches a forward against OPTION_LAUNCHES_PER_FORWARD; then at
    nf=16 card vs CPU, TF32 off, within 1e-3 of max|cpu|."""
    import torch

    rows = {}
    g = torch.Generator().manual_seed(7)
    for i, (name, opts) in enumerate(OPTION_CONFIGS.items()):
        sm = option_score_model(16, opts, 20 + i)
        n = OPTION_PARITY_SAMPLES
        args = (torch.randn(1, 2, n, generator=g), torch.tensor([0.5]),
                torch.randn(1, 1, n, generator=g))
        with torch.no_grad():
            want = sm(*args)
            with full_f32():
                got = sm.cuda()(*(a.cuda() for a in args))
        rel = _rel(got, want)
        check(rel <= CARD_CPU_REL, f"{name} nf=16: card vs CPU {rel}")

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sm = option_score_model(128, opts, 30 + i).cuda()
        x, y = (torch.randn(BATCH, c, FLAGSHIP_SAMPLES, generator=g).cuda()
                for c in (2, 1))
        t = torch.full((BATCH,), 0.5).cuda()
        predicted = OPTION_LAUNCHES_PER_FORWARD
        with torch.no_grad():
            for _ in range(2):  # cuDNN's set-up
                sm(x, t, y)
            torch.cuda.synchronize()
            reset_counts()
            out = sm(x, t, y)
            torch.cuda.synchronize()
            launches = counts()
            ms = []
            for _ in range(OPTION_REPS):
                t0 = time.perf_counter()
                sm(x, t, y)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
        check(launches["fir_down2d"] == predicted and sum(
            launches.values()) == predicted, f"{name}: launches {launches}")
        check(bool(torch.isfinite(out).all()) and out.shape == x.shape,
              f"{name}: output {tuple(out.shape)}")
        ctx.setdefault("slice_launches", {})[f"ncsnpp_{name}"] = launches
        rows[name] = {"options": opts, "card_vs_cpu_rel_nf16": rel,
                      "forward_ms": ms, "fir_down2d_launches": launches[
                          "fir_down2d"], "predicted": predicted,
                      "params": sum(p.numel() for p in sm.parameters()),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del sm, x, y, out
        torch.cuda.empty_cache()
    emit({"phase": "ncsnpp_options", "config": "score model nf=128, 7 "
          "levels, attention at 16, seeded (zero-init layers at unit "
          f"scale), batch {BATCH} x {FLAGSHIP_SAMPLES} samples, f32 (TF32 "
          "convs)", "rows": rows, "tolerance": CARD_CPU_REL,
          "card": ctx["card"]})


def phase_streaming_bench(ctx):
    """``ditsep_tpu_torch.scripts.streaming_bench`` on 8 s of stream (the
    flagship in bf16, PC N=30, 8 s windows, 1 s overlap, 0.25 s blocks):
    its JSON line, and fir_down2d's launches = 18 x the NFE of every
    window, the warm-up's included."""
    import torch
    from ditsep_tpu_torch.scripts import streaming_bench

    reset_counts()
    result, nfe = streaming_bench.run(STREAM_BENCH_S)
    launches = counts()
    want = LAUNCHES_PER_FORWARD * (nfe["warmup"] + sum(nfe["windows"]))
    check(launches["fir_down2d"] == want and sum(launches.values()) == want,
          f"streaming bench launches {launches}, predicted {want}")
    check(result["n_windows"] == len(nfe["windows"]) and all(
        n == 2 * N_STEPS for n in nfe["windows"]), f"streaming {nfe}")
    ctx.setdefault("slice_launches", {})["streaming_bench"] = launches
    emit(result)
    emit({"phase": "streaming_bench", "nfe": nfe, "launches": launches,
          "predicted_fir_down2d": want, "card": ctx["card"]})
    torch.cuda.empty_cache()


# FACodec (no kernel of the port lies on it): the demo at the shipped widths
# on 16 kHz files of 2-8.415 s, 8.415 s first; a small codec card vs CPU;
# the parameter counts of the JAX package's ``jax.eval_shape`` (the card's
# machine has no JAX), which model_info must print
FACODEC_FS = 16000
FACODEC_LENGTHS = (134640, 32000, 61952, 105630)
FACODEC_SMALL_ENC = dict(ngf=4, up_ratios=(2, 5), out_channels=32)
FACODEC_SMALL_DEC = dict(in_channels=32, ngf=4, up_ratios=(5, 2),
                         upsample_initial_channel=64, codebook_size=16,
                         codebook_dim=4, phone_classes=7, timbre_layers=2,
                         timbre_heads=2)
FACODEC_SMALL_SAMPLES = 4000
FACODEC_MARGIN = 1e-4  # the top-2 cosine margin where codes must agree
JAX_PARAMS = {"FACodecEncoder": 4_210_528, "FACodecDecoder": 16_742_447,
              "ScoreModelNCSNpp": 65_623_366}
FACODEC_DEMO_DECODER_PARAMS = 29_079_407  # upsample_initial_channel 1024


def vq_margins(dec, h):
    """The top-2 cosine margin of every quantizer of ``dec`` at each of
    ``h``'s frames (B, T): the least over the layers, each on the residual
    it quantizes."""
    import torch
    from ditsep_tpu_torch.models.facodec import FactorizedVQ
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(mod.scores(mod.proj_in(args[0]))))
        for m in dec.modules() if isinstance(m, FactorizedVQ)]
    try:
        with torch.no_grad():
            dec.quantize(h.transpose(1, 2))
    finally:
        for hk in hooks:
            hk.remove()
    top2 = [s.topk(2, dim=-1).values for s in seen]
    return torch.stack([t[..., 0] - t[..., 1] for t in top2]).amin(0)


def facodec_parity(device: str = "cuda") -> dict:
    """The small codec seeded on the CPU, then on ``device``, TF32 off:
    the encoder, the decoder's ``return_info`` (codes equal wherever every
    quantizer's margin clears FACODEC_MARGIN; the audio and the heads when
    all codes agree), ``vq2emb`` of the CPU's codes and
    ``decode_with_timbre`` under another speaker, each max|dev - cpu| /
    max|cpu|."""
    import copy

    import torch
    from ditsep_tpu_torch.models.facodec import (
        FACodecDecoder, FACodecEncoder,
    )

    # seed 30: every frame's margin clears FACODEC_MARGIN on the CPU
    g = torch.Generator().manual_seed(30)
    enc, dec = FACodecEncoder(**FACODEC_SMALL_ENC), FACodecDecoder(
        **FACODEC_SMALL_DEC)
    enc.reset_parameters(g)
    dec.reset_parameters(g)
    enc.eval()
    dec.eval()
    x = 0.3 * torch.randn(2, 1, FACODEC_SMALL_SAMPLES, generator=g)
    spk = torch.randn(2, FACODEC_SMALL_DEC["in_channels"], generator=g)

    def run(e, d, dev):
        with torch.no_grad():
            h = e(x.to(dev))
            audio, info = d(h, return_info=True)
            return {"h": h, "audio": audio, "info": info,
                    "emb": d.vq2emb(want_codes.to(dev)),
                    "vc": d.decode_with_timbre(emb_cpu.to(dev), spk.to(dev))}

    with torch.no_grad():
        h_cpu = enc(x)
        want_codes = dec(h_cpu, return_info=True)[1]["codes"]
        emb_cpu = dec.vq2emb(want_codes)
    cpu = run(enc, dec, "cpu")
    with full_f32():
        got = run(copy.deepcopy(enc).to(device), copy.deepcopy(dec).to(
            device), device)
    clear = vq_margins(dec, h_cpu) > FACODEC_MARGIN
    codes_cpu, codes_dev = cpu["info"]["codes"], got["info"]["codes"].cpu()
    check(torch.equal(codes_cpu[:, clear], codes_dev[:, clear]),
          "FACodec codes differ where the margin clears")
    out = {"encoder_rel": _rel(got["h"], cpu["h"]),
           "vq2emb_rel": _rel(got["emb"], cpu["emb"]),
           "decode_with_timbre_rel": _rel(got["vc"], cpu["vc"]),
           "frames_clearing_margin": int(clear.sum()),
           "frames": clear.numel(),
           "codes_equal": bool(torch.equal(codes_cpu, codes_dev))}
    if out["codes_equal"]:
        out["return_info_rel"] = max(
            [_rel(got["audio"], cpu["audio"])]
            + [_rel(got["info"][k], cpu["info"][k])
               for k in ("f0", "uv", "phone", "spk_embs")])
    rels = [v for k, v in out.items() if k.endswith("_rel")]
    check(max(rels) <= CARD_CPU_REL, f"FACodec card vs CPU {out}")
    return out


def facodec_demo(ctx, device: str = "cuda",
                 lengths=FACODEC_LENGTHS) -> dict:
    """``cli.facodec_demo``'s ``main`` at the shipped widths (seeded) on
    seeded files of ``lengths`` samples at 16 kHz, then again on the same
    files: the first pass's files checked, each file's seconds in both
    passes, peak GiB, the launches, the native library's reads."""
    import io

    import numpy as np
    import torch
    from ditsep_tpu_torch import native
    from ditsep_tpu_torch.cli import facodec_demo as cli
    from ditsep_tpu_torch.data import read_wav, write_wav

    cuda = device != "cpu"
    rng = np.random.default_rng(21)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ind, outd = Path(tmp, "in"), Path(tmp, "out")
        ind.mkdir()
        names = []
        for i, n in enumerate(lengths):
            names.append(f"utt{i}.wav")
            write_wav(str(ind / names[-1]), (0.1 * rng.standard_normal(
                n)).astype(np.float32), FACODEC_FS)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reads = native.calls["load_wav"]
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["--in-dir", str(ind), "--out-dir", str(outd)]
                     + ([] if cuda else ["--cpu"]))
        if cuda:
            torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        # the same files again: no length is new, so these seconds are the
        # steady work, and the first pass's excess is per-shape set-up
        buf_repeat = io.StringIO()
        with contextlib.redirect_stdout(buf_repeat):
            cli.main(["--in-dir", str(ind), "--out-dir", str(outd / "repeat")]
                     + ([] if cuda else ["--cpu"]))
        file_s_repeat = json.loads(
            buf_repeat.getvalue().strip().splitlines()[-1])["file_s"]
        launches = counts()
        native_reads = native.calls["load_wav"] - reads
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
        lines = buf.getvalue().strip().splitlines()
        summary = json.loads(lines[-1])
        for name, n in zip(names, lengths):
            stem = name[:-4]
            codes = np.load(outd / f"{stem}_codes.npy")
            check(codes.shape == (-(-n // 200), 6) and codes.min() >= 0
                  and codes.max() < 1024, f"{name} codes {codes.shape}")
            rec, fs = read_wav(str(outd / f"{stem}_reconstructed.wav"))
            check(fs == FACODEC_FS and rec.shape == (n,)
                  and bool(np.isfinite(rec).all()), f"{name} audio")
    check(summary["files"] == len(lengths) and len(lines) == len(lengths) + 1
          and all(ln.startswith(f"utt{i}.wav: ") for i, ln in
                  enumerate(lines[:-1])), f"facodec demo output {lines}")
    check(summary["params"] == JAX_PARAMS["FACodecEncoder"]
          + FACODEC_DEMO_DECODER_PARAMS, f"demo params {summary['params']}")
    check(not any(launches.values()), f"facodec demo launches {launches}")
    check(native_reads >= 2 * len(lengths) and native.available(),
          f"the native library read {native_reads} files")
    return {"file_s": summary["file_s"], "cli_s": cli_s,
            "s_per_file_new_length": float(np.mean(summary["file_s"][1:])),
            "file_s_repeat": file_s_repeat,
            "s_per_file_repeat": float(np.mean(file_s_repeat)),
            "peak_gib": peak, "params": summary["params"],
            "launches": launches, "native_reads": native_reads,
            "native_calls": dict(native.calls),
            "native_library": str(native.library_path().relative_to(REPO))}


def model_info_totals(argv) -> dict:
    """``cli.model_info``'s ``main`` in-process: each printed model's
    parameter total, by name."""
    import io

    from ditsep_tpu_torch.cli import model_info

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model_info.main(argv)
    out = {}
    for ln in buf.getvalue().splitlines():
        m = re.fullmatch(r"(\w+): ([\d,]+) parameters", ln)
        if m:
            out[m.group(1)] = int(m.group(2).replace(",", ""))
    return out


def facodec_profile() -> dict:
    """One forward of the shipped codec (encoder, then the decoder with
    ``return_info``) on the first file's length, profiled: the device's
    busy ms and idle share (``profile_replay``, "nfe" 1)."""
    import torch
    from ditsep_tpu_torch.cli.facodec_demo import build_codec

    enc, dec = build_codec("cuda")
    n = FACODEC_LENGTHS[0]
    x = 0.1 * torch.randn(1, 1, -(-n // 200) * 200, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(3))

    def run():
        dec(enc(x), return_info=True)
        return 1

    out = profile_replay(run)
    del enc, dec
    return {"samples": x.shape[-1], **out}


def phase_facodec(ctx):
    """FACodec: the demo CLI at the shipped widths (and one forward
    profiled), the small codec card vs CPU, model_info's counts against
    the JAX package's."""
    import torch

    t0 = time.perf_counter()
    demo = facodec_demo(ctx)
    demo_s = time.perf_counter() - t0
    reset_counts()
    prof = facodec_profile()
    check(not any(counts().values()), f"facodec profile {counts()}")
    reset_counts()
    t0 = time.perf_counter()
    parity = facodec_parity()
    parity_s = time.perf_counter() - t0
    parity_launches = counts()
    check(not any(parity_launches.values()),
          f"facodec parity launches {parity_launches}")
    t0 = time.perf_counter()
    totals = {**model_info_totals(["--facodec"]),
              **model_info_totals(["--config", "diffsep_icassp"])}
    info_s = time.perf_counter() - t0
    check(totals == JAX_PARAMS, f"model_info totals {totals}")
    ctx.setdefault("slice_launches", {}).update({
        "facodec_demo": demo["launches"], "facodec_parity": parity_launches})
    torch.cuda.empty_cache()
    emit({"phase": "facodec", "config": "FACodec as shipped (encoder ngf "
          "32, ratios (2, 4, 5, 5), 256 out; decoder 1024 initial channels, "
          "ratios (5, 5, 4, 2), VQ 1 + 2 + 3 x 1024 x 8, 5,003 phones, "
          "timbre 4 x 4), seeded; 4 files "
          f"{list(FACODEC_LENGTHS)} samples at 16 kHz", **demo,
          "demo_s": demo_s, "profile": prof, "small_card_vs_cpu": parity,
          "tolerance": CARD_CPU_REL, "parity_s": parity_s,
          "model_info_totals": totals, "jax_eval_shape_totals": JAX_PARAMS,
          "model_info_s": info_s, "card": ctx["card"]})


# the learning loop (ditsep_tpu_torch/examples): train_synthetic at the long
# run's widths (nf=32, batch 8 x 4 s, lr 5e-4) for 200 steps on 256 items,
# evaluated at N=5 after 100 steps and at the end; then nfe_study on its EMA
# export, 2 seeds of the two PC configurations. The mean loss of the last
# LEARN_WINDOW steps is below that of the first.
LEARN = dict(nf=32, batch=8, len_s=4.0, steps=200, items=256, eval_n=5,
             eval_every=100)
LEARN_WINDOW = 50
LEARN_STUDY, LEARN_STUDY_SEEDS = ("pc_N30", "pc_N15"), 2
# the nf=32 U-Net's backward: fir_up2d for its 3 down blocks' downsamples
# of h and of the skip x
CKPT_UP_LAUNCHES_PER_BACKWARD = 6


def learning_loop(device: str = "cuda", nf: int = 32, batch: int = 8,
                  len_s: float = 4.0, steps: int = 200, items: int = 256,
                  eval_n: int = 5, eval_every: int = 100) -> dict:
    """``train_synthetic.main`` with these arguments and ``--save-params``,
    then ``nfe_study.main`` on that export. Checks
    finite losses and the export loaded into a model of other weights
    equal to the EMA bit for bit. Returns the run's and the study's
    results, every loss, seconds, the launches of each path and the
    launches the config implies (``launches_want``: 2 forwards a train
    step, each with its backward; an evaluation separates with the
    parameters and with the EMA at NFE 2N; the study's NFE by
    configuration)."""
    import torch
    from ditsep_tpu_torch.configs import build_diffsep_trainer
    from ditsep_tpu_torch.examples import nfe_study, train_synthetic

    cpu = ["--cpu"] if device == "cpu" else []

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        npz = str(Path(tmp) / "ema.npz")
        sync()
        reset_counts()
        t0 = time.perf_counter()
        run = train_synthetic.main([
            "--steps", str(steps), "--nf", str(nf), "--batch", str(batch),
            "--len-s", str(len_s), "--n-train", str(items), "--lr", "5e-4",
            "--eval-N", str(eval_n), "--eval-every", str(eval_every),
            "--save-params", npz, *cpu])
        sync()
        train_s = time.perf_counter() - t0
        train_launches = counts()
        losses = run["losses"]
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"losses {losses}")
        back = build_diffsep_trainer(train_synthetic.synthetic_config(nf),
                                     device=device, seed=1,
                                     params_npz=npz).model.state_dict()
        ema = run["state"].ema.state_dict()
        check(back.keys() == ema.keys()
              and all(torch.equal(back[k], ema[k]) for k in ema),
              "the EMA export does not load back to the EMA's bits")
        del run["state"], back, ema
        sync()
        reset_counts()
        t0 = time.perf_counter()
        study = nfe_study.main([
            "--params", npz, "--nf", str(nf), "--len-s", str(len_s),
            "--n-seeds", str(LEARN_STUDY_SEEDS), "--configs", *LEARN_STUDY,
            *cpu])
        sync()
        study_s = time.perf_counter() - t0
        study_launches = counts()
    check(all(math.isfinite(c["si_sdr_mean"])
              for c in study["configs"].values()), f"study {study}")
    evals = len(run["interims"]) + 1
    zero = dict.fromkeys(train_launches, 0)
    want = {"learning_train": {
        **zero, "fir_down2d": (steps * 2 + evals * 2 * 2 * eval_n)
        * CKPT_LAUNCHES_PER_FORWARD,
        "fir_up2d": steps * 2 * CKPT_UP_LAUNCHES_PER_BACKWARD},
        "learning_nfe_study": {**zero, "fir_down2d": LEARN_STUDY_SEEDS * sum(
            c["nfe"] for c in study["configs"].values())
            * CKPT_LAUNCHES_PER_FORWARD}}
    return {"result": run["result"], "interims": run["interims"],
            "losses": losses, "study": study, "train_s": train_s,
            "study_s": study_s, "evaluations": evals,
            "launches": {"learning_train": train_launches,
                         "learning_nfe_study": study_launches},
            "launches_want": want}


def learning_fir_check() -> dict:
    """fir_down2d and fir_up2d at the learning loop's shapes (``scripts/
    fir_timing.py``'s ``learning_path_shapes``: batch 8, 256 frames; f32,
    as the loop runs them) against their plain versions bit for bit, each
    vector path against its scalar path (``check_fir_pair``). fir_up2d
    runs at every shape; the backward takes it at the down blocks'."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    from ditsep_tpu_torch.scripts import fir_timing

    k = fir_timing.FIR_K
    taps = ck.separable_taps(np.asarray(k), 1.0)
    g = torch.Generator(device="cuda").manual_seed(10)
    worst, rows = [0.0, 0.0], []
    for kind, level, shape in fir_timing.learning_path_shapes():
        x = torch.randn(shape, generator=g, device="cuda")
        *errs, down_path, up_path = check_fir_pair(x, g, taps, k)
        worst = [max(a, b) for a, b in zip(worst, errs)]
        rows.append([kind, level, list(shape), down_path, up_path])
    return {"max_abs_err": dict(zip(("fir_down2d", "fir_up2d"), worst)),
            "tolerance": "the plain versions' bits; each vector path equal "
                         "to its scalar path",
            "columns": ["kind", "level", "shape", "fir_down2d_path",
                        "fir_up2d_path"], "rows": rows}


def phase_learning(ctx):
    """The learning loop at the long run's widths (``learning_loop``): its
    kernels at its shapes against their plain versions
    (``learning_fir_check``), its launches as the config implies, the
    mean loss of the last LEARN_WINDOW steps below that of the first."""
    t0 = time.perf_counter()
    fir_check = learning_fir_check()
    rec = learning_loop(**LEARN)
    for path, got in rec["launches"].items():
        check(got == rec["launches_want"][path],
              f"{path} launches {got}, want {rec['launches_want'][path]}")
    losses = rec.pop("losses")
    first = sum(losses[:LEARN_WINDOW]) / LEARN_WINDOW
    last = sum(losses[-LEARN_WINDOW:]) / LEARN_WINDOW
    check(last < first, f"mean loss of the last {LEARN_WINDOW} steps "
                        f"{last} not below the first's {first}")
    ctx.setdefault("slice_launches", {}).update(rec["launches"])
    emit({"phase": "learning", "what": "ditsep_tpu_torch.examples."
          "train_synthetic (nf=32, ch_mult (1,1,2,2), attention at 32, "
          "batch 8 x 4 s, lr 5e-4, seeded weights) for "
          f"{LEARN['steps']} steps on {LEARN['items']} items, PC N="
          f"{LEARN['eval_n']} evaluations, then nfe_study on its EMA export "
          f"({LEARN_STUDY_SEEDS} seeds, {', '.join(LEARN_STUDY)})", **rec,
          "fir_check": fir_check,
          "loss_mean_first": first, "loss_mean_last": last,
          "window": LEARN_WINDOW,
          "steps_per_s": rec["result"]["steps_per_s"],
          "learning_s": time.perf_counter() - t0, "card": ctx["card"]})


# the latent path (latent_diffsep_ouve): the latent U-Net downsamples at
# its two level transitions, twice in the down block and once on the input
# pyramid; a forward's backward takes fir_up2d for the down blocks' two
LATENT_LAUNCHES_PER_FORWARD = 6
LATENT_UP_LAUNCHES_PER_BACKWARD = 4
LATENT_BATCH = 4                  # the direct separate_latent calls
LATENT_EVAL_ITEMS = 4             # cli.evaluate --latent, batch 4
# cli.train_diffsep_latent: the config's batch 16 of 5 s crops, 64 items:
# 4 steps in one epoch, ending in one validation (its 4 items fill one
# batch of 16: the score loss, 2 forwards, and a PC-30 separation, 60)
LATENT_TRAIN_ITEMS, LATENT_TRAIN_BATCH, LATENT_TRAIN_STEPS = 64, 16, 4
LATENT_TRAIN_LEN_S = 5.0
LATENT_CACHE_ITEMS = 2
# the small latent config of the card-vs-CPU phase (hop 64)
LATENT_PARITY_OVERRIDES = {
    "model.vae.channels": 32, "model.vae.c_mults": (1, 2, 4),
    "model.vae.strides": (2, 4, 8), "model.vae.latent_dim": 16,
    "model.score_model.nf": 32, "model.score_model.ch_mult": (1, 2, 2),
    "model.score_model.image_size": 16,
    "model.score_model.attn_resolutions": (4,)}


def latent_trainer(cfg, device: str, dtype: str = "f32"):
    """``cfg``'s latent trainer with seeded weights (the VAE's and the
    score model's), the score model's zero-init layers redrawn at unit
    scale, on ``device``; ``dtype`` the compute dtype of both."""
    from ditsep_tpu_torch.configs import build_latent_trainer, override
    cfg = override(cfg, {"model.score_model.dtype": dtype,
                         "model.vae.dtype": dtype})
    trainer = build_latent_trainer(cfg, device="cpu", seed=0)
    unit_scale_zero_init_layers(trainer.model, seed=0)
    trainer.model.to(device)
    trainer.vae.to(device)
    return trainer


def check_fir_pair(x, g, taps, plain_k) -> tuple:
    """fir_down2d on ``x`` and fir_up2d on a gradient of its output's
    shape (drawn from ``g``), each against its plain version bit for bit,
    and each one's vector path against its scalar path where its plan
    takes the vector path (fir_down2d's needs W a multiple of 2V = 8 f32 /
    16 bf16, fir_up2d's 4 / 8). Returns the two max abs errors and the two
    kernels' paths."""
    import torch
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    hw = tuple(x.shape[2:])
    down_path = ck.fir_down2d.plan(x)["path"]
    y = ck.fir_down2d(x, *taps)
    ref = ck.downsample_2d_plain(x, plain_k)
    gy = torch.randn(y.shape, generator=g, device="cuda").to(x.dtype)
    up_path = ck.fir_up2d.plan(gy, hw)["path"]
    dx = ck.fir_up2d(gy, *taps, hw)
    dref = ck.downsample_2d_bwd_plain(gy, plain_k, hw)
    same = ((down_path == "scalar" or torch.equal(
        ck.fir_down2d(x, *taps, force_path="scalar"), y))
        and (up_path == "scalar" or torch.equal(
            ck.fir_up2d(gy, *taps, hw, force_path="scalar"), dx)))
    torch.cuda.synchronize()
    errs = ((y.float() - ref.float()).abs().max().item(),
            (dx.float() - dref.float()).abs().max().item())
    check(torch.equal(y, ref) and torch.equal(dx, dref) and same,
          f"fir kernels at {tuple(x.shape)} {x.dtype}: not the plain "
          f"versions' bits (max errs {errs}), or a kernel's paths differ")
    return errs + (down_path, up_path)


def phase_latent_kernel(ctx):
    """fir_down2d and fir_up2d at every latent-U-Net shape (``scripts/
    fir_timing.py``'s latent cases: batch 1 and the phases' batches, 36
    and 20 latent frames), f32 and bf16, against their plain versions bit
    for bit, the scalar path asserted; then their times there."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    from ditsep_tpu_torch.scripts import fir_timing

    k = fir_timing.FIR_K
    taps = ck.separable_taps(np.asarray(k), 1.0)
    g = torch.Generator(device="cuda").manual_seed(9)
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    cases, up_paths = 0, {"vector": 0, "scalar": 0}
    for batch, tl in fir_timing.LATENT_CASES:
        for kind, _, shape in fir_timing.latent_path_shapes(batch, tl):
            base = torch.randn(shape, generator=g, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                *errs, down_path, up_path = check_fir_pair(base.to(dtype), g,
                                                           taps, k)
                check(down_path == "scalar", f"fir_down2d plan at latent "
                                             f"shape {shape} {dtype}: not "
                                             "the scalar path")
                name = str(dtype).split(".")[-1]
                worst[name] = [max(a, b) for a, b in zip(worst[name], errs)]
                cases += 1
                if kind == "down":  # the backward's shapes
                    up_paths[up_path] += 1
    fwd = fir_timing.time_latent_path(ctx["bandwidth"])
    bwd = fir_timing.time_latent_path(ctx["bandwidth"], backward=True)
    check(all(r["path"] == "scalar" for r in fwd if "path" in r),
          "a timed latent fir_down2d row took the vector path")
    ctx["latent_kernel"] = {"err": worst, "fwd": fwd, "bwd": bwd}
    keys = ("path", "kernel_ms", "bound_ms", "plain_ms", "library_ms",
            "call_ms", "in_l2")
    for name, rows in (("fir_down2d", fwd), ("fir_up2d", bwd)):
        emit({"phase": "latent_kernel", "kernel": name, "cases": cases,
              "max_abs_err": {d: v[0 if name == "fir_down2d" else 1]
                              for d, v in worst.items()},
              "tolerance": "the plain version's bits; fir_down2d on the "
                           "scalar path, fir_up2d's vector path equal to "
                           "its scalar path",
              **({"up_paths_at_down_block_shapes": up_paths}
                 if name == "fir_up2d" else {}),
              "timing": "device ms by CUDA graphs cycling past twice the "
                        "L2 (scripts/fir_timing.py --latent); library: "
                        "F.conv2d / F.conv_transpose2d depthwise 4x4 "
                        "stride 2",
              "columns": ["shape", "dtype", *keys],
              "rows": [[r["shape"], r["dtype"], *(r.get(c) for c in keys)]
                       for r in rows if "shape" in r],
              "sums": [r for r in rows if "shape" not in r],
              "card": ctx["card"]})


def phase_latent_parity(ctx):
    """The small latent config, seeded weights, on the card (TF32 off)
    against the CPU with the same draws: the VAE's encode (the mode), its
    posterior sample and decode, ``separate_latent`` at N = 3 (1e-3
    relative each), then two ``train_step_latent`` steps at PR 5's bars
    (the plain bar and, where Adam's first moment nearly cancels, plus
    the part the two devices' gradients explain)."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.configs import latent_diffsep_ouve, override
    from ditsep_tpu_torch.ops import cuda_kernels as ck

    cfg = override(latent_diffsep_ouve(), LATENT_PARITY_OVERRIDES)
    rng = np.random.default_rng(31)
    n, b = 3, 2
    mix = (0.1 * rng.standard_normal((b, 1, FS))).astype(np.float32)
    est_in = rng.standard_normal((b, 2, 16, FS // 64)).astype(np.float32)
    lat_shape = (b, 16, -(-FS // 64))
    enc = rng.standard_normal(lat_shape).astype(np.float32)
    shape = (b, 2) + lat_shape[1:]
    noise = (rng.standard_normal(shape).astype(np.float32),
             rng.standard_normal((n, 1) + shape).astype(np.float32),
             rng.standard_normal((n,) + shape).astype(np.float32))
    out = {}
    with full_f32():
        for device in ("cuda", "cpu"):
            tr = latent_trainer(cfg, device)
            m = torch.from_numpy(mix).to(device)
            torch.cuda.synchronize()
            ck.fir_down2d.launches = 0
            mode, _ = tr.encode(m, None)
            post, _ = tr.encode(m, None, draws={"enc_mix_z": enc})
            dec = tr.decode(torch.from_numpy(est_in).to(device), FS)
            est, nfe = tr.separate_latent(m, target_dim=FS, N=n,
                                          enc_noise=enc, noise=noise)
            torch.cuda.synchronize()
            out[device] = {k: v.cpu().numpy() for k, v in (
                ("encode_mode", mode), ("encode_sample", post),
                ("decode", dec), ("separate_latent", est))}
            out[device]["nfe"] = nfe
            out[device]["launches"] = ck.fir_down2d.launches
            del tr
    rel = {}
    for k in ("encode_mode", "encode_sample", "decode", "separate_latent"):
        gpu, cpu = out["cuda"][k], out["cpu"][k]
        check(gpu.shape == cpu.shape and np.isfinite(gpu).all(),
              f"latent {k}: card shape / finiteness")
        rel[k] = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
        check(rel[k] <= 1e-3, f"latent {k}: card vs CPU {rel[k]} > 1e-3")
    want = LATENT_LAUNCHES_PER_FORWARD * 2 * n
    check(out["cuda"]["nfe"] == out["cpu"]["nfe"] == 2 * n, "latent NFE")
    check(out["cuda"]["launches"] == want and out["cpu"]["launches"] == 0,
          f"latent parity launches card {out['cuda']['launches']} (want "
          f"{want}), CPU {out['cpu']['launches']}")
    emit({"phase": "latent_parity", "config": "latent_diffsep_ouve, VAE "
          "channels 32 c_mults (1,2,4) strides (2,4,8) latent 16; U-Net "
          "nf=32 ch_mult (1,2,2) attn (4,); seeded weights, zero-init "
          "layers at unit scale", "samples": FS, "batch": b, "N": n,
          "tf32": False, "tolerance": 1e-3, "max_rel_err": rel,
          "launches_card": out["cuda"]["launches"], "card": ctx["card"]})

    # two train steps, card vs CPU, the same batches and draws (1 s items
    # padded by the train loader to 8,192 samples: 128 latent frames)
    batches, draws = [], []
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    for step in range(2):
        mixb, tgt = synthetic_batch(b, 1.0, seed=40 + step)
        tl = -(-mixb.shape[-1] // 64)
        batches.append((mixb, tgt))
        draws.append({"mask_u": f32(np.resize([0.05, 0.5], b)),
                      "pit_z": f32(rng.standard_normal((b, 2, 16, tl))),
                      "shuffle_u": f32(rng.random((b, 2))),
                      "time_u": f32(rng.random(b)),
                      "z": f32(rng.standard_normal((b, 2, 16, tl))),
                      "enc_mix_z": f32(rng.standard_normal((b, 16, tl))),
                      "enc_tgt_z": f32(rng.standard_normal((2 * b, 16,
                                                            tl)))})
    hist = train_steps_card_vs_cpu(cfg, batches, draws, latent=True)
    plain = train_parity_worst(hist, explain=False)
    worst = train_parity_worst(hist, explain=True)
    check(worst["param_over_bar"] <= 1 and worst["ema_over_bar"] <= 1,
          f"card vs CPU latent train steps: {worst}")
    emit({"phase": "latent_train_parity", "config": "the latent_parity "
          "config", "batch": b, "samples": int(batches[0][0].shape[-1]),
          "steps": len(batches),
          "tf32": False, **{k: float(v) for k, v in worst.items()},
          "plain_bar": {k: float(v) for k, v in plain.items()},
          "losses_card": [h["loss"] for h in hist["cuda"]["steps"]],
          "losses_cpu": [h["loss"] for h in hist["cpu"]["steps"]],
          "tolerance": TRAIN_PARITY_TOLERANCE + "; plus twice the part "
          "of the difference the devices' gradients explain through "
          "float64 clip + Adam (plain_bar: without it)",
          "card": ctx["card"]})


def phase_latent_flagship(ctx):
    """latent_diffsep_ouve at full width, seeded weights: cli.evaluate
    --latent on synthetic 8.415 s items; separate_latent directly at batch
    4 in f32 and bf16 with the same draws; one f32 call split into VAE
    encode, sampler and VAE decode; one call replayed at N = 2 under the
    profiler."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.configs import latent_diffsep_ouve
    from ditsep_tpu_torch.data import SyntheticMixDataset
    from ditsep_tpu_torch.ops import cuda_kernels as ck

    args = ["--latent", "--config", "latent_diffsep_ouve", "--synthetic",
            "--synthetic-items", str(LATENT_EVAL_ITEMS),
            "--synthetic-len-s", str(FLAGSHIP_SAMPLES / FS),
            "--eval-batch-size", str(LATENT_BATCH), "--sampler-N",
            str(N_STEPS), "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    ev = run_evaluate(args, LATENT_LAUNCHES_PER_FORWARD)
    ev["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ctx["latent_launches"] = {"evaluate_latent": ev["launches"]}

    ds = SyntheticMixDataset(n_items=LATENT_BATCH, min_len_s=FLAGSHIP_SAMPLES
                             / FS, max_len_s=FLAGSHIP_SAMPLES / FS, seed=11)
    mix = torch.from_numpy(np.stack([ds[i][0] for i in range(LATENT_BATCH)])
                           ).cuda()
    g = torch.Generator(device="cuda").manual_seed(12)
    tl = -(-FLAGSHIP_SAMPLES // 2048)
    lat = (LATENT_BATCH, 64, tl)
    shape = (LATENT_BATCH, 2, 64, tl)
    enc = torch.randn(lat, generator=g, device="cuda")
    noise = (torch.randn(shape, generator=g, device="cuda"),
             torch.randn((N_STEPS, 1) + shape, generator=g, device="cuda"),
             torch.randn((N_STEPS,) + shape, generator=g, device="cuda"))
    results, ests = {}, {}
    for dtype in ("f32", "bf16"):
        tr = latent_trainer(latent_diffsep_ouve(), "cuda", dtype)
        warm = (noise[0], noise[1][:2], noise[2][:2])  # cuDNN's setup
        tr.separate_latent(mix, target_dim=FLAGSHIP_SAMPLES, N=2,
                           enc_noise=enc, noise=warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.fir_down2d.launches = 0
        t0 = time.perf_counter()
        est, nfe = tr.separate_latent(mix, target_dim=FLAGSHIP_SAMPLES,
                                      N=N_STEPS, enc_noise=enc, noise=noise)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = ck.fir_down2d.launches
        check(nfe == 2 * N_STEPS, f"latent {dtype} NFE {nfe}")
        check(tuple(est.shape) == (LATENT_BATCH, 2, FLAGSHIP_SAMPLES)
              and bool(torch.isfinite(est).all()),
              f"latent {dtype} output shape / finiteness")
        check(launches == LATENT_LAUNCHES_PER_FORWARD * nfe,
              f"latent {dtype} launches {launches}")
        results[dtype] = {"seconds": sec, "utt_per_s": LATENT_BATCH / sec,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30, "launches": launches, "nfe": nfe}
        ests[dtype] = est.float().cpu().numpy()
        if dtype == "f32":
            ctx["latent_batch4_utt_per_s"] = LATENT_BATCH / sec
            results["split_f32"] = latent_call_split(tr, mix, enc, noise)
            results["profiled_call_f32"] = {"N": 2, **profile_replay(
                lambda: tr.separate_latent(
                    mix, target_dim=FLAGSHIP_SAMPLES, N=2, enc_noise=enc,
                    noise=warm)[1])}
        ctx["latent_launches"]["separate_latent"] = launches
        del tr, est
        torch.cuda.empty_cache()
    agree = si_sdr_db(ests["bf16"], ests["f32"])
    emit({"phase": "latent_flagship", "config": "latent_diffsep_ouve (VAE "
          "channels 128, hop 2048, latent 64; U-Net nf=128 ch_mult (1,2,2); "
          "seeded weights, zero-init layers at unit scale)",
          "samples": FLAGSHIP_SAMPLES, "latent_frames": tl, "N": N_STEPS,
          "evaluate_cli": {"items": LATENT_EVAL_ITEMS,
                           "batch": LATENT_BATCH, **ev},
          "batch": LATENT_BATCH, "tf32_conv": True, **results,
          "bf16_vs_f32_si_sdr_db": {"mean": float(agree.mean()),
                                    "min": float(agree.min()),
                                    "bar_min": BF16_SI_SDR_BAR_DB},
          "timing": "host clock between two synchronizations; the split: "
                    "synchronized around encode, sampling and decode",
          "card": ctx["card"]})
    check(agree.min() >= BF16_SI_SDR_BAR_DB,
          f"latent bf16 vs f32 {agree.min():.2f} dB")


def latent_call_split(tr, mix, enc, noise) -> dict:
    """One f32 separate_latent call in its three parts, each between two
    synchronizations: VAE encode (the posterior sample), the sampler, VAE
    decode."""
    import torch
    marks = [time.perf_counter()]
    lat, _ = tr.encode(mix, None, draws={"enc_mix_z": enc})
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    est, nfe = tr.sample_latents(lat, latent=True, N=N_STEPS, noise=noise)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    tr.decode(est, FLAGSHIP_SAMPLES)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    enc_ms, samp_ms, dec_ms = (1e3 * (b - a) for a, b in zip(marks,
                                                             marks[1:]))
    return {"vae_encode_ms": enc_ms, "sampler_ms": samp_ms,
            "ms_per_score_call": samp_ms / nfe, "vae_decode_ms": dec_ms,
            "vae_share": (enc_ms + dec_ms) / (enc_ms + samp_ms + dec_ms)}


def phase_latent_train(ctx):
    """cli.train_diffsep_latent at full width (the config's batch 16 of
    5 s synthetic crops, 4 steps, one validation): steps/s over steps
    2-4, peak memory, launches; then cli.cache_latents on 2 items at
    N = 30."""
    import gc

    import numpy as np
    import torch
    from ditsep_tpu_torch.cli import cache_latents, train_diffsep_latent
    from ditsep_tpu_torch.data import LatentDataset
    from ditsep_tpu_torch.training.diffsep_latent import LatentDiffSepTrainer

    spans, losses = [], []
    real_step = LatentDiffSepTrainer.train_step_latent

    def timed_step(self, state, batch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = real_step(self, state, batch, **kw)
        losses.append(met["train/score_loss"].item())  # syncs
        spans.append(time.perf_counter() - t0)
        return state, met

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp, "run")
        LatentDiffSepTrainer.train_step_latent = timed_step
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            state = train_diffsep_latent.main([
                "--synthetic", "--synthetic-items", str(LATENT_TRAIN_ITEMS),
                "--synthetic-len-s", str(LATENT_TRAIN_LEN_S), "--max-steps",
                str(LATENT_TRAIN_STEPS), "--workdir", str(work)])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            LatentDiffSepTrainer.train_step_latent = real_step
        check(state.step == LATENT_TRAIN_STEPS == len(losses),
              f"latent train steps {state.step}, timed {len(losses)}")
        check(all(math.isfinite(v) for v in losses), f"losses {losses}")
        per_val = (2 + 2 * N_STEPS) * LATENT_LAUNCHES_PER_FORWARD
        want = {"fir_down2d": LATENT_TRAIN_STEPS * 2
                * LATENT_LAUNCHES_PER_FORWARD + per_val,
                "fir_up2d": LATENT_TRAIN_STEPS * 2
                * LATENT_UP_LAUNCHES_PER_BACKWARD}
        want.update({k: 0 for k in launches if k not in want})
        check(launches == want, f"latent train launches {launches}, want "
                                f"{want}")
        vals = [json.loads(ln) for ln in open(work / "metrics.jsonl")
                if "val/si_sdr" in ln]
        check(len(vals) == 1 and math.isfinite(vals[0]["val/si_sdr"])
              and math.isfinite(vals[0]["val/score_loss"]),
              f"latent validations {vals}")
        check((work / "ema.npz").exists()
              and (work / "checkpoints" / "latest" / "state.pt").exists(),
              "latent train outputs")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        ctx["latent_launches"]["train_cli_latent_diffsep_ouve"] = launches

        cache = Path(tmp, "cache")
        reset_counts()
        t0 = time.perf_counter()
        n = cache_latents.main([
            "--synthetic", "--synthetic-items", str(LATENT_CACHE_ITEMS),
            "--synthetic-len-s", str(FLAGSHIP_SAMPLES / FS), "--sampler-N",
            str(N_STEPS), "--out-dir", str(cache), "--seed", "0"])
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
        cache_launches = counts()
        want_c = LATENT_LAUNCHES_PER_FORWARD * 2 * N_STEPS * n
        check(n == LATENT_CACHE_ITEMS
              and cache_launches["fir_down2d"] == want_c
              and all(v == 0 for k, v in cache_launches.items()
                      if k != "fir_down2d"),
              f"cache_latents: {n} items, launches {cache_launches}")
        ds = LatentDataset(str(cache))
        tl = -(-FLAGSHIP_SAMPLES // 2048)
        for i in range(len(ds)):
            tgt, lat = ds[i]
            check(lat.shape == (2, 64, tl) and np.isfinite(lat).all()
                  and tgt.shape == (2, FLAGSHIP_SAMPLES),
                  f"cached latent {i}: {lat.shape} {tgt.shape}")
        ctx["latent_launches"]["cache_latents"] = cache_launches["fir_down2d"]
    timed = spans[1:]  # steps 2-4: the first warms cuDNN
    steps_per_s = len(timed) / sum(timed)
    emit({"phase": "latent_train", "config": "latent_diffsep_ouve (seeded "
          "weights), batch 16 of 5.0 s synthetic crops (40,960 samples "
          "after bucketing: 20 latent frames)", "steps": LATENT_TRAIN_STEPS,
          "losses": losses, "step_s": spans, "steps_per_s_2_4": steps_per_s,
          "items_per_s_2_4": LATENT_TRAIN_BATCH * steps_per_s,
          "total_s": total_s, "peak_gib": peak_gib, "validations": vals,
          "launches": launches,
          "timing": "host clock around each train_step_latent, "
                    "synchronized before and after; TF32 convs",
          "cache_latents": {"items": n, "N": N_STEPS, "seconds": cache_s,
                            "launches": cache_launches["fir_down2d"]},
          "card": ctx["card"]})


# the LDM decoder finetune and the VAE-GAN: card vs CPU on the small latent
# config with a two-scale discriminator (filters 8); then the CLI chain at
# full width, cache_latents -> train_ldm --use-disc (batch 4 x 2 sources x
# 40,960 samples) -> --resume -> validate_vae, and AutoencoderTrainer steps
# at the VAE's sample_size
LDM_PARITY_DISC = {"filters": 8, "n_ffts": (1024, 256),
                   "hop_lengths": (256, 64)}
LDM_PARITY_LR = 1.0   # the schedule's first rates are 1e-3 lr: above ulps
LDM_PARITY_SAMPLES = 8192  # 128 latent frames at hop 64
LDM_CACHE_ITEMS, LDM_LEN_S, LDM_BATCH = 8, 5.12, 4  # 40,960 samples
LDM_CACHE_N = 10  # the cache's PC steps: the finetune's data, not measured
LDM_STEPS, LDM_RESUME_STEPS = 6, 8  # gen on even steps, disc on odd
LDM_TIMED_STEPS, LDM_PROFILED_STEPS = 3, 3  # of each kind, after warm-up
AE_SAMPLES, AE_BATCH = 247808, 2  # oobleck_finetune sample_size
AE_TIMED_STEPS = 3  # of each kind, after a warm gen + disc pair


CLIP_ADAMW = {"b1": 0.8, "b2": 0.99, "weight_decay": 1e-3}


def group_worst(cpu: dict, card: dict, rate, clip: float,
                decay=None, adam: dict = CLIP_ADAMW) -> dict:
    """One parameter group's steps, the card's against the CPU's after
    each: the train-step bars at the applied rates (the sum over the
    steps of 1e-3 * rate where the CPU gradient is significant, 2 * rate
    elsewhere) plus twice the part the two devices' gradients explain
    through float64 clip + AdamW (``adam``: b1, b2, weight_decay;
    ``ClipAdamW``'s by default); the EMA the same times (1 - decay) plus 2
    ulps. Buffers (no gradient) are left out. Returns the worst ratios
    (<= 1 passes). The gradients themselves are held by
    ``grads_worst``."""
    import numpy as np
    worst = {"param_over_bar": 0.0, "ema_over_bar": 0.0}
    for n in range(1, len(cpu["steps"]) + 1):
        h_cpu = [s["grads"] for s in cpu["steps"][:n]]
        h_card = [s["grads"] for s in card["steps"][:n]]
        rates = [rate(i) for i in range(n)]
        a, b = (adam_f64(cpu["p0"], h, rates, clip, **adam)
                for h in (h_cpu, h_card))
        ref, got = cpu["steps"][n - 1], card["steps"][n - 1]
        for k, want in ref["params"].items():
            if k not in h_cpu[0]:
                continue
            sig = np.ones(want.shape, bool)
            for g in h_cpu:
                top = max(np.abs(x).max() for x in g.values())
                x = np.abs(g[k])
                sig &= (x >= 1e-3 * x.max()) & (x.max() >= 1e-6 * top)
            bar = (np.where(sig, 1e-3 * sum(rates), 2 * sum(rates))
                   + 2 * np.abs(a[k] - b[k]))
            worst["param_over_bar"] = max(worst["param_over_bar"], float(
                (np.abs(got["params"][k] - want) / bar).max()))
            if decay is not None:
                e = ref["ema"][k]
                e_bar = bar * (1 - decay) + 2 * np.spacing(np.abs(e))
                worst["ema_over_bar"] = max(worst["ema_over_bar"], float(
                    (np.abs(got["ema"][k] - e) / e_bar).max()))
    return worst


def snapshot(module) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def grads_of(loss, module) -> dict:
    """d loss / d each parameter of ``module`` (zeros where unused)."""
    import numpy as np
    import torch
    named = dict(module.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    return {k: (np.zeros(tuple(p.shape), np.float32) if g is None
                else g.cpu().numpy()) for (k, p), g in zip(named.items(),
                                                           grads)}


def hinge_term_scales(disc, reals, fakes) -> dict:
    """Each discriminator leaf's scale for a disc step's gradient: the
    larger max of the gradients of its two terms, the reals' and the
    fakes' (``discriminator_loss_terms``: the hinge's, or DAC's and
    BigVGAN's least-squares, each averaged over the scales, as the loss
    is). With every hinge active the loss is linear in the logits and the
    two terms nearly cancel: on ldm_parity's seeded discriminators a conv
    bias's gradient is 15 to 110 times smaller than either term's (CPU,
    float64). What the two devices' conv accumulation orders round, and a
    leaky ReLU whose input lies within that rounding of 0, is a share of
    the terms, not of their difference."""
    import numpy as np
    from ditsep_tpu_torch.models.discriminators import (
        discriminator_loss_terms)
    real, fake = (grads_of(term, disc) for term in
                  discriminator_loss_terms(disc, reals, fakes))
    return {k: float(max(np.abs(real[k]).max(), np.abs(fake[k]).max()))
            for k in real}


def ldm_fakes(ldm, n: int, lt, rt):
    """The decoded batch LDM step ``n`` holds against ``rt`` if it is a
    disc step, else None."""
    import torch
    if not ldm.use_disc_this_step(n):
        return None
    with torch.no_grad():
        return ldm.latent_trainer.decode(lt, rt.shape[-1])


def ldm_step_grads(ldm, n: int, lt, rt, fakes) -> tuple:
    """The gradient LDM step ``n`` takes at ``ldm``'s current parameters
    and the leaves' scales: the discriminator's on ``fakes`` on a disc
    step, with ``hinge_term_scales``, else the decoder's and None."""
    from ditsep_tpu_torch.models.discriminators import (
        encodec_discriminator_loss,
    )
    if ldm.use_disc_this_step(n):
        return (grads_of(encodec_discriminator_loss(ldm.disc, rt, fakes)[0],
                         ldm.disc), hinge_term_scales(ldm.disc, rt, fakes))
    return grads_of(ldm.gen_loss(lt, rt, True)[0], ldm.vae.decoder), None


def ae_fakes(ae, n: int, r, draws: list):
    """The round trip AutoencoderTrainer step ``n`` holds against the
    reals if it is a disc step (step n's draws), else None."""
    import torch
    if not ae.use_disc_this_step(n):
        return None
    with torch.no_grad():
        return ae._roundtrip(r, None, draws[n])[0]


def ae_step_grads(ae, n: int, r, draws: list, fakes) -> tuple:
    """The gradient AutoencoderTrainer step ``n`` takes at ``ae``'s current
    parameters, with step n's draws, and the leaves' scales, as
    ``ldm_step_grads``."""
    from ditsep_tpu_torch.models.discriminators import discriminator_loss
    if ae.use_disc_this_step(n):
        rt = r[..., :fakes.shape[-1]]  # the round trip's crop
        return (grads_of(discriminator_loss(ae.disc, rt, fakes)[0], ae.disc),
                hinge_term_scales(ae.disc, rt, fakes))
    return grads_of(ae.gen_loss(r, True, draws=draws[n])[0], ae.vae), None


def ldm_parity_steps(ldm, batches, device) -> dict:
    """gen -> disc -> gen LDM steps on ``batches``: per group (decoder,
    disc) the initial parameters and, per step, its gradient and the
    parameters (and EMA) after it; before each step both groups'
    parameters, and each step's gradient and (disc steps) its fakes in
    step order; the steps' losses."""
    import torch
    state = ldm.init_state()
    groups = {"decoder": {"p0": snapshot(state.decoder), "steps": []},
              "disc": {"p0": snapshot(state.disc), "steps": []}}
    losses, pre, step_grads, step_fakes = [], [], [], []
    for n, (lat, reals) in enumerate(batches):
        lt = torch.from_numpy(lat).to(device)
        rt = torch.from_numpy(reals).to(device)
        pre.append({"decoder": snapshot(state.decoder),
                    "disc": snapshot(state.disc)})
        fakes = ldm_fakes(ldm, n, lt, rt)
        grads, _ = ldm_step_grads(ldm, n, lt, rt, fakes)
        step_grads.append(grads)
        step_fakes.append(None if fakes is None else fakes.cpu().numpy())
        if ldm.use_disc_this_step(n):
            state, met = ldm.disc_step(state, lt, rt)
            losses.append(met["train/discriminator_loss"].item())
            groups["disc"]["steps"].append(
                {"grads": grads, "params": snapshot(state.disc)})
        else:
            state, met = ldm.gen_step(state, lt, rt)
            losses.append(met["train/loss"].item())
            groups["decoder"]["steps"].append(
                {"grads": grads, "params": snapshot(state.decoder),
                 "ema": snapshot(state.ema_decoder)})
    return {"groups": groups, "losses": losses, "pre": pre,
            "grads": step_grads, "fakes": step_fakes}


def ae_parity_steps(ae, reals, draws, device) -> dict:
    """A gen step and a disc step of the AutoencoderTrainer with explicit
    draws, as ``ldm_parity_steps``."""
    import torch
    state = ae.init_state()
    groups = {"vae": {"p0": snapshot(state.vae), "steps": []},
              "disc": {"p0": snapshot(state.disc), "steps": []}}
    r = torch.from_numpy(reals).to(device)
    losses, pre, step_grads, step_fakes = [], [], [], []
    for n in range(2):
        pre.append({"vae": snapshot(state.vae), "disc": snapshot(state.disc)})
        fakes = ae_fakes(ae, n, r, draws)
        grads, _ = ae_step_grads(ae, n, r, draws, fakes)
        step_grads.append(grads)
        step_fakes.append(None if fakes is None else fakes.cpu().numpy())
        if ae.use_disc_this_step(n):
            state, met = ae.disc_step(state, r, draws=draws[n])
            losses.append(met["train/discriminator_loss"].item())
            groups["disc"]["steps"].append({"grads": grads,
                                            "params": snapshot(state.disc)})
        else:
            state, met = ae.gen_step(state, r, draws=draws[n])
            losses.append(met["train/loss"].item())
            groups["vae"]["steps"].append({"grads": grads,
                                           "params": snapshot(state.vae),
                                           "ema": snapshot(state.ema_vae)})
    return {"groups": groups, "losses": losses, "pre": pre,
            "grads": step_grads, "fakes": step_fakes}


def replay_grads(modules: dict, pre: list, step_grads) -> list:
    """Each step's gradient at the parameters another run had before it:
    ``pre[n]`` loaded into ``modules`` (by group), then ``step_grads(n)``
    (what it returns). So the card's gradients are held against the
    CPU's at the same point, not along two trajectories that Adam
    parts."""
    import torch
    out = []
    for n, snaps in enumerate(pre):
        for group, sd in snaps.items():
            modules[group].load_state_dict(
                {k: torch.from_numpy(v) for k, v in sd.items()})
        out.append(step_grads(n))
    return out


def seeded_disc(in_channels: int, device: str, **kw):
    import torch
    from ditsep_tpu_torch.models.discriminators import (
        MultiScaleSTFTDiscriminator,
    )
    disc = MultiScaleSTFTDiscriminator(in_channels=in_channels, **kw)
    disc.reset_parameters(torch.Generator().manual_seed(in_channels))
    return disc.to(device)


def phase_ldm_parity(ctx):
    """The small latent config (latent_parity's, hop 64) with a two-scale
    discriminator (filters 8), seeded weights, on the card (TF32 off)
    against the CPU with the same inputs and draws: the perceptual MRSTFT
    at the ldm config's 7 resolutions and its gradient, the
    discriminator's logits and feature maps, gen -> disc -> gen LDM steps
    and one AutoencoderTrainer gen + disc pair (the latent mask on): each
    step's gradient against the CPU's at the card's parameters before it
    (a disc step's on the card's fakes, bars from ``hinge_term_scales``),
    the parameters at the train-step bars, at lr 1 (the schedule's first
    rates are 1e-3 lr: the steps stand above float32's resolution)."""
    import copy

    import numpy as np
    import torch
    from ditsep_tpu_torch.configs import latent_diffsep_ouve, override
    from ditsep_tpu_torch.training import auraloss
    from ditsep_tpu_torch.training.ldm import LDMTrainer
    from ditsep_tpu_torch.training.schedules import inverse_lr_schedule

    cfg = override(latent_diffsep_ouve(), LATENT_PARITY_OVERRIDES)
    rng = np.random.default_rng(41)
    b, t, d = 2, LDM_PARITY_SAMPLES, 16
    tl = t // 64
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    y = f32(0.3 * rng.standard_normal((b, 2, t)))
    x = f32(y + 0.1 * rng.standard_normal((b, 2, t)))
    batches = [(f32(rng.standard_normal((b, 2, d, tl))),
                f32(0.3 * rng.standard_normal((b, 2, t)))) for _ in range(3)]
    ae_reals = f32(0.3 * rng.standard_normal((b, 1, t)))
    ae_draws = [{"enc_z": f32(rng.standard_normal((b, d, tl))),
                 "mask_u": f32(rng.random((b, d, tl)))} for _ in range(2)]
    mr = {"sample_rate": FS, "perceptual_weighting": True}
    out = {}
    with full_f32():
        for device in ("cpu", "cuda"):
            res = {}
            for dt in ((torch.float32, torch.float64) if device == "cpu"
                       else (torch.float32,)):
                xt = torch.from_numpy(x).to(device, dt).requires_grad_(True)
                loss = auraloss.multi_resolution_stft_loss(
                    xt, torch.from_numpy(y).to(device, dt), **mr)
                (g,) = torch.autograd.grad(loss, [xt])
                res[str(dt)] = (loss.item(), g.double().cpu().numpy())
            disc = seeded_disc(2, device, **LDM_PARITY_DISC)
            with torch.no_grad():
                logits, fmaps = disc(torch.from_numpy(x).to(device))
            res["disc"] = [a.cpu().numpy() for a in logits
                           + [f for fm in fmaps for f in fm]]
            tr = latent_trainer(cfg, device)
            if device == "cpu":
                ae_vae = copy.deepcopy(tr.vae)  # the finetune moves tr's
            ldm = LDMTrainer(latent_trainer=tr, disc=disc, lr=LDM_PARITY_LR)
            res["ldm"] = ldm_parity_steps(ldm, batches, device)
            out[device] = res
            if device == "cpu":
                cpu_ldm = ldm
            del tr, ldm, disc
        # the CPU's gradients at the card's parameters before each step,
        # a disc step's on the card's fakes: the discriminator's gradient
        # is held alone, the decoder's round trip by the gen steps
        tn = torch.from_numpy
        fakes = [None if f is None else tn(f)
                 for f in out["cuda"]["ldm"]["fakes"]]
        replay = replay_grads(
            {"decoder": cpu_ldm.vae.decoder, "disc": cpu_ldm.disc},
            out["cuda"]["ldm"]["pre"], lambda n: ldm_step_grads(
                cpu_ldm, n, tn(batches[n][0]), tn(batches[n][1]), fakes[n]))
        ae = ae_card_vs_cpu("ae", ae_vae, seeded_disc(
            1, "cpu", **LDM_PARITY_DISC), ae_reals, ae_draws, "cuda",
            latent_mask_ratio=0.3)
    cpu, card = out["cpu"], out["cuda"]
    f32k, f64k = str(torch.float32), str(torch.float64)
    (l_cpu, g_cpu), (l_card, g_card) = cpu[f32k], card[f32k]
    g64 = cpu[f64k][1]
    mrstft = {"loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
              "grad_err_of_max": float(np.abs(g_card - g_cpu).max()
                                       / np.abs(g_cpu).max()),
              "cpu_f32_vs_f64_of_max": float(np.abs(g_cpu - g64).max()
                                             / np.abs(g_cpu).max())}
    check(mrstft["loss_rel"] <= 1e-5, f"MRSTFT card vs CPU {mrstft}")
    check(np.abs(g_card - g_cpu).max() <= 1e-5 * np.abs(g_cpu).max()
          + 2 * np.abs(g_cpu - g64).max(), f"MRSTFT gradient {mrstft}")
    disc_rel = max(float(np.abs(a - c).max() / np.abs(c).max())
                   for a, c in zip(card["disc"], cpu["disc"]))
    check(disc_rel <= 1e-5, f"discriminator card vs CPU {disc_rel}")
    # the hinge's gradient: with every hinge active a difference of two
    # nearly equal means (conv_post's bias exactly 0), its bar a share of
    # the terms (hinge_term_scales)
    worst = {"gen": 0.0, "disc": 0.0}
    for n, ((want, scale), got) in enumerate(zip(replay,
                                                 card["ldm"]["grads"])):
        kind = "disc" if cpu_ldm.use_disc_this_step(n) else "gen"
        worst[kind] = max(worst[kind], grads_worst(
            want, got, f"ldm step {n} at the card's parameters",
            scale=scale))
    steps = {"ldm": {"grad_over_bar": worst}}
    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(
        card["ldm"]["losses"], cpu["ldm"]["losses"]))
    check(loss_rel <= 1e-4, f"ldm losses card vs CPU {loss_rel}")
    steps["ldm"]["loss_rel"] = loss_rel
    for group, lr in (("decoder", LDM_PARITY_LR),
                      ("disc", 2 * LDM_PARITY_LR)):
        worst = group_worst(
            cpu["ldm"]["groups"][group], card["ldm"]["groups"][group],
            inverse_lr_schedule(lr), 1.0,
            decay=0.9999 if group == "decoder" else None)
        check(worst["param_over_bar"] <= 1 and worst["ema_over_bar"] <= 1,
              f"ldm {group} steps card vs CPU: {worst}")
        steps["ldm"][group] = worst
    steps["ae"] = {k: v for k, v in ae.items() if k != "losses_card"}
    emit({"phase": "ldm_parity", "config": "latent_parity's (VAE channels "
          "32, hop 64, latent 16), seeded weights; discriminator filters 8, "
          "n_ffts (1024, 256); MRSTFT: the ldm config's 7 resolutions, "
          "perceptual", "samples": t, "batch": b, "tf32": False,
          "lr": LDM_PARITY_LR, "mrstft": mrstft,
          "disc_max_rel_err": disc_rel, "steps": steps,
          "losses_card": {"ldm": card["ldm"]["losses"],
                          "ae": ae["losses_card"]},
          "tolerance": "MRSTFT 1e-5 relative, its gradient 1e-5 of max "
          "plus twice the CPU's own float32 error against float64; the "
          "discriminator 1e-5 of max; losses 1e-4 relative; each step's "
          "gradient leaf by leaf 1e-3 of the CPU leaf's max, the CPU's "
          "taken at the card's parameters before the step (a disc step's "
          "on the card's fakes, 1e-3 of the larger of its two hinge "
          "terms' gradients where that is larger); "
          "parameters the train-step bars at the applied rates plus the part "
          "float64 AdamW explains, the EMA the same times (1 - decay) "
          "plus 2 ulps (over_bar <= 1 passes)", "card": ctx["card"]})


def phase_ldm_train(ctx):
    """The decoder finetune at full width through its CLIs: cli.
    cache_latents on 8 synthetic 5.12 s items at N = 10 (fir_down2d's
    launches), cli.train_ldm --use-disc at batch 4 for 6 steps (peak
    memory), then --resume to 8; cli.validate_vae over the seeded and the
    finetuned VAE; the steady rates from 3 gen and 3 disc steps after a
    warm pair, alternating, each timed alone, then 3 gen steps under the
    profiler; then AutoencoderTrainer gen and disc steps at the VAE's
    sample_size of 247,808 samples, batch 2, timed the same way."""
    import gc

    import numpy as np
    import torch
    from ditsep_tpu_torch.cli import cache_latents, train_ldm, validate_vae
    from ditsep_tpu_torch.configs import (
        build_latent_trainer, build_oobleck_vae, ldm,
    )
    from ditsep_tpu_torch.data import LatentDataset, SyntheticMixDataset
    from ditsep_tpu_torch.models.weights import save_params_npz
    from ditsep_tpu_torch.training.autoencoder import AutoencoderTrainer
    from ditsep_tpu_torch.training.ldm import LDMTrainer

    cfg = ldm()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp, "cache")
        reset_counts()
        t0 = time.perf_counter()
        n = cache_latents.main([
            "--config", "ldm", "--synthetic", "--synthetic-items",
            str(LDM_CACHE_ITEMS), "--synthetic-len-s", str(LDM_LEN_S),
            "--sampler-N", str(LDM_CACHE_N), "--out-dir", str(cache),
            "--seed", "0"])
        torch.cuda.synchronize()
        cache_launches = counts()
        want = LATENT_LAUNCHES_PER_FORWARD * 2 * LDM_CACHE_N * n
        check(n == LDM_CACHE_ITEMS and cache_launches["fir_down2d"] == want
              and all(v == 0 for k, v in cache_launches.items()
                      if k != "fir_down2d"),
              f"cache_latents: {n} items, launches {cache_launches}, want "
              f"fir_down2d {want}")
        ctx["ldm_cache_launches"] = cache_launches["fir_down2d"]
        result["cache_latents"] = {"items": n, "N": LDM_CACHE_N,
                                   "seconds": time.perf_counter() - t0,
                                   "fir_down2d_launches": want}

        spans, metrics = {"gen": [], "disc": []}, []
        real = {"gen": LDMTrainer.gen_step, "disc": LDMTrainer.disc_step}

        def timed(kind):
            def step(self, state, *args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = real[kind](self, state, *args, **kw)
                vals = {k: v.item() for k, v in met.items()}  # syncs
                spans[kind].append(time.perf_counter() - t0)
                metrics.append({"step": state.step, **vals})
                return state, met
            return step

        work = Path(tmp, "run")
        args = ["--latent-cache", str(cache), "--use-disc", "--workdir",
                str(work), "--synthetic", "--seed", "0"]
        LDMTrainer.gen_step, LDMTrainer.disc_step = timed("gen"), timed("disc")
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            state = train_ldm.main(args + ["--max-steps", str(LDM_STEPS)])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            trainable = sum(p.numel() for p in state.decoder.parameters()
                            if p.requires_grad)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            resumed = train_ldm.main(
                args + ["--max-steps", str(LDM_RESUME_STEPS), "--resume"])
        finally:
            LDMTrainer.gen_step, LDMTrainer.disc_step = (real["gen"],
                                                         real["disc"])
        check(len(spans["gen"]) == len(spans["disc"]) == LDM_RESUME_STEPS // 2
              and resumed.step == LDM_RESUME_STEPS
              and [m["step"] for m in metrics]
              == list(range(1, LDM_RESUME_STEPS + 1)),
              f"train_ldm steps {[m['step'] for m in metrics]}, resumed at "
              f"{resumed.step}")
        check(all(math.isfinite(v) for m in metrics for v in m.values()),
              f"train_ldm metrics {metrics}")
        check(all(v == 0 for v in launches.values()),
              f"train_ldm launched kernels {launches}")
        index = json.loads((work / "checkpoints" / "index.json").read_text())
        check(len(index) == 4, f"train_ldm checkpoints {index}")
        result["train_ldm"] = {
            "batch": LDM_BATCH, "samples": int(LDM_LEN_S * FS),
            "trainable_params": trainable, "cli_gen_step_s": spans["gen"],
            "cli_disc_step_s": spans["disc"],
            "total_s": total_s, "peak_gib": peak_gib, "metrics": metrics,
            "launches": launches, "checkpoints": len(index),
            "resumed_to": resumed.step}

        # validate_vae over the seeded VAE and the finetuned one
        params_dir = Path(tmp, "vaes")
        params_dir.mkdir()
        vae = build_oobleck_vae(cfg["model"]["vae"], device="cpu", seed=0)
        save_params_npz(str(params_dir / "seeded.npz"), vae)
        vae.decoder.load_state_dict({k: v.cpu() for k, v in
                                     resumed.decoder.state_dict().items()})
        save_params_npz(str(params_dir / "finetuned.npz"), vae)
        del resumed, vae
        gc.collect()
        torch.cuda.empty_cache()
        rows = validate_vae.main(["--params-dir", str(params_dir),
                                  "--n-items", "4", "--synthetic"])
        check(len(rows) == 2 and all(math.isfinite(r["si_sdr"])
                                     and math.isfinite(r["mrstft"])
                                     for r in rows), f"validate_vae {rows}")
        result["validate_vae"] = rows

        # the steady rates: after a warm gen + disc pair (cuDNN's set-up),
        # 3 steps of each kind, alternating as train_ldm does; then 3 gen
        # steps under the profiler
        trainer = train_ldm.build_ldm_trainer(
            cfg, build_latent_trainer(cfg, device="cuda", seed=0),
            disc_channels=2)
        ds = LatentDataset(str(cache))
        items = [ds[i] for i in range(LDM_BATCH)]
        reals = torch.from_numpy(np.stack([t for t, _ in items])).cuda()
        lat = torch.from_numpy(np.stack([la for _, la in items])).cuda()
        state, spans = alternate_steps(
            trainer.gen_step, trainer.disc_step, trainer.init_state(),
            1 + LDM_TIMED_STEPS, lat, reals)
        result["train_ldm"].update(steady_rates(spans))
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(LDM_PROFILED_STEPS):
                state, _ = trainer.gen_step(state, lat, reals)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        result["gen_step_profile"] = {"steps": LDM_PROFILED_STEPS,
                                      **profile_summary(prof, wall_ms)}
        check(result["gen_step_profile"]["device_busy_ms"] > 0,
              "the profiler saw no device time")
        del trainer, state, reals, lat
        gc.collect()
        torch.cuda.empty_cache()

    # the VAE-GAN at the VAE's sample_size
    vcfg = cfg["model"]["vae"]
    dc = cfg["training"]["loss"]["discriminator"]
    batch, why = AE_BATCH, None
    while True:
        try:
            result["autoencoder"] = autoencoder_steps(
                vcfg, dc, batch, AutoencoderTrainer, build_oobleck_vae,
                SyntheticMixDataset)
            break
        except torch.cuda.OutOfMemoryError as e:
            gc.collect()
            torch.cuda.empty_cache()
            if batch == 1:
                raise
            why = f"batch {batch}: {str(e).splitlines()[0]}"
            batch //= 2
    result["autoencoder"]["halved_because"] = why
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "ldm_train", "config": "ldm (latent_diffsep_ouve's VAE: "
          "channels 128, c_mults (1,2,4,8,16), strides (2,4,4,8,8), latent "
          "64; the nf=128 latent NCSN++; discriminator filters 64, n_ffts "
          "2048-128), seeded weights, TF32 convs", **result,
          "timing": "host clock around each step, synchronized before and "
                    "after", "card": ctx["card"]})


def alternate_steps(gen, disc, state, n: int, *args, **kw):
    """``n`` gen and ``n`` disc steps, alternating, from ``state``: the
    state after them and each kind's seconds a step on the host clock,
    synchronized before and after (its metrics read, all finite)."""
    import torch
    spans = {"gen": [], "disc": []}
    for kind, step in (("gen", gen), ("disc", disc)) * n:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, *args, **kw)
        vals = [v.item() for v in met.values()]  # syncs
        spans[kind].append(time.perf_counter() - t0)
        check(all(math.isfinite(v) for v in vals), f"{kind} step: {met}")
    return state, spans


def steady_rates(spans: dict) -> dict:
    """Each kind's steps after its first (cuDNN's set-up): their seconds,
    total and rate."""
    out = {"warm_s": {k: v[0] for k, v in spans.items()}}
    for kind, v in spans.items():
        v = v[1:]
        out.update({f"{kind}_steps_timed": len(v), f"{kind}_step_s": v,
                    f"{kind}_s_total": sum(v),
                    f"{kind}_steps_per_s": len(v) / sum(v)})
    return out


def autoencoder_steps(vcfg, dc, batch, trainer_cls, build_vae, dataset_cls):
    """AutoencoderTrainer gen and disc steps, alternating, at ``batch``
    synthetic mixtures of the VAE's sample_size: a warm pair, then
    ``AE_TIMED_STEPS`` of each kind (``steady_rates``), and peak
    memory."""
    import numpy as np
    import torch
    vae = build_vae(vcfg, device="cuda", seed=0)
    disc = seeded_disc(1, "cuda", filters=dc["filters"],
                       n_ffts=tuple(dc["n_ffts"]),
                       hop_lengths=tuple(dc["hop_lengths"]))
    ae = trainer_cls(vae=vae, disc=disc)
    state = ae.init_state()
    ds = dataset_cls(n_items=batch, min_len_s=AE_SAMPLES / FS,
                     max_len_s=AE_SAMPLES / FS, seed=13)
    reals = torch.from_numpy(np.stack([ds[i][0] for i in range(batch)])
                             ).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check(tuple(reals.shape) == (batch, 1, AE_SAMPLES)
          and not ae.use_disc_this_step(0) and ae.use_disc_this_step(1),
          f"autoencoder batch {tuple(reals.shape)}")
    state, spans = alternate_steps(ae.gen_step, ae.disc_step, state,
                                   1 + AE_TIMED_STEPS, reals, generator=g)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del ae, state, vae, disc, reals
    return {"batch": batch, "samples": AE_SAMPLES, **steady_rates(spans),
            "peak_gib": peak}


# the serving phases: the nf=32 checkpoint's parity through the engine; the
# flagship behind the HTTP API at concurrency 1, 4 and 8 (one wave each,
# every batch size warmed first) and two /v1/stream sessions on the same
# engine; the latent flagship behind the API at concurrency 4 and 8
SERVE_PARITY_LENGTHS, SERVE_PARITY_N, SERVE_PARITY_SEED = (7000, 6500,
                                                          7600), 5, 7
SERVE_LEVELS, SERVE_WAVES, SERVE_MAX_BATCH = (1, 4, 8), 1, 8
SERVE_WAIT_MS = 100.0
SERVE_VARIANT_N = 5               # the variant engines' PC steps (NFE 10)
STREAM_S, STREAM_BLOCK_S, STREAMS = 8.0, 0.5, 2  # CHUNK_S, OVERLAP_S too
STREAM_CLI_N = 10                 # the streaming CLI's PC steps (NFE 20)
LATENT_SERVE_LEVELS = (4, 8)
LATENT_BUCKET = 65536             # 16 VAE hops of 2048


def phase_serving_parity(ctx):
    """build_engine on the trained nf=32 checkpoint, masked, TF32 off:
    three requests of different lengths in one bucket at max_batch 4, so
    the batch carries a padded row. Each served stem equals the same row
    of a direct trainer.separate on the padded batch, trimmed, bit for
    bit, with the engine's generator seeded alike; the engine's draws,
    replayed (``pc_generator_noise``), give the same bits and, on the CPU,
    the card's result within 1e-3 relative."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.cli.serve_api import build_engine
    from ditsep_tpu_torch.configs import build_diffsep_trainer
    from ditsep_tpu_torch.sdes.samplers import pc_generator_noise

    n, seed, bs = SERVE_PARITY_N, SERVE_PARITY_SEED, 4
    rng = np.random.default_rng(13)
    audios = [(0.1 * rng.standard_normal(L)).astype(np.float32)
              for L in SERVE_PARITY_LENGTHS]
    with full_f32():
        torch.cuda.synchronize()
        reset_counts()
        eng = build_engine(parity_config(mask_padding=True), device="cuda",
                           params_npz=str(CKPT), sampler_N=n,
                           mask_padding=True, max_batch=bs,
                           max_wait_ms=500.0, seed=seed)
        try:
            served = [f.result(timeout=600) for f in
                      [eng.submit(a) for a in audios]]
            st = eng.stats()
        finally:
            eng.close()
        torch.cuda.synchronize()
        launches = counts()
        nfe = eng.separate_fn.nfe
        blen = eng.bucket_of(max(SERVE_PARITY_LENGTHS))
        check(all(eng.bucket_of(L) == blen for L in SERVE_PARITY_LENGTHS),
              "the parity requests share one bucket")
        check((st["batches"], st["padded_rows"]) == (1, 1),
              f"serving parity batches {st}")
        want = CKPT_LAUNCHES_PER_FORWARD * nfe
        check(nfe == 2 * n and launches["fir_down2d"] == want
              and all(v == 0 for k, v in launches.items()
                      if k != "fir_down2d"),
              f"serving parity launches {launches}, want fir_down2d {want}")

        mix = np.zeros((bs, 1, blen), np.float32)
        lens = np.full((bs,), blen, np.int64)
        for i, a in enumerate(audios):
            mix[i, 0, :a.shape[-1]] = a
            lens[i] = a.shape[-1]
        trainer = eng.separate_fn.trainer
        card = {}
        for how in ("generator", "noise"):
            kw = ({"generator": torch.Generator(device="cuda").manual_seed(
                seed)} if how == "generator" else {
                "noise": pc_generator_noise(torch.Generator(
                    device="cuda").manual_seed(seed), (bs, 2, blen), n)})
            est, _ = trainer.separate(
                torch.from_numpy(mix).cuda(), N=n,
                lengths=torch.from_numpy(lens).cuda(), **kw)
            card[how] = est.float().cpu().numpy()
        bits = all(np.array_equal(o, card["generator"][i, :, :o.shape[-1]])
                   for i, o in enumerate(served))
        check(bits, "served stems differ from the direct call's rows")
        check(np.array_equal(card["noise"], card["generator"]),
              "the replayed draws differ from the generator's")
        noise = tuple(t.cpu() for t in pc_generator_noise(
            torch.Generator(device="cuda").manual_seed(seed),
            (bs, 2, blen), n))
        cpu_tr = build_diffsep_trainer(parity_config(mask_padding=True),
                                       device="cpu", params_npz=str(CKPT))
        cpu, _ = cpu_tr.separate(torch.from_numpy(mix), N=n,
                                 lengths=torch.from_numpy(lens), noise=noise)
        cpu = cpu.numpy()
    rel = float(np.abs(card["generator"] - cpu).max() / np.abs(cpu).max())
    check(rel <= 1e-3, f"serving parity card vs CPU {rel} > 1e-3")
    emit({"phase": "serving_parity",
          "checkpoint": str(CKPT.relative_to(REPO)),
          "config": "nf=32 ch_mult=(1,1,2,2) attn=(32,) mask_padding=on",
          "lengths": list(SERVE_PARITY_LENGTHS), "bucket": blen,
          "batch": bs, "padded_rows": st["padded_rows"], "N": n,
          "tf32": False, "served_equals_direct_bits": bits,
          "max_rel_err_card_vs_cpu": rel, "tolerance": 1e-3,
          "launches": launches["fir_down2d"], "launches_want": want,
          "card": ctx["card"]})


def serve_level(eng, client, conc: int, waves: int, lengths, per_forward,
                seed: int) -> dict:
    """One offered-concurrency level through the HTTP API
    (``scripts/serving_bench.run_level``): utt/s, wave latency, the
    client's request latency p50 / p95, the engine's counters from
    /v1/stats (this level's batches and occupancy, its cumulative p50 /
    p95), peak GiB, and fir_down2d's launches against batches x NFE x
    ``per_forward``; every stem finite, of its request's length."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.scripts import serving_bench as sb

    audios = sb.utterances(conc, lengths, seed=seed)
    before = client.get("/v1/stats")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    row = sb.run_level(client.submit, audios, waves)
    torch.cuda.synchronize()
    launches = counts()
    outs = row.pop("outputs")
    st = client.get("/v1/stats")
    batches = st["batches"] - before["batches"]
    items = st["batched_items"] - before["batched_items"]
    nfe = eng.separate_fn.nfe
    want = batches * nfe * per_forward
    check(items == conc * waves, f"level {conc}: {items} items served")
    check(launches["fir_down2d"] == want and all(
        v == 0 for k, v in launches.items() if k != "fir_down2d"),
        f"level {conc}: launches {launches}, want fir_down2d {want} "
        f"({batches} batches x {nfe} NFE x {per_forward})")
    for a, o in zip(audios, outs):
        check(o.shape == (2, a.shape[-1]) and np.isfinite(o).all(),
              f"level {conc}: stem shape {o.shape} / finiteness")
    row.update({"batches": batches, "mean_batch_occupancy": items / batches,
                "engine_latency_p50_ms": st["latency_p50_ms"],
                "engine_latency_p95_ms": st["latency_p95_ms"],
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "nfe": nfe, "launches": launches["fir_down2d"],
                "launches_want": want})
    return row


@contextlib.contextmanager
def api_server(eng):
    """``eng`` behind SeparationAPIServer on 127.0.0.1 (a free port) with
    an HTTP client; closes the client, the server and the engine."""
    from ditsep_tpu_torch.scripts.serving_bench import HTTPClient
    from ditsep_tpu_torch.serving import SeparationAPIServer

    srv = client = None
    try:
        srv = SeparationAPIServer(eng, port=0).start()
        client = HTTPClient(f"http://127.0.0.1:{srv.port}", fs=eng.fs,
                            workers=SERVE_MAX_BATCH)
        yield srv, client
    finally:
        if client is not None:
            client.close()
        if srv is not None:
            srv.close()
        eng.close()


def warm_engine(eng, length: int, per_forward: int) -> dict:
    """``eng.warmup`` at every batch size; its seconds and launches
    (batch sizes x NFE x ``per_forward``)."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.warmup([length])
    torch.cuda.synchronize()
    launches = counts()["fir_down2d"]
    want = len(eng.batch_sizes) * eng.separate_fn.nfe * per_forward
    check(launches == want, f"warmup launches {launches}, want {want}")
    return {"batch_sizes": eng.batch_sizes, "seconds":
            time.perf_counter() - t0, "launches": launches}


def phase_serving(ctx):
    """The flagship (diffsep_icassp, seeded weights, f32 with TF32 convs)
    through cli.serve_api's build_engine behind SeparationAPIServer:
    every batch size warmed, then concurrency 1, 4 and 8 over HTTP, one
    wave each; one wave at 8 with pipeline_depth=1 and one with the int16
    wire, each on an engine of its own (N = SERVE_VARIANT_N); /metrics
    parsed once. Then the serving_stream phase on the same engine and the
    streaming CLI."""
    from ditsep_tpu_torch.cli.serve_api import build_engine
    from ditsep_tpu_torch.configs import diffsep_icassp
    from ditsep_tpu_torch.scripts import serving_bench as sb

    lengths = sb.WAVEFORM_LENGTHS
    launches = 0
    eng = build_engine(diffsep_icassp(), device="cuda",
                       max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
                       seed=0)
    with api_server(eng) as (srv, client):
        bucket = eng.bucket_of(lengths[0])
        check(eng.bucket_of(lengths[1]) == bucket == 65153,
              f"serving lengths' bucket {bucket}")
        warm = warm_engine(eng, lengths[1], LAUNCHES_PER_FORWARD)
        launches += warm["launches"]
        levels = {}
        for conc in SERVE_LEVELS:
            levels[conc] = serve_level(eng, client, conc, SERVE_WAVES,
                                       lengths, LAUNCHES_PER_FORWARD,
                                       seed=conc)
            launches += levels[conc]["launches"]
        metrics = dict(ln.rsplit(" ", 1) for ln in client.get(
            "/metrics", raw=True).splitlines() if not ln.startswith("#"))
        st = client.get("/v1/stats")
        check(int(metrics["ditsep_requests_total"]) == st["requests"]
              and int(metrics["ditsep_batches_total"]) == st["batches"],
              f"/metrics {metrics} against /v1/stats {st}")
        variants = {}
        for name, kw in (("pipeline_depth_1", {"pipeline_depth": 1}),
                         ("wire_int16", {"wire_int16": True})):
            veng = build_engine(diffsep_icassp(), device="cuda",
                                max_batch=SERVE_MAX_BATCH,
                                max_wait_ms=SERVE_WAIT_MS, seed=0,
                                sampler_N=SERVE_VARIANT_N, **kw)
            with api_server(veng) as (_, vclient):
                variants[name] = serve_level(
                    veng, vclient, SERVE_MAX_BATCH, 1, lengths,
                    LAUNCHES_PER_FORWARD, seed=SERVE_MAX_BATCH)
            launches += variants[name]["launches"]
            del veng
        ctx["serve_launches"] = {"serve_api": launches}
        default = levels[SERVE_MAX_BATCH]
        emit({"phase": "serving", "config": "diffsep_icassp (nf=128, "
              "random weights seed 0)", "via": "HTTP POST /v1/separate",
              "lengths": list(lengths), "bucket": bucket, "N": N_STEPS,
              "max_batch": SERVE_MAX_BATCH, "max_wait_ms": SERVE_WAIT_MS,
              "tf32_conv": True, "warmup": warm,
              "levels": {str(k): v for k, v in levels.items()},
              "variants_at_8": variants, "variants_N": SERVE_VARIANT_N,
              "wave_s_at_8": {"default": default["wave_latency_s_mean"],
                              **{k: v["wave_latency_s_mean"]
                                 for k, v in variants.items()}},
              "direct_batch4_utt_per_s": ctx.get(
                  "flagship_batch4_utt_per_s"),
              "metrics": metrics, "launches": launches,
              "card": ctx["card"]})
        phase_serving_stream(ctx, eng, client)
    cli_separate_streaming(ctx)


def stream_session(url: str, mix, out: dict, key: str) -> None:
    """One /v1/stream session pushed in real time: block k of
    STREAM_BLOCK_S is posted once it has 'arrived' (STREAM_BLOCK_S x (k +
    1) after the start), or at once when the session lags. Records the
    samples emitted, the stems, and the wall latency of the oldest sample
    each response emits (its arrival to the response)."""
    import base64

    import numpy as np
    from urllib.request import Request, urlopen

    def post(path, data=b""):
        with urlopen(Request(f"{url}{path}", data=data), timeout=600) as r:
            return json.loads(r.read())

    def stems(r):
        return np.stack([np.frombuffer(base64.b64decode(b), "<f4")
                         for b in r["stems"]])

    block = int(STREAM_BLOCK_S * FS)
    meta = post(f"/v1/stream/open?chunk_seconds={CHUNK_S}"
                f"&overlap_seconds={OVERLAP_S}")
    sid, pieces, lat, emitted = meta["id"], [], [], 0
    t0 = time.perf_counter()
    for s in range(0, mix.shape[-1], block):
        arrival = t0 + (s + block) / FS
        time.sleep(max(0.0, arrival - time.perf_counter()))
        r = post(f"/v1/stream/{sid}/push", mix[s:s + block].tobytes())
        if r["samples"]:
            oldest = t0 + (emitted // block + 1) * block / FS
            lat.append(time.perf_counter() - oldest)
        emitted += r["samples"]
        pieces.append(stems(r))
    r = post(f"/v1/stream/{sid}/close")
    pieces.append(stems(r))
    out[key] = {"pushed": int(mix.shape[-1]), "emitted": emitted
                + r["samples"], "est": np.concatenate(pieces, axis=-1),
                "latency_bound_s": meta["latency_seconds"],
                "emit_latency_s": lat}


def phase_serving_stream(ctx, eng, client):
    """Two concurrent /v1/stream sessions of STREAM_S on the serving
    engine, pushed in real time in STREAM_BLOCK_S blocks, CHUNK_S windows
    with OVERLAP_S overlap: emitted samples equal pushed ones per session,
    the two streams' windows share batched calls, launches follow the
    batches."""
    import threading

    import numpy as np
    import torch
    from ditsep_tpu_torch.data import SyntheticMixDataset

    n = int(STREAM_S * FS)
    ds = SyntheticMixDataset(n_items=STREAMS, min_len_s=STREAM_S,
                             max_len_s=STREAM_S, seed=21)
    mixes = [ds[i][0][0].astype(np.float32) for i in range(STREAMS)]
    before = client.get("/v1/stats")
    torch.cuda.synchronize()
    reset_counts()
    out = {}
    threads = [threading.Thread(target=stream_session,
                                args=(client.url, m, out, str(i)))
               for i, m in enumerate(mixes)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    check(not any(t.is_alive() for t in threads) and len(out) == STREAMS,
          "stream sessions did not finish")
    st = client.get("/v1/stats")
    batches = st["batches"] - before["batches"]
    items = st["batched_items"] - before["batched_items"]
    want = batches * eng.separate_fn.nfe * LAUNCHES_PER_FORWARD
    sessions = {}
    for k, v in out.items():
        est = v.pop("est")
        check(v["emitted"] == v["pushed"] == n and est.shape == (2, n)
              and np.isfinite(est).all(), f"stream {k}: {v}")
        lat = v.pop("emit_latency_s")
        sessions[k] = {**v, "emit_latency_s_max": max(lat),
                       "emit_latency_s_mean": float(np.mean(lat)),
                       "responses_emitting": len(lat)}
    windows = len(range(0, n - int(OVERLAP_S * FS), int((CHUNK_S
                                                          - OVERLAP_S) * FS)))
    check(items == STREAMS * windows, f"stream windows served {items}")
    check(batches < items, f"the streams shared no call ({batches} "
          f"batches for {items} windows)")
    check(launches["fir_down2d"] == want, f"stream launches {launches}, "
          f"want fir_down2d {want}")
    ctx["serve_launches"]["serve_api_stream"] = launches["fir_down2d"]
    emit({"phase": "serving_stream", "streams": STREAMS,
          "stream_s": STREAM_S, "block_s": STREAM_BLOCK_S,
          "chunk_s": CHUNK_S, "overlap_s": OVERLAP_S,
          "windows_per_stream": windows, "bucket": eng.bucket_of(
              int(CHUNK_S * FS)), "batches": batches,
          "mean_batch_occupancy": items / batches, "wall_s": wall_s,
          "sessions": sessions, "launches": launches["fir_down2d"],
          "launches_want": want, "card": ctx["card"]})


def cli_separate_streaming(ctx):
    """cli.separate --chunk-seconds --overlap-seconds
    --streaming-block-seconds at the flagship width on one STREAM_S file,
    N = STREAM_CLI_N: finite stems of its length, launches windows x NFE x
    18."""
    import shutil

    import numpy as np
    import torch
    from ditsep_tpu_torch.cli import separate as cli
    from ditsep_tpu_torch.data import SyntheticMixDataset, read_wav, write_wav

    mix, _ = SyntheticMixDataset(n_items=1, min_len_s=STREAM_S,
                                 max_len_s=STREAM_S, seed=22)[0]
    n = mix.shape[-1]
    root = REPO / "build" / "chip_smoke_streaming"
    shutil.rmtree(root, ignore_errors=True)
    inp, outp = root / "in", root / "out"
    inp.mkdir(parents=True)
    write_wav(str(inp / "stream.wav"), mix[0], FS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    nfe = cli.main(["--config", "diffsep_icassp", "--input", str(inp),
                    "--output", str(outp), "--sampler-N", str(STREAM_CLI_N),
                    "--chunk-seconds", str(CHUNK_S), "--overlap-seconds",
                    str(OVERLAP_S), "--streaming-block-seconds",
                    str(STREAM_BLOCK_S), "--seed", "0"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    hop = int((CHUNK_S - OVERLAP_S) * FS)
    # windows at every hop while one fits, and a zero-padded tail window
    # when the last full one ends before the stream
    full = (n - int(CHUNK_S * FS)) // hop + 1
    windows = full + ((full - 1) * hop + int(CHUNK_S * FS) < n)
    want = LAUNCHES_PER_FORWARD * nfe * windows
    check(nfe == 2 * STREAM_CLI_N and launches["fir_down2d"] == want
          and all(v == 0 for k, v in launches.items() if k != "fir_down2d"),
          f"streaming CLI launches {launches}, want fir_down2d {want}")
    for src in ("s0", "s1"):
        data, fs = read_wav(str(outp / src / "stream.wav"))
        check(fs == FS and data.shape == (n,) and np.isfinite(data).all(),
              f"streaming CLI output {src}")
    shutil.rmtree(root, ignore_errors=True)
    ctx["serve_launches"]["cli_separate_streaming"] = launches["fir_down2d"]
    emit({"phase": "serving_stream_cli", "samples": n, "chunk_s": CHUNK_S,
          "overlap_s": OVERLAP_S, "block_s": STREAM_BLOCK_S,
          "windows": windows, "N": STREAM_CLI_N, "seconds": wall_s,
          "launches": launches["fir_down2d"], "launches_want": want,
          "card": ctx["card"]})


def phase_serving_latent(ctx):
    """build_engine(latent=True) on latent_diffsep_ouve at full width,
    seeded weights, behind the HTTP API: every batch size warmed at the
    65,536-sample bucket, then concurrency 4 and 8, one wave each;
    launches batches x NFE x 6."""
    from ditsep_tpu_torch.cli.serve_api import build_engine
    from ditsep_tpu_torch.configs import latent_diffsep_ouve
    from ditsep_tpu_torch.scripts import serving_bench as sb

    lengths = sb.LATENT_LENGTHS
    eng = build_engine(latent_diffsep_ouve(), device="cuda", latent=True,
                       max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
                       seed=0)
    with api_server(eng) as (_, client):
        bucket = eng.bucket_of(lengths[0])
        check(bucket == eng.bucket_of(lengths[1]) == LATENT_BUCKET,
              f"latent serving bucket {bucket}")
        warm = warm_engine(eng, lengths[1], LATENT_LAUNCHES_PER_FORWARD)
        launches = warm["launches"]
        levels = {}
        for conc in LATENT_SERVE_LEVELS:
            levels[conc] = serve_level(eng, client, conc, SERVE_WAVES,
                                       lengths, LATENT_LAUNCHES_PER_FORWARD,
                                       seed=100 + conc)
            launches += levels[conc]["launches"]
    ctx["serve_launches"]["serve_api_latent"] = launches
    emit({"phase": "serving_latent", "config": "latent_diffsep_ouve (VAE "
          "hop 2048, latent 64; U-Net nf=128; random weights seed 0)",
          "via": "HTTP POST /v1/separate", "lengths": list(lengths),
          "bucket": bucket, "latent_frames": bucket // 2048, "N": N_STEPS,
          "max_batch": SERVE_MAX_BATCH, "tf32_conv": True, "warmup": warm,
          "levels": {str(k): v for k, v in levels.items()},
          "direct_batch4_utt_per_s": ctx.get("latent_batch4_utt_per_s"),
          "launches": launches, "card": ctx["card"]})


# -- the mesh phase: data parallelism over torch.distributed ------------------
# the stable-audio generation path (generation phase): a small config of
# Stable Audio Open's schema for card-vs-CPU parity and the HTTP routes,
# and Stable Audio Open 1.0's published widths (stabilityai/
# stable-audio-open-1.0 model_config.json) for the full-width run
GEN_PARITY_STEPS, GEN_PARITY_SEED, GEN_PARITY_CFG = 4, 3, 5.0
GEN_FULL_STEPS, GEN_FULL_REQUESTS, GEN_FULL_CFG = 8, 2, 7.0
GEN_SMALL_VAE = {"in_channels": 2, "channels": 16, "c_mults": [1, 2, 4],
                 "strides": [2, 4, 4], "use_snake": True}
SAO_VAE = {"in_channels": 2, "channels": 128, "c_mults": [1, 2, 4, 8, 16],
           "strides": [2, 4, 4, 8, 8], "use_snake": True}


def sao_config(vae: dict, latent_dim: int, cond_dim: int, prompt_len: int,
               dit: dict, prompt: bool = True) -> dict:
    """A diffusion_cond config in Stable Audio Open 1.0's schema: an
    Oobleck VAE pretransform (encoder 2 x latent_dim, decoder latent_dim),
    a T5 prompt (``prompt``) and seconds_start / seconds_total number
    conditioners (0-512) on cross-attention, the two seconds on the global
    conditioning, a 'v' DiT."""
    ratio = math.prod(vae["strides"])
    enc = {**vae, "latent_dim": 2 * latent_dim}
    dec = {k: v for k, v in vae.items() if k != "in_channels"}
    dec.update(out_channels=vae["in_channels"], latent_dim=latent_dim)
    ids = (["prompt"] if prompt else []) + ["seconds_start", "seconds_total"]
    configs = [{"id": i, "type": "number",
                "config": {"min_val": 0, "max_val": 512}}
               for i in ("seconds_start", "seconds_total")]
    if prompt:
        configs.insert(0, {"id": "prompt", "type": "t5", "config": {
            "t5_model_name": "t5-base", "max_length": prompt_len}})
    return {"model_type": "diffusion_cond", "sample_rate": 44100, "model": {
        "pretransform": {"type": "autoencoder", "iterate_batch": True,
                         "config": {
                             "encoder": {"type": "oobleck", "config": enc},
                             "decoder": {"type": "oobleck", "config": dec},
                             "bottleneck": {"type": "vae"},
                             "latent_dim": latent_dim,
                             "downsampling_ratio": ratio,
                             "io_channels": vae["in_channels"]}},
        "conditioning": {"configs": configs, "cond_dim": cond_dim},
        "diffusion": {"cross_attention_cond_ids": ids,
                      "global_cond_ids": ["seconds_start", "seconds_total"],
                      "type": "dit", "diffusion_objective": "v",
                      "config": {"io_channels": latent_dim,
                                 "cond_token_dim": cond_dim,
                                 "global_cond_dim": 2 * cond_dim,
                                 "project_cond_tokens": False,
                                 "transformer_type": "continuous_transformer",
                                 **dit}},
        "io_channels": latent_dim}}


# Stable Audio Open 1.0: DiT 1536 wide, 24 layers, 24 heads; t5-base's
# 768-wide prompt of 128 tokens; VAE 128 channels, hop 2048, 64 latents
SAO_FULL = sao_config(SAO_VAE, 64, 768, 128,
                      {"embed_dim": 1536, "depth": 24, "num_heads": 24})
SAO_SAMPLE_SIZE = 2097152          # 1,024 latent frames, 47.6 s at 44.1 kHz
GEN_SMALL = sao_config(GEN_SMALL_VAE, 8, 64, 16,
                       {"embed_dim": 128, "depth": 2, "num_heads": 4})
GEN_SMALL_SAMPLE_SIZE = 2048       # 64 latent frames at hop 32


def nonzero_(module, seed: int) -> None:
    """Redraw the parameters that are all zero (the zero-initialised
    outputs, pre/post convs and biases) at N(0, 0.02^2): seeded weights
    whose every layer moves the output."""
    import torch
    g = torch.Generator(device=next(module.parameters()).device)
    g.manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=g)


def generation_app(cfg: dict, sample_size: int, device: str, seed: int = 0):
    """``GenerationApp`` of a stable-audio config from the model factory
    on ``device``: the DiT, the conditioners and the VAE seeded, the DiT's
    zero layers redrawn (``nonzero_``), in eval mode."""
    import torch
    from ditsep_tpu_torch.interface import GenerationApp
    from ditsep_tpu_torch.models.conditioners import (
        create_multi_conditioner_from_config)
    from ditsep_tpu_torch.models.factory import (
        create_diffusion_cond_from_config)

    with torch.device(device):
        g = torch.Generator(device=device).manual_seed(seed)
        dit, routing, _, pre = create_diffusion_cond_from_config(
            cfg, include_pretransform=True, generator=g)
        torch.manual_seed(seed)
        cond = create_multi_conditioner_from_config(
            cfg["model"]["conditioning"])
    nonzero_(dit, seed + 1)
    return GenerationApp(model=dit.eval(), io_channels=dit.io_channels,
                         sample_size=sample_size, fs=cfg["sample_rate"],
                         routing=routing, conditioner=cond.eval(),
                         pretransform=pre.eval())


def gen_inputs(prompt_len: int, width: int, seed: int,
               prompt: bool = True) -> dict:
    """Conditioner inputs of one request: a seeded (1, prompt_len, width)
    prompt embedding with its mask (what ``t5_encode_host`` hands the
    prompt conditioner; the last quarter is padding), seconds_start 0 and
    seconds_total 47."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {"seconds_start": np.zeros(1, np.float32),
           "seconds_total": np.full(1, 47.0, np.float32)}
    if prompt:
        mask = np.ones((1, prompt_len), bool)
        mask[:, 3 * prompt_len // 4:] = False
        out["prompt"] = (rng.standard_normal((1, prompt_len, width)).astype(
            np.float32), mask)
    return out


@contextlib.contextmanager
def timed_calls(obj, name: str):
    """Within it each ``obj.name(...)`` call is recorded: its arguments and
    its seconds between two synchronizations."""
    import torch
    calls, real = [], getattr(obj, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        calls.append({"args": args, "kw": kw,
                      "s": time.perf_counter() - t0})
        return out

    setattr(obj, name, timed)
    try:
        yield calls
    finally:
        delattr(obj, name)


def gen_parity(ctx, device: str = "cuda") -> dict:
    """(1) The small config's ``generate_conditional`` on the card and on
    the CPU with the same weights and the card's initial noise, TF32 off:
    the v sampler, k-heun, rectified-flow Euler, and a variation
    (init_noise_level 0.7) with an inpaint mask, each within 1e-3 of
    max|cpu|."""
    import copy

    import numpy as np
    import torch

    card = generation_app(GEN_SMALL, GEN_SMALL_SAMPLE_SIZE, device)
    cpu = copy.deepcopy(card)
    for m in (cpu.model, cpu.conditioner, cpu.pretransform):
        m.to("cpu")
    inputs = gen_inputs(16, 64, seed=4)
    t = np.arange(GEN_SMALL_SAMPLE_SIZE // 2) / 44100.0
    init = (0.6 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    mask = np.zeros(GEN_SMALL_SAMPLE_SIZE // 32, np.float32)
    mask[16:48] = 1.0
    cases = {"v": {}, "k_heun": {"sampler_type": "k-heun"},
             "rf_euler": {"objective": "rectified_flow"},
             "variation_inpaint": {"init_audio": init,
                                   "init_noise_level": 0.7,
                                   "inpaint_mask": mask}}
    out = {}
    with full_f32():
        for name, kw in cases.items():
            kw = dict(kw)
            objective = kw.pop("objective", "v")
            for app in (card, cpu):
                app.model.diffusion_objective = objective
            noise = card.initial_noise(1, GEN_PARITY_SEED)
            reset_counts()
            got = card.generate_conditional(
                inputs, steps=GEN_PARITY_STEPS, cfg_scale=GEN_PARITY_CFG,
                noise=noise, **kw)
            torch.cuda.synchronize()
            launches = counts()
            want = cpu.generate_conditional(
                inputs, steps=GEN_PARITY_STEPS, cfg_scale=GEN_PARITY_CFG,
                noise=noise.cpu(), **kw)
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            check(got.shape == (1, 2, GEN_SMALL_SAMPLE_SIZE)
                  and np.isfinite(got).all(), f"{name}: {got.shape}")
            check(rel <= 1e-3, f"generation {name}: card vs CPU {rel}")
            check(not any(launches.values()), f"{name} launches {launches}")
            out[name] = rel
    card.model.diffusion_objective = "v"
    return {"card_vs_cpu_rel": out, "app": card}


def gen_http(ctx, tmp: Path, device: str = "cuda") -> dict:
    """(2) A DemoServer with the small config's GenerationApp on numbers
    only and ``cli.serve``'s autoencoder tab at the latent path's VAE
    widths (mono, 128 channels, hop 2048, seeded): /api/generate_cond and
    /api/generate equal the direct calls' WAV bytes, /api/autoencoder
    round-trips 2 s."""
    import urllib.request

    import numpy as np
    import torch
    from ditsep_tpu_torch.cli.serve import build_autoencoder_app
    from ditsep_tpu_torch.configs import latent_diffsep_ouve
    from ditsep_tpu_torch.interface import DemoServer
    from ditsep_tpu_torch.interface.web import decode_wav, encode_wav

    numbers = sao_config(GEN_SMALL_VAE, 8, 64, 16,
                         {"embed_dim": 128, "depth": 2, "num_heads": 4},
                         prompt=False)
    gen = generation_app(numbers, GEN_SMALL_SAMPLE_SIZE, device, seed=7)
    v = latent_diffsep_ouve()["model"]["vae"]
    vae_json = tmp / "vae.json"
    vae_json.write_text(json.dumps({
        "model_type": "autoencoder", "sample_rate": v["sample_rate"],
        "model": {"encoder": {"type": "oobleck", "config": {
            "in_channels": 1, "channels": v["channels"],
            "c_mults": list(v["c_mults"]), "strides": list(v["strides"]),
            "latent_dim": 2 * v["latent_dim"]}},
            "decoder": {"type": "oobleck", "config": {
                "out_channels": 1, "channels": v["channels"],
                "c_mults": list(v["c_mults"]), "strides": list(v["strides"]),
                "latent_dim": v["latent_dim"]}},
            "bottleneck": {"type": "vae"}, "latent_dim": v["latent_dim"]}}))
    ae = build_autoencoder_app(str(vae_json), device=device, seed=2)
    srv = DemoServer(generation=gen, autoencoder=ae, port=0).start()
    out = {}

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()

    try:
        reset_counts()
        with deterministic_cudnn():
            cond = {"seconds_start": 0, "seconds_total": 47}
            status, body = post("/api/generate_cond", json.dumps(
                {"cond": cond, "steps": GEN_PARITY_STEPS,
                 "cfg_scale": GEN_PARITY_CFG, "seed": 5}).encode())
            direct = gen.generate_conditional(
                {k: np.asarray([v], np.float32) for k, v in cond.items()},
                steps=GEN_PARITY_STEPS, cfg_scale=GEN_PARITY_CFG, seed=5)
            check(status == 200 and body == encode_wav(direct[0], gen.fs),
                  "/api/generate_cond differs from the direct call")
            status, body = post("/api/generate", json.dumps(
                {"steps": GEN_PARITY_STEPS, "seed": 6}).encode())
            direct = gen.generate_uncond(steps=GEN_PARITY_STEPS, seed=6)
            check(status == 200 and body == encode_wav(direct[0], gen.fs),
                  "/api/generate differs from the direct call")
            hop = ae.vae.downsampling_ratio  # 2 s, whole hops
            clip = (0.5 * np.sin(np.arange(-(-2 * ae.fs // hop) * hop)
                                 * 0.05)).astype(np.float32)
            wav = encode_wav(clip, ae.fs)
            status, body = post("/api/autoencoder", wav)
            rec, fs = decode_wav(body)
            direct = ae.process(decode_wav(wav)[0])
            check(status == 200 and fs == ae.fs and rec.shape == (
                clip.size, 1) and body == encode_wav(direct, ae.fs),
                f"/api/autoencoder: {status} {rec.shape}")
        torch.cuda.synchronize()
        out["launches"] = counts()
        check(not any(out["launches"].values()),
              f"HTTP launches {out['launches']}")
    finally:
        srv.close()
    out["routes"] = ["/api/generate_cond", "/api/generate",
                     "/api/autoencoder"]
    return out


def gen_full(ctx, cfg: dict = SAO_FULL, sample_size: int = SAO_SAMPLE_SIZE,
             device: str = "cuda") -> dict:
    """(3) Stable Audio Open 1.0's widths with seeded weights:
    ``GenerationApp.generate_conditional`` for GEN_FULL_REQUESTS requests
    at batch 1, CFG 7, GEN_FULL_STEPS sampler steps (cut for the chip
    budget; the published default is 100), the sample_size of 2,097,152
    stereo samples. Seconds a sampler step and a decode, the request,
    peak memory, one profiled step, TFLOP/s, a bf16 step's distance."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.models.dit import DiffusionTransformer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    app = generation_app(cfg, sample_size, device, seed=11)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    dit = app.model
    n_params = sum(p.numel() for p in dit.parameters())
    out["dit_params"] = n_params
    cond = cfg["model"]["conditioning"]
    inputs = gen_inputs(cond["configs"][0]["config"]["max_length"],
                        cond["cond_dim"], seed=12)
    requests = []
    reset_counts()
    with timed_calls(dit, "forward") as steps, \
            timed_calls(app.pretransform, "decode") as decodes:
        for i in range(GEN_FULL_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio = app.generate_conditional(
                inputs, steps=GEN_FULL_STEPS, cfg_scale=GEN_FULL_CFG,
                seed=20 + i)
            requests.append(time.perf_counter() - t0)
            check(audio.shape == (1, 2, sample_size)
                  and np.isfinite(audio).all(),
                  f"full-width request {i}: {audio.shape}")
    torch.cuda.synchronize()
    out["launches"] = counts()
    check(not any(out["launches"].values()),
          f"full-width launches {out['launches']}")
    check(len(steps) == GEN_FULL_REQUESTS * GEN_FULL_STEPS
          and len(decodes) == GEN_FULL_REQUESTS,
          f"{len(steps)} DiT calls, {len(decodes)} decodes")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["tf32"] = {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}
    out["request_s"] = requests
    out["step_s"] = [c["s"] for c in steps]
    steady = [c["s"] for c in steps[GEN_FULL_STEPS:]]
    out["steady_step_s"] = sum(steady) / len(steady)
    out["decode_s"] = [c["s"] for c in decodes]
    x, t = steps[-1]["args"][:2]
    kw = steps[-1]["kw"]
    rows, tokens = x.shape[0] * 2, x.shape[-1] + 1  # CFG rows, + the global
    ctx_len = kw["cross_attn_cond"].shape[1]
    depth, width = len(dit.transformer.layers()), dit.embed_dim
    attn = rows * depth * 4 * width * (tokens * tokens + tokens * ctx_len)
    flops = 2 * n_params * tokens * rows + attn
    out["step_flop"] = flops
    out["step_tflop_per_s"] = flops / out["steady_step_s"] / 1e12
    out["cfg_rows"], out["tokens"] = rows, tokens
    prof = profile_replay(lambda: (dit(x, t, **kw), 1)[1])
    out["profiled_step"] = {k: prof[k] for k in ("wall_ms",
                                                  "device_busy_ms",
                                                  "idle_share", "top")}
    # one bf16 step (the port's dtype field: compute in bf16, float32
    # parameters) on the same weights and inputs
    with torch.device(device):
        bf16 = DiffusionTransformer(
            io_channels=dit.io_channels, embed_dim=width, depth=depth,
            num_heads=width // dit.transformer.dim_heads,
            cond_token_dim=dit.cond_token_dim,
            global_cond_dim=dit.to_global_embed.dense_0.in_features,
            project_cond_tokens=False, dtype=torch.bfloat16)
    bf16.load_state_dict(dit.state_dict())
    bf16.eval()
    with torch.no_grad():
        ref = dit(x, t, **kw).float()
        dit(x, t, **kw)
        bf16(x, t, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = bf16(x, t, **kw).float()
        torch.cuda.synchronize()
        out["bf16_step_s"] = time.perf_counter() - t0
    out["bf16_rel_dist"] = float((y - ref).abs().max() / ref.abs().max())
    del bf16
    out["app"] = app
    out["probe"] = (x, t, kw)
    return out


def gen_importer(app, probe, cfg: dict = SAO_FULL,
                 device: str = "cuda") -> dict:
    """(4) A seeded reference-layout state_dict of the full-width DiT (the
    full model's own weights, ``dit_reference_state``) through
    ``import_dit_params`` into a fresh full-width DiT; one forward equals,
    bit for bit, the same weights loaded through ``params_from_jax`` (the
    JAX package's flat layout, ``params_to_jax``)."""
    import torch
    from ditsep_tpu_torch.models.factory import (
        create_diffusion_cond_from_config)
    from ditsep_tpu_torch.models.torch_import import (
        dit_reference_state, import_dit_params)
    from ditsep_tpu_torch.models.weights import (
        load_state, params_from_jax, params_to_jax)

    src = app.model
    sd = dit_reference_state(src)
    flat = params_to_jax(src)
    x, t, kw = probe
    outs = {}
    t0 = time.perf_counter()
    for name in ("import", "jax_layout"):
        with torch.device(device):
            fresh = create_diffusion_cond_from_config(
                cfg, generator=torch.Generator(device=device))[0]
        if name == "import":
            import_dit_params(fresh, sd)
        else:
            load_state(fresh, params_from_jax(flat))
        with torch.no_grad():
            outs[name] = fresh.eval()(x, t, **kw)
        del fresh
        torch.cuda.empty_cache()
    check(torch.equal(outs["import"], outs["jax_layout"])
          and bool(torch.isfinite(outs["import"]).all()),
          "the imported full-width DiT differs from its JAX-layout load")
    return {"keys": len(sd), "bit_equal": True,
            "import_s": time.perf_counter() - t0}


def phase_generation(ctx):
    """The stable-audio generation path (``GenerationApp`` ->
    ``generate_diffusion_cond`` -> the samplers -> the DiT -> the VAE
    pretransform): (1) card vs CPU on a small config at 1e-3 relative, (2)
    the demo server's three routes, (3) Stable Audio Open 1.0's widths,
    (4) the DiT importer at full width. No kernel of the port lies on this
    path: every count stays 0."""
    import torch
    par = gen_parity(ctx)
    par.pop("app")
    emit({"phase": "generation_parity", "config": "Stable Audio Open's "
          "schema at a small width (Oobleck VAE 16 channels, hop 32, 8 "
          "latents; t5-style prompt (1, 16, 64) + seconds; DiT 128 wide, 2 "
          f"layers), {GEN_PARITY_STEPS} steps, CFG {GEN_PARITY_CFG}, TF32 "
          "off, the card's initial noise on the CPU", **par,
          "tolerance": "1e-3 of max|cpu|", "card": ctx["card"]})
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        http = gen_http(ctx, Path(tmp))
    emit({"phase": "generation_http", **http, "bytes_equal": True,
          "card": ctx["card"]})
    torch.cuda.empty_cache()
    full = gen_full(ctx)
    app, probe = full.pop("app"), full.pop("probe")
    emit({"phase": "generation_full", "config": "Stable Audio Open 1.0 "
          "widths (DiT 1536 x 24 layers, 24 heads, cond 768, VAE 128 "
          "channels hop 2048, 64 latents), seeded weights, prompt a seeded "
          "(1, 128, 768) embedding with its mask, seconds 0 / 47, batch 1, "
          f"CFG {GEN_FULL_CFG}, {GEN_FULL_STEPS} sampler steps (cut for the "
          "chip budget; 100 published), 2,097,152 stereo samples",
          **full, "card": ctx["card"]})
    imp = gen_importer(app, probe)
    emit({"phase": "generation_import", **imp, "card": ctx["card"]})
    ctx["generation_launches"] = full["launches"]
    del app, probe
    torch.cuda.empty_cache()


# -- the stable_models phase: the token LM, the codecs, the 1-D U-Nets --------
# MusicGen-small's transformer widths (audiocraft facebook/musicgen-small:
# 1024 wide, 24 layers, 16 heads) over DAC 44 kHz's 9 codebooks of 1024,
# in the delay pattern; the dac_pretrained pretransform at the widths the
# factory fixes (encoder d_model 64, strides 2, 4, 8, 8, hop 512, latent
# 1024, decoder 1536)
LM_FULL = {"model_type": "lm", "sample_rate": 44100, "model": {
    "pretransform": {"type": "dac_pretrained",
                     "config": {"model_type": "44khz"}},
    "lm": {"type": "continuous_transformer", "codebook_pattern": "delay",
           "config": {"n_quantizers": 9, "codebook_size": 1024,
                      "embed_dim": 1024, "depth": 24, "num_heads": 16}}}}
LM_FULL_LENGTH = 172               # frames: 88,064 samples, 2.0 s
LM_FULL_REQUESTS, LM_FULL_TOP_K = 1, 250
LM_PROFILE_STEPS = 16
# the small LM held card against CPU: 4 codebooks of 32, cross-attention,
# prepend and global conditioning, CFG 3
LM_SMALL = {"n_quantizers": 4, "codebook_size": 32, "dim": 64, "depth": 2,
            "num_heads": 4, "cross_attn_cond_dim": 16,
            "prepend_cond_dim": 8, "global_cond_dim": 8}
LM_SMALL_LENGTH, LM_SMALL_CFG = 24, 3.0
# the dance-diffusion U-Net at the reference class's defaults (stereo,
# depth 14, channels 128, 128, 256, 256 + 512 x 10)
DAU_FULL = {"model_type": "diffusion_uncond",
            "model": {"type": "DAU1d", "config": {}}}
DAU_SAMPLE_SIZE, DAU_STEPS = 65536, 8
SMALL_CODECS = {  # the small SEANet and TAAE autoencoders held card vs CPU
    "seanet": ({"dimension": 8, "n_filters": 8, "ratios": [4, 2]},
               {"dimension": 8, "n_filters": 8, "ratios": [4, 2]}),
    "taae": ({"in_channels": 1, "channels": 16, "latent_dim": 8,
              "c_mults": [1, 2], "strides": [2, 4],
              "transformer_depths": [1, 1], "sliding_window": [7, 8],
              "use_snake": True, "conformer": True},
             {"out_channels": 1, "channels": 16, "latent_dim": 8,
              "c_mults": [1, 2], "strides": [2, 4],
              "transformer_depths": [1, 1], "sliding_window": [7, 8],
              "use_snake": True, "conformer": True})}
UNET_SMALL = {"model_type": "diffusion_cond", "model": {"diffusion": {
    "type": "adp_cfg_1d", "cross_attention_cond_ids": ["prompt"],
    "config": {"in_channels": 2, "channels": 16, "multipliers": [1, 2, 2],
               "factors": [2, 2], "num_blocks": [1, 1],
               "attentions": [0, 1, 1], "context_embedding_features": 32,
               "context_embedding_max_length": 8, "attention_heads": 2,
               "attention_features": 16}}}}
DIFFAE_SMALL = {"model_type": "diffusion_autoencoder", "model": {
    "latent_dim": 4, "downsampling_ratio": 8, "io_channels": 1,
    "encoder": {"type": "oobleck", "config": {
        "channels": 8, "c_mults": [1, 2], "strides": [2, 4],
        "latent_dim": 4}},
    "diffusion": {"type": "adp_1d", "config": {
        "in_channels": 5, "out_channels": 1, "channels": 16,
        "multipliers": [1, 2], "factors": [2], "num_blocks": [1],
        "attentions": [0, 1]}}}}


def small_dac(device: str, seed: int):
    """A seeded DACPretransform whose quantizer takes LM_SMALL's codes (4
    codebooks of 32; hop 4, 16 latent channels)."""
    import torch
    from ditsep_tpu_torch.models.bottleneck import DACResidualVQ
    from ditsep_tpu_torch.models.codecs import (DACDecoderWrapper,
                                                DACEncoderWrapper)
    from ditsep_tpu_torch.models.pretransforms import DACPretransform

    with torch.device(device):
        g = torch.Generator(device=device).manual_seed(seed)
        parts = [DACEncoderWrapper(d_model=4, strides=(2, 2)),
                 DACDecoderWrapper(latent_dim=16, channels=16, rates=(2, 2)),
                 DACResidualVQ(16, n_codebooks=4, codebook_size=32,
                               codebook_dim=4)]
        for m in parts:
            m.reset_parameters(g)
    return DACPretransform(*parts).eval()


def small_lm(device: str, seed: int):
    """LM_SMALL seeded, its zero layers redrawn (``nonzero_``)."""
    import torch
    from ditsep_tpu_torch.models.lm import AudioLM
    with torch.device(device):
        lm = AudioLM(**LM_SMALL)
        lm.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    nonzero_(lm, seed + 1)
    return lm.eval()


def lm_teacher_forced(lm, grid, cond: dict, cfg_scale: float):
    """The per-step logits (B, n_q, S, C) of ``lm``'s cached decode fed BOS
    then grid[..., :-1] a token at a time (the prepend on the prefill),
    the CFG pair blended as ``lm_generate`` blends it."""
    import torch
    b, n_q, s = grid.shape
    use_cfg = cfg_scale != 1.0 and bool(cond)
    if use_cfg:
        cond = {k: torch.cat([v, v]) if k == "cross_attn_mask"
                else torch.cat([v, torch.zeros_like(v)])
                for k, v in cond.items()}
    n_prep = cond["prepend_cond"].shape[1] if "prepend_cond" in cond else 0
    cache = lm.init_cache(2 * b if use_cfg else b, n_prep + s + 1)
    bos = torch.full((b, n_q, 1), lm.special_token, dtype=grid.dtype,
                     device=grid.device)
    inp = torch.cat([bos, grid[..., :-1]], dim=-1)
    rest = {k: v for k, v in cond.items() if k != "prepend_cond"}
    out = []
    with torch.no_grad():
        for i in range(s):
            tok = inp[..., i:i + 1]
            lg, cache = lm(torch.cat([tok, tok]) if use_cfg else tok,
                           cache=cache, cache_index=0 if i == 0 else
                           n_prep + i, **(cond if i == 0 else rest))
            lg = lg[:, :, -1]
            if use_cfg:
                c, u = lg.chunk(2)
                lg = u + (c - u) * cfg_scale
            out.append(lg)
    return torch.stack(out, dim=2)


def _rel(got, want) -> float:
    return float((got.detach().cpu().float() - want.detach().float()).abs()
                 .max() / want.detach().float().abs().max())


def stable_parity(ctx, device: str = "cuda") -> dict:
    """(1) The small configs on the card and on the CPU with the same
    weights and the card's draws, TF32 off: the LM's ``lm_generate`` (CFG
    3, top-k 8) replayed teacher-forced on both (every step's logits
    within 1e-4 of max|cpu|), the same codes through a small
    ``DACPretransform.decode_tokens`` (1e-3), SEANet and TAAE
    autoencoders' round trips (1e-4), ``generate_diffusion_cond`` through
    the 'adp_cfg_1d' U-Net and ``DiffusionAutoencoder.reconstruct`` from
    the card's noise (1e-3). Every launch count 0."""
    import copy

    import torch
    from ditsep_tpu_torch.inference.generation import (
        generate_diffusion_cond)
    from ditsep_tpu_torch.models.factory import create_model_from_config
    from ditsep_tpu_torch.models.lm import DelayPattern, lm_generate

    def pair(module):
        return module, copy.deepcopy(module).to("cpu")

    out, rel = {}, {}
    g = torch.Generator().manual_seed(3)
    mask = torch.ones(1, 6, dtype=torch.bool)
    mask[:, 4:] = False
    cond_cpu = {"cross_attn_cond": torch.randn(1, 6, 16, generator=g),
                "cross_attn_mask": mask,
                "prepend_cond": torch.randn(1, 3, 8, generator=g),
                "global_cond": torch.randn(1, 8, generator=g)}
    cond = {k: v.to(device) for k, v in cond_cpu.items()}
    reset_counts()
    with full_f32():
        lm, cpu_lm = pair(small_lm(device, 1))
        tokens = lm_generate(
            lm, 1, LM_SMALL_LENGTH, top_k=8, cfg_scale=LM_SMALL_CFG,
            generator=torch.Generator(device=device).manual_seed(4), **cond)
        check(tokens.shape == (1, 4, LM_SMALL_LENGTH) and int(tokens.min())
              >= 0 and int(tokens.max()) < 32, f"LM tokens {tokens.shape}")
        grid = DelayPattern(4, 32).apply(tokens)
        rel["lm_teacher_forced_logits"] = _rel(
            lm_teacher_forced(lm, grid, cond, LM_SMALL_CFG),
            lm_teacher_forced(cpu_lm, grid.cpu(), cond_cpu, LM_SMALL_CFG))
        pre, cpu_pre = pair(small_dac(device, 5))
        with torch.no_grad():
            rel["dac_decode_tokens"] = _rel(pre.decode_tokens(tokens),
                                            cpu_pre.decode_tokens(
                                                tokens.cpu()))
        x = torch.randn(2, 1, 256, generator=g)
        for name, (enc, dec) in SMALL_CODECS.items():
            with torch.device(device):
                ae = create_model_from_config({
                    "model_type": "autoencoder", "model": {
                        "encoder": {"type": name, "config": enc},
                        "decoder": {"type": name, "config": dec},
                        "bottleneck": {"type": "tanh"}, "latent_dim": 8}},
                    torch.Generator(device=device).manual_seed(6))
            ae, cpu_ae = pair(ae.eval())
            with torch.no_grad():
                rel[f"{name}_round_trip"] = _rel(ae(x.to(device))[0],
                                                 cpu_ae(x)[0])
        with torch.device(device):
            net = create_model_from_config(
                UNET_SMALL, torch.Generator(device=device).manual_seed(7))[0]
        nonzero_(net, 8)
        net, cpu_net = pair(net.eval())
        emb = torch.randn(1, 5, 32, generator=g)
        noise = torch.randn(1, 2, 256, generator=torch.Generator(
            device=device).manual_seed(9), device=device)
        runs = []
        for model, dev in ((net, device), (cpu_net, "cpu")):
            with torch.no_grad():
                runs.append(generate_diffusion_cond(
                    model, steps=4, cfg_scale=3.0, batch_size=1,
                    sample_size=256, io_channels=model.io_channels,
                    cond_inputs={"cross_attn_cond": emb.to(dev)},
                    diffusion_objective=model.diffusion_objective,
                    noise=noise.to(dev)))
        rel["unet_cfg_generate"] = _rel(*runs)
        with torch.device(device):
            dae = create_model_from_config(
                DIFFAE_SMALL, torch.Generator(device=device).manual_seed(10))
        nonzero_(dae.diffusion, 11)
        dae, cpu_dae = pair(dae.eval())
        audio = torch.randn(1, 1, 256, generator=g)
        noise = torch.randn(1, 1, 256, generator=torch.Generator(
            device=device).manual_seed(12), device=device)
        with torch.no_grad():
            rel["diffae_reconstruct"] = _rel(
                dae.reconstruct(audio.to(device), steps=3, noise=noise),
                cpu_dae.reconstruct(audio, steps=3, noise=noise.cpu()))
    torch.cuda.synchronize()
    out["launches"] = counts()
    check(not any(out["launches"].values()),
          f"stable parity launches {out['launches']}")
    bars = {"lm_teacher_forced_logits": 1e-4, "dac_decode_tokens": 1e-3,
            "seanet_round_trip": 1e-4, "taae_round_trip": 1e-4,
            "unet_cfg_generate": 1e-3, "diffae_reconstruct": 1e-3}
    for name, bar in bars.items():
        check(rel[name] <= bar, f"{name}: card vs CPU {rel[name]} > {bar}")
    out["card_vs_cpu_rel"], out["bars"] = rel, bars
    return out


def stable_http(ctx, device: str = "cuda") -> dict:
    """(2) A ``DemoServer(lm=LMApp(...))`` with the small LM and the small
    DAC codec: /api/lm answers 200 with the WAV bytes of a direct
    ``LMApp.process`` at the same seed; without a decoder, the JSON codes
    of the direct call."""
    import urllib.request

    import torch
    from ditsep_tpu_torch.interface import DemoServer, LMApp
    from ditsep_tpu_torch.interface.web import encode_wav

    lm, pre = small_lm(device, 13), small_dac(device, 14)
    body = {"length": 16, "temperature": 0.9, "top_k": 8, "top_p": 0.0,
            "seed": 15}
    out = {}
    reset_counts()
    for name, decode in (("wav", pre.decode_tokens), ("codes", None)):
        app = LMApp(lm=lm, decode_tokens=decode, fs=44100)
        srv = DemoServer(lm=app, port=0).start()
        try:
            with deterministic_cudnn():
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/api/lm",
                    data=json.dumps(body).encode(), method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    status, got = r.status, r.read()
                direct = app.process(**body)
        finally:
            srv.close()
        want = (encode_wav(direct.reshape(-1), app.fs) if decode is not None
                else json.dumps({"codes": direct.tolist()}).encode())
        check(status == 200 and got == want,
              f"/api/lm ({name}) differs from the direct call")
        out[name] = {"status": status, "bytes": len(got),
                     "shape": list(direct.shape)}
    torch.cuda.synchronize()
    out["launches"] = counts()
    check(not any(out["launches"].values()),
          f"/api/lm launches {out['launches']}")
    return out


def stable_lm_full(ctx, cfg: dict = LM_FULL, length: int = LM_FULL_LENGTH,
                   device: str = "cuda") -> dict:
    """(3) The token LM at full width (LM_FULL, seeded, its zero layers
    redrawn at N(0, 0.02^2)) behind ``LMApp`` with the DAC 44 kHz codec:
    LM_FULL_REQUESTS requests of ``length`` frames, temperature 1, top-k
    250, each its prefill and its decode steps timed between
    synchronizations, ``decode_tokens`` timed; the codes in [0, 1024),
    the audio finite; with TF32 off, the last cached step's logits against
    a full uncached pass over the same prefix (1e-4 of max|ref|); 16
    decode steps profiled (the device's idle share); a step's byte bound
    (the parameters read once)."""
    import numpy as np
    import torch
    from ditsep_tpu_torch.interface import LMApp
    from ditsep_tpu_torch.models.factory import (
        create_model_from_config, create_pretransform_from_config)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device(device):
        g = torch.Generator(device=device).manual_seed(21)
        lm, pattern = create_model_from_config(cfg, g)
        pre = create_pretransform_from_config(cfg["model"]["pretransform"],
                                              generator=g)
    nonzero_(lm, 22)
    lm.eval()
    pre.eval()
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    n_params = sum(p.numel() for p in lm.parameters())
    out["lm_params"] = n_params
    out["codec_params"] = sum(p.numel() for p in pre.parameters())
    hop, n_q = pre.downsampling_ratio, lm.n_quantizers
    app = LMApp(lm=lm, decode_tokens=lambda c: pre.decode_tokens(c),
                fs=cfg["sample_rate"])
    steps = length + n_q - 1
    requests = []
    reset_counts()
    with timed_calls(lm, "forward") as calls, \
            timed_calls(pre, "decode_tokens") as decodes:
        for i in range(LM_FULL_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio = app.process(length=length, temperature=1.0,
                                top_k=LM_FULL_TOP_K, seed=30 + i)
            requests.append(time.perf_counter() - t0)
            check(audio.shape == (1, 1, length * hop)
                  and np.isfinite(audio).all(),
                  f"LM request {i}: {audio.shape}")
    torch.cuda.synchronize()
    out["launches"] = counts()
    check(not any(out["launches"].values()),
          f"full-width LM launches {out['launches']}")
    check(len(calls) == LM_FULL_REQUESTS * steps
          and len(decodes) == LM_FULL_REQUESTS,
          f"{len(calls)} LM calls, {len(decodes)} decodes")
    for d in decodes:
        codes = d["args"][0]
        check(codes.shape == (1, n_q, length) and int(codes.min()) >= 0
              and int(codes.max()) < lm.codebook_size,
              f"codes {tuple(codes.shape)} in [{int(codes.min())}, "
              f"{int(codes.max())}]")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["request_s"] = requests
    out["prefill_s"] = [calls[i * steps]["s"]
                        for i in range(LM_FULL_REQUESTS)]
    step_s = [c["s"] for i, c in enumerate(calls) if i % steps]
    q = np.percentile(step_s, [0, 10, 50, 90, 100])
    out["decode_step_s"] = {"n": len(step_s), "min": q[0], "p10": q[1],
                            "median": q[2], "p90": q[3], "max": q[4]}
    out["frames_per_s"] = [length / r for r in requests]
    out["decode_tokens_s"] = [d["s"] for d in decodes]
    bound_s = n_params * 4 / ctx["bandwidth"]
    out["step_bytes"], out["step_bound_ms"] = n_params * 4, bound_s * 1e3
    out["step_bound_share"] = bound_s / q[2]
    # the last cached step against a full uncached pass, TF32 off
    t0 = time.perf_counter()
    grid = pattern.apply(decodes[0]["args"][0])
    bos = torch.full((1, n_q, 1), lm.special_token, dtype=grid.dtype,
                     device=grid.device)
    inp = torch.cat([bos, grid[..., :-1]], dim=-1)
    with full_f32(), torch.no_grad():
        cached = lm_teacher_forced(lm, grid, {}, 1.0)[:, :, -1]
        full = lm(inp)[:, :, -1]
    out["cached_vs_full_rel"] = _rel(cached, full.cpu())
    check(out["cached_vs_full_rel"] <= 1e-4,
          f"cached step vs full pass {out['cached_vs_full_rel']}")
    out["cached_vs_full_s"] = time.perf_counter() - t0
    # LM_PROFILE_STEPS decode steps, the cache prefilled to the middle
    half = steps // 2
    n_prof = min(LM_PROFILE_STEPS, steps - half)
    cache = lm.init_cache(1, steps + 1)
    with torch.no_grad():
        lm(inp[..., :half], cache=cache, cache_index=0)

    def run():
        with torch.no_grad():
            for i in range(n_prof):
                lm(inp[..., half + i:half + i + 1], cache=cache,
                   cache_index=half + i)
        return n_prof

    t0 = time.perf_counter()
    prof = profile_replay(run)
    out["profiled_steps"] = {
        "steps": n_prof, "profile_s": time.perf_counter() - t0,
        "wall_ms": prof["wall_ms"],
        "device_busy_ms": prof["device_busy_ms"],
        "idle_share": prof["idle_share"], "top": prof["top"]}
    out["tf32"] = {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}
    return out


def stable_dau(ctx, cfg: dict = DAU_FULL,
               sample_size: int = DAU_SAMPLE_SIZE,
               device: str = "cuda") -> dict:
    """(4) DAU1d at the reference class's defaults through the factory,
    seeded: DAU_STEPS steps of ``inference.sampling.sample`` from noise of
    ``sample_size`` stereo samples (seconds a step, peak GiB, the output
    finite, 0 launches), one step profiled (the device's idle share, the
    top kernels); then a seeded reference-layout state_dict (its
    own weights, ``dau1d_reference_state``) through ``import_dau1d_params``
    into a fresh U-Net, one forward equal, bit for bit, to the same
    weights through ``params_from_jax``."""
    import torch
    from ditsep_tpu_torch.inference.sampling import sample
    from ditsep_tpu_torch.models.factory import create_model_from_config
    from ditsep_tpu_torch.models.torch_import import (
        dau1d_reference_state, import_dau1d_params)
    from ditsep_tpu_torch.models.weights import (
        load_state, params_from_jax, params_to_jax)

    torch.cuda.reset_peak_memory_stats()
    with torch.device(device):
        dau = create_model_from_config(
            cfg, torch.Generator(device=device).manual_seed(40)).eval()
    out = {"params": sum(p.numel() for p in dau.parameters())}
    io = dau.io_channels
    noise = torch.randn(1, io, sample_size, device=device,
                        generator=torch.Generator(device=device).manual_seed(
                            41))
    reset_counts()
    with timed_calls(dau, "forward") as calls, torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = sample(lambda x, t, **kw: dau(x, t), noise, DAU_STEPS, eta=0.0)
        torch.cuda.synchronize()
        out["sample_s"] = time.perf_counter() - t0
    out["launches"] = counts()
    check(not any(out["launches"].values()),
          f"DAU1d launches {out['launches']}")
    check(y.shape == (1, io, sample_size) and bool(torch.isfinite(y).all()),
          f"DAU1d sample {tuple(y.shape)}")
    out["step_s"] = [c["s"] for c in calls]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    t = torch.full((1,), 0.5, device=device)
    prof = profile_replay(lambda: (dau(noise, t), 1)[1])
    out["profiled_step"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                  "idle_share", "top")}
    t0 = time.perf_counter()
    sd, flat = dau1d_reference_state(dau), params_to_jax(dau)
    outs = {}
    for name in ("import", "jax_layout"):
        with torch.device(device):
            fresh = create_model_from_config(
                cfg, torch.Generator(device=device)).eval()
        if name == "import":
            import_dau1d_params(fresh, sd)
        else:
            load_state(fresh, params_from_jax(flat, fresh))
        with torch.no_grad(), deterministic_cudnn():
            outs[name] = fresh(noise, t)
        del fresh
    check(torch.equal(outs["import"], outs["jax_layout"]),
          "the imported DAU1d differs from its JAX-layout load")
    out["importer"] = {"keys": len(sd), "bit_equal": True,
                       "s": time.perf_counter() - t0}
    return out


def phase_stable_models(ctx):
    """The rest of the stable-audio models (the token LM with its KV
    cache behind ``LMApp`` and /api/lm, the DAC / SEANet / TAAE codecs,
    the adp U-Net, the diffusion autoencoder, DAU1d): (1) card vs CPU on
    small configs, (2) /api/lm, (3) the full-width LM path, (4) DAU1d at
    its reference width with its importer. No kernel of the port lies on
    these paths: every count stays 0. Each line carries its part's
    seconds (``part_s``)."""
    import torch

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return {**out, "part_s": time.perf_counter() - t0}

    par = timed(stable_parity, ctx)
    emit({"phase": "stable_parity", "config": "AudioLM depth 2, width 64, "
          "4 codebooks of 32, cross-attention + prepend + global, CFG 3, "
          f"{LM_SMALL_LENGTH} frames, top-k 8; DAC hop 4; SEANet and TAAE "
          "hop 8; adp_cfg_1d 16 channels, 4 steps; diffusion autoencoder "
          "hop 8, 3 steps; TF32 off, the card's draws on the CPU", **par,
          "card": ctx["card"]})
    http = timed(stable_http, ctx)
    emit({"phase": "stable_http", **http, "bytes_equal": True,
          "card": ctx["card"]})
    torch.cuda.empty_cache()
    full = timed(stable_lm_full, ctx)
    emit({"phase": "stable_lm_full", "config": "MusicGen-small widths (1024 "
          "wide, 24 layers, 16 heads) over DAC 44 kHz's 9 x 1024 codes in "
          "the delay pattern, seeded weights (zero layers redrawn at N(0, "
          f"0.02^2)); LMApp.process x {LM_FULL_REQUESTS}: {LM_FULL_LENGTH} "
          f"frames ({LM_FULL_LENGTH + 8} LM calls), temperature 1, top-k "
          f"{LM_FULL_TOP_K}, decoded by the DAC 44 kHz decoder (1536 "
          "channels, hop 512)", **full, "card": ctx["card"]})
    ctx["stable_launches"] = full["launches"]
    torch.cuda.empty_cache()
    dau = timed(stable_dau, ctx)
    emit({"phase": "stable_dau", "config": "DAU1d at the reference class's "
          "defaults (stereo, depth 14, channels 128, 128, 256, 256 + 512 x "
          f"10), seeded, {DAU_STEPS} v-sampler steps of {DAU_SAMPLE_SIZE} "
          "samples", **dau, "card": ctx["card"]})
    torch.cuda.empty_cache()


# the stable-audio training phase: small trainers card vs CPU (AdamW at a
# constant rate: steps well above float32's resolution), then the
# full-width children and the full-width DiT step
STABLE_PARITY_LR = 1e-3
STABLE_DIT_SMALL = dict(io_channels=4, embed_dim=64, depth=2, num_heads=4,
                        cond_token_dim=16, input_concat_dim=5)
STABLE_LM_SMALL = dict(n_quantizers=4, codebook_size=32, dim=64, depth=2,
                       num_heads=4)
STABLE_AE_VAE = dict(in_channels=1, channels=8, c_mults=(1, 2),
                     strides=(2, 4), latent_dim=4)
STABLE_AE_SAMPLES = 2048
STABLE_AE_DISCS = {  # DAC: one of its MPDs (1024 wide), one MRD
    "dac": {"type": "dac", "config": {"periods": [2],
                                      "fft_sizes": [512]}},
    "oobleck": {"type": "oobleck", "config": {"capacity": 8}}}
# the full-width children: config, batch, sample_size, steps, demo_every
SAO_AE = {"model_type": "autoencoder", "sample_rate": 44100, "model": {
    "encoder": {"type": "oobleck", "config": {**SAO_VAE, "latent_dim": 128}},
    "decoder": {"type": "oobleck", "config": {
        **{k: v for k, v in SAO_VAE.items() if k != "in_channels"},
        "out_channels": 2, "latent_dim": 64}},
    "bottleneck": {"type": "vae"}, "latent_dim": 64},
    "training": {"learning_rate": 1.5e-4, "loss_configs": {
        "discriminator": {"type": "dac", "config": {
            "periods": [2, 3, 5, 7, 11], "fft_sizes": [2048, 1024, 512]}}},
        "demo": {"max_num_sample": 1}}}
STABLE_CHILDREN = {
    "lm": ({**LM_FULL, "training": {"learning_rate": 1e-4,
                                    "demo": {"num_demos": 1}}},
           4, 176128, 4, 3),  # 86 frames a row and a demo
    "diffusion_uncond": ({**DAU_FULL, "sample_rate": 44100, "training": {
        "learning_rate": 1e-4, "demo": {"demo_steps": DAU_STEPS,
                                        "num_demos": 1}}},
        2, 65536, 3, 2),
    "autoencoder": (SAO_AE, 2, 65536, 4, 2),
}
STABLE_DIT_STEPS = 2
# a child's hook: each train / gen / disc step and each demo timed between
# synchronizations (the steps with their losses), and at exit the
# kernels' launch counts and the peak memory, in a file of the hook's
# directory. The children start at once; from its first step a child
# holds a file lock (``card_lock``'s) until it exits, so that one trains
# while the others start and load (their start-up is most of a child's
# wall time)
STABLE_HOOK = """
import atexit, fcntl, json, os, time
import torch
from ditsep_tpu_torch.training import demo
from ditsep_tpu_torch.training.autoencoder import AutoencoderTrainer
from ditsep_tpu_torch.training.diffusion import DiffusionTrainer
from ditsep_tpu_torch.training.lm import LMTrainer
_cuda = torch.cuda.is_available()
_rec = {"step_s": [], "kinds": [], "losses": [], "demo_s": []}
_lock = open(os.environ["CHIP_SMOKE_HOOK_OUT"] + "/../card.lock", "a")


def _sync():
    if _cuda:
        torch.cuda.synchronize()


def _timed(kind, real):
    def step(self, state, *args, **kw):
        if not _rec["step_s"]:  # the card to itself from the first step
            t0 = time.perf_counter()
            fcntl.flock(_lock, fcntl.LOCK_EX)
            _rec["lock_wait_s"] = time.perf_counter() - t0
        _sync()
        t0 = time.perf_counter()
        state, met = real(self, state, *args, **kw)
        _sync()
        _rec["step_s"].append(time.perf_counter() - t0)
        _rec["kinds"].append(kind)
        _rec["losses"].append(float(met.get(
            "train/loss", met.get("train/discriminator_loss"))))
        return state, met
    return step


def _timed_demo(real):
    def call(self, *args, **kw):
        _sync()
        t0 = time.perf_counter()
        real(self, *args, **kw)
        _sync()
        _rec["demo_s"].append(time.perf_counter() - t0)
    return call


for _cls, _name, _kind in ((DiffusionTrainer, "train_step", "train"),
                           (LMTrainer, "train_step", "train"),
                           (AutoencoderTrainer, "gen_step", "gen"),
                           (AutoencoderTrainer, "disc_step", "disc")):
    setattr(_cls, _name, _timed(_kind, getattr(_cls, _name)))
for _cls in (demo.AutoencoderDemoCallback, demo.DiffusionDemoCallback,
             demo.LMDemoCallback):
    _cls.__call__ = _timed_demo(_cls.__call__)


def _dump():
    from ditsep_tpu_torch.ops import cuda_kernels as ck
    _rec["launches"] = {n: getattr(ck, w).launches for n, w in (
        ("fir_down2d", "fir_down2d"), ("fir_up2d", "fir_up2d"),
        ("fba_fwd", "fused_bias_act_fwd"), ("fba_bwd", "fused_bias_act_bwd"),
        ("conv3x3_9tap", "conv3x3_9tap"),
        ("conv3x3_async_halo", "conv3x3_async_halo"))}
    _rec["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                        if _cuda else None)
    path = os.path.join(os.environ["CHIP_SMOKE_HOOK_OUT"],
                        f"{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(_rec, f)


atexit.register(_dump)
"""


def role_draws(spec: dict, generator) -> dict:
    """Draws by role on ``generator``'s device: name -> (shape, 'uniform'
    | 'normal') or (shape, 'int', low, high)."""
    import torch
    out, dev = {}, generator.device
    for name, (shape, kind, *bounds) in spec.items():
        if kind == "uniform":
            out[name] = torch.rand(shape, generator=generator, device=dev)
        elif kind == "normal":
            out[name] = torch.randn(shape, generator=generator, device=dev)
        else:
            out[name] = torch.randint(*bounds, shape, generator=generator,
                                      device=dev)
    return out


def trainer_steps(trainer, n_steps: int, args_of, device) -> dict:
    """``n_steps`` steps of a diffusion, DiffAE or LM trainer, step n on
    ``args_of(device, n)`` (the loss's and the step's positional and
    keyword arguments): the initial parameters (``p0``); before each
    step the parameters (``pre``) and the gradient there; after it the
    parameters and the EMA; the losses."""
    import torch
    state = trainer.init_state()
    run = {"p0": snapshot(state.model), "pre": [], "steps": [],
           "losses": []}
    for n in range(n_steps):
        args, kw = args_of(device, n)
        run["pre"].append({"model": snapshot(state.model)})
        with torch.enable_grad():
            grads = grads_of(trainer.loss(*args, model=state.model, **kw),
                             state.model)
        state, met = trainer.train_step(state, *args, **kw)
        run["losses"].append(met["train/loss"].item())
        run["steps"].append({"grads": grads, "params": snapshot(state.model),
                             "ema": snapshot(state.ema)})
    return run


def trainer_card_vs_cpu(name: str, trainers: dict, args_of, adam: dict,
                        clip: float, device: str) -> dict:
    """Two steps of ``trainers`` ({"cpu": ..., device: ...}, the same
    weights) on the same inputs and draws: each step's gradient leaf by
    leaf (``grads_worst``; the CPU's taken at the card's parameters before
    the step), the losses 1e-4 relative, the parameters and the EMA at
    the train-step bars (``group_worst``, the constant rate)."""
    import torch
    runs = {dev: trainer_steps(tr, 2, args_of, dev)
            for dev, tr in trainers.items()}
    cpu_tr, card = trainers["cpu"], runs[device]

    def step_grads(n):
        args, kw = args_of("cpu", n)
        with torch.enable_grad():
            return grads_of(cpu_tr.loss(*args, model=cpu_tr.model, **kw),
                            cpu_tr.model)
    replay = replay_grads({"model": cpu_tr.model}, card["pre"], step_grads)
    out = {"grad_over_bar": max(
        grads_worst(want, got["grads"], f"{name} step {n}")
        for n, (want, got) in enumerate(zip(replay, card["steps"])))}
    out["loss_rel"] = max(abs(a - c) / abs(c) for a, c in zip(
        card["losses"], runs["cpu"]["losses"]))
    check(out["loss_rel"] <= 1e-4, f"{name} losses: {out}")
    out.update(group_worst(runs["cpu"], card, lambda n: trainers[
        "cpu"].lr, clip, decay=cpu_tr.ema_decay, adam=adam))
    check(out["param_over_bar"] <= 1 and out["ema_over_bar"] <= 1,
          f"{name} steps card vs CPU: {out}")
    out["losses_card"] = card["losses"]
    return out


def ae_card_vs_cpu(name: str, vae, disc, reals, draws, device: str,
                   loss_cfg=None, latent_mask_ratio: float = 0.0) -> dict:
    """A gen + disc step pair of the VAE-GAN trainer (copies of ``vae`` and
    ``disc``, ClipAdamW at lr ``LDM_PARITY_LR``, the discriminator's twice
    that) on ``reals`` (numpy) with ``draws`` (numpy, a dict a step), on
    the card and on the CPU: each step's gradient against the CPU's at the
    card's parameters (a disc step's on the card's fakes, its bar a share
    of the larger of its two terms, ``hinge_term_scales``), the losses
    1e-4, the parameters at the train-step bars."""
    import copy

    import torch
    from ditsep_tpu_torch.training.autoencoder import AutoencoderTrainer
    from ditsep_tpu_torch.training.schedules import inverse_lr_schedule

    kw = {} if loss_cfg is None else {"loss_cfg": loss_cfg}
    trainers, out = {}, {}
    for dev in ("cpu", device):
        trainers[dev] = AutoencoderTrainer(
            vae=copy.deepcopy(vae).to(dev), disc=copy.deepcopy(disc).to(dev),
            lr=LDM_PARITY_LR, disc_lr=2 * LDM_PARITY_LR,
            latent_mask_ratio=latent_mask_ratio, **kw)
        out[dev] = ae_parity_steps(trainers[dev], reals, draws, dev)
    cpu_ae, card = trainers["cpu"], out[device]
    tn = torch.from_numpy
    fakes = [None if f is None else tn(f) for f in card["fakes"]]
    replay = replay_grads({"vae": cpu_ae.vae, "disc": cpu_ae.disc},
                          card["pre"], lambda n: ae_step_grads(
                              cpu_ae, n, tn(reals), draws, fakes[n]))
    res = {"grad_over_bar": {"gen": 0.0, "disc": 0.0}}
    for n, ((want, scale), got) in enumerate(zip(replay, card["grads"])):
        kind = "disc" if cpu_ae.use_disc_this_step(n) else "gen"
        res["grad_over_bar"][kind] = max(res["grad_over_bar"][kind],
                                         grads_worst(
            want, got, f"{name} step {n} at the card's parameters",
            scale=scale))
    res["loss_rel"] = max(abs(a - c) / abs(c) for a, c in zip(
        card["losses"], out["cpu"]["losses"]))
    check(res["loss_rel"] <= 1e-4, f"{name} losses card vs CPU {res}")
    for group, lr in (("vae", LDM_PARITY_LR), ("disc", 2 * LDM_PARITY_LR)):
        worst = group_worst(out["cpu"]["groups"][group],
                            card["groups"][group], inverse_lr_schedule(lr),
                            math.inf, decay=0.9999 if group == "vae"
                            else None)
        check(worst["param_over_bar"] <= 1 and worst["ema_over_bar"] <= 1,
              f"{name} {group} steps card vs CPU: {worst}")
        res[group] = worst
    res["losses_card"] = card["losses"]
    return res


def stable_ae_case(disc_cfg: dict, g) -> dict:
    """``ae_card_vs_cpu``'s arguments for the small VAE (seeded) against
    the ``disc_cfg`` discriminator (seeded), reals and draws from ``g``."""
    import torch
    from ditsep_tpu_torch.models.discriminators import (
        create_discriminator_from_config)
    from ditsep_tpu_torch.models.oobleck import OobleckVAE
    from ditsep_tpu_torch.training.autoencoder import AutoencoderLossConfig

    b, t = 2, STABLE_AE_SAMPLES
    tl = t // math.prod(STABLE_AE_VAE["strides"])
    reals = 0.3 * torch.randn(b, 1, t, generator=g, device=g.device)
    draws = [{"enc_z": torch.randn(b, STABLE_AE_VAE["latent_dim"], tl,
                                   generator=g, device=g.device)
              .cpu().numpy()} for _ in range(2)]
    vae = OobleckVAE(**STABLE_AE_VAE)
    vae.reset_parameters(torch.Generator().manual_seed(61))
    disc = create_discriminator_from_config(disc_cfg, sample_rate=FS)
    disc.reset_parameters(torch.Generator().manual_seed(62))
    return {"vae": vae, "disc": disc, "reals": reals.cpu().numpy(),
            "draws": draws, "loss_cfg": AutoencoderLossConfig(
                fft_sizes=(512, 128), hop_sizes=(128, 32), sample_rate=FS)}


def stable_train_parity(ctx, device: str = "cuda",
                        discs: dict = STABLE_AE_DISCS) -> dict:
    """(1) The new trainers on small configs on the card and on the CPU
    with the same weights and the card's draws, TF32 off, two steps each:
    ``DiffusionTrainer`` (a DiT 64 wide: cross-attention conditioning with
    CFG dropout 0.5, inpainting, a padding mask), ``DiffAETrainer`` (the
    small diffusion autoencoder), ``LMTrainer`` (4 codebooks of 32, the
    clip on), the VAE-GAN with a DAC and with an Oobleck discriminator.
    Every launch count 0."""
    import copy

    import torch
    from ditsep_tpu_torch.models.dit import DiffusionTransformer
    from ditsep_tpu_torch.models.factory import create_model_from_config
    from ditsep_tpu_torch.models.lm import AudioLM
    from ditsep_tpu_torch.training.diffusion import (
        INT32_MAX, CondRouting, DiffAETrainer, DiffusionTrainer)
    from ditsep_tpu_torch.training.lm import LMTrainer

    g = torch.Generator(device=device).manual_seed(50)

    def pair(module, seed):
        """``module`` (seeded on the CPU) with its zero layers redrawn,
        and a copy of it on the device."""
        nonzero_(module, seed)
        return {"cpu": module, device: copy.deepcopy(module).to(device)}

    def seeded(module, seed):
        module.reset_parameters(torch.Generator().manual_seed(seed))
        return module

    def on(dev, a):
        return a.to(dev) if isinstance(a, torch.Tensor) else a

    out = {}
    reset_counts()
    with full_f32():
        b, c, t, segs = 2, 4, 32, 4
        spec = {"t": ((b,), "uniform"), "noise": ((b, c, t), "normal"),
                "cfg_cross": ((b, 1, 1), "uniform"),
                "cfg_prepend": ((b, 1, 1), "uniform"),
                "mask_type": ((b,), "int", 0, 3),
                "n_segments": ((b,), "int", 1, segs + 1),
                "seg_len": ((b, segs), "int", 0, INT32_MAX),
                "seg_start": ((b, segs), "int", 0, INT32_MAX),
                "causal_len": ((b,), "int", 0, INT32_MAX)}
        draws = [role_draws(spec, g) for _ in range(2)]
        x0 = [torch.randn(b, c, t, generator=g, device=device)
              for _ in range(2)]
        mask = torch.ones(b, 5, dtype=torch.bool)
        mask[0, 3:] = False
        prompt = (torch.randn(b, 5, 16, generator=g, device=device), mask)
        padding = torch.ones(b, t, dtype=torch.bool)
        padding[1, 20:] = False
        routing = CondRouting(cross_attn_cond_ids=("prompt",),
                              input_concat_ids=("inpaint_mask",
                                                "inpaint_masked_input"))
        nets = pair(seeded(DiffusionTransformer(**STABLE_DIT_SMALL), 51), 52)
        out["diffusion"] = trainer_card_vs_cpu(
            "DiffusionTrainer", {dev: DiffusionTrainer(
                model=m, routing=routing, inpaint=True, cfg_dropout_prob=0.5,
                max_mask_segments=segs, lr=STABLE_PARITY_LR)
                for dev, m in nets.items()},
            lambda dev, n: ((on(dev, x0[n]), {"prompt": tuple(
                on(dev, a) for a in prompt)}, on(dev, padding)),
                {"draws": {k: on(dev, v) for k, v in draws[n].items()}}),
            {"b1": 0.9, "b2": 0.999, "weight_decay": 1e-3}, math.inf,
            device)

        aes = pair(create_model_from_config(
            DIFFAE_SMALL, torch.Generator().manual_seed(53)), 54)
        audio = [0.3 * torch.randn(b, 1, 64, generator=g, device=device)
                 for _ in range(2)]
        ae_draws = [role_draws({"t": ((b,), "uniform"),
                                "noise": ((b, 1, 64), "normal")}, g)
                    for _ in range(2)]
        out["diffae"] = trainer_card_vs_cpu(
            "DiffAETrainer", {dev: DiffAETrainer(
                model=m, lr=STABLE_PARITY_LR) for dev, m in aes.items()},
            lambda dev, n: ((on(dev, audio[n]),), {"draws": {
                k: on(dev, v) for k, v in ae_draws[n].items()}}),
            {"b1": 0.9, "b2": 0.999, "weight_decay": 1e-3}, math.inf,
            device)

        lms = pair(seeded(AudioLM(**STABLE_LM_SMALL), 55), 56)
        tokens = [torch.randint(0, 32, (b, 4, 16), generator=g,
                                device=device) for _ in range(2)]
        out["lm"] = trainer_card_vs_cpu(
            "LMTrainer", {dev: LMTrainer(model=m, lr=STABLE_PARITY_LR,
                                         clip_grad_norm=0.5)
                          for dev, m in lms.items()},
            lambda dev, n: ((on(dev, tokens[n]),), {}),
            {"b1": 0.9, "b2": 0.95, "weight_decay": 0.1}, 0.5, device)

        for name, cfg in discs.items():
            out[f"vaegan_{name}"] = ae_card_vs_cpu(
                f"VAE-GAN {name}", device=device, **stable_ae_case(cfg, g))
    if device != "cpu":
        torch.cuda.synchronize()
    out["launches"] = counts()
    check(not any(out["launches"].values()),
          f"stable_train parity launches {out['launches']}")
    return out


def loss_trend(kinds: list, losses: list) -> dict:
    """Per step kind (train, gen, disc): its first and last loss, all
    finite."""
    out = {}
    for kind in dict.fromkeys(kinds):
        ls = [v for k, v in zip(kinds, losses) if k == kind]
        check(all(math.isfinite(v) for v in ls), f"{kind} losses {ls}")
        out[kind] = {"first": ls[0], "last": ls[-1], "n": len(ls)}
    return out


def stable_train_cli(ctx, children: dict = STABLE_CHILDREN,
                     cpu: bool = False, root: Path = REPO / "build",
                     while_starting=None) -> dict:
    """(2) ``python -m ditsep_tpu_torch.cli.train_stable`` in a child a
    model type, started at once, with STABLE_HOOK (one child trains at a
    time): each step timed between synchronizations, one demo
    (``--demo-every``), the final JSON with 0 failed media calls, finite
    losses, every launch count 0, the peak memory. ``cpu`` adds --cpu
    (the CPU rehearsal); the children's files go in a temporary directory
    under ``root``; ``while_starting`` runs as ``run_children``'s."""
    out = {}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        tmp = Path(tmp)
        hook = tmp / "hook"
        hook.mkdir()
        (hook / "sitecustomize.py").write_text(STABLE_HOOK)
        cmds = {}
        for name, (cfg, batch, size, steps, demo) in children.items():
            path = tmp / f"{name}.json"
            path.write_text(json.dumps(cfg))
            cmds[name] = (
                ["-m", "ditsep_tpu_torch.cli.train_stable", "--model-config",
                 str(path), "--workdir", str(tmp / name), "--batch-size",
                 str(batch), "--sample-size", str(size), "--max-steps",
                 str(steps), "--demo-every", str(demo)]
                + (["--cpu"] if cpu else []))
        results = run_children(cmds, hook, tmp, while_starting)
        for name, (cfg, batch, size, steps, demo) in children.items():
            res = results[name]
            (rec,) = res["recs"]
            final = json.loads(res["stdout"].strip().splitlines()[-1])
            check(final["steps"] == steps and final["media_failures"] == 0
                  and all(math.isfinite(v) for v in final["final"].values()),
                  f"{name}: final {final}")
            check(len(rec["step_s"]) == steps and len(rec["demo_s"]) == 1
                  and not any(rec["launches"].values()), f"{name}: {rec}")
            out[name] = {"batch": batch, "sample_size": size,
                         "step_s": rec["step_s"], "kinds": rec["kinds"],
                         "trend": loss_trend(rec["kinds"], rec["losses"]),
                         "demo_s": rec["demo_s"],
                         "peak_gib": rec["peak_gib"],
                         "launches": rec["launches"], "final": final,
                         "lock_wait_s": rec["lock_wait_s"],
                         "wall_s": res["wall_s"]}
    return out


def stable_dit_full(ctx, cfg: dict = SAO_FULL,
                    sample_size: int = SAO_SAMPLE_SIZE,
                    device: str = "cuda") -> dict:
    """(3) ``DiffusionTrainer`` on the conditional DiT at Stable Audio Open
    1.0's widths (seeded, its zero layers redrawn; the generation phase's
    seeded prompt embedding and seconds through the conditioners), batch
    1 of the latent length, CFG dropout 0.1 from a card generator:
    STABLE_DIT_STEPS steps on the same draws (t, noise, dropout: the
    generator reseeded before each), so that the losses differ by the
    updates alone, each timed between synchronizations, the losses
    finite, the peak memory, every launch count 0."""
    import torch
    from ditsep_tpu_torch.training.diffusion import DiffusionTrainer

    torch.cuda.reset_peak_memory_stats()
    app = generation_app(cfg, sample_size, device, seed=70)
    conf = cfg["model"]["conditioning"]
    prompt_len = conf["configs"][0]["config"]["max_length"]
    with torch.no_grad():
        cond = app.conditioner(gen_inputs(prompt_len, conf["cond_dim"], 71))
    trainer = DiffusionTrainer(model=app.model, routing=app.routing)
    g = torch.Generator(device=device).manual_seed(72)
    latents = torch.randn(1, app.io_channels, sample_size
                          // app.pretransform.downsampling_ratio,
                          generator=g, device=device)
    state = trainer.init_state()
    out = {"params": sum(p.numel() for p in app.model.parameters()),
           "latent_shape": list(latents.shape), "step_s": [], "losses": []}
    reset_counts()
    for _ in range(STABLE_DIT_STEPS):
        g.manual_seed(73)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = trainer.train_step(state, latents, cond, generator=g)
        out["losses"].append(met["train/loss"].item())
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
    out["launches"] = counts()
    check(not any(out["launches"].values()),
          f"full-width DiT step launches {out['launches']}")
    check(all(math.isfinite(v) for v in out["losses"]),
          f"full-width DiT losses {out['losses']}")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def phase_stable_train(ctx):
    """The stable-audio training path, which no kernel of the port lies on
    (every count 0): (1) the new trainers card vs CPU on small configs,
    (2) ``cli.train_stable`` at full width for the LM, DAU1d and the
    Stable Audio Open VAE against the DAC discriminator, (3) the
    conditional DiT's step at Stable Audio Open 1.0's widths. (1) runs
    while (2)'s children start. Each line carries its part's seconds
    (``part_s``; (2)'s includes (1)'s)."""
    import torch

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return {**out, "part_s": time.perf_counter() - t0}

    par = {}
    cli = timed(stable_train_cli, ctx, STABLE_CHILDREN, False, REPO / "build",
                lambda _: par.update(timed(stable_train_parity, ctx)))
    emit({"phase": "stable_train_parity", "config": "DiT 64 wide, 2 "
          "layers (cross-attention + CFG dropout 0.5, inpainting, a padding "
          "mask); the diffusion autoencoder of stable_models; AudioLM 4 x "
          f"32, clip 0.5 (AdamW lr {STABLE_PARITY_LR}); the VAE-GAN (VAE "
          "8 channels, hop 8) with DAC (period 2, MRD 512) and "
          f"Oobleck discriminators (ClipAdamW lr {LDM_PARITY_LR}); TF32 off, "
          "the card's draws on the CPU, two steps each", **par,
          "tolerance": TRAIN_PARITY_TOLERANCE + "; the CPU's gradient at "
          "the card's parameters before each step; a disc step's on the "
          "card's fakes, 1e-3 of the larger of its two terms' gradients "
          "where that is larger; parameters plus the part float64 AdamW "
          "explains", "card": ctx["card"]})
    emit({"phase": "stable_train_cli", "config": "cli.train_stable: the LM "
          "at MusicGen-small's widths over DAC 44 kHz's 9 x 1024 codes, "
          "batch 4 x 86 frames; DAU1d at its defaults, batch 2 x 65,536 "
          "stereo; the Stable Audio Open 1.0 VAE (128 channels, strides 2, "
          "4, 4, 8, 8, 64 latents, stereo, 44.1 kHz) against the DAC "
          "discriminator (periods 2, 3, 5, 7, 11; fft 2048, 1024, 512; "
          "five bands), batch 2 x 65,536; seeded", **cli,
          "card": ctx["card"]})
    torch.cuda.empty_cache()
    dit = timed(stable_dit_full, ctx)
    emit({"phase": "stable_train_dit", "config": "DiffusionTrainer on "
          "Stable Audio Open 1.0's DiT (1536 x 24, cond 768), seeded, "
          "batch 1 x 1,024 latent frames, the generation phase's seeded "
          "conditioning", **dit, "card": ctx["card"]})
    torch.cuda.empty_cache()
    ctx["stable_train_launches"] = {
        "stable_train_parity": par["launches"],
        **{f"stable_train_cli_{k}": v["launches"] for k, v in cli.items()
           if k != "part_s"},
        "stable_train_dit": dit["launches"]}


MESH_STEPS, MESH_ITEMS = 2, 12     # one epoch of 2 steps at batch 6
MESH_LEN_S = 1.0                   # a batch row's seconds (2 until PR 19)
MESH_VAL_N = 3                     # the validation's PC steps in both runs
MESH_EVAL_ITEMS, MESH_GLOO_ITEMS = 1, 3
MESH_CHILD_TIMEOUT_S = 300  # all of a run_children call's children
LOCK = "card.lock"  # in the children's root: see STABLE_HOOK, MESH_HOOK
MESH_EVAL_TOL = 1e-3  # abs, every number of the gloo JSONs but runtime
# a child's hook: TF32 off and deterministic cuDNN, each train step and
# its gradient all-reduce timed (synchronized), and at exit its kernels'
# launch counts, those times, the losses and the peak memory, in a file
# of the hook's directory. The children start at once; from its first
# use of CUDA a child holds a file lock (``card_lock``'s) until it exits,
# so that one works on the card while the others import: no other child
# holds device memory while one trains (the cuDNN algorithm a convolution
# gets may depend on the memory left, and plain and --mesh must match
# bit for bit)
MESH_HOOK = """
import atexit, fcntl, json, os, sys, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.training.diffsep import DiffSepTrainer
_rec = {"step_s": [], "losses": [], "all_reduce_s": []}
_step, _all_reduce = DiffSepTrainer.train_step, parallel.all_reduce_grads_
_lazy_init = torch.cuda._lazy_init
_lock = open(os.environ["CHIP_SMOKE_HOOK_OUT"] + "/../card.lock", "a")
_t_hook = time.perf_counter()


def _held_lazy_init():
    if "lock_wait_s" not in _rec:
        t0 = time.perf_counter()
        fcntl.flock(_lock, fcntl.LOCK_EX)
        _rec["lock_wait_s"] = time.perf_counter() - t0
    _lazy_init()


def _timed(self, state, batch, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = _step(self, state, batch, **kw)
    _rec["losses"].append(met["train/score_loss"].item())
    _rec["step_s"].append(time.perf_counter() - t0)
    return state, met


def _timed_all_reduce(grads, mesh):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _all_reduce(grads, mesh)
    torch.cuda.synchronize()
    _rec["all_reduce_s"].append(time.perf_counter() - t0)


DiffSepTrainer.train_step = _timed
parallel.all_reduce_grads_ = _timed_all_reduce
torch.cuda._lazy_init = _held_lazy_init


def _dump():
    ck = sys.modules.get("ditsep_tpu_torch.ops.cuda_kernels")
    if ck is None:  # torch.distributed.run's own process
        return
    _rec["launches"] = {n: getattr(ck, w).launches for n, w in (
        ("fir_down2d", "fir_down2d"), ("fir_up2d", "fir_up2d"),
        ("fba_fwd", "fused_bias_act_fwd"), ("fba_bwd", "fused_bias_act_bwd"),
        ("conv3x3_9tap", "conv3x3_9tap"),
        ("conv3x3_async_halo", "conv3x3_async_halo"))}
    _rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    _rec["rank"] = int(os.environ.get("RANK", "-1"))
    _rec["process_s"] = time.perf_counter() - _t_hook
    path = os.path.join(os.environ["CHIP_SMOKE_HOOK_OUT"],
                        f"{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(_rec, f)


atexit.register(_dump)
"""


def child_env(hook_dir: Path, out_dir: Path) -> dict:
    """A child's environment: the hook's directory and the repository on
    PYTHONPATH, the hook's output directory (made)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    return {**os.environ, "PYTHONPATH": f"{hook_dir}:{REPO}",
            "CHIP_SMOKE_HOOK_OUT": str(out_dir),
            "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


@contextlib.contextmanager
def card_lock(path: Path):
    """The file lock that a hook's children take from their first step
    (``root / LOCK`` of ``run_children``): held, no child works on the
    card."""
    import fcntl
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def run_children(cmds: dict, hook_dir: Path, root: Path,
                 while_starting=None, unlocked: tuple = ()) -> dict:
    """Start every ``cmds`` child (name -> a python command line) at once
    from the repository with the hook, their output in files under
    ``root``, and wait for all under one hard timeout (every child killed
    on it). ``while_starting`` (a callable, given the children's
    processes by name) runs meanwhile holding ``card_lock``, so before any
    child's first step but those named in ``unlocked`` (their hook's
    lock is another file). Returns by name the seconds from the start to
    its exit, the standard output and the hook's records; a non-zero
    exit fails."""
    import subprocess
    procs, hook_out = {}, {}
    t0 = time.perf_counter()
    for name, cmd in cmds.items():
        out, err = (open(root / f"{name}.{k}", "w") for k in ("out", "err"))
        hook_out[name] = (root / "unlocked" if name in unlocked
                          else root) / f"hook_{name}"
        procs[name] = subprocess.Popen(
            [sys.executable, *cmd], cwd=str(REPO), stdout=out, stderr=err,
            env=child_env(hook_dir, hook_out[name]))
        out.close()
        err.close()
    done = {}
    try:
        if while_starting is not None:
            with card_lock(root / LOCK):
                while_starting(procs)
        while len(done) < len(procs):
            check(time.perf_counter() - t0 < MESH_CHILD_TIMEOUT_S,
                  f"children {sorted(set(procs) - set(done))} still running "
                  f"after {MESH_CHILD_TIMEOUT_S} s")
            for name, proc in procs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res = {}
    for name, proc in procs.items():
        check(proc.returncode == 0, f"{' '.join(cmds[name][:6])}... exited "
              f"{proc.returncode}: "
              f"{(root / f'{name}.err').read_text()[-3000:]}")
        res[name] = {"wall_s": done[name],
                     "stdout": (root / f"{name}.out").read_text(),
                     "recs": [json.loads(p.read_text()) for p in sorted(
                         hook_out[name].glob("*.json"))]}
    return res


def torchrun(nproc: int, module: str) -> list:
    from ditsep_tpu_torch.parallel import free_port
    return ["-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc-per-node", str(nproc), "--master-addr", "127.0.0.1",
            "--master-port", str(free_port()), "-m", module]


def sum_launches(recs) -> dict:
    out = {}
    for r in recs:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def gloo_evaluate(mesh, out_dir) -> dict:
    """``evaluate_dataset`` of the checkpoint's PC sampler (N=5) over 5
    items of 1 s at batch 2, TF32 off."""
    import torch
    from ditsep_tpu_torch.configs import build_diffsep_trainer
    from ditsep_tpu_torch.data import SyntheticMixDataset
    from ditsep_tpu_torch.eval import evaluate_dataset

    dev = torch.device("cuda") if mesh is None else mesh.device
    with full_f32():
        trainer = build_diffsep_trainer(parity_config(), device=dev,
                                        params_npz=str(CKPT))

        def sep(mix, lengths=None, generator=None):
            return trainer.separate(mix, N=5, generator=generator)[0]

        ds = SyntheticMixDataset(n_items=MESH_GLOO_ITEMS, min_len_s=1.0,
                                 max_len_s=1.0, seed=7)
        res = evaluate_dataset(sep, ds, fs=FS, batch_size=2, nfe=10,
                               warmup=False, device=dev, mesh=mesh,
                               out_dir=out_dir)
    return {k: res[k] for k in ("results", "summary", "chunks", "calls")}


def gloo_child(mesh, out: str, batches, draws) -> None:
    """Rank ``mesh.rank`` of the two gloo ranks on cuda:0."""
    import pickle
    reset_counts()
    steps, _ = checkpoint_steps(parity_config(), mesh.device, batches, draws,
                                mesh=mesh)
    ev = gloo_evaluate(mesh, f"{out}.json" if mesh.rank == 0 else None)
    with open(f"{out}.{mesh.rank}", "wb") as f:
        pickle.dump({"steps": steps, "eval": ev, "launches": counts()}, f)


def max_json_diff(a, b, path="") -> float:
    """The largest |a - b| over the numbers of two JSON trees, runtime
    aside; any other difference fails."""
    if isinstance(a, dict):
        check(set(a) == set(b), f"keys differ at {path}")
        return max([max_json_diff(a[k], b[k], f"{path}/{k}") for k in a
                    if k != "runtime"] + [0.0])
    if isinstance(a, list):
        check(len(a) == len(b), f"lengths differ at {path}")
        return max([max_json_diff(x, y, path) for x, y in zip(a, b)]
                   + [0.0])
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b)
    check(a == b, f"{path}: {a} != {b}")
    return 0.0


def mesh_gloo(ctx, tmp: Path, launches: dict) -> None:
    """The mesh phase's (b): two gloo ranks sharing cuda:0 against one
    process, their files under ``tmp``, their launches into
    ``launches``."""
    import pickle

    import torch
    from ditsep_tpu_torch import parallel

    batches, draws = train_parity_draws(4, 2, seed=13)
    t0 = time.perf_counter()
    parallel.launch(gloo_child, 2, str(tmp / "gloo"), batches, draws,
                    device="cuda:0", backend="gloo",
                    timeout_s=MESH_CHILD_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    ranks = [pickle.loads((tmp / f"gloo.{r}").read_bytes())
             for r in range(2)]
    one_steps, cfg = checkpoint_steps(parity_config(), "cuda", batches,
                                      draws)
    worst = train_parity_worst({"cpu": one_steps, "cuda":
                                ranks[0]["steps"], "cfg": cfg},
                               explain=False)
    check(worst["param_over_bar"] <= 1 and worst["ema_over_bar"] <= 1,
          f"two gloo ranks vs one process: {worst}")
    one_eval = gloo_evaluate(None, str(tmp / "gloo_one"))
    check(ranks[0]["eval"]["chunks"] == one_eval["chunks"],
          f"chunks {ranks[0]['eval']['chunks']} {one_eval['chunks']}")
    diff = max(max_json_diff(
        json.loads((tmp / "gloo.json" / f"test{suffix}.json").read_text()),
        json.loads((tmp / "gloo_one" / f"test{suffix}.json").read_text()))
        for suffix in ("", "_summary"))
    check(diff <= MESH_EVAL_TOL, f"gloo evaluate JSONs differ by {diff}")
    launches["mesh_gloo"] = sum_launches(ranks)
    emit({"phase": "mesh_gloo", "what": "two gloo ranks on cuda:0 "
          "(torch.distributed, TF32 off): two train steps of "
          f"{CKPT.name} (nf=32) on a batch of 4 x 1 s split 2 + 2, and "
          f"evaluate_dataset on {MESH_GLOO_ITEMS} items of 1 s at batch "
          "2 (N=5), each against one process on the card",
          **{k: float(v) for k, v in worst.items()},
          "tolerance": TRAIN_PARITY_TOLERANCE + f"; the evaluate JSONs "
          f"{MESH_EVAL_TOL} abs on every number but runtime",
          "eval_json_max_abs_diff": diff,
          "eval_chunks": ranks[0]["eval"]["chunks"],
          "losses": [h["loss"] for h in ranks[0]["steps"]["steps"]],
          "wall_s": gloo_s, "launches": launches["mesh_gloo"],
          "card": ctx["card"]})
    torch.cuda.empty_cache()  # the card's memory to the children


def phase_mesh(ctx):
    """Data parallelism (``ditsep_tpu_torch.parallel``) on the card.
    (a) ``cli.train_diffsep`` at the flagship width under
    ``torch.distributed.run`` with --mesh (NCCL, world size 1) against the
    same run without it: the losses, the validation and the EMA export
    bit-equal, the step times apart (the all-reduce's cost); and
    ``cli.evaluate --mesh``. (b) Two gloo ranks sharing cuda:0: two
    train steps of the trained nf=32 checkpoint on a batch of 4 split 2 +
    2 against one process at the train-step bars, and
    ``evaluate_dataset`` on 3 items against one process (``mesh_gloo``).
    The three children of (a) start together; (b) runs beside the
    evaluate child while the train children import, and then these work
    on the card one at a time (MESH_HOOK's lock, from a child's first use
    of CUDA)."""
    import numpy as np

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        tmp = Path(tmp)
        hook = tmp / "hook"
        hook.mkdir()
        (hook / "sitecustomize.py").write_text(MESH_HOOK)
        train = ["--config", "diffsep_icassp", "--synthetic",
                 "--synthetic-items", str(MESH_ITEMS), "--synthetic-len-s",
                 str(MESH_LEN_S), "--batch-size", str(TRAIN_BATCH),
                 "--max-steps", str(MESH_STEPS), "--override",
                 f"model.sampler.N={MESH_VAL_N}", "--workdir"]
        mesh_cmd = torchrun(1, "ditsep_tpu_torch.cli.train_diffsep")
        eval_cmd = torchrun(1, "ditsep_tpu_torch.cli.evaluate")
        port = mesh_cmd.index("--master-port") + 1
        while eval_cmd[port] == mesh_cmd[port]:
            eval_cmd = torchrun(1, "ditsep_tpu_torch.cli.evaluate")

        def gloo_then_evaluate(procs):
            # the gloo part beside the evaluate child (neither's numbers
            # depend on the other); then, evaluate done, the train
            # children have the card to themselves one at a time
            mesh_gloo(ctx, tmp, launches)
            while procs["evaluate"].poll() is None:
                check(time.perf_counter() - t_phase < MESH_CHILD_TIMEOUT_S,
                      "the --mesh evaluate child still running")
                time.sleep(0.1)

        res = run_children({
            "plain": ["-m", "ditsep_tpu_torch.cli.train_diffsep", *train,
                      str(tmp / "plain")],
            "mesh": [*mesh_cmd, "--mesh", *train, str(tmp / "mesh")],
            "evaluate": [
                *eval_cmd, "--mesh", "--config", "diffsep_icassp",
                "--synthetic", "--synthetic-items", str(MESH_EVAL_ITEMS),
                "--synthetic-len-s", "2.0", "--eval-batch-size", "2",
                "--sampler-N", "5", "--no-warmup", "--out-dir",
                str(tmp / "eval")]}, hook, tmp,
            while_starting=gloo_then_evaluate, unlocked=("evaluate",))
        # the processes that launched kernels (not torch.distributed.run's)
        runs = {k: {"wall_s": r["wall_s"], "recs": [
            rec for rec in r["recs"] if sum(rec["launches"].values())]}
            for k, r in res.items()}
        for name, r in runs.items():
            check(len(r["recs"]) == 1, f"{name}: records {r['recs']}")
        plain, mesh = (runs[k]["recs"][0] for k in ("plain", "mesh"))
        check(mesh["rank"] == 0 and len(mesh["step_s"]) == MESH_STEPS,
              f"mesh run record {mesh}")
        check(plain["losses"] == mesh["losses"],
              f"train losses {plain['losses']} vs {mesh['losses']}")
        vals = {k: [{m: v for m, v in json.loads(ln).items() if m != "time"}
                    for ln in open(tmp / k / "metrics.jsonl")]
                for k in ("plain", "mesh")}
        check(vals["plain"] == vals["mesh"] and len(vals["mesh"]) == 1,
              f"validations {vals}")
        ema = {k: np.load(tmp / k / "ema.npz") for k in ("plain", "mesh")}
        check(sorted(ema["plain"].files) == sorted(ema["mesh"].files)
              and all(np.array_equal(ema["plain"][f], ema["mesh"][f])
                      for f in ema["plain"].files), "EMA exports differ")
        check(mesh["launches"] == plain["launches"]
              and mesh["launches"]["fir_up2d"] == (
                  MESH_STEPS * 2 * UP_LAUNCHES_PER_BACKWARD),
              f"launches {mesh['launches']} vs {plain['launches']}")
        launches["mesh_train_nccl"] = mesh["launches"]
        step = {k: sum(r["step_s"][1:]) / (MESH_STEPS - 1)
                for k, r in (("plain", plain), ("mesh", mesh))}
        emit({"phase": "mesh_train", "what": "cli.train_diffsep "
              "diffsep_icassp (nf=128, seeded weights), batch 6 x "
              f"{MESH_LEN_S} s, "
              f"{MESH_STEPS} steps and a validation (PC N={MESH_VAL_N}), "
              "TF32 off, deterministic cuDNN: plain vs python -m "
              "torch.distributed.run --nproc-per-node 1 ... --mesh (NCCL, "
              "world size 1: the all-reduce a copy)", "bit_equal": True,
              "losses": mesh["losses"], "validation": vals["mesh"],
              "step_s_plain": plain["step_s"], "step_s_mesh": mesh["step_s"],
              "step_s_after_first": step,
              "all_reduce_s": mesh["all_reduce_s"],
              "all_reduce_share_after_first": sum(mesh["all_reduce_s"][1:])
              / sum(mesh["step_s"][1:]),
              "peak_gib": {"plain": plain["peak_gib"],
                           "mesh": mesh["peak_gib"]},
              "wall_s": {k: runs[k]["wall_s"] for k in ("plain", "mesh")},
              "lock_wait_s": {k: runs[k]["recs"][0].get("lock_wait_s")
                              for k in ("plain", "mesh")},
              "launches": mesh["launches"], "card": ctx["card"]})
        summary = json.loads(
            (tmp / "eval" / "librimix_test_summary.json").read_text())
        results = json.loads((tmp / "eval" / "librimix_test.json").read_text())
        check(summary["number"] == MESH_EVAL_ITEMS == len(results)
              and all(math.isfinite(summary[k]) for k in
                      ("si_sdr", "pesq", "stoi")), f"evaluate {summary}")
        launches["mesh_evaluate_nccl"] = runs["evaluate"]["recs"][0][
            "launches"]
        check(launches["mesh_evaluate_nccl"]["fir_down2d"] == (
            -(-MESH_EVAL_ITEMS // 2) * 10 * LAUNCHES_PER_FORWARD),
            f"evaluate launches {launches['mesh_evaluate_nccl']}")
        emit({"phase": "mesh_evaluate", "what": "python -m torch.distributed"
              ".run --nproc-per-node 1 -m ditsep_tpu_torch.cli.evaluate "
              f"--mesh, diffsep_icassp seeded, {MESH_EVAL_ITEMS} item of 2 s,"
              " batch 2, N=5", "summary": summary,
              "process_s": runs["evaluate"]["recs"][0]["process_s"],
              "peak_gib": runs["evaluate"]["recs"][0]["peak_gib"],
              "launches": launches["mesh_evaluate_nccl"],
              "card": ctx["card"]})

    ctx["mesh_launches"] = launches
    emit({"phase": "mesh", "phase_total_s": time.perf_counter() - t_phase})


def kernels_line(ctx, torch) -> list:
    """The ``kernels`` line: every kernel of the port with its numbers
    from the phases that measured it (None where none ran) and its
    launches by path over the paths that ran. ``launches`` is the main
    path's (the separation CLI's; the training CLI's for fir_up2d), or the
    sum over the paths that ran when that path did not."""
    def by_path(kernel: str) -> dict:
        paths = {}
        if "main_path_launches" in ctx and kernel == "fir_down2d":
            paths["separate_cli"] = ctx["main_path_launches"]
        if "train_launches" in ctx and kernel == "fir_up2d":
            paths["train_cli_diffsep_icassp"] = ctx["train_launches"][kernel]
        if kernel == "fir_down2d":
            paths.update({f"evaluate_{k}": v for k, v
                          in ctx.get("eval_launches", {}).items()})
            if "longform_launches" in ctx:
                paths["longform_cli"] = ctx["longform_launches"]
            paths.update(ctx.get("families_launches", {}))
        paths.update({f"train_cli_{k}": v[kernel] for k, v
                      in ctx.get("families_train_launches", {}).items()})
        for k, v in ctx.get("latent_launches", {}).items():
            if isinstance(v, dict):
                paths[k] = v[kernel]
            elif kernel == "fir_down2d":
                paths[k] = v
        if kernel == "fir_down2d":
            if "ldm_cache_launches" in ctx:
                paths["ldm_cache_latents"] = ctx["ldm_cache_launches"]
            paths.update(ctx.get("serve_launches", {}))
        for key in ("media_launches", "mesh_launches", "slice_launches"):
            paths.update({k: v[kernel] for k, v in ctx.get(key, {}).items()})
        if "generation_launches" in ctx:
            paths["generation_full"] = ctx["generation_launches"][kernel]
        if "stable_launches" in ctx:
            paths["stable_lm_full"] = ctx["stable_launches"][kernel]
        paths.update({k: v[kernel] for k, v in
                      ctx.get("stable_train_launches", {}).items()})
        return paths

    def main_count(paths: dict, key: str) -> int:
        return paths[key] if key in paths else sum(paths.values())

    def numbers(t, err, ms="kernel_ms", prefix=""):
        """A byte-bound kernel's numbers from its phase's times ``t``."""
        if t is None:
            return {"max_abs_err": None, "ms": None, "plain_ms": None,
                    "bound_ms": None, "bound_by": "bytes",
                    "library_ms": None}
        return {"max_abs_err": err, "ms": t[ms],
                "plain_ms": t[f"{prefix}plain_ms"],
                "bound_ms": t[f"{prefix}bound_ms"], "bound_by": "bytes",
                "library_ms": t.get("library_ms")}

    kernels = []
    paths = by_path("fir_down2d")
    kernels.append({
        "name": "fir_down2d", "route": "cuda",
        "source": "ditsep_tpu_torch/csrc/fir_down2d.cu",
        "replaces": "ditsep_tpu/ops/pallas_kernels.py:148",
        "launches": main_count(paths, "separate_cli"),
        "launches_by_path": paths,
        **numbers(ctx["kernel_times"]["float32"] if "kernel_times" in ctx
                  else None, ctx.get("kernel_err", {}).get(torch.float32))})
    paths = by_path("fir_up2d")
    kernels.append({
        "name": "fir_up2d", "route": "cuda",
        "source": "ditsep_tpu_torch/csrc/fir_up2d.cu",
        # no TPU kernel: the JAX package differentiates this with XLA
        "replaces": "ditsep_tpu/ops/fir.py:45",
        "launches": main_count(paths, "train_cli_diffsep_icassp"),
        "launches_by_path": paths,
        **numbers(ctx["up"]["level0"]["float32"] if "up" in ctx else None,
                  ctx["up"]["err"][torch.float32] if "up" in ctx else None)})
    fba = ctx.get("fba")
    for name, line, key in (("fba_fwd", 82, "fwd"), ("fba_bwd", 109, "bwd")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ditsep_tpu_torch/csrc/fused_bias_act.cu",
            "replaces": f"ditsep_tpu/ops/pallas_kernels.py:{line}",
            "launches": fba["launches"][name] if fba else 0,
            **numbers(fba and fba["times"]["float32"],
                      fba and fba["err"][torch.float32], f"{key}_ms",
                      f"{key}_"),
            "library_ms": None})
    conv = ctx.get("conv")
    for name, line, row in (("conv3x3_9tap", 95, "cuda_9tap"),
                            ("conv3x3_async_halo", 208, "cuda_async_halo")):
        r = conv["rows"][row] if conv else None
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ditsep_tpu_torch/csrc/conv3x3.cu",
            "replaces": f"scripts/pallas_conv_probe.py:{line}",
            "launches": conv["launches"][name] if conv else 0,
            "max_abs_err": conv["err"] if conv else None,
            "ms": r and r["ms_per_conv"],
            "plain_ms": conv["plain"][row] if conv else None,
            "bound_ms": r and r["bound_ms"],
            "bound_by": r["bound_by"] if r else "operations",
            "library_ms": (conv["rows"]["cudnn_native"]["ms_per_conv"]
                           if conv else None)})
    return kernels


def share_bytecode_cache() -> None:
    """The run's processes (this one and every child) keep their compiled
    bytecode in one cache in the checkout (``build/pycache``): where the
    installed packages carry none that is valid, each new process would
    compile torch's 2,000 modules again (8.5 s of a mesh train child on
    the H100's machine, PERF.md section 6); so only the first does."""
    prefix = str(REPO / "build" / "pycache")
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", type=int, choices=sorted(GROUPS),
                    help="run one group of phases (each under 900 s on the "
                         "card); the default runs every phase")
    ap.add_argument("--phase", action="append", default=[],
                    choices=[n[len("phase_"):] for g in GROUPS.values()
                             for n in g],
                    help="run this phase (repeatable; a phase that reads "
                         "another's results needs it too)")
    args = ap.parse_args(argv)
    if args.phase:
        phases = [f"phase_{n}" for n in args.phase]
    elif args.group:
        phases = list(GROUPS[args.group])
    else:
        phases = [n for g in sorted(GROUPS) for n in GROUPS[g]]
    if (REPO / "ditsep_tpu_torch").is_dir():
        share_bytecode_cache()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "ditsep_tpu_torch").is_dir() or not CKPT.exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from ditsep_tpu_torch.utils.device import card_line, card_peaks
    card = card_line()
    print(card, flush=True)
    ctx = {"card": card, "bandwidth": card_peaks(card)[1]}
    build = build_all()
    ctx["ptxas"] = {k: v for k, v in build.items() if k != "build_s"}
    emit({"phase": "device", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build.pop("build_s"), "ptxas": build,
          "bandwidth_bytes_per_s": ctx["bandwidth"]})

    for name in phases:
        t0 = time.perf_counter()
        globals()[name](ctx)
        emit({"phase": name[len("phase_"):],
              "phase_s": time.perf_counter() - t0})
    emit({"kernels": kernels_line(ctx, torch)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
