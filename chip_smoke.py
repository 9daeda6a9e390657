#!/usr/bin/env python3
"""Chip smoke test of the torch port (friendly_stable_audio_tools_tpu_torch)
on one NVIDIA GPU: Stable Audio Open 1.0 text-to-audio and training, Stable
Audio 2.0 long-form text-to-audio and training (and its DiT past 8192
tokens), Stable Audio 1.0 text-to-audio (fp32 through the CLI, and in
bench.py's bf16 recipe) and training, audio-LM training and generation
(MusicGen small's widths), text-to-audio through the adaLN DiT (SAO
1.0's config with `global_cond_type: "adaLN"`), AE-GAN training of the
Stable Audio VAEs, and the diffusion trainer's options (pre-encoded
latents, logit-normal timesteps, rectified flow, padding masks, the inpaint
trainer, demos, the weight-norm fold, the profiler), and SAO 1.0's config with 12
heads of 128 (generation and training), at full width. The training
phases [6], [7], [6b] and [9] run the DiT at TRAIN_DEPTH (4) of its 24
layers and the LM generation phases [13b] and [13] the LM at LM_GEN_DEPTH
(3) of its 24, to stay well inside the script's time limit; widths, shapes
and each kernel's calls per layer are as the configs write them.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from csrc/ (timed);
3. each kernel K1-K4 against its plain PyTorch version on the card in bf16,
   at every shape the two generation paths give it (SAO 1.0's decode of
   2,097,152 samples, SA 2.0's of 12,582,912) plus small ragged shapes,
   with max-abs and rel-L2 errors against a stated tolerance, both times,
   the least time the card could take (bound) and one PyTorch library
   call's time where one computes the same function; K1 (its K10a launch
   included) per call beside its earlier row (`EARLIER_MS`); each K2 shape
   names the route `conv_route` gave it, and a wide one also times the thin
   route's kernel; each thin K2 shape (here, in [3c], [3f], [3h], [3i] and
   [3k]) prints beside the time of the thin route's kernel before its
   redesign, measured in the same turns as the redesigned one
   (`EARLIER_MS`), with its bound and cuDNN's time; each path's K2 and K4
   totals print beside the earlier
   ones (`EARLIER_CONV_MS`, `log_conv_path`), flagged where they drift more than
   CONV_DRIFT (5%) from it; each K3 shape (here, in [3c] and [3f]) names
   the route `ru_route` gave it and prints beside its WMMA kernel's time
   (`EARLIER_MS`) and the unfused library chain (cuDNN's k7 conv on the
   snaked input, then a cuBLAS GEMM; TF32 off in fp32), each path's K3
   total beside the earlier one (`EARLIER_RU_MS`, `log_ru_path`); the wide
   K2 and K4 at ragged shapes (B 2, T 333, 96 -> 96, dilation 9; B 2, T 77,
   192 -> 96, stride 8, both with a snake), K3 at B 2, T 333, C 128 and T
   77, C 1024 (the split route), dilation 9;
   3b. the training attention kernels K5 (forward with LSE) and K6
   (backward) against their plain versions at the training shape (B 8,
   T 1040, kv_len 1025, 24 heads) and three smaller ones; K6 twice on the
   same inputs (its dq sums through reduce-adds in a varying order: the two
   runs within rel-L2 K6_RUN_TO_RUN); each per call beside its earlier row;
   3c. K2 and K3 at the frozen encoder's shapes, SAO 1.0's and SA 2.0's
   sample sizes (the encode runs one clip at a time, `iterate_batch`);
   3d. the long-sequence attention kernels K10a (rope K once) and K10
   against their plain versions at SA 2.0's shape (B 2, T 6272, kv_len 6145,
   24 heads) and three smaller ragged ones, each beside its earlier row
   (K10a by its device time under torch.profiler, beside its kernel's
   before its redesign, timed in the same turns as the redesigned one);
   3e. the fp32 training attention kernels K7 (forward with LSE) and K9
   (the backward, 3xTF32 on the tensor cores) against their plain versions at
   SA 2.0's training shape (B 8 x 24 heads, T 6272, kv_len 6145) and two
   smaller ragged ones, K7 and K9 beside their earlier FFMA rows, SDPA and
   its backward;
   3f. the fp32 kernels against their fp32 plain versions (TF32 off): K2,
   K3 and K4 at every shape of [3] and [3c]; K2 and K4 at the DAC decode's
   shapes at 4096 latent frames (26 and 4 calls); K2 at the DAC encode's
   shapes at 4,194,304 samples (26 calls per clip, 8 clips per SA 1.0
   training step); K7 without its LSE at the ADP U-Net's self-attention
   (B 2 x 16 heads: T 4096 and 2048 at head dim 64, T 1024 at head dim 80),
   beside its earlier FFMA rows;
   3h. the causal K7 with and without its LSE and the causal K9 against
   their plain versions in fp32 at the audio LM's shape (B 8 x 16 heads, T
   1501, D 64) and at T 1100, with bounds counted on the causal triangle and
   SDPA's causal fp32 times, the causal K7 and K9 beside their earlier FFMA
   rows; the fp32 K2 at the LM's SEANet encode shapes
   (B 8 x 960,000 samples, 10 calls per training step);
   3i. the fused SwiGLU MLP K13 against its plain version through the
   route `mlp.route` names: the streaming route in fp32 at the audio LM's
   decode (M 2, K 1024, inner 4096, Kout 1024: 24 calls per decode step)
   and at M 16 (rel-L2 1e-5); the tensor-core route at SAO's DiT (K 1536,
   inner 6144, Kout 1536) in bf16 at M 2050 (the generation's CFG batch 2
   x 1025 tokens) and 2080 (the training pad; one bf16 rounding) and in
   fp32 at M 2080; each with its plan, bound, the unfused cuBLAS chain's
   time and the earlier CUDA-core K13's figures, the tensor-core route's time split into the
   fp32 weights' tf32 parts, GEMM1 and GEMM2; the fp32 K2 and K4 at every
   shape of the LM's SEANet token decode (1500 frames to 959,992 samples:
   10 and 3 calls);
   3j. the adaLN elementwise kernels K11 (LayerNorm + modulate) and K12
   (gated residual) against their plain chains (one bf16 rounding) and
   against the Pallas kernels' own arithmetic, in bf16 at the adaLN DiT's
   shape (B 2, T 1024, D 1536: 48 calls of each per denoising step), K11
   also without gamma, and at a ragged [3, 777, 1536], timed as CUDA-graph
   replays;
   3g. the fp32 single-pass backward K8 against its plain version at the
   ADP U-Net's training shapes (B 8 x 16 heads: T 4096 and 2048 at head dim
   64, T 1024 at head dim 80), at a DiT shape where K8's plan fits (B 2 x 24
   heads, T 1184, kv_len 1177) and a small ragged one; K7 with its LSE at
   the three U-Net shapes; each beside its earlier FFMA row;
   3k. K7 in bf16 (serving, csrc/flash_attention_bf16.cu) against its plain
   version at the ADP U-Net's self-attention in bench.py's bf16 recipe (B 2
   x 16 heads: T 4096 and 2048 at head dim 64, T 1024 at head dim 80), at a
   ragged T 300 with kv_len 290, and at SA 2.0's DiT past 8192 tokens (B 2 x
   24 heads, T 8576, kv_len 8449; the fp32 K7 there too), with SDPA's bf16
   time, each bf16 shape's ratio to it beside the earlier kernel's time
   (`EARLIER_BF16_K7_MS`) and the device kernel that ran (its head dim's
   route); the bf16 K2 and K4 at every shape of the DAC decode (26 and 4
   calls, K4 at Cout 768, 384, 192 and 96);
4. the Oobleck VAE in fp32 (an encode of 2 x 2,097,152 samples and a short
   decode) with the fp32 kernels against the fp32 plain versions; then, in
   bench.py's bf16 recipe, one DiT forward (CFG batch-doubled) and the short
   decode with the kernels and with the plain versions, and the bf16 encode
   with the kernels against the fp32 encode with the plain versions;
   4b. one SA 2.0 DiT forward at 6144 latent frames with CFG (B 2, T 6272)
   with the kernels, with the plain versions in bf16, and as an fp32 copy;
5. the generation path: `create_model_from_config(stable_audio_open_1_0.json)`
   with random weights (seed 0, de-zeroed), DiT and VAE in bench.py's bf16
   recipe, then
   `generate_diffusion_cond` for one prompt, 100 dpmpp-3m-sde steps, CFG 7,
   2,097,152 stereo samples; output shape, finiteness and RMS are checked,
   and the kernels' launch counts show that the path ran through them (K1
   2400 and K10a 2400: K1 reads k roped once per call); then
   `profile_generation.profile_backbone` on one CFG step of the same model
   (device-busy share, K1's share of the device time);
   5b. the same model with `fused_mlp` set on its DiT's FeedForwards: one
   DiT forward against the one without it and, with the kernels (K13
   included) against the fp32 DiT, within DIT_ERR_RATIO of the plain bf16
   error; the 100-step generation (K13 2400 on its tensor-core route, the
   other counts as in [5]) and one profiled CFG step (K13's share); both
   generations' s-audio/s and both steps' device times side by side;
16. (after 5b, on the same model) init-audio generation and the other
   samplers: a variation of [5]'s clip (`init_audio`, `init_noise_level`
   1.0, 100 dpmpp-3m-sde steps, CFG 7), an inpainting with outpainting's
   cut and paste (`mask_args`, 100 steps), one pass of each other sampler
   from noise (INIT_SAMPLER_STEPS steps; k-dpm-adaptive until its
   controller reaches sigma_min or 200 iterations); each with the walls
   (the encode's too), peak memory and exact launch counts (the frozen
   bf16 encode's K2 by route and K3 15 on top of the decode's; K1 = K10a =
   24 x the model evaluations the step hook counted); then an
   INIT_CHECK_STEPS-step inpainting with the kernels and with the plain
   versions in bf16, each against an fp32 copy with the plain versions, its
   audio and its latents: the kernels' rel-L2 within DIT_ERR_RATIO of the
   plain bf16 one;
6. one training step of the fp32 DiT at batch 8 with the attention kernels,
   with their plain versions in bf16, and with fp32 plain attention as the
   reference: loss and weight gradients of layers 0, 11 and 23;
   6b. one training step of SA 2.0's fp32 DiT at batch 8 and 6144 latent
   frames (T 6272, kv_len 6145) with the attention through K7/K9, through
   their plain versions in fp32 (the reference), and through the bf16 K5/K6
   route forced (the route the port took before it routed as the JAX
   package does): loss and weight gradients of layers 0, 11 and 23;
7. the training path: `python -m friendly_stable_audio_tools_tpu_torch.train`'s
   `main` on the SAO config from 8 synthetic 50 s WAVs, batch 8, 4 steps
   with a checkpoint at step 4, then a resume for a fifth step; step time,
   throughput, memory and split, finite losses, moved weights, the EMA, and
   the kernels' launch counts as the code implies them (the frozen encode in
   fp32, through the fp32 K2/K3);
8. the long-form path: `create_model_from_config(stable_audio_2_0.json)`
   (CLAP text conditioner, random weights, hash tokenizer), DiT and VAE in
   bench.py's bf16 recipe, `generate_diffusion_cond` for one 285 s prompt, 100 dpmpp-3m-sde
   steps, CFG 7, 12,582,912 stereo samples; output checks, walls (CLAP,
   denoise per step, decode), peak memory, and the launch counts;
9. the long-form training path: `train.main` on the SA 2.0 config from 4
   synthetic 290 s WAVs, batch 8, 3 steps: step time, trained audio per
   second, the split, peak memory, finite losses, moved weights and the
   launch counts (K7/K9 and the fp32 encoder's K2/K3, no K5/K6);
15b. (before 4b, on the same model) one forward of SA 2.0's DiT at 8448
   latent frames (392.3 s; 8449 tokens padded to 8576) with CFG, full width
   and depth: fp32 with the kernels against the plain versions (the split
   route's K7 with kv_len, 24 launches), then in bench.py's bf16 recipe with
   the kernels and the plain versions against the fp32 forward (24 bf16 K7
   launches);
4c. one forward of Stable Audio 1.0's fp32 ADP U-Net at 4096 latent frames
   with CFG, with the kernels (K7 at T 4096, 2048, 1024) and with the plain
   versions (random weights, de-zeroed);
4d. the same forward in bench.py's bf16 recipe (the U-Net's weights in
   bf16, its input cast at entry): with the kernels (14 bf16 K7 launches,
   nothing else) and the plain versions, each against 4c's fp32 output;
15. the SA 1.0 path in bench.py's bf16 recipe: `generate_diffusion_cond` on
   the same model, one prompt, 100 dpmpp-3m-sde steps, CFG 7, 4,194,304
   samples, the DAC decoding in bf16: audio checks, walls, s-audio/s beside
   [10]'s fp32 figure from the same run, peak memory, and the launch counts
   (bf16 K7 1400, bf16 K2 26 (25 wide, 1 thin) and K4 4, nothing else);
10. the SA 1.0 path: the generate CLI (`generate.main`) on
   stable_audio_1_0.json as written (CLAP text and two int conditioners,
   ADP U-Net, DAC VAE; random weights, seed 0; hash tokenizer), one prompt,
   100 dpmpp-3m-sde steps, CFG 7, the model's own fp32, one WAV under
   build/: audio checks, walls (conditioners, denoise per step, decode),
   s-audio/s over 95.1 s of audio, peak memory, and the launch counts (K7
   1400, fp32 K2 26 (25 wide, 1 thin) and K4 4, nothing else);
   10b. the repaired dtype: the generate CLI on stable_audio_open_1_0.json
   in fp32 (K1 on a bf16 cast of the fp32 qkv, the fp32 K2/K3/K4 decode);
11b. one training step of SA 1.0's fp32 U-Net at batch 8 and 4096 latent
   frames (fixed draws, CFG dropout with one row dropped) with the gated
   self-attention through K7 (with its LSE) and K8, through their plain
   versions (the reference: loss within 1e-5, all gradients within rel-L2
   1e-4), and through the serving route the port took under grad before
   (K7 without its LSE: the q/k/v gradients of the 14 gated attentions are
   lost);
11. the SA 1.0 training path: `train.main` on stable_audio_1_0.json as
   written (CFG dropout 0.1, Adam at 5e-4, EMA) from 2 synthetic 96 s WAVs,
   batch 8, 3 steps: step time, trained audio per second, the split, peak
   memory, finite losses, moved weights and the launch counts (K7 with its
   LSE 14 and K8 14 per step, the DAC encoder's fp32 K2 26 per clip (25 wide),
   nothing else);
12b. one training step of the audio LM (musicgen_small_32khz.json: 24
   causal layers 1024 wide, 16 heads of 64; random weights, de-zeroed) at
   batch 8 on 30 s of audio (1500 frames, T 1501 with the delay pattern),
   fixed CFG-dropout draws: the causal self-attention through the causal K7
   with its LSE and the causal K9 against their plain versions (loss within
   1e-5, all gradients within rel-L2 1e-4), and one no-grad forward through
   the causal K7 without its LSE; launches asserted (tokenize: fp32 K2 10;
   step: causal K7 24, causal K9 24; forward: causal K7 without LSE 24);
12. the audio-LM training path: `train.main` on musicgen_small_32khz.json
   as written (T5-base, CFG dropout 0.1, AdamW 1e-4) from 8 synthetic 31 s
   mono 32 kHz WAVs, batch 8, 3 steps: step time, trained audio and tokens
   per second, the split (tokenize, T5, LM forward + backward, AdamW), peak
   memory, finite losses, moved weights and the launch counts (causal K7 24,
   causal K9 24, fp32 K2 10 per step, nothing else);
13b. the audio LM's static-KV-cache decode at full width
   (musicgen_small_32khz.json, random de-zeroed weights): a prefill and 63
   single-token steps of fixed tokens at CFG batch 2 through the
   generation's 1504-step cache, the fused MLP off and on: every step's
   logits within rel-L2 1e-5, K13 one launch per layer and call on and none
   off, no other kernel; a profiled window of 16 steps each (device busy share);
13. the audio-LM generation path: `generate_audio` on the same model, one
   prompt, 1500 frames (1 prefill and 1503 decode steps of the delay
   pattern), CFG 3, top_k 250, temperature 1, fp32, with the fused MLP off
   and then on (`create_model_from_config(..., fused_mlp=True)`): walls (T5,
   prefill, decode loop and per step, token decode, total), s-audio/s, peak
   memory; codes in [0, 2048), finite audio of the decoder's 959,992
   samples, and the launch counts (K13 one per layer and decode_step call
   on: 9,024 at 6 layers, 0 off; fp32 K2 10 and K4 3; nothing else);
14b. one forward and backward of the full-width bf16 adaLN DiT (1.39 B
   parameters, `to_scale_shift_gate` de-zeroed like every weight) at CFG
   batch 2 and 1024 latent frames, with `fused_ew` on, off, and as an fp32
   copy with the plain versions: K11 and K12 48 launches each on and none
   off, every gradient finite, the output and all gradients with the
   kernels within 1.5x the plain bf16 error against the fp32 copy;
14. the adaLN generation path: `create_model_from_config(..., fused_ew=True)`
   on the adaLN config, bench.py's bf16 recipe, `generate_diffusion_cond`
   for one prompt (100 dpmpp-3m-sde steps, CFG 7, 2,097,152 stereo
   samples), then again with `fused_ew` off on the same noise: walls,
   s-audio/s, peak memory, the audio's rel-L2 between the two, and the
   launch counts (K11 and K12 4,800 each on, 0 off); then the wall of one
   DiT call (a denoising step's) on and off in turns and a profiled window
   of each (device busy share, K11 + K12's device time).
17. AE-GAN training of Stable Audio 2.0's Oobleck VAE as written (random
   weights, fp32, batch 8 x 65536 stereo): K2 (thin-in, thin-out, wide),
   K3 (C 128 and C 1024) and K4 (2048 -> 1024, stride 8) under grad, their
   autograd Functions against the plain versions' autograd (output and
   every input's gradient within AE_GRAD_RTOL, forward + backward timed),
   and under torch.no_grad() nothing kept beyond the output; every shipped
   autoencoder config and its AE-GAN wrapper built on the card; one
   generator step with the kernels against the plain versions (losses and
   gradients, AE_STEP_RTOL) and its device time split by torch.profiler
   (the autoencoder's forward, the discriminator and the losses, the plain
   backward); AE_STEPS steps through the train CLI from synthetic WAVs
   (generator and discriminator in turn: every loss finite, every trained
   gradient finite and nonzero, the EMA moving on generator steps only, K3
   30, K4 5, K2 thin 2 and wide 2 per step), a resume from the step-2
   checkpoint and the export; one generator and one discriminator step of
   Stable Audio 1.0's DAC VAE and the DAC 2048/32 VAE (the SEANet + RVQ
   tokenizer is built only: its decoded length differs from the input's);
   the reconstruct CLI on a 10 s stereo WAV
   (the output as long as the input, finite, one forward's launches per
   chunk).

18. the diffusion trainer's options on SAO 1.0's fp32 DiT at full width and
   OPTIONS_DEPTH (8) of its 24 layers (all 24 until [19f] and [19g] came;
   batch 8, 1024 latent frames, fixed draws, TF32 off): a
   pre-encoded step (no encode: no K2/K3 launch), a logit-normal step, a
   rectified-flow step, a `mask_padding` step (the self-attention masked:
   the plain route, no attention kernel, as in the JAX package) and the
   inpaint variant's step (`diffusion_cond_inpaint`, input_concat_dim 65,
   built in memory), each with exact launch counts (per layer K5 2, K6 1,
   K10a 4 on the mask-free steps) and held against the plain versions as [6]
   holds its step (the masked one against every plain version in fp32);
   whole train steps from pre-encoded latents and from raw audio, timed;
   the VAE's weight norm folded (its encode within FP32_MODEL_RTOL of the
   unfolded one, still through K2/K3); then 2 steps of the train CLI
   (TRAIN_DEPTH layers) with a demo at step 2 (DEMO_STEPS steps,
   DEMO_CFG_SCALES; its wavs and its K1/K10a/K2-K4 launches),
   `--remove-pretransform-weight-norm post_load` and `--profile-dir` (a
   trace written), exact launch counts.
19. Dance Diffusion and the other diffusion model types, after [3l] (the
   fp32 K7 at head dim 32 against its plain version and SDPA at B1 x 16
   heads, T 8192 / 4096 / 2048 / 1024, and with its LSE at T 8192):
   [19a] each shipped dance_diffusion/*.json built on the card (one U-Net
   forward each), then dance_diffusion_base_44k.json as written (223.2 M,
   fp32, seed 0) through generate_diffusion_uncond at 65,536 samples, batch 4, 100
   dpmpp-3m-sde steps (no launch: its attention is plain there); [19b] one
   U-Net forward at 2,097,152 samples with the kernels against the plain
   versions (FP32_MODEL_RTOL, 24 K7 launches), then DD_LONG_STEPS steps;
   [19c] the train CLI on the config at batch 8 (3 steps, the demo at
   DEMO_STEPS, a checkpoint and a resume); [19d] a diffusion autoencoder
   (SA 2.0's VAE encoder and bottleneck, a dance_diffusion_base DAU1d
   decoder, ratio 2048): a train step at batch 2 x 65,536 (fp32 K2 2, K3
   15 under grad) and a 100-step DDIM decode; [19e] a mono-to-stereo prior
   on the same U-Net: a train step and a `stereoize` at PRIOR_STEPS; each
   with exact launch counts, walls and peak memory. After [3m] (K8 and K9
   at head dim 32 against their plain versions and SDPA's backward: K8 at
   BH 32 T 1024 and BH 16 T 2048 / 4096, K9 at BH 16 T 8192, each also
   with kv_len < T; FlashAttention against the plain autograd), the
   config trains past 131,072 samples: [19f] the train CLI on a copy of
   dance_diffusion_base_44k.json with only sample_size changed, at 2 x
   262,144 (6 K7 and 6 K8 at D 32 per step: T 1024) and 1 x 524,288 (12
   and 12: T 2048 and 1024), 3 steps each (times, trained s-audio/s, peak
   memory, exact counts), one 2 x 262,144 step with the kernels against
   the plain versions, and the U-Net's inner levels 9-14 under grad at the
   shapes of a 2,097,152-sample step (K9 at T 8192: 6; K8 18; K7 24; the
   outer levels' fp32 convs would need ~160 GB without remat); [19g] one
   step each of the prior and the diffusion autoencoder at 2 x 262,144.
20. SAO 1.0's config with 12 heads of 128 (`num_heads` 12, nothing else
   changed; T 1025, unpadded), after [3n] (the rope-fused K7 in bf16 and
   fp32 against its plain version at B 2 x 12 heads, T 2048 and a ragged 3
   heads of 64, the tables and k^ of its rope pass bit for bit against the
   plain version's, with its device time split by activity and the call's
   idle share; the fp32 K7 with
   and without its LSE and K8 at head dim 128 at B 8 x 12 heads and a
   ragged shape; SDPA and its backward beside them): [20] at full width and
   depth, a DiT forward with the kernels against the plain versions in fp32
   (FP32_MODEL_RTOL), generate_diffusion_cond at 100 steps in fp32, then in
   bench.py's bf16 recipe after [5]'s DiT rule (2400 rope-fused K7 launches
   each, no K1, K10a, K5 or K6); [20b] at TRAIN_DEPTH layers, a DiT step at
   batch 8 through the fp32 K7 with its LSE and K8 at head dim 128 against
   their plain versions ([6b]'s tolerances), then H128_TRAIN_STEPS steps of
   the train CLI on the config written to a file (K7 twice per layer and
   step, the checkpointed recompute, K8 once).

[5], [7], [8] and [14] also print their earlier end-to-end figures
(`EARLIER_E2E`) beside this run's, with the card's name and power limit.

Output: progress lines with each phase's wall, then one JSON line of
per-kernel results (the fp32 K2/K3/K4 and the serving K7 as entries of
their own, `*_f32` and `flash_forward_serving`; K2's wide route, the
wgmma kernel of conv_wgmma.cu, as `snake_conv1d_wide` and
`snake_conv1d_wide_f32`, its thin route as `snake_conv1d` and
`snake_conv1d_f32`; the bf16 K7 as
`flash_forward_bf16`; K13's streaming route as `glu_mlp`, its
times per decode step, its tensor-core route as `glu_mlp_tensor`, its
times per SAO CFG step with `fused_mlp`; K11 and K12 as `ln_modulate` and `gated_residual`,
their times per adaLN denoising step; the fp32 K7 at head dim 32 as
`flash_forward_d32`, its times per Dance Diffusion U-Net forward at
2,097,152 samples; K8 and K9 at head dim 32 as `flash_backward_fused_d32`
and `flash_backward_d32`, their times per Dance Diffusion training step at
2 x 262,144 and at 2,097,152 samples; the rope-fused K7 as
`flash_rope_attention`, its times per heads-128 DiT forward in bf16 and,
as `fp32_ms`, in fp32; the fp32 K7 and K8 at head dim 128 as
`flash_forward_d128` and `flash_backward_fused_d128`, their times per
heads-128 training step at 24 layers), the nvidia-smi line, and
as the last line `{"ok": true, "device": {...}}`. `import chip_smoke;
chip_smoke.flash_serving_phase(chip_smoke.new_results())` runs [3f]'s K7
part alone (likewise `dac_conv_phase`, `dac_encode_conv_phase(results,
json.loads(SA1_CONFIG.read_text()))`, or `decode_conv_phase(results,
torch.float32, {"sa2": "sa2_decode_ms", "sao": "sao_decode_ms"})`) after
the build.
Without a CUDA device the script exits with 2 and prints no result.
"""

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
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio"
SAO_CONFIG = CONFIGS / "stable_audio_open_1_0.json"
SA2_CONFIG = CONFIGS / "stable_audio_2_0.json"
SA1_CONFIG = CONFIGS / "stable_audio_1_0.json"
STEPS = 100
CFG_SCALE = 7.0
SAMPLE_SIZE = 2_097_152
PROMPT = {"prompt": "Amen break 174 BPM", "seconds_start": 0, "seconds_total": 47}
SA2_SAMPLE_SIZE = 12_582_912  # 6144 latent frames, 285.3 s at 44.1 kHz
SA2_PROMPT = {"prompt": "A grand orchestral arrangement with thunderous percussion",
              "seconds_start": 0, "seconds_total": 285}
# SA 2.0's self-attention: 6144 latent frames + 1 prepended token, padded to
# the 128-multiple 6272 at CFG batch 2 (models/transformer.py:seq_pad_length)
LONG_T, LONG_KV = 6272, 6145
# Stable Audio 1.0: 4096 latent frames of the DAC VAE (downsampling 1024), 95.1 s
SA1_SAMPLE_SIZE = 4_194_304
SA1_PROMPT = {"prompt": "A cool 80s glam rock song with driving drums and distorted guitars",
              "seconds_start": 0, "seconds_total": 95}
# SA 2.0 past the long route ([15b]): 8448 latent frames (392.3 s) + 1
# prepended token, padded to 8576 at CFG batch 2: the split route, K7 with kv_len
SA2_XL_SAMPLE_SIZE = 17_301_504
SA2_XL_T, SA2_XL_KV = 8576, 8449
SA2_XL_PROMPT = {"prompt": "A slow ambient soundscape with evolving pads and distant bells",
                 "seconds_start": 0, "seconds_total": 392}
# SAO 1.0's config with 12 heads of 128 ([3n], [20], [20b]): the DiT's 1536
# width in heads of 128 (rotary dim 64), T 1025 (1024 latent frames and the
# prepended global token; the padding rule's 128-multiple would add 12%,
# above its 4%, so the sequence runs unpadded at every batch); the train CLI
# there takes H128_TRAIN_STEPS steps from H128_WAVS WAVs
H128_HEADS, H128_T = 12, 1025
H128_TRAIN_STEPS = 3
H128_WAVS = 2
DEVICE = "cuda"
TRAIN_BATCH = 8
TRAIN_STEPS = 4
N_WAVS = 8
WAV_SECONDS = 50
# the DiT's self-attention at training batch 8: 1024 latent frames + 1
# prepended token, padded to 1040 (models/transformer.py:seq_pad_length)
TRAIN_T, TRAIN_KV = 1040, 1025
# SA 2.0 training (phase 9): 2 WAVs of 290 s (longer than the 285.3 s crop,
# so no clip is padded; the loader samples a batch of 8 from them with
# replacement: their synthesis took ~25 s of the run at 8, ~3 s each), 3 steps
SA2_WAVS = 2
SA2_WAV_SECONDS = 290
SA2_TRAIN_STEPS = 3
# the ADP U-Net's flash-gated self-attention at 4096 latent frames, 16 heads:
# (T, head dim, calls per U-Net call); SA 1.0 training (phases 11b, 11):
# batch 8 sampled with replacement from 2 WAVs of 96 s (longer than the
# 95.1 s crop), 3 steps
SA1_ATTENTION = [(SA1_SAMPLE_SIZE // 1024, 64, 2), (SA1_SAMPLE_SIZE // 2048, 64, 6),
                 (SA1_SAMPLE_SIZE // 4096, 80, 6)]
SA1_WAVS = 2
SA1_WAV_SECONDS = 96
SA1_TRAIN_STEPS = 3
# the audio LM (phases 3h, 12b, 12): MusicGen small's widths, 30 s of 32 kHz
# mono = 1500 frames of the EnCodec-style tokenizer, 1501 steps of the delay
# pattern (its valid steps); 16 heads of 64, 24 causal layers
LM_CONFIG = REPO / "friendly_stable_audio_tools_tpu_torch/configs/lm/musicgen_small_32khz.json"
LM_T, LM_HEADS, LM_LAYERS = 1501, 16, 24
LM_WAVS = 8
LM_WAV_SECONDS = 31
LM_TRAIN_STEPS = 3
# depth cuts, so that the script stays well inside its time limit: the
# training phases ([6], [7], [6b], [9]) run the DiT at TRAIN_DEPTH of its 24
# layers and the LM generation phases ([13b], [13]) the LM at LM_GEN_DEPTH
# of its 24; widths, shapes and every kernel's calls per layer are as
# written (`at_depth`)
TRAIN_DEPTH = 4
# [18a] runs the trainer's options on the DiT at OPTIONS_DEPTH of its 24
# layers (all 24 until [19f] and [19g] came and the run needed the time)
OPTIONS_DEPTH = 8
LM_GEN_DEPTH = 3
# init-audio generation ([16]): the outpainting of [5]'s clip (percent of
# the clip: its first half pasted over the middle, kept there with soft
# edges), the other samplers' steps, and the inpainting held against the
# plain versions
INIT_MASK_ARGS = {"cropfrom": 0, "pastefrom": 25, "pasteto": 75, "maskstart": 25, "maskend": 75,
                  "softnessL": 5, "softnessR": 5, "marination": 0}
INIT_SAMPLER_STEPS = 8
INIT_CHECK_STEPS = 8
# the diffusion trainer's options ([18]): the train CLI's demo at
# DEMO_STEPS sampler steps (the config's 250 cut) and two cfg scales
DEMO_STEPS = 8
DEMO_CFG_SCALES = [3, 9]
# its option steps with the bf16 pair kernels against fp32 attention: the
# loss, one scalar, moves by ~1e-4 of itself either way (the plain bf16
# versions too: 1.2e-4 on an H100 at SAO's shapes)
OPTION_LOSS_RTOL = 1e-3
# the train CLI's 2 steps there sample their batches of 8 from 2 WAVs
OPTION_WAVS = 2
# the adaLN DiT (phases 3j, 14b, 14): SAO 1.0's DiT with global_cond_type
# "adaLN", 1024 latent frames (nothing prepended), 1536 wide, 24 layers, two
# K11 and two K12 calls per layer and forward
ADALN_T, ADALN_DIM, ADALN_LAYERS = 1024, 1536, 24
# AE-GAN training ([17]): Stable Audio 2.0's Oobleck VAE as written (batch
# 8 x its 65536-sample crop, stereo, fp32) through the train CLI from 8
# synthetic 3 s WAVs, AE_STEPS steps (generator and discriminator in
# turn), a checkpoint every 2; one generator and one discriminator step of
# Stable Audio 1.0's DAC VAE; the reconstruct CLI on a 10 s WAV
AE_CONFIGS = REPO / "friendly_stable_audio_tools_tpu/configs/model_configs/autoencoders"
AE_CONFIG = AE_CONFIGS / "stable_audio_2_0_vae.json"
# the other shipped autoencoders, one generator and one discriminator step
# each: Stable Audio 1.0's DAC VAE, the DAC 2048/32 VAE (mono, no EMA); the
# SEANet + RVQ tokenizer (encodec_musicgen_rvq.json) is only built: its
# decoder returns 640 T - 8 samples, which the AE-GAN losses refuse in both
# packages (ROADMAP queue C)
AE_OTHER_CONFIGS = [AE_CONFIGS / name for name in (
    "stable_audio_1_0_vae.json", "dac_2048_32_vae.json")]
AE_STEPS = 4
AE_WAVS = 8
AE_WAV_SECONDS = 3
RECON_SECONDS = 10
# K2-K4 under grad (kernel forward, plain backward) against the plain
# version's autograd, fp32: rel-L2 of the output and each input's gradient
# (the 3xTF32 forwards sit at <= 2.3e-6)
AE_GRAD_RTOL = 1e-5
# a whole generator step with the kernels against the plain versions (same
# weights, reals and VAE noise): the losses' relative difference, and the
# rel-L2 of the autoencoder's gradient as a whole, each parameter's error
# held to that bound times the whole's norm (a weight-normed v's gradient
# is its weight's less the projection on it, and may cancel: the plain
# versions against themselves on reals perturbed by 2^-20 show the scale)
AE_STEP_RTOL = (1e-5, 1e-4)
# the port's conv kernels by device name (csrc/conv1d.cu, conv_wgmma.cu,
# residual_unit.cu), for the profiled split of a generator step
PORT_CONV_KERNELS = ("thin_cores_kernel", "thin_out_kernel", "thin_in_kernel",
                     "conv_taps_kernel", "conv_weights_kernel", "ru_fused_kernel",
                     "ru_conv_kernel", "ru_gemm_kernel", "ru_snake_kernel")

# tolerances of the kernel-vs-plain compares (bf16 in and out; both sides
# accumulate in fp32 and round the result once, in different orders):
#   rel-L2 of the difference, and max abs difference as a fraction of max|plain|
TOL = {
    # online (per 64-key tile) vs one-shot softmax: P is rounded to bf16
    # against different running maxima, ~2^-9 relative per probability
    "fused_qkv_rope_attention": (1e-2, 2.0 ** -5),
    # one bf16 rounding of the output: at most ~1 ulp (2^-7 relative) apart
    "snake_conv1d": (2e-3, 2.0 ** -6),
    "fused_residual_unit": (2e-3, 2.0 ** -6),
    "snake_conv_transpose1d": (2e-3, 2.0 ** -6),
    # K5 and K1 are one kernel; the LSE differs only by fp32 sum order (max abs 2e-3)
    "fused_qkv_rope_attention_stats": (1e-2, 2.0 ** -5),
    # K6 against the same formula on the same inputs: both round p and ds to
    # bf16 and accumulate in fp32, in different orders
    "fused_qkv_rope_attention_backward": (1e-2, 2.0 ** -5),
    # K10a: both rope in fp32 and round once to bf16; fp32 rounding order may
    # move a result across a bf16 rounding boundary (one ulp, 2^-8 relative)
    "rope_pair_k": (2e-3, 2.0 ** -6),
    # K10: K1's online softmax against a whole-sequence one
    "pair_long_attention": (1e-2, 2.0 ** -5),
    # K7 and K9 in fp32 against the same formulas in fp32 (TF32 off): only
    # the summation order, the online softmax's rescaling and the 3xTF32
    # products (~1-2e-6 rel-L2) differ; 1xTF32 products keep ~3 decimal
    # digits and would fail them
    "flash_forward": (1e-5, 1e-4),
    "flash_backward": (1e-4, 1e-3),
    # K8 the same way (3xTF32): dq's parts from the key blocks arrive through
    # bulk reduce-adds in an order that changes from run to run, which is a
    # summation order too
    "flash_backward_fused": (1e-5, 1e-4),
    # the fp32 kernels against their fp32 plain versions (TF32 off): K7
    # without its LSE (3xTF32, each key tile's P.V added in fp32), K2 (thin
    # route: FFMA), K3 and K4 (3xTF32, each tensor-core partial sum added
    # into an fp32 total every F32_FLUSH stages): summation order only
    "flash_forward_serving": (1e-5, 1e-4),
    "snake_conv1d_f32": (1e-5, 1e-4),
    "fused_residual_unit_f32": (1e-5, 1e-4),
    "snake_conv_transpose1d_f32": (1e-5, 1e-4),
    # bf16 K7 against its plain version: both round q' and P to bf16; the
    # kernel rounds P per 64-key tile against a running max, the plain
    # version once against the row max (as K1 against its plain version)
    "flash_forward_bf16": (1e-2, 2.0 ** -5),
    # the causal K7 (with and without its LSE) and K9 the same way: fp32
    # both sides, summation order and the online softmax's rescaling only
    "flash_forward_causal": (1e-5, 1e-4),
    "flash_forward_causal_serving": (1e-5, 1e-4),
    "flash_forward_d32": (1e-5, 1e-4),
    "flash_backward_fused_d32": (1e-5, 1e-4),
    "flash_backward_d32": (1e-5, 1e-4),
    "flash_backward_causal": (1e-4, 1e-3),
    # the rope-fused K7 against its plain version: both round the roped q
    # and k to bf16 (an fp32 rounding difference before that rounding may
    # move one element by a bf16 step); bf16 as the bf16 K7 (P rounded per
    # 64-key tile against a running max, the plain version once); fp32 up to
    # those steps, summation order otherwise
    "flash_rope_attention": (1e-2, 2.0 ** -5),
    "flash_rope_attention_f32": (1e-4, 1e-3),
    # the fp32 K7 and K8 at head dim 128: summation order only, as at 64
    "flash_forward_d128": (1e-5, 1e-4),
    "flash_backward_fused_d128": (1e-5, 1e-4),
    # K13 against its plain version at the same rounding points: fp32 both
    # sides (summation order only); bf16 one rounding of the output apart,
    # with v, g and h at most one bf16 step apart where the fp32 sums differ
    "glu_mlp": (1e-5, 1e-4),
    "glu_mlp_bf16": (2e-3, 2.0 ** -6),
    # K11 and K12 against the plain chains: one bf16 rounding of the output
    # apart (rel-L2 2^-8: K12's chain rounds 1 - gate and the sigmoid to
    # bf16, the kernel neither, so ~15% of outputs land one step apart)
    "ln_modulate": (4e-3, 2.0 ** -6),
    "gated_residual": (4e-3, 2.0 ** -6),
    # and against the Pallas kernels' own arithmetic: fp32 sums in another
    # order may move a result across one bf16 rounding boundary
    "ln_modulate_kernel_math": (1e-3, 2.0 ** -7),
    "gated_residual_kernel_math": (1e-3, 2.0 ** -7),
}
# the card's published peaks (H100 SXM, dense), for the bound: the larger of
# the products' operations at the bf16 tensor-core rate and the bytes each
# input read once and each output written once take at the memory rate
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the fastest fp32-accurate product rate of the card, for the bound of the
# fp32 kernels: 3xTF32 on the tensor cores (495 TFLOP/s of TF32, three
# passes); the CUDA cores' fp32 FMA peak is 66.9 TFLOP/s
PEAK_FP32_ACCURATE = 495e12 / 3
PEAK_FP32_CORES = 66.9e12
LSE_ATOL = 2e-3
# K6 against itself on the same inputs: dq's key-block partials are summed
# by reduce-adds in whatever order the blocks finish (fp32 rounding only)
K6_RUN_TO_RUN = 1e-6
# the redesigned kernels' per-call times at their main-path shapes before
# their wgmma/TMA redesigns (PERF.md §6's earlier rows, NVIDIA H100 80GB
# HBM3, 700 W: the head-pair kernels' first CUDA versions, K9's and the
# causal K9's FFMA two-pass kernels, the fp32 K7's and K8's FFMA kernels,
# K3's WMMA kernels),
# by label where a kernel has several main-path shapes: printed beside this
# run's
EARLIER_MS = {"fused_qkv_rope_attention": 0.5330, "fused_qkv_rope_attention_stats": 1.7254,
              "fused_qkv_rope_attention_backward": 6.7221,
              # K10a's kernel before its redesign: device time per call (torch.profiler),
              # in the same turns as the redesigned one (pair_attention_variants
              # --cases K10a --parent)
              "rope_pair_k": 0.0396,
              "pair_long_attention": 6.4190, "flash_backward": 206.1132,
              "flash_backward_causal": 4.8726,
              "flash_forward": {"B8 T6272 H24 kv_len 6145": 51.6539,
                                "BH128 T4096 D64 kv_len None": 14.9957,
                                "BH128 T2048 D64 kv_len None": 3.8476,
                                "BH128 T1024 D80 kv_len None": 1.5490},
              "flash_forward_serving": {"BH32 T4096 D64": 3.9423, "BH32 T2048 D64": 1.0357,
                                        "BH32 T1024 D80": 0.4230,
                                        "BH48 T8576 D64 kv_len 8449": 24.2365},
              "flash_forward_causal": 1.2969, "flash_forward_causal_serving": 1.6428,
              "flash_backward_fused": {"BH128 T4096 D64 kv_len None": 44.8828,
                                       "BH128 T2048 D64 kv_len None": 11.9388,
                                       "BH128 T1024 D80 kv_len None": 4.9380},
              # K3's WMMA kernels by shape (PR 18's final run)
              "fused_residual_unit": {
                  "B1 T49152 C1024 d1": 17.5744, "B1 T49152 C1024 d3": 17.6944,
                  "B1 T49152 C1024 d9": 17.8331, "B1 T393216 C512 d1": 26.7915,
                  "B1 T393216 C512 d3": 26.8292, "B1 T393216 C512 d9": 27.1197,
                  "B1 T1572864 C256 d1": 16.9001, "B1 T1572864 C256 d3": 17.1951,
                  "B1 T1572864 C256 d9": 17.2026, "B1 T6291456 C128 d1": 19.3452,
                  "B1 T6291456 C128 d3": 19.3974, "B1 T6291456 C128 d9": 19.4361,
                  "B1 T12582912 C128 d1": 38.0549, "B1 T12582912 C128 d3": 38.4133,
                  "B1 T12582912 C128 d9": 38.728, "B1 T8192 C1024 d1": 2.9059,
                  "B1 T8192 C1024 d3": 2.9204, "B1 T8192 C1024 d9": 2.9471,
                  "B1 T65536 C512 d1": 4.6269, "B1 T65536 C512 d3": 4.707,
                  "B1 T65536 C512 d9": 4.7626, "B1 T262144 C256 d1": 2.9279,
                  "B1 T262144 C256 d3": 2.9357, "B1 T262144 C256 d9": 2.9809,
                  "B1 T1048576 C128 d1": 3.2292, "B1 T1048576 C128 d3": 3.2337,
                  "B1 T1048576 C128 d9": 3.2813, "B1 T2097152 C128 d1": 6.4458,
                  "B1 T2097152 C128 d3": 6.5202, "B1 T2097152 C128 d9": 6.5828},
              "fused_residual_unit_f32": {
                  "B1 T49152 C1024 d1": 77.1196, "B1 T49152 C1024 d3": 77.411,
                  "B1 T49152 C1024 d9": 78.5386, "B1 T393216 C512 d1": 124.522,
                  "B1 T393216 C512 d3": 125.9183, "B1 T393216 C512 d9": 128.3895,
                  "B1 T1572864 C256 d1": 79.6042, "B1 T1572864 C256 d3": 79.8809,
                  "B1 T1572864 C256 d9": 81.1486, "B1 T6291456 C128 d1": 82.6592,
                  "B1 T6291456 C128 d3": 83.0249, "B1 T6291456 C128 d9": 84.336,
                  "B1 T12582912 C128 d1": 165.0171, "B1 T12582912 C128 d3": 165.5645,
                  "B1 T12582912 C128 d9": 167.9183, "B1 T8192 C1024 d1": 13.1292,
                  "B1 T8192 C1024 d3": 12.9979, "B1 T8192 C1024 d9": 13.0624,
                  "B1 T65536 C512 d1": 21.8553, "B1 T65536 C512 d3": 22.2303,
                  "B1 T65536 C512 d9": 22.8334, "B1 T262144 C256 d1": 13.4643,
                  "B1 T262144 C256 d3": 13.6296, "B1 T262144 C256 d9": 13.835,
                  "B1 T1048576 C128 d1": 13.9597, "B1 T1048576 C128 d3": 14.0166,
                  "B1 T1048576 C128 d9": 14.306, "B1 T2097152 C128 d1": 27.8211,
                  "B1 T2097152 C128 d3": 28.1017, "B1 T2097152 C128 d9": 28.5221},
              # K2's thin route before its redesign (the CUDA-core kernel of every
              # thin shape), by main-path shape, in the same turns as the
              # redesigned kernels (conv_variants --thin)
              "snake_conv1d": {
                  "B1 T12582912 128->2 d1": 19.8786, "B1 T2097152 128->2 d1": 3.5417,
                  "B1 T2097152 2->128 k7": 2.5962, "B1 T12582912 2->128 k7": 15.5055,
                  "DAC B1 T4194304 96->2 k7 d1": 3.8596},
              "snake_conv1d_f32": {
                  "B1 T12582912 128->2 d1": 23.3217, "B1 T2097152 128->2 d1": 3.9940,
                  "B1 T2097152 2->128 k7": 2.6067, "B1 T12582912 2->128 k7": 15.5502,
                  "DAC B1 T4194304 96->2 k7 d1": 4.2262,
                  "DAC encode B1 T4194304 2->128 k7 d1": 5.1968,
                  "SEANet encode B8 T960000 1->64 k7": 4.7355,
                  "SEANet decode B1 T959992 64->1 k7": 0.6505}}
# K3's WMMA kernels per main path (PERF.md §6's rows; NVIDIA H100 80GB HBM3,
# 700 W): ms by (kernel, results field), printed beside this run's
# (`log_ru_path`)
EARLIER_RU_MS = {
    ("fused_residual_unit", "ms"): 353.5303,
    ("fused_residual_unit", "sao_decode_ms"): 60.3580,
    ("fused_residual_unit", "encode_ms"): 482.5375,
    ("fused_residual_unit", "sa2_encode_ms"): 2818.7930,
    ("fused_residual_unit_f32", "ms"): 271.4719,
    ("fused_residual_unit_f32", "sa2_decode_ms"): 1606.9373,
    ("fused_residual_unit_f32", "encode_ms"): 2174.3403,
    ("fused_residual_unit_f32", "sa2_encode_ms"): 12847.6923,
}
# the bf16 K7's per-call times by [3k] shape before its wgmma/TMA redesign
# (the mma.sync kernel; PERF.md §6, NVIDIA H100 80GB HBM3, 700 W): printed
# beside this run's
# calls per timing in [3k]: at 3, the host's time between calls showed in the
# smaller shapes' times (T 1024 D 80: 0.0625 ms against 0.0294 ms of device
# time under torch.profiler; NVIDIA H100 80GB HBM3, 700 W)
BF16_K7_REPS = 10
EARLIER_BF16_K7_MS = {"BH32 T4096 D64 kv_len None": 0.7587, "BH32 T2048 D64 kv_len None": 0.2046,
                      "BH32 T1024 D80 kv_len None": 0.0929, "BH48 T8576 D64 kv_len 8449": 4.5652}
# the end-to-end figures of the phases the redesigns move, from earlier runs
# (PERF.md §5, chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): printed beside
# this run's
EARLIER_E2E = {
    "[5]": "16.686 s-audio/s (PR 9 run); 21.387 s-audio/s, decode 0.0754 s (PR 13 final run)",
    "[8]": "12.719 s-audio/s, 219.6 ms per step (PR 9 run); 28.284 s-audio/s, 96.414 ms per step, "
           "decode 0.4351 s (PR 13 final run)",
    "[15]": "18.272 s-audio/s, 5.2053 s, decode 0.4301 s (PR 13 final run)",
    "[10]": "generate_diffusion_cond 16.2844 s = 5.840 s-audio/s, decode 0.5259 s (PR 13 final "
            "run); 5.965 s-audio/s (PR 14 run 1); the fp32 K7 14 x 100 serving calls, 16.6371 ms "
            "per step ([3f], PR 6's rows)",
    "[10b]": "generate_diffusion_cond 10.8833 s = 4.369 s-audio/s, decode 0.3212 s (PR 13 final run)",
    "[11]": "8.0671 s per step, encode 6.1568 s (PR 13 final run); 4.2063 s per step, encode "
            "2.3007 s (PR 14 run 1); K7 with LSE + K8 per step 62.3708 + 191.0269 ms ([3g], PR "
            "8's rows)",
    "[9]": "19.2305 s per step at 6 layers, encode 15.0487 s (PR 13 final run); 18.6368 and "
           "18.6811 s (PR 17 runs); K7 with LSE 12 calls x 51.6539 ms per 6-layer step ([3e])",
    "[12]": "1.2437 s per step, tokenize 0.1200 s (PR 13 final run); 1.1302 and 1.2948 s (PR 17 "
            "runs); the causal K7 with LSE 24 x 1.2969 = 31.1247 ms per step ([3h])",
    "[12b]": "the causal K7 without LSE 24 x 1.6428 = 39.4271 ms per no-grad forward ([3h], PR 9)",
    "[15b]": "the fp32 K7 24 x 24.2365 = 581.6753 ms per DiT forward ([3k], PR 12 final run)",
    "[13]": "7.418 / 8.001 ms per decode step (fused MLP off / on), token decode 0.0380 / 0.0394 s "
            "(PR 13 final run)",
    "[14]": "30.190 and 44.867 ms per step with fused_ew, 33.171 and 41.281 without (two "
            "runs); one DiT call's device time 22.771 ms, K1 10.949 ms of it",
    "[7]": "4.2910 s per step at 24 layers; 2.9674 s at 6 layers, encode 2.5615 s (PR 13 final run)",
}
# the K2/K4 totals per main path of the wgmma kernel's first measured run
# (PERF.md §6; chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W):
# (kernel ms, cuDNN ms) by (kernel, results field), K2 over both routes;
# printed beside this run's (`log_conv_path`), which must stay within
# CONV_DRIFT of them now that the mainloop is shared with K13
EARLIER_CONV_MS = {
    ("snake_conv1d", "ms"): (20.2250, 32.4689),
    ("snake_conv1d", "sao_decode_ms"): (3.7150, 5.5866),
    ("snake_conv1d", "encode_ms"): (22.6584, 16.4194),
    ("snake_conv1d", "sa2_encode_ms"): (125.6387, 80.7750),
    ("snake_conv1d", "sa1_decode_ms"): (23.6977, 92.4361),
    ("snake_conv_transpose1d", "ms"): (20.5220, 25.0198),
    ("snake_conv_transpose1d", "sao_decode_ms"): (3.8878, 4.4417),
    ("snake_conv_transpose1d", "sa1_decode_ms"): (3.1046, 6.7692),
    ("snake_conv1d_f32", "ms"): (80.8022, 196.1677),
    ("snake_conv1d_f32", "sao_decode_ms"): (4.0920, 4.1492),
    ("snake_conv1d_f32", "sa2_decode_ms"): (23.4953, 24.6402),
    ("snake_conv1d_f32", "encode_ms"): (24.4987, 14.5894),
    ("snake_conv1d_f32", "sa2_encode_ms"): (125.5002, 78.6261),
    ("snake_conv1d_f32", "sa1_encode_ms"): (946.1646, 2442.1757),
    ("snake_conv1d_f32", "lm_encode_ms"): (12.7321, 19.3503),
    ("snake_conv1d_f32", "lm_decode_ms"): (1.9453, 2.7532),
    ("snake_conv_transpose1d_f32", "ms"): (13.0328, 35.2888),
    ("snake_conv_transpose1d_f32", "sao_decode_ms"): (10.7633, 23.1376),
    ("snake_conv_transpose1d_f32", "sa2_decode_ms"): (60.9337, 161.6038),
    ("snake_conv_transpose1d_f32", "lm_decode_ms"): (1.0543, 2.5403),
}
CONV_DRIFT = 0.05
# the DAC decoder's upsample strides (dac_codec.py's rates at SA 1.0)
DAC_RATES = (8, 8, 4, 4)
# the K2 calls of the Oobleck decode (conv_in, conv_out) and of one Oobleck
# encode call (conv_in, conv_out): (Cin, Cout, k)
OOBLECK_DECODE_K2 = [(64, 2048, 7), (128, 2, 7)]
OOBLECK_ENCODE_K2 = [(2, 128, 7), (2048, 128, 3)]
FLASH_LSE_ATOL = 1e-4
# SA 2.0 training step with K7/K9 against the fp32 plain versions: the loss
# to 1e-5 relative, each watched gradient to rel-L2 1e-4 (fp32 both sides)
SA2_LOSS_RTOL = 1e-5
SA2_GRAD_RTOL = 1e-4
# model compares: the bf16 DiT with the kernels against an fp32 copy (plain
# versions, same weights) may err at most DIT_ERR_RATIO times as much as the
# bf16 DiT with the plain versions does; random de-zeroed weights amplify
# bf16 rounding through 24 layers, so the bf16 error itself is the yardstick
DIT_ERR_RATIO = 1.5
DECODE_REL_TOL = 2e-2  # 15 residual units, 5 upsamples, 2 convs in bf16
# the frozen bf16 encode with the kernels against an fp32 encode (plain
# versions): 15 residual units, 5 downsamples and 2 convs in bf16
ENCODE_REL_TOL = 5e-2
# the fp32 models with the kernels against the same models with the plain
# versions: the Oobleck encode and decode ([4]) and SA 1.0's U-Net forward
# ([4c]), each kernel within ~1e-6 of its plain version
FP32_MODEL_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


def smi_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def timed_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def within(name, out, ref):
    """(ok, max_abs, rel_l2, max|ref|) of out against ref under TOL[name]."""
    import torch

    diff = out.float() - ref.float()
    max_abs = diff.abs().max().item()
    rel_l2 = (diff.norm() / ref.float().norm()).item()
    peak = ref.float().abs().max().item()
    rel_tol, abs_frac = TOL[name]
    ok = bool(torch.isfinite(out).all()) and rel_l2 <= rel_tol and max_abs <= abs_frac * peak
    return ok, max_abs, rel_l2, peak


def compare(name, kernel_fn, plain_fn, reps=3, library_fn=None):
    """Runs both, checks the tolerance, returns (ok, max_abs, rel_l2, peak,
    kernel ms, plain ms, library ms or None)."""
    import torch

    out = kernel_fn()
    torch.cuda.synchronize()
    ok, max_abs, rel_l2, peak = within(name, out, plain_fn())
    del out
    ms, plain_ms = timed_ms(kernel_fn, reps), timed_ms(plain_fn, reps)
    lib_ms = None if library_fn is None else timed_ms(library_fn, reps)
    return ok, max_abs, rel_l2, peak, ms, plain_ms, lib_ms


def bound_ms(flops, nbytes, peak=PEAK_FLOPS):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def report(results, name, label, main_path, ok, max_abs, rel_l2, peak, ms, plain_ms, lib_ms=None,
           bound=None, field="ms", extra="", tol_name=None):
    """Logs one kernel-vs-plain result, raises when it failed, and adds a
    main-path shape's error and weighted times to the kernel's entry: for
    `field` f, f (kernel), plain_f, bound_f (from `bound`, (ms, resource))
    and library_f (None once a shape has no library call). `tol_name` names
    the TOL entry the result was checked under, where it is not `name`'s."""
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    bnd = "" if bound is None else f" bound {bound[0]:.4f} ms ({bound[1]})"
    log(f"  {name} {label}: max_abs {max_abs:.4g} (max|plain| {peak:.4g}) rel_l2 {rel_l2:.3g}{extra} "
        f"tol {TOL[tol_name or name]} kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib}{bnd} "
        f"{'main-path' if main_path else 'extra'} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain version")
    if main_path and name in EARLIER_MS:
        log_against_earlier(name, label, ms, bound, lib_ms)
    r = results[name]
    if main_path:
        w = r["weight"].get(label, 1)
        r["max_abs_err"] = max(r["max_abs_err"], max_abs)
        r[field] = r.get(field, 0.0) + ms * w
        r["plain_" + field] = r.get("plain_" + field, 0.0) + plain_ms * w
        r["bound_" + field] = r.get("bound_" + field, 0.0) + bound[0] * w
        parts = r.setdefault("bound_parts", {}).setdefault(field, {})
        parts[bound[1]] = parts.get(bound[1], 0.0) + bound[0] * w
        lib_key = "library_" + field
        if lib_ms is None or (lib_key in r and r[lib_key] is None):
            r[lib_key] = None
        else:
            r[lib_key] = r.get(lib_key, 0.0) + lib_ms * w


@contextlib.contextmanager
def patched(pairs):
    """Sets (object, attribute, value) triples for the block, then restores
    them. An attribute the object only inherited (an instance's method) is
    deleted again rather than set to the bound method it had, which would
    leave the instance in a reference cycle that only the garbage collector
    frees (a model kept alive on the card)."""
    saved = [(obj, name, getattr(obj, name), name in vars(obj)) for obj, name, _ in pairs]
    for obj, name, value in pairs:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value, own in saved:
            if own:
                setattr(obj, name, value)
            else:
                delattr(obj, name)


def plain_attention(qkv, freqs, num_heads, kv_len=None):
    """The inference attention through the plain versions, routed as the
    kernels are, by length and heads (K1's, K10a's then K10's, the
    rope-fused K7's, or the split route's K7, which `plain_kernels` sends to
    its plain version); heads the pair kernels do not take run at their true
    length, the output padded back."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    t = qkv.shape[1]
    d = qkv.shape[-1] // (3 * num_heads)
    if kv_len is not None and kv_len < t and not attention.pair_heads(d, num_heads):
        out = plain_attention(qkv[:, :kv_len], freqs[:kv_len], num_heads)
        return torch.nn.functional.pad(out, (0, 0, 0, t - kv_len))
    route = attention.attention_route(t, d, num_heads)
    if route == "rope_flash":
        return flash.flash_rope_attention_plain(qkv, freqs, num_heads)
    if route == "pair_long":
        return attention.fused_qkv_rope_attention_long_plain(qkv, freqs, num_heads, kv_len)
    if route == "flash":
        return attention.fused_qkv_rope_attention_split(qkv, freqs, num_heads, kv_len)
    return attention.fused_qkv_rope_attention_plain(qkv, freqs, num_heads, kv_len)


def plain_kernels():
    """Routes the model's kernel calls to the plain versions (for the
    kernel-vs-plain model compares)."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention, conv1d, elementwise, mlp
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    return patched([(attention, "fused_qkv_rope_attention", plain_attention),
                    (elementwise, "ln_modulate", lambda *a, enabled=True:
                     elementwise.ln_modulate_plain(*a)),
                    (elementwise, "gated_residual", lambda *a, enabled=True:
                     elementwise.gated_residual_plain(*a)),
                    (mlp, "glu_mlp", mlp.glu_mlp_plain),
                    (flash, "flash_forward", flash.flash_forward_plain),
                    (flash, "flash_backward", flash.flash_backward_plain),
                    (flash, "flash_backward_fused", flash.flash_backward_fused_plain),
                    (conv1d, "snake_conv1d", conv1d.snake_conv1d_plain),
                    (conv1d, "fused_residual_unit", conv1d.fused_residual_unit_plain),
                    (conv1d, "snake_conv_transpose1d", conv1d.snake_conv_transpose1d_plain)])


def randn_fn(seed):
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEVICE) * scale

    return rnd


def snake_params(rnd, c):
    return rnd(c).abs() + 0.5, 1.0 / (rnd(c).abs() + 0.5)


def segmented(fn, x, halo, up=1, seg=1 << 21):
    """fn over overlapping time segments of x [1, T, C], each with `halo`
    input rows on either side, keeping `up` output rows per input row: a
    'same'-length conv computed in pieces, so that the plain versions' fp32
    temporaries at 12,582,912 samples fit the card."""
    import torch

    t = x.shape[1]
    if t <= seg:
        return fn(x)
    outs = []
    for s0 in range(0, t, seg):
        lo, hi = max(0, s0 - halo), min(t, s0 + seg + halo)
        y = fn(x[:, lo:hi])
        outs.append(y[:, (s0 - lo) * up:(min(t, s0 + seg) - lo) * up])
    return torch.cat(outs, dim=1)


def log_earlier_e2e(phase, extra=""):
    """A phase's earlier end-to-end figure, beside this run's (logged above)."""
    log(f"  {phase} earlier: {EARLIER_E2E[phase]}{extra}; this run's figures above, card "
        f"{smi_line()}")


def log_against_earlier(name, label, ms, bound, lib_ms):
    """One kernel's per-call time at a main-path shape beside its earlier
    row (the label's, where the kernel has several), its bound, its share of
    the bound and the library call's time."""
    was = EARLIER_MS[name]
    if isinstance(was, dict):
        if label not in was:
            return
        was = was[label]
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"  {name} {label} per call at its main-path shape: {ms:.4f} ms (was {was:.4f} ms before "
        f"the redesign, {was / ms:.2f}x), bound {bound[0]:.4f} ms ({bound[1]}, "
        f"{bound[0] / ms:.0%} of it), library {lib}")


def attention_bound(b, h, valid, products, in_tensors, out_tensors):
    """Bound of `products` [valid x valid x 64] products per head over the
    valid rows of the given tensors."""
    return bound_ms(products * 2 * b * h * valid * valid * 64,
                    sum(nbytes(x) * valid // x.shape[1] for x in in_tensors + out_tensors))


def sdpa_inputs(qkv, freqs, h, kv):
    """q roped and prescaled, k roped, v, as [B, H, T, 64] bf16, K/V sliced to
    kv_len: the inputs of the library call timed beside the attention kernels."""
    from friendly_stable_audio_tools_tpu_torch.ops.embeddings import apply_rotary_pos_emb

    b, t, _ = qkv.shape
    q, k, v = qkv.view(b, t, 3, h, 64).permute(2, 0, 3, 1, 4)
    valid = kv or t
    q = apply_rotary_pos_emb(q, freqs).contiguous()
    k = apply_rotary_pos_emb(k, freqs)[:, :, :valid].contiguous()
    return q, k, v[:, :, :valid].contiguous()


def conv_library(x, w, bias, alpha, inv_beta, dilation=1, stride=None):
    """cuDNN's conv1d (stride None) or conv_transpose1d in x's dtype (bf16
    or fp32, TF32 off) on the already snaked input: the library call timed
    beside K2 and K4 (it leaves the snake out)."""
    import torch.nn.functional as F

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    dt = x.dtype
    xs = x.float() if alpha is None else conv1d.snake(x.float(), alpha, inv_beta)
    xs = xs.to(dt).transpose(1, 2).contiguous()
    bb = None if bias is None else bias.to(dt)
    if stride is None:
        wt = w.permute(2, 1, 0).to(dt).contiguous()
        return lambda: F.conv1d(xs, wt, bb, padding="same", dilation=dilation)
    wt = w.permute(1, 2, 0).to(dt).contiguous()
    return lambda: F.conv_transpose1d(xs, wt, bb, stride=stride, padding=stride // 2)


def ru_library(x, w1, b1, alpha1, inv_beta1, w2, dilation):
    """The unfused library chain timed beside K3 (never called by the port):
    cuDNN's k7 dilated conv (+ b1) on the already snaked input, then a
    cuBLAS GEMM by w2, in x's dtype (fp32 with TF32 off), channels-first; it
    leaves snake2, b2 and the residual out."""
    import torch
    import torch.nn.functional as F

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    dt = x.dtype
    xs = conv1d.snake(x.float(), alpha1, inv_beta1).to(dt).transpose(1, 2).contiguous()
    w1t = w1.permute(2, 1, 0).to(dt).contiguous()
    w2t = w2.t().to(dt).contiguous()
    bb = b1.to(dt)
    return lambda: torch.matmul(w2t, F.conv1d(xs, w1t, bb, padding=3 * dilation,
                                              dilation=dilation))


def log_ru_path(results, dtype, field, what):
    """K3's total per main path `what` on `dtype` beside its earlier figure
    (EARLIER_RU_MS), with the plain version's, the bound and its share of
    it, and the unfused library chain's."""
    name = conv_name("fused_residual_unit", dtype)
    r = results[name]
    ms, bound, lib = r[field], r["bound_" + field], r["library_" + field]
    was = EARLIER_RU_MS[(name, field)]
    log(f"  {name}: {ms:.4f} ms per {what}; earlier {was:.4f} ms ({was / ms:.2f}x), plain "
        f"{r['plain_' + field]:.4f} ms, bound {bound:.4f} ms ({bound / ms:.0%} of it), library "
        f"chain {'none' if lib is None else f'{lib:.4f} ms'}; card {smi_line()}")


def conv_name(name, dtype):
    """The results entry of conv kernel `name` for activations of `dtype`."""
    import torch

    return name + ("_f32" if dtype == torch.float32 else "")


def k2_entry(cin, cout, k, dtype):
    """The results entry (and launch count) of K2's route for this shape."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    wide = conv1d.conv_route(cin, cout, k, dtype) == "wide"
    return conv_name("snake_conv1d_wide" if wide else "snake_conv1d", dtype)


def k2_counts(shapes, dtype, times=1):
    """K2's launches by route for convs of (Cin, Cout, k) `shapes`, `times` each."""
    counts = {conv_name("snake_conv1d", dtype): 0, conv_name("snake_conv1d_wide", dtype): 0}
    for cin, cout, k in shapes:
        counts[k2_entry(cin, cout, k, dtype)] += times
    return counts


def thin_k2_fn(x, w, bias, alpha, inv_beta, dilation):
    """The thin route's kernel (the design conv1d.thin_design gives the
    shape: the CUDA-core kernel, which takes any shape, at every wide shape
    chip_smoke times) launched directly on a call that conv_route sends to
    the wide kernel, outside the launch counts: its time beside the wide
    kernel's at every wide shape is what draws the route's boundary."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import build, conv1d

    k, cin, cout = w.shape
    xc, wc = x.contiguous(), w.to(x.dtype).contiguous()
    bb = (torch.zeros(cout, device=x.device) if bias is None else bias.float()).contiguous()
    ab = conv1d._stack_snake(alpha, inv_beta)
    y = torch.empty(x.shape[0], x.shape[1], cout, device=x.device, dtype=x.dtype)
    lib = build.library()
    fn = lib.fsat_snake_conv1d_f32 if x.dtype == torch.float32 else lib.fsat_snake_conv1d
    design = conv1d.THIN_DESIGNS[conv1d.thin_design(cin, cout, k, dilation, x.dtype)]

    def run():
        build.check(fn(xc.data_ptr(), wc.data_ptr(), bb.data_ptr(),
                       None if ab is None else ab.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                       cin, cout, k, dilation, dilation * (k - 1) // 2, design,
                       torch.cuda.current_stream().cuda_stream), "thin K2")
        return y

    return run


def conv_case(results, name, label, field, x, w, bias, a, ib, kernel, plain, flops, halo, up=1,
              weight=1, **lib_kw):
    """One K2 or K4 compare on x's dtype, reported under conv_name(name) (K2:
    its route's entry, k2_entry, checked under K2's tolerance) with `weight`
    calls per `field`. A wide K2 shape also times the thin route's kernel
    once. Bound: the products at the bf16 rate, or the fp32-accurate rate
    for fp32; w read once in x's dtype."""
    import torch

    y = torch.empty(x.shape[0], x.shape[1] * up, w.shape[2], device=DEVICE, dtype=x.dtype)
    peak = PEAK_FP32_ACCURATE if x.dtype == torch.float32 else PEAK_FLOPS
    bound = bound_ms(flops, nbytes(x, y, bias) + w.numel() * x.element_size(), peak=peak)
    del y
    tol_name = conv_name(name, x.dtype)
    extra = ""
    if name == "snake_conv1d":
        name = k2_entry(x.shape[2], w.shape[2], w.shape[0], x.dtype)
        extra = f", route {'wide' if '_wide' in name else 'thin'}"
        if "_wide" in name:
            thin = thin_k2_fn(x, w, bias, a, ib, lib_kw.get("dilation", 1))
            extra += f" (thin route {timed_ms(thin, 1):.4f} ms)"
            del thin
    else:
        name = tol_name
    results[name]["weight"][label] = weight
    report(results, name, label, True, *compare(
        tol_name, kernel, lambda: segmented(plain, x, halo, up),
        library_fn=conv_library(x, w, bias, a, ib, **lib_kw)), bound=bound, field=field,
        extra=extra, tol_name=tol_name)


def log_conv_path(results, name, dtype, field, what):
    """K2's (both routes) or K4's total per main path `what` on `dtype`,
    beside the earlier figure (EARLIER_CONV_MS) and whether it is within
    CONV_DRIFT of it, with the bound and cuDNN's time."""
    names = [conv_name(name, dtype)]
    if name == "snake_conv1d":
        names.append(conv_name("snake_conv1d_wide", dtype))
    names = [n for n in names if "bound_" + field in results[n]]
    rs = [results[n] for n in names]
    tot = {k: sum(r[k + field] for r in rs) for k in ("", "plain_", "bound_")}
    libs = [r["library_" + field] for r in rs]
    lib = None if None in libs else sum(libs)
    parts = ", ".join(f"{n} {results[n][field]:.4f}" for n in names)
    was, was_lib = EARLIER_CONV_MS[(conv_name(name, dtype), field)]
    ratio = tot[''] / was
    log(f"  {conv_name(name, dtype)}: {tot['']:.4f} ms per {what} ({parts}); earlier "
        f"{was:.4f} ms ({ratio:.3f}x, {'within' if abs(ratio - 1) <= CONV_DRIFT else 'OUTSIDE'} "
        f"{CONV_DRIFT:.0%}), plain {tot['plain_']:.4f} ms, bound {tot['bound_']:.4f} ms, cuDNN "
        f"{'none' if lib is None else f'{lib:.4f} ms'} (earlier {was_lib:.4f} ms); card "
        f"{smi_line()}")


def kernel_phase(results):
    """[3] K1 at SAO 1.0's shape and three ragged ones, then the decoders'
    K2-K4 in bf16."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention

    bf = torch.bfloat16
    rnd = randn_fn(0)

    # K1: the DiT's self-attention, B = 2 (CFG), 24 heads, T = 1024 + 1 prepended token
    for b, t, h, kv, main in [(2, 1025, 24, None, True), (1, 77, 2, None, False),
                              (4, 1040, 4, 1025, False), (2, 144, 2, 130, False)]:
        qkv = rnd(b, t, 3 * h * 64).to(bf)
        f = rotary_freqs(t, 32, device=DEVICE)
        q, k, v = sdpa_inputs(qkv, f, h, kv)
        out = torch.empty(b, t, h * 64, device=DEVICE, dtype=bf)
        report(results, "fused_qkv_rope_attention", f"B{b} T{t} H{h} kv_len {kv}", main, *compare(
            "fused_qkv_rope_attention", lambda: attention.fused_qkv_rope_attention(qkv, f, h, kv),
            lambda: attention.fused_qkv_rope_attention_plain(qkv, f, h, kv),
            library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
            bound=attention_bound(b, h, kv or t, 2, [qkv], [out]))
    decode_conv_phase(results, bf, {"sa2": "ms", "sao": "sao_decode_ms"})


def decode_conv_phase(results, dtype, fields):
    """K2, K3 and K4 on `dtype` activations at every shape of the Oobleck
    decodes of SA 2.0 (6144 latent frames) and SAO 1.0 (1024), batch 1,
    under fields["sa2"] and fields["sao"] (K3 under fields["sa2_ru"] and
    fields["sao_ru"] where given), and at three small ragged shapes."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    rnd = randn_fn(0 if dtype == torch.bfloat16 else 8)
    for frames, which in ((SA2_SAMPLE_SIZE // 2048, "sa2"), (SAMPLE_SIZE // 2048, "sao")):
        field = fields[which]
        n = frames * 2048
        # K2: decoder conv_in (64 -> 2048, k 7, no snake) and conv_out (snake, 128 -> 2, no bias)
        for t, cin, cout, sn, bias in [(frames, 64, 2048, False, True), (n, 128, 2, True, False)]:
            x = rnd(1, t, cin, scale=0.5).to(dtype)
            w = rnd(7, cin, cout, scale=1 / math.sqrt(7 * cin))
            bb = rnd(cout, scale=0.1) if bias else None
            a, ib = snake_params(rnd, cin) if sn else (None, None)
            conv_case(results, "snake_conv1d", f"B1 T{t} {cin}->{cout} d1", field, x, w, bb, a, ib,
                      lambda: conv1d.snake_conv1d(x, w, bb, a, ib),
                      lambda xs: conv1d.snake_conv1d_plain(xs, w, bb, a, ib),
                      2 * t * cin * cout * 7, halo=3)
            del x
        # K3: the 15 residual units
        ru = conv_name("fused_residual_unit", dtype)
        ru_field = fields.get(which + "_ru", field)
        peak = PEAK_FP32_ACCURATE if dtype == torch.float32 else PEAK_FLOPS
        for c, t in [(1024, frames * 8), (512, frames * 64), (256, frames * 256),
                     (128, frames * 1024), (128, n)]:
            x = rnd(1, t, c, scale=0.5).to(dtype)
            w1, w2 = rnd(7, c, c, scale=1 / math.sqrt(7 * c)), rnd(c, c, scale=1 / math.sqrt(c))
            b1, b2 = rnd(c, scale=0.1), rnd(c, scale=0.1)
            (a1, i1), (a2, i2) = snake_params(rnd, c), snake_params(rnd, c)
            for d in (1, 3, 9):
                y = torch.empty_like(x)
                bound = bound_ms(2 * t * c * c * 8, nbytes(x, y, b1, b2) + 8 * c * c * x.element_size(),
                                 peak=peak)
                del y
                report(results, ru, f"B1 T{t} C{c} d{d}", True, *compare(
                    ru,
                    lambda: conv1d.fused_residual_unit(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation=d),
                    lambda: segmented(lambda xs: conv1d.fused_residual_unit_plain(
                        xs, w1, b1, a1, i1, w2, b2, a2, i2, dilation=d), x, 3 * d),
                    library_fn=ru_library(x, w1, b1, a1, i1, w2, d)),
                    bound=bound, field=ru_field, extra=f", route {conv1d.ru_route(c, dtype)}")
            del x
        # K4: the 5 upsamples
        for t, cin, cout, st in [(frames, 2048, 1024, 8), (frames * 8, 1024, 512, 8),
                                 (frames * 64, 512, 256, 4), (frames * 256, 256, 128, 4),
                                 (frames * 1024, 128, 128, 2)]:
            x = rnd(1, t, cin, scale=0.5).to(dtype)
            w = rnd(2 * st, cin, cout, scale=1 / math.sqrt(2 * cin))
            bb = rnd(cout, scale=0.1)
            a, ib = snake_params(rnd, cin)
            conv_case(results, "snake_conv_transpose1d", f"B1 T{t} {cin}->{cout} s{st}", field, x, w,
                      bb, a, ib, lambda: conv1d.snake_conv_transpose1d(x, w, bb, a, ib, stride=st),
                      lambda xs: conv1d.snake_conv_transpose1d_plain(xs, w, bb, a, ib, stride=st),
                      2 * t * st * cin * cout * 2, halo=1, up=st, stride=st)
            del x
        what = f"{'SA 2.0' if which == 'sa2' else 'SAO 1.0'} decode"
        log_ru_path(results, dtype, ru_field, f"{what} (15 calls)")
        log_conv_path(results, "snake_conv1d", dtype, field, f"{what} (2 calls)")
        log_conv_path(results, "snake_conv_transpose1d", dtype, field, f"{what} (5 calls)")

    # small ragged shapes
    x = rnd(2, 301, 32, scale=0.5).to(dtype)
    w = rnd(7, 32, 48, scale=1 / math.sqrt(7 * 32))
    bb = rnd(48, scale=0.1)
    a, ib = snake_params(rnd, 32)
    k2 = conv_name("snake_conv1d", dtype)
    report(results, k2_entry(32, 48, 7, dtype), "B2 T301 32->48 d3", False, *compare(
        k2, lambda: conv1d.snake_conv1d(x, w, bb, a, ib, dilation=3),
        lambda: conv1d.snake_conv1d_plain(x, w, bb, a, ib, dilation=3)), tol_name=k2)
    # the wide K2 at a batch edge and a zero-filled halo on both sides (T 333
    # is no multiple of the 128-row tile; dilation 9 reaches 27 rows out)
    x = rnd(2, 333, 96, scale=0.5).to(dtype)
    w = rnd(7, 96, 96, scale=1 / math.sqrt(7 * 96))
    b96 = rnd(96, scale=0.1)
    a, ib = snake_params(rnd, 96)
    report(results, k2_entry(96, 96, 7, dtype), "B2 T333 96->96 d9 snake", False, *compare(
        k2, lambda: conv1d.snake_conv1d(x, w, b96, a, ib, dilation=9),
        lambda: conv1d.snake_conv1d_plain(x, w, b96, a, ib, dilation=9)), tol_name=k2)
    x = rnd(2, 333, 128, scale=0.5).to(dtype)
    w1, w2 = rnd(7, 128, 128, scale=1 / math.sqrt(7 * 128)), rnd(128, 128, scale=1 / math.sqrt(128))
    b1, b2 = rnd(128, scale=0.1), rnd(128, scale=0.1)
    (a1, i1), (a2, i2) = snake_params(rnd, 128), snake_params(rnd, 128)
    name = conv_name("fused_residual_unit", dtype)
    report(results, name, "B2 T333 C128 d9", False, *compare(
        name, lambda: conv1d.fused_residual_unit(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation=9),
        lambda: conv1d.fused_residual_unit_plain(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation=9)))
    # the split route under one row tile, both zero edges in its halo
    x = rnd(2, 77, 1024, scale=0.5).to(dtype)
    w1, w2 = rnd(7, 1024, 1024, scale=1 / math.sqrt(7 * 1024)), rnd(1024, 1024, scale=1 / 32)
    b1k, b2k = rnd(1024, scale=0.1), rnd(1024, scale=0.1)
    (a1, i1), (a2, i2) = snake_params(rnd, 1024), snake_params(rnd, 1024)
    report(results, name, "B2 T77 C1024 d9", False, *compare(
        name, lambda: conv1d.fused_residual_unit(x, w1, b1k, a1, i1, w2, b2k, a2, i2, dilation=9),
        lambda: conv1d.fused_residual_unit_plain(x, w1, b1k, a1, i1, w2, b2k, a2, i2, dilation=9)),
        extra=f", route {conv1d.ru_route(1024, dtype)}")
    cout = 96 if dtype == torch.float32 else 128  # the shapes of earlier runs
    x = rnd(2, 77, 128, scale=0.5).to(dtype)
    w = rnd(8, 128, cout, scale=1 / math.sqrt(2 * 128))
    a, ib = snake_params(rnd, 128)
    name = conv_name("snake_conv_transpose1d", dtype)
    report(results, name, f"B2 T77 128->{cout} s4", False, *compare(
        name, lambda: conv1d.snake_conv_transpose1d(x, w, b1[:cout], a, ib, stride=4),
        lambda: conv1d.snake_conv_transpose1d_plain(x, w, b1[:cout], a, ib, stride=4)))
    # K4 at a batch edge and both zero edges, stride 8, Cout 96 (the DAC's last width)
    x = rnd(2, 77, 192, scale=0.5).to(dtype)
    w = rnd(16, 192, 96, scale=1 / math.sqrt(2 * 192))
    a, ib = snake_params(rnd, 192)
    report(results, name, "B2 T77 192->96 s8 snake", False, *compare(
        name, lambda: conv1d.snake_conv_transpose1d(x, w, b96, a, ib, stride=8),
        lambda: conv1d.snake_conv_transpose1d_plain(x, w, b96, a, ib, stride=8)))


def attention_train_phase(results):
    """[3b] K5 and K6 against their plain versions (bf16 in; the backward
    compared in fp32 out, as training takes it). K6 gets the plain
    forward's out and lse, so the compare isolates the backward. Library
    calls: SDPA's forward beside K5, its backward beside K6."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(1)
    fwd, bwd = "fused_qkv_rope_attention_stats", "fused_qkv_rope_attention_backward"
    for b, t, h, kv, main in [(TRAIN_BATCH, TRAIN_T, 24, TRAIN_KV, True),
                              (4, TRAIN_T, 24, TRAIN_KV, False), (2, 272, 4, 260, False),
                              (1, 77, 2, None, False)]:
        label = f"B{b} T{t} H{h} kv_len {kv}"
        qkv = rnd(b, t, 3 * h * 64).to(torch.bfloat16)
        f = rotary_freqs(t, 32, device=DEVICE)
        go = rnd(b, t, h * 64).to(torch.bfloat16)
        if kv is not None:
            go[:, kv:] = 0  # the transformer slices the padded rows off
        valid = kv or t

        out, lse = attention.fused_qkv_rope_attention_stats(qkv, f, h, kv)
        torch.cuda.synchronize()
        out_p, lse_p = attention.fused_qkv_rope_attention_stats_plain(qkv, f, h, kv)
        ok, max_abs, rel_l2, peak = within(fwd, out, out_p)
        lse_err = (lse - lse_p).abs().max().item()
        ms = timed_ms(lambda: attention.fused_qkv_rope_attention_stats(qkv, f, h, kv), 3)
        plain_ms = timed_ms(lambda: attention.fused_qkv_rope_attention_stats_plain(qkv, f, h, kv), 3)
        q, k, v = (x.requires_grad_(True) for x in sdpa_inputs(qkv, f, h, kv))
        lib_ms = timed_ms(lambda: sdpa(q.detach(), k.detach(), v.detach()), 3)
        report(results, fwd, label, main, ok and lse_err <= LSE_ATOL, max_abs, rel_l2, peak, ms,
               plain_ms, lib_ms, bound=attention_bound(b, h, valid, 2, [qkv], [out, lse]),
               extra=f", lse max_abs {lse_err:.3g} (tol {LSE_ATOL})")

        def k6():
            return attention.fused_qkv_rope_attention_backward(qkv, out_p, lse_p, go, f, h, kv,
                                                               dtype=torch.float32)

        def k6_plain():
            return attention.fused_qkv_rope_attention_backward_plain(qkv, out_p, lse_p, go, f, h, kv,
                                                                     dtype=torch.float32)

        d, d_p = k6(), k6_plain()
        torch.cuda.synchronize()
        again = rel_err(k6(), d)  # the same inputs: dq's reduce-adds land in another order
        hd = h * 64
        thirds = " ".join(f"{n} {rel_err(d[..., i * hd:(i + 1) * hd], d_p[..., i * hd:(i + 1) * hd]):.3g}"
                          for i, n in enumerate("qkv"))
        ok, max_abs, rel_l2, peak = within(bwd, d, d_p)
        bound = attention_bound(b, h, valid, 5, [qkv, out_p, lse_p, go], [d])
        del d, d_p
        o = sdpa(q, k, v)
        g = go.view(b, t, h, 64).transpose(1, 2)
        lib_ms = timed_ms(lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True), 3)
        report(results, bwd, label, main, ok and again <= K6_RUN_TO_RUN, max_abs, rel_l2, peak,
               timed_ms(k6, 3), timed_ms(k6_plain, 3), lib_ms, bound=bound,
               extra=f" (rel-L2 of dq/dk/dv: {thirds}; two runs on the same inputs: rel-L2 "
                     f"{again:.3g}, tol {K6_RUN_TO_RUN})")
        del q, k, v, o
    for name, calls in ((fwd, 2 * 24), (bwd, 24)):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms per training step ({calls} calls at B{TRAIN_BATCH} "
            f"T{TRAIN_T}), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms")


def encode_calls(config):
    """Calls of the frozen encode per training batch: one per sample with
    `iterate_batch` true, one per n samples with an int n, else one."""
    ib = config["model"]["pretransform"].get("iterate_batch", False)
    return math.ceil(TRAIN_BATCH / int(ib)) if ib else 1


def encoder_conv_phase(results, config, field, dtype=None):
    """[3c] K2 and K3 at the frozen encoder's shapes for `config`'s sample
    size, on `dtype` activations (bf16 by default), at the batch of one
    encode call, weighted by the calls per training step, under `field` (the
    plain versions in overlapping time segments beyond 2,097,152 samples)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    dtype = dtype or torch.bfloat16
    rnd = randn_fn(2)
    calls = encode_calls(config)
    b = TRAIN_BATCH // calls
    n = config["sample_size"]
    ru = conv_name("fused_residual_unit", dtype)
    peak = PEAK_FP32_ACCURATE if dtype == torch.float32 else PEAK_FLOPS
    # K2: conv_in 2 -> 128 (k 7, no snake) at the sample size; conv_out
    # snake 2048 -> 128 (k 3) at the latent frames
    for t, cin, cout, k, sn in [(n, 2, 128, 7, False), (n // 2048, 2048, 128, 3, True)]:
        x = rnd(b, t, cin, scale=0.5).to(dtype)
        w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
        bb = rnd(cout, scale=0.1)
        a, ib = snake_params(rnd, cin) if sn else (None, None)
        conv_case(results, "snake_conv1d", f"B{b} T{t} {cin}->{cout} k{k}", field, x, w, bb, a, ib,
                  lambda: conv1d.snake_conv1d(x, w, bb, a, ib),
                  lambda xs: conv1d.snake_conv1d_plain(xs, w, bb, a, ib),
                  2 * b * t * cin * cout * k, halo=k // 2, weight=calls)
        del x
    # K3: the encoder's 15 residual units
    for c, t in [(128, n), (128, n // 2), (256, n // 8), (512, n // 32), (1024, n // 256)]:
        x = rnd(b, t, c, scale=0.5).to(dtype)
        w1, w2 = rnd(7, c, c, scale=1 / math.sqrt(7 * c)), rnd(c, c, scale=1 / math.sqrt(c))
        b1, b2 = rnd(c, scale=0.1), rnd(c, scale=0.1)
        (a1, i1), (a2, i2) = snake_params(rnd, c), snake_params(rnd, c)
        for d in (1, 3, 9):
            label = f"B{b} T{t} C{c} d{d}"
            results[ru]["weight"][label] = calls
            bound = bound_ms(2 * b * t * c * c * 8,
                             2 * nbytes(x) + nbytes(b1, b2) + 8 * c * c * x.element_size(), peak=peak)
            report(results, ru, label, True, *compare(
                ru,
                lambda: conv1d.fused_residual_unit(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation=d),
                lambda: segmented(lambda xs: conv1d.fused_residual_unit_plain(
                    xs, w1, b1, a1, i1, w2, b2, a2, i2, dilation=d), x, 3 * d),
                library_fn=ru_library(x, w1, b1, a1, i1, w2, d)),
                bound=bound, field=field, extra=f", route {conv1d.ru_route(c, dtype)}")
        del x
    log_conv_path(results, "snake_conv1d", dtype, field,
                  f"training-step encode ({2 * calls} calls: 2 per call, {calls} calls at batch {b})")
    log_ru_path(results, dtype, field, f"training-step encode ({calls} calls at batch {b})")


def dac_decode_k2_cases():
    """K2's calls in Stable Audio 1.0's DAC decode of 4096 latent frames
    (4,194,304 samples), batch 1: (T, Cin, Cout, k, dilation, calls) of
    conv_in 64 -> 1536 (k 7); per block, after the upsample, three residual
    units of a k-7 conv at dilations 1, 3, 9 and a 1x1 conv; conv_out 96 -> 2
    (k 7): 26 calls."""
    t, ch = SA1_SAMPLE_SIZE // 1024, 1536
    cases = [(t, 64, ch, 7, 1, 1)]
    for rate in DAC_RATES:
        t, ch = t * rate, ch // 2
        cases += [(t, ch, ch, 7, d, 1) for d in (1, 3, 9)] + [(t, ch, ch, 1, 1, 3)]
    cases.append((t, ch, 2, 7, 1, 1))
    if sum(calls for *_, calls in cases) != 26:
        raise AssertionError(f"the DAC decode's K2 shapes do not add up to 26 calls: {cases}")
    return cases


def dac_decode_k2_counts(dtype):
    return k2_counts([(cin, cout, k) for _, cin, cout, k, _, n in dac_decode_k2_cases()
                      for _ in range(n)], dtype)


def dac_conv_phase(results, dtype=None, field="ms"):
    """[3f] fp32 K2 and K4 ([3k]: bf16, under `field`) at every shape of
    Stable Audio 1.0's DAC decode of 4096 latent frames (4,194,304 samples),
    batch 1, weighted by the calls per decode: the upsamples (1536 -> 768 ->
    384 -> 192 -> 96 at strides 8, 8, 4, 4) and `dac_decode_k2_cases`, none
    with a fused snake (the DAC applies its Snake on its own). 26 K2 and 4 K4
    launches."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    dtype = dtype or torch.float32
    rnd = randn_fn(9)
    t, ch = SA1_SAMPLE_SIZE // 1024, 1536
    for rate in DAC_RATES:
        x = rnd(1, t, ch, scale=0.5).to(dtype)
        w = rnd(2 * rate, ch, ch // 2, scale=1 / math.sqrt(2 * ch))
        bb = rnd(ch // 2, scale=0.1)
        conv_case(results, "snake_conv_transpose1d", f"DAC B1 T{t} {ch}->{ch // 2} s{rate}", field, x,
                  w, bb, None, None, lambda: conv1d.snake_conv_transpose1d(x, w, bb, stride=rate),
                  lambda xs: conv1d.snake_conv_transpose1d_plain(xs, w, bb, stride=rate),
                  2 * t * rate * ch * (ch // 2) * 2, halo=1, up=rate, stride=rate)
        del x
        t, ch = t * rate, ch // 2
    for t, cin, cout, k, d, calls in dac_decode_k2_cases():
        x = rnd(1, t, cin, scale=0.5).to(dtype)
        w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
        bb = rnd(cout, scale=0.1)
        conv_case(results, "snake_conv1d", f"DAC B1 T{t} {cin}->{cout} k{k} d{d}", field, x, w, bb,
                  None, None, lambda: conv1d.snake_conv1d(x, w, bb, dilation=d),
                  lambda xs: conv1d.snake_conv1d_plain(xs, w, bb, dilation=d),
                  2 * t * cin * cout * k, halo=d * (k - 1) // 2, weight=calls, dilation=d)
        del x
    log_conv_path(results, "snake_conv1d", dtype, field, "SA 1.0 DAC decode (26 calls)")
    log_conv_path(results, "snake_conv_transpose1d", dtype, field, "SA 1.0 DAC decode (4 calls)")


def dac_encode_k2_cases(config):
    """K2's calls in one DAC encode of `config`'s clip (batch 1): (T, Cin,
    Cout, k, dilation, calls) of conv_in 2 -> 128 (k 7); per block, three
    residual units of a k-7 conv at dilations 1, 3, 9 and a 1x1 conv at the
    block's input width (128, 256, 512, 1024), then the strided downsample
    (the plain reshape-GEMM form, no kernel); conv_out 2048 -> 2048 (k 3): 26
    calls at SA 1.0's four strides."""
    enc = config["model"]["pretransform"]["config"]["encoder"]["config"]
    t, ch = config["sample_size"], enc["d_model"]
    cases = [(t, enc["in_channels"], ch, 7, 1, 1)]
    for stride in enc["strides"]:
        cases += [(t, ch, ch, 7, d, 1) for d in (1, 3, 9)] + [(t, ch, ch, 1, 1, 3)]
        t, ch = t // stride, ch * 2
    cases.append((t, ch, ch, 3, 1, 1))
    return cases


def dac_encode_conv_phase(results, config):
    """[3f] fp32 K2 at every shape of Stable Audio 1.0's DAC encode of one
    clip of 4,194,304 samples (one clip per encode call, `iterate_batch`),
    weighted by the calls per clip times the clips per training step, under
    `sa1_encode_ms` (`dac_encode_k2_cases`; none has a fused snake: the DAC
    applies its Snake on its own). 26 K2 launches per clip."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    rnd = randn_fn(11)
    clips = encode_calls(config)
    cases = dac_encode_k2_cases(config)
    if sum(calls for *_, calls in cases) != 26:
        raise AssertionError(f"the DAC encode's K2 shapes do not add up to 26 calls: {cases}")
    for t, cin, cout, k, d, calls in cases:
        x = rnd(1, t, cin, scale=0.5)
        w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
        bb = rnd(cout, scale=0.1)
        conv_case(results, "snake_conv1d", f"DAC encode B1 T{t} {cin}->{cout} k{k} d{d}",
                  "sa1_encode_ms", x, w, bb, None, None,
                  lambda: conv1d.snake_conv1d(x, w, bb, dilation=d),
                  lambda xs: conv1d.snake_conv1d_plain(xs, w, bb, dilation=d),
                  2 * t * cin * cout * k, halo=d * (k - 1) // 2, weight=calls * clips, dilation=d)
        del x
    log_conv_path(results, "snake_conv1d", torch.float32, "sa1_encode_ms",
                  f"SA 1.0 training-step encode ({26 * clips} calls: 26 per clip, {clips} clips)")


def seanet_conv_steps(config):
    """The fp32 K2 calls of one SEANet encode of a training batch (one call
    for the batch): (T, Cin, Cout, k) of conv_in, each block's residual
    convs (k 3 to half the width, k 1 back) and conv_out, in order."""
    enc = config["model"]["pretransform"]["config"]["encoder"]["config"]
    if enc.get("n_residual_layers", 1) != 1:
        raise AssertionError("the K2 shapes below assume one residual layer per block")
    t, ch = config["sample_size"], enc["n_filters"]
    cases = [(t, enc["channels"], ch, enc.get("kernel_size", 7))]
    for ratio in reversed(enc["ratios"]):  # the encoder's order
        cases += [(t, ch, ch // 2, enc.get("residual_kernel_size", 3)), (t, ch // 2, ch, 1)]
        t, ch = t // ratio, ch * 2
    cases.append((t, ch, enc["dimension"], enc.get("last_kernel_size", 7)))
    return cases


def seanet_conv_phase(results, config):
    """[3h] fp32 K2 at every shape of the audio LM's SEANet encode of a
    training batch (B 8 x 960,000 samples, one call; ELU before each conv,
    no snake), under `lm_encode_ms`: 10 launches per training step."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    rnd = randn_fn(15)
    cases = seanet_conv_steps(config)
    for t, cin, cout, k in cases:
        label = f"SEANet encode B{TRAIN_BATCH} T{t} {cin}->{cout} k{k}"
        x = rnd(TRAIN_BATCH, t, cin, scale=0.5)
        w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
        bb = rnd(cout, scale=0.1)
        conv_case(results, "snake_conv1d", label, "lm_encode_ms", x, w, bb, None, None,
                  lambda: conv1d.snake_conv1d(x, w, bb),
                  lambda xs: conv1d.snake_conv1d_plain(xs, w, bb),
                  2 * TRAIN_BATCH * t * cin * cout * k, halo=(k - 1) // 2)
        del x
    log_conv_path(results, "snake_conv1d", torch.float32, "lm_encode_ms",
                  f"audio LM training-step encode ({len(cases)} calls)")


LSTM_RTOL = 1e-5


def lstm_tf32_check(config):
    """[3h] cuDNN's LSTM follows `torch.backends.cudnn.allow_tf32`: the
    SEANet's residual two-layer LSTM at its training shape (B 8, 1500 frames,
    1024 wide), fp32 against the same weights in fp64, with TF32 off (as the
    CLIs set it; rel-L2 within LSTM_RTOL) and, for contrast, on."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.models.seanet import SLSTM

    enc = config["model"]["pretransform"]["config"]["encoder"]["config"]
    width = enc["n_filters"] * 2 ** len(enc["ratios"])
    frames = config["sample_size"] // config["model"]["pretransform"]["config"]["downsampling_ratio"]
    lstm = SLSTM(width, enc["lstm"]).to(DEVICE)
    x = randn_fn(16)(TRAIN_BATCH, frames, width)
    with torch.no_grad():
        want = lstm.double()(x.double())
        lstm.float()
        errs = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.cuda.synchronize()
            start = time.perf_counter()
            got = lstm(x)
            torch.cuda.synchronize()
            errs[tf32] = (rel_err(got.double(), want), time.perf_counter() - start)
        torch.backends.cudnn.allow_tf32 = False
    log(f"  cuDNN LSTM x2 [{TRAIN_BATCH}, {frames}, {width}] fp32 vs fp64: rel-L2 {errs[False][0]:.3g} "
        f"with TF32 off ({errs[False][1]:.4f} s, tol {LSTM_RTOL}), {errs[True][0]:.3g} with it on "
        f"({errs[True][1]:.4f} s)")
    if not errs[False][0] <= LSTM_RTOL:
        raise AssertionError("cuDNN's LSTM does not compute in fp32 with TF32 off")


def flash_serving_phase(results):
    """[3f] K7 without its LSE (serving) against its plain version in fp32 at
    the ADP U-Net's self-attention shapes at 4096 latent frames under CFG
    (B 2 x 16 heads): T 4096 and 2048 at head dim 64, T 1024 at head dim 80,
    weighted by the calls per U-Net forward (2, 6 and 6), and one small
    ragged shape. Library call: SDPA on the same fp32 heads."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(10)
    r = results["flash_forward_serving"]
    t0 = SA1_SAMPLE_SIZE // 1024  # the U-Net's levels: t0, t0 / 2, t0 / 4 frames
    for bh, t, d, calls in [(32, t0, 64, 2), (32, t0 // 2, 64, 6), (32, t0 // 4, 80, 6),
                            (3, 200, 80, 0)]:
        label = f"BH{bh} T{t} D{d}"
        if calls:
            r["weight"][label] = calls
        q, k, v = (rnd(bh, t, d) for _ in range(3))
        out = torch.empty_like(q)
        bound = bound_ms(4 * bh * t * t * d, nbytes(q, k, v, out), peak=PEAK_FP32_ACCURATE)
        report(results, "flash_forward_serving", label, calls > 0, *compare(
            "flash_forward_serving", lambda: flash.flash_forward(q, k, v, save_stats=False)[0],
            lambda: flash.flash_forward_plain(q, k, v, save_stats=False)[0],
            library_fn=lambda: sdpa(q[None], k[None], v[None])), bound=bound,
            extra=f"; SDPA backend {sdpa_backend(q[None], k[None], v[None])}")
        del q, k, v, out
    log(f"  flash_forward_serving: {r['ms']:.4f} ms per SA 1.0 U-Net forward (14 calls), plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, library {r['library_ms']:.4f} ms")


def flash_bf16_phase(results):
    """[3k] K7 in bf16 (serving) against its plain version at the ADP
    U-Net's self-attention shapes in bench.py's recipe (weighted by the
    calls per U-Net forward: 2, 6, 6), a ragged T 300 with kv_len 290, and
    SA 2.0's DiT past 8192 tokens (BH 48, T 8576, kv_len 8449: 24 calls per
    DiT forward, field sa2_xl_ms), where the fp32 K7 is held against its
    plain version too. Bound: 4 T kv_len D operations per head at the bf16
    (fp32: 3xTF32) rate, or q, out and the valid keys and values once at the
    memory rate. Library: SDPA on the same heads, K/V cut to kv_len. Each
    bf16 shape also logs the kernel's time over SDPA's and the name of the
    device kernel that ran (torch.profiler), which shows the head dim's route."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(12)
    cases = [(32, t, d, None, calls, "ms") for t, d, calls in SA1_ATTENTION]
    cases += [(3, 300, 80, 290, 0, "ms"), (2 * 24, SA2_XL_T, 64, SA2_XL_KV, 24, "sa2_xl_ms")]
    for bh, t, d, kv, calls, field in cases:
        valid = kv or t
        for name, dt, peak in (("flash_forward_bf16", torch.bfloat16, PEAK_FLOPS),
                               ("flash_forward_serving", torch.float32, PEAK_FP32_ACCURATE)):
            if dt == torch.float32 and field != "sa2_xl_ms":
                continue  # the fp32 K7's U-Net shapes are [3f]'s
            label = f"BH{bh} T{t} D{d} kv_len {kv}"
            if calls:
                results[name]["weight"][label] = calls
            q, k, v = (rnd(bh, t, d).to(dt) for _ in range(3))
            kk, vv = k[:, :valid].contiguous(), v[:, :valid].contiguous()
            bound = bound_ms(4 * bh * t * valid * d, nbytes(q, q, kk, vv), peak=peak)
            kernel_fn = lambda: flash.flash_forward(q, k, v, kv, save_stats=False)[0]  # noqa: E731
            got = compare(name, kernel_fn, lambda: flash.flash_forward_plain(
                q, k, v, kv, save_stats=False)[0], reps=BF16_K7_REPS,
                library_fn=lambda: sdpa(q[None], kk[None], vv[None]))
            report(results, name, label, calls > 0, *got, bound=bound, field=field,
                   extra=f"; SDPA backend {sdpa_backend(q[None], kk[None], vv[None])}")
            if dt == torch.bfloat16:  # the device kernel the C entry chose for this head dim
                route = [n for n in device_profile([kernel_fn])[2] if "bf16_kernel" in n]
                was = EARLIER_BF16_K7_MS.get(label)
                log(f"  flash_forward_bf16 {label}: {got[4] / got[6]:.2f}x SDPA's time"
                    + ("" if was is None else f", was {was:.4f} ms ({was / got[4]:.2f}x)")
                    + f"; D {d} ran {route}")
            del q, k, v, kk, vv
    r = results["flash_forward_bf16"]
    log(f"  flash_forward_bf16: {r['ms']:.4f} ms per SA 1.0 U-Net forward (14 calls), plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, library {r['library_ms']:.4f} ms; "
        f"{r['sa2_xl_ms']:.4f} ms per SA 2.0 DiT forward at T {SA2_XL_T} (24 calls)")


def sa1_unet_bf16_phase(model, inputs, ref):
    """[4d] One forward of SA 1.0's U-Net in bench.py's bf16 recipe at 4096
    latent frames with CFG (batch 2) through the kernels (bf16 K7 at T 4096,
    2048 and 1024) and through their plain versions, on [4c]'s inputs, each
    against [4c]'s fp32 U-Net with the plain versions (`ref`): the kernels'
    error at most DIT_ERR_RATIO times the plain bf16 error; 14 bf16 K7
    launches and nothing else. Applies the recipe to `model`."""
    import torch

    x, t, cond = inputs
    bench_recipe(model)
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out_k = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
        torch.cuda.synchronize()
        wall_k = time.perf_counter() - start
        counts = read_counts()
        with plain_kernels():
            start = time.perf_counter()
            out_p = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - start
    err_k, err_p = rel_err(out_k, ref), rel_err(out_p, ref)
    log(f"  SA 1.0 U-Net forward {list(x.shape)} with CFG in bf16, rel-L2 against the fp32 U-Net: "
        f"kernels {err_k:.3g}, plain bf16 {err_p:.3g} (bound: kernels <= {DIT_ERR_RATIO} x plain); "
        f"kernels vs plain {rel_err(out_k, out_p):.3g}; wall kernels {wall_k:.4f} s, plain "
        f"{wall_p:.4f} s; launches {counts}")
    want = {name: 0 for name in KERNELS}
    want["flash_forward_bf16"] = 14
    if not (torch.isfinite(out_k).all() and err_k <= DIT_ERR_RATIO * err_p):
        raise AssertionError("the bf16 SA 1.0 U-Net with the kernels disagrees with the plain versions")
    if counts != want:
        raise AssertionError(f"one bf16 SA 1.0 U-Net forward should launch {want}: {counts}")


def sa2_xl_forward_phase(model):
    """[15b] One forward of SA 2.0's DiT (full width and depth) at 8448
    latent frames with CFG (B 2, T 8449 padded to 8576, kv_len 8449): the
    split route's K7 in fp32 against the plain versions (rel-L2
    FP32_MODEL_RTOL), then, in bench.py's bf16 recipe (applied to `model`),
    with the kernels and with the plain versions, each against the fp32
    forward with the plain versions (kernels <= DIT_ERR_RATIO x plain).
    Launches: 24 fp32 K7 serving, then 24 bf16 K7, nothing else."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(2)
    frames = SA2_XL_SAMPLE_SIZE // 2048
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner([SA2_XL_PROMPT], device=DEVICE))
        x = torch.randn(1, frames, model.io_channels, generator=g, device=DEVICE)
        t = torch.full((1,), 0.6, device=DEVICE)
        runs = {}
        for recipe in ("fp32", "bf16"):
            if recipe == "bf16":
                bench_recipe(model)
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out_k = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            counts = read_counts()
            with plain_kernels():
                out_p = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
            runs[recipe] = (out_k, out_p, counts, wall)
    (k32, p32, c32, w32), (k16, p16, c16, w16) = runs["fp32"], runs["bf16"]
    rel32, err_k, err_p = rel_err(k32, p32), rel_err(k16, p32), rel_err(p16, p32)
    log(f"  SA 2.0 DiT forward {list(x.shape)} with CFG (T {SA2_XL_T}, kv_len {SA2_XL_KV}): fp32 "
        f"kernels vs plain rel-L2 {rel32:.3g} (tol {FP32_MODEL_RTOL}), wall {w32:.4f} s; bf16 "
        f"against the fp32 plain forward: kernels {err_k:.3g}, plain bf16 {err_p:.3g} (bound: "
        f"kernels <= {DIT_ERR_RATIO} x plain), wall {w16:.4f} s; launches fp32 {c32}, bf16 {c16}")
    want32, want16 = {name: 0 for name in KERNELS}, {name: 0 for name in KERNELS}
    want32["flash_forward_serving"], want16["flash_forward_bf16"] = 24, 24
    if not (torch.isfinite(k32).all() and torch.isfinite(k16).all() and rel32 <= FP32_MODEL_RTOL
            and err_k <= DIT_ERR_RATIO * err_p):
        raise AssertionError("the SA 2.0 DiT past 8192 tokens disagrees with the plain versions")
    if c32 != want32 or c16 != want16:
        raise AssertionError(f"the SA 2.0 DiT forwards should launch {want32} and {want16}")
    return c32, c16


def long_attention_phase(results):
    """[3d] K10a (rope K once) and K10 (attention over the roped K) against
    their plain versions; K10 and its plain version take the same khat."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention

    rnd = randn_fn(5)
    for b, t, h, kv, main in [(2, LONG_T, 24, LONG_KV, True), (1, 2049, 2, None, False),
                              (2, 2176, 4, 2050, False), (1, 8192, 2, None, False)]:
        label = f"B{b} T{t} H{h} kv_len {kv}"
        valid = kv or t
        qkv = rnd(b, t, 3 * h * 64).to(torch.bfloat16)
        f = rotary_freqs(t, 32, device=DEVICE)
        khat = attention.rope_pair_k_plain(qkv, f, h)
        k_part = qkv[..., h * 64:2 * h * 64]
        ok, max_abs, rel_l2, peak, wall, plain_ms, _ = compare(
            "rope_pair_k", lambda: attention.rope_pair_k(qkv, f, h),
            lambda: attention.rope_pair_k_plain(qkv, f, h))
        # K10a's own device time: a call's wall (its tables made, then ~30 us
        # of kernel) is the host's launch rate
        by_name = device_profile([lambda: attention.rope_pair_k(qkv, f, h)] * 10)[2]
        ms = sum(v for name, v in by_name.items() if "rope_" in name)
        report(results, "rope_pair_k", label, main, ok, max_abs, rel_l2, peak, ms, plain_ms,
               bound=bound_ms(0, (nbytes(k_part) + nbytes(khat)) * valid // t + nbytes(f) * 2),
               extra=f", device time (the wrapper's wall {wall:.4f} ms)")
        q, k, v = sdpa_inputs(qkv, f, h, kv)
        qv = qkv[..., :h * 64], qkv[..., 2 * h * 64:]
        report(results, "pair_long_attention", label, main, *compare(
            "pair_long_attention", lambda: attention.pair_long_attention(qkv, khat, f, h, kv),
            lambda: attention.pair_long_attention_plain(qkv, khat, f, h, kv),
            library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
            bound=attention_bound(b, h, valid, 2, [*qv, khat], [khat]))
        del qkv, khat, q, k, v
    for name in ("rope_pair_k", "pair_long_attention"):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms per long-form generation step (24 calls at B2 T{LONG_T}), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")


def flash_bound(bh, valid, products, in_tensors, out_tensors, d=64):
    """Bound of `products` [valid x valid x d] fp32 products per head at the
    fp32-accurate rate, over the valid rows of the given tensors; also the
    time at the CUDA cores' fp32 rate."""
    flops = products * 2 * bh * valid * valid * d
    bytes_ = sum(nbytes(x) * valid // x.shape[1] for x in in_tensors + out_tensors)
    return bound_ms(flops, bytes_, peak=PEAK_FP32_ACCURATE), flops / PEAK_FP32_CORES * 1e3


def sdpa_backend(q, k, v):
    """The name of the backend PyTorch's SDPA picks for these inputs."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(q, k, v)).name
    except Exception as e:  # a private call: say what failed rather than guess
        return f"unknown ({type(e).__name__})"


def flash_phase(results):
    """[3e] K7 (forward with LSE) and K9 (the backward) against their
    plain versions in fp32 (TF32 off); K9 gets the plain forward's out and
    lse, so the compare isolates the backward, and dO is zero on the padded
    rows, as on the transformer's path. Library calls: SDPA on the same fp32
    heads with K/V sliced to kv_len, and its backward beside K9."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(6)
    for b, t, h, kv, main in [(TRAIN_BATCH, LONG_T, 24, LONG_KV, True), (1, 1424, 2, None, False),
                              (1, 200, 3, 190, False)]:
        label = f"B{b} T{t} H{h} kv_len {kv}"
        bh, valid = b * h, kv or t
        q, k, v, do = (rnd(bh, t, 64) for _ in range(4))
        if kv is not None:
            do[:, kv:] = 0
        out, lse = flash.flash_forward(q, k, v, kv)
        torch.cuda.synchronize()
        out_p, lse_p = flash.flash_forward_plain(q, k, v, kv)
        ok, max_abs, rel_l2, peak = within("flash_forward", out, out_p)
        lse_err = (lse - lse_p).abs().max().item()
        del out, lse
        ms = timed_ms(lambda: flash.flash_forward(q, k, v, kv), 3)
        plain_ms = timed_ms(lambda: flash.flash_forward_plain(q, k, v, kv), 3)
        q4 = q.view(b, h, t, 64).clone().requires_grad_(True)
        k4, v4 = (x.view(b, h, t, 64)[:, :, :valid].clone().requires_grad_(True) for x in (k, v))
        backend = sdpa_backend(q4, k4, v4)
        lib_ms = timed_ms(lambda: sdpa(q4.detach(), k4.detach(), v4.detach()), 3)
        bound, cores_ms = flash_bound(bh, valid, 2, [q, k, v], [out_p, lse_p])
        report(results, "flash_forward", label, main, ok and lse_err <= FLASH_LSE_ATOL, max_abs,
               rel_l2, peak, ms, plain_ms, lib_ms, bound=bound,
               extra=f", lse max_abs {lse_err:.3g} (tol {FLASH_LSE_ATOL}); SDPA backend {backend}; "
                     f"at the CUDA cores' fp32 rate {cores_ms:.4f} ms")

        def k9():
            return flash.flash_backward(q, k, v, out_p, lse_p, do, kv)

        def k9_plain():
            return flash.flash_backward_plain(q, k, v, out_p, lse_p, do, kv)

        got, want = k9(), k9_plain()
        rels = [rel_err(a, w) for a, w in zip(got, want)]
        pad_zero = kv is None or not any(a[:, kv:].any() for a in got)
        ok = (all(bool(torch.isfinite(a).all()) for a in got) and pad_zero
              and max(rels) <= TOL["flash_backward"][0])
        max_abs = max((a - w).abs().max().item() for a, w in zip(got, want))
        peak = max(w.abs().max().item() for w in want)
        bound, cores_ms = flash_bound(bh, valid, 5, [q, k, v, out_p, lse_p, do], list(got))
        del got, want
        o4 = sdpa(q4, k4, v4)
        g4 = do.view(b, h, t, 64)
        lib_ms = timed_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 3)
        ms = timed_ms(k9, 3)
        report(results, "flash_backward", label, main, ok, max_abs, max(rels), peak, ms,
               timed_ms(k9_plain, 3), lib_ms, bound=bound,
               extra=f" (rel-L2 of dq/dk/dv: {' '.join(f'{r:.3g}' for r in rels)}; padded rows "
                     f"zero: {pad_zero}; {ms / lib_ms:.2f}x SDPA's backward; at the CUDA cores' "
                     f"fp32 rate {cores_ms:.4f} ms)")
        del q, k, v, do, out_p, lse_p, q4, k4, v4, o4
    for name, calls in (("flash_forward", 2 * 24), ("flash_backward", 24)):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms per SA 2.0 training step ({calls} calls at B{TRAIN_BATCH} "
            f"T{LONG_T}), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms")


def flash_fused_phase(results):
    """[3g] K8 (single-pass backward) against its plain version in fp32 (TF32
    off) at SA 1.0's training shapes (B 8 x 16 heads: T 4096 and 2048 at head
    dim 64, T 1024 at head dim 80, weighted by the calls per training step),
    at a DiT shape where K8's plan fits with kv_len < T (B 2 x 24 heads, T
    1184, kv_len 1177; dO zero on the padded rows, as on the transformer's
    path) and at a small ragged one; K7 with its LSE against its plain
    version at the three SA 1.0 shapes. K8 gets the plain forward's out and
    lse. Library calls: SDPA on the same fp32 heads, and its backward."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(11)
    bh_train = TRAIN_BATCH * 16
    cases = [(bh_train, t, d, None, calls) for t, d, calls in SA1_ATTENTION]
    cases += [(48, 1184, 64, 1177, 0), (3, 200, 80, 190, 0)]
    for bh, t, d, kv, calls in cases:
        label = f"BH{bh} T{t} D{d} kv_len {kv}"
        main = calls > 0
        if main:
            results["flash_backward_fused"]["weight"][label] = calls
            results["flash_forward"]["weight"][label] = calls
        if flash.backward_kernel(t, t, d) != "K8":
            raise AssertionError(f"{label}: K8's plan does not fit; the JAX package would run K9")
        valid = kv or t
        q, k, v, do = (rnd(bh, t, d) for _ in range(4))
        if kv is not None:
            do[:, kv:] = 0
        out_p, lse_p = flash.flash_forward_plain(q, k, v, kv)
        q4 = q[None].clone().requires_grad_(True)
        k4, v4 = (x[None, :, :valid].clone().requires_grad_(True) for x in (k, v))
        backend = sdpa_backend(q4, k4, v4)
        if main:  # K7 with its LSE, as the U-Net's training forward runs it
            out, lse = flash.flash_forward(q, k, v, kv)
            torch.cuda.synchronize()
            ok, max_abs, rel_l2, peak = within("flash_forward", out, out_p)
            lse_err = (lse - lse_p).abs().max().item()
            del out, lse
            bound, cores_ms = flash_bound(bh, valid, 2, [q, k, v], [out_p, lse_p], d)
            report(results, "flash_forward", label, True, ok and lse_err <= FLASH_LSE_ATOL,
                   max_abs, rel_l2, peak, timed_ms(lambda: flash.flash_forward(q, k, v, kv), 3),
                   timed_ms(lambda: flash.flash_forward_plain(q, k, v, kv), 3),
                   timed_ms(lambda: sdpa(q4.detach(), k4.detach(), v4.detach()), 3), bound=bound,
                   field="sa1_train_ms",
                   extra=f", lse max_abs {lse_err:.3g} (tol {FLASH_LSE_ATOL}); SDPA backend "
                         f"{backend}; at the CUDA cores' fp32 rate {cores_ms:.4f} ms")

        def k8():
            return flash.flash_backward_fused(q, k, v, out_p, lse_p, do, kv)

        def k8_plain():
            return flash.flash_backward_fused_plain(q, k, v, out_p, lse_p, do, kv)

        got, want = k8(), k8_plain()
        rels = [rel_err(a, w) for a, w in zip(got, want)]
        pad_zero = kv is None or not any(a[:, kv:].any() for a in got)
        ok = (all(bool(torch.isfinite(a).all()) for a in got) and pad_zero
              and max(rels) <= TOL["flash_backward_fused"][0])
        max_abs = max((a - w).abs().max().item() for a, w in zip(got, want))
        peak = max(w.abs().max().item() for w in want)
        bound, cores_ms = flash_bound(bh, valid, 5, [q, k, v, out_p, lse_p, do], list(got), d)
        del got, want
        o4 = sdpa(q4, k4, v4)
        g4 = do[None]
        lib_ms = timed_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 3)
        report(results, "flash_backward_fused", label, main, ok, max_abs, max(rels), peak,
               timed_ms(k8, 3), timed_ms(k8_plain, 3), lib_ms, bound=bound,
               extra=f" (rel-L2 of dq/dk/dv: {' '.join(f'{r:.3g}' for r in rels)}; padded rows "
                     f"zero: {pad_zero}; SDPA backend {backend}; at the CUDA cores' fp32 rate "
                     f"{cores_ms:.4f} ms)")
        del q, k, v, do, out_p, lse_p, q4, k4, v4, o4
    per = results["flash_backward_fused"]["per"]
    for name, field in (("flash_forward", "sa1_train_ms"), ("flash_backward_fused", "ms")):
        r = results[name]
        log(f"  {name}: {r[field]:.4f} ms per {per}, plain {r['plain_' + field]:.4f} ms, bound "
            f"{r['bound_' + field]:.4f} ms, library {r['library_' + field]:.4f} ms")


def causal_bound(bh, t, products, in_tensors, out_tensors, d=64):
    """Bound of `products` causal [T x T x d] fp32 products per head, counted
    on the causal triangle (T (T + 1) / 2 query-key pairs), at the
    fp32-accurate rate, over the given tensors' bytes."""
    flops = products * 2 * bh * (t * (t + 1) // 2) * d
    return bound_ms(flops, nbytes(*in_tensors, *out_tensors), peak=PEAK_FP32_ACCURATE)


def causal_flash_phase(results):
    """[3h] The causal K7 with and without its LSE and the causal K9 against
    their plain versions in fp32 (TF32 off), at the audio LM's training shape
    (B 8 x 16 heads, T 1501, D 64: 24 calls of K7 with its LSE and of K9 per
    training step, 24 of K7 without it per no-grad forward) and at a
    non-multiple length above 1024. K9 gets the plain forward's out and lse.
    Bounds on the causal triangle: the forward's 2 products, the backward's
    5 (s, dp, dv, dk, dq: what the work needs, as [3e] counts them). Library
    calls: SDPA with is_causal on the same fp32 heads (EFFICIENT_ATTENTION),
    forward, and forward + backward beside K9 (its backward alone logged)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(14)
    for bh, t, calls in [(TRAIN_BATCH * LM_HEADS, LM_T, LM_LAYERS), (6, 1100, 0)]:
        label = f"BH{bh} T{t} D64 causal"
        main = calls > 0
        if main:
            for name in ("flash_forward_causal", "flash_forward_causal_serving",
                         "flash_backward_causal"):
                results[name]["weight"][label] = calls
        q, k, v, do = (rnd(bh, t, 64) for _ in range(4))
        q4, k4, v4 = (x[None].clone().requires_grad_(True) for x in (q, k, v))
        backend = sdpa_backend(q4, k4, v4)
        sdpa_fwd = lambda: sdpa(q4.detach(), k4.detach(), v4.detach(), is_causal=True)  # noqa: E731

        out, lse = flash.flash_forward(q, k, v, causal=True)
        torch.cuda.synchronize()
        out_p, lse_p = flash.flash_forward_plain(q, k, v, causal=True)
        ok, max_abs, rel_l2, peak = within("flash_forward_causal", out, out_p)
        lse_err = (lse - lse_p).abs().max().item()
        del out, lse
        report(results, "flash_forward_causal", label, main, ok and lse_err <= FLASH_LSE_ATOL,
               max_abs, rel_l2, peak, timed_ms(lambda: flash.flash_forward(q, k, v, causal=True), 3),
               timed_ms(lambda: flash.flash_forward_plain(q, k, v, causal=True), 3),
               timed_ms(sdpa_fwd, 3), bound=causal_bound(bh, t, 2, [q, k, v], [out_p, lse_p]),
               extra=f", lse max_abs {lse_err:.3g} (tol {FLASH_LSE_ATOL}); SDPA backend {backend}")
        report(results, "flash_forward_causal_serving", label, main, *compare(
            "flash_forward_causal_serving",
            lambda: flash.flash_forward(q, k, v, save_stats=False, causal=True)[0],
            lambda: flash.flash_forward_plain(q, k, v, save_stats=False, causal=True)[0],
            library_fn=sdpa_fwd), bound=causal_bound(bh, t, 2, [q, k, v], [out_p]),
            extra=f"; SDPA backend {backend}")

        def k9():
            return flash.flash_backward(q, k, v, out_p, lse_p, do, causal=True)

        def k9_plain():
            return flash.flash_backward_plain(q, k, v, out_p, lse_p, do, causal=True)

        got, want = k9(), k9_plain()
        rels = [rel_err(a, w) for a, w in zip(got, want)]
        ok = (all(bool(torch.isfinite(a).all()) for a in got)
              and max(rels) <= TOL["flash_backward_causal"][0])
        max_abs = max((a - w).abs().max().item() for a, w in zip(got, want))
        peak = max(w.abs().max().item() for w in want)
        bound = causal_bound(bh, t, 5, [q, k, v, out_p, lse_p, do], list(got))
        del got, want
        o4 = sdpa(q4, k4, v4, is_causal=True)
        g4 = do[None]
        sdpa_bwd_ms = timed_ms(
            lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 3)

        def sdpa_fwd_bwd():
            o = sdpa(q4, k4, v4, is_causal=True)
            return torch.autograd.grad(o, (q4, k4, v4), g4)

        ms = timed_ms(k9, 3)
        report(results, "flash_backward_causal", label, main, ok, max_abs, max(rels), peak, ms,
               timed_ms(k9_plain, 3), timed_ms(sdpa_fwd_bwd, 3), bound=bound,
               extra=f" (rel-L2 of dq/dk/dv: {' '.join(f'{r:.3g}' for r in rels)}; SDPA "
                     f"backend {backend}, its forward + backward as the library time, its "
                     f"backward alone {sdpa_bwd_ms:.4f} ms: {ms / sdpa_bwd_ms:.2f}x)")
        del q, k, v, do, out_p, lse_p, q4, k4, v4, o4
    for name in ("flash_forward_causal", "flash_forward_causal_serving", "flash_backward_causal"):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms per {r['per']}, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, library {r['library_ms']:.4f} ms")


def graph_ms(fns, rounds=5):
    """Device time per call of `fns`, called in turn for `rounds` rounds, as
    one CUDA-graph replay timed with CUDA events: the host's launch cost,
    which bounds a back-to-back timing of calls of some microseconds, does
    not count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    return timed_ms(graph.replay, 3) / (rounds * len(fns))


# K13 at the main paths' shapes: (M, K, inner, Kout, dtype name, label);
# the LM's decode (M 2: one row and its CFG twin, 24 calls per decode step)
# and SAO's generation (M 2050: CFG batch 2 x 1025 tokens, 24 calls per CFG
# step with fused_mlp) are the two routes' main-path shapes
K13_CASES = [
    (2, 1024, 4096, 1024, "fp32", "M2 K1024 inner4096 Kout1024 fp32 (LM decode)"),
    (16, 1024, 4096, 1024, "fp32", "M16 K1024 inner4096 Kout1024 fp32"),
    (2050, 1536, 6144, 1536, "bf16", "M2050 K1536 inner6144 Kout1536 bf16 (SAO generation)"),
    (2080, 1536, 6144, 1536, "bf16", "M2080 K1536 inner6144 Kout1536 bf16 (SAO DiT, training pad)"),
    (2080, 1536, 6144, 1536, "fp32", "M2080 K1536 inner6144 Kout1536 fp32"),
]
K13_MAIN = {"glu_mlp": K13_CASES[0][5], "glu_mlp_tensor": K13_CASES[2][5]}
# the earlier K13 (FFMA on the CUDA cores) and the unfused cuBLAS chain in
# the same run, ms per call (PERF.md §6; chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W)
EARLIER_K13 = {K13_CASES[0][5]: (0.0445, 0.0386), K13_CASES[1][5]: (0.0830, 0.0892),
               K13_CASES[3][5]: (10.7117, 0.3665)}


def glu_mlp_phase(results):
    """[3i] K13 against its plain version through the route `mlp.route`
    names at each shape of K13_CASES: fp32 at the audio LM's decode (M 2,
    the streaming route) and at M 16; bf16 at SAO's DiT in generation (M
    2050) and at the training pad (M 2080), fp32 at M 2080 (the tensor-core
    route). Bound: the weights, x and y read or written once (bytes), or the
    three products at the bf16 or fp32-accurate rate. The library time is
    the unfused chain on cuBLAS (F.linear, silu * mul, F.linear; TF32 off),
    which no single PyTorch call replaces. Times are device time per call
    under torch.profiler (`device_profile`: the sum of a call's kernels, so
    the host's launch cost does not count), the calls cycling through
    weight sets that together exceed the 50 MB L2 twice, as the model reads
    a new layer's weights at every call; the tensor-core route's time is
    split into the fp32 weights' tf32 parts, GEMM1 and GEMM2. Each line
    names the route, its plan (tile widths and blocks) and the earlier
    CUDA-core K13's figures."""
    import torch
    import torch.nn.functional as F

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import mlp

    rnd = randn_fn(17)
    results["glu_mlp"]["weight"][K13_MAIN["glu_mlp"]] = LM_LAYERS
    results["glu_mlp_tensor"]["weight"][K13_MAIN["glu_mlp_tensor"]] = 24
    for m, k, inner, kout, dt_name, label in K13_CASES:
        dt = torch.float32 if dt_name == "fp32" else torch.bfloat16
        x = rnd(m, k).to(dt)
        per_set = inner * (2 * k + kout) * x.element_size()
        sets = [(rnd(2 * inner, k, scale=k ** -0.5).to(dt), rnd(2 * inner, scale=0.1),
                 rnd(kout, inner, scale=inner ** -0.5).to(dt))
                for _ in range(max(1, math.ceil(100e6 / per_set)))]

        def chain(x, w_in, b_in, w_out):
            v, g = F.linear(x, w_in, b_in.to(dt)).chunk(2, dim=-1)
            return F.linear(v * F.silu(g), w_out)

        route = mlp.route(m, k, inner, kout, dt)
        entry = "glu_mlp" if route == "stream" else "glu_mlp_tensor"
        y = torch.empty(m, kout, device=DEVICE, dtype=dt)
        flops = 2 * m * k * 2 * inner + 2 * m * inner * kout
        bound = bound_ms(flops, nbytes(x, *sets[0], y), peak=PEAK_FLOPS if dt_name == "bf16"
                         else PEAK_FP32_ACCURATE)
        del y
        tol = "glu_mlp" if dt_name == "fp32" else "glu_mlp_bf16"
        rounds = 5 if m <= 16 else 2
        with torch.no_grad():
            out = mlp.glu_mlp(x, *sets[0])
            torch.cuda.synchronize()
            checked = within(tol, out, mlp.glu_mlp_plain(x, *sets[0]))
            del out
            times = {}
            for name, fn in (("kernel", mlp.glu_mlp), ("plain", mlp.glu_mlp_plain),
                             ("library", chain)):
                calls = [lambda fn=fn, ws=ws: fn(x, *ws) for ws in sets] * rounds
                times[name] = device_profile(calls)
        if route == "stream":
            sp = mlp.stream_plan(x.device, m, k, inner, kout, dt)
            plan = (f"M tile {sp['m_tile']}, {sp['blocks']} blocks, {sp['outputs']} outputs each, "
                    f"{sp['stages']} stages")
        else:
            tp_ = mlp.tensor_plan(m, inner, kout, dt)
            plan = (f"GEMM1 N {tp_['glu_n']} ({tp_['glu_blocks']} blocks), GEMM2 N {tp_['out_n']} "
                    f"({tp_['out_blocks']} blocks)")
            parts = {"tf32 split": "tf32_split_kernel", "GEMM1": "glu_gemm_kernel",
                     "GEMM2": "out_gemm_kernel"}
            by_name = times["kernel"][2]
            plan += "; " + ", ".join(
                f"{part} {sum(ms for n, ms in by_name.items() if key in n):.4f} ms"
                for part, key in parts.items() if any(key in n for n in by_name))
        was = EARLIER_K13.get(label)
        extra = (f"; route {route}: {plan}; device time per call" +
                 ("" if was is None else f"; earlier CUDA-core K13: {was[0]:.4f} ms (cuBLAS chain {was[1]:.4f} ms)"))
        results[entry]["weight"].setdefault(label, 1)
        report(results, entry, label, label == K13_MAIN[entry], *checked, times["kernel"][0],
               times["plain"][0], times["library"][0], bound=bound, tol_name=tol, extra=extra)
        del x, sets
    for entry in ("glu_mlp", "glu_mlp_tensor"):
        r = results[entry]
        log(f"  {entry}: {r['ms']:.4f} ms per {r['per']}, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, unfused cuBLAS chain {r['library_ms']:.4f} ms; card {smi_line()}")


def seanet_decode_steps(config):
    """The kernel calls of one SEANet decode of `config`'s frames (batch 1),
    in order: ("k2", T, Cin, Cout, k) for conv_in, each block's residual
    convs (k 3 to half the width, k 1 back) and conv_out; ("k4", T, Cin,
    Cout, stride) for the upsamples at an even stride (an odd one is a plain
    transposed conv of length (T - 1) s - 2 ceil(s / 2) + 2 s). Returns the
    calls and the audio length."""
    ae = config["model"]["pretransform"]["config"]
    dec = ae["decoder"]["config"]
    if dec.get("n_residual_layers", 1) != 1:
        raise AssertionError("the K2 shapes below assume one residual layer per block")
    t = config["sample_size"] // ae["downsampling_ratio"]
    ch = dec["n_filters"] * 2 ** len(dec["ratios"])
    calls = [("k2", t, dec["dimension"], ch, dec.get("kernel_size", 7))]
    for s in dec["ratios"]:
        if s % 2 == 0:
            calls.append(("k4", t, ch, ch // 2, s))
            t = t * s
        else:
            t = (t - 1) * s - 2 * math.ceil(s / 2) + 2 * s
        ch //= 2
        calls += [("k2", t, ch, ch // 2, dec.get("residual_kernel_size", 3)),
                  ("k2", t, ch // 2, ch, 1)]
    calls.append(("k2", t, ch, dec["channels"], dec.get("last_kernel_size", 7)))
    return calls, t


def seanet_decode_conv_phase(results, config):
    """[3i] The fp32 K2 and K4 at every shape of the audio LM's token decode
    (musicgen_small_32khz.json: 1500 frames to 959,992 samples, batch 1; an
    ELU before each conv, no snake), under `lm_decode_ms`: 10 K2 and 3 K4
    launches per generation."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    rnd = randn_fn(18)
    calls, _ = seanet_decode_steps(config)
    for kind, t, cin, cout, k in calls:
        x = rnd(1, t, cin, scale=0.5)
        bb = rnd(cout, scale=0.1)
        if kind == "k2":
            w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
            conv_case(results, "snake_conv1d", f"SEANet decode B1 T{t} {cin}->{cout} k{k}",
                      "lm_decode_ms", x, w, bb, None, None,
                      lambda: conv1d.snake_conv1d(x, w, bb),
                      lambda xs: conv1d.snake_conv1d_plain(xs, w, bb),
                      2 * t * cin * cout * k, halo=(k - 1) // 2)
        else:
            w = rnd(2 * k, cin, cout, scale=1 / math.sqrt(2 * cin))
            conv_case(results, "snake_conv_transpose1d", f"SEANet decode B1 T{t} {cin}->{cout} s{k}",
                      "lm_decode_ms", x, w, bb, None, None,
                      lambda: conv1d.snake_conv_transpose1d(x, w, bb, stride=k),
                      lambda xs: conv1d.snake_conv_transpose1d_plain(xs, w, bb, stride=k),
                      2 * t * k * cin * cout * 2, halo=1, up=k, stride=k)
        del x
    for name, kind in (("snake_conv1d", "k2"), ("snake_conv_transpose1d", "k4")):
        log_conv_path(results, name, torch.float32, "lm_decode_ms",
                      f"audio LM token decode ({sum(c[0] == kind for c in calls)} calls)")


def elementwise_phase(results):
    """[3j] K11 (`ln_modulate`) and K12 (`gated_residual`) against their
    plain chains (one bf16 rounding apart: the chain rounds 1 - gate and the
    sigmoid where K12 does not) and against the Pallas kernels' own order of
    fp32 math and bf16 roundings (`*_kernel_math`: at most one bf16 step,
    where fp32 sums in another order cross a rounding boundary), at the
    adaLN DiT's shape (B 2 = CFG, T 1024, D 1536: 48 calls of each per
    denoising step) with a bf16 gamma as the bf16 recipe gives it, K11 also
    without gamma (the fix_scale form), and at a ragged [3, 777, 1536]. The
    scale, shift and gate are chunks of one [B, 1, 6D] projection, as the
    DiT hands them over. Bound: each [B, T, D] tensor read or written once
    at 3.35 TB/s. Calls last microseconds, so each is timed as CUDA-graph
    replays (`graph_ms`) cycling through as many input sets as make x (K11)
    or y (K12) alone at least twice the card's L2 cache, every call's output
    kept to the end of the capture so that no two calls write one buffer;
    no single PyTorch call computes either function."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import elementwise as ew

    rnd = randn_fn(23)
    d = ADALN_DIM
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    main_label = f"B2 T{ADALN_T} D{d}"
    for name in ("ln_modulate", "gated_residual"):
        results[name]["weight"][main_label] = 2 * ADALN_LAYERS
    cases = [("ln_modulate", 2, ADALN_T, "bf16"), ("ln_modulate", 2, ADALN_T, None),
             ("ln_modulate", 3, 777, "bf16"), ("gated_residual", 2, ADALN_T, None),
             ("gated_residual", 3, 777, None)]
    for name, b, t, gamma in cases:
        lnmod = name == "ln_modulate"
        sets = []
        for _ in range(max(2, -(-2 * l2 // (b * t * d * 2)))):
            x = rnd(b, t, d).to(torch.bfloat16)
            scale, shift, gate = (rnd(b, 1, 6 * d, scale=0.3).to(torch.bfloat16)
                                  .chunk(6, dim=-1)[:3])
            if lnmod:
                g = None if gamma is None else (1 + rnd(d, scale=0.1)).to(torch.bfloat16)
                sets.append((x, g, scale, shift))
            else:
                sets.append((x, gate, rnd(b, t, d).to(torch.bfloat16)))
        kernel = ew.ln_modulate if lnmod else ew.gated_residual
        plain = ew.ln_modulate_plain if lnmod else ew.gated_residual_plain
        math_ref = ew.ln_modulate_kernel_math if lnmod else ew.gated_residual_kernel_math
        label = f"B{b} T{t} D{d}" + (" gamma None" if lnmod and gamma is None else "")
        with torch.no_grad():
            out = kernel(*sets[0])
            torch.cuda.synchronize()
            checked = within(name, out, plain(*sets[0]))
            m_ok, m_abs, m_rel, _ = within(name + "_kernel_math", out, math_ref(*sets[0]))
            bound = bound_ms(0, nbytes(*sets[0], out))
            del out
            times = []
            for fn in (kernel, plain):
                kept = []
                times.append(graph_ms([lambda s=s, fn=fn, kept=kept: kept.append(fn(*s))
                                       for s in sets]))
            del kept
        extra = (f"; against the Pallas kernel's arithmetic max_abs {m_abs:.4g} rel_l2 {m_rel:.3g} "
                 f"tol {TOL[name + '_kernel_math']} {'OK' if m_ok else 'FAIL'}; CUDA-graph replays")
        if not m_ok:
            raise AssertionError(f"{name} {label} disagrees with the Pallas kernel's arithmetic")
        report(results, name, label, label == main_label, *checked, *times, None, bound=bound,
               extra=extra)
        del sets
    for name in ("ln_modulate", "gated_residual"):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms per {r['per']}, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, library none")


LM_PROMPT = {"prompt": "An upbeat synthwave track with punchy drums and a soaring lead"}
LM_CFG, LM_TOP_K, LM_TEMP = 3.0, 250, 1.0
LM_DECODE_STEPS = 64


def lm_cond_inputs(model):
    """The CFG-doubled conditioning of LM_PROMPT: T5, then the zeroed twin."""
    import torch

    cond = model.conditioner([LM_PROMPT], device=DEVICE)
    ctx = model.get_conditioning_inputs(cond)["cross_attn_cond"]
    return torch.cat([ctx, torch.zeros_like(ctx)])


def set_fused_mlp(model, on):
    from friendly_stable_audio_tools_tpu_torch.models.transformer import FeedForward

    for m in model.modules():
        if isinstance(m, FeedForward):
            m.fused_mlp = on


def lm_frames(config):
    """Frames of the config's clip: 1500 for 30 s at 32 kHz, ratio 640."""
    return config["sample_size"] // config["model"]["pretransform"]["config"]["downsampling_ratio"]


PROFILE_STEPS = 16


def device_profile(calls):
    """torch.profiler (device activity only) over the callables `calls`, run
    in order: the device's busy time per call (kernels, copies and fills on
    the one stream, which do not overlap), its activities per call, and its
    time per call by activity name, in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    by_name = {}
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / len(calls)
    return sum(by_name.values()), len(device) / len(calls), by_name


def profile_decode(lm, tokens, ctx, length):
    """`device_profile` over PROFILE_STEPS decode_step calls after a prefill
    (the first steps of `tokens`, a fresh cache): busy ms and activities per
    step, and the five largest activities by time per step."""
    import torch

    caches = lm.init_cache(2, length)
    with torch.no_grad():
        lm.decode_step(tokens[..., :1], caches, cross_attn_cond=ctx)
        busy, n, by_name = device_profile(
            [lambda i=i: lm.decode_step(tokens[..., i:i + 1], caches, cross_attn_cond=ctx)
             for i in range(1, PROFILE_STEPS + 1)])
    return busy, n, sorted(by_name.items(), key=lambda kv: -kv[1])[:5]


def lm_decode_phase(model, config):
    """[13b] The cached decode at full width (musicgen_small_32khz.json, random
    de-zeroed weights): a prefill of the special token, then 63 single-token
    steps of fixed random tokens at CFG batch 2 through a cache of the
    generation's 1504 steps, with the fused MLP off and then on (the same
    model, its FeedForwards switched): every step's logits within rel-L2
    1e-5; K13 launches one per layer and decode_step call with the switch
    on, none off, and no other kernel in either. The walls per step come from four runs
    in turns (off, on, on, off), then a profiled window of each
    (`profile_decode`): the device's busy share of the unprofiled step.
    Returns the walls per step in ms, {on: [first, second]}."""
    import torch

    lm = model.model
    pattern = model.pattern_provider.get_pattern(lm_frames(config))
    length = len(pattern.layout)
    g = torch.Generator(device=DEVICE).manual_seed(19)
    tokens = torch.randint(0, model.codebook_size, (1, model.num_quantizers, LM_DECODE_STEPS),
                           generator=g, device=DEVICE)
    tokens[..., :pattern.get_first_step_with_timesteps(0)] = model.masked_token_id
    tokens = torch.cat([tokens, tokens])
    ctx = lm_cond_inputs(model)
    runs, walls, prof = {}, {False: [], True: []}, {}
    for on in (False, True, True, False):  # in turns: the host's speed drifts
        set_fused_mlp(model, on)
        caches = lm.init_cache(2, length)
        logits, counts = [], []
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.no_grad():
            for i in range(LM_DECODE_STEPS):
                reset_counts()
                out, caches = lm.decode_step(tokens[..., i:i + 1], caches, cross_attn_cond=ctx)
                counts.append(read_counts())
                logits.append(out)
        torch.cuda.synchronize()
        walls[on].append((time.perf_counter() - start) / LM_DECODE_STEPS * 1e3)
        runs.setdefault(on, (logits, counts))
        del caches, logits
    for on in (False, True):
        set_fused_mlp(model, on)
        prof[on] = profile_decode(lm, tokens, ctx, length)
    set_fused_mlp(model, False)
    errs = [rel_err(a, b) for a, b in zip(runs[True][0], runs[False][0])]
    log(f"  {LM_DECODE_STEPS} decode_step calls at CFG batch 2 (cache of {length} steps): logits with "
        f"K13 vs the unfused chain rel-L2 max {max(errs):.3g} (tol 1e-5), first {errs[0]:.3g}, last "
        f"{errs[-1]:.3g}; wall per step (host clock, one sync at the end), in turns off, on, on, "
        f"off: {walls[False][0]:.3f}, {walls[True][0]:.3f}, {walls[True][1]:.3f}, "
        f"{walls[False][1]:.3f} ms")
    for on in (False, True):
        busy, n_kernels, top = prof[on]
        wall = statistics.mean(walls[on])
        log(f"  profiled {PROFILE_STEPS} steps, fused MLP {'on' if on else 'off'}: device busy "
            f"{busy:.3f} ms per step = {busy / wall:.1%} of the unprofiled wall per step "
            f"(idle {1 - busy / wall:.1%}); {n_kernels:.0f} device activities per step; "
            f"largest: " + ", ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in top))
    if not (max(errs) <= 1e-5 and all(torch.isfinite(x).all() for x in runs[True][0])):
        raise AssertionError("the cached decode with K13 disagrees with the unfused chain")
    for on in (False, True):
        want = {name: 0 for name in KERNELS}
        want["glu_mlp"] = config["model"]["lm"]["config"]["depth"] if on else 0
        bad = [c for c in runs[on][1] if c != want]
        if bad:
            raise AssertionError(f"decode_step launches {bad[0]}, expected {want} (fused {on})")
    return walls


def lm_generation_phase(model, config, fused):
    """[13] `generate_audio` on musicgen_small_32khz.json as written (random
    de-zeroed weights, seed 0, the hash tokenizer): one prompt, 1500 frames
    (1504 steps of the delay pattern: 1 prefill, 1503 decode steps), CFG 3,
    top_k 250, temperature 1, batch 1, fp32 with TF32 off. Walls (each phase
    ended by a synchronize): T5, the prefill, the decode loop, the token
    decode (`decode_tokens`: RVQ lookups, the SEANet decoder through the
    fp32 K2 and K4), the total; s-audio/s; peak memory. Checks: codes in [0,
    2048), finite audio of the decoder's length, and the launch counts
    (K13 one per layer and decode_step call with the switch on, else none;
    fp32 K2 10 and K4 3; nothing else). Returns the counts."""
    import numpy as np
    import torch

    calls, n_samples = seanet_decode_steps(config)
    marks, codes_seen = {}, []
    real_cond = model.conditioner.forward
    real_step = model.model.decode_step
    real_decode = model.pretransform.decode_tokens

    def cond(*a, **kw):
        out = real_cond(*a, **kw)
        torch.cuda.synchronize()
        marks["cond"] = time.perf_counter()
        return out

    def step(*a, **kw):
        out = real_step(*a, **kw)
        if "prefill" not in marks:
            torch.cuda.synchronize()
            marks["prefill"] = time.perf_counter()
        return out

    def decode(codes):
        torch.cuda.synchronize()
        marks["loop"] = time.perf_counter()
        codes_seen.append(codes)
        return real_decode(codes)

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with patched([(model.conditioner, "forward", cond), (model.model, "decode_step", step),
                  (model.pretransform, "decode_tokens", decode)]):
        torch.cuda.synchronize()
        start = time.perf_counter()
        audio = model.generate_audio(max_gen_len=lm_frames(config), conditioning=[LM_PROMPT],
                                     cfg_scale=LM_CFG, top_k=LM_TOP_K, temp=LM_TEMP,
                                     generator=gen)
        torch.cuda.synchronize()
        end = time.perf_counter()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    codes = codes_seen[0]
    steps = len(model.pattern_provider.get_pattern(lm_frames(config)).layout)
    seconds = n_samples / config["sample_rate"]
    walls = {"T5": marks["cond"] - start, "prefill": marks["prefill"] - marks["cond"],
             "decode loop": marks["loop"] - marks["prefill"], "token decode": end - marks["loop"]}
    total = end - start
    log(f"  fused MLP {'on' if fused else 'off'}: " + ", ".join(f"{k} {v:.4f} s" for k, v in walls.items())
        + f"; {walls['decode loop'] / (steps - 1) * 1e3:.3f} ms per decode step ({steps - 1} steps); "
        f"total {total:.4f} s = {seconds / total:.3f} s-audio/s ({n_samples} samples, {seconds} s); "
        f"peak {peak:.2f} GiB")
    c = codes.cpu().numpy()
    log(f"  codes {list(codes.shape)} in [{c.min()}, {c.max()}], {len(np.unique(c))} distinct; audio "
        f"{list(audio.shape)} rms {audio.float().pow(2).mean().sqrt().item():.4g}; launches {counts}")
    if not (codes.shape == (1, model.num_quantizers, lm_frames(config)) and c.min() >= 0
            and c.max() < model.codebook_size):
        raise AssertionError("generated codes out of range or unknown tokens left")
    if not (audio.shape == (1, 1, n_samples) and torch.isfinite(audio).all()):
        raise AssertionError(f"audio {tuple(audio.shape)} is not finite [1, 1, {n_samples}]")
    want = {name: 0 for name in KERNELS}
    want.update(glu_mlp=config["model"]["lm"]["config"]["depth"] * steps if fused else 0,
                snake_conv_transpose1d_f32=sum(k == "k4" for k, *_ in calls),
                **k2_counts([(cin, cout, k) for kind, _, cin, cout, k in calls if kind == "k2"],
                            torch.float32))
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return counts


def build_model(config, fused_mlp=False, fused_ew=False):
    """A model on the card in fp32: random weights, seed 0, de-zeroed."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.utils.common import dezero_

    model = create_model_from_config(config, seed=0, device=DEVICE, fused_mlp=fused_mlp,
                                     fused_ew=fused_ew)
    return dezero_(model, torch.Generator(device=DEVICE).manual_seed(1))


def synthetic_audio(seed, n_samples, sample_rate=44100):
    """[2, n] float32 in [-1, 1]: three sines per channel and a little noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(n_samples, dtype=np.float64) / sample_rate
    out = np.zeros((2, n_samples), np.float32)
    for ch in range(2):
        for _ in range(3):
            out[ch] += 0.15 * np.sin(2 * np.pi * rng.uniform(40, 4000) * t + rng.uniform(0, 6.3))
        out[ch] += 0.02 * rng.randn(n_samples)
    return np.clip(out, -1, 1)


def plain_pair_attention(qkv, freqs, num_heads, kv_len=None):
    """The training attention in plain torch: the K5/K6 plain versions in
    bf16 behind the same autograd binding as the kernels (phase 6's bf16
    yardstick)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention

    class PlainPair(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            xb = x.to(torch.bfloat16)
            out, lse = attention.fused_qkv_rope_attention_stats_plain(xb, freqs, num_heads, kv_len)
            ctx.save_for_backward(xb, out, lse)
            return out.to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            xb, out, lse = ctx.saved_tensors
            return attention.fused_qkv_rope_attention_backward_plain(
                xb, out, lse, g.to(torch.bfloat16), freqs, num_heads, kv_len, dtype=torch.float32)

    return PlainPair.apply(qkv)


def dit_train_setup(config, tmp, prompt):
    """The de-zeroed fp32 model of `config` (its DiT saved to tmp for the
    train CLI), fixed draws at batch 8 over the config's sample size, and a
    training-step function returning (loss, the gradients of layers 0, 11
    and 23's self-attention projections). Returns (step, depth, dit path)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.training.diffusion import get_alphas_sigmas

    model = build_model(config)
    dit_path = Path(tmp) / "dit_dezeroed.pt"
    torch.save({f"model.{k}": v for k, v in model.model.state_dict().items()}, dit_path)
    rnd = randn_fn(3)
    conds = [dict(prompt, seconds_start=i, seconds_total=prompt["seconds_total"] - i)
             for i in range(TRAIN_BATCH)]
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner(conds, device=DEVICE))
    latent_shape = (TRAIN_BATCH, config["sample_size"] // model.pretransform.downsampling_ratio,
                    model.io_channels)
    x0 = rnd(*latent_shape)
    noise = rnd(*x0.shape)
    t = torch.rand(TRAIN_BATCH, generator=torch.Generator(device=DEVICE).manual_seed(4),
                   device=DEVICE)
    alphas, sigmas = (v[:, None, None] for v in get_alphas_sigmas(t))
    noised, targets = x0 * alphas + noise * sigmas, noise * alphas - x0 * sigmas
    dit = model.model.train()
    del model
    depth = len(dit.transformer.layers)
    watched = {f"layers.{i}.{p}": getattr(dit.transformer.layers[i].self_attn, p).weight
               for i in (0, depth // 2 - 1, depth - 1) for p in ("to_qkv", "to_out")}

    def step():
        dit.zero_grad(set_to_none=True)
        loss = (dit(noised, t, **cond) - targets).square().mean()
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: w.grad.detach().clone() for k, w in watched.items()}

    return step, depth, dit_path


def dit_train_step_phase(config, tmp):
    """[6] One training step of the fp32 DiT at batch 8 (fixed draws): the
    attention through K5/K6, through their plain versions in bf16, and in
    fp32 plain (the reference). Saves the de-zeroed DiT for phase 7."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention

    step, depth, dit_path = dit_train_setup(config, tmp, PROMPT)
    reset_counts()
    start = time.perf_counter()
    loss_k, grads_k = step()
    wall_k = time.perf_counter() - start
    counts = read_counts()
    with patched([(attention, "fused_qkv_rope_attention", plain_pair_attention)]):
        loss_p, grads_p = step()
    with patched([(attention, "fused_qkv_rope_attention", attention.fused_qkv_rope_attention_plain)]):
        loss_r, grads_r = step()
    del step
    torch.cuda.empty_cache()

    for k in grads_k:
        log(f"  {k} grad rel-L2 against fp32 attention: kernels {rel_err(grads_k[k], grads_r[k]):.3g}, "
            f"plain bf16 {rel_err(grads_p[k], grads_r[k]):.3g}; kernels vs plain "
            f"{rel_err(grads_k[k], grads_p[k]):.3g}")
    cat = lambda g: torch.cat([v.flatten() for v in g.values()])  # noqa: E731
    err_k, err_p = rel_err(cat(grads_k), cat(grads_r)), rel_err(cat(grads_p), cat(grads_r))
    log(f"  loss: kernels {loss_k:.7g}, plain bf16 {loss_p:.7g}, fp32 attention {loss_r:.7g}; "
        f"watched gradients rel-L2: kernels {err_k:.3g}, plain bf16 {err_p:.3g} (bound: kernels <= "
        f"{DIT_ERR_RATIO} x plain); step wall with kernels {wall_k:.3f} s; launches {counts}")
    loss_ok = abs(loss_k - loss_r) <= max(DIT_ERR_RATIO * abs(loss_p - loss_r), 1e-5 * abs(loss_r))
    finite = all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads_k.values())
    if not (finite and loss_ok and err_k <= DIT_ERR_RATIO * err_p):
        raise AssertionError("the DiT training step with the kernels disagrees with the plain versions")
    if (counts["fused_qkv_rope_attention_stats"] != 2 * depth
            or counts["fused_qkv_rope_attention_backward"] != depth
            or counts["rope_pair_k"] != 4 * depth):
        raise AssertionError(f"one checkpointed step should launch K5 {2 * depth}, K6 {depth} and "
                             f"K10a {4 * depth} times: {counts}")
    return dit_path


def sa2_dit_train_step_phase(config, tmp):
    """[6b] One training step of SA 2.0's fp32 DiT at batch 8 and 6144 latent
    frames (T 6272, kv_len 6145; fixed draws): the attention through K7/K9
    (the unpack route), through their plain versions in fp32 (the
    reference), and through the bf16 K5/K6 route forced, which the port ran
    at every length before it routed as the JAX package does. Saves the
    de-zeroed DiT for phase 9; returns the kernels' launch counts."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    step, depth, dit_path = dit_train_setup(config, tmp, SA2_PROMPT)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    loss_k, grads_k = step()
    wall_k = time.perf_counter() - start
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with patched([(flash, "flash_forward", flash.flash_forward_plain),
                  (flash, "flash_backward", flash.flash_backward_plain)]):
        start = time.perf_counter()
        loss_r, grads_r = step()
        wall_r = time.perf_counter() - start
    with patched([(attention, "training_route", lambda *a: "pair")]):
        loss_o, grads_o = step()
    del step
    torch.cuda.empty_cache()

    errs = {k: rel_err(grads_k[k], grads_r[k]) for k in grads_k}
    for k in grads_k:
        log(f"  {k} grad rel-L2 against the fp32 plain step: kernels {errs[k]:.3g}, old bf16 route "
            f"{rel_err(grads_o[k], grads_r[k]):.3g}")
    cat = lambda g: torch.cat([v.flatten() for v in g.values()])  # noqa: E731
    loss_err = abs(loss_k - loss_r) / abs(loss_r)
    log(f"  loss: kernels {loss_k:.8g}, fp32 plain {loss_r:.8g} (rel {loss_err:.3g}, tol "
        f"{SA2_LOSS_RTOL}), old bf16 route {loss_o:.8g} (rel {abs(loss_o - loss_r) / abs(loss_r):.3g}); "
        f"watched gradients rel-L2: kernels {rel_err(cat(grads_k), cat(grads_r)):.3g} (tol "
        f"{SA2_GRAD_RTOL} each), old bf16 route {rel_err(cat(grads_o), cat(grads_r)):.3g}")
    log(f"  step wall: kernels {wall_k:.3f} s, fp32 plain {wall_r:.3f} s; peak memory of the DiT "
        f"step with the kernels (weights, gradients, no optimizer state) {peak:.2f} GiB; "
        f"launches {counts}")
    finite = all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads_k.values())
    if not (finite and loss_err <= SA2_LOSS_RTOL and max(errs.values()) <= SA2_GRAD_RTOL):
        raise AssertionError("the SA 2.0 DiT training step with K7/K9 disagrees with the fp32 plain step")
    want = {name: 0 for name in KERNELS}
    want.update(flash_forward=2 * depth, flash_backward=depth)
    if counts != want:
        raise AssertionError(f"one checkpointed SA 2.0 step should launch {want}: {counts}")
    return dit_path, counts


KERNELS = {  # name -> (module attribute holding its launch count)
    "fused_qkv_rope_attention": ("attention", "launches"),
    "rope_pair_k": ("attention", "rope_k_launches"),
    "pair_long_attention": ("attention", "long_launches"),
    "fused_qkv_rope_attention_stats": ("attention", "stats_launches"),
    "fused_qkv_rope_attention_backward": ("attention", "backward_launches"),
    "flash_forward": ("flash", "forward_launches"),
    "flash_backward": ("flash", "backward_launches"),
    "flash_backward_fused": ("flash", "fused_backward_launches"),
    "snake_conv1d": ("conv1d", "snake_conv1d_launches"),
    "snake_conv1d_wide": ("conv1d", "snake_conv1d_wide_launches"),
    "fused_residual_unit": ("conv1d", "fused_residual_unit_launches"),
    "snake_conv_transpose1d": ("conv1d", "snake_conv_transpose1d_launches"),
    "flash_forward_serving": ("flash", "serving_launches"),
    "flash_forward_bf16": ("flash", "serving_bf16_launches"),
    "snake_conv1d_f32": ("conv1d", "snake_conv1d_f32_launches"),
    "snake_conv1d_wide_f32": ("conv1d", "snake_conv1d_wide_f32_launches"),
    "fused_residual_unit_f32": ("conv1d", "fused_residual_unit_f32_launches"),
    "snake_conv_transpose1d_f32": ("conv1d", "snake_conv_transpose1d_f32_launches"),
    "flash_forward_causal": ("flash", "causal_forward_launches"),
    "flash_forward_causal_serving": ("flash", "causal_serving_launches"),
    "flash_backward_causal": ("flash", "causal_backward_launches"),
    "glu_mlp": ("mlp", "stream_launches"),
    "glu_mlp_tensor": ("mlp", "tensor_launches"),
    "ln_modulate": ("elementwise", "lnmod_launches"),
    "gated_residual": ("elementwise", "gres_launches"),
    "flash_forward_d32": ("flash", "d32_launches"),
    "flash_backward_fused_d32": ("flash", "d32_fused_backward_launches"),
    "flash_backward_d32": ("flash", "d32_backward_launches"),
    "flash_rope_attention": ("flash", "rope_launches"),
    "flash_forward_d128": ("flash", "d128_launches"),
    "flash_backward_fused_d128": ("flash", "d128_fused_backward_launches"),
}


# the kernels no bf16 generation of the DiT launches: the training
# attention, the fp32 attention and convolutions
NO_TRAINING = {"fused_qkv_rope_attention_stats": 0, "fused_qkv_rope_attention_backward": 0,
               "flash_forward": 0, "flash_backward": 0, "flash_backward_fused": 0,
               "flash_forward_serving": 0, "flash_forward_bf16": 0, "snake_conv1d_f32": 0,
               "snake_conv1d_wide_f32": 0, "fused_residual_unit_f32": 0,
               "snake_conv_transpose1d_f32": 0}


def _kernel_modules():
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention, conv1d, elementwise, mlp
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention

    return {"attention": attention, "conv1d": conv1d, "flash": flash_attention, "mlp": mlp,
            "elementwise": elementwise}


def reset_counts():
    mods = _kernel_modules()
    for mod, attr in KERNELS.values():
        setattr(mods[mod], attr, 0)


def read_counts():
    mods = _kernel_modules()
    return {name: getattr(mods[mod], attr) for name, (mod, attr) in KERNELS.items()}


def train_args(config, tmp, name, n_wavs, seconds, dit_path=None):
    """Writes `n_wavs` synthetic WAVs of `seconds`, the model config and an
    audio_dir dataset config under tmp; returns the train CLI's arguments
    (batch 8, 4 loader workers, the de-zeroed DiT as the starting weights
    where `dit_path` is given)."""
    import numpy as np
    from scipy.io import wavfile

    # console logging only: the train CLI logs to wandb when WANDB_API_KEY is set
    os.environ.pop("WANDB_API_KEY", None)
    tmp = Path(tmp)
    wavs = tmp / f"wavs_{name}"
    wavs.mkdir()
    for i in range(n_wavs):
        audio = synthetic_audio(100 + i, seconds * config["sample_rate"])[:config["audio_channels"]]
        wavfile.write(str(wavs / f"clip{i:02d}.wav"), config["sample_rate"],
                      (audio.T * 32767).astype(np.int16))
    (tmp / f"{name}_model.json").write_text(json.dumps(config))
    (tmp / f"{name}_data.json").write_text(json.dumps(
        {"dataset_type": "audio_dir", "datasets": [{"id": "synthetic", "path": str(wavs)}]}))
    return ["--model-config", str(tmp / f"{name}_model.json"),
            "--dataset-config", str(tmp / f"{name}_data.json"),
            "--batch-size", str(TRAIN_BATCH), "--seed", "0", "--num-workers", "4",
            "--save-dir", str(tmp / "run"), "--name", name] + (
                [] if dit_path is None else ["--pretrained-ckpt-path", str(dit_path)])


def train_timers(times, losses):
    """(class, method, timed method) triples: the step, the update, the
    frozen encode and the conditioners, each between two synchronisations;
    the step's loss goes to `losses`."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.models.conditioners import MultiConditioner
    from friendly_stable_audio_tools_tpu_torch.models.pretransforms import AutoencoderPretransform
    from friendly_stable_audio_tools_tpu_torch.training.diffusion import DiffusionCondTrainingWrapper

    def timer(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(key, []).append(time.perf_counter() - start)
            if key == "step":
                losses.append(out["loss"])
            return out
        return wrapper

    W = DiffusionCondTrainingWrapper
    return [(W, "train_step", timer(W.train_step, "step")),
            (W, "apply_update", timer(W.apply_update, "update")),
            (AutoencoderPretransform, "encode_nwc", timer(AutoencoderPretransform.encode_nwc, "encode")),
            (MultiConditioner, "forward", timer(MultiConditioner.forward, "cond"))]


def launches_per_step(config, route):
    """What one training step launches: each of the DiT's blocks runs the
    route's forward kernel once, and once more when the checkpointed block
    is recomputed for the backward, and its backward kernel once (route
    "pair": K5 and K6, with K10a once per K5 for k^ and twice per K6 for q^
    and k^; "flash": K7 and K9; "d128": K7 and K8 at head dim 128); each call of the frozen fp32
    encode (one per clip, iterate_batch) runs the fp32 K2 twice (conv_in on
    the thin route, conv_out on the wide one) and the fp32 K3 once per
    residual unit (3 in each encoder block); nothing else."""
    import torch

    depth = config["model"]["diffusion"]["config"]["depth"]
    n_units = 3 * len(config["model"]["pretransform"]["config"]["encoder"]["config"]["c_mults"])
    calls = encode_calls(config)
    fwd, bwd = {"pair": ("fused_qkv_rope_attention_stats", "fused_qkv_rope_attention_backward"),
                "flash": ("flash_forward", "flash_backward"),
                "d128": ("flash_forward_d128", "flash_backward_fused_d128")}[route]
    per_step = {name: 0 for name in KERNELS}
    per_step.update({fwd: 2 * depth, bwd: depth, "fused_residual_unit_f32": n_units * calls,
                     **k2_counts(OOBLECK_ENCODE_K2, torch.float32, calls)})
    if route == "pair":  # K10a: k^ for each K5; q^ and k^ for each K6
        per_step["rope_pair_k"] = 2 * depth + 2 * depth
    return per_step


def log_training(config, times, losses, steps, peak, total):
    """Logs step times, throughput and the split (medians of steps 2..n)."""
    step_s = times["step"][:steps]
    med = statistics.median(step_s[1:])
    med_of = lambda key: statistics.median(times[key][1:steps])  # noqa: E731
    dit_s = med - med_of("encode") - med_of("cond") - med_of("update")
    seconds = config["sample_size"] / config["sample_rate"]
    log(f"  steps {[round(x, 4) for x in step_s]} s; median of steps 2-{steps} {med:.4f} s = "
        f"{TRAIN_BATCH / med:.4f} samples/s = {TRAIN_BATCH * seconds / med:.3f} s-audio/s trained")
    log(f"  split (medians): encode {med_of('encode'):.4f} s, conditioners {med_of('cond'):.4f} s, "
        f"backbone fwd+bwd {dit_s:.4f} s, optimizer+EMA {med_of('update'):.4f} s; "
        f"peak memory {peak:.2f} GiB; run incl. set-up {total:.1f} s")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses not finite: {losses}")


def weight_moved(wrapper, dit_path, name="model.transformer.layers.0.self_attn.to_qkv.weight"):
    """Largest change of one weight (the DiT's layer-0 to_qkv) from the
    starting backbone."""
    import torch

    initial = torch.load(dit_path, map_location="cpu", weights_only=True, mmap=True)[name]
    return (wrapper.trainable[name].detach() - initial.to(wrapper.device)).abs().max().item()


def training_phase(config, tmp, dit_path):
    """[7] The train entry point on SAO 1.0: 4 steps from raw audio with a
    checkpoint at step 4, then a resume for a fifth. Returns the launch
    counts of the two runs."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import train

    cfg = copy.deepcopy(config)
    cfg["training"]["checkpoint"]["every_n_train_steps"] = TRAIN_STEPS
    args = train_args(cfg, tmp, "sao", N_WAVS, WAV_SECONDS, dit_path)
    times, losses = {}, []
    per_step = launches_per_step(config, "pair")
    with patched(train_timers(times, losses)):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        trainer = train.main(args + ["--max-steps", str(TRAIN_STEPS)])
        total = time.perf_counter() - start
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        w = trainer.wrapper
        grad = w.model.model.transformer.layers[0].self_attn.to_qkv.weight.grad
        moved = weight_moved(w, dit_path)
        ema_gap = max((e - p.detach()).abs().max().item() for e, p in zip(w.ema, w.dit_params))
        ckpt = Path(trainer.ckpt_dir) / "last"
        steps_done = w.step
        del trainer, w
        torch.cuda.empty_cache()

        reset_counts()
        resumed = train.main(args + ["--max-steps", str(TRAIN_STEPS + 1), "--ckpt-path", str(ckpt)])
        counts_resume = read_counts()
        resumed_step = resumed.wrapper.step
        del resumed
        torch.cuda.empty_cache()

    log_training(config, times, losses, TRAIN_STEPS, peak, total)
    log(f"  losses {losses}; layer-0 to_qkv grad max|g| {grad.abs().max().item():.4g}; "
        f"weights moved by up to {moved:.4g}; max |EMA - weights| {ema_gap:.4g}")
    log(f"  launches, {TRAIN_STEPS} steps: {counts}; resumed step {resumed_step}, launches {counts_resume}")
    if len(losses) != TRAIN_STEPS + 1:
        raise AssertionError(f"training losses missing: {losses}")
    if not (torch.isfinite(grad).all() and grad.abs().max() > 0):
        raise AssertionError("the layer-0 to_qkv gradient is not finite and non-zero")
    if not (moved > 0 and ema_gap > 0 and steps_done == TRAIN_STEPS and resumed_step == TRAIN_STEPS + 1):
        raise AssertionError("weights did not move, the EMA equals them, or the step count is off")
    for n, c in ((TRAIN_STEPS, counts), (1, counts_resume)):
        want = {k: v * n for k, v in per_step.items()}
        if c != want:
            raise AssertionError(f"launch counts {c} are not the {want} of {n} training steps")
    return counts, counts_resume


def longform_training_phase(config, tmp, dit_path):
    """[9] The train entry point on SA 2.0: 3 steps at batch 8 from synthetic
    290 s WAVs, starting from phase 6b's de-zeroed DiT; no checkpoint (phase
    7 covers saving and resuming). Returns the launch counts."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import train

    args = train_args(config, tmp, "sa2", SA2_WAVS, SA2_WAV_SECONDS, dit_path)
    times, losses = {}, []
    per_step = launches_per_step(config, "flash")
    with patched(train_timers(times, losses)):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        trainer = train.main(args + ["--max-steps", str(SA2_TRAIN_STEPS)])
        total = time.perf_counter() - start
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        moved = weight_moved(trainer.wrapper, dit_path)
        steps_done = trainer.wrapper.step
        del trainer
        torch.cuda.empty_cache()

    log_training(config, times, losses, SA2_TRAIN_STEPS, peak, total)
    log(f"  losses {losses}; weights moved by up to {moved:.4g}")
    log(f"  launches, {SA2_TRAIN_STEPS} steps: {counts}")
    if len(losses) != SA2_TRAIN_STEPS or not (moved > 0 and steps_done == SA2_TRAIN_STEPS):
        raise AssertionError("losses missing, weights did not move, or the step count is off")
    want = {k: v * SA2_TRAIN_STEPS for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} are not the {want} of {SA2_TRAIN_STEPS} steps")
    return counts


SA1_WATCHED = "model.unet.down0.transformer.blocks.0.attention.to_q.weight"


def sa1_train_step_phase(config, tmp):
    """[11b] One training step of SA 1.0's fp32 U-Net at batch 8 and 4096
    latent frames with fixed draws (CFG dropout 0.1 with row 0 dropped): the
    flash-gated self-attention through K7 with its LSE and K8, through their
    plain versions (the reference), and through the serving route the port
    took before (K7 without its LSE, whose output has no autograd graph).
    Saves the de-zeroed U-Net for phase 11; returns the kernels' launch
    counts."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.models.adp import ADPAttention
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash
    from friendly_stable_audio_tools_tpu_torch.training.diffusion import get_alphas_sigmas

    model = build_model(config)
    unet_path = Path(tmp) / "unet_dezeroed.pt"
    torch.save({f"model.{k}": v for k, v in model.model.state_dict().items()}, unet_path)
    rnd = randn_fn(12)
    conds = [dict(SA1_PROMPT, seconds_start=i, seconds_total=SA1_PROMPT["seconds_total"] - i)
             for i in range(TRAIN_BATCH)]
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner(conds, device=DEVICE))
    x0 = rnd(TRAIN_BATCH, SA1_SAMPLE_SIZE // model.pretransform.downsampling_ratio, model.io_channels)
    noise = rnd(*x0.shape)
    t = torch.rand(TRAIN_BATCH, generator=torch.Generator(device=DEVICE).manual_seed(13),
                   device=DEVICE)
    alphas, sigmas = (v[:, None, None] for v in get_alphas_sigmas(t))
    noised, targets = x0 * alphas + noise * sigmas, noise * alphas - x0 * sigmas
    drop = torch.zeros(TRAIN_BATCH, dtype=torch.bool, device=DEVICE)
    drop[0] = True
    unet = model.model.train()
    del model
    params = dict(unet.named_parameters(prefix="model"))
    # the self-attention modules the gate sends to the flash kernels (T >= 1024)
    lengths = {}
    hooks = [m.register_forward_pre_hook(lambda m, a, n=n: lengths.__setitem__(n, a[0].shape[1]))
             for n, m in unet.named_modules(prefix="model")
             if isinstance(m, ADPAttention) and n.endswith(".attention")]
    unet.zero_grad(set_to_none=True)
    with torch.no_grad():
        unet(noised, t, cfg_dropout_prob=0.1, cfg_dropout_mask=drop, **cond)
    for h in hooks:
        h.remove()
    watched = [f"{n}.{p}.weight" for n, t_len in lengths.items() if t_len >= 1024
               for p in ("to_q", "to_kv", "to_out")]

    def step():
        unet.zero_grad(set_to_none=True)
        out = unet(noised, t, cfg_dropout_prob=0.1, cfg_dropout_mask=drop, **cond)
        loss = (out - targets).square().mean()
        loss.backward()
        torch.cuda.synchronize()
        # the next step's zero_grad(set_to_none=True) leaves these tensors to the caller
        return loss.item(), {n: torch.zeros_like(p) if p.grad is None else p.grad
                             for n, p in params.items()}

    class ServingRoute:  # the route before the repair: K7 without its LSE under grad too
        @staticmethod
        def apply(q, k, v):
            with torch.no_grad():  # the kernel's output carries no autograd graph
                return flash.flash_forward(q, k, v, save_stats=False)[0]

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    loss_k, grads_k = step()
    wall_k = time.perf_counter() - start
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with plain_kernels():
        start = time.perf_counter()
        loss_r, grads_r = step()
        wall_r = time.perf_counter() - start
    errs = {n: rel_err(grads_k[n], g) for n, g in grads_r.items() if g.norm() > 0}
    total = math.sqrt(sum(((grads_k[n] - g).norm() ** 2).item() for n, g in grads_r.items())
                      / sum((g.norm() ** 2).item() for g in grads_r.values()))
    watched_r = {n: grads_r[n] for n in watched}
    del grads_k, grads_r
    with patched([(flash, "FlashAttention", ServingRoute)]):
        loss_o, grads_o = step()
    errs_o = {n: rel_err(grads_o[n], g) for n, g in watched_r.items()}
    del grads_o, watched_r, unet
    torch.cuda.empty_cache()

    loss_err = abs(loss_k - loss_r) / abs(loss_r)
    worst = max(errs, key=errs.get)
    log(f"  loss: kernels {loss_k:.8g}, plain {loss_r:.8g} (rel {loss_err:.3g}, tol {SA2_LOSS_RTOL}); "
        f"gradients of all {len(params)} parameters rel-L2 {total:.3g} (tol {SA2_GRAD_RTOL}), the "
        f"largest of one parameter {errs[worst]:.3g} ({worst})")
    for n in watched:
        log(f"  {n} grad rel-L2 against the plain step: kernels {errs.get(n, 0.0):.3g}, the serving "
            f"route {errs_o[n]:.3g}")
    log(f"  old serving route: loss {loss_o:.8g}; step wall: kernels {wall_k:.3f} s, plain "
        f"{wall_r:.3f} s; peak memory of the U-Net step with the kernels (weights, gradients, no "
        f"optimizer state) {peak:.2f} GiB; launches {counts}")
    if not (math.isfinite(loss_k) and loss_err <= SA2_LOSS_RTOL and total <= SA2_GRAD_RTOL
            and len(watched) == 3 * 14 and all(errs[n] <= SA2_GRAD_RTOL for n in watched)):
        raise AssertionError("the SA 1.0 U-Net training step with K7/K8 disagrees with the plain step")
    if max(errs_o[n] for n in watched if ".to_q." in n) < 0.5:
        raise AssertionError("the serving route under grad should lose the q/k/v gradients")
    want = {name: 0 for name in KERNELS}
    want.update(flash_forward=14, flash_backward_fused=14)
    if counts != want:
        raise AssertionError(f"one SA 1.0 U-Net training step should launch {want}: {counts}")
    return unet_path, counts


def sa1_training_phase(config, tmp, unet_path):
    """[11] The train entry point on SA 1.0 as written: 3 steps at batch 8
    from synthetic 96 s WAVs, starting from phase 11b's de-zeroed U-Net; no
    checkpoint. Returns the launch counts."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import train

    args = train_args(config, tmp, "sa1", SA1_WAVS, SA1_WAV_SECONDS, unet_path)
    times, losses = {}, []
    # per step: 14 flash-gated self-attentions, each K7 with its LSE and K8
    # (no checkpointing in the U-Net), and per clip (one per encode call) the
    # DAC encoder's fp32 K2: conv_in, conv_out and two in each of the three
    # residual units of each block (26 at SA 1.0's four strides)
    per_step = {name: 0 for name in KERNELS}
    per_step.update(flash_forward=14, flash_backward_fused=14,
                    **k2_counts([(cin, cout, k) for _, cin, cout, k, _, n in dac_encode_k2_cases(config)
                                 for _ in range(n)], torch.float32, encode_calls(config)))
    with patched(train_timers(times, losses)):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        trainer = train.main(args + ["--max-steps", str(SA1_TRAIN_STEPS)])
        total = time.perf_counter() - start
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        moved = weight_moved(trainer.wrapper, unet_path, SA1_WATCHED)
        steps_done = trainer.wrapper.step
        del trainer
        torch.cuda.empty_cache()

    log_training(config, times, losses, SA1_TRAIN_STEPS, peak, total)
    log(f"  losses {losses}; {SA1_WATCHED} moved by up to {moved:.4g}")
    log(f"  launches, {SA1_TRAIN_STEPS} steps: {counts}")
    if len(losses) != SA1_TRAIN_STEPS or not (moved > 0 and steps_done == SA1_TRAIN_STEPS):
        raise AssertionError("losses missing, weights did not move, or the step count is off")
    want = {k: v * SA1_TRAIN_STEPS for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} are not the {want} of {SA1_TRAIN_STEPS} steps")
    return counts


LM_PROMPTS = [{"prompt": f"lo-fi hip hop beat number {i} with warm piano and vinyl crackle"}
              for i in range(8)]


def lm_train_step_phase(config, tmp):
    """[12b] One training step of the audio LM at full width (MusicGen small,
    musicgen_small_32khz.json as written, random weights, de-zeroed) at
    batch 8 on 30 s of synthetic audio, with fixed CFG-dropout draws (row 0
    dropped): the causal self-attention through the causal K7 with its LSE
    and the causal K9, then through their plain versions (the reference:
    loss within 1e-5, all gradients within rel-L2 1e-4); one no-grad forward
    of the same batch through the causal K7 without its LSE against the
    plain versions. The codes come from one tokenize through the fp32 K2.
    Saves the de-zeroed model for phase 12; returns its path and the launch
    counts of the tokenize, the step and the forward."""
    import numpy as np
    import torch

    from friendly_stable_audio_tools_tpu_torch.training.lm import AudioLanguageModelTrainingWrapper

    model = build_model(config)
    lm_path = Path(tmp) / "lm_dezeroed.pt"
    torch.save(model.state_dict(), lm_path)
    n = config["sample_size"]
    audio = np.stack([synthetic_audio(200 + i, n, config["sample_rate"])[:1]
                      for i in range(TRAIN_BATCH)])
    reals = torch.from_numpy(audio).to(DEVICE).transpose(1, 2)  # [B, T, 1]
    wrapper = AudioLanguageModelTrainingWrapper(model, lr=config["training"]["learning_rate"])
    drop = {"cross_attn_cond": torch.arange(TRAIN_BATCH, device=DEVICE) == 0}
    reset_counts()
    codes = wrapper.tokenize(reals)
    counts_tok = read_counts()
    del reals
    params = dict(wrapper.trainable)

    def step():
        model.zero_grad(set_to_none=True)
        model.train()
        loss, metrics = wrapper.loss(None, LM_PROMPTS[:TRAIN_BATCH], draws=drop, codes=codes)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: torch.zeros_like(p) if p.grad is None else p.grad
                             for n, p in params.items()}

    def forward():
        with torch.no_grad():
            loss, _ = wrapper.loss(None, LM_PROMPTS[:TRAIN_BATCH], draws=drop, codes=codes)
        torch.cuda.synchronize()
        return loss.item()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    loss_k, grads_k = step()
    wall_k = time.perf_counter() - start
    counts_step = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with plain_kernels():
        start = time.perf_counter()
        loss_r, grads_r = step()
        wall_r = time.perf_counter() - start
    errs = {n: rel_err(grads_k[n], g) for n, g in grads_r.items() if g.norm() > 0}
    total = math.sqrt(sum(((grads_k[n] - g).norm() ** 2).item() for n, g in grads_r.items())
                      / sum((g.norm() ** 2).item() for g in grads_r.values()))
    del grads_k, grads_r
    model.zero_grad(set_to_none=True)
    reset_counts()
    eval_k = forward()
    counts_eval = read_counts()
    with plain_kernels():
        eval_r = forward()
    del wrapper, model
    torch.cuda.empty_cache()

    loss_err, eval_err = abs(loss_k - loss_r) / abs(loss_r), abs(eval_k - eval_r) / abs(eval_r)
    worst = max(errs, key=errs.get)
    log(f"  codes {list(codes.shape)} (values {int(codes.min())}..{int(codes.max())}); loss: kernels "
        f"{loss_k:.8g}, plain {loss_r:.8g} (rel {loss_err:.3g}, tol {SA2_LOSS_RTOL}); gradients of "
        f"all {len(params)} parameters rel-L2 {total:.3g} (tol {SA2_GRAD_RTOL}), the largest of one "
        f"parameter {errs[worst]:.3g} ({worst})")
    log(f"  no-grad forward: loss kernels {eval_k:.8g}, plain {eval_r:.8g} (rel {eval_err:.3g}); "
        f"step wall: kernels {wall_k:.3f} s, plain {wall_r:.3f} s; peak memory of the step with the "
        f"kernels (weights, gradients, no optimizer state) {peak:.2f} GiB")
    log(f"  launches: tokenize {counts_tok}; step {counts_step}; no-grad forward {counts_eval}")
    if not (math.isfinite(loss_k) and loss_err <= SA2_LOSS_RTOL and eval_err <= SA2_LOSS_RTOL
            and total <= SA2_GRAD_RTOL and errs[worst] <= SA2_GRAD_RTOL):
        raise AssertionError("the audio LM step with the causal K7/K9 disagrees with the plain step")
    for counts, want_nonzero in (
            (counts_tok, k2_counts([c[1:] for c in seanet_conv_steps(config)], torch.float32)),
            (counts_step, {"flash_forward_causal": LM_LAYERS, "flash_backward_causal": LM_LAYERS}),
            (counts_eval, {"flash_forward_causal_serving": LM_LAYERS})):
        want = {name: 0 for name in KERNELS}
        want.update(want_nonzero)
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
    return lm_path, counts_tok, counts_step, counts_eval


def lm_training_phase(config, tmp, lm_path):
    """[12] The train entry point on musicgen_small_32khz.json as written
    (CFG dropout 0.1, AdamW at 1e-4, betas 0.9 / 0.95, weight decay 0.1, no
    EMA) from 8 synthetic 31 s mono 32 kHz WAVs, batch 8, 3 steps, starting
    from phase 12b's de-zeroed model; no checkpoint (phase 7 covers saving
    and resuming). Returns the launch counts."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import train
    from friendly_stable_audio_tools_tpu_torch.models.conditioners import MultiConditioner
    from friendly_stable_audio_tools_tpu_torch.training.lm import AudioLanguageModelTrainingWrapper

    args = train_args(config, tmp, "lm", LM_WAVS, LM_WAV_SECONDS, lm_path)
    times, losses = {}, []

    def timer(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(key, []).append(time.perf_counter() - start)
            if key == "step":
                losses.append(out["loss"])
            return out
        return wrapper

    W = AudioLanguageModelTrainingWrapper
    timers = [(W, "train_step", timer(W.train_step, "step")),
              (W, "apply_update", timer(W.apply_update, "update")),
              (W, "tokenize", timer(W.tokenize, "encode")),
              (MultiConditioner, "forward", timer(MultiConditioner.forward, "cond"))]
    per_step = {name: 0 for name in KERNELS}
    per_step.update(flash_forward_causal=LM_LAYERS, flash_backward_causal=LM_LAYERS,
                    **k2_counts([c[1:] for c in seanet_conv_steps(config)], torch.float32))
    with patched(timers):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        trainer = train.main(args + ["--max-steps", str(LM_TRAIN_STEPS)])
        total = time.perf_counter() - start
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        w = trainer.wrapper
        name = "model.backbone.model.layers.0.self_attn.to_qkv.weight"
        initial = torch.load(lm_path, map_location="cpu", weights_only=True, mmap=True)[name]
        moved = (w.trainable[name].detach() - initial.to(w.device)).abs().max().item()
        steps_done = w.step
        del trainer, w
        torch.cuda.empty_cache()

    log_training(config, times, losses, LM_TRAIN_STEPS, peak, total)
    med = statistics.median(times["step"][1:LM_TRAIN_STEPS])
    frames = config["sample_size"] // config["model"]["pretransform"]["config"]["downsampling_ratio"]
    log(f"  {TRAIN_BATCH * frames / med:.1f} token frames/s ({TRAIN_BATCH * frames} frames of 4 "
        f"codebooks per step: {4 * TRAIN_BATCH * frames / med:.1f} tokens/s)")
    log(f"  losses {losses}; {name} moved by up to {moved:.4g}")
    log(f"  launches, {LM_TRAIN_STEPS} steps: {counts}")
    if len(losses) != LM_TRAIN_STEPS or not (moved > 0 and steps_done == LM_TRAIN_STEPS):
        raise AssertionError("losses missing, weights did not move, or the step count is off")
    want = {k: v * LM_TRAIN_STEPS for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} are not the {want} of {LM_TRAIN_STEPS} steps")
    return counts


def rel_err(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def dit_forward_phase(model, frames, prompt, label):
    """One DiT forward with CFG at `frames` latent frames: the bf16 DiT with
    the kernels and with the plain versions, each against an fp32 copy with
    the plain versions. Returns (kernels' rel-L2, plain bf16's rel-L2)."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(2)
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner([prompt], device=DEVICE))
        x = torch.randn(1, frames, model.io_channels, generator=g, device=DEVICE)
        t = torch.full((1,), 0.6, device=DEVICE)
        dit_k = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
        with plain_kernels():
            dit_p = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
            dit32 = copy.deepcopy(model.model).float()
            dit_ref = dit32(x, t, cfg_scale=CFG_SCALE, **cond)
            del dit32
    err_k, err_p = rel_err(dit_k, dit_ref), rel_err(dit_p, dit_ref)
    log(f"  {label} DiT forward {list(x.shape)} with CFG, rel-L2 against the fp32 DiT: kernels "
        f"{err_k:.3g}, plain bf16 {err_p:.3g} (bound: kernels <= {DIT_ERR_RATIO} x plain); "
        f"kernels vs plain {rel_err(dit_k, dit_p):.3g}")
    if not err_k <= DIT_ERR_RATIO * err_p:
        raise AssertionError(f"the {label} DiT forward with the kernels disagrees with the plain versions")
    return err_k, err_p


def generation_phase(model, config, prompt, sample_size, expected, min_counts):
    """generate_diffusion_cond for one prompt, 100 dpmpp-3m-sde steps, CFG 7,
    with every launch count set to 0 just before and read just after: checks
    the audio and the counts (`expected` exactly, `min_counts` at least),
    logs the walls, and returns (the counts, the audio, s-audio/s)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond

    phase = {"conditioners": 0.0, "decode": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phase[key] += time.perf_counter() - start
            return out
        return wrapper

    with patched([(model.conditioner, "forward", timed(model.conditioner.forward, "conditioners")),
                  (model.pretransform, "decode_nwc", timed(model.pretransform.decode_nwc, "decode"))]):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        audio = generate_diffusion_cond(model, steps=STEPS, cfg_scale=CFG_SCALE,
                                        conditioning=[prompt], sample_size=sample_size,
                                        sampler_type="dpmpp-3m-sde", sigma_min=0.3, sigma_max=500,
                                        seed=42)
        torch.cuda.synchronize()
        total = time.perf_counter() - start
        launches = read_counts()
    rms = audio.float().square().mean().sqrt().item()
    seconds = sample_size / config["sample_rate"]
    denoise = total - phase["conditioners"] - phase["decode"]
    log(f"  audio {list(audio.shape)} finite {bool(torch.isfinite(audio).all())} rms {rms:.4g}")
    log(f"  wall: conditioners {phase['conditioners']:.4f} s, denoise {denoise:.4f} s "
        f"({denoise / STEPS * 1e3:.3f} ms/step), decode {phase['decode']:.4f} s, total {total:.4f} s "
        f"= {seconds / total:.3f} s-audio/s")
    log(f"  launches {launches}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if tuple(audio.shape) != (1, 2, sample_size) or not torch.isfinite(audio).all() or rms <= 0:
        raise AssertionError(f"generation output is not finite [1, 2, {sample_size}] audio")
    if (any(launches[k] != n for k, n in expected.items())
            or any(launches[k] < n for k, n in min_counts.items())):
        raise AssertionError(f"launch counts {launches} do not show the main path's kernels")
    return launches, audio, seconds / total


def profile_sao_step(model, config):
    """One SAO bf16 denoising step's backbone call under torch.profiler
    (profile_generation.profile_backbone, 3 calls): the device-busy share of
    the wall, K1's share of the device time (the pair attention kernel and
    its K10a rope) and K13's (with fused_mlp), to say whether the host sets
    the step's pace. Returns the profile."""
    from friendly_stable_audio_tools_tpu_torch.profile_generation import profile_backbone

    prof = profile_backbone(model, config, steps=3, cfg_scale=CFG_SCALE)
    cats = prof["by_category_ms"]
    device = prof["device_ms_per_step"]
    k1 = cats.get("K1/K5/K10 pair attention", 0.0) + cats.get("K10a rope_pair", 0.0)
    k13 = cats.get("K13 glu_mlp", 0.0)
    log(f"  profiled SAO bf16 step (one CFG backbone call, mean of 3): wall "
        f"{prof['wall_ms_per_step']:.3f} ms, device busy {device:.3f} ms "
        f"({100 * (1 - prof['idle_share']):.1f}% of the wall); K1 + its K10a {k1:.3f} ms = "
        f"{100 * k1 / device:.1f}% of the device time; K13 {k13:.3f} ms = {100 * k13 / device:.1f}%; "
        f"by category " + ", ".join(f"{c} {ms:.3f}" for c, ms in list(cats.items())[:7])
        + f"; card {smi_line()}")
    if device <= 0 or k1 <= 0:
        raise AssertionError("the profiled SAO step shows no device time in K1")
    return prof


def sao_fused_mlp_phase(model, config, launches_off, rate_off, prof_off):
    """[5b] The same SAO bf16 model with `fused_mlp` set on every DiT
    FeedForward (what create_model_from_config(..., fused_mlp=True) sets):
    one full-size DiT forward with CFG against the fp32 DiT, with the kernels
    (K13 included) within DIT_ERR_RATIO of the plain bf16 error, and against
    the same forward without it; then the 100-step generation (K13 24 per
    step on the tensor-core route: 2,400, and the other counts as in [5])
    and one profiled CFG step. Both walls and both steps' device times print
    side by side. Leaves the switch off. Returns the launch counts."""
    import torch

    set_fused_mlp(model, False)
    g = torch.Generator(device=DEVICE).manual_seed(2)
    frames = SAMPLE_SIZE // model.pretransform.downsampling_ratio
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner([PROMPT], device=DEVICE))
        x = torch.randn(1, frames, model.io_channels, generator=g, device=DEVICE)
        t = torch.full((1,), 0.6, device=DEVICE)
        off = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
        set_fused_mlp(model, True)
        on = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
    log(f"  DiT forward with fused_mlp vs without: rel-L2 {rel_err(on, off):.3g}")
    del off, on
    dit_forward_phase(model, frames, PROMPT, "SAO 1.0 with fused_mlp")
    expected = {k: v for k, v in launches_off.items() if k in KERNELS}
    expected.update(glu_mlp=0, glu_mlp_tensor=24 * STEPS)
    launches, _, rate = generation_phase(model, config, PROMPT, SAMPLE_SIZE, expected=expected,
                                         min_counts={})
    prof = profile_sao_step(model, config)
    set_fused_mlp(model, False)
    log(f"  SAO bf16 generation, this run: fused_mlp off ([5]) {rate_off:.3f} s-audio/s, on "
        f"{rate:.3f} s-audio/s; one CFG step's device time off {prof_off['device_ms_per_step']:.3f} ms, "
        f"on {prof['device_ms_per_step']:.3f} ms (K13 {prof['by_category_ms'].get('K13 glu_mlp', 0.0):.3f} "
        f"ms of it); card {smi_line()}")
    return launches


def init_audio_call(model, label, expected, clip, **kw):
    """One `generate_diffusion_cond` of one SAO prompt (CFG 7, seed 42) with
    every launch count set to 0 just before and read just after; the step
    hook counts the model evaluations. Checks finite nonzero [1, 2,
    SAMPLE_SIZE] audio and the counts: `expected`, K1 and K10a 24 per
    evaluation, every other kernel 0. Logs the walls (conditioners, encode,
    decode, total), peak memory, the audio's rel-L2 to [5]'s `clip` and the
    card. Returns (counts, evaluations)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond

    phase = {"conditioners": 0.0, "encode": 0.0, "decode": 0.0}

    def timed(fn, key):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            phase[key] += time.perf_counter() - start
            return out
        return wrapper

    evals = [0]

    def count(info):
        evals[0] += 1

    pt = model.pretransform
    with patched([(model.conditioner, "forward", timed(model.conditioner.forward, "conditioners")),
                  (pt, "encode_nwc", timed(pt.encode_nwc, "encode")),
                  (pt, "decode_nwc", timed(pt.decode_nwc, "decode"))]):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        audio = generate_diffusion_cond(model, cfg_scale=CFG_SCALE, conditioning=[PROMPT],
                                        sample_size=SAMPLE_SIZE, sigma_min=0.3, sigma_max=500,
                                        seed=42, callback=count, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - start
        launches = read_counts()
    want = {name: 0 for name in KERNELS}
    want.update(expected, fused_qkv_rope_attention=24 * evals[0], rope_pair_k=24 * evals[0])
    rms = audio.float().square().mean().sqrt().item()
    denoise = total - sum(phase.values())
    log(f"  {label}: {evals[0]} model evaluations; wall conditioners {phase['conditioners']:.4f} s, "
        f"encode {phase['encode']:.4f} s, denoise {denoise:.4f} s ({denoise / evals[0] * 1e3:.3f} ms "
        f"per evaluation), decode {phase['decode']:.4f} s, total {total:.4f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; audio rms {rms:.4g}, rel-L2 to [5]'s "
        f"clip {rel_err(audio, clip):.4g}; card {smi_line()}")
    if tuple(audio.shape) != (1, 2, SAMPLE_SIZE) or not torch.isfinite(audio).all() or rms <= 0:
        raise AssertionError(f"{label}: the output is not finite nonzero [1, 2, {SAMPLE_SIZE}] audio")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches}, expected {want}")
    return launches, evals[0]


def init_audio_phase(model, audio):
    """[16] Init-audio generation and the other samplers on the SAO model in
    bench.py's bf16 recipe, [5]'s generated clip (`audio`, [1, 2,
    SAMPLE_SIZE]) as the init audio: a variation and an outpainting (100
    dpmpp-3m-sde steps each), one pass of each other sampler from noise,
    then the kernels against the plain versions on an inpainting. Returns
    the launch counts per path."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from friendly_stable_audio_tools_tpu_torch.inference.sampling import SAMPLER_TYPES

    init = (44100, audio[0])
    decode = {"fused_residual_unit": 15, "snake_conv_transpose1d": 5,
              **k2_counts(OOBLECK_DECODE_K2, torch.bfloat16)}
    with_encode = {"fused_residual_unit": 30, "snake_conv_transpose1d": 5,
                   **k2_counts(OOBLECK_DECODE_K2 + OOBLECK_ENCODE_K2, torch.bfloat16)}
    paths = {}
    paths["generate_variation"], _ = init_audio_call(
        model, f"variation (init_noise_level 1.0, {STEPS} dpmpp-3m-sde steps)", with_encode, audio,
        steps=STEPS, sampler_type="dpmpp-3m-sde", init_audio=init, init_noise_level=1.0)
    paths["generate_inpaint"], _ = init_audio_call(
        model, f"outpainting {INIT_MASK_ARGS} ({STEPS} dpmpp-3m-sde steps)", with_encode, audio,
        steps=STEPS, sampler_type="dpmpp-3m-sde", init_audio=init, mask_args=INIT_MASK_ARGS)
    # k-lms integrates its coefficients with scipy on the host: its import,
    # timed here, would otherwise land in the first k-lms call's wall
    start = time.perf_counter()
    import scipy.integrate  # noqa: F401
    log(f"  host: importing scipy.integrate took {time.perf_counter() - start:.4f} s")
    samplers = {name: 0 for name in KERNELS}
    for sampler in SAMPLER_TYPES:
        if sampler == "dpmpp-3m-sde":
            continue
        how = ("until sigma_min or 200 iterations" if sampler == "k-dpm-adaptive"
               else f"{INIT_SAMPLER_STEPS} steps")
        counts, _ = init_audio_call(model, f"{sampler} from noise, {how}", decode, audio,
                                    steps=INIT_SAMPLER_STEPS, sampler_type=sampler)
        samplers = {k: samplers[k] + counts[k] for k in KERNELS}
    paths["generate_samplers"] = samplers

    # the kernels against the plain versions: the same inpainting (same
    # seed, so the same draws) with the kernels, with the plain versions in
    # bf16, and on an fp32 copy with the plain versions; its audio, and its
    # latents (return_latents), which show the encode, the DiT and the
    # sampler apart from the decode: at random weights the decoded audio
    # barely moves with the latents (each [16] clip within rel-L2 ~3e-3 of
    # [5]'s)
    kw = dict(steps=INIT_CHECK_STEPS, cfg_scale=CFG_SCALE, conditioning=[PROMPT],
              sample_size=SAMPLE_SIZE, sampler_type="dpmpp-3m-sde", sigma_min=0.3, sigma_max=500,
              seed=7, init_audio=init, mask_args=INIT_MASK_ARGS)
    model32 = copy.deepcopy(model)
    model32.model.float()
    model32.pretransform.float()
    model32.pretransform.model_half = False
    for what, latents in (("audio", False), ("latents", True)):
        out_k = generate_diffusion_cond(model, return_latents=latents, **kw)
        with plain_kernels():
            out_p = generate_diffusion_cond(model, return_latents=latents, **kw)
            out_32 = generate_diffusion_cond(model32, return_latents=latents, **kw)
        err_k, err_p = rel_err(out_k, out_32), rel_err(out_p, out_32)
        log(f"  {INIT_CHECK_STEPS}-step outpainting's {what} {list(out_k.shape)}, rel-L2 against an "
            f"fp32 copy with the plain versions: kernels {err_k:.4g}, plain bf16 {err_p:.4g} (bound: "
            f"kernels <= {DIT_ERR_RATIO} x plain); kernels vs plain {rel_err(out_k, out_p):.4g}")
        if not (torch.isfinite(out_k).all() and err_k <= DIT_ERR_RATIO * err_p):
            raise AssertionError(f"the inpainting's {what} with the kernels disagree with the plain "
                                 f"versions")
    del model32
    torch.cuda.empty_cache()
    return paths


def bench_recipe(model):
    """bench.py's bf16 recipe (bench.py:67, 157-159): the DiT's and the
    VAE's weights in bf16, the VAE computing in bf16 (`model_half`). The
    CLIs run the model's own fp32 instead."""
    import torch

    model.model.to(torch.bfloat16)
    model.pretransform.to(torch.bfloat16)
    model.pretransform.model_half = True


def at_depth(config, depth):
    """A copy of `config` whose backbone (the DiT, or the audio LM) has
    `depth` layers; nothing else changes."""
    c = copy.deepcopy(config)
    c["model"]["diffusion" if "diffusion" in c["model"] else "lm"]["config"]["depth"] = depth
    return c


def adaln_config(config):
    """SAO 1.0's config with its DiT's global condition through adaLN
    (`global_cond_type: "adaLN"`), nothing else changed."""
    c = copy.deepcopy(config)
    c["model"]["diffusion"]["config"]["global_cond_type"] = "adaLN"
    return c


def set_fused_ew(model, on):
    from friendly_stable_audio_tools_tpu_torch.models.transformer import TransformerBlock
    from friendly_stable_audio_tools_tpu_torch.ops.norms import LayerNorm

    for m in model.modules():
        if isinstance(m, (LayerNorm, TransformerBlock)):
            m.fused_ew = on


def adaln_step_phase(model):
    """[14b] One forward and backward of the full-width bf16 adaLN DiT (CFG
    batch 2 of two prompts' conditioning at 1024 latent frames, fixed
    inputs, a mean-square loss against a fixed target) with `fused_ew` on,
    then off, then as an fp32 copy with the plain versions (the reference),
    on the same de-zeroed weights, `to_scale_shift_gate` included. Checks:
    K11 and K12 48 launches each in the forward with the switch on (the
    backward differentiates the plain chains: no launch), none off; every
    gradient finite, the adaLN projections' non-zero; the output and the
    concatenated gradients with the kernels within DIT_ERR_RATIO x the plain
    bf16 error against the reference. Returns (counts on, counts off)."""
    import torch

    dit = model.model
    g = torch.Generator(device=DEVICE).manual_seed(29)
    prompts = [PROMPT, dict(PROMPT, prompt="A calm piano melody in a large hall")]
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner(prompts, device=DEVICE))
    x = torch.randn(2, ADALN_T, model.io_channels, generator=g, device=DEVICE)
    target = torch.randn(x.shape, generator=g, device=DEVICE)
    t = torch.rand(2, generator=g, device=DEVICE)

    def step(net):
        net.zero_grad(set_to_none=True)
        out = net(x, t, **cond)
        loss = (out.float() - target).square().mean()
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().float().clone() for n, p in net.named_parameters()}
        return out.detach().float(), loss.item(), grads

    runs, counts = {}, {}
    for on in (True, False):
        set_fused_ew(dit, on)
        reset_counts()
        start = time.perf_counter()
        runs[on] = step(dit)
        counts[on] = read_counts()
        log(f"  fused_ew {'on' if on else 'off'}: loss {runs[on][1]:.7g}, step wall "
            f"{time.perf_counter() - start:.3f} s; launches {counts[on]}")
    set_fused_ew(dit, True)
    dit.zero_grad(set_to_none=True)
    with plain_kernels():
        dit32 = copy.deepcopy(dit).float()
        ref = step(dit32)
        del dit32
    torch.cuda.empty_cache()
    cat = lambda gr: torch.cat([v.flatten() for v in gr.values()])  # noqa: E731
    errs = {on: (rel_err(runs[on][0], ref[0]), rel_err(cat(runs[on][2]), cat(ref[2])))
            for on in runs}
    per_param = {n: rel_err(runs[True][2][n], runs[False][2][n]) for n in runs[True][2]}
    worst = sorted(per_param.items(), key=lambda kv: -kv[1])[:3]
    ssg = [n for n in per_param if "to_scale_shift_gate" in n]
    log(f"  on vs off: output rel-L2 {rel_err(runs[True][0], runs[False][0]):.3g}; gradients of "
        f"all {len(per_param)} parameters: rel-L2 median "
        f"{statistics.median(per_param.values()):.3g}, largest "
        + ", ".join(f"{n} {e:.3g}" for n, e in worst)
        + f"; the {len(ssg)} to_scale_shift_gate gradients up to "
        f"{max(per_param[n] for n in ssg):.3g}")
    log(f"  against the fp32 DiT with the plain versions (loss {ref[1]:.7g}): output rel-L2 kernels "
        f"{errs[True][0]:.3g}, plain bf16 {errs[False][0]:.3g}; all gradients rel-L2 kernels "
        f"{errs[True][1]:.3g}, plain bf16 {errs[False][1]:.3g} (bound: kernels <= {DIT_ERR_RATIO} "
        f"x plain)")
    finite = all(torch.isfinite(v).all() for v in runs[True][2].values())
    moved = all(runs[True][2][n].abs().max() > 0 for n in ssg)
    if not (finite and moved and errs[True][0] <= DIT_ERR_RATIO * errs[False][0]
            and errs[True][1] <= DIT_ERR_RATIO * errs[False][1]):
        raise AssertionError("the adaLN DiT step with K11/K12 disagrees with the plain chains")
    layers = len(dit.transformer.layers)
    for on in (True, False):
        want = {name: 0 for name in KERNELS}
        want.update(ln_modulate=2 * layers if on else 0, gated_residual=2 * layers if on else 0,
                    fused_qkv_rope_attention_stats=layers, fused_qkv_rope_attention_backward=layers,
                    rope_pair_k=3 * layers)
        if counts[on] != want:
            raise AssertionError(f"one adaLN DiT step should launch {want}: {counts[on]}")
    return counts[True], counts[False]


def adaln_generation_phase(model, config):
    """[14] `generate_diffusion_cond` on the adaLN DiT in bench.py's bf16
    recipe, `fused_ew` on and then off, on the same noise (seed 42): the
    walls, s-audio/s and peak memory of each (`generation_phase`), the
    audio's rel-L2 between the two, and the launch counts (K11 and K12 2 per
    layer and step on, none off; K1 24 per step; the bf16 decode's K2-K4).
    Then `profile_adaln_forward`. Returns the counts of the two runs."""
    import torch

    launches, audio = {}, {}
    for on in (True, False):
        set_fused_ew(model, on)
        log(f"  fused_ew {'on' if on else 'off'}:")
        n = 2 * ADALN_LAYERS * STEPS if on else 0
        launches[on], audio[on], _ = generation_phase(
            model, config, PROMPT, SAMPLE_SIZE,
            expected={"ln_modulate": n, "gated_residual": n,
                      "fused_qkv_rope_attention": ADALN_LAYERS * STEPS,
                      "rope_pair_k": ADALN_LAYERS * STEPS,
                      "pair_long_attention": 0, "fused_residual_unit": 15,
                      "snake_conv_transpose1d": 5, **NO_TRAINING},
            min_counts=k2_counts(OOBLECK_DECODE_K2, torch.bfloat16))
    log(f"  audio fused_ew on vs off: rel-L2 {rel_err(audio[True], audio[False]):.4g}; card "
        f"{smi_line()}")
    profile_adaln_forward(model)
    return launches[True], launches[False]


ADALN_PROFILE_CALLS = 10


def profile_adaln_forward(model):
    """Where a denoising step's DiT call goes (CFG batch 2, 1024 frames, the
    model's bf16): the wall per call of ADALN_PROFILE_CALLS calls in turns
    (on, off, off, on; host clock, one synchronize per turn), then a
    `device_profile` of as many calls with `fused_ew` on and off: the
    device's busy time and share of the wall, its activities, K11 and K12's
    device time, and the largest activities, per call."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(31)
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner([PROMPT], device=DEVICE))
        x = torch.randn(1, ADALN_T, model.io_channels, generator=g, device=DEVICE)
        t = torch.full((1,), 0.6, device=DEVICE)
        call = lambda: model.model(x, t, cfg_scale=CFG_SCALE, **cond)  # noqa: E731
        walls = {True: [], False: []}
        for on in (True, False, False, True):
            set_fused_ew(model, on)
            call()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(ADALN_PROFILE_CALLS):
                call()
            torch.cuda.synchronize()
            walls[on].append((time.perf_counter() - start) / ADALN_PROFILE_CALLS * 1e3)
        for on in (True, False):
            set_fused_ew(model, on)
            busy, n, by_name = device_profile([call] * ADALN_PROFILE_CALLS)
            wall = statistics.mean(walls[on])
            ew = sum(ms for name, ms in by_name.items()
                     if "ln_modulate_kernel" in name or "gated_residual_kernel" in name)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
            log(f"  DiT call, fused_ew {'on' if on else 'off'}: wall {walls[on][0]:.3f}, "
                f"{walls[on][1]:.3f} ms; device busy {busy:.3f} ms = {busy / wall:.1%} of the wall "
                f"(idle {1 - busy / wall:.1%}); {n:.0f} device activities; K11 + K12 "
                f"{ew:.3f} ms; largest: " + ", ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
    set_fused_ew(model, True)


def sa1_unet_forward_phase(model):
    """[4c] One forward of SA 1.0's fp32 U-Net at 4096 latent frames with
    CFG (batch 2), through the kernels (K7 without its LSE at T 4096, 2048
    and 1024) and through their plain versions; same weights and inputs.
    Returns the inputs (x, t, conditioning) and the plain versions' output,
    [4d]'s reference."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(2)
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner([SA1_PROMPT], device=DEVICE))
        x = torch.randn(1, SA1_SAMPLE_SIZE // 1024, model.io_channels, generator=g, device=DEVICE)
        t = torch.full((1,), 0.6, device=DEVICE)
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out_k = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
        torch.cuda.synchronize()
        wall_k = time.perf_counter() - start
        counts = read_counts()
        with plain_kernels():
            start = time.perf_counter()
            out_p = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - start
    err = rel_err(out_k, out_p)
    log(f"  SA 1.0 U-Net forward {list(x.shape)} with CFG, fp32: kernels vs plain rel-L2 {err:.3g} "
        f"(tol {FP32_MODEL_RTOL}); wall kernels {wall_k:.4f} s, plain {wall_p:.4f} s; "
        f"launches {counts}")
    want = {name: 0 for name in KERNELS}
    want["flash_forward_serving"] = 14
    if not (torch.isfinite(out_k).all() and err <= FP32_MODEL_RTOL):
        raise AssertionError("the SA 1.0 U-Net with the kernels disagrees with the plain versions")
    if counts != want:
        raise AssertionError(f"one SA 1.0 U-Net forward should launch {want}: {counts}")
    return (x, t, cond), out_p


def cli_generation_phase(config_path, prompt, expected):
    """The generate CLI (`generate.main`) on `config_path` for one prompt:
    100 dpmpp-3m-sde steps, CFG 7, the model in its own fp32, random weights
    (seed 0), one WAV written under build/. Times the conditioners, the
    decode and the whole `generate_diffusion_cond` call, each between two
    synchronisations; every launch count is set to 0 just before and read
    just after, and must equal `expected` (kernels not named: 0). Returns
    the counts and the generation's s-audio/s."""
    import wave

    import torch
    import yaml

    from friendly_stable_audio_tools_tpu_torch import generate
    from friendly_stable_audio_tools_tpu_torch.inference import generation
    from friendly_stable_audio_tools_tpu_torch.models.conditioners import MultiConditioner
    from friendly_stable_audio_tools_tpu_torch.models.pretransforms import AutoencoderPretransform

    config = json.loads(Path(config_path).read_text())
    times, outputs = {}, []

    def timer(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key] = times.get(key, 0.0) + time.perf_counter() - start
            if key == "total":
                outputs.append(out)
            return out
        return wrapper

    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        prompts = Path(tmp) / "prompts.yaml"
        prompts.write_text(yaml.safe_dump({"smoke": {"p0": prompt}}))
        args = ["--model-config", str(config_path), "--cond-yaml-path", str(prompts),
                "--output-dir", str(Path(tmp) / "out"), "--sample-steps", str(STEPS),
                "--cfg-scale", str(CFG_SCALE), "--seed", "42", "--batch-size", "2"]
        with patched([(generation, "generate_diffusion_cond",
                       timer(generation.generate_diffusion_cond, "total")),
                      (MultiConditioner, "forward", timer(MultiConditioner.forward, "cond")),
                      (AutoencoderPretransform, "decode_nwc",
                       timer(AutoencoderPretransform.decode_nwc, "decode"))]):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            start = time.perf_counter()
            generate.main(args)
            cli_wall = time.perf_counter() - start
            launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        wavs = sorted(Path(tmp).rglob("*.wav"))
        with wave.open(str(wavs[0])) as f:
            wav_shape = (f.getnchannels(), f.getnframes())
    audio = outputs[0]
    n = config["sample_size"]
    seconds = n / config["sample_rate"]
    total, cond, decode = times["total"], times["cond"], times["decode"]
    denoise = total - cond - decode
    rms = audio.float().square().mean().sqrt().item()
    log(f"  card: {smi_line()}")
    log(f"  audio {list(audio.shape)} {audio.dtype} finite {bool(torch.isfinite(audio).all())} "
        f"rms {rms:.4g}; WAV {len(wavs)} file(s), channels x frames {wav_shape}")
    log(f"  wall: conditioners {cond:.4f} s, denoise {denoise:.4f} s ({denoise / STEPS * 1e3:.3f} "
        f"ms/step), decode {decode:.4f} s, generate_diffusion_cond {total:.4f} s = "
        f"{seconds / total:.3f} s-audio/s ({seconds:.2f} s of audio); the CLI incl. model build "
        f"{cli_wall:.1f} s; peak memory {peak:.2f} GiB")
    log(f"  launches {launches}")
    want = {name: 0 for name in KERNELS}
    want.update(expected)
    if (tuple(audio.shape) != (1, 2, n) or not torch.isfinite(audio).all() or rms <= 0
            or len(wavs) != 1 or wav_shape != (2, n)):
        raise AssertionError(f"the CLI's output is not finite [1, 2, {n}] audio in one WAV")
    if launches != want:
        raise AssertionError(f"launch counts {launches} are not the main path's {want}")
    return launches, seconds / total


def ae_grad_cases(rnd, batch, n):
    """[17]'s K2-K4 shapes under grad at Stable Audio 2.0's VAE, batch
    `batch` x `n` samples: (result entry, label, wrapper, plain version,
    inputs, static arguments); every input tensor requires grad."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    frames = n // 2048

    def leaf(*shape, scale=1.0):
        return rnd(*shape, scale=scale).requires_grad_(True)

    def sn(c):
        a, ib = snake_params(rnd, c)
        return [a.requires_grad_(True), ib.requires_grad_(True)]

    b = batch
    return [
        ("snake_conv1d_f32", f"B{b} T{n} 2->128 k7 (encoder conv_in, thin-in)",
         conv1d.snake_conv1d, conv1d.snake_conv1d_plain,
         [leaf(b, n, 2, scale=0.5), leaf(7, 2, 128, scale=0.25), leaf(128, scale=0.1), None, None],
         (1,)),
        ("snake_conv1d_f32", f"B{b} T{n} 128->2 k7 snake (decoder conv_out, thin-out)",
         conv1d.snake_conv1d, conv1d.snake_conv1d_plain,
         [leaf(b, n, 128, scale=0.5), leaf(7, 128, 2, scale=0.03), None] + sn(128), (1,)),
        ("snake_conv1d_wide_f32", f"B{b} T{frames} 2048->128 k3 snake (encoder conv_out, wide)",
         conv1d.snake_conv1d, conv1d.snake_conv1d_plain,
         [leaf(b, frames, 2048, scale=0.5), leaf(3, 2048, 128, scale=0.013),
          leaf(128, scale=0.1)] + sn(2048), (1,)),
        ("snake_conv1d_wide_f32", f"B{b} T{frames} 64->2048 k7 (decoder conv_in, wide)",
         conv1d.snake_conv1d, conv1d.snake_conv1d_plain,
         [leaf(b, frames, 64, scale=1.0), leaf(7, 64, 2048, scale=0.05), leaf(2048, scale=0.1),
          None, None], (1,)),
        ("fused_residual_unit_f32", f"B{b} T{n} C128 d1", conv1d.fused_residual_unit,
         conv1d.fused_residual_unit_plain,
         [leaf(b, n, 128, scale=0.5), leaf(7, 128, 128, scale=0.03), leaf(128, scale=0.1)]
         + sn(128) + [leaf(128, 128, scale=0.09), leaf(128, scale=0.1)] + sn(128), (1,)),
        ("fused_residual_unit_f32", f"B{b} T{n // 256} C1024 d9", conv1d.fused_residual_unit,
         conv1d.fused_residual_unit_plain,
         [leaf(b, n // 256, 1024, scale=0.5), leaf(7, 1024, 1024, scale=0.012),
          leaf(1024, scale=0.1)] + sn(1024) + [leaf(1024, 1024, scale=0.03),
                                               leaf(1024, scale=0.1)] + sn(1024), (9,)),
        ("snake_conv_transpose1d_f32", f"B{b} T{frames} 2048->1024 s8", conv1d.snake_conv_transpose1d,
         conv1d.snake_conv_transpose1d_plain,
         [leaf(b, frames, 2048, scale=0.5), leaf(16, 2048, 1024, scale=0.016),
          leaf(1024, scale=0.1)] + sn(2048), (8,)),
    ]


def ae_grad_phase(results, batch=TRAIN_BATCH, n=65536):
    """[17a] K2, K3 and K4 under grad, fp32 with TF32 off, at one shape of
    each route of Stable Audio 2.0's VAE at batch 8 x 65536: the autograd
    Function (the kernel's forward, the plain version's backward) against
    the plain version's own autograd on the same inputs and upstream
    gradient (rel-L2 of the output and of every input's gradient within
    AE_GRAD_RTOL; one launch of the kernel per call), both timed forward +
    backward; then under torch.no_grad() no graph and nothing kept beyond
    the output. Adds {label: {rel_l2, ms, plain_ms}} under "ae_grad" in
    each kernel's entry."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    rnd = randn_fn(17)
    for name, label, fn, plain, args, static in ae_grad_cases(rnd, batch, n):
        tensors = [a for a in args if a is not None]
        attr = KERNELS[name][1]
        before = getattr(conv1d, attr)
        y = fn(*args, *static)
        launched = getattr(conv1d, attr) - before
        g = rnd(*y.shape)
        got = torch.autograd.grad(y, tensors, g)
        y_ref = plain(*args, *static)
        want = torch.autograd.grad(y_ref, tensors, g)
        rels = [rel_err(a, b) for a, b in zip((y, *got), (y_ref, *want))]
        del y, y_ref, got, want
        ms = timed_ms(lambda: torch.autograd.grad(fn(*args, *static), tensors, g), 3)
        plain_ms = timed_ms(lambda: torch.autograd.grad(plain(*args, *static), tensors, g), 3)
        ok = max(rels) <= AE_GRAD_RTOL and launched == 1 and all(math.isfinite(r) for r in rels)
        results[name].setdefault("ae_grad", {})[label] = dict(rel_l2=max(rels), ms=ms,
                                                              plain_ms=plain_ms)
        log(f"  {name} under grad, {label}: rel-L2 output {rels[0]:.3g}, gradients "
            f"{', '.join(f'{r:.3g}' for r in rels[1:])} (tol {AE_GRAD_RTOL}); forward + backward "
            f"{ms:.4f} ms (kernel forward, plain backward) vs {plain_ms:.4f} ms (plain); "
            f"{launched} launch {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label}: the gradient through the kernel disagrees with "
                                 f"the plain version's, or the kernel launched {launched} times")
        del args, tensors, g
        torch.cuda.empty_cache()
    # under no_grad: the kernel alone, nothing saved
    x = rnd(batch, n, 128, scale=0.5).requires_grad_(True)
    w1, w2 = rnd(7, 128, 128, scale=0.03).requires_grad_(True), rnd(128, 128, scale=0.09)
    b1 = rnd(128, scale=0.1)
    (a1, i1), (a2, i2) = snake_params(rnd, 128), snake_params(rnd, 128)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = conv1d.fused_residual_unit(x, w1, b1, a1, i1, w2, b1, a2, i2, dilation=1)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - base
    log(f"  under torch.no_grad(): fused_residual_unit at B{batch} T{n} C128 keeps {kept} bytes "
        f"beyond its inputs (its output: {y.untyped_storage().nbytes()}), grad_fn {y.grad_fn}")
    if y.grad_fn is not None or kept != y.untyped_storage().nbytes():
        raise AssertionError("a kernel under torch.no_grad() kept more than its output")


def oobleck_ae_counts(config):
    """What one forward of an Oobleck autoencoder (encode, then decode)
    launches, fp32: K3 for each residual unit (3 per block, encoder and
    decoder), K4 for each decoder upsample, K2 for the encoder's and the
    decoder's conv_in and conv_out on the route `conv_route` gives each
    (Stable Audio 2.0's VAE: thin for the encoder's conv_in and the
    decoder's conv_out, wide for the other two); nothing else."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    enc, dec = config["model"]["encoder"]["config"], config["model"]["decoder"]["config"]
    top = enc["c_mults"][-1] * enc["channels"]
    counts = encoder_counts(config)
    counts["fused_residual_unit_f32"] *= 2
    counts["snake_conv_transpose1d_f32"] = len(dec["strides"])
    for cin, cout, k in ((dec["latent_dim"], top, 7), (dec["channels"], dec["out_channels"], 7)):
        wide = conv1d.conv_route(cin, cout, k, torch.float32) == "wide"
        counts["snake_conv1d_wide_f32" if wide else "snake_conv1d_f32"] += 1
    return counts


def ae_forward_counts(model, config):
    """One encode + decode of a short clip under torch.no_grad(), with the
    counts set to 0 just before and read just after."""
    import torch

    x = torch.zeros(1, 4 * model.downsampling_ratio, model.in_channels, device=DEVICE)
    reset_counts()
    with torch.no_grad():
        model.decode_nwc(model.encode_nwc(x))
    return read_counts()


def ae_reals(config, batch, seed):
    """[batch, sample_size, channels] synthetic audio on the card."""
    import numpy as np
    import torch

    n = config["sample_size"]
    audio = [synthetic_audio(seed + i, n, config["sample_rate"])[:config["audio_channels"]].T
             for i in range(batch)]
    return torch.from_numpy(np.stack(audio)).to(DEVICE)


def port_conv_ms(by_name):
    return sum(ms for name, ms in by_name.items() if any(k in name for k in PORT_CONV_KERNELS))


def ae_step_phase(config):
    """[17b] Stable Audio 2.0's VAE (random weights, seed 0) and its AE-GAN
    wrapper from the factories: one generator step's launches at batch 8
    (one forward's: `oobleck_ae_counts`), its losses and gradients with the
    kernels against the plain versions on the same reals and VAE noise at
    batch 2 (AE_STEP_RTOL; the plain versions' autograd at batch 8 would
    not fit the card),
    and its device time split under torch.profiler: the autoencoder's
    forward (the port's kernels and the rest), the discriminator and the
    losses (forward and backward, on the decoded audio as a leaf), and the
    backward through the autoencoder (the plain versions' autograd): the
    whole step less the two. Also builds every shipped autoencoder config
    and its wrapper on the card."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.training.autoencoders import AutoencoderTrainingWrapper
    from friendly_stable_audio_tools_tpu_torch.training.factory import (
        create_training_wrapper_from_config,
    )

    for path in sorted(AE_CONFIGS.glob("*.json")):
        cfg = json.loads(path.read_text())
        m = create_model_from_config(cfg, device=DEVICE)
        w = create_training_wrapper_from_config(cfg, m)
        n_params = sum(p.numel() for p in m.parameters())
        log(f"  {path.name}: {n_params / 1e6:.3f} M autoencoder and "
            f"{sum(p.numel() for p in w.disc_params) / 1e6:.3f} M discriminator parameters on "
            f"{next(m.parameters()).device}")
        if not isinstance(w, AutoencoderTrainingWrapper):
            raise AssertionError(f"{path.name}: the factory gave {type(w).__name__}")
        del m, w
    torch.cuda.empty_cache()

    model = create_model_from_config(config, device=DEVICE)
    wrapper = create_training_wrapper_from_config(config, model)
    g = torch.Generator(device=DEVICE).manual_seed(5)

    def inputs(batch):
        shape = (batch, config["sample_size"] // model.downsampling_ratio, model.latent_dim)
        return ae_reals(config, batch, 300), {"noise": torch.randn(shape, generator=g,
                                                                   device=DEVICE)}

    def gen_step(reals, draws):
        wrapper.gen_optimizer.zero_grad(set_to_none=True)
        _, metrics = wrapper.generator_step(reals, draws)
        return {k: v.item() for k, v in metrics.items()}, [p.grad for p in wrapper.gen_params]

    reals, draws = inputs(TRAIN_BATCH)
    gen_step(reals, draws)  # warm-up
    reset_counts()
    gen_step(reals, draws)
    counts = read_counts()
    # the plain versions' autograd keeps every layer's fp32 temporaries (the
    # autograd Functions keep only their inputs): batch 2 for the compare
    small = inputs(2)
    metrics, grads = gen_step(*small)
    with plain_kernels():
        metrics_p, grads_p = gen_step(*small)
        _, grads_q = gen_step(small[0] * (1 + 2.0 ** -20), small[1])
    loss_rel = max(abs(metrics[k] - metrics_p[k]) / max(abs(metrics_p[k]), 1e-12) for k in metrics)
    flat_p = torch.cat([b.flatten() for b in grads_p])
    whole = rel_err(torch.cat([a.flatten() for a in grads]), flat_p)
    whole_q = rel_err(torch.cat([q.flatten() for q in grads_q]), flat_p)
    norm = flat_p.norm().item()
    names = [n for n, _ in wrapper.gen_named]
    per = sorted((((a - b).norm().item() / norm, rel_err(a, b), rel_err(q, b), n)
                  for a, b, q, n in zip(grads, grads_p, grads_q, names)), reverse=True)
    finite = all(torch.isfinite(a).all() and a.abs().max() > 0 for a in grads)
    log(f"  generator step at batch 2, kernels vs plain versions: losses {metrics}; largest relative "
        f"loss difference {loss_rel:.3g}; gradient rel-L2 {whole:.3g} as a whole (the plain "
        f"versions on reals x (1 + 2^-20): {whole_q:.3g}); "
        f"largest per parameter, as a share of the whole's norm, its own rel-L2 and the perturbed "
        f"plain run's: " + ", ".join(f"{n} {e:.3g} / {r:.3g} / {q:.3g}" for e, r, q, n in per[:4])
        + f" (tol {AE_STEP_RTOL}); all {len(grads)} gradients finite and nonzero: {finite}")
    want = oobleck_ae_counts(config)
    if counts != want:
        raise AssertionError(f"a generator step launched {counts}, expected {want}")
    if not (finite and loss_rel <= AE_STEP_RTOL[0] and whole <= AE_STEP_RTOL[1]
            and per[0][0] <= AE_STEP_RTOL[1]):
        raise AssertionError("the generator step with the kernels disagrees with the plain versions")
    del grads, grads_p, grads_q, small, flat_p
    wrapper.gen_optimizer.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # the split of a generator step's device time, batch 8
    with torch.no_grad():
        decoded = model.decode_nwc(model.encode_nwc(reals))

    def disc_and_losses():
        d = decoded.detach().requires_grad_(True)
        r, f = reals.transpose(1, 2), d.transpose(1, 2)
        info = {"reals": r, "decoded": f, "reals_left": r[:, 0:1], "reals_right": r[:, 1:2],
                "decoded_left": f[:, 0:1], "decoded_right": f[:, 1:2],
                "kl": torch.zeros((), device=DEVICE)}
        dis, adv, fm = wrapper.discriminator.loss(reals, d)
        info.update(loss_dis=dis, loss_adv=adv, feature_matching_distance=fm)
        wrapper.losses_gen(info)[0].backward()

    wrapper.discriminator.requires_grad_(False)
    fwd_ms, _, fwd = device_profile([lambda: wrapper.forward_info(reals, False, draws)])
    dl_ms, _, _ = device_profile([disc_and_losses])
    step_ms, n_act, step = device_profile([lambda: gen_step(reals, draws)])
    conv_fwd = port_conv_ms(fwd)
    log(f"  generator step, device time (torch.profiler, {n_act:.0f} activities): {step_ms:.3f} ms "
        f"= autoencoder forward {fwd_ms:.3f} ms (the port's K2/K3/K4 {conv_fwd:.3f} ms, the rest "
        f"{fwd_ms - conv_fwd:.3f}) + discriminator and losses forward and backward {dl_ms:.3f} ms "
        f"+ the autoencoder's backward (the plain versions' autograd) "
        f"{step_ms - fwd_ms - dl_ms:.3f} ms; card {smi_line()}")
    if port_conv_ms(step) <= 0 or step_ms <= 0:
        raise AssertionError("the profiled generator step shows no device time in the port's kernels")
    del model, wrapper, reals, decoded
    torch.cuda.empty_cache()
    return counts


def ae_step_recorder(records):
    """A replacement for AutoencoderTrainingWrapper.train_step that times each
    step between two synchronisations and records its kind, launches (the
    counts' increase), metrics, whether every parameter it trained has a
    finite nonzero gradient and whether it moved the EMA."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.training.autoencoders import AutoencoderTrainingWrapper

    original = AutoencoderTrainingWrapper.train_step

    def train_step(self, reals, *a, **kw):
        disc = self.step % 2 == 1 and self.step >= self.warmup_steps
        ema = [e.clone() for e in self.ema] if self.ema is not None else []
        before = read_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = original(self, reals, *a, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        named = self.discriminator.named_parameters() if disc else self.gen_named
        bad, zero = [], []
        for name, p in named:
            if p.grad is None or not torch.isfinite(p.grad).all():
                bad.append(name)
            elif p.grad.abs().max() == 0:
                zero.append(name)
        records.append(dict(
            kind="disc" if disc else "gen", seconds=seconds, metrics=metrics,
            counts={k: v - before[k] for k, v in read_counts().items()}, bad=bad, zero=zero,
            has_ema=self.ema is not None,
            ema_moved=any(not torch.equal(e, f) for e, f in zip(ema, self.ema or []))))
        return metrics

    return [(AutoencoderTrainingWrapper, "train_step", train_step)]


def check_ae_steps(records, per_step, label):
    """Every loss finite, every trained parameter's gradient finite and
    nonzero, the EMA (where kept) moved by generator steps only, `per_step`
    launches in each step. A discriminator's logit biases (`conv_post.bias`) are the
    exception to nonzero: while every logit sits inside the hinge's margin,
    their gradient is -1 + 1 = 0 exactly (the mean of the real branch's
    minus the fake branch's)."""
    for i, r in enumerate(records):
        if not all(math.isfinite(v) for v in r["metrics"].values()):
            raise AssertionError(f"{label} step {i}: a loss is not finite: {r['metrics']}")
        zero = [n for n in r["zero"] if not (r["kind"] == "disc" and n.endswith("conv_post.bias"))]
        if r["bad"] or zero:
            raise AssertionError(f"{label} step {i} ({r['kind']}): gradients missing or not "
                                 f"finite {r['bad']}, zero {zero}")
        if r["ema_moved"] != (r["has_ema"] and r["kind"] == "gen"):
            raise AssertionError(f"{label} step {i} ({r['kind']}): EMA moved {r['ema_moved']}")
        if r["counts"] != per_step:
            raise AssertionError(f"{label} step {i}: launches {r['counts']}, expected {per_step}")


def log_ae_steps(records, config, label):
    """Logs each step and the generator and discriminator s/step, and the
    trained s-audio/s over the mean step, the first step left out where
    there are more than two."""
    import torch

    seconds = config["sample_size"] / config["sample_rate"]
    later = records[1:] if len(records) > 2 else records
    mean = statistics.mean(r["seconds"] for r in later)
    by_kind = {k: [r["seconds"] for r in later if r["kind"] == k]
               or [r["seconds"] for r in records if r["kind"] == k] for k in ("gen", "disc")}
    log(f"  {label}: steps " + "; ".join(
        f"{r['kind']} {r['seconds']:.4f} s loss {r['metrics']['loss']:.5g}, zero gradients "
        f"{r['zero']}" for r in records))
    log(f"  {label}: generator {statistics.mean(by_kind['gen'] or [0]):.4f} s/step, discriminator "
        f"{statistics.mean(by_kind['disc'] or [0]):.4f} s/step; mean step {mean:.4f} s = "
        f"{TRAIN_BATCH * seconds / mean:.4f} s-audio/s trained ({TRAIN_BATCH} x {seconds:.3f} s); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {smi_line()}")


def ae_training_phase(config, tmp):
    """[17c] The train entry point on Stable Audio 2.0's VAE as written:
    AE_STEPS steps at batch 8 from AE_WAVS synthetic stereo WAVs (generator
    and discriminator in turn), checkpoints every 2 steps; then a resume from
    the step-2 checkpoint for one more step, and the EMA-preferring export
    loaded back into a new model. Returns the launch counts of the two runs."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config, train

    cfg = copy.deepcopy(config)
    cfg["training"]["checkpoint"]["every_n_train_steps"] = 2
    args = train_args(cfg, tmp, "ae", AE_WAVS, AE_WAV_SECONDS)
    per_step = oobleck_ae_counts(config)
    records = []
    with patched(ae_step_recorder(records)):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        trainer = train.main(args + ["--max-steps", str(AE_STEPS)])
        total = time.perf_counter() - start
        counts = read_counts()
        ckpt = Path(trainer.ckpt_dir) / "step_2"
        steps_done = trainer.wrapper.step
        log_ae_steps(records, config, f"train CLI, {AE_STEPS} steps (run incl. set-up {total:.1f} s)")
        del trainer
        torch.cuda.empty_cache()
        reset_counts()
        resumed = train.main(args + ["--max-steps", "3", "--ckpt-path", str(ckpt)])
        counts_resume = read_counts()
    records, resumed_records = records[:AE_STEPS], records[AE_STEPS:]
    check_ae_steps(records, per_step, "train CLI")
    check_ae_steps(resumed_records, per_step, "resumed")
    if [r["kind"] for r in records + resumed_records] != ["gen", "disc"] * (AE_STEPS // 2) + ["gen"]:
        raise AssertionError(f"steps {[r['kind'] for r in records + resumed_records]} do not "
                             f"alternate from the checkpoint's step")
    w = resumed.wrapper
    path = Path(tmp) / "vae.pt"
    w.export_model(str(path))
    model = create_model_from_config(cfg, device=DEVICE)
    model.load_state_dict(torch.load(path, map_location=DEVICE, weights_only=True), strict=True)
    params = dict(model.named_parameters())
    same = all(torch.equal(params[n], e) for (n, _), e in zip(w.gen_named, w.ema))
    log(f"  resumed from step 2: step {w.step}, {resumed_records[0]['kind']} step "
        f"{resumed_records[0]['seconds']:.4f} s, launches {counts_resume}; export {path.name} "
        f"loaded strictly, equal to the EMA: {same}")
    if not (steps_done == AE_STEPS and w.step == 3 and same):
        raise AssertionError("the step count, the resume or the export is off")
    if counts != {k: v * AE_STEPS for k, v in per_step.items()}:
        raise AssertionError(f"launch counts {counts} are not {AE_STEPS} x {per_step}")
    del resumed, w, model
    torch.cuda.empty_cache()
    return counts, counts_resume


def ae_config_steps_phase(config, label):
    """[17d] One generator and one discriminator step of another shipped
    autoencoder config as written, at batch 8 x its sample size from
    synthetic audio, through its wrapper: the same checks, each step
    launching what one forward of the autoencoder launches. Returns the
    launch counts of the two steps."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.training.factory import (
        create_training_wrapper_from_config,
    )

    model = create_model_from_config(config, device=DEVICE)
    wrapper = create_training_wrapper_from_config(config, model)
    per_step = ae_forward_counts(model, config)
    reals = ae_reals(config, TRAIN_BATCH, 400)
    records = []
    torch.cuda.reset_peak_memory_stats()
    with patched(ae_step_recorder(records)):
        reset_counts()
        for _ in range(2):
            wrapper.train_step(reals)
        counts = read_counts()
    log_ae_steps(records, config, label)
    log(f"  {label}: launches per step {per_step}")
    check_ae_steps(records, per_step, label)
    if [r["kind"] for r in records] != ["gen", "disc"] or sum(per_step.values()) == 0:
        raise AssertionError(f"{label}: the steps do not alternate, or launch no kernel")
    del model, wrapper, reals
    torch.cuda.empty_cache()
    return counts


def ae_reconstruct_phase(config, tmp):
    """[17e] The port's reconstruct CLI on a synthetic RECON_SECONDS s stereo
    WAV through Stable Audio 2.0's VAE (random weights): the output as long
    as the input, finite, and each chunk's encode + decode launching one
    forward's kernels. Returns the launch counts."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from friendly_stable_audio_tools_tpu_torch import reconstruct_audios
    from friendly_stable_audio_tools_tpu_torch.models.autoencoders import AudioAutoencoder

    tmp = Path(tmp)
    src, out = tmp / "recon_in", tmp / "recon_out"
    src.mkdir()
    sr = config["sample_rate"]
    n = RECON_SECONDS * sr
    wavfile.write(str(src / "clip.wav"), sr, (synthetic_audio(500, n, sr).T * 32767).astype(np.int16))
    (tmp / "recon_model.json").write_text(json.dumps(config))
    seen = []
    original = AudioAutoencoder.reconstruct_nwc

    def recorded(self, x, *a, **kw):
        y = original(self, x, *a, **kw)
        seen.append((tuple(x.shape), tuple(y.shape), bool(torch.isfinite(y).all())))
        return y

    ratio = config["model"]["downsampling_ratio"]
    chunk = int(sr / ratio)  # --frame-duration 1.0
    overlap = max(int(sr * 0.01 / ratio), 1)
    padded = -(-n // ratio) * ratio
    n_chunks = max(math.ceil((padded - chunk * ratio) / ((chunk - overlap) * ratio)) + 1, 1)
    with patched([(AudioAutoencoder, "reconstruct_nwc", recorded)]):
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        reconstruct_audios.main(["--model-config", str(tmp / "recon_model.json"), "--audio-dir",
                                 str(src), "--output-dir", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = read_counts()
    rate, data = wavfile.read(str(out / "clip.wav"))
    want = {k: v * n_chunks for k, v in oobleck_ae_counts(config).items()}
    log(f"  reconstruct CLI: {RECON_SECONDS} s stereo at {sr} Hz in {n_chunks} chunks of {chunk} "
        f"latents (overlap {overlap}), {wall:.3f} s wall incl. set-up; round trip {seen}; written "
        f"{data.shape} at {rate} Hz; launches {counts}")
    if not (seen and seen[0][2] and data.shape == (n, 2) and rate == sr):
        raise AssertionError("the reconstruction is not finite audio of the input's length")
    if counts != want:
        raise AssertionError(f"reconstruct launches {counts}, expected {want}")
    return counts


def new_results():
    """The per-kernel results, keyed by kernel: where it comes from, what
    its times are per (`per`), and each main-path shape's weight (calls per
    `per`); the phases add their numbers."""
    src = "friendly_stable_audio_tools_tpu_torch/csrc/"
    tpu = "friendly_stable_audio_tools_tpu/ops/pallas/"
    # what `ms` and the other times of each kernel's entry are per
    results = {
        "fused_qkv_rope_attention": dict(
            route="cuda", source=src + "attention.cu", replaces=tpu + "flash_attention.py:828",
            per="SAO 1.0 generation step (24 calls at B2 T1025)"),
        "rope_pair_k": dict(
            route="cuda", source=src + "attention_rope.cu", replaces=tpu + "flash_attention.py:1229",
            per=f"SA 2.0 generation step (24 calls at B2 T{LONG_T})"),
        "pair_long_attention": dict(
            route="cuda", source=src + "attention.cu", replaces=tpu + "flash_attention.py:1233",
            per=f"SA 2.0 generation step (24 calls at B2 T{LONG_T} kv_len {LONG_KV})"),
        "fused_qkv_rope_attention_stats": dict(
            route="cuda", source=src + "attention.cu", replaces=tpu + "flash_attention.py:980",
            per=f"SAO 1.0 training step (48 calls at B{TRAIN_BATCH} T{TRAIN_T})"),
        "fused_qkv_rope_attention_backward": dict(
            route="cuda", source=src + "attention_bwd.cu", replaces=tpu + "flash_attention.py:1119",
            per=f"SAO 1.0 training step (24 calls at B{TRAIN_BATCH} T{TRAIN_T})"),
        "flash_forward": dict(
            route="cuda", source=src + "flash_attention.cu", replaces=tpu + "flash_attention.py:230",
            per=f"SA 2.0 training step (48 calls at B{TRAIN_BATCH} H24 T{LONG_T} kv_len {LONG_KV})"),
        "flash_backward": dict(
            route="cuda", source=src + "flash_attention_bwd_f32.cu",
            replaces=tpu + "flash_attention.py:565",
            per=f"SA 2.0 training step (24 calls at B{TRAIN_BATCH} H24 T{LONG_T} kv_len {LONG_KV})"),
        "flash_backward_fused": dict(
            route="cuda", source=src + "flash_attention_bwd_f32.cu",
            replaces=tpu + "flash_attention.py:426",
            per=f"SA 1.0 training step (14 calls at B{TRAIN_BATCH} x H16: 2 at T4096 D64, 6 at "
                f"T2048 D64, 6 at T1024 D80)"),
        "snake_conv1d": dict(route="cuda", source=src + "conv1d.cu", replaces=tpu + "conv1d.py:91",
                             per="SA 2.0 decode (1 call on the thin route: conv_out 128 -> 2)"),
        "snake_conv1d_wide": dict(route="cuda", source=src + "conv_wgmma.cu",
                                  replaces=tpu + "conv1d.py:91",
                                  per="SA 2.0 decode (1 call on the wide route: conv_in 64 -> 2048)"),
        "fused_residual_unit": dict(route="cuda", source=src + "residual_unit.cu",
                                    replaces=tpu + "conv1d.py:507", per="SA 2.0 decode (15 calls)"),
        "snake_conv_transpose1d": dict(route="cuda", source=src + "conv_wgmma.cu",
                                       replaces=tpu + "conv1d.py:262", per="SA 2.0 decode (5 calls)"),
        "flash_forward_serving": dict(
            route="cuda", source=src + "flash_attention.cu", replaces=tpu + "flash_attention.py:230",
            per="SA 1.0 U-Net forward (14 calls at B2 x H16: 2 at T4096 D64, 6 at T2048 D64, 6 at "
                "T1024 D80)"),
        "flash_forward_bf16": dict(
            route="cuda", source=src + "flash_attention_bf16.cu",
            replaces=tpu + "flash_attention.py:230",
            per="SA 1.0 U-Net forward in bench.py's bf16 recipe (14 calls at B2 x H16: 2 at T4096 "
                "D64, 6 at T2048 D64, 6 at T1024 D80)"),
        "snake_conv1d_f32": dict(route="cuda", source=src + "conv1d.cu",
                                 replaces=tpu + "conv1d.py:91",
                                 per="SA 1.0 DAC decode (1 call on the thin route: conv_out 96 -> 2)"),
        "snake_conv1d_wide_f32": dict(route="cuda", source=src + "conv_wgmma.cu",
                                      replaces=tpu + "conv1d.py:91",
                                      per="SA 1.0 DAC decode (25 calls on the wide route)"),
        "fused_residual_unit_f32": dict(route="cuda", source=src + "residual_unit.cu",
                                        replaces=tpu + "conv1d.py:507",
                                        per="SAO 1.0 fp32 decode (15 calls)"),
        "snake_conv_transpose1d_f32": dict(route="cuda", source=src + "conv_wgmma.cu",
                                           replaces=tpu + "conv1d.py:262",
                                           per="SA 1.0 DAC decode (4 calls)"),
        "flash_forward_causal": dict(
            route="cuda", source=src + "flash_attention.cu", replaces=tpu + "flash_attention.py:146",
            per=f"audio LM training step ({LM_LAYERS} calls at B{TRAIN_BATCH} x H{LM_HEADS} T{LM_T})"),
        "flash_forward_causal_serving": dict(
            route="cuda", source=src + "flash_attention.cu", replaces=tpu + "flash_attention.py:146",
            per=f"audio LM no-grad forward ({LM_LAYERS} calls at B{TRAIN_BATCH} x H{LM_HEADS} "
                f"T{LM_T})"),
        "flash_backward_causal": dict(
            route="cuda", source=src + "flash_attention_bwd_f32.cu",
            replaces=tpu + "flash_attention.py:565",
            per=f"audio LM training step ({LM_LAYERS} calls at B{TRAIN_BATCH} x H{LM_HEADS} T{LM_T})"),
        "glu_mlp": dict(
            route="cuda", source=src + "glu_mlp.cu", replaces=tpu + "mlp.py:145",
            per=f"audio LM decode step ({LM_LAYERS} calls at M2 K1024 inner4096 Kout1024, fp32; "
                f"the streaming route)"),
        "glu_mlp_tensor": dict(
            route="cuda", source=src + "glu_mlp.cu", replaces=tpu + "mlp.py:145",
            per="SAO 1.0 bf16 CFG step with fused_mlp (24 calls at M2050 K1536 inner6144 "
                "Kout1536; the tensor-core route)"),
        "ln_modulate": dict(
            route="cuda", source=src + "elementwise.cu", replaces=tpu + "elementwise.py:98",
            per=f"adaLN DiT generation step ({2 * ADALN_LAYERS} calls at B2 T{ADALN_T} "
                f"D{ADALN_DIM}, bf16)"),
        "gated_residual": dict(
            route="cuda", source=src + "elementwise.cu", replaces=tpu + "elementwise.py:167",
            per=f"adaLN DiT generation step ({2 * ADALN_LAYERS} calls at B2 T{ADALN_T} "
                f"D{ADALN_DIM}, bf16)"),
        "flash_forward_d32": dict(
            route="cuda", source=src + "flash_attention.cu", replaces=tpu + "flash_attention.py:230",
            per=f"Dance Diffusion U-Net forward at {DD_LONG} samples (24 calls at B1 x H16 D32: 6 "
                f"each at T8192, T4096, T2048 and T1024)"),
        "flash_backward_fused_d32": dict(
            route="cuda", source=src + "flash_attention_bwd_f32.cu",
            replaces=tpu + "flash_attention.py:426",
            per="Dance Diffusion training step at 2 x 262,144 samples (6 calls at B2 x H16 T1024 "
                "D32)"),
        "flash_backward_d32": dict(
            route="cuda", source=src + "flash_attention_bwd_f32.cu",
            replaces=tpu + "flash_attention.py:565",
            per=f"Dance Diffusion training step at {DD_LONG} samples (6 calls at B1 x H16 T8192 "
                f"D32, the first attention level)"),
        "flash_rope_attention": dict(
            route="cuda", source=src + "flash_attention_rope.cu",
            replaces=tpu + "flash_attention.py:132",
            per=f"SAO 1.0 heads-128 generation step in bench.py's bf16 recipe (24 calls at B2 x "
                f"H{H128_HEADS} T{H128_T} D128: the rope pass, then the bf16 K7's rope instance "
                f"of flash_attention_bf16.cu, q roped inside; fp32_ms: the same in fp32, the "
                f"attention of flash_attention_rope.cu)"),
        "flash_forward_d128": dict(
            route="cuda", source=src + "flash_attention_d128.cu",
            replaces=tpu + "flash_attention.py:230",
            per=f"SAO 1.0 heads-128 training step at 24 layers (48 calls with the LSE at "
                f"B{TRAIN_BATCH} x H{H128_HEADS} T{H128_T} D128: the checkpointed blocks run it "
                f"twice)"),
        "flash_backward_fused_d128": dict(
            route="cuda", source=src + "flash_attention_d128.cu",
            replaces=tpu + "flash_attention.py:426",
            per=f"SAO 1.0 heads-128 training step at 24 layers (24 calls at B{TRAIN_BATCH} x "
                f"H{H128_HEADS} T{H128_T} D128)"),
    }
    for r in results.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, weight={})
    # extra fields: sao_decode_ms and sa2_decode_ms (K2-K4 per SAO 1.0 and SA
    # 2.0 decode), encode_ms and sa2_encode_ms (K2 and K3 per SAO 1.0 and SA
    # 2.0 training step's encode), sa1_train_ms (K7 with its LSE per SA 1.0
    # training step), sa1_encode_ms (the fp32 K2 per SA 1.0 training step's
    # DAC encode), sa1_decode_ms (the bf16 K2 and K4 per SA 1.0 DAC decode in
    # bench.py's recipe), sa2_xl_ms (K7 in fp32 and bf16 per SA 2.0 DiT
    # forward at 8448 latent frames), each with its plain_, bound_ and
    # library_ times
    results["fused_qkv_rope_attention"]["weight"] = {"B2 T1025 H24 kv_len None": 24}
    train_label = f"B{TRAIN_BATCH} T{TRAIN_T} H24 kv_len {TRAIN_KV}"
    results["fused_qkv_rope_attention_stats"]["weight"] = {train_label: 2 * 24}
    results["fused_qkv_rope_attention_backward"]["weight"] = {train_label: 24}
    long_label = f"B2 T{LONG_T} H24 kv_len {LONG_KV}"
    results["rope_pair_k"]["weight"] = {long_label: 24}
    results["pair_long_attention"]["weight"] = {long_label: 24}
    flash_label = f"B{TRAIN_BATCH} T{LONG_T} H24 kv_len {LONG_KV}"
    results["flash_forward"]["weight"] = {flash_label: 2 * 24}
    results["flash_backward"]["weight"] = {flash_label: 24}
    return results


# ---------------------------------------------------------------------------
# [18] the diffusion trainer's options
# ---------------------------------------------------------------------------

INPAINT_IDS = ["inpaint_mask", "inpaint_masked_input"]


def inpaint_variant(config):
    """SAO 1.0's config as a `diffusion_cond_inpaint` model, built in memory:
    the DiT takes the keep mask and the masked latents (1 + 64 channels) by
    input-concat; nothing else changes."""
    c = copy.deepcopy(config)
    c["model_type"] = "diffusion_cond_inpaint"
    c["model"]["diffusion"]["input_concat_ids"] = list(INPAINT_IDS)
    c["model"]["diffusion"]["config"]["input_concat_dim"] = 1 + c["model"]["io_channels"]
    return c


def option_inputs(model, config):
    """Batch 8 of synthetic clips at the config's sample size on the card (4
    clips, each twice), their metadata (each element valid over a prefix of
    50-100%: the padding masks `mask_padding` reads), their latents from
    the frozen encode, and fixed draws: uniform and logit-normal timesteps,
    noise, a CFG dropout mask dropping element 0's conditioning tokens."""
    import numpy as np
    import torch

    n = config["sample_size"]
    clips = [synthetic_audio(300 + i, n).T for i in range(TRAIN_BATCH // 2)]
    reals = torch.from_numpy(np.stack(clips * 2)).to(DEVICE)  # each clip twice, other masks
    metadata = []
    for i in range(TRAIN_BATCH):
        pm = np.zeros(n, np.float32)
        pm[:n * (TRAIN_BATCH + i) // (2 * TRAIN_BATCH)] = 1
        metadata.append(dict(PROMPT, seconds_start=i, seconds_total=PROMPT["seconds_total"] - i,
                             padding_mask=pm))
    with torch.no_grad():
        latents = model.pretransform.encode_nwc(reals)
    g = torch.Generator(device=DEVICE).manual_seed(18)
    draws = {"t": torch.rand(TRAIN_BATCH, generator=g, device=DEVICE),
             "noise": torch.randn(latents.shape, generator=g, device=DEVICE),
             "cfg_dropout_mask": torch.arange(TRAIN_BATCH, device=DEVICE) == 0,
             "padding_dropout": False}
    logit_t = torch.sigmoid(torch.randn(TRAIN_BATCH, generator=g, device=DEVICE))
    return reals, metadata, latents, draws, logit_t


def option_step(w, reals, metadata, draws, watched):
    """The wrapper's loss and its backward (the step's compute; the
    optimizer is the one every option shares) -> (loss, the DiT's output,
    watched grads)."""
    import torch

    for p in w.trainable.values():
        p.grad = None
    w.model.train()
    outputs = []
    hook = w.model.model.register_forward_hook(lambda m, i, o: outputs.append(o.detach()))
    try:
        loss, _ = w.loss(reals, metadata, 0, draws)
    finally:
        hook.remove()
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), outputs[0], {k: p.grad.detach().clone() for k, p in watched.items()}


def held_option_step(label, w, reals, metadata, draws, expected, masked=False):
    """One option's step with the kernels, its launches read around it and
    held to `expected`, then against the same step through the plain
    versions. A mask-free step as [6] holds its step: the attention through
    the plain bf16 pair versions and in fp32, the kernels' DiT output and
    watched gradients at most DIT_ERR_RATIO times as far (rel-L2) from fp32
    as the plain bf16 ones (the loss, one scalar of bf16-sized noise, within
    OPTION_LOSS_RTOL of fp32). A masked step (its attention plain in both,
    as in the JAX package) against every plain version, fp32 on both sides:
    the loss within SA2_LOSS_RTOL, the gradients SA2_GRAD_RTOL. Returns the
    launch counts."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention

    layers = w.model.model.transformer.layers
    depth = len(layers)
    watched = {f"layers.{i}.{p}": getattr(layers[i].self_attn, p).weight
               for i in (0, depth // 2 - 1, depth - 1) for p in ("to_qkv", "to_out")}
    pt = w.model.pretransform
    encoded = []
    reset_counts()
    start = time.perf_counter()
    with patched([(pt, "encode_nwc", lambda x: encoded.append(type(pt).encode_nwc(pt, x))
                   or encoded[-1])]):
        loss_k, out_k, grads_k = option_step(w, reals, metadata, draws, watched)
    wall = time.perf_counter() - start
    counts = read_counts()
    cat = lambda g: torch.cat([v.flatten() for v in g.values()])  # noqa: E731
    if masked:
        with plain_kernels():
            loss_r, out_r, grads_r = option_step(w, reals, metadata, draws, watched)
        err_k = rel_err(cat(grads_k), cat(grads_r))
        ok = abs(loss_k - loss_r) <= SA2_LOSS_RTOL * abs(loss_r) and err_k <= SA2_GRAD_RTOL
        detail = (f"every plain version {loss_r:.7g}; output rel-L2 {rel_err(out_k, out_r):.3g}, "
                  f"watched gradients {err_k:.3g}")
    else:
        # the attention is what these runs compare: the encode's latents
        # (K2/K3's, counted above) are reused rather than recomputed
        reuse = [(pt, "encode_nwc", lambda x: encoded[0])] if encoded else []
        with patched([(attention, "fused_qkv_rope_attention", plain_pair_attention)] + reuse):
            loss_p, out_p, grads_p = option_step(w, reals, metadata, draws, watched)
        with patched([(attention, "fused_qkv_rope_attention",
                       attention.fused_qkv_rope_attention_plain)] + reuse):
            loss_r, out_r, grads_r = option_step(w, reals, metadata, draws, watched)
        err_k, err_p = rel_err(cat(grads_k), cat(grads_r)), rel_err(cat(grads_p), cat(grads_r))
        out_k_err, out_p_err = rel_err(out_k, out_r), rel_err(out_p, out_r)
        ok = (abs(loss_k - loss_r) <= OPTION_LOSS_RTOL * abs(loss_r)
              and out_k_err <= DIT_ERR_RATIO * out_p_err and err_k <= DIT_ERR_RATIO * err_p)
        detail = (f"plain bf16 {loss_p:.7g}, fp32 attention {loss_r:.7g}; rel-L2 against fp32: "
                  f"output kernels {out_k_err:.3g}, plain bf16 {out_p_err:.3g}; watched gradients "
                  f"kernels {err_k:.3g}, plain bf16 {err_p:.3g}")
    finite = all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads_k.values())
    log(f"  {label}: loss with the kernels {loss_k:.7g}, {detail}; loss + backward wall with the "
        f"kernels {wall:.3f} s; launches {({k: v for k, v in counts.items() if v})}")
    if not (finite and ok):
        raise AssertionError(f"the {label} step with the kernels disagrees with the plain versions")
    if counts != expected:
        raise AssertionError(f"the {label} step launched {counts}, not {expected}")
    return counts


def timed_train_step(w, reals, metadata, draws):
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    metrics = w.train_step(reals, metadata, draws=[draws])
    torch.cuda.synchronize()
    if not math.isfinite(metrics["loss"]):
        raise AssertionError(f"the training step's loss is not finite: {metrics}")
    return time.perf_counter() - start


def training_options_phase(config):
    """[18a] SAO 1.0's full-width fp32 DiT (main() passes it at
    OPTIONS_DEPTH layers), batch 8, 1024 latent frames, fixed draws: a
    pre-encoded step (no encode: no K2/K3),
    a logit-normal step, a rectified-flow step and a `mask_padding` step
    (its self-attention masked: no attention kernel), each held against the
    plain versions; whole train steps (optimizer and EMA included) from
    pre-encoded latents and from raw audio, timed in turns; the weight-norm
    fold of the VAE (its encode before and after); then the inpaint
    variant's step. Returns the launch counts by step."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.models.utils import remove_weight_norm_
    from friendly_stable_audio_tools_tpu_torch.training.diffusion import (
        DiffusionCondInpaintTrainingWrapper,
        DiffusionCondTrainingWrapper,
    )

    per_step = launches_per_step(config, "pair")
    conv = {k for k in per_step if k.startswith(("snake_conv", "fused_residual"))}
    pre_encoded = {k: 0 if k in conv else v for k, v in per_step.items()}
    masked = {k: v if k in conv else 0 for k, v in per_step.items()}
    opt = config["training"]["optimizer_configs"]

    def wrapper(model, cls=DiffusionCondTrainingWrapper, **kw):
        return cls(model, optimizer_configs=opt, use_ema=False, **kw)

    model = build_model(config)
    reals, metadata, latents, draws, logit_t = option_inputs(model, config)
    counts = {"option_pre_encoded": held_option_step(
        "pre-encoded", wrapper(model, pre_encoded=True), latents, metadata, draws, pre_encoded)}
    counts["option_logit_normal"] = held_option_step(
        "logit-normal", wrapper(model, timestep_sampler="logit_normal"), reals, metadata,
        dict(draws, t=logit_t), per_step)
    model.diffusion_objective = "rectified_flow"
    counts["option_rectified_flow"] = held_option_step(
        "rectified flow", wrapper(model), reals, metadata, draws, per_step)
    model.diffusion_objective = "v"
    counts["option_mask_padding"] = held_option_step(
        "mask_padding", wrapper(model, mask_padding=True, mask_padding_dropout=0.1), reals,
        metadata, draws, masked, masked=True)

    w = DiffusionCondTrainingWrapper(model, optimizer_configs=opt)
    timed_train_step(w, reals, metadata, draws)  # its optimizer state allocated
    w.pre_encoded = True
    pre_s = timed_train_step(w, latents, metadata, draws)
    w.pre_encoded = False
    raw_s = timed_train_step(w, reals, metadata, draws)
    log(f"  a whole training step (conditioners, encode, DiT forward + backward, AdamW, EMA) at "
        f"batch {TRAIN_BATCH}, {len(model.model.transformer.layers)} layers: from pre-encoded "
        f"latents {pre_s:.4f} s, from raw audio "
        f"{raw_s:.4f} s (the frozen encode {raw_s - pre_s:.4f} s of it); card {smi_line()}")
    del w

    with torch.no_grad():
        clip = reals[:1]
        before = model.pretransform.encode_nwc(clip)
        remove_weight_norm_(model.pretransform.model)
        reset_counts()
        after = model.pretransform.encode_nwc(clip)
        fold_counts = read_counts()
    fold_err = rel_err(after, before)
    log(f"  the VAE's weight norm folded: encode rel-L2 against the unfolded one {fold_err:.3g} "
        f"(tol {FP32_MODEL_RTOL}), launches {({k: v for k, v in fold_counts.items() if v})}")
    if not (fold_err <= FP32_MODEL_RTOL and fold_counts["fused_residual_unit_f32"] > 0):
        raise AssertionError("the folded VAE's encode disagrees or left the kernels")
    del model, latents, before, after
    torch.cuda.empty_cache()

    inp_config = inpaint_variant(config)
    model = build_model(inp_config)
    w = wrapper(model, cls=DiffusionCondInpaintTrainingWrapper)
    draws["keep_mask"] = w.random_mask(TRAIN_BATCH, draws["noise"].shape[1])
    log(f"  inpaint keep masks: {[round(float(r.float().mean()), 3) for r in draws['keep_mask']]} "
        f"of each clip kept")
    counts["option_inpaint"] = held_option_step(
        f"inpaint (input_concat_dim {inp_config['model']['diffusion']['config']['input_concat_dim']})",
        w, reals, metadata, draws, per_step)
    del w, model, reals
    torch.cuda.empty_cache()
    return counts


def training_demo_phase(config, tmp):
    """[18b] The train entry point on SAO 1.0 (TRAIN_DEPTH layers): 2 steps
    with the config's demo every 2 steps (one demo, DEMO_CFG_SCALES,
    DEMO_STEPS sampler steps: cut from the config's 250),
    `--remove-pretransform-weight-norm post_load` and `--profile-dir` over
    step 2. Holds the demo's wavs, the folded VAE, the trace and the exact
    launches (2 steps' and the demo's); returns (train counts, demo
    counts)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import train
    from friendly_stable_audio_tools_tpu_torch.training.demos import DiffusionCondDemoCallback

    cfg = at_depth(config, TRAIN_DEPTH)
    cfg["training"]["demo"].update(demo_every=2, demo_steps=DEMO_STEPS, num_demos=1,
                                   demo_cfg_scales=DEMO_CFG_SCALES, demo_cond=[PROMPT])
    cfg["training"]["checkpoint"]["every_n_train_steps"] = 1000
    log(f"  the demo: {DEMO_STEPS} dpmpp-3m-sde steps (cut from the config's "
        f"{config['training']['demo']['demo_steps']}), cfg scales {DEMO_CFG_SCALES}, one prompt")
    args = train_args(cfg, tmp, "options", OPTION_WAVS, WAV_SECONDS)
    prof = Path(tmp) / "profile"
    demo_counts, demo_wall = {}, []
    run_demo = DiffusionCondDemoCallback.run_demo

    def counted(self, trainer, step, batch):
        before = read_counts()
        start = time.perf_counter()
        run_demo(self, trainer, step, batch)
        torch.cuda.synchronize()
        demo_wall.append(time.perf_counter() - start)
        demo_counts.update({k: v - before[k] for k, v in read_counts().items()})

    with patched([(DiffusionCondDemoCallback, "run_demo", counted)]):
        reset_counts()
        start = time.perf_counter()
        trainer = train.main(args + ["--max-steps", "2", "--remove-pretransform-weight-norm",
                                     "post_load", "--profile-dir", str(prof),
                                     "--profile-start-step", "1", "--profile-steps", "1"])
        total = time.perf_counter() - start
        counts = read_counts()
    samples = Path(trainer.save_dir) / "samples" / "2"
    wavs = sorted(p.name for p in samples.glob("*.wav")) if samples.is_dir() else []
    want_wavs = sorted([f"demo_cfg{s}_0.wav" for s in DEMO_CFG_SCALES] + ["pretransform_recon.wav"])
    names = [n for n, _ in trainer.wrapper.model.pretransform.named_parameters()]
    folded = any(n.endswith(".kernel") for n in names) and not any(
        n.endswith((".v", ".g")) for n in names)
    traces = sorted(prof.glob("*.json")) if prof.is_dir() else []
    trace_mb = traces[0].stat().st_size / 2**20 if traces else 0.0
    step = trainer.wrapper.step
    del trainer
    torch.cuda.empty_cache()
    per_step = launches_per_step(cfg, "pair")
    want = {k: 2 * v + demo_counts.get(k, 0) for k, v in per_step.items()}
    k1 = demo_counts.get("fused_qkv_rope_attention", 0)
    log(f"  2 steps + the demo in {total:.1f} s (the demo {demo_wall[0] if demo_wall else 0:.2f} s); "
        f"wavs {wavs}; VAE folded {folded}; trace {[t.name for t in traces]} {trace_mb:.1f} MiB")
    log(f"  the demo's launches: K1 {k1}, K10a {demo_counts.get('rope_pair_k', 0)}, fp32 K2 "
        f"{demo_counts.get('snake_conv1d_f32', 0)} thin + "
        f"{demo_counts.get('snake_conv1d_wide_f32', 0)} wide, fp32 K3 "
        f"{demo_counts.get('fused_residual_unit_f32', 0)}, fp32 K4 "
        f"{demo_counts.get('snake_conv_transpose1d_f32', 0)}; the run's {counts}")
    if not (step == 2 and wavs == want_wavs and folded and traces and trace_mb > 0):
        raise AssertionError("the train CLI's demo, weight-norm fold or profile window is missing")
    if not (k1 > 0 and k1 % TRAIN_DEPTH == 0 and demo_counts.get("rope_pair_k") == k1
            and demo_counts.get("snake_conv_transpose1d_f32", 0) > 0
            and demo_counts.get("fused_residual_unit_f32", 0) > 0):
        raise AssertionError(f"the demo did not run the generation and decode kernels: {demo_counts}")
    if counts != want:
        raise AssertionError(f"the run launched {counts}, not 2 steps' and the demo's {want}")
    return counts, demo_counts



# ---------------------------------------------------------------------------
# [3l] and [19] Dance Diffusion and the other diffusion model types
# ---------------------------------------------------------------------------

DD_CONFIG = REPO / ("friendly_stable_audio_tools_tpu/configs/model_configs/dance_diffusion/"
                    "dance_diffusion_base_44k.json")
DD_BATCH = 4  # the demo's count (training/demos.py:DiffusionDemoCallback)
DD_LONG = 2_097_152  # generate_diffusion_uncond's default length
DD_LONG_STEPS = 2
DD_HEADS = 16  # 512 channels in heads of 32
DD_T = (8192, 4096, 2048, 1024)  # the attention levels 9-12 at DD_LONG samples
DD_TRAIN_STEPS = 3
DD_WAVS = 8
DD_WAV_SECONDS = 3
DIFFAE_BATCH = 2
DIFFAE_STEPS = 100
PRIOR_STEPS = 8


def flash_d32_phase(results):
    """[3l] The fp32 K7 at head dim 32 (serving) against its plain version
    at Dance Diffusion's attention shapes at 2,097,152 samples (B1 x 16
    heads, T 8192 / 4096 / 2048 / 1024, 6 calls each per U-Net forward),
    SDPA on the same fp32 heads beside it; then the form with the LSE at T
    8192 (a 2,097,152-sample training step's first attention level; its
    backward is K9, [3m])."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(19)
    r = results["flash_forward_d32"]
    for t in DD_T:
        label = f"BH{DD_HEADS} T{t} D32"
        r["weight"][label] = 6
        q, k, v = (rnd(DD_HEADS, t, 32) for _ in range(3))
        bound = bound_ms(4 * DD_HEADS * t * t * 32, nbytes(q, k, v, q), peak=PEAK_FP32_ACCURATE)
        report(results, "flash_forward_d32", label, True, *compare(
            "flash_forward_d32", lambda: flash.flash_forward(q, k, v, save_stats=False)[0],
            lambda: flash.flash_forward_plain(q, k, v, save_stats=False)[0],
            library_fn=lambda: sdpa(q[None], k[None], v[None])), bound=bound,
            extra=f"; SDPA backend {sdpa_backend(q[None], k[None], v[None])}")
        del q, k, v
    t = DD_T[0]
    q, k, v = (rnd(DD_HEADS, t, 32) for _ in range(3))
    out, lse = flash.flash_forward(q, k, v)
    out_p, lse_p = flash.flash_forward_plain(q, k, v)
    ok, max_abs, rel_l2, peak = within("flash_forward_d32", out, out_p)
    lse_err = (lse - lse_p).abs().max().item()
    ms = timed_ms(lambda: flash.flash_forward(q, k, v), 3)
    plain_ms = timed_ms(lambda: flash.flash_forward_plain(q, k, v), 3)
    bound = bound_ms(4 * DD_HEADS * t * t * 32, nbytes(q, k, v, out, lse), peak=PEAK_FP32_ACCURATE)
    report(results, "flash_forward_d32", f"BH{DD_HEADS} T{t} D32 with its LSE", False,
           ok and lse_err <= FLASH_LSE_ATOL, max_abs, rel_l2, peak, ms, plain_ms, None,
           bound=bound, extra=f", lse max_abs {lse_err:.3g} (tol {FLASH_LSE_ATOL})")
    del q, k, v, out, lse, out_p, lse_p
    log(f"  flash_forward_d32: {r['ms']:.4f} ms per Dance Diffusion U-Net forward at {DD_LONG} "
        f"samples (24 calls), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, library "
        f"{r['library_ms']:.4f} ms")


def dd_flash_calls(config, sample_size):
    """The fp32 K7 launches of one DAU1d forward at `sample_size`: six
    self-attentions on each attention level whose length passes the flash
    gate (>= 1024 tokens; `dd_step_counts`)."""
    return dd_step_counts(config, sample_size)["flash_forward_d32"]


def dd_generate(model, label, batch, sample_size, steps, expected):
    """generate_diffusion_uncond (dpmpp-3m-sde, sigma 0.3 to 500) with the
    counts set to 0 just before and read just after and a wall per model
    evaluation (the step hook): checks the audio and the counts (`expected`,
    by kernel, exactly); returns (counts, audio, wall)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_uncond

    evals = []

    def hook(info):
        torch.cuda.synchronize()
        evals.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    audio = generate_diffusion_uncond(model, steps=steps, batch_size=batch,
                                      sample_size=sample_size, seed=0,
                                      sampler_type="dpmpp-3m-sde", sigma_min=0.3, sigma_max=500,
                                      callback=hook)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    counts = read_counts()
    gaps = [b - a for a, b in zip([start] + evals[:-1], evals)]
    seconds = batch * sample_size / model.sample_rate
    rms = audio.float().square().mean().sqrt().item()
    log(f"  {label}: audio {list(audio.shape)} rms {rms:.4g}; {steps} steps in {total:.3f} s = "
        f"{seconds / total:.3f} s-audio/s; per model evaluation {statistics.median(gaps) * 1e3:.2f} "
        f"ms (median of {len(gaps)}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K7 D32 launches "
        f"{counts['flash_forward_d32']}")
    if (tuple(audio.shape) != (batch, 2, sample_size) or not torch.isfinite(audio).all()
            or rms <= 0):
        raise AssertionError(f"{label}: not finite [{batch}, 2, {sample_size}] audio")
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, not {expected}")
    return counts, audio, total


def dd_generation_phase(config):
    """[19a] Each shipped dance_diffusion/*.json built on the card with one
    U-Net forward at its sample size (nothing launches: at most 512
    tokens of attention); then dance_diffusion_base_44k.json as written
    (223.2 M parameters, fp32, seed-0 weights) through
    generate_diffusion_uncond at the config's 65,536 samples, batch 4, 100
    steps: its attention (at most 256 tokens) stays plain, so nothing
    launches. Returns (the model, the counts)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config

    for path in sorted(DD_CONFIG.parent.glob("*.json")):
        other = json.loads(path.read_text())
        m = create_model_from_config(other, seed=0, device=DEVICE)
        x = torch.randn(1, other["sample_size"], m.io_channels, device=DEVICE)
        reset_counts()
        with torch.no_grad():
            y = m.model(x, torch.full((1,), 0.5, device=DEVICE))
        counts = read_counts()
        log(f"  {path.name}: built on the card, {sum(p.numel() for p in m.parameters()) / 1e6:.1f} "
            f"M parameters; one U-Net forward at {other['sample_size']} samples "
            f"{list(y.shape)}, launches {sum(counts.values())}")
        if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y).all() or any(counts.values()):
            raise AssertionError(f"{path.name}: the U-Net forward is off ({counts})")
        del m, x, y
        torch.cuda.empty_cache()
    model = create_model_from_config(config, seed=0, device=DEVICE)
    n = sum(p.numel() for p in model.parameters())
    log(f"  {DD_CONFIG.name}: {n / 1e6:.1f} M parameters, fp32")
    want = {name: 0 for name in KERNELS}
    want["flash_forward_d32"] = dd_flash_calls(config, config["sample_size"]) * STEPS
    counts, _, _ = dd_generate(model, f"generation at {config['sample_size']} samples, batch "
                               f"{DD_BATCH}", DD_BATCH, config["sample_size"], STEPS, want)
    return model, counts


def dd_long_phase(model, config):
    """[19b] The same model at 2,097,152 samples, batch 1: one U-Net forward
    with the kernels (24 fp32 K7 at head dim 32, `dd_flash_calls`) against
    the plain versions
    (rel-L2 FP32_MODEL_RTOL), then DD_LONG_STEPS sampler steps through
    generate_diffusion_uncond with a wall per evaluation. Returns the
    generation's counts."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.randn(1, DD_LONG, 2, generator=g, device=DEVICE)
    t = torch.full((1,), 0.6, device=DEVICE)
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.model(x, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = read_counts()
        with plain_kernels():
            torch.cuda.synchronize()
            start = time.perf_counter()
            ref = model.model(x, t)
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - start
    err = rel_err(out, ref)
    log(f"  one U-Net forward at {DD_LONG} samples: {wall:.3f} s with the kernels, {plain_wall:.3f} "
        f"s plain; rel-L2 {err:.3g} (tol {FP32_MODEL_RTOL}); launches {counts}")
    calls = dd_flash_calls(config, DD_LONG)
    want = {name: 0 for name in KERNELS}
    want["flash_forward_d32"] = calls
    if not (err <= FP32_MODEL_RTOL and torch.isfinite(out).all() and counts == want
            and calls > 0):
        raise AssertionError(f"the U-Net forward at {DD_LONG} samples: rel-L2 {err}, {counts}")
    del x, out, ref
    torch.cuda.empty_cache()
    counts, _, _ = dd_generate(model, f"generation at {DD_LONG} samples, batch 1", 1, DD_LONG,
                               DD_LONG_STEPS, {**want, "flash_forward_d32": calls * DD_LONG_STEPS})
    return counts


def dd_training_phase(config, tmp):
    """[19c] The train entry point on dance_diffusion_base_44k.json as written
    (it names no audio_channels; the CLI trains stereo): batch 8 from DD_WAVS
    synthetic stereo WAVs, DD_TRAIN_STEPS (3) steps with the demo (4 demos,
    DEMO_STEPS steps, cut from the config's 250) after step 2, a checkpoint
    at step 2 and a resume from it that runs step 3 again. Returns the counts of
    the two runs (nothing launches: the attention at 65,536 samples is
    plain)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import train
    from friendly_stable_audio_tools_tpu_torch.training.diffusion import (
        DiffusionUncondTrainingWrapper,
    )

    cfg = copy.deepcopy(config)
    cfg["training"]["demo"].update(demo_every=2, demo_steps=DEMO_STEPS)
    cfg["training"]["checkpoint"] = {"every_n_train_steps": 2}
    args = train_args({**cfg, "audio_channels": 2}, tmp, "dd", DD_WAVS, DD_WAV_SECONDS)
    (Path(tmp) / "dd_model.json").write_text(json.dumps(cfg))
    times, losses = [], []
    step = DiffusionUncondTrainingWrapper.train_step

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = step(self, *a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
        losses.append(out["loss"])
        return out

    with patched([(DiffusionUncondTrainingWrapper, "train_step", timed)]):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        trainer = train.main(args + ["--max-steps", str(DD_TRAIN_STEPS)])
        total = time.perf_counter() - start
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        samples = Path(trainer.save_dir) / "samples" / "2"
        wavs = sorted(p.name for p in samples.glob("*.wav")) if samples.is_dir() else []
        ckpt = Path(trainer.ckpt_dir) / "step_2"
        done = trainer.wrapper.step
        del trainer
        torch.cuda.empty_cache()
        reset_counts()
        resumed = train.main(args + ["--max-steps", str(DD_TRAIN_STEPS), "--ckpt-path",
                                     str(ckpt)])
        counts_resume = read_counts()
        resumed_step = resumed.wrapper.step
        del resumed
        torch.cuda.empty_cache()
    med = statistics.median(times[1:DD_TRAIN_STEPS])
    seconds = config["sample_size"] / config["sample_rate"]
    log(f"  steps {[round(x, 4) for x in times]} s (the last the resume's); median of steps "
        f"2-{DD_TRAIN_STEPS} {med:.4f} s = {TRAIN_BATCH * seconds / med:.3f} s-audio/s trained; "
        f"losses {[round(x, 5) for x in losses]}; peak memory {peak:.2f} GiB; run incl. set-up, "
        f"checkpoints and the demo {total:.1f} s; demo wavs {wavs}")
    if not (done == DD_TRAIN_STEPS and resumed_step == DD_TRAIN_STEPS and len(times) == 4
            and wavs == [f"demo_{i}.wav" for i in range(DD_BATCH)]
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError("the Dance Diffusion train CLI's steps, resume or demo are off")
    zero = {name: 0 for name in KERNELS}
    if counts != zero or counts_resume != zero:
        raise AssertionError(f"the train CLI launched {counts} / {counts_resume} at 65,536 samples")
    return counts, counts_resume


def diffae_config():
    """A diffusion autoencoder built in memory (no config is shipped; the
    layout of the JAX package's tests/test_training_other.py at full width):
    Stable Audio 2.0's VAE encoder and bottleneck, a dance_diffusion_base
    DAU1d decoder taking the 64 latent channels by input-concat, ratio 2048."""
    ae = json.loads(AE_CONFIG.read_text())
    dd = json.loads(DD_CONFIG.read_text())
    return {"model_type": "diffusion_autoencoder", "sample_size": dd["sample_size"],
            "sample_rate": ae["sample_rate"], "audio_channels": 2,
            "model": {"encoder": ae["model"]["encoder"], "bottleneck": ae["model"]["bottleneck"],
                      "diffusion": {"type": "DAU1d", "config": {
                          **dd["model"]["config"], "cond_dim": ae["model"]["latent_dim"]}},
                      "latent_dim": ae["model"]["latent_dim"],
                      "downsampling_ratio": ae["model"]["downsampling_ratio"], "io_channels": 2},
            "training": {"learning_rate": 1e-4}}


def encoder_counts(config):
    """What one encode of an Oobleck encoder launches, fp32: K3 per residual
    unit (3 per block) and K2 for conv_in and conv_out on their routes."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    enc = config["model"]["encoder"]["config"]
    want = {name: 0 for name in KERNELS}
    want["fused_residual_unit_f32"] = 3 * len(enc["c_mults"])
    for cin, cout, k in ((enc["in_channels"], enc["channels"], 7),
                         (enc["c_mults"][-1] * enc["channels"], enc["latent_dim"], 3)):
        wide = conv1d.conv_route(cin, cout, k, torch.float32) == "wide"
        want["snake_conv1d_wide_f32" if wide else "snake_conv1d_f32"] += 1
    return want


def diffae_phase():
    """[19d] The diffusion autoencoder: one train step at batch 2 x 65,536
    (the Oobleck encoder's fp32 K2 and K3 under grad: 2 and 15), then the
    encode and one DDIM decode of the batch at DIFFAE_STEPS steps (the
    encoder's kernels once more; the U-Net's attention is plain at 65,536
    samples). Returns (step counts, encode + decode counts)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.training.factory import (
        create_training_wrapper_from_config,
    )

    config = diffae_config()
    model = create_model_from_config(config, seed=0, device=DEVICE)
    w = create_training_wrapper_from_config(config, model)
    reals = ae_reals(config, DIFFAE_BATCH, 40)
    want = encoder_counts(config)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    metrics = w.train_step(reals, [{}] * DIFFAE_BATCH)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - start
    step_counts = read_counts()
    log(f"  train step at batch {DIFFAE_BATCH} x {config['sample_size']}: {step_s:.3f} s, loss "
        f"{metrics['loss']:.5f}, latent_std {metrics['latent_std']:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {step_counts}")
    if step_counts != want or not math.isfinite(metrics["loss"]):
        raise AssertionError(f"the diffusion autoencoder's step launched {step_counts}, not {want}")
    model.eval()
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.no_grad():
        latents = model.encode(reals.transpose(1, 2))
        recon = model.decode(latents, steps=DIFFAE_STEPS,
                             generator=torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - start
    decode_counts = read_counts()
    log(f"  encode + {DIFFAE_STEPS}-step DDIM decode: latents {list(latents.shape)}, audio "
        f"{list(recon.shape)} in {decode_s:.3f} s; launches {decode_counts}")
    if (tuple(recon.shape) != (DIFFAE_BATCH, 2, config["sample_size"])
            or not torch.isfinite(recon).all() or decode_counts != want):
        raise AssertionError(f"the DDIM decode: {list(recon.shape)}, launches {decode_counts}")
    del model, w, reals, latents, recon
    torch.cuda.empty_cache()
    return step_counts, decode_counts


def prior_config():
    """A mono-to-stereo prior on the dance_diffusion_base U-Net (the
    dual-mono `source` by input-concat, 2 channels), at the config's sample
    size."""
    dd = json.loads(DD_CONFIG.read_text())
    return {"model_type": "diffusion_prior", "sample_size": dd["sample_size"],
            "sample_rate": dd["sample_rate"], "audio_channels": 2,
            "model": {"prior_type": "mono_stereo", "conditioning": None, "io_channels": 2,
                      "diffusion": {"type": "DAU1d", "input_concat_ids": ["source"],
                                    "config": {**dd["model"]["config"], "cond_dim": 2}}},
            "training": {"learning_rate": 1e-4, "prior_type": "mono_stereo"}}


def prior_phase():
    """[19e] A mono-to-stereo prior on the dance_diffusion_base U-Net (the
    dual-mono `source` by input-concat, 2 channels): one train step at batch
    2 x 65,536 and one `stereoize` of a mono clip at PRIOR_STEPS steps;
    nothing launches (plain attention at 65,536 samples). Returns (step
    counts, stereoize counts)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.training.factory import (
        create_training_wrapper_from_config,
    )

    config = prior_config()
    model = create_model_from_config(config, seed=0, device=DEVICE)
    w = create_training_wrapper_from_config(config, model)
    reals = ae_reals(config, DIFFAE_BATCH, 50)
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    metrics = w.train_step(reals, [{}] * DIFFAE_BATCH)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - start
    step_counts = read_counts()
    model.eval()
    mono = reals[:1].mean(-1)[:, None, :].cpu().numpy()
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    stereo = model.stereoize(mono, in_sr=config["sample_rate"], steps=PRIOR_STEPS,
                             sampler_kwargs={"sampler_type": "dpmpp-3m-sde", "sigma_min": 0.3,
                                             "sigma_max": 500}, seed=0)
    torch.cuda.synchronize()
    stereo_s = time.perf_counter() - start
    stereo_counts = read_counts()
    log(f"  train step at batch {DIFFAE_BATCH} x {config['sample_size']}: {step_s:.3f} s, loss "
        f"{metrics['loss']:.5f}; stereoize {list(mono.shape)} -> {list(stereo.shape)} at "
        f"{PRIOR_STEPS} steps in {stereo_s:.3f} s")
    zero = {name: 0 for name in KERNELS}
    if (tuple(stereo.shape) != (1, 2, config["sample_size"]) or not torch.isfinite(stereo).all()
            or not math.isfinite(metrics["loss"]) or step_counts != zero or stereo_counts != zero):
        raise AssertionError(f"the prior: {list(stereo.shape)}, {step_counts}, {stereo_counts}")
    del model, w, reals, stereo
    torch.cuda.empty_cache()
    return step_counts, stereo_counts


# ---------------------------------------------------------------------------
# [3m], [19f] and [19g] K8 and K9 at head dim 32: the Dance Diffusion family
# trains past 131,072 samples
# ---------------------------------------------------------------------------

# (BH, T, kv_len, kernel, calls per step) of [3m]: K8 at the first attention
# level of a 2 x 262,144-sample step (T 1024, 2 x 16 heads: 6 calls), of a 1 x
# 524,288 one (T 2048) and of a 1 x 1,048,576 one (T 4096); K9 at a
# 2,097,152-sample step's first attention level (T 8192: 6 calls); each once
# with kv_len < T
D32_BWD_CASES = [(32, 1024, None, "K8", 6), (16, 2048, None, "K8", 0),
                 (16, 4096, None, "K8", 0), (16, 8192, None, "K9", 6),
                 (16, 1000, 937, "K8", 0), (8, 1000, 937, "K9", 0)]
# (BH, T, backward) of [3m]'s FlashAttention forward and backward against
# the plain autograd
D32_AUTOGRAD_CASES = ((32, 1024, "K8"), (16, 8192, "K9"))
# [19f]'s train CLI runs: (batch, samples per clip)
DD_TRAIN_SIZES = ((2, 262_144), (1, 524_288))
DD_TRAIN_WAV_SECONDS = 12  # 529,200 samples at 44.1 kHz: a clip of 524,288 fits
DD_BIG_BATCH, DD_BIG = 2, 262_144  # [19f]'s kernels-vs-plain step and [19g]'s steps
DD_INNER_LEVEL = 9  # the first attention level: 8192 tokens at DD_LONG samples


def flash_d32_backward_phase(results):
    """[3m] K8 and K9 at head dim 32 against their plain versions (rel-L2
    1e-5 for dq, dk and dv; dO zero on rows past kv_len, as on a padded
    path, and those rows' dk/dv zero) at D32_BWD_CASES, each timed beside
    its bound (5 products at 3xTF32's rate, or the bytes), its plain
    version and SDPA's fp32 backward on the same heads; then one
    FlashAttention forward and backward (K7 with its LSE, then K8 at T 1024
    and K9 at T 8192) against the plain autograd of softmax(q k^T / sqrt(32)) v."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(26)
    for bh, t, kv, kernel, calls in D32_BWD_CASES:
        name = "flash_backward_fused_d32" if kernel == "K8" else "flash_backward_d32"
        label = f"BH{bh} T{t} D32 kv_len {kv}"
        if calls:
            results[name]["weight"][label] = calls
        if kv is None and flash.backward_kernel(t, t, 32) != kernel:
            raise AssertionError(f"{label}: the JAX package would run "
                                 f"{flash.backward_kernel(t, t, 32)}, not {kernel}")
        valid = kv or t
        q, k, v, do = (rnd(bh, t, 32) for _ in range(4))
        if kv is not None:
            do[:, kv:] = 0
        out_p, lse_p = flash.flash_forward_plain(q, k, v, kv)
        if kernel == "K8":
            def fn():
                return flash.flash_backward_fused(q, k, v, out_p, lse_p, do, kv)

            def plain():
                return flash.flash_backward_fused_plain(q, k, v, out_p, lse_p, do, kv)
        else:
            def fn():
                return flash.flash_backward(q, k, v, out_p, lse_p, do, kv)

            def plain():
                return flash.flash_backward_plain(q, k, v, out_p, lse_p, do, kv)
        got, want = fn(), plain()
        torch.cuda.synchronize()
        rels = [rel_err(a, w) for a, w in zip(got, want)]
        pad_zero = kv is None or not any(a[:, kv:].any() for a in got[1:])
        ok = (all(bool(torch.isfinite(a).all()) for a in got) and pad_zero
              and max(rels) <= TOL[name][0])
        max_abs = max((a - w).abs().max().item() for a, w in zip(got, want))
        peak = max(w.abs().max().item() for w in want)
        bound, cores_ms = flash_bound(bh, valid, 5, [q, k, v, out_p, lse_p, do], list(got), 32)
        del got, want
        q4 = q[None].clone().requires_grad_(True)
        k4, v4 = (x[None, :, :valid].clone().requires_grad_(True) for x in (k, v))
        backend = sdpa_backend(q4, k4, v4)
        o4 = sdpa(q4, k4, v4)
        g4 = do[None]
        lib_ms = timed_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 3)
        report(results, name, label, calls > 0, ok, max_abs, max(rels), peak, timed_ms(fn, 3),
               timed_ms(plain, 3), lib_ms, bound=bound,
               extra=f" ({kernel}; rel-L2 of dq/dk/dv: {' '.join(f'{r:.3g}' for r in rels)}; "
                     f"padded rows zero: {pad_zero}; SDPA backend {backend}; at the CUDA cores' "
                     f"fp32 rate {cores_ms:.4f} ms)")
        del q, k, v, do, out_p, lse_p, q4, k4, v4, o4
        torch.cuda.empty_cache()
    for bh, t, kernel in D32_AUTOGRAD_CASES:
        q, k, v = (rnd(bh, t, 32).requires_grad_(True) for _ in range(3))
        do = rnd(bh, t, 32)
        out = flash.FlashAttention.apply(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), do)
        ref = torch.softmax((q @ k.transpose(1, 2)) * 32 ** -0.5, dim=-1) @ v
        want = torch.autograd.grad(ref, (q, k, v), do)
        rels = [rel_err(out, ref)] + [rel_err(a, w) for a, w in zip(grads, want)]
        log(f"  FlashAttention at BH{bh} T{t} D32 (K7 with its LSE, then {kernel}) against the "
            f"plain autograd: rel-L2 of out/dq/dk/dv {' '.join(f'{r:.3g}' for r in rels)} (tol "
            f"{TOL['flash_backward_d32'][0]})")
        if not max(rels) <= TOL["flash_backward_d32"][0]:
            raise AssertionError(f"FlashAttention at BH{bh} T{t} D32 disagrees with autograd")
        del q, k, v, do, out, grads, ref, want
        torch.cuda.empty_cache()
    for name in ("flash_backward_fused_d32", "flash_backward_d32"):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms per {r['per']}, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, library {r['library_ms']:.4f} ms")


def nonzero(counts):
    """The launch counts that are not 0."""
    return {name: n for name, n in counts.items() if n}


def dd_step_counts(config, sample_size):
    """What one Dance Diffusion training step at `sample_size` launches: on
    each attention level whose length passes the flash gate, 6 K7 at head
    dim 32 with their LSE and 6 of the backward the JAX package would
    choose there (K8 where its plan fits, else K9)."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    unet = config["model"]["config"]
    depth, strides = unet.get("depth", 14), [1] + list(unet.get("strides", [2] * 13))
    first = max(2, depth - unet.get("n_attn_layers", 6))
    want = {name: 0 for name in KERNELS}
    for i in range(first, depth + 1):
        t = sample_size // math.prod(strides[:i])
        if t >= 1024:
            want["flash_forward_d32"] += 6
            bwd = {"K8": "flash_backward_fused_d32", "K9": "flash_backward_d32"}[
                flash.backward_kernel(t, t, 32)]
            want[bwd] += 6
    return want


def dd_big_training_phase(config, tmp):
    """[19f] dance_diffusion_base_44k.json as written but for its sample
    size (a copy in tmp), through the train CLI at DD_TRAIN_SIZES (2 x
    262,144: one attention level through the kernels, T 1024 at B2 x H16;
    1 x 524,288: T 2048 and 1024), DD_TRAIN_STEPS steps each from synthetic
    stereo WAVs, no demo: step times, trained s-audio/s, peak memory, finite
    losses and weights, and the launches exactly (6 K7 and 6 K8 at D 32 per
    attention level and step). Then one step at 2 x 262,144 with the kernels
    against the same step on the plain versions (same weights, timesteps
    and noise; the loss and the gradient to FP32_MODEL_RTOL), and the
    U-Net's inner levels 9-14 under grad at the shapes of a 2,097,152-sample
    step (their input [1, 16384, 512]; the outer levels' fp32 convs would
    need ~160 GB without remat): K9 at T 8192, K8 at 4096-1024, against the
    plain versions. Returns the counts by run."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config, train
    from friendly_stable_audio_tools_tpu_torch.training.diffusion import (
        DiffusionUncondTrainingWrapper,
    )
    from friendly_stable_audio_tools_tpu_torch.training.factory import (
        create_training_wrapper_from_config,
    )

    runs = {}
    step = DiffusionUncondTrainingWrapper.train_step
    for batch, size in DD_TRAIN_SIZES:
        name = f"dd{size}"
        cfg = copy.deepcopy(config)
        cfg["sample_size"] = size
        cfg["training"]["demo"]["demo_every"] = 10 * DD_TRAIN_STEPS  # no demo in these runs
        args = train_args({**cfg, "audio_channels": 2}, tmp, name, batch, DD_TRAIN_WAV_SECONDS)
        (Path(tmp) / f"{name}_model.json").write_text(json.dumps(cfg))
        args[args.index("--batch-size") + 1] = str(batch)
        times, losses = [], []

        def timed(self, *a, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = step(self, *a, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            losses.append(out["loss"])
            return out

        with patched([(DiffusionUncondTrainingWrapper, "train_step", timed)]):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            start = time.perf_counter()
            trainer = train.main(args + ["--max-steps", str(DD_TRAIN_STEPS)])
            total = time.perf_counter() - start
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            finite = all(bool(torch.isfinite(p).all()) for p in trainer.wrapper.model.parameters())
            done = trainer.wrapper.step
            del trainer
            torch.cuda.empty_cache()
        per_step = dd_step_counts(cfg, size)
        want = {k: n * DD_TRAIN_STEPS for k, n in per_step.items()}
        med = statistics.median(times[1:DD_TRAIN_STEPS])
        seconds = batch * size / cfg["sample_rate"]
        log(f"  {batch} x {size} samples: steps {[round(x, 4) for x in times]} s; median of steps "
            f"2-{DD_TRAIN_STEPS} {med:.4f} s = {seconds / med:.3f} s-audio/s trained; losses "
            f"{[round(x, 5) for x in losses]}; peak memory {peak:.2f} GiB; run incl. set-up "
            f"{total:.1f} s; launches per step "
            f"{nonzero(per_step)}, counted {nonzero(counts)}")
        if not (done == DD_TRAIN_STEPS and len(times) == DD_TRAIN_STEPS and finite
                and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"the train CLI at {batch} x {size}: steps, losses or weights off")
        if counts != want or not per_step["flash_backward_fused_d32"]:
            raise AssertionError(f"the train CLI at {batch} x {size} launched {counts}, not {want}")
        runs[f"train_dd_{batch}x{size}"] = counts

    cfg = copy.deepcopy(config)
    cfg["sample_size"] = DD_BIG
    model = create_model_from_config(cfg, seed=0, device=DEVICE)
    w = create_training_wrapper_from_config(cfg, model)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    reals = ae_reals({**cfg, "audio_channels": 2}, DD_BIG_BATCH, 60)
    draws = {"t": torch.rand(DD_BIG_BATCH, generator=g, device=DEVICE),
             "noise": torch.randn(reals.shape, generator=g, device=DEVICE)}
    params = [p for p in model.model.parameters() if p.requires_grad]

    def one_step():
        model.zero_grad(set_to_none=True)
        loss, _ = w.loss(reals, [{}] * DD_BIG_BATCH, 0, draws)
        loss.backward()
        return loss.item(), torch.cat([p.grad.flatten() for p in params])

    reset_counts()
    loss_k, grad_k = one_step()
    counts = read_counts()
    with plain_kernels():
        loss_p, grad_p = one_step()
    err, loss_err = rel_err(grad_k, grad_p), abs(loss_k - loss_p) / abs(loss_p)
    log(f"  one step at {DD_BIG_BATCH} x {DD_BIG} with the kernels against the plain versions: "
        f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.3g}), gradient rel-L2 {err:.3g} (tol "
        f"{FP32_MODEL_RTOL}), finite {bool(torch.isfinite(grad_k).all())}; launches "
        f"{nonzero(counts)}")
    if not (err <= FP32_MODEL_RTOL and loss_err <= FP32_MODEL_RTOL
            and bool(torch.isfinite(grad_k).all()) and counts == dd_step_counts(cfg, DD_BIG)):
        raise AssertionError("the step at 2 x 262,144 with the kernels disagrees with the plain one")
    del w, reals, draws, grad_k, grad_p
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    unet = model.model
    if DD_INNER_LEVEL != unet.depth - cfg["model"]["config"]["n_attn_layers"]:
        raise AssertionError(f"level {DD_INNER_LEVEL} is not the U-Net's first attention level")
    c = unet.channels[DD_INNER_LEVEL - 2]
    t_in = DD_LONG // math.prod(unet.strides[:DD_INNER_LEVEL - 1])
    h = torch.randn(1, t_in, c, generator=g, device=DEVICE, requires_grad=True)
    inner = [p for n, p in unet.named_parameters()
             if n.startswith(tuple(f"level{i}_" for i in range(DD_INNER_LEVEL, unet.depth + 1)))]

    def inner_step():
        unet.zero_grad(set_to_none=True)
        h.grad = None
        unet._level(h, DD_INNER_LEVEL).backward(cot)
        return torch.cat([h.grad.flatten()] + [p.grad.flatten() for p in inner])

    cot = torch.randn(h.shape, generator=g, device=DEVICE) * 1e-3
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    grad_k = inner_step()
    torch.cuda.synchronize()
    inner_s = time.perf_counter() - start
    counts = read_counts()
    with plain_kernels():
        grad_p = inner_step()
    err = rel_err(grad_k, grad_p)
    want = dd_step_counts(cfg, DD_LONG)  # levels 1-8 hold no attention
    log(f"  the U-Net's levels {DD_INNER_LEVEL}-{unet.depth} under grad at a {DD_LONG}-sample "
        f"step's shapes (input {list(h.shape)}): {inner_s:.3f} s, rel-L2 of the gradients "
        f"against the plain versions {err:.3g} (tol {FP32_MODEL_RTOL}); launches "
        f"{nonzero(counts)}")
    if not (err <= FP32_MODEL_RTOL and bool(torch.isfinite(grad_k).all()) and counts == want
            and want["flash_backward_d32"] > 0):
        raise AssertionError(f"the inner levels at {DD_LONG} samples: rel-L2 {err}, {counts}")
    runs["train_dd_inner_levels"] = counts
    del model, unet, h, grad_k, grad_p
    torch.cuda.empty_cache()
    return runs


def dd_big_step(label, config, want_extra):
    """One train step of a diffusion_prior or diffusion_autoencoder (`config`
    at DD_BIG samples) at batch DD_BIG_BATCH: its wall, loss, finite
    gradients, peak memory and launches (the U-Net's attention level at T
    1024 through K7 and K8 at head dim 32, plus `want_extra`), exactly.
    Returns the counts."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.training.factory import (
        create_training_wrapper_from_config,
    )

    model = create_model_from_config(config, seed=0, device=DEVICE)
    w = create_training_wrapper_from_config(config, model)
    reals = ae_reals(config, DD_BIG_BATCH, 70)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    grads = []
    apply_update = w.apply_update

    def kept(*a, **kw):  # the gradients as the update finds them
        grads.extend(p.grad for p in model.parameters() if p.grad is not None)
        return apply_update(*a, **kw)

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with patched([(w, "apply_update", kept)]):
        metrics = w.train_step(reals, [{}] * DD_BIG_BATCH)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - start
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(grads) and all(bool(torch.isfinite(x).all()) for x in grads)
    want = dd_step_counts({"model": {"config": config["model"]["diffusion"]["config"]}}, DD_BIG)
    for name, n in want_extra.items():
        want[name] += n
    log(f"  {label}: one step at {DD_BIG_BATCH} x {DD_BIG} in {step_s:.3f} s, loss "
        f"{metrics['loss']:.5f}, gradients finite {finite}; peak memory {peak:.2f} GiB; "
        f"launches {nonzero(counts)}")
    if not (finite and math.isfinite(metrics["loss"]) and counts == want):
        raise AssertionError(f"{label} at {DD_BIG_BATCH} x {DD_BIG}: launched {counts}, not {want}")
    del model, w, reals, grads
    torch.cuda.empty_cache()
    return counts


def dd_big_steps_phase():
    """[19g] One train step each of the mono-to-stereo prior ([19e]'s) and
    the diffusion autoencoder ([19d]'s) at 2 x 262,144 samples: the U-Net's
    first attention level (T 1024) through K7 and K8 at head dim 32, and
    the diffAE's encoder through its fp32 K2 and K3. Returns the counts."""
    prior = {**prior_config(), "sample_size": DD_BIG}
    diffae = {**diffae_config(), "sample_size": DD_BIG}
    return {"prior_step_262k": dd_big_step("the prior", prior, {}),
            "diffae_step_262k": dd_big_step("the diffusion autoencoder", diffae,
                                            encoder_counts(diffae))}


def dance_diffusion_phases(results, tmp):
    """[19a]-[19g] in order; returns their counts by path."""
    import torch

    config = json.loads(DD_CONFIG.read_text())
    log(f"[19a] {DD_CONFIG.name} as written: generate_diffusion_uncond at "
        f"{config['sample_size']} samples, batch {DD_BATCH}, {STEPS} dpmpp-3m-sde steps")
    model, counts_gen = dd_generation_phase(config)
    log(f"[19b] the same model at {DD_LONG} samples: one U-Net forward kernels vs plain, then "
        f"{DD_LONG_STEPS} steps")
    counts_long = dd_long_phase(model, config)
    del model
    torch.cuda.empty_cache()
    log(f"[19c] the train CLI on {DD_CONFIG.name}: batch {TRAIN_BATCH}, {DD_TRAIN_STEPS} steps, "
        f"the demo, a resume")
    counts_train, counts_resume = dd_training_phase(config, tmp)
    log("[19d] a diffusion autoencoder (SA 2.0's VAE encoder, a DAU1d decoder): a train step, "
        "the DDIM decode")
    counts_diffae, counts_diffae_dec = diffae_phase()
    log("[19e] a mono-to-stereo prior on the DAU1d backbone: a train step, stereoize")
    counts_prior, counts_stereo = prior_phase()
    log(f"[19f] the train CLI on {DD_CONFIG.name} past 131,072 samples (K7 and K8 at head dim 32 "
        f"under grad): {' and '.join(f'{b} x {n}' for b, n in DD_TRAIN_SIZES)}, "
        f"{DD_TRAIN_STEPS} steps each; a step kernels vs plain; the inner levels at {DD_LONG} "
        f"samples (K9)")
    counts_big = dd_big_training_phase(config, tmp)
    log(f"[19g] one step each of the prior and the diffusion autoencoder at {DD_BIG_BATCH} x "
        f"{DD_BIG}")
    counts_big_steps = dd_big_steps_phase()
    return {"generate_dd": counts_gen, "generate_dd_long": counts_long, "train_dd": counts_train,
            "train_dd_resume": counts_resume, "diffae_step": counts_diffae,
            "diffae_decode": counts_diffae_dec, "prior_step": counts_prior,
            "prior_stereoize": counts_stereo, **counts_big, **counts_big_steps}


# ---------------------------------------------------------------------------
# [3n], [20], [20b] SAO 1.0's config with 12 heads of 128
# ---------------------------------------------------------------------------


def heads128_config(config):
    """SAO 1.0's config with its DiT in 12 heads of 128 (`num_heads` 12),
    nothing else changed: the same 1536 width, 24 layers and parameter
    shapes, rotary dim 64."""
    c = copy.deepcopy(config)
    c["model"]["diffusion"]["config"]["num_heads"] = H128_HEADS
    return c


def rope_bound(bh, t, d, dtype, qkv, out):
    """The rope-fused K7's bound: its score product from the bf16 roped
    operands at the bf16 rate, P.V at the bf16 rate (bf16 v) or 3xTF32's
    (fp32 v), against qkv read once and the output written once."""
    import torch

    flops = 2 * bh * t * t * d
    t_ops = (flops / PEAK_FLOPS + flops / (PEAK_FLOPS if dtype == torch.bfloat16
                                           else PEAK_FP32_ACCURATE)) * 1e3
    t_bytes = nbytes(qkv, out) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rope_pass_check(qkv, f, h, label):
    """The rope-fused K7's rope pass on the card: the q tables it makes from
    freqs bit for bit against `rope_tables`' (torch.cos / torch.sin on the
    card, times the prescale), k^ bit for bit against the plain version's."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    b, t, three_hd = qkv.shape
    d, rot = three_hd // (3 * h), f.shape[-1]
    _, scratch = flash.launch_rope(qkv, f, h)
    khat, cos_q, sin_q = flash.rope_scratch_views(scratch, b, t, h, d, rot)
    want_cos, want_sin, _, _ = flash.rope_tables(f, t, flash.LOG2E / math.sqrt(d))
    _, k, _ = flash.rope_heads_plain(qkv, f, h)
    tables_ok = torch.equal(cos_q, want_cos) and torch.equal(sin_q, want_sin)
    khat_ok = torch.equal(khat.float(), flash.merge_heads(k, b, h).float())
    log(f"  flash_rope_attention {label}: the rope pass's q tables bit-equal to rope_tables': "
        f"{tables_ok}; k^ bit-equal to the plain version's: {khat_ok}")
    if not (tables_ok and khat_ok):
        raise AssertionError(f"flash_rope_attention {label}: the rope pass's tables or k^ differ "
                             f"from the plain version's")


def heads128_kernel_phase(results):
    """[3n] The kernels of a DiT with heads of 128 against their plain
    versions. The rope-fused K7 (its rope pass, then the attention that
    ropes q and writes the output merged) in bf16 and fp32 at SAO 1.0's 12
    heads of 128 at CFG batch 2 (T 1025: 24 calls per DiT forward), at T
    2048 and at a ragged 3 heads of 64, its pass's tables and k^ bit for bit
    (`rope_pass_check`), the device time of the main-path call by activity
    and its idle share; library: SDPA on q and k roped outside (no single
    PyTorch call ropes).
    The fp32 K7 with its LSE (and without it) and K8 at head dim 128 at the
    training shape (B 8 x 12 heads, T 1025: 2 x 24 and 24 calls per step of
    24 checkpointed layers) and a ragged one with kv_len; K8 gets the plain
    forward's out and lse, dO zero on the padded rows; library: SDPA and its
    backward on the same fp32 heads."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = randn_fn(13)
    rope = results["flash_rope_attention"]
    for b, t, h, d, calls in ((2, H128_T, H128_HEADS, 128, 24), (1, 2048, H128_HEADS, 128, 0),
                              (2, 333, 3, 64, 0)):
        f = rotary_freqs(t, max(d // 2, 32), device=DEVICE)
        for dt, tol_name, field in ((torch.bfloat16, "flash_rope_attention", "ms"),
                                    (torch.float32, "flash_rope_attention_f32", "fp32_ms")):
            label = f"B{b} T{t} H{h} D{d} {str(dt)[6:]}"
            if calls:
                rope["weight"][label] = calls
            qkv = rnd(b, t, 3 * h * d).to(dt)
            rope_pass_check(qkv, f, h, label)
            q, k, v = attention._split_roped(qkv, f, h)
            got = compare(tol_name, lambda: flash.flash_rope_attention(qkv, f, h),
                          lambda: flash.flash_rope_attention_plain(qkv, f, h), reps=BF16_K7_REPS,
                          library_fn=lambda: sdpa(q[None], k[None], v[None]))
            report(results, "flash_rope_attention", label, calls > 0, *got,
                   bound=rope_bound(b * h, t, d, dt, qkv, qkv[..., :h * d]), field=field,
                   tol_name=tol_name, extra=f"; SDPA on q and k roped outside, backend "
                                            f"{sdpa_backend(q[None], k[None], v[None])}")
            if calls:  # the call's device time by activity: the rope pass, the attention
                busy, acts, by_name = device_profile([lambda: flash.flash_rope_attention(
                    qkv, f, h)] * 10)
                split = ", ".join(f"{n[:64]} {ms:.4f}" for n, ms in sorted(
                    by_name.items(), key=lambda kv: -kv[1]))
                log(f"  flash_rope_attention {label}: device busy {busy:.4f} ms of the call's "
                    f"{got[4]:.4f} ms wall (idle {1 - busy / got[4]:.1%}), {acts:.0f} device "
                    f"activities: {split}")
            del qkv, q, k, v
    log(f"  flash_rope_attention: {rope['ms']:.4f} ms per {H128_HEADS}-head SAO DiT forward in "
        f"bf16 (24 calls), plain {rope['plain_ms']:.4f}, bound {rope['bound_ms']:.4f}, SDPA on "
        f"roped q and k {rope['library_ms']:.4f}; fp32 {rope['fp32_ms']:.4f} ms, plain "
        f"{rope['plain_fp32_ms']:.4f}, bound {rope['bound_fp32_ms']:.4f}, SDPA "
        f"{rope['library_fp32_ms']:.4f}")

    bh_train = TRAIN_BATCH * H128_HEADS
    for bh, t, kv, calls in ((bh_train, H128_T, None, 24), (3, 333, 257, 0)):
        label = f"BH{bh} T{t} D128 kv_len {kv}"
        main = calls > 0
        if main:
            results["flash_forward_d128"]["weight"][label] = 2 * calls
            results["flash_backward_fused_d128"]["weight"][label] = calls
        if flash.backward_kernel(t, t, 128) != "K8":
            raise AssertionError(f"{label}: K8's plan does not fit; the JAX package would run K9")
        valid = kv or t
        q, k, v, do = (rnd(bh, t, 128) for _ in range(4))
        if kv is not None:
            do[:, kv:] = 0
        out_p, lse_p = flash.flash_forward_plain(q, k, v, kv)
        q4 = q[None].clone().requires_grad_(True)
        k4, v4 = (x[None, :, :valid].clone().requires_grad_(True) for x in (k, v))
        backend = sdpa_backend(q4, k4, v4)
        out, lse = flash.flash_forward(q, k, v, kv)
        serving, _ = flash.flash_forward(q, k, v, kv, save_stats=False)
        torch.cuda.synchronize()
        ok, max_abs, rel_l2, peak = within("flash_forward_d128", out, out_p)
        ok_s, _, rel_s, _ = within("flash_forward_d128", serving, out_p)
        lse_err = (lse - lse_p).abs().max().item()
        del out, lse, serving
        bound, cores_ms = flash_bound(bh, valid, 2, [q, k, v], [out_p, lse_p], 128)
        serving_ms = timed_ms(lambda: flash.flash_forward(q, k, v, kv, save_stats=False), 3)
        report(results, "flash_forward_d128", label, main, ok and ok_s and lse_err <= FLASH_LSE_ATOL,
               max_abs, rel_l2, peak, timed_ms(lambda: flash.flash_forward(q, k, v, kv), 3),
               timed_ms(lambda: flash.flash_forward_plain(q, k, v, kv), 3),
               timed_ms(lambda: sdpa(q4.detach(), k4.detach(), v4.detach()), 3), bound=bound,
               extra=f", lse max_abs {lse_err:.3g} (tol {FLASH_LSE_ATOL}); without the LSE "
                     f"{serving_ms:.4f} ms, rel-L2 {rel_s:.3g}; SDPA backend {backend}; at the "
                     f"CUDA cores' fp32 rate {cores_ms:.4f} ms")

        def k8():
            return flash.flash_backward_fused(q, k, v, out_p, lse_p, do, kv)

        def k8_plain():
            return flash.flash_backward_fused_plain(q, k, v, out_p, lse_p, do, kv)

        got, want = k8(), k8_plain()
        rels = [rel_err(a, w) for a, w in zip(got, want)]
        pad_zero = kv is None or not any(a[:, kv:].any() for a in got[1:])
        ok = (all(bool(torch.isfinite(a).all()) for a in got) and pad_zero
              and max(rels) <= TOL["flash_backward_fused_d128"][0])
        max_abs = max((a - w).abs().max().item() for a, w in zip(got, want))
        peak = max(w.abs().max().item() for w in want)
        bound, cores_ms = flash_bound(bh, valid, 5, [q, k, v, out_p, lse_p, do], list(got), 128)
        del got, want
        o4 = sdpa(q4, k4, v4)
        g4 = do[None]
        lib_ms = timed_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True), 3)
        report(results, "flash_backward_fused_d128", label, main, ok, max_abs, max(rels), peak,
               timed_ms(k8, 3), timed_ms(k8_plain, 3), lib_ms, bound=bound,
               extra=f" (rel-L2 of dq/dk/dv: {' '.join(f'{r:.3g}' for r in rels)}; padded rows "
                     f"of dk, dv zero: {pad_zero}; SDPA backend {backend}; at the CUDA cores' "
                     f"fp32 rate {cores_ms:.4f} ms)")
        del q, k, v, do, out_p, lse_p, q4, k4, v4, o4
    for name in ("flash_forward_d128", "flash_backward_fused_d128"):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms per {r['per']}, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, library {r['library_ms']:.4f} ms")


def heads128_generation_phase(config):
    """[20] SAO 1.0's config with 12 heads of 128 at full width and depth:
    generate_diffusion_cond at 100 dpmpp-3m-sde steps with CFG, in fp32 (the
    generate CLI's dtype; the fp32 VAE decode) and then in bench.py's bf16
    recipe, the rope-fused K7 at every DiT self-attention (24 per model
    evaluation: 2400 per generation) and no head-pair kernel; before each,
    one DiT forward with the kernels against the plain versions (fp32: to
    FP32_MODEL_RTOL; bf16: [5]'s rule, against an fp32 copy). Returns the
    two generations' launch counts."""
    import torch

    cfg = heads128_config(config)
    depth = cfg["model"]["diffusion"]["config"]["depth"]
    model = build_model(cfg)
    frames = SAMPLE_SIZE // model.pretransform.downsampling_ratio
    g = torch.Generator(device=DEVICE).manual_seed(2)
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner([PROMPT], device=DEVICE))
        x = torch.randn(1, frames, model.io_channels, generator=g, device=DEVICE)
        t = torch.full((1,), 0.6, device=DEVICE)
        reset_counts()
        dit_k = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
        counts = read_counts()
        with plain_kernels():
            dit_p = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
    err = rel_err(dit_k, dit_p)
    log(f"  fp32 DiT forward {list(x.shape)} with CFG ({H128_HEADS} heads of 128, T {H128_T}): "
        f"kernels vs plain rel-L2 {err:.3g} (tol {FP32_MODEL_RTOL}); launches "
        f"{nonzero(counts)}")
    if not err <= FP32_MODEL_RTOL or counts["flash_rope_attention"] != depth:
        raise AssertionError("the fp32 heads-128 DiT with the kernels disagrees with the plain "
                             "versions, or missed the rope-fused K7")
    del dit_k, dit_p
    no_pair = {"fused_qkv_rope_attention": 0, "rope_pair_k": 0, "pair_long_attention": 0,
               "fused_qkv_rope_attention_stats": 0, "fused_qkv_rope_attention_backward": 0,
               "flash_forward_d128": 0, "flash_backward_fused_d128": 0,
               "flash_rope_attention": depth * STEPS}
    log(f"  fp32 generation, {STEPS} steps:")
    counts_fp32, _, rate_fp32 = generation_phase(
        model, cfg, PROMPT, SAMPLE_SIZE,
        expected={**no_pair, "flash_forward_bf16": 0, "fused_residual_unit_f32": 15,
                  "snake_conv_transpose1d_f32": 5},
        min_counts=k2_counts(OOBLECK_DECODE_K2, torch.float32))
    bench_recipe(model)
    dit_forward_phase(model, frames, PROMPT, f"SAO 1.0 with {H128_HEADS} heads of 128")
    log(f"  bench.py's bf16 recipe, {STEPS} steps:")
    counts_bf16, _, rate_bf16 = generation_phase(
        model, cfg, PROMPT, SAMPLE_SIZE,
        expected={**no_pair, "flash_forward_bf16": 0, "fused_residual_unit": 15,
                  "snake_conv_transpose1d": 5, "ln_modulate": 0, "gated_residual": 0,
                  "glu_mlp": 0, "glu_mlp_tensor": 0},
        min_counts=k2_counts(OOBLECK_DECODE_K2, torch.bfloat16))
    log(f"  SAO 1.0 with {H128_HEADS} heads of 128: fp32 {rate_fp32:.3f} s-audio/s, bf16 "
        f"{rate_bf16:.3f} s-audio/s; card {smi_line()}")
    del model
    torch.cuda.empty_cache()
    return counts_fp32, counts_bf16


def heads128_training_phase(config, tmp):
    """[20b] SAO 1.0's config with 12 heads of 128 under grad at batch 8
    (TRAIN_DEPTH of its 24 layers, full width): one DiT training step with
    the fp32 K7 (with its LSE) and K8 at head dim 128 against their fp32
    plain versions (the loss to SA2_LOSS_RTOL, the watched gradients to
    SA2_GRAD_RTOL, as [6b]); then the train CLI on the config written to a
    file, H128_TRAIN_STEPS steps from H128_WAVS synthetic WAVs (times,
    trained s-audio/s, peak memory, exact launch counts: per layer and step
    K7 twice, the checkpointed block's recompute, and K8 once, no K5, K6,
    K9). Returns (the step's counts, the CLI's counts)."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import train
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    cfg = at_depth(heads128_config(config), TRAIN_DEPTH)
    step, depth, dit_path = dit_train_setup(cfg, tmp, PROMPT)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    loss_k, grads_k = step()
    wall_k = time.perf_counter() - start
    counts_step = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with patched([(flash, "flash_forward", flash.flash_forward_plain),
                  (flash, "flash_backward_fused", flash.flash_backward_fused_plain)]):
        start = time.perf_counter()
        loss_r, grads_r = step()
        wall_r = time.perf_counter() - start
    del step
    torch.cuda.empty_cache()
    errs = {k: rel_err(grads_k[k], grads_r[k]) for k in grads_k}
    loss_err = abs(loss_k - loss_r) / abs(loss_r)
    log(f"  one DiT step: loss kernels {loss_k:.8g}, fp32 plain {loss_r:.8g} (rel {loss_err:.3g}, "
        f"tol {SA2_LOSS_RTOL}); watched gradients rel-L2 max {max(errs.values()):.3g} (tol "
        f"{SA2_GRAD_RTOL}); wall kernels {wall_k:.3f} s, plain {wall_r:.3f} s; peak {peak:.2f} "
        f"GiB; launches {nonzero(counts_step)}")
    finite = all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads_k.values())
    if not (finite and loss_err <= SA2_LOSS_RTOL and max(errs.values()) <= SA2_GRAD_RTOL):
        raise AssertionError("the heads-128 DiT step with K7/K8 disagrees with the fp32 plain step")
    want = {name: 0 for name in KERNELS}
    want.update(flash_forward_d128=2 * depth, flash_backward_fused_d128=depth)
    if counts_step != want:
        raise AssertionError(f"one checkpointed heads-128 step should launch {want}: {counts_step}")

    args = train_args(cfg, tmp, "h128", H128_WAVS, WAV_SECONDS, dit_path)
    times, losses = {}, []
    per_step = launches_per_step(cfg, "d128")
    with patched(train_timers(times, losses)):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        trainer = train.main(args + ["--max-steps", str(H128_TRAIN_STEPS)])
        total = time.perf_counter() - start
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        moved = weight_moved(trainer.wrapper, dit_path)
        steps_done = trainer.wrapper.step
        del trainer
        torch.cuda.empty_cache()
    log_training(cfg, times, losses, H128_TRAIN_STEPS, peak, total)
    log(f"  losses {losses}; weights moved by up to {moved:.4g}; launches, {H128_TRAIN_STEPS} "
        f"steps: {nonzero(counts)}")
    if len(losses) != H128_TRAIN_STEPS or not (moved > 0 and steps_done == H128_TRAIN_STEPS):
        raise AssertionError("losses missing, weights did not move, or the step count is off")
    want = {k: v * H128_TRAIN_STEPS for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} are not the {want} of {H128_TRAIN_STEPS} "
                             f"steps")
    return counts_step, counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import build

    clock = {"run": time.perf_counter(), "phase": time.perf_counter()}

    def done(label):
        now = time.perf_counter()
        log(f"  {label} wall {now - clock['phase']:.1f} s (run so far {now - clock['run']:.1f} s)")
        clock["phase"] = now

    smi = smi_line()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.library()
    log(f"[2] built {build.build().name} in {time.perf_counter() - t0:.1f} s")
    done("[1]-[2]")

    results = new_results()
    config = json.loads(SAO_CONFIG.read_text())
    sa2_config = json.loads(SA2_CONFIG.read_text())
    sa1_config = json.loads(SA1_CONFIG.read_text())

    log("[3] kernels vs plain versions (bf16, tolerance = (rel-L2, max-abs / max|plain|))")
    kernel_phase(results)
    done("[3]")
    log("[3b] training attention kernels K5 and K6 vs plain versions")
    attention_train_phase(results)
    done("[3b]")
    log(f"[3c] K2 and K3 at the frozen encoder's shapes, SAO 1.0 and SA 2.0 ({encode_calls(config)} "
        f"encode calls per training step of batch {TRAIN_BATCH})")
    encoder_conv_phase(results, config, "encode_ms")
    encoder_conv_phase(results, sa2_config, "sa2_encode_ms")
    done("[3c]")
    log("[3d] long-sequence attention kernels K10a and K10 vs plain versions")
    long_attention_phase(results)
    done("[3d]")
    log("[3e] fp32 training attention kernels K7 and K9 vs plain versions")
    flash_phase(results)
    done("[3e]")
    log("[3f] fp32 kernels vs their fp32 plain versions: K2/K3/K4 at the Oobleck decode and encode "
        "shapes and the DAC decode's, K7 without its LSE at the ADP U-Net's")
    decode_conv_phase(results, torch.float32,
                      {"sa2": "sa2_decode_ms", "sao": "sao_decode_ms", "sao_ru": "ms"})
    encoder_conv_phase(results, config, "encode_ms", torch.float32)
    encoder_conv_phase(results, sa2_config, "sa2_encode_ms", torch.float32)
    dac_conv_phase(results)
    dac_encode_conv_phase(results, sa1_config)
    flash_serving_phase(results)
    done("[3f]")
    log("[3g] fp32 single-pass backward K8 (and K7 with its LSE) vs plain versions at SA 1.0's "
        "training shapes and a DiT shape")
    flash_fused_phase(results)
    done("[3g]")
    lm_config = json.loads(LM_CONFIG.read_text())
    log("[3h] the causal K7 (with and without its LSE) and K9 vs plain versions at the audio LM's "
        "shape; the fp32 K2 at its SEANet encode's shapes")
    causal_flash_phase(results)
    seanet_conv_phase(results, lm_config)
    lstm_tf32_check(lm_config)
    done("[3h]")
    log("[3i] the fused SwiGLU MLP K13 vs its plain version through each route (streaming: fp32 "
        "at the audio LM's decode M 2 and M 16; tensor cores: SAO's DiT at M 2050 and 2080, bf16 "
        "and fp32); the fp32 K2 and K4 at the LM's SEANet token-decode shapes")
    glu_mlp_phase(results)
    seanet_decode_conv_phase(results, lm_config)
    done("[3i]")
    log("[3j] the adaLN elementwise kernels K11 (LayerNorm + modulate) and K12 (gated residual) "
        "vs their plain chains and the Pallas kernels' arithmetic, bf16")
    elementwise_phase(results)
    done("[3j]")
    log("[3k] K7 in bf16 vs its plain version at the ADP U-Net's shapes and SA 2.0's past 8192 "
        "tokens (with the fp32 K7 there); the bf16 K2 and K4 at the DAC decode's shapes")
    flash_bf16_phase(results)
    dac_conv_phase(results, torch.bfloat16, "sa1_decode_ms")
    done("[3k]")
    log("[3l] the fp32 K7 at head dim 32 vs its plain version at Dance Diffusion's attention "
        "shapes at 2,097,152 samples, SDPA beside it")
    flash_d32_phase(results)
    done("[3l]")
    log("[3m] K8 and K9 at head dim 32 vs their plain versions at Dance Diffusion's training "
        "shapes (T 1024-4096: K8; T 8192: K9), SDPA's backward beside them; FlashAttention vs "
        "the plain autograd")
    flash_d32_backward_phase(results)
    done("[3m]")
    log(f"[3n] the rope-fused K7 (bf16 and fp32) and the fp32 K7 and K8 at head dim 128 vs their "
        f"plain versions at SAO 1.0's shapes with {H128_HEADS} heads of 128 (T {H128_T}), SDPA "
        f"beside them")
    heads128_kernel_phase(results)
    done("[3n]")

    log("[4] model forwards with the kernels vs the plain versions")
    model = build_model(config)
    audio_in = torch.from_numpy(np.stack([synthetic_audio(i, SAMPLE_SIZE).T for i in range(2)]))
    audio_in = audio_in.cuda()
    z_small = torch.randn(1, 64, 64, generator=torch.Generator(device=DEVICE).manual_seed(3),
                          device=DEVICE)
    with plain_kernels():
        z32 = model.pretransform.encode_nwc(audio_in)  # fp32 VAE, plain versions
        dec32_p = model.pretransform.decode_nwc(z_small)
    zk32 = model.pretransform.encode_nwc(audio_in)  # fp32 VAE, the fp32 kernels
    dec32_k = model.pretransform.decode_nwc(z_small)
    enc32_rel, dec32_rel = rel_err(zk32, z32), rel_err(dec32_k, dec32_p)
    log(f"  fp32 VAE encode {list(audio_in.shape)} -> {list(zk32.shape)} and decode [1, 64, 64] with "
        f"the fp32 kernels against the fp32 plain versions: rel-L2 {enc32_rel:.4g} and "
        f"{dec32_rel:.4g} (tol {FP32_MODEL_RTOL})")
    if not (enc32_rel <= FP32_MODEL_RTOL and dec32_rel <= FP32_MODEL_RTOL):
        raise AssertionError("the fp32 VAE with the kernels disagrees with the plain versions")
    del zk32, dec32_k, dec32_p
    bench_recipe(model)
    zk = model.pretransform.encode_nwc(audio_in)
    enc_rel = rel_err(zk, z32)
    log(f"  VAE encode {list(audio_in.shape)} -> {list(zk.shape)}: bf16 with the kernels against fp32 "
        f"with the plain versions, rel-L2 {enc_rel:.4g}, max abs {(zk - z32).abs().max().item():.4g} "
        f"(max|fp32| {z32.abs().max().item():.4g}; bound {ENCODE_REL_TOL})")
    del audio_in, z32, zk
    dit_forward_phase(model, SAMPLE_SIZE // 2048, PROMPT, "SAO 1.0")
    with torch.no_grad():
        dec_k = model.pretransform.decode_nwc(z_small)
        with plain_kernels():
            dec_p = model.pretransform.decode_nwc(z_small)
    dec_rel = rel_err(dec_k, dec_p)
    log(f"  VAE decode [1, 64, 64] -> {list(dec_k.shape)}: rel-L2 {dec_rel:.3g} (bound {DECODE_REL_TOL})")
    if not (dec_rel <= DECODE_REL_TOL and enc_rel <= ENCODE_REL_TOL):
        raise AssertionError("the VAE with the kernels disagrees with the plain versions")
    done("[4]")

    log("[5] generation path: SAO 1.0 text-to-audio, 100 dpmpp-3m-sde steps, CFG 7, bench.py's "
        "bf16 recipe")
    launches, sao_audio, rate_sao = generation_phase(
        model, config, PROMPT, SAMPLE_SIZE,
        expected={"fused_qkv_rope_attention": 24 * STEPS, "rope_pair_k": 24 * STEPS,
                  "pair_long_attention": 0,
                  "fused_residual_unit": 15, "snake_conv_transpose1d": 5, "ln_modulate": 0,
                  "gated_residual": 0, "glu_mlp": 0, "glu_mlp_tensor": 0, **NO_TRAINING},
        min_counts=k2_counts(OOBLECK_DECODE_K2, torch.bfloat16))
    prof_sao = profile_sao_step(model, config)
    log_earlier_e2e("[5]")
    done("[5]")
    log("[5b] SAO 1.0 text-to-audio with fused_mlp (K13's tensor-core route in every DiT "
        "FeedForward), bench.py's bf16 recipe: a DiT forward vs without it and vs fp32, the "
        "100-step generation, one profiled CFG step")
    launches_fused = sao_fused_mlp_phase(model, config, launches, rate_sao, prof_sao)
    done("[5b]")
    log(f"[16] init-audio generation on the same model: a variation and an outpainting of [5]'s "
        f"clip ({STEPS} dpmpp-3m-sde steps, CFG {CFG_SCALE}), each other sampler from noise, an "
        f"inpainting with the kernels vs the plain versions")
    counts_init = init_audio_phase(model, sao_audio)
    del model, sao_audio
    torch.cuda.empty_cache()
    done("[16]")

    # phases 6-7 write ~23 GB (a de-zeroed DiT and a full training checkpoint)
    # into the checkout's build/ directory, which the kernel build uses too
    log(f"[6] one DiT training step at batch {TRAIN_BATCH} ({TRAIN_DEPTH} of the DiT's 24 layers): "
        f"attention kernels vs plain bf16 vs fp32 attention")
    train_config = at_depth(config, TRAIN_DEPTH)
    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(scratch).free / 1e9
    log(f"  {free_gb:.1f} GB free under {scratch} for phases 6-7")
    if free_gb < 30:
        raise RuntimeError(f"phases 6-7 need ~23 GB of disk under {scratch}, {free_gb:.1f} GB free")
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        dit_path = dit_train_step_phase(train_config, tmp)
        done("[6]")
        log(f"[7] training path: train.main on SAO 1.0 ({TRAIN_DEPTH} DiT layers), batch "
            f"{TRAIN_BATCH}, {TRAIN_STEPS} steps from {N_WAVS} synthetic {WAV_SECONDS} s WAVs, "
            f"checkpoint, resume for one more step")
        counts_train, counts_resume = training_phase(train_config, tmp, dit_path)
    k5, k6 = "fused_qkv_rope_attention_stats", "fused_qkv_rope_attention_backward"
    was = 48 * EARLIER_MS[k5] + 24 * EARLIER_MS[k6]
    log_earlier_e2e("[7]", f"; K5 + K6 per 24-layer step (48 + 24 calls) "
                           f"{results[k5]['ms'] + results[k6]['ms']:.2f} ms in this run's [3b], "
                           f"{was:.1f} ms from the earlier per-call rows")
    done("[7]")

    log(f"[15b] SA 2.0's DiT past 8192 tokens: {SA2_XL_SAMPLE_SIZE // 2048} latent frames (T "
        f"{SA2_XL_T}, kv_len {SA2_XL_KV}), the split route's K7 in fp32 and in bench.py's bf16 "
        f"recipe vs plain versions")
    model = build_model(sa2_config)
    counts_xl32, counts_xl16 = sa2_xl_forward_phase(model)  # leaves the model in the recipe
    log_earlier_e2e("[15b]", f"; the fp32 K7 per DiT forward in this run's [3k]: "
                             f"{results['flash_forward_serving']['sa2_xl_ms']:.4f} ms (24 calls)")
    done("[15b]")
    log("[4b] SA 2.0's DiT at 6144 latent frames: kernels vs plain versions")
    dit_forward_phase(model, SA2_SAMPLE_SIZE // 2048, SA2_PROMPT, "SA 2.0")
    done("[4b]")
    log(f"[8] long-form path: SA 2.0 text-to-audio, {SA2_SAMPLE_SIZE} samples, 100 dpmpp-3m-sde "
        f"steps, CFG 7, bench.py's bf16 recipe")
    launches_long, _, _ = generation_phase(
        model, sa2_config, SA2_PROMPT, SA2_SAMPLE_SIZE,
        expected={"fused_qkv_rope_attention": 0, "rope_pair_k": 24 * STEPS,
                  "pair_long_attention": 24 * STEPS, "fused_residual_unit": 15,
                  "snake_conv_transpose1d": 5, "ln_modulate": 0, "gated_residual": 0,
                  **NO_TRAINING},
        min_counts=k2_counts(OOBLECK_DECODE_K2, torch.bfloat16))
    log_earlier_e2e("[8]")
    del model
    torch.cuda.empty_cache()
    done("[8]")

    # phases 6b and 9 write ~4.2 GB (SA 2.0's de-zeroed DiT and 2 WAVs)
    log(f"[6b] one SA 2.0 DiT training step at batch {TRAIN_BATCH}, T {LONG_T} kv_len {LONG_KV} "
        f"({TRAIN_DEPTH} of the DiT's 24 layers): K7/K9 vs their fp32 plain versions vs the bf16 "
        f"K5/K6 route")
    sa2_train_config = at_depth(sa2_config, TRAIN_DEPTH)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        sa2_dit_path, _ = sa2_dit_train_step_phase(sa2_train_config, tmp)
        done("[6b]")
        log(f"[9] long-form training path: train.main on SA 2.0 ({TRAIN_DEPTH} DiT layers), batch "
            f"{TRAIN_BATCH}, {SA2_TRAIN_STEPS} steps from {SA2_WAVS} synthetic {SA2_WAV_SECONDS} s "
            f"WAVs")
        counts_long = longform_training_phase(sa2_train_config, tmp, sa2_dit_path)
    log_earlier_e2e("[9]", f"; K7 with LSE per 24-layer step (48 calls) in this run's [3e]: "
                           f"{results['flash_forward']['ms']:.4f} ms")
    done("[9]")

    log("[4c] SA 1.0's U-Net at 4096 latent frames: kernels vs plain versions, fp32")
    model = build_model(sa1_config)
    unet_inputs, unet_ref = sa1_unet_forward_phase(model)
    done("[4c]")
    log("[4d] SA 1.0's U-Net at 4096 latent frames in bench.py's bf16 recipe: kernels vs plain "
        "versions vs [4c]'s fp32 U-Net")
    sa1_unet_bf16_phase(model, unet_inputs, unet_ref)
    del unet_inputs, unet_ref
    done("[4d]")
    log(f"[15] SA 1.0 in bench.py's bf16 recipe: generate_diffusion_cond, {SA1_SAMPLE_SIZE} "
        f"samples, {STEPS} dpmpp-3m-sde steps, CFG {CFG_SCALE}")
    launches_sa1_bf16, _, rate_sa1_bf16 = generation_phase(
        model, sa1_config, SA1_PROMPT, SA1_SAMPLE_SIZE,
        expected={**{name: 0 for name in KERNELS}, "flash_forward_bf16": 14 * STEPS,
                  "snake_conv_transpose1d": 4, **dac_decode_k2_counts(torch.bfloat16)},
        min_counts={})
    del model
    torch.cuda.empty_cache()
    log_earlier_e2e("[15]")
    done("[15]")
    log(f"[10] SA 1.0 path: the generate CLI on stable_audio_1_0.json, {SA1_SAMPLE_SIZE} samples, "
        f"{STEPS} dpmpp-3m-sde steps, CFG {CFG_SCALE}, fp32")
    launches_sa1, rate_sa1 = cli_generation_phase(
        SA1_CONFIG, SA1_PROMPT, {"flash_forward_serving": 14 * STEPS, "snake_conv_transpose1d_f32": 4,
                                 **dac_decode_k2_counts(torch.float32)})
    log(f"  SA 1.0 generation, this run: bf16 recipe ([15]) {rate_sa1_bf16:.3f} s-audio/s, fp32 CLI "
        f"([10]) {rate_sa1:.3f} s-audio/s; card {smi_line()}")
    torch.cuda.empty_cache()
    log_earlier_e2e("[10]", f"; the fp32 K7 per step (14 calls) in this run's [3f]: "
                            f"{results['flash_forward_serving']['ms']:.4f} ms")
    done("[10]")
    log(f"[10b] the repaired dtype: the generate CLI on stable_audio_open_1_0.json in fp32 (K1 on "
        f"bf16 casts of the fp32 qkv, the fp32 K2/K3/K4 in the decode)")
    launches_fp32, _ = cli_generation_phase(
        SAO_CONFIG, PROMPT, {"fused_qkv_rope_attention": 24 * STEPS, "rope_pair_k": 24 * STEPS,
                             "fused_residual_unit_f32": 15, "snake_conv_transpose1d_f32": 5,
                             **k2_counts(OOBLECK_DECODE_K2, torch.float32)})
    torch.cuda.empty_cache()
    log_earlier_e2e("[10b]")
    done("[10b]")

    # phases 11b and 11 write ~4.5 GB (SA 1.0's de-zeroed U-Net and 8 WAVs)
    log(f"[11b] one SA 1.0 U-Net training step at batch {TRAIN_BATCH}, 4096 latent frames: K7/K8 vs "
        f"their fp32 plain versions vs the serving route under grad")
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        unet_path, _ = sa1_train_step_phase(sa1_config, tmp)
        done("[11b]")
        log(f"[11] SA 1.0 training path: train.main on stable_audio_1_0.json, batch {TRAIN_BATCH}, "
            f"{SA1_TRAIN_STEPS} steps from {SA1_WAVS} synthetic {SA1_WAV_SECONDS} s WAVs")
        counts_sa1 = sa1_training_phase(sa1_config, tmp, unet_path)
    log_earlier_e2e("[11]", f"; K7 with LSE + K8 per step in this run's [3g]: "
                            f"{results['flash_forward']['sa1_train_ms']:.4f} + "
                            f"{results['flash_backward_fused']['ms']:.4f} ms")
    done("[11]")

    # phases 12b and 12 write ~3 GB (the de-zeroed LM with T5 and the tokenizer, 8 WAVs)
    log(f"[12b] one audio LM training step (musicgen_small_32khz.json) at batch {TRAIN_BATCH}, "
        f"T {LM_T}: the causal K7/K9 vs their fp32 plain versions; a no-grad forward")
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        lm_path, counts_lm_tok, counts_lm_step, counts_lm_eval = lm_train_step_phase(lm_config, tmp)
        log_earlier_e2e("[12b]", f"; in this run's [3h]: "
                                 f"{results['flash_forward_causal_serving']['ms']:.4f} ms")
        done("[12b]")
        log(f"[12] audio LM training path: train.main on musicgen_small_32khz.json, batch "
            f"{TRAIN_BATCH}, {LM_TRAIN_STEPS} steps from {LM_WAVS} synthetic {LM_WAV_SECONDS} s "
            f"mono WAVs")
        counts_lm = lm_training_phase(lm_config, tmp, lm_path)
    log_earlier_e2e("[12]", f"; the causal K7 with LSE per step in this run's [3h]: "
                            f"{results['flash_forward_causal']['ms']:.4f} ms")
    done("[12]")

    log(f"[13b] the audio LM's cached decode at full width ({LM_GEN_DEPTH} of its 24 layers): "
        f"{LM_DECODE_STEPS} decode_step calls on fixed tokens, the fused MLP (K13) on vs off")
    lm_gen_config = at_depth(lm_config, LM_GEN_DEPTH)
    model = build_model(lm_gen_config)
    lm_decode_phase(model, lm_gen_config)
    done("[13b]")
    log(f"[13] audio LM generation: generate_audio on musicgen_small_32khz.json ({LM_GEN_DEPTH} "
        f"layers), {lm_frames(lm_config)} frames, CFG {LM_CFG}, top_k {LM_TOP_K}, temperature "
        f"{LM_TEMP}, fp32; the fused MLP off, then on (create_model_from_config(..., "
        f"fused_mlp=True))")
    counts_gen = lm_generation_phase(model, lm_gen_config, False)
    del model
    torch.cuda.empty_cache()
    model = build_model(lm_gen_config, fused_mlp=True)
    counts_gen_fused = lm_generation_phase(model, lm_gen_config, True)
    del model
    torch.cuda.empty_cache()
    log_earlier_e2e("[13]")
    done("[13]")

    log("[14b] one forward and backward of the full-width bf16 adaLN DiT (SAO 1.0 with "
        "global_cond_type adaLN): fused_ew on vs off vs an fp32 copy with the plain versions")
    model = build_model(adaln_config(config), fused_ew=True)
    bench_recipe(model)
    counts_adaln_step, counts_adaln_step_off = adaln_step_phase(model)
    done("[14b]")
    log(f"[14] adaLN text-to-audio: create_model_from_config(..., fused_ew=True), {STEPS} "
        f"dpmpp-3m-sde steps, CFG {CFG_SCALE}, bench.py's bf16 recipe; fused_ew on, then off")
    counts_adaln, counts_adaln_off = adaln_generation_phase(model, config)
    log_earlier_e2e("[14]")
    del model
    torch.cuda.empty_cache()
    done("[14]")

    log(f"[17] AE-GAN training of {AE_CONFIG.name} (batch {TRAIN_BATCH} x 65536, fp32): K2, K3 "
        f"and K4 under grad vs plain autograd; a generator step vs the plain versions; "
        f"{AE_STEPS} steps through the train CLI with a resume and the export; "
        f"two steps of each DAC VAE; the reconstruct CLI")
    ae_config = json.loads(AE_CONFIG.read_text())
    ae_grad_phase(results)
    counts_ae_step = ae_step_phase(ae_config)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        counts_ae, counts_ae_resume = ae_training_phase(ae_config, tmp)
        counts_ae_other = {f"train_ae_{path.stem}": ae_config_steps_phase(
            json.loads(path.read_text()), path.name) for path in AE_OTHER_CONFIGS}
        counts_recon = ae_reconstruct_phase(ae_config, tmp)
    done("[17]")

    log(f"[18] the diffusion trainer's options on SAO 1.0's fp32 DiT ({OPTIONS_DEPTH} of 24 "
        f"layers, batch "
        f"{TRAIN_BATCH}, 1024 latent frames, fixed draws): pre-encoded, logit-normal, rectified "
        f"flow, mask_padding and the inpaint variant, each against the plain versions; whole steps "
        f"from latents and from audio; the weight-norm fold; then the train CLI "
        f"({TRAIN_DEPTH} layers) with a demo, the fold and the profiler")
    counts_options = training_options_phase(at_depth(config, OPTIONS_DEPTH))
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        counts_opt_train, counts_demo = training_demo_phase(config, tmp)
    done("[18]")

    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        counts_dd = dance_diffusion_phases(results, tmp)
    done("[19]")

    log(f"[20] SAO 1.0 with {H128_HEADS} heads of 128 (`num_heads` {H128_HEADS}, nothing else "
        f"changed): generate_diffusion_cond, {STEPS} dpmpp-3m-sde steps, CFG {CFG_SCALE}, in fp32 "
        f"and in bench.py's bf16 recipe, the rope-fused K7 at every self-attention")
    counts_h128_fp32, counts_h128_bf16 = heads128_generation_phase(config)
    done("[20]")
    log(f"[20b] the same config under grad ({TRAIN_DEPTH} of 24 layers, batch {TRAIN_BATCH}): a "
        f"DiT step through the fp32 K7 and K8 at head dim 128 vs their plain versions, then the "
        f"train CLI, {H128_TRAIN_STEPS} steps")
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        counts_h128_step, counts_h128_train = heads128_training_phase(config, tmp)
    done("[20b]")

    by_path = {"generate": launches, "generate_fused_mlp": launches_fused,
               "generate_long": launches_long, "train": counts_train,
               "train_resume": counts_resume, "train_long": counts_long,
               "generate_sa1": launches_sa1, "generate_fp32": launches_fp32,
               "train_sa1": counts_sa1, "lm_tokenize": counts_lm_tok, "lm_step": counts_lm_step,
               "lm_eval_forward": counts_lm_eval, "train_lm": counts_lm,
               "lm_generate": counts_gen, "lm_generate_fused_mlp": counts_gen_fused,
               "adaln_step": counts_adaln_step, "adaln_step_plain_ew": counts_adaln_step_off,
               "generate_adaln": counts_adaln, "generate_adaln_plain_ew": counts_adaln_off,
               "generate_sa1_bf16": launches_sa1_bf16, "sa2_xl_forward_fp32": counts_xl32,
               "sa2_xl_forward_bf16": counts_xl16, **counts_init,
               "ae_generator_step": counts_ae_step, "train_ae": counts_ae,
               "train_ae_resume": counts_ae_resume, **counts_ae_other,
               "reconstruct_ae": counts_recon, **counts_options,
               "train_options_cli": counts_opt_train, **counts_dd,
               "generate_h128_fp32": counts_h128_fp32, "generate_h128_bf16": counts_h128_bf16,
               "h128_step": counts_h128_step, "train_h128": counts_h128_train}

    def entry(name, r):
        parts = r["bound_parts"]["ms"]
        out = dict(name=name, route=r["route"], source=r["source"], replaces=r["replaces"],
                   launches=sum(c[name] for c in by_path.values()), max_abs_err=r["max_abs_err"],
                   ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by=max(parts, key=parts.get), library_ms=r["library_ms"], per=r["per"],
                   launches_by_path={p: c[name] for p, c in by_path.items()})
        for f in ("sao_decode_ms", "sa2_decode_ms", "encode_ms", "sa2_encode_ms", "sa1_train_ms",
                  "sa1_encode_ms", "lm_encode_ms", "lm_decode_ms", "sa1_decode_ms", "sa2_xl_ms",
                  "fp32_ms"):
            if f in r:
                out.update({k + f: r[k + f] for k in ("", "plain_", "bound_", "library_")})
        if "ae_grad" in r:  # [17]: under grad, forward + backward, kernel vs plain
            out["ae_grad"] = r["ae_grad"]
        return out

    print(json.dumps({"kernels": [entry(name, r) for name, r in results.items()]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
