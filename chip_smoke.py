#!/usr/bin/env python3
"""Chip smoke test of the torch port (friendly_stable_audio_tools_tpu_torch)
on one NVIDIA GPU: Stable Audio Open 1.0 text-to-audio and training, Stable
Audio 2.0 long-form text-to-audio and training, and Stable Audio 1.0
text-to-audio and training, at full width.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from csrc/ (timed);
3. each kernel K1-K4 against its plain PyTorch version on the card in bf16,
   at every shape the two generation paths give it (SAO 1.0's decode of
   2,097,152 samples, SA 2.0's of 12,582,912) plus small ragged shapes,
   with max-abs and rel-L2 errors against a stated tolerance, both times,
   the least time the card could take (bound) and one PyTorch library
   call's time where one computes the same function;
   3b. the training attention kernels K5 (forward with LSE) and K6
   (backward) against their plain versions at the training shape (B 8,
   T 1040, kv_len 1025, 24 heads) and three smaller ones;
   3c. K2 and K3 at the frozen encoder's shapes, SAO 1.0's and SA 2.0's
   sample sizes (the encode runs one clip at a time, `iterate_batch`);
   3d. the long-sequence attention kernels K10a (rope K once) and K10
   against their plain versions at SA 2.0's shape (B 2, T 6272, kv_len 6145,
   24 heads) and three smaller ragged ones;
   3e. the fp32 training attention kernels K7 (forward with LSE) and K9
   (two-pass backward) against their plain versions at SA 2.0's training
   shape (B 8 x 24 heads, T 6272, kv_len 6145) and two smaller ragged ones;
   3f. the fp32 kernels against their fp32 plain versions (TF32 off): K2,
   K3 and K4 at every shape of [3] and [3c]; K2 and K4 at the DAC decode's
   shapes at 4096 latent frames (26 and 4 calls); K2 at the DAC encode's
   shapes at 4,194,304 samples (26 calls per clip, 8 clips per SA 1.0
   training step); K7 without its LSE at the ADP U-Net's self-attention
   (B 2 x 16 heads: T 4096 and 2048 at head dim 64, T 1024 at head dim 80);
   3g. the fp32 single-pass backward K8 against its plain version at the
   ADP U-Net's training shapes (B 8 x 16 heads: T 4096 and 2048 at head dim
   64, T 1024 at head dim 80), at a DiT shape where K8's plan fits (B 2 x 24
   heads, T 1184, kv_len 1177) and a small ragged one; K7 with its LSE at
   the three U-Net shapes;
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
   and the kernels' launch counts show that the path ran through them;
6. one training step of the fp32 DiT at batch 8 with the attention kernels,
   with their plain versions in bf16, and with fp32 plain attention as the
   reference: loss and weight gradients of layers 0, 11 and 23;
   6b. one training step of SA 2.0's fp32 DiT at batch 8 and 6144 latent
   frames (T 6272, kv_len 6145) with the attention through K7/K9, through
   their plain versions in fp32 (the reference), and through the bf16 K5/K6
   route forced (the route the port took before it routed as the JAX
   package does): loss and weight gradients of layers 0, 11 and 23;
7. the training path: `python -m friendly_stable_audio_tools_tpu_torch.train`'s
   `main` on the SAO config from 16 synthetic 50 s WAVs, batch 8, 4 steps
   with a checkpoint at step 4, then a resume for a fifth step; step time,
   throughput, memory and split, finite losses, moved weights, the EMA, and
   the kernels' launch counts as the code implies them (the frozen encode in
   fp32, through the fp32 K2/K3);
8. the long-form path: `create_model_from_config(stable_audio_2_0.json)`
   (CLAP text conditioner, random weights, hash tokenizer), DiT and VAE in
   bench.py's bf16 recipe, `generate_diffusion_cond` for one 285 s prompt, 100 dpmpp-3m-sde
   steps, CFG 7, 12,582,912 stereo samples; output checks, walls (CLAP,
   denoise per step, decode), peak memory, and the launch counts;
9. the long-form training path: `train.main` on the SA 2.0 config from 8
   synthetic 290 s WAVs, batch 8, 3 steps: step time, trained audio per
   second, the split, peak memory, finite losses, moved weights and the
   launch counts (K7/K9 and the fp32 encoder's K2/K3, no K5/K6);
4c. one forward of Stable Audio 1.0's fp32 ADP U-Net at 4096 latent frames
   with CFG, with the kernels (K7 at T 4096, 2048, 1024) and with the plain
   versions (random weights, de-zeroed);
10. the SA 1.0 path: the generate CLI (`generate.main`) on
   stable_audio_1_0.json as written (CLAP text and two int conditioners,
   ADP U-Net, DAC VAE; random weights, seed 0; hash tokenizer), one prompt,
   100 dpmpp-3m-sde steps, CFG 7, the model's own fp32, one WAV under
   build/: audio checks, walls (conditioners, denoise per step, decode),
   s-audio/s over 95.1 s of audio, peak memory, and the launch counts (K7
   1400, fp32 K2 26 and K4 4, nothing else);
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
   written (CFG dropout 0.1, Adam at 5e-4, EMA) from 8 synthetic 96 s WAVs,
   batch 8, 3 steps: step time, trained audio per second, the split, peak
   memory, finite losses, moved weights and the launch counts (K7 with its
   LSE 14 and K8 14 per step, the DAC encoder's fp32 K2 26 per clip,
   nothing else).

Output: progress lines with each phase's wall, then one JSON line of
per-kernel results (the fp32 K2/K3/K4 and the serving K7 as entries of
their own, `*_f32` and `flash_forward_serving`), the nvidia-smi line, and
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
DEVICE = "cuda"
TRAIN_BATCH = 8
TRAIN_STEPS = 4
N_WAVS = 16
WAV_SECONDS = 50
# the DiT's self-attention at training batch 8: 1024 latent frames + 1
# prepended token, padded to 1040 (models/transformer.py:seq_pad_length)
TRAIN_T, TRAIN_KV = 1040, 1025
# SA 2.0 training (phase 9): 8 WAVs of 290 s (longer than the 285.3 s crop,
# so no clip is padded), 3 steps
SA2_WAVS = 8
SA2_WAV_SECONDS = 290
SA2_TRAIN_STEPS = 3
# SA 1.0 training (phases 11b, 11): batch 8, the ADP U-Net's flash-gated
# self-attention at B 8 x 16 heads: (T, head dim, calls per U-Net call), and
# 8 WAVs of 96 s (longer than the 95.1 s crop), 3 steps
SA1_TRAIN_ATTENTION = [(SA1_SAMPLE_SIZE // 1024, 64, 2), (SA1_SAMPLE_SIZE // 2048, 64, 6),
                       (SA1_SAMPLE_SIZE // 4096, 80, 6)]
SA1_WAVS = 8
SA1_WAV_SECONDS = 96
SA1_TRAIN_STEPS = 3

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
    # the summation order and the online softmax's rescaling differ; 1xTF32
    # products keep ~3 decimal digits and would fail them
    "flash_forward": (1e-5, 1e-4),
    "flash_backward": (1e-4, 1e-3),
    # K8 the same way: summation order only; dq's parts from the key tiles
    # arrive through atomics in an order that changes from run to run, which
    # is a summation order too
    "flash_backward_fused": (1e-5, 1e-4),
    # the fp32 kernels against their fp32 plain versions (TF32 off): K7
    # without its LSE (FFMA), K2 (FFMA), K3 and K4 (3xTF32, each tensor-core
    # partial sum of at most six products added in fp32): summation order only
    "flash_forward_serving": (1e-5, 1e-4),
    "snake_conv1d_f32": (1e-5, 1e-4),
    "fused_residual_unit_f32": (1e-5, 1e-4),
    "snake_conv_transpose1d_f32": (1e-5, 1e-4),
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
           bound=None, field="ms", extra=""):
    """Logs one kernel-vs-plain result, raises when it failed, and adds a
    main-path shape's error and weighted times to the kernel's entry: for
    `field` f, f (kernel), plain_f, bound_f (from `bound`, (ms, resource))
    and library_f (None once a shape has no library call)."""
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    bnd = "" if bound is None else f" bound {bound[0]:.4f} ms ({bound[1]})"
    log(f"  {name} {label}: max_abs {max_abs:.4g} (max|plain| {peak:.4g}) rel_l2 {rel_l2:.3g}{extra} "
        f"tol {TOL[name]} kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib}{bnd} "
        f"{'main-path' if main_path else 'extra'} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain version")
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
    """Sets (object, attribute, value) triples for the block, then restores them."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    for obj, name, value in pairs:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def plain_attention(qkv, freqs, num_heads, kv_len=None):
    """The inference attention through the plain versions, routed by length
    as the kernels are (K1's, or K10a's then K10's)."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention

    if attention.attention_route(qkv.shape[1]) == "pair_long":
        return attention.fused_qkv_rope_attention_long_plain(qkv, freqs, num_heads, kv_len)
    return attention.fused_qkv_rope_attention_plain(qkv, freqs, num_heads, kv_len)


def plain_kernels():
    """Routes the model's kernel calls to the plain versions (for the
    kernel-vs-plain model compares)."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention, conv1d
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as flash

    return patched([(attention, "fused_qkv_rope_attention", plain_attention),
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


def conv_name(name, dtype):
    """The results entry of conv kernel `name` for activations of `dtype`."""
    import torch

    return name + ("_f32" if dtype == torch.float32 else "")


def conv_case(results, name, label, field, x, w, bias, a, ib, kernel, plain, flops, halo, up=1,
              **lib_kw):
    """One K2 or K4 compare on x's dtype, reported under conv_name(name).
    Bound: the products at the bf16 rate, or the fp32-accurate rate for
    fp32; w read once in x's dtype."""
    import torch

    y = torch.empty(x.shape[0], x.shape[1] * up, w.shape[2], device=DEVICE, dtype=x.dtype)
    peak = PEAK_FP32_ACCURATE if x.dtype == torch.float32 else PEAK_FLOPS
    bound = bound_ms(flops, nbytes(x, y, bias) + w.numel() * x.element_size(), peak=peak)
    del y
    name = conv_name(name, x.dtype)
    report(results, name, label, True, *compare(
        name, kernel, lambda: segmented(plain, x, halo, up),
        library_fn=conv_library(x, w, bias, a, ib, **lib_kw)), bound=bound, field=field)


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
                        xs, w1, b1, a1, i1, w2, b2, a2, i2, dilation=d), x, 3 * d)),
                    bound=bound, field=ru_field)
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

    # small ragged shapes
    x = rnd(2, 301, 32, scale=0.5).to(dtype)
    w = rnd(7, 32, 48, scale=1 / math.sqrt(7 * 32))
    bb = rnd(48, scale=0.1)
    a, ib = snake_params(rnd, 32)
    name = conv_name("snake_conv1d", dtype)
    report(results, name, "B2 T301 32->48 d3", False, *compare(
        name, lambda: conv1d.snake_conv1d(x, w, bb, a, ib, dilation=3),
        lambda: conv1d.snake_conv1d_plain(x, w, bb, a, ib, dilation=3)))
    x = rnd(2, 333, 128, scale=0.5).to(dtype)
    w1, w2 = rnd(7, 128, 128, scale=1 / math.sqrt(7 * 128)), rnd(128, 128, scale=1 / math.sqrt(128))
    b1, b2 = rnd(128, scale=0.1), rnd(128, scale=0.1)
    (a1, i1), (a2, i2) = snake_params(rnd, 128), snake_params(rnd, 128)
    name = conv_name("fused_residual_unit", dtype)
    report(results, name, "B2 T333 C128 d9", False, *compare(
        name, lambda: conv1d.fused_residual_unit(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation=9),
        lambda: conv1d.fused_residual_unit_plain(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation=9)))
    cout = 96 if dtype == torch.float32 else 128  # the fp32 kernel takes Cout % 32 == 0
    x = rnd(2, 77, 128, scale=0.5).to(dtype)
    w = rnd(8, 128, cout, scale=1 / math.sqrt(2 * 128))
    a, ib = snake_params(rnd, 128)
    name = conv_name("snake_conv_transpose1d", dtype)
    report(results, name, f"B2 T77 128->{cout} s4", False, *compare(
        name, lambda: conv1d.snake_conv_transpose1d(x, w, b1[:cout], a, ib, stride=4),
        lambda: conv1d.snake_conv_transpose1d_plain(x, w, b1[:cout], a, ib, stride=4)))


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
        hd = h * 64
        thirds = " ".join(f"{n} {rel_err(d[..., i * hd:(i + 1) * hd], d_p[..., i * hd:(i + 1) * hd]):.3g}"
                          for i, n in enumerate("qkv"))
        ok, max_abs, rel_l2, peak = within(bwd, d, d_p)
        bound = attention_bound(b, h, valid, 5, [qkv, out_p, lse_p, go], [d])
        del d, d_p
        o = sdpa(q, k, v)
        g = go.view(b, t, h, 64).transpose(1, 2)
        lib_ms = timed_ms(lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True), 3)
        report(results, bwd, label, main, ok, max_abs, rel_l2, peak, timed_ms(k6, 3),
               timed_ms(k6_plain, 3), lib_ms, bound=bound,
               extra=f" (rel-L2 of dq/dk/dv: {thirds})")
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
    k2, ru = conv_name("snake_conv1d", dtype), conv_name("fused_residual_unit", dtype)
    peak = PEAK_FP32_ACCURATE if dtype == torch.float32 else PEAK_FLOPS
    # K2: conv_in 2 -> 128 (k 7, no snake) at the sample size; conv_out
    # snake 2048 -> 128 (k 3) at the latent frames
    for t, cin, cout, k, sn in [(n, 2, 128, 7, False), (n // 2048, 2048, 128, 3, True)]:
        label = f"B{b} T{t} {cin}->{cout} k{k}"
        results[k2]["weight"][label] = calls
        x = rnd(b, t, cin, scale=0.5).to(dtype)
        w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
        bb = rnd(cout, scale=0.1)
        a, ib = snake_params(rnd, cin) if sn else (None, None)
        conv_case(results, "snake_conv1d", label, field, x, w, bb, a, ib,
                  lambda: conv1d.snake_conv1d(x, w, bb, a, ib),
                  lambda xs: conv1d.snake_conv1d_plain(xs, w, bb, a, ib),
                  2 * b * t * cin * cout * k, halo=k // 2)
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
                    xs, w1, b1, a1, i1, w2, b2, a2, i2, dilation=d), x, 3 * d)),
                bound=bound, field=field)
        del x
    for name in (k2, ru):
        r = results[name]
        log(f"  {name}: {r[field]:.4f} ms per training-step encode ({calls} calls at batch "
            f"{b}), plain {r['plain_' + field]:.4f} ms, bound {r['bound_' + field]:.4f} ms")


def dac_conv_phase(results):
    """[3f] fp32 K2 and K4 at every shape of Stable Audio 1.0's DAC decode of
    4096 latent frames (4,194,304 samples), batch 1, weighted by the calls
    per decode: conv_in 64 -> 1536 (k 7); per block, the upsample, then three
    residual units of a k-7 conv at dilations 1, 3, 9 and a 1x1 conv, none
    with a fused snake (the DAC applies its Snake on its own); conv_out
    96 -> 2 (k 7). 26 K2 and 4 K4 launches."""
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    rnd = randn_fn(9)
    k2 = results["snake_conv1d_f32"]
    frames = SA1_SAMPLE_SIZE // 1024
    k2_cases = [(frames, 64, 1536, 7, 1, 1)]
    t, ch = frames, 1536
    for rate in (8, 8, 4, 4):
        x = rnd(1, t, ch, scale=0.5)
        w = rnd(2 * rate, ch, ch // 2, scale=1 / math.sqrt(2 * ch))
        bb = rnd(ch // 2, scale=0.1)
        conv_case(results, "snake_conv_transpose1d", f"DAC B1 T{t} {ch}->{ch // 2} s{rate}", "ms", x,
                  w, bb, None, None, lambda: conv1d.snake_conv_transpose1d(x, w, bb, stride=rate),
                  lambda xs: conv1d.snake_conv_transpose1d_plain(xs, w, bb, stride=rate),
                  2 * t * rate * ch * (ch // 2) * 2, halo=1, up=rate, stride=rate)
        del x
        t, ch = t * rate, ch // 2
        k2_cases += [(t, ch, ch, 7, d, 1) for d in (1, 3, 9)] + [(t, ch, ch, 1, 1, 3)]
    k2_cases.append((t, ch, 2, 7, 1, 1))
    for t, cin, cout, k, d, calls in k2_cases:
        label = f"DAC B1 T{t} {cin}->{cout} k{k} d{d}"
        k2["weight"][label] = calls
        x = rnd(1, t, cin, scale=0.5)
        w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
        bb = rnd(cout, scale=0.1)
        conv_case(results, "snake_conv1d", label, "ms", x, w, bb, None, None,
                  lambda: conv1d.snake_conv1d(x, w, bb, dilation=d),
                  lambda xs: conv1d.snake_conv1d_plain(xs, w, bb, dilation=d),
                  2 * t * cin * cout * k, halo=d * (k - 1) // 2, dilation=d)
        del x
    if sum(calls for *_, calls in k2_cases) != 26:
        raise AssertionError(f"the DAC decode's K2 shapes do not add up to 26 calls: {k2_cases}")
    for name, n_calls in (("snake_conv1d_f32", 26), ("snake_conv_transpose1d_f32", 4)):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms per SA 1.0 DAC decode ({n_calls} calls), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, library {r['library_ms']:.4f} ms")


def dac_encode_conv_phase(results, config):
    """[3f] fp32 K2 at every shape of Stable Audio 1.0's DAC encode of one
    clip of 4,194,304 samples (one clip per encode call, `iterate_batch`),
    weighted by the calls per clip times the clips per training step, under
    `sa1_encode_ms`: conv_in 2 -> 128 (k 7); per block, three residual units
    of a k-7 conv at dilations 1, 3, 9 and a 1x1 conv at the block's input
    width (128, 256, 512, 1024), then the strided downsample (the plain
    reshape-GEMM form, no kernel); conv_out 2048 -> 2048 (k 3). None has a
    fused snake (the DAC applies its Snake on its own). 26 K2 launches per
    clip."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d

    rnd = randn_fn(11)
    k2 = results["snake_conv1d_f32"]
    enc = config["model"]["pretransform"]["config"]["encoder"]["config"]
    clips = encode_calls(config)
    t, ch = config["sample_size"], enc["d_model"]
    k2_cases = [(t, enc["in_channels"], ch, 7, 1, 1)]
    for stride in enc["strides"]:
        k2_cases += [(t, ch, ch, 7, d, 1) for d in (1, 3, 9)] + [(t, ch, ch, 1, 1, 3)]
        t, ch = t // stride, ch * 2
    k2_cases.append((t, ch, ch, 3, 1, 1))
    if sum(calls for *_, calls in k2_cases) != 26:
        raise AssertionError(f"the DAC encode's K2 shapes do not add up to 26 calls: {k2_cases}")
    for t, cin, cout, k, d, calls in k2_cases:
        label = f"DAC encode B1 T{t} {cin}->{cout} k{k} d{d}"
        k2["weight"][label] = calls * clips
        x = rnd(1, t, cin, scale=0.5)
        w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
        bb = rnd(cout, scale=0.1)
        conv_case(results, "snake_conv1d", label, "sa1_encode_ms", x, w, bb, None, None,
                  lambda: conv1d.snake_conv1d(x, w, bb, dilation=d),
                  lambda xs: conv1d.snake_conv1d_plain(xs, w, bb, dilation=d),
                  2 * t * cin * cout * k, halo=d * (k - 1) // 2, dilation=d)
        del x
    log(f"  snake_conv1d_f32: {k2['sa1_encode_ms']:.4f} ms per SA 1.0 training-step encode "
        f"({26 * clips} calls: 26 per clip, {clips} clips), plain {k2['plain_sa1_encode_ms']:.4f} ms, "
        f"bound {k2['bound_sa1_encode_ms']:.4f} ms, library {k2['library_sa1_encode_ms']:.4f} ms")


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
        report(results, "rope_pair_k", label, main, *compare(
            "rope_pair_k", lambda: attention.rope_pair_k(qkv, f, h),
            lambda: attention.rope_pair_k_plain(qkv, f, h)),
            bound=bound_ms(0, (nbytes(k_part) + nbytes(khat)) * valid // t + nbytes(f) * 2))
        q, k, v = sdpa_inputs(qkv, f, h, kv)
        qv = qkv[..., :h * 64], qkv[..., 2 * h * 64:]
        report(results, "pair_long_attention", label, main, *compare(
            "pair_long_attention", lambda: attention.pair_long_attention(qkv, khat, f, h, kv),
            lambda: attention.pair_long_attention_plain(qkv, khat, f, h, kv),
            library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
            bound=attention_bound(b, h, valid, 2, [*qv, khat], [khat]))
        if main:  # what roping K once buys: K1's kernel on the same inputs
            k1_ms = timed_ms(lambda: attention._launch_forward(qkv, f, h, valid, False), 3)
            log(f"  K1's kernel (each key tile roped once per q tile) on the same inputs: "
                f"{k1_ms:.4f} ms")
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
    """[3e] K7 (forward with LSE) and K9 (two-pass backward) against their
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
        report(results, "flash_backward", label, main, ok, max_abs, max(rels), peak, timed_ms(k9, 3),
               timed_ms(k9_plain, 3), lib_ms, bound=bound,
               extra=f" (rel-L2 of dq/dk/dv: {' '.join(f'{r:.3g}' for r in rels)}; padded rows "
                     f"zero: {pad_zero}; at the CUDA cores' fp32 rate {cores_ms:.4f} ms)")
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
    cases = [(bh_train, t, d, None, calls) for t, d, calls in SA1_TRAIN_ATTENTION]
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


def build_model(config):
    """A model on the card in fp32: random weights, seed 0, de-zeroed."""
    import torch

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.utils.common import dezero_

    model = create_model_from_config(config, seed=0, device=DEVICE)
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
            or counts["fused_qkv_rope_attention_backward"] != depth):
        raise AssertionError(f"one checkpointed step should launch K5 {2 * depth} and K6 {depth} "
                             f"times: {counts}")
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
    "fused_residual_unit": ("conv1d", "fused_residual_unit_launches"),
    "snake_conv_transpose1d": ("conv1d", "snake_conv_transpose1d_launches"),
    "flash_forward_serving": ("flash", "serving_launches"),
    "snake_conv1d_f32": ("conv1d", "snake_conv1d_f32_launches"),
    "fused_residual_unit_f32": ("conv1d", "fused_residual_unit_f32_launches"),
    "snake_conv_transpose1d_f32": ("conv1d", "snake_conv_transpose1d_f32_launches"),
}


def _kernel_modules():
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention, conv1d
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention

    return {"attention": attention, "conv1d": conv1d, "flash": flash_attention}


def reset_counts():
    mods = _kernel_modules()
    for mod, attr in KERNELS.values():
        setattr(mods[mod], attr, 0)


def read_counts():
    mods = _kernel_modules()
    return {name: getattr(mods[mod], attr) for name, (mod, attr) in KERNELS.items()}


def train_args(config, tmp, name, n_wavs, seconds, dit_path):
    """Writes `n_wavs` synthetic WAVs of `seconds`, the model config and an
    audio_dir dataset config under tmp; returns the train CLI's arguments
    (batch 8, 4 loader workers, the de-zeroed DiT as the starting weights)."""
    import numpy as np
    from scipy.io import wavfile

    # console logging only: the train CLI logs to wandb when WANDB_API_KEY is set
    os.environ.pop("WANDB_API_KEY", None)
    tmp = Path(tmp)
    wavs = tmp / f"wavs_{name}"
    wavs.mkdir()
    for i in range(n_wavs):
        audio = synthetic_audio(100 + i, seconds * config["sample_rate"])
        wavfile.write(str(wavs / f"clip{i:02d}.wav"), config["sample_rate"],
                      (audio.T * 32767).astype(np.int16))
    (tmp / f"{name}_model.json").write_text(json.dumps(config))
    (tmp / f"{name}_data.json").write_text(json.dumps(
        {"dataset_type": "audio_dir", "datasets": [{"id": "synthetic", "path": str(wavs)}]}))
    return ["--model-config", str(tmp / f"{name}_model.json"),
            "--dataset-config", str(tmp / f"{name}_data.json"),
            "--batch-size", str(TRAIN_BATCH), "--seed", "0", "--num-workers", "4",
            "--save-dir", str(tmp / "run"), "--name", name, "--pretrained-ckpt-path", str(dit_path)]


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
    "pair": K5 and K6; "flash": K7 and K9); each call of the frozen fp32
    encode (one per clip, iterate_batch) runs the fp32 K2 twice (conv_in,
    conv_out) and the fp32 K3 once per residual unit (3 in each encoder
    block); nothing else."""
    depth = config["model"]["diffusion"]["config"]["depth"]
    n_units = 3 * len(config["model"]["pretransform"]["config"]["encoder"]["config"]["c_mults"])
    calls = encode_calls(config)
    fwd, bwd = {"pair": ("fused_qkv_rope_attention_stats", "fused_qkv_rope_attention_backward"),
                "flash": ("flash_forward", "flash_backward")}[route]
    per_step = {name: 0 for name in KERNELS}
    per_step.update({fwd: 2 * depth, bwd: depth, "snake_conv1d_f32": 2 * calls,
                     "fused_residual_unit_f32": n_units * calls})
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
    n_blocks = len(config["model"]["pretransform"]["config"]["encoder"]["config"]["strides"])
    per_step = {name: 0 for name in KERNELS}
    per_step.update(flash_forward=14, flash_backward_fused=14,
                    snake_conv1d_f32=(2 + 6 * n_blocks) * encode_calls(config))
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
    logs the walls, and returns the counts."""
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

    model.conditioner.forward = timed(model.conditioner.forward, "conditioners")
    model.pretransform.decode_nwc = timed(model.pretransform.decode_nwc, "decode")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    audio = generate_diffusion_cond(model, steps=STEPS, cfg_scale=CFG_SCALE, conditioning=[prompt],
                                    sample_size=sample_size, sampler_type="dpmpp-3m-sde",
                                    sigma_min=0.3, sigma_max=500, seed=42)
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
    return launches


def bench_recipe(model):
    """bench.py's bf16 recipe (bench.py:67, 157-159): the DiT's and the
    VAE's weights in bf16, the VAE computing in bf16 (`model_half`). The
    CLIs run the model's own fp32 instead."""
    import torch

    model.model.to(torch.bfloat16)
    model.pretransform.to(torch.bfloat16)
    model.pretransform.model_half = True


def sa1_unet_forward_phase(model):
    """[4c] One forward of SA 1.0's fp32 U-Net at 4096 latent frames with
    CFG (batch 2), through the kernels (K7 without its LSE at T 4096, 2048
    and 1024) and through their plain versions; same weights and inputs."""
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


def cli_generation_phase(config_path, prompt, expected):
    """The generate CLI (`generate.main`) on `config_path` for one prompt:
    100 dpmpp-3m-sde steps, CFG 7, the model in its own fp32, random weights
    (seed 0), one WAV written under build/. Times the conditioners, the
    decode and the whole `generate_diffusion_cond` call, each between two
    synchronisations; every launch count is set to 0 just before and read
    just after, and must equal `expected` (kernels not named: 0)."""
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
    return launches


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
            route="cuda", source=src + "attention_long.cu", replaces=tpu + "flash_attention.py:1229",
            per=f"SA 2.0 generation step (24 calls at B2 T{LONG_T})"),
        "pair_long_attention": dict(
            route="cuda", source=src + "attention_long.cu", replaces=tpu + "flash_attention.py:1233",
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
            route="cuda", source=src + "flash_attention.cu", replaces=tpu + "flash_attention.py:565",
            per=f"SA 2.0 training step (24 calls at B{TRAIN_BATCH} H24 T{LONG_T} kv_len {LONG_KV})"),
        "flash_backward_fused": dict(
            route="cuda", source=src + "flash_attention.cu", replaces=tpu + "flash_attention.py:426",
            per=f"SA 1.0 training step (14 calls at B{TRAIN_BATCH} x H16: 2 at T4096 D64, 6 at "
                f"T2048 D64, 6 at T1024 D80)"),
        "snake_conv1d": dict(route="cuda", source=src + "conv1d.cu", replaces=tpu + "conv1d.py:91",
                             per="SA 2.0 decode (2 calls)"),
        "fused_residual_unit": dict(route="cuda", source=src + "conv1d.cu",
                                    replaces=tpu + "conv1d.py:507", per="SA 2.0 decode (15 calls)"),
        "snake_conv_transpose1d": dict(route="cuda", source=src + "conv1d.cu",
                                       replaces=tpu + "conv1d.py:262", per="SA 2.0 decode (5 calls)"),
        "flash_forward_serving": dict(
            route="cuda", source=src + "flash_attention.cu", replaces=tpu + "flash_attention.py:230",
            per="SA 1.0 U-Net forward (14 calls at B2 x H16: 2 at T4096 D64, 6 at T2048 D64, 6 at "
                "T1024 D80)"),
        "snake_conv1d_f32": dict(route="cuda", source=src + "conv1d.cu",
                                 replaces=tpu + "conv1d.py:91", per="SA 1.0 DAC decode (26 calls)"),
        "fused_residual_unit_f32": dict(route="cuda", source=src + "conv1d_f32.cu",
                                        replaces=tpu + "conv1d.py:507",
                                        per="SAO 1.0 fp32 decode (15 calls)"),
        "snake_conv_transpose1d_f32": dict(route="cuda", source=src + "conv1d_f32.cu",
                                           replaces=tpu + "conv1d.py:262",
                                           per="SA 1.0 DAC decode (4 calls)"),
    }
    for r in results.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, weight={})
    # extra fields: sao_decode_ms and sa2_decode_ms (K2-K4 per SAO 1.0 and SA
    # 2.0 decode), encode_ms and sa2_encode_ms (K2 and K3 per SAO 1.0 and SA
    # 2.0 training step's encode), sa1_train_ms (K7 with its LSE per SA 1.0
    # training step), sa1_encode_ms (the fp32 K2 per SA 1.0 training step's
    # DAC encode), each with its plain_, bound_ and library_ times
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
    no_training = {"fused_qkv_rope_attention_stats": 0, "fused_qkv_rope_attention_backward": 0,
                   "flash_forward": 0, "flash_backward": 0, "flash_backward_fused": 0,
                   "flash_forward_serving": 0,
                   "snake_conv1d_f32": 0, "fused_residual_unit_f32": 0,
                   "snake_conv_transpose1d_f32": 0}
    launches = generation_phase(
        model, config, PROMPT, SAMPLE_SIZE,
        expected={"fused_qkv_rope_attention": 24 * STEPS, "rope_pair_k": 0, "pair_long_attention": 0,
                  "fused_residual_unit": 15, "snake_conv_transpose1d": 5, **no_training},
        min_counts={"snake_conv1d": 2})
    del model
    torch.cuda.empty_cache()
    done("[5]")

    # phases 6-7 write ~23 GB (a de-zeroed DiT and a full training checkpoint)
    # into the checkout's build/ directory, which the kernel build uses too
    log(f"[6] one DiT training step at batch {TRAIN_BATCH}: attention kernels vs plain bf16 vs "
        f"fp32 attention")
    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(scratch).free / 1e9
    log(f"  {free_gb:.1f} GB free under {scratch} for phases 6-7")
    if free_gb < 30:
        raise RuntimeError(f"phases 6-7 need ~23 GB of disk under {scratch}, {free_gb:.1f} GB free")
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        dit_path = dit_train_step_phase(config, tmp)
        done("[6]")
        log(f"[7] training path: train.main on SAO 1.0, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps "
            f"from {N_WAVS} synthetic {WAV_SECONDS} s WAVs, checkpoint, resume for one more step")
        counts_train, counts_resume = training_phase(config, tmp, dit_path)
    done("[7]")

    log("[4b] SA 2.0's DiT at 6144 latent frames: kernels vs plain versions")
    model = build_model(sa2_config)
    bench_recipe(model)
    dit_forward_phase(model, SA2_SAMPLE_SIZE // 2048, SA2_PROMPT, "SA 2.0")
    done("[4b]")
    log(f"[8] long-form path: SA 2.0 text-to-audio, {SA2_SAMPLE_SIZE} samples, 100 dpmpp-3m-sde "
        f"steps, CFG 7, bench.py's bf16 recipe")
    launches_long = generation_phase(
        model, sa2_config, SA2_PROMPT, SA2_SAMPLE_SIZE,
        expected={"fused_qkv_rope_attention": 0, "rope_pair_k": 24 * STEPS,
                  "pair_long_attention": 24 * STEPS, "fused_residual_unit": 15,
                  "snake_conv_transpose1d": 5, **no_training},
        min_counts={"snake_conv1d": 2})
    del model
    torch.cuda.empty_cache()
    done("[8]")

    # phases 6b and 9 write ~4.6 GB (SA 2.0's de-zeroed DiT and 8 WAVs)
    log(f"[6b] one SA 2.0 DiT training step at batch {TRAIN_BATCH}, T {LONG_T} kv_len {LONG_KV}: "
        f"K7/K9 vs their fp32 plain versions vs the bf16 K5/K6 route")
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        sa2_dit_path, _ = sa2_dit_train_step_phase(sa2_config, tmp)
        done("[6b]")
        log(f"[9] long-form training path: train.main on SA 2.0, batch {TRAIN_BATCH}, "
            f"{SA2_TRAIN_STEPS} steps from {SA2_WAVS} synthetic {SA2_WAV_SECONDS} s WAVs")
        counts_long = longform_training_phase(sa2_config, tmp, sa2_dit_path)
    done("[9]")

    log("[4c] SA 1.0's U-Net at 4096 latent frames: kernels vs plain versions, fp32")
    model = build_model(sa1_config)
    sa1_unet_forward_phase(model)
    del model
    torch.cuda.empty_cache()
    done("[4c]")
    log(f"[10] SA 1.0 path: the generate CLI on stable_audio_1_0.json, {SA1_SAMPLE_SIZE} samples, "
        f"{STEPS} dpmpp-3m-sde steps, CFG {CFG_SCALE}, fp32")
    launches_sa1 = cli_generation_phase(
        SA1_CONFIG, SA1_PROMPT, {"flash_forward_serving": 14 * STEPS, "snake_conv1d_f32": 26,
                                 "snake_conv_transpose1d_f32": 4})
    torch.cuda.empty_cache()
    done("[10]")
    log(f"[10b] the repaired dtype: the generate CLI on stable_audio_open_1_0.json in fp32 (K1 on "
        f"bf16 casts of the fp32 qkv, the fp32 K2/K3/K4 in the decode)")
    launches_fp32 = cli_generation_phase(
        SAO_CONFIG, PROMPT, {"fused_qkv_rope_attention": 24 * STEPS, "snake_conv1d_f32": 2,
                             "fused_residual_unit_f32": 15, "snake_conv_transpose1d_f32": 5})
    torch.cuda.empty_cache()
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
    done("[11]")

    by_path = {"generate": launches, "generate_long": launches_long, "train": counts_train,
               "train_resume": counts_resume, "train_long": counts_long,
               "generate_sa1": launches_sa1, "generate_fp32": launches_fp32,
               "train_sa1": counts_sa1}

    def entry(name, r):
        parts = r["bound_parts"]["ms"]
        out = dict(name=name, route=r["route"], source=r["source"], replaces=r["replaces"],
                   launches=sum(c[name] for c in by_path.values()), max_abs_err=r["max_abs_err"],
                   ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by=max(parts, key=parts.get), library_ms=r["library_ms"], per=r["per"],
                   launches_by_path={p: c[name] for p, c in by_path.items()})
        for f in ("sao_decode_ms", "sa2_decode_ms", "encode_ms", "sa2_encode_ms", "sa1_train_ms",
                  "sa1_encode_ms"):
            if f in r:
                out.update({k + f: r[k + f] for k in ("", "plain_", "bound_", "library_")})
        return out

    print(json.dumps({"kernels": [entry(name, r) for name, r in results.items()]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
