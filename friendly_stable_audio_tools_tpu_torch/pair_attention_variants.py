"""Times design variants of the attention kernels on Hopper against the
shipped ones on the card (the measurements behind the tile shapes of
csrc/attention.cu and csrc/flash_attention_bf16.cu and the notes of
csrc/attention_bwd.cu and csrc/flash_attention_bwd_f32.cu).

    python -m friendly_stable_audio_tools_tpu_torch.pair_attention_variants \
        [--out variants.json] [--parent CHECKOUT] [--check] [--cases K9] [--variants V]

Each variant is the shipped sources (csrc/) with one change, built apart
into a library of its own (run on the cases of the kernel it changes):

* ``keys64``: 64 keys per forward pipeline stage instead of 128;
* ``consumers3``: three consumer warpgroups (192 q rows per block) in the
  forward instead of two;
* ``no_dq_reduce``: K6 without its dq reduce-add (its dq is then wrong:
  timing only);
* ``bf16_keys64``, ``bf16_stages2``, ``bf16_stages4``: the bf16 K7 with 64
  keys per stage, or 2 or 4 stages instead of 3;
* ``bf16_turns_off``: the bf16 K7's consumer warpgroups starting their
  products freely instead of in turns;
* ``k9_raw_hi``: K9 with the raw fp32 value as each operand's tf32 hi part
  (the tensor cores read its top 19 bits) and lo = tf32(x - trunc(x)),
  instead of hi = tf32(x) and lo = tf32(x - hi) rounded to nearest (the
  split in attention_tiles.cuh, which the fp32 K7 shares);
* ``k9_no_dq_reduce``: K9 without its dq reduce-adds (its dq is then zero:
  timing only);
* ``k9_one_dq_reduce``: K9 with one 16 KB reduce-add per q tile instead of
  one per row (its dq is then wrong: timing only);
* ``k7_f32_slots2``: the fp32 K7 with a ring of 2 slots (one key tile's K
  and V^T) instead of 4 (D 64) or 3 (D 80);
* ``k7_f32_turns_off``: the fp32 K7's consumer warpgroups starting their
  products freely instead of in turns;
* ``rope_f32_turns_off``: the rope-fused K7's fp32 attention with its
  consumer warpgroups starting their products freely instead of in turns;
* ``rope_f32_kslots3``: its K^ ring of 3 tiles instead of 2;
* ``rope_bf16_short_first``: the rope-fused K7's bf16 attention taking each
  head's q tiles last first (at T 1025 the one-row tile in the first wave);
* ``rope_no_prefetch``: its rope pass without the L2 prefetch of its rows'
  q and k (k read by the pass, q roped by the attention next);
* ``rope_q_batch2``: the attention's q rope with 2 chunks' loads in flight
  at once instead of 4;
* ``rope_no_q_rope``: the attention's prologue reading q and scaling it
  without its rope (no partner, no tables; its output is then wrong: timing
  only);
* ``rope_q_generic_inline``: the q rope with its element-wise path (a rot
  that is not a multiple of 16) as a branch inside the 16-byte loop, never
  taken at rot 64, instead of a loop of its own;
* ``rope_f32_pv_once``: the fp32 attention's P.V as one tf32 product
  instead of three (its output is then less exact: timing only).

The rope-fused K7 (``--cases K7rope``) runs at SAO 1.0's shape with 12
heads of 128 (B 2, T 1025) in bf16 and fp32, the whole call timed (its
rope pass included; device time: every activity of the call), SDPA on q
and k roped outside beside it. With ``--parent``, a parent whose
flash_attention_rope.cu holds ``fsat_rope_heads`` (the design before the
q rope moved into the attention) runs its own route: the tables in torch,
its rope pass, the bf16 K7 or the fp32 K7 with a prescale of 1, the head
merge in torch.

K10a (attention_rope.cu) runs at ROPE_SHAPES (``--cases K10a``); with
``--parent`` its output is also held bit for bit against the parent's
kernel (``k10a_bit_equal_to_parent``).

``--parent CHECKOUT`` adds the kernels built from another checkout's csrc/
(e.g. the parent commit unpacked by ``git archive`` into a directory
.gitignore lists), timed at every case in the same turns: where K7's, K8's
or K9's C entry lives in that checkout's flash_attention.cu (the FFMA
kernels before their tensor-core redesigns), it is built from there, and
its K7 entry, which takes no scratch, is called without it. ``--cases S``
keeps the cases whose name holds S (e.g. ``K9``; ``K7f32,K8``: either).

The shipped build prints ``-Xptxas -v`` for attention.cu,
attention_rope.cu, flash_attention.cu, flash_attention_bf16.cu and flash_attention_bwd_f32.cu
(registers, shared memory, spills). K1, K5, K10 and
K6 run at their main-path shapes (chip_smoke's), and the bf16 K7 at the
ADP U-Net's (BH 32: T 4096 and 2048 at D 64, T 1024 at D 80) and SA 2.0's
DiT past 8192 tokens (BH 48, T 8576, kv_len 8449), and K9 at SA 2.0's
training shape (B 8 x 24 heads, T 6272, kv_len 6145, fp32) and the audio
LM's causal one (B 8 x 16 heads, T 1501), the fp32 K7 at every main-path
shape of chip_smoke [3e]-[3h] and [15b] (SA 2.0's training with its LSE,
the U-Net's serving and training shapes, the LM's causal shape with and
without its LSE, SA 2.0's DiT past 8192 tokens), K8 at SA 1.0's
training shapes (B 8 x 16 heads: T 4096 and 2048 at D 64, T 1024 at D 80),
and K8 and K9 at head dim 32 at Dance Diffusion's training shapes (K8 at BH
32 T 1024 and BH 16 T 2048 / 4096, K9 at BH 16 T 8192; a parent whose K9
source has no D 32 instance skips those cases, and one whose C entry takes
no head dim is called without it),
each library on the cases of the source it changes, in turns (shipped, the
variants, the variants again in reverse, shipped): per call the CUDA-event
time of the wrapper (K1/K5/K6's K10a launches, the fp32 K7's pre-pass and
K8/K9's dq zeroing and delta included, best of the two turns) and, from
torch.profiler, the device time of the kernels alone (the fp32 K7's
pre-pass included); beside the K7 cases, SDPA's time on the same heads
(K/V cut to kv_len; causal with is_causal), and beside K8 and K9, SDPA's
backward alone (fp32, TF32 off). Each output is held
against the plain version (the dq-reduce variants excepted; K9's rel-L2 is
the largest of dq's, dk's and dv's); ``--check`` stops after one such
pass. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from .ops.kernels import build

# variant -> (source file, [(text in it, replacement), ...])
BF16_SOURCE = "flash_attention_bf16.cu"
K7_SOURCE = "flash_attention.cu"
ROPE_SOURCE = "flash_attention_rope.cu"  # the rope-fused K7's pass and fp32 attention
K9_SOURCE = "flash_attention_bwd_f32.cu"  # K9 and K8
# one dq row's reduce-add in K9_SOURCE
K9_ROW_REDUCE = ("bulk_reduce_add_f32(dq + head + (size_t)(q0 + tid) * D, "
                 "staged + tid * L::kStageRow, D * 4);")
TILES = "attention_tiles.cuh"
VARIANTS = {
    "keys64": ("attention.cu", [("constexpr int kN = 128;", "constexpr int kN = 64;")]),
    "consumers3": ("attention.cu", [("constexpr int kConsumers = 2;",
                                     "constexpr int kConsumers = 3;")]),
    "no_dq_reduce": ("attention_bwd.cu", [
        ("if (tid == 0) bulk_reduce_add_f32(dq_bh + (size_t)q0 * kD, buf, kAccTile);", "")]),
    "bf16_keys64": (BF16_SOURCE, [("constexpr int kN = 128;", "constexpr int kN = 64;")]),
    "bf16_stages2": (BF16_SOURCE, [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
    "bf16_stages4": (BF16_SOURCE, [("constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
    "bf16_turns_off": (BF16_SOURCE, [("constexpr bool kTurns = true;",
                                      "constexpr bool kTurns = false;")]),
    "k9_raw_hi": ("attention_tiles.cuh", [(
        "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));",
        "  hi = __float_as_uint(x);\n"
        "  lo = tf32_rna(x - __uint_as_float(hi & 0xFFFFE000u));")]),
    "k9_no_dq_reduce": (K9_SOURCE, [(K9_ROW_REDUCE, "{}")]),
    "k9_one_dq_reduce": (K9_SOURCE, [(
        "if (tid < kQ && q0 + tid < T)\n      " + K9_ROW_REDUCE,
        "if (tid == 0 && q0 + kQ <= T)\n"
        "      bulk_reduce_add_f32(dq + head + (size_t)q0 * D, staged, kQ * D * 4);")]),
    "k7_f32_slots2": (K7_SOURCE, [("static constexpr int kSlots = D == 32 ? 8 : D == 64 ? 4 : 3;",
                                   "static constexpr int kSlots = 2;")]),
    "k7_f32_turns_off": (K7_SOURCE, [
        ("auto my_turn = [&] { bar_sync(kTurnBarrier + wg, 256); };", "auto my_turn = [&] {};"),
        ("auto pass_turn = [&] { bar_arrive(kTurnBarrier + 1 - wg, 256); };",
         "auto pass_turn = [&] {};")]),
    "rope_f32_turns_off": (ROPE_SOURCE, [
        ("auto my_turn = [&] { bar_sync(kTurnBarrier + wg, 256); };", "auto my_turn = [&] {};"),
        ("auto pass_turn = [&] { bar_arrive(kTurnBarrier + 1 - wg, 256); };",
         "auto pass_turn = [&] {};")]),
    "rope_f32_kslots3": (ROPE_SOURCE, [("constexpr int kKSlots = 2;",
                                        "constexpr int kKSlots = 3;")]),
    "rope_no_prefetch": (ROPE_SOURCE, [(
        "prefetch_l2(qkv + (size_t)(row0 + threadIdx.x) * 3 * hd, 2 * hd * (uint32_t)sizeof(Tin));",
        "{}")]),
    "rope_q_batch2": (TILES, [("constexpr int kBatch = 4;", "constexpr int kBatch = 2;")]),
    "rope_no_q_rope": (TILES, [("const bool rotary = d0 < rot,", "const bool rotary = false,")]),
    "rope_q_generic_inline": (TILES, [(
        "            if (rotary) {\n"
        "              const float pb = round_bf16(p[i][j]);\n"
        "              y = __fadd_rn(__fmul_rn(x[i][j], c[i][j]), "
        "__fmul_rn(low ? -pb : pb, s[i][j]));\n"
        "            }\n",
        "            if (rotary && (rot & 15) == 0) {\n"
        "              const float pb = round_bf16(p[i][j]);\n"
        "              y = __fadd_rn(__fmul_rn(x[i][j], c[i][j]), "
        "__fmul_rn(low ? -pb : pb, s[i][j]));\n"
        "            } else if (d0 + j < rot) {\n"
        "              const int d = d0 + j, t = r0 + r;\n"
        "              const Tin* row = base + t * stride;\n"
        "              const float pe = d < half ? -round_bf16(load1(row + d + half))\n"
        "                                        : round_bf16(load1(row + d - half));\n"
        "              y = __fadd_rn(__fmul_rn(x[i][j], cos_q[(size_t)t * rot + d]),\n"
        "                            __fmul_rn(pe, sin_q[(size_t)t * rot + d]));\n"
        "            }\n")]),
    "rope_f32_pv_once": (ROPE_SOURCE, [
        ("    wgmma_tf32<D>(o, hi[kk], kmajor_desc(v_lo), 1);\n"
         "    wgmma_tf32<D>(o, hi[kk], kmajor_desc(v_hi), 1);\n", "")]),
    "rope_bf16_short_first": (BF16_SOURCE, [(
        "const int q0 = blockIdx.x * kM, bh = blockIdx.y;",
        "const int q0 = (kRope ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kM, "
        "bh = blockIdx.y;")]),
}
# the sources each library is built from, where a checkout has them (K9's C
# entry is in K9_SOURCE, or in a parent's FFMA flash_attention.cu)
SOURCES = ("attention.cu", "attention_bwd.cu", "attention_rope.cu", BF16_SOURCE, K7_SOURCE,
           K9_SOURCE, ROPE_SOURCE, "flash_attention_d128.cu")
ENTRY_POINTS = ("fsat_pair_attention", "fsat_pair_attention_bwd", "fsat_rope_pair",
                "fsat_flash_forward_bf16", "fsat_flash_backward", "fsat_flash_forward",
                "fsat_flash_backward_fused", "fsat_flash_forward_d128")
# entry points that only some checkouts have: the rope-fused K7's (the
# shipped one; a parent's rope pass before the q rope moved into the attention)
OPTIONAL_ENTRY_POINTS = {
    "fsat_flash_rope_attention": build.SIGNATURES.get("fsat_flash_rope_attention"),
    "fsat_rope_heads": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                     ctypes.c_void_p]}
# -Xptxas -v for the shipped build
PTXAS_REPORT = ("attention.cu", "attention_rope.cu", BF16_SOURCE, K7_SOURCE, K9_SOURCE,
                ROPE_SOURCE)
# (B, T, H, kv_len) of each head-pair kernel's main path
PAIR_SHAPES = {"K1": (2, 1025, 24, None), "K5": (8, 1040, 24, 1025), "K10": (2, 6272, 24, 6145),
               "K6": (8, 1040, 24, 1025)}
# (BH, T, D, kv_len) of the bf16 K7's: the ADP U-Net's levels, SA 2.0's DiT past 8192 tokens
BF16_SHAPES = {"K7 BH32 T4096 D64": (32, 4096, 64, None), "K7 BH32 T2048 D64": (32, 2048, 64, None),
               "K7 BH32 T1024 D80": (32, 1024, 80, None),
               "K7 BH24 T1025 D128": (24, 1025, 128, None),
               "K7 BH48 T8576 kv8449 D64": (48, 8576, 64, 8449)}
# (BH, T, kv_len, causal, D) of K9's: SA 2.0's DiT training (B 8 x 24 heads),
# the audio LM's causal training (B 8 x 16 heads), Dance Diffusion's U-Net at
# 2,097,152 samples (16 heads of 32)
K9_SHAPES = {"K9 BH192 T6272 kv6145": (192, 6272, 6145, False, 64),
             "K9 causal BH128 T1501": (128, 1501, None, True, 64),
             "K9 BH16 T8192 D32": (16, 8192, None, False, 32)}
# (BH, T, D, kv_len, save_stats, causal) of the fp32 K7's: SA 2.0's DiT
# training, the U-Net's serving (B 2 x 16 heads) and training (B 8 x 16)
# levels, the LM's causal training and no-grad forward, SA 2.0's DiT past
# 8192 tokens
K7_F32_SHAPES = {
    "K7f32 lse BH192 T6272 kv6145 D64": (192, 6272, 64, 6145, True, False),
    "K7f32 serve BH32 T4096 D64": (32, 4096, 64, None, False, False),
    "K7f32 serve BH32 T2048 D64": (32, 2048, 64, None, False, False),
    "K7f32 serve BH32 T1024 D80": (32, 1024, 80, None, False, False),
    "K7f32 lse BH128 T4096 D64": (128, 4096, 64, None, True, False),
    "K7f32 lse BH128 T2048 D64": (128, 2048, 64, None, True, False),
    "K7f32 lse BH128 T1024 D80": (128, 1024, 80, None, True, False),
    "K7f32 causal lse BH128 T1501 D64": (128, 1501, 64, None, True, True),
    "K7f32 causal serve BH128 T1501 D64": (128, 1501, 64, None, False, True),
    "K7f32 online BH48 T8576 kv8449 D64": (48, 8576, 64, 8449, False, False)}
# (BH, T, D) of K8's: SA 1.0's U-Net training (B 8 x 16 heads), Dance
# Diffusion's U-Net training (2 x 262,144 samples: BH 32 at T 1024; 1 x
# 524,288: BH 16 at T 2048; BH 16 at T 4096 from 1,048,576 samples)
K8_SHAPES = {"K8 BH128 T4096 D64": (128, 4096, 64), "K8 BH128 T2048 D64": (128, 2048, 64),
             "K8 BH128 T1024 D80": (128, 1024, 80), "K8 BH32 T1024 D32": (32, 1024, 32),
             "K8 BH16 T2048 D32": (16, 2048, 32), "K8 BH16 T4096 D32": (16, 4096, 32)}
# the cases a library built before K8 and K9 took head dim 32 cannot run
D32_CASES = ("K9 BH16 T8192 D32", "K8 BH32 T1024 D32", "K8 BH16 T2048 D32", "K8 BH16 T4096 D32")
# (B, T, H, part) of K10a's: k at SA 2.0's long-form serving shape (24 calls
# per generation step) and SAO 1.0's (B2 T1025), q (prescaled by
# log2(e)/8) and k at SAO 1.0's training shape (K6's two calls); each
# output also held bit for bit against the parent's where --parent is given
ROPE_SHAPES = {"K10a k B2 T6272 H24": (2, 6272, 24, 1), "K10a k B2 T1025 H24": (2, 1025, 24, 1),
               "K10a q B8 T1040 H24": (8, 1040, 24, 0), "K10a k B8 T1040 H24": (8, 1040, 24, 1)}
# (B, T, H, D, dtype name) of the rope-fused K7's: SAO 1.0 with 12 heads of
# 128 at CFG batch 2 (24 calls per DiT forward)
ROPE_K7_SHAPES = {"K7rope bf16 B2 T1025 H12 D128": (2, 1025, 12, 128, "bfloat16"),
                  "K7rope f32 B2 T1025 H12 D128": (2, 1025, 12, 128, "float32")}
# the kernel whose device time each case reports (a substring of its name;
# K9's matches both of the FFMA two-pass kernels)
KERNEL_NAMES = {"K1": "pair_attention_kernel", "K5": "pair_attention_kernel",
                "K10": "pair_attention_kernel", "K6": "pair_bwd_kernel",
                **{key: "bf16_kernel" for key in BF16_SHAPES},
                **{key: "flash_bwd" for key in {**K9_SHAPES, **K8_SHAPES}},
                **{key: "flash_" for key in K7_F32_SHAPES},
                **{key: "rope_" for key in ROPE_SHAPES},
                **{key: "" for key in ROPE_K7_SHAPES}}  # every activity of the call
# the source each case's kernel is built from
CASE_SOURCES = {"K1": "attention.cu", "K5": "attention.cu", "K10": "attention.cu",
                "K6": "attention_bwd.cu", **{key: BF16_SOURCE for key in BF16_SHAPES},
                **{key: K9_SOURCE for key in K9_SHAPES},
                **{key: K7_SOURCE for key in K7_F32_SHAPES},
                **{key: K9_SOURCE for key in K8_SHAPES},
                **{key: "attention_rope.cu" for key in ROPE_SHAPES},
                **{key: ROPE_SOURCE for key in ROPE_K7_SHAPES}}


class _OldEntries:
    """A library built from an older csrc/: where its fsat_flash_forward
    takes no scratch (the FFMA K7), called without it; where its
    fsat_flash_backward takes no head dim (K9 at D 64 only), called without
    it; its other entries as they are."""

    def __init__(self, lib, forward_without_scratch, backward_without_d):
        self._lib = lib
        self._forward, self._backward = forward_without_scratch, backward_without_d

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name == "fsat_flash_forward" and self._forward:
            return lambda *args: fn(*args[:5], *args[6:])
        if name == "fsat_flash_backward" and self._backward:
            return lambda *args: fn(*args[:12], *args[13:])
        return fn


# the kernel source whose cases a variant runs, where it edits another file
# (the split in attention_tiles.cuh, which K9 and the fp32 K7 share: timed on
# K9; the rope-fused K7's q rope there and its bf16 attention's block order:
# timed on the rope-fused K7's cases)
VARIANT_CASES = {"k9_raw_hi": K9_SOURCE, "rope_bf16_short_first": ROPE_SOURCE,
                 "rope_q_batch2": ROPE_SOURCE, "rope_no_q_rope": ROPE_SOURCE,
                 "rope_q_generic_inline": ROPE_SOURCE}
# variants whose output is wrong by design (timing only)
TIMING_ONLY = ("no_dq_reduce", "k9_no_dq_reduce", "k9_one_dq_reduce", "rope_no_q_rope",
               "rope_f32_pv_once")


def case_source(name: str) -> str:
    """The source of the kernel whose cases variant `name` runs."""
    return VARIANT_CASES.get(name, VARIANTS[name][0])


def build_variant(name: str, tmp: Path, csrc: Path = build.CSRC_DIR,
                  sources=SOURCES) -> ctypes.CDLL:
    """`sources` of `csrc` with VARIANTS[name]'s substitutions (none for
    "shipped" or "parent"), compiled with build.NVCC_FLAGS into
    tmp/name/lib.so and bound; the shipped build prints -Xptxas -v."""
    src = tmp / name
    shutil.copytree(csrc, src)
    sources = [f for f in sources if (src / f).exists()]
    if name in VARIANTS:
        file, edits = VARIANTS[name][:2]
        text = (src / file).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in {file} exactly once")
            text = text.replace(old, new)
        (src / file).write_text(text)
    nvcc = build.find_nvcc()
    report = name == "shipped"
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS,
                               *(["-Xptxas", "-v"] if report and f in PTXAS_REPORT else []),
                               "-I", str(src), "-c", "-o", str(src / (f + ".o")), str(src / f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for f in sources]
    for f, proc in zip(sources, procs):
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {f}:\n{out}")
        if report and f in PTXAS_REPORT:
            print(f"ptxas, {f}:\n{out}", flush=True)
    lib_path = src / "lib.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    *(str(src / (f + ".o")) for f in sources)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    old_forward = "float* scratch" not in (src / K7_SOURCE).read_text()
    k9_file = next(f for f in (K9_SOURCE, K7_SOURCE) if (src / f).exists()
                   and "fsat_flash_backward(" in (src / f).read_text())
    old_backward = not re.search(r"fsat_flash_backward\([^)]*int D, int causal",
                                 (src / k9_file).read_text())
    for entry, argtypes in OPTIONAL_ENTRY_POINTS.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    for entry in ENTRY_POINTS:
        fn = getattr(lib, entry)
        fn.argtypes = build.SIGNATURES[entry]
        if entry == "fsat_flash_forward" and old_forward:
            fn.argtypes = fn.argtypes[:5] + fn.argtypes[6:]
        if entry == "fsat_flash_backward" and old_backward:
            fn.argtypes = fn.argtypes[:12] + fn.argtypes[13:]
        fn.restype = ctypes.c_int
    return _OldEntries(lib, old_forward, old_backward) if old_forward or old_backward else lib


def parent_rope_attention(lib, qkv, freqs, num_heads: int):
    """The rope-fused K7 as a parent with `fsat_rope_heads` ran it: the
    tables in torch, its rope pass (q^, k^, v split into heads), the bf16 K7
    or the fp32 K7 with a prescale of 1, the head merge in torch."""
    import math

    import torch

    from .ops.kernels import flash_attention as flash

    b, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    bh, rot, scale = b * num_heads, freqs.shape[-1], flash.LOG2E / math.sqrt(d)
    stream = torch.cuda.current_stream().cuda_stream
    tables = flash.rope_tables(freqs, t, scale)
    q, k, v, out = (torch.empty(bh, t, d, device=qkv.device, dtype=qkv.dtype) for _ in range(4))
    bf16 = qkv.dtype == torch.bfloat16
    err = lib.fsat_rope_heads(qkv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              *(c.data_ptr() for c in tables), b, t, num_heads, d, rot, scale,
                              int(bf16), stream)
    if bf16:
        err = err or lib.fsat_flash_forward_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 out.data_ptr(), bh, t, t, d, 1.0, stream)
    else:
        scratch = torch.empty(flash.forward_scratch_floats(bh, t, d), device=qkv.device)
        err = err or lib.fsat_flash_forward_d128(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 out.data_ptr(), None, scratch.data_ptr(), bh, t,
                                                 t, 1.0, stream)
    build.check(err, "parent_rope_attention")
    return flash.merge_heads(out, b, num_heads)


def rope_call(qkv, freqs, num_heads: int):
    """The rope-fused K7 through the library in use: the shipped route where
    it has `fsat_flash_rope_attention`, else a parent's."""
    from .ops.kernels import flash_attention as flash

    if hasattr(build._lib, "fsat_flash_rope_attention"):
        return flash.flash_rope_attention(qkv, freqs, num_heads)
    return parent_rope_attention(build._lib, qkv, freqs, num_heads)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="", help="write the results as JSON here")
    p.add_argument("--parent", default="", metavar="CHECKOUT",
                   help="also time the kernels built from this checkout's csrc/")
    p.add_argument("--check", action="store_true", help="stop after one correctness pass")
    p.add_argument("--cases", default="",
                   help="keep the cases whose name holds this (or, comma-separated, any of these)")
    p.add_argument("--variants", default="",
                   help="comma-separated: build only these variants (default: every one)")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .ops.embeddings import rotary_freqs
    from .ops.kernels import attention
    from .ops.kernels import flash_attention as flash

    if not torch.cuda.is_available():
        raise RuntimeError("pair_attention_variants needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tmp = Path(tempfile.mkdtemp())
    chosen = [v for v in args.variants.split(",") if v] or list(VARIANTS)
    names = ["shipped", *([] if args.check else chosen), *(["parent"] if args.parent else [])]
    # the cases each library runs: the shipped and the parent's all, a
    # variant those of the source it changes
    wanted = [key for key in CASE_SOURCES if any(c in key for c in args.cases.split(","))]
    runs = {name: [key for key in wanted
                   if name in ("shipped", "parent") or CASE_SOURCES[key] == case_source(name)]
            for name in names}
    parent_csrc = Path(args.parent) / build.CSRC_DIR.relative_to(build.PACKAGE_DIR.parent)
    if args.parent and "launch<32" not in (parent_csrc / K9_SOURCE).read_text():
        runs["parent"] = [key for key in runs["parent"] if key not in D32_CASES]
    names = [name for name in names if runs[name]]
    libs = {name: build_variant(name, tmp, parent_csrc if name == "parent" else build.CSRC_DIR)
            for name in names}

    torch.backends.cuda.matmul.allow_tf32 = False  # K9's plain version and SDPA in fp32
    g = torch.Generator(device="cuda").manual_seed(0)
    cases, calls, plains, sdpa, sdpa_bwd = {}, {}, {}, {}, {}
    for key, (b, t, h, kv) in PAIR_SHAPES.items():
        if key not in wanted:
            continue
        qkv = torch.randn(b, t, 3 * h * 64, generator=g, device="cuda").to(torch.bfloat16)
        f = rotary_freqs(t, 32, device="cuda")
        go = torch.randn(b, t, h * 64, generator=g, device="cuda").to(torch.bfloat16)
        if kv is not None:
            go[:, kv:] = 0
        cases[key] = (qkv, f, h, kv, go)
    if "K6" in cases:
        qkv6, f6, h6, kv6, go6 = cases["K6"]
        out6, lse6 = attention.fused_qkv_rope_attention_stats_plain(qkv6, f6, h6, kv6)
    pair_calls = {
        "K1": lambda c: attention.fused_qkv_rope_attention(*c[:4]),
        "K5": lambda c: attention.fused_qkv_rope_attention_stats(*c[:4])[0],
        "K10": lambda c: attention.fused_qkv_rope_attention_long(*c[:4]),
        "K6": lambda c: attention.fused_qkv_rope_attention_backward(
            c[0], out6, lse6, c[4], c[1], c[2], c[3], dtype=torch.float32),
    }
    pair_plains = {
        "K1": lambda c: attention.fused_qkv_rope_attention_plain(*c[:4]),
        "K5": lambda c: attention.fused_qkv_rope_attention_stats_plain(*c[:4])[0],
        "K10": lambda c: attention.fused_qkv_rope_attention_long_plain(*c[:4]),
        "K6": lambda c: attention.fused_qkv_rope_attention_backward_plain(
            qkv6, out6, lse6, go6, f6, h6, kv6, dtype=torch.float32),
    }
    for key in cases:
        calls[key] = pair_calls[key]
        plains[key] = pair_plains[key](cases[key])
    for key, (bh, t, d, kv) in BF16_SHAPES.items():
        if key not in wanted:
            continue
        q, k, v = (torch.randn(bh, t, d, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        cases[key] = (q, k, v, kv)
        calls[key] = lambda c: flash.flash_forward(*c, save_stats=False)[0]
        plains[key] = flash.flash_forward_plain(q, k, v, kv, save_stats=False)[0].float()
        valid = kv or t
        kk, vv = k[:, :valid].contiguous(), v[:, :valid].contiguous()
        sdpa[key] = (q[None], kk[None], vv[None])
    for key, (bh, t, kv, causal, d) in K9_SHAPES.items():
        if key not in wanted:
            continue
        q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda") for _ in range(4))
        if kv is not None:
            do[:, kv:] = 0  # as on the transformer's path
        out, lse = flash.flash_forward_plain(q, k, v, kv, causal=causal)
        cases[key] = (q, k, v, out, lse, do, kv, causal)
        calls[key] = lambda c: flash.flash_backward(*c[:7], causal=c[7])
        plains[key] = flash.flash_backward_plain(q, k, v, out, lse, do, kv, causal=causal)
        valid = kv or t
        q4 = q[None].clone().requires_grad_(True)
        k4, v4 = (x[None, :, :valid].clone().requires_grad_(True) for x in (k, v))
        o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        sdpa_bwd[key] = (o4, (q4, k4, v4), do[None])
    for key, (bh, t, d, kv, stats, causal) in K7_F32_SHAPES.items():
        if key not in wanted:
            continue
        q, k, v = (torch.randn(bh, t, d, generator=g, device="cuda") for _ in range(3))
        cases[key] = (q, k, v, kv, stats, causal)
        calls[key] = lambda c: flash.flash_forward(*c[:3], c[3], save_stats=c[4], causal=c[5])
        plains[key] = flash.flash_forward_plain(q, k, v, kv, save_stats=stats, causal=causal)
        if not stats:
            calls[key] = (lambda fn: lambda c: fn(c)[0])(calls[key])
            plains[key] = plains[key][0]
        valid = kv or t
        kk, vv = k[:, :valid].contiguous(), v[:, :valid].contiguous()
        sdpa[key] = (q[None], kk[None], vv[None], causal)
    for key, (b, t, h, part) in ROPE_SHAPES.items():
        if key not in wanted:
            continue
        qkv = torch.randn(b, t, 3 * h * 64, generator=g, device="cuda").to(torch.bfloat16)
        f = rotary_freqs(t, 32, device="cuda")
        _, _, cos, sin = attention._cuda_inputs("rope_pair", qkv, f, h)
        cases[key] = (qkv, cos, sin, h, part, attention.LOG2E / 8 if part == 0 else 1.0, f)
        # k through the public wrapper (its tables made per call, as chip_smoke
        # [3d] times it), q as K6 launches it (its tables made once per call
        # for both parts)
        calls[key] = (lambda c: attention.rope_pair_k(c[0], c[6], c[3])) if part else (
            lambda c: attention._rope_launch(*c[:6]))
        plains[key] = (attention.rope_pair_q_plain if part == 0 else attention.rope_pair_k_plain)(
            qkv, f, h)
    for key, (b, t, h, d, dt) in ROPE_K7_SHAPES.items():
        if key not in wanted:
            continue
        qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(getattr(torch, dt))
        f = rotary_freqs(t, d // 2, device="cuda")
        cases[key] = (qkv, f, h)
        calls[key] = lambda c: rope_call(*c)
        plains[key] = flash.flash_rope_attention_plain(qkv, f, h)
        q, k, v = attention._split_roped(qkv, f, h)
        sdpa[key] = (q[None], k[None], v[None])
    for key, (bh, t, d) in K8_SHAPES.items():
        if key not in wanted:
            continue
        q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda") for _ in range(4))
        out, lse = flash.flash_forward_plain(q, k, v)
        cases[key] = (q, k, v, out, lse, do)
        calls[key] = lambda c: flash.flash_backward_fused(*c)
        plains[key] = flash.flash_backward_fused_plain(q, k, v, out, lse, do)
        q4, k4, v4 = (x[None].clone().requires_grad_(True) for x in (q, k, v))
        o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
        sdpa_bwd[key] = (o4, (q4, k4, v4), do[None])

    def timed_ms(fn, reps=10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_ms(fn, kernel, reps=5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum((getattr(e, "self_device_time_total", 0) or 0) for e in prof.key_averages()
                   if kernel in e.key) / 1e3 / reps

    def rel_l2(out, plain):
        """rel-L2 of a kernel's output against its plain version's (the
        largest over the outputs, when there are several)."""
        if isinstance(plain, tuple):
            return max(rel_l2(a, b) for a, b in zip(out, plain))
        return ((out.float() - plain.float()).norm() / plain.float().norm()).item()

    results = {name: {} for name in names}
    rope_outs = {}  # K10a's first output per library, held bit for bit against the parent's
    for name in names if args.check else names + names[::-1]:
        build._lib = libs[name]
        for key in runs[name]:
            c, call = cases[key], calls[key]
            out = call(c)
            torch.cuda.synchronize()
            rel = rel_l2(out, plains[key])
            if key in ROPE_SHAPES:
                rope_outs.setdefault(name, {}).setdefault(key, out)
            del out
            r = results[name].setdefault(key, {"ms": [], "kernel_ms": [], "rel_l2": rel})
            if not args.check:
                r["ms"].append(timed_ms(lambda: call(c)))
                r["kernel_ms"].append(kernel_ms(lambda: call(c), KERNEL_NAMES[key]))
    build._lib = None
    shapes = {key: v for key, v in {**PAIR_SHAPES, **BF16_SHAPES, **K9_SHAPES, **K7_F32_SHAPES,
                                    **K8_SHAPES, **ROPE_SHAPES, **ROPE_K7_SHAPES}.items()
              if key in wanted}
    summary = {"card": smi, "shapes": {k: list(v) for k, v in shapes.items()}, "variants": {},
               "sdpa_ms": {}, "sdpa_backward_ms": {},
               "k10a_bit_equal_to_parent": {
                   key: torch.equal(out, rope_outs["parent"][key])
                   for key, out in rope_outs.get("shipped", {}).items()
                   if key in rope_outs.get("parent", {})}}
    if not args.check:
        for key, (q, k, v, *causal) in sdpa.items():
            summary["sdpa_ms"][key] = min(
                timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=bool(causal and causal[0])))
                for _ in range(2))
        for key, (o4, inputs, g4) in sdpa_bwd.items():
            summary["sdpa_backward_ms"][key] = min(
                timed_ms(lambda: torch.autograd.grad(o4, inputs, g4, retain_graph=True))
                for _ in range(2))
    for name in names:
        summary["variants"][name] = {
            key: {"ms": min(r["ms"], default=None), "kernel_ms": min(r["kernel_ms"], default=None),
                  "rel_l2": r["rel_l2"]}
            for key, r in results[name].items()}
        timed = lambda r: "" if r["ms"] is None else (  # noqa: E731
            f" {r['ms']:.4f} ms (kernel {r['kernel_ms']:.4f})")
        print(f"{name:13s} " + "  ".join(f"{key} rel-L2 {r['rel_l2']:.2e}{timed(r)}"
                                         for key, r in summary["variants"][name].items()),
              flush=True)
    for key, equal in summary["k10a_bit_equal_to_parent"].items():
        print(f"{key}: bit-equal to the parent's: {equal}", flush=True)
    for key, ms in summary["sdpa_ms"].items():
        print(f"SDPA          {key} {ms:.4f} ms", flush=True)
    for key, ms in summary["sdpa_backward_ms"].items():
        print(f"SDPA backward {key} {ms:.4f} ms", flush=True)
    print(f"card: {smi}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    shutil.rmtree(tmp, ignore_errors=True)
    worst = max(r["rel_l2"] for name in names for key, r in summary["variants"][name].items()
                if name not in TIMING_ONLY)
    if worst > 1e-2:
        raise AssertionError(f"a kernel disagrees with its plain version: rel-L2 {worst:.3g}")
    return summary


if __name__ == "__main__":
    main()
