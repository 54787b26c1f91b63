#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: builds the port's
CUDA kernels, holds each against its plain PyTorch version, serves
full-width qwen1.5-0.5b with a live rq8 checkpoint hot-swap, trains
full-width repro-100m with rq4 + error-feedback gradient compression,
runs the paper's algorithm tier on it (four workers stacked on the card
exchanging gradients through the partitioned rq4 ring AllReduce),
prefills full-width qwen1.5-0.5b, repro-100m and granite-8b on the
flash-attention kernel, prefills and serves full-width rwkv6-3b on the
WKV6 scan kernel, replays the virtual cluster's traces on full-width
repro-100m, and prefills and serves the hybrid and MoE families
(recurrentgemma-9b, deepseek-v2-lite-16b) and prefills qwen2.5-14b and
command-r-35b (bf16) at full width, exchanges full-width repro-100m
gradients per leaf (the per-leaf codec tier), decodes full-width
qwen1.5-0.5b and granite-8b on the unrolled tree with and without the
int8 KV cache, and prefills and decodes the embedding frontends at full
width: qwen2-vl-72b (M-RoPE on a patch grid, bf16, 32 of its 80 layers)
and seamless-m4t-large-v2 (the encoder-decoder), trains full-width
repro-100m through the launcher on several ranks (data parallelism), and
runs the paper's rq4 partitioned ring and DCD gossip with one worker a
rank (the ring's hops sent between processes).

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises and the script exits non-zero):

  1. the card's name and power limit (nvidia-smi); build the kernels;
  2. kernels: K1 minmax_bucketed, K2 encode_packed (drawing its own
     uniforms from the key, bucket b under fold_in(key, b)), K3
     decode_packed against their plain versions on the card (K2's: the
     prng draws, then the TPU kernel's function), bit for bit (payload,
     params, decoded values), at the full-width qwen1.5-0.5b geometry
     for bits 8/4/2 (the tail bucket drawing from bucket nb - 1) and on
     an unaligned multi-bucket buffer; CUDA-event timings at the rq8
     full-width shapes beside the bound (K1, K3 bytes; K2 the larger of
     bytes and its Threefry's integer instructions), K1 in turns with
     torch.aminmax on the same inputs;
  3. serve: ServeConfig(reduced=False, slots=4, 8 requests) on fp32
     weights with TF32 off; 3 ticks, publish a fresh rq8 checkpoint,
     swap, run to completion; hot == cold tokens on a probe; a flipped
     bit is rejected; every kernel launched on that path;
  4. a codec cross-check on a small input: the card's published bytes
     and CRC equal the CPU's (plain versions);
  5. train: K4 qdq_bucketed (keyed, as K2) against its plain version
     and against K3(K2(x)) under the same key on the card, bit for bit,
     at the full-width repro-100m geometry for bits 8/4/2, on the
     unaligned buffers and on a bucket holding an Inf and a NaN; its
     CUDA-event time at rq4 beside the bound (bytes or its Threefry).
     Then ~30 AdamW steps of full-width repro-100m (the
     unrolled tree, batch 8, seq 256, rq4 + error feedback) through the
     trainer's setup and step: finite, falling losses, K1 once and K4
     twice a step, K6 and K6b once a layer a step (the attention's
     flash route under autograd), comm_bytes equal to the fused
     message's wire bytes; step time, tokens/s, peak memory and a breakdown of the step; the
     trained state through save_state / load_state bit for bit; and one
     reduced step on the card against the CPU;
  6. ring: the device Threefry (K5's draws) against prng.random_bits
     and prng.uniform bit for bit over 4Mi counters from 0, across 2**24
     and up to 2**32; K5 decode_add_encode_bucketed, one call over a hop
     of 4 workers, against its keyed plain version (prng draws, then the
     TPU kernel's function), against K3 -> add -> K1 -> K2 on the same
     draws and against 4 one-worker hops through decode_add_encode_flat,
     bit for bit, at the full-width repro-100m partition geometry (N = 4)
     for bits 8/4/2, on partitions of several buckets whose last bucket is
     short, and on buckets holding Inf and NaN; an unaligned buffer takes
     the composition, as in the JAX package; a hop of 9 workers, and one
     of 300 buckets a worker, past one launch's argument block (one
     call); CUDA-event times at rq4 beside the plain version, the
     composition and the bound (bytes, or the Threefry's integer
     instructions counted in the SASS per pipe at the card's pipe rates,
     whichever is larger). Then
     parallel.run_distributed with CSGDRingExchange(rq4) over 4 workers
     stacked on the card, full-width repro-100m, plain SGD, 5 steps:
     finite loss at the mean iterate, consensus exactly 0 at every step,
     3 K5 launches a step (one call, one count, a hop), comm bytes from the geometry; step
     time, tokens/s, peak memory and a breakdown. Then a reduced ring
     exchange on the card against the CPU, bit for bit;
  7. prefill: K6 flash_attention_bhsd against its plain version on the
     card at S = 8192 (rtol = atol = 2e-5; bf16 0.05) at the attention
     geometries of qwen1.5-0.5b, granite-8b, grok-1 (softcap 30),
     recurrentgemma-9b's local attention (D = 256, window 2048), a
     non-causal tail (S = 8191) and bf16, and at deepseek-v2-lite's MLA
     (16/16 heads, q.k at D 192, v and out at DV 128, S = 16384, YaRN's
     softmax scale 0.114721), skip == full grid bit for bit;
     K6, plain and SDPA (memory-efficient kernel, a yardstick only)
     times and SDPA's error beside K6's, against the bound of K6's own
     arithmetic (3xTF32 or bf16 tensor-core products). Then
     make_prefill_step(
     use_flash=True, scan_layers=True, logits_positions="last") at full
     width and depth: qwen1.5-0.5b 1 x 32768, repro-100m 4 x 8192,
     granite-8b 1 x 8192 (fp32, TF32 off): one warm-up and 3 timed
     prefills, K6 once per layer, its share of the prefill, peak memory,
     and the last-position logits against the same prefill without
     flash. Then a reduced flash prefill on the card against the CPU;
     then K6b (flash attention's backward, after K6 with its lse)
     against its plain version on the card (rtol = atol = 1e-4) at the
     train cell's attention (8 x 16/16 x 2048 x 64, causal) and at GQA
     32/8, D 128, a second call bit for bit; its time beside its bound
     (10 * D flops a triple at the 3xTF32 rate), the plain version's and
     SDPA's memory-efficient backward (a yardstick only);
  8. rwkv: K7 wkv6_bhsk against its plain version on the card (rtol =
     atol = 1e-4, out and state) at the prefill's shape of one layer
     (B 1, H 40, S 32768, K 64), at the JAX tests' shapes and at 37
     chunks through ops.wkv6 with a state0, in rwkv6-3b's own decay
     regime and the JAX tests'; K7 and plain times beside the bound (the
     bytes, against the 3xTF32 operations K7 runs). Then
     rwkv6-3b at full width and depth (3,089,290,240 parameters, fp32,
     TF32 off): make_prefill_step(scan_layers=True,
     logits_positions="last") on 1 x 32768 tokens, a warm-up and 3
     timed prefills, K7 once a layer, its share, peak memory, finite
     logits; the prefill's last-position logits against the bulk
     prefill (the recurrent decode loop) on 1 x 320 tokens within 1e-3;
     the Engine serving 8 requests on 4 slots with 0 dropped. Then a
     reduced prefill, train step (loss and gradients, on the chunked
     scan) and decode on the card against the CPU;
  9. cluster: eight traces scheduled on the host, replayed on
     full-width repro-100m (4 workers, rq4: K1 once and K4 twice a codec
     call), the codec's share of each replay, card against CPU on
     reduced replays;
 10. families, at full width and depth with random weights from a seed
     (fp32 with TF32 off; command-r-35b bf16): recurrentgemma-9b
     (10,664,163,328 parameters) make_prefill_step(use_flash=True,
     scan_layers=True, logits_positions="last") on 1 x 8192, K6 once per
     local-attention layer (12, window 2048), logits within 1e-3 of the
     non-flash prefill and, on 1 x 320, of the bulk prefill (the decode
     loop), the Engine serving 8 requests (prompt 32, generation
     8/16/32, 4 slots, greedy); deepseek-v2-lite-16b (15,647,895,040
     parameters) prefill 1 x 4096 (one MoE group, capacity 480), K6 at
     (192, 128) once per MLA layer, peak memory, layer 0's absorbed MLA
     decode over 64 tokens within 1e-3 of its full-sequence form, 8
     served requests through the latent cache; qwen2.5-14b (fp32) and
     command-r-35b (bf16) flash prefills of 1 x 8192 on K6 against
     their non-flash prefills (1e-3; bf16 0.05), K6 alone at each geometry; then the five configs reduced
     (deepseek's MLA at the head dims K6 builds, so its prefill runs K6
     at (192, 128)), prefill and a train step's loss and gradients, card
     against CPU within 1e-5;
 11. leaf, the per-leaf codec tier: K4, K2 and K3 launched on leaf
     messages (JAX's per-leaf qdq, encode_packed and decode_packed; K4
     and K2 drawing each leaf's uniforms from its own key) against their
     plain versions, bit for bit (values, payload, params), over two
     workers' leaves at repro-100m's five leaf sizes and 1,000 elements,
     bits 8/4/2, with and without Inf/NaN, and over three leaves whose
     first and last share a key; their rq4 times at the
     25,165,824-element leaf beside the bound (bytes; K4 and K2 the
     larger of bytes and their Threefry), and at 768 elements (the
     launch floor). Then run_distributed on
     full-width repro-100m (the unrolled tree, 110 leaves), 4 stacked
     workers of 2 x 256, plain SGD, 3 steps each with
     CSGDRingExchange("rq4", flat=False), CSGDPSExchange("rq8",
     flat=False) and ECSGDExchange("rq4", flat=False): finite losses,
     consensus exactly 0 for the PS and ECSGD (the per-leaf ring is the
     monolithic chain: each worker ends with its own nesting order), the
     per-leaf launches a step as the arithmetic gives them, comm bytes
     from the geometry; step time, tokens/s, peak memory, a breakdown,
     the per-leaf ring step beside the partitioned flat ring's; a reduced
     per-leaf ring and the entry points on an Inf/NaN leaf, card against
     CPU bit for bit;
 12. kv, the unrolled decode and the int8 KV cache: full-width
     qwen1.5-0.5b (fp32 weights) bulk prefill of 4 x 64 tokens into a
     4,096-slot cache and 32 greedy steps on the bf16 cache, the int8
     cache fed the same tokens (JAX's rule: 1e-5 < max|d logits| /
     max|logits| < 0.05) and the scanned form on the same weights
     (within 1e-5); full-width granite-8b's 32,768-slot caches holding
     exactly 4,831,838,208 B of K/V (bf16) and 2,491,416,576 B (int8 +
     scales), a 64-token bulk prefill and 16 steps on each; then the
     five families reduced on the unrolled tree, card against CPU (fp32
     cache 1e-5, int8 cache 2e-3 of the logits' scale);
 13. frontends, at full width with random weights from a seed:
     qwen2-vl-72b in bf16 cut to 32 of its 80 layers (30,577,336,320
     parameters, 61.15 GB), make_prefill_step(use_flash=True,
     scan_layers=True, logits_positions="last") on 1 x 8192 stub
     embeddings with a Qwen2-VL position grid (1,024 text ids, a 64 x 96
     patch grid at t = 1,024, text from 1,120 on): K6 once a layer,
     logits within 0.05 relative L2 of the non-flash prefill; a 256-
     embedding text prompt fed a step at a time through make_serve_step
     (M-RoPE at text positions) against its prefill (0.05 relative L2),
     16 greedy token steps beside the step's bytes bound;
     seamless-m4t-large-v2 at full depth in fp32 (1,632,550,912
     parameters) prefilled on 1 x 8192 stub embeddings over 8,192
     source frames: K6 once a decoder layer and never in the encoder or
     the cross attention, within 1e-3 of the non-flash prefill; encode
     alone timed, a layer's pieces timed; 64 greedy tokens over the
     encoder memory through make_serve_step within 1e-3 of one
     full-sequence apply; then both reduced, card against CPU (prefill,
     loss and gradients 1e-5; decode on the fp32 cache 1e-5, the bf16 and
     int8 caches 2e-3 of the logits' scale);
 14. mesh, the mesh and compiler tooling: make_host_mesh() over the one
     card on a world-1 NCCL group; then, in a subprocess on the "fake"
     process-group backend, python -m repro_torch.launch.dryrun at full
     width on a subset of combos (grok-1-314b train_4k on the 16 x 16
     mesh, and a train, a prefill and a decode combo on each production
     mesh), one record a combo (per-device argument and temp bytes, dot
     FLOPs, collective bytes by kind), each record's argument bytes
     equal to the sum of the local shard sizes its specs give; then the
     one-device estimate (--mesh 1x1) of full-width repro-100m and
     qwen1.5-0.5b training on 4 x 4096 (AdamW fp32 moments, bf16
     params, remat, scan) held against the same step on the card:
     argument bytes equal to the storage placed on the card and to the
     bytes requested of the allocator (its allocated blocks at most 1 MiB
     a tensor more: 512-byte rounding, large blocks left unsplit when the
     rest of the segment is 1 MiB or less), temp within 10 %
     of the step's peak beyond what is live, dot FLOPs equal to the
     counter's around the card step, and the step's TFLOP/s;
 15. dp, the training launcher on ranks (``launch.train.setup`` and
     ``run_steps``): full-width repro-100m, 8 x 256, AdamW, rq4 + EF,
     DP_STEPS steps each. The one-card launcher (no group) in this
     process; (a) the launcher at world = the card count, its NCCL group
     made from torchrun's variables (one process a card; a world of one
     here): every step's loss and grad norm and the final state (SHA-256
     of every leaf) equal to the one-card launcher's bit for bit at world
     one; (b) two ranks sharing card 0 over a gloo group made for them
     and passed in (NCCL refuses two ranks on one card): replicas equal
     bit for bit, step 0's loss and grad norm within 1e-5 of (a)'s,
     falling losses, the all-reduce of 515,976,192 B of fp32 gradient
     and 4 B of loss (CUDA events; through the host: not a rate of
     NVLink). Every run: K1 once and K4 twice a step, comm bytes equal
     to the fused message's wire bytes, step ms, tokens/s and each
     rank's peak memory beside the card's name and power limit, and
     DP_PROFILE_STEPS more steps under torch.profiler (wall and busy ms
     a step, the card's idle share, the kernels that take most of it).
     Every run also trains reduced deepseek-v2-lite-16b (8 x 256: ONE
     MoE group of 2,048 tokens, which spans the ranks of (b) and of (a)
     on two or more cards, each rank gathering its tokens), held as
     repro-100m is and to one gather a MoE layer and step where it
     spans; and, at its full width, one MoE layer's forward and backward
     over the global batch against a rank's own rows (the extra work of
     a spanning group) and, on ranks, the gather's forward and backward;
 16. ranks, the paper's exchanges on a real worker axis: the ring cell
     (full-width repro-100m, 2 x 256 rows a worker, plain SGD, the rq4
     partitioned ring) through run_distributed(axis_name=RankAxis()),
     one worker a rank (``chip_smoke.py --ranks-rank OUT`` children):
     NCCL at world = the card count where there are two cards or more,
     and RING_WORKERS gloo ranks sharing card 0 always (their messages
     copied through the host). RANKS_STEPS steps: every rank's final
     params, losses and step-0 update equal bit for bit, consensus 0,
     step 0 equal to the stacked ring's (one step of RING_WORKERS stacked
     workers in this process) at RING_WORKERS ranks; a rank's launches a
     step as the geometry gives them (K1 once, K2 once or twice, K5 N-1
     times, K3 twice a partition) and the bytes it sent equal to
     message_bytes (96,746,880 at N = 4); step ms (its batch drawn to its
     exchange's end), exchange ms, a hop's wire, K5 and both (CUDA
     events) and its message bytes, a breakdown of the step; then
     RANKS_DCD_STEPS steps of DCD rq4 gossip on the ring, each rank's
     replicas equal to their sources' public copies bit for bit, launches
     and bytes from the geometry. A failed rank fails the run.

Kernel times are medians of samples that each time a run of
back-to-back calls (about SAMPLE_MS of work) between CUDA events.

The last stdout line is {"ok": true, "device": {...}}; the line before
it holds the card's name and power limit, and the one before that the
JSON summary of the kernels.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SMS = 132                          # H100 SXM streaming multiprocessors
# The SASS opcodes of 32-bit integer instructions (the device Threefry's
# count) by the pipe that runs them on Hopper: the integer ALU pipe, and
# the FMA pipe, which runs the integer multiply-adds the compiler also
# uses for adds and moves. Each pipe has 64 lanes an SM a clock, and an
# SM dispatches 128 instructions a clock (4 schedulers x one warp).
INT32_ALU_OPCODES = frozenset({"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL",
                               "SHR", "LEA", "PRMT", "IABS", "IMNMX",
                               "ISETP", "SEL"})
INT32_FMA_OPCODES = frozenset({"IMAD", "IMUL"})
PIPE_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
REPS = 20
# work in one timing sample: a kernel shorter than this is launched back
# to back within the sample
SAMPLE_MS = 5.0
FULL_ARCH = "qwen1.5-0.5b"
# JAX's flat_geometry on jax.eval_shape(transformer_scan.init) at full
# width: the port's tree must give the same wire geometry
FULL_TOTAL = 463_987_712
FULL_BUCKETS = 111
FULL_TAIL = 2_614_272

TRAIN_ARCH = "repro-100m"
# JAX's flat_geometry on both of its repro-100m parameter trees at full
# width (the same at bits 8, 4 and 2)
TRAIN_TOTAL = 128_994_048
TRAIN_BUCKETS = 31
TRAIN_TAIL = 3_164_928
TRAIN_STEPS = 30

# the ring phase: 4 workers stacked on the card, each with batch 2 x seq
# 256 (the 8 x 256 tokens of the train phase), plain SGD
RING_WORKERS = 4
RING_STEPS = 5
RING_BATCH = 2
RING_SEQ = 256
RING_LR = 0.1
RING_SEED = 0
# partitioned rq4 ring at N = 4: 6 messages of 31,493 payload rows x 512
# + 8 params rows x 8 B, one partition (32,248,832 elements) each
RING_PART_ELEMS = 32_248_832
RING_PART_BUCKETS = 8
RING_MSG_BYTES = 16_124_480
RING_COMM_BYTES = 96_746_880

# the prefill phase: make_prefill_step(use_flash=True, scan_layers=True,
# logits_positions="last") at full width and depth, fp32; (arch, input
# shape it is cut from, batch, seq, K6 launches per prefill = layers)
PREFILL_RUNS = (("qwen1.5-0.5b", "prefill_32k", 1, 32_768, 24),
                ("repro-100m", None, 4, 8_192, 12),
                ("granite-8b", None, 1, 8_192, 36))
PREFILL_REPS = 3
FP32_FLOPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 on the tensor cores
# K6 computes an fp32 product as three TF32 products (3xTF32)
FLASH_FP32_PRODUCTS = 3
# deepseek-v2-lite's MLA softmax scale: (128 + 64)^-0.5 times YaRN's
# mscale(40, 0.707)^2 (held to the configuration's in flash_geometries)
MLA_SCALE = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
# K6 against its plain version at full length (B = 1, unit normals):
# (name, Hq, Hkv, D, DV, S, causal, window, softcap, scale, dtype,
# tolerance); DV is v's and the output's head dim, scale None 1/sqrt(D)
FLASH_GEOMETRIES = (
    ("qwen1.5-0.5b", 16, 16, 64, 64, 8192, True, 0, 0.0, None, "float32",
     2e-5),
    ("granite-8b", 32, 8, 128, 128, 8192, True, 0, 0.0, None, "float32",
     2e-5),
    ("grok-1 (softcap 30)", 48, 8, 128, 128, 8192, True, 0, 30.0, None,
     "float32", 2e-5),
    ("recurrentgemma-9b local (window 2048)", 16, 1, 256, 256, 8192, True,
     2048, 0.0, None, "float32", 2e-5),
    ("tail S=8191, non-causal", 16, 16, 64, 64, 8191, False, 0, 0.0, None,
     "float32", 2e-5),
    ("qwen1.5-0.5b bf16", 16, 16, 64, 64, 8192, True, 0, 0.0, None,
     "bfloat16", 0.05),
    ("deepseek-v2-lite MLA (YaRN scale)", 16, 16, 192, 128, 16384, True, 0,
     0.0, MLA_SCALE, "float32", 2e-5),
)
# the row of FLASH_GEOMETRIES the kernels line reports as K6 at MLA's
# head dims (flash_fwd<float, 192, false, 128>)
MLA_GEOMETRY = "deepseek-v2-lite MLA (YaRN scale)"
# flash prefill logits against the same prefill without flash (the
# chunked exact path at S >= 4096): both are fp32, but they sum the
# attention in another order (online softmax over 64-key tiles against
# an exact softmax over all keys) and the difference passes through
# 12-36 full-width layers; a wrong attention moves random-weight logits
# by O(0.1)
PREFILL_TOL = 1e-3
# a reduced prefill on the card against the CPU: the model tests' 1e-5
REDUCED_TOL = 1e-5
# bf16: K6 against its plain version (bf16 rounds to 2**-8 relative)
BF16_TOL = 0.05
# K6b (flash attention's backward) against its plain version on the card:
# (name, B, Hq, Hkv, D, S), causal fp32; the train cell's attention first
FLASH_BACKWARD_GEOMETRIES = (
    ("qwen1.5-0.5b train 8 x 2048", 8, 16, 16, 64, 2048),
    ("granite-8b GQA 32/8 2 x 2048", 2, 32, 8, 128, 2048),
)
# gradients of unit normals reach ~10 and sum 2,048 terms: 3xTF32 and
# other summation orders put K6b ~1e-5 from the plain backward
K6B_TOL = 1e-4
FP32_3XTF32_FLOPS_PER_S = TF32_FLOPS_PER_S / FLASH_FP32_PRODUCTS
# a bf16 model's flash prefill logits against its non-flash prefill, by
# relative L2 (|flash - ref| / |ref|): at full width bf16 rounding
# carried through 40 layers sets correct paths 0.17-0.19 apart in max
# abs and 0.022 in relative L2 (K6, K6's plain version and the
# non-flash path, pairwise), while a wrong attention (every layer cut
# to 4,096 keys) moves them 4.06 and 0.457 (tools/bf16_prefill_probe.py
# on command-r-35b), so an allclose at 0.05 fails correct paths and this
# holds them
BF16_PREFILL_TOL = 0.05

# the rwkv phase: rwkv6-3b at full width and depth (JAX's
# jax.eval_shape(transformer_scan.init): 3,089,290,240 parameters in 24
# leaves), fp32, TF32 off
RWKV_ARCH = "rwkv6-3b"
RWKV_PARAMS = 3_089_290_240
RWKV_LEAVES = 24
RWKV_LAYERS = 32
RWKV_PREFILL = ("prefill_32k", 1, 32_768)
# K7 against its plain version: the JAX package's kernel-vs-recurrence
# tolerance
WKV_TOL = 1e-4
# (B, H, S, K): the prefill's shape of one layer, then the JAX tests'
# shapes (through ops.wkv6 with a state0; S = 100 is padded) and 37
# chunks (two full groups of K7's two-level scan and a short one)
WKV_PREFILL_SHAPE = (1, 40, 32_768, 64)
WKV_TEST_SHAPES = ((2, 2, 128, 64), (1, 4, 100, 32), (2, 1, 192, 64),
                   (1, 4, 2368, 64))
WKV_CHUNK = 64
# K7 computes each product as three TF32 products (3xTF32)
WKV_FP32_PRODUCTS = 3
# the prefill's last-position logits (K7's chunked scan; recurrentgemma's
# doubling scan and K6) against the serving path's bulk prefill (the
# token-by-token recurrence) at full width on 1 x 320 tokens (five
# chunks and a padded tail). Both are fp32: they differ by the order of
# the sums (the chunked form against the recurrence, batched GEMMs
# against per-token products), rounding of ~1e-7 relative per operation
# carried through 32-38 layers of the residual stream, ~1e-5 to 1e-4 on
# random-weight logits of magnitude O(1-30); a dropped chunk, a wrong
# state carry or a wrong decay moves them by O(0.1) or more
DECODE_CHECK_LEN = 320
DECODE_LOGITS_TOL = 1e-3
# the 1 x 32,768 prefill's peak device memory with K7's earlier design
# (one block per (b, h), no scratch), as this script measured it
RWKV_ONE_BLOCK_PEAK = 17_462_810_624

# the cluster phase: the virtual-cluster tier's scheduler on the host,
# its replays on the card at full width (repro-100m, 4 workers of batch
# 2 x seq 256, the ring phase's), rq4, plain SGD; the message is the
# full-width fp32 gradient
CLUSTER_WORKERS = 4
CLUSTER_SIZE_MB = TRAIN_TOTAL * 4 / 1e6
CLUSTER_LR = 0.1
CLUSTER_ROUNDS = 3
# card against CPU on the same traces: a reduced LM or the quadratic on
# the fp32 or rq4 wire (a gradient that differs from the CPU's by ~1e-6
# relative flips a few of the LM's ~560k stochastic roundings, each by
# one level, so the LM on the rq4 wire is held at 1e-3)
CLUSTER_TOL = 1e-5
CLUSTER_LM_RQ4_TOL = 1e-3

# the families phase: the hybrid and MoE families at full width and
# depth, fp32 with TF32 off but command-r-35b in bf16; parameter counts
# are JAX's param_count()
FAMILY_ARCHS = ("recurrentgemma-9b", "deepseek-v2-lite-16b", "qwen2.5-14b",
                "command-r-35b", "grok-1-314b")
FAMILY_PARAMS = {"recurrentgemma-9b": 10_664_163_328,
                 "deepseek-v2-lite-16b": 15_647_895_040,
                 "qwen2.5-14b": 14_770_033_664,
                 "command-r-35b": 30_283_546_624}
FAMILY_SEQ = 8192
RG_LOCAL_LAYERS = 12
DEEPSEEK_SEQ = 4096
DEEPSEEK_CAPACITY = 480
FAMILY_GEN = (8, 16, 32)
# one MLA layer's absorbed decode against its full-sequence form, within
# DECODE_LOGITS_TOL
MLA_CHECK_LEN = 64

# leaf phase: the per-leaf codec tier. repro-100m's five distinct leaf
# sizes (norm scales; the attention's k/v; its q/o; the MLP's; the
# embedding, vocab x d), checked at bits 8/4/2 with an odd size and an
# Inf/NaN leaf; 4 stacked workers of the full-width unrolled tree (110
# leaves) exchange per leaf for LEAF_STEPS steps of plain SGD
LEAF_SIZES = (768, 196_608, 589_824, 2_359_296, 25_165_824)
LEAF_ODD = 1000
LEAF_LEAVES = 110
LEAF_STEPS = 3
LEAF_RUNS = (("csgd_ring", "rq4"), ("csgd_ps", "rq8"), ("ecsgd", "rq4"))
# bytes a leaf element moves at rq4 (each input read once, each output
# written once): qdq x in and out fp32; encode x in, half a byte out;
# decode half a byte in, fp32 out
LEAF_BYTES_PER_ELEM = {"leaf_qdq": 8.0, "leaf_encode_packed": 4.5,
                       "leaf_decode_packed": 4.5}
# kv phase: the unrolled decode with and without the int8 KV cache
KV_ARCH = "qwen1.5-0.5b"
KV_BATCH, KV_PROMPT, KV_SLOTS, KV_GEN = 4, 64, 4096, 32
KV_UNROLL_TOL = 1e-5          # unrolled against scanned, bf16 cache
KV_INT8_REL = 0.05            # int8 against bf16 cache: JAX's own rule,
KV_INT8_FLOOR = 1e-5          # tests/test_models.py (and not identical)
GRANITE_ARCH = "granite-8b"
GRANITE_SLOTS, GRANITE_PROMPT, GRANITE_GEN = 32_768, 64, 16
# K/V (+ scale) bytes of granite-8b's 36 layers x 8 kv heads x D 128 at
# 32,768 slots: bf16 2 x 128 x 2 B a head-slot, int8 2 x (128 + 4) B
GRANITE_KV_BYTES = {False: 4_831_838_208, True: 2_491_416_576}
KV_REDUCED_ARCHS = ("qwen1.5-0.5b", "rwkv6-3b", "recurrentgemma-9b",
                    "deepseek-v2-lite-16b", "grok-1-314b")
KV_REDUCED_INT8_REL = 2e-3    # card vs CPU on the int8 cache (a code at a
                              # rounding half may flip by one)
# frontends phase: M-RoPE on the patch-stub frontend (qwen2-vl-72b, bf16,
# at 32 of its 80 layers: 61.15 GB of weights, where 80 would be 145 GB)
# and the encoder-decoder (seamless-m4t-large-v2, fp32, full depth).
# Parameter counts are JAX's count of the same configs
VL_ARCH = "qwen2-vl-72b"
VL_FULL_LAYERS, VL_LAYERS = 80, 32
VL_PARAMS = 30_577_336_320
VL_SEQ = 8192
# the prefill's Qwen2-VL-style ids: VL_TEXT text positions (t = h = w),
# a rows x cols patch grid at one temporal id, then text after the grid
VL_TEXT, VL_GRID = 1024, (64, 96)
VL_DECODE_LEN = 256           # a text prompt fed one embedding a step
VL_GEN = 16
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_PARAMS = 1_632_550_912
ENCDEC_SEQ = 8192             # decoder tokens and source frames alike
ENCDEC_GEN = 64
# the reduced configs card vs CPU: prefill 2 x 300 on a grid of 40 text
# ids, 10 x 20 patches and 60 text ids; 200 source frames
FRONTEND_REDUCED = ((40, (10, 20)), 300, 200)

QUANT_TPU = "src/repro/kernels/quant/kernel.py"
QUANT_SOURCE = "src/repro_torch/csrc/quant.cu"
# name -> (the TPU kernel it replaces (its bucketed form), source, bound;
# None: the larger term of this run's bound)
KERNELS = {
    "minmax_bucketed": (f"{QUANT_TPU}:246", QUANT_SOURCE, "bytes"),
    "encode_packed": (f"{QUANT_TPU}:203", QUANT_SOURCE, None),
    "decode_packed": (f"{QUANT_TPU}:394", QUANT_SOURCE, "bytes"),
    "qdq_bucketed": (f"{QUANT_TPU}:187", QUANT_SOURCE, None),
    "decode_add_encode_bucketed": (f"{QUANT_TPU}:349", QUANT_SOURCE, None),
    "flash_attention_bhsd": ("src/repro/kernels/flash_attn/kernel.py:143",
                             "src/repro_torch/csrc/flash_attn.cu",
                             "operations"),
    "wkv6_bhsk": ("src/repro/kernels/wkv6/kernel.py:77",
                  "src/repro_torch/csrc/wkv6.cu", None),
    # the per-leaf Pallas calls: K4, K2, K3 launched on leaf messages
    "leaf_qdq": (f"{QUANT_TPU}:77", QUANT_SOURCE, None),
    "leaf_encode_packed": (f"{QUANT_TPU}:96", QUANT_SOURCE, None),
    "leaf_decode_packed": (f"{QUANT_TPU}:117", QUANT_SOURCE, "bytes"),
}
SERVE_KERNELS = ("minmax_bucketed", "encode_packed", "decode_packed")
TRAIN_KERNELS = ("minmax_bucketed", "qdq_bucketed")
RING_KERNELS = ("decode_add_encode_bucketed",)
PREFILL_KERNELS = ("flash_attention_bhsd",)
RWKV_KERNELS = ("wkv6_bhsk",)
CLUSTER_KERNELS = ("minmax_bucketed", "qdq_bucketed")
LEAF_KERNELS = ("leaf_qdq", "leaf_encode_packed", "leaf_decode_packed")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def same_bits(a, b) -> bool:
    """Equal bits where not NaN, and NaN at the same places (a NaN's
    payload is not part of the result)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and bits_equal(a[~nan], b[~nan])


def max_abs(a, b) -> float:
    if not a.numel():
        return 0.0
    fin = a.isfinite() & b.isfinite()
    return float((a[fin].double() - b[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0


def time_ms(fn, reps: int = REPS) -> float:
    """Median time of one call over ``reps`` samples (after a warm-up
    call). Each sample times a run of back-to-back calls, about
    SAMPLE_MS of work, between two CUDA events, so a wrapper's host-side
    launch overhead hides behind the queue as it does on a busy path;
    the call count is set from one timed call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = max(1, min(64, int(SAMPLE_MS / max(start.elapsed_time(end), 1e-3))
                   + 1))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------


def check_kernels(padded, total: int, key, *, bits: int, bucket_elems: int,
                  timed: bool = False) -> dict:
    """K1/K2/K3 against their plain versions on the same card tensors
    (K2 drawing under ``key``, its plain version with prng); returns
    max_abs_err per kernel (and timings when ``timed``)."""
    import torch
    from repro_torch.kernels.quant import kernel, ops, ref

    x4, x3, params, (nb, rows_b, rt) = ops._bucket_views(
        padded, total, bits=bits, bucket_elems=bucket_elems)
    cap = padded.numel() // nb
    x2 = padded.view(nb, cap)
    xr = x2.view(nb, cap // ops.LANES, ops.LANES)
    pack = 8 // bits
    res = {}

    # K1
    mm = kernel.minmax_bucketed(xr)
    lo, hi = ref.minmax_bucketed(x2)
    want = torch.stack([lo, hi], dim=1)
    if not bits_equal(mm, want):
        raise AssertionError(f"K1 minmax_bucketed != plain (bits={bits})")
    res["minmax_bucketed"] = {"max_abs_err": max_abs(mm, want)}

    # K2 over the head buckets and the tail, as encode_flat launches it
    def k2():
        outs = []
        if nb > 1:
            outs.append(kernel.encode_packed(x4, key, params[:nb - 1],
                                             bits=bits))
        outs.append(kernel.encode_packed(x3, key, params[nb - 1:],
                                         bits=bits, first_bucket=nb - 1))
        return outs

    def k2_plain():
        outs = []
        if nb > 1:
            outs.append(ref.encode_packed_keyed(
                x4, ref.fold_keys(key, 0, nb - 1), params[:nb - 1, 0],
                params[:nb - 1, 1], bits=bits))
        outs.append(ref.encode_packed_keyed(
            x3, ref.fold_keys(key, nb - 1, 1), params[nb - 1:, 0],
            params[nb - 1:, 1], bits=bits))
        return outs

    got, want = k2(), k2_plain()
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"K2 encode_packed != plain (bits={bits})")
    res["encode_packed"] = {"max_abs_err": max(max_abs(g, w) for g, w in
                                               zip(got, want))}
    payloads = got

    # K3 on those payloads
    def k3():
        outs = []
        if nb > 1:
            outs.append(kernel.decode_packed(payloads[0], params[:nb - 1],
                                             bits=bits))
        outs.append(kernel.decode_packed(payloads[-1], params[nb - 1:],
                                         bits=bits))
        return outs

    def k3_plain():
        outs = []
        if nb > 1:
            outs.append(ref.decode_packed_bucketed(
                payloads[0], params[:nb - 1, 0], params[:nb - 1, 1],
                bits=bits))
        outs.append(ref.decode_packed_bucketed(
            payloads[-1], params[nb - 1:, 0], params[nb - 1:, 1], bits=bits))
        return outs

    got, want = k3(), k3_plain()
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"K3 decode_packed != plain (bits={bits})")
    res["decode_packed"] = {"max_abs_err": max(max_abs(g, w) for g, w in
                                               zip(got, want))}
    # the quantizer's own bound: every decoded value within one step
    # (its bucket's scale) of the input
    dec = torch.cat([g.reshape(-1) for g in got])
    src = torch.cat(([x4.reshape(-1)] if nb > 1 else [])
                    + [x3.reshape(-1)])
    step = torch.cat(([params[:nb - 1, 1].repeat_interleave(cap)]
                      if nb > 1 else [])
                     + [params[nb - 1:, 1].expand(x3.numel())])
    if not bool(((dec - src).abs() <= step * 1.0001).all()):
        raise AssertionError(f"decoded values off by more than one step "
                             f"(bits={bits})")
    del got, want, dec, src, step

    if timed:
        elems = x3.numel() + (x4.numel() if nb > 1 else 0)
        # K1 against torch.aminmax in turns (K1, aminmax, aminmax, K1)
        k1 = [time_ms(lambda: kernel.minmax_bucketed(xr))]
        lib = [time_ms(lambda: torch.aminmax(x2, dim=1)) for _ in range(2)]
        k1.append(time_ms(lambda: kernel.minmax_bucketed(xr)))
        res["minmax_bucketed"].update(
            ms=sum(k1) / 2, turns_ms=k1,
            plain_ms=time_ms(lambda: ref.minmax_bucketed(x2)),
            library_ms=sum(lib) / 2, library_turns_ms=lib,
            bound_ms=(x2.numel() * 4 + nb * 8) / HBM_BYTES_PER_S * 1e3)
        log(f"[kernels] K1 {sum(k1) / 2:.4f} ms ({k1[0]:.4f}, {k1[1]:.4f}) "
            f"vs torch.aminmax {sum(lib) / 2:.4f} ms ({lib[0]:.4f}, "
            f"{lib[1]:.4f}) on the same inputs: K1 <= aminmax: "
            f"{sum(k1) <= sum(lib)}")
        res["encode_packed"].update(
            ms=time_ms(k2), plain_ms=time_ms(k2_plain, reps=3),
            library_ms=None,
            **threefry_bound(elems, elems * 4 + elems // pack + nb * 8))
        res["decode_packed"].update(
            ms=time_ms(k3), plain_ms=time_ms(k3_plain), library_ms=None,
            bound_ms=(elems // pack + elems * 4 + nb * 8)
            / HBM_BYTES_PER_S * 1e3)
    return res


def kernels_phase(torch) -> dict:
    from repro_torch import configs
    from repro_torch.core import compression, prng
    from repro_torch.kernels.quant import ops
    from repro_torch.models import transformer_scan

    mc = configs.get_config(FULL_ARCH)
    params = transformer_scan.init(mc, transformer_scan.generator(1, "cuda"))
    layout = compression.FlatLayout.from_tree(params)
    _, cap, nb, _, _ = ops.flat_geometry(layout.total, bits=8)
    tail = layout.total - (nb - 1) * cap
    log(f"[kernels] full-width {FULL_ARCH}: {layout.total} elements, "
        f"{nb} buckets of {cap}, tail {tail}")
    if (layout.total, nb, tail) != (FULL_TOTAL, FULL_BUCKETS, FULL_TAIL):
        raise AssertionError("port parameter tree does not give the JAX "
                             "package's full-width wire geometry")

    errs: dict = {}
    timing: dict = {}

    def merge(res):
        for name, r in res.items():
            errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])

    for bits in (8, 4, 2):
        _, cap, nb, _, _ = ops.flat_geometry(layout.total, bits=bits)
        padded = layout.flatten(params, padded_len=nb * cap)
        res = check_kernels(padded, layout.total, prng.PRNGKey(bits),
                            bits=bits, bucket_elems=ops.DEFAULT_BUCKET_ELEMS,
                            timed=(bits == 8))
        merge(res)
        if bits == 8:
            timing = res
        del padded
        torch.cuda.empty_cache()
        log(f"[kernels] full width bits={bits}: K1 K2 K3 bit-identical to "
            "plain")

    g = torch.Generator(device="cuda").manual_seed(3)
    for total, be in ((3 * (1 << 22) + 12_345, ops.DEFAULT_BUCKET_ELEMS),
                      (300_001, 4096)):
        flat = torch.randn(total, generator=g, device="cuda") * 0.05
        for bits in (8, 4, 2):
            _, cap, nb, _, _ = ops.flat_geometry(total, bits=bits,
                                                 bucket_elems=be)
            merge(check_kernels(ops.edge_pad(flat, nb * cap), total,
                                prng.PRNGKey(total + bits), bits=bits,
                                bucket_elems=be))
        log(f"[kernels] unaligned total={total} bucket_elems={be}: "
            "bits 8/4/2 bit-identical to plain")
    del params
    torch.cuda.empty_cache()
    for name in SERVE_KERNELS:
        timing[name]["max_abs_err"] = errs[name]
    return timing


# ---------------------------------------------------------------------------
# serve phase (the main path)
# ---------------------------------------------------------------------------


def serve_phase(torch) -> dict:
    from repro_torch import serve
    from repro_torch.core import compression
    from repro_torch.kernels.quant import kernel
    from repro_torch.models import transformer_scan

    cfg = serve.ServeConfig(arch=FULL_ARCH, reduced=False, slots=4,
                            n_requests=8, prompt_len=32,
                            mixed_gen=(8, 16, 32), max_len=65,
                            temperature=0)
    eng = serve.Engine(cfg)
    channel = serve.CheckpointChannel()
    eng.subscribe(channel)
    reqs = serve.synthetic_requests(cfg)
    eng.warmup([cfg.prompt_len])
    trained = transformer_scan.init(eng.model_cfg,
                                    transformer_scan.generator(7, "cuda"))
    torch.cuda.synchronize()

    kernel.reset_launches()
    eng._t0 = time.monotonic()
    for r in reqs:
        eng.submit(r.tokens, r.max_new_tokens, rid=r.rid)
    for _ in range(3):
        eng.step()
    t0 = time.perf_counter()
    pub = channel.publish(trained, step=1, codec="rq8")
    torch.cuda.synchronize()
    publish_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    swapped = eng.maybe_swap()
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    torch.cuda.synchronize()
    launches = kernel.launch_counts()
    stats = eng.stats()

    c = eng.counters
    log(f"[serve] completed={c['completed']} dropped={c['dropped']} "
        f"swaps={c['swaps']} launches={launches}")
    if not swapped or (c["completed"], c["dropped"], c["swaps"]) != (8, 0, 1):
        raise AssertionError(f"serve run: {c}")
    for name in SERVE_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "serve path")
    for comp in eng.completions.values():
        if len(comp.tokens) != reqs[comp.rid].max_new_tokens or not all(
                0 <= t < eng.model_cfg.vocab for t in comp.tokens):
            raise AssertionError(f"request {comp.rid}: bad stream")

    # hot == cold: a probe on the swapped engine against a cold engine
    # started from the same published checkpoint
    probe = reqs[0].tokens[::-1].copy()
    rid = eng.submit(probe, 8)
    eng.run()
    cold = serve.Engine(cfg, params=serve.CheckpointChannel.decode(pub))
    cid = cold.submit(probe, 8)
    cold.run()
    if eng.result(rid).tokens != cold.result(cid).tokens:
        raise AssertionError("hot-swapped engine != cold start")
    log(f"[serve] probe hot == cold: {eng.result(rid).tokens}")
    del cold

    # a flipped bit must be rejected with the params untouched
    before = eng.params
    channel.publish_packed(compression.flip_bit(pub.packed, 77), pub.crc,
                           step=2)
    if eng.maybe_swap() or eng.params is not before or \
            eng.counters["swaps_rejected"] != 1:
        raise AssertionError("corrupt checkpoint was not rejected")
    log("[serve] flipped-bit checkpoint rejected, params unchanged")

    out = {"tokens_per_s": stats["tokens_per_s"],
           "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
           "decode_steps": stats["decode_steps"],
           "generated_tokens": stats["generated_tokens"],
           "wall_s": stats["wall_s"], "publish_ms": publish_ms,
           "swap_ms": swap_ms, "wire_mb": pub.wire_bytes / 1e6,
           "launches": launches}
    log("[serve] " + json.dumps(out))
    log("[serve] breakdown " + json.dumps(breakdown(torch, eng, pub)))
    return out


def host_ms(torch, fn, reps: int = 5) -> float:
    """Mean host-clock time of ``fn`` over ``reps`` runs, synchronized
    (after a warm-up run)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def breakdown(torch, eng, pub) -> dict:
    """Where the serve path's time goes, piece by piece at full width:
    one decode step over the 4 slots, one 32-token bulk prefill, the
    encode of the checkpoint a publish makes (flatten, K1, K2 drawing
    its 111 buckets' uniforms), the host CRC over it, and the decode of
    it (K3)."""
    from repro_torch.core import compression, prng
    from repro_torch.serve import engine as engine_mod

    state = engine_mod._clone(eng._state)
    toks = torch.zeros((1, eng.cfg.prompt_len), dtype=torch.long,
                       device="cuda")
    codec = compression.codec(pub.codec)
    return {
        "decode_step_ms": host_ms(torch, lambda: eng._serve_step(
            eng.params, state, {"tokens": eng._tokens})),
        "prefill_32_ms": host_ms(torch, lambda: eng._prefill(
            toks, prng.PRNGKey(0)), reps=2),
        "tree_encode_ms": host_ms(torch, lambda: codec.tree_encode_flat(
            eng.params, prng.PRNGKey(0)), reps=3),
        "crc_ms": host_ms(torch, lambda: compression.wire_crc32(pub.packed),
                          reps=2),
        "tree_decode_ms": host_ms(torch, lambda: codec.tree_decode_flat(
            pub.packed), reps=3),
    }


def cross_device_check(torch) -> None:
    """The same small checkpoint published on the card and on the CPU
    (plain versions): equal payload, params and CRC."""
    from repro_torch import configs, serve
    from repro_torch.core import pytree
    from repro_torch.models import transformer_scan

    mc = configs.get_config(FULL_ARCH).reduced()
    params = transformer_scan.init(mc, transformer_scan.generator(5))
    gpu = serve.CheckpointChannel().publish(
        pytree.tree_map(lambda a: a.cuda(), params), step=3)
    cpu = serve.CheckpointChannel().publish(params, step=3)
    if gpu.crc != cpu.crc or not bits_equal(gpu.packed.payload.cpu(),
                                            cpu.packed.payload) \
            or not bits_equal(gpu.packed.params.cpu(), cpu.packed.params):
        raise AssertionError("card and CPU publish different bytes")
    dec_g = serve.CheckpointChannel.decode(gpu)
    dec_c = serve.CheckpointChannel.decode(cpu)
    for a, b in zip(pytree.tree_leaves(dec_g), pytree.tree_leaves(dec_c)):
        if not bits_equal(a.cpu(), b):
            raise AssertionError("card and CPU decode differently")
    log(f"[check] reduced {FULL_ARCH} checkpoint: card == CPU bytes, CRC "
        f"0x{gpu.crc:08x}, decode")


# ---------------------------------------------------------------------------
# train phase (the second main path)
# ---------------------------------------------------------------------------


def check_qdq(padded, total: int, key, *, bits: int, bucket_elems: int,
              timed: bool = False) -> dict:
    """K4 (head buckets + tail, as qdq_flat launches it, drawing under
    ``key``) against its plain version and against K3(K2(x)) under the
    same key on the same card tensors."""
    import torch
    from repro_torch.kernels.quant import kernel, ops, ref

    x4, x3, params, (nb, _, _) = ops._bucket_views(
        padded, total, bits=bits, bucket_elems=bucket_elems)
    # (x, params, first bucket)
    parts = ([(x4, params[:nb - 1], 0)] if nb > 1 else []) \
        + [(x3, params[nb - 1:], nb - 1)]

    def k4():
        return [kernel.qdq_bucketed(x, key, p, bits=bits, first_bucket=f)
                for x, p, f in parts]

    def k4_plain():
        return [ref.qdq_keyed(x, ref.fold_keys(key, f, x.shape[0]), p[:, 0],
                              p[:, 1], bits=bits) for x, p, f in parts]

    got, want = k4(), k4_plain()
    if not all(same_bits(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"K4 qdq_bucketed != plain (bits={bits}, "
                             f"total={total})")
    res = {"max_abs_err": max(max_abs(g, w) for g, w in zip(got, want))}
    finite = bool(torch.isfinite(params).all())
    if finite:
        via = [kernel.decode_packed(kernel.encode_packed(
            x, key, p, bits=bits, first_bucket=f), p, bits=bits)
            for x, p, f in parts]
        if not all(bits_equal(g, v) for g, v in zip(got, via)):
            raise AssertionError(f"K4 != K3(K2(x)) (bits={bits}, "
                                 f"total={total})")
        del via
    del got, want
    if timed:
        elems = sum(x.numel() for x, _, _ in parts)
        res.update(ms=time_ms(k4), plain_ms=time_ms(k4_plain, reps=3),
                   library_ms=None,
                   **threefry_bound(elems, elems * 8 + nb * 8))
    return res


def qdq_phase(torch, params) -> dict:
    """K4 at the full-width repro-100m geometry (bits 8/4/2, timed at
    rq4), on the two unaligned buffers, and on a non-finite bucket."""
    from repro_torch.core import compression, prng
    from repro_torch.kernels.quant import ops

    layout = compression.FlatLayout.from_tree(params)
    err, timing = 0.0, {}
    for bits in (8, 4, 2):
        _, cap, nb, _, _ = ops.flat_geometry(layout.total, bits=bits)
        tail = layout.total - (nb - 1) * cap
        if (layout.total, nb, tail) != (TRAIN_TOTAL, TRAIN_BUCKETS,
                                        TRAIN_TAIL):
            raise AssertionError(
                f"port {TRAIN_ARCH} tree: {layout.total} elements, {nb} "
                f"buckets, tail {tail} at bits={bits}; the JAX package "
                f"gives {TRAIN_TOTAL}, {TRAIN_BUCKETS}, {TRAIN_TAIL}")
        padded = layout.flatten(params, padded_len=nb * cap)
        res = check_qdq(padded, layout.total, prng.PRNGKey(10 + bits),
                        bits=bits, bucket_elems=ops.DEFAULT_BUCKET_ELEMS,
                        timed=(bits == 4))
        err = max(err, res["max_abs_err"])
        if bits == 4:
            timing = res
        del padded
        torch.cuda.empty_cache()
        log(f"[train] K4 full width bits={bits} ({layout.total} elements, "
            f"{nb} buckets, tail {tail}): == plain, == K3(K2(x))")
    g = torch.Generator(device="cuda").manual_seed(4)
    for total, be in ((3 * (1 << 22) + 12_345, ops.DEFAULT_BUCKET_ELEMS),
                      (300_001, 4096)):
        flat = torch.randn(total, generator=g, device="cuda") * 0.05
        for bits in (8, 4, 2):
            _, cap, nb, _, _ = ops.flat_geometry(total, bits=bits,
                                                 bucket_elems=be)
            err = max(err, check_qdq(ops.edge_pad(flat, nb * cap), total,
                                     prng.PRNGKey(total - bits), bits=bits,
                                     bucket_elems=be)["max_abs_err"])
        log(f"[train] K4 unaligned total={total} bucket_elems={be}: bits "
            "8/4/2 == plain, == K3(K2(x))")
    flat = torch.randn(3 * 4096, generator=g, device="cuda")
    flat[4096 + 7] = float("inf")
    flat[4096 + 9] = float("nan")
    flat[2 * 4096 + 3] = -float("inf")
    res = check_qdq(flat, flat.numel(), prng.PRNGKey(1), bits=4,
                    bucket_elems=4096)
    out = ops.qdq_flat(flat, prng.PRNGKey(1), bits=4, bucket_elems=4096)
    bad = ~torch.isfinite(out.view(3, 4096)).all(dim=1)
    if bad.tolist() != [False, True, True]:
        raise AssertionError(f"non-finite buckets {bad.tolist()}")
    log(f"[train] K4 buckets with Inf/NaN: same NaN pattern as plain "
        f"(non-finite buckets {bad.tolist()})")
    timing["max_abs_err"] = max(err, res["max_abs_err"])
    return timing


def train_phase(torch) -> dict:
    """Full-width repro-100m, rq4 + error feedback, TRAIN_STEPS AdamW
    steps through the trainer's setup and step function."""
    from repro_torch.core import compression
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.quant import kernel
    from repro_torch.launch import train

    args = train.parse_args(["--arch", TRAIN_ARCH, "--compression", "rq4",
                             "--error-feedback", "--steps",
                             str(TRAIN_STEPS)])
    run = train.setup(args)
    state, train_step, data = run["state"], run["train_step"], run["data"]
    timing = qdq_phase(torch, state["params"])
    codec = compression.codec("rq4")
    wire = codec.tree_wire_bytes_flat(state["params"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernel.reset_launches()
    fk.reset_launches()
    # the attention's flash route under autograd: K6 once a layer (twice
    # under remat: the recompute) and K6b once a layer, a step
    flash_want = {"flash_attention_bhsd": run["cfg"].n_layers * (
        1 + args.remat), "flash_attention_bwd_bhsd": run["cfg"].n_layers}
    losses, gnorms, step_ms = [], [], []
    for t in range(TRAIN_STEPS):
        batch = train.to_device(data.batch_at(t), run["device"])
        before = kernel.launch_counts()
        flash_before = {k: getattr(fk, k).launches for k in flash_want}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = kernel.launch_counts()
        per = {k: after[k] - before[k] for k in TRAIN_KERNELS}
        if per != {"minmax_bucketed": 1, "qdq_bucketed": 2}:
            raise AssertionError(f"step {t}: launches {per}")
        flash_per = {k: getattr(fk, k).launches - flash_before[k]
                     for k in flash_want}
        if flash_per != flash_want:
            raise AssertionError(f"step {t}: flash launches {flash_per}, "
                                 f"want {flash_want}")
        if float(m["comm_bytes"]) != float(torch.tensor(wire)):
            raise AssertionError(f"comm_bytes {float(m['comm_bytes'])} != "
                                 f"wire {wire}")
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if t % 10 == 0 or t == TRAIN_STEPS - 1:
            log(f"[train] step {t:3d} loss {losses[-1]:.4f} gnorm "
                f"{gnorms[-1]:.3f} step {step_ms[-1]:.1f} ms")
    launches = kernel.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError("non-finite loss or grad norm")
    last5 = sum(losses[-5:]) / 5
    if not last5 < losses[0]:
        raise AssertionError(f"loss did not fall: first {losses[0]}, "
                             f"last-5 mean {last5}")
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    out = {"steps": TRAIN_STEPS, "first_loss": losses[0],
           "last5_loss": last5, "median_step_ms": med,
           "tokens_per_s": args.batch * args.seq / (med / 1e3),
           "max_memory_allocated": peak, "comm_bytes": wire,
           "launches": launches,
           "flash_launches": {k: getattr(fk, k).launches
                              for k in flash_want}}
    log(f"[train] flash launches a step: {json.dumps(flash_want)}")
    log(f"[train] median step {med:.3f} ms (first step {step_ms[0]:.1f} "
        "ms)")
    log(f"[train] tokens/s {out['tokens_per_s']:.1f}")
    log(f"[train] max_memory_allocated {peak} B")
    log("[train] " + json.dumps(out))
    log("[train] breakdown " + json.dumps(train_breakdown(
        torch, run, state, batch)))
    checkpoint_check(torch, state)
    train_cross_device_check(torch)
    out["qdq"] = timing
    return out


def train_breakdown(torch, run, state, batch) -> dict:
    """Where a full-width rq4 + EF step's time goes, piece by piece (K4
    draws its uniforms itself: no draw is timed apart)."""
    from repro_torch.core import compression, prng, pytree
    from repro_torch.kernels.quant import kernel, ops
    from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
    from repro_torch.train import steps

    scfg = steps.TrainStepConfig(grad_compression="rq4", error_feedback=True)
    loss_fn = steps.make_loss_fn(run["cfg"], scfg)
    params = state["params"]
    _, grads = steps.value_and_grad(loss_fn, params, batch)
    grads, _ = clip_by_global_norm(grads, 1.0)
    layout = compression.FlatLayout.from_tree(grads)
    _, cap, nb, _, _ = ops.flat_geometry(layout.total, bits=4)
    key = prng.PRNGKey(0)
    v = layout.flatten(grads).add_(state["ec_err"])
    padded = ops.edge_pad(v, nb * cap)
    x4, x3, par, _ = ops._bucket_views(
        padded, layout.total, bits=4, bucket_elems=ops.DEFAULT_BUCKET_ELEMS)

    def k4():
        if nb > 1:
            kernel.qdq_bucketed(x4, key, par[:nb - 1], bits=4)
        kernel.qdq_bucketed(x3, key, par[nb - 1:], bits=4,
                            first_bucket=nb - 1)

    # the update runs on copies: the trained state stays as it is
    scratch = pytree.tree_map(torch.clone, params)
    upd_opt = adamw(1e-6)
    upd_state = upd_opt.init(scratch)
    return {
        "fwd_bwd_ms": host_ms(torch, lambda: steps.value_and_grad(
            loss_fn, params, batch), reps=3),
        "clip_ms": host_ms(torch, lambda: clip_by_global_norm(grads, 1.0)),
        "flatten_ef_ms": host_ms(torch, lambda: layout.flatten(grads).add_(
            state["ec_err"])),
        "buckets": nb,
        "k1_bucket_params_ms": host_ms(torch, lambda: ops.bucket_params(
            padded.view(nb, cap), bits=4)),
        "k4_ms": host_ms(torch, k4),
        "optimizer_update_ms": host_ms(torch, lambda: apply_updates(
            scratch, upd_opt.update(grads, upd_state, scratch)[0])),
    }


def checkpoint_check(torch, state) -> None:
    """The trained full-width state through save_state / load_state:
    every leaf back bit for bit, on its device, CRCs verified."""
    from repro_torch.checkpoint import load_state, save_state
    from repro_torch.core import pytree

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        fname = save_state(state, d, step=int(state["step"]))
        save_s = time.perf_counter() - t0
        size = os.path.getsize(fname)
        t0 = time.perf_counter()
        back = load_state(state, fname)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(back)):
        if a.device != b.device or not bits_equal(a, b):
            raise AssertionError("checkpoint round trip changed a leaf")
    log(f"[train] checkpoint {size} B: save {save_s:.2f} s, load "
        f"{load_s:.2f} s (CRCs verified), state back bit for bit")


def train_cross_device_check(torch) -> None:
    """One reduced rq4 + EF step from the same state and batch on the
    card and on the CPU: losses within 1e-4, and the codec stage given
    the same gradient bit-equal (qflat and ec_err)."""
    from repro_torch import configs
    from repro_torch.core import compression, prng, pytree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    mc = configs.get_config(TRAIN_ARCH).reduced()
    scfg = steps.TrainStepConfig(grad_compression="rq4",
                                 error_feedback=True)
    opt = adamw(1e-3)
    cpu = steps.init_train_state(mc, opt, prng.PRNGKey(2), step_cfg=scfg,
                                 device="cpu")
    cpu["ec_err"].normal_(generator=torch.Generator().manual_seed(3))
    card = steps.state_to(cpu, "cuda")
    batch = SyntheticLM(vocab=mc.vocab, seq_len=65, batch=4,
                        seed=2).batch_at(0)
    loss_fn = steps.make_loss_fn(mc, scfg)
    lc, gc = steps.value_and_grad(loss_fn, cpu["params"], batch)
    lg, _ = steps.value_and_grad(loss_fn, card["params"],
                                 {k: v.cuda() for k, v in batch.items()})
    if abs(float(lc) - float(lg)) > 1e-4:
        raise AssertionError(f"card loss {float(lg)} != CPU {float(lc)}")
    codec = compression.codec("rq4")
    key = prng.fold_in(cpu["rng"], 0)
    qc, ec, _ = steps.compress_grads(codec, gc, key, cpu["ec_err"].clone())
    qg, eg, _ = steps.compress_grads(
        codec, pytree.tree_map(lambda t: t.cuda(), gc), key,
        card["ec_err"].clone())
    if not bits_equal(eg.cpu(), ec) or not all(
            bits_equal(a.cpu(), b) for a, b in zip(pytree.tree_leaves(qg),
                                                   pytree.tree_leaves(qc))):
        raise AssertionError("card and CPU codec stage differ")
    step = steps.make_train_step(mc, opt, scfg)
    _, mc_ = step(cpu, batch)
    _, mg_ = step(card, {k: v.cuda() for k, v in batch.items()})
    if abs(float(mc_["loss"]) - float(mg_["loss"])) > 1e-4:
        raise AssertionError("card and CPU train step losses differ")
    log(f"[check] reduced {TRAIN_ARCH} rq4 + EF step: loss card "
        f"{float(mg_['loss']):.6f} CPU {float(mc_['loss']):.6f}; "
        "qflat and ec_err card == CPU bit for bit")


# ---------------------------------------------------------------------------
# ring phase (the third main path: the algorithm tier's partitioned ring)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def sass_opcodes(library) -> dict:
    """Function name -> the opcodes of its SASS (cuobjdump -sass)."""
    from repro_torch.kernels import nvcc
    tool = Path(nvcc.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", line)
            if m:
                funcs[name].append(m.group(1).split(".")[0])
    return funcs


@functools.lru_cache(maxsize=None)
def threefry_int_ops() -> dict:
    """The device Threefry's 32-bit integer instructions per element,
    counted in the built SASS: the check kernel that hashes one counter a
    thread (threefry_kernel<1>) less the same kernel writing the counter
    itself (threefry_kernel<0>), by pipe. ``clocks_per_element`` is the
    busiest of the ALU pipe, the FMA pipe and the dispatch slots, in SM
    clocks (one lane's share)."""
    from repro_torch.kernels.quant import kernel

    funcs = sass_opcodes(kernel.LIBRARY)
    ops = INT32_ALU_OPCODES | INT32_FMA_OPCODES

    def ops_of(mode: int) -> list:
        names = [n for n in funcs if f"threefry_kernelILi{mode}E" in n]
        if len(names) != 1:
            raise AssertionError(f"threefry_kernel<{mode}> in the SASS: "
                                 f"{names}")
        return [op for op in funcs[names[0]] if op in ops]

    hashed, plain = ops_of(1), ops_of(0)
    by_op = {op: hashed.count(op) - plain.count(op)
             for op in sorted(set(hashed))}
    alu = sum(c for op, c in by_op.items() if op in INT32_ALU_OPCODES)
    fma = sum(c for op, c in by_op.items() if op in INT32_FMA_OPCODES)
    if alu + fma < 40:
        raise AssertionError(f"{alu + fma} integer instructions for 20 "
                             f"rounds: {by_op}")
    clocks = max(alu / PIPE_LANES_PER_SM, fma / PIPE_LANES_PER_SM,
                 (alu + fma) / DISPATCH_LANES_PER_SM)
    return {"per_element": alu + fma, "alu": alu, "fma": fma,
            "clocks_per_element": clocks,
            "bound_by": ("alu pipe" if clocks == alu / PIPE_LANES_PER_SM
                         else "fma pipe" if clocks == fma / PIPE_LANES_PER_SM
                         else "dispatch"),
            "by_opcode": by_op}


def threefry_bound(elems: int, nbytes: float) -> dict:
    """The bound of a kernel that hashes one Threefry counter for each
    of ``elems`` elements and moves ``nbytes``: the larger of the bytes
    at the HBM rate and the hash's integer instructions (counted in the
    SASS, per pipe) at the card's SM clock, with both terms."""
    clock = sm_clock_mhz()
    int_ops = threefry_int_ops()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    int_ms = elems * int_ops["clocks_per_element"] / (SMS * clock * 1e6) \
        * 1e3
    return {"bound_ms": max(bytes_ms, int_ms),
            "bound_by": "bytes" if bytes_ms >= int_ms else "operations",
            "bytes_bound_ms": bytes_ms, "int_bound_ms": int_ms,
            "int_ops_per_element": int_ops["per_element"],
            "sm_clock_mhz": clock}


def threefry_check(torch) -> None:
    """The card's Threefry (the draws of K2, K4 and K5,
    csrc/threefry.cuh) against prng.random_bits / prng.uniform, bit for
    bit: 4Mi counters from 0 under three keys, 4Mi across 2**24 and 4Mi
    up to 2**32."""
    from repro_torch.core import prng
    from repro_torch.kernels.quant import kernel

    n = 1 << 22
    for seed in (0, 1, 12345):
        key = prng.PRNGKey(seed)
        if not bits_equal(kernel.threefry(key, 0, n, device="cuda"),
                          prng.random_bits(key, (n,), device="cuda")):
            raise AssertionError(f"device threefry bits != prng (seed {seed})")
        if not bits_equal(kernel.threefry(key, 0, n, device="cuda",
                                          unit=True),
                          prng.uniform(key, (n,), device="cuda")):
            raise AssertionError(f"device uniforms != prng (seed {seed})")
    key = prng.fold_in(prng.PRNGKey(9), 3)
    want = prng.random_bits(key, ((1 << 24) + n // 2,), device="cuda")
    if not bits_equal(kernel.threefry(key, (1 << 24) - n // 2, n,
                                      device="cuda"), want[-n:]):
        raise AssertionError("device threefry != prng across 2**24")
    del want
    lo = torch.arange((1 << 32) - n, 1 << 32, dtype=torch.int64,
                      device="cuda")
    y0, y1 = prng.threefry2x32(*prng.key_words(key), torch.zeros_like(lo),
                               lo)
    if not bits_equal(kernel.threefry(key, (1 << 32) - n, n, device="cuda"),
                      y0 ^ y1):
        raise AssertionError("device threefry != prng below 2**32")
    log("[ring] device Threefry == prng.random_bits and prng.uniform bit "
        "for bit: 4Mi counters from 0 under 3 keys, 4Mi across 2**24, 4Mi "
        "up to 2**32")


def hop_inputs(n: int, part: int, seed: int, *, bits: int,
               bucket_elems: int, nonfinite: bool = False):
    """One reduce-scatter hop of n workers on the card, cut as the ring
    cuts it: stacked slices (n, n, part), worker i's first message
    encodes its own slice (i, i); at the hop worker i receives worker
    i - 1's message and adds its slice (i, i - 1) under its own key.
    Returns the hop's (payloads, params, locals_, keys), views all."""
    from repro_torch.core import prng
    from repro_torch.kernels.quant import ops
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    gparts = torch.randn((n, n, part), generator=g, device="cuda") * 0.01
    if nonfinite:          # worker 1's addend, in buckets 0, 1 and 2
        gparts[1, 0, 7] = float("inf")
        gparts[1, 0, bucket_elems + 9] = float("nan")
        gparts[1, 0, 2 * bucket_elems + 3] = -float("inf")
    msgs = [ops.encode_flat(gparts[i, i], prng.PRNGKey(seed + i), bits=bits,
                            bucket_elems=bucket_elems) for i in range(n)]
    return ([msgs[(i - 1) % n][0] for i in range(n)],
            [msgs[(i - 1) % n][1] for i in range(n)],
            [gparts[i, (i - 1) % n] for i in range(n)],
            [prng.fold_in(prng.PRNGKey(seed + 100 + i), 1)
             for i in range(n)])


def check_hop(n: int, part: int, seed: int, *, bits: int,
              bucket_elems: int, nonfinite: bool = False,
              timed: bool = False) -> dict:
    """K5 over one hop of n workers (one call) against its keyed plain
    version, against K3 -> add -> K1 -> K2 under the same keys, and against
    n one-worker hops through decode_add_encode_flat, bit for bit."""
    import torch
    from repro_torch.kernels.quant import kernel, ops, ref

    pays, prms, locs, keys = hop_inputs(n, part, seed, bits=bits,
                                        bucket_elems=bucket_elems,
                                        nonfinite=nonfinite)
    _, _, nb, rows_b, rows_kept = ops.flat_geometry(
        part, bits=bits, bucket_elems=bucket_elems)
    rt = rows_kept - (nb - 1) * rows_b

    def k5():
        return ops.decode_add_encode_partitions(
            pays, prms, locs, keys, bits=bits, bucket_elems=bucket_elems)

    def k5_plain():
        return ref.decode_add_encode_hop(pays, prms, locs, keys, bits=bits,
                                         rows_b=rows_b, rt=rt)

    def composed():    # K3, add, K1 + K2 (drawing on the card), per worker
        outs = [ops.encode_flat(ops.decode_flat(
            p, q, total=part, bits=bits, bucket_elems=bucket_elems).add_(x),
            key, bits=bits, bucket_elems=bucket_elems)
            for p, q, x, key in zip(pays, prms, locs, keys)]
        return (torch.stack([o for o, _ in outs]),
                torch.stack([q for _, q in outs]))

    what = f"(bits={bits}, N={n}, {part} elements a partition)"
    before = kernel.decode_add_encode_bucketed.launches
    got, got_p = k5()
    if kernel.decode_add_encode_bucketed.launches - before != 1:
        raise AssertionError(f"K5 hop launched "
                             f"{kernel.decode_add_encode_bucketed.launches - before} "
                             f"times {what}")
    for name, (w, wp) in (("its keyed plain version", k5_plain()),
                          ("K3 -> add -> K1 -> K2", composed())):
        if not (bits_equal(got, w) and same_bits(got_p, wp)):
            raise AssertionError(f"K5 != {name} {what}")
    before = kernel.decode_add_encode_bucketed.launches
    for i in range(n):
        fo, fp = ops.decode_add_encode_flat(pays[i], prms[i], locs[i],
                                            keys[i], bits=bits,
                                            bucket_elems=bucket_elems)
        if not (bits_equal(fo, got[i]) and same_bits(fp, got_p[i])):
            raise AssertionError(f"decode_add_encode_flat (N = 1) != the "
                                 f"N-worker hop, worker {i} {what}")
    if kernel.decode_add_encode_bucketed.launches - before != n:
        raise AssertionError("decode_add_encode_flat: not one K5 call")
    want, want_p = k5_plain()
    res = {"max_abs_err": max(max_abs(got.float(), want.float()),
                              max_abs(got_p, want_p))}
    del want, want_p
    if nonfinite:
        res["nonfinite_buckets"] = (~torch.isfinite(got_p).all(dim=2)
                                    ).tolist()
    if timed:
        elems = n * part
        int_ops = threefry_int_ops()
        res.update(
            ms=time_ms(k5),
            plain_ms=time_ms(k5_plain, reps=3),
            composed_ms=time_ms(composed, reps=3), library_ms=None,
            **threefry_bound(elems, elems * (2 * bits / 8 + 4) + 16 * n * nb),
            int_alu_ops=int_ops["alu"], int_fma_ops=int_ops["fma"],
            int_bound_by=int_ops["bound_by"],
            int_ops_by_opcode=int_ops["by_opcode"],
            design_floor_ms=(elems * (2 * (bits / 8 + 4) + bits / 8)
                             + 16 * n * nb) / HBM_BYTES_PER_S * 1e3,
            workers=n, elements=elems, buckets_per_worker=nb)
    return res


def dae_phase(torch) -> dict:
    """The device Threefry, then K5 over a hop of RING_WORKERS workers at
    the full-width ring partition geometry (bits 8/4/2, timed at rq4), on
    partitions of several buckets with a short last one, with buckets
    holding Inf and NaN, and an unaligned buffer (the composition)."""
    from repro_torch.kernels.quant import kernel, ops

    threefry_check(torch)
    err, timing = 0.0, {}
    for bits in (8, 4, 2):
        pe, nb_p, rows_p = ops.partition_geometry(TRAIN_TOTAL, RING_WORKERS,
                                                  bits=bits)
        res = check_hop(RING_WORKERS, pe, 20 + bits, bits=bits,
                        bucket_elems=ops.DEFAULT_BUCKET_ELEMS,
                        timed=(bits == 4))
        err = max(err, res["max_abs_err"])
        if bits == 4:
            if (pe, nb_p, rows_p * ops.LANES + nb_p * 8) != (
                    RING_PART_ELEMS, RING_PART_BUCKETS, RING_MSG_BYTES):
                raise AssertionError(f"rq4 partition geometry {pe}, {nb_p}, "
                                     f"{rows_p}")
            timing = res
        torch.cuda.empty_cache()
        log(f"[ring] K5 one call over {RING_WORKERS} full-width partitions "
            f"bits={bits} ({pe} elements, {nb_p} buckets each): == keyed "
            "plain, == K3 -> add -> K1 -> K2, == 4 one-worker hops")
    for bits in (8, 4, 2):
        granule = (8 // bits) * ops.LANES
        err = max(err, check_hop(RING_WORKERS, 5 * 4096 + 3 * granule,
                                 40 + bits, bits=bits,
                                 bucket_elems=4096)["max_abs_err"])
    log(f"[ring] K5 over {RING_WORKERS} partitions of several buckets with a "
        "short last bucket (bucket_elems 4096): bits 8/4/2 == keyed plain, "
        "== composition")
    # hops past one launch's argument block: one call, several launches
    for n, nb in ((kernel.HOP_MAX_WORKERS + 1, 40),
                  (2, kernel.HOP_MAX_KEYS + 44)):
        err = max(err, check_hop(n, (nb - 1) * 4096 + 3 * 1024, 60 + n,
                                 bits=4, bucket_elems=4096)["max_abs_err"])
        log(f"[ring] K5 one call over {n} partitions of {nb} buckets "
            f"({len(kernel.hop_chunks(n, nb))} launches): == keyed plain, "
            "== composition")
    # an unaligned total is JAX's sequential composition: no K5 launch
    g = torch.Generator(device="cuda").manual_seed(5)
    from repro_torch.core import prng
    for bits in (8, 4, 2):
        total = 300_001
        x = torch.randn(total, generator=g, device="cuda")
        loc = torch.randn(total, generator=g, device="cuda")
        pay, par = ops.encode_flat(x, prng.PRNGKey(bits), bits=bits,
                                   bucket_elems=4096)
        before = kernel.decode_add_encode_bucketed.launches
        fo, fp = ops.decode_add_encode_flat(pay, par, loc, prng.PRNGKey(9),
                                            bits=bits, bucket_elems=4096)
        if kernel.decode_add_encode_bucketed.launches != before:
            raise AssertionError("an unaligned buffer launched K5")
        wo, wp = ops.encode_flat(ops.decode_flat(
            pay, par, total=total, bits=bits, bucket_elems=4096) + loc,
            prng.PRNGKey(9), bits=bits, bucket_elems=4096)
        if not (bits_equal(fo, wo) and bits_equal(fp, wp)):
            raise AssertionError("unaligned decode_add_encode_flat != "
                                 "composition")
    log("[ring] unaligned total 300001: decode_add_encode_flat == "
        "K3 -> add -> K1 -> K2, bits 8/4/2")
    res = check_hop(RING_WORKERS, 3 * 4096, 3, bits=4, bucket_elems=4096,
                    nonfinite=True)
    bad = res["nonfinite_buckets"]
    if bad[1] != [True, True, True] or any(any(r) for i, r in enumerate(bad)
                                           if i != 1):
        raise AssertionError(f"non-finite buckets {bad}")
    log("[ring] K5 buckets with Inf/NaN: == keyed plain, NaN at the same "
        f"places (non-finite params rows by worker {bad})")
    timing["max_abs_err"] = max(err, res["max_abs_err"])
    log(f"[ring] K5 over a hop of {RING_WORKERS} rq4 full-width partitions: "
        + json.dumps(timing))
    return timing


class CountingExchange:
    """Wraps an exchange or a gossip operator: the kernel launches and the
    host time of each call (synchronized), for the smoke's per-step
    checks; on ranks (``axis_name``) also the bytes the call sent and the
    time it ended. Everything else (``init``, ``init_stacked``,
    ``message_bytes``) is the inner one's."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []
        self.sent = []
        self.ends = []
        self.last = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *args, **kw):
        import torch
        from repro_torch.kernels.quant import kernel
        axis = kw.get("axis_name")
        torch.cuda.synchronize()
        before = kernel.launch_counts()
        sent = axis.sent_bytes if axis is not None else 0
        t0 = time.perf_counter()
        out = self.inner(*args, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = kernel.launch_counts()
        self.calls.append(({k: after[k] - before[k] for k in after},
                           (t1 - t0) * 1e3))
        if axis is not None:
            self.sent.append(axis.sent_bytes - sent)
            self.ends.append(t1)
            self.last = out
        return out


def ring_problem(torch, device):
    """The ring cell's model and data on ``device``: full-width
    repro-100m from RING_SEED, its loss, a batch maker (RING_BATCH x
    RING_SEQ tokens from a key) and the evaluation batch."""
    from repro_torch import configs
    from repro_torch.core import compression, prng
    from repro_torch.models import transformer
    from repro_torch.train import steps

    cfg = configs.get_config(TRAIN_ARCH)
    params0 = transformer.init(
        cfg, torch.Generator(device=device).manual_seed(RING_SEED))
    layout = compression.FlatLayout.from_tree(params0)
    if layout.total != TRAIN_TOTAL:
        raise AssertionError(f"{TRAIN_ARCH}: {layout.total} parameters")

    def make_batch(key):
        tok = prng.randint(key, (RING_BATCH, RING_SEQ + 1), 0, cfg.vocab,
                           device=device)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    return (params0, steps.make_loss_fn(cfg), make_batch,
            make_batch(prng.PRNGKey(RING_SEED + 1)))


def ring_phase(torch) -> dict:
    """Full-width repro-100m, 4 workers stacked on the card, rq4
    partitioned ring, plain SGD, RING_STEPS steps of run_distributed."""
    from repro_torch.core import communicators, parallel
    from repro_torch.kernels.quant import kernel
    from repro_torch.train import steps

    timing = dae_phase(torch)
    params0, loss_fn, make_batch, eval_batch = ring_problem(torch, "cuda")
    marks = []

    def sample_batch(key, worker):
        if worker == 0:
            torch.cuda.synchronize()
            marks.append(["start", time.perf_counter()])
        return make_batch(key)

    def full_loss(p):
        torch.cuda.synchronize()
        marks.append(["end", time.perf_counter()])
        return loss_fn(p, eval_batch)

    def full_grad(p):
        return steps.value_and_grad(loss_fn, p, eval_batch)[1]

    ring = communicators.CSGDRingExchange(compressor="rq4")
    comm = ring.message_bytes(params0, n_workers=RING_WORKERS)
    if comm != RING_COMM_BYTES or comm != 2 * (RING_WORKERS - 1) * \
            RING_MSG_BYTES:
        raise AssertionError(f"comm_bytes_per_step {comm}")
    ex = CountingExchange(ring)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    t0 = time.perf_counter()
    res = parallel.run_distributed(
        loss_fn, full_loss, full_grad, params0, sample_batch,
        n_workers=RING_WORKERS, steps=RING_STEPS, lr=RING_LR, exchange=ex,
        seed=RING_SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = kernel.launch_counts()
    losses = [float(v) for v in res.losses]
    cons = [float(v) for v in res.consensus]
    gnorms = [float(v) for v in res.grad_norms]
    step_ms = [(e[1] - s[1]) * 1e3 for s, e in zip(marks[0::2], marks[1::2])]
    for t, (per, ex_ms) in enumerate(ex.calls):
        log(f"[ring] step {t} loss(x_bar) {losses[t]:.5f} gnorm "
            f"{gnorms[t]:.4f} consensus {cons[t]!r} step {step_ms[t]:.1f} "
            f"ms (exchange {ex_ms:.1f} ms) K5 launches "
            f"{per['decode_add_encode_bucketed']}")
        if per["decode_add_encode_bucketed"] != RING_WORKERS - 1:
            raise AssertionError(f"step {t}: launches {per}")
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"non-finite loss {losses}")
    if any(c != 0.0 for c in cons):
        raise AssertionError(f"consensus {cons}: workers differ")
    if res.comm_bytes_per_step != RING_COMM_BYTES:
        raise AssertionError(f"comm {res.comm_bytes_per_step}")
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens = RING_WORKERS * RING_BATCH * RING_SEQ
    out = {"steps": RING_STEPS, "workers": RING_WORKERS, "lr": RING_LR,
           "losses": losses, "consensus": cons, "median_step_ms": med,
           "first_step_ms": step_ms[0], "tokens_per_s": tokens / (med / 1e3),
           "exchange_ms": [ms for _, ms in ex.calls],
           "max_memory_allocated": peak,
           "comm_bytes_per_step": res.comm_bytes_per_step,
           "wall_s": wall, "launches": launches}
    log(f"[ring] median step {med:.1f} ms (first {step_ms[0]:.1f} ms), "
        f"tokens/s {out['tokens_per_s']:.1f}, max_memory_allocated {peak} B")
    log("[ring] " + json.dumps(out))
    log("[ring] breakdown " + json.dumps(ring_breakdown(
        torch, loss_fn, res.params, make_batch)))
    del res
    torch.cuda.empty_cache()
    ring_cross_device_check(torch)
    out["dae"] = timing
    return out


def ring_breakdown(torch, loss_fn, params_w, make_batch) -> dict:
    """Where a full-width ring step's time goes, piece by piece, each
    timed alone on the host clock around a synchronize. K2 draws the N
    initial encodes' uniforms and K5 the hops' own: none is drawn in
    plain torch."""
    from repro_torch.core import communicators as C
    from repro_torch.core import compression, prng, pytree
    from repro_torch.kernels.quant import kernel, ops
    from repro_torch.train import steps

    n = RING_WORKERS
    cdc = compression.codec("rq4")
    key = prng.PRNGKey(77)
    batch = make_batch(key)
    p0 = pytree.tree_map(lambda p: p[0], params_w)
    g = steps.value_and_grad(loss_fn, p0, batch)[1]
    grads_w = pytree.tree_map(lambda t: torch.stack([t] * n), g)
    del g
    layout = C._layout_w(grads_w)
    pe, nb, _ = cdc.partition_geometry(layout.total, n)
    _, cap, _, _, _ = ops.flat_geometry(pe, bits=4)
    gparts = C._flatten_w(layout, grads_w, padded_len=n * pe).view(n, n, pe)
    msgs = [cdc.encode_partition(gparts[i, i], prng.fold_in(key, i))
            for i in range(n)]

    def k5_hops():     # the N - 1 reduce-scatter hops, one call each
        pay, prm = [m[0] for m in msgs], [m[1] for m in msgs]
        for h in range(1, n):
            pay, prm = cdc.decode_add_encode_partitions(
                [pay[(i - 1) % n] for i in range(n)],
                [prm[(i - 1) % n] for i in range(n)],
                [gparts[i, (i - h) % n] for i in range(n)],
                [prng.fold_in(key, 10 * i + h) for i in range(n)])

    # K1 + K2 of the N initial partition encodes
    x4, x3, _, _ = ops._bucket_views(
        ops.edge_pad(gparts[0, 0], nb * cap), pe, bits=4,
        bucket_elems=ops.DEFAULT_BUCKET_ELEMS)

    def initial_encodes():
        for i in range(n):
            prm = ops.bucket_params(ops.edge_pad(gparts[i, i], nb * cap).view(
                nb, cap), bits=4)
            if nb > 1:
                kernel.encode_packed(x4, key, prm[:nb - 1], bits=4)
            kernel.encode_packed(x3, key, prm[nb - 1:], bits=4,
                                 first_bucket=nb - 1)

    payload_all = torch.empty((n, n) + tuple(msgs[0][0].shape),
                              dtype=torch.uint8, device="cuda")
    stacked = torch.stack([m[0] for m in msgs])
    rows = torch.arange(n, device="cuda")

    def all_gather():  # as the ring forwards the stacked messages
        for g in range(n):
            src = (rows - g) % n
            payload_all[rows, (src + 1) % n] = stacked[src]

    out = torch.empty((n, n * pe), device="cuda")

    def decode_all():
        for i in range(n):
            for j in range(n):
                cdc.decode_partition(*msgs[j], part_elems=pe,
                                     out=out[i, j * pe:(j + 1) * pe])

    return {
        "fwd_bwd_per_worker_ms": host_ms(torch, lambda: steps.value_and_grad(
            loss_fn, p0, batch), reps=3),
        "fwd_bwd_workers": n,
        "k5_per_step_ms": host_ms(torch, k5_hops, reps=3),
        "k1_k2_initial_encodes_ms": host_ms(torch, initial_encodes),
        "all_gather_copies_ms": host_ms(torch, all_gather),
        "final_decodes_k3_ms": host_ms(torch, decode_all),
        "flatten_pad_ms": host_ms(torch, lambda: C._flatten_w(
            layout, grads_w, padded_len=n * pe)),
        "sgd_update_ms": host_ms(torch, lambda: pytree.tree_map(
            lambda p, g: p - RING_LR * g, params_w, grads_w)),
    }


def ring_cross_device_check(torch) -> None:
    """A reduced rq4 ring exchange (N = 4, partitions of several
    buckets) on the card equals the CPU plain path bit for bit, given
    the same stacked gradients."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import communicators, compression, prng, pytree
    from repro_torch.kernels.quant import kernel
    from repro_torch.models import transformer

    mc = configs.get_config(TRAIN_ARCH).reduced(n_layers=2, d_model=128,
                                                vocab=256)
    params = transformer.init(mc, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(3)
    grads = pytree.tree_map(lambda p: torch.from_numpy(
        (rng.normal(size=(RING_WORKERS,) + tuple(p.shape)) * 0.01).astype(
            np.float32)), params)
    ring = communicators.CSGDRingExchange(compressor="rq4")
    default_be = compression.DEFAULT_BUCKET_ELEMS
    compression.DEFAULT_BUCKET_ELEMS = 16384     # partitions of 16 buckets
    try:
        before = kernel.decode_add_encode_bucketed.launches
        got, _ = ring(pytree.tree_map(lambda t: t.cuda(), grads), (),
                      prng.PRNGKey(5))
        k5 = kernel.decode_add_encode_bucketed.launches - before
        want, _ = ring(grads, (), prng.PRNGKey(5))
    finally:
        compression.DEFAULT_BUCKET_ELEMS = default_be
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        if not bits_equal(a.cpu(), b):
            raise AssertionError("card and CPU ring exchanges differ")
        if not all(bits_equal(a[i], a[0]) for i in range(1, RING_WORKERS)):
            raise AssertionError("workers differ after the all-gather")
    if k5 != RING_WORKERS - 1:
        raise AssertionError(f"reduced ring launched K5 {k5} times")
    total = sum(t.numel() for t in pytree.tree_leaves(params))
    log(f"[check] reduced {TRAIN_ARCH} rq4 ring ({total} parameters, "
        f"N={RING_WORKERS}, bucket_elems 16384): card == CPU bit for bit, "
        "all workers identical")


# ---------------------------------------------------------------------------
# prefill phase (the fourth main path: full-sequence prefill on flash)
# ---------------------------------------------------------------------------


def attended_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the causal and window masks leave over ``s``
    real queries and keys."""
    import numpy as np
    qp = np.arange(s, dtype=np.int64)
    hi = qp + 1 if causal else np.full(s, s, np.int64)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else 0
    return int((hi - lo).sum())


def flash_bound(b: int, hq: int, hkv: int, d: int, s: int, causal: bool,
                window: int, elt: int, dv: int = None) -> dict:
    """The least time for K6's work in the arithmetic it uses: fp32 as
    3xTF32, 3 x 2 * (D + DV) flops per attended (q-head, query, key)
    triple at the dense TF32 rate; bf16 2 * (D + DV) flops at the bf16
    rate; against q, k (head dim D), v (DV) read and out (DV) written
    once at the memory rate. DV defaults to D."""
    dv = d if dv is None else dv
    per, rate = ((FLASH_FP32_PRODUCTS * 2 * (d + dv), TF32_FLOPS_PER_S)
                 if elt == 4 else (2 * (d + dv), BF16_FLOPS_PER_S))
    flops = per * hq * b * attended_pairs(s, causal, window)
    nbytes = (hq * d + hkv * d + hkv * dv + hq * dv) * b * s * elt
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(flops / rate, nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": ("operations" if flops / rate >=
                         nbytes / HBM_BYTES_PER_S else "bytes")}


def check_flash(torch, b: int, hq: int, hkv: int, d: int, s: int,
                causal: bool, window: int, cap: float, dtype: str,
                tol: float, *, seed: int, dv: int = None,
                scale: float = None) -> dict:
    """K6 on unit-normal (B, H, S, D) card tensors (v (B, Hkv, S, DV),
    DV defaulting to D; S padded to the block as ops pads it) at softmax
    scale ``scale`` (None: 1/sqrt(D)) against its plain version on the
    same card tensors, at ``tol``; skip == full grid bit for bit;
    CUDA-event times of K6, the plain version and, for causal attention
    without window or softcap, SDPA's memory-efficient kernel on the
    same inputs (K and V repeated to the q heads beforehand) as the
    library yardstick, with its max abs error against the plain version
    beside K6's."""
    import numpy as np
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn import ops as fo

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    bq = min(fo.DEFAULT_BLOCK_Q, max(8, 1 << (s - 1).bit_length()))
    bk = min(fo.DEFAULT_BLOCK_K, bq)
    s_pad = -(-s // bq) * bq

    dv = d if dv is None else dv

    def draw(h, width=d):
        x = torch.from_numpy(rng.standard_normal(
            (b, h, s, width), dtype=np.float32)).to("cuda", dt)
        return torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))

    q, k, v = draw(hq), draw(hkv), draw(hkv, dv)
    kw = dict(causal=causal, window=window, softcap=cap, block_q=bq,
              block_k=bk, s_valid=s, scale=scale)
    out = fk.flash_attention_bhsd(q, k, v, **kw)
    full = fk.flash_attention_bhsd(q, k, v, skip=False, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, full):
        raise AssertionError(f"K6 skip != full grid at "
                             f"{(b, hq, hkv, d, dv, s)}")
    del full
    want = fk.flash_attention_plain(q, k, v, **kw)[:, :, :s].float()
    got = out[:, :, :s].float()
    err = max_abs(got, want)
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"K6 != plain at {(b, hq, hkv, d, dv, s)}: "
                             f"max abs err {err} (tolerance {tol})")
    del out, got
    res = {"shape": [b, hq, hkv, s, d], "dv": dv, "scale": scale,
           "dtype": dtype, "causal": causal,
           "window": window, "softcap": cap, "max_abs_err": err,
           "tolerance": tol, "library_max_abs_err": None,
           "ms": time_ms(lambda: fk.flash_attention_bhsd(q, k, v, **kw),
                         reps=5),
           "plain_ms": time_ms(lambda: fk.flash_attention_plain(
               q, k, v, **kw), reps=3), "library_ms": None}
    res.update(flash_bound(b, hq, hkv, d, s, causal, window,
                           q.element_size(), dv))
    if causal and not window and not cap:
        g = hq // hkv
        qs = q[:, :, :s]
        ks, vs = (t[:, :, :s].repeat_interleave(g, dim=1) for t in (k, v))
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            lib = torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, scale=scale)
            res["library_max_abs_err"] = max_abs(lib.float(), want)
            del lib
            res["library_ms"] = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, scale=scale), reps=5)
    del want
    res["fraction_of_bound"] = res["bound_ms"] / res["ms"]
    return res


def flash_geometries(torch) -> list:
    """K6 against its plain version at full length at the attention
    geometries of the repo's models (FLASH_GEOMETRIES), MLA's scale held
    to deepseek-v2-lite's."""
    from repro_torch import configs
    from repro_torch.models import mla
    want = mla._scale(configs.get_config("deepseek-v2-lite"))
    if abs(MLA_SCALE - want) > 1e-12:
        raise AssertionError(f"MLA_SCALE {MLA_SCALE} != the configuration's "
                             f"{want}")
    out = []
    for i, (name, hq, hkv, d, dv, s, causal, window, cap, scale, dtype,
            tol) in enumerate(FLASH_GEOMETRIES):
        res = check_flash(torch, 1, hq, hkv, d, s, causal, window, cap,
                          dtype, tol, seed=100 + i, dv=dv, scale=scale)
        res["name"] = name
        log(f"[prefill] K6 {name}: == plain within {tol} (max abs err "
            f"{res['max_abs_err']:.3g}), skip == full bit for bit; "
            + json.dumps(res))
        out.append(res)
        torch.cuda.empty_cache()
    return out


def mla_kernel_line(geometries: list, families: dict) -> dict:
    """The kernels line's row of K6 at MLA's head dims
    (flash_fwd<float, 192, false, 128>): its MLA_GEOMETRY times against
    its bound, plain version and SDPA, and its launches in the families'
    deepseek-v2-lite-16b prefills (once an MLA layer)."""
    g = next(r for r in geometries if r["name"] == MLA_GEOMETRY)
    return {"kernel": "flash_attention_bhsd (D 192, DV 128)",
            "shape": g["shape"], "dv": g["dv"], "scale": g["scale"],
            "max_abs_err": g["max_abs_err"], "kernel_ms": g["ms"],
            "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
            "fraction_of_bound": g["fraction_of_bound"],
            "launches": families["deepseek-v2-lite-16b"]["launches"],
            "library_ms": g["library_ms"],
            "library_max_abs_err": g["library_max_abs_err"]}


def prefill_model(torch, arch: str, shape_name, b: int, s: int,
                  n_layers: int, seed: int, *, dtype: str = "float32",
                  params=None, cfg=None, batch=None) -> dict:
    """One model at full width and depth: a warm-up and PREFILL_REPS
    timed flash prefills (the main path, K6 launches counted: once per
    attention layer, local ones at the model's window), K6 alone at the
    prefill's attention shape, and the same prefill without flash as the
    reference for the last-position logits. ``dtype`` is the weights'
    (bf16 takes K6's bf16 route, and its logits are held by relative L2,
    BF16_PREFILL_TOL); ``params``, when given, are the model's weights
    already on the card, ``cfg`` its configuration when it is not the
    registry's (a depth cut), and ``batch`` the prefill's inputs when
    they are not ``synthetic_batch``'s tokens (stub embeddings)."""
    from repro_torch import configs
    from repro_torch.core import prng, pytree
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models import transformer_scan
    from repro_torch.models.common import INPUT_SHAPES, InputShape
    from repro_torch.train import steps

    cfg = cfg or configs.get_config(arch)
    if cfg.n_layers != n_layers:
        raise AssertionError(f"{arch}: {cfg.n_layers} layers")
    attn_layers = sum(k in ("attn", "local_attn") for k in cfg.block_pattern)
    window = cfg.local_window if "local_attn" in cfg.block_pattern else 0
    fp32 = dtype == "float32"
    k6_tol, logits_tol = ((2e-5, PREFILL_TOL) if fp32
                          else (BF16_TOL, BF16_PREFILL_TOL))
    gc.collect()                 # earlier phases' cycles hold card memory
    torch.cuda.empty_cache()
    held = None
    if params is None:
        held = torch.cuda.memory_allocated()
        params = transformer_scan.init(
            cfg, transformer_scan.generator(seed, "cuda"),
            dtype=getattr(torch, dtype))
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    if batch is None:
        shape = (INPUT_SHAPES[shape_name] if shape_name else
                 InputShape(f"prefill_{s // 1024}k", s, b, "prefill"))
        batch = {k: v[:b] for k, v in pipeline.synthetic_batch(
            cfg, shape, prng.PRNGKey(seed), device="cuda").items()}
    lead = batch["tokens" if "tokens" in batch else "embeddings"]
    if tuple(lead.shape[:2]) != (b, s):
        raise AssertionError(f"batch {tuple(lead.shape)}")
    step = steps.make_prefill_step(cfg, use_flash=True, scan_layers=True,
                                   logits_positions="last")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fk.reset_launches()
    logits = step(params, batch)
    times = []
    for _ in range(PREFILL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    launches = fk.flash_attention_bhsd.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != (1 + PREFILL_REPS) * attn_layers:
        raise AssertionError(f"{arch}: K6 launched {launches} times in "
                             f"{1 + PREFILL_REPS} prefills of "
                             f"{attn_layers} attention layers")
    if tuple(logits.shape) != (b, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    med = sorted(times)[len(times) // 2]

    k6 = check_flash(torch, b, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     s, True, window, cfg.logit_softcap, dtype, k6_tol,
                     seed=seed + 1)
    ref = steps.make_prefill_step(cfg, use_flash=False, scan_layers=True,
                                  logits_positions="last")(params, batch)
    got, want = logits.float(), ref.float()
    err = max_abs(got, want)
    rel_l2 = float((got - want).norm() / want.norm())
    if not (torch.allclose(got, want, rtol=logits_tol, atol=logits_tol)
            if fp32 else rel_l2 <= logits_tol):
        raise AssertionError(f"{arch}: flash prefill logits != non-flash "
                             f"(max abs err {err}, relative L2 {rel_l2}, "
                             f"tolerance {logits_tol})")
    out = {"arch": arch, "dtype": dtype, "batch": b, "seq": s,
           "params": n_params, "layers": n_layers,
           "attention_layers": attn_layers, "window": window,
           "prefill_ms": times, "median_ms": med,
           "tokens_per_s": b * s / (med / 1e3),
           "k6_launches_per_prefill": launches // (1 + PREFILL_REPS),
           "k6_ms": k6["ms"], "k6_share": k6["ms"] * attn_layers / med,
           "max_memory_allocated": peak,
           "allocated_before_init": held,
           "logits_max_abs_err_vs_no_flash": err,
           "logits_rel_l2_vs_no_flash": rel_l2,
           "logits_tolerance": logits_tol,
           "logits_abs_max": float(ref.float().abs().max()), "k6": k6,
           "launches": launches}
    log(f"[prefill] {arch} ({dtype}) {b} x {s}: median {med:.1f} ms of "
        f"{[round(t, 1) for t in times]}, {out['tokens_per_s']:.1f} "
        f"tokens/s, K6 {k6['ms']:.3f} ms x {attn_layers} = "
        f"{100 * out['k6_share']:.1f} % of the prefill, peak "
        f"{peak} B, flash vs no-flash logits max abs err {err:.3g}, "
        f"relative L2 {rel_l2:.3g} (tolerance {logits_tol}"
        + ("" if fp32 else ", relative L2") + ")")
    log("[prefill] " + json.dumps(out))
    del params, batch, logits, ref
    torch.cuda.empty_cache()
    return out


def prefill_cross_device_check(torch) -> None:
    """A reduced flash prefill (the smoke's form, S = 300: padded to the
    block) on the card against the CPU, within REDUCED_TOL."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models import transformer_scan
    from repro_torch.train import steps

    for arch, _, _, _, _ in PREFILL_RUNS:
        mc = configs.get_config(arch).reduced()
        params = transformer_scan.init(mc, transformer_scan.generator(5))
        tok = torch.from_numpy(np.random.default_rng(6).integers(
            0, mc.vocab, size=(2, 300)).astype(np.int32))
        step = steps.make_prefill_step(mc, use_flash=True, scan_layers=True,
                                       logits_positions="last")
        want = step(params, {"tokens": tok})
        before = fk.flash_attention_bhsd.launches
        got = step(pytree.tree_map(lambda t: t.cuda(), params),
                   {"tokens": tok.cuda()}).cpu()
        if fk.flash_attention_bhsd.launches - before != mc.n_layers:
            raise AssertionError("reduced card prefill did not run on K6")
        if not torch.allclose(got, want, rtol=REDUCED_TOL,
                              atol=REDUCED_TOL):
            raise AssertionError(f"reduced {arch} prefill: card != CPU "
                                 f"(max abs err {max_abs(got, want)})")
        log(f"[check] reduced {arch} flash prefill (2 x 300): card == CPU "
            f"within {REDUCED_TOL} (max abs err {max_abs(got, want):.3g})")


def prefill_phase(torch) -> dict:
    """K6 at the models' attention geometries, then the three full-width
    prefills, then a reduced card-vs-CPU prefill. The K6 row of the
    kernels line is K6 at the first prefill's attention shape."""
    geoms = flash_geometries(torch)
    runs = [prefill_model(torch, arch, shape, b, s, n, seed=30 + i)
            for i, (arch, shape, b, s, n) in enumerate(PREFILL_RUNS)]
    prefill_cross_device_check(torch)
    k6 = dict(runs[0]["k6"])
    k6["max_abs_err"] = max(r["max_abs_err"] for r in
                            geoms + [r["k6"] for r in runs]
                            if r["dtype"] == "float32")
    return {"geometries": geoms, "runs": runs, "k6": k6,
            "launches": {"flash_attention_bhsd": sum(r["launches"]
                                                     for r in runs)}}


def check_flash_backward(torch, b: int, hq: int, hkv: int, d: int,
                         s: int, *, seed: int) -> dict:
    """K6b on unit-normal (B, H, S, D) fp32 card tensors, causal, after
    K6 with its lse: against the plain backward on the same card tensors
    (rtol = atol = K6B_TOL), a second call bit for bit; CUDA-event times
    of K6b, the plain backward and, as the yardstick only, PyTorch's
    memory-efficient SDPA backward on the same inputs (K and V repeated
    to the q heads beforehand), beside K6b's bound: 10 * D flops per
    attended (q-head, query, key) triple, the five products of one
    backward, at the 3xTF32 rate."""
    import numpy as np
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attn import kernel as fk

    rng = np.random.default_rng(seed)

    def draw(h):
        return torch.from_numpy(rng.standard_normal(
            (b, h, s, d), dtype=np.float32)).to("cuda")

    q, k, v, dout = draw(hq), draw(hkv), draw(hkv), draw(hq)
    out, lse = fk.flash_attention_bhsd(q, k, v, causal=True, window=0,
                                       softcap=0.0, block_q=256,
                                       block_k=128, s_valid=s,
                                       with_lse=True)
    bw = dict(causal=True, window=0, s_valid=s)
    got = fk.flash_attention_bwd_bhsd(q, k, v, out, dout, lse, **bw)
    again = fk.flash_attention_bwd_bhsd(q, k, v, out, dout, lse, **bw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"K6b reruns differ at {(b, hq, hkv, d, s)}")
    del again
    want = fk.flash_attention_backward_plain(q, k, v, out, dout, lse, **bw)
    err = max(max_abs(a, w) for a, w in zip(got, want))
    if not all(torch.allclose(a, w, rtol=K6B_TOL, atol=K6B_TOL)
               for a, w in zip(got, want)):
        raise AssertionError(f"K6b != plain at {(b, hq, hkv, d, s)}: max "
                             f"abs err {err} (tolerance {K6B_TOL})")
    del got, want
    flops = 10 * d * hq * b * attended_pairs(s, True, 0)
    res = {"shape": [b, hq, hkv, s, d], "max_abs_err": err,
           "tolerance": K6B_TOL, "bit_identical": True,
           "ms": time_ms(lambda: fk.flash_attention_bwd_bhsd(
               q, k, v, out, dout, lse, **bw), reps=5),
           "plain_ms": time_ms(lambda: fk.flash_attention_backward_plain(
               q, k, v, out, dout, lse, **bw), reps=3),
           "flops": flops, "bound_ms": flops / FP32_3XTF32_FLOPS_PER_S * 1e3,
           "bound_by": "operations"}
    g = hq // hkv
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (
        q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        lib = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)
        res["library_ms"] = time_ms(lambda: torch.autograd.grad(
            lib, (qs, ks, vs), dout, retain_graph=True), reps=5)
    res["fraction_of_bound"] = res["bound_ms"] / res["ms"]
    return res


def flash_backward_phase(torch) -> dict:
    """K6b at the train cell's attention and at GQA 32/8, D 128
    (FLASH_BACKWARD_GEOMETRIES); the first is the kernels line's K6b
    row."""
    out = []
    for i, (name, b, hq, hkv, d, s) in enumerate(FLASH_BACKWARD_GEOMETRIES):
        res = check_flash_backward(torch, b, hq, hkv, d, s, seed=200 + i)
        res["name"] = name
        log(f"[k6b] {name}: == plain within {K6B_TOL} (max abs err "
            f"{res['max_abs_err']:.3g}), reruns bit for bit; "
            + json.dumps(res))
        out.append(res)
        torch.cuda.empty_cache()
    return {"geometries": out, "k6b": out[0]}


# ---------------------------------------------------------------------------
# rwkv phase (the fifth main path: rwkv6-3b prefill on K7, and serving)
# ---------------------------------------------------------------------------


def wkv_draw(torch, rng, b: int, h: int, s: int, k: int, regime: str):
    """r, k, v, log_w (B, S, H, K), u (H, K) and a state0 (B, H, K, K),
    fp32 on the card, from a numpy generator: r, k, v normal * 0.5, u
    normal * 0.1, state0 normal * 0.1. ``regime`` picks the decays:
    "model" is rwkv6-3b's own at init (w0 = -6 plus a small LoRA term:
    log_w = -exp(-6 + 0.3 tanh(N(0, 1)))), "tests" the JAX tests'
    (log_w = -exp(N(0, 0.5) - 2))."""
    import numpy as np

    def n(*shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    r, kk, v = (n(b, s, h, k, scale=0.5) for _ in range(3))
    if regime == "model":
        lw = -np.exp(np.float32(-6.0) + np.float32(0.3)
                     * np.tanh(n(b, s, h, k)))
    else:
        lw = -np.exp(n(b, s, h, k, scale=0.5) - np.float32(2.0))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
            for a in (r, kk, v, lw, n(h, k, scale=0.1),
                      n(b, h, k, k, scale=0.1))]


def wkv_bound(b: int, h: int, s: int, k: int) -> dict:
    """The least time for K7's work on (B, H, S, K): per (b, h, chunk)
    the needed 4·C·K² flops (q_in @ S, the state update) + 2·C·(C-1)·K
    (att and att @ v on the strict lower triangle), run as 3xTF32 (three
    TF32 products each) at the dense TF32 rate, against r, k, v, log_w,
    u read and out and the final state written once at the memory rate
    (K7's own scratch is not counted). The fp32 term (the same flops at
    the fp32 rate, K7's earlier CUDA-core arithmetic) is reported beside
    it."""
    c = WKV_CHUNK
    flops = (4 * c * k * k + 2 * c * (c - 1) * k) * b * h * (s // c)
    nbytes = (5 * b * h * s * k + h * k + b * h * k * k) * 4
    ops_ms = WKV_FP32_PRODUCTS * flops / TF32_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "operations_ms": ops_ms, "bytes_ms": bytes_ms,
            "fp32_operations_ms": flops / FP32_FLOPS_PER_S * 1e3}


def wkv_close(torch, got, want, what: str) -> float:
    err = max_abs(got, want)
    if not torch.allclose(got, want, rtol=WKV_TOL, atol=WKV_TOL):
        raise AssertionError(f"K7 {what} != plain: max abs err {err} "
                             f"(tolerance {WKV_TOL})")
    return err


def check_wkv(torch, shape, regime: str, *, seed: int, timed: bool
              ) -> dict:
    """K7 on one (B, H, S, K) draw: ``wkv6_bhsk`` against its plain
    version on the same card tensors (S a chunk multiple), and the
    public ``ops.wkv6`` with a state0 (padding, fold-in) against the
    plain chunked scan (``ref.wkv6``) on the card, out and state each
    within WKV_TOL. ``timed``: CUDA-event times of K7 and of the plain
    version beside the bound."""
    import numpy as np
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import ops as wo
    from repro_torch.kernels.wkv6 import ref as wr

    b, h, s, k = shape
    r, kk, v, lw, u, s0 = wkv_draw(torch, np.random.default_rng(seed), b,
                                   h, s, k, regime)
    res = {"shape": [b, h, s, k], "regime": regime, "tolerance": WKV_TOL}
    errs = []
    if s % WKV_CHUNK == 0:
        x = [t.transpose(1, 2).contiguous() for t in (r, kk, v, lw)]
        out, st = wk.wkv6_bhsk(*x, u)
        torch.cuda.synchronize()
        want_o, want_s = wk.wkv6_plain(*x, u, chunk=WKV_CHUNK)
        errs += [wkv_close(torch, out, want_o, f"out at {shape}"),
                 wkv_close(torch, st, want_s, f"state at {shape}")]
        res["out_abs_max"] = float(want_o.abs().max())
        if timed:
            res.update(
                ms=time_ms(lambda: wk.wkv6_bhsk(*x, u), reps=5),
                plain_ms=time_ms(lambda: wk.wkv6_plain(
                    *x, u, chunk=WKV_CHUNK), reps=3),
                library_ms=None)
            res.update(wkv_bound(b, h, s, k))
            res["fraction_of_bound"] = res["bound_ms"] / res["ms"]
        del x, out, st, want_o, want_s
    got_o, got_s = wo.wkv6(r, kk, v, lw, u, state0=s0)
    torch.cuda.synchronize()
    ref_o, ref_s = wr.wkv6(r, kk, v, lw, u, state0=s0)
    errs += [wkv_close(torch, got_o, ref_o, f"ops out at {shape}"),
             wkv_close(torch, got_s, ref_s, f"ops state at {shape}")]
    res["max_abs_err"] = max(errs)
    return res


def wkv_geometries(torch) -> list:
    """K7 against its plain version at the prefill's shape of one layer
    (timed) and the JAX tests' shapes, in both decay regimes."""
    out = []
    for i, regime in enumerate(("model", "tests")):
        for j, shape in enumerate((WKV_PREFILL_SHAPE,) + WKV_TEST_SHAPES):
            res = check_wkv(torch, shape, regime, seed=200 + 10 * i + j,
                            timed=shape == WKV_PREFILL_SHAPE)
            log(f"[rwkv] K7 {shape} {regime} decays: == plain within "
                f"{WKV_TOL} (max abs err {res['max_abs_err']:.3g}); "
                + json.dumps(res))
            out.append(res)
        torch.cuda.empty_cache()
    return out


def rwkv_prefill(torch, params, cfg, seed: int) -> dict:
    """The main path: make_prefill_step(scan_layers=True,
    logits_positions="last") on full-width rwkv6-3b, 1 x 32,768 tokens
    from synthetic_batch cut from prefill_32k: a warm-up and
    PREFILL_REPS timed prefills, K7 once a layer in each."""
    from repro_torch.core import prng
    from repro_torch.data import pipeline
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models.common import INPUT_SHAPES
    from repro_torch.train import steps

    shape_name, b, s = RWKV_PREFILL
    batch = {k: v[:b] for k, v in pipeline.synthetic_batch(
        cfg, INPUT_SHAPES[shape_name], prng.PRNGKey(seed),
        device="cuda").items()}
    if tuple(batch["tokens"].shape) != (b, s):
        raise AssertionError(f"batch {tuple(batch['tokens'].shape)}")
    step = steps.make_prefill_step(cfg, scan_layers=True,
                                   logits_positions="last")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wk.reset_launches()
    logits = step(params, batch)
    times = []
    for _ in range(PREFILL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    launches = wk.wkv6_bhsk.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != (1 + PREFILL_REPS) * RWKV_LAYERS:
        raise AssertionError(f"K7 launched {launches} times in "
                             f"{1 + PREFILL_REPS} prefills of "
                             f"{RWKV_LAYERS} layers")
    if tuple(logits.shape) != (b, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"rwkv prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    med = sorted(times)[len(times) // 2]
    return {"arch": RWKV_ARCH, "batch": b, "seq": s, "prefill_ms": times,
            "median_ms": med, "tokens_per_s": b * s / (med / 1e3),
            "k7_launches_per_prefill": launches // (1 + PREFILL_REPS),
            "max_memory_allocated": peak,
            "logits_abs_max": float(logits.abs().max()),
            "launches": launches}


def prefill_vs_decode(torch, params, cfg, seed: int, kernel,
                      prefill_launches: int) -> dict:
    """The prefill's last-position logits against the serving path's
    bulk prefill (the token-by-token decode loop) on 1 x
    DECODE_CHECK_LEN tokens, within DECODE_LOGITS_TOL. ``kernel`` (a
    wrapper with a launch count) runs ``prefill_launches`` times in the
    prefill and never in the decode loop."""
    import numpy as np
    from repro_torch.models import transformer_scan
    from repro_torch.train import steps

    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(1, DECODE_CHECK_LEN)).astype(np.int32)).cuda()
    before = kernel.launches
    pre = steps.make_prefill_step(cfg, use_flash=True, scan_layers=True,
                                  logits_positions="last")(
        params, {"tokens": tok})
    if kernel.launches - before != prefill_launches:
        raise AssertionError(f"{cfg.arch_id}: the {DECODE_CHECK_LEN}-token "
                             f"prefill launched its kernel "
                             f"{kernel.launches - before} times")
    state = transformer_scan.init_decode_state(params, cfg, 1,
                                               DECODE_CHECK_LEN,
                                               dtype=torch.float32,
                                               device="cuda")
    before = kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bulk, _ = steps.make_bulk_prefill(cfg, scan_layers=True)(
        params, state, tok)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    if kernel.launches != before:
        raise AssertionError(f"{cfg.arch_id}: the decode loop launched "
                             "the prefill's kernel")
    err = max_abs(pre, bulk)
    if not torch.allclose(pre, bulk, rtol=DECODE_LOGITS_TOL,
                          atol=DECODE_LOGITS_TOL):
        raise AssertionError(f"{cfg.arch_id} prefill != bulk prefill "
                             f"(decode) logits: max abs err {err} "
                             f"(tolerance {DECODE_LOGITS_TOL})")
    return {"tokens": DECODE_CHECK_LEN, "logits_max_abs_err": err,
            "tolerance": DECODE_LOGITS_TOL,
            "logits_abs_max": float(bulk.abs().max()),
            "bulk_prefill_s": bulk_s,
            "bulk_ms_per_token": bulk_s / DECODE_CHECK_LEN * 1e3}


def serve_model(torch, arch: str, params, mixed_gen, kernel) -> dict:
    """Engine on a full-width model: 4 slots, 8 requests of prompt 32
    generating ``mixed_gen`` tokens in turn, greedy, fp32 decode state,
    to completion with 0 dropped; an MoE layer groups each slot's token
    alone (the JAX engine's vmapped batch-1 step). ``kernel``'s launches
    in the run are reported."""
    from repro_torch import serve
    from repro_torch.serve import engine as engine_mod

    cfg = serve.ServeConfig(arch=arch, reduced=False, slots=4,
                            n_requests=8, prompt_len=32,
                            mixed_gen=mixed_gen,
                            max_len=32 + max(mixed_gen) + 1, temperature=0)
    eng = serve.Engine(cfg, params=params, device="cuda")
    reqs = serve.synthetic_requests(cfg)
    eng.warmup([cfg.prompt_len])
    torch.cuda.synchronize()
    before = kernel.launches
    eng._t0 = time.monotonic()
    for r in reqs:
        eng.submit(r.tokens, r.max_new_tokens, rid=r.rid)
    eng.run()
    torch.cuda.synchronize()
    stats = eng.stats()
    c = eng.counters
    if (c["completed"], c["dropped"]) != (8, 0):
        raise AssertionError(f"{arch} serve run: {c}")
    for comp in eng.completions.values():
        if len(comp.tokens) != reqs[comp.rid].max_new_tokens or not all(
                0 <= t < eng.model_cfg.vocab for t in comp.tokens):
            raise AssertionError(f"{arch} request {comp.rid}: bad stream")
    state = engine_mod._clone(eng._state)
    return {"completed": c["completed"], "dropped": c["dropped"],
            "tokens_per_s": stats["tokens_per_s"],
            "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
            "decode_steps": stats["decode_steps"],
            "generated_tokens": stats["generated_tokens"],
            "wall_s": stats["wall_s"],
            "decode_step_ms": host_ms(torch, lambda: eng._serve_step(
                eng.params, state, {"tokens": eng._tokens})),
            "kernel_launches": kernel.launches - before}


def rwkv_cross_device_check(torch) -> None:
    """Reduced rwkv6-3b on the card against the CPU: the prefill (K7
    against the plain chunked scan, 2 x 300 tokens, padded), a train
    step's loss and gradients (the chunked scan on both, no K7 launch)
    and a 12-token bulk prefill (logits and every state leaf)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models import transformer_scan
    from repro_torch.train import steps

    mc = configs.get_config(RWKV_ARCH).reduced()
    params = transformer_scan.init(mc, transformer_scan.generator(5))
    gparams = pytree.tree_map(lambda t: t.cuda(), params)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, mc.vocab, size=(2, 300)).astype(np.int32))
    step = steps.make_prefill_step(mc, scan_layers=True,
                                   logits_positions="last")
    want = step(params, {"tokens": tok})
    before = wk.wkv6_bhsk.launches
    got = step(gparams, {"tokens": tok.cuda()}).cpu()
    if wk.wkv6_bhsk.launches - before != mc.n_layers:
        raise AssertionError("reduced card prefill did not run on K7")
    errs = {"prefill": max_abs(got, want)}
    if not torch.allclose(got, want, rtol=REDUCED_TOL, atol=REDUCED_TOL):
        raise AssertionError(f"reduced rwkv prefill: card != CPU (max abs "
                             f"err {errs['prefill']})")
    loss = steps.make_loss_fn(mc, steps.TrainStepConfig(scan_layers=True))
    batch = {"tokens": tok[:, :32], "labels": tok[:, 1:33]}
    want_l, want_g = steps.value_and_grad(loss, params, batch)
    before = wk.wkv6_bhsk.launches
    got_l, got_g = steps.value_and_grad(
        loss, gparams, {k: t.cuda() for k, t in batch.items()})
    if wk.wkv6_bhsk.launches != before:
        raise AssertionError("the rwkv train step launched K7 (forward-only)")
    grads = [("train loss", want_l, got_l.cpu())] + [
        ("train grads", w, g.cpu()) for w, g in
        zip(pytree.tree_leaves(want_g), pytree.tree_leaves(got_g))]
    for name, a, b in grads:
        errs[name] = max(errs.get(name, 0.0), max_abs(b, a))
        if not torch.allclose(b, a, rtol=REDUCED_TOL, atol=REDUCED_TOL):
            raise AssertionError(f"reduced rwkv {name}: card != CPU (max "
                                 f"abs err {max_abs(b, a)})")
    bulk = steps.make_bulk_prefill(mc, scan_layers=True)
    lc, sc = bulk(params, transformer_scan.init_decode_state(
        params, mc, 2, 16, dtype=torch.float32), tok[:, :12])
    lg, sg = bulk(gparams, transformer_scan.init_decode_state(
        gparams, mc, 2, 16, dtype=torch.float32), tok[:, :12].cuda())
    # the logits within REDUCED_TOL; the wkv state within WKV_TOL, the
    # JAX package's own state tolerance: a sum of outer products, its
    # rounding follows the terms' magnitude, not the element's (the two
    # devices differ by ~2.3e-5 there)
    pairs = [("logits", lc, lg.cpu(), REDUCED_TOL)]
    for part in ("prefix", "scan", "suffix"):
        for i, (dc, dg) in enumerate(zip(sc[part], sg[part])):
            pairs += [(f"{part}[{i}].{name}", t, dg[name].cpu(),
                       WKV_TOL if name == "wkv" else REDUCED_TOL)
                      for name, t in dc.items()]
    for name, a, b, tol in pairs:
        errs[name] = max_abs(b, a)
        if not torch.allclose(b, a, rtol=tol, atol=tol):
            raise AssertionError(f"reduced rwkv decode {name}: card != CPU "
                                 f"(max abs err {errs[name]}, tolerance "
                                 f"{tol})")
    log(f"[check] reduced {RWKV_ARCH} prefill (2 x 300), train step (loss "
        f"and every gradient, 2 x 32) and 12-token decode, every state "
        f"leaf: card == CPU within {REDUCED_TOL} "
        f"(wkv state {WKV_TOL}); max abs errs " + json.dumps(errs))


def rwkv_phase(torch) -> dict:
    """K7 at the prefill's and the JAX tests' shapes, then full-width
    rwkv6-3b: the prefill (the main path), the prefill against the
    decode path, serving; then a reduced card-vs-CPU check. The K7 row
    of the kernels line is K7 at the prefill's shape, model decays."""
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models import transformer_scan

    t0 = time.perf_counter()
    geoms = wkv_geometries(torch)
    cfg = configs.get_config(RWKV_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    params = transformer_scan.init(cfg, transformer_scan.generator(40,
                                                                  "cuda"))
    leaves = pytree.tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    if (n_params, len(leaves)) != (RWKV_PARAMS, RWKV_LEAVES):
        raise AssertionError(f"rwkv6-3b: {n_params} parameters in "
                             f"{len(leaves)} leaves")
    pre = rwkv_prefill(torch, params, cfg, seed=41)
    k7 = dict(next(g for g in geoms if g["shape"] == list(WKV_PREFILL_SHAPE)
                   and g["regime"] == "model"))
    k7["max_abs_err"] = max(g["max_abs_err"] for g in geoms)
    b, h, s, k = WKV_PREFILL_SHAPE
    pre.update(params=n_params, allocated_before_init=held,
               k7_ms=k7["ms"],
               k7_share=k7["ms"] * RWKV_LAYERS / pre["median_ms"],
               k7_group_chunks=wk.GROUP_CHUNKS,
               k7_scratch_bytes=wk.scratch_bytes(b, h, s, k))
    log(f"[rwkv] prefill {pre['batch']} x {pre['seq']}: median "
        f"{pre['median_ms']:.1f} ms of {[round(t, 1) for t in pre['prefill_ms']]}"
        f", {pre['tokens_per_s']:.1f} tokens/s, K7 {k7['ms']:.3f} ms x "
        f"{RWKV_LAYERS} = {100 * pre['k7_share']:.1f} % of the prefill, "
        f"K7 groups of G = {wk.GROUP_CHUNKS} chunks with "
        f"{pre['k7_scratch_bytes']} B of scratch a layer, peak "
        f"{pre['max_memory_allocated']} B (the one-block-per-(b, h) K7: "
        f"{RWKV_ONE_BLOCK_PEAK} B); " + json.dumps(pre))
    check = prefill_vs_decode(torch, params, cfg, 42, wk.wkv6_bhsk,
                              RWKV_LAYERS)
    log(f"[rwkv] prefill vs bulk prefill (decode) logits on 1 x "
        f"{DECODE_CHECK_LEN}: max abs err "
        f"{check['logits_max_abs_err']:.3g} (tolerance "
        f"{DECODE_LOGITS_TOL}); " + json.dumps(check))
    served = serve_model(torch, RWKV_ARCH, params, (8, 16), wk.wkv6_bhsk)
    log("[rwkv] serve " + json.dumps(served))
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_cross_device_check(torch)
    wall = time.perf_counter() - t0
    log(f"[rwkv] phase wall time {wall:.1f} s")
    return {"geometries": geoms, "prefill": pre, "check": check,
            "serve": served, "k7": k7, "wall_s": wall,
            "launches": {"wkv6_bhsk": pre["launches"]}}


# ---------------------------------------------------------------------------
# cluster phase (the sixth main path: the virtual cluster's replays)
# ---------------------------------------------------------------------------


def cluster_traces() -> list:
    """The phase's eight traces, scheduled on the host: (label, trace)."""
    from repro_torch import cluster
    from repro_torch.core import mixing

    n = CLUSTER_WORKERS
    spec = cluster.ClusterSpec(
        n_workers=n, t_compute=1.0,
        multipliers=cluster.straggler_multipliers(n, factor=4.0),
        t_lat=1e-2, t_tr=2e-3, size_mb=CLUSTER_SIZE_MB, codec="rq4")
    mk = cluster.make_protocol
    sync = mk("sync_ps").schedule(spec, rounds=CLUSTER_ROUNDS)
    crash = cluster.crash_restart(n, worker=1, t_down=2.0, t_up=6.0)
    byz = cluster.byzantine_workers(n, f=1, mode="sign_flip")
    out = [
        ("sync_ps", sync),
        ("async_ps", mk("async_ps").schedule(spec, horizon=sync.makespan)),
        ("local_sgd_h2", mk("local_sgd", period_h=2).schedule(spec,
                                                              rounds=2)),
        ("dsgd_ring", mk("dsgd", w=mixing.ring(n)).schedule(
            spec, rounds=CLUSTER_ROUNDS)),
        ("dcd_rq4", mk("dcd", compressor="rq4").schedule(
            spec, rounds=CLUSTER_ROUNDS)),
        ("laq", mk("laq").schedule(spec, rounds=CLUSTER_ROUNDS)),
        ("local_sgd_crash_restart", mk("local_sgd", period_h=2).schedule(
            spec, rounds=2, plan=crash)),
        ("sync_ps_byzantine_trimmed_mean",
         mk("sync_ps", aggregator="trimmed_mean").schedule(
             spec, rounds=CLUSTER_ROUNDS, plan=byz)),
    ]
    for _, tr in out:
        cluster.validate_trace(tr)
    rejoins = sum(len(r) for r in dict(out)["local_sgd_crash_restart"]
                  .extra("rejoiners"))
    if rejoins < 1:
        raise AssertionError("the crash_restart trace has no rejoin pull")
    return out


def codec_calls(tr) -> int:
    """The fused flat-codec calls (one K1 + K4 each) a replay of ``tr``
    makes, from the trace alone: every worker's gradient of a sync-PS
    round, every async and LAQ update, a round's present workers (H
    times a round in local SGD) and one checkpoint pull per rejoin."""
    n, p = tr.n_workers, tr.protocol
    if p in ("async_ps", "laq"):
        return tr.n_updates
    if p == "sync_ps":
        return tr.extra("rounds") * n
    present = tr.extra_or("present")
    if present is None:
        present = [range(n)] * tr.extra("rounds")
    steps = sum(len(rows) for rows in present)
    rejoins = tr.extra_or("rejoiners", ())
    if p == "local_sgd":
        return tr.extra("period_h") * steps + sum(len(r) for r in rejoins)
    if p in ("dsgd", "dcd"):
        return steps + sum(1 for r in rejoins for _, donor in r
                           if donor >= 0)
    raise ValueError(f"no call count for protocol {p}")


def cluster_codec_ms(torch) -> float:
    """Host-clock ms of one codec call on a full-width rq4 gradient
    (``ops.qdq_flat``: the edge pad, K1, and K4 over 31 buckets and the
    tail, drawing their uniforms)."""
    from repro_torch.core import prng
    from repro_torch.kernels.quant import ops

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(TRAIN_TOTAL, generator=g, device="cuda") * 0.01
    return host_ms(torch, lambda: ops.qdq_flat(x, prng.PRNGKey(3), bits=4),
                   reps=5)


def cluster_replay(torch, tr, wl) -> dict:
    """One full-width replay on the card: launches, wall time, peak."""
    from repro_torch import cluster
    from repro_torch.kernels.quant import kernel

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    t0 = time.perf_counter()
    res = cluster.replay(tr, wl, codec="rq4", lr=CLUSTER_LR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"res": res, "wall_s": wall, "launches": kernel.launch_counts(),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def cluster_phase(torch) -> dict:
    """The virtual-cluster tier at full width: eight traces scheduled on
    the host (sync / async PS, local SGD, DSGD, DCD, LAQ, a crash and
    rejoin, a Byzantine worker under the trimmed mean), each replayed on
    full-width repro-100m on the card through K1 + K4; then the same
    traces on small workloads on the card against the CPU, and the
    receive edge (checked_decode) on the card."""
    import numpy as np
    from repro_torch import cluster
    from repro_torch.core import compression

    t0 = time.perf_counter()
    card = smi_line()
    traces = cluster_traces()
    wl = cluster.lm_workload(smoke=False, batch=RING_BATCH, seq=RING_SEQ,
                             seed=0, device="cuda")
    total = compression.FlatLayout.from_tree(wl.params0).total
    if total != TRAIN_TOTAL:
        raise AssertionError(f"{TRAIN_ARCH}: {total} parameters")
    codec_ms = cluster_codec_ms(torch)
    log(f"[cluster] {card}; {len(traces)} traces of {CLUSTER_WORKERS} "
        f"workers, {CLUSTER_SIZE_MB} MB fp32 messages on the rq4 wire; "
        f"one codec call (K1 + K4, draws inside) on a gradient takes "
        f"{codec_ms:.3f} ms")
    rows, launches = [], {k: 0 for k in CLUSTER_KERNELS}
    for label, tr in traces:
        run = cluster_replay(torch, tr, wl)
        res = run["res"]
        calls = codec_calls(tr)
        got = {k: run["launches"][k] for k in CLUSTER_KERNELS}
        want = {"minmax_bucketed": calls, "qdq_bucketed": 2 * calls}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, the trace "
                                 f"asks {want}")
        if not np.isfinite(res.losses).all():
            raise AssertionError(f"{label}: non-finite loss {res.losses}")
        for k in CLUSTER_KERNELS:
            launches[k] += got[k]
        wall_ms = run["wall_s"] * 1e3
        row = {"replay": label, "protocol": tr.protocol,
               "updates_applied": res.updates_applied,
               "max_staleness": res.max_staleness,
               "makespan_s": res.makespan, "wall_s": run["wall_s"],
               "ms_per_update": wall_ms / res.updates_applied,
               "codec_calls": calls, "launches": got,
               "final_loss": res.final_loss,
               "losses": [float(v) for v in res.losses],
               "codec_share": calls * codec_ms / wall_ms,
               "max_memory_allocated": run["max_memory_allocated"],
               "card": card}
        log(f"[cluster] {label}: {res.updates_applied} updates, max "
            f"staleness {res.max_staleness}, makespan {res.makespan:.3f} "
            f"s simulated, {row['ms_per_update']:.1f} ms wall an update, "
            f"final loss {res.final_loss:.5f}, K1 {got['minmax_bucketed']}"
            f" K4 {got['qdq_bucketed']} (trace: {calls} codec calls), "
            f"codec {100 * row['codec_share']:.1f} %, peak "
            f"{run['max_memory_allocated']} B, {card}")
        rows.append(row)
        del run, res
    del wl
    gc.collect()
    torch.cuda.empty_cache()
    log("[cluster] " + json.dumps(rows))
    checked_decode_check(torch)
    cluster_cross_device_check(torch, traces)
    wall = time.perf_counter() - t0
    log(f"[cluster] phase wall time {wall:.1f} s")
    return {"replays": rows, "codec_ms": codec_ms, "launches": launches,
            "wall_s": wall}


def checked_decode_check(torch) -> None:
    """The receive edge on the card: checked_decode of a clean
    full-width rq4 message equals K3's decode bit for bit, and the same
    message with one bit flipped raises."""
    from repro_torch import configs
    from repro_torch.core import compression, prng
    from repro_torch.kernels.quant import kernel
    from repro_torch.models import transformer

    cfg = configs.get_config(TRAIN_ARCH)
    params = transformer.init(cfg, torch.Generator(device="cuda"
                                                   ).manual_seed(5))
    cdc = compression.codec("rq4")
    packed, crc = compression.frame(cdc.tree_encode_flat(params,
                                                         prng.PRNGKey(6)))
    del params
    before = kernel.decode_packed.launches
    got = compression.checked_decode(cdc, packed, crc)
    if kernel.decode_packed.launches - before != 2:
        raise AssertionError("checked_decode did not decode on K3")
    if not bits_equal(got, cdc.flat_decode(packed)):
        raise AssertionError("checked_decode != K3's decode")
    bad = compression.flip_bit(packed, 8 * packed.payload.numel() // 2 + 5)
    try:
        compression.checked_decode(cdc, bad, crc)
    except compression.WireCorruptionError:
        pass
    else:
        raise AssertionError("a flipped bit passed checked_decode")
    log(f"[check] checked_decode of a full-width rq4 message "
        f"({packed.wire_bytes} B): == K3's decode bit for bit; a flipped "
        "bit raises WireCorruptionError")


def cluster_cross_device_check(torch, traces) -> None:
    """The same traces on the card and on the CPU: the quadratic on the
    rq4 wire and the reduced LM on the fp32 wire within CLUSTER_TOL (the
    card's K1/K4 launches as the trace asks), the reduced LM on the rq4
    wire within CLUSTER_LM_RQ4_TOL, its codec stage given the CPU's
    gradient bit for bit."""
    import dataclasses

    import numpy as np
    from repro_torch import cluster
    from repro_torch.cluster import execute
    from repro_torch.core import compression, parallel, prng, pytree
    from repro_torch.kernels.quant import kernel

    prob = parallel.Quadratic.make(prng.PRNGKey(0), d=32,
                                   n_workers=CLUSTER_WORKERS, device="cpu")
    quad = (execute.problem_workload(prob),
            execute.problem_workload(dataclasses.replace(
                prob, a=prob.a.cuda(), b=prob.b.cuda())))
    lm_cpu = cluster.lm_workload(smoke=True, batch=2, seq=32, device="cpu")
    lm = (lm_cpu, dataclasses.replace(
        cluster.lm_workload(smoke=True, batch=2, seq=32, device="cuda"),
        params0=pytree.tree_map(lambda t: t.cuda(), lm_cpu.params0)))

    def both(tr, pair, codec, tol):
        kernel.reset_launches()
        got = cluster.replay(tr, pair[1], codec=codec, lr=CLUSTER_LR)
        counts = kernel.launch_counts()
        want = cluster.replay(tr, pair[0], codec=codec, lr=CLUSTER_LR)
        err = float(np.max(np.abs(got.losses - want.losses)
                           / np.abs(want.losses)))
        if not err <= tol or not np.isfinite(got.losses).all():
            raise AssertionError(f"{tr.protocol} {codec}: card "
                                 f"{got.losses} CPU {want.losses}")
        return err, counts

    errs = {}
    for label, tr in traces:
        err, counts = both(tr, quad, "rq4", CLUSTER_TOL)
        calls = codec_calls(tr)
        if (counts["minmax_bucketed"], counts["qdq_bucketed"]) != \
                (calls, calls):
            raise AssertionError(f"{label}: quadratic launches {counts}, "
                                 f"the trace asks {calls} each")
        errs[f"quadratic/{label}"] = err
        if tr.protocol != "dcd":     # its delta always rides rq4
            errs[f"lm_fp32/{label}"] = both(tr, lm, "none", CLUSTER_TOL)[0]
        if label in ("sync_ps", "dcd_rq4"):
            errs[f"lm_rq4/{label}"] = both(tr, lm, "rq4",
                                           CLUSTER_LM_RQ4_TOL)[0]
    key = prng.PRNGKey(9)
    g = lm_cpu.grad_fn(lm_cpu.params0, key)
    cdc = compression.codec("rq4")
    q_cpu = cdc.tree_qdq_flat(g, key)
    q_card = cdc.tree_qdq_flat(pytree.tree_map(lambda t: t.cuda(), g), key)
    if not all(bits_equal(a.cpu(), b) for a, b in zip(
            pytree.tree_leaves(q_card), pytree.tree_leaves(q_cpu))):
        raise AssertionError("the reduced LM's codec stage differs")
    log(f"[check] the {len(traces)} traces on the card against the CPU "
        f"(max relative loss difference; tolerance {CLUSTER_TOL}, "
        f"{CLUSTER_LM_RQ4_TOL} for the LM on rq4): " + json.dumps(errs)
        + "; the LM's codec stage given the CPU gradient: bit for bit")


# ---------------------------------------------------------------------------
# families phase (the seventh main path: the hybrid and MoE families)
# ---------------------------------------------------------------------------


def family_params(torch, arch: str, seed: int, dtype: str = "float32"):
    """Full-width, full-depth weights on the card, from a seed; their
    count against JAX's param_count() (FAMILY_PARAMS)."""
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.models import transformer_scan

    cfg = configs.get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    params = transformer_scan.init(
        cfg, transformer_scan.generator(seed, "cuda"),
        dtype=getattr(torch, dtype))
    n = sum(t.numel() for t in pytree.tree_leaves(params))
    if n != FAMILY_PARAMS[arch]:
        raise AssertionError(f"{arch}: {n} parameters, JAX counts "
                             f"{FAMILY_PARAMS[arch]}")
    return cfg, params


def deepseek_prefill(torch, params, cfg, seed: int) -> dict:
    """make_prefill_step(use_flash=True, scan_layers=True,
    logits_positions="last") on 1 x 4,096 tokens (one MoE group of
    MAX_GROUP, capacity 480): a warm-up and PREFILL_REPS timed
    prefills, K6 once an MLA layer (at head dims 192 / 128, since
    the MLA prefill takes flash attention on the card), peak memory."""
    from repro_torch.core import prng
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models import moe
    from repro_torch.models.common import InputShape
    from repro_torch.train import steps

    s = DEEPSEEK_SEQ
    if (moe._group_shape(s), moe._capacity(cfg.moe, s)) != \
            ((1, moe.MAX_GROUP), DEEPSEEK_CAPACITY):
        raise AssertionError("deepseek prefill grouping")
    batch = pipeline.synthetic_batch(
        cfg, InputShape("prefill_4k", s, 1, "prefill"), prng.PRNGKey(seed),
        device="cuda")
    step = steps.make_prefill_step(cfg, use_flash=True, scan_layers=True,
                                   logits_positions="last")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    logits = step(params, batch)
    times = []
    for _ in range(PREFILL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if fk.flash_attention_bhsd.launches != cfg.n_layers * (1 + PREFILL_REPS):
        raise AssertionError("the MLA prefill did not launch K6 once a "
                             "layer")
    if tuple(logits.shape) != (1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("deepseek prefill logits not finite or of "
                             "the wrong shape")
    med = sorted(times)[len(times) // 2]
    return {"arch": cfg.arch_id, "batch": 1, "seq": s, "prefill_ms": times,
            "median_ms": med, "tokens_per_s": s / (med / 1e3),
            "moe_group": moe.MAX_GROUP, "moe_capacity": DEEPSEEK_CAPACITY,
            "max_memory_allocated": peak,
            "logits_abs_max": float(logits.abs().max()),
            "launches": fk.flash_attention_bhsd.launches}


def mla_decode_check(torch, params, cfg, seed: int) -> dict:
    """Layer 0's full-width MLA: the absorbed decode, token by token
    over MLA_CHECK_LEN unit-normal inputs through an fp32 latent cache,
    against the full-sequence form, within DECODE_LOGITS_TOL."""
    from repro_torch.models import mla

    p = params["prefix_layers"][0]["mixer"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, MLA_CHECK_LEN, cfg.d_model), generator=g,
                    device="cuda")
    pos = torch.arange(MLA_CHECK_LEN, device="cuda")[None]
    full = mla.mla_attention(p, cfg, x, pos)
    cache = mla.init_cache(cfg, 1, MLA_CHECK_LEN, dtype=torch.float32,
                           device="cuda")
    outs = []
    for t in range(MLA_CHECK_LEN):
        out, cache = mla.decode_attention(p, cfg, x[:, t:t + 1], cache)
        outs.append(out)
    got = torch.cat(outs, 1)
    err = max_abs(got, full)
    if not torch.allclose(got, full, rtol=DECODE_LOGITS_TOL,
                          atol=DECODE_LOGITS_TOL):
        raise AssertionError(f"MLA absorbed decode != full sequence: max "
                             f"abs err {err}")
    return {"tokens": MLA_CHECK_LEN, "max_abs_err": err,
            "tolerance": DECODE_LOGITS_TOL,
            "abs_max": float(full.abs().max())}


def reduced_family(arch: str):
    """The reduced configuration of the CPU tests: recurrentgemma on
    (rglru, rglru, local_attn, rglru, rglru), deepseek on three layers
    (the dense prefix and two scanned MoE layers) with MLA at the head
    dims K6 builds (q.k 128 + 64, v 128)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.common import MLAConfig

    cfg = configs.get_config(arch)
    if arch == "recurrentgemma-9b":
        return dataclasses.replace(cfg.reduced(n_layers=5), block_pattern=(
            "rglru", "rglru", "local_attn", "rglru", "rglru"))
    if arch == "deepseek-v2-lite-16b":
        return dataclasses.replace(cfg.reduced(n_layers=3), mla=MLAConfig(
            kv_lora_rank=64, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    return cfg.reduced()


def families_cross_device_check(torch) -> None:
    """The five configurations reduced, on the card against the CPU: the
    flash prefill (K6 on the card once an attention or MLA layer, its
    plain version on the CPU, 2 x 300 tokens) and a train step's loss
    (cross entropy + MoE aux) and every gradient (2 x 32 tokens), within
    REDUCED_TOL."""
    import numpy as np
    from repro_torch.core import pytree
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models import transformer_scan
    from repro_torch.train import steps

    errs = {}
    for arch in FAMILY_ARCHS:
        mc = reduced_family(arch)
        params = transformer_scan.init(mc, transformer_scan.generator(5))
        gparams = pytree.tree_map(lambda t: t.cuda(), params)
        tok = torch.from_numpy(np.random.default_rng(6).integers(
            0, mc.vocab, size=(2, 300)).astype(np.int32))
        step = steps.make_prefill_step(mc, use_flash=True, scan_layers=True,
                                       logits_positions="last")
        pairs = [("prefill", step(params, {"tokens": tok}))]
        before = fk.flash_attention_bhsd.launches
        got = step(gparams, {"tokens": tok.cuda()}).cpu()
        attn = sum(k in ("attn", "local_attn", "mla")
                   for k in mc.block_pattern)
        if fk.flash_attention_bhsd.launches - before != attn:
            raise AssertionError(f"reduced {arch} prefill: K6 launches")
        loss = steps.make_loss_fn(mc, steps.TrainStepConfig(scan_layers=True))
        batch = {"tokens": tok[:, :32], "labels": tok[:, 1:33]}
        want_l, want_g = steps.value_and_grad(loss, params, batch)
        got_l, got_g = steps.value_and_grad(
            loss, gparams, {k: t.cuda() for k, t in batch.items()})
        checks = [("prefill", pairs[0][1], got), ("loss", want_l,
                                                  got_l.cpu())]
        checks += [("grads", w, g.cpu()) for w, g in zip(
            pytree.tree_leaves(want_g), pytree.tree_leaves(got_g))]
        for name, a, b in checks:
            key = f"{arch} {name}"
            errs[key] = max(errs.get(key, 0.0), max_abs(b, a))
            if not torch.allclose(b, a, rtol=REDUCED_TOL, atol=REDUCED_TOL):
                raise AssertionError(f"reduced {arch} {name}: card != CPU "
                                     f"(max abs err {max_abs(b, a)})")
    log(f"[check] the five family configs reduced: flash prefill (2 x "
        f"300), train loss with the MoE aux and every gradient (2 x 32): "
        f"card == CPU within {REDUCED_TOL}; max abs errs "
        + json.dumps(errs))


def families_phase(torch) -> dict:
    """recurrentgemma-9b and deepseek-v2-lite-16b at full width and
    depth: the prefill (the main path), its check against the decode
    path, serving; qwen2.5-14b (fp32) and command-r-35b (bf16) flash
    prefills; then the five configs reduced, card against CPU. K6's
    launches on the phase's main paths (reset before each, read after)
    are summed in ``launches``."""
    from repro_torch.kernels.flash_attn import kernel as fk

    t0 = time.perf_counter()
    k6 = 0
    out = {}

    cfg, params = family_params(torch, "recurrentgemma-9b", seed=50)
    rg = prefill_model(torch, "recurrentgemma-9b", None, 1, FAMILY_SEQ,
                       cfg.n_layers, seed=51, params=params)
    k6 += rg["launches"]
    if rg["k6_launches_per_prefill"] != RG_LOCAL_LAYERS:
        raise AssertionError("recurrentgemma-9b: K6 not once per local "
                             "attention layer")
    rg["vs_decode"] = prefill_vs_decode(torch, params, cfg, 52,
                                        fk.flash_attention_bhsd,
                                        RG_LOCAL_LAYERS)
    log(f"[families] recurrentgemma-9b prefill vs bulk prefill (decode) "
        f"logits on 1 x {DECODE_CHECK_LEN}: max abs err "
        f"{rg['vs_decode']['logits_max_abs_err']:.3g} (tolerance "
        f"{DECODE_LOGITS_TOL}); " + json.dumps(rg["vs_decode"]))
    rg["serve"] = serve_model(torch, "recurrentgemma-9b", params,
                              FAMILY_GEN, fk.flash_attention_bhsd)
    log("[families] recurrentgemma-9b serve " + json.dumps(rg["serve"]))
    out["recurrentgemma-9b"] = rg
    del params

    cfg, params = family_params(torch, "deepseek-v2-lite-16b", seed=53)
    ds = deepseek_prefill(torch, params, cfg, seed=54)
    k6 += ds["launches"]
    log(f"[families] deepseek-v2-lite-16b prefill 1 x {DEEPSEEK_SEQ}: "
        f"median {ds['median_ms']:.1f} ms, {ds['tokens_per_s']:.1f} "
        f"tokens/s, peak {ds['max_memory_allocated']} B; "
        + json.dumps(ds))
    ds["mla_decode"] = mla_decode_check(torch, params, cfg, seed=55)
    log(f"[families] deepseek-v2-lite-16b layer 0 MLA absorbed decode vs "
        f"full sequence over {MLA_CHECK_LEN} tokens: max abs err "
        f"{ds['mla_decode']['max_abs_err']:.3g} (tolerance "
        f"{DECODE_LOGITS_TOL})")
    ds["serve"] = serve_model(torch, "deepseek-v2-lite-16b", params,
                              FAMILY_GEN, fk.flash_attention_bhsd)
    log("[families] deepseek-v2-lite-16b serve " + json.dumps(ds["serve"]))
    out["deepseek-v2-lite-16b"] = ds
    del params

    for arch, dtype, seed in (("qwen2.5-14b", "float32", 56),
                              ("command-r-35b", "bfloat16", 58)):
        cfg, params = family_params(torch, arch, seed=seed, dtype=dtype)
        run = prefill_model(torch, arch, None, 1, FAMILY_SEQ, cfg.n_layers,
                            seed=seed + 1, dtype=dtype, params=params)
        del params
        k6 += run["launches"]
        out[arch] = run
    gc.collect()
    torch.cuda.empty_cache()
    families_cross_device_check(torch)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {"flash_attention_bhsd": k6}
    log(f"[families] phase wall time {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# leaf phase (the eighth main path: the per-leaf codec tier)
# ---------------------------------------------------------------------------


def check_leaf(torch, n: int, bits: int, seed: int, *, rows: int = 2,
               special: bool = False, repeat: bool = False) -> dict:
    """K4, K2 and K3 as per-leaf launches over ``rows`` workers' leaves of
    n elements, each drawing under its worker's key (with ``repeat`` the
    last leaf a copy of the first under the same key), against their
    plain versions on the same card tensors (and the params against the
    plain per-leaf ``ref.quant_params``), bit for bit; returns
    max_abs_err per kernel."""
    from repro_torch.core import prng
    from repro_torch.kernels.quant import kernel, ops, ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, n), generator=g, device="cuda") * 0.02
    if special:
        x[0, 3], x[0, n - 2] = math.inf, -math.inf
        x[rows - 1, 5] = math.nan
    keys = [prng.PRNGKey(seed + i) for i in range(rows)]
    if repeat:
        x[rows - 1] = x[0]
        keys[rows - 1] = keys[0]
    x4, params = ops._leaf_rows(x, keys, bits=bits)
    for i in range(rows):
        lo, scale = ref.quant_params(x[i], bits)
        if not same_bits(params[i], torch.stack([lo, scale])):
            raise AssertionError(f"leaf params != ref.quant_params (n={n})")
    lo, scale = params[:, 0], params[:, 1]
    q = kernel.leaf_qdq(x4, keys, params, bits=bits)
    want_q = ref.qdq_keyed(x4, keys, lo, scale, bits=bits)
    pay = kernel.leaf_encode_packed(x4, keys, params, bits=bits)
    want_pay = ref.encode_packed_keyed(x4, keys, lo, scale, bits=bits)
    dec = kernel.leaf_decode_packed(pay, params, bits=bits)
    want_dec = ref.decode_packed_bucketed(pay, lo, scale, bits=bits)
    if not (same_bits(q, want_q) and bits_equal(pay, want_pay)
            and same_bits(dec, want_dec) and same_bits(dec, q)):
        raise AssertionError(f"per-leaf K2/K3/K4 != plain (n={n}, "
                             f"bits={bits}, special={special}, "
                             f"repeat={repeat})")
    if repeat and not (bits_equal(q[0], q[rows - 1])
                       and bits_equal(pay[0], pay[rows - 1])):
        raise AssertionError(f"per-leaf K2/K4: a repeated key drew other "
                             f"uniforms (n={n}, bits={bits})")
    return {"leaf_qdq": max_abs(q, want_q),
            "leaf_encode_packed": max_abs(pay.float(), want_pay.float()),
            "leaf_decode_packed": max_abs(dec, want_dec)}


def time_leaf(torch, n: int, seed: int) -> dict:
    """rq4 CUDA-event times of the three per-leaf launches on ONE leaf of
    n elements (B = 1) beside their plain versions and the bound: the
    bytes (LEAF_BYTES_PER_ELEM over the zero-padded leaf, plus the
    params), for K4 and K2 against their Threefry's integer
    instructions, whichever is larger."""
    from repro_torch.core import prng
    from repro_torch.kernels.quant import kernel, ops, ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, n), generator=g, device="cuda") * 0.02
    keys = [prng.PRNGKey(seed)]
    x4, params = ops._leaf_rows(x, keys, bits=4)
    lo, scale = params[:, 0], params[:, 1]
    pay = kernel.leaf_encode_packed(x4, keys, params, bits=4)
    fns = {"leaf_qdq": (lambda: kernel.leaf_qdq(x4, keys, params, bits=4),
                        lambda: ref.qdq_keyed(x4, keys, lo, scale, bits=4)),
           "leaf_encode_packed": (
               lambda: kernel.leaf_encode_packed(x4, keys, params, bits=4),
               lambda: ref.encode_packed_keyed(x4, keys, lo, scale,
                                               bits=4)),
           "leaf_decode_packed": (
               lambda: kernel.leaf_decode_packed(pay, params, bits=4),
               lambda: ref.decode_packed_bucketed(pay, lo, scale, bits=4))}
    out = {}
    for name, (k, plain) in fns.items():
        nbytes = x4.numel() * LEAF_BYTES_PER_ELEM[name] + 8
        bound = ({"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                  "bound_by": "bytes"} if name == "leaf_decode_packed"
                 else threefry_bound(x4.numel(), nbytes))
        out[name] = {"ms": time_ms(k), "plain_ms": time_ms(plain),
                     "library_ms": None, **bound, "elems": n,
                     "padded": x4.numel()}
    return out


def leaf_geometry_bytes(layout, bits: int) -> float:
    """One worker's per-leaf message bytes of the whole tree, from the
    geometry: each leaf ceil(n / (pack * 512)) payload rows of 512 bytes
    plus its 8-byte params row (JAX's tree_wire_bytes)."""
    from repro_torch.kernels.quant import ops
    return float(sum(ops.leaf_payload_rows(n, bits=bits) * ops.LANES + 8
                     for n in layout.sizes))


def leaf_run(torch, name: str, compressor: str, params0, loss_fn,
             make_batch, eval_batch, n_leaves: int) -> dict:
    """LEAF_STEPS steps of run_distributed over RING_WORKERS stacked
    full-width workers with ``name`` at flat=False: finite losses, the
    per-leaf launches a step as the arithmetic gives them (the ring N L
    K2 and N L K3; the PS and ECSGD 2 L K4; nothing else of the codec),
    comm bytes from the geometry, step time, tokens/s, peak memory."""
    from repro_torch.core import communicators, compression, parallel
    from repro_torch.kernels.quant import kernel
    from repro_torch.train import steps

    n = RING_WORKERS
    inner = communicators.make_exchange(name, compressor=compressor,
                                        flat=False)
    bits = compression.codec(compressor).bits
    layout = compression.FlatLayout.from_tree(params0)
    hops = n - 1 if name == "csgd_ring" else 2
    comm = inner.message_bytes(params0, n_workers=n)
    if comm != hops * leaf_geometry_bytes(layout, bits):
        raise AssertionError(f"{name}: message_bytes {comm}")
    if name == "csgd_ring":
        want = {"leaf_encode_packed": n * n_leaves,
                "leaf_decode_packed": n * n_leaves}
    else:
        want = {"leaf_qdq": 2 * n_leaves}
    ex = CountingExchange(inner)
    marks = []

    def sample_batch(key, worker):
        if worker == 0:
            torch.cuda.synchronize()
            marks.append(["start", time.perf_counter()])
        return make_batch(key)

    def full_loss(p):
        torch.cuda.synchronize()
        marks.append(["end", time.perf_counter()])
        return loss_fn(p, eval_batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    res = parallel.run_distributed(
        loss_fn, full_loss,
        lambda p: steps.value_and_grad(loss_fn, p, eval_batch)[1], params0,
        sample_batch, n_workers=n, steps=LEAF_STEPS, lr=RING_LR,
        exchange=ex, seed=RING_SEED, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in kernel.launch_counts().items() if v}
    for t, (per, _) in enumerate(ex.calls):
        got = {k: v for k, v in per.items() if v}
        if got != want:
            raise AssertionError(f"{name} step {t}: launches {got}, the "
                                 f"arithmetic gives {want}")
    losses = [float(v) for v in res.losses]
    cons = [float(v) for v in res.consensus]
    if not all(math.isfinite(v) for v in losses + cons):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    if name != "csgd_ring" and any(c != 0.0 for c in cons):
        raise AssertionError(f"{name}: consensus {cons}")
    step_ms = [(e[1] - s[1]) * 1e3 for s, e in zip(marks[0::2], marks[1::2])]
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    out = {"exchange": name, "compressor": compressor, "flat": False,
           "workers": n, "steps": LEAF_STEPS, "losses": losses,
           "consensus": cons, "step_ms": step_ms, "median_step_ms": med,
           "exchange_ms": [ms for _, ms in ex.calls],
           "tokens_per_s": n * RING_BATCH * RING_SEQ / (med / 1e3),
           "max_memory_allocated": peak, "comm_bytes_per_step": comm,
           "launches_per_step": want, "launches": launches}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def leaf_breakdown(torch, loss_fn, params0, make_batch) -> dict:
    """Where a per-leaf step's time goes, each piece timed alone on the
    host clock around a synchronize: one worker's forward + backward,
    and each per-leaf kernel launched over every leaf for the 4 workers
    (K4 and K2 drawing each worker's uniforms under its key)."""
    from repro_torch.core import prng, pytree
    from repro_torch.kernels.quant import kernel, ops
    from repro_torch.train import steps

    n = RING_WORKERS
    batch = make_batch(prng.PRNGKey(78))
    g = steps.value_and_grad(loss_fn, params0, batch)[1]
    leaves = pytree.tree_leaves(g)
    keys = prng.split(prng.PRNGKey(79), len(leaves))
    wkeys = [[prng.fold_in(keys[j], i) for i in range(n)]
             for j in range(len(leaves))]
    views = [ops._leaf_rows(leaf.unsqueeze(0).expand((n,) + tuple(
        leaf.shape)), wkeys[j], bits=4) for j, leaf in enumerate(leaves)]
    pays = [kernel.leaf_encode_packed(x4, k, p, bits=4)
            for (x4, p), k in zip(views, wkeys)]

    out = {
        "fwd_bwd_per_worker_ms": host_ms(torch, lambda: steps.value_and_grad(
            loss_fn, params0, batch), reps=3),
        "k4_all_leaves_ms": host_ms(torch, lambda: [
            kernel.leaf_qdq(x4, k, p, bits=4)
            for (x4, p), k in zip(views, wkeys)]),
        "k2_all_leaves_ms": host_ms(torch, lambda: [
            kernel.leaf_encode_packed(x4, k, p, bits=4)
            for (x4, p), k in zip(views, wkeys)]),
        "k3_all_leaves_ms": host_ms(torch, lambda: [
            kernel.leaf_decode_packed(pay, p, bits=4)
            for pay, (_, p) in zip(pays, views)]),
        "params_all_leaves_ms": host_ms(torch, lambda: [
            ops.leaf_params(leaf.reshape(1, -1).expand(n, -1), bits=4)
            for leaf in leaves]),
        "leaves": len(leaves),
    }
    del views, pays, g
    torch.cuda.empty_cache()
    return out


def leaf_cross_device_check(torch) -> None:
    """A reduced per-leaf rq4 ring (N = 4) on the card equals the CPU's
    bit for bit, as does one odd-sized leaf's encode and an Inf/NaN
    leaf's qdq through the ops entry points (draws and params included)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import communicators, prng, pytree
    from repro_torch.kernels.quant import ops
    from repro_torch.models import transformer

    mc = configs.get_config(TRAIN_ARCH).reduced(n_layers=2, d_model=128,
                                                vocab=512)
    p = transformer.init(mc, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    g = pytree.tree_map(lambda t: torch.from_numpy(
        (rng.normal(size=(4,) + tuple(t.shape)) * 0.01).astype(np.float32)),
        p)
    ring = communicators.CSGDRingExchange(compressor="rq4", flat=False)
    want, _ = ring(g, (), prng.PRNGKey(6))
    got, _ = ring(pytree.tree_map(lambda t: t.cuda(), g), (),
                  prng.PRNGKey(6))
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        if not bits_equal(a.cpu(), b):
            raise AssertionError("reduced per-leaf ring: card != CPU")
    x = torch.from_numpy((rng.normal(size=LEAF_ODD) * 0.1).astype(
        np.float32))
    x[7], x[100] = math.inf, math.nan
    for bits in (8, 4, 2):
        pc, qc = ops.encode(x.cuda(), prng.PRNGKey(bits), bits=bits)
        pw, qw = ops.encode(x, prng.PRNGKey(bits), bits=bits)
        if not (torch.equal(pc.cpu(), pw) and same_bits(qc.cpu(), qw)
                and same_bits(ops.quantize_dequantize(
                    x.cuda(), prng.PRNGKey(bits), bits=bits).cpu(),
                    ops.quantize_dequantize(x, prng.PRNGKey(bits),
                                            bits=bits))):
            raise AssertionError(f"per-leaf entry points bits={bits}: "
                                 "card != CPU")
    log(f"[check] reduced per-leaf rq4 ring (N = 4, "
        f"{len(pytree.tree_leaves(g))} leaves) and a {LEAF_ODD}-element "
        "Inf/NaN leaf's encode and qdq at bits 8/4/2: card == CPU bit for "
        "bit")


def leaf_phase(torch, flat_ring_ms: float) -> dict:
    """The per-leaf kernels against their plain versions at repro-100m's
    leaf sizes, an odd size and an Inf/NaN leaf; their times at rq4;
    then the per-leaf ring, PS and ECSGD on 4 stacked full-width
    workers (the main path), a breakdown, and a reduced card vs CPU
    check. ``flat_ring_ms`` is the ring phase's partitioned flat ring
    step, printed beside the per-leaf ring's."""
    from repro_torch.core import compression

    t0 = time.perf_counter()
    errs: dict = {}
    for n in LEAF_SIZES + (LEAF_ODD,):
        for bits in (8, 4, 2):
            for special in (False, True):
                res = check_leaf(torch, n, bits, seed=n % 997 + bits,
                                 special=special)
                for k, v in res.items():
                    errs[k] = max(errs.get(k, 0.0), v)
    for bits in (8, 4, 2):
        res = check_leaf(torch, LEAF_ODD, bits, seed=60 + bits, rows=3,
                         repeat=True)
        for k, v in res.items():
            errs[k] = max(errs.get(k, 0.0), v)
    log(f"[leaf] K4, K2, K3 as per-leaf launches over 2 workers' leaves at "
        f"{list(LEAF_SIZES)} and {LEAF_ODD} elements, bits 8/4/2, with and "
        "without Inf/NaN, and over 3 leaves whose first and last share a "
        "key: bit-identical to plain, K4 and K2 drawing on the card")
    timing = time_leaf(torch, LEAF_SIZES[-1], seed=41)
    floor = time_leaf(torch, LEAF_SIZES[0], seed=42)
    for name in LEAF_KERNELS:
        timing[name]["max_abs_err"] = errs[name]
        timing[name]["launch_floor_ms"] = floor[name]["ms"]
        timing[name]["launch_floor_plain_ms"] = floor[name]["plain_ms"]
    log(f"[leaf] rq4 times at the {LEAF_SIZES[-1]}-element leaf (and the "
        f"{LEAF_SIZES[0]}-element leaf's, the launch floor) "
        + json.dumps(timing))
    torch.cuda.empty_cache()

    params0, loss_fn, make_batch, eval_batch = ring_problem(torch, "cuda")
    layout = compression.FlatLayout.from_tree(params0)
    if (len(layout.sizes), sorted(set(layout.sizes))) != \
            (LEAF_LEAVES, sorted(LEAF_SIZES)):
        raise AssertionError(f"{TRAIN_ARCH}: {len(layout.sizes)} leaves of "
                             f"sizes {sorted(set(layout.sizes))}")
    runs = {}
    launches: dict = {}
    for name, compressor in LEAF_RUNS:
        run = leaf_run(torch, name, compressor, params0, loss_fn,
                       make_batch, eval_batch, LEAF_LEAVES)
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = run
        log(f"[leaf] {name} {compressor} flat=False: median step "
            f"{run['median_step_ms']:.1f} ms, tokens/s "
            f"{run['tokens_per_s']:.1f}, consensus {run['consensus']}, "
            f"peak {run['max_memory_allocated']} B; " + json.dumps(run))
    log(f"[leaf] the ring step at full width, 4 workers: per-leaf rq4 "
        f"({LEAF_LEAVES} leaves, {runs['csgd_ring']['median_step_ms']:.1f} "
        f"ms) "
        f"against the partitioned flat ring ({flat_ring_ms:.1f} ms, ring "
        f"phase): x{runs['csgd_ring']['median_step_ms'] / flat_ring_ms:.2f}")
    log("[leaf] breakdown " + json.dumps(leaf_breakdown(
        torch, loss_fn, params0, make_batch)))
    del params0
    gc.collect()
    torch.cuda.empty_cache()
    leaf_cross_device_check(torch)
    for name in LEAF_KERNELS:
        launches.setdefault(name, 0)
    out = {"timing": timing, "runs": runs, "launches": launches,
           "flat_ring_ms": flat_ring_ms,
           "wall_s": time.perf_counter() - t0}
    log(f"[leaf] phase wall time {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# kv phase (the ninth main path: the unrolled decode and the int8 KV cache)
# ---------------------------------------------------------------------------


def stacked_like_scan(torch, params, cfg) -> dict:
    """An unrolled parameter tree as the scanned one: the repeating
    unit's layers stacked on a leading n_rep dim (the same weights)."""
    from repro_torch.core import pytree
    from repro_torch.models import transformer_scan

    prefix, unit, n_rep, suffix = transformer_scan.pattern_segments(cfg)
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["prefix_layers"] = layers[:len(prefix)]
    out["scan_blocks"] = [
        pytree.tree_map(lambda *xs: torch.stack(xs),
                        *[layers[len(prefix) + r * len(unit) + j]
                          for r in range(n_rep)])
        for j in range(len(unit))] if n_rep else []
    out["suffix_layers"] = layers[len(prefix) + n_rep * len(unit):]
    return out


def kv_decode(torch, impl, params, cfg, tokens, *, batch: int, slots: int,
              gen: int, quantize_kv: bool, feed=None) -> dict:
    """A bulk prefill of ``tokens`` into a fresh decode state of ``slots``
    (bf16 K/V, or int8 with ``quantize_kv``) and ``gen`` steps, greedy or
    fed the tokens of ``feed``: the logits of every step, the tokens,
    the prefill and per-step host times (synchronized), and the state's
    K/V (+ scale) bytes and allocated-memory delta."""
    from repro_torch.models import transformer_scan
    from repro_torch.train import steps

    scan = impl is transformer_scan
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = impl.init_decode_state(params, cfg, batch, slots,
                                   quantize_kv=quantize_kv)
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    blocks = state["layers"] if "layers" in state else \
        state["prefix"] + state["scan"] + state["suffix"]
    kv_bytes = sum(b[k].numel() * b[k].element_size() for b in blocks
                   for k in ("k", "v", "k_scale", "v_scale") if k in b)
    bulk = steps.make_bulk_prefill(cfg, scan_layers=scan)
    step = steps.make_serve_step(cfg, scan_layers=scan)
    t0 = time.perf_counter()
    logits, state = bulk(params, state, tokens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    all_logits, toks, step_ms = [logits], [], []
    for i in range(gen):
        nxt = feed[i] if feed is not None else logits.argmax(-1, keepdim=True)
        toks.append(nxt)
        t0 = time.perf_counter()
        logits, state = step(params, state, {"tokens": nxt})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        all_logits.append(logits)
    if not all(bool(torch.isfinite(x).all()) for x in all_logits):
        raise AssertionError(f"{cfg.arch_id}: non-finite decode logits")
    del state
    return {"logits": all_logits, "tokens": toks, "prefill_ms": prefill_ms,
            "step_ms": step_ms,
            "median_step_ms": sorted(step_ms)[len(step_ms) // 2],
            "kv_bytes": kv_bytes, "alloc_delta": delta}


def kv_summary(run: dict) -> dict:
    return {k: run[k] for k in ("prefill_ms", "median_step_ms", "kv_bytes",
                                "alloc_delta")}


def kv_cross_device_check(torch) -> None:
    """The five families reduced on the unrolled tree, card against
    CPU: an 8-token bulk prefill and 4 steps on the fp32 cache within
    REDUCED_TOL and on the int8 cache within KV_REDUCED_INT8_REL of the
    logits' scale, over every block kind (attn, local_attn, mla, rglru,
    rwkv; dense and MoE FFN)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.models import transformer
    from repro_torch.train import steps

    errs = {}
    for arch in KV_REDUCED_ARCHS:
        mc = (reduced_family(arch) if arch in FAMILY_ARCHS
              else configs.get_config(arch).reduced())
        params = transformer.init(mc, torch.Generator().manual_seed(8))
        gparams = pytree.tree_map(lambda t: t.cuda(), params)
        tok = torch.from_numpy(np.random.default_rng(9).integers(
            0, mc.vocab, size=(2, 12)).astype(np.int32))
        bulk, step = steps.make_bulk_prefill(mc), steps.make_serve_step(mc)
        for q in (False, True):
            mk = lambda p: transformer.init_decode_state(  # noqa: E731
                p, mc, 2, 16, dtype=torch.float32, quantize_kv=q)
            lc, sc = bulk(params, mk(params), tok[:, :8])
            lg, sg = bulk(gparams, mk(gparams), tok[:, :8].cuda())
            pairs = [(lg, lc)]
            for i in range(8, 12):
                lc, sc = step(params, sc, {"tokens": tok[:, i:i + 1]})
                lg, sg = step(gparams, sg, {"tokens": tok[:, i:i + 1].cuda()})
                pairs.append((lg, lc))
            err = max(max_abs(g.cpu(), c) for g, c in pairs)
            scale = max(float(c.abs().max()) for _, c in pairs)
            errs[f"{arch} {'int8' if q else 'fp32'}"] = err
            ok = err <= KV_REDUCED_INT8_REL * scale if q else all(
                torch.allclose(g.cpu(), c, rtol=REDUCED_TOL, atol=REDUCED_TOL)
                for g, c in pairs)
            if not ok:
                raise AssertionError(f"reduced {arch} unrolled decode "
                                     f"(int8 {q}): card != CPU, max abs err "
                                     f"{err}")
    log(f"[check] the five families reduced, unrolled decode (8-token bulk "
        f"prefill + 4 steps): card == CPU within {REDUCED_TOL} (fp32 cache) "
        f"and {KV_REDUCED_INT8_REL} of the logits' scale (int8 cache); max "
        "abs errs " + json.dumps(errs))


def kv_phase(torch) -> dict:
    """Full-width qwen1.5-0.5b on the unrolled tree: bulk prefill and
    greedy decode on the bf16 and the int8 cache, and the scanned form on
    the same weights; full-width granite-8b's 32,768-slot caches and
    their bytes; then the reduced families card vs CPU."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import transformer, transformer_scan

    t0 = time.perf_counter()
    out = {}
    cfg = configs.get_config(KV_ARCH)
    params = transformer.init(cfg, transformer_scan.generator(60, "cuda"))
    tok = torch.from_numpy(np.random.default_rng(61).integers(
        0, cfg.vocab, size=(KV_BATCH, KV_PROMPT)).astype(np.int32)).cuda()
    kw = dict(batch=KV_BATCH, slots=KV_SLOTS, gen=KV_GEN)
    bf16 = kv_decode(torch, transformer, params, cfg, tok, quantize_kv=False,
                     **kw)
    int8 = kv_decode(torch, transformer, params, cfg, tok, quantize_kv=True,
                     feed=bf16["tokens"], **kw)
    sparams = stacked_like_scan(torch, params, cfg)
    del params
    scan = kv_decode(torch, transformer_scan, sparams, cfg, tok,
                     quantize_kv=False, feed=bf16["tokens"], **kw)
    del sparams
    unroll_err = max(max_abs(a, b) for a, b in zip(bf16["logits"],
                                                   scan["logits"]))
    if not all(torch.allclose(a, b, rtol=KV_UNROLL_TOL, atol=KV_UNROLL_TOL)
               for a, b in zip(bf16["logits"], scan["logits"])):
        raise AssertionError(f"{KV_ARCH}: unrolled != scanned decode logits "
                             f"(max abs err {unroll_err})")
    rel = max(float((a - b).abs().max() / a.abs().max())
              for a, b in zip(bf16["logits"], int8["logits"]))
    if not KV_INT8_FLOOR < rel < KV_INT8_REL:
        raise AssertionError(f"{KV_ARCH}: int8 cache logits {rel} relative "
                             f"from the bf16 cache's")
    agree = float(np.mean([bool((a.argmax(-1) == b.argmax(-1)).all())
                           for a, b in zip(bf16["logits"], int8["logits"])]))
    out[KV_ARCH] = {"batch": KV_BATCH, "prompt": KV_PROMPT,
                    "slots": KV_SLOTS, "gen": KV_GEN,
                    "bf16": kv_summary(bf16), "int8": kv_summary(int8),
                    "scan_bf16": kv_summary(scan),
                    "unrolled_vs_scan_max_abs_err": unroll_err,
                    "int8_vs_bf16_rel": rel,
                    "int8_greedy_agreement": agree}
    log(f"[kv] {KV_ARCH} unrolled {KV_BATCH} x {KV_PROMPT} prompt, "
        f"{KV_GEN} steps: decode step {bf16['median_step_ms']:.1f} ms "
        f"(bf16 cache), {int8['median_step_ms']:.1f} ms (int8), scanned "
        f"{scan['median_step_ms']:.1f} ms; unrolled vs scanned max abs err "
        f"{unroll_err:.3g}; int8 vs bf16 {rel:.4g} of the logits' scale; "
        + json.dumps(out[KV_ARCH]))
    del bf16, int8, scan
    gc.collect()
    torch.cuda.empty_cache()

    cfg = configs.get_config(GRANITE_ARCH)
    params = transformer.init(cfg, transformer_scan.generator(62, "cuda"))
    tok = torch.from_numpy(np.random.default_rng(63).integers(
        0, cfg.vocab, size=(1, GRANITE_PROMPT)).astype(np.int32)).cuda()
    runs = {}
    for q in (False, True):
        run = kv_decode(torch, transformer, params, cfg, tok, batch=1,
                        slots=GRANITE_SLOTS, gen=GRANITE_GEN, quantize_kv=q)
        if run["kv_bytes"] != GRANITE_KV_BYTES[q]:
            raise AssertionError(f"{GRANITE_ARCH} (int8 {q}): K/V bytes "
                                 f"{run['kv_bytes']}, the geometry gives "
                                 f"{GRANITE_KV_BYTES[q]}")
        runs["int8" if q else "bf16"] = kv_summary(run)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out[GRANITE_ARCH] = {"slots": GRANITE_SLOTS, "prompt": GRANITE_PROMPT,
                         "gen": GRANITE_GEN, **runs}
    log(f"[kv] {GRANITE_ARCH} 1 x {GRANITE_SLOTS} slots: K/V bytes "
        f"{runs['bf16']['kv_bytes']} (bf16) and {runs['int8']['kv_bytes']} "
        f"(int8 + scales); " + json.dumps(out[GRANITE_ARCH]))
    kv_cross_device_check(torch)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[kv] phase wall time {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# frontends phase (the tenth main path: M-RoPE and the encoder-decoder)
# ---------------------------------------------------------------------------


def mrope_grid(text: int, grid: tuple, s: int):
    """(3, s) int32 Qwen2-VL position ids: ``text`` text positions
    (t = h = w = i), a rows x cols patch grid at t = ``text``, h = ``text``
    + row, w = ``text`` + col, then text ids from ``text`` + max(rows,
    cols) on (the next id after the grid's largest)."""
    import numpy as np
    rows, cols = grid
    n = rows * cols
    if s < text + n:
        raise ValueError(f"{s} positions hold no {text} + {n}")
    axes = (np.full(n, text), text + np.repeat(np.arange(rows), cols),
            text + np.tile(np.arange(cols), rows))
    tail = text + max(rows, cols) + np.arange(s - text - n)
    return np.stack([np.concatenate([np.arange(text), a, tail])
                     for a in axes]).astype(np.int32)


def vl_config():
    """qwen2-vl-72b at full width, cut to VL_LAYERS layers."""
    import dataclasses
    from repro_torch import configs

    cfg = configs.get_config(VL_ARCH)
    if cfg.n_layers != VL_FULL_LAYERS:
        raise AssertionError(f"{VL_ARCH}: {cfg.n_layers} layers")
    return dataclasses.replace(cfg, n_layers=VL_LAYERS,
                               block_pattern=("attn",) * VL_LAYERS)


def frontend_params(torch, cfg, seed: int, dtype, n_params: int):
    """Weights on the card from a seed, counted against JAX's count."""
    from repro_torch.core import pytree
    from repro_torch.models import transformer_scan

    gc.collect()
    torch.cuda.empty_cache()
    params = transformer_scan.init(
        cfg, transformer_scan.generator(seed, "cuda"), dtype=dtype)
    n = sum(t.numel() for t in pytree.tree_leaves(params))
    if n != n_params:
        raise AssertionError(f"{cfg.arch_id}: {n} parameters, JAX counts "
                             f"{n_params}")
    return params


def vl_decode(torch, params, cfg, seed: int) -> dict:
    """A 1 x VL_DECODE_LEN text prompt of stub embeddings fed one a step
    through make_serve_step (bf16 cache, M-RoPE at text positions) against
    the flash prefill of the same embeddings (relative L2 <=
    BF16_PREFILL_TOL), then VL_GEN greedy token steps; step times against
    the bytes a step must read (every weight but the embedding table's
    other rows, and the cache)."""
    from repro_torch.core import pytree
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models import transformer_scan
    from repro_torch.train import steps

    g = torch.Generator(device="cuda").manual_seed(seed)
    emb = (torch.randn((1, VL_DECODE_LEN, cfg.d_model), generator=g,
                       device="cuda") * 0.02).bfloat16()
    before = fk.flash_attention_bhsd.launches
    pre = steps.make_prefill_step(cfg, use_flash=True, scan_layers=True,
                                  logits_positions="last")(
        params, {"embeddings": emb})
    if fk.flash_attention_bhsd.launches - before != cfg.n_layers:
        raise AssertionError(f"{VL_ARCH}: the {VL_DECODE_LEN}-embedding "
                             "prefill did not launch K6 once a layer")
    state = transformer_scan.init_decode_state(
        params, cfg, 1, VL_DECODE_LEN + VL_GEN, device="cuda")
    step = steps.make_serve_step(cfg, scan_layers=True)
    before = fk.flash_attention_bhsd.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(VL_DECODE_LEN):
        logits, state = step(params, state, {"embeddings": emb[:, i:i + 1]})
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    got, want = logits.float(), pre.float()
    rel = float((got - want).norm() / want.norm())
    if fk.flash_attention_bhsd.launches != before:
        raise AssertionError(f"{VL_ARCH}: the decode launched K6")
    if not rel <= BF16_PREFILL_TOL:
        raise AssertionError(f"{VL_ARCH}: the decode fed the prompt's "
                             f"embeddings gives logits {rel} (relative L2) "
                             f"from the prefill's")
    step_ms, tok = [], logits.argmax(-1, keepdim=True)
    for _ in range(VL_GEN):
        t0 = time.perf_counter()
        logits, state = step(params, state, {"tokens": tok})
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{VL_ARCH}: non-finite decode logits")
    leaves = pytree.tree_leaves(params)
    weights = sum(t.numel() * t.element_size() for t in leaves) - \
        params["embed"].numel() * params["embed"].element_size() + \
        cfg.d_model * params["embed"].element_size()
    cache = sum(t.numel() * t.element_size()
                for t in pytree.tree_leaves(state)
                if isinstance(t, torch.Tensor))
    med = sorted(step_ms)[len(step_ms) // 2]
    return {"prompt": VL_DECODE_LEN, "gen": VL_GEN,
            "logits_rel_l2_vs_prefill": rel,
            "logits_max_abs_err_vs_prefill": max_abs(got, want),
            "tolerance": BF16_PREFILL_TOL,
            "feed_ms_per_embedding": feed_s / VL_DECODE_LEN * 1e3,
            "step_ms": step_ms, "median_step_ms": med,
            "tokens_per_s": 1e3 / med, "step_bytes": weights + cache,
            "bytes_bound_ms": (weights + cache) / HBM_BYTES_PER_S * 1e3}


def vl_run(torch) -> dict:
    """qwen2-vl-72b (bf16, VL_LAYERS layers): the flash prefill of 1 x
    VL_SEQ stub embeddings on a position grid, K6 once a layer, against
    the non-flash prefill; then the decode check and greedy steps."""
    from repro_torch.core import prng
    from repro_torch.data import pipeline
    from repro_torch.models.common import InputShape

    cfg = vl_config()
    params = frontend_params(torch, cfg, 70, torch.bfloat16, VL_PARAMS)
    batch = pipeline.synthetic_batch(
        cfg, InputShape("prefill_8k", VL_SEQ, 1, "prefill"),
        prng.PRNGKey(71), dtype=torch.bfloat16, device="cuda")
    batch["positions3"] = torch.from_numpy(
        mrope_grid(VL_TEXT, VL_GRID, VL_SEQ))[None].cuda()
    run = prefill_model(torch, VL_ARCH, None, 1, VL_SEQ, VL_LAYERS, seed=72,
                        dtype="bfloat16", params=params, cfg=cfg,
                        batch=batch)
    run["reduced"] = f"n_layers {VL_FULL_LAYERS} -> {VL_LAYERS}"
    run["positions3"] = {"text": VL_TEXT, "grid": list(VL_GRID),
                         "text_after_from": VL_TEXT + max(VL_GRID)}
    del batch
    run["decode"] = vl_decode(torch, params, cfg, seed=73)
    log(f"[frontends] {VL_ARCH} ({run['reduced']}) decode: the "
        f"{VL_DECODE_LEN}-embedding prompt fed a step at a time "
        f"{run['decode']['logits_rel_l2_vs_prefill']:.4g} relative L2 from "
        f"the prefill (tolerance {BF16_PREFILL_TOL}); token step "
        f"{run['decode']['median_step_ms']:.1f} ms against a bytes bound "
        f"of {run['decode']['bytes_bound_ms']:.2f} ms; "
        + json.dumps(run["decode"]))
    del params
    return run


def encdec_run(torch) -> dict:
    """seamless-m4t-large-v2 (fp32, full depth): the flash prefill of 1 x
    ENCDEC_SEQ stub embeddings over as many source frames (K6 once a
    decoder layer, none in the encoder), against the non-flash prefill;
    encode alone (timed, no K6); then speech to text: ENCDEC_GEN greedy
    tokens over the encoder memory through make_serve_step, each step's
    logits against one full-sequence apply of the same tokens and frames."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models import transformer_scan
    from repro_torch.models.common import InputShape
    from repro_torch.train import steps

    cfg = configs.get_config(ENCDEC_ARCH)
    params = frontend_params(torch, cfg, 74, torch.float32, ENCDEC_PARAMS)
    batch = pipeline.synthetic_batch(
        cfg, InputShape("prefill_8k", ENCDEC_SEQ, 1, "prefill"),
        prng.PRNGKey(75), dtype=torch.float32, device="cuda")
    if tuple(batch["src_embeddings"].shape[:2]) != (1, ENCDEC_SEQ):
        raise AssertionError("source frames")
    run = prefill_model(torch, ENCDEC_ARCH, None, 1, ENCDEC_SEQ,
                        cfg.n_layers, seed=76, params=params, batch=batch)
    src = batch["src_embeddings"]
    del batch
    before = fk.flash_attention_bhsd.launches
    memory = transformer_scan.encode(params, cfg, src)
    times = []
    for _ in range(PREFILL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        transformer_scan.encode(params, cfg, src)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if fk.flash_attention_bhsd.launches != before:
        raise AssertionError(f"{ENCDEC_ARCH}: the encoder launched K6")
    run["encode_ms"] = times
    run["encode_median_ms"] = sorted(times)[len(times) // 2]
    run["breakdown"] = encdec_breakdown(torch, params, cfg, memory)

    state = transformer_scan.init_decode_state(
        params, cfg, 1, ENCDEC_GEN, dtype=torch.float32, memory=memory)
    del memory
    before = fk.flash_attention_bhsd.launches
    step = steps.make_serve_step(cfg, scan_layers=True)
    tok = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    toks, outs, step_ms = [], [], []
    for _ in range(ENCDEC_GEN):
        toks.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = step(params, state, {"tokens": tok})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(logits)
        tok = logits.argmax(-1, keepdim=True).int()
    if fk.flash_attention_bhsd.launches != before:
        raise AssertionError(f"{ENCDEC_ARCH}: the decode launched K6")
    del state
    got = torch.stack(outs, 1)
    want = transformer_scan.apply(params, cfg, {
        "tokens": torch.cat(toks, 1), "src_embeddings": src})
    err = max_abs(got, want)
    if not torch.allclose(got, want, rtol=DECODE_LOGITS_TOL,
                          atol=DECODE_LOGITS_TOL):
        raise AssertionError(f"{ENCDEC_ARCH}: {ENCDEC_GEN} decode steps "
                             f"over the memory != the full-sequence apply "
                             f"(max abs err {err})")
    med = sorted(step_ms)[len(step_ms) // 2]
    run["decode"] = {"gen": ENCDEC_GEN, "source_frames": ENCDEC_SEQ,
                     "logits_max_abs_err_vs_apply": err,
                     "tolerance": DECODE_LOGITS_TOL,
                     "logits_abs_max": float(want.abs().max()),
                     "step_ms": step_ms, "median_step_ms": med,
                     "tokens_per_s": 1e3 / med,
                     "distinct_tokens": len({int(t) for t in toks})}
    log(f"[frontends] {ENCDEC_ARCH} encode 1 x {ENCDEC_SEQ} frames: median "
        f"{run['encode_median_ms']:.1f} ms of "
        f"{[round(t, 1) for t in times]}, no K6; a layer's pieces "
        + json.dumps(run["breakdown"]) + f"; {ENCDEC_GEN} greedy tokens "
        f"over the memory: step {med:.1f} ms, against the full-sequence "
        f"apply max abs err {err:.3g} (tolerance {DECODE_LOGITS_TOL}); "
        + json.dumps(run["decode"]))
    del params, src
    return run


def encdec_breakdown(torch, params, cfg, memory) -> dict:
    """CUDA-event times of one layer's pieces at the prefill's shape (1 x
    ENCDEC_SEQ over as many frames): the encoder's non-causal attention
    (q-chunked, plain), the decoder's cross attention (plain, over the
    whole memory), its causal self-attention on K6, and the FFN; each
    beside its count in a prefill."""
    from repro_torch.models import attention, layers
    from repro_torch.models.transformer_scan import _at

    enc = _at(params["encoder"]["scan_blocks"], 0)
    dec = _at(params["scan_blocks"][0], 0)
    x = memory[:, :ENCDEC_SEQ]
    pos = torch.arange(ENCDEC_SEQ, device="cuda")[None]
    mkv = attention.memory_kv(dec["cross"], cfg, memory)
    parts = {
        "encoder_attention": (lambda: attention.attention(
            enc["mixer"], cfg, x, pos, causal=False), cfg.n_encoder_layers),
        "cross_attention": (lambda: attention.cross_attention(
            dec["cross"], cfg, x, mkv), cfg.n_layers),
        "memory_kv": (lambda: attention.memory_kv(dec["cross"], cfg, memory),
                      cfg.n_layers),
        "self_attention_k6": (lambda: attention.attention(
            dec["mixer"], cfg, x, pos, use_flash=True), cfg.n_layers),
        "ffn": (lambda: layers.mlp(dec["ffn"], x, act=cfg.act, glu=cfg.glu),
                cfg.n_layers + cfg.n_encoder_layers),
    }
    out = {}
    for name, (fn, count) in parts.items():
        ms = time_ms(fn, reps=3)
        out[name] = {"ms": ms, "per_prefill": count, "ms_x_count": ms * count}
    return out


def frontends_cross_device_check(torch) -> None:
    """Both configs reduced, card against CPU: the flash prefill (K6 once
    a decoder layer on the card) on stub embeddings (a position grid for
    qwen2-vl, source frames for seamless), a train step's loss and every
    gradient within REDUCED_TOL; 8 decode steps (embeddings, or tokens
    over the encoder memory) on the fp32 cache within REDUCED_TOL and on
    the bf16 and int8 caches within KV_REDUCED_INT8_REL of the logits'
    scale (a K/V value at a rounding half may land a step apart)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.models import transformer_scan
    from repro_torch.train import steps

    (text, grid), s, src_len = FRONTEND_REDUCED
    errs = {}
    for arch in (VL_ARCH, ENCDEC_ARCH):
        mc = configs.get_config(arch).reduced()
        params = transformer_scan.init(mc, transformer_scan.generator(5))
        gparams = pytree.tree_map(lambda t: t.cuda(), params)
        rng = np.random.default_rng(6)
        batch = {"embeddings": torch.from_numpy(
            (rng.normal(size=(2, s, mc.d_model)) * 0.5).astype(np.float32))}
        if mc.rope_variant == "mrope":
            batch["positions3"] = torch.from_numpy(
                mrope_grid(text, grid, s))[None].expand(2, 3, s)
        if mc.is_encdec:
            batch["src_embeddings"] = torch.from_numpy(
                (rng.normal(size=(2, src_len, mc.d_model)) * 0.5).astype(
                    np.float32))
        gbatch = {k: v.cuda() for k, v in batch.items()}
        step = steps.make_prefill_step(mc, use_flash=True, scan_layers=True,
                                       logits_positions="last")
        checks = [("prefill", step(params, batch))]
        before = fk.flash_attention_bhsd.launches
        got = step(gparams, gbatch).cpu()
        if fk.flash_attention_bhsd.launches - before != mc.n_layers:
            raise AssertionError(f"reduced {arch} prefill: K6 launches")
        checks = [("prefill", checks[0][1], got)]
        loss = steps.make_loss_fn(mc, steps.TrainStepConfig(scan_layers=True))
        short = lambda b: {k: (v if k == "src_embeddings" else  # noqa: E731
                               v[..., :32, :] if k == "embeddings" else
                               v[..., :32]) for k, v in b.items()}
        labels = torch.from_numpy(rng.integers(0, mc.vocab, size=(2, 32))
                                  .astype(np.int32))
        want_l, want_g = steps.value_and_grad(
            loss, params, {**short(batch), "labels": labels})
        got_l, got_g = steps.value_and_grad(
            loss, gparams, {**short(gbatch), "labels": labels.cuda()})
        checks += [("loss", want_l, got_l.cpu())]
        checks += [("grads", w, g.cpu()) for w, g in zip(
            pytree.tree_leaves(want_g), pytree.tree_leaves(got_g))]
        for name, a, b in checks:
            key = f"{arch} {name}"
            errs[key] = max(errs.get(key, 0.0), max_abs(b, a))
            if not torch.allclose(b, a, rtol=REDUCED_TOL, atol=REDUCED_TOL):
                raise AssertionError(f"reduced {arch} {name}: card != CPU "
                                     f"(max abs err {max_abs(b, a)})")
        serve = steps.make_serve_step(mc, scan_layers=True)
        tok = torch.from_numpy(rng.integers(0, mc.vocab, size=(2, 8)).astype(
            np.int32))
        for cache in ("fp32", "bf16", "int8"):
            def run(p, b, dev):
                kw = {}
                if mc.is_encdec:
                    kw["memory"] = transformer_scan.encode(
                        p, mc, b["src_embeddings"])
                st = transformer_scan.init_decode_state(
                    p, mc, 2, 10, quantize_kv=cache == "int8", **kw,
                    dtype=torch.bfloat16 if cache == "bf16"
                    else torch.float32)
                outs = []
                for i in range(8):
                    inp = ({"tokens": tok[:, i:i + 1].to(dev)}
                           if mc.is_encdec else
                           {"embeddings": b["embeddings"][:, i:i + 1]})
                    logits, st = serve(p, st, inp)
                    outs.append(logits.cpu())
                return outs
            pairs = list(zip(run(gparams, gbatch, "cuda"),
                             run(params, batch, "cpu")))
            err = max(max_abs(g, c) for g, c in pairs)
            scale = max(float(c.abs().max()) for _, c in pairs)
            errs[f"{arch} decode {cache}"] = err
            ok = all(torch.allclose(g, c, rtol=REDUCED_TOL, atol=REDUCED_TOL)
                     for g, c in pairs) if cache == "fp32" else \
                err <= KV_REDUCED_INT8_REL * scale
            if not ok:
                raise AssertionError(f"reduced {arch} decode ({cache} "
                                     f"cache): card != CPU, max abs err "
                                     f"{err}")
    log(f"[check] {VL_ARCH} and {ENCDEC_ARCH} reduced: flash prefill (2 x "
        f"{s} stub embeddings; a position grid, {src_len} source frames), "
        f"train loss and every gradient (2 x 32) within {REDUCED_TOL}; 8 "
        f"decode steps on the fp32 cache within {REDUCED_TOL}, the bf16 and "
        f"int8 caches within {KV_REDUCED_INT8_REL} of the logits' scale: "
        "card == CPU; max abs errs " + json.dumps(errs))


def frontends_phase(torch) -> dict:
    """qwen2-vl-72b (M-RoPE, stub embeddings; bf16, 32 of 80 layers) and
    seamless-m4t-large-v2 (encoder-decoder, fp32) at full width: their
    flash prefills (the main path: K6 launches counted from 0 before each
    and read after), the decode checks, then both reduced card vs CPU."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {VL_ARCH: vl_run(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    out[ENCDEC_ARCH] = encdec_run(torch)
    gc.collect()
    torch.cuda.empty_cache()
    frontends_cross_device_check(torch)
    out["launches"] = {"flash_attention_bhsd": sum(
        out[a]["launches"] for a in (VL_ARCH, ENCDEC_ARCH))}
    out["wall_s"] = time.perf_counter() - t0
    log(f"[frontends] phase wall time {out['wall_s']:.1f} s")
    return out


# mesh phase: the dry run's subset at full width (a train, a prefill and
# a decode combo on each production mesh, grok-1-314b train_4k on 16 x 16),
# and its one-device estimate held against the card
MESH_SUBSET = ("grok-1-314b:train_4k", "qwen1.5-0.5b:prefill_32k",
               "qwen1.5-0.5b:decode_32k", "qwen1.5-0.5b:train_4k:multi-pod",
               "qwen1.5-0.5b:prefill_32k:multi-pod",
               "qwen1.5-0.5b:long_500k:multi-pod")
MESH_ESTIMATE = ("repro-100m", "qwen1.5-0.5b")
MESH_ESTIMATE_SHAPE = (4, 4096)           # global batch, sequence
MESH_TEMP_TOL = 0.10
# the caching allocator rounds a block to 512 B, and leaves a large-pool
# block unsplit when the rest of its segment would be 1 MiB or less: a
# tensor may hold up to 1 MiB more than it asked for
ALLOC_SLACK = 1 << 20


class _SpecMesh:
    """A mesh as the spec rules read it (axis names, device grid)."""

    def __init__(self, shape, names):
        import numpy as np
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def dryrun_subprocess(args: list, out: Path, timeout: int) -> list:
    """python -m repro_torch.launch.dryrun ``args`` -> its records; any
    failure raises (the CLI exits 1 on a failed combo)."""
    if out.exists():
        out.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)
    for line in res.stdout.splitlines():
        if line.startswith("[dryrun]"):
            log("[mesh] " + line)
    if res.returncode != 0:
        raise AssertionError(f"dry run {args} exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    log(f"[mesh] dry run of {len(recs)} combos in "
        f"{time.perf_counter() - t0:.1f} s (subprocess)")
    return recs


def closed_form_argument_bytes(rec: dict) -> int:
    """The record's inputs, laid out by the spec rules on its mesh: the
    sum over leaves of each local shard's bytes (host leaves aside)."""
    from repro_torch.core import pytree
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models.common import INPUT_SHAPES, InputShape
    dims = tuple(int(n) for n in rec["mesh"].split("x"))
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    mesh = _SpecMesh(dims, names)
    sharding.set_activation_batch_axes(names[:-1])
    base = INPUT_SHAPES[rec["shape"]]
    shape = InputShape(base.name, rec["seq_len"], rec["global_batch"],
                       base.kind)
    spec = dryrun.input_specs(rec["arch"], rec["shape"], shape=shape)
    sizes = dict(zip(names, dims))

    def local(leaf, sp) -> int:
        n = leaf.numel()
        for e in sp:
            for name in (e if isinstance(e, tuple) else (e,)):
                if name is not None:
                    n //= sizes[name]
        return n * leaf.element_size()

    total = 0
    if "state" in spec:
        for path, leaf in pytree.tree_flatten_with_path(spec["state"])[0]:
            if path[0] not in ("step", "rng") and path[-1] != "step":
                total += local(leaf, dryrun._state_spec(path, leaf, mesh))
    else:
        for path, leaf in pytree.tree_flatten_with_path(spec["params"])[0]:
            total += local(leaf, sharding.param_spec(
                path, tuple(leaf.shape), mesh))
        for path, leaf in pytree.tree_flatten_with_path(
                spec.get("decode_state", {}))[0]:
            if hasattr(leaf, "shape"):
                total += local(leaf, sharding.cache_spec(
                    path, tuple(leaf.shape), mesh))
    for leaf in pytree.tree_leaves(spec["batch"]):
        total += local(leaf, sharding.batch_spec(tuple(leaf.shape), mesh))
    sharding.set_activation_batch_axes(("data",))
    return total


def host_mesh_check(torch) -> dict:
    """make_host_mesh() over the one card, on a world-1 NCCL group."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        hm = mesh_lib.make_host_mesh()
        got = {"shape": tuple(hm.shape), "names": hm.mesh_dim_names,
               "device_type": hm.device_type}
    finally:
        dist.destroy_process_group()
    log(f"[mesh] host mesh {got}")
    if got != {"shape": (1,), "names": ("data",), "device_type": "cuda"}:
        raise AssertionError(f"host mesh {got}")
    return got


def mesh_phase(torch) -> dict:
    """The host mesh on the card; the dry run's subset at full width (in
    a subprocess, on the fake backend) with its argument bytes against
    the closed form; the one-device estimate against the card."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.common import InputShape
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"host_mesh": host_mesh_check(torch)}
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[mesh] HBM: data sheet {mesh_lib.HBM_BYTES} B, the card's "
        f"total_memory {total} B")
    outdir = ROOT / "build" / "dryrun"          # listed in .gitignore
    outdir.mkdir(parents=True, exist_ok=True)
    args = [a for c in MESH_SUBSET for a in ("--combo", c)]
    recs = dryrun_subprocess(args, outdir / "mesh_dryrun.jsonl", 600)
    for rec in recs:
        want = closed_form_argument_bytes(rec)
        c = rec["collectives"]["collective_breakdown"]
        log("[mesh] record " + json.dumps({
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "argument_bytes": rec["argument_size_in_bytes"],
            "closed_form": want, "temp_bytes": rec["temp_size_in_bytes"],
            "output_bytes": rec["output_size_in_bytes"],
            "alias_bytes": rec["alias_size_in_bytes"],
            "dot_flops": rec["dot_flops"], "collectives": c,
            "trace_s": rec["lower_s"]}))
        if rec["argument_size_in_bytes"] != want:
            raise AssertionError(f"{rec['arch']} {rec['shape']} "
                                 f"{rec['mesh']}: argument bytes "
                                 f"{rec['argument_size_in_bytes']} != "
                                 f"closed form {want}")
    out["subset"] = recs
    b, s = MESH_ESTIMATE_SHAPE
    est = dryrun_subprocess(
        [a for arch in MESH_ESTIMATE
         for a in ("--combo", f"{arch}:train_4k")]
        + ["--mesh", "1x1", "--batch", str(b), "--seq", str(s)],
        outdir / "mesh_estimate.jsonl", 600)
    out["estimates"] = []
    for rec in est:
        gc.collect()
        torch.cuda.empty_cache()
        card = dryrun.run_on_card(rec["arch"], "train_4k",
                                  shape=InputShape("train_4k", s, b,
                                                   "train"))
        args_b = rec["argument_size_in_bytes"]
        temp = rec["temp_size_in_bytes"]
        gap = abs(temp - card["peak_beyond_live"]) / card["peak_beyond_live"]
        row = {"arch": rec["arch"], "batch": f"{b} x {s}",
               "argument_bytes": args_b, "placed_bytes": card["placed_bytes"],
               "allocated_growth": card["allocated_growth"],
               "requested_growth": card["requested_growth"],
               "n_tensors": card["n_tensors"], "temp_bytes": temp,
               "card_peak_beyond_live": card["peak_beyond_live"],
               "temp_gap": gap, "dot_flops": rec["dot_flops"],
               "card_dot_flops": card["dot_flops"],
               "step_ms": card["step_ms"], "tflops": card["tflops"],
               "loss": card["loss"]}
        log("[mesh] estimate " + json.dumps(row))
        out["estimates"].append(row)
        if args_b != card["placed_bytes"]:
            raise AssertionError(f"{rec['arch']}: argument bytes {args_b} "
                                 f"!= placed {card['placed_bytes']}")
        if card["requested_growth"] != args_b or not 0 <= \
                card["allocated_growth"] - args_b <= \
                ALLOC_SLACK * card["n_tensors"]:
            raise AssertionError(f"{rec['arch']}: allocator growth "
                                 f"{card['allocated_growth']} (requested "
                                 f"{card['requested_growth']}) vs {args_b}")
        if card["dot_flops"] != rec["dot_flops"]:
            raise AssertionError(f"{rec['arch']}: dot FLOPs on the card "
                                 f"{card['dot_flops']} != "
                                 f"{rec['dot_flops']}")
        if gap > MESH_TEMP_TOL:
            raise AssertionError(f"{rec['arch']}: temp {temp} vs the card's "
                                 f"{card['peak_beyond_live']} ({gap:.3f})")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[mesh] phase wall time {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# dp phase: the launcher on several ranks (one rank a card)
# ---------------------------------------------------------------------------

# full-width repro-100m, the launcher's 8 x 256 global batch, AdamW, rq4 +
# error feedback, DP_STEPS steps on each run
DP_STEPS = 10
DP_ARGV = ["--arch", TRAIN_ARCH, "--compression", "rq4", "--error-feedback",
           "--steps", str(DP_STEPS)]
DP_BATCH_TOKENS = 8 * 256         # the launcher's default global batch
DP_TIMEOUT = 300
DP_REDUCE_REPS = 3
DP_PROFILE_STEPS = 2               # steps traced by torch.profiler a run
DP_PROFILE_TOP = 6                 # kernels listed a trace
# reduced deepseek-v2-lite-16b through the same launcher, 8 x 256: the
# global batch is ONE MoE group of 2,048 tokens, which spans the ranks
# whenever there are two or more (each gathers the group's tokens)
MOE_ARCH = "deepseek-v2-lite-16b"
DP_MOE_STEPS = 3
DP_MOE_ARGV = ["--arch", MOE_ARCH, "--reduced", "--compression", "rq4",
               "--error-feedback", "--steps", str(DP_MOE_STEPS)]
DP_MOE_SEED = 24


def dp_record(torch, args, run) -> dict:
    """The launcher's steps (``run_steps``) on ``run``, each timed on the
    host clock around a synchronize: losses, grad norms, K1/K4 launches
    a step, comm bytes against the wire, peak memory and the final
    state's SHA-256 a leaf."""
    from repro_torch.core import compression
    from repro_torch.kernels.quant import kernel
    from repro_torch.launch import train

    wire = compression.codec("rq4").tree_wire_bytes_flat(
        run["state"]["params"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    out = {"loss": [], "gnorm": [], "step_ms": [], "comm_bytes": [],
           "launches": []}
    steps = train.run_steps(args, run)
    while True:
        before = kernel.launch_counts()
        t0 = time.perf_counter()
        try:
            _, m = next(steps)
        except StopIteration:
            break
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        after = kernel.launch_counts()
        out["launches"].append({k: after[k] - before[k]
                                for k in TRAIN_KERNELS})
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
        out["comm_bytes"].append(float(m["comm_bytes"]))
    out["wire"] = float(torch.tensor(wire))
    out["peak"] = torch.cuda.max_memory_allocated()
    out["total_launches"] = {k: kernel.launch_counts()[k]
                             for k in TRAIN_KERNELS}
    out["sha256"] = leaf_sha256(run["state"])
    return out


def leaf_sha256(tree) -> list:
    """SHA-256 of every leaf's bytes, in leaf order."""
    import hashlib

    import numpy as np
    from repro_torch.core import pytree

    return [hashlib.sha256(np.ascontiguousarray(
        leaf.detach().cpu().numpy()).view(np.uint8)).hexdigest()
        for leaf in pytree.tree_leaves(tree)]


def dp_reduce_ms(torch, run) -> tuple:
    """(median ms, bytes) of ``steps.reduce_over_data`` over the mesh's
    'data' axis on a gradient of the model's layout (CUDA events around
    each call); (None, 0) on a world of one, whose step reduces nothing."""
    from repro_torch.core import compression, pytree
    from repro_torch.train import steps

    if run["world"] == 1:
        return None, 0
    grads = pytree.tree_map(torch.clone, run["state"]["params"])
    loss = torch.zeros((), device=run["device"])
    times = []
    for _ in range(DP_REDUCE_REPS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        steps.reduce_over_data(loss, grads, run["mesh"])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times = sorted(times[1:])
    total = compression.FlatLayout.from_tree(grads).total
    return times[len(times) // 2], (total + 1) * 4


def dp_profile(torch, run) -> dict:
    """DP_PROFILE_STEPS more steps of ``run`` from its final state (its
    records are taken) under torch.profiler (the card's activity only):
    the wall ms a step (host clock around a synchronize, the tracer's
    cost included), the card's busy ms a step (the union of its kernels'
    and copies' intervals), the idle share, and the kernels that take
    most of the time. The tracer's raw events are read, not parsed into
    a tree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    state, data, device = run["state"], run["data"], run["device"]
    first = int(state["step"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(first, first + DP_PROFILE_STEPS):
            state, _ = run["train_step"](
                state, train.to_device(data.batch_at(t), device))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / DP_PROFILE_STEPS
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, reach, by_name = 0, -1, {}
    for lo, hi, name in spans:
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
        by_name[name] = by_name.get(name, 0) + hi - lo
    busy_ms = busy / 1e6 / DP_PROFILE_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:DP_PROFILE_TOP]
    return {"wall_ms": wall, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall if spans else None,
            "device_events_a_step": len(spans) / DP_PROFILE_STEPS,
            "top_ms_a_step": [[n[:90], v / 1e6 / DP_PROFILE_STEPS]
                              for n, v in top]}


def dp_moe_record(torch, argv: list) -> dict:
    """``dp_record`` of the launcher on ``argv`` (the reduced MoE model),
    counting the all-gathers the steps make (an MoE group spanning the
    ranks gathers its tokens once a MoE layer and step)."""
    import torch.distributed as dist
    from repro_torch.launch import train

    args = train.parse_args(argv)
    run = train.setup(args)
    real, gathers = dist.all_gather, [0]

    def counted(*a, **kw):
        gathers[0] += 1
        return real(*a, **kw)

    dist.all_gather = counted
    try:
        res = dp_record(torch, args, run)
    finally:
        dist.all_gather = real
    res["gathers"] = gathers[0]
    return res


def dp_gather_ms(torch, run) -> float | None:
    """Median ms (CUDA events) of ``sharding.gather_rows`` forward and
    backward over the mesh's 'data' axis on a rank's 8/n x 256 rows of
    deepseek-v2-lite-16b's full-width activations (d_model 2,048, fp32):
    what a MoE layer whose group spans the ranks adds in messages a
    step; None on a world of one."""
    from repro_torch import configs
    from repro_torch.dist import sharding

    if run["world"] == 1:
        return None
    d = configs.get_config(MOE_ARCH).d_model
    x = torch.randn((DP_BATCH_TOKENS // 256 // run["world"], 256, d),
                    device=run["device"], requires_grad=True)
    times = []
    for _ in range(DP_REDUCE_REPS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = sharding.gather_rows(x, run["mesh"])
        torch.autograd.grad(y, x, torch.ones_like(y))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times = sorted(times[1:])
    return times[len(times) // 2]


def dp_moe_cost(torch, card: str) -> dict:
    """What a rank computes beyond its share when its MoE group spans the
    ranks, at deepseek-v2-lite-16b's full width (64 experts of 2,048 x
    1,408, top 6, 2 shared): one MoE layer's forward and backward
    (``time_ms``) over the 8 x 256 global batch, which every rank runs
    when the batch's one group of 2,048 tokens spans them, against over
    a rank's own 8/n x 256 rows, as it would run them were they whole
    groups; times the model's MoE layers, the extra a step."""
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.models import moe

    cfg = configs.get_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(DP_MOE_SEED)
    p = moe.moe_init(gen, cfg)
    leaves = [leaf.requires_grad_(True) for leaf in pytree.tree_leaves(p)]
    n_moe = cfg.n_layers - 1          # deepseek keeps layer 0 dense

    def layer_ms(rows: int) -> float:
        x = torch.randn((rows, 256, cfg.d_model), device="cuda",
                        generator=gen, requires_grad=True)

        def fwd_bwd():
            out, aux = moe.moe_apply(p, cfg, x, act=cfg.act)
            torch.autograd.grad(out.sum() + aux, [x, *leaves])
        return time_ms(fwd_bwd)

    whole = layer_ms(DP_BATCH_TOKENS // 256)
    out = {"arch": MOE_ARCH, "moe_layers": n_moe, "global_rows_ms": whole,
           "card": card}
    for n in (2, 4):
        own = layer_ms(DP_BATCH_TOKENS // 256 // n)
        out[f"n{n}"] = {"own_rows_ms": own, "extra_layer_ms": whole - own,
                        "extra_step_ms": n_moe * (whole - own)}
    del p, leaves
    gc.collect()
    torch.cuda.empty_cache()
    log("[dp] moe cost " + json.dumps(out))
    return out


def dp_child(out_path: str, gloo) -> int:
    """One rank of the dp phase (``chip_smoke.py --dp-rank OUT``): the
    launcher makes its NCCL group from torchrun's variables, or (``--gloo
    RDV RANK WORLD``) joins a gloo group made here, its ranks sharing
    card 0; then ``dp_record``, ``dp_reduce_ms``, ``dp_profile`` (NCCL
    ranks) and ``dp_gather_ms`` of repro-100m and ``dp_moe_record`` of the reduced
    MoE model to ``out_path``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extra = []
    if gloo:
        rdv, rank, world = gloo
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=int(rank), world_size=int(world))
        extra = ["--device", "cuda:0"]
    args = train.parse_args(DP_ARGV + extra)
    run = train.setup(args)
    try:
        res = dp_record(torch, args, run)
        res["reduce_ms"], res["reduce_bytes"] = dp_reduce_ms(torch, run)
        if not gloo:        # the card is shared: its trace says little
            res["profile"] = dp_profile(torch, run)
        res["gather_ms"] = dp_gather_ms(torch, run)
        res.update(rank=run["rank"], world=run["world"],
                   backend=dist.get_backend(run["group"]))
        del run
        gc.collect()
        torch.cuda.empty_cache()
        res["moe"] = dp_moe_record(torch, DP_MOE_ARGV + extra)
    finally:
        dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(res))
    return 0


def dp_spawn(argvs: list, envs: list, timeout: int = DP_TIMEOUT) -> list:
    """Run ``chip_smoke.py`` ranks side by side to their end; any failure
    (or ``timeout`` s) kills them all and raises."""
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               *a], cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, e in zip(argvs, envs)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"rank exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
    return outs


def dp_check_run(res: dict, want: dict | None = None) -> None:
    """K1 once and K4 twice a step (or ``want`` a step), comm bytes the
    fused wire's, finite losses and grad norms."""
    want = want or {"minmax_bucketed": 1, "qdq_bucketed": 2}
    for t, per in enumerate(res["launches"]):
        if per != want:
            raise AssertionError(f"rank {res.get('rank', 0)} step {t}: "
                                 f"launches {per}")
    if any(c != res["wire"] for c in res["comm_bytes"]):
        raise AssertionError(f"comm_bytes {res['comm_bytes']} != wire "
                             f"{res['wire']}")
    if not all(math.isfinite(v) for v in res["loss"] + res["gnorm"]):
        raise AssertionError("non-finite loss or grad norm")


def dp_summary(name: str, res: dict, card: str) -> dict:
    med = sorted(res["step_ms"][1:])[len(res["step_ms"][1:]) // 2]
    row = {"run": name, "rank": res.get("rank", 0),
           "world": res.get("world", 1), "backend": res.get("backend"),
           "median_step_ms": med, "first_step_ms": res["step_ms"][0],
           "tokens_per_s": DP_BATCH_TOKENS / (med / 1e3),
           "reduce_ms": res.get("reduce_ms"),
           "reduce_bytes": res.get("reduce_bytes", 0),
           "max_memory_allocated": res["peak"],
           "first_loss": res["loss"][0], "last_loss": res["loss"][-1],
           "card": card}
    for key in ("gather_ms", "gathers", "profile"):
        if key in res:
            row[key] = res[key]
    log("[dp] " + json.dumps(row))
    return row


def dp_step0_gap(res: dict, ref: dict, what: str) -> tuple:
    """(loss, grad norm) gaps of ``res``'s step 0 from ``ref``'s; raises
    over 1e-5."""
    d_loss = abs(res["loss"][0] - ref["loss"][0])
    d_gnorm = abs(res["gnorm"][0] - ref["gnorm"][0])
    if d_loss > 1e-5 or d_gnorm > 1e-5:
        raise AssertionError(f"{what}: step 0 loss/gnorm off by "
                             f"{d_loss}/{d_gnorm}")
    return d_loss, d_gnorm


def dp_check_ranks(ranks: list, backend: str, world: int, one: dict,
                   one_moe: dict, what: str) -> None:
    """The ranks of one run: ``backend`` at ``world``; each repro-100m
    and MoE run checked as the one-card runs are, replicas bit for bit;
    at world one the one-card runs' bits, beyond it step 0 within 1e-5
    of them and the MoE group's tokens gathered once a MoE layer and
    step."""
    from repro_torch import configs

    moe_layers = configs.get_config(MOE_ARCH).reduced().n_layers - 1
    for res in ranks:
        dp_check_run(res)
        dp_check_run(res["moe"], one_moe["launches"][0])
        if res["backend"] != backend or res["world"] != world:
            raise AssertionError(f"{what} ran {res['backend']} at world "
                                 f"{res['world']}")
        for r, r0 in ((res, ranks[0]), (res["moe"], ranks[0]["moe"])):
            if r["sha256"] != r0["sha256"] or r["loss"] != r0["loss"]:
                raise AssertionError(f"{what}: replicas differ")
        gathers = res["moe"]["gathers"]
        if gathers != (0 if world == 1 else DP_MOE_STEPS * moe_layers):
            raise AssertionError(f"{what}: {gathers} MoE gathers at world "
                                 f"{world}")
    for r, ref in ((ranks[0], one), (ranks[0]["moe"], one_moe)):
        if world == 1 and any(r[k] != ref[k]
                              for k in ("loss", "gnorm", "sha256")):
            raise AssertionError(f"{what}: world-1 launcher != one-card "
                                 "launcher")
        dp_step0_gap(r, ref, what)


def dp_phase(torch, card: str) -> dict:
    """(a) the launcher at world = the card count over NCCL (torchrun's
    variables), each step, grad norm and the final state equal to the
    one-card launcher's bit for bit on a world of one; (b) two ranks on
    card 0 over a gloo group made for them: replicas bit for bit, step 0
    within 1e-5 of (a), falling losses, K1 once and K4 twice a step on
    each rank. Each run also trains the reduced MoE model, whose one
    group spans the ranks of a world of two or more; and the full-width
    MoE layer's extra work a spanning rank does (``dp_moe_cost``)."""
    import socket
    from repro_torch.launch import train

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    args = train.parse_args(DP_ARGV)
    run = train.setup(args)
    if run["group"] is not None:
        raise AssertionError("the one-card launcher joined a group")
    one = dp_record(torch, args, run)
    dp_check_run(one)
    one["profile"] = dp_profile(torch, run)
    marks = {"one-card": time.perf_counter() - t0}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    one_moe = dp_moe_record(torch, DP_MOE_ARGV)
    dp_check_run(one_moe, one_moe["launches"][0])
    if one_moe["launches"][0]["minmax_bucketed"] < 1:
        raise AssertionError("the MoE run launched no K1")
    rows = [dp_summary("one-card", one, card),
            dp_summary("one-card-moe", one_moe, card)]
    marks["one-card MoE"] = time.perf_counter() - t0
    moe_cost = dp_moe_cost(torch, card)
    marks["MoE cost"] = time.perf_counter() - t0

    n = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tmp = Path(tempfile.mkdtemp(prefix="dp-", dir=ROOT / "build"))
    outs = [tmp / f"nccl{r}.json" for r in range(n)]
    dp_spawn([["--dp-rank", str(o)] for o in outs],
             [dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port)) for r in range(n)])
    nccl = [json.loads(o.read_text()) for o in outs]
    marks["(a)"] = time.perf_counter() - t0
    dp_check_ranks(nccl, "nccl", n, one, one_moe, "(a)")
    for res in nccl:
        rows += [dp_summary("nccl", res, card),
                 dp_summary("nccl-moe", dict(res["moe"], rank=res["rank"],
                                             world=n), card)]
    if n == 1:
        log("[dp] (a) NCCL world 1: every loss and grad norm and the final "
            "state (SHA-256 of every leaf) equal the one-card launcher's "
            "bit for bit, repro-100m and the MoE model")
    else:
        log(f"[dp] (a) NCCL world {n}: replicas bit for bit, step 0 within "
            "1e-5 of the one-card launcher, repro-100m and the MoE model "
            "(its one group spanning the ranks)")

    outs = [tmp / f"gloo{r}.json" for r in range(2)]
    dp_spawn([["--dp-rank", str(o), "--gloo", str(tmp / "rdv"), str(r), "2"]
              for r, o in enumerate(outs)],
             [dict(os.environ) for _ in outs])
    gloo = [json.loads(o.read_text()) for o in outs]
    marks["(b)"] = time.perf_counter() - t0
    dp_check_ranks(gloo, "gloo", 2, one, one_moe, "(b)")
    for res in gloo:
        rows += [dp_summary("gloo-2-ranks-1-card", res, card),
                 dp_summary("gloo-moe", dict(res["moe"], rank=res["rank"],
                                             world=2), card)]
    b = gloo[0]
    d_loss, d_gnorm = dp_step0_gap(b, nccl[0], "(b) against (a)")
    m_loss, m_gnorm = dp_step0_gap(b["moe"], one_moe, "(b) MoE")
    last3 = sum(b["loss"][-3:]) / 3
    if not last3 < b["loss"][0]:
        raise AssertionError(f"(b) loss did not fall: {b['loss']}")
    if b["reduce_bytes"] != (TRAIN_TOTAL + 1) * 4:
        raise AssertionError(f"(b) reduced {b['reduce_bytes']} B")
    log(f"[dp] (b) 2 gloo ranks on one card: replicas bit for bit, step 0 "
        f"loss {d_loss:.2e} and grad norm {d_gnorm:.2e} from (a), loss "
        f"{b['loss'][0]:.4f} -> {b['loss'][-1]:.4f}; the reduction: "
        f"{TRAIN_TOTAL * 4} B of fp32 gradient + 4 B of loss in one gloo "
        f"all-reduce through the host, {b['reduce_ms']:.1f} ms; the MoE "
        f"model's group spanning both ranks: replicas bit for bit, step 0 "
        f"loss {m_loss:.2e} and grad norm {m_gnorm:.2e} from the one-card "
        f"launcher's, {b['moe']['gathers']} gathers")
    launches = {k: sum(r["total_launches"][k]
                       for r in [one, one_moe] + [x for res in nccl + gloo
                                                  for x in (res,
                                                            res["moe"])])
                for k in TRAIN_KERNELS}
    wall = time.perf_counter() - t0
    shutil.rmtree(tmp)
    log(f"[dp] phase wall time {wall:.1f} s; at the end of each part: "
        + ", ".join(f"{k} {v:.1f}" for k, v in marks.items()))
    return {"rows": rows, "launches": launches, "moe_cost": moe_cost,
            "wall_s": wall}


# ---------------------------------------------------------------------------
# ranks phase (the paper's exchanges on a real worker axis: one worker a
# rank, the rq4 partitioned ring's hops sent between processes)
# ---------------------------------------------------------------------------

# the ring cell (full-width repro-100m, RING_BATCH x RING_SEQ rows a
# worker, plain SGD) through run_distributed(axis_name=...): RANKS_STEPS
# ring steps, then RANKS_DCD_STEPS steps of DCD rq4 gossip on the ring
RANKS_STEPS = 4
RANKS_DCD_STEPS = 2
RANKS_TIMEOUT = 300
RANKS_HOP_REPS = 5


def ranks_stacked_step0(torch) -> list:
    """SHA-256 of every leaf of the ring cell's workers after step 0 on
    RING_WORKERS stacked workers (its x̄: the workers are equal), the
    reference the ranks' step 0 is held to."""
    from repro_torch.core import communicators, parallel

    params0, loss_fn, make_batch, eval_batch = ring_problem(torch, "cuda")
    seen = []

    def full_loss(p):
        seen.append(leaf_sha256(p))
        return loss_fn(p, eval_batch)

    res = parallel.run_distributed(
        loss_fn, full_loss, lambda p: [torch.zeros(())], params0,
        lambda key, worker: make_batch(key), n_workers=RING_WORKERS,
        steps=1, lr=RING_LR,
        exchange=communicators.CSGDRingExchange(compressor="rq4"),
        seed=RING_SEED, device="cuda")
    if float(res.consensus[0]) != 0.0:
        raise AssertionError("stacked ring workers differ after step 0")
    return seen[0]


def ranks_ring(torch, axis, device, problem) -> dict:
    """RANKS_STEPS steps of the rq4 partitioned ring, one worker this
    rank: losses, consensus, each step's launches, bytes sent, step ms
    (its batch drawn to its exchange's end) and exchange ms (host clock
    around a synchronize), step 0's x̄ and the final params (SHA-256)."""
    from repro_torch.core import communicators, parallel
    from repro_torch.kernels.quant import kernel
    from repro_torch.train import steps

    params0, loss_fn, make_batch, eval_batch = problem
    starts, step0 = [], []

    def sample_batch(key, worker):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return make_batch(key)

    def full_loss(p):
        if not step0:
            step0.append(leaf_sha256(p))
        return loss_fn(p, eval_batch)

    ring = communicators.CSGDRingExchange(compressor="rq4")
    ex = CountingExchange(ring)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    res = parallel.run_distributed(
        loss_fn, full_loss,
        lambda p: steps.value_and_grad(loss_fn, p, eval_batch)[1], params0,
        sample_batch, n_workers=axis.n, steps=RANKS_STEPS, lr=RING_LR,
        exchange=ex, seed=RING_SEED, device=device, axis_name=axis)
    torch.cuda.synchronize()
    return {"losses": [float(v) for v in res.losses],
            "consensus": [float(v) for v in res.consensus],
            "launches": [{k: v for k, v in per.items() if v}
                         for per, _ in ex.calls],
            "total_launches": kernel.launch_counts(),
            "sent": ex.sent,
            "message_bytes": ring.message_bytes(params0, n_workers=axis.n),
            "step_ms": [(e - s) * 1e3 for s, e in zip(starts, ex.ends)],
            "exchange_ms": [ms for _, ms in ex.calls],
            "peak": torch.cuda.max_memory_allocated(device),
            "step0": step0[0], "final": leaf_sha256(res.params)}


def ranks_hop(torch, axis, device) -> dict:
    """One reduce-scatter hop at the full-width partition geometry, CUDA
    events around RANKS_HOP_REPS calls each (a warm-up first): the
    partition message's ppermute one step right (the wire), K5 alone
    (the decode, add and re-encode), and both."""
    from repro_torch.core import compression, prng

    cdc = compression.codec("rq4")
    n = axis.n
    part, _, _ = cdc.partition_geometry(TRAIN_TOTAL, n)
    gen = torch.Generator(device=device).manual_seed(RING_SEED + 7)
    x = torch.randn((part,), generator=gen, device=device) * 0.01
    pay, prm = cdc.encode_partition(x, prng.PRNGKey(1))
    perm = [(i, (i + 1) % n) for i in range(n)]
    key = prng.PRNGKey(2)

    def timed(fn) -> float:
        times = []
        for _ in range(RANKS_HOP_REPS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times = sorted(times[1:])
        return times[len(times) // 2]

    return {"wire_ms": timed(lambda: axis.ppermute((pay, prm), perm)),
            "k5_ms": timed(lambda: cdc.decode_add_encode_partition(
                pay, prm, x, key)),
            "hop_ms": timed(lambda: cdc.decode_add_encode_partition(
                *axis.ppermute((pay, prm), perm), x, key)),
            "message_bytes": pay.nbytes + prm.nbytes}


def ranks_breakdown(torch, axis, device, problem) -> dict:
    """Where a rank's ring step goes: its forward and backward, then the
    stages of the ring exchange itself (``CSGDRingExchange`` on
    ``axis``), each call timed on the host clock around a synchronize as
    the exchange makes it: the flatten and pad, its partition's encode
    (K1, K2 drawing its uniforms), the N-1 reduce-scatter hops (ppermute,
    K5), the N-1 all-gather ppermutes and the final decode (K3); the
    rest of the call is ``other_ms``. Every rank runs the same calls in
    the same order. Medians of RANKS_HOP_REPS exchanges after a warm-up;
    fails if the exchange made other calls than these."""
    from repro_torch.core import communicators, compression, prng
    from repro_torch.train import steps

    params0, loss_fn, make_batch, _ = problem
    n = axis.n
    batch = make_batch(prng.PRNGKey(77))
    grad = steps.value_and_grad(loss_fn, params0, batch)[1]
    ring = communicators.CSGDRingExchange(compressor="rq4")
    cdc = compression.codec("rq4")
    stages = [(compression.FlatLayout, "flatten", "flatten"),
              (type(cdc), "encode_partition", "encode"),
              (communicators.RankAxis, "ppermute", "ppermute"),
              (type(cdc), "decode_add_encode_partition", "k5"),
              (type(cdc), "flat_decode_partitioned", "decode")]
    want = (["flatten", "encode"] + ["ppermute", "k5"] * (n - 1)
            + ["ppermute"] * (n - 1) + ["decode"])
    calls, depth = [], [0]

    def timed(fn, name):
        def wrapper(*a, **k):
            if depth[0]:                        # a stage inside a stage
                return fn(*a, **k)
            depth[0] += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                calls.append((name, (time.perf_counter() - t) * 1e3))
                depth[0] -= 1
        return wrapper

    originals = [(cls, attr, vars(cls)[attr]) for cls, attr, _ in stages]
    reps = []
    try:
        for cls, attr, name in stages:
            setattr(cls, attr, timed(vars(cls)[attr], name))
        state = ring.init(grad, axis_name=axis)
        for _ in range(RANKS_HOP_REPS + 1):
            calls.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ring(grad, state, prng.PRNGKey(78), axis_name=axis)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t) * 1e3
            if [c for c, _ in calls] != want:
                raise AssertionError("the ring exchange's stages changed: "
                                     f"{[c for c, _ in calls]}")
            ms = [m for _, m in calls]
            reps.append({
                "exchange_ms": total, "flatten_pad_ms": ms[0],
                "encode_ms": ms[1],
                "reduce_scatter_ms": sum(ms[2:2 * n]),
                "reduce_scatter_wire_ms": sum(ms[2:2 * n:2]),
                "all_gather_ms": sum(ms[2 * n:3 * n - 1]),
                "decode_ms": ms[-1], "other_ms": total - sum(ms)})
    finally:
        for cls, attr, fn in originals:
            setattr(cls, attr, fn)
    reps = reps[1:]
    out = {k: sorted(r[k] for r in reps)[len(reps) // 2] for k in reps[0]}
    out["fwd_bwd_ms"] = host_ms(torch, lambda: steps.value_and_grad(
        loss_fn, params0, batch), reps=3)
    return out


def ranks_dcd(torch, axis, device, problem) -> dict:
    """RANKS_DCD_STEPS steps of DCD rq4 gossip on the ring (local SGD
    steps, the packed deltas sent to each Birkhoff term's destination):
    losses, each step's launches and bytes sent, and SHA-256 of this
    rank's public copy and of its replicas, with each replica's source
    rank."""
    from repro_torch.core import communicators, parallel
    from repro_torch.kernels.quant import kernel
    from repro_torch.train import steps

    params0, loss_fn, make_batch, eval_batch = problem
    dcd = CountingExchange(communicators.DCDGossipExchange(compressor="rq4"))
    kernel.reset_launches()
    res = parallel.run_distributed(
        loss_fn, lambda p: loss_fn(p, eval_batch),
        lambda p: steps.value_and_grad(loss_fn, p, eval_batch)[1], params0,
        lambda key, worker: make_batch(key), n_workers=axis.n,
        steps=RANKS_DCD_STEPS, lr=RING_LR,
        exchange=parallel.LocalExchange(), gossip=dcd, seed=RING_SEED,
        device=device, axis_name=axis)
    torch.cuda.synchronize()
    state = dcd.last[1]
    _, terms = dcd.birkhoff_terms(axis.n)
    return {"losses": [float(v) for v in res.losses],
            "consensus": [float(v) for v in res.consensus],
            "launches": [{k: v for k, v in per.items() if v}
                         for per, _ in dcd.calls],
            "total_launches": kernel.launch_counts(),
            "sent": dcd.sent,
            "message_bytes": dcd.message_bytes(params0, n_workers=axis.n),
            "mix_ms": [ms for _, ms in dcd.calls],
            "xhat": leaf_sha256(state["xhat"]),
            "nbr": [leaf_sha256(state["nbr"][k])
                    for k in range(len(terms))],
            "sources": [[s for s, d in perm if d == axis.index][0]
                        for _, perm in terms]}


def ranks_child(out_path: str, gloo) -> int:
    """One rank of the ranks phase (``chip_smoke.py --ranks-rank OUT``):
    an NCCL group from torchrun's variables (one rank a card), or
    (``--gloo RDV RANK WORLD``) a gloo group whose ranks share card 0;
    then ``ranks_ring``, ``ranks_hop`` and ``ranks_dcd`` to
    ``out_path``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import communicators

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0 if gloo else
                          int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    if gloo:
        rdv, rank, world = gloo
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=int(rank), world_size=int(world))
    else:
        dist.init_process_group("nccl", device_id=device)
    try:
        axis = communicators.RankAxis()
        problem = ring_problem(torch, device)
        res = {"rank": axis.index, "world": axis.n,
               "backend": axis.backend,
               "ring": ranks_ring(torch, axis, device, problem)}
        res["hop"] = ranks_hop(torch, axis, device)
        res["breakdown"] = ranks_breakdown(torch, axis, device, problem)
        gc.collect()
        torch.cuda.empty_cache()
        res["dcd"] = ranks_dcd(torch, axis, device, problem)
    finally:
        dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(res))
    return 0


def ranks_want(n: int) -> tuple:
    """A rank's launches a step from the geometry: the ring (K1 and K2
    encode its own partition, K5 n - 1 hops, K3 decodes n partitions)
    and DCD rq4 on the ring (one whole-model encode, its own decode and
    one a neighbour)."""
    from repro_torch.core import communicators
    from repro_torch.kernels.quant import ops

    _, nb_p, _ = ops.partition_geometry(TRAIN_TOTAL, n, bits=4)
    per = 1 if nb_p == 1 else 2          # launches an encode or a decode
    ring = {"minmax_bucketed": 1, "encode_packed": per,
            "decode_add_encode_bucketed": n - 1, "decode_packed": n * per}
    k = len(communicators.DCDGossipExchange().birkhoff_terms(n)[1])
    return ring, {"minmax_bucketed": 1, "encode_packed": 2,
                  "decode_packed": 2 * (1 + k)}


def ranks_check(ranks: list, backend: str, world: int, step0: list) -> None:
    """The ranks of one run: ``backend`` at ``world``; each step's
    launches as the geometry gives them and bytes sent equal to
    ``message_bytes``; consensus 0 and every rank's final params, losses
    and step-0 update equal (bit for bit), step 0 equal to the stacked
    ring's at RING_WORKERS; DCD's replicas equal their sources' public
    copies bit for bit."""
    want_ring, want_dcd = ranks_want(world)
    for res in ranks:
        if (res["backend"], res["world"]) != (backend, world):
            raise AssertionError(f"ran {res['backend']} at world "
                                 f"{res['world']}, not {backend} {world}")
        for part, want in (("ring", want_ring), ("dcd", want_dcd)):
            run = res[part]
            for t, per in enumerate(run["launches"]):
                if per != want:
                    raise AssertionError(f"{backend} rank {res['rank']} "
                                         f"{part} step {t}: launches {per}, "
                                         f"the geometry gives {want}")
            if any(b != run["message_bytes"] for b in run["sent"]):
                raise AssertionError(f"{backend} rank {res['rank']} {part}:"
                                     f" sent {run['sent']} B, message_bytes"
                                     f" {run['message_bytes']}")
            if not all(math.isfinite(v) for v in run["losses"]):
                raise AssertionError(f"{part}: non-finite loss")
        ring = res["ring"]
        if any(c != 0.0 for c in ring["consensus"]):
            raise AssertionError(f"{backend}: consensus {ring['consensus']}")
        for key in ("final", "step0", "losses"):
            if ring[key] != ranks[0]["ring"][key]:
                raise AssertionError(f"{backend}: replicas differ ({key})")
        dcd = res["dcd"]
        for src, got in zip(dcd["sources"], dcd["nbr"]):
            if got != ranks[src]["dcd"]["xhat"]:
                raise AssertionError(f"{backend} rank {res['rank']}: DCD "
                                     f"replica of rank {src} differs")
    if world == RING_WORKERS and ranks[0]["ring"]["step0"] != step0:
        raise AssertionError(f"{backend}: step 0 differs from the stacked "
                             "ring's")


def ranks_summary(name: str, res: dict, card: str) -> dict:
    ring, hop = res["ring"], res["hop"]
    med = sorted(ring["step_ms"][1:])[len(ring["step_ms"][1:]) // 2]
    row = {"run": name, "rank": res["rank"], "world": res["world"],
           "backend": res["backend"], "median_step_ms": med,
           "first_step_ms": ring["step_ms"][0],
           "exchange_ms": ring["exchange_ms"],
           "tokens_per_s": res["world"] * RING_BATCH * RING_SEQ / (
               med / 1e3),
           "sent_bytes_per_step": ring["sent"][0],
           "hop": hop, "breakdown": res["breakdown"],
           "dcd_mix_ms": res["dcd"]["mix_ms"],
           "dcd_sent_bytes_per_step": res["dcd"]["sent"][0],
           "max_memory_allocated": ring["peak"],
           "losses": ring["losses"], "card": card}
    if res["backend"] == "gloo":
        row["through"] = "the host (gloo: host copies and TCP loopback)"
    log("[ranks] " + json.dumps(row))
    return row


def ranks_phase(torch, card: str) -> dict:
    """The ring cell through run_distributed(axis_name=...), one worker a
    rank: NCCL at world = the card count where there are two cards or
    more, and RING_WORKERS gloo ranks sharing card 0 always. Each run:
    the replicas bit for bit, step 0 equal to the stacked ring's (at
    RING_WORKERS), launches and bytes from the geometry; the hop's wire,
    K5 and both timed; a short DCD rq4 run, its replicas bit for bit."""
    import socket

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    step0 = ranks_stacked_step0(torch)
    gc.collect()
    torch.cuda.empty_cache()
    marks = {"stacked step 0": time.perf_counter() - t0}
    tmp = Path(tempfile.mkdtemp(prefix="ranks-", dir=ROOT / "build"))
    n = torch.cuda.device_count()
    runs = {}
    if n >= 2:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        outs = [tmp / f"nccl{r}.json" for r in range(n)]
        dp_spawn([["--ranks-rank", str(o)] for o in outs],
                 [dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port)) for r in range(n)],
                 timeout=RANKS_TIMEOUT)
        runs["nccl", n] = [json.loads(o.read_text()) for o in outs]
        marks["nccl"] = time.perf_counter() - t0
    outs = [tmp / f"gloo{r}.json" for r in range(RING_WORKERS)]
    dp_spawn([["--ranks-rank", str(o), "--gloo", str(tmp / "rdv"), str(r),
               str(RING_WORKERS)] for r, o in enumerate(outs)],
             [dict(os.environ) for _ in outs], timeout=RANKS_TIMEOUT)
    runs["gloo", RING_WORKERS] = [json.loads(o.read_text()) for o in outs]
    marks["gloo"] = time.perf_counter() - t0
    rows = []
    launches: dict = {}
    for (backend, world), ranks in runs.items():
        ranks_check(ranks, backend, world, step0)
        for res in ranks:
            rows.append(ranks_summary(f"{backend}-{world}", res, card))
            for part in ("ring", "dcd"):
                for k, v in res[part]["total_launches"].items():
                    launches[k] = launches.get(k, 0) + v
        log(f"[ranks] {backend} world {world}: replicas bit for bit, "
            + ("step 0 equal to the stacked ring's bit for bit, "
               if world == RING_WORKERS else "")
            + f"{ranks[0]['ring']['sent'][0]} B sent a rank a step "
            "(message_bytes), launches a step as the geometry gives them, "
            "DCD's replicas equal their sources' public copies")
    wall = time.perf_counter() - t0
    shutil.rmtree(tmp)
    log(f"[ranks] phase wall time {wall:.1f} s; at the end of each part: "
        + ", ".join(f"{k} {v:.1f}" for k, v in marks.items()))
    return {"rows": rows, "launches": launches, "wall_s": wall}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if sys.argv[1:2] in (["--dp-rank"], ["--ranks-rank"]):  # one rank
        gloo = sys.argv[4:7] if sys.argv[3:4] == ["--gloo"] else None
        child = dp_child if sys.argv[1] == "--dp-rank" else ranks_child
        return child(sys.argv[2], gloo)
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attn import kernel as flash
    from repro_torch.kernels.quant import kernel
    from repro_torch.kernels.wkv6 import kernel as wkv

    card = smi_line()
    log(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = nvcc.build_many([(kernel.SOURCE, kernel.LIBRARY),
                            (flash.SOURCE, flash.LIBRARY),
                            (wkv.SOURCE, wkv.LIBRARY)], force=True)
    log(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in libs)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in "
        "parallel)")

    timing = kernels_phase(torch)
    served = serve_phase(torch)
    cross_device_check(torch)
    trained = train_phase(torch)
    timing["qdq_bucketed"] = trained["qdq"]
    ringed = ring_phase(torch)
    timing["decode_add_encode_bucketed"] = ringed["dae"]
    prefilled = prefill_phase(torch)
    timing["flash_attention_bhsd"] = prefilled["k6"]
    backward = flash_backward_phase(torch)
    rwkv = rwkv_phase(torch)
    timing["wkv6_bhsk"] = rwkv["k7"]
    clustered = cluster_phase(torch)
    families = families_phase(torch)
    leafed = leaf_phase(torch, ringed["median_step_ms"])
    timing.update(leafed["timing"])
    kv = kv_phase(torch)
    fronted = frontends_phase(torch)
    mesh_phase(torch)
    dp = dp_phase(torch, card)
    ranked = ranks_phase(torch, card)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro.")))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")

    log("[launches] " + json.dumps({"serve": served["launches"],
                                    "train": trained["launches"],
                                    "ring": ringed["launches"],
                                    "prefill": prefilled["launches"],
                                    "rwkv": rwkv["launches"],
                                    "cluster": clustered["launches"],
                                    "families": families["launches"],
                                    "leaf": leafed["launches"],
                                    "frontends": fronted["launches"],
                                    "dp": dp["launches"],
                                    "ranks": ranked["launches"]}))
    rows = []
    for name, (replaces, source, bound_by) in KERNELS.items():
        t = timing[name]
        path = (served if name in SERVE_KERNELS else ringed
                if name in RING_KERNELS else prefilled
                if name in PREFILL_KERNELS else rwkv
                if name in RWKV_KERNELS else leafed
                if name in LEAF_KERNELS else trained)
        launches = path["launches"][name]
        if name in PREFILL_KERNELS:      # K6 also runs the families' and
            launches += (families["launches"][name]     # the frontends'
                         + fronted["launches"][name])   # paths
        if name in TRAIN_KERNELS:        # and K1, K4 the dp phase's runs
            launches += dp["launches"][name]
        launches += ranked["launches"].get(name, 0)   # the ranks' ring, DCD
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": bound_by or t["bound_by"],
               "library_ms": t["library_ms"]}
        log(json.dumps({"kernel": name, "kernel_ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"],
                        "launches": row["launches"],
                        "library_ms": t["library_ms"]}))
        rows.append(row)
    k6b = backward["k6b"]      # replaces no TPU kernel: its own line
    log(json.dumps({"kernel": "flash_attention_bwd_bhsd",
                    "kernel_ms": k6b["ms"], "plain_ms": k6b["plain_ms"],
                    "bound_ms": k6b["bound_ms"],
                    "launches": trained["flash_launches"][
                        "flash_attention_bwd_bhsd"],
                    "library_ms": k6b["library_ms"]}))
    log(json.dumps(mla_kernel_line(prefilled["geometries"], families)))
    log(json.dumps({"kernels": rows}))
    log(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
