#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds every kernel from the repo's sources
   (``text_to_image_tpu_torch/csrc/*.cu`` with nvcc, one process per source,
   all together);
2. holds each kernel against its plain PyTorch version at every shape the
   GAN-CLS 64 px and StackGAN 64 / 256 px sampling and training paths give
   it (bf16 and f32, batch 64 and the discriminator's 3 × 64 streams; the
   four batch-norm kernels at every train-mode BN call of every path, up to
   the 64×256²×64 input of Stage-II's last up-block, each output and the
   running state bit for bit between two runs and each plan read back from
   C; the 256 px discriminator's six convs at both batches) and at odd
   shapes that
   reach every code path (for ``conv5x5_s2_act``, ``deconv5x5_s2`` and
   ``upconv3x3`` the path each call takes is read back from the C entry
   point and held against the Python mirror of the rule; every wgmma tile
   with every split of K -- for the two parity kernels every plan the
   grouped plan chooses from, the resident kernel and A by TMA boxes or by
   cp.async included -- a split's output bit for bit between two runs; the
   upconv's combined weights from its kernel bit for bit against the torch
   version; for ``conditioning_join`` both paths; for the batch norm the
   scalar path), and each backward (autograd.Function; the train-mode batch
   norm's through its statistics) against torch.autograd through the plain
   version, in f32 with TF32 off; the up-block's two backward kernels,
   ``upconv3x3_dx`` and ``upconv3x3_dw``, against their plain versions at
   the StackGAN, C-PGGAN and odd shapes (bf16 and f32, bit for bit between
   two launches, each path and what each launch did read back from C:
   for dw the kernel's own write, parts summed across a cluster, the
   weight-gradient kernel ``conv5x5_s2_dw`` against its plain version at
   every main-path call (the 64 px and 256 px D's convs, the GAN-CLS
   generator's deconvs in their own weight layout) and the odd shapes
   (phase 3c: bf16 and f32, bit for bit twice, every path and mode
   reached, the RGB layers' staged rows among them), and both
   weight-gradient kernels at Cin·Co over 1 M (bf16 on chip with no
   workspace; the up-block's f32 tile walking Cin in chunks; an up-block
   of that size forward and backward through its Function); the conv's
   input gradient ``conv5x5_s2_dx`` at every D call of both batches and
   at odd shapes (its route read back from C against the mirror, its
   plan's modes, bit for bit twice, every plan it takes at each deep call,
   its Function's first and second order in bf16 against autograd through
   the plain version), the RGB layer's dx and forward on the thin path of
   ``deconv5x5_s2`` and that path at Co 1-4 on odd maps; the transposed
   conv's input gradient ``deconv5x5_s2_dx`` (the ring and the thin path
   of ``down0.cuh``) at the generator's calls, the gradient penalty's
   critic first layer and odd shapes, alike (its path read back from C,
   bit for bit twice, every plan at each shape, its Function at first
   and second order), f32 and ragged channels on the
   conv of the flipped weight; the 3×3 stride-1 conv's kernels
   (``conv3x3_act``, ``act_grad``, ``conv3x3_dx``, ``conv3x3_dw``; phase
   3d) at every C-PGGAN 256 px and StackGAN Stage-II shape against their
   plain versions, bit for bit twice, and their Functions at second order
   (act_grad's at third);
3. drives the sampling path at the flagship widths (gf 128, z 100,
   embed 1024, batch 64, bf16) through ``eval/sampler.py`` — the sample grid
   and both interpolation grids — plus the BN-folded serving generator, with
   every launch counter set to 0 just before and read just after; checks the
   images (finite, shape, tanh range) and holds the generator against the
   same code on the CPU, where every kernel is its plain version;
4. drives the training path, the loop of ``main.py --train`` on synthetic
   data at flagship widths (df 64, batch 64, bf16), for a few ticks with the
   counters set to 0 just before and read just after: every loss finite,
   every parameter tree changed, the D running statistics moved; then one
   tick at batch 8 in f32 on the card against the same tick on the CPU
   (plain versions): losses, then params after Adam;
4b. drives the StackGAN paths at the full width of
   ``configs/stackgan_stage{1,2}_flowers.yml`` (gf 128, df 64, ca 128, batch
   64, bf16; Stage-II at 256 px over a frozen 64 px Stage-I drawn from the
   seed): the three grids of ``main.py`` for each stage, then 3 ticks of
   ``main.py --train`` for each stage, with the launch counts of all eight
   kernels, finite losses (``kl`` too), every trained leaf moved and the
   frozen Stage-I bit-identical; both generators against the CPU; one f32
   Stage-II tick at batch 4 on the card against the CPU;
4c. drives the data, checkpoint and resume path: writes an
   Oxford-102-sized StackGAN-format split from the seed (7,034 + 1,155
   examples, 76²×3 uint8, 10 × 1024 f32 captions, 102 classes), trains
   GAN-CLS from it with ``main.py --train`` at full width on the resident
   tier (snapshots, grids, metrics, launches a tick and a grid,
   ``max_to_keep``), stops at step 3 and resumes in a second call (the
   restore bit-equal to the snapshot, every tick's batch bit-identical to
   the straight run's, the final state against the straight run's), trains
   Stage-I with the EMA and Stage-II over that run directory (the frozen
   Stage-I bit-equal to the EMA), and times the tick through the resident
   and the host tier and a checkpoint's save and restore at full width;
   every run writes under ``build/smoke_runs_*``, removed at the end;
4d. drives WGAN-CLS and C-PGGAN: 3 ticks of ``main.py --train`` at the
   full width of ``configs/wgancls_flowers.yml`` (n_critic 5, the gradient
   penalty through the conv and join kernels, the layer-norm critic; the
   launches a tick of every kernel, the critic's GP forwards counted;
   finite d_loss, w_dist, d_wrong, gp, g_loss); one critic update's
   parameter gradients (GP included) of the kernel critic against the plain
   critic on the card at batch 64, f32 and bf16; one WGAN-CLS tick on the
   card against the CPU (n_critic 1, batch 8, f32); ``upconv3x3_bias`` with
   lrelu against its plain version at the six C-PGGAN up-block shapes (bf16
   and f32, path read back from C, bf16 timed); the whole C-PGGAN
   progression of ``configs/pggan_flowers.yml`` through ``main.py --train``
   at full width (5 stages × 2 ticks: each stage restores the last, α ramps
   0 → 1, grids at α = 1 and the stage's resolution, upconv launches per
   stage); one stage-7 tick of ``configs/pggan_flowers_256.yml`` (batch 32),
   with the 3×3 family's launches in it held to the count the model's
   layers give and none of its 3×3 calls on the library;
   then the WGAN-CLS and the stage-5 C-PGGAN ticks timed and profiled, and
   the gradient penalty's share of a critic update and the cost of the dw
   its inner gradient forms unasked;
4e. drives the Inception-score eval, ``main.py --eval-is`` at full width
   (phase 10, after every other phase): GAN-CLS over 4c's split with the
   SimpleCNN finetuned on its train images, then with a 102-class
   InceptionV3 ``<data_dir>/inception.npz`` drawn from the seed; Stage-II at
   256 px with that ``.npz``; each with its generator launch counts, the IS
   finite and in range, and its images/s.  Then the InceptionV3's logits
   and an IS on the card against the CPU (f32), the IS and the
   InceptionV3's time with TF32 allowed and off, the generators',
   SimpleCNN's and InceptionV3's times, and the synthetic-quality protocol
   (``evaluate``, ``evaluate_iv3``);
4f. checks data parallelism on the card (phase 11): ``bn_partials``
   and ``bn_finish`` at every BN call of the GAN-CLS tick cut into 1, 2 and
   4 pieces (against their plain versions, bit for bit between two runs,
   the merged statistics against one ``bn_stats``, the synced backward
   against autograd), timed on a rank's half; in one launch of 2 ranks
   sharing the card over gloo (the eight specs below in turn, one start-up
   for all): GAN-CLS at full width against one process at batch 64 (f32:
   the JAX package's DP tolerances over every element, the all-reduced
   gradients of a tick at learning rate 0; bf16: the ranks bit-identical,
   the launches a rank and tick), WGAN-CLS with GAN-INT and C-PGGAN stage
   4 the same way; G's elements that end past the bound named with their
   gradients at every update, and one process against itself on the rows
   permuted beside each f32 GAN-CLS comparison; one rank over nccl with
   the data-parallel path forced against the tick without a group (ms,
   launches, bytes all-reduced, one tick of each profiled); ``main.py
   --train`` in a group of one rank against none (equal launches, no
   collective); and ``torchrun`` of ``main.py --train``
   on 2 ranks over the sharded tier of 4c's split, 3 + 3 ticks
   bit-identical to 6;
4g. drives the port's root surfaces (phases 12-14): ``entry.entry()`` on
   the kernels against the same function on their plain versions on the
   card, with its launches and ms; ``entry.dryrun_multichip(8)``, 8 gloo
   ranks sharing the card on JAX's two meshes with the ``stem`` and
   ``embed`` linears column-parallel over ``model``, every rank's
   launches; ``python -m text_to_image_tpu_torch.bench`` at its defaults
   (rc 0, every value a number);
4h. drives every ported script (phase 15, last) through its ``main`` at a
   few steps, with the launch counts of the kernels each path runs (the
   GAN-CLS kernels for ``convergence_check`` and ``profile_step``; upconv,
   conv, join and BN for ``chained_stackgan`` and ``stage2_dynamics``;
   upconv for ``pggan_progression`` and ``serve_profile``): each reported
   number finite, the PASS / FAIL lines printed (not held at this length;
   the full-length runs of ``PERF.md`` hold them), the files each writes
   (the class grid, checkpoints, ``best.json`` beside the best checkpoint,
   the 256 px grid, the trace); the StackGAN chain with ``--traj`` and then
   ``--resume`` after an interruption before Stage-II's first snapshot
   (the replayed evals leave ``best.json`` and its checkpoint alone);
   ``convert_inception`` on a nested ``module.``-prefixed checkpoint read
   back bit for bit; ``e2e_demo`` and ``parity_runbook`` whole (their raw JPGs through Pillow;
   their ``main.py`` runs are processes of their own;
   the runbook at its defaults as ``python -m`` in the background of the
   untimed scripts);
   ``tools/bench_kernels`` at its defaults and with ``--upconv --conv
   --deconv --conv3x3 --grad``, every row a number.  Each phase's seconds are logged
   and reported;
5. times each kernel, its plain version and one PyTorch library call at
   those shapes (CUDA events, L2 flushed before each launch), computes each
   kernel's bound, prints the path, tile and split of each conv, join,
   deconv and upconv call with its TFLOP/s and GB/s, times each batch-norm
   call forward and with its backward beside ``F.batch_norm``, times the
   backward passes, sampling in images/s and the
   training ticks (GAN-CLS, Stage-I, Stage-II) in ms and images/s with
   their peak memory, and profiles where a forward's and a tick's device
   time goes (torch.profiler; GAN-CLS and Stage-II); the profiled GAN-CLS
   and WGAN-CLS ticks launch no library convolution over a 5×5 filter, and
   ``conv5x5_s2_dw`` as often as counted.

Every f32 comparison on the card runs with TF32 off
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False, set at the start).
Weights are random, from a seed.  It prints the card's name and power limit
and a ``{"kernels": [...]}`` line, writes the full report to
``chiprun_out/chip_smoke.json``, and ends with
``{"ok": true, "device": {...}}``.  Any failure raises: no result line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# the package beside this script: the timing method shared with the kernel
# microbench, and the tick timing shared with tools/tick_ab.py
from text_to_image_tpu_torch.tools.bench_kernels import (
    CONV3X3_SHAPES, PGGAN_UPCONV_SHAPES, L2Flush, bound, bwd_path_tag,
    conv_dw_tag, nbytes, s2_ops, time_ms, up_taps)
from text_to_image_tpu_torch.tools.ticks import (
    config_path, is_kernel, kernel_family, train_config)
from text_to_image_tpu_torch.tools.ticks import (
    tick_profile as phase_tick_profile, tick_timing as phase_tick_timing)

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 64
# kernel vs plain version: bf16 outputs may differ by a rounding flip
# (1 ulp = 2^-7 relative) after f32 sums taken in another order; f32 by the
# sum order only
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
BN_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
# whole generator, GPU kernels vs the CPU plain path (train-mode BN over
# the batch; bf16 rounds at every layer)
G_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
# (B, H, W, Cin) → Co, act: the 64 px generator's deconv calls
DECONV_SHAPES = [((BATCH, 4, 4, 1024), 512, "relu"),
                 ((BATCH, 8, 8, 512), 256, "relu"),
                 ((BATCH, 16, 16, 256), 128, "relu"),
                 ((BATCH, 32, 32, 128), 3, "tanh")]
# the BN inputs that the bn_act calls see
BN_SHAPES = [(BATCH, 4, 4, 1024), (BATCH, 8, 8, 512), (BATCH, 16, 16, 256),
             (BATCH, 32, 32, 128)]
# off the main path: ragged channels and odd maps, so that every code path
# of each kernel is held against its plain version too
ODD_DECONV_SHAPES = [((2, 5, 7, 12), 20, "lrelu"), ((3, 8, 8, 8), 16, "none"),
                     ((2, 5, 7, 6), 3, "tanh"), ((2, 4, 4, 16), 2, "relu")]
# the thin path (bf16, Co <= 4, Cin a multiple of 16) off the main path:
# Co 1-4 on odd and non-square maps, a row of two 64-pixel segments, Cin
# 16 / 32 / 48 (32- and 64-byte K slices) and 512, B 1; f32 takes the
# direct kernel
THIN_ODD_SHAPES = [((2, 5, 7, 16), 1, "relu"), ((2, 9, 6, 48), 2, "lrelu"),
                   ((3, 7, 70, 32), 4, "none"), ((1, 3, 5, 64), 3, "tanh"),
                   ((2, 4, 4, 512), 3, "tanh"), ((1, 11, 13, 128), 2, "none")]
# off the main path, (input, streams, act): the scalar path (C = 20), four
# channel slices the last of one group (C = 200), three streams of ragged C
ODD_BN_CALLS = [((3, 5, 7, 20), 1, "tanh"), ((2, 3, 3, 200), 1, "lrelu"),
                ((6, 5, 7, 20), 3, "relu")]
# the 64 px discriminator: the D step runs the real, fake and wrong streams
# in one pass of 3·64, the G step's D call one stream of 64
D_BATCH = 3 * BATCH


def conv_shapes(b):
    """(B, H, W, Cin) → Co, act: the D down-block calls at batch b."""
    return [((b, 64, 64, 3), 64, "lrelu"), ((b, 32, 32, 64), 128, "none"),
            ((b, 16, 16, 128), 256, "none"), ((b, 8, 8, 256), 512, "none")]


def conv_shapes_256(b):
    """The 256 px D's six down-block calls at batch b (growth capped at
    8·df): the first is the largest input a kernel of the port reads
    (192×256²×3), its output the largest a conv writes (192×128²×64)."""
    return [((b, 256, 256, 3), 64, "lrelu"), ((b, 128, 128, 64), 128, "none"),
            ((b, 64, 64, 128), 256, "none"), ((b, 32, 32, 256), 512, "none"),
            ((b, 16, 16, 512), 512, "none"), ((b, 8, 8, 512), 512, "none")]


def join_shape(b):
    """(B, H, W, Cx), E, Co: the D text join at batch b."""
    return (b, 4, 4, 512), 128, 512


# the D-side bn_act inputs per stream (lrelu): down1-3; the join's output
# has down3's shape
D_BN_SHAPES = [(BATCH, 16, 16, 128), (BATCH, 8, 8, 256), (BATCH, 4, 4, 512)]
# the bn_act inputs that only the StackGAN paths give (with BN_SHAPES and
# D_BN_SHAPES these are all of them).  Generators, relu: Stage-I's last
# up-block; Stage-II's encoder (32²×256, 16²×512; the join and the residual
# blocks repeat the latter) and its four up-blocks, the last the largest call
# of the port (64×256²×64).  The 256 px D per stream, lrelu: down1-5; the
# join's output has down5's shape
STACKGAN_BN_SHAPES = (
    [(s, "relu") for s in ((BATCH, 64, 64, 64), (BATCH, 32, 32, 256),
                           (BATCH, 16, 16, 512), (BATCH, 64, 64, 128),
                           (BATCH, 128, 128, 64), (BATCH, 256, 256, 64))]
    + [(s, "lrelu") for s in ((BATCH, 64, 64, 128), (BATCH, 32, 32, 256),
                              (BATCH, 16, 16, 512), (BATCH, 8, 8, 512),
                              (BATCH, 4, 4, 512))])
# every train-mode BN call of every path as (input, streams, act): the
# GAN-CLS and Stage-I generators' stem and up-blocks (relu); the 64 px D over
# the D step's three streams of 64 and the G step's one (down1-3, the join's
# output; lrelu); the StackGAN generators' other calls (relu; the residual
# blocks' second BN has no activation); the 256 px D at both batches
BN_CALLS = list(dict.fromkeys(
    [(s, 1, "relu") for s in BN_SHAPES]
    + [((k * BATCH, *s[1:]), k, "lrelu") for k in (3, 1) for s in D_BN_SHAPES]
    + [(s, 1, a) for s, a in STACKGAN_BN_SHAPES if a == "relu"]
    + [((BATCH, 16, 16, 512), 1, "none")]
    + [((k * BATCH, *s[1:]), k, a) for k in (3, 1)
       for s, a in STACKGAN_BN_SHAPES if a == "lrelu"]))
# the batch-norm statistics (mean, rstd, a, b, running state), kernel vs
# plain version: f32 sums over up to 4 M rows in another order
STATS_TOL = (1e-5, 1e-5)
# ~2 ms of device spin: longer than the host takes to enqueue a batch-norm
# call forward and backward through autograd
HOST_SPIN = 4_000_000
# the four batch-norm kernels by the step of a call each one times
BN_STEPS = {"bn_stats": "stats", "bn_act": "apply", "bn_bwd_reduce": "reduce",
            "bn_bwd_apply": "dx"}
# off the main path, reaching the direct (Cin <= 4), pipelined (aligned
# bf16) and simple-tile (f32, ragged) code paths, and odd maps (SAME pads 2)
ODD_CONV_SHAPES = [((2, 5, 7, 12), 20, "tanh"), ((3, 9, 6, 6), 10, "relu"),
                   ((2, 8, 8, 16), 8, "lrelu"), ((2, 7, 7, 2), 5, "none"),
                   ((2, 6, 6, 4), 3, "lrelu")]
ODD_JOIN_SHAPES = [((5, 3, 3, 12), 7, 20, "lrelu"),
                   ((4, 4, 4, 16), 8, 24, "tanh"),
                   ((3, 2, 2, 8), 16, 8, "relu")]
# shapes that reach the conv's two tensor-core paths off the main path:
# wgmma (bf16, Cin and Co multiples of 64) on odd, non-square maps, B = 1, M
# not a multiple of any tile, Co = 192 (64-wide tiles only) and Co = 256
# (every tile); down0 on the tensor cores (bf16, Cin <= 4, Co = 64) on odd
# maps and with Cin = 1, 2, 4; and shapes that just miss them (Co or Cin a
# multiple of 8 but not of 64: the pipelined tile; Cin <= 4 with another Co:
# the direct kernel).  In f32 all of them take the simple tile or the direct
# kernel.
WGMMA_ODD_SHAPES = [((1, 9, 7, 64), 64, "lrelu"), ((3, 10, 6, 128), 192, "none"),
                    ((3, 11, 9, 64), 256, "tanh")]
DOWN0_ODD_SHAPES = [((2, 9, 7, 3), 64, "lrelu"), ((2, 8, 8, 4), 64, "relu"),
                    ((3, 33, 17, 1), 64, "none"), ((2, 20, 40, 2), 64, "tanh")]
NEAR_MISS_CONV_SHAPES = [((2, 8, 8, 64), 72, "lrelu"), ((2, 8, 8, 72), 64, "none"),
                         ((2, 6, 6, 3), 32, "lrelu"), ((2, 9, 9, 5), 64, "none")]
# the path each list takes in bf16 (in f32: "direct" for Cin <= 4, else
# "tile")
CONV_PATH_BF16 = {"wgmma": WGMMA_ODD_SHAPES, "down0_mma": DOWN0_ODD_SHAPES}
NEAR_MISS_PATHS_BF16 = ["pipelined", "pipelined", "direct", "tile"]
# the join's wgmma path (bf16; Cx, E, Co multiples of 64) with H·W not a
# power of two, rows not a multiple of the tile, Co = 192; and one that just
# misses it (Co = 72: the simple tile)
WGMMA_JOIN_SHAPES = [((5, 3, 3, 64), 64, 64, "lrelu"),
                     ((2, 4, 4, 128), 64, 192, "tanh")]
NEAR_MISS_JOIN_SHAPES = [((2, 4, 4, 64), 64, 72, "none")]
# f32 conv: K = 25·Cin up to 12800 terms (the 256 px D's last two blocks)
# summed in another order than the plain version's 25 matmuls
CONV_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-4, 1e-4)}
# f32 backward vs torch.autograd through the plain version: 1e-4 of the
# largest |gradient| plus 1e-4 relative (sums of up to B·H·W·25 products)
GRAD_REL = 1e-4
# one training tick on the card vs the CPU (f32, TF32 off, batch 8): losses
# within 1e-4 + 1e-4·|ref|; params after Adam within 1e-6 (0.5 % of the LR
# 2e-4), where the gradient is clear of 0 (|mu| > 1e-3·max|mu| of the leaf:
# Adam's first step is lr·sign(g), so a near-zero g may flip).  A bias in
# front of a train-mode BN has a zero true gradient, so Adam turns its
# round-off into ±lr steps: those leaves are left out (see also
# phase_card_vs_cpu).
LOSS_TOL = 1e-4
PARAM_TOL = 1e-6
TRAIN_TICKS = 3
# launches per training tick.  A train-mode BN call is one bn_stats + one
# bn_act forward and, where it is differentiated, one bn_bwd_reduce + one
# bn_bwd_apply, whatever its number of streams.  The D step: G forward
# without gradient (4 deconv; 4 BN calls: stem, up0-2) and D over the three
# streams in one pass (4 conv, 1 join; 4 BN calls: down1-3, join;
# differentiated); then each of the 2 G steps: G (4 deconv, 4 BN) and D on
# one stream (4 conv, 1 join, 4 BN), both differentiated.  BN calls forward
# 4 + 4 + 2·(4 + 4) = 24, backward 4 + 2·(4 + 4) = 20.  The 5×5 backwards
# run on the kernels too (ops/kernels/conv.py): a conv's dx is one
# conv5x5_s2_dx launch where its Cin and Co are multiples of 64 (bf16:
# down1-3, `conv_dx_path`), else one deconv5x5_s2 launch (the RGB layer
# down0, Cin 3: the thin path); a deconv's dx one deconv5x5_s2_dx launch
# (bf16: the ring for the three deep layers, the thin path for the RGB
# layer; `deconv_dx_path`); each one's dw one conv5x5_s2_dw.  The D step
# differentiates D's 4 convs in w and down1-3 in x (the images need no
# gradient): 4 dw, 3 dx; each G step D's 4 convs in x only (D is not
# trained there: 3 dx and down0's deconv) and G's 4 deconvs in x and w (4
# deconv5x5_s2_dx, 4 dw).  deconv 12 + 2·1 = 14, conv5x5_s2_dx 3 + 2·3 =
# 9, deconv5x5_s2_dx 2·4 = 8, conv 12, dw 4 + 2·4 = 12.
TICK_LAUNCHES = {"deconv5x5_s2": 14, "conv5x5_s2_dx": 9,
                 "deconv5x5_s2_dx": 8, "bn_stats": 24,
                 "bn_act": 24, "bn_bwd_reduce": 20, "bn_bwd_apply": 20,
                 "conv5x5_s2_act": 12, "conditioning_join": 3,
                 "conv5x5_s2_dw": 12}
# the up-block's forward and its two backward kernels, on a path without one
NO_UPCONV = {"upconv3x3": 0, "upconv3x3_dx": 0, "upconv3x3_dw": 0}


# (B, H, W, Cin) → Co: the upconv3x3_bias calls of the 64 px Stage-I
# generator and of the 256 px Stage-II generator (act "none": a BN follows)
UPCONV_SHAPES = {
    "stage1": [((BATCH, 4, 4, 1024), 512), ((BATCH, 8, 8, 512), 256),
               ((BATCH, 16, 16, 256), 128), ((BATCH, 32, 32, 128), 64)],
    "stage2": [((BATCH, 16, 16, 512), 256), ((BATCH, 32, 32, 256), 128),
               ((BATCH, 64, 64, 128), 64), ((BATCH, 128, 128, 64), 64)]}
# off the main path: ragged channels (the simple tile), aligned bf16 on odd
# maps (the pipelined tile), B = 1, every activation
ODD_UPCONV_SHAPES = [((2, 5, 7, 12), 20, "lrelu"), ((3, 7, 5, 8), 16, "tanh"),
                     ((1, 3, 3, 5), 3, "relu"), ((2, 6, 9, 16), 8, "none")]
# the grouped wgmma path of both kernels (bf16, Cin and Co multiples of
# 64) off the main path: B = 1, M not a multiple of any tile, odd and
# non-square maps (A gathered by cp.async), Cin 64 with Co 192 (64-wide
# tiles only), and power-of-two maps whose tiles span several images, the
# last one partly past the batch (A as TMA boxes, zero-filled)
WGMMA_DECONV_ODD_SHAPES = [((1, 5, 7, 64), 64, "relu"),
                           ((3, 5, 3, 128), 192, "lrelu"),
                           ((2, 7, 9, 64), 256, "tanh"),
                           ((2, 6, 5, 64), 192, "none"),
                           ((1, 4, 8, 64), 128, "none"),
                           ((3, 8, 4, 128), 192, "lrelu")]
# upconv3x3_dw's on-chip fold off the main path: its 32-column tile at Co
# 96 and 32, K of one or two slices, maps of several images a box
FOLD_UPCONV_ODD_SHAPES = [((2, 4, 4, 64), 96), ((3, 2, 8, 64), 32),
                          ((2, 8, 8, 128), 32)]
# upconv3x3_dx's TMA kernels off the main path: Co 32 on the ring kernel
# with M not a multiple of the 128-row tile (the last box partly past the
# batch), B = 1 (one box of two images, one of them past it), the
# transposed kernel on a non-square map of 256-pixel rows with two column
# tiles (Cin 128) and at Co 32 on 384-pixel rows, Co 96 (three 32-channel
# slices a tap, parts in a cluster), and a map with no box (the gather
# loop, its parts through a workspace)
DX_ODD_SHAPES = [((5, 4, 8, 64), 32), ((1, 8, 8, 128), 64),
                 ((1, 2, 256, 128), 64), ((2, 2, 384, 64), 32),
                 ((2, 4, 4, 128), 96), ((2, 3, 5, 64), 64)]
# C-PGGAN's 128²×64→32 at batch 64 too (stage 7 runs it at 32)
DX_CO32_B64 = [((64, 128, 128, 64), 32)]
WGMMA_UPCONV_ODD_SHAPES = [((1, 5, 7, 64), 64, "relu"),
                           ((3, 5, 3, 128), 192, "lrelu"),
                           ((2, 7, 9, 64), 128, "tanh"),
                           ((2, 6, 5, 64), 192, "none"),
                           ((1, 4, 8, 64), 64, "none"),
                           ((3, 8, 4, 128), 192, "lrelu"),
                           ((2, 16, 8, 128), 64, "relu")]
# StackGAN launches per training tick (n_critic 1, g_steps 1, remat off),
# BN calls counted as above.  Stage-I: two G forwards (4 upconv; 5 BN calls:
# stem, up0-3), the first without gradient; D over three streams and over
# one (4 conv, 1 join, 4 BN calls each), both differentiated.  BN forward
# 5 + 4 + 5 + 4 = 18, backward 4 + 5 + 4 = 13.  Stage-II: two G forwards,
# each the frozen Stage-I (4 upconv, 5 BN calls, never differentiated) plus
# Stage-II (4 upconv; 11 BN calls: enc1-2, join, two per residual block,
# up0-3); the 256 px D has six down-blocks (6 conv, 1 join; 6 BN calls:
# down1-5, join), over three streams and over one.  BN forward
# 16 + 6 + 16 + 6 = 44, backward 6 + 11 + 6 = 23.  In both stages the G
# step differentiates the 4 up-blocks it trains: 4 upconv3x3_dx (the first
# block's input comes from the trained stem) and 4 upconv3x3_dw a tick.
# The D's convs as in TICK_LAUNCHES: the D step's dw of each and dx of all
# but the first, the G step's dx of each (no deconv forward): Stage-I 3 + 4
# (6 conv5x5_s2_dx, down0's one deconv5x5_s2), Stage-II 5 + 6 (10 and 1).
STACKGAN_TICK_LAUNCHES = {
    "stackgan_stage1": {"upconv3x3": 8, "upconv3x3_dx": 4,
                        "upconv3x3_dw": 4, "bn_stats": 18, "bn_act": 18,
                        "bn_bwd_reduce": 13, "bn_bwd_apply": 13,
                        "conv5x5_s2_act": 8, "conditioning_join": 2,
                        "deconv5x5_s2": 1, "conv5x5_s2_dx": 6,
                        "deconv5x5_s2_dx": 0, "conv5x5_s2_dw": 4},
    "stackgan_stage2": {"upconv3x3": 16, "upconv3x3_dx": 4,
                        "upconv3x3_dw": 4, "bn_stats": 44, "bn_act": 44,
                        "bn_bwd_reduce": 23, "bn_bwd_apply": 23,
                        "conv5x5_s2_act": 12, "conditioning_join": 2,
                        "deconv5x5_s2": 1, "conv5x5_s2_dx": 10,
                        "deconv5x5_s2_dx": 0, "conv5x5_s2_dw": 6}}
# per sampling forward (train-mode BN, no gradient): Stage-I 4 upconv + 5 BN
# calls; Stage-II 8 upconv (4 of them in the frozen Stage-I) + 16 BN calls
STACKGAN_FORWARD_LAUNCHES = {
    "stackgan_stage1": {"upconv3x3": 4, "bn_stats": 5, "bn_act": 5},
    "stackgan_stage2": {"upconv3x3": 8, "bn_stats": 16, "bn_act": 16}}
# the Stage-II generator (a frozen Stage-I inside: 25 layers, train-mode
# BN) on the card vs the CPU plain path: f32 by the largest error; in bf16
# every layer rounds, so the mean error is held and the largest reported
S2_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(got, ref, atol, rtol, what):
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    max_err = float(err.max())
    log(f"  {what}: max|err| {max_err:.3e} (tol {atol:g} + {rtol:g}·|ref|)"
        f" {'ok' if not bad.any() else 'FAIL'}")
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements out of "
                               f"tolerance, max|err| {max_err:.3e}")
    return max_err


# --------------------------------------------------------------------------

def deconv_inputs(shape, co, dtype, device, gen):
    cin = shape[-1]
    x = torch.relu(torch.randn(shape, generator=gen)).to(dtype)
    w = (torch.randn(5, 5, cin, co, generator=gen) * 0.02).to(dtype)
    s = 1.0 + 0.1 * torch.randn(co, generator=gen)
    t = 0.1 * torch.randn(co, generator=gen)
    return [v.to(device) for v in (x, w, s, t)]


def bn_inputs(shape, dtype, device, gen):
    c = shape[-1]
    x = torch.randn(shape, generator=gen).to(dtype)
    a = 1.0 + 0.1 * torch.randn(c, generator=gen)
    b = 0.1 * torch.randn(c, generator=gen)
    return [v.to(device) for v in (x, a, b)]


def bn_train_inputs(shape, dtype, device, gen, misaligned=False):
    """x, γ, β, running mean and var of a train-mode BN call; with
    `misaligned` x is a view one element into its buffer (2 or 4 bytes off
    the 16-byte alignment of the vector path)."""
    c = shape[-1]
    x = (0.5 + 1.5 * torch.randn(shape, generator=gen)).to(dtype).to(device)
    if misaligned:
        buf = torch.empty(x.numel() + 8, dtype=dtype, device=device)
        x = buf[1:1 + x.numel()].view(shape).copy_(x)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen)
    beta = 0.1 * torch.randn(c, generator=gen)
    rm = 0.1 * torch.randn(c, generator=gen)
    rv = 1.0 + 0.2 * torch.rand(c, generator=gen)
    return [x] + [v.to(device) for v in (gamma, beta, rm, rv)]


def compare_all(pairs, atol, rtol, what, rel_to_max=False):
    """Each (name, got, ref) within atol + rtol·|ref| (with `rel_to_max`
    atol is taken relative to max|ref| of that output); one log line."""
    worst, pairs = 0.0, list(pairs)
    for name, got, ref in pairs:
        err = (got.float() - ref.float()).abs()
        tol = atol * (float(ref.float().abs().max()) if rel_to_max else 1.0)
        bad = err > tol + rtol * ref.float().abs()
        check(not bool(bad.any()), f"{what} {name}: {int(bad.sum())} "
                                   f"elements out of tolerance, max|err| "
                                   f"{float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    log(f"  {what}: max|err| {worst:.3e} over {[p[0] for p in pairs]} ok")
    return worst


def phase_bn_kernels(device):
    """The four batch-norm kernels against their plain versions at every
    train-mode BN call of every path and at the odd calls, bf16 and f32, on
    the same inputs: bn_stats (mean, rstd, a, b, the running state), bn_act
    (the apply pass over those a, b), bn_bwd_reduce (per-stream sums, dγ,
    dβ) and bn_bwd_apply (dx over those sums).  Every output and the
    running state bit-identical between two runs; the plan of every launch
    read back from the C entry point against the Python mirror.  One call on
    a misaligned x holds the scalar path at C % 8 == 0."""
    from text_to_image_tpu_torch.ops.kernels import fused
    gen = torch.Generator().manual_seed(SEED + 10)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    errs = {n: {} for n in ("bn_stats", "bn_act", "bn_bwd_reduce",
                            "bn_bwd_apply")}
    plans = {}
    calls = ([(c, False) for c in BN_CALLS + ODD_BN_CALLS]
             + [(((4, 8, 8, 64), 2, "lrelu"), True)])
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for (shape, s, act), misaligned in calls:
            x, gamma, beta, rm, rv = bn_train_inputs(shape, dtype, device,
                                                     gen, misaligned)
            tag = " misaligned" if misaligned else ""
            what = f"{dt} {shape} S={s} {act}{tag}"
            key = (dtype, (*shape, s, act + tag))
            c = shape[-1]
            stats = fused.bn_stats(x, s, gamma, beta, rm, rv)
            again = fused.bn_stats(x, s, gamma, beta, rm, rv)
            ref = fused.bn_stats_plain(x, s, gamma, beta, rm, rv)
            torch.cuda.synchronize()
            check(all(torch.equal(u, v) for u, v in zip(stats, again)),
                  f"bn_stats {what}: outputs differ between two runs")
            errs["bn_stats"][key] = compare_all(
                zip(("mean", "rstd", "a", "b", "new mean", "new var"), stats,
                    ref), *STATS_TOL, f"bn_stats {what}")
            mean, rstd, a, b = stats[:4]
            y = fused._bn_act_forward(x, a, b, act)
            check(torch.equal(y, fused._bn_act_forward(x, a, b, act)),
                  f"bn_act {what}: output differs between two runs")
            errs["bn_act"][key] = compare_all(
                [("y", y, fused.bn_act_plain(x, a, b, act))], *BN_TOL[dtype],
                f"bn_act {what}")
            g = torch.randn(shape, generator=gen).to(device, dtype)
            sums = fused.bn_bwd_reduce(g, y, x, mean, rstd, s, act)
            again = fused.bn_bwd_reduce(g, y, x, mean, rstd, s, act)
            ref = fused.bn_bwd_reduce_plain(g, y, x, mean, rstd, s, act)
            torch.cuda.synchronize()
            check(all(torch.equal(u, v) for u, v in zip(sums, again)),
                  f"bn_bwd_reduce {what}: outputs differ between two runs")
            errs["bn_bwd_reduce"][key] = compare_all(
                zip(("sum ga", "sum ga.xhat", "dgamma", "dbeta"), sums, ref),
                GRAD_REL, GRAD_REL, f"bn_bwd_reduce {what}", rel_to_max=True)
            dx = fused.bn_bwd_apply(g, y, x, mean, rstd, gamma, *sums[:2], s,
                                    act)
            check(torch.equal(dx, fused.bn_bwd_apply(
                g, y, x, mean, rstd, gamma, *sums[:2], s, act)),
                f"bn_bwd_apply {what}: output differs between two runs")
            errs["bn_bwd_apply"][key] = compare_all(
                [("dx", dx, fused.bn_bwd_apply_plain(
                    g, y, x, mean, rstd, gamma, *sums[:2], s, act))],
                *BN_TOL[dtype], f"bn_bwd_apply {what}")
            mirror = fused.bn_plan(x.numel() // c, s, c, not misaligned, sms)
            for others in ((), (y,), (g, y), (g, y, dx)):
                on_card = fused.bn_plan_on_card(x, s, *others)
                check(on_card == mirror, f"bn plan {what}: C {on_card}, "
                                         f"mirror {mirror}")
            plans[what] = list(mirror)
            del x, y, g, dx, stats, sums, ref
        torch.cuda.empty_cache()
    log(f"  {len(plans)} batch-norm calls: every plan read back from C equals "
        f"the mirror")
    return errs, plans


def conv_inputs(shape, co, dtype, device, gen):
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (torch.randn(5, 5, shape[-1], co, generator=gen) * 0.02).to(dtype)
    b = 0.1 * torch.randn(co, generator=gen)
    return [v.to(device) for v in (x, w, b)]


def join_inputs(shape, e, co, dtype, device, gen):
    x = torch.relu(torch.randn(shape, generator=gen)).to(dtype)
    t = torch.randn(shape[0], e, generator=gen).to(dtype)
    wx = (torch.randn(shape[-1], co, generator=gen) * 0.02).to(dtype)
    wt = (torch.randn(e, co, generator=gen) * 0.02).to(dtype)
    b = 0.1 * torch.randn(co, generator=gen)
    return [v.to(device) for v in (x, t, wx, wt, b)]


def grouped_tag(conv, path, plan, h, w):
    """The text of a grouped wgmma plan: tile, parts of K per parity or the
    resident kernel, and how A comes."""
    if path != "wgmma":
        return path
    a = "TMA" if conv.a_by_tma(h, w, plan) else "cp.async"
    kind = ("resident 128x64" if plan.resident else
            f"{plan.tile_m}x{plan.tile_n} parts {list(plan.parts)}")
    return f"wgmma {kind}, A by {a}"


def grouped_vs_plain(conv, op, args, dtype, what, want_path=None):
    """One deconv5x5_s2 or upconv3x3 call against its plain version; checks
    the path the C entry point reports against the Python mirror of the rule
    and against the expected one, a split output bit for bit against a
    second run, and returns (max |err|, path, plan)."""
    x, w = args[0], args[1]
    cin, co = x.shape[-1], w.shape[-1]
    b, h, wd = x.shape[:3]
    if op == "deconv":
        got = conv.deconv5x5_s2(*args)
        ref = conv.deconv5x5_s2_plain(*args)
        path = conv.deconv_path_on_card(x, w, got)
        mirror = conv.deconv_path(cin, co, dtype)
        want = want_path or expected_deconv_path(cin, co, dtype)
        plan = conv.deconv_plan(b * h * wd, co, cin) if path == "wgmma" else None
    else:
        got = conv.upconv3x3(*args)
        ref = conv.upconv3x3_plain(*args)
        path = conv.upconv_path_on_card(x, conv.combined_weights(w), got)
        mirror = conv.upconv_path(wd, cin, co, dtype)
        want = want_path or expected_upconv_path(cin, co, dtype, wd)
        plan = conv.upconv_plan(b * h * wd, co, cin) if path == "wgmma" else None
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{what}: shape {got.shape}")
    check(path == mirror == want, f"{what}: path {path}, mirror {mirror}, "
                                  f"expected {want}")
    err = compare(got, ref, *TOL[dtype],
                  f"{what} [{grouped_tag(conv, path, plan, h, wd)}]")
    if plan and max(plan.parts) > 1:
        again = (conv.deconv5x5_s2 if op == "deconv" else conv.upconv3x3)(*args)
        check(torch.equal(got, again), f"{what}: split output differs "
                                       f"between two runs")
    return err, path, plan


def every_grouped_plan(conv, op, shapes, device, gen):
    """Every plan the grouped wgmma path can be given (each tile that divides
    Co with each split of K per parity the plans choose from, the resident
    kernels) at `shapes`, bf16: within tolerance of the plain version and
    bit for bit between two runs."""
    dtype = torch.bfloat16
    taps = conv.DECONV_PARITY_TAPS if op == "deconv" else conv.UPCONV_PARITY_TAPS
    for shape, co, act in shapes:
        b, h, wd, cin = shape
        args = [*(deconv_inputs if op == "deconv" else upconv_inputs)(
            shape, co, dtype, device, gen), act]
        plain = conv.deconv5x5_s2_plain if op == "deconv" else conv.upconv3x3_plain
        fwd = conv._deconv_forward if op == "deconv" else conv._upconv_forward
        ref = plain(*args)
        plans = conv.grouped_candidates(b * h * wd, co, cin, taps)
        worst, same = 0.0, True
        for plan in plans:
            got = fwd(*args, plan=plan)
            again = fwd(*args, plan=plan)
            torch.cuda.synchronize()
            same = same and torch.equal(got, again)
            err = (got.float() - ref.float()).abs()
            bad = err > TOL[dtype][0] + TOL[dtype][1] * ref.float().abs()
            check(not bool(bad.any()), f"{op} plan {plan} at {shape}->{co}: "
                                       f"max|err| {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
        a = sorted({conv.a_by_tma(h, wd, p) for p in plans})
        log(f"  {op} bfloat16 {shape}->{co} {act}: {len(plans)} plans (A by "
            f"TMA {a}): max|err| {worst:.3e}, two runs bit-identical {same}")
        check(same, f"{op}: output differs between two runs at {shape}")


def phase_kernels(device):
    """deconv5x5_s2 against its plain version at every main-path shape and
    at odd ones; the public bn_act (a and b given)."""
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    gen = torch.Generator().manual_seed(SEED)
    errs = {"deconv5x5_s2": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, co, act in DECONV_SHAPES:
            args = [*deconv_inputs(shape, co, dtype, device, gen), act]
            errs["deconv5x5_s2"][(dtype, shape)] = grouped_vs_plain(
                conv, "deconv", args, dtype,
                f"deconv5x5_s2 {str(dtype)[6:]} {shape}->{co} {act}")[0]
        for shape, co, act in (ODD_DECONV_SHAPES + WGMMA_DECONV_ODD_SHAPES
                               + THIN_ODD_SHAPES):
            args = [*deconv_inputs(shape, co, dtype, device, gen), act]
            grouped_vs_plain(
                conv, "deconv", args, dtype,
                f"deconv5x5_s2 {str(dtype)[6:]} {shape}->{co} {act} (odd)")
        # the public bn_act (eval-mode BN, the folded stem) with a, b given
        for shape, s, act in ODD_BN_CALLS + [(BN_SHAPES[0], 1, "relu")]:
            x, a, b = bn_inputs(shape, dtype, device, gen)
            compare(fused.bn_act(x, a, b, act), fused.bn_act_plain(x, a, b, act),
                    *BN_TOL[dtype], f"bn_act {str(dtype)[6:]} {shape} {act} "
                                    f"(public, a and b given)")
    every_grouped_plan(conv, "deconv", WGMMA_DECONV_ODD_SHAPES, device, gen)
    return errs


def expected_conv_path(cin, co, dtype):
    """The path the port is meant to take for a contiguous torch tensor."""
    if dtype != torch.bfloat16:
        return "direct" if cin <= 4 else "tile"
    if cin <= 4:
        return "down0_mma" if co == 64 else "direct"
    if cin % 64 == 0 and co % 64 == 0:
        return "wgmma"
    return "pipelined" if cin % 8 == 0 and co % 8 == 0 else "tile"


def expected_deconv_path(cin, co, dtype):
    """The deconv path the port is meant to take for a contiguous tensor."""
    if co <= 4 and cin <= 512:
        return ("thin" if dtype == torch.bfloat16 and cin % 16 == 0
                else "direct")
    if dtype != torch.bfloat16:
        return "tile"
    if cin % 64 == 0 and co % 64 == 0:
        return "wgmma"
    return "pipelined" if cin % 8 == 0 and co % 8 == 0 else "tile"


# the code paths that no bf16 call on a main path may take any more: the
# mma.sync and FMA tiles of igemm.cuh and the FMA direct kernels (names of
# the *_PATHS tuples; a dw mode that shares a name is not a path)
PRE_HOPPER_PATHS = ("pipelined", "tile", "direct")


def pre_hopper_calls(tables):
    """(table, shape, path) of every call in `tables` (name → rows with a
    "path") whose code path, the path tag's first word, is one of
    PRE_HOPPER_PATHS."""
    return [(name, r.get("shape"), r["path"])
            for name, table in tables.items() for r in table
            if isinstance(r.get("path"), str)
            and (r["path"].split() or [""])[0] in PRE_HOPPER_PATHS]


def expected_upconv_path(cin, co, dtype, width):
    """The upconv path the port is meant to take for a contiguous tensor
    of x [B,H,width,Cin]."""
    if dtype != torch.bfloat16:
        return "tile"
    if cin % 64 == 0 and co % 64 == 0:
        return "wgmma"
    if cin == 64 and co % 32 == 0 and width % 128 == 0:
        return "co32"
    return "pipelined" if cin % 8 == 0 and co % 8 == 0 else "tile"


def conv_vs_plain(conv, x, w, bias, act, dtype, what, want_path=None):
    """One conv5x5_s2_act call against its plain version; checks the path
    that the C entry point reports against the Python mirror of the rule
    (and against `want_path`) and returns (max |err|, path, plan)."""
    got = conv.conv5x5_s2_act(x, w, bias, act)
    ref = conv.conv5x5_s2_act_plain(x, w, bias, act)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"conv shape {got.shape}")
    cin, co = x.shape[-1], w.shape[-1]
    path = conv.conv_path_on_card(x, w, got)
    mirror = conv.conv_path(cin, co, dtype)
    want = want_path or expected_conv_path(cin, co, dtype)
    check(path == mirror == want, f"{what}: path {path}, mirror {mirror}, "
                                  f"expected {want}")
    plan = (conv.conv_plan(got.numel() // co, co, 25 * cin)
            if path == "wgmma" else None)
    tag = f"{path} {plan[0]}x{plan[1]} split {plan[2]}" if plan else path
    err = compare(got, ref, *CONV_TOL[dtype], f"{what} [{tag}]")
    if plan and plan[2] > 1:
        again = conv.conv5x5_s2_act(x, w, bias, act)
        check(torch.equal(got, again), f"{what}: split-K output differs "
                                       f"between two runs")
    return err, path, plan


def phase_train_kernels(device):
    """conv5x5_s2_act and conditioning_join against their plain versions at
    the D's shapes (batch 3·64 and 64) and at odd shapes, bf16 and f32, with
    the code path each call takes; every wgmma plan (tile × split of K) at
    the odd shapes, split-K outputs bit-identical between two runs."""
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    gen = torch.Generator().manual_seed(SEED + 2)
    errs = {"conv5x5_s2_act": {}, "conditioning_join": {}}
    paths = {}

    def join_vs_plain(shape, e, co, act, dtype, want, note=""):
        args = join_inputs(shape, e, co, dtype, device, gen)
        got = fused.conditioning_join(*args, act)
        ref = fused.conditioning_join_plain(*args, act)
        torch.cuda.synchronize()
        path = fused.join_path_on_card(*args[:4], got)
        mirror = fused.join_path(shape[-1], e, co, dtype)
        check(path == mirror == want, f"join {shape}: path {path}, mirror "
                                      f"{mirror}, expected {want}")
        return compare(got, ref, *CONV_TOL[dtype],
                       f"conditioning_join {str(dtype)[6:]} {shape} e{e}->{co} "
                       f"{act}{note} [{path}]")

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        for b in (D_BATCH, BATCH):
            for shape, co, act in conv_shapes(b):
                x, w, bias = conv_inputs(shape, co, dtype, device, gen)
                err, path, plan = conv_vs_plain(
                    conv, x, w, bias, act, dtype,
                    f"conv5x5_s2_act {dt} {shape}->{co} {act}")
                errs["conv5x5_s2_act"][(dtype, shape)] = err
                paths[f"{dt} {list(shape)}->{co}"] = [path, plan]
            shape, e, co = join_shape(b)
            errs["conditioning_join"][(dtype, shape)] = join_vs_plain(
                shape, e, co, "none", dtype, "wgmma" if bf16 else "simple")
        # the 256 px D's six calls: the D step's three streams, the G
        # step's one
        for b in (D_BATCH, BATCH):
            for shape, co, act in conv_shapes_256(b):
                x, w, bias = conv_inputs(shape, co, dtype, device, gen)
                err, path, plan = conv_vs_plain(
                    conv, x, w, bias, act, dtype,
                    f"conv5x5_s2_act {dt} {shape}->{co} {act} (256 px D)")
                errs["conv5x5_s2_act"][(dtype, shape)] = err
                paths[f"{dt} {list(shape)}->{co}"] = [path, plan]
                del x
            torch.cuda.empty_cache()
        odd = [(s, None) for s in ODD_CONV_SHAPES]
        for want, shapes in CONV_PATH_BF16.items():
            odd += [(s, want if bf16 else None) for s in shapes]
        odd += [(s, want if bf16 else None) for s, want in
                zip(NEAR_MISS_CONV_SHAPES, NEAR_MISS_PATHS_BF16)]
        for (shape, co, act), want in odd:
            x, w, bias = conv_inputs(shape, co, dtype, device, gen)
            conv_vs_plain(conv, x, w, bias, act, dtype,
                          f"conv5x5_s2_act {dt} {shape}->{co} {act} (odd)",
                          want)
        for shape, e, co, act in ODD_JOIN_SHAPES + NEAR_MISS_JOIN_SHAPES:
            join_vs_plain(shape, e, co, act, dtype, "simple", " (odd)")
        for shape, e, co, act in WGMMA_JOIN_SHAPES:
            join_vs_plain(shape, e, co, act, dtype,
                          "wgmma" if bf16 else "simple", " (odd)")
    # every plan the wgmma path can be given, at the odd shapes: each tile
    # that divides Co with each split of K; a split's output twice
    dtype = torch.bfloat16
    for shape, co, act in WGMMA_ODD_SHAPES:
        x, w, bias = conv_inputs(shape, co, dtype, device, gen)
        ref = conv.conv5x5_s2_act_plain(x, w, bias, act)
        for tm, tn in conv.CONV_TILES:
            if co % tn:
                continue
            worst, same = 0.0, True
            for split in conv.CONV_SPLITS:
                got = conv._conv_forward(x, w, bias, act, plan=(tm, tn, split))
                again = conv._conv_forward(x, w, bias, act,
                                           plan=(tm, tn, split))
                torch.cuda.synchronize()
                same = same and torch.equal(got, again)
                err = (got.float() - ref.float()).abs()
                bad = err > CONV_TOL[dtype][0] + CONV_TOL[dtype][1] * ref.float().abs()
                check(not bool(bad.any()),
                      f"wgmma plan {(tm, tn, split)} at {shape}->{co}: "
                      f"max|err| {float(err.max()):.3e}")
                worst = max(worst, float(err.max()))
            log(f"  conv5x5_s2_act bfloat16 {shape}->{co} {act} tile {tm}x{tn}, "
                f"splits {conv.CONV_SPLITS}: max|err| {worst:.3e}, two runs "
                f"bit-identical {same}")
            check(same, f"split-K output differs between two runs at {shape}")
    return errs, paths


def grad_compare(fn, plain, args, grad_idx, gen, what):
    """Forward and input gradients of `fn` (the kernel's autograd.Function)
    against torch.autograd through `plain`, for one random cotangent; f32."""
    def run(f):
        xs = [a.detach().clone().requires_grad_(i in grad_idx)
              if isinstance(a, torch.Tensor) else a for i, a in enumerate(args)]
        y = f(*xs)
        return y, xs
    y, xs = run(fn)
    g = torch.randn(y.shape, generator=gen).to(y.device)
    got = torch.autograd.grad(y, [xs[i] for i in grad_idx], g)
    y2, xs2 = run(plain)
    ref = torch.autograd.grad(y2, [xs2[i] for i in grad_idx], g)
    worst = 0.0
    for i, a, r in zip(grad_idx, got, ref):
        scale = float(r.abs().max())
        worst = max(worst, compare(a, r, GRAD_REL * scale, GRAD_REL,
                                   f"{what} d/d arg{i}"))
    return worst


def smooth(act):
    """The activation a main-path backward is checked with.  A backward
    takes act' from the kernel's own output; where that output and the
    plain version's fall on two sides of a relu/lrelu kink (|y| ~ 1e-6, a
    few of a million outputs), act' differs and so does every gradient term
    through that output.  The main-path shapes are checked without the
    kink; the odd shapes, and tanh, with their activation."""
    return "none" if act in ("relu", "lrelu") else act


def phase_backward(device):
    """The backward of deconv5x5_s2, conv5x5_s2_act, conditioning_join, the
    public bn_act and the train-mode batch norm (their autograd.Functions)
    against torch.autograd through the plain version, f32, TF32 off, at the
    training paths' shapes (batch 64; the batch norm at every BN call of
    every path) and odd ones."""
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    gen = torch.Generator().manual_seed(SEED + 3)
    f32 = torch.float32
    errs = {}
    for shape, co, act in ([(s, c, smooth(a)) for s, c, a in DECONV_SHAPES]
                           + ODD_DECONV_SHAPES[:2]):
        x, w, s, t = deconv_inputs(shape, co, f32, device, gen)
        errs[f"deconv5x5_s2 {shape}->{co} {act}"] = grad_compare(
            conv.deconv5x5_s2, conv.deconv5x5_s2_plain, [x, w, s, t, act],
            (0, 1, 2, 3), gen, f"deconv5x5_s2 bwd {shape}->{co} {act}")
    for shape, co, act in ([(s, c, smooth(a)) for s, c, a in conv_shapes(BATCH)]
                           + ODD_CONV_SHAPES[:2]):
        x, w, b = conv_inputs(shape, co, f32, device, gen)
        errs[f"conv5x5_s2_act {shape}->{co} {act}"] = grad_compare(
            conv.conv5x5_s2_act, conv.conv5x5_s2_act_plain, [x, w, b, act],
            (0, 1, 2), gen, f"conv5x5_s2_act bwd {shape}->{co} {act}")
    # conv5x5_s2_dx's Function: its backward (the conv and conv5x5_s2_dw
    # kernels, f32) with its forward, bf16 only on the card, swapped for
    # the plain version
    dx_forward = conv._conv_dx_forward
    conv._conv_dx_forward = lambda gc, w, h, wd: conv.conv5x5_s2_dx_plain(
        gc, w, h, wd)
    try:
        for (b, h, wd, cin), co in (((BATCH, 16, 16, 128), 256),
                                    ((2, 9, 7, 64), 64)):
            gc = torch.randn(b, (h + 1) // 2, (wd + 1) // 2, co,
                             generator=gen).to(device)
            w = (torch.randn(5, 5, cin, co, generator=gen) * 0.05).to(device)
            errs[f"conv5x5_s2_dx {(b, h, wd, cin)}->{co}"] = grad_compare(
                conv._ConvDx.apply, conv.conv5x5_s2_dx_plain, [gc, w, h, wd],
                (0, 1), gen, f"conv5x5_s2_dx bwd {(b, h, wd, cin)}->{co}")
    finally:
        conv._conv_dx_forward = dx_forward
    # deconv5x5_s2_dx's Function alike: its backward the transposed conv
    # and conv5x5_s2_dw (f32), its forward swapped for the plain version
    ddx_forward = conv._deconv_dx_forward
    conv._deconv_dx_forward = conv.deconv5x5_s2_dx_plain
    try:
        for (b, h, wd, cin), co in (((BATCH, 8, 8, 512), 256),
                                    ((2, 5, 7, 64), 3)):
            d = torch.randn(b, 2 * h, 2 * wd, co, generator=gen).to(device)
            w = (torch.randn(5, 5, cin, co, generator=gen) * 0.05).to(device)
            errs[f"deconv5x5_s2_dx {(b, h, wd, cin)}->{co}"] = grad_compare(
                conv._DeconvDx.apply, conv.deconv5x5_s2_dx_plain, [d, w],
                (0, 1), gen, f"deconv5x5_s2_dx bwd {(b, h, wd, cin)}->{co}")
    finally:
        conv._deconv_dx_forward = ddx_forward
    for (shape, e, co), act in ((join_shape(BATCH), "none"),
                                (ODD_JOIN_SHAPES[1][:3], "tanh")):
        args = join_inputs(shape, e, co, f32, device, gen)
        errs[f"conditioning_join {shape} {act}"] = grad_compare(
            fused.conditioning_join, fused.conditioning_join_plain,
            [*args, act], (0, 1, 2, 3, 4), gen,
            f"conditioning_join bwd {shape} e{e}->{co} {act}")
    # the public bn_act (eval mode, the folded stem): its backward at the
    # odd shapes
    for shape, s, act in ODD_BN_CALLS[:2]:
        x, a, b = bn_inputs(shape, f32, device, gen)
        errs[f"bn_act {shape} {act}"] = grad_compare(
            fused.bn_act, fused.bn_act_plain, [x, a, b, act], (0, 1, 2), gen,
            f"bn_act bwd {shape} {act}")
    errs.update(phase_bn_backward(device))
    return errs


def phase_bn_backward(device):
    """The train-mode batch norm (`batch_norm_train`: bn_stats + bn_act,
    bn_bwd_reduce + bn_bwd_apply) against torch.autograd through the plain
    forward (var_mean included), f32, TF32 off, for x, γ and β at every BN
    call of every path (without the kink, `smooth`: the plain forward's
    statistics differ from the kernel's in the last bits, so an output
    within ~1e-7 of 0 may take the other side of it; at 2^23 elements a flip
    is likely) and at the odd calls with their activation.  The kernels'
    act' at the kink is held by phase_bn_kernels, on the same y."""
    from text_to_image_tpu_torch.ops.kernels import fused
    gen = torch.Generator().manual_seed(SEED + 11)
    errs = {}
    for shape, s, act in dict.fromkeys(
            [(c, k, smooth(a)) for c, k, a in BN_CALLS] + ODD_BN_CALLS):
        x, gamma, beta, rm, rv = bn_train_inputs(shape, torch.float32, device,
                                                 gen)

        def kernels(x_, g_, b_):
            return fused.batch_norm_train(x_, g_, b_, rm, rv, s, act)[0]

        def plain(x_, g_, b_):
            a, b = fused.bn_stats_plain(x_, s, g_, b_, rm, rv)[2:4]
            return fused.bn_act_plain(x_, a, b, act)
        errs[f"batch_norm_train {shape} S={s} {act}"] = grad_compare(
            kernels, plain, [x, gamma, beta], (0, 1, 2), gen,
            f"batch_norm_train bwd {shape} S={s} {act}")
        del x
        torch.cuda.empty_cache()
    return errs


def upconv_inputs(shape, co, dtype, device, gen):
    x = torch.relu(torch.randn(shape, generator=gen)).to(dtype)
    w = (torch.randn(3, 3, shape[-1], co, generator=gen) * 0.02).to(dtype)
    s = 1.0 + 0.1 * torch.randn(co, generator=gen)
    t = 0.1 * torch.randn(co, generator=gen)
    return [v.to(device) for v in (x, w, s, t)]


def upconv_bias_plain(x, w, b, act):
    from text_to_image_tpu_torch.ops.kernels import conv
    return conv.upconv3x3_plain(x, w, torch.ones_like(b), b, act)


def phase_upconv_kernels(device):
    """upconv3x3 and upconv3x3_bias against the plain version at the eight
    StackGAN shapes at batch 64 (the main path's call, bias and no
    activation, and the scale/shift epilogue with relu) and at odd shapes,
    bf16 and f32."""
    from text_to_image_tpu_torch.ops.kernels import conv
    gen = torch.Generator().manual_seed(SEED + 5)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for shape, co in UPCONV_SHAPES["stage1"] + UPCONV_SHAPES["stage2"]:
            x, w, s, t = upconv_inputs(shape, co, dtype, device, gen)
            got = conv.upconv3x3_bias(x, w, t, "none")
            torch.cuda.synchronize()
            ref = upconv_bias_plain(x, w, t, "none")
            check(got.shape == ref.shape, f"upconv shape {got.shape}")
            errs[(dtype, shape)] = compare(
                got, ref, *TOL[dtype], f"upconv3x3_bias {dt} {shape}->{co} none")
            del got, ref
            same_wc(conv, w, f"{dt} {shape}->{co}")
            grouped_vs_plain(conv, "upconv", [x, w, s, t, "relu"], dtype,
                             f"upconv3x3 {dt} {shape}->{co} relu")
        for shape, co, act in ODD_UPCONV_SHAPES + WGMMA_UPCONV_ODD_SHAPES:
            x, w, s, t = upconv_inputs(shape, co, dtype, device, gen)
            same_wc(conv, w, f"{dt} {shape}->{co} (odd)")
            grouped_vs_plain(conv, "upconv", [x, w, s, t, act], dtype,
                             f"upconv3x3 {dt} {shape}->{co} {act} (odd)")
            compare(conv.upconv3x3_bias(x, w, t, act),
                    upconv_bias_plain(x, w, t, act), *TOL[dtype],
                    f"upconv3x3_bias {dt} {shape}->{co} {act} (odd)")
    every_grouped_plan(conv, "upconv", WGMMA_UPCONV_ODD_SHAPES, device, gen)
    return {"upconv3x3": errs}


def same_wc(conv, w, what):
    """The combine kernel's weights bit for bit against the torch version."""
    got = conv.combined_weights(w)
    torch.cuda.synchronize()
    check(torch.equal(got, conv.combine_upconv_weights(w)),
          f"combined weights {what}: kernel and torch differ")


def phase_upconv_backward(device):
    """Both upconv backwards (the parity adjoints; tanh's recompute) against
    torch.autograd through the plain version, f32, TF32 off: upconv3x3_bias
    at the eight main-path shapes, both at the odd ones."""
    from text_to_image_tpu_torch.ops.kernels import conv
    gen = torch.Generator().manual_seed(SEED + 6)
    f32 = torch.float32
    errs = {}
    for shape, co in UPCONV_SHAPES["stage1"] + UPCONV_SHAPES["stage2"]:
        x, w, _, t = upconv_inputs(shape, co, f32, device, gen)
        errs[f"upconv3x3_bias {shape}->{co} none"] = grad_compare(
            conv.upconv3x3_bias, upconv_bias_plain, [x, w, t, "none"],
            (0, 1, 2), gen, f"upconv3x3_bias bwd {shape}->{co} none")
        torch.cuda.empty_cache()
    for shape, co, act in ODD_UPCONV_SHAPES:
        x, w, s, t = upconv_inputs(shape, co, f32, device, gen)
        errs[f"upconv3x3 {shape}->{co} {act}"] = grad_compare(
            conv.upconv3x3, conv.upconv3x3_plain, [x, w, s, t, act],
            (0, 1, 2, 3), gen, f"upconv3x3 bwd {shape}->{co} {act}")
        errs[f"upconv3x3_bias {shape}->{co} {act}"] = grad_compare(
            conv.upconv3x3_bias, upconv_bias_plain, [x, w, t, act],
            (0, 1, 2), gen, f"upconv3x3_bias bwd {shape}->{co} {act}")
    return errs


# upconv3x3_dx and upconv3x3_dw against their plain versions on the same
# inputs: within tol·max|ref| + tol·|ref| (bf16: a rounding flip of the
# output after f32 sums in another order, the tensor cores' own among them;
# f32, TF32 off: sums of up to 16·B·H·W products in another order)
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: GRAD_REL}
# the Function whose backward runs each of them (its f32 check vs autograd)
BWD_OF = {"upconv3x3_dx": "upconv3x3", "upconv3x3_dw": "upconv3x3",
          "conv5x5_s2_dw": "conv5x5_s2_act"}


def phase_upconv_bwd_kernels(device):
    """The up-block's two backward kernels, upconv3x3_dx and upconv3x3_dw,
    against their plain versions on the same inputs, bf16 and f32, at the
    eight StackGAN shapes, the six C-PGGAN shapes, the odd shapes (ragged
    channels, every activation's shapes), the wgmma path's odd shapes
    (B = 1, M not a multiple of a tile, non-square maps) and the on-chip
    fold's (FOLD_UPCONV_ODD_SHAPES): each output bit for bit between two
    launches, the path read back from the C entry point and held against
    the Python mirror, logged with its plan; each dw launch's modes read
    back and held against `conv.dw_modes`, every mode reached; dx on
    wgmma at every StackGAN and C-PGGAN shape (128²×64→32 at batch 32 and
    64 too), each dx launch's modes read back and held against
    `conv.dx_modes`, every mode reached (DX_ODD_SHAPES among the shapes)."""
    from text_to_image_tpu_torch.ops.kernels import conv
    gen = torch.Generator().manual_seed(SEED + 17)
    errs = {"upconv3x3_dx": {}, "upconv3x3_dw": {}}
    paths = []
    seen, seen_dx = set(), set()
    main = set(UPCONV_SHAPES["stage1"] + UPCONV_SHAPES["stage2"]
               + PGGAN_UPCONV_SHAPES + DX_CO32_B64)
    shapes = list(dict.fromkeys(
        UPCONV_SHAPES["stage1"] + UPCONV_SHAPES["stage2"]
        + PGGAN_UPCONV_SHAPES + DX_CO32_B64 + FOLD_UPCONV_ODD_SHAPES
        + DX_ODD_SHAPES
        + [(s, c) for s, c, _ in ODD_UPCONV_SHAPES + WGMMA_UPCONV_ODD_SHAPES]))
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        tol = BWD_TOL[dtype]
        for shape, co in shapes:
            b, h, wd, cin = shape
            x, w, _, _ = upconv_inputs(shape, co, dtype, device, gen)
            g = torch.randn(b, 2 * h, 2 * wd, co, generator=gen).to(
                dtype).to(device)
            for name, fn, plain, on_card, mirror in (
                    ("upconv3x3_dx", lambda: conv.upconv3x3_dx(g, w, dtype),
                     lambda: conv.upconv3x3_dx_plain(g, w, dtype),
                     lambda out: conv.dx_path_on_card(g, out),
                     conv.dx_path(h, wd, cin, co, dtype)),
                    ("upconv3x3_dw", lambda: conv.upconv3x3_dw(x, g, dtype),
                     lambda: conv.upconv3x3_dw_plain(x, g, dtype),
                     lambda out: conv.dw_path_on_card(x, g),
                     conv.dw_path(h, wd, cin, co, dtype))):
                got, again = fn(), fn()
                torch.cuda.synchronize()
                path = on_card(got)
                what = f"{name} {dt} {shape}->{co}"
                check(path == mirror, f"{what}: path {path}, the mirror "
                                      f"says {mirror}")
                if name == "upconv3x3_dw":
                    modes = conv.dw_mode_on_card()
                    want = conv.dw_modes(path, conv.dw_plan(
                        b, h, wd, cin, co, dtype), 16, cin, h, wd)
                    check(modes == want, f"{what}: modes {sorted(modes)}, "
                                         f"the mirror says {sorted(want)}")
                    seen |= modes
                else:
                    modes = conv.dx_mode_on_card()
                    want = conv.dx_modes(path, conv.dx_plan(
                        b, h, wd, cin, co) if path == "wgmma" else None, co)
                    check(modes == want, f"{what}: modes {sorted(modes)}, "
                                         f"the mirror says {sorted(want)}")
                    check(path == "wgmma" or dtype != torch.bfloat16
                          or (shape, co) not in main,
                          f"{what}: a main-path call off wgmma ({path})")
                    seen_dx |= modes
                check(torch.equal(got, again),
                      f"{what}: two launches differ")
                ref = plain()
                tag = bwd_path_tag(name, path, shape, co)
                errs[name][(dtype, (shape, co))] = compare(
                    got, ref, tol * float(ref.float().abs().max()), tol,
                    f"{what} [{tag}] (bit-identical twice)")
                paths.append({"kernel": name, "dtype": dt,
                              "shape": [list(shape), co], "path": tag})
                del got, again, ref
            del x, w, g
            torch.cuda.empty_cache()
    # every way a launch can go: dw from the kernel itself, parts summed
    # across a cluster, the workspace, the on-chip fold and its 32-column
    # tile, the per-product blocks, the producer-warp main loop
    check(seen == {"direct", "cluster", "workspace", "fold", "bn32",
                   "producer"}, f"upconv3x3_dw modes reached {sorted(seen)}")
    log(f"  upconv3x3_dw modes reached (read back from C): {sorted(seen)}")
    # every way a dx launch can go: A by TMA, the shared patch, 64-byte K
    # slices, parts summed in a cluster, the gather loop and its workspace
    check(seen_dx == set(conv.DX_MODES),
          f"upconv3x3_dx modes reached {sorted(seen_dx)}")
    log(f"  upconv3x3_dx modes reached (read back from C): {sorted(seen_dx)}")
    return errs, paths


# conv5x5_s2_dw's main-path calls as (x shape, Co, flip): the 64 px and the
# 256 px D's convs at both batches (the D step's 3·64, the G step's 64;
# WGAN-CLS's critic has the 64 px D's shapes), the GAN-CLS generator's
# deconvs (their cotangent [B,2H,2W,Co] as x, their input's Cin as Co,
# written in the deconv's own weight layout as its backward asks)
CONV_DW_MAIN = list(dict.fromkeys(
    [(s, c, False) for b in (D_BATCH, BATCH) for s, c, _ in conv_shapes(b)]
    + [(s, c, False) for b in (D_BATCH, BATCH)
       for s, c, _ in conv_shapes_256(b)]
    + [((b, 2 * h, 2 * w, co), cin, True)
       for (b, h, w, cin), co, _ in DECONV_SHAPES]))
# off the main path: every odd conv and deconv shape of phase 2 (odd maps
# and ragged channels: mma and tile; even maps with a box: wgmma), the
# deconvs' in their layout
CONV_DW_ODD = list(dict.fromkeys(
    [(s, c, False) for s, c, _ in ODD_CONV_SHAPES + WGMMA_ODD_SHAPES
     + NEAR_MISS_CONV_SHAPES + DOWN0_ODD_SHAPES]
    + [((b, 2 * h, 2 * w, co), cin, True) for (b, h, w, cin), co, _ in
       ODD_DECONV_SHAPES + WGMMA_DECONV_ODD_SHAPES]))
# Cin·Co over 1 M, where one part's workspace of every product would be
# over CONV_WS_CAP: GAN-CLS G's first deconv at gf 256 (its dw: d
# [64,8,8,1024] against x's 2048 channels) and Stage-I's first up-block at
# gf 256 (4²×2048→1024).  bf16 sums every part on chip there (no
# workspace, one chunk); the up-block's f32 FMA tile keeps a workspace of
# every part and walks Cin in chunks
CONV_DW_CHUNKED = [((BATCH, 8, 8, 1024), 2048)]
UPCONV_DW_CHUNKED = [((BATCH, 4, 4, 2048), 1024)]


# the 5×5 ops' input gradients at the shapes the backward gives them: the
# conv's dx (conv5x5_s2_dx where bf16 Cin and Co are multiples of 64, else
# deconv5x5_s2 of its cotangent) at every D call, the 64 px and the 256 px
# D's at both batches (WGAN-CLS's critic has the 64 px D's shapes), the odd
# conv shapes (odd maps on the kernel's ring: WGMMA_ODD_SHAPES) and
# CDX_ODD_SHAPES (the patch kernel at B 1, an odd map whose plane tiles
# span images, one pixel)
CDX_ODD_SHAPES = [((1, 16, 128, 64), 64), ((2, 3, 5, 64), 128),
                  ((1, 1, 1, 128), 64)]
CONV_DX_SHAPES = list(dict.fromkeys(
    [(s, c) for b in (D_BATCH, BATCH)
     for s, c, _ in conv_shapes(b) + conv_shapes_256(b)]
    + [(s, c) for s, c, _ in ODD_CONV_SHAPES + WGMMA_ODD_SHAPES]
    + CDX_ODD_SHAPES))
# the deconv's dx (deconv5x5_s2_dx where bf16 Cin is a multiple of 64 and
# Co a multiple of 64 or at most 4, else conv5x5_s2_act of d with the
# flipped weight) at the GAN-CLS generator's calls, the odd deconv shapes
# (the ring at odd maps and Co 192 / 256, the conv route at ragged
# channels) and DDX_ODD_SHAPES: the thin path at the gradient penalty's
# critic first layer (Cin 64), at Cin 192 (three 64-column tiles) and 256
# (two 128-column tiles), an odd map at B 1 on both paths, one pixel
DDX_ODD_SHAPES = [((BATCH, 32, 32, 64), 3), ((2, 5, 7, 192), 4),
                  ((3, 8, 6, 256), 1), ((1, 5, 7, 64), 3),
                  ((1, 5, 3, 128), 64), ((1, 1, 1, 64), 64)]
DECONV_DX_SHAPES = [(s, c) for s, c, _ in DECONV_SHAPES + ODD_DECONV_SHAPES
                    + WGMMA_DECONV_ODD_SHAPES] + DDX_ODD_SHAPES


def conv_dx_vs_plain(conv, shape, co, dtype, device, gen):
    """The conv's dx for x `shape` and Co through `conv.conv_dx`, its route
    read back from C (`conv_dx_path_on_card`) and held against the mirror
    and the expected one.  conv5x5_s2_dx (bf16, Cin and Co multiples of
    64): against its plain version, its plan's modes read back from C
    against `conv_dx_modes`, a second launch bit for bit.  The deconv
    route: against the plain deconv of the flipped weight, cropped alike,
    its path read back from C.  Returns (max |err|, route)."""
    b, h, wd, cin = shape
    ho, wo = (h + 1) // 2, (wd + 1) // 2
    gc = torch.randn(b, ho, wo, co, generator=gen).to(dtype).to(device)
    w = (torch.randn(5, 5, cin, co, generator=gen) * 0.02).to(dtype).to(device)
    got = conv.conv_dx(gc, w, h, wd)
    again = conv.conv_dx(gc, w, h, wd)
    torch.cuda.synchronize()
    what = f"conv dx {str(dtype)[6:]} {shape}->{co}"
    route = conv.conv_dx_path_on_card(gc, w, got)
    mirror = conv.conv_dx_path(cin, co, dtype)
    want = ("wgmma" if dtype == torch.bfloat16 and cin % 64 == 0
            and co % 64 == 0 else "deconv")
    check(route == mirror == want, f"{what}: route {route}, mirror {mirror}, "
                                   f"expected {want}")
    check(torch.equal(got, again), f"{what}: two launches differ")
    if route == "wgmma":
        plan = conv.conv_dx_plan(b, h, wd, cin, co)
        modes = conv.conv_dx_mode_on_card()
        check(modes == conv.conv_dx_modes(plan),
              f"{what}: modes {sorted(modes)}, the mirror says "
              f"{sorted(conv.conv_dx_modes(plan))}")
        ref = conv.conv5x5_s2_dx_plain(gc, w, h, wd)
        tag = (f"conv5x5_s2_dx {plan.kernel} {plan.tile_m}x{plan.tile_n} "
               f"parts {plan.parts}")
    else:
        wdx = conv.deconv_dx_weight(w)
        one = torch.ones(cin, device=device)
        zero = torch.zeros(cin, device=device)
        full = conv.deconv5x5_s2(gc, wdx, one, zero)
        path = conv.deconv_path_on_card(gc, wdx, full)
        dwant = expected_deconv_path(co, cin, dtype)
        check(path == conv.deconv_path(co, cin, dtype) == dwant,
              f"{what}: deconv path {path}, expected {dwant}")
        ot, ol = conv.same_pads(h)[1] - 1, conv.same_pads(wd)[1] - 1
        ref = conv.deconv5x5_s2_plain(gc, wdx, one, zero)[:, ot:ot + h,
                                                          ol:ol + wd]
        plan = (conv.deconv_plan(b * ho * wo, cin, co) if path == "wgmma"
                else None)
        tag = f"deconv5x5_s2 {grouped_tag(conv, path, plan, ho, wo)}"
    check(got.shape == (b, h, wd, cin), f"{what}: shape {tuple(got.shape)}")
    return compare(got, ref, *TOL[dtype], f"{what} [{tag}] (bit-identical "
                                          f"twice)"), route


def every_conv_dx_plan(conv, shapes, device, gen):
    """conv5x5_s2_dx under every plan `conv_dx_candidates` gives at
    `shapes` (bf16): within tolerance of the plain version, bit for bit
    between two launches, the modes read back from C as the mirror says."""
    dtype = torch.bfloat16
    for (b, h, wd, cin), co in shapes:
        gc = torch.randn(b, (h + 1) // 2, (wd + 1) // 2, co,
                         generator=gen).to(dtype).to(device)
        w = (torch.randn(5, 5, cin, co, generator=gen) * 0.02).to(
            dtype).to(device)
        ref = conv.conv5x5_s2_dx_plain(gc, w, h, wd).float()
        plans = conv.conv_dx_candidates(b, h, wd, cin, co)
        worst, same = 0.0, True
        for plan in plans:
            got = conv.conv5x5_s2_dx(gc, w, h, wd, plan=plan)
            modes = conv.conv_dx_mode_on_card()
            again = conv.conv5x5_s2_dx(gc, w, h, wd, plan=plan)
            torch.cuda.synchronize()
            same = same and torch.equal(got, again)
            check(modes == conv.conv_dx_modes(plan),
                  f"conv5x5_s2_dx plan {plan} at {(b, h, wd, cin)}->{co}: "
                  f"modes {sorted(modes)}")
            err = (got.float() - ref).abs()
            bad = err > TOL[dtype][0] + TOL[dtype][1] * ref.abs()
            check(not bool(bad.any()), f"conv5x5_s2_dx plan {plan} at "
                                       f"{(b, h, wd, cin)}->{co}: max|err| "
                                       f"{float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
        log(f"  conv5x5_s2_dx bfloat16 {(b, h, wd, cin)}->{co}: "
            f"{len(plans)} plans ({sorted({p.kernel for p in plans})}): "
            f"max|err| {worst:.3e}, two runs bit-identical {same}")
        check(same, f"conv5x5_s2_dx: output differs between two runs at "
                    f"{(b, h, wd, cin)}->{co}")
        del gc, w, ref
        torch.cuda.empty_cache()


def conv_dx_function_vs_autograd(conv, device, gen):
    """conv5x5_s2_dx's autograd.Function in bf16 on the card (its forward
    the kernel, its backward the conv and conv5x5_s2_dw kernels), first and
    second order, against autograd through the plain version in f32 on the
    same bf16 values: within BWD_TOL[bf16] of each gradient's largest
    element.  Returns the worst relative error."""
    worst = 0.0
    for (b, h, wd, cin), co in (((2, 8, 8, 64), 128), ((3, 9, 7, 128), 64)):
        gc0 = torch.randn(b, (h + 1) // 2, (wd + 1) // 2, co,
                          generator=gen).to(torch.bfloat16).to(device)
        w0 = (torch.randn(5, 5, cin, co, generator=gen) * 0.05).to(
            torch.bfloat16).to(device)
        c = torch.randn(b, h, wd, cin, generator=gen).to(device)

        def grads(fn, dt):
            gc = gc0.to(dt).requires_grad_(True)
            w = w0.to(dt).requires_grad_(True)
            first = torch.autograd.grad(fn(gc, w, h, wd), [gc, w], c.to(dt),
                                        create_graph=True)
            second = torch.autograd.grad(
                sum((g.float()**2).sum() for g in first), [gc, w])
            return [v.float() for v in (*first, *second)]
        got = grads(conv.conv5x5_s2_dx, torch.bfloat16)
        want = grads(conv.conv5x5_s2_dx_plain, torch.float32)
        for name, u, v in zip(("d/dgc", "d/dw", "d2/dgc", "d2/dw"), got, want):
            tol = BWD_TOL[torch.bfloat16] * float(v.abs().max())
            err = compare(u, v, tol, 0.0, f"conv5x5_s2_dx Function {name} "
                                          f"{(b, h, wd, cin)}->{co} (bf16)")
            worst = max(worst, err / float(v.abs().max()))
    return worst


def expected_deconv_dx_path(cin, co, dtype):
    """The route of the deconv's dx the port is meant to take for a
    contiguous tensor."""
    if dtype != torch.bfloat16 or cin % 64:
        return "conv"
    if co % 64 == 0:
        return "ring"
    return "thin" if co <= 4 else "conv"


def deconv_dx_vs_plain(conv, shape, co, dtype, device, gen):
    """The deconv's dx for x `shape` and Co through `conv.deconv_dx` (the
    route `_Deconv.backward` takes), its path read back from C
    (`deconv_dx_path_on_card`) and held against the mirror and the expected
    one.  deconv5x5_s2_dx (ring, thin): against its plain version, a
    second launch bit for bit.  The conv route: conv5x5_s2_act of d with the
    flipped weight and a zero bias against its plain version, its path read
    back.  Returns (max |err|, path)."""
    b, h, wd, cin = shape
    d = torch.randn(b, 2 * h, 2 * wd, co, generator=gen).to(dtype).to(device)
    w = (torch.randn(5, 5, cin, co, generator=gen) * 0.02).to(dtype).to(device)
    what = f"deconv dx {str(dtype)[6:]} {shape}->{co}"
    path = conv.deconv_dx_path_on_card(
        d, w, torch.empty(b, h, wd, cin, dtype=dtype, device=device))
    mirror = conv.deconv_dx_path(cin, co, dtype)
    want = expected_deconv_dx_path(cin, co, dtype)
    check(path == mirror == want, f"{what}: path {path}, mirror {mirror}, "
                                  f"expected {want}")
    if path == "conv":
        return conv_vs_plain(
            conv, d, conv.deconv_dx_weight(w), torch.zeros(cin, device=device),
            "none", dtype, f"{what} (conv5x5_s2_act)")[0], path
    got = conv.deconv_dx(d, w)
    again = conv.deconv_dx(d, w)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{what}: two launches differ")
    check(got.shape == (b, h, wd, cin), f"{what}: shape {tuple(got.shape)}")
    tag = conv.deconv_dx_route(b, h, wd, cin, co, dtype)
    return compare(got, conv.deconv5x5_s2_dx_plain(d, w), *TOL[dtype],
                   f"{what} [{tag}] (bit-identical twice)"), path


def every_deconv_dx_plan(conv, shapes, device, gen):
    """deconv5x5_s2_dx under every plan `deconv_dx_candidates` gives at
    `shapes` (bf16): within tolerance of the plain version, bit for bit
    between two launches."""
    dtype = torch.bfloat16
    for (b, h, wd, cin), co in shapes:
        d = torch.randn(b, 2 * h, 2 * wd, co, generator=gen).to(dtype).to(
            device)
        w = (torch.randn(5, 5, cin, co, generator=gen) * 0.02).to(
            dtype).to(device)
        ref = conv.deconv5x5_s2_dx_plain(d, w).float()
        plans = conv.deconv_dx_candidates(b, h, wd, cin, co)
        worst, same = 0.0, True
        for plan in plans:
            got = conv.deconv5x5_s2_dx(d, w, plan=plan)
            again = conv.deconv5x5_s2_dx(d, w, plan=plan)
            torch.cuda.synchronize()
            same = same and torch.equal(got, again)
            err = (got.float() - ref).abs()
            bad = err > TOL[dtype][0] + TOL[dtype][1] * ref.abs()
            check(not bool(bad.any()), f"deconv5x5_s2_dx plan {plan} at "
                                       f"{(b, h, wd, cin)}->{co}: max|err| "
                                       f"{float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
        log(f"  deconv5x5_s2_dx bfloat16 {(b, h, wd, cin)}->{co}: "
            f"{len(plans)} plans ({sorted({p.kernel for p in plans})}): "
            f"max|err| {worst:.3e}, two runs bit-identical {same}")
        check(same, f"deconv5x5_s2_dx: output differs between two runs at "
                    f"{(b, h, wd, cin)}->{co}")
        del d, w, ref
        torch.cuda.empty_cache()


def deconv_dx_function_vs_autograd(conv, device, gen):
    """deconv5x5_s2_dx's autograd.Function in bf16 on the card (its forward
    the kernel, its backward the transposed conv and conv5x5_s2_dw
    kernels), first and second order, on the ring and the thin path,
    against autograd through the plain version in f32 on the same bf16
    values: within BWD_TOL[bf16] of each gradient's largest element.
    Returns the worst relative error."""
    worst = 0.0
    for (b, h, wd, cin), co in (((2, 4, 4, 128), 64), ((3, 5, 7, 64), 3)):
        d0 = torch.randn(b, 2 * h, 2 * wd, co, generator=gen).to(
            torch.bfloat16).to(device)
        w0 = (torch.randn(5, 5, cin, co, generator=gen) * 0.05).to(
            torch.bfloat16).to(device)
        c = torch.randn(b, h, wd, cin, generator=gen).to(device)

        def grads(fn, dt):
            d = d0.to(dt).requires_grad_(True)
            w = w0.to(dt).requires_grad_(True)
            first = torch.autograd.grad(fn(d, w), [d, w], c.to(dt),
                                        create_graph=True)
            second = torch.autograd.grad(
                sum((g.float()**2).sum() for g in first), [d, w])
            return [v.float() for v in (*first, *second)]
        got = grads(conv.deconv5x5_s2_dx, torch.bfloat16)
        want = grads(conv.deconv5x5_s2_dx_plain, torch.float32)
        for name, u, v in zip(("d/dd", "d/dw", "d2/dd", "d2/dw"), got, want):
            tol = BWD_TOL[torch.bfloat16] * float(v.abs().max())
            err = compare(u, v, tol, 0.0, f"deconv5x5_s2_dx Function {name} "
                                          f"{(b, h, wd, cin)}->{co} (bf16)")
            worst = max(worst, err / float(v.abs().max()))
    return worst


# the 3×3 stride-1 conv family's wrappers (their launch counters), in the
# order of the kernels line
K3_OPS = ("conv3x3_act", "conv3x3_dx", "conv3x3_dw", "act_grad")


def phase_conv3x3_kernels(device):
    """The 3×3 stride-1 SAME conv's kernels (conv3x3_act with lrelu,
    act_grad of its output, conv3x3_dx, conv3x3_dw) against their f32
    plain versions on the same bf16 values at every C-PGGAN 256 px shape
    (critic at 96 and 32 rows, generator at 32) and StackGAN Stage-II's
    residual and join convs, each output bit for bit between two launches,
    the second order through _Conv3x3Dw where the map is small enough to
    take it twice; act_grad's own checks (every act, the adjoint's add, a
    tensor it does not take raising, the third order); then _Conv3x3's
    double backward (the gradient penalty's) against autograd through the
    plain version.  The checks are tests/test_torch_conv3x3.py's chip
    tests (within 1e-2 of the forward's elements, of each gradient's
    largest element; act_grad's gc bit for bit, its db within 1e-4).
    Returns (each shape's worst errors; {op: {(dtype, shape): error}}: the
    forward's largest absolute error, the others' relative to their
    largest element; the second order's worst relative error)."""
    # by its path: an installed package named `tests` may shadow the
    # repository's test directory (it has no __init__.py)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_torch_conv3x3",
        os.path.join(ROOT, "tests", "test_torch_conv3x3.py"))
    t3 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t3)
    gen = torch.Generator().manual_seed(SEED + 23)
    out, errs = {}, {k: {} for k in K3_OPS}
    for shape in t3.MAIN_SHAPES:
        try:
            r = out[str(list(shape))] = t3.check_shape(
                shape, device, gen, second=shape[0] * shape[1] ** 2 <= 2**21)
        except AssertionError as e:
            check(False, f"conv3x3 {shape}: {e}")
            continue
        log(f"  conv3x3 {list(shape)}: {r}")
        for op, k in zip(K3_OPS, ("fwd", "dx", "dw", "act_grad_db")):
            errs[op][(torch.bfloat16, tuple(shape))] = r[k]
    second = None
    for what, fn in (("act_grad", t3.test_act_grad_kernel_matches_the_plain_version),
                     ("Function second order", t3.check_second_order)):
        try:
            got = fn(device)
        except AssertionError as e:
            check(False, f"conv3x3 {what}: {e}")
            continue
        if what.startswith("Function"):
            second = got
    log(f"  conv3x3 Function second order: worst {second}")
    torch.cuda.empty_cache()
    return out, errs, second


def phase_conv_bwd_kernels(device):
    """conv5x5_s2_dw against its plain version on the same inputs, bf16
    and f32, at every main-path call (CONV_DW_MAIN) and the odd shapes
    (CONV_DW_ODD; the deconvs' in their own weight layout), each output
    bit for bit between two launches, the path and the launch's modes read
    back from C and held against the Python mirrors; every path and mode
    reached.  Then Cin·Co over 1 M: conv5x5_s2_dw and upconv3x3_dw (bf16,
    no workspace) and the up-block's f32 FMA tile (its workspace in
    chunks) against their plain versions, bit for bit twice, and that
    up-block's forward and backward through its autograd.Function (no
    raise, finite, dw as the kernel gives it).  Last
    the input gradients, bf16 and f32: the conv's dx (conv5x5_s2_dx or
    deconv5x5_s2) at CONV_DX_SHAPES and the deconv's dx (deconv5x5_s2_dx,
    or conv5x5_s2_act with bias 0 for f32 and ragged channels) at
    DECONV_DX_SHAPES against the plain versions, each path read back from
    C, both dx kernels under every plan they take and through their
    Functions at first and second order; both dx and every split-K output
    bit for bit twice."""
    from text_to_image_tpu_torch.ops.kernels import conv
    gen = torch.Generator().manual_seed(SEED + 19)
    errs = {"conv5x5_s2_dw": {}, "upconv3x3_dw": {}, "conv5x5_s2_dx": {},
            "deconv5x5_s2 (conv dx)": {}, "deconv5x5_s2_dx": {},
            "conv5x5_s2_act (deconv dx)": {}}
    paths = []
    seen = set()
    seen_modes = set()

    def held(name, fn, plain, path, mirror, tag, dtype, key):
        got, again = fn(), fn()
        torch.cuda.synchronize()
        what = f"{name} {str(dtype)[6:]} {key}"
        check(path == mirror, f"{what}: path {path}, the mirror says "
                              f"{mirror}")
        check(torch.equal(got, again), f"{what}: two launches differ")
        check(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
        ref = plain()
        tol = BWD_TOL[dtype]
        errs[name][(dtype, key)] = compare(
            got, ref, tol * float(ref.float().abs().max()), tol,
            f"{what} [{tag}] (bit-identical twice)")
        paths.append({"kernel": name, "dtype": str(dtype)[6:],
                      "shape": [list(key[0]), key[1]], "path": tag})
        return got

    for dtype in (torch.bfloat16, torch.float32):
        for shape, co, flip in CONV_DW_MAIN + CONV_DW_ODD + (
                [(s, c, False) for s, c in CONV_DW_CHUNKED]
                if dtype == torch.bfloat16 else []):
            b, h, wd, cin = shape
            x = torch.randn(shape, generator=gen).to(dtype).to(device)
            g = torch.randn(b, (h + 1) // 2, (wd + 1) // 2, co,
                            generator=gen).to(dtype).to(device)
            path = conv.conv_dw_path_on_card(x, g)
            seen.add((dtype, path))
            dw = held("conv5x5_s2_dw",
                      lambda: conv.conv5x5_s2_dw(x, g, dtype, flip),
                      lambda: conv.conv5x5_s2_dw_plain(x, g, dtype, flip),
                      path, conv.conv_dw_path(h, wd, cin, co, dtype),
                      conv_dw_tag(conv, x, g)
                      + (" deconv layout" if flip else ""), dtype,
                      (shape, co))
            modes = conv.conv_dw_mode_on_card()
            want = conv.dw_modes(path, conv.conv_dw_plan(
                b, h, wd, cin, co, dtype), 25, cin, *g.shape[1:3])
            check(modes == want, f"conv5x5_s2_dw {shape}->{co}: modes "
                                 f"{sorted(modes)}, the mirror says "
                                 f"{sorted(want)}")
            check(dw.shape == ((5, 5, co, cin) if flip else (5, 5, cin, co)),
                  f"conv5x5_s2_dw {shape}->{co}: shape {tuple(dw.shape)}")
            seen_modes |= modes
            del x, g, dw
            torch.cuda.empty_cache()
    check(seen >= {(torch.bfloat16, p) for p in conv.DW_PATHS}
          | {(torch.float32, "tile")}, f"conv5x5_s2_dw paths reached {seen}")
    # dw from the kernel itself, parts summed across a cluster, the
    # workspace past a cluster, the RGB layers' staged rows, the
    # producer-warp main loop
    check(seen_modes == {"direct", "cluster", "workspace", "staged",
                         "producer"},
          f"conv5x5_s2_dw modes reached {sorted(seen_modes)}")
    log(f"  conv5x5_s2_dw modes reached (read back from C): "
        f"{sorted(seen_modes)}")
    # its own backward (a gradient of dw: the conv's dx and the conv)
    # against autograd through the plain version, f32
    for shape, co in (((2, 8, 6, 16), 8), ((2, 9, 7, 12), 20)):
        b, h, wd, _ = shape
        x = torch.randn(shape, generator=gen).to(device)
        g = torch.randn(b, (h + 1) // 2, (wd + 1) // 2, co,
                        generator=gen).to(device)
        grad_compare(conv.conv5x5_s2_dw, conv.conv5x5_s2_dw_plain,
                     [x, g, torch.float32], (0, 1), gen,
                     f"conv5x5_s2_dw bwd {shape}->{co}")
    bf = torch.bfloat16
    for shape, co in CONV_DW_CHUNKED:
        plan = conv.conv_dw_plan(*shape, co, bf)
        check(plan.chunk == shape[-1] and not conv.plan_ws_elems(plan, co, 25),
              f"conv5x5_s2_dw {shape}->{co}: a workspace {plan}")
    for shape, co in UPCONV_DW_CHUNKED:
        b, h, wd, cin = shape
        plan = conv.dw_plan(b, h, wd, cin, co, bf)
        check(plan.chunk == cin and not conv.plan_ws_elems(plan, co, 16),
              f"upconv3x3_dw {shape}->{co}: a workspace {plan}")
        f32 = conv.dw_plan(b, h, wd, cin, co, torch.float32)
        check(f32.chunk < cin, f"upconv3x3_dw f32 {shape}->{co}: one chunk "
                               f"{f32}")
        x, w, _, t = upconv_inputs(shape, co, bf, device, gen)
        g = torch.randn(b, 2 * h, 2 * wd, co, generator=gen).to(bf).to(device)
        path = conv.dw_path_on_card(x, g)
        dw = held("upconv3x3_dw", lambda: conv.upconv3x3_dw(x, g, bf),
                  lambda: conv.upconv3x3_dw_plain(x, g, bf), path,
                  conv.dw_path(h, wd, cin, co, bf),
                  bwd_path_tag("upconv3x3_dw", path, shape, co), bf,
                  (shape, co))
        x32, g32 = x.float(), g.float()
        held("upconv3x3_dw", lambda: conv.upconv3x3_dw(x32, g32,
                                                       torch.float32),
             lambda: conv.upconv3x3_dw_plain(x32, g32, torch.float32),
             conv.dw_path_on_card(x32, g32),
             conv.dw_path(h, wd, cin, co, torch.float32),
             f"tile chunk {f32.chunk}", torch.float32, (shape, co))
        del x32, g32
        xs = [v.detach().requires_grad_(True) for v in (x, w, t)]
        y = conv.upconv3x3_bias(*xs, "none")
        grads = torch.autograd.grad(y, xs, g)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(v.float()).all()) for v in grads),
              f"upconv3x3_bias {shape}->{co}: backward not finite")
        check(torch.equal(grads[1], dw), f"upconv3x3_bias {shape}->{co}: "
                                         f"its dw is not the kernel's")
        log(f"  upconv3x3_bias {shape}->{co} forward + backward through "
            f"its Function (Cin·Co {cin * co}): finite, dw the kernel's")
        del x, w, t, g, xs, y, grads, dw
        torch.cuda.empty_cache()
    routes = set()
    for dtype in (torch.bfloat16, torch.float32):
        for shape, co in CONV_DX_SHAPES:
            err, route = conv_dx_vs_plain(conv, shape, co, dtype, device, gen)
            routes.add((dtype, route))
            errs["conv5x5_s2_dx" if route == "wgmma"
                 else "deconv5x5_s2 (conv dx)"][(dtype, (shape, co))] = err
            torch.cuda.empty_cache()
    check(routes == {(torch.bfloat16, "wgmma"), (torch.bfloat16, "deconv"),
                     (torch.float32, "deconv")}, f"conv dx routes {routes}")
    every_conv_dx_plan(conv, [(s, c) for s, c in CONV_DX_SHAPES
                              if conv.conv_dx_path(s[-1], c, torch.bfloat16)
                              == "wgmma"], device, gen)
    paths.append({"kernel": "conv5x5_s2_dx",
                  "function_first_second_order_rel_err_bf16":
                      conv_dx_function_vs_autograd(conv, device, gen)})
    ddx_paths = set()
    for dtype in (torch.bfloat16, torch.float32):
        for shape, co in DECONV_DX_SHAPES:
            err, path = deconv_dx_vs_plain(conv, shape, co, dtype, device,
                                           gen)
            ddx_paths.add((dtype, path))
            errs["conv5x5_s2_act (deconv dx)" if path == "conv"
                 else "deconv5x5_s2_dx"][(dtype, (shape, co))] = err
            torch.cuda.empty_cache()
    check(ddx_paths == {(torch.bfloat16, "ring"), (torch.bfloat16, "thin"),
                        (torch.bfloat16, "conv"), (torch.float32, "conv")},
          f"deconv dx paths {ddx_paths}")
    every_deconv_dx_plan(conv, [(s, c) for s, c in DECONV_DX_SHAPES
                                if conv.deconv_dx_path(s[-1], c,
                                                       torch.bfloat16)
                                != "conv"], device, gen)
    paths.append({"kernel": "deconv5x5_s2_dx",
                  "function_first_second_order_rel_err_bf16":
                      deconv_dx_function_vs_autograd(conv, device, gen)})
    return errs, paths


def phase_stackgan_sampling(device, model, sample_dir, runs):
    """``python -m text_to_image_tpu_torch.main --cfg
    configs/<model>_flowers.yml --set data.dataset_name=synthetic
    stage1_checkpoint=`` on the card (with an empty checkpoint directory
    under `runs`, so the generator comes from the seed): the three grids at
    full width, batch 64, bf16, with the launch counts; then the generator
    (for Stage-II with its frozen Stage-I) against the same code on the
    CPU."""
    from text_to_image_tpu_torch import main as port_main
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.eval import sampler
    from text_to_image_tpu_torch.models.registry import get_model, tree_to
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.train.steps import stage1_aux
    from text_to_image_tpu_torch.utils import prng

    counters = all_counters()
    for k in counters:
        k.launches = 0
    out = port_main.main(["--cfg", config_path(model), "--device", str(device),
                          "--set", "data.dataset_name=synthetic",
                          "stage1_checkpoint=", f"sample_dir={sample_dir}",
                          f"checkpoint_dir={os.path.join(runs, 'none')}"])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    log(f"  {model} sampling-path launches (3 grids): {launches}")
    want = {k.__name__: 0 for k in counters}
    want.update({k: 3 * v for k, v in STACKGAN_FORWARD_LAUNCHES[model].items()})
    check(launches == want, f"unexpected launch counts {launches}")
    for name in ("eval_grid", "z_interp", "t_interp"):   # no checkpoint
        check(png_size(os.path.join(out, name + "_init.png"))[0] > 0,
              f"{name} not written")

    # the same generator through the sampler, on the card and on the CPU
    cfg = train_config(model)
    res = cfg.data.image_size
    check((cfg.gan.gf_dim, cfg.gan.ca_dim, cfg.dtype, res) ==
          (128, 128, "bfloat16", 64 if model == "stackgan_stage1" else 256),
          f"not the full-width config: {cfg}")
    bundle = get_model(cfg)
    params32, state = bundle.init(cfg.seed, device)[:2]
    aux32 = stage1_aux(cfg, cfg.seed, device) if bundle.needs_stage1 else {}
    n = 16 if bundle.needs_stage1 else BATCH     # the CPU side: 256 px, f32
    emb = get_dataset(cfg).test_embeddings(n)
    g = prng.generator(prng.fold_in(cfg.seed, 1))
    z = torch.randn(n, cfg.gan.z_dim, generator=g)
    eps = torch.randn(*bundle.eps_shape(n), generator=g)
    g_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        pol = L.Policy(compute_dtype=dtype)
        dcfg = train_config(model, dtype=dt)
        imgs = []
        for dev in (device, "cpu"):
            aux = {k: L.cast_weights(tree_to(v, dev), pol)
                   for k, v in aux32.items()}
            ts = sampler.GeneratorState(
                L.cast_weights(tree_to(params32, dev), pol),
                tree_to(state, dev), aux)
            gen = sampler.make_generator_fn(dcfg, device=dev)
            imgs.append(torch.as_tensor(
                sampler.sample_grid(gen, ts, dcfg, emb, z=z, eps=eps)))
        dev_img, cpu_img = imgs
        check(tuple(dev_img.shape) == (n, res, res, 3), f"{dev_img.shape}")
        check(bool(torch.isfinite(dev_img).all()), f"{model}: non-finite")
        check(float(dev_img.abs().max()) <= 1.0, f"{model}: outside [-1, 1]")
        err = (dev_img - cpu_img).abs()
        worst, mean = float(err.max()), float(err.mean())
        # Stage-II in bf16 rounds at each of 25 layers: the mean is held
        by_mean = bundle.needs_stage1 and dtype == torch.bfloat16
        held = mean if by_mean else worst
        tol = S2_TOL[dtype] if bundle.needs_stage1 else G_TOL[dtype]
        log(f"  {model} generator {dt} vs CPU plain path at batch {n}: "
            f"max|err| {worst:.3e}, mean {mean:.3e} "
            f"({'mean' if by_mean else 'max'} held to {tol:g}), image std "
            f"{float(dev_img.std()):.4f}")
        check(held <= tol, f"{model} generator {dt}: {held:.3e} > {tol:g}")
        g_err[f"{model} {dt}"] = {"max": worst, "mean": mean}
    return launches, g_err


def phase_upconv_timing(device, flush):
    """upconv3x3_bias at the eight StackGAN shapes (bf16, batch 64): kernel,
    plain version, one library composition (F.interpolate + cuDNN conv2d
    with the bias; the 4× upsampled map goes through device memory), the
    bound (bytes: x, w, the bias and y once each), and the backward."""
    import torch.nn.functional as F

    from text_to_image_tpu_torch.ops.kernels import conv
    gen = torch.Generator().manual_seed(SEED + 7)
    dtype = torch.bfloat16
    rows = []
    for stage, shapes in UPCONV_SHAPES.items():
        for shape, co in shapes:
            x, w, _, t = upconv_inputs(shape, co, dtype, device, gen)
            y = conv.upconv3x3_bias(x, w, t, "none")
            b, h, wd, cin = shape
            x_cl = x.permute(0, 3, 1, 2)              # channels_last strides
            w_t = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            t16 = t.to(dtype)

            def lib():
                return F.conv2d(F.interpolate(x_cl, scale_factor=2,
                                              mode="nearest"), w_t, t16,
                                padding=1)
            lib_err = float((lib().permute(0, 2, 3, 1).float()
                             - upconv_bias_plain(x, w, t, "none").float()
                             ).abs().max())
            flops = 2 * b * up_taps(h) * up_taps(wd) * cin * co
            nb = nbytes(x, w, t, y)
            bms, by = bound(nb, flops, dtype)
            path = conv.upconv_path(wd, cin, co, dtype)
            plan = (conv.upconv_plan(b * h * wd, co, cin) if path == "wgmma"
                    else None)
            tag = grouped_tag(conv, path, plan, h, wd)
            r = {"shape": [list(shape), co, "none"], "stage": stage,
                 "path": path, "plan": list(plan) if plan else None,
                 "tag": tag,
                 "ms": time_ms(lambda: conv.upconv3x3_bias(x, w, t, "none"),
                               flush),
                 "plain_ms": time_ms(lambda: upconv_bias_plain(x, w, t, "none"),
                                     flush, 5),
                 "library_ms": time_ms(lib, flush),
                 "bound_ms": bms, "bound_by": by,
                 "bwd_ms": bwd_ms(conv.upconv3x3_bias, [x, w, t, "none"],
                                  (0, 1, 2), flush, gen),
                 "library_max_abs_err_vs_plain": lib_err}
            r["tflops"] = flops / r["ms"] / 1e9
            r["gbytes_per_s"] = nb / r["ms"] / 1e6
            rows.append(r)
            log(f"  upconv3x3_bias {shape}->{co} [{tag}]: {r['ms']:.4f} ms "
                f"(bound {bms:.4f} by {by}, {r['tflops']:.1f} TFLOP/s, "
                f"{r['gbytes_per_s']:.0f} GB/s), plain {r['plain_ms']:.4f}, "
                f"interpolate+cuDNN {r['library_ms']:.4f} "
                f"({r['ms'] / r['library_ms']:.2f}x), backward "
                f"{r['bwd_ms']:.4f} ms")
            del x, w, y
            torch.cuda.empty_cache()
    return rows


def conv_plan_tag(conv, shape, co, dtype):
    """(path, plan, text) of a conv5x5_s2_act call: the code path and, on
    the wgmma path, the tile and the split of K."""
    b, h, wd, cin = shape
    path = conv.conv_path(cin, co, dtype)
    plan = (conv.conv_plan(b * ((h + 1) // 2) * ((wd + 1) // 2), co, 25 * cin)
            if path == "wgmma" else None)
    text = f"{path} {plan[0]}x{plan[1]} split {plan[2]}" if plan else path
    return path, plan, text


def phase_conv_256_timing(device, flush):
    """conv5x5_s2_act at the 256 px D's six shapes over the D step's three
    streams and the G step's one (bf16, batch 3·64 and 64): kernel, cuDNN's
    conv on the pre-padded input, the bound, and the path, tile and split."""
    import torch.nn.functional as F

    from text_to_image_tpu_torch.ops.kernels import conv
    gen = torch.Generator().manual_seed(SEED + 9)
    dtype = torch.bfloat16
    rows = []
    for shape, co, act in conv_shapes_256(D_BATCH) + conv_shapes_256(BATCH):
        x, w, bias = conv_inputs(shape, co, dtype, device, gen)
        y = conv.conv5x5_s2_act(x, w, bias, act)
        b, h, wd, cin = shape
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2)).contiguous(
            memory_format=torch.channels_last)
        w_t = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b16 = bias.to(dtype)

        def lib():
            out = F.conv2d(xp, w_t, b16, stride=2)
            return F.leaky_relu(out, 0.2) if act == "lrelu" else out
        flops = s2_ops(b, h, wd, cin, co)
        nb = nbytes(x, w, bias, y)
        bms, by = bound(nb, flops, dtype)
        path, plan, tag = conv_plan_tag(conv, shape, co, dtype)
        r = {"shape": [list(shape), co, act], "batch": b, "path": path,
             "plan": plan,
             "ms": time_ms(lambda: conv.conv5x5_s2_act(x, w, bias, act), flush,
                           iters=10),
             "library_ms": time_ms(lib, flush, iters=10),
             "bound_ms": bms, "bound_by": by}
        r["tflops"] = flops / r["ms"] / 1e9
        r["gbytes_per_s"] = nb / r["ms"] / 1e6
        rows.append(r)
        log(f"  conv5x5_s2_act {shape}->{co} {act} [{tag}]: {r['ms']:.4f} ms "
            f"(bound {bms:.4f} by {by}, {r['tflops']:.1f} TFLOP/s, "
            f"{r['gbytes_per_s']:.0f} GB/s), cuDNN {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x)")
        # its dx (the gradient into x: every layer's in the G step, all
        # but the RGB layer's in the D step) beside cuDNN's conv2d_input
        if cin > 3 or b == BATCH:
            gc = torch.randn(y.shape, generator=gen).to(dtype).to(device)
            dx = conv.conv_dx(gc, w, h, wd)
            g_cl = gc.permute(0, 3, 1, 2)
            padded = (b, cin, h + 3, wd + 3)
            nb = nbytes(gc, w, dx)
            bms, by = bound(nb, flops, dtype)
            d = {"shape": [list(shape), co, "dx"], "batch": b,
                 "path": conv.conv_dx_route(b, h, wd, cin, co, dtype),
                 "ms": time_ms(lambda: conv.conv_dx(gc, w, h, wd), flush,
                               iters=10, spin=HOST_SPIN),
                 "library_ms": time_ms(
                     lambda: torch.nn.grad.conv2d_input(padded, w_t, g_cl,
                                                        stride=2),
                     flush, iters=10, spin=HOST_SPIN),
                 "bound_ms": bms, "bound_by": by}
            rows.append(d)
            log(f"  conv dx {shape}->{co} [{d['path']}]: {d['ms']:.4f} ms "
                f"(bound {bms:.4f} by {by}), cuDNN conv2d_input "
                f"{d['library_ms']:.4f} ms ({d['ms'] / d['library_ms']:.2f}x)")
            del gc, dx, g_cl
        del x, y, xp
        torch.cuda.empty_cache()
    return rows


def phase_stackgan_rates(device, model):
    """Sampling throughput of one StackGAN stage at batch 64, bf16
    (train-mode BN, z, emb and ε kept on the card; median of 5 windows of
    10 synchronised forwards)."""
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.eval import sampler
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.train.steps import stage1_aux
    cfg = train_config(model)
    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)
    params, state = bundle.init(cfg.seed, device)[:2]
    aux = stage1_aux(cfg, cfg.seed, device) if bundle.needs_stage1 else {}
    aux = {k: L.cast_weights(v, policy) for k, v in aux.items()}
    params = L.cast_weights(params, policy)
    gen = sampler.make_generator_fn(cfg, device=device)
    g = torch.Generator().manual_seed(SEED + 8)
    z = torch.randn(BATCH, cfg.gan.z_dim, generator=g).to(device)
    eps = torch.randn(*bundle.eps_shape(BATCH), generator=g).to(device)
    emb = torch.as_tensor(get_dataset(cfg).test_embeddings(BATCH)).to(device)

    def fn():
        return gen(params, state, aux, z, emb, eps)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        samples.append(10 * BATCH / (time.perf_counter() - t0))
    rate = sorted(samples)[2]
    log(f"  sampling {model}: {rate:.1f} images/s, {BATCH / rate * 1e3:.3f} ms "
        f"per batch of {BATCH} (median of 5 windows of 10 batches)")
    return rate


def all_counters():
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    return (conv.deconv5x5_s2, fused.bn_stats, fused.bn_act,
            fused.bn_bwd_reduce, fused.bn_bwd_apply, conv.conv5x5_s2_act,
            fused.conditioning_join, conv.upconv3x3, conv.upconv3x3_dx,
            conv.upconv3x3_dw, conv.conv5x5_s2_dw, conv.conv5x5_s2_dx,
            conv.deconv5x5_s2_dx)


def flat(tree):
    from text_to_image_tpu_torch.train.optim import flatten
    return dict(flatten(tree))


def run_dirs(root):
    """``--set`` pairs that put a run's checkpoints, logs and grids under
    `root` (a fresh directory, so that nothing is restored from an earlier
    run)."""
    return [f"{k}={os.path.join(root, k.split('_')[0])}"
            for k in ("checkpoint_dir", "log_dir", "sample_dir")]


def phase_train_path(device, runs, model="gancls"):
    """``python -m text_to_image_tpu_torch.main --cfg
    configs/<model>_flowers.yml --train --steps 3 --set
    data.dataset_name=synthetic stage1_checkpoint=`` on the card (the
    config's full widths, batch 64, bf16; checkpoints, logs and grids under
    `runs`), with the launch counts of all eight kernels."""
    from text_to_image_tpu_torch import main as port_main
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.train.steps import stage1_aux

    argv = ["--cfg", config_path(model),
            "--train", "--steps", str(TRAIN_TICKS), "--device", str(device),
            "--set", "data.dataset_name=synthetic", "train.summary_interval=1",
            "stage1_checkpoint=", *run_dirs(os.path.join(runs, model))]
    counters = all_counters()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    trainer = port_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    log(f"  {model} training-path launches over {TRAIN_TICKS} ticks: "
        f"{launches} ({wall:.1f} s)")
    per_tick = (STACKGAN_TICK_LAUNCHES[model] if model in STACKGAN_TICK_LAUNCHES
                else {**TICK_LAUNCHES, **NO_UPCONV})
    check(launches == {k: v * TRAIN_TICKS for k, v in per_tick.items()},
          f"unexpected launch counts {launches}")

    cfg = trainer.cfg
    check((cfg.model, cfg.gan.gf_dim, cfg.gan.df_dim, cfg.gan.embed_dim,
           cfg.gan.ca_dim, cfg.train.batch_size, cfg.dtype, cfg.remat) == (
               model, 128, 64, 1024, 128, BATCH, "bfloat16", False),
          f"not the full-width config: {cfg}")
    ts = trainer.ts
    check(ts.step == TRAIN_TICKS, f"step {ts.step}")
    last = trainer.history[-1]
    names = ["d_loss", "d_real", "d_fake", "d_wrong", "g_fake", "g_loss"]
    bundle = get_model(cfg)
    if bundle.has_ca:
        names.append("kl")
    for k in names:
        check(k in last and math.isfinite(last[k]), f"loss {k}: {last.get(k)}")
    if bundle.needs_stage1:
        # the frozen Stage-I generator: bit-identical to the one drawn from
        # the seed, and in neither optimizer
        check(cfg.data.image_size == 256, f"image_size {cfg.data.image_size}")
        fresh = stage1_aux(cfg, cfg.seed, device)
        for key, tree in fresh.items():
            now = flat(ts.aux[key])
            same = [k for k, v in flat(tree).items() if torch.equal(now[k], v)]
            check(len(same) == len(now), f"{key}: changed leaves "
                                         f"{sorted(set(now) - set(same))}")
            log(f"  aux[{key}]: {len(same)}/{len(now)} leaves bit-identical")
        check(not any("stage1" in n for n in ts.g_opt.names), "Stage-I in g_opt")
    gp0, gs0, dp0, ds0 = bundle.init(cfg.seed, device)
    moved = {}
    for name, now, before in (("g_params", ts.g_params, gp0),
                              ("d_params", ts.d_params, dp0),
                              ("g_state", ts.g_state, gs0),
                              ("d_state", ts.d_state, ds0)):
        a, b = flat(now), flat(before)
        changed = [k for k in b if not torch.equal(a[k].detach(), b[k])]
        moved[name] = f"{len(changed)}/{len(b)}"
        check(len(changed) == len(b),
              f"{name}: unchanged leaves {sorted(set(b) - set(changed))}")
        log(f"  {name}: {len(changed)}/{len(b)} leaves changed")
    return trainer.history, launches, moved


def tick_on(cfg, spe, batch, noise, dev):
    from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                     make_train_step)
    ts = init_train_state(cfg.seed, cfg, spe, dev)
    t0 = time.perf_counter()
    ts, m = make_train_step(cfg, spe, dev)(ts, batch, noise)
    if dev != "cpu":
        torch.cuda.synchronize()
    log(f"  tick on {dev}: {time.perf_counter() - t0:.2f} s")
    return ts, {k: float(v) for k, v in m.items()}


def params_close(gts, cts, net, kink_share=0.0):
    """Max |card − CPU| of one net's params after Adam, where its gradient
    is clear of 0; biases in front of a train-mode BN left out.  At most
    `kink_share` of the net's compared elements may lie further apart than
    PARAM_TOL (see `phase_card_vs_cpu`); the maximum counts them too."""
    params_g = flat(getattr(gts, f"{net}_params"))
    params_c = flat(getattr(cts, f"{net}_params"))
    mu = getattr(cts, f"{net}_opt").moments()[0]
    layers = {leaf.split("/")[0] for leaf in params_c}
    worst, kept, n_far, n_kept = 0.0, [], 0, 0   # worst: far elements too
    for leaf, ref in params_c.items():
        layer, *mid = leaf.split("/")[:-1]
        # a bias in front of a train-mode BN (GAN-CLS `<layer>/b` with
        # `<layer>_bn`; StackGAN's nested `up<i>/conv/b`, `res<i>/conv<j>/b`)
        if leaf.endswith("/b") and (f"{layer}_bn" in layers if not mid
                                    else mid[0].startswith("conv")):
            continue   # zero true gradient: Adam walks on round-off
        m = mu[leaf].abs()
        keep = m > 1e-3 * float(m.max())
        check(bool(keep.any()), f"{net} {leaf}: zero gradient")
        kept.append(float(keep.float().mean()))
        err = (params_g[leaf].detach().cpu() - ref.detach())[keep].abs()
        far = err > PARAM_TOL
        n_far, n_kept = n_far + int(far.sum()), n_kept + far.numel()
        check(kink_share > 0 or not bool(far.any()),
              f"{net} {leaf}: |diff| {float(err.max()):.2e} after Adam")
        worst = max(worst, float(err.max()))
    share = n_far / n_kept
    log(f"  {net} params after Adam: max |diff| {worst:.2e} (tol "
        f"{PARAM_TOL:g}; compared {min(kept):.1%}-{max(kept):.1%} of each "
        f"leaf); {n_far} of {n_kept} compared elements further apart (share "
        f"{share:.2e}, allowed {kink_share:g})")
    check(share <= kink_share, f"{net}: share {share:.2e} of the compared "
                               f"elements differs after Adam")
    return {"max_abs_diff": worst, "share_apart": share}


def phase_card_vs_cpu(device, model="gancls", batch_size=8,
                      g_after_d_tol=LOSS_TOL, kink_share=None,
                      overrides=None):
    """One tick at the config's full widths, a small batch, f32, TF32 off,
    on the card and on the CPU (plain versions), same weights, data and
    noise: losses, then params after Adam.

    `g_after_d_tol` holds the default tick's g_fake, which the G step reads
    through the D that Adam has just updated.  That first update moves
    every D weight by ≈ lr·sign(g), so the weights whose gradient is
    round-off (a few per cent of a leaf) land 2·lr apart on two devices, and
    D's logit on the fakes with them.  Where g_fake is of order 1 (Stage-II
    at init) this shows as ~1e-3 of it and gets a looser, stated tolerance.
    g_loss is g_fake plus the weighted KL term: what it holds beyond g_fake
    (g_loss − g_fake) stays at LOSS_TOL, and the tick with D frozen holds
    g_fake and g_loss themselves to LOSS_TOL.

    `kink_share`, by net ("d", "g"): every backward takes act′ from the
    sign of the saved output, so a relu / lrelu output within round-off of 0
    lands on either side of the kink on two devices (a few of a million
    outputs), and its cotangent differs by the whole act′ step.  A 256 px
    net has tens of millions of such outputs and a batch of 4 few positions
    per channel, so single flips move a channel's gradient by per cents and
    flip the sign of a small share of a leaf's elements that the |mu| mask
    keeps; Adam's first step puts those 2·lr apart.  Stage-II therefore
    allows a stated share of each net's compared elements, about three
    times the share this run reads, to lie further apart, and logs the
    largest difference with them counted; GAN-CLS at 64 px allows none.

    At init, G's first Adam step (≈ lr·sign(g) on every weight) already
    saturates D on the fakes: the second G step reads g_loss ≈ 1e-6 and its
    gradient is too small to survive round-off, so G's params after the
    default tick differ between any two devices by a few lr.  The default
    tick therefore holds the losses and D's params, and a second tick with D
    frozen (discriminator_lr 0) holds G's params.

    A critic (WGAN-CLS) has no g_fake: its g_loss, −E[D(fake)], is what
    the G step reads through the updated critic, and takes
    `g_after_d_tol`.  `overrides` are further config settings."""
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.train.steps import draw_noise
    out = {}
    for variant, extra in (("tick", {}),
                           ("tick with D frozen", {"train.discriminator_lr": 0.0})):
        log(f"  {variant}:")
        cfg = train_config(model, **{"train.batch_size": batch_size,
                                     "dtype": "float32", **(overrides or {}),
                                     **extra})
        after_d = "g_loss" if get_model(cfg).is_wgan else "g_fake"
        ds = get_dataset(cfg)
        spe = max(1, ds.num_examples // batch_size)
        batch = {k: v[None] for k, v in ds.next_batch(
            batch_size, window=cfg.data.caption_window).items()}
        noise = draw_noise(cfg, 0, batch_size)
        gts, gm = tick_on(cfg, spe, batch, noise, device)
        cts, cm = tick_on(cfg, spe, batch, noise, "cpu")
        loss_err = {}
        for k in cm:
            loss_err[k] = abs(gm[k] - cm[k])
            log(f"  {k}: card {gm[k]:.7f} cpu {cm[k]:.7f} |diff| "
                f"{loss_err[k]:.2e}")
            got, ref, tol = gm[k], cm[k], LOSS_TOL
            if not extra and k == after_d:
                tol = g_after_d_tol
            elif not extra and k == "g_loss":     # the rest of g_loss
                got, ref = got - gm["g_fake"], ref - cm["g_fake"]
            check(abs(got - ref) <= tol * (1 + abs(ref)),
                  f"loss {k} differs: {abs(got - ref):.2e} > {tol:g}·(1+|ref|)")
        net = "g" if extra else "d"
        out[variant] = {"loss_abs_diff": loss_err, "losses_card": gm,
                        "params": params_close(
                            gts, cts, net, (kink_share or {}).get(net, 0.0))}
    return out


# --- the data, checkpoint and resume path (slice 7) -----------------------

# Oxford-102 as StackGAN's pickles split it: 7,034 train and 1,155 test
# examples, 76×76×3 uint8 crop sources, 10 char-CNN-RNN captions × 1024 f32
# each, 102 classes
FLOWERS_SPLITS = {"train": 7034, "test": 1155}
FLOWERS_CLASSES = 102
FLOWERS_CAPTIONS = 10
FLOWERS_EMBED = 1024
# one GAN-CLS sample grid: a train-mode G forward without gradient
GRID_LAUNCHES = {"deconv5x5_s2": 4, "bn_stats": 4, "bn_act": 4}
DATA_TICKS = 6
# the resumed run against the straight one, when the tick is not bit for
# bit deterministic on the card (cuDNN may pick backward convolutions that
# sum in no fixed order): each of the 3 ticks after the restore moves a
# param by at most ≈ 2·lr where round-off flips the sign of a near-zero
# gradient (Adam's normalised step), so params within 3·2·lr; the losses of
# bf16 nets over 3 ticks within 5e-2·(1 + |ref|)
RESUME_PARAM_TOL = 3 * 2 * 2e-4
RESUME_LOSS_TOL = 5e-2


def write_flowers_split(root, seed=SEED):
    """A split of Oxford-102's size in the reference pickle format (what
    ``data/preprocess.py`` writes), drawn from `seed`."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for split, n in FLOWERS_SPLITS.items():
        base = os.path.join(root, split)
        os.makedirs(base)
        classes = rng.permutation(np.arange(n) % FLOWERS_CLASSES + 1)
        for name, obj in (
                ("76images.pickle",
                 list(rng.integers(0, 256, (n, 76, 76, 3), dtype=np.uint8))),
                ("char-CNN-RNN-embeddings.pickle",
                 rng.standard_normal((n, FLOWERS_CAPTIONS, FLOWERS_EMBED),
                                     dtype=np.float32)),
                ("filenames.pickle", [f"image_{i:05d}.jpg" for i in range(n)]),
                ("class_info.pickle", [int(c) for c in classes])):
            with open(os.path.join(base, name), "wb") as f:
                pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def png_size(path):
    """(width, height) from a PNG's header; (0, 0) if it is not a PNG."""
    if not os.path.isfile(path):
        return 0, 0
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        return 0, 0
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


class Tee(io.StringIO):
    """Keeps what is printed and prints it."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


class RunRecorder:
    """Around `main.main` runs: each tick's resident batch as the tick got
    it (by step), the launches of the sample grids, and the state each
    restore produced (host copies)."""

    def __init__(self):
        self.batches, self.grid_launches, self.restored = {}, [], []

    @contextlib.contextmanager
    def recording(self):
        from text_to_image_tpu_torch.train import checkpoint as ckpt
        from text_to_image_tpu_torch.train import trainer as T
        rec = self
        real_step, real_samples = T.make_resident_step, T.Trainer.save_samples
        real_restore = ckpt.CheckpointManager.restore

        def make_resident_step(cfg, spe, device, env=None):
            inner = real_step(cfg, spe, device, env)

            def step(ts, data):
                batch = inner.batch_at(data, ts.step)
                rec.batches[ts.step] = {k: v.clone() for k, v in batch.items()}
                return inner.tick(ts, batch)
            return step

        def save_samples(trainer, step):
            before = {k.__name__: k.launches for k in all_counters()}
            out = real_samples(trainer, step)
            rec.grid_launches.append({k.__name__: k.launches - before[k.__name__]
                                      for k in all_counters()})
            return out

        def restore(mgr, ts_like, step=None):
            ts, got = real_restore(mgr, ts_like, step)
            if got is not None:
                rec.restored.append((got, ckpt.state_dict(ts)))
            return ts, got

        T.make_resident_step, T.Trainer.save_samples = (make_resident_step,
                                                         save_samples)
        ckpt.CheckpointManager.restore = restore
        try:
            yield self
        finally:
            T.make_resident_step, T.Trainer.save_samples = (real_step,
                                                             real_samples)
            ckpt.CheckpointManager.restore = real_restore


def drive(argv, rec=None):
    """`main.main(argv)` with every launch count set to 0 just before and
    read just after; returns (result, launches, what it printed)."""
    from text_to_image_tpu_torch import main as port_main
    counters = all_counters()
    for k in counters:
        k.launches = 0
    out = Tee()
    with contextlib.redirect_stdout(out), \
            (rec.recording() if rec else contextlib.nullcontext()):
        res = port_main.main(argv)
    torch.cuda.synchronize()
    return res, {k.__name__: k.launches for k in counters}, out.getvalue()


def flat_state(sd):
    """A checkpoint's state dict as {name: tensor or int}."""
    out = {"step": sd["step"]}
    for k, v in sd.items():
        if k == "step":
            continue
        if k == "aux":
            for a, tree in v.items():
                out.update({f"aux/{a}/{n}": t for n, t in tree.items()})
        elif k.endswith("_opt"):
            out[f"{k}/count"] = v["count"]
            for m in ("mu", "nu"):
                out.update({f"{k}/{m}/{n}": t for n, t in v[m].items()})
        else:
            out.update({f"{k}/{n}": t for n, t in v.items()})
    return out


def state_diff(a, b):
    """Names that differ between two flat states (bit for bit)."""
    check(a.keys() == b.keys(), f"state keys differ: {a.keys() ^ b.keys()}")
    return sorted(k for k in a if not (
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k]))


def tick_windows(step, ts, feed, ticks=10, windows=3):
    """ms a tick, median of `windows` windows of `ticks` ticks, each ended
    by reading a metric; returns (median ms, windows, ts)."""
    for _ in range(2):
        ts, m = step(ts, feed())
    float(m["g_loss"])
    got = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(ticks):
            ts, m = step(ts, feed())
        float(m["g_loss"])
        got.append((time.perf_counter() - t0) / ticks * 1e3)
    return sorted(got)[windows // 2], got, ts


def phase_data_checkpoint(device, runs):
    """The GAN-CLS run of ``main.py --train`` from an Oxford-102-sized
    StackGAN-format split at full width (gf 128, df 64, batch 64, bf16) on
    the resident tier: snapshots, grids, metrics, max_to_keep; a run
    stopped at step 3 and resumed (the restore bit-equal to the snapshot,
    every tick's batch bit-identical to the straight run's); Stage-II
    taking its frozen Stage-I from a Stage-I run directory; then the tick
    through the resident and the host tier, and the checkpoint's save and
    restore at full width, timed."""
    import numpy as np

    from text_to_image_tpu_torch.config import load_config
    from text_to_image_tpu_torch.train import checkpoint as ckpt
    from text_to_image_tpu_torch.train.steps import init_train_state
    from text_to_image_tpu_torch.train.trainer import Trainer
    from text_to_image_tpu_torch.utils.tensorboard import read_events

    report = {"launches": {}}
    data_dir = os.path.join(runs, "flowers")
    t0 = time.perf_counter()
    write_flowers_split(data_dir)
    log(f"  wrote the Oxford-102-sized split ({FLOWERS_SPLITS}) in "
        f"{time.perf_counter() - t0:.1f} s")
    flowers = ["data.dataset_name=flowers", f"data.data_dir={data_dir}",
               "train.summary_interval=1"]

    def gancls(root, steps, *extra):
        return (["--cfg", config_path("gancls"), "--train", "--steps",
                 str(steps), "--device", str(device), "--set", *flowers,
                 *run_dirs(root), *extra])

    # the straight run
    straight = RunRecorder()
    a = os.path.join(runs, "a")
    trainer, launches, said = drive(gancls(a, DATA_TICKS,
                                           "train.snapshot_interval=2",
                                           "train.sample_interval=3"),
                                    straight)
    check("data path: replicated" in said, "the data path is not the "
          "replicated resident tier")
    cfg = trainer.cfg
    check((cfg.gan.gf_dim, cfg.gan.df_dim, cfg.gan.z_dim, cfg.gan.embed_dim,
           cfg.train.batch_size, cfg.dtype, cfg.data.dataset_name) ==
          (128, 64, 100, 1024, BATCH, "bfloat16", "flowers"),
          f"not the full-width flowers config: {cfg}")
    check(trainer.dataset.num_examples == FLOWERS_SPLITS["train"]
          and trainer.dataset.embeddings.shape[1:] == (FLOWERS_CAPTIONS,
                                                       FLOWERS_EMBED),
          "the split read back is not the one written")
    ck = os.path.join(a, "checkpoint", "gancls", "flowers")
    check(sorted(os.listdir(ck)) == ["step_2.pt", "step_4.pt", "step_6.pt"],
          f"snapshots {sorted(os.listdir(ck))}")
    grids = os.path.join(a, "sample", "gancls", "flowers")
    check(sorted(os.listdir(grids)) == ["train_00000003.png",
                                        "train_00000006.png"],
          f"grids {sorted(os.listdir(grids))}")
    for g in os.listdir(grids):
        check(png_size(os.path.join(grids, g)) == (8 * 64, 8 * 64),
              f"{g}: {png_size(os.path.join(grids, g))}")
    logs = os.path.join(a, "log", "gancls", "flowers")
    with open(os.path.join(logs, "train.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    check([r["step"] for r in recs] == list(range(1, DATA_TICKS + 1)),
          f"metric records {[r['step'] for r in recs]}")
    for r in recs:
        for k in ("d_loss", "d_real", "d_fake", "d_wrong", "g_fake", "g_loss"):
            check(math.isfinite(r[k]), f"step {r['step']} {k} {r[k]}")
    (events,) = [os.path.join(logs, f) for f in os.listdir(logs)
                 if f.startswith("events.out.tfevents.")]
    ev = read_events(events)
    check(sorted(e["step"] for e in ev if "g_loss" in e["scalars"])
          == list(range(1, DATA_TICKS + 1)), "TensorBoard scalars")
    check(sorted(e["step"] for e in ev if "samples" in e["images"]) == [3, 6],
          "TensorBoard images")
    check(len(straight.grid_launches) == 2 and all(
        g == {k.__name__: GRID_LAUNCHES.get(k.__name__, 0)
              for k in all_counters()} for g in straight.grid_launches),
          f"grid launches {straight.grid_launches}")
    per_tick = {k: (v - sum(g[k] for g in straight.grid_launches)) / DATA_TICKS
                for k, v in launches.items()}
    check(per_tick == {**TICK_LAUNCHES, **NO_UPCONV},
          f"launches per tick {per_tick}")
    report["launches"]["flowers training (6 ticks, 2 grids)"] = launches
    log(f"  straight run: {DATA_TICKS} ticks, snapshots 2, 4, 6, grids 3, 6, "
        f"{len(recs)} metric records, launches {launches} (per tick "
        f"{per_tick}; each grid {straight.grid_launches[0]})")
    report["straight_history"] = trainer.history

    # max_to_keep: a snapshot every step over 7 steps leaves the last five
    b = os.path.join(runs, "b")
    _, launches, _ = drive(gancls(b, 7, "train.snapshot_interval=1"))
    kept = sorted(os.listdir(os.path.join(b, "checkpoint", "gancls", "flowers")))
    check(kept == [f"step_{s}.pt" for s in range(3, 8)], f"kept {kept}")
    report["launches"]["flowers training (7 ticks, a snapshot each)"] = launches
    log(f"  max_to_keep: {kept}")

    # stopped at step 3, resumed by a second call
    resumed = RunRecorder()
    c = os.path.join(runs, "c")
    _, l1, _ = drive(gancls(c, 3, "train.snapshot_interval=2",
                            "train.sample_interval=3"), resumed)
    t2, l2, said = drive(gancls(c, DATA_TICKS, "train.snapshot_interval=2",
                                "train.sample_interval=3"), resumed)
    check("restored checkpoint at step 3" in said, "no restore at step 3")
    report["launches"]["flowers training resumed (3 + 3 ticks)"] = {
        k: l1[k] + l2[k] for k in l1}
    (step, restored), = resumed.restored
    snap = torch.load(os.path.join(c, "checkpoint", "gancls", "flowers",
                                   "step_3.pt"), weights_only=True)
    restored, snap = flat_state(restored), flat_state(snap)
    differ = state_diff(restored, snap)
    check(step == 3 and not differ, f"restore not bit-equal: {differ[:10]}")
    log(f"  restore at step 3: {len(snap)} entries bit-equal to the snapshot "
        f"(params, BN state, Adam counts and moments, step)")
    check(sorted(resumed.batches) == sorted(straight.batches)
          == list(range(DATA_TICKS)), "recorded batches")
    for s in range(DATA_TICKS):
        for k, v in straight.batches[s].items():
            check(torch.equal(v, resumed.batches[s][k]),
                  f"the batch of step {s} differs ({k})")
    log(f"  every tick's batch of the resumed run bit-identical to the "
        f"straight run's (steps 0..{DATA_TICKS - 1}, real / wrong / emb)")
    end_a = flat_state(ckpt.state_dict(trainer.ts))
    end_c = flat_state(ckpt.state_dict(t2.ts))
    differ = state_diff(end_a, end_c)
    worst = max((float((end_a[k].float() - end_c[k].float()).abs().max())
                 for k in differ if isinstance(end_a[k], torch.Tensor)
                 and "/mu/" not in k and "/nu/" not in k), default=0.0)
    loss_diff = {k: abs(trainer.history[-1][k] - t2.history[-1][k])
                 for k in ("d_loss", "g_loss", "d_real", "d_fake", "d_wrong")}
    log(f"  final state of the resumed run vs the straight run: "
        f"{len(end_a) - len(differ)}/{len(end_a)} entries bit-identical; "
        f"largest param / BN-state difference {worst:.3e}; final losses "
        f"|diff| {loss_diff}")
    check(worst <= RESUME_PARAM_TOL, f"params {worst:.3e} apart")
    for k, v in loss_diff.items():
        check(v <= RESUME_LOSS_TOL * (1 + abs(trainer.history[-1][k])),
              f"final {k} {v:.3e} apart")
    report["resume"] = {"bit_identical_entries": len(end_a) - len(differ),
                        "entries": len(end_a), "differing": differ[:50],
                        "max_param_diff": worst, "final_loss_diff": loss_diff}
    del straight, resumed, trainer, t2
    torch.cuda.empty_cache()

    # Stage-II takes its frozen Stage-I from a Stage-I run directory
    s = os.path.join(runs, "s")
    s1, launches, _ = drive(
        ["--cfg", config_path("stackgan_stage1"), "--train", "--steps", "2",
         "--device", str(device), "--set", *flowers, "train.ema_decay=0.999",
         *run_dirs(os.path.join(s, "stage1"))])
    check(s1.cfg.gan.gf_dim == 128 and s1.cfg.data.image_size == 64,
          f"Stage-I config {s1.cfg}")
    report["launches"]["Stage-I training from the split (2 ticks)"] = launches
    run1 = os.path.join(s, "stage1", "checkpoint", "stackgan_stage1",
                        "flowers")
    snap = torch.load(os.path.join(run1, "step_2.pt"), weights_only=True)
    ema = snap["aux"]["ema_g_params"]
    check(any(not torch.equal(ema[k], snap["g_params"][k]) for k in ema),
          "the Stage-I EMA equals its live params")
    s2, launches, said = drive(
        ["--cfg", config_path("stackgan_stage2"), "--train", "--steps", "1",
         "--device", str(device), "--set", "data.dataset_name=synthetic",
         f"stage1_checkpoint={run1}", *run_dirs(os.path.join(s, "stage2"))])
    report["launches"]["Stage-II from the Stage-I run directory (1 tick)"] = \
        launches
    got = flat(s2.ts.aux["stage1_g_params"])
    check(got.keys() == ema.keys(), "Stage-I leaves")
    same = [k for k in got if torch.equal(got[k].cpu(), ema[k])]
    check(len(same) == len(ema), f"frozen Stage-I differs from the EMA: "
                                 f"{sorted(set(ema) - set(same))[:5]}")
    state = flat(s2.ts.aux["stage1_g_state"])
    check(all(torch.equal(state[k].cpu(), v)
              for k, v in snap["g_state"].items()), "Stage-I BN state")
    log(f"  Stage-II (256 px) took its frozen Stage-I from {run1}: "
        f"{len(same)}/{len(ema)} leaves bit-equal to the step-2 EMA params")
    del s1, s2
    torch.cuda.empty_cache()

    # timing: the tick through each tier, the checkpoint's save and restore
    timing = {}
    for tier, mode in (("resident", "auto"), ("host", "off")):
        tcfg = load_config(config_path("gancls"), {
            "data.dataset_name": "flowers", "data.data_dir": data_dir,
            "data.device_resident": mode,
            **dict(kv.split("=", 1) for kv in run_dirs(
                os.path.join(runs, f"t_{tier}")))})
        with contextlib.redirect_stdout(Tee()):
            tr = Trainer(tcfg, device=device, restore=False)
        check((tr.device_data is not None) == (tier == "resident"),
              f"{tier} tier not taken")
        if tr.device_data is not None:
            def feed(tr=tr):
                return tr.device_data
        else:
            def feed(tr=tr):
                return next(tr.pipeline)
        ms, windows, tr.ts = tick_windows(tr.step_fn, tr.ts, feed)
        prof = phase_tick_profile(tr.ts, lambda ts, _: tr.step_fn(ts, feed()),
                                  None, ms)
        timing[f"{tier} tier"] = {
            "tick_ms": ms, "windows_ms": windows,
            "images_per_s": BATCH / ms * 1e3,
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"],
            "kernels_per_tick": prof["kernels_per_tick"]}
        log(f"  GAN-CLS tick, {tier} tier: {ms:.3f} ms (windows "
            f"{', '.join(f'{w:.3f}' for w in windows)}), device busy "
            f"{prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.1%}")
        tr.close()
        del tr
        torch.cuda.empty_cache()
    for model in ("gancls", "stackgan_stage2"):
        mcfg = train_config(model)
        ts = init_train_state(mcfg.seed, mcfg, 100, device)
        like = init_train_state(mcfg.seed + 1, mcfg, 100, device)
        size = sum(t.numel() * t.element_size()
                   for t in flat_state(ckpt.state_dict(ts)).values()
                   if isinstance(t, torch.Tensor))
        saves, restores = [], []
        for rep in range(3):
            mgr = ckpt.CheckpointManager(os.path.join(runs, f"ck_{model}_{rep}"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(1, ts)
            saves.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            mgr.restore(like)
            torch.cuda.synchronize()
            restores.append((time.perf_counter() - t0) * 1e3)
            shutil.rmtree(mgr.directory)
        differ = state_diff(flat_state(ckpt.state_dict(like)),
                            flat_state(ckpt.state_dict(ts)))
        check(not differ, f"{model} restore: {differ[:5]}")
        timing[f"{model} checkpoint"] = {
            "bytes": size, "save_ms": sorted(saves)[1],
            "restore_ms": sorted(restores)[1], "save_ms_all": saves,
            "restore_ms_all": restores}
        log(f"  {model} checkpoint ({size / 2**20:.1f} MiB): save "
            f"{sorted(saves)[1]:.1f} ms, restore {sorted(restores)[1]:.1f} ms "
            f"(medians of 3)")
        del ts, like
        torch.cuda.empty_cache()
    report["timing"] = timing
    return report


def flagship_config():
    from text_to_image_tpu_torch.config import Config, DataConfig
    return Config(model="gancls", dtype="bfloat16", seed=SEED,
                  data=DataConfig(dataset_name="synthetic", image_size=64))


def no_library_conv5x5(what, prof, dw_per_tick):
    """A profiled tick (`tools/ticks.tick_profile`) launched no library
    convolution over a 5×5 filter, and conv5x5_s2_dw as often as counted."""
    log(f"  {what} tick: {prof['library_conv5x5_per_tick']:g} library "
        f"convolutions over a 5×5 filter, {prof['conv5x5_s2_dw_per_tick']:g} "
        f"conv5x5_s2_dw launches (counted: {dw_per_tick})")
    check(prof["library_conv5x5_per_tick"] == 0,
          f"{what} tick: a library 5×5 convolution ran")
    check(prof["conv5x5_s2_dw_per_tick"] == dw_per_tick,
          f"{what} tick: {prof['conv5x5_s2_dw_per_tick']} conv5x5_s2_dw "
          f"launches, {dw_per_tick} counted")


def phase_main_path(device):
    """The sampling path at flagship widths, with the launch counts."""
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.eval import sampler
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    from text_to_image_tpu_torch.utils import prng

    cfg = flagship_config()
    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)
    params32, state = bundle.init(cfg.seed, device)[:2]
    ts = sampler.GeneratorState(L.cast_weights(params32, policy), state)
    gen = sampler.make_generator_fn(cfg, device=device)
    emb = get_dataset(cfg).test_embeddings(BATCH)
    g = prng.generator(prng.fold_in(cfg.seed, 1))
    z = torch.randn(BATCH, cfg.gan.z_dim, generator=g)
    rows = min(8, BATCH // 2)   # as main.evaluate: 8 captions × 8 steps
    z1, z2, zt = (torch.randn(rows, cfg.gan.z_dim, generator=g)
                  for _ in range(3))

    counters = all_counters()
    for k in counters:
        k.launches = 0
    grid = sampler.sample_grid(gen, ts, cfg, emb, z=z)
    zgrid, zshape = sampler.latent_interpolation_grid(
        gen, ts, cfg, emb[:rows], 8, z1=z1, z2=z2)
    tgrid, tshape = sampler.text_interpolation_grid(
        gen, ts, cfg, emb[:rows], emb[rows:2 * rows], 8, z=zt)
    with torch.inference_mode():
        folded = bundle.gen_apply_inference(
            ts.g_params, ts.g_state, z.to(device), torch.as_tensor(emb).to(device),
            policy).float().cpu()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    log(f"  main-path launches: {launches}")
    # 3 train-mode forwards without gradient (4 deconv; 4 BN calls, each one
    # bn_stats + one bn_act) + the folded forward (4 deconv + 1 bn_act, the
    # eval-mode BN of its stem)
    want = {k.__name__: 0 for k in counters}
    want.update({"deconv5x5_s2": 16, "bn_stats": 12, "bn_act": 13})
    check(launches == want, f"unexpected launch counts {launches}")

    for name, imgs in (("sample grid", grid), ("z interpolation", zgrid),
                       ("text interpolation", tgrid),
                       ("folded generator", folded.numpy())):
        imgs = torch.as_tensor(imgs)
        check(tuple(imgs.shape)[1:] == (64, 64, 3), f"{name} {imgs.shape}")
        check(bool(torch.isfinite(imgs).all()), f"{name}: non-finite")
        check(float(imgs.abs().max()) <= 1.0, f"{name}: outside [-1, 1]")
        log(f"  {name}: {tuple(imgs.shape)} finite, in [-1, 1], "
            f"std {float(imgs.std()):.4f}")
    check(zshape == tshape == (rows, 8), "grid shapes")

    # the whole generator against the same code on the CPU (plain versions)
    cpu32 = {k: {n: t.cpu() for n, t in v.items()} for k, v in params32.items()}
    cpu_state = {k: {n: t.cpu() for n, t in v.items()} for k, v in state.items()}
    emb_t = torch.as_tensor(emb)
    g_err = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            pol = L.Policy(compute_dtype=dtype)
            dev_img = bundle.gen_apply(L.cast_weights(params32, pol), state,
                                       {}, z.to(device), emb_t.to(device),
                                       None, True, pol)[0]
            ref_img = bundle.gen_apply(L.cast_weights(cpu32, pol), cpu_state,
                                       {}, z, emb_t, None, True, pol)[0]
            g_err[f"train {str(dtype)[6:]}"] = compare(
                dev_img.cpu(), ref_img, G_TOL[dtype], 0,
                f"generator (train mode) {str(dtype)[6:]} vs CPU plain path")
        ref_fold = bundle.gen_apply_inference(L.cast_weights(cpu32, policy),
                                              cpu_state, z, emb_t, policy)
        g_err["folded bfloat16"] = compare(
            folded, ref_fold, G_TOL[torch.bfloat16], 0,
            "folded generator bfloat16 vs CPU plain path")
    return cfg, bundle, ts, gen, z, emb, launches, g_err


def phase_timing(device, cfg, bundle, ts, gen, z, emb):
    import torch.nn.functional as F

    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    flush = L2Flush(device)
    gen_ = torch.Generator().manual_seed(SEED + 1)
    dtype = torch.bfloat16
    rows = {"deconv5x5_s2": []}
    for shape, co, act in DECONV_SHAPES:
        x, w, s, t = deconv_inputs(shape, co, dtype, device, gen_)
        y = conv.deconv5x5_s2(x, w, s, t, act)
        b, h, wd, cin = shape
        # one library call: cuDNN's transposed conv (no epilogue) with the
        # kernel flipped, padding 1, cropped to 2H×2W; NHWC via channels_last
        x_cl = x.permute(0, 3, 1, 2)
        w_t = w.permute(2, 3, 0, 1).flip(2, 3).contiguous()

        def lib():
            return F.conv_transpose2d(x_cl, w_t, stride=2, padding=1)
        lib_y = lib()[:, :, :2 * h, :2 * wd].permute(0, 2, 3, 1)
        plain = conv.deconv5x5_s2_plain(x, w, s, t, "none")
        lib_err = float(((lib_y.float() * s + t) - plain.float()).abs().max())
        flops = s2_ops(b, 2 * h, 2 * wd, cin, co)
        bms, by = bound(nbytes(x, w, s, t, y), flops, dtype)
        path = conv.deconv_path(cin, co, dtype)
        plan = conv.deconv_plan(b * h * wd, co, cin) if path == "wgmma" else None
        tag = grouped_tag(conv, path, plan, h, wd)
        r = {"shape": [list(shape), co, act], "path": path,
             "plan": list(plan) if plan else None, "tag": tag,
             "ms": time_ms(lambda: conv.deconv5x5_s2(x, w, s, t, act), flush),
             "plain_ms": time_ms(
                 lambda: conv.deconv5x5_s2_plain(x, w, s, t, act), flush, 5),
             "library_ms": time_ms(lib, flush),
             "bound_ms": bms, "bound_by": by,
             "library_max_abs_err_vs_plain": lib_err}
        r["tflops"] = flops / r["ms"] / 1e9
        rows["deconv5x5_s2"].append(r)
        log(f"  deconv5x5_s2 {shape}->{co} [{tag}]: {r['ms']:.4f} ms (bound "
            f"{bms:.4f} by {by}, {r['tflops']:.1f} TFLOP/s), plain "
            f"{r['plain_ms']:.4f}, cuDNN {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x)")
    # sampling throughput at batch 64 (device-resident z, emb; host clock
    # around synchronised windows)
    policy = L.Policy.from_str(cfg.dtype)
    zd, ed = z.to(device), torch.as_tensor(emb).to(device)
    fold = torch.inference_mode()(
        lambda: bundle.gen_apply_inference(ts.g_params, ts.g_state, zd, ed,
                                           policy))
    rates = {}
    for name, fn in (("train_mode", lambda: gen(ts.g_params, ts.g_state,
                                                ts.aux, zd, ed)),
                     ("folded", fold)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            samples.append(20 * BATCH / (time.perf_counter() - t0))
        rates[name] = sorted(samples)[2]
        log(f"  sampling {name}: {rates[name]:.1f} images/s (median of 5 "
            f"windows of 20 batches of {BATCH})")
    return rows, rates


def phase_bn_timing(device, flush):
    """The four batch-norm kernels at every train-mode BN call of every path
    (bf16, L2 flushed): each kernel beside its bound (bytes: each input read
    once, each output written once), its plain version and PyTorch's own
    kernel for the same step, per stream (`torch.batch_norm_stats`,
    `batch_norm_elemt`, `batch_norm_backward_reduce`,
    `batch_norm_backward_elemt`: SyncBatchNorm's kernels; the last three
    without the activation); then a whole call forward (bn_stats + bn_act)
    and forward + backward (through autograd, dx, dγ, dβ) beside
    `F.batch_norm(training=True)` + the activation on the channels_last
    view of each stream."""
    import torch.nn.functional as F

    from text_to_image_tpu_torch.ops.kernels import fused
    gen = torch.Generator().manual_seed(SEED + 12)
    dtype = torch.bfloat16
    f_act = {"relu": F.relu, "lrelu": lambda v: F.leaky_relu(v, 0.2),
             "none": lambda v: v}
    rows = []
    for shape, s, act in BN_CALLS:
        x, gamma, beta, rm, rv = bn_train_inputs(shape, dtype, device, gen)
        c = shape[-1]
        mean, rstd, a, b, new_mean, new_var = fused.bn_stats(x, s, gamma, beta,
                                                             rm, rv)
        y = fused._bn_act_forward(x, a, b, act)
        g = torch.randn(shape, generator=gen).to(device, dtype)
        sums = fused.bn_bwd_reduce(g, y, x, mean, rstd, s, act)
        dx = fused.bn_bwd_apply(g, y, x, mean, rstd, gamma, *sums[:2], s, act)
        ya = [y] if act != "none" else []
        per_c = nbytes(gamma, beta, rm, rv)
        # streams as channels_last NCHW views, PyTorch's statistics of each
        xs = [t.permute(0, 3, 1, 2) for t in x.chunk(s)]
        gs = [t.permute(0, 3, 1, 2) for t in g.chunk(s)]
        lib_stats = [torch.batch_norm_stats(xi, 1e-5) for xi in xs]
        lib_sums = [torch.batch_norm_backward_reduce(gi, xi, m, i, gamma, True,
                                                     True, True)
                    for gi, xi, (m, i) in zip(gs, xs, lib_stats)]
        count = torch.tensor([x.numel() // c // s], dtype=torch.int32,
                             device=device)
        n = x.numel()
        kernels = {
            "stats": (lambda: fused.bn_stats(x, s, gamma, beta, rm, rv),
                      lambda: fused.bn_stats_plain(x, s, gamma, beta, rm, rv),
                      lambda: [torch.batch_norm_stats(xi, 1e-5) for xi in xs],
                      nbytes(x, mean, rstd, a, b, new_mean, new_var) + per_c,
                      6 * n),
            "apply": (lambda: fused._bn_act_forward(x, a, b, act),
                      lambda: fused.bn_act_plain(x, a, b, act),
                      lambda: [torch.batch_norm_elemt(xi, gamma, beta, m, i,
                                                      1e-5)
                               for xi, (m, i) in zip(xs, lib_stats)],
                      nbytes(x, y, a, b), 3 * n),
            "reduce": (lambda: fused.bn_bwd_reduce(g, y, x, mean, rstd, s, act),
                       lambda: fused.bn_bwd_reduce_plain(g, y, x, mean, rstd, s,
                                                         act),
                       lambda: [torch.batch_norm_backward_reduce(
                           gi, xi, m, i, gamma, True, True, True)
                           for gi, xi, (m, i) in zip(gs, xs, lib_stats)],
                       nbytes(g, x, *ya, mean, rstd, *sums), 6 * n),
            "dx": (lambda: fused.bn_bwd_apply(g, y, x, mean, rstd, gamma,
                                              *sums[:2], s, act),
                   lambda: fused.bn_bwd_apply_plain(g, y, x, mean, rstd, gamma,
                                                    *sums[:2], s, act),
                   lambda: [torch.batch_norm_backward_elemt(
                       gi, xi, m, i, gamma, r[0], r[1], count)
                       for gi, xi, (m, i), r in zip(gs, xs, lib_stats,
                                                    lib_sums)],
                   nbytes(g, x, *ya, dx, mean, rstd, gamma, *sums[:2]), 8 * n)}
        r = {"shape": list(shape), "streams": s, "act": act}
        for name, (fn, plain, lib, nb, flops) in kernels.items():
            bms, by = bound(nb, flops, torch.float32)
            ms = time_ms(fn, flush, spin=HOST_SPIN)
            r[name] = {"ms": ms, "plain_ms": time_ms(plain, flush, 5),
                       "library_ms": time_ms(lib, flush, spin=HOST_SPIN),
                       "bound_ms": bms, "bound_by": by,
                       "gbytes_per_s": nb / ms / 1e6}
        # a whole call: ours vs F.batch_norm + act, forward and with backward
        rm2, rv2 = rm.clone(), rv.clone()
        xq = x.detach().requires_grad_(True)
        gq = gamma.detach().requires_grad_(True)
        bq = beta.detach().requires_grad_(True)
        xsq = [xi.detach().requires_grad_(True) for xi in xs]

        def ours_fwd_bwd():
            yq = fused.batch_norm_train(xq, gq, bq, rm, rv, s, act)[0]
            return torch.autograd.grad(yq, (xq, gq, bq), g)

        def torch_fwd():
            return [f_act[act](F.batch_norm(xi, rm2, rv2, gamma, beta, True,
                                            0.1, 1e-5)) for xi in xs]

        def torch_fwd_bwd():
            outs = [f_act[act](F.batch_norm(xi, rm2, rv2, gq, bq, True, 0.1,
                                            1e-5)) for xi in xsq]
            return torch.autograd.grad(outs, xsq + [gq, bq], gs)
        # the device busy for the host's whole enqueue (autograd, Python):
        # device time, not the host's
        r["fwd_ms"] = time_ms(lambda: fused.batch_norm_train(
            x, gamma, beta, rm, rv, s, act), flush, spin=HOST_SPIN)
        r["fwd_bwd_ms"] = time_ms(ours_fwd_bwd, flush, spin=HOST_SPIN)
        r["f_batch_norm_fwd_ms"] = time_ms(torch_fwd, flush, spin=HOST_SPIN)
        r["f_batch_norm_fwd_bwd_ms"] = time_ms(torch_fwd_bwd, flush,
                                               spin=HOST_SPIN)
        rows.append(r)
        log(f"  bn {shape} S={s} {act}: " + ", ".join(
            f"{k} {r[k]['ms']:.4f} (bound {r[k]['bound_ms']:.4f}, torch "
            f"{r[k]['library_ms']:.4f})"
            for k in kernels) + f"; call fwd {r['fwd_ms']:.4f} vs F.batch_norm "
            f"{r['f_batch_norm_fwd_ms']:.4f}, fwd+bwd {r['fwd_bwd_ms']:.4f} vs "
            f"{r['f_batch_norm_fwd_bwd_ms']:.4f} ms")
        del x, y, g, dx, xs, gs, xq, xsq
        torch.cuda.empty_cache()
    return rows


def bwd_ms(fn, args, grad_idx, flush, gen):
    """Device time of one backward of fn's autograd.Function (the graph is
    built once and kept)."""
    xs = [a.detach().clone().requires_grad_(i in grad_idx)
          if isinstance(a, torch.Tensor) else a for i, a in enumerate(args)]
    y = fn(*xs)
    g = torch.randn(y.shape, generator=gen).to(y.device, y.dtype)
    leaves = [xs[i] for i in grad_idx]
    return time_ms(lambda: torch.autograd.grad(y, leaves, g, retain_graph=True),
                   flush, iters=10)


def phase_train_timing(device, flush):
    """conv5x5_s2_act and conditioning_join at the D's shapes (bf16, batch
    3·64 and 64): kernel, plain version, one library call, bound, and the
    backward; the backward of deconv5x5_s2 and bn_act at the tick's
    shapes."""
    import torch.nn.functional as F

    from text_to_image_tpu_torch.ops.kernels import conv, fused
    gen = torch.Generator().manual_seed(SEED + 4)
    dtype = torch.bfloat16
    rows = {"conv5x5_s2_act": [], "conditioning_join": []}
    for b in (D_BATCH, BATCH):
        for shape, co, act in conv_shapes(b):
            x, w, bias = conv_inputs(shape, co, dtype, device, gen)
            y = conv.conv5x5_s2_act(x, w, bias, act)
            _, h, wd, cin = shape
            # one library call: cuDNN's conv on the (1, 2)-pre-padded NCHW
            # input (channels_last strides) with the bias, plus the act
            xp = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2)).contiguous(
                memory_format=torch.channels_last)
            w_t = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b16 = bias.to(dtype)

            def lib():
                out = F.conv2d(xp, w_t, b16, stride=2)
                return F.leaky_relu(out, 0.2) if act == "lrelu" else out
            lib_err = float((lib().permute(0, 2, 3, 1).float()
                             - conv.conv5x5_s2_act_plain(x, w, bias, act).float()
                             ).abs().max())
            flops = s2_ops(b, h, wd, cin, co)
            nb = nbytes(x, w, bias, y)
            bms, by = bound(nb, flops, dtype)
            path, plan, tag = conv_plan_tag(conv, shape, co, dtype)
            r = {"shape": [list(shape), co, act], "batch": b, "path": path,
                 "plan": plan,
                 "ms": time_ms(lambda: conv.conv5x5_s2_act(x, w, bias, act),
                               flush),
                 "plain_ms": time_ms(lambda: conv.conv5x5_s2_act_plain(
                     x, w, bias, act), flush, 5),
                 "library_ms": time_ms(lib, flush),
                 "bound_ms": bms, "bound_by": by,
                 "bwd_ms": bwd_ms(conv.conv5x5_s2_act, [x, w, bias, act],
                                  (0, 1, 2), flush, gen),
                 "library_max_abs_err_vs_plain": lib_err}
            r["tflops"] = flops / r["ms"] / 1e9
            r["gbytes_per_s"] = nb / r["ms"] / 1e6
            rows["conv5x5_s2_act"].append(r)
            log(f"  conv5x5_s2_act {shape}->{co} {act} [{tag}]: "
                f"{r['ms']:.4f} ms (bound {bms:.4f} by {by}, "
                f"{r['tflops']:.1f} TFLOP/s, {r['gbytes_per_s']:.0f} GB/s), "
                f"plain {r['plain_ms']:.4f}, cuDNN {r['library_ms']:.4f} "
                f"({r['ms'] / r['library_ms']:.2f}x), backward "
                f"{r['bwd_ms']:.4f} ms")
        shape, e, co = join_shape(b)
        x, t, wx, wt, bias = join_inputs(shape, e, co, dtype, device, gen)
        y = fused.conditioning_join(x, t, wx, wt, bias, "none")
        # one library call: addmm on the materialised concat
        cat = torch.cat([x, t[:, None, None, :].expand(*shape[:3], e)],
                        -1).reshape(-1, shape[-1] + e)
        wcat = torch.cat([wx, wt])
        b16 = bias.to(dtype)
        flops = 2 * b * 16 * shape[-1] * co + 2 * b * e * co
        nb = nbytes(x, t, wx, wt, bias, y)
        bms, by = bound(nb, flops, dtype)
        jpath = fused.join_path(shape[-1], e, co, dtype)
        r = {"shape": [list(shape), e, co, "none"], "batch": b, "path": jpath,
             "ms": time_ms(lambda: fused.conditioning_join(
                 x, t, wx, wt, bias, "none"), flush),
             "plain_ms": time_ms(lambda: fused.conditioning_join_plain(
                 x, t, wx, wt, bias, "none"), flush),
             "library_ms": time_ms(lambda: torch.addmm(b16, cat, wcat), flush),
             "bound_ms": bms, "bound_by": by,
             "bwd_ms": bwd_ms(fused.conditioning_join,
                              [x, t, wx, wt, bias, "none"], (0, 1, 2, 3, 4),
                              flush, gen)}
        r["gbytes_per_s"] = nb / r["ms"] / 1e6
        rows["conditioning_join"].append(r)
        log(f"  conditioning_join {shape} e{e}->{co} [{jpath}, 128x64 tiles, "
            f"one launch]: {r['ms']:.4f} ms (bound {bms:.4f} by {by}, "
            f"{r['gbytes_per_s']:.0f} GB/s), plain {r['plain_ms']:.4f}, addmm "
            f"{r['library_ms']:.4f} ({r['ms'] / r['library_ms']:.2f}x), "
            f"backward {r['bwd_ms']:.4f} ms")
    bwd = {"deconv5x5_s2": []}
    for shape, co, act in DECONV_SHAPES:
        x, w, sc, t = deconv_inputs(shape, co, dtype, device, gen)
        ms = bwd_ms(conv.deconv5x5_s2, [x, w, sc, t, act], (0, 1, 3), flush,
                    gen)
        bwd["deconv5x5_s2"].append({"shape": [list(shape), co, act],
                                    "bwd_ms": ms})
        log(f"  deconv5x5_s2 backward {shape}->{co} {act}: {ms:.4f} ms")
    return rows, bwd


def phase_profile(gen, ts, z, emb, device, rate):
    """Device time per train-mode forward by kernel family (torch.profiler,
    CUPTI), and the device's busy share of the unprofiled forward time."""
    from torch.profiler import ProfilerActivity, profile
    zd, ed = z.to(device), torch.as_tensor(emb).to(device)
    for _ in range(3):
        gen(ts.g_params, ts.g_state, ts.aux, zd, ed)
    torch.cuda.synchronize()
    n = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            gen(ts.g_params, ts.g_state, ts.aux, zd, ed)
        torch.cuda.synchronize()
    fams: dict = {}
    launches = 0
    for e in prof.key_averages():
        if not is_kernel(e):
            continue
        fam = kernel_family(e.key)
        fams[fam] = fams.get(fam, 0.0) + e.self_device_time_total / 1e3 / n
        launches += e.count
    busy = sum(fams.values())
    wall = BATCH / rate * 1e3
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.4f} ms per forward ({ms / busy:.1%} of device time)")
    log(f"  device busy {busy:.4f} ms of {wall:.4f} ms per forward "
        f"(idle share {1 - busy / wall:.1%}); {launches / n:.0f} kernel "
        f"launches per forward")
    return {"ms_per_forward_by_family": fams, "device_busy_ms": busy,
            "forward_ms": wall, "idle_share": 1 - busy / wall,
            "kernels_per_forward": launches / n}


# --- WGAN-CLS and C-PGGAN ------------------------------------------------

PGGAN_TICKS_PER_STAGE = 2
# the kernel critic's parameter gradients of one critic update (GP included)
# against the plain critic's on the card, held as the backward checks hold
# theirs: within tol of the critic's largest gradient element plus tol of
# the element (f32 with TF32 off: GRAD_REL; bf16: one rounding of every
# layer's output).  A leaf's own scale is no yardstick: a leaf whose true
# gradient is near 0 (join_ln's bias) reads the other leaves' round-off (on
# an H100 80GB HBM3, f32: 1.6e-4 apart on a critic whose largest element is
# 113, 1.5 % of that leaf's own largest)
CRITIC_GRAD_TOL = {torch.float32: GRAD_REL, torch.bfloat16: 1e-2}


def wgan_tick_launches(n_critic, g_steps):
    """Launches per WGAN-CLS tick.  Each critic update: G without gradient
    (4 deconv; 4 BN calls: stem, up0-2), the layer-norm critic over the
    three streams (4 conv, 1 join) and once more at x̂ inside the gradient
    penalty (4 conv, 1 join); each G update: G (4 deconv, 4 BN calls,
    differentiated) and the critic on one stream (4 conv, 1 join).  The
    layer norm launches none of the kernels.  The 5×5 backwards (a conv's
    dx a conv5x5_s2_dx launch, the RGB layer's, Cin 3, a deconv launch; a
    deconv's dx a deconv5x5_s2_dx launch (bf16, Cin 64 or more); each dw
    one conv5x5_s2_dw): a critic update differentiates the three streams'
    convs (3 dx of the deep layers, 4 dw), the penalty's inner gradient at
    x̂ (4 dx, and the 4 dw it forms unasked) and then that gradient (the 4
    dx ops' backward: 3 conv and, for the RGB layer's deconv of Cin 64 to
    Co 3, 1 deconv5x5_s2_dx on its thin path; 4 dw; the dw ops' backward:
    4 dx, 4 conv at x̂ counted above), 3 + 3 + 3 conv5x5_s2_dx and 1 + 1
    deconv; a G update D's 4 convs in x (3 conv5x5_s2_dx, 1 deconv) and
    G's 4 deconvs (4 deconv5x5_s2_dx, 4 dw)."""
    return {"deconv5x5_s2": 4 * (n_critic + g_steps) + 2 * n_critic
            + g_steps,
            "conv5x5_s2_dx": 9 * n_critic + 3 * g_steps,
            "deconv5x5_s2_dx": n_critic + 4 * g_steps,
            "bn_stats": 4 * (n_critic + g_steps),
            "bn_act": 4 * (n_critic + g_steps),
            "bn_bwd_reduce": 4 * g_steps, "bn_bwd_apply": 4 * g_steps,
            "conv5x5_s2_act": 11 * n_critic + 4 * g_steps,
            "conditioning_join": 2 * n_critic + g_steps,
            "conv5x5_s2_dw": 16 * n_critic + 4 * g_steps, **NO_UPCONV}


def pggan_launches(stage, ticks, grids, cfg):
    """upconv3x3 launches of C-PGGAN ticks and grids at `stage`: every
    generator forward (one per critic update, one per G update, one per
    grid) runs stage − 1 up-blocks, and each G update differentiates them
    (one upconv3x3_dx and one upconv3x3_dw each: the first block's input
    comes from the trained stem); nothing else launches a kernel."""
    forwards = ticks * (cfg.train.n_critic + cfg.train.g_steps) + grids
    backwards = ticks * cfg.train.g_steps * (stage - 1)
    return {**{k.__name__: 0 for k in all_counters()},
            "upconv3x3": forwards * (stage - 1),
            "upconv3x3_dx": backwards, "upconv3x3_dw": backwards}


def pggan_conv3x3_launches(stage, cfg):
    """The 3×3 stride-1 family's launches in one C-PGGAN tick at `stage`,
    from the model's layers: a generator forward runs `stage` 3×3 convs
    (stem_conv, up{s}b), a critic forward 2·(stage − 1) + 1 (down{s}a,
    down{s}b, conv4), each one conv3x3_act.  A critic update: G without
    gradient, the critic over the three streams (one call of 3B) and at
    x̂; the penalty's inner gradient at x̂ (an act_grad and a dx a conv,
    no dw: it asks for x̂ alone); the loss's backward through the streams'
    convs (act_grad, dx, dw), through the inner gradient (its dx's adjoint:
    a forward and a dw; its act_grad's adjoint: an act_grad) and through
    the convs at x̂ again (act_grad, dx, dw).  A G update: G and the
    critic, the critic's act_grad and dx (no dw), G's act_grad, dx (the
    first conv's input comes from the trained stem) and dw."""
    g, d = stage, 2 * (stage - 1) + 1
    nc, ng = cfg.train.n_critic, cfg.train.g_steps
    return {"conv3x3_act": nc * (g + 3 * d) + ng * (g + d),
            "conv3x3_dx": nc * 3 * d + ng * (d + g),
            "conv3x3_dw": nc * 3 * d + ng * g,
            "act_grad": nc * 4 * d + ng * (d + g),
            "conv3x3.library": 0}


def check_metrics(last, names, what):
    for k in names:
        check(k in last and math.isfinite(last[k]), f"{what} {k}: "
                                                    f"{last.get(k)}")


def phase_wgan_train(device, runs):
    """``python -m text_to_image_tpu_torch.main --cfg
    configs/wgancls_flowers.yml --train --steps 3 --set
    data.dataset_name=synthetic`` at the config's full widths (gf 128, df 64,
    embed 1024, B 64, n_critic 5, λ 10, α 0.5, drift 1e-3, bf16), with the
    launch counts of every kernel."""
    argv = ["--cfg", config_path("wgancls"), "--train", "--steps",
            str(TRAIN_TICKS), "--device", str(device), "--set",
            "data.dataset_name=synthetic", "train.summary_interval=1",
            *run_dirs(os.path.join(runs, "wgancls"))]
    t0 = time.perf_counter()
    trainer, launches, _ = drive(argv)
    wall = time.perf_counter() - t0
    cfg = trainer.cfg
    check((cfg.model, cfg.gan.gf_dim, cfg.gan.df_dim, cfg.gan.z_dim,
           cfg.gan.embed_dim, cfg.train.batch_size, cfg.train.n_critic,
           cfg.train.coeff.gp_lambda, cfg.train.coeff.mismatch_alpha,
           cfg.train.coeff.drift_epsilon, cfg.dtype) == (
               "wgancls", 128, 64, 100, 1024, BATCH, 5, 10.0, 0.5, 1e-3,
               "bfloat16"), f"not the full-width config: {cfg}")
    per_tick = wgan_tick_launches(cfg.train.n_critic, cfg.train.g_steps)
    log(f"  wgancls launches over {TRAIN_TICKS} ticks: {launches} "
        f"({wall:.1f} s; per tick {per_tick})")
    check(launches == {k: v * TRAIN_TICKS for k, v in per_tick.items()},
          f"unexpected launch counts {launches}")
    check(trainer.ts.step == TRAIN_TICKS, f"step {trainer.ts.step}")
    check(trainer.ts.d_state == {}, "the critic keeps state")
    last = trainer.history[-1]
    check_metrics(last, ("d_loss", "w_dist", "d_wrong", "gp", "g_loss"),
                  "wgancls")
    log("  last tick: " + ", ".join(f"{k} {last[k]:.4f}" for k in
                                    ("d_loss", "w_dist", "d_wrong", "gp",
                                     "g_loss")))
    return trainer.history, launches


@contextlib.contextmanager
def plain_critic():
    """The critic with its kernels swapped for their plain versions (plain
    torch, differentiable twice by autograd itself), whatever the tensors'
    device."""
    from text_to_image_tpu_torch.models import gancls
    from text_to_image_tpu_torch.ops import layers
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    saved = layers.conv5x5_s2_act, gancls.conditioning_join
    layers.conv5x5_s2_act = conv.conv5x5_s2_act_plain
    gancls.conditioning_join = fused.conditioning_join_plain
    try:
        yield
    finally:
        layers.conv5x5_s2_act, gancls.conditioning_join = saved


def critic_update_inputs(device, dtype):
    """The full-width WGAN-CLS bundle, its critic as leaves that require
    grad, and one critic update's inputs at batch 64: f32 real and wrong
    images, G's fakes in `dtype`, the embeddings and the GP's ε."""
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.train.steps import _leaf_params
    cfg = train_config("wgancls")
    bundle = get_model(cfg)
    gp, gs, dp, _ = bundle.init(cfg.seed, device)
    policy = L.Policy(dtype)
    gen = torch.Generator().manual_seed(SEED + 11)
    real, wrong = (torch.rand(BATCH, 64, 64, 3, generator=gen) * 2 - 1
                   for _ in range(2))
    emb = torch.randn(BATCH, cfg.gan.embed_dim, generator=gen)
    z = torch.randn(BATCH, cfg.gan.z_dim, generator=gen)
    eps = torch.rand(BATCH, 1, 1, 1, generator=gen)
    real, wrong, emb, z, eps = (v.to(device) for v in (real, wrong, emb, z,
                                                       eps))
    with torch.no_grad():
        fake = bundle.gen_apply(gp, gs, {}, z, emb, None, True, policy)[0]
    return cfg, bundle, _leaf_params(dp), policy, (real, fake, wrong, emb,
                                                   eps)


def critic_loss(cfg, bundle, params, policy, data, with_gp=True):
    """One critic update's loss (`train/steps.py` d_step): the three
    streams, the gradient penalty at x̂, the Wasserstein loss."""
    from text_to_image_tpu_torch.models import losses as LL
    real, fake, wrong, emb, eps = data
    co = cfg.train.coeff
    xs = torch.stack([policy.cast(v) for v in (real, fake, wrong)])
    logits, _ = bundle.disc_streams(params, {}, {}, xs,
                                    emb.expand(3, *emb.shape), True, policy)
    gp = torch.zeros((), device=real.device)
    if with_gp:
        gp = LL.gradient_penalty(
            lambda x: bundle.disc_apply(params, {}, {}, x, emb, True,
                                        policy)[0], real, fake, eps)
    return LL.wgan_cls_d_loss(logits[0], logits[1], logits[2], gp,
                              co.mismatch_alpha, co.gp_lambda,
                              co.drift_epsilon)


def phase_wgan_critic_grads(device):
    """One critic update's parameter gradients at full width (batch 64, the
    three streams and the gradient penalty, whose second derivative runs
    through the conv and join autograd Functions), the kernel critic
    against the plain critic on the card, f32 (TF32 off) and bf16."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg, bundle, params, policy, data = critic_update_inputs(device,
                                                                 dtype)
        leaves = list(flat(params).values())
        grads = {}
        for variant, ctx in (("kernels", contextlib.nullcontext()),
                             ("plain", plain_critic())):
            with ctx:
                ld = critic_loss(cfg, bundle, params, policy, data)
                gs = torch.autograd.grad(ld["d_loss"], leaves,
                                         allow_unused=True)
            grads[variant] = [torch.zeros_like(p) if g is None else g
                              for p, g in zip(leaves, gs)]
            grads[variant + " gp"] = float(ld["gp"].detach())
        scale = max(float(r.abs().max()) for r in grads["plain"])
        tol = CRITIC_GRAD_TOL[dtype]
        dt = str(dtype)[6:]
        by_leaf, far = {}, 0
        for name, g, r in zip(flat(params), grads["kernels"],
                              grads["plain"]):
            diff = (g.float() - r.float()).abs()
            by_leaf[name] = float(diff.max()) / scale
            far += int((diff > tol * (scale + r.float().abs())).sum())
        worst = max(by_leaf.values())
        log(f"  critic update gradients, kernels vs plain ({dt}): largest "
            f"difference of each leaf over the critic's largest gradient "
            f"element {scale:.4g} (tol {tol:g} of it + {tol:g} of the "
            f"element; {far} elements outside): "
            + ", ".join(f"{k} {v:.2e}" for k, v in by_leaf.items())
            + f"; gp {grads['kernels gp']:.6f} vs {grads['plain gp']:.6f}")
        out[dt] = {"max_diff_over_scale": worst, "scale": scale,
                   "elements_outside": far, "by_leaf": by_leaf,
                   "gp_kernels": grads["kernels gp"],
                   "gp_plain": grads["plain gp"]}
        del grads, params, data
        torch.cuda.empty_cache()
    for dt, r in out.items():
        check(r["elements_outside"] == 0,
              f"critic gradients {dt}: {r['elements_outside']} elements "
              f"apart")
    return out


def device_profile(fn, n=3):
    """(wall ms, device-busy ms, kernel launches) per call of fn, over n
    calls after one warm-up: host clock to a sync, torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if is_kernel(e)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    return wall, busy, sum(e.count for e in kernels) / n


def phase_gp_cost(device):
    """At full width, bf16, batch 64: one critic update (forward and
    backward) with and without the gradient penalty, and the penalty's inner
    gradient with the critic's weights requiring grad (the conv and join
    backwards then also form dw, which the inner gradient does not ask for)
    and detached (no dw): wall ms, device-busy ms and launches of each."""
    from text_to_image_tpu_torch.train.steps import _detached
    cfg, bundle, params, policy, data = critic_update_inputs(
        device, torch.bfloat16)
    leaves = list(flat(params).values())
    real, fake, _, emb, eps = data

    def update(with_gp):
        return lambda: torch.autograd.grad(
            critic_loss(cfg, bundle, params, policy, data, with_gp)[
                "d_loss"], leaves, allow_unused=True)

    def inner(p):
        def fn():
            x = (fake.float() + eps * (real - fake.float())).requires_grad_()
            s = bundle.disc_apply(p, {}, {}, x, emb, True, policy)[0]
            return torch.autograd.grad(s.float().sum(), x, create_graph=True)
        return fn

    r = {}
    for name, fn in (("update", update(True)),
                     ("update_without_gp", update(False)),
                     ("inner_grad", inner(params)),
                     ("inner_grad_without_dw", inner(_detached(params)))):
        wall, busy, n = device_profile(fn)
        r[name] = {"wall_ms": wall, "device_ms": busy, "launches": n}
        log(f"  {name}: wall {wall:.3f} ms, device busy {busy:.4f} ms, "
            f"{n:.0f} launches")
    r["gp_share_of_update_device"] = 1 - (
        r["update_without_gp"]["device_ms"] / r["update"]["device_ms"])
    r["unrequested_dw_device_ms"] = (r["inner_grad"]["device_ms"]
                                     - r["inner_grad_without_dw"]["device_ms"])
    log(f"  GP share of a critic update's device time "
        f"{r['gp_share_of_update_device']:.1%}; the unrequested dw "
        f"{r['unrequested_dw_device_ms']:.4f} ms of the inner gradient's "
        f"{r['inner_grad']['device_ms']:.4f} ms")
    return r


# the co32 kernel beside the C-PGGAN shapes (bf16): the 256 px call at
# batch 64, Co 96 (three 32-channel columns) and a map of 96-pixel rows,
# which its tiles do not cover (pipelined)
PGGAN_CO32_EXTRA = [((64, 128, 128, 64), 32), ((8, 128, 128, 64), 96),
                    ((2, 16, 96, 64), 32)]


def phase_pggan_upconv(device, flush):
    """upconv3x3_bias with lrelu (the C-PGGAN up-block; equalized-LR
    weights N(0, 2/(9·Cin)), inputs of unit scale as PixelNorm leaves them)
    against its plain version at the six C-PGGAN shapes, bf16 and f32, and
    at PGGAN_CO32_EXTRA in bf16, the path read back from the C entry point
    and held against the expected one; bf16 timed beside the plain version
    and F.interpolate + cuDNN (the extra shapes that take co32)."""
    import torch.nn.functional as F

    from text_to_image_tpu_torch.ops.kernels import conv
    gen = torch.Generator().manual_seed(SEED + 13)
    errs, rows = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        extra = PGGAN_CO32_EXTRA if dtype == torch.bfloat16 else []
        for shape, co in PGGAN_UPCONV_SHAPES + extra:
            b, h, wd, cin = shape
            x = torch.randn(shape, generator=gen).to(dtype).to(device)
            w = (torch.randn(3, 3, cin, co, generator=gen)
                 * math.sqrt(2.0 / (9 * cin))).to(dtype).to(device)
            t = (0.1 * torch.randn(co, generator=gen)).to(device)
            got = conv.upconv3x3_bias(x, w, t, "lrelu")
            torch.cuda.synchronize()
            path = conv.upconv_path_on_card(x, conv.combined_weights(w), got)
            want = expected_upconv_path(cin, co, dtype, wd)
            check(path == conv.upconv_path(wd, cin, co, dtype) == want,
                  f"upconv {dt} {shape}->{co}: path {path}, expected {want}")
            if path == "co32":
                again = conv.upconv3x3_bias(x, w, t, "lrelu")
                check(torch.equal(got, again),
                      f"upconv {dt} {shape}->{co}: two co32 runs differ")
                del again
            ref = upconv_bias_plain(x, w, t, "lrelu")
            errs[(dtype, (shape, co))] = compare(
                got, ref, *TOL[dtype],
                f"upconv3x3_bias {dt} {shape}->{co} lrelu [{path}]")
            if dtype == torch.bfloat16 and ((shape, co) not in extra
                                            or path == "co32"):
                x_cl = x.permute(0, 3, 1, 2)
                w_t = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                t16 = t.to(dtype)

                def lib():
                    return F.leaky_relu(F.conv2d(
                        F.interpolate(x_cl, scale_factor=2, mode="nearest"),
                        w_t, t16, padding=1), 0.2)
                flops = 2 * b * up_taps(h) * up_taps(wd) * cin * co
                nb = nbytes(x, w, t, got)
                bms, by = bound(nb, flops, dtype)
                r = {"shape": [list(shape), co, "lrelu"], "path": path,
                     "main_path": (shape, co) in PGGAN_UPCONV_SHAPES,
                     "ms": time_ms(lambda: conv.upconv3x3_bias(x, w, t,
                                                               "lrelu"),
                                   flush),
                     "plain_ms": time_ms(lambda: upconv_bias_plain(
                         x, w, t, "lrelu"), flush, 5),
                     "library_ms": time_ms(lib, flush),
                     "bound_ms": bms, "bound_by": by}
                rows.append(r)
                log(f"  upconv3x3_bias {shape}->{co} lrelu [{path}]: "
                    f"{r['ms']:.4f} ms (bound {bms:.4f} by {by}, "
                    f"{flops / r['ms'] / 1e9:.1f} TFLOP/s), plain "
                    f"{r['plain_ms']:.4f}, interpolate+cuDNN+lrelu "
                    f"{r['library_ms']:.4f}")
            del x, w, got, ref
        torch.cuda.empty_cache()
    return errs, rows


@contextlib.contextmanager
def alpha_spy(seen):
    """Records (stage, α, under inference mode) of every C-PGGAN generator
    forward: ticks run with gradient, grids under inference mode."""
    from text_to_image_tpu_torch.models import pggan
    real = pggan.generator_apply

    def spy(params, z, emb, eps, stage, alpha, gan, policy):
        seen.append((stage, float(torch.as_tensor(alpha)),
                     torch.is_inference_mode_enabled()))
        return real(params, z, emb, eps, stage, alpha, gan, policy)

    pggan.generator_apply = spy
    try:
        yield
    finally:
        pggan.generator_apply = real


def phase_pggan_progression(device, runs):
    """``python -m text_to_image_tpu_torch.main --cfg
    configs/pggan_flowers.yml --train --steps 10 --set
    data.dataset_name=synthetic train.sample_interval=2`` at full width
    (gf 128, compressed 128, ca 128, B 64, n_critic 2, bf16): all 5 stages
    (4 → 64 px), 2 ticks each; every stage after the first restores the
    checkpoint of the one before, α ramps 0 → 1 over each stage's fade
    (1 tick: fade_fraction 0.5 of 2), each stage's grid is drawn at α = 1
    and its own resolution, launches per stage as `pggan_launches`."""
    n = 5
    steps = n * PGGAN_TICKS_PER_STAGE
    root = os.path.join(runs, "pggan")
    argv = ["--cfg", config_path("pggan"), "--train", "--steps", str(steps),
            "--device", str(device), "--set", "data.dataset_name=synthetic",
            "train.summary_interval=1",
            f"train.sample_interval={PGGAN_TICKS_PER_STAGE}",
            *run_dirs(root)]
    seen = []
    t0 = time.perf_counter()
    with alpha_spy(seen):
        trainers, launches, printed = drive(argv)
    wall = time.perf_counter() - t0
    cfg = trainers[-1].cfg
    check((cfg.gan.gf_dim, cfg.gan.compressed_embed_dim, cfg.gan.ca_dim,
           cfg.gan.z_dim, cfg.gan.embed_dim, cfg.train.batch_size,
           cfg.train.n_critic, cfg.data.image_size, cfg.dtype) == (
               128, 128, 128, 100, 1024, BATCH, 2, 64, "bfloat16"),
          f"not the full-width config: {cfg}")
    check([t.cfg.pggan.stage for t in trainers] == list(range(1, n + 1)),
          f"stages {[t.cfg.pggan.stage for t in trainers]}")
    want = {k.__name__: 0 for k in all_counters()}
    for s in range(1, n + 1):
        for k, v in pggan_launches(s, PGGAN_TICKS_PER_STAGE, 1, cfg).items():
            want[k] += v
    log(f"  pggan progression launches: {launches} ({wall:.1f} s)")
    check(launches == want, f"launches {launches}, expected {want}")
    per = PGGAN_TICKS_PER_STAGE
    stages = {}
    for t in trainers:
        s = t.cfg.pggan.stage
        check(t.ts.step == s * per, f"stage {s} ended at step {t.ts.step}")
        if s > 1:
            check(f"restored checkpoint at step {(s - 1) * per}" in printed,
                  f"stage {s} did not restore step {(s - 1) * per}")
        check_metrics(t.history[-1], ("d_loss", "w_dist", "d_wrong", "gp",
                                      "g_loss", "kl"), f"stage {s}")
        ticks = [a for st, a, grid in seen if st == s and not grid]
        grids = [a for st, a, grid in seen if st == s and grid]
        # per tick n_critic + g_steps forwards; α 0 in the first tick of a
        # stage that fades, 1 from the fade's end on
        f = cfg.train.n_critic + cfg.train.g_steps
        expect = ([1.0] * (per * f) if s == 1
                  else [0.0] * f + [1.0] * ((per - 1) * f))
        check(ticks == expect, f"stage {s}: α {ticks}, expected {expect}")
        check(grids == [1.0], f"stage {s}: grid α {grids}")
        res = 4 * 2 ** (s - 1)
        png = os.path.join(root, "sample", "pggan", "synthetic",
                           f"train_{s * per:08d}.png")
        check(png_size(png) == (8 * res, 8 * res),
              f"stage {s} grid {png}: {png_size(png)}")
        stages[s] = {"history": t.history, "alphas": ticks,
                     "grid": os.path.basename(png)}
        log(f"  stage {s} ({res} px): steps {(s - 1) * per}→{s * per}, α "
            f"{ticks[::f]}, grid {8 * res}×{8 * res}, last d_loss "
            f"{t.history[-1]['d_loss']:.4f} gp {t.history[-1]['gp']:.4f}")
    return {"stages": stages, "wall_s": wall}, launches


@contextlib.contextmanager
def upconv_path_spy(seen):
    """Records the path the C entry point reports for every upconv3x3
    forward on the card, as a row {"shape", "dtype", "path"}; the combined
    weights it passes come from the combine kernel, which no launch count
    counts."""
    from text_to_image_tpu_torch.ops.kernels import conv
    real = conv._upconv_forward

    def spy(x, w, scale, shift, act, plan=None):
        y = real(x, w, scale, shift, act, plan)
        seen.append({"shape": [list(x.shape), w.shape[-1], act],
                     "dtype": str(x.dtype)[6:],
                     "path": conv.upconv_path_on_card(
                         x, conv.combined_weights(w), y)})
        return y

    conv._upconv_forward = spy
    try:
        yield
    finally:
        conv._upconv_forward = real


def phase_pggan_256(device, runs):
    """One stage-7 tick of configs/pggan_flowers_256.yml (256 px, B 32,
    bf16) through ``main.py --train``: the 128²×64→32 up-block call runs
    on the training path with lrelu, on the co32 kernel (its path read
    back from the C entry point inside the tick); the 3×3 family's
    launches in the tick (its counters read just before and just after)
    are `pggan_conv3x3_launches`' and ``conv3x3.library`` counts none.
    Returns (the last metrics and the up-block calls' paths, the tick's
    launches: all_counters' and the 3×3 family's)."""
    argv = ["--cfg", os.path.join(ROOT, "configs", "pggan_flowers_256.yml"),
            "--train", "--steps", "1", "--device", str(device), "--set",
            "data.dataset_name=synthetic", "train.summary_interval=1",
            "pggan.stage=7", *run_dirs(os.path.join(runs, "pggan256"))]
    from text_to_image_tpu_torch.utils import profiling
    seen = []
    t0 = time.perf_counter()
    before = profiling.counters()
    with upconv_path_spy(seen):
        trainer, launches, _ = drive(argv)
    after = profiling.counters()
    wall = time.perf_counter() - t0
    cfg = trainer.cfg
    check((cfg.data.image_size, cfg.train.batch_size, cfg.pggan.stage,
           cfg.dtype) == (256, 32, 7, "bfloat16"), f"config {cfg}")
    # the 3×3 family's launches and library fallbacks in this tick
    k3_want = pggan_conv3x3_launches(7, cfg)
    k3 = {k: after.get(k, 0) - before.get(k, 0) for k in k3_want}
    log(f"  pggan 256 px stage-7 tick: the 3×3 family {k3} (expected "
        f"{k3_want})")
    check(k3 == k3_want, f"3×3 launches {k3}, expected {k3_want}")
    want = pggan_launches(7, 1, 0, cfg)
    last_call = [r for r in seen if r["shape"] == [[32, 128, 128, 64], 32,
                                                   "lrelu"]]
    log(f"  pggan 256 px stage-7 tick: launches {launches} ({wall:.1f} s); "
        f"the 128²×64→32 call's paths (read back from C) "
        f"{sorted({r['path'] for r in last_call})}, "
        f"{len(last_call)} calls")
    check(launches == want, f"launches {launches}, expected {want}")
    check(len(seen) == want["upconv3x3"], f"upconv calls seen {len(seen)}")
    check(last_call and all(r["path"] == "co32" for r in last_call),
          f"the 128²×64→32 call's paths {last_call}")
    last = trainer.history[-1]
    check_metrics(last, ("d_loss", "w_dist", "d_wrong", "gp", "g_loss",
                         "kl"), "pggan 256")
    return {**last, "upconv_paths": seen}, {**launches, **k3}


# --- phase 10: Inception-score eval ---------------------------------------------

IS_IMAGES = 3000              # main.py's default --is-images
IS_IMAGES_STAGE2 = 640
IS_CPU_IMAGES = 128
IV3_LOGIT_TOL = 1e-4          # card vs CPU, of the largest |logit|, f32
IS_CPU_TOL = 1e-3             # card vs CPU, relative IS, f32
# evaluate_iv3's finetune: its 600 steps, or as many as fit in this many
# seconds (which keeps phase 10 near 60 s; the script's phase 15 needs the
# time)
IV3_FINETUNE_BUDGET_S = 15.0
IV3_FC_SCALE = 200.0


def card_name():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


class EvalTimer:
    """Around `main.main` runs: the seconds of the eval classifier's
    finetune and of the IS loop (``eval.classifier.train_classifier`` and
    ``eval.inception.compute_inception_score``, which ``main.py`` imports
    when it runs), each ended by a synchronise."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def recording(self):
        from text_to_image_tpu_torch.eval import classifier, inception
        targets = {"finetune": (classifier, "train_classifier"),
                   "score": (inception, "compute_inception_score")}
        saved = {k: getattr(m, n) for k, (m, n) in targets.items()}

        def timed(key):
            def fn(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = saved[key](*args, **kw)
                torch.cuda.synchronize()
                self.seconds[key] = time.perf_counter() - t0
                return out
            return fn

        for key, (mod, name) in targets.items():
            setattr(mod, name, timed(key))
        try:
            yield self
        finally:
            for key, (mod, name) in targets.items():
                setattr(mod, name, saved[key])


@contextlib.contextmanager
def tf32(allowed: bool):
    cudnn, cublas = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, cublas.allow_tf32
    cudnn.allow_tf32 = cublas.allow_tf32 = allowed
    try:
        yield
    finally:
        cudnn.allow_tf32, cublas.allow_tf32 = saved


def finetune_step_ms(images, class_ids, classes, **kw):
    """ms a `train_classifier` step (batch 64 from the host, forward,
    backward, Adam): the difference of a 25- and a 5-step run over 20."""
    from text_to_image_tpu_torch.eval.classifier import train_classifier
    took = []
    for steps in (5, 25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_classifier(images, class_ids, classes, steps=steps, **kw)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
    return (took[1] - took[0]) / 20 * 1e3


def served_generator(cfg, device):
    """The generator that ``main.py`` samples without a checkpoint: from
    ``cfg.seed``, weights cast to the compute dtype (Stage-II with its
    frozen Stage-I from the seed)."""
    from text_to_image_tpu_torch.eval import sampler
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.train.steps import stage1_aux
    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)
    params, state = bundle.init(cfg.seed, device)[:2]
    aux = stage1_aux(cfg, cfg.seed, device) if bundle.needs_stage1 else {}
    ts = sampler.GeneratorState(
        L.cast_weights(params, policy), state,
        {k: L.cast_weights(v, policy) if k.endswith("params") else v
         for k, v in aux.items()})
    return sampler.make_generator_fn(cfg, device=device), ts


def phase_eval_is(device, runs, card):
    """``main.py --eval-is`` at full width on the card: (a) GAN-CLS from
    phase 6c's Oxford-102-sized split, the SimpleCNN finetuned for 300 steps
    on its 7,034 train images; (b) the same with ``<data_dir>/inception.npz``
    (a 102-class InceptionV3 from the seed, written by the port in the
    converter's layout); (c) Stage-II at 256 px over a frozen Stage-I from the
    seed, with that ``.npz``; each with its launch counts.  Then (d) the
    InceptionV3 and the IS on the card against the CPU (f32), (e) the IS of
    (b)'s images and the InceptionV3's time with TF32 allowed and off, the
    generator, SimpleCNN and InceptionV3 times, and (f) the synthetic-quality
    protocol."""
    from text_to_image_tpu_torch import convert
    from text_to_image_tpu_torch.config import load_config
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.eval import inception_v3 as iv3
    from text_to_image_tpu_torch.eval import synthetic_quality as quality
    from text_to_image_tpu_torch.eval.classifier import make_classifier_fn
    from text_to_image_tpu_torch.eval.inception import (
        compute_inception_score, simple_classifier_apply,
        simple_classifier_init)
    from text_to_image_tpu_torch.models.registry import tree_to
    from text_to_image_tpu_torch.utils import profiling

    report = {"launches": {}, "card": card}
    data_dir = os.path.join(runs, "flowers")          # phase 6c's split
    check(os.path.isdir(os.path.join(data_dir, "train")),
          f"no split under {data_dir}")
    npz = os.path.join(data_dir, "inception.npz")
    check(not os.path.exists(npz), f"{npz} exists before (a)")

    def eval_is(tag, model, images, *sets):
        timer = EvalTimer()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (_, (mean, std)), launches, said = drive(
            ["--cfg", config_path(model), "--eval-is", "--is-images",
             str(images), "--device", str(device), "--set",
             f"data.data_dir={data_dir}", *sets,
             *run_dirs(os.path.join(runs, f"is_{tag}"))], timer)
        wall = time.perf_counter() - t0
        check(math.isfinite(mean) and 1.0 <= mean <= FLOWERS_CLASSES + 1
              and math.isfinite(std), f"({tag}) IS {mean} ± {std}")
        per = (GRID_LAUNCHES if model == "gancls"
               else STACKGAN_FORWARD_LAUNCHES[model])
        forwards = 3 + -(-images // BATCH)          # the grids, the IS
        want = {k.__name__: forwards * per.get(k.__name__, 0)
                for k in all_counters()}
        check(launches == want, f"({tag}) launches {launches}, want {want}")
        rec = {"is_mean": mean, "is_std": std, "images": images,
               "launches": launches, "generator_forwards": forwards,
               "wall_s": wall, "finetune_s": timer.seconds.get("finetune"),
               "score_s": timer.seconds["score"],
               "is_images_per_s": images / timer.seconds["score"],
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        report[tag] = rec
        report["launches"][f"eval-is {tag}"] = launches
        log(f"  ({tag}) IS {mean:.4f} ± {std:.4f} over {images} images; "
            f"IS loop {rec['score_s']:.2f} s = {rec['is_images_per_s']:.1f} "
            f"images/s end to end"
            + (f", finetune {rec['finetune_s']:.2f} s"
               if rec["finetune_s"] else "")
            + f", whole call {wall:.2f} s, peak {rec['peak_memory_gib']:.2f} "
            f"GiB [{card}]; launches {launches} ({forwards} generator "
            f"forwards)")
        return said

    flowers = "data.dataset_name=flowers"
    said = eval_is("a gancls simplecnn", "gancls", IS_IMAGES, flowers)
    # class_info is 1-based (StackGAN's pickles), so max + 1 = 103 classes,
    # the first never drawn, as in the root main.py
    check(f"finetuning eval classifier ({FLOWERS_CLASSES + 1} classes)" in said
          and "classifier train accuracy" in said, "(a) no SimpleCNN finetune")
    # the fc scaled up so that the posteriors are far from uniform, as a
    # finetuned classifier's are (at its init std 0.01 every IS is ~1)
    iv3_cpu = iv3.init(SEED, FLOWERS_CLASSES)
    iv3_cpu["fc"]["w"] *= IV3_FC_SCALE
    convert.save_classifier_npz(npz, iv3_cpu)
    said = eval_is("b gancls inceptionv3", "gancls", IS_IMAGES, flowers)
    check(f"using converted classifier checkpoint {npz}" in said,
          "(b) the converted InceptionV3 was not used")
    said = eval_is("c stackgan_stage2 inceptionv3", "stackgan_stage2",
                   IS_IMAGES_STAGE2, "data.dataset_name=synthetic",
                   "stage1_checkpoint=")
    check("using converted classifier checkpoint" in said,
          "(c) the converted InceptionV3 was not used")

    # (d) the card against the CPU, f32 (TF32 is off in this script)
    iv3_dev = tree_to(iv3_cpu, device)
    g = torch.Generator().manual_seed(SEED + 7)
    x = torch.rand(8, 64, 64, 3, generator=g) * 2 - 1
    with torch.inference_mode():
        dev = iv3.apply(iv3_dev, x.to(device)).cpu()
        ref = iv3.apply(iv3_cpu, x)
    rel = float((dev - ref).abs().max() / ref.abs().max())
    log(f"  (d) InceptionV3 logits, batch 8, f32, TF32 off, card vs CPU: "
        f"max|err| {rel:.3e} of max|logit| {float(ref.abs().max()):.4f} "
        f"(tol {IV3_LOGIT_TOL:g})")
    check(rel <= IV3_LOGIT_TOL, f"InceptionV3 card vs CPU {rel:.3e}")
    cfg32 = train_config("gancls", dtype="float32")
    emb = get_dataset(cfg32, split="test").test_embeddings()
    scores, probs = {}, {}
    for dev_name, clf_params in ((device, iv3_dev), ("cpu", iv3_cpu)):
        gen, ts = served_generator(cfg32, dev_name)
        clf = iv3.make_classifier(clf_params)
        probs[str(dev_name)] = []

        def scored(x, clf=clf, got=probs[str(dev_name)]):
            logits = clf(x)
            got.append(logits.softmax(-1).cpu())
            return logits
        scores[str(dev_name)] = compute_inception_score(
            lambda z, e, eps: gen(ts.g_params, ts.g_state, ts.aux, z, e, eps),
            scored, emb, num_images=IS_CPU_IMAGES, batch_size=BATCH,
            z_dim=cfg32.gan.z_dim, seed=SEED)
    (dm, ds_), (cm, cs_) = scores[str(device)], scores["cpu"]
    is_rel = abs(dm - cm) / cm
    prob_err = float((torch.cat(probs[str(device)])
                      - torch.cat(probs["cpu"])).abs().max())
    log(f"  (d) IS of {IS_CPU_IMAGES} images, GAN-CLS f32 from the seed, "
        f"InceptionV3: card {dm:.6f} ± {ds_:.6f}, CPU {cm:.6f} ± {cs_:.6f}, "
        f"relative {is_rel:.3e} (tol {IS_CPU_TOL:g}); class posteriors "
        f"max|err| {prob_err:.3e}")
    check(is_rel <= IS_CPU_TOL, f"IS card vs CPU {is_rel:.3e}")
    report["card_vs_cpu"] = {"iv3_logits_rel_err": rel, "is_card": [dm, ds_],
                             "is_cpu": [cm, cs_], "is_rel_err": is_rel,
                             "posterior_max_abs_err": prob_err}
    del gen, ts
    torch.cuda.empty_cache()

    # (e) TF32, and the times of the eval path's parts
    flush = L2Flush(device)
    cfg = load_config(config_path("gancls"), {"data.dataset_name": "flowers",
                                              "data.data_dir": data_dir})
    gen, ts = served_generator(cfg, device)
    emb = get_dataset(cfg, split="test").test_embeddings()
    iv3_npz = iv3.load_npz(npz, device)
    tf32_is, iv3_ms = {}, {}
    imgs = gen(ts.g_params, ts.g_state, ts.aux,
               torch.randn(BATCH, cfg.gan.z_dim, generator=g), emb[:BATCH])
    for allowed in (False, True):
        def clf(images, allowed=allowed):
            with torch.inference_mode(), tf32(allowed):
                return iv3.apply(iv3_npz, images)
        key = "tf32" if allowed else "f32"
        tf32_is[key] = compute_inception_score(
            lambda z, e, eps: gen(ts.g_params, ts.g_state, ts.aux, z, e, eps),
            clf, emb, num_images=IS_IMAGES, batch_size=min(BATCH, IS_IMAGES),
            z_dim=cfg.gan.z_dim, seed=cfg.seed)
        iv3_ms[key] = time_ms(lambda: clf(imgs), flush, iters=10)
    b_mean = report["b gancls inceptionv3"]["is_mean"]
    log(f"  (e) IS of (b)'s {IS_IMAGES} images: TF32 off {tf32_is['f32'][0]:.6f}"
        f" ± {tf32_is['f32'][1]:.6f} ((b) via main.py {b_mean:.6f}), TF32 "
        f"allowed {tf32_is['tf32'][0]:.6f} ± {tf32_is['tf32'][1]:.6f}; "
        f"InceptionV3 forward, batch 64 from 64 px: {iv3_ms['f32']:.3f} ms "
        f"TF32 off, {iv3_ms['tf32']:.3f} ms allowed [{card}]")
    gcfg = load_config(config_path("stackgan_stage2"),
                       {"data.dataset_name": "synthetic",
                        "stage1_checkpoint": ""})
    s2gen, s2ts = served_generator(gcfg, device)
    s2emb = get_dataset(gcfg, split="test").test_embeddings(BATCH)
    # inputs on the card: a host tensor's copy would wait for the spin
    z = torch.randn(BATCH, cfg.gan.z_dim, generator=g).to(device)
    eps = torch.randn(*s2gen.eps_shape(BATCH), generator=g).to(device)
    emb_d, s2emb = (torch.as_tensor(e[:BATCH]).to(device) for e in (emb, s2emb))
    times = {
        "generator gancls (bf16, train-mode BN)": time_ms(
            lambda: gen(ts.g_params, ts.g_state, ts.aux, z, emb_d),
            flush, iters=10, spin=4 * HOST_SPIN),
        "generator stackgan_stage2 (bf16, frozen Stage-I)": time_ms(
            lambda: s2gen(s2ts.g_params, s2ts.g_state, s2ts.aux, z, s2emb,
                          eps), flush, iters=10, spin=4 * HOST_SPIN),
        "inceptionv3 forward, TF32 off": iv3_ms["f32"],
        "inceptionv3 forward, TF32 allowed": iv3_ms["tf32"]}
    del s2gen, s2ts
    simple = tree_to(simple_classifier_init(SEED, FLOWERS_CLASSES), device)
    simple_fn = make_classifier_fn(simple, simple_classifier_apply)
    times["simplecnn forward"] = time_ms(lambda: simple_fn(imgs), flush,
                                         iters=10, spin=4 * HOST_SPIN)
    train = get_dataset(cfg, split="train")
    classes = int(train.class_ids.max()) + 1
    times["simplecnn finetune step (76 px)"] = finetune_step_ms(
        train.images, train.class_ids, classes, device=device)
    times["inceptionv3 finetune step (76 px)"] = iv3_step = finetune_step_ms(
        train.images, train.class_ids, classes, lr=3e-4,
        init_fn=lambda k: iv3.init(k, classes), apply_fn=iv3.apply,
        device=device)
    for name, ms in times.items():
        log(f"  (e) {name}: {ms:.3f} ms per batch of {BATCH} [{card}]")
    report["tf32"] = {"is": tf32_is, "is_b_main": b_mean}
    report["times_ms"] = times

    # one IS batch of (b) (generator, InceptionV3 with TF32 off, posteriors
    # to the host) under utils/profiling.trace: its device time by kernel
    trace_dir = os.path.join(runs, "trace")
    clf = iv3.make_classifier(iv3_npz)
    with profiling.trace(trace_dir) as prof:
        clf(gen(ts.g_params, ts.g_state, ts.aux, z, emb_d)).softmax(-1).cpu()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:100])
                      for e in prof.key_averages() if is_kernel(e)),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    check(busy > 0 and len(os.listdir(trace_dir)) == 1,
          "profiling.trace saw no device time or wrote no trace")
    log(f"  (e) one IS batch of (b) under profiling.trace: device busy "
        f"{busy:.3f} ms in {sum(k[1] for k in kernels)} launches; top: "
        + "; ".join(f"{ms:.3f} ms ×{n} {name[:60]}"
                    for ms, n, name in kernels[:5]) + f" [{card}]")
    report["is_batch_profile"] = {"device_busy_ms": busy,
                                  "top_kernels_ms_calls_name": kernels[:25]}
    del gen, ts, imgs, iv3_npz, simple, clf, prof
    torch.cuda.empty_cache()

    # (f) the synthetic-quality protocol at 64 px, at its defaults
    fcfg = flagship_config()
    ds = get_dataset(fcfg)
    gen, ts = served_generator(fcfg, device)
    t0 = time.perf_counter()
    got = quality.evaluate(gen, ts, fcfg, ds, device=device)
    secs = time.perf_counter() - t0
    check(set(got) == {"r", "clf_acc", "cond_acc", "is_mean", "is_std"}
          and -1 <= got["r"] <= 1 and 1 <= got["is_mean"] <= 8
          and 0 <= got["cond_acc"] <= 1, f"(f) evaluate {got}")
    steps = min(600, int(IV3_FINETUNE_BUDGET_S * 1e3 / iv3_step))
    if steps < 600:
        log(f"  (f) evaluate_iv3: {steps} finetune steps, not 600: at "
            f"{iv3_step:.1f} ms a step 600 would take "
            f"{600 * iv3_step / 1e3:.0f} s of this script's budget")
    t0 = time.perf_counter()
    got_iv3 = quality.evaluate_iv3(gen, ts, fcfg, ds, clf_steps=steps,
                                   device=device)
    secs_iv3 = time.perf_counter() - t0
    check(set(got_iv3) == {"iv3_clf_acc", "iv3_cond_acc", "iv3_is_mean",
                           "iv3_is_std"} and 1 <= got_iv3["iv3_is_mean"] <= 8,
          f"(f) evaluate_iv3 {got_iv3}")
    log(f"  (f) synthetic protocol, GAN-CLS from the seed at 64 px: "
        f"evaluate {got} in {secs:.1f} s; evaluate_iv3 ({steps} steps) "
        f"{got_iv3} in {secs_iv3:.1f} s [{card}]")
    report["synthetic_quality"] = {"evaluate": got, "evaluate_s": secs,
                                   "evaluate_iv3": got_iv3,
                                   "evaluate_iv3_s": secs_iv3,
                                   "iv3_steps": steps}
    return report


# --- phase 11: data parallelism on the card ---------------------------------

DP_RANKS = 2
DP_BN_SPLITS = (1, 2, 4)
# the GAN-CLS tick's train-mode BN calls (input at batch 64, streams, act):
# the generator's four and the discriminator's over three streams and one
DP_BN_CALLS = ([(s, 1, "relu") for s in BN_SHAPES]
               + [((k * BATCH, *s[1:]), k, "lrelu") for k in (3, 1)
                  for s in D_BN_SHAPES])
# D pieces merged against one bn_stats over the whole batch: f32 sums over
# other partitions of up to 65536 rows a stream
DP_STATS_TOL = (1e-5, 1e-5)
# D ranks on a global batch against one process on it: the JAX package's
# data-parallel tolerances (tests/test_parallel.py): metrics rtol / atol,
# params within a few Adam steps
DP_METRIC_TOL = (5e-3, 1e-4)
DP_PARAM_LRS = 10
# all-reduced gradients against one process's, both from the same params
# (f32, TF32 off), as ‖Δ‖ / (‖g_leaf‖ + max ‖g‖ of the net): another
# reduction order reads up to 3.4e-4 (GAN-CLS) and 2.3e-3 (C-PGGAN's second
# critic update: the GP's second derivative through the stddev's square
# root) on an H100; a missing ÷ D reads 0.5 on the largest leaf, a leaf
# of norm f·max ‖g‖ counted twice f / (1 + f)
DP_GRAD_RTOL = 1e-2
DP_AT_REST = {"train.generator_lr": 0.0, "train.discriminator_lr": 0.0}
DP_TIMEOUT_S = 240
# per rank and tick of the data-parallel GAN-CLS tick: TICK_LAUNCHES with
# each BN forward's bn_stats replaced by bn_partials and bn_finish around
# the all-gather (3 launches forward, 2 backward a BN call)
DP_TICK_LAUNCHES = {**TICK_LAUNCHES, "bn_stats": 0,
                    "bn_partials": TICK_LAUNCHES["bn_stats"],
                    "bn_finish": TICK_LAUNCHES["bn_stats"], **NO_UPCONV}
DP_NCCL_TICKS = 8


def dp_pieces(x, streams, d):
    """Rank r's piece of x ([S·R, …]): rows r·R/d … (r + 1)·R/d of every
    stream, contiguous."""
    xs = x.reshape(streams, -1, *x.shape[1:])
    n = xs.shape[1] // d
    return [xs[:, r * n:(r + 1) * n].reshape(-1, *x.shape[1:]).contiguous()
            for r in range(d)]


def dp_whole(pieces, streams):
    return torch.cat([p.reshape(streams, -1, *p.shape[1:]) for p in pieces],
                     1).reshape(-1, *pieces[0].shape[1:])


def phase_dp_bn_kernels(device, flush):
    """(a) bn_partials and bn_finish at every BN call of the GAN-CLS tick,
    its batch cut into D = 1, 2, 4 pieces in one process (bf16 and f32):
    each against its plain version, bit-identical over two runs, the merged
    statistics against one bn_stats over the whole batch (bit for bit at
    D = 1), and the synced backward (bn_bwd_reduce of each piece, the sums
    added as the all-reduce adds them, bn_bwd_apply over the global row
    count) against torch.autograd through the plain versions (f32, TF32
    off; without the relu / lrelu kink, as phase_bn_backward).  Then both
    kernels timed at a rank's half of each call (D = 2, bf16) beside their
    plain versions, their bound and PyTorch's SyncBatchNorm kernels for the
    same step (`batch_norm_stats`, `batch_norm_gather_stats_with_counts`;
    one stream only)."""
    from text_to_image_tpu_torch.ops.kernels import fused
    gen = torch.Generator().manual_seed(SEED + 40)
    errs = {"bn_partials": {}, "bn_finish": {}, "synced_backward": {}}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for shape, s, act in DP_BN_CALLS:
            x, gamma, beta, rm, rv = bn_train_inputs(shape, dtype, device, gen)
            state = (gamma, beta, rm, rv)
            whole = fused.bn_stats(x, s, *state)
            for d in DP_BN_SPLITS:
                what = f"{dt} {shape} S={s} D={d}"
                key = (dtype, (*shape, s, d))
                pieces = dp_pieces(x, s, d)
                parts = [fused.bn_partials(p, s) for p in pieces]
                again = [fused.bn_partials(p, s) for p in pieces]
                torch.cuda.synchronize()
                check(all(torch.equal(u, v) for u, v in zip(parts, again)),
                      f"bn_partials {what}: outputs differ between two runs")
                errs["bn_partials"][key] = compare_all(
                    [(f"rank {r}", p, fused.bn_partials_plain(q, s))
                     for r, (p, q) in enumerate(zip(parts, pieces))],
                    *STATS_TOL, f"bn_partials {what}")
                stacked = torch.stack(parts)
                out = fused.bn_finish(stacked, *state)
                again = fused.bn_finish(stacked, *state)
                torch.cuda.synchronize()
                check(all(torch.equal(u, v) for u, v in zip(out, again)),
                      f"bn_finish {what}: outputs differ between two runs")
                names = ("mean", "rstd", "a", "b", "new mean", "new var")
                errs["bn_finish"][key] = compare_all(
                    zip(names, out, fused.bn_finish_plain(stacked, *state)),
                    *STATS_TOL, f"bn_finish {what}")
                if d == 1:
                    check(all(torch.equal(u, v) for u, v in zip(out, whole)),
                          f"bn_finish {what}: not bn_stats' bits")
                else:
                    compare_all(zip(names, out, whole), *DP_STATS_TOL,
                                f"merged vs one bn_stats {what}")
                if dtype == torch.float32:     # without the kink: smooth
                    errs["synced_backward"][key] = dp_synced_backward(
                        x, pieces, out, state, s, smooth(act), d, gen, what)
            del x, whole
        torch.cuda.empty_cache()

    # timing: a rank's half of each call, bf16
    rows = []
    dtype = torch.bfloat16
    for shape, s, act in DP_BN_CALLS:
        x, gamma, beta, rm, rv = bn_train_inputs(shape, dtype, device, gen)
        half = dp_pieces(x, s, DP_RANKS)[0]
        c = shape[-1]
        parts = fused.bn_partials(half, s)
        stacked = torch.stack([parts, fused.bn_partials(
            dp_pieces(x, s, DP_RANKS)[1], s)])
        out = fused.bn_finish(stacked, gamma, beta, rm, rv)
        per_c = nbytes(gamma, beta, rm, rv)
        r = {"shape": list(half.shape), "streams": s, "act": act,
             "ranks": DP_RANKS}
        lib_p = lib_f = None
        if s == 1:        # SyncBatchNorm's two steps, one stream a call
            xv = half.permute(0, 3, 1, 2)
            m, i = torch.batch_norm_stats(xv, 1e-5)
            means, invs = m.repeat(DP_RANKS, 1), i.repeat(DP_RANKS, 1)
            counts = torch.full((DP_RANKS,), float(half.numel() // c),
                                device=device)
            rm2, rv2 = rm.clone(), rv.clone()

            def lib_p():
                return torch.batch_norm_stats(xv, 1e-5)

            def lib_f():
                return torch.batch_norm_gather_stats_with_counts(
                    xv, means, invs, rm2, rv2, 0.1, 1e-5, counts)
        for name, fn, plain, lib, nb in (
                ("bn_partials", lambda: fused.bn_partials(half, s),
                 lambda: fused.bn_partials_plain(half, s), lib_p,
                 nbytes(half, parts)),
                ("bn_finish", lambda: fused.bn_finish(stacked, gamma, beta,
                                                      rm, rv),
                 lambda: fused.bn_finish_plain(stacked, gamma, beta, rm, rv),
                 lib_f, nbytes(stacked, *out) + per_c)):
            bms, by = bound(nb, 0, torch.float32)
            ms = time_ms(fn, flush, spin=HOST_SPIN)
            r[name] = {"ms": ms, "plain_ms": time_ms(plain, flush, 5),
                       "library_ms": (None if lib is None else
                                      time_ms(lib, flush, spin=HOST_SPIN)),
                       "bound_ms": bms, "bound_by": by}
        rows.append(r)
        log(f"  rank's half {tuple(half.shape)} S={s}: " + ", ".join(
            f"{k} {r[k]['ms']:.4f} ms (bound {r[k]['bound_ms']:.5f}, plain "
            f"{r[k]['plain_ms']:.4f}, torch {r[k]['library_ms']})"
            for k in ("bn_partials", "bn_finish")))
        del x, half
    torch.cuda.empty_cache()
    return ({k: {f"{str(dt)[6:]} {list(sh)}": v for (dt, sh), v in d.items()}
             for k, d in errs.items()}, rows)


def dp_synced_backward(x, pieces, stats, state, s, act, d, gen, what):
    """The D ranks' backward of one BN call (each piece's bn_bwd_reduce, the
    sums added in rank order as the all-reduce adds them, bn_bwd_apply over
    the global rows of a stream) against torch.autograd through the plain
    versions on the whole batch, f32."""
    from text_to_image_tpu_torch.ops.kernels import fused
    gamma, beta, rm, rv = state
    mean, rstd, a, b = stats[:4]
    g = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
    ys = [fused._bn_act_forward(p, a, b, act) for p in pieces]
    gs = dp_pieces(g, s, d)
    sums = [fused.bn_bwd_reduce(gp, yp, xp, mean, rstd, s, act)
            for gp, yp, xp in zip(gs, ys, pieces)]
    sga, sgx, dgamma, dbeta = (sum(t[i] for t in sums) for i in range(4))
    count = x.numel() // x.shape[-1] // s
    dx = dp_whole([fused.bn_bwd_apply(gp, yp, xp, mean, rstd, gamma, sga, sgx,
                                      s, act, count)
                   for gp, yp, xp in zip(gs, ys, pieces)], s)
    xr, gr, br = (t.detach().clone().requires_grad_(True)
                  for t in (x, gamma, beta))
    _, _, ar, brr, _, _ = fused.bn_stats_plain(xr, s, gr, br, rm, rv)
    yr = fused.bn_act_plain(xr, ar, brr, act)
    ref = torch.autograd.grad(yr, (xr, gr, br), g)
    return compare_all(zip(("dx", "dgamma", "dbeta"), (dx, dgamma, dbeta),
                           ref), GRAD_REL, GRAD_REL,
                       f"synced backward {what}", rel_to_max=True)


def dp_spec(model, dtype, ticks, backend="gloo", world=DP_RANKS, seed=0,
            **overrides):
    """A dp_ticks spec: `model`'s config at full width on synthetic data,
    `ticks` random global batches of batch 64 (uint8 images), every rank on
    card 0."""
    import dataclasses as dc
    cfg = train_config(model, dtype=dtype, **overrides)
    gen = torch.Generator().manual_seed(SEED + 50 + seed)
    k, b, res = cfg.train.n_critic, cfg.train.batch_size, cfg.data.image_size
    batches = [{"real": torch.randint(0, 256, (k, b, res, res, 3),
                                      generator=gen, dtype=torch.uint8),
                "wrong": torch.randint(0, 256, (k, b, res, res, 3),
                                       generator=gen, dtype=torch.uint8),
                "emb": torch.randn(k, b, cfg.gan.embed_dim, generator=gen)}
               for _ in range(ticks)]
    return cfg, {"cfg": dc.asdict(cfg), "mesh": {"data": -1}, "world": world,
                 "backend": backend, "device": "cuda", "batches": batches}


def dp_rest_spec(model, **overrides):
    """The spec of `dp_grads_at_rest`: one f32 tick of `model` at learning
    rate 0, every update's gradients recorded."""
    _, spec = dp_spec(model, "float32", 1, **overrides, **DP_AT_REST)
    spec["record_grads"] = True
    return spec


def dp_grads_at_rest(what, spec, outs, device, elements=()):
    """One f32 tick at learning rate 0 (`dp_rest_spec`; the params never
    move, so every update reads the same params on both sides): the
    gradients that each rank handed Adam (the all-reduced mean), every update's,
    against one process's, per leaf ‖Δ‖ ≤ DP_GRAD_RTOL·(‖g_leaf‖ + max
    ‖g‖ over the net's leaves).  Adam's step does not see a gradient's
    scale; this does (a wrong ÷ D, a leaf counted twice).  The G
    `elements` ((leaf, index) pairs) are logged at each G update, one
    process / ranks, in ulps of the leaf's largest |g|.  Returns the
    largest ‖Δ‖ / (‖g_leaf‖ + max ‖g‖) of each update."""
    from text_to_image_tpu_torch.tools import dp_ticks
    with deterministic_cudnn():
        one = dp_ticks.run(spec, device)
    worst = {}
    for net in ("d", "g"):
        for r, out in enumerate(outs):
            check(len(out["grads"][net]) == len(one["grads"][net]) > 0,
                  f"{what}: {net} updates recorded")
        for u, ref in enumerate(one["grads"][net]):
            big = max(float(v.norm()) for v in ref.values())
            for r, out in enumerate(outs):
                got = out["grads"][net][u]
                for k, v in ref.items():
                    share = (float((got[k] - v).norm())
                             / (float(v.norm()) + big))
                    if share >= worst.get((net, u), (0.0,))[0]:
                        worst[net, u] = (share, f"rank {r} {k}")
    log(f"  {what}: all-reduced gradients vs one process's, ‖Δ‖ / (‖g_leaf‖ "
        f"+ max ‖g‖) (tol {DP_GRAD_RTOL:g}): " + "; ".join(
            f"{net} update {u} {w:.3e} ({where})"
            for (net, u), (w, where) in worst.items()))
    for (net, u), (w, where) in worst.items():
        check(w <= DP_GRAD_RTOL, f"{what}: {net} update {u} gradient "
                                 f"{where} {w:.3e} apart")
    dp_same_across_ranks(what, outs)
    at = {}
    for leaf, idx in elements:
        at[f"{leaf}{list(idx)}"] = rows = []
        for u, ref in enumerate(one["grads"]["g"]):
            scale = float(ref[leaf].abs().max())
            ulp = math.ldexp(1.0, math.frexp(scale)[1] - 24)
            g1 = float(ref[leaf][idx])
            gr = float(outs[0]["grads"]["g"][u][leaf][idx])
            rows.append({"one": g1, "ranks": gr, "scale": scale,
                         "ulps_apart": abs(g1 - gr) / ulp})
        log(f"  {what}: g {leaf}{list(idx)} at rest: " + "; ".join(
            f"u{u} {d['one']:+.6e}/{d['ranks']:+.6e} ({d['ulps_apart']:.1f} "
            f"ulp of {d['scale']:.3e} apart)" for u, d in enumerate(rows)))
    return {**{f"{net}{u}": w for (net, u), (w, _) in worst.items()},
            "elements": at}


def dp_reorder_control(cfg, spec, device):
    """The control of phase 11b's G elements: one process on the spec's
    GAN-CLS batches against one process on the same batches with the rows
    of every tick permuted (the noise's with them).  The math is the same
    (each stream's BN statistics and every loss are sums over rows); only
    the order of the sums differs, as between one process and the ranks.
    Logs each net's largest difference in lr and its elements past
    DP_PARAM_LRS·lr and past half of it; returns them."""
    from text_to_image_tpu_torch.tools import dp_ticks
    from text_to_image_tpu_torch.train.steps import draw_noise
    b = cfg.train.batch_size
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(SEED))
    noise = [draw_noise(cfg, i, b) for i in range(len(spec["batches"]))]
    plain = {**spec, "noise": noise, "record_grads": False}
    moved = {**plain, "batches": [{k: v[:, perm] for k, v in x.items()}
                                  for x in spec["batches"]],
             "noise": [{k: v[:, perm] if k == "d" else v[perm]
                        for k, v in n.items()} for n in noise]}
    with deterministic_cudnn():
        a, c = dp_ticks.run(plain, device), dp_ticks.run(moved, device)
    lr = max(cfg.train.generator_lr, cfg.train.discriminator_lr)
    out = {}
    for net in ("g", "d"):
        worst, past, half = 0.0, 0, 0
        for k, v in a["state"][f"{net}_params"].items():
            err = (c["state"][f"{net}_params"][k] - v).abs()
            worst = max(worst, float(err.max()) / lr)
            past += int((err > DP_PARAM_LRS * lr).sum())
            half += int((err > DP_PARAM_LRS * lr / 2).sum())
        out[net] = {"max_lrs": worst, "past_bound": past, "past_half": half}
    mdiff = max(abs(x[k] - y[k]) for x, y in zip(a["metrics"], c["metrics"])
                for k in x)
    log("  control: one process vs one process on the rows permuted (the "
        f"same math in another order), {len(noise)} f32 ticks: metrics "
        f"within {mdiff:.3e}; " + ", ".join(
            f"{net} {o['max_lrs']:.2f}·lr ({o['past_bound']} past "
            f"{DP_PARAM_LRS}·lr, {o['past_half']} past half)"
            for net, o in out.items()))
    return {**out, "metric_max_diff": mdiff}


def dp_against_one(what, cfg, spec, outs, device, held=("g", "d"),
                   name_past=()):
    """The ranks' outcomes against one process running the same ticks on
    the whole batch on this card, both with cuDNN's deterministic
    algorithms: metrics at DP_METRIC_TOL every tick; every element of the
    `held` nets' params within DP_PARAM_LRS·lr (the others' largest
    difference and the count of their elements past the bound logged);
    the ranks' states bit-identical.  Every difference is logged before it
    is checked.  For each net of `name_past` the elements past the bound
    are named with their gradients at every update (`dp_elements_past`;
    the spec records every tick's).  Returns the largest of each."""
    from text_to_image_tpu_torch.tools import dp_ticks
    with deterministic_cudnn():          # as the ranks run (dp_ticks.main)
        one = dp_ticks.run(spec, device)
    past = {net: dp_elements_past(what, net, cfg, outs, one)
            for net in name_past}
    rtol, atol = DP_METRIC_TOL
    lr = max(cfg.train.generator_lr, cfg.train.discriminator_lr)
    worst_m, bad = 0.0, []
    worst_p = {net: [0.0, None, 0, 0] for net in ("g", "d")}  # max, leaf,
    for r, out in enumerate(outs):                  # past the bound, past ½
        for i, (got, ref) in enumerate(zip(out["metrics"], one["metrics"])):
            check(got.keys() == ref.keys(), f"{what}: metric names differ")
            for k, v in ref.items():
                diff = abs(got[k] - v)
                worst_m = max(worst_m, diff)
                if diff > atol + rtol * abs(v):
                    bad.append(f"rank {r} tick {i} {k}: {got[k]} vs {v}")
        for net, w in worst_p.items():
            for k, v in one["state"][f"{net}_params"].items():
                err = (out["state"][f"{net}_params"][k] - v).abs()
                if r == 0:           # the ranks are held bit-identical
                    w[2] += int((err > DP_PARAM_LRS * lr).sum())
                    w[3] += int((err > DP_PARAM_LRS * lr / 2).sum())
                if float(err.max()) >= w[0]:
                    w[0], w[1] = float(err.max()), k
    log(f"  {what}: {len(outs)} ranks vs one process, {len(one['metrics'])} "
        f"ticks: metrics within {worst_m:.3e}; every param within "
        + ", ".join(f"{net} {d / lr:.2f}·lr ({k}; {n} elements past "
                    f"{DP_PARAM_LRS}·lr, {h} past half{'' if net in held else '; not held'})"
                    for net, (d, k, n, h) in worst_p.items()))
    check(not bad, f"{what}: metrics apart: {bad[:5]}")
    for net in held:
        d, k = worst_p[net][:2]
        check(d <= DP_PARAM_LRS * lr,
              f"{what}: {net}_params {k} {d / lr:.2f}·lr apart")
    dp_same_across_ranks(what, outs)
    log(f"  {what}: ranks bit-identical")
    return {"metric_max_diff": worst_m,
            "param_max_diff_lrs": {n: w[0] / lr for n, w in worst_p.items()},
            "param_max_leaf": {n: w[1] for n, w in worst_p.items()},
            "params_past_bound": {n: w[2] for n, w in worst_p.items()},
            "params_past_half_bound": {n: w[3] for n, w in worst_p.items()},
            "held": list(held), "elements_past_bound": past,
            "metrics": [o["metrics"] for o in outs],
            "one_process_metrics": one["metrics"],
            "ms": [o["ms"] for o in outs], "one_process_ms": one["ms"]}


def dp_elements_past(what, net, cfg, outs, one):
    """The elements of `net`'s params that end past DP_PARAM_LRS·lr from
    one process's (the ranks are bit-identical: rank 0's), each with the
    all-reduced gradient that every update handed Adam on the ranks and
    in one process, and that gradient in ulps of its leaf's scale (the
    largest |g| of the leaf at that update: round-off of sums at that
    scale is a few such ulps).  Logged and returned."""
    lr = max(cfg.train.generator_lr, cfg.train.discriminator_lr)
    rows = []
    for k, v in one["state"][f"{net}_params"].items():
        err = (outs[0]["state"][f"{net}_params"][k] - v).abs()
        for idx in (err > DP_PARAM_LRS * lr).nonzero().tolist():
            idx = tuple(idx)
            per_update = []
            for u, ref in enumerate(one["grads"][net]):
                scale = float(ref[k].abs().max())
                ulp = math.ldexp(1.0, math.frexp(scale)[1] - 24) if scale \
                    else 0.0
                g1 = float(ref[k][idx])
                gr = float(outs[0]["grads"][net][u][k][idx])
                per_update.append({"one": g1, "ranks": gr, "scale": scale,
                                   "ulps_one": abs(g1) / ulp if ulp else 0.0,
                                   "ulps_ranks": abs(gr) / ulp if ulp
                                   else 0.0})
            rows.append({"leaf": k, "index": list(idx),
                         "diff_lrs": float(err[idx]) / lr,
                         "one_process": float(v[idx]),
                         "ranks": float(outs[0]["state"][f"{net}_params"][k][
                             idx]), "updates": per_update})
    log(f"  {what}: {len(rows)} element(s) of {net} past "
        f"{DP_PARAM_LRS}·lr, with the gradient of each of its "
        f"{len(one['grads'][net])} updates (one process / ranks, in ulps of "
        f"the leaf's largest |g|):")
    for r in rows:
        log(f"    {net} {r['leaf']}{r['index']}: {r['diff_lrs']:.2f}·lr apart "
            f"({r['one_process']:+.6e} vs {r['ranks']:+.6e}); " + "; ".join(
                f"u{u} {d['one']:+.3e}/{d['ranks']:+.3e} "
                f"({d['ulps_one']:.1f}/{d['ulps_ranks']:.1f} ulp of "
                f"{d['scale']:.3e})" for u, d in enumerate(r["updates"])))
    return rows


@contextlib.contextmanager
def deterministic_cudnn():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def dp_same_across_ranks(what, outs):
    for r, out in enumerate(outs[1:], 1):
        for tree in ("g_params", "d_params", "g_state", "d_state"):
            for k, v in outs[0]["state"][tree].items():
                check(torch.equal(out["state"][tree][k], v),
                      f"{what}: rank {r} {tree} {k} differs from rank 0's")


def dp_profile_delta(prof):
    """One tick without and one with the group under profiling.trace:
    wall and device-busy ms of each, and the ops whose self host time or
    device time grew most with the group."""
    alone, group = prof["alone"], prof["group"]
    zero = (0.0, 0, 0.0)
    rows = []
    for name in set(alone["ops"]) | set(group["ops"]):
        a, g = alone["ops"].get(name, zero), group["ops"].get(name, zero)
        rows.append((g[0] - a[0], g[2] - a[2], a[1], g[1], name))
    host = sorted(rows, reverse=True)[:12]
    dev = sorted(rows, key=lambda r: r[1], reverse=True)[:6]
    log(f"  traced tick: {alone['ms']:.2f} ms alone (device busy "
        f"{alone['device_busy_ms']:.3f}), {group['ms']:.2f} ms with the "
        f"group (busy {group['device_busy_ms']:.3f}); self host ms added "
        f"by the group: " + "; ".join(f"{h:+.3f} {n[:60]} ({c0}→{c1} calls)"
                                      for h, _, c0, c1, n in host))
    log("  device ms added by the group: " + "; ".join(
        f"{d:+.3f} {n[:60]} ({c0}→{c1})" for _, d, c0, c1, n in dev))
    return {"alone_ms": alone["ms"], "group_ms": group["ms"],
            "alone_busy_ms": alone["device_busy_ms"],
            "group_busy_ms": group["device_busy_ms"],
            "host_ms_added": host, "device_ms_added": dev}


def dp_world1_main(device, runs, launch):
    """``main.py --train`` (GAN-CLS, full width, bf16, 3 ticks) in a group
    of one rank over nccl, as ``torchrun --nproc_per_node 1`` makes it,
    against the same run with no group: the launches of every kernel
    equal (TICK_LAUNCHES a tick: bn_stats, no bn_partials), no byte
    all-reduced."""
    from text_to_image_tpu_torch import main as port_main
    from text_to_image_tpu_torch.parallel import collectives
    from text_to_image_tpu_torch.tools import dp_ticks
    ticks = 3

    def argv(root):
        return ["--cfg", config_path("gancls"), "--train", "--steps",
                str(ticks), "--set", "data.dataset_name=synthetic",
                "train.summary_interval=1", "train.snapshot_interval=1000",
                "train.sample_interval=1000", *run_dirs(root)]
    (grouped,) = launch("gancls_main_world1", {
        "argv": argv(os.path.join(runs, "dp", "world1_group")),
        "backend": "nccl", "device": "cuda", "world": 1})
    before = dp_ticks.counters()
    collectives.all_reduce_sum.bytes = 0
    port_main.main(argv(os.path.join(runs, "dp", "world1_alone")) +
                   ["--device", str(device)])
    torch.cuda.synchronize()
    alone = dp_ticks.counted_since(before)
    # the kernels' launches (the program's other counters have dotted names)
    want = {k: ticks * TICK_LAUNCHES.get(k, 0) for k in alone if "." not in k}
    log(f"  main.py --train, {ticks} ticks: launches in a group of one rank "
        f"{grouped['launches']}, without a group {alone}; bytes all-reduced "
        f"{grouped['all_reduce_bytes']} / {collectives.all_reduce_sum.bytes}")
    # every key of either, a counter that a process never bumped (absent
    # from its dict: an earlier phase of this one may have) counting 0
    same = all(grouped["launches"].get(k, 0) == alone.get(k, 0)
               for k in set(grouped["launches"]) | set(alone))
    check(same and {k: alone[k] for k in want} == want,
          f"world-1 launches {grouped['launches']} vs {alone} (want {want})")
    check(grouped["all_reduce_bytes"] == 0 ==
          collectives.all_reduce_sum.bytes, "a collective at world 1")
    return {"group_launches": grouped["launches"], "alone_launches": alone,
            "group_d_loss": [h["d_loss"] for h in grouped["history"]]}


def torchrun(argv, timeout):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    text_to_image_tpu_torch.main …`` from the repo root; what it printed."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(DP_RANKS), "-m",
         "text_to_image_tpu_torch.main", *argv], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0,
          f"torchrun exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")
    return proc.stdout


def phase_data_parallel(device, runs, flush):
    """Phase 11: data parallelism on the card (every rank on card 0)."""
    from text_to_image_tpu_torch.tools import dp_ticks
    report = {"launches": {}}
    t0 = time.perf_counter()
    log("phase 11a: bn_partials / bn_finish vs their plain versions, D = 1, "
        "2, 4 pieces of every GAN-CLS BN call, the synced backward, timed")
    report["errors"], report["bn_rows"] = phase_dp_bn_kernels(device, flush)
    log(f"  (11a: {time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    def launch(tag, spec):
        t1 = time.perf_counter()
        outs = dp_ticks.launch(spec, os.path.join(runs, "dp", tag),
                               DP_TIMEOUT_S)
        log(f"  {tag}: {spec['world']} rank(s) over {spec['backend']} in "
            f"{time.perf_counter() - t1:.1f} s")
        return outs

    # the eight specs of 11b and 11c over gloo: one launch, each rank
    # running them in turn in one process group
    gancls_f32, spec_f32 = dp_spec("gancls", "float32", 3)
    spec_f32["record_grads"] = "all"   # every update's, for the G elements
    frozen, spec_frozen = dp_spec("gancls", "float32", 3,
                                  **{"train.discriminator_lr": 0.0})
    wgan, spec_wgan = dp_spec("wgancls", "float32", 1,
                              **{"train.use_interpolation": True})
    pggan, spec_pggan = dp_spec("pggan", "float32", 1, **{"pggan.stage": 4})
    specs = {"gancls_f32": spec_f32, "gancls_f32_d_frozen": spec_frozen,
             "gancls_lr0": dp_rest_spec("gancls"),
             "gancls_bf16": dp_spec("gancls", "bfloat16", 3, seed=1)[1],
             "wgancls_f32": spec_wgan, "pggan_f32": spec_pggan,
             "wgancls_lr0": dp_rest_spec(
                 "wgancls", **{"train.use_interpolation": True}),
             "pggan_lr0": dp_rest_spec("pggan", **{"pggan.stage": 4})}
    t1 = time.perf_counter()
    runs_by_spec = dp_ticks.launch_many(
        specs, os.path.join(runs, "dp", "gloo_specs"),
        DP_TIMEOUT_S * len(specs))
    log(f"  {len(specs)} specs ({', '.join(specs)}): {DP_RANKS} ranks over "
        f"gloo in one launch, {time.perf_counter() - t1:.1f} s")

    log(f"phase 11b: GAN-CLS at full width, {DP_RANKS} ranks on this card "
        f"over gloo (batch 32 a rank) vs one process at batch 64")
    # every element of D's params with both nets training; G's with D
    # frozen.  While D trains, G's gradients vanish (D saturates on the
    # fakes) and Adam steps each weight ≈ lr whatever the gradient's size,
    # so another order of sums walks G's elements up to about 10·lr apart,
    # in one process against itself too (ROADMAP.md §3, fault (b)).  G with
    # D training is logged, its elements past the bound named with their
    # gradients; its gradients are held in the tick at lr 0
    # the control beside each: one process against itself on the rows
    # permuted, the same math in another order of sums
    report["gancls_f32"] = dp_against_one(
        "GAN-CLS f32", gancls_f32, spec_f32, runs_by_spec.pop("gancls_f32"),
        device, held=("d",), name_past=("g",))
    report["gancls_f32_reorder"] = dp_reorder_control(gancls_f32, spec_f32,
                                                      device)
    report["gancls_f32_d_frozen"] = dp_against_one(
        "GAN-CLS f32, D frozen", frozen, spec_frozen,
        runs_by_spec.pop("gancls_f32_d_frozen"), device)
    report["gancls_f32_d_frozen_reorder"] = dp_reorder_control(
        frozen, spec_frozen, device)
    past = report["gancls_f32"]["elements_past_bound"]["g"]
    report["gancls_f32_grads"] = dp_grads_at_rest(
        "GAN-CLS f32, lr 0", specs["gancls_lr0"],
        runs_by_spec.pop("gancls_lr0"), device,
        elements=[(e["leaf"], tuple(e["index"])) for e in past])
    outs = runs_by_spec.pop("gancls_bf16")
    dp_same_across_ranks("GAN-CLS bf16", outs)
    for r, out in enumerate(outs):
        for i, m in enumerate(out["metrics"]):
            check(all(math.isfinite(v) for v in m.values()),
                  f"GAN-CLS bf16 rank {r} tick {i}: {m}")
        for i, n in enumerate(out["launches"]):
            check({k: n[k] for k in DP_TICK_LAUNCHES} == DP_TICK_LAUNCHES,
                  f"GAN-CLS bf16 rank {r} tick {i} launches {n}, expected "
                  f"{DP_TICK_LAUNCHES}")
    report["launches"][f"dp GAN-CLS training, rank 0 of {DP_RANKS}"] = {
        k: sum(n[k] for n in outs[0]["launches"]) for k in DP_TICK_LAUNCHES}
    report["gancls_bf16"] = {"metrics": [o["metrics"] for o in outs],
                             "ms": [o["ms"] for o in outs],
                             "launches_per_tick": outs[0]["launches"][0],
                             "all_reduce_bytes": outs[0]["all_reduce_bytes"]}
    log(f"  GAN-CLS bf16: losses finite, ranks bit-identical, launches a "
        f"rank and tick {outs[0]['launches'][0]}")
    del outs

    log("phase 11c: WGAN-CLS with GAN-INT and C-PGGAN stage 4, "
        f"{DP_RANKS} ranks vs one process (f32)")
    report["wgancls_gan_int_f32"] = dp_against_one(
        "WGAN-CLS + GAN-INT f32", wgan, spec_wgan,
        runs_by_spec.pop("wgancls_f32"), device)
    report["pggan_stage4_f32"] = dp_against_one(
        "C-PGGAN stage 4 f32", pggan, spec_pggan,
        runs_by_spec.pop("pggan_f32"), device)
    report["wgancls_gan_int_f32_grads"] = dp_grads_at_rest(
        "WGAN-CLS + GAN-INT f32, lr 0", specs["wgancls_lr0"],
        runs_by_spec.pop("wgancls_lr0"), device)
    report["pggan_stage4_f32_grads"] = dp_grads_at_rest(
        "C-PGGAN stage 4 f32, lr 0", specs["pggan_lr0"],
        runs_by_spec.pop("pggan_lr0"), device)
    del runs_by_spec
    torch.cuda.empty_cache()

    log("phase 11d: one rank over nccl (a group of world 1), GAN-CLS bf16, "
        "vs the tick without a group, in turns in one process")
    cfg, spec = dp_spec("gancls", "bfloat16", DP_NCCL_TICKS, backend="nccl",
                        world=1, seed=2)
    # a group of one rank runs the one-process tick; this keeps the old
    # world-1 batch group, so that the data-parallel machinery is timed
    spec["world1_batch_group"] = True
    spec["turns"] = 4             # without, with, with, without
    spec["profile"] = True        # then one tick alone and one with, traced
    (out,) = launch("gancls_nccl", spec)
    # the first tick of a run warms up (allocator, cuBLAS): left out
    steady = {g: [t for r in out["turns"] if r["group"] == g
                  for t in r["ms"][1:]] for g in (True, False)}
    report["nccl_world1"] = {
        "tick_ms_median": statistics.median(steady[True]),
        "no_group_tick_ms_median": statistics.median(steady[False]),
        "turns": out["turns"], "launches_per_tick": out["launches"][-1],
        "all_reduce_bytes_per_tick": out["all_reduce_bytes"][-1]}
    check({k: out["launches"][-1][k] for k in DP_TICK_LAUNCHES}
          == DP_TICK_LAUNCHES,
          f"nccl tick launches {out['launches'][-1]}")
    report["launches"]["dp GAN-CLS tick, nccl world 1"] = {
        k: sum(n[k] for n in out["launches"]) for k in DP_TICK_LAUNCHES}
    n = report["nccl_world1"]
    log(f"  tick {n['tick_ms_median']:.2f} ms with the group (world 1), "
        f"{n['no_group_tick_ms_median']:.2f} ms without; "
        f"{n['all_reduce_bytes_per_tick']} bytes all-reduced a tick")
    report["nccl_world1"]["profile"] = dp_profile_delta(out["profile"])
    for tag in ("alone", "group"):       # the two Chrome traces, kept
        shutil.copytree(os.path.join(runs, "dp", "gancls_nccl",
                                     f"trace_{tag}"),
                        os.path.join(ROOT, "chiprun_out", "dp_traces", tag),
                        dirs_exist_ok=True)

    report["world1_main"] = dp_world1_main(device, runs, launch)

    log(f"phase 11e: torchrun --nproc_per_node {DP_RANKS} main.py --train "
        f"--dist-backend gloo, sharded resident tier, phase 6c's split: 3 + 3 "
        f"ticks vs 6 straight")
    from text_to_image_tpu_torch.train import checkpoint as ckpt
    data_dir = os.path.join(runs, "flowers")          # phase 6c's split
    check(os.path.isdir(os.path.join(data_dir, "train")),
          f"no split under {data_dir}")

    def argv(root, steps):
        return ["--cfg", config_path("gancls"), "--train", "--steps",
                str(steps), "--dist-backend", "gloo", "--set",
                "data.dataset_name=flowers", f"data.data_dir={data_dir}",
                "data.device_resident=sharded", "train.summary_interval=1",
                "train.snapshot_interval=1000", "train.sample_interval=1000",
                *run_dirs(root)]
    t1 = time.perf_counter()
    a, b = (os.path.join(runs, "dp", "torchrun", d) for d in "ab")
    said = torchrun(argv(a, 6), DP_TIMEOUT_S)
    check("data path: sharded" in said and "data parallel over 2 ranks" in
          said, f"not the sharded tier over 2 ranks:\n{said[-2000:]}")
    torchrun(argv(b, 3), DP_TIMEOUT_S)
    said_b = torchrun(argv(b, 6), DP_TIMEOUT_S)
    check("restored checkpoint at step 3" in said_b,
          f"the second run did not restore step 3:\n{said_b[-2000:]}")
    sa, sb = (ckpt.CheckpointManager(os.path.join(
        d, "checkpoint", "gancls", "flowers")).load(6)[0] for d in (a, b))
    fa, fb = flat_state(sa), flat_state(sb)
    check(fa.keys() == fb.keys(), "the two runs' checkpoints differ in keys")
    diff = [k for k in fa if not (torch.equal(fa[k], fb[k])
                                  if isinstance(fa[k], torch.Tensor)
                                  else fa[k] == fb[k])]
    check(not diff, f"3 + 3 ticks differ from 6 straight: {diff[:5]}")
    logs = [[json.loads(s) for s in open(os.path.join(
        d, "log", "gancls", "flowers", "train.jsonl"))] for d in (a, b)]
    check([r["step"] for r in logs[0]] == list(range(1, 7)),
          "one metric line a step from rank 0 alone")
    check([r["d_loss"] for r in logs[0][3:]] ==
          [r["d_loss"] for r in logs[1][3:]], "resumed losses differ")
    report["torchrun_resume"] = {"leaves_compared": len(fa),
                                 "seconds": time.perf_counter() - t1,
                                 "d_loss": [r["d_loss"] for r in logs[0]]}
    log(f"  torchrun: 3 + 3 ticks bit-identical to 6 straight over "
        f"{len(fa)} state entries ({time.perf_counter() - t1:.1f} s)")
    return report


# --- phases 12-14: the entry, the dry run, the bench -------------------------

# entry(): the GAN-CLS train-mode generator (4 deconv; 4 BN calls) and D
# over the three streams in one pass (4 conv, 1 join; 4 BN calls)
ENTRY_LAUNCHES = {"deconv5x5_s2": 4, "conv5x5_s2_act": 4,
                  "conditioning_join": 1, "bn_stats": 8, "bn_act": 8}
# entry() on the kernels vs the same function on their plain versions
# (bf16, batch 16): each layer rounds to bf16 after f32 sums in another
# order, and the train-mode BN over 16 rows carries a flip through the net;
# relative to the largest |value| of each output
ENTRY_TOL = 5e-2
# the dry run's kernels on each rank (the f32 WGAN-CLS + GAN-INT tick and
# the resident tick at tiny widths): G's BN over the batch group
# (bn_partials, bn_finish), the critic's convs and join
DRYRUN_KERNELS = ("deconv5x5_s2", "conv5x5_s2_act", "conditioning_join",
                  "bn_partials", "bn_finish", "bn_act", "bn_bwd_reduce",
                  "bn_bwd_apply", "conv5x5_s2_dw")
DRYRUN_DEVICES = 8
BENCH_TIMEOUT_S = 400
BENCH_NUMBERS = ("value", "vs_baseline", "resident_value",
                 "sharded_resident_value", "pipeline_value", "sampling_value",
                 "baseline_img_per_sec")


@contextlib.contextmanager
def plain_kernels():
    """Every kernel of the GAN-CLS forward swapped for its plain version
    whatever the tensors' device (no gradient: the train-mode BN's
    forward is bn_stats then bn_act)."""
    from text_to_image_tpu_torch.models import gancls
    from text_to_image_tpu_torch.ops import layers
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    swaps = [(layers, "deconv5x5_s2", conv.deconv5x5_s2_plain),
             (gancls, "deconv5x5_s2", conv.deconv5x5_s2_plain),
             (layers, "conv5x5_s2_act", conv.conv5x5_s2_act_plain),
             (gancls, "conditioning_join", fused.conditioning_join_plain),
             (fused, "bn_stats", fused.bn_stats_plain),
             (fused, "_bn_act_forward", fused.bn_act_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_entry(device):
    """Phase 12: `entry.entry()` on the card: one call with every counter
    at 0 before and read after (ENTRY_LAUNCHES), shapes and finiteness
    (`check_entry`), against the same function on the plain versions on
    the same inputs, and its ms (median of 5 synchronised calls)."""
    from text_to_image_tpu_torch import entry
    fn, args = entry.entry(str(device))
    counters = all_counters()
    for c in counters:
        c.launches = 0
    fake, logits = entry.check_entry(fn, args)
    launches = {c.__name__: c.launches for c in counters}
    want = {c.__name__: ENTRY_LAUNCHES.get(c.__name__, 0) for c in counters}
    log(f"  entry() launches {launches}")
    check(launches == want, f"entry() launches {launches}, expected {want}")
    with plain_kernels():
        ref_fake, ref_logits = fn(*args)
    torch.cuda.synchronize()
    check(all(c.launches == launches[c.__name__] for c in counters),
          "a kernel launched inside plain_kernels()")
    errs = {}
    for name, got, ref in (("fake", fake, ref_fake),
                           ("logits", logits, ref_logits)):
        errs[name] = float((got.float() - ref.float()).abs().max()
                           / ref.float().abs().max())
    log(f"  entry() vs its plain versions (bf16, B 16): fake "
        f"{errs['fake']:.3e}, logits {errs['logits']:.3e} of the largest "
        f"|value| (tol {ENTRY_TOL:g})")
    check(max(errs.values()) <= ENTRY_TOL, f"entry() vs plain: {errs}")
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(samples)
    log(f"  entry(): {ms:.3f} ms a call (median of 5, host clock between "
        f"synchronises; {samples})")
    return {"launches": launches, "errors": errs, "ms": ms,
            "ms_samples": samples}


def phase_dryrun():
    """Phase 13: `entry.dryrun_multichip(8)`: 8 gloo ranks sharing the
    card, the (data 4, model 2) and (slice 2, data 2, model 2) meshes; each
    rank asserts step 1 and finite metrics; every rank launched each
    kernel of DRYRUN_KERNELS and no bn_stats (G's BN is over its batch
    group)."""
    from text_to_image_tpu_torch import entry
    t0 = time.perf_counter()
    outs = entry.dryrun_multichip(DRYRUN_DEVICES, "cuda")
    seconds = time.perf_counter() - t0
    meshes = []
    for i, mesh in enumerate(outs[0]["dryrun"]):
        log(f"  {mesh['line']}")
        per_rank = [o["dryrun"][i]["launches"] for o in outs]
        for r, n in enumerate(per_rank):
            check(all(n[k] > 0 for k in DRYRUN_KERNELS) and
                  n["bn_stats"] == 0 == n["upconv3x3"],
                  f"dry run mesh {i} rank {r} launches {n}")
        log(f"  launches a rank (host-fed + resident tick): {per_rank[0]}")
        meshes.append({"line": mesh["line"], "launches": per_rank,
                       "metrics": [o["dryrun"][i]["metrics"] for o in outs],
                       "resident_metrics": [o["dryrun"][i]["resident_metrics"]
                                            for o in outs]})
    log(f"  (dry run: {seconds:.1f} s)")
    return {"meshes": meshes, "seconds": seconds}


def phase_bench(card, rates):
    """Phase 14: ``python -m text_to_image_tpu_torch.bench`` at its
    defaults: rc 0, its one JSON line with every value a number; logged
    with the card and phase 4's sampling rates beside ``sampling_value``."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "text_to_image_tpu_torch.bench"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"bench printed {lines}")
    line = json.loads(lines[0])
    for k in BENCH_NUMBERS:
        check(isinstance(line.get(k), (int, float)) and
              math.isfinite(line[k]) and line[k] > 0,
              f"bench {k} = {line.get(k)!r}")
    log(f"  bench [{card}] ({seconds:.1f} s): {json.dumps(line)}")
    log(f"  phase 4's sampling at batch 64: train mode "
        f"{rates['train_mode']:.1f}, folded {rates['folded']:.1f} images/s; "
        f"bench sampling_value {line['sampling_value']}")
    return {"line": line, "seconds": seconds, "card": card,
            "phase4_sampling": {k: rates[k] for k in ("train_mode",
                                                      "folded")}}


# --- phase 15: the scripts and the kernel microbench -------------------------

# training steps of the scripts' runs: enough to pass through every code
# path of each (the trajectory evals, the resume, each C-PGGAN stage), far
# too few for their quality gates, which the full-length runs hold
CONVERGENCE_STEPS = 20
CHAINED_STEPS = (4, 4, 6)            # Stage-I, Stage-II, Stage-II resumed
CHAINED_TRAJ = 2
DYNAMICS_STEPS = 2
PGGAN_STEPS_PER_STAGE = 1
PROFILE_STEPS = 3
SERVE_ITERS = 10
DEMO_STEPS = 20
DEMO_IS_IMAGES = 320
RUNBOOK_TIMEOUT_S = 300
# the kernels of the GAN-CLS tick; of the StackGAN and C-PGGAN paths
GANCLS_KERNELS = ("deconv5x5_s2", "conv5x5_s2_act", "conditioning_join",
                  "bn_stats", "bn_act", "bn_bwd_reduce", "bn_bwd_apply",
                  "conv5x5_s2_dw", "conv5x5_s2_dx")
UPCONV_KERNELS = ("upconv3x3",)
# (the D's conv backward: its dx on conv5x5_s2_dx, the RGB layer's on
# deconv5x5_s2, its dw on conv5x5_s2_dw)
STACKGAN_KERNELS = ("upconv3x3", "upconv3x3_dx", "upconv3x3_dw",
                    "conv5x5_s2_act", "conditioning_join", "bn_stats",
                    "bn_act", "bn_bwd_reduce", "bn_bwd_apply",
                    "deconv5x5_s2", "conv5x5_s2_dw", "conv5x5_s2_dx")
PGGAN_KERNELS = ("upconv3x3", "upconv3x3_dx", "upconv3x3_dw")


class PhaseClock:
    """The seconds of each phase of `run`: `start` logs a phase's line and
    ends the one before it."""

    def __init__(self):
        self.seconds, self._name, self._t0 = {}, None, None

    def start(self, line):
        self.stop()
        log(line)
        self._name, self._t0 = line.split(":", 1)[0], time.perf_counter()

    def stop(self):
        if self._name is not None:
            secs = time.perf_counter() - self._t0
            self.seconds[self._name] = self.seconds.get(self._name, 0.0) + secs
            log(f"  ({self._name}: {secs:.1f} s)")
            self._name = None
        return self.seconds


def finite_numbers(tree) -> bool:
    """Every number of a JSON-like tree is finite (bools aside)."""
    if isinstance(tree, dict):
        return all(finite_numbers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite_numbers(v) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return math.isfinite(tree)
    return True


def drive_script(name, fn, *args, want=(), **kw):
    """A script's ``main`` with every launch count 0 just before and read
    just after, what it printed teed: (rc, printed, launches).  Each
    kernel of `want` must have launched."""
    counters = all_counters()
    for k in counters:
        k.launches = 0
    out = Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kw)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    log(f"  {name}: rc {rc}, {time.perf_counter() - t0:.1f} s, launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    for k in want:
        check(launches[k] > 0, f"{name}: {k} never launched: {launches}")
    return rc, out.getvalue(), launches


def result_line(printed, tag, what):
    """The JSON of the last ``<tag> {...}`` line; every number finite."""
    lines = [ln for ln in printed.splitlines() if ln.startswith(tag + " ")]
    check(bool(lines), f"{what}: no {tag!r} line")
    res = json.loads(lines[-1][len(tag) + 1:])
    check(finite_numbers(res), f"{what}: a number is not finite: {res}")
    return res


def verdict(printed, rc, tag, what):
    """The script's PASS / FAIL line, consistent with its exit code."""
    said = [ln for ln in printed.splitlines()
            if ln in (f"{tag} PASS", f"{tag} FAIL")]
    check(len(said) == 1, f"{what}: verdict lines {said}")
    check((said[0] == f"{tag} PASS") == (rc == 0),
          f"{what}: {said[0]} with exit code {rc}")
    log(f"  {what}: {said[0]} (not held at this length)")
    return said[0]


def phase_scripts(device, runs):
    """Phase 15: every ported script through its ``main`` on the card, at
    a few steps, and the kernel microbench."""
    from text_to_image_tpu_torch.eval import inception_v3 as iv3
    from text_to_image_tpu_torch.eval.inception import load_classifier
    from text_to_image_tpu_torch.scripts import (chained_stackgan,
                                                 convergence_check,
                                                 convert_inception, e2e_demo,
                                                 parity_runbook,
                                                 pggan_progression,
                                                 profile_step, serve_profile,
                                                 stage2_dynamics)
    from text_to_image_tpu_torch.tools import bench_kernels
    from text_to_image_tpu_torch.train.checkpoint import CheckpointManager
    dev = str(device)
    root = os.path.join(runs, "scripts")
    report, launches = {}, {}

    # 15i: the runbook at its defaults, a process of its own (its main.py
    # runs are processes too) in the background of 15a-15h, none of which
    # is timed; collected before the timed 15e, 15f and 15j
    par_work = os.path.join(root, "parity")
    os.makedirs(root, exist_ok=True)
    par_log = open(os.path.join(root, "parity_runbook.log"), "w+")
    runbook = subprocess.Popen(
        [sys.executable, "-m", "text_to_image_tpu_torch.scripts.parity_runbook",
         "synthetic", par_work, "--device", dev], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}, stdout=par_log,
        stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    try:
        # 15a: GAN-CLS convergence on the resident tier
        grid = os.path.join(root, "convergence_grid.png")
        rc, said, launches["convergence_check"] = drive_script(
            "convergence_check", convergence_check.main, CONVERGENCE_STEPS,
            "gancls", "synthetic", grid, device=dev, want=GANCLS_KERNELS)
        report["convergence_check"] = {
            "result": result_line(said, "CONVERGENCE RESULT", "convergence_check"),
            "verdict": verdict(said, rc, "CONVERGENCE", "convergence_check")}
        check(png_size(grid) == (8 * 64, 8 * 64), f"class grid {png_size(grid)}")

        # 15b: the StackGAN chain with the trajectory, then resumed after an
        # interruption before Stage-II's first snapshot: its training restarts
        # at step 0 and replays the evals at or before the best one
        chain = os.path.join(root, "chained")
        s1, s2, s2_more = CHAINED_STEPS
        rc, said, launches["chained_stackgan --traj"] = drive_script(
            "chained_stackgan --traj", chained_stackgan.main, s1, s2, root=chain,
            traj_interval=CHAINED_TRAJ, device=dev, want=STACKGAN_KERNELS)
        first = result_line(said, "CHAINED RESULT", "chained_stackgan --traj")
        verdict(said, rc, "CHAINED", "chained_stackgan --traj")
        ck = os.path.join(chain, "ck")
        best_dir = os.path.join(ck, "stackgan_stage2", "synthetic_best")
        check(CheckpointManager(os.path.join(ck, "stackgan_stage1", "synthetic")
                                ).latest_step() == s1, "no Stage-I checkpoint")
        s2_dir = os.path.join(ck, "stackgan_stage2", "synthetic")
        check(CheckpointManager(s2_dir).latest_step() == s2,
              "no Stage-II checkpoint")
        check([p["step"] for p in first["stage2_traj"]] ==
              list(range(CHAINED_TRAJ, s2 + 1, CHAINED_TRAJ)),
              f"trajectory {first['stage2_traj']}")
        shutil.rmtree(s2_dir)
        rc, said, launches["chained_stackgan --resume"] = drive_script(
            "chained_stackgan --resume", chained_stackgan.main, s1, s2_more,
            root=chain, traj_interval=CHAINED_TRAJ, resume=True, device=dev,
            want=STACKGAN_KERNELS)
        again = result_line(said, "CHAINED RESULT", "chained_stackgan --resume")
        verdict(said, rc, "CHAINED", "chained_stackgan --resume")
        check("resume: seeded best" in said, "the resumed run seeded no best")
        check("resumed_seed" not in again["stage2"], f"{again['stage2']}")
        check([p["step"] for p in again["stage2_traj"]] ==
              [first["stage2_best"]["step"]]
              + list(range(CHAINED_TRAJ, s2_more + 1, CHAINED_TRAJ)),
              f"resumed trajectory {again['stage2_traj']}")
        with open(os.path.join(best_dir, "best.json")) as f:
            best = json.load(f)
        check(best == again["stage2_best"] and
              CheckpointManager(best_dir).all_steps() == [best["step"]],
              f"best.json {best} beside checkpoints "
              f"{CheckpointManager(best_dir).all_steps()}")
        check(png_size(os.path.join(chain, "samples", "stackgan_stage2",
                                    "synthetic", f"train_{s2_more:08d}.png")
                       )[0] > 0, "no Stage-II grid")
        report["chained_stackgan"] = {"traj": first, "resume": again,
                                      "best_json": best}

        # 15c: one Stage-II variant over the chain's Stage-I
        rc, said, launches["stage2_dynamics"] = drive_script(
            "stage2_dynamics", stage2_dynamics.main, s1, DYNAMICS_STEPS,
            ["smooth+g2"], dataset="synthetic", keep_stage1=True, root=chain,
            device=dev, want=STACKGAN_KERNELS)
        check(rc == 0 and "reusing checkpoint" in said, f"stage2_dynamics rc {rc}")
        report["stage2_dynamics"] = result_line(said, "S2AB RESULT",
                                                "stage2_dynamics")

        # 15d: the seven C-PGGAN stages to 256 px
        pg = os.path.join(root, "pggan")
        rc, said, launches["pggan_progression"] = drive_script(
            "pggan_progression", pggan_progression.main, PGGAN_STEPS_PER_STAGE,
            256, root=pg, device=dev, want=PGGAN_KERNELS)
        report["pggan_progression"] = {
            "result": result_line(said, "PGGAN256 RESULT", "pggan_progression"),
            "verdict": verdict(said, rc, "PGGAN256", "pggan_progression")}
        check(png_size(os.path.join(pg, "samples",
                                    "pggan_256px_synthetic_grid.png"))[0] > 0,
              "no 256 px grid")

        # 15g: a torchvision-layout checkpoint (nested, DataParallel keys)
        # converted and read back
        params = iv3.init(0, FLOWERS_CLASSES)
        pth, npz = (os.path.join(root, n) for n in ("iv3.pth", "iv3.npz"))
        torch.save({"model": {f"module.{k}": v for k, v in
                              iv3.export_torchvision_state_dict(params).items()}},
                   pth)
        rc, said, _ = drive_script("convert_inception", convert_inception.main,
                                   ["--pth", pth, "--out", npz])
        want, got = flat(params), flat(iv3.load_npz(npz, "cpu"))
        check(rc == 0 and want.keys() == got.keys() and
              all(torch.equal(v, got[k]) for k, v in want.items()),
              "convert_inception round trip")
        logits = load_classifier(npz, dev)(torch.rand(4, 64, 64, 3) * 2 - 1)
        check(tuple(logits.shape) == (4, FLOWERS_CLASSES) and
              bool(torch.isfinite(logits).all()), "converted classifier logits")
        report["convert_inception"] = {"leaves": len(flat(params))}

        # 15h: the demo whole (its raw JPGs through Pillow), its main.py
        # runs processes of their own
        rc, said, _ = drive_script("e2e_demo", e2e_demo.main,
                                   os.path.join(root, "e2e"), steps=DEMO_STEPS,
                                   is_images=DEMO_IS_IMAGES, device=dev)
        res = result_line(said, "E2E RESULT", "e2e_demo")
        check(rc == 0 and 1.0 <= res["is_mean"] and len(res["grids"]) == 3
              and all(png_size(g)[0] > 0 for g in res["grids"]),
              f"e2e_demo: rc {rc}, {res}")
        report["e2e_demo"] = res

        rc = runbook.wait(timeout=RUNBOOK_TIMEOUT_S)
    finally:
        if runbook.poll() is None:
            runbook.kill()
            runbook.wait()
        par_log.seek(0)
        said = par_log.read()
        par_log.close()
    log(f"  parity_runbook (python -m, in the background): rc {rc}, "
        f"{time.perf_counter() - t0:.1f} s from its start")
    res = result_line(said, "PARITY RESULT", "parity_runbook")
    check(rc == 0 and 1.0 <= res["is_mean"] and len(res["grids"]) == 3
          and all(png_size(g)[0] > 0 for g in res["grids"])
          and os.path.exists(os.path.join(par_work, "data", "inception.npz")),
          f"parity_runbook: rc {rc}, {res}\n{said[-3000:]}")
    report["parity_runbook"] = res

    # 15e, 15f: the step trace; the per-stage serving forward
    trace = os.path.join(root, "trace")
    rc, said, launches["profile_step"] = drive_script(
        "profile_step", profile_step.main,
        ["--steps", str(PROFILE_STEPS), "--out", trace, "--device", dev],
        want=GANCLS_KERNELS)
    traces = [f for f in os.listdir(trace) if f.endswith(".json")]
    check(rc == 0 and len(traces) == 1, f"profile_step rc {rc}, {traces}")
    report["profile_step"] = {"trace_bytes": os.path.getsize(
        os.path.join(trace, traces[0]))}
    rc, said, launches["serve_profile"] = drive_script(
        "serve_profile", serve_profile.main, 32, device=dev,
        iters=SERVE_ITERS, want=UPCONV_KERNELS)
    report["serve_profile"] = result_line(said, "SERVE RESULT",
                                          "serve_profile")
    check(rc == 0 and len(report["serve_profile"]["cum_ms"]) == 7,
          f"serve_profile {report['serve_profile']}")

    # 15j: the kernel microbench
    out_dir = os.path.join(ROOT, "chiprun_out")
    for argv, fname in (([], "bench_kernels.json"),
                        (["--upconv", "--conv", "--deconv", "--conv3x3",
                          "--grad"], "bench_kernels_grad.json")):
        rc, said, _ = drive_script(f"bench_kernels {' '.join(argv)}".strip(),
                                   bench_kernels.main, argv)
        with open(os.path.join(out_dir, fname)) as f:
            bench = json.load(f)
        check(rc == 0 and bench["rows"] and finite_numbers(bench["rows"]),
              f"bench_kernels {argv}: rc {rc}")
        check({r["kernel"] for r in bench["rows"]} ==
              ({k for t in bench_kernels.GRAD_TABLES.values() for k in t}
               | {bench_kernels.CONV_DX_VIA_DECONV}
               if argv else set(bench_kernels.KERNELS)),
              f"bench_kernels kernels {[r['kernel'] for r in bench['rows']]}")
        report[fname[:-5]] = bench
    report["launches"] = {f"script {k}": v for k, v in launches.items()}
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # checkpoints, logs, grids and the written split of the runs below; in
    # the git-ignored build/ (they take a few GB, too much for the report
    # directory), removed at the end
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    runs = tempfile.mkdtemp(prefix="smoke_runs_",
                            dir=os.path.join(ROOT, "build"))
    try:
        return run(runs)
    finally:
        shutil.rmtree(runs, ignore_errors=True)


def run(runs: str) -> int:
    sys.path.insert(0, ROOT)
    from text_to_image_tpu_torch.ops.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    phases = PhaseClock()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")

    phases.start("phase 1: build")
    t0 = time.perf_counter()
    _build.build(_build.sources())
    # a library whose digest an earlier run in this checkout built is
    # loaded as it is: it has no ptxas report
    built = [n for n in _build.sources() if _build.ptxas_report(n)]
    cached = [n for n in _build.sources() if n not in built]
    log(f"  nvcc built {built} in {time.perf_counter() - t0:.1f} s"
        + (f"; loaded from an earlier build (no ptxas report): {cached}"
           if cached else ""))
    for name in built:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    phases.start("phase 2: kernels vs plain versions at the main-path shapes")
    errs = phase_kernels(device)
    train_errs, conv_paths = phase_train_kernels(device)
    errs.update(train_errs)
    errs.update(phase_upconv_kernels(device))
    bn_errs, bn_plans = phase_bn_kernels(device)
    errs.update(bn_errs)

    phases.start("phase 3: backward passes vs torch.autograd through the plain "
                 "versions (f32, TF32 off)")
    grad_errs = phase_backward(device)
    grad_errs.update(phase_upconv_backward(device))
    phases.start("phase 3b: the up-block's backward kernels (upconv3x3_dx, "
                 "upconv3x3_dw) vs their plain versions at the StackGAN, "
                 "C-PGGAN and odd shapes (bf16 and f32), bit-identical twice")
    bwd_errs, bwd_paths = phase_upconv_bwd_kernels(device)
    errs.update(bwd_errs)
    phases.start("phase 3c: the 5x5 ops' weight-gradient kernel "
                 "(conv5x5_s2_dw) vs its plain version at the main-path and "
                 "odd shapes (bf16 and f32), bit-identical twice; the chunked "
                 "workspaces at Cin·Co over 1 M; the input gradients "
                 "(conv5x5_s2_dx under every plan, its Function's second "
                 "order; the RGB layer's on deconv5x5_s2; the deconv's on "
                 "the conv) at the shapes the backward gives them")
    cdw_errs, cdw_paths = phase_conv_bwd_kernels(device)
    errs["upconv3x3_dw"].update(cdw_errs.pop("upconv3x3_dw"))
    errs.update(cdw_errs)
    bwd_paths += cdw_paths

    phases.start("phase 3d: the 3x3 stride-1 conv's kernels (conv3x3_act, "
                 "act_grad, conv3x3_dx, conv3x3_dw) vs their plain versions "
                 "at every "
                 "C-PGGAN 256 px and StackGAN Stage-II shape (bf16), "
                 "bit-identical twice; the second order through their "
                 "Functions")
    conv3x3_errs, k3_errs, k3_second = phase_conv3x3_kernels(device)
    errs.update(k3_errs)

    phases.start("phase 4: sampling path at flagship widths, batch 64, bf16")
    cfg, bundle, ts, gen, z, emb, launches, g_err = phase_main_path(device)
    launches_by_path = {"sampling": launches}

    phases.start(f"phase 5: training path (main.py --train loop) at flagship widths, "
                 f"batch 64, bf16, {TRAIN_TICKS} ticks")
    history, launches_by_path["training"], moved = phase_train_path(device, runs)

    phases.start("phase 6: one tick on the card vs the CPU (flagship widths, batch 8, "
                 "f32, TF32 off)")
    tick_vs_cpu = phase_card_vs_cpu(device)

    stackgan = {}
    sample_dir = os.path.join(ROOT, "chiprun_out", "samples")
    for model in ("stackgan_stage1", "stackgan_stage2"):
        phases.start(f"phase 4b: {model} sampling path (main.py) at full width, batch "
                     f"64, bf16")
        launches_by_path[f"{model} sampling"], sg_err = \
            phase_stackgan_sampling(device, model, sample_dir, runs)
        g_err.update(sg_err)
        phases.start(f"phase 5b: {model} training path (main.py --train) at full "
                     f"width, batch 64, bf16, {TRAIN_TICKS} ticks")
        s_history, launches_by_path[f"{model} training"], s_moved = \
            phase_train_path(device, runs, model)
        stackgan[model] = {"training_history": s_history,
                           "training_leaves_changed": s_moved}
        torch.cuda.empty_cache()
    phases.start("phase 6b: one Stage-II tick on the card vs the CPU (full width, "
                 "256 px, batch 4, f32, TF32 off)")
    stackgan["stackgan_stage2"]["tick_vs_cpu"] = phase_card_vs_cpu(
        device, "stackgan_stage2", batch_size=4, g_after_d_tol=1e-2,
        kink_share={"d": 2e-4, "g": 3e-3})
    torch.cuda.empty_cache()

    phases.start("phase 6c: the data, checkpoint and resume path: GAN-CLS from an "
                 "Oxford-102-sized StackGAN-format split (main.py --train, full width, "
                 "resident tier), stopped and resumed; Stage-II from a Stage-I run "
                 "directory; the tick through each data tier and the checkpoint's "
                 "save and restore, timed")
    data_ckpt = phase_data_checkpoint(device, runs)
    launches_by_path.update(data_ckpt["launches"])
    torch.cuda.empty_cache()

    phases.start("phase 9a: WGAN-CLS training path (main.py --train) at the full "
                 f"width of configs/wgancls_flowers.yml, batch 64, bf16, "
                 f"{TRAIN_TICKS} ticks")
    wgan = {}
    wgan["training_history"], launches_by_path["wgancls training"] = \
        phase_wgan_train(device, runs)
    phases.start("phase 9a: one critic update's gradients (GP included), kernel "
                 "critic vs plain critic on the card, full width, batch 64")
    wgan["critic_grads"] = phase_wgan_critic_grads(device)
    phases.start("phase 9a: one WGAN-CLS tick on the card vs the CPU (full width, "
                 "n_critic 1, batch 8, f32, TF32 off)")
    # one critic update: further updates compound the ±lr Adam steps of
    # round-off gradients (β1 = 0); the kink allowance as Stage-II's
    wgan["tick_vs_cpu"] = phase_card_vs_cpu(
        device, "wgancls", batch_size=8, g_after_d_tol=1e-3,
        kink_share={"d": 5e-4, "g": 3e-3}, overrides={"train.n_critic": 1})
    torch.cuda.empty_cache()

    flush = L2Flush(device)
    phases.start("phase 9b: upconv3x3_bias with lrelu vs its plain version at the "
                 "C-PGGAN shapes (bf16 and f32), timed")
    pg_errs, pg_upconv_rows = phase_pggan_upconv(device, flush)
    errs["upconv3x3"].update(pg_errs)
    phases.start(f"phase 9c: the C-PGGAN progression (main.py --train, "
                 f"configs/pggan_flowers.yml at full width, 5 stages × "
                 f"{PGGAN_TICKS_PER_STAGE} ticks)")
    pggan = {}
    pggan["progression"], launches_by_path["pggan progression"] = \
        phase_pggan_progression(device, runs)
    torch.cuda.empty_cache()
    phases.start("phase 9d: one stage-7 tick of configs/pggan_flowers_256.yml "
                 "(256 px, batch 32)")
    pggan["stage7_256px"], launches_by_path["pggan 256 px stage-7 tick"] = \
        phase_pggan_256(device, runs)
    torch.cuda.empty_cache()

    phases.start("phase 7: timing")
    rows, rates = phase_timing(device, cfg, bundle, ts, gen, z, emb)
    train_rows, bwd_rows = phase_train_timing(device, flush)
    rows.update(train_rows)
    rows["upconv3x3"] = phase_upconv_timing(device, flush)
    conv_256_rows = phase_conv_256_timing(device, flush)
    bn_rows = phase_bn_timing(device, flush)
    for name, step in BN_STEPS.items():
        every = [{**r[step], "shape": [r["shape"], r["streams"], r["act"]]}
                 for r in bn_rows]
        # one GAN-CLS generator forward (its four BN calls at batch 64), as
        # for deconv5x5_s2
        rows[name] = [e for e, r in zip(every, bn_rows)
                      if (tuple(r["shape"]), r["streams"], r["act"]) in
                      {(sh, 1, "relu") for sh in BN_SHAPES}]
        rows[f"{name} (every call)"] = every
    tick, (tts, tstep, tbatch) = phase_tick_timing(device)

    phases.start("phase 8: where a train-mode forward's and a tick's device time goes")
    profile = phase_profile(gen, ts, z, emb, device, rates["train_mode"])
    tick_profile = phase_tick_profile(tts, tstep, tbatch, tick["tick_ms"])
    no_library_conv5x5("GAN-CLS", tick_profile,
                       TICK_LAUNCHES["conv5x5_s2_dw"])
    del tts, tstep, tbatch
    torch.cuda.empty_cache()

    phases.start("phase 7b / 8b: StackGAN sampling rates, ticks and the Stage-II "
                 "tick's device time")
    for model, ticks in (("stackgan_stage1", 10), ("stackgan_stage2", 5)):
        rates[model] = phase_stackgan_rates(device, model)
        stackgan[model]["tick"], tick_state = phase_tick_timing(
            device, model, ticks)
        if model == "stackgan_stage2":
            stackgan[model]["tick_profile"] = phase_tick_profile(
                *tick_state, stackgan[model]["tick"]["tick_ms"])
        del tick_state
        torch.cuda.empty_cache()

    phases.start("phase 9e: WGAN-CLS and C-PGGAN stage-5 ticks, their device time, "
                 "and the gradient penalty's cost")
    for model, store in (("wgancls", wgan), ("pggan", pggan)):
        store["tick"], tick_state = phase_tick_timing(device, model)
        store["tick_profile"] = phase_tick_profile(*tick_state,
                                                   store["tick"]["tick_ms"])
        del tick_state
        torch.cuda.empty_cache()
    wcfg = train_config("wgancls").train
    no_library_conv5x5("WGAN-CLS", wgan["tick_profile"], wgan_tick_launches(
        wcfg.n_critic, wcfg.g_steps)["conv5x5_s2_dw"])
    wgan["gp_cost"] = phase_gp_cost(device)
    torch.cuda.empty_cache()

    card = card_name()
    phases.start(f"phase 10: Inception-score eval (main.py --eval-is: GAN-CLS with "
                 f"the SimpleCNN and with an InceptionV3 .npz, Stage-II), the card vs "
                 f"the CPU, TF32, the synthetic-quality protocol [{card}]")
    eval_is = phase_eval_is(device, runs, card)
    launches_by_path.update(eval_is.pop("launches"))
    torch.cuda.empty_cache()

    phases.start(f"phase 11: data parallelism on the card ({DP_RANKS} ranks sharing it "
                 f"over gloo, one rank over nccl, torchrun through main.py) [{card}]")
    data_parallel = phase_data_parallel(device, runs, flush)
    launches_by_path.update(data_parallel.pop("launches"))
    torch.cuda.empty_cache()

    phases.start(f"phase 12: entry() (GAN-CLS 64 px bf16, batch 16: the generator and "
                 f"D over three streams) on the kernels vs their plain versions "
                 f"[{card}]")
    entry_report = phase_entry(device)
    launches_by_path["entry()"] = entry_report["launches"]
    torch.cuda.empty_cache()
    phases.start(f"phase 13: dryrun_multichip({DRYRUN_DEVICES}): {DRYRUN_DEVICES} gloo "
                 f"ranks sharing the card, WGAN-CLS + GAN-INT f32 at tiny widths, stem "
                 f"and embed column-sharded over model")
    dryrun = phase_dryrun()
    phases.start("phase 14: python -m text_to_image_tpu_torch.bench (its defaults: "
                 "GAN-CLS 64 px, batch 64, bf16)")
    bench = phase_bench(card, rates)

    phases.start(f"phase 15: the scripts (convergence_check, chained_stackgan "
                          f"with --traj and --resume, stage2_dynamics, "
                          f"pggan_progression, profile_step, serve_profile, "
                          f"convert_inception, e2e_demo, parity_runbook) and "
                          f"bench_kernels (its defaults and --upconv --conv "
                          f"--deconv --conv3x3 --grad) [{card}]")
    scripts = phase_scripts(device, runs)
    launches_by_path.update(scripts.pop("launches"))
    phase_seconds = phases.stop()
    # upconv3x3_dx and upconv3x3_dw: the microbench's rows (phase 15, this
    # run) at the eight StackGAN shapes
    up_blocks = {f"{list(s)}->{co}" for s, co in
                 UPCONV_SHAPES["stage1"] + UPCONV_SHAPES["stage2"]}
    for name in ("upconv3x3_dx", "upconv3x3_dw"):
        rows[name] = [r for r in scripts["bench_kernels_grad"]["rows"]
                      if r["kernel"] == name and r["shape"] in up_blocks]
        check(len(rows[name]) == len(up_blocks), f"{name}: {rows[name]}")
    # conv5x5_s2_dw: the microbench's rows of one GAN-CLS tick's calls, the
    # D step's four convs at 3·64 and the generator's four deconvs at 64
    rows["conv5x5_s2_dw"] = [
        r for r in scripts["bench_kernels_grad"]["rows"]
        if r["kernel"] == "conv5x5_s2_dw"
        and (r["op"], r["batch"]) in (("conv", D_BATCH), ("deconv", BATCH))]
    check(len(rows["conv5x5_s2_dw"]) == 8, f"conv5x5_s2_dw rows "
                                          f"{rows['conv5x5_s2_dw']}")
    # conv5x5_s2_dx: the microbench's rows of one GAN-CLS tick's calls, the
    # D step's three deep convs at 3·64 and two G steps' three at 64
    rows["conv5x5_s2_dx"] = [
        r for r in scripts["bench_kernels_grad"]["rows"]
        if r["kernel"] == "conv5x5_s2_dx" and r["op"] == "conv"]
    check(len(rows["conv5x5_s2_dx"]) == 6, f"conv5x5_s2_dx rows "
                                          f"{rows['conv5x5_s2_dx']}")
    # deconv5x5_s2_dx: the microbench's rows of the generator's four
    # deconvs at 64 (two G steps a GAN-CLS tick), each route timed whole
    # beside cuDNN conv2d over the padded cotangent and its bound
    rows["deconv5x5_s2_dx"] = [
        r for r in scripts["bench_kernels_grad"]["rows"]
        if r["kernel"] == "deconv5x5_s2_dx" and r["op"] == "deconv"]
    check(len(rows["deconv5x5_s2_dx"]) == 4, f"deconv5x5_s2_dx rows "
                                            f"{rows['deconv5x5_s2_dx']}")
    for r in rows["deconv5x5_s2_dx"]:
        log(f"  deconv dx {r['shape']} [{r['path']}]: {r['ms']:.4f} ms, "
            f"cuDNN conv2d {r['library_ms']:.4f} "
            f"({r['ms'] / r['library_ms']:.2f}x), bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f}")

    # the 3×3 family: the microbench's rows of C-PGGAN stage 7's 3×3 calls,
    # each once
    for name in K3_OPS:
        rows[name] = [r for r in scripts["bench_kernels_grad"]["rows"]
                      if r["kernel"] == name and r.get("op") == "conv3x3"]
        check(len(rows[name]) == len(CONV3X3_SHAPES),
              f"{name} rows {rows[name]}")

    # no bf16 call of a main path on a pre-Hopper path: every table of
    # main-path calls this run recorded (the timing rows, the microbench's,
    # the backward kernels' at the main shapes, the stage-7 tick's upconv
    # calls read back from C)
    main_shapes = {(tuple(s), c) for s, c in (
        UPCONV_SHAPES["stage1"] + UPCONV_SHAPES["stage2"]
        + PGGAN_UPCONV_SHAPES + DX_CO32_B64)}
    main_tables = {
        **{f"timing {k}": v for k, v in rows.items()},
        **{f"backward timing {k}": v for k, v in bwd_rows.items()},
        "C-PGGAN upconv": [r for r in pg_upconv_rows if r["main_path"]],
        "256 px D": conv_256_rows,
        "up-block backward": [
            r for r in bwd_paths if r.get("dtype") == "bfloat16"
            and r["kernel"].startswith("upconv3x3")
            and (tuple(r["shape"][0]), r["shape"][1]) in main_shapes],
        "microbench": scripts["bench_kernels"]["rows"],
        "microbench --grad": scripts["bench_kernels_grad"]["rows"],
        "stage-7 tick": [r for r in pggan["stage7_256px"]["upconv_paths"]
                         if r["dtype"] == "bfloat16"]}
    stale = pre_hopper_calls(main_tables)
    log(f"  bf16 main-path calls on {PRE_HOPPER_PATHS}: {stale} (over "
        f"{sum(len(t) for t in main_tables.values())} recorded calls)")
    check(not stale, f"bf16 main-path calls on a pre-Hopper path: {stale}")

    src = "text_to_image_tpu_torch/"
    meta = {
        "deconv5x5_s2": ("cuda", src + "csrc/deconv5x5_s2.cu",
                         "text_to_image_tpu/ops/pallas/conv.py:146"),
        # the Pallas bn_act and the XLA statistics and backward around it
        # (text_to_image_tpu/ops/layers.py:147 batch_norm_act)
        "bn_stats": ("cuda", src + "csrc/batch_norm.cu",
                     "text_to_image_tpu/ops/pallas/fused.py:259"),
        "bn_act": ("cuda", src + "csrc/batch_norm.cu",
                   "text_to_image_tpu/ops/pallas/fused.py:259"),
        "bn_bwd_reduce": ("cuda", src + "csrc/batch_norm.cu",
                          "text_to_image_tpu/ops/pallas/fused.py:259"),
        "bn_bwd_apply": ("cuda", src + "csrc/batch_norm.cu",
                         "text_to_image_tpu/ops/pallas/fused.py:259"),
        "conv5x5_s2_act": ("cuda", src + "csrc/conv5x5_s2.cu",
                           "text_to_image_tpu/ops/pallas/conv.py:797"),
        "conditioning_join": ("cuda", src + "csrc/conditioning_join.cu",
                              "text_to_image_tpu/ops/pallas/fused.py:327"),
        "upconv3x3": ("cuda", src + "csrc/upconv3x3.cu",
                      "text_to_image_tpu/ops/pallas/conv.py:546"),
        # the parity adjoints of the Pallas op's custom VJP (_upconv_bwd
        # :647, _upconv_bias_bwd :690), which the JAX package leaves to XLA
        "upconv3x3_dx": ("cuda", src + "csrc/upconv3x3_bwd.cu",
                         "text_to_image_tpu/ops/pallas/conv.py:606"),
        "upconv3x3_dw": ("cuda", src + "csrc/upconv3x3_bwd.cu",
                         "text_to_image_tpu/ops/pallas/conv.py:624"),
        # the weight half of the Pallas conv's custom VJP (_conv_bwd :891;
        # with its operands swapped, the deconv's _deconv_bwd :233), which
        # the JAX package leaves to XLA
        "conv5x5_s2_dw": ("cuda", src + "csrc/conv5x5_s2_bwd.cu",
                          "text_to_image_tpu/ops/pallas/conv.py:891"),
        # the input half of the same custom VJP (_conv_bwd :891)
        "conv5x5_s2_dx": ("cuda", src + "csrc/conv5x5_s2_bwd.cu",
                          "text_to_image_tpu/ops/pallas/conv.py:891"),
        # the input half of the deconv's custom VJP (_deconv_bwd :233, the
        # linear transpose of _raw_deconv :227, left to XLA); its thin
        # path's kernel in csrc/down0.cuh
        "deconv5x5_s2_dx": ("cuda", src + "csrc/conv5x5_s2_bwd.cu",
                            "text_to_image_tpu/ops/pallas/conv.py:233"),
        # the 3×3 stride-1 SAME conv, its bias and activation, and the
        # adjoints XLA derives, which the JAX package leaves to
        # lax.conv_general_dilated (its layers.py conv2d :80)
        "conv3x3_act": ("cuda", src + "csrc/conv3x3.cu",
                        "text_to_image_tpu/ops/layers.py:80"),
        "conv3x3_dx": ("cuda", src + "csrc/conv3x3.cu",
                       "text_to_image_tpu/ops/layers.py:80"),
        "conv3x3_dw": ("cuda", src + "csrc/conv3x3.cu",
                       "text_to_image_tpu/ops/layers.py:80"),
        "act_grad": ("cuda", src + "csrc/conv3x3.cu",
                     "text_to_image_tpu/ops/layers.py:80"),
    }

    def per_unit(per, key):
        """deconv5x5_s2 and the four batch-norm kernels: one GAN-CLS
        generator forward (the sum over its four calls at batch 64; for
        bn_bwd_reduce and bn_bwd_apply the backward of those four calls).  conv5x5_s2_act and conditioning_join: one
        GAN-CLS tick's forward calls (the D step at 3·64 plus two G steps' D
        at 64).  upconv3x3: one Stage-II generator forward, its frozen
        Stage-I included (the sum over the eight calls at batch 64).
        upconv3x3_dx and upconv3x3_dw: the backward of a Stage-I and of a
        Stage-II G step (the same eight calls).  conv5x5_s2_dw: one GAN-CLS
        tick's calls (the D step's four at 3·64, two G steps' four deconvs
        at 64).  deconv5x5_s2_dx: one GAN-CLS tick's calls (two G steps'
        four deconvs at 64).  conv3x3_act, conv3x3_dx, conv3x3_dw and
        act_grad: each of C-PGGAN stage 7's 3×3 calls once."""
        return sum(r[key] * (1 if r.get("batch", D_BATCH) == D_BATCH
                             or r.get("op") == "conv3x3" else 2)
                   for r in per)

    # upconv3x3's co32 call (C-PGGAN 256 px's 128²×64→32 at batch 32,
    # phase 9b): its own time, bound and library time on the line
    co32_call = [r for r in pg_upconv_rows
                 if r["shape"] == [[32, 128, 128, 64], 32, "lrelu"]]
    check(len(co32_call) == 1 and co32_call[0]["path"] == "co32",
          f"the co32 call's row {co32_call}")
    kernels = []
    for name, (route, source, replaces) in meta.items():
        per = rows[name]
        ops_share = sum(r["bound_ms"] for r in per if r["bound_by"] == "operations")
        k3 = name in K3_OPS
        # the 3×3 family is counted in the stage-7 tick alone
        by_path = {k: p.get(name, 0) for k, p in launches_by_path.items()
                   if not k3 or name in p}
        err = max(v for (dt, _), v in errs[name].items()
                  if dt == torch.bfloat16)
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            # the 3×3 family's dx, dw and act_grad: relative to the largest
            # element of the plain version
            "max_abs_err": err if not k3 or name == "conv3x3_act" else None,
            "ms": per_unit(per, "ms"),
            "plain_ms": per_unit(per, "plain_ms"),
            "bound_ms": per_unit(per, "bound_ms"),
            "bound_by": ("operations" if ops_share * 2 > sum(
                r["bound_ms"] for r in per) else "bytes"),
            "library_ms": per_unit(per, "library_ms"),
            # the backwards through autograd of the Function that runs
            # the kernel (the up-block's for dx and dw)
            "max_grad_err_f32": None if k3 else max(
                v for k, v in grad_errs.items()
                if k.startswith("batch_norm_train" if name in BN_STEPS
                                else BWD_OF.get(name, name))),
            "shapes": (rows.get(f"{name} (every call)", per)
                       + bwd_rows.get(name, [])
                       + (pg_upconv_rows if name == "upconv3x3" else [])),
        })
        if k3:
            # bf16 alone: _Conv3x3 at first and second order against
            # autograd through the f32 plain version (phase 3d)
            kernels[-1]["max_rel_err"] = err
            kernels[-1]["max_grad_err_bf16"] = k3_second
            kernels[-1]["library_fallbacks"] = launches_by_path[
                "pggan 256 px stage-7 tick"]["conv3x3.library"]
        if name == "upconv3x3":
            kernels[-1]["co32_call"] = {
                "source": src + "csrc/upconv_co32.cuh",
                "replaces": "text_to_image_tpu/ops/pallas/conv.py:424",
                **{k: co32_call[0][k] for k in ("shape", "path", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}}

    # the data-parallel BN's two kernels: one GAN-CLS generator forward of a
    # rank of 2 (its four BN calls on the rank's half of batch 64)
    for name in ("bn_partials", "bn_finish"):
        per = [r[name] for r in data_parallel["bn_rows"]
               if (r["streams"], r["act"]) == (1, "relu")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": src + "csrc/batch_norm.cu",
            "replaces": "text_to_image_tpu/ops/pallas/fused.py:259",
            "launches": sum(p.get(name, 0) for p in launches_by_path.values()),
            "launches_by_path": {k: p.get(name, 0)
                                 for k, p in launches_by_path.items()},
            "max_abs_err": max(v for k, v in
                               data_parallel["errors"][name].items()
                               if k.startswith("bfloat16")),
            "ms": sum(r["ms"] for r in per),
            "plain_ms": sum(r["plain_ms"] for r in per),
            "bound_ms": sum(r["bound_ms"] for r in per), "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in per),
            "max_grad_err_f32": max(
                data_parallel["errors"]["synced_backward"].values()),
            "shapes": [{**r[name], "shape": [r["shape"], r["streams"],
                                             r["act"], r["ranks"]]}
                       for r in data_parallel["bn_rows"]]})

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": kernels,
              "kernel_errors": {f"{n} {str(dt)[6:]} {list(s)}": v
                                for n, d in errs.items()
                                for (dt, s), v in d.items()},
              "backward_errors_f32": grad_errs,
              "conv3x3_errors": conv3x3_errs,
              "generator_errors": g_err, "sampling_images_per_s": rates,
              "profile": profile, "training_history": history,
              "training_leaves_changed": moved, "tick_vs_cpu": tick_vs_cpu,
              "tick": tick, "tick_profile": tick_profile,
              "launches_by_path": launches_by_path, "stackgan": stackgan,
              "data_checkpoint": data_ckpt, "wgancls": wgan,
              "pggan": pggan, "eval_is": eval_is,
              "data_parallel": data_parallel, "entry": entry_report,
              "dryrun_multichip": dryrun, "bench": bench,
              "scripts": scripts, "phase_seconds": phase_seconds,
              "upconv3x3_pggan_shapes": pg_upconv_rows,
              "upconv3x3_bwd_paths": bwd_paths,
              "conv5x5_s2_act_256px_d": conv_256_rows,
              "conv5x5_s2_act_paths": conv_paths,
              "batch_norm_calls": bn_rows, "batch_norm_plans": bn_plans}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
