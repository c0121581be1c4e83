"""Smoke run of the PyTorch port (``imp_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (the run fails on the first error):

1. ``build``   — compile every Hopper kernel of ``imp_torch/csrc`` (one
   ``nvcc`` per source, all at once) and load it.
2. ``kernel``  — hold each kernel against its plain PyTorch version on the
   card and time it beside its bound, the plain version and, where one
   exists, the one PyTorch call that computes the same function
   (``library_ms``, a yardstick only): K1 (flash forward) at the serving
   shapes, the 10 000-patch bag envelope (a fully masked slide among
   them), TransMIL's 10 001-token bag, CMTA's (d = 32, a ragged mask) and
   a 4 096-token batch whose mask is no prefix at K1's own tile, with its
   3xTF32 bound beside the
   fp32-core figure of its first design;
   K2/K3 (flash backward) at TransMIL's bag, the bag envelope with a fully
   masked slide, UMEML_GAN's 17-token decoder, CMTA's bag and a 4 096-token
   batch whose
   mask is no prefix (key tiles alternately valid and masked, one valid key
   alone in a masked tile, and a ragged slide), with ``ptxas``'s registers
   and spills and each CTA's dynamic shared memory; K4/K5 (modularity degree
   and combined passes: a sweep of the upper triangle and a column
   reduction each, timed together) at the training batch of
   ``UMEML_GAN.yaml`` and at a batch with a fully masked slide, a second
   launch of each against the first bit for bit, with the 3xTF32 bound
   beside the fp32-core figure, ``ptxas`` and the shared memory; K6/K7
   (the fused Newton-Schulz pseudo-inverse, forward and backward) on
   softmax rows at UMEML's TransLayers (batch 2: 16 matrices of 128),
   UMEML_GAN's at batch 8 (64 of 128), TransMIL's (8 of 256) and CMTA's
   (8 of 128), with the
   fused mode's gradient against autograd through the chain of products,
   and the chain's own times.
3. ``serve_flash`` — the serving path: UMEML_GAN at the full width of
   ``configs/Survival/UMEML_GAN.yaml`` (hidden 256, bags padded to
   10 000 x 512, 1 000 genes in 6 groups, exported batch 8) with
   ``TPU.ATTENTION=flash``, exported (``export_model``: a ``torch.export``
   program, K1 as the operator ``imp_torch::flash_fwd``), loaded, run
   through ``ServingModel.predict_many`` and the HTTP server, with the
   launch counts read around that run; then the module rebuilt from the
   artifact (``rebuild_model``) through the plain attention on the card,
   and the latency of ``predict`` at batch 8.
4. ``serve_nystrom`` — the same at the default ``TPU.ATTENTION``, which
   launches no kernel; its logits are held against the same program moved
   to the CPU (``move_to_device_pass``), which launches nothing.
5. ``train``   — the training path: ``python -m imp_torch.tools.train``
   (in process) with MBTRAIN at the full width of ``UMEML_GAN.yaml``,
   batch 2, on 16 synthetic slides of 1 ... 10 000 patches, for 3 epochs
   (plain, GAN, GAN + replacement) with the CCA epochs between them; K4
   and K5 must launch once per main step and never in the CCA or eval
   passes; a checkpoint must reload; the C-index must be reported.
6. ``train_step`` — one main step with the kernels and with the plain
   modularity on the card (loss, modular loss, gradients of ``p_proto``
   and the omics encoder), then the step time at batch 8
   (``UMEML_GAN_THROUGHPUT.yaml``).
7. ``train_transmil`` — ``python -m imp_torch.tools.train --trainer
   TransMIL --config-file configs/Survival/TransMIL.yaml TPU.ATTENTION
   flash`` (feature 512, bags padded to 10 000, batch 1) on the same 16
   slides for 2 epochs: K1, K2 and K3 twice per train step, K1 twice and
   K2/K3 never per eval batch; a checkpoint must reload; then one step
   through the kernels against one through the plain flash attention
   (loss and every parameter gradient), and ``train_step_transmil``, the
   step time at the 10 001-token bag.
8. ``train_flash`` / ``train_step_flash`` — phases 5 and 6 under
   ``TPU.ATTENTION=flash`` (2 epochs, both with the GAN phase): K1 launches
   once per TransLayer call, K2 and K3 once per TransLayer call with grad
   (counted by a forward hook), never in eval; one step through the kernels
   against one through the plain flash attention.
9. ``train_umeml`` / ``train_step_umeml`` — the fully-paired UMEML
   (``configs/Survival/UMEML.yaml``: MBTRAIN's non-GAN path, batch 2) for 2
   epochs through the CLI with every Nyström pseudo-inverse fused: K6 once
   per TransLayer call, K7 once per call with grad and never in eval, K4/K5
   once per step; then one step through K6/K7 against one through the
   chain (same dropout draws), and the step time of both modes.
10. ``train_transmil_nystrom`` / ``train_step_transmil_nystrom`` — TransMIL
   at ``TPU.ATTENTION=auto`` (Nyström, 256 landmarks) with the fused mode
   through the CLI: K6 and K7 twice per train step, K6 twice per eval
   batch; one step fused against chain and the step time of both modes.
11. ``train_classification`` — ``python -m imp_torch.tools.train --trainer
   MBTRAIN --config-file configs/Classification/UMEML_GAN.yaml`` (bilinear
   fusion, 6 classes, the flagship's widths, batch 2) on the same 16 slides
   for 2 epochs (plain, then GAN, the CCA epoch between): K4/K5 once per
   main step and never in the CCA epoch or the evaluations, the accuracy /
   AUC / macro-F1 block, one importance row per test slide in
   ``test_{path,omic}.txt``, a strict reload of the last checkpoint.
12. ``train_step_tasks`` — one main step per task through the kernels
   against the plain versions (loss and every gradient), then its step time
   and device busy time: UMEML_GAN at Grading and at Subtyping (K4/K5),
   TransMIL at Subtyping under flash (K1-K3), UMEML at Classification with
   the fused pseudo-inverse (K6/K7 against the chain).
13. ``test_new`` — a one-epoch ``train`` on configs/Grading/UMEML_GAN.yaml,
   then ``python -m imp_torch.tools.test_new`` on a synthetic external
   cohort of 12 slides, 4 of them without a molecular CSV: those are served
   with ``without_omic = 1``, the accuracy is reported, and
   ``test_new_{path,omic}.txt`` hold 12 rows each.
14. ``train_zoo`` — the baseline zoo: each of the eight trainers (MCAT,
   CMTA, Porpoise, ConCAT, ADD, HFB, SNN, SNNM) for one epoch through
   ``python -m imp_torch.tools.train --config-file configs/Survival/X.yaml``
   on the same 16 slides (bags padded to 10 000 x 512, 1 000 genes, batch
   1, the default ``TPU.ATTENTION``: no kernel launch), and Porpoise at
   Classification (6 classes): losses finite, the metric line, a strict
   reload of the epoch's checkpoint; MCAT at ``OPTIM.GRAD_ACCUM 4`` makes
   one optimizer update per 4 steps and its parameters stay still between;
   HFB's BatchNorm statistics move and its reload gives the same eval
   logits.
15. ``train_cmta`` / ``train_cmta_nystrom`` — CMTA (configs/Survival/
   CMTA.yaml) for one epoch through the CLI under flash (K1 once per
   TransLayer call, 8 per step: 4 over the 10 001-token bag, 4 over the 6
   genomics tokens; K2/K3 once per call with grad, never in eval) and at
   ``auto`` with every pseudo-inverse fused (K6 8 per step at (g, m) =
   (8, 128), K7 8 per step with grad, K6 8 per eval batch).
16. ``train_step_cmta`` — one CMTA step (its alignment loss included) at the
   full 10 000-patch slide through the kernels against the plain versions:
   under flash against the plain flash attention, then its step time; fused
   against the chain, then the A/B of the two; each with
   :func:`float64_check`'s margins for the gradients float32 cannot
   resolve, the device busy time and the idle share.
17. ``clip_vit_b16`` — the ViT-B/16 image tower at full width (12 blocks of
   768, 12 heads, 197 tokens at 224 px; no kernel of ``csrc``: products and
   softmax are plain PyTorch, as the JAX towers use no Pallas kernel)
   through ``imp_torch.tools.clip_feature``'s per-slide encode loop: two
   slides of 512 synthetic uint8 patches at batch 32, in fp32 and in bf16;
   2 images' fp32 features against their float64 CPU replay, the bf16
   features' cosine to the fp32 ones, images/s and the share of the compute
   bound (:func:`vit_flops`) at batch 32, 64, 128 and 256, the loop's
   device-busy share and the peak memory.
18. ``clip_rn50`` — one batch of 8 through the RN50 ModifiedResNet tower at
   224 px (random running statistics) against its float64 CPU replay.
19. ``train_clipomic`` — ``python -m imp_torch.tools.train --trainer
   CLIPOMIC`` on each task's ``configs/<Task>/CLIPOMIC.yaml`` for one epoch
   at the full text width (12 blocks of 512, 8 heads, context 77,
   vocabulary 49 408), the tower loaded from a random OpenAI-layout
   ``MODEL.BACKBONE.CLIP_CHECKPOINT``: every frozen tensor keeps its bits,
   every trainable one moves, the checkpoint reloads strictly.
20. ``plip_umeml_gan`` — ``python -m imp_torch.tools.extract_prototypes`` on
   the card over seeded prompt embeddings in the order of
   ``prompts/prompt.json``, then MBTRAIN on UMEML_GAN.yaml's values for 2
   epochs with ``MODEL.UMEML.PROTO_INIT plip``: the initial prototypes are
   the file's, K4/K5 once per main step.
21. ``kernel_flash_bf16`` — K1-K3's bf16 entries (``TRAINER.PREC`` bf16: q,
   k, v in bf16; bias, dO, lse, delta and every output fp32) at TransMIL's
   bag, CMTA's masked bag and UMEML_GAN's batch-8 sequences: the same bits
   as the fp32 entries on ``.float()`` copies, within 1e-4 of the plain
   versions, timed beside their bounds (each product at the rate its
   operands need: Q·K^T at the bf16 peak, a product with one bf16 operand
   in 2 TF32 passes, P^T·dO in 3xTF32), the plain versions, SDPA on the
   widened operands and SDPA in bf16 (not the same function).
22. ``train_step_bf16`` — one bf16 step through the kernels against the
   same step through the plain versions (loss and every gradient within
   2e-2 of its max-abs, and no farther from the fp32 plain step than twice
   the plain bf16 step, plus 1e-4): UMEML_GAN at batch 8 under flash at
   ``bf16``, TransMIL at the 10 000-patch slide under flash at ``amp``;
   each step's time, device busy time, idle share and peak memory beside
   the same trainer's fp32 step.
23. ``train_bf16`` — the train CLI at ``TRAINER.PREC bf16``: UMEML_GAN under
   flash for 2 epochs (GAN on, the CCA epoch between, which runs fp32 as in
   JAX) with, per main step, the bf16 entries for the path decoder and the
   bottleneck and the fp32 ones for the omics encoders and decoder (JAX's
   dtype flow: an fp32 gene-group mask keeps the omics branch fp32), K2/K3
   per call with grad and K4/K5 once, K1 alone in evaluation,
   the C-index lines and fp32 checkpoints; CMTA under flash at ``fp16`` for
   one epoch (the bf16 entries 8 per step, K1's 8 per eval batch).
24. ``umeml_bsm`` — UMEML at batch 2 with ``DATASET.USE_BSM`` at
   ``BS_MICRO`` 512 (a 10 000-token bag in 20 chunks), the pseudo-inverse
   fused: one step at a fixed permutation through the kernels against the
   plain versions (STEP_TOL, or :func:`float64_check`), K4/K5 20 times and
   K6/K7 120 times per step, its step time.
25. ``umeml_gan_variants`` — UMEML_GAN at batch 8 under ``auto`` and flash:
   ``head_fused=False`` and ``stacked_pairs=True`` (twin weights stacked)
   within STEP_TOL of the default model in loss and every gradient,
   ``bag_dtype=bfloat16`` at the bf16 gate of phase 22 (its plain run and
   the fp32 default model for reference), ``MODEL.INIT_WEIGHTS`` from a
   checkpoint giving the same eval logits bit for bit, ``umeml_gan_plot``'s
   [B, 7, 7] similarity grids and the count of PNGs written (none where
   matplotlib is absent).
26. ``trace_sessions`` — how many primer kernel records each traced window
   lost (``imp_torch.utils.profiling.traced``: the profiler loses the first
   records of a session, the more the older the process).
27. ``kernel_flash_partial`` — K1-K3 under ring attention's per-chunk
   contract at TransMIL's bag (1, 8, 10 001, 64) with its 7 314 valid keys
   cut into 4 key chunks, the last without a valid key: K1 per chunk and
   the logsumexp merge against one K1 call and the plain version, K2/K3
   per chunk with the global lse and delta (dq summed, dk and dv
   concatenated) against one K2/K3 call and the plain backward, within
   KERNEL_TOL; dk = dv = 0 exactly on the empty chunk; 4 launches of each;
   per-hop times beside the one call's.
28. ``train_sp`` — two ranks of ``imp_torch.parallel.launch.spawn`` (NCCL
   on two cards, else both on card 0 over gloo with host-staged
   collectives; the row names the backend and the card count): one step
   each of TransMIL under flash at (data, seq) = (1, 2), gather and ring,
   bag 10 000 = 100²; UMEML_GAN at batch 8, bag 10 000 x 512, (1, 2)
   gather and ring; UMEML_GAN at (2, 1), batch 4 a rank.  Each step's loss
   and every gradient within STEP_TOL of the one-rank step on the card;
   for UMEML_GAN under sp, whose max over prototypes lets a gradient jump
   under rounding-level changes of the forward, a miss goes to
   :func:`sp_layout_check` (the mesh within STEP_TOL of the same layout
   on one rank, that layout's float64 replay equal to the one-rank
   model's, :func:`float64_rule` on the layout, the argmax flips
   counted); UMEML_GAN under flash at ``TRAINER.PREC bf16``, (1, 2)
   gather and ring, and TransMIL at ``amp``, (1, 2) ring, run K1-K3's bf16
   entries on every hop and on the gathered bag: the loss and every
   gradient within phase 22's bf16 gate of the one-rank bf16 step (the
   same trainer's fp32 step its reference; a UMEML_GAN miss goes to
   :func:`sp_layout_check_bf16`); HFB at (2, 1), batch 4 a rank, its
   BatchNorm taking the global batch's moments over ``data``: every
   gradient by :func:`float64_rule` against the one-rank step at batch 8,
   the running mean and variance and rank 0's eval logits within STEP_TOL,
   rank 0's state reloading strictly into the one-rank model; the launches
   per rank (the bf16 entries' too), each rank's peak memory and step
   time, and the plain sp modularity passes beside K4+K5.
29. ``kernel_flash_partial_bf16`` — phase 27 with q, k and v in bf16: K1-K3's
   bf16 entries per chunk (4 launches of each) against one bf16 call and
   the plain version on the same operands, within KERNEL_TOL; dk = dv = 0
   exactly on the empty chunk; per-hop times beside one call's.
30. ``clip_tp_pp`` — the ViT-B/16 tower at full width split over two
   ranks (NCCL on two cards, else both on card 0 over gloo): tensor
   parallel at tp = 2 (``imp_torch.parallel.tensor``) and pipeline parallel
   at pp = 2 with 4 microbatches (``imp_torch.parallel.pipeline``), in fp32
   and bf16, through ``clip_feature.encode_slide`` on seeded uint8 patches
   at batch 32: fp32 features within CLIP_TOL of the one-rank tower's and 2
   images of their float64 CPU replay, bf16 cosine to fp32 at least
   CLIP_BF16_COS; images/s, each rank's block-weight bytes and peak memory
   beside the one-rank tower's.
31. ``serve_export`` — serving from a checkpoint through the exported
   program: ``python -m imp_torch.tools.export_model`` (in process) with
   the trainer route and ``--check`` on phase 8's UMEML_GAN checkpoint
   (flash, its first test batch of 8 from a 40-slide tree, bag 10 000 x
   512) and phase 7's TransMIL checkpoint (flash, 10 001 tokens, batch 1):
   the served program within 1e-5 of the trainer's eval forward, K1 6 and
   2 times per served forward, the latency of ``predict`` at batch 8; a
   UMEML_GAN built with the fused pseudo-inverse at ``auto`` through
   ``export_model``: K6 once per Nyström layer per forward
   (``imp_torch::pinv_fwd``), within 1e-5 of the rebuilt module, and no
   launch with the program moved to the CPU; a Classification UMEML_GAN
   artifact over the HTTP host (a ragged request answered, ``risk``
   refused with 400).  It runs after phase 8.
32. ``protocol`` — the paper's five-fold protocol on the port:
   ``python -m imp_torch.tools.run_method`` (in process, on the seeded bags
   of the same 16 slides) with ``configs/Survival/UMEML_GAN.yaml`` as
   committed, seeds 1 and 2 at ``TPU.ATTENTION auto``, and
   ``configs/Classification/UMEML_GAN.yaml``, seed 1 under flash, 2
   epochs each (plain, then GAN + replacement, the CCA epoch between; one
   ``protocol_run`` line each): every seed's ``log.txt`` has its metric
   line after training and its last checkpoint, the parser's summary
   (``imp_torch.tools.parse_test_res``) is the mean and sd of the values
   the runs returned as the logs print them, K4/K5 once per main step and
   never outside one, K1 once per TransLayer call and K2/K3 once per call
   with grad on the flash seed; then ``imp_torch.tools.transform_molecular``
   on ``tests/fixtures/gdc`` in a process that cannot import pandas (its
   files equal the JAX tool's in ``expected/``) and
   ``imp_torch.tools.gen_configs`` into a tmp dir (equal to the 52
   committed ``configs/*/*.yaml``).  It runs after phase 20.
33. ``bench_tools`` — the port's bench tools, in process, at short
   settings (``imp_torch.utils.profiling`` is their timing harness and
   this script's): one ``imp_torch.tools.bench.build_step`` step at batch
   2 and full width (bags of 10 000 x 512, hidden 256, 3 360 genes) up to
   its main update through K4/K5 against the same under
   :func:`plain_modularity` (the loss and every gradient of the main
   update within STEP_TOL); ``bench`` at batch 8 (its JSON line has every
   field, K4/K5 once per step, its baseline written only in the run's tmp
   dir, ``bench_baseline.json`` untouched); ``ab_step --knob pinv --slots
   2 --iters 5`` (K6/K7 6 times a step in the fused arm, never in the
   chain's); ``bench_anatomy --iters 5`` (every section finite, with its
   device-busy ms; K4/K5 once a call of the full step and of the
   modularity pair); ``bench_flash --check`` at n 1 024 (fp32 within
   KERNEL_TOL of the dense attention, K1 once per forward, K2 and K3 once
   per backward, in fp32 and on the bf16 entries), then timed at its
   default envelope in fp32 and bf16 (K1 once a call);
   ``bench_pinv --check`` at (g, m) = (16, 128), (64, 128) and (8, 256);
   ``bench_vit --stage device`` at batch 32, fp32 and bf16.  It runs after
   phase 6.
Phases 27, 29, 28 and 30 run after phase 25, in that order.  ``python3
chip_smoke.py --sp-only`` on a host of two cards or more (four H100s joined
by NVLink) builds the kernels and runs ``train_sp`` and ``clip_tp_pp`` over
NCCL, then ``train_sp_cli``: ``torchrun --standalone --nproc-per-node
<cards>`` of the train CLI for one epoch, one card a rank (TransMIL at (1,
cards) ring, MBTRAIN at (cards / 2, 2) gather, and MBTRAIN under flash at
``TRAINER.PREC bf16``, (cards / 2, 2) ring; each rank runs this script with
``--rank-cli``, which serves the seeded bags), then ``clip_tools``: the
same torchrun of ``imp_torch.tools.clip_feature --tp <cards>`` and ``--pp
<cards>`` and of ``imp_torch.tools.clip_feature_dp`` on synthetic patches
(each rank runs this script with ``--rank-tool``, which reads the patches
with numpy and, where h5py is absent, writes the features with ``np.save``
and says so), each slide's features within CLIP_TOL of the one-card
tool's.
Phases 22-25 run after 16 and before the CLIP phases (17-20); phase 21
runs last, where the profiler loses the most records, then phase 26.
``train_step`` (phase 6) also times UMEML_GAN's batch-8 step with the fused
mode.  The fused mode has no cfg key (JAX's ``PINV_MODE`` is a module
global): the runs build their models fused with :func:`pinv_mode` around
the trainers' model builds, and run such a model through the chain under
:func:`chain_pinv`; each A/B runs its modes in turns (chain, fused, fused,
chain).

Then a ``kernels`` line (every ported kernel with its launches on its
main path: serving for K1, TransMIL training for K2/K3, MBTRAIN for
K4/K5 (with ``plip_launches``, their launches in ``plip_umeml_gan``), UMEML
training for K6/K7; K1-K3 each with a ``partial`` object: its launches and
times under the ring's per-chunk contract (phase 27) and its launches per
rank in train_sp's TransMIL steps, and a ``partial_bf16`` object: the same
for its bf16 entry (phase 29) with its launches per rank in train_sp's bf16
steps; each with a ``cmta`` object: its launches
in CMTA's epoch under flash (K1-K3) or fused (K6/K7) and its times at CMTA's
shape, K1-K3 at (1, 8, 10 001, 32), K6/K7 at (8, 128); K1-K3 each with a ``bf16`` object: its bf16 entry's launches in
``train_bf16`` and its times at TransMIL's bag; K2 and K3 each with its own device time
and plain version, no library call, and a ``pair`` object that times dq,
dk and dv together through the wrapper, the plain backward and SDPA's
backward, with the name of SDPA's backward kernel from the trace; K6 and K7 with a ``chain`` object, the times of the unrolled
products they replace), the card's name and power limit from
``nvidia-smi``, and last ``{"ok": true, "device": {...}}``.  Weights are
random, from a seed.  K1 and K6 also carry a ``program`` object: their
launches per served forward through phase 31's programs.  Every kernel
carries ``protocol_launches``, its launches in phase 32's runs.  Without a CUDA
card the script exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from imp_torch.utils.profiling import (
    TRACE_PRIMERS, TRACE_SESSIONS, TRACE_SHORT, card_line, cuda_ms, device_busy_ms, device_ms,
    device_ms_by, device_rows, profiled, time_step,
)

DEVICE = "cuda"
SERVE_BATCH = 8  # the exported batch: configs/Survival/UMEML_GAN_THROUGHPUT.yaml
SEED = 0
# the card's published peaks (H100 SXM data sheet, dense, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
#: fp32-accurate products on the tensor cores: 3xTF32 (big.big + big.small +
#: small.big) takes three TF32 products for one
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BF16_FLOPS = 989e12
#: the tensor cores' rate for a product by how many of its two operands are
#: bf16: both (exact as one bf16 product with fp32 accumulation), one (exact
#: in TF32, so its low split is zero: 2 TF32 passes), none (3xTF32)
PRODUCT_PEAK = {2: PEAK_BF16_FLOPS, 1: PEAK_TF32_FLOPS / 2, 0: PEAK_3XTF32_FLOPS}
#: exps on the special-function units: 16 a clock per SM (CUDA C++
#: Programming Guide, arithmetic instruction throughput, compute capability
#: 9.0) x 132 SMs x 1.98 GHz, the boost clock behind ``PEAK_FP32_FLOPS``
#: (16 896 cores x 2 x 1.98 GHz)
PEAK_SFU_OPS = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12
# kernel vs plain on one card, fp32, different summation order
KERNEL_TOL = 1e-4
# logits through the kernel vs through the plain attention, one card
SERVE_TOL = 1e-4
# Nyström logits on the card vs the CPU: the Newton-Schulz pseudo-inverse
# amplifies rounding (the JAX package's own torch parity test holds 2e-3)
CROSS_DEVICE_TOL = 2e-3

KERNEL_INFO = {
    "flash_fwd": {
        "route": "cuda",
        "source": "imp_torch/csrc/flash_fwd.cu",
        "replaces": "imp_tpu/ops/flash_attention.py:46",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "imp_torch/csrc/flash_bwd.cu",
        "replaces": "imp_tpu/ops/flash_attention.py:104",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "imp_torch/csrc/flash_bwd.cu",
        "replaces": "imp_tpu/ops/flash_attention.py:144",
    },
    "modularity_deg": {
        "route": "cuda",
        "source": "imp_torch/csrc/modularity.cu",
        "replaces": "imp_tpu/ops/modularity.py:261",
    },
    "modularity_combined": {
        "route": "cuda",
        "source": "imp_torch/csrc/modularity.cu",
        "replaces": "imp_tpu/ops/modularity.py:135",
    },
    "pinv_fwd": {
        "route": "cuda",
        "source": "imp_torch/csrc/pinv.cu",
        "replaces": "imp_tpu/ops/pinv_kernel.py:73",
    },
    "pinv_bwd": {
        "route": "cuda",
        "source": "imp_torch/csrc/pinv.cu",
        "replaces": "imp_tpu/ops/pinv_kernel.py:83",
    },
}

#: configs/Survival/UMEML_GAN.yaml as typed values (the card's host needs
#: no YAML parser)
FLAGSHIP = {
    "DATASET.NAME": "TCGA_Glioma_S_UMEML",
    "DATASET.FEATURE_NAME": "features_clip_vit_b16",
    "DATASET.TYPE": "Survival",
    "DATASET.SURVIVAL_ENDPOINT": "DSS",
    "DATASET.MODALITY": "pathology",
    "DATASET.BAG_PAD": 10000,
    "DATASET.PATH.FEATURE": "conch",
    "DATASET.PATH.SAMPLE": False,
    "DATASET.PATH.NUM": 4096,
    "DATASET.PATH.DIM": 512,
    "DATASET.OMIC.TYPE": "all",
    "DATASET.OMIC.PATHWAY": "combine",
    "DATASET.OMIC.DIM": 1000,
    "TASK.NAME": "Survival",
    "TASK.LOSS": "nllsurvloss_new",
    "DATALOADER.TRAIN.BATCH_SIZE": 2,
    "DATALOADER.TEST.BATCH_SIZE": 2,
    "DATALOADER.NUM_WORKERS": 8,
    "LOSS.ALPHA": 0.5,
    "LOSS.REDUCTION": "mean",
    "OPTIM.NAME": "adam",
    "OPTIM.LR": 2e-4,
    "OPTIM.WEIGHT_DECAY": 1e-4,
    "OPTIM.STEPSIZE": (4000,),
    "OPTIM.MAX_EPOCH": 10,
    "OPTIM.ADAM_BETA1": 0.9,
    "OPTIM.ADAM_BETA2": 0.999,
    "OPTIM.MOMENTUM": 0.9,
    "OPTIM.LR_SCHEDULER": "cosine",
    "OPTIM.WARMUP_EPOCH": 1,
    "OPTIM.WARMUP_TYPE": "linear",
    "OPTIM.WARMUP_CONS_LR": 1e-5,
    "TRAIN.PRINT_FREQ": 100,
    "TEST.EVALUATOR": "Survival_UMEML",
    "MODEL.NAME": "umeml_gan",
    "MODEL.FUSION": "concat",
    "MODEL.SIZE": "small",
    "MODEL.DROPOUT": 0.25,
    "MODEL.PROJECT_DIM": 256,
    "MODEL.HIDDEN_DIM": 256,
    "MODEL.NUM_CLUSTERS": 10,
    "MODEL.UMEML.PROTOTYPES": 6,
    "MODEL.UMEML.REGISTERS": 3,
    "MODEL.UMEML.ALPHA": 5.0,
    "TRAINER.PREC": "fp32",
}
#: what configs/Survival/UMEML_GAN_THROUGHPUT.yaml changes
THROUGHPUT = {"DATALOADER.TRAIN.BATCH_SIZE": 8, "DATALOADER.TEST.BATCH_SIZE": 8, "OPTIM.LR": 8e-4}
TRANSMIL_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "Survival", "TransMIL.yaml")
LOG_DIR = os.path.join("output", "chip_smoke")  # the trainers' logs (gitignored)


def _set(cfg, values: dict):
    """Set dotted keys of ``cfg`` and freeze it."""
    for key, value in values.items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        setattr(node, leaf, value)
    cfg.freeze()
    return cfg


def flagship_cfg(attention: str = "auto", **overrides):
    """UMEML_GAN.yaml's config (plus ``overrides``, dotted keys), frozen."""
    from imp_torch.config import get_cfg_default

    return _set(get_cfg_default(), {**FLAGSHIP, "TPU.ATTENTION": attention, **overrides})


def yaml_cfg(path: str, **overrides):
    """The config of the YAML file ``path`` (plus ``overrides``), frozen."""
    from imp_torch.config import get_cfg_default

    cfg = get_cfg_default()
    cfg.merge_from_file(path)
    return _set(cfg, overrides)


def transmil_cfg(**overrides):
    """TransMIL.yaml under ``TPU.ATTENTION=flash`` (plus ``overrides``, which
    may set another attention), frozen."""
    return yaml_cfg(TRANSMIL_YAML, **{"TPU.ATTENTION": "flash", **overrides})


def flagship_opts(**overrides) -> list:
    """UMEML_GAN.yaml's values as the ``KEY VALUE`` list of the train CLI."""
    return [str(x) for k, v in {**FLAGSHIP, **overrides}.items() for x in (k, v)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what) -> None:
    """Fail the run unless ``ok`` (an ``assert`` would vanish under -O)."""
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    # name, B, H, N, d, valid keys per slide (None = no mask; see key_valid)
    ("serve_b8_n7", 8, 8, 7, 32, None),  # omic encoders + decoders, batch B
    ("serve_b16_n14", 16, 8, 14, 32, None),  # bottleneck encoders, batch 2B
    ("bag_n10000_d32", 3, 8, 10000, 32, (10000, 7313, 0)),
    ("bag_n10000_d64", 3, 8, 10000, 64, (10000, 7313, 0)),
    ("transmil_n10001_d64", 1, 8, 10001, 64, (7314,)),  # TransMIL: 7 313 patches + cls
    ("tiles_n4096_d64", 2, 8, 4096, 64, ("tiles", 4001)),  # a mask that is no prefix
    ("cmta_n10001_d32", 1, 8, 10001, 32, (7314,)),  # CMTA's bag encoder: 7 313 patches + cls
]
#: launches of each serving shape in one eval forward
FLASH_PER_FORWARD = {"serve_b8_n7": 4, "serve_b16_n14": 2}


#: the products of K1-K3 (2 FLOPs per (query, key) pair and dim each) by
#: their operands: q, k and v in the entry's dtype, P, dS and dO in fp32
FLASH_PRODUCTS = {
    "flash_fwd": (("q", "k"), ("p", "v")),
    "flash_bwd_dq": (("q", "k"), ("do", "v"), ("ds", "k")),
    "flash_bwd_dkv": (("q", "k"), ("do", "v"), ("p", "do"), ("ds", "q")),
}


def flash_bound_ms(kernel: str, pairs: int, d: int, nbytes: float, dtype: str) -> tuple:
    """The larger of the operations (``kernel``'s products, each at the
    rate its operands need (``PRODUCT_PEAK``; q, k, v are bf16 where
    ``dtype`` is ``"bf16"``), or one exp per pair on the special-function
    units, whichever takes longer) and the bytes at the memory rate, in ms,
    and which one it is."""
    narrow = {"q", "k", "v"} if dtype == "bf16" else set()
    products = sum(2 * pairs * d / PRODUCT_PEAK[sum(o in narrow for o in operands)]
                   for operands in FLASH_PRODUCTS[kernel])
    terms = {"operations": max(products, pairs / PEAK_SFU_OPS), "bytes": nbytes / PEAK_BYTES}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def flash_fwd_bounds(b, h, n, d, valid, dtype: str = "fp32") -> dict:
    """The least time for K1 on this call's work (:func:`flash_bound_ms`):
    QK^T and PV, one exp per pair; q, k, v (in ``dtype``: fp32 or bf16),
    bias read once and O, lse (fp32) written once.
    Pairs count the keys the data needs: a slide's valid keys (``valid``:
    counts per slide), or all of them where none is valid (O is then the
    mean of V).  ``bound_fp32_cores_ms`` is the same work with the products
    on the fp32 CUDA cores, the route of K1's first design."""
    keys = b * n if valid is None else sum(v if v else n for v in valid)
    pairs = h * n * keys
    operand_bytes = 2 if dtype == "bf16" else 4
    nbytes = (3 * operand_bytes + 4) * b * h * n * d + 4 * (b * n + b * h * n)
    bound, by = flash_bound_ms("flash_fwd", pairs, d, nbytes, dtype)
    return {"bound_ms": bound, "bound_by": by,
            "bound_fp32_cores_ms": bound_ms(4 * pairs * d + pairs, nbytes)[0]}


def tf32x3_bound_ms(flops: float, exps: float, nbytes: float) -> tuple:
    """The larger of the operations (products of ``flops`` in 3xTF32 on the
    tensor cores, or ``exps`` on the special-function units, whichever takes
    longer) and the bytes at the memory rate, in ms, and which one it is."""
    terms = {"operations": max(flops / PEAK_3XTF32_FLOPS, exps / PEAK_SFU_OPS),
             "bytes": nbytes / PEAK_BYTES}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def bound_ms(ops: float, nbytes: float) -> tuple:
    """The larger of the operations at the fp32 peak and the bytes at the
    memory rate, in ms, and which one it is."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernel(card: str, build_report: dict):
    """K1 against its plain version on the card: O on every slide and lse on
    slides with a valid key within ``KERNEL_TOL``; timed by events (``ms``)
    and in the trace (``kernel_device_ms``) beside its bound, the plain
    version and SDPA's forward on the same inputs and mask."""
    import torch
    import torch.nn.functional as F

    from imp_torch import kernels
    from imp_torch.ops.flash_attention import (
        NEG_INF, flash_attention_fwd, flash_attention_reference, flash_fwd_layout,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in fp32
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {}
    for name, b, h, n, d, specs in FLASH_SHAPES:
        q, k, v = (torch.randn(b, h, n, d, device=DEVICE, generator=g) for _ in range(3))
        q = q * d**-0.5
        layout = flash_fwd_layout(d)  # the tile and shared memory the kernel launches with
        if specs is None:
            bias, valid = torch.zeros(b, n, device=DEVICE), None
        else:
            keep = torch.stack([key_valid(n, spec, DEVICE, layout["tile"]) for spec in specs])
            bias = torch.where(keep, 0.0, NEG_INF)
            valid = [int(c) for c in keep.sum(dim=1).tolist()]
        with torch.no_grad():
            o, lse = flash_attention_fwd(q, k, v, bias)
            o_ref, lse_ref = flash_attention_reference(q, k, v, bias)
            torch.cuda.synchronize()
            has_key = (bias == 0).any(dim=1)
            err_o = (o - o_ref).abs().max().item()
            err_lse = (lse[has_key] - lse_ref[has_key]).abs().max().item()
            finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
            iters = 200 if n < 100 else 10
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, bias), iters)
            plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, bias), iters)
            dev_ms = device_ms(lambda: flash_attention_fwd(q, k, v, bias), "flash_fwd_kernel",
                               iters=min(iters, 20))
            mask4 = bias[:, None, None, :]
            lib_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4, scale=1.0),
                iters,
            )
        bounds = flash_fwd_bounds(b, h, n, d, valid)
        row = {
            "phase": "kernel", "kernel": "flash_fwd", "shape": name, "card": card,
            "B": b, "H": h, "N": n, "d": d, "valid": valid, "mask": specs,
            "max_abs_err_o": err_o, "max_abs_err_lse": err_lse, "tol": KERNEL_TOL,
            "finite": finite, "ms": ms, "kernel_device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, **bounds,
            "share_of_bound": bounds["bound_ms"] / (dev_ms or ms),
            "dynamic_smem_bytes": layout["flash_fwd"],
            "ptxas": ptxas_lines(build_report, "flash_fwd.cu"),
        }
        emit(row)
        require(finite and err_o <= KERNEL_TOL and err_lse <= KERNEL_TOL,
                f"flash_fwd disagrees with its plain version at {name}: {row}")
        require(row["share_of_bound"] <= 1.0,
                f"flash_fwd beats its bound at {name}: the bound is wrong: {row}")
        rows[name] = row
        del q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    kernels.reset_launches()  # the comparison launches do not count
    return rows


BWD_SHAPES = [
    # name, B, H, N, d, valid keys per slide (None = no mask; see key_valid)
    ("transmil_n10001_d64", 1, 8, 10001, 64, (7314,)),  # (a) TransMIL's bag
    ("bag_n10000_d32", 3, 8, 10000, 32, (10000, 7313, 0)),  # (b) one slide fully masked
    ("umeml_b8_n17_d32", 8, 8, 17, 32, None),  # (c) UMEML_GAN's decoder at batch 8
    ("tiles_n4096_d64", 2, 8, 4096, 64, ("tiles", 4001)),  # (d) a mask that is no prefix
    ("cmta_n10001_d32", 1, 8, 10001, 32, (7314,)),  # (e) CMTA's bag encoder
]
BWD_MAIN_SHAPE = "transmil_n10001_d64"
#: the flash shape of CMTA's bag TransLayers (its genomics ones run 6 tokens)
CMTA_FLASH_SHAPE = "cmta_n10001_d32"


def key_valid(n: int, spec, device, tile=None):
    """The valid keys of one slide: a prefix of ``spec`` keys, or, for
    ``"tiles"``, key tiles of ``tile`` (the kernel's own: ``flash_fwd_layout``
    for K1, ``flash_bwd_layout`` for K2/K3) alternately valid and masked,
    with one valid key alone inside a masked tile (K1 and K2 skip a tile by
    a vote over its biases, K3 zero-fills it, never from a length)."""
    import torch

    keys = torch.arange(n, device=device)
    if spec != "tiles":
        return keys < spec
    valid = (keys // tile) % 2 == 0
    valid[3 * tile + 17] = True
    return valid


def flash_bwd_bounds(b, h, n, d, valid, dtype: str = "fp32") -> dict:
    """The least time for K2 and K3 on this call's work
    (:func:`flash_bound_ms`): K2's three products and K3's four, one exp
    per pair; q, k, v (in ``dtype``: fp32 or bf16), dO, bias, lse and delta
    (fp32) read once and the fp32 gradients written once. Pairs count the
    keys the data needs: a slide's valid keys (``valid``: counts per
    slide), or all of them where none is valid (P = 1 on every key there)."""
    keys = b * n if valid is None else sum(v if v else n for v in valid)
    pairs = h * n * keys
    operand_bytes = 2 if dtype == "bf16" else 4
    inputs = (3 * operand_bytes + 4) * b * h * n * d + 4 * (b * n + 2 * b * h * n)
    return {
        "flash_bwd_dq": flash_bound_ms("flash_bwd_dq", pairs, d,
                                       inputs + 4 * b * h * n * d, dtype),
        "flash_bwd_dkv": flash_bound_ms("flash_bwd_dkv", pairs, d,
                                        inputs + 8 * b * h * n * d, dtype),
    }


def partial_bounds(b, h, nq, d, chunks, chunk_valid, dtype: str = "fp32") -> dict:
    """The least time of K1 and of K2 then K3 on each hop of the ring
    (:func:`flash_bound_ms`), from the chunk shapes: every query against
    one key chunk; pairs count the chunk's valid keys; K1 reads q, the
    chunk's k, v and bias once and writes O and lse once; K2 and K3 each
    read q, k, v, dO, bias, lse and delta once, K2 writes dq, K3 dk and dv.
    A chunk with no valid key needs no pair and no read of its k and v: its
    merge weight in the ring is 0 and its dk, dv are 0.  A ring's bound is
    the sum of its hops' (they run one after another); its pairs are those
    of one call over the whole mask."""
    op = 2 if dtype == "bf16" else 4
    fwd, bwd = [], []
    for nk, valid in zip(chunks, chunk_valid):
        pairs = h * nq * b * valid
        q_bytes, kv_bytes = op * b * h * nq * d, 2 * op * b * h * nk * d * (valid > 0)
        fwd.append(flash_bound_ms("flash_fwd", pairs, d, q_bytes + kv_bytes + 4 * b * nk
                                  + 4 * b * h * nq * (d + 1), dtype))
        inputs = q_bytes + kv_bytes + 4 * b * nk + 4 * b * h * nq * (d + 2)
        dq = flash_bound_ms("flash_bwd_dq", pairs, d, inputs + 4 * b * h * nq * d, dtype)
        dkv = flash_bound_ms("flash_bwd_dkv", pairs, d, inputs + 8 * b * h * nk * d, dtype)
        bwd.append((dq[0] + dkv[0], dq[1] if dq[1] == dkv[1] else "operations"))
    return {
        "fwd_hop_ms": [ms for ms, _ in fwd], "fwd_ring_ms": sum(ms for ms, _ in fwd),
        "fwd_by": sorted({by for _, by in fwd}),
        "bwd_hop_ms": [ms for ms, _ in bwd], "bwd_ring_ms": sum(ms for ms, _ in bwd),
        "bwd_by": sorted({by for _, by in bwd}),
        "covers": "K1 per hop; K2 and K3 together per hop",
    }


def sdpa_bwd_ms(q, k, v, bias, do, iters: int):
    """The backward of ``scaled_dot_product_attention`` on the same fp32
    inputs and mask: fwd + bwd minus fwd (a yardstick only), and the name of
    the device kernel that takes the most of the backward's time in the
    trace (it says which backend ran), None where the trace has none."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    mask4 = bias[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask4, scale=1.0)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qg, kg, vg), do)

    with torch.enable_grad():
        ms = cuda_ms(fwd_bwd, iters, warmup=1) - cuda_ms(fwd, iters, warmup=1)
        fwd_names = {e.key for e in device_rows(profiled(fwd, 1))}
        bwd_rows = [e for e in device_rows(profiled(fwd_bwd, 1)) if e.key not in fwd_names]
    top = max(bwd_rows, key=lambda e: e.self_device_time_total, default=None)
    return ms, None if top is None else top.key


#: the CUDA kernel that each backward kernel's trace rows are named after
BWD_KERNEL_SYMBOL = {"flash_bwd_dq": "dq_kernel", "flash_bwd_dkv": "dkv_kernel"}


def phase_flash_bwd(card: str, build_report: dict):
    """K2 and K3 against their plain versions on the card, and timed.  Both
    run in one ``flash_attention_bwd`` call, so the events time the pair
    (``pair``: dq, dk and dv, with the plain and SDPA backwards that compute
    the same three) and each kernel's own ``ms`` is its device time in the
    trace of that call.  Where a slide has a valid key, its masked keys must
    get dk = dv = 0 exactly (P = 0; K3 zero-fills a fully masked tile)."""
    import torch

    from imp_torch import kernels
    from imp_torch.ops.flash_attention import (
        NEG_INF, flash_attention_bwd, flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq_reference, flash_attention_bwd_reference, flash_attention_reference,
        flash_bwd_layout,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products in fp32
    plain = {"flash_bwd_dq": flash_attention_bwd_dq_reference,
             "flash_bwd_dkv": flash_attention_bwd_dkv_reference}

    rows = {}
    for name, b, h, n, d, specs in BWD_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        q, k, v, do = (torch.randn(b, h, n, d, device=DEVICE, generator=g) for _ in range(4))
        q = q * d**-0.5
        layout = flash_bwd_layout(d)  # the tile and shared memory the kernels launch with
        if specs is None:
            bias, valid = torch.zeros(b, n, device=DEVICE), None
        else:
            keep = torch.stack([key_valid(n, spec, DEVICE, layout["tile"]) for spec in specs])
            bias = torch.where(keep, 0.0, NEG_INF)
            valid = [int(c) for c in keep.sum(dim=1).tolist()]
        with torch.no_grad():
            o, lse = flash_attention_reference(q, k, v, bias)
            delta = (do * o).sum(-1)
            del o
            args = (q, k, v, bias, do, lse, delta)
            got = flash_attention_bwd(*args)
            ref = flash_attention_bwd_reference(*args)
            torch.cuda.synchronize()
            errs = {f"{g_}_rel": rel_err(a, r) for g_, a, r in zip(("dq", "dk", "dv"), got, ref)}
            abs_err = {"flash_bwd_dq": (got[0] - ref[0]).abs().max().item(),
                       "flash_bwd_dkv": max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))}
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            masked = (bias < 0) & (bias == 0).any(dim=1, keepdim=True)
            masked_zero = all(bool((t.transpose(1, 2)[masked] == 0).all()) for t in got[1:])
            del got, ref
            torch.cuda.empty_cache()
            iters = 100 if n < 100 else 5

            def wrapper():
                return flash_attention_bwd(*args)

            pair = {
                "covers": "dq, dk and dv: K2 then K3 in one flash_attention_bwd call",
                "ms": cuda_ms(wrapper, iters),
                "plain_ms": cuda_ms(lambda: flash_attention_bwd_reference(*args), min(iters, 3),
                                    warmup=1),
            }
            times = {kn: (device_ms(wrapper, sym, iters=min(iters, 20)),
                          cuda_ms(lambda: plain[kn](*args), min(iters, 3), warmup=1))
                     for kn, sym in BWD_KERNEL_SYMBOL.items()}
        pair["library_ms"], pair["library_kernel"] = sdpa_bwd_ms(q, k, v, bias, do, min(iters, 3))
        bounds = flash_bwd_bounds(b, h, n, d, valid)
        for kname, (ms, plain_ms) in times.items():
            require(ms is not None, f"the trace holds no device time for {kname} at {name}")
            bound, bound_by = bounds[kname]
            row = {
                "phase": "kernel", "kernel": kname, "shape": name, "card": card,
                "B": b, "H": h, "N": n, "d": d, "valid": valid, "mask": specs, **errs,
                "max_abs_err": abs_err[kname], "tol_rel": KERNEL_TOL, "finite": finite,
                "masked_keys_zero": masked_zero, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None,  # no one PyTorch call computes dq alone, or dk and dv alone
                "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
                "pair": pair, "dynamic_smem_bytes": layout[kname],
                "ptxas": ptxas_lines(build_report, "flash_bwd.cu"),
            }
            emit(row)
            rows[(kname, name)] = row
            require(row["share_of_bound"] <= 1.0,
                    f"{kname} beats its bound at {name}: the bound is wrong: {row}")
        require(finite and masked_zero and max(errs.values()) <= KERNEL_TOL,
                f"flash backward disagrees with its plain version at {name}: {errs}, "
                f"masked keys zero: {masked_zero}")
        del q, k, v, do, bias, lse, delta, args
        torch.cuda.empty_cache()
    kernels.reset_launches()  # the comparison launches do not count
    return rows


MOD_SHAPES = [
    # name, B, N, valid lengths, prototype counts (p_proto, h_omic)
    ("train_b2_n10000", 2, 10000, (10000, 7313), (6, 7)),  # UMEML_GAN.yaml's training batch
    ("masked_b3_n10000", 3, 10000, (10000, 7313, 0), (6, 7)),  # one slide fully masked
]
MOD_MAIN_SHAPE = "train_b2_n10000"
MOD_TEMP = 0.1
HIDDEN = 256


def modularity_bounds(b, n, d, lengths, p_counts, tile=64) -> dict:
    """The least time for each pass over this batch, counted over the upper
    triangle of (i, j) pairs within each slide's valid length, as the
    kernels sweep it: the largest of four terms.  ``products``: a d-deep dot
    product (2d FLOPs) per pair, fp32-accurate on the tensor cores
    (3xTF32).  ``chain``: the rest on the fp32 cores, per pair the ReLU and
    the sum for K4; for K5 the scaling by 1/e (3) and, per set of P
    prototypes, P products, P - 1 compares, s1, q, the weight and the dC
    select-adds (2P + 10).  ``tanh``: one per pair and set on the
    special-function units.  ``bytes``: x read once, outputs written once,
    and the column-side partials of every off-diagonal tile pair written and
    read once (1 vector of ``tile`` floats for K4, sum(P) for K5).  Returns
    per kernel ``bound_ms``, ``bound_by``, the terms (``bound_terms_ms``)
    and ``bound_fp32_cores_ms``: the products and the chain on the fp32
    cores, the route of the first design."""
    pairs = sum(m * (m + 1) // 2 for m in lengths)
    tile_pairs = sum((v := -(-m // tile)) * (v - 1) // 2 for m in lengths)
    x_bytes = 4 * b * n * d
    c_bytes = 4 * b * n * sum(p_counts)
    chain = {"modularity_deg": 2, "modularity_combined": 3 + sum(2 * p + 10 for p in p_counts)}
    nbytes = {
        "modularity_deg": x_bytes + 4 * b * n + 2 * 4 * tile_pairs * tile,
        "modularity_combined": (x_bytes + 2 * c_bytes + 4 * b * n + 4 * b
                                + 2 * 4 * tile_pairs * tile * sum(p_counts)),
    }
    out = {}
    for name in chain:
        terms = {
            "products": pairs * 2 * d / PEAK_3XTF32_FLOPS * 1e3,
            "chain": pairs * chain[name] / PEAK_FP32_FLOPS * 1e3,
            "tanh": pairs * len(p_counts) / PEAK_SFU_OPS * 1e3 if name == "modularity_combined" else 0.0,
            "bytes": nbytes[name] / PEAK_BYTES * 1e3,
        }
        top = max(terms, key=terms.get)
        out[name] = {"bound_ms": terms[top], "bound_by": "bytes" if top == "bytes" else "operations",
                     "bound_terms_ms": terms,
                     "bound_fp32_cores_ms": bound_ms(pairs * (2 * d + chain[name]), nbytes[name])[0]}
    return out


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (norm-wise relative error)."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


MOD_KERNEL_SYMBOLS = {  # every kernel each wrapper launches: the sweep, then the column reduction
    "modularity_deg": ("deg_kernel", "deg_reduce_kernel"),
    "modularity_combined": ("combined_kernel", "combined_reduce_kernel"),
}


def phase_modularity(card: str, build_report: dict):
    """K4 and K5 against their plain versions on the card, a second launch
    of each against the first (bit for bit), and timed: events around the
    wrapper (``ms``) and the device time of every kernel it launches."""
    import torch

    from imp_torch import kernels
    from imp_torch.ops import modularity as M

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in fp32
    rows = {}
    for name, b, n, lengths, p_counts in MOD_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        x = torch.randn(b, n, HIDDEN, device=DEVICE, generator=g)
        valid = torch.arange(n, device=DEVICE)[None, :] < torch.tensor(lengths, device=DEVICE)[:, None]
        protos = [torch.randn(b, p, HIDDEN, device=DEVICE, generator=g) for p in p_counts]
        with torch.no_grad():
            norm_x, cs = M._prepare(protos, x, valid)
            lens = M._valid_lengths(norm_x)
            deg = M.deg_cuda(norm_x, lens)
            deg_ref = M.degree_reference(norm_x)
            e = deg_ref.sum(dim=1).clamp_min(1e-12)
            inv_e = (1.0 / e).contiguous()
            s1, q, dcs = M.combined_cuda(norm_x, cs, deg_ref, inv_e, MOD_TEMP, lens)
            s1_ref, q_ref, dcs_ref = M.combined_reference(norm_x, cs, deg_ref, inv_e, MOD_TEMP)
            torch.cuda.synchronize()
            # traces (s1 - q/e)/e cancel: their error is read against the
            # size of the two terms
            scale = torch.maximum((s1_ref / e).abs(), (q_ref / e / e).abs()).max()
            trace_abs = ((s1 - q / e) / e - (s1_ref - q_ref / e) / e).abs().max()
            trace_err = (trace_abs / scale).item()
            errs = {
                "modularity_deg": {"deg_rel": rel_err(deg, deg_ref),
                                   "max_abs_err": (deg - deg_ref).abs().max().item()},
                "modularity_combined": {
                    "s1_rel": rel_err(s1, s1_ref), "q_rel": rel_err(q, q_ref),
                    "trace_rel": trace_err,
                    "dC_rel": max(rel_err(a, r) for a, r in zip(dcs, dcs_ref)),
                    # what reaches the loss: the traces and dC (s1 and q
                    # are sums of ~1e8 terms; their error is read relative)
                    "max_abs_err": max([trace_abs.item()]
                                       + [(a - r).abs().max().item() for a, r in zip(dcs, dcs_ref)]),
                },
            }
            finite = bool(torch.isfinite(deg).all() and all(torch.isfinite(d).all() for d in dcs))
            masked_zero = all(deg[i].abs().max().item() == 0.0 and
                              all(d[i].abs().max().item() == 0.0 for d in dcs)
                              for i, m in enumerate(lengths) if m == 0)
            # no atomics: a second launch on the same input gives the same bits
            again = M.combined_cuda(norm_x, cs, deg_ref, inv_e, MOD_TEMP, lens)
            same_bits = {
                "modularity_deg": bool(torch.equal(M.deg_cuda(norm_x, lens), deg)),
                "modularity_combined": bool(
                    torch.equal(again[0], s1) and torch.equal(again[1], q)
                    and all(torch.equal(a, r) for a, r in zip(again[2], dcs))),
            }
            del again
            calls = {
                "modularity_deg": (lambda: M.deg_cuda(norm_x, lens),
                                   lambda: M.degree_reference(norm_x)),
                "modularity_combined": (
                    lambda: M.combined_cuda(norm_x, cs, deg_ref, inv_e, MOD_TEMP, lens),
                    lambda: M.combined_reference(norm_x, cs, deg_ref, inv_e, MOD_TEMP)),
            }
            times = {kname: (cuda_ms(fn, 10), device_ms_by(fn, MOD_KERNEL_SYMBOLS[kname], iters=5),
                             cuda_ms(plain, 3, warmup=1))
                     for kname, (fn, plain) in calls.items()}
        bounds = modularity_bounds(b, n, HIDDEN, lengths, p_counts)
        layout = M.modularity_layout(n, HIDDEN, len(p_counts))
        for kname in ("modularity_deg", "modularity_combined"):
            ms, by_kernel, plain_ms = times[kname]
            require(all(v is not None for v in by_kernel.values()),
                    f"the trace holds no device time for a kernel of {kname} at {name}: {by_kernel}")
            dev_ms = sum(by_kernel.values())
            row = {
                "phase": "kernel", "kernel": kname, "shape": name, "card": card,
                "B": b, "N": n, "D": HIDDEN, "valid": lengths, "P": p_counts,
                **errs[kname], "tol_rel": KERNEL_TOL, "finite": finite,
                "masked_slide_zero": masked_zero, "same_bits_twice": same_bits[kname],
                "ms": ms, "kernel_device_ms": dev_ms, "kernel_device_ms_by": by_kernel,
                "plain_ms": plain_ms, "library_ms": None, **bounds[kname],
                "share_of_bound": bounds[kname]["bound_ms"] / dev_ms,
                "tile": layout["tile"], "workspace_bytes": 4 * b * layout["slots"] * layout["tile"]
                * (1 if kname == "modularity_deg" else sum(p_counts)),
                "dynamic_smem_bytes": layout[kname],
                "ptxas": ptxas_lines(build_report, "modularity.cu"),
            }
            emit(row)
            rels = [v for k, v in errs[kname].items() if k.endswith("_rel")]
            require(finite and masked_zero and max(rels) <= KERNEL_TOL,
                    f"{kname} disagrees with its plain version at {name}: {row}")
            require(same_bits[kname], f"{kname}: two launches on the same input differ at {name}")
            require(row["share_of_bound"] <= 1.0,
                    f"{kname} beats its bound at {name}: the bound is wrong: {row}")
            rows[(kname, name)] = row
        del x, norm_x, cs, deg, deg_ref, dcs, dcs_ref
        torch.cuda.empty_cache()
    kernels.reset_launches()  # the comparison launches do not count
    return rows


PINV_SHAPES = [
    # name, g (= batch x 8 heads), m (landmarks = TransLayer width / 2)
    ("umeml_b2_m128", 16, 128),  # UMEML's TransLayers at UMEML.yaml's batch 2
    ("umeml_gan_b8_m128", 64, 128),  # (a) UMEML_GAN's encode TransLayers at batch 8
    ("transmil_m256", 8, 256),  # (b) TransMIL's two TransLayers
    ("cmta_m128", 8, 128),  # (c) CMTA's eight TransLayers, batch 1
]
CMTA_PINV_SHAPE = "cmta_m128"
PINV_MAIN_SHAPE = "umeml_b2_m128"
PINV_ITERS = 6
PINV_KERNEL_SYMBOL = {"pinv_fwd": "pinv_fwd_kernel", "pinv_bwd": "pinv_bwd_kernel"}


def pinv_products(iters=PINV_ITERS) -> dict:
    """The m x m products each function needs: K6 4 per step; K7 the
    forward's but the last (their y, t1, t3 and mm feed the reverse sweep)
    and 8 adjoint products per reverse step."""
    return {"pinv_fwd": 4 * iters, "pinv_bwd": 4 * iters - 1 + 8 * iters}


#: the products K7 does as written: 4 per replayed step but the last, and 11
#: per reverse step (it recomputes y, t3 and mm from each stashed z_i)
PINV_BWD_KERNEL_PRODUCTS = 4 * (PINV_ITERS - 1) + 11 * PINV_ITERS


def pinv_bounds(g, m, iters=PINV_ITERS) -> dict:
    """The least time for K6 and K7 on g m x m matrices: the products each
    function needs (2 m^3 FLOPs each, :func:`pinv_products`) in 3xTF32 on
    the tensor cores, against x (and g_out) read once and z (or dx and dcp)
    written once; ``bound_fp32_cores_ms`` is the same work with the products
    on the fp32 CUDA cores, the route of the first design."""
    products = pinv_products(iters)
    product = 2 * m**3 * g
    nbytes = {"pinv_fwd": 4 * (2 * g * m * m + 1), "pinv_bwd": 4 * (3 * g * m * m + g + 1)}
    out = {}
    for name, n in products.items():
        bound, by = tf32x3_bound_ms(n * product, 0, nbytes[name])
        out[name] = {"bound_ms": bound, "bound_by": by,
                     "bound_fp32_cores_ms": bound_ms(n * product, nbytes[name])[0]}
    return out


def ptxas_lines(report: dict, source: str) -> list:
    """The ``ptxas`` lines of one source's build: registers, shared memory
    and spills per kernel."""
    return [line.strip() for line in report[source]["ptxas"].splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def phase_pinv(card: str, build_report: dict):
    """K6 and K7 against their plain versions on the card, a second launch
    of each against the first (bit for bit), the fused mode's gradient
    against autograd through the chain, and the times of each: the kernels'
    device time from the trace, the plain versions', and the chain's forward
    and forward + backward (the path they replace); with the launch layout
    the built library reports (``pinv_layout``)."""
    import torch

    from imp_torch import kernels
    from imp_torch.ops import pinv as P
    from imp_torch.ops.attention import moore_penrose_pinv

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in true fp32
    rows = {}
    for name, g, m in PINV_SHAPES:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        # softmax rows of seeded scores: conditioned like a Nystrom attn2
        x = torch.softmax(torch.randn(g, m, m, device=DEVICE, generator=gen), dim=-1)
        g_out = torch.randn(g, m, m, device=DEVICE, generator=gen)

        def grad_of(mode):
            xg = x.detach().clone().requires_grad_()
            with torch.enable_grad():
                z = moore_penrose_pinv(xg, PINV_ITERS, mode)
                return torch.autograd.grad((z * g_out).sum(), xg)[0]

        with torch.no_grad():
            c = P.norm_scalar(x)
            z, (dx, dcp) = P.pinv_fwd(x, c), P.pinv_bwd(x, c, g_out)
            z_ref, (dx_ref, dcp_ref) = P.pinv_fwd_reference(x, c), P.pinv_bwd_reference(x, c, g_out)
            torch.cuda.synchronize()
            errs = {
                "pinv_fwd": {"z_rel": rel_err(z, z_ref),
                             "max_abs_err": (z - z_ref).abs().max().item()},
                "pinv_bwd": {"dx_rel": rel_err(dx, dx_ref), "dcp_rel": rel_err(dcp, dcp_ref),
                             "dc_rel": rel_err(dcp.sum(), dcp_ref.sum()),
                             "max_abs_err": max((dx - dx_ref).abs().max().item(),
                                                (dcp.sum() - dcp_ref.sum()).abs().item()),
                             "max_abs_ref": dx_ref.abs().max().item()},
            }
            finite = all(bool(torch.isfinite(t).all()) for t in (z, dx, dcp))
            # no atomics: a second launch on the same input gives the same bits
            dx2, dcp2 = P.pinv_bwd(x, c, g_out)
            same_bits = {"pinv_fwd": bool(torch.equal(P.pinv_fwd(x, c), z)),
                         "pinv_bwd": bool(torch.equal(dx2, dx) and torch.equal(dcp2, dcp))}
            del dx2, dcp2
        fused_vs_chain = rel_err(grad_of("fused"), grad_of("chain"))
        with torch.no_grad():
            times = {
                "pinv_fwd": (device_ms(lambda: P.pinv_fwd(x, c), "pinv_fwd_kernel", iters=10),
                             cuda_ms(lambda: P.pinv_fwd(x, c), 10),
                             cuda_ms(lambda: P.pinv_fwd_reference(x, c), 10)),
                "pinv_bwd": (device_ms(lambda: P.pinv_bwd(x, c, g_out), "pinv_bwd_kernel", iters=5),
                             cuda_ms(lambda: P.pinv_bwd(x, c, g_out), 5),
                             cuda_ms(lambda: P.pinv_bwd_reference(x, c, g_out), 5, warmup=1)),
            }
            chain = {
                "covers": "moore_penrose_pinv: the normaliser and 6 steps of unrolled products",
                "fwd_ms": cuda_ms(lambda: moore_penrose_pinv(x, PINV_ITERS, "chain"), 10),
                "fused_fwd_ms": cuda_ms(lambda: moore_penrose_pinv(x, PINV_ITERS, "fused"), 10),
            }
        chain["fwd_bwd_ms"] = cuda_ms(lambda: grad_of("chain"), 5, warmup=1)
        chain["fused_fwd_bwd_ms"] = cuda_ms(lambda: grad_of("fused"), 5, warmup=1)
        bounds = pinv_bounds(g, m)
        layout = P.pinv_layout(m, PINV_ITERS)
        for kname in ("pinv_fwd", "pinv_bwd"):
            ms, event_ms, plain_ms = times[kname]
            require(ms is not None, f"the trace holds no device time for {kname} at {name}")
            kernel_products = (PINV_BWD_KERNEL_PRODUCTS if kname == "pinv_bwd"
                               else pinv_products()[kname])
            waves = -(-g // layout[kname]["clusters_at_once"])  # clusters run in turns
            row = {
                "phase": "kernel", "kernel": kname, "shape": name, "card": card, "g": g, "m": m,
                "iters": PINV_ITERS, **errs[kname], "fused_vs_chain_grad_rel": fused_vs_chain,
                "tol_rel": KERNEL_TOL, "finite": finite, "same_bits_twice": same_bits[kname],
                "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
                "library_ms": None,  # no one PyTorch call runs Newton-Schulz steps
                **bounds[kname], "share_of_bound": bounds[kname]["bound_ms"] / ms,
                "share_of_fp32_bound": bounds[kname]["bound_fp32_cores_ms"] / ms,
                "bound_products": pinv_products()[kname], "kernel_products": kernel_products,
                "cluster": layout["cluster"], "threads": layout["threads"],
                "dynamic_smem_bytes": layout[kname]["smem_bytes"],
                "clusters_at_once": layout[kname]["clusters_at_once"], "waves": waves,
                # what one cluster spends on each of its band products, run in turn
                "us_per_product": 1e3 * ms / waves / kernel_products,
                "workspace_bytes": 4 * g * layout[kname]["ws_floats"],
                "chain": chain, "ptxas": ptxas_lines(build_report, "pinv.cu"),
            }
            emit(row)
            rows[(kname, name)] = row
            require(same_bits[kname], f"{kname}: two launches on the same input differ at {name}")
            require(row["share_of_bound"] <= 1.0,
                    f"{kname} beats its bound at {name}: the bound is wrong: {row}")
        rels = [v for e in errs.values() for k, v in e.items() if k.endswith("_rel")]
        require(finite and max(rels) <= KERNEL_TOL and fused_vs_chain <= KERNEL_TOL,
                f"K6/K7 disagree with their plain versions or the chain at {name}: {errs}, "
                f"fused vs chain gradient {fused_vs_chain}")
        del x, g_out, z, dx, dcp, z_ref, dx_ref, dcp_ref
        torch.cuda.empty_cache()
    kernels.reset_launches()  # the comparison launches do not count
    return rows


# ---------------------------------------------------------------------------
# phases 3-4: serving
# ---------------------------------------------------------------------------

SLIDE_LENGTHS = (1, 10000, 2048, 517, 7313, 300, 9999, 4096, 64, 1500, 10000, 777)


def make_slides(rng, lengths, feat_dim, num_genes):
    bags = [rng.normal(size=(n, feat_dim)).astype(np.float32) for n in lengths]
    mol = rng.lognormal(size=(len(lengths), num_genes)).astype(np.float32)
    without = np.zeros(len(lengths), np.float32)
    without[2] = 1.0  # one slide without omics: the generator imputes it
    return {"img": bags, "mol": mol, "without_omic": without}


@contextlib.contextmanager
def plain_attention():
    """Route the flash wrappers (forward and backward) to their plain
    versions on the card, so the same model can be run through both."""
    import imp_torch.ops.flash_attention as fa

    saved = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_reference
    fa.flash_attention_bwd = fa.flash_attention_bwd_reference
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved


@contextlib.contextmanager
def pinv_mode(mode: str):
    """Build the Nyström models with ``pinv_mode=mode`` while inside: the
    registered builders of UMEML, UMEML_GAN, TransMIL and CMTA get it bound
    (it has no cfg key, as JAX's ``PINV_MODE`` has none)."""
    from imp_torch.engine import fusion_trainers  # noqa: F401  (registers cmta)
    from imp_torch.models import MODEL_REGISTRY

    names = ("umeml", "umeml_gan", "transmil", "cmta")
    saved = {n: MODEL_REGISTRY.get(n) for n in names}
    for n, builder in saved.items():
        MODEL_REGISTRY.register_as(n, force=True)(functools.partial(builder, pinv_mode=mode))
    try:
        yield
    finally:
        for n, builder in saved.items():
            MODEL_REGISTRY.register_as(n, force=True)(builder)


def fused_pinvs(model) -> int:
    """How many Nyström pseudo-inverses of ``model`` are fused."""
    from imp_torch.ops.attention import NystromAttention

    return sum(isinstance(m, NystromAttention) and m.pinv_mode == "fused" for m in model.modules())


@contextlib.contextmanager
def chain_pinv():
    """Route the fused pseudo-inverse to the chain of products while inside,
    as :func:`plain_attention` routes the flash wrappers, so a model built
    fused runs both ways."""
    import imp_torch.ops.attention as A

    saved = A.pinv_newton_schulz
    A.pinv_newton_schulz = lambda x, iters, batch_axis: A.moore_penrose_pinv(
        x, iters, "chain", batch_axis)
    try:
        yield
    finally:
        A.pinv_newton_schulz = saved


def pairs_of(model, batch):
    """The bottleneck's greedy path/omic pairs for ``batch``, per row."""
    import torch

    seen = {}

    def hook(_m, args):
        seen["pairs"] = torch.cat(greedy_pairs(model, args), dim=1)

    handle = model.bottleattn.register_forward_pre_hook(hook)
    try:
        with torch.no_grad():
            out = model(batch)
    finally:
        handle.remove()
    return out, seen["pairs"]


def http_checks(artifact, device, req_slides, served):
    """/health, one ragged /predict with risk, one malformed request."""
    from imp_torch.serving import make_http_server, survival_risk

    server = make_http_server(artifact, port=0, device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        require(r.status == 200 and health["status"] == "ok", health)
        body = {
            "batch": {
                "img": [b.tolist() for b in req_slides["img"]],
                "mol": req_slides["mol"].tolist(),
            },
            "risk": True,
        }
        req = urllib.request.Request(base + "/predict", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            resp = json.loads(r.read())
        want = served.predict({"img": req_slides["img"], "mol": req_slides["mol"]})
        logits = np.asarray(resp["outputs"]["logits"], np.float32)
        http_err = float(np.abs(logits - want["logits"]).max())
        risk_err = float(np.abs(np.asarray(resp["risk"]) - survival_risk(want["logits"])).max())
        bad = {"batch": {"img": [[[0.0] * 3]], "mol": [[0.0] * 10]}}
        req = urllib.request.Request(base + "/predict", data=json.dumps(bad).encode())
        try:
            urllib.request.urlopen(req, timeout=60)
            bad_status = 200
        except urllib.error.HTTPError as e:
            bad_status = e.code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    require(http_err <= 1e-5 and risk_err <= 1e-5, (http_err, risk_err))
    require(bad_status == 400, f"malformed request answered {bad_status}")
    return {"health": 200, "predict": 200, "malformed": bad_status,
            "http_vs_direct_err": http_err, "risk_err": risk_err}


def latency(served, rng, num_genes, reps: int = 30, breakdown: bool = True):
    """Host-clock latency of ``predict`` on full batches of 8 slides (pad,
    copy to the card, forward, copy back), and where its time goes unless
    ``breakdown`` is off."""
    import torch

    batch = make_slides(rng, SLIDE_LENGTHS[:SERVE_BATCH], served.manifest["feat_dim"], num_genes)
    for _ in range(3):
        served.predict(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        served.predict(batch)  # returns numpy: the device work is done
        times.append(time.perf_counter() - t0)
    t = np.asarray(times) * 1e3
    percentiles = {
        "predict_p50_ms": float(np.percentile(t, 50)),
        "predict_p99_ms": float(np.percentile(t, 99)),
        "slides_per_s": SERVE_BATCH * reps / float(t.sum() / 1e3),
        "reps": reps,
    }
    if not breakdown:
        return percentiles

    # where one predict's time goes: host padding, the copy to the card, the
    # forward on the card (events), and how much of it keeps the card busy
    pads = []
    for _ in range(5):
        t0 = time.perf_counter()
        img, mask = served._pad_bags(batch["img"])
        pads.append(time.perf_counter() - t0)
    host = {
        "img": img, "img_mask": mask, "mol": batch["mol"],
        "without_omic": batch["without_omic"],
        "insample_without_omic": np.zeros((SERVE_BATCH, num_genes), np.int32),
        "omic_means": served._aux["omic_means"],
    }
    host = {k: host.get(k, np.zeros(v["shape"], v["dtype"]))
            for k, v in served.manifest["batch_keys"].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    forward_ms = cuda_ms(lambda: served.call(tb), iters=10)
    forward_busy = device_busy_ms(lambda: served.call(tb))
    predict_busy = device_busy_ms(lambda: served.predict(batch), iters=3)
    p50 = percentiles["predict_p50_ms"]
    return {
        **percentiles,
        "breakdown": {
            "pad_ms": float(np.median(pads)) * 1e3,
            "h2d_ms": h2d_ms,
            "forward_ms": forward_ms,
            "forward_device_busy_ms": forward_busy,
            "predict_device_busy_ms": predict_busy,
            "device_idle_share": None if predict_busy is None else 1.0 - predict_busy / p50,
        },
    }


def phase_serve(attention: str, card: str, tmp: str):
    import torch

    from imp_torch import kernels
    from imp_torch.models import build_model, survival_num_classes
    from imp_torch.serving import (
        even_gene_groups, export_model, load_model, mbtrain_batch_template, rebuild_model,
    )

    cfg = flagship_cfg(attention)
    num_genes = cfg.DATASET.OMIC.DIM
    groups = even_gene_groups(num_genes, cfg.MODEL.UMEML.PROTOTYPES)
    model = build_model(
        cfg.MODEL.NAME, cfg=cfg, num_classes=survival_num_classes(cfg.TASK.NAME, 0),
        gene_group_indexes=groups, device=DEVICE,
        generator=torch.Generator().manual_seed(SEED),
    )
    rng = np.random.default_rng(SEED)
    omic_means = rng.lognormal(size=num_genes).astype(np.float32)
    artifact = os.path.join(tmp, f"umeml_gan_{attention}")
    t0 = time.perf_counter()
    export_model(model, cfg, mbtrain_batch_template(cfg, SERVE_BATCH, num_genes),
                 artifact, omic_means)
    export_s = time.perf_counter() - t0
    del model
    served = load_model(artifact, device=DEVICE)
    feat_dim = cfg.DATASET.PATH.DIM
    slides = make_slides(rng, SLIDE_LENGTHS, feat_dim, num_genes)
    req_slides = make_slides(rng, (2048, 1, 1200), feat_dim, num_genes)

    # ---- the main path: counts at 0 just before, read just after ----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = served.predict_many(slides)
    many_s = time.perf_counter() - t0
    http = http_checks(artifact, DEVICE, req_slides, served)
    torch.cuda.synchronize()
    counts = kernels.launches()
    forwards = -(-len(SLIDE_LENGTHS) // SERVE_BATCH) + 2  # predict_many + HTTP + its check
    flash = served.manifest["attention"] == "flash"
    expect = 6 * forwards if flash else 0
    require(counts["flash_fwd"] == expect,
            f"flash_fwd launches {counts['flash_fwd']} != {expect} ({attention})")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    logits = out["logits"]
    require(logits.shape == (len(SLIDE_LENGTHS), 4), logits.shape)
    n_proto = cfg.MODEL.UMEML.PROTOTYPES
    for key in ("importance_path", "importance_omic"):
        require(out[key].shape == (len(SLIDE_LENGTHS), n_proto), (key, out[key].shape))
    require(all(np.isfinite(v).all() for v in out.values()), "non-finite serving output")

    # ---- the same model through the reference path -------------------------
    model = rebuild_model(artifact, DEVICE)  # the live module: params.pt + config
    full = {k: v[:SERVE_BATCH] for k, v in slides.items()}
    img, mask = served._pad_bags(full["img"])
    tb = {
        "img": img, "img_mask": mask, "mol": full["mol"], "without_omic": full["without_omic"],
        "insample_without_omic": np.zeros((SERVE_BATCH, num_genes), np.int32),
        "omic_means": omic_means,
    }
    tb = {k: torch.from_numpy(v).to(DEVICE) for k, v in tb.items()}
    check = {}
    if flash:
        got, pairs = pairs_of(model, tb)
        with plain_attention():
            ref, ref_pairs = pairs_of(model, tb)
        same = (pairs == ref_pairs).all(dim=1)
        same = (same[:SERVE_BATCH] & same[SERVE_BATCH:]).cpu().numpy()  # both passes
        require(same.any(), "kernel vs plain: every slide paired its tokens differently")
        # a near-tie can flip a greedy pair between the two attention paths;
        # such slides are reported apart and left out of the numeric check
        err = float(np.abs(got["logits"].cpu().numpy() - ref["logits"].cpu().numpy())[same].max())
        check = {"vs": "plain attention on the card", "max_abs_err_logits": err,
                 "pairing_mismatch_rows": int((~same).sum()), "tol": SERVE_TOL}
        require(err <= SERVE_TOL, f"kernel vs plain serving logits: {check}")
    else:
        # the program moved to the CPU (torch.export.passes.move_to_device_pass)
        cpu = load_model(artifact, device="cpu")
        kernels.reset_launches()
        ref = cpu.predict(full)
        cpu_launches = sum(kernels.launches().values())
        with torch.no_grad():
            got = model(tb)
        err = float(np.abs(got["logits"].cpu().numpy() - ref["logits"]).max())
        check = {"vs": "the same artifact's program moved to the CPU", "max_abs_err_logits": err,
                 "tol": CROSS_DEVICE_TOL, "cpu_launches": cpu_launches}
        require(err <= CROSS_DEVICE_TOL and cpu_launches == 0,
                f"card vs CPU serving logits: {check}")
    direct_err = float(np.abs(got["logits"].cpu().numpy() - logits[:SERVE_BATCH]).max())
    require(direct_err <= 1e-5, f"predict_many vs the rebuilt module's forward: {direct_err}")

    row = {
        "phase": f"serve_{served.manifest['attention']}", "attention_cfg": attention,
        "card": card, "slides": len(SLIDE_LENGTHS), "bag_lengths": list(SLIDE_LENGTHS),
        "batch": SERVE_BATCH, "bag_pad": served.bag_pad, "num_genes": num_genes,
        "hidden": cfg.MODEL.HIDDEN_DIM, "launches": counts,
        "export_s": export_s, "program_bytes": os.path.getsize(os.path.join(artifact, "model.pt2")),
        "predict_many_s": many_s, "peak_device_gib": peak_gib,
        "http": http, "check": check, **latency(served, rng, num_genes),
    }
    emit(row)
    return row, counts


#: slides of the serving tree: its test fold 1 holds 8, the exported batch
SERVE_TREE_SLIDES = 40
#: the served program against the trainer's eval forward (``--check``)
EXPORT_TOL = 1e-5


def export_cli(argv) -> tuple:
    """``python -m imp_torch.tools.export_model argv`` in process, on the
    seeded bags: (manifest with ``check_max_abs_diff``, seconds, log)."""
    from imp_torch.tools.export_model import run

    console = io.StringIO()
    t0 = time.perf_counter()
    with seeded_bags(), contextlib.redirect_stdout(console):
        manifest = run(argv)
    return manifest, time.perf_counter() - t0, console.getvalue()


def launches_per_forward(served, batch) -> dict:
    """The kernel launches of one ``predict`` of a batch at the exported
    size (one forward of the program); the counts are set to 0 just before
    and read just after."""
    import torch

    from imp_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    served.predict(batch)
    torch.cuda.synchronize()
    return only_launched(kernels.launches())


def classification_http(artifact, rng, num_genes) -> dict:
    """A Classification artifact over the HTTP host: /health reports its
    kind, a ragged /predict answers the direct predict's outputs, ``risk``
    is refused with 400."""
    from imp_torch.serving import make_http_server

    server = make_http_server(artifact, port=0, device=DEVICE)
    served = server.serving_model
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    slides = make_slides(rng, (300, 1, 57), served.manifest["feat_dim"], num_genes)
    body = {"img": [b.tolist() for b in slides["img"]], "mol": slides["mol"].tolist()}

    def post(payload):
        req = urllib.request.Request(base + "/predict", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        status, resp = post({"batch": body})
        risk_status, risk_resp = post({"batch": body, "risk": True})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    want = served.predict_many({"img": slides["img"], "mol": slides["mol"]})
    err = max(float(np.abs(np.asarray(resp["outputs"][k]) - want[k]).max()) for k in want)
    out = {"health_kind": health["kind"], "task": health["task"], "predict": status,
           "batch_size": resp.get("batch_size"), "logits_shape": list(want["logits"].shape),
           "http_vs_direct_err": err, "risk": risk_status, "risk_error": risk_resp.get("error")}
    require(health["kind"] == "mbtrain" and health["task"] == "Classification", out)
    require(status == 200 and resp["batch_size"] == 3 and err <= 1e-5, out)
    require(want["logits"].shape == (3, 6), out)
    require(risk_status == 400 and "only defined for survival" in risk_resp["error"], out)
    return out


def phase_serve_export(card: str, tmp: str, flash_out: str, transmil_out: str):
    """Serving from a checkpoint through the exported program: the export
    CLI's trainer route with ``--check`` on ``train_flash``'s UMEML_GAN
    checkpoint (batch 8) and ``train_transmil``'s TransMIL checkpoint
    (batch 1, 10 001 tokens), both under flash; a UMEML_GAN built with the
    fused pseudo-inverse at ``auto`` through ``export_model``; a
    Classification UMEML_GAN over the HTTP host.  K1 and K6 run inside the
    programs as ``imp_torch::flash_fwd`` and ``imp_torch::pinv_fwd``."""
    import torch

    from imp_torch import kernels
    from imp_torch.models import build_model, survival_num_classes
    from imp_torch.serving import (
        even_gene_groups, export_model, load_model, mbtrain_batch_template, rebuild_model,
    )

    root = make_train_tree(os.path.join(tmp, "serve_tree"), SERVE_TREE_SLIDES)
    rng = np.random.default_rng(SEED + 1)
    num_genes, feat = FLAGSHIP["DATASET.OMIC.DIM"], FLAGSHIP["DATASET.PATH.DIM"]
    row = {"phase": "serve_export", "card": card, "entry": "python -m imp_torch.tools.export_model"}
    t0, seconds_by = time.perf_counter(), {}

    def lap(name):
        nonlocal t0
        seconds_by[name], t0 = time.perf_counter() - t0, time.perf_counter()

    # ---- UMEML_GAN under flash, from train_flash's checkpoint ---------------
    art = os.path.join(tmp, "export_umeml_gan_flash")
    argv = ["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--model-dir", flash_out,
            "--export-dir", art, "--device", DEVICE, "--check"] + flagship_opts(**{
                "TPU.ATTENTION": "flash", "DATALOADER.TEST.BATCH_SIZE": SERVE_BATCH})
    manifest, seconds, log = export_cli(argv)
    served = load_model(art, device=DEVICE)
    batch = make_slides(rng, SLIDE_LENGTHS[:SERVE_BATCH], feat, num_genes)
    per_forward = launches_per_forward(served, batch)
    row["umeml_gan"] = {
        "checkpoint_of": "train_flash", "kind": manifest["kind"],
        "batch": manifest["batch_size"], "bag_pad": manifest["bag_pad"],
        "attention": manifest["attention"], "export_s": seconds,
        "check_max_abs_diff": manifest["check_max_abs_diff"], "check_tol": EXPORT_TOL,
        "launches_per_forward": per_forward,
        "program_bytes": os.path.getsize(os.path.join(art, "model.pt2")),
        **latency(served, rng, num_genes, reps=20, breakdown=False),
    }
    require(manifest["batch_size"] == SERVE_BATCH and manifest["kind"] == "mbtrain"
            and manifest["bag_pad"] == FLAGSHIP["DATASET.BAG_PAD"], row["umeml_gan"])
    require(manifest["check_max_abs_diff"] <= EXPORT_TOL and "check OK" in log, row["umeml_gan"])
    require(per_forward == {"flash_fwd": 6}, f"K1 per served UMEML_GAN forward: {per_forward}")
    del served
    lap("umeml_gan")

    # ---- TransMIL under flash, from train_transmil's checkpoint -------------
    art = os.path.join(tmp, "export_transmil_flash")
    argv = ["--root", root, "--seed", "1", "--trainer", "TransMIL", "--config-file",
            TRANSMIL_YAML, "--model-dir", transmil_out, "--export-dir", art, "--device", DEVICE,
            "--check", "TPU.ATTENTION", "flash"]
    manifest, seconds, log = export_cli(argv)
    served = load_model(art, device=DEVICE)
    bag = rng.standard_normal((served.bag_pad, feat), dtype=np.float32)  # a full slide
    per_forward = launches_per_forward(served, {"img": [bag]})
    row["transmil"] = {
        "checkpoint_of": "train_transmil", "kind": manifest["kind"],
        "batch": manifest["batch_size"], "bag_pad": manifest["bag_pad"],
        "attention": manifest["attention"], "export_s": seconds,
        "check_max_abs_diff": manifest["check_max_abs_diff"], "check_tol": EXPORT_TOL,
        "launches_per_forward": per_forward,
    }
    require(manifest["kind"] == "generic" and manifest["outputs"] == ["logits"], row["transmil"])
    require(manifest["check_max_abs_diff"] <= EXPORT_TOL and "check OK" in log, row["transmil"])
    require(per_forward == {"flash_fwd": 2}, f"K1 per served TransMIL forward: {per_forward}")
    del served
    lap("transmil")

    # ---- UMEML_GAN with the fused pseudo-inverse, through export_model ------
    cfg = flagship_cfg("auto")
    groups = even_gene_groups(num_genes, cfg.MODEL.UMEML.PROTOTYPES)
    model = build_model(cfg.MODEL.NAME, cfg=cfg, num_classes=survival_num_classes("Survival", 0),
                        gene_group_indexes=groups, device=DEVICE, pinv_mode="fused",
                        generator=torch.Generator().manual_seed(SEED))
    fused = fused_pinvs(model)
    art = os.path.join(tmp, "export_umeml_gan_fused")
    t0 = time.perf_counter()
    manifest = export_model(model, cfg, mbtrain_batch_template(cfg, SERVE_BATCH, num_genes), art,
                            rng.lognormal(size=num_genes).astype(np.float32))
    seconds = time.perf_counter() - t0
    del model
    served = load_model(art, device=DEVICE)
    per_forward = launches_per_forward(served, batch)
    got = served.predict(batch)
    ref_model = rebuild_model(art, DEVICE)
    img, mask = served._pad_bags(batch["img"])
    host = {"img": img, "img_mask": mask, "mol": batch["mol"],
            "without_omic": batch["without_omic"],
            "insample_without_omic": np.zeros((SERVE_BATCH, num_genes), np.int32),
            "omic_means": served._aux["omic_means"]}
    with torch.no_grad():
        want = ref_model({k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()})
    err = max(float(np.abs(got[k] - want[k].cpu().numpy()).max()) for k in got)
    lap("umeml_gan_fused")
    cpu = load_model(art, device="cpu")  # the program moved to the CPU: no launch
    kernels.reset_launches()
    cpu_out = cpu.predict(batch)  # the same batch: the normaliser spans it
    cpu_launches = sum(kernels.launches().values())
    cpu_err = float(np.abs(cpu_out["logits"] - got["logits"]).max())
    row["umeml_gan_fused"] = {
        "entry": "imp_torch.serving.export_model", "pinv_mode": manifest["pinv_mode"],
        "fused_pinvs": fused, "export_s": seconds, "launches_per_forward": per_forward,
        "vs_rebuilt_max_abs_diff": err, "tol": EXPORT_TOL,
        "cpu": {"launches": cpu_launches, "max_abs_err_logits": cpu_err,
                "tol": CROSS_DEVICE_TOL},
    }
    require(manifest["pinv_mode"] == "fused" and fused > 0, row["umeml_gan_fused"])
    require(per_forward == {"pinv_fwd": fused}, f"K6 per served forward: {per_forward}")
    require(err <= EXPORT_TOL, f"fused program vs the rebuilt module: {err}")
    require(cpu_launches == 0 and cpu_err <= CROSS_DEVICE_TOL, row["umeml_gan_fused"])
    del served, cpu, ref_model
    lap("umeml_gan_fused_cpu")

    # ---- a Classification artifact over HTTP -------------------------------
    cfg = yaml_cfg(task_yaml("Classification", "UMEML_GAN"))
    art = os.path.join(tmp, "export_classification")
    model = build_model(cfg.MODEL.NAME, cfg=cfg, num_classes=6,
                        gene_group_indexes=even_gene_groups(num_genes, cfg.MODEL.UMEML.PROTOTYPES),
                        device=DEVICE, generator=torch.Generator().manual_seed(SEED))
    export_model(model, cfg, mbtrain_batch_template(cfg, 2, num_genes), art,
                 np.zeros(num_genes, np.float32))
    del model
    row["classification_http"] = classification_http(art, rng, num_genes)
    lap("classification_http")
    row["seconds"] = seconds_by
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phases 5-6: training
# ---------------------------------------------------------------------------

#: patches per synthetic training slide (index = the slide's number)
TRAIN_LENGTHS = (10000, 7313, 1, 4096, 9999, 300, 2048, 517, 10000, 64, 1500, 777,
                 5000, 8192, 12, 3000)
TRAIN_EPOCHS = 3
TRAIN_EPOCHS_FLASH = 2  # MBTRAIN and TransMIL under flash
STEP_TOL = 1e-4  # kernel vs plain modularity inside one train step, fp32
STEP_TIMED = 12  # timed steps at batch 8, after warm-up


def make_train_tree(root: str, num_slides: int = len(TRAIN_LENGTHS)) -> str:
    """The synthetic tree's CSVs (labels, 1 000 genes in six 166-gene
    signature groups, like the even fallback); bags come from
    :func:`seeded_bags` (slide i has ``TRAIN_LENGTHS[i % 16]`` patches)."""
    from imp_torch.data import synthetic

    return synthetic.materialize(root, num_slides=num_slides, bag_min=1, bag_max=1,
                                 feat_dim=512, num_genes=1000, group_size=166, seed=SEED,
                                 bags=False)


@contextlib.contextmanager
def seeded_bags():
    """The port's SlideDataset (and the external cohort's, which inherits
    it) with only its .h5 reader replaced: slide i's bag is
    TRAIN_LENGTHS[i] patches of seeded normal features; the molecular CSV is
    read by the port as usual."""
    import warnings

    from imp_torch.data.manager import SlideDataset

    def seeded_bag(self, idx):
        i = int(self.data_source[idx].patientid.split("-")[1])
        rng = np.random.default_rng(SEED + i)
        n = TRAIN_LENGTHS[i % len(TRAIN_LENGTHS)]
        return rng.standard_normal((n, self.cfg.DATASET.PATH.DIM), dtype=np.float32)

    reader = SlideDataset._load_bag
    SlideDataset._load_bag = seeded_bag
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="No file found")  # no .h5 on disk
            yield
    finally:
        SlideDataset._load_bag = reader


@contextlib.contextmanager
def audited(cls, names, record: list):
    """Record, for every call of the methods ``names`` of trainer class
    ``cls``: its name, the kernel launches it made, the TransLayer calls it
    made (``calls``, and ``grad``: those with grad enabled, counted by a
    global forward hook) and, for ``train_step``, its metrics."""
    import torch

    from imp_torch import kernels
    from imp_torch.ops.attention import TransLayer

    layers = {"calls": 0, "grad": 0}

    def count(module, _args, _out):
        if isinstance(module, TransLayer):
            layers["calls"] += 1
            layers["grad"] += int(torch.is_grad_enabled())

    own = {n: cls.__dict__.get(n) for n in names}

    def wrap(name):
        fn = getattr(cls, name)

        def wrapper(self, *args, **kw):
            before, seen = kernels.launches(), dict(layers)
            out = fn(self, *args, **kw)
            after = kernels.launches()
            record.append((name, {k: after[k] - before[k] for k in after},
                           {k: layers[k] - seen[k] for k in layers},
                           out if name == "train_step" else None))
            return out

        return wrapper

    hook = torch.nn.modules.module.register_module_forward_hook(count)
    for n in names:
        setattr(cls, n, wrap(n))
    try:
        yield
    finally:
        hook.remove()
        for n, fn in own.items():
            if fn is None:
                delattr(cls, n)
            else:
                setattr(cls, n, fn)


def flash_launches_match_layers(records) -> bool:
    """K1 once per TransLayer call, K2 and K3 once per call with grad."""
    return all(d["flash_fwd"] == c["calls"] and d["flash_bwd_dq"] == d["flash_bwd_dkv"] == c["grad"]
               for _, d, c, _ in records)


def run_trainer(argv, cls, names, log_name):
    """``python -m imp_torch.tools.train argv`` in process, on the seeded
    bags, with the calls of ``cls.names`` audited; the counts are set to 0
    just before and read just after.  Returns (result, launches, records,
    seconds, log text); the log is kept under ``LOG_DIR``."""
    import torch

    from imp_torch import kernels
    from imp_torch.tools.train import run

    record = []
    console = io.StringIO()  # the trainer's log goes to out/log.txt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with seeded_bags(), audited(cls, names, record), contextlib.redirect_stdout(console):
        # ---- the main path: counts at 0 just before, read just after ------
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = run(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernels.launches()
    out = argv[argv.index("--output-dir") + 1]
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, log_name), "w") as f:
        f.write(log)
    return result, counts, record, seconds, log


def reload_last(out: str, model):
    """Load the last checkpoint of a run into ``model``, strictly; returns
    (checkpoint name, its epoch)."""
    import torch

    mdir = os.path.join(out, "model")
    with open(os.path.join(mdir, "checkpoint")) as f:
        ckpt_name = f.read().strip()
    state = torch.load(os.path.join(mdir, ckpt_name), map_location=DEVICE, weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    return ckpt_name, int(state["epoch"])


def phase_train(card: str, root: str, out: str, attention: str = "auto"):
    """MBTRAIN through the CLI: 3 epochs at ``auto`` (plain, GAN, GAN +
    replacement), 2 under ``flash`` (GAN, GAN + replacement)."""
    import torch

    from imp_torch.engine.mbtrain import MBTRAIN
    from imp_torch.models import build_model, survival_num_classes
    from imp_torch.serving import even_gene_groups

    flash = attention == "flash"
    epochs = TRAIN_EPOCHS_FLASH if flash else TRAIN_EPOCHS
    argv = ["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--output-dir", out,
            "--device", DEVICE] + flagship_opts(**{
                "OPTIM.MAX_EPOCH": epochs, "TRAIN.CURRICULUM.GAN_START_EPOCH": 0 if flash else 1,
                "TRAIN.CURRICULUM.REPLACE_START_EPOCH": 1 if flash else 2,
                "TPU.ATTENTION": attention,
            })
    result, counts, record, seconds, log = run_trainer(
        argv, MBTRAIN, ("train_step", "run_epoch_cca", "test"),
        f"chip_smoke_train_{attention}_log.txt")

    steps = [r for r in record if r[0] == "train_step"]
    others = [r for r in record if r[0] != "train_step"]
    per_step_ok = all(d["modularity_deg"] == 1 and d["modularity_combined"] == 1
                      and (d["flash_fwd"] > 0) == flash for _, d, _, _ in steps)
    others_zero = all(d["modularity_deg"] == d["modularity_combined"] == 0
                      and (flash or not any(d.values())) for _, d, _, _ in others)
    metrics = [{k: float(v) for k, v in m.items()} for _, _, _, m in steps]
    finite = all(np.isfinite(list(m.values())).all() for m in metrics)
    gan_steps = sum("loss_gen" in m for m in metrics)
    cindex = [float(line.split(":")[1].strip().rstrip("%")) for line in log.splitlines()
              if line.startswith("* cindex:")]
    # the last checkpoint reloads into a fresh model, strictly
    cfg = flagship_cfg(attention)
    ckpt_name, ckpt_epoch = reload_last(out, build_model(
        cfg.MODEL.NAME, cfg=cfg, num_classes=survival_num_classes(cfg.TASK.NAME, 0),
        gene_group_indexes=even_gene_groups(1000, 6), device=DEVICE))
    layers_ok = flash_launches_match_layers(record) if flash else True
    row = {
        "phase": "train_flash" if flash else "train", "card": card,
        "entry": "python -m imp_torch.tools.train", "attention": attention,
        "slides": len(TRAIN_LENGTHS), "bag_lengths": list(TRAIN_LENGTHS),
        "batch": FLAGSHIP["DATALOADER.TRAIN.BATCH_SIZE"], "bag_pad": FLAGSHIP["DATASET.BAG_PAD"],
        "hidden": FLAGSHIP["MODEL.HIDDEN_DIM"], "genes": 1000, "epochs": epochs,
        "main_steps": len(steps), "gan_steps": gan_steps,
        "cca_epochs": sum(r[0] == "run_epoch_cca" for r in others),
        "evaluations": sum(r[0] == "test" for r in others),
        "launches": counts, "K4_K5_once_per_main_step": per_step_ok,
        "K4_K5_outside_main_steps": 0 if others_zero else [r[:2] for r in others],
        "translayer_calls_per_main_step": sorted({c["calls"] for _, _, c, _ in steps}),
        "flash_launches_match_translayer_calls": layers_ok,
        "K2_K3_in_eval": sum(d["flash_bwd_dq"] + d["flash_bwd_dkv"] for n, d, _, _ in others
                             if n == "test"),
        "losses_finite": finite, "last_loss": metrics[-1] if metrics else None,
        "cindex_lines": cindex, "result_cindex": result, "checkpoint": ckpt_name,
        "checkpoint_epoch": ckpt_epoch, "seconds": seconds,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(row)
    require(len(steps) > 0 and per_step_ok and others_zero, f"K4/K5 launches off the main steps: {row}")
    require(counts["modularity_deg"] == counts["modularity_combined"] == len(steps), row)
    require(layers_ok and row["K2_K3_in_eval"] == 0, f"K1/K2/K3 launches vs TransLayer calls: {row}")
    require(finite and gan_steps > 0 and row["cca_epochs"] == epochs - 1, row)
    require(len(cindex) >= epochs + 1 and result is not None, "no C-index reported")
    require(ckpt_epoch == epochs, f"last checkpoint is epoch {ckpt_epoch}")
    return row, counts


@contextlib.contextmanager
def plain_modularity():
    """Route the modularity passes to their plain versions on the card."""
    import imp_torch.ops.modularity as M

    saved = M.modularity_passes
    M.modularity_passes = M.modularity_passes_reference
    try:
        yield
    finally:
        M.modularity_passes = saved


FLASH_KERNEL_NAMES = ("flash_fwd_kernel", "dq_kernel", "dkv_kernel")
MOD_KERNEL_NAMES = MOD_KERNEL_SYMBOLS["modularity_deg"] + MOD_KERNEL_SYMBOLS["modularity_combined"]


def grads_check(loss_and_grads, plain, names):
    """One step's loss and gradients through the kernels and, under the
    context ``plain``, through the plain versions: their relative errors
    (the worst parameter named) and the launches of the kernel pass."""
    import torch

    from imp_torch import kernels

    kernels.reset_launches()
    loss_k, extra_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    counted = kernels.launches()
    with plain():
        loss_p, extra_p, grads_p = loss_and_grads()
    errs = {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    worst = max(errs, key=errs.get)
    check = {"loss_rel": rel_err(loss_k, loss_p), "grad_rel": errs[worst], "worst_param": worst,
             "params": len(errs), "loss": loss_k.item(), "tol_rel": STEP_TOL}
    check.update({f"{k}_rel": rel_err(extra_k[k], extra_p[k]) for k in extra_k})
    return check, counted


PINV_KERNEL_NAMES = ("pinv_fwd_kernel", "pinv_bwd_kernel")


def pinv_ab(step, kernel_names, first_chain=None):
    """The step time of ``step()`` (on a model built fused) with its
    pseudo-inverses as the chain (under :func:`chain_pinv`) and through
    K6/K7, in turns: chain, fused, fused, chain (``first_chain``, a chain
    timing already taken, stands for the first turn).  Returns per mode the
    median of its turns, the turns, and the kernels one step launches."""
    import torch

    from imp_torch import kernels

    names = tuple(kernel_names) + PINV_KERNEL_NAMES
    turns = {"chain": [], "fused": []}
    launched = {}
    for i, mode in enumerate(("chain", "fused", "fused", "chain")):
        if i == 0 and first_chain is not None:
            turns[mode].append(first_chain)
            continue
        with chain_pinv() if mode == "chain" else contextlib.nullcontext():
            if mode not in launched:
                kernels.reset_launches()
                step()
                torch.cuda.synchronize()
                launched[mode] = {k: v for k, v in kernels.launches().items() if v}
            turns[mode].append(time_step(step, names, timed=STEP_TIMED))
    out = {mode: {"step_ms_median": float(np.median([t["step_ms_median"] for t in ts])),
                  "launches_per_step": launched[mode], "turns": ts}
           for mode, ts in turns.items()}
    out["fused_over_chain"] = out["fused"]["step_ms_median"] / out["chain"]["step_ms_median"]
    return out


def mbtrain_for(root: str, out: str, attention: str = "auto", **overrides):
    """An MBTRAIN trainer on UMEML_GAN.yaml's config (plus ``overrides``)
    over the seeded bags, its first train batch and that batch on the card."""
    from imp_torch.engine import build_trainer

    cfg = flagship_cfg(attention, **{"DATASET.ROOT": root, "OUTPUT_DIR": out,
                                     "VERBOSE": False, "SEED": 1, "DATASET.FOLD": 1,
                                     "TRAINER.NAME": "MBTRAIN", **overrides})
    with seeded_bags():
        trainer = build_trainer(cfg, device=DEVICE)
        batch = next(iter(trainer.train_loader))
    return trainer, batch, trainer._device_batch(batch)


def phase_train_step(card: str, root: str, out: str, attention: str = "auto"):
    """One main step through the kernels against the plain versions (the
    modularity at ``auto``; the flash attention, forward and backward,
    under ``flash``), then the step time at batch 8; at ``auto`` also the
    A/B of the Nyström pseudo-inverse, chain against K6/K7."""
    import torch

    flash = attention == "flash"

    # ---- one main step, kernels vs plain, same dropout draws ----------------
    trainer, batch, db = mbtrain_for(root, out, attention)
    model, g = trainer.model, trainer.generator
    state = g.get_state()
    named = ([(n, p) for n, p in model.named_parameters() if not n.startswith("gan_discriminator")]
             if flash else
             [("p_proto", model.p_proto)] + [("omic_encoder." + n, p)
                                            for n, p in model.omic_encoder.named_parameters()])
    names, params = zip(*named)
    pairs = []
    hook = model.bottleattn.register_forward_pre_hook(
        lambda _m, args: pairs.append(torch.cat(greedy_pairs(model, args), dim=1)))

    def loss_and_grads():
        g.set_state(state)
        enc = model.encode(db, train=True, generator=g)
        out_ = model.finish(enc, db, train=True, replace_ratio=0.0, generator=g)
        loss = trainer.task_loss(out_["logits"], db) + out_["modular_loss"] + out_["loss_kd"]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]
        return loss.detach(), {"modular_loss": out_["modular_loss"].detach()}, grads

    check, counted = grads_check(loss_and_grads, plain_attention if flash else plain_modularity,
                                 names)
    hook.remove()
    check["same_greedy_pairs"] = bool(torch.equal(pairs[0], pairs[1]))
    require(counted["modularity_deg"] == 1 and counted["modularity_combined"] == 1, counted)
    if flash:  # six TransLayers with grad: encode's four and the bottleneck's two
        require(counted["flash_fwd"] == counted["flash_bwd_dq"] == counted["flash_bwd_dkv"] == 6,
                counted)
    require(check["same_greedy_pairs"] and check["loss_rel"] <= STEP_TOL
            and check["grad_rel"] <= STEP_TOL and check["modular_loss_rel"] <= STEP_TOL,
            f"train step through the kernels vs the plain versions: {check}")
    del trainer, model, db, params, named
    torch.cuda.empty_cache()

    # ---- the step time at batch 8 (UMEML_GAN_THROUGHPUT.yaml) ---------------
    # at auto the model is built fused and timed first under the chain
    with contextlib.nullcontext() if flash else pinv_mode("fused"):
        trainer, batch, db = mbtrain_for(root, out, attention, **THROUGHPUT)

    def step():
        return trainer.train_step(db, train_gan=True, replace_ratio=0.25)

    with contextlib.nullcontext() if flash else chain_pinv():
        timing = time_step(step, MOD_KERNEL_NAMES + (FLASH_KERNEL_NAMES if flash else ()),
                           timed=STEP_TIMED)
    b = len(batch["patient_id"])
    row = {
        "phase": "train_step_flash" if flash else "train_step", "card": card,
        "attention": attention, "check_b2": check,
        "batch": b, "bag_lengths": [int(x) for x in batch["img_mask"].sum(axis=1)],
        "bag_pad": trainer.cfg.DATASET.BAG_PAD, "hidden": trainer.cfg.MODEL.HIDDEN_DIM,
        "gan": True, "replace_ratio": 0.25, **timing,
        "slides_per_s": b / (timing["step_ms_median"] / 1e3),
    }
    if not flash:  # the pseudo-inverse A/B: the chain timed above, then K6/K7
        row["pinv_ab"] = pinv_ab(step, MOD_KERNEL_NAMES, first_chain=timing)
    emit(row)
    require(row["loss_finite"], row)
    if not flash:  # six TransLayers with grad per main step, each K6 then K7
        fused = row["pinv_ab"]["fused"]["launches_per_step"]
        require(fused.get("pinv_fwd") == fused.get("pinv_bwd") == 6
                and "pinv_fwd" not in row["pinv_ab"]["chain"]["launches_per_step"], row["pinv_ab"])
    return row


# ---------------------------------------------------------------------------
# phase 33: the bench tools
# ---------------------------------------------------------------------------

BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "best", "windows", "batch", "bag_pad",
                "feat_dim", "num_genes", "hidden", "prec", "attention", "pinv_mode", "no_gan",
                "no_mod", "no_opt", "no_kd", "launches_per_step", "card")
#: (g, m) of bench_pinv --check: the three Nyström shapes of the K6/K7 table
BENCH_PINV_SHAPES = ((16, 128), (64, 128), (8, 256))
#: bench_anatomy's sections that launch K4 and K5 once a call
BENCH_ANATOMY_K4_K5 = ("full_train_step", "modularity_pair_fwd_bwd")


def quiet(main, argv):
    """``main(argv)``'s result, its printed lines kept apart from the run's."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue().splitlines()


def bench_step_check() -> dict:
    """One ``imp_torch.tools.bench.build_step`` step at batch 2 and full width
    up to its main update (``step.loss_and_grads``: the encode, the GAN
    phase, the main loss and its gradients) through K4/K5 and, under
    :func:`plain_modularity`, through the plain passes, each on a model
    built anew from the same seed with the same generator seed: the loss
    and every gradient the main update takes within STEP_TOL, K4 and K5
    once each."""
    import torch

    from imp_torch.tools.bench import REPLACE_RATIO, build_step

    names = []

    def loss_and_grads():
        step, state, batch = build_step(batch_size=2, device=DEVICE)
        params = {id(p): n for n, p in state["model"].named_parameters()}
        names[:] = [params[id(p)] for p in state["opt_state"].params]
        loss, grads = step.loss_and_grads(state, batch,
                                          torch.Generator(device=DEVICE).manual_seed(SEED),
                                          REPLACE_RATIO)
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(state["opt_state"].params, grads)]
        return loss.detach(), {}, grads

    check, counted = grads_check(loss_and_grads, plain_modularity, names)
    check["launches"] = only_launched(counted)
    torch.cuda.empty_cache()
    require(counted["modularity_deg"] == counted["modularity_combined"] == 1, counted)
    require(check["loss_rel"] <= STEP_TOL and check["grad_rel"] <= STEP_TOL,
            f"bench step through K4/K5 vs the plain passes: {check}")
    return check


def phase_bench_tools(card: str, tmp: str):
    """The port's bench tools once each on the card (in process, at short
    settings): ``bench`` at batch 8 (full width), ``ab_step --knob pinv``,
    ``bench_anatomy``, ``bench_flash --check`` at n 1 024 then timed at the
    default envelope, ``bench_pinv --check`` at the three Nyström shapes and
    ``bench_vit --stage device`` at batch 32, fp32 and bf16; with
    :func:`bench_step_check`.  Returns the row and the launches of each
    kernel per step or call of the tools that ran it."""
    import torch

    from imp_torch.tools import ab_step, bench, bench_anatomy, bench_flash, bench_pinv, bench_vit

    row = {"phase": "bench_tools", "card": card, "check_b2": bench_step_check()}
    # the JAX package's self-recorded baseline (0 bytes here) stays as it is
    jax_baseline = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_baseline.json")
    def stamp():
        st = os.stat(jax_baseline) if os.path.exists(jax_baseline) else None
        return st and (st.st_size, st.st_mtime_ns)

    stamped = stamp()
    baseline = os.path.join(tmp, "output", "bench_torch_baseline.json")
    result, _ = quiet(bench.main, ["--batch-size", "8", "--device", DEVICE,
                                   "--baseline", baseline])
    missing = [k for k in BENCH_FIELDS if k not in result]
    require(not missing, f"bench's line lacks {missing}")
    per_step = result["launches_per_step"]
    require(per_step["modularity_deg"] == per_step["modularity_combined"] == 1.0
            and per_step["pinv_fwd"] == per_step["pinv_bwd"] == 0.0, per_step)
    require(result["loss_finite"] and result["vs_baseline"] == 1.0
            and os.path.exists(baseline), result)
    require(stamp() == stamped, "bench_baseline.json was touched")
    row["bench"] = result
    torch.cuda.empty_cache()

    result, lines = quiet(ab_step.main, ["--knob", "pinv", "--slots", "2", "--iters", "5",
                                         "--device", DEVICE])
    fused, chain = (result["arms"][a]["launches_per_step"] for a in ("A", "B"))
    require(fused["pinv_fwd"] == fused["pinv_bwd"] == 6.0
            and chain["pinv_fwd"] == chain["pinv_bwd"] == 0.0, result)
    row["ab_step"] = {**result, "lines": lines}
    torch.cuda.empty_cache()

    result, _ = quiet(bench_anatomy.main, ["--iters", "5", "--device", DEVICE])
    require(all(r["finite"] and r["device_busy_ms"] is not None
                for r in result["sections"].values()), result)
    anatomy = {s: result["sections"][s]["launches_per_call"] for s in BENCH_ANATOMY_K4_K5}
    require(all(a == {"modularity_deg": 1.0, "modularity_combined": 1.0}
                for a in anatomy.values()), anatomy)
    row["bench_anatomy"] = result
    torch.cuda.empty_cache()

    checked, _ = quiet(bench_flash.main, ["--n", "1024", "--check", "--iters", "3",
                                          "--device", DEVICE])
    fp32 = checked["check"]["fp32"]
    require(max(fp32[k] for k in ("fwd_rel_err", "dq_rel_err", "dk_rel_err", "dv_rel_err"))
            <= KERNEL_TOL, checked)
    for prec, entry in (("fp32", ""), ("bf16", "_bf16")):
        c = checked["check"][prec]
        require(c["launches_per_forward"] == {"flash_fwd": 1, "flash_bwd_dq": 0,
                                              "flash_bwd_dkv": 0}
                and c["launches_per_backward"] == {"flash_fwd": 0, "flash_bwd_dq": 1,
                                                   "flash_bwd_dkv": 1}, (entry, c))
    timed, _ = quiet(bench_flash.main, ["--precisions", "fp32,bf16", "--device", DEVICE])
    require(all(t["launches_per_call"] == {"flash_fwd": 1.0, "flash_bwd_dq": 0.0,
                                           "flash_bwd_dkv": 0.0}
                for t in timed["timed"].values()), timed)
    row["bench_flash"] = {"check_n1024": checked, "timed": timed}
    torch.cuda.empty_cache()

    row["bench_pinv"] = []
    for g, m in BENCH_PINV_SHAPES:  # raises where a bound of --check is missed
        result, _ = quiet(bench_pinv.main, ["--check", "--g", str(g), "--m", str(m),
                                            "--device", DEVICE])
        fused = result["check"]["launches"]["fused"]
        require(fused == {"per_forward": {"pinv_fwd": 1, "pinv_bwd": 0},
                          "per_backward": {"pinv_fwd": 0, "pinv_bwd": 1}}, result)
        row["bench_pinv"].append(result)
    torch.cuda.empty_cache()

    row["bench_vit"] = [quiet(bench_vit.main, ["--stage", "device", "--batch-size", "32",
                                               "--prec", prec, "--iters", "10",
                                               "--device", DEVICE])[0]
                        for prec in ("fp32", "bf16")]
    emit(row)
    torch.cuda.empty_cache()
    # every count below is one this run counted
    launches = {
        n: {**{f"bench_flash --check n 1024 {prec} (per {way})":
               checked["check"][prec][f"launches_per_{way}"][n]
               for prec in ("fp32", "bf16") for way in ("forward", "backward")},
            **{f"bench_flash {prec} (per timed forward)": timed["timed"][prec]["launches_per_call"][n]
               for prec in ("fp32", "bf16")}}
        for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for k in ("modularity_deg", "modularity_combined"):
        launches[k] = {"bench b8 (per step)": row["bench"]["launches_per_step"][k],
                       **{f"bench_anatomy {s} (per call)": anatomy[s][k]
                          for s in BENCH_ANATOMY_K4_K5}}
    for k in ("pinv_fwd", "pinv_bwd"):
        launches[k] = {"ab_step --knob pinv, fused arm (per step)":
                       row["ab_step"]["arms"]["A"]["launches_per_step"][k],
                       **{f"bench_pinv --check ({r['g']}, {r['m']}) (per {way})":
                          r["check"]["launches"]["fused"][f"per_{way}"][k]
                          for r in row["bench_pinv"] for way in ("forward", "backward")}}
    return row, launches


def greedy_pairs(model, args):
    """The bottleneck's greedy (path, omic) pairs for its inputs."""
    from imp_torch.ops.pairing import cosine_similarity_matrix, greedy_topk_pairs

    return greedy_topk_pairs(cosine_similarity_matrix(args[0], args[1]), model.bottleattn.topk)


#: what configs/Survival/UMEML.yaml changes in UMEML_GAN.yaml
UMEML = {"MODEL.NAME": "umeml"}
TRAIN_EPOCHS_UMEML = 2


def only_launched(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def phase_train_umeml(card: str, root: str, out: str):
    """MBTRAIN on UMEML.yaml through the CLI for 2 epochs, every Nyström
    pseudo-inverse fused: per train step K6 once per TransLayer call, K7
    once per call (all with grad) and K4/K5 once; per evaluation K6 once
    per TransLayer call and nothing else; losses finite, the C-index lines,
    a strict reload of the last checkpoint."""
    import torch

    from imp_torch.engine.mbtrain import MBTRAIN
    from imp_torch.models import build_model, survival_num_classes

    argv = ["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--output-dir", out,
            "--device", DEVICE] + flagship_opts(**UMEML, **{"OPTIM.MAX_EPOCH": TRAIN_EPOCHS_UMEML})
    with pinv_mode("fused"):
        result, counts, record, seconds, log = run_trainer(
            argv, MBTRAIN, ("train_step", "test"), "chip_smoke_train_umeml_log.txt")
    steps = [r for r in record if r[0] == "train_step"]
    tests = [r for r in record if r[0] == "test"]
    per_step_ok = all(
        c["calls"] > 0 and c["grad"] == c["calls"]
        and only_launched(d) == {"pinv_fwd": c["calls"], "pinv_bwd": c["calls"],
                                 "modularity_deg": 1, "modularity_combined": 1}
        for _, d, c, _ in steps)
    eval_ok = all(c["calls"] > 0 and c["grad"] == 0
                  and only_launched(d) == {"pinv_fwd": c["calls"]} for _, d, c, _ in tests)
    losses = [float(m["loss"]) for _, _, _, m in steps]
    cindex = [float(line.split(":")[1].strip().rstrip("%")) for line in log.splitlines()
              if line.startswith("* cindex:")]
    cfg = flagship_cfg(**UMEML)
    ckpt_name, ckpt_epoch = reload_last(out, build_model(
        "umeml", cfg=cfg, num_classes=survival_num_classes(cfg.TASK.NAME, 0),
        omic_dim=FLAGSHIP["DATASET.OMIC.DIM"], device=DEVICE))
    row = {
        "phase": "train_umeml", "card": card, "entry": "python -m imp_torch.tools.train",
        "config": "configs/Survival/UMEML.yaml", "pinv_mode": "fused",
        "slides": len(TRAIN_LENGTHS), "batch": FLAGSHIP["DATALOADER.TRAIN.BATCH_SIZE"],
        "bag_pad": FLAGSHIP["DATASET.BAG_PAD"], "hidden": FLAGSHIP["MODEL.HIDDEN_DIM"],
        "genes": FLAGSHIP["DATASET.OMIC.DIM"], "epochs": TRAIN_EPOCHS_UMEML,
        "train_steps": len(steps), "evaluations": len(tests), "launches": counts,
        "translayer_calls_per_step": sorted({c["calls"] for _, _, c, _ in steps}),
        "K6_K7_per_translayer_call_K4_K5_once_per_step": per_step_ok,
        "eval_K6_only": eval_ok, "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss": losses[-1] if losses else None, "cindex_lines": cindex,
        "result_cindex": result, "checkpoint": ckpt_name, "checkpoint_epoch": ckpt_epoch,
        "seconds": seconds, "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(row)
    require(len(steps) > 0 and per_step_ok, f"K6/K7/K4/K5 per UMEML train step: {row}")
    require(len(tests) > 0 and eval_ok, f"K6/K7 per UMEML evaluation: {row}")
    require(counts["pinv_bwd"] == sum(c["grad"] for _, _, c, _ in steps), row)
    require(row["losses_finite"] and result is not None and np.isfinite(result)
            and len(cindex) >= TRAIN_EPOCHS_UMEML + 1, f"UMEML training: {row}")
    require(ckpt_epoch == TRAIN_EPOCHS_UMEML, f"last checkpoint is epoch {ckpt_epoch}")
    return row, counts


def phase_train_step_umeml(card: str, root: str, out: str):
    """One UMEML step through K6/K7 against one through the chain (loss, the
    modular loss and every parameter gradient, same dropout draws), then the
    step time of both modes at UMEML.yaml's batch 2."""
    import torch

    with pinv_mode("fused"):
        trainer, batch, db = mbtrain_for(root, out, **UMEML)
    model, g = trainer.model, trainer.generator
    require(fused_pinvs(model) == 6, "UMEML has six Nyström TransLayers, all fused")
    state = g.get_state()
    names, params = zip(*model.named_parameters())

    def loss_and_grads():
        g.set_state(state)
        out_ = model(db, train=True, generator=g)
        loss = trainer.task_loss(out_["logits"], db) + out_["modular_loss"]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]
        return loss.detach(), {"modular_loss": out_["modular_loss"].detach()}, grads

    check, counted = grads_check(loss_and_grads, chain_pinv, names)
    require(only_launched(counted) == {"pinv_fwd": 6, "pinv_bwd": 6, "modularity_deg": 1,
                                       "modularity_combined": 1}, counted)
    require(check["loss_rel"] <= STEP_TOL and check["grad_rel"] <= STEP_TOL
            and check["modular_loss_rel"] <= STEP_TOL,
            f"UMEML step through K6/K7 vs the chain: {check}")
    ab = pinv_ab(lambda: trainer.train_step(db), MOD_KERNEL_NAMES)
    b = len(batch["patient_id"])
    row = {
        "phase": "train_step_umeml", "card": card, "check": check, "batch": b,
        "bag_lengths": [int(x) for x in batch["img_mask"].sum(axis=1)],
        "bag_pad": trainer.cfg.DATASET.BAG_PAD, "hidden": trainer.cfg.MODEL.HIDDEN_DIM,
        "pinv_ab": ab, "slides_per_s": {m: b / (ab[m]["step_ms_median"] / 1e3)
                                        for m in ("chain", "fused")},
    }
    emit(row)
    require(all(t["loss_finite"] for m in ("chain", "fused") for t in ab[m]["turns"]), row)
    require(ab["fused"]["launches_per_step"].get("pinv_fwd") == 6
            and "pinv_fwd" not in ab["chain"]["launches_per_step"], ab)
    return row


#: the kernels of one TransMIL train step and of one eval batch: its two
#: TransLayers under flash (K1, K2, K3) or Nyström with the fused mode (K6, K7)
TRANSMIL_LAUNCHES = {
    "flash": ({"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}, {"flash_fwd": 2}),
    "auto": ({"pinv_fwd": 2, "pinv_bwd": 2}, {"pinv_fwd": 2}),
}


def transmil_argv(root: str, out: str, attention: str = "flash") -> list:
    return ["--root", root, "--seed", "1", "--trainer", "TransMIL", "--config-file", TRANSMIL_YAML,
            "--output-dir", out, "--device", DEVICE, "TPU.ATTENTION", attention,
            "OPTIM.MAX_EPOCH", str(TRAIN_EPOCHS_FLASH)]


def transmil_modes(attention: str):
    """Under Nyström the TransMIL runs build their models fused."""
    return contextlib.nullcontext() if attention == "flash" else pinv_mode("fused")


def phase_train_transmil(card: str, root: str, out: str, attention: str = "flash"):
    """TransMIL through the CLI at TransMIL.yaml's width, under flash (K1,
    K2 and K3 twice per train step, K1 twice per eval batch) or at ``auto``
    with the fused pseudo-inverse (K6 and K7 twice per train step, K6 twice
    per eval batch), nothing else; losses finite, a C-index line, a strict
    reload."""
    import torch

    from imp_torch.engine.baselines import TransMIL
    from imp_torch.models import build_model, survival_num_classes

    phase = "train_transmil" if attention == "flash" else "train_transmil_nystrom"
    step_launches, eval_launches = TRANSMIL_LAUNCHES[attention]
    with transmil_modes(attention):
        result, counts, record, seconds, log = run_trainer(
            transmil_argv(root, out, attention), TransMIL, ("train_step", "test", "_eval_batch"),
            f"chip_smoke_{phase}_log.txt")
    steps = [r for r in record if r[0] == "train_step"]
    tests = [r for r in record if r[0] == "test"]
    eval_batches = sum(r[0] == "_eval_batch" for r in record)
    per_step_ok = all(only_launched(d) == step_launches and c == {"calls": 2, "grad": 2}
                      for _, d, c, _ in steps)
    eval_counts = only_launched({k: sum(d[k] for _, d, _, _ in tests) for k in counts})
    losses = [float(m["loss"]) for _, _, _, m in steps]
    cindex = [line for line in log.splitlines() if line.startswith("* C-Index:")]
    cfg = transmil_cfg(**{"TPU.ATTENTION": attention})
    ckpt_name, ckpt_epoch = reload_last(out, build_model(
        "transmil", cfg=cfg, num_classes=survival_num_classes(cfg.TASK.NAME, 0), device=DEVICE))
    row = {
        "phase": phase, "card": card, "entry": "python -m imp_torch.tools.train",
        "argv": transmil_argv("ROOT", "OUT", attention), "slides": len(TRAIN_LENGTHS),
        "pinv_mode": None if attention == "flash" else "fused",
        "bag_pad": int(cfg.DATASET.BAG_PAD), "feature": int(cfg.DATASET.PATH.DIM),
        "batch": int(cfg.DATALOADER.TRAIN.BATCH_SIZE), "epochs": TRAIN_EPOCHS_FLASH,
        "train_steps": len(steps), "evaluations": len(tests), "eval_batches": eval_batches,
        "launches": counts, "launches_per_step": step_launches, "per_step_ok": per_step_ok,
        "eval_launches": eval_counts, "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss": losses[-1] if losses else None, "cindex_lines": cindex,
        "result_cindex": result, "checkpoint": ckpt_name, "checkpoint_epoch": ckpt_epoch,
        "seconds": seconds, "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(row)
    require(len(steps) > 0 and per_step_ok, f"kernels per TransMIL train step: {row}")
    require(eval_batches > 0
            and eval_counts == {k: v * eval_batches for k, v in eval_launches.items()},
            f"kernels per TransMIL eval batch: {row}")
    require(all(counts[k] == v * len(steps) for k, v in step_launches.items()
                if k not in eval_launches), row)
    require(row["losses_finite"] and result is not None and np.isfinite(result)
            and len(cindex) >= TRAIN_EPOCHS_FLASH + 1, f"TransMIL training: {row}")
    require(ckpt_epoch == TRAIN_EPOCHS_FLASH, f"last checkpoint is epoch {ckpt_epoch}")
    return row, counts


def phase_train_step_transmil(card: str, root: str, out: str, attention: str = "flash"):
    """One TransMIL step at a full 10 000-patch slide (10 001 tokens with
    cls) through the kernels against the plain versions (loss and every
    parameter gradient, same dropout draws): under flash against the plain
    flash attention, then its step time; at ``auto`` K6/K7 against the
    chain, then the step time of both modes."""
    import torch

    from imp_torch.engine import build_trainer

    flash = attention == "flash"
    cfg = transmil_cfg(**{"DATASET.ROOT": root, "OUTPUT_DIR": out, "VERBOSE": False, "SEED": 1,
                          "DATASET.FOLD": 1, "TRAINER.NAME": "TransMIL",
                          "TPU.ATTENTION": attention})
    with seeded_bags(), transmil_modes(attention):
        trainer = build_trainer(cfg, device=DEVICE)
        batch = max((b for loader in (trainer.train_loader, trainer.val_loader, trainer.test_loader)
                     if loader is not None for b in loader),
                    key=lambda b: int(b["img_mask"].sum()))
    db = trainer._device_batch(batch)
    model, g = trainer.model, trainer.generator
    state = g.get_state()
    names, params = zip(*model.named_parameters())

    def loss_and_grads():
        g.set_state(state)
        loss = trainer.task_loss(model(db, train=True, generator=g), db)
        return loss.detach(), {}, torch.autograd.grad(loss, params)

    check, counted = grads_check(loss_and_grads, plain_attention if flash else chain_pinv, names)
    require(only_launched(counted) == TRANSMIL_LAUNCHES[attention][0], counted)
    require(check["loss_rel"] <= STEP_TOL and check["grad_rel"] <= STEP_TOL,
            f"TransMIL step through the kernels vs the plain versions ({attention}): {check}")

    def step():
        return trainer.train_step(db)

    b = len(batch["patient_id"])
    row = {
        "phase": "train_step_transmil" if flash else "train_step_transmil_nystrom", "card": card,
        "check": check, "batch": b, "bag_valid": int(batch["img_mask"].sum()),
        "tokens": int(cfg.DATASET.BAG_PAD) + 1,
    }
    if flash:
        timing = time_step(step, FLASH_KERNEL_NAMES, timed=STEP_TIMED)
        row.update(**timing, slides_per_s=b / (timing["step_ms_median"] / 1e3))
        require(timing["loss_finite"], row)
    else:
        ab = pinv_ab(step, ())
        row.update(pinv_ab=ab, slides_per_s={m: b / (ab[m]["step_ms_median"] / 1e3)
                                             for m in ("chain", "fused")})
        require(all(t["loss_finite"] for m in ("chain", "fused") for t in ab[m]["turns"]), row)
        require(ab["fused"]["launches_per_step"] == TRANSMIL_LAUNCHES["auto"][0]
                and ab["chain"]["launches_per_step"] == {}, ab)
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phases 11-13: Classification, Grading and Subtyping
# ---------------------------------------------------------------------------

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
TASK_EPOCHS = 2  # plain, then GAN, the CCA epoch between them
TASK_STEP_TIMED = 6
#: the external cohort: TRAIN_LENGTHS' first 12 bags; these have no omics
EXTERNAL_SLIDES = 12
EXTERNAL_NO_OMICS = (1, 4, 7, 10)
#: launch counter -> the kernels it counts, by their names in the trace
TRACE_NAMES = {"flash_fwd": ("flash_fwd_kernel",),
               **{k: (v,) for k, v in BWD_KERNEL_SYMBOL.items()},
               **MOD_KERNEL_SYMBOLS,
               **{k: (v,) for k, v in PINV_KERNEL_SYMBOL.items()}}


def task_yaml(task: str, model: str) -> str:
    return os.path.join(CONFIGS, task, f"{model}.yaml")


def result_lines(log: str, *keys) -> dict:
    """The ``* key: X%`` values of the log, per key."""
    return {k: [float(line.split(":")[1].strip().rstrip("%")) for line in log.splitlines()
                if line.startswith(f"* {k}:")] for k in keys}


def importance_rows(path: str) -> list:
    """The row widths of an importance dump, one per slide."""
    with open(path) as f:
        return [len(line.split()) for line in f if line.strip()]


def phase_train_classification(card: str, root: str, out: str):
    """MBTRAIN on configs/Classification/UMEML_GAN.yaml (bilinear fusion, 6
    classes, the full widths) through the CLI for 2 epochs (plain, then GAN,
    the CCA epoch between): K4/K5 once per main step and never in the CCA
    epoch or the evaluations, the accuracy / AUC / macro-F1 block, one
    importance row per test slide, a strict reload of the last checkpoint."""
    import torch

    from imp_torch.engine.mbtrain import MBTRAIN
    from imp_torch.models import build_model
    from imp_torch.serving import even_gene_groups

    config = task_yaml("Classification", "UMEML_GAN")
    argv = ["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--config-file", config,
            "--output-dir", out, "--device", DEVICE, "OPTIM.MAX_EPOCH", str(TASK_EPOCHS),
            "TRAIN.CURRICULUM.GAN_START_EPOCH", "1", "TRAIN.CURRICULUM.REPLACE_START_EPOCH",
            str(TASK_EPOCHS)]
    result, counts, record, seconds, log = run_trainer(
        argv, MBTRAIN, ("train_step", "run_epoch_cca", "test"),
        "chip_smoke_train_classification_log.txt")
    steps = [r for r in record if r[0] == "train_step"]
    others = [r for r in record if r[0] != "train_step"]
    per_step_ok = all(only_launched(d) == {"modularity_deg": 1, "modularity_combined": 1}
                      for _, d, _, _ in steps)
    others_zero = all(not only_launched(d) for _, d, _, _ in others)
    metrics = [{k: float(v) for k, v in m.items()} for _, _, _, m in steps]
    finite = all(np.isfinite(list(m.values())).all() for m in metrics)
    lines = result_lines(log, "accuracy", "AUC", "macro_f1")
    cfg = yaml_cfg(config)
    with open(os.path.join(root, "tcga_glioma", "labels", "classification",
                           "classification_test_1.csv")) as f:
        num_test = len(f.read().split()) - 1  # rows after the header
    rows = {m: importance_rows(os.path.join(out, f"test_{m}.txt")) for m in ("path", "omic")}
    model = build_model("umeml_gan", cfg=cfg, num_classes=6,
                        gene_group_indexes=even_gene_groups(1000, 6), device=DEVICE)
    ckpt_name, ckpt_epoch = reload_last(out, model)
    head = {"fusion": model.fusion, "classes": model.classifier.out_features,
            "outer_product_features": model.mm.encoder1.in_features,
            "encoder1_width": model.mm.encoder1.out_features,
            "bilinear_params": sum(p.numel() for p in model.mm.parameters())}
    row = {
        "phase": "train_classification", "card": card, "entry": "python -m imp_torch.tools.train",
        "config": "configs/Classification/UMEML_GAN.yaml", "slides": len(TRAIN_LENGTHS),
        "batch": int(cfg.DATALOADER.TRAIN.BATCH_SIZE), "bag_pad": int(cfg.DATASET.BAG_PAD),
        "hidden": int(cfg.MODEL.HIDDEN_DIM), "genes": 1000, "epochs": TASK_EPOCHS, "head": head,
        "main_steps": len(steps), "gan_steps": sum("loss_gen" in m for m in metrics),
        "cca_epochs": sum(r[0] == "run_epoch_cca" for r in others),
        "evaluations": sum(r[0] == "test" for r in others), "launches": counts,
        "K4_K5_once_per_main_step": per_step_ok,
        "launches_outside_main_steps": 0 if others_zero else [r[:2] for r in others],
        "losses_finite": finite, "last_loss": metrics[-1] if metrics else None,
        "result_lines": lines, "result_accuracy": result, "test_slides": num_test,
        "importance_rows": {m: len(r) for m, r in rows.items()},
        "checkpoint": ckpt_name, "checkpoint_epoch": ckpt_epoch, "seconds": seconds,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(row)
    require(len(steps) > 0 and per_step_ok and others_zero, f"K4/K5 off the main steps: {row}")
    require(counts["modularity_deg"] == counts["modularity_combined"] == len(steps), row)
    require(finite and row["gan_steps"] > 0 and row["cca_epochs"] == TASK_EPOCHS - 1, row)
    require(all(len(v) >= TASK_EPOCHS + 1 for v in lines.values()) and result is not None,
            f"no accuracy / AUC / macro_f1 block: {lines}")
    require(rows["path"] == rows["omic"] == [cfg.MODEL.UMEML.PROTOTYPES] * num_test,
            f"importance rows per test slide: {rows}")
    require(ckpt_epoch == TASK_EPOCHS and head["classes"] == 6 and head["fusion"] == "bilinear",
            row)
    return row, counts


def trainer_for(config: str, root: str, out: str, trainer: str, **overrides):
    """A trainer on ``config`` (plus ``overrides``) over the seeded bags."""
    from imp_torch.engine import build_trainer

    cfg = yaml_cfg(config, **{"DATASET.ROOT": root, "OUTPUT_DIR": out, "VERBOSE": False,
                              "SEED": 1, "DATASET.FOLD": 1, "TRAINER.NAME": trainer, **overrides})
    with seeded_bags():
        return build_trainer(cfg, device=DEVICE)


def phase_train_step_tasks(card: str, root: str, out: str):
    """One main step per task through the kernels against the plain
    versions (loss and every gradient, same dropout draws), then its step
    time and device busy time: UMEML_GAN at Grading and Subtyping (K4/K5
    against the plain modularity), TransMIL at Subtyping under flash (K1-K3
    against the plain flash attention), UMEML at Classification with the
    fused pseudo-inverse (K6/K7 against the chain; K4/K5 run in both)."""
    import torch

    cases = (
        ("UMEML_GAN", "Grading", "MBTRAIN", {}, plain_modularity,
         {"modularity_deg": 1, "modularity_combined": 1}),
        ("UMEML_GAN", "Subtyping", "MBTRAIN", {}, plain_modularity,
         {"modularity_deg": 1, "modularity_combined": 1}),
        ("TransMIL", "Subtyping", "TransMIL", {"TPU.ATTENTION": "flash"}, plain_attention,
         {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}),
        ("UMEML", "Classification", "MBTRAIN", {}, chain_pinv,
         {"pinv_fwd": 6, "pinv_bwd": 6, "modularity_deg": 1, "modularity_combined": 1}),
    )
    rows = []
    for model_name, task, trainer_name, overrides, plain, launches in cases:
        fused = model_name == "UMEML"
        with pinv_mode("fused") if fused else contextlib.nullcontext():
            trainer = trainer_for(task_yaml(task, model_name), root, out, trainer_name,
                                  **overrides)
        with seeded_bags():  # TransMIL: the fullest slide; MBTRAIN: the first batch
            batch = (max((b for loader in (trainer.train_loader, trainer.test_loader)
                          for b in loader), key=lambda b: int(b["img_mask"].sum()))
                     if trainer_name == "TransMIL" else next(iter(trainer.train_loader)))
        db = trainer._device_batch(batch)
        model, g = trainer.model, trainer.generator
        require(not fused or fused_pinvs(model) == 6, "UMEML has six Nyström TransLayers, fused")
        state = g.get_state()
        names = [n for n, _ in model.named_parameters() if not n.startswith("gan_discriminator")]

        def loss_and_grads(model=model, db=db):
            g.set_state(state)
            params = [dict(model.named_parameters())[n] for n in names]
            out_ = model(db, train=True, generator=g)
            if trainer_name == "TransMIL":
                loss, extra = trainer.task_loss(out_, db), {}
            else:
                loss = (trainer.task_loss(out_["logits"], db) + out_["modular_loss"]
                        + out_.get("loss_kd", 0.0))
                extra = {"modular_loss": out_["modular_loss"].detach()}
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]
            return loss.detach(), extra, grads

        check, counted = grads_check(loss_and_grads, plain, names)
        require(only_launched(counted) == launches, f"{model_name} at {task}: {counted}")
        if check["grad_rel"] > STEP_TOL:
            check["float64"] = float64_check(loss_and_grads, model, db, plain, names)
        require(check["loss_rel"] <= STEP_TOL
                and (check["grad_rel"] <= STEP_TOL or check["float64"]["ok"])
                and check.get("modular_loss_rel", 0.0) <= STEP_TOL,
                f"{model_name} at {task} through the kernels vs the plain versions: {check}")

        def step():
            if trainer_name == "TransMIL":
                return trainer.train_step(db)
            return trainer.train_step(db, train_gan=model_name == "UMEML_GAN", replace_ratio=0.25)

        timing = time_step(step, tuple(n for k in launches for n in TRACE_NAMES[k]),
                           timed=TASK_STEP_TIMED)
        b = len(batch["patient_id"])
        head = model.mm if hasattr(model, "mm") else model.classifier
        rows.append({
            "model": model_name, "task": task, "config": f"configs/{task}/{model_name}.yaml",
            "classes": int(model.classifier.out_features),
            "fusion": getattr(model, "fusion", None),
            "head_params": sum(p.numel() for p in head.parameters()),
            "pinv_mode": "fused" if fused else None, "check": check,
            "launches_per_step": only_launched(counted), "batch": b,
            "bag_lengths": [int(x) for x in batch["img_mask"].sum(axis=1)], **timing,
            "slides_per_s": b / (timing["step_ms_median"] / 1e3),
        })
        require(timing["loss_finite"], rows[-1])
        del trainer, model, db
        torch.cuda.empty_cache()
    row = {"phase": "train_step_tasks", "card": card, "steps": rows}
    emit(row)
    return row


def float64_check(loss_and_grads, model, db, plain, names) -> dict:
    """For a step whose gradients miss the gate, or to record margins: the
    same step (same draws) through the kernels and the plain versions in
    float32 and the plain versions in float64, judged by
    :func:`float64_rule`."""
    import copy

    import torch

    m64 = copy.deepcopy(model).double()
    db64 = {k: v.double() if v.is_floating_point() else v for k, v in db.items()}
    _, _, kern = loss_and_grads()
    with plain():
        _, _, flat = loss_and_grads()
        _, _, exact = loss_and_grads(m64, db64)
    del m64, db64
    torch.cuda.empty_cache()
    return float64_rule(names, kern, flat, exact)


def float64_rule(names, kern, flat, exact) -> dict:
    """A gradient passes when the kernels (``kern``) are within STEP_TOL of
    the plain version (``flat``) or, where float32 cannot resolve it (the
    plain float32 gradient is itself more than STEP_TOL off the float64
    one, ``exact``), when the kernels are no further from the float64
    gradient than twice the plain float32 version.  ``params`` lists the
    gradients past STEP_TOL either way; ``worst`` names the farthest from
    float64 of each float32 run, with its distance (CMTA's step runs the
    check always)."""
    rows, ok, worst = {}, True, {"kernel_vs_float64": (None, 0.0), "plain_vs_float64": (None, 0.0)}
    for n, k, p, x in zip(names, kern, flat, exact):
        k_p, k_x, p_x = rel_err(k, p), rel_err(k.double(), x), rel_err(p.double(), x)
        passed = k_p <= STEP_TOL or (p_x > STEP_TOL and k_x <= 2 * p_x)
        ok &= passed
        for key, err in (("kernel_vs_float64", k_x), ("plain_vs_float64", p_x)):
            if err > worst[key][1]:
                worst[key] = (n, err)
        if k_p > STEP_TOL or p_x > STEP_TOL:
            rows[n] = {"kernel_vs_plain": k_p, "kernel_vs_float64": k_x,
                       "plain_vs_float64": p_x, "max_abs_grad": x.abs().max().item(),
                       "passed": passed}
    return {"ok": ok, "params": rows, "worst": worst}


def make_external_tree(root: str) -> None:
    """``<root>/test/``: the Grading labels of EXTERNAL_SLIDES patients
    (their bags are TRAIN_LENGTHS' first ones, from :func:`seeded_bags`,
    so each .h5 file is an empty stand-in that marks the slide as present),
    and molecular CSVs for all but EXTERNAL_NO_OMICS."""
    import csv

    ext = os.path.join(root, "test")
    for sub in ("labels/grading", "features_clip_vit_b16", "molecular"):
        os.makedirs(os.path.join(ext, sub), exist_ok=True)
    rng = np.random.default_rng(SEED + 100)
    rows = []
    for i in range(EXTERNAL_SLIDES):
        pid = f"CPTAC-{i:04d}-01A"
        open(os.path.join(ext, "features_clip_vit_b16", pid + ".h5"), "w").close()
        if i not in EXTERNAL_NO_OMICS:
            with open(os.path.join(ext, "molecular", pid + ".csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["gene_name", "fpkm_uq_unstranded"])
                w.writerows([f"GENE{g}", repr(float(v))] for g, v in
                            enumerate(rng.lognormal(1.0, 1.0, 1000).astype(np.float32)))
        rows.append([pid, i % 3])
    with open(os.path.join(ext, "labels", "grading", "grading_test.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patients", "labels"])
        w.writerows(rows)


def phase_test_new(card: str, root: str, out: str):
    """``python -m imp_torch.tools.test_new`` on the external cohort with the
    checkpoint of a one-epoch ``train`` on configs/Grading/UMEML_GAN.yaml:
    the slides without omics are served with ``without_omic = 1``, the
    accuracy is reported, one importance row per slide, no K4/K5 launch."""
    import torch

    from imp_torch import kernels
    from imp_torch.engine.mbtrain import MBTRAIN
    from imp_torch.tools.test_new import run as run_test_new

    config = task_yaml("Grading", "UMEML_GAN")
    train_out, ext_out = os.path.join(out, "train"), os.path.join(out, "test_new")
    common = ["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--config-file", config,
              "--device", DEVICE]
    _, train_counts, steps, train_seconds, _ = run_trainer(
        common + ["--output-dir", train_out, "OPTIM.MAX_EPOCH", "1"], MBTRAIN, ("train_step",),
        "chip_smoke_train_grading_log.txt")
    make_external_tree(root)

    served = []
    eval_batch = MBTRAIN._eval_batch

    def keep_flags(self, batch, split, batch_index):
        db = eval_batch(self, batch, split, batch_index)
        served.extend(zip(batch["patient_id"], db["without_omic"].tolist()))
        return db

    console = io.StringIO()
    MBTRAIN._eval_batch = keep_flags
    try:
        with seeded_bags(), contextlib.redirect_stdout(console):
            # ---- the main path: counts at 0 just before, read just after ------
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = run_test_new(common + ["--model-dir", train_out, "--output-dir", ext_out])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = kernels.launches()
    finally:
        MBTRAIN._eval_batch = eval_batch
    with open(os.path.join(ext_out, "log.txt")) as f:
        log = f.read()
    with open(os.path.join(LOG_DIR, "chip_smoke_test_new_log.txt"), "w") as f:
        f.write(log)
    rows = {m: importance_rows(os.path.join(ext_out, f"test_new_{m}.txt")) for m in ("path", "omic")}
    without = sorted(int(pid.split("-")[1]) for pid, w in served if w == 1.0)
    row = {
        "phase": "test_new", "card": card, "entry": "python -m imp_torch.tools.test_new",
        "config": "configs/Grading/UMEML_GAN.yaml", "train_steps": len(steps),
        "train_launches": train_counts, "train_seconds": train_seconds,
        "external_slides": EXTERNAL_SLIDES, "served": len(served),
        "served_without_omic": without, "launches": counts,
        "result_lines": result_lines(log, "accuracy", "AUC", "macro_f1"),
        "result_accuracy": result, "importance_rows": {m: len(r) for m, r in rows.items()},
        "seconds": seconds,
    }
    emit(row)
    require(len(served) == EXTERNAL_SLIDES and without == list(EXTERNAL_NO_OMICS),
            f"slides without omics not served through the generator: {row}")
    require(not only_launched(counts), f"kernels launched in the external evaluation: {row}")
    require(result is not None and np.isfinite(result)
            and "Evaluate on the *external test* set (12 samples)" in log
            and len(row["result_lines"]["accuracy"]) == 1, f"no accuracy reported: {row}")
    require(rows["path"] == rows["omic"] == [6] * EXTERNAL_SLIDES, f"importance rows: {rows}")
    return row


# ---------------------------------------------------------------------------
# phases 14-16: the baseline zoo
# ---------------------------------------------------------------------------

ZOO = ("MCAT", "CMTA", "Porpoise", "ConCAT", "ADD", "HFB", "SNN", "SNNM")
ZOO_ACCUM = 4  # MCAT's OPTIM.GRAD_ACCUM in train_zoo (its default is 32)
#: the kernels of one CMTA train step and of one eval batch: its eight
#: TransLayers under flash (K1, K2, K3) or Nyström with the fused mode (K6, K7)
CMTA_LAUNCHES = {
    "flash": ({"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}, {"flash_fwd": 8}),
    "auto": ({"pinv_fwd": 8, "pinv_bwd": 8}, {"pinv_fwd": 8}),
}


def zoo_argv(root: str, out: str, trainer: str, task: str = "Survival", *opts) -> list:
    """One epoch of ``trainer`` through the CLI on its config of ``task``."""
    return ["--root", root, "--seed", "1", "--trainer", trainer, "--config-file",
            task_yaml(task, trainer), "--output-dir", out, "--device", DEVICE,
            "OPTIM.MAX_EPOCH", "1", *opts]


@contextlib.contextmanager
def watched_steps(record: list):
    """After each ``StandardTrainer.train_step``: the trainer, its
    optimizer's update count and whether any parameter moved."""
    import torch

    from imp_torch.engine.trainer import StandardTrainer

    step = StandardTrainer.train_step

    def wrapper(self, db):
        before = [p.detach().clone() for p in self.model.parameters()]
        out = step(self, db)
        moved = any(not torch.equal(a, p) for a, p in zip(before, self.model.parameters()))
        record.append((self, self.optimizer.updates, moved))
        return out

    StandardTrainer.train_step = wrapper
    try:
        yield
    finally:
        StandardTrainer.train_step = step


def phase_train_zoo(card: str, root: str, out: str):
    """Each of the eight zoo trainers for one epoch through the CLI on its
    Survival config (full widths, batch 1, ``TPU.ATTENTION`` at its default,
    so no kernel launches), plus Porpoise at Classification: losses finite,
    the metric line, a strict reload of the epoch's checkpoint; MCAT at
    ``OPTIM.GRAD_ACCUM`` 4 updates once per 4 steps and its parameters stay
    still between; HFB's BatchNorm statistics move and its reload gives the
    same eval logits."""
    import torch

    from imp_torch.engine.trainer import StandardTrainer
    from imp_torch.models import build_model

    runs, seconds_all = [], 0.0
    for trainer_name, task in [(t, "Survival") for t in ZOO] + [("Porpoise", "Classification")]:
        run_out = os.path.join(out, f"{trainer_name}_{task}")
        opts = ("OPTIM.GRAD_ACCUM", str(ZOO_ACCUM)) if trainer_name == "MCAT" else ()
        steps = []
        with watched_steps(steps):
            result, counts, record, seconds, log = run_trainer(
                zoo_argv(root, run_out, trainer_name, task, *opts), StandardTrainer,
                ("train_step",), f"chip_smoke_zoo_{trainer_name}_{task}_log.txt")
        seconds_all += seconds
        trainer = steps[-1][0]
        losses = [float(m["loss"]) for _, _, _, m in record]
        metric = "accuracy" if task == "Classification" else "C-Index"
        lines = [line for line in log.splitlines() if line.startswith(f"* {metric}:")]
        model = build_model(trainer.MODEL_NAME, cfg=trainer.cfg,
                            num_classes=trainer.model.classifier.out_features,
                            device=DEVICE, **trainer.build_kwargs())
        ckpt_name, ckpt_epoch = reload_last(run_out, model)
        row = {"trainer": trainer_name, "config": f"configs/{task}/{trainer_name}.yaml",
               "bag_pad": int(trainer.cfg.DATASET.BAG_PAD),
               "feature": int(trainer.cfg.DATASET.PATH.DIM), "genes": trainer.dm.omic_dim,
               "batch": int(trainer.cfg.DATALOADER.TRAIN.BATCH_SIZE),
               "classes": int(trainer.model.classifier.out_features),
               "params": sum(p.numel() for p in trainer.model.parameters()),
               "train_steps": len(steps), "launches": only_launched(counts),
               "losses_finite": bool(np.isfinite(losses).all()), "last_loss": losses[-1],
               "metric_lines": lines, "result": result, "checkpoint": ckpt_name,
               "checkpoint_epoch": ckpt_epoch, "seconds": seconds}
        require(len(steps) > 0 and row["losses_finite"] and len(lines) >= 2
                and result is not None and np.isfinite(result) and ckpt_epoch == 1,
                f"zoo trainer {trainer_name} at {task}: {row}")
        require(not row["launches"], f"kernels launched at the default attention: {row}")
        if trainer_name == "MCAT":
            moved = [m for _, _, m in steps]
            row.update(grad_accum=int(trainer.cfg.OPTIM.GRAD_ACCUM),
                       optimizer_updates=steps[-1][1],
                       moved_at_steps=[i + 1 for i, m in enumerate(moved) if m])
            require(row["grad_accum"] == ZOO_ACCUM
                    and row["optimizer_updates"] == len(steps) // ZOO_ACCUM
                    and moved == [(i + 1) % ZOO_ACCUM == 0 for i in range(len(steps))],
                    f"MCAT's gradient accumulation: {row}")
        if trainer_name == "HFB":
            norm = trainer.model.fusion_module.norm
            with seeded_bags():
                db = trainer._device_batch(next(iter(trainer.test_loader)))
            with torch.no_grad():
                diff = (model(db)["logits"] - trainer.model(db)["logits"]).abs().max().item()
            row.update(running_var_moved=bool((norm.running_var != 1).any()),
                       running_mean_moved=bool((norm.running_mean != 0).any()),
                       reload_eval_logits_max_abs_diff=diff)
            require(row["running_var_moved"] and row["running_mean_moved"] and diff <= 1e-6,
                    f"HFB's batch statistics through a reload: {row}")
        runs.append(row)
        del trainer, model, steps
        torch.cuda.empty_cache()
    row = {"phase": "train_zoo", "card": card, "entry": "python -m imp_torch.tools.train",
           "slides": len(TRAIN_LENGTHS), "epochs": 1, "runs": runs, "seconds": seconds_all}
    emit(row)
    return row


def cmta_modes(attention: str):
    """Under Nyström the CMTA runs build their models fused."""
    return contextlib.nullcontext() if attention == "flash" else pinv_mode("fused")


def phase_train_cmta(card: str, root: str, out: str, attention: str = "flash"):
    """CMTA for one epoch through the CLI at full width, under flash (K1 once
    per TransLayer call, K2 and K3 once per call with grad: 8 each per train
    step, K1 8 per eval batch) or at ``auto`` with the fused pseudo-inverse
    (K6 and K7 8 per train step, K6 8 per eval batch), nothing else; losses
    finite, the C-index line, a strict reload."""
    import torch

    from imp_torch.engine.fusion_trainers import CMTA
    from imp_torch.models import build_model

    phase = "train_cmta" if attention == "flash" else "train_cmta_nystrom"
    step_launches, eval_launches = CMTA_LAUNCHES[attention]
    with cmta_modes(attention):
        result, counts, record, seconds, log = run_trainer(
            zoo_argv(root, out, "CMTA", "Survival", "TPU.ATTENTION", attention), CMTA,
            ("train_step", "test", "_eval_batch"), f"chip_smoke_{phase}_log.txt")
        steps = [r for r in record if r[0] == "train_step"]
        tests = [r for r in record if r[0] == "test"]
        eval_batches = sum(r[0] == "_eval_batch" for r in record)
        per_step_ok = all(only_launched(d) == step_launches and c == {"calls": 8, "grad": 8}
                          for _, d, c, _ in steps)
        eval_counts = only_launched({k: sum(d[k] for _, d, _, _ in tests) for k in counts})
        losses = [float(m["loss"]) for _, _, _, m in steps]
        cindex = [line for line in log.splitlines() if line.startswith("* C-Index:")]
        cfg = yaml_cfg(task_yaml("Survival", "CMTA"), **{"TPU.ATTENTION": attention})
        model = build_model("cmta", cfg=cfg, num_classes=4, device=DEVICE)
    ckpt_name, ckpt_epoch = reload_last(out, model)
    row = {
        "phase": phase, "card": card, "entry": "python -m imp_torch.tools.train",
        "argv": zoo_argv("ROOT", "OUT", "CMTA", "Survival", "TPU.ATTENTION", attention),
        "pinv_mode": None if attention == "flash" else "fused",
        "fused_pinvs": fused_pinvs(model), "slides": len(TRAIN_LENGTHS), "batch": 1,
        "tokens": {"bag": int(cfg.DATASET.BAG_PAD) + 1, "genomics": 6}, "epochs": 1,
        "train_steps": len(steps), "evaluations": len(tests), "eval_batches": eval_batches,
        "launches": counts, "launches_per_step": step_launches, "per_step_ok": per_step_ok,
        "eval_launches": eval_counts, "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss": losses[-1] if losses else None, "cindex_lines": cindex,
        "result_cindex": result, "checkpoint": ckpt_name, "checkpoint_epoch": ckpt_epoch,
        "seconds": seconds, "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(row)
    require(len(steps) > 0 and per_step_ok, f"kernels per CMTA train step: {row}")
    require(eval_batches > 0
            and eval_counts == {k: v * eval_batches for k, v in eval_launches.items()},
            f"kernels per CMTA eval batch: {row}")
    require(all(counts[k] == v * len(steps) for k, v in step_launches.items()
                if k not in eval_launches), row)
    require(attention == "flash" or row["fused_pinvs"] == 8, row)
    require(row["losses_finite"] and result is not None and np.isfinite(result)
            and len(cindex) >= 2 and ckpt_epoch == 1, f"CMTA training: {row}")
    return row, counts


def phase_train_step_cmta(card: str, root: str, out: str):
    """One CMTA step at a full 10 000-patch slide (the alignment loss
    included, same dropout draws) through the kernels against the plain
    versions, for each mode: under flash against the plain flash attention
    (K1-K3), at ``auto`` fused against the chain (K6/K7); the loss and every
    gradient within STEP_TOL, or within :func:`float64_check`'s arbitration,
    whose margins are recorded for every gradient float32 cannot resolve;
    then the step time (flash) and the chain/fused A/B (auto), each with its
    device busy time and idle share."""
    import torch

    rows, batch = {}, None
    for attention in ("flash", "auto"):
        flash = attention == "flash"
        clock = {"start": time.perf_counter()}
        with cmta_modes(attention):
            trainer = trainer_for(task_yaml("Survival", "CMTA"), root, out, "CMTA",
                                  **{"TPU.ATTENTION": attention})
        if batch is None:  # the fullest slide, the same for both modes
            with seeded_bags():
                batch = max((b for loader in (trainer.train_loader, trainer.test_loader)
                             for b in loader), key=lambda b: int(b["img_mask"].sum()))
        db = trainer._device_batch(batch)
        clock["built"] = time.perf_counter()
        model, g = trainer.model, trainer.generator
        state = g.get_state()
        names = [n for n, _ in model.named_parameters()]

        def loss_and_grads(model=model, db=db):
            g.set_state(state)
            params = [dict(model.named_parameters())[n] for n in names]
            out_ = model(db, train=True, generator=g)
            align = trainer.extra_loss(out_, db)
            loss = trainer.task_loss(out_["logits"], db) + align
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]
            return loss.detach(), {"alignment_loss": align.detach()}, grads

        plain = plain_attention if flash else chain_pinv
        check, counted = grads_check(loss_and_grads, plain, names)
        require(only_launched(counted) == CMTA_LAUNCHES[attention][0], counted)
        clock["checked"] = time.perf_counter()
        check["float64"] = float64_check(loss_and_grads, model, db, plain, names)
        clock["float64"] = time.perf_counter()
        require(check["loss_rel"] <= STEP_TOL and check["alignment_loss_rel"] <= STEP_TOL
                and (check["grad_rel"] <= STEP_TOL or check["float64"]["ok"]),
                f"CMTA step through the kernels vs the plain versions ({attention}): {check}")

        def step():
            return trainer.train_step(db)

        b = len(batch["patient_id"])
        row = {"check": check, "batch": b, "bag_valid": int(batch["img_mask"].sum()),
               "tokens": int(trainer.cfg.DATASET.BAG_PAD) + 1}
        if flash:
            timing = time_step(step, FLASH_KERNEL_NAMES, timed=STEP_TIMED)
            row.update(**timing, slides_per_s=b / (timing["step_ms_median"] / 1e3))
            require(timing["loss_finite"], row)
        else:
            ab = pinv_ab(step, ())
            row.update(pinv_ab=ab, slides_per_s={m: b / (ab[m]["step_ms_median"] / 1e3)
                                                 for m in ("chain", "fused")})
            require(all(t["loss_finite"] for m in ("chain", "fused") for t in ab[m]["turns"]), row)
            require(ab["fused"]["launches_per_step"] == CMTA_LAUNCHES["auto"][0]
                    and ab["chain"]["launches_per_step"] == {}, ab)
        stamps = list(clock.values()) + [time.perf_counter()]
        row["seconds"] = dict(zip(("build", "check", "float64", "timing"),
                                  np.diff(stamps).tolist()))
        rows[attention] = row
        del trainer, model, db
        torch.cuda.empty_cache()
    row = {"phase": "train_step_cmta", "card": card, "flash": rows["flash"],
           "nystrom": rows["auto"]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phases 17-20: the CLIP towers, CLIPOMIC and the PLIP prototypes
# ---------------------------------------------------------------------------

CLIP_MODEL = "ViT-B/16"
CLIP_SLIDES, CLIP_PATCHES, CLIP_BATCH = 2, 512, 32  # two slides of 512 patches, the CLI's batch
CLIP_SWEEP = (32, 64, 128, 256)
CLIP_SWEEP_IMAGES = 1024  # images timed per (precision, batch) of the sweep
#: card fp32 features vs the same tower replayed in float64 on the CPU,
#: max |error| over max |feature|: fp32 products (TF32 off for matmuls and
#: cuDNN, as ``imp_torch.models.build_module`` sets) through 12 blocks of 768
CLIP_TOL = 1e-4
CLIP_BF16_COS = 0.99  # --prec bf16 features vs fp32, cosine per patch
CLIP_REPLAY_IMAGES = 2
RN_MODEL, RN_BATCH = "RN50", 8
CLIPOMIC_TASKS = ("Survival", "Classification", "Grading", "Subtyping")
PROMPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prompts", "prompt.json")
PLIP_EPOCHS = 2  # plain, then GAN, the CCA epoch between


def vit_flops(name: str = CLIP_MODEL) -> dict:
    """Operations (2 per multiply-add) of one image through the ViT, from
    its shapes: n = (res / patch)² + 1 tokens of width w, L blocks; the
    patchify 2·(n-1)·p²·3·w, per block qkv 2·n·w·3w, scores and P·V
    2·2·n²·w, out_proj 2·n·w², MLP 2·2·n·w·4w, then proj 2·w·out.  The
    LayerNorms, softmax and QuickGELU (~0.1 % more) are left out."""
    from imp_torch.models.clip import CLIP_CONFIGS

    c = CLIP_CONFIGS[name]
    p, w, depth = c["vision_patch_size"], c["vision_width"], c["vision_layers"]
    n = (c["image_resolution"] // p) ** 2 + 1
    block = 2 * n * w * 3 * w + 4 * n * n * w + 2 * n * w * w + 4 * n * w * 4 * w
    return {"tokens": n, "width": w, "layers": depth,
            "flops_per_image": 2 * (n - 1) * p * p * 3 * w + depth * block + 2 * w * c["embed_dim"],
            "formula": "2(n-1)p²·3w + L·(6nw² + 4n²w + 2nw² + 16nw²) + 2w·out"}


def float64_replay(model, x_u8):
    """The tower's features of ``x_u8`` replayed in float64 on the CPU."""
    import copy

    import torch

    from imp_torch.tools.clip_feature import device_normalize

    ref = copy.deepcopy(model).to("cpu", torch.float64)
    with torch.no_grad():
        return ref(device_normalize(x_u8.cpu(), torch.float64))


def rel_max_err(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@contextlib.contextmanager
def captured(cls, name: str, grab):
    """``grab(self, result)`` after every call of ``cls.name`` (a method
    of ``cls``'s own) while the block runs."""
    method = cls.__dict__[name]

    def wrapper(self, *args, **kw):
        out = method(self, *args, **kw)
        grab(self, out)
        return out

    setattr(cls, name, wrapper)
    try:
        yield
    finally:
        setattr(cls, name, method)


def phase_clip_vit_b16(card: str):
    """The ViT-B/16 image tower at full width (12 blocks of width 768, 12
    heads, 197 tokens at 224 px), random weights from SEED, through
    ``imp_torch.tools.clip_feature``'s per-slide encode loop: two slides of
    512 synthetic uint8 patches at batch 32, in fp32 and in bf16 (the
    tool's ``--prec bf16``); 2 images' fp32 features held to their float64
    CPU replay (CLIP_TOL) and the bf16 features' cosine to the fp32 ones
    (CLIP_BF16_COS); then images/s and the share of the compute bound at
    batch 32-256, the loop's device-busy share and the peak memory."""
    import torch

    from imp_torch import kernels
    from imp_torch.models.clip import CLIP_CONFIGS
    from imp_torch.tools.clip_feature import build_encoder, encode_slide

    size, dim = (CLIP_CONFIGS[CLIP_MODEL][k] for k in ("image_resolution", "embed_dim"))
    patches = np.random.default_rng(SEED).integers(
        0, 256, size=(CLIP_SLIDES * CLIP_PATCHES, size, size, 3), dtype=np.uint8)
    towers, encoders = {}, {}
    for prec in ("fp32", "bf16"):  # the same weights, cast for bf16
        towers[prec], encoders[prec] = build_encoder(
            CLIP_MODEL, DEVICE, prec, generator=torch.Generator().manual_seed(SEED))
    x = torch.from_numpy(patches[:CLIP_REPLAY_IMAGES]).to(DEVICE)
    replay_err = rel_max_err(encoders["fp32"](x).cpu(), float64_replay(towers["fp32"], x))

    def slide(prec, s):
        items = list(range(s * CLIP_PATCHES, (s + 1) * CLIP_PATCHES))
        return encode_slide(encoders[prec], lambda i: patches[i], items, CLIP_BATCH, size, DEVICE)

    kernels.reset_launches()
    loop, feats = {}, {}
    for prec in ("fp32", "bf16"):
        slide(prec, 0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        feats[prec] = np.concatenate([slide(prec, s) for s in range(CLIP_SLIDES)])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = device_busy_ms(lambda prec=prec: slide(prec, 1), iters=1)
        slide_ms = wall / CLIP_SLIDES * 1e3
        loop[prec] = {"images": len(feats[prec]), "seconds": wall,
                      "images_per_s": len(feats[prec]) / wall, "slide_ms": slide_ms,
                      "device_busy_ms_per_slide": busy,
                      "device_busy_share": None if busy is None else busy / slide_ms,
                      "peak_device_gib": peak}
    launches = only_launched(kernels.launches())
    direct = encoders["fp32"](torch.from_numpy(patches[:CLIP_BATCH]).to(DEVICE)).cpu().numpy()
    f32, f16 = feats["fp32"], feats["bf16"]
    cos = (f32 * f16).sum(1) / (np.linalg.norm(f32, axis=1) * np.linalg.norm(f16, axis=1))
    checks = {"replay_images": CLIP_REPLAY_IMAGES, "replay_rel_err": replay_err,
              "replay_tol": CLIP_TOL, "loop_vs_direct_rel_err": rel_max_err(f32[:CLIP_BATCH], direct),
              "bf16_cos_min": float(cos.min()), "bf16_cos_mean": float(cos.mean()),
              "bf16_cos_floor": CLIP_BF16_COS, "shape": list(f32.shape),
              "finite": bool(np.isfinite(f32).all() and np.isfinite(f16).all())}

    flops = vit_flops()
    peaks = {"fp32": PEAK_FP32_FLOPS, "bf16": PEAK_BF16_FLOPS}
    sweep = {}
    for prec in ("fp32", "bf16"):
        weight_bytes = sum(p.numel() * p.element_size() for p in towers[prec].parameters())
        for bs in CLIP_SWEEP:
            xb = torch.from_numpy(patches[:bs]).to(DEVICE)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: encoders[prec](xb), max(2, CLIP_SWEEP_IMAGES // bs), warmup=2)
            ops_ms = bs * flops["flops_per_image"] / peaks[prec] * 1e3
            bytes_ms = (weight_bytes + xb.numel() + bs * dim * 4) / PEAK_BYTES * 1e3
            bound = max(ops_ms, bytes_ms)
            sweep[f"{prec}_b{bs}"] = {
                "batch": bs, "ms": ms, "images_per_s": bs / (ms / 1e3), "bound_ms": bound,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": bound / ms,
                "achieved_tflops": bs * flops["flops_per_image"] / ms / 1e9,
                "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    busy32 = device_busy_ms(lambda: encoders["fp32"](torch.from_numpy(patches[:CLIP_BATCH])
                                                     .to(DEVICE)), iters=3)
    where = {}  # where the device time of one batch of 256 goes, by kernel
    for prec in ("fp32", "bf16"):
        xb = torch.from_numpy(patches[:CLIP_SWEEP[-1]]).to(DEVICE)
        rows = sorted(device_rows(profiled(lambda: encoders[prec](xb), 3)),
                      key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in rows) or 1.0
        where[prec] = [{"kernel": e.key[:120], "ms": e.self_device_time_total / 3 / 1e3,
                        "share": e.self_device_time_total / total} for e in rows[:8]]
    row = {"phase": "clip_vit_b16", "card": card, "model": CLIP_MODEL,
           "entry": "imp_torch.tools.clip_feature.encode_slide", "slides": CLIP_SLIDES,
           "patches_per_slide": CLIP_PATCHES, "batch": CLIP_BATCH, "image": size,
           "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_tf32": torch.backends.cudnn.allow_tf32,
           "bound": {**flops, "fp32_peak_flops": PEAK_FP32_FLOPS,
                     "bf16_peak_flops": PEAK_BF16_FLOPS,
                     "fp32_images_per_s": PEAK_FP32_FLOPS / flops["flops_per_image"],
                     "bf16_images_per_s": PEAK_BF16_FLOPS / flops["flops_per_image"]},
           "checks": checks, "loop": loop, "sweep": sweep,
           "fp32_b32_device_busy_ms": busy32, "top_kernels_b256": where, "launches": launches}
    emit(row)
    require(replay_err <= CLIP_TOL, f"ViT-B/16 fp32 vs its float64 replay: {checks}")
    require(checks["finite"] and f32.shape == (CLIP_SLIDES * CLIP_PATCHES, dim), checks)
    require(checks["loop_vs_direct_rel_err"] <= CLIP_TOL, f"encode loop vs direct: {checks}")
    require(checks["bf16_cos_min"] >= CLIP_BF16_COS, f"bf16 vs fp32 features: {checks}")
    require(not launches, f"the CLIP tower launched a ported kernel: {launches}")
    del towers, encoders
    torch.cuda.empty_cache()
    return row


def phase_clip_rn50(card: str):
    """One batch of 8 through the RN50 ModifiedResNet tower at 224 px
    (random weights and running statistics from SEED) on the card, held to
    its float64 CPU replay (CLIP_TOL)."""
    import torch

    from imp_torch.models import build_module
    from imp_torch.models.clip import CLIP_CONFIGS, FrozenBatchNorm2d, build_vision_tower
    from imp_torch.tools.clip_feature import device_normalize

    model = build_module(lambda: build_vision_tower(RN_MODEL), DEVICE,
                         torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():  # running statistics away from 0 and 1, so that the check reads them
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    size = CLIP_CONFIGS[RN_MODEL]["image_resolution"]
    x = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, 256, size=(RN_BATCH, size, size, 3), dtype=np.uint8)).to(DEVICE)

    def encode():
        with torch.no_grad():
            return model(device_normalize(x, torch.float32))

    got = encode()
    err = rel_max_err(got.cpu(), float64_replay(model, x))
    row = {"phase": "clip_rn50", "card": card, "model": RN_MODEL, "batch": RN_BATCH,
           "image": size, "shape": list(got.shape), "replay_rel_err": err, "replay_tol": CLIP_TOL,
           "finite": bool(torch.isfinite(got).all()), "ms": cuda_ms(encode, 10),
           "cudnn_tf32": torch.backends.cudnn.allow_tf32}
    emit(row)
    require(row["finite"] and err <= CLIP_TOL, f"RN50 vs its float64 replay: {row}")
    del model
    torch.cuda.empty_cache()
    return row


def openai_text_state(seed: int) -> dict:
    """A random OpenAI CLIP ``state_dict`` of ViT-B/16's text tower (12
    blocks of width 512, context 77, vocabulary 49 408), float32, from
    ``seed``: what ``MODEL.BACKBONE.CLIP_CHECKPOINT`` names."""
    import torch

    from imp_torch.models.clip import CLIP_CONFIGS

    c = CLIP_CONFIGS[CLIP_MODEL]
    w = c["transformer_width"]
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std):
        return torch.randn(*shape, generator=g) * std

    state = {"token_embedding.weight": r(c["vocab_size"], w, std=0.02),
             "positional_embedding": r(c["context_length"], w, std=0.01),
             "text_projection": r(w, c["embed_dim"], std=w**-0.5),
             "ln_final.weight": torch.ones(w), "ln_final.bias": torch.zeros(w)}
    for i in range(c["transformer_layers"]):
        p = f"transformer.resblocks.{i}."
        state.update({
            p + "ln_1.weight": torch.ones(w), p + "ln_1.bias": torch.zeros(w),
            p + "attn.in_proj_weight": r(3 * w, w, std=w**-0.5),
            p + "attn.in_proj_bias": torch.zeros(3 * w),
            p + "attn.out_proj.weight": r(w, w, std=w**-0.5), p + "attn.out_proj.bias": torch.zeros(w),
            p + "ln_2.weight": torch.ones(w), p + "ln_2.bias": torch.zeros(w),
            p + "mlp.c_fc.weight": r(4 * w, w, std=w**-0.5), p + "mlp.c_fc.bias": torch.zeros(4 * w),
            p + "mlp.c_proj.weight": r(w, 4 * w, std=(4 * w) ** -0.5),
            p + "mlp.c_proj.bias": torch.zeros(w)})
    return state


def phase_train_clipomic(card: str, root: str, out: str):
    """CLIPOMIC at the full text width (12 blocks of 512, 8 heads, context
    77, vocabulary 49 408) for one epoch through the CLI on each task's
    config, its text tower loaded from a random OpenAI-layout checkpoint
    (``MODEL.BACKBONE.CLIP_CHECKPOINT``): the tower holds the checkpoint's
    values after the build, every frozen tensor keeps its bits through the
    epoch and every trainable one moves, the metric line, a strict reload
    of the epoch's checkpoint (frozen tensors included), no kernel launch."""
    import shutil

    import torch

    from imp_torch.convert import convert_torch_clip_state
    from imp_torch.engine.baselines import CLIPOMIC
    from imp_torch.engine.trainer import StandardTrainer
    from imp_torch.models import build_model

    os.makedirs(out, exist_ok=True)
    ckpt = os.path.join(out, "clip_text.pt")
    state = openai_text_state(SEED)
    torch.save(state, ckpt)
    _, txt = convert_torch_clip_state(state, CLIP_MODEL)
    del state
    runs, seconds_all = [], 0.0
    for task in CLIPOMIC_TASKS:
        run_out = os.path.join(out, task)
        init, steps = {}, []

        def grab(_trainer, net):
            init.update({k: v.detach().clone() for k, v in net.state_dict().items()})

        with captured(CLIPOMIC, "build_network", grab), watched_steps(steps):
            result, counts, record, seconds, log = run_trainer(
                zoo_argv(root, run_out, "CLIPOMIC", task, "MODEL.BACKBONE.CLIP_CHECKPOINT", ckpt),
                StandardTrainer, ("train_step",), f"chip_smoke_clipomic_{task}_log.txt")
        seconds_all += seconds
        trainer = steps[-1][0]
        labels = trainer.param_labels()
        final = trainer.model.state_dict()
        frozen = [k for k, lab in labels.items() if lab == "frozen"]
        trainable = [k for k, lab in labels.items() if lab == "train"]
        loaded = all(torch.equal(init["genomic_backbone." + k], v.to(DEVICE)) for k, v in txt.items())
        frozen_kept = [k for k in frozen if torch.equal(final[k], init[k])]
        moved = [k for k in trainable if not torch.equal(final[k], init[k])]
        model = build_model("clipomic", cfg=trainer.cfg,
                            num_classes=trainer.model.classifier.out_features, device=DEVICE,
                            **trainer.build_kwargs())
        ckpt_name, ckpt_epoch = reload_last(run_out, model)
        reloaded = model.state_dict()
        losses = [float(m["loss"]) for _, _, _, m in record]
        metric = "C-Index" if task == "Survival" else "accuracy"
        lines = [line for line in log.splitlines() if line.startswith(f"* {metric}:")]
        row = {"task": task, "config": f"configs/{task}/CLIPOMIC.yaml",
               "text": {k: int(trainer.cfg.MODEL.BACKBONE[f"TEXT_{k.upper()}"])
                        for k in ("width", "heads", "layers", "vocab", "context")},
               "params": sum(p.numel() for p in trainer.model.parameters()),
               "frozen_params": sum(final[k].numel() for k in frozen),
               "trainable_tensors": len(trainer.optimizer.params),
               "train_steps": len(steps), "launches": only_launched(counts),
               "checkpoint_loaded": loaded, "frozen_tensors": len(frozen),
               "frozen_same_bits": len(frozen_kept), "trainable_tensors_moved": len(moved),
               "losses_finite": bool(np.isfinite(losses).all()), "last_loss": losses[-1],
               "metric_lines": lines, "result": result, "checkpoint": ckpt_name,
               "checkpoint_epoch": ckpt_epoch,
               "reload_frozen_same_bits": all(torch.equal(reloaded[k], init[k]) for k in frozen),
               "seconds": seconds}
        require(loaded and len(frozen_kept) == len(frozen) > 0 and len(moved) == len(trainable),
                f"CLIPOMIC's frozen text tower at {task}: {row}")
        require(len(steps) > 0 and row["losses_finite"] and len(lines) >= 2
                and result is not None and np.isfinite(result) and ckpt_epoch == 1
                and row["reload_frozen_same_bits"], f"CLIPOMIC at {task}: {row}")
        require(not row["launches"], f"kernels launched by CLIPOMIC: {row}")
        runs.append(row)
        del trainer, model, steps, init, final, reloaded
        shutil.rmtree(run_out)  # two checkpoints of 0.25 GB each
        torch.cuda.empty_cache()
    row = {"phase": "train_clipomic", "card": card, "entry": "python -m imp_torch.tools.train",
           "slides": len(TRAIN_LENGTHS), "epochs": 1, "runs": runs, "seconds": seconds_all}
    emit(row)
    return row


def phase_plip_umeml_gan(card: str, root: str, out: str):
    """PLIP prototypes into UMEML_GAN: ``python -m
    imp_torch.tools.extract_prototypes`` on the card over seeded [33, 512]
    prompt embeddings in the row order of prompts/prompt.json (6 categories),
    then MBTRAIN on UMEML_GAN.yaml's values (hidden 256, 6 prototypes) for 2
    epochs with ``MODEL.UMEML.PROTO_INIT plip``: the model's initial
    prototypes equal the ``.npy`` file, K4/K5 launch once per main step."""
    import json

    import torch

    from imp_torch.engine.mbtrain import MBTRAIN
    from imp_torch.tools import extract_prototypes

    os.makedirs(out, exist_ok=True)
    with open(PROMPTS) as f:
        counts_per_category = [len(v) for v in json.load(f).values()]
    emb = np.random.default_rng(SEED).standard_normal((sum(counts_per_category), 512),
                                                      dtype=np.float32)
    emb_path, proto_path = os.path.join(out, "plip_embeddings.npy"), os.path.join(
        out, "prototypes_plip.npy")
    np.save(emb_path, emb)
    console = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(console):
        protos = extract_prototypes.main([
            "--prompts", PROMPTS, "--embeddings", emb_path, "--out", proto_path,
            "--target-dim", str(FLAGSHIP["MODEL.HIDDEN_DIM"]), "--device", DEVICE])
    ae_seconds = time.perf_counter() - t0
    require(protos.shape == (1, len(counts_per_category), FLAGSHIP["MODEL.HIDDEN_DIM"])
            and np.isfinite(protos).all(), f"PLIP prototypes {protos.shape}")

    init = {}
    argv = ["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--output-dir", out,
            "--device", DEVICE] + flagship_opts(**{
                "OPTIM.MAX_EPOCH": PLIP_EPOCHS, "TRAIN.CURRICULUM.GAN_START_EPOCH": 1,
                "MODEL.UMEML.PROTO_INIT": "plip"})
    with captured(MBTRAIN, "build_model",
                  lambda self, _: init.update(p_proto=self.model.p_proto.detach().cpu().clone())):
        result, counts, record, seconds, log = run_trainer(
            argv, MBTRAIN, ("train_step", "run_epoch_cca", "test"),
            "chip_smoke_plip_umeml_gan_log.txt")
    steps = [r for r in record if r[0] == "train_step"]
    others = [r for r in record if r[0] != "train_step"]
    metrics = [{k: float(v) for k, v in m.items()} for _, _, _, m in steps]
    cindex = [line for line in log.splitlines() if line.startswith("* cindex:")]
    row = {"phase": "plip_umeml_gan", "card": card,
           "entry": "python -m imp_torch.tools.extract_prototypes; python -m imp_torch.tools.train",
           "prompts": sum(counts_per_category), "categories": len(counts_per_category),
           "prototypes_shape": list(protos.shape), "extract_seconds": ae_seconds,
           "ae_log": console.getvalue().splitlines()[-2:],
           "initial_prototypes_equal_npy": bool(np.array_equal(init["p_proto"].numpy(), protos)),
           "epochs": PLIP_EPOCHS, "main_steps": len(steps),
           "gan_steps": sum("loss_gen" in m for m in metrics), "launches": counts,
           "K4_K5_once_per_main_step": all(d["modularity_deg"] == d["modularity_combined"] == 1
                                           for _, d, _, _ in steps),
           "K4_K5_outside_main_steps": sum(d["modularity_deg"] + d["modularity_combined"]
                                           for _, d, _, _ in others),
           "losses_finite": all(np.isfinite(list(m.values())).all() for m in metrics),
           "cindex_lines": cindex, "result_cindex": result, "seconds": seconds,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    require(row["initial_prototypes_equal_npy"], f"PLIP prototypes did not reach UMEML_GAN: {row}")
    require(len(steps) > 0 and row["K4_K5_once_per_main_step"]
            and counts["modularity_deg"] == counts["modularity_combined"] == len(steps)
            and row["K4_K5_outside_main_steps"] == 0, f"K4/K5 on the PLIP run: {row}")
    require(row["losses_finite"] and row["gan_steps"] > 0 and result is not None
            and len(cindex) >= PLIP_EPOCHS + 1, row)
    return row, counts



# ---------------------------------------------------------------------------
# phases 21-25: the rest of the UMEML family (TRAINER.PREC bf16, USE_BSM,
# the head and twin variants, INIT_WEIGHTS, the plot variant)
# ---------------------------------------------------------------------------

FLASH_BF16_SHAPES = [
    # name, B, H, N, d, valid keys per slide (None = no mask; see key_valid)
    ("transmil_n10001_d64", 1, 8, 10001, 64, (7314,)),  # TransMIL's bag at amp
    ("cmta_n10001_d32", 1, 8, 10001, 32, (7314,)),  # CMTA's masked bag at fp16
    ("serve_b8_n7", 8, 8, 7, 32, None),  # UMEML_GAN's encoders/decoders at batch 8
    ("serve_b16_n14", 16, 8, 14, 32, None),  # its bottleneck encoders (2B rows)
]
BF16_MAIN_SHAPE = "transmil_n10001_d64"
#: the bf16 entries' launch counters and the trace symbols of their kernels
BF16_ENTRIES = {"flash_fwd": "flash_fwd_bf16", "flash_bwd_dq": "flash_bwd_dq_bf16",
                "flash_bwd_dkv": "flash_bwd_dkv_bf16"}
#: the CUDA kernels of K2's and K3's bf16 entries (their trace rows also
#: hold BWD_KERNEL_SYMBOL's names)
BF16_SYMBOL = {"flash_bwd_dq": "dq_kernel_bf16", "flash_bwd_dkv": "dkv_kernel_bf16"}
BF16_GATE = 2e-2  # a bf16 step through the kernels vs through the plain versions
BF16_MARGIN = 1e-4  # ... and its distance from the fp32 plain step: 2x the plain's + this


#: the protocol phase's runs: (task, TPU.ATTENTION, seeds)
PROTOCOL_RUNS = (("Survival", "auto", (1, 2)), ("Classification", "flash", (1,)))
PROTOCOL_EPOCHS = 2  # plain, then GAN + replacement, the CCA epoch between them
GDC_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "gdc")
GDC_TOP_K = 12  # the fixture's expected/ files are the JAX tool's output at this k
PRINTED_DIGITS = {"cindex": 2, "accuracy": 1}  # as the evaluators print the metric lines


def same_files(a: str, b: str, names=None) -> dict:
    """{"files": n, "differ": [names whose bytes differ or are missing]}."""
    import filecmp

    names = sorted(os.listdir(a)) if names is None else names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    return {"files": len(names), "differ": mismatch + errors}


def etl_without_pandas(tmp: str) -> dict:
    """``imp_torch.tools.transform_molecular`` on the GDC fixture in a child
    process where pandas, jax and imp_tpu cannot be imported; its files
    against the fixture's ``expected/`` (the JAX tool's bytes)."""
    out = os.path.join(tmp, "etl")
    fx = GDC_FIXTURE
    argv = ["--gdc-meta", os.path.join(fx, "metadata.cart.json"),
            "--gene-variance", os.path.join(fx, "gene_variance.csv"),
            "--origin-dir", os.path.join(fx, "origin"), "--feature-dir", os.path.join(fx, "features"),
            "--out-dir", out, "--top-k", str(GDC_TOP_K)]
    code = ("import sys\n"
            "for name in ('pandas', 'jax', 'imp_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from imp_torch.tools import transform_molecular\n"
            f"transform_molecular.main({argv!r})\n")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=here, env=env, capture_output=True,
                         text=True, timeout=120)
    row = {"rc": res.returncode, "stdout_last": res.stdout.strip().splitlines()[-1:]}
    if res.returncode == 0:
        row.update(same_files(os.path.join(fx, "expected"), out))
    else:
        row["stderr"] = res.stderr[-2000:]
    return row


def phase_protocol(card: str, root: str, out: str):
    """The paper's five-fold protocol through ``imp_torch.tools.run_method``
    (in process, on the seeded bags): UMEML_GAN.yaml at Survival, seeds 1
    and 2 at ``auto`` (K4/K5 once per main step), and Classification's
    UMEML_GAN.yaml, seed 1 under flash (K1 once per TransLayer call, K2/K3
    once per call with grad), 2 epochs each; the seeds' logs, checkpoints and
    the parser's summary against the values the runs returned; then the
    molecular ETL on the GDC fixture (no pandas) and the config generator
    into a tmp dir, both against the committed files."""
    import torch

    from imp_torch import kernels
    from imp_torch.engine.mbtrain import MBTRAIN
    from imp_torch.tools import gen_configs, parse_test_res, run_method

    t_phase = time.perf_counter()
    runs, total = [], {k: 0 for k in kernels.launches()}
    for task, attention, seeds in PROTOCOL_RUNS:
        argv = [task, "UMEML_GAN", "MBTRAIN", root, "--seeds", *map(str, seeds),
                "--device", DEVICE, "--output-root", out,
                "OPTIM.MAX_EPOCH", str(PROTOCOL_EPOCHS), "TRAIN.CURRICULUM.GAN_START_EPOCH", "1",
                "TRAIN.CURRICULUM.REPLACE_START_EPOCH", "1", "TPU.ATTENTION", attention,
                "VERBOSE", "False"]
        record = []
        console = io.StringIO()
        torch.cuda.synchronize()
        with seeded_bags(), audited(MBTRAIN, ("train_step", "run_epoch_cca", "test"), record), \
                contextlib.redirect_stdout(console):
            # ---- the main path: counts at 0 just before, read just after ------
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = run_method.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = kernels.launches()
        for k, v in counts.items():
            total[k] += v
        log_text = console.getvalue()
        method_dir = os.path.join(out, task, "UMEML_GAN")
        os.makedirs(LOG_DIR, exist_ok=True)
        with open(os.path.join(LOG_DIR, f"chip_smoke_protocol_{task}_log.txt"), "w") as f:
            f.write(log_text)

        keyword = res["keyword"]
        seed_rows = {}
        for seed in seeds:
            sdir = os.path.join(method_dir, f"seed{seed}")
            metric = parse_test_res.metric_regex(keyword or "cindex")
            found = parse_test_res.collect(metric, directory=method_dir, end_signal="Finish training")
            parsed = [o[metric["name"]] for o in found
                      if os.path.basename(os.path.dirname(o["file"])) == f"seed{seed}"]
            pointer = os.path.join(sdir, "model", "checkpoint")
            ckpt = open(pointer).read().strip() if os.path.isfile(pointer) else None
            seed_rows[seed] = {"returned": res["results"][seed], "parsed": parsed,
                               "checkpoint": ckpt,
                               "checkpoint_file": bool(ckpt) and os.path.isfile(
                                   os.path.join(sdir, "model", ckpt))}
        values = [res["results"][s] for s in seeds]
        digits = PRINTED_DIGITS.get(keyword, 2)
        printed = [round(v, digits) for v in values]
        mean, sd = res["summary"][keyword] if res["summary"] else (None, None)
        steps = [r for r in record if r[0] == "train_step"]
        others = [r for r in record if r[0] != "train_step"]
        flash = attention == "flash"
        per_step_ok = all(d["modularity_deg"] == 1 and d["modularity_combined"] == 1
                          and (d["flash_fwd"] > 0) == flash for _, d, _, _ in steps)
        # outside the main steps (CCA epochs, evaluations): no K4/K5; at auto
        # no launch at all, under flash K1-K3 as flash_launches_match_layers
        others_ok = all(d["modularity_deg"] == d["modularity_combined"] == 0
                        and (flash or not any(d.values())) for _, d, _, _ in others)
        row = {
            "task": task, "attention": attention, "seeds": list(seeds), "metric": keyword,
            "seed_runs": seed_rows, "summary": {"mean": mean, "sd": sd},
            "printed_values": printed, "launches": counts, "main_steps": len(steps),
            "gan_steps": sum("loss_gen" in (m or {}) for _, _, _, m in steps),
            "cca_epochs": sum(r[0] == "run_epoch_cca" for r in others),
            "evaluations": sum(r[0] == "test" for r in others),
            "translayer_calls_per_main_step": sorted({c["calls"] for _, _, c, _ in steps}),
            "K4_K5_once_per_main_step": per_step_ok, "nothing_else_outside_steps": others_ok,
            "flash_launches_match_translayer_calls": flash_launches_match_layers(record)
            if flash else None,
            "seconds": seconds,
        }
        runs.append(row)
        emit({"phase": "protocol_run", "card": card, **row})
        require(keyword == ("cindex" if task == "Survival" else "accuracy"), row)
        for seed, sr in seed_rows.items():
            require(sr["parsed"] == [round(sr["returned"], digits)] and sr["checkpoint"]
                    == f"model.ckpt-{PROTOCOL_EPOCHS}" and sr["checkpoint_file"],
                    f"seed {seed}: metric line or checkpoint missing: {row}")
        require(mean is not None and abs(mean - float(np.mean(printed))) < 1e-9
                and abs(sd - float(np.std(printed))) < 1e-9, f"parser summary: {row}")
        require(len(steps) > 0 and per_step_ok and others_ok, f"K4/K5 off the main steps: {row}")
        require(counts["modularity_deg"] == counts["modularity_combined"] == len(steps), row)
        require(not flash or (row["flash_launches_match_translayer_calls"]
                              and counts["flash_fwd"] > 0), f"K1-K3 vs TransLayer calls: {row}")
        require(row["gan_steps"] > 0 and row["cca_epochs"] == len(seeds) * (PROTOCOL_EPOCHS - 1),
                row)

    etl = etl_without_pandas(out)
    gen_dir = os.path.join(out, "configs")
    with contextlib.redirect_stdout(io.StringIO()):
        gen_configs.main(["--out-dir", gen_dir])
    names = sorted(os.path.join(t, f) for t in os.listdir(gen_dir)
                   for f in os.listdir(os.path.join(gen_dir, t)))
    configs = same_files(gen_dir, CONFIGS, names)
    row = {"phase": "protocol", "card": card, "entry": "python -m imp_torch.tools.run_method",
           "runs": [{k: r[k] for k in ("task", "attention", "seeds", "metric", "summary",
                                        "main_steps", "seconds")} for r in runs],
           "launches": total, "etl_without_pandas": etl, "gen_configs": configs,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    require(etl["rc"] == 0 and etl["files"] == 3 and not etl["differ"], f"ETL: {etl}")
    require(configs["files"] == 52 and not configs["differ"], f"gen_configs: {configs}")
    return row, total


def bf16_float64_gate(kernel, fp32_entry, exact, names) -> dict:
    """Gate (c) of K2/K3's bf16 entries: each gradient's max-abs distance
    from ``exact`` (a float64 replay of the plain version on the same bf16
    operands) at most twice that of the fp32 entries on ``.float()`` copies
    of those operands.  Per gradient both distances and their ratio, and
    whether all passed."""
    rows = {}
    for n, a, w, x in zip(names, kernel, fp32_entry, exact):
        got, ref = (a.double() - x).abs().max().item(), (w.double() - x).abs().max().item()
        rows[n] = {"kernel": got, "fp32_entry": ref, "ratio": got / max(ref, 1e-300)}
    return {"ok": all(r["kernel"] <= 2 * r["fp32_entry"] for r in rows.values()),
            "limit": "2x the fp32 entry", **rows}


def ptxas_of(report: dict, source: str, symbol: str) -> list:
    """The :func:`ptxas_lines` of the kernels of ``source`` whose mangled
    names hold ``symbol``."""
    out, mine = [], False
    for line in ptxas_lines(report, source):
        if "Compiling entry" in line:
            mine = symbol in line
        if mine:
            out.append(line)
    return out


def phase_flash_bf16(card: str, build_report: dict):
    """K1-K3's bf16 entries (``TRAINER.PREC`` bf16: q, k, v in bf16, the rest
    and the outputs fp32) at TransMIL's bag, CMTA's masked bag and
    UMEML_GAN's batch-8 sequences.  K1's widens q, k, v exactly as it stages
    them: O and lse are the fp32 entry's bits on ``.float()`` copies.  K2's
    and K3's keep them in bf16 (Q·Kᵀ in one bf16 pass, the products with one
    bf16 operand in two TF32 passes), so dq, dk and dv are held instead (a)
    within ``KERNEL_TOL`` of the plain versions, (b) to the same bits on a
    second launch, (c) no farther from a float64 replay than twice the fp32
    entries (:func:`bf16_float64_gate`).  Timed beside their bounds
    (:func:`flash_bound_ms`: each product at the rate its operands need, q,
    k, v at 2 bytes), the fp32 entries on the widened operands (K2, K3),
    the plain versions, SDPA on the widened operands (the same function)
    and SDPA in bf16 (not the same function: P·V in bf16)."""
    import torch
    import torch.nn.functional as F

    from imp_torch import kernels
    from imp_torch.ops.flash_attention import (
        NEG_INF, flash_attention_bwd, flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq_reference, flash_attention_bwd_reference, flash_attention_fwd,
        flash_attention_reference, flash_bwd_layout, flash_fwd_layout,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    plain = {"flash_bwd_dq": flash_attention_bwd_dq_reference,
             "flash_bwd_dkv": flash_attention_bwd_dkv_reference}
    rows = {}
    for name, b, h, n, d, specs in FLASH_BF16_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        q, k, v = (torch.randn(b, h, n, d, device=DEVICE, generator=g).bfloat16()
                   for _ in range(3))
        q = q * d**-0.5  # scaled in bf16, as flash_attention scales it
        do = torch.randn(b, h, n, d, device=DEVICE, generator=g)
        wide = tuple(t.float() for t in (q, k, v))  # the fp32 entries' operands
        tile = flash_fwd_layout(d)["tile"]
        if specs is None:
            bias, valid = torch.zeros(b, n, device=DEVICE), None
        else:
            keep = torch.stack([key_valid(n, spec, DEVICE, tile) for spec in specs])
            bias = torch.where(keep, 0.0, NEG_INF)
            valid = [int(c) for c in keep.sum(dim=1).tolist()]
        has_key = (bias == 0).any(dim=1)
        iters = 200 if n < 100 else 10
        with torch.no_grad():
            kernels.reset_launches()
            o, lse = flash_attention_fwd(q, k, v, bias)
            o_w, lse_w = flash_attention_fwd(*wide, bias)
            delta = (do * o_w).sum(-1)
            args = (q, k, v, bias, do, lse_w, delta)
            grads = flash_attention_bwd(*args)
            grads_w = flash_attention_bwd(*wide, bias, do, lse_w, delta)
            torch.cuda.synchronize()
            launched = only_launched(kernels.launches())
            again = flash_attention_bwd(*args)
            o_ref, lse_ref = flash_attention_reference(q, k, v, bias)
            ref = flash_attention_bwd_reference(*args)
            exact = flash_attention_bwd_reference(*(t.double() for t in args))
            same_bits = {"o": torch.equal(o, o_w), "lse": torch.equal(lse, lse_w)}
            twice = {gn: torch.equal(a, r) for gn, a, r in zip(("dq", "dk", "dv"), grads, again)}
            f64 = bf16_float64_gate(grads, grads_w, exact, ("dq", "dk", "dv"))
            errs = {"flash_fwd": max((o - o_ref).abs().max().item(),
                                     (lse[has_key] - lse_ref[has_key]).abs().max().item()),
                    "flash_bwd_dq": rel_err(grads[0], ref[0]),
                    "flash_bwd_dkv": max(rel_err(a, r) for a, r in zip(grads[1:], ref[1:]))}
            dtypes = [str(t.dtype) for t in (o, lse, *grads)]
            del grads, grads_w, again, ref, exact, o_ref
            torch.cuda.empty_cache()

            def fwd():
                return flash_attention_fwd(q, k, v, bias)

            def bwd():
                return flash_attention_bwd(*args)

            def bwd_wide():
                return flash_attention_bwd(*wide, bias, do, lse_w, delta)

            fwd_times = {"ms": cuda_ms(fwd, iters),
                         "kernel_device_ms": device_ms(fwd, "flash_fwd_kernel", min(iters, 20)),
                         "plain_ms": cuda_ms(lambda: flash_attention_reference(q, k, v, bias),
                                             min(iters, 10), warmup=1),
                         "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                             *wide, attn_mask=bias[:, None, None, :], scale=1.0), iters),
                         "library_bf16_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                             q, k, v, attn_mask=bias.bfloat16()[:, None, None, :], scale=1.0),
                             iters)}
            bwd_iters = 100 if n < 100 else 5
            pair = {"covers": "dq, dk and dv: K2 then K3 in one flash_attention_bwd call",
                    "ms": cuda_ms(bwd, bwd_iters),
                    "plain_ms": cuda_ms(lambda: flash_attention_bwd_reference(*args),
                                        min(bwd_iters, 3), warmup=1)}
            bwd_times = {kn: (device_ms(bwd, BF16_SYMBOL[kn], iters=min(bwd_iters, 20)),
                              device_ms(bwd_wide, sym, iters=min(bwd_iters, 20)),
                              cuda_ms(lambda: plain[kn](*args), min(bwd_iters, 3), warmup=1))
                         for kn, sym in BWD_KERNEL_SYMBOL.items()}
        pair["library_ms"], pair["library_kernel"] = sdpa_bwd_ms(*wide, bias, do,
                                                                 min(bwd_iters, 3))
        pair["library_bf16_ms"], _ = sdpa_bwd_ms(q, k, v, bias.bfloat16(), do.bfloat16(),
                                                 min(bwd_iters, 3))
        pair["library_bf16_note"] = "not the same function: P·V and the gradients in bf16"
        fb = flash_fwd_bounds(b, h, n, d, valid, "bf16")
        bb = flash_bwd_bounds(b, h, n, d, valid, "bf16")
        layout = flash_bwd_layout(d)["bf16"]
        common = {"phase": "kernel_flash_bf16", "shape": name, "card": card, "B": b, "H": h,
                  "N": n, "d": d, "valid": valid, "mask": specs, "launched": launched,
                  "out_dtypes": dtypes, "tol": KERNEL_TOL}
        row = {**common, "kernel": "flash_fwd", "entry": "imp_flash_fwd_bf16",
               "same_bits_as_f32_entry": same_bits,
               "max_abs_err": errs["flash_fwd"], **fwd_times, "bound_ms": fb["bound_ms"],
               "bound_by": fb["bound_by"],
               "library_bf16_note": "not the same function: P·V in bf16",
               "share_of_bound": fb["bound_ms"] / (fwd_times["kernel_device_ms"]
                                                   or fwd_times["ms"]),
               "ptxas": ptxas_lines(build_report, "flash_fwd.cu")}
        emit(row)
        rows[("flash_fwd", name)] = row
        for kname, (ms, fp32_ms, plain_ms) in bwd_times.items():
            require(ms is not None and fp32_ms is not None,
                    f"the trace holds no device time for {kname} at {name}")
            bound, bound_by = bb[kname]
            row = {**common, "kernel": kname, "entry": f"imp_{kname}_bf16",
                   "same_bits_twice": twice, "float64": f64,
                   "max_abs_err": errs[kname], "ms": ms, "fp32_entry_ms": fp32_ms,
                   "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
                   "bound_by": bound_by, "share_of_bound": bound / ms, "pair": pair,
                   "dynamic_smem_bytes": layout[kname],
                   "ptxas": ptxas_of(build_report, "flash_bwd.cu", BF16_SYMBOL[kname])}
            emit(row)
            rows[(kname, name)] = row
        require(all(same_bits.values()),
                f"K1's bf16 entry differs from its fp32 entry on widened operands at {name}: "
                f"{same_bits}")
        require(all(twice.values()), f"K2/K3's bf16 entries differ between launches at {name}: "
                f"{twice}")
        require(f64["ok"], f"K2/K3's bf16 entries are farther from float64 than twice the "
                f"fp32 entries at {name}: {f64}")
        require(max(errs.values()) <= KERNEL_TOL,
                f"bf16 entries disagree with the plain versions at {name}: {errs}")
        require(launched == {"flash_fwd": 1, "flash_fwd_bf16": 1, "flash_bwd_dq": 1,
                             "flash_bwd_dkv": 1, "flash_bwd_dq_bf16": 1,
                             "flash_bwd_dkv_bf16": 1}, launched)
        require(dtypes == ["torch.float32"] * 5, dtypes)
        require(all(r["share_of_bound"] <= 1.0 for (kn, s), r in rows.items() if s == name),
                f"a bf16 entry beats its bound at {name}: the bound is wrong")
        del q, k, v, do, wide, bias, args, o, lse, o_w, lse_w, delta
        torch.cuda.empty_cache()
    kernels.reset_launches()  # the comparison launches do not count
    return rows


def phase_trace_sessions(card: str):
    """What the traced windows of the run lost: per window the primer
    records missing from its trace, and the windows traced again because
    they lost records of a timed kernel past the primers
    (``imp_torch.utils.profiling.traced``)."""
    lost = [launched - seen for launched, seen in TRACE_SESSIONS]
    row = {"phase": "trace_sessions", "card": card, "sessions": len(lost),
           "primers": TRACE_PRIMERS, "retraced": sum(1 for _, seen in TRACE_SESSIONS if not seen),
           "retraced_for_lost_launches": len(TRACE_SHORT), "lost_launches": TRACE_SHORT[-5:],
           "lost_first": lost[:5], "lost_last": lost[-5:], "lost_max": max(lost, default=None),
           "sessions_with_loss": sum(1 for n in lost if n)}
    emit(row)
    return row


def bf16_gate(kernel, plain, fp32, names) -> dict:
    """A bf16 step through the kernels against the same bf16 step through the
    plain versions and against the fp32 plain step: each tensor (the loss,
    then every gradient) within ``BF16_GATE`` of its max-abs, and no farther
    from the fp32 step than twice the plain bf16 step (plus
    ``BF16_MARGIN``).  Returns the worst of each (for the second: the
    tensor with the largest share of its allowance, its distance from fp32
    and the plain bf16 step's) and whether all passed."""
    worst = {"kernel_vs_plain": (None, 0.0), "kernel_vs_fp32": (None, 0.0, 0.0)}
    share = -1.0
    ok = True
    for n, k, p, x in zip(names, kernel, plain, fp32):
        k_p, k_x, p_x = rel_err(k, p), rel_err(k, x), rel_err(p, x)
        ok &= k_p <= BF16_GATE and k_x <= 2 * p_x + BF16_MARGIN
        if k_p > worst["kernel_vs_plain"][1]:
            worst["kernel_vs_plain"] = (n, k_p)
        if k_x / (2 * p_x + BF16_MARGIN) > share:
            share, worst["kernel_vs_fp32"] = k_x / (2 * p_x + BF16_MARGIN), (n, k_x, p_x)
    return {"ok": ok, "worst": worst, "tensors": len(names), "gate": BF16_GATE,
            "margin": BF16_MARGIN}


def phase_train_step_bf16(card: str, root: str, out: str):
    """One step under ``TRAINER.PREC`` bf16 through the kernels (K1-K3's
    bf16 entries, K4/K5) against the same bf16 step through the plain
    versions and against the fp32 plain step (:func:`bf16_gate`): UMEML_GAN
    at batch 8 (UMEML_GAN_THROUGHPUT.yaml) under flash at ``bf16``, and
    TransMIL at a 10 000-patch slide under flash at ``amp``; then the step
    time, device busy time, idle share and peak memory of each, beside the
    same trainer's fp32 step.  Claims nothing."""
    import torch

    from imp_torch import kernels
    from imp_torch.engine import build_trainer
    from imp_torch.engine.precision import amp_call, bf16_matmul_scope

    rows = {}
    # ---- UMEML_GAN, batch 8, flash, bf16 --------------------------------------
    trainer, batch, db = mbtrain_for(root, out, "flash", **THROUGHPUT, **{"TRAINER.PREC": "bf16"})
    model, g = trainer.model, trainer.generator
    state = g.get_state()
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if not n.startswith("gan_discriminator")])

    def gan_loss_and_grads(dtype):
        g.set_state(state)
        with bf16_matmul_scope(dtype):
            enc = amp_call(model, "encode", dtype, db, train=True, generator=g)
            out_ = amp_call(model, "finish", dtype, enc, db, train=True, replace_ratio=0.0,
                            generator=g)
            loss = trainer.task_loss(out_["logits"], db) + out_["modular_loss"] + out_["loss_kd"]
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [loss.detach()] + [torch.zeros_like(p) if gr is None else gr
                                  for p, gr in zip(params, grads)]

    # JAX's dtype flow, kept: the zero-padded gene-group mask is an fp32
    # constant, so the omics encoders and decoder run fp32 (the fp32 entries)
    # and the path decoder and, in finish (its inputs cast to bf16), the
    # bottleneck's two TransLayers bf16 (the bf16 entries)
    rows["umeml_gan"] = bf16_step_row(trainer, batch, db, gan_loss_and_grads, names, {
        "flash_fwd_bf16": 3, "flash_bwd_dq_bf16": 3, "flash_bwd_dkv_bf16": 3,
        "flash_fwd": 3, "flash_bwd_dq": 3, "flash_bwd_dkv": 3,
        "modularity_deg": 1, "modularity_combined": 1},
        lambda: trainer.train_step(db, train_gan=True, replace_ratio=0.25),
        FLASH_KERNEL_NAMES + MOD_KERNEL_NAMES, prec="bf16")
    del trainer, model, db, params
    torch.cuda.empty_cache()

    # ---- TransMIL, the fullest slide, flash, amp ------------------------------
    cfg = transmil_cfg(**{"DATASET.ROOT": root, "OUTPUT_DIR": out, "VERBOSE": False, "SEED": 1,
                          "DATASET.FOLD": 1, "TRAINER.NAME": "TransMIL", "TRAINER.PREC": "amp"})
    with seeded_bags():
        trainer = build_trainer(cfg, device=DEVICE)
        batch = max((b for loader in (trainer.train_loader, trainer.test_loader) for b in loader),
                    key=lambda b: int(b["img_mask"].sum()))
    db = trainer._device_batch(batch)
    model, g = trainer.model, trainer.generator
    state = g.get_state()
    names, params = zip(*model.named_parameters())

    def mil_loss_and_grads(dtype):
        g.set_state(state)
        with bf16_matmul_scope(dtype):
            out_ = amp_call(model, "forward", dtype, db, train=True, generator=g)
            loss = trainer.task_loss(out_, db)
            grads = torch.autograd.grad(loss, params)
        return [loss.detach()] + list(grads)

    rows["transmil"] = bf16_step_row(trainer, batch, db, mil_loss_and_grads, names, {
        "flash_fwd_bf16": 2, "flash_bwd_dq_bf16": 2, "flash_bwd_dkv_bf16": 2},
        lambda: trainer.train_step(db), FLASH_KERNEL_NAMES, prec="amp")
    kernels.reset_launches()
    row = {"phase": "train_step_bf16", "card": card, **rows}
    emit(row)
    return row


def bf16_step_row(trainer, batch, db, loss_and_grads, names, launches, step, kernel_names,
                  prec: str) -> dict:
    """The gate of :func:`phase_train_step_bf16` for one trainer and the
    timing of its bf16 step beside its fp32 step (the same model, the
    trainer's compute dtype switched)."""
    import torch

    from imp_torch import kernels

    kernels.reset_launches()
    kernel = loss_and_grads(torch.bfloat16)
    torch.cuda.synchronize()
    counted = only_launched(kernels.launches())
    with plain_attention(), plain_modularity():
        plain = loss_and_grads(torch.bfloat16)
        fp32 = loss_and_grads(None)
    gate = bf16_gate(kernel, plain, fp32, ("loss",) + tuple(names))
    gate["loss"] = {"kernel": kernel[0].item(), "plain": plain[0].item(), "fp32": fp32[0].item()}
    del kernel, plain, fp32
    torch.cuda.empty_cache()
    require(counted == launches, f"kernels of one {prec} step: {counted}, want {launches}")
    require(gate["ok"], f"{prec} step through the kernels vs the plain versions: {gate}")
    timing = time_step(step, kernel_names, timed=6)
    dtype = trainer.cdtype
    trainer.cdtype = None  # the same trainer's fp32 step
    try:
        timing_fp32 = time_step(step, kernel_names, timed=6)
    finally:
        trainer.cdtype = dtype
    b = len(batch["patient_id"])
    require(timing["loss_finite"] and timing_fp32["loss_finite"], "a step's loss is not finite")
    return {"prec": prec, "attention": trainer.cfg.TPU.ATTENTION, "batch": b,
            "bag_valid": [int(x) for x in batch["img_mask"].sum(axis=1)],
            "launches_per_step": counted, "gate": gate,
            "bf16": {**timing, "slides_per_s": b / (timing["step_ms_median"] / 1e3)},
            "fp32": {**timing_fp32, "slides_per_s": b / (timing_fp32["step_ms_median"] / 1e3)}}


def phase_train_bf16(card: str, root: str, out: str):
    """``python -m imp_torch.tools.train`` under ``TRAINER.PREC`` bf16:
    UMEML_GAN (MBTRAIN, UMEML_GAN.yaml, flash) for 2 epochs, the GAN on and
    the CCA epoch between, and CMTA (flash) for one epoch at ``fp16``.  Per
    main step three TransLayers run the bf16 entries and three the fp32
    ones, as JAX's dtype flow has it (K1 per call, K2/K3 per call with
    grad), and K4/K5 once; the CCA epoch and the GAN losses run in fp32 as
    JAX runs them; evaluation runs K1 alone, its bf16 entry included; the
    metric lines; every checkpoint tensor fp32."""
    import torch

    from imp_torch.engine.fusion_trainers import CMTA
    from imp_torch.engine.mbtrain import MBTRAIN

    epochs = TRAIN_EPOCHS_FLASH
    argv = ["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--output-dir",
            os.path.join(out, "umeml_gan"), "--device", DEVICE] + flagship_opts(**{
                "OPTIM.MAX_EPOCH": epochs, "TRAIN.CURRICULUM.GAN_START_EPOCH": 0,
                "TRAIN.CURRICULUM.REPLACE_START_EPOCH": 1, "TPU.ATTENTION": "flash",
                "TRAINER.PREC": "bf16"})
    result, counts, record, seconds, log = run_trainer(
        argv, MBTRAIN, ("train_step", "run_epoch_cca", "test"), "chip_smoke_train_bf16_log.txt")
    steps = [r for r in record if r[0] == "train_step"]
    cca = [r for r in record if r[0] == "run_epoch_cca"]
    tests = [r for r in record if r[0] == "test"]
    # per main step the path decoder and the bottleneck run bf16, the omics
    # encoders and decoder fp32 (JAX's dtype flow: see phase_train_step_bf16)
    step_ok = all(d["flash_fwd_bf16"] == d["flash_fwd"] == 3 and c["calls"] == c["grad"] == 6
                  and d["flash_bwd_dq_bf16"] == d["flash_bwd_dkv_bf16"] == 3
                  and d["flash_bwd_dq"] == d["flash_bwd_dkv"] == 3
                  and d["modularity_deg"] == d["modularity_combined"] == 1
                  for _, d, c, _ in steps)
    cca_ok = all(d["flash_fwd"] == c["calls"] > 0 and d["flash_fwd_bf16"] == 0
                 and d["modularity_deg"] == 0 for _, d, c, _ in cca)
    # evaluation: K1 alone; the whole forward under the policy leaves only
    # the path decoder bf16 (the bottleneck meets the fp32 omics there)
    eval_ok = all(d["flash_fwd_bf16"] > 0 and c["grad"] == 0
                  and d["flash_fwd_bf16"] + d["flash_fwd"] == c["calls"]
                  and set(only_launched(d)) <= {"flash_fwd_bf16", "flash_fwd"}
                  for _, d, c, _ in tests)
    metrics = [{k: float(v) for k, v in m.items()} for _, _, _, m in steps]
    cindex = [line for line in log.splitlines() if line.startswith("* cindex:")]
    ckpt = checkpoint_dtypes(os.path.join(out, "umeml_gan"))
    umeml_gan = {
        "argv_prec": "bf16", "epochs": epochs, "main_steps": len(steps),
        "gan_steps": sum("loss_gen" in m for m in metrics), "cca_epochs": len(cca),
        "evaluations": len(tests), "launches": counts, "per_step_ok": step_ok,
        "cca_fp32_entries_ok": cca_ok, "eval_K1_bf16_only": eval_ok,
        "translayer_calls_per_step": sorted({c["calls"] for _, _, c, _ in steps}),
        "losses_finite": all(np.isfinite(list(m.values())).all() for m in metrics),
        "cindex_lines": cindex, "result_cindex": result, "checkpoint": ckpt, "seconds": seconds,
    }
    # ---- CMTA at fp16 (bf16) --------------------------------------------------
    cmta_out = os.path.join(out, "cmta")
    result_c, counts_c, record_c, seconds_c, log_c = run_trainer(
        zoo_argv(root, cmta_out, "CMTA", "Survival", "TPU.ATTENTION", "flash", "TRAINER.PREC",
                 "fp16"), CMTA, ("train_step", "test", "_eval_batch"),
        "chip_smoke_train_cmta_fp16_log.txt")
    c_steps = [r for r in record_c if r[0] == "train_step"]
    c_tests = [r for r in record_c if r[0] == "test"]
    c_batches = sum(r[0] == "_eval_batch" for r in record_c)
    c_step_ok = all(only_launched(d) == {"flash_fwd_bf16": 8, "flash_bwd_dq_bf16": 8,
                                         "flash_bwd_dkv_bf16": 8} for _, d, _, _ in c_steps)
    c_eval = only_launched({k: sum(d[k] for _, d, _, _ in c_tests) for k in counts_c})
    c_losses = [float(m["loss"]) for _, _, _, m in c_steps]
    cmta = {
        "argv_prec": "fp16", "train_steps": len(c_steps), "eval_batches": c_batches,
        "launches": counts_c, "per_step_ok": c_step_ok, "eval_launches": c_eval,
        "losses_finite": bool(np.isfinite(c_losses).all()),
        "cindex_lines": [line for line in log_c.splitlines() if line.startswith("* C-Index:")],
        "result_cindex": result_c, "checkpoint": checkpoint_dtypes(cmta_out),
        "seconds": seconds_c,
    }
    row = {"phase": "train_bf16", "card": card, "entry": "python -m imp_torch.tools.train",
           "umeml_gan": umeml_gan, "cmta": cmta,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    require(len(steps) > 0 and step_ok, f"bf16 entries per UMEML_GAN main step: {umeml_gan}")
    require(len(cca) == epochs - 1 and cca_ok, f"the CCA epoch at fp32: {umeml_gan}")
    require(len(tests) > 0 and eval_ok, f"K1's bf16 entry per evaluation: {umeml_gan}")
    require(umeml_gan["losses_finite"] and umeml_gan["gan_steps"] > 0
            and len(cindex) >= epochs + 1 and result is not None, umeml_gan)
    require(ckpt["all_fp32"] and ckpt["epoch"] == epochs, ckpt)
    require(len(c_steps) > 0 and c_step_ok and c_batches > 0
            and c_eval == {"flash_fwd_bf16": 8 * c_batches}, f"CMTA at fp16: {cmta}")
    require(cmta["losses_finite"] and result_c is not None and len(cmta["cindex_lines"]) >= 2
            and cmta["checkpoint"]["all_fp32"], cmta)
    return row, {k: counts[k] + counts_c[k] for k in counts}


def checkpoint_dtypes(out: str) -> dict:
    """The last checkpoint's epoch and whether every floating tensor of its
    model state is fp32 (the parameters stay fp32 under bf16)."""
    import torch

    mdir = os.path.join(out, "model")
    with open(os.path.join(mdir, "checkpoint")) as f:
        name = f.read().strip()
    state = torch.load(os.path.join(mdir, name), map_location="cpu", weights_only=True)
    dtypes = sorted({str(t.dtype) for t in state["model"].values() if t.is_floating_point()})
    return {"name": name, "epoch": int(state["epoch"]), "dtypes": dtypes,
            "all_fp32": dtypes == ["torch.float32"]}


BSM = {"DATASET.USE_BSM": True, "DATASET.BS_MICRO": 512}


@contextlib.contextmanager
def plain_everything():
    """Every kernel wrapper routed to its plain version (flash, modularity,
    the pseudo-inverse)."""
    with plain_attention(), plain_modularity(), chain_pinv():
        yield


def phase_umeml_bsm(card: str, root: str, out: str):
    """UMEML (UMEML.yaml, batch 2, bags padded to 10 000) with ``USE_BSM`` at
    ``BS_MICRO`` 512 (20 chunks of 512 tokens), every pseudo-inverse fused:
    one step at a fixed permutation through the kernels against the plain
    versions (loss and every gradient within STEP_TOL, or
    :func:`float64_check`), its launches per step (K4 and K5 once per chunk,
    K6 and K7 once per TransLayer call per chunk), and its step time."""
    import torch

    from imp_torch import kernels

    clock = [time.perf_counter()]
    with pinv_mode("fused"):
        trainer, batch, db = mbtrain_for(root, out, **UMEML, **BSM)
    model, g = trainer.model, trainer.generator
    require(fused_pinvs(model) == 6, "UMEML has six Nyström TransLayers, all fused")
    n = db["img"].shape[1]
    chunks = -(-n // BSM["DATASET.BS_MICRO"])
    perm = torch.randperm(chunks * BSM["DATASET.BS_MICRO"],
                          generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    state = g.get_state()
    names = [nm for nm, _ in model.named_parameters()]

    def loss_and_grads(model=model, db=db):
        g.set_state(state)
        params = [dict(model.named_parameters())[nm] for nm in names]
        saved, trainer.model = trainer.model, model
        try:
            loss = trainer.bsm_loss(db, perm)
        finally:
            trainer.model = saved
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]
        return loss.detach(), {}, grads

    clock.append(time.perf_counter())
    check, counted = grads_check(loss_and_grads, plain_everything, names)
    clock.append(time.perf_counter())
    want = {"modularity_deg": chunks, "modularity_combined": chunks,
            "pinv_fwd": 6 * chunks, "pinv_bwd": 6 * chunks}
    require(only_launched(counted) == want, f"kernels of one BSM step: {counted}, want {want}")
    if check["grad_rel"] > STEP_TOL:
        check["float64"] = float64_check(loss_and_grads, model, db, plain_everything, names)
    require(check["loss_rel"] <= STEP_TOL
            and (check["grad_rel"] <= STEP_TOL or check["float64"]["ok"]),
            f"BSM step through the kernels vs the plain versions: {check}")
    kernels.reset_launches()
    clock.append(time.perf_counter())
    # one traced step: a BSM step is 20 chunks' worth of kernels
    timing = time_step(lambda: trainer.train_step(db), MOD_KERNEL_NAMES + PINV_KERNEL_NAMES,
                       timed=4, traced=1)
    clock.append(time.perf_counter())
    b = len(batch["patient_id"])
    row = {"phase": "umeml_bsm", "card": card, "config": "configs/Survival/UMEML.yaml",
           "use_bsm": True, "bs_micro": BSM["DATASET.BS_MICRO"], "chunks": chunks,
           "alpha": float(trainer.cfg.MODEL.UMEML.ALPHA), "batch": b, "bag_pad": n,
           "bag_valid": [int(x) for x in batch["img_mask"].sum(axis=1)],
           "launches_per_step": counted, "check": check, **timing,
           "slides_per_s": b / (timing["step_ms_median"] / 1e3),
           "seconds": dict(zip(("build", "check", "float64", "timing"),
                               np.diff(clock).tolist()))}
    emit(row)
    require(timing["loss_finite"], row)
    return row


def variant_grads(model, db, g, state, task_loss):
    """Loss and the gradient of every parameter (by name) of one main-loss
    forward at replace ratio 0 with the generator at ``state``."""
    import torch

    g.set_state(state)
    enc = model.encode(db, train=True, generator=g)
    out_ = model.finish(enc, db, train=True, replace_ratio=0.0, generator=g)
    loss = task_loss(out_["logits"], db) + out_["modular_loss"] + out_["loss_kd"]
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if gr is None else gr
                           for n, p, gr in zip(names, params, grads)}


def twin_name(name: str):
    """(stacked name, twin index) of a twin-layout parameter, else (name, None)."""
    from imp_torch.convert import STACKED_TWINS

    top, _, rest = name.partition(".")
    for pair, twins in STACKED_TWINS.items():
        if top in twins:
            return f"{pair}.layer.{rest}", twins.index(top)
    return name, None


def phase_umeml_gan_variants(card: str, root: str, out: str):
    """UMEML_GAN at batch 8 (UMEML_GAN_THROUGHPUT.yaml), under ``auto`` and
    flash, its variants at the default model's weights, dropout off (the
    variants draw their masks in other shapes): ``head_fused=False`` and
    ``stacked_pairs=True`` (twin weights stacked) within STEP_TOL of the
    default model in loss and every gradient; ``bag_dtype=bfloat16`` at the
    bf16 gate (:func:`bf16_gate`: through the kernels against the plain
    versions, and against the fp32 default model through them); a trainer built with ``MODEL.INIT_WEIGHTS`` from the
    first's checkpoint gives its eval logits bit for bit; ``umeml_gan_plot``'s
    similarity grids are [B, 7, 7] and finite, and whether its PNGs were
    written (none without matplotlib)."""
    import torch

    from imp_torch.convert import stack_twins
    from imp_torch.models import build_model, survival_num_classes
    from imp_torch.ops.attention import ExactSelfAttention, NystromAttention
    from imp_torch.utils.checkpoint import save_checkpoint

    def no_dropout(model):
        model.dropout_rate = 0.0
        for m in model.modules():
            if isinstance(m, (NystromAttention, ExactSelfAttention)):
                m.dropout = 0.0
        return model

    rows = {}
    for attention in ("auto", "flash"):
        trainer, batch, db = mbtrain_for(root, out, attention, **THROUGHPUT)
        base, g, cfg = no_dropout(trainer.model), trainer.generator, trainer.cfg
        state = g.get_state()
        weights = {k: v.clone() for k, v in base.state_dict().items()}
        loss0, grads0 = variant_grads(base, db, g, state, trainer.task_loss)
        checks = {}
        for label, variant in (("head_fused_false", {"head_fused": False}),
                               ("stacked_pairs", {"stacked_pairs": True}),
                               ("bag_bf16", {"bag_dtype": torch.bfloat16})):
            model = no_dropout(build_model(
                "umeml_gan", cfg=cfg, num_classes=survival_num_classes(cfg.TASK.NAME, 0),
                gene_group_indexes=trainer.dm.gene_group_indexes, device=DEVICE, **variant))
            model.load_state_dict(stack_twins(weights) if "stacked_pairs" in variant else weights,
                                  strict=True)
            loss, grads = variant_grads(model, db, g, state, trainer.task_loss)
            if "bag_dtype" in variant:  # the bf16 gate: kernels vs plain, and vs fp32
                with plain_everything():
                    loss_p, grads_p = variant_grads(model, db, g, state, trainer.task_loss)
                    loss_x, grads_x = variant_grads(base, db, g, state, trainer.task_loss)
                names = list(grads)
                checks[label] = bf16_gate([loss] + [grads[n] for n in names],
                                          [loss_p] + [grads_p[n] for n in names],
                                          [loss_x] + [grads_x[n] for n in names],
                                          ["loss"] + names)
                require(checks[label]["ok"], f"{label} ({attention}): {checks[label]}")
                del model, grads, grads_p, grads_x
                torch.cuda.empty_cache()
                continue
            errs = {}
            for n, want in grads0.items():
                key, i = twin_name(n) if "stacked_pairs" in variant else (n, None)
                errs[n] = rel_err(grads[key] if i is None else grads[key][i], want)
            worst = max(errs, key=errs.get)
            checks[label] = {"loss_rel": rel_err(loss, loss0), "grad_rel": errs[worst],
                             "worst_param": worst, "params": len(errs), "tol_rel": STEP_TOL}
            require(checks[label]["loss_rel"] <= STEP_TOL and errs[worst] <= STEP_TOL,
                    f"{label} vs the default model ({attention}): {checks[label]}")
            del model, grads
            torch.cuda.empty_cache()
        # ---- MODEL.INIT_WEIGHTS from the first trainer's checkpoint -------------
        mdir = os.path.join(out, f"init_weights_{attention}", "model")
        save_checkpoint(trainer.state_dict(), mdir, 1)
        second, _, _ = mbtrain_for(root, os.path.join(out, f"second_{attention}"), attention,
                                   **THROUGHPUT, **{"MODEL.INIT_WEIGHTS": mdir, "SEED": 7})
        trainer.model.load_state_dict(weights)
        with torch.no_grad():
            first_logits = trainer.model(db)["logits"]
            second_logits = second.model(db)["logits"]
        init_same = bool(torch.equal(first_logits, second_logits))
        del second
        # ---- umeml_gan_plot ----------------------------------------------------
        plot, pbatch, _ = mbtrain_for(root, os.path.join(out, f"plot_{attention}"), attention,
                                      **THROUGHPUT, **{"MODEL.NAME": "umeml_gan_plot"})
        grids = plot.similarity_grids(pbatch)
        with seeded_bags():
            plot._plot_similarity(plot.test_loader)
        plot_dir = os.path.join(plot.output_dir, "plots")
        pngs = len(os.listdir(plot_dir)) if os.path.isdir(plot_dir) else 0
        try:
            import matplotlib  # noqa: F401
            have_matplotlib = True
        except ImportError:
            have_matplotlib = False
        rows[attention] = {
            "batch": len(batch["patient_id"]), "variants": checks,
            "init_weights_same_eval_logits": init_same,
            "plot": {"grid_shape": list(grids.shape), "finite": bool(torch.isfinite(grids).all()),
                     "matplotlib": have_matplotlib, "pngs_written": pngs},
        }
        require(init_same, f"MODEL.INIT_WEIGHTS: other eval logits ({attention})")
        require(list(grids.shape) == [len(pbatch["patient_id"]), 7, 7]
                and rows[attention]["plot"]["finite"], rows[attention]["plot"])
        require(have_matplotlib or pngs == 0, rows[attention]["plot"])
        del trainer, plot, base, db
        torch.cuda.empty_cache()
    row = {"phase": "umeml_gan_variants", "card": card, **rows}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phases 27-28: sequence and data parallelism
# ---------------------------------------------------------------------------

#: TransMIL's bag, its keys cut into the chunks of a 4-rank ring; the last
#: chunk (keys 7 501-10 000) holds no valid key under the 7 314-key mask
PARTIAL_SHAPE = ("transmil_n10001_d64", 1, 8, 10001, 64, 7314)
PARTIAL_CHUNKS = 4


def phase_flash_partial(card: str, prec: str = "fp32"):
    """K1-K3 under the ring's per-chunk contract
    (``flash_attention_partial``/``_bwd``, one launch each per hop): K1
    over each of 4 key chunks merged by logsumexp (``ring_hop_forward``)
    against one K1 call and the plain version; K2/K3 per chunk with the
    global lse and delta (``ring_hop_backward``: dq summed, dk and dv
    concatenated) against one K2/K3 call and the plain backward; dk = dv =
    0 exactly on the chunk without a valid key; 4 launches of each; the
    per-hop time beside the single call's.  ``prec="bf16"``: q, k and v in
    bf16 (``TRAINER.PREC bf16`` under sequence parallelism), through the
    bf16 entries, against one bf16 call and the plain version on the same
    bf16 operands (which widens them); dO, lse, delta and the merge fp32."""
    import torch

    from imp_torch import kernels
    from imp_torch.ops.flash_attention import (
        NEG_INF, flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
        flash_attention_reference,
    )
    from imp_torch.parallel.sequence import ring_hop_backward, ring_hop_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    name, b, h, n, d, n_valid = PARTIAL_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    q, k, v, do = (torch.randn(b, h, n, d, device=DEVICE, generator=g) for _ in range(4))
    q = q * d**-0.5
    if prec == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    entries = {kn: BF16_ENTRIES[kn] if prec == "bf16" else kn for kn in FLASH_PRODUCTS}
    valid = key_valid(n, n_valid, DEVICE)[None].expand(b, n)
    bias = torch.where(valid, 0.0, NEG_INF).contiguous()
    cuts = torch.tensor_split(torch.arange(n), PARTIAL_CHUNKS)
    spans = [(int(c[0]), int(c[-1]) + 1) for c in cuts]
    chunks = [(k[:, :, a:z].contiguous(), v[:, :, a:z].contiguous(), valid[:, a:z].contiguous())
              for a, z in spans]
    require(not chunks[-1][2].any() and all(c[2].any() for c in chunks[:-1]),
            "the last chunk must hold no valid key, the others some")

    def ring_forward():
        o = torch.zeros(q.shape, device=DEVICE)
        lse = torch.full(q.shape[:3], float("-inf"), device=DEVICE)
        for kc, vc, mc in chunks:
            o, lse = ring_hop_forward(q, kc, vc, mc, o, lse)
        return o, lse

    def ring_backward(lse, delta):
        dq, dks, dvs = torch.zeros(q.shape, device=DEVICE), [], []
        for kc, vc, mc in chunks:
            dq_t, dk, dv = ring_hop_backward(q, kc, vc, mc, do, lse, delta)
            dq, dks, dvs = dq + dq_t, dks + [dk], dvs + [dv]
        return dq, dks, dvs

    with torch.no_grad():
        kernels.reset_launches()
        o, lse = ring_forward()
        delta = (do * o).sum(-1)
        dq, dks, dvs = ring_backward(lse, delta)
        torch.cuda.synchronize()
        launches = {kn: kernels.launches().get(entries[kn], 0) for kn in FLASH_PRODUCTS}
        o1, lse1 = flash_attention_fwd(q, k, v, bias)
        o_ref, lse_ref = flash_attention_reference(q, k, v, bias)
        one = flash_attention_bwd(q, k, v, bias, do, lse1, (do * o1).sum(-1))
        ref = flash_attention_bwd_reference(q, k, v, bias, do, lse_ref, (do * o_ref).sum(-1))
        got = (dq, torch.cat(dks, 2), torch.cat(dvs, 2))
        torch.cuda.synchronize()
        errs = {
            "o_vs_one_call_rel": rel_err(o, o1), "o_vs_plain_rel": rel_err(o, o_ref),
            "lse_vs_one_call_rel": rel_err(lse, lse1), "lse_vs_plain_rel": rel_err(lse, lse_ref),
            **{f"{gn}_vs_one_call_rel": rel_err(a, c)
               for gn, a, c in zip(("dq", "dk", "dv"), got, one)},
            **{f"{gn}_vs_plain_rel": rel_err(a, c)
               for gn, a, c in zip(("dq", "dk", "dv"), got, ref)},
        }
        abs_err = {"flash_fwd": max((o - o_ref).abs().max().item(),
                                    (lse - lse_ref).abs().max().item()),
                   "flash_bwd_dq": (got[0] - ref[0]).abs().max().item(),
                   "flash_bwd_dkv": max((a - c).abs().max().item()
                                        for a, c in zip(got[1:], ref[1:]))}
        empty_chunk_zero = (int(torch.count_nonzero(dks[-1])) == 0
                            and int(torch.count_nonzero(dvs[-1])) == 0)
        finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, *got))
        del o1, lse1, one, ref, o_ref, lse_ref
        iters = 5
        times = {
            "fwd_ring_ms": cuda_ms(ring_forward, iters),
            "fwd_one_call_ms": cuda_ms(lambda: flash_attention_fwd(q, k, v, bias), iters),
            "bwd_ring_ms": cuda_ms(lambda: ring_backward(lse, delta), iters),
            "bwd_one_call_ms": cuda_ms(
                lambda: flash_attention_bwd(q, k, v, bias, do, lse, delta), iters),
            "fwd_hop_ms": [cuda_ms(lambda c=c: ring_hop_forward(q, *c, o, lse), iters)
                           for c in chunks],
            "bwd_hop_ms": [cuda_ms(lambda c=c: ring_hop_backward(q, *c, do, lse, delta), iters)
                           for c in chunks],
        }
    kernels.reset_launches()  # the comparison and timing launches do not count
    row = {
        "phase": "kernel_flash_partial" + ("_bf16" if prec == "bf16" else ""), "card": card,
        "prec": prec, "entries": entries, "shape": name, "B": b, "H": h, "N": n,
        "d": d, "valid": n_valid, "chunks": [z - a for a, z in spans],
        "chunk_valid_keys": [int(c[2].sum()) for c in chunks], **errs, "max_abs_err": abs_err,
        "tol_rel": KERNEL_TOL, "finite": finite, "empty_chunk_dk_dv_zero": empty_chunk_zero,
        "launches": launches, "launches_per_hop": {kn: 1 for kn in FLASH_PRODUCTS}, **times,
        "bound": partial_bounds(b, h, n, d, [z - a for a, z in spans],
                                [int(c[2][0].sum()) for c in chunks], prec),
    }
    emit(row)
    require(finite and empty_chunk_zero and max(errs.values()) <= KERNEL_TOL,
            f"the ring's chunk forms disagree: {row}")
    require(all(launches[kn] == PARTIAL_CHUNKS for kn in FLASH_PRODUCTS),
            f"K1-K3 ({prec} entries) must launch once per hop: {launches}")
    return row


SP_BACKEND_NOTE = {"nccl": "NCCL, one card per rank",
                   "gloo": "gloo on one shared card, every collective staged through host memory"}
SP_STEP_TIMED = 5
#: the runs of train_sp: (name, trainer, mesh shape (data, seq),
#: TPU.SP_ATTENTION, TRAINER.PREC)
SP_RUNS = (
    ("transmil_gather", "TransMIL", (1, 2), "gather", "fp32"),
    ("transmil_ring", "TransMIL", (1, 2), "ring", "fp32"),
    ("umeml_gan_gather", "MBTRAIN", (1, 2), "gather", "fp32"),
    ("umeml_gan_ring", "MBTRAIN", (1, 2), "ring", "fp32"),
    ("umeml_gan_data", "MBTRAIN", (2, 1), "gather", "fp32"),
    ("umeml_gan_bf16_gather", "MBTRAIN", (1, 2), "gather", "bf16"),
    ("umeml_gan_bf16_ring", "MBTRAIN", (1, 2), "ring", "bf16"),
    ("transmil_amp_ring", "TransMIL", (1, 2), "ring", "amp"),
    ("hfb_data", "HFB", (2, 1), "gather", "fp32"),
)
HFB_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "Survival",
                        "HFB.yaml")
HFB_BATCH = 8  # the global batch of train_sp's HFB step: 4 slides a rank at (2, 1)


def sp_attention(trainer: str, prec: str) -> str:
    """TPU.ATTENTION of a train_sp run: flash for TransMIL and for
    UMEML_GAN under bf16 (K1-K3's bf16 entries), else the default."""
    return "flash" if trainer == "TransMIL" or prec != "fp32" else "auto"


def zero_dropout(model) -> None:
    """Every dropout rate of ``model`` that MODEL.DROPOUT does not set (the
    attention's, HFB's gated pools and factorised pooling) to 0."""
    from imp_torch.ops.attention import ExactSelfAttention, NystromAttention

    for m in model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
        for rate in ("rate", "fac_drop"):
            if isinstance(getattr(m, rate, None), float):
                setattr(m, rate, 0.0)


def sp_trainer(root: str, out: str, trainer: str, mesh_shape, mode: str, prec: str = "fp32"):
    """A trainer of train_sp on this process's mesh, at dropout 0 (the mesh
    step and the one-rank step must draw alike): TransMIL under flash at
    TransMIL.yaml's 10 000-patch bag, MBTRAIN on UMEML_GAN.yaml's values
    at batch 8 (``UMEML_GAN_THROUGHPUT.yaml``), or HFB (HFB.yaml) at a
    global batch of HFB_BATCH; with its first train batch on the card."""
    from imp_torch.engine import build_trainer

    mesh = {"TPU.MESH_AXES": ("data", "seq"), "TPU.MESH_SHAPE": tuple(mesh_shape),
            "TPU.SP_ATTENTION": mode, "DATASET.ROOT": root, "OUTPUT_DIR": out,
            "VERBOSE": False, "SEED": 1, "DATASET.FOLD": 1, "MODEL.DROPOUT": 0.0,
            "TRAINER.PREC": prec, "TPU.ATTENTION": sp_attention(trainer, prec)}
    if trainer == "TransMIL":
        cfg = transmil_cfg(**{"TRAINER.NAME": "TransMIL", **mesh})
    elif trainer == "HFB":
        cfg = yaml_cfg(HFB_YAML, **{"TRAINER.NAME": "HFB", **mesh,
                                    "DATALOADER.TRAIN.BATCH_SIZE": HFB_BATCH,
                                    "DATALOADER.TEST.BATCH_SIZE": HFB_BATCH})
    else:
        cfg = flagship_cfg(**{"TRAINER.NAME": "MBTRAIN", **THROUGHPUT, **mesh})
    with seeded_bags():
        tr = build_trainer(cfg, device=DEVICE)
        batch = next(iter(tr.train_loader))
        test_batch = next(iter(tr.test_loader))
    zero_dropout(tr.model)
    # HFB's eval logits after its step: this rank's part of a test batch
    tr.test_db, tr.test_rows = tr._device_batch(test_batch), len(test_batch["patient_id"])
    return tr, tr._device_batch(batch)


def sp_loss(tr, model, db):
    """One train forward's loss under the trainer's precision policy (task
    + modularity + distillation for UMEML_GAN; task and extra loss for the
    others)."""
    import torch

    from imp_torch.engine.precision import amp_call

    out = amp_call(model, "forward", tr.cdtype, db, train=True,
                   generator=torch.Generator(device=db["img"].device).manual_seed(0))
    if isinstance(out, dict) and "modular_loss" in out:
        return tr.task_loss(out["logits"], db) + out["modular_loss"] + out["loss_kd"]
    logits = out["logits"] if isinstance(out, dict) else out
    return tr.task_loss(logits, db) + tr.extra_loss(out, db)


def sp_loss_and_grads(tr, db):
    """The loss and parameter gradients of one step under the trainer's mesh
    rule (1/world seeded, summed over the world): the one-rank values on
    every rank (zeros for the parameters the loss does not reach: the GAN
    discriminators)."""
    import torch

    names, params = zip(*tr.model.named_parameters())
    with tr._scope():
        loss = sp_loss(tr, tr.model, db)
        grads = tr._grads(loss, params)
    return tr._global_mean(loss), names, [torch.zeros_like(p) if gr is None else gr
                                           for gr, p in zip(grads, params)]


def eval_logits(tr, db):
    """The eval logits of the test batch ``db`` (every data rank's rows,
    without the pad rows)."""
    import torch

    with torch.no_grad():
        out = tr.model(db)
    out = out["logits"] if isinstance(out, dict) else out
    return tr._gather_rows(out, tr.test_rows)


def sp_rank(rank: int, root: str, out: str):
    """One rank of train_sp: for each run of ``SP_RUNS``, one step's loss
    and gradients (rank 0 returns them), then the launches of one train
    step, its time and this rank's peak memory; for UMEML_GAN under sp the
    time of the plain sequence-parallel modularity passes."""
    import torch

    from imp_torch import kernels
    from imp_torch.ops.modularity import _prepare
    from imp_torch.parallel import sequence as S

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for run, trainer, shape, mode, prec in SP_RUNS:
        tr, db = sp_trainer(root, os.path.join(out, f"{run}_{rank}"), trainer, shape, mode, prec)
        loss, names, grads = sp_loss_and_grads(tr, db)
        kw = {"train_gan": True} if trainer == "MBTRAIN" else {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        tr.train_step(db, **kw)
        torch.cuda.synchronize()
        row = {"launches": only_launched(kernels.launches()),
               "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
               "batch_rows": int(db["img"].shape[0]), "bag_tokens": int(db["img"].shape[1]),
               "backend": tr.mesh.world.backend}
        if trainer == "HFB":  # the state after one step, and its eval logits (every rank gathers)
            logits = eval_logits(tr, tr.test_db).cpu()
            if rank == 0:
                row.update(state={k: v.detach().to("cpu", copy=True)
                                  for k, v in tr.model.state_dict().items()},
                           eval_logits=logits)
        times = []
        for _ in range(SP_STEP_TIMED):
            t0 = time.perf_counter()
            tr.train_step(db, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        row.update(step_ms_median=float(np.median(times)), step_ms=times)
        if trainer == "MBTRAIN" and tr.mesh.seq.size > 1:
            with torch.no_grad():
                enc = tr.model.encode(db, train=False)
                norm_x, cs = _prepare((enc["p_proto"], enc["h_omic"]), enc["h_path_bag"],
                                      db["img_mask"])
                cs = [c.contiguous() for c in cs]
                row["sp_modularity_ms"] = cuda_ms(
                    lambda: S._PASSES[mode](norm_x, cs, MOD_TEMP, tr.mesh.seq), 3, warmup=1)
        if rank == 0:
            row.update(loss=loss.item(), names=list(names),
                       grads=[gr.detach().cpu() for gr in grads])
        res[run] = row
        del tr, db, grads
        torch.cuda.empty_cache()
    return res


def sp_one_rank_layout(tr, mode: str):
    """A copy of the one-rank UMEML_GAN that runs the sequence-parallel
    code of ``mode`` on an axis of one rank (every collective the
    identity): the one-rank step with the layout's own rounding."""
    import copy

    from imp_torch.parallel.collectives import Axis

    model = copy.deepcopy(tr.model)
    model.seq, model.sp_mode = Axis("seq"), mode
    for blk in model.proto_g_blocks:
        blk.cross_attn.seq = model.seq
    return model


#: the layout's float64 replay against the one-rank model's: the same
#: function up to float64 rounding
SAME_FUNCTION_TOL = 1e-9
#: the most a float32 UMEML_GAN step at batch 8, bag 10 000 may sit from its
#: float64 replay: the one-rank step itself (no sp code) reaches 1.23-1.29e-4
#: on ``p_proto`` and the proto blocks' norm weights when its weights move
#: by 2^-22 (``sp_precision_probe.py``), as pairs near a tie switch prototype
F32_STEP_RESOLUTION = 2e-4


@contextlib.contextmanager
def modularity_inputs():
    """Record (prototype sets, bag, mask) of each modularity call of
    UMEML_GAN, one-rank or sharded, in the yielded list."""
    import imp_torch.models.umeml_gan as U

    seen, saved = [], (U.compute_modularity_pair, U.compute_modularity_pair_sp,
                       U.compute_modularity_pair_ring)

    def recording(fn):
        def call(c_list, x, *args, **kwargs):
            mask = kwargs.get("valid", kwargs.get("valid_local"))
            seen.append(([c.detach() for c in c_list], x.detach(), mask))
            return fn(c_list, x, *args, **kwargs)
        return call

    U.compute_modularity_pair, U.compute_modularity_pair_sp, U.compute_modularity_pair_ring = (
        recording(fn) for fn in saved)
    try:
        yield seen
    finally:
        U.compute_modularity_pair, U.compute_modularity_pair_sp, U.compute_modularity_pair_ring = saved


def argmax_flips(run_a, run_b) -> dict:
    """The (i, j) pairs of valid tokens (i != j) whose prototype of largest
    C[p, i] C[p, j] differs between two runs' modularity inputs (the max
    over prototypes of the loss, first max winning), per prototype set,
    and the pairs of each set where the two largest products of ``run_a``
    lie within 1e-6 of each other (relative)."""
    import torch

    from imp_torch.ops.modularity import _prepare

    def assignments(run):
        c_list, x, mask = run
        return _prepare(tuple(c.float() for c in c_list), x.float(), mask)

    nx, cs_a = assignments(run_a)
    _, cs_b = assignments(run_b)
    valid = nx.abs().sum(dim=2) > 0
    n = nx.shape[1]
    flips, near, pairs = [0] * len(cs_a), [0] * len(cs_a), 0
    with torch.no_grad():
        for r0 in range(0, n, 512):
            r1 = min(r0 + 512, n)
            vm = valid[:, r0:r1, None] & valid[:, None, :]
            ii = torch.arange(r0, r1, device=vm.device)
            vm[:, ii - r0, ii] = False
            pairs += int(vm.sum())
            for k, (ca, cb) in enumerate(zip(cs_a, cs_b)):
                prod_a = ca[:, :, r0:r1, None] * ca[:, :, None, :]  # [B, P, R, N]
                prod_b = cb[:, :, r0:r1, None] * cb[:, :, None, :]
                flips[k] += int(((prod_a.argmax(dim=1) != prod_b.argmax(dim=1)) & vm).sum())
                top2 = prod_a.topk(2, dim=1).values
                gap = (top2[:, 0] - top2[:, 1]) / top2[:, 0].clamp_min(1e-30)
                near[k] += int(((gap < 1e-6) & (top2[:, 0] > 0) & vm).sum())
                del prod_a, prod_b, top2, gap
    return {"flipped_pairs": flips, "near_tied_pairs": near, "valid_pairs": pairs}


def sp_layout_check(ref: dict, mesh_grads, mode: str) -> dict:
    """For a UMEML_GAN mesh step whose gradients miss STEP_TOL against the
    one-rank step: the same sequence-parallel code on an axis of one rank
    (:func:`sp_one_rank_layout`), with fixed gates: (1) the mesh within
    STEP_TOL of that layout run (what the collectives change); (2) the
    layout's float64 replay within SAME_FUNCTION_TOL of the one-rank
    model's float64 replay (the sp code computes the one-rank function);
    (3) :func:`float64_rule` on the layout (its kernels against its plain
    versions, its float64 replay arbitrating), and every gradient of the
    layout within F32_STEP_RESOLUTION of its float64 replay (a float32
    fault of the sp code that float64 hides).  Records the pairs whose
    prototype argmax differs between the layout, the one-rank step and the
    float64 replay (:func:`argmax_flips`), the cause of the layout's
    distance to the one-rank float32 step."""
    import copy

    import torch

    tr, db, names = ref["tr"], ref["db"], ref["names"]
    layout = sp_one_rank_layout(tr, mode)

    def loss_and_grads(model, batch):
        params = [dict(model.named_parameters())[n] for n in names]
        with tr._scope():
            loss = sp_loss(tr, model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if gr is None else gr for p, gr in zip(params, grads)]

    db64 = {k: v.double() if v.is_floating_point() else v for k, v in db.items()}
    with modularity_inputs() as seen:
        kern = loss_and_grads(layout, db)
        with plain_everything():
            flat = loss_and_grads(layout, db)
            m64 = copy.deepcopy(layout).double()
            exact = loss_and_grads(m64, db64)
            del m64
            if "float64" not in ref:  # the one-rank model's replay, once per trainer
                m64 = copy.deepcopy(tr.model).double()
                ref["float64"] = loss_and_grads(m64, db64)
                del m64
        if "inputs" not in ref:
            with torch.no_grad(), tr._scope():
                sp_loss(tr, tr.model, db)
    if "inputs" not in ref:
        ref["inputs"] = seen[-1]
    layout_in, exact_in = seen[0], seen[2]
    mesh = {n: rel_err(mg.to(DEVICE), lg) for n, mg, lg in zip(names, mesh_grads, kern)}
    same = {n: rel_err(x, o) for n, x, o in zip(names, exact, ref["float64"])}
    check = {
        "mesh_vs_layout": max(mesh.values()), "mesh_vs_layout_param": max(mesh, key=mesh.get),
        "layout_float64_vs_one_rank_float64": max(same.values()),
        "layout_vs_one_rank": max(rel_err(lg, og) for lg, og in zip(kern, ref["grads"])),
        "float64": float64_rule(names, kern, flat, exact),
        "layout_vs_float64": max(rel_err(lg.double(), x) for lg, x in zip(kern, exact)),
        "one_rank_vs_float64": max(rel_err(og.double(), x)
                                   for og, x in zip(ref["grads"], ref["float64"])),
        "argmax_flips": {"layout_vs_one_rank": argmax_flips(layout_in, ref["inputs"]),
                         "layout_vs_float64": argmax_flips(layout_in, exact_in),
                         "one_rank_vs_float64": argmax_flips(ref["inputs"], exact_in)},
    }
    check["ok"] = (check["mesh_vs_layout"] <= STEP_TOL
                   and check["layout_float64_vs_one_rank_float64"] <= SAME_FUNCTION_TOL
                   and check["float64"]["ok"]
                   and check["layout_vs_float64"] <= F32_STEP_RESOLUTION)
    del layout, kern, flat, exact, db64, seen
    torch.cuda.empty_cache()
    return check


def sp_layout_check_bf16(ref: dict, mesh_grads, mode: str) -> dict:
    """For a bf16 UMEML_GAN mesh step that misses the bf16 gate against the
    one-rank bf16 step: the same sequence-parallel code on an axis of one
    rank (:func:`sp_one_rank_layout`) under the same precision policy, with
    fixed gates: (1) the mesh within BF16_GATE of that layout run (what the
    collectives change); (2) the layout at fp32 within F32_STEP_RESOLUTION
    of the one-rank fp32 step (the sp code computes the one-rank function;
    bf16 rounds the two summation orders apart)."""
    import torch

    tr, db, names = ref["tr"], ref["db"], ref["names"]
    layout = sp_one_rank_layout(tr, mode)

    def loss_and_grads(cdtype):
        params = [dict(layout.named_parameters())[n] for n in names]
        saved, tr.cdtype = tr.cdtype, cdtype
        try:
            with tr._scope():
                loss = sp_loss(tr, layout, db)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            tr.cdtype = saved
        return [loss.detach()] + [torch.zeros_like(p) if gr is None else gr
                                  for p, gr in zip(params, grads)]

    bf16 = loss_and_grads(tr.cdtype)
    fp32 = loss_and_grads(None)
    mesh = {n: rel_err(mg.to(DEVICE), lg) for n, mg, lg in zip(names, mesh_grads, bf16[1:])}
    fp = {n: rel_err(lg, og) for n, lg, og in zip(names, fp32[1:], ref["fp32"][1:])}
    check = {"mesh_vs_layout": max(mesh.values()), "mesh_vs_layout_param": max(mesh, key=mesh.get),
             "layout_fp32_vs_one_rank_fp32": max(fp.values()),
             "layout_fp32_vs_one_rank_fp32_param": max(fp, key=fp.get),
             "layout_bf16_vs_one_rank_bf16": bf16_gate(bf16, ref["bf16"], ref["fp32"],
                                                       ("loss",) + tuple(names))}
    check["ok"] = (check["mesh_vs_layout"] <= BF16_GATE
                   and check["layout_fp32_vs_one_rank_fp32"] <= F32_STEP_RESOLUTION)
    del layout, bf16, fp32
    torch.cuda.empty_cache()
    return check


def sp_reference(root: str, out: str, trainer: str, prec: str) -> dict:
    """The one-rank step of a train_sp run: its loss and gradients on the
    card (under bf16 also the same trainer's fp32 step, the bf16 gate's
    reference), the trainer and batch for the layout checks, the peak
    memory; HFB's state and eval logits after one step and the float64
    replay of its gradients."""
    import copy

    import torch

    tr, db = sp_trainer(root, out, trainer, (1, 1), "gather", prec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, names, grads = sp_loss_and_grads(tr, db)
    torch.cuda.synchronize()
    ref = {"loss": loss.item(), "names": names, "grads": grads, "tr": tr, "db": db,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    if prec != "fp32":
        ref["bf16"] = [loss] + grads
        saved, tr.cdtype = tr.cdtype, None
        try:
            loss32, _, grads32 = sp_loss_and_grads(tr, db)
        finally:
            tr.cdtype = saved
        ref["fp32"] = [loss32] + grads32
    if trainer == "HFB":
        m64 = copy.deepcopy(tr.model).double()
        db64 = {k: v.double() if v.is_floating_point() else v for k, v in db.items()}
        params = [dict(m64.named_parameters())[n] for n in names]
        ref["float64"] = list(torch.autograd.grad(sp_loss(tr, m64, db64), params))
        del m64, db64
        tr.train_step(db)
        ref["state"] = {k: v.detach().to("cpu", copy=True)
                        for k, v in tr.model.state_dict().items()}
        ref["eval_logits"] = eval_logits(tr, tr.test_db).cpu()
    if trainer == "MBTRAIN" and prec == "fp32":  # K4+K5 on one rank at the same bag
        from imp_torch.ops.modularity import _prepare, modularity_passes

        with torch.no_grad():
            enc = tr.model.encode(db, train=False)
            norm_x, cs = _prepare((enc["p_proto"], enc["h_omic"]), enc["h_path_bag"],
                                  db["img_mask"])
            cs = [c.contiguous() for c in cs]
            ref["k4_k5_ms"] = cuda_ms(lambda: modularity_passes(norm_x, cs, MOD_TEMP), 5)
            del enc, norm_x, cs
    return ref


def hfb_check(ref: dict, mine: dict) -> dict:
    """HFB's (2, 1) step against the one-rank step at the global batch:
    every gradient within STEP_TOL of the one-rank gradient or of its
    float64 replay (float32 cannot resolve some of HFB's gradients to
    STEP_TOL: its BatchNorm normalises 2B rows, and the mesh sums the
    moments in another order), or no farther from the float64 replay than
    twice the one-rank float32 gradient; the running mean and variance
    after the step and rank 0's eval logits from them within STEP_TOL, and
    rank 0's state loading strictly into the one-rank model."""
    import torch

    names, tr = ref["names"], ref["tr"]
    misses, worst = {}, (None, 0.0)
    for n, g, w, x in zip(names, mine["grads"], ref["grads"], ref["float64"]):
        g = g.to(DEVICE)
        g_w, g_x, w_x = rel_err(g, w), rel_err(g.double(), x), rel_err(w.double(), x)
        if g_w > worst[1]:
            worst = (n, g_w)
        if g_w > STEP_TOL:
            misses[n] = {"mesh_vs_one_rank": g_w, "mesh_vs_float64": g_x,
                         "one_rank_vs_float64": w_x, "max_abs_grad": x.abs().max().item(),
                         "passed": g_x <= max(STEP_TOL, 2 * w_x)}
    grads = {"ok": all(m["passed"] for m in misses.values()), "worst": worst, "misses": misses}
    stats = {k: rel_err(mine["state"][k], v) for k, v in ref["state"].items()
             if k.endswith(("running_mean", "running_var"))}
    moved = all(float((ref["state"][k] - (0.0 if k.endswith("mean") else 1.0)).abs().max()) > 0
                for k in stats)
    reload = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.load_state_dict({k: v.to(DEVICE) for k, v in mine["state"].items()}, strict=True)
    reloaded = eval_logits(tr, tr.test_db).cpu()
    tr.model.load_state_dict(reload, strict=True)
    check = {"grads": grads, "running_stats_rel": max(stats.values()), "running_stats": len(stats),
             "running_stats_moved": moved,
             "eval_logits_rel": rel_err(mine["eval_logits"], ref["eval_logits"]),
             "reload_eval_logits_rel": rel_err(reloaded, ref["eval_logits"]), "tol_rel": STEP_TOL}
    check["ok"] = (grads["ok"] and moved and check["running_stats_rel"] <= STEP_TOL
                   and check["eval_logits_rel"] <= STEP_TOL
                   and check["reload_eval_logits_rel"] <= STEP_TOL)
    del reload
    torch.cuda.empty_cache()
    return check


def phase_train_sp(card: str, root: str, out: str):
    """Two ranks of :func:`imp_torch.parallel.launch.spawn`: NCCL where
    there are two cards, else both on card 0 over gloo with host-staged
    collectives.  Each run of ``SP_RUNS`` holds one step against the
    one-rank step on the card: TransMIL under flash at the 10 000 = 100²
    bag, gather and ring, and UMEML_GAN at batch 8, bag 10 000 x 512,
    gather and ring, and at (2, 1), batch 4 a rank: the loss and every
    gradient within STEP_TOL (for UMEML_GAN under sp, where the max over
    prototypes makes a gradient jump under rounding-level changes of the
    forward, :func:`sp_layout_check` judging a miss); UMEML_GAN under
    flash at ``TRAINER.PREC bf16``, gather and ring, and TransMIL at
    ``amp``, ring (K1-K3's bf16 entries on every hop): within phase 22's
    bf16 gate of the one-rank bf16 step (:func:`bf16_gate`, the same
    trainer's fp32 step as its reference; for UMEML_GAN a miss goes to
    :func:`sp_layout_check_bf16`); HFB at (2, 1), its BatchNorm over the
    data axis: :func:`hfb_check`.  Records each rank's launches (K1-K3 or
    their bf16 entries for the flash runs; no K4/K5 under sp, where the
    plain row-band passes run; K4/K5 once a step at (2, 1)), peak memory
    and step time with its backend, and the plain sp modularity passes
    beside K4+K5 on one rank."""
    import torch

    from imp_torch import kernels
    from imp_torch.parallel.launch import spawn

    count = torch.cuda.device_count()
    backend = "nccl" if count >= 2 else "gloo"
    print(f"chip_smoke: train_sp on {count} card(s) over {backend}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = {}
    for _, trainer, _, _, prec in SP_RUNS:
        if (trainer, prec) not in refs:
            refs[(trainer, prec)] = sp_reference(
                root, os.path.join(out, f"one_{trainer}_{prec}"), trainer, prec)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = spawn(sp_rank, 2, (root, out), device=DEVICE, timeout=900)
    spawn_s = time.perf_counter() - t0
    rows = {}
    for run, trainer, shape, mode, prec in SP_RUNS:
        ref, mine = refs[(trainer, prec)], got[0][run]
        errs = {n: rel_err(a.to(DEVICE), b)
                for n, a, b in zip(ref["names"], mine["grads"], ref["grads"])}
        worst = max(errs, key=errs.get)
        check = {"loss_rel": abs(mine["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30),
                 "grad_rel": errs[worst], "worst_param": worst, "params": len(errs),
                 "tol_rel": STEP_TOL}
        if trainer == "HFB":
            check["hfb"] = hfb_check(ref, mine)
            ok = check["hfb"]["ok"]
        elif prec != "fp32":
            mesh = [torch.tensor(mine["loss"], device=DEVICE)] + [g.to(DEVICE)
                                                                for g in mine["grads"]]
            check["bf16_gate"] = bf16_gate(mesh, ref["bf16"], ref["fp32"],
                                           ("loss",) + tuple(ref["names"]))
            ok = check["bf16_gate"]["ok"]
            if not ok:
                require(trainer == "MBTRAIN",
                        f"train_sp {run}: the bf16 mesh step misses the bf16 gate: {check}")
                check["layout"] = sp_layout_check_bf16(ref, mine["grads"], mode)
                ok = check["layout"]["ok"]
        else:
            ok = check["loss_rel"] <= STEP_TOL
            if errs[worst] > STEP_TOL:
                require(trainer == "MBTRAIN" and shape[1] > 1,
                        f"train_sp {run}: the mesh step disagrees with the one-rank step: {check}")
                check["layout"] = sp_layout_check(ref, mine["grads"], mode)
                ok &= check["layout"]["ok"]
        keys = ("launches", "peak_device_gib", "step_ms_median", "step_ms", "batch_rows",
                "bag_tokens", "backend", "sp_modularity_ms")
        per_rank = [{k: r[run][k] for k in keys if k in r[run]} for r in got]
        row = {"phase": "train_sp", "run": run, "card": card, "cards": count,
               "backend": backend, "backend_note": SP_BACKEND_NOTE[backend],
               "mesh": {"data": shape[0], "seq": shape[1]}, "sp_attention": mode,
               "prec": prec, "attention": sp_attention(trainer, prec),
               "check": check, "ranks": per_rank,
               "one_rank_peak_device_gib": ref["peak_device_gib"]}
        if "k4_k5_ms" in ref:
            row["one_rank_k4_k5_ms"] = ref["k4_k5_ms"]
        emit(row)
        require(ok, f"train_sp {run}: the mesh step disagrees with the one-rank step: {check}")
        flash = [BF16_ENTRIES[kn] if prec != "fp32" else kn for kn in FLASH_PRODUCTS]
        for pr in per_rank:
            la = pr["launches"]
            if sp_attention(trainer, prec) == "flash":
                require(all(la.get(kn, 0) > 0 for kn in flash),
                        f"train_sp {run}: K1-K3 ({flash}) did not launch on a rank: {la}")
            if trainer == "MBTRAIN" and shape[1] > 1:
                require(not any(kn.startswith("modularity") and c for kn, c in la.items()),
                        f"train_sp {run}: K4/K5 launched under sp: {la}")
            elif trainer == "MBTRAIN":
                require(la.get("modularity_deg") == 1 and la.get("modularity_combined") == 1,
                        f"train_sp {run}: K4/K5 must launch once a step a rank: {la}")
        rows[run] = row
    emit({"phase": "train_sp_summary", "card": card, "cards": count, "backend": backend,
          "spawn_seconds": spawn_s})
    refs.clear()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    return rows


# ---------------------------------------------------------------------------
# phase 30: the tensor- and pipeline-parallel CLIP towers
# ---------------------------------------------------------------------------

CLIP_PAR_PATCHES = 128  # images each (layout, precision) encodes, timed after a warm-up batch
CLIP_PAR_MICROBATCHES = 4
#: (layout, tp, pp) of clip_tp_pp, two ranks each
CLIP_PAR_RUNS = (("tp", 2, 1), ("pp", 1, 2))


def clip_size() -> int:
    """The image side of CLIP_MODEL."""
    from imp_torch.models.clip import CLIP_CONFIGS

    return CLIP_CONFIGS[CLIP_MODEL]["image_resolution"]


def clip_par_patches():
    """The seeded uint8 patches of clip_tp_pp."""
    size = clip_size()
    return np.random.default_rng(SEED + 1).integers(
        0, 256, size=(CLIP_PAR_PATCHES, size, size, 3), dtype=np.uint8)


def clip_encode_timed(encode, patches, device) -> tuple:
    """(features, seconds) of the patches through ``clip_feature.encode_slide``
    at CLIP_BATCH, after one warm-up batch."""
    import torch

    from imp_torch.tools.clip_feature import encode_slide

    size = patches.shape[1]
    encode_slide(encode, lambda i: patches[i], list(range(CLIP_BATCH)), CLIP_BATCH, size, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = encode_slide(encode, lambda i: patches[i], list(range(len(patches))), CLIP_BATCH,
                         size, device)
    torch.cuda.synchronize()
    return feats, time.perf_counter() - t0


def clip_par_rank(rank: int):
    """One rank of clip_tp_pp: for each layout of CLIP_PAR_RUNS and each
    precision, the tower split over both ranks
    (``clip_feature.build_parallel_encoder``, random weights from seed 0 as
    the one-rank tool draws them), its features of the seeded patches
    through ``encode_slide`` (rank 0 returns them), images/s, this rank's
    block-weight bytes and peak memory."""
    import torch

    from imp_torch.tools.clip_feature import build_parallel_encoder

    from imp_torch.parallel.mesh import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    device = rank_device(DEVICE, rank)
    patches = clip_par_patches()
    res = {}
    for layout, tp, pp in CLIP_PAR_RUNS:
        for prec in ("fp32", "bf16"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mesh, encode, params = build_parallel_encoder(CLIP_MODEL, tp, pp,
                                                          CLIP_PAR_MICROBATCHES, device, prec)
            split = params["shard"].values() if tp > 1 else [params["stages"]]
            block_bytes = sum(t.numel() * t.element_size() for blk in split for t in blk.values())
            if tp > 1:  # the replicated per-block LayerNorms and biases
                block_bytes += sum(t.numel() * t.element_size() for k, t in params["rep"].items()
                                   if k.startswith("resblocks."))
            feats, seconds = clip_encode_timed(encode, patches, device)
            row = {"images_per_s": len(patches) / seconds, "seconds": seconds,
                   "block_weight_bytes": block_bytes,
                   "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "backend": (mesh.model if tp > 1 else mesh.pipe).backend}
            if rank == 0:
                row["feats"] = feats
            res[(layout, prec)] = row
            del encode, params
    return res


def phase_clip_tp_pp(card: str):
    """The ViT-B/16 tower at full width (12 blocks of 768, 12 heads, 224 px),
    random weights, split over two ranks of
    :func:`imp_torch.parallel.launch.spawn` (NCCL on two cards, else both on
    card 0 over gloo): tensor parallel at tp = 2 and pipeline parallel at
    pp = 2 with 4 microbatches, each in fp32 and bf16, driven through
    ``clip_feature.encode_slide`` on seeded uint8 patches at batch 32.  The
    fp32 features within CLIP_TOL of the one-rank tower's (max-abs) and 2
    images within CLIP_TOL of their float64 CPU replay; the bf16 features'
    cosine to the one-rank fp32 ones at least CLIP_BF16_COS; images/s, each
    rank's block-weight bytes and peak memory beside the one-rank tower's.
    No kernel of ``csrc`` runs (the JAX towers use no Pallas kernel)."""
    import torch

    from imp_torch import kernels
    from imp_torch.parallel.launch import spawn
    from imp_torch.tools.clip_feature import build_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    count = torch.cuda.device_count()
    patches = clip_par_patches()
    one = {}
    for prec in ("fp32", "bf16"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tower, encode = build_encoder(CLIP_MODEL, DEVICE, prec)
        feats, seconds = clip_encode_timed(encode, patches, DEVICE)
        one[prec] = {"images_per_s": len(patches) / seconds, "seconds": seconds,
                     "block_weight_bytes": sum(p.numel() * p.element_size()
                                               for p in tower.resblocks.parameters()),
                     "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "feats": feats}
        if prec == "fp32":
            x = torch.from_numpy(patches[:CLIP_REPLAY_IMAGES]).to(DEVICE)
            replay = float64_replay(tower, x)
        del tower, encode
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = spawn(clip_par_rank, 2, (), device=DEVICE, timeout=600)
    spawn_s = time.perf_counter() - t0
    launches = only_launched(kernels.launches())
    ref32 = one["fp32"]["feats"]
    runs, ok = {}, True
    for layout, tp, pp in CLIP_PAR_RUNS:
        for prec in ("fp32", "bf16"):
            feats = got[0][(layout, prec)].pop("feats")
            check = {"shape": list(feats.shape), "finite": bool(np.isfinite(feats).all())}
            if prec == "fp32":
                check.update(
                    vs_one_rank_rel=rel_max_err(torch.from_numpy(feats),
                                                torch.from_numpy(ref32)),
                    replay_rel=rel_max_err(torch.from_numpy(feats[:CLIP_REPLAY_IMAGES]), replay),
                    tol=CLIP_TOL)
                passed = check["vs_one_rank_rel"] <= CLIP_TOL and check["replay_rel"] <= CLIP_TOL
            else:
                cos = (feats * ref32).sum(1) / (np.linalg.norm(feats, axis=1)
                                                * np.linalg.norm(ref32, axis=1))
                check.update(cos_min_vs_one_rank_fp32=float(cos.min()), cos_floor=CLIP_BF16_COS)
                passed = check["cos_min_vs_one_rank_fp32"] >= CLIP_BF16_COS
            check["ok"] = passed and check["finite"] and feats.shape == ref32.shape
            ok &= check["ok"]
            runs[f"{layout}_{prec}"] = {"tp": tp, "pp": pp, "check": check,
                                        "ranks": [r[(layout, prec)] for r in got],
                                        "one_rank": {k: v for k, v in one[prec].items()
                                                     if k != "feats"}}
    row = {"phase": "clip_tp_pp", "card": card, "cards": count,
           "backend": "nccl" if count >= 2 else "gloo", "model": CLIP_MODEL,
           "batch": CLIP_BATCH, "images": CLIP_PAR_PATCHES,
           "microbatches": CLIP_PAR_MICROBATCHES, "runs": runs, "launches": launches,
           "spawn_seconds": spawn_s}
    emit(row)
    require(ok, f"clip_tp_pp: a split tower disagrees with the one-rank tower: {row}")
    return row


# ---------------------------------------------------------------------------
# --sp-only: the extraction tools under torchrun
# ---------------------------------------------------------------------------

#: slides (patch counts) of the tools' synthetic tree: two of three batches
#: and a single patch (which clip_feature_dp skips)
TOOL_SLIDES = {"s0": 96, "s1": 64, "single": 1}


def has_h5py() -> bool:
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def make_tool_tree(root: str) -> str:
    """``<root>/tcga_x/images/train/<slide>/pNNN.png``: each a seeded uint8
    ViT-B/16 patch saved with ``np.save`` (PIL may be absent on the card's
    host; :func:`rank_tool` reads them back); returns the slides' dir."""
    size = clip_size()
    src = os.path.join(root, "tcga_x", "images", "train")
    rng = np.random.default_rng(SEED + 2)
    for slide, n in TOOL_SLIDES.items():
        os.makedirs(os.path.join(src, slide))
        for i in range(n):
            with open(os.path.join(src, slide, f"p{i:03d}.png"), "wb") as f:
                np.save(f, rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8))
    return src


def rank_tool(tool: str, *argv) -> int:
    """One torchrun rank of ``imp_torch.tools.<tool>`` on the tree of
    :func:`make_tool_tree`: its patches read with ``np.load``, and, where
    h5py is absent, each slide's features saved by ``np.save`` to
    ``<slide>.h5.npy`` in place of the ``.h5`` (said so in the phase's
    row)."""
    import importlib

    mod = importlib.import_module(f"imp_torch.tools.{tool}")
    base = importlib.import_module("imp_torch.tools.clip_feature")

    def load(path, size, as_uint8=False):
        return np.load(path)

    def save(out_path, key, feats):
        np.save(out_path + ".npy", feats)

    for m in {mod, base}:
        m.preprocess = load
        if not has_h5py():
            m.write_features = save
    mod.main(list(argv))
    return 0


def read_features(path: str) -> np.ndarray:
    """A slide's features as the tool (or :func:`rank_tool`'s stand-in) wrote them."""
    if has_h5py():
        import h5py

        with h5py.File(path) as f:
            return f["clip_feature"][()]
    return np.load(path + ".npy")


def phase_clip_tools(card: str, tmp: str) -> dict:
    """``torchrun --standalone --nproc-per-node <cards>`` of
    ``imp_torch.tools.clip_feature --tp <cards>`` and ``--pp <cards>`` (4
    microbatches) and of ``imp_torch.tools.clip_feature_dp`` (the global
    batch of 32 split over every card) on the tree of :func:`make_tool_tree`
    (ViT-B/16, random weights): every rank exits 0, and each slide's
    features equal the one-card tool's (``build_encoder`` and
    ``encode_slide`` on card 0) within CLIP_TOL of the max-abs; the dp tool
    skips the single-patch slide.  Where h5py is absent the tools' writer
    is replaced by ``np.save`` (the row says so)."""
    import torch

    from imp_torch.tools.clip_feature import build_encoder, encode_slide

    n = torch.cuda.device_count()
    src = make_tool_tree(os.path.join(tmp, "tools"))
    size = clip_size()
    _, encode = build_encoder(CLIP_MODEL, DEVICE, "fp32")
    want = {}
    for slide in TOOL_SLIDES:
        items = sorted(os.listdir(os.path.join(src, slide)))
        want[slide] = encode_slide(encode, lambda f, s=slide: np.load(os.path.join(src, s, f)),
                                   items, CLIP_BATCH, size, DEVICE)
    del encode
    torch.cuda.empty_cache()
    common = ["--random-weights", "--batch-size", str(CLIP_BATCH), "--key", "clip_feature",
              "--device", DEVICE]
    runs = {
        "tp": ("clip_feature", ["--src", src, "--dst", os.path.join(tmp, "feat_tp"), "--model",
                                CLIP_MODEL, "--tp", str(n)] + common),
        "pp": ("clip_feature", ["--src", src, "--dst", os.path.join(tmp, "feat_pp"), "--model",
                                CLIP_MODEL, "--pp", str(n), "--microbatches", "4"] + common),
        "dp": ("clip_feature_dp", ["--root", os.path.join(tmp, "tools"), "--dataset", "tcga_x",
                                   "--output-dir", os.path.join(tmp, "feat_dp"), "--model",
                                   "clip_vit_b16"] + common),
    }
    rows = {}
    for name, (tool, argv) in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            ["torchrun", "--standalone", "--nproc-per-node", str(n), os.path.abspath(__file__),
             "--rank-tool", tool] + argv, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        out_dir = (os.path.join(tmp, "feat_dp", "clip_vit_b16", "tcga_x") if name == "dp"
                   else argv[argv.index("--dst") + 1])
        errs, present = {}, {}
        for slide in TOOL_SLIDES:
            path = os.path.join(out_dir, slide + ".h5")
            present[slide] = os.path.exists(path if has_h5py() else path + ".npy")
            if present[slide]:
                got = read_features(path)
                errs[slide] = (rel_max_err(torch.from_numpy(got), torch.from_numpy(want[slide]))
                               if got.shape == want[slide].shape else float("inf"))
        expect = {s: not (name == "dp" and c <= 1) for s, c in TOOL_SLIDES.items()}
        row = {"phase": "clip_tools", "card": card, "cards": n, "tool": tool, "run": name,
               "rc": proc.returncode, "seconds": seconds, "slides_written": present,
               "rel_err_vs_one_card": errs, "tol": CLIP_TOL,
               "writer": "h5py" if has_h5py() else
               "np.save to <slide>.h5.npy (h5py is absent on this host; no .h5 written)"}
        emit(row)
        require(proc.returncode == 0 and present == expect
                and all(e <= CLIP_TOL for e in errs.values()),
                f"clip tool {name} failed: {row}\n{proc.stderr[-4000:]}")
        rows[name] = row
    return rows


#: the train CLI runs of ``--sp-only`` under torchrun, one rank per card:
#: (name, trainer, TPU.MESH_SHAPE as a function of the card count,
#: SP_ATTENTION, further options)
SP_CLI_RUNS = (("TransMIL", "TransMIL", lambda n: (1, n), "ring", ()),
               ("MBTRAIN", "MBTRAIN", lambda n: (n // 2, 2), "gather", ()),
               ("MBTRAIN_bf16", "MBTRAIN", lambda n: (n // 2, 2), "ring",
                ("TRAINER.PREC", "bf16", "TPU.ATTENTION", "flash")))


def rank_cli(root: str, out: str, trainer: str, shape: str, mode: str, extra: str = "[]") -> int:
    """One torchrun rank of ``python -m imp_torch.tools.train`` for one epoch
    on the seeded bags (the card's host has no h5py): TransMIL under flash
    (TransMIL.yaml) or MBTRAIN on UMEML_GAN.yaml's values, on the mesh
    ``shape`` of ('data', 'seq'), with the options of the JSON list
    ``extra``; writes ``rank_cli<RANK>.json`` beside ``out`` (the ranks'
    stdout interleaves)."""
    from imp_torch import kernels
    from imp_torch.tools.train import run

    if trainer == "TransMIL":
        argv = transmil_argv(root, out) + ["OPTIM.MAX_EPOCH", "1"]
    else:
        argv = (["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--config-file",
                 os.path.join(CONFIGS, "Survival", "UMEML_GAN.yaml"), "--output-dir", out,
                 "--device", DEVICE] + flagship_opts(**{"OPTIM.MAX_EPOCH": 1}))
    argv += ["TPU.MESH_AXES", "('data','seq')", "TPU.MESH_SHAPE", shape,
             "TPU.SP_ATTENTION", mode] + json.loads(extra)
    with seeded_bags():
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = run(argv)
        seconds = time.perf_counter() - t0
    rank = int(os.environ["RANK"])
    with open(f"{out}.rank_cli{rank}.json", "w") as f:
        json.dump({"rank": rank, "trainer": trainer, "mesh": shape, "sp_attention": mode,
                   "options": json.loads(extra), "result": result, "seconds": seconds,
                   "launches": only_launched(kernels.launches())}, f)
    return 0


def phase_train_sp_cli(card: str, root: str, out: str) -> dict:
    """``torchrun --standalone --nproc-per-node <cards>`` (a free rendezvous
    port on localhost) of the train CLI through
    :func:`rank_cli` for each run of ``SP_CLI_RUNS`` (one epoch; NCCL, one
    card a rank): every rank exits 0 and reports the same result."""
    import torch

    n = torch.cuda.device_count()
    rows = {}
    for name, trainer, shape_of, mode, extra in SP_CLI_RUNS:
        shape, run_out = str(shape_of(n)), os.path.join(out, f"cli_{name}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            ["torchrun", "--standalone", "--nproc-per-node", str(n), os.path.abspath(__file__),
             "--rank-cli", root, run_out, trainer, shape, mode, json.dumps(list(extra))],
            capture_output=True, text=True, timeout=600)
        ranks = []
        for r in range(n):
            path = f"{run_out}.rank_cli{r}.json"
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
        row = {"phase": "train_sp_cli", "card": card, "cards": n, "run": name,
               "trainer": trainer, "mesh": shape, "sp_attention": mode,
               "options": list(extra), "rc": proc.returncode,
               "seconds": time.perf_counter() - t0, "ranks": ranks}
        emit(row)
        require(proc.returncode == 0 and len(ranks) == n
                and len({r["result"] for r in ranks}) == 1,
                f"torchrun of the train CLI failed: {row}\n{proc.stderr[-4000:]}")
        rows[name] = row
    return rows


def sp_only() -> int:
    """``python3 chip_smoke.py --sp-only`` on a host of several cards: the
    kernels built, then ``train_sp`` and ``clip_tp_pp`` (NCCL between two
    of the cards), ``train_sp_cli`` and ``clip_tools`` (every card a rank),
    the card line and the ok line."""
    import torch

    from imp_torch import kernels

    if torch.cuda.device_count() < 2:
        print("chip_smoke --sp-only: needs two cards or more", file=sys.stderr)
        return 2
    card = card_line()
    kernels.build()
    for name in kernels.KERNELS:
        kernels.load(name)
    with tempfile.TemporaryDirectory(prefix="imp_torch_sp_") as tmp:
        root = make_train_tree(os.path.join(tmp, "tree"))
        phase_train_sp(card, root, os.path.join(tmp, "sp"))
        phase_clip_tp_pp(card)
        phase_train_sp_cli(card, root, os.path.join(tmp, "sp_cli"))
        phase_clip_tools(card, tmp)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from imp_torch import kernels

    card = card_line()
    t0 = time.perf_counter()
    report = kernels.build()
    for name in kernels.KERNELS:
        kernels.load(name)
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "sources": {src: {"seconds": r["seconds"], "ptxas": ptxas_lines(report, src)}
                    for src, r in report.items()},
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    seconds = {}  # wall seconds of each phase

    def clocked(name, phase, *args, **kw):
        t = time.perf_counter()
        out = phase(*args, **kw)
        seconds[name] = time.perf_counter() - t
        return out

    krows = clocked("kernel_flash_fwd", phase_kernel, card, report)
    brows = clocked("kernel_flash_bwd", phase_flash_bwd, card, report)
    mrows = clocked("kernel_modularity", phase_modularity, card, report)
    prows = clocked("kernel_pinv", phase_pinv, card, report)
    with tempfile.TemporaryDirectory(prefix="imp_torch_smoke_") as tmp:
        _, counts = clocked("serve_flash", phase_serve, "flash", card, tmp)
        clocked("serve_nystrom", phase_serve, "auto", card, tmp)
        root = make_train_tree(os.path.join(tmp, "tree"))
        _, train_counts = clocked("train", phase_train, card, root, os.path.join(tmp, "train"))
        clocked("train_step", phase_train_step, card, root, os.path.join(tmp, "train_step"))
        _, bench_launches = clocked("bench_tools", phase_bench_tools, card, tmp)
        _, umeml_counts = clocked("train_umeml", phase_train_umeml, card, root,
                                  os.path.join(tmp, "umeml"))
        clocked("train_step_umeml", phase_train_step_umeml, card, root,
                os.path.join(tmp, "umeml_step"))
        _, transmil_counts = clocked("train_transmil", phase_train_transmil, card, root,
                                     os.path.join(tmp, "transmil"))
        clocked("train_step_transmil", phase_train_step_transmil, card, root,
                os.path.join(tmp, "transmil_step"))
        clocked("train_transmil_nystrom", phase_train_transmil, card, root,
                os.path.join(tmp, "transmil_nystrom"), attention="auto")
        clocked("train_step_transmil_nystrom", phase_train_step_transmil, card, root,
                os.path.join(tmp, "transmil_nystrom_step"), attention="auto")
        clocked("train_flash", phase_train, card, root, os.path.join(tmp, "train_flash"),
                attention="flash")
        clocked("train_step_flash", phase_train_step, card, root,
                os.path.join(tmp, "train_step_flash"), attention="flash")
        export_row = clocked("serve_export", phase_serve_export, card, tmp,
                             os.path.join(tmp, "train_flash"), os.path.join(tmp, "transmil"))
        clocked("train_classification", phase_train_classification, card, root,
                os.path.join(tmp, "classification"))
        clocked("train_step_tasks", phase_train_step_tasks, card, root,
                os.path.join(tmp, "task_steps"))
        clocked("test_new", phase_test_new, card, root, os.path.join(tmp, "test_new"))
        clocked("train_zoo", phase_train_zoo, card, root, os.path.join(tmp, "zoo"))
        _, cmta_flash_counts = clocked("train_cmta", phase_train_cmta, card, root,
                                       os.path.join(tmp, "cmta"))
        _, cmta_fused_counts = clocked("train_cmta_nystrom", phase_train_cmta, card, root,
                                       os.path.join(tmp, "cmta_nystrom"), attention="auto")
        clocked("train_step_cmta", phase_train_step_cmta, card, root,
                os.path.join(tmp, "cmta_step"))
        clocked("train_step_bf16", phase_train_step_bf16, card, root,
                os.path.join(tmp, "bf16_step"))
        _, bf16_counts = clocked("train_bf16", phase_train_bf16, card, root,
                                 os.path.join(tmp, "bf16"))
        clocked("umeml_bsm", phase_umeml_bsm, card, root, os.path.join(tmp, "bsm"))
        clocked("umeml_gan_variants", phase_umeml_gan_variants, card, root,
                os.path.join(tmp, "variants"))
        partial_row = clocked("kernel_flash_partial", phase_flash_partial, card)
        partial_bf16_row = clocked("kernel_flash_partial_bf16", phase_flash_partial, card, "bf16")
        sp_rows = clocked("train_sp", phase_train_sp, card, root, os.path.join(tmp, "sp"))
        clocked("clip_tp_pp", phase_clip_tp_pp, card)
        clocked("clip_vit_b16", phase_clip_vit_b16, card)
        clocked("clip_rn50", phase_clip_rn50, card)
        clocked("train_clipomic", phase_train_clipomic, card, root, os.path.join(tmp, "clipomic"))
        _, plip_counts = clocked("plip_umeml_gan", phase_plip_umeml_gan, card, root,
                                 os.path.join(tmp, "plip"))
        _, protocol_counts = clocked("protocol", phase_protocol, card, root,
                                     os.path.join(tmp, "protocol"))
    # last, where the profiler loses the most records (traced)
    bf16_rows = clocked("kernel_flash_bf16", phase_flash_bf16, card, report)
    clocked("trace_sessions", phase_trace_sessions, card)
    emit({"phase_seconds": seconds, "total_seconds": time.perf_counter() - t0})

    def cmta_entry(name):
        """The kernel on CMTA's path: launches in one epoch, time at its shape."""
        if name.startswith("pinv"):
            main, counts = prows[(name, CMTA_PINV_SHAPE)], cmta_fused_counts
        elif name == "flash_fwd":
            main, counts = krows[CMTA_FLASH_SHAPE], cmta_flash_counts
        else:
            main, counts = brows[(name, CMTA_FLASH_SHAPE)], cmta_flash_counts
        return {"launches": counts[name], "shape": main["shape"], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                **({"pair": main["pair"]} if "pair" in main else {}),
                **({"chain": main["chain"]} if "chain" in main else {})}

    def per_forward(key):
        return sum(krows[s][key] * n for s, n in FLASH_PER_FORWARD.items())

    def program_entry(name):
        """The kernel as the registered operator that the exported programs
        of serve_export call: its launches per served forward."""
        models = ("umeml_gan", "transmil") if name == "flash_fwd" else ("umeml_gan_fused",)
        per = {m: export_row[m]["launches_per_forward"].get(name, 0) for m in models}
        return {"operator": f"imp_torch::{name}", "launches_per_served_forward": per,
                "launches": sum(per.values())}

    def bf16_entry(name):
        """The kernel's bf16 entry: its launches in the bf16 CLI runs
        (UMEML_GAN and CMTA) and its times at TransMIL's bag; K1's bits
        against its fp32 entry, K2's and K3's gates (b) and (c), their times
        beside the fp32 entries', shares of the bound and ptxas lines."""
        main = bf16_rows[(name, BF16_MAIN_SHAPE)]
        mine = [r for (k, _), r in bf16_rows.items() if k == name]
        entry = {"entry": main["entry"], "launches": bf16_counts[BF16_ENTRIES[name]],
                 "shape": BF16_MAIN_SHAPE, "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "share_of_bound": main["share_of_bound"],
                 "library_ms": main["library_ms"] if name == "flash_fwd"
                 else main["pair"]["library_ms"],
                 "max_abs_err": max(r["max_abs_err"] for r in mine)}
        if name == "flash_fwd":
            return {**entry, "library_bf16_ms": main["library_bf16_ms"],
                    "library_bf16_note": main["library_bf16_note"],
                    "same_bits_as_f32_entry": all(all(r["same_bits_as_f32_entry"].values())
                                                  for r in mine)}
        return {**entry, "pair": main["pair"], "fp32_entry_ms": main["fp32_entry_ms"],
                "by_shape": {r["shape"]: {"ms": r["ms"], "fp32_entry_ms": r["fp32_entry_ms"],
                                          "bound_ms": r["bound_ms"],
                                          "share_of_bound": r["share_of_bound"]}
                             for r in mine},
                "same_bits_twice": all(all(r["same_bits_twice"].values()) for r in mine),
                "float64_worst_ratio": max(v["ratio"] for r in mine
                                           for v in r["float64"].values()
                                           if isinstance(v, dict)),
                "dynamic_smem_bytes": main["dynamic_smem_bytes"], "ptxas": main["ptxas"]}

    def partial_entry(name, row=None, runs=("transmil_ring", "transmil_gather")):
        """The kernel (or its bf16 entry: ``row`` the bf16 phase 29) under
        the ring's per-chunk contract: launches per hop and per ring of
        kernel_flash_partial, its per-hop and one-call times there, and the
        entry's launches per rank in train_sp's ``runs``."""
        row = row or partial_row
        side = "fwd" if name == "flash_fwd" else "bwd"
        entry = row["entries"][name]
        return {
            "entry": entry, "shape": row["shape"], "chunks": row["chunks"],
            "launches_per_hop": row["launches_per_hop"][name],
            "launches": row["launches"][name],
            "hop_ms": row[f"{side}_hop_ms"],
            "ring_ms": row[f"{side}_ring_ms"],
            "hop_bound_ms": row["bound"][f"{side}_hop_ms"],
            "ring_bound_ms": row["bound"][f"{side}_ring_ms"],
            "one_call_ms": row[f"{side}_one_call_ms"],
            **({"covers": "K2 and K3 together (one flash_attention_bwd call a hop)"}
               if side == "bwd" else {}),
            "max_abs_err": row["max_abs_err"][name],
            "train_sp_launches_per_rank": {
                run: [r["launches"].get(entry, 0) for r in sp_rows[run]["ranks"]]
                for run in runs},
        }

    def partial_bf16_entry(name):
        return partial_entry(name, partial_bf16_row,
                             ("umeml_gan_bf16_gather", "umeml_gan_bf16_ring", "transmil_amp_ring"))

    def modularity_entry(name):
        main = mrows[(name, MOD_MAIN_SHAPE)]
        return {
            "name": name, **KERNEL_INFO[name], "launches": train_counts[name],
            "plip_launches": plip_counts[name],
            "max_abs_err": max(r["max_abs_err"] for (k, _), r in mrows.items() if k == name),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "kernel_device_ms_by": main["kernel_device_ms_by"],
            "bound_fp32_cores_ms": main["bound_fp32_cores_ms"],
            "share_of_bound": main["share_of_bound"], "same_bits_twice": main["same_bits_twice"],
            "dynamic_smem_bytes": main["dynamic_smem_bytes"],
            "ptxas": main["ptxas"], "protocol_launches": protocol_counts[name],
        }

    def flash_bwd_entry(name):
        main = brows[(name, BWD_MAIN_SHAPE)]  # TransMIL's bag
        return {
            "name": name, **KERNEL_INFO[name], "launches": transmil_counts[name],
            "max_abs_err": max(r["max_abs_err"] for (k, _), r in brows.items() if k == name),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"], "pair": main["pair"],
            "share_of_bound": main["share_of_bound"],
            "dynamic_smem_bytes": main["dynamic_smem_bytes"], "ptxas": main["ptxas"],
            "cmta": cmta_entry(name), "bf16": bf16_entry(name), "partial": partial_entry(name),
            "partial_bf16": partial_bf16_entry(name), "protocol_launches": protocol_counts[name],
        }

    def pinv_entry(name):
        main = prows[(name, PINV_MAIN_SHAPE)]  # UMEML's TransLayers at batch 2
        return {
            "name": name, **KERNEL_INFO[name], "launches": umeml_counts[name],
            "max_abs_err": max(r["max_abs_err"] for (k, _), r in prows.items() if k == name),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "chain": main["chain"],
            "bound_fp32_cores_ms": main["bound_fp32_cores_ms"],
            "share_of_bound": main["share_of_bound"], "same_bits_twice": main["same_bits_twice"],
            "cluster": main["cluster"], "dynamic_smem_bytes": main["dynamic_smem_bytes"],
            "ptxas": main["ptxas"], "cmta": cmta_entry(name),
            **({"program": program_entry(name)} if name == "pinv_fwd" else {}),
            "protocol_launches": protocol_counts[name],
        }

    entries = [
        {
            "name": "flash_fwd", **KERNEL_INFO["flash_fwd"],
            "launches": counts["flash_fwd"],
            "max_abs_err": max(max(r["max_abs_err_o"], r["max_abs_err_lse"]) for r in krows.values()),
            # one serving forward: 4 launches at B=8,N=7 and 2 at B=16,N=14
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": "bytes" if all(krows[s]["bound_by"] == "bytes" for s in FLASH_PER_FORWARD)
            else "operations",
            "library_ms": per_forward("library_ms"),
            "cmta": cmta_entry("flash_fwd"), "bf16": bf16_entry("flash_fwd"),
            "partial": partial_entry("flash_fwd"), "partial_bf16": partial_bf16_entry("flash_fwd"),
            "program": program_entry("flash_fwd"),
            "protocol_launches": protocol_counts["flash_fwd"],
        },
        *(flash_bwd_entry(n) for n in ("flash_bwd_dq", "flash_bwd_dkv")),
        modularity_entry("modularity_deg"),
        modularity_entry("modularity_combined"),
        *(pinv_entry(n) for n in ("pinv_fwd", "pinv_bwd")),
    ]
    for entry in entries:  # launches per step or call of the bench tools (bench_tools)
        entry["bench_launches"] = bench_launches[entry["name"]]
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-cli"]:
        sys.exit(rank_cli(*sys.argv[2:8]))
    if sys.argv[1:2] == ["--rank-tool"]:
        sys.exit(rank_tool(*sys.argv[2:]))
    sys.exit(sp_only() if sys.argv[1:] == ["--sp-only"] else main())
