#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU, through its
hand-written kernels, and check what comes out.

    python3 chip_smoke.py

Models, each at full width with random weights from a seed, written as an
original-format checkpoint and loaded through ``make_dpt_from_state_dict``:
  * Depth-Anything V2 ViT-L (F=1024, 24 blocks, 16 heads x 64, patch 14):
    a 720x1280 BGR frame at max side 518 snaps to 504x504 (1297 tokens);
    the same weights under a ``..._metric_...`` file name give the metric
    model (sigmoid head); the long-N ladder serves one request at each max
    side 756, 1036, 1428 and 1904 (square: N = 2917, 5477, 10405, 18497);
  * Depth-Anything V1 ViT-L (the same widths; ``depth_anything_vitl14.pth``,
    so the family sniffing picks V1: taps on the last 4 blocks);
  * Depth-Anything V2 ViT-Giant (F=1536, 40 blocks, 24 heads x 64, SwiGLU
    hidden 4096, reassembly 1536 x 4, fusion 384) at 504x504;
  * MiDaS v3.1 BEiT-L-512 (F=1024, 24 blocks, 16 heads x 64, patch 16,
    relative-position bias in every block): max side 512 gives 512x512
    (1025 tokens), max side 1024 gives 1024x1024 (4097 tokens);
  * MiDaS v3.1 SwinV2-L-384 (F=192/384/768/1536, 2/2/18/2 blocks, 6/12/24/48
    heads x 32, patch 4, window 24): max side 384 gives 384x384, whose 24
    window attentions run at (nW, A, H) = (16, 576, 6) with the shift mask
    on odd blocks, (4, 576, 12) likewise, (1, 576, 24) and (1, 144, 48);
    max side 512 gives 512x512, where the window search picks 32 (A=1024)
    at stages 1-3 and 16 at stage 4.

The CUDA sources port twelve TPU kernels; the ``kernels`` JSON line has
one entry per TPU kernel:
  #1 fused qkv, unbiased  -- the Depth-Anything path; in bf16 the wgmma/TMA
     kernel of csrc/flash_attention_sm90.cu, which takes every bf16 launch
     without a bias or with a bf16 one (#2's and #4's too), in f32
     csrc/flash_attention.cu;
  #2 fused qkv, biased    -- the BEiT path (cached bias stack or inline bias;
     in bf16 the same kernel's BIAS_BF16 instantiation, its bias tiles
     filled by TMA or, for layouts TMA cannot read, by the producer's warps);
  #3 window attention     -- the SwinV2 path, the CPB bias and shift mask
     read factored, by head and by window: in bf16 with bf16 biases (the
     model's cached CPB stacks and masks) the wgmma/TMA kernel of
     csrc/window_attention_sm90.cu, which takes every such launch a tensor
     map can read (route ``window_sm90``); in f32, and bf16 with an f32
     bias, csrc/window_attention.cu (route ``window``);
  #4 / #5 (B, N, H, D) op -- the JAX package reaches it through its
     ``flash_attention`` op (the drop-in for dot_product_attention); no model
     of the port calls it, since the port serves every BEiT grid through #2.
     Its path is that op, driven at BEiT-L-512's attention shape (#4) and
     past 32768 keys (#5, the online kernel's regime; bf16 in
     csrc/flash_attention_sm90.cu);
  #6 / #7 int8-QK^T attention, the (B H, N, D) entry and the head-major
     qkv-slab entry (C entry csrc/flash_attention_int8.cu): every call runs
     the quantize prologue of csrc/flash_attention_int8_sm90.cu (two
     kernels, i8_pass_a and i8_pass_b), then in bf16 that source's int8
     wgmma/TMA attention kernel (fa_i8_sm90; routes ``int8_qk_sm90``,
     ``int8_qk_fused_sm90``), in f32 fa_int8_f32 (routes ``int8_qk``,
     ``int8_qk_fused``); as in the JAX package, no model serves through
     them. Their path holds them against the int8+qkv DA-V2 ViT-L's own qkv
     slabs (blocks 0, 11 and 23, B=8, captured by a forward hook on the
     block's qkv layer), the prologue's int8 q, int8 k and alpha equal to
     the plain prologue's by torch.equal, with CUDA-event and device times
     of the whole call, the prologue alone and the attention kernel alone
     against their plain versions, kernel #1 and SDPA on block 11's slab;
  #8 fused LayerNorm -> MLP -> LayerScale residual: in bf16 the three
     kernels of csrc/fused_mlp_sm90.cu (a LayerNorm pass, fc1 + GELU and
     fc2 + LayerScale residual as wgmma/TMA GEMMs; route ``fused_mlp_sm90``),
     in f32 mlp_f32 of csrc/fused_mlp.cu (route ``fused_mlp``), and
  #9 fused head tail, 3x3 conv -> ReLU -> 1x1 -> ReLU or sigmoid: in bf16
     at a width a tensor map reads the implicit GEMM on wgmma of
     csrc/head_tail_sm90.cu (route ``head_tail_sm90``), in f32 and at other
     widths csrc/head_tail.cu (route ``head_tail``); as in the JAX package,
     no model serves through them. Their paths hold them against the DA models' own layers:
     ``Block.mlp_residual`` of DA-V1 ViT-L's blocks 0, 11 and 23 on the
     residual stream after each block's attention (#8), ``Head.tail`` of
     the DA-V1 and DA-V2-metric ViT-L heads on the head's own input (#9),
     at B=1 and B=8, with CUDA-event times against those composites;
  #10 XL, #11 staged and #12 the variant shootout: measurement variants of
     #1, as in the JAX package served by no model. In bf16 they run on
     #1's wgmma/TMA pipeline (csrc/flash_xl_sm90.cu, one instantiation per
     qp, pipelining and mode; csrc/flash_staged_sm90.cu;
     csrc/flash_variant_sm90.cu, one instantiation per mode); f32 on the
     FMA template of csrc/flash_variants.cuh (C entries
     csrc/flash_attention_xl.cu, flash_attention_staged.cu, flash_variant.cu). Their path is the attention sweep
     (``muggled_dpt_tpu_torch/tools/flash_tune.py``) on DA-V2 ViT-L's own
     block-11 qkv slabs across the long-N ladder, against #1, SDPA and their
     plain versions.

Phases, in order; each prints its lines and the seconds it took, and any
failure raises:
  1. device: a CUDA card, or fail; the nvidia-smi name and power limit;
  2. build: nvcc builds the kernel library from csrc/, one nvcc per source,
     all started together; the bf16 attention kernel's registers, spills and
     shared memory, unbiased and biased, the sm_90 window kernel's, with
     and without the mask, and those of each sm_90 instantiation of #10
     (qp, pipelined, mode: also its key tile and consumer registers), #11,
     #12 (each mode), #9, #8's three kernels (also their tiles, stages
     and schedule) and the int8 attention kernel of #6 and #7 (also its q
     rows per CTA and stages) (cudaFuncGetAttributes); fails if ptxas
     serialized the wgmma (C7510-C7520) of any of the eight sm_90 sources
     (the attention, window, #6/#7, #8, #9, #10, #11 and #12 kernels) or
     any of them spilled;
  3. each kernel vs its plain version at the paths' shapes and edge cases,
     float32 and bfloat16 (#1 and #2 also at N = 127-385 around the bf16
     kernel's 128-key and 192-row tiles, #2 there with a padded stack layer
     and an unpadded bias, B=8 with a (B, H, Np, Np) bias and an odd-offset
     view, scales 0.3 and -0.3 with a bias; #4 on strided views at N = 129,
     385 and 1025, B = 1 and 8; each bf16 bias check names its fill), then
     CUDA-event times of both, in turns (the window kernel at each
     SwinV2-L-384 stage shape, B=1 and B=8, beside its bound and its exp
     floor); each window check requires the kernel it expects (bf16 with
     bf16 biases: sm_90; f32 and the mixed bias: window_attention.cu);
  4. DA-V2 bf16 serves 3 requests and a batch of 8 (24 launches per forward);
  5. DA-V2 float32 kernel model vs float32 plain model;
  6. BEiT-L-512 bf16 serves 3 requests and a batch of 8 at 512x512 (24
     biased launches per forward) and one 1024x1024 request through the
     cached bias stack;
  7. BEiT-L-512 float32 kernel model vs plain model, cached and inline bias;
  8. SwinV2-L-384 bf16 serves 3 requests and a batch of 8 at 384x384 (24
     window launches per forward, every one on the sm_90 kernel) and one
     512x512 request, its CPB stack build included;
  9. SwinV2-L-384 float32 kernel model vs plain model, cached and inline
     CPB and masks;
  10. the (B, N, H, D) op path;
  11. #8 and #9 vs their plain versions (#8 at F = 384, 768, 1024 and
      100, 1297, 8 x 1297 and 1025 rows, H = 4F, and at 100 rows, F = 384,
      H = 1568, no multiple of 256; #9 at ci = 32, 64, 128, 192, at
      504x504 with B=1 and 8, 389x512, 37x52 and 392x518, ReLU and
      sigmoid), float32 and bfloat16, each bf16 #8 call held to the
      fused_mlp_sm90 route as counted and to its three kernels by name
      (mlp_ln_sm90, mlp_fc1_sm90, mlp_fc2_sm90, each once), each bf16 #9
      launch held to the route its size must take, as the wrapper counted
      it and by the kernel's name (ht_sm90 at 504x504 and 389x512,
      head_tail<bf16> at 37x52 and 392x518), then CUDA-event times of both,
      in turns, and #8's three kernels' device times from events in one
      call at B = 1 and 8;
  12. DA-V1 ViT-L bf16 serving and f32 parity as 4-5, then #8 and #9 on its
      blocks and head (bf16 serving model and f32 kernel model), each bf16
      #8 call held to its three sm_90 kernels by name; #8 on block 11 timed
      per call and as device time beside the composite, and its host cost
      per call (the JSON's ``device_ms``, ``composite_device_ms`` and
      ``host_us``);
  13. DA-V2-metric ViT-L bf16 serving (depth in (0, 1)), #9 on its head;
  14. DA-V2 ViT-Giant bf16 serving (40 launches per forward), its int8
      default tier served the same way, and f32 parity;
  15. (between 3 and 4) #6 and #7 vs their plain versions and float32
      attention, float32 and bfloat16: ragged N, all-negative logits, a
      zero q row, the lossless case, #6 at N=32897 and on views whose rows
      a tensor map cannot read (copied by the wrapper); on every case the
      kernel prologue's int8 q, int8 k and alpha equal to the plain
      prologue's (torch.equal), each call counted on the route its dtype
      must take and its three kernels named (the prologue's two and the
      route's attention kernel);
  16. (after 5) torch._int_mm on the card as the int8 tier calls it, then
      DA-V2 ViT-L's int8 tiers (default, +qkv, +qkv calibrated on 2 frames,
      +qkv+neck) served like 4 beside the dense model, each with its times
      and abs-rel against dense bf16; #6 and #7 on the int8+qkv model's qkv
      slabs (3 + 3 launches on the sm_90 routes, each call's kernels named,
      the prologue equal to the plain one on each slab); the f32 int8+qkv
      kernel model vs its plain-attention twin;
  17. (in 6 and 8) BEiT-L-512 int8+qkv+neck and SwinV2-L-384 int8 (MLP
      only): one request and one batch of 8 each, against the bf16 model;
  18. (after 5) DA-V2 ViT-L bf16 on the long-N ladder: one request at each
      of 756, 1036, 1428 and 1904 (24 launches per forward), block 11's
      qkv slab captured, ms per request; f32 parity at 1428x1428;
  19. the attention sweep on those slabs: #1 against its plain version at
      every ladder N (bf16 and f32) and on an all-negative slab; #10 in
      every sweep case and #11 at 1, 2, 4 and 8 panels on the N=10405 and
      18497 slabs and at N=700 (also at scale -0.3) and 200 (all-negative), each bf16 launch of
      #10 and #11 held to its sm_90 kernel by name (the kernel names of
      its launches, from CUPTI's callback API); #12 in every mode at
      (16, 1297, 64) and on the N=18497 slab's heads, mask_exp2 against true
      attention with every logit negative, where padfix and chunk must
      fail, each bf16 launch held to fv_sm90 by name; the sweep's path run
      once with its launches counted; its CUDA-event tables at every
      ladder N, with #11's time beside its bound and its design floor (6 B
      H N^2 D over 989 TFLOP/s: pass 2 recomputes pass 1's QK^T); #12's
      padfix at (16, 1297, 64) per launch (CUDA events around each call,
      as every kernel's time) and as device time (launches queued back to
      back behind a spin of the card: the host's cost per call left out),
      beside its plain version and SDPA timed the same ways, and the host's
      cost per call of its bf16 and f32 routes (the same wrapper, with and
      without the sm_90 route's tensor-map encodes) and of SDPA; the JSON
      line carries the per-launch times as ``ms``, ``plain_ms`` and
      ``library_ms``, and the device times and host costs beside them;
  20. (after 5, 7 and 9) introspection on each f32 kernel model, one
      request: DA-V2 ViT-L at 504x504, BEiT-L-512 at 512x512 and
      SwinV2-L-384 at 384x384, the last two with the aux cached and built
      inline. ``forward_with_internals`` (the plain attention with explicit
      float32 softmax weights, launching no kernel) against the same model's
      kernel forward (mean abs-rel, the repo's 1e-3); every block run by its
      kernel (#1, #2 or #3, 24 launches counted on the f32 route) on the
      capture's tokens before it against the capture's tokens after it
      (abs-rel per block, 1e-3; the worst printed); each block's softmax map
      of its shape, rows summing to 1 within 1e-4; unit-scale fusion and the
      head on the capture's reassembly maps against the capture's depth (max
      abs 1e-6); the bf16 capture against the bf16 kernel forward (reported);
      B=1 ms of the f32 capture forward and the kernel forward. Then the four
      analysis experiments' ``main`` on the DA-V2 ViT-L checkpoint on the
      card (fusion_scaling's default sweep, both visualizers --headless,
      depth_masking --remove_plane), each file they must write read back;
  21. (after 20 on DA-V2 ViT-L, and after 7 and 9) the apps, each through
      its ``main`` with no -d, so on the card in bfloat16, with the counts
      set to 0 before and their launches required on their route:
      run_image --headless on a 720x1280 PNG (24 launches on ``fused``; its
      ``_raw.npy`` against the facade's normalized depth of the same frame,
      max abs 1e-3; ms per request of its ``compute_depth_display``);
      run_video --headless over a synthetic 48-frame 720x1280 mp4, -sync
      with -r (frames recorded) and dispatch-ahead (frames per second,
      median inference ms, the host ms inside each dispatch, results shown;
      24 launches per dispatch); run_3dviewer's handler on 127.0.0.1 in a
      thread (/frame/0 serially and 4 at once, all equal; its lossless
      24-bit depth against the facade's, max abs 1e-5; /get-source-info,
      /export/obj, POST /upload; ms per /frame beside the inference and
      read-back alone); depth_prediction --no_display (float32); a float16
      DA-V2 model, which the attention kernel must refuse, and run_image
      -u, which must exit up front; run_video's ``AsyncResult`` gate on 6
      clip frames (alone and in back-to-back pairs) against the facade's
      forward on the default stream, max abs 0; the conversion cache
      (seconds of a plain build, a miss and a hit, the miss's and hit's
      depth equal to the plain build's); run_image on BEiT-L-512 (24
      ``fused_biased`` launches) and SwinV2-L-384 (24 ``window_sm90``).
  22. (after 21's DA-V2 apps and the conversion cache) batch extraction
      and training on DA-V2 ViT-L: run_batch's ``main`` with no -d over 20
      720x1280 PNG frames at -dp 1 --per-chip-batch 8, bf16 (exactly 3 x 24
      ``fused`` launches from inside the app, every u16 PNG and .npy read
      back; frames/s steady-state beside the facade's ms per frame at B=8;
      the .npy against the bf16 facade, reported); -f32 on 4 frames, each
      .npy against the f32 facade's inference (1e-3 mean abs-rel), and
      --eval_gt on its own outputs x 2 (abs_rel 0.0000 and delta1 1.0000;
      --eval_no_align abs_rel 0.5000 and rmse_log 0.6931); make_train_step:
      the narrow DA-V2's first step against the CPU port's (the loss and
      every gradient within 1e-3), then the f32 ViT-L at B=2, 504x504, for
      3 steps on the plain attention (no kernel launch, finite losses,
      gradients on the parameters the CPU gives them, finite, every block's
      qkv and proj non-zero; ms per step and ``device_memory_report``'s
      peak); the gradient guard (a CUDA slab that requires grad refused
      under autograd, launched under no_grad); a spawned rank in an NCCL
      group of one (BatchParallelRunner through an all-gather against the
      facade, the narrow step through the all-reduce against the
      in-process one); finetune_demo (30 steps with checkpoints,
      CONVERGED; --resume, RESUMED OK). run_batch's 72 launches join #1's.
  23. (after 22 on DA-V2 ViT-L, and after 21's BEiT and SwinV2 run_image)
      export (``experiments/export_model.py``, ``experiments/export_onnx.py``):
      ``export_forward`` of the bf16 DA-V2 ViT-L at 504x504, its graph
      holding 24 ``mdpt::flash_attention_fused_qkv`` nodes, saved and
      reloaded: one call (24 ``fused`` launches) against the live forward
      (1e-3 mean abs-rel, bit-equality printed), B=1 ms of both (host
      clock, median of 10, two turns each); the artifact loaded and run in
      a fresh process that imports only ``ops.kernels.library`` (24
      launches, against this process's call); ``export_model.main`` in
      float32 (its own check against the live f32 kernel model and its
      timing loop), the reloaded f32 program against the f32 plain model
      (1e-3); ``export_onnx.main`` (the numpy evaluator against the live
      f32 kernel model on the card, 1e-3; the artifact's MB and the
      evaluator's seconds); BEiT-L-512 at 512x512 with the bias stack
      lifted as constants and built in-graph (24 ``fused_biased`` each,
      the artifacts' MB) and SwinV2-L-384 at 384x384 (24 ``window_sm90``),
      one reloaded request each against the live forward (1e-3). The
      export launches join #1's, #2's and #3's.
  24. (last) tensor parallelism: two gloo ranks sharing the card
      (``spawn(share_card=True)``; NCCL refuses two ranks on one device),
      mesh data 1 x model 2; on each rank DA-V2 ViT-L (B=8), BEiT-L-512
      (B=1, cached stack and inline) and SwinV2-L-384 (B=1), bf16 and
      f32, each built from its checkpoint and split by
      ``BatchParallelRunner(shard_model=True)``: one forward per dtype and
      aux mode with exactly 24 launches per rank on the family's route,
      the head counts each launch saw (8 of 16; BEiT's stack 8 heads;
      SwinV2 3/6/12/24), against the same rank's whole model (the
      single-process kernel forward; f32 within 1e-3 mean abs-rel, bf16
      within twice the whole bf16 model's own mean abs-rel to the whole f32
      model on the same frames); each rank's BEiT stack half the whole one's bytes; B=1
      and B=8 times of the split model beside the whole model's (gloo
      through the host: not a tensor-parallel speed); the narrow DA-V2 (2
      heads) train step split over the ranks, its pieces joined, against
      the in-process step (1e-3). Its bf16 launches join #1's, #2's and
      #3's, printed as those at the split head counts and those of the
      whole model's reference and timing forwards.
Then one JSON line of per-kernel results (each with its bound: the larger of
the bytes it must move over 3.35 TB/s and its operations over 989 TFLOP/s
for bf16, 1979 TOP/s for int8 (#6 and #7's QK^T); #3's exp floor, one exp2
per (q, k) pair over the SFU's 3.86e12 per second, is printed beside its
times, and #6's and #7's entries carry theirs and their prologue's byte
floor; and, where one PyTorch call
computes the same function, that call's time), the card line, and last the
ok line.

Imports only torch, numpy and the port: never jax or the JAX package."""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from muggled_dpt_tpu_torch import make_depthanythingv2_dpt, run_3dviewer, run_batch, run_image, run_video
from muggled_dpt_tpu_torch.checkpoints.beit import random_original_state_dict as random_beit_state_dict
from muggled_dpt_tpu_torch.checkpoints.random_init import random_original_depth_anything_state_dict
from muggled_dpt_tpu_torch.checkpoints.swinv2 import random_original_state_dict as random_swinv2_state_dict
from muggled_dpt_tpu_torch.checkpoints.cache import cache_path_for
from muggled_dpt_tpu_torch.demo_helpers.misc import AsyncResult, depth_to_numpy
from muggled_dpt_tpu_torch.demo_helpers.postprocess import normalize_01, remove_infinities, scale_prediction
from muggled_dpt_tpu_torch.experiments import attention_visualization, block_norm_visualization, depth_masking, fusion_scaling
from muggled_dpt_tpu_torch.experiments import export_model, export_onnx
from muggled_dpt_tpu_torch.make_dpt import make_dpt_from_state_dict
from muggled_dpt_tpu_torch.models.beit_family import BEiTDPT
from muggled_dpt_tpu_torch.models.dpt_neck import fusion_forward
from muggled_dpt_tpu_torch.models.swinv2 import shift_mask, stage_grids, window_plan
from muggled_dpt_tpu_torch.models.swinv2_family import SwinV2DPT
from muggled_dpt_tpu_torch.ops.nn import patchify_embed
from muggled_dpt_tpu_torch.parallel.inference import BatchParallelRunner
from muggled_dpt_tpu_torch.parallel.mesh import rank_device, spawn
from muggled_dpt_tpu_torch.parallel.tensor import shard_model, spec_for_param
from muggled_dpt_tpu_torch.parallel.train import adamw, make_train_step
from muggled_dpt_tpu_torch.simple_examples import depth_prediction
from muggled_dpt_tpu_torch.ops import quant as tq
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_int8 as fi8
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_staged as fst
from muggled_dpt_tpu_torch.ops.kernels import flash_attention_xl as fxl
from muggled_dpt_tpu_torch.ops.kernels import fused_mlp as fm
from muggled_dpt_tpu_torch.ops.kernels import head_tail as ht
from muggled_dpt_tpu_torch.ops.kernels import window_attention as wa
from muggled_dpt_tpu_torch.tools import attn_variants as fav
from muggled_dpt_tpu_torch.tools import finetune_demo
from muggled_dpt_tpu_torch.tools import flash_tune as ft
from muggled_dpt_tpu_torch.tools import measure
from muggled_dpt_tpu_torch.utils.observability import device_memory_report

VITL = {
    "features_per_token": 1024,
    "num_blocks": 24,
    "reassembly_features_list": [256, 512, 1024, 1024],
    "fusion_channels": 256,
    "patch_size_px": 14,
    "base_patch_grid_hw": (37, 37),
}
BEIT_L512 = {  # MiDaS v3.1 dpt_beit_large_512
    "features_per_token": 1024,
    "num_blocks": 24,
    "num_heads": 16,
    "reassembly_features_list": [256, 512, 1024, 1024],
    "fusion_channels": 256,
    "patch_size_px": 16,
    "base_patch_grid_hw": (32, 32),
}
VITG = {  # Depth-Anything V2 ViT-Giant
    "features_per_token": 1536,
    "num_blocks": 40,
    "reassembly_features_list": [1536, 1536, 1536, 1536],
    "fusion_channels": 384,
    "patch_size_px": 14,
    "base_patch_grid_hw": (37, 37),
    "is_giant": True,
}
SWIN_L384 = {  # MiDaS v3.1 dpt_swin2_large_384
    "features_per_stage": [192, 384, 768, 1536],
    "heads_per_stage": [6, 12, 24, 48],
    "layers_per_stage": [2, 2, 18, 2],
    "base_patch_grid_hw": (96, 96),
    "window_size_hw": (24, 24),
    "pretrained_window_sizes_per_stage": [12, 12, 12, 6],
    "fusion_channels": 256,
    "patch_size_px": 4,
}
SWIN_SIDE, SWIN_HW, SWIN_BIG_SIDE = 384, (384, 384), 512
SWIN_BLOCKS = sum(SWIN_L384["layers_per_stage"])  # 24 window attentions per forward
SWIN_D = 32
# (windows, window, heads, shift mask) of each stage at 384x384
SWIN_STAGES = [(16, (24, 24), 6, True), (4, (24, 24), 12, True), (1, (24, 24), 24, False), (1, (12, 12), 48, False)]
HEADS, HEAD_DIM = 16, 64
FRAME_HW = (720, 1280)
MAX_SIDE, OUT_HW = 518, (504, 504)
N_TOKENS = 1 + (OUT_HW[0] // 14) * (OUT_HW[1] // 14)  # 1297
BEIT_SIDE, BEIT_HW, BEIT_BIG_SIDE = 512, (512, 512), 1024
N_BEIT = 1 + (512 // 16) ** 2  # 1025
N_ONLINE = 32897  # past the JAX package's 32768-key one-pass ceiling
SEED = 0
DEVICE = "cuda"
MLP_WIDTHS = (384, 768, 1024)  # ViT-S, B and L: F, with the hidden width 4F
MLP_ROWS = (100, N_TOKENS, 8 * N_TOKENS, N_BEIT)
MLP_ODD_HIDDEN = ((100, 384, 1568),)  # (rows, F, H): H no multiple of the GEMMs' 256-wide tiles, the bf16 route's edge
MLP_SM90_KERNELS = ("mlp_ln_sm90", "mlp_fc1_sm90", "mlp_fc2_sm90")  # one bf16 #8 call's kernels, in launch order
HEAD_CHANNELS = (32, 64, 128, 192)  # the tail's input: half of fusion 64 (ViT-S), 128 (B), 256 (L), 384 (Giant)
# (B, H, W) and the bf16 route the wrapper must count there: the sm_90 kernel where a tensor map reads the map (the DA
# serving size; 389 rows, no multiple of either unit height, and 512 columns, a whole last column block whose right
# edge box lies past W), head_tail<bf16> at widths it cannot read
HEAD_SIZES = ((1, 504, 504, "head_tail_sm90"), (8, 504, 504, "head_tail_sm90"), (1, 389, 512, "head_tail_sm90"),
              (1, 37, 52, "head_tail"), (1, 392, 518, "head_tail"))
HEAD_ROUTE_KERNEL = {"head_tail_sm90": "ht_sm90", "head_tail": "head_tail<"}  # a #9 route and its kernel, as traced
TAP_BLOCKS = (0, 11, 23)  # DA-V1 ViT-L blocks whose second half #8 is held against; int8 DA-V2 qkv slabs for #6, #7
INT8_TIERS = {  # DA-V2 ViT-L int8 serving tiers: quantize_encoder_int8 options ("calibrate": 2 frames)
    "int8": {},
    "int8+qkv": {"include_qkv": True},
    "int8+qkv calibrated": {"include_qkv": True, "calibrate": True},
    "int8+qkv+neck": {"include_qkv": True, "include_neck": True},
}
INT8_FUSED_CASES = ((1, 300), (2, N_BEIT), (8, N_TOKENS))  # #7: (B, N), 16 heads
INT8_ONLINE_CASES = ((4, 300), (32, N_BEIT), (2, N_ONLINE))  # #6: (B H, N)
TRUE_ATTN_MAX_ERR = 0.05  # int8 logits against float32 attention (tests/test_flash_int8_experiment.py:112)
LOSSLESS_MAX_ERR = 2e-4  # integer-grid q and k quantize exactly: float32 round-off only
LADDER = ft.LADDER  # DA-V2 ViT-L max side -> tokens: 756 -> 2917, 1036 -> 5477, 1428 -> 10405, 1904 -> 18497
LADDER_PARITY_SIDE = 1428  # the f32 kernel model against the f32 plain model at N=10405
SWEEP_CHECK_N = (10405, 18497)  # #10 and #11 held on these slabs; #12 on the last one's heads
ALL_NEGATIVE_MAX_ERR = 2e-4  # f32 mask_exp2 against true attention with every logit far below 0 (the JAX tests' gate)
EXPECTED_FAILURE = 0.5  # padfix and chunk must miss true attention by more than this in the all-negative case

# tolerances of the kernel against its plain version on the same inputs
F32_MAX_ERR = 1e-4  # f32 FMAs in another summation order
BF16_MAX_ERR, BF16_MEAN_ERR = 2e-2, 2e-3  # p rounded to bf16 before PV, bf16 output
ABS_REL_BUDGET = 1e-3  # whole-model f32 budget of the repo
ROW_SUM_TOL = 1e-4  # a captured f32 softmax row against 1
UNIT_FUSION_MAX_ABS = 1e-6  # fusion at unit scales + head against the capture's own depth: the same ops
# #8 and #9, whose outputs are not bounded as attention's are: relative to the
# reference's largest magnitude (max) and mean magnitude (mean)
F32_REL_ERR = 1e-4  # f32 sums in another order
BF16_REL_MAX, BF16_REL_MEAN = 1.6e-2, 2e-3  # same rounding points: two bf16 ulps at the top, rare flips
# against the model's own bf16 composite, which also rounds fc1's output,
# fc2's output, the LayerScale product (#8) and the conv output (#9) to bf16
COMPOSITE_BF16_REL_MAX, COMPOSITE_BF16_REL_MEAN = 5e-2, 1e-2

# H100 SXM peaks for the bound: dense bf16 tensor cores, f32 FMA, HBM (int8: flash_attention_int8.int8_bound)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
WINDOW_SM90 = "window_attention_sm90.cu"
SM90_SOURCES = ("flash_attention_sm90.cu", WINDOW_SM90, "head_tail_sm90.cu", "flash_xl_sm90.cu", "flash_staged_sm90.cu",
                "flash_variant_sm90.cu", "fused_mlp_sm90.cu", "flash_attention_int8_sm90.cu")  # ptxas: no wgmma serialized, no spill
SM90_KERNEL = {9: "ht_sm90", 10: "fxl_sm90", 11: "fst_sm90", 12: "fv_sm90"}  # sm_90 kernels' names, as launches show them
FV_MODES = ("MASK", "PADFIX", "NOSM", "EXPONLY", "MAXONLY")  # csrc/flash_variant_sm90.cu's FvMode, in order

REPLACES = {
    1: "muggled_dpt_tpu/ops/pallas/flash_attention.py:125",
    2: "muggled_dpt_tpu/ops/pallas/flash_attention.py:434",
    3: "muggled_dpt_tpu/ops/pallas/window_attention.py:31",
    4: "muggled_dpt_tpu/ops/pallas/flash_attention.py:86",
    5: "muggled_dpt_tpu/ops/pallas/flash_attention.py:497",
    6: "experiments/flash_attention_int8.py:44",
    7: "experiments/flash_attention_int8.py:175",
    8: "experiments/pallas_fused_mlp.py:59",
    9: "experiments/pallas_head_conv.py:52",
    10: "experiments/flash_attention_xl.py:69",
    11: "experiments/flash_attention_staged.py:74",
    12: "tools/attn_variants.py:77",
}
NAMES = {
    1: "flash_attention_fused_qkv",
    2: "flash_attention_fused_qkv (bias, bias_stack + layer)",
    3: "window_attention (factored CPB bias + shift mask)",
    4: "flash_attention (B, N, H, D)",
    5: "flash_attention (B, N, H, D), past 32768 keys",
    6: "flash_attention_int8_qk ((B H, N, D), int8 QK^T, key-blocked)",
    7: "flash_attention_int8_qk_fused (head-major qkv slab, int8 QK^T, one pass)",
    8: "fused_ln_mlp_residual (LayerNorm -> fc1 -> GELU -> fc2 -> LayerScale residual)",
    9: "fused_head_tail (3x3 conv -> ReLU -> 1x1 conv -> ReLU or sigmoid)",
    10: "flash_attention_fused_qkv_xl (qp q blocks per CTA, next tile's QK^T pipelined; qp=1 pipelined)",
    11: "flash_attention_fused_qkv_staged (row max by key panel, then exp2 and PV; panels=2)",
    12: "flash_variant (pre-scaled (BH, N, D); mode padfix, the JAX default)",
}
SOURCES = {1: "flash_attention_sm90", 2: "flash_attention_sm90", 3: "window_attention_sm90", 4: "flash_attention_sm90",
           5: "flash_attention_sm90", 6: "flash_attention_int8_sm90", 7: "flash_attention_int8_sm90", 8: "fused_mlp_sm90",
           9: "head_tail_sm90", 10: "flash_xl_sm90", 11: "flash_staged_sm90", 12: "flash_variant_sm90"}
SERVED = {}  # what -> (ms per request at B=1, ms per frame at B=8), filled by serve()
# the kernel route (as launch_counts names it) of each (dtype, enable_cache): SwinV2's inline CPB is float32, and bf16
# q, k, v with a float32 bias take the route "window"
DA_ROUTES = {(dtype, True): "fused" for dtype in (torch.float32, torch.bfloat16)}
BEIT_ROUTES = {(dtype, cache): "fused_biased" for dtype in (torch.float32, torch.bfloat16) for cache in (True, False)}
SWIN_ROUTES = {(torch.float32, True): "window", (torch.float32, False): "window", (torch.bfloat16, True): "window_sm90",
               (torch.bfloat16, False): "window"}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = card_line()
    print(smi, flush=True)
    return smi


def phase_build():
    from muggled_dpt_tpu_torch.ops.kernels._build import build_library, kernel_library, ptxas_report

    logs = {}
    path = build_library(verbose=True, logs=logs)
    for bias, what in ((0, "BIAS_NONE"), (1, "BIAS_BF16")):
        info = (ctypes.c_int * 5)()
        err = kernel_library().mdpt_flash_attention_sm90_info(bias, info)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes of the bf16 attention kernel ({what}) failed: CUDA error {err}")
        regs, spill, static_smem, dynamic_smem, threads = info
        print(f"build: {path.name}; csrc/flash_attention_sm90.cu fa_sm90_bf16<{what}>: {regs} registers per thread at "
              f"launch (setmaxnreg: producer 32, consumers 160), {spill} B local memory per thread, {static_smem} B static + "
              f"{dynamic_smem} B dynamic shared memory, {threads} threads", flush=True)
    for mask, what in ((0, "no mask"), (1, "MASK")):
        info = (ctypes.c_int * 5)()
        err = kernel_library().mdpt_window_attention_sm90_info(mask, info)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes of the sm_90 window kernel ({what}) failed: CUDA error {err}")
        regs, spill, static_smem, dynamic_smem, threads = info
        print(f"build: csrc/{WINDOW_SM90} wa_sm90_bf16<{what}>: {regs} registers per thread at launch (setmaxnreg: "
              f"producer 32, consumers 160), {spill} B local memory per thread, {static_smem} B static + {dynamic_smem} B "
              f"dynamic shared memory, {threads} threads", flush=True)
    sm90_variants = [(f"fxl_sm90<qp={qp}, pipelined={pipelined}, {'ablate' if ablate else 'flash'}>",
                      lambda info, qp=qp, pipelined=pipelined, ablate=ablate:
                      kernel_library().mdpt_flash_xl_sm90_info(qp, pipelined, ablate, info))
                     for qp in (1, 2, 4) for pipelined in (0, 1) for ablate in (0, 1)]
    sm90_variants += [(f"fst_sm90<NEG={neg}>", lambda info, neg=neg: kernel_library().mdpt_flash_staged_sm90_info(neg, info))
                      for neg in (0, 1)]
    sm90_variants += [(f"fv_sm90<{name}>", lambda info, mode=mode: kernel_library().mdpt_flash_variant_sm90_info(mode, info))
                      for mode, name in enumerate(FV_MODES)]
    for what, query in sm90_variants:
        info = (ctypes.c_int * 7)()
        err = query(info)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes of {what} failed: CUDA error {err}")
        regs, spill, static_smem, dynamic_smem, threads, keys, consumer_regs = info
        print(f"build: {what}: {regs} registers per thread at launch (setmaxnreg: consumers {consumer_regs}), {spill} B "
              f"local memory per thread, {static_smem} B static + {dynamic_smem} B dynamic shared memory, {threads} "
              f"threads, {keys}-key tiles", flush=True)
    for rows, channels in ((8, 128), (6, 192)):
        info = (ctypes.c_int * 7)()
        err = kernel_library().mdpt_head_tail_sm90_info(rows, info)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes of ht_sm90<{rows}> failed: CUDA error {err}")
        regs, spill, static_smem, dynamic_smem, threads, rows, stages = info
        print(f"build: csrc/head_tail_sm90.cu ht_sm90<{rows}>: {regs} registers per thread, {spill} B local memory per "
              f"thread, {static_smem} B static + {dynamic_smem} B dynamic shared memory at ci={channels}, {threads} "
              f"threads, {rows} output rows per unit, {stages} TMA stages", flush=True)
    for kernel, name in enumerate(MLP_SM90_KERNELS):
        info = (ctypes.c_int * 9)()
        err = kernel_library().mdpt_fused_mlp_sm90_info(kernel, info)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes of {name} failed: CUDA error {err}")
        regs, spill, static_smem, dynamic_smem, threads, tile_m, tile_n, stages, pingpong = info
        shape = (f"{tile_m} rows per CTA, one warp each, F up to {tile_n}" if kernel == 0 else
                 f"{tile_m} x {tile_n} tiles, {stages} TMA stages, {'ping-pong' if pingpong else 'cooperative'} consumers "
                 f"(setmaxnreg: producer 40, consumers 232)")
        print(f"build: csrc/fused_mlp_sm90.cu {name}: {regs} registers per thread at launch, {spill} B local memory per "
              f"thread, {static_smem} B static + {dynamic_smem} B dynamic shared memory, {threads} threads, {shape}",
              flush=True)
    info = (ctypes.c_int * 8)()
    err = kernel_library().mdpt_flash_attention_int8_sm90_info(info)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes of fa_i8_sm90 failed: CUDA error {err}")
    regs, spill, static_smem, dynamic_smem, threads, rows, stages, consumer_regs = info
    print(f"build: csrc/flash_attention_int8_sm90.cu fa_i8_sm90: {regs} registers per thread at launch (setmaxnreg: "
          f"consumers {consumer_regs}), {spill} B local memory per thread, {static_smem} B static + {dynamic_smem} B dynamic "
          f"shared memory, {threads} threads, {rows} q rows per CTA, {stages} K/V stages", flush=True)
    for source in SM90_SOURCES:
        report = logs.get(source) or ptxas_report(source)  # the library may have been built before
        serialized = sorted(set(re.findall(r"C75(?:1\d|20)\)?[^\n]*", report)))
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)]
        if serialized or any(spills):
            raise RuntimeError(f"ptxas on csrc/{source}: wgmma serialization {serialized}, spill bytes {spills}")
        print(f"build: ptxas reports no wgmma serialization (C7510-C7520) and no spills for csrc/{source}", flush=True)


def make_qkv(rng, b, n, dtype, all_negative=False):
    """Head-major (B, N, 3C) qkv on the card, drawn with numpy. all_negative
    makes every logit strongly negative: q = -8|x|, k = |y|."""
    heads = HEADS
    x = rng.standard_normal((b, n, heads, 3, HEAD_DIM), dtype=np.float32)
    if all_negative:
        x[..., 0, :] = -8.0 * np.abs(x[..., 0, :])
        x[..., 1, :] = np.abs(x[..., 1, :])
    return torch.from_numpy(x.reshape(b, n, 3 * heads * HEAD_DIM)).to(DEVICE, dtype)


def make_bias(rng, shape, dtype, scale=1.0, shift=0.0):
    x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale) + np.float32(shift)
    return torch.from_numpy(x).to(DEVICE, dtype)


def padded_stack(rng, layers, n, dtype):
    """A (L, H, Np, Np) bias stack, Np = N rounded up to 8 (the cached
    stack's layout), with 1e6 in every pad: the kernel must never read it."""
    n_pad = (n + 7) // 8 * 8
    stack = make_bias(rng, (layers, HEADS, n_pad, n_pad), dtype)
    stack[..., n:, :] = 1e6
    stack[..., :, n:] = 1e6
    return stack


def fill_name(bias=None, bias_stack=None, layer=None, b=1, n=1) -> str:
    """" [tma]" or " [copy]": how the bf16 kernel fills its bias tiles for a
    bf16 bias given so; "" for a float32 one."""
    t = bias if bias_stack is None else bias_stack
    if t.dtype != torch.bfloat16:
        return ""
    operand = fa._bias_operand(bias, bias_stack, layer, b, HEADS, n, t.device)
    return " [tma]" if fa.bias_fill(operand) == fa.BIAS_FILL_TMA else " [copy]"


def timed_pair(smi, what, kernel, plain, library=None, iters=30, warmup=5):
    """CUDA-event times of a kernel and its plain version, in turns (plain,
    kernel, kernel, plain), then of ``library`` (one PyTorch call that
    computes the same function, or None). Prints them; returns the faster of
    each pair and the library time: (ms, plain_ms, library_ms)."""
    p1, k1, k2, p2 = (time_ms(f, iters, warmup) for f in (plain, kernel, kernel, plain))
    lib = None if library is None else time_ms(library, iters, warmup)
    extra = "" if lib is None else f", library call {lib:.4f} ms"
    print(f"kernel time {what}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms{extra} [{smi}]", flush=True)
    return min(k1, k2), min(p1, p2), lib


def device_pair(smi, what, kernel, plain, library=None):
    """Device times (``flash_tune.device_ms``) of a kernel and its plain
    version, in turns (plain, kernel, kernel, plain), then of ``library``;
    printed and returned as ``timed_pair`` returns its times."""
    p1, k1, k2, p2 = (ft.device_ms(f) for f in (plain, kernel, kernel, plain))
    lib = None if library is None else ft.device_ms(library)
    extra = "" if lib is None else f", library call {lib:.4f} ms"
    print(f"kernel time {what}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms{extra} (20 launches queued "
          f"behind a spin, after 3) [{smi}]", flush=True)
    return min(k1, k2), min(p1, p2), lib


def host_pair(smi, what, fns: dict, rounds: int = 5) -> list:
    """Host microseconds per call of each of ``fns`` (``flash_tune.host_us``:
    200 calls queued behind a spin of the card), in ``rounds`` rounds, the
    order reversed every other round (``measure.interleaved``); prints and
    returns each median."""
    readings = measure.interleaved(fns, ft.host_us, rounds)
    medians = [statistics.median(readings[label]) for label in fns]
    print(f"host us per call, {what} (200 calls queued behind a spin, median of {rounds} rounds): "
          + ", ".join(f"{label} {us:.1f}" for label, us in zip(fns, medians)) + f" [{smi}]", flush=True)
    return medians


def window_sdpa_inputs(q, k, v, cpb, mask):
    """The window attention as one SDPA call takes it: (B nW, H, A, D)
    copies of q, k and v and the (B nW, H, A, A) sum of cpb and mask."""
    b, nw, a, h, d = q.shape
    q4, k4, v4 = (t.permute(0, 1, 3, 2, 4).reshape(b * nw, h, a, d) for t in (q, k, v))
    bias = cpb[None].expand(nw, h, a, a) if mask is None else cpb[None] + mask[:, None]
    return q4, k4, v4, bias.to(q.dtype)[None].expand(b, nw, h, a, a).reshape(b * nw, h, a, a)


def time_ms(fn, iters=30, warmup=5) -> float:
    """Median of per-launch CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Checker:
    """Holds each kernel against its plain version and keeps each TPU
    kernel's worst error. ``relative``: the #8 / #9 gates, relative to the
    reference's magnitude; ``composite``: the reference is the model's own
    bf16 layer, not the plain version (gated, not kept as the worst)."""

    def __init__(self):
        self.worst = {kid: 0.0 for kid in NAMES}

    def __call__(self, kid, label, got, ref, shape, relative=False, composite=False, versus=None):
        torch.cuda.synchronize()
        got, ref = got.float(), ref.float()
        err = (got - ref).abs()
        max_err, mean_err = float(err.max()), float(err.mean())
        ok = bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(shape)
        f32 = label.startswith("float32")
        if relative:
            top, mean_ref = float(ref.abs().max()), float(ref.abs().mean())
            tol_max, tol_mean = ((F32_REL_ERR, F32_REL_ERR) if f32 else
                                 (COMPOSITE_BF16_REL_MAX, COMPOSITE_BF16_REL_MEAN) if composite else (BF16_REL_MAX, BF16_REL_MEAN))
            ok = ok and max_err <= tol_max * top and mean_err <= tol_mean * mean_ref
            scale = f" (max|ref|={top:.3e}, mean|ref|={mean_ref:.3e})"
        else:
            ok = ok and (max_err <= F32_MAX_ERR if f32 else max_err <= BF16_MAX_ERR and mean_err <= BF16_MEAN_ERR)
            scale = ""
        what = versus or ("the model's composite" if composite else "its plain version")
        vs = f" vs {versus}" if versus else " vs composite" if composite else ""
        print(f"kernel check #{kid} {label}{vs}: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e}{scale}", flush=True)
        if not ok:
            raise RuntimeError(f"kernel #{kid} disagrees with {what} at {label}")
        if not (composite or versus):
            self.worst[kid] = max(self.worst[kid], max_err)


def make_windows(rng, b, nw, window_hw, h, dtype, bias_dtype, with_mask, views=False):
    """Window attention inputs as the SwinV2 block hands them over, drawn
    with numpy: q l2-normalized times a logit scale of 10, k l2-normalized,
    v N(0, 1) clipped to +-3.5, each (B, nW, A, H, 32), A = the window's
    area (``views``: strided views of one (B, nW, A, 3, H, 32) qkv); cpb =
    16 * sigmoid(N(0, 1)) (H, A, A); the (nW, A, A) shift mask of a square
    grid of nW windows rolled by half a window, as the model builds it.
    An output is a convex combination of v's rows, so the clip keeps it
    below 4, where one bf16 ulp (1.6e-2) fits the bf16 gate; at [4, 8) one
    ulp is 3.1e-2, which the kernel, rounding p before normalizing, may
    differ by."""
    a = window_hw[0] * window_hw[1]
    qkv = torch.from_numpy(rng.standard_normal((b, nw, a, 3, h, SWIN_D), dtype=np.float32)).to(DEVICE)
    qkv[:, :, :, 2].clamp_(-3.5, 3.5)
    norm = torch.rsqrt((qkv[:, :, :, :2] ** 2).sum(-1, keepdim=True) + 1e-12)
    qkv[:, :, :, :2] *= norm
    qkv[:, :, :, 0] *= 10.0
    qkv = qkv.to(dtype)
    q, k, v = qkv.unbind(3) if views else (t.contiguous() for t in qkv.unbind(3))
    cpb = (16.0 * torch.sigmoid(torch.from_numpy(rng.standard_normal((h, a, a), dtype=np.float32)))).to(DEVICE, bias_dtype)
    mask = None
    if with_mask:
        side = math.isqrt(nw)
        grid = (side * window_hw[0], side * window_hw[1])
        mask = shift_mask(grid, window_hw, (window_hw[0] // 2, window_hw[1] // 2), DEVICE, bias_dtype)
    return q, k, v, cpb, mask


def check_windows(check, rng, dtype, b, nw, window_hw, h, with_mask, bias_dtype=None, views=False):
    """#3 against its plain version, on the kernel the inputs must reach:
    the sm_90 kernel for bf16 with bf16 biases, window_attention.cu else."""
    bias_dtype = bias_dtype or dtype
    args = make_windows(rng, b, nw, window_hw, h, dtype, bias_dtype, with_mask, views)
    a = window_hw[0] * window_hw[1]
    route = "window_sm90" if dtype == bias_dtype == torch.bfloat16 else "window"
    label = (f"{str(dtype)[6:]} B={b} nW={nw} A={a} H={h}{' mask' if with_mask else ''} bias {str(bias_dtype)[6:]}"
             f"{' strided views of one qkv' if views else ''} [{route}]")
    got = _counted(lambda: wa.window_attention(*args), route, 1, f"#3 {label}")
    check(3, label, got, wa.window_attention_reference(*args), (b, nw, a, h, SWIN_D))


def _split(qkv):
    x = qkv.unflatten(2, (HEADS, 3, HEAD_DIM))
    return x[..., 0, :], x[..., 1, :], x[..., 2, :]


def phase_kernel(smi: str) -> dict:
    """Kernel vs plain version, then times. Returns {kernel id: numbers}."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true f32
    rng = np.random.default_rng(SEED)
    check = Checker()
    device_before = torch.cuda.current_device()
    layers = BEIT_L512["num_blocks"]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        # #1: unbiased fused, the DA shapes and edge cases; N = 127-257 straddle
        # the bf16 kernel's 128-key K/V tiles, N = 191-385 its 192-row q tiles
        for b, n, neg, scale in [(1, N_TOKENS, False, None), (8, N_TOKENS, False, None), (1, 1, False, None),
                                 (1, 63, False, None), (1, 65, False, None), (2, 200, False, None),
                                 (2, 200, False, 0.3), (2, 200, False, -0.3), (2, 200, True, None), (1, N_TOKENS, True, None),
                                 (2, 127, False, None), (1, 128, False, None), (2, 129, False, None),
                                 (1, 255, False, None), (2, 257, True, None), (1, 191, False, None), (2, 192, False, None),
                                 (1, 193, False, None), (2, 385, False, None)]:
            qkv = make_qkv(rng, b, n, dtype, neg)
            label = f"{name} B={b} N={n}{' all-negative' if neg else ''}{f' scale={scale}' if scale else ''}"
            got = fa.flash_attention_fused_qkv(qkv, HEADS, scale=scale)
            check(1, label, got, fa.flash_attention_fused_qkv_reference(qkv, HEADS, scale=scale), (b, n, HEADS * HEAD_DIM))
        # #2: biased fused at BEiT-L-512's N, every bias source
        n = N_BEIT
        stack = padded_stack(rng, layers, n, dtype)
        for b in (1, 8):
            qkv = make_qkv(rng, b, n, dtype)
            sources = {
                "(1,H,N,N)": {"bias": make_bias(rng, (1, HEADS, n, n), dtype)},
                "(B,H,N,N)": {"bias": make_bias(rng, (b, HEADS, n, n), dtype)},
                "(1,1,1,N)": {"bias": make_bias(rng, (1, 1, 1, n), dtype, scale=4.0)},
                "(1,1,N,1)": {"bias": make_bias(rng, (1, 1, n, 1), dtype, scale=4.0)},
                f"(1,H,N,N) {str(other)[6:]}": {"bias": make_bias(rng, (1, HEADS, n, n), other)},
                "stack layer 0, pads 1e6": {"bias_stack": stack, "layer": 0},
                f"stack layer 1 {str(other)[6:]}, pads 1e6": {"bias_stack": padded_stack(rng, 2, n, other), "layer": 1},
                f"stack layer {layers - 1}, pads 1e6": {"bias_stack": stack, "layer": layers - 1},
            }
            for src, kw in sources.items():
                got = fa.flash_attention_fused_qkv(qkv, HEADS, **kw)
                ref = fa.flash_attention_fused_qkv_reference(qkv, HEADS, **kw)
                check(2, f"{name} B={b} N={n} bias {src}{fill_name(**kw, b=b, n=n)}", got, ref, (b, n, HEADS * HEAD_DIM))
        del stack
        for n in (1, 63, 65, 577, 4097):
            qkv, bias = make_qkv(rng, 1, n, dtype), make_bias(rng, (1, HEADS, n, n), dtype)
            got = fa.flash_attention_fused_qkv(qkv, HEADS, bias=bias)
            check(2, f"{name} B=1 N={n} bias (1,H,N,N)", got, fa.flash_attention_fused_qkv_reference(qkv, HEADS, bias=bias),
                  (1, n, HEADS * HEAD_DIM))
        qkv, bias = make_qkv(rng, 2, N_BEIT, dtype, all_negative=True), make_bias(rng, (1, HEADS, N_BEIT, N_BEIT), dtype, 0.1, -50.0)
        got = fa.flash_attention_fused_qkv(qkv, HEADS, bias=bias)
        check(2, f"{name} B=2 N={N_BEIT} all-negative, bias ~ -50", got,
              fa.flash_attention_fused_qkv_reference(qkv, HEADS, bias=bias), (2, N_BEIT, HEADS * HEAD_DIM))
        # #2 at the bf16 kernel's edges (N = 127-257 straddle its 128-key
        # tiles, 191-385 its 192-row q tiles), each with a padded stack layer
        # (TMA fill) and an unpadded bias (copy fill); B=8 with a padded
        # (B, H, Np, Np) bias (TMA over the batch dim); a view at an odd
        # offset into a padded layer (copy, pads 1e6 never read); scales
        # 0.3 and -0.3 with a bias
        for b, n in ((2, 127), (1, 128), (2, 129), (1, 191), (2, 192), (1, 193), (2, 257), (1, 385)):
            qkv, stack = make_qkv(rng, b, n, dtype), padded_stack(rng, 2, n, dtype)
            sources = {"stack layer 1, pads 1e6": {"bias_stack": stack, "layer": 1},
                       "(1,H,N,N) unpadded": {"bias": make_bias(rng, (1, HEADS, n, n), dtype)}}
            for src, kw in sources.items():
                got = fa.flash_attention_fused_qkv(qkv, HEADS, **kw)
                ref = fa.flash_attention_fused_qkv_reference(qkv, HEADS, **kw)
                check(2, f"{name} B={b} N={n} bias {src}{fill_name(**kw, b=b, n=n)}", got, ref, (b, n, HEADS * HEAD_DIM))
        n = 385
        qkv = make_qkv(rng, 8, n, dtype)
        padded = padded_stack(rng, 9, n, dtype)[1:, :, :, :]  # (B, H, Np, Np), batch stride H Np^2
        odd = padded_stack(rng, 1, n + 1, dtype)[:, :, 1:, 1:]  # (1, H, N + 7, N + 7) at an odd element offset
        for src, kw in {"(B,H,Np,Np) pads 1e6": {"bias": padded},
                        "(1,H,Np,Np) view at an odd offset, pads 1e6": {"bias": odd}}.items():
            got = fa.flash_attention_fused_qkv(qkv, HEADS, **kw)
            ref = fa.flash_attention_fused_qkv_reference(qkv, HEADS, **kw)
            check(2, f"{name} B=8 N={n} bias {src}{fill_name(**kw, b=8, n=n)}", got, ref, (8, n, HEADS * HEAD_DIM))
        q, k, v = _split(qkv)
        for kw in ({"bias": padded}, {"bias": padded[:1]}, {"bias": odd}):
            label = f"{name} B=8 N={n} strided views bias {tuple(kw['bias'].shape)}{fill_name(**kw, b=8, n=n)}"
            check(4, label, fa.flash_attention(q, k, v, **kw), fa.flash_attention_reference(q, k, v, **kw), (8, n, HEADS, HEAD_DIM))
        qkv = make_qkv(rng, 2, n, dtype)
        for scale in (0.3, -0.3):
            kw = {"bias_stack": padded, "layer": 0}
            got = fa.flash_attention_fused_qkv(qkv, HEADS, scale=scale, **kw)
            ref = fa.flash_attention_fused_qkv_reference(qkv, HEADS, scale=scale, **kw)
            check(2, f"{name} B=2 N={n} bias stack layer 0 scale={scale}{fill_name(**kw, b=2, n=n)}", got, ref,
                  (2, n, HEADS * HEAD_DIM))
        del padded, odd
        # #4: the (B, N, H, D) entry, contiguous and strided views of one qkv
        # (unbiased bf16: the tensor maps take the views' own strides)
        for b in (1, 8):
            for n in (129, N_BEIT):
                qkv = make_qkv(rng, b, n, dtype)
                bias = make_bias(rng, (1, HEADS, n, n), dtype)
                views = {"strided views of one qkv": _split(qkv), "contiguous": tuple(t.contiguous() for t in _split(qkv))}
                for kind, (q, k, v) in views.items():
                    for bias_kw in ({}, {"bias": bias}):
                        got = fa.flash_attention(q, k, v, **bias_kw)
                        ref = fa.flash_attention_reference(q, k, v, **bias_kw)
                        label = f"{name} B={b} N={n} {kind}{' bias (1,H,N,N)' if bias_kw else ''}"
                        check(4, label, got, ref, (b, n, HEADS, HEAD_DIM))
        # #5: unbiased past 32768 keys
        q, k, v = (make_bias(rng, (1, N_ONLINE, 2, HEAD_DIM), dtype) for _ in range(3))
        check(5, f"{name} B=1 N={N_ONLINE} H=2", fa.flash_attention(q, k, v), fa.flash_attention_reference(q, k, v),
              (1, N_ONLINE, 2, HEAD_DIM))
        del q, k, v
        # #3: the SwinV2-L-384 stage shapes, the 512x512 ones (A=1024), the
        # divisor search's largest window (A=2209), ragged and odd areas,
        # strided views, a bias in the other dtype
        for b in (1, 8):
            for nw, window_hw, h, with_mask in SWIN_STAGES:
                check_windows(check, rng, dtype, b, nw, window_hw, h, with_mask)
        for nw, h in ((16, 6), (4, 12)):
            check_windows(check, rng, dtype, 1, nw, (32, 32), h, True)
        check_windows(check, rng, dtype, 1, 1, (47, 47), 2, False)
        for window_hw in ((4, 4), (5, 5), (6, 6), (10, 15)):  # A = 16, 25, 36, 150
            check_windows(check, rng, dtype, 2, 4, window_hw, 3, True)
        check_windows(check, rng, dtype, 2, 4, (24, 24), 3, True, views=True)
        check_windows(check, rng, dtype, 2, 4, (10, 15), 3, True, bias_dtype=other)
        torch.cuda.empty_cache()
    if torch.cuda.current_device() != device_before:
        raise RuntimeError("a kernel launch changed the current CUDA device")
    print(f"current device unchanged by the launches: cuda:{device_before}", flush=True)

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        stack = padded_stack(rng, layers, N_BEIT, dtype)
        for b in (1, 8):
            qkv_da, qkv = make_qkv(rng, b, N_TOKENS, dtype), make_qkv(rng, b, N_BEIT, dtype)
            q, k, v = _split(qkv)
            bias = stack[layers - 1][None]  # a (1, H, Np, Np) layer of the padded stack, as BEiT hands it over
            last = {"bias_stack": stack, "layer": layers - 1}
            mask = stack[layers - 1][None, :, :N_BEIT, :N_BEIT]  # the same layer as the SDPA mask
            sdpa_da = [t.transpose(1, 2) for t in _split(qkv_da)]
            sdpa_beit = [t.transpose(1, 2) for t in (q, k, v)]
            pairs = {
                (1, f"fused N={N_TOKENS}"): (lambda: fa.flash_attention_fused_qkv(qkv_da, HEADS),
                                             lambda: fa.flash_attention_fused_qkv_reference(qkv_da, HEADS),
                                             lambda: F.scaled_dot_product_attention(*sdpa_da)),
                (2, f"fused N={N_BEIT} stack layer {layers - 1}"): (
                    lambda: fa.flash_attention_fused_qkv(qkv, HEADS, **last),
                    lambda: fa.flash_attention_fused_qkv_reference(qkv, HEADS, **last),
                    lambda: F.scaled_dot_product_attention(*sdpa_beit, attn_mask=mask)),
                (4, f"(B,N,H,D) views N={N_BEIT} bias (1,H,Np,Np) stack layer"): (
                    lambda: fa.flash_attention(q, k, v, bias=bias), lambda: fa.flash_attention_reference(q, k, v, bias=bias),
                    lambda: F.scaled_dot_product_attention(*sdpa_beit, attn_mask=mask)),
            }
            for (kid, what), (kernel, plain, library) in pairs.items():
                times[(kid, dtype, b)] = timed_pair(smi, f"#{kid} {name} B={b} {what} H={HEADS} D={HEAD_DIM}", kernel, plain,
                                                    library)
        del stack
        q, k, v = (make_bias(rng, (1, N_ONLINE, 2, HEAD_DIM), dtype) for _ in range(3))
        kernel, plain = (lambda: fa.flash_attention(q, k, v)), (lambda: fa.flash_attention_reference(q, k, v))
        library = lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))  # noqa: E731
        times[(5, dtype, 1)] = timed_pair(smi, f"#5 {name} B=1 N={N_ONLINE} H=2 D={HEAD_DIM}", kernel, plain, library,
                                          iters=5, warmup=1)
        del q, k, v
        # #3 at each SwinV2-L-384 stage shape, the bias in the model's dtype
        for b in (1, 8):
            for s, (nw, window_hw, h, with_mask) in enumerate(SWIN_STAGES, start=1):
                a = window_hw[0] * window_hw[1]
                args = make_windows(rng, b, nw, window_hw, h, dtype, dtype, with_mask, views=True)
                kernel, plain = (lambda: wa.window_attention(*args)), (lambda: wa.window_attention_reference(*args))
                sdpa_args = window_sdpa_inputs(*args)  # contiguous (B nW, H, A, D) and the summed bias, built untimed
                library = lambda: F.scaled_dot_product_attention(*sdpa_args[:3], attn_mask=sdpa_args[3], scale=1.0)  # noqa: E731
                what = f"#3 {name} B={b} stage {s} nW={nw} A={a} H={h} D={SWIN_D}{' mask' if with_mask else ''}"
                times[(3, dtype, b, s)] = timed_pair(smi, what, kernel, plain, library)
                limit = wa.window_bound(b, nw, a, h, with_mask)
                print(f"{what}: bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}), exp floor {limit['exp_floor_ms']:.4f} ms, "
                      f"kernel / exp floor {times[(3, dtype, b, s)][0] / limit['exp_floor_ms']:.2f}x [{smi}]", flush=True)
                del args, sdpa_args
        torch.cuda.empty_cache()
    # the JSON line carries the bf16 serving shape of each kernel (#3: stage 1, the most windows)
    at = {1: (8,), 2: (8,), 3: (8, 1), 4: (8,), 5: (1,)}
    return {kid: {"max_abs_err": check.worst[kid], **dict(zip(("ms", "plain_ms", "library_ms"), times[(kid, torch.bfloat16, *key)]))}
            for kid, key in at.items()}


def _abs_rel(ours: torch.Tensor, ref: torch.Tensor) -> float:
    return float((ours.float() - ref.float()).abs().mean() / (ref.float().abs().mean() + 1e-12))


def _check_depth(depth, shape, what):
    if tuple(depth.shape) != shape or not bool(torch.isfinite(depth).all()):
        raise RuntimeError(f"{what}: got shape {tuple(depth.shape)} (want {shape}), finite={bool(torch.isfinite(depth).all())}")


def _host_ms(fn, iters=10, warmup=3) -> float:
    """Median host-clock time of fn (which ends in a synchronize), in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _counted(fn, route, want, what):
    """Run fn, require exactly `want` launches on `route` and none on the others."""
    before = fa.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = fa.launch_counts()
    delta = {r: after[r] - before[r] for r in after}
    if delta != {r: (want if r == route else 0) for r in delta}:
        raise RuntimeError(f"{what}: launches {delta}, want {want} on route {route!r} only")
    return out


def serve(smi, model, side, out_hw, route, blocks, what) -> torch.Tensor:
    """bf16 serving through the public entry points: 3 requests through
    ``inference`` and one batch of 8 frames through ``inference_rgb_device``.
    Returns the first request's depth."""
    rng = np.random.default_rng(SEED + 1)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(6)]
    first = None
    for i in range(3):
        depth = _counted(lambda: model.inference(frames[i], side), route, blocks, f"{what} request {i}")
        _check_depth(depth, (1, *out_hw), f"{what} request {i}")
        first = depth if first is None else first
    hw = model.compute_scaled_hw(FRAME_HW, side)
    stack = torch.from_numpy(np.stack(frames + [frames[0], frames[3]])).to(DEVICE)  # rows 6, 7 repeat rows 0, 3
    batch = _counted(lambda: model.inference_rgb_device(stack, hw), route, blocks, f"{what} batch of 8")
    _check_depth(batch, (8, *out_hw), f"{what} batch of 8")
    if not (torch.equal(batch[6], batch[0]) and torch.equal(batch[7], batch[3])):
        raise RuntimeError(f"{what} batch: duplicate frames gave different depth")
    print(f"{what} bf16: 3 requests -> {(1, *out_hw)}, batch -> {(8, *out_hw)}, {blocks} {route} launches per forward, "
          "duplicates bit-equal", flush=True)

    def per_request():
        model.inference(frames[0], side)
        torch.cuda.synchronize()

    def per_batch():
        model.inference_rgb_device(stack, hw)
        torch.cuda.synchronize()

    ms_b1, ms_b8 = _host_ms(per_request), _host_ms(per_batch) / 8
    SERVED[what] = (ms_b1, ms_b8)
    print(f"{what} bf16 steady state: {ms_b1:.3f} ms per request at B=1, {ms_b8:.3f} ms per frame at B=8 [{smi}]", flush=True)
    return first, frames[0]


def phase_da_model(smi: str, ckpt: str):
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    fa.reset_launch_counts()  # count the path's run only
    depth, frame = serve(smi, model, MAX_SIDE, OUT_HW, "fused", VITL["num_blocks"], "DA-V2 ViT-L")
    return fa.flash_attention_fused_qkv.launches, depth, frame


def parity(ckpt, frame, side, out_hw, route, blocks, what, bf16_depth, cache_modes=(True,)):
    """f32 kernel model vs f32 plain model on the same checkpoint and frame.
    Returns the f32 kernel model."""
    _, m_kernel = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE, enable_optimizations=True)
    _, m_plain = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE, enable_optimizations=False)
    _, m_plain_bf16 = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE, enable_optimizations=False)
    for enable_cache in cache_modes:
        for m in (m_kernel, m_plain, m_plain_bf16):
            m.config["enable_cache"] = enable_cache
        d_kernel = _counted(lambda: m_kernel.inference(frame, side), route, blocks, f"{what} f32 kernel model")
        d_plain = _counted(lambda: m_plain.inference(frame, side), route, 0, f"{what} f32 plain model")
        _check_depth(d_kernel, (1, *out_hw), f"{what} f32 kernel model")
        _check_depth(d_plain, (1, *out_hw), f"{what} f32 plain model")
        rel, rel_bf16 = _abs_rel(d_kernel, d_plain), _abs_rel(bf16_depth, d_plain)
        rel_plain_bf16 = _abs_rel(m_plain_bf16.inference(frame, side), d_plain)
        mode = f" (enable_cache={enable_cache})" if len(cache_modes) > 1 else ""
        print(f"{what} f32 kernel vs plain{mode}: mean abs-rel {rel:.3e} (budget {ABS_REL_BUDGET:g}); "
              f"vs f32 plain, not gated: bf16 kernel model {rel_bf16:.3e}, bf16 plain model {rel_plain_bf16:.3e}", flush=True)
        if not rel <= ABS_REL_BUDGET:
            raise RuntimeError(f"{what}: f32 kernel model disagrees with the plain model: abs-rel {rel:.3e}")
    return m_kernel


def phase_beit_model(smi: str, ckpt: str):
    """BEiT-L-512 bf16: 512x512 serving, then one 1024x1024 request through
    the cached stack; then the 1024x1024 stack's last layer (an element
    offset past 2**31) against the plain version."""
    blocks = BEIT_L512["num_blocks"]
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    fa.reset_launch_counts()  # count the path's run only
    depth, frame = serve(smi, model, BEIT_SIDE, BEIT_HW, "fused_biased", blocks, "BEiT-L-512")
    rng = np.random.default_rng(SEED + 2)
    big = rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    out = _counted(lambda: model.inference(big, BEIT_BIG_SIDE), "fused_biased", blocks, "BEiT-L-512 1024x1024")
    _check_depth(out, (1, BEIT_BIG_SIDE, BEIT_BIG_SIDE), "BEiT-L-512 1024x1024")
    grid = (BEIT_BIG_SIDE // model.patch_size_px,) * 2
    stack = model._aux_cache[grid]
    if stack is None:
        raise RuntimeError("BEiT-L-512 1024x1024: the bias stack was not cached")
    print(f"BEiT-L-512 bf16 1024x1024 request: {(time.perf_counter() - t0) * 1e3:.1f} ms, first at this size "
          f"(bias stack {tuple(stack.shape)} {str(stack.dtype)[6:]}, {stack.numel() * stack.element_size() / 1e9:.2f} GB, "
          f"built once and cached) [{smi}]", flush=True)
    launches = fa.flash_attention_fused_qkv.biased_launches
    n = grid[0] * grid[1] + 1
    qkv = make_qkv(rng, 1, n, torch.bfloat16)
    kw = {"bias_stack": stack, "layer": blocks - 1}
    offset = (blocks - 1) * stack.stride(0)
    check = Checker()
    check(2, f"bfloat16 B=1 N={n} model stack layer {blocks - 1} (offset {offset} elements)",
          fa.flash_attention_fused_qkv(qkv, HEADS, **kw), fa.flash_attention_fused_qkv_reference(qkv, HEADS, **kw),
          (1, n, HEADS * HEAD_DIM))
    del qkv, stack, kw
    model.clear_cache()
    serve_int8_once(smi, model, {"include_qkv": True, "include_neck": True}, BEIT_SIDE, BEIT_HW, "fused_biased", blocks,
                    "BEiT-L-512 int8+qkv+neck", depth, frame)
    return launches, depth, frame, check.worst[2]


def phase_swin_model(smi: str, ckpt: str):
    """SwinV2-L-384 bf16: 384x384 serving, then one 512x512 request, its
    CPB stacks and masks built on the way."""
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    fa.reset_launch_counts()  # count the path's run only
    depth, frame = serve(smi, model, SWIN_SIDE, SWIN_HW, "window_sm90", SWIN_BLOCKS, "SwinV2-L-384")
    big = np.random.default_rng(SEED + 2).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _counted(lambda: model.inference(big, SWIN_BIG_SIDE), "window_sm90", SWIN_BLOCKS, "SwinV2-L-384 512x512")
    ms = (time.perf_counter() - t0) * 1e3
    _check_depth(out, (1, SWIN_BIG_SIDE, SWIN_BIG_SIDE), "SwinV2-L-384 512x512")
    grid = (SWIN_BIG_SIDE // model.patch_size_px,) * 2
    aux = model._aux_cache.get(grid)
    if aux is None:
        raise RuntimeError("SwinV2-L-384 512x512: the CPB stacks were not cached")
    windows = [window_plan(g, SWIN_L384["window_size_hw"])[0] for g in stage_grids(grid)]
    gb = sum(t.numel() * t.element_size() for stage in aux for t in stage.values() if t is not None) / 1e9
    print(f"SwinV2-L-384 bf16 512x512 request: {ms:.1f} ms, first at this size (CPB stacks and masks, {gb:.3f} GB, "
          f"built once and cached); windows per stage {windows} [{smi}]", flush=True)
    launches = wa.window_attention.sm90_launches
    serve_int8_once(smi, model, {}, SWIN_SIDE, SWIN_HW, "window_sm90", SWIN_BLOCKS, "SwinV2-L-384 int8 (MLP only)", depth,
                    frame)
    return launches, depth, frame


def kernel_block_outputs(net, x, internals, aux) -> list:
    """Every encoder block of ``net`` run on its kernel path on the capture's
    tokens before it: block 0 on the net's own embedding of ``x``, block i on
    the capture's block i-1 tokens (SwinV2: a stage's first block on the
    patch merge of them, with its stage's window plan, CPB and mask; BEiT:
    each block's bias from the cached stack ``aux`` or built inline). The
    outputs come in block order, in the capture's layout."""
    before = internals["block_tokens"]
    outs = []
    if isinstance(net, SwinV2DPT):
        prev, i = net.embed(x), 0
        for s in range(len(net.encoder.stages)):
            prev = net.encoder.stage_input(s, prev)
            b, gh, gw, c = prev.shape
            for block, args in net.encoder.block_plans(s, (gh, gw), aux, x.device):
                outs.append(block(prev, *args).reshape(b, gh * gw, c))
                prev, i = before[i].reshape(b, gh, gw, c), i + 1
        return outs
    enc = net.encoder
    tokens, grid = patchify_embed(x, net.patch_embed.weight, net.patch_embed.bias)
    if isinstance(net, BEiTDPT):
        prev, biases = enc.embed(tokens), enc.block_biases(grid, aux, x.dtype)
    else:
        prev, biases = enc.embed(tokens, grid), [None] * len(enc.blocks)
    for i, (block, bias) in enumerate(zip(enc.blocks, biases)):
        outs.append(block(prev, bias))
        prev = before[i]
    return outs


def attention_shapes(model, hw) -> list:
    """The (B=1) shape of each block's captured softmax weights at an input
    of ``hw``: (1, H, N, N) for the ViTs, (1, nW, H, A, A) per SwinV2 block."""
    if isinstance(model.net, SwinV2DPT):
        grids = stage_grids((hw[0] // model.patch_size_px, hw[1] // model.patch_size_px))
        shapes = []
        for s, grid in enumerate(grids):
            (wh, ww), _ = window_plan(grid, SWIN_L384["window_size_hw"])
            area = wh * ww
            nw = (grid[0] // wh) * (grid[1] // ww)
            shapes += [(1, nw, SWIN_L384["heads_per_stage"][s], area, area)] * SWIN_L384["layers_per_stage"][s]
        return shapes
    n = (hw[0] // model.patch_size_px) * (hw[1] // model.patch_size_px) + 1
    return [(1, model.config["num_heads"], n, n)] * model.config["num_blocks"]


def phase_capture(smi: str, model, frame, side, out_hw, what, routes, cache_modes=(True,)) -> dict:
    """Introspection on the f32 kernel model at full width, one request
    (B=1) from ``frame`` at ``side``, per aux mode: (a) the capture's depth
    against the same model's kernel forward (mean abs-rel, the repo's
    budget), the capture forward launching no kernel; (b) every block run on
    its kernel path on the capture's tokens before it against the capture's
    tokens after it (abs-rel per block, the same budget), its launches
    counted on the f32 route; (c) each block's softmax weights of their
    expected shape, every row summing to 1 within ``ROW_SUM_TOL``; (d)
    ``fusion_forward`` at unit scales and the head on the capture's
    reassembly maps against the capture's depth (max abs
    ``UNIT_FUSION_MAX_ABS``); (e) the bf16 capture against the bf16 kernel
    forward, reported; (f) host-clock ms of the f32 capture forward and the
    kernel forward. ``routes``: the kernel route of each (dtype,
    enable_cache). Returns per mode {"capture_ms", "forward_ms",
    "worst_block", "abs_rel"}."""
    x = model.prepare_image_bgr(frame, side)
    n_blocks = len(attention_shapes(model, out_hw))
    results = {}
    for enable_cache in cache_modes:
        route = routes[(torch.float32, enable_cache)]
        model.config["enable_cache"] = enable_cache
        model.clear_cache()
        label = f"{what} (enable_cache={enable_cache})" if len(cache_modes) > 1 else what
        d_kernel = _counted(lambda: model.forward(x), route, n_blocks, f"{label} f32 kernel forward")
        d_cap, internals = _counted(lambda: model.forward_with_internals(x), route, 0, f"{label} f32 capture")
        _check_depth(d_cap, (1, *out_hw), f"{label} capture")
        rel = _abs_rel(d_cap, d_kernel)
        if not rel <= ABS_REL_BUDGET:  # (a)
            raise RuntimeError(f"{label}: capture depth vs the kernel forward: abs-rel {rel:.3e}")
        grid = (x.shape[-2] // model.patch_size_px, x.shape[-1] // model.patch_size_px)
        with torch.inference_mode(), model._precision():
            outs = _counted(lambda: kernel_block_outputs(model.net, x, internals, model._get_aux(grid)), route, n_blocks,
                            f"{label} kernel blocks")  # (b)
            block_rel = [_abs_rel(o, t) for o, t in zip(outs, internals["block_tokens"])]
            del outs
            maps = internals["reassembly_maps"]
            d_unit = model.net.head(fusion_forward(maps, model.net.fusion, input_scales=(1.0, 1.0, 1.0, 1.0)))  # (d)
        worst = max(range(n_blocks), key=lambda i: block_rel[i])
        if len(block_rel) != n_blocks or not block_rel[worst] <= ABS_REL_BUDGET:
            raise RuntimeError(f"{label}: kernel block vs capture: abs-rel per block {block_rel}")
        shapes = [tuple(a.shape) for a in internals["attention"]]  # (c)
        if shapes != attention_shapes(model, out_hw) or any(a.dtype != torch.float32 for a in internals["attention"]):
            raise RuntimeError(f"{label}: attention maps {shapes}, want {attention_shapes(model, out_hw)} float32")
        row_err = max(float((a.sum(-1) - 1).abs().max()) for a in internals["attention"])
        if not row_err <= ROW_SUM_TOL:
            raise RuntimeError(f"{label}: a softmax row sums to 1 +- {row_err:.3e}")
        unit_err = float((d_unit - d_cap).abs().max())
        if not unit_err <= UNIT_FUSION_MAX_ABS:
            raise RuntimeError(f"{label}: unit-scale fusion + head vs the capture's depth: max abs {unit_err:.3e}")
        del internals, maps, d_unit
        torch.cuda.empty_cache()

        def capture_once():
            model.forward_with_internals(x)
            torch.cuda.synchronize()

        def forward_once():
            model.forward(x)
            torch.cuda.synchronize()

        capture_ms, forward_ms = _host_ms(capture_once, iters=5, warmup=1), _host_ms(forward_once, iters=5, warmup=1)
        m16 = model.to(torch.bfloat16)  # (e)
        d16 = _counted(lambda: m16.forward(x), routes[(torch.bfloat16, enable_cache)], n_blocks,
                       f"{label} bf16 kernel forward")
        rel16 = _abs_rel(m16.forward_with_internals(x)[0], d16)
        del m16
        torch.cuda.empty_cache()
        print(f"{label} capture, f32: depth vs the kernel forward abs-rel {rel:.3e} (budget {ABS_REL_BUDGET:g}); "
              f"{n_blocks} kernel blocks ({route}) on the capture's tokens, worst abs-rel {block_rel[worst]:.3e} at block "
              f"{worst} (budget {ABS_REL_BUDGET:g}); {n_blocks} softmax maps {shapes[0]}..{shapes[-1]}, rows sum to 1 "
              f"within {row_err:.2e}; unit-scale fusion + head vs capture depth max abs {unit_err:.2e}; bf16 capture vs "
              f"bf16 kernel forward abs-rel {rel16:.3e} (not gated); B=1 f32 capture forward {capture_ms:.3f} ms, kernel "
              f"forward {forward_ms:.3f} ms [{smi}]", flush=True)
        results[label] = {"capture_ms": capture_ms, "forward_ms": forward_ms, "worst_block": block_rel[worst],
                          "abs_rel": rel}
    return results


EXPERIMENTS = {  # module -> (arguments, files written into its folder for a 24-block ViT)
    fusion_scaling: ([], ["f" + "_".join(f"{s:g}" for s in scales) + ".png" for scales in fusion_scaling.default_sweep()]),
    attention_visualization: (["--headless"], [f"layer_{i:02d}.png" for i in range(24)]),
    block_norm_visualization: (["--headless"], ["all_blocks.png"] + [f"block_{i:02d}.png" for i in range(24)]),
    depth_masking: (["--remove_plane"], ["mask.png", "masked.png", "masked_rgba.png"]),
}


def phase_experiments(smi: str, ckpt: str, tmp: str):
    """The four analysis experiments' ``main`` on the checkpoint, on the
    card, each into its own folder of ``tmp``; every file each must write is
    there and reads back as an image."""
    for module, (args, files) in EXPERIMENTS.items():
        name = module.__name__.rsplit(".", 1)[1]
        out = os.path.join(tmp, name)
        t0 = time.perf_counter()
        module.main(["-m", ckpt, "-d", DEVICE, "-o", out, *args])
        got = sorted(os.listdir(out))
        unread = [f for f in got if cv2.imread(os.path.join(out, f), cv2.IMREAD_UNCHANGED) is None]
        if got != sorted(files) or unread:
            raise RuntimeError(f"experiment {name}: wrote {got} (want {sorted(files)}), unreadable {unread}")
        shutil.rmtree(out)
        print(f"experiment {name} {' '.join(args)}: {len(files)} images in {time.perf_counter() - t0:.1f} s [{smi}]",
              flush=True)
    torch.cuda.empty_cache()


APP_VIDEO_FRAMES = 48  # the synthetic 720x1280 clip run_video plays, each mode once over all of it
ASYNC_FRAMES = 6  # clip frames through run_video's AsyncResult against the default-stream forward: 2 alone, 2 pairs
APP_REPEATS = 5  # run_image's per-request time: median of these, after one
VIEWER_SERIAL, VIEWER_CONCURRENT = 8, 4  # /frame requests one after another, then at once
APP_MAX_ABS = 1e-3  # run_image's _raw.npy against the facade's depth, normalized 0..1, the same bf16 ops
VIEWER_MAX_ABS = 1e-5  # the viewer's lossless 24-bit depth against the facade's (quantization 6e-8)


def app_device_args() -> list:
    """The apps run with no -d, so on the card by default (in bfloat16); a
    CPU rehearsal (``DEVICE = "cpu"``) passes -d cpu (float32)."""
    return [] if DEVICE == "cuda" else ["-d", DEVICE]


def app_dtype():
    return torch.bfloat16 if DEVICE == "cuda" else torch.float32


def app_frame(tmp: str, name: str) -> tuple[str, np.ndarray]:
    """A smooth 720x1280 BGR test image (gradients and a disc, so depth and
    edges have structure), written losslessly as PNG."""
    hw = FRAME_HW
    yy, xx = np.mgrid[0 : hw[0], 0 : hw[1]].astype(np.float32)
    img = np.stack([xx / hw[1] * 255, yy / hw[0] * 255, 128 + 64 * np.sin(xx / 40) * np.cos(yy / 30)], -1)
    cv2.circle(img, (hw[1] // 2, hw[0] // 2), hw[0] // 4, (30, 200, 90), -1)
    img = img.clip(0, 255).astype(np.uint8)
    path = os.path.join(tmp, name)
    cv2.imwrite(path, img)
    return path, img


def run_image_once(smi, ckpt, tmp, route, blocks, what) -> tuple:
    """run_image --headless on a 720x1280 PNG through its ``main``, with no
    -d: ``blocks`` launches on ``route`` and none elsewhere, three files
    written. Returns (the saved paths, the image's path, the image)."""
    path, img = app_frame(tmp, "app_frame.png")
    with contextlib.chdir(tmp):
        t0 = time.perf_counter()
        saved = _counted(lambda: run_image.main(["-m", ckpt, "-i", path, "--headless", *app_device_args()]), route,
                         blocks, f"run_image {what}")
        seconds = time.perf_counter() - t0
    missing = [p for p in saved if not os.path.exists(p)]
    raw = np.load(saved[1])
    if missing or raw.shape != FRAME_HW or not np.isfinite(raw).all():
        raise RuntimeError(f"run_image {what}: missing {missing}, raw {raw.shape} finite={bool(np.isfinite(raw).all())}")
    print(f"run_image {what} --headless: 3 files, {blocks} {route} launches, {seconds:.1f} s with the model's load "
          f"[{smi}]", flush=True)
    return saved, path, img


def run_video_once(smi, ckpt, video, extra, blocks, what) -> dict:
    """run_video --headless over the clip through its ``main``; every
    dispatch launched ``blocks`` times on route fused and nothing else."""
    before = fa.launch_counts()
    stats = run_video.main(["-m", ckpt, "-i", video, "--headless", "--max_frames", str(APP_VIDEO_FRAMES), *extra,
                            *app_device_args()])
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in fa.launch_counts().items() if n != before[r]}
    dispatched = len(stats["host_ms"])
    if moved != {"fused": blocks * dispatched} or stats["frames"] != APP_VIDEO_FRAMES or stats["shown"] < 1:
        raise RuntimeError(f"run_video {what}: launches {moved} for {dispatched} dispatches, {stats['frames']} frames, "
                           f"{stats['shown']} shown")
    infer = f"{statistics.median(stats['infer_ms']):.3f} ms median inference (dispatch to depth on the host), " \
        if stats["infer_ms"] else ""
    print(f"run_video {what}: {stats['fps']:.2f} frames/s over {stats['frames']} frames, {stats['shown']} results shown "
          f"of {dispatched} dispatched, {infer}{statistics.median(stats['host_ms']):.3f} ms median host time inside the "
          f"dispatch (max {max(stats['host_ms']):.3f}) [{smi}]", flush=True)
    return stats


def viewer_get(base: str, path: str) -> tuple[dict, bytes]:
    with urllib.request.urlopen(base + path, timeout=300) as r:
        if r.status != 200:
            raise RuntimeError(f"3D viewer {path}: HTTP {r.status}")
        return dict(r.headers), r.read()


def viewer_depth(headers: dict, body: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(rgb, the normalized depth) of a /frame body: the lossless PNG's 24
    bits in R, G, B (run_3dviewer's wire format)."""
    n = int(headers["X-rgb-size"])
    rgb = cv2.imdecode(np.frombuffer(body[:n], np.uint8), cv2.IMREAD_COLOR)
    packed = cv2.imdecode(np.frombuffer(body[n:], np.uint8), cv2.IMREAD_UNCHANGED).astype(np.uint32)
    return rgb, ((packed[..., 2] << 16) | (packed[..., 1] << 8) | packed[..., 0]) / (2**24 - 1)


def check_async_result(smi, model, frames) -> int:
    """run_video's dispatch-ahead gate on the card (``AsyncResult``: its own
    stream, the pinned staging upload, the forward, the pinned read-back and
    the event) against the facade's forward on the default stream on the
    same frames, max abs 0 (the same bfloat16 ops on the same inputs). The
    first frames go through dispatch then collect one by one; the rest in
    pairs dispatched back to back, so the second upload rewrites the staging
    buffer while the first frame's forward may still run (only the second
    result is collected). Each frame's depth differs from the one before, so
    a stale result would show. Returns the gate's dispatches."""
    side = model.default_size_px
    hw = model.compute_scaled_hw(frames[0].shape[:2], side, True)

    def want(frame):
        rgb = torch.from_numpy(np.ascontiguousarray(frame[..., ::-1])).to(DEVICE)
        return depth_to_numpy(model.inference_rgb_device(rgb, hw))

    gate, dispatched, checked, prev = AsyncResult(DEVICE), 0, [], None
    steps = [[f] for f in frames[:2]] + [frames[i : i + 2] for i in range(2, len(frames), 2)]
    for step in steps:
        for frame in step:
            gate.dispatch(model, frame, side, True)
            dispatched += 1
        got, ref = gate.collect(), want(step[-1])
        if prev is not None and np.array_equal(ref, prev):
            raise RuntimeError("AsyncResult check: two clip frames gave the same depth, so a stale result cannot show")
        err = float(np.abs(got - ref).max())
        if got.shape != ref.shape or err != 0.0 or not gate.is_ready() or gate.collect() is not None:
            raise RuntimeError(f"AsyncResult on the card: depth {got.shape} max abs {err:.3e} from the default-stream "
                               f"forward (gate 0) after {len(step)} back-to-back dispatches")
        checked.append(len(step))
        prev = ref
    print(f"AsyncResult on the card: {len(checked)} collected depths ({checked.count(2)} after two back-to-back "
          f"dispatches) equal to the default-stream forward (max abs 0) [{smi}]", flush=True)
    return dispatched


def phase_conversion_cache(smi: str, ckpt: str, tmp: str):
    """``make_dpt_from_state_dict`` of the DA-V2 ViT-L checkpoint in bfloat16
    on the card: a plain build, a cache miss (convert, write the cache,
    build), a cache hit, then a plain build and a hit again; seconds of each
    to the model on the card, and the hit's depth against the plain model's,
    max abs 0 (the same float32 values cast the same way)."""
    frame = app_frame(tmp, "cache.png")[1]
    times, depths = {}, {}
    for name, cached in (("plain", False), ("miss", True), ("hit", True), ("plain", False), ("hit", True)):
        t0 = time.perf_counter()
        _, model = make_dpt_from_state_dict(ckpt, dtype=app_dtype(), device=DEVICE, conversion_cache=cached)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        if name not in depths:
            depths[name] = depth_to_numpy(model.inference(frame))
        del model
    cache_file = cache_path_for(ckpt)
    size = os.path.getsize(cache_file)
    os.remove(cache_file)
    torch.cuda.empty_cache()
    errs = {k: float(np.abs(depths[k] - depths["plain"]).max()) for k in ("miss", "hit")}
    if any(errs.values()):
        raise RuntimeError(f"conversion cache: depth max abs {errs} from the plain build's (gate 0)")
    print("conversion cache, DA-V2 ViT-L bf16 build to the card, s: plain " + " / ".join(f"{t:.3f}" for t in times["plain"])
          + f", miss {times['miss'][0]:.3f} (writes {size / 2**30:.3f} GiB), hit "
          + " / ".join(f"{t:.3f}" for t in times["hit"]) + f"; miss and hit depth equal to the plain build's [{smi}]",
          flush=True)
    return {k: min(v) for k, v in times.items()}


def phase_viewer(smi, model, image_path, img, blocks) -> tuple[float, int]:
    """run_3dviewer's handler on 127.0.0.1 in a thread, as a user's browser
    drives it: /frame/0 serially and 4 at once (equal bodies), its depth
    against the facade's, /get-source-info, /export/obj, POST /upload.
    Every inference launches ``blocks`` times on route fused. Returns the
    median ms per serial /frame and the handler's launches; prints beside
    it the inference and read-back alone (``predict_depth``), the rest of a
    request being the handler's encoding and HTTP."""
    side = model.default_size_px
    want = normalize_01(remove_infinities(depth_to_numpy(model.inference(img, side)).squeeze()))
    predict = []
    for _ in range(VIEWER_SERIAL):
        t0 = time.perf_counter()
        run_3dviewer.predict_depth(model, img, side, True)  # numpy out: the card is done
        predict.append((time.perf_counter() - t0) * 1e3)
    source = run_3dviewer.InputSource(image_path)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), run_3dviewer.make_handler(model, source, side, is_metric=False))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        before = fa.launch_counts()
        headers, first = viewer_get(base, "/frame/0")
        times = []
        for _ in range(VIEWER_SERIAL):
            t0 = time.perf_counter()
            _, body = viewer_get(base, "/frame/0")
            times.append((time.perf_counter() - t0) * 1e3)
            if body != first:
                raise RuntimeError("3D viewer: a repeated /frame/0 gave other bytes")
        bodies = [None] * VIEWER_CONCURRENT

        def fetch(i):
            bodies[i] = viewer_get(base, "/frame/0")[1]

        threads = [threading.Thread(target=fetch, args=(i,)) for i in range(VIEWER_CONCURRENT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or any(b != first for b in bodies):
            raise RuntimeError("3D viewer: concurrent /frame/0 requests did not all equal the serial one")
        rgb, depth = viewer_depth(headers, first)
        err = float(np.abs(depth - want).max())
        if rgb.shape != img.shape or depth.shape != want.shape or not err <= VIEWER_MAX_ABS:
            raise RuntimeError(f"3D viewer /frame/0: rgb {rgb.shape}, depth {depth.shape} vs {want.shape}, err {err:.3e}")
        info = json.loads(viewer_get(base, "/get-source-info")[1])
        obj = viewer_get(base, "/export/obj?grid=8")[1].decode()
        vertices = sum(line.startswith("v ") for line in obj.splitlines())
        if info != {"type": "image", "frame_count": 1, "fps": 0.0, "is_metric": False} or vertices != 81:
            raise RuntimeError(f"3D viewer: source info {info}, {vertices} OBJ vertices (want 81)")
        small = cv2.imencode(".png", cv2.resize(img, (320, 180)))[1].tobytes()
        with urllib.request.urlopen(urllib.request.Request(base + "/upload", data=small, method="POST"), timeout=300) as r:
            if r.status != 200:
                raise RuntimeError(f"3D viewer /upload: HTTP {r.status}")
        rgb_up, depth_up = viewer_depth(*viewer_get(base, "/frame/0"))
        if rgb_up.shape != (180, 320, 3) or not np.isfinite(depth_up).all():
            raise RuntimeError(f"3D viewer after /upload: rgb {rgb_up.shape}")
        torch.cuda.synchronize()
        moved = {r: n - before[r] for r, n in fa.launch_counts().items() if n != before[r]}
        inferences = 1 + VIEWER_SERIAL + VIEWER_CONCURRENT + 1 + 1  # the frames, the export, the uploaded frame
        if moved != {"fused": blocks * inferences}:
            raise RuntimeError(f"3D viewer: launches {moved}, want {blocks * inferences} on fused only")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    ms = statistics.median(times)
    print(f"run_3dviewer handler: {ms:.3f} ms median per /frame (JPEG + 24-bit PNG, {VIEWER_SERIAL} serial requests; "
          f"{min(times):.3f}-{max(times):.3f}), of which inference and read-back alone {statistics.median(predict):.3f} "
          f"ms; {VIEWER_CONCURRENT} concurrent equal to serial, depth max abs "
          f"{err:.3e} from the facade's (gate {VIEWER_MAX_ABS:g}), /get-source-info, /export/obj (81 vertices), "
          f"/upload; {inferences} inferences, {moved['fused']} fused launches [{smi}]", flush=True)
    return ms, moved["fused"]


def phase_apps(smi: str, ckpt: str, tmp: str) -> dict:
    """The apps on the DA-V2 ViT-L checkpoint, each through its ``main`` with
    no -d, so on the card in bfloat16 (depth_prediction: float32): run_image
    --headless, its ``_raw.npy`` against the facade's depth on the same
    frame and its per-request time; run_video --headless over a synthetic
    720x1280 clip, -sync (with -r: frames recorded) and dispatch-ahead;
    run_3dviewer's handler; depth_prediction --no_display; float16 refused.
    Returns the apps' launches by route, the checks' own inferences left out."""
    blocks = VITL["num_blocks"]
    fa.reset_launch_counts()  # count the path's run only; the apps' launches are summed below, call by call
    saved, image_path, img = run_image_once(smi, ckpt, tmp, "fused", blocks, "DA-V2 ViT-L")
    _, model = make_dpt_from_state_dict(ckpt, dtype=app_dtype(), device=DEVICE)
    h, w = img.shape[:2]
    want = normalize_01(remove_infinities(scale_prediction(depth_to_numpy(model.inference(img)), (w, h)).squeeze()))
    err = float(np.abs(np.load(saved[1]) - want).max())
    if not err <= APP_MAX_ABS:
        raise RuntimeError(f"run_image _raw.npy: max abs {err:.3e} from the facade's depth (gate {APP_MAX_ABS:g})")
    side = model.default_size_px
    run_image.compute_depth_display(model, img, side, True)
    times = []
    for _ in range(APP_REPEATS):
        t0 = time.perf_counter()
        run_image.compute_depth_display(model, img, side, True)  # numpy out: the card is done
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"run_image DA-V2 ViT-L: _raw.npy max abs {err:.3e} from the facade's normalized depth (gate "
          f"{APP_MAX_ABS:g}); {statistics.median(times):.3f} ms median per request (inference, read-back, resize to "
          f"720x1280, plane fit; {min(times):.3f}-{max(times):.3f}) [{smi}]", flush=True)

    video = os.path.join(tmp, "app_clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30, FRAME_HW[::-1])
    if not writer.isOpened():
        raise RuntimeError("cv2 cannot write the mp4 test clip")
    for t in range(APP_VIDEO_FRAMES):
        writer.write(np.roll(img, 16 * t, axis=1))
    writer.release()
    stats = {}
    with contextlib.chdir(tmp):
        stats["sync"] = run_video_once(smi, ckpt, video, ["-sync", "-r"], blocks, "-sync -r")
        recorded = sorted(os.listdir(stats["sync"]["record_folder"]))
        if stats["sync"]["recorded"] < 1 or not recorded:
            raise RuntimeError(f"run_video -r wrote no frames: {stats['sync']['record_folder']}")
        print(f"run_video -r: {stats['sync']['recorded']} frames recorded into {len(recorded)} files", flush=True)
        stats["ahead"] = run_video_once(smi, ckpt, video, [], blocks, "dispatch-ahead")
    check_async_result(smi, model, [np.roll(img, 16 * t, axis=1) for t in range(ASYNC_FRAMES)])

    ms, viewer_launches = phase_viewer(smi, model, image_path, img, blocks)
    del model

    depth = _counted(lambda: depth_prediction.main(["-m", ckpt, "--no_display", *app_device_args()]), "fused", blocks,
                     "depth_prediction")
    if depth.shape != OUT_HW or not (np.isfinite(depth).all() and depth.min() == 0 and depth.max() == 1):
        raise RuntimeError(f"depth_prediction: depth {depth.shape}, range {depth.min()}..{depth.max()}")
    print(f"depth_prediction --no_display: {depth.shape}, normalized, {blocks} fused launches (float32) [{smi}]",
          flush=True)
    phase_f16(smi, ckpt, tmp)
    dispatched = sum(len(v["host_ms"]) for v in stats.values())
    launches = {"fused": blocks * (1 + dispatched + 1) + viewer_launches}  # run_image, run_video, depth_prediction
    print(f"apps on DA-V2 ViT-L, launches from inside the apps: {launches} (run_image {blocks}, run_video "
          f"{blocks * dispatched}, run_3dviewer {viewer_launches}, depth_prediction {blocks}) [{smi}]", flush=True)
    torch.cuda.empty_cache()
    return {"run_image_ms": statistics.median(times), "video": stats, "viewer_ms": ms, "launches": launches}


BATCH_FRAMES = 20  # run_batch's folder: two full steps of BATCH_STEP frames and one padded
BATCH_STEP = 8  # -dp 1 --per-chip-batch 8
BATCH_F32_FRAMES = 4  # the -f32 runs: one step, padded
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 2, 3, 1e-5  # make_train_step on the f32 ViT-L at 504x504 (N = 1297)
NARROW_DA = (64, 1, 4, (8, 16, 32, 64), (8, 8), 16)  # F, heads, blocks, reassembly, base grid, fusion: the CPU tests' DA-V2
NARROW_SIDE = 56
GRAD_SEED = 0  # the narrow step's images: tests/test_torch_parallel.py:GRAD_SEED, a well-conditioned input
CARD_CPU_GRAD_RTOL = 1e-3  # the narrow first step's loss and each gradient, card against the CPU port
ZERO_FLOOR = 1e-4  # of the largest gradient norm: below it a gradient is float noise (head.proj.bias: SSI ignores a shift)
FINETUNE_STEPS = 30


def batch_folder(tmp: str, n: int) -> tuple[str, list]:
    """A folder of n 720x1280 BGR frames (app_frame rolled 16 px a frame), as PNG."""
    _, img = app_frame(tmp, "batch_base.png")
    folder = os.path.join(tmp, "batch_frames")
    os.makedirs(folder, exist_ok=True)
    frames = [np.roll(img, 16 * t, axis=1) for t in range(n)]
    for t, f in enumerate(frames):
        cv2.imwrite(os.path.join(folder, f"f_{t:03d}.png"), f)
    return folder, frames


def run_batch_once(ckpt, tmp, frames_dir, out, extra, want, what) -> dict:
    """run_batch's ``main`` with no -d, so on the card; exactly ``want``
    launches on route fused and none elsewhere, counted from inside the app."""
    before = fa.launch_counts()
    with contextlib.chdir(tmp):
        stats = run_batch.main(["-m", ckpt, "-i", frames_dir, "-o", out, "-dp", "1", *extra, *app_device_args()])
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in fa.launch_counts().items() if n != before[r]}
    if moved != {"fused": want}:
        raise RuntimeError(f"run_batch {what}: launches {moved}, want {want} on fused only")
    return stats


def grad_errors(ours: dict, ref: dict) -> dict:
    """Per tensor ||ours - ref|| / ||ref||; a reference gradient below
    ZERO_FLOOR of the largest is float noise, and ours must be too (its
    norm over the largest reference norm)."""
    top = max(float(v.norm()) for v in ref.values())
    out = {}
    for k, g in ours.items():
        n = float(ref[k].norm())
        out[k] = float(g.norm()) / top if n < ZERO_FLOOR * top else float((g - ref[k]).norm()) / n
    return out


def grads_of(net) -> dict:
    """Each parameter's gradient on the CPU (None: no gradient reached it)."""
    return {k: None if p.grad is None else p.grad.detach().float().cpu() for k, p in net.named_parameters()}


def block_pattern(name: str) -> str:
    return re.sub(r"blocks\.\d+\.", "blocks.*.", name)


def narrow_step(device, cfg=NARROW_DA, mesh=None):
    """One train step of the narrow DA-V2 (``cfg``) on ``device``, split over
    the model axis of ``mesh`` if given: (loss, gradients; a split
    parameter's gradient is this rank's piece)."""
    model = make_depthanythingv2_dpt(*cfg, device=device, seed=SEED)
    if mesh is not None:
        model = shard_model(model, mesh)
    rng = np.random.default_rng(GRAD_SEED)
    images = rng.standard_normal((TRAIN_BATCH, NARROW_SIDE, NARROW_SIDE, 3)).astype(np.float32)
    targets = rng.uniform(0.1, 1.0, (TRAIN_BATCH, NARROW_SIDE, NARROW_SIDE)).astype(np.float32)
    loss = float(make_train_step(model, adamw(model.net.parameters(), TRAIN_LR))(images, targets))
    return loss, grads_of(model.net)


def hold_step(what, loss, grads, ref_loss, ref_grads) -> tuple[float, str]:
    """The narrow step's loss and every gradient against a reference run, at
    CARD_CPU_GRAD_RTOL. Returns the worst error and what it was on."""
    missing = sorted(k for k in ref_grads if (ref_grads[k] is None) != (grads[k] is None))
    if missing:
        raise RuntimeError(f"{what}: gradients present on one side only: {missing}")
    errors = grad_errors({k: g for k, g in grads.items() if g is not None},
                         {k: g for k, g in ref_grads.items() if g is not None})
    worst = max(errors, key=errors.get)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    if not (loss_err <= CARD_CPU_GRAD_RTOL and errors[worst] <= CARD_CPU_GRAD_RTOL):
        raise RuntimeError(f"{what}: loss {loss} vs {ref_loss} ({loss_err:.3e}), worst gradient {worst} "
                           f"{errors[worst]:.3e} (gate {CARD_CPU_GRAD_RTOL:g})")
    return (loss_err, "the loss") if loss_err > errors[worst] else (errors[worst], worst)


def check_grad_guard(smi: str):
    """A CUDA qkv slab that requires grad: the kernel refuses it under
    autograd, and launches under no_grad."""
    qkv = make_qkv(np.random.default_rng(SEED + 7), 1, N_TOKENS, torch.bfloat16).requires_grad_()
    try:
        fa.flash_attention_fused_qkv(qkv, HEADS)
    except RuntimeError as e:
        if "no backward kernel" not in str(e):
            raise
        refusal = str(e)
    else:
        raise RuntimeError("flash_attention_fused_qkv ran on a slab that requires grad with grad mode on")
    with torch.no_grad():
        out = _counted(lambda: fa.flash_attention_fused_qkv(qkv, HEADS), "fused", 1, "the guard's no_grad launch")
    err = _abs_rel(out, fa.flash_attention_fused_qkv_reference(qkv.detach(), HEADS))
    if not err <= 1e-2:
        raise RuntimeError(f"the guard's no_grad launch: abs-rel {err:.3e} from the plain version")
    print(f"gradient guard: under autograd the kernel refuses ({refusal.split(';')[0]}); under no_grad it launches "
          f"once (abs-rel {err:.3e} from its plain version) [{smi}]", flush=True)


def _nccl_rank(rank, world_size, ckpt, frames_dir, out_path, device_type, n_frames, out_hw):
    """One rank of an NCCL group: BatchParallelRunner on a batch of
    ``n_frames`` (its gather an all-gather), against the facade on the same
    frames, then the narrow train step (its gradients all-reduced). Writes
    its numbers to ``out_path``."""
    device = rank_device(device_type, rank)
    _, model = make_dpt_from_state_dict(ckpt, dtype=app_dtype(), device=device)
    names = sorted(os.listdir(frames_dir))[:n_frames]
    frames = [cv2.imread(os.path.join(frames_dir, n)) for n in names]
    x = torch.cat([model.prepare_image_bgr_nhwc(f) for f in frames])
    fa.reset_launch_counts()
    depth = BatchParallelRunner(model)(x)
    torch.cuda.synchronize()
    launches = fa.launch_counts()["fused"]
    stack = torch.from_numpy(np.stack([f[..., ::-1] for f in frames])).to(device)
    want = model.inference_rgb_device(stack, out_hw)
    loss, grads = narrow_step(device)
    torch.save({"launches": launches, "err": _abs_rel(depth, want), "shape": tuple(depth.shape), "loss": loss,
                "grads": grads, "backend": torch.distributed.get_backend()}, out_path)


def phase_nccl_rank(smi: str, ckpt: str, frames_dir: str, tmp: str, loss: float, grads: dict):
    """A spawned rank in an NCCL group of world size 1: the runner's gather
    and the train step's all-reduce run on the card."""
    out = os.path.join(tmp, "nccl_rank.pt")
    spawn(_nccl_rank, 1, ckpt, frames_dir, out, DEVICE, BATCH_STEP, OUT_HW, device_type=DEVICE)
    got = torch.load(out, weights_only=True)
    blocks = VITL["num_blocks"]
    if got["backend"] != ("nccl" if DEVICE == "cuda" else "gloo") or got["launches"] != blocks or got["shape"] != (BATCH_STEP, *OUT_HW) or \
            not got["err"] <= ABS_REL_BUDGET:
        raise RuntimeError(f"NCCL rank: backend {got['backend']}, {got['launches']} fused launches (want {blocks}), "
                           f"depth {got['shape']}, abs-rel {got['err']:.3e} from the facade")
    worst, name = hold_step("NCCL rank's train step against the card's", got["loss"], got["grads"], loss, grads)
    print(f"NCCL world of 1: BatchParallelRunner B={BATCH_STEP} through an all-gather, {got['launches']} fused "
          f"launches, abs-rel {got['err']:.3e} from the facade; the narrow train step through the all-reduce within "
          f"{worst:.3e} ({name}) of the in-process step [{smi}]", flush=True)


def phase_training(smi: str, ckpt: str) -> dict:
    """make_train_step: the narrow DA-V2's first step on the card against
    the CPU port's, then the f32 DA-V2 ViT-L at B=2, 504x504, for
    TRAIN_STEPS steps on the plain attention (no kernel launches)."""
    cpu_loss, cpu_grads = narrow_step("cpu")
    card_loss, card_grads = narrow_step(DEVICE)
    worst, name = hold_step("narrow DA-V2 train step, card against CPU", card_loss, card_grads, cpu_loss, cpu_grads)
    with_grad = {block_pattern(k) for k, g in cpu_grads.items() if g is not None}
    print(f"narrow DA-V2 train step (F={NARROW_DA[0]}, {NARROW_DA[2]} blocks, B={TRAIN_BATCH}, {NARROW_SIDE}x{NARROW_SIDE}): "
          f"loss {card_loss:.6f} on the card, {cpu_loss:.6f} on the CPU; loss and every gradient within {worst:.3e} "
          f"(worst: {name}; gate {CARD_CPU_GRAD_RTOL:g}, TF32 off) [{smi}]", flush=True)

    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE)
    step = make_train_step(model, adamw(model.net.parameters(), TRAIN_LR))
    images, targets = finetune_demo.synthetic_scene(np.random.default_rng(SEED), TRAIN_BATCH, OUT_HW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, ms = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(images, targets)))  # float(): the card is done
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = grads_of(model.net)
            got = {block_pattern(k) for k, g in grads.items() if g is not None}
            bad = sorted(k for k, g in grads.items() if g is not None and not bool(torch.isfinite(g).all()))
            flat = [k for b in range(VITL["num_blocks"]) for k in (f"encoder.blocks.{b}.attn.qkv.weight",
                                                                    f"encoder.blocks.{b}.attn.proj.weight")
                    if grads[k] is None or float(grads[k].abs().max()) == 0.0]
            if got != with_grad or bad or flat:
                raise RuntimeError(f"ViT-L train step: gradients on {sorted(got ^ with_grad)} differ from the CPU's, "
                                   f"non-finite {bad}, zero qkv/proj {flat}")
            del grads
    moved = {r: n for r, n in fa.launch_counts().items() if n}
    memory = device_memory_report()
    peak = memory[f"cuda:{torch.cuda.current_device()}"]["peak_bytes_in_use"]
    if not all(math.isfinite(v) for v in losses) or moved or not peak:
        raise RuntimeError(f"ViT-L train step: losses {losses}, kernel launches {moved}, peak {peak}")
    print(f"DA-V2 ViT-L f32 train step, B={TRAIN_BATCH} at {OUT_HW[0]}x{OUT_HW[1]} (N={N_TOKENS}), plain attention, "
          f"no kernel launched: losses {', '.join(f'{v:.6f}' for v in losses)}; {len(with_grad)} parameter patterns "
          f"with a gradient, as on the CPU, every one finite, every block's qkv and proj non-zero; ms per step "
          f"{', '.join(f'{v:.1f}' for v in ms)}; peak {peak / 2**30:.2f} GiB allocated (device_memory_report) "
          f"[{smi}]", flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {"train_ms": statistics.median(ms[1:]), "train_first_ms": ms[0], "train_peak_gib": peak / 2**30,
            "losses": losses, "narrow": (card_loss, card_grads)}


def phase_finetune(smi: str, tmp: str):
    """tools/finetune_demo on the tiny model: FINETUNE_STEPS steps with
    checkpoints, CONVERGED, then --resume for 10 more, RESUMED OK."""
    ck = os.path.join(tmp, "finetune_ckpt")
    texts = []
    for extra, want in (([f"--steps", str(FINETUNE_STEPS), "--save_every", "10"], "CONVERGED"),
                        ([f"--steps", str(FINETUNE_STEPS + 10), "--resume"], "RESUMED OK")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = finetune_demo.main(["--ckpt_dir", ck, *extra, *app_device_args()])
        text = buf.getvalue()
        texts.append(text)
        if code != 0 or want not in text.splitlines():
            raise RuntimeError(f"finetune_demo {' '.join(extra)}: exit {code}, want {want}:\n{text}")
    first = texts[0].splitlines()
    print(f"finetune_demo on the card: {first[-2]}; {first[-1]}; after --resume: "
          f"{texts[1].splitlines()[-2]}; {texts[1].splitlines()[-1]} [{smi}]", flush=True)


def phase_batch_training(smi: str, ckpt: str, tmp: str) -> dict:
    """Batch extraction and training on DA-V2 ViT-L: run_batch in bf16 over
    BATCH_FRAMES 720x1280 frames at -dp 1 --per-chip-batch 8 (exactly 3 x 24
    fused launches, frames/s beside the facade's B=8 ms per frame); -f32 on
    4 frames against the f32 facade and --eval_gt's self-consistency; the
    train step; the gradient guard; an NCCL world of 1; finetune_demo.
    Returns run_batch's numbers and its bf16 launches."""
    blocks = VITL["num_blocks"]
    frames_dir, frames = batch_folder(tmp, BATCH_FRAMES)
    steps = -(-BATCH_FRAMES // BATCH_STEP)
    fa.reset_launch_counts()  # count the path's run only
    out16 = os.path.join(tmp, "batch_bf16")
    stats = run_batch_once(ckpt, tmp, frames_dir, out16, ["--per-chip-batch", str(BATCH_STEP), "--save", "u16,npy"],
                           steps * blocks, "bf16")
    launches = fa.launch_counts()["fused"]
    names = [f"f_{t:03d}" for t in range(BATCH_FRAMES)]
    saved = sorted(os.listdir(out16))
    depths = [np.load(os.path.join(out16, f"{n}.npy")) for n in names]
    if stats["frames"] != BATCH_FRAMES or saved != sorted(f"{n}{e}" for n in names for e in (".npy", ".png")) or \
            any(d.shape != OUT_HW or not np.isfinite(d).all() for d in depths):
        raise RuntimeError(f"run_batch bf16: {stats['frames']} frames, files {saved[:4]}..., shapes "
                           f"{sorted({d.shape for d in depths})}")
    _, model = make_dpt_from_state_dict(ckpt, dtype=app_dtype(), device=DEVICE)
    agree = max(_abs_rel(torch.from_numpy(depths[t]), model.inference(frames[t])[0].float().cpu())
                for t in range(BATCH_F32_FRAMES))
    stack = torch.from_numpy(np.stack([f[..., ::-1] for f in frames[:BATCH_STEP]])).to(DEVICE)

    def per_batch():
        model.inference_rgb_device(stack, OUT_HW)
        torch.cuda.synchronize()

    facade_ms = _host_ms(per_batch) / BATCH_STEP
    del model, stack
    torch.cuda.empty_cache()
    # the app's host work per frame, timed alone: the PNG decode, then the u16 PNG and .npy writes
    t0 = time.perf_counter()
    for n in names:
        cv2.imread(os.path.join(frames_dir, f"{n}.png"))
    decode_ms = (time.perf_counter() - t0) * 1e3 / BATCH_FRAMES
    t0 = time.perf_counter()
    for n, d in zip(names, depths):
        cv2.imwrite(os.path.join(tmp, "host_u16.png"), np.round(normalize_01(d) * 65535).astype(np.uint16))
        np.save(os.path.join(tmp, "host.npy"), d)
    write_ms = (time.perf_counter() - t0) * 1e3 / BATCH_FRAMES
    print(f"run_batch bf16 -dp 1 --per-chip-batch {BATCH_STEP}: {BATCH_FRAMES} frames of {FRAME_HW[0]}x{FRAME_HW[1]} in {steps} steps (the "
          f"last padded), {launches} fused launches from inside the app; {stats['fps']:.2f} frames/s steady-state "
          f"(decode, prep, forward, u16 PNG and .npy writes) beside the facade's {facade_ms:.3f} ms per frame at "
          f"B={BATCH_STEP} ({1e3 / facade_ms:.2f} frames/s); worst .npy against the bf16 facade's B=1 inference "
          f"{agree:.3e} mean abs-rel (not gated); the host alone per frame: PNG decode {decode_ms:.3f} ms, u16 PNG "
          f"and .npy writes {write_ms:.3f} ms, of {1e3 / stats['fps']:.3f} ms per frame [{smi}]", flush=True)

    out32 = os.path.join(tmp, "batch_f32")
    f32 = ["-f32", "--max_frames", str(BATCH_F32_FRAMES), "--per-chip-batch", str(BATCH_STEP), "--save", "npy"]
    run_batch_once(ckpt, tmp, frames_dir, out32, f32, blocks, "-f32")
    _, m32 = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE)
    errs = [_abs_rel(torch.from_numpy(np.load(os.path.join(out32, f"{names[t]}.npy"))),
                     m32.inference(frames[t])[0].cpu()) for t in range(BATCH_F32_FRAMES)]
    del m32
    torch.cuda.empty_cache()
    if not max(errs) <= ABS_REL_BUDGET:
        raise RuntimeError(f"run_batch -f32 against the f32 facade: abs-rel {errs} (budget {ABS_REL_BUDGET:g})")
    gt = os.path.join(tmp, "batch_gt")
    os.makedirs(gt, exist_ok=True)
    for t in range(BATCH_F32_FRAMES):
        np.save(os.path.join(gt, f"{names[t]}.npy"), np.load(os.path.join(out32, f"{names[t]}.npy")) * 2.0)
    evals = {}
    for mode, extra in (("aligned", []), ("no-align", ["--eval_no_align"])):
        got = run_batch_once(ckpt, tmp, frames_dir, os.path.join(tmp, f"batch_eval_{mode}"), [*f32, "--eval_gt", gt, *extra],
                             blocks, f"--eval_gt {mode}")
        evals[mode] = {k: f"{v:.4f}" for k, v in got["eval"].items()}
    if evals["aligned"]["abs_rel"] != "0.0000" or evals["aligned"]["delta1"] != "1.0000" or \
            evals["no-align"]["abs_rel"] != "0.5000" or evals["no-align"]["rmse_log"] != "0.6931":
        raise RuntimeError(f"run_batch --eval_gt on its own outputs x 2: {evals}")
    print(f"run_batch -f32 on {BATCH_F32_FRAMES} frames: each .npy within {max(errs):.3e} mean abs-rel of the f32 facade's "
          f"inference (budget {ABS_REL_BUDGET:g}); --eval_gt with its outputs x 2: SSI-aligned abs_rel="
          f"{evals['aligned']['abs_rel']} delta1={evals['aligned']['delta1']}, --eval_no_align abs_rel="
          f"{evals['no-align']['abs_rel']} rmse_log={evals['no-align']['rmse_log']} [{smi}]", flush=True)

    train = phase_training(smi, ckpt)
    check_grad_guard(smi)
    phase_nccl_rank(smi, ckpt, frames_dir, tmp, *train.pop("narrow"))
    phase_finetune(smi, tmp)
    return {"launches": launches, "fps": stats["fps"], "facade_ms": facade_ms, "decode_ms": decode_ms,
            "write_ms": write_ms, **train}


def phase_app_family(smi: str, ckpt: str, tmp: str, route: str, blocks: int, what: str) -> int:
    """run_image --headless on another family's checkpoint; its launches on ``route``."""
    fa.reset_launch_counts()  # count the path's run only
    run_image_once(smi, ckpt, tmp, route, blocks, what)
    return fa.launch_counts()[route]


def phase_f16(smi: str, ckpt: str, tmp: str):
    """What a float16 DA-V2 model does on the card (the apps' -u), and the
    apps' refusal of -u up front: the attention kernel takes float32 and
    bfloat16 only."""
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.float16, device=DEVICE)
    try:
        model.inference(np.zeros((*FRAME_HW, 3), np.uint8))
    except ValueError as e:
        refused = str(e)
    else:
        raise RuntimeError("a float16 DA-V2 model served on the card: the apps' -u refusal (ROADMAP A16) is stale")
    del model
    torch.cuda.empty_cache()
    try:
        with contextlib.chdir(tmp):
            run_image.main(["-m", ckpt, "-i", app_frame(tmp, "f16.png")[0], "--headless", "-u", *app_device_args()])
    except SystemExit as e:
        if "A16" not in str(e.code):
            raise
    else:
        raise RuntimeError("run_image -u ran on the card")
    print(f"float16 DA-V2 ViT-L on the card: the kernel refuses it ({refused}); run_image -u exits up front [{smi}]",
          flush=True)


EXPORT_TIMING_ITERS = 10  # B=1 host-clock ms of a reloaded program and the live forward: the median of these
EXPORT_CHILD = r"""
import json, sys
import numpy as np
import torch
import muggled_dpt_tpu_torch.ops.kernels.library  # the mdpt ops the program holds: the one import a load needs
from muggled_dpt_tpu_torch.ops.kernels import flash_attention as fa
program = torch.export.load(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2])).to(sys.argv[4], torch.bfloat16)
fa.reset_launch_counts()
out = program.module()(x)
if x.is_cuda:
    torch.cuda.synchronize()
np.save(sys.argv[3], out.float().cpu().numpy())
print(json.dumps(fa.launch_counts()))
"""


def export_reloaded(model, hw, path: str):
    """``export_model.export_forward`` of ``model`` at ``hw``, saved to
    ``path`` and loaded back: (the reloaded program, export seconds, load
    seconds, artifact bytes). Requires one ``mdpt`` node per attention block."""
    t0 = time.perf_counter()
    program = export_model.export_forward(model, hw)
    export_s = time.perf_counter() - t0
    torch.export.save(program, path)
    del program
    t0 = time.perf_counter()
    reloaded = torch.export.load(path)
    return reloaded, export_s, time.perf_counter() - t0, os.path.getsize(path)


def check_nodes(program, op: str, blocks: int, what: str):
    nodes = export_model.kernel_nodes(program)
    if nodes != {op: blocks}:
        raise RuntimeError(f"{what}: the exported program's kernel nodes are {nodes}, want {{{op!r}: {blocks}}}")


def export_input(model, hw, seed) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal((1, 3, *hw)).astype(np.float32) * 0.5
    return torch.from_numpy(x).to(DEVICE, model.dtype)


def reloaded_request(model, call, x, route, blocks, what) -> tuple[torch.Tensor, float, bool]:
    """One call of a reloaded program, exactly ``blocks`` launches on
    ``route``, against the live model's forward on the same input: (its
    depth, mean abs-rel, bit-equal), gated at the repo's 1e-3."""
    with model._precision():
        got = _counted(lambda: call(x), route, blocks, f"{what} reloaded program")
        live = _counted(lambda: model.forward(x), route, blocks, f"{what} live forward")
    _check_depth(got, tuple(live.shape), f"{what} reloaded program")
    rel, equal = _abs_rel(got, live), torch.equal(got, live)
    if not rel <= ABS_REL_BUDGET:
        raise RuntimeError(f"{what}: the reloaded program disagrees with the live forward: abs-rel {rel:.3e}")
    return got, rel, equal


def phase_export(smi: str, ckpt: str, tmp: str) -> dict:
    """DA-V2 ViT-L: the bf16 program at 504x504 (``export_forward``), saved,
    reloaded in this process and in a fresh one; the f32 program through
    ``export_model.main``, held against the f32 plain model; the ONNX
    artifact through ``export_onnx.main``. Returns the numbers and the
    ``fused`` launches."""
    fa.reset_launch_counts()  # count the path's run only
    blocks, out = VITL["num_blocks"], {}
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    path = os.path.join(tmp, "dav2_vitl_bf16.pt2")
    program, export_s, load_s, nbytes = export_reloaded(model, OUT_HW, path)
    check_nodes(program, "flash_attention_fused_qkv", blocks, "DA-V2 ViT-L bf16")
    call, x = program.module(), export_input(model, OUT_HW, SEED + 5)
    got, rel, equal = reloaded_request(model, call, x, "fused", blocks, "DA-V2 ViT-L bf16")

    def timed_call(fn):
        def run():
            fn(x)
            torch.cuda.synchronize()
        return run

    turns = [("program", timed_call(call)), ("live", timed_call(model.forward))]
    readings = {name: [] for name, _ in turns}
    for name, fn in turns + turns[::-1]:  # program, live, live, program
        readings[name].append(_host_ms(fn, iters=EXPORT_TIMING_ITERS))
    out["program_ms"], out["live_ms"] = min(readings["program"]), min(readings["live"])
    print(f"export DA-V2 ViT-L bf16 {OUT_HW[0]}x{OUT_HW[1]}: torch.export {export_s:.1f} s, artifact "
          f"{nbytes / 1e6:.1f} MB, load {load_s:.1f} s; reloaded program vs live forward: abs-rel {rel:.3e} (budget "
          f"{ABS_REL_BUDGET:g}), bit-equal {equal}, {blocks} fused launches per call; B=1 ms, host clock, median of "
          f"{EXPORT_TIMING_ITERS} (two turns, the lower kept): program {out['program_ms']:.3f}, live forward "
          f"{out['live_ms']:.3f} [{smi}]", flush=True)
    launches = fa.launch_counts()["fused"]
    x_path, child_out = os.path.join(tmp, "export_x.npy"), os.path.join(tmp, "export_child.npy")
    np.save(x_path, x.float().cpu().numpy())
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path, x_path, child_out, DEVICE], capture_output=True,
                          text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise RuntimeError(f"export: loading the program in a fresh process failed:\n{proc.stderr[-4000:]}")
    child_launches = json.loads(proc.stdout.strip().splitlines()[-1])
    child_rel = _abs_rel(torch.from_numpy(np.load(child_out)), got.float().cpu())
    if child_launches["fused"] != blocks or sum(child_launches.values()) != blocks or not child_rel <= ABS_REL_BUDGET:
        raise RuntimeError(f"export: the fresh process launched {child_launches}, abs-rel {child_rel:.3e}")
    launches += child_launches["fused"]
    print(f"export: the program loaded and ran in a fresh process ({time.perf_counter() - t0:.1f} s, importing only "
          f"ops.kernels.library): {blocks} fused launches, abs-rel {child_rel:.3e} against this process's call", flush=True)
    del program, call, model, got
    os.remove(path)
    torch.cuda.empty_cache()

    fa.reset_launch_counts()
    main_out = export_model.main(["-m", ckpt, "-b", str(MAX_SIDE), "-o", tmp, "--timing_iters", str(EXPORT_TIMING_ITERS),
                                  *app_device_args()])
    if main_out["nodes"] != {"flash_attention_fused_qkv": blocks}:
        raise RuntimeError(f"export_model.main: kernel nodes {main_out['nodes']}")
    program = torch.export.load(main_out["path"])
    _, plain = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE, enable_optimizations=False)
    x = export_input(plain, OUT_HW, SEED + 5)
    with plain._precision():
        got = _counted(lambda: program.module()(x), "fused", blocks, "DA-V2 ViT-L f32 reloaded program")
        ref = _counted(lambda: plain.forward(x), "fused", 0, "DA-V2 ViT-L f32 plain model")
    rel32 = _abs_rel(got, ref)
    if not rel32 <= ABS_REL_BUDGET:
        raise RuntimeError(f"export: the f32 reloaded program disagrees with the f32 plain model: abs-rel {rel32:.3e}")
    launches += fa.launch_counts()["fused"]
    print(f"export DA-V2 ViT-L f32 through export_model.main: artifact {main_out['bytes'] / 1e6:.1f} MB, reloaded vs "
          f"live f32 kernel model {main_out['abs_rel']:.3e}, reloaded vs f32 plain model {rel32:.3e} (budget "
          f"{ABS_REL_BUDGET:g}), {main_out['ms']:.3f} ms per frame (main's timing loop, host clock, mean of "
          f"{EXPORT_TIMING_ITERS}) [{smi}]", flush=True)
    del program, plain, got, ref
    os.remove(main_out["path"])
    torch.cuda.empty_cache()

    onnx_out = export_onnx.main(["-m", ckpt, "-b", str(MAX_SIDE), "-o", tmp, *app_device_args()])
    os.remove(onnx_out["path"])
    out.update(onnx_mb=onnx_out["bytes"] / 1e6, onnx_s=onnx_out["evaluator_s"], onnx_rel=onnx_out["abs_rel"],
               f32_rel=rel32, bf16_rel=rel, bf16_equal=equal, bf16_mb=nbytes / 1e6, export_s=export_s)
    print(f"export DA-V2 ViT-L ONNX through export_onnx.main: artifact {out['onnx_mb']:.1f} MB, numpy evaluator "
          f"{out['onnx_s']:.1f} s on the host, abs-rel {out['onnx_rel']:.3e} against the live f32 kernel model on the "
          f"card (budget {ABS_REL_BUDGET:g}) [{smi}]", flush=True)
    out["launches"] = launches
    return out


def phase_export_family(smi: str, ckpt: str, tmp: str, hw, route: str, blocks: int, what: str,
                        cache_modes=(True,)) -> tuple[int, dict]:
    """Another family's bf16 program at ``hw``, for each aux mode: exported,
    saved, reloaded, one request against the live forward, ``blocks``
    launches on ``route``. Returns the launches and the artifact MB by mode."""
    fa.reset_launch_counts()  # count the path's run only
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    op = "window_attention" if route.startswith("window") else "flash_attention_fused_qkv"
    sizes = {}
    for enable_cache in cache_modes:
        model.config["enable_cache"] = enable_cache
        model.clear_cache()
        mode = "aux cached, lifted as constants" if enable_cache else "aux built in-graph"
        path = os.path.join(tmp, f"export_{route}_{int(enable_cache)}.pt2")
        program, export_s, load_s, nbytes = export_reloaded(model, hw, path)
        check_nodes(program, op, blocks, what)
        _, rel, equal = reloaded_request(model, program.module(), export_input(model, hw, SEED + 6), route, blocks, what)
        sizes[enable_cache] = nbytes / 1e6
        print(f"export {what} bf16 {hw[0]}x{hw[1]} ({mode}): torch.export {export_s:.1f} s, artifact {nbytes / 1e6:.1f} "
              f"MB, load {load_s:.1f} s, {len(program.constants)} constants; reloaded vs live: abs-rel {rel:.3e}, "
              f"bit-equal {equal}, {blocks} {route} launches [{smi}]", flush=True)
        del program
        os.remove(path)
    del model
    torch.cuda.empty_cache()
    return fa.launch_counts()[route], sizes

TP_MESH = {"data": 1, "model": 2}  # the tensor-parallel phase: two gloo ranks sharing the one card
TP_TIMING_ITERS = 3  # B=1 and B=8 host-clock times through gloo: the median of 3 after 1
NARROW_TP = (64, 2, 4, (8, 16, 32, 64), (8, 8), 16)  # the narrow DA-V2 with 2 heads of 32, so its attention splits too
# each family of the phase: its checkpoint, size, launches per forward, route by dtype, the batch of its checks, and by
# aux mode (enable_cache) the heads each launch must see: (heads,), or (heads, the bias stack's heads)
TP_FAMILIES = {
    "DA-V2 ViT-L": {"ckpt": "da", "side": MAX_SIDE, "out_hw": OUT_HW, "blocks": VITL["num_blocks"], "batch": 8,
                    "routes": {torch.bfloat16: "fused", torch.float32: "fused"}, "heads": {True: [(8,)]}},
    "BEiT-L-512": {"ckpt": "beit", "side": BEIT_SIDE, "out_hw": BEIT_HW, "blocks": BEIT_L512["num_blocks"], "batch": 1,
                   "routes": {torch.bfloat16: "fused_biased", torch.float32: "fused_biased"},
                   "heads": {True: [(8, 8)], False: [(8,)]}},
    "SwinV2-L-384": {"ckpt": "swin", "side": SWIN_SIDE, "out_hw": SWIN_HW, "blocks": SWIN_BLOCKS, "batch": 1,
                     "routes": {torch.bfloat16: "window_sm90", torch.float32: "window"},
                     "heads": {True: [(3,), (6,), (12,), (24,)]}},
}
TP_LABEL = "gloo through the host on one card; not a tensor-parallel speed"
# the bf16 split forward and the bf16 whole one each sit about the whole bf16 model's gap from the f32 one, so they
# differ by at most about twice that gap; a kernel broken at the split shapes gives a mean abs-rel near 1
TP_BF16_GAP_FACTOR = 2.0


def launch_delta(fn, into: dict):
    """fn(), its launches added to ``into`` by route."""
    before = fa.launch_counts()
    result = fn()
    for r, n in fa.launch_counts().items():
        if n != before[r]:
            into[r] = into.get(r, 0) + n - before[r]
    return result


def record_heads(seen: set, fills: set):
    """Route the blocks' two attention entries through wrappers that record
    each call's heads ((heads,) or, with a bias stack, (heads, stack heads))
    in ``seen`` and, for a bf16 bias on the card, how the kernel fills its
    bias tiles (``fa.bias_fill``: "tma" or "copy") in ``fills``, and call
    the kernel's wrapper, which launches and counts."""
    from muggled_dpt_tpu_torch.models import swinv2 as swin_module
    from muggled_dpt_tpu_torch.ops import nn as nn_ops

    def fused(qkv, num_heads, **kw):
        stack, bias = kw.get("bias_stack"), kw.get("bias")
        seen.add((num_heads,) if stack is None else (num_heads, stack.shape[1]))
        given = bias if stack is None else stack
        if qkv.is_cuda and given is not None and given.dtype == torch.bfloat16:
            operand = fa._bias_operand(bias, stack, kw.get("layer"), qkv.shape[0], num_heads, qkv.shape[1], qkv.device)
            fills.add("tma" if fa.bias_fill(operand) == fa.BIAS_FILL_TMA else "copy")
        return fa.flash_attention_fused_qkv(qkv, num_heads, **kw)

    def window(q, k, v, cpb, mask=None):
        seen.add((q.shape[3],))
        return wa.window_attention(q, k, v, cpb, mask)

    nn_ops.flash_attention_fused_qkv = fused
    swin_module.window_attention_kernel = window


def tp_times(rank: int, runner, model, x, whole_launches: dict) -> dict:
    """B=1 ms per request and B=8 ms per frame of the split model (both
    ranks) and, on rank 0 alone while rank 1 waits, of the whole model,
    whose launches are added to ``whole_launches``."""
    def timed_fn(fn, xb):
        def run():
            fn(xb)
            torch.cuda.synchronize()
        return run

    whole = lambda xb: model.forward(xb.permute(0, 3, 1, 2))  # noqa: E731
    out = {"tp2": (_host_ms(timed_fn(runner, x[:1]), TP_TIMING_ITERS, 1),
                   _host_ms(timed_fn(runner, x), TP_TIMING_ITERS, 1) / len(x))}
    if rank == 0:
        out["tp1"] = launch_delta(lambda: (_host_ms(timed_fn(whole, x[:1]), TP_TIMING_ITERS, 1),
                                           _host_ms(timed_fn(whole, x), TP_TIMING_ITERS, 1) / len(x)), whole_launches)
    torch.distributed.barrier()
    return out


def _tp_rank(rank, world_size, device_type, ckpts, out_dir):
    """One of two gloo ranks on the one card (mesh data 1 x model 2): each
    family's full-width model from its checkpoint, split by
    ``BatchParallelRunner(shard_model=True)``, one counted forward per dtype
    and aux mode against the same rank's whole model (the single-process
    kernel forward; in f32 also the whole bf16 model's gap to the whole f32
    one), BEiT's per-rank stack against the whole one, B=1 and B=8 times;
    then the narrow DA-V2's split train step. Writes its numbers to
    ``out_dir/tp_rank<r>.pt``."""
    device = rank_device(device_type, rank, share_card=True)
    seen, fills = set(), set()
    record_heads(seen, fills)
    rng = np.random.default_rng(SEED + 1)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(8)]
    out = {"families": {}, "bf16_launches": {}, "bf16_whole_launches": {}, "device": str(device)}
    fa.reset_launch_counts()
    for what, f in TP_FAMILIES.items():
        fam = out["families"][what] = {}
        b, route = f["batch"], f["routes"]
        bf16_whole = {}  # by aux mode: the whole bf16 model's depth, for its gap to the whole f32 one
        for dtype in (torch.bfloat16, torch.float32):
            before = fa.launch_counts()
            _, model = make_dpt_from_state_dict(ckpts[f["ckpt"]], dtype=dtype, device=device)
            runner = BatchParallelRunner(model, mesh=TP_MESH)
            x = torch.cat([model.prepare_image_bgr_nhwc(frame, f["side"]) for frame in frames])
            for cache in f["heads"]:
                model.config["enable_cache"] = runner.local.config["enable_cache"] = cache
                seen.clear()
                fills.clear()
                label = f"{what} tp=2 {str(dtype)[6:]} (enable_cache={cache})"
                depth = _counted(lambda: runner(x[:b]), route[dtype], f["blocks"], label)
                heads, fill = sorted(seen), sorted(fills)
                ref = launch_delta(lambda: _counted(lambda: model.forward(x[:b].permute(0, 3, 1, 2)), route[dtype],
                                                    f["blocks"], f"{label}, the whole model"),
                                   out["bf16_whole_launches"] if dtype is torch.bfloat16 else {})
                _check_depth(depth, (b, *f["out_hw"]), label)
                fam[(str(dtype)[6:], cache)] = {"rel": _abs_rel(depth, ref), "heads": heads, "fills": fill}
                if dtype is torch.bfloat16:
                    bf16_whole[cache] = ref.float().cpu()
                else:
                    fam[(str(dtype)[6:], cache)]["bf16_gap"] = _abs_rel(bf16_whole.pop(cache).to(ref.device), ref)
                if f["ckpt"] == "beit" and cache:
                    grid = (f["side"] // model.patch_size_px,) * 2
                    local, whole = runner.local._aux_cache[grid], model._aux_cache[grid]
                    h = local.shape[1]
                    fam[("stack", str(dtype)[6:])] = (tuple(local.shape), local.numel() * local.element_size(),
                                                      whole.numel() * whole.element_size(),
                                                      torch.equal(local, whole[:, h * rank:h * (rank + 1)]))
            if dtype is torch.bfloat16:
                model.config["enable_cache"] = runner.local.config["enable_cache"] = True
                fam["ms"] = tp_times(rank, runner, model, x, out["bf16_whole_launches"])
                moved = {r: n - before[r] for r, n in fa.launch_counts().items() if n != before[r]}
                for r, n in moved.items():
                    out["bf16_launches"][r] = out["bf16_launches"].get(r, 0) + n
            del model, runner, x
            torch.cuda.empty_cache()
    out["train"] = narrow_step(device, NARROW_TP, TP_MESH)
    out["launches"] = fa.launch_counts()
    torch.save(out, os.path.join(out_dir, f"tp_rank{rank}.pt"))


def phase_tensor_parallel(smi: str, ckpts: dict, tmp: str) -> dict:
    """Tensor parallelism on the card: two gloo ranks sharing it
    (``spawn(share_card=True)``), each family's full-width model split over
    a model axis of 2 by ``BatchParallelRunner(shard_model=True)``: 24
    launches per rank per forward on the family's route at the rank's head
    counts (DA-V2 ViT-L B=8 at 8 of 16 heads; BEiT-L-512 B=1 at 8 of 16,
    cached and inline, each rank's stack half the whole one's bytes;
    SwinV2-L-384 B=1 at 3/6/12/24 of 6/12/24/48), the f32 depth within the
    repo's 1e-3 mean abs-rel of the single-process f32 kernel forward, the
    bf16 depth within ``TP_BF16_GAP_FACTOR`` times the whole bf16 model's
    mean abs-rel to the whole f32 model of the single-process bf16 kernel
    forward; B=1 and B=8 times beside the whole model's; the narrow
    DA-V2's split train step, its pieces joined, against the in-process
    step. Returns the bf16 launches of #1, #2 and #3 over both ranks."""
    spawn(_tp_rank, 2, DEVICE, ckpts, tmp, device_type=DEVICE, share_card=True)
    got = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"), weights_only=False) for r in range(2)]
    if {g["device"] for g in got} != {str(rank_device(DEVICE, 0, share_card=True))}:
        raise RuntimeError(f"tensor parallel ranks ran on {[g['device'] for g in got]}, want one shared card")
    for what, f in TP_FAMILIES.items():
        parts = []
        for dtype in ("bfloat16", "float32"):
            for cache, want in f["heads"].items():
                rels = [g["families"][what][(dtype, cache)]["rel"] for g in got]
                heads = [g["families"][what][(dtype, cache)]["heads"] for g in got]
                if any(h != want for h in heads):
                    raise RuntimeError(f"{what} tp=2 {dtype} (enable_cache={cache}): heads per launch {heads}, want {want}")
                fills = {tuple(g["families"][what][(dtype, cache)]["fills"]) for g in got}
                if dtype == "bfloat16" and "BEiT" in what and DEVICE == "cuda" and fills != {("tma",)}:
                    raise RuntimeError(f"{what} tp=2 bf16 (enable_cache={cache}): bias tiles filled by {fills}, want TMA")
                if dtype == "float32" and not max(rels) <= ABS_REL_BUDGET:
                    raise RuntimeError(f"{what} tp=2 float32 (enable_cache={cache}): abs-rel {rels} from the "
                                       f"single-process kernel forward (budget {ABS_REL_BUDGET:g})")
                gate = ""
                if dtype == "bfloat16":
                    gap = max(g["families"][what][("float32", cache)]["bf16_gap"] for g in got)
                    limit = TP_BF16_GAP_FACTOR * gap
                    if not max(rels) <= limit:
                        raise RuntimeError(f"{what} tp=2 bfloat16 (enable_cache={cache}): abs-rel {rels} from the "
                                           f"single-process bf16 kernel forward, above {TP_BF16_GAP_FACTOR:g} x its "
                                           f"{gap:.3e} from the f32 one ({limit:.3e})")
                    gate = f" (gate {limit:.3e}: {TP_BF16_GAP_FACTOR:g} x the whole bf16 model's {gap:.3e} from f32)"
                mode = f", enable_cache={cache}" if len(f["heads"]) > 1 else ""
                fill = f", bias fill {'/'.join(sorted({x for f in fills for x in f}))}" if any(fills) else ""
                parts.append(f"{dtype}{mode} {max(rels):.3e}{gate} at heads {want}{fill}")
        print(f"{what} tp=2 (2 gloo ranks on one card, B={f['batch']}, {f['blocks']} launches per rank per forward on "
              f"{sorted(set(f['routes'].values()))}): mean abs-rel to the single-process kernel forward, worst rank: "
              f"{'; '.join(parts)} (f32 gated at {ABS_REL_BUDGET:g}) [{smi}]", flush=True)
        if "BEiT" in what:
            for dtype in ("bfloat16", "float32"):
                stacks = [g["families"][what][("stack", dtype)] for g in got]
                heads = f["heads"][True][0][1]
                if any(2 * local != whole or shape[1] != heads for shape, local, whole, _ in stacks):
                    raise RuntimeError(f"{what} tp=2 {dtype}: rank stacks {stacks}, want {heads} heads and half the bytes")
                shape, local, whole, _ = stacks[0]
                print(f"{what} tp=2 {dtype} bias stack per rank {shape}, {local / 1e6:.1f} MB against the whole "
                      f"stack's {whole / 1e6:.1f} MB; equal to its heads of the whole stack: "
                      f"{[s[3] for s in stacks]} [{smi}]", flush=True)
        ms = [g["families"][what]["ms"] for g in got]
        print(f"{what} bf16 ms per request at B=1 / per frame at B=8: tp=2 {ms[0]['tp2'][0]:.3f} / {ms[0]['tp2'][1]:.3f} "
              f"(rank 1: {ms[1]['tp2'][0]:.3f} / {ms[1]['tp2'][1]:.3f}) beside the whole model's "
              f"{ms[0]['tp1'][0]:.3f} / {ms[0]['tp1'][1]:.3f} on rank 0 alone ({TP_LABEL}) [{smi}]", flush=True)
    ref_loss, ref_grads = narrow_step(DEVICE, NARROW_TP)
    (loss0, g0), (loss1, g1) = (g["train"] for g in got)
    grads = {k: g0[k] if g0[k] is None or g0[k].shape == ref_grads[k].shape else spec_for_param(k).join([g0[k], g1[k]])
             for k in g0}
    joined = sum(1 for k in g0 if g0[k] is not None and g0[k].shape != ref_grads[k].shape)
    worst, name = hold_step("narrow DA-V2 tp=2 train step against the in-process one", loss0, grads, ref_loss, ref_grads)
    if loss0 != loss1 or not joined:
        raise RuntimeError(f"narrow tp=2 train step: losses {loss0} and {loss1} on the ranks, {joined} split gradients")
    print(f"narrow DA-V2 train step (F={NARROW_TP[0]}, {NARROW_TP[1]} heads, B={TRAIN_BATCH}) split over 2 gloo ranks on "
          f"the card: loss {loss0:.6f} on both ranks, {joined} split gradients joined; within {worst:.3e} of the "
          f"in-process step ({name}; gate {CARD_CPU_GRAD_RTOL:g}) [{smi}]", flush=True)
    routes = ("fused", "fused_biased", "window_sm90")
    totals = {r: sum(g["bf16_launches"].get(r, 0) for g in got) for r in routes}
    whole = {r: sum(g["bf16_whole_launches"].get(r, 0) for g in got) for r in routes}
    print(f"tensor parallel phase: bf16 launches over both ranks by route {totals}: "
          f"{ {r: totals[r] - whole[r] for r in routes} } at the split head counts, {whole} in the whole model's "
          f"reference and timing forwards; all launches by rank "
          f"{[{r: n for r, n in g['launches'].items() if n} for g in got]} [{smi}]", flush=True)
    return {1: totals["fused"], 2: totals["fused_biased"], 3: totals["window_sm90"]}


def phase_bnhd_path(smi: str) -> tuple[int, int]:
    """The (B, N, H, D) op: BEiT-L-512's attention shape (B=8, q, k, v as
    strided views of one qkv, a padded (1, H, Np, Np) bias as the JAX BEiT
    route hands it over), then 32897 keys."""
    rng = np.random.default_rng(SEED + 3)
    qkv = make_qkv(rng, 8, N_BEIT, torch.bfloat16)
    bias = padded_stack(rng, 1, N_BEIT, torch.bfloat16)  # (1, H, Np, Np), pads 1e6
    fa.reset_launch_counts()  # count the path's run only
    out = _counted(lambda: fa.flash_attention(*_split(qkv), bias=bias), "bnhd", 1, "(B, N, H, D) op")
    _check_depth(out, (8, N_BEIT, HEADS, HEAD_DIM), "(B, N, H, D) op")
    at_beit = fa.flash_attention.launches
    q, k, v = (make_bias(rng, (1, N_ONLINE, 2, HEAD_DIM), torch.bfloat16) for _ in range(3))
    out = _counted(lambda: fa.flash_attention(q, k, v), "bnhd", 1, f"(B, N, H, D) op at {N_ONLINE} keys")
    _check_depth(out, (1, N_ONLINE, 2, HEAD_DIM), f"(B, N, H, D) op at {N_ONLINE} keys")
    online = fa.flash_attention.launches - at_beit
    print(f"(B, N, H, D) op: {at_beit} launch at B=8 N={N_BEIT} with bias, {online} at N={N_ONLINE}", flush=True)
    return at_beit, online


def mlp_inputs(rng, shape, dtype, hidden=None):
    """Tokens N(0, 1) and a GELU block's norm2, fc1, fc2 and ls2 in torch
    layout, drawn with numpy; fc1 and fc2 scaled by 1/sqrt(fan-in). The
    hidden width is 4F unless given."""
    f = shape[-1]
    h = 4 * f if hidden is None else hidden
    params = [((f,), 0.05, 1.0), ((f,), 0.05, 0.0), ((h, f), f**-0.5, 0.0), ((h,), 0.05, 0.0),
              ((f, h), h**-0.5, 0.0), ((f,), 0.05, 0.0), ((f,), 0.05, 1.0)]  # (shape, scale, shift)
    return make_bias(rng, shape, dtype), [make_bias(rng, s, dtype, scale, shift) for s, scale, shift in params]


def head_inputs(rng, b, ci, h, w, dtype):
    """An NCHW map N(0, 1) and a head tail's weights in torch layout, drawn
    with numpy: the 3x3 conv scaled by 1/sqrt(9 ci), the projection bias 2
    (most outputs positive, as the synthetic checkpoints' heads)."""
    params = [((32, ci, 3, 3), (9 * ci) ** -0.5, 0.0), ((32,), 0.1, 0.0), ((1, 32, 1, 1), 0.3, 0.0), ((1,), 1.0, 2.0)]
    return make_bias(rng, (b, ci, h, w), dtype), [make_bias(rng, s, dtype, scale, shift) for s, scale, shift in params]


def mlp_shape(rows: int, f: int) -> tuple:
    """(B, N, F) for a row count: 8 x 1297 as the batch of 8 it is."""
    return (8, N_TOKENS, f) if rows == 8 * N_TOKENS else (1, rows, f)


MLP_ROUTES = {torch.bfloat16: "fused_mlp_sm90", torch.float32: "fused_mlp"}  # the #8 route each dtype must take


def mlp_launch(fn, dtype):
    """fn() (one #8 call) with its route counted (``counted_route``) and, in
    bf16, its kernel launches traced; returns its output and, for the
    check's label, the kernels that ran, once the call took its dtype's
    route (``MLP_ROUTES``) and, in bf16, ran ``MLP_SM90_KERNELS``, each once
    and in order, and no other kernel of ``KNOWN_KERNELS``."""
    if dtype == torch.bfloat16:
        ((out, route),), (label,) = traced_launches(8, [lambda: counted_route(fn, MLP_ROUTES.values())], [MLP_SM90_KERNELS])
    else:
        (out, route), label = counted_route(fn, MLP_ROUTES.values()), ""
    if route != MLP_ROUTES[dtype]:
        raise RuntimeError(f"kernel #8: a {dtype} call took the route {route}, want {MLP_ROUTES[dtype]}")
    return out, label


def phase_fused_kernels(smi: str) -> dict:
    """#8 and #9 vs their plain versions at the paths' widths and edge cases,
    float32 and bfloat16, then CUDA-event times of both, in turns."""
    rng = np.random.default_rng(SEED + 4)
    check = Checker()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        shapes = [(mlp_shape(rows, f), 4 * f) for f in MLP_WIDTHS for rows in MLP_ROWS]
        shapes += [((1, rows, f), hidden) for rows, f, hidden in MLP_ODD_HIDDEN]
        for shape, hidden in shapes:
            x, params = mlp_inputs(rng, shape, dtype, hidden)
            out, kernel = mlp_launch(lambda: fm.fused_ln_mlp_residual(x, *params), dtype)
            check(8, f"{name} rows={x.numel() // shape[-1]} F={shape[-1]} H={hidden}{kernel}", out,
                  fm.fused_ln_mlp_residual_reference(x, *params), x.shape, relative=True)
        cases = [(ci, b, h, w, route, metric, *head_inputs(rng, b, ci, h, w, dtype)) for ci in HEAD_CHANNELS
                 for b, h, w, route in HEAD_SIZES for metric in (False, True)]
        calls = [lambda x=x, params=params, metric=metric: ht.fused_head_tail(x, *params, metric)
                 for *_, metric, x, params in cases]
        if dtype == torch.bfloat16:  # each launch held to its size's route, as counted and by name, in one trace
            results, names = device_kernels(lambda: [counted_route(call, HEAD_ROUTE_KERNEL) for call in calls])
            routes = [route for _, route in results]
            want = [route for _, _, _, _, route, *_ in cases]
            if routes != want:
                raise RuntimeError(f"kernel #9: the launches took the routes {routes}, want {want}")
            outs, kernels = [out for out, _ in results], ran_labels(9, names, [HEAD_ROUTE_KERNEL[r] for r in routes])
        else:
            outs, kernels = [call() for call in calls], [""] * len(calls)
        for (ci, b, h, w, _, metric, x, params), got, kernel in zip(cases, outs, kernels):
            check(9, f"{name} B={b} ci={ci} {h}x{w} {'sigmoid' if metric else 'relu'}{kernel}", got,
                  ht.fused_head_tail_reference(x, *params, metric), (b, h, w), relative=True)
        del cases, calls, outs
        torch.cuda.empty_cache()
    times = {}
    f, ci = VITL["features_per_token"], VITL["fusion_channels"] // 2  # ViT-L's block and head tail
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for b in (1, 8):
            x, params = mlp_inputs(rng, (b, N_TOKENS, f), dtype)
            times[(8, dtype, b)] = timed_pair(smi, f"#8 {name} B={b} N={N_TOKENS} F={f} H={4 * f}",
                                              lambda: fm.fused_ln_mlp_residual(x, *params),
                                              lambda: fm.fused_ln_mlp_residual_reference(x, *params))
            if dtype == torch.bfloat16:
                stages = [fm.sm90_stage_ms(x, *params) for _ in range(5)]
                ln_ms, fc1_ms, fc2_ms = (statistics.median(t[i] for t in stages) for i in range(3))
                print(f"kernel stages #8 bfloat16 B={b} N={N_TOKENS} F={f} H={4 * f}: mlp_ln_sm90 {ln_ms:.4f} ms, "
                      f"mlp_fc1_sm90 {fc1_ms:.4f} ms, mlp_fc2_sm90 {fc2_ms:.4f} ms (CUDA events between the three "
                      f"launches of one call, median of 5) [{smi}]", flush=True)
            x, params = head_inputs(rng, b, ci, *OUT_HW, dtype)
            times[(9, dtype, b)] = timed_pair(smi, f"#9 {name} B={b} ci={ci} {OUT_HW[0]}x{OUT_HW[1]} relu",
                                              lambda: ht.fused_head_tail(x, *params), lambda: ht.fused_head_tail_reference(x, *params))
            del x, params
        torch.cuda.empty_cache()
    return {kid: {"max_abs_err": check.worst[kid], **dict(zip(("ms", "plain_ms", "library_ms"), times[(kid, torch.bfloat16, 8)]))}
            for kid in (8, 9)}


def capture(model, frames, blocks):
    """Run the model on a (B, H, W, 3) frame stack at the DA serving size
    and return the input of each listed block (a forward pre-hook) and of
    the head's tail (Head.tail wrapped for the run)."""
    net, got = model.net, {}
    hooks = [net.encoder.blocks[i].register_forward_pre_hook(lambda m, args, i=i: got.__setitem__(i, args[0])) for i in blocks]
    tail = net.head.tail
    net.head.tail = lambda x: tail(got.setdefault("head", x))
    try:
        model.inference_rgb_device(frames, OUT_HW)
        torch.cuda.synchronize()
    finally:
        del net.head.tail
        for hook in hooks:
            hook.remove()
    return got


def hold_on_model(smi, model, what, stacks, check, blocks=None, times=None) -> dict:
    """#8 against ``Block.mlp_residual`` of each listed block on the residual
    stream after that block's attention, and #9 against ``Head.tail`` on the
    head's own input, for each frame stack (B=1 and B=8). The kernels'
    launches are counted on their own (with every count zeroed first) and
    returned; each kernel output is then held against the plain version and
    the model's composite. ``times``: a dict to fill with CUDA-event times,
    kernel vs composite (block 11 and the head), in turns."""
    name, net = str(model.dtype)[6:], model.net
    blocks = TAP_BLOCKS if blocks is None else blocks
    launches = {"fused_mlp": 0, "fused_mlp_sm90": 0, "head_tail": 0, "head_tail_sm90": 0}
    with torch.inference_mode(), model._precision():  # f32: no TF32 in the composites' GEMMs and convs
        for frames in stacks:
            b = frames.shape[0]
            got = capture(model, frames, blocks)
            tokens = {i: net.encoder.blocks[i].attention_residual(got[i]) for i in blocks}
            head, hx = net.head, got["head"].contiguous()
            mlp_args = {}
            for i in blocks:
                blk = net.encoder.blocks[i]
                mlp_args[i] = (tokens[i], blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight, blk.mlp.fc1.bias,
                               blk.mlp.fc2.weight, blk.mlp.fc2.bias, blk.ls2)
            head_args = (hx, head.conv_mid.weight, head.conv_mid.bias, head.proj.weight, head.proj.bias, head.is_metric)
            torch.cuda.synchronize()
            fa.reset_launch_counts()  # count this path's launches only
            calls = [lambda i=i: fm.fused_ln_mlp_residual(*mlp_args[i]) for i in blocks]
            if model.dtype == torch.bfloat16:  # the sm_90 kernels: #8's three per call, #9's at the serving size
                mlp_outs, mlp_kernels = traced_launches(8, calls, [MLP_SM90_KERNELS] * len(blocks))
                out_head, kernel = sm90_launch(9, lambda: ht.fused_head_tail(*head_args))
            else:
                mlp_outs, mlp_kernels = [call() for call in calls], [""] * len(blocks)
                out_head, kernel = ht.fused_head_tail(*head_args), ""
            outs, mlp_kernels = dict(zip(blocks, mlp_outs)), dict(zip(blocks, mlp_kernels))
            torch.cuda.synchronize()
            counts = fa.launch_counts()
            mlp_route = MLP_ROUTES[model.dtype]
            route = "head_tail_sm90" if model.dtype == torch.bfloat16 else "head_tail"
            if counts != {**{r: 0 for r in counts}, mlp_route: len(blocks), route: 1}:
                raise RuntimeError(f"{what} B={b}: launches {counts}, want {len(blocks)} {mlp_route} and 1 {route}")
            for r in launches:
                launches[r] += counts[r]
            for i in blocks:
                label = f"{name} {what} B={b} block {i} rows={tokens[i].shape[0] * tokens[i].shape[1]}{mlp_kernels[i]}"
                check(8, label, outs[i], fm.fused_ln_mlp_residual_reference(*mlp_args[i]), tokens[i].shape, relative=True)
                check(8, label, outs[i], net.encoder.blocks[i].mlp_residual(tokens[i]), tokens[i].shape, relative=True,
                      composite=True)
            label = (f"{name} {what} B={b} head ci={hx.shape[1]} {hx.shape[2]}x{hx.shape[3]} "
                     f"{'sigmoid' if head.is_metric else 'relu'}{kernel}")
            shape = (b, *hx.shape[2:])
            check(9, label, out_head, ht.fused_head_tail_reference(*head_args), shape, relative=True)
            check(9, label, out_head, head.tail(hx), shape, relative=True, composite=True)
            if times is not None:
                i = blocks[len(blocks) // 2]
                times[(8, model.dtype, b)] = timed_pair(smi, f"#8 {name} {what} B={b} block {i} vs Block.mlp_residual",
                                                        lambda: fm.fused_ln_mlp_residual(*mlp_args[i]),
                                                        lambda: net.encoder.blocks[i].mlp_residual(tokens[i]))
                times[(8, "device", b)] = device_pair(smi, f"#8 {name} {what} B={b} block {i} vs Block.mlp_residual",
                                                      lambda: fm.fused_ln_mlp_residual(*mlp_args[i]),
                                                      lambda: net.encoder.blocks[i].mlp_residual(tokens[i]))
                # the kernel's host cost alone: the composite's 8 launches a call would fill the launch queue behind the spin
                times[(8, "host", b)] = host_pair(smi, f"#8 {name} {what} B={b} block {i}",
                                                  {"#8": lambda: fm.fused_ln_mlp_residual(*mlp_args[i])})
                times[(9, model.dtype, b)] = timed_pair(smi, f"#9 {name} {what} B={b} head vs Head.tail",
                                                        lambda: ht.fused_head_tail(*head_args), lambda: head.tail(hx))
            del got, tokens, mlp_args, outs, hx, head_args, out_head
            torch.cuda.empty_cache()
    print(f"{what} {name}: #8 held against blocks {blocks}, #9 against the head, at B={[f.shape[0] for f in stacks]}; "
          f"launches {launches}", flush=True)
    return launches


def frame_stacks():
    """One frame (B=1) and a batch of 8, RGB uint8 on the card."""
    rng = np.random.default_rng(SEED + 5)
    frames = torch.from_numpy(rng.integers(0, 256, (8, *FRAME_HW, 3), dtype=np.uint8)).to(DEVICE)
    return frames[:1], frames


def phase_da_v1(smi: str, ckpt: str, check: Checker, times: dict):
    """DA-V1 ViT-L: bf16 serving, f32 parity, then #8 and #9 held against its
    blocks and head (bf16 serving model, with times; f32 kernel model)."""
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    if model.net.encoder.taps != tuple(range(VITL["num_blocks"] - 4, VITL["num_blocks"])):
        raise RuntimeError(f"DA-V1: {ckpt} did not load as V1 (taps {model.net.encoder.taps})")
    fa.reset_launch_counts()  # count the path's run only
    depth, frame = serve(smi, model, MAX_SIDE, OUT_HW, "fused", VITL["num_blocks"], "DA-V1 ViT-L")
    flash = fa.flash_attention_fused_qkv.launches
    m_f32 = parity(ckpt, frame, MAX_SIDE, OUT_HW, "fused", VITL["num_blocks"], "DA-V1 ViT-L", depth)
    stacks = frame_stacks()
    launches = hold_on_model(smi, model, "DA-V1 ViT-L", stacks, check, times=times)
    del model
    torch.cuda.empty_cache()
    for r, n in hold_on_model(smi, m_f32, "DA-V1 ViT-L", stacks, check).items():
        launches[r] += n
    return flash, launches


def phase_metric(smi: str, ckpt: str, check: Checker):
    """DA-V2-metric ViT-L: bf16 serving, depth in [0, 1] (bf16 rounds a
    sigmoid above 1 - 2**-9 to 1), then one f32 request, depth strictly in
    (0, 1); #9 held against the (sigmoid) head of both models."""
    cfg, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    if not (cfg["is_metric"] and model.net.head.is_metric):
        raise RuntimeError(f"DA-V2-metric: {ckpt} did not load as a metric model")
    fa.reset_launch_counts()
    depth, frame = serve(smi, model, MAX_SIDE, OUT_HW, "fused", VITL["num_blocks"], "DA-V2-metric ViT-L")
    _, m_f32 = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE)
    d32 = m_f32.inference(frame, MAX_SIDE)
    ranges = [(float(d.min()), float(d.max()), float((d == 1).float().mean())) for d in (depth, d32)]
    print(f"DA-V2-metric ViT-L depth: bf16 in [{ranges[0][0]:.6f}, {ranges[0][1]:.6f}] ({ranges[0][2]:.2%} at 1.0), "
          f"f32 in [{ranges[1][0]:.6f}, {ranges[1][1]:.6f}]", flush=True)
    if not (0.0 <= ranges[0][0] <= ranges[0][1] <= 1.0 and 0.0 < ranges[1][0] <= ranges[1][1] < 1.0):
        raise RuntimeError(f"DA-V2-metric: depth outside the sigmoid's range: {ranges}")
    stacks = frame_stacks()
    launches = hold_on_model(smi, model, "DA-V2-metric ViT-L", stacks, check, blocks=())
    del model
    torch.cuda.empty_cache()
    for r, n in hold_on_model(smi, m_f32, "DA-V2-metric ViT-L", stacks, check, blocks=()).items():
        launches[r] += n
    return launches


def phase_giant(smi: str, ckpt: str):
    """DA-V2 ViT-Giant: bf16 serving (40 launches per forward) and f32 parity."""
    cfg, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    if not cfg["is_giant"] or cfg["num_heads"] != 24:
        raise RuntimeError(f"DA-V2 ViT-Giant: {ckpt} loaded as {cfg}")
    fa.reset_launch_counts()
    depth, frame = serve(smi, model, MAX_SIDE, OUT_HW, "fused", VITG["num_blocks"], "DA-V2 ViT-Giant")
    launches = fa.flash_attention_fused_qkv.launches
    int8 = model.quantize_encoder_int8()
    d_int8, _ = serve(smi, int8, MAX_SIDE, OUT_HW, "fused", VITG["num_blocks"], "DA-V2 ViT-Giant int8")
    (b1, b8), (i1, i8) = SERVED["DA-V2 ViT-Giant"], SERVED["DA-V2 ViT-Giant int8"]
    print(f"DA-V2 ViT-Giant int8 (default tier) vs bf16: {i8:.3f} vs {b8:.3f} ms per frame at B=8, {i1:.3f} vs {b1:.3f} ms "
          f"per request at B=1, abs-rel {_abs_rel(d_int8, depth):.3e} [{smi}]", flush=True)
    del model, int8
    torch.cuda.empty_cache()
    parity(ckpt, frame, MAX_SIDE, OUT_HW, "fused", VITG["num_blocks"], "DA-V2 ViT-Giant", depth)
    return launches


def true_attention_err(out, q, k, v) -> tuple[float, float]:
    """Max abs error of an int8-QK^T output against float32 attention on the
    same (B, N, H, D) q, k and v (no quantization; TF32 off), and that
    attention's max |output|."""
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    return float((out.float().reshape(ref.shape) - ref).abs().max()), float(ref.abs().max())


def check_int8(check, kid, label, got, ref, shape, qkv_views=None, gate=TRUE_ATTN_MAX_ERR, relative=False):
    """The int8 kernel against its plain version (kernel #1's gates, or
    #8/#9's relative ones on a model's slab), then, with ``qkv_views``
    ((B, N, H, D) q, k, v), against true attention: within ``gate`` for
    the synthetic cases, whose outputs stay below 1 in magnitude; with
    ``relative`` (a model's slab, outputs up to 5 and larger logits, so a
    larger int8 logit error) within ``gate`` times max(1, max |output|)."""
    check(kid, label, got, ref, shape, relative=relative)
    if qkv_views is not None:
        err, top = true_attention_err(got, *qkv_views)
        limit = gate * max(1.0, top) if relative else gate
        print(f"kernel check #{kid} {label} vs float32 attention: max_abs_err={err:.3e} (max|out|={top:.3e}, gate {limit:.3g})",
              flush=True)
        if not err < limit:
            raise RuntimeError(f"kernel #{kid} {label}: int8 attention off true attention by {err:.3e}")


def lossless_inputs(rng, g, n, dtype, step=0.02):
    """(G, N, 64) q, k on a grid of ``step`` with every row's max |entry| at
    127 steps (so they quantize exactly; in bf16 the step is 2^-6, which
    bf16 holds exactly), v N(0, 1)."""
    qi, ki = (rng.integers(-127, 128, (g, n, HEAD_DIM)).astype(np.float32) for _ in range(2))
    qi[:, :, 0], ki[:, :, 0] = 127, 127
    return (torch.from_numpy(a).to(DEVICE, dtype) for a in (qi * np.float32(step), ki * np.float32(step),
                                                            rng.standard_normal((g, n, HEAD_DIM), dtype=np.float32)))


INT8_ROUTES = {(7, torch.bfloat16): "int8_qk_fused_sm90", (7, torch.float32): "int8_qk_fused",
               (6, torch.bfloat16): "int8_qk_sm90", (6, torch.float32): "int8_qk"}  # the route each call must take
INT8_KERNELS = {torch.bfloat16: ("i8_pass_a", "i8_pass_b", "fa_i8_sm90"),  # the prologue's two, then the attention's
                torch.float32: ("i8_pass_a", "i8_pass_b", "fa_int8_f32")}


def int8_calls(kid, dtype, calls) -> tuple[list, list]:
    """Each of ``calls`` (one call of #kid's entry on ``dtype`` each), its
    launches counted and its kernels named (CUPTI): returns the outputs and,
    for the checks' labels, the kernels each ran, once every call counted
    one launch on the route its dtype must take and ran the prologue's two
    kernels and that route's attention kernel, in order."""
    route = INT8_ROUTES[(kid, dtype)]
    routes = [r for (k, _), r in INT8_ROUTES.items() if k == kid]
    outs, labels = traced_launches(kid, [lambda call=call: counted_route(call, routes) for call in calls],
                                   [INT8_KERNELS[dtype]] * len(calls))
    taken = [r for _, r in outs]
    if taken != [route] * len(calls):
        raise RuntimeError(f"kernel #{kid} {dtype}: the calls counted on {taken}, want {route}")
    return [out for out, _ in outs], labels


def check_prologue(kid, label, launch, plain):
    """The kernel prologue (``Int8Launch.run(STAGE_PROLOGUE)``) against the
    plain prologue's (q_i8, k_i8, alpha) by torch.equal. ``plain``: #7's
    ``quantize_fused`` ((B, N, H, D), alpha (B, N, H)) or #6's
    ``quantize_rows`` ((B H, N, D), alpha (B H, N))."""
    launch.run(fi8.STAGE_PROLOGUE)
    torch.cuda.synchronize()
    got = (launch.q_i8, launch.k_i8, launch.alpha.permute(0, 2, 1))
    if kid == 6:  # one head per (B H) row of the scratch
        got = tuple(t.squeeze(2) for t in got)
    differ = [int((a != b).sum()) for a, b in zip(got, plain[:3])]
    same = all(torch.equal(a, b) for a, b in zip(got, plain[:3]))
    print(f"prologue check #{kid} {label}: int8 q, int8 k and alpha equal to the plain prologue's: {same} (entries that "
          f"differ: {differ})", flush=True)
    if not same:
        raise RuntimeError(f"kernel #{kid} {label}: the prologue differs from the plain one in {differ} entries")


def phase_int8_kernels(smi: str) -> dict:
    """#6 and #7 against their plain versions and true attention, float32 and
    bfloat16: ragged N, all-negative logits, a zero q row, the lossless
    case, #6 past 32768 keys; on every case the kernel prologue equal to the
    plain one, each call counted on its route and its kernels named.
    Returns each kernel's worst error."""
    torch.backends.cuda.matmul.allow_tf32 = False  # true attention in true f32
    rng = np.random.default_rng(SEED + 7)
    check = Checker()
    scale = HEAD_DIM**-0.5
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for b, n in INT8_FUSED_CASES:
            qkv = make_qkv(rng, b, n, dtype)
            label = f"{name} B={b} N={n} H={HEADS}"
            check_prologue(7, label, fi8.prepare_int8_qk_fused(qkv, HEADS), fi8.quantize_fused(qkv, HEADS, scale))
            (got,), (ran,) = int8_calls(7, dtype, [lambda: fi8.flash_attention_int8_qk_fused(qkv, HEADS)])
            check_int8(check, 7, label + ran, got, fi8.flash_attention_int8_qk_fused_reference(qkv, HEADS),
                       (b, n, HEADS * HEAD_DIM), _split(qkv))
        qkv = make_qkv(rng, 2, 200, dtype, all_negative=True)
        check_prologue(7, f"{name} B=2 N=200 all-negative", fi8.prepare_int8_qk_fused(qkv, HEADS),
                       fi8.quantize_fused(qkv, HEADS, scale))
        (got,), (ran,) = int8_calls(7, dtype, [lambda: fi8.flash_attention_int8_qk_fused(qkv, HEADS)])
        check(7, f"{name} B=2 N=200 all-negative{ran}", got, fi8.flash_attention_int8_qk_fused_reference(qkv, HEADS),
              (2, 200, HEADS * HEAD_DIM))
        for g, n in INT8_ONLINE_CASES:
            q, k, v = (make_bias(rng, (g, n, HEAD_DIM), dtype) for _ in range(3))
            label = f"{name} BH={g} N={n}"
            check_prologue(6, label, fi8.prepare_int8_qk(q, k, v), fi8.quantize_rows(q, k, scale))
            (got,), (ran,) = int8_calls(6, dtype, [lambda: fi8.flash_attention_int8_qk(q, k, v)])
            views = None if n == N_ONLINE else tuple(t[:, :, None] for t in (q, k, v))  # N_ONLINE: plain only (17 GB logits)
            check_int8(check, 6, label + ran, got, fi8.flash_attention_int8_qk_reference(q, k, v), (g, n, HEAD_DIM), views)
            del q, k, v, got
        q, k, v = (make_bias(rng, (2, 200, HEAD_DIM), dtype) for _ in range(3))
        q, k = -8.0 * q.abs(), k.abs()
        q[:, 7] = 0.0  # a zero row: sq = 1e-12 / 127, q_i8 = 0, the uniform softmax
        label = f"{name} BH=2 N=200 all-negative, zero row 7"
        check_prologue(6, label, fi8.prepare_int8_qk(q, k, v), fi8.quantize_rows(q, k, scale))
        (got,), (ran,) = int8_calls(6, dtype, [lambda: fi8.flash_attention_int8_qk(q, k, v)])
        check(6, label + ran, got, fi8.flash_attention_int8_qk_reference(q, k, v), (2, 200, HEAD_DIM))
        mean_err = float((got[:, 7].float() - v.float().mean(dim=1)).abs().max())
        print(f"kernel check #6 {name} zero q row vs the mean of v: max_abs_err={mean_err:.3e}", flush=True)
        if not mean_err < (F32_MAX_ERR if dtype == torch.float32 else BF16_MAX_ERR):
            raise RuntimeError(f"kernel #6 {name}: a zero q row did not give the mean of v ({mean_err:.3e})")
        # views whose rows are not 16 bytes apart (and v 4 or 8 bytes off): the wrapper copies them first
        wide = make_bias(np.random.default_rng(SEED + 12), (3, 2, 200, HEAD_DIM + 2), dtype)
        q, k, v = wide[0, ..., :HEAD_DIM], wide[1, ..., :HEAD_DIM], wide[2, ..., 2:]
        label = f"{name} BH=2 N=200 views off 16-byte rows, copied"
        check_prologue(6, label, fi8.prepare_int8_qk(q, k, v), fi8.quantize_rows(q, k, scale))
        (got,), (ran,) = int8_calls(6, dtype, [lambda: fi8.flash_attention_int8_qk(q, k, v)])
        check_int8(check, 6, label + ran, got, fi8.flash_attention_int8_qk_reference(q, k, v), (2, 200, HEAD_DIM),
                   tuple(t[:, :, None] for t in (q, k, v)))
        torch.cuda.empty_cache()
    for dtype, step, gate in ((torch.float32, 0.02, LOSSLESS_MAX_ERR), (torch.bfloat16, 2**-6, BF16_MAX_ERR)):
        name = str(dtype)[6:]  # bf16: the sm_90 kernel, whose p, v and output round to bf16, so its gate is bf16's
        q, k, v = lossless_inputs(rng, 2, 256, dtype, step)
        check_prologue(6, f"{name} BH=2 N=256 lossless", fi8.prepare_int8_qk(q, k, v), fi8.quantize_rows(q, k, scale))
        (got,), (ran,) = int8_calls(6, dtype, [lambda: fi8.flash_attention_int8_qk(q, k, v)])
        check_int8(check, 6, f"{name} BH=2 N=256 lossless{ran}", got, fi8.flash_attention_int8_qk_reference(q, k, v),
                   (2, 256, HEAD_DIM), tuple(t[:, :, None] for t in (q, k, v)), gate=gate)
        qkv = torch.stack([q, k, v], dim=2).reshape(2, 256, 3 * HEAD_DIM)  # one head; #7 pre-scales q, still lossless
        check_prologue(7, f"{name} B=2 N=256 H=1 lossless", fi8.prepare_int8_qk_fused(qkv, 1), fi8.quantize_fused(qkv, 1, scale))
        (got,), (ran,) = int8_calls(7, dtype, [lambda: fi8.flash_attention_int8_qk_fused(qkv, 1)])
        check_int8(check, 7, f"{name} B=2 N=256 H=1 lossless{ran}", got, fi8.flash_attention_int8_qk_fused_reference(qkv, 1),
                   (2, 256, HEAD_DIM), tuple(t[:, :, None] for t in (q, k, v)), gate=gate)
    return {kid: check.worst[kid] for kid in (6, 7)}


def check_int_mm():
    """torch._int_mm on the card as ops/quant.py calls it: the (in, out)
    column-major view of an (out, in) int8 weight, exact against int64 on
    the host; and a short input padded to 17 rows changes no row."""
    rng = np.random.default_rng(SEED + 8)
    x = torch.from_numpy(rng.integers(-127, 128, (64, 1024), dtype=np.int8)).to(DEVICE)
    w = torch.from_numpy(rng.integers(-127, 128, (4096, 1024), dtype=np.int8)).to(DEVICE)
    exact = (x.cpu().long() @ w.cpu().long().t()).int()
    got = torch._int_mm(x, w.t())
    short = tq.int8_matmul(x[:5], w)
    ok = torch.equal(got.cpu(), exact) and torch.equal(short.cpu(), exact[:5])
    print(f"torch._int_mm on the card: (64, 1024) x the column-major view of a (4096, 1024) weight exact: {ok}; "
          "5 rows padded to 17 equal the unpadded rows", flush=True)
    if not ok:
        raise RuntimeError("torch._int_mm on the card disagrees with int64 on the host")


def int8_tier(model, tier: str, calibration_frames):
    opts = dict(INT8_TIERS[tier])
    calibrate = opts.pop("calibrate", False)
    return model.quantize_encoder_int8(calibration_images=calibration_frames if calibrate else None,
                                       max_side_length=MAX_SIDE if calibrate else None, **opts)


def capture_qkv(model, frames, blocks):
    """Run the model on a (B, H, W, 3) frame stack at the DA serving size
    and return each listed block's qkv projection output (a forward hook
    on its qkv layer, a QuantLinear in the int8+qkv tier)."""
    got = {}
    hooks = [model.net.encoder.blocks[i].attn.qkv.register_forward_hook(lambda m, args, out, i=i: got.__setitem__(i, out))
             for i in blocks]
    try:
        model.inference_rgb_device(frames, OUT_HW)
        torch.cuda.synchronize()
    finally:
        for hook in hooks:
            hook.remove()
    return got


def hold_int8_on_model(smi, model, check) -> tuple[dict, dict]:
    """#7 on the int8+qkv DA-V2 ViT-L's own qkv slabs at blocks 0, 11 and 23
    (B=8) and #6 on their (B H, N, D) copies: the launches counted on their
    own (every count zeroed first) and each call's kernels named, then each
    output against its plain version and true attention and each prologue
    against the plain one; on block 11's slab, CUDA-event and device times
    of the whole call, the prologue alone and the attention kernel alone,
    against the plain version, the plain prologue, kernel #1 and SDPA, and
    the host's cost per call of the entry and of SDPA. Returns (launches,
    numbers for the JSON entries)."""
    slabs = capture_qkv(model, frame_stacks()[1], TAP_BLOCKS)
    heads_first = {i: tuple(t.transpose(1, 2).reshape(-1, N_TOKENS, HEAD_DIM).contiguous() for t in _split(slab))
                   for i, slab in slabs.items()}
    torch.cuda.synchronize()
    fa.reset_launch_counts()  # count this path's launches only
    outs7, ran7 = int8_calls(7, torch.bfloat16, [lambda slab=slab: fi8.flash_attention_int8_qk_fused(slab, HEADS)
                                                 for slab in slabs.values()])
    outs6, ran6 = int8_calls(6, torch.bfloat16, [lambda i=i: fi8.flash_attention_int8_qk(*heads_first[i]) for i in slabs])
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    want = {**{r: 0 for r in counts}, "int8_qk_sm90": len(slabs), "int8_qk_fused_sm90": len(slabs)}
    if counts != want:
        raise RuntimeError(f"int8 attention on the model's slabs: launches {counts}, want {want}")
    scale = HEAD_DIM**-0.5
    for at, (i, slab) in enumerate(slabs.items()):
        label = f"bfloat16 DA-V2 ViT-L int8+qkv B=8 block {i} qkv slab"
        check_prologue(7, label, fi8.prepare_int8_qk_fused(slab, HEADS), fi8.quantize_fused(slab, HEADS, scale))
        check_int8(check, 7, label + ran7[at], outs7[at], fi8.flash_attention_int8_qk_fused_reference(slab, HEADS),
                   (slab.shape[0], N_TOKENS, HEADS * HEAD_DIM), _split(slab), relative=True)
        q, k, v = heads_first[i]
        check_prologue(6, f"{label}, (B H, N, D) copies", fi8.prepare_int8_qk(q, k, v), fi8.quantize_rows(q, k, scale))
        check_int8(check, 6, f"{label}, (B H, N, D) copies{ran6[at]}", outs6[at], fi8.flash_attention_int8_qk_reference(q, k, v),
                   q.shape, tuple(t[:, :, None] for t in (q, k, v)), relative=True)
    mid = TAP_BLOCKS[len(TAP_BLOCKS) // 2]
    slab, (q, k, v) = slabs[mid], heads_first[mid]
    sdpa = [t.transpose(1, 2) for t in _split(slab)]
    entries = {
        7: (f"#7 bf16 B=8 N={N_TOKENS} H={HEADS} model block {mid} slab", lambda: fi8.flash_attention_int8_qk_fused(slab, HEADS),
            lambda: fi8.flash_attention_int8_qk_fused_reference(slab, HEADS), lambda: F.scaled_dot_product_attention(*sdpa),
            fi8.prepare_int8_qk_fused(slab, HEADS), lambda: fi8.quantize_fused(slab, HEADS, scale)),
        6: (f"#6 bf16 BH={8 * HEADS} N={N_TOKENS} model block {mid} heads", lambda: fi8.flash_attention_int8_qk(q, k, v),
            lambda: fi8.flash_attention_int8_qk_reference(q, k, v),
            lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]), fi8.prepare_int8_qk(q, k, v),
            lambda: fi8.quantize_rows(q, k, scale)),
    }
    numbers = {}
    for kid, (what, entry, plain, library, launch, plain_prologue) in entries.items():
        ms, plain_ms, library_ms = timed_pair(smi, f"{what} (prologue + kernel)", entry, plain, library)
        device_ms, plain_device_ms, library_device_ms = device_pair(smi, f"{what} (prologue + kernel)", entry, plain, library)
        parts = {}
        for part, fn in (("prologue", lambda: launch.run(fi8.STAGE_PROLOGUE)), ("attention", lambda: launch.run(fi8.STAGE_ATTENTION)),
                         ("plain_prologue", plain_prologue)):
            parts[f"{part}_ms"], parts[f"{part}_device_ms"] = time_ms(fn), ft.device_ms(fn)
        print(f"{what}: the prologue alone {parts['prologue_ms']:.4f} ms per call, {parts['prologue_device_ms']:.4f} device; the "
              f"attention kernel alone {parts['attention_ms']:.4f} / {parts['attention_device_ms']:.4f}; the plain prologue "
              f"{parts['plain_prologue_ms']:.4f} / {parts['plain_prologue_device_ms']:.4f} [{smi}]", flush=True)
        host_us, library_host_us = host_pair(smi, what, {"kernel": entry, "SDPA": library})
        numbers[kid] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "device_ms": device_ms,
                        "plain_device_ms": plain_device_ms, "library_device_ms": library_device_ms, **parts,
                        "host_us": host_us, "library_host_us": library_host_us}
    flash = fa.flash_attention_fused_qkv
    t_flash, t_flash_device = time_ms(lambda: flash(slab, HEADS)), ft.device_ms(lambda: flash(slab, HEADS))
    print(f"same slab: kernel #1 (bf16 q, k) {t_flash:.4f} ms per call, {t_flash_device:.4f} device [{smi}]", flush=True)
    for kid in numbers:
        numbers[kid].update(flash_ms=t_flash, flash_device_ms=t_flash_device)
    launches = {6: counts["int8_qk_sm90"], 7: counts["int8_qk_fused_sm90"]}
    del slabs, heads_first, outs6, outs7
    torch.cuda.empty_cache()
    return launches, numbers


def phase_int8_da(smi: str, ckpt: str, check: Checker):
    """DA-V2 ViT-L's int8 tiers in bf16: each serves like the dense model (24
    launches of #1 per forward), with its times and its depth's abs-rel
    against the dense bf16 model; the f32 int8+qkv kernel model against the
    same model on the plain attention path; then #6 and #7 held against the
    int8+qkv model's own qkv slabs. Returns (launches, times)."""
    check_int_mm()
    _, dense = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    blocks = VITL["num_blocks"]
    d_dense, frame = serve(smi, dense, MAX_SIDE, OUT_HW, "fused", blocks, "DA-V2 ViT-L dense")
    rng = np.random.default_rng(SEED + 6)
    calibration = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(2)]
    rows, held = {"dense": (*SERVED["DA-V2 ViT-L dense"], 0.0)}, None
    for tier in INT8_TIERS:
        model = int8_tier(dense, tier, calibration)
        depth, _ = serve(smi, model, MAX_SIDE, OUT_HW, "fused", blocks, f"DA-V2 ViT-L {tier}")
        rows[tier] = (*SERVED[f"DA-V2 ViT-L {tier}"], _abs_rel(depth, d_dense))
        if tier == "int8+qkv":
            held = model
        del model
        torch.cuda.empty_cache()
    for tier, (b1, b8, rel) in rows.items():
        print(f"DA-V2 ViT-L bf16 {tier:>20}: {b1:.3f} ms per request at B=1, {b8:.3f} ms per frame at B=8, "
              f"abs-rel vs dense bf16 {rel:.3e} [{smi}]", flush=True)
    del dense
    torch.cuda.empty_cache()
    launches, times = hold_int8_on_model(smi, held, check)
    del held
    torch.cuda.empty_cache()
    int8_parity(ckpt, frame)
    return launches, times


def int8_parity(ckpt, frame):
    """The f32 int8+qkv model on kernel #1 against the same model on the
    plain attention path. Whole-model depth is not held to the 1e-3 budget:
    a float32 rounding difference that moves one activation across an int8
    rounding boundary changes that activation by a whole step, which moves
    the next block's activations across theirs, so the difference grows
    with depth to the size of the int8 error itself. So each block is run
    on the plain model's own input to that block (captured by forward
    pre-hooks), and its output is held to the budget; the whole-model
    difference is held below the int8 tier's own error against the f32
    dense model."""
    blocks = VITL["num_blocks"]
    models = {}
    for kernel in (True, False):
        _, m = make_dpt_from_state_dict(ckpt, dtype=torch.float32, device=DEVICE, enable_optimizations=kernel)
        models[kernel] = m.quantize_encoder_int8(include_qkv=True)
        if not kernel:
            d_dense = _counted(lambda: m.inference(frame, MAX_SIDE), "fused", 0, "DA-V2 f32 plain dense model")
        del m
    d_kernel = _counted(lambda: models[True].inference(frame, MAX_SIDE), "fused", blocks, "DA-V2 int8+qkv f32 kernel model")
    net = models[False].net
    inputs = {}
    hooks = [b.register_forward_pre_hook(lambda m, args, i=i: inputs.__setitem__(i, args[0])) for i, b in enumerate(net.encoder.blocks)]
    try:
        d_plain = _counted(lambda: models[False].inference(frame, MAX_SIDE), "fused", 0, "DA-V2 int8+qkv f32 plain model")
    finally:
        for hook in hooks:
            hook.remove()
    with torch.inference_mode(), models[True]._precision():
        per_block = [_abs_rel(models[True].net.encoder.blocks[i](x), net.encoder.blocks[i](x)) for i, x in sorted(inputs.items())]
    rel, rel_int8, worst = _abs_rel(d_kernel, d_plain), _abs_rel(d_plain, d_dense), max(per_block)
    print(f"DA-V2 ViT-L int8+qkv f32 kernel vs plain: each block on the plain model's input, worst mean abs-rel {worst:.3e} "
          f"(block {per_block.index(worst)}; budget {ABS_REL_BUDGET:g}); whole model {rel:.3e}, against the int8 tier's own "
          f"{rel_int8:.3e} (plain int8+qkv vs plain dense, f32)", flush=True)
    if not (worst <= ABS_REL_BUDGET and rel < rel_int8):
        raise RuntimeError(f"DA-V2 int8+qkv f32: kernel model vs plain model per block {worst:.3e}, whole {rel:.3e} "
                           f"(int8 error {rel_int8:.3e})")
    del models, inputs
    torch.cuda.empty_cache()


def serve_int8_once(smi, model, opts, side, out_hw, route, blocks, what, dense_depth, frame):
    """One B=1 request and one B=8 batch of ``model``'s int8 tier (``opts``):
    launches counted, shapes and finite values checked, the request's depth
    against the bf16 model's on the same frame, steady-state times."""
    q = model.quantize_encoder_int8(**opts)
    depth = _counted(lambda: q.inference(frame, side), route, blocks, f"{what} request")
    _check_depth(depth, (1, *out_hw), f"{what} request")
    stack = torch.from_numpy(np.stack([frame] * 8)).to(DEVICE)
    hw = q.compute_scaled_hw(FRAME_HW, side)
    batch = _counted(lambda: q.inference_rgb_device(stack, hw), route, blocks, f"{what} batch of 8")
    _check_depth(batch, (8, *out_hw), f"{what} batch of 8")

    def request():
        q.inference(frame, side)
        torch.cuda.synchronize()

    def per_batch():
        q.inference_rgb_device(stack, hw)
        torch.cuda.synchronize()

    b1, b8 = _host_ms(request, 5, 1), _host_ms(per_batch, 5, 1) / 8
    print(f"{what} bf16: request {(1, *out_hw)} and batch {(8, *out_hw)} finite, {blocks} {route} launches per forward, "
          f"abs-rel vs the bf16 model {_abs_rel(depth, dense_depth):.3e}; {b1:.3f} ms per request at B=1, {b8:.3f} ms per "
          f"frame at B=8 [{smi}]", flush=True)
    del q


def phase_ladder(smi: str, ckpt: str):
    """DA-V2 ViT-L bf16 serving one request at each max side of the long-N
    ladder (24 launches of #1 per forward, depth finite and square), with
    block 11's qkv slab taken on the way (``flash_tune.capture_slab``: the
    block's input by a forward pre-hook, then its norm1 and qkv layer) and
    ms per request; then the f32 kernel model against the f32 plain model at
    1428x1428 (N=10405; the plain attention in steps of q rows). Returns
    ({N: bf16 slab}, {side: ms per request})."""
    _, model = make_dpt_from_state_dict(ckpt, dtype=torch.bfloat16, device=DEVICE)
    frame = np.random.default_rng(SEED + 9).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    blocks = VITL["num_blocks"]
    slabs, request_ms, parity_depth = {}, {}, None
    for side, n in LADDER.items():
        fa.reset_launch_counts()
        slab, depth = _counted(lambda: ft.capture_slab(model, frame, side), "fused", blocks, f"DA-V2 ViT-L {side}x{side}")
        _check_depth(depth, (1, side, side), f"DA-V2 ViT-L {side}x{side}")
        if tuple(slab.shape) != (1, n, 3 * HEADS * HEAD_DIM) or slab.dtype != torch.bfloat16:
            raise RuntimeError(f"DA-V2 ViT-L {side}x{side}: block {ft.SLAB_BLOCK} qkv slab {tuple(slab.shape)} {slab.dtype}")
        slabs[n] = slab
        parity_depth = depth if side == LADDER_PARITY_SIDE else parity_depth

        def request():
            model.inference(frame, side)
            torch.cuda.synchronize()

        request_ms[side] = _host_ms(request, 5, 1)
        print(f"DA-V2 ViT-L bf16 {side}x{side} (N={n}): depth {tuple(depth.shape)} finite, {blocks} fused launches per "
              f"forward, {request_ms[side]:.3f} ms per request at B=1 (median of 5 after 1) [{smi}]", flush=True)
    del model
    torch.cuda.empty_cache()
    side = LADDER_PARITY_SIDE
    parity(ckpt, frame, side, (side, side), "fused", blocks, f"DA-V2 ViT-L {side}x{side}", parity_depth)
    torch.cuda.empty_cache()
    return slabs, request_ms


def check_ablation(check, kid, label, got, ref, shape):
    """An ablation (a timing floor, not an attention) against its plain
    version, not kept as the kernel's worst error: non-finite exactly where
    the plain version is (exponly's exp2 overflows past logit 128), and on
    the finite entries within #8/#9's relative gates: max error 1.6e-2 x
    max|plain| and mean 2e-3 x mean|plain| in bf16, 1e-4 x in f32."""
    torch.cuda.synchronize()
    finite = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), finite):
        raise RuntimeError(f"kernel #{kid} {label}: non-finite outputs where its plain version has none, or the reverse")
    if not bool(finite.all()):
        print(f"kernel check #{kid} {label}: {int((~finite).sum())} outputs overflow in both", flush=True)
        got, ref = got.masked_fill(~finite, 0), ref.masked_fill(~finite, 0)
    check(kid, label, got, ref, shape, relative=True, versus="its plain version (ablation: relative gates)")


def true_exp2_attention(q, k, v):
    """float32 attention with base-2 weights on (G, N, D) q (pre-scaled), k, v."""
    return fa.flash_attention_reference(q[:, :, None].float(), k[:, :, None].float(), v[:, :, None].float(),
                                        scale=math.log(2.0))[:, :, 0]


def check_variants(check, label, q_s, q_s2, k, v, relative=False):
    """#12 in every mode of the sweep against its plain version; each bf16
    launch held to fv_sm90 by name."""
    calls = [lambda kw=kw: fav.flash_variant(q_s if kw.get("mode") == "mask_exp" else q_s2, k, v, **kw)
             for _, kw in ft.VARIANT_CASES]
    if q_s.dtype == torch.bfloat16:  # every launch held to fv_sm90, in one trace
        outs, kernels = traced_launches(12, calls, [SM90_KERNEL[12]] * len(calls))
    else:
        outs, kernels = [call() for call in calls], [""] * len(calls)
    for (case, kw), got, kernel in zip(ft.VARIANT_CASES, outs, kernels):
        q = q_s if kw.get("mode") == "mask_exp" else q_s2
        ref = fav.flash_variant_reference(q, k, v, kw.get("mode", "padfix"), kw.get("chunk"))
        if kw.get("mode") in ("nosm", "maxonly", "exponly"):
            check_ablation(check, 12, f"{label} {case}{kernel}", got, ref, q.shape)
        else:
            check(12, f"{label} {case}{kernel}", got, ref, q.shape, relative=relative)


KNOWN_KERNELS = ("fv_f32", "fv_sm90", "fxl_sm90", "fst_sm90", "ht_sm90", "head_tail<", "mlp_ln_sm90", "mlp_fc1_sm90",
                 "mlp_fc2_sm90", "mlp_f32", "i8_pass_a", "i8_pass_b", "fa_i8_sm90", "fa_int8_f32")  # #6-#12's, as traced


CUPTI_API_DOMAIN = 1  # cupti_callbacks.h: the domain of CUDA's C API calls, cuLaunchKernel among them
CUPTI_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p)


def _cupti():
    """(libcupti, its subscriber, the callback, the list it fills): CUPTI's
    callback API subscribed once per process to CUDA's launch entry points
    (the cuLaunchKernel* family), enabled only inside ``device_kernels``. The callback keeps the
    kernel name (``symbolName``) of each cuLaunchKernel* call it sees.
    (torch.profiler's traces, which rest on CUPTI's activity API, lost
    every device event on an H100 once libraries had loaded or kernels
    had run between them.)"""
    if _cupti.state is None:
        import glob

        nvidia = os.path.join(os.path.dirname(os.path.dirname(torch.__file__)), "nvidia", "cuda_cupti", "lib")
        paths = [p for pattern in (os.path.join(nvidia, "libcupti.so*"), "/usr/local/cuda/lib64/libcupti.so*",
                                   "/usr/local/cuda/extras/CUPTI/lib64/libcupti.so*") for p in sorted(glob.glob(pattern))]
        if not paths:
            raise RuntimeError("libcupti not found: the kernels' name checks need CUPTI")
        lib = ctypes.CDLL(paths[0])
        lib.cuptiSubscribe.argtypes = [ctypes.c_void_p, CUPTI_CALLBACK, ctypes.c_void_p]
        lib.cuptiEnableDomain.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int]
        names = []

        def on_call(user, domain, cbid, data):  # CUpti_CallbackData: site at 0, functionName at 8, symbolName at 32
            if ctypes.c_int.from_address(data).value == 0:  # CUPTI_API_ENTER
                function = ctypes.c_char_p.from_address(data + 8).value or b""
                if function.startswith(b"cuLaunchKernel"):
                    names.append((ctypes.c_char_p.from_address(data + 32).value or b"?").decode())

        callback, subscriber = CUPTI_CALLBACK(on_call), ctypes.c_void_p()
        err = lib.cuptiSubscribe(ctypes.byref(subscriber), callback, None)
        if err != 0:
            raise RuntimeError(f"cuptiSubscribe failed: CUPTI error {err}")
        _cupti.state = (lib, subscriber, callback, names)
    return _cupti.state


_cupti.state = None


def device_kernels(fn):
    """fn()'s output and the names of the kernels it launched (its
    cuLaunchKernel* calls), in launch order, demangled (c++filt)."""
    lib, subscriber, _, names = _cupti()
    names.clear()
    torch.cuda.synchronize()
    err = lib.cuptiEnableDomain(1, subscriber, CUPTI_API_DOMAIN)
    if err != 0:
        raise RuntimeError(f"cuptiEnableDomain failed: CUPTI error {err}")
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        lib.cuptiEnableDomain(0, subscriber, CUPTI_API_DOMAIN)
    mangled = list(names)
    demangled = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    return out, demangled


def traced_launches(kid, calls, kernels):
    """Each of ``calls`` (one launch of kernel #kid each) with its kernel
    launches traced (``device_kernels``); returns their outputs and
    ``ran_labels``."""
    outs, names = device_kernels(lambda: [call() for call in calls])
    return outs, ran_labels(kid, names, kernels)


def ran_labels(kid, names, kernels) -> list:
    """For each check's label, the kernels each launch ran, once the traced
    ``names`` show that the launches ran ``kernels`` (per launch a kernel, or
    a tuple of the kernels it runs in order), in order, and no other kernel
    of ``KNOWN_KERNELS``."""
    per_launch = [(k,) if isinstance(k, str) else tuple(k) for k in kernels]
    want = [k for ks in per_launch for k in ks]
    ran = [name for name in names if any(k in name for k in KNOWN_KERNELS)]
    if len(ran) != len(want) or not all(k in name for k, name in zip(want, ran)):
        raise RuntimeError(f"kernel #{kid}: the launches ran {names}, want {want}")
    labels, at = [], 0
    for ks in per_launch:
        labels.append(" [" + ", ".join(kernel_label(k, name) for k, name in zip(ks, ran[at:at + len(ks)])) + "]")
        at += len(ks)
    return labels


def counted_route(fn, routes):
    """fn()'s output and the one of ``routes`` (``launch_counts`` keys) whose
    count fn() raised, by one."""
    before = fa.launch_counts()
    out = fn()
    after = fa.launch_counts()
    moved = {r: after[r] - before[r] for r in routes if after[r] != before[r]}
    if list(moved.values()) != [1]:
        raise RuntimeError(f"one launch counted on one of {list(routes)} expected, got {moved}")
    return out, next(iter(moved))


def kernel_label(kernel: str, name: str) -> str:
    """The part of a traced kernel's name that names it: ``kernel`` and its template arguments."""
    return re.search(re.escape(kernel.rstrip("<")) + r"(<[^>]*>)?", name).group(0)


def sm90_launch(kid, fn):
    """fn() (one launch of kernel #kid) traced; returns its output and, for
    the check's label, the kernel that ran, once the trace shows that the
    launch ran #kid's sm_90 kernel (``SM90_KERNEL``) once and no other
    kernel of ``KNOWN_KERNELS``."""
    (out,), (label,) = traced_launches(kid, [fn], [SM90_KERNEL[kid]])
    return out, label


def phase_sweep(smi: str, slabs: dict) -> tuple[dict, dict, float]:
    """The attention sweep on the ladder's slabs (``tools/flash_tune.py``):
    1. #1 against its plain version on every slab, bf16 and an f32 copy,
       and on an all-negative slab at N=2917;
    2. #10 in every case of the sweep and #11 at panels 1, 2, 4 and 8
       against their plain versions (#11 also against kernel #1's output)
       on the slabs at N=10405 and 18497 and at N=700 (pads straddling the
       key tiles; also at scale -0.3) and N=200 all-negative, bf16 and f32;
       each bf16 launch held to its sm_90 kernel (``sm90_launch``);
    3. #12 in every mode at ViT-L's (16, 1297, 64) and on the N=18497
       slab's heads, bf16 and f32; in the all-negative case mask_exp2
       against true attention, and padfix and chunk shown to fail;
    4. the path: every case of the sweep once on every slab, launches
       counted (every count zeroed first);
    5. the sweep's CUDA-event tables at every ladder N in bf16, #11's time
       beside its bound and its design floor, and #12's times at
       (16, 1297, 64).
    On the model's slabs the gates are relative (#8/#9's, as #6/#7 are held
    on the int8 model's slabs): outputs reach past 4, where one bf16 ulp
    exceeds the absolute 2e-2. Returns (numbers, launches) of #10-#12 and #1's worst
    error on the slabs."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in true f32
    rng = np.random.default_rng(SEED + 10)
    check = Checker()
    shape = lambda x: (x.shape[0], x.shape[1], HEADS * HEAD_DIM)  # noqa: E731
    for n, slab in slabs.items():
        for x in (slab, slab.float()):
            check(1, f"{str(x.dtype)[6:]} DA-V2 ViT-L block {ft.SLAB_BLOCK} slab N={n}", fa.flash_attention_fused_qkv(x, HEADS),
                  fa.flash_attention_fused_qkv_reference(x, HEADS), shape(x), relative=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        n = min(LADDER.values())
        x = make_qkv(rng, 1, n, dtype, all_negative=True)
        check(1, f"{name} B=1 N={n} all-negative", fa.flash_attention_fused_qkv(x, HEADS),
              fa.flash_attention_fused_qkv_reference(x, HEADS), shape(x))
        inputs = {f"DA-V2 ViT-L block {ft.SLAB_BLOCK} slab N={n}": slabs[n].to(dtype) for n in SWEEP_CHECK_N}
        inputs["B=2 N=700"] = make_qkv(rng, 2, 700, dtype)
        inputs["B=1 N=200 all-negative"] = make_qkv(rng, 1, 200, dtype, all_negative=True)
        for what, x in inputs.items():
            rel = what.startswith("DA-V2")  # a model slab: relative gates
            ref, out1 = fa.flash_attention_fused_qkv_reference(x, HEADS), fa.flash_attention_fused_qkv(x, HEADS)
            for case, kw in ft.XL_CASES:
                call = lambda kw=kw: fxl.flash_attention_fused_qkv_xl(x, HEADS, **kw)  # noqa: E731
                got, kernel = sm90_launch(10, call) if dtype == torch.bfloat16 else (call(), "")
                if kw.get("ablate_softmax"):
                    check_ablation(check, 10, f"{name} {what} {case}{kernel}", got, fxl.ablation_reference(x, HEADS), shape(x))
                else:
                    check(10, f"{name} {what} {case}{kernel}", got, ref, shape(x), relative=rel)
            for panels in (1, 2, 4, 8):
                call = lambda panels=panels: fst.flash_attention_fused_qkv_staged(x, HEADS, panels=panels)  # noqa: E731
                got, kernel = sm90_launch(11, call) if dtype == torch.bfloat16 else (call(), "")
                label = f"{name} {what} panels={panels}{kernel}"
                check(11, label, got, fst.flash_attention_fused_qkv_staged_reference(x, HEADS, panels=panels), shape(x),
                      relative=rel)
                check(11, label, got, out1, shape(x), relative=rel, versus="kernel #1's output")
            if what == "B=2 N=700":  # a negative scale: #10's and #11's max of -s (#11: its NEG instantiation)
                scale = -0.3
                ref_neg = fa.flash_attention_fused_qkv_reference(x, HEADS, scale=scale)
                negs = [(10, f"xl qp={qp} {'pipelined' if pipelined else 'seq'}", ref_neg, lambda qp=qp, pipelined=pipelined:
                         fxl.flash_attention_fused_qkv_xl(x, HEADS, scale=scale, qp=qp, pipelined=pipelined))
                        for qp, pipelined in ((1, True), (2, False), (4, True))]
                negs.append((11, "panels=2", fst.flash_attention_fused_qkv_staged_reference(x, HEADS, scale, panels=2),
                             lambda: fst.flash_attention_fused_qkv_staged(x, HEADS, scale=scale, panels=2)))
                for kid, case, want, call in negs:
                    got, kernel = sm90_launch(kid, call) if dtype == torch.bfloat16 else (call(), "")
                    check(kid, f"{name} {what} scale {scale} {case}{kernel}", got, want, shape(x))
                del ref_neg, negs
            del ref, out1
            torch.cuda.empty_cache()
        for what, x in ((f"(16, 1297, {HEAD_DIM})", make_qkv(rng, 1, N_TOKENS, dtype)),
                        (f"DA-V2 ViT-L slab N={SWEEP_CHECK_N[-1]} heads", slabs[SWEEP_CHECK_N[-1]].to(dtype))):
            vi = ft.variant_inputs(x)
            check_variants(check, f"{name} {what}", vi["q_s"], vi["q_s2"], vi["k"], vi["v"], relative=what.startswith("DA-V2"))
            del vi
            torch.cuda.empty_cache()
        # every logit far below 0: q > 0, k < 0, both scaled by 4 (q then by D^-0.5 log2(e))
        q, k, v = (make_bias(rng, (2, 200, HEAD_DIM), torch.float32) for _ in range(3))
        q = ((q.abs() + 0.5) * 4.0 * (HEAD_DIM**-0.5 * fa.LOG2E)).to(dtype)
        k, v = (-(k.abs() + 0.5) * 4.0).to(dtype), v.to(dtype)
        true = true_exp2_attention(q, k, v)
        cases = (("mask_exp2", {"mode": "mask_exp2"}), ("padfix", {"mode": "padfix"}), ("chunk=128", {"chunk": 128}))
        calls = [lambda kw=kw: fav.flash_variant(q, k, v, **kw) for _, kw in cases]
        if dtype == torch.bfloat16:  # the three launches held to fv_sm90, in one trace
            outs, kernels = traced_launches(12, calls, [SM90_KERNEL[12]] * len(calls))
        else:
            outs, kernels = [call() for call in calls], [""] * len(calls)
        got, kernel = outs[0], kernels[0]
        err = float((got.float() - true).abs().max())
        gate = ALL_NEGATIVE_MAX_ERR if dtype == torch.float32 else BF16_MAX_ERR
        print(f"kernel check #12 {name} G=2 N=200 all-negative mask_exp2{kernel} vs true attention: max_abs_err={err:.3e} "
              f"(gate {gate:g})", flush=True)
        if not err <= gate:
            raise RuntimeError(f"kernel #12 {name} mask_exp2 misses true attention by {err:.3e} with every logit negative")
        for (case, _), got, kernel in zip(cases[1:], outs[1:], kernels[1:]):
            err = float((got.float() - true).abs().max())
            print(f"kernel check #12 {name} G=2 N=200 all-negative {case}{kernel} vs true attention: max_abs_err={err:.3e}: the "
                  f"pad-count correction cancels (expected failure, above {EXPECTED_FAILURE} as required)"
                  if err > EXPECTED_FAILURE else f"{case}: {err:.3e}", flush=True)
            if not err > EXPECTED_FAILURE:
                raise RuntimeError(f"kernel #12 {name} {case}: the all-negative case did not fail ({err:.3e})")
    torch.cuda.synchronize()
    fa.reset_launch_counts()  # the path: every case of the sweep once per ladder slab
    for slab in slabs.values():
        ft.run_once(slab)
    counts = fa.launch_counts()
    launches = {10: counts["xl"], 11: counts["staged"], 12: counts["variant"]}
    want = {10: len(ft.XL_CASES) * len(slabs), 11: len(ft.STAGED_CASES) * len(slabs), 12: len(ft.VARIANT_CASES) * len(slabs)}
    if launches != want or counts["fused"] != len(slabs):
        raise RuntimeError(f"attention sweep path: launches {counts}, want {want} and {len(slabs)} fused")
    print(f"attention sweep path on the {len(slabs)} ladder slabs: launches #10 {launches[10]}, #11 {launches[11]}, "
          f"#12 {launches[12]}, #1 {counts['fused']}", flush=True)
    tables = {n: ft.sweep(slab, smi) for n, slab in slabs.items()}
    for n, table in tables.items():
        limit, floor = attention_bound(1, n, HEADS, HEAD_DIM), staged_floor_ms(1, n, HEADS, HEAD_DIM)
        print(f"#11 bf16 N={n} {ft.STAGED_DEFAULT}: {table[ft.STAGED_DEFAULT]:.4f} ms; bound {limit['bound_ms']:.4f} ms "
              f"({limit['bound_by']}); design floor {floor:.4f} ms (6 B H N^2 D over 989 TFLOP/s: pass 2 recomputes pass "
              f"1's QK^T); #10 {ft.XL_DEFAULT} {table[ft.XL_DEFAULT]:.4f} ms; SDPA {table[ft.SDPA]:.4f} ms [{smi}]", flush=True)
    top = tables[max(tables)]
    vi = ft.variant_inputs(make_qkv(rng, 1, N_TOKENS, torch.bfloat16))
    q, k, v = vi["q_s2"], vi["k"], vi["v"]
    calls = (lambda: fav.flash_variant(q, k, v), lambda: fav.flash_variant_reference(q, k, v),
             lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=math.log(2.0)))
    numbers = {
        10: (top[ft.XL_DEFAULT], top["#1 / #10 plain version"], top[ft.SDPA]),
        11: (top[ft.STAGED_DEFAULT], top["#11 plain version (panels=2)"], top[ft.SDPA]),
        12: timed_pair(smi, f"#12 bf16 (16, {N_TOKENS}, {HEAD_DIM}) padfix, per launch", *calls),
    }
    numbers = {kid: {"max_abs_err": check.worst[kid], **dict(zip(("ms", "plain_ms", "library_ms"), t))}
               for kid, t in numbers.items()}
    # #12's launch is short enough that the host's cost per call shows in its per-launch time: its device time and
    # host cost beside it, the host's split by the f32 route, which runs the same wrapper without tensor-map encodes
    device = device_pair(smi, f"#12 bf16 (16, {N_TOKENS}, {HEAD_DIM}) padfix, device time", *calls)
    numbers[12].update(zip(("device_ms", "plain_device_ms", "library_device_ms"), device))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    host = host_pair(smi, f"#12 (16, {N_TOKENS}, {HEAD_DIM}) padfix", {
        "bf16 (fv_sm90: three tensor-map encodes)": calls[0],
        "f32 (fv_f32: no encode)": lambda: fav.flash_variant(q32, k32, v32),
        "SDPA bf16": calls[2]})
    numbers[12].update(host_us=host[0], library_host_us=host[2])
    return numbers, launches, check.worst[1]


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def write_checkpoint(sd: dict, path: str) -> str:
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: bf16 operations over the dense
    bf16 peak, or bytes over HBM's rate, whichever is larger."""
    t_ops = ops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_bound(b, n, h, d, bias_elements=0) -> dict:
    """Attention's bound: 4 B H N^2 D operations (QK^T and PV); q, k and v
    read, out written, a bias's N x N read once."""
    return bound(4 * b * h * n * n * d, (4 * b * n * h * d + bias_elements) * 2)


def staged_floor_ms(b, n, h, d) -> float:
    """#11's design floor: its tensor-core work, 6 B H N^2 D operations
    (pass 1's QK^T, then QK^T again and PV), over the dense bf16 peak."""
    return 6 * b * h * n * n * d / PEAK_FLOPS[torch.bfloat16] * 1e3


def bounds() -> dict:
    """Each kernel's bound at the shape its JSON entry was timed at, all
    bf16, from shape arithmetic: every input read once, every output written
    once; attention 4 B H N^2 D operations (QK^T and PV); #6 and #7 half
    of them int8 (QK^T), the entry's bf16 inputs read and output written
    (``flash_attention_int8.int8_bound``, with the prologue's byte floor
    and the exp floor beside);
    #8 the two GEMMs, 4 rows F H; #9 the 3x3 conv and the projection,
    2 B H W 32 (9 ci + 1); #10 and #11 at N=18497, #12 at (16, 1297, 64)."""
    e = 2  # bytes per bf16 element

    nw, (wh, ww), sh, _ = SWIN_STAGES[0]
    a = wh * ww
    rows, f = 8 * N_TOKENS, VITL["features_per_token"]
    b, ci, (hh, hw) = 8, VITL["fusion_channels"] // 2, OUT_HW
    return {
        1: attention_bound(8, N_TOKENS, HEADS, HEAD_DIM),
        2: attention_bound(8, N_BEIT, HEADS, HEAD_DIM, HEADS * N_BEIT**2),
        3: {key: value for key, value in wa.window_bound(8, nw, a, sh, True).items() if key != "exp_floor_ms"},
        4: attention_bound(8, N_BEIT, HEADS, HEAD_DIM, HEADS * N_BEIT**2),
        5: attention_bound(1, N_ONLINE, 2, HEAD_DIM),
        6: fi8.int8_bound(8, N_TOKENS, HEADS),  # with the prologue's byte floor and the exp floor
        7: fi8.int8_bound(8, N_TOKENS, HEADS),
        8: bound(4 * rows * f * 4 * f, (2 * rows * f + 2 * f * 4 * f + 4 * f + 4 * f) * e),
        9: bound(2 * b * hh * hw * 32 * (9 * ci + 1), (b * ci * hh * hw + b * hh * hw + 32 * (9 * ci + 3) + 1) * e),
        10: attention_bound(1, max(LADDER.values()), HEADS, HEAD_DIM),  # the N=18497 slab, B=1
        11: attention_bound(1, max(LADDER.values()), HEADS, HEAD_DIM),  # the recompute pass is the kernel's, not the function's
        12: attention_bound(HEADS, N_TOKENS, 1, HEAD_DIM),  # (16, 1297, 64)
    }


def main() -> int:
    t0 = time.perf_counter()
    smi = timed("device", phase_device)
    timed("build", phase_build)
    numbers = timed("kernel checks and times", phase_kernel, smi)
    numbers.update(timed("fused MLP and head tail checks and times", phase_fused_kernels, smi))
    int8_worst = timed("int8-QK^T attention checks", phase_int8_kernels, smi)
    launches, check, composite = {}, Checker(), {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_checkpoint(random_original_depth_anything_state_dict(VITL, seed=SEED),
                                os.path.join(tmp, "depth_anything_v2_vitl_random.pth"))
        launches[1], depth, frame = timed("DA-V2 model", phase_da_model, smi, ckpt)
        m32 = timed("DA-V2 f32 parity", parity, ckpt, frame, MAX_SIDE, OUT_HW, "fused", VITL["num_blocks"], "DA-V2 ViT-L",
                    depth)
        captured = timed("DA-V2 capture", phase_capture, smi, m32, frame, MAX_SIDE, OUT_HW, "DA-V2 ViT-L", DA_ROUTES)
        del m32
        timed("experiments on DA-V2 ViT-L", phase_experiments, smi, ckpt, tmp)
        apps = timed("apps on DA-V2 ViT-L: run_image, run_video, run_3dviewer, depth_prediction", phase_apps, smi, ckpt,
                     tmp)
        apps["cache_s"] = timed("conversion cache on DA-V2 ViT-L", phase_conversion_cache, smi, ckpt, tmp)
        batch = timed("batch extraction and training on DA-V2 ViT-L", phase_batch_training, smi, ckpt, tmp)
        exported = timed("export on DA-V2 ViT-L: torch.export bf16 and f32, ONNX", phase_export, smi, ckpt, tmp)
        launches[1] += batch["launches"] + exported["launches"]  # #1's path: DA-V2 serving, run_batch and export
        slabs, ladder_ms = timed("DA-V2 ViT-L long-N ladder, f32 parity at 1428x1428", phase_ladder, smi, ckpt)
        sweep_numbers, sweep_launches, ladder_worst = timed("attention sweep on the ladder's slabs: #1, #10, #11, #12",
                                                            phase_sweep, smi, slabs)
        del slabs
        torch.cuda.empty_cache()
        int8_launches, int8_times = timed("DA-V2 int8 tiers, #6 and #7 on the int8+qkv model", phase_int8_da, smi, ckpt, check)
        metric = os.path.join(tmp, "depth_anything_v2_metric_hypersim_vitl_random.pth")
        os.replace(ckpt, metric)  # the same weights: only the file name makes the metric head
        head_launches = timed("DA-V2-metric model and #9 on its head", phase_metric, smi, metric, check)
        tp_ckpts = {"da": ckpt}  # the tensor-parallel phase's, kept until it has run
        os.replace(metric, ckpt)
        ckpt = write_checkpoint(random_beit_state_dict(BEIT_L512, seed=SEED), os.path.join(tmp, "dpt_beit_large_512_random.pt"))
        launches[2], depth, frame, err = timed("BEiT model", phase_beit_model, smi, ckpt)
        numbers[2]["max_abs_err"] = max(numbers[2]["max_abs_err"], err)
        m32 = timed("BEiT f32 parity", parity, ckpt, frame, BEIT_SIDE, BEIT_HW, "fused_biased", BEIT_L512["num_blocks"],
                    "BEiT-L-512", depth, (True, False))
        captured.update(timed("BEiT capture", phase_capture, smi, m32, frame, BEIT_SIDE, BEIT_HW, "BEiT-L-512",
                              BEIT_ROUTES, (True, False)))
        del m32
        apps["launches"]["fused_biased"] = timed("run_image on BEiT-L-512", phase_app_family, smi, ckpt, tmp,
                                                 "fused_biased", BEIT_L512["num_blocks"], "BEiT-L-512")
        export_launches, exported["BEiT-L-512 MB"] = timed("export on BEiT-L-512", phase_export_family, smi, ckpt, tmp,
                                                           BEIT_HW, "fused_biased", BEIT_L512["num_blocks"], "BEiT-L-512",
                                                           (True, False))
        launches[2] += export_launches
        tp_ckpts["beit"] = ckpt
        ckpt = write_checkpoint(random_swinv2_state_dict(SWIN_L384, seed=SEED), os.path.join(tmp, "dpt_swin2_large_384_random.pt"))
        launches[3], depth, frame = timed("SwinV2 model", phase_swin_model, smi, ckpt)
        m32 = timed("SwinV2 f32 parity", parity, ckpt, frame, SWIN_SIDE, SWIN_HW, "window", SWIN_BLOCKS, "SwinV2-L-384",
                    depth, (True, False))
        captured.update(timed("SwinV2 capture", phase_capture, smi, m32, frame, SWIN_SIDE, SWIN_HW, "SwinV2-L-384",
                              SWIN_ROUTES, (True, False)))
        del m32
        apps["launches"]["window_sm90"] = timed("run_image on SwinV2-L-384", phase_app_family, smi, ckpt, tmp,
                                                "window_sm90", SWIN_BLOCKS, "SwinV2-L-384")
        export_launches, exported["SwinV2-L-384 MB"] = timed("export on SwinV2-L-384", phase_export_family, smi, ckpt,
                                                             tmp, SWIN_HW, "window_sm90", SWIN_BLOCKS, "SwinV2-L-384")
        launches[3] += export_launches
        torch.cuda.empty_cache()
        tp_ckpts["swin"] = ckpt
        launches[4], launches[5] = timed("(B, N, H, D) op path", phase_bnhd_path, smi)
        ckpt = write_checkpoint(random_original_depth_anything_state_dict(VITL, seed=SEED + 1),
                                os.path.join(tmp, "depth_anything_vitl14.pth"))
        flash_v1, fused = timed("DA-V1 model, f32 parity, #8 and #9 on its layers", phase_da_v1, smi, ckpt, check, composite)
        os.remove(ckpt)
        ckpt = write_checkpoint(random_original_depth_anything_state_dict(VITG, seed=SEED),
                                os.path.join(tmp, "depth_anything_v2_vitg_random.pth"))
        flash_giant = timed("DA-V2 ViT-Giant model and f32 parity", phase_giant, smi, ckpt)
        os.remove(ckpt)
        tp = timed("tensor parallel: DA-V2 ViT-L, BEiT-L-512, SwinV2-L-384 over 2 gloo ranks on the card",
                   phase_tensor_parallel, smi, tp_ckpts, tmp)
        for kid in (1, 2, 3):
            launches[kid] += tp[kid]
    for kid in (6, 7):
        launches[kid] = int8_launches[kid]
        numbers[kid] = {"max_abs_err": max(int8_worst[kid], check.worst[kid]), **int8_times[kid]}
    mlp_routes = {r: fused[r] for r in ("fused_mlp_sm90", "fused_mlp")}
    launches[8] = sum(mlp_routes.values())
    head_routes = {r: fused[r] + head_launches[r] for r in ("head_tail_sm90", "head_tail")}
    launches[9] = sum(head_routes.values())
    print(f"flash launches on the DA-V1 and Giant paths: {flash_v1}, {flash_giant}; #8 launches on the DA-V1 path by "
          f"route: {mlp_routes}; #9 launches on the DA-V1 and DA-V2-metric paths by route: {head_routes}", flush=True)
    if mlp_routes["fused_mlp_sm90"] == 0 or head_routes["head_tail_sm90"] == 0:
        raise RuntimeError(f"an sm_90 kernel of #8 or #9 never launched on its path: {mlp_routes}, {head_routes}")
    for kid in (8, 9):
        numbers[kid]["max_abs_err"] = max(numbers[kid]["max_abs_err"], check.worst[kid])
        numbers[kid]["composite_ms"] = composite[(kid, torch.bfloat16, 8)][1]  # the model's own unfused layers
    # #8 on DA-V1 block 11 at B=8: device times (the host's cost per call left out) and host costs, kernel and composite
    numbers[8].update(zip(("device_ms", "composite_device_ms"), composite[(8, "device", 8)][:2]))
    numbers[8]["host_us"] = composite[(8, "host", 8)][0]
    numbers.update(sweep_numbers)
    launches.update(sweep_launches)
    numbers[1]["max_abs_err"] = max(numbers[1]["max_abs_err"], ladder_worst)
    print("DA-V2 ViT-L bf16 ms per request at B=1 on the ladder: "
          + ", ".join(f"{side}x{side} (N={LADDER[side]}) {ms:.3f}" for side, ms in ladder_ms.items()) + f" [{smi}]", flush=True)
    worst = max(captured, key=lambda k: captured[k]["worst_block"])
    print("capture, f32 B=1 ms (capture forward / kernel forward): "
          + ", ".join(f"{k} {v['capture_ms']:.3f} / {v['forward_ms']:.3f}" for k, v in captured.items())
          + f"; worst kernel block against the capture: {captured[worst]['worst_block']:.3e} ({worst}) [{smi}]", flush=True)
    video = apps["video"]
    print(f"apps: run_image {apps['run_image_ms']:.3f} ms per request; run_video -sync "
          f"{video['sync']['fps']:.2f} frames/s (recording on), dispatch-ahead {video['ahead']['fps']:.2f} frames/s, "
          f"host ms per dispatch {statistics.median(video['ahead']['host_ms']):.3f}; run_3dviewer "
          f"{apps['viewer_ms']:.3f} ms per /frame; DA-V2 ViT-L build {apps['cache_s']['plain']:.3f} s plain, "
          f"{apps['cache_s']['hit']:.3f} s from the conversion cache; launches from inside the apps by route "
          f"{apps['launches']} [{smi}]",
          flush=True)
    print(f"batch extraction: run_batch bf16 {batch['fps']:.2f} frames/s steady-state at B={BATCH_STEP} beside the "
          f"facade's {batch['facade_ms']:.3f} ms per frame, {batch['launches']} fused launches; DA-V2 ViT-L f32 train "
          f"step B={TRAIN_BATCH} at {OUT_HW[0]}x{OUT_HW[1]}: {batch['train_ms']:.1f} ms per step after the first "
          f"({batch['train_first_ms']:.1f}), peak {batch['train_peak_gib']:.2f} GiB [{smi}]", flush=True)
    print(f"export: DA-V2 ViT-L bf16 reloaded program {exported['program_ms']:.3f} ms per request at B=1 against the "
          f"live forward's {exported['live_ms']:.3f} (abs-rel {exported['bf16_rel']:.3e}, bit-equal "
          f"{exported['bf16_equal']}), artifact {exported['bf16_mb']:.1f} MB; f32 program vs plain {exported['f32_rel']:.3e}; "
          f"ONNX {exported['onnx_mb']:.1f} MB, evaluator {exported['onnx_s']:.1f} s, abs-rel {exported['onnx_rel']:.3e}; "
          f"BEiT-L-512 artifact MB by aux cached {exported['BEiT-L-512 MB']}, SwinV2-L-384 "
          f"{exported['SwinV2-L-384 MB']} [{smi}]", flush=True)
    if not all(apps["launches"].get(r, 0) > 0 for r in ("fused", "fused_biased", "window_sm90")):
        raise RuntimeError(f"an app never launched a serving kernel: {apps['launches']}")
    limits = bounds()
    kernels = [
        {
            "name": NAMES[kid],
            "route": "cuda",
            "source": f"muggled_dpt_tpu_torch/csrc/{SOURCES[kid]}.cu",
            "replaces": REPLACES[kid],
            "launches": launches[kid],
            **numbers[kid],
            **limits[kid],
        }
        for kid in NAMES
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise RuntimeError(f"a kernel of the paths never launched: {kernels}")
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
