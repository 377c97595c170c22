"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (each prints its results; any failure exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit, the
   TF32 switches (both off: dual-softmax and fine matching stay f32);
2. build: the hand-written CUDA kernels from ``nerfmatch_tpu_torch/csrc``;
3. kernel vs plain PyTorch version at the main path's shapes: the render
   stage (coarse and fine, bf16 trunk: ``render_eval.cu``'s kernel, its
   registers, spills and shared memory from the build) on 9216 rays of the
   room fixture at eps 0 and 1e-4 (at 1e-4 its zero weights against
   ``early_term_mask`` on the plain version's alpha), the resample on the
   coarse weights with the deterministic u and a stratified draw (each at
   1e-5 and rerun bit-identical, with its C entry alone (launches queued
   back to back on the device), the wrapper's host cost a call, and
   ``torch.searchsorted`` on a cdf and u of the same shapes as a yardstick
   of its lookup half), and attention at B=1, H=8,
   D=32, L=S=3600 in f32 and bf16-operand modes (the bf16 forward also
   against the one-pass plain version that rounds what the kernel rounds,
   its ``lse`` against ``torch.logsumexp``, and on earlier lines the
   kernel's time on operands already cast, the whole call's with the cast
   launch, and ``exp_bound_ms``); the bf16 fine stage of an appearance NeRF
   (the room's views layer with a seeded 16-column block, a seeded (2, 16)
   table, rays alternating between its rows) against its plain version,
   its weights, depth, acc, feat and pts bit-identical to the stage
   without the block, its time with and without ``app`` in turns; the bf16
   fine stage with ``feat_max`` (``feat_comb='max'``) against its plain
   version (weights, depth, acc, rgb within 5e-3 and bit-identical to the
   lin stage's; pts and feat by ``feat_max_agreement``: the rays whose two
   largest weights lie within the tie margin counted, the others' pts and
   feat within 5e-3, theirs the point of a near-tied sample), rerun
   bit-identical, timed beside the lin stage in turns, the lin outputs'
   digest; attention at the merged multi-pair layout (L = 3600, S =
   14,400; and L = S = 14,400) beside SDPA; and attention at head_dim 16,
   64 and 128 (B=1, H=8, L=S=3600: the other instantiations of
   ``attention.cu``), bf16 against the one-pass plain version and f32
   against the plain version, each timed, the bf16 call also as its C
   entry alone, beside SDPA, its bound and ``exp_bound_ms``, and every
   attention kernel's registers and spills from the build;
3b. the same for training: the train-render forward and backward kernels
   on 9216 rays at full width (the room's fine MLP, jittered z, density
   noise of std 1, loss rgb MSE + 0.01 distortion), rgb / weights and every
   gradient leaf against the plain version with its explicit backward, two
   backward calls bit-identical, and the backward's launches (stash
   forward, trunk backward, weight-gradient GEMM, reductions) timed in one
   ``torch.profiler`` pass beside the workspace bytes each moves and, for
   the GEMM, ``torch.mm`` on operands of the stash's shapes; then the same
   kernels with appearance rows (the room's fine MLP with phase 3's seeded
   16-column views block and (2, 16) table, rays alternating rows): rgb /
   weights, every gradient leaf, ``g_app`` and the appearance rows' weight
   gradient against the plain version, the backward rerun bit-identical,
   each pass timed with and without ``app`` in turns;
3c. the same for matcher training: the fused StarReLU + 7x7 depthwise conv
   (forward, dgrad, wgrad) at the c2f trunk's stage-0 and stage-1 shapes
   (2, 240, 240, 256) and (2, 60, 60, 512), the forward and dgrad also at
   batch 1 (serving), each beside cuDNN's depthwise conv alone
   (``conv_alone_ms``, no StarReLU), the wgrad's C entry alone
   (``kernel_ms``) beside its wrapper and cuDNN's depthwise weight
   gradient alone (``conv_wgrad_alone_ms``, no StarReLU; its stage-1 row
   under ``stage_1`` in the summary), and the attention backward at
   B=2, H=8, D=32, L=S=3600 in f32 and bf16-operand modes, timed as the
   training path calls it (the forward's output and ``lse`` handed in) and
   on its own (it casts and runs the forward kernel first); each backward
   rerun must be bit-identical; then the bf16 backward at merged multi-pair
   training's shapes (B=2, H=8; L = 3600, S = 14,400 and L = S = 14,400)
   against the plain backward taken a head at a time, beside its bound,
   ``exp_bound_ms`` and SDPA's backward; then the backward at head_dim
   16, 64 and 128 (B=2, H=8, L=S=3600, both modes, reruns bit-identical)
   against the plain backward, beside SDPA's backward and its bound;
3d. the same for the int8 serving trunk: activation scales calibrated from
   the first 1024 of 9216 rays of the room fixture, the int8 kernel's
   design, registers, spills and shared memory, then the int8 render stage
   (``render_eval.cu`` with s8 ``wgmma``: coarse, and the fine stage of
   ``'both'`` and ``'posttap'``) at eps 0 and 1e-4 against its plain
   version, with the share of integer activations that differ (< 1e-3),
   a rerun (bit-identical), its zero weights against ``early_term_mask``
   on the plain int8 version's alpha at 1e-4, the bf16 stage's time beside
   it, its bound, the fine stages of ``'both'`` and ``'posttap'`` with
   ``app`` as in phase 3, the fine stage of ``'posttap'`` with ``feat_max``
   as in phase 3, and the two-stage render of every int8 mode against the
   f32 plain render;
4. serving: the room NeRF (``pretrained/synthetic_room_nerf.npz``) with its
   int8 mode resolved as the serving paths resolve it (``'coarse'``: the
   config does not set ``render.trunk_int8``) and the production c2f
   matcher (random weights from a seed) localize three query photos (the
   port's own 480x480 renders on the room's camera circle) against scene
   points rendered at nearby database poses, through
   ``NeRFMatchEvaluator.eval_batch(iters=2, mutual=True)`` (the ConvFormer
   token mixers through the fused StarReLU + depthwise-conv kernel), plus one
   ``eval_bs=2`` request, then one request each at the opt-in
   ``trunk_int8`` values ``'posttap'`` and ``'none'`` (its scene points and
   matches against the default's), and request 0's matches with cuDNN's
   TF32 on against off (reported); the launch counters must show every
   kernel ran and the default requests on the int8 coarse stage; one
   request's matches are checked against the plain path on the CPU;
4b. iNeRF on the serving renderer and matcher at full width (one 480x480
   query, ds 8: 3600 rays, 128 + 128 samples, the 8x256 MLP): 30 steps
   scored on the pose from the ground truth turned by 2 deg and moved by
   0.05 (the loss and ``t_err`` must fall; per-step loss and errors, the
   step's time and the peak memory printed), two match-mode steps with the
   match loss (``inerf_refinement``), the counters showing one int8 coarse
   stage and one resample a step and the attention backward, then one step
   with the kernel half against its plain twin and against the JAX plain
   half (loss, gradient cosine, fine fenceposts), the same for the
   candidate half on kernel 1 (bf16, eps 0) against the JAX plain half, and
   three steps on an appearance NeRF made from the same weights;
5. training: a 24-frame 480x480 scene rendered from the room NeRF is
   written in the dataset's layout; ``cli.train_nerf --debug`` trains on it
   with ``configs/nerf/nerf_7scenes_mip_sfm.yaml`` (only the data paths and
   the output dir changed) and resumes; ``NerfTrainer`` then takes 50 steps
   of 9216 rays from a fresh initialization (loss must fall, PSNR rise);
   the launch counters must show the train kernels and the resample ran;
   the last checkpoint loads into a serving renderer that renders one ds-8
   scene-point grid through the eval kernels;
5b. PSNR: ``cli.eval_nerf`` in its PSNR mode (``--split test --img_wh 480
   480 --downsample 1 --save_depth``) on that checkpoint over 4 test
   frames: mean PSNR, seconds an image and the launches (25 bf16 coarse
   stages, 25 resamples, 25 bf16 fine stages an image), then one image's
   kernel render against the port's plain render of the same rays (rgb
   within 5e-3, both PSNRs);
5c. the same on an appearance checkpoint (phase 5's weights, the seeded
   block and table of phase 3) over a copy of the scene whose frames sit
   under two sequence folders: PSNR per sequence, the same pose's rgb
   moved by the id, a ``--cache_scene_pts`` run whose ``pt_feat`` and
   ``pt3d`` do not move with the id, and a ``'posttap'`` cache run (the int8
   fine stage with ``app``);
5d. appearance training: a two-sequence 480x270 scene rendered from the
   room NeRF (the second sequence at exposure 0.8) with sky and transient
   masks; ``cli.train_nerf --debug`` trains
   ``configs/nerf/nerf_cambridge_mip_app.yaml`` (only the data paths and
   the output dir changed) and resumes with the table's shape;
   ``NerfTrainer`` takes 30 timed steps of 9216 rays from a fresh
   initialization (the loss must fall, both table rows move, the counters
   show the ``_app`` train kernels and the resample); ``validate_pair`` on a
   retrieval-pair val sample; ``cli.eval_nerf``'s PSNR mode per sequence
   on the CLI's last checkpoint;
6. matcher training: a 24-frame room scene, its scene points cached through
   ``NerfEvaluator.cache_scene_pts`` (3600 points x 256-d per frame) and a
   pairs file; ``cli.train_nerfmatch --stage c2f --debug`` trains on it with
   ``configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml`` at full width (only
   the data paths, the output dir and ``exp.max_epochs: 2`` changed; no
   ImageNet weights in the repo, so the trunk trains from scratch) and
   resumes; one epoch of 20 CLI steps each with ``exp.num_workers`` 0 and 1
   times the loader's prefetch; 5 ``CoarseTrainStep`` steps on the coarse
   config; the c2f model then takes 100 steps of the coarse (unclamped)
   loss, after which the c2f's clamped coarse loss must send gradient to the
   trunk and the attention layers, then 30 timed ``C2FTrainStep`` steps at
   batch 2 (the loss on fixed match lists and the per-step coarse loss must
   fall), 3 profiled; the launch counters must show the attention,
   attention-backward and the three StarReLU + depthwise-conv kernels ran;
   then merged multi-pair training (``NeRFMatchMultiPair``, ``pair_topk:
   4``, ``sample_mode: rand``, ``sample_pts: 14400``): the CLI's debug epoch
   and its resume, and 10 timed ``C2FTrainStep`` steps at batch 2 (ms/step,
   peak memory, finite loss; the attention kernels' launches by (L, S):
   kernels 3 and 4 at S = 14,400, 4 each a step); 5 ``CoarseTrainStep``
   steps with ``pt_ftype='rand'`` and 5 ``C2FTrainStep`` steps with the
   ``convformer384_fpn`` backbone (its BatchNorm statistics must move);
   the last CLI checkpoint loads strictly into ``NeRFMatchEvaluator`` and
   localizes one request; the scene's points are also cached with
   ``feat_comb='max'`` (``ds8max``) at ``'coarse'`` and at ``'posttap'``
   (the share of points that moved against ``ds8lin``), and the NeRF saved
   with ``render.feat_comb: max``;
7. the localization benchmark: ``cli.benchmark_nerfmatch`` (its ``main``,
   in this process, so the launch counters see it) on phase 6's matcher
   checkpoint and cached room scene, with the room NeRF saved as a
   checkpoint for ``--nerf_path`` (``--iters 2 --mutual --rthres 10
   --eval_bs 2``): the metrics file under the reference's tag name, finite
   errors for every solved pose, and the int8 coarse stage in the
   re-render; then ``--inerf --inerf_optim 2``, ``--query2query``,
   ``--no_cache_pt`` and ``--retrieval_only``, the multi-pair protocols on
   the pairs file's 4 refs a query (``--pair_topk 4`` stacked, ``--pair_topk
   4 --sample_mode rand --sample_pts 14400`` merged, ``--pair_topk 2
   --match_oracle``, which runs no matcher; 6 queries each, ``--debug``)
   and ``--iters 2`` on the
   ``ds8max`` cache with the feat_comb='max' NeRF (the fine stage with
   ``feat_max`` in the re-render), and ``--inerf --inerf_optim 2
   --visualize --eval_bs 2 --debug`` (a GIF of ``inerf_optim`` overlay
   frames for each of the 6 queries over 50 cm), each with its tag-named
   file of one row a query and the kernels its path launches (the attention
   launches by key count: the merged run's at S = 14,400);
8. the NeRF variants the kernels do not cover, and multi-scene training, at
   the 7-Scenes config's full width: (8a) the config with
   ``embedding.type: normal`` and ``render.use_viewdirs: False`` (the
   classic NeRF, rendered by no kernel in either package) through
   ``cli.train_nerf --debug`` (20 steps) and its resume, 10 timed steps
   (ms, peak memory; the loss falls) and ``cli.eval_nerf``'s PSNR mode on
   2 frames, with the logged route ``plain`` and kernels 1, 1b, 2, 5 and 6
   at 0 launches over the whole part; (8b) the mip config with
   ``data.out_scr: True``: the CLI (the plain route, kernels 5 and 6 at 0)
   and its resume, 10 timed steps, ``scr_fine`` finite, then the
   checkpoint's scene points cached at the serving default through kernels
   1b, 2 and 1, within 5e-3 of the same weights' without the head, each
   cache timed; (8c) in phase 6's scene dir, a second room scene at other
   poses beside the first and ``data.scenes: [room_a, room_b]``:
   ``cli.train_nerfmatch --stage c2f --debug`` and its resume, 10 timed
   c2f steps at batch 2 on batches of one sample of each scene (ms, peak
   memory; the launches a step of kernels 3, 4 and 7-9 equal to phase 6's
   step), 2 steps on a ``data.datasets`` mixed config of the two, and
   ``benchmark_nerfmatch --iters 2`` with the CLI's checkpoint over both
   scenes (two queries each); (8d) the kernel summary's rows of kernels 1,
   1b, 2, 3, 4 and 7-9 carry phase 8's launches (``launches_phase8``);
9. the parallel package: (9a) ``cli.train_nerf --debug --max_epochs 1`` on
   a room scene under the ``NERFMATCH_*`` contract at world size 1 (an NCCL
   group: backend, world and ``gpu_num`` asserted; kernels 5, 6 and 2
   counted), then one ``NerfTrainer`` step with the group against the same
   step without one, bit for bit; (9b) this script started twice more as
   two gloo ranks on cuda:0 (``--phase9-rank``; killed past
   ``PHASE9_RANK_TIMEOUT_S``): 3 full-width NeRF steps on halves of 9216
   room rays and 2 production c2f steps on one pair each of a batch whose
   pairs hold 900 and 300 GT matches, held to this process's steps over
   the whole batches (``PHASE9_LOSS_RTOL``, ``PHASE9_UPDATE_COS``), with
   each rank's ms a step and peak memory, and the same c2f steps with
   per-rank loss normalizers as a control that must fail those limits;
   (9c) on a mesh of ``[cuda:0, cuda:0]`` (``scripts/dp_nccl_probe.py``
   runs it over every GPU of a host): ``sharded_point_match`` and
   ``eval_match_point_sharded`` of the production c2f matcher at 3600
   image tokens x 14,400 points, and ``forward_multi_pair(pair_mesh=)`` at
   K = 4 and 3, each with valid and j_ids identical to the dense path,
   mconf within 1e-6 and expec_f within 1e-5; ``make_sharded_render`` on
   9216 room rays at the serving default bit-identical to
   ``fused_predict``; the kernel rows carry phase 9's launches
   (``launches_phase9``);
10. the end-to-end accuracy path: ``e2e.pipeline.run`` on the enclosed
   synthetic scene (a 128x128 ball inside a textured shell, 24 training
   and 6 query views; the ladder's frustum depth, 6) at a short budget
   (``E2E_NERF_EPOCHS`` NeRF and
   ``E2E_MATCH_EPOCHS`` matcher epochs), to the end on the card: the NeRF
   trained at full width (kernels 5, 6, 2) and its held-out PSNR, the
   scene points cached at the serving default ``'coarse'`` (1b, 2, 1),
   Mini, Full warm-started from Mini's ``best`` checkpoint (the
   ``convformer`` trunk, whose widths pass the gate of kernels 7-9; 3 and
   4 at the e2e matcher's head width 8, on their 16-wide instantiation),
   and the 12 query pairs localized single-shot, with the Full model,
   with ``--iters 2`` and with iNeRF; the summary (stage times, PSNR,
   medians, match counts, recall at 5 deg / 0.05) is printed, the medians
   must be finite, Full's warm start Mini's ``best``, and kernels 1, 1b, 2,
   3, 4, 5, 6, 7, 8 and 9 launched (``launches_phase10`` on their rows);
   then the attention at head_dim 8 against its plain version, one launch
   a pass, forward and backward timed beside SDPA and their bounds, the
   forward also as its C entry alone (the ``attention`` row's
   ``e2e_head_dim8``);
11. a hid-128 NeRF end to end (``phase_hid128``): the 7-Scenes config
   with ``hid_dim`` 128 in both stages, ``train_nerf --debug`` for 5 epochs
   of 10 steps on phase 5's room scene, 50 timed steps (ms a step, peak
   memory after a reset), its scene points for the scene's 24 frames at
   the serving int8 default and one 480x480 request localized by
   ``eval_batch(iters=2)`` with a c2f matcher (random weights, seed 0)
   of ``pt_dim`` 128; launches of kernels 1, 1b, 2, 5, 6 all above 0.

Phases 3, 3d and 3b also hold the render kernels at the MLP widths
``WIDTH_ROWS`` (32, 96, 128, 192; 32 and 96 run zero-padded at 64 and
128) to their plain versions on the room's 9216 rays x 128 samples with
seeded random weights (the rows' ``widths``: kernel 1 coarse and fine,
1b coarse and fine ``'posttap'``, 5 with its stash, 6, each with its
bound on the real width's operations, 5 and 6 with ``torch.mm`` over the
same products, 1b with ``pack_fused``'s host ms), and kernels 1 and 5-6
at the widest encoding the JAX kernels take (F = 21, Fd = 18, appearance
rows; ``wide_encoding``).

Each kernel's line gives its bound: the larger of the bytes it must move
(inputs read once, outputs written once) over 3.35 TB/s and its matrix
operations over the H100's published peak for their type (989 TFLOP/s
bf16, 1,979 TOP/s int8, 67 TFLOP/s f32 outside the tensor cores), for this
run's inputs (the render stages count only the sample blocks early
termination leaves), and ``library_ms``, the time of one PyTorch call
computing the same function where there is one
(``scaled_dot_product_attention`` for the attention forward and its
autograd backward; none for the others).  The attention rows' lines also
give ``exp_bound_ms``, the least time of their base-2 exponentials on the
special-function units (at head_dim 32 it exceeds the tensor-core time).
The resample's ``launches`` are phase 4's, ``launches_training`` phase
5's; ``launches_inerf`` is phase 4b's count where it launched the kernel;
``render_fine_app``'s are phase 5c's PSNR run, ``render_fine_int8_app``'s
its ``'posttap'`` cache run, the ``render_train_*_app`` rows' phase 5d's 30
timed steps, ``render_fine_max``'s phase 7's ``--iters 2`` run on the
``ds8max`` cache, ``render_fine_int8_max``'s phase 6's ``'posttap'`` max
cache; the attention row's ``merged`` entry (S = 14,400) carries the
merged run's launches at that S as ``launches_multipair``; its
``merged_train`` entries and each row of ``attention_bwd``'s ``merged``
list carry phase 6's launches a merged training step at that shape
(``launches_train_per_step``), and ``attention_bwd``'s
``merged_train_step`` the step's ms and peak memory; ``launches_phase11``
is phase 11's count, and ``render_train_fwd``'s ``phase11_hid128`` its
summary.  The last two lines are the kernel summary and ``{"ok": true,
...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

KERNEL_SOURCES = {
    "render_coarse": ("nerfmatch_tpu_torch/csrc/render_eval.cuh",
                      "nerfmatch_tpu/ops/pallas/render_kernel.py:1032"),
    "render_fine": ("nerfmatch_tpu_torch/csrc/render_eval.cuh",
                    "nerfmatch_tpu/ops/pallas/render_kernel.py:1032"),
    "render_coarse_int8": ("nerfmatch_tpu_torch/csrc/render_eval.cuh",
                           "nerfmatch_tpu/ops/pallas/render_kernel.py:563"),
    "render_fine_int8": ("nerfmatch_tpu_torch/csrc/render_eval.cuh",
                         "nerfmatch_tpu/ops/pallas/render_kernel.py:563"),
    # The fine stages of an appearance NeRF: the same kernel with each ray's
    # appearance row (the Pallas kernel's app operand, render_kernel.py:455).
    "render_fine_app": ("nerfmatch_tpu_torch/csrc/render_eval.cuh",
                        "nerfmatch_tpu/ops/pallas/render_kernel.py:1032"),
    "render_fine_int8_app": ("nerfmatch_tpu_torch/csrc/render_eval.cuh",
                             "nerfmatch_tpu/ops/pallas/render_kernel.py:563"),
    # The fine stages with feat_comb='max' (the Pallas kernel's feat_max
    # branch, render_kernel.py:716-735 and :772-775).
    "render_fine_max": ("nerfmatch_tpu_torch/csrc/render_eval.cuh",
                        "nerfmatch_tpu/ops/pallas/render_kernel.py:1032"),
    "render_fine_int8_max": ("nerfmatch_tpu_torch/csrc/render_eval.cuh",
                             "nerfmatch_tpu/ops/pallas/render_kernel.py:563"),
    "resample": ("nerfmatch_tpu_torch/csrc/resample.cu",
                 "nerfmatch_tpu/ops/pallas/resample_kernel.py:82"),
    "attention": ("nerfmatch_tpu_torch/csrc/attention.cu",
                  "nerfmatch_tpu/ops/pallas/attention_kernel.py:99"),
    "render_train_fwd": ("nerfmatch_tpu_torch/csrc/render_train.cuh",
                         "nerfmatch_tpu/ops/pallas/render_train.py:420"),
    "render_train_bwd": ("nerfmatch_tpu_torch/csrc/render_train.cuh",
                         "nerfmatch_tpu/ops/pallas/render_train.py:455"),
    # The train stages of an appearance NeRF: the same kernels with each
    # ray's appearance row in (extras, render_train.py:201) and its
    # cotangent out (extras_grad, render_train.py:303-312).
    "render_train_fwd_app": ("nerfmatch_tpu_torch/csrc/render_train.cuh",
                             "nerfmatch_tpu/ops/pallas/render_train.py:420"),
    "render_train_bwd_app": ("nerfmatch_tpu_torch/csrc/render_train.cuh",
                             "nerfmatch_tpu/ops/pallas/render_train.py:455"),
    "attention_bwd": ("nerfmatch_tpu_torch/csrc/attention.cu",
                      "nerfmatch_tpu/ops/pallas/attention_kernel.py:184"),
    "dw_star_fwd": ("nerfmatch_tpu_torch/csrc/sepconv.cu",
                    "nerfmatch_tpu/ops/pallas/sepconv_kernel.py:133"),
    "dw_star_dgrad": ("nerfmatch_tpu_torch/csrc/sepconv.cu",
                      "nerfmatch_tpu/ops/pallas/sepconv_kernel.py:198"),
    "dw_star_wgrad": ("nerfmatch_tpu_torch/csrc/sepconv.cu",
                      "nerfmatch_tpu/ops/pallas/sepconv_kernel.py:268"),
}
# What the bf16 render stages run since their redesign (kernel line's
# "design").
RENDER_EVAL_DESIGN = ("wgmma m64nHIDk16, persistent grid of two warpgroups, "
                      "one 2-ray tile per warpgroup with early termination, "
                      "32-row weight slices by bulk copy in a ring, tap "
                      "layer run again on its kept A for the descriptor")
# What the int8 render stages run since their redesign: the same engine.
INT8_EVAL_DESIGN = ("render_eval.cu's engine with the trunk from int8_from on "
                    "s8 wgmma m64nHIDk32 (K-major s8 slot images, 64 rows a "
                    "slot, in the same ring), A packed from the s32 "
                    "accumulator by a host-side row permutation, the "
                    "post-skip layer's encoding rows 64 columns at a time "
                    "into a second accumulator, unfused f32 epilogue")
# What the resample runs since its redesign.
RESAMPLE_DESIGN = ("16 lanes a ray (two rays a warp, one wave at 9216 rays), "
                   "each weight loaded once into registers, blur neighbours "
                   "by shuffles, chunk sums + butterfly weight sum, shuffle "
                   "scan of the cdf into 1 KB of shared memory a ray, an "
                   "unrolled 8-step binary search a bin")
# The serving default (trunk_int8='coarse'), then the opt-in requests'.
SERVING_KERNELS = ("render_coarse_int8", "render_fine", "resample",
                   "attention", "dw_star_fwd")
OPT_IN_KERNELS = ("render_fine_int8", "render_coarse")
MATCH_KERNELS = ("attention", "attention_bwd", "dw_star_fwd", "dw_star_dgrad",
                 "dw_star_wgrad")
TRAIN_KERNELS = ("render_train_fwd", "render_train_bwd", "resample")
# Phase 7's single-query protocols: flags, the reference's result-file tag,
# the kernels each must launch (--retrieval_only renders and matches
# nothing, nor does the match oracle: PnP on conf_gt); then the multi-pair
# ones on the pairs file's 4 refs a query (stacked; merged to 14,400
# points; the oracle), cut to 6 queries each by --debug (a query's sample
# holds a dense (3600, 4 x 3600) conf_gt: ~0.4 s of host time to build),
# and --iters 2 on the ds8max cache with a NeRF whose
# config sets feat_comb: max ({max_dir}, {max_nerf}: phase 6's; its own
# --cache_tag, since the scene dir is not in the tag).
BENCH_PROTOCOLS = (
    (["--inerf", "--inerf_optim", "2"], "_itr1ds8inerf2lr0.001match",
     ("render_coarse_int8", "resample", "attention", "dw_star_fwd")),
    (["--query2query"], "_itr1.query2query",
     ("render_coarse_int8", "render_fine", "resample", "attention")),
    (["--no_cache_pt"], "_itr1_nocache",
     ("render_coarse_int8", "render_fine", "resample", "attention")),
    (["--retrieval_only"], "_IR_itr1", ()),
    (["--pair_topk", "4", "--debug"], "_itr1_top4pt-1.debug",
     ("attention", "dw_star_fwd")),
    (["--pair_topk", "4", "--sample_mode", "rand", "--sample_pts", "14400",
      "--debug"], "_itr1_top4pt14400.debug", ("attention", "dw_star_fwd")),
    (["--pair_topk", "2", "--match_oracle", "--debug"],
     "_itr1_top2pt-1.match_oracle.debug", ()),
    (["--iters", "2", "--eval_bs", "2", "--scene_dir", "{max_dir}",
      "--nerf_path", "{max_nerf}", "--cache_tag", "max"], "_itr2",
     ("render_coarse_int8", "render_fine_max", "resample", "attention",
      "dw_star_fwd")),
    # The failure cases' iNeRF GIFs (bs=1 whatever --eval_bs says), 6
    # queries.
    (["--inerf", "--inerf_optim", "2", "--visualize", "--eval_bs", "2",
      "--debug"], "_itr1ds8inerf2lr0.001match.debug",
     ("render_coarse_int8", "resample", "attention", "dw_star_fwd")),
)
MERGED_S = 14400
# Merged multi-pair training's attention shapes (L, S) at S = 14,400: the
# image's queries over the points (the coarse former), the points' self
# attention (pt_sa); the points' queries over the image (S = 3600) ride
# along.
MERGED_TRAIN_SHAPES = ((3600, MERGED_S), (MERGED_S, MERGED_S))
CAM_R, NEAR, FAR = 0.8, 0.05, 2.1        # scripts/train_bench_scene.py
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# H100 SXM data sheet (dense): memory rate and peak rates by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def log(msg):
    print(msg, flush=True)


def bound(ops, nbytes):
    """-> dict(bound_ms, bound_by): the larger of ``nbytes`` over the memory
    rate and ``ops`` ({operand type: operations}) over the peaks."""
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def stage_macs(mlp, fine, int8_from=None):
    """Multiply-adds per sample of a render stage's matrix products by
    operand type: trunk layers from ``int8_from`` on int8, the others and
    the fine stage's feature / views / rgb heads bf16, the sigma head f32."""
    start = mlp.cfg.layer_num if int8_from is None else int8_from
    macs = {"bf16": 0, "int8": 0, "f32": mlp.alpha_linear.in_features}
    for i, lin in enumerate(mlp.pts_linears):
        macs["int8" if i >= start else "bf16"] += lin.weight.numel()
    if fine:
        macs["bf16"] += sum(lin.weight.numel() for lin in (
            mlp.feature_linear, mlp.views_linears[0], mlp.rgb_linear))
    return macs


def live_samples(weights, eps):
    """Samples outside the blocks the render kernel skips at ``eps``
    (``early_term_mask``): the transmittance entering a block is 1 minus the
    weights before it, which the kernel's own output gives exactly up to
    the first skipped block."""
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (SAMPLE_BLOCK,
                                                               TILE_RAYS)

    n, S = weights.shape
    blk = weights.reshape(n, S // SAMPLE_BLOCK, SAMPLE_BLOCK).sum(-1)
    t_in = 1.0 - (torch.cumsum(blk, -1) - blk)
    dead = (t_in < eps).reshape(n // TILE_RAYS, TILE_RAYS, -1).all(1)
    dead[:, 0] = False
    dead = torch.cummax(dead.int(), -1).values.bool()
    return int((~dead).sum()) * TILE_RAYS * SAMPLE_BLOCK


def weight_tensors(packed):
    """The tensors of a packed weight list, each once (the bf16 kernel's
    encoding flags are views into its slot images)."""
    seen, out = set(), []
    for p in packed:
        if p is not None and p.untyped_storage().data_ptr() not in seen:
            seen.add(p.untyped_storage().data_ptr())
            out.append(p)
    return out


def render_bound(mlp, fine, rays, z, out, eps, weight_bytes, int8_from=None):
    """Bound of one render stage on this run's inputs and outputs."""
    live = live_samples(out["weights"], eps) if eps > 0 else out["weights"].numel()
    ops = {k: 2 * m * live for k, m in stage_macs(mlp, fine, int8_from).items()}
    return bound(ops, nbytes(rays, z, *out.values()) + weight_bytes)


def cuda_ms(fn, reps=10):
    """Mean device time of ``fn()`` in ms (CUDA events, after warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_alone_ms(launch, reps=50):
    """Device time a call of ``launch`` (a C entry, no wrapper) takes back to
    back: CUDA events around ``reps`` calls queued behind a 10 ms device
    sleep, so the host's time never shows."""
    launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps=200):
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    device keeps up, so the launch queue never fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def resample_row(z, w):
    """Kernel 2 on the coarse weights of 9216 rays, with the deterministic
    u (serving) and a stratified draw (training): the error against the
    plain version (tol 1e-5), a rerun bit-identical, the wrapper's time
    (``ms``), the C entry alone (``kernel_ms``), the wrapper's
    host cost a call, and ``torch.searchsorted`` on a cdf and u of the same
    shapes as a yardstick of the lookup half only (``lookup_library_ms``:
    not the same function, so ``library_ms`` stays None)."""
    from nerfmatch_tpu_torch.nerf.sampling import blur_weights, stratified_u
    from nerfmatch_tpu_torch.ops import kernels
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z, resample_z_plain)

    n, nb = z.shape
    dev = z.device
    u_strat = stratified_u(n, nb, torch.Generator(dev).manual_seed(0), dev)
    pdf = blur_weights(w, 0.01)
    pdf = pdf / pdf.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]),
                     torch.cumsum(pdf[:, :-1], -1).clamp(max=1.0),
                     torch.ones_like(pdf[:, :1])], -1)
    lib, stream = kernels.library(), kernels.stream_ptr(dev)
    out = torch.empty_like(z)
    row = {}
    for mode, u in (("deterministic", None), ("stratified", u_strat)):
        a, b = resample_z(z, w, u=u), resample_z_plain(z, w, u=u)
        err = float((a - b).abs().max())
        same = torch.equal(a, resample_z(z, w, u=u))
        u_ptr = None if u is None else u.data_ptr()
        u_full = (torch.linspace(0.0, 1.0 - 2.0**-23, nb, device=dev)
                  .expand(n, nb).contiguous() if u is None else u)
        got = dict(
            max_abs_err=err, ms=cuda_ms(lambda: resample_z(z, w, u=u)),
            kernel_ms=kernel_alone_ms(lambda: kernels.check(
                lib.nm_resample_forward(z.data_ptr(), w.data_ptr(), u_ptr,
                                        out.data_ptr(), n, nb, 0.01, stream),
                "resample")),
            host_us=host_us(lambda: resample_z(z, w, u=u)),
            plain_ms=cuda_ms(lambda: resample_z_plain(z, w, u=u), 3),
            library_ms=None,
            lookup_library_ms=cuda_ms(lambda: torch.searchsorted(
                cdf, u_full, right=True)),
            **bound({}, nbytes(z, w, a, *([] if u is None else [u]))))
        log(f"kernel resample, {mode} u: max_abs_err={err:.3e} (tol 1e-5) "
            f"rerun bit-identical={same} ms={got['ms']:.4f} kernel_ms="
            f"{got['kernel_ms']:.4f} host_us={got['host_us']:.1f} plain_ms="
            f"{got['plain_ms']:.3f} bound_ms={got['bound_ms']:.4f} "
            f"({got['bound_by']}) lookup_library_ms (searchsorted)="
            f"{got['lookup_library_ms']:.4f}")
        assert err < 1e-5 and same and bool(torch.isfinite(a).all())
        if u is None:
            row.update(design=RESAMPLE_DESIGN, **got)
        else:
            row[mode] = got
    return row


def room_c2w(ang):
    """c2w (OpenCV axes) of the room's camera circle at angle ``ang``, looking
    at the origin (the geometry of scripts/train_bench_scene.py)."""
    eye = np.array([CAM_R * np.cos(ang), 0.25 * np.sin(3 * ang),
                    CAM_R * np.sin(ang)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
    c2w[:3, 3] = eye
    return c2w


def camera_rays(c2w, size, dev, height=None):
    """(size * height, 12) rays of a size x height (default square) pinhole
    camera (the room's 64 px / focal 80 horizontal field of view) with the
    room's near/far planes."""
    from nerfmatch_tpu_torch.nerf.rays import (get_ray_dirs, get_rays_c2w,
                                               prepare_rays_data)

    K = camera_K(size, height)
    dirs = get_ray_dirs(height or size, size, torch.as_tensor(K, device=dev))
    o, d, v = get_rays_c2w(dirs, torch.as_tensor(c2w, dtype=torch.float32,
                                                 device=dev))
    near = torch.full_like(d[..., :1], NEAR)
    far = torch.full_like(d[..., :1], FAR)
    rays = prepare_rays_data(o, v, v, near, far)
    return rays.reshape(-1, 12).contiguous()


def camera_K(size, height=None):
    f = 80.0 * size / 64.0
    return np.array([[f, 0, size / 2], [0, f, (height or size) / 2],
                     [0, 0, 1]], np.float32)


def max_err(a, b, scaled=False):
    """Largest absolute error over the outputs; ``scaled``: relative to each
    output's largest value where that exceeds 1 (features, depths)."""
    return max(float((a[k] - b[k]).abs().max())
               / (max(1.0, float(b[k].abs().max())) if scaled else 1.0)
               for k in b)


def load_room_renderer(dev):
    """The room fixture NeRF under the production NeRF config."""
    from nerfmatch_tpu_torch.config import load_yaml_config
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.train.checkpoint import (load_npz_params,
                                                      state_dict_from_jax)

    nerf_cfg, _ = load_yaml_config(ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    renderer = NerfRenderer(nerf_cfg, stop_layer=3)
    renderer.load_state_dict(state_dict_from_jax(load_npz_params(
        ROOT / "pretrained/synthetic_room_nerf.npz")), strict=True)
    return renderer.to(dev).eval()


def app_mlp(mlp, seed=0):
    """A copy of ``mlp`` with an appearance input: its views layer gains a
    seeded 16-column block (0.1 N(0, 1); the other weights shared) -> (the
    MLP, a seeded (2, 16) N(0, 1) table), on ``mlp``'s device."""
    import dataclasses

    from nerfmatch_tpu_torch.nerf.model import NerfMLP

    g = torch.Generator().manual_seed(seed)
    dev = mlp.views_linears[0].weight.device
    out = NerfMLP(dataclasses.replace(mlp.cfg, app_dim=16)).to(dev)
    state = dict(mlp.state_dict())
    wv = state["views_linears.0.weight"]
    state["views_linears.0.weight"] = torch.cat(
        [wv, 0.1 * torch.randn(wv.shape[0], 16, generator=g).to(dev)], 1)
    out.load_state_dict(state, strict=True)
    return out.eval(), torch.randn(2, 16, generator=g).to(dev)


def with_appearance(renderer, config, seed=0):
    """An appearance NeRF from ``renderer``'s weights: ``config`` with
    ``embedding.appearance_embed``, both views layers with the seeded block
    of :func:`app_mlp`, the seeded (2, 16) table, ``renderer``'s render
    settings -> (renderer on the same device, its config)."""
    import copy
    import dataclasses

    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer

    cfg = copy.deepcopy(config)
    cfg.embedding.appearance_embed = True
    out = NerfRenderer(cfg, num_frames=2,
                       stop_layer=renderer.fine_cfg.stop_layer)
    state = {k: v.detach().cpu() for k, v in renderer.state_dict().items()}
    for i, stage in enumerate(("nerf_coarse", "nerf_fine")):
        mlp, table = app_mlp(getattr(renderer, stage), seed + i)
        state[f"{stage}.views_linears.0.weight"] = \
            mlp.views_linears[0].weight.detach().cpu()
    state["embedding_a.weight"] = table.cpu()
    out.load_state_dict(state, strict=True)
    out.cfg = dataclasses.replace(renderer.cfg, appearance_embedding=True)
    return out.to(renderer.device).eval(), cfg


def app_stage_row(mlp, rays, z, int8=None, design=RENDER_EVAL_DESIGN,
                  label="bf16"):
    """The fine stage of an appearance NeRF (``mlp`` with :func:`app_mlp`'s
    block; rays alternating between the table's two rows) at eps 1e-4
    against its plain version (tol 5e-3 scaled); its weights, depth, acc,
    feat and pts bit-identical to ``mlp``'s stage without the block, its rgb
    moved; the stage's ms with and without ``app`` in turns -> its summary
    row."""
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        pack_mlp, render_stage, render_stage_plain)

    amlp, table = app_mlp(mlp)
    n, hv = rays.shape[0], mlp.cfg.hid_dim // 2
    app = table[torch.arange(n, device=rays.device) % 2].contiguous()
    kw = dict(fine=True, num_freqs=15, dirs_freqs=4, early_term_eps=1e-4,
              int8=int8)
    pa, pb = pack_mlp(amlp, int8), pack_mlp(mlp, int8)
    run_a = lambda: render_stage(amlp, rays, z, packed=pa, app=app, **kw)
    run_b = lambda: render_stage(mlp, rays, z, packed=pb, **kw)
    run_p = lambda: render_stage_plain(amlp, rays, z, app=app, **kw)
    a, b, pl = run_a(), run_b(), run_p()
    torch.cuda.synchronize()
    err, scaled = max_err(a, pl), max_err(a, pl, scaled=True)
    same = {k: torch.equal(a[k], b[k]) for k in ("weights", "depth", "acc",
                                                 "feat", "pts")}
    moved = float((a["rgb"] - b["rgb"]).abs().max())
    del pl
    ms = [cuda_ms(f, 5) for f in (run_b, run_a, run_a, run_b)]
    plain_ms = cuda_ms(run_p, 2)
    q_rows = [] if int8 is None else [
        v for k, v in int8.items() if torch.is_tensor(v) and k[0] != "w"
        and k != "img"]
    live = live_samples(a["weights"], 1e-4)
    ops = {k: 2 * m * live for k, m in stage_macs(
        mlp, True, None if int8 is None else int8["start"]).items()}
    ops["f32"] += 2 * 16 * hv * n          # app @ Wva, once a ray
    row = dict(design=design, max_abs_err=err, ms=(ms[1] + ms[2]) / 2,
               ms_without_app=(ms[0] + ms[3]) / 2, plain_ms=plain_ms,
               library_ms=None, **bound(ops, nbytes(
                   rays, z, app, *a.values(), *weight_tensors(pa), *q_rows)))
    log(f"kernel render_fine{'' if int8 is None else '_int8'}_app ({label}) "
        f"eps=0.0001: max_abs_err={err:.3e} scaled {scaled:.3e} (tol 5e-3, vs "
        f"plain with the same app rows) ms={row['ms']:.3f} (without app "
        f"{row['ms_without_app']:.3f}; in turns "
        f"{[round(v, 4) for v in ms]}) plain_ms={plain_ms:.3f} bound_ms="
        f"{row['bound_ms']:.3f} ({row['bound_by']}); weights, depth, acc, "
        f"feat, pts bit-identical to the stage without app: {same}; rgb moved "
        f"by the rows up to {moved:.3e}")
    assert scaled < 5e-3 and all(same.values()) and moved > 1e-3
    assert all(bool(torch.isfinite(v).all()) for v in a.values())
    return row


def feat_max_row(mlp, rays, z, int8=None, design=RENDER_EVAL_DESIGN,
                 label="bf16"):
    """The fine stage with feat_max (feat_comb='max': the descriptor and the
    point of each ray's largest weight) at eps 1e-4 against
    ``render_stage_plain(feat_max=True)``: weights, depth, acc and rgb within
    5e-3 scaled and bit-identical to the lin stage's; pts and feat held by
    ``feat_max_agreement`` (outside the tie margin pts within 5e-3 and feat
    within 5e-3 of its largest value; inside it the point of a near-tied
    sample within 5e-3), the rays inside the margin counted; a rerun
    bit-identical; its ms beside the lin stage's in turns; the lin stage's
    outputs' digest (the parent's bits: ``scripts/render_eval_probe.py
    --parent-eval``) -> its summary row (the bound is the lin stage's: the
    same products)."""
    import hashlib

    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        feat_max_agreement, pack_mlp, render_stage, render_stage_plain)

    kw = dict(fine=True, num_freqs=15, dirs_freqs=4, early_term_eps=1e-4,
              int8=int8)
    packed = pack_mlp(mlp, int8)
    run_m = lambda: render_stage(mlp, rays, z, packed=packed, feat_max=True,
                                 **kw)
    run_l = lambda: render_stage(mlp, rays, z, packed=packed, **kw)
    run_p = lambda: render_stage_plain(mlp, rays, z, feat_max=True, **kw)
    a, again, lin, pl = run_m(), run_m(), run_l(), run_p()
    torch.cuda.synchronize()
    same = all(torch.equal(a[k], again[k]) for k in a)
    shared = ("weights", "depth", "acc", "rgb")
    lin_same = all(torch.equal(a[k], lin[k]) for k in shared)
    err = max_err({k: a[k] for k in shared}, {k: pl[k] for k in shared},
                  scaled=True)
    agree = feat_max_agreement(a, pl, rays, z)
    digest = hashlib.sha256(b"".join(
        lin[k].cpu().numpy().tobytes() for k in sorted(lin))).hexdigest()[:16]
    moved = float((a["pts"] - lin["pts"]).abs().max())
    del again, pl
    ms = [cuda_ms(f, 5) for f in (run_l, run_m, run_m, run_l)]
    plain_ms = cuda_ms(run_p, 2)
    q_rows = [] if int8 is None else [
        v for k, v in int8.items() if torch.is_tensor(v) and k[0] != "w"
        and k != "img"]
    row = dict(design=design + "; feat_max: one thread a ray finds the "
               "block's first largest weight, the descriptor pass reduces "
               "with a one-hot weight and writes", max_abs_err=max(
                   err, agree["pts_err"], agree["pick_err"]),
               feat_err=agree["feat_err"], near_tie=agree["near_tie"],
               flipped=agree["flipped"], tie_margin=agree["margin"], ms=(ms[1] + ms[2]) / 2,
               ms_lin=(ms[0] + ms[3]) / 2, plain_ms=plain_ms, library_ms=None,
               **render_bound(mlp, True, rays, z, a, 1e-4, nbytes(
                   *weight_tensors(packed), *q_rows),
                   None if int8 is None else int8["start"]))
    log(f"kernel render_fine{'' if int8 is None else '_int8'}_max ({label}) "
        f"eps=0.0001: weights / depth / acc / rgb max_abs_err scaled "
        f"{err:.3e} (tol 5e-3, vs plain feat_max) and bit-identical to the "
        f"lin stage: {lin_same}; tie margin {agree['margin']:.3e} (twice the "
        f"largest weight difference): {agree['near_tie']} of {rays.shape[0]} "
        f"rays inside it, {agree['flipped']} of them on another sample than "
        f"the plain version's; outside it pts err {agree['pts_err']:.3e}, feat "
        f"err {agree['feat_err']:.3e} of its largest value (tol 5e-3 each); "
        f"inside it the point of a near-tied sample within "
        f"{agree['pick_err']:.3e} (tol 5e-3); rerun bit-identical: {same}; "
        f"pts moved against lin by up to {moved:.3e}; ms={row['ms']:.3f} "
        f"(lin {row['ms_lin']:.3f}; in turns {[round(v, 4) for v in ms]}) "
        f"plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.3f} "
        f"({row['bound_by']}, the lin stage's); lin outputs sha256 {digest}")
    assert same and lin_same and err < 5e-3 and moved > 1e-3
    assert agree["pts_err"] < 5e-3 and agree["pick_err"] < 5e-3
    assert agree["feat_err"] < 5e-3
    assert all(bool(torch.isfinite(v).all()) for v in a.values())
    return row


def phase_environment():
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi}")
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False (dual-softmax, "
        "fine matching and the backbone features they see stay f32)")
    return smi


def phase_build():
    from nerfmatch_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib}")
    # Registers, shared memory and spills of every kernel, by entry name
    # (the nvcc log is kept beside the library, so a cached build has it too).
    name = ""
    for line in (Path(lib).parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line or ("spill" in line and "0 bytes spill stores, 0 "
                                "bytes spill loads" not in line):
            log(f"  ptxas {name}: " + line.strip().replace("ptxas info    : ", ""))


def render_eval_build():
    """The render kernel's ptxas lines (registers, spills) by instantiation
    (bf16 or int8 trunk) and its dynamic shared memory, from the build."""
    import re

    from nerfmatch_tpu_torch.ops import kernels

    name, out = "", []
    log_path = Path(kernels.BUILD_INFO["path"]).parent / "build.log"
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "render_eval_kernel" in name and ("Used" in line or "spill" in line):
            hid, fine, dbg, q8 = re.search(r"ILi(\d+)ELb(\d)ELb(\d)ELb(\d)E",
                                           name).groups()
            out.append(f"<{hid}, {'fine' if fine == '1' else 'coarse'}"
                       f"{', debug' if dbg == '1' else ''}, "
                       f"{'int8' if q8 == '1' else 'bf16'}>: "
                       + line.strip().replace("ptxas info    : ", ""))
    lib = kernels.library()
    for q8 in (0, 1):
        for hid in (64, 128, 192, 256):
            for fine in (0, 1):
                out.append(f"<{hid}, {'fine' if fine else 'coarse'}, "
                           f"{'int8' if q8 else 'bf16'}>: "
                           f"{lib.nm_render_eval_smem(hid, fine, q8, 4)} bytes "
                           f"of dynamic shared memory (Fd = 4)")
    return out


def phase_kernels(renderer, dev):
    """Kernel vs plain version at the main path's shapes -> summary rows."""
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_plain, fused_attention)
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        early_term_mask, pack_mlp, render_stage, render_stage_plain,
        stage_alpha_plain)
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z_plain)

    rows = {}
    rays = camera_rays(room_c2w(0.4), 96, dev)          # 9216 rays, unit dirs
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    kw = dict(num_freqs=15, dirs_freqs=4)
    stages = {"render_coarse": (renderer.nerf_coarse, False),
              "render_fine": (renderer.nerf_fine, True)}
    z_in = {"render_coarse": z}
    # The plain version rounds the same MLP operands to bf16: the kernel
    # differs from it by f32 accumulation order and the bf16 rounding ties
    # this breaks apart.  The f32-MLP plain version is reported beside it.
    tol = 5e-3
    for line in render_eval_build():
        if "bf16" in line:
            log(f"render_eval_kernel {line}")
    for eps in (0.0, 1e-4):
        for name, (mlp, fine) in stages.items():
            if name == "render_fine":
                coarse = render_stage_plain(renderer.nerf_coarse, rays, z,
                                            fine=False, early_term_eps=eps, **kw)
                z_in[name] = resample_z_plain(z, coarse["weights"]).contiguous()
            packed = pack_mlp(mlp)
            args = dict(fine=fine, early_term_eps=eps, **kw)
            run_k = lambda: render_stage(mlp, rays, z_in[name], packed=packed,
                                         **args)
            run_p = lambda: render_stage_plain(mlp, rays, z_in[name], **args)
            a, b = run_k(), run_p()
            f32 = render_stage_plain(mlp, rays, z_in[name], trunk_bf16=False,
                                     **args)
            torch.cuda.synchronize()
            err, scaled = max_err(a, b), max_err(a, b, scaled=True)
            err32 = {k: float(f"{float((a[k] - f32[k]).abs().max()):.3e}")
                     for k in a}
            ms, plain_ms = cuda_ms(run_k, 3), cuda_ms(run_p, 3)
            skipped = float((a["weights"] == 0).float().mean())
            log(f"kernel {name} eps={eps:g}: max_abs_err={err:.3e} scaled "
                f"{scaled:.3e} (tol {tol:g}, vs plain with bf16 MLP operands; "
                f"max abs vs f32 MLP {err32}) ms={ms:.3f} "
                f"plain_ms={plain_ms:.3f} zero-weight share={skipped:.3f}")
            assert scaled < tol and all(torch.isfinite(v).all()
                                        for v in a.values())
            if eps > 0:
                # The skipped blocks against early_term_mask on the plain
                # version's alpha: exact zeros there, and a kept (tile,
                # block) all-zero only where the plain version's is.
                mask = early_term_mask(stage_alpha_plain(
                    mlp, rays, z_in[name], **kw), eps)
                tile_zero = lambda w: (w.reshape(-1, 2, w.shape[1] // 32, 32)
                                       == 0).all(-1).all(1)
                kept = ~mask.reshape(-1, 2, mask.shape[1] // 32, 32)[:, 0, :, 0]
                zeros_on_mask = bool((a["weights"][mask] == 0).all())
                same_kept = torch.equal(tile_zero(a["weights"]) & kept,
                                        tile_zero(b["weights"]) & kept)
                log(f"  early termination: early_term_mask share "
                    f"{float(mask.float().mean()):.4f}, kernel zero-weight "
                    f"share {skipped:.4f}; kernel weights exact zeros on the "
                    f"mask: {zeros_on_mask}; kept blocks all-zero as in the "
                    f"plain version: {same_kept}")
                assert zeros_on_mask and same_kept
                rows[name] = dict(
                    design=RENDER_EVAL_DESIGN,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                    **render_bound(mlp, fine, rays, z_in[name], a, eps,
                                   nbytes(*weight_tensors(packed))))
                log(f"  bound {rows[name]['bound_ms']:.3f} ms "
                    f"({rows[name]['bound_by']}; {live_samples(a['weights'], eps)}"
                    f" of {a['weights'].numel()} samples outside skipped blocks)")
    rows["render_fine_app"] = app_stage_row(renderer.nerf_fine, rays,
                                            z_in["render_fine"])
    for name, by_hid in render_width_rows(dev, int8=False).items():
        rows[name]["widths"] = by_hid
    rows["render_fine_app"]["wide_encoding"] = wide_encoding_render_row(dev)
    rows["render_fine_max"] = feat_max_row(renderer.nerf_fine, rays,
                                           z_in["render_fine"])
    w = render_stage_plain(renderer.nerf_coarse, rays, z, fine=False,
                           early_term_eps=1e-4, **kw)["weights"].contiguous()
    rows["resample"] = resample_row(z, w)

    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(1, 3600, 8, 32, device=dev, generator=g) / np.sqrt(32)
    k = torch.randn(1, 3600, 8, 32, device=dev, generator=g)
    v = torch.randn(1, 3600, 8, 32, device=dev, generator=g)
    rnd = lambda t: t.to(torch.bfloat16).float()
    # f32 mode: max and mean 1e-4 (other summation orders).  bf16 mode: both
    # sides round q, k, v and the unnormalized probabilities to bf16, but
    # the one-pass kernel rounds e' = 2^(x - ceil(max x)), the two-pass plain
    # version e = exp(s - max): e' / e is no power of two, so the two
    # roundings (relative 2^-9 each) fall independently.  The tolerance is
    # that rounding's own size, measured on these inputs as the distance
    # between the plain version and the same attention with unrounded e:
    # twice its mean, four times its maximum.  Against the one-pass plain
    # version, which rounds what the kernel rounds, the earlier tolerance
    # stands (max 1e-3, mean 1e-5: a few ties broken apart by ex2.approx
    # and the summation order).
    noise = (attention_plain(q, k, v, True)
             - attention_plain(rnd(q), rnd(k), rnd(v), False)).abs()
    tols = {False: (1e-4, 1e-4),
            True: (4 * float(noise.max()), 2 * float(noise.mean()))}
    for bf16 in (False, True):
        a = fused_attention(q, k, v, bf16)
        b = attention_plain(q, k, v, bf16)
        err, mean_err = float((a - b).abs().max()), float((a - b).abs().mean())
        ms = cuda_ms(lambda: fused_attention(q, k, v, bf16))
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, bf16))
        log(f"kernel attention bf16={bf16}: max_abs_err={err:.3e} mean "
            f"{mean_err:.3e} (tol max {tols[bf16][0]:.3g}, mean "
            f"{tols[bf16][1]:.3g}) ms={ms:.3f} plain_ms={plain_ms:.3f}")
        assert err < tols[bf16][0] and mean_err < tols[bf16][1]
        assert torch.isfinite(a).all()
        if bf16:   # the serving default (attn_bf16=True)
            rows["attention"] = attention_forward_row(q, k, v, a, err, ms,
                                                      plain_ms)
    rows["attention"]["merged"] = attention_merged_row(dev)
    rows["attention"]["head_dims"] = {
        str(d): attention_width_row(dev, d) for d in ATTN_WIDTH_ROWS}
    rows["attention"]["ptxas"] = attention_build()
    return rows


def attention_merged_row(dev, L=3600, S=14400):
    """The bf16 attention forward at the merged multi-pair layout's shapes
    (``--pair_topk 4 --sample_mode rand --sample_pts 14400``): the image's
    3600 queries over 14,400 points (the coarse former's image side), held
    to the one-pass plain version (max 1e-3, mean 1e-5) with the two-pass
    plain version's error beside, its bound, ``exp_bound_ms`` and
    ``scaled_dot_product_attention``; then the points' self-attention (L = S
    = 14,400) timed beside SDPA -> a row for the ``attention`` summary."""
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_onepass_plain, attention_plain, fused_attention)

    g = torch.Generator(dev).manual_seed(1)
    q = torch.randn(1, L, 8, 32, device=dev, generator=g) / np.sqrt(32)
    k = torch.randn(1, S, 8, 32, device=dev, generator=g)
    v = torch.randn(1, S, 8, 32, device=dev, generator=g)
    a = fused_attention(q, k, v, True)
    one, _ = attention_onepass_plain(q, k, v, True)
    err1, mean1 = float((a - one).abs().max()), float((a - one).abs().mean())
    del one
    err2 = float((a - attention_plain(q, k, v, True)).abs().max())
    ms = cuda_ms(lambda: fused_attention(q, k, v, True))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, True), 3)
    lib_ms, lib_err = sdpa_forward(q, k, v, a)
    eb, _, _ = exp_bound_ms(8 * L * S)
    row = dict(L=L, S=S, max_abs_err=err1, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, exp_bound_ms=eb,
               **bound({"bf16": 4 * 8 * L * S * 32}, nbytes(q, k, v, a)))
    qs = torch.randn(1, S, 8, 32, device=dev, generator=g) / np.sqrt(32)
    row["self_S"] = dict(ms=cuda_ms(lambda: fused_attention(qs, k, v, True)),
                         library_ms=sdpa_forward(qs, k, v, fused_attention(
                             qs, k, v, True))[0],
                         **bound({"bf16": 4 * 8 * S * S * 32},
                                 nbytes(qs, k, v, qs)))
    log(f"kernel attention bf16 at L={L}, S={S} (merged multi-pair): vs the "
        f"one-pass plain version max {err1:.3e} mean {mean1:.3e} (tol max "
        f"1e-3, mean 1e-5), vs the two-pass plain version max {err2:.3e}; "
        f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.4f} "
        f"exp_bound_ms={eb:.4f} scaled_dot_product_attention {lib_ms:.4f} "
        f"(max abs diff {lib_err:.2e}); L=S={S}: ms="
        f"{row['self_S']['ms']:.4f} SDPA {row['self_S']['library_ms']:.4f} "
        f"bound {row['self_S']['bound_ms']:.4f}")
    assert err1 < 1e-3 and mean1 < 1e-5 and torch.isfinite(a).all()
    return row


# The head_dims phases 3 and 3c hold beside the matcher's 32: the other
# instantiations of csrc/attention.cu (16, 64, 128).
ATTN_WIDTH_ROWS = (16, 64, 128)


def attention_build():
    """ptxas registers and spills of every attention kernel instantiation,
    from the build log, by readable name (``<kD>``, dK/dV ``<kD, pass>``:
    0 both, 1 dV alone, 2 dK alone)."""
    import re

    from nerfmatch_tpu_torch.ops import kernels

    bases = ("attention_bf16_kernel", "attn_bwd_dkdv_bf16", "attn_bwd_dq_bf16",
             "attn_bwd_prep", "attention_cast_bf16", "attention_f32_kernel",
             "attn_bwd_dkdv_f32", "attn_bwd_dq_f32")
    name, out = "", {}
    log_path = Path(kernels.BUILD_INFO["path"]).parent / "build.log"
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            base = next((b for b in bases if b in name), None)
            if base is None:
                name = ""
                continue
            rest = name.split(base, 1)[1]
            args = re.match(r"I((?:Li\d+E)+)E", rest)
            widths = re.findall(r"Li(\d+)E", args.group(1)) if args else []
            name = base + (f"<{', '.join(widths)}>" if widths else "")
        elif name and ("Used" in line or "spill" in line):
            text = line.strip().replace("ptxas info    : ", "")
            if "spill" in text:
                text = text.split(":", 1)[-1].strip()
            out[name] = (out[name] + "; " if name in out else "") + text
    for n, text in sorted(out.items()):
        log(f"  ptxas {n}: {text}")
    return out


def attention_fwd_alone_ms(q, k, v, cast=True):
    """Device time of the attention forward's C entry alone (no wrapper),
    calls queued back to back: with ``cast`` on the f32 q, k, v (the cast
    launch and the kernel, as the matcher calls it), else on bf16 operands
    (the kernel alone)."""
    from nerfmatch_tpu_torch.ops import kernels
    from nerfmatch_tpu_torch.ops.kernels import attention_kernel as ak

    B, L, H, D = q.shape
    S, W = k.shape[1], ak.operand_width(D)
    out = torch.empty(B, L, H, D, device=q.device)
    if cast:
        ops = [t.contiguous() for t in (q, k, v)]
        ws = torch.empty((B * L + 2 * B * S) * H * W, device=q.device,
                         dtype=torch.bfloat16)
    else:
        ops, ws = ak._operands((q, k, v), True), None
    lib, stream = kernels.library(), kernels.stream_ptr(q.device)
    return kernel_alone_ms(lambda: kernels.check(lib.nm_attention_forward(
        *(t.data_ptr() for t in ops), out.data_ptr(), 0,
        ws.data_ptr() if cast else 0, B, L, S, H, D, 1, stream), "attention"))


def attention_width_row(dev, D, L=3600, S=3600, H=8):
    """The attention forward at head_dim ``D`` and phase 3's shapes (B = 1,
    H = 8, L = S = 3600) on the ``kernel_head_dim(D)`` instantiation: the
    bf16 mode against the one-pass plain version (max 1e-3, mean 1e-5, the
    D = 32 tolerances; the two-pass plain version's error beside), the f32
    mode against ``attention_plain`` (max 1e-4); the bf16 call timed through
    the wrapper (``ms``) and its C entry alone (``kernel_ms``), beside the
    plain version, SDPA, the bound and ``exp_bound_ms``; the f32 mode's
    time -> a row of the attention summary's ``head_dims``."""
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_onepass_plain, attention_plain, fused_attention,
        kernel_head_dim)

    g = torch.Generator(dev).manual_seed(4)
    q = torch.randn(1, L, H, D, device=dev, generator=g) / np.sqrt(D)
    k = torch.randn(1, S, H, D, device=dev, generator=g)
    v = torch.randn(1, S, H, D, device=dev, generator=g)
    a = fused_attention(q, k, v, True)
    one, _ = attention_onepass_plain(q, k, v, True)
    err1, mean1 = float((a - one).abs().max()), float((a - one).abs().mean())
    del one
    err2 = float((a - attention_plain(q, k, v, True)).abs().max())
    a32 = fused_attention(q, k, v, False)
    err32 = float((a32 - attention_plain(q, k, v, False)).abs().max())
    ms = cuda_ms(lambda: fused_attention(q, k, v, True))
    kernel_ms = attention_fwd_alone_ms(q, k, v)
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, True), 3)
    f32_ms = cuda_ms(lambda: fused_attention(q, k, v, False), 3)
    lib_ms, lib_err = sdpa_forward(q, k, v, a)
    eb, _, _ = exp_bound_ms(H * L * S)
    row = dict(D=D, kernel_head_dim=kernel_head_dim(D), L=L, S=S,
               max_abs_err=err1, mean_abs_err=mean1, two_pass_max_err=err2,
               ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_max_diff=lib_err, exp_bound_ms=eb,
               f32_ms=f32_ms, f32_max_abs_err=err32,
               **bound({"bf16": 4 * H * L * S * D}, nbytes(q, k, v, a)))
    log(f"kernel attention at head_dim {D} (kD {row['kernel_head_dim']}), "
        f"B=1, H={H}, L=S={L}: bf16 vs the one-pass plain version max "
        f"{err1:.3e} mean {mean1:.3e} (tol max 1e-3, mean 1e-5), vs the "
        f"two-pass plain version max {err2:.3e}; f32 mode vs attention_plain "
        f"max {err32:.3e} (tol 1e-4); ms={ms:.4f} kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.4f} "
        f"exp_bound_ms={eb:.4f} scaled_dot_product_attention {lib_ms:.4f} "
        f"(max abs diff {lib_err:.2e}); f32 mode {f32_ms:.3f} ms")
    assert err1 < 1e-3 and mean1 < 1e-5 and err32 < 1e-4
    assert torch.isfinite(a).all() and torch.isfinite(a32).all()
    return row


def exp_bound_ms(n_exp):
    """Least time for ``n_exp`` base-2 exponentials on the special-function
    units: 16 a clock on each of the card's SMs (the CUDA programming
    guide's throughput table for compute capability 9.0), at the largest
    SM clock ``nvidia-smi`` reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (16 * sms * mhz * 1e6) * 1e3, sms, mhz


def attention_forward_row(q, k, v, out, err, ms, plain_ms):
    """The bf16 forward's summary row; on earlier lines its parts."""
    from nerfmatch_tpu_torch.ops.kernels import attention_kernel as ak

    B, L, H, D = q.shape
    S = k.shape[1]
    one, _ = ak.attention_onepass_plain(q, k, v, True)
    err1, mean1 = float((out - one).abs().max()), float((out - one).abs().mean())
    qb, kb, vb = ak._operands((q, k, v), True)
    _, lse, _ = ak._forward_kernel(qb, kb, vb, True, True)
    rnd = lambda t: t.to(torch.bfloat16).float()
    lse_ref = torch.logsumexp(torch.einsum("blhd,bshd->bhls", rnd(q), rnd(k)),
                              -1).reshape(B * H, L)
    lse_err = float((lse - lse_ref).abs().max())
    log(f"  vs the one-pass plain version (the kernel's own rounding): max "
        f"{err1:.3e} mean {mean1:.3e} (tol max 1e-3, mean 1e-5); lse vs "
        f"torch.logsumexp max {lse_err:.3e} (tol 1e-4)")
    assert err1 < 1e-3 and mean1 < 1e-5 and lse_err < 1e-4
    parts = {
        "kernel on bf16 operands": cuda_ms(
            lambda: ak._forward_kernel(qb, kb, vb, True, False)),
        "with lse": cuda_ms(lambda: ak._forward_kernel(qb, kb, vb, True, True)),
        "on f32 q, k, v (cast launch + kernel in one call)": cuda_ms(
            lambda: ak._forward_kernel(q, k, v, True, False)),
    }
    log("  parts (ms): " + json.dumps({k_: round(v_, 4)
                                        for k_, v_ in parts.items()}))
    lib_ms, lib_err = sdpa_forward(q, k, v, out)
    eb, sms, mhz = exp_bound_ms(B * H * L * S)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **bound({"bf16": 4 * B * H * L * S * D}, nbytes(q, k, v, out)))
    log(f"  bound {row['bound_ms']:.4f} ms; exp_bound_ms {eb:.4f} (one ex2 "
        f"per logit, {B * H * L * S} logits / (16 per clock x {sms} SMs x "
        f"{mhz:.0f} MHz)); scaled_dot_product_attention (bf16 operands) "
        f"{lib_ms:.3f} ms, max abs diff to the kernel {lib_err:.2e}")
    return row


def sdpa_forward(q, k, v, ref):
    """Time of ``scaled_dot_product_attention`` on the bf16-rounded
    (B, H, L, D) operands (q arrives pre-scaled), and its largest
    difference to ``ref``."""
    from torch.nn import functional as F

    qb, kb, vb = (x.transpose(1, 2).to(torch.bfloat16).contiguous()
                  for x in (q, k, v))
    run = lambda: F.scaled_dot_product_attention(qb, kb, vb, scale=1.0)
    diff = float((run().transpose(1, 2).float() - ref).abs().max())
    return cuda_ms(run), diff


def phase_int8_kernels(renderer, dev):
    """The int8 render stage vs its plain version at the serving path's
    shapes, and every int8 mode's two-stage render vs the f32 plain render
    -> summary rows."""
    import dataclasses

    from nerfmatch_tpu_torch.nerf.model import eval_feat_layer
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_mlp_int8)
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        early_term_mask, pack_mlp, render_stage, render_stage_plain,
        stage_alpha_plain)
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z_plain)

    rays = camera_rays(room_c2w(0.4), 96, dev)          # 9216 rays, unit dirs
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    kw = dict(num_freqs=15, dirs_freqs=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = calibrate_act_scales(renderer, rays[:1024])
    torch.cuda.synchronize()
    calib_ms = (time.perf_counter() - t0) * 1e3
    cmlp, fmlp = renderer.nerf_coarse, renderer.nerf_fine
    tap = eval_feat_layer(fmlp.cfg)
    int8 = {"coarse": (cmlp, False, pack_mlp_int8(cmlp, scales["coarse"], 0)),
            "both": (fmlp, True, pack_mlp_int8(fmlp, scales["fine"], 0, tap)),
            "posttap": (fmlp, True, pack_mlp_int8(fmlp, scales["fine"],
                                                  tap + 1, tap))}
    bf16 = {id(m): pack_mlp(m) for m in (cmlp, fmlp)}
    # The bytes the kernel reads besides rays and z: its packed weights and
    # the int8 trunk's f32 rows.
    wbytes = lambda q, packed: nbytes(*weight_tensors(packed), *[
        v for k, v in q.items() if torch.is_tensor(v) and k[0] != "w" and k != "img"])
    log(f"int8 calibration: {calib_ms:.1f} ms (plain f32 render of 1024 rays, "
        f"both stages; once per scene)")
    room_pack_ms = pack_fused_ms(renderer, scales)
    log(f"pack_fused at hid 256 (int8 'coarse'): {room_pack_ms:.2f} ms of "
        f"host time a call")
    log(f"int8 render design: {INT8_EVAL_DESIGN}")
    for line in render_eval_build():
        if "int8" in line:
            log(f"render_eval_kernel {line}")
    # Both sides quantize the same f32 values with the same roundings and
    # multiply integers exactly; the f32 epilogue is unfused on both.  What
    # remains: the bf16 layers and heads (as in the bf16 rows), sinf / expf
    # against torch's in the encoding, and the compositing order.
    tol = 5e-3
    rows = {}
    for eps in (0.0, 1e-4):
        args = dict(early_term_eps=eps, **kw)
        zc = resample_z_plain(z, render_stage_plain(
            cmlp, rays, z, fine=False, int8=int8["coarse"][2],
            **args)["weights"]).contiguous()
        for mode, (mlp, fine, q) in int8.items():
            zz = zc if fine else z
            packed = pack_mlp(mlp, q)
            run_k = lambda: render_stage(mlp, rays, zz, fine=fine,
                                         packed=packed, int8=q, **args)
            run_b = lambda: render_stage(mlp, rays, zz, fine=fine,
                                         packed=bf16[id(mlp)], **args)
            run_p = lambda: render_stage_plain(mlp, rays, zz, fine=fine,
                                               int8=q, **args)
            a, b, again = run_k(), run_p(), run_k()
            torch.cuda.synchronize()
            err, scaled = max_err(a, b), max_err(a, b, scaled=True)
            same = all(torch.equal(a[k], again[k]) for k in a)
            del again
            share = ""
            if eps == 0:
                ka = render_stage(mlp, rays, zz, fine=fine, packed=packed,
                                  int8=q, debug_q=True, **args)
                pa = render_stage_plain(mlp, rays, zz, fine=fine, int8=q,
                                        debug_q=True, **args)
                shares = {k: float((ka[k] != pa[k]).float().mean())
                          for k in ("xq", "hq")}
                share = " int8 activations that differ: " + json.dumps(
                    {k: float(f"{v:.3e}") for k, v in shares.items()})
                del ka, pa
                assert max(shares.values()) < 1e-3, shares
            ms, bf16_ms = cuda_ms(run_k, 5), cuda_ms(run_b, 5)
            plain_ms = cuda_ms(run_p, 2)
            name = "render_fine_int8" if fine else "render_coarse_int8"
            row = dict(design=INT8_EVAL_DESIGN, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=None,
                       **render_bound(mlp, fine, rays, zz, a, eps,
                                      wbytes(q, packed), q["start"]))
            log(f"kernel {name} ({mode}) eps={eps:g}: max_abs_err={err:.3e} "
                f"scaled {scaled:.3e} (tol {tol:g}, vs plain int8){share} "
                f"ms={ms:.3f} (bf16 stage {bf16_ms:.3f}) plain_ms="
                f"{plain_ms:.3f} bound_ms={row['bound_ms']:.3f} "
                f"({row['bound_by']}); rerun bit-identical: {same}")
            assert scaled < tol and same and all(torch.isfinite(v).all()
                                                 for v in a.values())
            if eps > 0:
                # The skipped blocks against early_term_mask on the plain
                # int8 version's alpha: exact zeros there.
                mask = early_term_mask(stage_alpha_plain(
                    mlp, rays, zz, int8=q, **kw), eps)
                zeros_on_mask = bool((a["weights"][mask] == 0).all())
                log(f"  early termination: early_term_mask share "
                    f"{float(mask.float().mean()):.4f}, kernel zero-weight "
                    f"share {float((a['weights'] == 0).float().mean()):.4f}; "
                    f"kernel weights exact zeros on the mask: {zeros_on_mask}")
                assert zeros_on_mask
            # The serving default's coarse stage, and the fine stage of the
            # opt-in 'posttap' request that phase 4 serves.
            if eps > 0 and mode in ("coarse", "posttap"):
                rows[name] = row
                row["pack_fused_ms"] = room_pack_ms
            if eps > 0 and fine:
                row_app = app_stage_row(mlp, rays, zz, int8=q,
                                        design=INT8_EVAL_DESIGN, label=mode)
                if mode == "posttap":
                    rows["render_fine_int8_app"] = row_app
                    rows["render_fine_int8_max"] = feat_max_row(
                        mlp, rays, zz, int8=q, design=INT8_EVAL_DESIGN,
                        label=mode)

    for name, by_hid in render_width_rows(dev, int8=True).items():
        rows[name]["widths"] = by_hid

    # Two-stage renders of every mode against the f32 plain render, against
    # the JAX int8 test's budget (tests/test_pallas_render.py, 'both', on 8
    # rays of a random field).  Over 9216 rays of a scene the maxima sit at
    # silhouette edges, where another fine z distribution switches surface:
    # the 99th percentile over rays is reported beside them.
    base_cfg, base_scales = renderer.cfg, renderer.act_scales
    renderer.act_scales = scales
    p99 = lambda x: float(torch.quantile(x.flatten().float(), 0.99))
    try:
        renderer.cfg = dataclasses.replace(base_cfg, compute_dtype="float32")
        ref = renderer.render_rays(rays)
        for mode in ("none", "coarse", "both", "posttap"):
            renderer.cfg = dataclasses.replace(base_cfg, trunk_int8=mode,
                                               early_term_eps=0.0)
            out = renderer.fused_render(rays)
            rgb_mean = float((out["rgb_fine"] - ref["rgb_fine"]).abs().mean())
            d_rgb = (out["rgb_fine"] - ref["rgb_fine"]).abs().amax(-1)
            d_depth = (out["depth_fine"] - ref["depth_fine"]).abs()
            d_feat = (out["feat_fine"] - ref["feat_fine"]).abs().amax(-1) \
                / ref["feat_fine"].abs().max()
            within = (rgb_mean < 1e-2 and float(d_rgb.max()) < 8e-2
                      and float(d_depth.max()) < 8e-2
                      and float(d_feat.max()) < 0.15)
            log(f"two-stage {mode} vs f32 plain: rgb mean {rgb_mean:.3e}, per "
                f"ray p99 {p99(d_rgb):.3e} max "
                f"{float(d_rgb.max()):.3e}; depth p99 {p99(d_depth):.3e} max "
                f"{float(d_depth.max()):.3e}; feat rel p99 {p99(d_feat):.3e} "
                f"max {float(d_feat.max()):.3e} (budget rgb mean 1e-2 / max "
                f"8e-2, depth 8e-2, feat 0.15: maxima within {within}; rays "
                f"with rgb over 8e-2 {float((d_rgb > 8e-2).float().mean()):.4f})")
    finally:
        renderer.cfg, renderer.act_scales = base_cfg, base_scales
    return rows


def make_request(renderer, ang, dev, size=480):
    """A query photo (the port's render at ``ang``) and scene points rendered
    at a database pose 0.12 rad further along the circle."""
    c2w = room_c2w(ang)
    rgb = renderer.fused_predict(camera_rays(c2w, size, dev))["rgb_fine"]
    assert torch.isfinite(rgb).all(), "query render is not finite"
    img = rgb.reshape(size, size, 3).clamp(0, 1).cpu().numpy()
    ys, xs = np.meshgrid(np.arange(size // 8), np.arange(size // 8),
                         indexing="ij")
    m = (size // 8) ** 2
    return dict(image=((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32),
                im_mask=np.ones(m, np.float32),
                pt2d=(np.stack([xs, ys], -1).reshape(-1, 2) * 8 + 4).astype(
                    np.float32),
                K=camera_K(size), c2w=c2w.astype(np.float32),
                unnorm_scene=np.eye(4, dtype=np.float32),
                db_c2w=room_c2w(ang + 0.12))


def scene_points(renderer, reqs, size=480):
    outs = renderer.render_novel_views(
        (size, size), [r["K"] for r in reqs], [r["db_c2w"] for r in reqs],
        [r["unnorm_scene"] for r in reqs], downsample=8)
    batch = {k: np.stack([r[k] for r in reqs]) for k in
             ("image", "im_mask", "pt2d", "K", "c2w", "unnorm_scene")}
    batch.update(pt3d=outs["pt3d"], pt_feat=outs["pt_feat"],
                 pt_mask=np.ones(outs["pt3d"].shape[:2], np.float32))
    for k in ("pt3d", "pt_feat"):
        assert np.isfinite(batch[k]).all(), k
    return batch


def match_pairs(evaluator, batch):
    """The first query's valid (image, point) matches."""
    out = evaluator._match(*[batch[k][:1] for k in (
        "image", "pt_feat", "pt3d", "im_mask", "pt_mask")], True, 0.0)
    lists = out["lists"]
    v = lists["valid"][0]
    return set(zip(lists["i_ids"][0][v], lists["j_ids"][0][v]))


def phase_serving(renderer, evaluator, dev, size=480):
    """``renderer`` is the serving renderer (its int8 mode resolved as the
    serving paths resolve it)."""
    import dataclasses

    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts

    default = renderer.cfg.trunk_int8
    angles = [0.3 + 2.1 * i for i in range(3)]
    reqs = [make_request(renderer, a, dev, size) for a in angles]
    kw = dict(iters=2, mutual=True, solver="colmap", rthres=10.0)
    # Warm-up request (cuDNN autotuning, allocator), not counted.
    evaluator.eval_batch(scene_points(renderer, reqs[:1], size), renderer=renderer,
                         **kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    results = []
    for i, group in enumerate([[0], [1], [2], [0, 1]]):
        t0 = time.perf_counter()
        batch = scene_points(renderer, [reqs[j] for j in group], size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = evaluator.eval_batch(batch, renderer=renderer, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for c2w, r_err, t_err in zip(res["c2w_est"], res["R_err"],
                                     res["t_err"]):
            # A query whose PnP failed reports inf errors and no pose;
            # every solved one must be finite.
            assert (c2w is None and r_err == t_err == float("inf")) or (
                np.isfinite(c2w).all() and np.isfinite([r_err, t_err]).all())
        rerendered = sum(c is not None for c in res["c2w_est"])
        row = dict(request=i, queries=group, scene_points_ms=(t1 - t0) * 1e3,
                   localize_ms=(t2 - t1) * 1e3,
                   num_matches=res["num_matches"], R_err_deg=res["R_err"],
                   t_err=res["t_err"], pnp_ok_final=rerendered)
        log("request " + json.dumps(row))
        results.append((batch, res))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"launches during serving at trunk_int8={default!r}: "
        f"{json.dumps(launches)}")
    missing = [k for k in SERVING_KERNELS if launches[k] == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    assert launches["render_coarse"] == 0, "the default served a bf16 coarse stage"

    # The opt-in modes on request 0's inputs: its scene points and
    # first-iteration matches against the default's.
    base = results[0][0]
    base_pairs = match_pairs(evaluator, base)
    for mode in ("posttap", "none"):
        renderer.cfg = dataclasses.replace(renderer.cfg, trunk_int8=mode)
        t0 = time.perf_counter()
        batch = scene_points(renderer, reqs[:1], size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = evaluator.eval_batch(batch, renderer=renderer, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pairs = match_pairs(evaluator, batch)
        feat_ref = np.abs(base["pt_feat"]).max()
        log("request " + json.dumps(dict(
            trunk_int8=mode, queries=[0], scene_points_ms=(t1 - t0) * 1e3,
            localize_ms=(t2 - t1) * 1e3, num_matches=res["num_matches"],
            R_err_deg=res["R_err"], t_err=res["t_err"],
            pt_feat_max_drift_rel=float(np.abs(batch["pt_feat"] - base[
                "pt_feat"]).max() / feat_ref),
            pt3d_max_drift=float(np.abs(batch["pt3d"] - base["pt3d"]).max()),
            pt3d_mean_drift=float(np.abs(batch["pt3d"] - base["pt3d"]).mean()),
            match_jaccard_vs_default=len(pairs & base_pairs)
            / max(len(pairs | base_pairs), 1))))
        for k in ("pt3d", "pt_feat"):
            assert np.isfinite(batch[k]).all(), (mode, k)
    renderer.cfg = dataclasses.replace(renderer.cfg, trunk_int8=default)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"launches during serving, opt-in requests included: "
        f"{json.dumps(launches)}")
    missing = [k for k in (*SERVING_KERNELS, *OPT_IN_KERNELS)
               if launches[k] == 0]
    assert not missing, f"kernels never launched in serving: {missing}"
    # cuDNN's own default (TF32 on, which the package turns off) on request
    # 0's matches: reported, not asserted, and after the launch counts.
    torch.backends.cudnn.allow_tf32 = True
    pairs = match_pairs(evaluator, base)
    torch.backends.cudnn.allow_tf32 = False
    log(f"check: cuDNN TF32 on vs off, request 0's matches {len(pairs)} vs "
        f"{len(base_pairs)}, jaccard "
        f"{len(pairs & base_pairs) / max(len(pairs | base_pairs), 1):.4f} "
        f"(reported)")
    return launches, results


def perturbed_pose(c2w, deg, dist):
    """``c2w`` turned by ``deg`` degrees about a fixed axis and moved by
    ``dist`` world units along a fixed direction, both in its camera frame."""
    from nerfmatch_tpu_torch.utils.geometry import rodrigues

    axis = np.array([0.3, 1.0, -0.2]) / np.linalg.norm([0.3, 1.0, -0.2])
    move = np.array([1.0, -0.5, 0.3]) / np.linalg.norm([1.0, -0.5, 0.3])
    pert = np.eye(4)
    pert[:3, :3] = rodrigues(torch.tensor(axis * np.deg2rad(deg))).numpy()
    pert[:3, 3] = dist * move
    return c2w @ pert


def twin_half(renderer, packed):
    """The plain twin of iNeRF's kernel half (``coarse_resample`` on the
    card): the coarse stage's plain version with the same trunk (the int8
    one of ``packed``), eps and padding, then the plain resample."""
    from nerfmatch_tpu_torch.nerf.renderer import reparam_unit_dir
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        TILE_RAYS, render_stage_plain)
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z_plain)

    (_, mlp), _ = renderer._stages()
    S, cfg = renderer.fine_cfg.num_pts, renderer.cfg

    def half(rays, packed_=None, plain=False):
        n = rays.shape[0]
        r, nrm = reparam_unit_dir(
            torch.cat([rays, rays[-1:].expand((-n) % TILE_RAYS, -1)]))
        t = torch.linspace(0.0, 1.0, S + 1, device=rays.device)
        z = r[:, 6:7] * (1.0 - t) + r[:, 7:8] * t
        w = render_stage_plain(
            mlp, r, z, fine=False, num_freqs=cfg.xyz_num_freqs,
            dirs_freqs=cfg.dirs_num_freqs, var_scale=1.0,
            early_term_eps=cfg.early_term_eps, int8=packed[0][1])["weights"]
        return (resample_z_plain(z, w) / nrm)[:n]
    return half


def bf16_half(renderer):
    """The candidate iNeRF half with the JAX pass's arithmetic on the card:
    kernel 1's coarse stage with the bf16 trunk and no early termination
    (its own bf16 pack), then the resample kernel."""
    from nerfmatch_tpu_torch.nerf.renderer import reparam_unit_dir
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        TILE_RAYS, pack_mlp, render_stage)
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import resample_z

    (_, mlp), _ = renderer._stages()
    S, cfg, packed = renderer.fine_cfg.num_pts, renderer.cfg, pack_mlp(mlp)

    @torch.no_grad()
    def half(rays, packed_=None, plain=False):
        n = rays.shape[0]
        r, nrm = reparam_unit_dir(
            torch.cat([rays, rays[-1:].expand((-n) % TILE_RAYS, -1)]))
        t = torch.linspace(0.0, 1.0, S + 1, device=rays.device)
        z = (r[:, 6:7] * (1.0 - t) + r[:, 7:8] * t).contiguous()
        w = render_stage(mlp, r, z, fine=False, packed=packed,
                         num_freqs=cfg.xyz_num_freqs,
                         dirs_freqs=cfg.dirs_num_freqs, var_scale=1.0)["weights"]
        return (resample_z(z, w) / nrm)[:n]
    return half


def phase_inerf(renderer, evaluator, nerf_cfg, dev, size=480):
    """Phase 4b: iNeRF at full width on the serving renderer (int8 coarse)
    and the production c2f matcher.  (a) from the ground truth turned by
    2 deg and moved by 0.05, 30 steps at lrate 0.002 with the cosine decay,
    scored on the pose (``eval_pose``) against a query that is the iNeRF
    render of the ground truth on the ds-8 grid (white background, as iNeRF
    composites): the loss and ``t_err`` must fall; (c) one match-mode query
    with the match loss for 2 steps (``inerf_refinement``); the counters,
    reset before (a) and read after (c), must show one int8 coarse stage and
    one resample a step and the attention backward; (b) afterwards, one step
    from the same start with the kernel half, with its plain twin (the
    stage's plain version on the same int8 trunk, the plain resample: held
    to the kernel half) and with the JAX package's plain half (the coarse
    MLP in the config's bf16 ``compute_dtype``, no int8, no early
    termination: reported, bounded only against gross faults): the loss, the
    cosine of the gradients, the fine fenceposts; and the candidate half on
    kernel 1 (bf16, eps 0: :func:`bf16_half`) against the JAX plain half,
    which iNeRF would run at gradient cosine > 0.99; (d) three steps on an
    appearance NeRF made from the same weights (table row 1): ms a step, the
    loss before and after."""
    from argparse import Namespace

    from nerfmatch_tpu_torch.eval.inerf import InerfQuery, inerf_refinement
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.utils.geometry import pose_err

    ds, steps, g = 8, 30, size // 8
    conf = Namespace(lrate=0.002, num_optim=steps, lrdecay=True,
                     eval_pose=True, ds=ds, use_match_loss=False)
    c2w, K, un = room_c2w(0.3), camera_K(size), np.eye(4)
    img = np.zeros((size, size, 3), np.float32)
    batch = dict(image=img[None], K=K[None], c2w=c2w[None].astype(np.float32))
    gt = InerfQuery(evaluator, batch, renderer, un, c2w, conf)
    img[ds // 2::ds, ds // 2::ds] = gt.render(gt.delta)[0].reshape(
        g, g, 3).cpu().numpy()
    start = perturbed_pose(c2w, 2.0, 0.05)
    r0, t0 = map(float, pose_err(c2w, start))
    match_req = make_request(renderer, 0.3, dev, size)
    match_batch = scene_points(renderer, [match_req], size)
    torch.cuda.synchronize()
    evaluator.timer.clear()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_launch_counts()
    q = InerfQuery(evaluator, batch, renderer, un, start, conf)
    rows = []
    for j in range(steps):
        loss = q.step(j)[0]
        r_err, t_err = map(float, pose_err(c2w, q.c2w()))
        rows.append((loss, r_err, t_err))
    torch.cuda.synchronize()
    step_ms = np.asarray(evaluator.timer["inerf_step_time"]) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    log(f"inerf (a): start R_err {r0:.3f} deg t_err {t0:.4f}; per step "
        f"(loss, R_err deg, t_err): " + json.dumps(
            [[round(v, 6) for v in r] for r in rows]))
    log(f"inerf (a): step ms median {np.median(step_ms):.2f} min "
        f"{step_ms.min():.2f} max {step_ms.max():.2f} (first "
        f"{step_ms[0]:.2f}); peak memory above the resident "
        f"{peak:.2f} GiB (3600 rays x 128 fine samples, 8x256 f32 MLP "
        f"under autograd)")
    assert rows[-1][0] < rows[0][0], "iNeRF loss did not fall"
    assert rows[-1][2] < t0, f"iNeRF t_err {rows[-1][2]} not below {t0}"
    per_step = {k: LAUNCHES[k] for k in ("render_coarse_int8", "resample")}
    assert per_step == {k: steps for k in per_step}, per_step
    evaluator.timer.clear()
    mconf = Namespace(lrate=0.001, num_optim=2, lrdecay=False,
                      eval_pose=False, ds=ds, use_match_loss=True)
    t1 = time.perf_counter()
    c2w_m, r_m, t_m = inerf_refinement(
        evaluator, match_batch, renderer, match_batch["unnorm_scene"][0],
        perturbed_pose(c2w, 2.0, 0.05), mconf, mutual=True, rthres=10.0)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"inerf (c): match mode with the match loss, 2 steps in "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms (step ms "
        f"{[round(v * 1e3, 2) for v in evaluator.timer['inerf_step_time']]}), "
        f"R_err {r_m:.3f} t_err {t_m:.4f}")
    log(f"launches during iNeRF (a) + (c): {json.dumps(launches)}")
    assert launches["render_coarse_int8"] == launches["resample"] == steps + 2
    assert launches["render_coarse"] == 0 and launches["render_fine"] == 0
    missing = [k for k in ("attention", "attention_bwd", "dw_star_fwd")
               if launches[k] == 0]
    assert not missing, f"kernels never launched by iNeRF: {missing}"
    assert c2w_m is None or np.isfinite(c2w_m).all()

    qs = {name: InerfQuery(evaluator, batch, renderer, un, start, conf,
                           plain=name == "jax_plain")
          for name in ("kernel", "twin", "jax_plain", "bf16_eps0")}
    halves = {"twin": twin_half(renderer, qs["kernel"].packed),
              "bf16_eps0": bf16_half(renderer)}
    rays = qs["kernel"]._rays(qs["kernel"].delta).detach()
    z = {"kernel": renderer.coarse_resample(rays, qs["kernel"].packed),
         "jax_plain": renderer.coarse_resample(rays, plain=True),
         **{k: h(rays) for k, h in halves.items()}}
    evaluator.timer.clear()
    loss = {}
    for name, qq in qs.items():
        if name in halves:                        # this query's half only
            renderer.coarse_resample = halves[name]
        try:
            loss[name] = qq.step(0)[0]
        finally:
            renderer.__dict__.pop("coarse_resample", None)
    step = dict(zip(qs, (v * 1e3 for v in evaluator.timer["inerf_step_time"])))
    half_ms = cuda_ms(lambda: renderer.coarse_resample(rays, qs["kernel"].packed))
    plain_half_ms = cuda_ms(lambda: renderer.coarse_resample(rays, plain=True),
                            3)
    bf16_half_ms = cuda_ms(lambda: halves["bf16_eps0"](rays))
    cmp = {}
    for a, b in (("kernel", "twin"), ("kernel", "jax_plain"),
                 ("bf16_eps0", "jax_plain")):
        dz = (z[a] - z[b]).abs()
        cmp[f"{a} vs {b}"] = dict(
            loss_rel=abs(loss[a] - loss[b]) / loss[b],
            grad_cos=float(torch.nn.functional.cosine_similarity(
                qs[a].delta.grad, qs[b].delta.grad, dim=0)),
            z_mean=float(dz.mean()), z_max=float(dz.max()))
    log("inerf (b): one step from the same start, the kernel half against "
        "its plain twin (tol: loss 1e-3 relative, gradient cosine > 0.99, "
        "fine z 1e-4 on average) and against the JAX plain half (bounded at "
        "5e-2 relative loss and 5e-2 mean fine z): " + json.dumps(
            {k: {kk: float(f"{vv:.4g}") for kk, vv in v.items()}
             for k, v in cmp.items()})
        + f"; losses {json.dumps(loss)}; step ms "
        f"{json.dumps({k: round(v, 2) for k, v in step.items()})}; the "
        f"kernel half alone {half_ms:.3f} ms, the bf16 eps-0 half "
        f"{bf16_half_ms:.3f}, the JAX plain half {plain_half_ms:.3f}")
    t, p = cmp["kernel vs twin"], cmp["kernel vs jax_plain"]
    c = cmp["bf16_eps0 vs jax_plain"]
    log(f"inerf route: the coarse half stays on the serving stage "
        f"(trunk_int8={renderer.cfg.trunk_int8!r}, eps "
        f"{renderer.cfg.early_term_eps:g}); kernel 1 at bf16 / eps 0 would "
        f"need gradient cosine > 0.99 with the JAX plain half and has "
        f"{c['grad_cos']:.6f} (the serving stage {p['grad_cos']:.6f})")
    assert t["loss_rel"] < 1e-3 and t["grad_cos"] > 0.99 and t["z_mean"] < 1e-4
    assert p["loss_rel"] < 5e-2 and p["z_mean"] < 5e-2
    assert c["loss_rel"] < 5e-2 and c["z_mean"] < 5e-2

    app_r, _ = with_appearance(renderer, nerf_cfg)
    evaluator.timer.clear()
    qa = InerfQuery(evaluator, batch, app_r, un, start, conf)
    losses = [qa.step(j)[0] for j in range(3)]
    with torch.no_grad():
        after = float(qa.loss(qa.delta)[0])
    torch.cuda.synchronize()
    app_ms = [v * 1e3 for v in evaluator.timer["inerf_step_time"]]
    log(f"inerf (d): appearance NeRF (table row 1), 3 steps: ms "
        f"{[round(v, 2) for v in app_ms]}, loss before {losses[0]:.6f} -> "
        f"after {after:.6f} (per step {[round(v, 6) for v in losses]})")
    assert np.isfinite(losses + [after]).all()
    del app_r, qa
    return dict(launches=launches, step_ms=float(np.median(step_ms)),
                peak_gib=peak, half_ms=half_ms, plain_half_ms=plain_half_ms,
                bf16_half_ms=bf16_half_ms, app_step_ms=app_ms)


def phase_check(evaluator, batch):
    """One request's first-iteration matches: GPU (f32 attention operands)
    vs the plain path on the CPU, same weights and inputs."""
    from nerfmatch_tpu_torch.models.attention import set_attention_bf16

    model = evaluator.model
    args = [batch[k][:1] for k in ("image", "pt_feat", "pt3d", "im_mask",
                                   "pt_mask")]
    set_attention_bf16(model, False)
    gpu = evaluator._match(*args, True, 0.0)
    set_attention_bf16(model, True)
    bf = evaluator._match(*args, True, 0.0)
    model.cpu()
    evaluator.device = torch.device("cpu")
    cpu = evaluator._match(*args, True, 0.0)
    for out in (gpu, bf, cpu):
        for k in ("mconf", "expec_f"):
            assert np.isfinite(out[k]).all(), k
    pairs = lambda o: set(zip(o["lists"]["i_ids"][0][o["lists"]["valid"][0]],
                              o["lists"]["j_ids"][0][o["lists"]["valid"][0]]))
    pg, pc, pb = pairs(gpu), pairs(cpu), pairs(bf)
    agree = len(pg & pc) / max(len(pg | pc), 1)
    common = np.asarray(gpu["valid"][0] & cpu["valid"][0]
                        & (gpu["j_ids"][0] == cpu["j_ids"][0]))
    M = gpu["j_ids"].shape[1]
    ef = np.abs(gpu["expec_f"].reshape(-1, M, 3)[0][common]
                - cpu["expec_f"].reshape(-1, M, 3)[0][common])
    ef_max = float(ef.max()) if ef.size else 0.0
    log(f"check: gpu-f32 vs cpu-plain matches {len(pg)} vs {len(pc)}, "
        f"jaccard {agree:.4f} (min 0.98); expec_f max_abs_err {ef_max:.2e} "
        f"(tol 1e-3); bf16-operand vs f32 jaccard "
        f"{len(pb & pg) / max(len(pb | pg), 1):.4f} (reported)")
    assert agree >= 0.98 and ef_max < 1e-3


WIDTH_ROWS = (32, 96, 128, 192)   # MLP widths held beside the room's 256
# The widest encoding the JAX kernels take with an appearance table: F =
# 21 (126 encoding columns), Fd = 18 (111 + 16 extras columns).
WIDE_ENCODING = (21, 18)


def width_renderer(hid, dev, seed=0):
    """The room's NeRF config (8 layers, skip 4, F = 15, Fd = 4, the
    descriptor tapped at layer 3) at MLP width ``hid`` in both stages,
    seeded random weights, density biases raised by 3 (partly opaque)."""
    from nerfmatch_tpu_torch.config import load_yaml_config
    from nerfmatch_tpu_torch.models.layers import init_params_
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer

    cfg, _ = load_yaml_config(ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    cfg.coarse_nerf.hid_dim = cfg.fine_nerf.hid_dim = hid
    r = init_params_(NerfRenderer(cfg, stop_layer=3),
                     torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for mlp in (r.nerf_coarse, r.nerf_fine):
            mlp.alpha_linear.bias += 3.0
    return r.to(dev).eval()


def wide_encoding_mlp(dev, hid=256, seed=0):
    """An 8 x ``hid`` MLP (skip 4, descriptor at layer 3) at the widest
    encoding, with a 16-column appearance block, seeded random weights,
    density bias +3 -> (mlp, F, Fd)."""
    from nerfmatch_tpu_torch.models.layers import init_params_
    from nerfmatch_tpu_torch.nerf.model import NerfConfig, NerfMLP

    F, Fd = WIDE_ENCODING
    cfg = NerfConfig(layer_num=8, hid_dim=hid, xyz_dim=6 * F,
                     dirs_dim=6 * Fd + 3, app_dim=16, use_viewdirs=True,
                     skips=(4,), stop_layer=3)
    mlp = init_params_(NerfMLP(cfg), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        mlp.alpha_linear.bias += 3.0
    return mlp.to(dev), F, Fd


def pack_fused_ms(renderer, scales, reps=5):
    """Host ms of ``NerfRenderer.pack_fused`` at the serving int8 default
    (``fused_predict`` calls it once a call: both stages' kernel weights,
    the int8 trunk, at the kernel width), device synced, mean of ``reps``."""
    import dataclasses

    cfg, act = renderer.cfg, renderer.act_scales
    renderer.cfg = dataclasses.replace(cfg, trunk_int8="coarse")
    renderer.act_scales = scales
    try:
        renderer.pack_fused()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            renderer.pack_fused()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    finally:
        renderer.cfg, renderer.act_scales = cfg, act


def render_width_row(mlp, rays, z, fine, num_freqs=15, dirs_freqs=4,
                     int8=None, plain_int8=None, app=None, eps=1e-4):
    """One render stage at ``mlp``'s width against its plain version (phase
    3's tolerance, 5e-3 scaled; int8: the kernel on ``int8``, packed at the
    kernel width, the plain version on ``plain_int8``) -> its row: errors,
    ms, plain_ms, the bound on the real width's operations."""
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        pack_mlp, render_stage, render_stage_plain)
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        kernel_width)

    kw = dict(fine=fine, num_freqs=num_freqs, dirs_freqs=dirs_freqs,
              early_term_eps=eps, app=app)
    packed = pack_mlp(mlp, int8)
    run_k = lambda: render_stage(mlp, rays, z, packed=packed, int8=int8, **kw)
    run_p = lambda: render_stage_plain(mlp, rays, z, int8=plain_int8, **kw)
    a, b = run_k(), run_p()
    torch.cuda.synchronize()
    err, scaled = max_err(a, b), max_err(a, b, scaled=True)
    assert scaled < 5e-3 and all(torch.isfinite(v).all() for v in a.values()), \
        (mlp.cfg.hid_dim, fine, scaled)
    start = None if int8 is None else int8["start"]
    wbytes = nbytes(*weight_tensors(packed))
    return dict(hid=mlp.cfg.hid_dim, kernel_width=kernel_width(mlp.cfg.hid_dim),
                max_abs_err=err, scaled_err=scaled, ms=cuda_ms(run_k, 3),
                plain_ms=cuda_ms(run_p, 2),
                **render_bound(mlp, fine, rays, z, a, eps, wbytes, start))


def render_width_rows(dev, int8):
    """Phase 3's (bf16) or 3d's (``int8``: the coarse stage of the serving
    default, the fine stage of 'posttap') render rows at ``WIDTH_ROWS``,
    on the room's 9216 rays x 128 samples -> {stage name: {hid: row}}."""
    from nerfmatch_tpu_torch.nerf.model import eval_feat_layer
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_kernel_int8,
                                                       pack_mlp_int8)
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        render_stage_plain)
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z_plain)

    rays = camera_rays(room_c2w(0.4), 96, dev)          # 9216 rays
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    kw = dict(num_freqs=15, dirs_freqs=4, early_term_eps=1e-4)
    tag = "_int8" if int8 else ""
    out = {f"render_coarse{tag}": {}, f"render_fine{tag}": {}}
    for hid in WIDTH_ROWS:
        r = width_renderer(hid, dev, seed=hid)
        cmlp, fmlp = r.nerf_coarse, r.nerf_fine
        qs = {False: (None, None), True: (None, None)}
        if int8:
            scales = calibrate_act_scales(r, rays[:1024])
            pack_ms = pack_fused_ms(r, scales)
            log(f"pack_fused at hid {hid} (int8 'coarse'): {pack_ms:.2f} ms "
                f"of host time a call")
            tap = eval_feat_layer(fmlp.cfg)
            qs = {False: (pack_kernel_int8(cmlp, scales["coarse"], 0),
                          pack_mlp_int8(cmlp, scales["coarse"], 0)),
                  True: (pack_kernel_int8(fmlp, scales["fine"], tap + 1, tap),
                         pack_mlp_int8(fmlp, scales["fine"], tap + 1, tap))}
        zf = resample_z_plain(z, render_stage_plain(
            cmlp, rays, z, fine=False, int8=qs[False][1], **kw)["weights"]
        ).contiguous()
        for name, mlp, fine, zz in ((f"render_coarse{tag}", cmlp, False, z),
                                    (f"render_fine{tag}", fmlp, True, zf)):
            row = render_width_row(mlp, rays, zz, fine, int8=qs[fine][0],
                                   plain_int8=qs[fine][1])
            if int8:
                row["pack_fused_ms"] = pack_ms
            out[name][str(hid)] = row
            log(f"kernel {name} hid={hid} (run at {row['kernel_width']}) "
                f"eps=1e-4: max_abs_err={row['max_abs_err']:.3e} scaled "
                f"{row['scaled_err']:.3e} (tol 5e-3) ms={row['ms']:.3f} "
                f"plain_ms={row['plain_ms']:.3f} bound_ms="
                f"{row['bound_ms']:.3f} ({row['bound_by']}, real width)")
        del r
    return out


def wide_encoding_render_row(dev):
    """Kernel 1's fine stage at the widest encoding with appearance rows
    (``wide_encoding_mlp``) against its plain version -> its row."""
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        render_stage_plain)
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z_plain)

    mlp, F, Fd = wide_encoding_mlp(dev)
    rays = camera_rays(room_c2w(0.4), 96, dev)
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    g = torch.Generator(dev).manual_seed(2)
    app = 0.5 * torch.randn(2, 16, device=dev, generator=g)[
        torch.arange(rays.shape[0], device=dev) % 2].contiguous()
    zf = resample_z_plain(z, render_stage_plain(
        mlp, rays, z, fine=False, num_freqs=F, dirs_freqs=Fd,
        early_term_eps=1e-4)["weights"]).contiguous()
    row = render_width_row(mlp, rays, zf, True, F, Fd, app=app)
    row.update(num_freqs=F, dirs_freqs=Fd, app_dim=16)
    log(f"kernel render_fine_app at F={F}, Fd={Fd} (+16 appearance columns), "
        f"hid 256: max_abs_err={row['max_abs_err']:.3e} scaled "
        f"{row['scaled_err']:.3e} (tol 5e-3) ms={row['ms']:.3f} plain_ms="
        f"{row['plain_ms']:.3f} bound_ms={row['bound_ms']:.3f}")
    return row


def train_bwd_yardstick(mlp, rows):
    """``torch.mm`` (cuBLAS) over the weight-gradient products of ``mlp``'s
    matrices at their real shapes, bf16, ``rows`` sample rows each: the
    library time beside the backward; the port never calls it."""
    dev = next(mlp.parameters()).device
    gen = torch.Generator(dev).manual_seed(7)
    shapes = [lin.weight.shape for lin in (*mlp.pts_linears, mlp.feature_linear,
                                           mlp.views_linears[0], mlp.rgb_linear)]
    widest = max(max(s) for s in shapes)
    a = torch.randn(rows, widest, device=dev, generator=gen).bfloat16()
    b = torch.randn(rows, widest, device=dev, generator=gen).bfloat16()
    return cuda_ms(lambda: [torch.mm(a[:, :i].t(), b[:, :o]) for o, i in shapes], 3)


def train_width_row(spec, rays, z, noise, target, app=None):
    """Kernels 5 (the training forward with its stash) and 6 (the backward
    on it) at ``spec.mlp``'s width against the plain stage (phase 3b's
    tolerances: forward 5e-3; backward 3e-2 of each leaf's largest gradient
    with cosine > 0.999) -> (forward row, backward row), each with its
    bound on the real width's operations and ``torch.mm`` over the same
    products."""
    from nerfmatch_tpu_torch.ops.kernels import render_train_kernel as rtk

    mlp, cfg = spec.mlp, spec.mlp.cfg
    n, S = z.shape[0], z.shape[1] - 1
    packed = rtk.pack_train(mlp)
    with torch.no_grad():
        rgb, w, stash = rtk.kernel_forward(spec, rays, z, noise, packed,
                                           stash=True, app=app)
        rgb_p, w_p = rtk.train_stage_forward(spec, rays, z, noise, app=app)
    g_rgb, g_w = train_cotangents(z, rgb, w, target)
    ga = rtk.kernel_backward(spec, stash, rays, z, noise, g_rgb, g_w, packed,
                             app)
    gb = rtk.train_stage_backward(spec, rays, z, noise, g_rgb, g_w, app=app)
    torch.cuda.synchronize()
    fwd_err = max(float((rgb - rgb_p).abs().max()), float((w - w_p).abs().max()))
    leaf = {}
    for k, ref in gb.items():
        got = ga[k]
        assert got.shape == ref.shape and torch.isfinite(got).all(), k
        cos = float((got * ref).sum()) / max(float(got.norm() * ref.norm()), 1e-30)
        leaf[k] = (scaled_err(got, ref), cos)
    bwd_err = max(e for e, _ in leaf.values())
    min_cos = min(c for _, c in leaf.values() if c != 0.0)
    assert fwd_err < 5e-3 and bwd_err < 3e-2 and min_cos > 0.999, \
        (cfg.hid_dim, fwd_err, bwd_err, min_cos)
    with torch.no_grad():
        ms_f = cuda_ms(lambda: rtk.kernel_forward(spec, rays, z, noise, packed,
                                                  stash=True, app=app), 3)
        plain_f = cuda_ms(lambda: rtk.train_stage_forward(spec, rays, z, noise,
                                                          app=app), 2)
        ms_b = cuda_ms(lambda: rtk.kernel_backward(
            spec, stash, rays, z, noise, g_rgb, g_w, packed, app), 3)
        plain_b = cuda_ms(lambda: rtk.train_stage_backward(
            spec, rays, z, noise, g_rgb, g_w, app=app), 1)
    del stash
    # The real width's work: its operations and its own stash's bytes.
    fwd_ops = {k: 2 * m * n * S for k, m in stage_macs(mlp, True).items()}
    stash_b = sum(rtk._stash_parts(cfg, n, S))
    w_bytes = sum(p.numel() * 2 for p in mlp.parameters())
    g_bytes = sum(p.numel() * 4 for p in mlp.parameters())
    io = nbytes(rays, z, noise, rgb, w) + w_bytes
    common = dict(hid=cfg.hid_dim, kernel_width=rtk.kernel_width(cfg.hid_dim))
    fwd = dict(common, max_abs_err=fwd_err, ms=ms_f, plain_ms=plain_f,
               library_ms=train_fwd_yardstick(spec, n * S),
               **bound(fwd_ops, io + stash_b))
    bwd = dict(common, max_abs_err=bwd_err, min_cosine=min_cos, ms=ms_b,
               plain_ms=plain_b, library_ms=train_bwd_yardstick(mlp, n * S),
               **bound({k: 2 * v for k, v in fwd_ops.items()},
                       nbytes(rays, z, noise, g_rgb, g_w) + w_bytes + g_bytes
                       + stash_b))
    log(f"kernel render_train hid={cfg.hid_dim} (run at {fwd['kernel_width']}"
        f"{'' if app is None else ', appearance rows'}, F={spec.num_freqs}, "
        f"Fd={spec.dirs_freqs}): forward max_abs_err={fwd_err:.3e} (tol 5e-3) "
        f"ms={ms_f:.3f} plain_ms={plain_f:.3f} torch.mm {fwd['library_ms']:.3f}"
        f" bound {fwd['bound_ms']:.3f} ({fwd['bound_by']}); backward max "
        f"scaled err={bwd_err:.3e} (tol 3e-2) min cosine {min_cos:.6f} (tol "
        f"0.999) ms={ms_b:.3f} plain_ms={plain_b:.3f} torch.mm "
        f"{bwd['library_ms']:.3f} bound {bwd['bound_ms']:.3f} "
        f"({bwd['bound_by']})")
    return fwd, bwd


def train_width_rows(dev):
    """Phase 3b's rows at ``WIDTH_ROWS`` (each width's fine MLP on phase
    3b's 9216 rays x 128 jittered samples) and at the widest encoding with
    appearance rows -> {row name: {hid or 'wide_encoding': row}}."""
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import StageSpec

    from nerfmatch_tpu_torch.ops import kernels

    lib = kernels.library()
    for hid in (64, 128, 192, 256):
        log(f"train kernels <{hid}>: dynamic shared memory forward "
            f"{lib.nm_render_train_smem(hid, 8, 4, 0, 1)} bytes (Fd = 4; "
            f"{lib.nm_render_train_smem(hid, 8, 18, 16, 1)} at Fd = 18 with "
            f"appearance rows), trunk backward "
            f"{lib.nm_render_train_smem(hid, 8, 4, 0, 0)} (8 layers)")
    out = {"render_train_fwd": {}, "render_train_bwd": {}}
    for hid in WIDTH_ROWS:
        r = width_renderer(hid, dev, seed=hid)
        spec, rays, z, noise, target = train_inputs(r, dev)
        fwd, bwd = train_width_row(spec, rays, z, noise, target)
        out["render_train_fwd"][str(hid)] = fwd
        out["render_train_bwd"][str(hid)] = bwd
        del r, spec
    mlp, F, Fd = wide_encoding_mlp(dev)
    _, rays, z, noise, target = train_inputs(None, dev)
    g = torch.Generator(dev).manual_seed(3)
    app = 0.5 * torch.randn(2, 16, device=dev, generator=g)[
        torch.arange(rays.shape[0], device=dev) % 2].contiguous()
    fwd, bwd = train_width_row(StageSpec(mlp, F, Fd), rays, z, noise, target,
                               app)
    for row in (fwd, bwd):
        row.update(num_freqs=F, dirs_freqs=Fd, app_dim=16)
    out["render_train_fwd_app"] = {"wide_encoding": fwd}
    out["render_train_bwd_app"] = {"wide_encoding": bwd}
    return out


def train_inputs(renderer, dev):
    """Phase 3b's stage: the room's fine MLP on 9216 rays, 128 jittered
    samples, density noise of std 1 -> (spec, rays, z, noise, target); the
    spec None without a renderer."""
    from nerfmatch_tpu_torch.nerf.sampling import (jitter_fenceposts,
                                                   jitter_uniforms)
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import StageSpec

    g = torch.Generator(dev).manual_seed(1)
    rays = camera_rays(room_c2w(0.4), 96, dev)           # 9216 rays
    n, S = rays.shape[0], 128
    t = torch.linspace(0.0, 1.0, S + 1, device=dev)
    z = jitter_fenceposts(rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t,
                          jitter_uniforms(n, S + 1, g, dev)).contiguous()
    noise = torch.randn(n, S, device=dev, generator=g)   # noise_std 1.0
    target = torch.rand(n, 3, device=dev, generator=g)
    return (None if renderer is None else StageSpec(renderer.nerf_fine, 15, 4),
            rays, z, noise, target)


def train_cotangents(z, rgb, w, target):
    """(g_rgb, g_w) of the loss rgb MSE + 0.01 distortion."""
    from nerfmatch_tpu_torch.nerf.compositing import t_to_s
    from nerfmatch_tpu_torch.utils.metrics import distortion_loss

    rgb_r, w_r = rgb.detach().requires_grad_(), w.detach().requires_grad_()
    loss = ((rgb_r - target) ** 2).mean() + 0.01 * distortion_loss(
        t_to_s(z, z.min(), z.max()), w_r)
    return torch.autograd.grad(loss, (rgb_r, w_r))


def phase_train_kernels(renderer, dev):
    """Train-render kernels (the training forward with its stash, the
    no-gradient forward, the backward on the stash) vs the plain version at
    the training path's shapes -> summary rows."""
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        backward_layout, kernel_backward, kernel_forward, pack_train,
        train_stage_backward, train_stage_forward)

    spec, rays, z, noise, target = train_inputs(renderer, dev)
    n, S = z.shape[0], z.shape[1] - 1
    packed = pack_train(spec.mlp)
    with torch.no_grad():
        rgb, w, stash = kernel_forward(spec, rays, z, noise, packed,
                                       stash=True)
        rgb_n, w_n, _ = kernel_forward(spec, rays, z, noise, packed)
        rgb_p, w_p = train_stage_forward(spec, rays, z, noise)
    torch.cuda.synchronize()
    same = torch.equal(rgb, rgb_n) and torch.equal(w, w_n)
    log(f"kernel render_train_fwd: stashing and no-gradient forwards "
        f"bit-identical: {same}")
    assert same, "the stashing forward differs from the no-gradient forward"
    g_rgb, g_w = train_cotangents(z, rgb, w, target)
    ga = kernel_backward(spec, stash, rays, z, noise, g_rgb, g_w, packed)
    gb = train_stage_backward(spec, rays, z, noise, g_rgb, g_w)
    again = kernel_backward(spec, stash, rays, z, noise, g_rgb, g_w, packed)
    torch.cuda.synchronize()
    differ = [k for k in ga if not torch.equal(ga[k], again[k])]
    log(f"kernel render_train_bwd: two calls bit-identical: {not differ}")
    assert not differ, f"backward reruns differ: {differ}"
    # Same bf16 operand roundings on both sides: f32 sums in other orders
    # (and the gradients' bf16 rounding ties they break apart) remain.
    fwd_err = max(float((rgb - rgb_p).abs().max()),
                  float((w - w_p).abs().max()))
    leaf = {}
    for k, ref in gb.items():
        got = ga[k]
        assert torch.isfinite(got).all(), k
        scale = float(ref.abs().max())
        cos = float((got * ref).sum()) / max(float(got.norm() * ref.norm()),
                                             1e-30)
        leaf[k] = (float((got - ref).abs().max()) / max(scale, 1e-30), cos)
    bwd_err = max(e for e, _ in leaf.values())
    worst = max(leaf, key=lambda k: leaf[k][0])
    min_cos = min(c for _, c in leaf.values())
    with torch.no_grad():
        ms_s = cuda_ms(lambda: kernel_forward(spec, rays, z, noise, packed,
                                              stash=True), 5)
        ms_f = cuda_ms(lambda: kernel_forward(spec, rays, z, noise, packed), 5)
        plain_f = cuda_ms(lambda: train_stage_forward(spec, rays, z, noise), 2)
        ms_b = cuda_ms(lambda: kernel_backward(spec, stash, rays, z, noise,
                                               g_rgb, g_w, packed), 3)
        plain_b = cuda_ms(lambda: train_stage_backward(spec, rays, z, noise,
                                                       g_rgb, g_w), 1)
    lay = backward_layout(spec.mlp.cfg, n, S)
    log(f"kernel render_train_fwd: max_abs_err={fwd_err:.3e} (rgb and "
        f"weights, tol 5e-3) training forward with its stash ms={ms_s:.3f}, "
        f"no-gradient forward ms={ms_f:.3f}, plain_ms={plain_f:.3f} "
        f"acc max={float(w.sum(-1).max()):.3f}; stash {lay.stash / 1e9:.3f} "
        f"GB = {lay.stash / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    log(f"kernel render_train_bwd: max scaled err={bwd_err:.3e} ({worst}; "
        f"tol 3e-2 of each leaf's largest gradient), min cosine "
        f"{min_cos:.6f} (tol 0.999) ms={ms_b:.3f} plain_ms={plain_b:.3f} "
        f"(plain chunked over 1024 rays, recomputing its forward)")
    log("  per-leaf scaled err: " + json.dumps(
        {k: float(f"{e:.2e}") for k, (e, _) in leaf.items()}))
    assert fwd_err < 5e-3 and bwd_err < 3e-2 and min_cos > 0.999
    train_bwd_parts(spec, stash, rays, z, noise, g_rgb, g_w, packed)
    lib_f = train_fwd_yardstick(spec, n * S)
    del stash
    # Forward: every sample through the trunk and heads (no early
    # termination in training); the training forward also writes the
    # stash.  Backward: the two products of each forward product's gradient
    # (activations and weights), reading the stash.
    fwd_ops = {k: 2 * m * n * S for k, m in stage_macs(spec.mlp, True).items()}
    w_bytes = sum(p.numel() * 2 for p in spec.mlp.parameters())   # bf16
    g_bytes = sum(p.numel() * 4 for p in spec.mlp.parameters())   # f32 grads
    io = nbytes(rays, z, noise, rgb, w) + w_bytes
    nograd = bound(fwd_ops, io)
    log(f"kernel render_train_fwd (no gradient): ms={ms_f:.3f} bound_ms="
        f"{nograd['bound_ms']:.3f} ({nograd['bound_by']}) plain_ms="
        f"{plain_f:.3f} library_ms={lib_f:.3f}")
    return {"render_train_fwd": dict(
                max_abs_err=fwd_err, ms=ms_s, plain_ms=plain_f,
                library_ms=lib_f, **bound(fwd_ops, io + lay.stash)),
            "render_train_bwd": dict(
                max_abs_err=bwd_err, ms=ms_b, plain_ms=plain_b, library_ms=None,
                **bound({k: 2 * v for k, v in fwd_ops.items()},
                        nbytes(rays, z, noise, g_rgb, g_w) + w_bytes + g_bytes
                        + lay.stash))}


def plain_g_app_on_kernel_mask(spec, stash, rays, z, noise, app, g_rgb,
                               chunk=1024):
    """The plain version's ``g_app`` (its bf16 roundings: ``train_stage_
    backward``'s rgb head, ``g_hvsum`` rounded once, times ``wva``) with the
    views layer's ReLU mask read from the kernel's stashed bf16 ``hv``
    instead of its own, and (N,) bool: the rays at one of whose samples the
    two masks differ (bf16 operands summed in another order leave
    pre-activations near 0 on either side) -> (g_app (N, 16), flips)."""
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        _align256, _bf16, _stash_parts, train_stage_forward)

    mlp, cfg = spec.mlp, spec.mlp.cfg
    n, S, hv = z.shape[0], z.shape[1] - 1, cfg.hid_dim // 2
    # The stash holds xb, hs of every layer, feat, then hv (carve_stash).
    off = sum(map(_align256, _stash_parts(cfg, n, S)[:cfg.layer_num + 2]))
    k_hv = stash[off:off + n * S * hv * 2].view(torch.bfloat16).view(n, S, hv)
    wrgb = _bf16(mlp.rgb_linear.weight)
    wva = _bf16(mlp.views_linears[0].weight[:, cfg.hid_dim + cfg.dirs_dim:])
    g_app, flips = [], []
    with torch.no_grad():
        for lo in range(0, n, chunk):
            sl = slice(lo, lo + chunk)
            _, w, f = train_stage_forward(spec, rays[sl], z[sl], noise[sl],
                                          keep=True, app=app[sl])
            mask = k_hv[sl] > 0
            g_rgbt = (g_rgb[sl][:, None, :] * w[..., None] * f["rgb_s"]
                      * (1.0 - f["rgb_s"]))
            g_hv = torch.where(mask, _bf16(g_rgbt) @ wrgb, 0.0)
            g_app.append(_bf16(g_hv.sum(1)) @ wva)
            flips.append((mask != (f["hv"] > 0)).flatten(1).any(1))
    return torch.cat(g_app), torch.cat(flips)


def phase_train_app_kernels(renderer, dev):
    """Phase 3b with appearance rows: kernels 5 and 6 on the room's fine MLP
    with :func:`app_mlp`'s seeded 16-column views block and (2, 16) table
    (rays alternating rows) at phase 3b's shapes, against the plain version
    with the same rows (rgb / weights 5e-3; every parameter gradient and
    the appearance rows' weight gradient 3e-2 of the leaf's largest and
    cosine > 0.999; ``g_app``, a gradient per ray, cosine > 0.999 and, on
    every ray, 3e-2 of its largest against the plain version taken with the
    kernel's own views-ReLU mask, the error against the plain version's
    own mask reported beside it), the backward rerun bit-identical, each pass timed with and without ``app`` in turns beside
    its bound -> summary rows."""
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        StageSpec, backward_layout, kernel_backward, kernel_forward,
        pack_train, train_stage_backward, train_stage_forward)

    spec, rays, z, noise, target = train_inputs(renderer, dev)
    amlp, table = app_mlp(spec.mlp)
    aspec = StageSpec(amlp, spec.num_freqs, spec.dirs_freqs)
    n, S = z.shape[0], z.shape[1] - 1
    hv = amlp.cfg.hid_dim // 2
    app = table[torch.arange(n, device=dev) % 2].contiguous()
    packed, apacked = pack_train(spec.mlp), pack_train(amlp)
    with torch.no_grad():
        rgb, w, stash = kernel_forward(aspec, rays, z, noise, apacked,
                                       stash=True, app=app)
        rgb_b, w_b, stash_b = kernel_forward(spec, rays, z, noise, packed,
                                             stash=True)
        rgb_p, w_p = train_stage_forward(aspec, rays, z, noise, app=app)
    g_rgb, g_w = train_cotangents(z, rgb, w, target)
    ga = kernel_backward(aspec, stash, rays, z, noise, g_rgb, g_w, apacked,
                         app)
    again = kernel_backward(aspec, stash, rays, z, noise, g_rgb, g_w,
                            apacked, app)
    gb = train_stage_backward(aspec, rays, z, noise, g_rgb, g_w, app=app)
    torch.cuda.synchronize()
    differ = [k for k in ga if not torch.equal(ga[k], again[k])]
    log(f"kernel render_train_bwd_app: two calls bit-identical (g_app "
        f"included): {not differ}")
    assert not differ, f"backward reruns differ: {differ}"
    fwd_err = max(float((rgb - rgb_p).abs().max()),
                  float((w - w_p).abs().max()))
    moved = float((rgb - rgb_b).abs().max())
    leaf = {}
    views = "views_linears.0.weight"
    pairs = [(k, ga[k], gb[k]) for k in gb]
    pairs.append((views + "[app rows]", ga[views][:, -16:], gb[views][:, -16:]))
    for k, got, ref in pairs:
        assert torch.isfinite(got).all(), k
        scale = float(ref.abs().max())
        cos = float((got * ref).sum()) / max(float(got.norm() * ref.norm()),
                                             1e-30)
        leaf[k] = (float((got - ref).abs().max()) / max(scale, 1e-30), cos)
    # A ray's g_app sums its samples' g_hv: where the ReLU of the views
    # layer flips between the two versions, a whole g_hv element differs,
    # which a weight gradient's sum over 1.2M rows hides and a ray's does
    # not.  So every ray is held to the plain g_app on the kernel's mask;
    # the plain version's own g_app is reported apart.
    g_app_km, flips = plain_g_app_on_kernel_mask(aspec, stash, rays, z, noise,
                                                 app, g_rgb)
    scale_app = float(gb["app"].abs().max())
    app_err = float((ga["app"] - g_app_km).abs().max()) / scale_app
    app_d = (ga["app"] - gb["app"]).abs().max(1).values / scale_app
    app_same = float(app_d[~flips].max())
    app_flip = float(app_d[flips].max()) if bool(flips.any()) else 0.0
    bwd_err = max(e for k, (e, _) in leaf.items() if k != "app")
    min_cos = min(c for _, c in leaf.values())
    with torch.no_grad():
        fa = lambda: kernel_forward(aspec, rays, z, noise, apacked,
                                    stash=True, app=app)
        fb = lambda: kernel_forward(spec, rays, z, noise, packed, stash=True)
        fms = [cuda_ms(f, 5) for f in (fb, fa, fa, fb)]
        ba = lambda: kernel_backward(aspec, stash, rays, z, noise, g_rgb, g_w,
                                     apacked, app)
        bb = lambda: kernel_backward(spec, stash_b, rays, z, noise, g_rgb,
                                     g_w, packed)
        bms = [cuda_ms(f, 3) for f in (bb, ba, ba, bb)]
        plain_f = cuda_ms(lambda: train_stage_forward(aspec, rays, z, noise,
                                                      app=app), 2)
        plain_b = cuda_ms(lambda: train_stage_backward(
            aspec, rays, z, noise, g_rgb, g_w, app=app), 1)
    lay = backward_layout(amlp.cfg, n, S)
    del stash, stash_b
    # The trunk and heads as phase 3b counts them, plus app @ Wva once a
    # ray (f32 FMAs); the backward adds the appearance rows' weight-gradient
    # product (bf16) and g_app (f32), once a ray each.
    fwd_ops = {k: 2 * m * n * S for k, m in stage_macs(spec.mlp, True).items()}
    app_ops = 2 * 16 * hv * n
    fwd_ops["f32"] += app_ops
    bwd_ops = {k: 2 * v for k, v in fwd_ops.items()}
    bwd_ops["bf16"] += app_ops
    bwd_ops["f32"] += app_ops
    w_bytes = sum(p.numel() * 2 for p in amlp.parameters())
    g_bytes = sum(p.numel() * 4 for p in amlp.parameters())
    fwd_row = dict(max_abs_err=fwd_err, ms=(fms[1] + fms[2]) / 2,
                   ms_without_app=(fms[0] + fms[3]) / 2, plain_ms=plain_f,
                   library_ms=None, **bound(fwd_ops, nbytes(
                       rays, z, noise, app, rgb, w) + w_bytes + lay.stash))
    bwd_row = dict(max_abs_err=bwd_err, g_app_err=app_err,
                   g_app_err_own_mask=app_same,
                   g_app_err_own_mask_relu_flips=app_flip,
                   rays_with_relu_flips=int(flips.sum()),
                   ms=(bms[1] + bms[2]) / 2,
                   ms_without_app=(bms[0] + bms[3]) / 2, plain_ms=plain_b,
                   library_ms=None, **bound(bwd_ops, nbytes(
                       rays, z, noise, g_rgb, g_w, ga["app"]) + w_bytes
                       + g_bytes + lay.stash))
    log(f"kernel render_train_fwd_app: max_abs_err={fwd_err:.3e} (rgb and "
        f"weights, tol 5e-3, vs plain with the same rows) training forward "
        f"with its stash ms={fwd_row['ms']:.3f} (without app "
        f"{fwd_row['ms_without_app']:.3f}; in turns "
        f"{[round(v, 4) for v in fms]}) plain_ms={plain_f:.3f} bound_ms="
        f"{fwd_row['bound_ms']:.3f} ({fwd_row['bound_by']}); rgb moved by the "
        f"rows up to {moved:.3e}; stash {lay.stash / 1e9:.3f} GB")
    log(f"kernel render_train_bwd_app: max scaled err={bwd_err:.3e} (tol "
        f"3e-2 of each parameter leaf's largest gradient; app rows of the "
        f"views weight {leaf[views + '[app rows]'][0]:.2e}, cosine "
        f"{leaf[views + '[app rows]'][1]:.6f}); g_app cosine "
        f"{leaf['app'][1]:.6f}, scaled err {app_err:.2e} on all {n} rays "
        f"against the plain g_app on the kernel's views-ReLU mask (tol "
        f"3e-2); against the plain version's own mask {app_same:.2e} on the "
        f"{n - int(flips.sum())} rays where the masks agree, {app_flip:.2e} "
        f"on the {int(flips.sum())} where they differ at some sample; min "
        f"cosine "
        f"{min_cos:.6f} (tol 0.999) ms={bwd_row['ms']:.3f} (without app "
        f"{bwd_row['ms_without_app']:.3f}; in turns "
        f"{[round(v, 4) for v in bms]}) plain_ms={plain_b:.3f} bound_ms="
        f"{bwd_row['bound_ms']:.3f} ({bwd_row['bound_by']})")
    log("  per-leaf scaled err: " + json.dumps(
        {k: float(f"{e:.2e}") for k, (e, _) in leaf.items()}))
    assert fwd_err < 5e-3 and bwd_err < 3e-2 and min_cos > 0.999
    assert app_err < 3e-2, app_err
    assert moved > 1e-3, "the appearance rows do not move rgb"
    return {"render_train_fwd_app": fwd_row, "render_train_bwd_app": bwd_row}


def train_fwd_yardstick(spec, rows):
    """``torch.mm`` (cuBLAS) over the train stage's MLP products at their
    shapes, bf16, one call each (trunk, feature, views on ``rows`` sample
    rows): the library time beside the forward kernel; the port never
    calls it."""
    cfg, mlp = spec.mlp.cfg, spec.mlp
    dev = next(mlp.parameters()).device
    gen = torch.Generator(dev).manual_seed(6)
    widest = max(lin.in_features for lin in mlp.pts_linears)
    x = torch.randn(rows, widest, device=dev, generator=gen).bfloat16()
    ws = [lin.weight.detach().t().bfloat16() for lin in mlp.pts_linears]
    ws += [mlp.feature_linear.weight.detach().t().bfloat16(),
           mlp.views_linears[0].weight.detach()[:, :cfg.hid_dim].t().bfloat16()]
    ms = cuda_ms(lambda: [torch.mm(x[:, :wt.shape[0]], wt) for wt in ws], 3)
    log(f"  yardstick: torch.mm over the forward's {len(ws)} MLP products "
        f"({rows} rows, bf16) {ms:.3f} ms (library_ms of the train forward; "
        f"never called by the port)")
    return ms


def train_bwd_parts(spec, stash, rays, z, noise, g_rgb, g_w, packed):
    """Kernel 6's three launches in one call (one ``torch.profiler`` pass),
    the bytes each moves with their time at 3.35 TB/s, and ``torch.mm`` on
    stash-shaped bf16 operands for the weight-gradient GEMM's products (the
    yardstick of that launch; the port never calls it).  The backward reads
    the stash and launches no forward."""
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        backward_layout, kernel_backward)

    cfg = spec.mlp.cfg
    n, S, H = rays.shape[0], z.shape[1] - 1, cfg.hid_dim
    layout = backward_layout(cfg, n, S)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        kernel_backward(spec, stash, rays, z, noise, g_rgb, g_w, packed)
        torch.cuda.synchronize()
    names = {"train_bwd_kernel": "trunk backward", "wgrad_gemm_kernel":
             "weight-gradient GEMM", "reduce_parts_kernel": "reductions"}
    part_ms = dict.fromkeys(names.values(), 0.0)
    fwd = 0
    for e in prof.key_averages():
        fwd += e.count if "train_fwd_kernel" in e.key else 0
        for key, label in names.items():
            if key in e.key:
                part_ms[label] += e.self_device_time_total / 1e3
    assert fwd == 0, f"kernel_backward launched train_fwd_kernel {fwd} times"
    assert all(part_ms.values()), f"a backward launch is missing: {part_ms}"
    ws = layout.traffic
    gen = torch.Generator(rays.device).manual_seed(5)
    a = torch.randn(n * S, H, device=rays.device, generator=gen).bfloat16()
    b = torch.randn(n * S, H, device=rays.device, generator=gen).bfloat16()
    xs = [(a[:r, :m], b[:r, :k]) for m, k, r in layout.products]
    lib_ms = cuda_ms(lambda: [torch.mm(x.t(), y) for x, y in xs], 3)
    del a, b, xs
    total = sum(ws.values())
    log("kernel render_train_bwd launches (one call, torch.profiler; no "
        "train_fwd_kernel): " + ", ".join(
            f"{k} {part_ms[k]:.3f} ms ({ws[k] / 1e9:.2f} GB, "
            f"{ws[k] / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s)" for k in ws))
    log(f"  backward traffic {total / 1e9:.2f} GB per call = "
        f"{total / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s; weight-gradient "
        f"GEMM {part_ms['weight-gradient GEMM']:.3f} ms vs torch.mm on "
        f"stash-shaped bf16 operands {lib_ms:.3f} ms (library_ms of that "
        f"launch; never called by the port)")


def scaled_err(a, b):
    """Largest absolute error over the largest absolute reference value."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_matcher_kernels(dev):
    """The fused StarReLU + depthwise conv (kernels 7, 8, 9) and the
    attention backward (kernel 4) vs their plain versions at matcher
    training's shapes -> summary rows."""
    from torch.nn import functional as F

    from nerfmatch_tpu_torch.ops.kernels import attention_kernel as ak
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_bwd, attention_bwd_plain)
    from nerfmatch_tpu_torch.ops.kernels.sepconv_kernel import (
        dw_star_dgrad, dw_star_dgrad_plain, dw_star_fwd, dw_star_plain,
        dw_star_wgrad, dw_star_wgrad_plain)

    rows = {}
    g = torch.Generator(dev).manual_seed(2)
    # f32 on both sides (TF32 is off): the kernels sum the 49 taps, and the
    # per-block partials of ds, db and dw, in other orders than cuDNN and
    # torch.sum do.  Batch 2 (training) at both stages, then batch 1
    # (serving).
    for stage, shape in (("stage 0", (2, 240, 240, 256)),
                         ("stage 1", (2, 60, 60, 512)),
                         ("stage 0", (1, 240, 240, 256)),
                         ("stage 1", (1, 60, 60, 512))):
        train = shape[0] == 2   # the serving batch takes no weight gradient
        C = shape[-1]
        x = torch.randn(shape, device=dev, generator=g)
        w = torch.randn(7, 7, C, device=dev, generator=g) * 0.1
        cb = torch.randn(C, device=dev, generator=g)
        s = torch.tensor(0.8944, device=dev)
        b = torch.tensor(-0.4472, device=dev)
        up = torch.randn(shape, device=dev, generator=g)
        y, y_p = dw_star_fwd(x, w, cb, s, b), dw_star_plain(x, w, cb, s, b)
        dx, ds, db = dw_star_dgrad(x, w, s, up)
        dx_p, ds_p, db_p = dw_star_dgrad_plain(x, w, s, up)
        rerun = dw_star_dgrad(x, w, s, up)
        same = (torch.equal(rerun[0], dx) and torch.equal(rerun[1], ds)
                and torch.equal(rerun[2], db))
        outs = [y, dx, ds, db]
        if train:
            dw, dw_p = (dw_star_wgrad(x, s, b, up),
                        dw_star_wgrad_plain(x, s, b, up))
            same = same and torch.equal(dw_star_wgrad(x, s, b, up), dw)
            outs.append(dw)
        wf = torch.flip(w, (0, 1)).permute(2, 0, 1).unsqueeze(1)
        dact = F.conv2d(up.permute(0, 3, 1, 2), wf, padding=3,
                        groups=C).permute(0, 2, 3, 1)
        r2 = torch.relu(x) ** 2
        torch.cuda.synchronize()
        errs = {"y": scaled_err(y, y_p), "dx": scaled_err(dx, dx_p),
                "ds": abs(float(ds - ds_p)) / float((dact * r2).abs().sum()),
                "db": abs(float(db - db_p)) / float(dact.abs().sum())}
        times = {
            "dw_star_fwd": (cuda_ms(lambda: dw_star_fwd(x, w, cb, s, b)),
                            cuda_ms(lambda: dw_star_plain(x, w, cb, s, b))),
            "dw_star_dgrad": (cuda_ms(lambda: dw_star_dgrad(x, w, s, up)),
                              cuda_ms(lambda: dw_star_dgrad_plain(x, w, s, up)))}
        abs_err = {"dw_star_fwd": float((y - y_p).abs().max()),
                   "dw_star_dgrad": float((dx - dx_p).abs().max())}
        # f32 multiply-adds of the 49 taps per element; each tensor read or
        # written once (StarReLU + conv is no single PyTorch call).
        taps = {"f32": 2 * 49 * x.numel()}
        moved = {"dw_star_fwd": nbytes(x, w, cb, y),
                 "dw_star_dgrad": nbytes(x, w, up, dx)}
        wgrad_extra = {}
        if train:
            errs["dw"] = scaled_err(dw, dw_p)
            times["dw_star_wgrad"] = (
                cuda_ms(lambda: dw_star_wgrad(x, s, b, up)),
                cuda_ms(lambda: dw_star_wgrad_plain(x, s, b, up), 3))
            abs_err["dw_star_wgrad"] = float((dw - dw_p).abs().max())
            moved["dw_star_wgrad"] = nbytes(x, up, dw)
            wgrad_extra = dict(kernel_ms=wgrad_alone_ms(x, s, b, up),
                               conv_wgrad_alone_ms=conv_wgrad_alone_ms(x, up))
        bounds = {k: bound(taps, moved[k]) for k in times}
        log(f"kernel dw_star {stage} {tuple(shape)}: scaled err "
            + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
            + " (tol 1e-4 of the largest value for y, dx, dw; 1e-5 of the "
            "sum of |terms| for ds, db); rerun bit-identical "
            f"{same}; ms / plain_ms " + json.dumps(
                {k: [round(a, 3), round(p, 3)] for k, (a, p) in times.items()})
            + "; bound_ms " + json.dumps(
                {k: round(v["bound_ms"], 4) for k, v in bounds.items()})
            + f"; conv_alone_ms {conv_alone_ms(x, w):.4f}"
            + "".join(f"; wgrad {k} {v:.4f}" for k, v in wgrad_extra.items()))
        assert max(v for k, v in errs.items() if k in ("y", "dx", "dw")) < 1e-4
        assert max(errs["ds"], errs["db"]) < 1e-5 and same
        assert all(torch.isfinite(t).all() for t in outs)
        if train:
            got = {k: dict(max_abs_err=abs_err[k], ms=a, plain_ms=p,
                           library_ms=None, **bounds[k])
                   for k, (a, p) in times.items()}
            got["dw_star_wgrad"].update(wgrad_extra)
            if stage == "stage 0":
                rows.update(got)
            else:   # the wgrad's stage-1 row rides on its stage-0 row
                rows["dw_star_wgrad"]["stage_1"] = got["dw_star_wgrad"]
        del x, up, y, y_p, dx, dx_p, dact, r2, rerun, outs

    q = torch.randn(2, 3600, 8, 32, device=dev, generator=g) / np.sqrt(32)
    k = torch.randn(2, 3600, 8, 32, device=dev, generator=g)
    v = torch.randn(2, 3600, 8, 32, device=dev, generator=g)
    up = torch.randn(2, 3600, 8, 32, device=dev, generator=g)
    # bf16 mode: both sides round q, k, v, g, z and dl to bf16; other
    # summation orders break a few of those rounding ties apart.
    # (the forward's bf16 rounding of e also reaches delta = rowsum(g out)).
    tols = {False: (1e-4, 0.99999), True: (1e-2, 0.999)}  # (scaled, cosine)
    for bf16 in (False, True):
        # As the training path calls it: operand-typed q, k, v, the
        # forward's output and lse handed over (ms); and on its own, where
        # it casts and runs the forward kernel first (alone_ms).
        qo, ko, vo = ak._operands((q, k, v), bf16)
        out, lse, _ = ak._forward_kernel(qo, ko, vo, bf16, True)
        run = lambda: attention_bwd(qo, ko, vo, up, bf16, out=out, lse=lse)
        got, again = run(), run()
        alone = attention_bwd(q, k, v, up, bf16)
        ref = attention_bwd_plain(q, k, v, up, bf16)
        torch.cuda.synchronize()
        same = all(torch.equal(a, a2) and torch.equal(a, a3)
                   for a, a2, a3 in zip(got, again, alone))
        err = max(scaled_err(a, r) for a, r in zip(got, ref))
        cos = min(float((a * r).sum()) / float(a.norm() * r.norm())
                  for a, r in zip(got, ref))
        abs_err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        ms = cuda_ms(run)
        alone_ms = cuda_ms(lambda: attention_bwd(q, k, v, up, bf16))
        plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, up, bf16), 3)
        log(f"kernel attention_bwd bf16={bf16}: dq/dk/dv scaled err "
            f"{err:.3e} (tol {tols[bf16][0]:g}), min cosine {cos:.6f} (tol "
            f"{tols[bf16][1]}), max_abs_err {abs_err:.3e}, reruns and the "
            f"call on its own bit-identical {same} ms={ms:.3f} (out and lse "
            f"handed in; on its own, with the cast and the forward kernel: "
            f"{alone_ms:.3f}) plain_ms={plain_ms:.3f}")
        assert err < tols[bf16][0] and cos > tols[bf16][1] and same
        assert all(torch.isfinite(a).all() for a in got)
        if bf16:   # the training default (attn_bf16=True)
            B, L, H, D = q.shape
            S = k.shape[1]
            lib_ms = sdpa_backward(q, k, v, up)
            eb, sms, mhz = exp_bound_ms(2 * B * H * L * S)
            # Five products of L x S x D per head: the logits again (the
            # softmax is not an input), dV, dP, dQ and dK.
            rows["attention_bwd"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                **bound({"bf16": 10 * B * H * L * S * D},
                        nbytes(q, k, v, up, *got)))
            log(f"  bound {rows['attention_bwd']['bound_ms']:.4f} ms; "
                f"exp_bound_ms {eb:.4f} (dK/dV and dQ each take one ex2 per "
                f"logit: 2 x {B * H * L * S} / (16 per clock x {sms} SMs x "
                f"{mhz:.0f} MHz)); the "
                f"autograd backward of scaled_dot_product_attention (bf16 "
                f"operands) {lib_ms:.3f} ms")
    rows["attention_bwd"]["merged"] = [attention_bwd_merged_row(dev, L, S)
                                       for L, S in MERGED_TRAIN_SHAPES]
    rows["attention_bwd"]["head_dims"] = {
        str(d): attention_bwd_width_row(dev, d) for d in ATTN_WIDTH_ROWS}
    return rows


def attention_bwd_width_row(dev, D, B=2, L=3600, S=3600, H=8):
    """The attention backward at head_dim ``D`` and phase 3c's shapes (B =
    2, H = 8, L = S = 3600; ``out`` and ``lse`` handed in, as the training
    path calls it) on the ``kernel_head_dim(D)`` instantiation: bf16 mode
    against ``attention_bwd_plain`` (1e-2 of each gradient's largest value,
    cosine > 0.999, the D = 32 tolerances), f32 mode (1e-4, cosine >
    0.99999), each rerun bit-identical; timed beside the plain version,
    SDPA's backward, the bound and ``exp_bound_ms`` -> a row of the
    ``attention_bwd`` summary's ``head_dims``."""
    from nerfmatch_tpu_torch.ops.kernels import attention_kernel as ak
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_bwd, attention_bwd_plain, kernel_head_dim)

    g = torch.Generator(dev).manual_seed(5)
    q = torch.randn(B, L, H, D, device=dev, generator=g) / np.sqrt(D)
    k = torch.randn(B, S, H, D, device=dev, generator=g)
    v = torch.randn(B, S, H, D, device=dev, generator=g)
    up = torch.randn(B, L, H, D, device=dev, generator=g)
    res = {}
    for bf16, (tol, min_cos) in ((False, (1e-4, 0.99999)), (True, (1e-2, 0.999))):
        out, lse, ops = ak._forward_kernel(q, k, v, bf16, True)
        run = lambda: attention_bwd(*ops, up, bf16, out=out, lse=lse)
        got, again = run(), run()
        ref = attention_bwd_plain(q, k, v, up, bf16)
        torch.cuda.synchronize()
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        err = max(scaled_err(a, r) for a, r in zip(got, ref))
        cos = min(float((a * r).sum()) / float(a.norm() * r.norm())
                  for a, r in zip(got, ref))
        abs_err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        del ref
        res[bf16] = dict(scaled_err=err, cosine=cos, max_abs_err=abs_err,
                         same=same, ms=cuda_ms(run, 3 if not bf16 else 10),
                         plain_ms=cuda_ms(lambda: attention_bwd_plain(
                             q, k, v, up, bf16), 3))
        log(f"kernel attention_bwd at head_dim {D} (kD {kernel_head_dim(D)}) "
            f"bf16={bf16}, B={B}, H={H}, L=S={L}: dq/dk/dv scaled err "
            f"{err:.3e} (tol {tol:g}), min cosine {cos:.6f} (tol {min_cos}), "
            f"max_abs_err {abs_err:.3e}, rerun bit-identical {same}; "
            f"ms={res[bf16]['ms']:.3f} (out and lse handed in) plain_ms="
            f"{res[bf16]['plain_ms']:.3f}")
        assert err < tol and cos > min_cos and same
        assert all(torch.isfinite(a).all() for a in got)
        if bf16:
            grads = got
    lib_ms = sdpa_backward(q, k, v, up)
    eb, _, _ = exp_bound_ms(2 * B * H * L * S)
    b16 = res[True]
    row = dict(D=D, kernel_head_dim=kernel_head_dim(D), B=B, L=L, S=S,
               max_abs_err=b16["max_abs_err"], scaled_err=b16["scaled_err"],
               cosine=b16["cosine"], ms=b16["ms"], plain_ms=b16["plain_ms"],
               library_ms=lib_ms, exp_bound_ms=eb, f32_ms=res[False]["ms"],
               f32_scaled_err=res[False]["scaled_err"],
               **bound({"bf16": 10 * B * H * L * S * D},
                       nbytes(q, k, v, up, *grads)))
    log(f"  head_dim {D}: bound_ms {row['bound_ms']:.4f} exp_bound_ms "
        f"{eb:.4f} SDPA backward {lib_ms:.3f}")
    return row


def attention_bwd_merged_row(dev, L, S, B=2, H=8):
    """The bf16 attention backward at a merged multi-pair training shape
    (B = 2, H = 8; ``out`` and ``lse`` handed in, as the training path
    calls it) against the plain backward taken a head at a time (the plain
    version's logits of all heads would not fit at L = S = 14,400): 1e-2 of
    each output's largest value, cosine > 0.999, a rerun bit-identical;
    with its bound, ``exp_bound_ms`` and SDPA's autograd backward -> a row
    for the ``attention_bwd`` summary's ``merged`` list."""
    from nerfmatch_tpu_torch.ops.kernels import attention_kernel as ak
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_bwd, attention_bwd_plain)

    g = torch.Generator(dev).manual_seed(3)
    q = torch.randn(B, L, H, 32, device=dev, generator=g) / np.sqrt(32)
    k = torch.randn(B, S, H, 32, device=dev, generator=g)
    v = torch.randn(B, S, H, 32, device=dev, generator=g)
    up = torch.randn(B, L, H, 32, device=dev, generator=g)
    qo, ko, vo = ak._operands((q, k, v), True)
    out, lse, _ = ak._forward_kernel(qo, ko, vo, True, True)
    run = lambda: attention_bwd(qo, ko, vo, up, True, out=out, lse=lse)
    got, again = run(), run()

    def plain():
        ref = [torch.empty_like(a) for a in got]
        for h in range(H):
            one = attention_bwd_plain(*(x[:, :, h:h + 1] for x in (q, k, v, up)),
                                      True)
            for r, o in zip(ref, one):
                r[:, :, h:h + 1] = o
            del one
        return ref

    ref = plain()
    torch.cuda.synchronize()
    same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
    err = max(scaled_err(a, r) for a, r in zip(got, ref))
    cos = min(float((a * r).sum()) / float(a.norm() * r.norm())
              for a, r in zip(got, ref))
    abs_err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
    del ref
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain, 1)
    lib_ms = sdpa_backward(q, k, v, up)
    eb, _, _ = exp_bound_ms(2 * B * H * L * S)
    row = dict(L=L, S=S, max_abs_err=abs_err, scaled_err=err, cosine=cos,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, exp_bound_ms=eb,
               **bound({"bf16": 10 * B * H * L * S * 32},
                       nbytes(q, k, v, up, *got)))
    log(f"kernel attention_bwd bf16 at B={B}, H={H}, L={L}, S={S} (merged "
        f"multi-pair training): dq/dk/dv scaled err {err:.3e} (tol 1e-2), "
        f"min cosine {cos:.6f} (tol 0.999), max_abs_err {abs_err:.3e}, rerun "
        f"bit-identical {same}; ms={ms:.3f} (out and lse handed in) "
        f"plain_ms={plain_ms:.2f} (a head at a time) bound_ms="
        f"{row['bound_ms']:.4f} exp_bound_ms={eb:.4f} SDPA backward "
        f"{lib_ms:.3f}")
    assert err < 1e-2 and cos > 0.999 and same
    assert all(torch.isfinite(a).all() for a in got)
    return row


def conv_alone_ms(x, w):
    """Time of cuDNN's depthwise 7x7 convolution alone (``F.conv2d``,
    groups=C, TF32 off) on the channels-last view of x: a yardstick beside
    kernels 7 and 8, not the same function (no StarReLU)."""
    from torch.nn import functional as F

    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
    return cuda_ms(lambda: F.conv2d(xc, wc, padding=3, groups=x.shape[-1]))


def wgrad_alone_ms(x, s, b, up):
    """Time of kernel 9's C entry alone (its two launches, no wrapper): the
    device time of what ``dw_star_wgrad`` launches."""
    from nerfmatch_tpu_torch.ops import kernels
    from nerfmatch_tpu_torch.ops.kernels.sepconv_kernel import (
        dw_star_wgrad_parts)

    B, H, W, C = x.shape
    rows = dw_star_wgrad_parts(x.device.index, B, H, W, C)
    part = torch.empty(rows, 49, 32, device=x.device)
    dw = torch.empty(7, 7, C, device=x.device)
    lib, stream = kernels.library(), kernels.stream_ptr(x.device)
    return cuda_ms(lambda: kernels.check(lib.nm_dw_star_wgrad(
        x.data_ptr(), up.data_ptr(), s.data_ptr(), b.data_ptr(), dw.data_ptr(),
        part.data_ptr(), rows, B, H, W, C, 7, stream), "dw_star_wgrad"), 20)


def conv_wgrad_alone_ms(x, up):
    """Time of cuDNN's depthwise 7x7 weight gradient alone
    (``torch.nn.grad.conv2d_weight``, TF32 off) on the channels-last views
    of the pre-activated x and of g: a yardstick beside kernel 9, not the
    same function (no StarReLU)."""
    C = x.shape[-1]
    xc, gc = x.permute(0, 3, 1, 2), up.permute(0, 3, 1, 2)
    return cuda_ms(lambda: torch.nn.grad.conv2d_weight(
        xc, (C, 1, 7, 7), gc, padding=3, groups=C))


def sdpa_backward(q, k, v, up):
    """Time of the autograd backward of ``scaled_dot_product_attention`` on
    the bf16-rounded (B, H, L, D) operands."""
    from torch.nn import functional as F

    with torch.enable_grad():
        qb, kb, vb = (x.transpose(1, 2).to(torch.bfloat16).contiguous()
                      .requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qb, kb, vb, scale=1.0)
        g = up.transpose(1, 2).to(torch.bfloat16).contiguous()
        return cuda_ms(lambda: torch.autograd.grad(out, (qb, kb, vb), g,
                                                   retain_graph=True))


def write_room_scene(renderer, dev, root, n_frames=24, size=480,
                     name="room", offset=0.0):
    """The room NeRF's renders on its camera circle (frame i at angle
    2 pi (i + offset) / n_frames), in the dataset's layout:
    <root>/<name>/seq-01/frame-XXX.color.png + transforms_{train,test}.json."""
    from PIL import Image

    scene = root / name
    (scene / "seq-01").mkdir(parents=True)
    frames = []
    with torch.no_grad():
        for i in range(n_frames):
            c2w = room_c2w(2 * np.pi * (i + offset) / n_frames)
            rgb = renderer.fused_predict(camera_rays(c2w, size, dev))["rgb_fine"]
            img = rgb.reshape(size, size, 3).clamp(0, 1).cpu().numpy()
            name = f"seq-01/frame-{i:03d}.color.png"
            Image.fromarray((img * 255).round().astype(np.uint8)).save(
                scene / name)
            frames.append(dict(file_path=name, intrinsics=camera_K(size).tolist(),
                               height=size, width=size,
                               transform_matrix=c2w.tolist()))
    for split in ("train", "test"):
        (scene / f"transforms_{split}.json").write_text(
            json.dumps({"frames": frames}))


def phase_training(renderer, dev, seed, root):
    """Train on the room scene (written under ``root``) through the CLI
    (debug, resume) and 50 NerfTrainer steps; serve the checkpoint ->
    (launch counts, the CLI's last checkpoint, its config)."""
    from nerfmatch_tpu_torch.config import load_yaml_config, save_config
    from nerfmatch_tpu_torch.cli.train_nerf import main as train_cli
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.nerf_trainer import (NerfTrainer,
                                                        init_config_odir)

    t0 = time.perf_counter()
    write_room_scene(renderer, dev, root)
    log(f"training scene: 24 frames 480x480 written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg_path = ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml"
    cfg, _ = load_yaml_config(cfg_path)
    cfg.data.data_dir = str(root)
    cfg.data.scene = "room"
    cfg.data.scene_anno_path = str(root / "#scene" / "transforms_#split.json")
    cfg.exp.odir = str(root / "out")
    save_config(root / "cfg.yaml", cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out_cfg, r1 = train_cli(["--config", str(root / "cfg.yaml"), "--debug"])
    t1 = time.perf_counter()
    w1 = r1.nerf_fine.pts_linears[0].weight.detach().clone()
    _, r2 = train_cli(["--config", str(root / "cfg.yaml"), "--debug"])
    t2 = time.perf_counter()
    assert torch.equal(r2.nerf_fine.pts_linears[0].weight, w1), "resume"
    ckpt = latest_checkpoint(init_config_odir(out_cfg) / "checkpoints",
                             name="last")
    assert ckpt is not None and ckpt.name == f"last_{cfg.exp.max_epochs}"
    log(f"cli --debug: {cfg.exp.max_epochs} epochs x 10 steps of "
        f"{cfg.exp.batch_size} rays + validation in {t1 - t0:.1f} s; "
        f"resumed at epoch {cfg.exp.max_epochs} in {t2 - t1:.1f} s "
        f"({ckpt.name})")

    trainer = NerfTrainer(cfg, device=dev, seed=seed)
    ds = init_data_loader(cfg.data, split="train").dataset
    batches = ds.ray_batches(cfg.exp.batch_size,
                             np.random.default_rng(seed))
    gen = torch.Generator(dev).manual_seed(seed)
    dev_batch = lambda b: (torch.as_tensor(b["rays"], device=dev),
                           torch.as_tensor(b["rgbs"], device=dev))
    steps = [dev_batch(next(batches)) for _ in range(56)]
    hist = [trainer.train_step(*steps[i], gen) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist += [trainer.train_step(*steps[i], gen) for i in range(2, 52)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 50 * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = dict(LAUNCHES)
    log(f"launches during training: {json.dumps(launches)}")
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    assert not missing, f"kernels never launched in training: {missing}"
    loss = [float(m["loss"]) for m in hist]
    psnr = [float(m["rgb_fine_psnr"]) for m in hist]
    assert all(np.isfinite(loss)), "non-finite loss"
    assert np.mean(loss[-5:]) < np.mean(loss[:5]), loss
    assert np.mean(psnr[-5:]) > np.mean(psnr[:5]), psnr

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(52, 56):
            trainer.train_step(*steps[i], gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an op's device time already holds its kernels,
    # and a user annotation's range (the optimizer step) spans kernels.
    ka = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in ka) / 1e3
    # The forward kernel runs once a stage a step (coarse, fine): the
    # backward reads its stash and recomputes nothing.
    fwd_runs = sum(e.count for e in ka if "train_fwd_kernel" in e.key)
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:8]
    log(f"training: {step_ms:.1f} ms/step, "
        f"{cfg.exp.batch_size / step_ms * 1e3:.0f} rays/s over 50 steps "
        f"of {cfg.exp.batch_size} rays; loss {loss[0]:.4f} -> "
        f"{np.mean(loss[-5:]):.4f}, train psnr {psnr[0]:.2f} -> "
        f"{np.mean(psnr[-5:]):.2f} dB; profiled 4 steps: wall "
        f"{wall:.1f} ms, device {dev_ms:.1f} ms, idle share "
        f"{max(0.0, 1 - dev_ms / wall):.2f}")
    log("  device time by kernel (ms, 4 steps): " + json.dumps(
        {e.key[:60]: round(e.self_device_time_total / 1e3, 2)
         for e in top}))
    log(f"  train_fwd_kernel launches in the 4 profiled steps: {fwd_runs} "
        f"(2 a step); peak memory over the 50 timed steps "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    assert fwd_runs == 8, f"train_fwd_kernel ran {fwd_runs} times in 4 steps"

    serving = NerfRenderer(cfg, stop_layer=3)
    serving.load_state_dict(torch.load(ckpt / "model.pt"), strict=True)
    serving = serving.to(dev).eval()
    with torch.no_grad():
        out = serving.render_novel_view((480, 480), camera_K(480),
                                        room_c2w(0.5), ds.unnorm_scene)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    log(f"served {ckpt.name}: ds-8 grid pt3d {out['pt3d'].shape} "
        f"pt_feat {out['pt_feat'].shape}")
    return launches, ckpt, cfg


def phase_hid128(dev, seed, root, hid=128, size=480):
    """Phase 11: a NeRF at MLP width ``hid`` end to end.  The 7-Scenes
    config with ``hid_dim`` 128 in both stages, trained by the
    ``train_nerf`` CLI (--debug, 5 epochs of 10 steps) on phase 5's room
    scene under ``root``, then 50 timed ``NerfTrainer`` steps (kernels 5,
    6); its checkpoint served at the serving int8 default: the scene points
    of the scene's 24 frames (kernels 1b, 2, 1) and one 480x480 request
    localized by ``eval_batch(iters=2)`` with a c2f matcher at random
    weights (seed 0) whose ``pt_dim`` follows the NeRF width -> summary."""
    import dataclasses

    from nerfmatch_tpu_torch.cli.train_nerf import main as train_cli
    from nerfmatch_tpu_torch.config import load_yaml_config, save_config
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
    from nerfmatch_tpu_torch.nerf.renderer import (NerfRenderer,
                                                   serving_int8_mode)
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.nerf_trainer import (NerfTrainer,
                                                        init_config_odir)

    cfg, _ = load_yaml_config(ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    cfg.coarse_nerf.hid_dim = cfg.fine_nerf.hid_dim = hid
    cfg.data.data_dir = str(root)
    cfg.data.scene = "room"
    cfg.data.scene_anno_path = str(root / "#scene" / "transforms_#split.json")
    cfg.exp.odir = str(root / f"out{hid}")
    cfg.exp.max_epochs = 5
    save_config(root / f"cfg{hid}.yaml", cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out_cfg, _ = train_cli(["--config", str(root / f"cfg{hid}.yaml"), "--debug"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    ckpt = latest_checkpoint(init_config_odir(out_cfg) / "checkpoints",
                             name="last")
    assert ckpt is not None and ckpt.name == "last_5", ckpt

    trainer = NerfTrainer(cfg, device=dev, seed=seed)
    ds = init_data_loader(cfg.data, split="train").dataset
    batches = ds.ray_batches(cfg.exp.batch_size, np.random.default_rng(seed))
    gen = torch.Generator(dev).manual_seed(seed)
    steps = [(torch.as_tensor(b["rays"], device=dev),
              torch.as_tensor(b["rgbs"], device=dev))
             for b in (next(batches) for _ in range(52))]
    hist = [trainer.train_step(*steps[i], gen) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist += [trainer.train_step(*steps[i], gen) for i in range(2, 52)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 50 * 1e3
    peak = torch.cuda.max_memory_allocated()
    loss = [float(m["loss"]) for m in hist]
    assert trainer.route == "kernels" and all(np.isfinite(loss)), loss
    assert np.mean(loss[-5:]) < np.mean(loss[:5]), loss
    train_launches = {k: LAUNCHES[k] for k in TRAIN_KERNELS}
    del trainer, steps

    serving = NerfRenderer(cfg, stop_layer=3)
    serving.load_state_dict(torch.load(ckpt / "model.pt"), strict=True)
    serving = serving.to(dev).eval()
    serving.cfg = dataclasses.replace(serving.cfg,
                                      trunk_int8=serving_int8_mode(cfg))
    match_cfg, _ = load_yaml_config(
        ROOT / "configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml")
    match_cfg.model.pt_dim = hid
    evaluator = NeRFMatchEvaluator(
        match_cfg, device=dev, generator=torch.Generator().manual_seed(0))
    kw = dict(iters=2, mutual=True, solver="colmap", rthres=10.0)
    with torch.no_grad():
        req = make_request(serving, 0.3, dev, size)
        # Warm-up request (calibration, cuDNN autotuning, the allocator).
        evaluator.eval_batch(scene_points(serving, [req], size),
                             renderer=serving, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        frames = [room_c2w(2 * np.pi * i / 24) for i in range(24)]
        cache = serving.render_novel_views(
            (size, size), [camera_K(size)] * 24, frames,
            [np.eye(4, dtype=np.float32)] * 24, downsample=8)
        torch.cuda.synchronize()
        cache_ms = (time.perf_counter() - t0) * 1e3 / 24
        for k in ("pt3d", "pt_feat"):
            assert np.isfinite(cache[k]).all(), k
        assert cache["pt_feat"].shape[-1] == hid, cache["pt_feat"].shape
        t0 = time.perf_counter()
        batch = scene_points(serving, [req], size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = evaluator.eval_batch(batch, renderer=serving, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = {**train_launches,
                **{k: LAUNCHES[k] for k in ("render_coarse_int8", "render_fine",
                                            "resample")}}
    c2w, r_err, t_err = res["c2w_est"][0], res["R_err"][0], res["t_err"][0]
    assert (c2w is None and r_err == t_err == float("inf")) or (
        np.isfinite(c2w).all() and np.isfinite([r_err, t_err]).all())
    out = dict(hid=hid, cli_s=cli_s, cli_steps=50, step_ms=step_ms,
               peak_gib=peak / 2**30, loss_first=loss[0],
               loss_last5=float(np.mean(loss[-5:])),
               cache_ms_per_frame=cache_ms, scene_points_ms=(t1 - t0) * 1e3,
               request_ms=(t2 - t0) * 1e3, localize_ms=(t2 - t1) * 1e3,
               num_matches=res["num_matches"], R_err_deg=r_err, t_err=t_err,
               trunk_int8=serving.cfg.trunk_int8, matcher_pt_dim=hid,
               launches=launches)
    log("phase 11 (hid 128 end to end): " + json.dumps(out))
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"phase 11 never launched: {missing}"
    return out


def plain_fused_rgb(renderer, rays, chunk=9216):
    """The port's plain render of (N, 12) rays on the card: what
    :meth:`NerfRenderer.fused_render` computes, with each stage's plain
    version (the same bf16 operands and early termination) and the
    resample's plain twin that sums in the kernel's order, ``chunk`` rays
    at a time (the kernel path's chunks) -> rgb_fine (N, 3)."""
    from nerfmatch_tpu_torch.nerf.renderer import reparam_unit_dir
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        render_stage_plain)
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z_scan_plain)

    (_, cmlp), (_, fmlp) = renderer._stages()
    kw = renderer._stage_kwargs()
    S = renderer.fine_cfg.num_pts
    t = torch.linspace(0.0, 1.0, S + 1, device=rays.device)
    out = []
    for i in range(0, rays.shape[0], chunk):
        r, _ = reparam_unit_dir(rays[i:i + chunk])
        z = (r[:, 6:7] * (1.0 - t) + r[:, 7:8] * t).contiguous()
        w = render_stage_plain(cmlp, r, z, fine=False, **kw)["weights"]
        zf = resample_z_scan_plain(z, w)
        out.append(render_stage_plain(fmlp, r, zf, fine=True, **kw)["rgb"])
    return torch.cat(out)


def phase_psnr(ckpt, root, dev, n_images=4, size=480):
    """Phase 5b: ``cli.eval_nerf`` in its PSNR mode (``--split test
    --img_wh 480 480 --downsample 1 --save_depth``) on phase 5's checkpoint,
    over the first ``n_images`` test frames of the room scene: the mean
    PSNR, seconds an image (loading, rendering, PNGs) and the launches (per
    image 25 bf16 coarse stages, 25 resamples, 25 bf16 fine stages: the
    config sets no ``trunk_int8``); then one image's kernel render against
    the port's plain render of the same rays on the card (rgb within 5e-3)
    with both PSNRs, and the render's own ms an image -> launches."""
    from nerfmatch_tpu_torch.cli import eval_nerf
    from nerfmatch_tpu_torch.eval.nerf_evaluator import load_nerf_from_ckpt
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.utils.metrics import compute_nerf_metrics

    out_dir = root / "psnr"
    argv = ["--ckpt", str(ckpt), "--split", "test", "--img_wh", str(size),
            str(size), "--downsample", "1", "--save_depth", "--nums",
            str(n_images), "--cache_dir", str(out_dir)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = eval_nerf.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    chunks = -(-size * size // 9216)
    log(f"eval_nerf (PSNR) {' '.join(argv[2:-2])}: {n_images} images in "
        f"{wall:.2f} s, {wall / n_images:.3f} s an image; PSNR per image "
        f"{[round(v, 4) for v in res['psnr']]}, mean "
        f"{np.mean(res['psnr']):.4f} dB; launches "
        + json.dumps({k: v for k, v in launches.items() if v}))
    assert len(res["psnr"]) == n_images and np.isfinite(res["psnr"]).all()
    for k in ("render_coarse", "resample", "render_fine"):
        assert launches[k] == chunks * n_images, (k, launches[k])
    assert launches["render_coarse_int8"] == launches["render_fine_int8"] == 0
    for sub in ("rgb", "depth"):
        assert len(list((out_dir / sub).glob("*.png"))) == n_images, sub

    args = eval_nerf.build_parser().parse_args(argv)
    ev = load_nerf_from_ckpt(ckpt, args, frame_num=1, device=dev)
    batch = next(iter(ev.data_loader))
    rays = torch.as_tensor(np.asarray(batch["rays"][0]).reshape(-1, 12),
                           dtype=torch.float32, device=dev)
    gt = torch.as_tensor(np.asarray(batch["rgbs"][0]).reshape(-1, 3),
                         device=dev)
    with torch.no_grad():
        k_rgb = ev.renderer.fused_predict(rays)["rgb_fine"]
        p_rgb = plain_fused_rgb(ev.renderer, rays)
        render_ms = cuda_ms(lambda: ev.renderer.fused_predict(rays), 3)
    d = (k_rgb - p_rgb).abs()
    psnr = {n: float(compute_nerf_metrics({"rgb_fine": x}, gt, True)[
        "rgb_fine_psnr"]) for n, x in (("kernel", k_rgb), ("plain", p_rgb))}
    log(f"  image 0 ({batch['img_idx'][0]}): kernel vs plain render on the "
        f"card, rgb max {float(d.max()):.3e} (tol 5e-3) mean "
        f"{float(d.mean()):.3e}; PSNR kernel {psnr['kernel']:.4f} plain "
        f"{psnr['plain']:.4f} (difference "
        f"{psnr['kernel'] - psnr['plain']:.2e} dB); the render alone "
        f"{render_ms:.1f} ms an image ({chunks} chunks of 9216 rays)")
    assert float(d.max()) < 5e-3
    return launches, wall / n_images, render_ms


def phase_psnr_app(ckpt, cfg, root, dev, n_poses=3, size=480):
    """Phase 5c: an appearance checkpoint (phase 5's weights, the seeded
    appearance block and (2, 16) table of :func:`with_appearance`, in the
    port's checkpoint layout) on a copy of the room scene whose first
    ``n_poses`` test frames sit under two sequence folders (``ts`` 0 and
    1, the same poses and images, the room's scene normalization):
    ``cli.eval_nerf``'s PSNR mode, the PSNR per sequence and the launches
    (the fine stages with ``app``); the same pose's rgb differs between the
    two ids; a ``--cache_scene_pts`` run (serving int8 default) gives the
    same pose bit-identical ``pt_feat`` and ``pt3d`` under both ids and
    another ``pt_color``; a cache run at ``trunk_int8='posttap'`` launches
    the int8 fine stage with ``app`` -> launches of both fine stages."""
    import shutil

    from PIL import Image

    from nerfmatch_tpu_torch.cli import eval_nerf
    from nerfmatch_tpu_torch.eval.nerf_evaluator import load_nerf_from_ckpt
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.checkpoint import save_checkpoint

    base = NerfRenderer(cfg, stop_layer=3)
    base.load_state_dict(torch.load(ckpt / "model.pt"), strict=True)
    app_r, app_cfg = with_appearance(base, cfg)
    src, scene = root / "room", root / "room2"
    frames = json.loads((src / "transforms_test.json").read_text())["frames"]
    two = []
    for seq in ("seq-01", "seq-02"):
        (scene / seq).mkdir(parents=True)
        for f in frames[:n_poses]:
            name = f["file_path"].replace("seq-01", seq)
            shutil.copy(src / f["file_path"], scene / name)
            two.append(dict(f, file_path=name))
    for split in ("train", "test"):
        (scene / f"transforms_{split}.json").write_text(
            json.dumps({"frames": two}))
    app_cfg.data.scene = "room2"
    app_cfg.data.snorm_json = str(src / "transforms_train.json")
    app_ckpt = save_checkpoint(root / "app", 0, app_r, config=app_cfg,
                               name="last")
    out_dir = root / "psnr_app"
    argv = ["--ckpt", str(app_ckpt), "--split", "test", "--img_wh", str(size),
            str(size), "--downsample", "1", "--save_depth", "--cache_dir",
            str(out_dir)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = eval_nerf.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    n, chunks = 2 * n_poses, -(-size * size // 9216)
    psnr = res["psnr"]
    log(f"eval_nerf (PSNR), appearance checkpoint: {n} images in {wall:.2f} "
        f"s, {wall / n:.3f} s an image; PSNR seq-01 (ts 0) "
        f"{[round(v, 4) for v in psnr[:n_poses]]} mean "
        f"{np.mean(psnr[:n_poses]):.4f}, seq-02 (ts 1) "
        f"{[round(v, 4) for v in psnr[n_poses:]]} mean "
        f"{np.mean(psnr[n_poses:]):.4f} dB; launches "
        + json.dumps({k: v for k, v in launches.items() if v}))
    for k in ("render_coarse", "resample", "render_fine_app"):
        assert launches[k] == chunks * n, (k, launches[k])
    assert launches["render_fine"] == 0 and np.isfinite(psnr).all()
    png = lambda seq, f: np.asarray(Image.open(
        out_dir / "rgb" / f"{seq}_{Path(f['file_path']).name[:-10]}.png"),
        np.int32)
    moved = [int(np.abs(png("seq-01", f) - png("seq-02", f)).max())
             for f in frames[:n_poses]]
    log(f"  rgb of the same pose under ts 0 and 1: largest PNG difference "
        f"{moved}")
    assert min(moved) > 0

    cache = root / "cache_app"
    reset_launch_counts()
    eval_nerf.main(["--ckpt", str(app_ckpt), "--cache_scene_pts",
                    "--downsample", "8", "--split", "test", "--cache_dir",
                    str(cache)])
    cache_launches = {k: v for k, v in LAUNCHES.items() if v}
    same, color = [], []
    for f in frames[:n_poses]:
        stem = Path(f["file_path"]).name[:-10]
        a, b = (np.load(cache / "ds8lin" / f"{seq}_{stem}.npy",
                        allow_pickle=True).item() for seq in ("seq-01", "seq-02"))
        same.append(all(np.array_equal(a[k], b[k]) for k in ("pt_feat", "pt3d")))
        color.append(float(np.abs(a["pt_color"] - b["pt_color"]).max()))
    log(f"  --cache_scene_pts (serving int8 default): pt_feat and pt3d of "
        f"the same pose bit-identical under ts 0 and 1: {same}; pt_color "
        f"differs by up to {[round(c, 4) for c in color]}; launches "
        + json.dumps(cache_launches))
    assert all(same) and min(color) > 0
    assert cache_launches.get("render_coarse_int8", 0) > 0
    assert cache_launches.get("render_fine_app", 0) > 0

    args = eval_nerf.build_parser().parse_args(
        ["--ckpt", str(app_ckpt), "--downsample", "8", "--split", "test"])
    reset_launch_counts()
    load_nerf_from_ckpt(app_ckpt, args, device=dev).cache_scene_pts(
        cache_dir=root / "cache_posttap", trunk_int8="posttap")
    posttap = LAUNCHES["render_fine_int8_app"]
    log(f"  cache at trunk_int8='posttap': {posttap} int8 fine stages with app")
    assert posttap > 0 and LAUNCHES["render_fine_app"] == 0
    return {"render_fine_app": launches["render_fine_app"],
            "render_fine_int8_app": posttap}, wall / n


def write_app_scene(renderer, dev, root, n_frames=24, wh=(480, 270)):
    """A two-sequence scene for the Cambridge config, in its layout: the
    room NeRF's ``wh`` renders on its camera circle, even frames under
    ``GreatCourt/seq1``, odd ones under ``seq2`` with their exposure at 0.8
    (what an appearance row absorbs); per frame a background ("sky") mask
    of the top 12% of rows and a transient ("car") mask of a box a tenth of
    the width and an eighth of the height, at a frame-dependent place in
    the lower half, under ``masks/masks_bg`` and
    ``masks/masks_trnz_cars``; ``annotations/transforms_GreatCourt_
    {train,test}.json`` (test: two frames of each sequence) and a pairs
    file (each frame with the next two) -> the pairs file's path."""
    from PIL import Image

    w, h = wh
    scene = root / "GreatCourt"
    frames = []
    with torch.no_grad():
        for i in range(n_frames):
            seq = "seq1" if i % 2 == 0 else "seq2"
            c2w = room_c2w(2 * np.pi * i / n_frames)
            rgb = renderer.fused_predict(camera_rays(c2w, w, dev, h))["rgb_fine"]
            img = rgb.reshape(h, w, 3).clamp(0, 1).cpu().numpy()
            img = img * (0.8 if seq == "seq2" else 1.0)
            name = f"{seq}/frame{i:05d}.png"
            sky = np.zeros((h, w), np.uint8)
            sky[:int(0.12 * h)] = 255
            car = np.zeros((h, w), np.uint8)
            bw, bh = w // 10, h // 8
            x0, y0 = i * w // 24 % (w - bw), h // 2 + 3 * i % (h // 2 - bh)
            car[y0:y0 + bh, x0:x0 + bw] = 255
            for path, arr in (
                    (scene / name, (img * 255).round().astype(np.uint8)),
                    (root / "masks/masks_bg/GreatCourt" / name, sky),
                    (root / "masks/masks_trnz_cars/GreatCourt" / name, car)):
                path.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(arr).save(path)
            frames.append(dict(file_path=name,
                               intrinsics=camera_K(w, h).tolist(), height=h,
                               width=w, transform_matrix=c2w.tolist()))
    anno = root / "annotations"
    anno.mkdir()
    test = frames[:4]
    for split, fr in (("train", frames), ("test", test)):
        (anno / f"transforms_GreatCourt_{split}.json").write_text(
            json.dumps({"frames": fr}))
    pairs = root / "pairs_GreatCourt.txt"
    pairs.write_text("\n".join(
        f"{frames[i]['file_path']} {frames[(i + d) % n_frames]['file_path']}"
        for i in range(n_frames) for d in (1, 2)))
    return pairs


def phase_training_app(renderer, dev, seed, root):
    """Phase 5d: appearance training on a two-sequence scene
    (:func:`write_app_scene`): ``cli.train_nerf --debug`` trains
    ``configs/nerf/nerf_cambridge_mip_app.yaml`` (only the data paths and
    the output dir changed) and resumes with the table's shape;
    ``NerfTrainer`` takes 32 steps of 9216 rays from a fresh initialization
    (30 timed; the loss must fall, both table rows move, the counters show
    the ``_app`` train kernels and the resample and not the kernels without
    rows); a retrieval-pair val sample runs ``validate_pair``;
    ``cli.eval_nerf``'s PSNR mode scores the CLI's last checkpoint per
    sequence -> launch counts of the 32 steps."""
    from nerfmatch_tpu_torch.cli import eval_nerf
    from nerfmatch_tpu_torch.cli.train_nerf import main as train_cli
    from nerfmatch_tpu_torch.config import load_yaml_config, save_config
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.nerf_trainer import (NerfTrainer,
                                                        init_config_odir)

    t0 = time.perf_counter()
    pairs = write_app_scene(renderer, dev, root)
    log(f"appearance scene: 24 frames 480x270 under seq1 / seq2 (seq2 at "
        f"exposure 0.8), sky and transient masks, written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg, _ = load_yaml_config(ROOT / "configs/nerf/nerf_cambridge_mip_app.yaml")
    cfg.data.data_dir = str(root)
    cfg.data.scene_anno_path = str(root / "annotations" /
                                   "transforms_#scene_#split.json")
    cfg.data.mask_dir = str(root / "masks")
    cfg.exp.odir = str(root / "out_app")
    save_config(root / "cfg_app.yaml", cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out_cfg, r1 = train_cli(["--config", str(root / "cfg_app.yaml"),
                             "--debug"])
    t1 = time.perf_counter()
    table = r1.embedding_a.weight.detach().clone()
    cli_launches = {k: v for k, v in LAUNCHES.items() if v}
    _, r2 = train_cli(["--config", str(root / "cfg_app.yaml"), "--debug"])
    t2 = time.perf_counter()
    assert torch.equal(r2.embedding_a.weight, table), "resume"
    ckpt = latest_checkpoint(init_config_odir(out_cfg) / "checkpoints",
                             name="last")
    assert ckpt is not None and ckpt.name == f"last_{cfg.exp.max_epochs}"
    log(f"cli --debug (Cambridge config): {cfg.exp.max_epochs} epochs x 10 "
        f"steps of {cfg.exp.batch_size} rays + validation in {t1 - t0:.1f} "
        f"s; resumed at epoch {cfg.exp.max_epochs} in {t2 - t1:.1f} s "
        f"({ckpt.name}, table {tuple(table.shape)}); launches "
        + json.dumps(cli_launches))
    assert table.shape == (2, 16)
    assert cli_launches.get("render_train_fwd_app", 0) > 0
    assert "render_train_fwd" not in cli_launches

    ds = init_data_loader(cfg.data, split="train").dataset
    trainer = NerfTrainer(cfg, device=dev, seed=seed,
                          num_frames=int(np.max(ds.seq_ind)) + 1)
    batches = ds.ray_batches(cfg.exp.batch_size, np.random.default_rng(seed))
    gen = torch.Generator(dev).manual_seed(seed)
    steps = [(torch.as_tensor(b["rays"], device=dev),
              torch.as_tensor(b["rgbs"], device=dev),
              torch.as_tensor(b["ts"], device=dev))
             for b in (next(batches) for _ in range(32))]
    assert {int(v) for _, _, ts in steps for v in ts.unique()} == {0, 1}
    table0 = trainer.renderer.embedding_a.weight.detach().clone()
    hist = [trainer.train_step(r, c, gen, ts=ts) for r, c, ts in steps[:2]]
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist += [trainer.train_step(r, c, gen, ts=ts) for r, c, ts in steps[2:]]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 30 * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = dict(LAUNCHES)
    loss = [float(m["loss"]) for m in hist]
    moved = (trainer.renderer.embedding_a.weight.detach() - table0).abs()
    log(f"appearance training: {step_ms:.1f} ms/step, "
        f"{cfg.exp.batch_size / step_ms * 1e3:.0f} rays/s over 30 steps of "
        f"{cfg.exp.batch_size} rays; loss {loss[0]:.4f} -> "
        f"{np.mean(loss[-5:]):.4f}; table rows moved by up to "
        f"{[round(float(v), 5) for v in moved.max(1).values]}; peak memory "
        f"{peak / 2**30:.2f} GiB; launches "
        + json.dumps({k: v for k, v in launches.items() if v}))
    assert all(np.isfinite(loss)) and np.mean(loss[-5:]) < np.mean(loss[:5]), loss
    assert bool((moved.max(1).values > 0).all()), "a table row did not train"
    for k in ("render_train_fwd_app", "render_train_bwd_app", "resample"):
        assert launches[k] > 0, k
    assert launches["render_train_fwd_app"] == 2 * 30
    assert launches["render_train_fwd"] == launches["render_train_bwd"] == 0

    pcfg, _ = load_yaml_config(root / "cfg_app.yaml")
    pcfg.data.train_pair_txt = str(pairs)
    sample = next(iter(init_data_loader(pcfg.data, split="val")))
    sample = {k: (v[0] if isinstance(v, (np.ndarray, list)) else v)
              for k, v in sample.items()}
    assert np.asarray(sample["c2w"]).size == 32
    t0 = time.perf_counter()
    pm = trainer.validate_pair(sample)
    log(f"validate_pair ({sample['img_idx']}, ds 8): "
        + json.dumps({k: (v if np.isfinite(v) else str(v))
                      for k, v in pm.items()})
        + f" in {time.perf_counter() - t0:.2f} s")
    kinds = {"R_err_depth": float, "t_err_depth": float, "R_err_match": float,
             "t_err_match": float, "match_score": float, "num_matches": int}
    assert set(pm) == set(kinds)
    assert all(type(pm[k]) is t and not np.isnan(pm[k]) for k, t in kinds.items())

    out_dir = root / "psnr_cambridge"
    reset_launch_counts()
    res = eval_nerf.main(["--ckpt", str(ckpt), "--split", "test", "--img_wh",
                          "480", "270", "--downsample", "1", "--cache_dir",
                          str(out_dir)])
    psnr = res["psnr"]
    log(f"eval_nerf (PSNR) on {ckpt.name}: seq1 (ts 0) "
        f"{[round(v, 4) for v in psnr[:2]]}, seq2 (ts 1) "
        f"{[round(v, 4) for v in psnr[2:]]} dB; launches "
        + json.dumps({k: v for k, v in LAUNCHES.items() if v}))
    assert len(psnr) == 4 and np.isfinite(psnr).all()
    assert LAUNCHES["render_fine_app"] > 0 and LAUNCHES["render_fine"] == 0
    return launches


def write_match_scene(renderer, nerf_cfg, dev, root, n_frames=24, size=480):
    """Matcher training data from the room NeRF: the room scene
    (``write_room_scene``), its scene points cached per frame through
    ``NerfEvaluator.cache_scene_pts`` on the ds-8 grid, and a pairs file
    (each frame with its +-1 and +-2 neighbours), and the NeRF saved as a
    checkpoint with this scene's config -> (cache dir, pairs file, NeRF
    checkpoint).  The cache dir carries the feature layer's tag
    (``inter_layer3``), from which the benchmark's re-render takes its tap.

    The dataset's fst normalization is set to the identity (its
    ``rescale_factor``) so the NeRF renders the scene points in the frame it
    was trained in, the frame of the images and poses."""
    from nerfmatch_tpu_torch.config import namespace2dict
    from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator
    from nerfmatch_tpu_torch.train.checkpoint import save_checkpoint

    write_room_scene(renderer, dev, root, n_frames, size)
    anno = root / "room" / "transforms_train.json"
    cfg = match_scene_config(nerf_cfg, root, "room", size)
    cache = NerfEvaluator(cfg, renderer).cache_scene_pts(
        cache_dir=root / "inter_layer3" / "room")
    log(f"scene-point cache served at trunk_int8="
        f"{renderer.cfg.trunk_int8!r}")
    frames = sorted(json.loads(anno.read_text())["frames"],
                    key=lambda f: f["file_path"])
    n = len(frames)
    pairs = root / "pairs.txt"
    pairs.write_text("".join(
        f"{frames[i]['file_path']} {frames[(i + d) % n]['file_path']}\n"
        for i in range(n) for d in (-2, -1, 1, 2)))
    nerf_ckpt = save_checkpoint(root / "nerf" / "checkpoints", 1, renderer,
                                config=namespace2dict(cfg), name="last")
    return cache, pairs, nerf_ckpt, cache_max(renderer, cfg, root, cache)


def match_scene_config(nerf_cfg, root, scene, size=480):
    """The NeRF config that caches a room scene's points (``<root>/<scene>``)
    on the ds-8 grid of every frame, with the dataset's fst normalization
    at the identity (its ``rescale_factor``)."""
    import copy

    from nerfmatch_tpu_torch.nerf.scene import compute_scene_normalization_fst

    anno = root / scene / "transforms_train.json"
    scale = float(compute_scene_normalization_fst(anno, 1.0, 1.0)[0, 0])
    cfg = copy.deepcopy(nerf_cfg)
    cfg.data.data_dir = str(root)
    cfg.data.scene = scene
    cfg.data.scene_anno_path = str(root / "#scene" / "transforms_#split.json")
    cfg.data.img_wh = [size, size]
    cfg.data.max_frustum_depth = 1.0
    cfg.data.rescale_factor = scale
    cfg.data.downsample = cfg.downsample = 8
    cfg.split = "test"                                    # every frame
    return cfg


def cache_max(renderer, cfg, root, lin_dir):
    """The room scene's points once more with ``feat_comb='max'`` (tag
    ``ds8max``): at the serving int8 mode (``'coarse'``: the bf16 fine stage
    with feat_max) beside ``lin_dir``, and at ``'posttap'`` (the int8 fine
    stage with feat_max), each on a copy of ``renderer``; the share of
    points that moved against ``lin_dir``; the NeRF saved with
    ``render.feat_comb: max`` in its config (phase 7's re-render on the
    ``ds8max`` cache) -> dict(dir, nerf_ckpt, launches by mode)."""
    import copy

    from nerfmatch_tpu_torch.config import namespace2dict
    from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.checkpoint import save_checkpoint

    out, launches = {}, {}
    for mode, where in (("coarse", lin_dir.parent), ("posttap", root / "max8")):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out[mode] = NerfEvaluator(cfg, copy.deepcopy(renderer)).cache_scene_pts(
            feat_comb="max", cache_dir=where, trunk_int8=mode)
        torch.cuda.synchronize()
        launches[mode] = {k: v for k, v in LAUNCHES.items() if v}
        log(f"scene-point cache feat_comb='max' at trunk_int8={mode!r}: "
            f"{out[mode].name} in {time.perf_counter() - t0:.2f} s; launches "
            f"{json.dumps(launches[mode])}")
    n = len(list(lin_dir.glob("*.npy")))
    assert launches["coarse"].get("render_fine_max") == n
    assert launches["posttap"].get("render_fine_int8_max") == n
    assert "render_fine" not in launches["coarse"]
    load = lambda d, f: np.load(d / f.name, allow_pickle=True).item()
    moved, off = [], []
    for f in sorted(lin_dir.glob("*.npy")):
        lin, mx, q8 = (load(d, f) for d in (lin_dir, out["coarse"],
                                            out["posttap"]))
        assert set(mx) == set(lin) and mx["pt_feat"].shape == lin["pt_feat"].shape
        assert all(np.isfinite(mx[k]).all() for k in ("pt3d", "pt_feat"))
        moved.append(np.abs(mx["pt3d"] - lin["pt3d"]).max(-1))
        off.append(np.abs(q8["pt3d"] - mx["pt3d"]).max(-1))
    moved, off = np.concatenate(moved), np.concatenate(off)
    log(f"ds8max against ds8lin: {float((moved > 1e-3).mean()):.4f} of "
        f"{moved.size} points moved by > 1e-3 (median {np.median(moved):.3e}, "
        f"max {moved.max():.3e}); the 'posttap' max cache against the "
        f"'coarse' one: {float((off > 1e-3).mean()):.4f} moved by > 1e-3")
    assert (moved > 1e-3).mean() > 0.01
    cfg_max = copy.deepcopy(cfg)
    cfg_max.render.feat_comb = "max"
    nerf_ckpt = save_checkpoint(root / "nerf_max" / "checkpoints", 1, renderer,
                                config=namespace2dict(cfg_max), name="last")
    return dict(dir=out["coarse"], nerf_ckpt=nerf_ckpt, launches=launches)


def phase_matcher_training(renderer, nerf_cfg, dev, seed, size=480,
                           n_frames=24, timed_steps=30, warm_steps=100):
    """Train the c2f matcher on the room scene through the CLI (debug,
    resume), time the CLI's step with and without the loader's prefetch,
    take coarse and timed c2f steps, localize with the checkpoint, then run
    phase 7 on the checkpoint and phase 8c beside the scene before it is
    removed -> (launch counts of the timed c2f steps, of the benchmark,
    phase 6's merged multi-pair numbers, phase 8c's)."""
    import copy
    import tempfile

    from nerfmatch_tpu_torch.config import load_yaml_config, save_config
    from nerfmatch_tpu_torch.cli.train_nerfmatch import main as train_cli
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.ops.matching import pad_matches_with_gt
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import (
        BATCH_KEYS, C2F_KEYS, C2FTrainStep, CoarseTrainStep, coarse_features,
        build_matcher, init_config_odir, to_device)
    from nerfmatch_tpu_torch.utils.metrics import compute_matching_loss
    from nerfmatch_tpu_torch.utils.optim import (config_adaptive_lr,
                                                 init_optimizer,
                                                 trainable_parameters)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        cache, pairs, nerf_ckpt, maxc = write_match_scene(
            renderer, nerf_cfg, dev, root, n_frames, size)
        shapes = {k: v.shape for k, v in np.load(
            next(cache.glob("*.npy")), allow_pickle=True).item().items()}
        log(f"matcher scene: {n_frames} frames {size}x{size} and their scene "
            f"points ({cache.name}: {shapes}) in {time.perf_counter() - t0:.1f}"
            f" s")
        assert shapes["pt_feat"] == ((size // 8) ** 2, 256)

        def config(name):
            cfg, _ = load_yaml_config(ROOT / "configs/nerfmatch" / name)
            cuts = {"data.data_dir": str(root), "data.scenes": ["room"],
                    "data.scene_anno_path": str(root / "#scene" /
                                                "transforms_#split.json"),
                    "data.scene_dir": str(cache),
                    "data.train_pair_txt": str(pairs),
                    "data.test_pair_txt": str(pairs),
                    "exp.odir": str(root / "out"), "exp.max_epochs": 2}
            if size != 480:
                cuts["data.img_wh"] = [size, size]
            for key, value in cuts.items():
                sec, attr = key.split(".")
                log(f"  {name} cut: {key}: {getattr(getattr(cfg, sec), attr)!r}"
                    f" -> {value!r}")
                setattr(getattr(cfg, sec), attr, value)
            cfg.data.seed = cfg.exp.seed
            return cfg

        cfg = config("nerfmatch_7scenes_sfm_c2f.yaml")
        save_config(root / "c2f.yaml", cfg)
        argv = ["--config", str(root / "c2f.yaml"), "--stage", "c2f",
                "--debug"]
        t0 = time.perf_counter()
        out_cfg, m1 = train_cli(argv)
        t1 = time.perf_counter()
        w1 = {k: v.detach().clone() for k, v in m1.state_dict().items()}
        _, m2 = train_cli(argv)
        t2 = time.perf_counter()
        assert all(torch.equal(v, w1[k]) for k, v in m2.state_dict().items()), \
            "resume changed the weights"
        ckpt = latest_checkpoint(init_config_odir(out_cfg, False) /
                                 "checkpoints", name="last")
        assert ckpt is not None and ckpt.name == "last_2", ckpt
        log(f"cli train_nerfmatch --stage c2f --debug: 2 epochs x 5 steps of "
            f"batch {cfg.exp.batch_size} + 2 val batches each in "
            f"{t1 - t0:.1f} s (lr {out_cfg.optim.lr:g} = clr * batch / cbs); "
            f"resumed at epoch 2 in {t2 - t1:.1f} s ({ckpt.name})")
        del m1, m2

        # The loader's prefetch: host time to build a batch, and the CLI's
        # step (the trainer's wall ms/step over one epoch of 20 steps) with
        # batches built in the loop (num_workers 0) or in a thread (1).
        it = iter(init_data_loader(cfg.data, cfg.exp.batch_size, split="train"))
        t0 = time.perf_counter()
        for _ in range(10):
            next(it)
        host_s = (time.perf_counter() - t0) / 10
        cli_ms = {}
        for workers in (0, 1):
            c = copy.deepcopy(cfg)
            c.exp.num_workers, c.exp.max_epochs = workers, 1
            c.exp.resume_version = f"workers{workers}"
            c.data.epoch_sample_num = 20 * c.exp.batch_size
            save_config(root / "workers.yaml", c)
            out, _ = train_cli(["--config", str(root / "workers.yaml"),
                                "--stage", "c2f"])
            metrics = init_config_odir(out, False) / "metrics.jsonl"
            cli_ms[workers] = next(
                r["train/ms_per_step"] for r in map(
                    json.loads, metrics.read_text().splitlines())
                if "train/ms_per_step" in r)
        log(f"loader: {host_s:.4f} s of host time per batch of "
            f"{cfg.exp.batch_size}; CLI {cli_ms[0]:.1f} ms/step with "
            f"num_workers 0, {cli_ms[1]:.1f} with 1 (prefetch thread)")

        def batches(cfg, keys, n):
            it = iter(init_data_loader(cfg.data, cfg.exp.batch_size,
                                       split="train", num_workers=1))
            return [to_device(next(it), keys, dev) for _ in range(n)]

        def trainer(cfg, coarse):
            model = build_matcher(cfg, coarse, torch.Generator().manual_seed(
                seed)).to(dev)
            opt = init_optimizer(cfg.optim, trainable_parameters(model),
                                 lr=config_adaptive_lr(cfg)[0])
            return model, opt

        ccfg = config("nerfmatch_7scenes_sfm_coarse.yaml")
        model, opt = trainer(ccfg, True)
        step = CoarseTrainStep(model, opt)
        closs = [float(step.step(b)["loss"])
                 for b in batches(ccfg, BATCH_KEYS, 5)]
        log(f"coarse: 5 CoarseTrainStep steps at batch "
            f"{ccfg.exp.batch_size}, loss {[round(x, 5) for x in closs]}")
        assert np.isfinite(closs).all(), closs
        del model, opt, step

        model, opt = trainer(cfg, False)
        step = C2FTrainStep(model, opt,
                            generator=torch.Generator(dev).manual_seed(seed))
        # Five batches cycled: the first and the last 5 of 32 steps see the
        # same five.  The loss on them, each with one fixed list of GT
        # matches, before and after the timed steps shows whether training
        # lowered it, whatever each step's own GT draw.
        data = batches(cfg, C2F_KEYS, 5)
        no_pred = lambda gt: {"j_ids": torch.zeros_like(gt, dtype=torch.long),
                              "mconf": torch.zeros_like(gt),
                              "valid": torch.zeros_like(gt, dtype=torch.bool)}
        gt_lists = [pad_matches_with_gt(no_pred(b["conf_gt"][..., 0]),
                                        b["conf_gt"], generator=step.generator)
                    for b in data]

        def fixed_loss():
            """(total, coarse, fine) loss on the five batches and lists."""
            with torch.no_grad():
                terms = [step.losses(b, mlist=m)[1]
                         for b, m in zip(data, gt_lists)]
            return tuple(np.mean([float(t[k]) for t in terms])
                         for k in ("loss", "coarse_loss", "fine_loss"))

        def coarse_term(clamp):
            """Mean focal loss on the five batches, and the share of GT
            positives whose conf clears the clamp (1e-6)."""
            loss, above = 0.0, 0.0
            for b in data:
                conf = coarse_features(model, *(b[k] for k in BATCH_KEYS[:5]))[0]
                term = compute_matching_loss(conf, b["conf_gt"], clamp=clamp)
                if torch.is_grad_enabled():
                    term.backward()
                loss += float(term.detach()) / len(data)
                above += float((conf[b["conf_gt"] == 1] > 1e-6).float().mean()
                               ) / len(data)
            return loss, above

        # From a random init every conf of the 3600 x 3600 dual softmax is
        # ~1e-7: the c2f's clamped focal loss sits at its clamp and sends the
        # coarse path no gradient.  The reference starts Full from ImageNet
        # or a trained Mini; here the same model first takes coarse steps
        # with the Mini's unclamped loss (CoarseTrainStep), until GT
        # positives clear the clamp.
        with torch.no_grad():
            warm_before = coarse_term(clamp=False)
        warm = CoarseTrainStep(model, opt)
        for i in range(warm_steps):
            warm.step(data[i % len(data)])
        with torch.no_grad():
            warm_after = coarse_term(clamp=False)
        model.zero_grad(set_to_none=True)
        clamped = coarse_term(clamp=True)[0]
        gnorm = {}
        for name, p in model.named_parameters():
            if p.grad is not None:
                top = name.split(".")[0]
                gnorm[top] = gnorm.get(top, 0.0) + float(p.grad.norm()) ** 2
        gnorm = {k: v ** 0.5 for k, v in gnorm.items()}
        model.zero_grad(set_to_none=True)
        log(f"coarse warm-up at c2f width: {warm_steps} CoarseTrainStep steps,"
            f" unclamped focal loss {warm_before[0]:.4f} -> {warm_after[0]:.4f}"
            f", GT positives above the clamp {warm_before[1]:.4f} -> "
            f"{warm_after[1]:.4f}; the c2f's clamped coarse term "
            f"{clamped:.4f}, its gradient norm by module " + json.dumps(
                {k: float(f"{v:.4g}") for k, v in gnorm.items()}))
        assert warm_after[0] < warm_before[0], (warm_before, warm_after)
        # The clamped coarse term alone reaches the trunk (kernels 8-9) and
        # the attention layers (kernel 4).
        for mod in ("backbone", "pt_sa", "coarse_former"):
            assert 0 < gnorm.get(mod, 0) < float("inf"), (mod, gnorm)

        before = fixed_loss()
        hist = [step.step(data[i % 5]) for i in range(2)]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        hist += [step.step(data[i % 5]) for i in range(2, 2 + timed_steps)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                step.step(data[i % 5])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)
        log(f"launches during matcher training: {json.dumps(launches)}")
        missing = [k for k in MATCH_KERNELS if launches[k] == 0]
        assert not missing, f"kernels never launched in matcher training: " \
            f"{missing}"
        after = fixed_loss()
        loss, closs, floss, pos = ([float(m[k]) for m in hist] for k in (
            "loss", "coarse_loss", "fine_loss", "coarse_pos_ratio"))
        # Kernel rows only: a user annotation's range (the optimizer step)
        # spans kernels that have rows of their own.
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
        dev_ms = sum(e.self_device_time_total for e in ka) / 1e3
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:16]
        log(f"matcher training: {step_ms:.1f} ms/step, "
            f"{cfg.exp.batch_size / step_ms * 1e3:.2f} pairs/s over "
            f"{timed_steps} c2f steps of batch {cfg.exp.batch_size} "
            f"({size}x{size}, {(size // 8) ** 2} tokens x {(size // 8) ** 2} "
            f"points); loss on the 5 batches with fixed GT match lists "
            f"{before[0]:.4f} -> {after[0]:.4f} (coarse {before[1]:.4f} -> "
            f"{after[1]:.4f}, fine {before[2]:.4f} -> {after[2]:.4f}); "
            f"per-step coarse loss mean of the "
            f"first / last 5 {np.mean(closs[:5]):.4f} / {np.mean(closs[-5:]):.4f}"
            f", fine {np.mean(floss[:5]):.4f} / {np.mean(floss[-5:]):.4f} "
            f"with {np.mean(pos[:5]):.2f} / {np.mean(pos[-5:]):.2f} % of the "
            f"listed matches within coarse_dthres, total "
            f"{np.mean(loss[:5]):.4f} / {np.mean(loss[-5:]):.4f}; peak "
            f"memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; profiled "
            f"3 steps: wall {wall:.1f} ms, device {dev_ms:.1f} ms, idle share "
            f"{max(0.0, 1 - dev_ms / wall):.2f}")
        log("  device time by kernel (ms, 3 steps): " + json.dumps(
            {e.key[:60]: round(e.self_device_time_total / 1e3, 2)
             for e in top}))
        groups = {"attention backward (kernel 4)": ("attn_bwd",),
                  "attention forward (kernel 3)": ("attention_",),
                  "StarReLU + dwconv (kernels 7-9)": ("dw_star",
                                                      "wgrad_sum"),
                  "GEMMs": ("gemm", "Gemm"), "cuDNN convs": ("conv", "cudnn"),
                  "optimizer": ("multi_tensor",)}
        by_group = {g: 0.0 for g in (*groups, "other")}
        for e in ka:
            g = next((g for g, keys in groups.items()
                      if any(k in e.key for k in keys)), "other")
            by_group[g] += e.self_device_time_total / 1e3 / 3
        log("  device time by group (ms per step): " + json.dumps(
            {g: round(v, 2) for g, v in by_group.items()}))
        assert np.isfinite(loss).all(), loss
        assert after[0] < before[0], (before, after)
        # The per-step coarse loss must fall too.  The per-step total need
        # not: as the coarse matches improve, more of each step's predicted
        # matches fall within coarse_dthres of their GT and enter the fine
        # loss, each with several times a GT-padded match's pixel error.
        # The fixed-list loss above is the fine part's learning check.
        assert np.mean(closs[-5:]) < np.mean(closs[:5]), closs
        del model, opt, step, data
        torch.cuda.empty_cache()
        multipair = phase_multipair_training(config, root, dev, seed)
        phase_ablation_steps(config, dev, seed, batches, trainer)
        torch.cuda.empty_cache()

        evaluator = NeRFMatchEvaluator(
            cfg, state_dict=torch.load(ckpt / "model.pt", map_location="cpu",
                                       weights_only=True), device=dev)
        with torch.no_grad():
            req = make_request(renderer, 0.3, dev, size)
            res = evaluator.eval_batch(scene_points(renderer, [req], size),
                                       renderer=renderer, iters=2, mutual=True,
                                       solver="colmap", rthres=10.0)
        c2w, r_err, t_err = res["c2w_est"][0], res["R_err"][0], res["t_err"][0]
        assert (c2w is None and r_err == t_err == float("inf")) or (
            np.isfinite(c2w).all() and np.isfinite([r_err, t_err]).all())
        log(f"localized with {ckpt.name}: {res['num_matches'][0]} matches, "
            f"R_err {r_err:.2f} deg, t_err {t_err:.3f}")
        del evaluator
        torch.cuda.empty_cache()
        bench = phase_benchmark(ckpt, nerf_ckpt, maxc)
        torch.cuda.empty_cache()
        multiscene = phase_multiscene_training(
            renderer, nerf_cfg, config, root, dev, seed, nerf_ckpt,
            {k: launches[k] / (timed_steps + 3) for k in MATCH_KERNELS},
            size)
    bench["render_fine_int8_max"] = maxc["launches"]["posttap"][
        "render_fine_int8_max"]
    return launches, bench, multipair, multiscene


class AttentionShapes:
    """Counts the attention kernels' launches by (L, S) while active: the
    forward kernel (``_forward_kernel``) and the backward
    (``attention_bwd``, which the autograd Function calls)."""

    def __init__(self):
        from nerfmatch_tpu_torch.ops.kernels import attention_kernel

        self.mod = attention_kernel
        self.fwd, self.bwd = {}, {}

    def __enter__(self):
        mod, fwd, bwd = self.mod, self.mod._forward_kernel, self.mod.attention_bwd
        self.saved = fwd, bwd

        def counted_fwd(qs, k, v, bf16, want_lse):
            key = (qs.shape[1], k.shape[1])
            self.fwd[key] = self.fwd.get(key, 0) + 1
            return fwd(qs, k, v, bf16, want_lse)

        def counted_bwd(qs, k, v, g, bf16=False, out=None, lse=None):
            key = (qs.shape[1], k.shape[1])
            self.bwd[key] = self.bwd.get(key, 0) + 1
            return bwd(qs, k, v, g, bf16, out=out, lse=lse)

        mod._forward_kernel, mod.attention_bwd = counted_fwd, counted_bwd
        return self

    def __exit__(self, *exc):
        self.mod._forward_kernel, self.mod.attention_bwd = self.saved

    def by_key_count(self, counts):
        out = {}
        for (_, S), n in counts.items():
            out[S] = out.get(S, 0) + n
        return out


def phase_multipair_training(config, root, dev, seed, steps=10):
    """Merged multi-pair c2f training on the room scene
    (``NeRFMatchMultiPair``, ``pair_topk: 4``, ``sample_mode: rand``,
    ``sample_pts: 14400``; the pairs file's 4 refs a query, drawn with
    replacement): ``cli.train_nerfmatch --stage c2f --debug`` (one epoch of
    5 steps and 2 val queries) and its resume, then ``steps`` timed
    ``C2FTrainStep`` steps at batch 2 on 3 batches, with the peak memory and
    the attention kernels' launches by (L, S) -> dict(ms_per_step,
    peak_gib, launches a step at S = 14,400 by kernel and shape)."""
    from nerfmatch_tpu_torch.config import save_config
    from nerfmatch_tpu_torch.cli.train_nerfmatch import main as train_cli
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import (
        C2F_KEYS, C2FTrainStep, build_matcher, init_config_odir, to_device)
    from nerfmatch_tpu_torch.utils.optim import (config_adaptive_lr,
                                                 init_optimizer,
                                                 trainable_parameters)

    cfg = config("nerfmatch_7scenes_sfm_c2f.yaml")
    for key, value in (("data.dataset", "NeRFMatchMultiPair"),
                       ("data.pair_topk", 4), ("data.sample_mode", "rand"),
                       ("data.sample_pts", MERGED_S), ("exp.max_epochs", 1),
                       ("exp.resume_version", "multipair")):
        sec, attr = key.split(".")
        log(f"  multi-pair cut: {key}: "
            f"{getattr(getattr(cfg, sec), attr, None)!r} -> {value!r}")
        setattr(getattr(cfg, sec), attr, value)
    save_config(root / "multipair.yaml", cfg)
    argv = ["--config", str(root / "multipair.yaml"), "--stage", "c2f",
            "--debug"]
    t0 = time.perf_counter()
    out_cfg, m1 = train_cli(argv)
    t1 = time.perf_counter()
    w1 = {k: v.detach().clone() for k, v in m1.state_dict().items()}
    _, m2 = train_cli(argv)
    assert all(torch.equal(v, w1[k]) for k, v in m2.state_dict().items()), \
        "multi-pair resume changed the weights"
    ckpt = latest_checkpoint(init_config_odir(out_cfg, False) / "checkpoints",
                             name="last")
    assert ckpt is not None and ckpt.name == "last_1", ckpt
    meta = json.loads((ckpt / "meta.json").read_text())
    log(f"cli train_nerfmatch --stage c2f --debug on the merged multi-pair "
        f"config: 1 epoch of 5 steps of batch {cfg.exp.batch_size} + 2 val "
        f"queries in {t1 - t0:.1f} s, resumed in "
        f"{time.perf_counter() - t1:.1f} s ({ckpt.name}; val loss "
        f"{meta['best_loss']:.4f})")
    del m1, m2, w1

    it = iter(init_data_loader(cfg.data, cfg.exp.batch_size, split="train",
                               num_workers=1))
    t0 = time.perf_counter()
    data = [to_device(next(it), C2F_KEYS, dev) for _ in range(3)]
    host_s = (time.perf_counter() - t0) / 3
    assert data[0]["pt3d"].shape == (cfg.exp.batch_size, MERGED_S, 3)
    model = build_matcher(cfg, False, torch.Generator().manual_seed(seed)).to(dev)
    opt = init_optimizer(cfg.optim, trainable_parameters(model),
                         lr=config_adaptive_lr(cfg)[0])
    step = C2FTrainStep(model, opt,
                        generator=torch.Generator(dev).manual_seed(seed))
    for i in range(2):
        step.step(data[i % 3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with AttentionShapes() as shapes:
        t0 = time.perf_counter()
        hist = [step.step(data[i % 3]) for i in range(steps)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = [float(m["loss"]) for m in hist]
    launches = {k: v for k, v in LAUNCHES.items() if v}
    fwd_s, bwd_s = (shapes.by_key_count(c) for c in (shapes.fwd, shapes.bwd))
    per_step = {
        f"{name} L={L} S={S}": counts.get((L, S), 0) / steps
        for name, counts in (("attention", shapes.fwd),
                             ("attention_bwd", shapes.bwd))
        for L, S in MERGED_TRAIN_SHAPES}
    log(f"merged multi-pair training: {ms:.1f} ms/step over {steps} "
        f"C2FTrainStep steps of batch {cfg.exp.batch_size} (3600 tokens x "
        f"{MERGED_S} points; batches built beforehand, {host_s:.2f} s of host "
        f"time each), peak memory {peak:.2f} GiB, loss "
        f"{[round(x, 4) for x in loss]}; launches {json.dumps(launches)}; "
        f"attention launches by (L, S): forward "
        + json.dumps({f"{L}x{S}": n for (L, S), n in sorted(shapes.fwd.items())})
        + ", backward "
        + json.dumps({f"{L}x{S}": n for (L, S), n in sorted(shapes.bwd.items())})
        + f"; by key count: forward {json.dumps(fwd_s)}, backward "
        f"{json.dumps(bwd_s)}")
    assert np.isfinite(loss).all(), loss
    # A step runs pt_sa's 3 layers at L = S = 14,400 and the coarse former's
    # image queries over the points once, forward and backward.
    for name, counts in (("attention", shapes.fwd),
                         ("attention_bwd", shapes.bwd)):
        assert counts.get((MERGED_S, MERGED_S), 0) == 3 * steps, (name, counts)
        assert counts.get((3600, MERGED_S), 0) == steps, (name, counts)
    del model, opt, step, data
    return dict(ms_per_step=ms, peak_gib=peak, per_step=per_step,
                steps=steps)


def phase_ablation_steps(config, dev, seed, batches, trainer, steps=5):
    """Five ``CoarseTrainStep`` steps with ``pt_ftype='rand'`` (descriptors
    drawn from the step's generator, one draw a step) and five
    ``C2FTrainStep`` steps with the FPN backbone (``convformer384_fpn``:
    the FPN exists on the two-scale backbone only), each from a fresh
    initialization on the single-pair room batches: finite losses, and the
    FPN's BatchNorm running statistics moved (parameters, as the JAX
    package's leaves).  Each step is timed on its own (the first includes
    cuDNN's algorithm search for new shapes)."""
    from nerfmatch_tpu_torch.train.matcher_trainer import (
        BATCH_KEYS, C2F_KEYS, C2FTrainStep, CoarseTrainStep)

    def timed(step, data):
        """-> (losses, ms of each step, device synced)."""
        loss, ms = [], []
        for b in data:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss.append(float(step.step(b)["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return loss, ms

    ccfg = config("nerfmatch_7scenes_sfm_coarse.yaml")
    ccfg.model.pt_ftype = "rand"
    model, opt = trainer(ccfg, True)
    gen = torch.Generator(dev).manual_seed(seed)
    step = CoarseTrainStep(model, opt, generator=gen)
    loss, ms = timed(step, batches(ccfg, BATCH_KEYS, steps))
    log(f"pt_ftype='rand': {steps} CoarseTrainStep steps at batch "
        f"{ccfg.exp.batch_size}, ms a step {[round(x, 1) for x in ms]} "
        f"(steps 2-{steps}: {np.mean(ms[1:]):.1f} ms/step), loss "
        f"{[round(x, 5) for x in loss]}")
    assert np.isfinite(loss).all(), loss
    del model, opt, step

    fcfg = config("nerfmatch_7scenes_sfm_c2f.yaml")
    fcfg.model.backbone = "convformer384_fpn"
    model, opt = trainer(fcfg, False)
    bn = model.backbone.layer1_outconv2[1]
    stats = [bn.running_mean.detach().clone(), bn.running_var.detach().clone()]
    step = C2FTrainStep(model, opt, generator=torch.Generator(dev).manual_seed(
        seed))
    loss, ms = timed(step, batches(fcfg, C2F_KEYS, steps))
    moved = [float((p.detach() - s).abs().max())
             for p, s in zip((bn.running_mean, bn.running_var), stats)]
    log(f"convformer384_fpn: {steps} C2FTrainStep steps at batch "
        f"{fcfg.exp.batch_size}, ms a step {[round(x, 1) for x in ms]} "
        f"(steps 2-{steps}: {np.mean(ms[1:]):.1f} ms/step), loss "
        f"{[round(x, 5) for x in loss]}; the FPN BatchNorm's running_mean / "
        f"running_var moved by up to {moved[0]:.3e} / {moved[1]:.3e}")
    assert np.isfinite(loss).all(), loss
    assert min(moved) > 0, moved


def phase_benchmark(ckpt, nerf_ckpt, maxc):
    """Phase 7: ``cli.benchmark_nerfmatch`` on the matcher checkpoint, its
    cached scene and the NeRF checkpoint (``maxc``: phase 6's ``ds8max``
    cache and feat_comb='max' NeRF) -> launch counts of the main run, with
    ``render_fine_max`` the ``ds8max`` run's and ``attention_merged`` the
    merged run's attention launches at S = 14,400."""
    from nerfmatch_tpu_torch.cli.benchmark_nerfmatch import main as bench_cli
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts

    argv = ["--ckpts", str(ckpt), "--nerf_path", str(nerf_ckpt), "--iters",
            "2", "--mutual", "--rthres", "10", "--eval_bs", "2"]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    (avg, per_scene), = bench_cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    # The reference's tag: <scene>_rth<rthres><split>[_<solver>]_itr<iters>,
    # under <ckpt dir>/<model name>_results.
    path = ckpt.parent / "best_tmed_results" / "room_rth10test_colmap_itr2.npy"
    assert path.exists(), f"no metrics file {path}"
    metrics = np.load(path, allow_pickle=True).item()
    r_err, t_err = (np.asarray(metrics[k], np.float64) for k in ("R_err", "t_err"))
    solved = np.isfinite(r_err) & np.isfinite(t_err)
    assert np.array_equal(solved, np.isfinite(r_err) | np.isfinite(t_err)), \
        "a pose with one finite and one infinite error"
    log(f"benchmark_nerfmatch {' '.join(argv[2:])}... : {len(r_err)} queries "
        f"in {wall:.1f} s, {int(solved.sum())} solved; per scene " + json.dumps(
            [{k: round(m[k], 3) for k in ("t_med", "r_med", "recall",
                                          "localize_time")} for m in per_scene])
        + f" (t_med cm, r_med deg, recall % at 5 cm / 5 deg, localize_time "
        f"ms per query); metrics file {path.name} with "
        f"{sorted(metrics)}")
    log(f"launches during the benchmark: {json.dumps(launches)}")
    missing = [k for k in ("render_coarse_int8", "render_fine", "resample",
                           "attention", "dw_star_fwd") if launches[k] == 0]
    assert not missing, f"kernels never launched in the benchmark: {missing}"
    per_protocol = bench_protocols(ckpt, nerf_ckpt, maxc, metrics)
    run = lambda flag: next(v for k, v in per_protocol.items() if flag in k)
    launches["render_fine_max"] = run("--cache_tag")["render_fine_max"]
    launches["attention_merged"] = run("--sample_mode")["attention_s"]
    return launches


def bench_protocols(ckpt, nerf_ckpt, maxc, metrics):
    """Phase 7's :data:`BENCH_PROTOCOLS` -> their launch counts by their
    flags (joined), with ``attention_s``: the attention launches at S =
    14,400."""
    from nerfmatch_tpu_torch.eval import match_evaluator

    out = {}
    gifs, write_gif = {}, match_evaluator.write_gif

    def recorded(path, frames, *args, **kwargs):
        gifs[Path(path).name] = len(frames)
        return write_gif(path, frames, *args, **kwargs)

    match_evaluator.write_gif = recorded
    try:
        for raw, tag, kernels in BENCH_PROTOCOLS:
            gifs.clear()
            out[" ".join(raw)] = bench_protocol(
                ckpt, nerf_ckpt, maxc, metrics, raw, tag, kernels, gifs)
    finally:
        match_evaluator.write_gif = write_gif
    return out


def bench_protocol(ckpt, nerf_ckpt, maxc, metrics, raw, tag, kernels, gifs):
    """One of :data:`BENCH_PROTOCOLS` -> its launch counts, with
    ``attention_s`` (see :func:`bench_protocols`); ``gifs``: the frames of
    each GIF ``--visualize`` wrote, by name."""
    from nerfmatch_tpu_torch.cli.benchmark_nerfmatch import main as bench_cli
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts

    flags = [f.format(max_dir=maxc["dir"], max_nerf=maxc["nerf_ckpt"])
             for f in raw]
    argv = ["--ckpts", str(ckpt), "--nerf_path", str(nerf_ckpt),
            "--mutual", "--rthres", "10", *flags]
    torch.cuda.synchronize()
    reset_launch_counts()
    with AttentionShapes() as shapes:
        t0 = time.perf_counter()
        (avg, _), = bench_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    keys = shapes.by_key_count(shapes.fwd)
    res = (f"{flags[flags.index('--cache_tag') + 1]}_"
           if "--cache_tag" in flags else "") + "best_tmed_results"
    path = ckpt.parent / res / f"room_rth10test_colmap{tag}.npy"
    assert path.exists(), f"no metrics file {path}"
    m = np.load(path, allow_pickle=True).item()
    r_err, t_err = (np.asarray(m[k], np.float64) for k in ("R_err", "t_err"))
    solved = np.isfinite(r_err) & np.isfinite(t_err)
    n_queries = 6 if "--debug" in flags else len(metrics["R_err"])
    assert len(r_err) == n_queries, (path.name, len(r_err))
    assert np.array_equal(solved, np.isfinite(r_err) | np.isfinite(t_err))
    steps = m.get("inerf_step_time", np.zeros(0)) * 1e3
    log(f"benchmark_nerfmatch {' '.join(flags)}: {len(r_err)} queries in "
        f"{wall:.1f} s, {int(solved.sum())} solved; t_med "
        f"{avg['t_med']:.3f} cm r_med {avg['r_med']:.3f} deg, "
        f"localize_time {avg['localize_time']:.3f} ms a query"
        + (f", {len(steps)} iNeRF steps, median {np.median(steps):.2f} ms"
           if len(steps) else "")
        + f"; file {path.name} with {sorted(m)}; launches "
        + json.dumps({k: v for k, v in LAUNCHES.items() if v}))
    missing = [k for k in kernels if LAUNCHES[k] == 0]
    assert not missing, f"{flags}: kernels never launched: {missing}"
    if "--inerf" in flags:
        assert len(steps) > 0 and len(steps) % 2 == 0
        assert LAUNCHES["render_coarse_int8"] == len(steps)
    if "--pair_topk" in flags:
        log(f"  attention launches by key count: " + json.dumps(
            {str(s_): n for s_, n in sorted(keys.items())})
            + f"; matches a query {np.mean(m['num_matches']):.1f}")
        assert np.isfinite(np.asarray(m["num_matches"], float)).all()
    if "--sample_mode" in flags:
        # The points' self-attention and the image's queries over them
        # run on the kernel at the merged S.
        assert keys.get(MERGED_S, 0) >= 2 * len(r_err), keys
    if "--match_oracle" in flags:
        assert LAUNCHES["attention"] == 0 and int(solved.sum()) > 0
    if "--cache_tag" in flags:
        assert LAUNCHES["render_fine"] == 0
    if "--visualize" in flags:
        from PIL import Image

        files = sorted(ckpt.parent.rglob("visualization/room/*.gif"))
        # A query whose first PnP failed (t_err inf) has no iNeRF frames.
        over = {i for i, t in enumerate(t_err) if np.isfinite(t) and t > 0.5}
        assert {f.name for f in files} == set(gifs), (files, gifs)
        assert {int(n.split("_")[0]) for n in gifs} == over, (gifs, over)
        n_optim = int(flags[flags.index("--inerf_optim") + 1])
        assert all(n == n_optim for n in gifs.values()), gifs
        read = {}
        for f in files:
            with Image.open(f) as im:
                read[f.name] = (im.n_frames, im.size)
        log(f"  --visualize: {len(files)} GIFs for the {len(over)} of "
            f"{len(t_err)} queries over 50 cm, {n_optim} overlay frames "
            f"each (as written; frames and size as PIL reads them back: "
            f"{json.dumps(read)})")
    return dict(LAUNCHES, attention_s=keys.get(MERGED_S, 0))


# Kernels 1, 1b, 2, 5 and 6: every render stage (eval and train, each
# branch) and the resample.  Phase 8a must launch none of them.
NERF_KERNEL_PREFIXES = ("render_", "resample")


def nerf_launches():
    """The launch counts of kernels 1, 1b, 2, 5 and 6 that moved."""
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES

    return {k: v for k, v in LAUNCHES.items()
            if v and k.startswith(NERF_KERNEL_PREFIXES)}


def variant_nerf_config(root, name, edits):
    """``configs/nerf/nerf_7scenes_mip_sfm.yaml`` on phase 5's room scene
    (data paths, output dir and 2 epochs: 20 debug steps) with ``edits``
    ((dotted key, value) pairs, each logged) -> config."""
    from nerfmatch_tpu_torch.config import load_yaml_config

    cfg, _ = load_yaml_config(ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    cfg.data.data_dir = str(root)
    cfg.data.scene = "room"
    cfg.data.scene_anno_path = str(root / "#scene" / "transforms_#split.json")
    cfg.exp.odir = str(root / f"out_{name}")
    cfg.exp.max_epochs = 2
    for key, value in edits:
        sec, attr = key.split(".")
        log(f"  {name} config: {key}: "
            f"{getattr(getattr(cfg, sec), attr, None)!r} -> {value!r}")
        setattr(getattr(cfg, sec), attr, value)
    return cfg


def variant_cli(cfg, root, name):
    """``cli.train_nerf --debug`` on ``cfg`` (2 epochs of 10 steps) and its
    resume -> (the last checkpoint, the logged route, seconds of the first
    run)."""
    from nerfmatch_tpu_torch.config import save_config
    from nerfmatch_tpu_torch.cli.train_nerf import main as train_cli
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.nerf_trainer import init_config_odir

    path = root / f"{name}.yaml"
    save_config(path, cfg)
    t0 = time.perf_counter()
    out_cfg, r1 = train_cli(["--config", str(path), "--debug"])
    secs = time.perf_counter() - t0
    w1 = r1.nerf_fine.pts_linears[0].weight.detach().clone()
    del r1
    _, r2 = train_cli(["--config", str(path), "--debug"])
    assert torch.equal(r2.nerf_fine.pts_linears[0].weight, w1), "resume"
    del r2
    run_dir = init_config_odir(out_cfg)
    ckpt = latest_checkpoint(run_dir / "checkpoints", name="last")
    assert ckpt is not None and ckpt.name == "last_2", ckpt
    return ckpt, (run_dir / "route.txt").read_text(), secs


def variant_steps(cfg, dev, seed, steps=10):
    """``steps`` timed ``NerfTrainer`` steps of 9216 rays (after 2 untimed)
    from a fresh initialization; the loss must fall -> (trainer, ms a step,
    peak GiB, losses, the first batch's rays)."""
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    trainer = NerfTrainer(cfg, device=dev, seed=seed)
    assert trainer.route == "plain", trainer.route
    ds = init_data_loader(cfg.data, split="train").dataset
    batches = ds.ray_batches(cfg.exp.batch_size, np.random.default_rng(seed))
    data = [tuple(torch.as_tensor(b[k], device=dev) for k in ("rays", "rgbs"))
            for b in (next(batches) for _ in range(steps + 2))]
    gen = torch.Generator(dev).manual_seed(seed)
    hist = [trainer.train_step(*data[i], gen) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist += [trainer.train_step(*data[i], gen) for i in range(2, steps + 2)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = [float(m["loss"]) for m in hist]
    assert np.isfinite(loss).all(), loss
    assert np.mean(loss[-3:]) < np.mean(loss[:3]), loss
    return trainer, ms, peak, loss, data[0][0]


def phase_nerf_variants(dev, seed, root, n_psnr=2):
    """Phase 8a and 8b on phase 5's room scene (under ``root``) at the
    7-Scenes config's full width.

    8a: the config with ``embedding.type: normal`` and ``render.use_viewdirs:
    False`` (the classic NeRF, which no kernel renders in either package):
    ``cli.train_nerf --debug`` (20 steps) and its resume, 10 timed steps
    (ms, peak memory; the loss falls), ``cli.eval_nerf``'s PSNR mode on
    ``n_psnr`` frames; the logged route is ``plain`` and kernels 1, 1b, 2,
    5 and 6 launch 0 times over the whole part.

    8b: the mip config with ``data.out_scr: True``: the CLI (20 steps, the
    plain route: kernels 5 and 6 at 0) and its resume, 10 timed steps,
    ``scr_fine`` finite; the CLI checkpoint's scene points cached at the
    serving default (``'coarse'``: kernels 1b, 2, 1) and again from the
    same weights without the head, on the same route: pt3d and pt_feat
    within 5e-3 -> dict of the phase's numbers and the cache's launches."""
    import copy

    from nerfmatch_tpu_torch.cli import eval_nerf
    from nerfmatch_tpu_torch.eval.nerf_evaluator import (NerfEvaluator,
                                                         load_renderer)
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts

    out = {}
    # 8a: the classic NeRF without viewdirs.
    cfg = variant_nerf_config(root, "classic", (
        ("embedding.type", "normal"), ("render.use_viewdirs", False)))
    torch.cuda.synchronize()
    reset_launch_counts()
    ckpt, route, cli_s = variant_cli(cfg, root, "classic")
    trainer, ms, peak, loss, _ = variant_steps(cfg, dev, seed)
    del trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = eval_nerf.main(["--ckpt", str(ckpt), "--split", "test", "--img_wh",
                          "480", "480", "--downsample", "1", "--nums",
                          str(n_psnr), "--cache_dir", str(root / "psnr_8a")])
    torch.cuda.synchronize()
    psnr_s = (time.perf_counter() - t0) / n_psnr
    launched = nerf_launches()
    log(f"8a classic NeRF (Fourier 15/4, no viewdirs, 128 + 256 samples): "
        f"cli --debug 20 steps + validation in {cli_s:.1f} s, route "
        f"{route!r}, resumed ({ckpt.name}); {ms:.1f} ms/step over 10 steps "
        f"of {cfg.exp.batch_size} rays, peak {peak:.2f} GiB, loss "
        f"{loss[0]:.4f} -> {np.mean(loss[-3:]):.4f}; eval_nerf PSNR "
        f"{[round(v, 3) for v in res['psnr']]} dB, {psnr_s:.2f} s an image "
        f"(480x480); kernels 1, 1b, 2, 5, 6 launched {json.dumps(launched)}")
    assert route == "plain", route
    assert not launched, f"the classic NeRF launched {launched}"
    assert len(res["psnr"]) == n_psnr and np.isfinite(res["psnr"]).all()
    out["8a"] = dict(ms_per_step=ms, peak_gib=peak, psnr_s=psnr_s)
    torch.cuda.empty_cache()

    # 8b: the scene-coordinate head.
    cfg = variant_nerf_config(root, "out_scr", (("data.out_scr", True),))
    torch.cuda.synchronize()
    reset_launch_counts()
    ckpt, route, cli_s = variant_cli(cfg, root, "out_scr")
    trainer, ms, peak, loss, rays = variant_steps(cfg, dev, seed)
    with torch.no_grad():
        scr = trainer.render_train(rays, torch.Generator(dev).manual_seed(
            seed))["scr_fine"]
    train_launched = nerf_launches()
    del trainer
    torch.cuda.empty_cache()
    log(f"8b out_scr NeRF (mip, the head {cfg.fine_nerf.hid_dim}-"
        f"{cfg.fine_nerf.hid_dim // 2}-3): cli --debug 20 steps + validation "
        f"in {cli_s:.1f} s, route {route!r}; {ms:.1f} ms/step over 10 steps, "
        f"peak {peak:.2f} GiB, loss {loss[0]:.4f} -> {np.mean(loss[-3:]):.4f};"
        f" scr_fine {tuple(scr.shape)} finite {bool(torch.isfinite(scr).all())}"
        f"; kernels launched in training {json.dumps(train_launched)}")
    assert route == "plain", route
    assert not any(k.startswith("render_train") for k in train_launched), \
        train_launched
    assert scr.shape == (cfg.exp.batch_size, 3) and torch.isfinite(scr).all()
    out["8b"] = dict(ms_per_step=ms, peak_gib=peak)

    ccfg = match_scene_config(cfg, root, "room")
    head, _ = load_renderer(ckpt, stop_layer=3)
    head = head.to(dev).eval()
    assert head.cfg.out_scr and head.fused_eval_supported
    hcfg = copy.deepcopy(ccfg)
    hcfg.data.out_scr = False
    bare = NerfRenderer(hcfg, stop_layer=3)
    bare.load_state_dict({k: v for k, v in head.state_dict().items()
                          if "pnt_block" not in k}, strict=True)
    bare = bare.to(dev).eval()
    caches, secs, launches = {}, {}, {}
    for name, r, c in (("head", head, ccfg), ("bare", bare, hcfg)):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        caches[name] = NerfEvaluator(c, r).cache_scene_pts(
            cache_dir=root / f"scr_cache_{name}")
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = {k: v for k, v in LAUNCHES.items() if v}
    n = len(list(caches["head"].glob("*.npy")))
    err = {"pt3d": 0.0, "pt_feat": 0.0}
    for f in sorted(caches["head"].glob("*.npy")):
        a, b = (np.load(caches[k] / f.name, allow_pickle=True).item()
                for k in ("head", "bare"))
        for k in err:
            err[k] = max(err[k], float(np.abs(a[k] - b[k]).max()))
    log(f"8b scene points of the out_scr checkpoint at trunk_int8="
        f"{head.cfg.trunk_int8!r}: {n} frames in {secs['head']:.2f} s, "
        f"launches {json.dumps(launches['head'])}; the head-less weights "
        f"{secs['bare']:.2f} s, launches {json.dumps(launches['bare'])}; "
        f"largest difference pt3d {err['pt3d']:.3e}, pt_feat "
        f"{err['pt_feat']:.3e} (tolerance 5e-3)")
    for k in ("render_coarse_int8", "resample", "render_fine"):
        assert launches["head"].get(k) == n, (k, launches["head"])
    assert launches["head"] == launches["bare"]
    assert max(err.values()) < 5e-3, err
    out["8b"].update(cache_s=secs["head"], cache_bare_s=secs["bare"],
                     launches=launches["head"], err=err)
    return out


def phase_multiscene_training(renderer, nerf_cfg, config, root, dev, seed,
                              nerf_ckpt, phase6_per_step, size=480, steps=10):
    """Phase 8c, in phase 6's scene dir: a second room scene at other poses
    (the camera circle turned by half a frame) and its scene points, beside
    phase 6's (``room_a``); the c2f config with ``data.scenes: [room_a,
    room_b]``: ``cli.train_nerfmatch --stage c2f --debug`` (one epoch) and
    its resume; ``steps`` timed ``C2FTrainStep`` steps at batch 2 on
    batches of one sample of each scene (ms, peak memory; the launches a
    step of kernels 3, 4, 7, 8, 9 equal to phase 6's ``phase6_per_step``);
    2 steps on a ``data.datasets`` mixed config of the two; the CLI's
    checkpoint localizes one query of each scene through
    ``benchmark_nerfmatch``'s per-scene loop (``--iters 2``) -> dict."""
    import copy
    import os

    from nerfmatch_tpu_torch.cli.benchmark_nerfmatch import main as bench_cli
    from nerfmatch_tpu_torch.cli.train_nerfmatch import main as train_cli
    from nerfmatch_tpu_torch.config import dict2namespace, save_config
    from nerfmatch_tpu_torch.data.loaders import (_collate, init_data_loader,
                                                  init_multiscene_dataset)
    from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import (
        C2F_KEYS, C2FTrainStep, build_matcher, init_config_odir, to_device)
    from nerfmatch_tpu_torch.utils.optim import (config_adaptive_lr,
                                                 init_optimizer,
                                                 trainable_parameters)

    t0 = time.perf_counter()
    write_room_scene(renderer, dev, root, 24, size, name="room_b", offset=0.5)
    NerfEvaluator(match_scene_config(nerf_cfg, root, "room_b", size),
                  renderer).cache_scene_pts(
        cache_dir=root / "inter_layer3" / "room_b")
    os.symlink(root / "room", root / "room_a", target_is_directory=True)
    os.symlink(root / "inter_layer3" / "room",
               root / "inter_layer3" / "room_a", target_is_directory=True)
    log(f"8c second scene room_b (24 frames at other poses) and its scene "
        f"points in {time.perf_counter() - t0:.1f} s")

    cfg = config("nerfmatch_7scenes_sfm_c2f.yaml")
    for key, value in (
            ("data.scenes", ["room_a", "room_b"]),
            ("data.scene_dir", str(root / "inter_layer3" / "#scene" /
                                   "ds8lin")),
            ("exp.max_epochs", 1), ("exp.resume_version", "multiscene")):
        sec, attr = key.split(".")
        log(f"  multi-scene cut: {key}: "
            f"{getattr(getattr(cfg, sec), attr, None)!r} -> {value!r}")
        setattr(getattr(cfg, sec), attr, value)
    save_config(root / "multiscene.yaml", cfg)
    argv = ["--config", str(root / "multiscene.yaml"), "--stage", "c2f",
            "--debug"]
    t0 = time.perf_counter()
    out_cfg, m1 = train_cli(argv)
    t1 = time.perf_counter()
    w1 = {k: v.detach().clone() for k, v in m1.state_dict().items()}
    _, m2 = train_cli(argv)
    assert all(torch.equal(v, w1[k]) for k, v in m2.state_dict().items()), \
        "multi-scene resume changed the weights"
    ckpt = latest_checkpoint(init_config_odir(out_cfg, False) / "checkpoints",
                             name="last")
    assert ckpt is not None and ckpt.name == "last_1", ckpt
    log(f"cli train_nerfmatch --stage c2f --debug over room_a + room_b: 1 "
        f"epoch of 5 steps of batch {cfg.exp.batch_size} + 2 val batches in "
        f"{t1 - t0:.1f} s, resumed in {time.perf_counter() - t1:.1f} s "
        f"({ckpt.name})")
    del m1, m2, w1

    ds = init_multiscene_dataset(cfg.data, split="train")
    half = int(ds.offsets[1])
    assert len(ds.datasets) == 2 and len(ds) > half > 0
    data = [to_device(_collate([ds[i], ds[half + i]]), C2F_KEYS, dev)
            for i in range(4)]
    assert not torch.equal(data[0]["pt3d"][0], data[0]["pt3d"][1])
    model = build_matcher(cfg, False, torch.Generator().manual_seed(seed)).to(dev)
    opt = init_optimizer(cfg.optim, trainable_parameters(model),
                         lr=config_adaptive_lr(cfg)[0])
    step = C2FTrainStep(model, opt,
                        generator=torch.Generator(dev).manual_seed(seed))
    for i in range(2):
        step.step(data[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    hist = [step.step(data[i % 4]) for i in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: LAUNCHES[k] / steps for k in MATCH_KERNELS}
    loss = [float(m["loss"]) for m in hist]
    log(f"8c multi-scene training: {ms:.1f} ms/step over {steps} "
        f"C2FTrainStep steps of batch 2 (one sample of each scene), peak "
        f"{peak:.2f} GiB, loss {[round(x, 4) for x in loss]}; launches a "
        f"step {json.dumps(per_step)} (phase 6: "
        f"{json.dumps(phase6_per_step)})")
    assert np.isfinite(loss).all(), loss
    assert per_step == phase6_per_step, (per_step, phase6_per_step)

    mixed = copy.deepcopy(cfg)
    del mixed.data.scenes
    mixed.data.datasets = dict2namespace({"a": {"scenes": ["room_a"]},
                                          "b": {"scenes": ["room_b"]}})
    loader = init_data_loader(mixed.data, 2, split="train")
    it = iter(loader)
    mloss = [float(step.step(to_device(next(it), C2F_KEYS, dev))["loss"])
             for _ in range(2)]
    log(f"8c mixed config (data.datasets a: [room_a], b: [room_b]; "
        f"{len(loader.dataset)} pairs): 2 steps, loss "
        f"{[round(x, 4) for x in mloss]}")
    assert np.isfinite(mloss).all(), mloss
    del model, opt, step, data
    torch.cuda.empty_cache()

    frames = sorted(json.loads((root / "room" / "transforms_test.json")
                               .read_text())["frames"],
                    key=lambda f: f["file_path"])
    # Two queries a scene: the evaluator squeezes its per-query arrays, so a
    # scene of one query would give 0-d arrays (as in the JAX evaluator).
    one = root / "pairs_two.txt"
    one.write_text("".join(f"{frames[i]['file_path']} "
                           f"{frames[i + 1]['file_path']}\n" for i in (3, 9)))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    (avg, per_scene), = bench_cli([
        "--ckpts", str(ckpt), "--nerf_path", str(nerf_ckpt), "--iters", "2",
        "--mutual", "--rthres", "10", "--test_pair_txt", str(one),
        "--cache_tag", "multiscene"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bench = {k: v for k, v in LAUNCHES.items() if v}
    log(f"8c benchmark_nerfmatch --iters 2 on the multi-scene checkpoint, "
        f"two queries a scene: {len(per_scene)} scenes in {wall:.1f} s, per "
        f"scene " + json.dumps([{k: round(float(m[k]), 3) for k in
                                 ("t_med", "r_med", "recall")}
                                for m in per_scene])
        + f"; launches {json.dumps(bench)}")
    assert len(per_scene) == 2, per_scene
    for k in ("render_coarse_int8", "render_fine", "resample", "attention",
              "dw_star_fwd"):
        assert bench.get(k, 0) > 0, (k, bench)
    return dict(ms_per_step=ms, peak_gib=peak, per_step=per_step,
                steps=steps, bench=bench)


# Phase 9: data-parallel training and sharded evaluation.  Each pair of
# 9b's worker ranks is killed and the phase fails past this many seconds.
PHASE9_RANK_TIMEOUT_S = 600
# 9b: SGD (Adam's per-element normalization turns a reduction-order
# difference in a near-zero gradient into a whole step of the learning rate).
PHASE9_NERF_LR, PHASE9_C2F_LR = 0.1, 1.0
# 9b's limits on the ranks against one process: the loss's relative gap and
# the cosine of the parameter update (measured on an H100: gaps <= 1.2e-6,
# cosines >= 0.9999998).  The per-rank-normalized c2f step (a plain DDP
# step's mean of the ranks' means) runs as a control and must fail them.
PHASE9_LOSS_RTOL, PHASE9_UPDATE_COS = 1e-5, 0.99999


def dp_nerf_steps(inp, dev, rows):
    """Phase 9b's NeRF: a full-width ``NerfTrainer`` (seeded) takes one step
    on ``rows`` of each of ``inp``'s global batches (this process's data-
    parallel group, if any) -> losses, final weights (on the host), ms a
    step of the steps after the first, peak memory."""
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    trainer = NerfTrainer(inp["nerf_cfg"], device=dev, seed=inp["seed"])
    gen = torch.Generator(dev).manual_seed(inp["seed"])
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for rays, rgbs in inp["nerf_batches"]:
        rays, rgbs = rays[rows].to(dev), rgbs[rows].to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(rays, rgbs, gen)["loss"]))
        secs.append(time.perf_counter() - t0)
    return dict(losses=losses, ms=float(np.mean(secs[1:])) * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                state={k: v.cpu() for k, v in
                       trainer.renderer.state_dict().items()})


def dp_c2f_steps(inp, dev, rows, keep_state=True, per_rank=False):
    """Phase 9b's matcher: the production c2f matcher (seeded) takes
    ``C2FTrainStep`` steps on ``rows`` of ``inp``'s batch of 2 pairs with
    SGD (the group of this process, if any) -> losses, final weights,
    ms a step after the first, peak memory.  ``per_rank``: the control,
    every loss divided by this rank's counts, as a plain DDP step divides
    (the gradient sum over the ranks is then the mean of their means)."""
    from unittest import mock

    from nerfmatch_tpu_torch.parallel.distributed import DataGroup
    from nerfmatch_tpu_torch.utils import metrics
    from nerfmatch_tpu_torch.train.matcher_trainer import (C2FTrainStep,
                                                           build_matcher)
    from nerfmatch_tpu_torch.utils.optim import trainable_parameters

    model = build_matcher(inp["c2f_cfg"], False,
                          torch.Generator().manual_seed(inp["seed"])).to(dev)
    opt = torch.optim.SGD(trainable_parameters(model), lr=PHASE9_C2F_LR)
    step = C2FTrainStep(model, opt, generator=torch.Generator(dev).manual_seed(
        inp["seed"]), group=DataGroup.current())
    batch = {k: v[rows].to(dev) for k, v in inp["c2f_batch"].items()}
    local_counts = mock.patch.object(
        metrics, "_global_count",
        lambda count, group=None: count if group is None
        else count * group.world)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(inp["c2f_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with local_counts if per_rank else contextlib.nullcontext():
            losses.append(float(step.step(batch)["loss"]))
        secs.append(time.perf_counter() - t0)
    return dict(losses=losses, ms=float(np.mean(secs[1:])) * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                state={k: v.detach().cpu() for k, v in
                       model.state_dict().items()} if keep_state else None)


def phase9_rank(rank, world, backend, port, work):
    """One rank of phase 9b (``chip_smoke.py --phase9-rank R --phase9-world
    W --phase9-backend B --phase9-port P --phase9-dir D``): a group of W
    over backend B (gloo: every rank on cuda:0; nccl: rank R on cuda:R),
    the NeRF and c2f steps on this rank's block -> ``D/rank<R>.pt``."""
    import torch.distributed as dist

    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed)
    from nerfmatch_tpu_torch.utils import resolve_device

    gpu = rank if backend == "nccl" else 0
    dev = resolve_device(f"cuda:{gpu}")
    maybe_initialize_distributed(
        {"NERFMATCH_COORDINATOR": f"127.0.0.1:{port}",
         "NERFMATCH_NUM_PROCESSES": str(world),
         "NERFMATCH_PROCESS_ID": str(rank), "LOCAL_RANK": str(gpu)},
        device="cuda", backend=backend)
    assert dist.get_backend() == backend and dist.get_world_size() == world
    inp = torch.load(work / "inputs.pt", weights_only=False)
    n = len(inp["nerf_batches"][0][0]) // world
    out = {}
    for name, fn in (("nerf", lambda: dp_nerf_steps(
            inp, dev, slice(rank * n, (rank + 1) * n))),
                     ("c2f", lambda: dp_c2f_steps(
            inp, dev, slice(rank, rank + 1), keep_state=rank == 0)),
                     ("c2f_per_rank", lambda: dp_c2f_steps(
            inp, dev, slice(rank, rank + 1), keep_state=rank == 0,
            per_rank=True))):
        reset_launch_counts()
        out[name] = fn()
        out[name]["launches"] = {k: v for k, v in LAUNCHES.items() if v}
        if rank:
            out[name]["state"] = None
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def update_agreement(got, want, start):
    """(cosine, largest element gap over the largest update) of two
    trainings' parameter updates from ``start``, over every float tensor."""
    keys = [k for k in start if start[k].is_floating_point()]
    d_got = torch.cat([(got[k] - start[k]).double().reshape(-1) for k in keys])
    d_want = torch.cat([(want[k] - start[k]).double().reshape(-1)
                        for k in keys])
    cos = float(d_got @ d_want / (d_got.norm() * d_want.norm()))
    return cos, float((d_got - d_want).abs().max() / d_want.abs().max())


def phase9_nccl_cli(renderer, dev, seed, root):
    """9a: ``train_nerf`` under the JAX package's launch contract at world
    size 1 (an NCCL group), 10 steps of 9216 rays at full width on the room
    scene; one step with the group against the same step without one, on
    the same batch and generator -> the kernels' launches in the CLI."""
    import os

    import torch.distributed as dist

    from nerfmatch_tpu_torch.cli.train_nerf import main as train_cli
    from nerfmatch_tpu_torch.config import load_yaml_config, save_config
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    write_room_scene(renderer, dev, root)
    cfg, _ = load_yaml_config(ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    cfg.data.data_dir = str(root)
    cfg.data.scene = "room"
    cfg.data.scene_anno_path = str(root / "#scene" / "transforms_#split.json")
    cfg.exp.odir = str(root / "out")
    save_config(root / "cfg.yaml", cfg)
    ds = init_data_loader(cfg.data, cfg.exp.batch_size, split="train").dataset
    b = next(ds.ray_batches(cfg.exp.batch_size, np.random.default_rng(seed)))
    rays, rgbs = (torch.as_tensor(b[k], device=dev) for k in ("rays", "rgbs"))

    def one_step():
        trainer = NerfTrainer(cfg, device=dev, seed=seed)
        m = trainer.train_step(rays, rgbs,
                               torch.Generator(dev).manual_seed(seed))
        return float(m["loss"]), trainer.renderer.state_dict()

    alone = one_step()
    env = {"NERFMATCH_COORDINATOR": f"127.0.0.1:{free_port()}",
           "NERFMATCH_NUM_PROCESSES": "1", "NERFMATCH_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        out_cfg, _ = train_cli(["--config", str(root / "cfg.yaml"), "--debug",
                                "--max_epochs", "1"])
        cli_s = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in TRAIN_KERNELS}
        backend, world = dist.get_backend(), dist.get_world_size()
        grouped = one_step()
    finally:
        for k in env:
            os.environ.pop(k)
        if dist.is_initialized():
            dist.destroy_process_group()
    equal = grouped[0] == alone[0] and all(
        torch.equal(grouped[1][k], v) for k, v in alone[1].items())
    log(f"phase 9a: train_nerf under NERFMATCH_* at world 1: backend "
        f"{backend}, gpu_num {out_cfg.gpu_num}, 10 steps of 9216 rays + "
        f"validation in {cli_s:.1f} s, launches {json.dumps(launches)}; one "
        f"step with the NCCL group vs without: loss {grouped[0]!r} vs "
        f"{alone[0]!r}, weights bit-identical: {equal}")
    assert (backend, world, out_cfg.gpu_num) == ("nccl", 1, 1), \
        (backend, world, out_cfg.gpu_num)
    assert equal, "a world-1 step with the group differs from one without"
    missing = [k for k, v in launches.items() if not v]
    assert not missing, f"9a launched no {missing}"
    return launches


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def c2f_dp_batch(cfg, seed, size=480, pairs=2):
    """A c2f training batch of ``pairs`` pairs at the production shapes
    (3600 image tokens, 3600 points) whose pairs hold 900, 300, 600, 150,
    900, ... GT matches."""
    g = torch.Generator().manual_seed(seed)
    M = N = (size // 8) ** 2
    ys, xs = torch.meshgrid(torch.arange(size // 8), torch.arange(size // 8),
                            indexing="ij")
    pt2d = torch.stack([xs, ys], -1).reshape(-1, 2).float() * 8 + 4
    conf_gt = torch.zeros(pairs, M, N)
    for b in range(pairs):
        n_pos = (900, 300, 600, 150)[b % 4]
        rows = torch.randperm(M, generator=g)[:n_pos]
        conf_gt[b, rows, torch.randperm(N, generator=g)[:n_pos]] = 1.0
    return {"image": torch.rand(pairs, size, size, 3, generator=g),
            "pt_feat": torch.randn(pairs, N, cfg.model.pt_dim, generator=g),
            "pt3d": torch.randn(pairs, N, 3, generator=g) * 0.3,
            "im_mask": torch.ones(pairs, M), "pt_mask": torch.ones(pairs, N),
            "conf_gt": conf_gt,
            "pt2d": pt2d.expand(pairs, M, 2).contiguous(),
            "pt2d_proj": torch.rand(pairs, N, 2, generator=g) * size}


def phase9_ranks(dev, seed, root, world=2, backend="gloo"):
    """9b: ``world`` ranks in subprocesses (gloo: all on cuda:0, as the
    smoke runs them; nccl: one a GPU, ``scripts/dp_nccl_probe.py``), held
    to this process's steps over the same global batches -> their launches
    and figures."""
    from nerfmatch_tpu_torch.config import load_yaml_config

    nerf_cfg, _ = load_yaml_config(
        ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    nerf_cfg.optim.optimizer, nerf_cfg.optim.lr = "sgd", PHASE9_NERF_LR
    c2f_cfg, _ = load_yaml_config(
        ROOT / "configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml")
    renderer = load_room_renderer(dev)
    batches = []
    for i in range(3):
        rays = camera_rays(room_c2w(0.7 + 0.9 * i), 96, dev)
        with torch.no_grad():
            rgbs = renderer.fused_predict(rays)["rgb_fine"].clamp(0, 1)
        batches.append((rays.cpu(), rgbs.cpu()))
    del renderer
    inp = {"seed": seed, "nerf_cfg": nerf_cfg, "nerf_batches": batches,
           "c2f_cfg": c2f_cfg,
           "c2f_batch": c2f_dp_batch(c2f_cfg, seed, pairs=world),
           "c2f_steps": 2}
    every = slice(None)
    one = {"nerf": dp_nerf_steps(inp, dev, every)}
    torch.cuda.empty_cache()
    one["c2f"] = dp_c2f_steps(inp, dev, every)
    torch.cuda.empty_cache()
    torch.save(inp, root / "inputs.pt")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--phase9-rank",
         str(r), "--phase9-world", str(world), "--phase9-backend", backend,
         "--phase9-port", str(port), "--phase9-dir", str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    t0 = time.perf_counter()
    deadline = t0 + PHASE9_RANK_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise SystemExit(f"phase 9b: ranks passed {PHASE9_RANK_TIMEOUT_S} s")
    ranks_s = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise SystemExit("phase 9b: a rank failed:\n" + "\n".join(
            f"--- rank {r} ---\n{log_[-3000:]}" for r, log_ in
            enumerate(logs)))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    start = {"nerf": None, "c2f": None}
    from nerfmatch_tpu_torch.train.matcher_trainer import build_matcher
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer

    r0 = NerfRenderer(nerf_cfg)
    r0.init_params(torch.Generator().manual_seed(seed))
    start["nerf"] = r0.state_dict()
    start["c2f"] = build_matcher(c2f_cfg, False, torch.Generator().manual_seed(
        seed)).state_dict()
    res = {}

    def agreement(a, b, start):
        cos, gap = update_agreement(a["state"], b["state"], start)
        loss_gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                           b["losses"]))
        held = loss_gap < PHASE9_LOSS_RTOL and cos > PHASE9_UPDATE_COS
        return cos, gap, loss_gap, held

    for name in ("nerf", "c2f"):
        a, b = ranks[0][name], one[name]
        cos, gap, loss_gap, held = agreement(a, b, start[name])
        res[name] = dict(
            update_cosine=cos, update_max_gap=gap, loss_rel_gap=loss_gap,
            losses_ranks=a["losses"], losses_one_process=b["losses"],
            ms_per_step_rank=[r[name]["ms"] for r in ranks],
            ms_per_step_one_process=b["ms"],
            peak_gib_rank=[r[name]["peak_gib"] for r in ranks],
            peak_gib_one_process=b["peak_gib"],
            launches_rank=[r[name]["launches"] for r in ranks])
        where = "cuda:0" if backend == "gloo" else f"{world} GPUs"
        log(f"phase 9b {name}: {world} {backend} ranks on {where} vs one "
            "process: " + json.dumps({k: v for k, v in res[name].items()
                                      if k != "launches_rank"}))
        assert all(r[name]["losses"] == ranks[0][name]["losses"]
                   for r in ranks)
        assert held, (name, loss_gap, cos)
    cos, gap, loss_gap, held = agreement(ranks[0]["c2f_per_rank"], one["c2f"],
                                         start["c2f"])
    res["c2f_per_rank_control"] = dict(update_cosine=cos, update_max_gap=gap,
                                       loss_rel_gap=loss_gap)
    log(f"phase 9b control: per-rank-normalized c2f ranks vs one process: "
        + json.dumps(res["c2f_per_rank_control"]) + " (must fail the limits "
        f"loss < {PHASE9_LOSS_RTOL}, cosine > {PHASE9_UPDATE_COS})")
    assert not held, ("the per-rank-normalized control passed 9b's limits",
                      loss_gap, cos)
    log(f"phase 9b: the {world} ranks (start, import, steps) in "
        f"{ranks_s:.1f} s" + ("; their gradient all-reduce runs over gloo "
                              "through the host: these times say nothing of "
                              "NCCL on a multi-GPU host"
                              if backend == "gloo" else ""))
    res["ranks_s"] = ranks_s
    return res


def phase9_sharded_eval(renderer, nerf_cfg, dev, seed, size=480,
                        devices=None):
    """9c: sharded evaluation on a mesh of ``devices`` (default: ``dev``
    twice) against the dense paths on ``dev`` -> figures and the kernels'
    launches."""
    import copy
    import dataclasses

    from nerfmatch_tpu_torch.config import load_yaml_config
    from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
    from nerfmatch_tpu_torch.nerf.renderer import serving_int8_mode
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.parallel.mesh import make_mesh
    from nerfmatch_tpu_torch.parallel.point_sharding import sharded_point_match
    from nerfmatch_tpu_torch.parallel.render_sharding import \
        make_sharded_render

    cfg, _ = load_yaml_config(
        ROOT / "configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml")
    model = NeRFMatchEvaluator(
        cfg, device=dev, generator=torch.Generator().manual_seed(seed)).model
    mesh = make_mesh(devices=devices or [dev, dev])
    where = "[" + ", ".join(map(str, mesh.devices)) + "]"
    g = torch.Generator().manual_seed(seed + 1)
    M, N = (size // 8) ** 2, MERGED_S
    img = torch.rand(1, size, size, 3, generator=g).to(dev)
    feat = torch.randn(1, N, cfg.model.pt_dim, generator=g).to(dev)
    pts = (torch.randn(1, N, 3, generator=g) * 0.3).to(dev)
    pt_mask = (torch.rand(1, N, generator=g) > 0.05).float().to(dev)
    kw = dict(pt_mask=pt_mask, mutual=True, top_k=2048)
    res = {}

    def held(got, want, tag):
        v = want["valid"]
        same_valid = torch.equal(got["valid"], v)
        same_j = torch.equal(got["j_ids"][v], want["j_ids"][v])
        conf = float((got["mconf"] - want["mconf"]).abs().max())
        row = dict(valid=int(v.sum()), same_valid=same_valid, same_j=same_j,
                   mconf_err=conf)
        if "expec_f" in got and "expec_f" in want:
            e = got["expec_f"].reshape(*v.shape, 3)[v] \
                - want["expec_f"].reshape(*v.shape, 3)[v]
            row["expec_f_err"] = float(e.abs().max()) if e.numel() else 0.0
        res[tag] = row
        assert same_valid and same_j and conf <= 1e-6 and \
            row.get("expec_f_err", 0.0) <= 1e-5, (tag, row)

    def sync():
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)

    def timed(fn, warm=True):
        """fn's output and its ms on the host clock, every mesh device
        synchronized; after one call untimed (model copies, first
        launches on a card) unless ``warm`` is False."""
        if warm:
            fn()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    reset_launch_counts()
    with torch.no_grad():
        dense, dense_ms = timed(lambda: model.eval_match(img, feat, pts, **kw))
        im_cfeat, pt_cfeat, _ = model._point_sharded_feats(img, feat, pts)
        spm = sharded_point_match(mesh, im_cfeat, pt_cfeat, model.temperature,
                                  pt_mask=pt_mask, temp_type=model.cfg.temp_type,
                                  mutual=True)
        held(spm, dense, "sharded_point_match")
        ps, ps_ms = timed(lambda: model.eval_match_point_sharded(
            mesh, img, feat, pts, **kw))
        held(ps, dense, "eval_match_point_sharded")
        res["ms"] = {"dense": dense_ms, "point_sharded": ps_ms}
        for K in (4, 3):
            kfeat = feat[:, :K * M].reshape(1, K, M, -1)
            kpts = pts[:, :K * M].reshape(1, K, M, 3)
            kmask = pt_mask[:, :K * M].reshape(1, K, M)
            kkw = dict(kw, pt_mask=kmask)
            serial, s_ms = timed(lambda: model.eval_match(img, kfeat, kpts,
                                                          **kkw))
            shard, p_ms = timed(lambda: model.eval_match(
                img, kfeat, kpts, pair_mesh=mesh, **kkw))
            for k in range(K):
                held({n: shard[n][k] for n in ("j_ids", "mconf", "valid",
                                               "expec_f")},
                     {n: serial[n][k] for n in ("j_ids", "mconf", "valid",
                                                "expec_f")},
                     f"pair_sharded K={K} pair {k}")
            res["ms"][f"pairs_serial K={K}"] = s_ms
            res["ms"][f"pair_sharded K={K}"] = p_ms
    match_launches = {k: v for k, v in LAUNCHES.items() if v}

    serving = copy.deepcopy(renderer)
    serving.cfg = dataclasses.replace(serving.cfg,
                                      trunk_int8=serving_int8_mode(nerf_cfg))
    serving.act_scales = None
    rays = camera_rays(room_c2w(1.1), 96, dev)
    reset_launch_counts()
    with torch.no_grad():
        render = make_sharded_render(mesh, serving)
        got = render(rays)      # calibrates the int8 scales of both
        want = serving.fused_predict(rays)
        render_launches = {k: v for k, v in LAUNCHES.items() if v}
        ms = {"sharded": [], "fused_predict": []}
        for name in ("sharded", "fused_predict", "fused_predict", "sharded"):
            fn = (lambda: render(rays)) if name == "sharded" \
                else (lambda: serving.fused_predict(rays))
            ms[name].append(timed(fn, warm=False)[1])
    bits = {k: bool(torch.equal(got[k], want[k])) for k in want}
    res["render"] = dict(bit_identical=bits, trunk_int8=serving.cfg.trunk_int8,
                         **{f"{k}_ms": v for k, v in ms.items()})
    log(f"phase 9c: sharded evaluation on {where}: " + json.dumps(res)
        + f"; launches: matching {json.dumps(match_launches)}, render "
        f"{json.dumps(render_launches)}")
    assert all(bits.values()), bits
    launches = {k: match_launches.get(k, 0) + render_launches.get(k, 0)
                for k in set(match_launches) | set(render_launches)}
    return res, launches


def phase_parallel(renderer, nerf_cfg, dev, seed):
    """Phase 9 -> launches by kernel and sub-phase (its figures are in the
    log)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "9a").mkdir()
        (root / "9b").mkdir()
        cli = phase9_nccl_cli(renderer, dev, seed, root / "9a")
        torch.cuda.empty_cache()
        two = phase9_ranks(dev, seed, root / "9b")
        torch.cuda.empty_cache()
        _, eval_launches = phase9_sharded_eval(renderer, nerf_cfg, dev,
                                               seed)
    by_kernel = {}
    for k, v in cli.items():
        by_kernel.setdefault(k, {})["9a_cli_10_steps"] = v
    for name in ("nerf", "c2f"):
        for r, counts in enumerate(two[name]["launches_rank"]):
            for k, v in counts.items():
                by_kernel.setdefault(k, {})[f"9b_{name}_rank{r}"] = v
    for k, v in eval_launches.items():
        by_kernel.setdefault(k, {})["9c_sharded_eval"] = v
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return by_kernel


# Phase 10: the e2e pipeline's budget (a few NeRF and matcher epochs), the
# matcher trunk (the e2e config's 'tiny' trunk is too narrow for kernels
# 7-9's gate, C % 128 == 0) and the serving mode (the config pins 'none';
# the serving default 'coarse' runs kernel 1b).
E2E_NERF_EPOCHS, E2E_MATCH_EPOCHS = 4, 3
E2E_BACKBONE, E2E_TRUNK_INT8 = "convformer", "coarse"
E2E_KERNELS = ("render_fine", "render_coarse_int8", "resample", "attention",
               "attention_bwd", "render_train_fwd", "render_train_bwd",
               "dw_star_fwd", "dw_star_dgrad", "dw_star_wgrad")


def e2e_attention_row(dev, B=2, L=256, S=256, H=8, D=8):
    """The e2e matcher's attention (64-wide coarse features: 8 heads of 8,
    L = S = 256 at 128x128 and ds 8), which runs the kernels' 16-wide
    instantiation on columns that are zero only on the card: the bf16
    forward against the one-pass plain version (max 1e-3, mean 1e-5) and
    the backward through autograd against the plain backward (1e-2 of each
    gradient's largest value, cosine > 0.999), one launch a pass; the
    forward timed through the wrapper (``ms``) and its C entry alone
    (``kernel_ms``: the cast launch and the kernel, as the matcher calls
    it; ``kernel_bf16_ms``: the kernel alone on bf16 operands), beside the
    plain version, SDPA and the bound; the backward (``out`` and ``lse``
    handed in, as autograd calls it) beside its plain version, SDPA's
    backward and its bound."""
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES
    from nerfmatch_tpu_torch.ops.kernels import attention_kernel as ak
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_bwd, attention_bwd_plain, attention_onepass_plain,
        fused_attention, kernel_head_dim)

    g = torch.Generator(dev).manual_seed(10)
    q, k, v, up = (torch.randn(B, L, H, D, device=dev, generator=g) * s
                   for s in (0.3, 1.0, 1.0, 1.0))
    with torch.no_grad():
        n0 = LAUNCHES["attention"]
        out = fused_attention(q, k, v, True)
        fwd_launches = LAUNCHES["attention"] - n0
        one, _ = attention_onepass_plain(q, k, v, True)
        err = (out - one).abs()
        ms = cuda_ms(lambda: fused_attention(q, k, v, True))
        kernel_ms = attention_fwd_alone_ms(q, k, v)
        kernel_bf16_ms = attention_fwd_alone_ms(q, k, v, cast=False)
        plain_ms = cuda_ms(lambda: attention_onepass_plain(q, k, v, True))
        lib_ms, lib_err = sdpa_forward(q, k, v, one)
    assert float(err.max()) < 1e-3 and float(err.mean()) < 1e-5, err.max()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0, n1 = LAUNCHES["attention"], LAUNCHES["attention_bwd"]
    (fused_attention(*leaves, True) * up).sum().backward()
    launches = dict(forward=fwd_launches,
                    autograd_forward=LAUNCHES["attention"] - n0,
                    autograd_backward=LAUNCHES["attention_bwd"] - n1)
    assert set(launches.values()) == {1}, launches
    with torch.no_grad():
        ref = attention_bwd_plain(q, k, v, up, True)
        out2, lse, ops = ak._forward_kernel(q, k, v, True, True)
        bwd_ms = cuda_ms(lambda: attention_bwd(*ops, up, True, out=out2,
                                               lse=lse))
        bwd_plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, up, True))
    bwd_lib_ms = sdpa_backward(q, k, v, up)
    grads = {}
    for name, leaf, r in zip("qkv", leaves, ref):
        cos = float((leaf.grad * r).sum()) / float(leaf.grad.norm() * r.norm())
        grads[f"d{name}"] = dict(scaled_err=scaled_err(leaf.grad, r), cos=cos)
        assert grads[f"d{name}"]["scaled_err"] < 1e-2 and cos > 0.999, grads
    backward = dict(grads, ms=bwd_ms, plain_ms=bwd_plain_ms,
                    library_ms=bwd_lib_ms,
                    **bound({"bf16": 10 * B * H * L * S * D},
                            nbytes(q, k, v, up, *(x.grad for x in leaves))))
    row = dict(B=B, L=L, S=S, H=H, D=D, padded_to=kernel_head_dim(D),
               launches=launches, max_abs_err=float(err.max()),
               mean_abs_err=float(err.mean()), ms=ms, kernel_ms=kernel_ms,
               kernel_bf16_ms=kernel_bf16_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_max_diff=lib_err, backward=backward,
               **bound({"bf16": 2 * 2 * B * H * L * S * D},
                       nbytes(q, k, v, out)))
    log(f"phase 10 attention at head_dim {D} (the kD "
        f"{kernel_head_dim(D)} instantiation): {json.dumps(row)}")
    return row


def phase_e2e(dev, seed):
    """Phase 10: ``e2e.pipeline.run`` on the enclosed synthetic scene at a
    short budget, to the end on the card (NeRF training, its held-out PSNR,
    the scene-point cache at the serving default, Mini, Full warm-started
    from Mini's ``best``, localization of the 12 query pairs under single,
    c2f-fine, iters2 and iters2+inerf); the medians must be finite, Full's
    warm start Mini's ``best`` checkpoint, and kernels 1, 1b, 2, 3, 4, 5,
    6, 7, 8 and 9 launched; then the attention at the e2e matcher's head
    width against its plain version -> (launches by kernel, summary,
    attention row)."""
    import tempfile

    from nerfmatch_tpu_torch.e2e import pipeline
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts

    torch.manual_seed(seed)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        summary = pipeline.run(Path(tmp), enclosed=True,
                               nerf_epochs=E2E_NERF_EPOCHS,
                               match_epochs=E2E_MATCH_EPOCHS, device=dev,
                               backbone=E2E_BACKBONE,
                               trunk_int8=E2E_TRUNK_INT8,
                               frustum_depth=pipeline.ENCLOSED_FRUSTUM_DEPTH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
    summary["phase_seconds"] = seconds
    log("phase 10 summary: " + json.dumps(summary))
    log(f"phase 10 launches: {json.dumps(launches)}")
    for name, p in summary["protocols"].items():
        assert np.isfinite(p["r_med"]) and np.isfinite(p["t_med"]), (name, p)
    warm = summary["warm_start"]
    assert "/out_match/" in warm["ckpt"] and \
        Path(warm["ckpt"]).name.startswith("best_") and warm["tensors"] > 0, \
        warm
    missing = [k for k in E2E_KERNELS if not launches.get(k)]
    assert not missing, missing
    row = e2e_attention_row(dev)
    log(f"phase 10: {seconds:.1f} s (the pipeline)")
    return launches, summary, row


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    # Phase 9b's ranks: this script started again by itself.
    p.add_argument("--phase9-rank", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--phase9-world", type=int, default=2,
                   help=argparse.SUPPRESS)
    p.add_argument("--phase9-backend", default="gloo", help=argparse.SUPPRESS)
    p.add_argument("--phase9-port", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--phase9-dir", type=Path, default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.phase9_rank is not None:
        phase9_rank(args.phase9_rank, args.phase9_world, args.phase9_backend,
                    args.phase9_port, args.phase9_dir)
        return

    smi = phase_environment()
    import copy
    import dataclasses
    import tempfile

    from nerfmatch_tpu_torch.config import load_yaml_config
    from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
    from nerfmatch_tpu_torch.nerf.renderer import serving_int8_mode

    phase_build()
    dev = torch.device("cuda", 0)
    renderer = load_room_renderer(dev)
    nerf_cfg, _ = load_yaml_config(ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    log(f"renderer: trunk_int8={renderer.cfg.trunk_int8} "
        f"early_term_eps={renderer.cfg.early_term_eps} feat_layer=3")
    with torch.no_grad():
        rows = phase_kernels(renderer, dev)
        rows.update(phase_int8_kernels(renderer, dev))
    rows.update(phase_train_kernels(renderer, dev))
    rows.update(phase_train_app_kernels(renderer, dev))
    for name, by_hid in train_width_rows(dev).items():
        key = "wide_encoding" if name.endswith("_app") else "widths"
        rows[name][key] = by_hid.get(key, by_hid)
    torch.cuda.empty_cache()
    with torch.no_grad():
        rows.update(phase_matcher_kernels(dev))
    torch.cuda.empty_cache()

    match_cfg, _ = load_yaml_config(
        ROOT / "configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml")
    evaluator = NeRFMatchEvaluator(
        match_cfg, device=dev,
        generator=torch.Generator().manual_seed(args.seed))
    log(f"matcher: {evaluator.model.cfg}")
    # The serving renderer: the same weights, its int8 mode resolved as the
    # scene-point cache and the localize-time re-render resolve it.
    serving = copy.deepcopy(renderer)
    serving.cfg = dataclasses.replace(serving.cfg,
                                      trunk_int8=serving_int8_mode(nerf_cfg))
    log(f"serving renderer: trunk_int8={serving.cfg.trunk_int8!r} "
        f"(render.trunk_int8 in the config: "
        f"{getattr(nerf_cfg.render, 'trunk_int8', None)!r})")
    with torch.no_grad():
        launches, results = phase_serving(serving, evaluator, dev)
        inerf = phase_inerf(serving, evaluator, nerf_cfg, dev)
        phase_check(evaluator, results[0][0])
    del serving, evaluator, results
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trained, ckpt5, cfg5 = phase_training(renderer, dev, args.seed,
                                              Path(tmp))
        hid128 = phase_hid128(dev, args.seed, Path(tmp))
        _, psnr_s, psnr_ms = phase_psnr(ckpt5, Path(tmp), dev)
        app_launches, psnr_app_s = phase_psnr_app(ckpt5, cfg5, Path(tmp), dev)
        app_trained = phase_training_app(renderer, dev, args.seed,
                                         Path(tmp))
        torch.cuda.empty_cache()
        variants = phase_nerf_variants(dev, args.seed, Path(tmp))
    log(f"PSNR phases: {psnr_s:.3f} s an image ({psnr_ms:.1f} ms of it the "
        f"render), appearance checkpoint {psnr_app_s:.3f} s an image")
    launches.update(app_launches)
    launches.update({k: trained[k]
                     for k in ("render_train_fwd", "render_train_bwd")})
    launches.update({k: app_trained[k] for k in ("render_train_fwd_app",
                                                 "render_train_bwd_app")})
    # The resample runs on both paths: phase 4's count is the line's,
    # phase 5's stands beside it.
    rows["resample"]["launches_training"] = trained["resample"]
    log(f"resample launches: serving {launches['resample']}, training "
        f"{trained['resample']}")
    # The new kernels' counts come from matcher training, where all four run.
    match, bench, multipair, multiscene = phase_matcher_training(
        renderer, nerf_cfg, dev, args.seed)
    launches.update({k: match[k] for k in MATCH_KERNELS if k != "attention"})
    assert bench["render_coarse_int8"] > 0
    # The feat_max stages: phase 7's --iters 2 on the ds8max cache, phase
    # 6's 'posttap' max cache; the merged layout's attention at S = 14,400.
    launches.update({k: bench[k] for k in ("render_fine_max",
                                           "render_fine_int8_max")})
    rows["attention"]["merged"]["launches_multipair"] = bench["attention_merged"]
    # Merged multi-pair training (phase 6): each shape's launches a step.
    for name in ("attention", "attention_bwd"):
        for L, S in MERGED_TRAIN_SHAPES:
            per_step = multipair["per_step"][f"{name} L={L} S={S}"]
            if name == "attention_bwd":
                row = next(r for r in rows[name]["merged"]
                           if (r["L"], r["S"]) == (L, S))
            else:
                row = rows[name].setdefault("merged_train", {})
                row = row.setdefault(f"L={L} S={S}", {})
            row["launches_train_per_step"] = per_step
    rows["attention_bwd"]["merged_train_step"] = {
        k: multipair[k] for k in ("ms_per_step", "peak_gib", "steps")}

    # Phase 8: 8a launched none of kernels 1, 1b, 2, 5, 6; 8b's scene-point
    # cache of the out_scr NeRF ran 1b, 2 and 1; 8c's steps 3, 4 and 7-9.
    for n in ("render_coarse_int8", "render_fine", "resample"):
        rows[n]["launches_phase8"] = {
            "8a_classic": 0, "8b_out_scr_cache": variants["8b"]["launches"][n]}
    for n in MATCH_KERNELS:
        rows[n]["launches_phase8"] = {
            "8c_multiscene_per_step": multiscene["per_step"][n],
            "8c_benchmark": multiscene["bench"].get(n, 0)}
    rows["attention_bwd"]["multiscene_train_step"] = {
        k: multiscene[k] for k in ("ms_per_step", "peak_gib", "steps")}
    log("phase 8: " + json.dumps({
        "8a": variants["8a"], "8b": {k: v for k, v in variants["8b"].items()
                                     if k != "launches"},
        "8c": {k: multiscene[k] for k in ("ms_per_step", "peak_gib")}}))

    torch.cuda.empty_cache()
    phase9_launches = phase_parallel(renderer, nerf_cfg, dev, args.seed)
    for n, counts in phase9_launches.items():
        if n in rows:
            rows[n]["launches_phase9"] = counts

    torch.cuda.empty_cache()
    e2e_launches, _, e2e_row = phase_e2e(dev, args.seed)
    for n in E2E_KERNELS:
        rows[n]["launches_phase10"] = e2e_launches[n]
    rows["attention"]["e2e_head_dim8"] = e2e_row

    # Phase 11's counts (the hid-128 NeRF) stand beside each kernel it ran.
    for n, c in hid128["launches"].items():
        rows[n]["launches_phase11"] = c
    rows["render_train_fwd"]["phase11_hid128"] = {
        k: v for k, v in hid128.items() if k != "launches"}

    # The iNeRF phase's counts stand beside each kernel it launched.
    for n, c in inerf["launches"].items():
        if c:
            rows[n]["launches_inerf"] = c
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=launches[n], **rows[n])
               for n, (src, rep) in KERNEL_SOURCES.items()]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
