#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (posecnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
nvcc. It drives the port's serving path and stops at the first phase
that fails, with a non-zero exit:

  1. the card's name and power limit; build the CUDA kernels, one nvcc a
     source started together (`csrc/hough_vote.cu`, the vote kernels;
     `csrc/nms_scan.cu`, the NMS scan; `csrc/kabsch.cu`, RANSAC's two
     pose kernels and the Kabsch rotation), and print `ptxas -v`'s registers,
     shared memory and spills per kernel, with the data-path library
     (`data/native.py`, g++) built beside them;
  2. each kernel against its plain PyTorch version, bit for bit, at the
     serve shapes, on samples packed from a planted 480×640 scene
     (K = 8 slots, S = 1024 samples), and all three at the edge cases
     of `vote_edge_case` (the exhaustive vote at stride 1, the
     coarse-to-fine pair as c2f runs them); each kernel's time from a CUDA
     graph of n launches replayed between two CUDA events (`ms`: no
     host work between the launches), the time per call of a Python
     loop of wrapper calls (`call_ms`: what the serving path pays), the
     plain version's time and the kernel's bound, with torch.profiler's
     per-kernel device time as a cross-check; the exhaustive kernel's
     time beside the coarse-to-fine pair's on the same samples; the NMS
     scan kernel (`nms_scan_kernel`, after its packing launch
     `pack_kill_kernel`) against its plain version bit for bit at every
     `scan_case` (the RPN's (1, 2000) suppression matrix at lov_det.yaml's
     shapes, test_net's (21, 128) per-class one, the serving forward's
     per-class ones at batch 1 and 4, (1, 16) and (1, 64), no valid row,
     every row killing the later ones, no kills, N = 1, 31, 32, 33, 64, 65,
     2048, 2049 and 4096 (the register and shared-memory masks), 64
     leading indices), one scan launch each counted by the wrapper and on
     the device, with `ms`, `call_ms`, each launch's device time
     (profiler), the plain version's time and its bound at (1, 2000), (21,
     128), (1, 16) and (1, 64);
  3. the planted scene through `hough_voting` on the card: the planted
     centres and depths are recovered;
  4. the whole model, small and in fp32, on the card against the CPU;
  5. the HTTP server at full width (22 classes, 480×640, num_units 64,
     fc_dim 4096, 1024 Hough samples, seeded random weights), its forward
     compiled (one CUDA graph per engine, `utils/graph.compile_static`),
     at engine batch 1 (5 requests) and 4 (8 requests from 4 clients
     through the MicroBatcher), its per-class NMS inside the graph: the
     captured forward records flat, window and the scan once, the requests
     replay it (no wrapper call) and the kernels count one flat, one window
     and one scan launch a forward on the device; on three frames in a row
     (random, planted, zeros) the graph's label, RoIs, poses and NMS keep
     mask equal the eager body's bit for bit; the planted frame's keep mask
     equals the host scan (`greedy_keep`) of its RoIs' suppression matrix;
     flat, window and tile bit for bit against their plain
     versions on the planted frame's Hough inputs (8 slots at batch 1, 32
     at batch 4, S = 1024); the forward's ms as the graph and eager (CUDA
     events); then 200 more requests: the median and p90
     request, the server's forward + fetch and the body's decode;
  6. the checks of `python -m posecnn_torch.cli.validate`, in process:
     c2f equals the exhaustive vote on a rendered 480×640 22-class
     scene, and every backend finds both of two same-class instances
     in multi-instance mode;
  7. the full-width forward with the exhaustive backend, and with
     multi-instance Hough on c2f: finite, with launch counts and times;
  8. the training path at full width: the r6 phase-B flagship config
     (`experiments/cfgs/lov_color_2d_pool_full.yaml`: 22 classes, 480×640,
     batch 8, fc_dim 4096, adam) on seeded random weights and the
     procedural class library, the pooled synthetic feed through the
     prefetcher, bf16 train steps through `cli/train_net.build_trainer`,
     whose step is compiled (`engine/train.CompiledTrainStep`, one CUDA
     graph replayed a step): 2 warm-up steps (the first the real step and
     the capture), then 6 timed steps of the compiled step and 6 of the
     same step eager with the feed's render threads running, then 6 of
     each on held batches with them stopped, the flat and window kernels
     launched once a step (counted on the device); the equality gate on
     the flagship (adam) and on `bench train`'s configuration (momentum):
     5 consecutive compiled steps from one state with live Hough slots (the
     seg head biased to one class) and a step of the lr staircase, each
     against eager steps from the same state, the metrics bit for bit,
     each gradient within the eager spread or `GRAD_TOL` of its largest
     entry, the optimizer run eagerly on the compiled step's gradients
     equal to its parameters and state bit for bit, a replay's dropout
     equal to fresh generators'; the loss and every gradient finite, the
     parameters moved, pose rows supervised; the flat, window and tile
     kernels bit for bit against their plain versions on the packed
     samples and window origins of a step's Hough (64 slots, 256 samples,
     vertex factor 8), on the model's inputs and on the GT's; the step's
     training Hough on c2f equal to the exhaustive backend's row for row
     on the GT inputs at the step's vertex factor; ms per step,
     images/s, peak memory, the forward / backward / optimizer / Hough
     split, the feed's production time and whether its queue ran dry, the
     device's busy share (profiler), and FLOPs per step
     (FlopCounterMode) with MFU;
  9. the evaluation path at full width (the flagship yaml, seeded random
     weights): `python -m posecnn_torch.cli.test_net --refine --ransac` in
     process on 8 held-out frames, compiled (the forward with its NMS one
     graph, one flat, window and scan launch a replay on the device, ICP
     one graph per object count, RANSAC's `estimate_center` one graph at
     (1024, 64), the evaluator's pose errors one graph per padded row
     count), with images/s and the seconds of render, forward (its NMS
     inside), extraction (RANSAC inside), ICP and the evaluator (a run
     without the recording), then again recorded (`compiled_run`): every
     compiled call (forward, ICP, RANSAC centre, pose errors) equal to its eager
     run bit for bit, none of RANSAC's and the evaluator's graphs
     launching a CUDA kernel, RANSAC's ms a detection compiled and eager,
     the pose-error program on random pairs with a z-flip class (padded
     rows == eager bit for bit, == the unpadded eager body within 1e-6
     relative), each
     forward's flat and window kernels bit for bit against their plain
     versions on its own packed samples and window origins; `test_icp`'s
     drive at 480×640 with and without the rotation sweep (TE must fall),
     compiled and held to eager, its scenes refined on the card and the
     CPU and held by the ICP tests' scene rule, `icp_refine_batch`'s
     device time a frame eager and compiled (equal bit for bit) and a
     profile of one frame each way (device events, device busy time,
     wall, the host's costliest ops); RANSAC centres of the
     planted scene within 1 px, card against CPU; the evaluator on the
     card against the CPU on the run's detections; `estimate_pose_3d` at
     (4096 points, 256 hypotheses) compiled == eager bit for bit, one
     `pose_hypotheses_kernel` and one `pose_refine_kernel` launch a replay
     counted on the device and nothing else, both timed, the pose against
     the truth and the CPU's, the kernels against the plain body (the same
     best hypothesis, R within 1e-4, t within 1e-5, the inliers equal);
     each pose kernel against its plain version (the SVD on the card) at
     (4096, 256) and at 65536 points: a fit's R within 1e-4 and t within
     1e-5 where its covariance's singular values stand apart, each score
     its own fit's fp64 count and plain's up to the points near the
     threshold; their ms as a graph of launches (the hypotheses' kernel at
     1, 2, 4 and 8 hypotheses a block), per call, the plain version's,
     and their bounds; `kabsch_kernel` (on no program path since) against
     its plain version at the program's covariances: R within 1e-4 where
     the singular values stand apart, trace(R·cov) within 1e-5
     everywhere; its ms as a graph of launches, per call, the plain
     version's and torch.linalg.svd's, and its bound;
 10. the real-frame family at full width: a YCB-Video tree written to a
     temporary directory in the reference's formats (22 classes, 8 train
     and 4 val frames at 480×640 rendered by the carried generator, PNG
     and .mat); 3 train steps through `cli/train_net.build_trainer` on
     each of these yamls, with the GT RoIs prepended (random weights emit
     no Hough RoI): `lov_rgbd_2d.yaml` (RGBD, chromatic, noise),
     `lov_color_2d_adapt.yaml` (the domain head) and
     `lov_color_2d_full.yaml` (the matching loss, real and synthetic
     streams 1:10, num_units 128), each step with finite losses, every
     term reported, flat and window launched once and held bit for bit
     to plain on the step's own Hough inputs and on its batch's GT
     inputs; c2f == exhaustive on an RGBD step; the gradient reversal
     exact on an adapt step; the matching term's device ms; each yaml's
     step compiled as train_net builds it (`CompiledTrainStep`: a graph
     per batch signature, captured and replayed) and held by the equality
     gate over 5 replays across a step of the lr staircase (metrics and
     the update bit for bit, each gradient within the eager spread or
     2e-2, one flat and one window launch a replay on the device), the
     yaml's loss terms among its metrics (`loss_match` for full); `--resume`
     restoring the RGBD snapshot as the JAX CLI resumes (its step, a fresh
     optimizer at count 0, `lr_step_offset` at the step, the device rate
     on the global step's staircase), the CLI training on from it (count
     1, one flat and one window launch); `test_net --dataset lov --refine` on the
     4 val frames with that snapshot and with seeded random weights
     (whose labels leave detections for ICP), finite summaries, each
     forward's kernels bit for bit to plain. Per config: ms a step split into feed
     wait, forward, backward and optimizer (CUDA events), images/s and
     peak memory;
 11. the detection family and the demo at full width: `lov_det.yaml` as
     written (22 classes, 480×640, batch 1, 20 anchors a cell, 2000 boxes
     into the RPN's NMS, 128 proposals and sampled RoIs, fc_dim 4096, SGD
     momentum, bf16) through `cli/train_net.build_trainer`, whose step is
     compiled (`engine/train.CompiledDetTrainStep`, one CUDA graph with the
     RPN's NMS on the scan kernel): 4 eager steps, each split into forward
     / backward / optimizer (CUDA events), FLOPs a step (FlopCounterMode on
     the eager step); then the compiled step's capture and 4 replays (CUDA
     events; images/s and MFU on their time), the scan launched once a
     replay and the vote kernels never (counted on the device, every count
     set to 0 just before), every loss term finite, peak memory; the
     equality gate (phase 8's, with the detection step's launches) over 5
     consecutive replays across a step of the lr staircase; the RPN's
     `proposal_layer` and its NMS timed alone, the device scan against the
     host scan, and the kernel == plain bit for bit on that real (1, 2000)
     matrix; a small fp32 PoseCNNDet on the card against the CPU with the
     same target noise; `test_net` on the snapshot of those steps (8
     held-out renders), its `det_infer` (one graph, the scan twice a
     replay: the RPN's NMS and the per-class one) and `det_pose` (one graph per padded detection
     count) compiled: recorded (`compiled_run`: every compiled call equal to
     its eager run bit for bit), timed, and with its programs eager, whose
     `eval_det.json` must equal the compiled run's (images/s of both, stage
     seconds, mAP, the graphs); `python -m posecnn_torch.cli.demo --refine` on 5
     rendered 480×640 frames in the demo's format with the flagship yaml's
     widths, compiled (its forward and ICP), every compiled call equal to
     its eager run bit for bit, flat, window and the scan launched once a
     replayed forward, flat and window bit for bit equal to plain on each
     forward's inputs.

 12. the segmentation and video families and fusion at full width, with
     seeded random weights: 4 train steps each of
     `rgbd_scene_single_color_fcn8.yaml` as written (FCN8, 10 classes,
     480×640, batch 2, fc_dim 4096, bf16) and of the same yaml with
     `network=resnet50_seg` (num_units 64) through
     `cli/train_net.build_trainer`, split into forward / backward /
     optimizer (CUDA events), every loss and gradient finite, peak memory,
     FLOPs a step (FlopCounterMode) and MFU, then the same step compiled
     as train_net runs it (`compiled_family`: its capture, 4 replays timed
     with CUDA events, one graph, no CUDA kernel launched on the device,
     peak memory; the equality gate over 5 replays across a step of the lr
     staircase); small fp32 FCN8, ResNet50Seg and RecurrentSegNet on the
     card against the CPU (log-probs within 1e-4); 4 steps of
     `lov_color_rnn.yaml` as written (RecurrentSegNet, 22 classes, T = 5,
     batch 1, 480×640, num_units 64, fp32) with the same split and the same
     compiled step and gate, `compute_flow`'s ms a frame and peak memory,
     then 2 steps on a fabricated YCB-Video tree with a moving camera (the
     real-video feed); `test_video` on the video snapshot (3 sequences of 5
     frames, TSDF grid `test.grid_size` 256), its forward compiled (one
     graph, every call held to its eager body bit for bit, no launch on the
     device) and again eager: the seconds of render, forward, fuse, track
     and extract, the forward's seconds each way, IoU, surface points, and
     `video_eval.json` equal between the two but for the seconds, its
     `fuse_frame` (the volume bound in place) and `track_camera` compiled
     too, every call held to its eager body; `test_fusion` at its grid 64
     with its four programs compiled (`fuse_frame`, `raycast`,
     `track_camera`, `extract_mesh`: every call held to its eager body bit
     for bit, no launch on the device) and eager, the two reports equal;
     `fuse_frame`, `raycast` and `track_camera` at grid 512 with 10 classes
     on a 480×640 frame, compiled against eager on a twin volume (bit for
     bit, ms a frame each way, peak memory), a call with another volume
     refused. No vote kernel launches in the phase.
 13. the head switches and the GAN step at full width, with seeded random
     weights: 4 steps of `shapenet_single_single_color_gan.yaml` as written
     (2 classes, 480×640, batch 4, num_units 64, seg + vertex, vertex_w 10,
     lr 2e-4) through `cli/train_net.build_trainer`, each split into the
     generator's forward / backward / optimizer and the discriminator's
     step (CUDA events), every loss and gradient finite
     (`utils/debug.finite_check`), peak memory, FLOPs a step; the step
     compiled as train_net runs it (both updates in one graph: 4 replays
     timed, no launch on the device, the equality gate over 5 replays with
     the discriminator and its Adam kept, restored and re-run); one small
     fp64 GAN step on the card against the CPU; 3 steps each of
     `lov_color_3d.yaml` on a fabricated YCB-Video tree (22 classes, batch
     2, real and synthetic 1:3), `linemod_ape_3d.yaml` on a fabricated
     LINEMOD tree (720×960) and `rgbd_scene_single_depth.yaml` (seg only,
     DEPTH, 10 classes; the posecnn trainer renders the procedural library
     for it, as the JAX one does), each step's terms exactly the yaml's,
     with no vote kernel launched; `test_net --dataset lov --save_results`
     on the lov_color_3d snapshot (every head built, the pose head kept at
     its seeded values and named), flat and window launched once a forward
     and bit for bit equal to plain on each forward's inputs;
     `render_poses` on its results; `check_data` and `test_synthesis`
     (scenes/s on the host) on the flagship yaml.
 14. the data-path library and what this slice added, at full width: one
     480×640 textured 22-class scene (the flagship yaml's depth range, YCB's
     camera, orientation paint) rendered through the C++ loops and through
     the numpy path, 8 each after a warm-up, splats bit for bit and vertex
     targets within 1e-6, ms a scene on the host; `write_shards` of 16
     such scenes and `ShardReader` drawing 64 samples with chromatic jitter
     and a background pool (scenes/s, samples/s); `train_net` on the
     flagship yaml (c2f) with `train.max_host_rss_gb` under the process's
     RSS, which must snapshot at iteration 1 and return, then `--resume`
     to iteration 3 with the handoff off (Adam's count and steps read back
     2 from the card: restarted at 0); the flagship's compiled Adam step
     resumed from that run's snapshot (count, steps and moments 0 on the
     card, the device rate `schedule(0 + offset)`), its first replay held
     to eager resumed steps by the equality gate, one more replay reading
     back count and steps 1; `train_net --pretrained` from a
     Caffe-layout vgg16.npy at VGG16's shapes (seeded): 15 kernels loaded,
     fc8 skipped, conv1_1 and fc6 equal to the file before 2 steps; in both
     runs flat and window launched once a step and bit for bit equal to
     plain on each step's inputs; the overfit guard (`probe_overfit --iters
     400 --sweep adam:0.0003 --assert_below 15` on a fabricated YCB-Video
     tree: min and final rotation error, ms a step); `export_coco` of 8
     rendered scenes and of the tree's frames.
 15. data parallelism on the one card: its ranks are processes on
     `cuda:0` joined over gloo with CUDA tensors (staged through host
     memory), an exercise of the data-parallel code on the device, not a
     scaling figure. (a) fp32, TF32 off, keep_prob 1: one step of the
     dry run's config (`parallel/dryrun.py`) at 2 ranks × batch 2 against
     one process at batch 4, then `dryrun_multichip(4)` (DP2×TP2, 4
     processes), |Δloss| and max|Δparam| held to the CPU tests' 1e-5 and
     1e-6; (b) the flagship yaml at 2 ranks × 4 images (global batch 8,
     bf16, adam, GT RoIs prepended) through `cli/train_net.build_trainer`
     and `parallel/mesh.spawn_ranks`, as `train_net --num_data` runs them,
     the device map given (both ranks on `cuda:0`, gloo): 3 steps, each
     with finite losses identical on both ranks, the parameters identical
     across ranks after it (per-parameter fp64 sums gathered from both,
     bit for bit), flat and window launched once in each rank and equal
     to plain bit for bit on that rank's inputs; per rank ms a step split
     into forward / backward / all-reduce / optimizer (CUDA events) and
     peak memory; then the same 3 steps through
     `train_net.launch_data_parallel` with that device map (the CLI's rank
     path: `train_loop` with the mesh, the recipe's host-RSS limit judged
     on both ranks every iteration), rank 0's log of 3 iterations with
     finite losses and its one snapshot; (c) `train_net --num_data 2
     --device cpu --iters 2` on a tiny cfg in a subprocess: one
     `metrics.jsonl`, one final snapshot, exit 0; (d) with two cards or more, `train_net --num_data -1` over
     NCCL on the flagship yaml (images/s beside phase 8's one-card step);
     with one card a line says it did not run; (e) `python -m
     posecnn_torch.bench scaling --ranks 2` in process (JAX's
     `experiments/bench_scaling.py`: its lines at 1 and 2 ranks, finite,
     the weak-scaling efficiency, and with one card the last line saying
     it measured the mechanism, not scaling).
 16. the JAX repository's measurement entry points (`posecnn_torch/entry.py`,
     `bench.py`, `utils/graph.py`, `cli/eval_rotation_oracle.py`): (a)
     `entry()`'s forward (stride 4) and `bench infer`'s (stride 1), bf16 at
     full width, each eager and as a CUDA graph of 2 data-dependent bodies
     (`capture_loop`), label_2d, rois and poses_pred of the replay equal to
     the eager forward's bit for bit; (b) on the Hough inputs of each
     forward (8 slots, S = 128), of `bench phases`' batch-4 forward (32
     slots) and of one `bench train` step of each feed (the training
     Hough, 16 slots), flat, window and tile against their plain versions
     bit for bit, with flat and window launched once in each of these
     eager runs (counts set to 0 just before each) and once per captured
     forward; (c) `bench infer` and `train` in process, each JSON line
     printed, every captured forward launching flat and window once
     (`bench phases` runs in phase 17, as the first lines of `bench c2f`);
     (d) the rotation oracle on
     a fabricated YCB-Video tree with a seeded checkpoint of the
     `lov_color_2d` yaml's model, 4 images at 480×640.
 17. the c2f tuning knobs and the rest of the JAX repository's benches
     (`bench.py` `c2f`, `components`, `hough`, `train_components`,
     `train_mfu`, `profile`; `cli/summarize_run.py`): (a) on `bench c2f`'s
     planted samples (8 slots, S = 128, 480×640) the exhaustive vote
     (tile) and, at each tuning (coarse factor, windows a slot) (4, 4),
     (8, 4), (4, 2), (8, 2), the flat pass, the c2f windows and the c2f
     maximum against their plain versions bit for bit, flat and window
     launched once a tuning (counts set to 0 just before each call), with
     each kernel's time (a CUDA graph) and bound at each tuning; (b) one
     eager training step at each shape the benches add (the three
     `train_mfu` points, `train_components`' res_240x320 and batch1), its
     Hough held to plain bit for bit and flat and window launched once;
     then the six benches in process at full width, each JSON line
     printed, every number finite and positive (the derived differences
     of `train_components` finite), every captured body launching the
     kernels it should, each bench's launches counted from 0; (c) a
     3-step `train_net` run and `test_net` on its snapshot (the 48×64
     toy, on the card, each Hough call held to plain), then
     `python -m posecnn_torch.cli.summarize_run` on them: one loss-curve
     row a step and the evaluation's row, finite.

Every scene the script renders goes through the C++ loops of
`data/native.py`. Every `test_net` and demo run goes through
`compiled_run`: the CLI's compiled calls keep a copy of each call, which
is run again eagerly after the CLI returns (recording the forward's
Hough inputs for the kernel checks) and held to the graph's outputs bit
for bit. A graph's replays call no wrapper, so the launches of a run
that replays graphs (the HTTP requests, the compiled CLIs) are the ones
the kernels count on the device (`device_counted`,
`hough_kernels.device_launches`), with those counts and the wrappers'
set to 0 just before the run; its times come from a pass without the
recording where the phase prints them so.

The line before the last is one JSON object with the kernels' results:
the three vote kernels, the NMS scan, whose `launches` are those of
phase 5's batch-1 HTTP run (one a forward, its times at the serving
shape (1, 16), the other shapes' beside them), RANSAC's two pose kernels,
whose `launches` are those of phase 9's replayed `estimate_pose_3d` (one
each a replay), and the Kabsch kernel, launched there no more (0); the
last line is {"ok": true, "device":
{...}}. Without a CUDA device,
or without the posecnn_torch package beside it, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

HEIGHT, WIDTH, NUM_CLASSES = 480, 640, 22
SAMPLES, MAX_CLASSES = 1024, 8
# published dense peaks of one H100 SXM (NVIDIA's data sheet): fp32 on
# the CUDA cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_OPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12
TRAIN_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", "cfgs",
                         "lov_color_2d_pool_full.yaml")
TRAIN_WARMUP, TRAIN_TIMED = 2, 6
# phase 9: test_net and test_icp on the flagship yaml (22 classes,
# 480×640, num_units 64, fc_dim 4096, 1024 test Hough samples)
EVAL_ARGS, EVAL_IMAGES = ["--cfg", TRAIN_CFG], 8
# phase 10: the real-frame family on a fabricated YCB-Video tree, each
# config's yaml as written (22 classes, 480×640, batch 2)
REAL_CFGS = ("lov_rgbd_2d", "lov_color_2d_adapt", "lov_color_2d_full")
# random weights emit no valid Hough RoI at full width, which leaves the
# domain and matching terms no rows: those two configs run with the GT
# RoIs prepended (the flagship's setting); the RGBD one runs as written
REAL_SET = {"lov_rgbd_2d": [], "lov_color_2d_adapt": ["--set", "train.gt_pose_rois=True"],
            "lov_color_2d_full": ["--set", "train.gt_pose_rois=True"]}
REAL_STEPS, REAL_FRAMES = 3, (8, 4)  # train steps per config; train and val frames
# phase 11: the detection family on lov_det.yaml as written (22 classes,
# 480×640, batch 1, 20 anchors a cell, fc_dim 4096, momentum), and the demo
DET_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", "cfgs",
                       "lov_det.yaml")
DET_STEPS, DET_EVAL_IMAGES, DEMO_FRAMES = 4, 8, 5
# phase 12: the segmentation and video families and fusion, each yaml as
# written; SEG_SET's runs on the fcn8 yaml
SEG_CFG, RNN_CFG = "rgbd_scene_single_color_fcn8", "lov_color_rnn"
SEG_SET = {"fcn8": [], "resnet50_seg": ["--set", "network=resnet50_seg"]}
SEG_STEPS, RNN_STEPS, RNN_REAL_STEPS, VIDEO_SEQUENCES = 4, 4, 2, 3
FUSE_GRID, FUSE_CLASSES = 512, 10
# phase 13: the GAN step and the switched posecnn yamls, each as written;
# the train and val frames of the fabricated YCB-Video tree, the scenes
# test_synthesis renders
GAN_CFG = "shapenet_single_single_color_gan"
GAN_STEPS, SWITCH_STEPS, SWITCH_FRAMES, SYNTHESIS_SAMPLES = 4, 3, (4, 2), 8
# phase 14: renders timed a path; shard scenes written and samples read;
# the handoff run's and the --pretrained run's steps; the overfit guard
# at the r6 recipe's settings (finish_round_r6.sh:85-89; JAX's own probe
# clears 15° on the same fabricated geometry, PERF.md); export_coco's
# rendered images and the fabricated tree's frames
RENDERS, SHARD_SCENES, SHARD_READS = 8, 16, 64
HANDOFF_ITERS, PRETRAINED_STEPS, GUARD_ITERS, GUARD_DEG = 3, 2, 400, 15.0
COCO_IMAGES, COCO_FRAMES = 8, 4
# phase 15: the flagship's global batch 8 over 2 ranks on the one card;
# the steps each rank takes; the parity bars of tests/test_torch_parallel.py
DP_RANKS, DP_STEPS, DP_DLOSS, DP_DPARAM = 2, 3, 1e-5, 1e-6
DP_RSS_GB = 100  # the flagship recipe's host-RSS limit (experiments/run_r6c.sh)
SCALING_RANKS = 2  # `bench scaling`'s sizes in phase 15: 1 and 2 ranks
DP_TOY = ["--set", "train.syn_height=48", "train.syn_width=64", "train.num_classes=4",
          "train.fc_dim=32", "train.num_units=8", "train.ims_per_batch=2",
          "train.vertex_reg_2d=True", "train.pose_reg=True", "train.display=1",
          "train.hough_num_samples=64"]
# card vs CPU in ICP: tests/test_torch_icp.py's scene rule, by which it
# holds the port to JAX
ICP_ATOL_STEP, ICP_ATOL, ICP_SHARE = 1e-4, 2e-3, 0.8
# the fp32 additions, subtractions and multiplications the vote needs
# (hough_kernels.votes_at; comparisons and selects are not counted): per
# tested (cell, sample) pair the 6 that depend on the cell (dot's and
# dist2's sums, dot², t2n2·dist2 and the two accumulations); per tested
# (column, sample) and (row, sample) of a unit the 3 of its side (dx or
# dy, u·dx or v·dy, dx² or dy²); per sample tested anywhere in a slot
# (a window, for the window kernel) w·d and 0·d, the two values wv·d
# can take
OPS_PER_PAIR, OPS_PER_LINE, OPS_PER_SAMPLE = 6, 3, 2
# (cls, cx, cy, depth, half_w, half_h): three objects, known centres and
# depths. Centres on the 1/8 grid keep the sampled direction field
# symmetric about them, so the vote plateau is centred there too.
PLANTED = [(5, 200.0, 152.0, 0.9, 60, 50), (12, 448.0, 296.0, 1.3, 50, 60),
           (17, 296.0, 400.0, 0.7, 70, 40)]


def planted_scene(height, width, num_classes, objects, factor=8, noise=0.0, seed=0):
    """A label map and the 1/factor-resolution vertex map a perfect
    vertex head would give: per object a box of its class whose unit
    directions (at the low-res pixel centres) point at (cx, cy), with
    log depth. Returns label (H, W) int64 and vertex (H/f, W/f, 3C) fp32."""
    label = np.zeros((height, width), np.int64)
    ys, xs = np.mgrid[0:height, 0:width]
    hl, wl = height // factor, width // factor
    low = (np.random.RandomState(seed).randn(hl, wl, 3 * num_classes) * noise).astype(np.float32)
    ly, lx = np.mgrid[0:hl, 0:wl]
    fy_c, fx_c = (ly + 0.5) * factor - 0.5, (lx + 0.5) * factor - 0.5
    for cls, cx, cy, depth, hw, hh in objects:
        label[(np.abs(xs - cx) <= hw) & (np.abs(ys - cy) <= hh)] = cls
        region = (np.abs(fx_c - cx) <= hw + factor) & (np.abs(fy_c - cy) <= hh + factor)
        dx, dy = cx - fx_c, cy - fy_c
        n = np.sqrt(dx * dx + dy * dy) + 1e-10
        low[region, 3 * cls + 0] += (dx / n)[region]
        low[region, 3 * cls + 1] += (dy / n)[region]
        low[region, 3 * cls + 2] += np.log(depth)
    return label, low


def intrinsics(height, width, f=1066.0):
    k = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32)
    meta = np.zeros(48, np.float32)
    meta[:9] = k.flatten()
    meta[9:18] = np.linalg.inv(k).flatten()
    return k, meta


def planted_extents(num_classes):
    return np.full((num_classes, 3), 0.15, np.float32) * (np.arange(num_classes) > 0)[:, None]


def packed_planted(device):
    """(K, 8, S) samples, (K, 4) boxes and (K,) sample weights of the
    planted scene, packed by the port's `_prepare_slots` at the serve
    config."""
    import torch

    from posecnn_torch.ops.hough_voting import _prepare_slots

    label, low = planted_scene(HEIGHT, WIDTH, NUM_CLASSES, PLANTED, noise=0.02)
    _, meta = intrinsics(HEIGHT, WIDTH)
    prep = _prepare_slots(
        torch.from_numpy(label).to(device), torch.from_numpy(low).to(device),
        torch.from_numpy(planted_extents(NUM_CLASSES)).to(device), torch.from_numpy(meta).to(device),
        num_classes=NUM_CLASSES, label_threshold=500, skip_pixels=10, num_samples=SAMPLES,
        max_classes=MAX_CLASSES, vertex_factor=8,
    )
    return prep["packed"], prep["bboxes"], prep["samp_w"]


# the vote kernels by their names in the source, the JSON line and LAUNCHES
KERNELS = {"tile": "tile_vote_kernel", "flat": "flat_vote_kernel",
           "window": "window_vote_kernel"}
# every kernel the launch counts hold (ops/_cuda.KERNELS): the vote kernels
# and the NMS scan, whose library also builds its packing kernel
COUNTED = (*KERNELS, "scan", "kabsch", "pose_hyp", "pose_refine")
SCAN_KERNEL, PACK_KERNEL = "nms_scan_kernel", "pack_kill_kernel"
# refine/ransac.py's rotation kernel and its two pose kernels (csrc/kabsch.cu)
KABSCH_KERNEL = "kabsch_kernel"
POSE_HYP_KERNEL, POSE_REFINE_KERNEL = "pose_hypotheses_kernel", "pose_refine_kernel"
EDGE_CASES = ("s1", "s37", "s300", "s1100", "inf_depth", "short", "dead", "multi")


def vote_edge_case(name):
    """Vote inputs at the edges the coarse-to-fine kernels must hold bit
    for bit, made with numpy from a seed. Returns (samples (K, 8, S)
    fp32, bboxes (K, 4) fp32, (height, width) of the stride-1 cell grid,
    c2f window options).

    The coarse grid (stride 4) of a 150×172 grid is 38×43 cells: its
    second 1024-cell tile is ragged, and its odd width puts row ends at
    every offset within a block. `s*` have S = 1, 37, 300 and
    1100 samples. `inf_depth` has a sample at d = inf that is tested in
    the first coarse tile only (NaN in dsum there, none in the second
    tile) and one at w = 0 that is never tested; slot 1 votes with one
    at its centre, so its windows carry NaN. `short` is 20 rows high,
    so its windows reach past the grid, and its objects sit at the
    bottom-right, so their windows clamp there; slot 0 votes with one
    sample at d = inf at its object's centre, which its windows test, so
    their cells past the grid (weight 0) carry 0·inf = NaN. `dead` has no live
    sample and no vote box. `multi` picks 32 windows per slot greedily,
    as multi-instance Hough does."""
    rng = np.random.RandomState(EDGE_CASES.index(name))
    k, s = 3, {"s1": 1, "s37": 37, "s300": 300, "s1100": 1100}.get(name, 256)
    height, width = (20, 172) if name == "short" else (150, 172)
    if name == "short":
        cx, cy = rng.uniform(150, 172, (k, 2)), rng.uniform(10, 20, (k, 2))
    else:
        cx, cy = rng.uniform(20, width - 20, (k, 2)), rng.uniform(20, height - 20, (k, 2))
    # one object per slot, or two in `multi`
    pick = rng.randint(0, 2 if name == "multi" else 1, (k, s))
    tx, ty = np.take_along_axis(cx, pick, 1), np.take_along_axis(cy, pick, 1)
    x, y = tx + rng.uniform(-45, 45, (k, s)), ty + rng.uniform(-45, 45, (k, s))
    dx, dy = tx - x, ty - y
    n = np.sqrt(dx * dx + dy * dy) + 1e-10
    u, v = dx / n + rng.randn(k, s) * 0.05, dy / n + rng.randn(k, s) * 0.05
    d = rng.uniform(0.5, 2.0, (k, s))
    t2n2 = (0.9 * np.sqrt(u * u + v * v)) ** 2
    thr = rng.uniform(8.0, 60.0, (k, s))
    w = rng.uniform(0.5, 1.5, (k, s)) * (rng.uniform(size=(k, s)) > 0.1)
    if name in ("s37", "s1100"):
        w[1] = 0.0  # a dead slot among live ones
    if name == "dead":
        w[:] = 0.0
    if name == "inf_depth":
        # slot 0 spans all rows; sample 0 reaches rows 0-30 px only
        y[0] = rng.uniform(0, height, s)
        x[0, 0], y[0, 0], thr[0, 0], w[0, 0], d[0, 0] = 60.0, 10.0, 20.0, 1.0, np.inf
        x[0, 1], y[0, 1], w[0, 1], d[0, 1] = 80.0, 120.0, 0.0, np.inf
        x[1, 0], y[1, 0], thr[1, 0], w[1, 0], d[1, 0] = cx[1, 0], cy[1, 0], 60.0, 1.0, np.inf
    if name == "short":
        x[0, 0], y[0, 0], thr[0, 0], w[0, 0], d[0, 0] = cx[0, 0], cy[0, 0], 30.0, 1.0, np.inf
    samples = np.stack([x, y, u, v, d, t2n2, thr, w], 1).astype(np.float32)
    live = w > 0
    big = np.float32(3e38)
    bboxes = np.stack([np.where(live, x - thr, big).min(1), np.where(live, x + thr, -big).max(1),
                       np.where(live, y - thr, big).min(1), np.where(live, y + thr, -big).max(1)],
                      1).astype(np.float32)
    top_t, local_max = (32, True) if name == "multi" else (4, False)
    return samples, bboxes, (height, width), dict(top_t=top_t, coarse_local_max=local_max)


# the NMS scan's inputs: the RPN's (1, 2000) suppression matrix at phase
# 11's shapes, test_net's (21, 128) per-class one, the serving programs'
# per-class ones at batch 1 and 4, and the edges (of the kernel's words,
# its register and shared-memory masks, its blocks of four warps)
SCAN_CASES = ("rpn", "per_class", "all_invalid", "all_kill", "no_kills", "n1", "n33", "n31",
              "n32", "n64", "n65", "n2048", "n2049", "n4096", "b64", "serve1", "serve4")
# the cases phase 2 times (the main paths' shapes)
SCAN_TIMED = ("rpn", "per_class", "serve1", "serve4")
DET_RPN = dict(height=480, width=640, stride=16, scales=(4, 8, 16, 32),
               ratios=(0.5, 0.75, 1.0, 1.5, 2.0), pre_nms=2000, threshold=0.7, min_size=16.0)


def scan_case(name):
    """The greedy scan's inputs, made from a seed on the CPU: (kill (B, N, N)
    bool, sorted_valid (B, N) bool) tensors, as `ops/nms.box_suppression`
    makes them. `rpn` is `proposal_layer`'s at lov_det.yaml's shapes
    (`DET_RPN`): 24000 anchors on the 30×40 conv5_3 map of a 480×640 frame
    with seeded scores and deltas, the top 2000 decoded and clipped, the
    16 px size filter as the valid rows, IoU > 0.7. `per_class` is
    `test_net`'s per-class NMS at lov_det's test shapes: 21 foreground
    classes × 128 proposals around six objects, scores per class, IoU >
    0.5, an eighth of the proposals invalid. `serve1` and `serve4` are the
    serving forward's `nms_per_class` at batch 1 and 4 (`per_class_suppression`
    over 16 and 64 Hough RoIs: 8 classes, 2 instances a class and frame,
    tied scores). `all_invalid` has no valid row; `all_kill` every row
    killing every later one; `no_kills` none; `n1` N = 1 in three leading
    indices; `nN` N = 31, 32, 33 (a word, and a bit past it), 64, 65,
    2048 (the last in registers), 2049 (the first in shared memory) and
    4096 (a sparse random kill, a third of the valid rows kept); `b64` 64
    leading indices of N = 200 (sixteen blocks of four warps)."""
    import torch

    from posecnn_torch.ops.nms import box_suppression, per_class_suppression
    from posecnn_torch.ops.rpn import _top_k, anchor_grid, generate_anchors
    from posecnn_torch.utils.bbox import bbox_transform_inv, clip_boxes

    rng = np.random.RandomState(100 + SCAN_CASES.index(name))
    if name == "rpn":
        r = DET_RPN
        h, w = -(-r["height"] // r["stride"]), -(-r["width"] // r["stride"])
        anchors = torch.from_numpy(anchor_grid(h, w, r["stride"], generate_anchors(
            r["stride"], r["ratios"], r["scales"])))
        scores = torch.from_numpy(rng.rand(len(anchors)).astype(np.float32))
        deltas = torch.from_numpy((rng.randn(len(anchors), 4) * 0.2).astype(np.float32))
        top, idx = _top_k(scores, r["pre_nms"])
        boxes = clip_boxes(bbox_transform_inv(anchors[idx], deltas[idx]), r["height"],
                           r["width"])
        size_ok = ((boxes[:, 2] - boxes[:, 0] + 1 >= r["min_size"])
                   & (boxes[:, 3] - boxes[:, 1] + 1 >= r["min_size"]))
        _, kill, valid = box_suppression(boxes, top, r["threshold"], size_ok)
        return kill[None], valid[None]
    if name in ("serve1", "serve4"):
        frames = 1 if name == "serve1" else 4
        n = 16 * frames
        cls = np.tile(np.repeat(np.arange(1, 9), 2), frames)
        xy = rng.uniform(0, 560, (n, 2))
        xy[1::2] = xy[::2] + rng.uniform(-10, 10, (n // 2, 2))  # a near twin a class
        rois = np.concatenate([np.repeat(np.arange(frames), 16)[:, None], cls[:, None], xy,
                               xy + rng.uniform(40, 80, (n, 2)),
                               np.round(rng.rand(n, 1) * 4) / 4], 1).astype(np.float32)
        _, kill, valid = per_class_suppression(torch.from_numpy(rois), 0.5,
                                               torch.from_numpy(rng.rand(n) > 0.25))
        return kill[None].contiguous(), valid[None]
    if name == "n4096":
        n = 4096
        kill = np.zeros((n, n), bool)
        i, j = rng.randint(0, n, (2, 4 * n))
        kill[np.minimum(i, j), np.maximum(i, j)] = i != j
        return torch.from_numpy(kill[None]), torch.from_numpy(rng.rand(1, n) > 0.125)
    b, n = {"per_class": (21, 128), "n1": (3, 1), "b64": (64, 200)}.get(name, (2, 64))
    if name.startswith("n") and name[1:].isdigit():
        n = int(name[1:])
    centres = rng.uniform(40, 600, (6, 2))
    c = centres[rng.randint(0, 6, n)] + rng.randn(n, 2) * 12
    half = rng.uniform(15, 60, (n, 2))
    boxes = np.concatenate([c - half, c + half], 1).astype(np.float32)
    boxes = np.broadcast_to(boxes, (b, n, 4)).copy()
    scores = rng.rand(b, n).astype(np.float32)
    scores[:, ::5] = 0.5  # ties keep their input order
    valid = rng.rand(b, n) > 0.125
    if name == "all_invalid":
        valid[:] = False
    _, kill, sorted_valid = box_suppression(torch.from_numpy(boxes), torch.from_numpy(scores),
                                            0.5, torch.from_numpy(valid))
    if name == "all_kill":
        kill = torch.ones_like(kill).triu(diagonal=1)
    elif name == "no_kills":
        kill = torch.zeros_like(kill)
    return kill.contiguous(), sorted_valid


def exact(got, want):
    """max |got - want| and whether got equals want element for element,
    NaN where want is NaN (bit for bit but for NaN payloads). Equal tensors
    on one device are told so there, without a copy to the host."""
    import torch

    if got.device == want.device and got.shape == want.shape and got.dtype == want.dtype:
        same = got == want
        if got.is_floating_point():
            same |= torch.isnan(got) & torch.isnan(want)
        if bool(same.all()):
            return 0.0, True
    got, want = got.cpu().double(), want.cpu().double()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not same.numel():
        return 0.0, True
    return float(torch.where(same, 0.0, (got - want).abs()).max()), bool(same.all())


def graph_ms(fn, n):
    """Device milliseconds per call of `fn`: n calls captured in one CUDA
    graph, replayed once to warm up, then timed over one replay by CUDA
    events. No host work lies between the launches, so a kernel that is
    faster than its wrapper's host code is still timed, not the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profiler_ms(calls, n=20):
    """torch.profiler's mean device milliseconds per launch of each
    kernel over n calls of each of `calls` (name -> fn); a kernel the
    profiler recorded no device time for is missing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name in calls:
            if KERNELS[name] in ev.key and total > 0:
                out[name] = total / ev.count / 1e3
    return out


def ptxas_lines(report):
    """Per kernel of `nvcc -Xptxas -v`'s report: registers, shared memory
    bytes and spill bytes (stores + loads)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            name = next((k for k in (*KERNELS.values(), SCAN_KERNEL, PACK_KERNEL, KABSCH_KERNEL,
                                     POSE_HYP_KERNEL, POSE_REFINE_KERNEL)
                         if k in m.group(1)), None)
            if name in (SCAN_KERNEL, PACK_KERNEL):  # templates: the mask's home, the reads
                flag = "ILb1E" in m.group(1)
                name += (f"<{'shared' if flag else 'registers'}>" if name == SCAN_KERNEL
                         else f"<{'16-byte' if flag else 'byte'} loads>")
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(registers=int(m.group(1)),
                                            smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def lines_per_group(coord, in_grid, group, n_groups):
    """(rows of in_grid, n_groups) float64: how many distinct values of
    `coord` (a cell's row or column) the in-grid cells of each group hold."""
    import torch

    coord = coord.expand_as(in_grid).long()
    span = int(coord.max()) + 1 if coord.numel() else 1
    out = torch.zeros((in_grid.shape[0], n_groups), dtype=torch.float64, device=coord.device)
    for r in range(in_grid.shape[0]):
        keep = in_grid[r]
        keys = torch.unique(group[keep] * span + coord[r, keep])
        out[r] = torch.bincount(keys // span, minlength=n_groups).double()
    return out


def vote_bound(cells, in_bytes, out_bytes):
    """The least time of a vote kernel on these inputs: the larger of its
    operations over the fp32 peak and its bytes (inputs read once,
    outputs written once) over the memory rate. `cells` is the last five
    fields (cy, cx, in_grid, group, hit) of a `hough_kernels.*_cells` result:
    only the in-grid cells of the groups a sample is tested in count.
    Returns (bound ms, "operations" or "bytes", tested pairs)."""
    import torch

    cy, cx, in_grid, group, hit = cells
    n_groups = hit.shape[2]
    per_group = torch.zeros((in_grid.shape[0], n_groups), dtype=torch.float64,
                            device=hit.device).index_add_(1, group, in_grid.double())
    tested = hit.double()
    tests = float((tested * per_group[:, None]).sum())
    lines = lines_per_group(cx, in_grid, group, n_groups) + lines_per_group(cy, in_grid, group,
                                                                             n_groups)
    ops = (tests * OPS_PER_PAIR + float((tested * lines[:, None]).sum()) * OPS_PER_LINE
           + float(hit.any(2).sum()) * OPS_PER_SAMPLE)
    t_ops = ops / PEAK_FP32_OPS
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", tests


def phase_kernels(device):
    """Kernels against their plain versions at the serve shapes and at
    the edge cases, bit for bit; their times."""
    import torch

    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.ops import hough_kernels as hk
    from posecnn_torch.ops.hough_voting import _window_maxima

    def check(name, got, want, where="at the serve shapes"):
        err, ok = exact(got, want)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version {where}: "
                                 f"max_abs_err {err}")
        return err

    samples, bboxes, samp_w = packed_planted(device)
    k, _, s = samples.shape
    coarse = dict(cell_stride=4, grid_h=HEIGHT // 4, grid_w=WIDTH // 4)
    fine = dict(cell_stride=1, grid_h=HEIGHT, grid_w=WIDTH)
    in_bytes = samples.numel() * 4 + bboxes.numel() * 4

    # the exhaustive kernel over the full stride-1 grid
    tv, td = hk.hough_votes_exhaustive(samples, bboxes, **fine)
    qv, qd = hk.hough_votes_exhaustive_plain(samples, bboxes, **fine)
    assert tv.shape == (k, HEIGHT, WIDTH), tv.shape
    errs = {"tile": max(check("tile_vote_kernel", tv, qv), check("tile_vote_kernel", td, qd))}

    kv, kd = hk.hough_votes_flat(samples, bboxes, **coarse)
    pv, pd = hk.hough_votes_flat_plain(samples, bboxes, **coarse)
    assert kv.shape == (k, (HEIGHT // 4) * (WIDTH // 4)), kv.shape
    assert float(pv.max()) > 0, "the planted scene gave no coarse votes"
    errs["flat"] = max(check("flat_vote_kernel", kv, pv), check("flat_vote_kernel", kd, pd))

    # the window kernel on the origins that the plain coarse votes give
    _, top_i = torch.sort(pv, dim=1, descending=True, stable=True)
    top_i = top_i[:, : hk.TOP_T]
    cw = WIDTH // 4
    oy = ((top_i // cw) * 4 + 2 - hk.WINDOW // 2).clamp(0, HEIGHT - hk.WINDOW)
    ox = ((top_i % cw) * 4 + 2 - hk.WINDOW // 2).clamp(0, WIDTH - hk.WINDOW)
    en = pv.gather(1, top_i) > 0
    origins = torch.stack([oy, ox, en.long()], -1).reshape(k * hk.TOP_T, 3).int().contiguous()
    wv, wd = hk.hough_votes_windows(samples, origins, **fine)
    qv, qd = hk.hough_votes_windows_plain(samples, origins, **fine)
    errs["window"] = max(check("window_vote_kernel", wv, qv), check("window_vote_kernel", wd, qd))

    # the c2f maximum the kernels pick is the plain one, cell and sums
    best_k = hk.hough_votes_c2f(samples, bboxes, **fine)
    best_p = hk.hough_votes_c2f(samples.cpu(), bboxes.cpu(), **fine)
    for got, want in zip(best_k, best_p):
        check("the c2f maximum", got, want)

    # kernel times: from a CUDA graph of n launches (ms) and per call of a
    # loop of wrapper calls (call_ms); the plain versions run twice in
    # all at these shapes (the comparison above is their warm-up)
    calls = {
        "tile": (lambda: hk.hough_votes_exhaustive(samples, bboxes, **fine), 50,
                 lambda: hk.hough_votes_exhaustive_plain(samples, bboxes, **fine)),
        "flat": (lambda: hk.hough_votes_flat(samples, bboxes, **coarse), 200,
                 lambda: hk.hough_votes_flat_plain(samples, bboxes, **coarse)),
        "window": (lambda: hk.hough_votes_windows(samples, origins, **fine), 200,
                   lambda: hk.hough_votes_windows_plain(samples, origins, **fine)),
    }
    times = {name: (graph_ms(fn, n), device_ms(fn, device, n),
                    device_ms(plain, device, 1, warm=False))
             for name, (fn, n, plain) in calls.items()}
    c2f_ms = device_ms(lambda: hk.hough_votes_c2f(samples, bboxes, **fine), device, 50)
    try:
        prof = profiler_ms({name: fn for name, (fn, _, _) in calls.items()})
        prof_note = ", ".join(f"{n} {prof[n]:.4f}" for n in prof) or "no device time recorded"
    except RuntimeError as err:  # the profiler is a cross-check, not a gate
        prof_note = f"profiler failed: {err}"

    # multi-instance c2f at the full-width model's object budget (16 RoIs
    # per image, so 32 greedily picked windows per slot): the window
    # kernel at the origins that path gives it, many overlapping and some
    # disabled, against its plain version
    multi = dict(fine, top_t=32, coarse_local_max=True)
    win = hk.hough_votes_c2f_windows(samples, bboxes, **multi)
    moy, mox, men = win[2:]
    m_origins = torch.stack([moy, mox, men.long()], -1).reshape(-1, 3).int().contiguous()
    mv, md = hk.hough_votes_windows(samples, m_origins, **fine)
    qv, qd = hk.hough_votes_windows_plain(samples, m_origins, **fine)
    where = "at the multi-instance origins"
    multi_err = max(check("window_vote_kernel", mv, qv, where),
                    check("window_vote_kernel", md, qd, where))
    # its time, split: the whole c2f windows call (flat pass, greedy
    # pick, window kernel), the window kernel alone (graph), and the
    # maxima search with its decidability dedup that hough_voting runs
    # after it
    multi_ms = (
        device_ms(lambda: hk.hough_votes_c2f_windows(samples, bboxes, **multi), device, 20),
        graph_ms(lambda: hk.hough_votes_windows(samples, m_origins, **fine), 50),
        device_ms(lambda: _window_maxima(*win, samp_w, grid_h=HEIGHT, grid_w=WIDTH, m=16,
                                         vote_threshold=1.0), device, 20),
    )

    # the kernels at the edge cases, on the card against the CPU: the
    # exhaustive vote at stride 1 (ragged tiles, NaN where a tested
    # d = inf sample reaches), the flat pass, and the windows at the
    # origins the c2f glue picks
    for case in EDGE_CASES:
        e_samples, e_boxes, (h, w), opts = vote_edge_case(case)
        e_samples, e_boxes = torch.from_numpy(e_samples), torch.from_numpy(e_boxes)
        where = f"at edge case {case}"
        kw = dict(cell_stride=1, grid_h=h, grid_w=w)
        got = hk.hough_votes_exhaustive(e_samples.to(device), e_boxes.to(device), **kw)
        for a, b in zip(got, hk.hough_votes_exhaustive_plain(e_samples, e_boxes, **kw)):
            check("tile_vote_kernel", a, b, where)
        kw = dict(cell_stride=4, grid_h=-(-h // 4), grid_w=-(-w // 4))
        got = hk.hough_votes_flat(e_samples.to(device), e_boxes.to(device), **kw)
        for a, b in zip(got, hk.hough_votes_flat_plain(e_samples, e_boxes, **kw)):
            check("flat_vote_kernel", a, b, where)
        kw = dict(cell_stride=1, grid_h=h, grid_w=w, **opts)
        got = hk.hough_votes_c2f_windows(e_samples.to(device), e_boxes.to(device), **kw)
        for a, b in zip(got, hk.hough_votes_c2f_windows(e_samples, e_boxes, **kw)):
            check("window_vote_kernel", a, b, where)

    out_cells = {"tile": k * HEIGHT * WIDTH, "flat": kv.numel(), "window": wv.numel()}
    cells = {
        "tile": hk.tile_cells(samples, bboxes, **fine),
        "flat": hk.flat_cells(samples, bboxes, **coarse),
        "window": hk.window_cells(samples, origins, **fine)[1:],
    }
    bounds = {
        name: vote_bound(cells[name], in_bytes if name != "window" else
                         samples.numel() * 4 + origins.numel() * 4, 2 * 4 * out_cells[name])
        for name in cells
    }
    # how unevenly the exhaustive vote's work falls on its (tile, slot) pairs
    per_tile = cells["tile"][4].sum(1)
    per_tile = per_tile[per_tile > 0].double()
    print(f"phase 2 kernels vs plain at serve shapes (K={k}, S={s}), bit for bit: tile "
          f"{tuple(tv.shape)}, flat {tuple(kv.shape)}, windows {tuple(wv.shape)}, c2f maximum "
          f"equal; tile (stride 1), flat and c2f windows at the edge cases "
          f"{', '.join(EDGE_CASES)}: equal; ms graph/call/"
          f"plain/bound (bound by, tested pairs): "
          + ", ".join(f"{n} {times[n][0]:.4f}/{times[n][1]:.4f}/{times[n][2]:.1f}/"
                      f"{bounds[n][0]:.4f} ({bounds[n][1]}, {bounds[n][2]:.4g})" for n in times)
          + f"; tile: {per_tile.numel()} live (tile, slot) pairs, tested samples per pair "
          f"{float(per_tile.min()):.0f}-{float(per_tile.max()):.0f} (mean "
          f"{float(per_tile.mean()):.1f})"
          + f"; torch.profiler ms per launch: {prof_note}; exhaustive {times['tile'][0]:.4f} ms "
          f"vs c2f pair with its glue {c2f_ms:.4f} ms on the same samples; multi-instance c2f: "
          f"windows {tuple(mv.shape)} at the greedy origins ({int(men.sum())} live) equal "
          f"(max_abs_err {multi_err:.3g}), c2f windows call (flat + greedy pick + window kernel) "
          f"{multi_ms[0]:.4f} ms, window kernel alone {multi_ms[1]:.4f} ms (graph), window "
          f"maxima with the dedup {multi_ms[2]:.4f} ms", flush=True)
    return errs, times, bounds


def scan_bound(kill, kept):
    """The least time of the NMS scan on these inputs: the bytes the walk
    needs (each kept row's kills of the rows after it, one byte each, the
    valid mask read and the kept mask written) over the memory rate; its
    ORs, a word of 32 kills at a time, are far fewer than the bytes.
    Returns (bound ms, "bytes", bytes)."""
    import torch

    n = kill.shape[-1]
    rows = torch.arange(n, device=kept.device)
    needed = float(((n - 1 - rows) * kept.reshape(-1, n)).sum()) + 2 * kept.numel()
    return needed / PEAK_BYTES * 1e3, "bytes", needed


def scan_profile(kill, valid, n=50):
    """torch.profiler's mean device milliseconds a launch of each kernel
    of `greedy_scan` (the packing and the scan) over n calls; a kernel it
    recorded no time for is missing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from posecnn_torch.ops.nms import greedy_scan

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            greedy_scan(kill, valid)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name in (PACK_KERNEL, SCAN_KERNEL):
            if name in ev.key and total > 0:
                out[name] = out.get(name, 0.0) + total / 1e3 / n
    return out


def phase_scan(device):
    """Phase 2, the NMS scan: the kernel against its plain version bit for
    bit at every `scan_case`, its launches counted by the wrapper and on
    the device; at the main paths' shapes (`SCAN_TIMED`) its time as a CUDA
    graph of n calls (`ms`), per wrapper call (`call_ms`) and each of its
    two launches' (the packing's and the scan's) by torch.profiler, the
    plain version's and the bound. Returns those by timed case."""
    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.ops.nms import greedy_scan, greedy_scan_plain

    results, shapes = {}, {}
    for case in SCAN_CASES:
        kill, valid = (t.to(device) for t in scan_case(case))
        shapes[case] = tuple(valid.shape)
        want = greedy_scan_plain(kill, valid)
        got, calls, counted = device_counted(lambda: greedy_scan(kill, valid))
        err, same = exact(got, want)
        if not same or got.shape != want.shape:
            raise AssertionError(f"{SCAN_KERNEL} disagrees with its plain version at scan case "
                                 f"{case}: {int((got != want).sum())} rows differ")
        if (calls["scan"], counted["scan"]) != (1, 1):
            raise AssertionError(f"{SCAN_KERNEL} at {case}: wrapper / device launches "
                                 f"{calls['scan']} / {counted['scan']}, not 1 / 1")
        if case in SCAN_TIMED:
            bound = scan_bound(kill, want)
            results[case] = dict(
                shape=shapes[case], kept=int(want.sum()), valid=int(valid.sum()),
                max_abs_err=err, ms=graph_ms(lambda: greedy_scan(kill, valid), 50),
                call_ms=device_ms(lambda: greedy_scan(kill, valid), device, 50),
                kernels_ms=scan_profile(kill, valid),
                plain_ms=device_ms(lambda: greedy_scan_plain(kill, valid), device, 1, warm=False),
                bound_ms=bound[0], bound_by=bound[1], bytes=bound[2])
    print("phase 2 NMS scan kernel vs plain, bit for bit at (B, N) "
          + ", ".join(f"{c} {shape}" for c, shape in shapes.items())
          + f"; one scan launch each (wrapper / device), after one {PACK_KERNEL} launch; ms "
          "graph / call / each launch (profiler) / plain / bound (bound by, bytes needed; kept "
          "of valid rows): "
          + "; ".join(f"{c} {r['ms']:.4f} / {r['call_ms']:.4f} / "
                      + ", ".join(f"{k} {v:.4f}" for k, v in r["kernels_ms"].items())
                      + f" / {r['plain_ms']:.1f} / {r['bound_ms']:.3g} ({r['bound_by']}, "
                      f"{r['bytes']:.4g}; {r['kept']} of {r['valid']})"
                      for c, r in results.items()), flush=True)
    return results


def phase_planted(device):
    """The planted scene through hough_voting: centres within 1 px, depths 1%."""
    import torch

    from posecnn_torch.ops.hough_voting import hough_voting

    label, low = planted_scene(HEIGHT, WIDTH, NUM_CLASSES, PLANTED, noise=0.02)
    _, meta = intrinsics(HEIGHT, WIDTH)
    out = hough_voting(
        torch.from_numpy(label[None]).to(device), torch.from_numpy(low[None]).to(device),
        torch.from_numpy(planted_extents(NUM_CLASSES)).to(device),
        torch.from_numpy(meta[None]).to(device),
        num_samples=SAMPLES, max_classes=MAX_CLASSES, vertex_factor=8,
    )
    rois, poses, valid = out.rois.cpu().numpy(), out.poses_init.cpu().numpy(), out.valid.cpu().numpy()
    if int(valid.sum()) != len(PLANTED):
        raise AssertionError(f"{int(valid.sum())} valid rows for {len(PLANTED)} planted objects")
    worst_px, worst_depth = 0.0, 0.0
    for cls, cx, cy, depth, _, _ in PLANTED:
        row = np.nonzero(valid & (rois[:, 1] == cls))[0]
        if len(row) != 1:
            raise AssertionError(f"class {cls}: {len(row)} rows")
        r, p = rois[row[0]], poses[row[0]]
        px = max(abs(0.5 * (r[2] + r[4]) - cx), abs(0.5 * (r[3] + r[5]) - cy))
        dz = abs(p[6] - depth) / depth
        if px > 1.0 or dz > 0.01:
            raise AssertionError(f"class {cls}: centre off by {px} px, depth by {dz:.4f}")
        worst_px, worst_depth = max(worst_px, px), max(worst_depth, dz)
    print(f"phase 3 planted scene through hough_voting: {len(PLANTED)} objects, centres within "
          f"{worst_px:.3f} px, depths within {100 * worst_depth:.3f}%", flush=True)


def phase_small_model(device):
    """The whole model, small and in fp32, on the card against the CPU."""
    import torch

    from posecnn_torch.models.posecnn import PoseCNN, init_weights

    c, h, w = 4, 96, 128
    model = PoseCNN(c, num_units=16, fc_dim=64, hough_num_samples=64, max_objects=4)
    init_weights(model, 0)
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(1, h, w, 3).astype(np.float32) * 40.0)
    extents = torch.from_numpy(planted_extents(c))
    _, meta = intrinsics(h, w, f=150.0)
    meta = torch.from_numpy(meta[None])
    ref = model(data, extents, meta)
    got = model.to(device)(data.to(device), extents.to(device), meta.to(device))
    agree = float((got.label_2d.cpu() == ref.label_2d).float().mean())
    if agree < 0.999:
        raise AssertionError(f"label agreement {agree}")
    if agree == 1.0:
        for name in ("rois", "poses_init", "valid"):
            a, b = getattr(got.hough, name).cpu(), getattr(ref.hough, name)
            if not torch.allclose(a.float(), b.float(), atol=1e-3):
                raise AssertionError(f"hough {name} disagrees with the CPU")
        if not torch.allclose(got.poses_pred.cpu(), ref.poses_pred, atol=1e-3):
            raise AssertionError("poses_pred disagrees with the CPU")
    print(f"phase 4 small fp32 model on the card vs the CPU: label agreement {agree:.5f}"
          + (", rois/poses_init/poses_pred within 1e-3" if agree == 1.0 else ""), flush=True)


# a captured forward's launches (c2f), and with its per-class NMS (the
# serving, demo and posecnn test_net programs)
FORWARD_BODY = {"tile": 0, "flat": 1, "window": 1, "scan": 0, "kabsch": 0,
                "pose_hyp": 0, "pose_refine": 0}
NMS_FORWARD = {**FORWARD_BODY, "scan": 1}
# phase 5: requests a counted pass sends (batch 1: the five images in turn;
# batch 4: twice the batch from as many clients), and requests a timed
# pass sends, its clients as many as the batch
SERVE_TIMED = 200


def device_counted(call):
    """call() with the CUDA kernels' counts set to 0 just before it: the
    wrappers' (`_cuda.LAUNCHES`) and the kernels' own on the device
    (`_cuda.device_launches`). Returns (call's result, the wrappers' counts
    after it: the kernels they launched eagerly, and the device's: those
    and the ones graph replays made, which call no wrapper), each by
    kernel of COUNTED."""
    from posecnn_torch.ops import _cuda

    for key in _cuda.LAUNCHES:
        _cuda.LAUNCHES[key] = 0
    _cuda.reset_device_launches()
    out = call()
    counted = _cuda.device_launches()
    calls = {k: _cuda.LAUNCHES[k] for k in COUNTED}
    return out, calls, {k: counted[k] for k in COUNTED}


def phase_serve(card):
    """The HTTP serving path at full width, compiled, at engine batch 1 and
    4 (the MicroBatcher behind 4 clients). Returns (each CUDA kernel's
    launches counted on the device in the batch-1 HTTP run, each engine's
    captured body's launches)."""
    from concurrent.futures import ThreadPoolExecutor as Clients

    import torch

    from posecnn_torch.cli.serve import _decode_image, build_engine, make_parser, make_server
    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.models import posecnn as posecnn_module
    from posecnn_torch.ops import hough_kernels as hk
    from posecnn_torch.ops.nms import greedy_keep, per_class_suppression

    label, _ = planted_scene(HEIGHT, WIDTH, NUM_CLASSES, PLANTED)
    planted = (label * 11 % 256).astype(np.uint8)[:, :, None].repeat(3, 2)
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 255, (HEIGHT, WIDTH, 3), np.uint8) for _ in range(4)] + [planted]
    bodies_json = [json.dumps({"image_b64": base64.b64encode(img.tobytes()).decode(),
                               "shape": list(img.shape)}).encode() for img in images]
    keys = {"detections", "label_shape", "seconds", "batch_seconds", "batch_size"}
    parts, bodies, http_launches = [], {}, None
    for batch in (1, 4):
        args = make_parser().parse_args(["--port", "0", "--batch", str(batch)])
        t0 = time.perf_counter()
        engine = build_engine(args)  # builds, warms up and captures the graph
        setup_s = time.perf_counter() - t0
        cfg_line = (f"{engine.num_classes} classes, {engine.height}x{engine.width}, fc_dim "
                    f"{engine.model.pose_head.fc6.out_features}, samples "
                    f"{engine.model.hough_kw['num_samples']}")
        (program,) = engine._compiled.programs.values()
        bodies[f"serve batch {batch}"] = program.launches
        if program.launches != NMS_FORWARD:
            raise AssertionError(f"serve batch {batch}: the captured forward records "
                                 f"{program.launches}, not {NMS_FORWARD}")
        server = make_server(engine, "127.0.0.1", 0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()

        def post(i):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/infer",
                                         data=bodies_json[i % len(images)],
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, out = resp.status, json.loads(resp.read())
            return status, out, (time.perf_counter() - t) * 1000

        def send(n):
            if batch == 1:
                return [post(i) for i in range(n)]
            with Clients(batch) as clients:
                return list(clients.map(post, range(n)))

        try:
            # the counted pass: the replays' launches counted on the device
            results, calls, counted = device_counted(
                lambda: send(len(images) if batch == 1 else 2 * batch))
            # the timed pass
            timed = send(SERVE_TIMED)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        n_det = 0
        for status, out, _ in results + timed:
            if status != 200 or set(out) != keys:
                raise AssertionError(f"bad response {status}: {str(out)[:200]}")
            for det in out["detections"]:
                vals = det["quat_wxyz"] + det["trans"] + det["roi"] + [det["score"]]
                if not np.all(np.isfinite(vals)):
                    raise AssertionError(f"non-finite detection {det}")
                if abs(np.linalg.norm(det["quat_wxyz"]) - 1.0) > 1e-3:
                    raise AssertionError(f"quaternion not unit-norm: {det}")
                n_det += 1
        # each forward answers batch_size requests: the counted pass's forwards
        forwards = sum(1.0 / out["batch_size"] for _, out, _ in results)
        if abs(forwards - round(forwards)) > 1e-6:
            raise AssertionError(f"serve batch {batch}: batch sizes "
                                 f"{[o['batch_size'] for _, o, _ in results]}")
        forwards = round(forwards)
        if batch == 1:
            http_launches = counted
        # the requests replayed the graph: no wrapper call, and the device
        # counted one flat, one window and one scan launch a forward
        if any(calls.values()) or any(counted[k] != forwards * NMS_FORWARD[k] for k in COUNTED):
            raise AssertionError(f"serve batch {batch}: wrapper calls {calls}, launches counted "
                                 f"on the device {counted}, {forwards} forwards")

        # graph against the eager body, bit for bit, on three frames in a row
        # (random, planted, zeros): stale or aliased static buffers show here
        meta = torch.from_numpy(engine._meta0).to(engine.device)

        def eager(data):
            return engine._compiled.fn(data, meta)

        frames = [rng.randint(0, 255, (batch, HEIGHT, WIDTH, 3), np.uint8),
                  np.repeat(planted[None, :, :, ::-1], batch, 0),
                  np.zeros((batch, HEIGHT, WIDTH, 3), np.uint8)]
        names = ("label_2d", "rois", "poses_init", "poses_pred", "keep")
        for i, frame in enumerate(frames):
            data = torch.from_numpy(np.ascontiguousarray(frame)).to(engine.device)
            got = [t.clone() for t in engine.infer_device(data, meta)]
            want = eager(data)
            for name, g, w in zip(names, got, want):
                if not exact(g, w)[1]:
                    raise AssertionError(f"serve batch {batch}, frame {i}: the graph's {name} "
                                         f"differs from the eager body's: {exact(g, w)[0]}")
        # the planted frame's eager body with its Hough recorded (counts from
        # 0): flat, window and tile bit for bit to plain at the engine's
        # shapes, and the keep mask (the graph's, equal to it) bit for bit
        # to the host scan of the Hough output's suppression matrix
        data = torch.from_numpy(np.ascontiguousarray(frames[1])).to(engine.device)
        recorded, hough_out = Recorded(), []
        record, original = counting_hough(recorded)

        def kept_hough(*args, **kw):
            hough_out.append(record(*args, **kw))
            return hough_out[-1]

        for key in hk.LAUNCHES:
            hk.LAUNCHES[key] = 0
        posecnn_module.hough_voting = kept_hough
        try:
            label_2d, rois, poses_init, poses_pred, keep = eager(data)
        finally:
            posecnn_module.hough_voting = original
        errs = recorded_vs_plain(recorded, f"serve batch {batch}")
        (hough,) = hough_out
        host_keep = greedy_keep(per_class_suppression(hough.rois, engine.nms_threshold,
                                                      hough.valid))
        if not (torch.equal(hough.rois, rois) and torch.equal(keep, host_keep)):
            raise AssertionError(f"serve batch {batch}: the planted frame's keep mask "
                                 f"{keep.tolist()} is not the host scan's {host_keep.tolist()}")
        for name, t in (("rois", rois), ("poses_init", poses_init), ("poses_pred", poses_pred)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"non-finite {name}")
        cls = rois[:, 1].long()
        q = poses_pred.reshape(len(rois), -1, 4)[torch.arange(len(rois)), cls]
        if keep.any() and not bool(((q.norm(dim=1) - 1).abs()[keep] < 1e-3).all()):
            raise AssertionError("valid rows' quaternions are not unit-norm")
        graph_ms = device_ms(lambda: engine._compiled(data, meta), engine.device, 20)
        eager_ms = device_ms(lambda: engine._compiled.fn(data, meta), engine.device, 20)
        # the timed pass: request latency, the server's forward + fetch
        # (batch_seconds), and the request body's decode timed in process
        lat = np.sort([r[2] for r in timed])
        fwd = np.array([1e3 * out["batch_seconds"] for _, out, _ in timed])
        sizes = np.array([out["batch_size"] for _, out, _ in timed])
        decode = []
        for body in bodies_json:
            t = time.perf_counter()
            _decode_image(json.loads(body))
            decode.append((time.perf_counter() - t) * 1e3)
        parts.append(
            f"batch {batch} ({cfg_line}; engine set-up with the capture {setup_s:.1f} s): "
            f"counted pass {len(results)} requests in {forwards} forwards, launches counted on "
            f"the device {counted} (wrapper calls {calls}); {len(frames)} frames in a row graph == "
            f"eager bit for bit; the planted frame's Hough ({hough_shape(recorded)}) flat / "
            f"window / tile == plain bit for bit, max_abs_err {errs}; its keep mask == the host "
            f"scan bit for bit ({int(keep.sum())} of {int(hough.valid.sum())} valid rows kept); "
            f"forward with its NMS "
            f"{graph_ms:.4f} ms as the graph, {eager_ms:.4f} ms eager (CUDA events, mean "
            f"of 20); timed pass {len(timed)} requests ({n_det} detections in all): median "
            f"{float(np.median(lat)):.2f} ms, p90 {float(lat[int(0.9 * (len(lat) - 1))]):.2f} ms, "
            f"server forward + fetch (batch_seconds) median {float(np.median(fwd)):.2f} ms, batch "
            f"size median {float(np.median(sizes)):.1f} (mean {float(sizes.mean()):.2f}), request "
            f"body JSON + base64 decode {float(np.median(decode)):.2f} ms (in process, median of "
            f"{len(decode)})")
        del engine
        torch.cuda.empty_cache()
    print(f"phase 5 serve over HTTP, compiled, on {card}: " + " | ".join(parts), flush=True)
    return http_launches, bodies


def phase_validate(device):
    """The validation entry point's checks, in process."""
    from posecnn_torch.cli.validate import run_checks

    result = run_checks(device)
    print("phase 6 validate (posecnn_torch.cli.validate): " + json.dumps(result), flush=True)


def phase_full_width(device, card):
    """The full-width forward on the exhaustive backend, and with
    multi-instance Hough on c2f; returns each run's launch counts."""
    import torch

    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.models.posecnn import PoseCNN, init_weights
    from posecnn_torch.ops import hough_kernels as hk

    rng = np.random.RandomState(2)
    data = torch.from_numpy(rng.randn(1, HEIGHT, WIDTH, 3).astype(np.float32) * 40.0).to(device)
    extents = torch.from_numpy(planted_extents(NUM_CLASSES)).to(device)
    _, meta = intrinsics(HEIGHT, WIDTH)
    meta = torch.from_numpy(meta[None]).to(device)
    runs, parts = {}, []
    for name, kw in (("exhaustive", dict(hough_backend="exhaustive")),
                     ("multi-instance c2f", dict(hough_backend="c2f", vote_threshold=1.0,
                                                 vote_percentage=1e-4))):
        model = PoseCNN(NUM_CLASSES, num_units=64, fc_dim=4096, hough_num_samples=SAMPLES,
                        compute_dtype=torch.bfloat16, **kw)
        init_weights(model, 0)
        model = model.to(device)
        for key in hk.LAUNCHES:
            hk.LAUNCHES[key] = 0
        out = model(data, extents, meta)
        torch.cuda.synchronize()
        runs[name] = dict(hk.LAUNCHES)
        for field in ("log_prob", "poses_pred"):
            if not bool(torch.isfinite(getattr(out, field)).all()):
                raise AssertionError(f"{name} forward: non-finite {field}")
        for field in out.hough._fields:
            t = getattr(out.hough, field)
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} forward: non-finite hough {field}")
        ms = device_ms(lambda m=model: m(data, extents, meta), device, 10)
        parts.append(f"{name}: {int(out.hough.valid.sum())} valid RoIs, launches {runs[name]}, "
                     f"forward {ms:.3f} ms")
        del model, out
    if runs["exhaustive"]["tile"] < 1 or min(runs["multi-instance c2f"][k]
                                             for k in ("flat", "window")) < 1:
        raise AssertionError(f"a kernel of a full-width path never launched: {runs}")
    print(f"phase 7 full-width forward ({NUM_CLASSES} classes, {HEIGHT}x{WIDTH}, num_units 64, "
          f"fc_dim 4096, {SAMPLES} samples, bf16, batch 1, CUDA events after warm-up) on "
          f"{card}: " + "; ".join(parts), flush=True)
    return runs


def kernel_busy_ms(prof):
    """Device milliseconds of all kernels and copies torch.profiler
    recorded: the device-side events' self times (a CPU op's device time
    repeats its kernels')."""
    from torch.autograd import DeviceType

    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3


def top_kernels(prof, n, steps):
    """The n device-side events with the most device time, as
    'name ms-per-step' strings (names cut to 60 characters)."""
    from torch.autograd import DeviceType

    evs = sorted((ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA),
                 key=lambda ev: -ev.self_device_time_total)[:n]
    return [f"{ev.key[:60]} {ev.self_device_time_total / 1e3 / steps:.2f}" for ev in evs]


def top_host_ops(prof, n):
    """The n aten operators with the most host (self CPU) time, as
    'name calls ms' strings."""
    evs = sorted((ev for ev in prof.key_averages() if ev.key.startswith("aten::")),
                 key=lambda ev: -ev.self_cpu_time_total)[:n]
    return [f"{ev.key} {ev.count} {ev.self_cpu_time_total / 1e3:.2f}" for ev in evs]


def icp_profile(call, device):
    """Where one `icp_refine_batch` call's time goes: wall ms (host clock
    to a synchronise, with the profiler on), the device's busy ms and its
    kernel launches (torch.profiler), and the five aten operators with the
    most host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
    return wall_ms, kernel_busy_ms(prof), launches, top_host_ops(prof, 5)


def train_hough_inputs(tr, step, batch):
    """The Hough inputs of one train step, as (label (B, H, W), 1/8 vertex
    map (B, H/8, W/8, 3C)) pairs: "step", the model's training forward at
    the state's step (its dropout streams), as the step votes; "gt", the
    batch's GT labels and its vertex targets averaged over 8×8 blocks,
    which vote for the GT centres. Returns (the decompressed batch, the
    pairs)."""
    import torch

    from posecnn_torch.engine.train import decompress_feed, dropout_generators

    model = tr.model
    b = decompress_feed(batch, tr.cfg)
    gens = dropout_generators(tr.cfg.rng_seed, tr.state.step, tr.device)
    with torch.no_grad():
        c4, c5 = model.features(b["data"], b.get("data_p"))
        label = torch.argmax(model.seg_head(c4, c5, keep_prob=step.keep_prob,
                                            generator=gens[0]).float(), dim=-1)
        vert = model.vertex_head(c4, c5, keep_prob=step.keep_prob, generator=gens[1]).float()
        del c4, c5
    return b, {"step": (label, vert.contiguous()), "gt": gt_hough_inputs(tr, b)}


def gt_hough_inputs(tr, b):
    """The GT Hough inputs of a decompressed batch: its labels and its
    vertex targets averaged over the model's vertex factor, which vote for
    the GT centres."""
    import torch
    import torch.nn.functional as F

    from posecnn_torch.ops.losses import build_vertex_targets

    f = tr.model.hough_kw["vertex_factor"]
    with torch.no_grad():
        targets, _ = build_vertex_targets(b["label"], b["vertex_centers"], b["vertex_logz"],
                                          b["vertex_valid"],
                                          weight_inside=tr.cfg.train.vertex_w_inside)
        vert_gt = F.avg_pool2d(targets.permute(0, 3, 1, 2), f).permute(0, 2, 3, 1).contiguous()
    return b["label"], vert_gt


def kernels_vs_plain(kw, extents, meta, inputs, where):
    """flat, window and tile kernels against their plain versions, bit for
    bit, on the packed samples, boxes and window origins of each input
    pair (label (B, H, W), 1/f vertex map) at a Hough call's shapes (B·K
    slots, its `num_samples`, its vertex factor; `kw` is the model's
    `hough_kw`). The origins are those that call's c2f pass picks.
    Returns {input: (slots, live slots, samples, peak coarse vote)} and
    the largest error of each kernel."""
    import torch

    from posecnn_torch.ops import hough_kernels as hk
    from posecnn_torch.ops.hough_voting import prepare_votes

    s = kw["cell_stride"]
    shapes, errs = {}, {"tile": 0.0, "flat": 0.0, "window": 0.0}
    for name, (label, vert) in inputs.items():
        preps, packed, bboxes = prepare_votes(
            label, vert, extents, meta, skip_pixels=kw["skip_pixels"],
            num_samples=kw["num_samples"], vertex_factor=kw["vertex_factor"])
        h, w = label.shape[1] // s, label.shape[2] // s
        fine = dict(cell_stride=s, grid_h=h, grid_w=w)
        coarse = dict(cell_stride=s * hk.COARSE, grid_h=-(-h // hk.COARSE),
                      grid_w=-(-w // hk.COARSE))
        win = hk.hough_votes_c2f_windows(packed, bboxes, **fine)
        origins = torch.stack([win[2], win[3], win[4].long()], -1).reshape(-1, 3).int()
        origins = origins.contiguous()
        pairs = {
            "flat": (hk.hough_votes_flat(packed, bboxes, **coarse),
                     hk.hough_votes_flat_plain(packed, bboxes, **coarse)),
            "window": (hk.hough_votes_windows(packed, origins, **fine),
                       hk.hough_votes_windows_plain(packed, origins, **fine)),
            "tile": (hk.hough_votes_exhaustive(packed, bboxes, **fine),
                     hk.hough_votes_exhaustive_plain(packed, bboxes, **fine)),
        }
        for kernel, (got, want) in pairs.items():
            for a, c in zip(got, want):
                err, ok = exact(a, c)
                if not ok:
                    raise AssertionError(f"{KERNELS[kernel]} disagrees with its plain version "
                                         f"on {where}'s {name} inputs: max_abs_err {err}")
                errs[kernel] = max(errs[kernel], err)
        live = sum(int(p["slot_valid"].sum()) for p in preps)
        shapes[name] = (packed.shape[0], live, packed.shape[2],
                        float(pairs["flat"][1][0].max()))
    return shapes, errs


def train_hough_gate(tr, b, vert):
    """The training Hough of c2f against the exhaustive backend on one
    step's GT inputs at the step's vertex factor, as `cli/validate.py`
    gates the eval path: valid, targets and weights equal, the valid
    rows' rois within 1e-5. Returns (valid rows, matched rows, launches
    of each backend's run)."""
    import torch

    from posecnn_torch.ops import hough_kernels as hk
    from posecnn_torch.ops.hough_voting import hough_voting

    outs, launches = {}, {}
    for backend in ("c2f", "exhaustive"):
        for key in hk.LAUNCHES:
            hk.LAUNCHES[key] = 0
        kw = dict(tr.model.hough_kw, backend=backend)
        outs[backend] = hough_voting(b["label"], vert, tr.extents, b["meta"], b["gt_poses"],
                                     b["gt_valid"], is_train=True, **kw)
        torch.cuda.synchronize()
        launches[backend] = dict(hk.LAUNCHES)
    got, want = outs["c2f"], outs["exhaustive"]
    valid = want.valid
    for name in ("valid", "poses_target", "poses_weight", "domains"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"training Hough: c2f {name} != exhaustive")
    if not torch.allclose(got.rois[valid], want.rois[valid], rtol=0, atol=1e-5):
        raise AssertionError("training Hough: c2f rois != exhaustive rois")
    matched = int(((want.poses_weight.amax(1) > 0) & valid).sum())
    if int(valid.sum()) == 0 or matched == 0:
        raise AssertionError(f"training Hough gate: {int(valid.sum())} valid rows, {matched} "
                             "matched: nothing compared")
    if launches["c2f"]["flat"] < 1 or launches["c2f"]["window"] < 1 or (
            launches["exhaustive"]["tile"] < 1):
        raise AssertionError(f"training Hough gate: a kernel never launched: {launches}")
    return int(valid.sum()), matched, launches


def timed_steps(step, state, batches):
    """Run `step` (a callable of (state, batch)) on each batch (an iterator
    or a list) with CUDA events around each call. Returns (device ms per
    step, the run's launches as the kernels counted them on the device:
    eager launches and graph replays, metrics per step, host seconds spent
    waiting for batches, wall s)."""
    import torch

    from posecnn_torch.ops import hough_kernels as hk

    events, metrics, wait_s = [], [], 0.0
    hk.reset_device_launches()
    wall0 = time.perf_counter()
    it = iter(batches)
    while True:
        w0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        wait_s += time.perf_counter() - w0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step(state, batch))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    counted = hk.device_launches()
    return ([a.elapsed_time(b) for a, b in events], {k: counted[k] for k in COUNTED}, metrics,
            wait_s, wall)


def check_train_steps(launches, metrics):
    """The run launched the flat and window kernels once a step (as the
    kernels counted them on the device), each step's metrics are finite
    and each step supervised pose rows."""
    if launches["flat"] != len(metrics) or launches["window"] != len(metrics):
        raise AssertionError(f"{len(metrics)} train steps launched {launches}, not flat and "
                             "window once a step")
    for i, m in enumerate(metrics):
        values = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(list(values.values()))):
            raise AssertionError(f"train step {i}: non-finite metrics {values}")
        if values["num_pose_rois"] <= 0:
            raise AssertionError(f"train step {i}: no supervised pose rows")


# phase 8's equality gate: consecutive steps from one state; the eager steps
# it takes from a step's state where two of them differ; the bound on a
# gradient tensor's difference, as a share of its largest entry, five bf16
# ulps (2^-8 each): the trunk and heads run in bf16, where an fp32 add in
# another order that moves one rounding moves a value by an ulp, and two
# eager steps differ by up to ~2 of them (7.1e-3, PERF.md); and the seg
# head's bias that makes one class every pixel's label (random weights
# leave the vote no class above its 500-pixel label threshold)
GATE_STEPS, GATE_EAGER_RUNS, GRAD_TOL, LIVE_BIAS = 5, 4, 2e-2, 100.0


def step_outputs(step, state, batch, compiled):
    """One step of `step` (a `CompiledStep`) on `batch`, compiled or
    eagerly (`step.eager`): ([its metrics, lr included, as one fp64
    tensor], [each parameter's gradient as the update used it], [every
    parameter and buffer after it], [the optimizers' state tensors after
    it]), over every module the step trains (the GAN's discriminator
    too)."""
    import torch

    m = step(state, batch) if compiled else step.eager(state, batch)
    return ([torch.tensor([float(m[k]) for k in sorted(m)], dtype=torch.float64)],
            [p.grad.detach().clone() for p in trained_parameters(step)],
            [t.detach().clone() for mod in step.models() for t in mod.state_dict().values()],
            [t.detach().clone() for t in state.state_tensors()])


def trained_parameters(step):
    """The parameters of every module `step` trains, in order."""
    return [p for mod in step.models() for p in mod.parameters()]


def descend_on(step, state, grads):
    """The update alone, eagerly, on `grads` (one a trained parameter, as
    the update used them): the step's optimizer's move at the rate of its
    count (the gradient transforms already applied), then the GAN's
    discriminator Adam."""
    for p, g in zip(trained_parameters(step), grads):
        p.grad = g.clone()
    state.opt.prepare()
    state.opt.descend()
    if getattr(state, "d_opt", None) is not None:
        state.d_opt.step()


def distance(a, b) -> float:
    """The largest |difference| over matching tensors (lists of lists)."""
    return max(float((x.double() - y.double()).abs().max()) for xs, ys in zip(a, b)
               for x, y in zip(xs, ys) if x.numel())


def gradients_agree(got, eagers) -> float:
    """Each gradient tensor of `got` within the eager steps' own spread of
    it or within GRAD_TOL of its largest entry, from the nearest eager
    step. Returns the largest difference as a share of that entry."""
    worst = 0.0
    for i, g in enumerate(got):
        ref = [e[i] for e in eagers]
        scale = max(float(ref[0].abs().max()), 1e-30)
        near = min(float((g.double() - r.double()).abs().max()) for r in ref)
        spread = max(float((a.double() - b.double()).abs().max()) for j, a in enumerate(ref)
                     for b in ref[j + 1:])
        if near > max(spread, GRAD_TOL * scale):
            raise AssertionError(f"gradient {i}: {near:.3e} from the nearest eager one, whose "
                                 f"spread is {spread:.3e} and largest entry {scale:.3e}")
        worst = max(worst, near / scale)
    return worst


def live_hough_inputs(step, state, batch, where):
    """The posecnn family's preparation of the equality gate: make the seg
    head label every pixel with the class of the batch's first GT row
    (`LIVE_BIAS` on its output bias, in place), so that the steps after
    vote on live slots; then hold the vote kernels to plain on the Hough
    inputs of the state's training forward. Returns the gate's note: the
    live slots of those inputs."""
    import types

    import torch

    cls = int(batch["gt_poses"][batch["gt_valid"].bool()][0, 1])
    with torch.no_grad():
        step.model.seg_head.score_out.bias[cls] += LIVE_BIAS
    tr = types.SimpleNamespace(model=step.model, cfg=step.cfg, state=state,
                               device=step.extents.device)
    b, inputs = train_hough_inputs(tr, step, batch)
    shapes, _ = kernels_vs_plain(step.model.hough_kw, step.extents, b["meta"],
                                 {"live": inputs["step"]}, where)
    live = shapes["live"][1]
    return {"live_slots": live, "note": f"{live} live Hough slots in the first step's labels, "
                                        "the kernels == plain on them"}


# what one replayed training step launches: the posecnn step its c2f pair,
# the detection step the RPN's NMS scan
C2F_STEP = {"tile": 0, "flat": 1, "window": 1, "scan": 0, "kabsch": 0,
            "pose_hyp": 0, "pose_refine": 0}
DET_STEP = {"tile": 0, "flat": 0, "window": 0, "scan": 1, "kabsch": 0,
            "pose_hyp": 0, "pose_refine": 0}
# a replayed segmentation, video or GAN step's (the GAN yaml builds no
# pose head, so no Hough), and a replay of test_video's forward
NO_LAUNCH = {"tile": 0, "flat": 0, "window": 0, "scan": 0, "kabsch": 0,
             "pose_hyp": 0, "pose_refine": 0}


def equality_gate(step, state, batches, where, per_replay, prepare=None, resumed=False):
    """A compiled step (a `CompiledStep` of any family) against the same
    step eager over len(batches) consecutive steps from one state: the
    given state, readied by the family's `prepare(step, state, batch,
    where)` where it has one (the posecnn family's `live_hough_inputs`,
    which returns the gate's note), with the optimizer's count two updates
    before a step of the lr staircase; or, `resumed`, with the optimizer as
    a resume left it (count 0, the schedule offset to the restored step).
    The run is the compiled step's
    (replays of its graph); before each of its steps the state is kept
    (`bench.snapshot`, restored in place, as a graph reads it) and eager
    steps are run from it. A step is three parts, each held to its own
    bar. Its forward (every metric and lr): equal bit for bit where two
    eager steps are. Its backward (each gradient as the update used it):
    within the eager steps' spread, or GRAD_TOL of the tensor's largest
    entry, from the nearest eager step (GATE_EAGER_RUNS of them where two
    differ): the backward adds in a device-dependent order, and the update
    amplifies that in the parameters, where it cannot be told apart from a
    fault. Its update: the optimizers run eagerly from the same state on
    the compiled step's gradients (`descend_on`: the GAN's two) equal the
    compiled step's parameters and optimizer state (Adam's moments and
    steps, the momentum traces) bit for bit. The state kept and restored
    covers every module the step trains and every optimizer (the GAN's
    discriminator and its Adam too). The parameters' and the optimizer
    state's distances from the nearest eager step and between the eager
    steps are printed beside. The CUDA kernels' launches of the compiled
    steps are counted on the device and must be `per_replay` a step. The
    state is left restored to the one given. Returns `prepare`'s result
    (or {}) with the rows, the launches per replay and a line to print."""
    from posecnn_torch.bench import snapshot
    from posecnn_torch.engine.train import fastforward_opt_counts

    given = snapshot(step, state)
    prepared = prepare(step, state, batches[0], where) if prepare is not None else {}
    if resumed:
        if state.opt.count != 0:
            raise AssertionError(f"{where}: a resumed optimizer at count {state.opt.count}")
    else:
        fastforward_opt_counts(state.opt, step.cfg.train.stepsize - 2)
    lrs = [state.opt.schedule(state.opt.count + i) for i in range(len(batches))]
    if len(set(lrs)) < 2 and not resumed:
        raise AssertionError(f"{where}: the gate's steps cross no step of the lr staircase: {lrs}")
    start = snapshot(step, state)
    step(state, batches[0])  # make sure of the graph: a signature's first call runs eagerly
    start()
    counted = dict.fromkeys(COUNTED, 0)
    rows, forward_bitwise = [], 0
    for i, batch in enumerate(batches):
        at = snapshot(step, state)
        runs = []
        for _ in range(2):
            at()
            runs.append(step_outputs(step, state, batch, compiled=False))
        if distance(runs[0][:1], runs[1][:1]) != 0.0 or distance(runs[0][1:2], runs[1][1:2]) != 0.0:
            while len(runs) < GATE_EAGER_RUNS:
                at()
                runs.append(step_outputs(step, state, batch, compiled=False))
        at()
        got, _, launches = device_counted(lambda: step_outputs(step, state, batch, True))
        counted = {k: counted[k] + launches[k] for k in COUNTED}
        after = snapshot(step, state)
        # the update, eagerly, on the compiled step's gradients
        at()
        descend_on(step, state, got[1])
        update = distance([[t.detach() for mod in step.models() for t in mod.state_dict().values()],
                           [t.detach() for t in state.state_tensors()]], got[2:])
        after()
        forward = distance(got[:1], runs[0][:1])
        bitwise = all(distance(e[:1], runs[0][:1]) == 0.0 for e in runs)
        if (bitwise and forward != 0.0) or update != 0.0:
            raise AssertionError(f"{where}, step {i + 1}: the compiled step's metrics differ from "
                                 f"the eager step's by {forward:.3e} (eager steps bit for bit: "
                                 f"{bitwise}), its update from the eager update on its own "
                                 f"gradients by {update:.3e}")
        forward_bitwise += bitwise
        grads = gradients_agree(got[1], [e[1] for e in runs])
        rows.append((forward, grads, *(
            (min(distance([got[j]], [e[j]]) for e in runs),
             max(distance([a[j]], [b[j]]) for k, a in enumerate(runs) for b in runs[k + 1:]))
            for j in (2, 3))))
    if counted != {k: per_replay[k] * len(batches) for k in COUNTED}:
        raise AssertionError(f"{where}: {len(batches)} replayed steps launched {counted}, not "
                             f"{per_replay} a step")
    given()
    note = f"{prepared['note']}; " if "note" in prepared else ""
    line = (f"equality gate, {where}: {len(batches)} consecutive compiled steps (replays) from "
            f"one state ({note}lr {[float(f'{x:.3g}') for x in lrs]}), each against eager steps "
            f"from the same state: metrics and lr bit for bit in {forward_bitwise} of "
            f"{len(batches)} steps (where the eager steps are), the update on the compiled "
            f"gradients bit for bit in every step; by step, the gradients' largest difference "
            f"from the nearest eager step as a share of the tensor's largest entry (bar "
            f"{GRAD_TOL:g} or the eager spread), and the parameters' and optimizer state's "
            f"distance from the nearest eager step / between eager steps: "
            + "; ".join(f"{i + 1}: {g:.2e}, parameters {p[0]:.3e} / {p[1]:.3e}, state "
                        f"{o[0]:.3e} / {o[1]:.3e}" for i, (_, g, p, o) in enumerate(rows))
            + f"; launches in the compiled steps (device) {counted}")
    return {**prepared, "rows": rows, "launches_per_replay": dict(per_replay), "line": line}


def recording_dropout(step, recorded):
    """A stand-in for the model's `dropout` that, under graph capture,
    appends (generator index in `step.generators`, input, output) of each
    call to `recorded`: after each replay those tensors hold the replay's.
    Returns (the stand-in, the original)."""
    import torch

    from posecnn_torch.models import posecnn as posecnn_module

    original = posecnn_module.dropout

    def record(x, keep_prob, generator):
        out = original(x, keep_prob, generator)
        if torch.cuda.is_current_stream_capturing():
            index = next(i for i, g in enumerate(step.generators) if g is generator)
            recorded.append((index, x, out))
        return out

    return record, original


def bench_config_gate():
    """The equality gate on `bench train`'s configuration (22 classes,
    480×640, batch 2, momentum, its one batch five times), its compiled
    step's dropout recorded at its capture; then two more replays, each
    replay's dropout on each of its inputs equal to the same dropout drawn
    from fresh generators seeded by `SeedSequence([seed, step])`."""
    import torch

    from posecnn_torch import bench
    from posecnn_torch.engine.train import dropout_generators
    from posecnn_torch.models import posecnn as posecnn_module

    step, state, batch = bench.train_setup(torch.device("cuda"))
    recorded = []
    stand_in, original = recording_dropout(step, recorded)
    posecnn_module.dropout = stand_in
    try:
        gate = equality_gate(step, state, [batch] * GATE_STEPS,
                             "bench train's configuration (momentum)", C2F_STEP,
                             live_hough_inputs)
        streams = sorted(i for i, _, _ in recorded)  # fc9's only with a domain head
        if streams != list(range(len(streams))) or len(streams) < 4:
            raise AssertionError(f"the captured step's dropout streams: {streams}")
        checked = []
        for _ in range(2):
            step(state, batch)
            fresh = dropout_generators(step.cfg.rng_seed, state.step - 1, batch["data"].device)
            for index, x, out in recorded:
                if not torch.equal(out, original(x, step.keep_prob, fresh[index])):
                    raise AssertionError(f"a replay's dropout (stream {index}, step "
                                         f"{state.step - 1}) differs from a fresh generator's")
            checked.append(state.step - 1)
    finally:
        posecnn_module.dropout = original
    gate["line"] += (f"; each of the {len(streams)} dropout streams of the replays at steps "
                     f"{checked} equal to fresh generators' of SeedSequence([seed, step]), bit "
                     "for bit")
    return gate


def phase_train(card):
    """The training path at full width; returns the vote kernels' launches
    per replayed step of the compiled step (counted on the device)."""
    import gc
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from posecnn_torch.cli import train_net
    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.engine.train import CompiledTrainStep, TrainStep
    from posecnn_torch.ops.hough_voting import _prepare_slots, hough_voting

    # the flagship yaml sets hough_backend "xla" to get around a TPU
    # Mosaic compile failure at batch 16 (lov_color_2d_pool_b16.yaml:37-38);
    # the card's kernels do not have it, so the TrainConfig default
    # "auto" (c2f) runs here
    args = train_net.make_parser().parse_args(
        ["--cfg", TRAIN_CFG, "--set", "train.hough_backend=auto"])
    t0 = time.perf_counter()
    tr = train_net.build_trainer(args, train_net.load_config(args))
    t = tr.cfg.train
    batch_size = t.ims_per_batch
    # the trainer's step, as train_net runs it: compiled (one CUDA graph)
    step = tr.step
    if not isinstance(step, CompiledTrainStep):
        raise AssertionError(f"train_net's posecnn step is {type(step).__name__}, not compiled")

    def eager(state, batch):  # the same step, launch by launch
        return TrainStep.__call__(step, state, batch)

    before = [p.detach().clone() for p in tr.model.parameters()]
    setup_s = time.perf_counter() - t0
    runs = {}
    try:
        for _ in range(TRAIN_WARMUP):  # the first: the batch's real step, then the capture
            step(tr.state, next(tr.batches))
        warm_s = time.perf_counter() - t0 - setup_s
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # with the feed's two render threads running, as training runs
        for name, call in (("compiled", step), ("eager", eager)):
            tr.batches.gets = tr.batches.dry = 0
            runs[name] = (*timed_steps(call, tr.state, itertools.islice(tr.batches, TRAIN_TIMED)),
                          tr.batches.dry, tr.batches.gets)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        held = [next(tr.batches) for _ in range(GATE_STEPS)]
    finally:
        tr.batches.close()
    produce = sorted(tr.batches.produce_seconds)
    for name, (_, launches, metrics, *_) in runs.items():
        check_train_steps(launches, metrics)
    feed_ms, feed_launches, metrics, wait_s, feed_wall, dry, gets = runs["compiled"]

    # one more step by its parts (eager between the replays): its gradients
    # as backward left them (the update rewrites them in place with the
    # decay and the clip)
    total, _ = step.forward(tr.state, held[2])
    step.backward(total)
    bad = [n for n, p in tr.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad or not bool(torch.isfinite(total)):
        raise AssertionError(f"loss {float(total)}; missing or non-finite gradients: {bad[:5]}")
    step.update(tr.state)
    del total
    still = [n for (n, p), b in zip(tr.model.named_parameters(), before) if torch.equal(p, b)]
    if still:
        raise AssertionError(f"parameters that did not move: {still[:5]}")
    del before

    # the same steps with the feed's threads stopped, on held batches
    alone = {}
    for name, call in (("compiled", step), ("eager", eager)):
        alone[name] = timed_steps(call, tr.state, held[:3] * 2)
        check_train_steps(alone[name][1], alone[name][2])
    alone_ms, alone_launches = alone["compiled"][:2]
    per_replay = {k: v / len(alone_ms) for k, v in alone_launches.items()}
    if (step.compiled.programs and len(step.compiled.programs) != 1) or any(
            p.launches != FORWARD_BODY for p in step.compiled.programs.values()):
        raise AssertionError(f"phase 8: the compiled step's graphs launch "
                             f"{[p.launches for p in step.compiled.programs.values()]}")
    # one batch produced with nothing else running (a fresh producer:
    # its first call fills the pool, the next renders the fresh scenes)
    make_batch = tr.make_batch_factory(2)
    p0 = time.perf_counter()
    make_batch()
    fill_s = time.perf_counter() - p0
    p0 = time.perf_counter()
    make_batch()
    produce_alone_s = time.perf_counter() - p0

    # the split of one step, twice: forward (Hough inside), backward, update
    split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for batch in held[:2]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, _ = step.forward(tr.state, batch)
        ev[1].record()
        step.backward(total)
        ev[2].record()
        step.update(tr.state)
        ev[3].record()
        torch.cuda.synchronize()
        for j, name in enumerate(split):
            split[name] += ev[j].elapsed_time(ev[j + 1]) / 2
    # Hough alone on a step's inputs, and one image's sample prep
    b, hough_inputs = train_hough_inputs(tr, step, held[0])
    label, vert = hough_inputs["step"]
    kw = tr.model.hough_kw

    def hough():
        return hough_voting(label, vert, tr.extents, b["meta"], b["gt_poses"], b["gt_valid"],
                            is_train=True, **kw)

    hough_ms = device_ms(hough, tr.device, 5)
    h0 = time.perf_counter()
    for _ in range(5):
        hough()
    hough_host_ms = (time.perf_counter() - h0) / 5 * 1e3  # enqueue only, no synchronise
    torch.cuda.synchronize()
    prep_ms = device_ms(lambda: _prepare_slots(
        label[0], vert[0], tr.extents, b["meta"][0], num_classes=t.num_classes,
        label_threshold=500, skip_pixels=kw["skip_pixels"], num_samples=kw["num_samples"],
        max_classes=8, vertex_factor=8), tr.device, 10)

    # the device's busy share over two steps of each (profiled, so the
    # host is slower)
    busy = {}
    for name, call in (("eager", eager), ("compiled", step)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            p0 = time.perf_counter()
            for batch in held[:2]:
                call(tr.state, batch)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - p0) * 1e3
        busy[name] = (kernel_busy_ms(prof) / 2, prof_wall_ms)  # per step
        if name == "eager":
            top = top_kernels(prof, 10, 2)
    busy_ms, prof_wall_ms = busy["eager"]

    # FLOPs of one step (the forward and backward products and convolutions;
    # a replay runs no operator the counter sees, so the eager step)
    with FlopCounterMode(display=False) as counter:
        eager(tr.state, held[2])
    flops = counter.get_total_flops()

    # the kernels against their plain versions at the training Hough's
    # shapes, then c2f against the exhaustive backend on the GT inputs
    vote_shapes, vote_errs = kernels_vs_plain(tr.model.hough_kw, tr.extents, b["meta"],
                                              hough_inputs, "the train step")
    if vote_shapes["gt"][1] == 0 or vote_shapes["gt"][3] <= 0:
        raise AssertionError("the train step's GT inputs gave no live slot: nothing compared")
    valid_rows, matched, gate_launches = train_hough_gate(tr, b, hough_inputs["gt"][1])
    # the compiled step against the eager one from one state, with live
    # Hough slots and a step of the staircase (the gate resets both after)
    gate = equality_gate(step, tr.state, held, "phase 8 flagship (adam)", C2F_STEP,
                         live_hough_inputs)
    ms, ms_feed = float(np.mean(alone_ms)), float(np.mean(feed_ms))
    ms_eager = float(np.mean(alone["eager"][0]))
    wall_feed = 1e3 * feed_wall / TRAIN_TIMED
    e_ms, _, _, e_wait_s, e_wall, e_dry, e_gets = runs["eager"]
    wall_feed_eager = 1e3 * e_wall / TRAIN_TIMED
    dtype = str(tr.model.trunk.compute_dtype).removeprefix("torch.")
    c_busy_ms, c_prof_wall_ms = busy["compiled"]
    print(f"phase 8 train step at full width (r6 phase-B flagship, {t.num_classes} classes, "
          f"{t.syn_height}x{t.syn_width}, batch {batch_size}, num_units {t.num_units}, fc_dim "
          f"{t.fc_dim}, {t.optimizer}, grad_clip {t.grad_clip}, pool {t.syn_pool_size}/"
          f"{t.syn_pool_fresh} fresh, hough_backend auto = c2f, {dtype}) on {card}, train_net's "
          f"compiled step (one CUDA graph, replayed) beside the same step eager: set-up "
          f"{setup_s:.1f} s, first batches, the real first step, the capture and a replay "
          f"{warm_s:.1f} s; {TRAIN_TIMED} steps each with the feed's 2 threads running: ms per "
          f"step (CUDA events) compiled {', '.join(f'{x:.2f}' for x in feed_ms)} (mean "
          f"{ms_feed:.2f}), wall {wall_feed:.2f} ms per step, "
          f"{batch_size * TRAIN_TIMED / feed_wall:.1f} images/s, waited on the feed "
          f"{1e3 * wait_s / TRAIN_TIMED:.2f} ms per step, queue dry at {dry} of {gets} gets; "
          f"eager {', '.join(f'{x:.2f}' for x in e_ms)} (mean {float(np.mean(e_ms)):.2f}), wall "
          f"{wall_feed_eager:.2f} ms per step, {batch_size * TRAIN_TIMED / e_wall:.1f} images/s, "
          f"waited {1e3 * e_wait_s / TRAIN_TIMED:.2f} ms per step, dry at {e_dry} of {e_gets}; "
          f"batch production median {1e3 * produce[len(produce) // 2]:.1f} ms (max "
          f"{1e3 * produce[-1]:.1f}) over {len(produce)} batches, peak memory {peak_gb:.2f} GB; "
          f"{len(alone_ms)} steps each with the feed stopped: ms per step compiled "
          f"{', '.join(f'{x:.2f}' for x in alone_ms)} (mean {ms:.2f}, "
          f"{1e3 * batch_size / ms:.1f} images/s), eager "
          f"{', '.join(f'{x:.2f}' for x in alone['eager'][0])} (mean {ms_eager:.2f}, "
          f"{1e3 * batch_size / ms_eager:.1f} images/s); one batch produced alone "
          f"{1e3 * produce_alone_s:.1f} ms ({1e3 * fill_s:.1f} ms for the first, which fills "
          f"the pool with {batch_size} renders); split of the eager step (CUDA events, mean of "
          f"2, feed stopped): forward {split['forward']:.2f} ms (Hough inside), backward "
          f"{split['backward']:.2f} ms, optimizer {split['optimizer']:.2f} ms; Hough alone "
          f"{hough_ms:.2f} ms device, {hough_host_ms:.2f} ms host enqueue, _prepare_slots "
          f"{prep_ms:.3f} ms an image; device busy per step (profiler, 2 steps each) eager "
          f"{busy_ms:.2f} ms, {100 * busy_ms / (prof_wall_ms / 2):.1f}% of its wall "
          f"({prof_wall_ms / 2:.1f} ms), compiled {c_busy_ms:.2f} ms, "
          f"{100 * c_busy_ms / (c_prof_wall_ms / 2):.1f}% of its wall ({c_prof_wall_ms / 2:.1f} "
          f"ms), {100 * busy_ms / wall_feed:.1f}% of the compiled wall with the feed; top device "
          f"events of the eager step, ms per step: {'; '.join(top)}; "
          f"{flops / 1e12:.3f} TFLOP per step (FlopCounterMode), "
          f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s compiled, MFU "
          f"{100 * flops / (ms / 1e3) / PEAK_BF16_FLOPS:.2f}% of 989 TFLOP/s bf16 at the "
          f"compiled feed-stopped rate ({100 * flops / (ms_eager / 1e3) / PEAK_BF16_FLOPS:.2f}% "
          f"eager; {100 * flops / (wall_feed / 1e3) / PEAK_BF16_FLOPS:.2f}% at the compiled wall "
          f"with the feed); launches (counted on the device) in the {TRAIN_TIMED} compiled steps "
          f"with the feed {feed_launches}, per replayed step {per_replay}; final loss "
          f"{float(metrics[-1]['loss']):.4f}, pose rows {float(metrics[-1]['num_pose_rois']):.0f}"
          f"; flat, window and tile kernels == plain, bit for bit, at the training Hough's "
          f"shapes (slots, live slots, samples, peak coarse vote): "
          + ", ".join(f"{n} inputs {v[:3]}, {v[3]:.1f}" for n, v in vote_shapes.items())
          + f", max_abs_err {vote_errs}; training Hough c2f == exhaustive on a step's GT inputs "
          f"at vertex factor {kw['vertex_factor']}: {valid_rows} valid rows, {matched} matched, "
          f"launches {gate_launches}; {gate['line']}", flush=True)
    del tr, step, held, b, hough_inputs, label, vert
    gc.collect()
    torch.cuda.empty_cache()
    # the gate on `bench train`'s configuration (momentum, batch 2), with
    # a replay's dropout held to fresh generators'
    momentum = bench_config_gate()
    print(f"phase 8 {momentum['line']}", flush=True)
    return {"per_replayed_step": per_replay,
            "flagship_gate": {k: gate[k] for k in ("launches_per_replay", "live_slots")},
            "momentum_gate": {k: momentum[k] for k in ("launches_per_replay", "live_slots")}}


def summaries_agree(got, want, tol=1e-5):
    """Two `PoseEvaluator.summarize()` results: counts, success rates and
    seg IoU equal, every other number within `tol`. Returns the largest
    difference; raises on a disagreement."""
    if set(got) != set(want) or set(got["per_class"]) != set(want["per_class"]):
        raise AssertionError("evaluator summaries have different keys")
    if got["seg_iou_per_class"] != want["seg_iou_per_class"] or (
            got["num_images"] != want["num_images"]):
        raise AssertionError("evaluator summaries: seg IoU or image counts differ")
    worst = 0.0
    pairs = [(got, want, k) for k in ("add_auc", "adds_auc", "seg_mean_iou") if k in want]
    pairs += [(g, want["per_class"][c], k) for c, g in got["per_class"].items() for k in g]
    for g, w, k in pairs:
        if k in ("count", "success_rate", "reproj_success_rate"):
            if g[k] != w[k]:
                raise AssertionError(f"evaluator summaries: {k} {g[k]} != {w[k]}")
        elif not (g[k] == w[k] or abs(g[k] - w[k]) <= tol):
            raise AssertionError(f"evaluator summaries: {k} {g[k]} vs {w[k]} beyond {tol}")
        elif g[k] != w[k]:
            worst = max(worst, abs(g[k] - w[k]))
    return worst


def icp_card_vs_cpu(scene, device, rot_perturb, num_iters):
    """One scene of `test_icp`'s drive refined on the card and on the CPU,
    held by tests/test_torch_icp.py's scene rule: after one iteration
    every hypothesis within ICP_ATOL_STEP; after `num_iters`, at least
    ICP_SHARE of them within ICP_ATOL and 1/P, and every refined pose
    within ICP_ATOL where the CPU's winning margin exceeds 2/P. Returns
    (largest one-step difference, share of converged hypotheses within
    the tolerance, largest refined-pose difference)."""
    import torch

    from posecnn_torch.cli import test_icp

    points = scene["model_pts"].shape[1]
    out = []
    for iters in (1, num_iters):
        res = test_icp.refine_scene(scene, device, iters, rot_perturb)
        ref = test_icp.refine_scene(scene, torch.device("cpu"), iters, rot_perturb)
        d_rt = (res.hypothesis_rts.cpu() - ref.hypothesis_rts).abs().flatten(2).amax(-1)
        d_score = (res.hypothesis_scores.cpu() - ref.hypothesis_scores).abs()
        out.append((d_rt, d_score, res, ref))
    step = float(out[0][0].max())
    d_rt, d_score, res, ref = out[1]
    share = float(((d_rt <= ICP_ATOL) & (d_score <= 1.0 / points + 1e-6)).float().mean())
    top2 = ref.hypothesis_scores.sort(dim=1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2.0 / points
    d_pose = torch.cat([(res.quat.cpu() - ref.quat).abs(), (res.trans.cpu() - ref.trans).abs()],
                       1)[clear]
    pose = float(d_pose.max()) if d_pose.numel() else 0.0
    if not (step <= ICP_ATOL_STEP and share >= ICP_SHARE and pose <= ICP_ATOL):
        raise AssertionError(f"ICP on the card vs the CPU: one step {step}, converged share "
                             f"{share} within {ICP_ATOL}, refined poses {pose}")
    return step, share, pose


# phase 9 (e): estimate_pose_3d's correspondences and hypotheses (the
# JAX default hypothesis count at 4096 points: tests/test_torch_ransac.py's
# scene, scaled; and a scene larger than a block's shared memory, 227 KB),
# its inlier threshold, and the bars of its kernels against their plain
# versions: R where the covariance's singular values stand apart by 1e-3 of
# the largest, as tests/test_torch_ransac.py compares R to JAX's, and t
# there; trace(R·cov), which every maximiser attains, on every matrix; an
# inlier count up to the points whose fp64 error lies within POSE_BAND of
# the threshold (relative) under either fit, or on either side of it
POSE_POINTS, POSE_HYPOTHESES, POSE_THRESHOLD = 4096, 256, 0.01
POSE_POINTS_LARGE = 65536
KABSCH_GAP, KABSCH_R_TOL, KABSCH_TRACE_TOL = 1e-3, 1e-4, 1e-5
POSE_T_TOL, POSE_BAND = 1e-5, 1e-5
# fp32 operations of one inlier test |R s + t - d| < threshold (R s + t - d
# 21, the squared norm 5, the root, the compare), of one hypothesis' fit
# but its rotation (the weight sum 3, the means 36, the centred covariance
# 126, t 18), and of an inlier in a refinement round (its count and sums 7,
# its centred products 24)
TEST_OPS, FIT_OPS, INLIER_OPS = 28, 183, 31


def pose_scene(n, seed=0):
    """n 3D-3D correspondences of one rigid pose (RandomState(seed)), 2 mm
    noise, 30% gross outliers: (obj, cam, valid, R, t) as numpy."""
    from posecnn_torch.utils.quaternion import quat_to_mat_np

    rng = np.random.RandomState(seed)
    q = rng.randn(4)
    r = quat_to_mat_np(q / np.linalg.norm(q)).astype(np.float32)
    t = np.array([0.1, -0.05, 0.9], np.float32)
    obj = ((rng.rand(n, 3) - 0.5) * 0.2).astype(np.float32)
    cam = obj @ r.T + t + rng.randn(n, 3).astype(np.float32) * 0.002
    cam[: n * 3 // 10] += rng.rand(n * 3 // 10, 3).astype(np.float32) * 0.5
    return obj, cam.astype(np.float32), np.ones(n, bool), r, t


def kabsch_ops(sweeps):
    """fp32 operations of `kabsch_one` on matrices that ran `sweeps` (a
    tensor): per matrix the scaling (9), three column-pair tests a sweep
    (15 each: three 3-vector dots), one column rotation (46: the angle and
    two column pairs of A and V) in each sweep but the last (a further
    sweep ran because one rotated, at least), and the assembly of R (93)."""
    n, total = int(sweeps.numel()), float(sweeps.sum())
    return n * (9 + 93) + 45 * total + 46 * (total - n)


def bound_of(bytes_, ops):
    """(the least ms: bytes over the memory rate or fp32 operations over the
    fp32 peak, whichever is larger, "bytes" or "operations", bytes, ops)."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
    return (t_bytes, "bytes", bytes_, ops) if t_bytes >= t_ops else (t_ops, "operations", bytes_,
                                                                      ops)


def kabsch_bound(sweeps):
    """The least time of the Kabsch kernel on these inputs: its bytes (each
    3x3 fp32 matrix read and its rotation written) against its operations
    (`kabsch_ops`). Returns `bound_of`'s tuple."""
    return bound_of(72 * int(sweeps.numel()), kabsch_ops(sweeps))


def pose_hypotheses_bound(n, hyp, sweeps):
    """The least time of `pose_hypotheses_kernel` at N = n, Hyp = hyp: the
    points read (N·25 bytes), the triples read and the fits and scores
    written (Hyp·(24 + 48 + 8)), against TEST_OPS a (hypothesis, point)
    pair, FIT_OPS a fit and its rotation's `kabsch_ops` by `sweeps`, those
    `kabsch_kernel` ran on the hypotheses' covariances. Returns
    `bound_of`'s tuple."""
    return bound_of(25 * n + 80 * hyp, TEST_OPS * n * hyp + FIT_OPS * hyp + kabsch_ops(sweeps))


def pose_refine_bound(n, hyp, inliers, sweeps):
    """The least time of `pose_refine_kernel` at N = n, Hyp = hyp, given each
    round's inliers (the plain version's) and the sweeps `kabsch_kernel` ran
    on a refinement's covariance (a tensor of one): the points (N·25 bytes),
    the scores (Hyp·8) and the best fit (48) read, the pose (56) written,
    against the argmax's Hyp compares, an inlier test a point a round and in
    the final count, a valid count a point, INLIER_OPS an inlier a round,
    and in each round of at least 3 inliers a rotation of those sweeps
    (`kabsch_ops`) with its means and t (24). Returns `bound_of`'s tuple."""
    ran = sum(c >= 3 for c in inliers)
    ops = (hyp + TEST_OPS * n * (len(inliers) + 1) + n + INLIER_OPS * sum(inliers)
           + ran * (kabsch_ops(sweeps) + 24))
    return bound_of(25 * n + 8 * hyp + 48 + 56, ops)


def refine_inliers(obj, cam, valid, hyps, threshold, num_refine):
    """Each refinement round's inliers under `pose_refine_plain`: round k
    takes those of the pose after k rounds."""
    from posecnn_torch.refine import ransac

    return [float(ransac.pose_refine_plain(obj, cam, valid, *hyps, threshold, k).inliers)
            for k in range(num_refine)]


def kabsch_vs_plain(cov, where):
    """`kabsch_kernel` against its plain version (the SVD on the card) on
    the covariances cov (n, 3, 3): R within KABSCH_R_TOL where the singular
    values stand apart by KABSCH_GAP of the largest, trace(R·cov) within
    KABSCH_TRACE_TOL of the singular values' sum everywhere. Returns (the
    largest |ΔR| over those matrices, how many, the largest relative trace
    difference, the kernel's sweeps)."""
    import torch

    from posecnn_torch.refine.ransac import kabsch_rotation, kabsch_rotation_plain

    got, sweeps = kabsch_rotation(cov, sweeps=True)
    want = kabsch_rotation_plain(cov)
    sv = torch.linalg.svdvals(cov.double())
    gap = torch.minimum(sv[:, 0] - sv[:, 1], sv[:, 1] - sv[:, 2]) / sv[:, 0].clamp(min=1e-30)
    apart = gap > KABSCH_GAP
    d_r = (got - want).abs().flatten(1).amax(1)
    err = float(d_r[apart].max()) if bool(apart.any()) else 0.0
    trace = (torch.einsum("nij,nji->n", got.double(), cov.double())
             - torch.einsum("nij,nji->n", want.double(), cov.double())).abs()
    rel = float((trace / sv.sum(1).clamp(min=1e-30)).max())
    orth = float((got @ got.transpose(1, 2) - torch.eye(3, device=cov.device)).abs().max())
    if err > KABSCH_R_TOL or rel > KABSCH_TRACE_TOL or orth > 1e-5 or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{KABSCH_KERNEL} disagrees with its plain version at {where}: "
                             f"|dR| {err} on {int(apart.sum())} separated matrices, trace "
                             f"{rel}, |R R^T - I| {orth}")
    return err, int(apart.sum()), rel, sweeps


def fit_errors(obj, cam, r, t):
    """|R s + t - d| in fp64 of each fit r (H, 3, 3), t (H, 3) at every
    point of obj, cam (N, 3): (H, N)."""
    pred = obj.double() @ r.double().transpose(-1, -2) + t.double()[..., None, :]
    return (pred - cam.double()).norm(dim=-1)


def count_slack(err_a, err_b, valid, threshold):
    """(the fp64 inlier count under fit a (H,), the valid points per fit
    whose count may differ between fits a and b: an fp64 error within
    POSE_BAND of the fp32 threshold under either, or the two on either
    side (H,), those under fit a alone (H,))."""
    thr = float(np.float32(threshold))
    near_a = (err_a - thr).abs() <= POSE_BAND * thr
    near_b = (err_b - thr).abs() <= POSE_BAND * thr
    sides = (err_a < thr) != (err_b < thr)
    return (((err_a < thr) & valid).sum(-1), ((near_a | near_b | sides) & valid).sum(-1),
            (near_a & valid).sum(-1))


def pose_hypotheses_vs_plain(obj, cam, valid, triples, threshold, where, chunk=64):
    """`pose_hypotheses_kernel` against `pose_hypotheses_plain` (the SVD on
    the card for its rotations) on one input: R within KABSCH_R_TOL and t
    within POSE_T_TOL where the hypothesis' covariance has its singular
    values apart by KABSCH_GAP; on every usable hypothesis R finite and
    trace(R·cov) within KABSCH_TRACE_TOL of the singular values' sum of the
    plain version's (every maximiser attains it, so this holds the fits of
    rank-deficient triples too); the same hypotheses usable; each usable
    score equal to the fp64 count of its own fit up to its points near the
    threshold, and to the plain version's up to `count_slack`. Returns the
    stats."""
    import torch

    from posecnn_torch.refine import ransac

    rs, ts, scores = ransac.pose_hypotheses(obj, cam, valid, triples, threshold)
    rs_p, ts_p, scores_p = ransac.pose_hypotheses_plain(obj, cam, valid, triples, threshold)
    cov = ransac.weighted_covariance(obj[triples].double(), cam[triples].double(),
                                     valid[triples].double())[0]
    sv = torch.linalg.svdvals(cov)
    apart = torch.minimum(sv[:, 0] - sv[:, 1], sv[:, 1] - sv[:, 2]) > KABSCH_GAP * sv[:, 0]
    d_r = (rs - rs_p).abs().flatten(1).amax(1)[apart]
    d_t = (ts - ts_p).abs().amax(1)[apart]
    r_err = float(d_r.max()) if d_r.numel() else 0.0
    t_err = float(d_t.max()) if d_t.numel() else 0.0
    usable = scores >= 0
    trace = (torch.einsum("nij,nji->n", rs.double(), cov)
             - torch.einsum("nij,nji->n", rs_p.double(), cov)).abs() / sv.sum(1).clamp(min=1e-30)
    trace_err = float(trace[usable].max()) if bool(usable.any()) else 0.0
    own_off = differ = max_diff = 0
    for lo in range(0, triples.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        err = fit_errors(obj, cam, rs[sl], ts[sl])
        count, slack, near = count_slack(err, fit_errors(obj, cam, rs_p[sl], ts_p[sl]), valid,
                                         threshold)
        off = torch.where(usable[sl], (scores[sl] - count).abs(), 0)
        diff = (scores[sl] - scores_p[sl]).abs()
        if bool((off > near).any()) or bool((diff > torch.where(usable[sl], slack, 0)).any()):
            raise AssertionError(f"pose_hypotheses_kernel's scores at {where}: off the fp64 "
                                 f"count by {off.tolist()} (near {near.tolist()}), off the "
                                 f"plain version by {diff.tolist()} (slack {slack.tolist()})")
        own_off += int((off > 0).sum())
        differ += int((diff > 0).sum())
        max_diff = max(max_diff, int(diff.max()))
    if (r_err > KABSCH_R_TOL or t_err > POSE_T_TOL or trace_err > KABSCH_TRACE_TOL
            or not torch.equal(usable, scores_p >= 0)
            or not bool(torch.isfinite(rs).all() and torch.isfinite(ts).all())):
        raise AssertionError(f"pose_hypotheses_kernel disagrees with its plain version at {where}: "
                             f"|dR| {r_err}, |dt| {t_err} on {int(apart.sum())} separated fits, "
                             f"trace {trace_err} on {int(usable.sum())} usable, usable "
                             f"{int(usable.sum())} / {int((scores_p >= 0).sum())}")
    return dict(shape=[obj.shape[0], triples.shape[0]], max_abs_err=max(r_err, t_err),
                r_err=r_err, t_err=t_err, trace_rel_err=trace_err, compared=int(apart.sum()),
                usable=int(usable.sum()), scores_off_fp64=own_off, scores_differ=differ,
                max_score_diff=max_diff)


def pose_refine_vs_plain(obj, cam, valid, hyps, threshold, num_refine, where, exact=False):
    """`pose_refine_kernel` against `pose_refine_plain` on the same
    hypotheses: R within KABSCH_R_TOL, t within POSE_T_TOL, the inliers
    equal (`exact`) or within `count_slack` of the two final fits, the score
    the inliers over the valid entries. Returns the stats."""
    import torch

    from posecnn_torch.refine import ransac

    got = ransac.pose_refine(obj, cam, valid, *hyps, threshold, num_refine)
    want = ransac.pose_refine_plain(obj, cam, valid, *hyps, threshold, num_refine)
    r_err = float((got.rotation - want.rotation).abs().max())
    t_err = float((got.translation - want.translation).abs().max())
    _, slack, _ = count_slack(fit_errors(obj, cam, got.rotation[None], got.translation[None]),
                              fit_errors(obj, cam, want.rotation[None], want.translation[None]),
                              valid, threshold)
    d_inl = float((got.inliers - want.inliers).abs())
    share = torch.where(got.inliers > 0, got.inliers / valid.sum().clamp(min=1), 0.0)
    if (r_err > KABSCH_R_TOL or t_err > POSE_T_TOL or d_inl > (0 if exact else float(slack[0]))
            or not torch.equal(got.score, share.float())):
        raise AssertionError(f"pose_refine_kernel disagrees with its plain version at {where}: "
                             f"|dR| {r_err}, |dt| {t_err}, inliers {float(got.inliers)} / "
                             f"{float(want.inliers)} (slack {int(slack[0])}), score "
                             f"{float(got.score)} / {float(want.score)}")
    return dict(shape=[obj.shape[0], hyps[2].shape[0]], max_abs_err=max(r_err, t_err),
                r_err=r_err, t_err=t_err, inliers=float(got.inliers),
                plain_inliers=float(want.inliers))


def ransac_pose_check(device):
    """Phase 9 (e): `estimate_pose_3d` at (POSE_POINTS, POSE_HYPOTHESES) as a
    compiled program against its eager body (bit for bit; three replays
    counted on the device: `pose_hypotheses_kernel` and
    `pose_refine_kernel` once a replay, no other kernel), both timed; the
    pose against the truth; the two kernels against their plain versions
    there and at POSE_POINTS_LARGE points (`pose_hypotheses_vs_plain`,
    `pose_refine_vs_plain`), the whole plain body against the kernels' (the
    same best hypothesis, R, t, inliers), each kernel timed as a graph of
    launches, per wrapper call and its plain version, with its bound (from
    the sweeps `kabsch_kernel` runs on the same covariances and the plain
    version's inliers a round); `kabsch_kernel` against its plain version at
    the program's covariances (the hypotheses' and a refinement's), timed
    likewise with torch.linalg.svd. Returns (line, {kernel: its entry for
    the kernels line})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.refine import ransac
    from posecnn_torch.utils.graph import compile_static

    def scene(n, seed):
        obj_np, cam_np, valid_np, r_true, t_true = pose_scene(n, seed)
        obj, cam, valid = (torch.from_numpy(a).to(device) for a in (obj_np, cam_np, valid_np))
        triples = ransac.draw_hypotheses(valid, POSE_HYPOTHESES, 3,
                                         torch.Generator().manual_seed(seed), n_valid=n)
        return (obj, cam, valid, triples), r_true, t_true

    args, r_true, t_true = scene(POSE_POINTS, 0)
    obj, cam, valid, triples = args
    thr, kw = POSE_THRESHOLD, dict(inlier_threshold=POSE_THRESHOLD)
    eager = partial(ransac.estimate_pose_3d, *args, **kw)
    program = compile_static(ransac.estimate_pose_3d)
    compiled = partial(program, *args, **kw)
    _, eager_calls, _ = device_counted(eager)
    want = eager()
    tree_exact(tree_map(lambda x: x.clone(), compiled()), want, "estimate_pose_3d compiled vs eager")
    replays = 3
    outs, calls, counted = device_counted(lambda: [tree_map(lambda x: x.clone(), compiled())
                                                   for _ in range(replays)])
    for out in outs:
        tree_exact(out, want, "estimate_pose_3d replay vs eager")
    per = {k: counted[k] / replays for k in COUNTED}
    two = {**NO_LAUNCH, "pose_hyp": 1, "pose_refine": 1}
    if any(calls.values()) or per != two or eager_calls != two:
        raise AssertionError(f"estimate_pose_3d: eager wrapper calls {eager_calls}; replays: "
                             f"wrapper calls {calls}, device launches {counted} in {replays}")
    rot = want.rotation.cpu().numpy()
    r_err = float(np.degrees(np.arccos(np.clip(0.5 * (np.trace(rot @ r_true.T) - 1), -1, 1))))
    t_err = float(np.linalg.norm(want.translation.cpu().numpy() - t_true))
    if not (r_err < 3.0 and t_err < 0.01 and float(want.score) > 0.5):
        raise AssertionError(f"estimate_pose_3d: {r_err} deg, {t_err} m, score "
                             f"{float(want.score)}")
    cpu = ransac.estimate_pose_3d(*(a.cpu() for a in args), **kw)
    vs_cpu = (float((want.rotation.cpu() - cpu.rotation).abs().max()),
              float((want.translation.cpu() - cpu.translation).abs().max()),
              float(want.inliers), float(cpu.inliers))
    ms = (device_ms(eager, device, 20), device_ms(compiled, device, 20))
    # where a compiled call's time goes: its graph's replay alone (CUDA
    # events over a loop of replays), and the device's busy time a call
    # (torch.profiler: the copies into the graph's inputs and the kernels)
    (graph,) = [p.graph for p in program.programs.values()]
    replay_ms = device_ms(graph.replay, device, 20)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            compiled()
        torch.cuda.synchronize(device)
    busy_ms = kernel_busy_ms(prof) / 20

    # each kernel against its plain version, at both scenes; the plain body
    # end to end against the kernels'
    hyp_stats = pose_hypotheses_vs_plain(*args, thr, "the planted scene")
    hyps = ransac.pose_hypotheses(*args, thr)
    ref_stats = pose_refine_vs_plain(obj, cam, valid, hyps, thr, 2, "the planted scene",
                                     exact=True)
    plain_hyps = ransac.pose_hypotheses_plain(*args, thr)
    plain = ransac.pose_refine_plain(obj, cam, valid, *plain_hyps, thr, 2)
    best = (int(torch.argmax(hyps[2])), int(torch.argmax(plain_hyps[2])))
    body = (float((want.rotation - plain.rotation).abs().max()),
            float((want.translation - plain.translation).abs().max()))
    if (best[0] != best[1] or body[0] > KABSCH_R_TOL or body[1] > POSE_T_TOL
            or float(want.inliers) != float(plain.inliers)):
        raise AssertionError(f"estimate_pose_3d's kernels vs its plain body: best {best}, |dR| "
                             f"{body[0]}, |dt| {body[1]}, inliers {float(want.inliers)} / "
                             f"{float(plain.inliers)}")
    large, _, _ = scene(POSE_POINTS_LARGE, 1)
    hyp_large = pose_hypotheses_vs_plain(*large, thr, f"{POSE_POINTS_LARGE} points")
    ref_large = pose_refine_vs_plain(*large[:3], ransac.pose_hypotheses(*large, thr), thr, 2,
                                     f"{POSE_POINTS_LARGE} points")

    # the rotation kernel at the program's covariances
    w3 = valid[triples].float()
    hyp_cov = ransac.weighted_covariance(obj[triples], cam[triples], w3)[0]
    inl = ransac._inliers_3d(want.rotation, want.translation, obj, cam, valid, thr).float()
    ref_cov = ransac.weighted_covariance(obj, cam, inl)[0][None]
    err, compared, rel, sweeps = kabsch_vs_plain(hyp_cov, "the hypotheses' covariances")
    err1, _, rel1, ref_sweeps = kabsch_vs_plain(ref_cov, "a refinement's covariance")

    # the times, at the planted scene (and the graphs at the large one)
    hyp_bound = pose_hypotheses_bound(POSE_POINTS, POSE_HYPOTHESES, sweeps)
    round_inliers = refine_inliers(obj, cam, valid, hyps, thr, 2)
    ref_bound = pose_refine_bound(POSE_POINTS, POSE_HYPOTHESES, round_inliers, ref_sweeps)
    hyp_stats.update(
        launches=counted["pose_hyp"], ms=graph_ms(lambda: ransac.pose_hypotheses(*args, thr), 200),
        call_ms=device_ms(lambda: ransac.pose_hypotheses(*args, thr), device, 50),
        plain_ms=device_ms(lambda: ransac.pose_hypotheses_plain(*args, thr), device, 20),
        bound_ms=hyp_bound[0], bound_by=hyp_bound[1], bytes=hyp_bound[2],
        operations=hyp_bound[3], library_ms=None,
        program_ms={"eager": ms[0], "compiled": ms[1], "replay": replay_ms, "busy": busy_ms},
        large={**hyp_large, "ms": graph_ms(lambda: ransac.pose_hypotheses(*large, thr), 50)})
    large_hyps = ransac.pose_hypotheses(*large, thr)
    ref_stats.update(
        launches=counted["pose_refine"],
        ms=graph_ms(lambda: ransac.pose_refine(obj, cam, valid, *hyps, thr, 2), 200),
        call_ms=device_ms(lambda: ransac.pose_refine(obj, cam, valid, *hyps, thr, 2), device, 50),
        plain_ms=device_ms(lambda: ransac.pose_refine_plain(obj, cam, valid, *hyps, thr, 2),
                           device, 20),
        bound_ms=ref_bound[0], bound_by=ref_bound[1], bytes=ref_bound[2],
        operations=ref_bound[3], library_ms=None, round_inliers=round_inliers,
        large={**ref_large, "ms": graph_ms(lambda: ransac.pose_refine(*large[:3], *large_hyps,
                                                                      thr, 2), 50)})

    bound = kabsch_bound(sweeps)
    k_ms = graph_ms(lambda: ransac.kabsch_rotation(hyp_cov), 200)
    call_ms = device_ms(lambda: ransac.kabsch_rotation(hyp_cov), device, 50)
    plain_ms = device_ms(lambda: ransac.kabsch_rotation_plain(hyp_cov), device, 20)
    svd_ms = device_ms(lambda: torch.linalg.svd(hyp_cov), device, 20)
    kabsch = dict(shape=list(hyp_cov.shape), launches=counted["kabsch"],
                  max_abs_err=max(err, err1), trace_rel_err=max(rel, rel1), compared=compared,
                  ms=k_ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound[0],
                  bound_by=bound[1], bytes=bound[2], operations=bound[3], library_ms=svd_ms,
                  sweeps=[int(sweeps.min()), float(sweeps.float().mean()), int(sweeps.max())])

    def times(st):
        return (f"ms graph / call / plain / bound {st['ms']:.4f} / {st['call_ms']:.4f} / "
                f"{st['plain_ms']:.4f} / {st['bound_ms']:.3g} ({st['bound_by']}, share "
                f"{100 * st['bound_ms'] / st['ms']:.2f}%)")

    line = (f"(e) estimate_pose_3d at ({POSE_POINTS} points, {POSE_HYPOTHESES} hypotheses, 30% "
            f"outliers) compiled == eager bit for bit (first call and {replays} replays), "
            f"{r_err:.3f} deg / {1e3 * t_err:.3f} mm from the truth, {float(want.inliers):.0f} "
            f"inliers; the card vs the CPU (the SVD there): |dR| {vs_cpu[0]:.3g}, |dt| "
            f"{vs_cpu[1]:.3g}, inliers {vs_cpu[2]:.0f} / {vs_cpu[3]:.0f}; ms eager / compiled "
            f"{ms[0]:.4f} / {ms[1]:.4f} (CUDA events, mean of 20), the graph's replay alone "
            f"{replay_ms:.4f}, the device busy {busy_ms:.4f} a compiled call (profiler: its "
            f"input copies and two kernels); launches a replay (device) "
            f"{per}; the plain body vs the kernels: best hypothesis {best[0]} / {best[1]}, |dR| "
            f"{body[0]:.3g}, |dt| {body[1]:.3g}, inliers equal; pose_hypotheses_kernel vs plain "
            f"(the SVD on the card), at {POSE_POINTS} / {POSE_POINTS_LARGE} points: |dR| "
            f"{hyp_stats['r_err']:.3g} / {hyp_large['r_err']:.3g}, |dt| {hyp_stats['t_err']:.3g} "
            f"/ {hyp_large['t_err']:.3g} on {hyp_stats['compared']} / {hyp_large['compared']} "
            f"separated fits (bars {KABSCH_R_TOL:g}, {POSE_T_TOL:g}), trace(R cov) within "
            f"{hyp_stats['trace_rel_err']:.3g} / {hyp_large['trace_rel_err']:.3g} of plain's on "
            f"{hyp_stats['usable']} / {hyp_large['usable']} usable (bar {KABSCH_TRACE_TOL:g}), "
            f"scores off their own fp64 "
            f"count {hyp_stats['scores_off_fp64']} / {hyp_large['scores_off_fp64']} and off "
            f"plain's {hyp_stats['scores_differ']} / {hyp_large['scores_differ']} times, each "
            f"within its points near the threshold; {times(hyp_stats)}; ms at "
            f"{POSE_POINTS_LARGE} points {hyp_stats['large']['ms']:.4f}; pose_refine_kernel vs plain on the same hypotheses: |dR| {ref_stats['r_err']:.3g} "
            f"/ {ref_large['r_err']:.3g}, |dt| {ref_stats['t_err']:.3g} / "
            f"{ref_large['t_err']:.3g}, inliers {ref_stats['inliers']:.0f} / "
            f"{ref_stats['plain_inliers']:.0f}, {ref_large['inliers']:.0f} / "
            f"{ref_large['plain_inliers']:.0f}; {times(ref_stats)}; ms at {POSE_POINTS_LARGE} "
            f"points {ref_stats['large']['ms']:.4f}; inliers a round (plain) "
            f"{ref_stats['round_inliers']}; {KABSCH_KERNEL} (on no program path) vs plain: max |dR| "
            f"{err:.3g} on {compared} of {hyp_cov.shape[0]} hypothesis covariances with "
            f"singular values apart (bar {KABSCH_R_TOL:g}), {err1:.3g} on a refinement's, "
            f"trace(R cov) within {max(rel, rel1):.3g} of sum(sigma) on all (bar "
            f"{KABSCH_TRACE_TOL:g}); sweeps min / mean / max {kabsch['sweeps']}; at "
            f"{tuple(hyp_cov.shape)} ms graph / call / plain / torch.linalg.svd / bound "
            f"{k_ms:.4f} / {call_ms:.4f} / {plain_ms:.4f} / {svd_ms:.4f} / {bound[0]:.3g} "
            f"({bound[1]})")
    return line, {"pose_hyp": hyp_stats, "pose_refine": ref_stats, "kabsch": kabsch}


def pose_errors_check(device, points, pairs_n=5):
    """The evaluator's compiled pose errors on `pairs_n` random pairs of the
    classes of `points`, the first pair's class a z-flip class: the
    padded program's rows (its first call and a replay) equal the eager
    body on the same padded rows bit for bit, and the eager body on the
    unpadded rows within 1e-6 relative. Returns the line."""
    import torch

    from posecnn_torch.engine.evaluate import PoseEvaluator, pair_errors

    rng = np.random.RandomState(0)
    c = points.shape[0]
    classes = rng.randint(1, c, pairs_n)

    def quat():
        q = rng.randn(4).astype(np.float32)
        return q / np.linalg.norm(q)

    pairs = [(int(k), quat(), rng.randn(3).astype(np.float32) * 0.1 + [0, 0, 1], quat(),
              rng.randn(3).astype(np.float32) * 0.1 + [0, 0, 1]) for k in classes]
    k = np.array([[1066.8, 0, WIDTH / 2], [0, 1066.8, HEIGHT / 2], [0, 0, 1]], np.float32)
    ev = PoseEvaluator(num_classes=c, points=points, extents=np.ones((c, 3), np.float32),
                       z_flip_classes=(int(classes[0]),), intrinsics=k, device=str(device))
    inputs = ev.pair_inputs(pairs)
    want = pair_errors(*inputs)
    got = [torch.from_numpy(ev._pair_errors(pairs)) for _ in range(2)]  # capture, replay
    for g in got:
        tree_exact(g, want[:pairs_n].cpu(), "the evaluator's pose errors, padded, vs eager")
    unpadded = pair_errors(*(t[:pairs_n] for t in inputs[:6]), *inputs[6:]).cpu()
    rel = float(((got[0] - unpadded).abs() / unpadded.abs().clamp(min=1e-30)).max())
    if rel > 1e-6 or len(ev._errors.programs) != 1:
        raise AssertionError(f"the evaluator's pose errors: padded vs unpadded eager {rel}, "
                             f"{len(ev._errors.programs)} graphs")
    return (f"the pose-error program on {pairs_n} random pairs (a z-flip class among them) "
            f"padded to {inputs[0].shape[0]} rows == its eager body bit for bit (capture and "
            f"replay), the unpadded eager body within {rel:.3g} relative")


def phase_eval(device, card):
    """Phase 9, the evaluation path at full width: `test_net --refine
    --ransac`, compiled, each forward, ICP, RANSAC centre and evaluator
    call held to its eager run bit for bit; ICP through `test_icp`'s drive,
    compiled and eager; RANSAC centres, and the evaluator, each on the card
    against the CPU; `estimate_pose_3d` compiled, its two pose kernels and
    the Kabsch kernel (`ransac_pose_check`). Returns (each vote kernel's
    launches in the recorded test_net run, its captured forward's
    launches, the three kernels' entries)."""
    import tempfile

    import torch

    from posecnn_torch.cli import test_icp, test_net
    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.engine import evaluate as evaluate_module
    from posecnn_torch.engine.evaluate import PoseEvaluator
    from posecnn_torch.refine.icp import icp_refine_batch
    from posecnn_torch.refine.ransac import draw_hypotheses, estimate_center
    from posecnn_torch.utils.graph import compile_static

    # 9.1: test_net --refine --ransac in process on the flagship yaml,
    # compiled: once as it is, for its images/s and stage seconds; then
    # counted, recording what the evaluator is fed, then each forward's,
    # ICP call's, RANSAC centre's and pose-error call's eager run, which
    # records the forward's Hough inputs
    with tempfile.TemporaryDirectory() as out:
        test_net.main([*EVAL_ARGS, "--device", str(device), "--num_images", str(EVAL_IMAGES),
                       "--refine", "--ransac", "--output", out])
        with open(os.path.join(out, "eval.json")) as f:
            run = json.load(f)["run"]
    recorded = {"images": [], "seg": []}

    class RecordingEvaluator(PoseEvaluator):
        def __post_init__(self):
            super().__post_init__()
            recorded["evaluator"] = self

        def add_segmentation(self, gt_label, pred_label):
            recorded["seg"].append((gt_label, pred_label))
            super().add_segmentation(gt_label, pred_label)

        def add_image(self, detections, gts):
            recorded["images"].append((detections, gts))
            super().add_image(detections, gts)

    with tempfile.TemporaryDirectory() as out:
        test_net.PoseEvaluator = RecordingEvaluator
        try:
            _, run_net = compiled_run(
                lambda: test_net.main([*EVAL_ARGS, "--device", str(device), "--num_images",
                                       str(EVAL_IMAGES), "--refine", "--ransac", "--output",
                                       out]),
                [test_net, evaluate_module], "test_net")
        finally:
            test_net.PoseEvaluator = PoseEvaluator
        with open(os.path.join(out, "eval.json")) as f:
            summary = json.load(f)
    ev = recorded["evaluator"]
    c = ev.num_classes
    iou = summary["seg_iou_per_class"]
    if summary["num_images"] != EVAL_IMAGES or len(iou) != c or not np.isfinite(
            summary["seg_mean_iou"]):
        raise AssertionError(f"eval.json: {summary['num_images']} images, {len(iou)} IoUs, "
                             f"mean {summary['seg_mean_iou']}")
    launches, replayed, hough_in = run_net["device"], run_net["replayed"], run_net["recorded"]
    forwards = run_net["bodies"]["forward_with_nms"]
    if any(replayed[k] != EVAL_IMAGES for k in ("flat", "window", "scan")) or len(
            hough_in) != EVAL_IMAGES or run_net["forwards"] != EVAL_IMAGES or (
            forwards != [NMS_FORWARD]):
        raise AssertionError(f"test_net: replays launched {replayed} in {EVAL_IMAGES} frames, "
                             f"{len(hough_in)} forwards, captured forwards {forwards}")
    icp_graphs = len(run_net["bodies"].get("icp_refine_batch", []))
    # RANSAC's centres and the pose errors: their graphs launch no kernel,
    # and every call equals its eager body (compiled_run held them)
    checks, bodies = run_net["checks"], run_net["bodies"]
    n_ransac, n_errors = checks.get("estimate_center", 0), checks.get("pair_errors", 0)
    matcher = PoseEvaluator(num_classes=c, points=ev.points, extents=ev.extents,
                            instance_matching=ev.instance_matching)
    with_pairs = sum(any(pair is not None for _, pair in matcher._match(dets, gts))
                     for dets, gts in recorded["images"])
    if (bodies.get("estimate_center") != [NO_LAUNCH] or not n_ransac
            or any(b != NO_LAUNCH for b in bodies.get("pair_errors", []))
            or n_errors != with_pairs):
        raise AssertionError(f"test_net --ransac: RANSAC graphs {bodies.get('estimate_center')} "
                             f"over {n_ransac} calls, pose-error graphs "
                             f"{bodies.get('pair_errors')} over {n_errors} calls ({with_pairs} "
                             "images with a matched pair)")
    errors_line = pose_errors_check(device, ev.points)
    # RANSAC's ms a detection, compiled and eager, on the run's first centre
    ransac_args, ransac_kw, _ = run_net["programs"]["estimate_center"][0].calls[0]
    eager = partial(estimate_center, *ransac_args, **ransac_kw)
    compiled = partial(compile_static(estimate_center), *ransac_args, **ransac_kw)
    tree_exact(tree_map(lambda x: x.clone(), compiled()), eager(), "estimate_center compiled")
    ransac_ms = (device_ms(eager, device, 5), device_ms(compiled, device, 5))
    pose_line, pose_kernels = ransac_pose_check(device)
    # flat and window bit for bit on each eval forward's Hough inputs
    extents, kw = hough_in.call
    meta = hough_in[0][2]
    inputs = {f"forward {i}": (lab, vert) for i, (lab, vert, _) in enumerate(hough_in)}
    shapes, errs = kernels_vs_plain(kw, extents, meta, inputs, "test_net")
    best = max(shapes, key=lambda n: shapes[n][1])
    sec = run["seconds"]

    # 9.2: test_icp's drive at full width, twice, compiled; then its scenes
    # on the card against the CPU, and icp_refine_batch's device time a
    # frame, eager and compiled (equal bit for bit)
    icp_lines, icp_ms, icp_rule = [], [], []
    with tempfile.TemporaryDirectory() as out:
        for rp in (0.0, 0.25):
            argv = [*EVAL_ARGS, "--device", str(device), "--output", out, "--num_scenes", "2",
                    "--rot_perturb", str(rp)]
            rep, run_icp = compiled_run(lambda: test_icp.main(argv), [test_icp], "test_icp")
            if not rep["num_objects"] or not rep["mean_te_after_cm"] < rep["mean_te_before_cm"]:
                raise AssertionError(f"test_icp at rot_perturb {rp}: TE "
                                     f"{rep['mean_te_before_cm']} -> {rep['mean_te_after_cm']} cm")
            icp_lines.append(f"rot_perturb {rp}: {rep['num_objects']} objects, TE "
                             f"{rep['mean_te_before_cm']:.2f} -> {rep['mean_te_after_cm']:.2f} cm, "
                             f"{run_icp['checked']} compiled calls == eager")
            args = test_icp.make_parser().parse_args(argv)
            for scene in test_icp.perturbed_scenes(test_icp.load_config(args), 2,
                                                   args.rot_noise_deg, args.trans_noise):
                icp_rule.append(icp_card_vs_cpu(scene, device, rp, args.num_iters))
                t = [torch.from_numpy(np.asarray(scene[k])).to(device)
                     for k in ("quats", "transs", "model_pts", "depth", "masks", "k")]
                kw = dict(num_iters=args.num_iters, rot_perturb=rp)
                eager = partial(icp_refine_batch, *t, **kw)
                compiled = partial(compile_static(icp_refine_batch), *t, **kw)
                tree_exact(tree_map(lambda x: x.clone(), compiled()), eager(),
                           f"ICP compiled vs eager, rot_perturb {rp}")
                icp_ms.append((device_ms(eager, device, 5), device_ms(compiled, device, 5)))
        # one frame of the sweep profiled, eager and compiled: the scene's
        # device events, device busy time, wall and host ops
        icp_prof = [icp_profile(call, device) for call in (eager, compiled)]
        hyp = eager().hypothesis_scores.shape[1]
        icp_scene_shape = f"{t[0].shape[0]} objects x {hyp} hypotheses"

    # 9.3: RANSAC centres of the planted scene's per-class directions, on
    # the card and the CPU from the same host draw
    label, low = planted_scene(HEIGHT, WIDTH, NUM_CLASSES, PLANTED, noise=0.02)
    ly, lx = np.mgrid[0 : HEIGHT // 8, 0 : WIDTH // 8]
    centres = np.stack([(lx + 0.5) * 8 - 0.5, (ly + 0.5) * 8 - 0.5], -1).astype(np.float32)
    worst_px = worst_gap = 0.0
    for cls, cx, cy, _, _, _ in PLANTED:
        live = np.abs(low[..., 3 * cls]) + np.abs(low[..., 3 * cls + 1]) > 0.5
        px = torch.from_numpy(centres[live])
        dirs = torch.from_numpy(np.ascontiguousarray(low[live][:, 3 * cls : 3 * cls + 2]))
        valid = torch.ones(len(px), dtype=torch.bool)
        pairs = draw_hypotheses(valid, 64, 2, torch.Generator().manual_seed(cls))
        got = estimate_center(px.to(device), dirs.to(device), valid.to(device), pairs.to(device))
        want = estimate_center(px, dirs, valid, pairs)
        gap = float((got.center.cpu() - want.center).abs().max())
        off = float(np.abs(got.center.cpu().numpy() - [cx, cy]).max())
        if off > 1.0 or gap > 1e-3 or float(got.inliers) != float(want.inliers):
            raise AssertionError(f"RANSAC class {cls}: centre off by {off} px, card vs CPU {gap}")
        worst_px, worst_gap = max(worst_px, off), max(worst_gap, gap)

    # 9.4: the evaluator on the card and on the CPU, fed 9.1's inputs
    evs = {}
    for dev in (device, torch.device("cpu")):
        evs[dev.type] = PoseEvaluator(num_classes=c, points=ev.points, extents=ev.extents,
                                      symmetric_classes=ev.symmetric_classes,
                                      instance_matching=ev.instance_matching, device=str(dev))
        for gt_label, pred in recorded["seg"]:
            evs[dev.type].add_segmentation(gt_label, pred)
        for dets, gts in recorded["images"]:
            evs[dev.type].add_image(dets, gts)
    ev_gap = summaries_agree(evs[device.type].summarize(), evs["cpu"].summarize())

    cfg = test_net.load_config(test_net.make_parser().parse_args(EVAL_ARGS))
    rule = "; ".join(f"{a:.3g}, {b:.3f}, {c_:.3g}" for a, b, c_ in icp_rule)
    print(f"phase 9 evaluation ({c} classes, {cfg.train.syn_height}x{cfg.train.syn_width}, "
          f"num_units {cfg.train.num_units}, fc_dim {cfg.train.fc_dim}, "
          f"{cfg.test.hough_num_samples} samples, seeded random weights) on {card}: test_net "
          f"--refine --ransac "
          f"{EVAL_IMAGES} images, {run['images_per_s']:.2f} images/s (a run without the recording), "
          f"seconds render "
          f"{sec['render']:.3f} / forward with its NMS {sec['forward']:.3f} / extraction with "
          f"RANSAC {sec['extract']:.3f} / ICP {sec['icp']:.3f} / evaluator "
          f"{sec['evaluate']:.3f}, {run['detections']} detections, {run['refined']} refined, "
          f"seg mean IoU {summary['seg_mean_iou']:.4f}; compiled: the forward one graph "
          f"({forwards[0]} a "
          f"replay), ICP {icp_graphs} graphs (one per object count); the recorded run's "
          f"launches counted on the device {launches} (eager warm-ups, the wrappers' counts, {run_net['calls']}; graph "
          f"replays {replayed}); "
          f"{run_net['checked']} compiled calls (forwards and ICP) == their eager runs bit for "
          f"bit; the keep mask == the host scan bit for bit on {run_net['scanned']} forwards; "
          f"flat, window and tile == plain bit "
          f"for bit on every eval forward ({len(inputs)}; the liveliest, {best}: slots, live, "
          f"samples, peak coarse vote {shapes[best]}), max_abs_err {errs}; test_icp "
          f"({'; '.join(icp_lines)}), card vs CPU per scene (one step, converged share within "
          f"{ICP_ATOL}, refined poses): "
          f"{rule}, icp_refine_batch ms a frame eager / compiled (== eager bit for bit) "
          f"{', '.join(f'{a:.3f} / {b:.3f}' for a, b in icp_ms)} (CUDA events, mean of 5); the "
          f"last frame ({icp_scene_shape}) profiled eager / compiled: wall {icp_prof[0][0]:.2f} / "
          f"{icp_prof[1][0]:.2f} ms, device busy {icp_prof[0][1]:.2f} / {icp_prof[1][1]:.2f} ms, "
          f"{icp_prof[0][2]} / {icp_prof[1][2]} device events, top aten ops by host ms (calls, "
          f"ms): {'; '.join(icp_prof[0][3])} / {'; '.join(icp_prof[1][3])}); RANSAC centres of "
          f"{len(PLANTED)} planted objects within "
          f"{worst_px:.3f} px, card vs CPU {worst_gap:.3g} px; evaluator on the card == CPU "
          f"(largest difference {ev_gap:.3g}); RANSAC in test_net --ransac: {n_ransac} centres "
          f"through one graph at {ransac_args[0].shape[0], ransac_args[3].shape[0]} "
          f"(points, hypotheses), == eager bit for bit, ms a detection eager / compiled "
          f"{ransac_ms[0]:.3f} / {ransac_ms[1]:.3f} (CUDA events, mean of 5); the evaluator's "
          f"pose errors: {n_errors} calls through {len(bodies.get('pair_errors', []))} graphs "
          f"(rows padded to a power of two, at least 8), == eager bit for bit; {errors_line}; "
          f"{pose_line}", flush=True)
    return launches, forwards[0], pose_kernels


def cfg_path(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", "cfgs",
                        f"{name}.yaml")


def recording_hough(recorded):
    """A stand-in for the model's `hough_voting` that appends a copy of each
    call's (label, 1/8 vertex map, meta) to `recorded`, keeps its extents
    and keywords under `recorded.call`, and votes as the original; returns
    (the stand-in, the original). A call under graph capture (a compiled
    train step's) records nothing: it runs no kernel, and its graph's
    replays show in the kernels' own counts on the device."""
    import torch

    from posecnn_torch.models import posecnn as posecnn_module

    original = posecnn_module.hough_voting

    def record(label, vertex, extents, meta, *args, **kw):
        if torch.cuda.is_current_stream_capturing():
            return original(label, vertex, extents, meta, *args, **kw)
        recorded.append((label.detach().clone(), vertex.detach().clone(), meta.clone()))
        recorded.call = (extents, kw)
        return original(label, vertex, extents, meta, *args, **kw)

    return record, original


class Recorded(list):
    call = None


def tree_map(fn, tree):
    """fn on every tensor of a nest of tuples, named tuples, lists and
    dicts; other leaves as they are."""
    import torch

    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def tree_exact(got, want, where):
    """Every tensor of `got` equal to the one at the same place of `want`,
    element for element (NaN where NaN); raises on the first that is not."""
    leaves = []
    tree_map(leaves.append, got)
    wants = []
    tree_map(wants.append, want)
    if len(leaves) != len(wants):
        raise AssertionError(f"{where}: {len(leaves)} tensors against {len(wants)}")
    for i, (g, w) in enumerate(zip(leaves, wants)):
        if g.shape != w.shape or not exact(g, w)[1]:
            raise AssertionError(f"{where}: output tensor {i} differs (max |d| "
                                 f"{exact(g, w)[0] if g.shape == w.shape else 'shape'})")


def recording_compile(made):
    """A stand-in for `utils/graph.compile_static` that appends each
    compiled call it makes to `made` and keeps a copy of every call's
    arguments (taken before the call) and outputs under the compiled
    call's `calls`. A program with arguments bound in place (the fusion
    volume: a copy of each call would fill the card) is held to its eager
    body at once instead: the body runs on copies of the arguments taken
    before the call, and its outputs and the copies after it must equal
    the program's outputs and the bound tensors bit for bit; `checked`
    counts those calls."""
    import torch

    from posecnn_torch.utils.graph import compile_static

    class Recording(compile_static):
        def __init__(self, fn, inplace=()):
            super().__init__(fn, inplace=inplace)
            self.calls, self.checked = [], 0
            made.append(self)

        def __call__(self, *args, **kwargs):
            before = tree_map(lambda t: t.clone(), (args, kwargs))
            out = super().__call__(*args, **kwargs)
            if not self.inplace:
                self.calls.append((*before, tree_map(lambda t: t.clone(), out)))
                return out
            with torch.no_grad():
                want = self.fn(*before[0], **before[1])
            name = getattr(self.fn, "func", self.fn).__name__
            tree_exact(out, want, f"{name} (in place), call {self.checked}: graph vs eager")
            tree_exact((args, kwargs), before, f"{name} (in place), call {self.checked}: the "
                       "bound tensors after the graph vs after the eager body")
            self.checked += 1
            return out

    return Recording


def compiled_run(call, modules, where):
    """call(), a CLI run, with `compile_static` of each of `modules`
    recording (`recording_compile`), under `device_counted` (the vote
    kernels' counts, the wrappers' and the device's, set to 0 just before
    it);
    then every call of every compiled program run again eagerly on its own
    arguments, with the model's Hough recorded, and held to the graph's
    outputs bit for bit (a program with in-place arguments is held so
    during the run, call by call). Returns (call's result, a dict: `calls`,
    the wrappers' counts in the run (the eager warm-ups); `device`, each
    kernel's launches counted on the device; `replayed`, those the graph
    replays made (device less calls); `bodies`, each captured program's
    launches a replay, by the compiled function's name; `forwards`, the
    calls of the compiled forward; `recorded`, the eager reruns' Hough
    inputs and launches (`counting_hough`, one a forward); `checked`, the
    calls held to eager, and `checks` by name; `scanned`, the forwards
    whose graph's keep mask equals the host scan (`greedy_keep`) of their
    own RoIs' suppression matrix bit for bit; `programs`, the recording
    compiled calls by name, with their calls' copies)."""
    import torch

    from posecnn_torch.models import posecnn as posecnn_module
    from posecnn_torch.ops.nms import greedy_keep, per_class_suppression

    made = []
    stand_in = recording_compile(made)
    originals = [m.compile_static for m in modules]
    for m in modules:
        m.compile_static = stand_in
    try:
        result, calls, counted = device_counted(call)
    finally:
        for m, original in zip(modules, originals):
            m.compile_static = original
    replayed = {k: counted[k] - calls[k] for k in COUNTED}
    bodies, forwards, checks, programs = {}, 0, {}, {}
    for c in made:
        name = getattr(c.fn, "func", c.fn).__name__
        bodies.setdefault(name, []).extend(p.launches for p in c.programs.values())
        programs.setdefault(name, []).append(c)
        checks[name] = checks.get(name, 0) + c.checked
        if name == "forward_with_nms":
            forwards += len(c.calls)
    recorded = Recorded()
    record, original = counting_hough(recorded)
    posecnn_module.hough_voting = record
    scanned = 0
    try:
        for c in made:
            name = getattr(c.fn, "func", c.fn).__name__
            for args, kwargs, out in c.calls:
                with torch.no_grad():
                    want = c.fn(*args, **kwargs)
                tree_exact(out, want, f"{where}: {name} graph vs eager, call {checks[name]}")
                checks[name] += 1
                if name == "forward_with_nms":
                    # the graph's keep mask against the host scan, which
                    # shares nothing with the device scan
                    outputs, keep = out
                    host = greedy_keep(per_class_suppression(
                        outputs.hough.rois, c.fn.keywords["nms_threshold"], outputs.hough.valid))
                    if not torch.equal(keep, host):
                        raise AssertionError(f"{where}: forward {scanned}: the graph's keep mask "
                                             f"{keep.tolist()} is not the host scan's "
                                             f"{host.tolist()}")
                    scanned += 1
    finally:
        posecnn_module.hough_voting = original
    return result, dict(calls=calls, device=counted, replayed=replayed, bodies=bodies,
                        forwards=forwards, recorded=recorded, checked=sum(checks.values()),
                        checks=checks, scanned=scanned, programs=programs)


def domain_reversal_check(tr, batches):
    """On the first of an adapt run's batches whose forward at keep_prob 1
    has valid RoIs (the domain loss's rows): the gradient that the loss
    sends into the trunk side of the reversal is exactly −λ times the one
    arriving from the domain head, which is non-zero, as are the head's
    own gradients. Returns (batch index, valid RoIs, λ, |head side|,
    cosine of the two sides, the head's gradient norm)."""
    import torch

    from posecnn_torch.engine.train import compute_losses, decompress_feed
    from posecnn_torch.models import posecnn as posecnn_module

    grads, original = {}, posecnn_module.gradient_reversal

    def watched(x, lambda_):
        x.register_hook(lambda g: grads.__setitem__("into_trunk", g))
        y = original(x, lambda_)
        y.register_hook(lambda g: grads.__setitem__("from_head", g))
        return y

    rows = []
    for index, batch in enumerate(batches):
        posecnn_module.gradient_reversal = watched
        try:
            tr.model.zero_grad(set_to_none=True)
            total, metrics = compute_losses(tr.model, decompress_feed(batch, tr.cfg), tr.cfg,
                                            tr.points, tr.extents, tr.symmetry, keep_prob=1.0)
            total.backward()
        finally:
            posecnn_module.gradient_reversal = original
        rows.append(int(metrics["num_rois"]))
        if rows[-1] > 0:
            break
    else:
        raise AssertionError(f"domain head: no valid RoI on any batch ({rows}): nothing to check")
    lam = tr.model.domain_head.lambda_
    into, head = grads["into_trunk"].float(), grads["from_head"].float()
    if not torch.equal(grads["into_trunk"], -lam * grads["from_head"]):
        raise AssertionError("gradient reversal: the trunk side is not -λ × the head side")
    cos = float((into * head).sum() / (into.norm() * head.norm()))
    head_norm = float(sum(p.grad.float().norm() ** 2
                          for p in tr.model.domain_head.parameters()) ** 0.5)
    if not (float(head.abs().max()) > 0 and head_norm > 0 and cos < -0.999):
        raise AssertionError(f"domain head gradients: |head side| {float(head.abs().max())}, "
                             f"head params {head_norm}, cosine {cos}")
    tr.model.zero_grad(set_to_none=True)
    return index, rows[-1], lam, float(head.norm()), cos, head_norm


def adam_fastforward_check(step):
    """`fastforward_opt_counts` on the card's fused Adam: one update from
    `step` equals the CPU's (unfused) Adam from the same state, and both
    stand at `step` + 1. Returns the largest parameter difference."""
    import torch

    from posecnn_torch.core.config import cfg_from_dict
    from posecnn_torch.engine.train import create_optimizer, fastforward_opt_counts

    cfg = cfg_from_dict({"train": {"optimizer": "adam", "learning_rate": 0.01}})
    g = torch.Generator().manual_seed(0)
    p0, grad = torch.randn(64, 32, generator=g), torch.randn(64, 32, generator=g)
    out = []
    for device in ("cuda", "cpu"):
        p = p0.clone().to(device).requires_grad_()
        opt = fastforward_opt_counts(create_optimizer(cfg, [p]), step)
        p.grad = grad.to(device)
        opt.update()
        if opt.count != step + 1 or float(opt.opt.state[p]["step"]) != step + 1:
            raise AssertionError(f"Adam on {device}: count {opt.count}, step "
                                 f"{float(opt.opt.state[p]['step'])} after one update")
        out.append(p.detach().cpu())
    err = float((out[0] - out[1]).abs().max())
    if err > 1e-6 or torch.equal(out[1], p0):
        raise AssertionError(f"fused Adam from step {step}: card vs CPU {err}")
    return err


def real_gate(step, state, batches, name):
    """Phase 10's compiled step of one real-frame yaml (`CompiledTrainStep`,
    as train_net builds it): each batch signature's graph captured first
    (the full yaml's feed mixes real and synthetic batches), from one state
    restored after, then the equality gate over `batches` (GATE_STEPS
    consecutive replays across a step of the lr staircase; the seg head
    biased so that the vote has live slots), one flat and one window launch
    a replay. The yaml's loss terms must be among the graphs' metrics
    (`loss_match`: the matching term runs inside the step). Returns the
    gate's result, with the graphs' count and metric names in its line."""
    from posecnn_torch.bench import snapshot
    from posecnn_torch.engine.train import CompiledTrainStep

    if not isinstance(step, CompiledTrainStep):
        raise AssertionError(f"phase 10 {name}: the step is {type(step).__name__}, not compiled")
    start = snapshot(step, state)
    for batch in batches:
        step(state, batch)
    start()
    gate = equality_gate(step, state, batches, f"phase 10 {name}", C2F_STEP, live_hough_inputs)
    programs = list(step.compiled.programs.values())
    keys = sorted(set().union(*(p.keys for p in programs)))
    t = step.cfg.train
    want = {"loss", "loss_cls", "loss_vertex", "loss_pose"}
    want |= {"loss_domain"} if t.adapt else set()
    want |= {"loss_match"} if t.matching else set()
    if not want <= set(keys) or any(p.launches != C2F_STEP for p in programs):
        raise AssertionError(f"phase 10 {name}: graphs' metrics {keys} (want {sorted(want)}), "
                             f"launches {[p.launches for p in programs]}")
    gate["line"] = (f"compiled step: {len(programs)} graphs (batch signatures), metrics "
                    f"{keys}, launches a replay {C2F_STEP}; {gate['line']}")
    return gate


def phase_real(card):
    """Phase 10: the real-frame family on a fabricated YCB-Video tree at
    full width. Returns the kernel launches of its training steps and of
    its test_net run."""
    import tempfile

    import torch

    from posecnn_torch.cli import test_net, train_net
    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.core.checkpoint import save_params, snapshot_path
    from posecnn_torch.core.weights import params_to_jax
    from posecnn_torch.data.fabricate import write_ycb_tree
    from posecnn_torch.engine.train import decompress_feed, lr_schedule, make_train_step
    from posecnn_torch.models import posecnn as posecnn_module
    from posecnn_torch.ops import hough_kernels as hk
    from posecnn_torch.ops.matching_loss import roi_matching_loss

    train_launches = {k: 0 for k in KERNELS}
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "lov")
        t0 = time.perf_counter()
        write_ycb_tree(root, sets=(("train", REAL_FRAMES[0]), ("val", REAL_FRAMES[1])))
        fab_s = time.perf_counter() - t0
        rgbd_snapshot = None
        for name in REAL_CFGS:
            out = os.path.join(tmp, name)
            argv = ["--dataset", "lov", "--data_root", root, "--cfg", cfg_path(name), "--output",
                    out, *REAL_SET[name]]
            args = train_net.make_parser().parse_args(argv)
            t0 = time.perf_counter()
            tr = train_net.build_trainer(args, train_net.load_config(args))
            setup_s = time.perf_counter() - t0
            t = tr.cfg.train
            step = make_train_step(tr.cfg, tr.model, tr.points, tr.extents, tr.symmetry)
            recorded, batches, per_step, metrics = Recorded(), [], [], []
            record, original = recording_hough(recorded)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            posecnn_module.hough_voting = record
            try:
                for i in range(REAL_STEPS):
                    w0 = time.perf_counter()
                    batch = next(tr.batches)
                    feed_ms = 1e3 * (time.perf_counter() - w0)
                    for key in hk.LAUNCHES:
                        hk.LAUNCHES[key] = 0
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                    ev[0].record()
                    total, m = step.forward(tr.state, batch)
                    ev[1].record()
                    step.backward(total)
                    ev[2].record()
                    m["lr"] = step.update(tr.state)
                    ev[3].record()
                    torch.cuda.synchronize()
                    launches = dict(hk.LAUNCHES)
                    for key in KERNELS:
                        train_launches[key] += launches[key]
                    if launches["flat"] != 1 or launches["window"] != 1:
                        raise AssertionError(f"{name} step {i}: flat and window launched "
                                             f"{launches}, not once each")
                    values = {k: float(v) for k, v in m.items()}
                    if not all(np.isfinite(list(values.values()))):
                        raise AssertionError(f"{name} step {i}: non-finite metrics {values}")
                    per_step.append((feed_ms, *(ev[j].elapsed_time(ev[j + 1]) for j in range(3)),
                                     1e3 * (time.perf_counter() - w0)))
                    metrics.append(values)
                    batches.append(batch)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                # the last step's loss holds its autograd graph, whose
                # AccumulateGrad nodes sit on the default stream: a capture
                # (the gate's) then fails, so free it
                del total, m
                # the equality gate's batches: these steps' and the feed's next
                gate_batches = batches + [next(tr.batches) for _ in range(GATE_STEPS - REAL_STEPS)]
            finally:
                posecnn_module.hough_voting = original
                tr.batches.close()
            want = {"loss", "loss_cls", "loss_vertex", "loss_pose", "loss_qmag"}
            want |= {"loss_domain"} if t.adapt else set()
            want |= {"loss_match"} if t.matching else set()
            if not all(want <= set(m) for m in metrics):
                raise AssertionError(f"{name}: a loss term is missing: {sorted(metrics[0])}")
            # each step's flat and window kernels against plain on its own
            # Hough inputs, and on the GT inputs of its batch (live slots)
            shapes, errs = {}, {}
            for i, ((label, vert, meta), batch) in enumerate(zip(recorded, batches)):
                inputs = {f"step {i}": (label, vert),
                          f"GT {i}": gt_hough_inputs(tr, decompress_feed(batch, tr.cfg))}
                sh, er = kernels_vs_plain(tr.model.hough_kw, tr.extents, meta, inputs,
                                          f"{name} step {i}")
                shapes.update(sh)
                errs = {k: max(errs.get(k, 0.0), v) for k, v in er.items()}
            live = sum(v[1] for k, v in shapes.items() if k.startswith("GT"))
            if live == 0:
                raise AssertionError(f"{name}: no live slot on the GT inputs: nothing compared")
            extra = ""
            if name == "lov_rgbd_2d":
                b = decompress_feed(batches[0], tr.cfg)
                valid_rows, matched, gate = train_hough_gate(tr, b, gt_hough_inputs(tr, b)[1])
                extra += (f"; c2f == exhaustive on step 0's GT inputs: {valid_rows} valid rows, "
                          f"{matched} matched, launches {gate}")
                rgbd_snapshot = snapshot_path(out, t.snapshot_prefix, t.snapshot_infix,
                                              tr.state.step)
                save_params(rgbd_snapshot, tr.model, step=tr.state.step, meta=tr.head_meta)
                saved = params_to_jax(tr.model.state_dict())
                lr_next = lr_schedule(tr.cfg)(tr.state.opt.count)
            if t.adapt:
                index, rows, lam, head, cos, head_norm = domain_reversal_check(tr, batches)
                extra += (f"; gradient reversal on step {index}'s batch ({rows} valid RoIs): "
                          f"trunk side = -{lam} x head side exactly, cosine {cos:.6f}, |head "
                          f"side| {head:.3e}, domain head grad norm {head_norm:.3e}")
            if t.matching:
                b = decompress_feed(batches[-1], tr.cfg)
                out_m = tr.model.train_forward(b["data"], tr.extents, b["meta"], b["gt_poses"],
                                               b["gt_valid"], keep_prob=1.0)
                poses = out_m.poses_pred.detach().requires_grad_()
                h = out_m.hough
                pts = tr.points

                def term():
                    return roi_matching_loss(h.rois, poses, h.poses_init, h.poses_weight,
                                             h.valid, b["label"], b["meta"], pts)

                def term_grad():
                    loss, _ = term()
                    return torch.autograd.grad(loss, poses)

                fwd_ms = device_ms(term, tr.device, 5)
                both_ms = device_ms(term_grad, tr.device, 5)
                _, n_match = term()
                extra += (f"; matching term on {h.rois.shape[0]} RoIs x "
                          f"{pts[:, :: max(pts.shape[1] // 64, 1)].shape[1]} points x "
                          f"{b['label'].shape[1] // 8}x{b['label'].shape[2] // 8} "
                          f"({int(n_match)} matched): forward {fwd_ms:.3f} ms, forward + "
                          f"backward {both_ms:.3f} ms device (CUDA events, mean of 5)")
                del out_m, poses, h
            gate = real_gate(step, tr.state, gate_batches, name)
            extra += f"; {gate['line']}"
            split = np.asarray(per_step)  # feed wait, forward, backward, optimizer, wall
            steady = split[1:].mean(0)
            lines.append(
                f"{name} (input {tr.cfg.input}, batch {t.ims_per_batch}, num_units {t.num_units}, "
                f"{'adapt, ' if t.adapt else ''}{'matching, ' if t.matching else ''}"
                f"{'GT RoIs prepended, ' if t.gt_pose_rois else ''}"
                f"{'synthesize 1:' + str(t.syn_ratio) + ', ' if t.synthesize else ''}chromatic "
                f"{t.chromatic}, noise {t.add_noise}): set-up {setup_s:.1f} s; {REAL_STEPS} "
                f"steps, ms feed wait / forward / backward / optimizer / wall (the first builds "
                f"cuDNN plans): " + "; ".join("/".join(f"{x:.2f}" for x in row) for row in split)
                + f" (steps 2-{REAL_STEPS} mean {'/'.join(f'{x:.2f}' for x in steady)}: "
                f"{1e3 * t.ims_per_batch / steady[4]:.2f} images/s at the wall, "
                f"{1e3 * t.ims_per_batch / steady[1:4].sum():.2f} on the step's device time), "
                f"batch production {', '.join(f'{1e3 * x:.0f}' for x in tr.batches.produce_seconds)} "
                f"ms, peak memory {peak_gb:.2f} GB; losses "
                + ", ".join(f"{k} {metrics[-1][k]:.4f}" for k in sorted(want))
                + f", valid RoIs a step {[int(m['num_rois']) for m in metrics]}, pose rows "
                f"{metrics[-1]['num_pose_rois']:.0f}; flat and window launched "
                f"once a step, == plain bit for bit on each step's inputs and its GT inputs "
                f"({len(shapes)} inputs, {live} live GT slots), max_abs_err {errs}" + extra)
            del tr, step, batches, recorded, gate_batches, gate
            torch.cuda.empty_cache()

        # --resume: the newest snapshot, as the JAX CLI resumes it: the step
        # continued, the optimizer fresh (count 0, zero traces on the card),
        # the staircase on the global step through lr_step_offset; the
        # device rate of the next update set from it
        out = os.path.join(tmp, REAL_CFGS[0])
        argv = ["--dataset", "lov", "--data_root", root, "--cfg", cfg_path(REAL_CFGS[0]),
                "--output", out, "--resume", *REAL_SET[REAL_CFGS[0]]]
        args = train_net.make_parser().parse_args(argv)
        tr = train_net.build_trainer(args, train_net.load_config(args))
        tr.batches.close()
        restored = params_to_jax(tr.model.state_dict())
        same = all(np.array_equal(restored[k], saved[k]) for k in saved)
        opt = tr.state.opt
        fresh = not any(bool(t.any()) for t in tr.state.state_tensors())
        lr = opt.prepare()
        device_lr = float(opt.lr)
        if args.ckpt != rgbd_snapshot or tr.state.step != REAL_STEPS or opt.count != 0 or (
                tr.cfg.train.lr_step_offset != REAL_STEPS) or not same or not fresh or (
                lr != lr_next) or device_lr != float(np.float32(lr_next)):
            raise AssertionError(f"--resume: {args.ckpt} vs {rgbd_snapshot}, step "
                                 f"{tr.state.step}, optimizer count {opt.count}, offset "
                                 f"{tr.cfg.train.lr_step_offset}, fresh {fresh}, parameters "
                                 f"equal {same}, lr {lr} (device {device_lr}) / {lr_next}")
        del tr, restored, saved, opt
        # the CLI itself resumes and trains one more step (its first call
        # eager: one flat and one window launch on the device)
        state, _, resume_launches = device_counted(lambda: train_net.main_run(
            train_net.make_parser().parse_args(argv), train_net.load_config(args),
            REAL_STEPS + 1))
        resumed_lr = float(state.opt.lr)
        if not (state.step == REAL_STEPS + 1 and state.opt.count == 1) or (
                resumed_lr != float(np.float32(lr_next))) or (
                resume_launches["flat"], resume_launches["window"]) != (1, 1):
            raise AssertionError(f"train_net --resume ended at step {state.step}, optimizer "
                                 f"count {state.opt.count}, device rate {resumed_lr}, "
                                 f"launches {resume_launches}")
        final_snapshot = train_net.newest_snapshot(out)
        adam_err = adam_fastforward_check(REAL_STEPS)
        resume_line = (f"--resume restored {os.path.basename(rgbd_snapshot)} (parameters "
                       f"equal) as the JAX CLI resumes: step {REAL_STEPS}, the optimizer "
                       f"fresh (count 0, zero traces read on the card), lr_step_offset "
                       f"{REAL_STEPS}, device rate {device_lr:g} = schedule(0 + offset) = the "
                       f"staircase at the global step; train_net --resume --iters "
                       f"{REAL_STEPS + 1} trained 1 step (step {REAL_STEPS + 1}, count 1, "
                       f"device rate {resumed_lr:g}, launches on the device flat "
                       f"{resume_launches['flat']} window {resume_launches['window']}), wrote "
                       f"{os.path.basename(final_snapshot)}; fused Adam fast-forwarded to step "
                       f"{REAL_STEPS} (as the equality gates set the count) == the CPU's Adam "
                       f"after one update within {adam_err:.3g}")
        del state
        torch.cuda.empty_cache()

        # test_net --dataset lov --refine on the val frames, RGBD snapshot,
        # compiled: with the snapshot, then with seeded random weights, whose
        # labels leave RoIs to detect and refine (a few steps teach
        # background); each compiled call held to its eager run, which
        # records the forward's Hough inputs
        recorded = Recorded()
        written = {}
        for weights, ckpt in (("snapshot", ["--ckpt", final_snapshot]), ("random", [])):
            _, run_net = compiled_run(lambda: test_net.main(
                ["--dataset", "lov", "--data_root", root, "--cfg", cfg_path(REAL_CFGS[0]),
                 *ckpt, "--refine", "--num_images", str(REAL_FRAMES[1]), "--output",
                 os.path.join(tmp, weights)]), [test_net], f"test_net --dataset lov ({weights})")
            with open(os.path.join(tmp, weights, "eval.json")) as f:
                written[weights] = json.load(f)
            written[weights]["launches"] = run_net["device"]
            written[weights]["replayed"] = run_net["replayed"]
            recorded.extend(run_net["recorded"])
            recorded.call = run_net["recorded"].call
    for weights, summary in written.items():
        run = summary["run"]
        finite = [summary["seg_mean_iou"], summary["add_auc"], summary["adds_auc"],
                  run["images_per_s"]]
        if summary["num_images"] != REAL_FRAMES[1] or not np.isfinite(finite).all() or len(
                summary["seg_iou_per_class"]) != 22 or run["refined"] != run["detections"]:
            raise AssertionError(f"test_net --dataset lov ({weights} weights): {summary}")
        if not (summary["replayed"]["flat"] == summary["replayed"]["window"]
                == summary["replayed"]["scan"] == REAL_FRAMES[1]):
            raise AssertionError(f"test_net --dataset lov ({weights} weights): replays "
                                 f"launched {summary['replayed']}")
    if written["random"]["run"]["refined"] == 0:
        raise AssertionError("test_net --dataset lov --refine: no detection to refine")
    extents, kw = recorded.call
    e_shapes, e_errs = {}, {}
    for i, (label, vert, meta) in enumerate(recorded):
        sh, er = kernels_vs_plain(kw, extents, meta, {f"forward {i}": (label, vert)},
                                  "test_net --dataset lov")
        e_shapes.update(sh)
        e_errs = {k: max(e_errs.get(k, 0.0), v) for k, v in er.items()}
    evals = []
    for weights, summary in written.items():
        run, sec = summary["run"], summary["run"]["seconds"]
        evals.append(
            f"{weights} weights (compiled calls recorded): {run['images_per_s']:.2f} images/s, "
            f"seconds read / forward / "
            f"extract / ICP / evaluator {sec['render']:.3f} / {sec['forward']:.3f} / "
            f"{sec['extract']:.3f} / {sec['icp']:.3f} / {sec['evaluate']:.3f}, "
            f"{run['detections']} detections, {run['refined']} refined, seg mean IoU "
            f"{summary['seg_mean_iou']:.4f}, launches counted on the device {summary['launches']} (graph "
            f"replays {summary['replayed']})")
    print(f"phase 10 real frames on {card}: a fabricated YCB-Video tree (22 classes, "
          f"{REAL_FRAMES[0]} train and {REAL_FRAMES[1]} val frames at 480x640, rendered, PNG and "
          f".mat) written in {fab_s:.1f} s; "
          + " | ".join(lines)
          + f" | {resume_line} | test_net --dataset lov --refine, RGBD, {REAL_FRAMES[1]} val "
          f"frames: " + "; ".join(evals) + f"; flat and window == plain bit for bit on each of "
          f"the {len(recorded)} forwards (slots, live, samples, peak coarse vote: "
          f"{max(e_shapes.values(), key=lambda v: v[1])} at the liveliest), max_abs_err "
          f"{e_errs}", flush=True)
    return train_launches, {k: sum(w["launches"][k] for w in written.values()) for k in KERNELS}


def det_card_vs_cpu(device):
    """A small fp32 PoseCNNDet (4 classes, 64×96, fc_dim 32, 3×3 anchors,
    16 slots) on the card against the CPU, with the same weights, batch and
    target noise: the same proposal and sampled rows, the RoI coordinates
    within 1e-3 px, every loss term within 1e-4 relative. Returns the
    largest relative loss difference and the number of valid proposals."""
    import copy

    import torch

    from posecnn_torch.cli.train_net import det_targets
    from posecnn_torch.data.procedural import synthetic_class_library
    from posecnn_torch.data.synthetic import SyntheticSceneGenerator
    from posecnn_torch.models.detection import PoseCNNDet, detection_losses
    from posecnn_torch.models.posecnn import init_weights
    from posecnn_torch.ops.rpn import target_noise

    h, w = 64, 96
    lib = synthetic_class_library(4, 256)
    k = np.array([[90.0, 0, w / 2], [0, 90.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=w, height=h, seed=4,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    batch = det_targets(gen.render(dense_vertex_targets=False))
    model = PoseCNNDet(4, anchor_scales=(1, 2, 4), anchor_ratios=(0.5, 1.0, 2.0), fc_dim=32,
                       post_nms_topk=16, pre_nms_topk=100, rois_per_image=16, rpn_batchsize=32,
                       rpn_positive_overlap=0.5, bg_thresh_lo=0.0)
    init_weights(model, 0)
    noise = target_noise(*model.noise_shapes(h, w, 8), torch.Generator().manual_seed(0), "cpu")
    sym = np.asarray(lib.symmetry, np.float32).copy()
    sym[1] = 1.0
    outs = {}
    for dev, m in ((torch.device("cpu"), model), (device, copy.deepcopy(model).to(device))):
        t = {name: torch.from_numpy(np.array(v)).to(dev) for name, v in batch.items()}
        out = m(t["data"], t["gt_boxes"], t["gt_poses"], t["gt_valid"], train=True,
                noise=type(noise)(*(x.to(dev) for x in noise)))
        losses = detection_losses(out, 4, torch.from_numpy(lib.points[:, :48]).to(dev),
                                  torch.from_numpy(sym).to(dev))
        outs[dev.type] = (out, {name: float(v.detach()) for name, v in losses.items()})
    (cpu, cpu_l), (card, card_l) = outs["cpu"], outs[device.type]
    same = [torch.equal(cpu.proposals.valid, card.proposals.valid.cpu()),
            torch.equal(cpu.anchor_targets.labels, card.anchor_targets.labels.cpu()),
            torch.equal(cpu.proposal_targets.labels, card.proposal_targets.labels.cpu()),
            torch.allclose(cpu.proposal_targets.rois.detach(),
                           card.proposal_targets.rois.detach().cpu(), rtol=0, atol=1e-3)]
    rel = max(abs(card_l[name] - v) / max(abs(v), 1e-7) for name, v in cpu_l.items())
    if not all(same) or rel > 1e-4:
        raise AssertionError(f"PoseCNNDet on the card vs the CPU: proposals, anchor labels, "
                             f"RoI labels, RoI rows equal {same}; losses {card_l} vs {cpu_l}")
    return rel, int(cpu.proposals.valid.sum())


class Eager:
    """A stand-in for `utils/graph.compile_static` that calls the body as
    it is: a CLI's run with its programs eager."""

    def __init__(self, fn, inplace=()):
        self.fn, self.programs = fn, {}

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


# a replay of test_net's captured det_infer: the scans of the RPN's NMS and
# of the per-class NMS
DET_INFER_BODY = {"tile": 0, "flat": 0, "window": 0, "scan": 2, "kabsch": 0,
                  "pose_hyp": 0, "pose_refine": 0}


def phase_det_demo(card):
    """Phase 11: the detection family's training and evaluation at full
    width on lov_det.yaml, compiled, and the demo with --refine on 5
    rendered frames, compiled. Returns (each vote kernel's launches in the
    recorded demo run, its captured forward's launches, the detection
    family's results for the scan's entry of the kernels line)."""
    import tempfile

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from posecnn_torch.cli import demo, test_net, train_net
    from posecnn_torch.core.checkpoint import save_params
    from posecnn_torch.data.fabricate import write_demo_frames
    from posecnn_torch.data.procedural import synthetic_class_library
    from posecnn_torch.engine.train import CompiledDetTrainStep, TrainStep
    from posecnn_torch.ops.nms import box_suppression, greedy_keep, greedy_scan, greedy_scan_plain
    from posecnn_torch.ops.nms import nms
    from posecnn_torch.ops.rpn import _top_k
    from posecnn_torch.utils.bbox import bbox_transform_inv, clip_boxes
    from posecnn_torch.utils.graph import compile_static

    # 11.1: train_net's trainer on lov_det.yaml as written, its step compiled
    args = train_net.make_parser().parse_args(["--cfg", DET_CFG])
    t0 = time.perf_counter()
    tr = train_net.build_trainer(args, train_net.load_config(args))
    t, model, step, device = tr.cfg.train, tr.model, tr.step, tr.device
    if not isinstance(step, CompiledDetTrainStep):
        raise AssertionError(f"train_net's detection step is {type(step).__name__}, not compiled")
    dtype = str(model.compute_dtype).removeprefix("torch.")
    setup_s = time.perf_counter() - t0
    try:
        batches = [next(tr.batches) for _ in range(max(DET_STEPS, GATE_STEPS))]
    finally:
        tr.batches.close()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the same step eager, launch by launch, split by CUDA events
    split, metrics = [], []
    for batch in batches[:DET_STEPS]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, m = step.forward(tr.state, batch)
        ev[1].record()
        step.backward(total)
        ev[2].record()
        m["lr"] = step.update(tr.state)
        ev[3].record()
        torch.cuda.synchronize()
        split.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
        metrics.append({name: float(v) for name, v in m.items()})
    # a live eager graph keeps the parameters' AccumulateGrad nodes on this
    # stream, which the compiled step's capture below cannot depend on
    del total
    terms = {"rpn_cls", "rpn_box", "rcnn_cls", "rcnn_box", "loss_pose", "loss", "lr"}
    for i, m in enumerate(metrics):
        if not np.isfinite(list(m.values())).all() or set(m) != terms:
            raise AssertionError(f"det train step {i}: {m}")
    # a step's FLOPs on the eager step (the compiled one's first call would
    # run it and then capture it, counting the work twice)
    with FlopCounterMode(display=False) as counter:
        TrainStep.__call__(step, tr.state, batches[-1])
    flops = counter.get_total_flops()
    # the compiled step as train_net runs it: the first call is the batch's
    # real step and the capture, then DET_STEPS replays, every count set to
    # 0 just before them, the launches counted on the device
    step(tr.state, batches[0])
    (c_ms, c_launches, c_metrics, _, _), c_calls, _ = device_counted(
        lambda: timed_steps(step, tr.state, batches[:DET_STEPS]))
    (program,) = step.compiled.programs.values()
    if (c_launches != {k: DET_STEP[k] * DET_STEPS for k in COUNTED} or c_calls["scan"]
            or program.launches != DET_STEP):
        raise AssertionError(f"{DET_STEPS} replayed det steps launched {c_launches} on the device "
                             f"({c_calls} wrapper calls; {program.launches} captured), not "
                             f"{DET_STEP} a step")
    for i, m in enumerate(c_metrics):
        m = {name: float(v) for name, v in m.items()}
        if not np.isfinite(list(m.values())).all() or set(m) != terms:
            raise AssertionError(f"compiled det train step {i}: {m}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gate = equality_gate(step, tr.state, batches[:GATE_STEPS], "phase 11 lov_det.yaml (momentum)",
                         DET_STEP)
    # the RPN's proposal layer and its NMS alone, on the last batch's RPN;
    # the scan kernel against its plain version on its real (1, 2000) matrix
    h_im, w_im = batches[-1]["data"].shape[1:3]
    with torch.no_grad():
        _, rpn_cls, rpn_bbox, cls_prob = model.rpn(batches[-1]["data"])
        pkw = model.proposal_kw
        a = model.num_anchors
        anchors = model.anchors(rpn_cls.shape[1], rpn_cls.shape[2], device)
        scores, idx = _top_k(cls_prob[0][..., a:].reshape(-1), pkw["pre_nms_topk"])
        boxes = clip_boxes(bbox_transform_inv(anchors[idx], rpn_bbox[0].reshape(-1, 4)[idx]),
                           h_im, w_im)
        size_ok = ((boxes[:, 2] - boxes[:, 0] + 1 >= pkw["min_size"])
                   & (boxes[:, 3] - boxes[:, 1] + 1 >= pkw["min_size"]))
        sup = box_suppression(boxes, scores, pkw["nms_threshold"], size_ok)
        rpn_kept = greedy_scan(sup.kill[None], sup.sorted_valid[None])
        rpn_err, same = exact(rpn_kept, greedy_scan_plain(sup.kill[None], sup.sorted_valid[None]))
        if not same:
            raise AssertionError(f"{SCAN_KERNEL} disagrees with its plain version on the RPN's "
                                 f"{tuple(sup.kill.shape)} matrix of a lov_det forward")

        def host_ms(fn, n=5):
            fn()
            torch.cuda.synchronize()
            p0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - p0) / n * 1e3

        propose_ms = host_ms(lambda: model.propose(cls_prob, rpn_bbox, h_im, w_im))
        nms_ms = host_ms(lambda: nms(boxes, scores, pkw["nms_threshold"], valid=size_ok))
        host_scan_ms = host_ms(lambda: greedy_keep(box_suppression(
            boxes, scores, pkw["nms_threshold"], size_ok)))
        kept = int(nms(boxes, scores, pkw["nms_threshold"], valid=size_ok).sum())
        proposals = model.propose(cls_prob, rpn_bbox, h_im, w_im)
    rel, small_valid = det_card_vs_cpu(device)

    with tempfile.TemporaryDirectory() as tmp:
        trained = tr.state.step
        snapshot = os.path.join(tmp, "det", f"det_iter_{trained}.npz")
        save_params(snapshot, model, step=trained)  # what train_net's snapshot writes
        del tr, model, step, program, batches
        torch.cuda.empty_cache()
        # 11.2: test_net on the snapshot, compiled: recorded (every compiled
        # call held to its eager run, the launches counted on the device),
        # then timed, then with its programs eager; the two summaries equal
        det_eval = ["--cfg", DET_CFG, "--ckpt", snapshot, "--num_images", str(DET_EVAL_IMAGES)]
        result, run_eval = compiled_run(lambda: test_net.main(
            [*det_eval, "--output", os.path.join(tmp, "eval")]), [test_net],
            "test_net on lov_det.yaml")
        t0 = time.perf_counter()
        timed = test_net.main([*det_eval, "--output", os.path.join(tmp, "eval_timed")])
        eval_s = time.perf_counter() - t0
        compiled = test_net.compile_static
        test_net.compile_static = Eager
        try:
            eager_eval = test_net.main([*det_eval, "--output", os.path.join(tmp, "eval_eager")])
        finally:
            test_net.compile_static = compiled
        if not os.path.exists(os.path.join(tmp, "eval", "eval_det.json")) or not np.isfinite(
                result["map"]) or timed["run"]["images_per_s"] <= 0:
            raise AssertionError(f"test_net on lov_det.yaml: {result}")
        summaries = [{k: v for k, v in json.load(open(os.path.join(tmp, d, "eval_det.json"))
                                              ).items() if k != "run"}
                     for d in ("eval", "eval_eager")]
        if summaries[0] != summaries[1]:
            raise AssertionError("test_net on lov_det.yaml: the compiled run's eval_det.json "
                                 "differs from the eager run's")
        infer_bodies = run_eval["bodies"].get("det_infer", [])
        if (infer_bodies != [DET_INFER_BODY]
                or run_eval["replayed"] != {k: DET_INFER_BODY[k] * DET_EVAL_IMAGES for k in COUNTED}
                or run_eval["calls"] != DET_INFER_BODY):
            raise AssertionError(f"test_net on lov_det.yaml: the captured det_infer launched "
                                 f"{infer_bodies}, its {DET_EVAL_IMAGES} frames' replays "
                                 f"{run_eval['replayed']} (the eager warm-up {run_eval['calls']})")
        # det_pose as test_net compiles it, at detection counts a frame may
        # have (random weights may leave the run none): each replay of a
        # padded size equal to the eager call bit for bit
        pose = compile_static(test_net.det_pose)
        points = torch.from_numpy(synthetic_class_library(t.num_classes, 256).points).to(device)
        k_det = torch.tensor([[500.0, 0, w_im / 2], [0, 500.0, h_im / 2], [0, 0, 1]],
                             device=device)
        draw = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for n in (3, 5, 3, 17):
                rows = test_net.padded_rows(n)
                xy = torch.rand((rows, 2), generator=draw) * torch.tensor([w_im - 120.0,
                                                                           h_im - 120.0])
                wh = 20.0 + torch.rand((rows, 2), generator=draw) * 100.0
                pose_args = ((torch.rand((rows, 4), generator=draw) * 2 - 1).to(device),
                             torch.cat([xy, xy + wh], 1).to(device),
                             points[torch.arange(rows) % (t.num_classes - 1) + 1], k_det)
                got = [x.clone() for x in pose(*pose_args)]
                tree_exact(got, test_net.det_pose(*pose_args), f"det_pose at {n} detections")
        pose_rows = sorted(p.args[0].shape[0] for p in pose.programs.values())
        if pose_rows != [4, 8, 32]:
            raise AssertionError(f"det_pose at 3, 5, 3, 17 detections captured {pose_rows} rows")
        del pose
        torch.cuda.empty_cache()

        # 11.3: the demo on rendered frames with --refine, recording each
        # forward's Hough inputs
        images = os.path.join(tmp, "demo_images")
        f0 = time.perf_counter()
        write_demo_frames(images, DEMO_FRAMES)
        frames_s = time.perf_counter() - f0
        results, run_demo = compiled_run(lambda: demo.main(
            ["--images", images, *EVAL_ARGS, "--refine", "--output", os.path.join(tmp, "demo")]),
            [demo], "the demo")
        launches, replayed = run_demo["device"], run_demo["replayed"]
        recorded = run_demo["recorded"]
        written = sorted(os.listdir(os.path.join(tmp, "demo")))
    if len(results) != DEMO_FRAMES or len(recorded) != DEMO_FRAMES or len(written) != (
            2 * DEMO_FRAMES + 1):
        raise AssertionError(f"demo: {len(results)} frames, {len(recorded)} forwards, wrote "
                             f"{written}")
    demo_forwards = run_demo["bodies"]["forward_with_nms"]
    if any(replayed[k] != DEMO_FRAMES for k in ("flat", "window", "scan")) or (
            demo_forwards != [NMS_FORWARD]):
        raise AssertionError(f"demo: the replays of one captured forward must launch flat, "
                             f"window and scan once a frame: {replayed}, captured "
                             f"{demo_forwards}")
    for f in results:
        for d in f["detections"]:
            if not np.isfinite(d["quat_wxyz"] + d["trans"]).all():
                raise AssertionError(f"demo frame {f['frame']}: {d}")
    extents, kw = recorded.call
    shapes, errs = {}, {}
    for i, (label, vert, meta) in enumerate(recorded):
        sh, er = kernels_vs_plain(kw, extents, meta, {f"forward {i}": (label, vert)}, "the demo")
        shapes.update(sh)
        errs = {k: max(errs.get(k, 0.0), v) for k, v in er.items()}
    steady = np.mean(split[1:], 0)
    compiled_ms = float(np.mean(c_ms))
    run, sec = timed["run"], timed["run"]["seconds"]
    frame_ms = ", ".join(f"{1e3 * f['seconds']:.1f}" for f in results)
    print(f"phase 11 detection family and demo on {card}: train_net on lov_det.yaml "
          f"({t.num_classes} classes, {t.syn_height}x{t.syn_width}, batch 1, {a} anchors a "
          f"cell, pre_nms {t.rpn_pre_nms_top_n}, post_nms {t.rpn_post_nms_top_n}, "
          f"{t.batch_size} RoIs sampled, fc_dim {t.fc_dim}, {t.optimizer}, {dtype}), "
          f"set-up {setup_s:.1f} s; its step compiled (one CUDA graph, launches a replay "
          f"{DET_STEP}): {DET_STEPS} replays "
          + "/".join(f"{x:.2f}" for x in c_ms)
          + f" ms (CUDA events; mean {compiled_ms:.2f}, {1e3 / compiled_ms:.2f} images/s, MFU "
          f"{100 * flops / (compiled_ms / 1e3) / PEAK_BF16_FLOPS:.2f}%), launches counted on "
          f"the device {c_launches}; the same step eager, {DET_STEPS} steps, ms forward / "
          f"backward / optimizer (the first builds cuDNN plans): "
          + "; ".join("/".join(f"{x:.2f}" for x in row) for row in split)
          + f" (steps 2-{DET_STEPS} mean {'/'.join(f'{x:.2f}' for x in steady)}, sum "
          f"{steady.sum():.2f} ms, {1e3 / steady.sum():.2f} images/s), peak memory "
          f"{peak_gb:.2f} GB, {flops / 1e12:.3f} TFLOP a step (FlopCounterMode on the eager "
          f"step), MFU eager {100 * flops / (steady.sum() / 1e3) / PEAK_BF16_FLOPS:.2f}% of 989 "
          f"TFLOP/s bf16; losses of the last eager step "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics[-1].items())
          + f"; {gate['line']}; proposal_layer {propose_ms:.2f} ms (host clock to a "
          f"synchronise, mean of 5: top-{pkw['pre_nms_topk']} of {anchors.shape[0]} anchors, "
          f"decode, NMS, top-{pkw['post_nms_topk']}), of which NMS {nms_ms:.2f} ms on the "
          f"device scan against {host_scan_ms:.2f} ms with the host scan ({kept} of "
          f"{int(size_ok.sum())} boxes kept, {int(proposals.valid.sum())} valid proposals; "
          f"{SCAN_KERNEL} == plain bit for bit on that {tuple(sup.kill.shape)} matrix); "
          f"a small fp32 PoseCNNDet on the card == the CPU (proposals, anchor and RoI labels "
          f"equal, {small_valid} valid proposals; losses within {rel:.2e} relative) | "
          f"test_net on its {trained}-step snapshot, {DET_EVAL_IMAGES} held-out renders, "
          f"compiled: det_infer {timed['run']['graphs']['det_infer']} graph, det_pose "
          f"{timed['run']['graphs']['det_pose']} graphs; {run['images_per_s']:.2f} images/s "
          f"({eval_s:.1f} s with set-up) against {eager_eval['run']['images_per_s']:.2f} with "
          f"its programs eager, eval_det.json equal; seconds render / forward / extract / "
          f"evaluate {sec['render']:.3f} / {sec['forward']:.3f} / {sec['extract']:.3f} / "
          f"{sec['evaluate']:.3f} (eager "
          + " / ".join(f"{eager_eval['run']['seconds'][k]:.3f}" for k in
                       ("render", "forward", "extract", "evaluate"))
          + f"), {run['detections']} detections, mAP@0.5 {result['map']:.4f} over "
          f"{len(result['per_class'])} classes; recorded run: launches counted on the device "
          f"{run_eval['device']} (eager warm-up {run_eval['calls']}, replays "
          f"{run_eval['replayed']}), {run_eval['checked']} compiled calls == their eager runs "
          f"bit for bit; det_pose alone at 3, 5, 3, 17 detections: graphs at {pose_rows} rows, "
          f"each replay == its eager call bit for bit | demo "
          f"--refine on {DEMO_FRAMES} rendered 480x640 frames (written in {frames_s:.1f} s; the "
          f"flagship yaml's widths, seeded random weights; compiled calls recorded): ms a frame "
          f"{frame_ms}, detections "
          f"{[len(f['detections']) for f in results]} (classes "
          f"{[[d['class'] for d in f['detections']] for f in results]}), compiled: the forward "
          f"one graph ({demo_forwards[0]} a replay), ICP "
          f"{len(run_demo['bodies'].get('icp_refine_batch', []))} graphs, launches counted on "
          f"the device {launches} (eager warm-ups {run_demo['calls']}, graph replays "
          f"{replayed}), {run_demo['checked']} compiled calls "
          f"(forwards and ICP) == their eager runs bit for bit; the keep mask == the host scan "
          f"bit for bit on {run_demo['scanned']} forwards; "
          f"flat, window and tile == plain bit for bit on each of the {len(recorded)} forwards "
          f"(slots, live, samples, peak coarse vote: "
          f"{max(shapes.values(), key=lambda v: v[1])} at the liveliest), max_abs_err {errs}",
          flush=True)
    det = {"train_launches": c_launches, "per_replayed_step": DET_STEP["scan"],
           "gate_per_replay": gate["launches_per_replay"]["scan"], "rpn_max_abs_err": rpn_err,
           "test_net_launches": run_eval["device"]["scan"],
           "per_test_net_frame": run_eval["replayed"]["scan"] / DET_EVAL_IMAGES,
           "per_captured_det_infer": infer_bodies[0]["scan"], "compiled_ms": compiled_ms,
           "eager_ms": float(steady.sum())}
    return launches, demo_forwards[0], det


def split_steps(step, state, batches):
    """Each batch through `step.forward`, `.backward` and `.update` with
    CUDA events between: (ms forward / backward / optimizer per step,
    metrics per step). Raises on a non-finite loss or gradient."""
    import torch

    split, metrics = [], []
    for i, batch in enumerate(batches):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, m = step.forward(state, batch)
        ev[1].record()
        step.backward(total)
        ev[2].record()
        grads_ok = all(bool(torch.isfinite(p.grad).all()) for p in step.model.parameters()
                       if p.grad is not None)
        ev_upd = torch.cuda.Event(enable_timing=True)
        ev_upd.record()
        m["lr"] = step.update(state)
        ev[3].record()
        torch.cuda.synchronize()
        split.append([ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                      ev_upd.elapsed_time(ev[3])])
        metrics.append({name: float(v) for name, v in m.items()})
        if not grads_ok or not np.isfinite(list(metrics[-1].values())).all():
            raise AssertionError(f"step {i}: gradients finite {grads_ok}, metrics {metrics[-1]}")
    return split, metrics


def compiled_family(tr, batches, n, where):
    """A trainer's compiled step (a `CompiledStep`) as train_net runs it:
    the first call on batches[0] is the batch's real step and the capture,
    then n replays on batches[:n] timed with CUDA events, every count set to
    0 just before them; the capture records no CUDA kernel, the replays
    launch none on the device and call no wrapper, every metric is finite;
    one graph serves the run. Then the equality gate over GATE_STEPS
    batches. Returns {"ms": ms a replay, "peak_gb", "per_replay": the
    program's launches, "gate": the gate's result}."""
    import torch

    from posecnn_torch.engine.train import CompiledStep

    step, state = tr.step, tr.state
    if not isinstance(step, CompiledStep):
        raise AssertionError(f"{where}: train_net's step is {type(step).__name__}, not compiled")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, batches[0])
    (ms, launches, metrics, _, _), calls, _ = device_counted(
        lambda: timed_steps(step, state, batches[:n]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    programs = list(step.compiled.programs.values())
    if (len(programs) != 1 or programs[0].launches != NO_LAUNCH or launches != NO_LAUNCH
            or any(calls.values())):
        raise AssertionError(f"{where}: {len(programs)} graphs recording "
                             f"{[p.launches for p in programs]}; {n} replays launched {launches} "
                             f"on the device, {calls} through the wrappers; none expected")
    for i, m in enumerate(metrics):
        m = {name: float(v) for name, v in m.items()}
        if not np.isfinite(list(m.values())).all():
            raise AssertionError(f"{where}: compiled step {i}: {m}")
    gate = equality_gate(step, state, batches[:GATE_STEPS], where, NO_LAUNCH)
    return {"ms": ms, "peak_gb": peak_gb, "per_replay": dict(programs[0].launches), "gate": gate}


def describe_compiled(compiled, images, eager_ms):
    """The line of a `compiled_family` result: ms a replay, its mean
    beside the eager step's, images/s on it, peak memory, the gate."""
    mean = float(np.mean(compiled["ms"]))
    return (f"compiled (one CUDA graph, train_net's step): ms a replay (CUDA events) "
            + ", ".join(f"{x:.2f}" for x in compiled["ms"])
            + f" (mean {mean:.2f} against the eager step's {eager_ms:.2f}, "
            f"{1e3 * images / mean:.2f} images/s), peak memory {compiled['peak_gb']:.2f} GB, "
            f"launches a replay {compiled['per_replay']}; {compiled['gate']['line']}")


def seg_card_vs_cpu(device):
    """Small fp32 FCN8, ResNet50Seg and RecurrentSegNet on the card against
    the CPU with the same weights and inputs: the largest log-prob
    difference, within 1e-4."""
    import copy

    import torch

    from posecnn_torch.data.procedural import synthetic_class_library
    from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
    from posecnn_torch.models import FCN8, RecurrentSegNet, ResNet50Seg
    from posecnn_torch.models.posecnn import init_weights

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 96, 128, 3).astype(np.float32) * 40.0)
    lib = synthetic_class_library(4, 256)
    k = np.array([[90.0, 0, 64], [0, 90.0, 48], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=128, height=96, seed=3,
                                  point_colors=lib.colors, point_normals=lib.normals)
    seq = SyntheticSequenceGenerator(gen, num_steps=3).minibatch(1)
    blobs = [torch.from_numpy(seq[key]) for key in ("image", "depth", "meta")]
    errs = {}
    for name, model, inputs in (("fcn8", FCN8(4, fc_dim=64), [x]),
                                ("resnet50_seg", ResNet50Seg(4, num_units=16), [x]),
                                ("recurrent_seg", RecurrentSegNet(4, num_units=16), blobs)):
        init_weights(model, 1)
        if name == "recurrent_seg":  # a live gate, so the warped state matters
            torch.nn.init.normal_(model.fusion.gate.weight, 0.0, 0.1,
                                  generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            want = model(*inputs)[0]
            got = copy.deepcopy(model).to(device)(*(a.to(device) for a in inputs))[0].cpu()
        errs[name] = float((got - want).abs().max())
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"seg and video models on the card vs the CPU: {errs}")
    return errs


def volumes_equal(a, b, slab=32) -> bool:
    """Two TSDF volumes' tensors equal element for element, compared on
    the device a slab of x at a time (a whole grid-512 probability volume
    is 5.4 GB)."""
    import torch

    return all(torch.equal(x, y) if x.dim() == 0 else
               all(torch.equal(x[i:i + slab], y[i:i + slab]) for i in range(0, x.shape[0], slab))
               for x, y in zip(a, b))


def fusion_programs_at_grid(device):
    """Phase 12 (d): one frame (HEIGHT × WIDTH, FUSE_CLASSES classes) through
    `fuse_frame` at grid FUSE_GRID, then `raycast` and `track_camera` on
    it, each compiled (`compile_static`; the volume bound in place) and
    eager on a twin volume, the two held bit for bit (outputs, and both
    volumes after each call) at the compiled program's first call and a
    replay, then each timed by CUDA events; a fuse call with another
    volume must raise. Returns the line."""
    import torch

    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.refine.fusion import create_volume, fuse_frame, raycast, track_camera
    from posecnn_torch.utils.graph import compile_static

    def volume():
        return create_volume(FUSE_GRID, FUSE_CLASSES, origin=(-1.0, -1.0, 0.3),
                             voxel_size=2.0 / FUSE_GRID, device=device)

    vols = {"eager": volume(), "compiled": volume()}
    vol_gb = sum(t.numel() * t.element_size() for t in vols["eager"]) / 1e9
    gen = torch.Generator(device=device).manual_seed(1)
    depth = 0.8 + torch.rand((HEIGHT, WIDTH), device=device, generator=gen)
    prob = torch.softmax(torch.randn((HEIGHT, WIDTH, FUSE_CLASSES), device=device, generator=gen),
                         -1)
    kk = torch.tensor([[1066.8, 0, WIDTH / 2], [0, 1066.8, HEIGHT / 2], [0, 0, 1]], device=device)
    pose = torch.eye(3, 4, device=device)
    bodies = {"fuse_frame": fuse_frame, "raycast": raycast, "track_camera": track_camera}
    programs = {"fuse_frame": compile_static(fuse_frame, inplace=("vol",)),
                "raycast": compile_static(raycast, inplace=("vol",)),
                "track_camera": compile_static(track_camera)}
    calls = {"fuse_frame": lambda f, v: f(v, depth, prob, kk, pose),
             "raycast": lambda f, v: f(v, kk, pose, height=HEIGHT, width=WIDTH),
             "track_camera": lambda f, v: f(depth + 0.002, depth, kk, pose, num_iters=6)}
    ms, peak, fuses = {}, 0.0, 0
    for name, call in calls.items():
        for _ in range(2):  # the program's first call (eager, then the capture), then a replay
            want = call(bodies[name], vols["eager"])
            got = call(programs[name], vols["compiled"])
            if name != "fuse_frame":  # fuse_frame returns the volumes themselves
                tree_exact(got, want, f"{name} at grid {FUSE_GRID}: graph vs eager")
            if not volumes_equal(vols["compiled"], vols["eager"]):
                raise AssertionError(f"the volumes after {name} at grid {FUSE_GRID} differ")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms[name] = tuple(device_ms(lambda: call(f, vols[which]), device, 3, warm=False)
                         for f, which in ((bodies[name], "eager"), (programs[name], "compiled")))
        peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
        fuses += 5 if name == "fuse_frame" else 0
    if not volumes_equal(vols["compiled"], vols["eager"]):
        raise AssertionError(f"the volumes after the timed calls at grid {FUSE_GRID} differ")
    updated = int((vols["compiled"].weight == fuses).sum())
    try:
        calls["fuse_frame"](programs["fuse_frame"], vols["eager"])
    except ValueError:
        pass
    else:
        raise AssertionError("fuse_frame compiled: a call with another volume did not raise")
    graphs = {name: len(p.programs) for name, p in programs.items()}
    del vols, programs
    torch.cuda.empty_cache()
    return (f"fuse_frame, raycast and track_camera at grid {FUSE_GRID} with {FUSE_CLASSES} "
            f"classes ({HEIGHT}x{WIDTH} frame): compiled == eager bit for bit (outputs and "
            f"volumes, first call and a replay), graphs {graphs}, a call with another volume "
            f"refused; ms a frame eager / compiled (CUDA events, mean of 3): "
            + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in ms.items())
            + f"; peak memory {peak:.2f} GB with two volumes of {vol_gb:.2f} GB, {updated} "
            f"voxels updated by all {fuses} fuses")


def phase_seg_video(device, card):
    """Phase 12: the segmentation and video families' training, eager and
    compiled (each held to eager by the equality gate), the video
    evaluation, compiled and eager, and fusion at full width. Returns (the
    vote kernels' launches in the phase, all 0; the CUDA kernels' launches
    a replay of each compiled step and of test_video's forward, by name,
    all 0)."""
    import tempfile

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from posecnn_torch.cli import test_fusion, test_video, train_net
    from posecnn_torch.core.checkpoint import save_params
    from posecnn_torch.data.fabricate import write_ycb_tree
    from posecnn_torch.ops import hough_kernels as hk
    from posecnn_torch.ops.flow import compute_flow
    from posecnn_torch.utils.graph import compile_static

    for key in hk.LAUNCHES:
        hk.LAUNCHES[key] = 0
    parts, families = [], {}

    def run(argv, steps, where=None):
        """build_trainer on argv, `steps` held batches through split_steps
        (the step eager, split); then, named by `where`, the compiled step
        (`compiled_family`: timed replays, the equality gate): (trainer,
        split, metrics, peak GB, FLOPs of one more eager step, set-up s, the
        batches, the compiled step's results or None)."""
        args = train_net.make_parser().parse_args(argv)
        t0 = time.perf_counter()
        tr = train_net.build_trainer(args, train_net.load_config(args))
        try:
            batches = [next(tr.batches) for _ in range(max(steps, GATE_STEPS if where else 0))]
        finally:
            tr.batches.close()
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        split, metrics = split_steps(tr.step, tr.state, batches[:steps])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the eager step: the compiled one's first call would capture under the counter
        with FlopCounterMode(display=False) as counter:
            tr.step.eager(tr.state, batches[steps - 1])
        if any(hk.LAUNCHES.values()):  # compiled_family's counts start from 0
            raise AssertionError(f"phase 12 launched a vote kernel: {dict(hk.LAUNCHES)}")
        compiled = compiled_family(tr, batches, steps, where) if where else None
        return (tr, split, metrics, peak_gb, counter.get_total_flops(), setup_s,
                batches[:steps], compiled)

    def describe(split, flops, peak_gb, peak_flops, peak_name):
        steady = np.mean(split[1:], 0)
        return ("ms forward / backward / optimizer (CUDA events; the first builds cuDNN plans) "
                + "; ".join("/".join(f"{x:.2f}" for x in row) for row in split)
                + f" (steps 2-{len(split)} mean {'/'.join(f'{x:.2f}' for x in steady)}), peak "
                f"memory {peak_gb:.2f} GB, {flops / 1e12:.3f} TFLOP a step (FlopCounterMode), "
                f"MFU {100 * flops / (steady.sum() / 1e3) / peak_flops:.2f}% of {peak_name}")

    # 12.1: the segmentation family on the fcn8 yaml, as FCN8 and ResNet50Seg
    for network, extra in SEG_SET.items():
        tr, split, metrics, peak_gb, flops, setup_s, _, compiled = run(
            ["--cfg", cfg_path(SEG_CFG), *extra], SEG_STEPS, f"phase 12 {network}")
        families[network] = compiled["per_replay"]
        t = tr.cfg.train
        width = f"fc_dim {t.fc_dim}" if network == "fcn8" else f"num_units {t.num_units}"
        parts.append(f"{network} on {SEG_CFG}.yaml ({t.num_classes} classes, {t.syn_height}x"
                     f"{t.syn_width}, batch {t.ims_per_batch}, {width}, "
                     f"{str(tr.model.compute_dtype).removeprefix('torch.')}, set-up {setup_s:.1f}"
                     f" s): {describe(split, flops, peak_gb, PEAK_BF16_FLOPS, '989 TFLOP/s bf16')}"
                     f", losses {', '.join(f'{m['loss']:.4f}' for m in metrics)}; "
                     + describe_compiled(compiled, t.ims_per_batch, np.mean(split[1:], 0).sum()))
        del tr
        torch.cuda.empty_cache()
    errs = seg_card_vs_cpu(device)
    parts.append("small fp32 models on the card == the CPU, log-probs within "
                 + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    with tempfile.TemporaryDirectory() as tmp:
        # 12.2: the video family on lov_color_rnn.yaml, synthetic sequences
        tr, split, metrics, peak_gb, flops, setup_s, batches, compiled = run(
            ["--cfg", cfg_path(RNN_CFG)], RNN_STEPS, "phase 12 recurrent_seg")
        families["recurrent_seg"] = compiled["per_replay"]
        t, model, grid = tr.cfg.train, tr.model, tr.cfg.test.grid_size
        snapshot = os.path.join(tmp, "rnn", f"rnn_iter_{tr.state.step}.npz")
        save_params(snapshot, model, step=tr.state.step)  # what train_net's snapshot writes
        # compute_flow alone on a step's frames 0 → 1: the warp of frame 1,
        # forward and forward + backward
        depth, meta = batches[-1]["depth"], batches[-1]["meta"]
        b, h, w, u = depth.shape[1], depth.shape[2], depth.shape[3], t.num_units
        zeros = torch.zeros((b, h, w, u), device=device)
        points = compute_flow(zeros, zeros, torch.zeros((b, h, w, 3), device=device), depth[0],
                              meta[0])[2]
        depth, meta = depth[1], meta[1]
        gen = torch.Generator(device=device).manual_seed(0)
        state = torch.randn((b, h, w, u), device=device, generator=gen).requires_grad_(True)
        weights = torch.rand((b, h, w, u), device=device, generator=gen).requires_grad_(True)

        def flow_ms(backward, n=5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            for i in range(n + 1):
                if i == 1:
                    ev[0].record()
                out = compute_flow(state, weights, points, depth, meta)
                if backward:
                    (out[0].sum() + out[1].sum()).backward()
            ev[1].record()
            torch.cuda.synchronize()
            return ev[0].elapsed_time(ev[1]) / n, float((out[1] != 1).float().mean())

        (flow_f, matched), (flow_fb, _) = flow_ms(False), flow_ms(True)
        parts.append(f"recurrent_seg on {RNN_CFG}.yaml ({t.num_classes} classes, T = "
                     f"{t.num_steps}, batch {t.ims_per_batch}, {t.syn_height}x{t.syn_width}, "
                     f"num_units {t.num_units}, fp32, set-up {setup_s:.1f} s): "
                     f"{describe(split, flops, peak_gb, PEAK_FP32_OPS, '67 TFLOP/s fp32')}, "
                     f"losses {', '.join(f'{m['loss']:.4f}' for m in metrics)}; compute_flow "
                     f"{flow_f:.2f} ms a frame forward, {flow_fb:.2f} ms forward + backward "
                     f"(CUDA events, mean of 5; {100 * matched:.1f}% of pixels matched); "
                     + describe_compiled(compiled, t.ims_per_batch, np.mean(split[1:], 0).sum()))
        del tr, model, state, weights, batches
        torch.cuda.empty_cache()

        # the real-video feed: a fabricated YCB-Video tree with a moving camera
        root = os.path.join(tmp, "lov")
        t0 = time.perf_counter()
        write_ycb_tree(root, sets=(("train", 6),), video_length=6, moving_camera=True)
        fab_s = time.perf_counter() - t0
        tr, split, metrics, peak_gb, _, setup_s, _, _ = run(
            ["--cfg", cfg_path(RNN_CFG), "--dataset", "ycb_video", "--data_root", root],
            RNN_REAL_STEPS)
        parts.append(f"recurrent_seg on a fabricated moving-camera YCB-Video tree (6 frames "
                     f"written in {fab_s:.1f} s, set-up {setup_s:.1f} s): ms forward / backward "
                     f"/ optimizer " + "; ".join("/".join(f"{x:.2f}" for x in row)
                                                 for row in split)
                     + f", losses {', '.join(f'{m['loss']:.4f}' for m in metrics)}, peak memory "
                     f"{peak_gb:.2f} GB")
        del tr
        torch.cuda.empty_cache()

        # 12.3: test_video on the video snapshot, its forward compiled
        # (recorded: every call held to its eager body, the launches counted
        # on the device), then with its program eager; the two
        # video_eval.json equal but for the seconds
        video_argv = ["--cfg", cfg_path(RNN_CFG), "--ckpt", snapshot, "--num_sequences",
                      str(VIDEO_SEQUENCES), "--num_steps", str(t.num_steps)]
        runs = {}
        for name in ("compiled", "eager"):
            out = os.path.join(tmp, f"video_{name}")
            t0 = time.perf_counter()
            if name == "compiled":
                results, video_run = compiled_run(
                    lambda: test_video.main([*video_argv, "--output", out]), [test_video],
                    "test_video")
            else:
                test_video.compile_static = Eager
                try:
                    results = test_video.main([*video_argv, "--output", out])
                finally:
                    test_video.compile_static = compile_static
            with open(os.path.join(out, "video_eval.json")) as f:
                written = json.load(f)
            runs[name] = (results, written, time.perf_counter() - t0)
        results, written, video_s = runs["compiled"]
        bodies = video_run["bodies"].get("video_labels", [])
        steps = t.num_steps
        want_checks = {"video_labels": VIDEO_SEQUENCES, "fuse_frame": VIDEO_SEQUENCES * steps,
                       "track_camera": VIDEO_SEQUENCES * (steps - 1)}
        if (len(results) != VIDEO_SEQUENCES or not all(np.isfinite(r["mean_iou"]) for r in results)
                or any(video_run["bodies"].get(name) != [NO_LAUNCH] for name in want_checks)
                or video_run["device"] != NO_LAUNCH or video_run["checks"] != want_checks):
            raise AssertionError(f"test_video compiled: {results}; graphs {video_run['bodies']}, "
                                 f"device launches {video_run['device']}, calls held to eager "
                                 f"{video_run['checks']} (want {want_checks})")

        def without_seconds(rows):
            return [{k: v for k, v in r.items() if k != "seconds"} for r in rows]

        if without_seconds(written) != without_seconds(runs["eager"][1]):
            raise AssertionError(f"test_video: the compiled video_eval.json {written} differs "
                                 f"from the eager one {runs['eager'][1]}")
        sec = {k: sum(r["seconds"][k] for r in results) for k in test_video.STAGES}
        forward_s = {name: [r["seconds"]["forward"] for r in runs[name][0]] for name in runs}
        parts.append(f"test_video on its snapshot ({VIDEO_SEQUENCES} sequences of {t.num_steps} "
                     f"frames, grid {grid}, {video_s:.1f} s with set-up): seconds "
                     + " / ".join(f"{k} {v:.3f}" for k, v in sec.items())
                     + "; forward s a sequence (host clock to the labels' fetch) compiled "
                     + ", ".join(f"{x:.4f}" for x in forward_s["compiled"])
                     + " (the first its eager run and capture), eager "
                     + ", ".join(f"{x:.4f}" for x in forward_s["eager"])
                     + f"; one graph each for the forward, fuse_frame (the volume bound in "
                     f"place) and track_camera, calls equal to their eager bodies bit for bit "
                     f"{video_run['checks']}, launches on the device {video_run['device']}; "
                     "video_eval.json equal to the eager run's but for the seconds; IoU "
                     + ", ".join(f"{r['mean_iou']:.4f}" for r in results)
                     + "; surface points " + ", ".join(str(r["surface_points"]) for r in results)
                     + "; tracked motion m " + ", ".join(
                         "/".join(f"{x:.4f}" for x in r["tracked_motion_m"]) for r in results))
        torch.cuda.empty_cache()

        # 12.4: test_fusion at its grid 64, its four programs compiled
        # (recorded: each call held to its eager body, the launches counted
        # on the device), then eager; the two reports equal
        fusion = {}
        for name in ("compiled", "eager"):
            out = os.path.join(tmp, f"fusion_{name}")
            t0 = time.perf_counter()
            if name == "compiled":
                report, fusion_run = compiled_run(lambda: test_fusion.main(["--output", out]),
                                                  [test_fusion], "test_fusion")
            else:
                test_fusion.compile_static = Eager
                try:
                    report = test_fusion.main(["--output", out])
                finally:
                    test_fusion.compile_static = compile_static
            fusion[name] = (report, time.perf_counter() - t0)
            if not os.path.exists(os.path.join(out, "model.ply")) or report[
                    "surface_points"] <= 0:
                raise AssertionError(f"test_fusion ({name}): {report}")
        report, fusion_s = fusion["compiled"]
        n = report["num_steps"]
        want_checks = {"fuse_frame": n, "raycast": 2 * n - 1, "track_camera": n - 1,
                       "extract_mesh": 1}
        if (report != fusion["eager"][0] or fusion_run["checks"] != want_checks
                or any(fusion_run["bodies"].get(k) != [NO_LAUNCH] for k in want_checks)
                or fusion_run["device"] != NO_LAUNCH):
            raise AssertionError(f"test_fusion compiled: report {report} (eager "
                                 f"{fusion['eager'][0]}), calls held to eager "
                                 f"{fusion_run['checks']} (want {want_checks}), graphs "
                                 f"{fusion_run['bodies']}, device launches {fusion_run['device']}")
    torch.cuda.empty_cache()
    grid_line = fusion_programs_at_grid(device)
    parts.append(f"test_fusion (grid {report['grid_size']}, compiled {fusion_s:.1f} s, eager "
                 f"{fusion['eager'][1]:.1f} s with set-up): the four programs one graph each, "
                 f"calls equal to their eager bodies bit for bit {fusion_run['checks']}, launches "
                 f"on the device {fusion_run['device']}, the report equal to the eager run's; "
                 f"surface points "
                 f"{report['surface_points']}, classes {report['surface_classes']}, "
                 f"{report['mesh_triangles']} triangles, raycast depth MAE "
                 f"{report['raycast_depth_mae_m']:.4f} m, label accuracy "
                 f"{report['raycast_fg_label_acc']:.4f}, tracking errors deg "
                 f"{[round(x, 3) for x in report['tracking_rot_err_deg']]}; {grid_line}")
    launches = dict(hk.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"phase 12 launched a vote kernel: {launches}")
    print(f"phase 12 segmentation, video and fusion on {card}: " + " | ".join(parts)
          + f" | vote kernel launches {launches}", flush=True)
    families["test_video"] = bodies[0]
    return launches, families


def gan_card_vs_cpu(device):
    """One small GAN step (3 classes, 48×64, num_units 8, seg + vertex,
    keep_prob 1) on the card and on the CPU from the same weights and
    batch, in fp64 (the scores and vertex maps cast to fp32, as the model
    casts them): the losses within 1e-4 relative, every generator and
    discriminator gradient within 1e-3 of its tensor's largest entry. In
    fp32 a ReLU or leaky-ReLU input within ~1e-6 of zero falls on either
    side of its kink on the two devices and moves a gradient by ~1e-3.
    Returns (largest relative loss difference, largest gradient one)."""
    import copy

    import torch

    from posecnn_torch.core.config import cfg_from_dict
    from posecnn_torch.data.procedural import synthetic_class_library
    from posecnn_torch.data.synthetic import SyntheticSceneGenerator
    from posecnn_torch.engine.train import create_gan_train_state, make_gan_train_step
    from posecnn_torch.models.gan import FeatureDiscriminator
    from posecnn_torch.models.posecnn import PoseCNN, init_weights

    c, h, w = 3, 48, 64
    lib = synthetic_class_library(c, 256)
    k = np.array([[90.0, 0, w / 2], [0, 90.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=w, height=h, seed=4,
                                  point_colors=lib.colors, point_normals=lib.normals)
    batch = {key: torch.from_numpy(v) for key, v in
             gen.minibatch(2, max_gt=8, dense_vertex_targets=False).items() if key != "depth"}
    cfg = cfg_from_dict({"train": {"num_classes": c, "num_units": 8, "vertex_reg_2d": True,
                                   "gan": True, "learning_rate": 2e-4, "vertex_w": 10.0}})
    model, disc = PoseCNN(c, num_units=8, fc_dim=32, pose_reg=False), FeatureDiscriminator(3 * c + 3)
    init_weights(model, 0)
    init_weights(disc, 1)
    for mod in list(model.modules()) + list(disc.modules()):
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    model, disc = model.double(), disc.double()
    batch = {key: v.double() if v.dtype == torch.float32 else v for key, v in batch.items()}
    runs = []
    for dev in (device, torch.device("cpu")):
        m, d = copy.deepcopy(model).to(dev), copy.deepcopy(disc).to(dev)
        state = create_gan_train_state(cfg, m, d)
        step = make_gan_train_step(cfg, m, d, *(torch.from_numpy(a).to(dev).double() for a in (
            lib.points[:, :32], lib.extents, lib.symmetry)), keep_prob=1.0)
        # the eager twin: compile_step holds fp32 metrics, this step's are fp64
        metrics = step.eager(state, {key: v.to(dev) for key, v in batch.items()})
        grads = {f"{side}.{name}": p.grad.cpu() for side, mod in (("g", m), ("d", d))
                 for name, p in mod.named_parameters()}
        runs.append(({key: float(v) for key, v in metrics.items()}, grads))
    (got, got_g), (want, want_g) = runs
    loss_rel = max(abs(got[key] - want[key]) / max(abs(want[key]), 1e-12) for key in want)
    grad_rel, worst = max((float((got_g[n] - want_g[n]).abs().max())
                           / max(float(want_g[n].abs().max()), 1e-12), n) for n in want_g)
    if set(got) != set(want) or loss_rel > 1e-4 or grad_rel > 1e-3:
        raise AssertionError(f"GAN step on the card vs the CPU: losses {got} / {want}, "
                             f"gradients within {grad_rel:.2e} of their largest entry ({worst})")
    return loss_rel, grad_rel


def switched_steps(tr, steps, want):
    """`steps` batches from a switched trainer's feed (the host clock of
    each wait), the feed stopped, then a train step on each, split into
    forward / backward / optimizer (CUDA events): every metric finite, the
    terms exactly `want` (with lr), and no vote kernel launched. Returns
    (rows of ms: wait, forward, backward, optimizer; metrics; peak GB;
    the batches; the feed's production seconds)."""
    import torch

    from posecnn_torch.ops import hough_kernels as hk

    waits, batches = [], []
    try:
        for _ in range(steps):
            w0 = time.perf_counter()
            batches.append(next(tr.batches))
            waits.append(1e3 * (time.perf_counter() - w0))
    finally:
        tr.batches.close()
    rows, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, (wait, batch) in enumerate(zip(waits, batches)):
        for key in hk.LAUNCHES:
            hk.LAUNCHES[key] = 0
        split, m = split_steps(tr.step, tr.state, [batch])
        launches = dict(hk.LAUNCHES)
        if any(launches.values()) or set(m[0]) != want | {"lr"}:
            raise AssertionError(f"switched step {i}: launches {launches}, terms "
                                 f"{sorted(m[0])}, want {sorted(want)}")
        rows.append([wait, *split[0]])
        metrics.append(m[0])
    return (rows, metrics, torch.cuda.max_memory_allocated() / 1e9, batches,
            list(tr.batches.produce_seconds))


def phase_switches_gan(device, card):
    """Phase 13: the GAN step at full width, eager and compiled (held to
    eager by the equality gate), the switched posecnn yamls on fabricated
    trees, the evaluation of a switched snapshot and the inspection CLIs.
    Returns (the kernels' launches in that test_net run, the CUDA kernels'
    launches a replay of the compiled GAN step, all 0)."""
    import contextlib
    import io
    import tempfile

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from posecnn_torch.cli import check_data, render_poses, test_net, test_synthesis, train_net
    from posecnn_torch.core.checkpoint import save_params, snapshot_path
    from posecnn_torch.data.fabricate import write_linemod_tree, write_ycb_tree
    from posecnn_torch.engine.train import decompress_feed
    from posecnn_torch.ops import hough_kernels as hk
    from posecnn_torch.utils.debug import finite_check

    parts = []
    # 13.1: the GAN step on its yaml as written
    args = train_net.make_parser().parse_args(["--cfg", cfg_path(GAN_CFG)])
    t0 = time.perf_counter()
    tr = train_net.build_trainer(args, train_net.load_config(args))
    setup_s = time.perf_counter() - t0
    t, step, state = tr.cfg.train, finite_check(tr.step), tr.state
    try:
        batches = [next(tr.batches) for _ in range(max(GAN_STEPS, GATE_STEPS))]
    finally:
        tr.batches.close()
    for key in hk.LAUNCHES:
        hk.LAUNCHES[key] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the step eager, split by CUDA events
    split, metrics = [], []
    for batch in batches[:GAN_STEPS]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        total, m, fake = step.forward(state, batch)
        ev[1].record()
        step.backward(total)
        ev[2].record()
        m["lr"] = step.update(state)
        ev[3].record()
        m["loss_d"] = step.discriminator(state, batch, fake)
        ev[4].record()
        torch.cuda.synchronize()
        split.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
        metrics.append({name: float(v) for name, v in m.items()})
    # a live eager graph keeps the parameters' AccumulateGrad nodes on this
    # stream, which the compiled step's capture cannot depend on
    del total, fake
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gan_launches = dict(hk.LAUNCHES)
    want = {"loss", "loss_cls", "loss_vertex", "loss_g_adv", "loss_d", "lr"}
    if any(gan_launches.values()) or not all(set(m) == want and np.isfinite(
            list(m.values())).all() for m in metrics):
        raise AssertionError(f"GAN steps: launches {gan_launches}, metrics {metrics}")
    # the eager step: the compiled one's first call would capture under the counter
    with FlopCounterMode(display=False) as counter:
        step.eager(state, batches[GAN_STEPS - 1])
    flops = counter.get_total_flops()
    steady = np.mean(split[1:], 0)
    # the compiled step as train_net runs it: both updates in one graph
    compiled = compiled_family(tr, batches, GAN_STEPS, "phase 13 GAN")
    loss_rel, grad_rel = gan_card_vs_cpu(device)
    parts.append(
        f"GAN step on {GAN_CFG}.yaml ({t.num_classes} classes, {t.syn_height}x{t.syn_width}, "
        f"batch {t.ims_per_batch}, num_units {t.num_units}, vertex_w {t.vertex_w}, lr "
        f"{t.learning_rate:g}, {t.optimizer}, gan_weight {t.gan_weight}, "
        f"{str(tr.model.trunk.compute_dtype).removeprefix('torch.')} generator, fp32 discriminator; "
        f"set-up {setup_s:.1f} s): {GAN_STEPS} steps, ms generator forward / backward / "
        f"optimizer / discriminator step (CUDA events; the first builds cuDNN plans) "
        + "; ".join("/".join(f"{x:.2f}" for x in row) for row in split)
        + f" (steps 2-{GAN_STEPS} mean {'/'.join(f'{x:.2f}' for x in steady)}, "
        f"{1e3 * t.ims_per_batch / steady.sum():.2f} images/s on the step's device time), "
        f"peak memory {peak_gb:.2f} GB, {flops / 1e12:.3f} TFLOP a step (FlopCounterMode), "
        f"MFU {100 * flops / (steady.sum() / 1e3) / PEAK_BF16_FLOPS:.2f}% of 989 TFLOP/s bf16; "
        f"loss_d {', '.join(f'{m['loss_d']:.4f}' for m in metrics)}, loss_g_adv "
        f"{', '.join(f'{m['loss_g_adv']:.4g}' for m in metrics)}, every loss and gradient "
        f"finite (utils/debug.finite_check), vote launches {gan_launches}; "
        + describe_compiled(compiled, t.ims_per_batch, steady.sum())
        + f"; a small fp64 GAN step on the card == the CPU (losses within {loss_rel:.2e} "
        f"relative, gradients within {grad_rel:.2e} of their largest entry)")
    del tr, step, state, batches
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # 13.2: the switched yamls, 3 steps each
        root, lm_root = os.path.join(tmp, "lov"), os.path.join(tmp, "linemod")
        t0 = time.perf_counter()
        write_ycb_tree(root, sets=(("train", SWITCH_FRAMES[0]), ("val", SWITCH_FRAMES[1])))
        os.makedirs(lm_root)
        write_linemod_tree(lm_root, "ape")
        fab_s = time.perf_counter() - t0
        runs = {"lov_color_3d": ["--dataset", "lov", "--data_root", root],
                "linemod_ape_3d": ["--dataset", "linemod", "--cls", "ape", "--data_root",
                                   lm_root],
                "rgbd_scene_single_depth": []}
        snapshot = None
        for name, extra in runs.items():
            out = os.path.join(tmp, name)
            args = train_net.make_parser().parse_args(
                ["--cfg", cfg_path(name), "--output", out, *extra])
            t0 = time.perf_counter()
            tr = train_net.build_trainer(args, train_net.load_config(args))
            setup_s = time.perf_counter() - t0
            t = tr.cfg.train
            heads = [n for n in ("vertex_head", "pose_head", "domain_head")
                     if getattr(tr.model, n) is not None]
            want = {"loss", "loss_cls"} | ({"loss_vertex"} if heads else set())
            rows, metrics, peak_gb, batches, produced = switched_steps(tr, SWITCH_STEPS, want)
            if name == "lov_color_3d":
                snapshot = snapshot_path(out, t.snapshot_prefix, t.snapshot_infix, tr.state.step)
                save_params(snapshot, tr.model, step=tr.state.step, meta=tr.head_meta)
                # the last batch's GT Hough inputs (live slots) for the
                # kernels at test_net's shapes below
                b = decompress_feed(batches[-1], tr.cfg)
                gt_inputs, gt_meta = gt_hough_inputs(tr, b), b["meta"]
            rows = np.asarray(rows)
            steady = rows[1:].mean(0)
            parts.append(
                f"{name} (input {tr.cfg.input}, {t.num_classes} classes, "
                f"{tr.cfg.train.syn_height}x{tr.cfg.train.syn_width} x scales_base "
                f"{t.scales_base[0]}, batch {t.ims_per_batch}, vertex_reg_2d {t.vertex_reg_2d}, "
                f"vertex_reg_3d {t.vertex_reg_3d}, pose_reg {t.pose_reg}: heads "
                f"{heads or 'seg only'}; set-up {setup_s:.1f} s): ms feed wait (the feed "
                f"running) / forward / backward / optimizer (on the held batches, the feed "
                f"stopped) " + "; ".join("/".join(f"{x:.2f}" for x in row) for row in rows)
                + f" (steps 2-{SWITCH_STEPS} mean {'/'.join(f'{x:.2f}' for x in steady)}, "
                f"{1e3 * t.ims_per_batch / steady[1:].sum():.2f} images/s on the step's device "
                f"time), batch production {', '.join(f'{1e3 * x:.0f}' for x in produced)} ms, "
                f"peak memory {peak_gb:.2f} GB, terms of the last step "
                + ", ".join(f"{k} {v:.4f}" for k, v in metrics[-1].items())
                + ", no vote launch")
            del tr, batches
            torch.cuda.empty_cache()

        # 13.3: test_net on the seg + vertex snapshot: every head built,
        # the pose head's seeded; render_poses on its results
        out = os.path.join(tmp, "eval")
        captured = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            summary, run_net = compiled_run(lambda: test_net.main(
                ["--dataset", "lov", "--data_root", root, "--cfg", cfg_path("lov_color_3d"),
                 "--ckpt", snapshot, "--num_images", str(SWITCH_FRAMES[1]), "--save_results",
                 "--output", out]), [test_net], "test_net on the switched snapshot")
        eval_s = time.perf_counter() - t0
        launches, replayed = run_net["device"], run_net["replayed"]
        recorded = run_net["recorded"]
        kept = [line.split(" has no ")[1].split(";")[0]
                for line in captured.getvalue().splitlines() if "kept the model" in line]
        if kept != ["pose_head"]:
            raise AssertionError(f"test_net on the seg + vertex snapshot kept {kept}, not the "
                                 "pose head alone")
        n = SWITCH_FRAMES[1]
        if any(replayed[k] != n for k in ("flat", "window", "scan")) or len(recorded) != n:
            raise AssertionError(f"test_net on the switched snapshot: replays launched "
                                 f"{replayed}, {len(recorded)} forwards")
        extents, kw = recorded.call
        shapes, errs = {}, {}
        for i, (label, vert, meta) in [*enumerate(recorded), ("GT", (*gt_inputs, gt_meta))]:
            sh, er = kernels_vs_plain(kw, extents, meta, {f"forward {i}": (label, vert)},
                                      "test_net on the switched snapshot")
            shapes.update(sh)
            errs = {k: max(errs.get(k, 0.0), v) for k, v in er.items()}
        if shapes["forward GT"][1] == 0:
            raise AssertionError("the switched step's GT Hough inputs have no live slot")
        run = summary["run"]
        if not np.isfinite([summary["seg_mean_iou"], run["images_per_s"]]).all():
            raise AssertionError(f"test_net on the switched snapshot: {summary}")
        written = render_poses.main(["--results", out, "--output", os.path.join(tmp, "poses")])
        if written != n:
            raise AssertionError(f"render_poses wrote {written} renderings of {n}")
        parts.append(
            f"test_net --dataset lov on the {SWITCH_STEPS}-step lov_color_3d snapshot "
            f"({n} val frames, {eval_s:.1f} s with set-up, compiled calls recorded): every "
            f"head built, the file's "
            f"missing {kept[0]} kept at its seeded values and named; "
            f"{run['images_per_s']:.2f} images/s, "
            f"{run['detections']} detections, seg mean IoU {summary['seg_mean_iou']:.4f}, "
            f"launches counted on the device {launches} (graph replays {replayed}); flat, "
            f"window and "
            f"tile == plain bit for bit at its Hough's "
            f"shapes on each of the {len(recorded)} forwards' inputs and on the last lov_color_3d "
            f"batch's GT inputs (slots, live, samples, peak coarse vote: "
            + "; ".join(f"{k} {v}" for k, v in shapes.items())
            + f"), max_abs_err {errs}; render_poses drew {written} results_NNNN.npz")

        # 13.4: check_data and test_synthesis on the flagship yaml
        t0 = time.perf_counter()
        check_data.main(["--cfg", TRAIN_CFG, "--num_samples", "2", "--output",
                         os.path.join(tmp, "check")])
        check_s = time.perf_counter() - t0
        images = sorted(os.listdir(os.path.join(tmp, "check")))
        report = test_synthesis.main(["--cfg", TRAIN_CFG, "--num_samples",
                                      str(SYNTHESIS_SAMPLES), "--output",
                                      os.path.join(tmp, "synthesis")])
        if len(images) != 10 or not report["tz_within_config"]:
            raise AssertionError(f"check_data wrote {images}; test_synthesis {report}")
        parts.append(
            f"check_data on the flagship yaml: {len(images)} images in {check_s:.1f} s; "
            f"test_synthesis: {report['scenes_per_sec']} scenes/s on this machine's host "
            f"({SYNTHESIS_SAMPLES} 480x640 scenes), {report['mean_objects_per_scene']:.2f} "
            f"objects a scene, foreground {report['mean_fg_fraction']:.3f}, tz "
            f"{[round(z, 3) for z in report['tz_range']]} within the config, quaternion norm "
            f"error {report['max_quat_norm_err']:.2e}")
        fab_line = (f"fabricated trees (YCB-Video {SWITCH_FRAMES[0]} + {SWITCH_FRAMES[1]} "
                    f"frames at 480x640, LINEMOD's indexes and extents) in {fab_s:.1f} s")
    print(f"phase 13 head switches, GAN step and inspection CLIs on {card}: {fab_line} | "
          + " | ".join(parts), flush=True)
    return launches, {"gan": compiled["per_replay"]}


def textured_generator(cfg, seed, native=True):
    """A 480×640 generator of the 22-class procedural library painted by
    `colorize_model_library(orient_detail=True)`, through YCB's camera, at
    the cfg's depth range; the C++ loops or (`native=False`) numpy."""
    from posecnn_torch.cli.common import YCB_K
    from posecnn_torch.data.procedural import colorize_model_library, make_procedural_objects
    from posecnn_torch.data.synthetic import SyntheticSceneGenerator

    proc = make_procedural_objects(NUM_CLASSES, 2620, seed=0)
    colors, normals = colorize_model_library(proc.points, orient_detail=True)
    return SyntheticSceneGenerator(proc.points, proc.extents, YCB_K, width=WIDTH, height=HEIGHT,
                                   t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
                                   pixel_means=cfg.pixel_means, seed=seed, point_colors=colors,
                                   point_normals=normals, native=native)


def render_library_vs_numpy(cfg, seed):
    """One `textured_generator` scene rendered through the C++ loops and
    through the numpy path, 1 warm-up and RENDERS timed each; the splats
    held bit for bit, the dense vertex targets within 1e-6. Returns
    (library ms, numpy ms a scene, the targets' largest difference)."""
    gens = [textured_generator(cfg, seed, native) for native in (True, False)]
    secs, target_err = [0.0, 0.0], 0.0
    for i in range(RENDERS + 1):
        scenes = []
        for j, gen in enumerate(gens):
            t0 = time.perf_counter()
            scenes.append(gen.render())
            if i > 0:  # after the warm-up
                secs[j] += time.perf_counter() - t0
        got, want = scenes
        for name in ("image", "label", "depth", "vertex_weights", "poses", "meta"):
            if not np.array_equal(getattr(got, name), getattr(want, name)):
                raise AssertionError(f"render {i}: the library's {name} differs from numpy's")
        err = float(np.abs(got.vertex_targets - want.vertex_targets).max())
        if not err <= 1e-6:
            raise AssertionError(f"render {i}: vertex targets differ by {err} (> 1e-6)")
        target_err = max(target_err, err)
        if not (got.label > 0).any():
            raise AssertionError(f"render {i}: nothing rendered")
    return 1e3 * secs[0] / RENDERS, 1e3 * secs[1] / RENDERS, target_err


def counting_hough(recorded):
    """`recording_hough`'s stand-in that also keeps each call's kernel
    launches under `recorded.launches`; returns (the stand-in, the original)."""
    from posecnn_torch.ops import hough_kernels as hk

    import torch

    record, original = recording_hough(recorded)
    recorded.launches = []

    def counted(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            return record(*args, **kw)  # recorded by nothing (see recording_hough)
        before = dict(hk.LAUNCHES)
        out = record(*args, **kw)
        recorded.launches.append({k: hk.LAUNCHES[k] - before[k] for k in KERNELS})
        return out

    return counted, original


def recorded_vs_plain(recorded, where):
    """Each recorded Hough call launched flat and window once, and both
    (and tile) equal their plain versions on its inputs, bit for bit.
    Returns the largest error of each kernel."""
    for i, counts in enumerate(recorded.launches):
        if counts["flat"] != 1 or counts["window"] != 1:
            raise AssertionError(f"{where}, step {i + 1}: launches {counts}, not 1 flat and "
                                 "1 window")
    extents, kw = recorded.call
    errs = {k: 0.0 for k in KERNELS}
    for i, (label, vert, meta) in enumerate(recorded):
        _, err = kernels_vs_plain(kw, extents, meta, {f"step {i + 1}": (label, vert)}, where)
        errs = {k: max(errs[k], err[k]) for k in KERNELS}
    return errs


def caffe_vgg16_npy(path, seed, fc_dim=4096):
    """A Caffe-layout vgg16.npy at VGG16's shapes, seeded random values:
    13 convs (HWIO), fc6 (25088, fc_dim), fc7 (fc_dim, fc_dim) and the
    1000-way fc8, each with biases (VGG16's own fc_dim is 4096)."""
    from posecnn_torch.models.vgg16 import VGG16_STAGES

    rng = np.random.default_rng(seed)
    data, cin = {}, 3
    for stage, (cout, n) in enumerate(VGG16_STAGES, start=1):
        for i in range(1, n + 1):
            data[f"conv{stage}_{i}"] = {
                "weights": 0.01 * rng.standard_normal((3, 3, cin, cout), np.float32),
                "biases": 0.01 * rng.standard_normal(cout, np.float32)}
            cin = cout
    for name, shape in (("fc6", (25088, fc_dim)), ("fc7", (fc_dim, fc_dim)),
                        ("fc8", (fc_dim, 1000))):
        data[name] = {"weights": 0.001 * rng.standard_normal(shape, np.float32),
                      "biases": 0.01 * rng.standard_normal(shape[1], np.float32)}
    np.save(path, data, allow_pickle=True)
    return data


def resumed_adam_gate(out, sets):
    """Phase 14's compiled Adam resume of the flagship: `train_net
    --resume` from the newest snapshot under `out` (the handoff run's, at
    step HANDOFF_ITERS), as the JAX CLI resumes: the step continued, count
    0 and every Adam `step` and moment 0 read back from the card,
    `lr_step_offset` at the step and the device rate `schedule(0 +
    offset)`. Its first replay is held to eager resumed steps from the same
    state by `equality_gate`'s three parts; one more replay then reads back
    count and steps 1 and the same rate, launching one flat and one window
    kernel. Returns the line to print."""
    import torch

    from posecnn_torch.cli import train_net
    from posecnn_torch.engine.train import lr_schedule

    t0 = time.perf_counter()
    args = train_net.make_parser().parse_args(
        ["--cfg", TRAIN_CFG, "--output", out, "--resume", "--set", *sets])
    tr = train_net.build_trainer(args, train_net.load_config(args))
    try:
        batch = next(tr.batches)
    finally:
        tr.batches.close()
    opt = tr.state.opt
    tensors = tr.state.state_tensors()  # Adam's, made where its first update makes them
    steps = [opt.opt.state[p]["step"] for p in opt.params]
    zero = not any(bool(t.any()) for t in tensors)
    rate = opt.prepare()
    device_rate = float(opt.lr)
    base = dataclasses.replace(tr.cfg, train=dataclasses.replace(tr.cfg.train, lr_step_offset=0))
    if not (tr.state.step == tr.cfg.train.lr_step_offset == HANDOFF_ITERS and opt.count == 0
            and zero and all(t.is_cuda for t in steps) and opt.opt.param_groups[0]["fused"]
            and rate == lr_schedule(base)(HANDOFF_ITERS)
            and device_rate == float(np.float32(rate))):
        raise AssertionError(f"resumed Adam: step {tr.state.step}, offset "
                             f"{tr.cfg.train.lr_step_offset}, count {opt.count}, zero state "
                             f"{zero}, rate {rate} (device {device_rate})")
    gate = equality_gate(tr.step, tr.state, [batch], "phase 14 resumed Adam (flagship)",
                         C2F_STEP, live_hough_inputs, resumed=True)
    _, _, launches = device_counted(lambda: tr.step(tr.state, batch))
    after = {float(t) for t in steps}
    if opt.count != 1 or after != {1.0} or float(opt.lr) != device_rate or (
            launches != C2F_STEP):
        raise AssertionError(f"resumed Adam's replay: count {opt.count}, steps {after}, device "
                             f"rate {float(opt.lr)}, launches {launches}")
    line = (f"compiled Adam resume of the flagship from {os.path.basename(args.ckpt)}: step "
            f"{HANDOFF_ITERS}, lr_step_offset {HANDOFF_ITERS}, count 0 and every Adam step and "
            f"moment 0 read back from the card, device rate {device_rate:g} = schedule(0 + "
            f"offset); {gate['line']}; one more replay: count 1, every Adam step 1 on the "
            f"card, the same rate, launches {launches}; {time.perf_counter() - t0:.1f} s with "
            f"set-up")
    del tr, gate, batch
    torch.cuda.empty_cache()
    return line


def phase_slice11(card, native_build_s):
    """Phase 14: the C++ data-path library against the numpy path, the
    shard store, the host-RSS handoff and --resume, --pretrained, the
    overfit guard and export_coco. Returns the kernels' launches in its
    train_net runs (the handoff, the resume and the --pretrained steps)."""
    import contextlib
    import io
    import itertools
    import tempfile

    import torch

    from posecnn_torch.cli import export_coco, probe_overfit, train_net
    from posecnn_torch.core.config import cfg_from_file
    from posecnn_torch.data import ShardReader, write_shards
    from posecnn_torch.data.fabricate import write_ycb_tree
    from posecnn_torch.engine.train import host_rss_gb, make_train_step
    from posecnn_torch.models import posecnn as posecnn_module
    from posecnn_torch.ops import hough_kernels as hk

    wall0 = time.perf_counter()
    parts = []
    cfg = cfg_from_file(TRAIN_CFG)
    # 14.1: the library against the numpy path
    lib_ms, numpy_ms, target_err = render_library_vs_numpy(cfg, cfg.rng_seed)
    parts.append(
        f"data/native built by g++ in {native_build_s:.2f} s (beside nvcc, phase 1); one 480x640 "
        f"textured 22-class scene (flagship yaml, YCB camera, orient paint) {lib_ms:.1f} ms "
        f"through the library, {numpy_ms:.1f} ms through numpy ({numpy_ms / lib_ms:.2f}x; "
        f"{RENDERS} renders each after a warm-up, this machine's host), splats bit for bit, "
        f"vertex targets within {target_err:.3g}")

    with tempfile.TemporaryDirectory() as tmp:
        # 14.2: the shard store
        gen = textured_generator(cfg, 1)
        t0 = time.perf_counter()
        paths = write_shards(gen, os.path.join(tmp, "shards"), SHARD_SCENES, samples_per_shard=8)
        write_s = time.perf_counter() - t0
        pool = np.random.default_rng(2).integers(0, 256, (4, HEIGHT, WIDTH, 3), np.uint8)
        reader = ShardReader(os.path.join(tmp, "shards"), NUM_CLASSES, cfg.pixel_means, seed=3,
                             chromatic=True, backgrounds=pool)
        t0 = time.perf_counter()
        samples = [reader.sample() for _ in range(SHARD_READS)]
        read_s = time.perf_counter() - t0
        bad = [i for i, sm in enumerate(samples) if sm["image"].shape != (HEIGHT, WIDTH, 3)
               or not np.isfinite(sm["image"]).all() or sm["label"].max() >= NUM_CLASSES
               or not (sm["label"] > 0).any() or sm["poses"].shape[1] != 13]
        if len(paths) != SHARD_SCENES // 8 or bad:
            raise AssertionError(f"shards: {len(paths)} files, bad samples {bad[:5]}")
        parts.append(
            f"write_shards: {SHARD_SCENES} scenes at 480x640 through the library in "
            f"{write_s:.2f} s ({SHARD_SCENES / write_s:.2f} scenes/s, {len(paths)} files, "
            f"{sum(os.path.getsize(p) for p in paths) / 1e6:.1f} MB); ShardReader: "
            f"{SHARD_READS} samples with chromatic jitter and a 4-frame background pool in "
            f"{read_s:.2f} s ({SHARD_READS / read_s:.1f} samples/s, this machine's host)")

        # 14.3: the host-RSS handoff, then --resume with it off
        out = os.path.join(tmp, "handoff")
        limit = host_rss_gb() / 2  # the RSS only grows from here, so step 1 passes it
        sets = ["train.hough_backend=auto", "train.display=1"]

        def run_train_net(*flags):
            argv = ["--cfg", TRAIN_CFG, "--output", out, "--iters", str(HANDOFF_ITERS), *flags]
            args = train_net.make_parser().parse_args(argv)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                state = train_net.main_run(args, train_net.load_config(args), HANDOFF_ITERS)
            return state, buf.getvalue(), time.perf_counter() - t0

        recorded = Recorded()
        counted, original = counting_hough(recorded)

        def handoff_and_resume():
            state, handoff_log, handoff_s = run_train_net(
                "--set", *sets, f"train.max_host_rss_gb={limit:.3f}")
            snaps = sorted(os.listdir(out))
            if state.step != 1 or "snapshotting and exiting" not in handoff_log or not any(
                    f.endswith("_iter_1.npz") for f in snaps):
                raise AssertionError(f"handoff: ended at step {state.step}, files {snaps}, "
                                     f"log tail {handoff_log[-400:]!r}")
            return handoff_s, *run_train_net("--resume", "--set", *sets)

        posecnn_module.hough_voting = counted
        try:
            (handoff_s, state, resume_log, resume_s), _, launches = device_counted(
                handoff_and_resume)
        finally:
            posecnn_module.hough_voting = original
        # each run's first step is eager (its Hough recorded), the resumed
        # run's second a replay of the graph its first captured
        if state.step != HANDOFF_ITERS or "_iter_1.npz" not in resume_log or (
                "snapshotting" in resume_log) or len(recorded) != 2 or (
                launches["flat"], launches["window"]) != (HANDOFF_ITERS, HANDOFF_ITERS):
            raise AssertionError(f"--resume: ended at step {state.step}, {len(recorded)} eager "
                                 f"steps, launches {launches}, log tail {resume_log[-400:]!r}")
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        if len(losses) != HANDOFF_ITERS or not np.isfinite(losses).all():
            raise AssertionError(f"handoff and resume logged {losses}")
        # the resumed pass's Adam started again at count 0 (JAX's resume):
        # its count and every Adam step, read back from the card, are the
        # pass's HANDOFF_ITERS - 1 updates
        adam_steps = {float(state.opt.opt.state[p]["step"]) for p in state.opt.params}
        if state.opt.count != HANDOFF_ITERS - 1 or adam_steps != {HANDOFF_ITERS - 1.0}:
            raise AssertionError(f"--resume: count {state.opt.count}, Adam steps {adam_steps} "
                                 f"after {HANDOFF_ITERS - 1} resumed updates")
        handoff_errs = recorded_vs_plain(recorded, "the handoff and resume steps")
        parts.append(
            f"train_net on the flagship yaml (c2f) with train.max_host_rss_gb={limit:.3f} "
            f"(half the process's RSS before it): snapshotted at iteration 1 and returned in "
            f"{handoff_s:.1f} s with set-up; --resume from it to iteration {HANDOFF_ITERS} with "
            f"the handoff off in {resume_s:.1f} s (Adam restarted: count and steps read back "
            f"{HANDOFF_ITERS - 1} after its {HANDOFF_ITERS - 1} updates); losses "
            f"{[round(x, 4) for x in losses]}; "
            f"launches {launches} (counted on the device: flat and window once a step, the "
            f"compiled step's first call in each run eager, the resumed run's last a replay), "
            f"== plain bit for bit on each of the {len(recorded)} eager steps' inputs, "
            f"max_abs_err {handoff_errs}")
        del state, recorded
        torch.cuda.empty_cache()
        parts.append(resumed_adam_gate(out, sets))
        torch.cuda.empty_cache()

        # 14.4: --pretrained from a full-shape Caffe-layout vgg16.npy
        npy = os.path.join(tmp, "vgg16.npy")
        argv = ["--cfg", TRAIN_CFG, "--output", os.path.join(tmp, "pretrained"), "--pretrained",
                npy, "--set", "train.hough_backend=auto"]
        args = train_net.make_parser().parse_args(argv)
        run_cfg = train_net.load_config(args)
        t0 = time.perf_counter()
        data = caffe_vgg16_npy(npy, 4, run_cfg.train.fc_dim)
        npy_s = time.perf_counter() - t0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tr = train_net.build_trainer(args, run_cfg)
        line = next((ln for ln in buf.getvalue().splitlines() if "import_vgg16_npy" in ln), "")
        try:
            loaded = line.split("(")[-1].rstrip(")").split(", ")
            conv = tr.model.trunk.conv1_1.weight.detach().cpu().numpy()
            fc6 = tr.model.pose_head.fc6.weight.detach().cpu().numpy()
            if "loaded 15 kernels" not in line or "fc8" in loaded or len(loaded) != 15:
                raise AssertionError(f"--pretrained: {line!r}")
            if not (np.array_equal(conv, data["conv1_1"]["weights"].transpose(3, 2, 0, 1))
                    and np.array_equal(fc6, data["fc6"]["weights"].T)):
                raise AssertionError("--pretrained: conv1_1 or fc6 differs from the npy")
            del data, conv, fc6
            step = make_train_step(tr.cfg, tr.model, tr.points, tr.extents, tr.symmetry)
            recorded = Recorded()
            counted, original = counting_hough(recorded)
            posecnn_module.hough_voting = counted
            try:
                pre_ms, pre_launches, pre_metrics, _, _ = timed_steps(
                    step, tr.state, itertools.islice(tr.batches, PRETRAINED_STEPS))
            finally:
                posecnn_module.hough_voting = original
        finally:
            tr.batches.close()
        check_train_steps(pre_launches, pre_metrics)
        launches = {k: launches[k] + pre_launches[k] for k in KERNELS}
        pre_errs = recorded_vs_plain(recorded, "the --pretrained steps")
        parts.append(
            f"--pretrained: a Caffe-layout vgg16.npy at VGG16's shapes (13 convs, fc6 "
            f"25088x{run_cfg.train.fc_dim}, fc7, fc8 1000-way; seeded) written in {npy_s:.1f} s; {line.strip()} "
            f"(fc8 skipped); conv1_1 and the pose head's fc6 equal the npy (HWIO -> OIHW, "
            f"(in, out) -> (out, in)) before the first step; {PRETRAINED_STEPS} steps, ms "
            f"(CUDA events) {', '.join(f'{x:.2f}' for x in pre_ms)}, loss "
            f"{float(pre_metrics[-1]['loss']):.4f}, launches {pre_launches} in "
            f"{PRETRAINED_STEPS} compiled steps (the first eager, its Hough == plain bit for "
            f"bit, max_abs_err {pre_errs}); launches in phase 14's train_net runs "
            f"{launches}")
        del tr, step, recorded
        torch.cuda.empty_cache()

        # 14.5: the overfit guard at the recipe's settings, on a fabricated tree
        root = os.path.join(tmp, "lov")
        t0 = time.perf_counter()
        write_ycb_tree(root, sets=(("train", COCO_FRAMES),))
        fab_s = time.perf_counter() - t0
        for key in hk.LAUNCHES:
            hk.LAUNCHES[key] = 0
        out_json = os.path.join(tmp, "guard.json")
        t0 = time.perf_counter()
        rc = probe_overfit.main(["--data_root", root, "--iters", str(GUARD_ITERS), "--sweep",
                                 "adam:0.0003", "--assert_below", str(GUARD_DEG), "--out",
                                 out_json])
        guard_s = time.perf_counter() - t0
        with open(out_json) as f:
            guard = json.load(f)[0]
        if rc != 0 or not guard["min_rot_err"] < GUARD_DEG:
            raise AssertionError(f"overfit guard: rc {rc}, {guard['min_rot_err']} deg")
        parts.append(
            f"overfit guard (probe_overfit --iters {GUARD_ITERS} --sweep adam:0.0003 "
            f"--assert_below {GUARD_DEG}, class 1, 160x160, batch 2, dense Hough; the fabricated "
            f"tree written in {fab_s:.1f} s): min rotation error {guard['min_rot_err']} deg, "
            f"final {guard['final_rot_err']} deg, {guard['ms_per_step']:.2f} ms a step, phase "
            f"wall {guard_s:.1f} s, vote kernel launches {dict(hk.LAUNCHES)}")

        # 14.6: export_coco, rendered and from the tree's frames
        coco = []
        for name, argv in (
                ("synthetic", ["--cfg", TRAIN_CFG, "--dataset", "synthetic", "--data_root",
                               root, "--num_images", str(COCO_IMAGES)]),
                ("dataset", ["--dataset", "lov", "--data_root", root, "--num_images", "0"])):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                written = export_coco.main([*argv, "--output", os.path.join(tmp, name)])
            secs = time.perf_counter() - t0
            want_images = COCO_IMAGES if name == "synthetic" else COCO_FRAMES
            if len(written["images"]) != want_images or not written["annotations"] or not (
                    os.path.exists(os.path.join(tmp, name, "annotations.json"))):
                raise AssertionError(f"export_coco {name}: {len(written['images'])} images, "
                                     f"{len(written['annotations'])} annotations")
            coco.append(f"{name}: {len(written['images'])} images, "
                        f"{len(written['annotations'])} annotations, "
                        f"{len(written['categories'])} categories in {secs:.2f} s")
        parts.append("export_coco " + "; ".join(coco))
    print(f"phase 14 data-path library, shards, host-RSS handoff, --pretrained, overfit guard "
          f"and export_coco on {card} (phase wall {time.perf_counter() - wall0:.1f} s): "
          + " | ".join(parts), flush=True)
    return launches


def _dp_flagship_rank(rank, device, out_dir):
    """One rank of phase 15 (b): the flagship trainer on this rank's share,
    DP_STEPS steps timed by parts, the checks after each; its results go
    to `out_dir/<rank>.json`."""
    import torch
    import torch.distributed as dist

    from posecnn_torch.cli import train_net
    from posecnn_torch.models import posecnn as posecnn_module
    from posecnn_torch.ops import hough_kernels as hk
    from posecnn_torch.parallel.mesh import all_gather, create_mesh

    args = train_net.make_parser().parse_args(
        ["--cfg", TRAIN_CFG, "--set", "train.hough_backend=auto"])
    mesh = create_mesh(num_data=DP_RANKS)
    tr = train_net.build_trainer(args, train_net.load_config(args), mesh=mesh, device=device)
    step, state = tr.step, tr.state
    recorded = Recorded()
    counted, original = counting_hough(recorded)
    events = {}

    def timed_sync(sync=step.sync_gradients):
        events["backward_end"].record()
        sync()
        events["sync_end"].record()

    step.sync_gradients = timed_sync
    posecnn_module.hough_voting = counted
    torch.cuda.reset_peak_memory_stats()
    rows = []
    try:
        for i in range(DP_STEPS):
            batch = next(tr.batches)
            events.update({k: torch.cuda.Event(enable_timing=True)
                           for k in ("start", "forward_end", "backward_end", "sync_end", "end")})
            events["start"].record()
            total, metrics = step.forward(state, batch)
            events["forward_end"].record()
            step.backward(total)
            step.update(state)
            events["end"].record()
            torch.cuda.synchronize()
            names = list(metrics)
            values = torch.stack([metrics[k].float() for k in names])
            every = all_gather(values, mesh.world_group)
            sums = torch.stack([p.detach().double().sum() for p in tr.model.parameters()])
            every_sum = all_gather(sums, mesh.world_group)
            ms = [events[a].elapsed_time(events[b]) for a, b in
                  (("start", "forward_end"), ("forward_end", "backward_end"),
                   ("backward_end", "sync_end"), ("sync_end", "end"))]
            rows.append({"metrics": dict(zip(names, values.tolist())),
                         "same_metrics": bool((every == every[0]).all()),
                         "same_params": bool((every_sum == every_sum[0]).all()),
                         "finite": bool(torch.isfinite(values).all()),
                         "ms": ms, "launches": recorded.launches[-1]})
    finally:
        posecnn_module.hough_voting = original
        tr.batches.close()
    errs = recorded_vs_plain(recorded, f"phase 15 rank {rank}")
    bucket = sum(p.numel() for p in tr.model.parameters())
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump({"rows": rows, "errs": errs, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "bucket_mb": bucket * 4 / 1e6, "local_batch": int(batch["data"].shape[0])}, f)
    dist.barrier()


def phase_data_parallel(card):
    """Phase 15: data parallelism on the card (see the module docstring).
    Returns each kernel's launches in the flagship ranks' steps, both
    ranks together."""
    import gc
    import tempfile

    import torch

    from posecnn_torch.cli import train_net
    from posecnn_torch.parallel.dryrun import (
        dryrun_case,
        dryrun_multichip,
        parity,
        run_ranks,
        step_once,
    )
    from posecnn_torch.parallel.mesh import spawn_ranks

    wall0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    print(f"phase 15 data parallelism on {card}: ranks are processes on the one card over gloo "
          "with CUDA tensors (staged through host memory), an exercise of the data-parallel "
          "code on the device, not a scaling figure", flush=True)
    parts = []
    # (a) parity, fp32 with TF32 off (setup_device), keep_prob 1
    case = dryrun_case(4)
    one = step_once(case, "cuda")
    many = run_ranks([([case], 2, 1)], devices=["cuda:0"] * 2, backend="gloo")[0][0]
    dloss, dparam = parity(one, many)
    tp = dryrun_multichip(4, device="cuda", backend="gloo")
    for what, dl, dp in (("DP2", dloss, dparam), ("DP2xTP2", tp["dloss"], tp["dparam"])):
        if not (dl <= DP_DLOSS and dp <= DP_DPARAM):
            raise AssertionError(f"phase 15 {what} parity: |dloss| {dl}, max|dparam| {dp} over "
                                 f"{DP_DLOSS} / {DP_DPARAM}")
    parts.append(
        f"(a) dry-run config fp32, 2 ranks x batch 2 vs one process at batch 4: |dloss| "
        f"{dloss:.3g}, max|dparam| {dparam:.3g}; dryrun_multichip(4) DP2xTP2: |dloss| "
        f"{tp['dloss']:.3g}, max|dparam| {tp['dparam']:.3g} (bars {DP_DLOSS} / {DP_DPARAM}; "
        "MULTICHIP_r05 at DP4xTP2 on 8 virtual CPU devices: 3.81e-06 / 7.41e-08)")
    # (b) the flagship step, 2 ranks x 4 on cuda:0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(_dp_flagship_rank, DP_RANKS, (tmp,), devices=["cuda:0"] * DP_RANKS,
                    backend="gloo", rendezvous_dir=tmp)
        flagship_s = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"{r}.json")) as f:
                ranks.append(json.load(f))
    launches = {k: 0 for k in KERNELS}
    for r, res in enumerate(ranks):
        for i, row in enumerate(res["rows"]):
            if not (row["finite"] and row["same_metrics"] and row["same_params"]):
                raise AssertionError(f"phase 15 rank {r} step {i + 1}: finite {row['finite']}, "
                                     f"metrics equal across ranks {row['same_metrics']}, "
                                     f"parameters equal {row['same_params']}")
            for k in KERNELS:
                launches[k] += row["launches"][k]
    per_rank = []
    for r, res in enumerate(ranks):
        split = np.array([row["ms"] for row in res["rows"]])
        per_rank.append(
            f"rank {r}: forward / backward / all-reduce / optimizer ms "
            + "; ".join(" / ".join(f"{v:.2f}" for v in step_ms) for step_ms in split)
            + f", peak {res['peak_gb']:.2f} GB, flat / window max_abs_err "
            f"{res['errs']['flat']} / {res['errs']['window']}")
    m = ranks[0]["rows"][-1]["metrics"]
    parts.append(
        f"(b) flagship yaml, {DP_RANKS} ranks x {ranks[0]['local_batch']} images (global 8, "
        f"bf16, adam, GT RoIs), {DP_STEPS} steps in {flagship_s:.1f} s with set-up: losses "
        f"finite and equal on both ranks, parameters equal across ranks after every step (fp64 "
        f"sums, bit for bit), flat / window {launches['flat']} / {launches['window']} launches "
        f"(once a step a rank), bit for bit equal to plain; all-reduce bucket "
        f"{ranks[0]['bucket_mb']:.1f} MB fp32; last step loss {m['loss']:.4f}, num_pose_rois "
        f"{m['num_pose_rois']:.0f}; " + " | ".join(per_rank))
    # (b) then the CLI's own rank path on the same yaml and device map:
    # train_loop(mesh=) with the recipe's RSS limit judged on both ranks at
    # every iteration, rank 0 alone logging and snapshotting
    with tempfile.TemporaryDirectory() as tmp:
        args = train_net.make_parser().parse_args(
            ["--cfg", TRAIN_CFG, "--iters", str(DP_STEPS), "--output", tmp, "--set",
             "train.hough_backend=auto", "train.display=1",
             f"train.max_host_rss_gb={DP_RSS_GB}"])
        t0 = time.perf_counter()
        train_net.launch_data_parallel(args, train_net.load_config(args), DP_STEPS, DP_RANKS,
                                       devices=["cuda:0"] * DP_RANKS, backend="gloo")
        launch_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        snaps = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
    iters = [row["iter"] for row in logged]
    if iters != list(range(1, DP_STEPS + 1)) or len(snaps) != 1 or not snaps[0].endswith(
            f"_iter_{DP_STEPS}.npz") or not all(np.isfinite(row["loss"]) for row in logged):
        raise AssertionError(f"phase 15 (b) launch_data_parallel: logged iterations {iters}, "
                             f"losses {[row['loss'] for row in logged]}, snapshots {snaps}")
    parts.append(
        f"(b) the same yaml through train_net.launch_data_parallel ({DP_RANKS} ranks on cuda:0 "
        f"over gloo, train_loop with the mesh, train.max_host_rss_gb={DP_RSS_GB} judged on both "
        f"ranks every iteration): {DP_STEPS} steps in {launch_s:.1f} s with set-up, rank 0's "
        f"log of iterations {iters}, losses "
        + ", ".join(f"{row['loss']:.4f}" for row in logged)
        + f", one snapshot ({snaps[0]})")
    # (c) the CLI on the CPU, 2 gloo processes
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "posecnn_torch.cli.train_net", "--device",
                              "cpu", "--num_data", "2", "--iters", "2", "--output", tmp,
                              *DP_TOY], capture_output=True, text=True, timeout=600,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        snaps = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
        logged = open(os.path.join(tmp, "metrics.jsonl")).read().splitlines() if os.path.exists(
            os.path.join(tmp, "metrics.jsonl")) else []
        if cli.returncode != 0 or snaps != ["posecnn_iter_2.npz"] or len(logged) != 2:
            raise AssertionError(f"phase 15 (c): rc {cli.returncode}, snapshots {snaps}, "
                                 f"{len(logged)} log lines; {cli.stderr[-2000:]}")
    parts.append(f"(c) train_net --num_data 2 --device cpu --iters 2 (48x64 toy): exit 0 in "
                 f"{cli_s:.1f} s, 2 log lines, one snapshot ({snaps[0]})")
    # (e) `bench scaling` (JAX's experiments/bench_scaling.py) at 1 and 2
    # ranks; on one card both ranks share it over gloo: the mechanism
    from posecnn_torch import bench

    t0 = time.perf_counter()
    lines = bench.bench_scaling(torch.device("cuda"), ranks=SCALING_RANKS)
    scaling_s = time.perf_counter() - t0
    sizes = [line for line in lines if "s_per_iter" in line]
    effs = [line for line in lines if "weak_scaling_efficiency" in line]
    numbers = [line[k] for line in sizes for k in ("s_per_iter", "images_per_s", "loss")]
    numbers += [line["weak_scaling_efficiency"] for line in effs]
    one_card = torch.cuda.device_count() < SCALING_RANKS
    if ([line["devices"] for line in sizes] != [1, SCALING_RANKS] or len(effs) != 1
            or not all(np.isfinite(x) and x > 0 for x in numbers)
            or one_card != (lines[-1].get("scaling") == "mechanism")):
        raise AssertionError(f"phase 15 (e) bench scaling: {lines}")
    parts.append(f"(e) python -m posecnn_torch.bench scaling --ranks {SCALING_RANKS} "
                 f"({scaling_s:.1f} s): " + "; ".join(json.dumps(line) for line in lines))
    # (d) NCCL across cards, where the machine has them
    cards = torch.cuda.device_count()
    if cards < 2:
        parts.append("phase 15 (d) not run: 1 card")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "posecnn_torch.cli.train_net", "--cfg",
                            TRAIN_CFG, "--num_data", "-1", "--iters", "6", "--output", tmp,
                            "--set", "train.hough_backend=auto", "train.display=1"],
                           check=True, timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
            with open(os.path.join(tmp, "metrics.jsonl")) as f:
                s_per_iter = [json.loads(line)["s_per_iter"] for line in f][-1]
        batch = max(8, cards) // cards * cards  # the flagship's batch 8, rounded to the ranks
        parts.append(f"(d) train_net --num_data -1 over NCCL on {cards} cards, flagship yaml: "
                     f"{batch / s_per_iter:.1f} images/s over 6 steps (phase 8: one card), "
                     f"{time.perf_counter() - t0:.1f} s")
    print(f"phase 15 data parallelism on {card} (phase wall {time.perf_counter() - wall0:.1f} "
          "s): " + " | ".join(parts), flush=True)
    return launches


ORACLE_IMAGES = 4  # phase 16 (d): held-out scenes the rotation oracle scores


def counted_run(call, where):
    """call() with the model's Hough recorded and the kernels' counts set
    to 0 just before it and read just after (`device_counted`: the
    launches the kernels counted on the device, eager ones and a compiled
    train step's replays); then each recorded (eager) Hough call held to
    its plain versions (`recorded_vs_plain`). Returns (call's result, its
    launches, the recorded calls)."""
    from posecnn_torch.models import posecnn as posecnn_module

    recorded = Recorded()
    stand_in, original = counting_hough(recorded)
    posecnn_module.hough_voting = stand_in
    try:
        out, _, launches = device_counted(call)
    finally:
        posecnn_module.hough_voting = original
    recorded_vs_plain(recorded, where)
    return out, launches, recorded


def hough_shape(recorded):
    """'K slots, S = n' of a recorded Hough call: B images of up to
    `max_classes` (8) present foreground classes each."""
    label, _, _ = recorded[0]
    extents, kw = recorded.call
    slots = label.shape[0] * min(kw.get("max_classes", 8), extents.shape[0] - 1)
    return f"{slots} slots, S = {kw['num_samples']}"


def phase_entry_bench(card):
    """Phase 16: the JAX repository's measurement entry points on the card
    (see the module docstring). Returns each kernel's launches in each
    eager run of the phase's paths (counted from 0) and per captured
    forward of each graph."""
    import gc
    import tempfile

    import torch

    from posecnn_torch import bench
    from posecnn_torch.cli import eval_rotation_oracle
    from posecnn_torch.core.checkpoint import save_params
    from posecnn_torch.core.config import cfg_from_file
    from posecnn_torch.data.fabricate import write_ycb_tree
    from posecnn_torch.entry import entry, flagship_model, forward_fn, make_inputs
    from posecnn_torch.models.posecnn import PoseCNN, init_weights
    from posecnn_torch.utils.graph import capture_loop

    wall0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fn_entry, args = entry()
    device = args[0].device
    fn_infer = forward_fn(flagship_model(1, device=device))
    forwards = (("entry (stride 4)", fn_entry), ("bench infer (stride 1)", fn_infer))
    parts, launches, per_body = [], {}, {}
    for name, fn in forwards:
        # (a) eager, with (b) each kernel against plain on its Hough inputs
        eager, launches[name], recorded = counted_run(lambda: fn(*args), f"phase 16 {name}")
        # (a) the same forward as a CUDA graph of 2 data-dependent bodies
        replay, static, body = capture_loop(fn, args, 2)
        replay()
        torch.cuda.synchronize()
        per_body[name] = body
        if body["flat"] != 1 or body["window"] != 1:
            raise AssertionError(f"phase 16 {name}: a captured forward launches {body}, not "
                                 "1 flat and 1 window")
        for field, got, want in zip(("label_2d", "rois", "poses_pred"), static, eager):
            diff, same = exact(got, want)
            if not same:
                raise AssertionError(f"phase 16 {name}: graph replay's {field} differs from "
                                     f"the eager forward's (max_abs_err {diff})")
        valid = int((static[1][:, 6] > 0).sum())
        parts.append(f"(a, b) {name}: replay == eager bit for bit (label_2d, rois, "
                     f"poses_pred; {valid} RoIs with votes); flat / window / tile vs plain on "
                     f"its Hough inputs ({hough_shape(recorded)}) bit for bit; launches eager "
                     f"{launches[name]}, per captured forward {body}")
        del replay, static, eager

    # (b) the shapes of the benches' other paths: `bench phases`' batch-4
    # forward and one `bench train` step of each feed
    inp4 = make_inputs(4, HEIGHT, WIDTH, NUM_CLASSES, device=device)
    _, launches["batch 4"], recorded = counted_run(
        lambda: fn_infer(inp4["data"], inp4["extents"], inp4["meta"]), "phase 16 batch 4")
    parts.append(f"(b) bench phases' batch-4 forward: flat / window / tile vs plain "
                 f"({hough_shape(recorded)}) bit for bit; launches {launches['batch 4']}")
    del inp4, fn_infer
    for feed in ("sparse", "dense"):
        name = f"bench train {feed}"
        step, state, batch = bench.train_setup(device, dense=feed == "dense")
        loss, launches[name], recorded = counted_run(
            lambda: bench.train_steps(step, state, batch, 1), f"phase 16 {name}")
        if not torch.isfinite(loss):
            raise AssertionError(f"phase 16 {name}: loss {float(loss)}")
        parts.append(f"(b) {name} step (the training Hough): flat / window / tile vs plain "
                     f"({hough_shape(recorded)}) bit for bit; launches {launches[name]}")
        del step, state, batch, loss
    for name, counts in launches.items():
        if counts["flat"] != 1 or counts["window"] != 1:
            raise AssertionError(f"phase 16 {name}: launches {counts}, not 1 flat and 1 window")
    print(f"phase 16 (a, b) on {card}: " + " | ".join(parts), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the benches, in process, at full width (`phases` runs in phase
    # 17 inside `bench c2f`, with the same checks)
    for command in ("infer", "train"):
        t0 = time.perf_counter()
        lines = bench.COMMANDS[command](device)
        for line in lines:
            numbers = [v for v in line.values() if isinstance(v, float)]
            if not all(np.isfinite(numbers)) or not all(v > 0 for v in numbers):
                raise AssertionError(f"phase 16 bench {command}: {line}")
            if "launches_per_forward" in line:
                body = line["launches_per_forward"]
                if body["flat"] != 1 or body["window"] != 1:
                    raise AssertionError(f"phase 16 bench {command}: a captured forward "
                                         f"launches {body}, not 1 flat and 1 window")
                per_body[f"bench {command} {line['timing']}"] = body
            if "launches_per_step" in line:  # the compiled train step's graph
                body = line["launches_per_step"]
                if body != FORWARD_BODY:
                    raise AssertionError(f"phase 16 bench {command}: a replayed train step "
                                         f"launches {body}, not 1 flat and 1 window")
                per_body[f"bench {command} {line['feed']} compiled step"] = body
            print(f"phase 16 (c) bench {command}: {json.dumps(line)}", flush=True)
        print(f"phase 16 (c) bench {command}: {time.perf_counter() - t0:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    # (d) the rotation oracle on a fabricated tree with a seeded checkpoint
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ycb")
        write_ycb_tree(root, sets=(("train", 1),))
        cfg = cfg_from_file(eval_rotation_oracle.DEFAULT_CFG)
        model = PoseCNN(NUM_CLASSES, num_units=cfg.train.num_units, fc_dim=cfg.train.fc_dim,
                        hough_num_samples=cfg.train.hough_num_samples,
                        max_objects=eval_rotation_oracle.MAX_OBJECTS, gt_pose_rois=True)
        init_weights(model, 16)
        ckpt = os.path.join(tmp, "seeded.npz")
        save_params(ckpt, model, step=16)
        out = os.path.join(tmp, "oracle.json")
        summary = eval_rotation_oracle.main(["--ckpt", ckpt, "--data_root", root, "--num_images",
                                             str(ORACLE_IMAGES), "--out", out])
        with open(out) as f:
            written = json.load(f)
    rows = summary["per_class"]
    degrees = [r[k] for r in rows.values() for k in ("mean_deg", "median_deg")]
    if (not rows or not all(np.isfinite(degrees)) or summary["ckpt_step"] != 16
            or summary["num_images"] != ORACLE_IMAGES or set(written) != set(summary)):
        raise AssertionError(f"phase 16 (d) rotation oracle: {summary}")
    print(f"phase 16 (d) rotation oracle ({ORACLE_IMAGES} images, 480x640, the lov_color_2d "
          f"yaml, seeded weights, bf16): {sum(r['n'] for r in rows.values())} GT rows in "
          f"{len(rows)} classes, {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps({k: v for k, v in summary.items() if k != 'per_class'})}", flush=True)
    print(f"phase 16 wall {time.perf_counter() - wall0:.1f} s", flush=True)
    return launches, per_body


# phase 17 (c): the train_net run summarize_run reads (the 48×64 toy of
# phase 15 (c), on the card) and the test_net images of its evaluation
SUMMARY_ITERS, SUMMARY_EVAL_IMAGES = 3, 2
SUMMARY_EVAL_SET = ["--set", "train.syn_height=48", "train.syn_width=64", "train.num_classes=4",
                    "train.fc_dim=32", "train.num_units=8", "test.hough_num_samples=64",
                    "train.add_num_points=32"]
# the breakdown benches phase 17 runs, and what each captured body of
# theirs launches: (tile, flat, window) by the line's phase or component
BREAKDOWNS = ("c2f", "components", "hough", "train_components", "train_mfu", "profile")
NO_VOTE, C2F_PAIR, TILE_ONLY = (0, 0, 0), (0, 1, 1), (1, 0, 0)
BODY_LAUNCHES = {"A_trunk_seg": NO_VOTE, "B_plus_vertex_hough": C2F_PAIR, "C_full": C2F_PAIR,
                 "full_batch4": C2F_PAIR, "c2f_default_f4_t4": C2F_PAIR, "c2f_f8_t4": C2F_PAIR,
                 "c2f_f4_t2": C2F_PAIR, "c2f_f8_t2": C2F_PAIR, "trunk": NO_VOTE,
                 "seg_only": NO_VOTE, "seg_vertex_hough": C2F_PAIR, "full": C2F_PAIR,
                 "hough_alone": C2F_PAIR, "roi_posehead_alone": NO_VOTE,
                 "prepare_slots": NO_VOTE, "vote_kernel_realistic": TILE_ONLY,
                 "full_batch1": C2F_PAIR}


def check_bench_line(command, line, signed=()):
    """Every number of a bench line finite and positive (the keys in
    `signed`, differences of two timings, finite), one level of nested
    numbers included; each captured body's launches as BODY_LAUNCHES says.
    Returns (name, launches per body) or None."""
    values = {}
    for key, v in line.items():
        if key.startswith("launches"):
            continue
        values.update({f"{key}.{k}": x for k, x in v.items()} if isinstance(v, dict)
                      else {key: v})
    bad = {k: v for k, v in values.items() if isinstance(v, float)
           and not (np.isfinite(v) and (v > 0 or k.split(".")[-1] in signed))}
    if bad:
        raise AssertionError(f"phase 17 bench {command}: {bad} in {json.dumps(line)}")
    if "launches_per_step" in line:  # a compiled train step's graph
        name = f"{line.get('variant', 'full')} compiled step"
        want = NO_VOTE if line.get("variant") in ("no_pose", "seg_only") else C2F_PAIR
        if tuple(line["launches_per_step"][k] for k in KERNELS) != want:
            raise AssertionError(f"phase 17 bench {command} {name}: a replayed step launches "
                                 f"{line['launches_per_step']}, not {want} (tile, flat, window)")
        return name, line["launches_per_step"]
    body = line.get("launches_per_body", line.get("launches_per_forward"))
    if body is None:
        return None
    name = line.get("phase", line.get("component"))
    if tuple(body[k] for k in KERNELS) != BODY_LAUNCHES[name]:
        raise AssertionError(f"phase 17 bench {command} {name}: a captured body launches "
                             f"{body}, not {BODY_LAUNCHES[name]} (tile, flat, window)")
    return name, body


def phase_breakdowns(device, card):
    """Phase 17: the c2f tuning knobs and the breakdown benches (see the
    module docstring). Returns each kernel's largest error against its
    plain version, its launches in each eager run (counted from 0) and per
    captured body, and its times and bounds at the c2f tunings."""
    import contextlib
    import gc
    import io
    import tempfile

    import torch

    from posecnn_torch import bench
    from posecnn_torch.cli import test_net, train_net
    from posecnn_torch.cli.validate import device_ms
    from posecnn_torch.ops import hough_kernels as hk

    wall0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    errs = {k: 0.0 for k in KERNELS}

    def launched(call):
        """call() with the kernels' counts set to 0 just before it and read
        just after (a direct call of the vote functions: nothing for
        `counted_run` to record)."""
        for key in hk.LAUNCHES:
            hk.LAUNCHES[key] = 0
        out = call()
        return out, {kk: hk.LAUNCHES[kk] for kk in KERNELS}

    def check(kernel, got, want, where):
        for a, b in zip(got, want):
            err, ok = exact(a, b)
            if not ok:
                raise AssertionError(f"phase 17: {kernel} disagrees with its plain version "
                                     f"{where}: max_abs_err {err}")
            if kernel in errs:
                errs[kernel] = max(errs[kernel], err)

    # (a) the exhaustive vote and the c2f pair at each tuning on `bench
    # c2f`'s planted samples (8 slots, 3 live, S = 128), against plain
    *_, packed, bboxes = bench.planted_slots(device)
    k = packed.shape[0]
    in_bytes = (packed.numel() + bboxes.numel()) * 4
    fine = dict(cell_stride=1, grid_h=HEIGHT, grid_w=WIDTH)
    got, counts = launched(lambda: hk.hough_votes_exhaustive(packed, bboxes, **fine))
    check("tile", got, hk.hough_votes_exhaustive_plain(packed, bboxes, **fine), "at stride 1")
    if tuple(counts[kk] for kk in KERNELS) != TILE_ONLY:
        raise AssertionError(f"phase 17 exhaustive: launches {counts}")
    launches = {"exhaustive": counts}
    # each kernel's graph ms and bound: tile at stride 1, flat and window
    # at each tuning
    at_tunings = {"tile": {"ms": graph_ms(lambda: hk.hough_votes_exhaustive(
        packed, bboxes, **fine), 50), "bound_ms": vote_bound(
        hk.tile_cells(packed, bboxes, **fine), in_bytes, 2 * 4 * got[0].numel())[0]},
        "flat": {}, "window": {}}
    parts = []
    for name, tuning in bench.C2F_TUNINGS:
        f, top_t = tuning["coarse_factor"], tuning["top_t"]
        coarse = dict(cell_stride=f, grid_h=-(-HEIGHT // f), grid_w=-(-WIDTH // f))
        where = f"at {name}"
        win, launches[name] = launched(
            lambda: hk.hough_votes_c2f_windows(packed, bboxes, **fine, **tuning))
        check("window", win, hk.hough_votes_c2f_windows(packed.cpu(), bboxes.cpu(), **fine,
                                                          **tuning), where)
        check("flat", hk.hough_votes_flat(packed, bboxes, **coarse),
              hk.hough_votes_flat_plain(packed, bboxes, **coarse), where)
        check("the c2f maximum", hk.hough_votes_c2f(packed, bboxes, **fine, **tuning),
              hk.hough_votes_c2f(packed.cpu(), bboxes.cpu(), **fine, **tuning), where)
        if tuple(launches[name][kk] for kk in KERNELS) != C2F_PAIR:
            raise AssertionError(f"phase 17 {name}: launches {launches[name]}")
        origins = torch.stack([win[2], win[3], win[4].long()], -1).reshape(-1, 3).int()
        origins = origins.contiguous()
        n_cells = coarse["grid_h"] * coarse["grid_w"]
        flat, window = at_tunings["flat"], at_tunings["window"]
        flat[name] = {
            "ms": graph_ms(lambda: hk.hough_votes_flat(packed, bboxes, **coarse), 200),
            "bound_ms": vote_bound(hk.flat_cells(packed, bboxes, **coarse), in_bytes,
                                   2 * 4 * k * n_cells)[0]}
        window[name] = {
            "ms": graph_ms(lambda: hk.hough_votes_windows(packed, origins, **fine), 200),
            "bound_ms": vote_bound(
                hk.window_cells(packed, origins, **fine)[1:],
                (packed.numel() + origins.numel()) * 4, 2 * 4 * origins.shape[0] * hk.TILE)[0]}
        glue_ms = device_ms(lambda: hk.hough_votes_c2f(packed, bboxes, **fine, **tuning),
                            device, 50)
        parts.append(f"{name}: flat {tuple(coarse.values())[1:]} / windows {k * top_t} "
                     f"({int(win[4].sum())} live) / maximum vs plain bit for bit; flat "
                     f"{flat[name]['ms']:.4f} ms (bound {flat[name]['bound_ms']:.4f}), window "
                     f"{window[name]['ms']:.4f} (bound {window[name]['bound_ms']:.4f}), the c2f "
                     f"call with its glue {glue_ms:.4f}")
    print(f"phase 17 (a) on {card}: `bench c2f`'s planted samples (K={k}, S={packed.shape[2]}): "
          f"exhaustive vs plain bit for bit, tile {at_tunings['tile']['ms']:.4f} ms (bound "
          f"{at_tunings['tile']['bound_ms']:.4f}); " + " | ".join(parts)
          + f"; launches {json.dumps(launches)}", flush=True)
    del packed, bboxes
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one eager step, its Hough recorded and held to plain, at each
    # training shape the benches add to phase 16 (b)'s: each `train_mfu`
    # point and the `train_components` variants of another frame or batch
    train_shapes = [(f"train_mfu ({b}, {scale})", bench.mfu_setup(b, scale))
                    for b, scale in bench.MFU_POINTS]
    train_shapes += [(f"train_components {name}", variant) for name, variant
                     in bench.TRAIN_VARIANTS if name in ("res_240x320", "batch1")]
    for name, setup in train_shapes:
        t0 = time.perf_counter()
        step, state, batch = bench.train_setup(device, **setup)
        loss, launches[name], recorded = counted_run(
            lambda: bench.train_steps(step, state, batch, 1), f"phase 17 {name}")
        if not torch.isfinite(loss) or tuple(launches[name][kk] for kk in KERNELS) != C2F_PAIR:
            raise AssertionError(f"phase 17 {name}: loss {float(loss)}, launches "
                                 f"{launches[name]}")
        print(f"phase 17 (b) {name} step (the training Hough): flat / window / tile vs plain "
              f"({hough_shape(recorded)}, {tuple(batch['data'].shape[1:3])}) bit for bit; "
              f"launches {launches[name]}; {time.perf_counter() - t0:.1f} s", flush=True)
        del step, state, batch, loss, recorded
        gc.collect()
        torch.cuda.empty_cache()

    # (b) the breakdown benches in process, at full width, each counted
    # from 0 (their Hough calls at the shapes above, at phase 16 (b)'s and
    # at (a)'s planted samples); every number finite and positive, every
    # captured body launching what it should
    per_body = {}
    signed = set(bench.train_differences({name: 0.0 for name, _ in bench.TRAIN_VARIANTS}))
    for command in BREAKDOWNS:
        t0 = time.perf_counter()
        for key in hk.LAUNCHES:
            hk.LAUNCHES[key] = 0
        lines = bench.COMMANDS[command](device)
        launches[f"bench {command}"] = {kk: hk.LAUNCHES[kk] for kk in KERNELS}
        for line in lines:
            body = check_bench_line(command, line, signed)
            if body is not None:
                per_body[f"bench {command} {body[0]}"] = body[1]
            print(f"phase 17 (b) bench {command}: {json.dumps(line)}", flush=True)
        if command == "profile" and not lines[-1]["kernels"]:
            raise AssertionError(f"phase 17 bench profile: no device kernel traced: {lines[-1]}")
        counts = launches[f"bench {command}"]
        if counts["flat"] < 1 or counts["window"] != counts["flat"] or (
                counts["tile"] < 1) != (command != "hough"):
            raise AssertionError(f"phase 17 bench {command}: launches {counts}")
        print(f"phase 17 (b) bench {command}: {time.perf_counter() - t0:.1f} s, launches "
              f"{counts}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    # (c) summarize_run on a train_net run and a test_net evaluation of
    # its snapshot, as the JAX repo's runbooks lay them out
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "output", "run")
        eval_dir = os.path.join(tmp, "output", f"eval_syn_{SUMMARY_ITERS}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, launches["summary train_net"], _ = counted_run(lambda: train_net.main(
                ["--output", run_dir, "--iters", str(SUMMARY_ITERS), *DP_TOY]),
                "phase 17 train_net")
            snapshot = os.path.join(run_dir, f"posecnn_iter_{SUMMARY_ITERS}.npz")
            _, run_net = compiled_run(lambda: test_net.main(
                ["--ckpt", snapshot, "--num_images", str(SUMMARY_EVAL_IMAGES), "--output",
                 eval_dir, *SUMMARY_EVAL_SET]), [test_net], "phase 17 test_net")
            launches["summary test_net"] = run_net["device"]
            recorded_vs_plain(run_net["recorded"], "phase 17 test_net")
        summary = subprocess.run([sys.executable, "-m", "posecnn_torch.cli.summarize_run",
                                  run_dir], cwd=tmp, capture_output=True, text=True, timeout=120,
                                 env={**os.environ, "PYTHONPATH": os.path.dirname(
                                     os.path.abspath(__file__))})
    if summary.returncode != 0:
        raise AssertionError(f"phase 17 summarize_run: rc {summary.returncode}; "
                             f"{summary.stderr[-2000:]}")
    result = json.loads(summary.stdout.splitlines()[-1])
    curve, evals = result["loss_curve"], result["evals"]
    if (result["metric"] != "train_run_summary" or len(curve) != SUMMARY_ITERS
            or not np.isfinite([c["loss"] for c in curve]).all() or len(evals) != 1
            or evals[0]["iter"] != SUMMARY_ITERS or not np.isfinite(evals[0]["seg_mean_iou"])):
        raise AssertionError(f"phase 17 summarize_run: {summary.stdout}")
    for run in ("summary train_net", "summary test_net"):
        if launches[run]["flat"] < 1 or launches[run]["window"] != launches[run]["flat"]:
            raise AssertionError(f"phase 17 {run}: launches {launches[run]}")
    print(f"phase 17 (c) summarize_run on a {SUMMARY_ITERS}-step train_net run (48x64 toy on the "
          f"card) and test_net's eval.json of its snapshot ({SUMMARY_EVAL_IMAGES} images): "
          f"{time.perf_counter() - t0:.1f} s; launches {launches['summary train_net']}, "
          f"{launches['summary test_net']};\n{summary.stdout}", flush=True)
    print(f"phase 17 wall {time.perf_counter() - wall0:.1f} s", flush=True)
    return errs, launches, per_body, at_tunings


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        from posecnn_torch.cli.common import setup_device
        from posecnn_torch.data import native
        from posecnn_torch.ops import _cuda
    except ImportError:
        print("chip_smoke: run it from the repository root (posecnn_torch not found)",
              file=sys.stderr)
        return 2
    device = setup_device("cuda")  # also switches TF32 off: phase 4 compares fp32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    # the data-path library builds with g++ while nvcc builds the kernels
    def build_native():
        t = time.perf_counter()
        native.library()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native_future = pool.submit(build_native)
        _cuda.build_all()  # one nvcc a source, started together
        cuda_s = time.perf_counter() - t0
        native_s = native_future.result()  # raises what the build raised
    report = "".join(_cuda.build_report(name) for name in _cuda.LIBRARIES)
    print(f"phase 1 card {card}; kernels ({', '.join(_cuda.LIBRARIES)}, one nvcc each) built "
          f"and loaded in {cuda_s:.1f} s, the data-path library (g++) beside them in "
          f"{native_s:.2f} s; ptxas: {json.dumps(ptxas_lines(report))}", flush=True)

    errs, times, bounds = phase_kernels(device)
    scan = phase_scan(device)
    phase_planted(device)
    phase_small_model(device)
    launches, cli_bodies = phase_serve(card)
    phase_validate(device)
    runs = phase_full_width(device, card)
    train = phase_train(card)
    eval_launches, cli_bodies["test_net"], pose_kernels = phase_eval(device, card)
    real_launches, real_eval_launches = phase_real(card)
    demo_launches, cli_bodies["demo"], det = phase_det_demo(card)
    seg_launches, seg_replays = phase_seg_video(device, card)
    switch_launches, gan_replays = phase_switches_gan(device, card)
    slice11_launches = phase_slice11(card, native_s)
    dp_launches = phase_data_parallel(card)
    entry_launches, entry_per_body = phase_entry_bench(card)
    p17_errs, p17_launches, p17_per_body, p17_tunings = phase_breakdowns(device, card)
    # each kernel's launches on its main path: the exhaustive forward for
    # the tile kernel, the batch-1 HTTP serving run for the c2f pair and the
    # NMS scan (its graph replays, counted on the device); and those of the
    # test_net run (phase 9, recorded) and of phase 10's training steps and
    # test_net run, each counted from 0
    launches["tile"] = runs["exhaustive"]["tile"]
    # phases 12-13: each compiled family step's and test_video's launches a
    # replay (counted on the device, all 0)
    families = {**seg_replays, **gan_replays}

    replaces = {"tile": "posecnn_tpu/ops/hough_pallas.py:39",
                "flat": "posecnn_tpu/ops/hough_pallas.py:191",
                "window": "posecnn_tpu/ops/hough_pallas.py:333"}
    print(json.dumps({"kernels": [
        {"name": KERNELS[k], "route": "cuda", "source": "posecnn_torch/csrc/hough_vote.cu",
         "replaces": replaces[k], "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "call_ms": times[k][1], "plain_ms": times[k][2],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": None,
         "test_net_launches": eval_launches[k], "real_train_launches": real_launches[k],
         "real_test_net_launches": real_eval_launches[k], "demo_launches": demo_launches[k],
         "seg_video_launches": seg_launches[k],
         "switched_test_net_launches": switch_launches[k],
         "slice11_launches": slice11_launches[k], "dp_launches": dp_launches[k],
         "phase16_launches": {name: counts[k] for name, counts in entry_launches.items()},
         "per_captured_forward": {name: body[k] for name, body in entry_per_body.items()},
         "per_captured_cli_body": {name: body[k] for name, body in cli_bodies.items()},
         "phase17_max_abs_err": p17_errs[k],
         "phase17_launches": {name: counts[k] for name, counts in p17_launches.items()},
         "phase17_per_captured_body": {name: body[k] for name, body in p17_per_body.items()},
         "phase17_at_tunings": p17_tunings[k],
         "per_replayed_train_step": train["per_replayed_step"][k],
         "train_gate_per_replay": {name: train[name]["launches_per_replay"][k]
                                   for name in ("flagship_gate", "momentum_gate")},
         "per_replayed_family_program": {name: counts[k] for name, counts in families.items()}}
        for k in ("tile", "flat", "window")
    ] + [
        {"name": SCAN_KERNEL, "route": "cuda", "source": "posecnn_torch/csrc/nms_scan.cu",
         "replaces": "posecnn_tpu/ops/nms.py:34", "launches": launches["scan"],
         **{k: scan["serve1"][k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                             "bound_ms", "bound_by", "kernels_ms")},
         "library_ms": None, "shape": list(scan["serve1"]["shape"]),
         **{case: {k: scan[case][k] for k in
                   ("shape", "max_abs_err", "ms", "call_ms", "kernels_ms", "plain_ms",
                    "bound_ms", "bound_by")} for case in ("serve4", "per_class", "rpn")},
         "posecnn_test_net_launches": eval_launches["scan"],
         "demo_launches": demo_launches["scan"],
         "per_captured_cli_body": {name: body["scan"] for name, body in cli_bodies.items()},
         "det_train_launches": det["train_launches"]["scan"],
         **{k: det[k] for k in ("per_replayed_step", "gate_per_replay", "rpn_max_abs_err",
                                "test_net_launches", "per_test_net_frame",
                                "per_captured_det_infer")},
         "per_replayed_family_program": {name: counts["scan"] for name, counts in families.items()}}
    ] + [
        {"name": name, "route": "cuda", "source": "posecnn_torch/csrc/kabsch.cu",
         "replaces": replaces, **pose_kernels[k],
         "per_replayed_family_program": {fam: counts[k] for fam, counts in families.items()}}
        for k, name, replaces in (
            ("pose_hyp", POSE_HYP_KERNEL, "posecnn_tpu/refine/ransac.py:155"),
            ("pose_refine", POSE_REFINE_KERNEL, "posecnn_tpu/refine/ransac.py:165"),
            ("kabsch", KABSCH_KERNEL, "posecnn_tpu/refine/ransac.py:119"))
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
