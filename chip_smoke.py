#!/usr/bin/env python3
"""Runs the PyTorch port (tensor2robot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--phases build,kernels,training,serving,critic,export,serve_quant,policy,data,cli,meta,stream,moe,grasp2vec,vrgripper,maml_export,stem_s2d,png,parallel]

Phases, each fatal on failure (exit code 1, no result line):

  1. build    — compiles the hand-written CUDA kernels from the checkout's
                sources (ops/csrc/flash_fwd.cu and flash_bwd.cu, one nvcc
                per source and head dim 16, 32, 64, 128, all at once, for
                sm_90a) and prints each kernel's registers and spills.
  2. kernels  — holds each flash kernel against its plain PyTorch version
                on the card, on nine cases around the transformer-BC
                shape (B=8, S=1024, H=8, D=32; causal f32 and bf16, a
                window, a q offset, a k offset with fully masked rows, a
                ragged non-causal D=64, a bf16 D=128, the model's default
                D=16, and D=24 zero-padded to the built 32): B2 (normalized
                forward), B1 (unnormalized forward with row stats l, m),
                B3 (dq) and B4 (dk, dv) from the same lse and delta, all
                four running their products on the tensor cores as
                split-f32 (3xTF32) mma.sync; B3 and B4 launch twice and
                must give the same bits; a second derivative through
                FlashAttentionFunction must raise on the card. Times
                each kernel, its plain version and one PyTorch call that
                computes the same function (a yardstick the port never
                calls; the backward yardstick's own error against the
                plain version is printed), and computes each kernel's
                bound over the f32-accurate routes (SIMT f32, or split
                f32 on the TF32 tensor cores).
  3. training — a full-width transformer-BC model (T=1024 steps, 64x64x3
                images, pose 14, action 7, d_model 256, 4 layers, 8 heads
                of 32, use_flash=True; seeded random weights, batch 8):
                first one backward through the kernels against the einsum
                attention path (plain autograd) on the same batch and
                weights, then train_eval_model for 20 steps with
                checkpoints at 10 and 20 and 2 eval batches each time;
                B1, B3 and B4 must launch once per layer per step and B2
                once per layer per eval batch. Then the train step's time,
                peak memory and a torch.profiler breakdown.
  4. serving  — CheckpointPredictor restores the checkpoint the training
                phase wrote and serves it through PolicyServer with
                buckets (1, 2, 4, 8) to four client threads sending 24
                episodes; every reply must be finite, [1024, 7], equal
                within tolerance to the same weights served with the plain
                (einsum) attention, and B2 launched once per layer per
                served batch. The training phase's train_eval_model also
                exports (create_default_exporters, warmup ladder (1, 2, 4,
                8)) after each eval: latest/ and best/ versions, each timed
                and sized, each with its torch.export program.
  5. critic   — the QT-Opt Grasping44 critic at the flagship's full width
                (472x472 crops of uint8 512x640x3 sources, num_convs
                (6, 6, 3), width 64, batch 64, momentum, EMA 0.9999,
                seeded random weights; the shape of bench.py's
                qtopt_critic_train_mfu_bs64_472px cell, but in float32
                without its bf16 model wrapper): first one batch of 2
                (center crop) through the same weights on the card and
                on the CPU with every relu and pool pinned to the card's
                choices (loss, every gradient and every batch-norm
                statistic, and a TF32 control that must fail), then
                train_eval_model for 20 steps with random
                crops and distortions from per-step card generators,
                checkpoints at 10 and 20 and one EMA eval batch after
                each, then a restore of 20.pt that must equal the live
                state bit for bit (parameters, batch-norm buffers, EMA,
                optimizer state) and evaluate to the same bits. Then the train step's time,
                steps/s, peak memory, a torch.profiler breakdown and the
                achieved TFLOP/s against an analytic flop count. The
                critic runs no kernel of the port (its convolutions are
                cuDNN's, its pools and batch norms plain torch).
  6. export   — serves the training phase's step-10 export with no model
                code: ExportedSavedModelPredictor loads the program (B2 as
                the t2r_torch::flash_fwd operator), PolicyServer takes its
                ladder and warmup requests from the export and prewarms
                every bucket; 4 clients x 6 episodes, every reply within
                1e-4 of einsum attention at the same step and B2 launched
                4 x batches; then a hot swap to the step-20 export under
                traffic (versions never go back for a client, each reply
                equals its own version's einsum action, the last replies
                are step 20, the incoming version prewarms every bucket
                first); an int8 export of step 20 (within 0.05 of the f32
                export's actions, files under half the f32 sizes); and the
                critic phase's step-20 EMA weights exported at full width
                and served for 8 requests within 1e-5 of
                CheckpointPredictor, launching no kernel.
  6b. serve_quant — low-precision serving exports (export/serve_quant.py)
                with T2R_SERVE_CALIB=static: (a) one Exporter export of
                the training phase's step-20 full-width BC (flash heads)
                in fp16, int8, fp8_e4m3 and fp8_e5m2, each regime through
                its own parity gate, its payload MB, fired layers (20 in
                int8/fp8), dot audit (every fired contraction in the
                regime's contracted dtype: i8, f8e4m3, f16 for e5m2 on
                the card) and reduce audit (no activation-quant reduce but
                the layers the calibration demoted); (b) each regime
                served through ExportedSavedModelPredictor(quant_regime=)
                and PolicyServer to 4 clients x 2 episodes, every reply
                within the regime's parity tolerance of the f32 export, B2
                exactly 4 a batch, the snapshot's regime, layers and
                calibration; (c) the int8 program on the card against the
                CPU on 2 episodes, and a regime an export lacks raising;
                (d) einsum heads: the int8 QK^T and PV measured at T = 1024
                against f32, then an int8 export at T = 32 (the first 32
                positions of the same weights) firing every attention
                module, audited int8, no flash launch; (e) the critic's
                EMA at full width in int8, its convs fired and audited,
                8 requests within int8's tolerance, no flash launch.
  7. policy   — robot-side action selection. (a) The full-width critic
                (the critic phase's step-20 EMA weights when it ran, else
                seed 0) exported with action_batch_size 64 through the
                Exporter and restored with ExportedSavedModelPredictor (no
                model code): JitCEMPolicy (action_size 10, 64 samples, 3
                iterations, seed 0) runs the whole CEM loop as one CUDA
                graph replay per select (replays must equal selects);
                selects/s and p50/p90 ms; the same loop eagerly on the same
                noise (best action and Q within 1e-5) and its selects/s;
                the graph's best Q re-scored through predict (1e-5);
                CEMPolicy's numpy engine over the same predictor; the
                64-state predict of the untiled export (calls/s); an int8
                export under JitCEMPolicy; a second export version restored
                must rebuild the graph exactly once. (b) The PoseToyEnv
                loop: run_env with the random policy collects 64 episodes
                into TFRecords, train_eval_model trains
                PoseEnvRegressionModel from them with the latest exporter,
                collect_eval_loop evaluates a RegressionPolicy over the
                export on 32 episodes (its global step must be the
                export's), and JitCEMPolicy drives episodes over a
                PoseEnvContinuousMCModel export. No flash kernel runs.
  8. data     — the data stack: builds the native TFRecord codec and the
                JPEG codec (libjpeg where the host has jpeglib.h, else
                nvJPEG; the line names it) with g++, writes 128 train
                records in 4 shards and 64 eval records of the critic's
                in-spec (512x640 q95 JPEGs of seeded camera-like frames),
                holds FastSpecParser against SpecParser bit for bit (the
                golden record, train records with and without ROI, the eval
                shard), ROI decode against the full decode's crop, TFRecord
                write/read and CRCs, and the codec's q95 round trip of the
                seeded frames against its bound; times RecordDataset alone
                (thread and process backends, ROI on and off, batch 64);
                then train_eval_model trains the full-width critic for 20
                steps from the records (random ROI in train, center in
                eval) with checkpoints at 10 and 20 and EMA evals, and a
                fed step's time and the card's busy share are printed
                beside the critic phase's step on a batch already on the
                card.
  9. cli      — the trainer's command line: (a) in process, one remat +
                grad_accum_steps 2 step of full-width BC against a plain
                step on one batch (the BC gradient gate; B1 16, B3 8, B4 8
                launches exactly), 10 steps at iterations_per_loop 5
                against 1 (the same gate on the step-10 parameters, cuDNN
                deterministic) and each regime's synced step time and
                peak memory (remat's under 0.75 of the plain step's);
                (b) bin/run_t2r_trainer as a child process
                training full-width BC for 20 steps (remat, grad-accum 2,
                5 steps a loop, EMA, checkpoints at 10 and 20) with the
                six hook builders, beside bin/run_continuous_eval tailing
                its model_dir (steps 10 and 20 evaluated with B2 and
                exported): operative_config.gin, step_timing.jsonl, a
                profiler trace naming B1, B3 and B4, golden_values.npy,
                the TD3 lagged directory one version behind and a
                durability manifest per checkpoint; (c) the JAX package's
                shipped pose_env configs through the three binaries:
                run_random_collect.gin (64 episodes), run_train_reg.gin at
                its own width and device_type 'tpu' (the bf16 wrapper),
                cut from 5000 to 40 steps and from 100 eval batches to 1,
                and continuous eval over that run. Random-collect rewards
                are all <= 0, so that run's loss is exactly 0; in
                process, the same model takes a reward-bearing bf16 step
                against the f32 step from the same weights, then 4 more
                that must lower the loss.
 10. meta     — MAML (meta_learning/): the shipped run_train_reg_maml.gin's
                model, PoseEnvRegressionModelMAML at its widths (64x64x3,
                8 tasks of 3 condition + 3 inference samples, one inner
                step): (a) a second- and a first-order outer step on the
                card against the CPU from the same weights (loss 1e-5
                rel, gradients 1e-4 of max; TF32 off, cuDNN
                deterministic), then each order's synced step and peak
                memory; (b) the config through run_t2r_trainer (bf16
                wrapper) beside run_continuous_eval, random task batches,
                cut to 40 steps and 1 eval batch; (c) 64 hidden-drift
                PoseToyEnv tasks written as meta-example records
                (make_meta_example), 40 steps from them through
                RecordDataset and FixedLenMetaExamplePreprocessor, then
                run_meta_env (10 tasks x 2 adaptations) with
                MAMLRegressionPolicy over CheckpointPredictor: actions
                finite and in the box, the policy's action equal to a
                direct forward. No flash kernel runs.
 11. stream   — KV-cache streaming serving (the shape of the JAX bench's
                streaming_bc_policy_steps_per_sec): full-width BC (episode
                1024, 64x64x3, d_model 256, 4 layers, 8 heads of 32, f32,
                seed-0 weights) at batch 1, attention windows 128 and
                None: StreamingBCPolicy streams the whole episode, one CUDA
                graph replay a step, every action within 1e-4 abs + rel of
                the full forward's row (einsum path); reset() reproduces
                step 0; steps/s (median of 5 windows of 20) and p50/p90
                per step; the eager step over 64 steps; the streaming
                export (torch.export of the step) restored with no model
                code, within 1e-5 of the in-process policy, its steps/s.
                Then 4 experts at window 128 against its own full forward.
                No flash kernel runs (decode attends through the einsum
                oracle, as the JAX package's decode does).
 12. moe      — full-width BC (batch 8, T = 1024) with 4 experts, k = 2,
                flash on, Adam: one step's loss and every gradient through
                B1/B3/B4 against the einsum path under the BC gate, with
                the routing picks that differ between the two counted (one
                under a top-2 margin of 1e-5 takes its episode out of the
                comparison; any other fails); B1, B3, B4 exactly 4 a step;
                the synced step (median of TIMED_STEPS), steps/s, peak memory, a
                profile, beside the dense step; loss/moe_aux finite and
                no aux in eval outputs or the checkpoint.
 13. grasp2vec — Grasp2VecModel at its defaults (ResNet-50, 472x472 crops
                of 512x640 JPEG sources, n-pairs loss), f32, batch 8:
                a batch of 2 through the same seeded weights on the card
                and the CPU (embeddings, loss and batch-norm statistics
                1e-4 of their max; gradients under the critic's f32
                limit), 48 JPEG records, 20 steps through
                train_eval_model from them (nvJPEG decode on the card),
                the synced step's time, TFLOP/s against an analytic flop
                count, peak memory and profile, the checkpoint's
                embeddings served through CheckpointPredictor equal to the
                in-process eval forward and turned into heatmaps, and one
                triplet_embedding_loss step. No flash kernel runs.
 14. vrgripper — every VRGripper family at its JAX defaults (40-step
                episodes of 100x100 crops of 220x300 uint8 sources):
                regression with MSE and with a 3-component MDN,
                domain-adaptive, TEC, the WTL trial model and a
                second-order MAML over the regression model, each held
                against the CPU (the meta phase's gate) and stepped on the
                card (synced step, peak memory; the MAML step profiled);
                then the MSE model through train_eval_model, served from
                its checkpoint equal to the in-process eval forward. No
                flash kernel runs.
 15. maml_export — MAML models exported as static-batch programs (make_fx
                records the inner backward as aten ops): the shipped
                run_train_reg_maml.gin model (8 tasks of 3 + 3 at 64x64)
                at batches 1 and 8, VRGripper's MAML model at its JAX
                defaults (4 tasks), and the policy's model at 1; each
                program held to the checkpoint forward on the same
                weights, export, load and warm predict timed; then one
                MAML policy episode on PoseToyEnv from the export, acting
                as the checkpoint policy does.
 16. stem_s2d — the full-width critic (batch 64, f32, TF32 off) with the
                space-to-depth stem against the plain stem on the same
                weights (stem output and eval logits), 5 S2D train steps,
                a synced step of each stem; then one PCGrad step over the
                critic's loss split into two tasks, card vs CPU with
                every relu and pool pinned to the card's choices.
 17. png      — 512x640 RGB PNG records of the critic's in-spec through
                the port's encoder, parsed back bit for bit; PNG decode
                MB/s beside JPEG's on one thread; RecordDataset feeding
                the critic from them (decode whole, crop 472x472).
 18. parallel — sequence- and data-parallel BC at full width (T = 1024,
                64x64x3, d_model 256, 4 layers, 8 heads of 32, flash on,
                batch 8, Adam, seed 0) on 4 ranks: processes sharing
                cuda:0 in one gloo group (a card holds one NCCL rank), the
                CUDA tensors they exchange staged through pinned host
                buffers, every kernel on the card. On a sequence-4 mesh
                (256 frames a rank) the ring, Ulysses (2 heads a rank) and
                a window-300 ring (3 of 4 hops) each take one step's loss
                and every gradient, averaged by the trainer's bucket, and
                an eval forward, held against the single-device flash step
                and forward from the same weights and batch on rank 0 (the
                BC gate; 1e-4 abs + rel); B1, B3 and B4 must launch exactly
                16, 4 and 12 times a rank a step (B2 4 times in Ulysses'
                eval); then the synced step (median of 3), peak memory,
                gloo-staged MB a step and rank 0's profiled step. Then train_eval_model on a
                2 x 2 data x sequence mesh (4 steps, checkpoints at 2 and
                4 from rank 0, exact launches) and its 4.pt served on one
                card by CheckpointPredictor within 1e-4 of the einsum
                path. Then on the same ranks, parallel_critic: the
                full-width f32 critic (batch 64) on a 2 data x 2 fsdp
                mesh (the sharded_params regime: its large kernels split
                over fsdp and gathered on use; regime and bytes a rank
                logged), its batch norms' moments over every shard, held
                against the single-device batch-64 step on the same
                weights and preprocessed batch with every relu and pool
                pinned to the single-device choices (loss 1e-5 rel,
                running statistics from zero 1e-4 of their max + 1e-7,
                each gradient 5e-2 of its max); the same step with
                per-shard moments must fail the statistics gate; the
                synced mesh step (median of 5); then train_eval_model on
                the mesh from shard_by_host JPEG records with an exporter
                and StepTimingHook on rank 0, continuous_eval over the
                mesh, and the export served on one card within 1e-5 abs +
                rel of the checkpoint's forward. And parallel_moe: MoE BC
                (4 experts, k = 2) at the BC width on a 2 data x 2 expert
                mesh, each rank computing its 2 resident experts, loss and
                every gradient through B1/B3/B4 held to the BC gate
                against the single-device MoE step (routing picks that
                differ only under a top-2 margin of 1e-5 leave their
                episodes out), B1, B3 and B4 exactly 4 times a rank a
                step, the synced step (median of 5), peak GiB and staged
                MB. And parallel_pipe: the BC width with its encoder
                pipelined (GPipe over the pipe dim, 2 blocks a stage) on a
                2 data x 2 pipe mesh, 4 microbatches: loss and every
                gradient (each stage's gathered from its ranks) and an
                eval forward held to the BC gate against the single-device
                flash step from the same weights and batch, B1, B3 and B4
                exactly 8 times a rank a step (B2 8 times in its eval);
                the synced step (median of 3), peak GiB and staged MB;
                one step on a 2 sequence x 2 pipe mesh (the manual einsum
                ring in every stage, no kernel) under the same gate; then
                train_eval_model on 2 data x 2 pipe (2 steps, a checkpoint
                with the stages stacked, a resume to 4) and the 4.pt
                served on one card by CheckpointPredictor through B2
                within 1e-4 of the einsum path. And parallel_zero2: the
                BC width on a 4-rank data mesh (global batch 8, block
                512): a replicated step, then each ZeRO-2 codec (none,
                fp16, int8, fp8_e4m3, fp8_e5m2) for 5 synced steps from
                the same weights; none's first step against the
                replicated one (loss 1e-5 rel, the gradients under the
                BC gate, every parameter within 1e-6 abs + 1e-4 of its
                leaf's largest update + what Adam's first step makes of
                the two gradients' difference), each quantized run's
                fifth against none's fifth (the loss within the JAX
                package's tolerance, int8's widened to its step times
                the loss; the parameters' change within a relative L2
                limit of the exact change), and a control of each codec
                with every step's update halved that must fail that
                gate; B1, B3 and B4 exactly 4 times a
                rank a step; wire bytes, optimizer-state bytes a rank,
                staged MB, step ms and peak GiB; then train_eval_model
                in int8 (2 steps, a checkpoint with the residuals, a
                resume to 4), its 4.pt served on one card within 1e-4
                of the einsum path; and on one card a
                flatten_optimizer_update step against the per-leaf one.
                And parallel_sharded: the BC width on a 1 data x 2 fsdp
                x 2 model mesh (the sharded_params regime: 19 leaves,
                3 462 656 parameters, split four ways; each Linear and
                Conv kernel's output channels over model, gathered after
                the rank's columns, its inputs over fsdp), global batch
                8: one step's loss and every gradient (gathered) and an
                eval forward against the single-device flash step under
                the BC gate, a control with the column split's output
                gather summing the model ranks' cotangents (as
                all_gather's backward would) that must fail it, every
                rank's parameter and Adam-moment bytes exactly the
                reckoning from the whole leaves (each of 2^14 elements
                or more split four ways), B1, B3 and B4 exactly 4 times
                a rank a step (B2 4 in its eval); the synced step
                (median of 3), staged MB and peak GiB, and the same
                steps with every sharded leaf gathered on use (the
                column split off; checked, not counted); then train_eval_model clipped to a global
                norm the BC gradient exceeds (4 steps, checkpoints at 2
                and 4, every rank's clip factor below 1 and the same),
                its newest checkpoint resumed on the mesh and on one
                card equal bit for bit, and served on one card within
                1e-4 of the einsum path. And parallel_composed: BC at
                the BC width, global batch 8, on composed meshes of the
                same ranks: (a) zero2 on 2 data x 2 sequence (the ring)
                over ("data", "sequence"), (b) the same mesh over
                ("data",), (c) zero2 on 2 data x 2 pipe, (d) sharded
                parameters on 2 fsdp x 2 sequence, (e) on 2 fsdp x 2
                pipe, (f) the flat update on 2 data x 2 pipe; each one
                step from the chain's seed-0 weights against the
                single-device step (loss 1e-5 rel, the gradients under
                the BC gate, the parameters under the Adam-step gate of
                parallel_zero2), B1, B3 and B4 exactly what the same
                shape's replicated step launches (8 each a rank a step),
                every rank's parameter and Adam-moment bytes exactly the
                reckoning from the whole leaves (stage leaves whole on
                their stage), then 5 synced steps (not (f)); a control
                each for (a) (the slice summed over data alone), (d)
                (the whole leaves averaged over data x fsdp alone) and
                (c) (the stage entries left un-averaged), which must
                fail; then train_eval_model on (a) clipped to a global
                norm the BC gradient exceeds (4 steps, checkpoints at 2
                and 4, the clip factors below 1 and the same on every
                rank), 4.pt resumed in sharded_params on (d) and on one
                card bit for bit, and served on one card within 1e-4 of
                the einsum path. (parallel_moe_sequence and
                parallel_maml_sharded follow.) And parallel_plan: the
                sharding planner at the BC width, global batch 8: the
                dp_pp_zero2 preset built by its plan (mesh, model from
                model_kwargs(), Trainer(plan=...)) audited clean entry
                by entry and one step bit for bit against the
                hand-wired trainer on the same weights and batch, with
                the hand-wired step's launches (8 each a rank); then
                T2R_PLAN=auto on a cold plan cache measuring shortlist-2
                (one probe or more; the analytic top five and each
                probe's step, peak memory and analytic/measured memory
                printed), a warm call reading the cache (0 probes, the
                same plan document byte for byte on every rank) and one
                audited plan-driven step on the winner. Then
                parallel_3d: JAX's dp_sp_pp (2
                data x 2 sequence x 2 pipe, zero2 over ("data",
                "sequence")) on 8 gloo ranks in a second world, its step
                and its ("data",) twin's under the same gates against
                the single-device step, the twin against the step,
                exact bytes, no flash launch (the manual ring's einsum
                tiles), 3 synced steps. The four (eight) processes share
                one card: no time here is a multi-card speed.

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and as its last line {"ok": true, "device": {...}}. Exits
non-zero without a result when no CUDA card is visible. A run of a subset
of the phases prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "training", "serving", "critic", "export",
          "serve_quant", "aot", "policy", "data", "cli", "meta", "stream", "moe", "grasp2vec",
          "vrgripper", "maml_export", "stem_s2d", "png", "parallel")
# Where the training and serving phases run: always the card when the
# script runs (a test may point them at the CPU with the plain kernels).
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# f32-accurate routes for an f32 kernel's products: f32 FMAs outside the
# tensor cores, or split f32 on the TF32 tensor cores (three TF32 products
# per product, 495 TFLOP/s / 3). A kernel's bound takes the faster route.
PEAK_BYTES_PER_S = 3.35e12
SIMT_F32 = "simt f32"
F32_ROUTES = {SIMT_F32: 67e12, "3xtf32 tensor cores": 495e12 / 3}

SLICE = dict(batch=8, seq=1024, heads=8, head_dim=32)
NUM_LAYERS = 4
BC_WIDTH = dict(image_size=(64, 64), d_model=256)
BUCKETS = (1, 2, 4, 8)
CLIENTS = 4
REQUESTS_PER_CLIENT = 6
DISTINCT_EPISODES = 4
# Kernel vs plain version, |err| <= tol * (1 + |plain|). B2's f32 bound is
# the JAX package's own flash tolerance (tests/test_flash_attention.py); B1,
# B3 and B4 sum up to 1024 keys (or queries) per output in another order
# than the plain version's matmuls, so their f32 bound is 1e-4. bf16
# inputs are widened exactly, but B2's output rounds to 8 mantissa bits
# (one ulp at |o| ~ 1 is ~4e-3), and the gradients of the bf16 cases come
# from bf16 outputs and row stats: 2e-2.
KERNEL_TOL = {
    "flash_fwd": {"float32": 2e-5, "bfloat16": 2e-2},
    "flash_fwd_tile": {"float32": 1e-4, "bfloat16": 2e-2},
    "flash_bwd_dq": {"float32": 1e-4, "bfloat16": 2e-2},
    "flash_bwd_dkv": {"float32": 1e-4, "bfloat16": 2e-2},
}
# The TPU kernel each CUDA kernel replaces (tensor2robot_tpu/ops/
# flash_attention.py) and its source in the port.
KERNEL_ROWS = {
    "flash_fwd": ("flash_fwd.cu", "tensor2robot_tpu/ops/flash_attention.py:255"),
    "flash_fwd_tile": ("flash_fwd.cu", "tensor2robot_tpu/ops/flash_attention.py:276"),
    "flash_bwd_dq": ("flash_bwd.cu", "tensor2robot_tpu/ops/flash_attention.py:465"),
    "flash_bwd_dkv": ("flash_bwd.cu", "tensor2robot_tpu/ops/flash_attention.py:528"),
}
# Served actions vs the einsum-attention predictor: four layers of f32
# attention computed in another order, convs in full f32 (TF32 off).
SERVE_TOL = 1e-4
# One backward through the kernels vs the einsum path: the loss within
# 1e-5 relative; each parameter's gradient within GRAD_TOL * max|g_ref| +
# 1e-7 (f32 sums over 1024 keys and 8192 frames in another order).
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
TRAIN_STEPS = 20
SAVE_EVERY = 10
EVAL_STEPS = 2
LOG_EVERY = 5
TIMED_STEPS = 5
# The critic phase: the flagship configuration in float32 (the shape of
# bench.py's qtopt_critic_train_mfu_bs64_472px cell, which runs the
# forward in bf16 through the model wrapper; this phase does not) and the
# batch of the card-vs-CPU check. Its limits are the BC gradient check's
# (LOSS_TOL, GRAD_TOL), except the float32 gradients': at initialization
# the batch norms, on the batch's statistics, amplify rounding, and
# cuDNN's float32 conv algorithms round more than the CPU's convs, so
# with every relu and pool pinned the card's float32 gradients lie
# 1.392e-2 of their max from float64 and the CPU's 5.155e-4 (H100 80GB
# HBM3 at 700 W, PERF.md §6; with PyTorch's own CUDA convs the card reads
# 4.807e-4). CRITIC_F32_GRAD_TOL is 3.6 times the card's reading; TF32
# convs land at 3.0 times it.
CRITIC = dict(image_size=(472, 472), num_convs=(6, 6, 3), width=64)
CRITIC_BATCH = 64
CRITIC_CHECK_BATCH = 2
CRITIC_F32_GRAD_TOL = 5e-2
# A gradient that is 0 in exact arithmetic is rounding noise in float32;
# it is held to ZERO_GRAD of the model's largest gradient.
ZERO_GRAD = 1e-6
CRITIC_EVAL_STEPS = 1
# The data phase: full-width JPEG records of the critic's in-spec (train
# records, train shards, eval records), timed batches of RecordDataset
# alone, and the steps profiled when fed from records.
DATA_RECORDS = (128, 4, 64)
DATA_BATCHES = 16
PROFILED_FED_STEPS = 5
GOLDEN_RECORDS = os.path.join(ROOT, "tests", "golden", "qtopt_train.tfrecord")
# A codec's q95 round trip of ROUNDTRIP_FRAMES seeded 512x640 frames
# (camera_like_frames, seed 0), (mean, max) absolute error against the
# sources. libjpeg's is measured on the CPU by
# tests/test_torch_data_codec.py (mean 3.3526853, max 149). nvJPEG's encoder and decoder differ from libjpeg's (chroma
# down- and upsampling, IDCT), so it is held to libjpeg's mean + 50% and
# max + 32 levels: the first margin, 25%, was set before nvJPEG's first
# reading on the card (mean 4.2566, max 160: 1.27x libjpeg's mean; PERF.md
# §6). A channel swap or a wrong subsampling reads a mean above 20.
ROUNDTRIP_FRAMES = 8
LIBJPEG_ROUNDTRIP = (3.3526853, 149)
ROUNDTRIP = {
    "libjpeg": LIBJPEG_ROUNDTRIP,
    "nvjpeg": (LIBJPEG_ROUNDTRIP[0] * 1.5, LIBJPEG_ROUNDTRIP[1] + 32),
}
# The policy phase: JitCEMPolicy as the JAX bench's predict leg sizes it
# (bench.py:954-1100: action_size 10, 64 samples, 3 iterations, seed 0,
# an export with action_batch_size 64), timed over POLICY_SELECTS selects
# after warm-up; the eager loop and the numpy engine over fewer. Graph vs
# eager on the same noise, and the graph's best Q vs the same action
# re-scored through predict: 1e-5 abs + rel (the same f32 ops in another
# launch order, or one batch of 64 against another).
CEM = dict(action_size=10, cem_samples=64, cem_iterations=3, seed=0)
POLICY_SELECTS = 50
POLICY_EAGER_SELECTS = 10
POLICY_NUMPY_SELECTS = 5
PREDICT_WINDOWS, PREDICT_WINDOW = 5, 5
POLICY_TOL = 1e-5
# The PoseToyEnv loop: random-policy episodes collected, train steps of
# PoseEnvRegressionModel from their records, eval episodes of the trained
# policy through collect_eval_loop, and episodes of JitCEMPolicy over a
# PoseEnvContinuousMCModel export.
POSE_COLLECT = 64
POSE_TRAIN_STEPS = 40
POSE_BATCH = 16
POSE_EVAL = 32
POSE_CEM_EPISODES = 8
# Numbers one phase measures for another to print beside its own.
MEASURED = {}


def log(message: str) -> None:
    print(message, flush=True)


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them; printed
    beside every number the run measures."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(s_q, s_k, causal, q_offset, k_offset, window) -> int:
    """(query, key) pairs this case's masks let through, counted exactly."""
    total = 0
    for i in range(s_q):
        q_pos = q_offset + i
        lo, hi = k_offset, k_offset + s_k  # key positions [lo, hi)
        if causal:
            hi = min(hi, q_pos + 1)
            if window is not None:
                lo = max(lo, q_pos - window + 1)
        total += max(0, hi - lo)
    return total


def bound_ms(flops: float, nbytes: float, routes=tuple(F32_ROUTES)):
    """(least time in ms, what bounds it, the route of the products) at
    the card's published peaks, over the f32-accurate routes given."""
    route = max(routes, key=F32_ROUTES.get)
    t_ops = flops / F32_ROUTES[route] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), bound_by, route


def reset_launches() -> None:
    from tensor2robot_tpu_torch.ops import flash_attention as fa

    for kernel in fa.KERNELS.values():
        kernel.launches = 0


def read_launches() -> dict:
    from tensor2robot_tpu_torch.ops import flash_attention as fa

    return {name: kernel.launches for name, kernel in fa.KERNELS.items()}


def phase_build():
    """Builds every (source, head dim) library at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    from tensor2robot_tpu_torch.ops import flash_attention as fa

    jobs = [(d, s) for s in fa.KERNEL_SOURCES for d in fa.KERNEL_HEAD_DIMS]
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda job: fa.build_library(*job), jobs))
    log(f"[build] {len(paths)} libraries in {time.monotonic() - t0:.1f}s")
    for path in paths:
        log(f"[build] {os.path.relpath(path, ROOT)}")
        function = ""
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                # The mangled name from the kernel's own name on: its
                # template arguments read I<type>Li<D>Li<tile>[Lb<tile>].
                name = line.split("'")[1] if "'" in line else line
                function = name[name.rfind("flash_"):]
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {function}: {line.strip()}")


def phase_kernels():
    import torch

    from tensor2robot_tpu_torch.ops import flash_attention as fa

    b, s, h, d = (SLICE[k] for k in ("batch", "seq", "heads", "head_dim"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(batch, s_q, s_k, heads, dim, dtype):
        """q, k, v as MultiHeadAttention hands them over: [B, S, H, D]
        views into a fused [B, S, 3*H*D] projection, not contiguous; and
        a dO that is a strided view too."""
        inner = heads * dim

        def fused(seq, width):
            return torch.randn(
                (batch, seq, width), generator=gen, device="cuda"
            ).to(dtype)

        fused_q = fused(s_q, 3 * inner)
        fused_kv = fused_q if s_k == s_q else fused(s_k, 3 * inner)
        q, k, v = [
            t[..., i * inner:(i + 1) * inner].view(t.shape[0], t.shape[1], heads, dim)
            for i, t in enumerate((fused_q, fused_kv, fused_kv))
        ]
        dout = fused(s_q, 2 * inner)[..., :inner].view(batch, s_q, heads, dim)
        return q, k, v, dout

    def check(kernel, case, dtype, got, ref):
        tol = KERNEL_TOL[kernel][str(dtype).split(".")[-1]]
        err = (got.float() - ref.float()).abs()
        max_err = err.max().item()
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        if not torch.isfinite(got.float()).all() or bad:
            raise AssertionError(
                f"{case}: {kernel} disagrees with its plain version "
                f"(max_abs_err {max_err}, {bad} elements past {tol})"
            )
        return max_err

    cases = [
        # name, (B, Sq, Sk, H, D), dtype, kwargs
        ("slice_f32_causal", (b, s, s, h, d), torch.float32, dict(causal=True)),
        ("slice_bf16_causal", (b, s, s, h, d), torch.bfloat16, dict(causal=True)),
        ("slice_f32_window128", (b, s, s, h, d), torch.float32,
         dict(causal=True, window=128)),
        ("slice_f32_q_offset512", (b, s // 2, s, h, d), torch.float32,
         dict(causal=True, q_offset=s // 2)),
        ("slice_f32_k_offset256_masked_rows", (b, s, s, h, d), torch.float32,
         dict(causal=True, k_offset=256)),
        ("f32_noncausal_ragged_d64", (2, 1000, 777, 4, 64), torch.float32,
         dict(causal=False)),
        ("bf16_causal_d128", (2, 1024, 1024, 2, 128), torch.bfloat16,
         dict(causal=True)),
        ("slice_f32_causal_d16", (b, s, s, 2 * h, 16), torch.float32,
         dict(causal=True)),
        ("f32_window_padded_d24", (2, 777, 777, 4, 24), torch.float32,
         dict(causal=True, window=200)),
    ]
    errors = {}
    for name, (cb, sq, sk, ch, cd), dtype, kw in cases:
        q, k, v, dout = qkv(cb, sq, sk, ch, cd, dtype)
        errs = {}
        # B2.
        out = fa.flash_fwd_kernel(q, k, v, **kw)
        errs["flash_fwd"] = check(
            "flash_fwd", name, dtype, out, fa.flash_attention_plain(q, k, v, **kw)
        )
        # B1: o, l and m.
        got = fa.flash_tile_kernel(q, k, v, **kw)
        ref = fa.flash_attention_tile_plain(q, k, v, **kw)
        errs["flash_fwd_tile"] = max(
            check("flash_fwd_tile", f"{name} {part}", dtype, g, r)
            for part, g, r in zip("olm", got, ref)
        )
        # B3 and B4 from the plain forward's lse and delta.
        o, l, m = ref
        l_safe = l.clamp_min(1e-30)
        out = (o / l_safe.transpose(1, 2)[..., None]).to(dtype)
        lse = m + torch.log(l_safe)
        delta = fa.flash_attention_bwd_delta(dout, out)
        dq = fa.flash_bwd_dq_kernel(q, k, v, dout, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, **kw)
        ref_dq = fa.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, **kw)
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_plain(
            q, k, v, dout, lse, delta, **kw
        )
        torch.cuda.synchronize()
        errs["flash_bwd_dq"] = check("flash_bwd_dq", name, dtype, dq, ref_dq)
        errs["flash_bwd_dkv"] = max(
            check("flash_bwd_dkv", f"{name} dk", dtype, dk, ref_dk),
            check("flash_bwd_dkv", f"{name} dv", dtype, dv, ref_dv),
        )
        # No atomics: a second launch on the same inputs gives the same bits.
        again = (fa.flash_bwd_dq_kernel(q, k, v, dout, lse, delta, **kw),
                 *fa.flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, **kw))
        for part, first, second in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
            if not torch.equal(first, second):
                raise AssertionError(
                    f"{name}: {part} differs between two launches"
                )
        if kw.get("k_offset", 0) > 0:
            rows = kw["k_offset"]
            masked = max(
                fa.flash_fwd_kernel(q, k, v, **kw)[:, :rows].float().abs().max().item(),
                dq[:, :rows].abs().max().item(),
            )
            if masked != 0.0:
                raise AssertionError(f"{name}: masked rows not 0 ({masked})")
        errors[name] = errs
        log(f"[kernels] {name}: max_abs_err " + ", ".join(
            f"{kernel} {err:.3e}" for kernel, err in errs.items()
        ) + "; dq, dk, dv bitwise equal over two launches")
    check_second_derivative_raises()
    return errors, time_kernels(errors["slice_f32_causal"])


def check_second_derivative_raises() -> None:
    """B3 and B4 give gradients with no graph: a second derivative through
    FlashAttentionFunction on the card must raise, not drop the term."""
    import torch

    from tensor2robot_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((1, 128, 2, 16), generator=gen, device="cuda")
               .requires_grad_() for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    (g,) = torch.autograd.grad(((out + q) ** 2).sum(), q, create_graph=True)
    try:
        torch.autograd.grad(g.sum(), q)
    except RuntimeError as err:
        if "once-differentiable" not in str(err):
            raise
        log("[kernels] a second derivative through FlashAttentionFunction "
            "raises on the card")
        return
    raise AssertionError("a second derivative through flash attention "
                         "did not raise on the card")


def time_kernels(errors) -> list:
    """Each kernel at the slice shape, f32 causal (the training path's
    call), beside its plain version, a PyTorch yardstick and its bound."""
    import torch

    from tensor2robot_tpu_torch.ops import flash_attention as fa

    b, s, h, d = (SLICE[k] for k in ("batch", "seq", "heads", "head_dim"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    fused = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
    q, k, v = (t.view(b, s, h, d) for t in fused.split(h * d, dim=-1))
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda")
    o, l, m = fa.flash_tile_kernel(q, k, v, causal=True)
    l_safe = l.clamp_min(1e-30)
    out = o / l_safe.transpose(1, 2)[..., None]
    lse = m + torch.log(l_safe)
    delta = fa.flash_attention_bwd_delta(dout, out)
    bwd_args = (q, k, v, dout, lse, delta)

    # Yardsticks the port never calls: SDPA for B2; the memory-efficient
    # attention forward with its log-sum-exp for B1, and its backward op
    # (dq, dk and dv in one call) for B3 and B4.
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, dout))
    library = {
        "flash_fwd": ("scaled_dot_product_attention",
                      lambda: torch.nn.functional.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True)),
    }
    try:
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        eff_out, eff_lse, seed, offset = eff(qt, kt, vt, None, True, 0.0, True)
        eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
        library["flash_fwd_tile"] = (
            "aten._scaled_dot_product_efficient_attention",
            lambda: eff(qt, kt, vt, None, True, 0.0, True),
        )
        bwd_call = (
            "aten._scaled_dot_product_efficient_attention_backward",
            lambda: eff_bwd(dot, qt, kt, vt, None, eff_out, eff_lse, seed,
                            offset, 0.0, [True, True, True, False], True),
        )
        yardstick_accuracy(bwd_call[1](), bwd_args)
        library["flash_bwd_dq"] = library["flash_bwd_dkv"] = bwd_call
    except (RuntimeError, TypeError) as err:
        log(f"[kernels] efficient-attention yardstick not measured: {err}")

    pairs = b * h * visible_pairs(s, s, True, 0, 0, None)
    io = b * s * h * d * 4  # one f32 [B, S, H, D] tensor
    stats = b * h * s * 4  # one f32 [B, H, S] tensor
    calls = {
        # name: (kernel, plain, flops per visible pair per D, bytes)
        "flash_fwd": (lambda: fa.flash_fwd_kernel(q, k, v, causal=True),
                      lambda: fa.flash_attention_plain(q, k, v, causal=True),
                      4, 4 * io),
        "flash_fwd_tile": (
            lambda: fa.flash_tile_kernel(q, k, v, causal=True),
            lambda: fa.flash_attention_tile_plain(q, k, v, causal=True),
            4, 4 * io + 2 * stats),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq_kernel(*bwd_args, causal=True),
            lambda: fa.flash_attention_bwd_dq_plain(*bwd_args, causal=True),
            6, 5 * io + 2 * stats),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv_kernel(*bwd_args, causal=True),
            lambda: fa.flash_attention_bwd_dkv_plain(*bwd_args, causal=True),
            8, 6 * io + 2 * stats),
    }
    rows = []
    for name, (kernel, plain, per_pair, nbytes) in calls.items():
        kernel_ms = cuda_time_ms(kernel, 20)
        plain_ms = cuda_time_ms(plain, 3, warmup=1)
        library_name, library_ms = None, None
        if name in library:
            library_name, call = library[name]
            library_ms = cuda_time_ms(call, 20)
        flops = per_pair * d * pairs
        least, bound_by, route = bound_ms(flops, nbytes)
        simt, _, _ = bound_ms(flops, nbytes, (SIMT_F32,))
        log(
            f"[kernels] timing {name} slice_f32_causal on {card_line()}: kernel "
            f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, {library_name} "
            f"{library_ms if library_ms is None else f'{library_ms:.4f}'} ms; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB -> bound "
            f"{least:.4f} ms ({bound_by}, {route}; {SIMT_F32} alone "
            f"{simt:.4f} ms)"
        )
        source, replaces = KERNEL_ROWS[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"tensor2robot_tpu_torch/ops/csrc/{source}",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": errors[name],
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": least,
            "bound_by": bound_by,
            "bound_route": route,
            "library_ms": library_ms,
        })
    return rows


def yardstick_accuracy(grads, bwd_args) -> None:
    """The efficient-attention backward's own error against the plain
    backward at the slice shape (its grads come [B, H, S, D]), beside the
    f32 tolerance B3 and B4 are held to. Reported, not enforced: the port
    never calls it."""
    import torch

    from tensor2robot_tpu_torch.ops import flash_attention as fa

    tol = KERNEL_TOL["flash_bwd_dq"]["float32"]
    plain = fa.flash_attention_bwd_plain(*bwd_args, causal=True)
    parts = []
    for part, got, ref in zip(("dq", "dk", "dv"), grads, plain):
        err = (got.transpose(1, 2).float() - ref).abs()
        past = (err > tol + tol * ref.abs()).sum().item()
        parts.append(f"{part} {err.max().item():.3e} ({past} past {tol})")
    torch.cuda.synchronize()
    log("[kernels] yardstick accuracy aten._scaled_dot_product_efficient_"
        "attention_backward slice_f32_causal vs plain: max_abs_err "
        + ", ".join(parts))


def full_width_model(use_flash: bool):
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )

    return TransformerBCModel(**bc_model_kwargs(use_flash))


def check_gradients() -> None:
    """One backward through B1/B3/B4 against the einsum attention path
    (plain autograd) on the same batch and weights."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model, ref_model = full_width_model(True), full_width_model(False)
    trainer = Trainer(model, device=DEVICE)
    network = trainer.init_state(torch.Generator().manual_seed(0)).network
    ref_network = Trainer(ref_model, device=DEVICE).init_state(
        params=network.state_dict()
    ).network
    generator = DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=0)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), DEVICE)

    reset_launches()
    loss, _ = trainer.forward_loss(network, batch)
    loss.backward()
    torch.cuda.synchronize()
    launches = read_launches()
    ref_loss, _ = trainer.forward_loss(ref_network, batch)
    ref_loss.backward()
    expected = {"flash_fwd": 0, "flash_fwd_tile": NUM_LAYERS,
                "flash_bwd_dq": NUM_LAYERS, "flash_bwd_dkv": NUM_LAYERS}
    if launches != expected:
        raise AssertionError(f"backward launches {launches} != {expected}")
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    if not loss_err <= LOSS_TOL:
        raise AssertionError(f"loss {loss.item()} vs einsum {ref_loss.item()}")
    worst, worst_name = 0.0, ""
    ref_params = dict(ref_network.named_parameters())
    for name, p in network.named_parameters():
        g, g_ref = p.grad, ref_params[name].grad
        if g is None or g_ref is None:
            raise AssertionError(f"{name}: no gradient")
        scale = g_ref.abs().max().item()
        err = (g - g_ref).abs().max().item()
        if not err <= GRAD_TOL * scale + 1e-7:
            raise AssertionError(
                f"{name}: gradient off the einsum path by {err} (max {scale})"
            )
        ratio = err / max(scale, 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
    log(f"[training] gradient check: loss {loss.item():.7f} vs einsum "
        f"{ref_loss.item():.7f} (rel {loss_err:.2e}); worst gradient "
        f"{worst_name} at {worst:.2e} of its max; launches {launches}")


def phase_training(model_dir: str) -> dict:
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.metrics import read_metrics
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    check_gradients()
    torch.cuda.empty_cache()

    model = full_width_model(True)
    reset_launches()
    EXPORTS.clear()
    t0 = time.monotonic()
    final_eval = train_eval_model(
        model,
        DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=0),
        DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=1000),
        model_dir=model_dir, max_train_steps=TRAIN_STEPS,
        save_checkpoints_steps=SAVE_EVERY, eval_steps=EVAL_STEPS,
        log_every_steps=LOG_EVERY, device=DEVICE,
        create_exporters_fn=timed_exporters,
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    evals = TRAIN_STEPS // SAVE_EVERY
    expected = {
        "flash_fwd": NUM_LAYERS * EVAL_STEPS * evals,
        "flash_fwd_tile": NUM_LAYERS * TRAIN_STEPS,
        "flash_bwd_dq": NUM_LAYERS * TRAIN_STEPS,
        "flash_bwd_dkv": NUM_LAYERS * TRAIN_STEPS,
    }
    if launches != expected:
        raise AssertionError(f"train_eval_model launches {launches} != {expected}")
    steps = state_lib.checkpoint_steps(model_dir)
    if steps != [SAVE_EVERY, TRAIN_STEPS]:
        raise AssertionError(f"checkpoints {steps}")
    records = read_metrics(os.path.join(model_dir, "train"))
    logged = [r["step"] for r in records]
    if logged != list(range(LOG_EVERY, TRAIN_STEPS + 1, LOG_EVERY)):
        raise AssertionError(f"metrics logged at steps {logged}")
    losses = [r["loss"] for r in records]
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(
        final_eval.get("eval/mse", float("nan"))
    ):
        raise AssertionError(f"non-finite losses {losses} / eval {final_eval}")
    log(f"[training] train_eval_model on {card_line()}: {TRAIN_STEPS} steps, checkpoints "
        f"{steps}, in {wall:.1f}s (host data, evals, checkpoints and "
        f"exports included); losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"final eval {final_eval}; launches {launches}")
    latest = [(e["step"]) for e in EXPORTS if e["exporter"] == "latest"]
    if latest != [SAVE_EVERY, TRAIN_STEPS]:
        raise AssertionError(f"latest exports at steps {latest}")
    for e in EXPORTS:
        log(f"[training] export {e['exporter']} step {e['step']} in "
            f"{e['seconds']:.2f}s: program {e['program_mb']:.2f} MB, "
            f"variables {e['variables_mb']:.2f} MB, warmup "
            f"{e['warmup_mb']:.2f} MB ({e['path']})")
    time_train_step(model_dir)
    return launches


def time_train_step(model_dir: str) -> None:
    """Median of synced train steps on one device batch, peak memory, and
    where one step's device time goes (torch.profiler)."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import (
        Trainer,
        restore_or_init_state,
    )

    model = full_width_model(True)
    trainer = Trainer(model, device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    generator = DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=7)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), DEVICE)
    for _ in range(3):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    median = sorted(times)[len(times) // 2]
    MEASURED["bc_step_ms"] = median
    log(f"[training] train step (batch {SLICE['batch']}, on-device batch) on "
        f"{card_line()}: "
        f"median {median:.3f} ms over {TIMED_STEPS} synced steps "
        f"(min {min(times):.3f}, max {max(times):.3f}) = "
        f"{1e3 / median:.3f} steps/s; peak memory allocated "
        f"{peak / 2**30:.3f} GiB")
    device_profile("train step", lambda: trainer.train_step(state, batch), rows=20)


def device_profile(label: str, fn, rows: int = 10):
    """Device time by op and device busy share of one call's wall time,
    from torch.profiler; returns (wall ms, busy ms). Diagnostic only: a
    profiler that cannot trace the card is reported, not fatal (None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    except RuntimeError as err:
        log(f"[profile] {label}: not measured: {err}")
        return None
    # Device-side events only (kernels, copies): host ops also carry the
    # device time of what they launched, so summing every row counts it
    # twice, and a user annotation's device span covers its kernels and
    # the gaps between them. Busy time is the union of the device
    # intervals.
    device_events = [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_us, end_us = 0.0, float("-inf")
    for start, stop in sorted(
        (e.time_range.start, e.time_range.end) for e in device_events
    ):
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
    busy_ms = busy_us / 1e3
    by_name = {}
    for event in device_events:
        total, count = by_name.get(event.name, (0.0, 0))
        by_name[event.name] = (total + event.time_range.elapsed_us(), count + 1)
    log(f"[profile] {label} on {card_line()}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{len(device_events)} device events")
    for name, (total, count) in sorted(
        by_name.items(), key=lambda item: item[1][0], reverse=True
    )[:rows]:
        log(f"[profile]   {total / 1e3:9.3f} ms  x{count:<4d} {name[:90]}")
    return wall_ms, busy_ms


def phase_serving(model_dir: str) -> int:
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.predictors import CheckpointPredictor
    from tensor2robot_tpu_torch.serving import PolicyServer
    from tensor2robot_tpu_torch.specs import make_random_numpy
    from tensor2robot_tpu_torch.train import state as state_lib

    predictor = CheckpointPredictor(
        full_width_model(True), checkpoint_dir=model_dir, device=DEVICE
    )
    plain = CheckpointPredictor(full_width_model(False), device=DEVICE)
    trained = state_lib.load_checkpoint(model_dir)
    plain.load_state_dict(trained["params"], version=trained["step"])
    spec = predictor.get_feature_specification()
    episodes = make_random_numpy(spec, batch_size=DISTINCT_EPISODES, seed=1)
    expected = plain.predict(episodes)["action"]
    requests = [
        {key: value[i] for key, value in episodes.items()}
        for i in range(DISTINCT_EPISODES)
    ]

    replies, errors = [], []
    lock = threading.Lock()

    def client(index, server):
        try:
            futures = []
            for n in range(REQUESTS_PER_CLIENT):
                episode = (index + n) % DISTINCT_EPISODES
                futures.append((episode, time.monotonic(),
                                server.submit(requests[episode])))
            for episode, t_submit, future in futures:
                response = future.result(timeout=300)
                with lock:
                    replies.append((episode, time.monotonic() - t_submit,
                                    response))
        except Exception as err:  # noqa: BLE001 — reported by the caller
            with lock:
                errors.append(err)

    with PolicyServer(
        predictor, batch_buckets=BUCKETS, max_wait_ms=20,
        default_deadline_ms=120_000,
    ) as server:
        t_start = time.monotonic()
        server.start()
        log(f"[serving] started (restore + prewarm of {BUCKETS}) in "
            f"{time.monotonic() - t_start:.2f}s, model_version "
            f"{predictor.model_version} from {predictor.model_path}")
        if predictor.model_version != TRAIN_STEPS:
            raise AssertionError(
                f"served version {predictor.model_version}, not the trained "
                f"step {TRAIN_STEPS}"
            )
        reset_launches()
        t0 = time.monotonic()
        threads = [
            threading.Thread(target=client, args=(i, server))
            for i in range(CLIENTS)
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=600)
        wall = time.monotonic() - t0
        launches = read_launches()
        snap = server.snapshot()
    if errors or any(thread.is_alive() for thread in threads):
        raise AssertionError(f"client failures: {errors!r}")
    total = CLIENTS * REQUESTS_PER_CLIENT
    if len(replies) != total or snap["counters"]["completed"] != total:
        raise AssertionError(f"{len(replies)} replies of {total}: {snap}")
    worst = 0.0
    for episode, _, response in replies:
        action = response.outputs["action"]
        if action.shape != (SLICE["seq"], 7) or not np.isfinite(action).all():
            raise AssertionError(f"bad reply {action.shape}")
        err = np.abs(action - expected[episode])
        if (err > SERVE_TOL + SERVE_TOL * np.abs(expected[episode])).any():
            raise AssertionError(
                f"reply disagrees with plain attention: {err.max()}"
            )
        worst = max(worst, float(err.max()))
    batches = snap["counters"]["batches"]
    served = launches.pop("flash_fwd")
    if served == 0 or served != NUM_LAYERS * batches or any(launches.values()):
        raise AssertionError(
            f"flash launches {served} != {NUM_LAYERS} x {batches} batches, "
            f"or training kernels launched in serving: {launches}"
        )
    latencies = sorted(latency for _, latency, _ in replies)
    log(
        f"[serving] on {card_line()}: {total} episodes in {wall:.3f}s = "
        f"{total / wall:.3f} req/s; "
        f"client p50 {latencies[len(latencies) // 2] * 1e3:.1f} ms, "
        f"max {latencies[-1] * 1e3:.1f} ms; server p50_total "
        f"{snap['latency_ms']['p50_total']:.1f} ms, p50_compute "
        f"{snap['latency_ms']['p50_compute']:.1f} ms; batches {batches} "
        f"{snap['batches_by_bucket']}, fill {snap['batch_fill_ratio']:.3f}; "
        f"flash launches {served}; max |action - plain| {worst:.3e}"
    )
    profile_predict(predictor, requests)
    return served


def profile_predict(predictor, requests) -> None:
    """Where a served batch's time goes: the host stack the dispatcher
    does, then one max-bucket predict under torch.profiler."""
    import numpy as np

    from tensor2robot_tpu_torch.serving.buckets import pad_feature_batch

    rows = [requests[i % len(requests)] for i in range(BUCKETS[-1])]
    t0 = time.monotonic()
    batch = pad_feature_batch(rows, BUCKETS[-1])
    stack_ms = (time.monotonic() - t0) * 1e3
    log(f"[profile] bucket {BUCKETS[-1]}: host stack {stack_ms:.1f} ms; input "
        f"{sum(np.asarray(v).nbytes for v in batch.values()) / 1e6:.0f} MB")
    device_profile(f"predict bucket {BUCKETS[-1]}", lambda: predictor.predict(batch))


def critic_model():
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom,
    )

    return Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
        batch_size=CRITIC_BATCH, device_type="gpu", **CRITIC
    )


def critic_train_flops(image_size, batch_size, num_convs=(6, 6, 3), width=64):
    """Flops of one Grasping44 train step: the conv and dense products
    (2 flops a multiply-add) of the forward, times 3 for forward and
    backward. The same count as bench.py's _analytic_train_flops, kept
    here because this script imports nothing of the JAX side."""
    h, w = image_size
    flops = 0.0

    def conv(h, w, cin, cout, k, stride=1):
        nonlocal flops
        h, w = -(-h // stride), -(-w // stride)
        flops += 2.0 * batch_size * h * w * cout * k * k * cin
        return h, w

    h, w = conv(h, w, 3, width, 6, 2)
    h, w = -(-h // 3), -(-w // 3)
    for _ in range(num_convs[0]):
        h, w = conv(h, w, width, width, 5)
    h, w = -(-h // 3), -(-w // 3)
    for _ in range(num_convs[1]):
        h, w = conv(h, w, width, width, 3)
    h, w = -(-h // 2), -(-w // 2)
    for _ in range(num_convs[2]):
        h, w = h - 2, w - 2
        flops += 2.0 * batch_size * h * w * width * 9 * width
    flops += 2.0 * batch_size * (
        10 * 256 + 256 * width + h * w * width * 64 + 64 * 64 + 64
    )
    return flops * 3.0


def _share(got, ref, tol) -> float:
    """|got - ref| over its allowance tol * max|ref| + 1e-7."""
    allowance = tol * ref.abs().max().item() + 1e-7
    return (got - ref).abs().max().item() / allowance


def check_critic_on_cpu() -> None:
    """One full-width batch of CRITIC_CHECK_BATCH (center crop, no
    distortion) through the same weights on the card and on the CPU.

    A relu passes or stops a unit's gradient by the sign of its input and
    a max pool sends a window's gradient to its largest inputs: both
    choices jump, and two float32 runs whose activations differ in the
    last bits take a few of them the other way, which moves the weight
    gradients by percents of their max (PERF.md §6). So the card's
    float32 runs record their choices and every other run here is pinned
    to them (research/qtopt/routing.py). Held: the float32 loss
    (LOSS_TOL), batch-norm statistics (GRAD_TOL) and gradients
    (CRITIC_F32_GRAD_TOL; those 0 in exact arithmetic to ZERO_GRAD of the
    largest), and the float64 gradients (GRAD_TOL). The same card run
    with TF32 convs and matmuls must fail the float32 gradient limit, or
    the limit could not tell a wrong float32 path."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.research.qtopt.routing import (
        critic_gradients,
        pinned_routing,
        record_routing,
        worst_gap,
    )
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model = critic_model()
    base = {k: v.cpu() for k, v in Trainer(model, device=DEVICE).init_state(
        torch.Generator().manual_seed(0)).network.state_dict().items()}
    generator = DefaultRandomInputGenerator(batch_size=CRITIC_CHECK_BATCH, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), "cpu")

    def pinned(routing, device, dtype, tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with pinned_routing(routing.to(device)):
                return critic_gradients(model, base, batch, dtype, device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    failures = []

    def held(card, cpu, index, tol, zero=()):
        """Each tensor of card[index] within tol of cpu's; the names in
        `zero` are left to zero_to_rounding."""
        share, name = max((_share(v, cpu[index][n], tol), n)
                          for n, v in card[index].items() if n not in zero)
        if not share <= 1.0:
            failures.append(f"{name} at {share:.3f} of its allowance ({tol})")
        return (f"worst {name} at {share:.3f} of its allowance ({tol}) over "
                f"{len(card[index]) - len(zero)}")

    def zero_to_rounding(card, exact):
        """The gradients that are 0 in exact arithmetic (a bias before a
        batch norm on batch statistics: its float64 gradient is below
        ZERO_GRAD of the largest), each held to |g| <= that on the card."""
        floor = ZERO_GRAD * max(g.abs().max().item() for g in exact.values())
        zero = {n for n, g in exact.items() if g.abs().max().item() <= floor}
        worst = max((card[1][n].abs().max().item() for n in zero), default=0.0)
        if not worst <= floor:
            failures.append(f"a gradient that is 0 in exact arithmetic reads "
                            f"{worst} on the card (limit {floor})")
        return zero, (f"{len(zero)} gradients 0 in exact arithmetic, on the "
                      f"card at most {worst:.2e} (limit {floor:.2e})")

    def control(card, cpu, tol, zero):
        """The TF32 run must fail the float32 limit."""
        share, name = max((_share(g, cpu[1][n], tol), n)
                          for n, g in card[1].items() if n not in zero)
        if not share > 1.0:
            failures.append(
                f"a TF32 run passes the float32 limit {tol} ({name} at "
                f"{share:.3f} of it): the check cannot tell it from float32")
        return f"TF32 control {name} at {share:.1f} of the allowance"

    def loss(card, cpu, label):
        err = abs(card[0] - cpu[0]) / abs(cpu[0])
        if not err <= LOSS_TOL:
            failures.append(f"{label} loss {card[0]} on the card vs {cpu[0]}")
        return f"loss {card[0]:.7f} vs {cpu[0]:.7f} (rel {err:.2e})"

    on_card = torch.device(DEVICE).type == "cuda"
    with record_routing() as routing:
        card32 = critic_gradients(model, base, batch, torch.float32, DEVICE)
    with record_routing() as cpu_own:
        critic_gradients(model, base, batch, torch.float32, "cpu")
    flips = routing.differences(cpu_own)
    cpu32 = pinned(routing, "cpu", torch.float32)
    card64 = pinned(routing, DEVICE, torch.float64)
    cpu64 = pinned(routing, "cpu", torch.float64)
    zero, zero_text = zero_to_rounding(card32, cpu64[1])
    train = [loss(card32, cpu32, "float32"),
             "batch-norm statistics " + held(card32, cpu32, 2, GRAD_TOL),
             "gradients " + held(card32, cpu32, 1, CRITIC_F32_GRAD_TOL, zero),
             zero_text]
    if on_card:
        train.append(control(pinned(routing, DEVICE, torch.float32, tf32=True),
                             cpu32, CRITIC_F32_GRAD_TOL, zero))
    train += ["float64 " + loss(card64, cpu64, "float64"),
              "float64 gradients " + held(card64, cpu64, 1, GRAD_TOL)]
    exact = ", ".join(f"{who} {gap:.3e} ({name})" for who, (gap, name) in (
        ("card", worst_gap(card32[1], cpu64[1])),
        ("CPU", worst_gap(cpu32[1], cpu64[1]))))

    log(f"[critic] card vs CPU, batch {CRITIC_CHECK_BATCH} at full width, "
        f"every relu and pool pinned to the card's float32 choices (the CPU's "
        f"own float32 run takes {flips[0]} relu units and {flips[1]} pool "
        f"windows the other way): " + "; ".join(train)
        + f"; float32 gradients vs the pinned float64 on the CPU, worst of "
        f"each max: {exact}")
    if failures:
        raise AssertionError("critic card vs CPU: " + "; ".join(failures))


def same_train_state(live, restored) -> str:
    """Raises unless two TrainStates hold the same step and the same bits
    in every network parameter and buffer, EMA parameter and optimizer
    state tensor; returns what was compared."""
    import torch

    def tensors(state):
        optimizer = state.optimizer.state_dict()
        out = {f"network.{k}": v for k, v in state.network.state_dict().items()}
        out.update({f"ema.{k}": v for k, v in (state.ema_params or {}).items()})
        out.update({f"optimizer.{i}.{k}": v
                    for i, slots in optimizer["state"].items()
                    for k, v in slots.items() if torch.is_tensor(v)})
        return out, optimizer["param_groups"]

    (a, groups_a), (b, groups_b) = tensors(live), tensors(restored)
    if live.step != restored.step or groups_a != groups_b or set(a) != set(b):
        raise AssertionError(
            f"restored state differs: step {restored.step} vs {live.step}, "
            f"keys {sorted(set(a) ^ set(b))[:5]}")
    for key in a:
        if a[key].dtype != b[key].dtype or not torch.equal(a[key], b[key].to(a[key].device)):
            raise AssertionError(f"restored {key} differs from the live one")
    kinds = {k.split(".")[0] for k in a}
    counts = {kind: sum(k.startswith(kind + ".") for k in a) for kind in sorted(kinds)}
    return ", ".join(f"{n} {kind} tensors" for kind, n in counts.items())


def phase_critic(model_dir: str) -> None:
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train import train_eval as train_eval_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.metrics import read_metrics
    from tensor2robot_tpu_torch.train.train_eval import (
        Trainer,
        evaluate,
        restore_or_init_state,
        train_eval_model,
    )

    check_critic_on_cpu()
    torch.cuda.empty_cache()

    model = critic_model()
    reset_launches()
    # train_eval_model keeps its TrainState to itself: catch the object
    # its restore_or_init_state returns, which its steps then update in
    # place, to hold the restored checkpoint against the live state.
    live = []

    def catch_state(*args, **kwargs):
        live.append(restore_or_init_state(*args, **kwargs))
        return live[-1]

    train_eval_lib.restore_or_init_state = catch_state
    t0 = time.monotonic()
    try:
        final_eval = train_eval_model(
            model,
            DefaultRandomInputGenerator(batch_size=CRITIC_BATCH, seed=0),
            DefaultRandomInputGenerator(batch_size=CRITIC_BATCH, seed=1000),
            model_dir=model_dir, max_train_steps=TRAIN_STEPS,
            save_checkpoints_steps=SAVE_EVERY, eval_steps=CRITIC_EVAL_STEPS,
            log_every_steps=LOG_EVERY, seed=0, device=DEVICE,
        )
        torch.cuda.synchronize()
    finally:
        train_eval_lib.restore_or_init_state = restore_or_init_state
    wall = time.monotonic() - t0
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the critic launched flash kernels: {launches}")
    steps = state_lib.checkpoint_steps(model_dir)
    if steps != [SAVE_EVERY, TRAIN_STEPS]:
        raise AssertionError(f"critic checkpoints {steps}")
    records = read_metrics(os.path.join(model_dir, "train"))
    logged = [r["step"] for r in records]
    if logged != list(range(LOG_EVERY, TRAIN_STEPS + 1, LOG_EVERY)):
        raise AssertionError(f"critic metrics logged at steps {logged}")
    losses = [r["loss"] for r in records]
    evals = [r for r in read_metrics(os.path.join(model_dir, "eval"))]
    if (not all(math.isfinite(x) for x in losses)
            or set(final_eval) != {"loss", "accuracy", "q_mean"}
            or not all(math.isfinite(v) for v in final_eval.values())
            or [r["step"] for r in evals] != [SAVE_EVERY, TRAIN_STEPS]):
        raise AssertionError(
            f"critic losses {losses}, evals {evals}, final {final_eval}")
    # The restore of the last checkpoint is the live state, bit for bit,
    # and evaluates to the same bits.
    trainer = Trainer(model, device=DEVICE)
    restored = restore_or_init_state(model_dir, trainer)
    compared = same_train_state(live[0], restored)
    eval_generator = DefaultRandomInputGenerator(batch_size=CRITIC_BATCH, seed=1000)
    eval_generator.set_specification_from_model(model, "eval")
    again = evaluate(trainer, restored, iter(eval_generator.create_dataset("eval")),
                     eval_steps=CRITIC_EVAL_STEPS, use_ema=True)
    if restored.step != TRAIN_STEPS or again != final_eval:
        raise AssertionError(
            f"restored step {restored.step} evaluates to {again}, the live "
            f"run to {final_eval}")
    # The EMA of 20 steps at 0.9999 is ~the initial weights, so the eval
    # above hardly depends on training: the raw parameters' train-mode
    # loss on a fixed batch does, and must differ from the initial one's.
    generator = DefaultRandomInputGenerator(batch_size=CRITIC_BATCH, seed=7)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), DEVICE)
    initial = trainer.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():
        raw = {name: trainer.forward_loss(state.network, batch)[0].item()
               for name, state in (("live", live[0]), ("restored", restored),
                                   ("initial", initial))}
    if raw["live"] != raw["restored"] or raw["live"] == raw["initial"]:
        raise AssertionError(f"raw-parameter train-mode losses {raw}")
    log(f"[critic] train_eval_model on {card_line()}: {TRAIN_STEPS} steps of "
        f"batch {CRITIC_BATCH} at {CRITIC['image_size']}, checkpoints {steps}, "
        f"in {wall:.1f}s (host data, evals and checkpoints included); losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; EMA evals "
        f"{[round(r['loss'], 6) for r in evals]}; restore of "
        f"{TRAIN_STEPS}.pt equal to the live state bit for bit ({compared}), "
        f"its EMA eval {again} equal to the live one, its raw parameters' "
        f"train-mode loss {raw['restored']!r} equal to the live one "
        f"(initial weights: {raw['initial']!r}); flash launches {launches}")
    time_critic_step(model_dir)


def time_critic_step(model_dir: str) -> None:
    """Median of synced critic train steps on one device batch (the crop
    and distortion included, as in the step), peak memory, achieved
    TFLOP/s and a torch.profiler breakdown."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import (
        Trainer,
        restore_or_init_state,
    )

    model = critic_model()
    trainer = Trainer(model, device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    generator = DefaultRandomInputGenerator(batch_size=CRITIC_BATCH, seed=7)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), DEVICE)
    for _ in range(3):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    median = sorted(times)[len(times) // 2]
    MEASURED["critic_step_ms"] = median
    flops = critic_train_flops(CRITIC["image_size"], CRITIC_BATCH,
                               CRITIC["num_convs"], CRITIC["width"])
    achieved = flops / (median / 1e3)
    log(f"[critic] train step (batch {CRITIC_BATCH}, on-device batch) on "
        f"{card_line()}: median {median:.3f} ms over {TIMED_STEPS} synced "
        f"steps (min {min(times):.3f}, max {max(times):.3f}) = "
        f"{1e3 / median:.3f} steps/s; peak memory allocated "
        f"{peak / 2**30:.3f} GiB; {flops / 1e12:.4f} TFLOP a step (analytic) "
        f"-> {achieved / 1e12:.2f} TFLOP/s, {100 * achieved / F32_ROUTES[SIMT_F32]:.1f}% "
        f"of the f32 peak outside the tensor cores (TF32 off)")
    device_profile("critic train step", lambda: trainer.train_step(state, batch),
                   rows=15)


# -- the data phase -------------------------------------------------------------


# -- export: the BC and critic programs served without model code ------------------

# The training phase's exports, in the order they were written.
EXPORTS = []
CRITIC_REQUESTS = 8
CRITIC_SERVE_TOL = 1e-5
INT8_TOL = 0.05
INT8_SIZE_RATIO = 0.5


def export_sizes(path: str) -> dict:
    """MB of an export's program, variables and warmup records."""
    from tensor2robot_tpu_torch.export import saved_model
    from tensor2robot_tpu_torch.export.export_generators import (
        WARMUP_DIR,
        WARMUP_FILENAME,
    )

    def mb(file):
        return os.path.getsize(file) / 1e6 if os.path.exists(file) else 0.0

    return {
        "program_mb": mb(saved_model.program_path(path)),
        "variables_mb": mb(os.path.join(path, saved_model.VARIABLES_FILENAME)),
        "warmup_mb": mb(os.path.join(path, WARMUP_DIR, WARMUP_FILENAME)),
    }


def timed_exporters(model):
    """create_default_exporters with the serving ladder (best on the eval
    mse), each export timed and sized into EXPORTS; raises unless every
    export carries its program."""
    from tensor2robot_tpu_torch.export import (
        create_default_exporters,
        create_valid_result_smaller,
    )
    from tensor2robot_tpu_torch.export.saved_model import read_metadata

    exporters = create_default_exporters(
        model, warmup_batch_sizes=BUCKETS,
        compare_fn=create_valid_result_smaller("eval/mse"),
    )
    for exporter in exporters:
        def timed(fn=exporter.maybe_export, name=exporter.name, **kwargs):
            t0 = time.monotonic()
            path = fn(**kwargs)
            if path is None:
                return None
            seconds = time.monotonic() - t0
            meta = read_metadata(path)
            if meta["program"] is not True:
                raise AssertionError(f"{path}: no program: {meta['program_error']}")
            EXPORTS.append(dict(exporter=name, step=kwargs["step"], path=path,
                                seconds=seconds, **export_sizes(path)))
            return path

        exporter.maybe_export = timed
    return exporters


def install_version(source: str, root: str, version: int) -> str:
    """Copies an export into `root` as version `version`, renamed into
    place so a poller never sees it half copied."""
    import shutil

    tmp = os.path.join(root, f"temp-{version}")
    shutil.copytree(source, tmp)
    final = os.path.join(root, str(version))
    os.replace(tmp, final)
    return final


def run_clients(server, requests, until) -> list:
    """CLIENTS threads, each submitting request (index + n) % len(requests)
    one at a time while `until(index, replies so far)` holds; returns
    (client, episode, latency s, reply time, response) tuples."""
    replies, errors = [], []
    lock = threading.Lock()

    def client(index):
        n = 0
        try:
            while True:
                with lock:
                    mine = sum(1 for r in replies if r[0] == index)
                if not until(index, mine):
                    return
                episode = (index + n) % len(requests)
                t_submit = time.monotonic()
                response = server.call(requests[episode], timeout=300)
                t_done = time.monotonic()
                with lock:
                    replies.append((index, episode, t_done - t_submit, t_done,
                                    response))
                n += 1
        except Exception as err:  # noqa: BLE001 — reported by the caller
            with lock:
                errors.append(err)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(CLIENTS)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=900)
    if errors or any(thread.is_alive() for thread in threads):
        raise AssertionError(f"client failures: {errors!r}")
    return replies


def check_replies(replies, expected) -> float:
    """Raises unless every reply is finite, [seq, 7] and within SERVE_TOL
    of the einsum-attention action of its own version; returns the max
    abs error."""
    import numpy as np

    worst = 0.0
    for _, episode, _, _, response in replies:
        action = response.outputs["action"]
        want = expected[response.model_version][episode]
        if action.shape != (SLICE["seq"], 7) or not np.isfinite(action).all():
            raise AssertionError(f"bad reply {action.shape}")
        err = np.abs(action - want)
        if (err > SERVE_TOL + SERVE_TOL * np.abs(want)).any():
            raise AssertionError(
                f"version {response.model_version} reply disagrees with "
                f"einsum attention: {err.max()}")
        worst = max(worst, float(err.max()))
    return worst


def p50_ms(values) -> float:
    values = sorted(values)
    return values[len(values) // 2] * 1e3


def phase_export(model_dir: str) -> int:
    """Serves the training phase's BC exports with no model code (ladder
    from their metadata, a hot swap under traffic, an int8 export), then
    exports the critic phase's EMA weights and serves them. Returns the B2
    launches of the phase."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.export import (
        ExportedModel,
        Exporter,
        LatestExporter,
        list_export_dirs,
    )
    from tensor2robot_tpu_torch.export.saved_model import read_metadata
    from tensor2robot_tpu_torch.predictors import (
        CheckpointPredictor,
        ExportedSavedModelPredictor,
    )
    from tensor2robot_tpu_torch.serving import PolicyServer
    from tensor2robot_tpu_torch.specs import make_random_numpy
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.train_eval import (
        Trainer,
        restore_or_init_state,
    )

    steps = (SAVE_EVERY, TRAIN_STEPS)
    exports = {
        read_metadata(path)["global_step"]: path
        for path in list_export_dirs(os.path.join(model_dir, "export", "latest"))
    }
    if sorted(exports) != list(steps):
        raise AssertionError(f"latest exports of steps {sorted(exports)}")
    root = os.path.join(model_dir, "served")
    install_version(exports[SAVE_EVERY], root, SAVE_EVERY)
    predictor = ExportedSavedModelPredictor(export_dir=root, device=DEVICE)
    t0 = time.monotonic()
    if not predictor.restore():
        raise AssertionError("no export to restore")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    spec = predictor.get_feature_specification()
    episodes = make_random_numpy(spec, batch_size=DISTINCT_EPISODES, seed=1)
    expected = {}
    for step in steps:  # the same weights through einsum attention
        reference = CheckpointPredictor(full_width_model(False), device=DEVICE)
        reference.load_state_dict(state_lib.load_checkpoint(model_dir, step)["params"])
        expected[step] = reference.predict(episodes)["action"]
        del reference
    torch.cuda.empty_cache()
    requests = [{k: v[i] for k, v in episodes.items()} for i in range(DISTINCT_EPISODES)]

    total = 0
    with PolicyServer(predictor, max_wait_ms=20, default_deadline_ms=120_000) as server:
        reset_launches()
        t0 = time.monotonic()
        server.start()
        torch.cuda.synchronize()
        prewarm_s = time.monotonic() - t0
        prewarm = read_launches()
        snap = server.snapshot()
        if server.buckets != BUCKETS or snap["warmup_source"] != "export":
            raise AssertionError(
                f"ladder {server.buckets} from {snap['warmup_source']}, not "
                f"the export's {BUCKETS}")
        if prewarm["flash_fwd"] != NUM_LAYERS * len(BUCKETS) or any(
                v for k, v in prewarm.items() if k != "flash_fwd"):
            raise AssertionError(f"prewarm launches {prewarm}")
        total += prewarm["flash_fwd"]
        log(f"[export] BC export of step {SAVE_EVERY} restored with no model "
            f"code on {card_line()}: load + move {load_s:.2f}s, prewarm of "
            f"{BUCKETS} (ladder from t2r_metadata.json, the export's warmup "
            f"requests) {prewarm_s:.2f}s; B2 launches {prewarm['flash_fwd']}")

        # Steady state on version 10.
        reset_launches()
        before = server.snapshot()["counters"]["batches"]
        t0 = time.monotonic()
        replies = run_clients(server, requests,
                              lambda i, mine: mine < REQUESTS_PER_CLIENT)
        wall = time.monotonic() - t0
        launches = read_launches()
        snap = server.snapshot()
        batches = snap["counters"]["batches"] - before
        if {r[4].model_version for r in replies} != {SAVE_EVERY}:
            raise AssertionError("steady-state replies from another version")
        worst = check_replies(replies, expected)
        served = launches.pop("flash_fwd")
        if served != NUM_LAYERS * batches or any(launches.values()):
            raise AssertionError(
                f"B2 launches {served} != {NUM_LAYERS} x {batches} batches, or "
                f"other kernels launched: {launches}")
        total += served
        MEASURED["export_f32"] = (len(replies) / wall, p50_ms([r[2] for r in replies]))
        log(f"[export] served from the export on {card_line()}: "
            f"{len(replies)} episodes in {wall:.3f}s = {len(replies) / wall:.3f} "
            f"episodes/s; client p50 {p50_ms([r[2] for r in replies]):.1f} ms; "
            f"server p50_total {snap['latency_ms']['p50_total']:.1f} ms, "
            f"p50_compute {snap['latency_ms']['p50_compute']:.1f} ms; batches "
            f"{batches}; B2 launches {served}; max |action - einsum| {worst:.3e}")

        # Hot swap to version 20 under traffic.
        swap = {}

        def until(index, mine):
            if mine >= 2 and index == 0 and "start" not in swap:
                swap["start"] = time.monotonic()
                install_version(exports[TRAIN_STEPS], root, TRAIN_STEPS)
                if not server.hot_swap():
                    raise AssertionError("hot_swap refused")
            if "landed" not in swap and predictor.model_version == TRAIN_STEPS:
                swap["landed"] = time.monotonic()
                swap["counts"] = {}
            if "landed" not in swap:
                return True
            base = swap["counts"].setdefault(index, mine)
            return mine < base + 3

        reset_launches()
        before = server.snapshot()["counters"]["batches"]
        replies = run_clients(server, requests, until)
        launches = read_launches()
        snap = server.snapshot()
        batches = snap["counters"]["batches"] - before
        worst = check_replies(replies, expected)
        for index in range(CLIENTS):
            versions = [r[4].model_version for r in replies if r[0] == index]
            if versions != sorted(versions) or set(versions) - set(steps):
                raise AssertionError(f"client {index} saw versions {versions}")
            if versions[-1] != TRAIN_STEPS:
                raise AssertionError(f"client {index} ended on {versions[-1]}")
        if snap["prewarmed"].get(str(TRAIN_STEPS)) != list(BUCKETS):
            raise AssertionError(f"version {TRAIN_STEPS} prewarmed {snap['prewarmed']}")
        served = launches.pop("flash_fwd")
        if served != NUM_LAYERS * (batches + len(BUCKETS)) or any(launches.values()):
            raise AssertionError(
                f"B2 launches {served} != {NUM_LAYERS} x ({batches} batches + "
                f"{len(BUCKETS)} prewarm predicts), or others: {launches}")
        total += served
        landed = swap["landed"]
        near = [r[2] for r in replies if abs(r[3] - landed) <= 0.5]
        log(f"[export] hot swap {SAVE_EVERY} -> {TRAIN_STEPS} under traffic: "
            f"landed {landed - swap['start']:.2f}s after hot_swap(); "
            f"{len(replies)} replies, versions per client never back, each "
            f"within {SERVE_TOL} of its version's einsum action (max "
            f"{worst:.3e}); version {TRAIN_STEPS} prewarmed {BUCKETS} first; "
            f"B2 launches {served} ({batches} batches + {len(BUCKETS)} prewarm "
            f"predicts); max reply latency within 0.5s of the swap "
            f"{max(near) * 1e3 if near else float('nan'):.1f} ms, client p50 "
            f"{p50_ms([r[2] for r in replies]):.1f} ms")
    predictor.close()
    del predictor
    torch.cuda.empty_cache()

    # int8: an export of step 20 with weight-only int8.
    trainer = Trainer(full_width_model(True), device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    t0 = time.monotonic()
    int8_path = Exporter("int8", quantize_weights=True).maybe_export(
        step=state.step, state=state, eval_metrics={}, compiled=trainer,
        model_dir=model_dir)
    int8_s = time.monotonic() - t0
    del state, trainer
    reset_launches()
    f32 = ExportedModel(exports[TRAIN_STEPS], device=DEVICE).predict(episodes)["action"]
    got = ExportedModel(int8_path, device=DEVICE).predict(episodes)["action"]
    launches = read_launches()
    if launches["flash_fwd"] != 2 * NUM_LAYERS:
        raise AssertionError(f"int8 / f32 predict launches {launches}")
    total += launches["flash_fwd"]
    gap = np.abs(got - f32)
    if (gap > INT8_TOL + INT8_TOL * np.abs(f32)).any():
        raise AssertionError(f"int8 actions {gap.max()} from the f32 export's")
    sizes, f32_sizes = export_sizes(int8_path), export_sizes(exports[TRAIN_STEPS])
    for key in ("program_mb", "variables_mb"):
        if sizes[key] >= INT8_SIZE_RATIO * f32_sizes[key]:
            raise AssertionError(f"int8 {key} {sizes[key]} vs f32 {f32_sizes[key]}")
    log(f"[export] int8 export of step {TRAIN_STEPS} in {int8_s:.2f}s: program "
        f"{sizes['program_mb']:.2f} MB (f32 {f32_sizes['program_mb']:.2f}), "
        f"variables {sizes['variables_mb']:.2f} MB (f32 "
        f"{f32_sizes['variables_mb']:.2f}); max |int8 - f32 action| "
        f"{gap.max():.3e} (limit {INT8_TOL} abs + rel)")
    torch.cuda.empty_cache()

    # The critic: its step-20 EMA weights, exported and served.
    critic_dir = os.path.join(model_dir, "critic")
    trainer = Trainer(critic_model(), device=DEVICE)
    state = restore_or_init_state(critic_dir, trainer)
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"critic state at step {state.step}")
    reset_launches()
    t0 = time.monotonic()
    path = LatestExporter("critic").maybe_export(
        step=state.step, state=state, eval_metrics={}, compiled=trainer,
        model_dir=critic_dir)
    critic_export_s = time.monotonic() - t0
    del state, trainer
    predictor = ExportedSavedModelPredictor(
        export_dir=os.path.dirname(path), device=DEVICE)
    t0 = time.monotonic()
    predictor.restore()
    critic_load_s = time.monotonic() - t0
    batch = make_random_numpy(predictor.get_feature_specification(),
                              batch_size=CRITIC_REQUESTS, seed=3)
    got = predictor.predict(batch)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the critic launched flash kernels: {launches}")
    reference = CheckpointPredictor(critic_model(), checkpoint_dir=critic_dir,
                                    device=DEVICE)
    reference.restore()
    want = reference.predict(batch)
    if set(got) != set(want):
        raise AssertionError(f"critic outputs {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for key, value in want.items():
        err = np.abs(got[key] - value)
        if (not np.isfinite(got[key]).all() or got[key].shape != value.shape
                or (err > CRITIC_SERVE_TOL + CRITIC_SERVE_TOL * np.abs(value)).any()):
            raise AssertionError(f"critic {key}: {err.max()} from the checkpoint's")
        worst = max(worst, float(err.max()))
    sizes = export_sizes(path)
    log(f"[export] critic (EMA of step {TRAIN_STEPS}, {CRITIC['image_size']} "
        f"crop of uint8 512x640 inside the program) exported in "
        f"{critic_export_s:.2f}s (program {sizes['program_mb']:.2f} MB, "
        f"variables {sizes['variables_mb']:.2f} MB), restored in "
        f"{critic_load_s:.2f}s; {CRITIC_REQUESTS} requests on {card_line()}: "
        f"max |exported - CheckpointPredictor(EMA)| {worst:.3e} (limit "
        f"{CRITIC_SERVE_TOL} abs + rel); flash launches {launches}")
    return total


# The serve_quant phase: low-precision serving exports of the training
# phase's step-20 BC weights (and the critic phase's EMA), one program per
# regime (export/serve_quant.py), each held to its own parity gate.
SERVE_QUANT_REGIMES = ("fp16", "int8", "fp8_e4m3", "fp8_e5m2")
SERVE_QUANT_EPISODES = 2  # a client's episodes per regime
SERVE_QUANT_CPU_EPISODES = 2
SERVE_QUANT_RECKONED_S = 130
# (d)'s einsum-head export: at T = 1024 the JAX package's int8 PV (probs
# on a fixed 1/127 step) misses the gate, so its export demotes; a short
# episode keeps it within.
SERVE_QUANT_EINSUM_SEQ = 32
# The warmup ladder (calibration and gate corpus) of (e)'s critic export.
SERVE_QUANT_SHORT_LADDER = (1, 2)


def bc_native_layers(num_layers: int) -> list:
    """The kernels full-width BC contracts natively (JAX's default
    eligibility: every dense and conv kernel of 16 rows or more)."""
    layers = ["params/Conv_0/kernel", "params/Conv_1/kernel", "params/embed/kernel",
              "params/action_head/kernel"]
    for block in range(num_layers):
        for name in ("attention/qkv", "attention/out", "mlp_in", "mlp_out"):
            layers.append(f"params/encoder/block_{block}/{name}/kernel")
    return sorted(layers)


def contracted_dtype(regime: str) -> str:
    """The dtype the program contracts a regime's fired layers in, as
    serve_quant.audit_dot_dtypes names it: e5m2 runs as f16 on the card
    (cuBLASLt multiplies no two e5m2 matrices), as e5m2 on the CPU."""
    if regime == "fp8_e5m2":
        return "f16" if DEVICE.startswith("cuda") else "f8e5m2"
    return {"fp16": "f32", "int8": "i8", "fp8_e4m3": "f8e4m3"}[regime]


def _quant_export(model, model_dir: str, name: str, regimes, ladder=BUCKETS) -> tuple:
    """One Exporter(serve_quant=regimes) export of `model_dir`'s newest
    checkpoint; returns (path, its serve_quant metadata, seconds, kernel
    launches during the export)."""
    import torch

    from tensor2robot_tpu_torch.export import Exporter
    from tensor2robot_tpu_torch.export.saved_model import read_metadata
    from tensor2robot_tpu_torch.train.train_eval import Trainer, restore_or_init_state

    trainer = Trainer(model, device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"{model_dir} state at step {state.step}")
    reset_launches()
    t0 = time.monotonic()
    path = Exporter(name, warmup_batch_sizes=ladder, serve_quant=regimes).maybe_export(
        step=TRAIN_STEPS, state=state, eval_metrics={}, compiled=trainer,
        model_dir=model_dir)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = read_launches()
    del state, trainer
    torch.cuda.empty_cache()
    return path, read_metadata(path)["serve_quant"], seconds, launches


def _check_regime_record(meta: dict, regime: str, layers: list, attention: list,
                         others: int = 0) -> str:
    """Raises unless the export's record of `regime` says every eligible
    layer (and attention module) fired, none unlowered or demoted, the
    dot audit counts each fired contraction once in the regime's
    contracted dtype and `others` (the layers too shallow to be eligible)
    in f32, and the program quantizes no activation per call but the
    layers the static calibration demoted; returns a summary."""
    from tensor2robot_tpu_torch.export import serve_quant as sq

    native, calib = meta["native"][regime], meta["calib"][regime]
    dot, reduce = meta["dot_audit"][regime], meta["reduce_audit"][regime]
    want_layers = layers if regime in sq.NATIVE_DOT_REGIMES else []
    want_attention = attention if regime in sq.NATIVE_DOT_REGIMES else []
    if (sorted(native["layers"]) != want_layers or native.get("unlowered")
            or native["attention"] != want_attention or native["demoted"]):
        raise AssertionError(f"{regime} native record {native}")
    contractions = len(layers) + 2 * len(attention)
    want_dot = {contracted_dtype(regime): contractions}
    if regime == "fp16":
        want_dot = {"f32": len(layers)}
    if others:
        want_dot["f32"] = want_dot.get("f32", 0) + others
    want_dot["total"] = sum(want_dot.values())
    if dot != want_dot:
        raise AssertionError(f"{regime} dot audit {dot} != {want_dot}")
    fired = set(want_layers) | set(want_attention)
    demoted = [k for k in calib["demoted_to_dynamic"]
               if (k.rsplit(":", 1)[0] if k.startswith("attn/") else k) in fired]
    if regime in sq.NATIVE_DOT_REGIMES and (
            calib["mode"] != "static"
            or reduce["activation_quant_reduces"] != len(demoted)):
        raise AssertionError(f"{regime} calib {calib['mode']}, reduce audit {reduce}, "
                             f"demoted {demoted}")
    parity = meta["parity"][regime]
    return (f"gate {max(parity['max_divergence'].values()):.4e} <= "
            f"{parity['tolerance']}; fired {len(native['layers'])} layers + "
            f"{len(native['attention'])} attention; dot audit {dot}; activation-quant "
            f"reduces {reduce['activation_quant_reduces']} (static, {len(demoted)} "
            f"demoted to dynamic)")


def _serve_regime(root: str, regime: str, requests, expected, tol: float) -> dict:
    """Serves `regime` of the export under `root` through
    ExportedSavedModelPredictor and PolicyServer to CLIENTS clients of
    SERVE_QUANT_EPISODES episodes each; every reply within `tol` of the f32
    export's action for its episode, B2 exactly NUM_LAYERS a batch (and
    a prewarmed bucket). Returns rates, launches and the snapshot."""
    import numpy as np

    from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
    from tensor2robot_tpu_torch.serving import PolicyServer

    predictor = ExportedSavedModelPredictor(export_dir=root, device=DEVICE,
                                            quant_regime=regime)
    if not predictor.restore():
        raise AssertionError(f"{regime}: no export to restore")
    with PolicyServer(predictor, max_wait_ms=20, default_deadline_ms=120_000) as server:
        reset_launches()
        server.start()
        prewarm = read_launches()
        reset_launches()
        before = server.snapshot()["counters"]["batches"]
        t0 = time.monotonic()
        replies = run_clients(server, requests,
                              lambda i, mine: mine < SERVE_QUANT_EPISODES)
        wall = time.monotonic() - t0
        launches = read_launches()
        snap = server.snapshot()
    predictor.close()
    batches = snap["counters"]["batches"] - before
    served = launches.pop("flash_fwd")
    if (served != NUM_LAYERS * batches or any(launches.values())
            or prewarm["flash_fwd"] != NUM_LAYERS * len(BUCKETS)):
        raise AssertionError(f"{regime}: B2 {served} for {batches} batches, others "
                             f"{launches}, prewarm {prewarm}")
    worst = 0.0
    for _, episode, _, _, response in replies:
        action = response.outputs["action"]
        err = np.abs(action - expected[episode])
        if not np.isfinite(action).all() or not err.max() <= tol:
            raise AssertionError(f"{regime} reply {err.max()} from the f32 export's")
        worst = max(worst, float(err.max()))
    return dict(episodes=len(replies), rate=len(replies) / wall,
                p50=p50_ms([r[2] for r in replies]), batches=batches,
                b2=served + prewarm["flash_fwd"], worst=worst, snap=snap)


def phase_serve_quant(model_dir: str) -> int:
    """Low-precision serving exports (export/serve_quant.py) of the
    training phase's step-20 BC weights and the critic phase's EMA, with
    static activation calibration. Returns the B2 launches of the BC export
    and of the served programs."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.export import ExportedModel
    from tensor2robot_tpu_torch.export import serve_quant as sq
    from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
    from tensor2robot_tpu_torch.specs import make_random_numpy

    t_phase = time.monotonic()
    saved_calib = os.environ.get("T2R_SERVE_CALIB")
    os.environ["T2R_SERVE_CALIB"] = "static"
    try:
        total = _serve_quant_bc(model_dir)
        # (d) einsum heads: the same weights with use_flash=False.
        _serve_quant_einsum(model_dir)
        # (e) the critic's EMA at full width.
        critic_dir = os.path.join(model_dir, "critic")
        path, meta, seconds, launches = _quant_export(
            critic_model(), critic_dir, "serve_quant", ("int8",),
            ladder=SERVE_QUANT_SHORT_LADDER)
        layers = sorted(meta["native"]["int8"]["layers"])
        convs = [k for k in layers if "conv" in k]
        dense = sum(isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))
                    for m in critic_model().create_network().modules())
        summary = _check_regime_record(meta, "int8", layers, [], others=dense - len(layers))
        predictor = ExportedSavedModelPredictor(
            export_dir=os.path.dirname(path), device=DEVICE, quant_regime="int8")
        predictor.restore()
        batch = make_random_numpy(predictor.get_feature_specification(),
                                  batch_size=CRITIC_REQUESTS, seed=3)
        reset_launches()
        got = predictor.predict(batch)
        want = ExportedModel(path, device=DEVICE, quant_regime="none").predict(batch)
        after = read_launches()
        predictor.close()
        worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        if (not convs or any(launches.values()) or any(after.values())
                or not worst <= sq.DEFAULT_PARITY_TOL["int8"]):
            raise AssertionError(f"critic int8: {worst}, convs {convs}, launches "
                                 f"{launches} / {after}")
        log(f"[serve_quant] (e) critic (EMA of step {TRAIN_STEPS}, {CRITIC['image_size']}) "
            f"int8 export on {card_line()} in {seconds:.1f}s: {summary} ({len(convs)} "
            f"convs; {dense - len(layers)} shallow dense layers stay f32, as in the JAX "
            f"package); {CRITIC_REQUESTS} requests within {worst:.4e} of its f32 program "
            f"(limit {sq.DEFAULT_PARITY_TOL['int8']}); no flash launch")
    finally:
        if saved_calib is None:
            os.environ.pop("T2R_SERVE_CALIB", None)
        else:
            os.environ["T2R_SERVE_CALIB"] = saved_calib
    log(f"[serve_quant] phase {time.monotonic() - t_phase:.1f}s (reckoned "
        f"{SERVE_QUANT_RECKONED_S} s)")
    return total


def _serve_quant_einsum(model_dir: str) -> None:
    """(d) of the serve_quant phase: full-width BC with einsum heads. At
    T = 1024 the regime's int8 QK^T and PV (the JAX package's: the softmax
    probs on a fixed 1/127 step) are measured against the f32 forward over
    the warmup corpus, as the exporter's native pre-gate measures them; at
    T = SERVE_QUANT_EINSUM_SEQ the int8 serving module fires every
    attention module within the gate, and its program audits int8. No
    flash launch."""
    import torch

    from tensor2robot_tpu_torch.export import serve_quant as sq
    from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
    from tensor2robot_tpu_torch.export.saved_model import run_batch, export_quant_program
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.train.train_eval import Trainer, restore_or_init_state

    tol = sq.DEFAULT_PARITY_TOL["int8"]
    model = full_width_model(False)
    trainer = Trainer(model, device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    variables = state.export_state_dict(use_ema=False)
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    warmup = generator.generate_warmup_batches(BUCKETS)
    reset_launches()
    f32 = generator.create_serving_fn(variables, device=trainer.device)
    quant = generator.create_quant_serving_fn(
        variables, "int8", calibration=sq.calibrate_activations(warmup),
        device=trainer.device)
    divergence = sq.measure_parity(
        [run_batch(f32, batch, trainer.device) for batch in warmup],
        [run_batch(quant, batch, trainer.device, quant.quant_payload) for batch in warmup])
    fired = sorted(k for k in quant.quant_native_fired if k.startswith("attn/"))
    del f32, quant, state, trainer
    attention = [f"attn/encoder/block_{i}/attention" for i in range(NUM_LAYERS)]
    if fired != attention or any(read_launches().values()):
        raise AssertionError(f"einsum heads lowered {fired}, launched {read_launches()}")
    log(f"[serve_quant] (d) einsum heads at T = {SLICE['seq']} on {card_line()}: int8 "
        f"with QK^T and PV lowered, {len(warmup)} warmup batches: max |int8 - f32| "
        f"{max(divergence.values()):.4e} (gate {tol}: the exporter "
        f"{'keeps it native' if max(divergence.values()) <= tol else 'demotes it to the dequant path'})")

    # The first `seq` steps of the same model: attention is causal, so
    # the position table's first `seq` rows are all a short episode reads.
    seq = min(SERVE_QUANT_EINSUM_SEQ, SLICE["seq"])
    short = TransformerBCModel(**dict(bc_model_kwargs(False), episode_length=seq))
    params = dict(variables)
    params["encoder.pos_embedding"] = variables["encoder.pos_embedding"][:seq]
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(short)
    warmup = generator.generate_warmup_batches(BUCKETS)
    device = torch.device(DEVICE)
    f32 = generator.create_serving_fn(params, device=device)
    quant = generator.create_quant_serving_fn(
        params, "int8", calibration=sq.calibrate_activations(warmup), device=device)
    t0 = time.monotonic()
    divergence = max(sq.measure_parity(
        [run_batch(f32, batch, device) for batch in warmup],
        [run_batch(quant, batch, device, quant.quant_payload) for batch in warmup],
    ).values())
    program = export_quant_program(quant, generator.create_example_features())
    dot = sq.audit_dot_dtypes(program)
    seconds = time.monotonic() - t0
    fired = sorted(quant.quant_native_fired)
    want = sorted(bc_native_layers(NUM_LAYERS) + attention)
    contractions = len(bc_native_layers(NUM_LAYERS)) + 2 * NUM_LAYERS
    launches = read_launches()
    if (fired != want or dot != {"i8": contractions, "total": contractions}
            or not divergence <= tol or any(launches.values())):
        raise AssertionError(f"einsum int8 at T = {seq}: fired {fired}, dot {dot}, "
                             f"divergence {divergence}, launches {launches}")
    log(f"[serve_quant] (d) einsum heads at T = {seq} (the first {seq} positions of the "
        f"same weights) on {card_line()}: int8 within {divergence:.4e} of f32 over "
        f"{len(warmup)} warmup batches (gate {tol}); fired {len(fired) - NUM_LAYERS} "
        f"layers + {NUM_LAYERS} attention; its program (traced in "
        f"{seconds:.1f}s with the gate) audits {dot}; no flash launch")


def _serve_quant_bc(model_dir: str) -> int:
    """(a)-(c) of the serve_quant phase on full-width BC with flash heads;
    returns the B2 launches of the export (its gates run every regime's
    module) and of the served programs."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.export import ExportedModel, list_export_dirs
    from tensor2robot_tpu_torch.export import saved_model
    from tensor2robot_tpu_torch.export import serve_quant as sq
    from tensor2robot_tpu_torch.specs import make_random_numpy

    # (a) one export carrying every regime.
    path, meta, seconds, export_launches = _quant_export(
        full_width_model(True), model_dir, "serve_quant", SERVE_QUANT_REGIMES)
    layers = bc_native_layers(NUM_LAYERS)
    f32_mb = os.path.getsize(os.path.join(path, saved_model.VARIABLES_FILENAME)) / 1e6
    for regime in SERVE_QUANT_REGIMES:
        summary = _check_regime_record(meta, regime, layers, [])
        sizes = {k: v / 1e6 for k, v in meta["payload_bytes"][regime].items()}
        file_mb = os.path.getsize(os.path.join(
            path, saved_model.quant_payload_relpath(regime))) / 1e6
        log(f"[serve_quant] (a) {regime}: payload {file_mb:.3f} MB (values "
            f"{sizes['values']:.3f}, scales {sizes['scales']:.3f}, passthrough "
            f"{sizes['passthrough']:.3f}) beside the f32 variables {f32_mb:.3f} MB; "
            f"{summary}")
    log(f"[serve_quant] (a) full-width BC (flash heads) exported in {seconds:.1f}s on "
        f"{card_line()}: regimes {list(meta['regimes'])}, static calibration over the "
        f"warmup ladder {BUCKETS}; B2 launches in the export {export_launches['flash_fwd']}")

    # (b) each regime served, beside the f32 program.
    root = os.path.dirname(path)
    f32 = ExportedModel(path, device=DEVICE, quant_regime="none")
    spec = f32.feature_spec
    episodes = make_random_numpy(spec, batch_size=DISTINCT_EPISODES, seed=11)
    expected = f32.predict(episodes)["action"]
    del f32
    requests = [{k: v[i] for k, v in episodes.items()} for i in range(DISTINCT_EPISODES)]
    total = export_launches["flash_fwd"]
    f32_rate = ("the export phase's f32 program: {:.3f} episodes/s, p50 {:.1f} ms".format(
        *MEASURED["export_f32"]) if "export_f32" in MEASURED
        else "the f32 program's rate: not measured in this run")
    for regime in SERVE_QUANT_REGIMES:
        tol = sq.DEFAULT_PARITY_TOL[regime]
        run = _serve_regime(root, regime, requests, expected, tol)
        snap = run.pop("snap")
        native = regime in sq.NATIVE_DOT_REGIMES
        if (snap["serve_quant"] != regime
                or snap["serve_quant_native_layers"] != (layers if native else [])
                or snap.get("serve_quant_calib") != ("static" if native else None)):
            raise AssertionError(f"{regime} snapshot {snap}")
        total += run["b2"]
        log(f"[serve_quant] (b) {regime} served on {card_line()}: {run['episodes']} "
            f"episodes ({CLIENTS} clients x {SERVE_QUANT_EPISODES}) within "
            f"{run['worst']:.4e} of the f32 export (limit {tol}); {run['rate']:.3f} "
            f"episodes/s, client p50 {run['p50']:.1f} ms ({f32_rate}); batches "
            f"{run['batches']}, B2 {run['b2']} with the prewarm; snapshot regime "
            f"{snap['serve_quant']}, calib {snap.get('serve_quant_calib')}, "
            f"{len(snap.get('serve_quant_native_layers', []))} native layers")

    # (c) the int8 program on the card and on the CPU, the same payload.
    sub = {k: v[:SERVE_QUANT_CPU_EPISODES] for k, v in episodes.items()}
    reset_launches()
    card = ExportedModel(path, device=DEVICE, quant_regime="int8").predict(sub)["action"]
    total += read_launches()["flash_fwd"]
    t0 = time.monotonic()
    cpu = ExportedModel(path, device="cpu", quant_regime="int8").predict(sub)["action"]
    cpu_s = time.monotonic() - t0
    gap = float(np.abs(card - cpu).max())
    if not gap <= sq.DEFAULT_PARITY_TOL["int8"]:
        raise AssertionError(f"int8 card vs CPU {gap}")
    plain = list_export_dirs(os.path.join(model_dir, "export", "latest"))[-1]
    os.environ["T2R_SERVE_QUANT"] = "int8"
    try:
        ExportedModel(plain, device=DEVICE)
    except ValueError as err:
        if "T2R_SERVE_QUANT" not in str(err):
            raise
    else:
        raise AssertionError("a regime the export lacks did not raise")
    finally:
        os.environ.pop("T2R_SERVE_QUANT", None)
    log(f"[serve_quant] (c) int8 program on {card_line()} vs the CPU (same payload, "
        f"{SERVE_QUANT_CPU_EPISODES} episodes, {cpu_s:.1f}s on the CPU): max |card - cpu| "
        f"{gap:.4e} (limit {sq.DEFAULT_PARITY_TOL['int8']}); T2R_SERVE_QUANT=int8 on a "
        "plain export raises naming the flag")
    torch.cuda.empty_cache()
    return total


# The aot phase: AOTInductor packages of full-width BC (export/aot.py), one
# a (regime, warmup bucket), built at export and served with no eager
# program; then the fallbacks and the artifact store. The f32 ladder only:
# int8's four builds would double the phase's, so its packages are built in
# the CPU tests (tests/test_torch_aot.py). On the card they diverged from
# the int8 eager program past the package gate (aot.PACKAGE_PARITY_TOL),
# which refuses such a regime at export (ROADMAP.md A10.2-int8).
AOT_REGIMES = ()
AOT_EPISODES = 2  # a client's episodes each way
AOT_RECKONED_S = 130


@contextlib.contextmanager
def _env(**values):
    """Sets (or, with None, unsets) environment variables for a block."""
    saved = {name: os.environ.get(name) for name in values}
    for name, value in values.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def _aot_boot(root: str, regime: str, requests, expected, aot: bool) -> dict:
    """Restores the export under `root` in `regime` with T2R_SERVE_AOT on
    (and T2R_AOT_REQUIRE) or off, prewarms every bucket under PolicyServer
    and serves CLIENTS clients of AOT_EPISODES episodes each; every reply
    within SERVE_TOL (abs + rel) of `expected`, B2 exactly NUM_LAYERS a
    batch and a prewarmed bucket. Returns the restore and serving numbers
    and the snapshot."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
    from tensor2robot_tpu_torch.serving import PolicyServer

    with _env(T2R_SERVE_AOT="1" if aot else "0", T2R_AOT_REQUIRE="1" if aot else None):
        predictor = ExportedSavedModelPredictor(export_dir=root, device=DEVICE,
                                                quant_regime=regime)
        t0 = time.monotonic()
        if not predictor.restore():
            raise AssertionError(f"{regime}: no export to restore under {root}")
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
    loaded = predictor.loaded_model
    with PolicyServer(predictor, max_wait_ms=20, default_deadline_ms=120_000) as server:
        reset_launches()
        t0 = time.monotonic()
        server.start()
        torch.cuda.synchronize()
        prewarm_s = time.monotonic() - t0
        prewarm = read_launches()
        reset_launches()
        before = server.snapshot()["counters"]["batches"]
        t0 = time.monotonic()
        replies = run_clients(server, requests, lambda i, mine: mine < AOT_EPISODES)
        wall = time.monotonic() - t0
        launches = read_launches()
        snap = server.snapshot()
    predictor.close()
    batches = snap["counters"]["batches"] - before
    served = launches.pop("flash_fwd")
    if (served != NUM_LAYERS * batches or any(launches.values())
            or prewarm["flash_fwd"] != NUM_LAYERS * len(BUCKETS)):
        raise AssertionError(f"{regime} aot={aot}: B2 {served} for {batches} batches, "
                             f"others {launches}, prewarm {prewarm}")
    sources = {str(b): "aot" if aot else "compile" for b in BUCKETS}
    hits = len(BUCKETS) if aot else 0
    if (snap["prewarm_source"] != sources or snap["counters"]["aot_hits"] != hits
            or snap["counters"]["aot_misses"] or "aot_fallbacks" in snap
            or (loaded.fresh_trace_calls != 0) != (not aot)):
        raise AssertionError(f"{regime} aot={aot}: snapshot {snap}, fresh calls "
                             f"{loaded.fresh_trace_calls}")
    worst = 0.0
    for _, episode, _, _, response in replies:
        action = response.outputs["action"]
        want = expected[episode]
        err = np.abs(action - want)
        if not np.isfinite(action).all() or (err > SERVE_TOL + SERVE_TOL * np.abs(want)).any():
            raise AssertionError(f"{regime} aot={aot} reply {err.max()} from the eager "
                                 "program's")
        worst = max(worst, float(err.max()))
    return dict(load_s=load_s, prewarm_s=prewarm_s, episodes=len(replies),
                rate=len(replies) / wall, p50=p50_ms([r[2] for r in replies]),
                batches=batches, b2=served + prewarm["flash_fwd"], worst=worst, snap=snap)


def _eager_expected(path: str, regime: str, episodes) -> "np.ndarray":
    """The export's eager program on `episodes` (T2R_SERVE_AOT=0)."""
    from tensor2robot_tpu_torch.export import ExportedModel

    with _env(T2R_SERVE_AOT="0", T2R_AOT_REQUIRE=None):
        loaded = ExportedModel(path, device=DEVICE, quant_regime=regime)
        return loaded.predict(episodes)["action"]


def _copy_version(path: str, root: str) -> str:
    """A private copy of the export version `path` under `root`."""
    import shutil

    dest = os.path.join(root, os.path.basename(path))
    shutil.copytree(path, dest)
    return dest


def _edit_metadata(path: str, edit) -> None:
    meta_path = os.path.join(path, "t2r_metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    edit(meta)
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def _aot_fallbacks(model_dir: str, path: str, episodes, expected) -> int:
    """(c) on copies: a bitflipped bucket file, a forged topology and a
    transplanted aot/ dir, each a typed, counted fallback whose batches
    the eager program serves within SERVE_TOL. Returns the B2 launches."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.export import ExportedModel, list_export_dirs
    from tensor2robot_tpu_torch.export import aot as aot_lib
    from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
    from tensor2robot_tpu_torch.serving import PolicyServer

    def close(got, want, label):
        err = np.abs(got - want)
        if not np.isfinite(got).all() or (err > SERVE_TOL + SERVE_TOL * np.abs(want)).any():
            raise AssertionError(f"{label}: {err.max()} from the eager program")
        return float(err.max())

    total = 0
    big = max(BUCKETS)
    batch = {k: np.concatenate([v] * (big // len(v) + 1))[:big] for k, v in episodes.items()}
    want_big = np.concatenate([expected] * (big // len(expected) + 1))[:big]
    with tempfile.TemporaryDirectory(prefix="aot_fallbacks_") as scratch:
        # A bitflipped package: its bucket falls back, the rest serve.
        root = os.path.join(scratch, "bitflip")
        copy = _copy_version(path, root)
        target = os.path.join(copy, aot_lib.aot_relpath("none", big))
        with open(target, "r+b") as f:
            f.seek(os.path.getsize(target) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0x10]))
        predictor = ExportedSavedModelPredictor(export_dir=root, device=DEVICE)
        with _env(T2R_SERVE_AOT="1", T2R_AOT_REQUIRE=None):
            predictor.restore()
        with PolicyServer(predictor, max_wait_ms=20, default_deadline_ms=120_000) as server:
            reset_launches()
            server.start()
            loaded = predictor.loaded_model
            got = loaded.predict(batch)["action"]
            launches = read_launches()["flash_fwd"]
            snap = server.snapshot()
        predictor.close()
        if (loaded.aot_fallbacks != {big: "AOTCorrupt"}
                or snap["aot_fallbacks"] != {str(big): "AOTCorrupt"}
                or snap["counters"]["aot_misses"] != 1
                or snap["prewarm_source"][str(big)] != "compile"
                or loaded.fresh_trace_calls != 2
                or launches != NUM_LAYERS * (len(BUCKETS) + 1)):
            raise AssertionError(f"bitflip: {loaded.aot_fallbacks}, {snap}, fresh "
                                 f"{loaded.fresh_trace_calls}, B2 {launches}")
        total += launches
        flip = close(got, want_big, "bitflipped bucket")
        # A forged topology: every bucket falls back; T2R_AOT_REQUIRE raises.
        copy = _copy_version(path, os.path.join(scratch, "topology"))
        _edit_metadata(copy, lambda meta: meta["aot"]["topology"].update(
            device_name="NVIDIA A100-SXM4-80GB", compute_capability="sm_80"))
        with _env(T2R_SERVE_AOT="1", T2R_AOT_REQUIRE=None):
            loaded = ExportedModel(copy, device=DEVICE)
        if (loaded.aot_executables or loaded.aot_fallbacks
                != {b: "topology_mismatch" for b in BUCKETS}):
            raise AssertionError(f"forged topology: {loaded.aot_fallbacks}")
        reset_launches()
        topo = close(loaded.predict(batch)["action"], want_big, "forged topology")
        total += read_launches()["flash_fwd"]
        with _env(T2R_SERVE_AOT="1", T2R_AOT_REQUIRE="1"):
            try:
                ExportedModel(copy, device=DEVICE)
            except aot_lib.AOTError as err:
                if "T2R_AOT_REQUIRE" not in str(err):
                    raise
            else:
                raise AssertionError("T2R_AOT_REQUIRE=1 booted a forged topology")
        # aot/ transplanted (with its declaration) into the step-10 export.
        step10 = list_export_dirs(os.path.join(model_dir, "export", "latest"))[0]
        copy = _copy_version(step10, os.path.join(scratch, "transplant"))
        import shutil

        shutil.copytree(os.path.join(path, aot_lib.AOT_DIR),
                        os.path.join(copy, aot_lib.AOT_DIR))
        with open(os.path.join(path, "t2r_metadata.json")) as f:
            block = json.load(f)["aot"]
        _edit_metadata(copy, lambda meta: meta.update(aot=block))
        with _env(T2R_SERVE_AOT="1", T2R_AOT_REQUIRE=None):
            loaded = ExportedModel(copy, device=DEVICE)
            reset_launches()
            got = loaded.predict(batch)["action"]
            total += read_launches()["flash_fwd"]
        if (loaded.aot_executables or loaded.fresh_trace_calls != 1
                or loaded.aot_fallbacks != {b: "AOTKeyMismatch" for b in BUCKETS}):
            raise AssertionError(f"transplant: {loaded.aot_fallbacks}")
        reset_launches()
        transplant = close(got, _eager_expected(step10, "none", batch), "transplant")
        total += read_launches()["flash_fwd"]
        torch.cuda.empty_cache()
    log(f"[aot] (c) fallbacks on copies, {card_line()}: a bitflipped bucket-{big} "
        f"package AOTCorrupt, counted (aot_misses 1), its batch served by the eager "
        f"program within {flip:.3e} of the eager reference; a forged topology "
        f"(sm_80) every bucket topology_mismatch, served within {topo:.3e}, and "
        f"T2R_AOT_REQUIRE=1 raises AOTError; aot/ transplanted into the step-"
        f"{SAVE_EVERY} export every bucket AOTKeyMismatch (fingerprint), never served, "
        f"that export's eager program within {transplant:.3e}")
    return total


def _aot_store(path: str, episodes, expected) -> int:
    """(d) the export as a dense base in an ArtifactStore, booted by
    exported_policy_loader with every bucket "aot", one batch a bucket
    served within SERVE_TOL. Returns the B2 launches."""
    import numpy as np

    from tensor2robot_tpu_torch.export.artifact_store import ArtifactStore
    from tensor2robot_tpu_torch.serving.server import exported_policy_loader

    with tempfile.TemporaryDirectory(prefix="aot_store_") as scratch:
        store = ArtifactStore(os.path.join(scratch, "store"))
        t0 = time.monotonic()
        manifest = store.put(path, "bc")
        put_s = time.monotonic() - t0
        loader, catalog = exported_policy_loader(
            store.root, work_dir=os.path.join(scratch, "work"), max_wait_ms=20,
            device=DEVICE)
        with _env(T2R_SERVE_AOT="1", T2R_AOT_REQUIRE="1"):
            reset_launches()
            t0 = time.monotonic()
            server = loader("bc")
            boot_s = time.monotonic() - t0
        try:
            prewarm = read_launches()["flash_fwd"]
            worst, batches = 0.0, 0
            requests = [{k: v[i] for k, v in episodes.items()}
                        for i in range(len(expected))]
            for bucket in BUCKETS:
                before = server.snapshot()["counters"]["batches"]
                reset_launches()
                futures = [server.submit(requests[i % len(requests)])
                           for i in range(bucket)]
                for i, future in enumerate(futures):
                    action = future.result(300).outputs["action"]
                    want = expected[i % len(requests)]
                    err = np.abs(action - want)
                    if (err > SERVE_TOL + SERVE_TOL * np.abs(want)).any():
                        raise AssertionError(f"store bucket {bucket}: {err.max()}")
                    worst = max(worst, float(err.max()))
                launches = read_launches()["flash_fwd"]
                formed = server.snapshot()["counters"]["batches"] - before
                if launches != NUM_LAYERS * formed:
                    raise AssertionError(f"store bucket {bucket}: B2 {launches} for "
                                         f"{formed} batches")
                batches += formed
                prewarm += launches
            snap = server.snapshot()
        finally:
            server.stop()
        if (catalog != ["bc"] or snap["prewarm_source"] != {str(b): "aot" for b in BUCKETS}
                or manifest["payload"]["kind"] != "dense"
                or server.mem_bytes != manifest["payload"]["weights_nbytes"]):
            raise AssertionError(f"store: {catalog}, {snap}, {manifest['payload']}")
    log(f"[aot] (d) the export put into an ArtifactStore as a dense base in "
        f"{put_s:.2f}s ({manifest['export_nbytes'] / 1e6:.1f} MB in "
        f"{len(manifest['files'])} files); exported_policy_loader materialized and "
        f"booted it with T2R_AOT_REQUIRE=1 in {boot_s:.2f}s on {card_line()}: every "
        f"bucket aot; one batch a bucket ({batches} batches) within {worst:.3e} of the "
        f"eager program (limit {SERVE_TOL} abs + rel)")
    return prewarm


def phase_aot(model_dir: str) -> int:
    """AOTInductor packages (export/aot.py) of the training phase's step-20
    BC weights: (a) exported with a package per regime of AOT_REGIMES and
    f32 and per warmup bucket, built side by side; (b) booted strict (T2R_SERVE_AOT=1,
    T2R_AOT_REQUIRE=1) under PolicyServer, every bucket "aot" and no
    eager call, served within SERVE_TOL of the same export's eager
    program, B2 exactly NUM_LAYERS a batch from inside the packages, and
    the same served eagerly for its numbers; (c) fallbacks on copies; (d)
    the artifact store. Returns the B2 launches."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.export import ExportedModel, LatestExporter
    from tensor2robot_tpu_torch.export import aot as aot_lib
    from tensor2robot_tpu_torch.export.saved_model import read_metadata
    from tensor2robot_tpu_torch.specs import make_random_numpy
    from tensor2robot_tpu_torch.train.train_eval import Trainer, restore_or_init_state

    t_phase = time.monotonic()
    # (a) the export, its packages built in spawned processes.
    trainer = Trainer(full_width_model(True), device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"{model_dir} state at step {state.step}")
    reset_launches()
    t0 = time.monotonic()
    exporter = LatestExporter("aot", warmup_batch_sizes=BUCKETS, aot_executables=True,
                              serve_quant=AOT_REGIMES)
    path = exporter.maybe_export(step=TRAIN_STEPS, state=state, eval_metrics={},
                                 compiled=trainer, model_dir=model_dir)
    torch.cuda.synchronize()
    export_s = time.monotonic() - t0
    total = read_launches()["flash_fwd"]
    del state, trainer
    torch.cuda.empty_cache()
    aot = read_metadata(path)["aot"]
    regimes = ("none",) + AOT_REGIMES
    if (aot.get("errors") or aot["topology"] != aot_lib.device_topology(DEVICE)
            or aot["buckets"] != {r: list(BUCKETS) for r in regimes}):
        raise AssertionError(f"aot block {aot}")
    aot_dir = os.path.join(path, aot_lib.AOT_DIR)
    aot_mb = sum(os.path.getsize(os.path.join(aot_dir, f))
                 for f in os.listdir(aot_dir)) / 1e6
    builds = "; ".join(
        f"{regime} " + ", ".join(
            f"b{b} {ms / 1e3:.1f}s (package vs program {aot['parity'][regime][b]:.2e})"
            for b, ms in aot["compile_ms"][regime].items())
        for regime in regimes)
    log(f"[aot] (a) full-width BC (step {TRAIN_STEPS}, flash heads) exported with "
        f"AOTInductor packages on {card_line()} in {export_s:.1f}s (gates, programs "
        f"and {len(regimes) * len(BUCKETS)} package builds, at most "
        f"{max(1, (os.cpu_count() or 2) - 1)} at once; the AOT pass "
        f"{aot['wall_ms'] / 1e3:.1f}s with its loads and checks): aot block format "
        f"{aot['format_version']}, topology {aot['topology']}, buckets "
        f"{aot['buckets']}, fingerprints "
        f"{ {r: f[:12] for r, f in aot['fingerprint'].items()} }; build s per bucket "
        f"(export + compile in its process; the package's gate against its program, "
        f"limit {aot_lib.PACKAGE_PARITY_TOL} abs + rel): {builds}; aot/ {aot_mb:.1f} MB")

    # (b) strict AOT boots against the same export's eager programs.
    root = os.path.dirname(path)
    with _env(T2R_SERVE_AOT="0", T2R_AOT_REQUIRE=None):
        feature_spec = ExportedModel(path, device=DEVICE).feature_spec
    episodes = make_random_numpy(feature_spec, batch_size=DISTINCT_EPISODES, seed=13)
    episodes = dict(episodes.items())
    requests = [{k: v[i] for k, v in episodes.items()} for i in range(DISTINCT_EPISODES)]
    for regime in ("none",) + AOT_REGIMES:
        expected = _eager_expected(path, regime, episodes)
        runs = {aot_on: _aot_boot(root, regime, requests, expected, aot_on)
                for aot_on in (True, False)}
        total += sum(run["b2"] for run in runs.values())
        hit, eager = runs[True], runs[False]
        log(f"[aot] (b) {regime} on {card_line()}: strict AOT boot (T2R_SERVE_AOT=1, "
            f"T2R_AOT_REQUIRE=1) load {hit['load_s']:.2f}s, prewarm of {BUCKETS} "
            f"{hit['prewarm_s']:.2f}s, every bucket aot (aot_hits "
            f"{hit['snap']['counters']['aot_hits']}), fresh_trace_calls 0; "
            f"{hit['episodes']} episodes ({CLIENTS} clients x {AOT_EPISODES}) within "
            f"{hit['worst']:.3e} of the eager program (limit {SERVE_TOL} abs + rel), "
            f"{hit['rate']:.3f} episodes/s, client p50 {hit['p50']:.1f} ms, B2 "
            f"{hit['b2']} for {hit['batches']} batches + the prewarm; eager boot "
            f"(T2R_SERVE_AOT=0) load {eager['load_s']:.2f}s, prewarm "
            f"{eager['prewarm_s']:.2f}s, {eager['rate']:.3f} episodes/s, client p50 "
            f"{eager['p50']:.1f} ms")
        torch.cuda.empty_cache()

    # (c) fallbacks on copies, (d) the store.
    expected = _eager_expected(path, "none", episodes)
    total += _aot_fallbacks(model_dir, path, episodes, expected)
    total += _aot_store(path, episodes, expected)
    torch.cuda.empty_cache()
    log(f"[aot] phase {time.monotonic() - t_phase:.1f}s (reckoned {AOT_RECKONED_S} s)")
    return total


def _percentile_ms(values, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values) * 1e3, q))


def _timed_selects(policy, state, count):
    """Per-select wall seconds of `count` SelectAction calls (each ends
    with the copy of its action to the host, so it is synchronous)."""
    times = []
    for _ in range(count):
        t0 = time.perf_counter()
        policy.SelectAction(state)
        times.append(time.perf_counter() - t0)
    return times


def _synced_ms(fn, iters: int = 20) -> float:
    """Mean host ms of `fn` over `iters` calls after two warm-up calls,
    the card synchronized around them."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _population_batch(state, action, leaves, population):
    """One state with `action` repeated over the exported population."""
    import numpy as np

    batch = {key: np.asarray(value)[None] for key, value in state.items()}
    offset = 0
    for key, size in leaves:
        part = np.asarray(action, np.float32)[offset:offset + size]
        batch[key] = np.repeat(part[None, None], population, axis=1)
        offset += size
    return batch


def _close(got, want, tol) -> float:
    """max |got - want|; raises unless within tol abs + rel."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    if not np.all(np.isfinite(got)) or np.any(err > tol + tol * np.abs(want)):
        raise AssertionError(f"{got} vs {want}: |err| {err.max()} over {tol} abs + rel")
    return float(err.max())


def scaled_params(params, seed: int = 0) -> dict:
    """Seeded weights of a trained critic's scale in the layout of the
    state dict `params`: kernels normal * sqrt(2 / fan in), biases and
    batch-norm means normal * 0.05, batch-norm scales 1 + normal * 0.1,
    variances uniform in [0.5, 1.5]. The package's init (std 0.01 kernels,
    zero biases), and a 20-step EMA of it, leave the critic's Q at ~1e-6
    and flat in the action, where no tolerance means anything."""
    import torch

    generator = torch.Generator().manual_seed(seed)
    out = {}
    for key, value in params.items():
        value = value.detach().cpu()
        if not value.is_floating_point():
            out[key] = value
            continue
        normal = torch.randn(value.shape, generator=generator)
        if key.endswith(".weight") and value.ndim >= 2:
            out[key] = normal * math.sqrt(2.0 / value[0].numel())
        elif key.endswith(".weight"):
            out[key] = 1.0 + 0.1 * normal
        elif key.endswith(".var"):
            out[key] = 0.5 + torch.rand(value.shape, generator=generator)
        else:
            out[key] = 0.05 * normal
    return out


def _eager_select(policy, state):
    """The policy's loop run eagerly (no graph) on its own buffers and on
    the noise its next select draws after `policy.seed()`: the features
    loaded, the noise drawn, the loop run, the best copied out."""
    import torch

    from tensor2robot_tpu_torch.ops import cem as cem_ops

    policy._load_features(state)
    noise = policy._noise
    generator = torch.Generator(device=noise.device).manual_seed(policy._noise_seed)
    cem_ops.draw_noise(generator, noise.shape[0], noise.shape[1], noise.shape[2:],
                       out=noise)
    best, best_q = policy._run_loop(policy._source)
    return best.cpu().numpy(), float(best_q)


def _check_select(policy, predictor, state, population) -> dict:
    """One select through the graph against the same loop run eagerly on
    the same noise, its best Q against its action re-scored through
    predict, and the Q range of the select's first population (the scale
    the POLICY_TOL checks are to be read against)."""
    import numpy as np
    import torch

    policy.seed(0)
    action, q = policy.SelectAction(state), policy.last_q
    eager_action, eager_q = _eager_select(policy, state)
    leaves = policy._resolve_action_leaves()
    rescored = predictor.predict(_population_batch(state, action, leaves,
                                                   population))["q_predicted"]
    first = torch.clamp(policy._noise[0], policy._low, policy._high)
    first_q = policy._objective(policy._source, leaves)(first).cpu().numpy()
    if np.any(np.abs(action) > 1.0) or action.shape != (CEM["action_size"],):
        raise AssertionError(f"action {action} outside the box")
    return dict(action=action, q=q,
                d_action=_close(eager_action, action, POLICY_TOL),
                d_q=_close(eager_q, q, POLICY_TOL),
                d_rescore=_close(np.asarray(rescored).reshape(-1)[0], q, POLICY_TOL),
                first_max=float(first_q.max()), spread=float(np.ptp(first_q)))


def policy_critic_cem(model_dir: str) -> None:
    """JitCEMPolicy over the full-width critic's export: one CUDA graph
    replay per select, against the eager loop and the numpy engine, the
    64-state raw predict, an int8 export and a version change."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.export import Exporter
    from tensor2robot_tpu_torch.policies import CEMPolicy, JitCEMPolicy, split_action
    from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
    )
    from tensor2robot_tpu_torch.specs import make_random_numpy
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.train_eval import Trainer, restore_or_init_state

    graph = torch.device(DEVICE).type == "cuda"
    critic_dir = os.path.join(model_dir, "critic")
    trained = state_lib.latest_checkpoint_step(critic_dir) is not None
    weights_dir = critic_dir if trained else os.path.join(model_dir, "policy_critic")
    population = CEM["cem_samples"]
    exports = {}
    t0 = time.monotonic()
    for name, batch, quantize in (("cem", population, False), ("raw", None, False),
                                  ("cem_int8", population, True)):
        model = Critic(batch_size=CRITIC_BATCH, action_batch_size=batch, **CRITIC)
        trainer = Trainer(model, device=DEVICE)
        state = restore_or_init_state(weights_dir, trainer,
                                      torch.Generator().manual_seed(0))
        step = state.step
        exports[name] = (Exporter(name, quantize_weights=quantize), state, trainer)
        exports[name][0].maybe_export(step=step, state=state, eval_metrics={},
                                      compiled=trainer, model_dir=model_dir)
    export_s = time.monotonic() - t0
    weights = (f"the critic phase's EMA of step {step}" if trained
               else "seed 0 (no critic phase)")

    def restored(name):
        predictor = ExportedSavedModelPredictor(
            os.path.join(model_dir, "export", name), timeout=0, device=DEVICE)
        if not predictor.restore():
            raise AssertionError(f"no {name} export")
        return predictor

    reset_launches()
    predictor = restored("cem")
    spec = predictor.get_feature_specification()
    state = {k: v[0] for k, v in make_random_numpy(spec, batch_size=1, seed=0).items()
             if k.startswith("state")}
    policy = JitCEMPolicy(predictor, **CEM)
    t0 = time.monotonic()
    policy.SelectAction(state)
    build_s = time.monotonic() - t0
    replays = policy.graph_replays
    times = _timed_selects(policy, state, POLICY_SELECTS)
    ran = policy.graph_replays - replays if graph else policy.eager_selects - 1
    if ran != POLICY_SELECTS or (graph and policy.graph_builds != 1):
        raise AssertionError(f"{ran} graph replays for {POLICY_SELECTS} selects, "
                             f"{policy.graph_builds} builds")
    # The same select on the same noise, through the graph and eagerly.
    check = _check_select(policy, predictor, state, population)
    eager_times = []
    for _ in range(POLICY_EAGER_SELECTS):
        t0 = time.perf_counter()
        _eager_select(policy, state)
        eager_times.append(time.perf_counter() - t0)
    leaves = policy._resolve_action_leaves()
    numpy_policy = CEMPolicy(predictor, **CEM)
    numpy_times = _timed_selects(numpy_policy, state, POLICY_NUMPY_SELECTS)
    hz = lambda ts: len(ts) / sum(ts)  # noqa: E731
    log(f"[policy] critic {CRITIC['image_size']} (num_convs {CRITIC['num_convs']}) "
        f"with {weights}, exported x3 in {export_s:.2f}s; JitCEMPolicy(action_size "
        f"{CEM['action_size']}, {population} samples, {CEM['cem_iterations']} "
        f"iterations) on {card_line()}: first select (warm-up + capture) "
        f"{build_s:.2f}s; {hz(times):.3f} selects/s over {POLICY_SELECTS}, p50 "
        f"{_percentile_ms(times, 50):.3f} ms, p90 {_percentile_ms(times, 90):.3f} ms; "
        f"graph replays {ran} = selects, builds {policy.graph_builds}")
    log(f"[policy] eager loop (same loop, no graph) {hz(eager_times):.3f} selects/s "
        f"over {POLICY_EAGER_SELECTS}, p50 {_percentile_ms(eager_times, 50):.3f} ms; "
        f"on the same noise max|d best action| {check['d_action']:.3e}, |d best Q| "
        f"{check['d_q']:.3e} vs the graph; graph best Q {check['q']:.6e} re-scored "
        f"through predict: |d| {check['d_rescore']:.3e} (limit {POLICY_TOL} abs + "
        f"rel); Q range of the first population {check['spread']:.3e}")
    log(f"[policy] CEMPolicy (numpy engine, {CEM['cem_iterations']} predictor round "
        f"trips) {hz(numpy_times):.3f} selects/s over {POLICY_NUMPY_SELECTS}, p50 "
        f"{_percentile_ms(numpy_times, 50):.3f} ms")
    MEASURED["jit_cem_selects_per_s"] = hz(times)

    raw = restored("raw")
    features = make_random_numpy(raw.get_feature_specification(), batch_size=population,
                                 seed=0)
    raw.predict(features)
    windows = []
    for _ in range(PREDICT_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(PREDICT_WINDOW):
            out = raw.predict(features)
        windows.append(PREDICT_WINDOW / (time.perf_counter() - t0))
    q = np.asarray(out["q_predicted"])
    if q.shape[0] != population or not np.all(np.isfinite(q)):
        raise AssertionError(f"raw predict q {q.shape}")
    # What the graph re-runs: each iteration's critic call repeats the
    # state tower, which the untiled export at one state approximates
    # (its head scores one action).
    one = {key: torch.from_numpy(np.asarray(value)[:1]).to(DEVICE)
           for key, value in features.items()}
    call_ms = _synced_ms(lambda: predictor.loaded_model.traced_predict(
        {**policy._inputs, **{key: part[None] for key, part in
                              split_action(policy._noise[0], leaves).items()}}))
    tower_ms = _synced_ms(lambda: raw.loaded_model.traced_predict(one))
    log(f"[policy] {population}-state predict of the untiled critic export on "
        f"{card_line()}: median {float(np.median(windows)):.3f} calls/s over "
        f"{PREDICT_WINDOWS} windows of {PREDICT_WINDOW} (best {max(windows):.3f}); "
        f"one critic call at population {population} {call_ms:.3f} ms, the untiled "
        f"export at one state (~ the state tower each CEM iteration re-runs) "
        f"{tower_ms:.3f} ms")

    int8 = restored("cem_int8")
    int8_policy = JitCEMPolicy(int8, **CEM)
    actions = [int8_policy.SelectAction(state) for _ in range(5)]
    int8_ran = int8_policy.graph_replays if graph else int8_policy.eager_selects
    if int8_ran != 5 or np.any(np.abs(actions) > 1.0) or not np.all(np.isfinite(actions)):
        raise AssertionError(f"int8: {int8_ran} replays for 5 selects, {actions}")
    if not int8.loaded_model.metadata.get("weights_int8"):
        raise AssertionError("the int8 export is not quantized")

    # A second version lands, with weights of a trained critic's scale;
    # the next select rebuilds the graph once, and the graph, the eager
    # loop and predict are held to each other where Q varies with the
    # action.
    exporter, state_cem, trainer = exports["cem"]
    scaled = trainer.init_state(params=scaled_params(state_cem.network.state_dict()))
    exporter.maybe_export(step=state_cem.step + 1, state=scaled, eval_metrics={},
                          compiled=trainer, model_dir=model_dir)
    first = predictor.loaded_model
    if not predictor.restore() or predictor.loaded_model is first:
        raise AssertionError("the second export version was not restored")
    builds, replays = policy.graph_builds, policy.graph_replays
    for _ in range(3):
        policy.SelectAction(state)
    if graph and (policy.graph_builds != builds + 1 or policy.graph_replays != replays + 3):
        raise AssertionError(f"after the version change: builds {policy.graph_builds}, "
                             f"replays {policy.graph_replays - replays}")
    second = _check_select(policy, predictor, state, population)
    if not np.isfinite(second["spread"]) or second["spread"] <= 1e3 * POLICY_TOL * (
            1.0 + abs(second["first_max"])):
        raise AssertionError(f"second version: Q range {second['spread']} of the "
                             f"first population is within reach of the tolerance")
    if second["q"] < second["first_max"] - POLICY_TOL * (1.0 + abs(second["first_max"])):
        raise AssertionError(f"best Q {second['q']} below the first population's "
                             f"{second['first_max']}")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the policy phase launched flash kernels: {launches}")
    log(f"[policy] int8 export under JitCEMPolicy: 5 selects, {int8_ran} graph "
        f"replays, actions in [-1, 1]; after restore() of a second export version "
        f"the graph was rebuilt {policy.graph_builds - builds} time(s) and 3 more "
        f"selects replayed it; flash launches {launches}")
    log(f"[policy] second version (seeded weights of a trained critic's scale): Q "
        f"range of the first population {second['spread']:.6e} (max "
        f"{second['first_max']:.6e}), best Q {second['q']:.6e}; graph vs eager on "
        f"the same noise max|d best action| {second['d_action']:.3e}, |d best Q| "
        f"{second['d_q']:.3e}; re-scored through predict |d| "
        f"{second['d_rescore']:.3e} (limit {POLICY_TOL} abs + rel)")


def policy_pose_loop(model_dir: str) -> None:
    """The PoseToyEnv loop through the port's entry points: random
    collect into TFRecords, train_eval_model with the latest exporter,
    one collect_eval_loop cycle of a RegressionPolicy over the export, and
    JitCEMPolicy over a PoseEnvContinuousMCModel export."""
    import glob

    import numpy as np
    import torch

    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.export import LatestExporter
    from tensor2robot_tpu_torch.policies import JitCEMPolicy, RegressionPolicy
    from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
    from tensor2robot_tpu_torch.research import pose_env
    from tensor2robot_tpu_torch.research.run_env import run_env
    from tensor2robot_tpu_torch.train.train_eval import Trainer, train_eval_model
    from tensor2robot_tpu_torch.utils.continuous_collect_eval import collect_eval_loop
    from tensor2robot_tpu_torch.utils.writer import TFRecordReplayWriter

    graph = torch.device(DEVICE).type == "cuda"
    root = os.path.join(model_dir, "pose")
    t0 = time.monotonic()
    random_rewards = run_env(
        pose_env.PoseToyEnv(seed=1), pose_env.PoseEnvRandomPolicy(seed=2),
        num_episodes=POSE_COLLECT,
        episode_to_transitions_fn=functools.partial(
            pose_env.episode_to_transitions_pose_toy, binary_success_threshold=-1.5),
        replay_writer=TFRecordReplayWriter(), output_dir=os.path.join(root, "collect"))
    collect_s = time.monotonic() - t0
    records = glob.glob(os.path.join(root, "collect", "*.tfrecord"))
    train_dir = os.path.join(root, "train")
    t0 = time.monotonic()
    train_eval_model(
        pose_env.PoseEnvRegressionModel(device_type="gpu"),
        DefaultRecordInputGenerator(file_patterns=records, batch_size=POSE_BATCH, seed=0),
        model_dir=train_dir, max_train_steps=POSE_TRAIN_STEPS,
        save_checkpoints_steps=POSE_TRAIN_STEPS, eval_steps=None,
        create_exporters_fn=lambda model: [LatestExporter("latest")], device=DEVICE)
    train_s = time.monotonic() - t0
    predictor = ExportedSavedModelPredictor(
        os.path.join(train_dir, "export", "latest"), timeout=0, device=DEVICE)
    policy = RegressionPolicy(predictor)
    eval_rewards, seen = [], []

    def run_agent_fn(env, policy, num_episodes, output_dir, global_step):
        seen.append(global_step)
        eval_rewards.extend(run_env(env, policy, num_episodes=num_episodes))

    t0 = time.monotonic()
    final = collect_eval_loop(
        root_dir=os.path.join(root, "robot"), policy=policy, run_agent_fn=run_agent_fn,
        eval_env=pose_env.PoseToyEnv(seed=9), num_eval=POSE_EVAL,
        max_steps=POSE_TRAIN_STEPS, idle_sleep_secs=0.0, max_cycles=1)
    eval_s = time.monotonic() - t0
    export_step = predictor.loaded_model.global_step
    if not (final == seen[0] == policy.global_step == export_step == POSE_TRAIN_STEPS):
        raise AssertionError(f"loop step {final}, run at {seen}, policy "
                             f"{policy.global_step}, export {export_step}")
    if len(eval_rewards) != POSE_EVAL or not np.all(np.isfinite(eval_rewards)):
        raise AssertionError(f"eval rewards {eval_rewards}")

    critic = pose_env.PoseEnvContinuousMCModel(action_batch_size=CEM["cem_samples"])
    trainer = Trainer(critic, device=DEVICE)
    LatestExporter("mc").maybe_export(
        step=0, state=trainer.init_state(torch.Generator().manual_seed(0)),
        eval_metrics={}, compiled=trainer, model_dir=root)
    mc = ExportedSavedModelPredictor(os.path.join(root, "export", "mc"), timeout=0,
                                     device=DEVICE)
    mc.restore()
    cem = JitCEMPolicy(mc, action_size=2, cem_samples=CEM["cem_samples"],
                       cem_iterations=CEM["cem_iterations"], seed=0,
                       pack_fn=lambda state, context, timestep: {"state/image": state})
    actions = []

    class _Recorded:
        def sample_action(self, obs, explore_prob):
            action, debug = cem.sample_action(obs, explore_prob)
            actions.append(action)
            return action, debug

    t0 = time.monotonic()
    cem_rewards = run_env(pose_env.PoseToyEnv(seed=11), _Recorded(),
                          num_episodes=POSE_CEM_EPISODES)
    cem_s = time.monotonic() - t0
    ran = cem.graph_replays if graph else cem.eager_selects
    if (ran != POSE_CEM_EPISODES or np.any(np.abs(actions) > 1.0)
            or not np.all(np.isfinite(cem_rewards))):
        raise AssertionError(f"pose CEM: {ran} replays, actions {actions}")
    # One more select's best Q against its action re-scored by predict.
    obs = pose_env.PoseToyEnv(seed=12).reset()
    action = cem.SelectAction(obs)
    rescored = mc.predict(_population_batch(
        {"state/image": obs}, action, [("action/pose", 2)],
        CEM["cem_samples"]))["q_predicted"]
    d_rescore = _close(np.asarray(rescored).reshape(-1)[0], cem.last_q, POLICY_TOL)
    log(f"[policy] PoseToyEnv on {card_line()}: {POSE_COLLECT} random episodes "
        f"collected in {collect_s:.2f}s ({POSE_COLLECT / collect_s:.1f} episodes/s, "
        f"{len(records)} shard); PoseEnvRegressionModel {POSE_TRAIN_STEPS} steps of "
        f"batch {POSE_BATCH} from the records + latest export in {train_s:.2f}s; "
        f"collect_eval_loop: {POSE_EVAL} eval episodes of RegressionPolicy at "
        f"global_step {policy.global_step} (export step {export_step}) in "
        f"{eval_s:.2f}s ({POSE_EVAL / eval_s:.1f} episodes/s), mean reward "
        f"{np.mean(eval_rewards):.4f} beside the random policy's "
        f"{np.mean(random_rewards):.4f}; JitCEMPolicy over the "
        f"PoseEnvContinuousMCModel export (seed-0 weights): {POSE_CEM_EPISODES} "
        f"episodes in {cem_s:.2f}s, {ran} graph replays, mean reward "
        f"{np.mean(cem_rewards):.4f}; its best Q {cem.last_q:.6e} re-scored through "
        f"predict: |d| {d_rescore:.3e} (limit {POLICY_TOL} abs + rel)")


def phase_policy(model_dir: str) -> None:
    import torch

    policy_critic_cem(model_dir)
    torch.cuda.empty_cache()
    policy_pose_loop(model_dir)


def camera_like_frames(n: int, height: int, width: int, seed: int):
    """Seeded robot-camera-like uint8 frames (bench.py's recipe with torch's
    bilinear resize in place of PIL's): a smooth low-frequency background,
    3-7 flat object rectangles and sensor noise (sigma 4). Real grasping
    frames are spatially coherent, so their JPEGs are 40-150 KB at q95 for
    512x640, not the ~385 KB of uniform noise."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    frames = np.empty((n, height, width, 3), np.uint8)
    for i in range(n):
        small = rng.randint(0, 256, (height // 16, width // 16, 3))
        base = torch.nn.functional.interpolate(
            torch.from_numpy(small.astype(np.float32)).permute(2, 0, 1)[None],
            size=(height, width), mode="bilinear", align_corners=False,
        )[0].permute(1, 2, 0).numpy().copy()
        for _ in range(rng.randint(3, 8)):
            h = rng.randint(height // 16, height // 3)
            w = rng.randint(width // 16, width // 3)
            y = rng.randint(0, height - h)
            x = rng.randint(0, width - w)
            base[y : y + h, x : x + w] = rng.randint(0, 256, 3)
        base += rng.normal(0.0, 4.0, base.shape)
        frames[i] = np.clip(base, 0, 255).astype(np.uint8)
    return frames


def roundtrip_error(frames, decoded):
    """(mean, max) absolute error of decoded frames against their sources."""
    import numpy as np

    diff = np.abs(decoded.astype(np.int16) - frames.astype(np.int16))
    return float(diff.mean()), int(diff.max())


def write_records(model, directory: str, counts, image_hw, seed: int = 0,
                  image_format: str = "jpeg"):
    """Records of a model's in-spec (train): every JPEG feature (the
    critic's state/image, Grasp2Vec's three images) a q95 JPEG (or, with
    image_format "png", a PNG, which the decoder tells by its signature)
    of camera_like_frames at `image_hw`, every other feature and the label
    drawn from the spec with the seed. counts = (train records, train
    shards, eval records). Returns ({"train": pattern, "eval": pattern},
    the first shard's (frames, records, encoded images) of the first image
    feature, seconds to write)."""
    from tensor2robot_tpu_torch.data import codec, tfrecord
    from tensor2robot_tpu_torch.data.encoder import encode_example
    from tensor2robot_tpu_torch.specs import TensorSpecStruct, make_random_numpy

    train_records, shards, eval_records = counts
    spec = TensorSpecStruct()
    for key, value in model.preprocessor.get_in_feature_specification("train").items():
        spec[f"features/{key}"] = value
    for key, value in model.preprocessor.get_in_label_specification("train").items():
        spec[f"labels/{key}"] = value
    jpeg_keys = [key for key, value in spec.items() if value.data_format == "jpeg"]
    os.makedirs(directory, exist_ok=True)
    t0 = time.monotonic()
    sample = None
    layout = [("train", s, train_records // shards) for s in range(shards)]
    layout.append(("eval", 0, eval_records))
    for index, (split, shard, n) in enumerate(layout):
        part_seed = seed + 1000 * index
        values = make_random_numpy(spec, batch_size=n, seed=part_seed)
        images = {}
        for k, key in enumerate(jpeg_keys):
            frames = camera_like_frames(n, *image_hw, seed=part_seed + 17 * k)
            images[key] = (frames, [codec.encode_jpeg(f, quality=95) if image_format == "jpeg"
                                    else codec.encode_image(f, image_format)
                                    for f in frames])
        records = []
        for i in range(n):
            row = {key: value[i] for key, value in values.items()}
            row.update({key: jpegs[i] for key, (_, jpegs) in images.items()})
            records.append(encode_example(spec, row))
        if sample is None:
            frames, jpegs = images[jpeg_keys[0]]
            sample = (frames, records, jpegs)
        total = shards if split == "train" else 1
        tfrecord.write_tfrecords(
            os.path.join(directory, f"{split}-{shard:05d}-of-{total:05d}.tfrecord"),
            records)
    patterns = {split: os.path.join(directory, f"{split}-*.tfrecord")
                for split in ("train", "eval")}
    return patterns, sample, time.monotonic() - t0


def codec_roundtrip():
    """(mean, max) absolute error of this host's codec's q95 round trip of
    the first ROUNDTRIP_FRAMES seeded 512x640 frames."""
    import numpy as np

    from tensor2robot_tpu_torch.data import codec

    frames = camera_like_frames(ROUNDTRIP_FRAMES, 512, 640, seed=0)
    decoded = np.empty_like(frames)
    for frame, out in zip(frames, decoded):
        codec.decode_into(codec.encode_jpeg(frame, quality=95), out)
    return roundtrip_error(frames, decoded)


def check_data_path(model, patterns, sample) -> str:
    """The card-side self-checks of the data stack; raises on any
    difference. FastSpecParser equals SpecParser bit for bit (golden
    record, a train batch with and without ROI, the eval shard); a ROI
    decode equals the full decode's crop; records written and read back
    are the same bytes with every CRC (native and plain) holding; the
    codec's round trip of the seeded frames stays within ROUNDTRIP."""
    import numpy as np

    from tensor2robot_tpu_torch.data import codec, tfrecord
    from tensor2robot_tpu_torch.data.parser import SpecParser
    from tensor2robot_tpu_torch.data.roi import DecodeROI, resolve_decode_rois
    from tensor2robot_tpu_torch.data.wire import FastSpecParser
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom,
    )

    def combined(critic):
        spec = {}
        for key, value in critic.preprocessor.get_in_feature_specification("train").items():
            spec[f"features/{key}"] = value
        for key, value in critic.preprocessor.get_in_label_specification("train").items():
            spec[f"labels/{key}"] = value
        return spec

    def same(fast, oracle, what):
        if set(fast) != set(oracle):
            raise AssertionError(f"{what}: keys differ")
        for key in oracle:
            a, b = np.asarray(fast[key]), np.asarray(oracle[key])
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"{what}: FastSpecParser differs from "
                                     f"SpecParser at {key}")

    golden_model = Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
        image_size=(96, 96), num_convs=(2, 2, 1))
    golden = list(tfrecord.read_tfrecords(GOLDEN_RECORDS))
    spec = combined(golden_model)
    same(FastSpecParser(spec).parse_batch(golden),
         SpecParser(spec).parse_batch(golden), "golden record")
    spec = combined(model)
    fast, oracle = FastSpecParser(spec), SpecParser(spec)
    frames, records, jpegs = sample
    batch = records[:16]
    same(fast.parse_batch(batch), oracle.parse_batch(batch), "train records")
    th, tw = model.preprocessor._target_shape()
    rng = np.random.default_rng(0)
    for mode in ("random", "center"):
        roi = resolve_decode_rois({"features/state/image": DecodeROI(th, tw, mode)},
                                  spec, len(batch), rng)
        same(fast.parse_batch(batch, roi=roi), oracle.parse_batch(batch, roi=roi),
             f"train records, {mode} ROI")
    eval_records = list(tfrecord.read_tfrecords(tfrecord.list_files(patterns["eval"])[0]))
    same(fast.parse_batch(eval_records), oracle.parse_batch(eval_records), "eval shard")
    # ROI decode == full decode + crop, at window edges and sub-MCU offsets.
    h, w = frames.shape[1:3]
    full = np.empty(frames.shape[1:], np.uint8)
    windows = 0
    for data in jpegs[:8]:
        codec.decode_into(data, full)
        for y, x in ((0, 0), (h - th, w - tw), (17, 23), (h - th - 3, 9)):
            out = np.empty((th, tw, 3), np.uint8)
            codec.decode_roi_into(data, out, y, x, (h, w))
            if not np.array_equal(out, full[y : y + th, x : x + tw]):
                raise AssertionError(f"ROI decode at ({y}, {x}) differs from the crop")
            windows += 1
    # TFRecord write then read: the same bytes, every CRC holds.
    path = os.path.join(os.path.dirname(tfrecord.list_files(patterns["eval"])[0]),
                        "roundtrip.tfrecord")
    tfrecord.write_tfrecords(path, records)
    back = list(tfrecord.read_tfrecords(path, verify_crc=True))
    with open(path, "rb") as f:
        raw = f.read()
    offsets, lengths = tfrecord.index_tfrecord_buffer(raw, verify_crc=True)
    if back != records or len(offsets) != len(records):
        raise AssertionError("TFRecord write/read changed the records")
    for record in records[:2]:
        if tfrecord.masked_crc32c(record) != tfrecord.masked_crc32c_plain(record):
            raise AssertionError("native CRC32-C differs from the plain version")
    # The codec's round trip of the seeded full-size frames.
    mean, worst = codec_roundtrip()
    bound = ROUNDTRIP[codec.codec_name()]
    if not (mean <= bound[0] and worst <= bound[1]):
        raise AssertionError(
            f"{codec.codec_name()} round trip mean {mean:.4f} max {worst} "
            f"exceeds {bound}")
    return (f"FastSpecParser == SpecParser bit for bit (golden record, 16 "
            f"train records full / random ROI / center ROI, {len(eval_records)} "
            f"eval records); {windows} ROI windows == full decode + crop; "
            f"{len(records)} records written and read back with every CRC; "
            f"{codec.codec_name()} q95 round trip of {ROUNDTRIP_FRAMES} frames: "
            f"mean abs err {mean:.4f}, max {worst} (bound {bound[0]}, {bound[1]})")


def time_codec(jpegs, source_hw, target_hw) -> str:
    """One thread's time per image of the codec alone over `jpegs`: a full
    decode and a decode of a random target_hw window (seed 0), into
    pinned buffers where a card is visible."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.data import codec

    def buffer(shape):
        out = torch.empty(shape, dtype=torch.uint8,
                          pin_memory=torch.cuda.is_available())
        return out.numpy()

    full = buffer(tuple(source_hw) + (3,))
    window = buffer(tuple(target_hw) + (3,))
    rng = np.random.default_rng(0)
    offsets = [(int(rng.integers(0, source_hw[0] - target_hw[0] + 1)),
                int(rng.integers(0, source_hw[1] - target_hw[1] + 1)))
               for _ in jpegs]
    codec.decode_into(jpegs[0], full)  # warm-up
    t0 = time.perf_counter()
    for data in jpegs:
        codec.decode_into(data, full)
    t1 = time.perf_counter()
    for data, (y, x) in zip(jpegs, offsets):
        codec.decode_roi_into(data, window, y, x, source_hw)
    t2 = time.perf_counter()
    return (f"{(t1 - t0) / len(jpegs) * 1e3:.3f} ms a full decode, "
            f"{(t2 - t1) / len(jpegs) * 1e3:.3f} ms a {target_hw[0]}x"
            f"{target_hw[1]} ROI decode (one thread, {len(jpegs)} JPEGs)")


def time_data_stack(model, patterns) -> list:
    """Records/s of RecordDataset alone over the train shards at
    CRITIC_BATCH, for each backend with ROI on and off, decode cache off;
    one warm-up batch (which starts the workers) is not timed."""
    import numpy as np

    from tensor2robot_tpu_torch.data.dataset import RecordDataset
    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRecordInputGenerator,
    )

    generator = DefaultRecordInputGenerator(file_patterns=patterns["train"],
                                            batch_size=CRITIC_BATCH, seed=0)
    generator.set_specification_from_model(model, "train")
    rows = []
    saved = os.environ.get("T2R_DECODE_CACHE_MB")
    os.environ["T2R_DECODE_CACHE_MB"] = "0"
    try:
        for backend in ("thread", "process"):
            for roi in (True, False):
                dataset = RecordDataset(
                    generator.combined_spec(), patterns["train"], CRITIC_BATCH,
                    mode="train", seed=0, parse_backend=backend,
                    decode_roi=generator.decode_rois("train") if roi else None)
                it = iter(dataset)
                next(it)
                t0 = time.perf_counter()
                nbytes = 0
                for _ in range(DATA_BATCHES):
                    batch = next(it)
                    nbytes += sum(np.asarray(v).nbytes for v in batch.values())
                seconds = time.perf_counter() - t0
                del it, batch
                dataset.close()
                records = DATA_BATCHES * CRITIC_BATCH / seconds
                image = tuple(generator.combined_spec()["features/state/image"].shape)
                shape = (model.preprocessor._target_shape() if roi else image[:2])
                rows.append((backend, roi, records))
                log(f"[data] {backend} backend, ROI {'on' if roi else 'off'} "
                    f"({shape[0]}x{shape[1]} images), batch {CRITIC_BATCH}, "
                    f"{dataset._num_parse_workers} workers, decode cache off, on "
                    f"{card_line()}: {records:.1f} records/s = {records:.1f} "
                    f"images/s, {nbytes / seconds / 1e6:.1f} host MB/s of "
                    f"parsed batches ({DATA_BATCHES} batches in {seconds:.3f} s)")
    finally:
        if saved is None:
            os.environ.pop("T2R_DECODE_CACHE_MB", None)
        else:
            os.environ["T2R_DECODE_CACHE_MB"] = saved
    return rows


def time_fed_steps(model_dir: str, model, patterns) -> dict:
    """Train steps fed from records: each step's wall from asking the
    infeed for the batch to the step's end (synchronized), its median over
    TIMED_STEPS, and the card's busy share over a profiled window of fed
    steps."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRecordInputGenerator,
    )
    from tensor2robot_tpu_torch.train import infeed
    from tensor2robot_tpu_torch.train.train_eval import Trainer, restore_or_init_state

    trainer = Trainer(model, device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    generator = DefaultRecordInputGenerator(file_patterns=patterns["train"],
                                            batch_size=CRITIC_BATCH, seed=1)
    generator.set_specification_from_model(model, "train")
    dataset = generator.create_record_dataset("train")
    fed = infeed.device_prefetch(iter(dataset), DEVICE, depth=infeed.resolve_depth())
    for _ in range(3):
        trainer.train_step(state, next(fed))
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(state, next(fed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    median = sorted(times)[len(times) // 2]
    share = device_profile(
        f"{PROFILED_FED_STEPS} critic train steps fed from records",
        lambda: [trainer.train_step(state, next(fed))
                 for _ in range(PROFILED_FED_STEPS)], rows=8)
    # On the card the images were parsed into pinned buffers, which the
    # infeed copies as they are.
    pinned = len(dataset._ring) if dataset._ring is not None else 0
    if torch.cuda.is_available() and not pinned:
        raise AssertionError("the fed steps' images came through no pinned buffer")
    return {"median": median, "min": min(times), "max": max(times), "busy": share,
            "pinned": pinned}


def phase_data(model_dir: str) -> None:
    """Builds the data stack, writes full-width JPEG records, checks the
    parsers and the codec on the card, times RecordDataset alone, then
    trains the critic from the records."""
    import torch

    from tensor2robot_tpu_torch.data import codec, native, tfrecord
    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRecordInputGenerator,
    )
    from tensor2robot_tpu_torch.data.wire import reset_decode_cache
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.metrics import read_metrics
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    t0 = time.monotonic()
    tfrecord.masked_crc32c(b"")
    name = codec.codec_name()
    log(f"[build] data: JPEG codec {name} ({native.codec_build()[1]}), "
        f"tfrecord_io.cc, with g++ into build/native/ in "
        f"{time.monotonic() - t0:.1f}s")
    model = critic_model()
    source = model.preprocessor.get_in_feature_specification("train")["state/image"]
    patterns, sample, seconds = write_records(
        model, os.path.join(model_dir, "records"), DATA_RECORDS, source.shape[:2])
    sizes = [len(r) for r in sample[2]]
    log(f"[data] wrote {DATA_RECORDS[0]} train records in {DATA_RECORDS[1]} "
        f"shards and {DATA_RECORDS[2]} eval records ({source.shape[0]}x"
        f"{source.shape[1]} q95 JPEG by {name}, mean JPEG "
        f"{sum(sizes) / len(sizes) / 1e3:.1f} KB) in {seconds:.1f}s")
    log(f"[data] checks on {card_line()}: {check_data_path(model, patterns, sample)}")
    log(f"[data] {name} alone on {card_line()}: "
        + time_codec(sample[2], source.shape[:2], model.preprocessor._target_shape()))
    time_data_stack(model, patterns)

    reset_decode_cache()  # the run decodes its own first epoch
    codec.COUNTS.reset()
    t0 = time.monotonic()
    final_eval = train_eval_model(
        model,
        DefaultRecordInputGenerator(file_patterns=patterns["train"],
                                    batch_size=CRITIC_BATCH, seed=0),
        DefaultRecordInputGenerator(file_patterns=patterns["eval"],
                                    batch_size=CRITIC_BATCH, seed=0),
        model_dir=model_dir, max_train_steps=TRAIN_STEPS,
        save_checkpoints_steps=SAVE_EVERY, eval_steps=CRITIC_EVAL_STEPS,
        log_every_steps=LOG_EVERY, seed=0, device=DEVICE,
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    decodes = (codec.COUNTS.decodes, codec.COUNTS.roi_decodes)
    steps = state_lib.checkpoint_steps(model_dir)
    losses = [r["loss"] for r in read_metrics(os.path.join(model_dir, "train"))]
    evals = read_metrics(os.path.join(model_dir, "eval"))
    if (steps != [SAVE_EVERY, TRAIN_STEPS] or len(losses) != TRAIN_STEPS // LOG_EVERY
            or not all(math.isfinite(x) for x in losses)
            or [r["step"] for r in evals] != [SAVE_EVERY, TRAIN_STEPS]
            or set(final_eval) != {"loss", "accuracy", "q_mean"}
            or not all(math.isfinite(v) for v in final_eval.values())):
        raise AssertionError(f"critic from records: checkpoints {steps}, losses "
                             f"{losses}, evals {evals}, final {final_eval}")
    # Every image of the run came through the native codec (or from the
    # decode cache it filled): at least one epoch of the train shards.
    if sum(decodes) < min(DATA_RECORDS[0], TRAIN_STEPS * CRITIC_BATCH):
        raise AssertionError(f"critic from records decoded {decodes} (full, ROI)")
    log(f"[data] critic from records: train_eval_model on {card_line()}: "
        f"{TRAIN_STEPS} steps of batch {CRITIC_BATCH} at "
        f"{CRITIC['image_size']} from {source.shape[0]}x{source.shape[1]} JPEG "
        f"records (random ROI in train, center ROI in eval), checkpoints "
        f"{steps}, EMA evals {[round(r['loss'], 6) for r in evals]}, in "
        f"{wall:.1f}s (records, evals and checkpoints included); losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; codec calls {decodes[0]} "
        f"full + {decodes[1]} ROI decodes")
    fed = time_fed_steps(model_dir, model, patterns)
    busy = ("not measured" if fed["busy"] is None else
            f"{100 * fed['busy'][1] / fed['busy'][0]:.1f}% of "
            f"{fed['busy'][0]:.1f} ms")
    on_card = MEASURED.get("critic_step_ms")
    log(f"[data] critic train step fed from records on {card_line()}: median "
        f"{fed['median']:.3f} ms over {TIMED_STEPS} synced steps (min "
        f"{fed['min']:.3f}, max {fed['max']:.3f}) = {1e3 / fed['median']:.3f} "
        f"steps/s; device busy {busy} over {PROFILED_FED_STEPS} fed steps; "
        f"{fed['pinned']} pinned image buffers; the critic phase's step on a "
        f"batch already on the card: "
        + (f"{on_card:.3f} ms" if on_card else "not run"))


# -- the cli phase ----------------------------------------------------------------

# The trainer's command line: the port's three binaries as child
# processes. The BC learner at full width under remat, grad-accum 2 and
# 5 steps a loop, with the six hook builders, beside a continuous-eval
# process tailing its model_dir; the regimes held in process against a
# plain step; then the JAX package's shipped pose_env configs. The pose
# trainer runs run_train_reg.gin at its own width and device_type 'tpu'
# (the bf16 wrapper), cut from 5000 to CLI_POSE["steps"] steps and from
# 100 eval batches to CLI_POSE["eval_steps"].
CLI_STEPS, CLI_SAVE_EVERY, CLI_LOOP, CLI_ACCUM = 20, 10, 5, 2
CLI_EVAL_STEPS = 2
CLI_PROFILE = dict(start_step=10, num_steps=2)
CLI_IPL_STEPS = 10
CLI_TIMED_STEPS = 5
# remat's peak memory against the plain step's, at most.
CLI_REMAT_PEAK = 0.75
# A reward-bearing bf16 step of run_train_reg.gin's model (its width,
# device_type 'tpu') against the f32 step from the same weights: the
# loss within POSE_BF16_LOSS_TOL (the bf16 gate of the port's dtype-policy
# tests), the gradient within POSE_BF16_GRAD_TOL relative L2 over all
# leaves (bf16 convs at batch 4 on the CPU read 0.09 on random data and
# 0.26 on collected data; no update reads 1, a flipped one 2), the
# update's cosine with the f32 update at least POSE_BF16_UPDATE_COS
# (Adam's first step is the learning rate times the gradient's sign, and
# bf16 flips the sign of gradients in its noise); then POSE_BF16_STEPS
# steps on the batch lower its loss.
POSE_BF16_LOSS_TOL = 0.02
POSE_BF16_GRAD_TOL = 0.5
POSE_BF16_UPDATE_COS = 0.5
POSE_BF16_STEPS = 5
POSE_ADAM = dict(lr=1e-3, beta1=0.9)
CLI_POSE = dict(collect=64, steps=40, eval_steps=1, batch=None)
CLI_TIMEOUT = 600
POSE_CONFIGS = os.path.join(ROOT, "tensor2robot_tpu", "research", "pose_env", "configs")
# The flash kernels in a CUDA trace, demangled or mangled (B1 is the
# forward body with kTile = true).
TRACE_KERNELS = {
    "flash_fwd_tile": r"flash_fwd_kernel<[^\"]*true>|flash_fwd_kernelI[^\"]*Lb1E",
    "flash_bwd_dq": r"flash_bwd_dq_kernel",
    "flash_bwd_dkv": r"flash_bwd_dkv_kernel",
}


def bc_model_kwargs(use_flash: bool = True) -> dict:
    return dict(
        action_size=7, pose_size=14, episode_length=SLICE["seq"],
        image_size=BC_WIDTH["image_size"], d_model=BC_WIDTH["d_model"],
        num_layers=NUM_LAYERS, num_heads=SLICE["heads"],
        head_dim=SLICE["head_dim"], use_flash=use_flash, device_type="gpu",
    )


def _bindings(prefix: str, values: dict) -> list:
    return [f"{prefix}.{key} = {value!r}" for key, value in values.items()]


class _Child:
    """A binary of the port as a child process, its output in a file."""

    def __init__(self, name: str, module: str, flags: list, log_dir: str):
        self.name = name
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.log")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self._file = open(self.path, "w")
        self.started = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"tensor2robot_tpu_torch.bin.{module}", *flags],
            cwd=ROOT, env=env, stdout=self._file, stderr=subprocess.STDOUT)
        self.seconds = None

    def output(self) -> str:
        with open(self.path, errors="replace") as f:
            return f.read()

    def tail(self, lines: int = 60) -> str:
        """The output's last lines, each cut to 400 characters (a torch
        error can print a line of megabytes)."""
        return "\n".join(line[:400] for line in self.output().splitlines()[-lines:])

    def wait_for(self, text: str, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while text not in self.output():
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"{self.name} never printed {text!r}:\n{self.tail()}")
            time.sleep(0.2)

    def wait(self, timeout: float = CLI_TIMEOUT) -> str:
        try:
            code = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"{self.name} ran past {timeout}s:\n{self.tail()}")
        self.seconds = time.monotonic() - self.started
        self._file.close()
        if code != 0:
            raise AssertionError(f"{self.name} exited {code}:\n{self.tail()}")
        return self.output()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._file.close()


def _run_children(children) -> None:
    try:
        for child in children:
            child.wait()
    finally:
        for child in children:
            child.stop()


def _bc_flags() -> list:
    model = {**bc_model_kwargs(True), "use_avg_model_params": True}
    return [f"--gin_bindings={b}" for b in (
        _bindings("TransformerBCModel", model)
        + _bindings("eval/DefaultRandomInputGenerator",
                    dict(batch_size=SLICE["batch"], seed=1000)))]


def cli_bc_binaries(model_dir: str) -> dict:
    """run_t2r_trainer (full-width BC, remat, grad-accum, 5 steps a loop,
    six hook builders) beside run_continuous_eval tailing it. The learner
    reads constant batches: drawing a 400 MB random batch a step on the
    host would bound it (the parity group trains on random batches)."""
    import glob
    import re

    import numpy as np

    from tensor2robot_tpu_torch.train import durability
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.metrics import read_metrics

    run_dir = os.path.join(model_dir, "bc")
    td3 = {"export_dir": os.path.join(run_dir, "td3", "latest"),
           "lagged_export_dir": os.path.join(run_dir, "td3", "lagged"),
           "save_secs": 0.0, "num_versions": 5}
    trainer_flags = _bc_flags() + [f"--gin_bindings={b}" for b in (
        ["train_eval_model.t2r_model = @TransformerBCModel()",
         "train_eval_model.input_generator_train = @train/DefaultConstantInputGenerator()",
         "train_eval_model.hook_builders = [@StepTimingHookBuilder(), "
         "@ProfilerHookBuilder(), @GoldenValuesHookBuilder(), @TD3Hooks(), "
         "@VariableLoggerHookBuilder(), @ConfigLoggerHookBuilder()]"]
        + _bindings("train/DefaultConstantInputGenerator",
                    dict(batch_size=SLICE["batch"], constant_value=0.5))
        + _bindings("train_eval_model", dict(
            model_dir=run_dir, max_train_steps=CLI_STEPS,
            save_checkpoints_steps=CLI_SAVE_EVERY, log_every_steps=CLI_LOOP,
            remat=True, grad_accum_steps=CLI_ACCUM, iterations_per_loop=CLI_LOOP,
            device=DEVICE))
        + _bindings("StepTimingHookBuilder", dict(sync_every=CLI_LOOP))
        + _bindings("ProfilerHookBuilder", CLI_PROFILE)
        + _bindings("VariableLoggerHookBuilder", dict(every_steps=CLI_SAVE_EVERY))
        + _bindings("TD3Hooks", td3))]
    eval_flags = _bc_flags() + [f"--gin_bindings={b}" for b in (
        ["continuous_eval.t2r_model = @TransformerBCModel()",
         "continuous_eval.input_generator_eval = @eval/DefaultRandomInputGenerator()",
         "continuous_eval.create_exporters_fn = @create_default_exporters"]
        + _bindings("continuous_eval", dict(
            model_dir=run_dir, eval_steps=CLI_EVAL_STEPS,
            max_train_steps=CLI_STEPS, timeout=float(CLI_TIMEOUT),
            poll_interval=0.2, device=DEVICE)))]
    os.makedirs(run_dir, exist_ok=True)
    # The eval job first: once it polls, the learner starts, so the eval
    # job sees step 10 land before the learner can reach step 20.
    evaluator = _Child("continuous_eval_bc", "run_continuous_eval", eval_flags, model_dir)
    children = [evaluator]
    try:
        evaluator.wait_for("continuous_eval: waiting", CLI_TIMEOUT)
        children.append(_Child("trainer_bc", "run_t2r_trainer", trainer_flags, model_dir))
    finally:
        _run_children(children[::-1])  # the learner first: its own time
    trainer_out = children[1].output()

    steps = state_lib.checkpoint_steps(run_dir)
    if steps != [CLI_SAVE_EVERY, CLI_STEPS]:
        raise AssertionError(f"trainer checkpoints {steps}")
    for step in steps:
        manifest = state_lib.manifest_path(run_dir, step)
        if not os.path.exists(manifest) or durability.validate(run_dir, step):
            raise AssertionError(f"step {step} has no valid durability manifest")
    operative = os.path.join(run_dir, "operative_config.gin")
    with open(operative) as f:
        if f"train_eval_model.device = {DEVICE!r}" not in f.read():
            raise AssertionError(f"{operative} does not bind device {DEVICE!r}")
    timing = [json.loads(line) for line in open(
        os.path.join(run_dir, "profiling", "step_timing.jsonl"))]
    if not timing or not all(row["steps_per_sec"] > 0 for row in timing):
        raise AssertionError(f"step_timing.jsonl rows {timing}")
    traces = glob.glob(os.path.join(run_dir, "profiling", "trace_*.json"))
    if len(traces) != 1:
        raise AssertionError(f"profiler traces {traces}")
    with open(traces[0]) as f:
        trace = f.read()
    in_trace = {name: len(re.findall(pattern, trace))
                for name, pattern in TRACE_KERNELS.items()}
    if torch_device_type() == "cuda" and not all(in_trace.values()):
        raise AssertionError(f"the profiler trace lacks a flash kernel: {in_trace}")
    if not os.path.exists(os.path.join(run_dir, "golden_values.npy")):
        raise AssertionError("no golden_values.npy")
    latest = sorted(os.listdir(td3["export_dir"]))
    lagged = sorted(os.listdir(td3["lagged_export_dir"]))
    if len(latest) < 2 or lagged[-1] != latest[-2]:
        raise AssertionError(f"TD3 latest {latest}, lagged {lagged}")
    evals = [row["step"] for row in read_metrics(os.path.join(run_dir, "eval"))]
    if evals != [CLI_SAVE_EVERY, CLI_STEPS]:
        raise AssertionError(f"continuous eval wrote steps {evals}")
    exports = []
    for path in sorted(glob.glob(os.path.join(run_dir, "export", "*", "*", "t2r_metadata.json"))):
        with open(path) as f:
            meta = json.load(f)
        exports.append((meta["exporter"], meta["global_step"], meta["program_device"]))
    if sorted(e[1] for e in exports if e[0] == "latest") != [CLI_SAVE_EVERY, CLI_STEPS]:
        raise AssertionError(f"the eval job's exports {exports}")
    if not all(str(e[2]).startswith(torch_device_type()) for e in exports):
        raise AssertionError(f"exports not traced on {DEVICE}: {exports}")
    variables = trainer_out.count("var=embed.weight ")
    if variables != CLI_STEPS // CLI_SAVE_EVERY or "Operative config" not in trainer_out:
        raise AssertionError(f"VariableLoggerHook logged {variables} times; "
                             "or ConfigLoggerHook did not log")
    hook_rate = float(np.median([row["steps_per_sec"] for row in timing]))
    log(f"[cli] trainer binary on {card_line()}: {CLI_STEPS} steps of full-width "
        f"BC (remat, grad_accum_steps {CLI_ACCUM}, iterations_per_loop {CLI_LOOP}) "
        f"in {children[1].seconds:.1f}s with start-up; checkpoints {steps} with "
        f"manifests; StepTimingHook {', '.join(f'{r['steps_per_sec']:.3f}' for r in timing)} "
        f"steps/s (median {hook_rate:.3f}); trace {os.path.basename(traces[0])} "
        f"({len(trace) / 1e6:.1f} MB) kernel events {in_trace}; TD3 latest "
        f"{latest}, lagged {lagged}; variable logs {variables}")
    log(f"[cli] continuous-eval binary: steps {evals} in {evaluator.seconds:.1f}s "
        f"with start-up; exports {exports}")
    return {"hook_steps_per_sec": hook_rate, "profile_kernels": in_trace}


def torch_device_type() -> str:
    import torch

    return torch.device(DEVICE).type


def _synced_step_ms(trainer, state, batch, steps=None) -> tuple:
    """Median synced train step ms over `steps` (CLI_TIMED_STEPS) after two
    warm-up steps, and the peak memory of those steps."""
    import torch

    for _ in range(2):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps or CLI_TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], torch.cuda.max_memory_allocated()


def cli_regime_parity(model_dir: str) -> dict:
    """One remat + grad-accum step against a plain one on one full-width
    batch (the BC gradient gate and the launches per step), 10 steps at
    iterations_per_loop 5 against 1, and each regime's synced step time."""
    import itertools

    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer, train_eval_model

    model = full_width_model(True)
    plain = Trainer(model, device=DEVICE)
    regime = Trainer(model, device=DEVICE, remat=True, grad_accum_steps=CLI_ACCUM)
    network = plain.init_state(torch.Generator().manual_seed(0)).network
    twin = plain.init_state(params=network.state_dict()).network
    generator = DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=0)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), DEVICE)
    features, labels = plain.preprocess_train(batch)
    loss, _ = plain.backward(network, features, labels)
    torch.cuda.synchronize()
    reset_launches()
    regime_loss, _ = regime.backward(twin, features, labels)
    torch.cuda.synchronize()
    launches = read_launches()
    expected = {"flash_fwd": 0, "flash_fwd_tile": 2 * NUM_LAYERS * CLI_ACCUM,
                "flash_bwd_dq": NUM_LAYERS * CLI_ACCUM,
                "flash_bwd_dkv": NUM_LAYERS * CLI_ACCUM}
    if launches != expected:
        raise AssertionError(f"remat + grad-accum step launches {launches} != {expected}")
    loss_err = abs(regime_loss.item() - loss.item()) / abs(loss.item())
    if not loss_err <= LOSS_TOL:
        raise AssertionError(f"loss {regime_loss.item()} vs plain {loss.item()}")
    worst = 0.0
    twin_params = dict(twin.named_parameters())
    for name, p in network.named_parameters():
        scale = p.grad.abs().max().item()
        err = (twin_params[name].grad - p.grad).abs().max().item()
        if not err <= GRAD_TOL * scale + 1e-7:
            raise AssertionError(f"{name}: remat + grad-accum gradient off the "
                                 f"plain one by {err} (max {scale})")
        worst = max(worst, err / max(scale, 1e-30))
    log(f"[cli] remat + grad_accum_steps {CLI_ACCUM} vs plain on {card_line()}: "
        f"loss {regime_loss.item():.7f} vs {loss.item():.7f} (rel {loss_err:.2e}); "
        f"worst gradient at {worst:.2e} of its max; launches {launches}")
    del network, twin

    class CachedBatches(DefaultRandomInputGenerator):
        """Two random batches drawn once, in turns: the same stream for
        both runs without drawing 400 MB of host data a step."""

        def _create_dataset(self, mode):
            return itertools.cycle(list(itertools.islice(
                super()._create_dataset(mode), 2)))

    # cuDNN's default conv backward sums in an order that varies from run
    # to run, and Adam scales each element by its own gradient, so two
    # runs of one regime already drift apart in the last bits; the
    # comparison of iterations_per_loop takes deterministic convs.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    for loop in (CLI_LOOP, 1):
        run_dir = os.path.join(model_dir, f"ipl{loop}")
        reset_launches()
        t0 = time.monotonic()
        train_eval_model(
            full_width_model(True),
            CachedBatches(batch_size=SLICE["batch"], seed=0),
            model_dir=run_dir, max_train_steps=CLI_IPL_STEPS,
            save_checkpoints_steps=CLI_IPL_STEPS, log_every_steps=CLI_LOOP,
            iterations_per_loop=loop, device=DEVICE)
        torch.cuda.synchronize()
        runs[loop] = (state_lib.load_checkpoint(run_dir, CLI_IPL_STEPS)["params"],
                      time.monotonic() - t0, read_launches())
        for name, count in runs[loop][2].items():
            launches[name] += count
    torch.backends.cudnn.deterministic = deterministic
    worst, equal = 0.0, True
    for name, p in runs[1][0].items():
        if not p.is_floating_point():
            continue
        other = runs[CLI_LOOP][0][name]
        equal = equal and torch.equal(p, other)
        scale = p.abs().max().item()
        err = (other - p).abs().max().item()
        if not err <= GRAD_TOL * scale + 1e-7:
            raise AssertionError(f"{name} at step {CLI_IPL_STEPS}: iterations_per_loop "
                                 f"{CLI_LOOP} off 1 by {err} (max {scale})")
        worst = max(worst, err / max(scale, 1e-30))
    log(f"[cli] {CLI_IPL_STEPS} steps at iterations_per_loop {CLI_LOOP} vs 1 "
        f"(deterministic cuDNN convs): "
        f"parameters {'bit-equal' if equal else f'worst {worst:.2e} of max'}; "
        f"{runs[CLI_LOOP][1]:.1f}s vs {runs[1][1]:.1f}s with set-up")

    timed = {}
    for name, kw in (("plain", {}), ("remat", dict(remat=True)),
                     ("grad_accum", dict(grad_accum_steps=CLI_ACCUM)),
                     ("remat+grad_accum", dict(remat=True, grad_accum_steps=CLI_ACCUM))):
        trainer = Trainer(model, device=DEVICE, **kw)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        timed[name] = _synced_step_ms(trainer, state, batch)
        del state
        torch.cuda.empty_cache()
    log(f"[cli] synced train step (batch {SLICE['batch']}, on-device batch, median "
        f"of {CLI_TIMED_STEPS}) on {card_line()}: " + "; ".join(
            f"{name} {ms:.3f} ms = {1e3 / ms:.3f} steps/s, peak {peak / 2**30:.3f} GiB"
            for name, (ms, peak) in timed.items()))
    # remat's segments must lower the peak: the conv embed's activations
    # wait in slices of frames for their recompute.
    if torch_device_type() == "cuda" and not (
            timed["remat"][1] <= CLI_REMAT_PEAK * timed["plain"][1]):
        raise AssertionError(f"remat peak {timed['remat'][1]} not under "
                             f"{CLI_REMAT_PEAK} of the plain step's {timed['plain'][1]}")
    MEASURED["cli_timed"] = timed
    return launches


def start_pose_collect(model_dir: str) -> "_Child":
    """The random collect, its env and policy seeded (0): the shipped
    config leaves them unseeded, and the bf16 step below is held on what
    it collects, so every run holds it on the same episodes."""
    return _Child("collect_pose", "run_collect_eval", [
        f"--root_dir={os.path.join(model_dir, 'pose', 'collect')}",
        f"--gin_configs={os.path.join(POSE_CONFIGS, 'run_random_collect.gin')}",
        f"--gin_bindings=collect_eval_loop.num_collect = {CLI_POSE['collect']}",
        "--gin_bindings=PoseToyEnv.seed = 0",
        "--gin_bindings=PoseEnvRandomPolicy.seed = 0",
    ], model_dir)


def cli_pose_binaries(model_dir: str, collect: "_Child") -> None:
    """The JAX package's shipped pose_env configs through the three
    binaries: random collect (started by the caller), then regression
    training (bf16 wrapper) with continuous eval tailing it."""
    import glob

    from tensor2robot_tpu_torch.data import tfrecord
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.metrics import read_metrics

    _run_children([collect])
    root = os.path.join(model_dir, "pose")
    shards = sorted(glob.glob(os.path.join(root, "collect", "policy_collect", "*.tfrecord")))
    records = sum(1 for shard in shards for _ in tfrecord.read_tfrecords(shard))
    if records != CLI_POSE["collect"]:
        raise AssertionError(f"collect wrote {records} records in {shards}")
    run_dir = os.path.join(root, "run")
    common = [f"--gin_configs={os.path.join(POSE_CONFIGS, 'run_train_reg.gin')}",
              f"--gin_bindings=EVAL_DATA = {shards!r}"]
    if CLI_POSE["batch"]:
        common += [f"--gin_bindings={scope}/DefaultRecordInputGenerator.batch_size = "
                   f"{CLI_POSE['batch']}" for scope in ("train_input_generator",
                                                        "eval_input_generator")]
    evaluator = _Child("continuous_eval_pose", "run_continuous_eval", common + [
        "--gin_bindings=continuous_eval.t2r_model = @PoseEnvRegressionModel()",
        "--gin_bindings=continuous_eval.input_generator_eval = {'cli': %EVAL_INPUT_GENERATOR}",
        f"--gin_bindings=continuous_eval.model_dir = {run_dir!r}",
        f"--gin_bindings=continuous_eval.eval_steps = {CLI_POSE['eval_steps']}",
        f"--gin_bindings=continuous_eval.max_train_steps = {CLI_POSE['steps']}",
        "--gin_bindings=continuous_eval.poll_interval = 0.2",
        f"--gin_bindings=continuous_eval.timeout = {float(CLI_TIMEOUT)}",
        f"--gin_bindings=continuous_eval.device = {DEVICE!r}",
    ], model_dir)
    trainer = _Child("trainer_pose", "run_t2r_trainer", common + [
        f"--gin_bindings=TRAIN_DATA = {shards!r}",
        f"--gin_bindings=train_eval_model.max_train_steps = {CLI_POSE['steps']}",
        f"--gin_bindings=train_eval_model.eval_steps = {CLI_POSE['eval_steps']}",
        f"--gin_bindings=train_eval_model.model_dir = {run_dir!r}",
        f"--gin_bindings=train_eval_model.device = {DEVICE!r}",
    ], model_dir)
    _run_children([trainer, evaluator])
    if "dtype=torch.bfloat16" not in trainer.output():
        raise AssertionError("run_train_reg.gin did not train under the bf16 wrapper")
    if state_lib.checkpoint_steps(run_dir) != [CLI_POSE["steps"]]:
        raise AssertionError(f"pose checkpoints {state_lib.checkpoint_steps(run_dir)}")
    evals = read_metrics(os.path.join(run_dir, "eval_cli"))
    if [row["step"] for row in evals] != [CLI_POSE["steps"]]:
        raise AssertionError(f"pose continuous eval wrote {evals}")
    train = read_metrics(os.path.join(run_dir, "train"))
    log(f"[cli] pose_env configs on {card_line()}: run_random_collect.gin "
        f"{records} episodes (beside the BC binaries); run_train_reg.gin "
        f"(device_type 'tpu': bf16 wrapper) {CLI_POSE['steps']} steps in "
        f"{trainer.seconds:.1f}s with start-up, last loss {train[-1]['loss']:.6f} "
        f"(random-collect rewards are <= 0: every loss weight is 0); "
        f"continuous eval beside it done {evaluator.seconds:.1f}s after its start: "
        f"{evals[-1]}")
    cli_pose_bf16_step(shards)


def cli_pose_bf16_step(shards: list) -> None:
    """run_train_reg.gin's model under its bf16 wrapper, trained in
    process on a collected batch whose rewards are made positive. The
    env's reward is -|action - target| <= 0 and the loss weights clamp at
    0, so the binaries' run on random-collect data has a loss of exactly
    0 and moves nothing (in both packages); this step is the one that
    holds the bf16 update. Rewards become exp(reward), in (0, 1], larger
    for closer actions."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.models.tpu_model_wrapper import BFloat16ModelWrapper
    from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
        PoseEnvRegressionModel,
    )
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer, maybe_wrap_for_tpu

    model = PoseEnvRegressionModel(device_type="tpu")
    wrapped = maybe_wrap_for_tpu(model)
    if not isinstance(wrapped, BFloat16ModelWrapper):
        raise AssertionError("device_type 'tpu' did not select the bf16 wrapper")
    runs = {}
    for name, each in (("f32", model), ("bf16", wrapped)):
        generator = DefaultRecordInputGenerator(
            file_patterns=shards, batch_size=CLI_POSE["batch"] or 64,
            shuffle_buffer_size=0, seed=0, num_parse_workers=0)
        generator.set_specification_from_model(each, "train")
        batch = to_device(next(iter(generator.create_dataset("train"))), DEVICE)
        batch["labels/reward"] = torch.exp(batch["labels/reward"].float()).to(
            batch["labels/reward"].dtype)
        trainer = Trainer(each, device=DEVICE)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        params = dict(state.network.named_parameters())
        init = {k: p.detach().clone() for k, p in params.items()}
        losses = [trainer.train_step(state, batch)["loss"].float()]
        grads = {k: state.optimizer.state[p]["exp_avg"] / (1 - POSE_ADAM["beta1"])
                 for k, p in params.items()}
        moved = {k: p.detach() - init[k] for k, p in params.items()}
        for _ in range(POSE_BF16_STEPS - 1):
            losses.append(trainer.train_step(state, batch)["loss"].float())
        runs[name] = dict(init=init, grads=grads, moved=moved,
                          losses=[float(x) for x in losses])
    f32, bf16 = runs["f32"], runs["bf16"]
    if any(not torch.equal(f32["init"][k], v) for k, v in bf16["init"].items()):
        raise AssertionError("the bf16 and f32 steps did not start from one init")
    flat = lambda tree: torch.cat([v.flatten().double() for v in tree.values()])  # noqa: E731
    grad_err = float((flat(bf16["grads"]) - flat(f32["grads"])).norm()
                     / flat(f32["grads"]).norm())
    a, b = flat(bf16["moved"]), flat(f32["moved"])
    update_cos = float(a @ b / (a.norm() * b.norm()))
    largest = max(float(v.abs().max()) for v in bf16["moved"].values())
    stalled = [k for k, v in bf16["moved"].items()
               if not float(v.abs().max()) >= 0.5 * POSE_ADAM["lr"]]
    loss, want = bf16["losses"][0], f32["losses"][0]
    log(f"[cli] run_train_reg.gin's model, a reward-bearing bf16 step vs f32 on "
        f"{card_line()}: loss {loss:.6f} vs {want:.6f}; gradient {grad_err:.4f} "
        f"relative L2; update cosine {update_cos:.4f}, largest {largest:.3e}; "
        f"bf16 losses over {POSE_BF16_STEPS} steps "
        + ", ".join(f"{x:.6f}" for x in bf16["losses"]))
    if not (loss > 0 and abs(loss - want) <= POSE_BF16_LOSS_TOL):
        raise AssertionError(f"bf16 loss {loss} vs f32 {want}")
    if not grad_err <= POSE_BF16_GRAD_TOL:
        raise AssertionError(f"bf16 gradient {grad_err} relative L2 off f32")
    if not (update_cos >= POSE_BF16_UPDATE_COS and largest <= 1.002 * POSE_ADAM["lr"]
            and not stalled):
        raise AssertionError(f"bf16 update: cosine {update_cos}, largest {largest}, "
                             f"leaves that did not move {stalled}")
    if not bf16["losses"][-1] < bf16["losses"][0]:
        raise AssertionError(f"bf16 steps did not lower the loss: {bf16['losses']}")


def phase_cli(model_dir: str) -> dict:
    launches = cli_regime_parity(model_dir)
    # The pose collect (host only) runs beside the BC binaries.
    collect = start_pose_collect(model_dir)
    try:
        measured = cli_bc_binaries(model_dir)
    except BaseException:
        collect.stop()
        raise
    timed = MEASURED["cli_timed"]["remat+grad_accum"][0]
    log(f"[cli] steps/s of remat + grad_accum_steps {CLI_ACCUM} on {card_line()}: "
        f"StepTimingHook in the trainer binary {measured['hook_steps_per_sec']:.3f} "
        f"(iterations_per_loop {CLI_LOOP}, host data and hooks included) beside "
        f"this script's synced timer {1e3 / timed:.3f} (one on-device batch)")
    cli_pose_binaries(model_dir, collect)
    return launches


# The meta phase (slice 10): the shipped run_train_reg_maml.gin's model,
# PoseEnvRegressionModelMAML over PoseEnvRegressionModel, at its widths:
# 64x64x3 images, batch 8 (tasks), and the samples dim (None) that the
# random generator fills with 3 condition and 3 inference samples a task.
# (a) an outer step on the card against the CPU from the same weights on
# the same batch, second and first order, held to the BC gradient gate
# (LOSS_TOL, GRAD_TOL; set before the first card run), TF32 off and cuDNN
# deterministic; (b) the config through the binaries, cut from 5000 steps
# to META_CLI["steps"] and from 100 eval batches to 1; (c) meta-example
# records of collected hidden-drift tasks, META_RECORD_STEPS steps from
# them, and run_meta_env over the trained checkpoint.
META_TASKS = 8
META_SAMPLES = 3  # make_random_numpy's sequence_length
META_TIMED_STEPS = 5
META_CLI = dict(steps=40, eval_steps=1)
META_CONFIG = os.path.join(ROOT, "tensor2robot_tpu_torch", "research", "pose_env",
                           "configs", "run_train_reg_maml.gin")
META_RECORD_TASKS = 64
META_RECORD_STEPS = 40
META_ENV = dict(tasks=10, adaptations=2)
# A collected episode's reward: 1 when the random action lands within
# this distance of the target (the JAX package's pose tests' threshold).
META_SUCCESS = -1.5


def meta_model(use_second_order: bool = True, device_type: str = "gpu", mesh=None,
               **kwargs):
    """Pose MAML, its base built with `mesh` (its loss's sums then span
    the mesh's data x fsdp shards)."""
    from tensor2robot_tpu_torch.research.pose_env import (
        PoseEnvRegressionModel,
        PoseEnvRegressionModelMAML,
    )

    return PoseEnvRegressionModelMAML(
        base_model=PoseEnvRegressionModel(device_type=device_type, mesh=mesh),
        num_inner_loop_steps=1, use_second_order=use_second_order, **kwargs)


def meta_card_vs_cpu() -> None:
    """A second- and a first-order outer step from the same seeded weights
    on the same random task batch, on the card and on the CPU; then each
    order's synced step and peak memory on the card."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    generator = DefaultRandomInputGenerator(batch_size=META_TASKS, seed=0)
    generator.set_specification_from_model(meta_model(), "train")
    batch = next(iter(generator.create_dataset("train")))
    shape = tuple(batch["features/condition/features/state"].shape)
    if shape != (META_TASKS, META_SAMPLES, 64, 64, 3):
        raise AssertionError(f"task batch of shape {shape}")
    weights = meta_model().init_network(torch.Generator().manual_seed(0), "cpu").state_dict()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rows, timed = [], {}
    try:
        for name, second in (("second order", True), ("first order", False)):
            grads = {}
            for device in ("cpu", DEVICE):
                trainer = Trainer(meta_model(second), device=device)
                network = trainer.init_state(params=weights).network
                features, labels = trainer.preprocess_train(to_device(batch, device))
                loss, metrics = trainer.backward(network, features, labels)
                grads[device] = (float(loss), {k: p.grad.detach().cpu()
                                               for k, p in network.named_parameters()})
            (want, want_grads), (got, got_grads) = grads["cpu"], grads[DEVICE]
            loss_err = abs(got - want) / abs(want)
            if not loss_err <= LOSS_TOL:
                raise AssertionError(f"{name}: card loss {got} vs CPU {want}")
            worst = 0.0
            for key, ref in want_grads.items():
                scale = float(ref.abs().max())
                err = float((got_grads[key] - ref).abs().max())
                if not err <= GRAD_TOL * scale + 1e-7:
                    raise AssertionError(f"{name}: {key} gradient off the CPU's by {err} "
                                         f"(max {scale})")
                worst = max(worst, err / max(scale, 1e-30))
            rows.append(f"{name} loss {got:.7f} vs {want:.7f} (rel {loss_err:.2e}), worst "
                        f"gradient at {worst:.2e} of its max")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    device_batch = to_device(batch, DEVICE)
    for name, second in (("second order", True), ("first order", False)):
        trainer = Trainer(meta_model(second), device=DEVICE)
        state = trainer.init_state(params=weights)
        timed[name] = _synced_step_ms(trainer, state, device_batch, META_TIMED_STEPS)
        if second:
            # A launch-bound step: the busy share says how far the host
            # holds the card back.
            device_profile("meta second-order step",
                           lambda: trainer.train_step(state, device_batch))
        del state
        torch.cuda.empty_cache()
    log(f"[meta] card vs CPU, {META_TASKS} tasks x ({META_SAMPLES} condition + "
        f"{META_SAMPLES} inference) at 64x64, one inner step, f32: " + "; ".join(rows))
    log(f"[meta] synced outer step (on-device batch, median of {META_TIMED_STEPS}) on "
        f"{card_line()}: " + "; ".join(
            f"{name} {ms:.3f} ms = {1e3 / ms:.3f} steps/s, peak {peak / 2**30:.3f} GiB"
            for name, (ms, peak) in timed.items()))
    MEASURED["meta_timed"] = timed


def meta_binaries(model_dir: str) -> None:
    """The port's run_train_reg_maml.gin through run_t2r_trainer (its
    device_type 'tpu': the bf16 wrapper) beside run_continuous_eval, random
    task batches standing in for meta-example shards as the JAX package's
    test_maml_gin_config_trains binds them."""
    import numpy as np

    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.metrics import read_metrics

    run_dir = os.path.join(model_dir, "maml")
    steps = META_CLI["steps"]
    common = [f"--gin_configs={META_CONFIG}"] + [f"--gin_bindings={b}" for b in (
        _bindings("train_rand/DefaultRandomInputGenerator",
                  dict(batch_size=META_TASKS, seed=0))
        + _bindings("eval_rand/DefaultRandomInputGenerator",
                    dict(batch_size=META_TASKS, seed=1000)))]
    trainer_flags = common + [f"--gin_bindings={b}" for b in (
        ["train_eval_model.input_generator_train = "
         "@train_rand/DefaultRandomInputGenerator()",
         "train_eval_model.input_generator_eval = @eval_rand/DefaultRandomInputGenerator()",
         "train_eval_model.hook_builders = [@StepTimingHookBuilder()]"]
        + _bindings("train_eval_model", dict(
            model_dir=run_dir, max_train_steps=steps, eval_steps=META_CLI["eval_steps"],
            log_every_steps=10, device=DEVICE))
        + _bindings("StepTimingHookBuilder", dict(sync_every=max(1, min(10, steps - 1)))))]
    eval_flags = common + [f"--gin_bindings={b}" for b in (
        ["continuous_eval.t2r_model = @PoseEnvRegressionModelMAML()",
         "continuous_eval.input_generator_eval = "
         "{'cli': @eval_rand/DefaultRandomInputGenerator()}"]
        + _bindings("continuous_eval", dict(
            model_dir=run_dir, eval_steps=META_CLI["eval_steps"], max_train_steps=steps,
            timeout=float(CLI_TIMEOUT), poll_interval=0.2, device=DEVICE)))]
    os.makedirs(run_dir, exist_ok=True)
    # Both start at once: the learner checkpoints only at its last step,
    # which the eval job (polling by then) evaluates.
    children = [_Child("trainer_maml", "run_t2r_trainer", trainer_flags, model_dir)]
    try:
        children.append(_Child("continuous_eval_maml", "run_continuous_eval", eval_flags,
                               model_dir))
    finally:
        _run_children(children)
    trainer, evaluator = children
    if "dtype=torch.bfloat16" not in trainer.output():
        raise AssertionError("run_train_reg_maml.gin did not train under the bf16 wrapper")
    checkpoints = state_lib.checkpoint_steps(run_dir)
    train = read_metrics(os.path.join(run_dir, "train"))
    evals = [row["step"] for row in read_metrics(os.path.join(run_dir, "eval_cli"))]
    if checkpoints != [steps] or evals != checkpoints:
        raise AssertionError(f"checkpoints {checkpoints}, continuous eval steps {evals}")
    if not train or not all(np.isfinite(row["loss"]) for row in train):
        raise AssertionError(f"train metrics {train}")
    timing = [json.loads(line) for line in open(
        os.path.join(run_dir, "profiling", "step_timing.jsonl"))]
    rate = float(np.median([row["steps_per_sec"] for row in timing]))
    log(f"[meta] run_train_reg_maml.gin through the binaries on {card_line()} (cut: "
        f"max_train_steps 5000 -> {steps}, eval_steps 100 -> {META_CLI['eval_steps']}; "
        f"random task batches of {META_TASKS}; bf16 wrapper): {steps} steps in "
        f"{trainer.seconds:.1f}s with start-up, last loss {train[-1]['loss']:.6f}, "
        f"inner losses {train[-1]['inner_loss_0']:.6f} -> {train[-1]['inner_loss_1']:.6f}; "
        f"StepTimingHook {', '.join(f'{r['steps_per_sec']:.3f}' for r in timing)} "
        f"steps/s (median {rate:.3f}); continuous eval steps {evals} done "
        f"{evaluator.seconds:.1f}s after its start")


def collect_meta_records(path: str, num_tasks: int, seed: int = 0) -> int:
    """Hidden-drift PoseToyEnv tasks as meta-example records: per task one
    condition and one inference episode of the random policy, each its
    transition Example (rewards 1 within META_SUCCESS of the target), joined
    by make_meta_example."""
    from tensor2robot_tpu_torch.data import tfrecord
    from tensor2robot_tpu_torch.meta_learning.meta_example import make_meta_example
    from tensor2robot_tpu_torch.research.pose_env import (
        PoseEnvRandomPolicy,
        PoseToyEnv,
        episode_to_transitions_pose_toy,
    )

    env = PoseToyEnv(hidden_drift=True, seed=seed)
    policy = PoseEnvRandomPolicy(seed=seed + 1)
    records = []
    for _ in range(num_tasks):
        env.reset_task()
        examples = []
        for _ in range(2):
            obs = env.reset()
            action, _ = policy.sample_action(obs, 1.0)
            new_obs, reward, done, debug = env.step(action)
            examples += episode_to_transitions_pose_toy(
                [(obs, action, reward, new_obs, done, debug)],
                binary_success_threshold=META_SUCCESS)
        records.append(make_meta_example(examples[:1], examples[1:]))
    return tfrecord.write_tfrecords(path, records)


class _RecordedEnv:
    """An env that keeps every action it is given."""

    def __init__(self, env):
        self._env = env
        self.actions = []

    def reset_task(self):
        self._env.reset_task()

    def reset(self):
        return self._env.reset()

    def step(self, action):
        self.actions.append(action)
        return self._env.step(action)


def unbatched_pack(pack_features):
    """A model's pack_features (batch 1 columns) as a policy pack_fn: the
    policy adds the batch dim itself."""
    return lambda state, context, timestep: {
        key: value[0] for key, value in pack_features(state, context, timestep).items()}


def meta_records_to_policy(model_dir: str) -> None:
    """Collect -> meta-example records -> META_RECORD_STEPS steps through
    RecordDataset and FixedLenMetaExamplePreprocessor -> run_meta_env with
    MAMLRegressionPolicy over CheckpointPredictor."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.meta_learning import (
        FixedLenMetaExamplePreprocessor,
        MAMLRegressionPolicy,
        run_meta_env,
    )
    from tensor2robot_tpu_torch.predictors import CheckpointPredictor
    from tensor2robot_tpu_torch.research.pose_env import PoseToyEnv
    from tensor2robot_tpu_torch.specs import TensorSpecStruct
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    root = os.path.join(model_dir, "maml_records")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "tasks.tfrecord")
    t0 = time.monotonic()
    written = collect_meta_records(path, META_RECORD_TASKS)
    collect_s = time.monotonic() - t0
    model = meta_model(preprocessor_cls=FixedLenMetaExamplePreprocessor)
    run_dir = os.path.join(root, "run")
    t0 = time.monotonic()
    train_eval_model(
        model, DefaultRecordInputGenerator(file_patterns=path, batch_size=META_TASKS, seed=0),
        model_dir=run_dir, max_train_steps=META_RECORD_STEPS,
        save_checkpoints_steps=META_RECORD_STEPS, log_every_steps=10, device=DEVICE)
    train_s = time.monotonic() - t0
    predictor = CheckpointPredictor(model, checkpoint_dir=run_dir, device=DEVICE)
    if not predictor.restore() or predictor.global_step != META_RECORD_STEPS:
        raise AssertionError(f"the predictor serves step {predictor.global_step}")
    policy = MAMLRegressionPolicy(predictor, pack_fn=unbatched_pack(model.pack_features))
    env = _RecordedEnv(PoseToyEnv(hidden_drift=True, seed=2))
    t0 = time.monotonic()
    stats = run_meta_env(env, policy, num_tasks=META_ENV["tasks"],
                         num_adaptations_per_task=META_ENV["adaptations"])
    env_s = time.monotonic() - t0
    actions = np.stack(env.actions)
    episodes = META_ENV["tasks"] * META_ENV["adaptations"]
    if len(actions) != episodes or not np.all(np.isfinite(actions)) or not np.all(
            np.abs(actions) <= 1.0):
        raise AssertionError(f"meta-env actions {actions}")
    # The policy's action is the model's inference_output on the same
    # packed features, run directly.
    obs = env.reset()
    action = policy.SelectAction(obs)
    packed = model.pack_features(obs, policy.prev_episode_data, 0)
    with torch.no_grad():
        features, _ = model.preprocessor.preprocess(TensorSpecStruct(
            {k: torch.from_numpy(v).to(DEVICE) for k, v in packed.items()}), None,
            mode="predict")
        outputs, _ = model.inference_network_fn(predictor._network, features, "predict")
    direct = outputs["inference_output"][0, 0].cpu().numpy()
    gap = float(np.max(np.abs(action - direct) / (1.0 + np.abs(direct))))
    if not gap <= POLICY_TOL:
        raise AssertionError(f"policy action {action} vs direct forward {direct}")
    log(f"[meta] records to a policy on {card_line()}: {written} meta-example records "
        f"of hidden-drift tasks in {collect_s:.1f}s; {META_RECORD_STEPS} steps of batch "
        f"{META_TASKS} from them (RecordDataset, FixedLenMetaExamplePreprocessor) in "
        f"{train_s:.1f}s with set-up; run_meta_env {META_ENV['tasks']} tasks x "
        f"{META_ENV['adaptations']} adaptations over CheckpointPredictor: "
        + ", ".join(f"{k.split('/', 1)[1]} {v:.6f}" for k, v in sorted(stats.items()))
        + f"; {episodes / env_s:.3f} episodes/s; policy vs direct forward {gap:.2e}")


def phase_meta(model_dir: str) -> None:
    meta_card_vs_cpu()
    meta_binaries(model_dir)
    meta_records_to_policy(model_dir)


# The stream phase: the JAX package's streaming bench shape (bench.py:
# 1328-1330): full-width BC at batch 1 over a 1024-step episode, windows
# 128 and None, and experts at window 128. Each streamed action is held
# to the full-sequence forward's row under SERVE_TOL (the served-action
# gate, set before the first card run), the exported policy to the
# in-process one under STREAM_EXPORT_TOL (the same f32 ops, loaded from
# the program). Steps/s is the median of STREAM_WINDOWS windows of
# STREAM_WINDOW steps after a reset, as bench.py:1358-1368 takes it.
STREAM_ATTENTION_WINDOWS = (128, None)
STREAM_EXPERTS = 4
STREAM_EXPORT_TOL = 1e-5
STREAM_WINDOWS, STREAM_WINDOW = 5, 20
STREAM_EAGER_STEPS = 64
# The moe phase: full-width BC with 4 experts (k = 2, the JAX package's
# test count) through the kernels. Routing is discontinuous: a token
# whose k-th and (k+1)-th router probabilities lie within the two
# attention paths' rounding may pick another expert on each path. A
# differing pick under MOE_FLIP_MARGIN takes its episode (its routing
# group, the only one it reaches) out of the comparison; any other fails.
MOE_EXPERTS = 4
MOE_FLIP_MARGIN = 1e-5


def stream_model(window, num_experts: int = 1):
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )

    return TransformerBCModel(**bc_model_kwargs(use_flash=False),
                              attention_window=window, num_experts=num_experts)


def _stream(policy, images, poses) -> tuple:
    """Actions [T, A] and per-step wall seconds of one episode."""
    import numpy as np

    actions, times = [], []
    for t in range(len(images)):
        t0 = time.perf_counter()
        actions.append(policy.step(images[t], poses[t])[0])
        times.append(time.perf_counter() - t0)
    return np.stack(actions), times


def _steps_per_s(policy, images, poses) -> float:
    """bench.py's rate: the median per-step time of windows of steps from
    an episode's start."""
    import statistics

    per_step = []
    for _ in range(STREAM_WINDOWS):
        policy.reset()
        t0 = time.perf_counter()
        for t in range(STREAM_WINDOW):
            policy.step(images[t], poses[t])
        per_step.append((time.perf_counter() - t0) / STREAM_WINDOW)
    return 1.0 / statistics.median(per_step)


def _check_replays(runner, steps: int, label: str) -> str:
    """One graph replay per step on the card (one build); eager steps on
    the CPU rehearsal."""
    graph = torch_device_type() == "cuda"
    ran = runner.graph_replays if graph else runner.eager_steps
    if ran != steps or (graph and runner.graph_builds != 1):
        raise AssertionError(f"{label}: {ran} graph replays for {steps} steps, "
                             f"{runner.graph_builds} builds")
    return f"{'graph replays' if graph else 'eager steps'} {ran} = steps"


def stream_one(window, num_experts: int, model_dir: str, full_routes: bool) -> None:
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.export import (
        StreamingExportedPolicy,
        save_streaming_export,
    )
    from tensor2robot_tpu_torch.specs import make_random_numpy

    model = stream_model(window, num_experts)
    network = model.init_network(torch.Generator().manual_seed(0), device=DEVICE)
    network.eval()
    episode = make_random_numpy(model.get_feature_specification("predict"),
                                batch_size=1, seed=0)
    with torch.no_grad():
        full = network({k: torch.from_numpy(np.asarray(v)).to(DEVICE)
                        for k, v in episode.items()}, "predict")["action"][0].cpu().numpy()
    state = network.state_dict()
    images, poses = np.asarray(episode["image"])[0], np.asarray(episode["gripper_pose"])[0]
    steps = len(images)
    label = (f"window {window}" + (f", {num_experts} experts" if num_experts > 1 else ""))

    reset_launches()
    policy = model.create_streaming_policy(state, device=DEVICE)
    streamed, times = _stream(policy, images, poses)
    err = _close(streamed, full, SERVE_TOL)
    policy.reset()
    again = policy.step(images[0], poses[0])[0]
    reset_err = _close(again, full[0], SERVE_TOL)
    _close(again, streamed[0], STREAM_EXPORT_TOL)
    rate = _steps_per_s(policy, images, poses)
    replays = _check_replays(policy, steps + 1 + STREAM_WINDOWS * STREAM_WINDOW, label)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"streaming launched flash kernels {launches}")
    log(f"[stream] {label} on {card_line()}: {steps} steps at batch 1 within "
        f"{SERVE_TOL} abs + rel of the full forward (max |err| {err:.3e}); reset "
        f"reproduces step 0 (|err| {reset_err:.3e}); first step (warm-up + capture) "
        f"{times[0] * 1e3:.1f} ms; {rate:.3f} steps/s (median of {STREAM_WINDOWS} "
        f"windows of {STREAM_WINDOW}); p50 {_percentile_ms(times[1:], 50):.4f} ms, "
        f"p90 {_percentile_ms(times[1:], 90):.4f} ms over steps 1-{steps - 1}; "
        f"{replays}; no flash launch")
    if not full_routes:
        return

    eager = model.create_streaming_policy(state, device=DEVICE, graph=False)
    eager_actions, eager_times = _stream(eager, images[:STREAM_EAGER_STEPS],
                                         poses[:STREAM_EAGER_STEPS])
    eager_err = _close(eager_actions, streamed[:STREAM_EAGER_STEPS], STREAM_EXPORT_TOL)
    log(f"[stream] {label} eager (no graph): {len(eager_times) / sum(eager_times):.3f} "
        f"steps/s over {STREAM_EAGER_STEPS}, p50 {_percentile_ms(eager_times, 50):.4f} "
        f"ms; actions within {STREAM_EXPORT_TOL} of the graph's (max |err| "
        f"{eager_err:.3e})")
    # Host launches vs device time of one step, each route.
    for name, route in (("graph", policy), ("eager", eager)):
        device_profile(f"stream step ({label}, {name})",
                       lambda route=route: route.step(images[0], poses[0]), rows=5)

    export_dir = os.path.join(model_dir, f"stream_{window}")
    t0 = time.monotonic()
    save_streaming_export(export_dir, model, state)
    export_s = time.monotonic() - t0
    t0 = time.monotonic()
    loaded = StreamingExportedPolicy(export_dir, device=DEVICE)
    load_s = time.monotonic() - t0
    exported, _ = _stream(loaded, images, poses)
    export_err = _close(exported, streamed, STREAM_EXPORT_TOL)
    export_rate = _steps_per_s(loaded, images, poses)
    replays = _check_replays(loaded, steps + STREAM_WINDOWS * STREAM_WINDOW,
                             label + " export")
    log(f"[stream] {label} export: written in {export_s:.2f}s, loaded with no model "
        f"code in {load_s:.2f}s; {steps} steps within {STREAM_EXPORT_TOL} of the "
        f"in-process policy (max |err| {export_err:.3e}); {export_rate:.3f} steps/s; "
        f"{replays}")


def phase_stream(model_dir: str) -> None:
    """KV-cache streaming serving at full width (no flash kernel runs:
    decode attends through the einsum oracle, as JAX's _decode_step)."""
    for window in STREAM_ATTENTION_WINDOWS:
        stream_one(window, 1, model_dir, full_routes=True)
    stream_one(STREAM_ATTENTION_WINDOWS[0], STREAM_EXPERTS, model_dir, full_routes=False)


def moe_model(use_flash: bool):
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )

    return TransformerBCModel(**bc_model_kwargs(use_flash), num_experts=MOE_EXPERTS)


class _RouterRecorder:
    """Records the router logits of every top_k_routing call while on."""

    def __init__(self):
        from tensor2robot_tpu_torch.ops import moe as moe_ops

        self.logits = []
        self._ops = moe_ops
        self._route = moe_ops.top_k_routing

    def __enter__(self):
        def recorded(router_logits, num_selected, capacity):
            self.logits.append(router_logits.detach().float())
            return self._route(router_logits, num_selected, capacity)

        self._ops.top_k_routing = recorded
        return self

    def __exit__(self, *exc):
        self._ops.top_k_routing = self._route

    def picks(self, k: int):
        """Per layer: the top-k experts [G, T, k] and each token's top-k
        margin p_k - p_(k+1) [G, T], as top_k_routing picks them."""
        import torch

        out = []
        for logits in self.logits:
            probs, order = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                                      descending=True, stable=True)
            out.append((order[..., :k], probs[..., k - 1] - probs[..., k]))
        return out


def _moe_backward(trainer, network, batch):
    import torch

    with _RouterRecorder() as recorder:
        loss, metrics = trainer.forward_loss(network, batch)
        loss.backward()
    torch.cuda.synchronize()
    return loss, metrics, recorder.picks(2)


def moe_gradient_check() -> dict:
    """One step's loss and gradients through B1/B3/B4 against the einsum
    path on the same batch and weights, with routing flips counted."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.specs import TensorSpecStruct
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model, ref_model = moe_model(True), moe_model(False)
    trainer, ref_trainer = Trainer(model, device=DEVICE), Trainer(ref_model, device=DEVICE)
    weights = trainer.init_state(torch.Generator().manual_seed(0)).network.state_dict()
    generator = DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=0)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), DEVICE)
    episodes = list(range(SLICE["batch"]))
    dropped = []
    for _ in range(2):
        part = TensorSpecStruct()
        for key, value in batch.items():
            part[key] = value[episodes]
        network = trainer.init_state(params=weights).network
        ref_network = ref_trainer.init_state(params=weights).network
        reset_launches()
        loss, metrics, picks = _moe_backward(trainer, network, part)
        launches = read_launches()
        ref_loss, _, ref_picks = _moe_backward(ref_trainer, ref_network, part)
        margin = min(m.min().item() for _, m in picks)
        flips = []
        for layer, ((ids, m), (ref_ids, _)) in enumerate(zip(picks, ref_picks)):
            differ = (ids != ref_ids).any(dim=-1)
            for g, t in differ.nonzero().tolist():
                flips.append((layer, episodes[g], t, m[g, t].item()))
        wide = [f for f in flips if f[3] >= MOE_FLIP_MARGIN]
        if wide:
            raise AssertionError(f"routing differs past the margin {MOE_FLIP_MARGIN}: "
                                 f"(layer, episode, step, margin) {wide}")
        if not flips:
            break
        # Each episode is its own routing group and attention context, so a
        # flip reaches nothing outside it.
        dropped += sorted({f[1] for f in flips})
        episodes = [e for e in episodes if e not in dropped]
        log(f"[moe] routing flips under the margin {MOE_FLIP_MARGIN} "
            f"(layer, episode, step, margin) {flips}: episodes {dropped} left "
            "out of the comparison")
    else:
        raise AssertionError("routing still flips after leaving episodes out")
    expected = {"flash_fwd": 0, "flash_fwd_tile": NUM_LAYERS,
                "flash_bwd_dq": NUM_LAYERS, "flash_bwd_dkv": NUM_LAYERS}
    if launches != expected:
        raise AssertionError(f"MoE step launches {launches} != {expected}")
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    if not loss_err <= LOSS_TOL:
        raise AssertionError(f"MoE loss {loss.item()} vs einsum {ref_loss.item()}")
    aux = metrics["loss/moe_aux"].item()
    if not math.isfinite(aux):
        raise AssertionError(f"loss/moe_aux {aux}")
    worst, worst_name = 0.0, ""
    ref_params = dict(ref_network.named_parameters())
    for name, p in network.named_parameters():
        g, g_ref = p.grad, ref_params[name].grad
        if g is None or g_ref is None:
            raise AssertionError(f"{name}: no gradient")
        scale = g_ref.abs().max().item()
        err = (g - g_ref).abs().max().item()
        if not err <= GRAD_TOL * scale + 1e-7:
            raise AssertionError(
                f"{name}: MoE gradient off the einsum path by {err} (max {scale})")
        ratio = err / max(scale, 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
    log(f"[moe] {MOE_EXPERTS} experts (k = 2) gradient check on {card_line()}: loss "
        f"{loss.item():.7f} vs einsum {ref_loss.item():.7f} (rel {loss_err:.2e}), "
        f"loss/moe_aux {aux:.7f}; worst gradient {worst_name} at {worst:.2e} of its "
        f"max; routing picks differing {len(flips)} over {len(episodes)} episodes "
        f"(episodes left out: {dropped or 'none'}), smallest top-2 margin "
        f"{margin:.3e}; launches {launches}")
    return launches


def phase_moe(model_dir: str) -> dict:
    """Full-width BC with experts: the gradient gate through the kernels,
    the launches and cost of a step, and the aux loss kept out of eval
    outputs and checkpoints."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    launches = moe_gradient_check()
    torch.cuda.empty_cache()
    model = moe_model(True)
    trainer = Trainer(model, device=DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    generator = DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=7)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), DEVICE)
    reset_launches()
    median, peak = _synced_step_ms(trainer, state, batch, TIMED_STEPS)
    steps = 2 + TIMED_STEPS
    counted = read_launches()
    per_step = {"flash_fwd": 0, "flash_fwd_tile": NUM_LAYERS,
                "flash_bwd_dq": NUM_LAYERS, "flash_bwd_dkv": NUM_LAYERS}
    if counted != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError(f"{steps} MoE steps launched {counted}")
    dense = MEASURED.get("bc_step_ms")
    log(f"[moe] train step (batch {SLICE['batch']}, {MOE_EXPERTS} experts, on-device "
        f"batch) on {card_line()}: median {median:.3f} ms over {TIMED_STEPS} synced "
        f"steps = {1e3 / median:.3f} steps/s; peak memory allocated "
        f"{peak / 2**30:.3f} GiB; the dense step "
        + (f"{dense:.3f} ms (training phase)" if dense else "not measured in this run")
        + f"; launches {counted} over {steps} steps")
    for name, count in counted.items():
        launches[name] += count

    reset_launches()
    start = state.step
    device_profile("MoE train step", lambda: trainer.train_step(state, batch), rows=20)
    metrics = trainer.train_step(state, batch)
    aux = metrics["loss/moe_aux"].item()
    if not math.isfinite(aux) or not math.isfinite(metrics["loss"].item()):
        raise AssertionError(f"MoE train metrics {metrics}")
    evals = trainer.eval_step(state, batch)
    if set(evals) != {"eval/mse"}:
        raise AssertionError(f"MoE eval metrics {sorted(evals)}")
    with torch.inference_mode():
        features, _ = trainer.preprocess_train(batch)
        outputs = model.packed_inference(state.network, features, "eval")[2]
    if set(outputs) != {"inference_output", "action"}:
        raise AssertionError(f"MoE eval outputs {sorted(outputs)}")
    state_lib.save_checkpoint(model_dir, state.step, state.params())
    saved = state_lib.load_checkpoint(model_dir, state.step)["params"]
    if set(saved) != set(state.network.state_dict()) or any("aux" in k for k in saved):
        raise AssertionError(f"MoE checkpoint keys {sorted(saved)}")
    counted = read_launches()
    ran = state.step - start
    expected = {"flash_fwd": 2 * NUM_LAYERS, "flash_fwd_tile": NUM_LAYERS * ran,
                "flash_bwd_dq": NUM_LAYERS * ran, "flash_bwd_dkv": NUM_LAYERS * ran}
    if counted != expected:
        raise AssertionError(f"{ran} MoE steps and two eval forwards launched "
                             f"{counted} != {expected}")
    log(f"[moe] loss/moe_aux {aux:.7f} finite; eval metrics {sorted(evals)} and eval "
        f"outputs {sorted(outputs)} carry no aux, nor the checkpoint's "
        f"{len(saved)} tensors; launches {counted} over {ran} steps and two eval "
        "forwards")
    for name, count in counted.items():
        launches[name] += count
    return launches


# -- grasp2vec: ResNet-50 embeddings trained from JPEG records ----------------------

# The flagship Grasp2Vec configuration: the model's defaults (ResNet-50,
# 472x472 crops of 512x640 JPEG sources, n-pairs loss) in float32, batch 8.
G2V_MODEL = dict(scene_size=(472, 472), goal_size=(472, 472), resnet_size=50)
G2V_BATCH = 8
G2V_CHECK_BATCH = 2
G2V_RECORDS = (48, 2, 16)
G2V_SOURCE = (512, 640)
# Card vs CPU at full width (TF32 off), a batch of 2: the card's float32
# embeddings, loss and batch-norm statistics within G2V_TOL of their max
# from the CPU's float32 ones. The gradients are held against the CPU in
# float64: at batch 2 the goal tower's train-mode batch norms make float32
# gradients of either device lie far from float64 (this phase on an H100
# 80GB HBM3 at 700 W: the card's worst leaf 9.035e-02 of its max, relative
# L2 1.454e-02; the CPU's 1.416e-01 and 1.577e-02), so card against CPU in
# float32 would compare two roundings. Each leaf within G2V_GRAD_TOL of its
# max (2.8x the card's reading); the relative L2 is printed.
G2V_TOL = 1e-4
G2V_GRAD_TOL = 0.25
G2V_SERVE_TOL = 1e-6


def grasp2vec_model(**kwargs):
    from tensor2robot_tpu_torch.research.grasp2vec import Grasp2VecModel

    return Grasp2VecModel(device_type="gpu", **G2V_MODEL, **kwargs)


def resnet_conv_flops(hw, resnet_size: int = 50, num_filters: int = 64) -> float:
    """Forward flops (2 a multiply-add) of the ResNet's convolutions and
    final dense layer on one image of size `hw`, from its shapes: the 7x7/2
    stem, the 3x3/2 SAME pool, then per block the 1x1/3x3/1x1 bottleneck
    (3x3/3x3 basic below 50) and each block layer's strided projection."""
    from tensor2robot_tpu_torch.layers.resnet import get_block_sizes

    h, w = hw
    flops = 0.0

    def conv(h, w, cin, cout, k, stride=1):
        nonlocal flops
        h, w = -(-h // stride), -(-w // stride)
        flops += 2.0 * h * w * cout * k * k * cin
        return h, w

    h, w = conv(h, w, 3, num_filters, 7, 2)
    h, w = -(-h // 2), -(-w // 2)
    bottleneck = resnet_size >= 50
    channels = num_filters
    for i, blocks in enumerate(get_block_sizes(resnet_size)):
        filters = num_filters * 2 ** i
        out = filters * (4 if bottleneck else 1)
        for j in range(blocks):
            stride = (1, 2, 2, 2)[i] if j == 0 else 1
            if j == 0:
                conv(h, w, channels, out, 1, stride)
            if bottleneck:
                conv(h, w, channels, filters, 1)
                h, w = conv(h, w, filters, filters, 3, stride)
                conv(h, w, filters, out, 1)
            else:
                h, w = conv(h, w, channels, filters, 3, stride)
                conv(h, w, filters, filters, 3)
            channels = out
    return flops + 2.0 * channels


def grasp2vec_train_flops(scene_size, goal_size, batch_size, resnet_size=50) -> float:
    """Flops of one Grasp2Vec train step: the pre, post and goal images'
    ResNet forwards, times 3 for forward and backward (the loss and the
    norms are not counted)."""
    per_example = (2 * resnet_conv_flops(scene_size, resnet_size)
                   + resnet_conv_flops(goal_size, resnet_size))
    return 3.0 * batch_size * per_example


def _g2v_step(model, weights, batch, device, dtype):
    """One train-mode forward and backward (center crops, no flips) from
    `weights` on a raw batch, in `dtype`: (loss, embeddings, gradients,
    batch-norm buffers) on the CPU."""
    import torch

    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    network = model.create_network()
    network.load_state_dict(weights)
    network = network.to(device=device, dtype=dtype)
    trainer = Trainer(model, device=device)
    features, _ = trainer.preprocess_train(to_device(batch, device))
    network.train()
    outputs = network({k: v.to(dtype) for k, v in features.items()}, "train")
    loss, _ = model.model_train_fn(features, None, outputs, "train")
    loss.backward()
    vectors = {k: outputs[k].detach().cpu().double()
               for k in ("pre_vector", "post_vector", "goal_vector")}
    grads = {k: p.grad.cpu().double() for k, p in network.named_parameters()
             if p.grad is not None}
    buffers = {k: b.detach().cpu().double() for k, b in network.named_buffers()}
    del network
    return loss.item(), vectors, grads, buffers


def _grad_distance(grads, ref) -> tuple:
    """(worst leaf's max error over its max, that leaf, relative L2 of the
    whole gradient) of `grads` against `ref`."""
    shares = {k: float((grads[k] - g).abs().max() / max(float(g.abs().max()), 1e-30))
              for k, g in ref.items()}
    worst = max(shares, key=shares.get)
    num = sum(float(((grads[k] - g) ** 2).sum()) for k, g in ref.items())
    den = sum(float((g ** 2).sum()) for g in ref.values())
    return shares[worst], worst, math.sqrt(num / den)


def grasp2vec_card_vs_cpu() -> str:
    """A batch of G2V_CHECK_BATCH at full width through the same seeded
    weights: the card in float32 against the CPU in float32 (forward,
    statistics) and in float64 (gradients)."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator

    model = grasp2vec_model()
    generator = DefaultRandomInputGenerator(batch_size=G2V_CHECK_BATCH, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    weights = model.init_network(torch.Generator().manual_seed(0), "cpu").state_dict()
    cpu32 = _g2v_step(model, weights, batch, "cpu", torch.float32)
    cpu64 = _g2v_step(model, weights, batch, "cpu", torch.float64)
    card = _g2v_step(model, weights, batch, DEVICE, torch.float32)
    loss_err = abs(card[0] - cpu32[0]) / abs(cpu32[0])
    if not loss_err <= G2V_TOL:
        raise AssertionError(f"grasp2vec card loss {card[0]} vs CPU {cpu32[0]}")
    parts = [f"loss {card[0]:.7f} vs {cpu32[0]:.7f} (rel {loss_err:.2e}; float64 "
             f"{cpu64[0]:.7f})"]
    for name, index in (("embeddings", 1), ("batch-norm statistics", 3)):
        if set(card[index]) != set(cpu32[index]):
            raise AssertionError(f"grasp2vec {name}: keys differ")
        shares = {k: _share(card[index][k], ref, G2V_TOL) for k, ref in cpu32[index].items()}
        key = max(shares, key=shares.get)
        if not shares[key] <= 1.0:
            raise AssertionError(f"grasp2vec {name}: {key} at {shares[key] * G2V_TOL:.3e} "
                                 f"of its max from the CPU's")
        parts.append(f"{name} worst {key} at {shares[key] * G2V_TOL:.2e} of its max")
    if set(card[2]) != set(cpu64[2]):
        raise AssertionError("grasp2vec gradients: keys differ")
    worst, key, l2 = _grad_distance(card[2], cpu64[2])
    if not worst <= G2V_GRAD_TOL:
        raise AssertionError(f"grasp2vec gradients: {key} at {worst:.3e} of its max from "
                             f"float64, relative L2 {l2:.3e}")
    cpu_worst, cpu_key, cpu_l2 = _grad_distance(cpu32[2], cpu64[2])
    parts.append(f"gradients vs float64: card worst {key} at {worst:.3e} of its max, "
                 f"relative L2 {l2:.3e} (the CPU's float32: {cpu_key} at {cpu_worst:.3e}, "
                 f"L2 {cpu_l2:.3e})")
    return "; ".join(parts)


def phase_grasp2vec(model_dir: str) -> None:
    """Grasp2Vec at full width: card vs CPU, 20 steps from JPEG records
    through train_eval_model, the step's cost, serving the checkpoint's
    embeddings, a heatmap and a triplet-loss step."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.predictors import CheckpointPredictor
    from tensor2robot_tpu_torch.research.grasp2vec import triplet_embedding_loss
    from tensor2robot_tpu_torch.research.grasp2vec.visualization import compute_heatmap
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.metrics import read_metrics
    from tensor2robot_tpu_torch.train.train_eval import (
        Trainer,
        restore_or_init_state,
        train_eval_model,
    )

    reset_launches()
    line = grasp2vec_card_vs_cpu()
    log(f"[grasp2vec] card vs CPU, batch {G2V_CHECK_BATCH} at full width "
        f"({G2V_MODEL}, f32, TF32 off): {line}")
    torch.cuda.empty_cache()

    model = grasp2vec_model()
    patterns, _, seconds = write_records(model, os.path.join(model_dir, "records"),
                                         G2V_RECORDS, G2V_SOURCE)
    t0 = time.monotonic()
    final_eval = train_eval_model(
        model,
        DefaultRecordInputGenerator(file_patterns=patterns["train"], batch_size=G2V_BATCH,
                                    seed=1),
        DefaultRecordInputGenerator(file_patterns=patterns["eval"], batch_size=G2V_BATCH),
        model_dir=model_dir, max_train_steps=TRAIN_STEPS, save_checkpoints_steps=SAVE_EVERY,
        eval_steps=1, log_every_steps=LOG_EVERY, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    steps = state_lib.checkpoint_steps(model_dir)
    losses = [r["loss"] for r in read_metrics(os.path.join(model_dir, "train"))]
    if (steps != [SAVE_EVERY, TRAIN_STEPS] or not all(math.isfinite(x) for x in losses)
            or set(final_eval) != {"loss", "embed_loss"}
            or not all(math.isfinite(v) for v in final_eval.values())):
        raise AssertionError(f"grasp2vec checkpoints {steps}, losses {losses}, "
                             f"eval {final_eval}")
    log(f"[grasp2vec] train_eval_model on {card_line()}: {TRAIN_STEPS} steps of batch "
        f"{G2V_BATCH} from {G2V_RECORDS[0]} JPEG records ({seconds:.1f}s to write), "
        f"checkpoints {steps}, in {wall:.1f}s; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; eval {final_eval}")

    trainer = Trainer(model, device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    records = DefaultRecordInputGenerator(file_patterns=patterns["eval"],
                                          batch_size=G2V_BATCH)
    records.set_specification_from_model(model, "eval")
    dataset = records.create_record_dataset("eval")
    try:
        host_batch = {k: torch.as_tensor(v).clone() for k, v in next(iter(dataset)).items()}
    finally:
        dataset.close()
    batch = to_device(host_batch, DEVICE)
    median, peak = _synced_step_ms(trainer, state, batch, TIMED_STEPS)
    flops = grasp2vec_train_flops(G2V_MODEL["scene_size"], G2V_MODEL["goal_size"],
                                  G2V_BATCH, G2V_MODEL["resnet_size"])
    achieved = flops / (median / 1e3)
    log(f"[grasp2vec] train step (batch {G2V_BATCH}, on-device batch, crops and flips "
        f"included) on {card_line()}: median {median:.3f} ms over {TIMED_STEPS} synced "
        f"steps = {1e3 / median:.3f} steps/s; peak memory allocated "
        f"{peak / 2**30:.3f} GiB; {flops / 1e12:.4f} TFLOP a step (analytic) -> "
        f"{achieved / 1e12:.2f} TFLOP/s, {100 * achieved / F32_ROUTES[SIMT_F32]:.1f}% of "
        "the f32 peak outside the tensor cores (TF32 off)")
    device_profile("grasp2vec train step", lambda: trainer.train_step(state, batch),
                   rows=15)

    # Serve the last checkpoint: the predictor's embeddings are the
    # in-process eval forward's on the restored weights.
    del state
    torch.cuda.empty_cache()
    restored = restore_or_init_state(model_dir, trainer)
    predictor = CheckpointPredictor(model, checkpoint_dir=model_dir, device=DEVICE)
    if not predictor.restore() or predictor.global_step != TRAIN_STEPS:
        raise AssertionError(f"grasp2vec predictor at step {predictor.global_step}")
    raw = {k[len("features/"):]: v for k, v in host_batch.items()
           if k.startswith("features/")}
    served = predictor.predict(raw)
    with torch.inference_mode():
        features, _ = model.preprocessor.preprocess(
            {k: v.to(DEVICE) for k, v in raw.items()}, None, mode="predict")
        direct = trainer.predict_step(restored.network, features)
    worst = 0.0
    for key, want in direct.items():
        want = want.cpu().numpy()
        err = float(np.abs(served[key] - want).max())
        if served[key].shape != want.shape or not err <= G2V_SERVE_TOL * np.abs(want).max():
            raise AssertionError(f"served {key} off the eval forward by {err}")
        worst = max(worst, err)
    heatmaps, softmaxed = compute_heatmap(torch.from_numpy(served["goal_vector"]),
                                          torch.from_numpy(served["pre_spatial"]))
    sums = softmaxed.sum(dim=(1, 2, 3))
    if (not torch.isfinite(heatmaps).all()
            or not torch.allclose(sums, torch.ones_like(sums), atol=1e-5)):
        raise AssertionError(f"grasp2vec heatmaps: softmax sums {sums}")
    log(f"[grasp2vec] CheckpointPredictor at step {predictor.global_step}: "
        f"{len(served)} outputs ({', '.join(f'{k} {tuple(v.shape)}' for k, v in sorted(served.items()))}) "
        f"within {worst:.3e} of the in-process eval forward; heatmaps "
        f"{tuple(heatmaps.shape)} finite, their softmax sums to 1")

    triplet = grasp2vec_model(embedding_loss_fn=triplet_embedding_loss)
    trainer = Trainer(triplet, device=DEVICE)
    state = trainer.init_state(params=restored.network.state_dict())
    del restored
    metrics = trainer.train_step(state, batch)
    loss = metrics["loss"].item()
    if not math.isfinite(loss):
        raise AssertionError(f"grasp2vec triplet step loss {loss}")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"grasp2vec launched flash kernels: {launches}")
    log(f"[grasp2vec] one triplet_embedding_loss step from step {TRAIN_STEPS}: loss "
        f"{loss:.6f}; flash launches {launches}")
    del state
    torch.cuda.empty_cache()


# -- vrgripper: the BC, TEC, WTL and MAML families at their defaults ---------------

# The VRGripper models at the JAX package's defaults (100x100 images cropped
# and resized from uint8 220x300 sources, episodes of 40 steps, action 7,
# gripper pose 14), float32, batches of VRG_BATCH episodes (VRG_TASKS tasks
# for the meta models), seed-0 weights. Card vs CPU (TF32 off, cuDNN
# deterministic): the loss within LOSS_TOL of the CPU's float32 loss, and
# each gradient against the CPU's float64 one, within the critic's float32
# limit (CRITIC_F32_GRAD_TOL of its leaf's max) or twice the CPU's own
# float32 distance from float64 on that leaf, whichever is larger. The meta
# phase's GRAD_TOL, set before the first card run, failed there: the
# regression model's float32 gradient lay 1.401e-04 of a leaf's max from
# the CPU's float32 one, the TEC's conv2 kernel 1.607e-04 of its max from
# float64 where the CPU's lay 1.059e-05 (cuDNN's float32 conv gradients
# round more than the CPU's, as the critic phase found), and leaves that
# sum ~10^5 cancelling terms (the conv biases before the towers' layer
# norms) lie 1.04e-02 of their max from float64 on either device.
VRG_BATCH = 8
VRG_TASKS = 4
VRG_STEPS = 10
VRG_SERVE_TOL = 1e-6


def vrgripper_models() -> dict:
    """name -> a fresh model of each trained family."""
    from tensor2robot_tpu_torch.research import vrgripper

    def maml():
        return vrgripper.VRGripperEnvRegressionModelMAML(
            base_model=vrgripper.VRGripperRegressionModel(device_type="gpu"),
            num_inner_loop_steps=1, use_second_order=True)

    return {
        "regression_mse": lambda: vrgripper.VRGripperRegressionModel(device_type="gpu"),
        "regression_mdn3": lambda: vrgripper.VRGripperRegressionModel(
            num_mixture_components=3, device_type="gpu"),
        "domain_adaptive": lambda: vrgripper.VRGripperDomainAdaptiveModel(device_type="gpu"),
        "tec": lambda: vrgripper.VRGripperEnvTecModel(embed_loss_weight=0.1,
                                                      device_type="gpu"),
        "wtl_trial": lambda: vrgripper.VRGripperEnvSimpleTrialModel(device_type="gpu"),
        "maml_second_order": maml,
    }


def _random_batch(model, batch_size: int, seed: int):
    from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator

    generator = DefaultRandomInputGenerator(batch_size=batch_size, seed=seed)
    generator.set_specification_from_model(model, "train")
    return next(iter(generator.create_dataset("train")))


def _backward_on(model, weights, batch, device, dtype):
    """(loss, {name: gradient} on the CPU in float64) of one train-mode
    backward (no random crop) from `weights`, computed in `dtype`."""
    import torch

    from tensor2robot_tpu_torch.specs import TensorSpecStruct
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    def cast(structure):
        return TensorSpecStruct({k: v.to(dtype) if v.is_floating_point() else v
                                 for k, v in structure.items()})

    trainer = Trainer(model, device=device)
    network = trainer.init_state(params=weights).network.to(dtype)
    features, labels = trainer.preprocess_train(to_device(batch, device))
    features, labels = cast(features), cast(labels)
    network.train()
    outputs, _ = model.inference_network_fn(network, features, "train", labels=labels)
    loss, _ = model.model_train_fn(features, labels, outputs, "train")
    loss.backward()
    return loss.item(), {k: p.grad.detach().cpu().double()
                         for k, p in network.named_parameters() if p.grad is not None}


def card_vs_cpu_backward(make_model, batch) -> str:
    """One train-mode backward from the same seed-0 weights on the same
    batch, on the card and on the CPU: the card's loss within LOSS_TOL
    relative of the CPU's float32 loss, and every gradient within
    max(CRITIC_F32_GRAD_TOL, twice the CPU's float32 distance) of its
    leaf's max from the CPU's float64 gradient."""
    import torch

    model = make_model()
    weights = model.init_network(torch.Generator().manual_seed(0), "cpu").state_dict()
    want, cpu_grads = _backward_on(model, weights, batch, "cpu", torch.float32)
    _, ref = _backward_on(model, weights, batch, "cpu", torch.float64)
    got, got_grads = _backward_on(model, weights, batch, DEVICE, torch.float32)
    loss_err = abs(got - want) / abs(want)
    if not loss_err <= LOSS_TOL or not set(got_grads) == set(cpu_grads) == set(ref):
        raise AssertionError(f"card loss {got} vs CPU {want}")

    def distance(grads, key):
        return float((grads[key] - ref[key]).abs().max() / max(float(ref[key].abs().max()),
                                                               1e-30))

    card = {k: distance(got_grads, k) for k in ref}
    cpu = {k: distance(cpu_grads, k) for k in ref}
    for key in ref:
        allowance = max(CRITIC_F32_GRAD_TOL, 2.0 * cpu[key])
        if not card[key] <= allowance + 1e-7 / max(float(ref[key].abs().max()), 1e-30):
            raise AssertionError(f"{key}: the card's gradient lies {card[key]:.3e} of its "
                                 f"max from float64, the CPU's float32 {cpu[key]:.3e}")
    worst = max(card, key=card.get)
    return (f"loss {got:.7f} vs {want:.7f} (rel {loss_err:.2e}); gradients vs float64: "
            f"card worst {worst} at {card[worst]:.2e} of its max (the CPU's float32 there "
            f"{cpu[worst]:.2e}, its worst {max(cpu.values()):.2e})")


def phase_vrgripper(model_dir: str) -> None:
    """Each VRGripper family: card vs CPU, then steps on the card; the MSE
    regression model through train_eval_model and served from its
    checkpoint."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator
    from tensor2robot_tpu_torch.predictors import CheckpointPredictor
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import (
        Trainer,
        restore_or_init_state,
        train_eval_model,
    )

    reset_launches()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, make_model in vrgripper_models().items():
            meta = name in ("tec", "wtl_trial", "maml_second_order")
            batch = _random_batch(make_model(), VRG_TASKS if meta else VRG_BATCH, seed=0)
            line = card_vs_cpu_backward(make_model, batch)
            trainer = Trainer(make_model(), device=DEVICE)
            state = trainer.init_state(torch.Generator().manual_seed(0))
            device_batch = to_device(batch, DEVICE)
            median, peak = _synced_step_ms(trainer, state, device_batch, VRG_STEPS)
            loss = trainer.train_step(state, device_batch)["loss"].item()
            if not math.isfinite(loss):
                raise AssertionError(f"{name} loss {loss}")
            log(f"[vrgripper] {name} ({VRG_TASKS if meta else VRG_BATCH} "
                f"{'tasks' if meta else 'episodes'} of 40 steps): card vs CPU {line}; "
                f"synced step on {card_line()}: median {median:.3f} ms over {VRG_STEPS} = "
                f"{1e3 / median:.3f} steps/s, peak {peak / 2**30:.3f} GiB; loss after "
                f"{VRG_STEPS + 3} steps {loss:.6f}")
            if name == "maml_second_order":
                device_profile("vrgripper MAML second-order step",
                               lambda: trainer.train_step(state, device_batch))
            del state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # The MSE regression model through the trainer, served from its checkpoint.
    model = vrgripper_models()["regression_mse"]()
    t0 = time.monotonic()
    final_eval = train_eval_model(
        model, DefaultRandomInputGenerator(batch_size=VRG_BATCH, seed=0),
        DefaultRandomInputGenerator(batch_size=VRG_BATCH, seed=1000), model_dir=model_dir,
        max_train_steps=VRG_STEPS, save_checkpoints_steps=VRG_STEPS // 2, eval_steps=1,
        log_every_steps=VRG_STEPS // 2, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    steps = state_lib.checkpoint_steps(model_dir)
    if steps != [VRG_STEPS // 2, VRG_STEPS] or not all(
            math.isfinite(v) for v in final_eval.values()):
        raise AssertionError(f"vrgripper checkpoints {steps}, eval {final_eval}")
    predictor = CheckpointPredictor(model, checkpoint_dir=model_dir, device=DEVICE)
    if not predictor.restore() or predictor.global_step != VRG_STEPS:
        raise AssertionError(f"vrgripper predictor at step {predictor.global_step}")
    raw = {k[len("features/"):]: v for k, v in _random_batch(model, 2, seed=5).items()
           if k.startswith("features/")}
    served = predictor.predict(raw)
    trainer = Trainer(model, device=DEVICE)
    restored = restore_or_init_state(model_dir, trainer)
    with torch.inference_mode():
        features, _ = model.preprocessor.preprocess(
            {k: torch.as_tensor(v).to(DEVICE) for k, v in raw.items()}, None,
            mode="predict")
        direct = trainer.predict_step(restored.network, features)
    action = direct["inference_output"].cpu().numpy()
    err = float(np.abs(served["inference_output"] - action).max())
    if served["inference_output"].shape != (2, 40, 7) or not err <= VRG_SERVE_TOL:
        raise AssertionError(f"served actions off the eval forward by {err}")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"vrgripper launched flash kernels: {launches}")
    log(f"[vrgripper] regression_mse train_eval_model on {card_line()}: {VRG_STEPS} steps "
        f"of batch {VRG_BATCH}, checkpoints {steps}, in {wall:.1f}s; eval {final_eval}; "
        f"CheckpointPredictor at step {predictor.global_step}: actions "
        f"{served['inference_output'].shape} within {err:.3e} of the in-process eval "
        f"forward; flash launches {launches}")


# -- the maml_export phase: MAML models exported and served ---------------------

# The shipped run_train_reg_maml.gin model (8 tasks of 3 condition + 3
# inference samples at 64x64) is exported as static-batch programs at one
# task (a robot) and the meta batch, VRGripper's MAML model (JAX defaults)
# at VRG_TASKS, and the policy's model (FixedLenMetaExamplePreprocessor, one
# sample a side) at one task. Each program is held to the same weights'
# checkpoint forward under SERVE_TOL (the served-action gate, set before
# the first card run).
MAML_EXPORT_BATCHES = (1, META_TASKS)
MAML_TIMED_PREDICTS = 5


def _flat_request(generator, tasks: int, seed: int) -> dict:
    from tensor2robot_tpu_torch.specs import make_random_numpy

    return dict(make_random_numpy(generator.serving_input_spec(), batch_size=tasks,
                                  seed=seed).items())


def _synced_call_ms(fn, iters: int) -> float:
    """Median ms of `fn()` over iters synced calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def export_maml(label: str, model, root: str, batches, tasks: int, warmup: bool = True,
                timed=()):
    """Exports seed-0 weights of a MAML model as one program per batch in
    `batches` (with the warmup ladder, and its requests unless `warmup` is
    False: the record encoder, as the JAX package's, writes a stack of
    images but not a stack of image sequences), holds the program against
    the checkpoint forward on `tasks` tasks and times both at the task
    counts in `timed`; returns the export dir and the weights."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.export import saved_model
    from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
    from tensor2robot_tpu_torch.predictors import CheckpointPredictor

    weights = model.init_network(torch.Generator().manual_seed(0), DEVICE).state_dict()
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    serving = generator.create_serving_fn(weights, device=torch.device(DEVICE))
    t0 = time.monotonic()
    path = saved_model.save_exported_model(
        root, weights, generator.serving_input_spec(), serving_module=serving,
        example_features=generator.create_example_features(),
        metadata={"warmup_batch_sizes": list(batches)}, program_batches=batches)
    export_s = time.monotonic() - t0
    if warmup:
        generator.write_warmup_requests(generator.generate_warmup_batches(batches), path)
    t0 = time.monotonic()
    loaded = saved_model.ExportedModel(path, device=DEVICE)
    load_s = time.monotonic() - t0
    if not loaded.has_program or loaded.program_batches != sorted(batches):
        raise AssertionError(f"{label} export has no programs at {batches}: "
                             f"{loaded.metadata.get('program_error')}")
    reference = CheckpointPredictor(model, device=DEVICE)
    reference.load_state_dict(weights)
    request = _flat_request(generator, tasks, seed=1)
    got, want = loaded.predict(request), reference.predict(request)
    worst = 0.0
    for key in ("inference_output", "condition_output"):
        err = np.abs(got[key] - want[key]) / (SERVE_TOL * (1.0 + np.abs(want[key])))
        worst = max(worst, float(err.max()))
        if got[key].shape != want[key].shape or not np.all(np.isfinite(got[key])):
            raise AssertionError(f"{label} {key}: {got[key].shape} vs {want[key].shape}")
    if not worst <= 1.0:
        raise AssertionError(f"{label} export off the checkpoint forward at {worst:.3f} "
                             f"of {SERVE_TOL} abs + rel")
    times = {}
    for size in timed:
        one = {k: torch.as_tensor(v[:size]).to(DEVICE) for k, v in request.items()}
        times[size] = (
            _synced_call_ms(lambda: loaded.traced_predict(one), MAML_TIMED_PREDICTS),
            _synced_call_ms(lambda: serving(one), MAML_TIMED_PREDICTS))
    mb = sum(os.path.getsize(saved_model.static_program_path(path, b))
             for b in batches) / 1e6
    log(f"[maml_export] {label} on {card_line()}: programs at batches {list(batches)} "
        f"traced (make_fx, inner backward included) and saved in {export_s:.1f}s "
        f"({mb:.1f} MB), loaded in {load_s:.1f}s; {tasks} task(s) within {worst:.3f} of "
        f"the {SERVE_TOL} abs + rel gate of the checkpoint forward"
        + "".join(f"; warm predict of {size} task(s) {ms:.3f} ms, the eager module "
                  f"{eager:.3f} ms (median of {MAML_TIMED_PREDICTS} synced)"
                  for size, (ms, eager) in times.items()))
    return os.path.dirname(path), weights


def maml_policy_from_export(root: str, model, weights) -> None:
    """A MAML policy episode on PoseToyEnv from the export, acting as the
    same weights' checkpoint policy does."""
    import numpy as np

    from tensor2robot_tpu_torch.meta_learning import MAMLRegressionPolicy, run_meta_env
    from tensor2robot_tpu_torch.predictors import (
        CheckpointPredictor,
        ExportedSavedModelPredictor,
    )
    from tensor2robot_tpu_torch.research.pose_env import PoseToyEnv

    predictor = ExportedSavedModelPredictor(root, timeout=0, device=DEVICE)
    if not predictor.restore() or not predictor.loaded_model.has_program:
        raise AssertionError("the MAML policy export did not restore with its program")
    policy = MAMLRegressionPolicy(predictor, pack_fn=unbatched_pack(model.pack_features))
    env = _RecordedEnv(PoseToyEnv(hidden_drift=True, seed=3))
    t0 = time.monotonic()
    stats = run_meta_env(env, policy, num_tasks=1, num_adaptations_per_task=2)
    env_s = time.monotonic() - t0
    actions = np.stack(env.actions)
    if not np.all(np.isfinite(actions)) or not np.all(np.abs(actions) <= 1.0):
        raise AssertionError(f"policy actions {actions}")
    reference = CheckpointPredictor(model, device=DEVICE)
    reference.load_state_dict(weights)
    twin = MAMLRegressionPolicy(reference, pack_fn=unbatched_pack(model.pack_features))
    twin.adapt(policy.prev_episode_data)
    obs = env.reset()
    action, want = policy.SelectAction(obs), twin.SelectAction(obs)
    gap = float(np.max(np.abs(action - want) / (1.0 + np.abs(want))))
    if not gap <= SERVE_TOL:
        raise AssertionError(f"export policy action {action} vs checkpoint {want}")
    log(f"[maml_export] MAML policy from the export on {card_line()}: run_meta_env 1 "
        f"task x 2 adaptations in {env_s:.2f}s ("
        + ", ".join(f"{k.split('/', 1)[1]} {v:.6f}" for k, v in sorted(stats.items()))
        + f"); action vs the checkpoint policy's {gap:.2e}")


def phase_maml_export(model_dir: str) -> None:
    from tensor2robot_tpu_torch.meta_learning import FixedLenMetaExamplePreprocessor

    reset_launches()
    export_maml("pose MAML (run_train_reg_maml.gin model, 3 + 3 samples at 64x64)",
                meta_model(), os.path.join(model_dir, "pose"), MAML_EXPORT_BATCHES,
                META_TASKS, timed=(1, META_TASKS))
    export_maml("VRGripper MAML (JAX defaults)", vrgripper_models()["maml_second_order"](),
                os.path.join(model_dir, "vrgripper"), (VRG_TASKS,), VRG_TASKS, warmup=False,
                timed=(VRG_TASKS,))
    policy_model = meta_model(preprocessor_cls=FixedLenMetaExamplePreprocessor)
    root, weights = export_maml("pose MAML policy model (1 + 1 samples)", policy_model,
                                os.path.join(model_dir, "policy"), (1,), 1)
    maml_policy_from_export(root, policy_model, weights)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"maml_export launched flash kernels: {launches}")


# -- the stem_s2d phase: the space-to-depth stem and PCGrad on the critic --------

# The S2D stem's output against the plain stem's on the same weights: the
# CPU tests' float32 limit (tests/test_torch_s2d_conv.py), of the output's
# largest magnitude; the critic's eval-mode logits under SERVE_TOL of
# their largest, on weights of a trained critic's scale (scaled_params:
# the package's init leaves the logits at ~0). The PCGrad step's gradients against the CPU's, every relu and
# pool pinned to the card's choices, under CRITIC_F32_GRAD_TOL of each
# leaf's largest (those 0 in exact arithmetic: ZERO_GRAD of the largest).
S2D_STEM_TOL = 2e-5
S2D_STEPS = 5
PCGRAD_BATCH = 4


@contextlib.contextmanager
def stem_flag(s2d: bool):
    """T2R_STEM_S2D set while a critic network is built (the stem is chosen
    then)."""
    saved = os.environ.get("T2R_STEM_S2D")
    os.environ["T2R_STEM_S2D"] = "1" if s2d else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("T2R_STEM_S2D", None)
        else:
            os.environ["T2R_STEM_S2D"] = saved


def s2d_stem_check() -> None:
    """The S2D stem against the plain one on the same weights (seeded at a
    trained critic's scale, scaled_params) and batch: the stem's output
    and the eval-mode logits; then S2D_STEPS train steps with S2D and a
    synced step of each stem."""
    import torch

    from tensor2robot_tpu_torch.layers.s2d_conv import SpaceToDepthConv
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model = critic_model()
    batch = to_device(_random_batch(model, CRITIC_BATCH, seed=3), DEVICE)
    stems, logits, states, trainers = {}, {}, {}, {}
    weights = None
    for name in ("plain", "s2d"):
        with stem_flag(name == "s2d"):
            trainers[name] = Trainer(critic_model(), device=DEVICE)
            if weights is None:
                weights = scaled_params(trainers[name].init_state(
                    torch.Generator().manual_seed(0)).network.state_dict())
            states[name] = trainers[name].init_state(params=weights)
        network = states[name].network
        if isinstance(network.grasping44.conv1_1, SpaceToDepthConv) != (name == "s2d"):
            raise AssertionError(f"the {name} critic built another stem")
        with torch.no_grad():
            features, _ = trainers[name].preprocessor.preprocess(
                batch["features"], None, mode="eval")
            stems[name] = network.grasping44.conv1_1(
                features["state/image"].permute(0, 3, 1, 2))
            logits[name] = network(features, "eval")["q_predicted"]

    def share(values):
        return float((values["s2d"] - values["plain"]).abs().max()
                     / values["plain"].abs().max())

    stem_err, logit_err = share(stems), share(logits)
    if not stem_err <= S2D_STEM_TOL or not logit_err <= SERVE_TOL:
        raise AssertionError(f"S2D stem off the plain stem: {stem_err:.3e} of the "
                             f"stem's max, logits {logit_err:.3e}")
    losses = [trainers["s2d"].train_step(states["s2d"], batch)["loss"].item()
              for _ in range(S2D_STEPS)]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"S2D critic losses {losses}")
    timed = {name: _synced_step_ms(trainers[name], states[name], batch, S2D_STEPS)
             for name in ("plain", "s2d")}
    log(f"[stem_s2d] critic (batch {CRITIC_BATCH}, {CRITIC['image_size'][0]}x"
        f"{CRITIC['image_size'][1]}, f32, TF32 off) on {card_line()}: S2D stem vs plain "
        f"on the same weights {stem_err:.3e} of the stem's max (limit {S2D_STEM_TOL}), "
        f"eval logits {logit_err:.3e} of their max (limit {SERVE_TOL}); {S2D_STEPS} S2D "
        f"steps, losses " + ", ".join(f"{v:.6f}" for v in losses) + "; synced step "
        + ", ".join(f"{name} {ms:.3f} ms (peak {peak / 2**30:.3f} GiB)"
                    for name, (ms, peak) in timed.items())
        + f" (median of {S2D_STEPS})")


def critic_pcgrad(model, weights, batch, device, routing_context):
    """One PCGrad step of the critic with its loss split into two tasks (the
    halves of the batch, center crop): (losses, the combined gradients by
    flax path as float64 on the CPU)."""
    import torch

    from tensor2robot_tpu_torch.research.qtopt import pcgrad
    from tensor2robot_tpu_torch.specs import TensorSpecStruct
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer
    from tensor2robot_tpu_torch.utils.keypath import flax_parameter_paths

    trainer = Trainer(model, device=device)
    network = trainer.init_state(params=weights).network
    on_device = to_device(batch, device)
    features, labels = trainer.preprocessor.preprocess(
        on_device["features"], on_device["labels"], mode="train")
    names = {path: name for name, path in flax_parameter_paths(network).items()}
    params = {path: dict(network.named_parameters())[name] for path, name in names.items()}
    half = len(labels["reward"]) // 2

    def task(part):
        f = TensorSpecStruct({k: v[part] for k, v in features.items()})
        lab = TensorSpecStruct({k: v[part] for k, v in labels.items()})

        def loss(p):
            outputs = torch.func.functional_call(
                network, {names[k]: v for k, v in p.items()}, (f, "train"))
            return model.model_train_fn(f, lab, outputs, "train")[0]
        return loss

    with routing_context:
        total, grads = pcgrad.pcgrad_gradients(
            [task(slice(0, half)), task(slice(half, None))], params)
    return float(total), {k: v.detach().double().cpu() for k, v in grads.items()}


def pcgrad_card_vs_cpu() -> None:
    """PCGrad over the full-width critic's loss split into two tasks, on
    the card and on the CPU from the same weights and batch."""
    import torch

    from tensor2robot_tpu_torch.research.qtopt.routing import pinned_routing, record_routing
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model = critic_model()
    weights = {k: v.cpu() for k, v in Trainer(model, device="cpu").init_state(
        torch.Generator().manual_seed(0)).network.state_dict().items()}
    batch = _random_batch(model, PCGRAD_BATCH, seed=5)
    t0 = time.monotonic()
    with record_routing() as routing:
        card_loss, card = critic_pcgrad(model, weights, batch, DEVICE,
                                        contextlib.nullcontext())
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    cpu_loss, cpu = critic_pcgrad(model, weights, batch, "cpu",
                                  pinned_routing(routing.to("cpu")))
    largest = max(g.abs().max().item() for g in cpu.values())
    worst, worst_name, zeros = 0.0, None, 0
    for name, ref in cpu.items():
        scale = ref.abs().max().item()
        if scale <= ZERO_GRAD * largest:
            zeros += 1
            share = card[name].abs().max().item() / (ZERO_GRAD * largest)
        else:
            share = (card[name] - ref).abs().max().item() / (
                CRITIC_F32_GRAD_TOL * scale + 1e-7)
        if share > worst:
            worst, worst_name = share, name
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not worst <= 1.0 or not loss_err <= LOSS_TOL:
        raise AssertionError(f"PCGrad card vs CPU: {worst_name} at {worst:.3f} of its "
                             f"allowance, loss rel {loss_err:.2e}")
    log(f"[stem_s2d] PCGrad step (critic loss split into 2 tasks of "
        f"{PCGRAD_BATCH // 2}, full width) on {card_line()} in {card_s:.2f}s: card vs "
        f"CPU (relus and pools pinned to the card's choices) loss {card_loss:.7f} vs "
        f"{cpu_loss:.7f} (rel {loss_err:.2e}); combined gradients worst {worst_name} at "
        f"{worst:.3f} of its allowance ({CRITIC_F32_GRAD_TOL} of the leaf's max; {zeros} "
        f"leaves 0 in exact arithmetic held to {ZERO_GRAD} of the largest)")


def phase_stem_s2d(model_dir: str) -> None:
    del model_dir
    reset_launches()
    s2d_stem_check()
    pcgrad_card_vs_cpu()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"stem_s2d launched flash kernels: {launches}")


# -- the png phase: PNG image records feeding the critic ----------------------------

# (train records, shards, eval records) of 512x640 PNG sources; fed steps.
PNG_RECORDS = (64, 2, 8)
PNG_STEPS = 5
PNG_BATCHES = 8


def time_decoders(frames) -> str:
    """One thread's decode MB/s (decoded bytes) of the frames as PNG and as
    q95 JPEG through the codec; PNG must give the frames back exactly."""
    import numpy as np

    from tensor2robot_tpu_torch.data import codec

    pngs = [codec.encode_image(f, "png") for f in frames]
    jpegs = [codec.encode_jpeg(f, quality=95) for f in frames]
    out = np.empty_like(frames[0])
    rates = {}
    for name, blobs in (("PNG", pngs), ("JPEG", jpegs)):
        codec.decode_into(blobs[0], out)
        t0 = time.perf_counter()
        for data, frame in zip(blobs, frames):
            codec.decode_into(data, out)
            if name == "PNG" and not np.array_equal(out, frame):
                raise AssertionError("a PNG decode differs from its source frame")
        rates[name] = (len(blobs) * frames[0].nbytes / (time.perf_counter() - t0) / 1e6,
                       sum(map(len, blobs)) / len(blobs) / 1e3)
    return ", ".join(f"{name} {mbs:.1f} MB/s ({kb:.1f} KB a file)"
                     for name, (mbs, kb) in rates.items())


def phase_png(model_dir: str) -> None:
    """Writes 512x640 RGB PNG records of the critic's in-spec through the
    port's encoder, reads them back bit for bit, feeds the critic from them
    through RecordDataset, and times PNG decode beside JPEG's."""
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.data import codec, png
    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.data.parser import SpecParser
    from tensor2robot_tpu_torch.specs import TensorSpecStruct
    from tensor2robot_tpu_torch.train import infeed
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    def png_record(image_spec, data):
        from tensor2robot_tpu_torch.data.encoder import encode_example

        return encode_example(TensorSpecStruct({"features/state/image": image_spec}),
                              {"features/state/image": data})

    reset_launches()
    codec.COUNTS.reset()
    model = critic_model()
    spec = model.preprocessor.get_in_feature_specification("train")["state/image"]
    source_hw = tuple(spec.shape[:2])
    patterns, (frames, _, pngs), write_s = write_records(
        model, model_dir, PNG_RECORDS, source_hw, image_format="png")
    if codec.COUNTS.png_encodes != sum(PNG_RECORDS[::2]) or not png.is_png(pngs[0]):
        raise AssertionError(f"{codec.COUNTS.png_encodes} PNG encodes")
    parsed = SpecParser(TensorSpecStruct({"features/state/image": spec})).parse_batch(
        [png_record(spec, data) for data in pngs[:4]])
    if not np.array_equal(np.asarray(parsed["features/state/image"]), frames[:4]):
        raise AssertionError("parsed PNG records differ from their frames")
    rates = time_decoders(frames[:16])

    generator = DefaultRecordInputGenerator(file_patterns=patterns["train"],
                                            batch_size=CRITIC_BATCH, seed=0)
    generator.set_specification_from_model(model, "train")
    dataset = generator.create_record_dataset("train")
    it = iter(dataset)
    next(it)
    t0 = time.perf_counter()
    for _ in range(PNG_BATCHES):
        next(it)
    records_s = PNG_BATCHES * CRITIC_BATCH / (time.perf_counter() - t0)
    trainer = Trainer(model, device=DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    fed = infeed.device_prefetch(it, DEVICE, depth=infeed.resolve_depth())
    t0 = time.perf_counter()
    losses = [trainer.train_step(state, next(fed))["loss"].item() for _ in range(PNG_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / PNG_STEPS * 1e3
    dataset.close()
    if not all(math.isfinite(v) for v in losses) or not codec.COUNTS.png_decodes:
        raise AssertionError(f"critic from PNG records: losses {losses}, "
                             f"{codec.COUNTS.png_decodes} PNG decodes")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"png launched flash kernels: {launches}")
    log(f"[png] {sum(PNG_RECORDS[::2])} records of {source_hw[0]}x{source_hw[1]} RGB "
        f"PNG sources written in "
        f"{write_s:.1f}s, parsed back bit for bit; decode on one thread: {rates}; "
        f"RecordDataset (ROI crops of whole PNG decodes, batch {CRITIC_BATCH}) "
        f"{records_s:.1f} records/s; {PNG_STEPS} critic steps fed from PNG records on "
        f"{card_line()}: {step_ms:.3f} ms a step with the feed, losses "
        + ", ".join(f"{v:.6f}" for v in losses)
        + f"; {codec.COUNTS.png_decodes} PNG decodes, flash launches {launches}")


# -- parallel: sequence- and data-parallel BC over 4 gloo ranks on one card ---------

# 4 ranks as processes sharing cuda:0 (a card holds one NCCL rank at most,
# so they join a gloo group and collectives.py stages the CUDA tensors
# they exchange through pinned host buffers). The regimes: (mode, window,
# B1 = B3 = B4 launches a rank a step: 4 layers x the ring's hops, or one
# per layer for Ulysses' local flash attention).
PARALLEL_RANKS = 4
PARALLEL_REGIMES = {
    "ring": ("ring", None, NUM_LAYERS * 4),
    "ulysses": ("ulysses", None, NUM_LAYERS),
    "ring_window300": ("ring", 300, NUM_LAYERS * 3),
}
# Timed steps of each sequence regime and of the pipelined step (3 since
# the planner's sub-phase, parallel_plan, joined the run; 2 since the
# serve_quant phase did).
PARALLEL_TIMED_STEPS = 2
# train_eval_model on a 2 x 2 data x sequence mesh: steps, checkpoint
# interval and eval batches (4 steps hold the whole run near 750 s).
PARALLEL_TRAIN = dict(steps=4, save_every=2, eval_steps=1)
PARALLEL_TIMEOUT = 600
# Pipelined BC at the BC width: a 2 data x 2 pipe mesh (2 blocks a stage,
# the default 4 microbatches of 1 episode a rank), the sequence x pipe
# mesh of the ring-in-pipe step, and train_eval_model's first run (steps,
# checkpoint interval, eval batches) before its resume to 2 x steps.
PARALLEL_PIPE = dict(mesh=(2, 2), ring=(2, 2), train=dict(steps=2, save_every=2,
                                                          eval_steps=1))
# The ranks' device: the card, shared (a CPU rehearsal passes "cpu").
PARALLEL_DEVICE = "cuda:0"
# Per-rank state of a parallel-phase child: its meshes, one per shape.
_RANK_MESHES = {}


def _parallel_spec() -> dict:
    """What the ranks run, from this process's settings: spawned ranks
    import this file afresh, so they take their sizes from here."""
    return dict(device=PARALLEL_DEVICE, model=bc_model_kwargs(True),
                batch=SLICE["batch"], layers=NUM_LAYERS, timed=PARALLEL_TIMED_STEPS,
                regimes=PARALLEL_REGIMES, train=PARALLEL_TRAIN,
                critic=dict(PARALLEL_CRITIC), moe=dict(PARALLEL_MOE),
                pipe=dict(PARALLEL_PIPE), zero2=dict(PARALLEL_ZERO2),
                sharded=dict(PARALLEL_SHARDED), composed=dict(PARALLEL_COMPOSED),
                three_d=dict(PARALLEL_3D), moe_sequence=dict(PARALLEL_MOE_SEQUENCE),
                maml=dict(PARALLEL_MAML), plan=dict(PARALLEL_PLAN))


def _rank_setup(spec: dict, data: int, sequence: int, fsdp: int = 1, expert: int = 1,
                pipe: int = 1, model: int = 1):
    """A rank's f32 settings (as main() sets them) and its mesh. On the
    CPU (a rehearsal) the kernels' plain versions count as their kernels
    would, so the launch checks run as on the card."""
    from tensor2robot_tpu_torch.ops import flash_attention as fa
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    _f32_only()
    if spec["device"] == "cpu" and not _RANK_MESHES:
        def counted(fn, *kernels):
            def run(*args, **kwargs):
                for kernel in kernels:
                    fa.KERNELS[kernel].launches += 1
                return fn(*args, **kwargs)
            return run

        fa.flash_attention_plain = counted(fa.flash_attention_plain, "flash_fwd")
        fa.flash_attention_tile_plain = counted(fa.flash_attention_tile_plain,
                                                "flash_fwd_tile")
        fa.flash_attention_bwd_plain = counted(fa.flash_attention_bwd_plain,
                                               "flash_bwd_dq", "flash_bwd_dkv")
    key = (data, sequence, fsdp, expert, pipe, model)
    if key not in _RANK_MESHES:
        _RANK_MESHES[key] = mesh_lib.make_mesh(data=data, fsdp=fsdp, model=model,
                                               sequence=sequence, expert=expert, pipe=pipe)
    return _RANK_MESHES[key]


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _peak_gib(device: str) -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if device.startswith("cuda") else 0.0


def _bc_batch(model, batch_size: int, seed: int):
    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )

    generator = DefaultRandomInputGenerator(batch_size=batch_size, seed=seed)
    generator.set_specification_from_model(model, "train")
    return next(iter(generator.create_dataset("train")))


def parallel_rank_regime(spec: dict, regime: str) -> dict:
    """On every rank (sequence = 4): one step's loss and every gradient,
    averaged over the ranks by the trainer's bucket, and one eval forward;
    rank 0 holds them against the single-device flash step and forward on
    the same weights and batch. Then the synced step (median of 3), peak
    memory and staged bytes a step. Returns the rank's numbers and the
    launches its main-path calls made."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import collectives
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    mesh = _rank_setup(spec, 1, PARALLEL_RANKS)
    mode, window, per_step = spec["regimes"][regime]
    layers, device = spec["layers"], spec["device"]
    kwargs = dict(spec["model"], attention_window=window)
    model = TransformerBCModel(mesh=mesh, sequence_parallel_mode=mode, **kwargs)
    trainer = Trainer(model, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    host = _bc_batch(model, spec["batch"], seed=0)
    batch = to_device(mesh_lib.shard_batch(host, mesh), device)
    rank = dist.get_rank()
    out = {"rank": rank, "launches": {k: 0 for k in read_launches()}}

    def counted(fn):
        reset_launches()
        result = fn()
        _sync(device)
        for name, count in read_launches().items():
            out["launches"][name] += count
        return result, read_launches()

    network = state.network
    network.train()

    def step():
        features, labels = trainer.preprocess_train(batch)
        loss, metrics = trainer.backward(network, features, labels)
        return trainer.average_over_ranks(network, loss, metrics)[0]

    loss, launches = counted(step)
    want = {"flash_fwd": 0, "flash_fwd_tile": per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step}
    if launches != want:
        raise AssertionError(f"rank {rank} {regime} step launched {launches} != {want}")
    grads = {n: p.grad.detach().clone() for n, p in network.named_parameters()}
    network.zero_grad(set_to_none=True)
    with torch.inference_mode():
        network.eval()
        features, _ = trainer.preprocessor.preprocess(batch["features"], None, mode="eval")
        (action, launches) = counted(
            lambda: model.packed_inference(network, features, "eval")[2]["inference_output"])
    eval_want = ({"flash_fwd": layers, "flash_fwd_tile": 0} if mode == "ulysses"
                 else {"flash_fwd": 0, "flash_fwd_tile": per_step})
    eval_want.update(flash_bwd_dq=0, flash_bwd_dkv=0)
    if launches != eval_want:
        raise AssertionError(f"rank {rank} {regime} eval launched {launches} != {eval_want}")
    if rank == 0:
        out.update(_single_device_reference(kwargs, device, state.network.state_dict(),
                                            batch, loss, grads, action))
    del grads, action
    dist.barrier()

    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    times, staged = [], []
    for i in range(2 + spec["timed"]):
        collectives.reset_staged_bytes()
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        _, launches = counted(lambda: trainer.train_step(state, batch))
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
            staged.append(collectives.staged_bytes())
        if launches != want:
            raise AssertionError(f"rank {rank} {regime} train step launched {launches}")
    out.update(
        step_ms=sorted(times)[len(times) // 2], step_min=min(times),
        step_max=max(times), peak_gib=_peak_gib(device),
        staged_mb=sorted(staged)[len(staged) // 2] / 1e6,
    )
    # Where a step's time goes on the card: rank 0 profiles the second of
    # two steps (device_profile runs two) while the other ranks step.
    reset_launches()
    if rank == 0 and device.startswith("cuda"):
        device_profile(f"{regime} train step, rank 0 of {PARALLEL_RANKS} sharing the card",
                       lambda: trainer.train_step(state, batch), rows=8)
    else:
        for _ in range(2):
            trainer.train_step(state, batch)
    _sync(device)
    for name, count in read_launches().items():
        out["launches"][name] += count
    return out


def _single_device_reference(kwargs, device, weights, batch, loss, grads,
                             action, rows=slice(None)) -> dict:
    """Rank 0: the single-device flash step and eval forward from the same
    weights and batch on the card, against the mesh's (the BC gate and
    the served-action gate); the mesh's `action` holds the episodes
    `rows` of the batch."""
    import torch

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model = TransformerBCModel(**kwargs)
    trainer = Trainer(model, device=device)
    network = trainer.init_state(params=weights).network
    network.train()
    ref_loss, _ = trainer.forward_loss(network, batch)
    ref_loss.backward()
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    if not loss_err <= LOSS_TOL:
        raise AssertionError(f"mesh loss {loss.item()} vs one card {ref_loss.item()}")
    worst, worst_name = 0.0, ""
    for name, p in network.named_parameters():
        g, g_ref = grads[name], p.grad
        scale = g_ref.abs().max().item()
        err = (g - g_ref).abs().max().item()
        if not err <= GRAD_TOL * scale + 1e-7:
            raise AssertionError(
                f"{name}: mesh gradient off the single-device step by {err} (max {scale})")
        if err / max(scale, 1e-30) > worst:
            worst, worst_name = err / max(scale, 1e-30), name
    network.zero_grad(set_to_none=True)
    with torch.inference_mode():
        network.eval()
        features, _ = trainer.preprocessor.preprocess(batch["features"], None, mode="eval")
        ref_action = model.packed_inference(
            network, features, "eval")[2]["inference_output"][rows]
    eval_err = ((action - ref_action).abs() / (1 + ref_action.abs())).max().item()
    if not eval_err <= SERVE_TOL:
        raise AssertionError(f"mesh eval forward off the single-device one by {eval_err}")
    return dict(loss=loss.item(), ref_loss=ref_loss.item(), loss_err=loss_err,
                worst=worst, worst_name=worst_name, eval_err=eval_err)


def parallel_rank_train(spec: dict, model_dir: str) -> dict:
    """On every rank: train_eval_model on a 2 x 2 data x sequence mesh;
    returns the final eval and the rank's launches."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    mesh = _rank_setup(spec, 2, 2)
    model = TransformerBCModel(mesh=mesh, **spec["model"])
    train = spec["train"]
    if spec["device"].startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    final_eval = train_eval_model(
        model,
        DefaultRandomInputGenerator(batch_size=spec["batch"], seed=0),
        DefaultRandomInputGenerator(batch_size=spec["batch"], seed=1000),
        model_dir=model_dir, max_train_steps=train["steps"],
        save_checkpoints_steps=train["save_every"], eval_steps=train["eval_steps"],
        log_every_steps=train["save_every"], device=spec["device"], mesh=mesh,
    )
    _sync(spec["device"])
    return {"final_eval": final_eval, "launches": read_launches(),
            "peak_gib": _peak_gib(spec["device"])}


def _serve_mesh_checkpoint(model_dir: str, want: list) -> tuple:
    """A mesh run's newest checkpoint served on one card by
    CheckpointPredictor (the single-device model; a pipelined run's
    stacked stages load as its chain), against the same weights on the
    einsum path, after checking the run left the checkpoints `want`;
    returns (what it found, the launches of the served batch)."""
    import numpy as np

    from tensor2robot_tpu_torch.predictors import CheckpointPredictor
    from tensor2robot_tpu_torch.specs import make_random_numpy
    from tensor2robot_tpu_torch.train import state as state_lib

    steps = state_lib.checkpoint_steps(model_dir)
    if steps != want:
        raise AssertionError(f"mesh run checkpoints {steps} != {want}")
    predictor = CheckpointPredictor(full_width_model(True), checkpoint_dir=model_dir,
                                    device=DEVICE)
    if not predictor.restore() or predictor.model_version != want[-1]:
        raise AssertionError(f"restored version {predictor.model_version}")
    plain = CheckpointPredictor(full_width_model(False), device=DEVICE)
    trained = state_lib.load_checkpoint(model_dir)
    plain.load_state_dict(trained["params"], version=trained["step"])
    episodes = make_random_numpy(predictor.get_feature_specification(),
                                 batch_size=DISTINCT_EPISODES, seed=1)
    reset_launches()
    got = predictor.predict(episodes)["action"]
    launches = read_launches()
    expected = plain.predict(episodes)["action"]
    if got.shape != (DISTINCT_EPISODES, SLICE["seq"], 7) or not np.all(np.isfinite(got)):
        raise AssertionError(f"served actions {got.shape}")
    err = float(np.max(np.abs(got - expected) / (1 + np.abs(expected))))
    if not err <= SERVE_TOL:
        raise AssertionError(f"mesh checkpoint served {err} off the einsum path")
    if launches != {"flash_fwd": NUM_LAYERS, "flash_fwd_tile": 0, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        raise AssertionError(f"serving launched {launches}")
    return (f"steps {steps}; {steps[-1]}.pt served on one card by CheckpointPredictor, "
            f"{DISTINCT_EPISODES} episodes within {err:.2e} of the einsum path"), launches


# -- parallel_critic and parallel_moe: global batches and experts on the same ranks --

# The full-width f32 critic on a 2 data x 2 fsdp mesh: the sharded_params
# regime, as the JAX trainer resolves it (every leaf of mesh.MIN_WEIGHT_SIZE
# elements or more split over fsdp, gathered on use), and data_shard's fsdp
# index: global batch 64, 16 a rank, its batch norms' train-mode moments
# over the 4 shards. `records` = (train records in as many files
# as shards, files, eval records) of shard_by_host JPEG input for the
# train_eval_model run of `steps` steps.
PARALLEL_CRITIC = dict(model=CRITIC, batch=CRITIC_BATCH, mesh=(2, 2), timed=5,
                       steps=4, records=(128, 4, 64))
# The gate's steps take cuDNN's deterministic convs, so a rerun rounds as
# the first did (the f32 gradients of either step lie ~2% of their max
# from float64's: the critic phase's reading).
# Running statistics start from zero in the gate's step, so afterwards they
# hold (1 - momentum) x the batch moments (momentum 0.9997): held to 1e-4
# of their max + 1e-7, as the critic phase holds its statistics. From the
# initial mean 0 / variance 1 the variance would read 1 + a 3e-4 nudge, and
# per-shard moments would pass any gate on it.
PARALLEL_STATS_TOL = 1e-4
# MoE BC at the BC cell's width on a 2 data x 2 expert mesh: 4 experts,
# k = 2, batch 8 (4 a data shard), 2 resident experts a rank.
PARALLEL_MOE = dict(experts=MOE_EXPERTS, mesh=(2, 2), timed=5)
# Each sub-phase's seconds, reckoned before its first card run (PERF.md
# §6 has the reckoning): the critic's single-device and mesh steps, the
# control, 7 timed steps, 192 JPEG records, 4 steps with an eval and an
# export, and continuous_eval; MoE's step, its single-device reference
# and 7 steps; the pipelined step, its reference and 12 steps, the ring-
# in-pipe step and its reference, 4 trainer steps with 2 evals, a
# resume and a served checkpoint; ZeRO-2's replicated step, 5 x 5 codec
# steps, 4 trainer steps with 2 evals, a resume, a served checkpoint and
# two one-card steps; sharded parameters' checked step, its control, its
# single-device reference, 7 timed steps of ~2.5 s (~2 GB staged a rank a
# step, most of it the column-split conv's input cotangent and output),
# 7 more with every sharded leaf gathered on use (~0.5 s each, tens of MB
# staged), 4 trainer steps with 2 evals, a resume on the mesh and on one
# card, a served checkpoint.
# The composed meshes: a single-device reference step, six gate steps and
# three controls (~1 s each with their gathers), 5 x 7 synced steps
# (~0.6 s each), 4 trainer steps with 2 evals, a resume in another
# regime and on one card, a served checkpoint; dp_sp_pp: 8 ranks up
# (~10 s), the reference, two gate steps, 5 synced steps (the composed
# meshes' and dp_sp_pp's timed steps cut to 2 and 1 to pay for the next
# two sub-phases). MoE over expert x sequence: two
# mesh backwards, an eval, the single-device reference, 5 synced steps of
# ~0.5 s. Sharded MAML: per order the single-device reference, a gate
# step (and a control), 5 synced steps of ~0.3 s.
PARALLEL_RECKONED_S = {"parallel_critic": 110, "parallel_moe": 45, "parallel_pipe": 60,
                       "parallel_zero2": 45, "parallel_sharded": 62,
                       "parallel_composed": 60, "parallel_3d": 40,
                       "parallel_moe_sequence": 40, "parallel_maml_sharded": 30,
                       "parallel_plan": 30}


@contextlib.contextmanager
def _deterministic_convs():
    """cuDNN's deterministic conv algorithms inside: the gate's steps, on
    one card and on the mesh, then round the same way on every run."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _parallel_critic_model(spec: dict):
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom,
    )

    return Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
        device_type="gpu", **spec["critic"]["model"])


def _zero_statistics(network) -> None:
    """Every batch norm's running statistics set to 0 (PARALLEL_STATS_TOL
    says why)."""
    import torch

    with torch.no_grad():
        for name, buffer in network.named_buffers():
            if name.endswith((".mean", ".var")):
                buffer.zero_()


def _critic_global_batch(model, batch_size: int):
    """A seeded preprocessed global batch of the critic: (features,
    labels) as numpy, rewards 0 or 1."""
    from tensor2robot_tpu_torch.specs import make_random_numpy

    features = dict(make_random_numpy(model.get_feature_specification("train"),
                                      batch_size=batch_size, seed=0))
    labels = dict(make_random_numpy(model.get_label_specification("train"),
                                    batch_size=batch_size, seed=1))
    labels["reward"] = (labels["reward"] > 0.5).astype("float32")
    return features, labels


def _on(tree: dict, device: str):
    import torch

    from tensor2robot_tpu_torch.specs import TensorSpecStruct

    return TensorSpecStruct({k: torch.from_numpy(v).to(device) for k, v in tree.items()})


def parallel_rank_critic(spec: dict, routing_dir: str, synchronized: bool) -> dict:
    """On every rank of the 2 x 2 data x fsdp mesh: one critic backward on
    this rank's shard of the global batch (deterministic cuDNN convs, as
    the single-device step's), every relu and pool pinned to the
    single-device step's choices for these rows, the gradients averaged
    by the trainer's bucket. `synchronized=False` is the control:
    each norm takes its own shard's moments. Returns the loss, every
    gradient and every buffer."""
    import torch

    from tensor2robot_tpu_torch.layers import batch_norm
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.parallel import sharded_params
    from tensor2robot_tpu_torch.research.qtopt.routing import Routing, pinned_routing
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    critic, device = spec["critic"], spec["device"]
    mesh = _rank_setup(spec, critic["mesh"][0], 1, fsdp=critic["mesh"][1])
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    model = _parallel_critic_model(spec)
    trainer = Trainer(model, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    network = state.network
    _zero_statistics(network)
    if not synchronized:
        batch_norm.synchronize(network, None)
    features, labels = (_on(mesh_lib.shard_batch(t, mesh), device)
                        for t in _critic_global_batch(model, critic["batch"]))
    recorded = torch.load(os.path.join(routing_dir, f"shard{trainer.shard}.pt"))
    routing = Routing(recorded["relus"], [tuple(p) for p in recorded["pools"]]).to(device)
    network.train()
    with _deterministic_convs(), pinned_routing(routing):
        loss, metrics = trainer.backward(network, features, labels)
    loss, _ = trainer.reduce_gradients(state, loss, metrics)
    grads = sharded_params.full_grads(network, trainer.param_layout, mesh)
    _sync(device)
    return dict(loss=loss.item(), grads={n: g.cpu().numpy() for n, g in grads.items()},
                stats={n: b.cpu().numpy() for n, b in network.named_buffers()})


def _timed_mesh_steps(trainer, state, batch, device: str, timed: int) -> dict:
    """2 + `timed` synced train steps, every rank starting each together;
    the median and spread of the timed ones on this rank, its peak GiB and
    the gloo-staged MB a step."""
    import torch.distributed as dist

    from tensor2robot_tpu_torch.parallel import collectives

    times, staged = [], []
    for i in range(2 + timed):
        collectives.reset_staged_bytes()
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        _sync(device)
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
            staged.append(collectives.staged_bytes())
    return dict(step_ms=sorted(times)[len(times) // 2], step_min=min(times),
                step_max=max(times), peak_gib=_peak_gib(device),
                staged_mb=sorted(staged)[len(staged) // 2] / 1e6)


def parallel_rank_critic_time(spec: dict) -> dict:
    """On every rank: synced train steps of the critic on the mesh (the
    trainer's step: crop and distortions on the card, backward, bucket,
    Adam), from this rank's shard of a raw 512x640 batch. Returns the
    median and spread, the peak GiB and the gloo-staged MB a step."""
    import torch

    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    critic, device = spec["critic"], spec["device"]
    mesh = _rank_setup(spec, critic["mesh"][0], 1, fsdp=critic["mesh"][1])
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = _parallel_critic_model(spec)
    trainer = Trainer(model, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = to_device(mesh_lib.shard_batch(_bc_batch(model, critic["batch"], seed=0), mesh),
                      device)
    timed = _timed_mesh_steps(trainer, state, batch, device, critic["timed"])
    timed.update(regime=trainer.regime, **_state_bytes(state, trainer))
    return timed


def _state_bytes(state, trainer) -> dict:
    """This rank's parameter and Adam-moment bytes, the whole model's
    parameter bytes, and how many leaves it holds a shard of."""
    from tensor2robot_tpu_torch.parallel import sharded_params

    layout, whole = trainer.param_layout, 0
    for name, p in state.network.named_parameters():
        shape = (sharded_params.whole_shape(p, layout[name], trainer.mesh)
                 if name in layout else p.shape)
        whole += math.prod(shape) * p.element_size()
    network = state.network
    return dict(
        param_bytes=sum(p.numel() * p.element_size() for p in network.parameters()),
        opt_bytes=sum(t.numel() * t.element_size()
                      for entry in state.optimizer.state_dict()["state"].values()
                      for t in entry.values() if t.ndim),
        whole_bytes=whole, sharded_leaves=len(layout))


def parallel_rank_critic_train(spec: dict, patterns: dict, model_dir: str) -> dict:
    """On every rank: train_eval_model on the 2 x 2 mesh from shard_by_host
    JPEG records (the eval file is read whole and sliced), an exporter and
    StepTimingHook built on rank 0; then continuous_eval over the mesh.
    Returns the final and continuous evals and rank 0's timing rows."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRecordInputGenerator,
    )
    from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
    from tensor2robot_tpu_torch.export.exporters import LatestExporter
    from tensor2robot_tpu_torch.hooks.profiling_hook_builder import StepTimingHookBuilder
    from tensor2robot_tpu_torch.train.continuous_eval import continuous_eval
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    critic, device = spec["critic"], spec["device"]
    mesh = _rank_setup(spec, critic["mesh"][0], 1, fsdp=critic["mesh"][1])
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    def records(split):
        return DefaultRecordInputGenerator(
            file_patterns=patterns[split], batch_size=critic["batch"], seed=3,
            shard_by_host=split == "train")

    timing = StepTimingHookBuilder(sync_every=1, output_path=None)
    steps = critic["steps"]
    final = train_eval_model(
        _parallel_critic_model(spec), records("train"), records("eval"),
        model_dir=model_dir, max_train_steps=steps, save_checkpoints_steps=steps,
        eval_steps=1, log_every_steps=1, device=device, mesh=mesh,
        hook_builders=[timing],
        create_exporters_fn=lambda model: [LatestExporter(
            name="latest", export_generator=DefaultExportGenerator())],
    )
    evaluated = continuous_eval(
        _parallel_critic_model(spec), model_dir, records("eval"), eval_steps=1,
        max_train_steps=steps, timeout=60.0, poll_interval=0.5, mesh=mesh,
        device=device)
    return dict(final=final, evaluated=evaluated,
                rows=None if timing.hook is None else timing.hook.rows)


def _critic_gate(mesh_runs, reference) -> tuple:
    """The mesh step against the single-device one: (what failed, the
    summary). Loss LOSS_TOL rel; every running statistic
    PARALLEL_STATS_TOL of its max + 1e-7; every gradient
    CRITIC_F32_GRAD_TOL of its max + 1e-7, those 0 in exact arithmetic (a
    bias before a batch norm: below ZERO_GRAD of the largest in the
    reference) held to that floor; every rank the same."""
    ref_loss, ref_grads, ref_stats = reference
    failures = []
    head = mesh_runs[0]
    for run in mesh_runs[1:]:
        for kind in ("grads", "stats"):
            for name, value in run[kind].items():
                if not (value == head[kind][name]).all():
                    failures.append(f"{kind} {name} differ between ranks")
    loss_err = abs(head["loss"] - ref_loss) / abs(ref_loss)
    if not loss_err <= LOSS_TOL:
        failures.append(f"loss {head['loss']} vs one card {ref_loss}")

    def share(got, want, tol):
        return float(abs(got - want).max()) / (tol * float(abs(want).max()) + 1e-7)

    stats = max((share(head["stats"][n], w, PARALLEL_STATS_TOL), n)
                for n, w in ref_stats.items())
    if not stats[0] <= 1.0:
        failures.append(f"statistic {stats[1]} at {stats[0]:.3f} of its allowance")
    floor = ZERO_GRAD * max(float(abs(g).max()) for g in ref_grads.values())
    zero = {n for n, g in ref_grads.items() if float(abs(g).max()) <= floor}
    grads = max((share(head["grads"][n], w, CRITIC_F32_GRAD_TOL), n)
                for n, w in ref_grads.items() if n not in zero)
    if not grads[0] <= 1.0:
        failures.append(f"gradient {grads[1]} at {grads[0]:.3f} of its allowance")
    zero_worst = max((float(abs(head["grads"][n]).max()) for n in zero), default=0.0)
    if not zero_worst <= floor:
        failures.append(f"a gradient 0 in exact arithmetic reads {zero_worst} (limit {floor})")
    summary = (f"loss {head['loss']:.7f} vs one card {ref_loss:.7f} (rel {loss_err:.2e}); "
               f"worst statistic {stats[1]} at {stats[0]:.3f} of its allowance "
               f"({PARALLEL_STATS_TOL} of its max + 1e-7); worst gradient {grads[1]} at "
               f"{grads[0]:.3f} of its allowance ({CRITIC_F32_GRAD_TOL} of its max + 1e-7); "
               f"{len(zero)} gradients 0 in exact arithmetic at most {zero_worst:.2e} "
               f"(limit {floor:.2e})")
    return failures, summary, stats[0]


def parallel_critic(world, spec: dict, model_dir: str) -> None:
    """The full-width critic's global-batch step on 2 data x 2 fsdp ranks
    against the single-device step, the per-shard control, the synced
    mesh step, then train_eval_model, continuous_eval and the export over
    the mesh, served on one card."""
    import shutil

    import numpy as np
    import torch

    from tensor2robot_tpu_torch.predictors import CheckpointPredictor
    from tensor2robot_tpu_torch.predictors.exported_savedmodel_predictor import (
        ExportedSavedModelPredictor,
    )
    from tensor2robot_tpu_torch.research.qtopt.routing import record_routing
    from tensor2robot_tpu_torch.specs import make_random_numpy
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    t0 = time.monotonic()
    critic, device = spec["critic"], spec["device"]
    shards = critic["mesh"][0] * critic["mesh"][1]
    rows = critic["batch"] // shards
    model = _parallel_critic_model(spec)
    trainer = Trainer(model, device=device)
    network = trainer.init_state(torch.Generator().manual_seed(0)).network
    _zero_statistics(network)
    features, labels = (_on(t, device) for t in _critic_global_batch(model, critic["batch"]))
    network.train()
    with _deterministic_convs(), record_routing() as routing:
        loss, _ = trainer.backward(network, features, labels)
    reference = (loss.item(),
                 {n: p.grad.cpu().numpy() for n, p in network.named_parameters()},
                 {n: b.cpu().numpy() for n, b in network.named_buffers()})
    routing_dir = tempfile.mkdtemp(dir=model_dir)
    for shard in range(shards):
        part = slice(shard * rows, (shard + 1) * rows)
        torch.save({"relus": [m[part].clone().cpu() for m in routing.relus],
                    "pools": [(m[part].clone().cpu(), c[part].clone().cpu())
                              for m, c in routing.pools]},
                   os.path.join(routing_dir, f"shard{shard}.pt"))
    del network, trainer, features, labels, routing, loss
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    mesh_runs = world.run(parallel_rank_critic, spec, routing_dir, True,
                          timeout_s=PARALLEL_TIMEOUT)
    control = world.run(parallel_rank_critic, spec, routing_dir, False,
                        timeout_s=PARALLEL_TIMEOUT)
    shutil.rmtree(routing_dir)
    failures, summary, _ = _critic_gate(mesh_runs, reference)
    if failures:
        raise AssertionError("parallel_critic gate: " + "; ".join(failures))
    control_failures, _, control_share = _critic_gate(control[:1], reference)
    if not any(f.startswith("statistic") for f in control_failures):
        raise AssertionError(
            "per-shard moments pass the statistics gate: it cannot tell them from "
            "the global batch's")
    timed = world.run(parallel_rank_critic_time, spec, timeout_s=PARALLEL_TIMEOUT)
    log(f"[parallel_critic] full-width f32 critic {critic['model']['image_size']}, "
        f"batch {critic['batch']} on a {critic['mesh'][0]} data x {critic['mesh'][1]} "
        f"fsdp mesh ({rows} a rank, batch-norm moments over every shard) on "
        f"{card_line()}, every relu and pool pinned to the single-device choices: "
        f"{summary}; control with per-shard moments: worst statistic at "
        f"{control_share:.1f} of its allowance (fails, as it must); synced mesh step "
        f"median {timed[0]['step_ms']:.3f} ms (min {timed[0]['step_min']:.3f}, max "
        f"{timed[0]['step_max']:.3f}) over {critic['timed']} on rank 0, medians by rank "
        f"{[round(r['step_ms'], 3) for r in timed]}; peak GiB by rank "
        f"{[round(r['peak_gib'], 3) for r in timed]}; gloo host-staged "
        f"{timed[0]['staged_mb']:.3f} MB a step on rank 0; regime {timed[0]['regime']}: "
        f"{timed[0]['sharded_leaves']} leaves sharded over fsdp, parameters "
        f"{timed[0]['param_bytes'] / 1e6:.3f} MB a rank of {timed[0]['whole_bytes'] / 1e6:.3f}"
        f" MB, optimizer state {timed[0]['opt_bytes'] / 1e6:.3f} MB a rank")

    t_train = time.monotonic()
    run_dir = tempfile.mkdtemp(dir=model_dir)
    source = model.preprocessor.get_in_feature_specification("train")["state/image"]
    patterns, _, write_s = write_records(model, os.path.join(run_dir, "records"),
                                         critic["records"], source.shape[:2])
    ranks = world.run(parallel_rank_critic_train, spec, patterns, run_dir,
                      timeout_s=PARALLEL_TIMEOUT)
    steps = critic["steps"]
    if state_lib.checkpoint_steps(run_dir) != [steps]:
        raise AssertionError(f"mesh critic checkpoints {state_lib.checkpoint_steps(run_dir)}")
    for key in ("final", "evaluated"):
        values = [r[key] for r in ranks]
        if any(v != values[0] for v in values) or not math.isfinite(values[0]["loss"]):
            raise AssertionError(f"ranks' {key} evals {values}")
    if ranks[0]["rows"] is None or len(ranks[0]["rows"]) != steps - 1 or any(
            r["rows"] is not None for r in ranks[1:]):
        raise AssertionError(f"StepTimingHook rows by rank {[r['rows'] for r in ranks]}")
    predictor = ExportedSavedModelPredictor(
        export_dir=os.path.join(run_dir, "export", "latest"), device=DEVICE)
    predictor.restore()
    requests = make_random_numpy(predictor.get_feature_specification(),
                                 batch_size=CRITIC_REQUESTS, seed=3)
    got = predictor.predict(requests)
    reference_predictor = CheckpointPredictor(_parallel_critic_model(spec),
                                              checkpoint_dir=run_dir, device=DEVICE)
    reference_predictor.restore()
    want = reference_predictor.predict(requests)
    worst = 0.0
    for key, value in want.items():
        err = np.abs(got[key] - value)
        if (not np.isfinite(got[key]).all() or got[key].shape != value.shape
                or (err > CRITIC_SERVE_TOL + CRITIC_SERVE_TOL * np.abs(value)).any()):
            raise AssertionError(f"mesh critic export {key}: {err.max()} from the checkpoint's")
        worst = max(worst, float(err.max()))
    shutil.rmtree(run_dir)
    rate = ranks[0]["rows"][-1]["steps_per_sec"]
    log(f"[parallel_critic] train_eval_model on the mesh on {card_line()}: "
        f"{critic['records'][0]} + {critic['records'][2]} JPEG records written in "
        f"{write_s:.1f}s, {critic['records'][1]} train files split by shard_by_host "
        f"({critic['records'][1] // shards} a data x fsdp shard); {steps} steps, "
        f"{steps}.pt from rank 0; final eval {ranks[0]['final']} on every rank; "
        f"StepTimingHook on rank 0 only ({len(ranks[0]['rows'])} rows, last "
        f"{rate:.3f} steps/s); continuous_eval over the mesh "
        f"{ranks[0]['evaluated']} on every rank; the export served on one card, "
        f"{CRITIC_REQUESTS} requests within {worst:.3e} of CheckpointPredictor(EMA) "
        f"(limit {CRITIC_SERVE_TOL} abs + rel); {time.monotonic() - t_train:.1f}s")
    log(f"[parallel_critic] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_critic']} s)")


def parallel_rank_moe(spec: dict, episodes: list) -> dict:
    """On every rank of the 2 data x 2 expert mesh: one MoE BC backward on
    this rank's data shard of the batch's `episodes` through its resident
    experts, averaged by the trainer's bucket, router picks recorded.
    Rank 0 then takes the single-device MoE step on the same episodes and
    weights and measures the mesh's loss and gradients against it (the
    caller gates them once it has compared the routing). Returns the
    picks, the launches and rank 0's measurements."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    moe, device = spec["moe"], spec["device"]
    mesh = _rank_setup(spec, moe["mesh"][0], 1, expert=moe["mesh"][1])
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    kwargs = dict(spec["model"], num_experts=moe["experts"])
    model = TransformerBCModel(mesh=mesh, **kwargs)
    trainer = Trainer(model, device=device, mesh=mesh)
    network = trainer.init_state(torch.Generator().manual_seed(0)).network
    host = _bc_batch(model, spec["batch"], seed=0)
    part = {k: v[episodes] for k, v in host.items()}
    batch = to_device(mesh_lib.shard_batch(part, mesh), device)
    network.train()
    reset_launches()
    with _RouterRecorder() as recorder:
        features, labels = trainer.preprocess_train(batch)
        loss, metrics = trainer.backward(network, features, labels)
        loss, metrics = trainer.average_over_ranks(network, loss, metrics)
    _sync(device)
    launches = read_launches()
    out = dict(rank=dist.get_rank(), shard=trainer.shard, launches=launches,
               picks=[(ids.cpu().numpy(), m.cpu().numpy()) for ids, m in recorder.picks(2)])
    if out["rank"] == 0:
        reference = TransformerBCModel(**kwargs)
        ref_trainer = Trainer(reference, device=device)
        ref_network = ref_trainer.init_state(params=network.state_dict()).network
        ref_network.train()
        with _RouterRecorder() as ref_recorder:
            ref_loss, ref_metrics = ref_trainer.forward_loss(
                ref_network, to_device(part, device))
            ref_loss.backward()
        worst, worst_name, over = 0.0, "", []
        ref_params = dict(ref_network.named_parameters())
        for name, p in network.named_parameters():
            g, g_ref = p.grad, ref_params[name].grad
            scale = g_ref.abs().max().item()
            err = (g - g_ref).abs().max().item()
            if not err <= GRAD_TOL * scale + 1e-7:
                over.append(f"{name} off by {err} (max {scale})")
            if err / max(scale, 1e-30) > worst:
                worst, worst_name = err / max(scale, 1e-30), name
        out.update(loss=loss.item(), ref_loss=ref_loss.item(),
                   aux=metrics["loss/moe_aux"].item(),
                   ref_aux=ref_metrics["loss/moe_aux"].item(),
                   worst=worst, worst_name=worst_name, over=over,
                   ref_picks=[(ids.cpu().numpy(), m.cpu().numpy())
                              for ids, m in ref_recorder.picks(2)])
    dist.barrier()
    return out


def parallel_rank_moe_time(spec: dict) -> dict:
    """On every rank: synced MoE train steps on the 2 x 2 mesh; returns
    the median and spread, peak GiB, staged MB a step and the launches."""
    import torch

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    moe, device = spec["moe"], spec["device"]
    mesh = _rank_setup(spec, moe["mesh"][0], 1, expert=moe["mesh"][1])
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = TransformerBCModel(mesh=mesh, num_experts=moe["experts"], **spec["model"])
    trainer = Trainer(model, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = to_device(mesh_lib.shard_batch(_bc_batch(model, spec["batch"], seed=7), mesh),
                      device)
    reset_launches()
    out = _timed_mesh_steps(trainer, state, batch, device, moe["timed"])
    out["launches"] = read_launches()
    return out


def _moe_flips(ranks, episodes, shards: int) -> list:
    """(layer, episode, step, margin) of every router pick a mesh rank
    made otherwise than the single-device step, over each rank's episodes
    (data shard d holds the d-th block of `episodes`)."""
    per_shard = len(episodes) // shards
    reference = ranks[0]["ref_picks"]
    flips = []
    for r in ranks:
        mine = episodes[r["shard"] * per_shard:(r["shard"] + 1) * per_shard]
        offset = r["shard"] * per_shard
        for layer, ((ids, margin), (ref_ids, _)) in enumerate(zip(r["picks"], reference)):
            differ = (ids != ref_ids[offset:offset + per_shard]).any(axis=-1)
            for g, t in zip(*differ.nonzero()):
                flips.append((layer, mine[g], int(t), float(margin[g, t])))
    return sorted(set(flips))


def parallel_moe(world, spec: dict) -> dict:
    """MoE BC on 2 data x 2 expert ranks against the single-device MoE
    step (the moe phase's routing rule), then its synced step. Returns
    the launches of every rank's main-path calls."""
    t0 = time.monotonic()
    moe, layers = spec["moe"], spec["layers"]
    shards = moe["mesh"][0]
    per_step = {"flash_fwd": 0, "flash_fwd_tile": layers, "flash_bwd_dq": layers,
                "flash_bwd_dkv": layers}
    launches = {name: 0 for name in per_step}
    episodes, dropped = list(range(spec["batch"])), []
    for _ in range(2):
        ranks = world.run(parallel_rank_moe, spec, episodes, timeout_s=PARALLEL_TIMEOUT)
        for r in ranks:
            if r["launches"] != per_step:
                raise AssertionError(f"rank {r['rank']} MoE step launched {r['launches']}")
            for name, count in r["launches"].items():
                launches[name] += count
        flips = _moe_flips(ranks, episodes, shards)
        wide = [f for f in flips if f[3] >= MOE_FLIP_MARGIN]
        if wide:
            raise AssertionError(f"mesh routing differs past the margin {MOE_FLIP_MARGIN}: "
                                 f"(layer, episode, step, margin) {wide}")
        if not flips:
            break
        # Each episode is its own routing group and attention context; the
        # kept episodes stay a multiple of the data shards.
        dropped += sorted({f[1] for f in flips})
        episodes = [e for e in episodes if e not in dropped]
        episodes = episodes[:len(episodes) - len(episodes) % shards]
        log(f"[parallel_moe] routing flips under the margin {MOE_FLIP_MARGIN} "
            f"(layer, episode, step, margin) {flips}: episodes {dropped} left out")
    else:
        raise AssertionError("mesh routing still flips after leaving episodes out")
    head = ranks[0]
    loss_err = abs(head["loss"] - head["ref_loss"]) / abs(head["ref_loss"])
    aux_err = abs(head["aux"] - head["ref_aux"]) / abs(head["ref_aux"])
    if not loss_err <= LOSS_TOL or head["over"] or not math.isfinite(head["aux"]):
        raise AssertionError(f"MoE mesh step: loss {head['loss']} vs {head['ref_loss']}; "
                             f"aux {head['aux']}; gradients {head['over']}")
    timed = world.run(parallel_rank_moe_time, spec, timeout_s=PARALLEL_TIMEOUT)
    steps = 2 + moe["timed"]
    for r in timed:
        if r["launches"] != {k: v * steps for k, v in per_step.items()}:
            raise AssertionError(f"{steps} MoE mesh steps launched {r['launches']}")
        for name, count in r["launches"].items():
            launches[name] += count
    log(f"[parallel_moe] MoE BC ({moe['experts']} experts, k = 2, "
        f"{moe['experts'] // moe['mesh'][1]} resident a rank) on a {moe['mesh'][0]} data x "
        f"{moe['mesh'][1]} expert mesh on {card_line()}: loss {head['loss']:.7f} vs one "
        f"card {head['ref_loss']:.7f} (rel {loss_err:.2e}); loss/moe_aux "
        f"{head['aux']:.7f} (rel {aux_err:.2e}); worst gradient {head['worst_name']} at "
        f"{head['worst']:.2e} of its max; routing picks differing {len(flips)} over "
        f"{len(episodes)} episodes (left out: {dropped or 'none'}); B1/B3/B4 "
        f"{layers} each a rank a step; synced step median {timed[0]['step_ms']:.3f} ms "
        f"(min {timed[0]['step_min']:.3f}, max {timed[0]['step_max']:.3f}) over "
        f"{moe['timed']} on rank 0, medians by rank "
        f"{[round(r['step_ms'], 3) for r in timed]}; peak GiB by rank "
        f"{[round(r['peak_gib'], 3) for r in timed]}; gloo host-staged "
        f"{timed[0]['staged_mb']:.3f} MB a step on rank 0")
    log(f"[parallel_moe] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_moe']} s)")
    return launches

# -- parallel_pipe: the BC encoder pipelined over the pipe dim on the same ranks -----


def _pipe_micro(local_batch: int, stages: int) -> int:
    """The pipelined encoder's default microbatches (JAX's rule)."""
    return max(d for d in range(1, min(local_batch, 2 * stages) + 1)
               if local_batch % d == 0)


def parallel_rank_pipe(spec: dict, sequence: bool) -> dict:
    """On every rank of the 2 data x 2 pipe mesh (or, `sequence`, the
    2 sequence x 2 pipe mesh): one pipelined BC step's loss and every
    gradient (averaged by the trainer's bucket; each stage's gathered over
    the pipe ranks and relabelled as the chain's) and an eval forward;
    rank 0 holds them against the single-device flash step and forward on
    the same weights and batch. Then, on data x pipe, the synced step
    (median of PARALLEL_TIMED_STEPS), peak memory and staged bytes a
    step, and rank 0's profiled step. Returns the rank's numbers and its
    main-path launches."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import collectives
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.parallel import pipeline
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    device = spec["device"]
    outer, stages = spec["pipe"]["ring" if sequence else "mesh"]
    mesh = (_rank_setup(spec, 1, outer, pipe=stages) if sequence
            else _rank_setup(spec, outer, 1, pipe=stages))
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = TransformerBCModel(mesh=mesh, pipeline_stages=stages, **spec["model"])
    trainer = Trainer(model, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    host = _bc_batch(model, spec["batch"], seed=0)
    batch = to_device(mesh_lib.shard_batch(host, mesh), device)
    shard, shards = mesh_lib.data_shard(mesh)
    local = spec["batch"] // shards
    # B1 = B3 = B4 a rank a step: blocks a stage x microbatches; the
    # manual ring of sequence x pipe runs the einsum tiles (no kernel).
    per_step = 0 if sequence else spec["layers"] // stages * _pipe_micro(local, stages)
    want = {"flash_fwd": 0, "flash_fwd_tile": per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step}
    rank = dist.get_rank()
    out = {"rank": rank, "launches": {k: 0 for k in read_launches()},
           "per_step": per_step}

    def counted(fn):
        reset_launches()
        result = fn()
        _sync(device)
        for name, count in read_launches().items():
            out["launches"][name] += count
        return result, read_launches()

    network = state.network
    network.train()

    def step():
        features, labels = trainer.preprocess_train(batch)
        loss, metrics = trainer.backward(network, features, labels)
        return trainer.average_over_ranks(network, loss, metrics)[0]

    loss, launches = counted(step)
    if launches != want:
        raise AssertionError(f"rank {rank} pipelined step launched {launches} != {want}")
    grads = pipeline.unstack_stages({
        n: (collectives.stack_over(p.grad, mesh, mesh_lib.PIPE_AXIS)
            if trainer.stage_local(n) else p.grad.detach().clone())
        for n, p in network.named_parameters()})
    weights = trainer.checkpoint_state(state, optimizer=False)["params"]
    network.zero_grad(set_to_none=True)
    with torch.inference_mode():
        network.eval()
        features, _ = trainer.preprocessor.preprocess(batch["features"], None, mode="eval")
        action, launches = counted(
            lambda: model.packed_inference(network, features, "eval")[2]["inference_output"])
    eval_want = {"flash_fwd": per_step, "flash_fwd_tile": 0, "flash_bwd_dq": 0,
                 "flash_bwd_dkv": 0}
    if launches != eval_want:
        raise AssertionError(f"rank {rank} pipelined eval launched {launches} != {eval_want}")
    if rank == 0:
        out.update(_single_device_reference(
            spec["model"], device, weights, to_device(host, device), loss, grads, action,
            rows=slice(shard * local, (shard + 1) * local)))
    del grads, weights, action
    dist.barrier()
    if sequence:
        return out
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    times, staged = [], []
    for i in range(2 + spec["timed"]):
        collectives.reset_staged_bytes()
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        _, launches = counted(lambda: trainer.train_step(state, batch))
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
            staged.append(collectives.staged_bytes())
        if launches != want:
            raise AssertionError(f"rank {rank} pipelined train step launched {launches}")
    out.update(
        step_ms=sorted(times)[len(times) // 2], step_min=min(times),
        step_max=max(times), peak_gib=_peak_gib(device),
        staged_mb=sorted(staged)[len(staged) // 2] / 1e6,
    )
    # Where a pipelined step's time goes on the card: rank 0 (stage 0)
    # profiles the second of two steps while the other ranks step.
    if rank == 0 and device.startswith("cuda"):
        counted(lambda: device_profile(
            f"pipelined train step, rank 0 (stage 0) of {PARALLEL_RANKS} sharing the card",
            lambda: trainer.train_step(state, batch), rows=8))
    else:
        counted(lambda: [trainer.train_step(state, batch) for _ in range(2)])
    return out


def parallel_rank_pipe_train(spec: dict, model_dir: str, steps: int) -> dict:
    """On every rank: train_eval_model of pipelined BC on the 2 data x 2
    pipe mesh up to `steps` (resuming from model_dir's newest checkpoint);
    returns the final eval, the rank's launches and peak GiB."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    data, stages = spec["pipe"]["mesh"]
    mesh = _rank_setup(spec, data, 1, pipe=stages)
    model = TransformerBCModel(mesh=mesh, pipeline_stages=stages, **spec["model"])
    train = spec["pipe"]["train"]
    if spec["device"].startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    final_eval = train_eval_model(
        model,
        DefaultRandomInputGenerator(batch_size=spec["batch"], seed=0),
        DefaultRandomInputGenerator(batch_size=spec["batch"], seed=1000),
        model_dir=model_dir, max_train_steps=steps,
        save_checkpoints_steps=train["save_every"], eval_steps=train["eval_steps"],
        log_every_steps=train["save_every"], device=spec["device"], mesh=mesh,
    )
    _sync(spec["device"])
    return {"final_eval": final_eval, "launches": read_launches(),
            "peak_gib": _peak_gib(spec["device"])}


def parallel_pipe(world, spec: dict, model_dir: str) -> dict:
    """Pipelined BC on the ranks: the 2 data x 2 pipe step and the
    2 sequence x 2 pipe step against the single-device step, the synced
    step, then train_eval_model with a stacked checkpoint and a resume,
    served on one card. Returns the launches of every rank's main-path
    calls."""
    from tensor2robot_tpu_torch.train import state as state_lib

    t0 = time.monotonic()
    pipe = spec["pipe"]
    launches = {name: 0 for name in read_launches()}

    def add(counts) -> None:
        for name, count in counts.items():
            launches[name] += count

    ranks = world.run(parallel_rank_pipe, spec, False, timeout_s=PARALLEL_TIMEOUT)
    for r in ranks:
        add(r["launches"])
    head, per_step = ranks[0], ranks[0]["per_step"]
    data, stages = pipe["mesh"]
    micro = _pipe_micro(spec["batch"] // data, stages)
    log(f"[parallel_pipe] BC pipelined over {stages} stages ({spec['layers'] // stages} "
        f"blocks a stage, {micro} microbatches of {spec['batch'] // data // micro} "
        f"episode(s)) on a {data} data x {stages} pipe mesh on {card_line()}: loss "
        f"{head['loss']:.7f} vs one card {head['ref_loss']:.7f} (rel "
        f"{head['loss_err']:.2e}); worst gradient {head['worst_name']} at "
        f"{head['worst']:.2e} of its max; eval forward within {head['eval_err']:.2e}; "
        f"B1/B3/B4 {per_step} each a rank a step (B2 {per_step} in its eval); synced "
        f"step median {head['step_ms']:.3f} ms (min {head['step_min']:.3f}, max "
        f"{head['step_max']:.3f}) over {spec['timed']} on rank 0, medians by rank "
        f"{[round(r['step_ms'], 3) for r in ranks]}; peak GiB by rank "
        f"{[round(r['peak_gib'], 3) for r in ranks]} (one card's step on an H100: "
        f"6.082 GiB, PERF.md §5); gloo host-staged {head['staged_mb']:.3f} MB a "
        f"step on rank 0, by rank {[round(r['staged_mb'], 3) for r in ranks]}")
    ring = world.run(parallel_rank_pipe, spec, True, timeout_s=PARALLEL_TIMEOUT)
    for r in ring:
        add(r["launches"])
    head = ring[0]
    log(f"[parallel_pipe] ring in pipe: one step on a {pipe['ring'][0]} sequence x "
        f"{pipe['ring'][1]} pipe mesh (the manual einsum ring in every stage) on "
        f"{card_line()}: loss {head['loss']:.7f} vs one card {head['ref_loss']:.7f} (rel "
        f"{head['loss_err']:.2e}); worst gradient {head['worst_name']} at "
        f"{head['worst']:.2e} of its max; eval forward within {head['eval_err']:.2e}; "
        f"no kernel launch")
    train = pipe["train"]
    steps = train["steps"]
    evals = steps // train["save_every"]
    want = {"flash_fwd": per_step * evals * train["eval_steps"],
            "flash_fwd_tile": per_step * steps, "flash_bwd_dq": per_step * steps,
            "flash_bwd_dkv": per_step * steps}
    with tempfile.TemporaryDirectory(dir=model_dir) as run_dir:
        t_train = time.monotonic()
        runs = []
        for last in (steps, 2 * steps):  # the second resumes from the first's checkpoint
            runs.append(world.run(parallel_rank_pipe_train, spec, run_dir, last,
                                  timeout_s=PARALLEL_TIMEOUT))
            for r in runs[-1]:
                if r["launches"] != want:
                    raise AssertionError(f"pipelined train_eval_model to {last} launched "
                                         f"{r['launches']} != {want}")
                add(r["launches"])
            finals = {round(r["final_eval"]["eval/mse"], 9) for r in runs[-1]}
            if len(finals) != 1 or not all(math.isfinite(e) for e in finals):
                raise AssertionError(f"ranks' final evals {finals}")
            if last == steps:
                stacked = state_lib.load_checkpoint(run_dir, steps)["params"]
                qkv = stacked["encoder.pipe_stages.block_0.attention.qkv.weight"]
                if qkv.shape[0] != stages or "encoder.block_0.attention.qkv.weight" in stacked:
                    raise AssertionError(f"checkpoint stage layout {tuple(qkv.shape)}")
        served, served_launches = _serve_mesh_checkpoint(
            run_dir, list(range(train["save_every"], 2 * steps + 1, train["save_every"])))
        add(served_launches)
        log(f"[parallel_pipe] train_eval_model on the {data} x {stages} data x pipe mesh on "
            f"{card_line()}: {steps} steps, then a resume to {2 * steps} (each run "
            f"B1/B3/B4 {per_step * steps} a rank, B2 {want['flash_fwd']} in its eval); "
            f"{steps}.pt holds the stages stacked ({tuple(qkv.shape)} qkv); final eval "
            f"{runs[-1][0]['final_eval']} on every rank; {served}; peak GiB by rank "
            f"{[round(r['peak_gib'], 3) for r in runs[-1]]}; "
            f"{time.monotonic() - t_train:.1f}s")
    log(f"[parallel_pipe] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_pipe']} s)")
    return launches


# -- parallel_zero2: ZeRO-2 weight-update sharding and its codecs on the same ranks --

# Full-width BC on a 4-rank data mesh (global batch 8, 2 episodes a rank),
# block 512: one replicated step, then `steps` steps of each codec from
# the same seed-0 weights ("none" is zero2's exact exchange; its first
# step is the gate against the replicated one, and every quantized run's
# last step is held against its last). All of a codec's steps are synced
# and timed. Then train_eval_model in int8: `train` steps with a
# checkpoint holding the residuals, a resume to twice as many, served on
# one card; and on one card the flat optimizer update against the
# per-leaf one.
PARALLEL_ZERO2 = dict(regimes=("none", "fp16", "int8", "fp8_e4m3", "fp8_e5m2"),
                      block=512, batch=8, steps=5,
                      train=dict(steps=2, save_every=2, eval_steps=1))
# A quantized run against the exact one after `steps` steps from the same
# weights, error feedback included. The loss within the JAX package's own
# absolute tolerance (tests/test_collectives.py:266-296); int8's is the
# larger of it and int8's quantization step (1/127) times the exact run's
# loss, since JAX's tolerances are absolute at its mock's loss of ~0.5 and
# int8's BC loss after 5 steps read 3.70e-3 at an exact loss of 1.045
# (PERF.md §6). The parameters' change from the start, as one vector,
# within ZERO2_REL_L2 of the exact run's change in L2 norm. Each limit lies
# between the codec's sound reading and its control's (ZERO2_CONTROLS): a
# run of the same codec with a fault put in from outside the trainer, which
# must fail the gate. A fault scales what every step changes of the
# parameters (ZERO2_FAULTS): "half_update" by 1/2, as a decode with half
# the scale would. An update never applied reads a relative L2 of exactly
# 1, further out still.
ZERO2_LOSS_TOLS = {"fp16": 2e-4, "int8": 2e-3, "fp8_e4m3": 2e-3, "fp8_e5m2": 5e-3}
ZERO2_INT8_STEP = 1 / 127.0
ZERO2_REL_L2 = {"fp16": 0.05, "int8": 0.4, "fp8_e4m3": 0.2, "fp8_e5m2": 0.2}
ZERO2_FAULTS = {"half_update": 0.5}
ZERO2_CONTROLS = {name: ("half_update",) for name in ZERO2_REL_L2}
# One Adam step against another from the same weights (zero2's against the
# replicated step; the flat update's against the per-leaf one): the loss
# LOSS_TOL rel; the gradient each stepped with (Adam's first moment over
# 1 - beta1, gathered from the shards) under the BC gate (GRAD_TOL of its
# leaf's max + 1e-7); every parameter within 1e-6 abs + 1e-4 of its leaf's
# largest update + the difference between what Adam's first step,
# lr g / (|g| + eps), makes of the two runs' own gradients, element by
# element. That last term is rounding-sized wherever |g| >> eps, and up to
# lr where g is within rounding of 0 and its sign is rounding's.
ZERO2_PARAM_TOL = (1e-6, 1e-4)


def _first_moments(trainer, state) -> dict:
    """{parameter name: Adam's first moment} of a state after its first
    step, gathered from the shards (checkpoint_state; a collective in the
    ZeRO-2 regimes) and cut from a flat vector."""
    from tensor2robot_tpu_torch.train import state as state_lib

    saved = trainer.checkpoint_state(state)["optimizer"]["state"]
    names = [n for n, _ in state.network.named_parameters()]
    if len(saved) == 1 and len(names) > 1:  # one flat vector
        return state_lib.ema_as_tree(saved[0]["exp_avg"].clone(), state.network)
    # Copies: the later steps move the live moments in place.
    return {names[i]: entry["exp_avg"].clone() for i, entry in saved.items()}


def _adam_step_gate(got: dict, want: dict, start: dict, got_m: dict, want_m: dict,
                    optimizer) -> tuple:
    """(the worst gradient error over its allowance and its leaf, the
    worst parameter error over its allowance and its leaf) of one Adam
    step `got` against `want` from `start` (module constants above)."""
    group = optimizer.param_groups[0]
    beta1, (lr, eps) = group["betas"][0], (group["lr"], group["eps"])
    worst_g, worst_p = (0.0, ""), (0.0, "")
    for name, m in want_m.items():
        g_want, g_got = m / (1 - beta1), got_m[name] / (1 - beta1)
        dg = (g_got - g_want).abs()
        ratio = dg.max().item() / (GRAD_TOL * g_want.abs().max().item() + 1e-7)
        worst_g = max(worst_g, (ratio, name))
        first_step = lambda g: lr * g / (g.abs() + eps)
        allowed = (ZERO2_PARAM_TOL[0]
                   + (first_step(g_got) - first_step(g_want)).abs().reshape(want[name].shape)
                   + ZERO2_PARAM_TOL[1] * (want[name] - start[name]).abs().max())
        ratio = ((got[name] - want[name]).abs() / allowed).max().item()
        worst_p = max(worst_p, (ratio, name))
    return worst_g, worst_p


def parallel_rank_zero2(spec: dict) -> dict:
    """On every rank of the 4-rank data mesh: the replicated step, then
    each codec's zero2 run from the same weights and batch, each step
    synced and timed with its staged bytes and launches; the gates (the
    exact step against the replicated one, each quantized run against
    the exact run) on every rank. Returns the rank's numbers and the
    launches of its main-path calls."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import collectives
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    cfg, device, layers = spec["zero2"], spec["device"], spec["layers"]
    mesh = _rank_setup(spec, PARALLEL_RANKS, 1)
    model = TransformerBCModel(mesh=mesh, **spec["model"])
    host = _bc_batch(model, cfg["batch"], seed=0)
    batch = to_device(mesh_lib.shard_batch(host, mesh), device)
    want = {"flash_fwd": 0, "flash_fwd_tile": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}
    rank = dist.get_rank()
    out = {"rank": rank, "launches": {k: 0 for k in read_launches()}, "regimes": {}}

    def run(steps: int, fault=None, **kwargs):
        """`steps` synced steps of a fresh trainer, cuDNN's convs
        deterministic (a rerun rounds as this one did), with the control's
        `fault` put in after every step (ZERO2_CONTROLS); (the state dicts
        before, after the first and after the last step, the numbers). A
        control's launches are checked and not counted."""
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(model, device=device, mesh=mesh, **kwargs)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        snapshot = lambda: {k: v.detach().clone() for k, v in state.network.state_dict().items()}
        start, first, moments, losses, times, staged = snapshot(), None, None, [], [], []
        for i in range(steps):
            before = ({k: v.detach().clone() for k, v in state.network.named_parameters()}
                      if fault else None)
            collectives.reset_staged_bytes()
            reset_launches()
            _sync(device)
            dist.barrier()
            t0 = time.perf_counter()
            with _deterministic_convs():
                losses.append(float(trainer.train_step(state, batch)["loss"]))
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            staged.append(collectives.staged_bytes())
            launches = read_launches()
            if fault is None:
                for name, count in launches.items():
                    out["launches"][name] += count
            if launches != want:
                raise AssertionError(f"rank {rank} {kwargs} step launched {launches} != {want}")
            if fault:
                with torch.no_grad():
                    for name, param in state.network.named_parameters():
                        param.copy_(before[name] + ZERO2_FAULTS[fault]
                                    * (param - before[name]))
                del before
            if i == 0:
                first = snapshot()
                moments = _first_moments(trainer, state) if trainer.collective is None else None
        optimizer = state.optimizer
        opt_bytes = sum(t.numel() * t.element_size()
                        for entry in state.optimizer.state_dict()["state"].values()
                        for t in entry.values() if t.ndim)
        numbers = dict(losses=losses, step_ms=sorted(times)[len(times) // 2],
                       step_min=min(times), step_max=max(times),
                       staged_mb=sorted(staged)[len(staged) // 2] / 1e6,
                       peak_gib=_peak_gib(device), opt_mb=opt_bytes / 1e6)
        n_params = sum(p.numel() for p in state.network.parameters())
        layout = collectives.FlatShardLayout(n_params, PARALLEL_RANKS, cfg["block"])
        coll = trainer.collective or collectives.get_collective("none", cfg["block"])
        pre, post = collectives.wire_summary(coll, layout.padded)
        numbers.update(n_params=n_params, wire_pre_mb=pre / 1e6, wire_post_mb=post / 1e6,
                       regime=trainer.regime)
        if trainer.collective is not None and fault is None:
            numbers["exchange_ms"] = trainer.measure_collective_ms()
        last = snapshot()
        del trainer, state
        return start, (first, moments, optimizer), last, numbers

    def against_exact(numbers: dict, last: dict, name: str) -> dict:
        """A quantized run's fifth step against the exact run's: the loss
        error and its tolerance, and the parameters' change against the
        exact change (relative L2, module constants)."""
        loss_tol = ZERO2_LOSS_TOLS[name]
        if name == "int8":
            loss_tol = max(loss_tol, ZERO2_INT8_STEP * abs(exact_loss))
        diff = sum(float(torch.sum((last[k].double() - v.double()) ** 2))
                   for k, v in exact_last.items())
        moved = sum(float(torch.sum((v.double() - start[k].double()) ** 2))
                    for k, v in exact_last.items())
        return dict(loss_err=abs(numbers["losses"][-1] - exact_loss), loss_tol=loss_tol,
                    rel_l2=math.sqrt(diff / moved), rel_l2_tol=ZERO2_REL_L2[name],
                    param_err=max((last[k] - v).abs().max().item() for k, v in exact_last.items()))

    start, replicated, _, numbers = run(1)
    out["regimes"]["replicated"] = numbers
    out["controls"] = {}
    for name in cfg["regimes"]:
        kwargs = dict(shard_weight_update=True, collective_quant=name,
                      collective_block=cfg["block"])
        _, first, last, numbers = run(cfg["steps"], **kwargs)
        if name == "none":
            exact_loss, exact_last = numbers["losses"][-1], last
            loss_err = abs(numbers["losses"][0] - out["regimes"]["replicated"]["losses"][0])
            loss_err /= abs(out["regimes"]["replicated"]["losses"][0])
            (grad, grad_name), (worst, worst_name) = _adam_step_gate(
                first[0], replicated[0], start, first[1], replicated[1], replicated[2])
            numbers.update(loss_err=loss_err, grad=grad, grad_name=grad_name, worst=worst,
                           worst_name=worst_name)
        else:
            numbers.update(against_exact(numbers, last, name))
            for fault in ZERO2_CONTROLS[name]:
                _, _, control_last, control = run(cfg["steps"], fault=fault, **kwargs)
                out["controls"][f"{name} {fault}"] = against_exact(control, control_last, name)
                del control_last
        out["regimes"][name] = numbers
        del first, last
    del exact_last
    return out


def _zero2_failures(ranks: list) -> list:
    """What every rank's parallel_rank_zero2 numbers break of the gates
    (module constants): a sound run over a limit, or a control within
    both of its codec's limits."""
    failures = []
    for r in ranks:
        for name, n in r["regimes"].items():
            if name == "replicated":
                continue
            if name == "none":
                if not (n["loss_err"] <= LOSS_TOL and n["grad"] <= 1.0 and n["worst"] <= 1.0):
                    failures.append(
                        f"rank {r['rank']} zero2 step off the replicated one: loss "
                        f"{n['loss_err']} rel, gradient {n['grad_name']} at {n['grad']} and "
                        f"parameter {n['worst_name']} at {n['worst']} of their allowances")
            elif not (n["loss_err"] < n["loss_tol"] and n["rel_l2"] <= n["rel_l2_tol"]):
                failures.append(
                    f"rank {r['rank']} {name} off the exact run: loss {n['loss_err']} (< "
                    f"{n['loss_tol']}), parameter change rel L2 {n['rel_l2']} (<= "
                    f"{n['rel_l2_tol']})")
        for control, n in r["controls"].items():
            if n["loss_err"] < n["loss_tol"] and n["rel_l2"] <= n["rel_l2_tol"]:
                failures.append(
                    f"rank {r['rank']} control {control} passed the gate: loss "
                    f"{n['loss_err']} (< {n['loss_tol']}), rel L2 {n['rel_l2']} (<= "
                    f"{n['rel_l2_tol']})")
    return failures


def parallel_rank_zero2_train(spec: dict, model_dir: str, steps: int) -> dict:
    """On every rank: train_eval_model of BC on the 4-rank data mesh in the
    int8 ZeRO-2 regime up to `steps` (resuming from model_dir's newest
    checkpoint); returns the final eval, the rank's launches and peak GiB."""
    import torch

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    cfg = spec["zero2"]
    mesh = _rank_setup(spec, PARALLEL_RANKS, 1)
    model = TransformerBCModel(mesh=mesh, **spec["model"])
    train = cfg["train"]
    if spec["device"].startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    final_eval = train_eval_model(
        model,
        DefaultRandomInputGenerator(batch_size=cfg["batch"], seed=0),
        DefaultRandomInputGenerator(batch_size=cfg["batch"], seed=1000),
        model_dir=model_dir, max_train_steps=steps,
        save_checkpoints_steps=train["save_every"], eval_steps=train["eval_steps"],
        log_every_steps=train["save_every"], device=spec["device"], mesh=mesh,
        shard_weight_update=True, collective_quant="int8", collective_block=cfg["block"],
    )
    _sync(spec["device"])
    return {"final_eval": final_eval, "launches": read_launches(),
            "peak_gib": _peak_gib(spec["device"])}


def _flat_update_check(spec: dict) -> tuple:
    """On one card: a flatten_optimizer_update BC step against the
    per-leaf step from the same seed-0 weights and the full batch, under
    _adam_step_gate. Returns (what it found, the launches of both
    steps)."""
    import torch

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model = TransformerBCModel(**spec["model"])
    batch = to_device(_bc_batch(model, spec["zero2"]["batch"], seed=0), DEVICE)
    launches = {k: 0 for k in read_launches()}
    results = []
    for flat in (False, True):
        trainer = Trainer(model, device=DEVICE, flatten_optimizer_update=flat)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        start = {k: v.detach().clone() for k, v in state.network.state_dict().items()}
        reset_launches()
        with _deterministic_convs():
            loss = float(trainer.train_step(state, batch)["loss"])
        for name, count in read_launches().items():
            launches[name] += count
        results.append((loss, {k: v.detach().clone()
                               for k, v in state.network.state_dict().items()},
                        _first_moments(trainer, state), state.optimizer))
        del trainer, state
    (loss, leaf, leaf_m, optimizer), (flat_loss, flat, flat_m, _) = results
    loss_err = abs(flat_loss - loss) / abs(loss)
    (grad, grad_name), (worst, worst_name) = _adam_step_gate(
        flat, leaf, start, flat_m, leaf_m, optimizer)
    if not (loss_err <= LOSS_TOL and grad <= 1.0 and worst <= 1.0):
        raise AssertionError(f"flat update off the per-leaf step: loss {loss_err} rel, "
                             f"gradient {grad_name} at {grad} and parameter {worst_name} "
                             f"at {worst} of their allowances")
    return (f"loss {loss_err:.2e} rel, worst gradient {grad_name} at {grad:.2e} and worst "
            f"parameter {worst_name} at {worst:.2e} of their allowances"), launches


def parallel_zero2(world, spec: dict, model_dir: str) -> dict:
    """ZeRO-2 on the ranks: each codec's steps against the replicated and
    the exact steps, train_eval_model in int8 with a checkpoint of the
    residuals and a resume, served on one card; the flat update on one
    card. Returns the launches of every main-path call."""
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.metrics import read_metrics

    t0 = time.monotonic()
    cfg = spec["zero2"]
    launches = {name: 0 for name in read_launches()}

    def add(counts) -> None:
        for name, count in counts.items():
            launches[name] += count

    ranks = world.run(parallel_rank_zero2, spec, timeout_s=PARALLEL_TIMEOUT)
    for r in ranks:
        add(r["launches"])
    head = ranks[0]["regimes"]
    rep = head["replicated"]
    log(f"[parallel_zero2] BC ({head['none']['n_params']} parameters) on a "
        f"{PARALLEL_RANKS}-rank data mesh, global batch {cfg['batch']}, block "
        f"{cfg['block']}, on {card_line()}: replicated step optimizer state "
        f"{rep['opt_mb']:.3f} MB a rank, gloo host-staged {rep['staged_mb']:.3f} MB")
    for name in cfg["regimes"]:
        r = head[name]
        if name == "none":
            gate = (f"step 1 vs the replicated step: loss {r['loss_err']:.2e} rel, worst "
                    f"gradient {r['grad_name']} at {r['grad']:.2e} and worst parameter "
                    f"{r['worst_name']} at {r['worst']:.2e} of their allowances")
        else:
            gate = (f"after {cfg['steps']} steps vs the exact run: loss {r['loss_err']:.2e} "
                    f"abs (allowed {r['loss_tol']:.2e}), parameter change rel L2 "
                    f"{r['rel_l2']:.3e} (allowed {r['rel_l2_tol']}), worst parameter "
                    f"{r['param_err']:.2e} abs; the losses "
                    f"{[round(x, 6) for x in r['losses']]}, the exact run's "
                    f"{[round(x, 6) for x in head['none']['losses']]}")
        exchange = (f"; one exchange {r['exchange_ms']:.3f} ms (median of 5)"
                    if "exchange_ms" in r else "")
        log(f"[parallel_zero2] {name} ({r['regime']}) on {card_line()}: {gate}; wire "
            f"{r['wire_pre_mb']:.3f} MB f32 -> {r['wire_post_mb']:.3f} MB a rank a step "
            f"({r['wire_pre_mb'] / r['wire_post_mb']:.2f}x){exchange}; optimizer state "
            f"{r['opt_mb']:.3f} MB a rank (replicated {rep['opt_mb']:.3f}); B1/B3/B4 "
            f"{spec['layers']} each a rank a step; synced step median {r['step_ms']:.3f} ms "
            f"(min {r['step_min']:.3f}, max {r['step_max']:.3f}) over {cfg['steps']} on rank "
            f"0, medians by rank {[round(x['regimes'][name]['step_ms'], 3) for x in ranks]}; "
            f"gloo host-staged {r['staged_mb']:.3f} MB a step on rank 0; peak GiB by rank "
            f"{[round(x['regimes'][name]['peak_gib'], 3) for x in ranks]}")
    for control, c in ranks[0]["controls"].items():
        log(f"[parallel_zero2] control {control} (must fail) on {card_line()}: after "
            f"{cfg['steps']} steps vs the exact run: loss {c['loss_err']:.2e} abs (allowed "
            f"{c['loss_tol']:.2e}), parameter change rel L2 {c['rel_l2']:.3e} (allowed "
            f"{c['rel_l2_tol']}), worst parameter {c['param_err']:.2e} abs")
    failures = _zero2_failures(ranks)
    if failures:
        raise AssertionError("; ".join(failures))
    train = cfg["train"]
    steps, layers = train["steps"], spec["layers"]
    evals = steps // train["save_every"]
    want = {"flash_fwd": layers * evals * train["eval_steps"],
            "flash_fwd_tile": layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps}
    with tempfile.TemporaryDirectory(dir=model_dir) as run_dir:
        t_train = time.monotonic()
        runs = []
        for last in (steps, 2 * steps):  # the second resumes from the first's checkpoint
            runs.append(world.run(parallel_rank_zero2_train, spec, run_dir, last,
                                  timeout_s=PARALLEL_TIMEOUT))
            for r in runs[-1]:
                if r["launches"] != want:
                    raise AssertionError(f"int8 train_eval_model to {last} launched "
                                         f"{r['launches']} != {want}")
                add(r["launches"])
            finals = {round(r["final_eval"]["eval/mse"], 9) for r in runs[-1]}
            if len(finals) != 1 or not all(math.isfinite(e) for e in finals):
                raise AssertionError(f"ranks' final evals {finals}")
            if last == steps:
                saved = state_lib.load_checkpoint(run_dir, steps)
                grad = saved["collective_residual"]["grad"]
                if grad.shape[0] != PARALLEL_RANKS or not grad.abs().max() > 0:
                    raise AssertionError(f"checkpoint residual {tuple(grad.shape)}")
        lines = read_metrics(os.path.join(run_dir, "train"))
        if not lines or not all(line["collective/compression"] > 3.5 for line in lines):
            raise AssertionError(f"metrics lines {lines}")
        served, served_launches = _serve_mesh_checkpoint(
            run_dir, list(range(train["save_every"], 2 * steps + 1, train["save_every"])))
        add(served_launches)
        log(f"[parallel_zero2] train_eval_model in int8 on the {PARALLEL_RANKS}-rank data "
            f"mesh on {card_line()}: {steps} steps, then a resume to {2 * steps} (each run "
            f"B1/B3/B4 {layers * steps} a rank, B2 {want['flash_fwd']} in its eval); "
            f"{steps}.pt holds the residuals ({tuple(grad.shape)} gradient); metrics lines "
            f"carry collective/compression {lines[-1]['collective/compression']:.3f} and "
            f"wall {lines[-1]['collective/wall_ms']:.3f} ms; final eval "
            f"{runs[-1][0]['final_eval']} on every rank; {served}; peak GiB by rank "
            f"{[round(r['peak_gib'], 3) for r in runs[-1]]}; "
            f"{time.monotonic() - t_train:.1f}s")
    found, flat_launches = _flat_update_check(spec)
    add(flat_launches)
    log(f"[parallel_zero2] flatten_optimizer_update on one card ({card_line()}): one step "
        f"against the per-leaf step, {found}; B1/B3/B4 {layers} each a step")
    log(f"[parallel_zero2] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_zero2']} s)")
    return launches


# -- parallel_sharded: parameters sharded over fsdp and model on the same ranks --

# BC at the BC width on a 1 data x 2 fsdp x 2 model mesh, the sharded_params
# regime (mesh.param_sharding: every leaf of mesh.MIN_WEIGHT_SIZE elements
# or more split four ways, each kernel's output channels over model and its
# inputs over fsdp, the pos_embedding's E over model and T over fsdp),
# global batch 8 (4 episodes a data x fsdp shard; the two model ranks of a
# shard hold the same episodes). Its train_eval_model run clips to global
# norm `clip`, below the BC gradient's norm, so every step clips.
PARALLEL_SHARDED = dict(mesh=(1, 2, 2), batch=8, clip=0.05,
                        train=dict(steps=4, save_every=2, eval_steps=1))


def _sharded_reference(kwargs: dict, device: str, weights: dict, batch) -> tuple:
    """Rank 0: the single-device flash step on the whole batch from the
    gathered weights: (loss, {name: gradient}, eval actions)."""
    import torch

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model = TransformerBCModel(**kwargs)
    trainer = Trainer(model, device=device)
    network = trainer.init_state(params=weights).network
    network.train()
    with _deterministic_convs():
        loss, _ = trainer.forward_loss(network, batch)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in network.named_parameters()}
    network.zero_grad(set_to_none=True)
    with torch.inference_mode():
        network.eval()
        features, _ = trainer.preprocessor.preprocess(batch["features"], None, mode="eval")
        action = model.packed_inference(network, features, "eval")[2]["inference_output"]
    return loss.item(), grads, action


def _bc_grad_gate(loss: float, grads: dict, ref_loss: float, ref_grads: dict) -> dict:
    """A mesh step's loss and gathered gradients against the single-device
    step's: the loss error (LOSS_TOL rel) and the worst gradient's share of
    its allowance (GRAD_TOL of its leaf's max + 1e-7) and its leaf."""
    worst, worst_name = 0.0, ""
    for name, ref in ref_grads.items():
        share = (grads[name] - ref).abs().max().item() / (
            GRAD_TOL * ref.abs().max().item() + 1e-7)
        if share > worst:
            worst, worst_name = share, name
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    return dict(loss=loss, ref_loss=ref_loss, loss_err=loss_err, worst=worst,
                worst_name=worst_name, ok=loss_err <= LOSS_TOL and worst <= 1.0)


def parallel_rank_sharded(spec: dict) -> dict:
    """On every rank of the 1 x 2 x 2 mesh: one step's loss and every
    gradient (gathered whole) against the single-device flash step on
    rank 0, the same step with the output gather's backward left as
    all_gather's (the control, which must fail; its launches are checked,
    not counted), an eval forward, the bytes this rank holds against the
    reckoning, then the synced step (median of `timed`), staged MB and
    peak GiB, and the same steps with the column split off. Returns the
    rank's numbers and the launches of its main-path calls."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import collectives, sharded_params
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    cfg, device, layers = spec["sharded"], spec["device"], spec["layers"]
    data, fsdp, model_size = cfg["mesh"]
    mesh = _rank_setup(spec, data, 1, fsdp=fsdp, model=model_size)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = TransformerBCModel(**spec["model"])
    trainer = Trainer(model, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    network, layout = state.network, trainer.param_layout
    weights = trainer.checkpoint_state(state, optimizer=False)["params"]
    host = _bc_batch(model, cfg["batch"], seed=0)
    batch = to_device(mesh_lib.shard_batch(host, mesh), device)
    rank = dist.get_rank()
    want = {"flash_fwd": 0, "flash_fwd_tile": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}
    out = {"rank": rank, "regime": trainer.regime, "layout": len(layout),
           "launches": {k: 0 for k in read_launches()}}
    # The reckoning, from the whole leaves and not from the trainer's
    # layout: at the BC width every leaf of mesh.MIN_WEIGHT_SIZE elements
    # or more splits fsdp x model ways (its last dim and another divide),
    # and every other leaf stays whole.
    ways = fsdp * model_size
    sizes = [weights[n].numel() for n, _ in network.named_parameters()]
    split = [n for n in sizes if n >= mesh_lib.MIN_WEIGHT_SIZE]
    out.update(params_split=sum(split), leaves_rule=len(split),
               params_rule=sum(n // ways if n >= mesh_lib.MIN_WEIGHT_SIZE else n
                               for n in sizes))

    def gate_step(control: bool):
        saved = collectives._GatherFrom
        if control:
            collectives._GatherFrom = collectives._AllGather
        network.train()
        reset_launches()
        try:
            with _deterministic_convs():
                features, labels = trainer.preprocess_train(batch)
                loss, metrics = trainer.backward(network, features, labels)
                loss, _ = trainer.reduce_gradients(state, loss, metrics)
            _sync(device)
        finally:
            collectives._GatherFrom = saved
        launches = read_launches()
        if launches != want:
            raise AssertionError(f"rank {rank} sharded step launched {launches} != {want}")
        if not control:
            for name, count in launches.items():
                out["launches"][name] += count
        grads = sharded_params.full_grads(network, layout, mesh)
        network.zero_grad(set_to_none=True)
        return loss.item(), grads

    loss, grads = gate_step(False)
    with torch.inference_mode():
        network.eval()
        features, _ = trainer.preprocessor.preprocess(batch["features"], None, mode="eval")
        reset_launches()
        action = model.packed_inference(network, features, "eval")[2]["inference_output"]
        _sync(device)
    launches = read_launches()
    eval_want = {"flash_fwd": layers, "flash_fwd_tile": 0, "flash_bwd_dq": 0,
                 "flash_bwd_dkv": 0}
    if launches != eval_want:
        raise AssertionError(f"rank {rank} sharded eval launched {launches} != {eval_want}")
    for name, count in launches.items():
        out["launches"][name] += count
    control_loss, control_grads = gate_step(True)
    if rank == 0:
        ref_loss, ref_grads, ref_action = _sharded_reference(
            spec["model"], device, weights, to_device(host, device))
        out["gate"] = _bc_grad_gate(loss, grads, ref_loss, ref_grads)
        out["control"] = _bc_grad_gate(control_loss, control_grads, ref_loss, ref_grads)
        out["norm"] = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                                    for g in ref_grads.values()))
        rows = ref_action[:action.shape[0]]
        out["eval_err"] = ((action - rows).abs() / (1 + rows.abs())).max().item()
        del ref_grads, ref_action
    del grads, control_grads, action, weights
    dist.barrier()

    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out.update(_timed_mesh_steps(trainer, state, batch, device, spec["timed"]))
    launches = read_launches()
    steps = 2 + spec["timed"]
    if launches != {name: count * steps for name, count in want.items()}:
        raise AssertionError(f"rank {rank} sharded timed steps launched {launches}")
    for name, count in launches.items():
        out["launches"][name] += count
    out.update(_state_bytes(state, trainer))

    # The same timed steps with every sharded leaf gathered on use, the
    # column split off: what the column split's activation traffic costs
    # against gathering its weights. Checked, not counted.
    del state, network
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    column_layers = sharded_params._COLUMN_LAYERS
    sharded_params._COLUMN_LAYERS = ()
    try:
        gathered = Trainer(model, device=device, mesh=mesh)
        gathered_state = gathered.init_state(torch.Generator().manual_seed(0))
    finally:
        sharded_params._COLUMN_LAYERS = column_layers
    reset_launches()
    timed = _timed_mesh_steps(gathered, gathered_state, batch, device, spec["timed"])
    launches = read_launches()
    if launches != {name: count * steps for name, count in want.items()}:
        raise AssertionError(f"rank {rank} gathered-on-use steps launched {launches}")
    out["gathered"] = {k: timed[k] for k in ("step_ms", "step_min", "step_max", "staged_mb")}
    return out


def _recording_clip(clip: float, scales: list):
    """An Adam factory clipped to global norm `clip` whose optimizer
    appends each update's clip factor to `scales`."""
    from tensor2robot_tpu_torch.models import optimizers

    def create():
        clipped = optimizers.with_gradient_clipping(optimizers.create_adam_optimizer(),
                                                    max_global_norm=clip)

        def bind(params):
            optimizer = clipped(params)
            step = optimizer.step

            def recorded(closure=None):
                result = step(closure)
                scales.append(float(optimizer.clip_scale))
                return result

            optimizer.step = recorded
            return optimizer

        return bind

    return create


def parallel_rank_sharded_train(spec: dict, model_dir: str) -> dict:
    """On every rank: train_eval_model of BC on the 1 x 2 x 2 mesh, clipped
    (PARALLEL_SHARDED's clip), with checkpoints; then a trainer on the
    mesh resumes the newest one and gathers it again. Returns the final
    eval, each step's clip factor, the launches, peak GiB and (rank 0)
    the resumed state gathered whole."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.train_eval import (
        Trainer,
        restore_or_init_state,
        train_eval_model,
    )

    cfg = spec["sharded"]
    data, fsdp, model_size = cfg["mesh"]
    mesh = _rank_setup(spec, data, 1, fsdp=fsdp, model=model_size)
    train, scales = cfg["train"], []
    model = TransformerBCModel(create_optimizer_fn=_recording_clip(cfg["clip"], scales),
                               **spec["model"])
    if spec["device"].startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    final_eval = train_eval_model(
        model,
        DefaultRandomInputGenerator(batch_size=cfg["batch"], seed=0),
        DefaultRandomInputGenerator(batch_size=cfg["batch"], seed=1000),
        model_dir=model_dir, max_train_steps=train["steps"],
        save_checkpoints_steps=train["save_every"], eval_steps=train["eval_steps"],
        log_every_steps=train["save_every"], device=spec["device"], mesh=mesh,
    )
    _sync(spec["device"])
    launches = read_launches()
    trainer = Trainer(TransformerBCModel(create_optimizer_fn=_recording_clip(cfg["clip"], []),
                                         **spec["model"]), device=spec["device"], mesh=mesh)
    resumed = trainer.checkpoint_state(restore_or_init_state(model_dir, trainer))
    out = {"final_eval": final_eval, "scales": scales, "launches": launches,
           "peak_gib": _peak_gib(spec["device"]), "regime": trainer.regime}
    if dist.get_rank() == 0:
        out["resumed"] = dict(
            step=resumed["step"],
            params={k: v.cpu() for k, v in resumed["params"].items()},
            moments={i: {k: v.cpu() for k, v in e.items()}
                     for i, e in resumed["optimizer"]["state"].items()})
    return out


def _one_card_resume(spec: dict, model_dir: str, resumed: dict, clip: float) -> str:
    """The newest checkpoint restored by the one-card trainer (Adam
    clipped to global norm `clip`, as the run was), against the mesh
    trainer's resume gathered whole, bit for bit: every parameter and Adam
    moment."""
    import torch

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.train_eval import Trainer, restore_or_init_state

    trainer = Trainer(TransformerBCModel(
        create_optimizer_fn=_recording_clip(clip, []), **spec["model"]), device=DEVICE)
    state = restore_or_init_state(model_dir, trainer)
    if state.step != resumed["step"]:
        raise AssertionError(f"one card resumed step {state.step} != {resumed['step']}")
    for name, value in state.network.state_dict().items():
        if not torch.equal(value.cpu(), resumed["params"][name]):
            raise AssertionError(f"one-card resume {name} differs from the mesh's")
    saved = state.optimizer.state_dict()["state"]
    for index, entry in resumed["moments"].items():
        for key, value in entry.items():
            if not torch.equal(saved[index][key].cpu(), value):
                raise AssertionError(f"one-card resume moment {index} {key} differs")
    return (f"{resumed['step']}.pt resumed on one card equal bit for bit to the mesh's "
            f"resume gathered whole ({len(resumed['params'])} entries, "
            f"{len(resumed['moments'])} moment pairs)")


def parallel_sharded(world, spec: dict, model_dir: str) -> dict:
    """Parameter sharding on the ranks: one step against the single-device
    step and its control, bytes a rank, the synced step; then
    train_eval_model clipped by a global norm, resumed on one card and
    served from one card. Returns the launches of every main-path call."""
    t0 = time.monotonic()
    cfg = spec["sharded"]
    layers = spec["layers"]
    launches = {name: 0 for name in read_launches()}

    def add(counts) -> None:
        for name, count in counts.items():
            launches[name] += count

    ranks = world.run(parallel_rank_sharded, spec, timeout_s=PARALLEL_TIMEOUT)
    for r in ranks:
        add(r["launches"])
    head = ranks[0]
    gate, control = head["gate"], head["control"]
    failures = []
    if not (gate["ok"] and head["eval_err"] <= SERVE_TOL):
        failures.append(f"sharded step off the single-device one: {gate}, eval "
                        f"{head['eval_err']}")
    if control["ok"]:
        failures.append(f"control (a model-dim gradient summed) passed the gate: {control}")
    for r in ranks:
        if r["regime"] != "sharded_params" or r["layout"] != r["leaves_rule"] or not (
                r["param_bytes"] == 4 * r["params_rule"] < r["whole_bytes"]):
            failures.append(f"rank {r['rank']} {r['regime']} holds {r['param_bytes']} "
                            f"parameter bytes in {r['layout']} sharded leaves, the "
                            f"reckoning {4 * r['params_rule']} in {r['leaves_rule']}")
        if r["opt_bytes"] != 2 * r["param_bytes"]:
            failures.append(f"rank {r['rank']} bytes {r['param_bytes']} / {r['opt_bytes']}")
    data, fsdp, model_size = cfg["mesh"]
    log(f"[parallel_sharded] BC ({head['whole_bytes'] // 4} parameters) on a {data} data x "
        f"{fsdp} fsdp x {model_size} model mesh, global batch {cfg['batch']} "
        f"({cfg['batch'] // (data * fsdp)} episodes a data x fsdp shard), regime "
        f"{head['regime']}, on {card_line()}: {head['layout']} leaves sharded "
        f"({head['params_split']} parameters split {fsdp * model_size} ways); "
        f"{head['param_bytes'] // 4} parameters a rank ({head['param_bytes'] / 1e6:.3f} MB, the "
        f"reckoning's {4 * head['params_rule'] / 1e6:.3f} MB), Adam moments "
        f"{head['opt_bytes'] / 1e6:.3f} MB a rank against "
        f"{2 * head['whole_bytes'] / 1e6:.3f} MB replicated; one step vs the single-device "
        f"step: loss {gate['loss']:.7f} vs {gate['ref_loss']:.7f} (rel "
        f"{gate['loss_err']:.2e}), worst gradient {gate['worst_name']} at "
        f"{gate['worst']:.3e} of its allowance; eval forward within "
        f"{head['eval_err']:.2e}; control with the output gather's backward summed over "
        f"model: worst gradient {control['worst_name']} at {control['worst']:.1f} of its "
        f"allowance (fails, as it must); the global gradient norm {head['norm']:.4f}; "
        f"B1/B3/B4 {layers} each a rank a step (B2 {layers} in its eval); synced step "
        f"median {head['step_ms']:.3f} ms (min {head['step_min']:.3f}, max "
        f"{head['step_max']:.3f}) over {spec['timed']} on rank 0, medians by rank "
        f"{[round(r['step_ms'], 3) for r in ranks]}; gloo host-staged "
        f"{head['staged_mb']:.3f} MB a step on rank 0; peak GiB by rank "
        f"{[round(r['peak_gib'], 3) for r in ranks]}; every sharded leaf gathered on use "
        f"(no column split), same ranks and batch: synced step median "
        f"{head['gathered']['step_ms']:.3f} ms (min {head['gathered']['step_min']:.3f}, max "
        f"{head['gathered']['step_max']:.3f}), medians by rank "
        f"{[round(r['gathered']['step_ms'], 3) for r in ranks]}, gloo host-staged "
        f"{head['gathered']['staged_mb']:.3f} MB a step on rank 0")
    if failures:
        raise AssertionError("; ".join(failures))

    train = cfg["train"]
    steps = train["steps"]
    evals = steps // train["save_every"]
    want = {"flash_fwd": layers * evals * train["eval_steps"],
            "flash_fwd_tile": layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps}
    with tempfile.TemporaryDirectory(dir=model_dir) as run_dir:
        t_train = time.monotonic()
        runs = world.run(parallel_rank_sharded_train, spec, run_dir,
                         timeout_s=PARALLEL_TIMEOUT)
        for r in runs:
            if r["launches"] != want:
                raise AssertionError(f"sharded train_eval_model launched {r['launches']} "
                                     f"!= {want}")
            add(r["launches"])
        finals = {round(r["final_eval"]["eval/mse"], 9) for r in runs}
        if len(finals) != 1 or not all(math.isfinite(e) for e in finals):
            raise AssertionError(f"ranks' final evals {finals}")
        scales = runs[0]["scales"]
        if (len(scales) != steps or not all(0 < x < 1 for x in scales)
                or any(r["scales"] != scales for r in runs)):
            raise AssertionError(f"clip factors by rank {[r['scales'] for r in runs]}")
        resumed = _one_card_resume(spec, run_dir, runs[0]["resumed"], cfg["clip"])
        served, served_launches = _serve_mesh_checkpoint(
            run_dir, list(range(train["save_every"], steps + 1, train["save_every"])))
        add(served_launches)
        log(f"[parallel_sharded] train_eval_model on the {data} x {fsdp} x {model_size} "
            f"mesh clipped to global norm {cfg['clip']} on {card_line()}: {steps} steps "
            f"(B1/B3/B4 {layers * steps} a rank, B2 {want['flash_fwd']} in its evals), clip "
            f"factor by step {[round(x, 6) for x in scales]}, the same on every rank; final "
            f"eval {runs[0]['final_eval']} on every rank; {resumed}; {served}; peak GiB by "
            f"rank {[round(r['peak_gib'], 3) for r in runs]}; "
            f"{time.monotonic() - t_train:.1f}s")
    log(f"[parallel_sharded] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_sharded']} s)")
    return launches


# -- parallel_composed and parallel_3d: the composed regimes on the ranks ----------

# BC at the BC width, global batch 8, on composed meshes of the 4 ranks:
# name -> ((data, fsdp, sequence, pipe), trainer kwargs, the regime), the
# meshes of ROADMAP.md A9.4c part 1: (a) zero2 on 2 data x 2 sequence (the
# ring) over ("data", "sequence"), (b) the same mesh over ("data",), (c)
# zero2 on 2 data x 2 pipe (JAX's dp_pp_zero2), (d) sharded parameters on
# 2 fsdp x 2 sequence, (e) on 2 fsdp x 2 pipe, (f) the flat update on
# 2 data x 2 pipe. `controls`: the mechanism each control breaks (it must
# fail the gate); `untimed`: the meshes that get the gate only, the others
# `timed` synced steps; the train_eval_model run on mesh `train_mesh`,
# clipped to global norm `clip`
# (below the BC gradient's norm, so every step clips), resumed on mesh
# `resume`.
PARALLEL_COMPOSED = dict(
    meshes={
        "a": ((2, 1, 2, 1), dict(shard_weight_update=True,
                                 weight_update_axes=("data", "sequence")), "zero2"),
        "b": ((2, 1, 2, 1), dict(shard_weight_update=True), "zero2"),
        "c": ((2, 1, 1, 2), dict(shard_weight_update=True), "zero2"),
        "d": ((1, 2, 2, 1), {}, "sharded_params"),
        "e": ((1, 2, 1, 2), {}, "sharded_params"),
        "f": ((2, 1, 1, 2), dict(flatten_optimizer_update=True), "replicated"),
    },
    controls={"a": "slice_over_data", "d": "whole_over_data_fsdp", "c": "stages_unaveraged"},
    untimed=("f",), timed=2, batch=8, clip=0.05, train_mesh="a", resume="d",
    train=dict(steps=4, save_every=2, eval_steps=1))
# JAX's dp_sp_pp preset on 8 ranks sharing the card: 2 data x 2 sequence
# x 2 pipe, zero2 over ("data", "sequence"), against the single-device
# step and against its ("data",) twin; `timed` synced steps.
PARALLEL_3D = dict(ranks=8, mesh=(2, 1, 2, 2), axes=("data", "sequence"), twin=("data",),
                   timed=1, batch=8)


@contextlib.contextmanager
def _composed_control(name, trainer):
    """A control of parallel_composed in force inside (None: none): zero2's
    slice summed over the data ranks alone (the other sequence ranks'
    tokens dropped), the whole leaves averaged over data x fsdp alone, or
    the stage entries left un-averaged over their stage's ranks."""
    from tensor2robot_tpu_torch.parallel import collectives
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    def data_only(x, mesh, axis_name, scatter_dimension=0):
        _, size, index = mesh_lib.dims_group(mesh, axis_name)
        summed = collectives.psum(x, mesh, mesh_lib.DATA_AXIS)
        return summed.chunk(size, dim=scatter_dimension)[index]

    saved = collectives.psum_scatter, mesh_lib.stage_group
    if name == "slice_over_data":
        collectives.psum_scatter = data_only
    elif name == "whole_over_data_fsdp":
        trainer.mean_axes = (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS)
    elif name == "stages_unaveraged":
        mesh_lib.stage_group = lambda mesh: (None, 1)
    try:
        yield
    finally:
        collectives.psum_scatter, mesh_lib.stage_group = saved


def _reckoned_elements(weights: dict, stages: int, param_ways: int,
                       moment_ways: int) -> tuple:
    """(parameters, elements of one Adam moment) a rank holds, reckoned
    from the whole leaves of the chain's state dict `weights`, not from
    any trainer's layout: over `stages` > 1 a block's leaves are its
    stage's (a rank holds 1/stages of them, whole); every other leaf of
    mesh.MIN_WEIGHT_SIZE elements or more splits `param_ways` ways as a
    parameter and `moment_ways` ways as a moment (at the BC width each has
    a dim that divides), and a smaller one stays whole."""
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

    params = moments = 0
    for name, value in weights.items():
        n = value.numel()
        if stages > 1 and ".block_" in name:
            params += n // stages
            moments += n // stages
        elif n >= mesh_lib.MIN_WEIGHT_SIZE:
            params += n // param_ways
            moments += n // moment_ways
        else:
            params += n
            moments += n
    return params, moments


def _f32_only() -> None:
    """A rank's f32 settings, as main() sets them (no TF32 in matmuls or
    cuDNN convolutions), before its first card work: the single-device
    reference runs before the rank's first mesh."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _composed_reference(spec: dict, weights: dict, host) -> dict:
    """Rank 0: the single-device flash step of BC from the chain
    `weights` on the whole batch, cuDNN's convs deterministic: the loss,
    the stepped parameters, Adam's first moments and the optimizer (its
    hyperparameters)."""
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    trainer = Trainer(TransformerBCModel(**spec["model"]), device=spec["device"])
    state = trainer.init_state(params=weights)
    with _deterministic_convs():
        loss = float(trainer.train_step(state, to_device(host, spec["device"]))["loss"])
    return dict(loss=loss, optimizer=state.optimizer,
                params={k: v.detach().clone() for k, v in state.network.state_dict().items()},
                moments=_first_moments(trainer, state))


def _composed_gate(got: dict, reference: dict, start: dict) -> dict:
    """A mesh step (loss, gathered chain parameters and first moments)
    against the single-device one: the loss error (LOSS_TOL rel) and
    _adam_step_gate's worst gradient and parameter shares."""
    (grad, grad_name), (worst, worst_name) = _adam_step_gate(
        got["params"], reference["params"], start, got["moments"], reference["moments"],
        reference["optimizer"])
    loss_err = abs(got["loss"] - reference["loss"]) / abs(reference["loss"])
    return dict(loss=got["loss"], loss_err=loss_err, grad=grad, grad_name=grad_name,
                worst=worst, worst_name=worst_name,
                ok=loss_err <= LOSS_TOL and grad <= 1.0 and worst <= 1.0)


def _composed_step(spec: dict, dims: tuple, kwargs: dict, weights: dict, host,
                   batch_size: int, timed: int, control=None) -> dict:
    """On every rank of the mesh `dims` (data, fsdp, sequence, pipe): BC
    (pipelined over a pipe dim) from the chain `weights` on this rank's
    share of the global batch `host` of `batch_size`, one gate step
    with `control` in force, its launches checked against the same
    shape's replicated step's (blocks x ring hops, or a stage's blocks x
    microbatches; none under sequence x pipe, whose manual ring runs the
    einsum tiles), the loss and the parameters and first moments gathered
    whole as the chain's, this rank's bytes; then, for `timed` > 0, the
    synced steps. Returns the numbers and the main-path launches (none
    for a control)."""
    import torch

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.parallel import pipeline
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    device, layers = spec["device"], spec["layers"]
    data, fsdp, sequence, stages = dims
    mesh = _rank_setup(spec, data, sequence, fsdp=fsdp, pipe=stages)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    extra = dict(pipeline_stages=stages) if stages > 1 else {}
    model = TransformerBCModel(mesh=mesh, **extra, **spec["model"])
    trainer = Trainer(model, device=device, mesh=mesh, **kwargs)
    state = trainer.init_state(params=weights)
    batch = to_device(mesh_lib.shard_batch(host, mesh), device)
    if stages > 1:
        per_step = 0 if sequence > 1 else layers // stages * _pipe_micro(
            batch_size // (data * fsdp), stages)
    else:
        per_step = layers * sequence
    want = {"flash_fwd": 0, "flash_fwd_tile": per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step}
    launches = {k: 0 for k in read_launches()}
    reset_launches()
    _sync(device)
    with _composed_control(control, trainer), _deterministic_convs():
        loss = float(trainer.train_step(state, batch)["loss"])
    _sync(device)
    got = read_launches()
    if got != want:
        raise AssertionError(f"{dims} {kwargs} {control} step launched {got} != {want}")
    if control is None:
        launches = dict(got)
    out = dict(loss=loss, regime=trainer.regime, per_step=per_step)
    out.update(_state_bytes(state, trainer))
    # Copies: the saved tensors may be the live ones, which the timed
    # steps move in place.
    saved = trainer.checkpoint_state(state)
    names = [n for n, _ in state.network.named_parameters()]
    out["params"] = pipeline.unstack_stages(
        {k: v.clone() for k, v in saved["params"].items()})
    out["moments"] = pipeline.unstack_stages({
        names[i]: entry["exp_avg"].clone() for i, entry in saved["optimizer"]["state"].items()})
    del saved
    if timed:
        reset_launches()
        out.update(_timed_mesh_steps(trainer, state, batch, device, timed))
        got = read_launches()
        if got != {name: count * (2 + timed) for name, count in want.items()}:
            raise AssertionError(f"{dims} {kwargs} timed steps launched {got}")
        for name, count in got.items():
            launches[name] += count
    out["launches"] = launches
    del trainer, state
    return out


def parallel_rank_composed(spec: dict) -> dict:
    """On every rank: the chain's seed-0 weights and the batch, rank 0's
    single-device reference step, then each mesh of PARALLEL_COMPOSED (a
    gate step, the synced steps) and each control; rank 0 holds every
    gate. Returns the rank's numbers (parameters and moments dropped)
    and the launches of its main-path calls."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )

    cfg, device = spec["composed"], spec["device"]
    _f32_only()
    model = TransformerBCModel(**spec["model"])
    weights = {k: v.detach() for k, v in model.init_network(
        torch.Generator().manual_seed(0), device).state_dict().items()}
    host = _bc_batch(model, cfg["batch"], seed=0)
    rank = dist.get_rank()
    reference = _composed_reference(spec, weights, host) if rank == 0 else None
    dist.barrier()
    out = {"rank": rank, "launches": {k: 0 for k in read_launches()}, "meshes": {},
           "controls": {}}
    for name, (dims, kwargs, _) in cfg["meshes"].items():
        timed = 0 if name in cfg["untimed"] else cfg["timed"]
        result = _composed_step(spec, dims, kwargs, weights, host, cfg["batch"], timed)
        for kernel, count in result.pop("launches").items():
            out["launches"][kernel] += count
        got = dict(loss=result.pop("loss"), params=result.pop("params"),
                   moments=result.pop("moments"))
        if rank == 0:
            result["gate"] = _composed_gate(got, reference, weights)
        out["meshes"][name] = result
        out["meshes"][name]["reckoned"] = _composed_reckoning(
            weights, dims, kwargs)
        del got
        dist.barrier()
    for name, control in cfg["controls"].items():
        dims, kwargs, _ = cfg["meshes"][name]
        result = _composed_step(spec, dims, kwargs, weights, host, cfg["batch"], 0, control)
        got = dict(loss=result.pop("loss"), params=result.pop("params"),
                   moments=result.pop("moments"))
        if rank == 0:
            out["controls"][f"({name}) {control}"] = _composed_gate(got, reference, weights)
        del got, result
        dist.barrier()
    return out


def _composed_reckoning(weights: dict, dims: tuple, kwargs: dict) -> tuple:
    """(parameters, one moment's elements) a rank holds on the mesh `dims`
    in the regime of `kwargs`, reckoned (_reckoned_elements)."""
    data, fsdp, sequence, stages = dims
    if fsdp > 1:
        return _reckoned_elements(weights, stages, fsdp, fsdp)
    if kwargs.get("shard_weight_update"):
        sizes = {"data": data, "fsdp": fsdp, "sequence": sequence, "pipe": stages}
        group = math.prod(sizes[axis] for axis in kwargs.get("weight_update_axes",
                                                               ("data",)))
        return _reckoned_elements(weights, stages, 1, group)
    return _reckoned_elements(weights, stages, 1, 1)


def parallel_rank_composed_train(spec: dict, model_dir: str) -> dict:
    """On every rank: train_eval_model of BC on PARALLEL_COMPOSED's
    train_mesh, clipped, with checkpoints; then a trainer on its resume
    mesh (another regime, the same model tree) resumes the newest one and
    gathers it. Returns the final eval, each step's clip factor, the
    launches, peak GiB and (rank 0) the resumed state gathered whole."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.train.train_eval import (
        Trainer,
        restore_or_init_state,
        train_eval_model,
    )

    cfg = spec["composed"]
    (data, fsdp, sequence, stages), kwargs, _ = cfg["meshes"][cfg["train_mesh"]]
    mesh = _rank_setup(spec, data, sequence, fsdp=fsdp, pipe=stages)
    train, scales = cfg["train"], []
    model = TransformerBCModel(mesh=mesh, create_optimizer_fn=_recording_clip(cfg["clip"], scales),
                               **spec["model"])
    if spec["device"].startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    final_eval = train_eval_model(
        model,
        DefaultRandomInputGenerator(batch_size=cfg["batch"], seed=0),
        DefaultRandomInputGenerator(batch_size=cfg["batch"], seed=1000),
        model_dir=model_dir, max_train_steps=train["steps"],
        save_checkpoints_steps=train["save_every"], eval_steps=train["eval_steps"],
        log_every_steps=train["save_every"], device=spec["device"], mesh=mesh, **kwargs,
    )
    _sync(spec["device"])
    launches = read_launches()
    (data, fsdp, sequence, stages), kwargs, _ = cfg["meshes"][cfg["resume"]]
    other = _rank_setup(spec, data, sequence, fsdp=fsdp, pipe=stages)
    trainer = Trainer(TransformerBCModel(mesh=other, **spec["model"]), device=spec["device"],
                      mesh=other, **kwargs)
    resumed = trainer.checkpoint_state(restore_or_init_state(model_dir, trainer))
    out = {"final_eval": final_eval, "scales": scales, "launches": launches,
           "peak_gib": _peak_gib(spec["device"]), "regime": trainer.regime}
    if dist.get_rank() == 0:
        out["resumed"] = dict(
            step=resumed["step"],
            params={k: v.cpu() for k, v in resumed["params"].items()},
            moments={i: {k: v.cpu() for k, v in e.items()}
                     for i, e in resumed["optimizer"]["state"].items()})
    return out


def _composed_failures(ranks: list, cfg: dict) -> list:
    """What every rank's parallel_rank_composed numbers break: a gate over
    its limits, a control within them, a regime that is not the mesh's,
    bytes other than the reckoning."""
    failures = []
    head = ranks[0]
    for name, r in head["meshes"].items():
        if not r["gate"]["ok"]:
            failures.append(f"mesh ({name}) off the single-device step: {r['gate']}")
    for name, gate in head["controls"].items():
        if gate["ok"]:
            failures.append(f"control {name} passed the gate: {gate}")
    for r in ranks:
        for name, m in r["meshes"].items():
            regime = cfg["meshes"][name][2]
            params, moment = m["reckoned"]
            if m["regime"] != regime:
                failures.append(f"rank {r['rank']} mesh ({name}) resolved {m['regime']}")
            if m["param_bytes"] != 4 * params or m["opt_bytes"] != 2 * 4 * moment:
                failures.append(
                    f"rank {r['rank']} mesh ({name}) holds {m['param_bytes']} parameter and "
                    f"{m['opt_bytes']} moment bytes, the reckoning {4 * params} and "
                    f"{8 * moment}")
    return failures


def parallel_composed(world, spec: dict, model_dir: str) -> dict:
    """The composed regimes on the 4 ranks: each mesh's step against the
    single-device step with exact launches and bytes, its synced steps,
    the controls; then train_eval_model clipped on mesh (a), resumed in
    another regime and on one card, served from one card. Returns the
    launches of every main-path call."""
    t0 = time.monotonic()
    cfg, layers = spec["composed"], spec["layers"]
    launches = {name: 0 for name in read_launches()}

    def add(counts) -> None:
        for name, count in counts.items():
            launches[name] += count

    ranks = world.run(parallel_rank_composed, spec, timeout_s=PARALLEL_TIMEOUT)
    for r in ranks:
        add(r["launches"])
    head = ranks[0]
    whole = head["meshes"]["a"]["whole_bytes"]
    for name, (dims, kwargs, regime) in cfg["meshes"].items():
        m, gate = head["meshes"][name], head["meshes"][name]["gate"]
        timing = ("gate only" if name in cfg["untimed"] else
                  f"synced step median {m['step_ms']:.3f} ms (min {m['step_min']:.3f}, max "
                  f"{m['step_max']:.3f}) over {cfg['timed']} on rank 0, medians by rank "
                  f"{[round(r['meshes'][name]['step_ms'], 3) for r in ranks]}; gloo "
                  f"host-staged {m['staged_mb']:.3f} MB a step on rank 0; peak GiB by rank "
                  f"{[round(r['meshes'][name]['peak_gib'], 3) for r in ranks]}")
        log(f"[parallel_composed] ({name}) {regime} on data x fsdp x sequence x pipe "
            f"{'x'.join(map(str, dims))} {kwargs} on {card_line()}: loss "
            f"{gate['loss']:.7f} (rel {gate['loss_err']:.2e}), worst gradient "
            f"{gate['grad_name']} at {gate['grad']:.2e} and worst parameter "
            f"{gate['worst_name']} at {gate['worst']:.2e} of their allowances; "
            f"{m['param_bytes'] // 4} parameters ({m['param_bytes'] / 1e6:.3f} MB) and Adam "
            f"moments {m['opt_bytes'] / 1e6:.3f} MB a rank (reckoned "
            f"{m['reckoned'][0]} and 2 x {m['reckoned'][1]} elements; replicated "
            f"{2 * whole / 1e6:.3f} MB); B1/B3/B4 {m['per_step']} each a rank a step; "
            f"{timing}")
    for name, gate in head["controls"].items():
        log(f"[parallel_composed] control {name} (must fail) on {card_line()}: loss rel "
            f"{gate['loss_err']:.2e}, worst gradient {gate['grad_name']} at "
            f"{gate['grad']:.2e} and worst parameter {gate['worst_name']} at "
            f"{gate['worst']:.2e} of their allowances")
    failures = _composed_failures(ranks, cfg)
    if failures:
        raise AssertionError("; ".join(failures))

    train = cfg["train"]
    steps = train["steps"]
    per_rank = layers * cfg["meshes"][cfg["train_mesh"]][0][2]  # the ring's hops
    want = {"flash_fwd": 0,
            "flash_fwd_tile": per_rank * (steps + train["eval_steps"] * steps
                                          // train["save_every"]),
            "flash_bwd_dq": per_rank * steps, "flash_bwd_dkv": per_rank * steps}
    with tempfile.TemporaryDirectory(dir=model_dir) as run_dir:
        t_train = time.monotonic()
        runs = world.run(parallel_rank_composed_train, spec, run_dir,
                         timeout_s=PARALLEL_TIMEOUT)
        for r in runs:
            if r["launches"] != want:
                raise AssertionError(f"composed train_eval_model launched {r['launches']} "
                                     f"!= {want}")
            add(r["launches"])
            if r["regime"] != cfg["meshes"][cfg["resume"]][2]:
                raise AssertionError(f"resumed in {r['regime']}")
        finals = {round(r["final_eval"]["eval/mse"], 9) for r in runs}
        if len(finals) != 1 or not all(math.isfinite(e) for e in finals):
            raise AssertionError(f"ranks' final evals {finals}")
        scales = runs[0]["scales"]
        if (len(scales) != steps or not all(0 < x < 1 for x in scales)
                or any(r["scales"] != scales for r in runs)):
            raise AssertionError(f"clip factors by rank {[r['scales'] for r in runs]}")
        resumed = _one_card_resume(spec, run_dir, runs[0]["resumed"], cfg["clip"])
        served, served_launches = _serve_mesh_checkpoint(
            run_dir, list(range(train["save_every"], steps + 1, train["save_every"])))
        add(served_launches)
        log(f"[parallel_composed] train_eval_model on mesh ({cfg['train_mesh']}) clipped to "
            f"global norm {cfg['clip']} on {card_line()}: {steps} steps (B1/B3/B4 "
            f"{per_rank * steps} a rank, B1 {want['flash_fwd_tile'] - per_rank * steps} "
            f"more in its ring evals), clip factor by step {[round(x, 6) for x in scales]}, "
            f"the same on every rank; final eval {runs[0]['final_eval']} on every rank; "
            f"{steps}.pt resumed in {runs[0]['regime']} on mesh ({cfg['resume']}); "
            f"{resumed}; {served}; peak GiB by rank "
            f"{[round(r['peak_gib'], 3) for r in runs]}; {time.monotonic() - t_train:.1f}s")
    log(f"[parallel_composed] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_composed']} s)")
    return launches


def parallel_rank_3d(spec: dict) -> dict:
    """On every rank of the 8: the chain's seed-0 weights, rank 0's
    single-device reference step, then the dp_sp_pp gate step over
    ("data", "sequence") with its synced steps, and its ("data",) twin's
    gate step; rank 0 holds both against the reference and the twin
    against the step. Returns the rank's numbers and launches (none: the
    manual ring of sequence x pipe runs the einsum tiles)."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )

    cfg, device = spec["three_d"], spec["device"]
    _f32_only()
    model = TransformerBCModel(**spec["model"])
    weights = {k: v.detach() for k, v in model.init_network(
        torch.Generator().manual_seed(0), device).state_dict().items()}
    host = _bc_batch(model, cfg["batch"], seed=0)
    rank = dist.get_rank()
    reference = _composed_reference(spec, weights, host) if rank == 0 else None
    dist.barrier()
    out = {"rank": rank}
    for name, axes, timed in (("step", cfg["axes"], cfg["timed"]), ("twin", cfg["twin"], 0)):
        kwargs = dict(shard_weight_update=True, weight_update_axes=axes)
        result = _composed_step(spec, cfg["mesh"], kwargs, weights, host, cfg["batch"], timed)
        got = dict(loss=result.pop("loss"), params=result.pop("params"),
                   moments=result.pop("moments"))
        result["reckoned"] = _composed_reckoning(weights, cfg["mesh"], kwargs)
        if rank == 0:
            result["gate"] = _composed_gate(got, reference, weights)
            if name == "step":
                first = got
            else:
                result["against_step"] = _composed_gate(got, dict(first, optimizer=reference[
                    "optimizer"]), weights)
        out[name] = result
        del got
        dist.barrier()
    return out


def parallel_3d(spec: dict) -> dict:
    """JAX's dp_sp_pp on 8 gloo ranks sharing the card (a second world):
    the gate step against the single-device step and its ("data",) twin,
    exact bytes, no flash launch, the synced steps. Returns the launches
    (all 0)."""
    from tensor2robot_tpu_torch.parallel.launch import LocalWorld

    t0 = time.monotonic()
    cfg = spec["three_d"]
    with LocalWorld(cfg["ranks"], threads=1, timeout_s=PARALLEL_TIMEOUT) as world:
        up = time.monotonic() - t0
        ranks = world.run(parallel_rank_3d, spec, timeout_s=PARALLEL_TIMEOUT)
    head = ranks[0]
    failures = []
    for name in ("step", "twin"):
        gate = head[name]["gate"]
        if not gate["ok"]:
            failures.append(f"dp_sp_pp {name} off the single-device step: {gate}")
    if not head["twin"]["against_step"]["ok"]:
        failures.append(f"dp_sp_pp twin off the step: {head['twin']['against_step']}")
    for r in ranks:
        for name in ("step", "twin"):
            m = r[name]
            params, moment = m["reckoned"]
            if m["regime"] != "zero2" or m["param_bytes"] != 4 * params or (
                    m["opt_bytes"] != 8 * moment) or any(m["launches"].values()):
                failures.append(f"rank {r['rank']} dp_sp_pp {name}: {m['regime']}, "
                                f"{m['param_bytes']} / {m['opt_bytes']} bytes (reckoned "
                                f"{4 * params} / {8 * moment}), launches {m['launches']}")
    step, twin = head["step"], head["twin"]
    log(f"[parallel_3d] dp_sp_pp: {cfg['ranks']} gloo ranks on {spec['device']} up in "
        f"{up:.1f}s, 2 data x 2 sequence x 2 pipe, zero2 over {cfg['axes']}, global batch "
        f"{cfg['batch']}, on {card_line()}: loss {step['gate']['loss']:.7f} (rel "
        f"{step['gate']['loss_err']:.2e}), worst gradient {step['gate']['grad_name']} at "
        f"{step['gate']['grad']:.2e} and worst parameter {step['gate']['worst_name']} at "
        f"{step['gate']['worst']:.2e} of their allowances; the {cfg['twin']} twin: rel "
        f"{twin['gate']['loss_err']:.2e}, {twin['gate']['grad']:.2e} and "
        f"{twin['gate']['worst']:.2e} against one card, {twin['against_step']['grad']:.2e} and "
        f"{twin['against_step']['worst']:.2e} against the step; Adam moments "
        f"{step['opt_bytes'] / 1e6:.3f} MB a rank ({twin['opt_bytes'] / 1e6:.3f} MB for the "
        f"twin), {step['param_bytes'] / 1e6:.3f} MB of parameters; no flash launch (the manual "
        f"ring's einsum tiles); synced step median {step['step_ms']:.3f} ms (min "
        f"{step['step_min']:.3f}, max {step['step_max']:.3f}) over {cfg['timed']} on rank 0, "
        f"medians by rank {[round(r['step']['step_ms'], 3) for r in ranks]}; gloo host-staged "
        f"{step['staged_mb']:.3f} MB a step on rank 0; peak GiB by rank "
        f"{[round(r['step']['peak_gib'], 3) for r in ranks]}")
    if failures:
        raise AssertionError("; ".join(failures))
    log(f"[parallel_3d] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_3d']} s)")
    return {name: 0 for name in read_launches()}


# -- parallel_moe_sequence: MoE BC on 2 expert x 2 sequence ranks ------------------

# MoE BC at the BC width on 2 expert x 2 sequence (ring) ranks: 4 experts,
# k = 2, batch 8 (every rank holds the whole batch: expert and sequence
# ranks share it), 2 resident experts a rank, each block's MoE gathering
# the episode's 2 shards before routing; `timed` synced steps.
PARALLEL_MOE_SEQUENCE = dict(experts=MOE_EXPERTS, mesh=(2, 2), timed=2)
# Each control must miss its gate by this factor or more.
CONTROL_MARGIN = 100


@contextlib.contextmanager
def _slicing_moe_gather(on: bool):
    """The MoE x sequence control in force inside when `on`: the MoE's
    gather of the sequence shards takes this rank's slice of the cotangent
    in its backward (gather_from) instead of summing the sequence ranks'
    (all_gather's psum_scatter)."""
    import types

    from tensor2robot_tpu_torch.layers import moe as moe_layers
    from tensor2robot_tpu_torch.parallel import collectives

    saved = moe_layers.collectives
    if on:
        moe_layers.collectives = types.SimpleNamespace(
            all_gather=collectives.gather_from, axis_index=collectives.axis_index)
    try:
        yield
    finally:
        moe_layers.collectives = saved


def parallel_rank_moe_sequence(spec: dict, episodes: list) -> dict:
    """On every rank of the 2 expert x 2 sequence mesh: one MoE BC
    backward on the batch's `episodes` (router picks recorded, gradients
    averaged by the trainer's bucket), its launches; the eval forward; then
    the control's backward. Rank 0 then takes the single-device MoE step
    and eval forward on the same weights and episodes and measures the
    mesh's loss, aux, gradients, eval action and the control against them
    (the caller gates them once it has compared the routing). Returns the
    picks, the main-path launches and rank 0's measurements."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    cfg, device = spec["moe_sequence"], spec["device"]
    experts, sequence = cfg["mesh"]
    mesh = _rank_setup(spec, 1, sequence, expert=experts)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    kwargs = dict(spec["model"], num_experts=cfg["experts"])
    model = TransformerBCModel(mesh=mesh, **kwargs)
    trainer = Trainer(model, device=device, mesh=mesh)
    network = trainer.init_state(torch.Generator().manual_seed(0)).network
    host = _bc_batch(model, spec["batch"], seed=0)
    part = {k: v[episodes] for k, v in host.items()}
    batch = to_device(mesh_lib.shard_batch(part, mesh), device)
    rank = dist.get_rank()

    def backward(control: bool):
        network.zero_grad(set_to_none=True)
        network.train()
        with _RouterRecorder() as recorder, _deterministic_convs(), \
                _slicing_moe_gather(control):
            features, labels = trainer.preprocess_train(batch)
            loss, metrics = trainer.backward(network, features, labels)
            loss, metrics = trainer.average_over_ranks(network, loss, metrics)
        grads = {n: p.grad.detach().clone() for n, p in network.named_parameters()}
        return loss, metrics, grads, recorder

    reset_launches()
    loss, metrics, grads, recorder = backward(False)
    _sync(device)
    launches = read_launches()
    with torch.inference_mode():
        network.eval()
        features, _ = trainer.preprocessor.preprocess(batch["features"], None, mode="eval")
        reset_launches()
        action = model.packed_inference(network, features, "eval")[2]["inference_output"]
        _sync(device)
        eval_launches = read_launches()
    control_loss, _, control_grads, _ = backward(True)
    out = dict(rank=rank, shard=0, launches=launches, eval_launches=eval_launches,
               picks=[(ids.cpu().numpy(), m.cpu().numpy()) for ids, m in recorder.picks(2)])
    if rank == 0:
        reference = TransformerBCModel(**kwargs)
        ref_trainer = Trainer(reference, device=device)
        ref_network = ref_trainer.init_state(params=network.state_dict()).network
        ref_network.train()
        with _RouterRecorder() as ref_recorder, _deterministic_convs():
            ref_loss, ref_metrics = ref_trainer.forward_loss(ref_network, batch)
            ref_loss.backward()
        ref_grads = {n: p.grad.detach() for n, p in ref_network.named_parameters()}
        with torch.inference_mode():
            ref_network.eval()
            ref_action = reference.packed_inference(
                ref_network, features, "eval")[2]["inference_output"]
        out.update(gate=_bc_grad_gate(loss.item(), grads, ref_loss.item(), ref_grads),
                   control=_bc_grad_gate(control_loss.item(), control_grads,
                                         ref_loss.item(), ref_grads),
                   aux=metrics["loss/moe_aux"].item(),
                   ref_aux=ref_metrics["loss/moe_aux"].item(),
                   eval_err=((action - ref_action).abs()
                             / (1 + ref_action.abs())).max().item(),
                   ref_picks=[(ids.cpu().numpy(), m.cpu().numpy())
                              for ids, m in ref_recorder.picks(2)])
    dist.barrier()
    return out


def parallel_rank_moe_sequence_time(spec: dict) -> dict:
    """On every rank: synced MoE train steps on the expert x sequence
    mesh; returns the median and spread, peak GiB, staged MB a step and
    the launches."""
    import torch

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    cfg, device = spec["moe_sequence"], spec["device"]
    experts, sequence = cfg["mesh"]
    mesh = _rank_setup(spec, 1, sequence, expert=experts)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = TransformerBCModel(mesh=mesh, num_experts=cfg["experts"], **spec["model"])
    trainer = Trainer(model, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = to_device(mesh_lib.shard_batch(_bc_batch(model, spec["batch"], seed=7), mesh),
                      device)
    reset_launches()
    out = _timed_mesh_steps(trainer, state, batch, device, cfg["timed"])
    out["launches"] = read_launches()
    return out


def parallel_moe_sequence(world, spec: dict) -> dict:
    """MoE BC on 2 expert x 2 sequence ranks against the single-device MoE
    step (the moe phase's routing rule), its eval forward, the control,
    then its synced step. Returns the launches of every rank's main-path
    calls."""
    t0 = time.monotonic()
    cfg, layers = spec["moe_sequence"], spec["layers"]
    experts, sequence = cfg["mesh"]
    per_step = layers * sequence  # B1/B3/B4: the ring's hops in every layer
    want = {"flash_fwd": 0, "flash_fwd_tile": per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step}
    eval_want = {"flash_fwd": 0, "flash_fwd_tile": per_step, "flash_bwd_dq": 0,
                 "flash_bwd_dkv": 0}
    launches = {name: 0 for name in want}
    episodes, dropped = list(range(spec["batch"])), []
    for _ in range(2):
        ranks = world.run(parallel_rank_moe_sequence, spec, episodes,
                          timeout_s=PARALLEL_TIMEOUT)
        for r in ranks:
            if r["launches"] != want or r["eval_launches"] != eval_want:
                raise AssertionError(f"rank {r['rank']} MoE x sequence step launched "
                                     f"{r['launches']}, its eval {r['eval_launches']}")
            for name in launches:
                launches[name] += r["launches"][name] + r["eval_launches"][name]
        flips = _moe_flips(ranks, episodes, 1)
        wide = [f for f in flips if f[3] >= MOE_FLIP_MARGIN]
        if wide:
            raise AssertionError(f"mesh routing differs past the margin {MOE_FLIP_MARGIN}: "
                                 f"(layer, episode, step, margin) {wide}")
        if not flips:
            break
        dropped += sorted({f[1] for f in flips})
        episodes = [e for e in episodes if e not in dropped]
        log(f"[parallel_moe_sequence] routing flips under the margin {MOE_FLIP_MARGIN} "
            f"(layer, episode, step, margin) {flips}: episodes {dropped} left out")
    else:
        raise AssertionError("mesh routing still flips after leaving episodes out")
    head = ranks[0]
    gate, control = head["gate"], head["control"]
    aux_err = abs(head["aux"] - head["ref_aux"]) / abs(head["ref_aux"])
    if not gate["ok"] or not aux_err <= LOSS_TOL or not head["eval_err"] <= SERVE_TOL:
        raise AssertionError(f"MoE x sequence step: {gate}; aux {head['aux']} vs "
                             f"{head['ref_aux']}; eval {head['eval_err']}")
    if not control["worst"] >= CONTROL_MARGIN:
        raise AssertionError(f"the slicing-gather control's worst gradient is "
                             f"{control['worst']} of its allowance, under {CONTROL_MARGIN}")
    timed = world.run(parallel_rank_moe_sequence_time, spec, timeout_s=PARALLEL_TIMEOUT)
    steps = 2 + cfg["timed"]
    for r in timed:
        if r["launches"] != {k: v * steps for k, v in want.items()}:
            raise AssertionError(f"{steps} MoE x sequence steps launched {r['launches']}")
        for name, count in r["launches"].items():
            launches[name] += count
    log(f"[parallel_moe_sequence] MoE BC ({cfg['experts']} experts, k = 2, "
        f"{cfg['experts'] // experts} resident a rank) on a {experts} expert x {sequence} "
        f"sequence (ring) mesh, batch {len(episodes)}, on {card_line()}: loss "
        f"{gate['loss']:.7f} vs one card {gate['ref_loss']:.7f} (rel {gate['loss_err']:.2e}); "
        f"loss/moe_aux {head['aux']:.7f} (rel {aux_err:.2e}); worst gradient "
        f"{gate['worst_name']} at {gate['worst']:.2e} of its allowance; eval forward within "
        f"{head['eval_err']:.2e}; routing picks differing {len(flips)} (left out: "
        f"{dropped or 'none'}); control (the MoE gather's backward slicing the cotangent) "
        f"worst gradient {control['worst_name']} at {control['worst']:.2e} of its allowance "
        f"(fails, as it must); B1/B3/B4 {per_step} each a rank a step (B1 {per_step} in its "
        f"eval); synced step median {timed[0]['step_ms']:.3f} ms (min "
        f"{timed[0]['step_min']:.3f}, max {timed[0]['step_max']:.3f}) over {cfg['timed']} "
        f"on rank 0, medians by rank {[round(r['step_ms'], 3) for r in timed]}; peak GiB by "
        f"rank {[round(r['peak_gib'], 3) for r in timed]}; gloo host-staged "
        f"{timed[0]['staged_mb']:.3f} MB a step on rank 0")
    log(f"[parallel_moe_sequence] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_moe_sequence']} s)")
    return launches


# -- parallel_maml_sharded: pose MAML on sharded parameters ------------------------

# Pose MAML (8 tasks x (3 + 3) at 64x64, f32, one inner step) on 1 data x
# 2 fsdp x 2 model ranks in sharded_params, second and first order, each
# against the single-device outer step; `timed` synced steps of each. No
# MAML family has a leaf of mesh.MIN_WEIGHT_SIZE (2^14) elements, so the
# ranks shard leaves of `min_shard` elements or more (JAX's CompiledModel
# param_min_shard_size): pose's conv3-6 kernels and pose_fc1, each cut
# over fsdp and model.
PARALLEL_MAML = dict(mesh=(1, 2, 2), tasks=META_TASKS, min_shard=2 ** 13, timed=3)


@contextlib.contextmanager
def _unreduced_over_fsdp(on: bool):
    """The sharded-MAML control in force inside when `on`: a leaf cut over
    fsdp is gathered whole by a gather whose backward keeps this rank's
    slice of the cotangent, so its gradient misses the other fsdp ranks'
    tasks."""
    from tensor2robot_tpu_torch.parallel import collectives

    saved = collectives.all_gather
    if on:
        collectives.all_gather = collectives.gather_from
    try:
        yield
    finally:
        collectives.all_gather = saved


def parallel_rank_maml(spec: dict) -> dict:
    """On every rank of the 1 x 2 x 2 mesh, for each order: the outer
    step's loss and every gradient gathered whole (reduced as a step
    reduces them), the layout and this rank's parameter and Adam bytes
    (after one optimizer step) beside the reckoning from the whole leaves,
    then (second order) the control, and the synced steps; rank 0 holds
    them against the single-device outer step on the same weights and task
    batch. Returns the rank's numbers (no flash kernel runs)."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.parallel import sharded_params
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    cfg, device = spec["maml"], spec["device"]
    data, fsdp, model_ways = cfg["mesh"]
    mesh = _rank_setup(spec, data, 1, fsdp=fsdp, model=model_ways)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    generator = DefaultRandomInputGenerator(batch_size=cfg["tasks"], seed=0)
    generator.set_specification_from_model(meta_model(), "train")
    host = next(iter(generator.create_dataset("train")))
    weights = meta_model().init_network(torch.Generator().manual_seed(0), "cpu").state_dict()
    reckoned = sum(v.numel() // (fsdp * model_ways) if v.numel() >= cfg["min_shard"]
                   else v.numel() for k, v in weights.items())
    local = to_device(mesh_lib.shard_batch(host, mesh), device)
    rank = dist.get_rank()
    out = {"rank": rank, "orders": {}}
    for name, second in (("second order", True), ("first order", False)):
        reference = None
        if rank == 0:
            ref_trainer = Trainer(meta_model(second), device=device)
            ref_network = ref_trainer.init_state(params=weights).network
            with _deterministic_convs():
                features, labels = ref_trainer.preprocess_train(to_device(host, device))
                ref_loss, _ = ref_trainer.backward(ref_network, features, labels)
            reference = (ref_loss.item(), {n: p.grad.detach() for n, p in
                                            ref_network.named_parameters()})
            del ref_trainer, ref_network
        trainer = Trainer(meta_model(second, mesh=mesh), device=device, mesh=mesh,
                          param_min_shard_size=cfg["min_shard"])
        state = trainer.init_state(params=weights)

        def step(control: bool):
            state.network.zero_grad(set_to_none=True)
            with _deterministic_convs(), _unreduced_over_fsdp(control):
                features, labels = trainer.preprocess_train(local)
                loss, metrics = trainer.backward(state.network, features, labels)
            loss, _ = trainer.reduce_gradients(state, loss, metrics)
            return loss.item(), sharded_params.full_grads(state.network,
                                                          trainer.param_layout, mesh)

        loss, grads = step(False)
        control = step(True) if second else None
        state.network.zero_grad(set_to_none=True)
        result = dict(layout=dict(trainer.param_layout), regime=trainer.regime,
                      reckoned=reckoned)
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        result.update(_timed_mesh_steps(trainer, state, local, device, cfg["timed"]))
        result.update(_state_bytes(state, trainer))
        if rank == 0:
            result["gate"] = _bc_grad_gate(loss, grads, *reference)
            if control is not None:
                result["control"] = _bc_grad_gate(*control, *reference)
        out["orders"][name] = result
        del trainer, state, grads, control
        dist.barrier()
    return out


def parallel_maml_sharded(world, spec: dict) -> None:
    """Pose MAML on sharded parameters over 1 data x 2 fsdp x 2 model
    ranks, second and first order: each outer step against the
    single-device one (the meta phase's gate), the layout non-empty, bytes
    a rank exact, the control, the synced steps."""
    t0 = time.monotonic()
    cfg = spec["maml"]
    ranks = world.run(parallel_rank_maml, spec, timeout_s=PARALLEL_TIMEOUT)
    failures = []
    for r in ranks:
        for name, m in r["orders"].items():
            if m["regime"] != "sharded_params" or not m["layout"]:
                failures.append(f"rank {r['rank']} {name}: {m['regime']}, layout "
                                f"{m['layout']}")
            if m["param_bytes"] != 4 * m["reckoned"] or m["opt_bytes"] != 8 * m["reckoned"]:
                failures.append(f"rank {r['rank']} {name}: {m['param_bytes']} parameter and "
                                f"{m['opt_bytes']} moment bytes, the reckoning "
                                f"{4 * m['reckoned']} and {8 * m['reckoned']}")
    for name, m in ranks[0]["orders"].items():
        if not m["gate"]["ok"]:
            failures.append(f"{name} off the single-device step: {m['gate']}")
        if "control" in m and not m["control"]["worst"] >= CONTROL_MARGIN:
            failures.append(f"{name} control at {m['control']['worst']} of its allowance, "
                            f"under {CONTROL_MARGIN}")
    if failures:
        raise AssertionError("; ".join(failures))
    data, fsdp, model_ways = cfg["mesh"]
    for name, m in ranks[0]["orders"].items():
        gate = m["gate"]
        control = (f"; control (an fsdp-cut leaf's gradient not reduced over fsdp) worst "
                   f"gradient {m['control']['worst_name']} at {m['control']['worst']:.2e} of "
                   f"its allowance (fails, as it must)" if "control" in m else "")
        log(f"[parallel_maml_sharded] pose MAML {name}, {cfg['tasks']} tasks x "
            f"({META_SAMPLES} + {META_SAMPLES}), f32, on a {data} data x {fsdp} fsdp x "
            f"{model_ways} model mesh, leaves of {cfg['min_shard']} elements or more sharded "
            f"({len(m['layout'])}: {sorted(m['layout'])}), on {card_line()}: loss "
            f"{gate['loss']:.7f} vs one card {gate['ref_loss']:.7f} (rel "
            f"{gate['loss_err']:.2e}); worst gradient {gate['worst_name']} at "
            f"{gate['worst']:.2e} of its allowance; "
            f"{m['param_bytes'] // 4} parameters a rank and Adam moments "
            f"{m['opt_bytes'] / 1e6:.6f} MB (reckoned {m['reckoned']} elements; whole "
            f"{m['whole_bytes'] // 4}){control}; synced outer step median "
            f"{m['step_ms']:.3f} ms (min {m['step_min']:.3f}, max {m['step_max']:.3f}) over "
            f"{cfg['timed']} on rank 0, medians by rank "
            f"{[round(r['orders'][name]['step_ms'], 3) for r in ranks]}; gloo host-staged "
            f"{m['staged_mb']:.3f} MB a step on rank 0; peak GiB by rank "
            f"{[round(r['orders'][name]['peak_gib'], 3) for r in ranks]}")
    log(f"[parallel_maml_sharded] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_maml_sharded']} s)")


# -- parallel_plan: the sharding planner on the same ranks ---------------------------

# Full-width BC (global batch `batch`) on the 4 ranks: (a) the `preset`
# plan (2 data x 2 pipe, ZeRO-2 over data) built by the planner (its mesh,
# the model from model_kwargs(), Trainer(plan=...) and its audit) against
# the hand-wired trainer on the same weights and batch, one gate step each;
# (b) T2R_PLAN=auto on a cold plan cache with T2R_PLAN_MEASURE=`measure`
# (`measure_steps` timed steps a probe), then a warm call, then one
# plan-driven step on the winner.
PARALLEL_PLAN = dict(preset="dp_pp_zero2", batch=8, measure="shortlist-2", measure_steps=1)


def _tensors_equal(a, b) -> tuple:
    """(every pair bit for bit, the largest absolute difference) of two
    equally long tensor lists."""
    import torch

    worst = max(((x.float() - y.float()).abs().max().item() for x, y in zip(a, b)
                 if x.numel()), default=0.0)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), worst


def parallel_rank_plan(spec: dict, cache_dir: str) -> dict:
    """On every rank: (a) the preset's plan-driven trainer and the
    hand-wired one from the same weights, the audit's entries and
    mismatches, one gate step each (deterministic cuDNN) with its loss
    and launches, and whether every parameter and optimizer state tensor
    this rank holds agrees bit for bit; (b) the cold and warm auto
    searches' stats and plan documents, rank 0's table as the cache holds
    it, and the winner's plan-driven step (its audit and launches).
    Returns the rank's numbers and the launches of its main-path calls."""
    import torch
    import torch.distributed as dist

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    from tensor2robot_tpu_torch.parallel import plan_cache, planner
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    cfg, device = spec["plan"], spec["device"]
    plan = planner.resolve_preset(cfg["preset"])
    hand_mesh = _rank_setup(spec, plan.data, plan.sequence, pipe=plan.pipe)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    rank = dist.get_rank()
    out = {"rank": rank, "launches": {k: 0 for k in read_launches()}}
    planned = Trainer(TransformerBCModel(mesh=plan.build_mesh(), **plan.model_kwargs(),
                                         **spec["model"]), device=device, plan=plan)
    hand = Trainer(TransformerBCModel(mesh=hand_mesh, **plan.model_kwargs(), **spec["model"]),
                   device=device, mesh=hand_mesh, shard_weight_update=True)
    weights = hand.model.without_mesh().init_network(
        torch.Generator().manual_seed(0), "cpu").state_dict()
    host = _bc_batch(hand.model, cfg["batch"], seed=0)
    batch = to_device(mesh_lib.shard_batch(host, hand_mesh), device)
    local = cfg["batch"] // plan.data
    per_step = spec["layers"] // plan.pipe * _pipe_micro(local, plan.pipe)
    out["want"] = {"flash_fwd": 0, "flash_fwd_tile": per_step, "flash_bwd_dq": per_step,
                   "flash_bwd_dkv": per_step}

    def counted_step(trainer, state, local_batch):
        reset_launches()
        with _deterministic_convs():
            loss = trainer.train_step(state, local_batch)["loss"].item()
        _sync(device)
        launches = read_launches()
        for name, count in launches.items():
            out["launches"][name] += count
        return loss, launches

    states = {}
    for name, trainer in (("plan", planned), ("hand", hand)):
        state = trainer.init_state(params=weights)
        states[name] = state
        if name == "plan":
            out["audit"] = planner.audit_state_layout(trainer.layout, trainer.mesh, state)
            out["regimes"] = (trainer.regime, hand.regime)
        out[f"{name}_loss"], out[f"{name}_launches"] = counted_step(trainer, state, batch)

    def held(state):
        opt = [t for entry in state.optimizer.state.values() for t in entry.values()
               if torch.is_tensor(t)]
        return [p.detach() for p in state.network.parameters()] + opt

    out["bitwise"], out["max_diff"] = _tensors_equal(held(states["plan"]), held(states["hand"]))
    del planned, hand, states
    dist.barrier()

    flags_set = dict(T2R_PLAN="auto", T2R_PLAN_CACHE_DIR=cache_dir,
                     T2R_PLAN_MEASURE=cfg["measure"],
                     T2R_PLAN_MEASURE_STEPS=str(cfg["measure_steps"]))
    saved = {k: os.environ.get(k) for k in flags_set}
    os.environ.update(flags_set)
    try:
        model = TransformerBCModel(**spec["model"])
        reset_launches()
        t0 = time.monotonic()
        cold = planner.resolve_plan_from_flag(model, host, device=device)
        out["cold_s"] = time.monotonic() - t0
        out["cold"] = dict(stats=planner.last_search(),
                           doc=json.dumps(cold.to_json(), sort_keys=True))
        for name, count in read_launches().items():
            out["launches"][name] += count
        t0 = time.monotonic()
        warm = planner.resolve_plan_from_flag(model, host, device=device)
        out["warm_s"] = time.monotonic() - t0
        out["warm"] = dict(stats=planner.last_search(),
                           doc=json.dumps(warm.to_json(), sort_keys=True))
        if rank == 0:
            out["table"] = plan_cache.load(out["cold"]["stats"]["fingerprint"],
                                           cache_dir)["table"]
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    trainer = Trainer(model, device=device, plan=warm)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    out["winner_audit"] = planner.audit_state_layout(trainer.layout, trainer.mesh, state)
    out["winner_regime"] = trainer.regime
    out["winner_loss"], out["winner_launches"] = counted_step(
        trainer, state, to_device(mesh_lib.shard_batch(host, trainer.mesh), device))
    out["winner_want"] = {"flash_fwd": 0, "flash_fwd_tile": spec["layers"],
                          "flash_bwd_dq": spec["layers"], "flash_bwd_dkv": spec["layers"]}
    return out


def parallel_plan(world, spec: dict, model_dir: str) -> dict:
    """The planner on the ranks: the preset's plan-driven step against the
    hand-wired one (audit clean, bit for bit, the same launches), then the
    cold auto search (measured, one probe or more), the warm one (the
    cache, no probe, the same document) and the winner's plan-driven step
    (audit clean, its launches). Returns the launches of every rank's
    main-path calls."""
    t0 = time.monotonic()
    cfg = spec["plan"]
    with tempfile.TemporaryDirectory(dir=model_dir) as cache_dir:
        ranks = world.run(parallel_rank_plan, spec, cache_dir, timeout_s=PARALLEL_TIMEOUT)
    failures = []
    for r in ranks:
        audits = (("preset", r["audit"]), ("winner", r["winner_audit"]))
        for name, audit in audits:
            if not audit["leaves"] or audit["mismatches"]:
                failures.append(f"rank {r['rank']} {name} audit {audit['leaves']} entries, "
                                f"mismatches {audit['mismatches'][:5]}")
        if r["regimes"] != ("zero2", "zero2"):
            failures.append(f"rank {r['rank']} regimes {r['regimes']}")
        if not r["bitwise"] or r["plan_loss"] != r["hand_loss"]:
            failures.append(f"rank {r['rank']} plan-driven step off the hand-wired one: loss "
                            f"{r['plan_loss']!r} vs {r['hand_loss']!r}, max diff {r['max_diff']}")
        for name in ("plan", "hand"):
            if r[f"{name}_launches"] != r["want"]:
                failures.append(f"rank {r['rank']} {name} step launched "
                                f"{r[f'{name}_launches']} != {r['want']}")
        if r["winner_launches"] != r["winner_want"]:
            failures.append(f"rank {r['rank']} winner's step launched {r['winner_launches']} "
                            f"!= {r['winner_want']}")
        cold, warm = r["cold"]["stats"], r["warm"]["stats"]
        if cold["source"] != "measured" or cold["probe_compiles"] < 1:
            failures.append(f"rank {r['rank']} cold search {cold['source']} with "
                            f"{cold['probe_compiles']} probes")
        if warm["source"] != "cache" or warm["probe_compiles"] != 0:
            failures.append(f"rank {r['rank']} warm search {warm['source']} with "
                            f"{warm['probe_compiles']} probes")
        if r["warm"]["doc"] != r["cold"]["doc"] or r["cold"]["doc"] != ranks[0]["cold"]["doc"]:
            failures.append(f"rank {r['rank']} plan documents differ: {r['cold']['doc']} / "
                            f"{r['warm']['doc']}")
    if failures:
        raise AssertionError("; ".join(failures))
    head = ranks[0]
    log(f"[parallel_plan] (a) preset {cfg['preset']} on {card_line()}: BC at full width "
        f"(T={spec['model']['episode_length']}, global batch {cfg['batch']}), the plan's "
        f"mesh, model and Trainer(plan=...): audit clean over {head['audit']['leaves']} "
        f"entries on every rank ({[r['audit']['leaves'] for r in ranks]}); one step "
        f"against the hand-wired Trainer(mesh=make_mesh(data=2, pipe=2), "
        f"shard_weight_update=True) on the same weights and batch: loss "
        f"{head['plan_loss']!r} vs {head['hand_loss']!r}, every parameter and optimizer "
        f"state tensor bit for bit on every rank; B1/B3/B4 "
        f"{head['want']['flash_fwd_tile']} each a rank a step, the hand-wired step's")
    for row in head["table"][:5]:
        log(f"[parallel_plan] (b) analytic table: {row['plan']['name']} memory "
            f"{row['memory']['total']} B/rank comm {row['comm']['total']} B/rank a step "
            f"{'feasible' if row['feasible'] else 'infeasible: ' + '; '.join(row['reasons'])}")
    for row in head["table"]:
        probe = row.get("measured")
        if probe is None:
            continue
        if probe.get("skipped"):
            log(f"[parallel_plan] (b) probe {row['plan']['name']} skipped: {probe['skipped']}")
            continue
        ratio = probe.get("analytic_memory_error", {}).get("ratio")
        log(f"[parallel_plan] (b) probe {row['plan']['name']} on {card_line()}: step "
            f"{probe['step_time_ms']:.3f} ms (the slowest rank's, {probe['steps_timed']} "
            f"timed), peak memory {probe['memory_per_device_bytes']} B/rank, analytic / "
            f"measured memory {ratio}")
    cold, warm = head["cold"]["stats"], head["warm"]["stats"]
    log(f"[parallel_plan] (b) T2R_PLAN=auto, T2R_PLAN_MEASURE={cfg['measure']}: cold "
        f"{cold['source']} with {cold['probe_compiles']} probe(s) in {head['cold_s']:.1f}s, "
        f"winner {cold['plan']}; warm {warm['source']} with {warm['probe_compiles']} probes "
        f"in {head['warm_s']:.2f}s, to_json() byte-identical on every rank; the winner's "
        f"plan-driven step ({head['winner_regime']}): audit clean over "
        f"{head['winner_audit']['leaves']} entries, loss {head['winner_loss']:.7f}, B1/B3/B4 "
        f"{head['winner_want']['flash_fwd_tile']} each a rank")
    log(f"[parallel_plan] sub-phase {time.monotonic() - t0:.1f}s (reckoned "
        f"{PARALLEL_RECKONED_S['parallel_plan']} s)")
    launches = {name: 0 for name in read_launches()}
    for r in ranks:
        for name, count in r["launches"].items():
            launches[name] += count
    return launches


def phase_parallel(model_dir: str) -> dict:
    """Sequence- and data-parallel BC at full width over 4 gloo ranks
    sharing the card: ring, Ulysses and a windowed ring against the
    single-device step, then train_eval_model on a 2 x 2 mesh served from
    one card; then on the same ranks the critic over data x fsdp, MoE BC
    over data x expert, BC pipelined over data x pipe, BC's ZeRO-2
    regimes over data, BC's parameters sharded over fsdp x model and
    BC's composed regimes (parallel_critic, parallel_moe, parallel_pipe,
    parallel_zero2, parallel_sharded, parallel_composed), MoE BC over
    expert x sequence and pose MAML on sharded parameters
    (parallel_moe_sequence, parallel_maml_sharded), and the sharding
    planner's plan-driven steps and auto search (parallel_plan); then
    JAX's dp_sp_pp on 8 ranks in a second world (parallel_3d). Returns the
    launches of every rank's main-path calls."""
    import torch

    from tensor2robot_tpu_torch.parallel.launch import LocalWorld

    torch.cuda.empty_cache()
    t0 = time.monotonic()
    launches = {name: 0 for name in read_launches()}
    spec = _parallel_spec()
    with LocalWorld(PARALLEL_RANKS, threads=2, timeout_s=PARALLEL_TIMEOUT) as world:
        log(f"[parallel] {PARALLEL_RANKS} gloo ranks on {spec['device']} up in "
            f"{time.monotonic() - t0:.1f}s; they share one card, so no time "
            "below is a multi-card speed")
        for regime in PARALLEL_REGIMES:
            ranks = world.run(parallel_rank_regime, spec, regime,
                              timeout_s=PARALLEL_TIMEOUT)
            for r in ranks:
                for name, count in r["launches"].items():
                    launches[name] += count
            head = ranks[0]
            log(f"[parallel] {regime} (sequence {PARALLEL_RANKS}, "
                f"{SLICE['seq'] // PARALLEL_RANKS} frames a rank) on {card_line()}: loss "
                f"{head['loss']:.7f} vs one card {head['ref_loss']:.7f} (rel "
                f"{head['loss_err']:.2e}); worst gradient {head['worst_name']} at "
                f"{head['worst']:.2e} of its max; eval forward within "
                f"{head['eval_err']:.2e}; B1/B3/B4 {PARALLEL_REGIMES[regime][2]} a rank a "
                f"step; synced step median {head['step_ms']:.3f} ms (min "
                f"{head['step_min']:.3f}, max {head['step_max']:.3f}) over "
                f"{PARALLEL_TIMED_STEPS} on rank 0, medians by rank "
                f"{[round(r['step_ms'], 3) for r in ranks]}; peak GiB by rank "
                f"{[round(r['peak_gib'], 3) for r in ranks]}; gloo host-staged "
                f"{head['staged_mb']:.3f} MB a step on rank 0")
        with tempfile.TemporaryDirectory(dir=model_dir) as run_dir:
            ranks = world.run(parallel_rank_train, spec, run_dir,
                              timeout_s=PARALLEL_TIMEOUT)
            train = PARALLEL_TRAIN
            per_rank = NUM_LAYERS * 2  # 2 hops of a sequence-2 ring
            want = {"flash_fwd": 0,
                    "flash_fwd_tile": per_rank * (train["steps"] + train["eval_steps"]
                                                  * train["steps"] // train["save_every"]),
                    "flash_bwd_dq": per_rank * train["steps"],
                    "flash_bwd_dkv": per_rank * train["steps"]}
            for r in ranks:
                if r["launches"] != want:
                    raise AssertionError(f"2 x 2 train_eval_model launched {r['launches']}"
                                         f" != {want}")
                for name, count in r["launches"].items():
                    launches[name] += count
            evals = {round(r["final_eval"]["eval/mse"], 9) for r in ranks}
            if len(evals) != 1 or not all(math.isfinite(e) for e in evals):
                raise AssertionError(f"ranks' final evals {evals}")
            served, served_launches = _serve_mesh_checkpoint(
                run_dir, list(range(train["save_every"], train["steps"] + 1,
                                    train["save_every"])))
            for name, count in served_launches.items():
                launches[name] += count
            log(f"[parallel] train_eval_model on a 2 x 2 data x sequence mesh on "
                f"{card_line()}: {train['steps']} steps, final eval {ranks[0]['final_eval']} "
                f"on every rank; {served}; peak GiB by rank "
                f"{[round(r['peak_gib'], 3) for r in ranks]}")
        parallel_critic(world, spec, model_dir)
        for name, count in parallel_moe(world, spec).items():
            launches[name] += count
        for name, count in parallel_pipe(world, spec, model_dir).items():
            launches[name] += count
        for name, count in parallel_zero2(world, spec, model_dir).items():
            launches[name] += count
        for name, count in parallel_sharded(world, spec, model_dir).items():
            launches[name] += count
        for name, count in parallel_composed(world, spec, model_dir).items():
            launches[name] += count
        for name, count in parallel_moe_sequence(world, spec).items():
            launches[name] += count
        parallel_maml_sharded(world, spec)
        for name, count in parallel_plan(world, spec, model_dir).items():
            launches[name] += count
    for name, count in parallel_3d(spec).items():
        launches[name] += count
    log(f"[parallel] phase wall {time.monotonic() - t0:.1f}s; launches over the ranks "
        f"{launches}")
    return launches


def timed_phase(name: str, fn, *args):
    t0 = time.monotonic()
    out = fn(*args)
    log(f"[done] phase {name} in {time.monotonic() - t0:.1f}s")
    return out


def share_bytecode() -> None:
    """One bytecode cache for the run and every process it starts, in
    build/pycache (gitignored), when the port lies beside this script.
    Where bytecode writing is off (PYTHONDONTWRITEBYTECODE) every process
    compiles each module it imports from source again: torch, Inductor and the port are thousands of modules, and
    the run starts dozens of processes (build workers, binaries, ranks)."""
    if not os.path.isdir(os.path.join(ROOT, "tensor2robot_tpu_torch")):
        return
    prefix = os.path.join(ROOT, "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated subset of %s (a subset prints no result line)"
        % ",".join(PHASES),
    )
    args = parser.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        print(f"chip_smoke: phases must be among {PHASES}", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as err:
        print(f"chip_smoke: torch unavailable ({err})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        import tensor2robot_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port is not beside this script ({err})",
              file=sys.stderr)
        return 2
    # f32 means f32: no TF32 in matmuls or cuDNN convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels, launches = [], {}
    try:
        card = card_line()
        log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
            f"{card}")
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as model_dir:
            if "build" in phases:
                timed_phase("build", phase_build)
            if "kernels" in phases:
                _, kernels = timed_phase("kernels", phase_kernels)
            if "training" in phases:
                launches.update(timed_phase("training", phase_training, model_dir))
            if "serving" in phases:
                if "training" not in phases:
                    raise ValueError("serving restores the training checkpoint")
                launches["flash_fwd"] = timed_phase("serving", phase_serving, model_dir)
            if "critic" in phases:
                timed_phase("critic", phase_critic, os.path.join(model_dir, "critic"))
            if "export" in phases:
                if "training" not in phases or "critic" not in phases:
                    raise ValueError(
                        "export serves the training and critic phases' weights")
                launches["flash_fwd"] += timed_phase("export", phase_export, model_dir)
            if "serve_quant" in phases:
                if "training" not in phases or "critic" not in phases:
                    raise ValueError(
                        "serve_quant exports the training and critic phases' weights")
                launches["flash_fwd"] += timed_phase("serve_quant", phase_serve_quant,
                                                     model_dir)
            if "aot" in phases:
                if "training" not in phases:
                    raise ValueError("aot exports the training phase's weights")
                launches["flash_fwd"] += timed_phase("aot", phase_aot, model_dir)
            if "policy" in phases:
                timed_phase("policy", phase_policy, model_dir)
            if "data" in phases:
                timed_phase("data", phase_data, os.path.join(model_dir, "data"))
            if "cli" in phases:
                for name, count in timed_phase(
                        "cli", phase_cli, os.path.join(model_dir, "cli")).items():
                    launches[name] = launches.get(name, 0) + count
            if "meta" in phases:
                timed_phase("meta", phase_meta, os.path.join(model_dir, "meta"))
            if "stream" in phases:
                timed_phase("stream", phase_stream, os.path.join(model_dir, "stream"))
            if "moe" in phases:
                for name, count in timed_phase(
                        "moe", phase_moe, os.path.join(model_dir, "moe")).items():
                    launches[name] = launches.get(name, 0) + count
            if "grasp2vec" in phases:
                timed_phase("grasp2vec", phase_grasp2vec,
                            os.path.join(model_dir, "grasp2vec"))
            if "vrgripper" in phases:
                timed_phase("vrgripper", phase_vrgripper,
                            os.path.join(model_dir, "vrgripper"))
            if "maml_export" in phases:
                timed_phase("maml_export", phase_maml_export,
                            os.path.join(model_dir, "maml_export"))
            if "stem_s2d" in phases:
                timed_phase("stem_s2d", phase_stem_s2d, os.path.join(model_dir, "stem_s2d"))
            if "png" in phases:
                timed_phase("png", phase_png, os.path.join(model_dir, "png"))
            if "parallel" in phases:
                for name, count in timed_phase("parallel", phase_parallel, model_dir).items():
                    launches[name] = launches.get(name, 0) + count
        log(f"[done] {time.monotonic() - t0:.1f}s")
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    if phases != list(PHASES):
        log(f"[done] phases {phases} only: no result line")
        return 0
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    share_bytecode()
    sys.exit(main())
