#!/usr/bin/env python3
"""Runs the PyTorch port (tensor2robot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--phases build,kernels,training,serving,critic,export,policy,data,cli]

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
                nvJPEG; the line names it) with g++, writes 512 train
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

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and as its last line {"ok": true, "device": {...}}. Exits
non-zero without a result when no CUDA card is visible. A run of a subset
of the phases prints no result line.
"""

from __future__ import annotations

import argparse
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
PHASES = ("build", "kernels", "training", "serving", "critic", "export", "policy",
          "data", "cli")
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
TIMED_STEPS = 10
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
DATA_RECORDS = (512, 4, 64)
DATA_BATCHES = 32
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


def write_records(model, directory: str, counts, image_hw, seed: int = 0):
    """Records of the critic's in-spec (train) at `image_hw`: state/image a
    q95 JPEG of camera_like_frames, every other feature and the label drawn
    from the spec with the seed. counts = (train records, train shards,
    eval records). Returns ({"train": pattern, "eval": pattern}, the first
    shard's (frames, records, JPEGs), seconds to write)."""
    from tensor2robot_tpu_torch.data import codec, tfrecord
    from tensor2robot_tpu_torch.data.encoder import encode_example
    from tensor2robot_tpu_torch.specs import TensorSpecStruct, make_random_numpy

    train_records, shards, eval_records = counts
    spec = TensorSpecStruct()
    for key, value in model.preprocessor.get_in_feature_specification("train").items():
        spec[f"features/{key}"] = value
    for key, value in model.preprocessor.get_in_label_specification("train").items():
        spec[f"labels/{key}"] = value
    os.makedirs(directory, exist_ok=True)
    t0 = time.monotonic()
    sample = None
    layout = [("train", s, train_records // shards) for s in range(shards)]
    layout.append(("eval", 0, eval_records))
    for index, (split, shard, n) in enumerate(layout):
        part_seed = seed + 1000 * index
        values = make_random_numpy(spec, batch_size=n, seed=part_seed)
        frames = camera_like_frames(n, *image_hw, seed=part_seed)
        jpegs = [codec.encode_jpeg(frame, quality=95) for frame in frames]
        records = []
        for i in range(n):
            row = {key: value[i] for key, value in values.items()}
            row["features/state/image"] = jpegs[i]
            records.append(encode_example(spec, row))
        if sample is None:
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


def _synced_step_ms(trainer, state, batch) -> tuple:
    import torch

    for _ in range(2):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(CLI_TIMED_STEPS):
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
    return _Child("collect_pose", "run_collect_eval", [
        f"--root_dir={os.path.join(model_dir, 'pose', 'collect')}",
        f"--gin_configs={os.path.join(POSE_CONFIGS, 'run_random_collect.gin')}",
        f"--gin_bindings=collect_eval_loop.num_collect = {CLI_POSE['collect']}",
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


def timed_phase(name: str, fn, *args):
    t0 = time.monotonic()
    out = fn(*args)
    log(f"[done] phase {name} in {time.monotonic() - t0:.1f}s")
    return out


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
            if "policy" in phases:
                timed_phase("policy", phase_policy, model_dir)
            if "data" in phases:
                timed_phase("data", phase_data, os.path.join(model_dir, "data"))
            if "cli" in phases:
                for name, count in timed_phase(
                        "cli", phase_cli, os.path.join(model_dir, "cli")).items():
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
    sys.exit(main())
