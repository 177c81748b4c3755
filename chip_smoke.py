#!/usr/bin/env python3
"""Runs the PyTorch port (tensor2robot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--phases build,kernels,training,serving]

Phases, each fatal on failure (exit code 1, no result line):

  1. build    — compiles the hand-written CUDA kernels from the checkout's
                sources (ops/csrc/flash_fwd.cu and flash_bwd.cu, one nvcc
                per source and head dim, all at once, for sm_90a) and
                prints each kernel's registers and spills.
  2. kernels  — holds each flash kernel against its plain PyTorch version
                on the card, on seven cases around the transformer-BC
                shape (B=8, S=1024, H=8, D=32; causal f32 and bf16, a
                window, a q offset, a k offset with fully masked rows, a
                ragged non-causal D=64 and a bf16 D=128): B2 (normalized
                forward), B1 (unnormalized forward with row stats l, m),
                B3 (dq) and B4 (dk, dv) from the same lse and delta; B3
                and B4 launch twice and must give the same bits. Times
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
                served batch.

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
PHASES = ("build", "kernels", "training", "serving")
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
    return errors, time_kernels(errors["slice_f32_causal"])


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

    return TransformerBCModel(
        action_size=7, pose_size=14, episode_length=SLICE["seq"],
        image_size=(64, 64), d_model=256, num_layers=NUM_LAYERS,
        num_heads=SLICE["heads"], head_dim=SLICE["head_dim"],
        use_flash=use_flash,
    )


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
    t0 = time.monotonic()
    final_eval = train_eval_model(
        model,
        DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=0),
        DefaultRandomInputGenerator(batch_size=SLICE["batch"], seed=1000),
        model_dir=model_dir, max_train_steps=TRAIN_STEPS,
        save_checkpoints_steps=SAVE_EVERY, eval_steps=EVAL_STEPS,
        log_every_steps=LOG_EVERY, device=DEVICE,
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
        f"{steps}, in {wall:.1f}s (host data, evals and checkpoints "
        f"included); losses {', '.join(f'{x:.5f}' for x in losses)}; final "
        f"eval {final_eval}; launches {launches}")
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


def device_profile(label: str, fn, rows: int = 10) -> None:
    """Device time by op and device busy share of one call's wall time,
    from torch.profiler. Diagnostic only: a profiler that cannot trace the
    card is reported, not fatal."""
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
        return
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
                phase_build()
            if "kernels" in phases:
                _, kernels = phase_kernels()
            if "training" in phases:
                launches.update(phase_training(model_dir))
            if "serving" in phases:
                if "training" not in phases:
                    raise ValueError("serving restores the training checkpoint")
                launches["flash_fwd"] = phase_serving(model_dir)
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
