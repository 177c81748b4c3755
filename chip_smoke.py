#!/usr/bin/env python3
"""Runs the PyTorch port (tensor2robot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

  1. build   — compiles the hand-written CUDA kernels from the checkout's
               sources (ops/csrc/flash_fwd.cu, nvcc for sm_90a).
  2. kernels — holds the flash forward kernel (the port of the Pallas
               `_flash_kernel`) against its plain PyTorch version on the
               card at the serving shape (B=8, S=1024, H=8, D=32; causal;
               f32 and bf16), plus a windowed, an offset and a masked-row
               case and the other head dims; times kernel, plain version
               and torch's scaled_dot_product_attention (a yardstick the
               port never calls) and computes the kernel's bound.
  3. serving — restores a full-width transformer-BC model (T=1024 steps,
               64x64x3 images, d_model 256, 4 layers, 8 heads of 32,
               use_flash=True; seeded random weights) from a checkpoint
               into CheckpointPredictor, serves it through PolicyServer
               with buckets (1, 2, 4, 8) to four client threads sending 24
               episodes, and checks every reply: finite, [1024, 7], equal
               within tolerance to the same weights served with the plain
               (einsum) attention, and the flash kernel launched once per
               layer per served batch.

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and as its last line {"ok": true, "device": {...}}. Exits
non-zero without a result when no CUDA card is visible.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, bf16 dense tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

SLICE = dict(batch=8, seq=1024, heads=8, head_dim=32)
NUM_LAYERS = 4
BUCKETS = (1, 2, 4, 8)
CLIENTS = 4
REQUESTS_PER_CLIENT = 6
DISTINCT_EPISODES = 4
# Kernel vs plain version: the f32 bound is the JAX package's own flash
# tolerance (tests/test_flash_attention.py); bf16 outputs round to 8
# mantissa bits, so one bf16 ulp at |o| ~ 1 is ~4e-3.
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Served actions vs the einsum-attention predictor: four layers of f32
# attention computed in another order, convs in full f32 (TF32 off).
SERVE_TOL = 1e-4


def log(message: str) -> None:
    print(message, flush=True)


def card_line() -> str:
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


def phase_build():
    """Builds every head dim's library at once (one nvcc each)."""
    from concurrent.futures import ThreadPoolExecutor

    from tensor2robot_tpu_torch.ops import flash_attention as fa

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(fa.KERNEL_HEAD_DIMS)) as pool:
        paths = list(pool.map(fa.build_library, fa.KERNEL_HEAD_DIMS))
    log(f"[build] {len(paths)} libraries in {time.monotonic() - t0:.1f}s")
    for path in paths:
        log(f"[build] {path.relative_to(ROOT)}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from tensor2robot_tpu_torch.ops import flash_attention as fa

    b, s, h, d = (SLICE[k] for k in ("batch", "seq", "heads", "head_dim"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(batch, s_q, s_k, heads, dim, dtype):
        """q, k, v as MultiHeadAttention hands them over: [B, S, H, D]
        views into a fused [B, S, 3*H*D] projection, not contiguous."""
        inner = heads * dim

        def fused(seq):
            return torch.randn(
                (batch, seq, 3 * inner), generator=gen, device="cuda"
            ).to(dtype)

        fused_q = fused(s_q)
        fused_kv = fused_q if s_k == s_q else fused(s_k)
        return [
            t[..., i * inner:(i + 1) * inner].view(t.shape[0], t.shape[1], heads, dim)
            for i, t in enumerate((fused_q, fused_kv, fused_kv))
        ]

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
    results = {}
    for name, (cb, sq, sk, ch, cd), dtype, kw in cases:
        q, k, v = qkv(cb, sq, sk, ch, cd, dtype)
        out = fa.flash_fwd_kernel(q, k, v, **kw)
        ref = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = KERNEL_TOL[str(dtype).split(".")[-1]]
        err = (out.float() - ref.float()).abs()
        max_err = err.max().item()
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        if not torch.isfinite(out.float()).all() or bad:
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max_abs_err {max_err}, {bad} elements past {tol})"
            )
        if kw.get("k_offset", 0) > 0:
            masked = out[:, : kw["k_offset"]].float().abs().max().item()
            if masked != 0.0:
                raise AssertionError(f"{name}: masked rows not 0 ({masked})")
        results[name] = max_err
        log(f"[kernels] {name}: max_abs_err {max_err:.3e} (tol {tol})")

    # Timing at the serving shape, f32 causal (the main path's call).
    q, k, v = qkv(b, s, s, h, d, torch.float32)
    kernel_ms = cuda_time_ms(lambda: fa.flash_fwd_kernel(q, k, v, causal=True), 50)
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_plain(q, k, v, causal=True), 5, warmup=1
    )
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 50
    )
    flops = 4 * d * b * h * visible_pairs(s, s, True, 0, 0, None)
    nbytes = 4 * b * s * h * d * q.element_size()
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    log(
        f"[kernels] timing slice_f32_causal: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; {flops / 1e9:.3f} GFLOP "
        f"-> {t_ops:.4f} ms at f32 peak, {nbytes / 1e6:.2f} MB -> "
        f"{t_bytes:.4f} ms at HBM peak"
    )
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tensor2robot_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "tensor2robot_tpu/ops/flash_attention.py:255",
        "launches": None,
        "max_abs_err": results["slice_f32_causal"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def phase_serving():
    import numpy as np
    import torch

    from tensor2robot_tpu_torch.models.transformer_models import (
        TransformerBCModel,
    )
    from tensor2robot_tpu_torch.ops import flash_attention as fa
    from tensor2robot_tpu_torch.predictors import (
        CheckpointPredictor,
        save_checkpoint,
    )
    from tensor2robot_tpu_torch.serving import PolicyServer
    from tensor2robot_tpu_torch.specs import make_random_numpy

    def model(use_flash):
        return TransformerBCModel(
            action_size=7, pose_size=14, episode_length=SLICE["seq"],
            image_size=(64, 64), d_model=256, num_layers=NUM_LAYERS,
            num_heads=SLICE["heads"], head_dim=SLICE["head_dim"],
            use_flash=use_flash,
        )

    flash_model = model(True)
    weights = flash_model.init_network(
        torch.Generator().manual_seed(0), "cuda"
    ).state_dict()
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    save_checkpoint(ckpt_dir, 1, weights)

    predictor = CheckpointPredictor(flash_model, checkpoint_dir=ckpt_dir)
    plain = CheckpointPredictor(model(False))
    plain.load_state_dict(weights, version=1)
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
            f"{predictor.model_version}")
        fa.flash_fwd_kernel.launches = 0
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
        launches = fa.flash_fwd_kernel.launches
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
    if launches == 0 or launches != NUM_LAYERS * batches:
        raise AssertionError(
            f"flash kernel launches {launches} != {NUM_LAYERS} x {batches} batches"
        )
    latencies = sorted(latency for _, latency, _ in replies)
    log(
        f"[serving] {total} episodes in {wall:.3f}s = {total / wall:.3f} req/s; "
        f"client p50 {latencies[len(latencies) // 2] * 1e3:.1f} ms, "
        f"max {latencies[-1] * 1e3:.1f} ms; server p50_total "
        f"{snap['latency_ms']['p50_total']:.1f} ms, p50_compute "
        f"{snap['latency_ms']['p50_compute']:.1f} ms; batches {batches} "
        f"{snap['batches_by_bucket']}, fill {snap['batch_fill_ratio']:.3f}; "
        f"flash launches {launches}; max |action - plain| {worst:.3e}"
    )
    profile_predict(predictor, requests)
    return launches


def profile_predict(predictor, requests) -> None:
    """Where a served batch's time goes: the host stack the dispatcher
    does, then one max-bucket predict under torch.profiler (device time by
    op, device busy share of the predict's wall time). Diagnostic only:
    a profiler that cannot trace the card is reported, not fatal."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensor2robot_tpu_torch.serving.buckets import pad_feature_batch

    rows = [requests[i % len(requests)] for i in range(BUCKETS[-1])]
    t0 = time.monotonic()
    batch = pad_feature_batch(rows, BUCKETS[-1])
    stack_ms = (time.monotonic() - t0) * 1e3
    predictor.predict(batch)
    try:
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.monotonic()
            predictor.predict(batch)
            wall_ms = (time.monotonic() - t0) * 1e3
    except RuntimeError as err:
        log(f"[profile] not measured: {err}")
        return

    from torch.autograd import DeviceType

    # Device-side events only (kernels, copies): host ops also carry the
    # device time of what they launched, so summing every row counts it
    # twice. Busy time is the union of the device intervals.
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    log(
        f"[profile] bucket {BUCKETS[-1]}: host stack {stack_ms:.1f} ms; "
        f"predict wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%); input "
        f"{sum(np.asarray(v).nbytes for v in batch.values()) / 1e6:.0f} MB"
    )
    for name, (total, count) in sorted(
        by_name.items(), key=lambda item: item[1][0], reverse=True
    )[:8]:
        log(f"[profile]   {total / 1e3:9.3f} ms  x{count:<4d} {name[:90]}")


def main() -> int:
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
    try:
        card = card_line()
        log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        t0 = time.monotonic()
        phase_build()
        kernel = phase_kernels()
        kernel["launches"] = phase_serving()
        log(f"[done] {time.monotonic() - t0:.1f}s")
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
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
