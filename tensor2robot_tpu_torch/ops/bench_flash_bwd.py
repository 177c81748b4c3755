"""Times the flash backward kernels B3 (dq) and B4 (dk, dv) of one or more
kernel source trees, side by side on one CUDA card.

    python3 -m tensor2robot_tpu_torch.ops.bench_flash_bwd \\
        [--csrc DIR ...] [--rounds 2] [--iters 50]

Each --csrc is a directory laid out as ops/csrc/ (flash_bwd.cu and its
headers), e.g. the csrc/ of another checkout unpacked under build/; the
default is this checkout's. Every tree is built for D = 32 into
build/bench/<n>/, then all are timed in turns (A, B, ..., then in reverse,
`--rounds` times) at the transformer-BC training shape (B=8, S=1024, H=8,
D=32, causal, f32, q/k/v as views of a fused projection), each beside the
plain version's error and the memory-efficient attention backward as a
yardstick. Prints the card's name and power limit, the compiler's register
and spill lines, and one line per tree and round.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

from tensor2robot_tpu_torch.ops import flash_attention as fa

SHAPE = (8, 1024, 8, 32)  # B, S, H, D
ROOT = Path(__file__).resolve().parents[2]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
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


def _kernels(csrc: Path, build: Path):
    """B3 and B4 bound to the library built from `csrc`."""
    fa._CSRC, fa._BUILD_DIR = csrc, build
    fa._library.cache_clear()
    dq, dkv = fa.FlashBwdDqKernel(), fa.FlashBwdDkvKernel()
    dq._function(SHAPE[3])
    dkv._function(SHAPE[3])
    log = fa.library_path(SHAPE[3], "flash_bwd").with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {csrc}: {line.strip()}", flush=True)
    return dq, dkv


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", action="append", type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA device visible")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = [p.resolve() for p in (args.csrc or [fa._CSRC])]
    root = ROOT / "build" / "bench"
    # One nvcc per tree, all at once, each in its own process (the build
    # paths are module state).
    code = ("import sys; from pathlib import Path; "
            "from tensor2robot_tpu_torch.ops import flash_attention as fa; "
            "fa._CSRC, fa._BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2]); "
            f"fa.build_library({SHAPE[3]}, 'flash_bwd')")
    builds = [subprocess.Popen([sys.executable, "-c", code, str(tree),
                                str(root / str(n))], cwd=ROOT)
              for n, tree in enumerate(trees)]
    if any(proc.wait() != 0 for proc in builds):
        print("bench_flash_bwd: a build failed")
        return 1
    kernels = [_kernels(tree, root / str(n)) for n, tree in enumerate(trees)]

    b, s, h, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    fused = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
    q, k, v = (t.view(b, s, h, d) for t in fused.split(h * d, dim=-1))
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda")
    o, l, m = fa.flash_attention_tile_plain(q, k, v, causal=True)
    l_safe = l.clamp_min(1e-30)
    lse = m + torch.log(l_safe)
    delta = fa.flash_attention_bwd_delta(dout, o / l_safe.transpose(1, 2)[..., None])
    args_ = (q, k, v, dout, lse, delta)
    ref = fa.flash_attention_bwd_plain(*args_, causal=True)

    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, dout))
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    eff_out, eff_lse, seed, offset = eff(qt, kt, vt, None, True, 0.0, True)
    eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward

    def yardstick():
        return eff_bwd(dot, qt, kt, vt, None, eff_out, eff_lse, seed, offset,
                       0.0, [True, True, True, False], True)

    card = _card()
    print(f"[bench] {card}; B=8 S=1024 H=8 D=32 causal f32", flush=True)
    for n, (dq_kernel, dkv_kernel) in enumerate(kernels):
        got = (dq_kernel(*args_, causal=True), *dkv_kernel(*args_, causal=True))
        errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
        print(f"[bench] tree {n} {trees[n]}: max_abs_err dq {errs[0]:.3e} "
              f"dk {errs[1]:.3e} dv {errs[2]:.3e}", flush=True)
    order = list(range(len(kernels)))
    for r in range(args.rounds):
        for n in order if r % 2 == 0 else order[::-1]:
            dq_kernel, dkv_kernel = kernels[n]
            dq_ms = _time_ms(lambda: dq_kernel(*args_, causal=True), args.iters)
            dkv_ms = _time_ms(lambda: dkv_kernel(*args_, causal=True), args.iters)
            print(f"[bench] round {r} tree {n} on {card}: B3 {dq_ms:.4f} ms, "
                  f"B4 {dkv_ms:.4f} ms, B3+B4 {dq_ms + dkv_ms:.4f} ms",
                  flush=True)
        print(f"[bench] round {r} efficient-attention backward on {card}: "
              f"{_time_ms(yardstick, args.iters):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
