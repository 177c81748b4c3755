"""Times the flash kernels B2, B1 (forward) and B3, B4 (backward) of one or
more kernel source trees, side by side on one CUDA card.

    python3 -m tensor2robot_tpu_torch.ops.bench_flash \\
        [--csrc DIR ...] [--head-dim D ...] [--rounds 2] [--iters 50]

Each --csrc is a directory laid out as ops/csrc/ (flash_fwd.cu,
flash_bwd.cu and their headers), e.g. the csrc/ of another checkout
unpacked under build/; the default is this checkout's. Every tree's two
sources are built for each --head-dim (default 32) into build/bench/<n>/,
then all trees are timed in turns (A, B, ..., then in reverse, `--rounds`
times) at the transformer-BC shape (B=8, S=1024, H*D=256, so H=8 at
D=32 and the same work at every D; causal, f32, q/k/v as views of a
fused projection), beside PyTorch calls for the same functions that
the port never makes: the memory-efficient attention forward without its
log-sum-exp (B2; the kernel scaled_dot_product_attention takes for f32,
which chip_smoke.py times itself), with it (B1), and its backward (B3 and
B4 together). Prints the card's name and power limit, the compiler's
register and spill lines, each tree's error against the plain versions,
and one line per tree and round.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

from tensor2robot_tpu_torch.ops import flash_attention as fa

BATCH, SEQ, WIDTH = 8, 1024, 256  # B, S, H * D
ROOT = Path(__file__).resolve().parents[2]
# In the order they are timed.
KERNELS = {
    "B2": fa.FlashForwardKernel,
    "B1": fa.FlashTileKernel,
    "B3": fa.FlashBwdDqKernel,
    "B4": fa.FlashBwdDkvKernel,
}


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


def _kernels(csrc: Path, build: Path, dims) -> dict:
    """B2, B1, B3 and B4 bound to the libraries built from `csrc` for each
    head dim of `dims`."""
    fa._CSRC, fa._BUILD_DIR = csrc, build
    fa._library.cache_clear()
    kernels = {name: cls() for name, cls in KERNELS.items()}
    for dim in dims:
        for kernel in kernels.values():
            kernel._function(dim)
        for source in fa.KERNEL_SOURCES:
            log = fa.library_path(dim, source).with_suffix(".log")
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {csrc} {source} D={dim}: {line.strip()}",
                          flush=True)
    return kernels


def _build(trees, dims) -> bool:
    """One nvcc per tree, source and head dim, all at once, each in its own
    process (the build paths are module state)."""
    code = ("import sys; from pathlib import Path; "
            "from tensor2robot_tpu_torch.ops import flash_attention as fa; "
            "fa._CSRC, fa._BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2]); "
            "fa.build_library(int(sys.argv[4]), sys.argv[3])")
    builds = [
        subprocess.Popen([sys.executable, "-c", code, str(tree),
                          str(ROOT / "build" / "bench" / str(n)), source,
                          str(dim)],
                         cwd=ROOT)
        for n, tree in enumerate(trees) for source in fa.KERNEL_SOURCES
        for dim in dims
    ]
    return all(proc.wait() == 0 for proc in builds)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", action="append", type=Path)
    parser.add_argument("--head-dim", action="append", type=int,
                        choices=fa.KERNEL_HEAD_DIMS)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device visible")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = [p.resolve() for p in (args.csrc or [fa._CSRC])]
    dims = args.head_dim or [32]
    if not _build(trees, dims):
        print("bench_flash: a build failed")
        return 1
    kernels = [_kernels(tree, ROOT / "build" / "bench" / str(n), dims)
               for n, tree in enumerate(trees)]
    card = _card()
    for dim in dims:
        _bench(kernels, trees, (BATCH, SEQ, WIDTH // dim, dim), card, args)
    return 0


def _bench(kernels, trees, shape, card, args) -> None:
    """Every tree's four kernels at one shape, in turns, and the
    yardsticks."""
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    fused = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
    q, k, v = (t.view(b, s, h, d) for t in fused.split(h * d, dim=-1))
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda")
    o, l, m = fa.flash_attention_tile_plain(q, k, v, causal=True)
    l_safe = l.clamp_min(1e-30)
    lse = m + torch.log(l_safe)
    delta = fa.flash_attention_bwd_delta(dout, o / l_safe.transpose(1, 2)[..., None])
    bwd_args = (q, k, v, dout, lse, delta)
    calls = {
        "B2": ((q, k, v), fa.flash_attention_plain(q, k, v, causal=True)),
        "B1": ((q, k, v), (o, l, m)),
        "B3": (bwd_args, fa.flash_attention_bwd_dq_plain(*bwd_args, causal=True)),
        "B4": (bwd_args, fa.flash_attention_bwd_dkv_plain(*bwd_args, causal=True)),
    }

    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, dout))
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    eff_out, eff_lse, seed, offset = eff(qt, kt, vt, None, True, 0.0, True)
    eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    yardsticks = {
        "efficient-attention forward (B2)":
            lambda: eff(qt, kt, vt, None, False, 0.0, True),
        "efficient-attention forward with lse (B1)":
            lambda: eff(qt, kt, vt, None, True, 0.0, True),
        "efficient-attention backward (B3+B4)":
            lambda: eff_bwd(dot, qt, kt, vt, None, eff_out, eff_lse, seed,
                            offset, 0.0, [True, True, True, False], True),
    }

    print(f"[bench] {card}; B={b} S={s} H={h} D={d} causal f32", flush=True)
    for n, tree_kernels in enumerate(kernels):
        errs = []
        for name, (inputs, ref) in calls.items():
            got = tree_kernels[name](*inputs, causal=True)
            got, ref = ((got,), (ref,)) if torch.is_tensor(got) else (got, ref)
            errs.append(f"{name} " + "/".join(
                f"{(g - r).abs().max().item():.3e}" for g, r in zip(got, ref)
            ))
        print(f"[bench] D={d} tree {n} {trees[n]}: max_abs_err " + ", ".join(errs),
              flush=True)
    order = list(range(len(kernels)))
    for r in range(args.rounds):
        for n in order if r % 2 == 0 else order[::-1]:
            times = {
                name: _time_ms(
                    lambda kernel=kernels[n][name], inputs=inputs: kernel(
                        *inputs, causal=True),
                    args.iters,
                )
                for name, (inputs, _) in calls.items()
            }
            print(f"[bench] D={d} round {r} tree {n} on {card}: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in times.items()
            ) + f", B3+B4 {times['B3'] + times['B4']:.4f} ms", flush=True)
        print(f"[bench] D={d} round {r} yardsticks on {card}: " + ", ".join(
            f"{name} {_time_ms(fn, args.iters):.4f} ms"
            for name, fn in yardsticks.items()
        ), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
