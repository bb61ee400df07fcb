"""Probe: would int8-stored activation planes speed up the planar net?
(counterpart of tools/bench_int8_planes.py)

The planar net's convs are bound by the bytes of their bf16 activations;
int8 storage halves them, if dequantizing on load and requantizing on
store costs less than it saves. The probe times a chain of 3x3 16 -> 16
convs at the 1080p serving net's level-0 grid (144x240) over a batch of
8, two variants:

  bf16-planes  planar_conv on bf16 planes (the port's tensor-core CUDA
               kernel, scale 1, bias 0, ReLU), the layer the planar net
               runs
  int8-planes  int8_conv (csrc/int8_conv.cu, the same bf16 tensor-core
               implicit GEMM): int8 in, dequantize, the same conv and
               ReLU, requantize to int8 (q = 64)

Per-layer time = (time of the long chain - time of the short chain) /
(long - short), timed with CUDA events, the variants' samples interleaved
round-robin; the median over repeats is reported with its range. Needs a
CUDA device.

    python -m vidmat_torch.tools.bench_int8_planes [--repeats 9]
        [--short 4] [--long 24] [--batch 8]
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

H, W, C = 144, 240, 16


def _layer_weights(seed: int = 0) -> torch.Tensor:
    """The probe's (16, 16, 3, 3) bf16 weights: randn * 0.2 drawn as the
    JAX probe draws its (9, C_out, C_in) tap stack."""
    taps = np.random.RandomState(seed).randn(9, C, C).astype(np.float32)
    w = (taps * 0.2).reshape(3, 3, C, C).transpose(2, 3, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(w)).to(torch.bfloat16)


def variants(batch: int = 8, device="cuda"):
    """{name: (one layer as a function of its input, the chain's input)}
    on ``device``."""
    from vidmat_torch.ops.int8_planar import Q, int8_conv
    from vidmat_torch.ops.planar import pack_conv_weight, planar_conv

    w = _layer_weights().to(device)
    wp = pack_conv_weight(w)
    ones = torch.ones(C, device=device)
    zeros = torch.zeros(C, device=device)
    x0 = torch.from_numpy(np.random.RandomState(1).randn(
        batch, C, H, W).astype(np.float32) * 0.5).to(device)
    return {
        "bf16-planes": (lambda x: planar_conv([x], w, ones, zeros, 1, "relu",
                                              wp), x0.to(torch.bfloat16)),
        "int8-planes": (lambda x: int8_conv(x, w, packed=wp),
                        torch.round(x0 * Q).clamp(-127, 127).to(torch.int8)),
    }


def _chain_ms(step, n: int, x) -> float:
    """Device ms of n chained layers, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        x = step(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run(repeats: int = 9, short: int = 4, long: int = 24,
        batch: int = 8) -> dict:
    """{variant: {"ms": median ms per layer-batch, "min", "max", "n"}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_int8_planes measures the card: no CUDA "
                           "device is available")
    built = variants(batch)
    for step, x in built.values():  # build the kernels, warm up
        _chain_ms(step, short, x)
        _chain_ms(step, long, x)
    samples = {name: [] for name in built}
    for _ in range(repeats):
        for name, (step, x) in built.items():
            d = (_chain_ms(step, long, x) - _chain_ms(step, short, x)) / (
                long - short)
            if d > 0:
                samples[name].append(d)
    return {name: dict(ms=statistics.median(s), min=min(s), max=max(s),
                       n=len(s))
            for name, s in samples.items() if s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=9)
    ap.add_argument("--short", type=int, default=4)
    ap.add_argument("--long", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    res = run(args.repeats, args.short, args.long, args.batch)
    print(f"device: {torch.cuda.get_device_name(0)}")
    for name, r in res.items():
        print(f"{name}: {r['ms']:.4f} ms/layer-batch (n={r['n']}, "
              f"{r['min']:.4f}-{r['max']:.4f})")


if __name__ == "__main__":
    main()
