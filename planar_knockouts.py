#!/usr/bin/env python3
"""Where the bf16 tensor-core planar kernels spend their time.

Times planar_conv, planar_conv2, planar_conv_gru and planar_gru
(vidmat_torch/csrc/planar_conv.cu, planar_conv2.cu and planar_gru.cu on
bf16 planes) at the 1080p main path's call sites (chip_smoke.py's site
capture: fast_demo, s2d 2, ratio 0.25; the unfused network's planar_gru
sites), each time built from a copy of the vidmat_torch package whose
csrc/planar_mma.cuh (and planar_conv.cu) has one part knocked out:

  as built        the kernels as shipped
  spread scale    the recompute's narrower error scale 2 sqrt(K) |acc| +
                  4 S in place of K |acc| + 4 S (what the wider one
                  costs; same-sign tiny terms then round otherwise)
  no recompute    near_tie never fires: no value is recomputed in the
                  CUDA-core order (results may differ from plain)
  no weights      stage_w, and planar_conv's copy of its packed weights,
                  do nothing (results wrong)
  no inputs       stage_cl, and planar_conv's stage_rows, return at once
                  (results wrong)
  no K loop       the mma K loop runs no step (results wrong)

so each part's share is the difference to "as built". A last build counts
the values each site queues for recomputation. Cold-L2 medians as
chip_smoke.py phase 6 times them.

Each variant runs in a process of its own whose working directory holds
its copy, so ``import vidmat_torch`` there builds and binds the copy's
kernels. The copies (and their libraries) go to
vidmat_torch/build/knockouts/, the table to
chiprun_out/planar_knockouts.json. Needs a CUDA device and nvcc:

    python3 planar_knockouts.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
COPIES = os.path.join(ROOT, "vidmat_torch", "build", "knockouts")
LIBS = {"conv": "planar_conv", "conv2": "planar_conv2",
        "conv_gru": "planar_gru", "gru": "planar_gru"}


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"knockout edit no longer applies: {old[:60]!r}")
    return text.replace(old, new)


def _no_recompute(h):
    return _sub(h, "bool near_tie(float v, float dv) {",
                "bool near_tie(float v, float dv) {\n  return false;")


def _spread_scale(h):
    return _sub(h, "return kU * (kf * fabsf(acc) + 4.0f * sabs);",
                "return kU * (2.0f * sqrtf(kf) * fabsf(acc) + 4.0f * sabs);")


def _no_weights(h):
    return _sub(h, "int kp, int split, int koff2, bf16* dst) {",
                "int kp, int split, int koff2, bf16* dst) {\n  return;")


def _no_inputs(h):
    return _sub(h, "int ps,\n                         int c0, int c1) {",
                "int ps,\n                         int c0, int c1) {\n  return;")


def _no_conv_weights(c):
    return _sub(c, "for (int i = threadIdx.x; i < nv; i += kThreads) "
                   "dst[i] = __ldg(src + i);",
                "for (int i = threadIdx.x; i < 0; i += kThreads) "
                "dst[i] = __ldg(src + i);")


def _no_conv_inputs(c):
    return _sub(c, "int vec) {\n  constexpr int kU = 4;",
                "int vec) {\n  return;\n  constexpr int kU = 4;")


def _no_k_loop(h):
    return _sub(h, "for (int kc = 0; kc < sg.chunks; ++kc) {",
                "for (int kc = 0; kc < 0; ++kc) {")


def _count(h):
    h = _sub(h, "constexpr int kQueue = 32;", """constexpr int kQueue = 32;
__device__ unsigned long long g_counts[2];
extern "C" void vm_take_counts(unsigned long long* out) {
  unsigned long long zero[2] = {0, 0};
  cudaMemcpyFromSymbol(out, g_counts, sizeof(zero));
  cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));
}""")
    return _sub(h, "      const bool need = r < npix && !epi(r, n, v, "
                   "err_scale(v, sv, kf));",
                """      const bool need = r < npix && !epi(r, n, v, err_scale(v, sv, kf));
      const unsigned queued = __ballot_sync(0xFFFFFFFFu, need);
      const unsigned valid = __ballot_sync(0xFFFFFFFFu, r < npix);
      if (lane == 0) {
        atomicAdd(&g_counts[0], (unsigned long long)__popc(queued));
        atomicAdd(&g_counts[1], (unsigned long long)__popc(valid));
      }""")


# variant -> {csrc file: edit}
VARIANTS = {"as built": {}, "spread scale": {"planar_mma.cuh": _spread_scale},
            "no recompute": {"planar_mma.cuh": _no_recompute},
            "no weights": {"planar_mma.cuh": _no_weights,
                           "planar_conv.cu": _no_conv_weights},
            "no inputs": {"planar_mma.cuh": _no_inputs,
                          "planar_conv.cu": _no_conv_inputs},
            "no K loop": {"planar_mma.cuh": _no_k_loop},
            "count": {"planar_mma.cuh": _count}}


def _python(copy, code):
    """A Python process running ``code`` in ``copy`` (its vidmat_torch
    first on the path, then this directory's chip_smoke.py)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen([sys.executable, "-c", code], cwd=copy, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def make_copies():
    """{variant: directory}: one edited copy of the package per variant,
    its three planar libraries compiled, every copy in parallel."""
    copies, procs = {}, []
    libs = sorted(set(LIBS.values()))
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = os.path.join(COPIES, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "vidmat_torch"),
                        os.path.join(d, "vidmat_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        for fname, edit in edits.items():
            path = os.path.join(d, "vidmat_torch", "csrc", fname)
            with open(path) as f:
                text = edit(f.read())
            with open(path, "w") as f:
                f.write(text)
        copies[name] = d
        procs.append((name, _python(
            d, f"from vidmat_torch.ops import _build; _build.build({libs})")))
    outs = [(name, proc.communicate()[0], proc.returncode)
            for name, proc in procs]
    failed = [f"build failed for {name!r}:\n{out}"
              for name, out, rc in outs if rc != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return copies


def run_variant(name: str) -> None:
    """In a copy: time every site (or, for "count", count the values it
    queues) and print the result as one JSON line."""
    import ctypes

    import torch

    import chip_smoke as cs
    import vidmat_torch
    from vidmat_torch.config import preset_video_1080p
    from vidmat_torch.models.weights import build_network, default_variables
    from vidmat_torch.ops import _build

    if not vidmat_torch.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"not the copy's package: {vidmat_torch.__file__}")
    dev = torch.device("cuda")
    mcfg, _ = preset_video_1080p()
    variables = default_variables(mcfg)
    net = build_network(mcfg, variables, dtype=torch.bfloat16, device=dev)
    net_u = build_network(mcfg, variables, dtype=torch.bfloat16, device=dev,
                          fuse_pairs=False)
    chunk = torch.from_numpy(cs.padded_clip(cs.CHUNK, seed=11)).to(dev)
    sites = cs.capture_sites(net, net_u, cs.coarse_input(net, chunk))
    ops = cs.planar_ops()
    row = {}
    for site, (key, args) in sites.items():
        if name != "count":
            row[site] = cs.time_cold(cs.kernel_call(key, args))
            continue
        take = _build.load(LIBS[key]).vm_take_counts
        take.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        take.restype = None
        counts = (ctypes.c_ulonglong * 2)()
        torch.cuda.synchronize()
        take(counts)
        ops[key][0](*args)
        torch.cuda.synchronize()
        take(counts)
        row[site] = [counts[0], counts[1]]
    print(json.dumps(row))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("planar_knockouts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    gpu = cs.gpu_line()
    table = {"gpu": gpu, "ms": {}, "recomputed": {}}
    for name, d in make_copies().items():
        out, _ = _python(d, "import planar_knockouts as k; "
                         f"k.run_variant({name!r})").communicate()
        try:
            row = json.loads(out.strip().splitlines()[-1])
        except (ValueError, IndexError):
            raise RuntimeError(f"variant {name!r} failed:\n{out}") from None
        if name == "count":
            table["recomputed"] = row
            continue
        table["ms"][name] = row
        print(f"{name:13s} " + " ".join(f"{s} {t:.4f}" for s, t in row.items())
              + f"  ({gpu})", flush=True)
    print("recomputed values / values per site: " + ", ".join(
        f"{s} {q}/{n}" for s, (q, n) in table["recomputed"].items()))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "planar_knockouts.json"),
              "w") as f:
        json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
