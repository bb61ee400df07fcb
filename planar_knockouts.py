#!/usr/bin/env python3
"""Where the hand-written kernels spend their time, and whether an edit
changed their bytes.

    python3 planar_knockouts.py                  # the bf16 planar kernels
    python3 planar_knockouts.py --tail [PREFIX]  # the tail kernels
    python3 planar_knockouts.py --parent DIR     # tail A/B against DIR

Planar (no option): times planar_conv, planar_conv2, planar_conv_gru and
planar_gru (vidmat_torch/csrc/planar_conv.cu, planar_conv2.cu and
planar_gru.cu on bf16 planes) at the 1080p main path's call sites
(chip_smoke.py's site capture: fast_demo, s2d 2, ratio 0.25; the unfused
network's planar_gru sites), each time built from a copy of the
vidmat_torch package whose csrc/planar_mma.cuh (and planar_conv.cu) has
one part knocked out:

  as built        the kernels as shipped
  spread scale    the recompute's narrower error scale 2 sqrt(K) |acc| +
                  4 S in place of K P + 4 S (what the wider one
                  costs; same-sign tiny terms then round otherwise)
  final-sum scale K |acc| + 4 S, the scale before P (the larger of |acc|
                  and the largest K step's mass) replaced |acc|: what P
                  costs; big terms that cancel then round otherwise
  no recompute    near_tie never fires: no value is recomputed in the
                  CUDA-core order (results may differ from plain)
  no weights      stage_w, and planar_conv's copy of its packed weights,
                  do nothing (results wrong)
  no inputs       stage_cl, and planar_conv's stage_rows, return at once
                  (results wrong)
  no K loop       the mma K loop runs no step (results wrong)

so each part's share is the difference to "as built". A last build counts
the values each site queues for recomputation. Table to
chiprun_out/planar_knockouts.json.

--tail: the same for ingest_pool_normalize and fused_refine_composite
(csrc/ingest.cu, refine_composite.cu) at the main path's 4-frame
1088x1920 chunk and at 1 frame, fused_refine_float (refine_float.cu) at
the session's 1-frame 1088x1920 launch and composite_rgba_packed
(composite.cu) premultiplied at 1 frame of 480x864 and of 1088x1920 and
int8_conv (int8_conv.cu) at the probe's layer-batch and one image,
with the knockouts of TAIL_VARIANTS (those whose name starts with PREFIX,
if given, and "as built" on their kernels). Table to
chiprun_out/tail_knockouts.json.

--parent DIR: DIR holds another tree's vidmat_torch/ package, for
example an earlier commit's (git archive <commit> vidmat_torch | tar -x
-C DIR). Ingest and the packed tail of both trees run on the same inputs
made from seeds, in the order parent, this tree, this tree, parent:

  refine   fused_refine_composite in its five background modes (none,
           color, image, per_frame, coarse) at the chunk and at 1 frame,
           and at ragged shapes: pool 2 at a width that is not a
           multiple of 4, pool 8 with an odd coarse width that does not
           fill a tile, pool 4 with partial tiles in both directions; 2
           frames each
  ingest   ingest_pool_normalize at the chunk (bf16 and f32) and at
           ragged shapes (pools 2 and 8, 4 channels, a width that is not
           a multiple of 16)
  float    fused_refine_float at the session's 1088x1920 frame (pool 4),
           pools 2 and 8, pool 4 with a ragged last strip on 1 and 2
           frames, and a frame one byte off alignment (the per-pixel
           body)
  composite composite_rgba_packed in its four modes (none, color, image,
           per_frame) at 1 frame of 480x864 and 1088x1920, 2 frames of
           1088x1920, a ragged 2 x 37 x 53 and the same from buffers one
           element off alignment (the scalar path)
  int8     int8_conv (the int8 planes probe's layer, its weights) at the
           probe's 8 x 16 x 144 x 240 layer-batch, one 144x240 image, a
           ragged 37x53 and 2 images one byte off alignment

The first parent run saves every output; the first run of this tree
counts, per case, the outputs unequal to the parent's and to the plain
twin: bytes, or for the float tail values (with the values equal but for
the sign of a zero counted apart). Every run times the launch-shape
cases (TIMED). Table to chiprun_out/tail_ab.json; the exit code is 1 if
an output differs from the parent's, except int8_conv's, which sums in
another order than an earlier kernel may: its values unequal to the
parent's are counted, and the exit code is 1 if it is more than 1 unit
from the plain twin or differs from it in 1e-3 of its values or more.

Each tree or edited copy runs in a process of its own whose working
directory holds its package, so ``import vidmat_torch`` there builds and
binds that package's kernels. The copies (and their libraries) go to
vidmat_torch/build/knockouts/. Cold-L2 medians as chip_smoke.py phase 6
times them. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


_SCALE = "return kU * (kf * fmaxf(fabsf(acc), big) + 4.0f * sabs);"


def _spread_scale(h):
    return _sub(h, _SCALE,
                "return kU * (2.0f * sqrtf(kf) * fabsf(acc) + 4.0f * sabs);")


def _final_sum_scale(h):
    return _sub(h, _SCALE, "return kU * (kf * fabsf(acc) + 4.0f * sabs);")


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
                   "err_scale(v, sv, bg, kf));",
                """      const bool need = r < npix && !epi(r, n, v, err_scale(v, sv, bg, kf));
      const unsigned queued = __ballot_sync(0xFFFFFFFFu, need);
      const unsigned valid = __ballot_sync(0xFFFFFFFFu, r < npix);
      if (lane == 0) {
        atomicAdd(&g_counts[0], (unsigned long long)__popc(queued));
        atomicAdd(&g_counts[1], (unsigned long long)__popc(valid));
      }""")


# variant -> {csrc file: edit}
VARIANTS = {"as built": {}, "spread scale": {"planar_mma.cuh": _spread_scale},
            "final-sum scale": {"planar_mma.cuh": _final_sum_scale},
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


def make_copies(variants, libs, subdir):
    """{variant: directory}: one edited copy of the package per variant
    under COPIES/subdir, the given libraries ({variant: libraries} or one
    list for all) compiled, every copy in parallel."""
    copies = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = os.path.join(COPIES, subdir, str(i))
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
    # Every edit applied: build the copies, all at once.
    procs = []
    for name, d in copies.items():
        built = libs[name] if isinstance(libs, dict) else libs
        procs.append((name, _python(
            d, f"from vidmat_torch.ops import _build; _build.build({built})")))
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


def _json_run(tree: str, code: str) -> dict:
    """The JSON line that ``code``, run in ``tree`` by _python, prints
    last."""
    out, _ = _python(tree, code).communicate()
    try:
        return json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        raise RuntimeError(f"{code!r} in {tree} failed:\n{out}") from None


def planar_main(gpu: str) -> int:
    table = {"gpu": gpu, "ms": {}, "recomputed": {}}
    copies = make_copies(VARIANTS, sorted(set(LIBS.values())), "planar")
    for name, d in copies.items():
        row = _json_run(d, "import planar_knockouts as k; "
                        f"k.run_variant({name!r})")
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


# ---- ingest and the packed tail ------------------------------------------

MODES = ("none", "color", "image", "per_frame", "coarse")
# (label, n, h, w, pool) of the refine cases; the first two are timed.
REFINE_SHAPES = [("chunk", 4, 1088, 1920, 4), ("frame", 1, 1088, 1920, 4),
                 ("pool2 w%4=2", 2, 36, 302, 2),
                 ("pool8 wl=37", 2, 64, 296, 8),
                 ("pool4 partial tiles", 2, 36, 300, 4)]
# (label, shape, pool, dtype name); the first and the last are timed.
INGEST_CASES = [("chunk bf16", (4, 1088, 1920, 3), 4, "bfloat16"),
                ("chunk f32", (4, 1088, 1920, 3), 4, "float32"),
                ("pool2 c4", (2, 100, 152, 4), 2, "bfloat16"),
                ("pool8", (2, 64, 96, 3), 8, "bfloat16"),
                ("pool4 w%16=4", (1, 64, 100, 3), 4, "float32"),
                ("pool4 c4", (2, 64, 96, 4), 4, "bfloat16"),
                ("frame bf16", (1, 1088, 1920, 3), 4, "bfloat16")]
# (label, n, h, w, pool, frame offset) of the float tail's cases.
FLOAT_CASES = [("frame", 1, 1088, 1920, 4, 0), ("pool2", 2, 36, 52, 2, 0),
               ("pool8", 2, 64, 296, 8, 0),
               ("pool4 36x300", 1, 36, 300, 4, 0),
               ("pool4 2x36x300", 2, 36, 300, 4, 0),
               ("pool4 offset frame", 2, 36, 300, 4, 1)]
# (label, n, h, w, offset in elements) of composite's cases, each in the
# four modes.
COMPOSITE_CASES = [("480x864", 1, 480, 864, 0),
                   ("1088x1920", 1, 1088, 1920, 0),
                   ("2x1088x1920", 2, 1088, 1920, 0),
                   ("ragged 37x53", 2, 37, 53, 0),
                   ("offset 37x53", 2, 37, 53, 1)]
COMPOSITE_MODES = ("none", "color", "image", "per_frame")
# (label, shape, offset in bytes) of int8_conv's cases.
INT8_CASES = [("batch 8x144x240", (8, 16, 144, 240), 0),
              ("1 image 144x240", (1, 16, 144, 240), 0),
              ("ragged 37x53", (1, 16, 37, 53), 0),
              ("offset 2x144x240", (2, 16, 144, 240), 1)]
TIMED = ("refine chunk", "refine frame", "ingest chunk bf16",
         "ingest frame bf16", "float frame", "composite none 480x864",
         "composite none 1088x1920", "int8 batch 8x144x240",
         "int8 1 image 144x240")
TAIL_SAVE = os.path.join(ROOT, "vidmat_torch", "build", "tail_ab")


def refine_inputs(n, h, w, pool, mode, dev, seed=0):
    """Frame, coefficient grids and background of one refine case: the
    synthetic clip's frames where the shape is the main path's, else
    random bytes; coefficients that drive alpha and fgr past both ends of
    [0, 1]; backgrounds slightly outside [0, 1]."""
    import torch

    g = torch.Generator().manual_seed(seed)
    if (h, w) == (1088, 1920):
        import chip_smoke as cs

        frame = torch.from_numpy(cs.padded_clip(n, seed=12 + seed))
    else:
        frame = torch.randint(0, 256, (n, h, w, 3), generator=g,
                              dtype=torch.uint8)
    hl, wl = h // pool, w // pool
    a = torch.rand((n, hl, wl, 4), generator=g) * 2 - 0.5
    b = torch.rand((n, hl, wl, 4), generator=g) * 1.5 - 0.5
    shape = {"image": (h, w, 3), "per_frame": (n, h, w, 3),
             "coarse": (n, hl, wl, 3)}.get(mode)
    if mode == "none":
        bg = None
    elif mode == "color":
        bg = (0.2, 0.9, 0.4)
    else:
        bg = (torch.rand(shape, generator=g) * 1.2 - 0.1).to(dev)
    return frame.to(dev), a.to(dev), b.to(dev), bg


def tail_cases(dev, timed_only, kinds):
    """{case name: (kernel output, plain output or None, call)} of every
    case (or of the timed ones, without the plain output) of the given
    kernels ("refine", "ingest", "float", "composite", "int8") on this
    process's package. Outputs are flat: bytes, int8_conv's int8 values,
    or the float tail's float32 alpha and fgr."""
    import inspect

    import torch

    from chip_smoke import offset_copy
    from vidmat_torch.ops.composite import (composite_rgba_packed,
                                            composite_rgba_packed_plain)
    from vidmat_torch.ops.ingest import (ingest_pool_normalize,
                                         ingest_pool_normalize_plain)
    from vidmat_torch.ops.int8_planar import int8_conv, int8_conv_plain
    from vidmat_torch.ops.planar import pack_conv_weight
    from vidmat_torch.ops.refine import (fused_refine_composite,
                                         fused_refine_composite_plain,
                                         fused_refine_float,
                                         fused_refine_float_plain)
    from vidmat_torch.tools.bench_int8_planes import _layer_weights

    def as_bytes(t):
        return t.contiguous().view(torch.uint8).reshape(-1)

    def flat(pair):
        return torch.cat([t.reshape(-1) for t in pair])

    out = {}
    for label, n, h, w, pool in REFINE_SHAPES:
        timed = f"refine {label}" in TIMED
        if "refine" not in kinds or timed_only and not timed:
            continue
        for mode in MODES:
            fr, a, b, bg = refine_inputs(n, h, w, pool, mode, dev)
            k = fused_refine_composite(fr, a, b, bg, pool)
            p = None if timed_only else fused_refine_composite_plain(
                fr, a, b, bg, pool)
            call = (lambda fr=fr, a=a, b=b, bg=bg, pool=pool:
                    fused_refine_composite(fr, a, b, bg, pool))
            out[f"refine {mode} {label}"] = (
                as_bytes(k), None if p is None else as_bytes(p),
                call if timed else None)
    for label, shape, pool, dt in INGEST_CASES:
        timed = f"ingest {label}" in TIMED
        if "ingest" not in kinds or timed_only and not timed:
            continue
        g = torch.Generator().manual_seed(100)
        img = torch.randint(0, 256, shape, generator=g,
                            dtype=torch.uint8).to(dev)
        dtype = getattr(torch, dt)
        k = ingest_pool_normalize(img, pool, out_dtype=dtype)
        p = None if timed_only else ingest_pool_normalize_plain(
            img, pool, out_dtype=dtype)
        call = (lambda img=img, pool=pool, dtype=dtype:
                ingest_pool_normalize(img, pool, out_dtype=dtype))
        out[f"ingest {label}"] = (
            as_bytes(k), None if p is None else as_bytes(p),
            call if timed else None)
    for label, n, h, w, pool, off in FLOAT_CASES:
        timed = f"float {label}" in TIMED
        if "float" not in kinds or timed_only and not timed:
            continue
        fr, a, b, _ = refine_inputs(n, h, w, pool, "none", dev, seed=1)
        fr = offset_copy(fr, off)
        k = flat(fused_refine_float(fr, a, b, pool))
        p = None if timed_only else flat(fused_refine_float_plain(fr, a, b,
                                                                  pool))
        call = (lambda fr=fr, a=a, b=b, pool=pool:
                fused_refine_float(fr, a, b, pool))
        out[f"float {label}"] = (k, p, call if timed else None)
    for label, n, h, w, off in COMPOSITE_CASES:
        g = torch.Generator().manual_seed(200)
        fgr = offset_copy(torch.rand((n, h, w, 3), generator=g).to(dev), off)
        alpha = offset_copy((torch.rand((n, h, w, 1), generator=g) * 1.2
                             - 0.1).to(dev), off)
        for mode in COMPOSITE_MODES:
            timed = f"composite {mode} {label}" in TIMED
            if "composite" not in kinds or timed_only and not timed:
                continue
            shape = {"image": (h, w, 3), "per_frame": (n, h, w, 3)}.get(mode)
            bg = ((0.2, 0.9, 0.4) if mode == "color" else None
                  if shape is None else offset_copy(
                      (torch.rand(shape, generator=g) * 1.2 - 0.1).to(dev),
                      off))
            k = composite_rgba_packed(fgr, alpha, bg)
            p = None if timed_only else composite_rgba_packed_plain(
                fgr, alpha, bg)
            call = (lambda fgr=fgr, alpha=alpha, bg=bg:
                    composite_rgba_packed(fgr, alpha, bg))
            out[f"composite {mode} {label}"] = (
                as_bytes(k), None if p is None else as_bytes(p),
                call if timed else None)
    w8 = _layer_weights().to(dev)
    # An earlier tree's int8_conv packs its weights itself, or reads w.
    kw = ({"packed": pack_conv_weight(w8)}
          if "packed" in inspect.signature(int8_conv).parameters else {})
    for label, shape, off in INT8_CASES:
        timed = f"int8 {label}" in TIMED
        if "int8" not in kinds or timed_only and not timed:
            continue
        g = torch.Generator().manual_seed(300)
        x = offset_copy(torch.randint(-127, 128, shape, generator=g,
                                      dtype=torch.int8).to(dev), off)
        k = int8_conv(x, w8, **kw)
        p = None if timed_only else int8_conv_plain(x, w8)
        out[f"int8 {label}"] = (k.reshape(-1),
                                None if p is None else p.reshape(-1),
                                (lambda x=x: int8_conv(x, w8, **kw))
                                if timed else None)
    return out


def tail_worker(action: str,
                kinds=("refine", "ingest", "float", "composite", "int8")
                ) -> None:
    """In one tree's process: run the cases; save the outputs (action
    "save"), or count the outputs unequal to the saved ones ("compare"),
    or neither ("none"); time the timed cases ("time": only those, as the
    knockouts do). Prints one JSON line."""
    import torch

    import chip_smoke as cs
    import vidmat_torch

    if not vidmat_torch.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"not the tree's package: {vidmat_torch.__file__}")
    dev = torch.device("cuda")
    cases = tail_cases(dev, action == "time", kinds)
    torch.cuda.synchronize()
    row = {"package": os.path.dirname(vidmat_torch.__file__), "cases": {}}
    os.makedirs(TAIL_SAVE, exist_ok=True)
    for name, (k, p, call) in cases.items():
        res = {}
        is_float = k.dtype == torch.float32
        if p is not None:
            res["unequal_to_plain"] = int((k != p).sum())
            if is_float:
                res["max_abs_to_plain"] = float((k - p).abs().max())
            if name.startswith(("refine", "int8")):
                res["max_lsb_to_plain"] = int((k.int() - p.int()).abs()
                                              .max())
                res["values"] = k.numel()
        path = os.path.join(TAIL_SAVE, name.replace(" ", "_")
                            .replace("%", "") + ".pt")
        if action == "save":
            torch.save(k.cpu(), path)
        elif action == "compare":
            par = torch.load(path).to(dev)
            res["unequal_to_parent"] = int((k != par).sum())
            if is_float:
                res["signed_zeros_to_parent"] = int(
                    ((k == par) & (k.view(torch.int32)
                                   != par.view(torch.int32))).sum())
        if call is not None:
            res["ms"] = cs.time_cold(call)
        row["cases"][name] = res
    print(json.dumps(row), flush=True)


def _refine_no_coefficients(s):
    return _sub(s, "    t[0] = a.ma[r0];\n    t[1] = a.ma[r1];\n"
                   "    t[2] = a.mb[r0];\n    t[3] = a.mb[r1];\n",
                "    t[0] = make_float4((float)r0, 1.f, 2.f, 3.f);\n"
                "    t[1] = make_float4((float)r1, 3.f, 2.f, 1.f);\n"
                "    t[2] = t[0];\n    t[3] = t[1];\n")


def _refine_no_shuffles(s):
    return _sub(s, "    const float4 ra_p = next_lane(ra), "
                   "rb_p = next_lane(rb);\n",
                "    const float4 ra_p = ra, rb_p = rb;\n")


def _refine_no_frame(s):
    return _sub(s, "fw[r][k] = full && y_first + r < g.h ? src[k] : 0u;",
                "fw[r][k] = k + (uint32_t)(size_t)src;")


def _refine_no_math(s):
    return _sub(s, "  const float4 A = lerp4k<KIND>(alo, ahi, f);",
                "  return __float_as_uint(alo.x + ahi.y + blo.z + bhi.w + f"
                " + lum + bgc.x);\n"
                "  const float4 A = lerp4k<KIND>(alo, ahi, f);")


def _refine_no_stores(s):
    return _sub(s, "      o[0] = make_uint2(word[0], word[1]);\n"
                   "      o[1] = make_uint2(word[2], word[3]);\n",
                "      if (word[0] == 0x12345u && word[1] == 7u) {\n"
                "        o[0] = make_uint2(word[0], word[1]);\n"
                "        o[1] = make_uint2(word[2], word[3]);\n      }\n")


def _refine_no_exact_fma(s):
    return _sub(s, "  if constexpr (KIND == 1) return __fmaf_rn(f, q, g * p);"
                   "\n  if constexpr (KIND == 2) return __fmaf_rn(g, p, f * q);"
                   "\n", "")


def _rows(n):
    def edit(s):
        s, count = re.subn(r"constexpr int kRows = \d+;",
                           f"constexpr int kRows = {n};", s)
        if count != 1:
            raise RuntimeError("knockout edit no longer applies: kRows")
        return s
    return edit


def _refine_no_register_cap(s):
    return _sub(s, "__global__ void __launch_bounds__(kThreads, 3)\n",
                "__global__ void __launch_bounds__(kThreads)\n")


def _refine_divisions(s):
    if "kPool, &" not in s:
        raise RuntimeError("knockout edit no longer applies: 'kPool, &'")
    return s.replace("kPool, &", "g.pool, &")


_FLOAT_STORES = ("    store_run(a.alpha + prow, sa, lo, hi, lane);\n"
                 "    store_run(a.fgr + 3 * prow, sf, 3 * lo, 3 * hi, "
                 "lane);\n")


def _float_no_stores(s):
    return _sub(s, _FLOAT_STORES, "    if (sa[lane] == 1234.5f) {\n"
                + _FLOAT_STORES + "    }\n")


def _float_blocks_256(s):
    return _sub(s, "constexpr int kThreads = 128;",
                "constexpr int kThreads = 256;")


def _float_register_cap(s):
    return _sub(s, "__global__ void __launch_bounds__(kThreads) "
                   "refine_float_kernel",
                "__global__ void __launch_bounds__(kThreads, 8) "
                "refine_float_kernel")


def _composite_scalar(s):
    return _sub(s, "  const bool vec = aligned16(fgr)",
                "  const bool vec = false && aligned16(fgr)")


def _composite_no_stores(s):
    s = _sub(s, "  reinterpret_cast<uint4*>(a.out)[gi] = make_uint4(",
             "  const uint4 o = make_uint4(")
    last = "      word(mode, f2.y, f2.z, f2.w, al.w, b2.y, b2.z, b2.w));\n"
    return _sub(s, last, last + "  if ((o.x ^ o.y ^ o.z ^ o.w) == 0x12345u)\n"
                "    reinterpret_cast<uint4*>(a.out)[gi] = o;\n")


def _composite_runtime_mode(s):
    return _sub(s, "  const int mode = MODE;", "  const int mode = a.mode;")


_INT8_MMA = ("          mma16816(acc[m][0], a, b[0], b[1]);\n"
             "          mma16816(acc[m][1], a, b[2], b[3]);\n")


def _int8_no_mma(s):
    return _sub(s, _INT8_MMA, "")


def _int8_mma_accumulates(s):
    acc = "".join(
        f"""          asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{{%0, %1, %2, %3}}, {{%4, %5, %6, %7}}, {{%8, %9}}, "
              "{{%0, %1, %2, %3}};\\n"
              : "+f"(acc[m][{j}][0]), "+f"(acc[m][{j}][1]),
                "+f"(acc[m][{j}][2]), "+f"(acc[m][{j}][3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                "r"(b[{2 * j}]), "r"(b[{2 * j + 1}]));
""" for j in (0, 1))
    return _sub(s, _INT8_MMA, acc)


def _int8_no_loads(s):
    s = _sub(s, "      f.v[u][0] = __ldg(reinterpret_cast<const uint4*>(src));\n"
                "      f.v[u][1] = __ldg(reinterpret_cast<const uint4*>(src + "
                "hw));\n",
             "      f.v[u][0] = make_uint4((uint32_t)(size_t)src, 1u, 2u, 3u);"
             "\n      f.v[u][1] = f.v[u][0];\n")
    return _sub(s, "      f.h[u][0] = (uint8_t)__ldg(src);\n      f.h[u][1] = "
                   "(uint8_t)__ldg(src + hw);\n",
                "      f.h[u][0] = (int)(size_t)src & 63;\n"
                "      f.h[u][1] = 1;\n")


_INT8_STORE = ("      *reinterpret_cast<uint4*>(ob + co * hw + (size_t)gy * wd + "
               "gx) =\n")


def _int8_no_stores(s):
    s = _sub(s, _INT8_STORE, "      const uint4 o4 =\n")
    return _sub(s, "                                          r * kTileW + s * "
                   "16);\n",
                "                                          r * kTileW + s * "
                "16);\n      if (o4.x == 0x12345678u && o4.w == 7u)\n"
                "  " + _INT8_STORE + "          o4;\n")


def _int8_scalar(s):
    return _sub(s, "  const bool vec = wd % 16 == 0 &&",
                "  const bool vec = false && wd % 16 == 0 &&")


def _int8_const(name, value):
    def edit(s):
        s, count = re.subn(rf"constexpr int {name} = \d+;",
                           f"constexpr int {name} = {value};", s)
        if count != 1:
            raise RuntimeError(f"knockout edit no longer applies: {name}")
        return s
    return edit


def _ingest_no_loads(s):
    return _sub(s, "if (j < 3 * ng)", "if (j < 0)")


_INGEST_STORE = ("  store12(out + (((long long)b * oh + oy) * ow + "
                 "4 * (g0 + lane)) * 3, res);")


def _ingest_no_stores(s):
    return _sub(s, _INGEST_STORE,
                "  if (res[0] == 1234.5f && res[5] == 3.0f)\n" + _INGEST_STORE)


# variant -> {csrc file: edit}. Each but the first knocks one part out or
# changes one choice (the outputs may then be wrong), so its share is the
# difference to "as built".
TAIL_VARIANTS = {
    "as built": {},
    "refine: no coefficient loads": {
        "refine_composite.cu": _refine_no_coefficients},
    "refine: no shuffles": {"refine_composite.cu": _refine_no_shuffles},
    "refine: no frame loads": {"refine_composite.cu": _refine_no_frame},
    "refine: no pixel math": {"refine_composite.cu": _refine_no_math},
    "refine: no stores": {"refine_composite.cu": _refine_no_stores},
    "refine: no exact FMAs": {"refine_composite.cu": _refine_no_exact_fma},
    "refine: 1 row a warp": {"refine_composite.cu": _rows(1)},
    "refine: 4 rows a warp": {"refine_composite.cu": _rows(4)},
    "refine: no register cap": {
        "refine_composite.cu": _refine_no_register_cap},
    "refine: divisions": {"refine_composite.cu": _refine_divisions},
    "ingest: no loads": {"ingest.cu": _ingest_no_loads},
    "ingest: no stores": {"ingest.cu": _ingest_no_stores},
    "float: no coefficient loads": {"refine_float.cu":
                                    _refine_no_coefficients},
    "float: no stores": {"refine_float.cu": _float_no_stores},
    "float: <= 64 registers": {"refine_float.cu": _float_register_cap},
    "float: 256-thread blocks": {"refine_float.cu": _float_blocks_256},
    "float: divisions": {"refine_float.cu": _refine_divisions},
    "float: 2 rows a warp": {"refine_float.cu": _rows(2)},
    "float: 4 rows a warp": {"refine_float.cu": _rows(4)},
    "composite: scalar loads": {"composite.cu": _composite_scalar},
    "composite: no stores": {"composite.cu": _composite_no_stores},
    "composite: runtime mode": {"composite.cu": _composite_runtime_mode},
    "int8: no mma": {"int8_conv.cu": _int8_no_mma},
    "int8: mma accumulates": {"int8_conv.cu": _int8_mma_accumulates},
    "int8: no loads": {"int8_conv.cu": _int8_no_loads},
    "int8: no stores": {"int8_conv.cu": _int8_no_stores},
    "int8: scalar staging": {"int8_conv.cu": _int8_scalar},
    "int8: 64-column tiles": {"int8_conv.cu": _int8_const("kTileW", 64)},
    "int8: 128-thread blocks": {"int8_conv.cu": _int8_const("kThreads", 128)},
}
# csrc file -> (tail_cases kind, library)
TAIL_KINDS = {"refine_composite.cu": ("refine", "refine_composite"),
              "ingest.cu": ("ingest", "ingest"),
              "refine_float.cu": ("float", "refine_float"),
              "composite.cu": ("composite", "composite"),
              "int8_conv.cu": ("int8", "int8_conv")}


def tail_main(gpu: str, prefix: str = "") -> int:
    """Time the edited kernels of every TAIL_VARIANTS copy whose name
    starts with ``prefix`` (and "as built")."""
    variants = {name: edits for name, edits in TAIL_VARIANTS.items()
                if not edits or name.startswith(prefix)}
    files = {name: list(edits) for name, edits in variants.items()}
    files["as built"] = sorted({f for fs in files.values() for f in fs})
    copies = make_copies(variants, {
        name: sorted({TAIL_KINDS[f][1] for f in fs})
        for name, fs in files.items()}, "tail")
    table = {"gpu": gpu, "ms": {}}
    for name, d in copies.items():
        kinds = sorted({TAIL_KINDS[f][0] for f in files[name]})
        row = _json_run(d, "import planar_knockouts as k; "
                        f"k.tail_worker('time', {kinds!r})")
        table["ms"][name] = {c: e["ms"] for c, e in row["cases"].items()}
    names = list(table["ms"]["as built"])
    print(f"tail knockouts, cold-L2 ms ({gpu}):")
    print(f"{'':29s} " + " ".join(f"{n[:18]:>18s}" for n in names))
    for name, row in table["ms"].items():
        print(f"{name:29s} " + " ".join(
            f"{row[n]:18.4f}" if n in row else f"{'':18s}" for n in names),
            flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tail_knockouts.json"),
              "w") as f:
        json.dump(table, f, indent=1)
    return 0


def tail_ab(parent: str, gpu: str) -> int:
    """This tree's tail kernels against ``parent``'s."""
    parent = os.path.abspath(parent)
    if not os.path.isdir(os.path.join(parent, "vidmat_torch")):
        raise SystemExit(f"{parent} holds no vidmat_torch/")
    runs = [_json_run(tree, "import planar_knockouts as k; "
                      f"k.tail_worker({action!r})")
            for tree, action in ((parent, "save"), (ROOT, "compare"),
                                 (ROOT, "none"), (parent, "none"))]
    table = {"gpu": gpu, "cases": {}}
    for name, res in runs[1]["cases"].items():
        entry = dict(res)
        entry["parent_unequal_to_plain"] = \
            runs[0]["cases"][name]["unequal_to_plain"]
        if "ms" in res:
            entry["ms"] = [runs[i]["cases"][name]["ms"] for i in (1, 2)]
            entry["parent_ms"] = [runs[i]["cases"][name]["ms"]
                                  for i in (0, 3)]
        table["cases"][name] = entry
        times = ("" if "ms" not in res else
                 f"; ms this {entry['ms'][0]:.4f} / {entry['ms'][1]:.4f}, "
                 f"parent {entry['parent_ms'][0]:.4f} / "
                 f"{entry['parent_ms'][1]:.4f}")
        unit = "bytes"
        if "max_abs_to_plain" in res:
            unit = "floats"
            times = (f"; sign-of-zero only {res['signed_zeros_to_parent']}"
                     f", max |d| to plain {res['max_abs_to_plain']:.3g}"
                     + times)
        print(f"{name:34s} {unit} unequal to parent "
              f"{res['unequal_to_parent']}, to plain "
              f"{res['unequal_to_plain']} (parent "
              f"{entry['parent_unequal_to_plain']})" + times, flush=True)
    print(gpu)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tail_ab.json"), "w") as f:
        json.dump(table, f, indent=1)
    bad = [n for n, e in table["cases"].items()
           if e["unequal_to_parent"] and not n.startswith("int8")]
    # int8_conv: the bar against plain (phase 2's), not identity.
    bad += [n for n, e in table["cases"].items() if n.startswith("int8")
            and (e["max_lsb_to_plain"] > 1
                 or e["unequal_to_plain"] >= 1e-3 * e["values"])]
    if bad:
        print(f"outputs differ from the parent's, or int8_conv's from "
              f"plain beyond its bar: {bad}")
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tail", nargs="?", const="", metavar="PREFIX",
                    help="knock out parts of the tail kernels in place of "
                    "the planar kernels (only the knockouts whose name "
                    "starts with PREFIX, e.g. 'float:')")
    ap.add_argument("--parent", help="compare the tail kernels with the "
                    "vidmat_torch/ package in this directory")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("planar_knockouts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    gpu = cs.gpu_line()
    rc = 0
    if args.parent:
        rc = tail_ab(args.parent, gpu)
    if args.tail is not None:
        rc = tail_main(gpu, args.tail) or rc
    if not args.parent and args.tail is None:
        rc = planar_main(gpu)
    return rc


if __name__ == "__main__":
    sys.exit(main())
