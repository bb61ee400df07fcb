"""Command-line interface of the port (counterpart of vidmat/cli.py).

Usage:
  python -m vidmat_torch.cli video  IN.mp4 --output-alpha a.mp4 \
      --output-composition c.mp4 [--preset video_1080p] [--device cuda]
  python -m vidmat_torch.cli image  IN.png --trimap T.png --output-alpha a.png
  python -m vidmat_torch.cli bench  [--quick]
  python -m vidmat_torch.cli export bundle/ --height 1088 --width 1920 \
      --preset video_1080p --chunk 4
  python -m vidmat_torch.cli bundle-video bundle/ IN.mp4 --output-alpha a.mp4
  python -m vidmat_torch.cli evaluate pred/ true/ [--metrics mad,grad,conn]
  python -m vidmat_torch.cli train --steps 200 --out ckpt.npz

The nine subcommands take the JAX package's options, defaults and
choices, plus ``--device`` (``cuda``, the default, or ``cpu``).
``--checkpoint`` reads the port's ``.npz`` checkpoints (an orbax
directory raises naming its converter, ``jax_checkpoint_to_npz.py`` at
the repo root), and ``train`` writes one (``.npz`` appended to
``--out`` when missing). ``multistream --pp`` serves each stream in two
pipelined stages over two positions (``PipelinedStreams``): two visible
cards per stream with ``--device cuda`` (fewer exit with the JAX
package's message), CPU positions with ``--device cpu``;
``--pallas-interpret`` is accepted and changes nothing, as in
``MultiStreamMatting``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_device(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (cuda) or the CPU (the plain "
                        "PyTorch versions of the kernels)")


def _load_checkpoint(path):
    """The port's checkpoint at ``path`` (an .npz of the JAX package's
    variables, as ``vidmat_torch/checkpoints/`` holds them), or None. A
    directory (an orbax checkpoint of the JAX package) raises naming its
    converter, ``jax_checkpoint_to_npz.py`` (``models.weights``
    ``load_checkpoint``)."""
    if not path:
        return None
    from vidmat_torch.models.weights import load_checkpoint

    return load_checkpoint(path)


def _add_video(sub):
    p = sub.add_parser("video", help="video in -> alpha/fgr/composite out")
    p.add_argument("input")
    p.add_argument("--output-alpha")
    p.add_argument("--output-foreground")
    p.add_argument("--output-composition")
    p.add_argument("--output-segmentation", metavar="PATH",
                   help="write the co-trained SEGMENTATION head's mask "
                        "stream instead of matting outputs (RVM-lineage "
                        "downstream/debug output; needs a co-trained "
                        "checkpoint — the shipped seg_demo by default); "
                        "mutually exclusive with the matting outputs")
    p.add_argument("--bg-color", default="0,1,0",
                   help="composite background R,G,B in [0,1]")
    p.add_argument("--bg-image", default=None,
                   help="background replacement image path (overrides "
                        "--bg-color for the composition output)")
    p.add_argument("--bg-video", default=None,
                   help="per-frame background replacement video path, "
                        "looped if shorter than the input (overrides "
                        "--bg-image)")
    p.add_argument("--bg-blur", type=int, default=None, metavar="RADIUS",
                   help="portrait mode: composite over a blur of the "
                        "source frame (radius in full-res pixels, e.g. "
                        "16; overrides every other --bg-* option)")
    p.add_argument("--bg-plate", default=None, metavar="IMAGE",
                   help="clean-plate CONDITIONING (BGMv2 lineage): a "
                        "pre-captured image of the scene WITHOUT the "
                        "subject — a network input that disambiguates "
                        "camouflaged subjects, not the composite "
                        "background (combine with --bg-* as usual); "
                        "selects the plate-conditioned model family")
    p.add_argument("--downsample-ratio", type=float, default=None)
    p.add_argument("--tile-size", type=int, default=None, metavar="PX",
                   help="tiled full-res refine (the 4K rung): guided-"
                        "filter stats per PX-sized coarse tile, feather-"
                        "blended coefficient grids (e.g. 1024)")
    p.add_argument("--tile-overlap", type=int, default=None, metavar="PX",
                   help="tile overlap for --tile-size (default 128)")
    p.add_argument("--static-skip-eps", type=float, default=None,
                   metavar="EPS",
                   help="static-scene fast path: skip the net when the "
                        "coarse frame's mean abs delta <= EPS in [0,1] "
                        "units (e.g. 0.002); ~2x on static content")
    p.add_argument("--preset", choices=["clip_480p", "video_1080p",
                                        "video_1080p_errormap",
                                        "video_4k"], default=None)
    p.add_argument("--checkpoint",
                   help="port checkpoint (.npz; an orbax directory of the "
                        "JAX package raises: convert it with "
                        "jax_checkpoint_to_npz.py)")
    p.add_argument("--trimap", default=None, metavar="SOURCE",
                   help="trimap-conditioned matting: a per-frame trimap "
                        "stream (video / PNG dir or pattern), or a "
                        "SINGLE image = keyframe propagation (the "
                        "recurrent state carries the frame-0 annotation "
                        "forward); values {0,128,255} = bg/unknown/fg")
    p.add_argument("--mask", default=None, metavar="SOURCE",
                   help="like --trimap but with ROUGH binary segmentation "
                        "masks (converted on the fly: unknown band "
                        "straddles the mask boundary); a single image = "
                        "keyframe propagation, a stream = per-frame")
    p.add_argument("--mask-band", type=float, default=0.04,
                   help="unknown-band half-width for --mask (fraction of "
                        "the short side, or pixels if >=1)")
    p.add_argument("--start-frame", type=int, default=0,
                   help="skip the first N input frames (exact "
                        "sequential skip)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="convert at most N frames")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace the run with torch.profiler (a Chrome "
                        "trace) when N > 0")
    p.add_argument("--progress", action="store_true")
    _add_device(p)


def _add_image(sub):
    p = sub.add_parser("image", help="single-image matting")
    p.add_argument("input",
                   help="an image file, or a BATCH: a directory / glob "
                        "of images (then --output-alpha/--output-"
                        "foreground name directories; each output keeps "
                        "its source filename as PNG)")
    p.add_argument("--trimap")
    p.add_argument("--mask", help="rough binary segmentation mask image "
                                  "(converted to a trimap on the fly)")
    p.add_argument("--bg-plate", default=None, metavar="IMAGE",
                   help="clean background plate (scene without the "
                        "subject) — plate-conditioned matting; in batch "
                        "mode the one plate applies to every image "
                        "(same scene)")
    p.add_argument("--output-alpha", required=True)
    p.add_argument("--output-foreground")
    p.add_argument("--checkpoint")
    _add_device(p)


def _add_bench(sub):
    p = sub.add_parser("bench", help="run the throughput benchmark")
    p.add_argument("--quick", action="store_true")
    _add_device(p)


def _add_multistream(sub):
    p = sub.add_parser("multistream",
                       help="matte N videos concurrently")
    p.add_argument("inputs", nargs="+", help="video files (one per stream)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--downsample-ratio", type=float, default=None,
                   help="coarse-pass ratio (default: the preset's when "
                        "--preset is given, else 0.25)")
    p.add_argument("--checkpoint")
    p.add_argument("--preset", choices=["multistream"], default=None,
                   help="use the multistream ladder preset (planar conv "
                        "path, one card)")
    p.add_argument("--height", type=int, default=1088)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--chunk", type=int, default=1,
                   help="frames per stream per dispatch (throughput mode: "
                        "K>1 amortizes dispatch overhead at K-frame "
                        "output latency)")
    p.add_argument("--bg-blur", type=int, default=None, metavar="RADIUS",
                   help="portrait mode: also write composition_NN.mp4 per "
                        "stream, compositing over a blur of that stream's "
                        "own frames (radius in full-res pixels)")
    p.add_argument("--pp", action="store_true",
                   help="serve each stream 2-stage pipeline-parallel "
                        "(coarse net | fused refine+composite) over a "
                        "('stream', 'pp') mesh of 2N positions: the "
                        "visible cards with --device cuda, 2N CPU "
                        "positions with --device cpu (parallel/pp.py)")
    p.add_argument("--pallas-interpret", action="store_true",
                   help="accepted for the JAX package's command lines; "
                        "changes nothing (the port's kernels are CUDA)")
    _add_device(p)


def _add_export(sub):
    p = sub.add_parser(
        "export",
        help="export an AOT serving bundle (torch.export; "
             "platform-pinned)")
    p.add_argument("out_dir")
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--preset", choices=["clip_480p", "video_1080p",
                                        "video_1080p_errormap",
                                        "video_4k"], default=None)
    p.add_argument("--checkpoint", help="port checkpoint (.npz; default: "
                                        "the shipped weights for the config)")
    p.add_argument("--downsample-ratio", type=float, default=None)
    p.add_argument("--bg-color", default="0,1,0",
                   help="baked composite background R,G,B in [0,1]")
    p.add_argument("--bg-image", default=None,
                   help="baked background replacement image path")
    p.add_argument("--bg-blur", type=int, default=None, metavar="RADIUS",
                   help="portrait mode: the bundle composites over a blur "
                        "of the source frame (radius in full-res pixels; "
                        "overrides --bg-color/--bg-image)")
    p.add_argument("--bg-plate", default=None, metavar="IMAGE",
                   help="clean-plate conditioning: bake this pre-captured "
                        "background plate into the bundle (selects the "
                        "plate-conditioned model family; one bundle per "
                        "camera setup)")
    p.add_argument("--alpha-only", action="store_true",
                   help="bundle emits only the uint8 alpha plane "
                        "(4x smaller per-frame readback)")
    p.add_argument("--raw-foreground", action="store_true",
                   help="bundle emits raw (uncomposited) foreground")
    p.add_argument("--chunk", type=int, default=None,
                   help="also export a K-frame chunk-batched step "
                        "(offline-conversion throughput mode)")
    _add_device(p)


def _add_bundle_video(sub):
    p = sub.add_parser(
        "bundle-video",
        help="convert a video using an exported AOT bundle (no tracing)")
    p.add_argument("bundle",
                   help="bundle directory from `vidmat-torch export`")
    p.add_argument("input")
    p.add_argument("--output-alpha")
    p.add_argument("--output-foreground")
    p.add_argument("--output-composition")
    p.add_argument("--progress", action="store_true")
    _add_device(p)


def _add_train(sub):
    p = sub.add_parser(
        "train", help="train on synthetic clips, or a directory-format "
        "dataset (--fgr-dir/--pha-dir)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--out", default="checkpoints/demo")
    p.add_argument("--clip-len", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--fgr-dir", help="foreground clip dirs "
                   "(VideoMatte-style layout; requires --pha-dir)")
    p.add_argument("--pha-dir", help="alpha clip dirs matching --fgr-dir")
    p.add_argument("--bg-dir", help="background stills for on-the-fly "
                   "compositing (default: solid random colors)")
    p.add_argument("--seg-every", type=int, default=0, metavar="K",
                   help="segmentation co-training: every K-th step trains "
                        "the shared trunk + seg head on a binary-mask "
                        "batch (RVM-lineage interleave; 0 = off)")
    _add_device(p)


def _add_live(sub):
    p = sub.add_parser(
        "live",
        help="real-time matting with latest-wins frame dropping "
             "(camera index or file simulated as a live feed)")
    p.add_argument("source", help="camera index (e.g. 0) or video path / "
                                  "image-sequence dir")
    p.add_argument("--height", type=int, default=None,
                   help="serving height (default: probe the source; "
                        "rounded to /16)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--output-alpha")
    p.add_argument("--output-composition")
    p.add_argument("--bg-color", default="0,1,0")
    p.add_argument("--pace-fps", type=float, default=None,
                   help="producer pacing for file sources (default: the "
                        "file's native fps; cameras are naturally paced)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--downsample-ratio", type=float, default=None)
    p.add_argument("--checkpoint")
    p.add_argument("--static-skip-eps", type=float, default=None,
                   help="static-scene fast path (see `video`)")
    p.add_argument("--bg-plate", default=None, metavar="IMAGE",
                   help="clean-plate conditioning (a fixed camera setup "
                        "is exactly the case a pre-captured plate fits); "
                        "selects the plate-conditioned model family")
    _add_device(p)


def _add_evaluate(sub):
    p = sub.add_parser(
        "evaluate",
        help="score a predicted alpha sequence against ground truth "
             "(MAD/MSE/SAD/Grad/Conn/dtSSD, literature units)")
    p.add_argument("pred", help="predicted alpha: video file, image dir, "
                                "printf pattern, or glob")
    p.add_argument("true", help="ground-truth alpha (same source forms)")
    p.add_argument("--metrics", default="mad,mse,sad,grad,dtssd",
                   help="comma list from mad,mse,sad,grad,conn,dtssd "
                        "(conn is the host connected-component sweep; "
                        "slow on long clips)")
    p.add_argument("--trimap", help="trimap sequence (same source forms): "
                                    "restricts the alpha metrics to the "
                                    "trimap UNKNOWN band per frame — the "
                                    "standard trimap-restricted benchmark "
                                    "protocol")
    p.add_argument("--pred-fgr", help="predicted foreground sequence: "
                                      "adds the fgr_mse metric (alpha>0 "
                                      "region; requires --true-fgr)")
    p.add_argument("--true-fgr", help="ground-truth foreground sequence")
    p.add_argument("--per-frame", action="store_true",
                   help="include the per-frame rows in the JSON")
    p.add_argument("--output", help="write the JSON report here as well")
    _add_device(p)


def _pp_devices(device: str, s: int):
    """The 2s positions of ``multistream --pp``: the first 2s visible
    cards with --device cuda (fewer exit with the JAX package's message),
    2s CPU positions with --device cpu."""
    if device == "cpu":
        return ["cpu"] * (2 * s)
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2 * s:
        raise SystemExit(
            f"--pp needs 2 devices per stream ({2 * s} for {s} "
            f"streams); {n} visible")
    return [f"cuda:{i}" for i in range(2 * s)]


def _run_multistream_pp(args, readers, padded, variables, h, w,
                        ms_cfg) -> int:
    """``multistream --pp``: N streams x 2 stages over a ('stream', 'pp')
    mesh of 2N positions (the visible cards with --device cuda, 2N CPU
    positions with --device cpu), driven through
    ``PipelinedStreams.convert`` (which hides the one-round skew).
    Streams that end early are padded with their last frame on the feed
    side; their outputs stop being written (vidmat/cli.py:272-346)."""
    import numpy as np

    from vidmat_torch.io.writer import VideoWriter
    from vidmat_torch.parallel.mesh import make_mesh
    from vidmat_torch.parallel.pp import PipelinedStreams

    s = len(readers)
    mesh = make_mesh(("stream", "pp"), (s, 2),
                     devices=_pp_devices(args.device, s))
    pps = PipelinedStreams(s, h, w, mesh, variables=variables,
                           chunk=args.chunk, bg_blur=args.bg_blur,
                           pallas_interpret=args.pallas_interpret,
                           **ms_cfg)
    its = [padded(r) for r in readers]
    alive = [True] * s
    last = [np.zeros((h, w, pps.in_c), np.uint8)] * s
    alive_hist: list = []

    def rounds():
        while True:
            batch = []
            any_alive = False
            for i, it in enumerate(its):
                if alive[i]:
                    try:
                        last[i] = next(it)
                        any_alive = True
                    except StopIteration:
                        alive[i] = False
                batch.append(last[i])
            if not any_alive:
                return
            alive_hist.append(list(alive))
            yield np.stack(batch)

    os.makedirs(args.output_dir, exist_ok=True)
    writers = [VideoWriter(os.path.join(args.output_dir,
                                        f"alpha_{i:02d}.mp4"),
                           readers[i].fps) for i in range(s)]
    comp_writers = ([VideoWriter(os.path.join(args.output_dir,
                                              f"composition_{i:02d}.mp4"),
                                 readers[i].fps) for i in range(s)]
                    if args.bg_blur else [])
    crops = [(min(r.height, args.height), min(r.width, args.width))
             for r in readers]
    frames_out = [0] * s
    for k, (alpha, rgba) in enumerate(pps.convert(rounds())):
        for i in range(s):
            if not alive_hist[k][i]:
                continue
            ch, cw = crops[i]
            writers[i].write(alpha[i, :ch, :cw])
            if comp_writers:
                comp_writers[i].write(rgba[i, :ch, :cw, :3])
            frames_out[i] += 1
    for wr in writers + comp_writers:
        wr.close()
    print(json.dumps({"streams": s, "mesh": {"stream": s, "pp": 2},
                      "frames": frames_out}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vidmat-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_video(sub)
    _add_image(sub)
    _add_bench(sub)
    _add_multistream(sub)
    _add_export(sub)
    _add_bundle_video(sub)
    _add_train(sub)
    _add_live(sub)
    _add_evaluate(sub)
    args = parser.parse_args(argv)

    if args.cmd == "video":
        import dataclasses

        from vidmat_torch.api import convert_video
        from vidmat_torch.config import PRESETS, PipelineConfig
        from vidmat_torch.utils.profiling import maybe_profile

        model_cfg = pipe_cfg = None
        if args.preset:
            model_cfg, pipe_cfg = PRESETS[args.preset]()
        if args.bg_plate and model_cfg is not None \
                and not model_cfg.use_bg_plate:
            # Plate conditioning is a model axis: the preset's config in
            # the plate family, the same serving geometry (a bare
            # --bg-plate is selected by convert_video).
            model_cfg = dataclasses.replace(model_cfg, use_bg_plate=True)
        overrides = {}
        if args.static_skip_eps is not None:
            overrides["static_skip_eps"] = args.static_skip_eps
        if args.tile_size is not None:
            overrides["tile_size"] = args.tile_size
        if args.tile_overlap is not None:
            overrides["tile_overlap"] = args.tile_overlap
        if overrides:
            pipe_cfg = dataclasses.replace(pipe_cfg or PipelineConfig(),
                                           **overrides)
        variables = _load_checkpoint(args.checkpoint)
        bg = tuple(float(x) for x in args.bg_color.split(","))
        with maybe_profile(args.profile):
            metrics = convert_video(
                args.input, output_alpha=args.output_alpha,
                output_foreground=args.output_foreground,
                output_composition=args.output_composition,
                bg_color=bg, bg_image=args.bg_image,
                bg_video=args.bg_video, bg_blur=args.bg_blur,
                bg_plate=args.bg_plate,
                downsample_ratio=args.downsample_ratio,
                variables=variables, model_cfg=model_cfg,
                pipe_cfg=pipe_cfg, progress=args.progress,
                start_frame=args.start_frame, max_frames=args.max_frames,
                trimap_source=args.trimap, mask_source=args.mask,
                mask_band=(int(args.mask_band) if args.mask_band >= 1
                           else args.mask_band),
                output_segmentation=args.output_segmentation,
                device=args.device)
        print(json.dumps(metrics))
        return 0

    if args.cmd == "image":
        import glob as _glob

        import numpy as np

        from vidmat_torch.api import matte_image
        from vidmat_torch.io.reader import _IMG_EXTS, read_image
        from vidmat_torch.io.writer import write_image

        variables = _load_checkpoint(args.checkpoint)
        if os.path.isdir(args.input) or any(c in args.input for c in "*?["):
            # Batch mode: a directory or glob of images, matted
            # independently (no temporal state); outputs keep the source
            # file name (as .png) under the output directories.
            if args.trimap or args.mask:
                print("batch image mode does not take --trimap/--mask "
                      "(per-image annotations have no pairing rule); "
                      "use the video subcommand with PNG sequences",
                      file=sys.stderr)
                return 2
            if os.path.isdir(args.input):
                files = sorted(
                    os.path.join(args.input, f)
                    for f in os.listdir(args.input)
                    if os.path.splitext(f)[1].lower() in _IMG_EXTS)
            else:
                files = sorted(_glob.glob(args.input))
            if not files:
                print(f"no images match {args.input!r}", file=sys.stderr)
                return 2
            os.makedirs(args.output_alpha, exist_ok=True)
            if args.output_foreground:
                os.makedirs(args.output_foreground, exist_ok=True)
            # One stepper for the batch; the configuration as
            # matte_image's no-trimap branch picks it.
            from vidmat_torch.config import ModelConfig
            from vidmat_torch.pipeline.stepper import ImageStepper

            plate = read_image(args.bg_plate) if args.bg_plate else None
            if plate is not None:
                from vidmat_torch.models.weights import plate_default_config

                cfg = plate_default_config()
            else:
                cfg = (ModelConfig() if variables is None
                       else ModelConfig(recurrent=False))
            stepper = ImageStepper(cfg, variables=variables,
                                   device=args.device)
            for f in files:
                alpha, fgr = stepper(read_image(f), bg_plate=plate)
                stem = os.path.splitext(os.path.basename(f))[0] + ".png"
                write_image(os.path.join(args.output_alpha, stem), alpha)
                if args.output_foreground:
                    write_image(
                        os.path.join(args.output_foreground, stem), fgr)
            print(json.dumps({"images": len(files)}))
            return 0

        image = read_image(args.input)
        trimap = read_image(args.trimap) if args.trimap else None
        if trimap is not None and trimap.dtype == np.uint8:
            trimap = trimap.astype(np.float32) / 255.0
        mask = read_image(args.mask) if args.mask else None
        plate = read_image(args.bg_plate) if args.bg_plate else None
        alpha, fgr = matte_image(image, trimap, variables=variables,
                                 mask=mask, bg_plate=plate,
                                 device=args.device)
        write_image(args.output_alpha, alpha)
        if args.output_foreground:
            write_image(args.output_foreground, fgr)
        return 0

    if args.cmd == "bench":
        import bench_torch

        return bench_torch.main(["--device", args.device]
                                + (["--quick"] if args.quick else []))

    if args.cmd == "multistream":
        from vidmat_torch.io.reader import VideoReader
        from vidmat_torch.io.writer import VideoWriter
        from vidmat_torch.parallel.multistream import MultiStreamMatting
        from vidmat_torch.pipeline.stepper import pad_to_multiple

        if args.pp:
            # The positions first: without them nothing is read.
            _pp_devices(args.device, len(args.inputs))
        variables = _load_checkpoint(args.checkpoint)
        readers = [VideoReader(p) for p in args.inputs]
        h = args.height + ((-args.height) % 16)
        w = args.width + ((-args.width) % 16)

        def padded(reader):
            for f in reader:
                yield pad_to_multiple(
                    f[:args.height, :args.width], 16)[0]

        ms_cfg = {}
        if args.preset:
            from vidmat_torch.config import PRESETS

            mcfg, pcfg, _ = PRESETS[args.preset]()
            ms_cfg = dict(cfg=mcfg,
                          downsample_ratio=pcfg.downsample_ratio,
                          refine=pcfg.refine)
        # An explicit --downsample-ratio wins; the preset's applies only
        # when the flag is unset.
        if args.downsample_ratio is not None:
            ms_cfg["downsample_ratio"] = args.downsample_ratio
        else:
            ms_cfg.setdefault("downsample_ratio", 0.25)
        if args.pp:
            return _run_multistream_pp(args, readers, padded, variables,
                                       h, w, ms_cfg)
        ms = MultiStreamMatting(len(readers), h, w, variables=variables,
                                chunk=args.chunk, bg_blur=args.bg_blur,
                                pallas_interpret=args.pallas_interpret,
                                device=args.device, **ms_cfg)
        os.makedirs(args.output_dir, exist_ok=True)
        writers = [VideoWriter(os.path.join(args.output_dir,
                                            f"alpha_{i:02d}.mp4"),
                               readers[i].fps)
                   for i in range(len(readers))]
        # Portrait mode: the step's second output is each stream's
        # composition over a blur of its own frames.
        comp_writers = ([VideoWriter(os.path.join(args.output_dir,
                                                  f"composition_{i:02d}.mp4"),
                                     readers[i].fps)
                         for i in range(len(readers))]
                        if args.bg_blur else [])
        # Each stream cropped to its own frame size (the bucket's edge
        # padding is not written).
        crops = [(min(r.height, args.height), min(r.width, args.width))
                 for r in readers]

        def on_output(i, n, alpha, out):
            ch, cw = crops[i]
            writers[i].write(alpha[:ch, :cw])
            if comp_writers:
                comp_writers[i].write(out[:ch, :cw])

        summary = ms.serve([padded(r) for r in readers],
                           on_output=on_output)
        for wr in writers + comp_writers:
            wr.close()
        print(json.dumps(summary))
        return 0

    if args.cmd == "export":
        import dataclasses

        from vidmat_torch.config import PRESETS, PipelineConfig
        from vidmat_torch.deploy import export_bundle

        model_cfg = pipe_cfg = None
        if args.preset:
            model_cfg, pipe_cfg = PRESETS[args.preset]()
        if args.bg_plate and (model_cfg is None
                              or not model_cfg.use_bg_plate):
            # Plate conditioning is a model axis: the (preset's) config in
            # the plate family, the same serving geometry.
            from vidmat_torch.models.weights import plate_default_config

            model_cfg = dataclasses.replace(
                model_cfg or dataclasses.replace(plate_default_config(),
                                                 conv_impl="planar"),
                use_bg_plate=True)
        if args.chunk is not None:
            pipe_cfg = dataclasses.replace(pipe_cfg or PipelineConfig(),
                                           chunk_size=args.chunk)
        variables = _load_checkpoint(args.checkpoint)
        bg = tuple(float(x) for x in args.bg_color.split(","))
        path = export_bundle(
            args.out_dir, args.height, args.width, model_cfg=model_cfg,
            pipe_cfg=pipe_cfg, variables=variables,
            downsample_ratio=args.downsample_ratio,
            bg_color=None if args.raw_foreground else bg,
            bg_image=args.bg_image, bg_blur=args.bg_blur,
            bg_plate=args.bg_plate,
            alpha_only=args.alpha_only,
            need_fgr=args.raw_foreground, device=args.device)
        with open(f"{path}/manifest.json") as f:
            print(f.read())
        return 0

    if args.cmd == "bundle-video":
        from vidmat_torch.deploy import ServingBundle

        bundle = ServingBundle(args.bundle, device=args.device)
        metrics = bundle.convert(
            args.input, output_alpha=args.output_alpha,
            output_foreground=args.output_foreground,
            output_composition=args.output_composition,
            progress=args.progress)
        print(json.dumps(metrics))
        return 0

    if args.cmd == "train":
        from vidmat_torch.config import ModelConfig
        from vidmat_torch.models.weights import save_checkpoint
        from vidmat_torch.train.loop import train_on_clips

        if (args.fgr_dir is None) != (args.pha_dir is None):
            raise SystemExit("--fgr-dir and --pha-dir go together")
        if args.fgr_dir:
            from vidmat_torch.train.dataset import ClipDirDataset

            data = ClipDirDataset(
                args.fgr_dir, args.pha_dir, bgr_root=args.bg_dir,
                clip_len=args.clip_len, batch=args.batch,
                size=args.size).batches()
        else:
            from vidmat_torch.train.data import synthetic_clip_batches

            data = synthetic_clip_batches(t=args.clip_len, n=args.batch,
                                          h=args.size, w=args.size)
        cfg = ModelConfig()
        seg_data = None
        if args.seg_every > 0:
            if args.fgr_dir:
                # The directory dataset doubles as segmentation
                # supervision (alpha binarized), from a sampler of its own.
                from vidmat_torch.train.dataset import (ClipDirDataset,
                                                        as_seg_batches)

                seg_data = as_seg_batches(ClipDirDataset(
                    args.fgr_dir, args.pha_dir, bgr_root=args.bg_dir,
                    clip_len=args.clip_len, batch=args.batch,
                    size=args.size, seed=17).batches())
            else:
                from vidmat_torch.train.data import synthetic_seg_batches

                seg_data = synthetic_seg_batches(
                    t=args.clip_len, n=args.batch, h=args.size,
                    w=args.size, seed=17)
        state = train_on_clips(cfg, data, num_steps=args.steps, lr=args.lr,
                               seg_data_iter=seg_data,
                               seg_every=args.seg_every, device=args.device)
        path = save_checkpoint(args.out, state.variables)
        print(f"saved checkpoint to {path}")
        return 0

    if args.cmd == "live":
        from vidmat_torch.pipeline.realtime import RealtimeMatting
        from vidmat_torch.pipeline.video import auto_downsample_ratio

        src = args.source
        h, w, fps, pace = args.height, args.width, None, args.pace_fps
        if src.isdigit():
            from vidmat_torch.io.reader import require_cv2

            cv2 = require_cv2(f"the camera {src}")
            cap = cv2.VideoCapture(int(src))
            if cap.isOpened():
                h = h or int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or None
                w = w or int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or None
                fps = cap.get(cv2.CAP_PROP_FPS) or None
            cap.release()
        else:
            from vidmat_torch.io.reader import VideoReader, image_sequence

            seq = image_sequence(src)
            if seq is not None:
                first = next(seq, None)
                if first is not None:
                    h = h or first.shape[0]
                    w = w or first.shape[1]
            else:
                r = VideoReader(src)
                h, w, fps = h or r.height, w or r.width, r.fps
                r.close()
            if pace is None:
                pace = fps or 30.0  # files must be paced to act live
        if not h or not w:
            print("error: could not probe the source size; pass "
                  "--height/--width", file=sys.stderr)
            return 1
        variables = _load_checkpoint(args.checkpoint)
        ratio = (args.downsample_ratio if args.downsample_ratio
                 is not None else auto_downsample_ratio(h, w))
        plate = None
        if args.bg_plate:
            from vidmat_torch.io.reader import read_image

            plate = read_image(args.bg_plate)
        rt = RealtimeMatting(
            h, w, variables=variables, downsample_ratio=ratio,
            static_skip_eps=args.static_skip_eps,
            bg_color=tuple(float(x) for x in args.bg_color.split(",")),
            bg_plate=plate, device=args.device)
        stats = rt.run(src, output_alpha=args.output_alpha,
                       output_composition=args.output_composition,
                       pace_fps=pace, max_frames=args.max_frames,
                       fps_hint=fps or pace or 30.0)
        print(json.dumps(stats))
        return 0

    if args.cmd == "evaluate":
        from vidmat_torch.eval import (VideoEval, alpha_frames, rgb_frames,
                                       scale_metric, trimap_unknown_region)

        metrics = tuple(m.strip() for m in args.metrics.split(",")
                        if m.strip())
        if bool(args.pred_fgr) != bool(args.true_fgr):
            print("error: --pred-fgr and --true-fgr must be given together",
                  file=sys.stderr)
            return 1
        if args.pred_fgr and "fgr_mse" not in metrics:
            metrics = metrics + ("fgr_mse",)
        ev = VideoEval(metrics=metrics, device=args.device)
        it_true = alpha_frames(args.true)
        it_pf = rgb_frames(args.pred_fgr) if args.pred_fgr else None
        it_tf = rgb_frames(args.true_fgr) if args.true_fgr else None
        it_tri = alpha_frames(args.trimap) if args.trimap else None
        n = 0
        for pred in alpha_frames(args.pred):
            true = next(it_true, None)
            if true is None:
                print(f"error: true sequence ended at frame {n} while "
                      f"pred continues", file=sys.stderr)
                return 1
            pf = next(it_pf, None) if it_pf is not None else None
            tf = next(it_tf, None) if it_tf is not None else None
            if it_pf is not None and (pf is None or tf is None):
                print(f"error: foreground sequence ended at frame {n}",
                      file=sys.stderr)
                return 1
            region = None
            if it_tri is not None:
                tri = next(it_tri, None)
                if tri is None:
                    print(f"error: trimap sequence ended at frame {n}",
                          file=sys.stderr)
                    return 1
                region = trimap_unknown_region(tri)
            ev.update(pred, true, pred_fgr=pf, true_fgr=tf, region=region)
            n += 1
        if next(it_true, None) is not None:
            print(f"error: pred sequence ended at frame {n} while "
                  f"true continues", file=sys.stderr)
            return 1
        report = ev.summary()
        if args.trimap:
            report["region"] = "trimap-unknown"
        if args.per_frame:
            report["per_frame"] = [
                {k: scale_metric(k, v) for k, v in row.items()}
                for row in ev.frames]
        text = json.dumps(report, indent=2)
        print(text)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text + "\n")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
