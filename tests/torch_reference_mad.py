"""Reference alpha MADs of the JAX package on the clips chip_smoke.py
converts, run on the CPU with the net as XLA convolutions (parity-pinned
to the planar path). chip_smoke.py holds the port's MAD on the card to
these numbers.

  video_1080p  64 synthetic 1920x1080 frames (seed 0), fast_demo, bf16,
               ratio 0.25, guided (chip_smoke.py's main path)
  clip_480p    100 synthetic 480x864 frames (seed 0), synthetic_demo,
               bf16, full resolution, no refinement (its clip_480p phase)
  plate_1080p  16 frames of the 1920x1080 camouflage clean-plate clip
               (synthetic_plate_clip, seed 0) with its true plate,
               plate_demo, bf16, ratio 0.25, guided (its phase B, path e)
  errormap_1080p  16 frames of the 1920x1088 hard clip (synthetic_hard_clip,
               seed 0), synthetic_demo, bf16, ratio 0.25, error-map
               refinement with errormap_demo (256 patches of 16): the alpha
               MAD and the unknown-band MAD (alpha_to_trimap of the ground
               truth) (its phase E)

    python tests/torch_reference_mad.py [video_1080p|clip_480p|plate_1080p|
                                         errormap_1080p]
        (video_1080p, the default: about two minutes on 8 cores)
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vidmat.config import ModelConfig, RefineConfig  # noqa: E402
from vidmat.io.fixtures import (synthetic_clip,  # noqa: E402
                                synthetic_hard_clip, synthetic_plate_clip)
from vidmat.models.matting_net import MattingNetwork  # noqa: E402
from vidmat.models.weights import default_variables  # noqa: E402
from vidmat.pipeline.stepfactory import build_serving_body  # noqa: E402

#: clip -> (model config, refine mode, bucket, ratio, frames (h, w), count)
CLIPS = {
    "video_1080p": (ModelConfig(space_to_depth=2), "guided", (1088, 1920),
                    0.25, (1080, 1920), 64),
    "clip_480p": (ModelConfig(), "none", (480, 864), 1.0, (480, 864), 100),
    "plate_1080p": (ModelConfig(use_bg_plate=True, space_to_depth=2),
                    "guided", (1088, 1920), 0.25, (1080, 1920), 16),
    "errormap_1080p": (ModelConfig(), "errormap", (1088, 1920), 0.25,
                       (1088, 1920), 16),
}


def _pad(img, bh, bw):
    fh, fw = img.shape[:2]
    return np.pad(img, ((0, bh - fh), (0, bw - fw), (0, 0)), mode="edge")


def main(name: str = "video_1080p") -> None:
    cfg, mode, (bh, bw), ratio, (fh, fw), count = CLIPS[name]
    variables = default_variables(cfg)
    if cfg.use_bg_plate:
        clip = [(f, a) for f, a, _ in synthetic_plate_clip(fh, fw, count,
                                                           seed=0)]
        plate = next(synthetic_plate_clip(fh, fw, 1, seed=0))[2]
        extra = dict(bg_plate=jnp.asarray(_pad(plate, bh, bw)))
    elif mode == "errormap":
        from vidmat.pipeline.video import _load_default_refiner
        from vidmat.refine.errormap import ErrorMapRefiner

        clip = synthetic_hard_clip(fh, fw, count, seed=0)
        refiner = ErrorMapRefiner(num_patches=256, patch_size=16)
        extra = dict(refiner=(refiner, _load_default_refiner(
            refiner, bh, bw, bh // 4, bw // 4)))
    else:
        clip = synthetic_clip(fh, fw, count, seed=0)
        extra = {}
    body, plan = build_serving_body(
        MattingNetwork(cfg, dtype=jnp.bfloat16), cfg, RefineConfig(mode),
        bh, bw, ratio, use_pallas=False, **extra)
    step = jax.jit(body)
    state = plan.make_state(1)
    mads, unk = [], []
    for frame, gt in clip:
        padded = _pad(frame, bh, bw)[None]
        outs, state = step(variables, jnp.asarray(padded), state)
        alpha = np.asarray(outs[0])[0, :fh, :fw, 0] / 255.0
        d = np.abs(alpha - gt[..., 0])
        mads.append(float(d.mean()))
        if mode == "errormap":
            from vidmat.train.data import alpha_to_trimap

            unk.append(float(d[alpha_to_trimap(gt[..., 0])[..., 0]
                               == 0.5].mean()))
    print("per-frame", np.round(mads, 4).tolist())
    print(f"JAX reference alpha MAD over {count} frames ({name}): "
          f"{np.mean(mads):.5f}")
    if unk:
        print(f"JAX reference unknown-band alpha MAD ({name}): "
              f"{np.mean(unk):.5f}")


if __name__ == "__main__":
    main(*sys.argv[1:])
