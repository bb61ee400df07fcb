"""Reference alpha MAD of the JAX package on the clip chip_smoke.py's
main-path phase converts: 64 synthetic 1920x1080 frames (seed 0), the
video_1080p configuration (fast_demo, bf16, ratio 0.25, guided) with the
net as XLA convolutions, run on the CPU. chip_smoke.py holds the port's
MAD on the card to this number.

    python tests/torch_reference_mad.py     (about two minutes on 8 cores)
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
from vidmat.io.fixtures import synthetic_clip  # noqa: E402
from vidmat.models.matting_net import MattingNetwork  # noqa: E402
from vidmat.models.weights import default_variables  # noqa: E402
from vidmat.pipeline.stepfactory import build_serving_body  # noqa: E402


def main() -> None:
    cfg = ModelConfig(space_to_depth=2)
    variables = default_variables(cfg)
    body, plan = build_serving_body(
        MattingNetwork(cfg, dtype=jnp.bfloat16), cfg, RefineConfig("guided"),
        1088, 1920, 0.25, use_pallas=False)
    step = jax.jit(body)
    state = plan.make_state(1)
    mads = []
    for frame, gt in synthetic_clip(1080, 1920, 64, seed=0):
        padded = np.pad(frame, ((0, 8), (0, 0), (0, 0)), mode="edge")[None]
        outs, state = step(variables, jnp.asarray(padded), state)
        alpha = np.asarray(outs[0])[0, :1080, :, 0] / 255.0
        mads.append(float(np.abs(alpha - gt[..., 0]).mean()))
    print("per-frame", np.round(mads, 4).tolist())
    print(f"JAX reference alpha MAD over 64 frames: {np.mean(mads):.5f}")


if __name__ == "__main__":
    main()
