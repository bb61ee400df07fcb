"""The ``fast_demo`` held-out gate through the port (the counterpart of
tests/integration/test_quality.py ``test_fast_s2d_checkpoint_quality``):
``MattingSession(160, 160)`` on the s2d=2 model in float32 on the CPU over
the held-out synthetic clip (160x160, 6 frames, seed 987654) mattes within
a mean alpha MAD of 0.0025, and within 1e-5 of the JAX session's MAD on
the same frames."""

import numpy as np

from vidmat_torch.io.fixtures import synthetic_clip
from vidmat_torch.utils.metrics import mad


def test_fast_demo_held_out_gate_through_the_port():
    from vidmat.api import MattingSession as JSession
    from vidmat.config import ModelConfig as JModelConfig

    from vidmat_torch import MattingSession, ModelConfig

    clip = list(synthetic_clip(160, 160, 6, seed=987654))
    sess = MattingSession(160, 160, model_cfg=ModelConfig(space_to_depth=2),
                          device="cpu")
    jsess = JSession(160, 160, model_cfg=JModelConfig(space_to_depth=2))
    port = [mad(sess.step(f)[0], gt) for f, gt in clip]
    ref = [mad(np.asarray(jsess.step(f)[0]), gt) for f, gt in clip]
    assert np.mean(port) < 0.0025, np.mean(port)
    assert abs(np.mean(port) - np.mean(ref)) <= 1e-5, (np.mean(port),
                                                       np.mean(ref))
