"""Jobs of several processes (the counterpart of
tests/integration/test_multihost.py:40, 72).

Two worker processes with 2 CPU positions each join over gloo on
localhost (``initialize_distributed``) and build one global mesh of 4
positions:

- one sharded train step on the ('data',) mesh, each process with its
  own rows of the batch (tests/torch_multihost_worker.py): both
  processes' losses are equal bit for bit, their updated parameters
  equal byte for byte, and the loss is within 2e-5 of the one-process
  unsharded step on the whole batch;
- ``MultiStreamMatting(mesh=)`` on a ('stream',) mesh serves each
  process's streams, equal byte for byte to a one-process instance
  (tests/torch_multihost_serve_worker.py, which asserts it).

The workers see no card (``CUDA_VISIBLE_DEVICES=""``).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(script, nproc=2):
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, script), str(i), str(nproc),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, text=True) for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                pytest.fail(f"{script} timed out")
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_sharded_train_step():
    import torch  # noqa: F401

    sys.path.insert(0, HERE)
    from torch_multihost_worker import local_batch

    from vidmat_torch.config import ModelConfig
    from vidmat_torch.models.weights import init_params
    from vidmat_torch.train.loop import (TrainState, make_optimizer,
                                         make_train_step)

    outs = _run_workers("torch_multihost_worker.py")
    assert [o["pid"] for o in outs] == [0, 1]
    assert all(o["devices"] == 4 for o in outs)
    # The replicated loss and the one optimizer step: identical.
    assert outs[0]["loss"] == outs[1]["loss"], outs
    assert outs[0]["params"] == outs[1]["params"], outs

    parts = [local_batch(pid, 2) for pid in range(2)]
    batch = [np.concatenate(xs, axis=1) for xs in zip(*parts)]
    cfg = ModelConfig()
    variables = init_params(cfg, seed=0)
    opt = make_optimizer()
    _, m = make_train_step(cfg, opt, device="cpu")(
        TrainState(variables=variables,
                   opt_state=opt.init(variables["params"])), *batch)
    np.testing.assert_allclose(outs[0]["loss"], float(m["loss"]),
                               rtol=2e-5)


def test_two_process_multistream_serving():
    outs = _run_workers("torch_multihost_serve_worker.py")
    assert [o["pid"] for o in outs] == [0, 1]
    assert all(o["ok"] and o["positions"] == 4 for o in outs)
