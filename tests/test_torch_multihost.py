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
  (tests/torch_multihost_serve_worker.py, which asserts it);
- sharded training and inference on meshes whose 'spatial' groups span
  both processes (tests/torch_multihost_spatial_worker.py), held against
  the one-process unsharded step, which this process computes while the
  workers run: the matting step on ('spatial',) (4) and ('spatial',
  'data') (2, 2), the seg step on (2, 2) (loss and terms 2e-5 relative,
  per-leaf gradients max|dg| / max|g| <= 1e-4, running statistics 1e-5,
  the processes' losses equal bit for bit and their updated parameters
  byte for byte), ``apply_sharded`` on (4) (atol 2e-5), and in float64
  the training network's forward and backward on both meshes (1e-10).

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


def _start_workers(script, nproc=2, *args, threads=None):
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if threads:   # OpenMP threads that spin while gloo waits starve the peer
        env["OMP_NUM_THREADS"] = str(threads)
    return script, [subprocess.Popen(
        [sys.executable, os.path.join(HERE, script), str(i), str(nproc),
         str(port), *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, text=True) for i in range(nproc)]


def _run_workers(script, nproc=2):
    return _collect(*_start_workers(script, nproc))


def _collect(script, procs):
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


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_two_process_spatial_groups_span_processes(tmp_path, monkeypatch):
    import torch

    sys.path.insert(0, HERE)
    import torch_multihost_spatial_worker as wk

    running = _start_workers("torch_multihost_spatial_worker.py", 2,
                             str(tmp_path), threads=2)
    try:
        cases = wk.batches()
        refs = {kind: wk.step(kind, *cases[kind]) for kind in cases}
        net, frame = wk.apply_inputs()
        from vidmat_torch.models.matting_net import init_state

        with torch.no_grad():
            state, apply_refs = init_state(net.cfg, 1, wk.H, wk.W), []
            for _ in range(2):
                a, f, state = net(frame, state)
                apply_refs.append((a, f, *state))
        monkeypatch.setattr(torch.Tensor, "float", lambda self: self)
        a64, f64, g64 = wk.f64_run(*wk.f64_inputs())
    finally:
        outs = _collect(*running)
    assert [o["pid"] for o in outs] == [0, 1]
    assert outs[0]["losses"] == outs[1]["losses"], outs
    assert outs[0]["params"] == outs[1]["params"], outs
    got = [np.load(tmp_path / f"w{pid}.npz") for pid in (0, 1)]
    for name, kind in (("mat4", "mat"), ("mat22", "mat"),
                       ("seg22", "seg")):
        g0, m0, s0, _ = refs[kind]
        sub = {part: {k.split("/", 2)[2]: got[0][k] for k in got[0].files
                      if k.startswith(f"{name}/{part}/")}
               for part in "gsm"}
        assert set(sub["g"]) == set(g0) and set(sub["s"]) == set(s0)
        worst_m = {k: abs(float(sub["m"][k]) - m0[k]) / max(abs(m0[k]),
                                                            1e-12)
                   for k in m0}
        assert max(worst_m.values()) <= 2e-5, (name, worst_m)
        worst_g = {k: _rel(sub["g"][k], g0[k]) for k in g0}
        assert max(worst_g.values()) <= 1e-4, (name, sorted(
            worst_g.items(), key=lambda kv: -kv[1])[:5])
        worst_s = max(float(np.abs(sub["s"][k] - s0[k]).max()) for k in s0)
        assert worst_s <= 1e-5, (name, worst_s)
    for it, ref in enumerate(apply_refs):
        for k, want in zip(("alpha", "fgr", "h3", "h2", "h1"), ref):
            have = got[0][f"apply4/{it}/{k}"]
            assert have.shape == tuple(want.shape), k
            np.testing.assert_allclose(have, want.numpy(), atol=2e-5)
    for mk in ("4", "22"):
        for pid in (0, 1):
            np.testing.assert_allclose(got[pid][f"f64_{mk}/alpha"],
                                       a64.numpy(), rtol=0, atol=1e-12)
            np.testing.assert_allclose(got[pid][f"f64_{mk}/fgr"],
                                       f64.numpy(), rtol=0, atol=1e-12)
            worst = max(_rel(got[pid][f"f64_{mk}/g/{k}"], v.numpy())
                        for k, v in g64.items() if v.abs().max() > 0)
            assert worst <= 1e-10, (mk, pid, worst)
