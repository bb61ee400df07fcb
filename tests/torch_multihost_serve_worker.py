"""Worker process of tests/test_torch_multihost.py: multi-stream serving
of the port over a mesh that spans processes (the counterpart of
tests/integration/multihost_serve_worker.py).

Each worker is one process with 2 CPU positions; together they form a
4-position ('stream',) mesh serving 4 streams. ``MultiStreamMatting(4,
..., mesh=)`` serves this process's 2 streams (its positions', one
each), and a one-stream instance without a mesh serves each of them (the
same body at the same batch: an instance of 2 streams may differ by 1 in
a byte, the reductions' order depending on the batch); the worker
asserts that their outputs are equal byte for byte over 3 rounds with
scene cuts in the second: serving needs no communication, so the
process boundary must not change a byte.

Usage: python torch_multihost_serve_worker.py <pid> <nproc> <port>
Prints one JSON line {"pid", "ok", "positions", "sum"} on success.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from vidmat_torch.config import ModelConfig  # noqa: E402
from vidmat_torch.models.weights import init_params  # noqa: E402
from vidmat_torch.parallel.mesh import (initialize_distributed,  # noqa: E402
                                        make_mesh)
from vidmat_torch.parallel.multistream import (  # noqa: E402
    MultiStreamMatting)

H = W = 64


def stream_frame(s, t):
    """Stream s's frame at round t (the same in both instances)."""
    return np.random.RandomState(1000 + 37 * s + t).randint(
        0, 255, (H, W, 3), np.uint8)


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
    mesh = make_mesh(("stream",), (2 * nproc,), devices=["cpu"] * 2)
    s_all = mesh.size
    local_s = s_all // nproc
    cfg = ModelConfig(conv_impl="planar")
    kw = dict(cfg=cfg, variables=init_params(cfg, seed=0),
              downsample_ratio=0.5, dtype="float32",
              bg_color=(0.1, 0.6, 0.2), device="cpu")
    meshed = MultiStreamMatting(s_all, H, W, mesh=mesh, **kw)
    singles = [MultiStreamMatting(1, H, W, **kw) for _ in range(local_s)]
    assert meshed.s == local_s and len(meshed.positions) == 2

    mine = range(pid * local_s, (pid + 1) * local_s)
    checksum = 0
    for t in range(3):
        frames = np.stack([stream_frame(s, t) for s in mine])
        reset = np.zeros((local_s,), bool)
        if t == 1:
            reset[::2] = True   # scene cuts on even local slots
        got = meshed.step(frames, reset)
        outs = [one.step(frames[i:i + 1], reset[i:i + 1])
                for i, one in enumerate(singles)]
        want = [np.concatenate(x) for x in zip(*outs)]
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        checksum ^= int(np.bitwise_xor.reduce(got[1], axis=None))
    print(json.dumps({"pid": pid, "ok": True, "positions": s_all,
                      "sum": checksum}), flush=True)


if __name__ == "__main__":
    main()
