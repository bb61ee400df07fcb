"""Worker process of tests/test_torch_multihost.py: one sharded train step
of the port over a mesh that spans processes (the counterpart of
tests/integration/multihost_worker.py).

Each worker is one process with 2 CPU positions. It joins the job over
gloo (``initialize_distributed``), builds the global 4-position
('data',) mesh and runs one ``make_train_step(mesh=)`` step on its own
rows of the batch (seed 100 + pid): BatchNorm's statistics and the
gradients are summed across the process boundary, the outputs gathered
from both processes for the replicated loss.

Usage: python torch_multihost_worker.py <process_id> <num_processes> <port>
Prints one JSON line {"pid", "loss", "devices", "params"} on success
(``params``: a SHA-256 of the updated parameters' bytes).
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from vidmat_torch.config import ModelConfig  # noqa: E402
from vidmat_torch.models.weights import (flatten_variables,  # noqa: E402
                                         init_params, numpy_variables)
from vidmat_torch.parallel.mesh import (initialize_distributed,  # noqa: E402
                                        make_mesh)
from vidmat_torch.train.loop import (TrainState, make_optimizer,  # noqa: E402
                                     make_train_step)

T, N, H, W = 1, 4, 16, 32   # the JAX worker's sizes


def local_batch(pid, nproc):
    """Process ``pid``'s rows of the batch."""
    rng = np.random.RandomState(100 + pid)
    n = N // nproc
    return (rng.rand(T, n, H, W, 3).astype(np.float32),
            rng.rand(T, n, H, W, 1).astype(np.float32),
            rng.rand(T, n, H, W, 3).astype(np.float32))


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
    mesh = make_mesh(("data",), (2 * nproc,), devices=["cpu"] * 2)
    assert mesh.process_count == nproc and mesh.local.sum() == 2
    cfg = ModelConfig()
    variables = init_params(cfg, seed=0)   # equal in every process
    optimizer = make_optimizer()
    state = TrainState(variables=variables,
                       opt_state=optimizer.init(variables["params"]))
    step = make_train_step(cfg, optimizer, mesh=mesh)
    state, metrics = step(state, *local_batch(pid, nproc))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    flat = flatten_variables(numpy_variables(state.variables["params"]))
    digest = hashlib.sha256(b"".join(flat[k].tobytes()
                                     for k in sorted(flat))).hexdigest()
    print(json.dumps({"pid": pid, "loss": loss, "devices": mesh.size,
                      "params": digest}), flush=True)


if __name__ == "__main__":
    main()
