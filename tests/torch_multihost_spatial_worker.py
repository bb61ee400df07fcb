"""Worker process of tests/test_torch_multihost.py: sharded training and
width-sharded inference of the port over meshes whose 'spatial' groups
span both processes.

Each worker is one process with 2 CPU positions; it joins the job over
gloo (``initialize_distributed``). On the global 4-position meshes
('spatial',) (4) and ('spatial', 'data') (2, 2) each data group's
'spatial' positions lie in both processes, so every layer exchanges its
margins across the process boundary. Each process passes the whole rows
of the data groups it holds a position of (here the whole batch). It
runs, and saves for the parent to hold against the unsharded step:

- ``mat4``, ``mat22``: one matting step (laplacian 0.5, boundary 2.0)
  on ('spatial',) (4) and on (2, 2), T=2, N=4, 32x64, through an
  optimizer that applies Adam and keeps the gradients in its state;
- ``seg22``: the segmentation step on (2, 2);
- ``apply4``: ``apply_sharded`` on ('spatial',) (4), from the zero state
  and then from its own state;
- ``f64_4``, ``f64_22``: the training network of the fast_demo model
  (s2d=2) at 32x128 in float64, its outputs and the gradients of a
  weighted sum of them.

Usage: python torch_multihost_spatial_worker.py <process_id>
<num_processes> <port> <out_dir>. Writes <out_dir>/w<process_id>.npz and
prints one JSON line {"pid", "losses", "params"} (``params``: SHA-256 of
each step's updated parameters).
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vidmat_torch.config import ModelConfig, preset_video_1080p  # noqa: E402
from vidmat_torch.models.matting_net import MattingNetwork  # noqa: E402
from vidmat_torch.models.weights import (flatten_variables,  # noqa: E402
                                         graft_seg_params, init_params,
                                         load_into_torch, numpy_variables,
                                         randomize_bn_stats)
from vidmat_torch.parallel.collectives import (  # noqa: E402
    sum_over_processes)
from vidmat_torch.parallel.mesh import (initialize_distributed,  # noqa: E402
                                        make_mesh)
from vidmat_torch.parallel.spatial import (Layout,  # noqa: E402
                                           apply_sharded, sharded_forward)
from vidmat_torch.train import loop, optim  # noqa: E402
from vidmat_torch.train.data import (synthetic_clip_batches,  # noqa: E402
                                     synthetic_seg_batches)

T, N, H, W = 2, 4, 32, 64
MESHES = {"4": (("spatial",), (4,)), "22": (("spatial", "data"), (2, 2))}


def batches():
    """The whole batches the parent's unsharded steps take."""
    cfg = ModelConfig()
    v = init_params(cfg, seed=0)
    return {"mat": (v, next(synthetic_clip_batches(t=T, n=N, h=H, w=W,
                                                   seed=9))),
            "seg": (graft_seg_params(v, cfg),
                    next(synthetic_seg_batches(t=T, n=N, h=H, w=W,
                                               seed=7)))}


def capturing_adam():
    """``make_optimizer``'s Adam, its state keeping the gradients."""
    inner = optim.make_optimizer()

    def update(g, s, p=None):
        u, s2 = inner.update(g, s["inner"], p)
        return u, {"g": g, "inner": s2}

    return optim.GradientTransformation(
        lambda p: {"g": optim.tree_map(optim.zeros_like, p),
                   "inner": inner.init(p)}, update)


def step(kind, variables, batch, mesh=None):
    """One step: (grads, metrics, batch_stats, updated params) as flat
    numpy dicts."""
    opt = capturing_adam()
    make = (loop.make_train_step if kind == "mat"
            else loop.make_seg_train_step)
    kw = (dict(laplacian_weight=0.5, boundary_weight=2.0) if kind == "mat"
          else {})
    fn = make(ModelConfig(), optimizer=opt, mesh=mesh,
              device=None if mesh is not None else "cpu", **kw)
    st, m = fn(loop.TrainState(variables=variables, opt_state=opt.init(
        variables["params"])), *batch)
    flat = lambda t: flatten_variables(numpy_variables(t))  # noqa: E731
    return (flat(st.opt_state["g"]), {k: float(x) for k, x in m.items()},
            flat(st.variables["batch_stats"]),
            flat(st.variables["params"]))


def local_rows(x, lay, axis):
    """The whole rows of the data groups ``lay`` holds a position of."""
    per = x.shape[axis] // lay.d
    idx = np.concatenate([np.arange(g * per, (g + 1) * per)
                          for g in lay.rows])
    return np.take(x, idx, axis=axis)


def apply_inputs():
    cfg = ModelConfig()
    net = MattingNetwork(cfg)
    load_into_torch(net, randomize_bn_stats(init_params(cfg, seed=0)))
    frame = torch.from_numpy(
        np.random.RandomState(0).rand(1, H, W, 3).astype(np.float32))
    return net, frame


def f64_inputs():
    cfg = preset_video_1080p()[0]
    net = MattingNetwork(cfg, bn_train=True)
    load_into_torch(net, init_params(cfg, seed=0))
    rng = np.random.RandomState(0)
    frame, wa, wf = (torch.from_numpy(rng.rand(4, 32, 128, c))
                     for c in (3, 1, 3))
    return net.double().train(), frame, wa, wf


def f64_run(net, frame, wa, wf, lay=None):
    """Outputs and per-parameter gradients of sum(a * wa) + sum(f * wf),
    sharded over ``lay`` or not (float64: ``Tensor.float`` kept)."""
    net.zero_grad()
    if lay is not None:
        fb = lay.frame_bounds(frame.shape[2], 2)
        a, f, _ = sharded_forward(net, lay, lay.split(
            torch.from_numpy(local_rows(frame.numpy(), lay, 0)), 0, 2, fb),
            frame.shape[2])
        a, f = lay.join(a, 0, 2, fb), lay.join(f, 0, 2, fb)
    else:
        a, f, _ = net(frame)
    ((a * wa).sum() + (f * wf).sum()).backward()
    names, grads = zip(*((k, p.grad) for k, p in net.named_parameters()))
    if lay is not None:      # each process's part, as the step sums them
        grads = sum_over_processes(list(grads))
    return a.detach(), f.detach(), {k: g.clone()
                                    for k, g in zip(names, grads)}


def main():
    pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
    meshes = {k: make_mesh(axes, shape, devices=["cpu"] * 2)
              for k, (axes, shape) in MESHES.items()}
    for mesh in meshes.values():
        lay = Layout(mesh)
        assert mesh.local.sum() == 2 and all(
            len(set(row)) == 2 for row in lay.pids.tolist()), lay.pids
    saved, losses, digests = {}, {}, {}
    cases = batches()
    for name, kind, mk in (("mat4", "mat", "4"), ("mat22", "mat", "22"),
                           ("seg22", "seg", "22")):
        variables, batch = cases[kind]
        lay = Layout(meshes[mk])
        g, m, s, p = step(kind, variables,
                          [local_rows(x, lay, 1) for x in batch],
                          meshes[mk])
        losses[name] = m["loss"]
        digests[name] = hashlib.sha256(b"".join(
            p[k].tobytes() for k in sorted(p))).hexdigest()
        saved.update({f"{name}/g/{k}": v for k, v in g.items()})
        saved.update({f"{name}/s/{k}": v for k, v in s.items()})
        saved.update({f"{name}/m/{k}": np.float64(v) for k, v in m.items()})

    net, frame = apply_inputs()
    state = None
    with torch.no_grad():
        for it in range(2):
            a, f, state = apply_sharded(net, meshes["4"], frame, state)
            for k, t in zip(("alpha", "fgr", "h3", "h2", "h1"),
                            (a, f, *state)):
                saved[f"apply4/{it}/{k}"] = t.numpy()

    torch.Tensor.float = lambda self: self     # keep float64
    net, frame, wa, wf = f64_inputs()
    for mk in ("4", "22"):
        a, f, g = f64_run(net, frame, wa, wf, Layout(meshes[mk]))
        saved[f"f64_{mk}/alpha"], saved[f"f64_{mk}/fgr"] = a.numpy(), f.numpy()
        saved.update({f"f64_{mk}/g/{k}": v.numpy() for k, v in g.items()})

    np.savez(os.path.join(out, f"w{pid}.npz"), **saved)
    print(json.dumps({"pid": pid, "losses": losses, "params": digests}),
          flush=True)


if __name__ == "__main__":
    main()
