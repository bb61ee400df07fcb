"""Chunked temporal step of the network (counterpart of
vidmat/pipeline/scan.py): K frames per call, the recurrent carry threaded
through them in order, as the JAX package's ``lax.scan``.

This is the network-level chunk step (the temporal parity tests' unit);
the serving bodies chunk through ``graph.per_frame_chunk`` and the fused
``chunk_body``.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from vidmat_torch._device import full_fp32, resolve_device
from vidmat_torch.models.matting_net import MattingNetwork, RecurrentState
from vidmat_torch.models.weights import module_tensors, to_device


def make_chunk_step(net: MattingNetwork, cdtype=torch.float32,
                    device="cuda"):
    """Build a chunk step of ``net`` (a ``MattingNetwork``: its
    definition; the weights come with each call).

    chunk_step(variables, frames, state) -> (alphas, fgrs, new_state)
      variables: Flax-layout variables {'params', 'batch_stats'} (numpy or
                 tensor leaves), run through ``torch.func.functional_call``
                 on ``module_tensors``; converted once per variables object
                 and kept on the device, not reloaded every call
      frames:    (K, N, H, W, C) float in [0, 1] (already ingested),
                 cast to ``cdtype``
      state:     RecurrentState for (N, H, W) (``init_state``), or None
                 for a non-recurrent net
    alphas (K, N, H, W, 1), fgrs (K, N, H, W, 3) and new_state on
    ``device`` (the card unless the caller passes ``device="cpu"``).
    Inference only (no autograd), in full float32 where float32."""
    dev = resolve_device(device)
    names = set(net.state_dict())
    held = {}

    def weights(variables):
        if held.get("variables") is not variables:
            # Leaves the module lacks (a co-trained tree's seg_head on a
            # matting-only net) are not read, as Flax's apply ignores them.
            held["tensors"] = {
                k: v for k, v in module_tensors(
                    to_device(variables, dev)).items() if k in names}
            held["variables"] = variables
        return held["tensors"]

    @torch.no_grad()
    def chunk_step(variables, frames, state):
        tensors = weights(variables)
        frames = torch.as_tensor(frames).to(dev, cdtype)
        if state is not None:
            state = RecurrentState(*(torch.as_tensor(h).to(dev)
                                     for h in state))
        alphas, fgrs = [], []
        with full_fp32():
            for x in frames:
                alpha, fgr, state = functional_call(net, tensors,
                                                    (x, state))
                alphas.append(alpha)
                fgrs.append(fgr)
        return torch.stack(alphas), torch.stack(fgrs), state

    return chunk_step
