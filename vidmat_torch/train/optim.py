"""The optimizer and learning-rate schedule of the training loop
(counterpart of the optax pieces vidmat/train/loop.py and the training
tools use): ``chain``, ``clip_by_global_norm``, ``adam``, ``set_to_zero``,
``multi_transform`` and ``warmup_cosine_decay_schedule``, written out
so that each step computes optax's arithmetic.

Trees are nested dicts of tensors (Flax's variable layout). A
transformation is a pair ``init(params) -> state``, ``update(grads,
state, params) -> (updates, state)``; ``apply_updates(params, updates)``
adds them. Two differences from the PyTorch library's pieces matter and
are kept here as optax has them:

- ``clip_by_global_norm`` leaves the gradients unchanged when their
  global norm is below the limit and divides them by the norm otherwise
  (``clip_grad_norm_`` divides by norm + 1e-6);
- Adam updates every leaf on every step, a leaf whose gradient is zero
  included (its first moment still moves it); ``torch.optim.Adam`` skips
  a parameter without a gradient. The training steps pass zero tensors,
  never None.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Union

import numpy as np
import torch

Tree = Dict[str, Any]
Schedule = Callable[[int], np.float32]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Any]


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves in sorted-key order (the order JAX flattens a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def zeros_like(x) -> torch.Tensor:
    """Zeros shaped as ``x`` (a tensor, on its device, or an array)."""
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return torch.zeros(np.shape(x), dtype=torch.float32)


def _f32(x) -> float:
    """A float32 value as a Python float (exact): a tensor op with it
    computes in the tensor's float32."""
    return float(np.float32(x))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u, params, updates)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """g unchanged when ||g|| < max_norm, else g / ||g|| * max_norm (the
    norm over every leaf)."""
    def update(updates, state, params=None):
        leaves = tree_leaves(updates)
        g_norm = torch.sqrt(sum(torch.sum(x * x) for x in leaves))
        keep = g_norm < max_norm
        return tree_map(lambda t: torch.where(keep, t,
                                              (t / g_norm) * max_norm),
                        updates), state

    return GradientTransformation(lambda params: (), update)


class AdamState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax.scale_by_adam: the moments, one shared step count, bias
    correction ``1 - b ** count`` in float32."""
    def init(params):
        return AdamState(0, tree_map(zeros_like, params),
                         tree_map(zeros_like, params))

    def update(updates, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, updates,
                      state.nu)
        count = state.count + 1
        c = np.float32(count)
        bc1 = _f32(np.float32(1) - np.float32(b1) ** c)
        bc2 = _f32(np.float32(1) - np.float32(b2) ** c)
        out = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2
                                                            + eps_root)
                                                 + eps), mu, nu)
        return out, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr: Union[float, Schedule]
                           ) -> GradientTransformation:
    """Multiply by -lr; a schedule is read at the step count before the
    step (0 first), as optax.scale_by_schedule does."""
    if not callable(lr):
        return GradientTransformation(
            lambda params: (),
            lambda u, s, p=None: (tree_map(lambda g: g * -lr, u), s))

    def update(updates, count, params=None):
        step = _f32(-lr(count))
        return tree_map(lambda g: g * step, updates), count + 1

    return GradientTransformation(lambda params: 0, update)


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 scale_by_learning_rate(lr))


def set_to_zero() -> GradientTransformation:
    return GradientTransformation(
        lambda params: (),
        lambda u, s, p=None: (tree_map(zeros_like, u), s))


def _select(tree: Tree, labels: Tree, label: str) -> Tree:
    """The subtree of the leaves labelled ``label`` (empty dicts kept out)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _select(v, labels[k], label)
            if sub:
                out[k] = sub
        elif labels[k] == label:
            out[k] = v
    return out


def _merge(into: Tree, part: Tree) -> None:
    for k, v in part.items():
        if isinstance(v, dict):
            _merge(into.setdefault(k, {}), v)
        else:
            into[k] = v


def multi_transform(transforms: Dict[str, GradientTransformation],
                    param_labels: Callable[[Tree], Tree]
                    ) -> GradientTransformation:
    """optax.multi_transform: each transformation sees only the leaves
    its label names (its clip norm is over those alone)."""
    def init(params):
        labels = param_labels(params)
        return {k: t.init(_select(params, labels, k))
                for k, t in transforms.items()}

    def update(updates, state, params=None):
        labels = param_labels(updates)
        out: Tree = {}
        new_state = {}
        for k, t in transforms.items():
            sub_p = None if params is None else _select(params, labels, k)
            u, new_state[k] = t.update(_select(updates, labels, k),
                                       state[k], sub_p)
            _merge(out, u)
        return out, new_state

    return GradientTransformation(init, update)


def make_optimizer(lr: Union[float, Schedule] = 1e-4
                   ) -> GradientTransformation:
    """The training loop's optimizer: optax.chain(clip_by_global_norm(1.0),
    adam(lr))."""
    return chain(clip_by_global_norm(1.0), adam(lr))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    def schedule(count):
        if transition_steps <= 0:
            return np.float32(init_value)
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return (np.float32(init_value - end_value) * frac
                + np.float32(end_value))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("the cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}")

    def schedule(count):
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(np.pi) * c / np.float32(decay_steps)))
        decayed = np.float32(1 - alpha) * cosine + np.float32(alpha)
        return np.float32(init_value) * decayed
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps``; float32 arithmetic."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                alpha)

    def schedule(count):
        return warm(count) if count < warmup_steps else cos(
            count - warmup_steps)
    return schedule
