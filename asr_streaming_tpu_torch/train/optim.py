"""Optimizers with optax's semantics, and the step utilities.

The JAX trainers build their optimizers from optax (``chain``,
``clip_by_global_norm``, ``adam``, ``adamw``) and differentiate with
``jax.value_and_grad``; the port cannot import optax, so this module
keeps those semantics in torch, functionally, over parameter trees
(nested dicts and lists of tensors):

  * an optimizer is ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``, and
    ``apply_updates`` adds the updates, as in optax;
  * adam: ``mu_hat / (sqrt(nu_hat) + eps)`` with bias corrections
    ``1 - b**count`` in f32; adamw adds ``weight_decay * param`` to every
    leaf (no mask), then the learning rate scales;
  * a schedule sees optax's count: 0 on the first update.

The updates are written by hand rather than through ``torch.optim``:
``torch.optim.AdamW`` applies the decay to the parameter in place, so
its update is known only as a difference of parameters, which loses the
digits that a comparison with optax needs.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples and
    NamedTuples of tensors) and the same leaves of the trees in
    ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def value_and_grad(loss_fn: Callable, params, has_aux: bool = False):
    """(loss, grads) of ``loss_fn(params)``, as ``jax.value_and_grad``:
    the grads tree has the params' structure, and a leaf the loss does
    not reach gets zeros (autograd would give None).  With ``has_aux``,
    ``loss_fn`` returns (loss, aux) and this ((loss, aux), grads), the
    tensors of ``aux`` detached."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(params)
    if has_aux:
        loss, aux = loss
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    grads = tree_map(lambda p: by_id[id(p)], params)
    if has_aux:
        return (loss.detach(), tree_map(lambda t: t.detach(), aux)), grads
    return loss.detach(), grads


def apply_updates(params, updates):
    with torch.no_grad():
        return tree_map(lambda p, u: (p + u).detach(), params, updates)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float, sum_squares: Optional[Callable]
                        = None) -> GradientTransformation:
    """Scale every leaf by max_norm / ||g|| when the global norm
    ||g|| reaches max_norm.  ``sum_squares(grads)`` gives ||g||^2 where
    the tree is one shard of the model
    (parallel/collectives.py::global_sum_squares); by default the sum over
    the tree's leaves."""
    def update(grads, state, params=None):
        with torch.no_grad():
            sq = (sum(torch.sum(g * g) for g in tree_leaves(grads))
                  if sum_squares is None else sum_squares(grads))
            g_norm = torch.sqrt(sq)
            keep = g_norm < max_norm          # no host sync
            return tree_map(lambda g: torch.where(
                keep, g, (g / g_norm) * max_norm), grads), state

    return GradientTransformation(lambda params: (), update)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in f32, as numpy and XLA round it (torch's f32
    pow differs by an ulp at some counts, 2e-5 of 1 - 0.999**3)."""
    return float(1 - np.float32(decay) ** count)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        with torch.no_grad():
            mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads,
                          state["mu"])
            nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                          state["nu"])
            count = state["count"] + 1
            c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
            updates = tree_map(
                lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps), mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(grads, state, params=None):
        with torch.no_grad():
            return tree_map(lambda u, p: u + weight_decay * p, grads,
                            params), state

    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(schedule: Schedule) -> GradientTransformation:
    """updates * -lr, lr = schedule(count), count 0 on the first update."""
    def update(grads, state, params=None):
        lr = schedule(state) if callable(schedule) else schedule
        with torch.no_grad():
            return tree_map(lambda u: u * -lr, grads), state + 1

    return GradientTransformation(lambda params: 0, update)


def adam(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


class TrainLog(NamedTuple):
    """What a trainer's CLI returns: the loss after each step and each
    step's wall seconds (each ends by reading the loss on the host)."""
    losses: List[float]
    seconds: List[float]

    @property
    def loss(self) -> float:
        return self.losses[-1]
