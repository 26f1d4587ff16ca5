"""AdamW over nested dicts of tensors, updated in place.

The optimizer state is a tree congruent with the parameters ({"m", "v",
"step"}).  Every update is computed in float32 and cast back to each
leaf's dtype, so `state_dtype` bf16 halves optimizer memory.

`adamw_update` writes the new parameters, moments and step into the
tensors it is given (under torch.no_grad) and returns them, as the
reference returns its new trees: a step keeps no second copy of the
master weights.  A caller that needs the old values (a checkpoint taken
before the step) copies them first.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map


def adamw_init(params, state_dtype=torch.float32):
    """Zero moments congruent with `params` (DTensor parameters get
    DTensor moments with their placements) and a step of 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=state_dtype)
    dev = next(leaf for _, leaf in tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32 (0-d)."""
    sums = [torch.sum(torch.square(x.float())) for _, x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so that their global norm is at most max_norm, the
    norm before scaling)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step with learning rate `lr` (a float or a 0-d tensor).
    Writes into `params` and `state` and returns (params, state)."""
    step = state["step"].add_(1)
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    flat_m = dict(tree_leaves(state["m"]))
    flat_v = dict(tree_leaves(state["v"]))
    flat_p = dict(tree_leaves(params))
    for path, g in tree_leaves(grads):
        m, v, p = flat_m[path], flat_v[path], flat_p[path]
        g32 = g.float()
        p32 = p.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, state
