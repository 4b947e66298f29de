"""Training steps of the reference: the mean token cross-entropy of
``model.Reference``, its gradients by autograd in float32 (one row at a
time, each layer recomputed in the backward), and AdamW as the trainer's
configuration states it: the global gradient norm clipped to
``grad_clip``, bias-corrected moments, and decoupled weight decay on
every leaf of two or more dims as it is stored (the layer-stacked norm
weights too).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from .model import Reference


def leaves(tree: dict, prefix: str = ""):
    """(path, tensor) of every leaf, depth first."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, name + "/")
        else:
            yield name, v


def adamw_steps(cfg: dict, params: dict, batches: list[dict], opt: dict,
                control: str | None = None) -> dict:
    """Train ``params`` (float32 leaves, modified in place) for one step a
    batch.  ``batches``: dicts of (B, S) token and label tensors on the
    parameters' device.  ``opt``: lr, b1, b2, eps, weight_decay,
    grad_clip.  Returns the loss of each step, each leaf's norm of the
    first step's clipped gradient (what the optimizer gets) and of its
    raw gradient."""
    flat = dict(leaves(params))
    for t in flat.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in flat.items()}
    v = {k: torch.zeros_like(t) for k, t in flat.items()}
    ref = Reference(cfg, params, control=control, remat=True)
    out = {"losses": [], "first_grad": None, "first_raw_grad": None}
    for step, batch in enumerate(batches, start=1):
        rows = batch["tokens"].shape[0]
        total = 0.0
        for t in flat.values():
            t.grad = None
        for i in range(rows):
            loss = ref.loss(batch["tokens"][i: i + 1],
                            batch["labels"][i: i + 1]) / rows
            loss.backward()
            total += float(loss.detach())
        out["losses"].append(total)
        with torch.no_grad():
            grads = {k: t.grad for k, t in flat.items()}
            gnorm = math.sqrt(sum(float(g.pow(2).sum())
                                  for g in grads.values()))
            scale = (min(1.0, opt["grad_clip"] / max(gnorm, 1e-12))
                     if opt["grad_clip"] else 1.0)
            if step == 1:
                out["first_raw_grad"] = {k: float(g.norm())
                                         for k, g in grads.items()}
                out["first_grad"] = {k: n * scale for k, n in
                                     out["first_raw_grad"].items()}
            c1 = 1.0 - opt["b1"] ** step
            c2 = 1.0 - opt["b2"] ** step
            for k, p in flat.items():
                g = grads[k] * scale
                m[k].mul_(opt["b1"]).add_(g, alpha=1.0 - opt["b1"])
                v[k].mul_(opt["b2"]).addcmul_(g, g, value=1.0 - opt["b2"])
                delta = (m[k] / c1) / ((v[k] / c2).sqrt() + opt["eps"])
                if p.dim() >= 2:
                    delta = delta + opt["weight_decay"] * p
                p.sub_(opt["lr"] * delta)
    for t in flat.values():
        t.requires_grad_(False)
        t.grad = None
    return out


def change_norms(params: dict, make_start: Callable[[], dict]
                 ) -> dict[str, float]:
    """Each leaf's norm of ``params`` less the start the weight maker
    makes again (one leaf at a time is compared; the start is freed)."""
    start = dict(leaves(make_start()))
    out = {k: float((p.detach().float() - start[k].float()).norm())
           for k, p in leaves(params)}
    del start
    return out
