"""Nested dicts of tensors as the port's parameter trees (the reference's
pytrees): their leaves in a fixed order, a leaf-wise map, a rebuild from
flat leaves, and ``value_and_grad`` over such a tree."""

from __future__ import annotations

import torch


def leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict, in a fixed order."""
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, dict):
            yield from leaves(node, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", node


def tree_map(fn, tree, *rest):
    """The nested dict ``tree`` with each leaf replaced by ``fn(leaf,
    *leaves of rest at the same place)``."""
    return {name: (tree_map(fn, node, *(r[name] for r in rest))
                   if isinstance(node, dict)
                   else fn(node, *(r[name] for r in rest)))
            for name, node in tree.items()}


def rebuild(like, flat: dict):
    """The nested dict shaped like ``like`` whose leaves are
    ``flat[path]``."""
    def go(node, prefix):
        return {name: (go(child, f"{prefix}{name}/")
                       if isinstance(child, dict) else flat[prefix + name])
                for name, child in node.items()}
    return go(like, "")


def value_and_grad(loss_fn, params, *args, has_aux: bool = False):
    """``jax.value_and_grad(loss_fn, has_aux=has_aux)(params, *args)``
    for a nested dict ``params``: ``(loss, grads)`` or ``((loss, aux),
    grads)``, the loss detached and ``grads`` shaped like ``params``. Only
    ``params``' leaves require grad (fresh detached views of them), so
    tensors among ``args`` stay out of the graph unless they require grad
    themselves."""
    flat = {name: p.detach().requires_grad_(True)
            for name, p in leaves(params)}
    with torch.enable_grad():
        out = loss_fn(rebuild(params, flat), *args)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, list(flat.values()))
    grads = rebuild(params, dict(zip(flat, grads)))
    if has_aux:
        return (loss.detach(), out[1]), grads
    return loss.detach(), grads
