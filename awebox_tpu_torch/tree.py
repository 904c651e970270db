"""Nested-dict helpers: the port's parameter trees are plain dicts whose
leaves are numpy arrays (build time) or tensors (run time)."""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """Apply fn leafwise over one or more dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def to_tensors(tree, dtype, device):
    """Every leaf as a tensor: floating leaves in ``dtype``, on ``device``."""
    def leaf(x):
        t = x if torch.is_tensor(x) else torch.as_tensor(np.array(x))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return tree_map(leaf, tree)
