"""Weights between the reference's flax variables and the port's models.

Flax ``params`` and ``batch_stats`` arrive as nested dicts of numpy arrays
of any depth (``{"BasicBlock_0": {"Conv_0": {"kernel": ...}}, ...}``), the
form ``jax.device_get`` gives; a leaf's path joins its keys with ``/``;
this module needs neither JAX nor flax. A port model holds them as one flat
vector each, in the reference's ``ravel_pytree`` order and flax's leaf
layouts (``param_layout`` / ``stats_layout``), so the transfer is a
flatten in that order and nothing else.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Layout = Sequence[Tuple[str, Tuple[int, ...]]]


def _leaf_paths(tree: Mapping, prefix: str = ""):
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaf_paths(sub, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}"


def flatten_tree(tree: Mapping, layout: Layout) -> np.ndarray:
    """Nested ``{module: {...: {leaf: array}}}`` -> flat f32 vector in
    ``layout`` order. Raises when a leaf is missing, extra, or has another
    shape."""
    want = {path for path, _ in layout}
    have = set(_leaf_paths(tree))
    if want != have:
        raise ValueError(f"tree leaves differ from the layout: missing "
                         f"{sorted(want - have)}, extra {sorted(have - want)}")
    parts = []
    for path, shape in layout:
        node = tree
        for key in path.split("/"):
            node = node[key]
        a = np.asarray(node, np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape} != {tuple(shape)}")
        parts.append(a.reshape(-1))
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def unflatten_tree(flat: np.ndarray, layout: Layout) -> Dict:
    """Flat vector in ``layout`` order -> nested dicts keyed by the path's
    components (copies)."""
    flat = np.asarray(flat, np.float32)
    total = sum(math.prod(shape) for _, shape in layout)
    if flat.shape != (total,):
        raise ValueError(f"flat has shape {flat.shape}, layout holds "
                         f"{total} elements")
    tree: Dict = {}
    off = 0
    for path, shape in layout:
        *mods, leaf = path.split("/")
        node = tree
        for mod in mods:
            node = node.setdefault(mod, {})
        size = math.prod(shape)
        node[leaf] = flat[off:off + size].reshape(shape).copy()
        off += size
    return tree


@torch.no_grad()
def load_flax_variables(model, params: Mapping,
                        batch_stats: Optional[Mapping] = None) -> None:
    """Copy flax ``params`` and ``batch_stats`` (none for a model without
    BatchNorm: the LSTM, the Transformer, AlexNet, MNISTNet) into a port
    model (a padded flat parameter keeps its zero tail)."""
    model.flat[:model.n_params].copy_(torch.from_numpy(
        flatten_tree(params, model.param_layout)))
    model.stats.copy_(torch.from_numpy(
        flatten_tree(batch_stats or {}, model.stats_layout)))


def export_flax_variables(model) -> Tuple[Dict, Dict]:
    """A port model's weights as flax-shaped ``(params, batch_stats)``."""
    flat = model.flat.detach()[:model.n_params].cpu().numpy()
    stats = model.stats.detach().cpu().numpy()
    return (unflatten_tree(flat, model.param_layout),
            unflatten_tree(stats, model.stats_layout))
