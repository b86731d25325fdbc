"""``"generator": "images"``: a closed loop of image batches.

The trainer takes the next batch as soon as the step before it has
finished, cycling through ``pool_batches`` distinct global batches of
``global_batch`` rows. Each image is its class's template (drawn at
``template_hw`` and repeated up to the image size, so the task is
learnable) plus ``noise`` times unit normal noise, as pixels
``clip(128 + 48 * value)`` in uint8; labels are uniform over ``classes``.
``served_as`` is the layout and dtype the port's own input pipeline hands
the trainer for this dataset: ``uint8`` (ImageNet: NHWC pixels,
normalised on the device) or ``float32_normalised`` (CIFAR: NHWC float32,
``(x / 255 - mean) / std`` per channel). Labels are int32.

The pixels are drawn on the device with one generator and copied to
host memory once, in set-up. The shapes and the int32 labels in
``[0, classes)`` are those of ``gaussiank_sgd_torch/benchlib.py``'s
``make_batch`` (frozen here); the pixels' dtype is the dataset pipeline's
and not ``make_batch``'s float32 normals, since the trainer is handed
what its pipeline would hand it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..seeds import derive

Batch = Tuple[np.ndarray, np.ndarray]
SERVED = {"uint8": torch.uint8, "float32_normalised": torch.float32}


def make_pool(traffic: Dict, seed: int, device: torch.device) -> List[Batch]:
    h, w, c = traffic["image"]
    th, tw = traffic["template_hw"]
    classes = int(traffic["classes"])
    rows = int(traffic["global_batch"])
    if traffic["served_as"] not in SERVED:
        raise ValueError(f"unknown served_as {traffic['served_as']!r}")
    gen = torch.Generator(device).manual_seed(derive(seed, "traffic"))
    templates = torch.randn((classes, th, tw, c), generator=gen,
                            device=device)
    templates = templates.repeat_interleave(h // th, dim=1)
    templates = templates.repeat_interleave(w // tw, dim=2)
    pool = []
    for _ in range(int(traffic["pool_batches"])):
        y = torch.randint(0, classes, (rows,), generator=gen, device=device)
        noise = torch.randn((rows, h, w, c), generator=gen, device=device)
        x = torch.clamp(128.0 + 48.0 * (templates[y]
                                        + traffic["noise"] * noise),
                        0.0, 255.0).to(torch.uint8)
        if traffic["served_as"] == "float32_normalised":
            mean = torch.tensor(traffic["mean"], device=device)
            std = torch.tensor(traffic["std"], device=device)
            x = (x.float() / 255.0 - mean) / std
        pool.append((x.cpu().numpy(), y.to(torch.int32).cpu().numpy()))
    return pool


def input_spec(traffic: Dict, rows: int):
    """``((x shape, x dtype), (y shape, y dtype))`` of ``rows`` rows as
    the trainer is handed them (the FLOP count's inputs)."""
    return (((rows, *traffic["image"]), SERVED[traffic["served_as"]]),
            ((rows,), torch.int64))


def write_split_files(pool: List[Batch], rows: int, path: str) -> str:
    """The pool's first ``rows`` rows as the ``{train,val}_{images,labels}
    .npy`` files of a data directory (``path``), which the port's ImageNet
    reader memory-maps: a run's trainer then builds its datasets from
    files, as a deployment with data does, and draws no synthetic split.
    The trainer is fed the pool itself."""
    if sum(len(b[1]) for b in pool) < rows:
        raise ValueError(f"the pool holds fewer than {rows} rows")
    os.makedirs(path, exist_ok=True)
    x = np.concatenate([b[0] for b in pool])[:rows]
    y = np.concatenate([b[1] for b in pool])[:rows]
    for split in ("train", "val"):
        np.save(os.path.join(path, f"{split}_images.npy"), x)
        np.save(os.path.join(path, f"{split}_labels.npy"), y)
    return path
