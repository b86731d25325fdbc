"""Device selection for the port's entry points.

The port runs on the card. The CPU is taken only when a caller asks for it
(the tests do, with ``device="cpu"``); a missing GPU is an error, never a
silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; raise if it is absent; ``cpu`` only when asked.

    On ``cuda`` it also pins float32 matmuls and convolutions to full f32
    (TF32 off), so an f32 run computes what its reference computes, and
    makes cuDNN pick deterministic algorithms without autotuning, so a
    seeded run, and a run resumed from a checkpoint, repeat bit for bit.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; this entry point runs on the "
                "GPU unless the caller passes device='cpu' (--device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def card_line(device: Union[str, torch.device]) -> Optional[str]:
    """The card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``), or None on the CPU. A card's
    power limit moves its times, so every number measured on it travels
    with this line."""
    import subprocess
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return lines[index if index < len(lines) else 0].strip()
