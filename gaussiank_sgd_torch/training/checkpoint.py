"""Checkpoint and resume (port of
``gaussiank_sgd_tpu/training/checkpoint.py``).

A checkpoint holds the whole training state, so a resumed run continues
the uninterrupted one bit for bit: the parameters, the momentum and the
BatchNorm running statistics, every worker's EF residual row and warm
thresholds, the step, and every worker's dropout generator. The trainer
realigns its data stream to the restored step (``data/loader.py``).

Files are written with ``torch.save`` and read with ``torch.load(...,
weights_only=True)``. The port cannot read the reference's orbax
checkpoints, nor the reference the port's: it imports no JAX. One step
directory ``step_XXXXXXXX`` holds

* ``state.pt`` (rank 0): ``step``, ``world`` (P), ``numel`` (N), and the
  replicated ``params``, ``opt_state`` and ``model_state``. The flat
  parameter and momentum are stored **unpadded**, at N: the fused-EF
  path's zero pad (``models/flat.py:pad_flat``) never reaches the disk;
* ``rank_RRRRR.pt`` (one a rank): that worker's EF row at N, its
  thresholds (``[n_buckets]``, or None for a stateless compressor) and its
  dropout generator's state. Stacked over the ranks the rows are the
  reference's logical ``[P, N]`` EF array and ``[P, n_buckets]``
  thresholds. Each rank writes its own row rather than gathering P rows of
  N floats onto rank 0, which at P = 8 and ResNet-50 would put 8 x 102 MB
  on one card and serialise every write behind one process;
* ``commit_manifest.json``, written last by rank 0 after every rank has
  written (a barrier), through a tmp file and ``os.replace``: that rename
  is the commit bit. It lists every file with its size and CRC-32.

``list_checkpoints`` returns only sealed directories whose files still
have their listed sizes; a restore also checks each file's CRC-32 (a
flipped bit in a tensor's bytes loads silently otherwise), and
``restore_latest_good`` falls back to the previous sealed checkpoint when
one fails to restore on any rank. A restore at another worker count
(P -> P') gives every new EF row ``sum_p(rows) / P'`` in the unpadded
space, summed in row order, and every new worker the mean of the old
thresholds; dropout generators then keep their fresh seeds.

Not ported: the reference's conversion of a legacy optax momentum tree
into the flat buffer (the port has only the flat optimizer), and the
recurrent carry (no recurrent model is ported yet).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.collectives import all_reduce_sum, rank, world_size
from ..parallel.trainstep import TrainState

MANIFEST = "commit_manifest.json"
SHARED = "state.pt"
_FORMAT = 1


def _row_file(r: int) -> str:
    return f"rank_{r:05d}.pt"


def _barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            crc = zlib.crc32(chunk, crc)
    return crc


def _host(t: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """A host copy of ``t[:n]`` with its own storage (``torch.save`` of a
    view would write the whole underlying buffer, pad included)."""
    t = t.detach()
    return (t if n is None else t[:n]).to("cpu", copy=True)


def save_checkpoint(ckpt_dir: str, state: TrainState, numel: int, *,
                    generator: Optional[torch.Generator] = None,
                    overwrite: bool = False) -> str:
    """Write and seal a checkpoint of ``state`` on every rank (a
    collective: each rank calls it); returns the step directory.

    ``numel`` is the model's parameter count N; the live flat vectors may
    be longer (the fused-EF pad), and only their first N entries are
    written. A sealed checkpoint already at this step is left as it is
    unless ``overwrite`` (the trainer passes it when the live state may
    differ from that directory's: a resumed run re-reaching a step an older
    trajectory sealed). An unsealed directory at this step is an aborted
    save and is always rewritten."""
    r, p = rank(), world_size()
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{state.step:08d}")
    _barrier()                        # every rank sees the same directory
    keep = is_committed(path) and not overwrite
    _barrier()
    if keep:
        return path
    if r == 0:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
    _barrier()
    if r == 0:
        torch.save({"step": state.step, "world": p, "numel": numel,
                    "params": _host(state.params, numel),
                    "opt_state": {k: _host(v, numel)
                                  for k, v in state.opt_state.items()},
                    "model_state": {k: _host(v)
                                    for k, v in state.model_state.items()}},
                   os.path.join(path, SHARED))
    torch.save({"ef_residual": _host(state.ef_residual, numel),
                "comp_state": (None if state.comp_state is None
                               else _host(state.comp_state[0])),
                "dropout_generator": (None if generator is None
                                      else generator.get_state())},
               os.path.join(path, _row_file(r)))
    _barrier()
    if r == 0:
        _write_manifest(path, state.step, p)
    _barrier()
    return path


def _write_manifest(path: str, step: int, world: int) -> None:
    """Seal a finished save: list every file (size, CRC-32), write the list
    to a tmp name and rename it into place, the commit point."""
    files = {}
    for name in sorted(os.listdir(path)):
        if name in (MANIFEST, MANIFEST + ".tmp"):
            continue
        fp = os.path.join(path, name)
        files[name] = {"size": os.path.getsize(fp), "crc32": _crc32(fp)}
    tmp = os.path.join(path, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"format": _FORMAT, "step": step, "world": world,
                   "wrote_unix": time.time(), "files": files}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, MANIFEST))


def _manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def checkpoint_bytes(path: str) -> int:
    """The bytes of a sealed checkpoint's files, from its manifest."""
    return sum(f["size"] for f in _manifest(path)["files"].values())


def is_committed(path: str) -> bool:
    """True when ``path`` is sealed and every file its manifest lists has
    its listed size (an aborted save has no manifest; a truncated or
    deleted file fails the size check; ``restore_checkpoint`` checks the
    contents)."""
    try:
        files = _manifest(path)["files"]
        return all(os.path.getsize(os.path.join(path, name)) == f["size"]
                   for name, f in files.items())
    except (OSError, ValueError, KeyError, TypeError):
        return False


def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """Sealed, size-valid checkpoints as ``(step, path)``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(os.path.abspath(ckpt_dir), d)
        if not d.startswith("step_") or not is_committed(path):
            continue
        try:
            out.append((int(d[len("step_"):]), path))
        except ValueError:
            continue
    return out


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


def gc_checkpoints(ckpt_dir: str, keep_last: int) -> List[str]:
    """Delete all but the newest ``keep_last`` sealed checkpoints (unsealed
    directories are left alone); returns the removed paths. ``keep_last <
    1`` keeps everything."""
    if keep_last < 1:
        return []
    removed = []
    for _, path in list_checkpoints(ckpt_dir)[:-keep_last]:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def _load(path: str, name: str, manifest: dict) -> dict:
    """``torch.load`` of one listed file after its CRC-32 check."""
    fp = os.path.join(path, name)
    want = manifest["files"][name]["crc32"]
    if _crc32(fp) != want:
        raise ValueError(f"{fp}: CRC-32 differs from the manifest's")
    return torch.load(fp, map_location="cpu", weights_only=True)


def _read(path: str, state: TrainState, ef_numel: int):
    """Everything this rank restores from ``path``, on the host, checked
    against the live state's shapes: ``(shared, ef row, thresholds,
    generator state, old P)``."""
    manifest = _manifest(path)
    old_p, new_p = int(manifest["world"]), world_size()
    shared = _load(path, SHARED, manifest)
    n = int(shared["numel"])
    if not 0 < n <= ef_numel or state.params.numel() != ef_numel:
        raise ValueError(f"checkpoint of {n} parameters does not fit the "
                         f"live flat vectors of {ef_numel}")
    for k, v in state.model_state.items():
        if shared["model_state"][k].shape != v.shape:
            raise ValueError(f"model_state[{k!r}] has shape "
                             f"{tuple(shared['model_state'][k].shape)}, "
                             f"live {tuple(v.shape)}")
    rows = [_load(path, _row_file(r), manifest)
            for r in ([rank()] if old_p == new_p else range(old_p))]
    if any(row["ef_residual"].shape != (n,) for row in rows):
        raise ValueError("an EF row is not of the checkpoint's N")
    if old_p == new_p:
        ef, cs = rows[0]["ef_residual"], rows[0]["comp_state"]
        gen = rows[0]["dropout_generator"]
    else:
        # mass-preserving redistribution in the unpadded space
        ef = rows[0]["ef_residual"].clone()
        for row in rows[1:]:
            ef += row["ef_residual"]
        ef /= new_p
        cs = None
        if rows[0]["comp_state"] is not None:
            cs = rows[0]["comp_state"].clone()
            for row in rows[1:]:
                cs += row["comp_state"]
            cs /= old_p
        gen = None
    if (cs is None) != (state.comp_state is None) or (
            cs is not None and cs.shape != state.comp_state[0].shape):
        raise ValueError("the checkpoint's thresholds do not fit the live "
                         "compressor state")
    return shared, ef, cs, gen, old_p


def restore_checkpoint(path: str, state: TrainState, ef_numel: int, *,
                       generator: Optional[torch.Generator] = None,
                       on_elastic: Optional[Callable[[int, int], None]] = None
                       ) -> None:
    """Restore the checkpoint at ``path`` into the live ``state`` (a
    collective: each rank calls it). The flat parameter and the BatchNorm
    buffers are written in place; momentum, EF row and thresholds are
    replaced, each vector re-padded with zeros to ``ef_numel``.
    ``generator`` (this rank's dropout generator) gets its saved state back
    at an unchanged worker count. Every rank checks what it read; if any
    rank's read failed, every rank raises and nothing is restored.
    ``on_elastic(old P, new P)`` is called when the worker count
    changed."""
    dev = state.params.device
    try:
        read, err = _read(path, state, ef_numel), None
    except Exception as e:  # noqa: BLE001 -- every rank must agree; re-raised
        read, err = None, e
    failed = int(all_reduce_sum(torch.tensor(int(err is not None),
                                             device=dev)))
    if failed:
        raise RuntimeError(f"restore of {path} failed on {failed} rank(s)"
                           + (f"; here: {type(err).__name__}: {err}"
                              if err is not None else "")) from err
    shared, ef, cs, gen, old_p = read
    if old_p != world_size() and on_elastic is not None:
        on_elastic(old_p, world_size())
    n = int(shared["numel"])

    def padded(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(ef_numel, dtype=x.dtype, device=dev)
        out[:n] = x.to(dev)
        return out

    with torch.no_grad():
        state.params.detach().copy_(padded(shared["params"]))
        for k, v in state.model_state.items():
            v.copy_(shared["model_state"][k].to(dev))
    state.opt_state = {k: padded(v) for k, v in shared["opt_state"].items()}
    state.ef_residual = padded(ef)
    if cs is not None:
        state.comp_state = cs.to(dev)[None, :]
    if gen is not None and generator is not None:
        generator.set_state(gen)
    state.step = int(shared["step"])


def restore_latest_good(ckpt_dir: str, state: TrainState, ef_numel: int, *,
                        generator: Optional[torch.Generator] = None,
                        on_skip: Optional[Callable[[str, Exception],
                                                   None]] = None,
                        on_elastic: Optional[Callable[[int, int],
                                                      None]] = None) -> str:
    """Restore the newest sealed checkpoint under ``ckpt_dir`` that
    restores, walking back past any that fail (``on_skip(path, error)`` for
    each); returns its path. Raises ``FileNotFoundError`` when nothing is
    sealed there and ``RuntimeError`` when every candidate failed."""
    ckpts = list_checkpoints(ckpt_dir)
    if not ckpts:
        raise FileNotFoundError(f"no committed checkpoint under "
                                f"{ckpt_dir!r}")
    causes = []
    for _, path in reversed(ckpts):
        try:
            restore_checkpoint(path, state, ef_numel, generator=generator,
                               on_elastic=on_elastic)
            return path
        except RuntimeError as e:
            causes.append(f"{os.path.basename(path)}: {e}")
            if on_skip is not None:
                on_skip(path, e)
    raise RuntimeError("every committed checkpoint failed to restore:\n  "
                       + "\n  ".join(causes))
