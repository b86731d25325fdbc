"""Fused threshold-select + pack — port of
``gaussiank_sgd_tpu/ops/pallas_pack.py``.

Two levels, as in the reference:

1. **Kernel (one pass over device memory).** The flat buffer is viewed as
   ``[rows, 128]``; a cell is ``SEG`` consecutive rows of one lane. For
   every cell the kernel emits the largest above-threshold entry by an int32
   ranking key ``(bits(|x|) & ~(SEG-1)) | row_in_seg``, with its exact value
   and chunk-local index, plus the exact per-chunk count of ``|x| > t``.
   The fused EF form also computes ``acc = res + scale * g`` in the same
   pass and writes it back as the new error-feedback row. The kernel is
   CUDA C++ (``csrc/fused_select.cu``); its plain PyTorch version lives
   here and runs for CPU tensors only.
2. **Host tail (small).** An exact top-k over the ``n/SEG`` candidates,
   ties to the lowest candidate position, then ``finish_pack`` and the
   warm-threshold controller.

The padded EF row of the fused form is inert: thresholds are >= 0, the mask
is strict ``|x| > t`` and the pad starts at zero, so no pad element is ever
selected and the pad stays zero.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..compressors.base import CompressResult, finish_pack
from ..compressors.gaussian import (_next_threshold, gaussian_warm_compress,
                                    gaussian_warm_compress_batched)
from ..parallel.wire import encode_entries
from . import _build

_LANES = 128
_MAX_SEG = 64     # largest segment span; shrinks with density (segment_span)
_DENSITY_CEIL = 1.0 / 32   # capacity ceiling of the candidate geometry

# Launches of each CUDA kernel, counted by its wrapper where it launches.
# Plain-version calls (CPU tensors) do not count.
LAUNCHES = {"fused_ef_select": 0, "fused_select": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------- geometry

def segment_span(density: float) -> int:
    """SEG: rows per one-slot candidate cell, chosen so SEG*density <= 0.5."""
    seg = _MAX_SEG
    while seg > 8 and density * seg > 0.5:
        seg //= 2
    return seg


def rows_per_block(density: float) -> int:
    """R: rows per block of the candidate layout."""
    if not supports_density(density):
        raise ValueError(
            f"fused select+pack supports density <= {_DENSITY_CEIL}, "
            f"got {density}")
    return 1024


def supports_density(density: float) -> bool:
    """True iff the candidate geometry can emit k = density*n pairs."""
    return density <= _DENSITY_CEIL


def _chunk_geometry(chunk: int,
                    density: float) -> Tuple[int, int, int, int]:
    """(R, SEG, blocks_per_chunk, candidate_capacity) for a chunk of
    ``chunk`` elements; R is capped at the chunk's own rows (rounded up to
    a SEG multiple)."""
    R = rows_per_block(density)
    seg = segment_span(density)
    rows_total = -(-chunk // _LANES)
    if rows_total < R:
        R = max(seg, -(-rows_total // seg) * seg)
    bpc = -(-chunk // (R * _LANES))
    return R, seg, bpc, (R // seg) * bpc * _LANES


def ef_padded_chunk(chunk: int, k: int, *,
                    density: float) -> Optional[int]:
    """Block-aligned chunk size the fused EF kernel needs, or None when the
    fused EF path cannot serve this (chunk, k, density)."""
    if not supports_density(density):
        return None
    R, _, bpc, nc = _chunk_geometry(chunk, density)
    if k > nc:
        return None
    return bpc * R * _LANES


# ------------------------------------------------------- the kernel's plain

def _emit_candidates_plain(x: torch.Tensor, t: torch.Tensor, R: int,
                           seg: int, bpc: int):
    """The kernel's arithmetic with torch ops on a ``[n_chunks, bpc, nseg,
    SEG, 128]`` view of the zero-padded ``[n_chunks, bpc*R*128]`` input."""
    n_chunks = x.shape[0]
    nseg = R // seg
    x5 = x.reshape(n_chunks, bpc, nseg, seg, _LANES)
    ax = x5.abs()
    mask = ax > t.view(-1, 1, 1, 1, 1)
    counts = mask.sum(dim=(1, 2, 3, 4), dtype=torch.int32)
    rowid = torch.arange(seg, dtype=torch.int32,
                         device=x.device).view(1, 1, 1, seg, 1)
    key = torch.where(mask, (ax.view(torch.int32) & ~(seg - 1)) | rowid, 0)
    top = key.amax(dim=3)                                # [c, bpc, nseg, 128]
    valid = top > 0
    win = (key == top.unsqueeze(3)) & valid.unsqueeze(3)
    val = torch.where(win, x5, 0.0).sum(dim=3)
    blk = torch.arange(bpc, dtype=torch.int32, device=x.device).view(
        1, bpc, 1, 1)
    sg = torch.arange(nseg, dtype=torch.int32, device=x.device).view(
        1, 1, nseg, 1)
    lane = torch.arange(_LANES, dtype=torch.int32, device=x.device)
    seg_row = blk * R + sg * seg + (top & (seg - 1))
    flat_idx = seg_row * _LANES + lane
    vals = torch.where(valid, val, 0.0).reshape(n_chunks, -1)
    idxs = torch.where(valid, flat_idx, 0).reshape(n_chunks, -1)
    return vals, idxs.to(torch.int32), counts


def fused_select_plain(x2d: torch.Tensor, thresholds: torch.Tensor,
                       density: float):
    """Plain version of kernel B2 (any device): zero-pad each chunk to a
    block multiple, as the reference does, then emit candidates."""
    chunk = x2d.shape[1]
    R, seg, bpc, _ = _chunk_geometry(chunk, density)
    x = torch.nn.functional.pad(x2d, (0, bpc * R * _LANES - chunk))
    return _emit_candidates_plain(x, thresholds, R, seg, bpc)


def fused_ef_select_plain(res2d: torch.Tensor, g2d: torch.Tensor,
                          scale: float, thresholds: torch.Tensor,
                          density: float):
    """Plain version of kernel B1 (any device): ``scale * g``, then
    ``+ res``, each rounded to f32, then the candidates of that acc."""
    R, seg, bpc, _ = _chunk_geometry(res2d.shape[1], density)
    acc = res2d + g2d * float(np.float32(scale))
    return (acc,) + _emit_candidates_plain(acc, thresholds, R, seg, bpc)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _outputs(n_chunks: int, nc: int, device):
    return (torch.empty((n_chunks, nc), dtype=torch.float32, device=device),
            torch.empty((n_chunks, nc), dtype=torch.int32, device=device),
            torch.zeros((n_chunks,), dtype=torch.int32, device=device))


# ------------------------------------------------------------- the wrappers

def fused_select_candidates_chunked(
    x2d: torch.Tensor, thresholds: torch.Tensor, density: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate pass over ``[n_chunks, chunk]`` f32 with per-chunk f32
    ``thresholds [n_chunks]``: ``(cand_values [n_chunks, nc], cand_indices
    [n_chunks, nc] chunk-local int32, counts [n_chunks] int32)``.

    Kernel B2 on a CUDA tensor (the ragged tail reads as zero, no pad
    copy); the plain version on a CPU tensor, after zero-padding each chunk
    to a block multiple as the reference does."""
    if x2d.dim() != 2:
        raise ValueError(f"x2d must be [n_chunks, chunk], got {x2d.shape}")
    n_chunks, chunk = x2d.shape
    R, seg, bpc, nc = _chunk_geometry(chunk, density)
    _check("x2d", x2d, (n_chunks, chunk), x2d.device)
    _check("thresholds", thresholds, (n_chunks,), x2d.device)
    if x2d.device.type == "cpu":
        return fused_select_plain(x2d, thresholds, density)
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    vals, idxs, counts = _outputs(n_chunks, nc, x2d.device)
    lib = _build.load().lib
    _build.check(lib.gk_select_candidates(
        x2d.data_ptr(), thresholds.data_ptr(), vals.data_ptr(),
        idxs.data_ptr(), counts.data_ptr(), n_chunks, chunk,
        bpc * (R // seg), seg, _stream(x2d.device)), "fused_select")
    LAUNCHES["fused_select"] += 1
    return vals, idxs, counts


def fused_ef_select_candidates_chunked(
    res2d: torch.Tensor, g2d: torch.Tensor, scale: Union[float, np.floating],
    thresholds: torch.Tensor, density: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused EF accumulate + candidate pass over block-aligned
    ``[n_chunks, chunk_pad]`` f32 rows: ``(acc2d, cand_values, cand_indices,
    counts)`` with ``acc2d = res2d + scale * g2d`` the new, not yet zeroed,
    EF accumulator (a fresh buffer; the inputs are not written).

    Kernel B1 on CUDA tensors; the plain version on CPU tensors, with the
    accumulate as two ops (``scale * g``, then ``+ res``), which the
    kernel's ``__fadd_rn(res, __fmul_rn(scale, g))`` equals bit for bit.
    ``scale`` is a host number (rounded to f32)."""
    if res2d.dim() != 2:
        raise ValueError(f"res2d must be [n_chunks, chunk_pad], got "
                         f"{res2d.shape}")
    n_chunks, chunk_pad = res2d.shape
    R, seg, bpc, nc = _chunk_geometry(chunk_pad, density)
    if bpc * R * _LANES != chunk_pad:
        raise ValueError(
            f"fused EF path needs block-aligned chunks: chunk_pad="
            f"{chunk_pad} != {bpc}*{R}*{_LANES}; pad the live EF buffer "
            f"with ef_padded_chunk first")
    _check("res2d", res2d, (n_chunks, chunk_pad), res2d.device)
    _check("g2d", g2d, (n_chunks, chunk_pad), res2d.device)
    _check("thresholds", thresholds, (n_chunks,), res2d.device)
    scale32 = float(np.float32(scale))
    if res2d.device.type == "cpu":
        return fused_ef_select_plain(res2d, g2d, scale32, thresholds, density)
    if res2d.device.type != "cuda":
        raise ValueError(f"unsupported device {res2d.device}")
    acc = torch.empty_like(res2d)
    vals, idxs, counts = _outputs(n_chunks, nc, res2d.device)
    lib = _build.load().lib
    _build.check(lib.gk_ef_select_candidates(
        res2d.data_ptr(), g2d.data_ptr(), scale32, thresholds.data_ptr(),
        acc.data_ptr(), vals.data_ptr(), idxs.data_ptr(), counts.data_ptr(),
        n_chunks, chunk_pad, bpc * (R // seg), seg, _stream(res2d.device)),
        "fused_ef_select")
    LAUNCHES["fused_ef_select"] += 1
    return acc, vals, idxs, counts


def fused_select_candidates(
    acc: torch.Tensor, threshold: torch.Tensor, density: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One candidate pass over a flat f32 buffer: ``(cand_values [nc],
    cand_indices [nc], count)`` — the ``n_chunks == 1`` case."""
    vals, idxs, counts = fused_select_candidates_chunked(
        acc.reshape(1, -1), threshold.reshape(1), density)
    return vals[0], idxs[0], counts[0]


# --------------------------------------------------------------- host tail

def _cand_top_k(vals: torch.Tensor, k: int):
    """Exact top-k of ``|vals|`` along the last axis, ties to the lowest
    position: ``lax.top_k``'s order. (Above 131,072 candidates the reference
    takes ``approx_max_k``, which on the CPU returns exactly this.) A stable
    descending sort is used because ``torch.topk`` promises no tie order."""
    key = vals.abs()
    kpos = torch.sort(key, dim=-1, descending=True, stable=True).indices
    kpos = kpos[..., :k]
    return key.gather(-1, kpos), kpos


def _select_candidates_topk(vals: torch.Tensor, idxs: torch.Tensor, k: int,
                            n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sent_idx [..., k], val [..., k])`` with the sentinel ``n`` on
    invalid slots (a candidate with key 0 stays in the residual)."""
    kv, kpos = _cand_top_k(vals, k)
    valid = kv > 0
    val = torch.where(valid, vals.gather(-1, kpos), 0.0)
    sent_idx = torch.where(valid, idxs.gather(-1, kpos), n)
    return sent_idx.to(torch.int32), val


def _controller_update(state: torch.Tensor, count: torch.Tensor,
                       val: torch.Tensor, valid: torch.Tensor, k: int,
                       gain: float) -> torch.Tensor:
    """Next carried threshold. Warm (state > 0): the warm GaussianK
    controller's multiplicative nudge toward count == k, clipped to
    [1/4, 4]. Cold (state <= 0): the smallest sent magnitude (1e-8 when
    nothing was sent)."""
    t_warm = _next_threshold(state, count, k, gain)
    mags = torch.where(valid, val.to(torch.float32).abs(), float("inf"))
    kth = mags.amin(dim=-1)
    bootstrap = torch.where(torch.isfinite(kth), kth, float(np.float32(1e-8)))
    return torch.where(state > 0, t_warm, bootstrap).to(state.dtype)


def gaussian_fused_compress(acc: torch.Tensor, k: int, state: torch.Tensor,
                            *, density: float = 0.001,
                            sigma_scale: Optional[float] = None,
                            gain: float = 0.18,
                            ) -> Tuple[CompressResult, torch.Tensor]:
    """Warm-threshold GaussianK over a flat f32 ``acc`` with the fused
    select kernel (B2): kernel candidates -> exact top-k -> finish_pack ->
    controller, with no branch on the hot path. ``acc`` is not modified:
    the residual is a copy with the k sent entries zeroed.

    Above density 1/32, or with k above the candidate capacity, this is
    ``gaussian_warm_compress``, as in the reference: the one form that
    reads ``sigma_scale``."""
    n = acc.shape[0]
    if (not supports_density(density)
            or k > _chunk_geometry(n, density)[3]):
        return gaussian_warm_compress(acc, k, state, density=density,
                                      sigma_scale=sigma_scale, gain=gain)
    vals, idxs, count = fused_select_candidates(acc, state, density)
    sent_idx, val = _select_candidates_topk(vals, idxs, k, n)
    comp, residual = finish_pack(acc.clone(), sent_idx, val.to(acc.dtype))
    valid = sent_idx < n
    t_new = _controller_update(state, count, val, valid, k, gain)
    nsel = torch.where(state > 0, count, valid.sum(dtype=torch.int32))
    return CompressResult(comp, residual, nsel), t_new


def gaussian_fused_compress_batched(
    x: torch.Tensor, k: int, state: torch.Tensor, *,
    density: float = 0.001, sigma_scale: Optional[float] = None,
    gain: float = 0.18,
) -> Tuple[CompressResult, torch.Tensor]:
    """gaussian_fused over ``[n_chunks, chunk]`` with per-chunk thresholds
    ``state [n_chunks]``: one B2 launch for every chunk. ``x`` is not
    modified. Above density 1/32, or with k above the candidate capacity,
    this is ``gaussian_warm_compress_batched``, as in the reference."""
    chunk = x.shape[1]
    if (not supports_density(density)
            or k > _chunk_geometry(chunk, density)[3]):
        return gaussian_warm_compress_batched(x, k, state, density=density,
                                              sigma_scale=sigma_scale,
                                              gain=gain)
    vals, idxs, counts = fused_select_candidates_chunked(x, state, density)
    sent_idx, val = _select_candidates_topk(vals, idxs, k, chunk)
    val = val.to(x.dtype)
    comp, residual = finish_pack(x.clone(), sent_idx, val)
    valid = sent_idx < chunk
    t_new = _controller_update(state, counts, val, valid, k, gain)
    nsel = torch.where(state > 0, counts,
                       valid.sum(dim=-1, dtype=torch.int32))
    return CompressResult(comp, residual, nsel), t_new


def gaussian_fused_ef_compress_batched(
    res2d: torch.Tensor, g2d: torch.Tensor, scale, k: int,
    state: torch.Tensor, *, density: float = 0.001,
    sigma_scale: Optional[float] = None, gain: float = 0.18,
) -> Tuple[CompressResult, torch.Tensor]:
    """gaussian_fused with the EF accumulate folded into the kernel pass
    (B1): the caller hands the carried residual and the raw gradient as
    block-aligned ``[n_chunks, chunk_pad]`` rows, and ``scale`` (1, or the
    learning rate under ``fold_lr``), so ``acc = res + scale * g``. The
    returned residual is the new padded EF buffer (the kernel's acc with
    the k sent entries zeroed); the inputs are not written.
    ``sigma_scale`` is taken for the registry's signature and not read:
    this path never estimates a threshold, as in the reference."""
    del sigma_scale
    n_chunks, chunk_pad = res2d.shape
    if ef_padded_chunk(chunk_pad, k, density=density) != chunk_pad:
        raise ValueError(
            f"fused EF path needs pre-padded block-aligned chunks with "
            f"k <= capacity: got chunk={chunk_pad}, k={k}, "
            f"density={density} (ef_padded_chunk -> "
            f"{ef_padded_chunk(chunk_pad, k, density=density)})")
    acc, vals, idxs, counts = fused_ef_select_candidates_chunked(
        res2d, g2d, scale, state, density)
    sent_idx, val = _select_candidates_topk(vals, idxs, k, chunk_pad)
    comp, residual = finish_pack(acc, sent_idx, val)
    valid = sent_idx < chunk_pad
    t_new = _controller_update(state, counts, val, valid, k, gain)
    nsel = torch.where(state > 0, counts,
                       valid.sum(dim=-1, dtype=torch.int32))
    return CompressResult(comp, residual, nsel), t_new


def pack_wire_words(idx2d: torch.Tensor, val2d: torch.Tensor) -> torch.Tensor:
    """Wire-pack the fused select pass's chunk-local ``[n_chunks, k]``
    selection: one word per entry (u16 bucket-relative index | bf16 value,
    ``parallel/wire.py``). The chunk-local index is the bucket-relative
    one, so no global int32 index buffer is made for the wire. The
    caller's gate keeps the chunk within 65,536 elements; ``finish_pack``
    already mapped invalid slots to index 0 with value 0."""
    return encode_entries(idx2d, val2d)
