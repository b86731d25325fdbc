"""Per-task loss and eval functions (port of the ``classify``, ``lm``,
``ctc`` and ``seq2seq`` tasks of ``gaussiank_sgd_tpu/training/losses.py``).

A loss function here is a closure over its model: ``loss_fn(batch) ->
(loss, aux)``, or for a recurrent model ``loss_fn(batch, carry) -> (loss,
aux, new carry)``. A train-mode forward updates the model's BatchNorm
running statistics in place (the train step snapshots them for its guard).
An eval function, ``eval_fn(batch) -> sums`` (recurrent: ``eval_fn(batch,
carry) -> (sums, new carry)``), runs the model in eval mode and returns f32
sums that add across batches and workers.

The cross-entropies follow optax on the logits' own dtype: the integer-label
form is ``logsumexp(logits) - logits[label]`` and the soft-target form
``-sum(target * log_softmax(logits))``, each in the logits' dtype (bf16 for
the Transformer at bf16, whose tied projection gives bf16 logits), with the
products by an f32 target or mask, and the sums, in f32.

The CTC loss is ``optax.ctc_loss``'s on f32 logits ``[B, T', C]`` with
every frame valid, blank 0 and label 0 as padding (labels sit at the front
of each row): ``F.ctc_loss`` on ``log_softmax(logits)``, the NLL of each
row, without ``'mean'``'s division by the target lengths. It runs in f64
and returns f32: in f32 its alpha-beta sums put ~4e-6 of absolute error
into a gradient of magnitude 0.2, two to five times optax's own. Where no
alignment exists (more labels, with their repeats, than frames) optax
gives a large finite loss (its log-zero is -1e5) and ``F.ctc_loss``
``inf``. The character error rate decodes greedily (per-frame arg-max,
repeats collapsed, blanks dropped) and counts Levenshtein edits against
each reference, exactly, on the host.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet channel statistics (mean, std) for uint8 pixel batches
IMAGENET_NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

Norm = Tuple[Sequence[float], Sequence[float]]
_INV255 = float(np.float32(1.0) / np.float32(255.0))


@functools.lru_cache(maxsize=8)
def _norm_constants(input_norm: Norm, device: torch.device):
    """``(-mean as f64, f32(1 / std))`` on ``device``, made once: a fresh
    host-to-device copy each step would wait for the device's queue."""
    mean, std = (np.asarray(v, np.float32) for v in input_norm)
    return (torch.tensor(-mean, dtype=torch.float64, device=device),
            torch.tensor(np.float32(1.0) / std, device=device))


def _prep_pixels(x: torch.Tensor, input_norm: Optional[Norm]) -> torch.Tensor:
    """Normalise uint8 pixels on the device: ``(x / 255 - mean) / std`` in
    f32, rounded as XLA lowers the reference's expression on the CPU — a
    multiply by f32(1/255) and the subtraction in one fused multiply-add
    (one rounding; exact here through f64, whose 53 bits hold the whole
    sum), then a multiply by the f32 reciprocal of ``std``. Float inputs
    pass through untouched."""
    if input_norm is None or x.dtype != torch.uint8:
        return x
    neg_mean, inv_std = _norm_constants(input_norm, x.device)
    return (x.double() * _INV255 + neg_mean).float() * inv_std


def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels`` over the last
    axis, in the logits' dtype."""
    picked = logits.gather(-1, y.long().unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - picked


def _smoothed_ce(logits: torch.Tensor, y: torch.Tensor,
                 smoothing: float) -> torch.Tensor:
    """optax's ``softmax_cross_entropy`` against the target ``onehot(y) *
    (1 - eps) + eps / V``, in f32: ``-((1 - eps) * logp[y] + (eps / V) *
    sum(logp))`` with ``logp = log_softmax(logits)`` in the logits' dtype.
    The same function as the reference's, summed in another order; the
    ``[..., V]`` target is never made."""
    logp = torch.log_softmax(logits, dim=-1).float()
    picked = logp.gather(-1, y.long().unsqueeze(-1)).squeeze(-1)
    v = logits.shape[-1]
    return -((1.0 - smoothing) * picked + (smoothing / v) * logp.sum(-1))


def decoder_input(tgt: torch.Tensor) -> torch.Tensor:
    """Teacher forcing: the target shifted right by one, pad id 0 in
    front."""
    return torch.nn.functional.pad(tgt[:, :-1], (1, 0))


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each sequence's CTC negative log-likelihood ``[B]`` f32 (``optax.
    ctc_loss`` with no logit padding and ``labels == 0`` as label
    padding)."""
    logp = torch.log_softmax(logits.double(), dim=-1).transpose(0, 1)
    frames = torch.full((logits.shape[0],), logits.shape[1],
                        dtype=torch.long, device=logits.device)
    return F.ctc_loss(logp, labels.long(), frames, (labels != 0).sum(-1),
                      blank=0, reduction="none").float()


def ctc_greedy_decode(logits: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode: ``(ids, mask)`` with ``ids`` the per-frame
    arg-max ``[B, T']`` and ``mask`` the frames kept (not blank 0, not a
    repeat of the frame before); the decoded string is ``ids[mask]``."""
    ids = logits.argmax(-1)
    prev = F.pad(ids[:, :-1], (1, 0), value=-1)
    return ids, (ids != 0) & (ids != prev)


def char_error_counts(logits: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(edit distance sum, reference character sum)`` of a batch, f32 on
    ``logits``' device: the Levenshtein distance of each greedy decode to
    its labels (``labels == 0`` is padding), the CER's numerator and
    denominator. The dynamic programme runs on the host over the hypothesis
    frames, a row a frame for the whole batch: ``new[j] = min(row[j] + 1,
    new[j - 1] + 1, row[j - 1] + cost)`` as ``j + cummin(tmp - j)``;
    frames the decode drops leave the row as it is."""
    hyp, keep = (t.cpu() for t in ctc_greedy_decode(logits))
    ref = labels.cpu().long()
    j = torch.arange(ref.shape[1] + 1)
    row = j.expand(ref.shape[0], -1)
    for t in range(hyp.shape[1]):
        cost = (hyp[:, t:t + 1] != ref).long()
        tmp = torch.cat([row[:, :1] + 1, torch.minimum(
            row[:, 1:] + 1, row[:, :-1] + cost)], dim=1)
        new = torch.cummin(tmp - j, dim=1).values + j
        row = torch.where(keep[:, t:t + 1], new, row)
    ref_len = (ref != 0).sum(-1)
    edits = row.gather(1, ref_len[:, None])
    return (torch.tensor(float(edits.sum()), device=logits.device),
            torch.tensor(float(ref_len.sum()), device=logits.device))


def _lm_logits(out):
    """A language model's logits: the LSTM returns ``(logits, carry)``,
    the transformer LM its logits alone."""
    return out[0] if isinstance(out, tuple) else out


def make_loss_fn(model: torch.nn.Module, task: str = "classify",
                 input_norm: Optional[Norm] = None,
                 label_smoothing: float = 0.0,
                 recurrent: bool = False) -> Callable:
    """The train loss of ``task``:

    * ``classify``: softmax cross-entropy (mean over the batch) on f32
      logits, the batch accuracy as ``aux["acc"]``. ``input_norm`` = (mean,
      std) for uint8 pixel batches, applied on the device
      (``_prep_pixels``);
    * ``lm``: the cross-entropy per token (mean over every token), also as
      ``aux["ce_per_token"]``; ``recurrent`` threads the carry;
    * ``ctc``: the mean over the batch of each sequence's CTC loss
      (``ctc_loss``), also as ``aux["ctc"]``;
    * ``seq2seq``: the cross-entropy (label-smoothed when
      ``label_smoothing`` > 0) over the target tokens that are not pad,
      ``sum(ce * mask) / max(sum(mask), 1)``, and the masked token accuracy
      as ``aux["acc"]``."""
    if recurrent and task != "lm":
        raise ValueError(f"carry threading is for lm models, not {task}")
    if task == "lm":
        def ce_of(logits, y):
            loss = _ce(logits, y).mean()
            return loss, {"ce_per_token": loss.detach()}

        if recurrent:
            def loss_fn(batch, carry):
                x, y = batch
                logits, new_carry = model(x, train=True, carry=carry)
                return ce_of(logits, y) + (new_carry,)
            return loss_fn

        def loss_fn(batch):
            x, y = batch
            return ce_of(_lm_logits(model(x, train=True)), y)
        return loss_fn
    if task == "seq2seq":
        def loss_fn(batch):
            src, tgt = batch
            logits = model(src, decoder_input(tgt), train=True)
            mask = (tgt != 0).float()
            ce = (_smoothed_ce(logits, tgt, label_smoothing)
                  if label_smoothing > 0 else _ce(logits, tgt))
            denom = torch.clamp(mask.sum(), min=1.0)
            loss = (ce * mask).sum() / denom
            acc = ((logits.argmax(-1) == tgt) * mask).sum() / denom
            return loss, {"acc": acc.detach()}
        return loss_fn
    if task == "ctc":
        def loss_fn(batch):
            x, labels = batch
            loss = ctc_loss(model(x, train=True), labels).mean()
            return loss, {"ctc": loss.detach()}
        return loss_fn
    if task != "classify":
        raise ValueError(f"unknown task {task!r}")

    def loss_fn(batch):
        x, y = batch
        logits = model(_prep_pixels(x, input_norm), train=True).float()
        y = y.long()
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, {"acc": acc.detach()}

    return loss_fn


def make_eval_fn(model: torch.nn.Module, task: str = "classify",
                 input_norm: Optional[Norm] = None,
                 recurrent: bool = False) -> Callable:
    """The eval sums of ``task``, f32, so a distributed pass adds them
    across workers. Eval mode: the running BatchNorm statistics, no
    dropout, no gradient.

    * ``classify``: ``{"loss_sum", "top1", "top5", "n"}``: the softmax
      cross-entropy of the f32 logits, the rows whose label is the
      arg-max, the rows whose label is among the 5 largest logits, and the
      row count; uint8 pixels normalised as in training;
    * ``lm``: ``{"loss_sum", "n"}`` over every token; ``recurrent`` threads
      the carry: ``eval_fn(batch, carry) -> (sums, new carry)``;
    * ``ctc``: ``{"loss_sum", "cer_edit_sum", "cer_ref_sum", "n"}``: the
      CTC losses, the greedy decodes' edit distances and the reference
      characters (``char_error_counts``), and the row count;
    * ``seq2seq``: ``{"loss_sum", "top1", "n"}`` over the target tokens
      that are not pad (the cross-entropy without smoothing)."""
    if recurrent and task != "lm":
        raise ValueError(f"carry threading is for lm models, not {task}")
    if task == "lm":
        def lm_sums(logits, y):
            return {"loss_sum": _ce(logits, y).sum(),
                    "n": torch.tensor(float(y.numel()),
                                      device=logits.device)}

        if recurrent:
            @torch.no_grad()
            def eval_fn(batch, carry):
                x, y = batch
                logits, new_carry = model(x, train=False, carry=carry)
                return lm_sums(logits, y), new_carry
            return eval_fn

        @torch.no_grad()
        def eval_fn(batch):
            x, y = batch
            return lm_sums(_lm_logits(model(x, train=False)), y)
        return eval_fn
    if task == "seq2seq":
        @torch.no_grad()
        def eval_fn(batch):
            src, tgt = batch
            logits = model(src, decoder_input(tgt), train=False)
            mask = (tgt != 0).float()
            return {"loss_sum": (_ce(logits, tgt) * mask).sum(),
                    "top1": ((logits.argmax(-1) == tgt) * mask).sum(),
                    "n": mask.sum()}
        return eval_fn
    if task == "ctc":
        @torch.no_grad()
        def eval_fn(batch):
            x, labels = batch
            logits = model(x, train=False)
            edit_sum, ref_sum = char_error_counts(logits, labels)
            return {"loss_sum": ctc_loss(logits, labels).sum(),
                    "cer_edit_sum": edit_sum, "cer_ref_sum": ref_sum,
                    "n": torch.tensor(float(labels.shape[0]),
                                      device=logits.device)}
        return eval_fn
    if task != "classify":
        raise ValueError(f"unknown task {task!r}")

    @torch.no_grad()
    def eval_fn(batch):
        x, y = batch
        logits = model(_prep_pixels(x, input_norm), train=False).float()
        y = y.long()
        top = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
        return {"loss_sum": F.cross_entropy(logits, y, reduction="sum"),
                "top1": (logits.argmax(-1) == y).sum().float(),
                "top5": (top == y[:, None]).any(-1).sum().float(),
                "n": torch.tensor(float(y.shape[0]), device=logits.device)}

    return eval_fn
