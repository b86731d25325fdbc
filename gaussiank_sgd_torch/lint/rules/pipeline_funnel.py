"""Rule: collective-outside-pipeline (port of
``gaussiank_sgd_tpu/lint/rules/pipeline_funnel.py``).

The port keeps the reference's invariant: the bucket-pipelined step
(``parallel/trainstep.py``) only hides exchange latency when every
payload collective is issued through one of its funnels. A raw payload
collective added elsewhere in ``parallel/`` bypasses the eligibility gate
(the collective runs sequentially even when the build says "pipelined"),
the ``sparse_noexch`` twin (``exposed_exchange_ms`` stops ablating it)
and the overlapped-bytes accounting. This rule flags payload collectives
in ``parallel/`` whose enclosing-function chain contains no funnel name;
deliberately sequential call sites (``parallel/collectives.py``'s
primitives and ``DPMesh.gather``) carry an inline suppression with their
justification.

The vocabulary is torch's: ``all_gather``, ``all_gather_into_tensor``,
``batch_isend_irecv``, ``isend`` and ``irecv``. The funnels are the
port's own: ``_pipelined_phase`` and its ``_launch`` (the pipelined
schedule), ``butterfly_rounds`` (gTop-k's rounds, ``parallel/gtopk.py``),
and ``ring_attention`` with its hop ``_rotate`` — the K/V rotation is
model compute inside the ring, not a gradient-exchange payload.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from ..core import Finding, ModuleCtx

NAME = "collective-outside-pipeline"
SEVERITY = "error"

#: payload collectives the pipelined schedule must own
_PAYLOAD_COLLECTIVES = {"all_gather", "all_gather_into_tensor",
                        "batch_isend_irecv", "isend", "irecv"}

#: enclosing-def names through which payload collectives may be issued
_SANCTIONED_FUNNELS = {"_pipelined_phase", "_launch", "butterfly_rounds",
                       "ring_attention", "_rotate"}


def _terminal_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


class Rule:
    name = NAME
    severity = SEVERITY
    description = ("torch payload collectives (all_gather, "
                   "all_gather_into_tensor, batch_isend_irecv, isend, irecv)"
                   " in parallel/ must be issued through a sanctioned "
                   "pipeline funnel (_pipelined_phase, _launch, "
                   "butterfly_rounds, ring_attention)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if os.path.basename(os.path.dirname(ctx.path)) != "parallel":
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and _terminal_name(node.func) in _PAYLOAD_COLLECTIVES):
                continue
            chain = [a.name for a in ctx.ancestors(node)
                     if isinstance(a, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]
            if any(name in _SANCTIONED_FUNNELS for name in chain):
                continue
            fname = _terminal_name(node.func)
            # the reference reports this rule's column 0-based; kept so the
            # two tools' findings compare field for field
            yield Finding(
                rule=self.name, severity=self.severity, path=ctx.path,
                line=node.lineno, col=node.col_offset,
                end_line=getattr(node, "end_lineno", 0) or 0,
                message=(f"payload collective {fname}() issued outside "
                         f"the sanctioned pipeline funnels "
                         f"({', '.join(sorted(_SANCTIONED_FUNNELS))}): "
                         f"it bypasses the overlap eligibility gate, the "
                         f"noexch ablation twin, and the overlapped-bytes "
                         f"accounting (parallel/trainstep.py)"),
                source_line=ctx.src(node))
