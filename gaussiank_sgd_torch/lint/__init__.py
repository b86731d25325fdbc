"""gklint for the PyTorch port (port of the portable tiers of
``gaussiank_sgd_tpu/lint``).

Four AST rules, with the reference's names, severities and messages:
fail-loud, print-in-library, collective-outside-pipeline (torch's
collectives and the port's funnels) and lock-discipline; the host tiers
``lint concurrency`` (lint/concurrency.py: per-class lock model,
callback/blocking-under-lock, thread escapes) and ``lint events``
(lint/event_contract.py: publish sites against the port's
``telemetry/events.py``, ratcheted in ``.gklint-torch-events.json``); and
``lint audit`` (lint/program_audit.py), which runs a step of each arm of
the reference's audit matrix and checks its host syncs, its collective
inventory and the two identities, ratcheted in
``.gklint-torch-programs.json``.

CLI: ``python -m gaussiank_sgd_torch.lint [--json] [paths...]`` — exits
nonzero on findings not in the committed baseline
(``.gklint-torch-baseline.json``), 2 on a suppression without a ``--
justification``. The AST, ``concurrency`` and ``events`` tiers import no
torch. Library entry points:

    from gaussiank_sgd_torch.lint import lint_source, lint_paths
"""

from .baseline import (default_baseline_path, load_baseline, split_new,
                       write_baseline)
from .core import (Finding, Suppression, lint_paths, lint_paths_detailed,
                   lint_source, lint_source_detailed)
from .rules import ALL_RULES, RULES_BY_NAME, select_rules

__all__ = [
    "ALL_RULES", "Finding", "RULES_BY_NAME",
    "Suppression", "default_baseline_path", "lint_paths",
    "lint_paths_detailed", "lint_source", "lint_source_detailed",
    "load_baseline", "select_rules", "split_new", "write_baseline",
]
