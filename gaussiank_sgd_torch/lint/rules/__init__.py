"""gklint rule registry (port of ``gaussiank_sgd_tpu/lint/rules``).

Every rule module exposes a ``Rule`` class with ``name``, ``severity``,
``description`` and ``check(ctx) -> Iterator[Finding]``. The port carries
the four rules that hold for torch code, in the reference's order; the
reference's ``host-sync-in-hot-path``, ``recompile-hazard``,
``mesh-axis-consistency``, ``donation-check`` and ``traced-control-flow``
read JAX's staging (the code under ``jit``/``shard_map``), and the port
compiles and captures nothing. A warm step's host syncs are counted on
the card by ``lint audit`` instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from . import fail_loud, lock_discipline, pipeline_funnel, print_in_library

ALL_RULES = [
    fail_loud.Rule(),
    print_in_library.Rule(),
    pipeline_funnel.Rule(),
    lock_discipline.Rule(),
]

RULES_BY_NAME = {r.name: r for r in ALL_RULES}


def select_rules(names: Optional[Sequence[str]] = None) -> List[object]:
    if not names:
        return list(ALL_RULES)
    unknown = [n for n in names if n not in RULES_BY_NAME]
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)} "
                       f"(available: {', '.join(sorted(RULES_BY_NAME))})")
    return [RULES_BY_NAME[n] for n in names]
