"""A rank past 0 of a cell on several chips: ``python -m gkbench.worker
<spec.json>``, started by ``gkbench.run`` (or ``gkbench.calibrate``, whose
spec lists ``seeds``). It runs its part of the run, hands its numbers to
rank 0 and exits; 3 when a forbidden module was loaded."""

from __future__ import annotations

import json
import sys


def main(path: str) -> int:
    from .run import process_start, run_rank
    t_start = process_start()
    with open(path) as f:
        spec = json.load(f)
    from . import harness, manifest
    cell = manifest.Cell(**spec["cell"])
    import torch.distributed as dist
    if "seeds" in spec:
        from .calibrate import program_steps
        from .run import init_group
        dev = init_group(spec["device"], spec["rank"], cell.chips,
                         spec["port"])
        for _ in program_steps(cell, spec["seeds"], dev, spec["rank"]):
            pass
    else:
        prog, _ = run_rank(spec, t_start, cell)
        dist.all_gather_object([None] * cell.chips, prog.local)
    dist.destroy_process_group()
    found = harness.forbidden_modules()
    if found:
        print(f"gkbench worker: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
