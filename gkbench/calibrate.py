"""The readings the check's limits are set from, on the chip at the cell's
own size: ``python3 -m gkbench.calibrate --workload <cell> --seeds <n>...
[--program] [--control] [--bf16] [--faults]``.

For each seed, each number of ``check.py`` for:

* ``program``: the program's first steps, as a run makes them (every
  rank of the cell; ranks past 0 run ``gkbench.worker``);
* ``fp8``: the control, the reference put in the program's place and
  computed one precision below the configuration's bfloat16
  (``reference/lowp.py``);
* ``bf16`` (``--bf16``): the reference put in the program's place at the
  configuration's own bfloat16, a second witness beside the program of
  what that rounding alone does to each number;
* each fault of ``reference/sgd.py`` the cell can have, planted in the
  reference put in the program's place (``no_exchange`` only on several
  chips). A step that returns its state unchanged reads 1 in
  ``update_gap`` by construction and is not run.

With them, the look at the by-leaf readings (``look``): for the
gradient, the residual and the change, the worst leaf with nothing masked
(``*_raw``) and where it is, how many entries only one side selected in
all and in that leaf (``*_one_side``, ``*_raw_one_side``), that leaf's gap
once they are masked (``*_raw_masked``), and the leaves holding most of
them (``*_most``).

One JSON line a seed and reading on standard output, then the largest and
the smallest of each number by reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import Dict, List, Optional

from . import check

LOOK = ("grad_raw", "residual_raw", "update_raw", "grad_raw_masked",
        "residual_raw_masked", "update_raw_masked", "grad_one_side",
        "residual_one_side", "update_one_side", "grad_raw_one_side",
        "residual_raw_one_side", "update_raw_one_side")


def look(prog, ref, p0, layout, hyper) -> Dict:
    """The by-leaf readings with nothing masked, and the entries only one
    side selected, leaf by leaf."""
    import math
    import torch
    p0 = p0[:prog.params.numel()].float().cpu()
    masks = check.masks(prog, ref, p0, hyper)
    moved = check.moved_leaves(ref.grad1, layout)
    pairs = {"grad": (prog.momentum1, ref.momentum1, None),
             "residual": (prog.residual1, ref.residual1, None),
             "update": (prog.params - p0, ref.params - p0, moved)}
    sizes = [math.prod(s) for _, s in layout]
    out = {}
    for name, (a, b, keep) in pairs.items():
        raw = check.leaf_gaps(a, b, layout, keep)
        masked = dict((leaf, g) for g, leaf in
                      check.leaf_gaps(a, b, layout, keep, masks[name]))
        gap, leaf = max(raw)
        counts = [int(c.sum()) for c in torch.split(
            masks[name][:sum(sizes)], sizes)]
        by_leaf = dict(zip((p for p, _ in layout), counts))
        out[f"{name}_raw"] = (gap, leaf)
        out[f"{name}_raw_masked"] = (masked[leaf], leaf)
        out[f"{name}_one_side"] = (sum(counts), "entries")
        out[f"{name}_raw_one_side"] = (by_leaf[leaf], leaf)
        out[f"{name}_most"] = sorted(
            ((c, p) for p, c in by_leaf.items() if c), reverse=True)[:3]
    return out


def _line(seed: int, kind: str, numbers, looked) -> Dict:
    out = {"seed": seed, "reading": kind}
    for name in check.NUMBERS + LOOK:
        got = numbers if name in check.NUMBERS else looked
        out[name] = got[name][0]
        out[f"{name}_at"] = got[name][1]
    for name in ("grad", "residual", "update"):
        out[f"{name}_most"] = looked[f"{name}_most"]
    return out


def reading(cell, seed, dev, prog, precision="float32", fault=None,
            ref=None):
    """``(numbers, look, reference steps)`` of one reading: the program's
    steps ``prog``, or with ``prog`` None the reference's at ``precision``
    with ``fault`` put in its place."""
    from . import harness
    from .weights import make_weights
    if prog is None:
        prog = harness.reference_steps(cell, seed, dev, precision, fault)
    numbers, ref = harness.reference_numbers(cell, seed, dev, prog, ref=ref)
    model = harness.reference_model(cell.config)
    looked = look(prog, ref, make_weights(model.layout, seed, dev),
                  model.layout, harness.hyper(cell))
    return numbers, looked, ref


def program_steps(cell, seeds: List[int], dev, rank: int):
    """Every rank: the program's first steps for each seed in turn, the
    ranks meeting at a barrier after each (rank 0 compares meanwhile)."""
    import torch.distributed as dist
    from . import harness
    for seed in seeds:
        yield seed, harness.first_steps(cell, seed, dev, rank)
        if dist.is_initialized():
            dist.barrier()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    from . import harness, manifest
    from .reference import sgd
    from .run import _Workers, _cell_dict, _free_port, init_group
    cell = manifest.load_cell(args.workload)
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    refs = {}
    if args.program:
        port = _free_port()
        spec = {"workload": cell.name, "device": args.device, "port": port,
                "seeds": args.seeds, "cell": _cell_dict(cell)}
        with tempfile.TemporaryDirectory(prefix="gkbench-ranks-") as d:
            workers = (_Workers([dict(spec, rank=r)
                                 for r in range(1, cell.chips)], d)
                       if cell.chips > 1 else None)
            dev = init_group(args.device, 0, cell.chips, port)
            for seed, steps in program_steps(cell, args.seeds, dev, 0):
                numbers, looked, refs[seed] = reading(cell, seed, dev, steps)
                emit(_line(seed, "program", numbers, looked))
            if workers is not None:
                torch.distributed.destroy_process_group()
                if any(workers.join(120.0)):
                    return 1
    else:
        dev = init_group(args.device, 0, 1, 0)
    kinds = (["fp8"] if args.control else []) + (
        ["bf16"] if args.bf16 else []) + (
        [f for f in sgd.FAULTS if cell.chips > 1 or f != "no_exchange"]
        if args.faults else [])
    for seed in args.seeds:
        for kind in kinds:
            precision = {"fp8": "fp8", "bf16": "bfloat16"}.get(kind,
                                                               "float32")
            fault = None if kind in ("fp8", "bf16") else kind
            numbers, looked, refs[seed] = reading(
                cell, seed, dev, None, precision, fault, refs.get(seed))
            emit(_line(seed, kind, numbers, looked))
    for kind in sorted({line["reading"] for line in lines}):
        got = [line for line in lines if line["reading"] == kind]
        print(json.dumps({"reading": kind, "seeds": len(got), **{
            name: {"max": max(g[name] for g in got),
                   "min": min(g[name] for g in got)}
            for name in check.NUMBERS + LOOK}}), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"gkbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
