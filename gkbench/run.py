"""The benchmark of ``gaussiank_sgd_torch``: one run of one cell.

    python3 -m gkbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic and
metrics are in ``BENCHMARK.json`` and the files it names under
``gkbench/``. A run builds the cell's ``Trainer`` (one process a card:
ranks past 0 run ``gkbench.worker``), hands it the benchmark's seeded
weights, checks its first steps, warms up, then drives ``Trainer.train``
for ``--seconds`` on a closed loop of seeded batches. It prints its
end-to-end metrics (``--trace 0``) or its per-layer ones (``--trace 1``,
from ``torch.profiler`` over a stretch of the window) as the last line of
standard output, one JSON object, and the compared numbers with their
limits as the last lines of standard error. No card, too few cards, a
failed rank or a forbidden module loaded: a nonzero exit and no result.
"""

from __future__ import annotations

import os
import time

_IMPORTED = time.time()
# one process a card with few threads, as torchrun starts its workers: the
# step is launched by one host thread, and idle OpenMP workers spinning on
# a shared host only take cycles from it
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import datetime  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402


def process_start() -> float:
    """The wall-clock time this process started (Linux), else when this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Workers:
    """Ranks 1.. of a cell as processes of ``gkbench.worker``, watched: a
    rank that fails ends the run."""

    def __init__(self, specs: List[Dict], spec_dir: str):
        self.procs = []
        for spec in specs:
            path = os.path.join(spec_dir, f"rank{spec['rank']}.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            # their standard output goes to standard error: the result is
            # rank 0's last line
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "gkbench.worker", path],
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))), stdout=2))
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watcher, daemon=True)
        self._watch.start()

    def _watcher(self) -> None:
        while not self._done.wait(0.5):
            for p in self.procs:
                rc = p.poll()
                if rc not in (None, 0):
                    print(f"gkbench: rank worker {p.args[-1]} exited {rc}",
                          file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(1)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def join(self, timeout: float) -> List[int]:
        """Wait for every rank; stop the watcher. Their exit codes."""
        self._done.set()
        self._watch.join()
        deadline = time.monotonic() + timeout
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        return codes


def init_group(device: str, rank: int, world: int, port: int):
    """This rank's device, joined to the group of ``world`` ranks."""
    import torch
    import torch.distributed as dist
    dev = (torch.device("cuda", rank) if device == "cuda"
           else torch.device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=300))
    return dev


def run_rank(spec: Dict, t_start: float, cell=None):
    """One rank of a run from its spec: ``(program part, device)``; the
    process group is left for the caller to close."""
    from . import harness, manifest
    cell = manifest.load_cell(spec["workload"]) if cell is None else cell
    dev = init_group(spec["device"], spec["rank"], cell.chips, spec["port"])
    prog = harness.run_program(cell, spec["seed"], spec["seconds"],
                               spec["trace"], dev, spec["rank"], cell.chips,
                               t_start)
    return prog, dev


def run_cell(cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[Dict] = None) -> Dict:
    """The run as rank 0 drives it: the other ranks started, this rank's
    part, their numbers gathered, the reference, the result."""
    import torch
    from . import check, harness, manifest
    t_start = process_start() if t_start is None else t_start
    bench = manifest.load_manifest() if bench is None else bench
    port = _free_port()
    spec = {"workload": cell.name, "seed": int(seed), "seconds": seconds,
            "trace": bool(traced), "device": device, "port": port,
            "rank": 0}
    workers = None
    with tempfile.TemporaryDirectory(prefix="gkbench-ranks-") as spec_dir:
        if cell.chips > 1:
            workers = _Workers([dict(spec, rank=r, cell=_cell_dict(cell))
                                for r in range(1, cell.chips)], spec_dir)
        try:
            prog, dev = run_rank(spec, t_start, cell)
            ranks = [prog.local]
            if cell.chips > 1:
                import torch.distributed as dist
                ranks = [None] * cell.chips
                dist.all_gather_object(ranks, prog.local)
                dist.destroy_process_group()
                codes = workers.join(120.0)
                if any(codes):
                    raise RuntimeError(f"rank workers exited {codes}")
        except BaseException:
            if workers is not None:
                workers.kill()
            raise
    ctx = prog.ctx
    print("gkbench: set-up " + ", ".join(
        f"{name} {s:.3f} s" for name, s in ctx.setup_phases),
        file=sys.stderr)
    print(f"gkbench: {ctx.steps} steps in the window "
          f"({ctx.window_s:.3f} s): the samples of a per-step percentile",
          file=sys.stderr, flush=True)
    limits = cell.setup["limits"]
    numbers, _ = harness.reference_numbers(cell, seed, dev, prog.steps,
                                           names=limits)
    checks = {name: {"value": numbers[name][0], "limit": limits[name]}
              for name in check.NUMBERS if name in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in manifest.metrics_for(bench, cell.name, kind):
        if traced:
            vals = [r["per_layer"][m["name"]] for r in ranks
                    if m["name"] in r["per_layer"]]
            value = sum(vals) / len(vals) if len(vals) == len(ranks) else None
        else:
            value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    result = {"correct": correct, "attempted": ctx.steps,
              "failed": ctx.skipped, "metrics": metrics,
              "device": device_info}
    if traced:
        busy = [r["busy_s"] for r in ranks if r["busy_s"] is not None]
        wins = [r["window_s"] for r in ranks if r["window_s"] is not None]
        if busy and wins:
            device_info["busy_s"] = sum(busy) / len(busy)
            device_info["window_s"] = sum(wins) / len(wins)
        if ctx.summary is not None:
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in ctx.summary.device_ops],
                "idle_gaps": [[n, s] for n, s in ctx.summary.idle_gaps]}
    for name in checks:
        print(f"check {name} {numbers[name][0]!r} limit "
              f"{limits[name]!r} ({numbers[name][1]})",
              file=sys.stderr)
    result["checks"] = checks
    return result


def _cell_dict(cell) -> Dict:
    """A cell as a worker's spec carries it (tests run cells that
    ``BENCHMARK.json`` does not name)."""
    return {"name": cell.name, "chips": cell.chips,
            "config_name": cell.config_name,
            "traffic_name": cell.traffic_name, "config": cell.config,
            "traffic": cell.traffic, "setup": cell.setup}


def card_line() -> Optional[str]:
    """``name, power.limit`` of the card by ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()
    from . import harness, manifest
    cell = manifest.load_cell(args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"gkbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{cards} available", file=sys.stderr)
        return 2
    card = card_line()
    if card:
        print(f"gkbench: card {card} (step_mfu_pct's peak is the published "
              f"dense bf16 rate at the full power limit)", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"gkbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
