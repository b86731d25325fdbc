"""``python -m gaussiank_sgd_torch.service`` — run one job elastically
(port of ``gaussiank_sgd_tpu/service/__main__.py``).

The launcher CLI (``training.launch``, with its ``--dist-backend``) plus
the service layer: resize bounds/budgets, a control file for live
operator commands, a scripted ``--resize-at`` schedule (deterministic
operator actions for chaos tests), and optionally a scheduler-mode health
server with per-job routes. Workers are spawned through the launch
module's ``--worker`` entry point, so this process never imports torch.
On one card, several gloo ranks share it::

  python -m gaussiank_sgd_torch.service --nprocs 2 --dist-backend gloo \
      --config exp_configs/config2_vgg16_cifar10_gaussian.json \
      --compressor gaussian_fused --compress-warmup-steps 2 --max-steps 12 \
      --save-every-steps 2 --resize-at 4:3 --resize-at 8:2 --run-id elastic
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional, Tuple

from ..training import config as config_mod
from ..training.launch import LaunchConfig
from .resize import ResizePolicy
from .supervisor import ElasticSupervisor


def _parse_resize_at(values: List[str]) -> List[Tuple[int, int]]:
    out = []
    for value in values or []:
        step, sep, n = value.partition(":")
        if not sep:
            raise SystemExit(
                f"--resize-at expects STEP:N, got {value!r}")
        out.append((int(step), int(n)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.service",
        description="elastic autoscaling pod: launcher supervision plus "
                    "resize engine, control plane and per-job health")
    # launcher knobs (mirrors training.launch)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--dist-backend", dest="dist_backend",
                    choices=("nccl", "gloo"), default=None,
                    help="the workers' process-group backend (default: "
                         "nccl on cards, gloo on the CPU); gloo lets "
                         "several ranks share one card")
    ap.add_argument("--heartbeat-timeout", type=float, default=300.0,
                    dest="heartbeat_timeout_s")
    ap.add_argument("--poll-interval", type=float, default=0.2,
                    dest="poll_s")
    ap.add_argument("--grace", type=float, default=20.0, dest="grace_s")
    ap.add_argument("--max-relaunches", type=int, default=2)
    ap.add_argument("--bootstrap-timeout", type=float, default=60.0,
                    dest="bootstrap_timeout_s")
    ap.add_argument("--bootstrap-retries", type=int, default=4)
    ap.add_argument("--kill-step", type=int, default=None,
                    help="chaos: SIGKILL --kill-proc at this step")
    ap.add_argument("--kill-proc", type=int, default=0)
    ap.add_argument("--preempt-step", type=int, default=None,
                    help="chaos: SIGTERM --preempt-proc at this step "
                         "(graceful preemption)")
    ap.add_argument("--preempt-proc", type=int, default=0)
    # service knobs
    ap.add_argument("--min-nprocs", type=int, default=1)
    ap.add_argument("--max-nprocs", type=int, default=64)
    ap.add_argument("--resize-step-budget", type=int, default=50,
                    help="max merged steps one resize may roll back")
    ap.add_argument("--resize-wall-budget", type=float, default=600.0,
                    help="max seconds from directive to all new workers' "
                         "first heartbeat")
    ap.add_argument("--max-resizes", type=int, default=16)
    ap.add_argument("--drain-grace", type=float, default=3.0,
                    help="seconds a clean worker exit (peers live) must "
                         "persist before it counts as preemption drain")
    ap.add_argument("--control-file", type=str, default=None,
                    help="operator command file (default: "
                         "<pod_dir>/control.json)")
    ap.add_argument("--resize-at", action="append", default=[],
                    metavar="STEP:N",
                    help="scripted operator resize: re-mesh to N once "
                         "merged progress reaches STEP (repeatable)")
    ap.add_argument("--service-health-port", type=int, default=None,
                    help="serve /healthz/<job> and /metrics/<job> for "
                         "this job on a scheduler-mode health server")
    config_mod.add_args(ap)
    args = ap.parse_args(argv)
    cfg = config_mod.from_args(args, argv)

    launch = LaunchConfig(
        nprocs=args.nprocs,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        grace_s=args.grace_s, poll_s=args.poll_s,
        max_relaunches=args.max_relaunches,
        bootstrap_timeout_s=args.bootstrap_timeout_s,
        bootstrap_retries=args.bootstrap_retries,
        kill_step=args.kill_step, kill_proc=args.kill_proc,
        preempt_step=args.preempt_step, preempt_proc=args.preempt_proc,
        dist_backend=args.dist_backend)
    policy = ResizePolicy(
        min_nprocs=args.min_nprocs, max_nprocs=args.max_nprocs,
        step_budget=args.resize_step_budget,
        wall_budget_s=args.resize_wall_budget,
        max_resizes=args.max_resizes, drain_grace_s=args.drain_grace)
    pod_dir = os.path.join(cfg.output_dir, cfg.run_id)
    sup = ElasticSupervisor(
        cfg, launch, pod_dir, policy=policy, job=cfg.run_id,
        control_path=args.control_file,
        resize_schedule=_parse_resize_at(args.resize_at))
    server = None
    if args.service_health_port is not None:
        from ..telemetry.health import HealthServer
        server = HealthServer(None, port=args.service_health_port).start()
        server.add_job(sup.job, sup.health)
    try:
        return sup.run()
    finally:
        if server is not None:
            server.close()


if __name__ == "__main__":
    sys.exit(main())
