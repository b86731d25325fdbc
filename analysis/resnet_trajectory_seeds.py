#!/usr/bin/env python3
"""Readings of the ResNet-50 ``gaussian_fused`` trajectory parity test over
seeds, on the CPU, for setting and checking its tolerances.

    JAX_PLATFORMS=cpu python3 analysis/resnet_trajectory_seeds.py [--seeds 6,7 1,2 ...]

Each pair is (weight seed, batch seed) for
``tests/test_torch_resnet.py:_trajectory``: ResNet-50 at full width with
one block a stage, 64^2 uint8 input, 1 dense + 2 sparse steps, the port
against the reference's ``build_dp_train_step``. The test's own assertions
hold on every pair. Prints one JSON line a pair: each step's relative loss
gap, the share of k sent by one trajectory and not the other on each sparse
step (cold first), and the final BatchNorm statistics' largest gap.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", nargs="+",
                   default=["6,7", "1,2", "3,4", "8,9", "10,11", "12,13"])
    args = p.parse_args()
    from tests.test_torch_resnet import _trajectory
    for pair in args.seeds:
        seeds = tuple(int(s) for s in pair.split(","))
        _, _, readings = _trajectory("resnet50_1111", "gaussian_fused",
                                     ["dense", "sparse", "sparse"], 4,
                                     u8=True, seeds=seeds)
        print(json.dumps({"seeds": seeds, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
