"""Operator control plane — a file-based command channel (port of
``gaussiank_sgd_tpu/service/control.py``).

Operators (or tests, or a cluster agent) atomically write commands to a
well-known file in the pod directory; the elastic supervisor polls and
*consumes* it (read + unlink) from its watch loop.  One JSON object per
line::

    {"cmd": "resize", "nprocs": 4}     re-mesh to 4 workers
    {"cmd": "stop"}                    graceful shutdown (exit 143)

A file is the right transport here for the same reason heartbeats are
files: it needs no ports, survives supervisor restarts, and `tmp +
os.replace` gives writers atomicity for free.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


class ControlPlane:
    """Single-consumer command file with torn-write tolerance.

    A non-atomic writer can race the poll and hand us half a line.  In
    that case the file is left in place and re-read next poll, up to
    ``max_retries`` consecutive bad polls — then it is consumed anyway
    and counted in ``rejected``, so a permanently-garbled file cannot
    wedge the supervisor loop.
    """

    def __init__(self, path: str, max_retries: int = 3):
        self.path = str(path)
        self.max_retries = int(max_retries)
        #: command files consumed without yielding a single valid command.
        self.rejected = 0
        self._bad_polls = 0

    def poll(self) -> List[Dict[str, Any]]:
        """Commands written since the last poll, oldest first."""
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                raw = fh.read()
        except OSError:
            return []
        cmds = self._parse(raw)
        if cmds is None:
            self._bad_polls += 1
            if self._bad_polls <= self.max_retries:
                return []  # possibly a torn write: retry next poll
            self.rejected += 1
            cmds = []
        self._bad_polls = 0
        try:
            os.remove(self.path)
        except OSError:
            pass  # writer replaced it mid-consume; next poll picks it up
        return cmds

    @staticmethod
    def _parse(raw: str) -> Optional[List[Dict[str, Any]]]:
        if not raw.strip():
            return None
        out: List[Dict[str, Any]] = []
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                return None
            if not isinstance(obj, dict) or "cmd" not in obj:
                return None
            out.append(obj)
        return out

    @staticmethod
    def write(path: str, *cmds: Dict[str, Any]) -> None:
        """Atomic writer half (tmp + replace), for operators and tests."""
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for cmd in cmds:
                fh.write(json.dumps(cmd) + "\n")
        os.replace(tmp, path)
