"""Checkpoints of the HPA controller's state across syncs.

Counterpart of ``k8s_gpu_hpa_tpu/control/checkpoint.py``.  A restarted
controller that forgets its recommendation window can flap: a scale-down
recommended 10 s before the crash fires at once after it, skipping the rest
of ``scaleDown.stabilizationWindowSeconds``.  So ``HPAController`` writes a
small JSON document after every sync and restores it when it is built, and
a restart is invisible to the v2 algorithm.

Schema ``version: 1``, the JAX package's key for key (a file written by
either package restores in the other): everything ``_sync_inner`` reads
across syncs, that is ``recommendations`` (the stabilization ring),
``scale_events`` (the policies' period lookback), ``last_good_sync_at``,
the last ``HPAStatus`` (desired replicas, metric values, reason, the
conditions with their transition times) and the condition history.
``current_replicas`` is not restored: the scale target stays the truth for
it, as the real controller reads the scale subresource again.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Protocol

CHECKPOINT_VERSION = 1


class CheckpointStore(Protocol):
    """Where a controller keeps its state between syncs.  ``load`` returns
    None when there is nothing readable to restore: a cold start, never an
    error."""

    def save(self, state: dict) -> None: ...

    def load(self) -> dict | None: ...


class InMemoryCheckpointStore:
    """Lasts across objects, not processes: the restart faults' store (the
    injectors rebuild the controller in the same process) and the tests'."""

    def __init__(self) -> None:
        self._state: dict | None = None
        self.saves = 0

    def save(self, state: dict) -> None:
        # through JSON and back, so that it is never more lenient than the
        # file store (tuple keys, NaN)
        self._state = json.loads(json.dumps(state, allow_nan=False))
        self.saves += 1

    def load(self) -> dict | None:
        return self._state


class FileCheckpointStore:
    """One JSON file, replaced atomically (a tmp file and ``os.replace``).
    A missing or torn file loads as None: a controller always comes up, at
    worst cold."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)

    def save(self, state: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(state, fh, separators=(",", ":"), allow_nan=False)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def load(self) -> dict | None:
        try:
            return json.loads(self.path.read_text())
        except (OSError, ValueError):
            return None
