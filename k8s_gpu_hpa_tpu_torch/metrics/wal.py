"""Write-ahead log and snapshot store for the TSDB (the durability layer).

Counterpart of ``k8s_gpu_hpa_tpu/metrics/wal.py``.  A real Prometheus
survives a crash because every appended sample reaches a WAL segment before
it is acknowledged, and a periodic head snapshot bounds how much of that
log a restart replays.  This module gives the simulated TSDB both, in one
directory:

- **segments** (``wal-00000000.jsonl`` ...): JSONL in append order, one
  record per accepted ``TimeSeriesDB.append``: ``op: "append"`` for a live
  point, ``op: "stale"`` for a staleness marker (its own op, so NaN never
  goes through JSON), with the point's ``origin`` span id when it has one.
  Each record is flushed as it is written, so a kill can tear at most the
  last line of the last segment.
- **snapshot** (``snapshot.json``): the TSDB's whole retained state (the
  payload ``TimeSeriesDB.snapshot_payload`` builds) and ``covered_through``,
  the index of the newest segment the snapshot subsumes.  It is written
  atomically (a tmp file, fsync, ``os.replace``), and the segments it
  covers are deleted only after the replace, so a crash at any byte leaves
  either the old snapshot and every segment or the new snapshot and the
  tail it does not cover: both replay.

The store round-trips whatever payload the TSDB hands it; the payload's
``format`` is read in one place, ``TimeSeriesDB.recover``.  The files are
the JAX package's, byte for byte where the records are the same, so a
directory either package wrote recovers in the other.  Each record's write
is a ``wal:flush`` profile stage, and the rotation, snapshot, truncation
and replay branches are ``recovery_path:*`` coverage probes (obs/).

Recovery reads the snapshot and then the tail segments in order.  An
undecodable line is tolerated only where a kill can leave one, as the last
line of the last segment (dropped); anywhere else it is corruption and
raises ``WALCorruption``.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.obs import coverage, profile

_SEGMENT_RE = re.compile(r"^wal-(\d{8})\.jsonl$")
SNAPSHOT_NAME = "snapshot.json"


class WALCorruption(Exception):
    """A torn record where no crash could have left one."""


def _segment_name(index: int) -> str:
    return f"wal-{index:08d}.jsonl"


class WriteAheadLog:
    """JSONL segments in append order and an atomic snapshot, in one
    directory.

    One instance owns the directory for one TSDB's life.  A new instance
    over the same directory (the restart path) never appends to a segment
    on disk: it opens a fresh one past the highest, so a torn tail of the
    previous life stays the last line of its segment and replays.
    """

    def __init__(self, directory: str | os.PathLike, segment_max_records: int = 2048):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.segment_max_records = segment_max_records
        existing = self._segment_indices()
        #: the segment the next record goes to (always a fresh one at
        #: construction; see the class docstring)
        self._seg_index = (existing[-1] + 1) if existing else 0
        self._seg_records = 0
        self._fh = None
        #: records written through this instance
        self.records_written = 0

    # ---- write path ---------------------------------------------------------

    def log_append(
        self,
        name: str,
        labels: tuple[tuple[str, str], ...],
        value: float,
        ts: float,
        origin: int | None = None,
        exemplar=None,
    ) -> None:
        """Record one accepted append.  NaN (a staleness marker) is written
        as ``op: "stale"`` with no value; an exemplar
        (``metrics.schema.Exemplar``, a histogram bucket's traced
        observation) rides along with a live point."""
        if value != value:  # NaN
            rec: dict = {"op": "stale", "name": name, "labels": list(labels), "ts": ts}
        else:
            rec = {"op": "append", "name": name, "labels": list(labels), "value": value, "ts": ts}
        if origin is not None:
            rec["origin"] = origin
        if exemplar is not None and rec["op"] == "append":
            rec["exemplar"] = {
                "value": exemplar.value,
                "trace_id": exemplar.trace_id,
                "span_id": exemplar.span_id,
                "ts": exemplar.ts,
            }
        self._write_line(json.dumps(rec, separators=(",", ":")))

    def _write_line(self, line: str) -> None:
        with profile.stage("wal:flush"):
            if self._fh is None or self._seg_records >= self.segment_max_records:
                self._rotate()
            self._fh.write(line + "\n")
            self._fh.flush()
            self._seg_records += 1
            self.records_written += 1

    def _rotate(self) -> None:
        """Seal the open segment, if any, and open the next."""
        if self._fh is not None:
            self._fh.close()
            self._seg_index += 1
            coverage.hit("recovery_path:wal_segment_rotated")
        self._fh = open(self.directory / _segment_name(self._seg_index), "a")
        self._seg_records = 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ---- snapshot and truncation --------------------------------------------

    def write_snapshot(self, payload: dict) -> None:
        """Persist ``payload`` atomically and delete the segments it
        subsumes, in the order a crash needs: seal the open segment, write
        and fsync the tmp file, replace the snapshot, then delete the
        covered segments.  A kill between any two steps leaves a snapshot
        and a tail that replay."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        covered = self._segment_indices()
        covered_through = covered[-1] if covered else self._seg_index
        doc = {"covered_through": covered_through, "payload": payload}
        tmp = self.directory / (SNAPSHOT_NAME + ".tmp")
        with open(tmp, "w") as fh:
            # dumps, not dump: the same bytes, through the C encoder (dump
            # streams through the Python one, slow on per-point triples)
            fh.write(json.dumps(doc, separators=(",", ":"), allow_nan=False))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.directory / SNAPSHOT_NAME)
        coverage.hit("recovery_path:wal_snapshot_written")
        for idx in covered:
            (self.directory / _segment_name(idx)).unlink(missing_ok=True)
        # the next record starts the segment after all the snapshot covers
        self._seg_index = covered_through + 1
        self._seg_records = 0

    def truncate_tail(self, records: int = 64, tear: bool = False) -> int:
        """The ``wal_truncate`` fault: destroy up to ``records`` lines at the
        end of the newest segment and, with ``tear``, leave a partial record
        behind.  Returns how many whole records were lost."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        indices = self._segment_indices()
        if not indices:
            return 0
        path = self.directory / _segment_name(indices[-1])
        lines = path.read_text().splitlines()
        lost = min(records, len(lines))
        body = "".join(line + "\n" for line in lines[: len(lines) - lost])
        if tear:
            body += '{"op":"append","name":"torn_mid_rec'
        path.write_text(body)
        coverage.hit("recovery_path:wal_tail_truncated")
        return lost

    # ---- read path ----------------------------------------------------------

    def read(self) -> tuple[dict | None, list[dict]]:
        """``(snapshot payload or None, tail records)``: all a recovery
        needs, in replay order.  Tolerates one torn line, the last line of
        the last segment."""
        payload: dict | None = None
        covered_through = -1
        snap_path = self.directory / SNAPSHOT_NAME
        if snap_path.exists():
            try:
                doc = json.loads(snap_path.read_text())
                payload = doc["payload"]
                covered_through = doc["covered_through"]
            except (ValueError, KeyError) as exc:
                coverage.hit("recovery_path:wal_corruption_detected")
                raise WALCorruption(f"unreadable snapshot {snap_path}: {exc}") from exc
            coverage.hit("recovery_path:wal_replay_snapshot")
        else:
            coverage.hit("recovery_path:wal_replay_cold")
        records: list[dict] = []
        indices = [i for i in self._segment_indices() if i > covered_through]
        for pos, idx in enumerate(indices):
            path = self.directory / _segment_name(idx)
            lines = path.read_text().splitlines()
            last_segment = pos == len(indices) - 1
            for lineno, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError as exc:
                    if last_segment and lineno == len(lines) - 1:
                        # the one tear a kill can leave: dropped
                        coverage.hit("recovery_path:wal_torn_tail_dropped")
                        continue
                    coverage.hit("recovery_path:wal_corruption_detected")
                    raise WALCorruption(f"torn record mid-log ({path.name}:{lineno + 1})") from exc
        return payload, records

    # ---- introspection ------------------------------------------------------

    def _segment_indices(self) -> list[int]:
        out = []
        for entry in self.directory.iterdir():
            m = _SEGMENT_RE.match(entry.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def segment_count(self) -> int:
        return len(self._segment_indices())

    def has_snapshot(self) -> bool:
        return (self.directory / SNAPSHOT_NAME).exists()
