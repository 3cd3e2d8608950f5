"""A simulated object store: the substrate of the exchange between regions.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/objstore.py``.  Thanos ships
sealed blocks to S3 or GCS and lets every querier read them back; this is
that substrate on the simulator's terms: visibility latency on the virtual
clock instead of network time, an outage window instead of a cloud incident,
and an upload torn at any byte instead of a crashed uploader.  Everything
the regions exchange (the format-3 TSDB snapshot payloads of :mod:`.tsdb`)
travels through :class:`SimObjectStore` as opaque bytes under the
sealed-generation scheme of :mod:`.global_query`, so every failure of the
exchange is a behavior this store produces on demand:

- **latency**: a put becomes visible to ``get`` and ``list`` once the clock
  passes its put time plus ``latency_s`` (the writer too: one visibility
  rule for every reader);
- **unavailability**: while an outage window is open (the
  ``objstore_outage`` fault kind) every call raises
  :class:`ObjectStoreUnavailable`; windows nest on a depth counter, so
  overlapping faults compose as the scrape path's do;
- **torn upload**: ``put(..., fail_after=k)`` stores exactly the first
  ``k`` bytes durably and raises :class:`TornUpload`, what a crashed
  uploader leaves behind, which the sealed-generation reader must survive
  at any ``k``.

The store keeps no versions and does no conditional puts: generations,
seals, checksums and the fallback live in the reader one layer up, where
they are tested against this store's worst behavior.
"""

from __future__ import annotations

from k8s_gpu_hpa_tpu_torch.utils.clock import Clock, SystemClock


class ObjectStoreUnavailable(ConnectionError):
    """The store is inside an outage window: every call fails."""


class TornUpload(RuntimeError):
    """A put was killed mid-stream; the prefix written so far is durable."""


class SimObjectStore:
    """put, get and list over virtual time, with latency and outages."""

    def __init__(self, clock: Clock | None = None, latency_s: float = 0.0):
        self.clock = clock if clock is not None else SystemClock()
        self.latency_s = float(latency_s)
        #: key -> (bytes, visible_at): one visibility rule for every reader
        self._objects: dict[str, tuple[bytes, float]] = {}
        self._outage_depth = 0
        self.puts_total = 0
        self.gets_total = 0
        self.lists_total = 0
        self.torn_uploads_total = 0
        self.outage_errors_total = 0

    # ---- the outage window (the objstore_outage fault kind) ----------------

    def begin_outage(self) -> None:
        """Open one outage window; windows nest."""
        self._outage_depth += 1

    def end_outage(self) -> None:
        if self._outage_depth > 0:
            self._outage_depth -= 1

    @property
    def available(self) -> bool:
        return self._outage_depth == 0

    def _check_available(self) -> None:
        if self._outage_depth > 0:
            self.outage_errors_total += 1
            raise ObjectStoreUnavailable(
                f"object store unavailable (outage depth {self._outage_depth})"
            )

    # ---- the API -----------------------------------------------------------

    def put(self, key: str, data: bytes, fail_after: int | None = None) -> None:
        """Store ``data`` under ``key``, visible after the latency.

        ``fail_after=k`` kills the uploader mid-put: exactly the first ``k``
        bytes land durably (visible after the same latency as any put) and
        :class:`TornUpload` is raised, so the caller never writes its seal,
        which the generation protocol's fallback is there to survive."""
        self._check_available()
        visible_at = self.clock.now() + self.latency_s
        if fail_after is not None and fail_after < len(data):
            self._objects[key] = (bytes(data[:fail_after]), visible_at)
            self.torn_uploads_total += 1
            raise TornUpload(f"put {key!r} killed after {fail_after}/{len(data)} bytes")
        self._objects[key] = (bytes(data), visible_at)
        self.puts_total += 1

    def get(self, key: str) -> bytes:
        """A visible object; ``KeyError`` when it is absent or still inside
        its visibility latency (an eventually consistent miss)."""
        self._check_available()
        self.gets_total += 1
        entry = self._objects.get(key)
        if entry is None or entry[1] > self.clock.now():
            raise KeyError(key)
        return entry[0]

    def list(self, prefix: str = "") -> list[str]:
        """The visible keys under ``prefix``, sorted, so every reader walks
        the generations in one order."""
        self._check_available()
        self.lists_total += 1
        now = self.clock.now()
        return sorted(
            k for k, (_, visible_at) in self._objects.items()
            if k.startswith(prefix) and visible_at <= now
        )

    def delete(self, key: str) -> bool:
        """Drop ``key`` if present; True when it was removed."""
        self._check_available()
        return self._objects.pop(key, None) is not None

    def stats(self) -> dict:
        return {
            "objects": len(self._objects),
            "bytes": sum(len(b) for b, _ in self._objects.values()),
            "puts": self.puts_total,
            "gets": self.gets_total,
            "lists": self.lists_total,
            "torn_uploads": self.torn_uploads_total,
            "outage_errors": self.outage_errors_total,
            "available": self.available,
        }
