"""The Thanos-style global query layer over the regions' sealed snapshots.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/global_query.py``.  Each region
seals its TSDB state now and then into a format-3 snapshot payload
(:meth:`~k8s_gpu_hpa_tpu_torch.metrics.tsdb.TimeSeriesDB.snapshot_payload`,
the bytes the WAL snapshot writes, so the exchange inherits the recovery
path's round trip) and uploads it to the simulated object store under a
**sealed-generation protocol**:

1. the payload travels as canonical JSON at ``regions/<R>/gen/<n>``;
2. only after the blob's put returns does the publisher write the seal
   ``regions/<R>/seal/<n>`` = ``{"generation", "size", "crc32"}``.

A reader trusts generation ``n`` only when its seal parses and the blob
matches the sealed size and CRC.  An uploader killed at any byte, in the
blob or in the seal, leaves either an unsealed blob (no seal: invisible) or
an unreadable seal: the reader falls back to the newest older generation
that validates, so a torn upload never reaches the global view.

:class:`GlobalQueryLayer` merges the regions' sealed payloads into one
:class:`~k8s_gpu_hpa_tpu_torch.metrics.tsdb.TimeSeriesDB`, tagging every
series with a ``region`` label (disjoint by construction: Thanos's external
label) and restoring the merged payload through ``TimeSeriesDB.recover``.
Global queries then run through the ordinary query engine, and answer
exactly as one reference TSDB merged from the live regional DBs does.

Payloads are cached per region, keyed by sealed generation, and
:meth:`GlobalQueryLayer.invalidate` drops one region's entry: a
``tsdb_restart`` in region A never evicts region B's cached view.

The exchange's joints are ``region:*`` coverage probes
(``global_merge_fallback``, ``objstore_hit``, ``objstore_miss``,
``objstore_outage`` and ``global_merge_sealed``; obs/coverage.py).
"""

from __future__ import annotations

import json
import zlib

from k8s_gpu_hpa_tpu_torch.metrics.objstore import ObjectStoreUnavailable, SimObjectStore
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.obs import coverage

#: the exchange's artifact format: the TSDB snapshot format (read by
#: ``TimeSeriesDB.recover``, so older payloads restore too)
EXCHANGE_FORMAT = 3


def _gen_key(region: str, generation: int) -> str:
    return f"regions/{region}/gen/{generation:08d}"


def _seal_key(region: str, generation: int) -> str:
    return f"regions/{region}/seal/{generation:08d}"


def encode_payload(payload: dict) -> bytes:
    """Canonical JSON bytes, sorted keys and no whitespace: the same
    payload gives the same bytes and so the same CRC."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode("utf-8")


def publish_snapshot(
    store: SimObjectStore,
    region: str,
    generation: int,
    payload: dict,
    fail_blob_after: int | None = None,
    fail_seal_after: int | None = None,
) -> dict:
    """Upload one sealed generation: the blob first, the seal after it.

    ``fail_blob_after`` and ``fail_seal_after`` tear the put they name at
    that byte: the store's :class:`~.objstore.TornUpload` propagates and the
    torn prefix stays behind, the state the reader must survive.  Returns
    the seal written."""
    blob = encode_payload(payload)
    store.put(_gen_key(region, generation), blob, fail_after=fail_blob_after)
    seal = {"generation": generation, "size": len(blob), "crc32": zlib.crc32(blob)}
    store.put(_seal_key(region, generation), encode_payload(seal), fail_after=fail_seal_after)
    return seal


def read_latest_sealed(store: SimObjectStore, region: str) -> tuple[int, dict] | None:
    """The newest generation whose seal parses and whose blob matches the
    sealed size and CRC, past every broken newer one; None when the region
    has no readable sealed generation.  An outage propagates."""
    for key in reversed(store.list(f"regions/{region}/seal/")):
        try:
            seal = json.loads(store.get(key).decode("utf-8"))
            generation = int(seal["generation"])
            expected_size = int(seal["size"])
            expected_crc = int(seal["crc32"])
            blob = store.get(_gen_key(region, generation))
            if len(blob) != expected_size or zlib.crc32(blob) != expected_crc:
                raise ValueError("seal/blob mismatch")
            payload = json.loads(blob.decode("utf-8"))
        except ObjectStoreUnavailable:
            raise
        except (KeyError, ValueError, TypeError, UnicodeDecodeError):
            # a torn seal, a torn blob, or a blob its seal disowns
            coverage.hit("region:global_merge_fallback")
            continue
        coverage.hit("region:objstore_hit")
        return generation, payload
    coverage.hit("region:objstore_miss")
    return None


# ---- payload merge + restore ------------------------------------------------


def _tag_labels(labels: list, region: str) -> list:
    """Add the external ``region`` label and sort: two regions never collide
    on a label set that differs in ``region``."""
    return sorted([list(pair) for pair in labels] + [["region", region]])


def merge_payloads(payloads: dict[str, dict]) -> dict:
    """Combine the regions' snapshot payloads into one restorable payload.

    Series (their Gorilla columns and rollups verbatim) concatenate under
    region-tagged labels; the version counters sum by name (a sum of
    monotonic counters stays monotonic, so the planner's cache validation
    keeps its meaning); staleness markers and exemplars are tagged the same
    way.  Regions merge in sorted order, and ``lookback``, ``retention`` and
    ``downsample`` come from the first, so the same inputs give the same
    bytes."""
    series: list[dict] = []
    versions: dict[str, int] = {}
    stale_pending: list = []
    exemplars: list = []
    at = 0.0
    lookback = retention = downsample = None
    for region in sorted(payloads):
        p = payloads[region]
        at = max(at, p["at"])
        if lookback is None:
            lookback = p["lookback"]
        if retention is None:
            retention = p["retention"]
        if downsample is None:
            downsample = p.get("downsample")
        for entry in p["series"]:
            tagged = dict(entry)
            tagged["labels"] = _tag_labels(entry["labels"], region)
            series.append(tagged)
        for name, version in p.get("versions", {}).items():
            versions[name] = versions.get(name, 0) + version
        for name, labels, ts in p.get("stale_pending", []):
            stale_pending.append([name, _tag_labels(labels, region), ts])
        for name, labels, value, trace_id, span_id, ts in p.get("exemplars", []):
            exemplars.append([name, _tag_labels(labels, region), value, trace_id, span_id, ts])
    merged = {
        "format": EXCHANGE_FORMAT,
        "at": at,
        "lookback": 300.0 if lookback is None else lookback,
        "retention": retention,
        "series": series,
        "versions": versions,
        "stale_pending": stale_pending,
        "exemplars": exemplars,
    }
    if downsample is not None:
        merged["downsample"] = downsample
    return merged


class _PayloadWAL:
    """A read-only WAL over a payload in memory: ``recover`` restores the
    snapshot with an empty tail, and the restored view's appends log
    nowhere (the merged global DB is a query surface, not a write path)."""

    def __init__(self, payload: dict):
        self._payload = payload

    def read(self):
        return self._payload, []

    def log_append(self, *args, **kwargs) -> None:
        pass

    def write_snapshot(self, payload: dict) -> None:
        pass


def restore_payload(payload: dict, clock) -> TimeSeriesDB:
    """Restore a payload into a serving TSDB through the recovery path
    (format negotiation, rollup restore, index rebuild), then detach the
    WAL so the view is read-only."""
    db = TimeSeriesDB.recover(_PayloadWAL(payload), clock)
    db.wal = None
    return db


def combined_payload_of(db) -> dict:
    """One payload for a pipeline's DB: a plain TSDB's own snapshot, or a
    FederatedTSDB's members merged (their label sets are disjoint by the
    ring) with the member tags stripped: the global merge adds the
    ``region`` label once, at the exchange."""
    members = getattr(db, "members", None)
    if members is None:
        return db.snapshot_payload()
    merged = merge_payloads(
        {f"member-{i:02d}": member.snapshot_payload() for i, member in enumerate(members)}
    )
    for entry in merged["series"]:
        entry["labels"] = [pair for pair in entry["labels"] if pair[0] != "region"]
    for rec in merged["stale_pending"]:
        rec[1] = [pair for pair in rec[1] if pair[0] != "region"]
    for rec in merged["exemplars"]:
        rec[1] = [pair for pair in rec[1] if pair[0] != "region"]
    return merged


# ---- the global query layer -------------------------------------------------


class GlobalQueryLayer:
    """Merged reads across regions over the sealed exchange.

    Each region's payload is cached by sealed generation, and the merged
    DB by the whole generation vector.  An object-store outage during a
    refresh serves the last sealed view (a stale read beats none, Thanos's
    stance) and is counted."""

    def __init__(self, clock, store: SimObjectStore):
        self.clock = clock
        self.store = store
        self._regions: list[str] = []
        #: region -> (generation, payload); invalidate() drops one entry
        self._payloads: dict[str, tuple[int, dict]] = {}
        self._merged: tuple[tuple, TimeSeriesDB] | None = None
        self.refreshes_total = 0
        self.outages_seen = 0
        self.stale_serves = 0

    def register_region(self, name: str) -> None:
        if name not in self._regions:
            self._regions.append(name)

    def invalidate(self, region: str) -> None:
        """Drop one region's cached payload and the merged view over it; the
        other regions' entries stay."""
        self._payloads.pop(region, None)
        self._merged = None

    def cached_generation(self, region: str) -> int | None:
        entry = self._payloads.get(region)
        return None if entry is None else entry[0]

    def cached_payload(self, region: str) -> dict | None:
        entry = self._payloads.get(region)
        return None if entry is None else entry[1]

    def refresh(self) -> dict:
        """Pull each registered region's newest sealed generation.  Returns
        ``{"generations": {region: generation or None}, "stale": bool}``,
        stale when an outage left the cached views in service."""
        self.refreshes_total += 1
        stale = False
        generations: dict[str, int | None] = {}
        for region in self._regions:
            try:
                latest = read_latest_sealed(self.store, region)
            except ObjectStoreUnavailable:
                coverage.hit("region:objstore_outage")
                self.outages_seen += 1
                self.stale_serves += 1
                stale = True
                generations[region] = self.cached_generation(region)
                continue
            if latest is None:
                generations[region] = self.cached_generation(region)
                continue
            generation, payload = latest
            cached = self._payloads.get(region)
            if cached is None or cached[0] != generation:
                self._payloads[region] = (generation, payload)
            generations[region] = generation
        return {"generations": generations, "stale": stale}

    def db(self) -> TimeSeriesDB:
        """The merged global TSDB over every cached payload: refreshed, and
        rebuilt only when some region's generation moved."""
        self.refresh()
        key = tuple((region, gen) for region, (gen, _) in sorted(self._payloads.items()))
        if self._merged is None or self._merged[0] != key:
            merged_payload = merge_payloads(
                {region: payload for region, (_, payload) in self._payloads.items()}
            )
            self._merged = (key, restore_payload(merged_payload, self.clock))
            coverage.hit("region:global_merge_sealed")
        return self._merged[1]

    # -- reads through the merged DB's query engine ---------------------------

    def instant_vector(self, name, matchers=None, at=None):
        return self.db().instant_vector(name, matchers, at)

    def range_avg(self, name, matchers=None, window_s=0.0, at=None, **kwargs):
        return self.db().range_avg(name, matchers, window_s, at, **kwargs)

    def rollup_range_avg(self, name, matchers=None, window_s=0.0, at=None, step=None, **kwargs):
        return self.db().rollup_range_avg(name, matchers, window_s, at, step, **kwargs)

    def status(self) -> dict:
        return {
            "regions": list(self._regions),
            "cached_generations": {
                region: gen for region, (gen, _) in sorted(self._payloads.items())
            },
            "refreshes": self.refreshes_total,
            "outages_seen": self.outages_seen,
            "stale_serves": self.stale_serves,
        }


def query_basket(db, names: list[str], windows: list[float], at: float) -> dict:
    """The comparison basket both sides of the differential are hashed by:
    for each name, the instant vector, and for each window the range
    average and every rollup tier the DB serves (None where a tier cannot
    answer), as plain JSON rows."""
    out: dict = {}
    for name in sorted(names):
        rows: dict = {"instant": [[list(s.labels), s.value] for s in db.instant_vector(name, at=at)]}
        for window in windows:
            rows[f"range_{window:g}"] = [
                [list(s.labels), s.value] for s in db.range_avg(name, window_s=window, at=at)
            ]
            for step in getattr(db, "rollup_steps", ()) or ():
                vec = db.rollup_range_avg(name, window_s=window, at=at, step=step)
                rows[f"rollup_{step:g}_{window:g}"] = (
                    None if vec is None else [[list(s.labels), s.value] for s in vec]
                )
        out[name] = rows
    return out


def basket_fingerprint(basket: dict) -> str:
    """Canonical JSON's CRC32 and length: what two runs compare."""
    blob = encode_payload(basket)
    return f"crc32:{zlib.crc32(blob):08x}:{len(blob)}"
