"""Sharded scraping and TSDB federation: the 10k-target metrics plane.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/federation.py``.
``ShardedScrapePlane`` is cut to what the pipeline sets: its shard DBs take
the TSDB's defaults but for ``downsample`` (no ``lookback``, ``retention``,
``chunk_size`` or ``ring`` knob).  Its shards' rules fan out onto a
thread pool as JAX's do (``parallel_rules``), and fall back to one shard
after another when an evaluator carries a tracer or self-metrics sink; the
recorded values are the same either way, which ``control/race_harness.py``
checks schedule by schedule and ``analysis/concurrency.py`` declares as the
plane's concurrency contract.

One scraper over one TSDB tops out well before 10,000 targets: every sweep
walks the whole fleet and every fleet-wide query scans every series.  This
module splits the plane the way Prometheus deployments do:

- :class:`HashRing`: target-to-shard assignment keyed by CRC32 with
  virtual nodes, so a fleet lands on the same shards in every process and
  after every restart (the doctor's ``check_shards`` holds the shards
  disjoint and their union the fleet).
- :class:`ShardedScrapePlane`: N Prometheus-agent-style shards, each a
  plain :class:`~k8s_gpu_hpa_tpu_torch.metrics.tsdb.Scraper` over its own
  :class:`~k8s_gpu_hpa_tpu_torch.metrics.tsdb.TimeSeriesDB`.  Shards may
  run local recording rules (``add_shard_rules``) that pre-reduce their
  targets, so a global query is O(shards) instead of O(fleet): each shard
  records ``sum``/``count`` over its series, and one global rule divides
  the federated sums (:class:`~k8s_gpu_hpa_tpu_torch.metrics.rules.Ratio`).
- :class:`FederatedTSDB`: the merged read view rule evaluation and the
  adapter consume.  Reads fan out over the global DB and every shard DB and
  concatenate (shard series are disjoint by the ring); writes (rule
  outputs, staleness markers) land in the global DB; ``version`` sums the
  members' monotonic write counters, so the incremental skip stays exact
  across the federation; a read capture fans out to every member, so
  metric lineage reaches through it.
"""

from __future__ import annotations

import json
import zlib
from bisect import bisect_right
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from k8s_gpu_hpa_tpu_torch.metrics.planner import QueryPlanner
from k8s_gpu_hpa_tpu_torch.metrics.rules import RecordingRule, RuleEvaluator
from k8s_gpu_hpa_tpu_torch.metrics.schema import Exemplar, Sample
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import LabelSet, Scraper, ScrapeTarget, TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.obs import coverage


class HashRing:
    """Consistent-hash ring over ``shards`` shards with virtual nodes.

    Keys are CRC32 hashes — stable across processes (``hash()`` is salted
    per run), the same choice ``Scraper.stagger_after_recovery`` already
    made.  ``vnodes`` virtual points per shard smooth the assignment to
    within a few percent of uniform at fleet sizes.  The ring places every
    key as JAX's does."""

    def __init__(self, shards: int, vnodes: int = 64):
        if shards < 1:
            raise ValueError(f"need at least 1 shard, got {shards}")
        self.shards = shards
        self.vnodes = vnodes
        points = sorted(
            (zlib.crc32(f"shard-{s}/vnode-{r}".encode()), s)
            for s in range(shards)
            for r in range(vnodes)
        )
        self._hashes = [h for h, _ in points]
        self._owners = [s for _, s in points]

    def shard_for(self, key: str) -> int:
        """Owning shard of ``key`` (the first ring point at/after its hash,
        wrapping)."""
        h = zlib.crc32(key.encode())
        idx = bisect_right(self._hashes, h) % len(self._hashes)
        return self._owners[idx]


class ShardedScrapePlane:
    """N scraper shards, each owning a hash-ring subset of the fleet with
    its own TSDB — drop-in for a single ``Scraper`` in the pipeline (same
    ``add_target`` / ``scrape_once`` / ``targets`` /
    ``stagger_after_recovery`` surface)."""

    def __init__(self, clock, shards: int, interval: float = 1.0, tracer=None, selfmetrics=None,
                 downsample=None):
        self.ring = HashRing(shards)
        self.shard_dbs = [TimeSeriesDB(clock, downsample=downsample) for _ in range(shards)]
        self.scrapers = [
            Scraper(db, interval=interval, tracer=tracer, selfmetrics=selfmetrics)
            for db in self.shard_dbs
        ]
        #: per-shard rule evaluators (``add_shard_rules``), or None slots
        self.shard_evaluators: list[RuleEvaluator | None] = [None] * shards
        #: evaluate shard rules concurrently (disjoint DBs make the passes
        #: independent); falls back to the serial loop when a shard
        #: evaluator carries a tracer or self-metrics sink, whose internals
        #: are not thread-safe
        self.parallel_rules = True
        self._rule_pool: ThreadPoolExecutor | None = None

    # -- Scraper drop-in surface --------------------------------------------

    def add_target(
        self, fetch: Callable, name: str = "", **attached_labels: str
    ) -> ScrapeTarget:
        """Assign the target to its ring shard and register it there.  The
        ring key is the target name (unique per fleet by construction:
        ``exporter/<node>``, ``kube-state-metrics``, ...)."""
        shard = self.ring.shard_for(name)
        return self.scrapers[shard].add_target(fetch, name, **attached_labels)

    def remove_target(self, target: ScrapeTarget) -> None:
        self.scrapers[self.shard_of(target)].remove_target(target)

    @property
    def targets(self) -> list[ScrapeTarget]:
        """The whole fleet, shard by shard (chaos injectors and the outage
        scenario iterate/mutate this exactly as with a single scraper)."""
        return [t for scraper in self.scrapers for t in scraper.targets]

    def scrape_once(self) -> int:
        return sum(scraper.scrape_once() for scraper in self.scrapers)

    def stagger_after_recovery(self, spread: float | None = None) -> None:
        for scraper in self.scrapers:
            scraper.stagger_after_recovery(spread)

    # -- shard-local rules (the federation pre-reduction) --------------------

    def add_shard_rules(self, rules_for: "Callable[[int], list[RecordingRule]]") -> None:
        """Install per-shard recording rules: ``rules_for(shard)`` returns
        the rules shard ``shard`` evaluates over ITS OWN DB (it can only see
        its own targets).  Outputs should carry a ``shard`` label so the
        global federated aggregate can tell the partial results apart."""
        for shard in range(len(self.scrapers)):
            rules = rules_for(shard)
            if not rules:
                continue
            existing = self.shard_evaluators[shard]
            if existing is not None:
                existing.rules.extend(rules)
            else:
                self.shard_evaluators[shard] = RuleEvaluator(
                    self.shard_dbs[shard],
                    rules,
                    planner=QueryPlanner(self.shard_dbs[shard]),
                )

    def evaluate_rules_once(self) -> int:
        """One evaluation pass over every shard's local rules (the pipeline
        runs this before the global evaluator each rule tick, so federated
        aggregates read fresh shard reductions).

        With two or more populated shards the passes fan out onto a shared
        thread pool: shard DBs are disjoint by ring construction and a
        rule's incremental state lives on the per-shard rule objects, so
        the evaluations share nothing.  The fan-out is skipped when any
        evaluator carries a tracer or selfmetrics sink (their span and list
        internals are not guarded) or when ``parallel_rules`` is off."""
        evaluators = [ev for ev in self.shard_evaluators if ev is not None]
        if (
            len(evaluators) < 2
            or not self.parallel_rules
            or any(ev.tracer is not None or ev.selfmetrics is not None for ev in evaluators)
        ):
            if len(evaluators) >= 2:
                # a genuine fallback (a shared sink or parallelism off), not
                # the trivial 0/1-shard case
                coverage.hit("concurrency:shard_rules_serial_fallback")
            return sum(ev.evaluate_once() for ev in evaluators)
        # concurrency contract: the disjoint-ownership fan-out declared in
        # analysis/concurrency.py CONTRACTS; the race harness holds it
        # bit-identical to the serial loop
        coverage.hit("concurrency:shard_rules_parallel")
        pool = self._rule_pool
        if pool is None or pool._max_workers < len(evaluators):
            if pool is not None:
                pool.shutdown(wait=True)
            pool = self._rule_pool = ThreadPoolExecutor(
                max_workers=len(evaluators), thread_name_prefix="shard-rules"
            )
        return sum(pool.map(lambda ev: ev.evaluate_once(), evaluators))

    # -- introspection (doctor check_shards) ---------------------------------

    def shard_of(self, target: ScrapeTarget) -> int:
        return self.ring.shard_for(target.name)

    def shard_status(self) -> dict:
        """Shard inventory as the ``doctor`` L3 probe consumes it: per shard
        the target names it owns and a reachability verdict (in production
        each agent would serve this from its own /-/ready; in-process a
        shard is reachable iff its DB answers)."""
        shards = []
        fleet: list[str] = []
        for shard, scraper in enumerate(self.scrapers):
            names = [t.name for t in scraper.targets]
            fleet.extend(names)
            reachable = True
            try:
                scraper.db.series_count()
            except Exception:
                reachable = False
            shards.append(
                {
                    "shard": shard,
                    "reachable": reachable,
                    "targets": names,
                    "series": scraper.db.series_count(),
                }
            )
        return {"shards": shards, "fleet": fleet}

    def shard_status_json(self) -> str:
        return json.dumps(self.shard_status())


class FederatedTSDB:
    """Merged read view over the global TSDB plus every shard TSDB.

    The division of labor mirrors Prometheus federation: shards own raw
    scraped series, the global DB owns everything the control plane writes
    (rule outputs, SLO counters, checkpoint-adjacent series) and the WAL.
    Reads concatenate across members — label sets are disjoint across
    shards by ring construction, so concatenation IS the merge.  Writes go
    to the global member; ``version(name)`` sums the members' monotonic
    per-name counters (a sum of monotonics is monotonic, so incremental
    rule eval's version signatures keep their exact semantics); capture
    brackets fan out so lineage records reads wherever they physically
    happened."""

    def __init__(self, global_db: TimeSeriesDB, shard_dbs: list[TimeSeriesDB]):
        self.global_db = global_db
        self.shard_dbs = list(shard_dbs)
        self.members = [global_db, *shard_dbs]

    # -- ambient properties (consumers read these off any TSDB) -------------

    @property
    def clock(self):
        return self.global_db.clock

    @property
    def lookback(self) -> float:
        return self.global_db.lookback

    @property
    def retention(self) -> float:
        return self.global_db.retention

    @property
    def wal(self):
        return self.global_db.wal

    @property
    def last_recovery(self):
        return self.global_db.last_recovery

    # -- writes: the control plane's series live in the global DB ------------

    def append(self, *args, **kwargs) -> None:
        self.global_db.append(*args, **kwargs)

    def mark_stale(self, *args, **kwargs) -> None:
        self.global_db.mark_stale(*args, **kwargs)

    def snapshot(self) -> None:
        self.global_db.snapshot()

    def gc(self) -> int:
        return sum(db.gc() for db in self.members)

    # -- reads: fan out and concatenate --------------------------------------

    def instant_vector(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        at: float | None = None,
    ) -> list[Sample]:
        at = self.clock.now() if at is None else at
        out = self.global_db.instant_vector(name, matchers, at)
        for db in self.shard_dbs:
            vec = db.instant_vector(name, matchers, at)
            if vec:
                out.extend(vec)
        return out

    def range_avg(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        window_s: float = 0.0,
        at: float | None = None,
        use_summaries: bool = False,
        stats=None,
    ) -> list[Sample]:
        at = self.clock.now() if at is None else at
        out = self.global_db.range_avg(
            name, matchers, window_s, at, use_summaries=use_summaries, stats=stats
        )
        for db in self.shard_dbs:
            vec = db.range_avg(
                name, matchers, window_s, at, use_summaries=use_summaries, stats=stats
            )
            if vec:
                out.extend(vec)
        return out

    def latest(self, name: str, matchers: dict[str, str] | None = None) -> float | None:
        vec = self.instant_vector(name, matchers)
        if not vec:
            return None
        if len(vec) > 1:
            raise ValueError(f"query for {name} matched {len(vec)} series, expected 1")
        return vec[0].value

    def begin_capture(self) -> None:
        for db in self.members:
            db.begin_capture()

    def end_capture(
        self,
    ) -> list[tuple[str, LabelSet, float, float, int | None, str]]:
        captured: list = []
        for db in self.members:
            captured.extend(db.end_capture())
        return captured

    def exemplar(self, name: str, labels: LabelSet) -> Exemplar | None:
        for db in self.members:
            ex = db.exemplar(name, labels)
            if ex is not None:
                return ex
        return None

    def exemplars_of(self, name: str) -> dict:
        out: dict = {}
        for db in self.members:
            out.update(db.exemplars_of(name))
        return out

    # -- counters: sums of the members' (all monotonic where it matters) -----

    def version(self, name: str) -> int:
        return sum(db.version(name) for db in self.members)

    def series_generation(self, name: str) -> int:
        return sum(db.series_generation(name) for db in self.members)

    @property
    def decode_cache_hits(self) -> int:
        return sum(db.decode_cache_hits for db in self.members)

    @property
    def decode_cache_misses(self) -> int:
        return sum(db.decode_cache_misses for db in self.members)

    def total_points(self) -> int:
        return sum(db.total_points() for db in self.members)

    def total_appends(self) -> int:
        return sum(db.total_appends() for db in self.members)

    def retained_bytes(self) -> int:
        return sum(db.retained_bytes() for db in self.members)

    def series_count(self) -> int:
        return sum(db.series_count() for db in self.members)

    def series_names(self) -> list[str]:
        names: set[str] = set()
        for db in self.members:
            names.update(db.series_names())
        return sorted(names)

    # -- downsampled rollup tiers (fan out like any read) --------------------

    @property
    def rollup_steps(self) -> tuple[float, ...]:
        """Union of the members' tier menus (shards and the global DB may
        downsample independently; the planner only needs to know a step
        exists somewhere to try it)."""
        steps: set[float] = set()
        for db in self.members:
            steps.update(db.rollup_steps)
        return tuple(sorted(steps))

    @property
    def downsample_policy(self):
        for db in self.members:
            policy = db.downsample_policy
            if policy is not None:
                return policy
        return None

    def rollup_range_avg(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        window_s: float = 0.0,
        at: float | None = None,
        step: float | None = None,
        stats=None,
    ) -> list[Sample] | None:
        """Tier read across members: every member holding matching series
        must serve the tier, else the whole federated query reports None
        (mixing tier and raw members would break the bit-exactness
        contract).  Members without matching series contribute []."""
        at = self.clock.now() if at is None else at
        out: list[Sample] = []
        for db in self.members:
            vec = db.rollup_range_avg(name, matchers, window_s, at, step, stats=stats)
            if vec is None:
                return None
            out.extend(vec)
        return out

    def range_avg_bucketed(
        self,
        name: str,
        matchers: dict[str, str] | None = None,
        window_s: float = 0.0,
        at: float | None = None,
        step: float | None = None,
    ) -> list[Sample]:
        at = self.clock.now() if at is None else at
        out: list[Sample] = []
        for db in self.members:
            out.extend(db.range_avg_bucketed(name, matchers, window_s, at, step=step))
        return out

    def rollup_rows(self, *args, **kwargs) -> list:
        out: list = []
        for db in self.members:
            out.extend(db.rollup_rows(*args, **kwargs))
        return out

    def rollup_storage_stats(self) -> dict:
        merged: dict = {"enabled": False, "tiers": {}}
        for db in self.members:
            stats = db.rollup_storage_stats()
            if not stats.get("enabled"):
                continue
            merged["enabled"] = True
            for label, entry in stats["tiers"].items():
                slot = merged["tiers"].setdefault(
                    label, {"series": 0, "chunks": 0, "buckets": 0, "bytes": 0}
                )
                for k, v in entry.items():
                    slot[k] += v
            for key in (
                "rollup_bytes",
                "ingested_points",
                "ingested_chunks",
                "ingested_bytes",
                "sealed_buckets",
                "dropped_buckets",
            ):
                merged[key] = merged.get(key, 0) + stats[key]
        return merged
