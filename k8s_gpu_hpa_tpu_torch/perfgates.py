"""Performance-gate constants of the fleet-scale metrics plane.

Counterpart of ``k8s_gpu_hpa_tpu/perfgates.py``, cut to the constants the
``sim_scale``, ``sim_scale_10k``, ``query_bench`` and ``downsample_bench``
rungs read (``trial.py``), the ``capacity_crunch`` sizing and gates
(``chaos/crunch.py``), the ``region_evacuation`` ones
(``chaos/evacuate.py``), the coverage floors (``simulate --scenario
coverage``) and the ``profile_bench`` ones (``control/profile_harness.py``):
the same values, in one place, so a deliberate re-baselining is one edit.

Two kinds of constants live here:

- **sizing** (targets, horizon, shards): what a rung runs, in a full and a
  smoke size; a smoke size runs the same code paths at some 10-30x less
  work.
- **gates** (floors and ceilings): what a run must clear.  The floors sit
  some 4-5x under the numbers the JAX package measured on a development
  host (its BASELINE.md), so they catch an algorithmic regression (a hot
  path gone quadratic, retention stopped, compression fallen back to raw)
  without flaking on machine variance.
"""

from __future__ import annotations

#: the uncompressed cost of one retained point, a (float64 ts, float64
#: value) pair; ``compression_ratio`` is measured against it, so the 4x gate
#: is a statement about the encoded columns, not about Python's boxing
UNCOMPRESSED_BYTES_PER_SAMPLE = 16.0

# ---- sim_scale: the 1000-target unsharded rung ------------------------------

SIM_SCALE_TARGETS = 1000
SIM_SCALE_HORIZON_S = 3600.0
#: virtual seconds per wall second, the full rung's floor
SIM_SCALE_MIN_SPEEDUP = 1000.0

SIM_SCALE_SMOKE_TARGETS = 200
SIM_SCALE_SMOKE_HORIZON_S = 600.0
SIM_SCALE_SMOKE_MIN_SPEEDUP = 100.0

# ---- sim_scale_10k: the sharded federation rung -----------------------------

SIM_SCALE_10K_TARGETS = 10000
SIM_SCALE_10K_HORIZON_S = 3600.0
SIM_SCALE_10K_SHARDS = 8
SIM_SCALE_10K_MIN_SPEEDUP = 25.0

SIM_SCALE_10K_SMOKE_TARGETS = 2000
SIM_SCALE_10K_SMOKE_HORIZON_S = 600.0
SIM_SCALE_10K_SMOKE_SHARDS = 4
SIM_SCALE_10K_SMOKE_MIN_SPEEDUP = 50.0

# ---- query_bench: planned vs naive rule evaluation --------------------------

#: the full rung runs the fleet-aggregate basket at the sim_scale_10k
#: population (10k fleet series over 8 shard DBs), with enough history that
#: most sealed chunks sit wholly inside the range window
QUERY_BENCH_TARGETS = SIM_SCALE_10K_TARGETS
QUERY_BENCH_SHARDS = SIM_SCALE_10K_SHARDS
QUERY_BENCH_HORIZON_S = 3600.0
QUERY_BENCH_INTERVAL_S = 5.0
#: the range rule's window; it starts mid-chunk, so boundary decodes run
QUERY_BENCH_WINDOW_S = 3300.0
#: planned-vs-naive wall-time floor over the basket (a pushdown that
#: stopped working would land near 1x)
MIN_PLANNED_SPEEDUP = 3.0

QUERY_BENCH_SMOKE_TARGETS = 500
QUERY_BENCH_SMOKE_SHARDS = 4
QUERY_BENCH_SMOKE_HORIZON_S = 1800.0
#: the smoke size keeps fewer sealed chunks a series, so its margin is
#: smaller than the full rung's
QUERY_BENCH_SMOKE_MIN_PLANNED_SPEEDUP = 2.0

#: Gorilla columns must stay at least 4x denser than the 16-byte point (a
#: fall-back to raw encoding or an origins-column leak lands well under 4)
MIN_COMPRESSION_RATIO = 4.0
#: the fleet query's p95 budget: per-shard scans (~targets/shards series
#: each) and the adapter's federated single-series read
MAX_FLEET_QUERY_P95_MS = 3.0
#: the plane's ingest floor (below it the append path gained per-point
#: overhead)
MIN_APPENDS_PER_SEC = 25000.0

# ---- downsample_bench: rollup tiers vs raw decode ----------------------------

#: the full rung ages a day of 10k-target fleet history (30 s cadence)
#: through the 5m/1h compactor, then reads a 20 h tier-aligned fleet window
#: ending at hour 22 both ways
DOWNSAMPLE_BENCH_TARGETS = SIM_SCALE_10K_TARGETS
DOWNSAMPLE_BENCH_SHARDS = SIM_SCALE_10K_SHARDS
DOWNSAMPLE_BENCH_HORIZON_S = 86400.0
DOWNSAMPLE_BENCH_INTERVAL_S = 30.0
DOWNSAMPLE_BENCH_WINDOW_S = 72000.0
DOWNSAMPLE_BENCH_AT_S = 79200.0
#: the rollup-tier fleet query against the cold raw rescan of the same
#: window (a tier silently falling back to raw lands near 1x)
MIN_ROLLUP_SPEEDUP = 5.0

#: the smoke size keeps the full rung's 30 s cadence (the storage ratio is a
#: statement about samples a bucket, so thinning the cadence would fake it)
#: but shrinks the span to 6 h and the fleet to 200
DOWNSAMPLE_SMOKE_TARGETS = 200
DOWNSAMPLE_SMOKE_SHARDS = 2
DOWNSAMPLE_SMOKE_HORIZON_S = 21600.0
DOWNSAMPLE_SMOKE_INTERVAL_S = 30.0
#: a 3 h window ending at hour 4: aligned, and well inside the compacted
#: span (the compactor trails "now" by the horizon and some two chunks)
DOWNSAMPLE_SMOKE_WINDOW_S = 10800.0
DOWNSAMPLE_SMOKE_AT_S = 14400.0
#: fewer raw points a series shrink the decode-avoidance margin
DOWNSAMPLE_SMOKE_MIN_ROLLUP_SPEEDUP = 3.0

#: rollup bytes for the aged span against the 16-byte uncompressed cost of
#: the raw samples they summarize (five Gorilla columns a bucket at
#: 1/10-1/120 the sample count); a tier storing a row a sample would land
#: near 1.0
MAX_ROLLUP_BYTES_RATIO = 0.1

# ---- capacity_crunch: the pool shared by three tenants -----------------------

#: the base pool is 2 nodes of 8 devices; the autoscaler may add 2 more
#: 8-device nodes (whole 4-device slice quanta), so peak supply is 32
#: devices against a peak demand of some 31 from three tenants: the crunch
#: clears only if preemption, the fair share and provisioning all work
CRUNCH_BASE_NODES = 2
CRUNCH_NODE_CHIPS = 8
CRUNCH_SLICE_QUANTUM = 4
CRUNCH_AUTOSCALER_MAX_NODES = 2
CRUNCH_PROVISION_DELAY_S = 45.0
CRUNCH_PROVISION_TIMEOUT_S = 60.0
CRUNCH_EVICTION_GRACE_S = 10.0
#: virtual seconds after the faults arm (the spikes clear at some 510 s;
#: the tail is the convergence window the contract checks)
CRUNCH_TOTAL_S = 1000.0

#: time-to-capacity p95 ceilings by priority (seconds a pod waits Pending
#: before it binds, over every admission of the run).  The high-priority
#: tenant is served by preemption (grace and requeue, p95 10 s); the low
#: priorities wait for the autoscaler to get past its provision_fail
#: backoff (p95 235-310 s); the ceilings leave room over both
CRUNCH_HIGH_TTC_P95_MAX_S = 60.0
CRUNCH_LOW_TTC_P95_MAX_S = 480.0

#: the declared starvation budgets (the longest Pending stint a tenant
#: tolerates); ``simulate --scenario crunch --starvation-budget`` overrides
#: them to show the contract can fail
CRUNCH_STARVATION_BUDGETS_S = {
    "tpu-prod": 120.0,
    "tpu-batch": 600.0,
    "tpu-best": 900.0,
}

# ---- region_evacuation: the control plane over three regions -----------------

#: three regions on one clock, each a pool like the crunch's.  The home
#: region ("us") holds the prod and batch tenants; the survivors hold one
#: local tenant each and the headroom the evacuation spills into
EVAC_REGIONS = ("us", "eu", "ap")
EVAC_BASE_NODES = 2
EVAC_NODE_CHIPS = 8
EVAC_SLICE_QUANTUM = 4
#: the object store's visibility latency (put → readable)
EVAC_OBJSTORE_LATENCY_S = 2.0
#: the global plane's periods: spill scheduling and sealed publishing
EVAC_SYNC_INTERVAL_S = 15.0
EVAC_PUBLISH_INTERVAL_S = 30.0

#: the faults (seconds after arming): the kill lands mid-traffic, an
#: object-store outage overlaps the evacuation's busiest phase, and a
#: partition of a survivor ("ap"), opened before the kill, shows the spill
#: routing around it: prod and part of batch land on "eu", the rest of
#: batch is denied (``no_capacity``) until the partition heals
EVAC_KILL_AT_S = 60.0
EVAC_KILL_DURATION_S = 300.0
EVAC_OUTAGE_AT_S = 120.0
EVAC_OUTAGE_DURATION_S = 45.0
EVAC_PARTITION_AT_S = 30.0
EVAC_PARTITION_DURATION_S = 90.0
#: the settle before arming and the run after it (the tail past the kill
#: and the recovery is the window the contract checks)
EVAC_SETTLE_S = 120.0
EVAC_TOTAL_S = 900.0

#: time-to-reconvergence ceilings by priority band: seconds from the kill
#: to the band's frozen replicas all Running on the survivors' mirrors.
#: Prod's is tighter: its spill comes first and binds into standing
#: headroom (15 s in the canned run); batch may wait out the fair share
#: behind the survivors' own tenants (75 s)
EVAC_PROD_TTC_MAX_S = 150.0
EVAC_BATCH_TTC_MAX_S = 420.0

#: the starvation budgets of the tenants during the evacuation (the spill
#: must not starve the survivors' own tenants past these)
EVAC_STARVATION_BUDGETS_S = {
    "tpu-prod": 120.0,
    "tpu-batch": 600.0,
    "eu-local": 600.0,
    "ap-local": 600.0,
}

#: the smoke size (``simulate --scenario evacuate --smoke``): the same
#: lifecycle over three regions, a shorter kill and tail
EVAC_SMOKE_KILL_DURATION_S = 180.0
EVAC_SMOKE_TOTAL_S = 600.0

# ---- coverage_floor: the execution-coverage floors --------------------------

#: union decision-path coverage the canned runs must reach together, as
#: hit probes / registered probes.  The floor is not 1.0 on purpose: the
#: never-hit remainder is the published gap list, so a registry that grows
#: past what the canned runs exercise widens the gap instead of failing
COVERAGE_UNION_FLOOR = 0.70

#: per-domain floors under the same union map, each with margin below the
#: ratio the JAX package's canned runs reach: a scenario edit that stops
#: exercising a whole domain trips its floor even if the union survives
COVERAGE_DOMAIN_FLOORS = {
    "hpa_condition": 0.70,
    "scheduler_branch": 0.85,
    "planner_path": 0.50,
    "fault_kind": 0.65,
    "alert_state": 0.70,
    "recovery_path": 0.60,
    "concurrency": 0.80,
    "fuzz": 0.75,
    "profile": 0.75,
    "region": 0.75,
    "alerting": 0.85,
}

#: the union must also leave at least this many probes never hit: zero
#: would mean the gap list went dark and coverage stopped carrying
#: information
COVERAGE_MIN_NEVER_HIT = 1

# ---- race_sweep: the shard-rules fan-out's interleavings (`simulate races`) --

#: permuted completion schedules a sweep runs; each must be bit-identical
#: to the serial reference
RACE_SWEEP_SCHEDULES = 4
#: shards in the sweep's plane: enough for a nontrivial permutation space
RACE_SWEEP_SHARDS = 4
#: synthetic fleet targets spread over the ring
RACE_SWEEP_TARGETS = 12
#: scrape and evaluate ticks a schedule
RACE_SWEEP_TICKS = 6

# ---- profile_bench: the continuous-profiling plane --------------------------

#: attribution floor for the scale run: at least this share of
#: run_fleet_scale's own measured (gc-disabled) wall window must land
#: inside named stage brackets
PROFILE_MIN_ATTRIBUTION = 0.90

#: --diff regression tolerance: a stage's share of attributed self time
#: may grow by at most this many absolute share points over the baseline.
#: Shares, not seconds, make the gate machine-portable (a uniformly slower
#: machine cancels out)
PROFILE_DIFF_SHARE_TOLERANCE = 0.25
#: stages below this candidate self time are exempt from the share gate
#: (sub-5 ms totals are all jitter)
PROFILE_DIFF_MIN_SELF_S = 0.005

#: the planted-slowdown canary the rung proves the diff gate catches:
#: PROFILE_CANARY_PLANT_S accounted (never slept) seconds added per call
#: to this stage must push its share past the tolerance against a clean run
PROFILE_CANARY_STAGE = "tsdb:append"
PROFILE_CANARY_PLANT_S = 0.05

#: scale-run shapes for run_profile: full = the sim_scale shape the
#: attribution gate is specified at; smoke = the tests' sizing
PROFILE_SCALE_TARGETS = 1000
PROFILE_SCALE_HORIZON_S = 3600.0
PROFILE_SCALE_SMOKE_TARGETS = 200
PROFILE_SCALE_SMOKE_HORIZON_S = 600.0

#: the `coverage --run profile` session's tiny fleet shape: just enough
#: scrape and rule traffic to fill a real ProfileMap for the exporters
PROFILE_COVERAGE_TARGETS = 10
PROFILE_COVERAGE_HORIZON_S = 120.0

# ---- chaos_fuzz: the coverage-guided adversarial fuzzer ------------------------

#: the smoke campaign (``simulate --scenario fuzz`` with no --budget or
#: --seed): small enough for a quick check, large enough to accept and
#: reject and to steer by novelty
FUZZ_SMOKE_BUDGET = 8
FUZZ_SMOKE_SEED = 7

#: the rung's exploration budget; the rung runs it TWICE and requires the
#: two reports to be the same bytes (the determinism that the corpus and
#: its replays rest on)
FUZZ_RUNG_BUDGET = 8
FUZZ_RUNG_SEED = 7

#: the planted-bug gate: with the --break-grace canary armed (an eviction
#: grace of forever, so any preemption strands Terminating pods) the fuzzer
#: must FIND a failing schedule and minimize it within this many cases
FUZZ_CANARY_BUDGET = 6
FUZZ_CANARY_SEED = 7

#: the novelty floor: at least this many accepted mutations must each have
#: hit a probe not seen before, over the rung's FUZZ_RUNG_BUDGET cases (a
#: mutator that stopped varying the fault kinds lands at 0-1)
FUZZ_MIN_NOVEL_ACCEPTS = 2

#: the minimizer's ceiling: minimized faults over the failing schedule's
#: faults for the canary's failure (the delta debugger must delete schedule
#: mass, not hand back its input)
FUZZ_MAX_SHRINK_RATIO = 0.67

#: the ``coverage --run fuzz`` session's campaign, pinned with its seed so
#: it both accepts AND rejects a mutation; the session then minimizes and
#: replays chaos/fuzz.CANARY_CORE, so the minimizer and replay probes fire
#: on every run
FUZZ_COVERAGE_BUDGET = 4
FUZZ_COVERAGE_SEED = 11

# ---- paging_bench: the incident plane --------------------------------------------

#: the router's timing, Alertmanager's semantics on the shared virtual
#: clock.  group_wait gathers a burst into one first page; group_interval
#: throttles the updates of a group already paged (a flap inside it folds
#: into ONE update); repeat_interval pages a group still firing again.  The
#: 120 s repeat is much shorter than Alertmanager's 4 h default on purpose:
#: it bounds to one interval the gap of a fault injected into a group
#: ALREADY firing (the crunch's overlaps), which the time-to-page budgets
#: below are set against
PAGING_GROUP_WAIT_S = 15.0
PAGING_GROUP_INTERVAL_S = 60.0
PAGING_REPEAT_INTERVAL_S = 120.0

#: paging quality against the injected faults.  Recall is exact: every
#: injected fault must give at least one attributed page or repeat inside
#: its window.  Precision has margin: a page may ride on burn-rate evidence
#: alone, but the canned drills measure 1.00 (every page attributable), so
#: 0.90 trips on a real attribution regression
PAGING_RECALL_FLOOR = 1.0
PAGING_PRECISION_FLOOR = 0.90

#: the p95 time-to-page ceiling of each canned drill, seconds from a
#: fault's injection to its first covering notification.  The storm's
#: faults page fresh groups (detection, for_seconds 5 and group_wait 15);
#: the crunch's faults overlap, so the late ones ride repeats (bounded by
#: PAGING_REPEAT_INTERVAL_S); the evacuation's region probes detect within
#: a rule tick.  The margin over the measured times is there so that a
#: routing regression trips the gate, not scheduling jitter
PAGING_TTP_P95_MAX_S = {
    "storm": 90.0,
    "crunch": 240.0,
    "evacuate": 60.0,
}

#: for_seconds of the harness's state-probe rules (chaos/paging.py): long
#: enough to ride out a blip of one tick, short enough to keep the
#: time-to-page inside the budgets above
PAGING_ALERT_FOR_S = 5.0
