"""The flight recorder (``simulate.run_history``/``run_why``), the doctor's
rollup probe (``doctor.check_downsampling`` over
``metrics.downsample.downsample_selfcheck``) and ``run_downsample_bench``
against the JAX package's.

- ``run_history(days=0.125)``: every field that does not read the wall
  clock is JAX's (the hourly table, the scale events and their lineages,
  the fault windows, the restarts, the tier buckets, the rule reads by
  tier, no violation), and its report is JAX's but for the rollup bytes.
  Those bytes roll up the pipeline's self-metrics, which record wall-clock
  durations, so they move from run to run in both packages: they are held
  within 5% of JAX's (some 0.1% apart in one process on this CPU, 2% on
  another host).
- ``run_why`` on the first scale event is JAX's but for the same
  wall-clock durations, through the API and the CLI; an unknown id is
  refused as JAX's refuses it; ``--shards 2`` exits 2 in one line, where
  JAX's raises.
- ``check_downsampling`` passes and fails as JAX's does on a live selfcheck
  payload, a raw-only DB, a tier too young to hold a bucket, a reported
  disagreement and no verifiable window; the doctor's "L3 rollup tiers"
  probe passes on a live payload and skips without a fetcher.
- ``run_downsample_bench``'s deterministic fields are JAX's at a small
  size.

Tolerance: exact, but for the wall-clock fields named above.
"""

import json
import math
import re

import pytest
import torch

from k8s_gpu_hpa_tpu import doctor as jax_doctor
from k8s_gpu_hpa_tpu import simulate as jax_simulate
from k8s_gpu_hpa_tpu.__main__ import main as jax_main
from k8s_gpu_hpa_tpu.control import scale_harness as jax_harness
from k8s_gpu_hpa_tpu.metrics import downsample as jax_downsample
from k8s_gpu_hpa_tpu.metrics import tsdb as jax_tsdb
from k8s_gpu_hpa_tpu.utils import clock as jax_clock
from k8s_gpu_hpa_tpu_torch import doctor, simulate
from k8s_gpu_hpa_tpu_torch.__main__ import main
from k8s_gpu_hpa_tpu_torch.control import scale_harness
from k8s_gpu_hpa_tpu_torch.metrics import downsample, tsdb
from k8s_gpu_hpa_tpu_torch.utils import clock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(simulate=simulate, doctor=doctor, ds=downsample, tsdb=tsdb, clock=clock,
            harness=scale_harness)
JAX = dict(simulate=jax_simulate, doctor=jax_doctor, ds=jax_downsample, tsdb=jax_tsdb,
           clock=jax_clock, harness=jax_harness)
BOTH = (PORT, JAX)

DAYS = 0.125
#: what reads the wall clock: the rollup bytes of the history's tiers
_BYTES = ("rollup_bytes", "ingested_bytes")


@pytest.fixture(scope="module")
def histories():
    return {"port": simulate.run_history(days=DAYS), "jax": jax_simulate.run_history(days=DAYS)}


def _deterministic(result: dict) -> dict:
    stats = result["tier_stats"]
    return {
        **{k: v for k, v in result.items() if k not in ("tracer", "tier_stats")},
        "tier_stats": {
            **{k: v for k, v in stats.items() if k not in ("tiers", *_BYTES)},
            "tiers": {label: {k: v for k, v in t.items() if k != "bytes"}
                      for label, t in stats["tiers"].items()},
        },
    }


def test_the_history_s_deterministic_fields_are_jax_s(histories):
    port, ref = histories["port"], histories["jax"]
    assert _deterministic(port) == _deterministic(ref)
    assert port["ok"] is True and port["violations"] == []
    assert [e["span_id"] for e in port["scale_events"]] == [516, 1378, 2368]
    assert all(e["complete"] for e in port["scale_events"])
    assert port["restarts"] == [{"component": "tsdb", "t": 6480.0}]
    assert {k: t["buckets"] for k, t in port["tier_stats"]["tiers"].items()} == {
        "5m": 5218, "1h": 327}
    assert port["tier_reads"] == {"raw": 5052}
    assert len(port["tracer"].spans) == len(ref["tracer"].spans)
    for label, t in port["tier_stats"]["tiers"].items():
        want = ref["tier_stats"]["tiers"][label]["bytes"]
        assert abs(t["bytes"] - want) <= 0.05 * want, label


def test_the_history_s_report_is_jax_s_but_for_the_rollup_bytes(histories):
    def lines(result, render):
        return [line for line in render(result).splitlines()
                if not line.startswith("rollup storage: ")]

    port = lines(histories["port"], simulate.render_history)
    assert port == lines(histories["jax"], jax_simulate.render_history)
    assert "[restart tsdb]" in "\n".join(port)
    assert "HISTORY CONTRACT VIOLATED" not in "\n".join(port)


def _strip_durations(result: dict) -> dict:
    hops = [{**hop, "details": [{k: v for k, v in d.items() if k != "duration_seconds"}
                                for d in hop["details"]]} for hop in result["hops"]]
    return {**result, "hops": hops}


def test_why_on_the_first_event_is_jax_s_and_an_unknown_id_is_refused(histories):
    first = histories["port"]["scale_events"][0]["span_id"]
    port = simulate.run_why(first, history=histories["port"])
    ref = jax_simulate.run_why(first, days=DAYS)
    assert _strip_durations(port) == _strip_durations(ref)
    assert port["ok"] is True and port["complete"] is True
    assert [h["kind"] for h in port["hops"]] == [
        "scale_event", "hpa_sync", "adapter_query", "rule_eval", "scrape", "exporter_sample"]
    assert "lineage: COMPLETE" in simulate.render_why(port)
    unknown = simulate.run_why(10**9, history=histories["port"])
    assert unknown == jax_simulate.run_why(10**9, days=DAYS)
    assert unknown["ok"] is False and "no scale event" in unknown["error"]
    assert simulate.render_why(unknown) == jax_simulate.render_why(unknown)


def test_the_why_command_prints_and_exits_as_jax_s(capsys):
    args = ["simulate", "--scenario", "why", "--event", "1378", "--days", str(DAYS)]
    code = main(args)
    out = capsys.readouterr().out
    ref_code = jax_main(args)
    ref = capsys.readouterr().out
    strip = re.compile(r", duration_seconds=[0-9.e-]+")
    assert (code, strip.sub("", out)) == (ref_code, strip.sub("", ref))
    assert code == 0 and "scale event #1378" in out
    # no event: both exit 2 with the same one-line hint
    args = ["simulate", "--scenario", "why"]
    assert (main(args), capsys.readouterr().out) == (jax_main(args), capsys.readouterr().out)


@pytest.mark.parametrize("scenario", ["history", "why"])
def test_a_sharded_flight_recorder_exits_2_in_one_line(scenario, capsys):
    code = main(["simulate", "--scenario", scenario, "--event", "516", "--shards", "2",
                 "--days", str(DAYS)])
    out = capsys.readouterr().out
    assert code == 2
    assert len(out.strip().splitlines()) == 1
    assert "single-TSDB durability path" in out and out.startswith(f"simulate {scenario}: ")
    with pytest.raises(RuntimeError):
        simulate.run_history(days=DAYS, shards=2)


# ---- the doctor's rollup probe -----------------------------------------------------


def _downsampled_db(mods, hours: float = 6.0, series: int = 4):
    vclock = mods["clock"].VirtualClock()
    db = mods["tsdb"].TimeSeriesDB(vclock, retention=(hours + 1.0) * 3600.0,
                                   downsample=mods["ds"].DownsamplePolicy())
    labels = [tuple(sorted({"job": "probe", "instance": f"p-{i}"}.items()))
              for i in range(series)]
    ts = 0.0
    for _ in range(int(hours * 3600.0 / 30.0)):
        ts += 30.0
        vclock.advance(30.0)
        for i, lab in enumerate(labels):
            db.append("probe_metric", lab, 10.0 + i + round(math.sin(ts / 900.0), 2))
    return db


@pytest.fixture(scope="module")
def selfchecks():
    """Each package's selfcheck of its own 6-hour DB, and of a DB too young
    for any bucket to seal."""
    return {
        name: {"live": mods["ds"].downsample_selfcheck(_downsampled_db(mods), ["probe_metric"]),
               "young": mods["ds"].downsample_selfcheck(_downsampled_db(mods, hours=0.05),
                                                        ["probe_metric"])}
        for name, mods in (("port", PORT), ("jax", JAX))
    }


def _verdict(mods, doc: dict) -> tuple[bool, str]:
    try:
        return True, mods["doctor"].check_downsampling(json.dumps(doc))
    except AssertionError as e:
        return False, str(e)


def _raw_only(mods) -> dict:
    db = mods["tsdb"].TimeSeriesDB(mods["clock"].VirtualClock(), retention=3600.0)
    return mods["ds"].downsample_selfcheck(db, ["probe_metric"])


def _disagreeing(doc: dict) -> dict:
    doc = json.loads(json.dumps(doc))
    doc["agreement"][0]["agree"] = False
    doc["agree_all"] = False
    return doc


def _unverified(doc: dict) -> dict:
    return {**doc, "agreement": [], "windows_served": 0}


@pytest.mark.parametrize("case,passes,says", [
    ("live", True, "rollup==raw twin"),
    ("raw-only", False, "no downsample policy"),
    ("young", False, "no sealed buckets"),
    ("disagreement", False, "DISAGREES"),
    ("no-overlap", False, "differentially verified"),
])
def test_check_downsampling_passes_and_fails_as_jax_s(case, passes, says, selfchecks):
    verdicts = []
    for name, mods in (("port", PORT), ("jax", JAX)):
        docs = selfchecks[name]
        doc = {"live": lambda: docs["live"], "raw-only": lambda: _raw_only(mods),
               "young": lambda: docs["young"],
               "disagreement": lambda: _disagreeing(docs["live"]),
               "no-overlap": lambda: _unverified(docs["live"])}[case]()
        verdicts.append((doc, _verdict(mods, doc)))
    assert json.dumps(verdicts[0][0]) == json.dumps(verdicts[1][0])
    assert verdicts[0][1] == verdicts[1][1]
    ok, detail = verdicts[0][1]
    assert ok is passes and says in detail
    if case == "live":
        assert verdicts[0][0]["windows_served"] >= 2 and "5m" in detail and "1h" in detail
    if case == "disagreement":
        assert "probe_metric@5m" in detail


def test_the_doctor_s_rollup_probe_passes_and_skips_as_jax_s(selfchecks):
    got = []
    for name, mods in (("port", PORT), ("jax", JAX)):
        payload = json.dumps(selfchecks[name]["live"])
        probes = {r.name: r for r in mods["doctor"].diagnose(downsample_fetch=lambda p=payload: p)}
        skipped = {r.name: r for r in mods["doctor"].diagnose()}
        got.append((probes["L3 rollup tiers"].ok, probes["L3 rollup tiers"].detail,
                    skipped["L3 rollup tiers"].detail))
    assert got[0] == got[1]
    ok, detail, skipped = got[0]
    assert ok and "rollup==raw twin" in detail and "skipped" in skipped


# ---- the downsample bench ----------------------------------------------------------

#: what reads the wall clock in a run_downsample_bench result
_BENCH_WALL = ("populate_s", "appends_per_sec", "rollup_ms", "raw_ms", "speedup")


def test_the_downsample_bench_s_deterministic_fields_are_jax_s():
    kw = dict(targets=24, shards=2, horizon_s=21600.0, scrape_interval=30.0,
              window_s=10800.0, at_s=14400.0)
    port, ref = (m["harness"].run_downsample_bench(**kw) for m in BOTH)
    assert set(port) == set(ref)
    assert ({k: v for k, v in port.items() if k not in _BENCH_WALL}
            == {k: v for k, v in ref.items() if k not in _BENCH_WALL})
    assert port["identical"] and port["differential"]["identical"]
    assert port["differential"]["windows_checked"] > 0
    assert port["tier_selected"] and port["rollup_reads"] == {"1h": 2}
    assert port["fleet_series"] == 24 and port["bytes_ratio"] < 0.1
