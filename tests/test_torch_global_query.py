"""The object store (``metrics/objstore.py``) and the sealed exchange with
its global query layer (``metrics/global_query.py``) against the JAX
package's.

- The sealed-generation protocol torn at every byte of the blob and of the
  seal, a sealed blob corrupted in place, a region never published and a
  republish after a torn generation: at each cut the port's reader serves
  what JAX's serves on JAX's store, and the last good generation.
- The seeded differential: two downsampling regional DBs fed the same
  random samples in each package, published, read back, merged and
  restored; the port's global basket equals its merged reference and JAX's
  global basket, across raw windows and every rollup tier.
- ``encode_payload``, ``merge_payloads``, ``combined_payload_of`` (on a
  FederatedTSDB of members) and ``basket_fingerprint`` give JAX's values.
- The layer's region-scoped ``invalidate``, its stale serve in an outage,
  and the store's nested outages, latency and counters, as JAX's.

Tolerance: exact (virtual time, canonical JSON, bit-identical floats).
"""

import random

import pytest
import torch

from k8s_gpu_hpa_tpu.metrics import global_query as jax_gq
from k8s_gpu_hpa_tpu.metrics import objstore as jax_os
from k8s_gpu_hpa_tpu.metrics.downsample import DownsamplePolicy as JaxPolicy
from k8s_gpu_hpa_tpu.metrics.federation import FederatedTSDB as JaxFederated
from k8s_gpu_hpa_tpu.metrics.tsdb import TimeSeriesDB as JaxTSDB
from k8s_gpu_hpa_tpu.utils.clock import VirtualClock as JaxClock
from k8s_gpu_hpa_tpu_torch.metrics import global_query as gq
from k8s_gpu_hpa_tpu_torch.metrics import objstore
from k8s_gpu_hpa_tpu_torch.metrics.downsample import DownsamplePolicy
from k8s_gpu_hpa_tpu_torch.metrics.federation import FederatedTSDB
from k8s_gpu_hpa_tpu_torch.metrics.tsdb import TimeSeriesDB
from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

torch.set_num_threads(1)

PORT = dict(gq=gq, os=objstore, TSDB=TimeSeriesDB, Clock=VirtualClock, Policy=DownsamplePolicy,
            Federated=FederatedTSDB)
JAX = dict(gq=jax_gq, os=jax_os, TSDB=JaxTSDB, Clock=JaxClock, Policy=JaxPolicy,
           Federated=JaxFederated)


def _small_payloads(pkg):
    """Two generations of a small snapshot payload (test_evacuate.py's)."""
    clock = pkg["Clock"]()
    db = pkg["TSDB"](clock, lookback=300.0)
    for i in range(6):
        db.append("util", (("node", "n0"),), 10.0 + i)
        db.append("util", (("node", "n1"),), 50.0 - i)
        clock.advance(5.0)
    gen1 = db.snapshot_payload()
    for i in range(4):
        db.append("util", (("node", "n0"),), 99.0 - i)
        clock.advance(5.0)
    gen2 = db.snapshot_payload()
    return clock, gen1, gen2


@pytest.fixture(scope="module")
def payloads():
    port, ref = _small_payloads(PORT), _small_payloads(JAX)
    assert gq.encode_payload(port[1]) == jax_gq.encode_payload(ref[1])
    assert gq.encode_payload(port[2]) == jax_gq.encode_payload(ref[2])
    assert gq.encode_payload(port[1]) != gq.encode_payload(port[2])
    return {"port": port, "jax": ref}


def _torn_read(pkg, clock, gen1, gen2, **tear):
    """Publish gen 1 whole and gen 2 torn as ``tear`` says; what the reader
    serves then, as (generation, canonical bytes) or None."""
    store = pkg["os"].SimObjectStore(clock)
    pkg["gq"].publish_snapshot(store, "us", 1, gen1)
    with pytest.raises(pkg["os"].TornUpload):
        pkg["gq"].publish_snapshot(store, "us", 2, gen2, **tear)
    got = pkg["gq"].read_latest_sealed(store, "us")
    return None if got is None else (got[0], pkg["gq"].encode_payload(got[1]))


@pytest.mark.parametrize("part", ["blob", "seal"])
def test_a_generation_torn_at_every_byte_falls_back_as_jax_s(payloads, part):
    """Tear generation 2's blob (its seal is then never written) or its seal
    (the blob is whole, the seal a prefix that never parses) at every byte:
    the reader serves generation 1 intact at each cut, as JAX's does."""
    port_clock, p1, p2 = payloads["port"]
    jax_clock, j1, j2 = payloads["jax"]
    if part == "blob":
        size = len(gq.encode_payload(p2))
    else:
        size = len(gq.encode_payload(gq.publish_snapshot(objstore.SimObjectStore(port_clock),
                                                         "probe", 1, p2)))
    want_gen1 = (1, gq.encode_payload(p1))
    for offset in range(size):
        tear = {f"fail_{part}_after": offset}
        got = _torn_read(PORT, port_clock, p1, p2, **tear)
        assert got == want_gen1, f"{part} torn at byte {offset}: served {got and got[0]}"
        assert got == _torn_read(JAX, jax_clock, j1, j2, **tear)


def test_a_sealed_blob_corrupted_in_place_is_skipped_by_its_crc(payloads):
    for name, pkg in (("port", PORT), ("jax", JAX)):
        clock, gen1, gen2 = payloads[name]
        store = pkg["os"].SimObjectStore(clock)
        pkg["gq"].publish_snapshot(store, "us", 1, gen1)
        pkg["gq"].publish_snapshot(store, "us", 2, gen2)
        blob2 = bytearray(pkg["gq"].encode_payload(gen2))
        blob2[len(blob2) // 2] ^= 0xFF  # the same size, a wrong CRC
        store.put("regions/us/gen/00000002", bytes(blob2))
        generation, payload = pkg["gq"].read_latest_sealed(store, "us")
        assert generation == 1
        assert gq.encode_payload(payload) == gq.encode_payload(payloads["port"][1])


def test_a_region_never_published_is_a_miss():
    assert gq.read_latest_sealed(objstore.SimObjectStore(VirtualClock()), "never-published") is None
    assert jax_gq.read_latest_sealed(jax_os.SimObjectStore(JaxClock()), "never-published") is None


def test_a_republish_after_a_torn_generation_is_served(payloads):
    """A torn generation 2 and then a good 3: the reader serves 3 (the
    fallback is by generation; the region is not poisoned)."""
    for name, pkg in (("port", PORT), ("jax", JAX)):
        clock, gen1, gen2 = payloads[name]
        store = pkg["os"].SimObjectStore(clock)
        pkg["gq"].publish_snapshot(store, "us", 1, gen1)
        with pytest.raises(pkg["os"].TornUpload):
            pkg["gq"].publish_snapshot(store, "us", 2, gen2, fail_seal_after=3)
        pkg["gq"].publish_snapshot(store, "us", 3, gen2)
        generation, payload = pkg["gq"].read_latest_sealed(store, "us")
        assert generation == 3
        assert gq.encode_payload(payload) == gq.encode_payload(payloads["port"][2])


def test_the_seal_and_the_store_s_counters_are_jax_s(payloads):
    port_clock, p1, p2 = payloads["port"]
    jax_clock, j1, j2 = payloads["jax"]
    stores = objstore.SimObjectStore(port_clock), jax_os.SimObjectStore(jax_clock)
    seals = [
        gq.publish_snapshot(stores[0], "us", 1, p1),
        jax_gq.publish_snapshot(stores[1], "us", 1, j1),
    ]
    assert seals[0] == seals[1]
    for store, mod, gen in ((stores[0], gq, p2), (stores[1], jax_gq, j2)):
        with pytest.raises((objstore.TornUpload, jax_os.TornUpload)):
            mod.publish_snapshot(store, "us", 2, gen, fail_blob_after=10)
        mod.read_latest_sealed(store, "us")
        assert store.delete("regions/us/gen/00000002") is True
        assert store.delete("regions/us/gen/00000002") is False
    assert stores[0].stats() == stores[1].stats()
    assert stores[0].stats()["torn_uploads"] == 1


def test_the_store_s_latency_and_nested_outages_are_jax_s():
    """A put is invisible to get and list until its latency passes; outage
    windows nest, every call inside one raises and is counted, and the
    store is available again only when the last window closes."""
    outcomes = []
    for os_mod, clock in ((objstore, VirtualClock()), (jax_os, JaxClock())):
        store = os_mod.SimObjectStore(clock, latency_s=2.0)
        store.put("a/1", b"x")
        seen = [store.list("a/")]
        with pytest.raises(KeyError):
            store.get("a/1")
        clock.advance(2.0)
        seen += [store.list("a/"), store.get("a/1")]
        store.begin_outage()
        store.begin_outage()
        for call in (lambda: store.get("a/1"), lambda: store.list(), lambda: store.put("b", b"y")):
            with pytest.raises(os_mod.ObjectStoreUnavailable):
                call()
        store.end_outage()
        seen.append(store.available)
        with pytest.raises(ConnectionError):
            store.delete("a/1")
        store.end_outage()
        store.end_outage()  # one more than were opened: no underflow
        seen += [store.available, store.list(), store.stats()]
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][:4] == [[], ["a/1"], b"x", False]
    assert outcomes[0][-1]["outage_errors"] == 4


# ---- the seeded differential ------------------------------------------------


def _regional_dbs(pkg, seed: int):
    """Two downsampling regional DBs driven until sealed chunks age past the
    horizon, so every rollup tier holds rows (test_evacuate.py's)."""
    rng = random.Random(seed)
    clock = pkg["Clock"]()
    policy = pkg["Policy"](steps=(60.0, 300.0), horizon=120.0)
    dbs = {
        region: pkg["TSDB"](clock, lookback=300.0, retention=86400.0, downsample=policy)
        for region in ("us", "eu")
    }
    for tick in range(1200):
        for region, db in dbs.items():
            db.append("util", (("node", f"{region}-0"),), rng.uniform(0, 100))
            if tick % 3 == 0:
                db.append("util", (("node", f"{region}-1"),), rng.uniform(0, 100))
        clock.advance(1.0)
    return clock, dbs


def _exchange(pkg, seed: int):
    clock, dbs = _regional_dbs(pkg, seed)
    store = pkg["os"].SimObjectStore(clock)
    layer = pkg["gq"].GlobalQueryLayer(clock, store)
    payloads = {}
    for region, db in dbs.items():
        payloads[region] = pkg["gq"].combined_payload_of(db)
        pkg["gq"].publish_snapshot(store, region, 1, payloads[region])
        layer.register_region(region)
    reference = pkg["gq"].restore_payload(pkg["gq"].merge_payloads(payloads), clock)
    return clock, layer.db(), reference, payloads


@pytest.fixture(scope="module")
def exchanges():
    return _exchange(PORT, 0xE19), _exchange(JAX, 0xE19)


def test_the_merged_payload_is_jax_s(exchanges):
    (_, _, _, port), (_, _, _, ref) = exchanges
    assert gq.encode_payload(port["us"]) == jax_gq.encode_payload(ref["us"])
    merged = gq.merge_payloads(port)
    assert gq.encode_payload(merged) == jax_gq.encode_payload(jax_gq.merge_payloads(ref))
    assert merged["downsample"] == port["eu"]["downsample"]  # the first region's, sorted
    assert merged["versions"] == {"util": sum(p["versions"]["util"] for p in port.values())}
    assert {pair[1] for e in merged["series"] for pair in e["labels"] if pair[0] == "region"} == {
        "us", "eu"}


def test_global_reads_equal_the_merged_reference_and_jax_s(exchanges):
    """The exchange path (snapshot, publish, sealed read, merge, restore)
    against a direct merge of the same payloads, and against JAX's global
    DB, over seeded random windows and anchors: unaligned ones (the tiers
    answer None on every side) and step-aligned ones inside the compacted
    span (the tiers serve rows)."""
    (clock, port_db, port_ref, _), (_, jax_db, _, _) = exchanges
    assert tuple(port_db.rollup_steps) == tuple(port_ref.rollup_steps) == (60.0, 300.0)
    rng = random.Random(0xE19 + 1)
    now = clock.now()
    saw_rollup_rows = False
    for trial in range(30):
        if trial % 2 == 0:
            windows = sorted(rng.uniform(10.0, 900.0) for _ in range(2))
            at = now - rng.uniform(0.0, 240.0)
        else:
            step = rng.choice((60.0, 300.0))
            windows = [step * rng.randint(1, 3)]
            at = step * rng.randint(max(1, int(300 // step)), int(900 // step))
        got = gq.query_basket(port_db, ["util"], windows, at)
        assert got == gq.query_basket(port_ref, ["util"], windows, at)
        assert got == jax_gq.query_basket(jax_db, ["util"], windows, at)
        assert gq.basket_fingerprint(got) == jax_gq.basket_fingerprint(got)
        saw_rollup_rows = saw_rollup_rows or any(
            rows for key, rows in got["util"].items() if key.startswith("rollup_") and rows
        )
    assert saw_rollup_rows, "the differential never read a rollup tier"


def test_a_federated_db_s_combined_payload_is_jax_s():
    """``combined_payload_of`` over a FederatedTSDB's members: merged with
    the member tags stripped, as JAX's."""
    out = []
    for pkg in (PORT, JAX):
        clock = pkg["Clock"]()
        members = [pkg["TSDB"](clock) for _ in range(3)]
        fed = pkg["Federated"](members[0], members[1:])
        for i in range(5):
            members[0].append("up", (("job", "g"),), 1.0)
            members[1].append("util", (("node", "a"),), 10.0 + i)
            members[2].append("util", (("node", "b"),), 20.0 - i)
            clock.advance(15.0)
        payload = pkg["gq"].combined_payload_of(fed)
        out.append(gq.encode_payload(payload))
        assert not any(p[0] == "region" for e in payload["series"] for p in e["labels"])
        assert payload["versions"] == {"up": 5, "util": 10}
    assert out[0] == out[1]


# ---- the layer's cache ------------------------------------------------------


def test_invalidate_is_scoped_to_one_region(payloads):
    """Invalidating region A leaves B's cached payload (the same object) in
    place; the next read brings A back at its generation."""
    clock, gen1, gen2 = payloads["port"]
    store = objstore.SimObjectStore(clock)
    gq.publish_snapshot(store, "a", 1, gen1)
    gq.publish_snapshot(store, "b", 1, gen2)
    layer = gq.GlobalQueryLayer(clock, store)
    layer.register_region("a")
    layer.register_region("b")
    first = layer.db()
    cached_b = layer.cached_payload("b")
    assert cached_b is not None and layer.db() is first  # no generation moved
    layer.invalidate("a")
    assert layer.cached_generation("a") is None
    assert layer.cached_payload("b") is cached_b
    assert layer.db() is not first
    assert layer.cached_generation("a") == 1
    assert layer.cached_payload("b") is cached_b


def test_a_refresh_in_an_outage_serves_stale_as_jax_s(payloads):
    outcomes = []
    for name, pkg in (("port", PORT), ("jax", JAX)):
        clock, gen1, _ = payloads[name]
        store = pkg["os"].SimObjectStore(clock)
        pkg["gq"].publish_snapshot(store, "a", 1, gen1)
        layer = pkg["gq"].GlobalQueryLayer(clock, store)
        layer.register_region("a")
        layer.register_region("never")
        seen = [layer.refresh()]
        store.begin_outage()
        seen.append(layer.refresh())
        store.end_outage()
        seen += [layer.refresh(), layer.status()]
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    stale = outcomes[0][1]
    assert stale == {"generations": {"a": 1, "never": None}, "stale": True}
    assert outcomes[0][2]["stale"] is False
    assert outcomes[0][3]["stale_serves"] == 2  # a region each: "a" and "never"
