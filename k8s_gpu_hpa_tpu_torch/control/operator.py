"""The slice-quantum operator: whole-slice scaling on a plain cluster.

Counterpart of ``k8s_gpu_hpa_tpu/control/operator.py``.  Multi-host slices
scale in quanta: one logical replica is ``hosts_per_slice`` pods, and a
partial slice waits at the process group's rendezvous serving nothing.  The
package's own controller keeps the quantum itself (control/hpa.py), but on a
real cluster kube-controller-manager runs the HPA, which has no quantum: a
Percent policy or a mid-range metric can land replicas on a partial slice.

The operator works beside the plain HPA instead of replacing it: it watches
the HPAs annotated ``k8s-tpu-hpa/replica-quantum: "<q>"``
(deploy/tpu-test-multihost-hpa.yaml) and repairs the target's scale
subresource when the HPA lands off a slice boundary:

- growing (desired > current): round up to the next whole slice, since a
  partial slice adds capacity only once complete;
- shrinking (desired < current): release down to the whole slices; the HPA
  moves the same way, so its next sync agrees instead of fighting;
- steady (desired == current) off a boundary: hold.  The plain HPA asserts
  its desired count again at every sync, so a patch here starts a patch war
  without end (the operator releases 3 to 2, the HPA restores 3, for ever)
  that churns the slice's pods.  The stranded host is the lesser evil; the
  package's controller, which owns the count with no second writer, releases
  it instead, the one deliberate difference between the two rules;
- the bounds snap inward to slice multiples, as the controller's do.

A war that remains (a ``minReplicas`` that is no slice multiple, so the
HPA's floor lies under the slice floor) is bounded by a guard: when the
operator's last patch of a target was reverted to the same observed
``(current, hpa_desired)``, the repeat repair is suppressed until that state
changes.

One writer: the Deployment runs one replica, and a coordination.k8s.io
Lease (held by pod name, renewed every reconcile interval) covers the
rolling update, when two replicas overlap: only the holder patches.  A small
HTTP server serves ``/healthz`` (the loop ticked lately), ``/readyz`` (and
holds the lease) and ``/metrics`` (deploy/quantum-operator.yaml).

``/metrics`` serves the counters of reconciles, repairs, suppressions and
lease changes and ``quantum_operator_partial_slice_held``: the steady hold
leaves a stranded host running on purpose, capacity serving nothing, and the
gauge makes that visible to the shipped ``TpuSliceHeldPartial`` alert
(metrics/rules.py).

It speaks plain REST to the API server with the service account's token, no
Kubernetes client library, as exporter/kubeapi.py does.  Run it as
``python -m k8s_gpu_hpa_tpu_torch.control.operator``.
"""

from __future__ import annotations

import json
import math
import os
import ssl
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, HTTPServer

from k8s_gpu_hpa_tpu_torch.control.hpa import QUANTUM_ANNOTATION
from k8s_gpu_hpa_tpu_torch.metrics.exposition import encode_text
from k8s_gpu_hpa_tpu_torch.metrics.schema import MetricFamily

TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
CACERT_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

#: scaleTargetRef.kind -> (API group, plural) of its /scale subresource
SCALE_PATHS = {
    "Deployment": ("apps/v1", "deployments"),
    "StatefulSet": ("apps/v1", "statefulsets"),
    "ReplicaSet": ("apps/v1", "replicasets"),
}


class KubeClient:
    """The least API-server client: GET, PATCH and POST with the pod's
    service-account token."""

    def __init__(
        self,
        api_base: str | None = None,
        token: str | None = None,
        cacert_path: str | None = None,
    ):
        if api_base is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            api_base = f"https://{host}:{port}"
        self.api_base = api_base.rstrip("/")
        self._token = token
        self._cacert_path = cacert_path if cacert_path is not None else CACERT_PATH

    def _read_token(self) -> str:
        if self._token is not None:
            return self._token
        with open(TOKEN_PATH) as f:
            return f.read().strip()

    def _context(self) -> ssl.SSLContext | None:
        if not self.api_base.startswith("https"):
            return None
        if os.path.exists(self._cacert_path):
            return ssl.create_default_context(cafile=self._cacert_path)
        return ssl.create_default_context()

    def _request(self, method: str, path: str, body: dict | None = None) -> dict:
        req = urllib.request.Request(self.api_base + path, method=method)
        req.add_header("Authorization", f"Bearer {self._read_token()}")
        req.add_header("Accept", "application/json")
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            content_type = (
                "application/merge-patch+json" if method == "PATCH" else "application/json"
            )
            req.add_header("Content-Type", content_type)
        with urllib.request.urlopen(req, data=data, timeout=10, context=self._context()) as r:
            return json.loads(r.read().decode() or "{}")

    def get(self, path: str) -> dict:
        return self._request("GET", path)

    def patch(self, path: str, body: dict) -> dict:
        return self._request("PATCH", path, body)

    def post(self, path: str, body: dict) -> dict:
        return self._request("POST", path, body)


class _LeaseLost(Exception):
    """Raised inside a reconcile when the leadership check before a write
    fails."""


class OperatorMetrics:
    """The operator's own Prometheus families, encoded by the package's
    exposition encoder like every other exporter's."""

    def __init__(self):
        self.reconciles_total = 0
        self.repairs_total = {"up": 0, "down": 0}
        self.suppressed_repairs_total = 0
        self.lease_transitions_total = 0
        #: target ("StatefulSet/name") -> 1.0 while the steady hold keeps it
        #: off a slice boundary (a stranded host), else 0.0; a cleared target
        #: stays exported at 0, so the alert sees the change rather than a
        #: series that vanished
        self.partial_slice_held: dict[str, float] = {}

    def set_held(self, target: str, held: bool) -> None:
        self.partial_slice_held[target] = 1.0 if held else 0.0

    def render(self) -> str:
        reconciles = MetricFamily(
            "quantum_operator_reconciles_total",
            "counter",
            "completed reconcile passes over the namespace's annotated HPAs",
        )
        reconciles.add(float(self.reconciles_total))
        repairs = MetricFamily(
            "quantum_operator_repairs_total",
            "counter",
            "scale-subresource patches applied, by direction",
        )
        for direction, count in sorted(self.repairs_total.items()):
            repairs.add(float(count), direction=direction)
        suppressed = MetricFamily(
            "quantum_operator_suppressed_repairs_total",
            "counter",
            "repairs withheld by the revert-war suppression guard",
        )
        suppressed.add(float(self.suppressed_repairs_total))
        lease = MetricFamily(
            "quantum_operator_lease_transitions_total",
            "counter",
            "leadership changes observed by this replica (acquired or lost)",
        )
        lease.add(float(self.lease_transitions_total))
        held = MetricFamily(
            "quantum_operator_partial_slice_held",
            "gauge",
            "1 while the steady-hold rule leaves this target off a slice "
            "boundary (a stranded host serving nothing); alert: TpuSliceHeldPartial",
        )
        # a copy: render() runs on the HTTP thread while the reconcile
        # thread adds targets
        for target, value in sorted(dict(self.partial_slice_held).items()):
            held.add(value, target=target)
        return encode_text([reconciles, repairs, suppressed, lease, held])


@dataclass
class RepairAction:
    hpa: str
    target: str  # "StatefulSet/tpu-test-multihost"
    from_replicas: int
    to_replicas: int
    reason: str


def quantum_desired(
    current: int,
    hpa_desired: int,
    quantum: int,
    min_replicas: int,
    max_replicas: int,
) -> int:
    """The operator's repair rule (the module's docstring says why): growing
    rounds up to a whole slice; shrinking releases down to the whole slices;
    steady off a boundary holds (a patch would start a war with the plain
    HPA, which asserts its count at every sync); under the slice floor it
    grows to it; the bounds snap inward.

    control/hpa.py's quantum rounding but for the steady case, where the
    package's controller, sole owner of the count, releases the partial
    slice instead."""
    q = quantum
    max_q = max_replicas // q * q
    if max_q == 0:
        # maxReplicas cannot fit one whole slice, a misconfiguration
        # (control/hpa.py refuses it); never repair a live workload to 0
        return current
    min_q = min(math.ceil(min_replicas / q) * q, max_q)
    if current % q == 0:
        return current  # on a boundary: nothing to repair
    if hpa_desired > current or current < min_q:
        return min(math.ceil(current / q) * q, max_q)
    if hpa_desired == current:
        # steady off a boundary: hold, as the HPA owns the count and would
        # revert a release at its next sync
        return current
    # shrinking: the partial slice's hosts serve nothing, so release them
    # down to the whole slices, the way the HPA is going
    return max(current // q * q, min_q)


class QuantumOperator:
    """One reconcile loop over a namespace's annotated HPAs."""

    def __init__(
        self,
        client: KubeClient,
        namespace: str = "default",
        elector: "LeaseElector | None" = None,
    ):
        self.client = client
        self.namespace = namespace
        self.elector = elector
        self.metrics = OperatorMetrics()
        #: targets visited in this pass (to clear the gauge of stale ones)
        self._seen_targets: set[str] = set()
        #: the leadership last seen, for the transition counter
        self._was_leader: bool | None = None
        #: liveness: monotonic time of the last finished loop iteration
        self.last_tick: float = time.monotonic()
        #: target -> (current, hpa_desired, patched_to) of its last repair,
        #: for the suppression guard
        self._last_repair: dict[str, tuple[int, int, int]] = {}
        #: targets whose suppression was logged (once an episode)
        self._suppressed_logged: set[str] = set()
        #: HPAs whose quantum over maxReplicas was logged once
        self._misconfig_logged: set[str] = set()
        #: HPA name -> its last logged reconcile error (logged when it
        #: changes, cleared on success, so a deleted target does not log at
        #: every tick)
        self._error_logged: dict[str, str] = {}

    def _list_hpas(self) -> list[dict]:
        path = f"/apis/autoscaling/v2/namespaces/{self.namespace}/horizontalpodautoscalers"
        return self.client.get(path).get("items", [])

    def reconcile_once(self) -> list[RepairAction]:
        actions: list[RepairAction] = []
        self._seen_targets = set()
        aborted = False
        for hpa in self._list_hpas():
            name = hpa.get("metadata", {}).get("name", "?")
            try:
                action = self._reconcile_hpa(hpa)
            except _LeaseLost:
                # a slow pass can outlive the lease while a standby already
                # patches: abort the pass rather than write beside it
                print("lost lease mid-reconcile; aborting pass", flush=True)
                aborted = True
                break
            except Exception as e:
                # one malformed HPA (a mistyped annotation, a deleted target)
                # must not keep the others from their repairs, nor log at
                # every tick: log when the message changes
                message = f"{type(e).__name__}: {e}"
                if self._error_logged.get(name) != message:
                    self._error_logged[name] = message
                    print(
                        f"reconcile error for HPA {name}: {message} "
                        "(continuing; logged once until it changes)",
                        flush=True,
                    )
                continue
            self._error_logged.pop(name, None)
            if action is not None:
                actions.append(action)
        if not aborted:
            # a target whose HPA vanished (or lost its annotation) during a
            # hold must not page for ever
            for target in self.metrics.partial_slice_held:
                if target not in self._seen_targets:
                    self.metrics.set_held(target, False)
            # finished passes only (the family's help): a replica whose lease
            # flaps and aborts must not read as reconciling
            self.metrics.reconciles_total += 1
        return actions

    def _reconcile_hpa(self, hpa: dict) -> RepairAction | None:
        annotations = hpa["metadata"].get("annotations", {})
        if QUANTUM_ANNOTATION not in annotations:
            return None
        q = int(annotations[QUANTUM_ANNOTATION])
        if q <= 1:
            return None
        spec = hpa["spec"]
        ref = spec["scaleTargetRef"]
        if ref["kind"] not in SCALE_PATHS:
            return None
        name = hpa["metadata"]["name"]
        max_replicas = int(spec["maxReplicas"])
        if q > max_replicas:
            # quantum_desired holds here; say why, once
            if name not in self._misconfig_logged:
                self._misconfig_logged.add(name)
                print(
                    f"HPA {name}: quantum {q} exceeds maxReplicas "
                    f"{max_replicas} — cannot fit one whole slice; holding",
                    flush=True,
                )
            return None
        self._misconfig_logged.discard(name)
        group, plural = SCALE_PATHS[ref["kind"]]
        # seen before any API call that can fail for a moment: one flaky GET
        # must not make the cleanup take the target for deleted and zero its
        # gauge (which would restart the alert's for: timer)
        target = f"{ref['kind']}/{ref['name']}"
        self._seen_targets.add(target)
        scale_path = f"/apis/{group}/namespaces/{self.namespace}/{plural}/{ref['name']}/scale"
        scale = self.client.get(scale_path)
        current = int(scale.get("spec", {}).get("replicas") or 0)
        if current == 0:
            return None  # a suspended or empty target is not the operator's
        hpa_desired = int(hpa.get("status", {}).get("desiredReplicas") or current)
        desired = quantum_desired(
            current, hpa_desired, q, int(spec.get("minReplicas", 1)), max_replicas
        )
        # the steady hold made visible: off a boundary with the HPA steady, a
        # stranded host is left running on purpose
        self.metrics.set_held(
            target, desired == current and current % q != 0 and hpa_desired == current
        )
        if desired == current:
            last = self._last_repair.get(target)
            if last is not None and current == last[2] and hpa_desired == last[1]:
                # only our own last patch holding (the operator ticks faster
                # than the HPA syncs): the episode goes on, and the memory
                # stays so the HPA's coming revert is suppressed
                return None
            # a state that needs nothing (or one someone else moved to):
            # the episode is over
            self._last_repair.pop(target, None)
            self._suppressed_logged.discard(target)
            return None
        last = self._last_repair.get(target)
        if last is not None and last[:2] == (current, hpa_desired):
            # this very state was repaired and then reverted (by the plain
            # HPA): repeating the patch would loop for ever
            self.metrics.suppressed_repairs_total += 1
            if target not in self._suppressed_logged:
                self._suppressed_logged.add(target)
                print(
                    f"suppressing repeat repair of {target}: "
                    f"({current}, hpa_desired={hpa_desired}) -> {last[2]} "
                    "was reverted; another controller owns this count "
                    "(check that minReplicas/maxReplicas are slice "
                    "multiples)",
                    flush=True,
                )
            return None
        if self.elector is not None and not self.elector.still_leader():
            # leadership checked again right before each write (a target can
            # cost two 10 s API timeouts)
            raise _LeaseLost()
        self.client.patch(scale_path, {"spec": {"replicas": desired}})
        self._last_repair[target] = (current, hpa_desired, desired)
        self._suppressed_logged.discard(target)
        direction = "up" if desired > current else "down"
        self.metrics.repairs_total[direction] += 1
        return RepairAction(
            hpa=name,
            target=target,
            from_replicas=current,
            to_replicas=desired,
            reason=f"partial slice (quantum {q}): rounded {direction} {current}->{desired}",
        )

    def tick(self) -> list[RepairAction]:
        """One loop iteration: the leader check (when electing), then a
        reconcile."""
        if self.elector is not None:
            leader = self.elector.ensure_leader()
            if self._was_leader is not None and leader != self._was_leader:
                self.metrics.lease_transitions_total += 1
            self._was_leader = leader
            if not leader:
                return []
        return self.reconcile_once()

    def run_forever(self, interval: float = 5.0) -> None:
        while True:
            try:
                for action in self.tick():
                    print(f"repaired {action.target}: {action.reason}", flush=True)
            except Exception as e:  # an API blip: log, retry at the next tick
                print(f"reconcile error: {e}", flush=True)
            self.last_tick = time.monotonic()
            time.sleep(interval)


class LeaseElector:
    """Leadership over a coordination.k8s.io/v1 Lease, in plain REST.

    One replica runs (``strategy: Recreate``); the lease covers the windows
    where two operator pods still coexist (a pod stuck terminating on a
    cordoned node, a Deployment scaled up by hand): the patch loop runs only
    while ``ensure_leader()`` is true.  The protocol is client-go's: acquire
    when the Lease is absent, or when its ``renewTime`` has stayed the same
    on our monotonic clock for the duration its holder wrote (never by
    comparing the holder's wall clock with ours: clock skew would elect two
    leaders); renew while we hold it; else stand by.  Acquiring and renewing
    send the ``resourceVersion`` read, so a race to take over elects one
    winner (the loser's patch gets 409)."""

    def __init__(
        self,
        client: KubeClient,
        namespace: str,
        identity: str,
        name: str = "quantum-operator",
        lease_duration: float = 30.0,
    ):
        self.client = client
        self.namespace = namespace
        self.identity = identity
        self.name = name
        self.lease_duration = lease_duration
        self.is_leader = False
        #: monotonic time of the last acquire or renew
        self._last_renew = float("-inf")
        #: (renewTime as read, our monotonic time when first read): expiry
        #: is how long the holder's renewTime has stayed the same on our clock
        self._observed: tuple[str | None, float] | None = None

    @property
    def _path(self) -> str:
        return f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}/leases/{self.name}"

    @staticmethod
    def _now() -> str:
        # a MicroTime in the Kubernetes wire format (UTC, microseconds, "Z")
        return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()) + ".000000Z"

    def _spec(self) -> dict:
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration),
            "renewTime": self._now(),
        }

    def ensure_leader(self) -> bool:
        """Acquire or renew the Lease; whether we hold it now."""
        try:
            try:
                lease = self.client.get(self._path)
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    raise
                self.client.post(
                    f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}/leases",
                    {
                        "apiVersion": "coordination.k8s.io/v1",
                        "kind": "Lease",
                        "metadata": {"name": self.name},
                        "spec": self._spec(),
                    },
                )
                self.is_leader = True
                self._last_renew = time.monotonic()
                return True
            spec = lease.get("spec", {})
            holder = spec.get("holderIdentity")
            renew = spec.get("renewTime") or spec.get("acquireTime")
            # the duration the holder wrote (two versions of the pod can run
            # different durations), measured on our own monotonic clock
            holder_duration = float(spec.get("leaseDurationSeconds") or self.lease_duration)
            now_mono = time.monotonic()
            if self._observed is None or self._observed[0] != renew:
                self._observed = (renew, now_mono)
            expired = renew is None or now_mono - self._observed[1] > holder_duration
            if holder == self.identity or holder is None or expired:
                # two candidates can both see the lease expired: the
                # resourceVersion has the API server refuse the loser's
                # patch with 409, where a plain merge patch would elect both
                body: dict = {"spec": self._spec()}
                rv = lease.get("metadata", {}).get("resourceVersion")
                if rv is not None:
                    body["metadata"] = {"resourceVersion": rv}
                try:
                    self.client.patch(self._path, body)
                except urllib.error.HTTPError as e:
                    if e.code == 409:  # lost the race: stand down
                        self.is_leader = False
                        return False
                    raise
                self.is_leader = True
                self._last_renew = time.monotonic()
            else:
                self.is_leader = False
        except Exception as e:
            # the Lease cannot be read or written: stand down (a non-leader
            # that patches is worse than a missed interval)
            print(f"lease error ({self.name}): {e}", flush=True)
            self.is_leader = False
        return self.is_leader

    def still_leader(self) -> bool:
        """The check before each scale patch: a renew younger than a third
        of the lease is trusted, else the lease is acquired again first, so a
        pass that outlives the lease cannot write beside a standby that took
        over."""
        if not self.is_leader:
            return False
        if time.monotonic() - self._last_renew < self.lease_duration / 3:
            return True
        return self.ensure_leader()


def start_health_server(
    operator: QuantumOperator, port: int, stale_after: float = 60.0, host: str = "0.0.0.0"
) -> HTTPServer:
    """``/healthz``: the loop ticked within ``stale_after`` s; ``/readyz``:
    that, and the lease held (when electing); ``/metrics``: the operator's
    own families (``OperatorMetrics``).  It serves on a daemon thread; port 0
    takes a free port (``server.server_port``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            fresh = time.monotonic() - operator.last_tick < stale_after
            if self.path == "/metrics":
                body = operator.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/healthz":
                ok = fresh
            elif self.path == "/readyz":
                ok = fresh and (operator.elector is None or operator.elector.is_leader)
            else:
                self.send_response(404)
                self.end_headers()
                return
            body = b"ok" if ok else b"stale"
            self.send_response(200 if ok else 503)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = HTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main() -> None:
    """``python -m k8s_gpu_hpa_tpu_torch.control.operator``, the operator's
    container.

    Environment: NAMESPACE ("default"), INTERVAL_S (5), HEALTH_PORT (8086;
    0 turns the server off), LEASE_NAME ("quantum-operator"; empty turns the
    election off), POD_NAME (the lease holder's identity)."""
    namespace = os.environ.get("NAMESPACE", "default")
    client = KubeClient()
    interval = float(os.environ.get("INTERVAL_S", "5"))
    lease_name = os.environ.get("LEASE_NAME", "quantum-operator")
    elector = None
    if lease_name:
        elector = LeaseElector(
            client,
            namespace,
            identity=os.environ.get("POD_NAME", os.uname().nodename),
            name=lease_name,
            # it must outlive a sleep and a reconcile, or it expires every
            # cycle and the standbys take over for nothing
            lease_duration=max(30.0, 4 * interval),
        )
    operator = QuantumOperator(client, namespace=namespace, elector=elector)
    health_port = int(os.environ.get("HEALTH_PORT", "8086"))
    if health_port:
        # liveness must allow a whole healthy cycle, a sleep and a slow
        # reconcile, or a long INTERVAL_S restarts a healthy pod in a loop
        start_health_server(operator, health_port, stale_after=max(60.0, 4 * interval))
    print(
        f"slice-quantum operator: namespace={operator.namespace}, "
        f"annotation={QUANTUM_ANNOTATION}, "
        f"lease={lease_name or 'disabled'}, health_port={health_port}",
        flush=True,
    )
    operator.run_forever(interval=interval)


if __name__ == "__main__":
    main()
