"""The port's kubelet attribution against the JAX package's: the protobuf
wire codec on the same bytes, ``parse_list_response`` on the same kubelet
responses for integer device ids, the port's UUID resolution (NVIDIA's
device plugin names devices ``GPU-…``), and ``PodResourcesClient`` against a
fake kubelet ``PodResourcesLister/List`` gRPC server on a unix socket."""

import struct
from concurrent import futures

import pytest

from k8s_gpu_hpa_tpu.exporter import podresources as jax_podresources
from k8s_gpu_hpa_tpu.utils import protowire as jax_protowire
from k8s_gpu_hpa_tpu_torch.exporter import podresources
from k8s_gpu_hpa_tpu_torch.exporter.podresources import (
    GPU_RESOURCE,
    PodResourcesClient,
    parse_device_index,
    parse_list_response,
)
from k8s_gpu_hpa_tpu_torch.utils import protowire
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)


def _message(field: int, payload: bytes) -> bytes:
    return protowire.encode_tag(field, protowire.BYTES) + protowire.encode_varint(len(payload)) + payload


def kubelet_response(pods, resource=GPU_RESOURCE, unknown_fields=False) -> bytes:
    """A ListPodResourcesResponse: ``pods`` is [(namespace, name,
    [[device ids of one container], ...])]."""
    body = b""
    for namespace, name, containers in pods:
        pod = protowire.encode_string(1, name) + protowire.encode_string(2, namespace)
        for i, ids in enumerate(containers):
            devices = protowire.encode_string(1, resource) + b"".join(
                protowire.encode_string(2, d) for d in ids)
            if unknown_fields:  # a newer kubelet's topology field, say
                devices += protowire.encode_uint(3, 7)
            container = protowire.encode_string(1, f"c{i}") + _message(2, devices)
            pod += _message(3, container)
        if unknown_fields:
            pod += protowire.encode_double(9, 1.5)
        body += _message(1, pod)
    return body


WIRE_CASES = {
    "varints": b"".join(protowire.encode_uint(3, v) for v in (0, 1, 127, 128, 300, 2**32, 2**63)),
    "strings": protowire.encode_string(2, "kube-system") + protowire.encode_string(15, b"\x00\xff"),
    "fixed": protowire.encode_tag(4, protowire.FIXED32) + struct.pack("<I", 7)
    + protowire.encode_double(5, -2.25),
    "kubelet": kubelet_response([("default", "a", [["0", "1"]]), ("ns", "b", [["GPU-1"], ["3"]])],
                                unknown_fields=True),
    "truncated_string": protowire.encode_string(1, "hello")[:-2],
    "truncated_varint": b"\x08\xff",
    "truncated_fixed64": protowire.encode_tag(1, protowire.FIXED64) + b"\x00" * 3,
    "truncated_fixed32": protowire.encode_tag(1, protowire.FIXED32) + b"\x00",
    "group_wire_type": bytes([0x0B]),
    "overlong_varint": b"\x08" + b"\xff" * 10 + b"\x01",
    "empty": b"",
}


def _decode(module, data):
    try:
        return ("ok", module.decode_fields(data), module.fields_by_number(data))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_protowire_decodes_like_the_jax_package(case):
    data = WIRE_CASES[case]
    assert _decode(protowire, data) == _decode(jax_protowire, data)


@pytest.mark.parametrize(
    "encode,args",
    [("encode_varint", (300,)), ("encode_tag", (19, 2)), ("encode_string", (3, "nvidia.com/gpu")),
     ("encode_string", (1, b"\x01\x02")), ("encode_uint", (7, 2**40)), ("encode_double", (2, 0.1))],
)
def test_protowire_encodes_like_the_jax_package(encode, args):
    assert getattr(protowire, encode)(*args) == getattr(jax_protowire, encode)(*args)


def test_protowire_reinterpretations_and_refusals_match():
    for raw in (0, 1, 2, 3, 2**64 - 1, struct.unpack("<Q", struct.pack("<d", -7.5))[0]):
        assert protowire.as_sint(raw) == jax_protowire.as_sint(raw)
        a, b = protowire.as_double(raw), jax_protowire.as_double(raw)
        assert a == b or (a != a and b != b)  # NaN payloads
    for module in (protowire, jax_protowire):
        with pytest.raises(ValueError):
            module.encode_varint(-1)


@pytest.mark.parametrize(
    "device_id", ["0", "3", "12", "nvidia7", "/dev/nvidia2", "accel5 ", "x", ""]
)
def test_parse_device_index_equals_the_jax_package(device_id):
    assert parse_device_index(device_id) == jax_podresources.parse_device_index(device_id)


INTEGER_RESPONSES = {
    "one_pod": [("default", "tpu-test-real", [["0"]])],
    "two_pods": [("default", "a", [["0", "1"]]), ("team", "b", [["2"], ["3"]])],
    "paths": [("default", "a", [["/dev/nvidia4", "nvidia5"]])],
    "reassigned": [("default", "old", [["1"]]), ("default", "new", [["1"]])],
    "no_devices": [("default", "idle", [[]])],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(INTEGER_RESPONSES))
@pytest.mark.parametrize("unknown_fields", [False, True])
def test_integer_ids_parse_as_the_jax_package_does(case, unknown_fields):
    data = kubelet_response(INTEGER_RESPONSES[case], unknown_fields=unknown_fields)
    want = jax_podresources.parse_list_response(data, GPU_RESOURCE)
    assert parse_list_response(data) == want
    assert parse_list_response(data, GPU_RESOURCE, resolve_uuid=lambda u: 99) == want


def test_other_resources_are_ignored():
    data = kubelet_response([("default", "tpu", [["0"]])], resource="google.com/tpu")
    data += kubelet_response([("default", "gpu", [["1"]])])
    assert parse_list_response(data) == {1: ("default", "gpu")}


# a UUID that ends in digits: the trailing-integer rule would read index 7
UUID_ENDING_IN_DIGITS = "GPU-12ab2938-905b-7039-2e15-9ce2bc90abc7"
UUID_OTHER = "GPU-f90076c0-bc23-0d78-d72c-5f6899b6ffd1"
UUID_UNKNOWN = "GPU-00000000-0000-0000-0000-0000000000f3"


def test_uuids_resolve_through_the_resolver_never_the_trailing_integer():
    indices = {UUID_ENDING_IN_DIGITS: 0, UUID_OTHER: 1}
    data = kubelet_response([
        ("default", "tpu-test-real", [[UUID_ENDING_IN_DIGITS]]),
        ("team", "b", [[UUID_OTHER, UUID_UNKNOWN]]),
        ("team", "c", [["5"]]),
        ("team", "mig", [["MIG-12ab2938-905b-7039-2e15-9ce2bc900002"]]),
    ])
    mapping = parse_list_response(data, resolve_uuid=indices.get)
    assert mapping == {0: ("default", "tpu-test-real"), 1: ("team", "b"), 5: ("team", "c")}
    # the JAX package's rule reads the UUIDs' trailing digits: what the port avoids
    jax_mapping = jax_podresources.parse_list_response(data, GPU_RESOURCE)
    assert jax_mapping[7] == ("default", "tpu-test-real")
    assert jax_mapping[3] == ("team", "b")


def test_without_a_resolver_every_uuid_is_skipped():
    data = kubelet_response([("default", "a", [[UUID_ENDING_IN_DIGITS, "2"]])])
    assert parse_list_response(data) == {2: ("default", "a")}


def test_importing_the_module_needs_no_grpc():
    # grpc is imported inside list_allocations only
    assert "grpc" not in vars(podresources)


@pytest.fixture
def fake_kubelet(tmp_path):
    """A kubelet PodResourcesLister/List server on a unix socket, answering
    with the bytes in ``kubelet.response`` and counting the calls."""
    grpc = pytest.importorskip("grpc")

    class Kubelet:
        response = b""
        calls = 0

    kubelet = Kubelet()

    def handle(request, context):
        kubelet.calls += 1
        assert request == b""  # an empty ListPodResourcesRequest
        return kubelet.response

    class Handler(grpc.GenericRpcHandler):
        def service(self, call_details):
            if call_details.method != "/v1.PodResourcesLister/List":
                return None
            return grpc.unary_unary_rpc_method_handler(
                handle, request_deserializer=lambda raw: raw,
                response_serializer=lambda raw: raw)

    socket_path = tmp_path / "kubelet.sock"
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((Handler(),))
    assert server.add_insecure_port(f"unix://{socket_path}") != 0
    server.start()
    kubelet.socket_path = str(socket_path)
    try:
        yield kubelet
    finally:
        server.stop(grace=0).wait()


def test_client_reads_the_fake_kubelet(fake_kubelet):
    fake_kubelet.response = kubelet_response([
        ("default", "tpu-test-real", [[UUID_OTHER]]),
        ("default", "tpu-test-sim1", [["3"]]),
        ("default", "tpu", [["0"]]),
    ])
    client = PodResourcesClient(socket_path=fake_kubelet.socket_path,
                                resolve_uuid={UUID_OTHER: 2}.get)
    assert client.resource_name == GPU_RESOURCE
    assert client.list_allocations() == {
        2: ("default", "tpu-test-real"), 3: ("default", "tpu-test-sim1"), 0: ("default", "tpu"),
    }
    assert fake_kubelet.calls == 1


def test_client_raises_when_the_kubelet_is_absent(tmp_path):
    grpc = pytest.importorskip("grpc")
    client = PodResourcesClient(socket_path=str(tmp_path / "missing.sock"))
    with pytest.raises(grpc.RpcError):  # UNAVAILABLE: the daemon keeps its last table
        client.list_allocations()


# ---- the stub exporter's Kubernetes-API attributor ----------------------------


def _pod(name, phase="Running", deleting=False):
    meta = {"name": name, **({"deletionTimestamp": "2026-01-01T00:00:00Z"} if deleting else {})}
    return {"metadata": meta, "status": {"phase": phase}}


POD_LISTS = {
    "running": [_pod("tpu-test-b"), _pod("tpu-test-a")],
    "mixed": [_pod("p3"), _pod("p1", "Pending"), _pod("p2", deleting=True), _pod("p0")],
    "none_running": [_pod("p1", "Pending")],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(POD_LISTS))
def test_kubeapi_attributor_deals_devices_as_the_jax_package_does(case):
    from k8s_gpu_hpa_tpu.exporter.kubeapi import KubeApiAttributor as JaxKubeApiAttributor
    from k8s_gpu_hpa_tpu_torch.exporter.kubeapi import KubeApiAttributor
    from tests.test_kubeapi_attributor import FakeApiServer

    server = FakeApiServer()
    server.pods = POD_LISTS[case]
    try:
        got = [
            cls("tpu-test", namespace="team", num_chips=3, api_base=server.base, token="t0k").list_allocations()
            for cls in (KubeApiAttributor, JaxKubeApiAttributor)
        ]
    finally:
        server.close()
    assert got[0] == got[1]
    assert [r["selector"] for r in server.requests] == ["app=tpu-test"] * 2
    assert [r["auth"] for r in server.requests] == ["Bearer t0k"] * 2
    assert [r["path"] for r in server.requests] == ["/api/v1/namespaces/team/pods"] * 2
