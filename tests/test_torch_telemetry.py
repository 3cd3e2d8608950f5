"""Workload self-telemetry written by the port is read by the JAX package's
unchanged exporter-side reader exactly as its own writer's reports are."""

import dataclasses
import json

from k8s_gpu_hpa_tpu.exporter.selfreport import SelfReportReader
from k8s_gpu_hpa_tpu.loadgen.telemetry import TelemetryWriter as JaxWriter
from k8s_gpu_hpa_tpu.loadgen.telemetry import WorkloadReport as JaxReport
from k8s_gpu_hpa_tpu_torch.loadgen.telemetry import TelemetryWriter, WorkloadReport
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

GAUGES = dict(
    tensorcore_util_pct=19.4,
    duty_cycle_pct=100.0,
    hbm_bw_util_pct=None,
    achieved_tflops=191.6,
    queue_depth=3.0,
)


def test_report_fields_are_the_jax_packages():
    assert [f.name for f in dataclasses.fields(WorkloadReport)] == [
        f.name for f in dataclasses.fields(JaxReport)
    ]


def test_port_report_reads_back_like_the_jax_report(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for cls, directory in ((TelemetryWriter, port_dir), (JaxWriter, jax_dir)):
        writer = cls(directory=str(directory), pod="tpu-test-real", namespace="default")
        assert writer.write(**GAUGES, force=True)
        assert writer.path.endswith("default_tpu-test-real.json")
    port_doc = json.loads((port_dir / "default_tpu-test-real.json").read_text())
    jax_doc = json.loads((jax_dir / "default_tpu-test-real.json").read_text())
    assert port_doc.keys() == jax_doc.keys()

    (port_key, port_rep), = SelfReportReader(str(port_dir)).read().items()
    (jax_key, jax_rep), = SelfReportReader(str(jax_dir)).read().items()
    assert port_key == jax_key == ("default", "tpu-test-real")
    # only the write time differs between the two reports
    assert dataclasses.replace(port_rep, ts=0.0) == dataclasses.replace(jax_rep, ts=0.0)
    assert port_rep.queue == "tpu-test" and port_rep.hbm_bw_util_pct is None


def test_writer_rate_limits_and_clears(tmp_path):
    writer = TelemetryWriter(directory=str(tmp_path), pod="p", namespace="ns", min_interval=60.0)
    assert writer.write(duty_cycle_pct=50.0)
    assert not writer.write(duty_cycle_pct=60.0)  # inside min_interval
    assert SelfReportReader(str(tmp_path)).read()[("ns", "p")].duty_cycle_pct == 50.0
    writer.clear()
    assert SelfReportReader(str(tmp_path)).read() == {}
