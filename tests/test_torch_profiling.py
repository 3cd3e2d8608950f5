"""The env-gated profiling window (utils/profiling.py), the counterpart of
tests/test_profiling.py with a Chrome trace in place of xplane: a window
opens, brackets real work, and leaves one trace file on disk; and each of
the three container mains (matmul, decode, train) writes one when
``PROFILE_S`` is set."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from k8s_gpu_hpa_tpu_torch.utils.profiling import ProfileWindow
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _trace_files(root: Path) -> list[Path]:
    return sorted(root.rglob("*.json"))


def _events(path: Path) -> list[dict]:
    return json.loads(path.read_text())["traceEvents"]


def test_disabled_by_default(tmp_path):
    w = ProfileWindow(env={})
    assert not w.enabled
    for _ in range(3):
        w.poll()  # must be a free no-op
    w.close()
    assert _trace_files(tmp_path) == []


def test_malformed_profile_s_disables(tmp_path):
    w = ProfileWindow(env={"PROFILE_S": "ten", "PROFILE_DIR": str(tmp_path)})
    assert not w.enabled
    w.poll()
    assert _trace_files(tmp_path) == []


def test_window_captures_one_trace(tmp_path):
    w = ProfileWindow(env={"PROFILE_S": "0.2", "PROFILE_DIR": str(tmp_path)})
    assert w.enabled
    x = torch.ones(64, 64)
    deadline = time.perf_counter() + 10.0
    while not w._done and time.perf_counter() < deadline:
        w.poll()
        x = (x @ x) / 64.0
        time.sleep(0.02)
    assert w._done, "window never closed"
    files = _trace_files(tmp_path)
    assert files == [w.path], "no Chrome trace written"
    # the window bracketed the loop's work
    assert any("aten::mm" in e.get("name", "") for e in _events(w.path))
    # one process, one trace: further polls must not open a second window
    for _ in range(5):
        w.poll()
    assert _trace_files(tmp_path) == files


def test_close_flushes_open_window(tmp_path):
    w = ProfileWindow(env={"PROFILE_S": "60", "PROFILE_DIR": str(tmp_path)})
    w.poll()  # opens the 60 s window
    torch.ones(32, 32) @ torch.ones(32, 32)
    w.close()  # SIGTERM path: stop early, keep the artifact
    assert _trace_files(tmp_path) == [w.path]
    w.poll()  # no reopen after close
    assert w._done


_MAINS = {
    "matmul": ("from k8s_gpu_hpa_tpu_torch.loadgen.matmul import main; main(device='cpu')",
               {"MATMUL_SIZE": "64"}),
    "decode": ("from k8s_gpu_hpa_tpu_torch.loadgen.decode import main; main(device='cpu')",
               {"DECODE_BATCH": "1", "MAX_SEQ": "64", "D_MODEL": "64", "N_HEADS": "1",
                "N_LAYERS": "1"}),
    "train": ("from k8s_gpu_hpa_tpu_torch.loadgen.train import main; main(device='cpu')",
              {"BATCH_SIZE": "2", "IMAGE_SIZE": "8", "SMALL_MODEL": "1"}),
}


@pytest.mark.parametrize("main", sorted(_MAINS))
def test_container_main_writes_one_chrome_trace(main, tmp_path):
    code, sizes = _MAINS[main]
    env = {
        **{k: v for k, v in os.environ.items() if k not in ("CHECKPOINT_DIR", "TPU_TELEMETRY_DIR")},
        **sizes, "PROFILE_S": "0.5", "PROFILE_DIR": str(tmp_path / "profile"),
        "REPORT_S": "60", "TPU_TEST_INTENSITY_FILE": str(tmp_path / "knob"),
    }
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lines = []
    try:
        deadline = time.monotonic() + 120
        while not any(ln.startswith("profiling: trace written") for ln in lines):
            line = proc.stdout.readline()
            if not line or time.monotonic() > deadline:
                break
            lines.append(line.strip())
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert any(ln.startswith("profiling: trace written") for ln in lines), lines
    (trace,) = _trace_files(tmp_path / "profile")
    assert trace.name == f"trace-{proc.pid}.json"
    assert _events(trace)  # a readable Chrome trace with the loop's events
