"""Prometheus text exposition format: encoder and parser.

The exporter↔Prometheus joint in the reference is the text format served on
:9400/metrics (dcgm-exporter.yaml:31-32,40-41) and smoke-tested with
``curl localhost:9400/metrics | grep dcgm_gpu_temp`` (README.md:42-47).  We
implement both directions: ``encode_text`` is what the exporter serves (the C++
core has an equivalent encoder; this one is the reference implementation its
tests diff against) and ``parse_text`` is what our mini-Prometheus scraper uses,
so the scrape contract is exercised end-to-end in tests.

Format per the Prometheus exposition spec (text/plain; version=0.0.4): HELP/TYPE
comment lines, then ``name{label="value",...} value`` sample lines with ``\\``,
``\n`` and ``"`` escaped inside label values.

Histograms follow the OpenMetrics layout: a family of type ``histogram``
renders its samples under suffixed series names (``x_bucket`` with an ``le``
label per bound plus ``+Inf``, ``x_sum``, ``x_count``), and ``_bucket``
samples may carry an exemplar trailer::

    x_bucket{le="0.01"} 5 # {trace_id="7",span_id="7"} 0.003 12.5

``parse_text`` folds the suffixed series back into the base family (suffix
preserved on each Sample) and reconstructs exemplars, so the text and
structured scrape paths stay flatten-equivalent.
"""

from __future__ import annotations

import math

from k8s_gpu_hpa_tpu_torch.metrics.schema import Exemplar, MetricFamily, Sample

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")

_ESCAPES = {"\\": "\\\\", "\n": "\\n", '"': '\\"'}


def _escape_label_value(v: str) -> str:
    return "".join(_ESCAPES.get(ch, ch) for ch in v)


def _unescape_label_value(v: str) -> str:
    out: list[str] = []
    i = 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", "n": "\n", '"': '"'}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def _format_value(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _format_exemplar(ex: Exemplar) -> str:
    trailer = (
        f' # {{trace_id="{ex.trace_id}",span_id="{ex.span_id}"}}'
        f" {_format_value(ex.value)}"
    )
    if ex.ts is not None:
        trailer += f" {_format_value(ex.ts)}"
    return trailer


def encode_text(families: list[MetricFamily]) -> str:
    """Encode metric families into Prometheus text exposition format."""
    lines: list[str] = []
    for fam in families:
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for sample in fam.samples:
            name = fam.name + sample.suffix
            trailer = "" if sample.exemplar is None else _format_exemplar(
                sample.exemplar
            )
            if sample.labels:
                labelstr = ",".join(
                    f'{k}="{_escape_label_value(v)}"' for k, v in sample.labels
                )
                lines.append(
                    f"{name}{{{labelstr}}} {_format_value(sample.value)}{trailer}"
                )
            else:
                lines.append(f"{name} {_format_value(sample.value)}{trailer}")
    return "\n".join(lines) + "\n"


def flatten(families: list[MetricFamily]) -> list[tuple[str, Sample]]:
    """Flatten families to (wire name, sample) pairs — the order-insensitive
    currency for equivalence checks between the text and structured scrape
    paths (a structured fetch must ingest exactly what its text rendering
    would after a parse round trip).  The wire name includes the sample's
    suffix, so a histogram flattens to its _bucket/_sum/_count series."""
    return [
        (fam.name + sample.suffix, sample)
        for fam in families
        for sample in fam.samples
    ]


def _parse_labels(body: str) -> tuple[tuple[str, str], ...]:
    labels: list[tuple[str, str]] = []
    i = 0
    n = len(body)
    while i < n:
        # label name
        j = body.index("=", i)
        name = body[i:j].strip().lstrip(",").strip()
        # opening quote
        k = body.index('"', j)
        # find closing quote honoring escapes
        m = k + 1
        while m < n:
            if body[m] == "\\":
                m += 2
                continue
            if body[m] == '"':
                break
            m += 1
        labels.append((name, _unescape_label_value(body[k + 1 : m])))
        i = m + 1
    return tuple(sorted(labels))


def _find_close(line: str, open_idx: int) -> int:
    """Index of the ``}`` closing the brace at ``open_idx``, honoring quoted
    label values (an exemplar trailer has its own ``{...}``, so rindex would
    overshoot).  Raises ValueError when unterminated."""
    i = open_idx + 1
    n = len(line)
    while i < n:
        ch = line[i]
        if ch == '"':
            i += 1
            while i < n:
                if line[i] == "\\":
                    i += 2
                    continue
                if line[i] == '"':
                    break
                i += 1
        elif ch == "}":
            return i
        i += 1
    raise ValueError(f"unterminated label set in {line!r}")


def _parse_exemplar(rest: str) -> Exemplar | None:
    """Parse an OpenMetrics exemplar trailer: ``{labels} value [ts]``.

    Returns None (sample kept, exemplar dropped) on anything malformed —
    exemplars are best-effort debugging links, never worth failing a scrape."""
    try:
        open_idx = rest.index("{")
        close = _find_close(rest, open_idx)
        labels = dict(_parse_labels(rest[open_idx + 1 : close]))
        parts = rest[close + 1 :].split()
        value = float(parts[0])
        ts = float(parts[1]) if len(parts) > 1 else None
        return Exemplar(
            value=value,
            trace_id=int(labels["trace_id"]),
            span_id=int(labels["span_id"]),
            ts=ts,
        )
    except (ValueError, IndexError, KeyError):
        return None


def parse_text(text: str) -> list[MetricFamily]:
    """Parse Prometheus text exposition into metric families.

    Tolerant of unknown metrics and interleaved comments, like a real
    scraper.  Series named ``x_bucket``/``x_sum``/``x_count`` whose base
    ``x`` was declared ``# TYPE x histogram`` fold back into family ``x``
    with the suffix preserved on each sample; ``# {...}`` exemplar trailers
    on bucket lines are reconstructed.
    """
    families: dict[str, MetricFamily] = {}
    hist_names: set[str] = set()

    def fam(name: str) -> MetricFamily:
        if name not in families:
            families[name] = MetricFamily(name)
        return families[name]

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP ") :]
            name, _, help_ = rest.partition(" ")
            fam(name).help = help_
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE ") :]
            name, _, type_ = rest.partition(" ")
            fam(name).type = type_ or "untyped"
            if type_ == "histogram":
                hist_names.add(name)
            continue
        if line.startswith("#"):
            continue
        # sample line: name[{labels}] value [# exemplar]; malformed lines are
        # skipped, never fatal — a scraper must survive a corrupt exposition
        try:
            if "{" in line:
                open_idx = line.index("{")
                name = line[:open_idx]
                close = _find_close(line, open_idx)
                labels = _parse_labels(line[open_idx + 1 : close])
                rest = line[close + 1 :].strip()
            else:
                name, _, rest = line.partition(" ")
                labels = ()
            value_str, hash_sep, exemplar_str = rest.partition("#")
            value = float(value_str.split()[0])
            exemplar = _parse_exemplar(exemplar_str) if hash_sep else None
        except (ValueError, IndexError):
            continue
        suffix = ""
        for cand in _HIST_SUFFIXES:
            base = name[: -len(cand)]
            if name.endswith(cand) and base in hist_names:
                name, suffix = base, cand
                break
        fam(name).samples.append(Sample(value, labels, suffix, exemplar))
    return list(families.values())
