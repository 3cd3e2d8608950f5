"""Structured traces on the pipeline's (virtual) clock.

Counterpart of ``k8s_gpu_hpa_tpu/obs/trace.py``.  Every pipeline stage
emits :class:`Span` records into one :class:`Tracer`; spans are causally
linked by id (obs/schema.py has the kinds and the edges a link may take), so
a scale event can be walked back to the raw exporter sweeps that fed it
(obs/lineage.py).  On a ``VirtualClock`` the whole trace is deterministic:
the same scenario gives the same spans with the same ids, counted from 1.

Two ways to emit:

- ``emit(kind, attrs, links=...)``: a span opened and closed at once (most
  stages: on a virtual clock a synchronous callback takes no clock time);
- ``open(kind)`` … ``close(span, links=..., **attrs)``: when the id must
  exist before the attributes do; the scraper stamps the open span's id as
  the ``origin`` of every point it appends, then closes the span with the
  sample count.

Scopes give the HPA sync its children without threading state through the
adapter: ``push_scope()`` starts collecting the ids of the spans closed
while it is active, ``pop_scope()`` returns them, so the sync span links to
exactly the adapter queries its own body issued.

``write_jsonl``/``read_jsonl`` export a trace for offline analysis
(``python -m k8s_gpu_hpa_tpu_torch simulate --scenario trace --trace-out``).
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.obs.schema import validate_span_fields
from k8s_gpu_hpa_tpu_torch.utils.clock import Clock


@dataclass
class Span:
    """One traced unit of pipeline work.  ``start``/``end`` are clock
    seconds; ``links`` are the ids of the spans whose data fed this one
    (causal parents, not children)."""

    span_id: int
    kind: str
    start: float
    end: float
    attrs: dict = field(default_factory=dict)
    links: tuple[int, ...] = ()

    def as_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "kind": self.kind,
            "start": self.start,
            "end": self.end,
            "attrs": self.attrs,
            "links": list(self.links),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            span_id=int(d["span_id"]),
            kind=d["kind"],
            start=float(d["start"]),
            end=float(d["end"]),
            attrs=dict(d.get("attrs", {})),
            links=tuple(int(x) for x in d.get("links", [])),
        )


class Tracer:
    """Collects spans against one clock.  ``validate=True`` checks each span
    against ``SPAN_SCHEMA`` when it closes, so a stage emitting an
    undeclared shape fails loudly instead of producing a trace the walker
    cannot follow."""

    def __init__(self, clock: Clock, validate: bool = True):
        self.clock = clock
        self.validate = validate
        self.spans: list[Span] = []
        self._by_id: dict[int, Span] = {}
        self._ids = itertools.count(1)
        self._scopes: list[list[int]] = []

    # ---- emission ----------------------------------------------------------

    def open(
        self, kind: str, attrs: dict | None = None, start: float | None = None
    ) -> Span:
        """Take a span id now, to be used (as a point origin, as a link
        target) before the span's final attributes are known.  The span is
        in ``spans`` and in the open scopes only once closed."""
        now = self.clock.now()
        return Span(
            span_id=next(self._ids),
            kind=kind,
            start=now if start is None else start,
            end=now,
            attrs=dict(attrs or {}),
        )

    def close(
        self,
        span: Span,
        links: tuple[int, ...] = (),
        end: float | None = None,
        **attrs,
    ) -> Span:
        span.end = self.clock.now() if end is None else end
        span.attrs.update(attrs)
        span.links = tuple(dict.fromkeys(itertools.chain(span.links, links)))
        if self.validate:
            validate_span_fields(span.kind, span.attrs, span_id=span.span_id)
        self.spans.append(span)
        self._by_id[span.span_id] = span
        for scope in self._scopes:
            scope.append(span.span_id)
        return span

    def emit(
        self,
        kind: str,
        attrs: dict | None = None,
        links: tuple[int, ...] = (),
        start: float | None = None,
        end: float | None = None,
    ) -> Span:
        """A span opened and closed in one call."""
        return self.close(self.open(kind, attrs, start=start), links, end=end)

    # ---- scopes ------------------------------------------------------------

    def push_scope(self) -> None:
        self._scopes.append([])

    def pop_scope(self) -> tuple[int, ...]:
        """Ids of every span closed while the innermost scope was open."""
        return tuple(self._scopes.pop())

    # ---- queries -----------------------------------------------------------

    def get(self, span_id: int) -> Span | None:
        return self._by_id.get(span_id)

    def spans_of(self, kind: str) -> list[Span]:
        return [s for s in self.spans if s.kind == kind]

    # ---- JSONL export ------------------------------------------------------

    def write_jsonl(self, path: str | Path) -> int:
        """One span a line, in emission order; returns the span count."""
        path = Path(path)
        with path.open("w") as f:
            for span in self.spans:
                f.write(json.dumps(span.as_dict()) + "\n")
        return len(self.spans)


def read_jsonl(path: str | Path) -> list[Span]:
    """Load a trace export back into spans (blank lines skipped)."""
    spans = []
    for line in Path(path).read_text().splitlines():
        if line.strip():
            spans.append(Span.from_dict(json.loads(line)))
    return spans
