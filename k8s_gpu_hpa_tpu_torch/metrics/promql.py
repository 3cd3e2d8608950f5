"""PromQL-subset front end: compile rule strings into ``Expr`` ASTs.

Counterpart of ``k8s_gpu_hpa_tpu/metrics/promql.py``, whole.  A recording
or alert rule exists as an ``Expr`` AST (metrics/rules.py), which the loop
evaluates, and as the PromQL string its ``promql()`` renders into the
shipped PrometheusRule (manifests.py).  This parser closes the loop: every
rendered string compiles back to an AST equal (dataclass ``==``) to its
source, and the planner (metrics/planner.py) runs the same ASTs, so the
YAML, the evaluation in process and the planned execution share one
meaning.

The grammar is the subset the shipped manifests use, no more:

    expr        := cmp ("and" "on" "(" ")" cmp)*          # AndOn, left-assoc
    cmp         := additive (CMPOP NUMBER)?               # Cmp vs scalar
    additive    := multiplicative ("-" multiplicative)*   # only 1 - x (burn)
    multiplicative := primary (mul_join | "/" primary)*
    mul_join    := "*" "on" "(" labels ")"
                   "group_left" "(" labels? ")" primary   # MulOnGroupLeft
    primary     := NUMBER | "(" expr ")" | selector
                 | AGGOP ("by" "(" labels ")")? "(" expr ")"
                 | "absent" "(" expr ")"
                 | "histogram_quantile" "(" NUMBER "," selector ")"
                 | ("increase" | "avg_over_time") "(" selector range ")"
    selector    := NAME ("{" NAME "=" STRING ("," NAME "=" STRING)* "}")?
    range       := "[" DURATION "]"

Aggregations read as the node the rule factories build (``avg(x)`` →
:class:`Avg`, ``max by(...)`` → :class:`MaxBy`, bare ``min/max/sum/count``
→ :class:`Aggregate`, other grouped ops → :class:`AggregateBy`), and the
SLO burn idiom ``(1 - (increase(good[w]) / increase(total[w]))) / budget``
folds into one :class:`BurnRate` (objective ``1 - budget``, exact for the
shipped budgets in IEEE double).  A parenthesized division of two vector
expressions is the federated :class:`Ratio`.  Anything outside the subset
raises :class:`PromQLError` with the position.

:func:`parse_query` takes a larger query subset (``rate()``, bare
``increase()``, ``!=``/``=~``/``!~`` matchers, ``or vector(N)``,
``histogram_quantile`` over a general bucket expression) into query-only
nodes (:class:`Rate`, :class:`Increase`, :class:`QSelect`,
:class:`OrVector`, :class:`QHistogramQuantile`) that render but do not
evaluate.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from k8s_gpu_hpa_tpu_torch.metrics.rules import (
    Absent,
    Aggregate,
    AggregateBy,
    AndOn,
    Avg,
    AvgOverTime,
    BurnRate,
    Cmp,
    Expr,
    HistogramQuantile,
    MaxBy,
    MulOnGroupLeft,
    Ratio,
    Select,
    _fmt_window,
)


class PromQLError(ValueError):
    """The input is outside the supported PromQL subset (or malformed)."""


# -- query-mode nodes ---------------------------------------------------------
# A dashboard uses PromQL the closed loop never evaluates: rate() over
# counters, a bare increase() outside the burn idiom, !=/=~ matchers, and the
# "or vector(0)" stat-panel idiom.  These nodes give that query subset the
# same parse -> canonical-render contract the rule subset has; they are Expr
# subclasses (so they nest inside aggregations) whose evaluate() stays
# NotImplemented.


@dataclass
class QSelect(Expr):
    """Selector with general matchers: ``name{key!="v",other=~"re"}``; the
    matcher triples keep their source order (no canonical sort: order is
    part of a hand-written query's bytes)."""

    name: str
    matchers: tuple[tuple[str, str, str], ...]  # (label, op, value)

    def input_names(self) -> frozenset[str]:
        return frozenset((self.name,))

    def promql(self) -> str:
        inner = ",".join(f'{k}{op}"{v}"' for k, op, v in self.matchers)
        return f"{self.name}{{{inner}}}"


@dataclass
class Rate(Expr):
    """``rate(selector[window])`` — per-second counter rate."""

    child: Expr  # Select or QSelect
    window: float

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        return f"rate({self.child.promql()}[{_fmt_window(self.window)}])"


@dataclass
class Increase(Expr):
    """``increase(selector[window])`` used as a vector in its own right —
    outside the burn idiom, which still folds to :class:`BurnRate`."""

    child: Expr  # Select or QSelect
    window: float

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        return f"increase({self.child.promql()}[{_fmt_window(self.window)}])"


@dataclass
class OrVector(Expr):
    """``child or vector(default)`` — the stat-panel idiom: an empty result
    renders as the default scalar instead of "No data"."""

    child: Expr
    default: float

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        return f"{self.child.promql()} or vector({self.default:g})"


@dataclass
class QHistogramQuantile(Expr):
    """``histogram_quantile(q, expr)`` over a general bucket expression,
    such as ``sum by(le)(rate(..._bucket[5m]))`` (a bare ``_bucket``
    selector still reads as the rule subset's
    :class:`~.rules.HistogramQuantile`)."""

    q: float
    child: Expr

    def input_names(self) -> frozenset[str]:
        return self.child.input_names()

    def promql(self) -> str:
        q = self.q
        rendered = str(int(q)) if q == int(q) else repr(q)
        return f"histogram_quantile({rendered}, {self.child.promql()})"


#: aggregation keywords and whether the bare (no ``by``) form has a
#: dedicated node (``avg`` → Avg; the rest → Aggregate)
_AGG_OPS = ("avg", "sum", "count", "min", "max")
_CMP_OPS = ("==", "!=", "<=", ">=", "<", ">")

_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+)
  | (?P<DURATION>\d+(?:\.\d+)?[smhdwy])(?![A-Za-z0-9_:])
  | (?P<NUMBER>\d+(?:\.\d+)?)
  | (?P<NAME>[A-Za-z_:][A-Za-z0-9_:]*)
  | (?P<STRING>"(?:[^"\\]|\\.)*")
  | (?P<OP>=~|!~|==|!=|<=|>=|[<>{}()\[\],=*/+-])
    """,
    re.VERBOSE,
)

_DURATION_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
                   "w": 604800.0, "y": 31536000.0}


def parse_duration(text: str) -> float:
    """``5m`` → 300.0 — the inverse of ``rules._fmt_window``."""
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([smhdwy])", text)
    if m is None:
        raise PromQLError(f"bad duration {text!r}")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


@dataclass
class _Token:
    kind: str  # DURATION | NUMBER | NAME | STRING | OP | EOF
    text: str
    pos: int


def tokenize(text: str) -> list[_Token]:
    tokens: list[_Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise PromQLError(f"unexpected character {text[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind != "WS":
            tokens.append(_Token(kind, m.group(), m.start()))
    tokens.append(_Token("EOF", "", len(text)))
    return tokens


# -- intermediate forms -------------------------------------------------------
# These exist only between parse and canonicalization: scalar literals, the
# counter-delta halves of the burn idiom, and their quotient.  A finished
# parse must be a pure Expr; an intermediate escaping to the top level means
# the input used arithmetic the subset does not model.


@dataclass
class _Num:
    value: float


@dataclass
class _Increase:
    name: str
    matchers: dict[str, str]
    window: float


@dataclass
class _Div:
    left: _Increase
    right: _Increase


@dataclass
class _OneMinus:
    inner: _Div


class _Parser:
    def __init__(self, text: str, query: bool = False):
        self.text = text
        self.tokens = tokenize(text)
        self.i = 0
        #: query mode (parse_query): additionally accept the dashboard-only
        #: constructs — rate(), bare increase(), !=/=~/!~ matchers,
        #: "or vector(N)", histogram_quantile over a general expression
        self.query = query

    # -- token plumbing ------------------------------------------------------

    def peek(self) -> _Token:
        return self.tokens[self.i]

    def next(self) -> _Token:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, kind: str, text: str | None = None) -> _Token:
        tok = self.next()
        if tok.kind != kind or (text is not None and tok.text != text):
            want = text if text is not None else kind
            raise PromQLError(
                f"expected {want!r} at {tok.pos}, got {tok.text!r} "
                f"in {self.text!r}"
            )
        return tok

    def at_op(self, *texts: str) -> bool:
        tok = self.peek()
        return tok.kind == "OP" and tok.text in texts

    def at_name(self, *texts: str) -> bool:
        tok = self.peek()
        return tok.kind == "NAME" and tok.text in texts

    # -- grammar -------------------------------------------------------------

    def parse(self) -> Expr:
        expr = self.parse_or()
        tok = self.peek()
        if tok.kind != "EOF":
            raise PromQLError(
                f"trailing input at {tok.pos}: {self.text[tok.pos:]!r}"
            )
        expr = self.vector(expr, "top-level expression")
        return expr

    def vector(self, x, where: str) -> Expr:
        """Require a vector Expr; in query mode, lift a bare counter-delta
        intermediate into the query-only :class:`Increase` node instead of
        rejecting it (outside the burn idiom it IS a vector query)."""
        if self.query and isinstance(x, _Increase):
            return Increase(Select(x.name, x.matchers), x.window)
        if not isinstance(x, Expr):
            raise PromQLError(
                f"{where} is not a vector query in the supported subset: "
                f"{self.text!r}"
            )
        return x

    def parse_or(self):
        """Query mode only: ``expr or vector(N)`` — loosest binding."""
        left = self.parse_and()
        while self.query and self.at_name("or"):
            self.next()
            self.expect("NAME", "vector")
            self.expect("OP", "(")
            default = float(self.expect("NUMBER").text)
            self.expect("OP", ")")
            left = OrVector(self.vector(left, "'or vector()' operand"), default)
        return left

    def parse_and(self):
        left = self.parse_cmp()
        while self.at_name("and"):
            self.next()
            self.expect("NAME", "on")
            self.expect("OP", "(")
            if not self.at_op(")"):
                tok = self.peek()
                raise PromQLError(
                    f"only the empty match group 'and on()' is supported "
                    f"(got labels at {tok.pos})"
                )
            self.expect("OP", ")")
            right = self.parse_cmp()
            if not isinstance(left, Expr) or not isinstance(right, Expr):
                raise PromQLError("'and on()' operands must be vector queries")
            left = AndOn(left, right)
        return left

    def parse_cmp(self):
        left = self.parse_additive()
        if self.at_op(*_CMP_OPS):
            op = self.next().text
            tok = self.peek()
            if tok.kind != "NUMBER":
                raise PromQLError(
                    f"comparison threshold must be a scalar literal at "
                    f"{tok.pos} (got {tok.text!r})"
                )
            threshold = float(self.next().text)
            if not isinstance(left, Expr):
                raise PromQLError("comparison operand must be a vector query")
            return Cmp(left, op, threshold)
        return left

    def parse_additive(self):
        left = self.parse_mul()
        while self.at_op("-", "+"):
            op = self.next().text
            right = self.parse_mul()
            if (
                op == "-"
                and isinstance(left, _Num)
                and left.value == 1.0
                and isinstance(right, _Div)
            ):
                left = _OneMinus(right)
            else:
                raise PromQLError(
                    "arithmetic outside '1 - (increase(...) / increase(...))' "
                    f"is not in the supported subset: {self.text!r}"
                )
        return left

    def parse_mul(self):
        left = self.parse_primary()
        while self.at_op("*", "/"):
            op = self.next().text
            if op == "*":
                left = self.parse_join_tail(left)
                continue
            right = self.parse_primary()
            left = self.fold_div(left, right)
        return left

    def parse_join_tail(self, left):
        """``* on(k,...) group_left(extra...) right`` — the app-scoping join."""
        if not self.at_name("on"):
            raise PromQLError(
                "bare '*' is not supported; only "
                "'* on(...) group_left(...)' joins"
            )
        self.next()
        self.expect("OP", "(")
        on = self.parse_label_list()
        self.expect("OP", ")")
        self.expect("NAME", "group_left")
        self.expect("OP", "(")
        group_left = self.parse_label_list()
        self.expect("OP", ")")
        right = self.parse_primary()
        if not isinstance(left, Expr) or not isinstance(right, Expr):
            raise PromQLError("join operands must be vector queries")
        return MulOnGroupLeft(left, right, on=on, group_left=group_left)

    def fold_div(self, left, right):
        """Canonicalize a quotient: burn rate, federation ratio, or the
        increase/increase intermediate inside the burn parentheses."""
        if isinstance(left, _Increase) and isinstance(right, _Increase):
            return _Div(left, right)
        if isinstance(left, _OneMinus) and isinstance(right, _Num):
            good, total = left.inner.left, left.inner.right
            if good.window != total.window:
                raise PromQLError(
                    f"burn-rate windows disagree: {good.window} vs "
                    f"{total.window}"
                )
            return BurnRate(
                good_name=good.name,
                total_name=total.name,
                objective=1.0 - right.value,
                window=float(good.window),
                good_matchers=good.matchers,
                total_matchers=total.matchers,
            )
        if isinstance(left, Expr) and isinstance(right, Expr):
            return Ratio(left, right)
        raise PromQLError(
            f"unsupported division operands in {self.text!r}"
        )

    def parse_primary(self):
        tok = self.peek()
        if tok.kind == "NUMBER":
            return _Num(float(self.next().text))
        if self.at_op("("):
            self.next()
            inner = self.parse_or()
            self.expect("OP", ")")
            return inner
        if tok.kind != "NAME":
            raise PromQLError(
                f"expected expression at {tok.pos}, got {tok.text!r} "
                f"in {self.text!r}"
            )
        name = tok.text
        if name in _AGG_OPS and self.is_aggregation_call():
            return self.parse_aggregation()
        if name == "absent":
            self.next()
            self.expect("OP", "(")
            child = self.parse_and()
            self.expect("OP", ")")
            if not isinstance(child, Expr):
                raise PromQLError("absent() takes a vector query")
            return Absent(child)
        if name == "histogram_quantile":
            return self.parse_histogram_quantile()
        if name in ("increase", "avg_over_time") or (
            self.query and name == "rate"
        ):
            return self.parse_range_fn(name)
        return self.parse_selector()

    def is_aggregation_call(self):
        """Disambiguate ``max(...)`` / ``max by(...)`` from a selector whose
        metric happens to be named ``max`` (legal PromQL, absent from our
        manifests but cheap to keep correct)."""
        nxt = self.tokens[self.i + 1]
        return (nxt.kind == "OP" and nxt.text == "(") or (
            nxt.kind == "NAME" and nxt.text == "by"
        )

    def parse_aggregation(self):
        op = self.next().text
        keys: tuple[str, ...] | None = None
        if self.at_name("by"):
            self.next()
            self.expect("OP", "(")
            keys = self.parse_label_list()
            self.expect("OP", ")")
        self.expect("OP", "(")
        child = self.parse_and()
        self.expect("OP", ")")
        child = self.vector(child, f"{op}() operand")
        if keys is None:
            return Avg(child) if op == "avg" else Aggregate(op, child)
        if op == "max":
            return MaxBy(keys, child)
        return AggregateBy(op, keys, child)

    def parse_histogram_quantile(self):
        self.next()
        self.expect("OP", "(")
        q_tok = self.expect("NUMBER")
        self.expect("OP", ",")
        if self.query:
            child = self.vector(
                self.parse_and(), "histogram_quantile() operand"
            )
            self.expect("OP", ")")
            if isinstance(child, Select) and child.name.endswith("_bucket"):
                # the rule-subset shape: same canonical node either mode
                return HistogramQuantile(
                    float(q_tok.text),
                    child.name[: -len("_bucket")],
                    child.matchers,
                )
            return QHistogramQuantile(float(q_tok.text), child)
        sel = self.parse_selector()
        self.expect("OP", ")")
        if not sel.name.endswith("_bucket"):
            raise PromQLError(
                f"histogram_quantile() needs a _bucket selector, got "
                f"{sel.name!r}"
            )
        return HistogramQuantile(
            float(q_tok.text), sel.name[: -len("_bucket")], sel.matchers
        )

    def parse_range_fn(self, fn: str):
        self.next()
        self.expect("OP", "(")
        sel = self.parse_selector()
        self.expect("OP", "[")
        window = parse_duration(self.expect("DURATION").text)
        self.expect("OP", "]")
        self.expect("OP", ")")
        if fn == "avg_over_time":
            if not isinstance(sel, Select):
                raise PromQLError(
                    "avg_over_time() needs equality matchers only (the "
                    f"closed loop evaluates it): {self.text!r}"
                )
            return AvgOverTime(sel.name, window, sel.matchers)
        if fn == "rate":
            return Rate(sel, window)
        if isinstance(sel, QSelect):
            # non-equality matchers can't be the burn idiom's counter halves
            return Increase(sel, window)
        return _Increase(sel.name, sel.matchers, window)

    def parse_selector(self):
        name = self.expect("NAME").text
        matchers: dict[str, str] = {}
        triples: list[tuple[str, str, str]] = []
        if self.at_op("{"):
            self.next()
            while not self.at_op("}"):
                key = self.expect("NAME").text
                if self.query and self.at_op("!=", "=~", "!~"):
                    op = self.next().text
                else:
                    self.expect("OP", "=")
                    op = "="
                raw = self.expect("STRING").text
                value = raw[1:-1].replace('\\"', '"').replace("\\\\", "\\")
                matchers[key] = value
                triples.append((key, op, value))
                if self.at_op(","):
                    self.next()
                elif not self.at_op("}"):
                    tok = self.peek()
                    raise PromQLError(
                        f"expected ',' or '}}' in matchers at {tok.pos}"
                    )
            self.expect("OP", "}")
        if any(op != "=" for _, op, _ in triples):
            return QSelect(name, tuple(triples))
        return Select(name, matchers)

    def parse_label_list(self) -> tuple[str, ...]:
        labels: list[str] = []
        while self.peek().kind == "NAME":
            labels.append(self.next().text)
            if self.at_op(","):
                self.next()
            else:
                break
        return tuple(labels)


def parse(text: str) -> Expr:
    """Compile one PromQL string into the ``Expr`` AST it denotes.

    The round-trip contract: for every expression ``e`` a rule factory
    builds, ``parse(e.promql()) == e`` (dataclass equality), and for every
    string ``s`` of a rendered manifest, ``parse(s).promql() == s``."""
    return _Parser(text).parse()


def parse_query(text: str) -> Expr:
    """Compile one query string: the rule subset plus the query-only
    constructs (``rate()``, bare ``increase()``, ``!=``/``=~``/``!~``
    matchers, ``or vector(N)``, ``histogram_quantile`` over a general
    bucket expression).  Every rule-subset string parses identically under
    both entry points (the extra grammar only adds), and
    ``parse_query(s).promql() == s`` for a canonically rendered ``s``."""
    return _Parser(text, query=True).parse()
