"""Accumulo-style visibility expression parser/evaluator
(security/VisibilityEvaluator.scala:21).

Grammar: term | '(' expr ')' with '&' (and) and '|' (or); '&' and '|'
cannot mix without parens (Accumulo's rule). Terms are alphanumeric
(plus _ - : . /) or arbitrary strings in double quotes.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

__all__ = ["parse_visibility", "VisibilityExpression",
           "evaluate_visibilities", "validate_labels", "distinct_labels"]


def validate_labels(sft, labels) -> None:
    """Validate distinct visibility labels against a schema.
    Attribute-level schemas need exactly one comma-separated part per
    attribute; every non-empty part (or whole label) must parse."""
    if sft.visibility_level == "attribute":
        n_attr = len(sft.attributes)
        for e in labels:
            parts = str(e).split(",")
            if len(parts) != n_attr:
                raise ValueError(
                    f"attribute-level visibility needs {n_attr} "
                    f"comma-separated labels, got {e!r}")
            for p in parts:
                if p:
                    parse_visibility(p)
    else:
        for e in labels:
            parse_visibility(str(e))


_TERM_RE = re.compile(r'[A-Za-z0-9_\-:./]+|"(?:[^"\\]|\\.)*"')


@dataclasses.dataclass(frozen=True)
class VisibilityExpression:
    """op: 'term' | 'and' | 'or'."""
    op: str
    term: str | None = None
    children: tuple = ()

    def evaluate(self, auths: set[str]) -> bool:
        if self.op == "term":
            return self.term in auths
        if self.op == "and":
            return all(c.evaluate(auths) for c in self.children)
        return any(c.evaluate(auths) for c in self.children)


class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def parse(self) -> VisibilityExpression:
        e = self._expr()
        if self.i != len(self.s):
            raise ValueError(
                f"trailing input in visibility: {self.s[self.i:]!r}")
        return e

    def _expr(self) -> VisibilityExpression:
        parts = [self._primary()]
        op = None
        while self.peek() in ("&", "|"):
            ch = self.s[self.i]
            if op is None:
                op = ch
            elif ch != op:
                raise ValueError(
                    f"cannot mix & and | without parens: {self.s!r}")
            self.i += 1
            parts.append(self._primary())
        if len(parts) == 1:
            return parts[0]
        return VisibilityExpression("and" if op == "&" else "or",
                                    children=tuple(parts))

    def _primary(self) -> VisibilityExpression:
        if self.peek() == "(":
            self.i += 1
            e = self._expr()
            if self.peek() != ")":
                raise ValueError(f"unbalanced parens in {self.s!r}")
            self.i += 1
            return e
        m = _TERM_RE.match(self.s, self.i)
        if not m:
            raise ValueError(
                f"bad visibility term at {self.i} in {self.s!r}")
        self.i = m.end()
        term = m.group(0)
        if term.startswith('"'):
            term = term[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        return VisibilityExpression("term", term)


_CACHE: dict[str, VisibilityExpression] = {}


def parse_visibility(expr: str) -> VisibilityExpression:
    if expr not in _CACHE:
        if len(_CACHE) > 10_000:
            _CACHE.clear()
        _CACHE[expr] = _P(expr.strip()).parse()
    return _CACHE[expr]


def distinct_labels(expressions) -> tuple[np.ndarray, np.ndarray]:
    """(labels, inverse): the distinct labels of an object array, None
    and "" both as "", and each row's index into them."""
    filled = np.asarray(expressions, dtype=object)
    filled = np.where(np.equal(filled, None), "", filled).astype(str)
    return np.unique(filled, return_inverse=True)


def evaluate_visibilities(expressions, auths) -> np.ndarray:
    """Bool mask of rows whose visibility passes the auth set, each
    distinct label evaluated once. Empty/None visibility is
    world-readable (reference semantics)."""
    if not len(expressions):
        return np.ones(0, dtype=bool)
    auth_set = set(auths)
    labels, inverse = distinct_labels(expressions)
    ok = np.array([not e or parse_visibility(e).evaluate(auth_set)
                   for e in labels.tolist()], dtype=bool)
    return ok[inverse.reshape(-1)]
