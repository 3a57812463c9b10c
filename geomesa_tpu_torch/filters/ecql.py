"""ECQL parser: CQL text -> Filter AST.

Recursive descent over the grammar:

    filter   := or
    or       := and (OR and)*
    and      := not (AND not)*
    not      := NOT not | primary
    primary  := '(' filter ')' | predicate
    predicate:= INCLUDE | EXCLUDE
              | BBOX '(' attr ',' num ',' num ',' num ',' num [',' crs] ')'
              | INTERSECTS|DISJOINT|CONTAINS|WITHIN|TOUCHES|CROSSES|OVERLAPS
                  |EQUALS '(' attr ',' geometry ')'
              | DWITHIN '(' attr ',' geometry ',' num ',' units ')'
              | IN '(' str (',' str)* ')'                  -- fid filter
              | attr IN '(' literal (',' literal)* ')'
              | attr BETWEEN literal AND literal
              | attr [NOT] LIKE str | attr ILIKE str
              | attr IS [NOT] NULL
              | attr DURING instant '/' instant
              | attr BEFORE instant | attr AFTER instant | attr TEQUALS instant
              | attr op literal        (op: = <> != < > <= >=)

Dates parse to epoch millis; geometries parse via the WKT reader;
DWITHIN's units are one or more words ("meters", "statute miles").
Syntax errors raise ECQLError (BEYOND is not in the grammar).
"""

from __future__ import annotations

import functools
import re

import numpy as np

from ..geometry.wkt import _Scanner, _parse_geom
from . import ast

__all__ = ["parse_ecql", "ECQLError"]


class ECQLError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<lparen>\()
    | (?P<rparen>\))
    | (?P<comma>,)
    | (?P<slash>/)
    | (?P<op><=|>=|<>|!=|=|<|>)
    | (?P<string>'(?:[^']|'')*')
    | (?P<datetime>\d{4}-\d{2}-\d{2}(?:[T ]\d{2}:\d{2}:\d{2}(?:\.\d+)?Z?)?)
    | (?P<number>[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?)
    | (?P<word>[A-Za-z_][A-Za-z0-9_.:-]*)
    )""", re.VERBOSE)

_SPATIAL = {
    "INTERSECTS": ast.Intersects, "DISJOINT": ast.Disjoint,
    "CONTAINS": ast.Contains, "WITHIN": ast.Within,
    "TOUCHES": ast.Touches, "CROSSES": ast.Crosses,
    "OVERLAPS": ast.Overlaps, "EQUALS": ast.GeomEquals,
}


def _parse_instant(s: str) -> int:
    """ISO instant -> epoch millis (UTC assumed, trailing Z optional)."""
    s = s.strip().rstrip("Z").replace(" ", "T")
    try:
        return int(np.datetime64(s, "ms").astype(np.int64))
    except ValueError as e:
        raise ECQLError(f"bad instant {s!r}: {e}") from None


class _Tokens:
    def __init__(self, text: str):
        self.text = text
        self.toks: list[tuple[str, str]] = []
        self.starts: list[int] = []
        i = 0
        while i < len(text):
            m = _TOKEN_RE.match(text, i)
            if not m or m.end() == i:
                if text[i:].strip():
                    raise ECQLError(f"cannot tokenize at: {text[i:][:40]!r}")
                break
            i = m.end()
            kind = m.lastgroup
            self.toks.append((kind, m.group(kind).strip()))
            self.starts.append(m.start(kind))
        self.pos = 0

    def peek(self, k: int = 0):
        if self.pos + k < len(self.toks):
            return self.toks[self.pos + k]
        return ("eof", "")

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def expect(self, kind: str, val: str | None = None):
        t = self.next()
        if t[0] != kind or (val is not None and t[1].upper() != val):
            raise ECQLError(f"expected {val or kind}, got {t[1]!r} "
                            f"in {self.text[:80]!r}")
        return t

    def at_word(self, *words: str) -> bool:
        t = self.peek()
        return t[0] == "word" and t[1].upper() in words


def _unquote(s: str) -> str:
    return s[1:-1].replace("''", "'")


def _number(tok: tuple[str, str]) -> float:
    if tok[0] != "number":
        raise ECQLError(f"expected number, got {tok[1]!r}")
    return float(tok[1])


def _literal(tok: tuple[str, str]):
    kind, val = tok
    if kind == "string":
        return _unquote(val)
    if kind == "number":
        f = float(val)
        return int(f) if f.is_integer() and "." not in val and "e" not in val.lower() else f
    if kind == "datetime":
        return _parse_instant(val)
    if kind == "word" and val.upper() in ("TRUE", "FALSE"):
        return val.upper() == "TRUE"
    raise ECQLError(f"expected literal, got {val!r}")


class _Parser:
    def __init__(self, text: str):
        self.t = _Tokens(text)

    def parse(self) -> ast.Filter:
        f = self.or_expr()
        if self.t.peek()[0] != "eof":
            raise ECQLError(f"trailing input: {self.t.peek()[1]!r}")
        return f

    def or_expr(self) -> ast.Filter:
        parts = [self.and_expr()]
        while self.t.at_word("OR"):
            self.t.next()
            parts.append(self.and_expr())
        return parts[0] if len(parts) == 1 else ast.Or(parts)

    def and_expr(self) -> ast.Filter:
        parts = [self.not_expr()]
        while self.t.at_word("AND"):
            self.t.next()
            parts.append(self.not_expr())
        return parts[0] if len(parts) == 1 else ast.And(parts)

    def not_expr(self) -> ast.Filter:
        if self.t.at_word("NOT"):
            self.t.next()
            return ast.Not(self.not_expr())
        return self.primary()

    def primary(self) -> ast.Filter:
        kind, val = self.t.peek()
        if kind == "lparen":
            self.t.next()
            f = self.or_expr()
            self.t.expect("rparen")
            return f
        if kind != "word":
            raise ECQLError(f"unexpected token {val!r}")
        u = val.upper()
        if u == "INCLUDE":
            self.t.next()
            return ast.Include()
        if u == "EXCLUDE":
            self.t.next()
            return ast.Exclude()
        if u == "BBOX":
            return self.bbox()
        if u == "DWITHIN":
            return self.dwithin()
        if u in _SPATIAL:
            return self.spatial(u)
        if u == "IN":
            return self.fid_filter()
        return self.attr_predicate()

    def bbox(self) -> ast.Filter:
        self.t.next()
        self.t.expect("lparen")
        attr = self.t.expect("word")[1]
        vals = []
        for _ in range(4):
            self.t.expect("comma")
            vals.append(_number(self.t.next()))
        if self.t.peek()[0] == "comma":  # optional CRS, ignored (4326 only)
            self.t.next()
            self.t.next()
        self.t.expect("rparen")
        return ast.BBox(attr, *vals)

    def _geometry(self):
        # the WKT scanner reads from the current token's character offset
        # (tokens don't model WKT structure); then skip the tokens it used
        sc = _Scanner(self.t.text)
        sc.i = self.t.starts[self.t.pos]
        g = _parse_geom(sc)
        while (self.t.pos < len(self.t.starts)
               and self.t.starts[self.t.pos] < sc.i):
            self.t.pos += 1
        return g

    def spatial(self, name: str) -> ast.Filter:
        self.t.next()
        self.t.expect("lparen")
        attr = self.t.expect("word")[1]
        self.t.expect("comma")
        g = self._geometry()
        self.t.expect("rparen")
        return _SPATIAL[name](attr, g)

    def dwithin(self) -> ast.Filter:
        self.t.next()
        self.t.expect("lparen")
        attr = self.t.expect("word")[1]
        self.t.expect("comma")
        g = self._geometry()
        self.t.expect("comma")
        dist = _number(self.t.next())
        self.t.expect("comma")
        units = [self.t.next()[1]]
        while self.t.peek()[0] == "word":  # "statute miles" etc.
            units.append(self.t.next()[1])
        self.t.expect("rparen")
        return ast.DWithin(attr, g, dist, " ".join(units).lower())

    def fid_filter(self) -> ast.Filter:
        self.t.next()
        self.t.expect("lparen")
        ids = [_unquote(self.t.expect("string")[1])]
        while self.t.peek()[0] == "comma":
            self.t.next()
            ids.append(_unquote(self.t.expect("string")[1]))
        self.t.expect("rparen")
        return ast.FidFilter(ids)

    def attr_predicate(self) -> ast.Filter:
        attr = self.t.expect("word")[1]
        kind, val = self.t.peek()
        u = val.upper() if kind == "word" else None
        if kind == "op":
            self.t.next()
            lit = _literal(self.t.next())
            return ast.Compare("<>" if val == "!=" else val, attr, lit)
        if u == "BETWEEN":
            self.t.next()
            lo = _literal(self.t.next())
            self.t.expect("word", "AND")
            hi = _literal(self.t.next())
            return ast.Between(attr, lo, hi)
        if u in ("LIKE", "ILIKE"):
            self.t.next()
            pat = _unquote(self.t.expect("string")[1])
            return ast.Like(attr, pat, case_sensitive=(u == "LIKE"))
        if u == "NOT":
            self.t.next()
            if self.t.at_word("LIKE"):
                self.t.next()
                pat = _unquote(self.t.expect("string")[1])
                return ast.Not(ast.Like(attr, pat))
            raise ECQLError("expected LIKE after NOT")
        if u == "IS":
            self.t.next()
            if self.t.at_word("NOT"):
                self.t.next()
                self.t.expect("word", "NULL")
                return ast.Not(ast.IsNull(attr))
            self.t.expect("word", "NULL")
            return ast.IsNull(attr)
        if u == "IN":
            self.t.next()
            self.t.expect("lparen")
            vals = [_literal(self.t.next())]
            while self.t.peek()[0] == "comma":
                self.t.next()
                vals.append(_literal(self.t.next()))
            self.t.expect("rparen")
            return ast.InList(attr, vals)
        if u == "DURING":
            self.t.next()
            start = self._instant()
            self.t.expect("slash")
            end = self._instant()
            return ast.During(attr, start, end)
        if u == "BEFORE":
            self.t.next()
            return ast.Before(attr, self._instant())
        if u == "AFTER":
            self.t.next()
            return ast.After(attr, self._instant())
        if u == "TEQUALS":
            self.t.next()
            return ast.TEquals(attr, self._instant())
        raise ECQLError(f"unexpected predicate on {attr!r}: {val!r}")

    def _instant(self) -> int:
        t = self.t.next()
        if t[0] == "datetime":
            return _parse_instant(t[1])
        if t[0] == "string":
            return _parse_instant(_unquote(t[1]))
        raise ECQLError(f"expected instant, got {t[1]!r}")


@functools.lru_cache(maxsize=512)
def parse_ecql(text: str) -> ast.Filter:
    """Parse an ECQL filter string to a Filter AST. Cached: AST nodes are
    frozen dataclasses, so one shared tree per query string is safe."""
    text = text.strip()
    if not text:
        return ast.Include()
    return _Parser(text).parse()
