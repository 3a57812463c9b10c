"""SQL parser: the geomesa-spark-sql surface as a hand-rolled grammar.

The reference extends Spark SQL with spatial UDFs and catalyst rules
(geomesa-spark/geomesa-spark-sql/src/main/scala/org/apache/spark/sql/
SQLTypes.scala:22, SQLSpatialFunctions.scala:31-41);
here the surface is a self-contained SELECT subset:

    select   := SELECT items FROM table [alias]
                [JOIN table [alias] ON st_pred] [WHERE expr]
                [ORDER BY col [ASC|DESC]] [LIMIT n]
    items    := '*' | item (',' item)*
    item     := agg '(' (col|'*') ')' | col | ST_fn(args)
    expr     := SQL boolean algebra over comparisons, BETWEEN/IN/LIKE/
                IS NULL, and ST_ predicates with geometry constructors
                (ST_GeomFromText / ST_Point / ST_MakeBBOX)

Expressions parse into the SAME Filter AST the ECQL path uses
(filters/ast.py) — the rewrite of `ST_Contains(g, col)` into a
column-anchored predicate IS the reference's STContainsRule pushdown
(SQLRules.scala:99-246): by the time the engine sees the query, every
spatial constraint is planner-consumable. Numeric literals stay Python
floats (f64), so a radius or a box edge reaches the store unrounded.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from ..filters import ast
from ..geometry import Geometry, Point, parse_wkt
from ..geometry.base import Envelope

__all__ = ["parse_sql", "SqlSelect", "SqlJoin", "SelectItem", "SqlError"]


class SqlError(ValueError):
    pass


@dataclasses.dataclass
class SelectItem:
    """One projected output: a column, *, an aggregate over one, or a
    scalar ST_* call over one (fn + literal args)."""
    expr: str                 # column name ('a.geom' qualified ok) or '*'
    agg: str | None = None    # count/min/max/sum/avg | 'st' (scalar)
    alias: str | None = None
    fn: str | None = None     # uppercased ST_* name when agg == 'st'
    args: tuple = ()          # literal args after the column

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        if self.agg == "st":
            return f"{(self.fn or 'st').lower()}({self.expr})"
        if self.agg:
            return f"{self.agg}({self.expr})"
        return self.expr


@dataclasses.dataclass
class SqlJoin:
    table: str
    alias: str
    kind: str                 # 'dwithin' | 'contains' | 'intersects' | 'eq'
    distance: float | None    # for dwithin (degrees)
    left_prop: str            # qualified 'alias.col' (first ON arg)
    right_prop: str           # qualified 'alias.col' (second ON arg)
    outer: bool = False       # LEFT [OUTER] JOIN


@dataclasses.dataclass
class HavingCond:
    """One HAVING conjunct: an aggregate (or group key) compared to a
    literal. Conjuncts AND together."""
    item: SelectItem          # the aggregated (or plain) expression
    op: str                   # =, <>, <, >, <=, >=
    value: Any


@dataclasses.dataclass
class SqlSelect:
    items: list[SelectItem]
    table: str
    alias: str
    joins: list[SqlJoin]
    where: ast.Filter | None  # props qualified when a join is present
    order_by: str | None
    order_desc: bool
    limit: int | None
    group_by: list[str] | None = None
    having: list[HavingCond] | None = None


_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<lparen>\()
    | (?P<rparen>\))
    | (?P<comma>,)
    | (?P<star>\*)
    | (?P<op><=|>=|<>|!=|=|<|>)
    | (?P<string>'(?:[^']|'')*')
    | (?P<number>[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?)
    | (?P<word>[A-Za-z_][A-Za-z0-9_.]*)
    )""", re.VERBOSE)

_AGGS = {"COUNT", "MIN", "MAX", "SUM", "AVG"}

from ..analytics.st_functions import SQL_SCALARS as _SQL_SCALARS  # noqa: E402

# ST predicate -> (column-first AST node, literal-first AST node): the
# literal-first rewrite is STContainsRule's argument flip
_ST_PREDS = {
    "ST_CONTAINS": (ast.Contains, ast.Within),
    "ST_WITHIN": (ast.Within, ast.Contains),
    "ST_COVERS": (ast.Contains, ast.Within),
    "ST_INTERSECTS": (ast.Intersects, ast.Intersects),
    "ST_DISJOINT": (ast.Disjoint, ast.Disjoint),
    "ST_CROSSES": (ast.Crosses, ast.Crosses),
    "ST_OVERLAPS": (ast.Overlaps, ast.Overlaps),
    "ST_TOUCHES": (ast.Touches, ast.Touches),
    "ST_EQUALS": (ast.GeomEquals, ast.GeomEquals),  # symmetric
}


class _Tokens:
    def __init__(self, text: str):
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if m is None:
                if text[pos:].strip() == "":
                    break
                raise SqlError(f"cannot tokenize at: {text[pos:pos+25]!r}")
            pos = m.end()
            kind = m.lastgroup
            self.toks.append((kind, m.group(kind)))
        self.i = 0

    def peek(self, ahead: int = 0):
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind: str, value: str | None = None) -> str:
        k, v = self.next()
        if k != kind or (value is not None
                         and (v or "").upper() != value.upper()):
            raise SqlError(f"expected {value or kind}, got {v!r}")
        return v

    def at_word(self, *words: str) -> bool:
        k, v = self.peek()
        return k == "word" and v.upper() in words

    def take_word(self, *words: str) -> bool:
        if self.at_word(*words):
            self.next()
            return True
        return False


def _unquote(s: str) -> str:
    return s[1:-1].replace("''", "'")


def _num(v: str) -> float:
    f = float(v)
    return int(f) if f.is_integer() and "." not in v and "e" not in v.lower() \
        else f


_RESERVED = {"FROM", "JOIN", "ON", "WHERE", "ORDER", "GROUP", "LIMIT",
             "AND", "OR", "NOT", "AS", "BY", "ASC", "DESC", "BETWEEN",
             "IN", "LIKE", "ILIKE", "IS", "NULL", "TRUE", "FALSE",
             "INNER", "LEFT", "OUTER", "HAVING"}

# geometry aggregates (the reference's ConvexHull UDAF,
# geomesa-spark-sql/.../udaf/ConvexHull.scala, plus the ST_Extent-style
# envelope fold)
_GEOM_AGGS = {"ST_CONVEXHULL": "convex_hull", "CONVEXHULL": "convex_hull",
              "CONVEX_HULL": "convex_hull",
              "ST_EXTENT": "extent", "EXTENT": "extent"}


class _Parser:
    def __init__(self, text: str):
        self.t = _Tokens(text)

    # -- top level ---------------------------------------------------------

    def select(self) -> SqlSelect:
        self.t.expect("word", "SELECT")
        items = self._items()
        self.t.expect("word", "FROM")
        table, alias = self._table_ref()
        joins = []
        while True:
            if self.t.take_word("LEFT"):
                self.t.take_word("OUTER")
                self.t.expect("word", "JOIN")
                joins.append(self._join(outer=True))
            elif self.t.take_word("INNER"):
                self.t.expect("word", "JOIN")
                joins.append(self._join())
            elif self.t.take_word("JOIN"):
                joins.append(self._join())
            else:
                break
        where = None
        if self.t.take_word("WHERE"):
            where = self._expr()
        group_by = None
        if self.t.take_word("GROUP"):
            self.t.expect("word", "BY")
            group_by = [self._name()]
            while self.t.peek()[0] == "comma":
                self.t.next()
                group_by.append(self._name())
        having = None
        if self.t.take_word("HAVING"):
            having = [self._having_cond()]
            while self.t.take_word("AND"):
                having.append(self._having_cond())
        order_by, desc = None, False
        if self.t.take_word("ORDER"):
            self.t.expect("word", "BY")
            order_by = self._name()
            if self.t.take_word("DESC"):
                desc = True
            else:
                self.t.take_word("ASC")
        limit = None
        if self.t.take_word("LIMIT"):
            limit = int(_num(self.t.expect("number")))
        k, v = self.t.peek()
        if k is not None:
            raise SqlError(f"unexpected trailing input: {v!r}")
        return SqlSelect(items, table, alias, joins, where,
                         order_by, desc, limit, group_by, having)

    def _having_cond(self) -> HavingCond:
        """agg(col|*) op literal, or group-key op literal."""
        k, v = self.t.peek()
        if k == "word" and (v.upper() in _AGGS
                            or v.upper() in _GEOM_AGGS) \
                and self.t.peek(1)[0] == "lparen":
            item = self._item()
        else:
            item = SelectItem(self._name())
        k, op = self.t.next()
        if k != "op":
            raise SqlError(f"expected operator in HAVING, got {op!r}")
        if op == "!=":
            op = "<>"
        return HavingCond(item, op, self._literal())

    def _table_ref(self) -> tuple[str, str]:
        name = self._name()
        alias = name
        if self.t.take_word("AS"):
            alias = self._name()
        elif (self.t.peek()[0] == "word"
              and self.t.peek()[1].upper() not in _RESERVED):
            alias = self._name()
        return name, alias

    def _join(self, outer: bool = False) -> SqlJoin:
        table, alias = self._table_ref()
        self.t.expect("word", "ON")
        # equi-join: ON a.col = b.col (no function-call parenthesis)
        if self.t.peek(1)[0] != "lparen":
            a = self._name()
            k, op = self.t.next()
            if k != "op" or op != "=":
                raise SqlError(f"expected '=' in equi-join ON, got {op!r}")
            b = self._name()
            if "." not in a or "." not in b:
                raise SqlError("join ON columns must be alias-qualified "
                               f"(got {a!r}, {b!r})")
            return SqlJoin(table, alias, "eq", None, a, b, outer)
        fn = self._name().upper()
        self.t.expect("lparen")
        a = self._name()
        self.t.expect("comma")
        b = self._name()
        if "." not in a or "." not in b:
            raise SqlError("join ON columns must be alias-qualified "
                           f"(got {a!r}, {b!r})")
        distance = None
        if fn == "ST_DWITHIN":
            self.t.expect("comma")
            distance = float(_num(self.t.expect("number")))
            kind = "dwithin"
        elif fn in ("ST_CONTAINS", "ST_COVERS"):
            kind = "contains"
        elif fn == "ST_INTERSECTS":
            kind = "intersects"
        else:
            raise SqlError(f"unsupported join predicate {fn}")
        self.t.expect("rparen")
        return SqlJoin(table, alias, kind, distance, a, b, outer)

    def _items(self) -> list[SelectItem]:
        items = [self._item()]
        while self.t.peek()[0] == "comma":
            self.t.next()
            items.append(self._item())
        return items

    def _item(self) -> SelectItem:
        k, v = self.t.peek()
        if k == "star":
            self.t.next()
            return SelectItem("*")
        if k == "word" and v.upper() in _GEOM_AGGS \
                and self.t.peek(1)[0] == "lparen":
            self.t.next()
            self.t.expect("lparen")
            col = self._name()
            self.t.expect("rparen")
            return SelectItem(col, _GEOM_AGGS[v.upper()], self._opt_alias())
        if k == "word" and v.upper() in _SQL_SCALARS \
                and self.t.peek(1)[0] == "lparen":
            fn = self.t.next()[1].upper()
            self.t.expect("lparen")
            if self.t.peek()[0] in ("number", "string"):
                # all-literal constructor (ST_MakeBBOX(0,0,1,1)): no
                # source column — the engine broadcasts the value
                kk, vv = self.t.next()
                first = _num(vv) if kk == "number" else _unquote(vv)
                col = "__const__"
                args = [first]
            else:
                col = self._name()
                args = []
            while self.t.peek()[0] == "comma":
                self.t.next()
                kk, vv = self.t.peek()
                if kk == "number":
                    args.append(_num(self.t.next()[1]))
                elif kk == "string":
                    args.append(_unquote(self.t.next()[1]))
                else:
                    g = self._geom_or_col()
                    if not isinstance(g, Geometry):
                        raise SqlError(
                            f"{fn}: literal argument expected, got "
                            f"column {g!r}")
                    args.append(g)
            self.t.expect("rparen")
            return SelectItem(col, "st", self._opt_alias(), fn=fn,
                              args=tuple(args))
        if k == "word" and v.upper() in _AGGS \
                and self.t.peek(1)[0] == "lparen":
            agg = self.t.next()[1].lower()
            self.t.expect("lparen")
            if self.t.peek()[0] == "star":
                self.t.next()
                col = "*"
            else:
                col = self._name()
            self.t.expect("rparen")
            alias = self._opt_alias()
            return SelectItem(col, agg, alias)
        col = self._name()
        return SelectItem(col, None, self._opt_alias())

    def _opt_alias(self) -> str | None:
        if self.t.take_word("AS"):
            return self._name()
        return None

    def _name(self) -> str:
        k, v = self.t.next()
        if k != "word":
            raise SqlError(f"expected identifier, got {v!r}")
        return v

    # -- boolean expressions (same shape as the ECQL parser) ---------------

    def _expr(self) -> ast.Filter:
        left = self._and()
        while self.t.take_word("OR"):
            left = ast.Or([left, self._and()])
        return left

    def _and(self) -> ast.Filter:
        left = self._not()
        while self.t.take_word("AND"):
            left = ast.And([left, self._not()])
        return left

    def _not(self) -> ast.Filter:
        if self.t.take_word("NOT"):
            return ast.Not(self._not())
        return self._primary()

    def _primary(self) -> ast.Filter:
        k, v = self.t.peek()
        if k == "lparen":
            self.t.next()
            e = self._expr()
            self.t.expect("rparen")
            return e
        if k == "word" and v.upper() in _ST_PREDS:
            return self._st_pred()
        if k == "word" and v.upper() == "ST_DWITHIN":
            return self._st_dwithin()
        return self._comparison()

    def _st_pred(self) -> ast.Filter:
        fn = self._name().upper()
        col_node, lit_node = _ST_PREDS[fn]
        self.t.expect("lparen")
        a = self._geom_or_col()
        self.t.expect("comma")
        b = self._geom_or_col()
        self.t.expect("rparen")
        if isinstance(a, str) and isinstance(b, Geometry):
            return col_node(a, b)
        if isinstance(a, Geometry) and isinstance(b, str):
            return lit_node(b, a)   # STContainsRule argument flip
        raise SqlError(f"{fn} needs one geometry column and one literal "
                       f"(joins use JOIN ... ON)")

    def _st_dwithin(self) -> ast.Filter:
        self.t.expect("word", "ST_DWITHIN")
        self.t.expect("lparen")
        a = self._geom_or_col()
        self.t.expect("comma")
        b = self._geom_or_col()
        self.t.expect("comma")
        d = float(_num(self.t.expect("number")))
        self.t.expect("rparen")
        if isinstance(a, str) and isinstance(b, Geometry):
            return ast.DWithin(a, b, d, "degrees")
        if isinstance(a, Geometry) and isinstance(b, str):
            return ast.DWithin(b, a, d, "degrees")
        raise SqlError("ST_DWithin needs one geometry column and one "
                       "literal (joins use JOIN ... ON)")

    def _geom_or_col(self):
        k, v = self.t.peek()
        if k == "word" and v.upper() in ("ST_GEOMFROMTEXT", "ST_GEOMFROMWKT",
                                         "ST_POINT", "ST_MAKEPOINT",
                                         "ST_MAKEBBOX", "ST_MAKEBOX2D"):
            fn = self._name().upper()
            self.t.expect("lparen")
            if fn in ("ST_GEOMFROMTEXT", "ST_GEOMFROMWKT"):
                g = parse_wkt(_unquote(self.t.expect("string")))
            elif fn in ("ST_POINT", "ST_MAKEPOINT"):
                x = _num(self.t.expect("number"))
                self.t.expect("comma")
                y = _num(self.t.expect("number"))
                g = Point(float(x), float(y))
            else:
                vals = [_num(self.t.expect("number"))]
                for _ in range(3):
                    self.t.expect("comma")
                    vals.append(_num(self.t.expect("number")))
                g = Envelope(*[float(x) for x in vals]).to_polygon()
            self.t.expect("rparen")
            return g
        return self._name()

    def _comparison(self) -> ast.Filter:
        prop = self._name()
        if self.t.take_word("IS"):
            neg = self.t.take_word("NOT")
            self.t.expect("word", "NULL")
            f: ast.Filter = ast.IsNull(prop)
            return ast.Not(f) if neg else f
        neg = self.t.take_word("NOT")
        if self.t.take_word("BETWEEN"):
            lo = self._literal()
            self.t.expect("word", "AND")
            hi = self._literal()
            f = ast.Between(prop, lo, hi)
            return ast.Not(f) if neg else f
        if self.t.take_word("IN"):
            self.t.expect("lparen")
            vals = [self._literal()]
            while self.t.peek()[0] == "comma":
                self.t.next()
                vals.append(self._literal())
            self.t.expect("rparen")
            f = ast.InList(prop, vals)
            return ast.Not(f) if neg else f
        if self.t.take_word("LIKE"):
            f = ast.Like(prop, str(self._literal()), True)
            return ast.Not(f) if neg else f
        if self.t.take_word("ILIKE"):
            f = ast.Like(prop, str(self._literal()), False)
            return ast.Not(f) if neg else f
        if neg:
            raise SqlError(f"unexpected NOT after {prop}")
        k, op = self.t.next()
        if k != "op":
            raise SqlError(f"expected operator after {prop}, got {op!r}")
        if op == "!=":
            op = "<>"
        return ast.Compare(op, prop, self._literal())

    def _literal(self) -> Any:
        k, v = self.t.next()
        if k == "string":
            return _unquote(v)
        if k == "number":
            return _num(v)
        if k == "word" and v.upper() == "TRUE":
            return True
        if k == "word" and v.upper() == "FALSE":
            return False
        raise SqlError(f"expected literal, got {v!r}")


def parse_sql(text: str) -> SqlSelect:
    return _Parser(text).select()
