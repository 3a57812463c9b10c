"""Ingest converters: raw records -> FeatureBatch.

Mirrors geomesa-convert (SimpleFeatureConverterFactory.scala:194 +
format modules): a converter config declares an id expression and per-
attribute transform expressions over parsed input records. Formats:
delimited text (CSV/TSV), JSON (with dotted paths), and an in-memory
list-of-rows form.

Config shape (the TypeSafe-config structure, as a dict):
    {"type": "delimited-text", "format": "CSV",
     "id-field": "md5($0)",
     "fields": [{"name": "dtg", "transform": "isoDate($3)"},
                {"name": "geom", "transform": "point($1::double, $2::double)"}]}
"""

from __future__ import annotations

import csv
import io
import json
from itertools import chain, islice
from typing import Any, Iterable

import numpy as np

from ..features.batch import FeatureBatch
from ..features.sft import SimpleFeatureType
from .dsl import EvaluationContext, compile_expression, parse_expression

__all__ = ["SimpleFeatureConverter", "DelimitedTextConverter",
           "JsonConverter", "converter_for"]

# sentinel yielded by _records for unparseable inputs; process() counts
# it as a failure without evaluating transforms
_BAD_RECORD: list = []


class SimpleFeatureConverter:
    """Base: compile field transforms, process record streams."""

    def __init__(self, sft: SimpleFeatureType, config: dict):
        self.sft = sft
        self.config = config
        self.id_ast = parse_expression(config.get("id-field", "uuid()"))
        self.id_expr = compile_expression(config.get("id-field", "uuid()"))
        # every named field compiles IN DECLARATION ORDER — later
        # transforms (and the id expression) may reference earlier ones
        # as $fieldName (Transformers' fieldLookup). Intermediate fields
        # not in the SFT are building blocks only. Nameless entries are
        # column bindings (e.g. a bare JSON path referenced by number).
        # The AST is kept next to each compiled closure so the columnar
        # backend (convert/vectorized.py) can evaluate the same program.
        self.ordered_exprs: list[tuple[str, Any]] = []
        self.ordered_asts: list[tuple[str, tuple]] = []
        declared = {}
        for f in config.get("fields", []):
            if "name" not in f or f.get("transform") is None:
                continue
            declared[f["name"]] = True
            self.ordered_exprs.append(
                (f["name"], compile_expression(f["transform"])))
            self.ordered_asts.append(
                (f["name"], parse_expression(f["transform"])))
        for attr in sft.attributes:
            if attr.name not in declared:
                raise ValueError(f"no transform for attribute {attr.name!r}")
        from .validators import build_validators
        self.validator_names = list(
            config.get("options", {}).get("validators", []))
        self.validators = build_validators(self.validator_names, sft)

    def _records(self, source) -> Iterable[list]:
        """Yield column lists; cols[0] is the raw record."""
        raise NotImplementedError

    def process(self, source, ctx: EvaluationContext | None = None
                ) -> tuple[FeatureBatch, EvaluationContext]:
        ctx = ctx or EvaluationContext()
        return self._process_scalar(self._records(source), ctx), ctx

    def _process_scalar(self, records: Iterable[list],
                        ctx: EvaluationContext) -> FeatureBatch:
        """The record-at-a-time oracle; ``iter_batches`` is the fast path."""
        ids: list[str] = []
        data: dict[str, list] = {a.name: [] for a in self.sft.attributes}
        for cols in records:
            ctx.line += 1
            if cols is _BAD_RECORD:
                ctx.failure += 1
                continue
            try:
                fields: dict[str, Any] = {}
                for name, expr in self.ordered_exprs:
                    fields[name] = expr(cols, fields)
                fid = str(self.id_expr(cols, fields))
                values = {a.name: fields[a.name]
                          for a in self.sft.attributes}
            except Exception:
                ctx.failure += 1
                continue
            if self.validators:
                from .validators import validate
                if validate(self.validators, values) is not None:
                    ctx.failure += 1
                    continue
            ids.append(fid)
            for name, v in values.items():
                data[name].append(v)
            ctx.success += 1
        # point columns arrive as Point objects; from_dict handles them
        return FeatureBatch.from_dict(self.sft, ids, data)

    def iter_batches(self, source, ctx: EvaluationContext | None = None,
                     batch_rows: int | None = None):
        """Stream ``FeatureBatch``es of ``geomesa.ingest.batch.rows``
        records — the firehose entry point. Columnar evaluation by
        default (see convert/vectorized.py); ``geomesa.ingest.
        vectorized=false`` kills it back to the scalar oracle, and
        ``geomesa.ingest.verify=true`` runs both per chunk and asserts
        id-for-id equivalence.

        Yields (batch, ctx) per chunk; ctx is cumulative (pass one in to
        aggregate across sources).
        """
        from .vectorized import (INGEST_BATCH_ROWS, INGEST_VECTORIZED,
                                 INGEST_VERIFY, process_columnar,
                                 process_columns)
        ctx = ctx or EvaluationContext()
        rows = batch_rows or INGEST_BATCH_ROWS.as_int()
        vectorized = INGEST_VECTORIZED.as_bool()
        verify = INGEST_VERIFY.as_bool()

        # formats with a columnar source (CSV cell-splitting) skip the
        # per-record generator entirely; verify mode needs the record
        # stream for the scalar oracle, so it takes the row path
        col_chunks = getattr(self, "iter_column_chunks", None)
        if vectorized and not verify and col_chunks is not None:
            for cols, n, ragged, n_bad in col_chunks(source, rows):
                yield process_columns(self, cols, n, ragged, n_bad, ctx), ctx
            return

        def emit(chunk: list[list]) -> FeatureBatch:
            if not vectorized:
                return self._process_scalar(chunk, ctx)
            batch = process_columnar(self, chunk, ctx)
            if verify:
                oracle = self._process_scalar(chunk, EvaluationContext())
                if list(batch.ids) != list(oracle.ids):
                    raise AssertionError(
                        "vectorized/scalar id divergence: "
                        f"{len(batch.ids)} vs {len(oracle.ids)} rows")
            return batch

        chunk: list[list] = []
        for rec in self._records(source):
            chunk.append(rec)
            if len(chunk) >= rows:
                yield emit(chunk), ctx
                chunk = []
        if chunk:
            yield emit(chunk), ctx


def _uses_col0(node: tuple) -> bool:
    kind = node[0]
    if kind == "col":
        return node[1] == 0
    if kind in ("lit", "relit", "field"):
        return False
    if kind == "recast":
        return _uses_col0(node[1])
    if kind == "cast":
        return _uses_col0(node[2])
    if kind in ("try", "withdefault"):
        return _uses_col0(node[1]) or _uses_col0(node[2])
    return any(_uses_col0(a) for a in node[2])


class DelimitedTextConverter(SimpleFeatureConverter):
    """CSV/TSV lines -> features ($1..$N are the delimited columns)."""

    def __init__(self, sft: SimpleFeatureType, config: dict):
        super().__init__(sft, config)
        fmt = config.get("format", "CSV").upper()
        self.delimiter = {"CSV": ",", "TSV": "\t"}.get(fmt, ",")
        self.skip_lines = int(config.get("options", {}).get("skip-lines", 0))
        # re-joining every parsed row into the $0 raw record costs more
        # than the parse itself on wide rows — skip it when no transform
        # (and not the id expression) ever reads $0
        self._needs_raw = (_uses_col0(self.id_ast)
                           or any(_uses_col0(a)
                                  for _, a in self.ordered_asts))

    def _records(self, source):
        if isinstance(source, str):
            source = io.StringIO(source)
        reader = csv.reader(source, delimiter=self.delimiter)
        if self._needs_raw:
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [self.delimiter.join(row)] + row
        else:
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [""] + row

    def iter_column_chunks(self, source, rows: int):
        """Columnar CSV parse: split whole chunks of text into cell
        arrays instead of iterating records — the per-row work drops to
        two C string splits plus one numpy reshape. Yields
        ``(cols, n, ragged, n_bad)`` tuples for ``process_columns``.

        The split is only CSV-correct while no quote character appears;
        the first chunk containing ``"`` degrades the REST of the stream
        to the csv.reader row path (a quoted newline may span chunk
        boundaries, so per-chunk fallback would tear records). Ragged
        chunks (uneven delimiter counts) re-parse row-wise so column
        references err exactly the rows the scalar path would.
        """
        from .vectorized import _transpose, parse_csv_arrow
        if isinstance(source, str):
            source = io.StringIO(source)
        for _ in range(self.skip_lines):
            if not source.readline():
                return
        d = self.delimiter
        # Arrow's reader drops the raw line, so $0 users stay on the
        # python split (they need the unsplit text in column 0)
        use_arrow = not self._needs_raw

        def row_chunks(line_iter):
            reader = csv.reader(line_iter, delimiter=d)
            chunk: list[list] = []
            for row in reader:
                if not row:
                    continue
                chunk.append(([d.join(row)] + row) if self._needs_raw
                             else ([""] + row))
                if len(chunk) >= rows:
                    cols, ragged = _transpose(chunk)
                    yield cols, len(chunk), ragged, 0
                    chunk = []
            if chunk:
                cols, ragged = _transpose(chunk)
                yield cols, len(chunk), ragged, 0

        est = 0  # learned bytes/line; first chunk iterates to calibrate
        carry = ""
        while True:
            if est:
                # block read: one syscall-ish slab instead of `rows`
                # readline calls, cut at the last complete line
                block = source.read(rows * est)
                joined = carry + block
                if not joined:
                    return
                if block:
                    cut = joined.rfind("\n")
                    if cut < 0:  # line longer than the slab: keep growing
                        carry = joined
                        continue
                    carry, joined = joined[cut + 1:], joined[:cut + 1]
                else:
                    carry = ""  # EOF: flush the unterminated tail line
            else:
                raw = list(islice(source, rows))
                if not raw:
                    return
                joined = "".join(raw)
                est = max(16, len(joined) // len(raw))
            if '"' in joined:
                if carry:  # finish the cut-off line before re-splitting
                    carry += source.readline()
                yield from row_chunks(chain(
                    io.StringIO(joined), [carry] if carry else [], source))
                return
            got = parse_csv_arrow(joined, d) if use_arrow else None
            if got is None:
                got = self._split_chunk(joined, d)
            if got is not None:
                yield got

    def _split_chunk(self, joined: str, d: str):
        body = joined[:-1] if joined.endswith("\n") else joined
        if "\r" in body:  # str sources; text-mode files normalize already
            body = body.replace("\r\n", "\n").replace("\r", "\n")
        ls = body.split("\n")
        if "" in ls:  # blank lines are skipped, not counted
            ls = [line for line in ls if line]
            body = "\n".join(ls)
        n = len(ls)
        if n == 0:
            return None
        w1 = ls[0].count(d)
        flat = body.replace("\n", d).split(d)
        if (len(flat) == n * (w1 + 1)
                and all(line.count(d) == w1 for line in ls)):
            arr = np.array(flat, dtype=object).reshape(n, w1 + 1)
            raw_col = (np.array(ls, dtype=object) if self._needs_raw
                       else np.full(n, "", dtype=object))
            cols = [raw_col] + [arr[:, i] for i in range(w1 + 1)]
            return cols, n, False, 0
        # ragged: row-wise parse isolates exactly the short/long rows
        from .vectorized import _transpose
        recs = [(([d.join(r)] + r) if self._needs_raw else ([""] + r))
                for r in csv.reader(io.StringIO(joined), delimiter=d) if r]
        if not recs:
            return None
        cols, ragged = _transpose(recs)
        return cols, len(recs), ragged, 0


class JsonConverter(SimpleFeatureConverter):
    """JSON objects (one per line, or a top-level array) -> features.

    Field transforms use jsonPath('$.a.b') via the `$0` record: the
    config's fields may use ``jsonPath`` expressions written as
    ``path('a.b')`` which this converter resolves before transforms, so
    `$1..$N` bind to the declared paths in order.
    """

    def __init__(self, sft: SimpleFeatureType, config: dict):
        self.paths = [f["path"] for f in config.get("fields", [])
                      if "path" in f]
        # fields with a path but no transform default to the column ref
        fields = []
        col = 0
        for f in config.get("fields", []):
            f = dict(f)
            if "path" in f:
                col += 1
                if "name" in f:
                    f.setdefault("transform", f"${col}")
            fields.append(f)
        config = dict(config)
        config["fields"] = fields
        super().__init__(sft, config)

    @staticmethod
    def _resolve(obj: Any, path: str):
        cur = obj
        for part in path.replace("$.", "").split("."):
            if isinstance(cur, dict):
                cur = cur.get(part)
            elif isinstance(cur, list) and part.isdigit():
                cur = cur[int(part)]
            else:
                return None
        return cur

    def iter_column_chunks(self, source, rows: int):
        """Columnar JSON-lines parse: Arrow ``read_json`` decodes whole
        blocks in C and declared paths resolve as struct-field hops
        instead of a python dict walk per record. Yields
        ``(cols, n, ragged, n_bad)`` tuples for ``process_columns``.

        Degradations keep scalar semantics exactly: top-level-array
        sources, configs whose transforms read the ``$0`` record, and
        paths with list indices take the record path from the start; a
        block Arrow refuses (malformed line, mixed field types) sends
        that block AND the rest of the stream to the per-record parser,
        which isolates bad lines row-for-row."""
        from .vectorized import parse_json_arrow
        if not isinstance(source, str):
            source = source.read()
        stripped = source.strip()
        use_arrow = not (_uses_col0(self.id_ast)
                         or any(_uses_col0(a)
                                for _, a in self.ordered_asts))

        def record_chunks(records_iter):
            chunk: list[list] = []
            for rec in records_iter:
                chunk.append(rec)
                if len(chunk) >= rows:
                    yield self._record_cols(chunk)
                    chunk = []
            if chunk:
                yield self._record_cols(chunk)

        if not use_arrow or stripped.startswith("["):
            yield from record_chunks(self._records(stripped))
            return
        lines = [ln for ln in stripped.splitlines() if ln.strip()]
        for at in range(0, len(lines), rows):
            got = parse_json_arrow("\n".join(lines[at:at + rows]),
                                   self.paths)
            if got is None:
                yield from record_chunks(
                    self._records("\n".join(lines[at:])))
                return
            yield got

    @staticmethod
    def _record_cols(chunk: list[list]):
        """Scalar record chunk -> the (cols, n, ragged, n_bad) shape
        ``process_columns`` takes (bad records masked out, counted)."""
        from .vectorized import _transpose
        good = [r for r in chunk if r is not _BAD_RECORD]
        n_bad = len(chunk) - len(good)
        if not good:
            return [np.empty(0, dtype=object)], 0, False, n_bad
        cols, ragged = _transpose(good)
        return cols, len(good), ragged, n_bad

    def _records(self, source):
        if not isinstance(source, str):
            source = source.read()  # file-like: parse the whole stream
        stripped = source.strip()
        if stripped.startswith("["):
            try:
                objs = json.loads(stripped)
            except ValueError:
                yield _BAD_RECORD
                return
        else:
            objs = []
            for line in stripped.splitlines():
                if not line.strip():
                    continue
                try:
                    objs.append(json.loads(line))
                except ValueError:
                    objs.append(_BAD_RECORD)
        for obj in objs:
            if obj is _BAD_RECORD:
                yield _BAD_RECORD
                continue
            try:
                yield [obj] + [self._resolve(obj, p) for p in self.paths]
            except Exception:
                # a bad record must count as a failure, not kill the run
                yield _BAD_RECORD


def converter_for(sft: SimpleFeatureType, config: dict):
    kind = config.get("type", "delimited-text")
    if kind == "delimited-text":
        return DelimitedTextConverter(sft, config)
    if kind == "json":
        return JsonConverter(sft, config)
    if kind in ("xml", "fixed-width", "avro", "composite"):
        from .formats import (AvroConverter, CompositeConverter,
                              FixedWidthConverter, XmlConverter)
        cls = {"xml": XmlConverter, "fixed-width": FixedWidthConverter,
               "avro": AvroConverter, "composite": CompositeConverter}[kind]
        return cls(sft, config)
    if kind in ("shapefile", "jdbc", "osm"):
        from .geo_formats import (JdbcConverter, OsmConverter,
                                  ShapefileConverter)
        cls = {"shapefile": ShapefileConverter, "jdbc": JdbcConverter,
               "osm": OsmConverter}[kind]
        return cls(sft, config)
    raise ValueError(f"unknown converter type: {kind}")
