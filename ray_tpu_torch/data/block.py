"""Blocks: the unit of data movement (reference: ``python/ray/data/block.py``).

A block is a :class:`Table`: named numpy columns of one length. It lives in
the shared-memory object store, whose serializer ships each column out of
band, so a worker reading a block gets views of the store's pages and the
training ingest path (``iter_torch_batches``) copies each batch once, onto
its device. The table serves the part of ``pyarrow.Table``'s interface that
the package calls, so the dataset code reads as the reference's.

Columns are 1-D arrays of scalars, N-D arrays whose first axis is the row
(tensor columns: a token row, an image), or 1-D object arrays (strings,
bytes, ragged cells). Arrow and pandas come in only at the edges
(``from_arrow``, ``from_pandas``, ``to_arrow``, ``to_pandas``, the
``"pyarrow"`` and ``"pandas"`` batch formats and the file readers and
writers), imported where they are used; the ingest path loads neither.
"""

from __future__ import annotations

from typing import (Any, Dict, Iterable, List, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np

Batch = Union["Table", Dict[str, np.ndarray], "pd.DataFrame", List[dict]]


def _is_arrow_table(x) -> bool:
    # by the type's module, so that asking never imports pyarrow
    return (type(x).__module__.startswith("pyarrow")
            and type(x).__name__ == "Table")


def _is_pandas(x) -> bool:
    return (type(x).__module__.startswith("pandas")
            and type(x).__name__ == "DataFrame")


def _require(pkg: str, api: str):
    try:
        return __import__(pkg)
    except ImportError as e:
        raise ImportError(f"{pkg} is not installed in this image; install "
                          f"`{pkg}` to use {api}") from e


def _object_column(cells) -> np.ndarray:
    out = np.empty(len(cells), dtype=object)
    for i, c in enumerate(cells):
        out[i] = c
    return out


def _as_column(v) -> np.ndarray:
    """One column as the block holds it: strings and bytes as object
    arrays of ``str``/``bytes`` (what Arrow's ``to_numpy`` gives), cells
    that are arrays of one shape stacked into an N-D tensor column, ragged
    cells as an object array."""
    if isinstance(v, np.ndarray):
        arr = v
    else:
        try:
            arr = np.asarray(v)
        except ValueError:  # ragged nested sequences
            arr = _object_column(list(v))
    if arr.ndim == 0:
        arr = arr.reshape(1)
    if arr.dtype.kind in "US":
        arr = arr.astype(object)
    if arr.dtype == object and arr.ndim == 1 and len(arr) and all(
            isinstance(c, np.ndarray) and c.ndim >= 1 for c in arr):
        shapes = {c.shape for c in arr}
        dtypes = {c.dtype for c in arr}
        if len(shapes) == 1 and len(dtypes) == 1 and \
                next(iter(dtypes)) != object:
            arr = np.stack(list(arr))
    return arr


class Field(NamedTuple):
    name: str
    type: np.dtype
    shape: Tuple[int, ...]


class Schema:
    """A block's columns: names, numpy dtypes and cell shapes (``()`` for
    a scalar column, ``(2048,)`` for a row of 2048 tokens). Built from a
    ``pyarrow.Schema`` by :meth:`from_arrow`."""

    def __init__(self, names: Iterable[str], types: Iterable[Any],
                 shapes: Optional[Iterable[Tuple[int, ...]]] = None):
        self.names = list(names)
        self.types = [np.dtype(t) for t in types]
        self.shapes = ([tuple(s) for s in shapes] if shapes is not None
                       else [()] * len(self.names))
        if not len(self.names) == len(self.types) == len(self.shapes):
            raise ValueError("a schema needs one type and shape per name")

    @classmethod
    def from_arrow(cls, schema) -> "Schema":
        fields = [(f.name, *_arrow_type_to_numpy(f.type)) for f in schema]
        return cls([f[0] for f in fields], [f[1] for f in fields],
                   [f[2] for f in fields])

    def field(self, name: str) -> Field:
        i = self.names.index(name)
        return Field(name, self.types[i], self.shapes[i])

    def __iter__(self):
        return iter(Field(*f) for f in zip(self.names, self.types,
                                            self.shapes))

    def __len__(self) -> int:
        return len(self.names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and list(self) == list(other)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {t}{list(s) if s else ''}"
                         for n, t, s in self)
        return f"Schema({cols})"


def _arrow_type_to_numpy(t) -> Tuple[np.dtype, Tuple[int, ...]]:
    import pyarrow as pa

    shape: Tuple[int, ...] = ()
    while pa.types.is_fixed_size_list(t):
        shape += (t.list_size,)
        t = t.value_type
    if (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_binary(t) or pa.types.is_large_binary(t)
            or pa.types.is_list(t) or pa.types.is_large_list(t)
            or pa.types.is_struct(t) or pa.types.is_null(t)):
        return np.dtype(object), shape
    return np.dtype(t.to_pandas_dtype()), shape


class Table:
    """Named numpy columns of one length: the port's block."""

    def __init__(self, columns: Optional[Dict[str, Any]] = None,
                 num_rows: Optional[int] = None):
        cols = {str(k): _as_column(v) for k, v in (columns or {}).items()}
        lengths = {len(c) for c in cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: "
                             f"{ {k: len(c) for k, c in cols.items()} }")
        self._cols = cols
        self._n = lengths.pop() if lengths else int(num_rows or 0)

    @classmethod
    def _of(cls, cols: Dict[str, np.ndarray], n: int) -> "Table":
        """A table over columns already in block form (no checks)."""
        t = cls.__new__(cls)
        t._cols = cols
        t._n = n
        return t

    # ---------------------------------------------------------- the shape

    @property
    def num_rows(self) -> int:
        return self._n

    @property
    def column_names(self) -> List[str]:
        return list(self._cols)

    @property
    def schema(self) -> Schema:
        return Schema(self._cols, [c.dtype for c in self._cols.values()],
                      [c.shape[1:] for c in self._cols.values()])

    @property
    def nbytes(self) -> int:
        total = 0
        for c in self._cols.values():
            if c.dtype != object:
                total += c.nbytes
            else:
                total += c.nbytes + sum(
                    len(x) if isinstance(x, (str, bytes)) else
                    getattr(x, "nbytes", 8) for x in c)
        return total

    def column(self, name: Union[str, int]) -> np.ndarray:
        if isinstance(name, int):
            name = self.column_names[name]
        try:
            return self._cols[name]
        except KeyError:
            raise KeyError(f"no column {name!r} in {self.column_names}") \
                from None

    # ------------------------------------------------- row and column ops

    def slice(self, offset: int = 0, length: Optional[int] = None
              ) -> "Table":
        offset = min(max(int(offset), 0), self._n)
        end = self._n if length is None else min(offset + int(length),
                                                 self._n)
        return Table._of({k: c[offset:end] for k, c in self._cols.items()},
                         max(end - offset, 0))

    def take(self, indices) -> "Table":
        idx = np.asarray(indices, dtype=np.int64)
        return Table._of({k: c[idx] for k, c in self._cols.items()},
                         len(idx))

    def filter(self, mask) -> "Table":
        mask = np.asarray(mask, dtype=bool)
        return Table._of({k: c[mask] for k, c in self._cols.items()},
                         int(mask.sum()))

    def select(self, names: List[str]) -> "Table":
        return Table._of({n: self.column(n) for n in names}, self._n)

    def drop_columns(self, names: Union[str, List[str]]) -> "Table":
        names = [names] if isinstance(names, str) else list(names)
        for n in names:
            self.column(n)  # a missing column raises, as Arrow's does
        return Table._of({k: c for k, c in self._cols.items()
                          if k not in names}, self._n)

    def rename_columns(self, names: List[str]) -> "Table":
        if len(names) != len(self._cols):
            raise ValueError(f"{len(names)} names for "
                             f"{len(self._cols)} columns")
        return Table._of(dict(zip(names, self._cols.values())), self._n)

    def append_column(self, name: str, column) -> "Table":
        col = _as_column(column)
        if self._cols and len(col) != self._n:
            raise ValueError(f"column {name!r} has {len(col)} rows, the "
                             f"table {self._n}")
        return Table._of({**self._cols, name: col}, len(col))

    def sort_by(self, sorting: Union[str, List[Tuple[str, str]]]
                ) -> "Table":
        """Stable sort on one or more keys, NaN last in either order
        (Arrow's ``sort_by``: ties keep their order)."""
        if isinstance(sorting, str):
            sorting = [(sorting, "ascending")]
        order = np.arange(self._n)
        # the last key first: each stable pass keeps the later keys' order
        for key, how in reversed(list(sorting)):
            order = order[_stable_order(self.column(key)[order],
                                        how == "descending")]
        return self.take(order)

    # ------------------------------------------------------------ to rows

    def to_pydict(self) -> Dict[str, list]:
        return {k: c.tolist() for k, c in self._cols.items()}

    def to_pylist(self) -> List[dict]:
        cols = self.to_pydict()
        return [{k: v[i] for k, v in cols.items()} for i in range(self._n)]

    def __repr__(self) -> str:
        return f"Table({self._n} rows, {self.schema})"

    @staticmethod
    def concat(tables: List["Table"]) -> "Table":
        """Row-wise concatenation. A column missing from some tables is
        filled with ``None`` there (Arrow's default promotion fills
        nulls); numpy promotes differing dtypes."""
        tables = list(tables)
        if len(tables) == 1:
            return tables[0]
        names: List[str] = []
        for t in tables:
            names += [n for n in t.column_names if n not in names]
        cols = {}
        for name in names:
            parts = [t._cols[name] if name in t._cols
                     else np.full(t.num_rows, None, dtype=object)
                     for t in tables]
            if len({p.shape[1:] for p in parts}) > 1 or (
                    len({p.dtype == object for p in parts}) > 1
                    and len({p.ndim for p in parts}) > 1):
                # tensor cells of differing shapes: ragged cells
                parts = [p if p.ndim == 1 and p.dtype == object
                         else _object_column(list(p)) for p in parts]
            cols[name] = np.concatenate(parts)
        return Table._of(cols, sum(t.num_rows for t in tables))


def _stable_order(col: np.ndarray, descending: bool) -> np.ndarray:
    """Indices that sort ``col`` stably, NaN last."""
    nan = (np.isnan(col) if col.dtype.kind == "f"
           else np.zeros(len(col), bool))
    idx = np.nonzero(~nan)[0]
    vals = col[idx]
    if descending:
        # a stable ascending sort of the reversed column, reversed, keeps
        # equal keys in their first order
        rev = np.argsort(vals[::-1], kind="stable")[::-1]
        order = (len(vals) - 1) - rev
    else:
        order = np.argsort(vals, kind="stable")
    return np.concatenate([idx[order], np.nonzero(nan)[0]])


def to_block(data: Batch) -> Table:
    """Normalize any batch format into a :class:`Table` block."""
    if isinstance(data, Table):
        return data
    if _is_arrow_table(data):
        return _from_arrow(data)
    if _is_pandas(data):
        return Table({str(c): data[c].to_numpy() for c in data.columns},
                     num_rows=len(data))
    if isinstance(data, dict):
        return Table(data)
    if isinstance(data, list):
        if data and isinstance(data[0], dict):
            # Arrow's ``from_pylist``: the first row's keys, None where a
            # later row lacks one
            names = list(data[0])
            return Table({k: _cells([row.get(k) for row in data])
                          for k in names})
        return Table({"item": _cells(data)})
    if isinstance(data, np.ndarray):
        return to_block({"data": data})
    raise TypeError(f"cannot convert {type(data)} to a block")


def _cells(values: list) -> np.ndarray:
    """One column from row values: scalars as a typed array, arrays or
    lists of one shape stacked, anything else (None, dicts, ragged cells)
    as an object array."""
    if not values:
        return np.array([])
    if any(v is None or isinstance(v, dict) for v in values):
        return _object_column(values)
    if all(isinstance(v, np.ndarray) for v in values):
        return _as_column(_object_column(values))
    return _as_column(values)


# ----------------------------------------------------------- the edges


def _from_arrow(table) -> Table:
    import pyarrow as pa

    cols = {}
    for name in table.column_names:
        col = table.column(name)
        t = col.type
        if pa.types.is_fixed_size_list(t):
            shape = []
            flat = col.combine_chunks()
            while pa.types.is_fixed_size_list(flat.type):
                shape.append(flat.type.list_size)
                flat = flat.flatten()
            cols[name] = flat.to_numpy(zero_copy_only=False).reshape(
                -1, *shape)
        elif _is_tensor_struct(t):
            # the reference's {bytes, shape, dtype} cells
            cols[name] = _as_column(_object_column([
                np.frombuffer(d["__tb__"], dtype=np.dtype(d["__td__"]))
                .reshape(d["__ts__"]).copy() for d in col.to_pylist()]))
        else:
            cols[name] = _as_column(col.to_numpy(zero_copy_only=False))
    return Table(cols, num_rows=table.num_rows)


def _is_tensor_struct(t) -> bool:
    import pyarrow as pa

    return (pa.types.is_struct(t) and t.num_fields == 3
            and {t.field(i).name for i in range(3)}
            == {"__tb__", "__ts__", "__td__"})


def to_arrow(block: Table):
    """The block as a ``pyarrow.Table``: N-D columns as nested fixed-size
    lists, object columns by Arrow's own inference."""
    pa = _require("pyarrow", "to_arrow")
    arrays = {}
    for name in block.column_names:
        col = block.column(name)
        if col.dtype == object:
            arrays[name] = pa.array([c.tolist() if isinstance(c, np.ndarray)
                                     else c for c in col])
        elif col.ndim == 1:
            arrays[name] = pa.array(col)
        else:
            arr = pa.array(np.ascontiguousarray(col).reshape(-1))
            for size in reversed(col.shape[1:]):
                arr = pa.FixedSizeListArray.from_arrays(arr, size)
            arrays[name] = arr
    return pa.table(arrays)


def to_pandas(block: Table):
    pd = _require("pandas", "to_pandas")
    return pd.DataFrame({name: (col if col.ndim == 1 else list(col))
                         for name, col in BlockAccessor(block)
                         .to_numpy().items()})


class BlockAccessor:
    def __init__(self, block: Table):
        self.block = block

    @staticmethod
    def for_block(block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        return self.block.num_rows

    def size_bytes(self) -> int:
        return self.block.nbytes

    def schema(self) -> Schema:
        return self.block.schema

    def to_arrow(self):
        return to_arrow(self.block)

    def to_pandas(self):
        return to_pandas(self.block)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {name: self.block.column(name)
                for name in self.block.column_names}

    def to_batch(self, batch_format: str):
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def slice(self, start: int, end: int) -> Table:
        return self.block.slice(start, end - start)

    def rows(self) -> Iterable[dict]:
        """Row dicts: Python scalars, and a writable copy of each tensor
        cell (UDFs may change it in place)."""
        names = self.block.column_names
        cols = []
        for name in names:
            col = self.block.column(name)
            if col.ndim > 1:
                cols.append([np.array(c) for c in col])
            elif col.dtype == object:
                cols.append(list(col))
            else:
                cols.append(col.tolist())
        return [dict(zip(names, vals)) for vals in zip(*cols)] if names \
            else [{} for _ in range(self.block.num_rows)]

    @staticmethod
    def concat(blocks: List[Table]) -> Table:
        blocks = [b for b in blocks if b.num_rows > 0] or blocks[:1]
        return Table.concat(blocks)


class SchemaMismatchError(TypeError):
    """A block violated an enforced schema contract (strict-schema
    analog of the reference's strict-mode type checks; raised inside the
    producing task so the failure names the offending stage, not a
    downstream consumer)."""


def normalize_schema(schema) -> Schema:
    """Accept a :class:`Schema`, a ``pyarrow.Schema`` or a ``{name:
    type}`` mapping. Values may be numpy/str dtype specs, ``str``/``object``
    (text columns: object arrays of ``str``), or Arrow ``DataType``s (a
    fixed-size list is a tensor column)."""
    if isinstance(schema, Schema):
        return schema
    if type(schema).__module__.startswith("pyarrow"):
        return Schema.from_arrow(schema)
    if isinstance(schema, dict):
        names, types, shapes = [], [], []
        for k, v in schema.items():
            shape: Tuple[int, ...] = ()
            if type(v).__module__.startswith("pyarrow"):
                v, shape = _arrow_type_to_numpy(v)
            elif v in (str, "str", "string", "object", object, bytes):
                v = object
            names.append(k)
            types.append(np.dtype(v))
            shapes.append(shape)
        return Schema(names, types, shapes)
    raise TypeError(f"schema must be a Schema, a pyarrow.Schema or a dict, "
                    f"got {type(schema)}")


def check_schema(block: Table, expected: Schema,
                 where: str = "enforce_schema") -> None:
    """Exact-contract validation: column names (order-insensitive), dtypes
    and cell shapes must match. Raises SchemaMismatchError naming every
    difference — silent promotion is exactly what a schema contract
    exists to prevent."""
    if block.num_rows == 0:
        # A fully-filtered block carries whatever schema its producer
        # left (possibly the pre-map input schema) — there are no rows
        # to violate the contract.
        return

    def show(f):
        return f"{f.type}{list(f.shape) if f.shape else ''}"

    got = {f.name: f for f in block.schema}
    want = {f.name: f for f in expected}
    problems = []
    for name in want.keys() - got.keys():
        problems.append(f"missing column {name!r} ({show(want[name])})")
    for name in got.keys() - want.keys():
        problems.append(f"unexpected column {name!r} ({show(got[name])})")
    for name in want.keys() & got.keys():
        if (want[name].type, want[name].shape) != \
                (got[name].type, got[name].shape):
            problems.append(f"column {name!r}: expected "
                            f"{show(want[name])}, got {show(got[name])}")
    if problems:
        raise SchemaMismatchError(
            f"[{where}] block schema violates the enforced contract: "
            + "; ".join(sorted(problems)))
