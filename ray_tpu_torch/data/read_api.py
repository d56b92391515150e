"""Dataset creation APIs (reference: ``python/ray/data/read_api.py``).

Readers are lazy: each source is a callable executed inside a task, so a
``read_parquet`` over 1000 files schedules 1000 (fused) read+transform
tasks with streaming backpressure.
"""

from __future__ import annotations

import functools
import glob as globlib
import math
import os
from builtins import range as builtins_range
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .block import Table, to_block
from .dataset import Dataset


def _expand_paths(paths: Union[str, List[str]], suffix: str = "") -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            out.extend(sorted(
                f for f in globlib.glob(os.path.join(p, "**", "*"),
                                        recursive=True)
                if os.path.isfile(f) and f.endswith(suffix)))
        elif any(c in p for c in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files found for {paths}")
    return out


def _file_ds(sources: List[Any], files: List[str]) -> Dataset:
    """Dataset over file-read tasks, remembering the source paths
    (surfaced by ``Dataset.input_files`` — reference keeps the same
    metadata on its read tasks)."""
    ds = Dataset(sources)
    ds._input_files = list(files)
    return ds


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    import builtins

    n = len(items)
    if parallelism <= 0:
        parallelism = min(max(1, n // 1000), 200) if n else 1
    per = math.ceil(n / parallelism) if n else 1
    blocks = []
    for i in builtins.range(0, n, per) if n else [0]:
        chunk = items[i:i + per]
        if chunk and isinstance(chunk[0], dict):
            blocks.append(to_block(chunk))
        else:
            blocks.append(to_block({"item": np.asarray(chunk)
                                    if chunk else np.array([])}))
    return Dataset(blocks)


def range(n: int, *, parallelism: int = -1) -> Dataset:
    import builtins

    if parallelism <= 0:
        parallelism = min(200, max(1, n // 50000)) if n else 1
    per = math.ceil(n / parallelism) if n else 1
    sources = []
    for i in builtins.range(0, n, per):
        lo, hi = i, min(i + per, n)
        sources.append(functools.partial(_range_block, lo, hi))
    return Dataset(sources or [to_block({"id": np.array([], np.int64)})])


def _range_block(lo: int, hi: int):
    return {"id": np.arange(lo, hi, dtype=np.int64)}


def from_numpy(ndarrays: Union[np.ndarray, List[np.ndarray]],
               column: str = "data") -> Dataset:
    """One block per array (reference: ``ray.data.from_numpy``, which
    takes an array or a list of them); an N-D array is a tensor column."""
    if isinstance(ndarrays, np.ndarray):
        ndarrays = [ndarrays]
    return Dataset([to_block({column: arr}) for arr in ndarrays])


def from_pandas(df) -> Dataset:
    return Dataset([to_block(df)])


def from_arrow(table) -> Dataset:
    return Dataset([table])


def from_huggingface(hf_dataset, *, parallelism: int = -1) -> Dataset:
    """A HuggingFace ``datasets.Dataset`` as a distributed dataset
    (reference: ``ray.data.from_huggingface``). Zero-copy: HF datasets
    are arrow-backed, so the underlying table is taken directly and
    split into blocks."""
    if not hasattr(hf_dataset, "data"):
        raise ValueError(
            "from_huggingface needs a materialized datasets.Dataset; "
            "for streaming IterableDataset, iterate and use from_items "
            "(or load without streaming=True)")
    if getattr(hf_dataset, "_indices", None) is not None:
        # select()/shuffle()/filter() leave an indices mapping over the
        # base table; flatten so the arrow data matches the logical rows.
        hf_dataset = hf_dataset.flatten_indices()
    table = getattr(hf_dataset.data, "table", None)
    if table is None:
        return from_pandas(hf_dataset.to_pandas())
    n = len(table)
    if parallelism <= 0:
        parallelism = max(1, min(8, n // 10_000 or 1))
    if parallelism == 1 or n == 0:
        return Dataset([table.combine_chunks()])
    import builtins

    per = -(-n // parallelism)
    # NB: this module's ``range`` is the data API (ray.data.range).
    blocks = [table.slice(i * per, per).combine_chunks()
              for i in builtins.range(parallelism) if i * per < n]
    return Dataset(blocks)


def _read_parquet_file(path: str, columns):
    import pyarrow.parquet as pq

    return pq.read_table(path, columns=columns)


def read_parquet(paths: Union[str, List[str]], *,
                 columns: Optional[List[str]] = None,
                 parallelism: int = -1, **kw) -> Dataset:
    files = _expand_paths(paths, ".parquet")
    return _file_ds([functools.partial(_read_parquet_file, f, columns)
                     for f in files], files)


def _read_csv_file(path: str):
    import pyarrow.csv as pcsv

    return pcsv.read_csv(path)


def read_csv(paths: Union[str, List[str]], **kw) -> Dataset:
    files = _expand_paths(paths)
    return _file_ds([functools.partial(_read_csv_file, f)
                     for f in files], files)


def _read_json_file(path: str):
    import pyarrow.json as pjson

    return pjson.read_json(path)


def read_json(paths: Union[str, List[str]], **kw) -> Dataset:
    files = _expand_paths(paths)
    return _file_ds([functools.partial(_read_json_file, f)
                     for f in files], files)


def _read_text_file(path: str):
    with open(path) as f:
        return {"text": np.array([ln.rstrip("\n") for ln in f])}


def read_text(paths: Union[str, List[str]], **kw) -> Dataset:
    files = _expand_paths(paths)
    return _file_ds([functools.partial(_read_text_file, f)
                     for f in files], files)


def _read_numpy_file(path: str):
    return {"data": np.load(path)}


def read_numpy(paths: Union[str, List[str]], **kw) -> Dataset:
    files = _expand_paths(paths)
    return _file_ds([functools.partial(_read_numpy_file, f)
                     for f in files], files)


def _read_tfrecords_file(path: str, raw: bool, verify: bool):
    from .tfrecords import parse_example, read_tfrecord_frames

    if raw:
        return {"bytes": np.array(
            list(read_tfrecord_frames(path, verify=verify)), dtype=object)}
    rows = [parse_example(p)
            for p in read_tfrecord_frames(path, verify=verify)]
    if not rows:
        # Zero-row, zero-column block: a phantom column here would
        # pollute the dataset schema next to non-empty sibling files.
        return Table()
    return to_block(rows)


def read_tfrecords(paths: Union[str, List[str]], *, raw: bool = False,
                   verify_crc: bool = False, **kw) -> Dataset:
    """TFRecord files of ``tf.train.Example`` records, one row per
    record (reference: ``ray.data.read_tfrecords`` — implemented here
    without tensorflow: dependency-free framing + Example wire parsing,
    ``data/tfrecords.py``). ``raw=True`` yields the undecoded payload
    bytes instead; ``verify_crc`` checks the CRC32C frame checksums."""
    files = _expand_paths(paths)
    return _file_ds([functools.partial(_read_tfrecords_file, f, raw,
                                       verify_crc) for f in files], files)


def _read_sql_shard(connection_factory, sql: str, shard, n_shards):
    # DB-API has no portable row-range pushdown, so each task runs the
    # query and keeps its slice (the reference's read_sql carries the
    # same caveat and defaults to one read task; shard in SQL for large
    # results).
    conn = connection_factory()
    try:
        cur = conn.cursor()
        cur.execute(sql)
        cols = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    lo = (len(rows) * shard) // n_shards
    hi = (len(rows) * (shard + 1)) // n_shards
    part = rows[lo:hi]
    return to_block([dict(zip(cols, r)) for r in part]) if part \
        else {c: np.array([]) for c in cols}


def read_sql(sql: str, connection_factory, *, parallelism: int = 1,
             **kw) -> Dataset:
    """Rows of a SQL query via any DB-API connection factory
    (reference: ``ray.data.read_sql`` — connection factories, not
    connections, cross the wire so each read task opens its own).
    ``parallelism > 1`` splits the result set across tasks (each task
    runs the query; use a single task or shard in SQL for large
    results)."""
    parallelism = max(1, int(parallelism))
    return Dataset([functools.partial(_read_sql_shard, connection_factory,
                                      sql, i, parallelism)
                    for i in builtins_range(parallelism)])


def _read_binary_file(path: str, include_paths: bool):
    with open(path, "rb") as f:
        data = f.read()
    out: Dict[str, Any] = {"bytes": np.array([data], dtype=object)}
    if include_paths:
        out["path"] = np.array([path])
    return out


def read_binary_files(paths: Union[str, List[str]], *,
                      include_paths: bool = False, **kw) -> Dataset:
    """One row per file with a ``bytes`` column (reference:
    ``ray.data.read_binary_files``)."""
    files = _expand_paths(paths)
    return Dataset([functools.partial(_read_binary_file, f, include_paths)
                    for f in files])


def _read_image_file(path: str, size, mode, include_paths: bool):
    from PIL import Image

    img = Image.open(path)
    if mode is not None:
        img = img.convert(mode)
    if size is not None:
        img = img.resize((size[1], size[0]))
    arr = np.asarray(img)
    # One object-dtype cell per row: arrow columns are 1-D, image tensors
    # are not (batch consumers re-stack via the block accessor).
    col = np.empty(1, dtype=object)
    col[0] = arr
    out: Dict[str, Any] = {"image": col}
    if include_paths:
        out["path"] = np.array([path])
    return out


def read_images(paths: Union[str, List[str]], *,
                size: Optional[tuple] = None, mode: Optional[str] = None,
                include_paths: bool = False, **kw) -> Dataset:
    """Decoded images as an ``image`` tensor column (reference:
    ``ray.data.read_images``, ``read_api.py:598+``). ``size`` is
    (height, width); ``mode`` a PIL mode like "RGB"."""
    files = _expand_paths(paths)
    return _file_ds([
        functools.partial(_read_image_file, f, size, mode, include_paths)
        for f in files], files)


def _read_webdataset_shard(path: str):
    """One tar shard -> rows keyed by sample basename, one column per
    extension (the webdataset convention: ``sample001.jpg`` +
    ``sample001.cls`` + ... group into one row)."""
    import tarfile

    samples: Dict[str, Dict[str, bytes]] = {}
    order: List[str] = []
    with tarfile.open(path) as tar:
        for member in tar:
            if not member.isfile():
                continue
            # WebDataset convention: the extension starts at the FIRST
            # dot of the BASENAME (directories may contain dots).
            dirname, _, fname = member.name.rpartition("/")
            stem, dot, ext = fname.partition(".")
            base = f"{dirname}/{stem}" if dirname else stem
            if base not in samples:
                samples[base] = {}
                order.append(base)
            f = tar.extractfile(member)
            samples[base][ext or "bin"] = f.read() if f else b""
    cols = sorted({ext for s in samples.values() for ext in s})
    out: Dict[str, Any] = {
        "__key__": np.array(order, dtype=object)}
    for ext in cols:
        out[ext] = np.array([samples[k].get(ext, b"") for k in order],
                            dtype=object)
    return out


def read_webdataset(paths: Union[str, List[str]], **kw) -> Dataset:
    """WebDataset tar shards, one task per shard (reference:
    ``ray.data.read_webdataset``)."""
    files = _expand_paths(paths)
    return _file_ds([functools.partial(_read_webdataset_shard, f)
                     for f in files], files)


# ------------------------------------------------------- datasource plugin


class Datasource:
    """Custom connector API (reference: ``ray.data.Datasource``): return
    per-task thunks, each producing one block of rows."""

    def get_read_tasks(self, parallelism: int) -> List[Callable[[], Any]]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


def read_datasource(datasource: Datasource, *, parallelism: int = -1,
                    **kw) -> Dataset:
    tasks = datasource.get_read_tasks(max(parallelism, 1))
    if not tasks:
        return Dataset([to_block([])])
    return Dataset(list(tasks))


# ------------------------------------------------------------- lakehouse


def _delta_live_files(table_path: str, version: Optional[int]):
    """Replay the Delta transaction log -> (live parquet paths,
    partition values per path).

    Dependency-free: a Delta table is parquet parts plus a JSON action
    log (`_delta_log/<version 020d>.json`, one JSON action per line;
    `add`/`remove` actions carry data-file paths, `add.partitionValues`
    the hive-partition constants). Checkpoint parquet files compact older
    actions; they are replayed first when present (reference:
    ``ray.data.read_delta_lake`` delegates all of this to the deltalake
    package — absent from this image, hence the native replay).
    """
    import json as _json

    log_dir = os.path.join(table_path, "_delta_log")
    if not os.path.isdir(log_dir):
        raise FileNotFoundError(f"not a Delta table (no _delta_log): "
                                f"{table_path}")
    versions = sorted(
        int(os.path.basename(f)[:20])
        for f in globlib.glob(os.path.join(log_dir, "*.json"))
        if os.path.basename(f)[:20].isdigit())
    if version is not None:
        versions = [v for v in versions if v <= version]
        if not versions:
            raise ValueError(f"version {version} not in Delta log "
                             f"(have {versions})")
    live: Dict[str, dict] = {}
    # Checkpoints come in two layouts: single-part
    # `<v>.checkpoint.parquet` and multi-part
    # `<v>.checkpoint.<part>.<parts>.parquet`; group files by version so
    # a multi-part checkpoint replays ALL its parts.
    by_ver: Dict[int, List[str]] = {}
    for c in globlib.glob(os.path.join(log_dir, "*.checkpoint*.parquet")):
        base = os.path.basename(c)
        if base[:20].isdigit():
            by_ver.setdefault(int(base[:20]), []).append(c)
    ckpt_vers = sorted(v for v in by_ver
                       if version is None or v <= version)
    start_after = -1
    if ckpt_vers:
        import pyarrow.parquet as pq

        start_after = ckpt_vers[-1]
        for part_file in sorted(by_ver[start_after]):
            for row in pq.read_table(part_file).to_pylist():
                add = row.get("add")
                if add and add.get("path"):
                    live[add["path"]] = add.get("partitionValues") or {}
                rem = row.get("remove")
                if rem and rem.get("path"):
                    live.pop(rem["path"], None)
    for v in versions:
        if v <= start_after:
            continue
        with open(os.path.join(log_dir, f"{v:020d}.json")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                action = _json.loads(line)
                add = action.get("add")
                if add and add.get("path"):
                    live[add["path"]] = add.get("partitionValues") or {}
                rem = action.get("remove")
                if rem and rem.get("path"):
                    live.pop(rem["path"], None)
    return live


def _read_delta_file(table_path: str, rel_path: str, parts: dict,
                     columns):
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pq.read_table(os.path.join(table_path, rel_path), columns=columns)
    # Partition columns live in the directory structure, not the file;
    # attach them as constant columns (string-typed — Delta's
    # partitionValues are serialized strings).
    for col, val in parts.items():
        if columns is not None and col not in columns:
            continue
        if col not in t.column_names:
            t = t.append_column(col, pa.array([val] * len(t)))
    return t


def read_delta(path: str, *, version: Optional[int] = None,
               columns: Optional[List[str]] = None, **kw) -> Dataset:
    """Delta Lake table -> Dataset, one block per live data file, with
    time travel via ``version`` (reference: ``ray.data.read_delta_lake``).
    Implemented natively — see ``_delta_live_files``."""
    path = os.path.expanduser(path)
    live = _delta_live_files(path, version)
    if not live:
        return Dataset([to_block([])])
    return Dataset([functools.partial(_read_delta_file, path, rel, parts,
                                      columns)
                    for rel, parts in sorted(live.items())])


def read_iceberg(table_identifier: str, *,
                 catalog_kwargs: Optional[Dict[str, Any]] = None,
                 row_filter: Optional[str] = None,
                 selected_fields: Optional[tuple] = None,
                 parallelism: int = -1, **kw) -> Dataset:
    """Iceberg table via pyiceberg (reference:
    ``ray.data.read_iceberg``). This adapter requires the pyiceberg
    package (catalog resolution + scan planning are pyiceberg's job —
    ``data/avro.py`` can decode the manifests, but snapshot/partition
    semantics live above the file format) and raises an actionable
    ImportError without it (translation layer tested against an
    API-faithful fake)."""
    try:
        from pyiceberg.catalog import load_catalog
    except ImportError as e:
        raise ImportError(
            "pyiceberg is not installed in this image; install "
            "`pyiceberg` to use read_iceberg (read_delta has a native, "
            "dependency-free reader)") from e
    catalog = load_catalog(**(catalog_kwargs or {}))
    table = catalog.load_table(table_identifier)
    scan_kw: Dict[str, Any] = {}
    if row_filter is not None:
        scan_kw["row_filter"] = row_filter
    if selected_fields is not None:
        scan_kw["selected_fields"] = tuple(selected_fields)
    scan = table.scan(**scan_kw)
    arrow_table = scan.to_arrow()
    n = max(1, parallelism)
    if n == 1 or len(arrow_table) == 0:
        return Dataset([arrow_table])
    per = -(-len(arrow_table) // n)
    return Dataset([arrow_table.slice(i * per, per)
                    for i in builtins_range(n) if i * per < len(arrow_table)])


def _read_mongo_shard(uri: str, database: str, collection: str,
                      pipeline, shard: int, n_shards: int):
    import pymongo

    client = pymongo.MongoClient(uri)
    coll = client[database][collection]
    # Shard deterministically: every task scans in _id order, so index-mod
    # partitioning assigns each document to exactly one shard (natural
    # order differs between independent cursors and would duplicate/drop
    # rows under n_shards > 1).
    agg = list(pipeline or []) + [{"$sort": {"_id": 1}}]
    docs = coll.aggregate(agg)
    part = [
        {k: v for k, v in d.items() if k != "_id"}
        for i, d in enumerate(docs) if i % n_shards == shard]
    return to_block(part) if part else to_block([])


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline: Optional[List[dict]] = None,
               parallelism: int = 1, **kw) -> Dataset:
    """MongoDB collection -> Dataset (reference: ``ray.data.read_mongo``).
    Requires pymongo (absent from this image; adapter logic tested
    against a fake). Connection strings, not connections, cross the wire
    — each read task opens its own client. ``parallelism > 1`` shards
    client-side over an ``_id``-sorted scan: each task still cursors the
    full (post-pipeline) result, so it buys task-level parallelism for
    downstream transforms, not scan bandwidth — for large collections
    pre-partition in ``pipeline`` (e.g. ``$match`` on _id ranges) with
    ``parallelism=1`` per range."""
    try:
        import pymongo  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "pymongo is not installed in this image; install `pymongo` "
            "to use read_mongo") from e
    n = max(1, int(parallelism))
    return Dataset([functools.partial(_read_mongo_shard, uri, database,
                                      collection, pipeline, i, n)
                    for i in builtins_range(n)])


# ----------------------------------------------------- surface completion


def from_blocks(blocks: List[Any]) -> Dataset:
    """Dataset over pre-built blocks (reference: ``ray.data.from_blocks``
    — arrow tables, pandas frames, column dicts, or row lists)."""
    return Dataset([to_block(b) for b in blocks])


def from_arrow_refs(refs: List[Any]) -> Dataset:
    """ObjectRefs of arrow tables as a dataset, zero-copy (reference:
    ``ray.data.from_arrow_refs``); refs are valid block sources."""
    return Dataset(list(refs))


def from_pandas_refs(refs: List[Any]) -> Dataset:
    """ObjectRefs of DataFrames (reference: ``from_pandas_refs``). The
    per-block conversion runs worker-side inside the fused task
    (``to_block`` accepts frames), not on the driver."""
    return Dataset(list(refs))


def from_numpy_refs(refs: List[Any], column: str = "data") -> Dataset:
    """ObjectRefs of ndarrays (reference: ``from_numpy_refs``)."""
    return Dataset([functools.partial(_wrap_numpy_ref, r, column)
                    for r in refs])


def _wrap_numpy_ref(ref, column: str):
    import ray_tpu_torch

    return {column: np.asarray(ray_tpu_torch.get(ref))}


def from_torch(torch_dataset, *, parallelism: int = -1) -> Dataset:
    """A torch map- or iterable-style dataset as a distributed dataset
    (reference: ``ray.data.from_torch``). Rows become an ``item``
    column (tuple samples stay tuples, matching the reference)."""
    if hasattr(torch_dataset, "__len__") and \
            hasattr(torch_dataset, "__getitem__"):
        # Map-style: index explicitly — plain iteration would fall back
        # to the __getitem__ protocol, which loops forever on datasets
        # that never raise IndexError.
        items = [torch_dataset[i]
                 for i in builtins_range(len(torch_dataset))]
    else:
        items = list(torch_dataset)
    return from_items(items, parallelism=parallelism)


def read_parquet_bulk(paths: Union[str, List[str]], *,
                      columns: Optional[List[str]] = None,
                      **kw) -> Dataset:
    """One read task per file with NO metadata/partitioning pass up
    front (reference: ``ray.data.read_parquet_bulk`` — the fast path
    for many small homogeneous files; skips read_parquet's file-schema
    inspection entirely)."""
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:  # no directory expansion either — paths are taken as given
        files.append(os.path.expanduser(p))
    return _file_ds([functools.partial(_read_parquet_file, f, columns)
                     for f in files], files)


def _read_avro_file(path: str):
    from .avro import read_avro_file

    rows = read_avro_file(path)
    if not rows:
        return Table()
    return to_block(rows)


def read_avro(paths: Union[str, List[str]], **kw) -> Dataset:
    """Avro object container files, one task per file (reference:
    ``ray.data.read_avro`` — decoded by the dependency-free reader in
    ``data/avro.py``: zigzag varints, schema-driven records, null and
    deflate codecs)."""
    files = _expand_paths(paths)
    return _file_ds([functools.partial(_read_avro_file, f)
                     for f in files], files)


def range_tensor(n: int, *, shape: tuple = (1,),
                 parallelism: int = -1) -> Dataset:
    """Rows of ``{"data": full(shape, i)}`` for i in [0, n) (reference:
    ``ray.data.range_tensor`` — the tensor-column benchmark source)."""
    shape = tuple(shape)

    def to_tensor(batch):
        ids = batch["id"]
        col = np.empty(len(ids), dtype=object)
        for j, i in enumerate(ids):
            col[j] = np.full(shape, i)
        return {"data": col}

    return range(n, parallelism=parallelism).map_batches(to_tensor)


def from_tf(tf_dataset) -> Dataset:
    """A ``tf.data.Dataset`` materialized into a distributed dataset
    (reference: ``ray.data.from_tf`` — the reference also materializes;
    streaming TF pipelines should feed ``from_items`` incrementally)."""
    rows = []
    for item in tf_dataset.as_numpy_iterator():
        if isinstance(item, dict):
            rows.append(item)
        elif isinstance(item, tuple):
            rows.append({f"item_{i}": v for i, v in enumerate(item)})
        else:
            rows.append({"item": item})
    return from_items(rows)
