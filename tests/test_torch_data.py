"""The port's ``data`` against the JAX package's, on the CPU.

One module-scoped cluster of each package. Every scenario builds the same
dataset from the same numpy inputs (made from a seed) in both packages,
``ray_tpu.data`` (Arrow blocks) and ``ray_tpu_torch.data`` (numpy blocks),
and holds the port's rows to the reference's: exactly, in the order the
reference defines; float aggregates and preprocessors within rtol 1e-9 in
float64; where the reference defines no order (groupby groups, hash
partitions) both results are sorted by key first. A missing value is None
in the reference's rows and NaN in a numeric column of the port's; the
rows are compared with both read as "missing".

The UDFs are lambdas and nested functions, so cloudpickle ships them by
value: no port worker imports this module, which imports JAX. The fixture
shuts both clusters down and removes the port's arenas and session
directory, failures included.
"""

import ast
import glob
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jd
from ray_tpu_torch import data as td

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-9
N = 240


@pytest.fixture(scope="module")
def clusters():
    base = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="rtd", dir=base if len(base) < 48
                            else "/tmp")
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = root
    session = None
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        ray_tpu.init(num_cpus=4, probe_tpu=False, ignore_reinit_error=True)
        ray_tpu_torch.init(num_cpus=4, probe_gpu=False)
        session = ray_tpu_torch._private.worker.global_worker().session_name
        yield root
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for p in glob.glob("/dev/shm/rtpt*"):
                if session and session[-8:] in p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            shutil.rmtree(root, ignore_errors=True)


def _items():
    """N rows from a numpy seed: an id, a key with ties, floats, a
    string and a 4-wide tensor cell."""
    rng = np.random.default_rng(12)
    k = rng.integers(0, 5, N)
    v = rng.standard_normal(N)
    x = rng.standard_normal((N, 4)).astype(np.float32)
    words = np.array(["ash", "birch", "cedar", "elm"])[rng.integers(0, 4, N)]
    return [{"id": i, "k": int(k[i]), "v": float(v[i]), "s": str(words[i]),
             "x": x[i]} for i in range(N)]


def _ds(pkg, parallelism=4, tensor=True):
    items = _items()
    if not tensor:
        items = [{c: r[c] for c in r if c != "x"} for r in items]
    return pkg.from_items(items, parallelism=parallelism)


def _cell(v):
    if isinstance(v, np.ndarray):
        return _cell(v.tolist())
    if isinstance(v, (list, tuple)):
        return [_cell(c) for c in v]
    if isinstance(v, np.generic):
        return _cell(v.item())
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "missing"
    return v


def _rows(rows):
    return [{k: _cell(v) for k, v in r.items()} for r in rows]


def _close(got, want, rtol=RTOL):
    """Rows equal, floats within rtol (in float64)."""
    assert len(got) == len(want)
    for g, w in zip(_rows(got), _rows(want)):
        assert list(g) == list(w)
        for c in w:
            if isinstance(w[c], float) and isinstance(g[c], float):
                np.testing.assert_allclose(g[c], w[c], rtol=rtol, atol=0)
            elif isinstance(w[c], list) and w[c] and \
                    isinstance(w[c][0], float):
                np.testing.assert_allclose(g[c], w[c], rtol=rtol, atol=0)
            else:
                assert g[c] == w[c], (c, g, w)


def _sorted(rows, *keys):
    return sorted(rows, key=lambda r: tuple(
        (1, "") if _cell(r[k]) == "missing" else (0, _cell(r[k]))
        for k in keys))


# ------------------------------------------------------ per-block transforms

TRANSFORMS = {
    "map_batches": lambda ds: ds.map_batches(
        lambda b: {"id": b["id"], "w": b["v"] * 2 + b["k"],
                   "x2": b["x"] * 2}, batch_size=25),
    "map": lambda ds: ds.map(lambda r: {**r, "v": r["v"] + r["k"]}),
    "filter": lambda ds: ds.filter(lambda r: r["k"] % 2 == 0),
    "flat_map": lambda ds: ds.flat_map(
        lambda r: [r, {**r, "id": r["id"] + 1000}] if r["k"] == 1 else []),
    "add_column": lambda ds: ds.add_column("w", lambda b: b["v"] * b["k"]),
    "projections": lambda ds: ds.select_columns(["id", "s", "x"])
    .rename_columns({"s": "word"}).drop_columns(["x"]),
    "limit": lambda ds: ds.filter(lambda r: r["k"] != 3).limit(37),
    "random_sample": lambda ds: ds.random_sample(0.3, seed=4),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_rows_match(clusters, name):
    want = TRANSFORMS[name](_ds(jd)).take_all()
    got = TRANSFORMS[name](_ds(td)).take_all()
    assert len(want) > 0
    assert _rows(got) == _rows(want)


# ---------------------------------------------------------------- all-to-all

EXCHANGES = {
    "random_shuffle": lambda ds: ds.random_shuffle(seed=5),
    "repartition": lambda ds: ds.repartition(3),
    "sort": lambda ds: ds.sort("k"),
    "sort_descending": lambda ds: ds.sort("k", descending=True),
    "sort_float": lambda ds: ds.sort("v"),
    "union": lambda ds: ds.union(ds.filter(lambda r: r["k"] == 2)),
    "zip": lambda ds: ds.zip(ds.map_batches(
        lambda b: {"k": b["k"] * 10, "t": b["v"]}).repartition(3)),
    "shuffle_then_filter": lambda ds: ds.random_shuffle(seed=9).filter(
        lambda r: r["v"] > 0).select_columns(["id", "v"]),
}


@pytest.mark.parametrize("name", sorted(EXCHANGES))
def test_exchange_rows_match_in_order(clusters, name):
    """Rows and their order: the numpy RNG draws are the reference's, and
    the port's sort keeps equal keys in order as Arrow's does."""
    jds, pds = EXCHANGES[name](_ds(jd)), EXCHANGES[name](_ds(td))
    assert pds.num_blocks() == jds.num_blocks()
    assert _rows(pds.take_all()) == _rows(jds.take_all())


def _shard_rows(shards):
    return [_rows(s.iter_rows() if hasattr(s, "iter_rows") else s)
            for s in shards]


SPLITS = {
    "split": lambda ds: ds.split(3),
    "streaming_split": lambda ds: ds.streaming_split(3),
    "streaming_split_equal": lambda ds: ds.streaming_split(3, equal=True),
    "split_at_indices": lambda ds: ds.split_at_indices([10, 100, 101]),
    "split_proportionately": lambda ds: ds.split_proportionately([0.5,
                                                                  0.25]),
    "train_test_split": lambda ds: list(ds.train_test_split(0.2,
                                                            shuffle=True,
                                                            seed=3)),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_shards_match(clusters, name):
    want = _shard_rows(SPLITS[name](_ds(jd)))
    got = _shard_rows(SPLITS[name](_ds(td)))
    assert [len(s) for s in got] == [len(s) for s in want]
    assert got == want


# -------------------------------------------------- groupby, join, unique

AGGS = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
        ("v", "count"), ("v", "std"), ("v", "absmax"), ("v", "quantile"),
        ("id", "sum"), ("id", "max"), ("id", "unique")]


@pytest.mark.parametrize("how", ["aggregate", "count", "sum", "mean", "std",
                                 "map_groups"])
def test_groupby_matches_sorted_by_key(clusters, how):
    def run(pkg):
        g = _ds(pkg, tensor=False).groupby("k")
        if how == "aggregate":
            return g.aggregate(*AGGS).take_all()
        if how == "count":
            return g.count().take_all()
        if how == "map_groups":
            return g.map_groups(lambda b: {
                "k": b["k"][:1], "n": np.array([len(b["id"])]),
                "first": b["id"][:1], "spread": [float(b["v"].max()
                                                       - b["v"].min())]}
            ).take_all()
        return getattr(g, how)("v").take_all()

    want, got = _sorted(run(jd), "k"), _sorted(run(td), "k")
    assert [r["k"] for r in got] == list(range(5))
    # Arrow's threaded distinct defines no order within a group
    for r in want + got:
        if "unique(id)" in r:
            r["unique(id)"] = sorted(r["unique(id)"])
    _close(got, want)


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_matches_sorted_by_key(clusters, how):
    rng = np.random.default_rng(31)

    def run(pkg):
        left = pkg.from_items([{"key": int(a), "a": int(b)} for a, b in zip(
            rng.integers(0, 30, 60), range(60))], parallelism=3)
        right = pkg.from_items([{"key": int(a), "b": float(b), "a": 7}
                                for a, b in zip(rng.integers(10, 40, 50),
                                                rng.standard_normal(50))],
                               parallelism=2)
        return left.join(right, on="key", how=how).take_all()

    state = rng.bit_generator.state
    want = run(jd)
    rng.bit_generator.state = state
    got = run(td)
    assert list(got[0]) == list(want[0]) == ["key", "a", "b", "a_1"]
    assert _rows(_sorted(got, "key", "a", "b")) == \
        _rows(_sorted(want, "key", "a", "b"))


def test_unique_and_dataset_aggregates_match(clusters):
    for col in ("k", "s"):
        assert td.from_items(_items(), parallelism=4).unique(col) == \
            jd.from_items(_items(), parallelism=4).unique(col)
    spec = [a for a in AGGS if a[1] != "unique"]
    want = _ds(jd).aggregate(*spec)
    got = _ds(td).aggregate(*spec)
    assert list(got) == list(want)
    np.testing.assert_allclose([float(got[k]) for k in want],
                               [float(want[k]) for k in want], rtol=RTOL)
    for fn in ("sum", "min", "max", "mean", "std"):
        np.testing.assert_allclose(getattr(_ds(td), fn)("v"),
                                   getattr(_ds(jd), fn)("v"), rtol=RTOL)


# ------------------------------------------------------------- consumption


def test_take_count_and_schema_match(clusters):
    jds, pds = _ds(jd), _ds(td)
    assert _rows(pds.take(5)) == _rows(jds.take(5))
    assert pds.count() == jds.count() == N
    assert pds.num_blocks() == jds.num_blocks() == 4
    assert pds.columns() == jds.columns() == ["id", "k", "v", "s", "x"]
    # Arrow makes the rows' 4-wide cells a variable-size list; the port
    # stacks them into a tensor column
    assert pds.schema().field("x") == ("x", np.dtype(np.float32), (4,))
    js, ps = _ds(jd, tensor=False).schema(), _ds(td, tensor=False).schema()
    assert ps == td.Schema.from_arrow(js)
    assert ps.types == [np.dtype(t) for t in (np.int64, np.int64,
                                              np.float64, object)]
    arr = np.zeros((6, 3, 2), np.float32)
    assert td.from_numpy(arr[:, :, 0]).schema() == td.Schema.from_arrow(
        jd.from_numpy(arr[:, :, 0]).schema())
    assert td.from_numpy(arr).schema().field("data").shape == (3, 2)


@pytest.mark.parametrize("kw", [
    dict(batch_size=7), dict(batch_size=64, drop_last=True),
    dict(batch_size=50, local_shuffle_buffer_size=100,
         local_shuffle_seed=2)], ids=["7", "64_drop_last", "local_shuffle"])
def test_iter_batches_match(clusters, kw):
    def batches(pkg):
        return [{c: np.stack([np.asarray(e) for e in col])
                 if col.dtype == object and c == "x" else col
                 for c, col in b.items()}
                for b in _ds(pkg).iter_batches(**kw)]

    want, got = batches(jd), batches(td)
    assert [len(b["id"]) for b in got] == [len(b["id"]) for b in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for c in w:
            np.testing.assert_array_equal(g[c], w[c])
            assert g[c].dtype == w[c].dtype


def test_iter_torch_batches_match_and_are_writable(clusters):
    """C2: the port casts a torch dtype after ``torch.as_tensor`` and
    copies the store's read-only views, so its tensors equal JAX
    ``Dataset.iter_torch_batches``'s and may be written, with no
    "not writable" warning."""
    import torch

    dtypes = {"v": torch.float32, "k": torch.int32}
    want = list(_ds(jd, tensor=True).select_columns(["id", "k", "v", "x"])
                .iter_torch_batches(batch_size=32, dtypes=dtypes))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = list(_ds(td, tensor=True).select_columns(["id", "k", "v", "x"])
                   .iter_torch_batches(batch_size=32, dtypes=dtypes))
        it = _ds(td).select_columns(["id", "v"]).streaming_split(2)[1]
        shard = list(it.iter_torch_batches(batch_size=16, dtypes=dtypes))
    assert not [w for w in caught if "not writable" in str(w.message)]
    assert len(got) == len(want) == math.ceil(N / 32)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for c in w:
            assert g[c].dtype == w[c].dtype and g[c].device.type == "cpu"
            assert torch.equal(g[c], w[c])
    assert shard[0]["v"].dtype == torch.float32
    for t in got[0].values():
        t.add_(1)  # writable: no store page behind it


def test_reference_iterator_breaks_on_a_torch_dtype(clusters):
    """C2 as it stands in the reference: ``DataIterator.
    iter_torch_batches`` hands a torch dtype to numpy's ``astype``."""
    import torch

    it = jd.from_items([{"a": 1.0}]).iterator()
    with pytest.raises(TypeError, match="data type"):
        next(it.iter_torch_batches(batch_size=1,
                                   dtypes={"a": torch.float32}))
    ok = next(td.from_items([{"a": 1.0}]).iterator().iter_torch_batches(
        batch_size=1, dtypes={"a": torch.float32}))
    assert ok["a"].dtype == torch.float32 and ok["a"].tolist() == [1.0]


def test_from_numpy_takes_a_list_of_blocks(clusters):
    arr = np.random.default_rng(5).integers(0, 100, (40, 8), dtype=np.int32)
    pds = td.from_numpy([arr[:10], arr[10:30], arr[30:]], column="tokens")
    assert pds.num_blocks() == 3
    want = jd.from_numpy(arr, column="tokens").take_all()
    assert _rows(pds.take_all()) == _rows(want)
    batch = next(pds.iter_batches(batch_size=40))["tokens"]
    assert batch.dtype == np.int32 and batch.shape == (40, 8)


def test_enforce_schema_matches(clusters):
    def run(pkg, schema):
        return pkg.from_items([{"a": 1, "b": 2.0}]).enforce_schema(
            schema).take_all()

    good = {"a": np.int64, "b": np.float64}
    assert run(td, good) == run(jd, good)
    bad = {"a": np.int64, "c": np.float64}
    for pkg in (jd, td):
        with pytest.raises(Exception, match="missing column 'c'") as err:
            run(pkg, bad)
        assert "unexpected column 'b'" in str(err.value)


def test_random_access_matches(clusters):
    keys = [0, 17, 239, 500, 120]
    got = _ds(td, tensor=False).to_random_access_dataset(
        "id", num_workers=2).multiget(keys)
    want = _ds(jd, tensor=False).to_random_access_dataset(
        "id", num_workers=2).multiget(keys)
    assert [r is None for r in got] == [r is None for r in want] == \
        [False, False, False, True, False]
    assert _rows([r for r in got if r]) == _rows([r for r in want if r])


# ---------------------------------------------------------- preprocessors

PREPROCESSORS = {
    "StandardScaler": lambda p: p.StandardScaler(["v", "id"]),
    "MinMaxScaler": lambda p: p.MinMaxScaler(["v"]),
    "MaxAbsScaler": lambda p: p.MaxAbsScaler(["v"]),
    "RobustScaler": lambda p: p.RobustScaler(["v"]),
    "Normalizer": lambda p: p.Normalizer(["v", "id"]),
    "OrdinalEncoder": lambda p: p.OrdinalEncoder(["s"]),
    "OneHotEncoder": lambda p: p.OneHotEncoder(["s"]),
    "SimpleImputer": lambda p: p.SimpleImputer(["v"], strategy="mean"),
    "UniformKBinsDiscretizer": lambda p: p.UniformKBinsDiscretizer(["v"],
                                                                   4),
    "Chain": lambda p: p.Chain(p.MinMaxScaler(["v"]),
                               p.LabelEncoder("s")),
}


@pytest.mark.parametrize("name", sorted(PREPROCESSORS))
def test_preprocessor_matches(clusters, name):
    from ray_tpu.data import preprocessors as jp
    from ray_tpu_torch.data import preprocessors as tp

    want = PREPROCESSORS[name](jp).fit_transform(
        _ds(jd, tensor=False)).take_all()
    got = PREPROCESSORS[name](tp).fit_transform(
        _ds(td, tensor=False)).take_all()
    _close(got, want)


# ------------------------------------------------------------ file formats


def test_tfrecords_round_trip_matches(clusters, tmp_path):
    rows = [{c: r[c] for c in ("id", "k", "v", "s")} for r in _items()[:50]]
    jd.from_items(rows, parallelism=2).write_tfrecords(str(tmp_path / "j"))
    td.from_items(rows, parallelism=2).write_tfrecords(str(tmp_path / "p"))
    jfiles = sorted((tmp_path / "j").iterdir())
    pfiles = sorted((tmp_path / "p").iterdir())
    assert [f.read_bytes() for f in pfiles] == \
        [f.read_bytes() for f in jfiles]
    want = jd.read_tfrecords(str(tmp_path / "j")).take_all()
    got = td.read_tfrecords(str(tmp_path / "p")).take_all()
    assert _rows(got) == _rows(want)
    raw = td.read_tfrecords(str(tmp_path / "j"), raw=True).take(1)
    assert isinstance(raw[0]["bytes"], bytes)


def test_parquet_round_trip_matches(clusters, tmp_path):
    jd.from_items(_items(), parallelism=2).write_parquet(str(tmp_path / "j"))
    td.from_items(_items(), parallelism=2).write_parquet(str(tmp_path / "p"))
    want = _rows(jd.read_parquet(str(tmp_path / "j")).take_all())
    # each package reads the other's files
    for path in ("j", "p"):
        assert _rows(td.read_parquet(str(tmp_path / path)).take_all()) == \
            want
    assert _rows(jd.read_parquet(str(tmp_path / "p")).take_all()) == want
    assert td.read_parquet(str(tmp_path / "p")).schema().field("x") == \
        ("x", np.dtype(np.float32), (4,))


# ------------------------------------------------------- the ingest path

_NO_ARROW = """
import glob, os, shutil, sys, tempfile
base = tempfile.gettempdir()
root = tempfile.mkdtemp(prefix="rtd", dir=base if len(base) < 48
                        else "/tmp")
os.environ["RAY_TPU_TORCH_TMPDIR"] = root
import numpy as np
import ray_tpu_torch
from ray_tpu_torch import data

ray_tpu_torch.init(num_cpus=2, probe_gpu=False)
session = ray_tpu_torch._private.worker.global_worker().session_name
try:
    def tag(b):
        import sys
        n = len(b["x"])
        return {"x": b["x"] * 2,
                "worker_pid": np.full(n, os.getpid()),
                "arrow": np.full(n, "pyarrow" in sys.modules),
                "pandas": np.full(n, "pandas" in sys.modules)}
    ds = data.from_numpy([np.arange(i * 50, (i + 1) * 50)
                          for i in range(4)], column="x")
    ds = ds.map_batches(tag).random_shuffle(seed=0)
    seen = []
    for it in ds.streaming_split(2):
        for b in it.iter_torch_batches(batch_size=16):
            seen.append(b)
    x = sorted(v for b in seen for v in b["x"].tolist())
    assert x == list(range(0, 400, 2)), x
    assert not any(b["arrow"].any() or b["pandas"].any() for b in seen)
    pids = {p for b in seen for p in b["worker_pid"].tolist()}
    assert pids and os.getpid() not in pids
    bad = [m for m in ("pyarrow", "pandas") if m in sys.modules]
    assert not bad, bad
    print("ok", len(pids))
finally:
    ray_tpu_torch.shutdown()
    for p in glob.glob("/dev/shm/rtpt*"):
        if session[-8:] in p:
            os.unlink(p)
    shutil.rmtree(root, ignore_errors=True)
"""


def test_ingest_path_loads_no_arrow_or_pandas():
    """from_numpy -> map_batches -> random_shuffle -> streaming_split ->
    iter_torch_batches in a fresh driver: neither the driver nor a worker
    that ran a map has pyarrow or pandas loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("RAY_TPU_TORCH_TMPDIR", None)
    proc = subprocess.run([sys.executable, "-c", _NO_ARROW], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


# ---------------------------------------------------------------- the copies

# Modules copied from the reference with only their names changed; the
# rest differ as CHANGES.md lists (block, dataset, iterator, read_api and
# __init__).
VERBATIM = ("data/context.py", "data/plan.py", "data/interfaces.py",
            "data/random_access.py", "data/preprocessors.py",
            "data/tfrecords.py", "data/avro.py")


def _renamed(text: str) -> str:
    text = re.sub(r"\bray_tpu\b(?!_torch)", "ray_tpu_torch", text)
    text = re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", text)
    return re.sub(r"\brtpu", "rtpt", text)


def _code(text: str) -> str:
    """The module's syntax tree without docstrings."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


@pytest.mark.parametrize("module", VERBATIM)
def test_data_copy_is_the_reference_code_but_for_names(module):
    got = (REPO / "ray_tpu_torch" / module).read_text()
    want = _renamed((REPO / "ray_tpu" / module).read_text())
    assert _code(got) == _code(want)


# ------------------------------------------------- C7: a stream's blocks

BLOCK_BYTES = 16 << 20


def _store_settles_to(worker, level, timeout=20.0):
    """The store's used bytes once they are at or below ``level`` (the
    driver flushes its released refs every 0.1 s), or the last reading
    when the timeout passes first."""
    import gc
    import time

    deadline = time.monotonic() + timeout
    while True:
        gc.collect()
        used = worker.store.stats()["bytes_in_use"]
        if used <= level or time.monotonic() > deadline:
            return used
        time.sleep(0.1)


def test_repeated_map_batches_passes_leave_the_store_as_they_found_it(
        clusters):
    """C7: the same ``from_numpy`` -> ``map_batches`` stream of 16 MiB
    blocks, read four times with the dataset deleted between passes,
    leaves the store's used bytes at their level before the first pass
    and the driver's ``_object_futures`` no larger than after the first
    pass. Before the fix each pass left its argument bundles and its
    returned blocks in the store (zero-ref, so evictable only under
    pressure, and two sizes of block fragmented the arena until a 1 GiB
    store filled in two passes of 256 MiB) and two futures a block in
    the driver."""
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    rows = BLOCK_BYTES // 8
    blocks = [np.full(rows, i, np.float64) for i in range(4)]
    start = _store_settles_to(w, 0, timeout=1.0)
    futures = []
    for _ in range(4):
        ds = td.from_numpy(blocks).map_batches(
            lambda b: {"data": b["data"] * 2})
        seen = [float(b["data"][0]) for b in ds.iter_batches(batch_size=rows)]
        assert seen == [0.0, 2.0, 4.0, 6.0]
        del ds
        used = _store_settles_to(w, start)
        assert used <= start, (used, start)
        futures.append(len(w._object_futures))
    assert max(futures[1:]) <= futures[0], futures


def test_a_release_that_outruns_a_borrow_leaves_the_block(clusters):
    """C7's free waits for late increfs: a reader's -1 that reaches the
    directory before the owner's +1 for that reader's copy (an async
    actor's reply can outrun its increfs) takes the count to 0 for a
    moment; the block must stay readable, and go once the last reference
    does."""
    import time

    from ray_tpu_torch._private.worker import global_worker

    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    w = global_worker()
    start = _store_settles_to(w, 0, timeout=1.0)
    ref = ray_tpu_torch.put(np.ones(BLOCK_BYTES // 8))
    oid = ref.id.binary()
    # the reader's release, then the owner's late +1 for its copy
    w.send_gcs_threadsafe({"t": "ref", "d": [(oid, -1)]})
    w.send_gcs_threadsafe({"t": "ref", "d": [(oid, 1)]})
    time.sleep(0.5)
    assert ray_tpu_torch.get(total.remote(ref), timeout=30) == \
        BLOCK_BYTES // 8
    del ref
    assert _store_settles_to(w, start) <= start
