"""Dataset preprocessors: fit statistics once, transform anywhere.

Reference: ``python/ray/data/preprocessors/`` (the AIR preprocessor
suite: scalers, encoders, imputer, hasher, tokenizer, discretizers,
concatenator, chain). ``fit`` runs streaming aggregates over the
dataset (driver holds only the statistics); ``transform`` rides
``map_batches`` so the work fuses into the block tasks like any other
batch op.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class PreprocessorNotFittedError(RuntimeError):
    pass


class Preprocessor:
    """Base API (reference: ``ray.data.preprocessor.Preprocessor``):
    ``fit(ds)`` learns state, ``transform(ds)`` applies it lazily,
    ``transform_batch(batch)`` applies it to one in-memory batch."""

    _is_fittable = True

    def __init__(self):
        self.stats_: Optional[dict] = None

    # -- to override ----------------------------------------------------
    def _fit(self, ds) -> dict:
        return {}

    def _transform_batch(self, batch: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # -- public ---------------------------------------------------------
    def fit(self, ds) -> "Preprocessor":
        self.stats_ = self._fit(ds)
        return self

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform(self, ds):
        self._check_fitted()
        return ds.map_batches(_TransformFn(self), batch_format="numpy")

    def transform_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        self._check_fitted()
        return self._transform_batch(
            {k: np.asarray(v) for k, v in batch.items()})

    def _check_fitted(self):
        if self._is_fittable and self.stats_ is None:
            raise PreprocessorNotFittedError(
                f"{type(self).__name__} must be fit() before transform")

    def __repr__(self):
        return f"{type(self).__name__}(fitted={self.stats_ is not None})"


class _TransformFn:
    """Pickles the fitted preprocessor once per task, not per batch."""

    def __init__(self, prep: Preprocessor):
        self.prep = prep

    def __call__(self, batch):
        return self.prep._transform_batch(batch)


# ------------------------------------------------------------- scalers


class _ColumnStatScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)


class StandardScaler(_ColumnStatScaler):
    """(x - mean) / std per column (reference: ``StandardScaler``)."""

    def _fit(self, ds):
        aggs = []
        for c in self.columns:
            aggs += [(c, "mean"), (c, "std")]
        got = ds.aggregate(*aggs)
        return {c: (got[f"mean({c})"], got[f"std({c})"] or 1.0)
                for c in self.columns}

    def _transform_batch(self, batch):
        for c in self.columns:
            mean, std = self.stats_[c]
            batch[c] = (batch[c].astype(np.float64) - mean) / (std or 1.0)
        return batch


class MinMaxScaler(_ColumnStatScaler):
    """(x - min) / (max - min) (reference: ``MinMaxScaler``)."""

    def _fit(self, ds):
        aggs = []
        for c in self.columns:
            aggs += [(c, "min"), (c, "max")]
        got = ds.aggregate(*aggs)
        return {c: (got[f"min({c})"], got[f"max({c})"])
                for c in self.columns}

    def _transform_batch(self, batch):
        for c in self.columns:
            lo, hi = self.stats_[c]
            span = (hi - lo) or 1.0
            batch[c] = (batch[c].astype(np.float64) - lo) / span
        return batch


class MaxAbsScaler(_ColumnStatScaler):
    """x / max|x| (reference: ``MaxAbsScaler``)."""

    def _fit(self, ds):
        got = ds.aggregate(*[(c, "absmax") for c in self.columns])
        return {c: got[f"absmax({c})"] or 1.0 for c in self.columns}

    def _transform_batch(self, batch):
        for c in self.columns:
            batch[c] = batch[c].astype(np.float64) / (self.stats_[c] or 1.0)
        return batch


class RobustScaler(_ColumnStatScaler):
    """(x - median) / IQR (reference: ``RobustScaler``)."""

    def __init__(self, columns: List[str],
                 quantile_range: tuple = (0.25, 0.75)):
        super().__init__(columns)
        self.quantile_range = quantile_range

    def _fit(self, ds):
        lo_q, hi_q = self.quantile_range
        out = {}
        for c in self.columns:
            # One streaming scan per column; all three quantiles come
            # from the same pull (three aggregate() calls would each
            # re-execute the whole pipeline).
            vals = np.concatenate([np.asarray(col, dtype=np.float64)
                                   for col in ds._iter_columns(c)])
            lo, med, hi = np.quantile(vals, [lo_q, 0.5, hi_q])
            out[c] = (float(med), float(hi - lo) or 1.0)
        return out

    def _transform_batch(self, batch):
        for c in self.columns:
            med, iqr = self.stats_[c]
            batch[c] = (batch[c].astype(np.float64) - med) / iqr
        return batch


class Normalizer(Preprocessor):
    """Row-wise norm scaling across columns (reference: ``Normalizer``);
    stateless."""

    _is_fittable = False

    def __init__(self, columns: List[str], norm: str = "l2"):
        super().__init__()
        self.columns = list(columns)
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"unknown norm {norm!r}")
        self.norm = norm

    def _transform_batch(self, batch):
        mat = np.stack([batch[c].astype(np.float64)
                        for c in self.columns], axis=1)
        if self.norm == "l2":
            denom = np.sqrt((mat ** 2).sum(axis=1))
        elif self.norm == "l1":
            denom = np.abs(mat).sum(axis=1)
        else:
            denom = np.abs(mat).max(axis=1)
        denom = np.where(denom == 0, 1.0, denom)
        for i, c in enumerate(self.columns):
            batch[c] = mat[:, i] / denom
        return batch


# ------------------------------------------------------------ encoders


def _distinct_per_column(ds, columns: List[str]) -> Dict[str, list]:
    """All columns' distinct values in ONE dataset execution (per-column
    ``ds.unique`` calls would each re-run the whole pipeline)."""
    import ray_tpu_torch

    from .block import BlockAccessor, to_block

    out: Dict[str, set] = {c: set() for c in columns}
    for ref in ds._stream_refs():
        cols = BlockAccessor(to_block(ray_tpu_torch.get(ref))).to_numpy()
        for c in columns:
            out[c].update(_scalar(v) for v in cols[c])
    return {c: sorted(vals) for c, vals in out.items()}


class OrdinalEncoder(Preprocessor):
    """Category -> dense int id, sorted order (reference:
    ``OrdinalEncoder``). Unseen categories map to -1."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds):
        return {c: {v: i for i, v in enumerate(vals)}
                for c, vals in _distinct_per_column(ds,
                                                    self.columns).items()}

    def _transform_batch(self, batch):
        for c in self.columns:
            table = self.stats_[c]
            batch[c] = np.array([table.get(_scalar(v), -1)
                                 for v in batch[c]], dtype=np.int64)
        return batch


class LabelEncoder(OrdinalEncoder):
    """OrdinalEncoder for the label column (reference:
    ``LabelEncoder``)."""

    def __init__(self, label_column: str):
        super().__init__([label_column])
        self.label_column = label_column


class OneHotEncoder(Preprocessor):
    """Category -> one-hot vector column per category (reference:
    ``OneHotEncoder`` — emits ``{col}_{value}`` indicator columns)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds):
        return _distinct_per_column(ds, self.columns)

    def _transform_batch(self, batch):
        for c in self.columns:
            vals = batch.pop(c)
            for cat in self.stats_[c]:
                batch[f"{c}_{cat}"] = np.array(
                    [1 if _scalar(v) == cat else 0 for v in vals],
                    dtype=np.int8)
        return batch


class MultiHotEncoder(Preprocessor):
    """List-valued category column -> multi-hot vector (reference:
    ``MultiHotEncoder``)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds):
        out = {}
        for c in self.columns:
            cats = set()
            for row in ds.iter_rows():
                cats.update(_scalar(v) for v in row[c])
            out[c] = sorted(cats)
        return out

    def _transform_batch(self, batch):
        for c in self.columns:
            cats = self.stats_[c]
            index = {v: i for i, v in enumerate(cats)}
            col = np.empty(len(batch[c]), dtype=object)
            for j, lst in enumerate(batch[c]):
                vec = np.zeros(len(cats), dtype=np.int8)
                for v in lst:
                    i = index.get(_scalar(v))
                    if i is not None:
                        vec[i] = 1
                col[j] = vec
            batch[c] = col
        return batch


# ----------------------------------------------------------- the rest


class SimpleImputer(Preprocessor):
    """Fill NaNs with mean/median/most_frequent/constant (reference:
    ``SimpleImputer``)."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Any = None):
        super().__init__()
        if strategy not in ("mean", "median", "most_frequent", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value

    def _fit(self, ds):
        out = {}
        for c in self.columns:
            if self.strategy == "constant":
                out[c] = self.fill_value
            elif self.strategy == "most_frequent":
                counts: collections.Counter = collections.Counter()
                for row in ds.iter_rows():
                    v = row[c]
                    if v is not None and not _is_nan(v):
                        counts[_scalar(v)] += 1
                out[c] = counts.most_common(1)[0][0] if counts else 0
            else:
                vals = []
                for col in ds._iter_columns(c):
                    arr = np.asarray(col, dtype=np.float64)
                    vals.append(arr[~np.isnan(arr)])
                allv = np.concatenate(vals) if vals else np.array([0.0])
                out[c] = float(np.mean(allv) if self.strategy == "mean"
                               else np.median(allv))
        return out

    def _transform_batch(self, batch):
        for c in self.columns:
            fill = self.stats_[c]
            col = batch[c]
            if col.dtype.kind == "f":
                batch[c] = np.where(np.isnan(col), fill, col)
            else:
                batch[c] = np.array(
                    [fill if v is None or _is_nan(v) else v for v in col])
        return batch


class FeatureHasher(Preprocessor):
    """Token-count dict/text column -> fixed-width hashed vector
    (reference: ``FeatureHasher``); stateless."""

    _is_fittable = False

    def __init__(self, columns: List[str], num_features: int = 64,
                 output_column: Optional[str] = None):
        super().__init__()
        self.columns = list(columns)
        self.num_features = num_features
        self.output_column = output_column or "hashed_features"

    def _transform_batch(self, batch):
        import zlib

        n = len(next(iter(batch.values())))
        col = np.empty(n, dtype=object)
        for j in range(n):
            vec = np.zeros(self.num_features, dtype=np.float64)
            for c in self.columns:
                v = batch[c][j]
                tokens = (v.items() if isinstance(v, dict)
                          else [(t, 1) for t in str(v).split()])
                for tok, cnt in tokens:
                    h = zlib.crc32(str(tok).encode()) % self.num_features
                    vec[h] += cnt
            col[j] = vec
        for c in self.columns:
            batch.pop(c)
        batch[self.output_column] = col
        return batch


class Tokenizer(Preprocessor):
    """String column -> token list column (reference: ``Tokenizer``);
    stateless, default whitespace split."""

    _is_fittable = False

    def __init__(self, columns: List[str],
                 tokenization_fn: Optional[Callable] = None):
        super().__init__()
        self.columns = list(columns)
        self.fn = tokenization_fn or (lambda s: str(s).split())

    def _transform_batch(self, batch):
        for c in self.columns:
            col = np.empty(len(batch[c]), dtype=object)
            for j, v in enumerate(batch[c]):
                col[j] = list(self.fn(_scalar(v)))
            batch[c] = col
        return batch


class UniformKBinsDiscretizer(Preprocessor):
    """Equal-width binning into int bin ids (reference:
    ``UniformKBinsDiscretizer``)."""

    def __init__(self, columns: List[str], bins: int):
        super().__init__()
        self.columns = list(columns)
        self.bins = int(bins)

    def _fit(self, ds):
        got = ds.aggregate(*[a for c in self.columns
                             for a in ((c, "min"), (c, "max"))])
        return {c: np.linspace(got[f"min({c})"], got[f"max({c})"],
                               self.bins + 1)
                for c in self.columns}

    def _transform_batch(self, batch):
        for c in self.columns:
            edges = self.stats_[c]
            batch[c] = np.clip(
                np.digitize(batch[c].astype(np.float64), edges[1:-1]),
                0, self.bins - 1).astype(np.int64)
        return batch


class CustomKBinsDiscretizer(Preprocessor):
    """Binning with caller-provided edges (reference:
    ``CustomKBinsDiscretizer``); stateless."""

    _is_fittable = False

    def __init__(self, columns: List[str], bins: List[float]):
        super().__init__()
        self.columns = list(columns)
        self.edges = np.asarray(bins, dtype=np.float64)

    def _transform_batch(self, batch):
        for c in self.columns:
            batch[c] = np.digitize(batch[c].astype(np.float64),
                                   self.edges[1:-1]).astype(np.int64)
        return batch


class Concatenator(Preprocessor):
    """Merge numeric columns into one vector column (reference:
    ``Concatenator``); stateless."""

    _is_fittable = False

    def __init__(self, columns: List[str],
                 output_column_name: str = "concatenated_features"):
        super().__init__()
        self.columns = list(columns)
        self.output_column_name = output_column_name

    def _transform_batch(self, batch):
        mat = np.stack([batch.pop(c).astype(np.float64)
                        for c in self.columns], axis=1)
        col = np.empty(len(mat), dtype=object)
        for j in range(len(mat)):
            col[j] = mat[j]
        batch[self.output_column_name] = col
        return batch


class Chain(Preprocessor):
    """Sequential composition (reference: ``Chain``): fit runs left to
    right, each stage fitting on the PREVIOUS stages' transform."""

    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)
        # A chain of only stateless stages is itself stateless and
        # transforms without fit() (reference: Chain NOT_FITTABLE).
        self._is_fittable = any(p._is_fittable for p in self.preprocessors)

    def fit(self, ds):
        cur = ds
        for p in self.preprocessors:
            if p._is_fittable:
                p.fit(cur)
            cur = p.transform(cur)
        self.stats_ = {"fitted": True}
        return self

    def transform(self, ds):
        self._check_fitted()
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def transform_batch(self, batch):
        self._check_fitted()
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch

    def _transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p._transform_batch(batch)
        return batch


def _scalar(v):
    return v.item() if hasattr(v, "item") else v


def _is_nan(v) -> bool:
    try:
        return bool(np.isnan(v))
    except (TypeError, ValueError):
        return False
