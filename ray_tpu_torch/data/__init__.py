from .block import (BlockAccessor, Schema, SchemaMismatchError, Table,
                    normalize_schema, to_block)
from .context import (BackpressurePolicy, ConcurrencyCapPolicy, DataContext,
                      MemoryBudgetPolicy)
from .dataset import Dataset, MaterializedDataset
from .iterator import DataIterator
from .interfaces import (
    ActorPoolStrategy,
    BlockBasedFileDatasink,
    Datasink,
    ExecutionOptions,
    ExecutionResources,
    NodeIdStr,
    ReadTask,
    RowBasedFileDatasink,
)
from .random_access import RandomAccessDataset
from .read_api import (
    Datasource,
    from_arrow,
    from_arrow_refs,
    from_blocks,
    from_huggingface,
    from_items,
    from_numpy,
    from_numpy_refs,
    from_pandas,
    from_pandas_refs,
    from_tf,
    from_torch,
    range,
    read_avro,
    read_binary_files,
    read_csv,
    read_datasource,
    read_delta,
    read_iceberg,
    read_images,
    read_json,
    read_mongo,
    read_numpy,
    range_tensor,
    read_parquet,
    read_parquet_bulk,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)

__all__ = [
    "Dataset", "MaterializedDataset", "DataIterator", "BlockAccessor",
    "to_block", "from_items", "from_numpy", "from_pandas", "from_arrow",
    "from_huggingface",
    "range", "read_parquet", "read_csv", "read_json", "read_text",
    "read_numpy", "read_binary_files", "read_images", "read_webdataset",
    "Datasource", "read_datasource", "read_sql", "read_tfrecords",
    "read_delta", "read_iceberg", "read_mongo", "read_avro",
    "read_parquet_bulk", "from_blocks", "from_arrow_refs",
    "from_pandas_refs", "from_numpy_refs", "from_torch", "from_tf",
    "RandomAccessDataset",
    "DataContext", "BackpressurePolicy", "ConcurrencyCapPolicy",
    "MemoryBudgetPolicy",
    "Datasink", "BlockBasedFileDatasink", "RowBasedFileDatasink",
    "ActorPoolStrategy", "ExecutionOptions", "ExecutionResources",
    "NodeIdStr", "ReadTask", "range_tensor", "Schema",
    "DatasetContext", "DatasetIterator", "Preprocessor", "Table",
]

# Spelling aliases the reference keeps exporting (data/__init__.py):
DatasetContext = DataContext
DatasetIterator = DataIterator

from .preprocessors import Preprocessor  # noqa: E402

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('data')
del _rlu
