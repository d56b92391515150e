from .checkpoint import Checkpoint, load_pytree, save_pytree
from .config import (TRAIN_DATASET_KEY, BackendConfig, CheckpointConfig,
                     DataConfig, FailureConfig, RunConfig, ScalingConfig,
                     SyncConfig)
from .session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from .trainer import Result, TorchTrainer, classify_pipeline_loss

__all__ = [
    "TorchTrainer", "Result", "classify_pipeline_loss", "Checkpoint",
    "ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
    "DataConfig", "SyncConfig", "BackendConfig", "TRAIN_DATASET_KEY",
    "report", "get_context", "get_checkpoint", "get_dataset_shard",
    "save_pytree", "load_pytree",
]
