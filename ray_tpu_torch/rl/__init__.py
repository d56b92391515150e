"""``ray_tpu_torch.rl``: the on-policy and Podracer half of ``ray_tpu.rl``.

Port of ``ray_tpu/rl/``: the RL module (MLP and the ViT pixel module),
the PPO loss and learners, the mesh learners with V-trace inside the
update, env runners and their groups, connectors, the replay buffer,
PPO, IMPALA, APPO, multi-agent PPO and the Podracer tier. The learner's
update runs on its lease's device (a card with ``learners(use_gpu=True)``);
the runners' forwards run on the CPU unless they hold a GPU. The
off-policy, model-based and offline half (DQN, SAC, CQL, BC, MARWIL,
DreamerV3) is not ported: its names raise ``NotImplementedError`` naming
the ``ROADMAP.md`` item that brings it.
"""

from .algorithm import Algorithm, AlgorithmConfig, PPO, PPOConfig
from .appo import APPO, APPOConfig
from .connectors import (ClipRewards, ConnectorPipeline, FlattenObs,
                         GAEConnector, NormalizeObs, default_env_to_module,
                         default_learner_pipeline)
from .env_runner import EnvRunner, EnvRunnerGroup
from .impala import IMPALA, IMPALAConfig
# Reference exports both spellings (rllib/algorithms/__init__.py)
Impala = IMPALA
ImpalaConfig = IMPALAConfig
from .learner import Learner, LearnerGroup, gae
from .multi_agent import MultiAgentEnv, MultiAgentEnvRunner, MultiAgentPPO
from .pixel_env import CatchEnv
from .podracer import Podracer, PodracerConfig
from .replay import ReplayBuffer
from .rl_module import MLPModuleConfig, PixelModuleConfig
from .vtrace import vtrace

#: The names of ``ray_tpu.rl`` that wait for the second half (A14b).
NOT_PORTED = ("DQN", "DQNConfig", "SAC", "SACConfig", "CQL", "CQLConfig",
              "BC", "BCConfig", "MARWIL", "MARWILConfig",
              "episodes_to_rows", "DreamerV3", "DreamerV3Algo")

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig",
    "IMPALA", "IMPALAConfig", "EnvRunner", "EnvRunnerGroup", "Learner",
    "LearnerGroup", "gae", "vtrace", "MLPModuleConfig", "ReplayBuffer",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
    "APPO", "APPOConfig", "Impala", "ImpalaConfig",
    "Podracer", "PodracerConfig", "PixelModuleConfig", "CatchEnv",
    "ConnectorPipeline", "FlattenObs", "NormalizeObs", "ClipRewards",
    "GAEConnector", "default_env_to_module", "default_learner_pipeline",
]


def __getattr__(name):
    if name in NOT_PORTED:
        from .._private.roadmap import not_ported

        raise not_ported(f"ray_tpu_torch.rl.{name}", "rl")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('rl')
del _rlu
