from odh_kubeflow_tpu_torch.train.checkpoint import CheckpointManager  # noqa: F401
from odh_kubeflow_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    cross_entropy_loss,
)
