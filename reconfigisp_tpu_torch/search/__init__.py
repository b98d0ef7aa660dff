"""Training and search: IspTrainer (step 2, a fixed pipeline) and the
DARTS search trainers (step 1, the supernet)."""

from reconfigisp_tpu_torch.search.trainer import (
    DartsFtTrainer, DartsTrainer, IspTrainer)

__all__ = ["DartsFtTrainer", "DartsTrainer", "IspTrainer"]
