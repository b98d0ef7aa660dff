"""Training and search: IspTrainer (step 2, a fixed pipeline), the DARTS
search trainers (step 1, the supernet) and run_training, the loop both
CLIs and configs/*.yaml go through."""

from reconfigisp_tpu_torch.search.trainer import (
    DartsFtTrainer, DartsTrainer, IspTrainer, run_training)

__all__ = ["DartsFtTrainer", "DartsTrainer", "IspTrainer", "run_training"]
