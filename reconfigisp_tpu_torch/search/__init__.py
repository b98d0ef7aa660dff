"""Training and search.  Ported so far: IspTrainer, step-2 training of a
fixed pipeline."""

from reconfigisp_tpu_torch.search.trainer import IspTrainer

__all__ = ["IspTrainer"]
