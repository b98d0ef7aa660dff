"""Data layer: datasets, samplers, loaders (host-side numpy).

Counterpart of reconfigisp_tpu/data/__init__.py (reference
codes/data/__init__.py:9-53).
"""

from reconfigisp_tpu_torch.data.datasets import (
    OnePlusDetectionDataset, PairRecordDataset, RawPairFolderDataset,
    SyntheticDetectionDataset, SyntheticPlantedDataset, SyntheticRawDataset,
    create_dataset, set_access_base)
from reconfigisp_tpu_torch.data.sampler import (
    HalfSplitSampler, Loader, create_loader, create_search_loaders)

__all__ = [
    "SyntheticRawDataset", "SyntheticPlantedDataset", "RawPairFolderDataset",
    "SyntheticDetectionDataset", "PairRecordDataset", "OnePlusDetectionDataset",
    "create_dataset", "set_access_base",
    "HalfSplitSampler", "Loader", "create_search_loaders", "create_loader",
]
