from .pipeline import (PartitionedDataset, SyntheticClassificationDataset,
                       SyntheticLMDataset)

__all__ = ["PartitionedDataset", "SyntheticClassificationDataset",
           "SyntheticLMDataset"]
