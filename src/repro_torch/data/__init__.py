from .batches import batch_shapes, synthetic_batch
from .pipeline import (PartitionedDataset, SyntheticClassificationDataset,
                       SyntheticLMDataset)

__all__ = ["batch_shapes", "synthetic_batch", "PartitionedDataset",
           "SyntheticClassificationDataset", "SyntheticLMDataset"]
