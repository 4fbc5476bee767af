from .pipeline import PartitionedDataset, SyntheticClassificationDataset

__all__ = ["PartitionedDataset", "SyntheticClassificationDataset"]
