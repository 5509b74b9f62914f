from .scheduler import PartitionScheduler

__all__ = ["PartitionScheduler"]
