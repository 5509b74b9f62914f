from .kernelnn import KernelNN
from .registry import init_model

__all__ = ["KernelNN", "init_model"]
