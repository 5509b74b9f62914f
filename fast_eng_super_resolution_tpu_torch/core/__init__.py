from .graph import BucketSpec, Graph, GraphBatch, merge_batch, pad_and_bucket, pad_graph, stack_graphs

__all__ = ["BucketSpec", "Graph", "GraphBatch", "merge_batch",
           "pad_and_bucket", "pad_graph", "stack_graphs"]
