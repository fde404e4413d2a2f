from concrete_tpu_torch.representation.node import Node, Operation
from concrete_tpu_torch.representation.graph import Graph

__all__ = ["Node", "Operation", "Graph"]
