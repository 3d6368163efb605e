from .dual_gnn import DualGNN, DualLayer
from .one_gnn import OneGNN, ResidualBlock

__all__ = ["DualGNN", "DualLayer", "OneGNN", "ResidualBlock"]
