from .one_gnn import OneGNN, ResidualBlock

__all__ = ["OneGNN", "ResidualBlock"]
