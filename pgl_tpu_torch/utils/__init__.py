from . import edge_index
from . import transform
from .edge_index import EdgeIndex

__all__ = ["edge_index", "transform", "EdgeIndex"]
