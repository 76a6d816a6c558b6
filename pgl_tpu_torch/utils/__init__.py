from . import edge_index
from . import transform
from . import data
from . import mp_reader
from .edge_index import EdgeIndex

__all__ = ["edge_index", "transform", "data", "mp_reader", "EdgeIndex"]
