from . import config
from . import edge_index
from . import transform
from . import data
from . import mp_reader
from . import shared_embedding
from . import stream_pool
from .edge_index import EdgeIndex
from .logger import log

__all__ = ["config", "edge_index", "transform", "data", "mp_reader",
           "shared_embedding", "stream_pool", "EdgeIndex", "log"]
