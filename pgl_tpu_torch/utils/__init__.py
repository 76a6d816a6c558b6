from . import amp
from . import checkpoint
from . import config
from . import edge_index
from . import export
from . import platform
from . import profiler
from . import transform
from . import data
from . import mp_reader
from . import shared_embedding
from . import stream_pool
from .edge_index import EdgeIndex
from .logger import log

__all__ = ["amp", "checkpoint", "config", "edge_index", "export",
           "platform", "profiler", "transform", "data", "mp_reader",
           "shared_embedding", "stream_pool", "EdgeIndex", "log"]
