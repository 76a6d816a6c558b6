"""Application mini-frameworks (port of ``pgl_tpu/apps``; reference:
``apps/``): GNNAutoScale historical embeddings, the PGLBox-style
out-of-core engine with its ingestion, the walk-based unsupervised
trainer and the Graph4Rec toolkit. ``pglbox_model`` is not ported yet."""

from . import common
from . import gnn_autoscale
from . import graph4rec
from . import ingest
from . import pglbox
from . import unsupervised

__all__ = ["common", "gnn_autoscale", "graph4rec", "ingest", "pglbox",
           "unsupervised"]
