"""Application mini-frameworks (port of ``pgl_tpu/apps``; reference:
``apps/``): GNNAutoScale historical embeddings, the PGLBox-style
out-of-core engine with its ingestion and its GNN model stack, the
walk-based unsupervised trainer and the Graph4Rec toolkit."""

from . import common
from . import gnn_autoscale
from . import graph4rec
from . import ingest
from . import pglbox
from . import pglbox_model
from . import unsupervised

__all__ = ["common", "gnn_autoscale", "graph4rec", "ingest", "pglbox",
           "pglbox_model", "unsupervised"]
