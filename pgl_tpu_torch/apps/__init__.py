"""Application mini-frameworks (port of ``pgl_tpu/apps``; reference:
``apps/``): GNNAutoScale historical embeddings, the PGLBox-style
out-of-core engine with its ingestion, and the walk-based unsupervised
trainer. ``graph4rec`` and ``pglbox_model`` are not ported yet."""

from . import common
from . import gnn_autoscale
from . import ingest
from . import pglbox
from . import unsupervised

__all__ = ["common", "gnn_autoscale", "ingest", "pglbox", "unsupervised"]
