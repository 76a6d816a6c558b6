"""Synthetic generators and dataset loaders (port of ``pgl_tpu/datasets``)."""

from .synthetic import (random_graph, powerlaw_graph, community_graph,
                        cora_shaped_graph, citation_shaped_graph,
                        blogcatalog_shaped_graph)
from .loaders import (CitationDataset, CoraDataset, BlogCatalogDataset,
                      ArXivDataset, RedditDataset, OgbnArxivDataset,
                      get_default_data_dir)

__all__ = ["random_graph", "powerlaw_graph", "community_graph",
           "cora_shaped_graph", "citation_shaped_graph",
           "blogcatalog_shaped_graph", "CitationDataset", "CoraDataset",
           "BlogCatalogDataset", "ArXivDataset", "RedditDataset",
           "OgbnArxivDataset", "get_default_data_dir"]
