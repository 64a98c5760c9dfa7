"""Candidate sources: pluggable, sublinear cascade stage 0.

See :mod:`repro_torch.candidates.base` for the protocol. Importing this
package registers the built-in sources (``full_scan``, ``centroid_lsh``,
``cluster_tree``) in :data:`SOURCES`.
"""
from repro_torch.candidates.base import (EMPTY_CENTER, SOURCES, SourceSpec,
                                         corpus_centroids, kmeans,
                                         pack_table, register_source,
                                         resolve_source)
from repro_torch.candidates.centroid_lsh import (CentroidLSHSource,
                                                 CentroidLSHSpec)
from repro_torch.candidates.cluster_tree import (ClusterTreeSource,
                                                 ClusterTreeSpec)
from repro_torch.candidates.fullscan import FullScanSource, FullScanSpec

__all__ = [
    "EMPTY_CENTER",
    "SOURCES",
    "SourceSpec",
    "CentroidLSHSource",
    "CentroidLSHSpec",
    "ClusterTreeSource",
    "ClusterTreeSpec",
    "FullScanSource",
    "FullScanSpec",
    "corpus_centroids",
    "kmeans",
    "pack_table",
    "register_source",
    "resolve_source",
]
