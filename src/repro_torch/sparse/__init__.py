"""Block-sparse data subsystem: CSR, padded block-ELL grid tiles and the
K-bucketed ragged grid (``repro_torch.sparse.format``), and the streaming
two-pass libsvm ingest (``repro_torch.sparse.ingest``: file -> CSR)."""

from repro_torch.sparse.format import (BUCKET_SKEW_THRESHOLD,
                                       BucketedGridData, CSRMatrix, K_CHUNK,
                                       MAX_K_BUCKETS, SPARSE_DENSITY_THRESHOLD,
                                       SUBLANE, SparseGridData, SparseTile,
                                       assign_k_buckets,
                                       bucketed_grid_from_csr, choose_k,
                                       csr_k_per_tile, density, grid_nbytes,
                                       make_bucketed_grid_data,
                                       make_sparse_grid_data,
                                       packed_bytes_per_step, pad_to_multiple,
                                       problem_k_per_tile,
                                       sparse_grid_from_csr, tile_k_skew)
from repro_torch.sparse.ingest import (MalformedLine, ScanStats,
                                       csr_primal_objective, ingest_libsvm,
                                       iter_csr_shards, scan_libsvm)

__all__ = [
    "BUCKET_SKEW_THRESHOLD", "BucketedGridData", "CSRMatrix", "K_CHUNK",
    "MAX_K_BUCKETS", "SPARSE_DENSITY_THRESHOLD", "SUBLANE", "SparseGridData",
    "SparseTile", "assign_k_buckets", "bucketed_grid_from_csr", "choose_k",
    "csr_k_per_tile", "density", "grid_nbytes", "make_bucketed_grid_data",
    "make_sparse_grid_data", "packed_bytes_per_step", "pad_to_multiple",
    "problem_k_per_tile", "sparse_grid_from_csr", "tile_k_skew",
    "MalformedLine", "ScanStats", "csr_primal_objective", "ingest_libsvm",
    "iter_csr_shards", "scan_libsvm",
]
