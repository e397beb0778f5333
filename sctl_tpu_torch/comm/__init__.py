from .comm import Comm, exclusive_cumsum
from .launch import run_ranks, start_ranks
from .verbs import (allgatherv, alltoallv, alltoallv_ring, global_sort,
                    partition_n, partition_s, partition_w, route,
                    scatter_forward, scatter_reverse, sort_scatter_index)

__all__ = [
    "Comm", "exclusive_cumsum", "run_ranks", "start_ranks",
    "allgatherv", "alltoallv", "alltoallv_ring", "route", "partition_n",
    "partition_w", "partition_s", "global_sort", "sort_scatter_index",
    "scatter_forward", "scatter_reverse",
]
