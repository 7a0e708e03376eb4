"""The inference surface: RetrieverConfig -> Retriever over an IndexStore
and a SearchBackend; serving.make_server puts a BatchingServer in front.
The sharded layout runs over the default process group (make_dp_mesh);
its ranks but 0 follow rank 0's server (serving.serve_followers)."""

from repro_torch.retrieval.index import IndexStore, build_index_store, encode_corpus
from repro_torch.retrieval.retriever import (
    Retriever,
    RetrieverConfig,
    make_dp_mesh,
    merge_shard_candidates,
)
from repro_torch.retrieval.search import (
    SEARCH_BACKENDS,
    DenseSearchBackend,
    FusedSearchBackend,
    SearchBackend,
    resolve_search_backend,
)
from repro_torch.retrieval.serving import load_trained_params, make_server, serve_followers

__all__ = [
    "IndexStore", "build_index_store", "encode_corpus",
    "Retriever", "RetrieverConfig", "make_dp_mesh", "merge_shard_candidates",
    "SEARCH_BACKENDS", "DenseSearchBackend", "FusedSearchBackend",
    "SearchBackend", "resolve_search_backend",
    "load_trained_params", "make_server", "serve_followers",
]
