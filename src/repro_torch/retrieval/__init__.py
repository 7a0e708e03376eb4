"""The inference surface: RetrieverConfig -> Retriever over an IndexStore
and a SearchBackend; serving.make_server puts a BatchingServer in front."""

from repro_torch.retrieval.index import IndexStore, build_index_store, encode_corpus
from repro_torch.retrieval.retriever import Retriever, RetrieverConfig
from repro_torch.retrieval.search import (
    SEARCH_BACKENDS,
    DenseSearchBackend,
    FusedSearchBackend,
    SearchBackend,
    resolve_search_backend,
)
from repro_torch.retrieval.serving import load_trained_params, make_server

__all__ = [
    "IndexStore", "build_index_store", "encode_corpus",
    "Retriever", "RetrieverConfig",
    "SEARCH_BACKENDS", "DenseSearchBackend", "FusedSearchBackend",
    "SearchBackend", "resolve_search_backend",
    "load_trained_params", "make_server",
]
