"""Search models: the chunk-schedulable exact arg-min nonce searcher, on
one device or over a mesh of them."""

from .miner_model import NonceSearcher
from .sharded import MeshNonceSearcher

__all__ = ["MeshNonceSearcher", "NonceSearcher"]
