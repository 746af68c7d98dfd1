"""The supernet: projection headers, the frozen BERT and the elastic trunk."""

from .headers import header_apply, init_header
from .mult import init_supernet, supernet_apply, supernet_headers, supernet_trunk

__all__ = [
    "header_apply",
    "init_header",
    "init_supernet",
    "supernet_apply",
    "supernet_headers",
    "supernet_trunk",
]
