"""Serving: the paged continuous-batching engine and its page bookkeeping."""
from repro_torch.serve.engine import Request, ServeEngine, ServeStats  # noqa: F401
from repro_torch.serve.kvcache import (PageAllocator, PoolExhausted,  # noqa: F401
                                       PrefixIndex, page_hashes)
