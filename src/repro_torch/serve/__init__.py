"""Serving: the paged continuous-batching engine, its page bookkeeping and
token selection (greedy or sampled with JAX's threefry keys)."""
from repro_torch.serve.engine import Request, ServeEngine, ServeStats  # noqa: F401
from repro_torch.serve.kvcache import (PageAllocator, PoolExhausted,  # noqa: F401
                                       PrefixIndex, page_hashes)
from repro_torch.serve.sampling import (GREEDY, SamplingParams,  # noqa: F401
                                        mask_logits, sample_token,
                                        sample_tokens)
