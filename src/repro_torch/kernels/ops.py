"""Dispatch for the models: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel (which raises on what it cannot take).  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref


def paged_attention(q, k_pages, v_pages, page_table, valid_len, *,
                    scale=None, softcap=None, window=None, k_scale=None,
                    v_scale=None):
    kw = dict(scale=scale, softcap=softcap, window=window, k_scale=k_scale,
              v_scale=v_scale)
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_pages, v_pages, page_table, valid_len,
                                   **kw)
    if q.device.type == "cuda":
        return _pa.paged_attention(q, k_pages, v_pages, page_table, valid_len,
                                   **kw)
    raise ValueError(f"paged_attention has no path for device {q.device}")
