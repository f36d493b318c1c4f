"""Serving engines: paged-KV continuous batching and the dense-cache
lockstep baseline.

    from repro_torch.serving import PagedEngine, Request, naive_generate
"""
from repro_torch.serving.engine import (
    DecodeState,
    PagedEngine,
    Request,
    Scheduler,
    naive_generate,
)
from repro_torch.serving.paging import OutOfPages, PageAllocator, pages_needed

__all__ = [
    "DecodeState", "OutOfPages", "PageAllocator", "PagedEngine", "Request",
    "Scheduler", "naive_generate", "pages_needed",
]
