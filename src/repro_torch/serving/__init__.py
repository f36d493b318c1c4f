"""Paged-KV continuous-batching serving engine.

    from repro_torch.serving import PagedEngine, Request
"""
from repro_torch.serving.engine import DecodeState, PagedEngine, Request, Scheduler
from repro_torch.serving.paging import OutOfPages, PageAllocator, pages_needed

__all__ = [
    "DecodeState", "OutOfPages", "PageAllocator", "PagedEngine", "Request",
    "Scheduler", "pages_needed",
]
