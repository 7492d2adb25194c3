from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged_cache import (BlockAllocator, PagedCacheError,
                                           init_paged_pools)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeEngine", "BlockAllocator", "PagedCacheError",
           "init_paged_pools", "Request", "Scheduler"]
