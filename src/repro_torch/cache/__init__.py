"""The Ludo-paged KV cache: page tables over the Outback index, and the
two-choice cuckoo baseline."""

from repro_torch.cache.paged import (CuckooPageTable, LudoPageTable,
                                     PageAllocator, page_key)

__all__ = ["CuckooPageTable", "LudoPageTable", "PageAllocator", "page_key"]
