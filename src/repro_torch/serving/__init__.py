"""KV-centric serving engine (paper §4) of the port: continuous batching
with prefill priority, paged + tiered KV management, PAM decode loop."""

from repro_torch.serving.engine import (Request, RequestState, ServingConfig,
                                        ServingEngine)
from repro_torch.serving.events import ServeEvent
from repro_torch.serving.paged_kv import (BlockAllocator, OutOfBlocks,
                                          PagedKVPool, PrefixTrie)
from repro_torch.serving.pam_manager import (PAMManager, PAMManagerConfig,
                                             PAMState)
from repro_torch.serving.spec import EngineSpec

__all__ = ["BlockAllocator", "EngineSpec", "OutOfBlocks", "PagedKVPool",
           "PAMManager", "PAMManagerConfig", "PAMState", "PrefixTrie",
           "Request", "RequestState", "ServeEvent", "ServingConfig",
           "ServingEngine"]
