"""KV-centric serving engine (paper §4) of the port: continuous batching
with prefill priority, paged + tiered KV management, PAM decode loop."""

from repro_torch.serving.engine import (Request, RequestState, ServingConfig,
                                        ServingEngine)
from repro_torch.serving.paged_kv import (BlockAllocator, OutOfBlocks,
                                          PrefixTrie)
from repro_torch.serving.pam_manager import PAMManagerConfig, PAMState

__all__ = ["BlockAllocator", "OutOfBlocks", "PAMManagerConfig", "PAMState",
           "PrefixTrie", "Request", "RequestState", "ServingConfig",
           "ServingEngine"]
