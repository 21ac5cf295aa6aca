"""PAM core: the paper's primary contribution as composable PyTorch
modules (counterpart of ``repro.core``)."""

from repro_torch.core.online_softmax import (AttnPartial,
                                             attention_from_partitions,
                                             empty_partial, finalize,
                                             local_attention, merge_many,
                                             merge_partials,
                                             reference_attention, tree_merge)
from repro_torch.core.importance import (DEFAULT_LAMBDA,
                                         context_locality_hit_rate,
                                         step_score_from_attn_weights,
                                         tier_importance_score, topk_hot_set,
                                         update_importance)
from repro_torch.core.tiers import (COLD, DEFAULT_TIERS, HOT, WARM, TierSpec,
                                    TieredKVState, initial_placement)
from repro_torch.core.scheduling import (ScheduleConfig, ratio_error,
                                         schedule_kv)
from repro_torch.core.pam_attention import (PAMAttentionConfig,
                                            PAMAttentionOutput,
                                            pam_attention_step)

__all__ = [
    "AttnPartial", "attention_from_partitions", "empty_partial", "finalize",
    "local_attention", "merge_many", "merge_partials", "reference_attention",
    "tree_merge", "DEFAULT_LAMBDA", "context_locality_hit_rate",
    "step_score_from_attn_weights", "tier_importance_score", "topk_hot_set",
    "update_importance", "COLD", "DEFAULT_TIERS", "HOT", "WARM", "TierSpec",
    "TieredKVState", "initial_placement", "ScheduleConfig", "ratio_error",
    "schedule_kv", "PAMAttentionConfig", "PAMAttentionOutput",
    "pam_attention_step",
]
