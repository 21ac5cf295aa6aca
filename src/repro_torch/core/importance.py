"""KV-token importance tracking (paper §6.3.1, eq. 7).

Counterpart of ``repro.core.importance.update_importance``:

    I_i(j) = lam * S_i(j) + (1 - lam) * I_i(j-1)
"""

from __future__ import annotations

import torch

DEFAULT_LAMBDA = 0.6  # paper: "lambda is set as 0.6"


def update_importance(importance: torch.Tensor, step_score: torch.Tensor,
                      lam: float = DEFAULT_LAMBDA) -> torch.Tensor:
    """Eq. (7): EMA update. Shapes broadcast; typically (B, tokens)."""
    return lam * step_score + (1.0 - lam) * importance
