"""Intra-device KV mapping (paper §6.1).

Counterpart of ``repro.core.mapping``. Within one PIM device, KV tokens
are interleaved across B parallel bank groups and the device's latency
is the max over groups (T_intra = max_bg T_bg), so the mapper balances
the activation frequency (tracked over a 10-step window) across groups.
On the GPU a "bank group" is a share of the decode kernel's grid: the
balanced assignment orders the hot set's gather so each share carries
an equal load of frequently activated tokens (``bank_interleave`` in
``core.pam_interface`` lays it out).
"""

from __future__ import annotations

import numpy as np
import torch


def greedy_balanced_assign(freq: torch.Tensor, valid: torch.Tensor,
                           num_groups: int) -> torch.Tensor:
    """Greedy longest-processing-time assignment of tokens to groups.

    Tokens are taken in decreasing frequency (ties in index order,
    invalid tokens last); each goes to the currently lightest group, the
    first of equal ones, and adds its frequency to that group's fp32
    load. Returns (tokens,) int32 group ids on freq's device.

    The reference runs the greedy walk as a ``lax.scan`` over the
    tokens. It is sequential (each choice reads the loads the previous
    ones left), so it runs here on the host over float32 numpy loads,
    one argmin over ``num_groups`` loads a token, instead of as a few
    kernel launches a token on the device.
    """
    f = torch.where(valid, freq.float(), torch.full_like(freq.float(), -1.0))
    order = torch.argsort(-f, stable=True)
    w = np.maximum(f[order].cpu().numpy(), np.float32(0.0))
    loads = np.zeros(num_groups, np.float32)
    groups = np.empty(w.shape[0], np.int32)
    for i, wi in enumerate(w):
        g = int(loads.argmin())
        loads[g] += wi
        groups[i] = g
    out = torch.empty_like(order, dtype=torch.int32)
    out[order] = torch.from_numpy(groups).to(order.device)
    return out


def group_loads(freq: torch.Tensor, assign: torch.Tensor,
                valid: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(num_groups,) total activation frequency per group (T_bg proxy)."""
    w = torch.where(valid, freq.float(), torch.zeros_like(freq.float()))
    return torch.zeros(num_groups, dtype=torch.float32,
                       device=w.device).index_add(0, assign.long(), w)


def imbalance(freq: torch.Tensor, assign: torch.Tensor, valid: torch.Tensor,
              num_groups: int) -> torch.Tensor:
    """max / mean group load; 1.0 is perfect balance (T_intra metric)."""
    loads = group_loads(freq, assign, valid, num_groups)
    return torch.amax(loads) / torch.clamp(torch.mean(loads), min=1e-9)


def update_activation_freq(freq_window: torch.Tensor,
                           activated: torch.Tensor, step,
                           window: int = 10) -> torch.Tensor:
    """Ring-buffer activation tracking over the paper's 10-step window.

    freq_window: (window, tokens) uint8 history; activated: (tokens,)
    bool this step; step: an int or a 0-dim integer tensor. Returns the
    updated window (the input is not modified).
    """
    out = freq_window.clone()
    out[step % window] = activated.to(freq_window.dtype)
    return out


def windowed_frequency(freq_window: torch.Tensor) -> torch.Tensor:
    """(tokens,) int32 activation count over the window."""
    return torch.sum(freq_window, dim=0, dtype=torch.int32)
