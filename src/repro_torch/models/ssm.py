"""Mamba-2 (SSD) block: fused projection, causal conv, selective scan.

Counterpart of ``repro.models.ssm``. Training runs the chunked SSD form:
``ssm_forward(use_kernel=True)`` through the ``ssd_scan`` kernels
(``repro_torch.kernels.ssd_scan``: forward and backward on the card, the
plain versions on the CPU), else ``ssd_chunked``, the plain chunk-parallel
form. Prefill runs ``ssd_chunked`` with the final state, as the reference
does, and decode keeps an O(1) recurrent state per layer: the conv ring
buffer and the (H, N, P) fp32 SSM state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import ssd_chunked_states
from repro_torch.models.config import SSMConfig
from repro_torch.models.layers import init_linear, rms_norm


class SSMParams(NamedTuple):
    in_proj: torch.Tensor      # (d, 2*di + 2*G*N + H)
    conv_w: torch.Tensor       # (ck, conv_dim)   conv_dim = di + 2*G*N
    conv_b: torch.Tensor       # (conv_dim,)
    dt_bias: torch.Tensor      # (H,) fp32
    a_log: torch.Tensor        # (H,) fp32, A = -exp(a_log)
    d_skip: torch.Tensor       # (H,) fp32
    out_norm: torch.Tensor     # (di,)
    out_proj: torch.Tensor     # (di, d)


def _dims(d: int, cfg: SSMConfig) -> tuple[int, int, int]:
    di = cfg.d_inner(d)
    H = cfg.n_heads(d)
    conv_dim = di + 2 * cfg.n_groups * cfg.d_state
    return di, H, conv_dim


def init_ssm(gen: torch.Generator, d: int, cfg: SSMConfig,
             dtype: torch.dtype, device: torch.device) -> SSMParams:
    """Random weights at the reference's init scales; ``dt_bias``,
    ``a_log`` and ``d_skip`` stay fp32 in a bf16 model, as there."""
    di, H, conv_dim = _dims(d, cfg)
    proj_out = 2 * di + 2 * cfg.n_groups * cfg.d_state + H
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.conv_kernel, conv_dim), generator=gen, **f32)
    return SSMParams(
        in_proj=init_linear(gen, d, proj_out, dtype, device),
        conv_w=(conv_w * 0.1).to(dtype),
        conv_b=torch.zeros((conv_dim,), dtype=dtype, device=device),
        dt_bias=torch.zeros((H,), **f32),
        a_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        d_skip=torch.ones((H,), **f32),
        out_norm=torch.ones((di,), dtype=dtype, device=device),
        out_proj=init_linear(gen, di, d, dtype, device),
    )


def _split_proj(z_xbc_dt: torch.Tensor, d: int, cfg: SSMConfig):
    di, H, conv_dim = _dims(d, cfg)
    return (z_xbc_dt[..., :di], z_xbc_dt[..., di:di + conv_dim],
            z_xbc_dt[..., di + conv_dim:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU. xbc: (B, L, C); w: (ck, C)."""
    ck, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, ck - 1, 0))
    out = sum(pad[:, i:i + L] * w[i][None, None, :] for i in range(ck))
    return F.silu(out + b[None, None, :])


def ssd_chunked(x, dt, a, b, c, d_skip, chunk: int,
                return_final_state: bool = False):
    """Chunk-parallel SSD in plain tensor code, the same math as the
    kernels (counterpart of ``ssd_chunked_jnp``). Shapes as
    ``kernels.ssd_scan.ssd_scan``. With ``return_final_state`` also
    returns h_L (B, H, N, P) fp32, which seeds the decode cache."""
    y, _, h = ssd_chunked_states(x, dt, a, b, c, d_skip, chunk)
    return (y, h) if return_final_state else y


def _project(p: SSMParams, x: torch.Tensor, cfg: SSMConfig):
    """The shared front of ``ssm_forward`` / ``ssm_prefill``: z, the raw
    conv input, the scan operands (x, b and c as views of the conv
    output), dt and a."""
    B, L, d = x.shape
    di, H, conv_dim = _dims(d, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xbc_raw, dt_raw = _split_proj(x @ p.in_proj, d, cfg)
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    xs = xbc[..., :di].reshape(B, L, H, P)
    bmat = xbc[..., di:di + G * N].reshape(B, L, G, N)
    cmat = xbc[..., di + G * N:].reshape(B, L, G, N)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    return z, xbc_raw, (xs, dt, a, bmat, cmat, p.d_skip)


def _finish(p: SSMParams, y: torch.Tensor, z: torch.Tensor,
            rms_eps: float) -> torch.Tensor:
    B, L = y.shape[:2]
    y = y.reshape(B, L, -1) * F.silu(z)
    return rms_norm(y, p.out_norm, rms_eps) @ p.out_proj


def ssm_forward(p: SSMParams, x: torch.Tensor, cfg: SSMConfig, *,
                rms_eps: float, use_kernel: bool = False) -> torch.Tensor:
    """Train/prefill pass. x: (B, L, d) -> (B, L, d)."""
    z, _, scan = _project(p, x, cfg)
    if use_kernel:
        y = kops.ssd(*scan, chunk=cfg.chunk)
    else:
        y = ssd_chunked(*scan, cfg.chunk)
    return _finish(p, y, z, rms_eps)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, ck-1, conv_dim) last conv inputs
    state: torch.Tensor   # (B, H, N, P) fp32


def ssm_prefill(p: SSMParams, x: torch.Tensor, cfg: SSMConfig, *,
                rms_eps: float) -> tuple[torch.Tensor, SSMCache]:
    """Full-sequence pass that also returns the decode cache (conv tail +
    final SSM state) so serving can switch to recurrent decode."""
    z, xbc_raw, scan = _project(p, x, cfg)
    y, h_final = ssd_chunked(*scan, cfg.chunk, return_final_state=True)
    out = _finish(p, y, z, rms_eps)
    # conv ring buffer = last (ck-1) PRE-activation conv inputs
    ck, L = cfg.conv_kernel, x.shape[1]
    tail = F.pad(xbc_raw, (0, 0, max(ck - 1 - L, 0), 0))
    return out, SSMCache(conv=tail[:, tail.shape[1] - (ck - 1):],
                         state=h_final)


def init_ssm_cache(batch: int, d: int, cfg: SSMConfig, dtype: torch.dtype,
                   device: torch.device) -> SSMCache:
    di, H, conv_dim = _dims(d, cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, H, cfg.d_state, cfg.head_dim),
                          dtype=torch.float32, device=device))


def ssm_decode(p: SSMParams, x: torch.Tensor, cache: SSMCache,
               cfg: SSMConfig, *, rms_eps: float
               ) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrent step. x: (B, d) -> (B, d)."""
    B, d = x.shape
    di, H, conv_dim = _dims(d, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xbc, dt_raw = _split_proj(x @ p.in_proj, d, cfg)

    window = torch.cat([cache.conv, xbc[:, None, :]], dim=1)  # (B, ck, C)
    conv_out = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    xbc_t = F.silu(conv_out)
    new_conv = window[:, 1:]

    xs = xbc_t[..., :di].reshape(B, H, P)
    rep = H // G
    bh = xbc_t[..., di:di + G * N].reshape(B, G, N).repeat_interleave(
        rep, dim=1)                                           # (B, H, N)
    ch = xbc_t[..., di + G * N:].reshape(B, G, N).repeat_interleave(
        rep, dim=1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)               # (B, H)
    a = -torch.exp(p.a_log)

    decay = torch.exp(dt * a)[..., None, None]                # (B, H, 1, 1)
    upd = (dt[..., None, None] * bh[..., :, None]
           * xs.float()[..., None, :])                        # (B, H, N, P)
    state = decay * cache.state + upd
    y = torch.einsum("bhn,bhnp->bhp", ch.float(), state)
    y = y + p.d_skip[None, :, None] * xs.float()
    y = y.reshape(B, di).to(x.dtype) * F.silu(z)
    out = rms_norm(y, p.out_norm, rms_eps) @ p.out_proj
    return out, SSMCache(conv=new_conv, state=state)
