"""Routed top-k MoE with shared experts (Qwen3-MoE / DeepSeek-V2 style).

Counterpart of ``repro.models.moe``: the same sort-based capacity
dispatch in dense shapes. Tokens are ranked per expert in token order,
gathered into an (E, cap, d) batch, run through one batched product per
projection and combined by gate weight; an assignment past its expert's
capacity is dropped. Every shape follows from (T, K, E, cap), so the
function reads no tensor value on the host (a decode step's CUDA graph
can hold it). The expert products are plain ``torch.bmm``, as the
reference leaves its ``einsum``s to XLA; no TPU kernel is involved. A
sharded engine's weights reach them through
``tensor_parallel.expert_ffn`` and ``linear`` (each site its slice of
the expert ffn dim); the router stays replicated.

Capacity couples the rows of a call: a token's output depends on every
other token routed with it, so callers hand in exactly the reference's
shapes (padded prefill buckets, every decode slot). The reference's
``moe_pin`` perf flag (expert-parallel sharding constraints on the
dispatch intermediates) is accepted and changes no number, as there:
this family trains on one site until its 2-D expert split is ported
(ROADMAP Queue 1 item 10), so there is nothing to pin.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import init_linear


class MoEParams(NamedTuple):
    router: torch.Tensor                  # (d, E) fp32
    w_gate: torch.Tensor                  # (E, d, f)
    w_up: torch.Tensor                    # (E, d, f)
    w_down: torch.Tensor                  # (E, f, d)
    shared_gate: Optional[torch.Tensor]   # (d, n_shared*f) fused shared
    shared_up: Optional[torch.Tensor]
    shared_down: Optional[torch.Tensor]


class Routing(NamedTuple):
    """The dispatch tables of one call (the reference's intermediates)."""
    expert_ids: torch.Tensor   # (T, K) int64, descending prob, ties low id
    keep: torch.Tensor         # (T*K,) bool: inside its expert's capacity
    slot: torch.Tensor         # (T*K,) int64 in [0, E*cap], E*cap dropped
    tok_table: torch.Tensor    # (E*cap,) int64 token of each slot (0 empty)
    gate_table: torch.Tensor   # (E*cap,) fp32 gate of each slot (0 empty)
    aux: torch.Tensor          # () fp32 Switch load-balance loss
    cap: int


def _experts(gen: torch.Generator, shape: tuple, scale: float,
             out: torch.Tensor) -> None:
    """Fill ``out`` (E, a, b) with N(0, scale^2) one expert at a time, so
    the fp32 draw never holds more than one expert's matrix."""
    for e in range(shape[0]):
        w = torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                        device=out.device)
        out[e] = w * scale


def fill_moe(gen: torch.Generator, d: int, cfg: MoEConfig,
             p: MoEParams) -> None:
    """Draw one layer's weights into the preallocated tensors of ``p``
    (views of the stacked leaves, or fresh tensors) at the reference's
    scales: router N(0, 1/d) in fp32, gate / up N(0, 1/d), down
    N(0, 1/f), shared experts N(0, 1/fan_in)."""
    E, f = cfg.num_experts, cfg.d_expert
    dev = p.w_gate.device
    p.router.copy_(init_linear(gen, d, E, torch.float32, dev))
    _experts(gen, (E, d, f), 1.0 / math.sqrt(d), p.w_gate)
    _experts(gen, (E, d, f), 1.0 / math.sqrt(d), p.w_up)
    _experts(gen, (E, f, d), 1.0 / math.sqrt(f), p.w_down)
    if cfg.num_shared:
        sh = cfg.num_shared * f
        dtype = p.w_gate.dtype
        p.shared_gate.copy_(init_linear(gen, d, sh, dtype, dev))
        p.shared_up.copy_(init_linear(gen, d, sh, dtype, dev))
        p.shared_down.copy_(init_linear(gen, sh, d, dtype, dev))


def moe_shapes(d: int, cfg: MoEConfig) -> dict[str, tuple]:
    """Shape of each ``MoEParams`` field; zero-size shared leaves when
    the config has no shared expert (the reference's uniform pytree)."""
    E, f, sh = cfg.num_experts, cfg.d_expert, cfg.num_shared * cfg.d_expert
    return dict(router=(d, E), w_gate=(E, d, f), w_up=(E, d, f),
                w_down=(E, f, d),
                shared_gate=(d, sh) if sh else (0,),
                shared_up=(d, sh) if sh else (0,),
                shared_down=(sh, d) if sh else (0,))


def init_moe(gen: torch.Generator, d: int, cfg: MoEConfig,
             dtype: torch.dtype, device: torch.device) -> MoEParams:
    """One layer's MoE weights (router fp32, the rest ``dtype``); no
    shared expert gives ``None`` shared fields, as the reference's."""
    fields = {n: torch.empty(s, dtype=torch.float32 if n == "router"
                             else dtype, device=device)
              for n, s in moe_shapes(d, cfg).items()}
    p = MoEParams(**fields)
    fill_moe(gen, d, cfg, p)
    if not cfg.num_shared:
        p = p._replace(shared_gate=None, shared_up=None, shared_down=None)
    return p


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                 torch.Tensor]:
    """``lax.top_k``: the k largest in descending order, ties to the lower
    index (a stable descending sort; ``torch.topk`` fixes no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(p: MoEParams, xf: torch.Tensor, cfg: MoEConfig) -> Routing:
    """The reference's routing and capacity tables for tokens xf (T, d):
    fp32 router softmax, top-k gates renormalised by max(sum, 1e-9), the
    Switch aux loss, each assignment's position inside its expert in
    token order, ``cap = ceil(T*K/E*capacity_factor)`` from shapes, and
    the overflow sentinel at E*cap."""
    T = xf.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    dev = xf.device
    probs = torch.softmax(xf.float() @ p.router, dim=-1)         # (T, E)
    gate_vals, expert_ids = _top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=dev)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum((expert_ids[..., None] == experts).float(),
                              dim=1), dim=0)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    cap = int(math.ceil(T * K / E * cfg.capacity_factor))
    flat_expert = expert_ids.reshape(T * K)
    onehot = (flat_expert[:, None] == experts).to(torch.int32)   # (TK, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos, 1, flat_expert[:, None])[:, 0]       # (TK,)
    keep = pos < cap
    slot = torch.where(keep, flat_expert * cap + pos,
                       torch.full_like(pos, E * cap))
    flat_token = torch.arange(T * K, device=dev) // K
    # kept slots are distinct; only the dropped ones share the sentinel,
    # which is cut off
    tok_table = torch.zeros(E * cap + 1, dtype=torch.int64, device=dev)
    tok_table = tok_table.scatter(0, slot, flat_token)[:-1]
    gate_table = torch.zeros(E * cap + 1, dtype=torch.float32, device=dev)
    flat_gate = gate_vals.reshape(T * K)
    gate_table = gate_table.scatter(0, slot, torch.where(
        keep, flat_gate, torch.zeros_like(flat_gate)))
    return Routing(expert_ids, keep, slot, tok_table, gate_table[:-1], aux,
                   cap)


def combine(contrib: torch.Tensor, slot: torch.Tensor, K: int
            ) -> torch.Tensor:
    """y (T, d) from the per-slot contributions (E*cap, d): each token's
    kept slots summed in ascending slot order, starting from zeros in
    ``contrib.dtype``.

    The reference scatter-adds every slot into zeros (``y.at[tok].add``);
    XLA's CPU scatter applies updates in slot order, so each token's sum
    runs over its kept slots in ascending order (expert-major). Empty
    slots point at token 0 with gate 0 and add zeros, which change no sum
    while every contribution is finite, so this gather-and-sum gives the
    same values without atomics (whose order on the card varies from run
    to run)."""
    T = slot.shape[0] // K
    slots = torch.sort(slot.reshape(T, K), dim=1).values  # dropped last
    padded = torch.cat([contrib, contrib.new_zeros(1, contrib.shape[1])])
    y = contrib.new_zeros(T, contrib.shape[1])
    for j in range(K):
        y = y + padded[slots[:, j]]
    return y


def moe_forward(p: MoEParams, x: torch.Tensor, cfg: MoEConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x.dtype, aux_loss () fp32)."""
    B, S, d = x.shape
    E = cfg.num_experts
    xf = x.reshape(B * S, d)
    r = route(p, xf, cfg)
    xe = xf[r.tok_table].reshape(E, r.cap, d)                    # (E, C, d)
    ye = tp.expert_ffn(xe, p.w_gate, p.w_up, p.w_down)           # (E, C, d)
    gates = r.gate_table.reshape(E, r.cap).to(ye.dtype)
    y = combine((ye * gates[..., None]).reshape(E * r.cap, d), r.slot,
                cfg.top_k)
    if p.shared_gate is not None:
        sg = tp.linear(xf, p.shared_gate)
        su = tp.linear(xf, p.shared_up)
        y = y + tp.linear(F.silu(sg) * su, p.shared_down)
    return y.reshape(B, S, d).to(x.dtype), r.aux


def moe_forward_dense_oracle(p: MoEParams, x: torch.Tensor, cfg: MoEConfig
                             ) -> torch.Tensor:
    """No-capacity-drop oracle (every token reaches its experts), the
    reference's test bound on the dispatch path's drop error."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    gate_vals, expert_ids = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    y = torch.zeros_like(xf)
    for e in range(cfg.num_experts):
        w = torch.sum(torch.where(expert_ids == e, gate_vals,
                                  torch.zeros_like(gate_vals)), dim=-1)
        g = xf @ p.w_gate[e]
        u = xf @ p.w_up[e]
        ye = (F.silu(g) * u) @ p.w_down[e]
        y = y + w[:, None].to(ye.dtype) * ye
    if p.shared_gate is not None:
        sg = xf @ p.shared_gate
        su = xf @ p.shared_up
        y = y + (F.silu(sg) * su) @ p.shared_down
    return y.reshape(B, S, d).to(x.dtype)
