"""The PAM serving engine (paper §4): request pool, continuous batching
with prefill priority, PAM-managed decode loop.

Counterpart of ``repro.serving.engine`` for greedy serving of the dense
family, on a dense or a paged + hot-ring KV layout, and of the Mamba-2
(SSM) family on the dense layout:

* Admission buckets prompt lengths to powers of two; same-bucket
  admissions commit as a group — one batched prefill, then one commit
  that writes every prompt into its pool blocks, re-lays the last
  ``hot_window`` tokens onto the ring, seeds the first tokens and places
  the PAM rows.
* ``_decode_body`` is one decode step of the full PAM pipeline in the
  reference's order (``_fused_decode_body``): participation mask, hot
  clamp and tier split, ``decode_step`` (hot-ring partial through
  ``flash_decode_merged`` ⊕ paged partial through
  ``flash_decode_paged_merged``, or ``flash_decode_merged`` over the
  dense cache), importance EMA, capacity
  cascade and Alg. 2, greedy sampling, on-device EOS.
* The SSM family prefills at each prompt's exact length (its running
  state would absorb padding), commits the conv ring and recurrent state
  into the slot, and feeds the importance EMA recency-only scores (the
  reference's, for an attention-free model). It refuses paged pools and
  the hot ring, as the reference does.
* ``micro_steps = k`` runs ``k`` such steps back to back and reads the
  host buffers once. Time is the host's wall clock; every readback
  synchronises with the device.

Not ported yet: sampling at ``temperature > 0`` and ``top_k`` (ROADMAP
Queue 1 item 1), the prefix cache (item 2) and chunked prefill (item 3),
each raising ``NotImplementedError``; export/import for migration (item
4) and sharding (item 9).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import pam_interface as pam_if
from repro_torch.core import tiers as tiers_mod
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_decode import ring_position_map
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serving import paged_kv as pkv
from repro_torch.serving import pam_manager as pm
from repro_torch.serving.paged_kv import BlockAllocator, OutOfBlocks
from repro_torch.serving.pam_manager import PAMManagerConfig

WAITING, RUNNING, DONE = "waiting", "running", "done"


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0


@dataclasses.dataclass
class RequestState:
    request: Request
    status: str = WAITING
    slot: int = -1
    outputs: list[int] = dataclasses.field(default_factory=list)
    planned: int = 0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: list[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine configuration (the reference's fields).

    ``block_size > 0`` turns on the paged warm/cold pool (``pool_blocks``
    physical blocks, default enough for every slot's full window; needs a
    PAM config and ``max_len`` a block multiple). ``hot_window > 0``
    (paged only) shrinks the dense hot buffer to a ring of that many
    slots. The remaining sampling/prefix/chunking fields exist so configs
    read the same as the reference's; non-default values raise.
    """
    max_batch: int = 4
    max_len: int = 256
    eos_token: int = -1                # -1: run to max_new_tokens
    pam: Optional[PAMManagerConfig] = None
    micro_steps: int = 1               # decode steps per host readback
    block_size: int = 0                # paged-KV block tokens (0 = dense)
    pool_blocks: Optional[int] = None  # physical blocks (None = full)
    hot_window: int = 0                # hot ring slots (0 = max_len)
    temperature: float = 0.0
    top_k: int = 0
    prefix_cache: bool = False
    prefill_chunk: int = 0
    bucket_prefill: bool = True        # pow-2 prompt-length buckets
    sample_seed: int = 0               # per-request sampling key seed


def _unported(scfg: ServingConfig) -> None:
    if scfg.temperature > 0 or scfg.top_k or scfg.sample_seed:
        raise NotImplementedError("sampled decoding (temperature/top_k/"
                                  "sample_seed) is not ported yet: ROADMAP "
                                  "Queue 1 item 1")
    if not scfg.bucket_prefill:
        raise NotImplementedError("exact-length prefill (bucket_prefill="
                                  "False) is not ported yet: ROADMAP Queue 1 "
                                  "item 1")
    if scfg.prefix_cache:
        raise NotImplementedError("the prefix cache is not ported yet: "
                                  "ROADMAP Queue 1 item 2")
    if scfg.prefill_chunk:
        raise NotImplementedError("chunked prefill is not ported yet: "
                                  "ROADMAP Queue 1 item 3")


class ServingEngine:
    """The PAM serving engine. ``submit`` requests, then drive with
    ``step()`` (one admission pass + one decode step) or ``run()`` (to
    completion; ``micro_steps`` decode steps per host readback)."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServingConfig,
                 *, device: str | torch.device | None = None):
        _unported(scfg)
        tf._require_ported(cfg)
        self.device = resolve_device(device)
        self.cfg, self.params, self.scfg = cfg, params, scfg
        B, Smax = scfg.max_batch, scfg.max_len
        self.pam_cfg = scfg.pam
        self.block_size = scfg.block_size
        self.hot_window = scfg.hot_window
        self.allocator: Optional[BlockAllocator] = None
        self.sentinel = 0
        if self.hot_window and not self.block_size:
            raise ValueError("hot_window (ring hot tier) requires the paged "
                             "pool (block_size > 0): evicted tokens live "
                             "only in their mapped blocks")
        if self.hot_window and not 0 < self.hot_window <= Smax:
            raise ValueError(f"hot_window {self.hot_window} must be in "
                             f"(0, max_len={Smax}]")
        dev = self.device
        if self.block_size:
            if scfg.pam is None:
                raise ValueError("paged KV (block_size > 0) requires a PAM "
                                 "config: tier residency decides "
                                 "dense-vs-paged reads")
            if Smax % self.block_size:
                raise ValueError(f"max_len {Smax} not a multiple of "
                                 f"block_size {self.block_size}")
            nb_seq = Smax // self.block_size
            if scfg.pool_blocks is not None and scfg.pool_blocks <= 0:
                raise ValueError(f"pool_blocks must be positive, got "
                                 f"{scfg.pool_blocks}")
            pool_blocks = (scfg.pool_blocks if scfg.pool_blocks is not None
                           else B * nb_seq)
            self.allocator = BlockAllocator(pool_blocks, self.block_size)
            self.sentinel = pool_blocks
            self.cache = tf.init_decode_cache(
                cfg, B, Smax, paged_blocks=pool_blocks,
                block_size=self.block_size, hot_window=self.hot_window,
                device=dev)
            self.pam_state = pm.init_pam_state(B, Smax, num_blocks=nb_seq,
                                               sentinel=pool_blocks,
                                               device=dev)
            self.peak_occupancy = 0.0
            self.blocks_touched_total = 0
            self.blocks_window_total = 0
        else:
            self.cache = tf.init_decode_cache(cfg, B, Smax, device=dev)
            self.pam_state = pm.init_pam_state(B, Smax, device=dev)

        self.requests: dict[int, RequestState] = {}
        self.waiting: collections.deque[int] = collections.deque()
        self.slots: list[Optional[int]] = [None] * B
        self.tokens_dev = torch.zeros(B, dtype=torch.int32, device=dev)
        self.clock = 0.0                 # wall-clock seconds
        self.decode_time = 0.0           # wall-clock seconds in decode
        self.steps = 0
        self.decode_dispatches = 0       # host readbacks of decode steps
        self.decode_device_steps = 0
        self.prefill_dispatches = 0
        self.admit_dispatches = 0
        self.tier_reads_total = np.zeros(3, np.int64)
        self.moved_tokens_total = 0

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> None:
        self.requests[req.id] = RequestState(request=req)
        self.waiting.append(req.id)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _bucket_len(self, s_len: int) -> int:
        """Pow-2 prefill buckets (as the reference's jit-cache cap); the
        exact length for the SSM family, whose state can't absorb
        padding."""
        if self.cfg.family == "ssm":
            return s_len
        b = 1
        while b < s_len:
            b *= 2
        return min(b, self.scfg.max_len)

    def _admit(self) -> int:
        """Prefill-priority admission. In paged mode each admission first
        claims pool blocks for its full window (prompt + budget); an
        exhausted pool leaves the request queued. Same-bucket admissions
        commit as one group. Returns prompt tokens processed."""
        admitted: list[tuple] = []
        free = self._free_slots()
        while self.waiting and free:
            rid = self.waiting.popleft()
            rs = self.requests[rid]
            prompt = np.asarray(rs.request.prompt, np.int32)
            s_len = len(prompt)
            if s_len + rs.request.max_new_tokens > self.scfg.max_len:
                raise ValueError(f"request {rid} exceeds max_len")
            table_row = None
            if self.allocator is not None:
                window = s_len + rs.request.max_new_tokens
                need = self.allocator.blocks_for(window)
                if need > self.allocator.num_blocks:
                    raise ValueError(
                        f"request {rid} needs {need} blocks but the pool "
                        f"holds {self.allocator.num_blocks}")
                try:
                    self.allocator.allocate(rid, window)
                except OutOfBlocks:
                    self.allocator.free(rid)
                    self.waiting.appendleft(rid)
                    break
                table_row = self.allocator.padded_table(
                    rid, self.scfg.max_len // self.block_size,
                    self.sentinel)
                self.peak_occupancy = max(self.peak_occupancy,
                                          self.allocator.occupancy)
            admitted.append((rid, rs, prompt, s_len, free.pop(0), table_row))
        groups: dict[int, list[tuple]] = {}
        for item in admitted:
            groups.setdefault(self._bucket_len(item[3]), []).append(item)
        return sum(self._commit_group(bucket, group)
                   for bucket, group in groups.items())

    def _commit_group(self, bucket: int, group: list[tuple]) -> int:
        """One batched prefill + one commit for a same-bucket group."""
        dev = self.device
        n = len(group)
        padded = np.zeros((n, bucket), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, (_, _, prompt, s_len, *_rest) in enumerate(group):
            padded[i, :s_len] = prompt
            lens[i] = s_len
        lens_t = torch.as_tensor(lens, device=dev)
        exact = self.cfg.family == "ssm"
        logits, sub = tf.prefill(self.cfg, self.params,
                                 torch.as_tensor(padded, device=dev),
                                 self.scfg.max_len,
                                 true_len=None if exact else lens_t)
        self.prefill_dispatches += 1
        slots = [g[4] for g in group]
        rows = None
        if self.allocator is not None:
            rows = torch.as_tensor(np.stack([g[5] for g in group]),
                                   device=dev)
        firsts = self._commit(sub, logits, slots, lens_t, rows)
        self.admit_dispatches += 1
        firsts = firsts.cpu().numpy()
        for i, (rid, rs, _, _, slot, _) in enumerate(group):
            self._finish_admit(rid, rs, slot, int(firsts[i]))
        return int(lens.sum())

    def _commit(self, sub: tf.DecodeCache, logits: torch.Tensor,
                slots: list[int], lengths: torch.Tensor,
                table_rows: Optional[torch.Tensor]) -> torch.Tensor:
        """Install a prefilled group (the reference's admission commit):
        pool write of the full logical rows, ring re-layout of the last
        ``hot_window`` tokens, slot scatter (K/V, or the SSM conv ring and
        state), first tokens, PAM placement. Returns the first tokens
        (n,)."""
        firsts = torch.argmax(logits, dim=-1).to(torch.int32)
        idx = torch.as_tensor(slots, device=self.device)
        if self.cfg.family == "ssm":
            self.cache.conv[:, idx] = sub.conv
            self.cache.state[:, idx] = sub.state
        else:
            self._commit_kv(sub, slots, lengths, table_rows, idx)
        self.cache.lengths[idx] = lengths
        self.tokens_dev[idx] = firsts
        if self.pam_cfg is not None:
            for i, slot in enumerate(slots):
                pm.place_prefill_state(
                    self.pam_cfg, self.pam_state, slot, int(lengths[i]),
                    table_rows[i] if self.block_size else None)
        return firsts

    def _commit_kv(self, sub: tf.DecodeCache, slots: list[int],
                   lengths: torch.Tensor,
                   table_rows: Optional[torch.Tensor],
                   idx: torch.Tensor) -> None:
        """The dense family's K/V part of the commit: pool write, ring
        re-layout, slot scatter."""
        n = len(slots)
        sk, sv = sub.k, sub.v                     # (L, n, Hkv, Smax, dh)
        if self.block_size:
            for i in range(n):
                pkv.write_prefill(self.cache.pk, sk[:, i], table_rows[i],
                                  self.block_size)
                pkv.write_prefill(self.cache.pv, sv[:, i], table_rows[i],
                                  self.block_size)
            if self.hot_window:
                ring_pos, valid = ring_position_map(lengths,
                                                    self.hot_window)
                sk = torch.stack([pam_if.logical_to_ring(
                    sk[:, i], ring_pos[i], valid[i]) for i in range(n)], 1)
                sv = torch.stack([pam_if.logical_to_ring(
                    sv[:, i], ring_pos[i], valid[i]) for i in range(n)], 1)
        self.cache.k[:, idx] = sk
        self.cache.v[:, idx] = sv

    def _finish_admit(self, rid: int, rs: RequestState, slot: int,
                      tok: int) -> None:
        """Record the first token and mark the request RUNNING — or DONE
        at once when the prefill's token already ends it."""
        eos = self.scfg.eos_token
        rs.status, rs.slot = RUNNING, slot
        rs.outputs.append(tok)
        rs.planned = 1
        self.slots[slot] = rid
        if (eos >= 0 and tok == eos) or rs.request.max_new_tokens <= 1:
            rs.status = DONE
            rs.first_token_time = self.clock
            rs.token_times = [self.clock]
            rs.finish_time = self.clock
            self.slots[slot] = None
            if self.allocator is not None:
                self.allocator.free(rid)

    # ------------------------------------------------------------ decoding
    def _decode_body(self, tokens: torch.Tensor, active: torch.Tensor):
        """ONE decode step of the full PAM pipeline, in the reference's
        order: participation -> tier split -> decode -> observe ->
        sample. Updates ``self.cache``/``self.pam_state``; returns
        (tokens, active, per-step stats as device tensors)."""
        cfg, pcfg, dev = self.cfg, self.pam_cfg, self.device
        smax, bs = self.scfg.max_len, self.block_size
        cache, st = self.cache, self.pam_state
        B = active.shape[0]
        lengths = cache.lengths + active.to(torch.int32)
        pos_all = torch.arange(smax, device=dev)[None, :]
        if pcfg is not None:
            participate = pm.participation_mask(pcfg, st.importance, lengths)
        else:
            participate = pos_all < lengths[:, None]
        paged_append = None
        blocks = torch.zeros(2, dtype=torch.int32, device=dev)
        if bs:
            nb = smax // bs
            if self.hot_window:
                # ring demotion: tokens that slid out of the window are
                # re-tagged so the split reads them from the pool
                st = st._replace(tier=tiers_mod.clamp_hot_to_window(
                    st.tier, lengths, self.hot_window))
            hot_m, pgd_m, block_live = pm.paged_participation_split(
                participate, st.tier, lengths, bs, self.hot_window)
            bt_eff = torch.where(block_live, st.block_table,
                                 torch.full_like(st.block_table,
                                                 self.sentinel))
            d_fn = pm.make_paged_decode_attn(hot_m, pgd_m, bt_eff,
                                             block_live)
            # append coordinates of the new token; inactive rows write the
            # sentinel trash page
            pos = cache.lengths
            lb = torch.clamp(pos // bs, 0, nb - 1).long()
            dst_block = torch.where(
                active, st.block_table[torch.arange(B, device=dev), lb],
                torch.full_like(pos, self.sentinel))
            paged_append = (dst_block.to(torch.int32),
                            (pos % bs).to(torch.int32))
            window = pkv.token_block_mask(pos_all < lengths[:, None], bs)
            act = active[:, None]
            blocks = torch.stack([torch.sum(block_live & act),
                                  torch.sum(window & act)]).to(torch.int32)
        else:
            d_fn = pm.make_masked_decode_attn(participate)
        old_lens = cache.lengths
        logits, cache, scores = tf.decode_step(
            cfg, self.params, tokens, cache, decode_attn_fn=d_fn,
            paged_append=paged_append)
        cache = cache._replace(
            lengths=torch.where(active, cache.lengths, old_lens))
        if pcfg is not None:
            read_mask = participate & active[:, None]
            tier_reads = pm.tier_read_counts_of(st.tier, read_mask)
            hit = pm.hit_rate_of(st.last_hot, participate)
            if scores is None:     # attention-free: recency-only scores
                scores = (pos_all == (cache.lengths - 1)[:, None]).float()
            before = st.moved_tokens
            st = pm.observe_update(pcfg, st, scores, cache.lengths,
                                   participate)
            moved = st.moved_tokens - before
        else:
            tier_reads = torch.zeros(3, dtype=torch.int32, device=dev)
            hit = torch.zeros((), device=dev)
            moved = torch.zeros((), dtype=torch.int32, device=dev)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)   # greedy
        tokens = torch.where(active, nxt, tokens)
        if self.scfg.eos_token >= 0:
            active = active & (tokens != self.scfg.eos_token)
        self.cache, self.pam_state = cache, st
        return tokens, active, (tokens, tier_reads, hit, moved,
                                cache.lengths, blocks)

    def _decode(self, k: int, active_np: np.ndarray) -> dict[str, np.ndarray]:
        """``k`` decode steps back to back, one host readback."""
        t0 = time.perf_counter()
        active = torch.as_tensor(active_np, device=self.device)
        tokens = self.tokens_dev
        per_step = []
        for _ in range(k):
            tokens, active, bufs = self._decode_body(tokens, active)
            per_step.append(bufs)
        self.tokens_dev = tokens
        names = ("tokens", "tier_reads", "hit_rate", "moved", "lengths",
                 "blocks")
        out = {name: torch.stack([b[i] for b in per_step]).cpu().numpy()
               for i, name in enumerate(names)}
        self.decode_time += time.perf_counter() - t0
        self.decode_dispatches += 1
        self.decode_device_steps += k
        self.tier_reads_total += out["tier_reads"].sum(axis=0)
        self.moved_tokens_total += int(out["moved"].sum())
        if self.block_size:
            self.blocks_touched_total += int(out["blocks"][:, 0].sum())
            self.blocks_window_total += int(out["blocks"][:, 1].sum())
        return out

    def _running(self) -> np.ndarray:
        return np.array([s is not None and self.requests[s].status == RUNNING
                         for s in self.slots])

    def step(self) -> dict[str, Any]:
        """One engine iteration: admission (prefill) + one decode step
        for all running sequences. Returns step stats."""
        t0 = time.perf_counter()
        prefill_tokens = self._admit()
        active_np = self._running()
        stats: dict[str, Any] = {"prefill_tokens": prefill_tokens,
                                 "active": int(active_np.sum())}
        if active_np.any():
            out = self._decode(1, active_np)
            stats["tier_reads"] = out["tier_reads"][0]
            stats["moved_tokens"] = int(out["moved"][0])
            stats["hit_rate"] = float(out["hit_rate"][0])
            self._emit_tokens(out["tokens"][0], active_np)
        dt = time.perf_counter() - t0
        self.clock += dt
        stats["step_time_s"] = dt
        self._stamp_times()
        self.steps += 1
        return stats

    def _emit_tokens(self, nxt: np.ndarray, active: np.ndarray) -> None:
        for slot, rid in enumerate(self.slots):
            if rid is None or not active[slot]:
                continue
            rs = self.requests[rid]
            tok = int(nxt[slot])
            rs.outputs.append(tok)
            rs.planned = len(rs.outputs)
            if (len(rs.outputs) >= rs.request.max_new_tokens
                    or tok == self.scfg.eos_token):
                rs.status = DONE
                self.slots[slot] = None
                if self.allocator is not None:
                    self.allocator.free(rid)

    def _stamp_times(self) -> None:
        for rs in self.requests.values():
            if rs.status in (RUNNING, DONE):
                if rs.first_token_time is None:
                    rs.first_token_time = self.clock
                if len(rs.token_times) < len(rs.outputs):
                    rs.token_times += [self.clock] * (
                        len(rs.outputs) - len(rs.token_times))
                if rs.status == DONE and rs.finish_time is None:
                    rs.finish_time = self.clock

    def run(self, max_steps: int = 10_000) -> dict[str, Any]:
        """Run until all submitted requests finish. Returns summary."""
        if self.scfg.micro_steps > 1:
            return self._run_micro(max_steps)
        for _ in range(max_steps):
            if not self.waiting and all(s is None for s in self.slots):
                break
            self.step()
        return self.summary()

    def _run_micro(self, max_steps: int) -> dict[str, Any]:
        """Micro-step loop: each iteration admits, then runs the largest
        power-of-two number of decode steps (up to ``micro_steps``) that
        no running request overshoots, with one host readback. A slot
        that samples EOS mid-run is frozen on the device."""
        micro = self.scfg.micro_steps
        eos = self.scfg.eos_token
        while self.steps < max_steps:
            if not self.waiting and all(s is None for s in self.slots):
                break
            t0 = time.perf_counter()
            prefill_tokens = self._admit()
            pairs = [(i, rid) for i, rid in enumerate(self.slots)
                     if rid is not None
                     and self.requests[rid].status == RUNNING]
            if not pairs:
                self.clock += time.perf_counter() - t0
                if prefill_tokens:
                    continue   # the admission wave finished at prefill
                break
            remaining = min(self.requests[rid].request.max_new_tokens
                            - self.requests[rid].planned
                            for _, rid in pairs)
            k = 1
            while k * 2 <= min(remaining, micro):
                k *= 2
            active_np = np.zeros((self.scfg.max_batch,), bool)
            for slot, _ in pairs:
                active_np[slot] = True
            out = self._decode(k, active_np)
            self.steps += k
            dt = (time.perf_counter() - t0) / k
            for j in range(k):
                self.clock += dt
                for slot, rid in pairs:
                    rs = self.requests[rid]
                    if rs.status == DONE:
                        continue             # froze at EOS mid-run
                    tok = int(out["tokens"][j, slot])
                    rs.outputs.append(tok)
                    rs.planned = len(rs.outputs)
                    if rs.first_token_time is None:
                        rs.first_token_time = self.clock
                    while len(rs.token_times) < len(rs.outputs):
                        rs.token_times.append(self.clock)
                    if (len(rs.outputs) >= rs.request.max_new_tokens
                            or (eos >= 0 and tok == eos)):
                        rs.status = DONE
                        rs.finish_time = self.clock
                        self.slots[slot] = None
                        if self.allocator is not None:
                            self.allocator.free(rid)
        return self.summary()

    # ------------------------------------------------------------ metrics
    def summary(self) -> dict[str, Any]:
        """Run metrics: throughput, TPOT percentiles, step counts, tier
        reads and Alg. 2 moves; in paged mode also pages touched vs the
        dense window per step and pool occupancy. Times are wall-clock
        seconds on the host, each ending in a device readback."""
        done = [r for r in self.requests.values() if r.status == DONE]
        total_tokens = sum(len(r.outputs) for r in done)
        decode_tokens = sum(len(r.outputs) - 1 for r in done)
        tpots = []
        for r in done:
            if len(r.token_times) > 1:
                tpots.extend(np.diff(r.token_times).tolist())
        out = {
            "device": str(self.device),
            "finished": len(done),
            "total_tokens": total_tokens,
            "wall_time_s": self.clock,
            "throughput_tok_s": total_tokens / max(self.clock, 1e-9),
            "decode_time_s": self.decode_time,
            "decode_tok_s": decode_tokens / max(self.decode_time, 1e-9),
            "p50_tpot_s": float(np.percentile(tpots, 50)) if tpots else 0.0,
            "p99_tpot_s": float(np.percentile(tpots, 99)) if tpots else 0.0,
            "steps": self.steps,
            "decode_dispatches": self.decode_dispatches,
            "decode_device_steps": self.decode_device_steps,
            "prefill_dispatches": self.prefill_dispatches,
            "admit_dispatches": self.admit_dispatches,
            "tier_reads": [int(x) for x in self.tier_reads_total],
            "moved_tokens": self.moved_tokens_total,
        }
        if self.block_size:
            n = max(self.decode_device_steps, 1)
            out["blocks_touched_per_step"] = self.blocks_touched_total / n
            out["blocks_window_per_step"] = self.blocks_window_total / n
            out["pool_occupancy_peak"] = self.peak_occupancy
            out["pool_occupancy_now"] = self.allocator.occupancy
            out["hot_window"] = self.hot_window or self.scfg.max_len
            out["hot_bytes_per_slot"] = int(
                (self.cache.k.nbytes + self.cache.v.nbytes)
                // self.scfg.max_batch)
        return out

