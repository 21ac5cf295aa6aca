"""The PAM serving engine (paper §4): request pool, continuous batching
with prefill priority, PAM-managed decode loop.

Counterpart of ``repro.serving.engine`` for the dense and the GQA
mixture-of-experts families (whose K/V cache is the dense family's), on
a dense or a paged + hot-ring KV layout, and of the Mamba-2 (SSM) family
on the dense layout. The MoE's capacity couples the rows routed
together, so prefill buckets, chunk slices and every decode slot (idle
ones included) reach the model in the reference's shapes:

* Admission buckets prompt lengths to powers of two (or takes them
  exactly, ``bucket_prefill=False``); same-bucket admissions commit as a
  group — one batched prefill, then one commit that writes every prompt
  into its pool blocks, re-lays the last ``hot_window`` tokens onto the
  ring, samples the first tokens and places the PAM rows.
* ``prefix_cache`` makes the pool refcounted and indexes committed
  prompts in a ``PrefixTrie``: an admission adopts its longest cached
  prefix's blocks, pins a partially-covered tail block for
  copy-on-write, prefills only the novel suffix over the gathered prefix
  (``tf.prefill_suffix``) and commits it in the reference's order (CoW,
  suffix scatter, hot-row rebuild, first-token sample, PAM placement).
* ``prefill_chunk`` admits a prompt whose novel part exceeds the budget
  in bounded slices, one per engine step, interleaved with decode; the
  slot is claimed but ``PREFILLING`` (out of the decode mask) until the
  final slice's suffix commit samples its first token.
* ``_decode_body_`` is one decode step of the full PAM pipeline in the
  reference's order (``_fused_decode_body``), in place over the
  engine's own tensors: participation mask, hot
  clamp and tier split, ``decode_step`` (hot-ring partial through
  ``flash_decode_merged`` ⊕ paged partial through
  ``flash_decode_paged_merged``, or ``flash_decode_merged`` over the
  dense cache), importance EMA, capacity cascade and Alg. 2, sampling
  (``sampling.sample_tokens``: greedy argmax at temperature 0, else
  temperature / top-k with per-request keys ``fold_in(fold_in(
  PRNGKey(seed), rid), position)`` on the reference's own threefry
  bits), on-device EOS.
* The SSM family prefills at each prompt's exact length (its running
  state would absorb padding), commits the conv ring and recurrent state
  into the slot, and feeds the importance EMA recency-only scores (the
  reference's, for an attention-free model). It refuses paged pools and
  the hot ring, as the reference does.
* The MLA mixture-of-experts family (``deepseek-v2-lite-16b``) serves on
  the dense layout only, as in the reference: its cache is one latent
  and one shared rope key a token (``ckv`` / ``krope``), which the
  commit scatters into the slot; each decode step attends over the
  participating latent tokens (``pam_manager.make_masked_latent_attn``,
  plain tensor code as the reference's einsums) and PAM's importance,
  tiers and Alg. 2 run on latent tokens. Pools (hence the ring, the
  prefix cache and chunked prefill) and migration refuse it.
* The vlm family (``internvl2-1b``) serves as a text-only dense model,
  as the reference's engine does (it takes no patches): every dense
  path, paged + ring included. ``prefix_cache`` refuses it, and chunked
  admission fails at its first slice (``tf.prefill_suffix`` refuses
  vlm), as in the reference. The audio family (an encoder, no decode
  step) raises at construction.
* The hybrid family (``zamba2-7b``: groups of Mamba-2 layers, each
  followed by one shared attention block with a KV cache site of its
  own) serves on the dense layout only, as in the reference: it
  prefills at exact length (as the SSM family), commits the conv ring
  and state and every site's K/V rows into the slot, and each decode
  step attends the participating tokens at every site
  (``flash_decode_merged`` n_groups times); PAM's importance, tiers and
  Alg. 2 run on the sites' mean mass. Pools and migration refuse it.
* A decode dispatch runs ``k`` such steps (``micro_steps = k``: the
  largest power of two no running request overshoots) and reads one
  ``StepBufs`` back, which synchronises with the device. On CUDA the
  dispatch is a CUDA graph, the counterpart of the reference's donated
  ``_fused_decode_fn``: keyed by ``(k, Alg. 2 phase)`` (the position of
  its first step modulo ``schedule_interval``, which fixes where Alg. 2
  runs inside it), run eagerly at its first dispatch and captured right
  after, replayed at every later one. Anything that writes engine state
  between dispatches (admission, chunk slices, import, EOS teardown)
  writes in place, so the graphs' addresses stay valid. On the CPU the
  same in-place body runs eagerly.
* Time: with a ``latency_model`` (``repro_torch.perfmodel``) each step
  advances ``clock`` by the model's seconds for the step's stats dict
  (the reference's keys: ``prefill_tokens``, ``active``, ``tier_reads``,
  ``moved_tokens``, ``hit_rate``, the paged blocks, ``batch_lengths``):
  the simulated PIM hardware's time, which makes a cluster
  deterministic. Without one, ``clock`` is the host's wall clock.
  ``wall_time`` is always the host's.
* Cluster hooks: ``export_request`` gathers a running request's KV into
  the portable logical layout (hot rows from the ring through
  ``ring_to_logical``, warm/cold rows through the block table) and frees
  its slot and blocks without finishing it; ``import_request`` installs
  such a snapshot into a free slot and freshly allocated blocks;
  ``load_signal`` / ``can_accept`` / ``serviceable`` /
  ``slot_importance_mass`` feed the router and the balancer
  (``repro_torch.cluster``). Metrics and traces bind to
  ``repro_torch.obs`` as the reference's do.

* Sharding (``EngineSpec.shard = g > 1`` on the paged + ring PAM path,
  as ``EngineSpec.validate`` admits; the dense, vlm and GQA MoE families,
  whose caches the paged pools take): one engine
  over ``g`` sites (``distributed.pam_shard.decode_sites``, every site
  on the engine's device). Each site holds its slice of the weights
  that ``distributed.sharding.param_specs`` splits (views:
  ``distributed.tensor_parallel``), of the ring's slots and of the
  pool's blocks; the cache stays one tensor a field, so admission,
  chunks, copy-on-write, export and import write global coordinates as
  unsharded. Each decode step attends per site and merges exactly across
  the sites (``pam_shard.make_sharded_paged_decode_attn``); the dispatch,
  its graph and its readback are the unsharded engine's.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import (Any, Callable, Iterable, Iterator, NamedTuple,
                    Optional)

import numpy as np
import torch

from repro_torch.core import pam_interface as pam_if
from repro_torch.core import tiers as tiers_mod
from repro_torch.device import resolve_device
from repro_torch.distributed import pam_shard as psh
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.frontend.chunking import ChunkPlan, validate_budget
from repro_torch.kernels.flash_decode import ring_position_map
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import paged_kv as pkv
from repro_torch.serving import pam_manager as pm
from repro_torch.serving import sampling
from repro_torch.serving.paged_kv import (BlockAllocator, OutOfBlocks,
                                          PrefixTrie)
from repro_torch.serving.pam_manager import PAMManagerConfig

WAITING, PREFILLING, RUNNING, DONE = (
    "waiting", "prefilling", "running", "done")


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0


def check_prompt_ids(prompt, vocab: int) -> None:
    """Reject a prompt holding a token id outside ``[0, vocab)``.

    The embedding lookup indexes with the ids: on the CPU a bad id
    raises mid-step, and on CUDA it fails a device-side assert that
    leaves the process's context (shared by every engine of a fleet)
    unusable. The reference's gather clamps such an id and serves a
    different prompt; the port refuses the request at submission."""
    ids = np.asarray(prompt)
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= vocab):
        bad = ids[(ids < 0) | (ids >= vocab)]
        raise ValueError(f"prompt token ids must lie in [0, {vocab}); "
                         f"got {bad[:8].tolist()}")


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

    ``block_size > 0`` turns on the paged warm/cold pool: ``pool_blocks``
    physical blocks of ``block_size`` tokens (default: enough for every
    slot's full window; set it lower for capacity backpressure). Needs a
    PAM config (tier residency decides dense-vs-paged reads) and
    ``max_len`` a block multiple. ``hot_window > 0`` (paged only) shrinks
    the dense hot buffer to a ring of that many slots (position ``p`` at
    slot ``p % hot_window``); every appended token is mirrored into its
    pool block, so streams equal the full-window engine's.

    ``temperature`` 0 is the greedy argmax; above 0 the first token and
    every decode token are sampled from the temperature softmax,
    restricted to the ``top_k`` largest logits (0: all), drawing the
    token at position ``p`` of request ``rid`` from
    ``fold_in(fold_in(PRNGKey(sample_seed), rid), p)``.
    ``bucket_prefill`` pads prompts to power-of-two lengths; False
    prefills each at its exact length.

    ``prefix_cache`` shares prompt prefixes over the paged pool: an
    admission maps its longest cached prefix onto existing (refcounted)
    blocks, prefills only the novel suffix, and copy-on-writes a
    partially-filled shared tail block before its first write. Needs
    ``block_size > 0``. ``prefill_chunk`` (a power of two, 0 = off)
    admits a prompt whose novel part exceeds that many tokens in slices
    of at most ``prefill_chunk`` tokens, one per engine step,
    interleaved with decode; streams equal single-shot admission's.
    Needs ``block_size > 0``.
    """
    max_batch: int = 4
    max_len: int = 256
    eos_token: int = -1                # -1: run to max_new_tokens
    pam: Optional[PAMManagerConfig] = None
    micro_steps: int = 1               # decode steps per host readback
    block_size: int = 0                # paged-KV block tokens (0 = dense)
    pool_blocks: Optional[int] = None  # physical blocks (None = full)
    hot_window: int = 0                # hot ring slots (0 = max_len)
    temperature: float = 0.0           # 0 = greedy argmax
    top_k: int = 0                     # 0 = full softmax when sampling
    prefix_cache: bool = False         # trie-indexed prefix sharing
    prefill_chunk: int = 0             # chunked prefill budget (0 = off)
    bucket_prefill: bool = True        # pow-2 prompt-length buckets
    sample_seed: int = 0               # per-request sampling key seed


class StepBufs(NamedTuple):
    """Per-dispatch device->host readback of ``k`` decode steps, the
    reference's ``StepBufs`` (same names and dtypes): the only thing the
    host copies back from a decode dispatch."""
    tokens: torch.Tensor      # (k, B) int32 tokens after each step
    tier_reads: torch.Tensor  # (k, 3) int32 participating tokens per tier
    hit_rate: torch.Tensor    # (k,)   fp32 context-locality hit rate
    moved: torch.Tensor       # (k,)   int32 Alg. 2 migrations this step
    lengths: torch.Tensor     # (k, B) int32 post-step cache lengths
    blocks: torch.Tensor      # (k, 2) int32 (paged pages touched, dense
    #                                        window pages), paged mode


def _step_bufs(flat: torch.Tensor, k: int, B: int) -> StepBufs:
    """``StepBufs`` as views of one flat int32 buffer of ``k (2B + 7)``
    words (``hit_rate`` reinterprets its words as fp32)."""
    t, r, h, m, n, b = torch.split(flat, (k * B, k * 3, k, k, k * B, k * 2))
    return StepBufs(tokens=t.view(k, B), tier_reads=r.view(k, 3),
                    hit_rate=h.view(torch.float32), moved=m,
                    lengths=n.view(k, B), blocks=b.view(k, 2))


@dataclasses.dataclass
class _Readback:
    """A ``k``-step ``StepBufs`` on the engine's device (zeroed: the
    fields a mode does not write read 0) and its host copy (pinned on
    CUDA): one device-to-host copy a dispatch."""
    flat: torch.Tensor
    host: torch.Tensor
    bufs: StepBufs
    host_bufs: StepBufs

    @classmethod
    def make(cls, k: int, B: int, device: torch.device) -> "_Readback":
        n = k * (2 * B + 7)
        flat = torch.zeros(n, dtype=torch.int32, device=device)
        host = torch.zeros(n, dtype=torch.int32,
                           pin_memory=device.type == "cuda")
        return cls(flat, host, _step_bufs(flat, k, B),
                   _step_bufs(host, k, B))

    def read(self) -> dict[str, np.ndarray]:
        """Copy the device buffer back (waits for the dispatch) and
        return each field as its own numpy array."""
        self.host.copy_(self.flat)
        return {f: getattr(self.host_bufs, f).numpy().copy()
                for f in StepBufs._fields}


class ServingEngine:
    """The PAM serving engine. Build with ``EngineSpec(...).build(params,
    latency_model=..., device=...)`` or ``ServingEngine(cfg, params,
    scfg, device=...)``; ``submit`` requests, then drive with ``step()``
    (one admission pass + one decode step) or ``run()`` (to completion;
    ``micro_steps`` decode steps per host readback)."""

    def __init__(self, spec, params: dict, scfg: Optional[ServingConfig]
                 = None, *,
                 latency_model: Optional[Callable[[dict], float]] = None,
                 name: Optional[str] = None,
                 device: str | torch.device | None = None):
        from repro_torch.serving.spec import EngineSpec
        if isinstance(spec, EngineSpec):
            if scfg is not None or name is not None:
                raise TypeError("ServingEngine(EngineSpec, params, ...): "
                                "the serving config and name live on the "
                                "spec")
        else:
            if scfg is None:
                raise TypeError("ServingEngine(cfg, params, scfg) needs a "
                                "ServingConfig")
            spec = EngineSpec(model=spec, serving=scfg,
                              name=name if name is not None else "dev0")
        cfg, scfg = spec.model, spec.serving
        tf._require_ported(cfg)
        if not cfg.has_decode:    # the reference asserts it
            raise AssertionError(f"{cfg.name} is encoder-only")
        self.device = resolve_device(device)
        self.spec, self.name, self.shard = spec, spec.name, spec.shard
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.latency_model = latency_model
        self.clock = 0.0                 # modeled (or wall) seconds
        self.wall_time = 0.0             # host wall-clock seconds
        self.busy_time = 0.0             # clock seconds with active > 0
        self.last_step_time = 0.0        # clock charge of the last
        self.last_step_stats = None      # decode-only step, its stats
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
        self.sites = self.cache_specs = None
        if self.shard > 1:
            # checked after the cache, as the reference: a family the
            # pools refuse raises there first
            spec.validate()
            # the sites, each holding its slice of the weights (views) and
            # reading its slice of the ring and the pool
            self.sites = psh.decode_sites(self.shard, dev)
            self.params = tp.shard_params(
                params, shd.param_specs(cfg, self.shard, params), self.shard)
            self.cache_specs = shd.serving_cache_shardings(self.cache,
                                                           self.shard)

        self.trie: Optional[PrefixTrie] = None
        if scfg.prefix_cache:
            if not self.block_size:
                raise ValueError("prefix_cache requires the paged pool "
                                 "(block_size > 0): shared prefixes live "
                                 "in refcounted blocks")
            if cfg.family == "vlm":
                raise ValueError("prefix_cache keys on token ids; the "
                                 "vlm patch prefix has none")
            self.trie = PrefixTrie(self.block_size, self.allocator)
            self.prefix_hits = 0            # admissions with matched > 0
            self.cached_prefix_tokens = 0   # prefill compute skipped
            self.novel_prefill_tokens = 0   # prefill compute performed
            self.cow_copies = 0             # tail blocks duplicated
        self.chunk = scfg.prefill_chunk
        self._chunking: dict[int, ChunkPlan] = {}  # rid -> in-flight plan
        if self.chunk:
            validate_budget(self.chunk)
            if not self.block_size:
                raise ValueError("prefill_chunk (chunked prefill) "
                                 "requires the paged pool (block_size > "
                                 "0): slices append KV through the pool "
                                 "commit path")
            self.chunked_admissions = 0
            self.chunk_slices = 0             # slice dispatches
            self.max_chunk_slice = 0          # largest slice prefilled

        self.requests: dict[int, RequestState] = {}
        self.waiting: collections.deque[int] = collections.deque()
        self.slots: list[Optional[int]] = [None] * B
        self.tokens_dev = torch.zeros(B, dtype=torch.int32, device=dev)
        # per-slot request ids, the sampling keys' operand
        self.rids_dev = torch.zeros(B, dtype=torch.int64, device=dev)
        # the decode mask, filled from the host copy before a dispatch
        self._active = torch.zeros(B, dtype=torch.bool, device=dev)
        self._active_host = torch.zeros(B, dtype=torch.bool,
                                        pin_memory=dev.type == "cuda")
        self._readbacks: dict[int, _Readback] = {}
        # CUDA graphs by dispatch key (k, Alg. 2 phase), in one memory
        # pool the engine's graphs share
        self._graphs: dict[tuple[int, int], torch.cuda.CUDAGraph] = {}
        self._graph_pool = None
        self._graph_stream = None
        self.capture_seconds = 0.0
        # micro-steps whose body ran on the host, op by op or recorded
        # into a graph (every decode step on the CPU); the decode
        # wrappers are called n_layers times for each (a hybrid model's
        # n_groups attention sites)
        self.decode_body_steps = 0
        self._dispatch = (self._dispatch_graph if dev.type == "cuda"
                          else self._dispatch_eager)
        self.decode_time = 0.0           # wall-clock seconds in decode
        self.steps = 0
        self.decode_dispatches = 0       # host readbacks of decode steps
        self.decode_device_steps = 0
        self.prefill_dispatches = 0
        self.admit_dispatches = 0
        self.migrations_in = 0
        self.migrations_out = 0
        self.tier_reads_total = np.zeros(3, np.int64)
        self.moved_tokens_total = 0
        self._bind_obs()

    # -------------------------------------------------------- telemetry
    def _bind_obs(self) -> None:
        """Bind this engine's labeled instruments against the registry
        installed now (``repro_torch.obs.metrics.install`` before
        construction); every series carries a ``device`` label so a
        fleet shares one registry. With the default (disabled) registry
        each update is one attribute check."""
        reg = obs_metrics.get_registry()
        self._mreg = reg
        c, g, h = reg.counter, reg.gauge, reg.histogram
        dl = ("device",)
        d = {"device": self.name}
        self._m_steps = c(
            "pam_engine_steps_total",
            "engine iterations (admission pass + decode step)",
            dl).labels(**d)
        self._m_decode_disp = c(
            "pam_engine_decode_dispatches_total",
            "fused decode device dispatches", dl).labels(**d)
        self._m_device_steps = c(
            "pam_engine_decode_device_steps_total",
            "decode steps executed on device (k per micro dispatch)",
            dl).labels(**d)
        self._m_prefill_disp = c(
            "pam_engine_prefill_dispatches_total",
            "prefill / suffix-prefill / chunk-slice dispatches",
            dl).labels(**d)
        self._m_admit_disp = c(
            "pam_engine_admit_dispatches_total",
            "donated admission-commit dispatches", dl).labels(**d)
        self._m_prefill_tokens = c(
            "pam_engine_prefill_tokens_total",
            "prompt tokens prefilled (novel only under prefix cache)",
            dl).labels(**d)
        self._m_decode_tokens = c(
            "pam_engine_decode_tokens_total",
            "decode tokens emitted to requests", dl).labels(**d)
        self._m_finished = c(
            "pam_engine_finished_total",
            "requests finished (EOS or budget)", dl).labels(**d)
        self._m_step_h = h(
            "pam_engine_step_seconds",
            "per-step latency (modeled or wall-clock)", dl).labels(**d)
        self._m_active = g(
            "pam_engine_active_slots",
            "slots decoding in the last step", dl).labels(**d)
        self._m_queue = g(
            "pam_engine_queue_depth",
            "requests waiting for admission", dl).labels(**d)
        self._m_pool = g(
            "pam_engine_pool_occupancy",
            "paged-pool block occupancy fraction", dl).labels(**d)
        tier_c = c("pam_engine_tier_read_tokens_total",
                   "participating tokens read, by KV tier",
                   ("device", "tier"))
        self._m_tier = tuple(tier_c.labels(device=self.name, tier=t)
                             for t in ("hot", "warm", "cold"))
        self._m_moved = c(
            "pam_engine_moved_tokens_total",
            "Alg. 2 tier migrations (tokens)", dl).labels(**d)
        self._m_blocks_touched = c(
            "pam_engine_blocks_touched_total",
            "pool pages touched by paged reads", dl).labels(**d)
        self._m_blocks_window = c(
            "pam_engine_blocks_window_total",
            "dense-window pages a full read would touch",
            dl).labels(**d)
        self._m_prefix_hits = c(
            "pam_engine_prefix_hits_total",
            "admissions that matched a cached prefix", dl).labels(**d)
        self._m_cached_prefix_tokens = c(
            "pam_engine_cached_prefix_tokens_total",
            "prefill compute skipped via prefix sharing (tokens)",
            dl).labels(**d)
        self._m_cow = c(
            "pam_engine_cow_copies_total",
            "copy-on-write tail-block duplications", dl).labels(**d)
        self._m_chunk_adm = c(
            "pam_engine_chunked_admissions_total",
            "admissions that went through chunked prefill",
            dl).labels(**d)
        self._m_chunk_slices = c(
            "pam_engine_chunk_slices_total",
            "chunked-prefill slice dispatches", dl).labels(**d)
        mig = c("pam_engine_migrations_total",
                "requests migrated (suspend/resume rides the same "
                "path)", ("device", "direction"))
        self._m_mig_in = mig.labels(device=self.name, direction="in")
        self._m_mig_out = mig.labels(device=self.name, direction="out")

    def _observe_step(self, stats: dict[str, Any], dt: float) -> None:
        """Per-step telemetry: one ``enabled`` check when metrics are off
        and one ``None`` check when tracing is off."""
        if self._mreg.enabled:
            self._m_steps.inc()
            self._m_step_h.observe(dt)
            if stats["prefill_tokens"]:
                self._m_prefill_tokens.inc(stats["prefill_tokens"])
            self._m_active.set(stats["active"])
            self._m_queue.set(len(self.waiting))
            for m, v in zip(self._m_tier, stats["tier_reads"]):
                if v:
                    m.inc(int(v))
            if stats["moved_tokens"]:
                self._m_moved.inc(stats["moved_tokens"])
            if "blocks_touched" in stats:
                self._m_blocks_touched.inc(stats["blocks_touched"])
                self._m_blocks_window.inc(stats["blocks_window"])
            if self.allocator is not None:
                self._m_pool.set(self.allocator.occupancy)
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.slice(self.name, "step", self.clock - dt, dt,
                     active=stats["active"],
                     prefill_tokens=stats["prefill_tokens"])
            tr.counter(self.name, "occupancy", self.clock,
                       active=stats["active"],
                       queue=len(self.waiting),
                       pool=(self.allocator.occupancy
                             if self.allocator is not None else 0.0))

    def _trace_finish(self, rs: RequestState) -> None:
        """Count a finished request and close its lifecycle track."""
        self._m_finished.inc()
        tr = obs_trace.COLLECTOR
        if tr is not None:
            rid = rs.request.id
            tr.mark(rid, "finish", self.clock, tokens=len(rs.outputs))
            phase = tr.open_phase(rid)
            if phase is not None:
                tr.end(rid, phase, self.clock)

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> None:
        """Queue a request; a prompt id outside ``[0, cfg.vocab)`` raises
        ``ValueError`` (``check_prompt_ids``)."""
        check_prompt_ids(req.prompt, self.cfg.vocab)
        self.requests[req.id] = RequestState(request=req)
        self.waiting.append(req.id)
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.begin(req.id, "queued", self.clock,
                     device=self.name, prompt=len(req.prompt))

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _bucket_len(self, s_len: int) -> int:
        """Pow-2 prefill buckets (as the reference's jit-cache cap); the
        exact length without ``bucket_prefill`` and for the SSM and
        hybrid families, whose state can't absorb padding."""
        if (not self.scfg.bucket_prefill
                or self.cfg.family in ("ssm", "hybrid")):
            return s_len
        b = 1
        while b < s_len:
            b *= 2
        return min(b, self.scfg.max_len)

    def _sample(self, logits: torch.Tensor, rids: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        """Tokens under the engine's sampling policy; ``positions`` are
        the sampled tokens' absolute positions."""
        return sampling.sample_tokens(
            logits, self.scfg.sample_seed, rids, positions,
            self.scfg.temperature, self.scfg.top_k)

    def _reserve_fresh(self, need: int) -> None:
        """Best-effort headroom for ``need`` fresh blocks: under pool
        pressure, evict LRU trie-only cached prefixes until the free list
        covers the ask. If live requests pin everything, the caller's
        ``allocate`` raises ``OutOfBlocks`` (admission backpressure)."""
        if self.trie is not None and need > self.allocator.free_blocks:
            self.trie.evict(need - self.allocator.free_blocks)

    def _admit(self) -> int:
        """Prefill-priority admission. Returns prompt tokens processed:
        with the prefix cache, only each admission's novel suffix. In
        paged mode each admission first claims pool blocks for its full
        window (prompt + budget); an exhausted pool leaves the request
        queued.

        With ``prefix_cache`` the prompt is split against the trie into a
        cached prefix, whose blocks are ADOPTED (refcount +1), and a
        novel suffix; a partially-covered tail block is pinned for
        copy-on-write. A novel part above ``prefill_chunk`` admits in
        slices (``PREFILLING``). The rest group by novel-length bucket:
        a group with a prefix hit commits through the suffix path (plain
        members ride along), the others through one full prefill."""
        # items: (rid, rs, prompt, s_len, slot, table_row, start,
        # cow_src); start = cache-resident prefix tokens, cow_src = the
        # shared tail block pinned for copy-on-write (-1 = none)
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
            matched, cow_src = 0, -1
            if self.allocator is not None:
                window = s_len + rs.request.max_new_tokens
                need = self.allocator.blocks_for(window)
                if need > self.allocator.num_blocks:
                    raise ValueError(
                        f"request {rid} needs {need} blocks but the pool "
                        f"holds {self.allocator.num_blocks}")
                shared: list[int] = []
                if self.trie is not None:
                    # >= 1 token is always recomputed (the suffix prefill
                    # produces the first token's logits)
                    matched, ids = self.trie.lookup(prompt)
                    matched = min(matched, s_len - 1)
                    nfull = matched // self.block_size
                    shared = ids[:nfull]
                    if matched % self.block_size:
                        cow_src = ids[nfull]
                try:
                    if shared:
                        # adopt first: the incref shields the matched
                        # blocks from the eviction below
                        self.allocator.adopt(rid, shared)
                    if cow_src >= 0:
                        self.allocator.incref(cow_src)   # CoW-source pin
                    self._reserve_fresh(need - len(shared))
                    self.allocator.allocate(rid, window)
                except OutOfBlocks:
                    # roll back the adoption and the pin, then wait
                    if cow_src >= 0:
                        self.allocator.decref(cow_src)
                    self.allocator.free(rid)
                    self.waiting.appendleft(rid)
                    break
                table_row = self.allocator.padded_table(
                    rid, self.scfg.max_len // self.block_size,
                    self.sentinel)
                self.peak_occupancy = max(self.peak_occupancy,
                                          self.allocator.occupancy)
            slot = free.pop(0)
            if matched > 0:
                self.prefix_hits += 1
                self.cached_prefix_tokens += matched
                self._m_prefix_hits.inc()
                self._m_cached_prefix_tokens.inc(matched)
            if self.chunk and s_len - matched > self.chunk:
                # chunked admission: the slot and the full block window
                # are claimed now, the prompt fills one slice per step;
                # the slot is not decode-eligible until the final slice
                rs.status, rs.slot = PREFILLING, slot
                self.slots[slot] = rid
                self._chunking[rid] = ChunkPlan(
                    rid=rid, slot=slot, start=matched, total=s_len,
                    budget=self.chunk, cow_src=cow_src)
                self.chunked_admissions += 1
                self._m_chunk_adm.inc()
                tr = obs_trace.COLLECTOR
                if tr is not None:
                    tr.begin(rid, "prefill", self.clock,
                             device=self.name, novel=s_len - matched)
                continue
            admitted.append((rid, rs, prompt, s_len, slot, table_row,
                             matched, cow_src))
        groups: dict[int, list[tuple]] = {}
        for item in admitted:
            groups.setdefault(self._bucket_len(item[3] - item[6]),
                              []).append(item)
        return sum(
            self._commit_suffix_group(bucket, group)
            if any(it[6] > 0 for it in group)
            else self._commit_group(bucket, group)
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
        exact = self.cfg.family in ("ssm", "hybrid")
        logits, sub = tf.prefill(self.cfg, self.params,
                                 torch.as_tensor(padded, device=dev),
                                 self.scfg.max_len,
                                 true_len=None if exact else lens_t)
        self.prefill_dispatches += 1
        self._m_prefill_disp.inc()
        slots = [g[4] for g in group]
        rids = torch.as_tensor([g[0] for g in group], dtype=torch.int64,
                               device=dev)
        rows = None
        if self.allocator is not None:
            rows = torch.as_tensor(np.stack([g[5] for g in group]),
                                   device=dev)
        firsts = self._commit(sub, logits, slots, lens, rids, rows)
        self.admit_dispatches += 1
        self._m_admit_disp.inc()
        if self.trie is not None:
            # publish after the commit lands the prompts in the pool and
            # before an EOS teardown frees their tables
            self.novel_prefill_tokens += int(lens.sum())
            for rid, _, prompt, *_rest in group:
                self.trie.insert(prompt, self.allocator.table(rid))
        firsts = firsts.cpu().numpy()
        for i, (rid, rs, _, _, slot, *_rest) in enumerate(group):
            self._finish_admit(rid, rs, slot, int(firsts[i]))
        return int(lens.sum())

    def _commit(self, sub: tf.DecodeCache, logits: torch.Tensor,
                slots: list[int], lens: np.ndarray, rids: torch.Tensor,
                table_rows: Optional[torch.Tensor]) -> torch.Tensor:
        """Install a prefilled group (the reference's admission commit):
        pool write of the full logical rows, ring re-layout of the last
        ``hot_window`` tokens, slot scatter (K/V, the MLA latent and rope
        key, the SSM conv ring and state, or the hybrid's conv ring,
        state and every site's K/V), first tokens sampled at
        position ``lens[i]``, PAM placement. Returns the first tokens
        (n,)."""
        idx = torch.as_tensor(slots, device=self.device)
        lengths = torch.as_tensor(lens, device=self.device)
        firsts = self._sample(logits, rids, lengths)
        if self.cfg.family == "ssm":
            self.cache.conv[:, idx] = sub.conv
            self.cache.state[:, idx] = sub.state
        elif tf._mla_moe(self.cfg):
            self.cache.ckv[:, idx] = sub.ckv
            self.cache.krope[:, idx] = sub.krope
        elif tf._hybrid(self.cfg):    # no pool and no ring to fill
            self.cache.conv[:, idx] = sub.conv
            self.cache.state[:, idx] = sub.state
            self._install_hot_rows(sub.k, sub.v, lengths, idx)
        else:
            self._commit_kv(sub, slots, lengths, table_rows, idx)
        self.cache.lengths[idx] = lengths
        self.tokens_dev[idx] = firsts
        self.rids_dev[idx] = rids
        if self.pam_cfg is not None:
            for i, slot in enumerate(slots):
                pm.place_prefill_state(
                    self.pam_cfg, self.pam_state, slot, int(lens[i]),
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
        self._install_hot_rows(sk, sv, lengths, idx)

    def _install_hot_rows(self, sk: torch.Tensor, sv: torch.Tensor,
                          lengths: torch.Tensor, idx: torch.Tensor) -> None:
        """Write logical (L, n, Hkv, Smax, dh) rows into the dense cache
        slots ``idx``, re-based onto ring coordinates with a hot ring."""
        if self.hot_window:
            ring_pos, valid = ring_position_map(lengths, self.hot_window)
            n = sk.shape[1]
            sk = torch.stack([pam_if.logical_to_ring(
                sk[:, i], ring_pos[i], valid[i]) for i in range(n)], 1)
            sv = torch.stack([pam_if.logical_to_ring(
                sv[:, i], ring_pos[i], valid[i]) for i in range(n)], 1)
        self.cache.k[:, idx] = sk
        self.cache.v[:, idx] = sv

    def _suffix_coords(self, row: np.ndarray, start: int, t: int,
                       width: int) -> tuple[np.ndarray, np.ndarray]:
        """Token-granular pool scatter coordinates for ``width`` suffix
        positions from absolute position ``start`` (``t`` of them real);
        padding past ``t`` routes to the sentinel trash block."""
        bs = self.block_size
        nb = self.scfg.max_len // bs
        pos = start + np.arange(width)
        bids = np.where(np.arange(width) < t,
                        row[np.minimum(pos // bs, nb - 1)],
                        self.sentinel).astype(np.int32)
        sids = (pos % bs).astype(np.int32)
        return bids, sids

    def _commit_suffix_group(self, bucket: int,
                             group: list[tuple]) -> int:
        """Prefill + commit a same-bucket group through the SUFFIX path:
        one batched suffix prefill (each row's cached prefix gathered
        from the pool through its table; all zeros for plain riders)
        and one commit (``_commit_suffix``). Also commits the FINAL
        slice of a chunked admission (``start`` = the slice's begin).
        Returns the novel tokens prefilled."""
        dev = self.device
        bs = self.block_size
        nb = self.scfg.max_len // bs
        n = len(group)
        padded = np.zeros((n, bucket), np.int32)
        suf_lens = np.zeros((n,), np.int32)
        starts = np.zeros((n,), np.int32)
        full_lens = np.zeros((n,), np.int32)
        rows = np.zeros((n, nb), np.int32)
        read_rows = np.zeros((n, nb), np.int32)
        bids = np.zeros((n, bucket), np.int32)
        sids = np.zeros((n, bucket), np.int32)
        cow_srcs = np.full((n,), self.sentinel, np.int32)
        cow_dsts = np.full((n,), self.sentinel, np.int32)
        cow_pins: list[int] = []
        for i, (rid, _, prompt, s_len, _, _, start, cow_src) \
                in enumerate(group):
            t = s_len - start
            padded[i, :t] = prompt[start:]
            suf_lens[i], starts[i], full_lens[i] = t, start, s_len
            row = self.allocator.padded_table(rid, nb, self.sentinel)
            rows[i] = row
            # READ view of the table for the prefix gather: a CoW row's
            # tail positions live in the publisher's cow_src until the
            # commit duplicates it, and the prefill runs first
            read_rows[i] = row
            if cow_src >= 0:
                nfull = start // bs
                read_rows[i, nfull] = cow_src
                cow_srcs[i] = cow_src
                cow_dsts[i] = row[nfull]
                cow_pins.append(cow_src)
            bids[i], sids[i] = self._suffix_coords(row, start, t, bucket)
        starts_t = torch.as_tensor(starts, device=dev)
        read_t = torch.as_tensor(read_rows, device=dev)
        logits, suf_k, suf_v = tf.prefill_suffix(
            self.cfg, self.params, torch.as_tensor(padded, device=dev),
            pam_if.gather_prefix_logical(self.cache.pk, read_t, starts_t),
            pam_if.gather_prefix_logical(self.cache.pv, read_t, starts_t),
            starts_t, true_len=torch.as_tensor(suf_lens, device=dev))
        self.prefill_dispatches += 1
        self._m_prefill_disp.inc()
        slots = [g[4] for g in group]
        rids = torch.as_tensor([g[0] for g in group], dtype=torch.int64,
                               device=dev)
        firsts = self._commit_suffix(
            suf_k, suf_v, logits, slots, full_lens, rids,
            torch.as_tensor(rows, device=dev),
            torch.as_tensor(bids, device=dev),
            torch.as_tensor(sids, device=dev), cow_srcs, cow_dsts)
        self.admit_dispatches += 1
        self._m_admit_disp.inc()
        for src in cow_pins:
            # the copy reading cow_src is enqueued ahead of any later use
            # of the block on the stream: release the pin
            self.allocator.decref(src)
            self.cow_copies += 1
            self._m_cow.inc()
        if self.trie is not None:
            self.novel_prefill_tokens += int(suf_lens.sum())
            for rid, _, prompt, *_rest in group:
                self.trie.insert(prompt, self.allocator.table(rid))
        firsts = firsts.cpu().numpy()
        for i, (rid, rs, _, _, slot, *_rest) in enumerate(group):
            self._finish_admit(rid, rs, slot, int(firsts[i]))
        return int(suf_lens.sum())

    def _commit_suffix(self, suf_k: torch.Tensor, suf_v: torch.Tensor,
                       logits: torch.Tensor, slots: list[int],
                       lens: np.ndarray, rids: torch.Tensor,
                       table_rows: torch.Tensor, bids: torch.Tensor,
                       sids: torch.Tensor, cow_srcs: np.ndarray,
                       cow_dsts: np.ndarray) -> torch.Tensor:
        """Commit a suffix-prefilled group, in the reference's order:

        1. copy-on-write each row's shared tail block ``cow_srcs[i]``
           into its fresh ``cow_dsts[i]`` (the sentinel onto itself for
           rows with nothing to copy);
        2. scatter each row's suffix K/V token by token into its blocks
           (padding to the sentinel);
        3. rebuild each slot's dense hot row from the full logical
           sequence gathered back through its table, on the ring;
        4. sample each first token at absolute position ``lens[i]``;
        5. place the PAM rows and block tables.

        Returns the first tokens (n,)."""
        pk, pv = self.cache.pk, self.cache.pv
        for src, dst in zip(cow_srcs.tolist(), cow_dsts.tolist()):
            pkv.copy_block(pk, src, dst)
            pkv.copy_block(pv, src, dst)
        bi, si = bids.long(), sids.long()
        pk[:, bi, si] = torch.movedim(suf_k, 2, 3)     # (L, n, S, Hkv, dh)
        pv[:, bi, si] = torch.movedim(suf_v, 2, 3)
        lengths = torch.as_tensor(lens, device=self.device)
        idx = torch.as_tensor(slots, device=self.device)
        # the full logical rows (shared prefix + fresh suffix), zeroed
        # past each length: (L, n, Hkv, Smax, dh)
        self._install_hot_rows(
            pam_if.gather_prefix_logical(pk, table_rows, lengths),
            pam_if.gather_prefix_logical(pv, table_rows, lengths),
            lengths, idx)
        self.cache.lengths[idx] = lengths
        firsts = self._sample(logits, rids, lengths)
        self.tokens_dev[idx] = firsts
        self.rids_dev[idx] = rids
        if self.pam_cfg is not None:
            for i, slot in enumerate(slots):
                pm.place_prefill_state(self.pam_cfg, self.pam_state, slot,
                                       int(lens[i]), table_rows[i])
        return firsts

    # ------------------------------------------------- chunked prefill
    def _advance_chunks(self) -> int:
        """Advance every in-flight chunked admission by ONE slice:
        intermediate slices scatter their KV into the pool
        (``_chunk_fill``); the final slice commits through the suffix
        path, which samples the first token, and the request turns
        RUNNING. Returns the prefill tokens processed: at most
        ``prefill_chunk`` per in-flight admission per step."""
        total = 0
        for rid in list(self._chunking):
            plan = self._chunking[rid]
            begin, t = plan.next_slice()
            rs = self.requests[rid]
            prompt = np.asarray(rs.request.prompt, np.int32)
            if begin + t >= plan.total:
                del self._chunking[rid]
                # cow_src is -1 here: a chunked plan has >= 2 slices, so
                # the first (CoW-carrying) slice was an intermediate one
                self._commit_suffix_group(
                    self._bucket_len(t),
                    [(rid, rs, prompt, plan.total, plan.slot, None,
                      begin, -1)])
            else:
                self._chunk_fill(plan, prompt, begin, t)
                plan.done += t
            plan.slices += 1
            self.chunk_slices += 1
            self._m_chunk_slices.inc()
            self.max_chunk_slice = max(self.max_chunk_slice, t)
            total += t
        return total

    def _chunk_fill(self, plan: ChunkPlan, prompt: np.ndarray,
                    begin: int, t: int) -> None:
        """One INTERMEDIATE slice: the first slice's copy-on-write, the
        prefix gather through the request's own table, the suffix prefill
        over the slice, and the slice's pool scatter. No hot row, no
        sampling, no PAM placement: the final slice's commit does those."""
        dev = self.device
        bs = self.block_size
        nb = self.scfg.max_len // bs
        row = self.allocator.padded_table(plan.rid, nb, self.sentinel)
        pk, pv = self.cache.pk, self.cache.pv
        cow = plan.cow_src >= 0
        if cow:
            # after the copy the request's own table maps the copy, so
            # the gather below reads the prefix through its own row
            pkv.copy_block(pk, plan.cow_src, int(row[begin // bs]))
            pkv.copy_block(pv, plan.cow_src, int(row[begin // bs]))
        row_t = torch.as_tensor(row, device=dev)
        gk = pam_if.gather_prefix_logical(pk, row_t, begin)
        gv = pam_if.gather_prefix_logical(pv, row_t, begin)
        _, suf_k, suf_v = tf.prefill_suffix(
            self.cfg, self.params,
            torch.as_tensor(prompt[begin:begin + t][None], device=dev),
            gk[:, None], gv[:, None], begin, true_len=t)
        del gk, gv
        bids, sids = self._suffix_coords(row, begin, t, t)
        bi = torch.as_tensor(bids, device=dev).long()
        si = torch.as_tensor(sids, device=dev).long()
        pk[:, bi, si] = torch.movedim(suf_k[:, 0], 1, 2)  # (L, t, Hkv, dh)
        pv[:, bi, si] = torch.movedim(suf_v[:, 0], 1, 2)
        self.prefill_dispatches += 1
        self._m_prefill_disp.inc()
        if cow:
            self.allocator.decref(plan.cow_src)
            self.cow_copies += 1
            self._m_cow.inc()
            plan.cow_src = -1
        if self.trie is not None:
            self.novel_prefill_tokens += t

    def _finish_admit(self, rid: int, rs: RequestState, slot: int,
                      tok: int) -> None:
        """Record the first token and mark the request RUNNING — or DONE
        at once when the prefill's token already ends it."""
        eos = self.scfg.eos_token
        rs.status, rs.slot = RUNNING, slot
        rs.outputs.append(tok)
        rs.planned = 1
        rs.first_token_time = None         # stamped after the clock charge
        self.slots[slot] = rid
        self._m_decode_tokens.inc()
        tr = obs_trace.COLLECTOR
        if tr is not None:
            # begin() closes the open queued / prefill phase
            tr.begin(rid, "decode", self.clock, device=self.name)
        if (eos >= 0 and tok == eos) or rs.request.max_new_tokens <= 1:
            rs.status = DONE
            rs.first_token_time = self.clock
            rs.token_times = [self.clock]
            rs.finish_time = self.clock
            self.slots[slot] = None
            if self.allocator is not None:
                self.allocator.free(rid)
            self._trace_finish(rs)

    # ------------------------------------------------------------ decoding
    def _decode_body_(self, i: int, bufs: StepBufs, schedule: bool) -> None:
        """ONE decode step of the full PAM pipeline, in the reference's
        order (participation -> tier split -> decode -> observe ->
        sample), entirely in place: it reads the engine's ``tokens_dev``,
        ``_active`` and ``rids_dev``, updates the cache, the PAM state,
        the tokens and the active mask in their own storage, and writes
        the step's stats into row ``i`` of ``bufs``. It rebinds nothing
        and reads no device value on the host, so a CUDA graph can
        capture it. ``schedule`` says whether Alg. 2 runs this step."""
        cfg, pcfg, dev = self.cfg, self.pam_cfg, self.device
        smax, bs = self.scfg.max_len, self.block_size
        cache, st = self.cache, self.pam_state
        tokens, active = self.tokens_dev, self._active
        B = active.shape[0]
        lengths = cache.lengths + active.to(torch.int32)
        pos_all = torch.arange(smax, device=dev)[None, :]
        if pcfg is not None:
            participate = pm.participation_mask(pcfg, st.importance, lengths)
        else:
            participate = pos_all < lengths[:, None]
        paged_append = None
        if bs:
            nb = smax // bs
            if self.hot_window:
                # ring demotion: tokens that slid out of the window are
                # re-tagged so the split reads them from the pool
                st.tier.copy_(tiers_mod.clamp_hot_to_window(
                    st.tier, lengths, self.hot_window))
            hot_m, pgd_m, block_live = pm.paged_participation_split(
                participate, st.tier, lengths, bs, self.hot_window)
            bt_eff = torch.where(block_live, st.block_table,
                                 torch.full_like(st.block_table,
                                                 self.sentinel))
            if self.sites is not None:
                d_fn = psh.make_sharded_paged_decode_attn(
                    self.sites, hot_m, pgd_m, bt_eff, block_live)
            else:
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
            bufs.blocks[i, 0] = torch.sum(block_live & act)
            bufs.blocks[i, 1] = torch.sum(window & act)
        else:
            d_fn = pm.make_masked_decode_attn(participate)
        l_fn = (pm.make_masked_latent_attn(participate)
                if tf._mla_moe(cfg) else None)
        logits, stepped, scores = tf.decode_step(
            cfg, self.params, tokens, cache, decode_attn_fn=d_fn,
            paged_append=paged_append, latent_attn_fn=l_fn)
        # inactive slots keep their lengths
        cache.lengths.copy_(torch.where(active, stepped.lengths,
                                        cache.lengths))
        if pcfg is not None:
            bufs.tier_reads[i] = pm.tier_read_counts_of(
                st.tier, participate & active[:, None])
            bufs.hit_rate[i] = pm.hit_rate_of(st.last_hot, participate)
            if scores is None:     # attention-free: recency-only scores
                scores = (pos_all == (cache.lengths - 1)[:, None]).float()
            bufs.moved[i] = pm.observe_update_(
                pcfg, st, scores, cache.lengths, participate,
                schedule=schedule)
        # the sampled token's absolute position is the post-append
        # length; (rid, position) key the per-request draw
        nxt = self._sample(logits, self.rids_dev, cache.lengths)
        tokens.copy_(torch.where(active, nxt, tokens))
        if self.scfg.eos_token >= 0:
            active &= tokens != self.scfg.eos_token
        bufs.tokens[i] = tokens
        bufs.lengths[i] = cache.lengths

    def _schedule_flags(self, key: tuple[int, int]) -> list[bool]:
        """Whether Alg. 2 runs in each micro-step of dispatch ``key``."""
        k, phase = key
        return [self.pam_cfg is not None
                and pm.runs_schedule(self.pam_cfg, phase + i)
                for i in range(k)]

    def _dispatch_eager(self, key: tuple[int, int], bufs: StepBufs) -> None:
        """The ``k`` micro-steps of ``key``, op by op (the CPU's path, and
        on the card an eager twin's, bound by the caller)."""
        for i, schedule in enumerate(self._schedule_flags(key)):
            self._decode_body_(i, bufs, schedule)
        self.decode_body_steps += key[0]

    def _dispatch_graph(self, key: tuple[int, int], bufs: StepBufs) -> None:
        """The counterpart of the reference's ``_fused_decode_fn`` /
        ``_get_micro``: the first dispatch of ``key`` runs eagerly (it
        builds the kernels, creates the cuBLAS handles and warms the
        allocator), then captures the ``k`` micro-steps as one CUDA
        graph; every later dispatch of ``key`` replays it. A failed
        capture or replay raises, naming the key."""
        graph = self._graphs.get(key)
        if graph is None:
            self._dispatch_eager(key, bufs)
            self._graphs[key] = self._capture(key, bufs)
            return
        try:
            graph.replay()
        except Exception as exc:
            raise RuntimeError(f"{self.name}: replay of the decode graph "
                               f"{key} (micro-steps, Alg. 2 phase) failed"
                               ) from exc

    def _capture(self, key: tuple[int, int],
                 bufs: StepBufs) -> torch.cuda.CUDAGraph:
        """Record dispatch ``key`` into a CUDA graph over the engine's own
        tensors, in the engine's shared memory pool. Recording advances
        no state."""
        t0 = time.perf_counter()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.device)
        stream = self._graph_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        # the cycle collector frees dropped engines (they sit in reference
        # cycles); one freed while this thread records ends the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self._graph_pool,
                                    capture_error_mode="thread_local")
                try:
                    self._dispatch_eager(key, bufs)
                finally:
                    graph.capture_end()
        except Exception as exc:
            raise RuntimeError(f"{self.name}: CUDA graph capture of the "
                               f"decode dispatch {key} (micro-steps, "
                               f"Alg. 2 phase) failed") from exc
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.capture_seconds += time.perf_counter() - t0
        return graph

    def release_graphs(self) -> None:
        """Drop the captured decode graphs and their memory pool (an
        engine torn down: a chaos kill, the end of a fleet)."""
        if self._graphs:
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        self._graph_pool = None

    def _readback(self, k: int) -> _Readback:
        """The ``k``-step ``StepBufs`` (made at the first dispatch of
        ``k``)."""
        rb = self._readbacks.get(k)
        if rb is None:
            rb = self._readbacks[k] = _Readback.make(
                k, self.scfg.max_batch, self.device)
        return rb

    def _decode(self, k: int, active_np: np.ndarray) -> dict[str, np.ndarray]:
        """``k`` decode steps in one dispatch (a graph replay on CUDA),
        one host readback of ``StepBufs``."""
        t0 = time.perf_counter()
        rb = self._readback(k)
        self._active_host.copy_(torch.from_numpy(active_np))
        self._active.copy_(self._active_host, non_blocking=True)
        step0 = self.pam_state.step
        tiering = self.pam_cfg is not None and self.pam_cfg.use_tiering
        key = (k, step0 % self.pam_cfg.schedule_interval if tiering else 0)
        self._dispatch(key, rb.bufs)
        out = rb.read()
        if self.pam_cfg is not None:
            self.pam_state = self.pam_state._replace(step=step0 + k)
        out["tier_reads"] = out["tier_reads"].astype(np.int64)
        self.decode_time += time.perf_counter() - t0
        self.decode_dispatches += 1
        self.decode_device_steps += k
        self._m_decode_disp.inc()
        self._m_device_steps.inc(k)
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
        for all running sequences. Returns the step's stats, the dict
        the latency model reads (the reference's keys)."""
        t0 = time.perf_counter()
        prefill_tokens = self._admit() + self._advance_chunks()
        # decode-eligible = occupied and past prefill (a chunking slot is
        # claimed but PREFILLING until its final slice commits)
        active_np = self._running()
        stats: dict[str, Any] = {"prefill_tokens": prefill_tokens,
                                 "active": int(active_np.sum()),
                                 "tier_reads": np.zeros(3, np.int64),
                                 "moved_tokens": 0}
        if active_np.any():
            out = self._decode(1, active_np)
            if self.pam_cfg is not None:
                stats["tier_reads"] = out["tier_reads"][0]
                stats["hit_rate"] = float(out["hit_rate"][0])
                stats["moved_tokens"] = int(out["moved"][0])
            if self.block_size:
                stats["blocks_touched"] = int(out["blocks"][0, 0])
                stats["blocks_window"] = int(out["blocks"][0, 1])
                stats["pool_occupancy"] = self.allocator.occupancy
            stats["batch_lengths"] = out["lengths"][0]
            self._emit_tokens(out["tokens"][0], active_np)
        else:
            stats["batch_lengths"] = self.cache.lengths.cpu().numpy()
        wall = time.perf_counter() - t0
        self.wall_time += wall
        dt = (float(self.latency_model(stats))
              if self.latency_model is not None else wall)
        self.clock += dt
        if not prefill_tokens:
            # the load signal: steady decode latency only (an admission
            # step's prefill spike would whipsaw the router's costs)
            self.last_step_time = dt
            self.last_step_stats = stats
        if active_np.any():
            self.busy_time += dt
        stats["step_time_s"] = dt
        self._stamp_times()
        self.steps += 1
        self._observe_step(stats, dt)
        return stats

    def _emit_tokens(self, nxt: np.ndarray, active: np.ndarray) -> None:
        for slot, rid in enumerate(self.slots):
            if rid is None or not active[slot]:
                continue
            rs = self.requests[rid]
            tok = int(nxt[slot])
            rs.outputs.append(tok)
            self._m_decode_tokens.inc()
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
                    self._trace_finish(rs)

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
        that samples EOS mid-run is frozen on the device. The latency
        model charges each sub-step, the first one the admission's
        prefill, as the reference's ``_consume``; without one each
        sub-step takes an equal share of the iteration's wall time."""
        micro = self.scfg.micro_steps
        eos = self.scfg.eos_token
        while self.steps < max_steps:
            if not self.waiting and all(s is None for s in self.slots):
                break
            t0 = time.perf_counter()
            prefill_tokens = self._admit() + self._advance_chunks()
            pairs = [(i, rid) for i, rid in enumerate(self.slots)
                     if rid is not None
                     and self.requests[rid].status == RUNNING]
            if not pairs:
                wall = time.perf_counter() - t0
                self.wall_time += wall
                if self.latency_model is None:
                    self.clock += wall
                elif self._chunking:
                    # chunk slices filling with nothing decoding: no
                    # decode step carries the admission's charge
                    self._charge_prefill_only(prefill_tokens)
                if prefill_tokens:
                    continue   # the admission wave finished at prefill,
                    # or chunk slices are filling with nothing decoding
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
            wall = time.perf_counter() - t0
            self.wall_time += wall
            for j in range(k):
                stats = {"prefill_tokens": prefill_tokens if j == 0 else 0,
                         "active": len(pairs),
                         "tier_reads": out["tier_reads"][j],
                         "moved_tokens": int(out["moved"][j]),
                         "batch_lengths": out["lengths"][j]}
                if self.pam_cfg is not None:
                    stats["hit_rate"] = float(out["hit_rate"][j])
                dt = (float(self.latency_model(stats))
                      if self.latency_model is not None else wall / k)
                self.clock += dt
                if not stats["prefill_tokens"]:
                    self.last_step_time = dt
                    self.last_step_stats = stats
                self.busy_time += dt
                self._observe_step(stats, dt)
                for slot, rid in pairs:
                    rs = self.requests[rid]
                    if rs.status == DONE:
                        continue             # froze at EOS mid-run
                    tok = int(out["tokens"][j, slot])
                    rs.outputs.append(tok)
                    self._m_decode_tokens.inc()
                    rs.planned = len(rs.outputs)
                    if rs.first_token_time is None:
                        rs.first_token_time = self.clock
                    while len(rs.token_times) < len(rs.outputs):
                        rs.token_times.append(self.clock)
                    if (len(rs.outputs) >= rs.request.max_new_tokens
                            or (eos >= 0 and tok == eos)):
                        rs.status = DONE
                        rs.finish_time = self.clock
                        self._trace_finish(rs)
                        self.slots[slot] = None
                        if self.allocator is not None:
                            self.allocator.free(rid)
        return self.summary()

    def _charge_prefill_only(self, prefill_tokens: int) -> None:
        """Modeled clock charge of a micro-loop iteration that filled
        chunk slices but dispatched no decode step."""
        stats = {"prefill_tokens": prefill_tokens, "active": 0,
                 "tier_reads": np.zeros(3, np.int64), "moved_tokens": 0,
                 "batch_lengths": self.cache.lengths.cpu().numpy()}
        self.clock += float(self.latency_model(stats))

    # ---------------------------------------- cluster / migration hooks
    def can_accept(self, n_tokens: int, *,
                   reserve_queued: bool = True) -> bool:
        """True iff a request with an ``n_tokens`` window (prompt +
        generation budget) could be admitted now: a free slot and, in
        paged mode, enough free pool blocks. With ``reserve_queued`` both
        are counted net of this engine's own waiting queue, so a router's
        dispatch round cannot over-assign it; a migration passes False
        (a rescue may compete with queued admissions)."""
        queued_slots = len(self.waiting) if reserve_queued else 0
        if len(self._free_slots()) - queued_slots < 1:
            return False
        if self.allocator is None:
            return True
        queued = sum(
            self.allocator.blocks_for(
                len(self.requests[rid].request.prompt)
                + self.requests[rid].request.max_new_tokens)
            for rid in self.waiting) if reserve_queued else 0
        return (self.allocator.blocks_for(n_tokens)
                <= self.allocator.free_blocks - queued)

    def serviceable(self, n_tokens: int) -> bool:
        """True iff an ``n_tokens`` window fits this engine at all
        (``max_len`` and the whole pool)."""
        if n_tokens > self.scfg.max_len:
            return False
        if self.allocator is None:
            return True
        return self.allocator.blocks_for(n_tokens) <= self.allocator.num_blocks

    def load_signal(self) -> dict[str, Any]:
        """Host-side load snapshot for the router and the balancer (the
        paper's §4.3 cost signal): queue depth, running count, last
        decode step's clock charge, pool occupancy."""
        running = sum(s is not None for s in self.slots)
        return {
            "queue_depth": len(self.waiting),
            "running": running,
            "free_slots": self.scfg.max_batch - running,
            "step_time_s": self.last_step_time,
            "pool_occupancy": (self.allocator.occupancy
                               if self.allocator is not None else 0.0),
            "free_blocks": (self.allocator.free_blocks
                            if self.allocator is not None else -1),
            "clock": self.clock,
        }

    def slot_importance_mass(self) -> dict[int, float]:
        """Per running request: the sum of its eq. 7 EMA over its tokens,
        the balancer's victim signal (lowest mass moves first)."""
        running = [(slot, rid) for slot, rid in enumerate(self.slots)
                   if rid is not None
                   and self.requests[rid].status == RUNNING]
        if self.pam_cfg is None:
            return {rid: 0.0 for _, rid in running}
        mass = torch.sum(self.pam_state.importance, dim=-1).cpu().numpy()
        return {rid: float(mass[slot]) for slot, rid in running}

    def _require_migratable(self) -> None:
        # an MLA model's latent cache leaves k empty, a hybrid model's
        # cache holds conv / state: both refused here too
        if self.cache.k.numel() == 0 or self.cache.conv.numel() > 0:
            raise ValueError(f"{self.cfg.name}: KV migration requires a "
                             f"pure GQA decode cache")

    def _export_rows(self, rid: int, slot: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """One request's K and V in the logical (L, Hkv, Smax, dh)
        layout: hot tokens from the dense row (through the ring map with
        a hot window), warm/cold tokens through the block table."""
        kc, vc = self.cache.k[:, slot], self.cache.v[:, slot]
        if not self.block_size:
            return kc, vc
        nb = self.scfg.max_len // self.block_size
        row = torch.as_tensor(
            self.allocator.padded_table(rid, nb, self.sentinel),
            device=self.device)
        gk = pkv.gather_sequence(self.cache.pk, row)
        gv = pkv.gather_sequence(self.cache.pv, row)
        tier_row = self.pam_state.tier[slot]
        if self.hot_window:
            ring_pos, valid = ring_position_map(
                self.cache.lengths[slot][None], self.hot_window)
            ring_pos, valid = ring_pos[0], valid[0]
            hot_at = tier_row[ring_pos.clamp(0, gk.shape[2] - 1)]
            sel = valid & (hot_at == tiers_mod.HOT)
            return (pam_if.ring_to_logical(kc, ring_pos, sel, gk),
                    pam_if.ring_to_logical(vc, ring_pos, sel, gv))
        hot = (tier_row == tiers_mod.HOT)[None, None, :, None]
        return torch.where(hot, kc, gk), torch.where(hot, vc, gv)

    def export_request(self, rid: int) -> dict[str, Any]:
        """Export a RUNNING request for migration (§6.2 sender side):
        its KV in the portable logical layout, its PAM rows and host
        bookkeeping, as numpy on the host; then free its slot and blocks
        (a decref: blocks another request or the trie maps survive)
        without finishing it. bf16 K/V travel as ``uint16`` arrays of
        the same bits (numpy has no bfloat16)."""
        self._require_migratable()
        rs = self.requests.get(rid)
        if rs is None or rs.status != RUNNING:
            raise ValueError(f"request {rid} is not running here")
        slot = rs.slot
        k_row, v_row = self._export_rows(rid, slot)
        pam = self.pam_cfg is not None
        imp, tier, lh = (pm.extract_slot_state(self.pam_state, slot) if pam
                         else (None, None, None))
        snap = {
            "request": rs.request,
            "outputs": list(rs.outputs),
            "planned": len(rs.outputs),
            "length": int(self.cache.lengths[slot]),
            "token": int(self.tokens_dev[slot]),
            "k": _kv_to_host(k_row),
            "v": _kv_to_host(v_row),
            "importance": _to_host(imp) if pam else None,
            "tier": _to_host(tier) if pam else None,
            "last_hot": _to_host(lh) if pam else None,
            "first_token_time": rs.first_token_time,
            "token_times": list(rs.token_times),
            "arrival": rs.request.arrival,
            "src": self.name,
        }
        self.slots[slot] = None
        if self.allocator is not None:
            self.allocator.free(rid)
        del self.requests[rid]
        self.migrations_out += 1
        self._m_mig_out.inc()
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.mark(rid, "migrate_out", self.clock, src=self.name)
            tr.begin(rid, "suspended", self.clock)  # closes "decode"
        return snap

    def _kv_to_device(self, a: np.ndarray) -> torch.Tensor:
        """A snapshot's K or V on this engine's device, in its cache
        dtype; a bf16 cache takes the ``uint16`` bit patterns."""
        want = self.cache.k.dtype
        if want == torch.bfloat16:
            if a.dtype != np.uint16:
                raise ValueError(f"{self.name}: a bf16 cache imports uint16 "
                                 f"bit patterns, got {a.dtype}")
            t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
            return t.to(self.device).view(torch.bfloat16)
        t = torch.from_numpy(np.array(a, copy=True))
        if t.dtype != want:
            raise ValueError(f"{self.name}: snapshot KV is {a.dtype}, the "
                             f"cache holds {want}")
        return t.to(self.device)

    def import_request(self, snap: dict[str, Any]) -> None:
        """Admit a migrated request mid-decode (§6.2 receiver side):
        install the snapshot's KV into a free slot (re-based onto the
        ring with a hot window) and, in paged mode, write the whole
        logical row through freshly allocated blocks (physical ids never
        travel); insert the PAM rows and seed the token. Raises
        ``OutOfBlocks`` / ``ValueError`` when this engine cannot take
        the request (check ``can_accept`` first)."""
        self._require_migratable()
        req: Request = snap["request"]
        free = self._free_slots()
        if not free:
            raise ValueError(f"{self.name}: no free slot for migrated "
                             f"request {req.id}")
        Smax = self.scfg.max_len
        if snap["k"].shape[2] != Smax:
            raise ValueError("snapshot window does not match max_len "
                             f"({snap['k'].shape[2]} vs {Smax})")
        dev = self.device
        k_row = self._kv_to_device(snap["k"])
        v_row = self._kv_to_device(snap["v"])
        window = len(req.prompt) + req.max_new_tokens
        table_row = None
        if self.allocator is not None:
            # trie-only cached prefixes yield first under pressure
            self._reserve_fresh(self.allocator.blocks_for(window))
            self.allocator.allocate(req.id, window)  # may raise OutOfBlocks
            table_row = torch.as_tensor(self.allocator.padded_table(
                req.id, Smax // self.block_size, self.sentinel), device=dev)
            self.peak_occupancy = max(self.peak_occupancy,
                                      self.allocator.occupancy)
        slot = free[0]
        length = int(snap["length"])
        if self.hot_window:
            ring_pos, valid = ring_position_map(
                torch.tensor([length], device=dev), self.hot_window)
            dk = pam_if.logical_to_ring(k_row, ring_pos[0], valid[0])
            dv = pam_if.logical_to_ring(v_row, ring_pos[0], valid[0])
        else:
            dk, dv = k_row, v_row
        self.cache.k[:, slot] = dk
        self.cache.v[:, slot] = dv
        self.cache.lengths[slot] = length
        if self.block_size:
            pkv.write_prefill(self.cache.pk, k_row, table_row,
                              self.block_size)
            pkv.write_prefill(self.cache.pv, v_row, table_row,
                              self.block_size)
        self.tokens_dev[slot] = int(snap["token"])
        self.rids_dev[slot] = req.id
        if self.pam_cfg is not None:
            def row(key, dtype, default):
                a = snap[key] if snap[key] is not None else default
                return torch.as_tensor(np.array(a, dtype), device=dev)
            pm.insert_slot_state(
                self.pam_state, slot,
                row("importance", np.float32, np.zeros(Smax)),
                row("tier", np.int32, np.zeros(Smax)),
                row("last_hot", bool, np.zeros(Smax)), table_row)
        rs = RequestState(
            request=req, status=RUNNING, slot=slot,
            outputs=list(snap["outputs"]), planned=snap["planned"],
            first_token_time=snap["first_token_time"],
            token_times=list(snap["token_times"]))
        self.requests[req.id] = rs
        self.slots[slot] = req.id
        if self.trie is not None:
            # the imported row holds the prompt's KV at its positions:
            # publish it so later arrivals share it here too
            self.trie.insert(np.asarray(req.prompt, np.int32),
                             self.allocator.table(req.id))
        self.migrations_in += 1
        self._m_mig_in.inc()
        tr = obs_trace.COLLECTOR
        if tr is not None:
            tr.mark(req.id, "migrate_in", self.clock, dst=self.name)
            tr.begin(req.id, "decode", self.clock, device=self.name)

    def suspend_request(self, rid: int) -> dict[str, Any]:
        """Detach a running request into a host-held snapshot, freeing
        its slot and blocks (``export_request``'s dict); resuming it
        here or on any compatible engine continues the stream exactly
        (sampling keys depend only on seed, rid and position)."""
        return self.export_request(rid)

    def resume_request(self, snap: dict[str, Any]) -> None:
        """Re-admit a suspended request, the twin of ``suspend_request``."""
        self.import_request(snap)

    # ------------------------------------------------ serving surface
    def as_router(self, *, preemptible: bool = False):
        """This engine as a one-device ``ClusterRouter``: admission,
        events and the ``serve`` generator come from the router;
        ``preemptible`` attaches the suspension machinery SLO admission
        needs."""
        from repro_torch.cluster.router import ClusterRouter
        return ClusterRouter.for_engine(self, preemptible=preemptible)

    def serve(self, requests: Optional[Iterable[Request]] = None, *,
              max_ticks: Optional[int] = None) -> Iterator[Any]:
        """Submit ``requests`` (if given) and yield ``ServeEvent``s until
        everything drains; the same surface as ``ClusterRouter.serve``."""
        yield from self.as_router().serve(requests, max_ticks=max_ticks)

    # ------------------------------------------------------------ metrics
    def params_bytes_per_device(self) -> int:
        """Bytes of model parameters one site holds: every leaf at its
        site shape (a split leaf's slice, a replicated leaf whole), as the
        reference counts ``shard_shape``; the whole tree unsharded. On one
        card the sites' slices are views of one allocation: this is what
        a site would hold on a card of its own."""
        return tp.site_nbytes(self.params)

    def summary(self) -> dict[str, Any]:
        """Run metrics: throughput, TPOT percentiles, step counts, tier
        reads and Alg. 2 moves, migrations; in paged mode also pages
        touched vs the dense window per step and pool occupancy; the
        chunk counters with ``prefill_chunk`` and the prefix counters
        with ``prefix_cache``. ``sim_time_s`` and the TPOTs are on the
        engine's clock (modeled with a latency model); ``wall_time_s``
        and the decode times are the host's wall clock, each step ending
        in a device readback."""
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
            "sim_time_s": self.clock,
            "wall_time_s": self.wall_time,
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
            "migrations_in": self.migrations_in,
            "migrations_out": self.migrations_out,
            "tier_reads": [int(x) for x in self.tier_reads_total],
            "moved_tokens": self.moved_tokens_total,
        }
        if self.shard > 1:
            out["shard"] = self.shard
            out["sites"] = [str(d) for d in self.sites.devices]
            out["param_bytes_per_device"] = self.params_bytes_per_device()
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
        if self.chunk:
            out["chunked_admissions"] = self.chunked_admissions
            out["chunk_slices"] = self.chunk_slices
            out["max_chunk_slice_tokens"] = self.max_chunk_slice
        if self.trie is not None:
            out["prefix_hits"] = self.prefix_hits
            out["cached_prefix_tokens"] = self.cached_prefix_tokens
            out["novel_prefill_tokens"] = self.novel_prefill_tokens
            out["cow_copies"] = self.cow_copies
            out["trie_blocks"] = self.trie.num_blocks
            out["trie_evictions"] = self.trie.evictions
        return out

    def slo_attainment(self, slo_s: float) -> float:
        """Fraction of decode-token gaps within the SLO (paper Fig. 9)."""
        gaps = []
        for r in self.requests.values():
            if len(r.token_times) > 1:
                gaps.extend(np.diff(r.token_times).tolist())
        if not gaps:
            return 1.0
        return float(np.mean(np.asarray(gaps) <= slo_s))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` that owns its memory: on a CPU engine
    ``.cpu().numpy()`` would alias the live cache or PAM rows, which the
    slot's next occupant overwrites under a sealed snapshot."""
    return t.to("cpu", copy=True).numpy()


def _kv_to_host(t: torch.Tensor) -> np.ndarray:
    """K or V rows as a host numpy array; bf16 as ``uint16`` bit patterns
    (numpy has no bfloat16), so a snapshot's bytes, ``kv_bytes`` and its
    crc32 are those of the reference's bf16 arrays for the same values."""
    if t.dtype == torch.bfloat16:
        return _to_host(t.contiguous().view(torch.int16)).view(np.uint16)
    return _to_host(t)
