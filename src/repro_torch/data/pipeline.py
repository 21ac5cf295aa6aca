"""Token pipelines (copy of ``repro.data.pipeline``; numpy only, so the
batches are bit-equal to the reference's).

``SyntheticLM`` generates a deterministic, learnable pseudo-corpus (a
periodic Markov-ish stream). ``FileCorpus`` memory-maps a flat .bin of
token ids (numpy uint16/uint32) and serves fixed-length windows. Both
shard by (dp_rank, dp_size) and are restart-safe: state is just the
step. ``make_batch_specs`` gives one batch's shapes and dtypes as meta
tensors (the reference's ``ShapeDtypeStruct`` stand-ins).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def shard_for_rank(global_batch: int, dp_rank: int, dp_size: int
                   ) -> tuple[int, int]:
    """Contiguous per-rank slice of the global batch."""
    per = global_batch // dp_size
    return dp_rank * per, per


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic LM stream: next token depends on the previous
    one and a noise draw via a fixed random mixing table (so it is
    learnable but not trivial). Seeded per (rank, step) — reproducible
    across restarts."""
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 4096)
        self._table = rng.integers(0, v, size=(v, 8), dtype=np.int32)
        self._v = v

    def batch_at(self, step: int, rank: int = 0) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + rank)
        B, S = self.batch, self.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, self._v, size=B)
        noise = rng.integers(0, 8, size=(B, S))
        for t in range(1, S):
            toks[:, t] = self._table[toks[:, t - 1], noise[:, t]]
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1                      # no target for last position
        return {"tokens": toks, "labels": labels}

    def batches(self, start_step: int = 0, rank: int = 0):
        step = start_step
        while True:
            yield self.batch_at(step, rank)
            step += 1


@dataclasses.dataclass
class FileCorpus:
    """Flat token-id binary, windowed. dtype inferred from file suffix
    (.u16.bin / .u32.bin)."""
    path: str
    seq_len: int
    batch: int

    def __post_init__(self):
        dtype = np.uint16 if ".u16" in self.path else np.uint32
        self._data = np.memmap(self.path, dtype=dtype, mode="r")
        self._n_windows = (len(self._data) - 1) // self.seq_len

    def batch_at(self, step: int, rank: int = 0, dp_size: int = 1
                 ) -> dict[str, np.ndarray]:
        idx0 = (step * dp_size + rank) * self.batch
        rows = [(idx0 + i) % self._n_windows for i in range(self.batch)]
        toks = np.stack([
            np.asarray(self._data[r * self.seq_len:(r + 1) * self.seq_len],
                       np.int32) for r in rows])
        labels = np.stack([
            np.asarray(self._data[r * self.seq_len + 1:
                                  (r + 1) * self.seq_len + 1], np.int32)
            for r in rows])
        return {"tokens": toks, "labels": labels}


def make_batch_specs(cfg, batch: int, seq: int) -> dict:
    """Meta-tensor stand-ins (shape and dtype, no storage) for one
    training batch of ``seq`` positions: frames (bf16) for the audio
    family, else tokens and labels (int32) behind the vlm's
    ``num_patches`` patches (bf16)."""
    import torch

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cfg.family == "audio":
        return {"frames": meta((batch, seq, cfg.frontend_dim),
                               torch.bfloat16),
                "labels": meta((batch, seq), torch.int32)}
    text = seq - (cfg.num_patches if cfg.family == "vlm" else 0)
    specs = {"tokens": meta((batch, text), torch.int32),
             "labels": meta((batch, text), torch.int32)}
    if cfg.family == "vlm":
        specs["patches"] = meta((batch, cfg.num_patches, cfg.frontend_dim),
                                torch.bfloat16)
    return specs
