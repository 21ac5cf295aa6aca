"""Inter-device KV migration (paper §4.3 / §6.2): move a running request
between serving engines. Counterpart of ``repro.cluster.migration``.

The currency is the ``KVSnapshot``: the request's KV in the portable
logical layout (L, Hkv, Smax, dh) — hot tokens read from the source's
dense row (through the ring map when it runs a hot window), warm/cold
tokens gathered from the paged pool through the block table — plus the
per-token PAM state (importance EMA, tier tags, participation history)
and the host bookkeeping (emitted tokens, timing marks, the next-token
seed). The layout is absolute, so engines with different hot windows
(or none) interoperate; the importer re-bases onto its own ring.

Arrays are numpy on the host. bf16 K/V are held as ``uint16`` arrays of
the same bit patterns (numpy has no bfloat16), so ``kv_bytes`` and the
crc32 seal equal the reference's for the same values; a reference
snapshot's bf16 arrays cross by ``.view(np.uint16)``.

Export frees the source's slot and blocks without finishing the request
(with the prefix cache a decref: blocks other requests or the trie map
stay); import installs the snapshot into a free slot and freshly
allocated blocks of the target (physical block ids never travel) and
publishes the prompt in the target's trie. A migrated request's stream
equals its unmigrated twin's: the token choice depends on the KV bytes,
the importance EMA and the length, never on the tier tags, and sampling
keys are per request (``fold_in(fold_in(seed, rid), position)``).

``seal`` puts a crc32 over the KV bytes and the host bookkeeping on the
snapshot, ``verify`` re-derives it, and ``commit`` refuses a sealed
snapshot whose checksum no longer matches (``SnapshotCorruption``)
before it claims a slot or a block.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional

import numpy as np

from repro_torch.serving.engine import Request, ServingEngine


class SnapshotCorruption(RuntimeError):
    """A sealed ``KVSnapshot`` failed its checksum at commit time."""


@dataclasses.dataclass
class KVSnapshot:
    """Portable mid-decode state of one request (see module docstring).

    ``kv_bytes`` is the volume a real interconnect would carry: only the
    live window (length tokens x layers x heads x head_dim x 2 tensors).
    """
    request: Request
    outputs: list[int]             # tokens emitted so far (incl. prefill)
    length: int                    # cache length at export
    token: int                     # next-token seed
    k: np.ndarray                  # (L, Hkv, Smax, dh) logical layout
    v: np.ndarray
    importance: Optional[np.ndarray]   # (Smax,) eq. 7 EMA, or None
    tier: Optional[np.ndarray]         # (Smax,) tier tags, or None
    last_hot: Optional[np.ndarray]     # (Smax,) participation history
    first_token_time: Optional[float]
    token_times: list[float]
    src: str                       # exporting device name
    checksum: Optional[int] = None   # crc32 seal; None = unsealed
    src_shard: int = 1             # the exporting engine's shard count

    @property
    def kv_bytes(self) -> int:
        L, Hkv, _, dh = self.k.shape
        return 2 * L * Hkv * dh * self.length * self.k.dtype.itemsize

    @classmethod
    def export(cls, engine: ServingEngine, rid: int) -> "KVSnapshot":
        """Detach a running request from ``engine`` (frees its slot and
        blocks) and wrap its state, sealed with a checksum."""
        d = engine.export_request(rid)
        snap = cls(request=d["request"], outputs=d["outputs"],
                   length=d["length"], token=d["token"], k=d["k"],
                   v=d["v"], importance=d["importance"], tier=d["tier"],
                   last_hot=d["last_hot"],
                   first_token_time=d["first_token_time"],
                   token_times=d["token_times"], src=d["src"],
                   src_shard=engine.shard)
        snap.seal()
        return snap

    # ------------------------------------------------------ wire integrity
    def _digest(self) -> int:
        """crc32 over what exactness depends on: the KV bytes and the
        host bookkeeping that seeds the resumed decode."""
        head = repr((self.request.id, self.outputs, self.length,
                     self.token)).encode()
        crc = zlib.crc32(head)
        crc = zlib.crc32(np.ascontiguousarray(self.k), crc)
        crc = zlib.crc32(np.ascontiguousarray(self.v), crc)
        if self.importance is not None:
            crc = zlib.crc32(np.ascontiguousarray(self.importance), crc)
        return crc & 0xFFFFFFFF

    def seal(self) -> "KVSnapshot":
        self.checksum = self._digest()
        return self

    def verify(self) -> bool:
        """True iff unsealed or the seal still matches the content."""
        return self.checksum is None or self.checksum == self._digest()

    def clone(self) -> "KVSnapshot":
        """Deep copy: the wire copy a transfer carries, so corruption in
        flight never touches the sender's copy."""
        return dataclasses.replace(
            self, outputs=list(self.outputs), k=self.k.copy(),
            v=self.v.copy(),
            importance=(None if self.importance is None
                        else self.importance.copy()),
            tier=None if self.tier is None else self.tier.copy(),
            last_hot=(None if self.last_hot is None
                      else self.last_hot.copy()),
            token_times=list(self.token_times))

    def commit(self, engine: ServingEngine) -> None:
        """Install this snapshot on ``engine``; decode resumes at its
        next step. A sealed snapshot is verified first, so a corrupted
        one raises ``SnapshotCorruption`` before any slot or block is
        claimed."""
        if not self.verify():
            raise SnapshotCorruption(
                f"request {self.request.id}: snapshot checksum mismatch "
                f"(corrupted in transfer from {self.src})")
        engine.import_request({
            "request": self.request, "outputs": self.outputs,
            "planned": len(self.outputs), "length": self.length,
            "token": self.token, "k": self.k, "v": self.v,
            "importance": self.importance, "tier": self.tier,
            "last_hot": self.last_hot,
            "first_token_time": self.first_token_time,
            "token_times": self.token_times,
        })


def can_migrate(src: ServingEngine, dst: ServingEngine, rid: int) -> bool:
    """Feasibility precheck: ``rid`` runs on ``src``, and ``dst`` has the
    same cache window, PAM policy and sampling policy (seed included)
    and can take the request's window right now (a free slot and pool
    blocks, competing with its own queue)."""
    rs = src.requests.get(rid)
    if rs is None or rs.status != "running":
        return False
    if dst.scfg.max_len != src.scfg.max_len:
        return False
    if dst.pam_cfg != src.pam_cfg:
        return False
    if ((dst.scfg.temperature, dst.scfg.top_k, dst.scfg.sample_seed)
            != (src.scfg.temperature, src.scfg.top_k,
                src.scfg.sample_seed)):
        return False
    window = len(rs.request.prompt) + rs.request.max_new_tokens
    return dst.serviceable(window) and dst.can_accept(
        window, reserve_queued=False)


def migrate(src: ServingEngine, dst: ServingEngine, rid: int,
            link_bw: float = 0.0) -> dict[str, Any]:
    """Move running request ``rid`` from ``src`` to ``dst``; on a failed
    import the request goes back to ``src`` (whose export freed the
    room) and the error propagates.

    Returns a record: bytes moved and the modeled transfer seconds at
    ``link_bw`` (0 disables the charge). The caller (the balancer)
    prechecks feasibility and advances the destination's clock.
    """
    snap = KVSnapshot.export(src, rid)
    try:
        snap.commit(dst)
    except Exception:
        snap.commit(src)
        raise
    transfer_s = snap.kv_bytes / link_bw if link_bw > 0 else 0.0
    return {"rid": rid, "src": src.name, "dst": dst.name,
            "tokens": snap.length, "bytes": snap.kv_bytes,
            "transfer_s": transfer_s}
