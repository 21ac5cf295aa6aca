"""The kernel builds of the vlm and audio families on the card, held to
their plain versions: the decode kernels at (head dim 64, group 7)
(internvl2-1b: 14 query heads over 2 kv heads; the wide path, warps
holding 1, 2, 2 and 2 heads, four query values a thread staged with a
tail guard) and the ``flash_attention`` forward at (64, 7) causal and at
(80, 1) bidirectional (hubert-xlarge's encoder): bf16 on the wgmma
kernel (TMA zero-fills head dim 80 to two 64-column swizzle tiles), fp32
on the CUDA-core kernel (five output columns a thread at head dim 80,
the fp32 tiles above 48 KB of shared memory), then both models'
reduced variants card against CPU. Every test here needs an NVIDIA GPU
and skips without one; the file imports neither JAX nor the reference
package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_vlm_audio_cuda.py

Tolerances: decode rtol / atol 1e-4 as ``tests/test_torch_decode_gqa_cuda.py``
(both sides fp32, another summation order and the kernels' ex2.approx);
attention fp32 rtol 1e-4 / atol 1e-3 and bf16 2e-2 (one bf16 rounding
of the output), as chip_smoke's kernel rows; model logits 1e-3 of the
largest logit, as chip_smoke's parity phases; TF32 off.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402

DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-3),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
PARITY_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, tol):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 40, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_group7_matches_plain(cuda, dtype, split):
    """The dense kernel at (64, 7), stacked and merged with its scores:
    ragged lengths, an all-dead row, a dead split."""
    rng = np.random.default_rng(70)
    B, H, Hkv, d, S = 3, 14, 2, 64, 300
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
               for s in ((B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    mask = torch.from_numpy(rng.random((B, S)) < 0.5)
    mask[0, 128:256] = False
    lens = torch.tensor([300, 77, 0])
    dev = [t.to(cuda) for t in (q, k, v, mask)]
    ref = tfd.flash_decode(q, k, v, mask, kv_lens=lens, block_s=split or 128)
    n0 = tfd.flash_decode.launches
    got = tfd.flash_decode(*dev, kv_lens=lens.to(cuda), block_s=split or 128)
    torch.cuda.synchronize()
    assert tfd.flash_decode.launches - n0 == 1
    _close(got, ref, DECODE_TOL)
    ref = tfd.flash_decode_merged(q, k, v, mask, kv_lens=lens, scores=True)
    n0 = tfd.flash_decode_merged.launches
    got = tfd.flash_decode_merged(*dev, kv_lens=lens.to(cuda), scores=True,
                                  split=split)
    torch.cuda.synchronize()
    assert tfd.flash_decode_merged.launches - n0 == 1
    _close(got, ref, DECODE_TOL)
    assert bool((got[1][2] == tfd.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_group7_matches_plain(cuda, dtype):
    """The paged kernel at (64, 7), stacked and merged with its scores:
    sentinel entries, dead blocks, a row with no live token."""
    rng = np.random.default_rng(71)
    B, H, Hkv, d, bs, nb, NB = 3, 14, 2, 64, 16, 12, 40
    q = torch.from_numpy(rng.standard_normal((B, H, d), np.float32)).to(dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (NB + 1, bs, Hkv, d), np.float32)).to(dtype) for _ in range(2))
    table = torch.from_numpy(
        rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32))
    table[2, 5:] = NB
    mask = torch.from_numpy(rng.random((B, nb * bs)) < 0.3)
    mask[1, :] = False
    mask[2, 5 * bs:] = False
    live = mask.reshape(B, nb, bs).any(-1)
    live[0, 0] = False
    args = (q, kp, vp, table, mask)
    dev = [t.to(cuda) for t in args]
    ref = tfd.flash_decode_paged(*args, block_live=live)
    got = tfd.flash_decode_paged(*dev, block_live=live.to(cuda))
    _close(got, ref, DECODE_TOL)
    ref = tfd.flash_decode_paged_merged(*args, block_live=live, scores=True)
    got = tfd.flash_decode_paged_merged(*dev, block_live=live.to(cuda),
                                        scores=True)
    _close(got, ref, DECODE_TOL)
    assert bool((got[1][1] == tfd.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,d,S,causal", [(14, 2, 64, 200, True),
                                              (16, 16, 80, 150, False),
                                              (4, 4, 80, 64, True)])
def test_flash_attention_forward_matches_plain(cuda, H, Hkv, d, S, causal,
                                               dtype):
    """The forward at (64, 7) and (80, 1), ragged last tiles: fp32 on the
    3xTF32 tensor-core kernel, bf16 on the wgmma kernel (one wgmma launch a call,
    also held to ``_fwd_rounded``, the plain model of its bf16 rounding
    of P); o and the fp32 log-sum-exp against the plain version, one
    launch a call."""
    rng = np.random.default_rng(d + S)
    B = 2
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
               for s in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    wgmma = dtype == torch.bfloat16
    assert tfa._variant(dtype, d) == ("wgmma" if wgmma else "tf32x3")
    ref = tfa.flash_attention_fwd(q, k, v, causal=causal)
    n0 = (tfa.flash_attention.launches, tfa.flash_attention.wgmma_launches)
    got = tfa.flash_attention_fwd(*(t.to(cuda) for t in (q, k, v)),
                                  causal=causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches - n0[0],
            tfa.flash_attention.wgmma_launches - n0[1]) == (1, int(wgmma))
    _close(got[:1], ref[:1], ATTN_TOL[dtype])
    _close(got[1:], ref[1:], ATTN_TOL[torch.float32])
    if wgmma:
        rounded, _ = tfa._fwd_rounded(q, k, v, causal, d ** -0.5)
        _close(got[:1], (rounded,), ATTN_TOL[dtype])


def _reduced(arch, **heads):
    from repro_torch.models.config import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **heads)


def _rel(a, b):
    return float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [{}, dict(n_heads=14, n_kv_heads=2,
                                            d_head=64)],
                         ids=["reduced", "g7"])
def test_vlm_forward_prefill_decode_card_vs_cpu(cuda, heads):
    """Reduced internvl2-1b (fp32): ``forward(use_kernel=True)`` with
    patches, ``prefill(patches=)`` and two decode steps through
    ``flash_decode_merged``, card against CPU."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving import pam_manager as pm
    cfg = _reduced("internvl2-1b", **heads)
    from repro_torch.tree import tree_map
    params = tf.init_params(cfg, 0, device="cpu")
    dparams = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
    patches = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_patches, cfg.frontend_dim), np.float32))
    batch = {"tokens": toks, "patches": patches}
    ref, _ = tf.forward(cfg, params, batch, use_kernel=True)
    got, _ = tf.forward(cfg, dparams, {k: v.to(cuda) for k, v in
                                       batch.items()}, use_kernel=True)
    assert _rel(got, ref) <= PARITY_TOL
    lc, cc = tf.prefill(cfg, params, toks, 64, patches=patches)
    lg, cg = tf.prefill(cfg, dparams, toks.to(cuda), 64,
                        patches=patches.to(cuda))
    assert _rel(lg, lc) <= PARITY_TOL
    part = torch.ones((2, 64), dtype=torch.bool)
    for _ in range(2):
        nxt = torch.argmax(lc, -1).to(torch.int32)
        lc, cc, _ = tf.decode_step(cfg, params, nxt, cc,
                                   decode_attn_fn=pm.make_masked_decode_attn(
                                       part))
        n0 = tfd.flash_decode_merged.launches
        lg, cg, _ = tf.decode_step(cfg, dparams, nxt.to(cuda), cg,
                                   decode_attn_fn=pm.make_masked_decode_attn(
                                       part.to(cuda)))
        assert tfd.flash_decode_merged.launches - n0 == cfg.n_layers
        assert _rel(lg, lc) <= PARITY_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [{}, dict(n_heads=4, n_kv_heads=4,
                                            d_head=80)],
                         ids=["reduced", "d80"])
def test_audio_forward_card_vs_cpu(cuda, heads):
    """Reduced hubert-xlarge (fp32): the bidirectional
    ``forward(use_kernel=True)`` over 150 frames, card against CPU, one
    ``flash_attention`` launch a layer."""
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map
    cfg = _reduced("hubert-xlarge", **heads)
    params = tf.init_params(cfg, 0, device="cpu")
    dparams = tree_map(lambda t: t.to(cuda), params)
    frames = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 150, cfg.frontend_dim), np.float32))
    ref, _ = tf.forward(cfg, params, {"frames": frames}, use_kernel=True)
    n0 = tfa.flash_attention.launches
    got, _ = tf.forward(cfg, dparams, {"frames": frames.to(cuda)},
                        use_kernel=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches - n0 == cfg.n_layers
    assert _rel(got, ref) <= PARITY_TOL
