"""The port's MLA family (``deepseek-v2-lite-16b``) on the card, held to
its own CPU run.

* The reduced model's serving engine (4 heads, latent rank 32, 4
  experts top-2 + 1 shared; fp32, TF32 off) on dense PAM gives the
  greedy streams of the same engine on the CPU, with the decode dispatch
  eager and replayed as CUDA graphs, at ``micro_steps`` 1 and 4: 6
  requests through 4 slots, one of them to ``max_len`` exactly.
* ``mla_decode`` at one layer of full MLA width (d 2048, 16 heads, r
  512 + rope 64) on bf16 CUDA tensors against fp32 on the CPU from the
  same bf16-rounded weights, inputs and caches, three steps: the output
  and the written latent and rope key within 3e-2 of the reference's
  largest magnitude, the mass within 5e-2 of its largest (bf16 rounds
  q, the latent, the absorbed query and the latent output, each to 2^-9
  relative; the scores and probabilities are fp32 on both sides).

Every test needs an NVIDIA GPU and skips without one; the file imports
neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_mla_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import get_config, reduced  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import pam_manager as tpm  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
OUT_TOL = 3e-2
MASS_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card's run "
                    "to the CPU's")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _streams(cfg, host, dev, micro, eager):
    params = host if dev == "cpu" else tree.tree_map(lambda t: t.to(dev),
                                                     host)
    eng = teng.ServingEngine(cfg, params, teng.ServingConfig(
        pam=tpm.PAMManagerConfig(max_tokens=128, hot_capacity=16,
                                 warm_capacity=16, compression=2,
                                 recency_window=4, schedule_interval=2),
        max_batch=4, max_len=128, micro_steps=micro), device=dev)
    if eager:
        eng._dispatch = eng._dispatch_eager
    rng = np.random.default_rng(11)
    lens = [int(n) for n in rng.integers(20, 61, 5)] + [128 - 24]
    for i, n in enumerate(lens):
        eng.submit(teng.Request(i, rng.integers(0, cfg.vocab, n), 24))
    eng.run()
    return {i: list(rs.outputs) for i, rs in eng.requests.items()}, eng


@pytest.mark.cuda
@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("eager", [True, False])
def test_reduced_engine_streams_equal_cpu(cuda, eager, micro):
    cfg = reduced(get_config(ARCH))
    host = ttf.init_params(cfg, 0, device="cpu")
    want, _ = _streams(cfg, host, "cpu", micro, eager=True)
    got, eng = _streams(cfg, host, cuda, micro, eager)
    assert got == want
    assert all(len(v) == 24 for v in got.values())
    assert bool(eng._graphs) != eager


def _rel(got, ref):
    ref = ref.float()
    return float((got.float().cpu() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_mla_decode_bf16_on_card_matches_fp32_cpu(cuda, masked):
    cfg = get_config(ARCH)
    m = cfg.mla
    gen = torch.Generator().manual_seed(0)
    p16 = tmla.init_mla(gen, cfg.d_model, cfg.n_heads, m, torch.bfloat16,
                        torch.device("cpu"))
    B, smax = 2, 256
    caches = [torch.randn((B, smax, n), generator=gen).to(torch.bfloat16)
              for n in (m.kv_lora_rank, m.qk_rope_head_dim)]
    part = torch.rand((B, smax), generator=gen) < 0.7
    ref = [c.float() for c in caches]
    got = [c.to(cuda) for c in caches]
    p32 = tmla.MLAParams(*(w.float() for w in p16))
    pdev = tmla.MLAParams(*(w.to(cuda) for w in p16))
    kw = dict(n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
              rms_eps=cfg.rms_eps)
    for lens in ([7, 200], [8, 201], [9, 255]):
        x = torch.randn((B, cfg.d_model), generator=gen).to(torch.bfloat16)
        lens = torch.tensor(lens, dtype=torch.int32)
        fns = ((tpm.make_masked_latent_attn(part),
                tpm.make_masked_latent_attn(part.to(cuda))) if masked else
               (tmla.mla_latent_decode_attn,) * 2)
        o_ref, mass_ref, *_ = tmla.mla_decode(
            p32, x.float(), ref[0], ref[1], lens, m,
            latent_attn_fn=fns[0], **kw)
        o, mass, *_ = tmla.mla_decode(
            pdev, x.to(cuda), got[0], got[1], lens.to(cuda), m,
            latent_attn_fn=fns[1], **kw)
        assert o.dtype == torch.bfloat16 and mass.dtype == torch.float32
        assert _rel(o, o_ref) <= OUT_TOL
        assert _rel(mass, mass_ref) <= MASS_TOL
        for g, r in zip(got, ref):
            assert _rel(g, r) <= OUT_TOL
