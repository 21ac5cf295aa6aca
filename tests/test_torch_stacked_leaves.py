"""The port's training graph reads each stacked layer leaf through one
``unbind``, for both families, with and without remat.

``params["layers"]`` stacks every layer's weights on a leading axis, as
the JAX pytree does. Indexing a leaf once per layer would put a
``SelectBackward0`` on it for every layer, each of whose backward
allocates a zero tensor as large as the whole leaf, and autograd would
add L of them. ``models.transformer._layers`` unbinds each leaf once per
forward, outside the remat checkpoints, so the only node that feeds a
stacked leaf's gradient is one ``UnbindBackward0``. Walked from
``loss.grad_fn`` on the reduced configs (random weights from seed 0,
tokens from a seeded numpy generator); the gradients themselves are held
to the reference by ``test_torch_training.py`` and ``test_torch_ssm.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.models import config as tcfg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = ["qwen3-0.6b", "mamba2-780m"]


def _loss(arch, remat, use_kernel):
    cfg = tcfg.reduced(tcfg.get_config(arch))
    params = ttf.init_params(cfg, 0, device="cpu")
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    loss = ttf.loss_fn(cfg, params, batch, use_kernel=use_kernel,
                       remat=remat)
    return cfg, params, loss


def _feeders(loss):
    """For each leaf tensor reached by the graph (by id): the names of the
    nodes whose next_functions hold its AccumulateGrad."""
    feeds, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if type(nxt).__name__ == "AccumulateGrad":
                feeds.setdefault(id(nxt.variable), []).append(node.name())
            todo.append(nxt)
    return feeds


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_stacked_leaf_is_fed_by_one_unbind(arch, remat):
    cfg, params, loss = _loss(arch, remat, use_kernel=True)
    feeds = _feeders(loss)
    stacked = tree.leaves_with_paths(params["layers"])
    assert len(stacked) > 5
    for name, leaf in stacked:
        assert leaf.shape[0] == cfg.n_layers, name
        fed_by = feeds.get(id(leaf))
        assert fed_by == ["UnbindBackward0"], (name, fed_by)
    names = [n for fs in feeds.values() for n in fs]
    assert "SelectBackward0" not in names


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_views_are_the_stacked_slices(arch):
    """``_layers`` gives one dict per layer, shaped like
    ``params["layers"]``, whose leaves are views of slice i."""
    cfg = tcfg.reduced(tcfg.get_config(arch))
    params = ttf.init_params(cfg, 0, device="cpu")
    views = ttf._layers(params)
    assert len(views) == cfg.n_layers
    for i, lp in enumerate(views):
        for (name, v), (name2, s) in zip(tree.leaves_with_paths(lp),
                                         tree.leaves_with_paths(
                                             params["layers"])):
            assert name == name2
            assert v._base is s and torch.equal(v, s[i])

