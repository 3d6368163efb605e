"""DualGNN's edge MLP folded into its two edge terms as one kernel
(``ops.cuda.dual_edge``, ``csrc/dual_edge.cu``) and its routing in
``DualLayer.forward``.

On the CPU: ``dual_edge_terms_plain`` (fc1, GELU, fc2, GELU, then fc3
folded into the edge weight) against the unfolded eager edge stage at r5's
widths, in float64 (1e-12 of the largest term: the fold is exact algebra)
and in float32 (``RTOL``: the fold sums fc3's and the edge weight's
products in one, another order; measured at most 7.3e-7); the routing rule
(a CPU tensor, gradients on or dropout drawn keep the eager chain: no
launch, the edge terms bit-equal to it); what the wrapper refuses.

The module imports no JAX, so its ``cuda`` cases run on the card:
``python3 -m pytest tests/test_torch_dual_edge.py -m cuda -p no:cacheprovider``.
There the kernel is held against the plain version (edge counts that are
no multiple of its 128-edge tile, 2 to 32 terms an edge, the sparse
family's -1e15 channel, NaN and infinities), r5's whole forward at
n = 2048 against the unfolded eager one, the ``dual_edge_kernel`` count of
a serving forward and of a training step, and a forward with no host sync.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from lapgnn_tpu_torch import tracing
from lapgnn_tpu_torch.data.generators import FAMILIES
from lapgnn_tpu_torch.models.dual_gnn import DualLayer
from lapgnn_tpu_torch.models.one_gnn import dropout
from lapgnn_tpu_torch.ops.cuda import dual_edge as kedge
from lapgnn_tpu_torch.ops.cuda.dual_edge import (
    dual_edge_terms,
    dual_edge_terms_plain,
    fold_edge_weights,
)
from lapgnn_tpu_torch.ops.features import graph_features

R5 = Path(__file__).resolve().parent.parent / "artifacts" / "dual_gnn_r5"
HIDDEN, HEADS = 256, 4  # dual_gnn_r5's widths


def _gelu(x):
    return F.gelu(x, approximate="none")


def _layer(seed, dtype=torch.float32, rate=0.1):
    torch.manual_seed(seed)
    return DualLayer(HIDDEN, HEADS, rate).to(dtype)


def _eager(layer, x, generator=None):
    """The unfolded edge stage as ``DualLayer.forward`` runs it off the
    kernel: fc1, GELU (dropout), fc2, GELU, fc3, then the edge weight."""
    e = dropout(_gelu(layer.edge_fc1(x)), layer.dropout, generator)
    e = layer.edge_fc3(_gelu(layer.edge_fc2(e)))
    return torch.matmul(e.reshape(-1, layer.hidden_dim), layer._edge_weight()).view(
        *x.shape[:3], 2 * layer.heads)


def _weights(layer):
    wf, bf = fold_edge_weights(layer.edge_fc3.weight, layer.edge_fc3.bias, layer._edge_weight())
    return (layer.edge_fc1.weight, layer.edge_fc1.bias, layer.edge_fc2.weight,
            layer.edge_fc2.bias, wf, bf)


def _features(fam, n, B, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    C = np.stack([FAMILIES[fam](n, rng) for _ in range(B)]).astype(np.float32)
    return graph_features(torch.from_numpy(C).to(device))


def _within(got, want):
    """Equal where ``want`` is not finite; elsewhere within the module's
    tolerance of each instance's largest finite term."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[~fin].isnan(),
                                                                    want[~fin].isnan()):
        return False
    if not torch.equal(got[torch.isinf(want)], want[torch.isinf(want)]):
        return False
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(want))
    return bool((diff <= kedge.tolerance(want)).all())


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("fam", ["uniform", "noisy_linear", "tie", "sparse", "low_rank"])
def test_plain_matches_the_eager_edge_stage_float64(fam):
    layer = _layer(1, torch.float64)
    x = _features(fam, 12, 2, 7).edge_feat.double()
    with torch.no_grad():
        want = _eager(layer, x)
        got = dual_edge_terms_plain(x, *_weights(layer))
    scale = want.abs().amax((1, 2, 3), keepdim=True)
    assert bool(((got - want).abs() <= 1e-12 * scale).all())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_plain_matches_the_eager_edge_stage_float32(fam, seed):
    layer = _layer(seed)
    x = _features(fam, 24, 2, 100 + seed).edge_feat
    with torch.no_grad():
        want = _eager(layer, x)
        got = dual_edge_terms_plain(x, *_weights(layer))
    assert got.dtype == torch.float32 and _within(got, want)


@pytest.mark.parametrize("case", ["inference", "no_grad", "grad", "dropout"])
def test_routing_keeps_the_eager_chain_off_the_card(case, monkeypatch):
    """A CPU tensor (in inference or not), gradients on, or dropout drawn:
    no launch and no count, and the attention reads edge terms bit-equal to
    the unfolded chain's (the row term, and the column term transposed)."""
    layer = _layer(3)
    gf = _features("noisy_linear", 10, 2, 11)
    rows = torch.randn(2, 10, HIDDEN)
    cols = torch.randn(2, 10, HIDDEN)
    seen = []
    real = DualLayer._attention

    def spy(self, src, dst, edge, *args):
        seen.append(edge.detach().clone())
        return real(self, src, dst, edge, *args)

    monkeypatch.setattr(DualLayer, "_attention", spy)
    before = (dual_edge_terms.launches, tracing.counters().get("dual_edge_kernel", 0))
    seed = 5 if case == "dropout" else None
    if case == "inference":
        with torch.inference_mode():
            layer(gf.edge_feat, rows, cols, seed=seed)
    elif case == "grad":
        with torch.enable_grad():
            layer(gf.edge_feat, rows, cols, seed=seed)
    else:
        with torch.no_grad():
            layer(gf.edge_feat, rows, cols, seed=seed)
    assert (dual_edge_terms.launches, tracing.counters().get("dual_edge_kernel", 0)) == before
    g = torch.Generator().manual_seed(seed) if seed is not None else None
    with torch.no_grad():
        want = _eager(layer, gf.edge_feat, g)
    assert torch.equal(seen[0], want[..., :HEADS])
    assert torch.equal(seen[1], want[..., HEADS:].transpose(1, 2))


def _args():
    layer = _layer(4)
    x = torch.randn(1, 5, 6, 10)
    return [x, *(w.detach() for w in _weights(layer))]


@pytest.mark.parametrize("bad", ["dtype", "weight_dtype", "rank", "features", "w2_shape",
                                 "bf_shape", "too_many_terms", "contiguous", "device"])
def test_the_kernel_wrapper_refuses(bad):
    args = _args()
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "weight_dtype":
        args[3] = args[3].double()
    elif bad == "rank":
        args[0] = args[0][0]
    elif bad == "features":
        args[0] = torch.randn(1, 5, 6, 9)
    elif bad == "w2_shape":
        args[3] = args[3][:, :64].contiguous()
    elif bad == "bf_shape":
        args[6] = args[6][:4].contiguous()
    elif bad == "too_many_terms":
        args[5], args[6] = torch.zeros(128, kedge.MAX_OUT + 1), torch.zeros(kedge.MAX_OUT + 1)
    elif bad == "contiguous":
        args[0] = torch.randn(1, 6, 5, 10).transpose(1, 2)
    # "device": every argument is valid but on the CPU, which the kernel does not take
    with pytest.raises((TypeError, ValueError)):
        dual_edge_terms(*args)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_weights(layer, cuda):
    return [w.detach().to(cuda).contiguous() for w in _weights(layer)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [1, 3, 33, 257, 2048])
def test_kernel_matches_plain_on_card(cuda, n, B):
    w = _card_weights(_layer(6), cuda)
    x = _features("uniform", n, B, 13 + n, cuda).edge_feat
    got = dual_edge_terms(x, *w)
    want = dual_edge_terms_plain(x, *w)
    torch.cuda.synchronize()
    assert got.shape == (B, n, n, 2 * HEADS) and _within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [1, 3, 8, 16])
def test_kernel_other_head_counts_on_card(cuda, heads):
    """2 to 32 terms an edge: the fold runs in chunks of 8 outputs padded
    with zeros, and a lane stores only the outputs that exist."""
    torch.manual_seed(heads)
    w = _card_weights(DualLayer(16 * heads, heads, 0.1), cuda)
    x = _features("tie", 45, 2, 31 + heads, cuda).edge_feat
    got = dual_edge_terms(x, *w)
    want = dual_edge_terms_plain(x, *w)
    torch.cuda.synchronize()
    assert got.shape[-1] == 2 * heads and _within(got, want)


@pytest.mark.cuda
def test_wider_layer_keeps_the_eager_chain_on_card(cuda):
    """17 heads, 34 terms an edge, more than the kernel takes: an inference
    forward on the card runs the unfolded chain, with no launch."""
    torch.manual_seed(17)
    layer = DualLayer(16 * 17, 17, 0.1).to(cuda)
    gf = _features("uniform", 12, 1, 37, cuda)
    rows = torch.randn(1, 12, 16 * 17, device=cuda)
    cols = torch.randn(1, 12, 16 * 17, device=cuda)
    before = dual_edge_terms.launches
    with torch.inference_mode():
        layer(gf.edge_feat, rows, cols)
    torch.cuda.synchronize()
    assert dual_edge_terms.launches == before


@pytest.mark.cuda
def test_sparse_channel_on_card(cuda):
    """The sparse family's scaled-cost channel (about -1e15) drives the
    edge MLP far from 0; the terms reach about 1e13, held relative to it."""
    w = _card_weights(_layer(7), cuda)
    x = _features("sparse", 257, 2, 17, cuda).edge_feat
    assert float(x.amin()) < -1e14
    got = dual_edge_terms(x, *w)
    want = dual_edge_terms_plain(x, *w)
    torch.cuda.synchronize()
    assert _within(got, want)


@pytest.mark.cuda
def test_special_values_on_card(cuda):
    """NaN and infinities in an edge's features give NaN and infinities in
    that edge's terms where the plain version has them, and nowhere else;
    an unaligned view of the features (4-byte copies) gives the same."""
    w = _card_weights(_layer(8), cuda)
    x = torch.randn(1, 33, 33, 10, device=cuda)
    x[0, 0, 0, 3] = float("nan")
    x[0, 1, 2, 0] = float("inf")
    x[0, 5, 5, 7] = -float("inf")
    x[0, 9, 4, :] = float("inf")
    got = dual_edge_terms(x, *w)
    want = dual_edge_terms_plain(x, *w)
    torch.cuda.synchronize()
    assert bool((~torch.isfinite(want)).any()) and _within(got, want)
    buf = torch.randn(33 * 33 * 10 + 1, device=cuda)
    view = buf[1:].view(1, 33, 33, 10)
    assert _within(dual_edge_terms(view, *w), dual_edge_terms_plain(view, *w))


def _r5(cuda):
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_from_flax

    params, meta, _ = load_checkpoint(R5)
    model = build_model_from_meta(meta)
    model.load_state_dict(params_from_flax(params))
    return model.to(cuda), params, meta


@pytest.mark.cuda
def test_r5_forward_at_2048_matches_the_eager_forward_on_card(cuda):
    """r5's whole inference forward (six kernel launches) against the same
    model's unfolded eager forward (gradients on, no parameter requiring
    one, so nothing is kept) on a noisy_linear instance at n = 2048: u
    within 2e-5 relative, the serving cell's limit."""
    model, _, _ = _r5(cuda)
    for p in model.parameters():
        p.requires_grad_(False)
    gf = _features("noisy_linear", 2048, 1, 21, cuda)
    before = dual_edge_terms.launches
    with torch.inference_mode():
        u = model(gf.edge_feat, gf.row_feat, gf.col_feat)["u"]
    assert dual_edge_terms.launches - before == 6
    with torch.enable_grad():
        u_eager = model(gf.edge_feat, gf.row_feat, gf.col_feat)["u"]
    assert dual_edge_terms.launches - before == 6
    gap = float((u - u_eager).norm() / u_eager.norm())
    assert gap <= 2e-5, gap


@pytest.mark.cuda
def test_dual_edge_kernel_counts_on_card(cuda):
    """A serving forward (the pipeline's predict) adds 6 to
    ``dual_edge_kernel``, one a layer; a training step (gradients, dropout)
    adds 0."""
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import build_model_from_meta
    from lapgnn_tpu_torch.train.dual_trainer import make_dual_train_step
    from lapgnn_tpu_torch.train.schedule import make_optimizer

    model, params, meta = _r5(cuda)
    pipe = WarmStartPipeline(build_model_from_meta(meta), params, normalize_costs=False,
                             device=cuda)
    C = torch.from_numpy(FAMILIES["uniform"](64, np.random.default_rng(3)).astype(np.float32))
    C = C.to(cuda)[None]
    count = lambda: tracing.counters().get("dual_edge_kernel", 0)  # noqa: E731
    before = count()
    pipe.predict_duals(C)
    torch.cuda.synchronize()
    assert count() - before == 6
    step = make_dual_train_step(model, make_optimizer(list(model.parameters()), 1e-3))
    before = count()
    step(C.repeat(2, 1, 1), torch.zeros(2, 64, device=cuda),
         generator=torch.Generator(cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert count() - before == 0


@pytest.mark.cuda
def test_forward_makes_no_host_sync_on_card(cuda):
    model, _, _ = _r5(cuda)
    gf = _features("tie", 96, 2, 29, cuda)
    with torch.inference_mode():
        model(gf.edge_feat, gf.row_feat, gf.col_feat)  # loads the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model(gf.edge_feat, gf.row_feat, gf.col_feat)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
