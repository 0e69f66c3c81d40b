"""The PyTorch port's hand-written kernels on the card.

Every test here needs an NVIDIA GPU: it is marked `cuda` and skips without
one. The file imports nothing of JAX, so it runs on a machine that has only
PyTorch; tests/conftest.py imports JAX, so run it there without it:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: kernel against its plain version on the same inputs, max error
<= 1e-4 (f32) / 3e-2 (bf16) of max|plain| (f32 sums in another order; bf16
may round one intermediate the other way); the embed CLI on the card
against --cpu, 1e-4 * max(1, max|cpu|); a training step's gradients on the
card against the CPU, 1e-3 of each gradient's max + 1e-6 (f32 through
three layers, a BatchNorm each)."""

import numpy as np
import pytest
import torch

from molclr_tpu_torch.cli import embed as port_embed
from molclr_tpu_torch.data.featurize import featurize_smiles
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import spec_for_graphs
from molclr_tpu_torch.data.synthetic import synthetic_corpus
from molclr_tpu_torch.models import MolCLRNet
from molclr_tpu_torch.losses import nt_xent_loss
from molclr_tpu_torch.ops import fused_gcn, fused_layer, ntxent

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest "
                    "tests/test_torch_port_cuda.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(seed, tiles, s, d, padded_rows):
    """Random block-diagonal symmetric adjacency with self-loops on real
    rows; the last `padded_rows` rows of every tile are padding."""
    rng = np.random.RandomState(seed)
    n, pad = tiles * s, fused_layer.CNT_PAD
    adj = np.zeros((tiles, s, s), np.float32)
    for t in range(tiles):
        a = (rng.rand(s, s) < 0.1).astype(np.float32)
        a = np.maximum(a, a.T)
        np.fill_diagonal(a, 1.0)
        a[s - padded_rows:, :] = 0
        a[:, s - padded_rows:] = 0
        adj[t] = a
    real = np.diagonal(adj, axis1=1, axis2=2).reshape(-1) > 0
    cnt = np.zeros((n, pad), np.float32)
    cnt[:, :8] = rng.randint(0, 3, (n, 8))
    cnt[~real] = 0
    x = dict(h=rng.randn(n, d), a=rng.rand(d) + 0.5, b=0.2 * rng.randn(d),
             adj=adj, cnt=cnt)
    etab = np.zeros((pad, d))
    etab[:8] = 0.3 * rng.randn(8, d)
    gine = dict(etab=etab, w1=rng.randn(d, 2 * d) / d ** 0.5,
                b1=0.1 * rng.randn(2 * d), w2=rng.randn(2 * d, d) / d ** 0.5,
                b2=0.1 * rng.randn(d))
    col = np.zeros((pad, 1))
    col[:8] = rng.randn(8, 1)
    gcn = dict(etab=np.repeat(col, d, axis=1), w=rng.randn(d, d) / d ** 0.5,
               bias=0.1 * rng.randn(d))
    return x, gine, gcn


ACT = {"h", "adj", "cnt", "etab", "w1", "w2", "w"}


def _to(m, dev, dt):
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev,
                            dtype=dt if k in ACT else torch.float32)
            for k, v in m.items()}


def _run(layer, f, x, p, relu_in):
    if layer == "gine":
        return f(x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"],
                 p["w1"], p["b1"], p["w2"], p["b2"], relu_in)
    return f(x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"], p["w"],
             p["bias"], relu_in)


@pytest.mark.parametrize("shape", [(4, 64, 40, 9), (3, 16, 37, 5),
                                   (2, 256, 300, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("layer", ["gine", "gcn"])
def test_kernel_matches_plain(cuda, shape, dtype, relu_in, layer):
    """The kernel against its plain version on the card, including ragged
    widths and padded rows; two runs are bit-identical (no atomics), and
    the launch count grows by one per call."""
    dt = getattr(torch, dtype)
    x, pg, pc = _problem(sum(shape), *shape)
    x, p = _to(x, cuda, dt), _to(pg if layer == "gine" else pc, cuda, dt)
    kern, plain = ((fused_layer.fused_gine_bn_layer,
                    fused_layer.fused_gine_bn_layer_plain) if layer == "gine"
                   else (fused_gcn.fused_gcn_bn_layer,
                         fused_gcn.fused_gcn_bn_layer_plain))
    before = kern.launches
    out, sums = _run(layer, kern, x, p, relu_in)
    out2, sums2 = _run(layer, kern, x, p, relu_in)
    ref_out, ref_sums = _run(layer, plain, x, p, relu_in)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert out.dtype == dt and out.shape == ref_out.shape
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    err = (out.float() - ref_out.float()).abs().max().item()
    assert err <= rtol * ref_out.float().abs().max().item()
    err = (sums - ref_sums).abs().max().item()
    assert err <= rtol * ref_sums.abs().max().item()
    assert torch.equal(out, out2) and torch.equal(sums, sums2)


def _gine_args(x, p):
    return (x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"], p["w1"],
            p["b1"], p["w2"], p["b2"])


@pytest.mark.parametrize("shape", [(4, 64, 40, 9), (3, 16, 37, 5),
                                   (2, 256, 300, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
def test_backward_kernel_matches_plain(cuda, shape, dtype, relu_in):
    """K1f's residuals and K1b against the plain versions on the card, on
    the same residuals and random cotangents; two runs bit-identical."""
    dt = getattr(torch, dtype)
    x, pg, _ = _problem(sum(shape) + 1, *shape)
    x, p = _to(x, cuda, dt), _to(pg, cuda, dt)
    args = _gine_args(x, p)
    out, sums, agg, mid = fused_layer.fused_gine_bn_layer_fwd(*args, relu_in,
                                               residuals=True)
    ref = fused_layer.fused_gine_bn_layer_fwd_plain(*args, relu_in)
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    for got, want in zip((out, sums, agg, mid), ref):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rtol * want.float().abs().max().item()
    gen = torch.Generator().manual_seed(sum(shape))
    g = torch.randn(out.shape, generator=gen).to(cuda, dt)
    dsums = (0.05 * torch.randn(sums.shape, generator=gen)).to(cuda)
    bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"], agg, mid,
             out, p["w1"], p["w2"], relu_in)
    before = fused_layer.fused_gine_bn_layer_bwd.launches
    got = fused_layer.fused_gine_bn_layer_bwd(*bargs)
    again = fused_layer.fused_gine_bn_layer_bwd(*bargs)
    want = fused_layer.fused_gine_bn_layer_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert fused_layer.fused_gine_bn_layer_bwd.launches == before + 2
    for name, a, b, c in zip(("dh", "da", "db", "dw1", "db1", "dw2", "db2",
                              "detab"), got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n,d", [(128, 32), (256, 256), (384, 100)])
@pytest.mark.parametrize("dead", [0, 7])
def test_ntxent_kernels_match_plain(cuda, n, d, dead):
    """K2f and K2b against their plain versions on the card, with dead
    pairs; two runs bit-identical."""
    gen = torch.Generator().manual_seed(n + d + dead)
    reps = torch.randn(n, d, generator=gen)
    reps = (reps / reps.norm(dim=1, keepdim=True)).to(cuda)
    valid = torch.ones(n)
    if dead:
        pairs = torch.randperm(n // 2, generator=gen)[:dead]
        valid[pairs] = 0
        valid[pairs + n // 2] = 0
    valid = valid.to(cuda)
    got = ntxent.ntxent_fwd(reps, valid, 10.0)
    again = ntxent.ntxent_fwd(reps, valid, 10.0)
    want = ntxent.ntxent_fwd_plain(reps, valid, 10.0)
    live = valid > 0
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        err = (a - c)[live].abs().max().item()
        assert err <= 1e-4 * max(1.0, c[live].abs().max().item())
    scale = 1.0 / valid.sum()
    m, l, _ = got
    dr = ntxent.ntxent_bwd(reps, valid, 10.0, scale, m, l)
    dr2 = ntxent.ntxent_bwd(reps, valid, 10.0, scale, m, l)
    ref = ntxent.ntxent_bwd_plain(reps, valid, 10.0, scale, m, l)
    torch.cuda.synchronize()
    assert torch.equal(dr, dr2)
    assert (dr - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_ntxent_kernel_loss_matches_closed_form_on_card(cuda):
    gen = torch.Generator().manual_seed(3)
    zi = torch.randn(200, 64, generator=gen)
    zj = zi + 0.5 * torch.randn(200, 64, generator=gen)
    mask = torch.rand(200, generator=gen) > 0.1
    res = []
    for fn in (ntxent.nt_xent_kernel, nt_xent_loss):
        a = zi.to(cuda).requires_grad_(True)
        b = zj.to(cuda).requires_grad_(True)
        loss = fn(a, b, 0.1, True, pair_mask=mask.to(cuda))
        loss.backward()
        res.append((loss.item(), a.grad, b.grad))
    (l0, a0, b0), (l1, a1, b1) = res
    assert abs(l0 - l1) <= 1e-5 * max(1.0, abs(l1))
    assert (a0 - a1).abs().max().item() <= 1e-4 * a1.abs().max().item()
    assert (b0 - b1).abs().max().item() <= 1e-4 * b1.abs().max().item()


def test_trunk_gets_gradients_on_card(cuda):
    """Training MolCLRNet on the card gives every parameter a non-zero
    gradient (the backward runs K1b once per layer), equal to the CPU's
    within 1e-3 of its max; GCN training on the card raises until its
    backward kernel is ported."""
    smiles = synthetic_corpus(24, seed=5)
    gp = [featurize_smiles(s) for s in smiles]
    batch = pack_batch(gp, spec_for_graphs(gp, 24, tile=32, sizing="max"))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        model = MolCLRNet(num_layers=3, emb_dim=32, feat_dim=64, tile=32,
                          generator=torch.Generator().manual_seed(2))
        model = model.to(dev).train()
        b = batch.to(dev)
        before = fused_layer.fused_gine_bn_layer_bwd.launches
        _, zi = model(b)
        _, zj = model(b)
        nt_xent_loss(zi, zj, 0.1, True, pair_mask=b.graph_mask).backward()
        if dev.type == "cuda":
            assert fused_layer.fused_gine_bn_layer_bwd.launches == before + 6
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        assert g.abs().max() > 0, k
        ref = grads[1][k]
        # (+1e-6: the conv output biases feed a BatchNorm, so their exact
        # gradient is 0 and both devices hold f32 noise there)
        assert (g - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-6, k
    gcn = MolCLRNet(num_layers=2, emb_dim=32, feat_dim=64, tile=32,
                    gnn_type="gcn").to(cuda).train()
    with pytest.raises(NotImplementedError, match="K3b"):
        gcn(batch.to(cuda))


def test_kernel_rejects_a_tile_that_is_not_a_multiple_of_the_strip(cuda):
    x, pg, _ = _problem(1, 2, 24, 8, 2)
    with pytest.raises(ValueError, match="multiple"):
        _run("gine", fused_layer.fused_gine_bn_layer,
             _to(x, cuda, torch.float32), _to(pg, cuda, torch.float32),
             False)


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_embed_cli_on_card_matches_cpu(cuda, tmp_path, gnn):
    """The embed CLI on the card (kernels) against --cpu (plain path), with
    one launch of the layer's kernel per layer and batch."""
    layers, tile = 2, 32
    smiles = synthetic_corpus(40, seed=21)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(smiles) + "\n")
    model = MolCLRNet(num_layers=layers, emb_dim=32, feat_dim=64,
                      gnn_type=gnn, tile=tile,
                      generator=torch.Generator().manual_seed(9))
    gp = [featurize_smiles(s) for s in smiles[:16]]
    with torch.no_grad():
        model.train()(pack_batch(gp, spec_for_graphs(
            gp, 16, tile=tile, sizing="max")).to("cpu"))
    ckpt = tmp_path / "m.pth"
    torch.save(model.state_dict(), ckpt)
    args = ["--checkpoint", str(ckpt), "--model", gnn, "--layers",
            str(layers), "--emb-dim", "32", "--feat-dim", "64",
            "--batch-size", "16", "--tile", str(tile)]
    kern = (fused_layer.fused_gine_bn_layer if gnn == "gin"
            else fused_gcn.fused_gcn_bn_layer)
    kern.launches = 0
    assert port_embed.main([str(corpus), str(tmp_path / "g.npy"), *args]) == 0
    assert kern.launches == layers * 3                    # 40 molecules / 16
    assert port_embed.main([str(corpus), str(tmp_path / "c.npy"), *args,
                            "--cpu"]) == 0
    emb, ref = np.load(tmp_path / "g.npy"), np.load(tmp_path / "c.npy")
    assert emb.shape == ref.shape == (40, 64)
    assert np.abs(emb - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


# ----------------------------------------------- the unchained layers K4, K5


@pytest.mark.parametrize("shape", [(4, 64, 40, 9), (3, 16, 37, 5),
                                   (2, 256, 300, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unchained_gine_kernels_match_plain(cuda, shape, dtype):
    """K4f (with and without residuals) and K4b against their plain
    versions on the card, with random cotangents; two runs bit-identical,
    one launch counted per call."""
    dt = getattr(torch, dtype)
    x, pg, _ = _problem(sum(shape) + 2, *shape)
    x, p = _to(x, cuda, dt), _to(pg, cuda, dt)
    args = (x["h"], x["adj"], x["cnt"], p["etab"], p["w1"], p["b1"],
            p["w2"], p["b2"])
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    before = fused_layer.fused_gine_layer.launches
    res = fused_layer.fused_gine_layer_fwd(*args, residuals=True)
    res2 = fused_layer.fused_gine_layer_fwd(*args, residuals=True)
    lean = fused_layer.fused_gine_layer_fwd(*args, residuals=False)
    ref = fused_layer.fused_gine_layer_fwd_plain(*args)
    torch.cuda.synchronize()
    assert fused_layer.fused_gine_layer.launches == before + 3
    assert lean[1] is None and torch.equal(lean[0], res[0])
    for name, a, b, c in zip(("out", "agg", "mid"), res, res2, ref):
        assert a.dtype == dt and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name
    out, agg, mid = res
    gen = torch.Generator().manual_seed(sum(shape))
    g = torch.randn(out.shape, generator=gen).to(cuda, dt)
    bargs = (g, x["adj"], x["cnt"], agg, mid, p["w1"], p["w2"])
    before = fused_layer.fused_gine_layer_bwd.launches
    got = fused_layer.fused_gine_layer_bwd(*bargs)
    again = fused_layer.fused_gine_layer_bwd(*bargs)
    want = fused_layer.fused_gine_layer_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert fused_layer.fused_gine_layer_bwd.launches == before + 2
    for name, a, b, c in zip(("dh", "dw1", "db1", "dw2", "db2", "detab"),
                             got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shape", [(4, 64, 40, 9), (3, 16, 37, 5),
                                   (2, 256, 300, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unchained_gcn_kernels_match_plain(cuda, shape, dtype):
    """K5f and K5b against their plain versions on the card; two runs
    bit-identical, one launch counted per call."""
    dt = getattr(torch, dtype)
    x, _, pc = _problem(sum(shape) + 3, *shape)
    x, p = _to(x, cuda, dt), _to(pc, cuda, dt)
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    before = fused_gcn.fused_gcn_layer.launches
    out = fused_gcn.fused_gcn_layer_fwd(x["h"], x["adj"], p["w"])
    out2 = fused_gcn.fused_gcn_layer_fwd(x["h"], x["adj"], p["w"])
    ref = fused_gcn.fused_gcn_layer_plain(x["h"], x["adj"], p["w"])
    torch.cuda.synchronize()
    assert fused_gcn.fused_gcn_layer.launches == before + 2
    assert out.dtype == dt and torch.equal(out, out2)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rtol * ref.float().abs().max().item()
    gen = torch.Generator().manual_seed(sum(shape))
    g = torch.randn(out.shape, generator=gen).to(cuda, dt)
    before = fused_gcn.fused_gcn_layer_bwd.launches
    got = fused_gcn.fused_gcn_layer_bwd(g, x["h"], x["adj"], p["w"])
    again = fused_gcn.fused_gcn_layer_bwd(g, x["h"], x["adj"], p["w"])
    want = fused_gcn.fused_gcn_layer_bwd_plain(g, x["h"], x["adj"], p["w"])
    torch.cuda.synchronize()
    assert fused_gcn.fused_gcn_layer_bwd.launches == before + 2
    for name, a, b, c in zip(("dx", "dw"), got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_finetune_trunk_gets_gradients_on_card(cuda, gnn):
    """A train-mode FineTuneNet step (drop_ratio 0.3, the unchained trunk)
    on the card gives every parameter a gradient through K4b / K5b (one
    launch per layer), equal to the CPU's with the same dropout masks
    within 1e-3 of its max (+1e-6, as above); all are non-zero but the
    conv output biases, whose exact gradient is 0 ahead of a BatchNorm."""
    from molclr_tpu_torch.models import FineTuneNet
    from molclr_tpu_torch.train.finetune import compute_loss

    layers, d = 3, 32
    smiles = synthetic_corpus(24, seed=6)
    gp = [featurize_smiles(s, add_hs=True) for s in smiles]
    batch = pack_batch(gp, spec_for_graphs(gp, 24, tile=64, sizing="max"))
    gen = torch.Generator().manual_seed(4)
    n = batch.nbr.shape[0]
    masks = [torch.rand(n, d, generator=gen) < 0.7 for _ in range(layers)]
    labels = torch.randint(0, 2, (24,), generator=gen).float()
    kern = (fused_layer.fused_gine_layer_bwd if gnn == "gin"
            else fused_gcn.fused_gcn_layer_bwd)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        model = FineTuneNet(num_layers=layers, emb_dim=d, feat_dim=64,
                            gnn_type=gnn, drop_ratio=0.3, tile=64,
                            generator=torch.Generator().manual_seed(2))
        model = model.to(dev).train()
        b = batch.to(dev)
        before = kern.launches
        _, pred = model(b, dropout_masks=[m.to(dev) for m in masks])
        compute_loss(pred, labels.to(dev), b.graph_mask, "ce").backward()
        if dev.type == "cuda":
            assert kern.launches == before + layers
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        ref = grads[1][k]
        assert (g - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-6, k
        if not (k.endswith("mlp.2.bias") or (gnn == "gcn" and k.startswith(
                "gnns.") and k.endswith(".bias"))):
            assert g.abs().max() > 0, k
