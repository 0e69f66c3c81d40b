"""The member axis of the unchained layer kernels (K4f / K4b, K5f / K5b) and
the lockstep trunk of an ensemble, on the CPU at small sizes (M = 3
members, T = 2 tiles of 128, D = 32, D2 = 64).

The JAX FineTuner trains its members as one `jax.vmap` over its step with
the batch unmapped, so the adjacency and the counts are shared while the
features, the edge tables and the weights carry the member axis. Here each
member-axis wrapper's CPU path (the plain version, member by member), its
forward and its VJP, is held to `jax.vmap` of the JAX kernel in interpreter
mode with the adjacency and the counts at `in_axes=None`; then the lockstep
trunk (models.nets.member_trunks) against each member's own trunk, and one
GIN and one GCN ensemble `train_step` against its members stepped alone,
bit for bit.

Tolerances are tests/test_torch_port_finetune_ops.py's: f32 max|port -
jax| <= 1e-5 * max(1, max|jax|) (sums taken in another order); bf16 3e-2
of max|jax| (one bf16 ulp is 2^-8; an intermediate may round the other
way). The trunk and the steps: exact."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.ops import fused_gcn as jax_fused_gcn
from molclr_tpu.ops import fused_layer as jax_fused_layer
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import featurize_many, spec_for_graphs
from molclr_tpu_torch.data.synthetic import synthetic_corpus
from molclr_tpu_torch.models import FineTuneNet, layers
from molclr_tpu_torch.models.nets import member_trunks
from molclr_tpu_torch.ops import fused_gcn, fused_layer
from molclr_tpu_torch.train.finetune import train_step
from molclr_tpu_torch.train.optim import two_group_adam

M, T, S, D, D2 = 3, 2, 128, 32, 64
RTOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32, RTOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# member-axis arguments that stay f32 (the biases)
F32 = {"b1", "b2"}
GINE_PARAMS = ("h", "etab", "w1", "b1", "w2", "b2")


def assert_close(port, ref, rtol):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    lim = rtol * max(1.0, float(np.abs(ref).max()))
    assert err <= lim, (err, lim)


def _problem(seed):
    """A block-diagonal symmetric adjacency with self-loops on real rows
    (the last 24 rows of each tile are padding) and edge counts, shared;
    per member features (zero on padding rows), edge tables, weights and a
    cotangent."""
    rng = np.random.RandomState(seed)
    n = T * S
    adj = np.zeros((T, S, S), np.float32)
    for k in range(T):
        a = (rng.rand(S, S) < 0.05).astype(np.float32)
        a = np.maximum(a, a.T)
        np.fill_diagonal(a, 1.0)
        a[S - 24:, :] = 0
        a[:, S - 24:] = 0
        adj[k] = a
    real = np.diagonal(adj, axis1=1, axis2=2).reshape(-1) > 0
    cnt = np.zeros((n, fused_layer.CNT_PAD), np.float32)
    cnt[:, :8] = rng.randint(0, 3, (n, 8))
    cnt[~real] = 0
    etab = np.zeros((M, fused_layer.CNT_PAD, D), np.float32)
    etab[:, :8] = 0.3 * rng.randn(M, 8, D)
    h = rng.randn(M, n, D) * real[None, :, None]
    x = dict(adj=adj, cnt=cnt, h=h, etab=etab,
             w1=rng.randn(M, D, D2) / D ** 0.5, b1=0.1 * rng.randn(M, D2),
             w2=rng.randn(M, D2, D) / D2 ** 0.5, b2=0.1 * rng.randn(M, D),
             w=rng.randn(M, D, D) / D ** 0.5, g=rng.randn(M, n, D))
    return {k: np.asarray(v, np.float32) for k, v in x.items()}


def _jx(x, jdt):
    return {k: jnp.asarray(v, jnp.float32 if k in F32 else jdt)
            for k, v in x.items()}


def _tx(x, tdt):
    return {k: torch.from_numpy(v).to(torch.float32 if k in F32 else tdt)
            for k, v in x.items()}


def _vmap(fn, mapped: str):
    """jax.vmap of fn with the arguments marked '0' in `mapped` on the
    member axis and those marked '-' (the adjacency, the counts) unmapped,
    as the JAX FineTuner maps its step over a shared batch."""
    return jax.vmap(fn, in_axes=tuple(0 if c == "0" else None
                                      for c in mapped))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gine_members_forward_matches_jax_vmap(dtype):
    """(out, agg, mid) of fused_gine_layer_members_fwd (the plain version
    member by member) against jax.vmap of the Pallas forward."""
    jdt, tdt, rtol = DTYPES[dtype]
    x = _problem(1)
    jx, tx = _jx(x, jdt), _tx(x, tdt)
    keys = ("h", "adj", "cnt", "etab", "w1", "b1", "w2", "b2")
    ref = _vmap(functools.partial(jax_fused_layer._run_fwd, interpret=True),
                "0--00000")(*(jx[k] for k in keys))
    got = fused_layer.fused_gine_layer_members_fwd(*(tx[k] for k in keys),
                                                   residuals=True)
    for a, b in zip(got, ref):
        assert a.dtype == tdt
        assert_close(a, b, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gine_members_vjp_matches_jax_vmap(dtype):
    """fused_gine_layer_members and its backward against jax.vjp of the
    vmapped Pallas layer: the output and the gradients of h, etab, W1, b1,
    W2, b2 of every member, in the dtypes `_fused_bwd` returns; none for
    the shared adjacency and counts; no kernel launched on the CPU."""
    jdt, tdt, rtol = DTYPES[dtype]
    x = _problem(2)
    jx, tx = _jx(x, jdt), _tx(x, tdt)

    def f(h, etab, w1, b1, w2, b2):
        return _vmap(lambda h, e, w1, b1, w2, b2:
                     jax_fused_layer.fused_gine_layer(
                         h, jx["adj"], jx["cnt"], e, w1, b1, w2, b2, True),
                     "000000")(h, etab, w1, b1, w2, b2)

    jout, vjp = jax.vjp(f, *(jx[k] for k in GINE_PARAMS))
    jgrads = vjp(jx["g"])
    for k in GINE_PARAMS:
        tx[k].requires_grad_(True)
    before = (fused_layer.fused_gine_layer.launches,
              fused_layer.fused_gine_layer_bwd.launches)
    out = fused_layer.fused_gine_layer_members(
        tx["h"], tx["adj"], tx["cnt"], tx["etab"], tx["w1"], tx["b1"],
        tx["w2"], tx["b2"])
    assert type(out.grad_fn).__name__ == "_GineBackward"
    out.backward(tx["g"])
    assert (fused_layer.fused_gine_layer.launches,
            fused_layer.fused_gine_layer_bwd.launches) == before
    assert_close(out, jout, rtol)
    for k, jg in zip(GINE_PARAMS, jgrads):
        assert tx[k].grad.dtype == tx[k].dtype, k
        assert_close(tx[k].grad, jg, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gine_members_bwd_matches_jax_kernel_vmap(dtype):
    """fused_gine_layer_members_bwd's six stacked results against jax.vmap
    of the Pallas backward (`_run_bwd`) on JAX's residuals."""
    jdt, tdt, rtol = DTYPES[dtype]
    x = _problem(3)
    jx = _jx(x, jdt)
    keys = ("h", "adj", "cnt", "etab", "w1", "b1", "w2", "b2")
    _, agg, mid = _vmap(functools.partial(jax_fused_layer._run_fwd,
                                          interpret=True),
                        "0--00000")(*(jx[k] for k in keys))
    ref = _vmap(functools.partial(jax_fused_layer._run_bwd, interpret=True),
                "0--0000")(jx["g"], jx["adj"], jx["cnt"], agg, mid,
                           jx["w1"], jx["w2"])
    t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(tdt)
         for k, v in dict(g=jx["g"], adj=jx["adj"], cnt=jx["cnt"], agg=agg,
                          mid=mid, w1=jx["w1"], w2=jx["w2"]).items()}
    got = fused_layer.fused_gine_layer_members_bwd(
        t["g"], t["adj"], t["cnt"], t["agg"], t["mid"], t["w1"], t["w2"])
    for a, b in zip(got, ref):
        assert_close(a, np.asarray(b, np.float32).reshape(a.shape), rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_members_match_jax_vmap(dtype):
    """fused_gcn_layer_members forward and its VJP in x and W (dW in W's
    dtype) against jax.vmap of the Pallas layer with the adjacency
    unmapped; fused_gcn_layer_members_bwd's (dx, dW) against jax.vmap of
    the Pallas backward."""
    jdt, tdt, rtol = DTYPES[dtype]
    x = _problem(4)
    jx, tx = _jx(x, jdt), _tx(x, tdt)
    layer = _vmap(lambda h, adj, w: jax_fused_gcn.fused_gcn_layer(
        h, adj, w, True), "0-0")
    jout, vjp = jax.vjp(lambda h, w: layer(h, jx["adj"], w), jx["h"],
                        jx["w"])
    jdx, jdw = vjp(jx["g"])
    h = tx["h"].requires_grad_(True)
    w = tx["w"].requires_grad_(True)
    out = fused_gcn.fused_gcn_layer_members(h, tx["adj"], w)
    assert type(out.grad_fn).__name__ == "_GcnBackward"
    out.backward(tx["g"])
    assert out.dtype == tdt and h.grad.dtype == tdt and w.grad.dtype == tdt
    assert_close(out, jout, rtol)
    assert_close(h.grad, jdx, rtol)
    assert_close(w.grad, jdw, rtol)
    jbwd, _, jbw = jax.vmap(
        functools.partial(jax_fused_gcn._fused_bwd, True),
        in_axes=((0, None, 0), 0))((jx["h"], jx["adj"], jx["w"]), jx["g"])
    got = fused_gcn.fused_gcn_layer_members_bwd(
        tx["g"], h.detach(), tx["adj"], w.detach())
    for a, b in zip(got, (jbwd, jbw)):
        assert_close(a, b, rtol)


def test_member_wrappers_reject_bad_arguments():
    """A member stack whose weights miss the member axis, and one layer
    handed to the member entry points, raise."""
    x = _tx(_problem(5), torch.float32)
    with pytest.raises(ValueError, match="shapes do not match D"):
        fused_layer.fused_gine_layer_members(
            x["h"], x["adj"], x["cnt"], x["etab"], x["w1"][0], x["b1"],
            x["w2"], x["b2"])
    with pytest.raises(ValueError, match=r"\[M, N, D\]"):
        fused_gcn.fused_gcn_layer_members(x["h"][0], x["adj"], x["w"][0])
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        fused_gcn.fused_gcn_layer(x["h"], x["adj"], x["w"])


# ------------------------------------------------ the lockstep trunk, steps

SMALL = dict(num_layers=2, emb_dim=16, feat_dim=32, tile=64)


@functools.lru_cache(maxsize=None)
def _graphs():
    graphs, _ = featurize_many(synthetic_corpus(40, seed=6), add_hs=True)
    return graphs


def _batch(n=16):
    graphs = _graphs()
    return pack_batch(graphs[:n], spec_for_graphs(graphs, n, tile=64)).to(
        "cpu")


def _members(gnn, normalize=False, drop=0.3, m=M):
    return [FineTuneNet(generator=torch.Generator().manual_seed(7 + i),
                        gnn_type=gnn, normalize_gcn=normalize,
                        drop_ratio=drop, **SMALL) for i in range(m)]


def _masks(batch, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand(batch.num_nodes, SMALL["emb_dim"], generator=gen)
            < 0.7 for _ in range(SMALL["num_layers"])]


def _counting(monkeypatch, name):
    """Count the calls of layers.<name> (the member-axis entry points)."""
    calls = []
    inner = getattr(layers, name)

    def counted(*args):
        calls.append(args[0].shape[0])
        return inner(*args)

    monkeypatch.setattr(layers, name, counted)
    return calls


@pytest.mark.parametrize("gnn,normalize", [("gin", False), ("gcn", False),
                                           ("gcn", True)])
def test_member_trunks_equal_each_trunk(monkeypatch, gnn, normalize):
    """member_trunks in training mode (each member its own keep masks) and
    in eval mode: each member's node embeddings, and after a backward of
    their sum each parameter's gradient, equal those of the member's own
    trunk bit for bit; one member-axis call per layer over all members.
    One member, drop_ratio 0 (the BN-chained trunk) and tile 0 leave each
    member to its own trunk."""
    fwd = ("fused_gine_layer_members" if gnn == "gin"
           else "fused_gcn_layer_members")
    calls = _counting(monkeypatch, fwd)
    batch = _batch()
    models = _members(gnn, normalize)
    alone = copy.deepcopy(models)
    masks = [_masks(batch, 20 + m) for m in range(M)]
    for train in (True, False):
        for model in models + alone:
            model.train(train)
        del calls[:]
        got = member_trunks(models, batch, masks if train else None)
        assert calls == [M] * SMALL["num_layers"]
        for m, (model, h) in enumerate(zip(alone, got)):
            want = model.trunk(batch, masks[m] if train else None)
            assert torch.equal(h, want), (train, m)
            if train:
                want.float().mul(m + 1).sum().backward()
        if train:
            sum(h.float().mul(m + 1).sum()
                for m, h in enumerate(got)).backward()
    for model, ref in zip(models, alone):
        for (name, p), q in zip(model.named_parameters(), ref.parameters()):
            assert (p.grad is None) == (q.grad is None), name
            assert p.grad is None or torch.equal(p.grad, q.grad), name
    for other in ([models[0]], _members(gnn, normalize, drop=0.0),
                  [FineTuneNet(gnn_type=gnn, drop_ratio=0.3,
                               **dict(SMALL, tile=0)) for _ in range(2)]):
        assert member_trunks(other, batch) == [None] * len(other)


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_ensemble_train_step_equals_members_alone(monkeypatch, gnn):
    """Two train_steps of a 3-seed ensemble at dropout 0.3 (one two-group
    Adam, one member-axis call per layer) against each member stepped
    alone under its own Adam with its seed's masks: losses, parameters and
    BatchNorm stats bit for bit."""
    fwd = ("fused_gine_layer_members" if gnn == "gin"
           else "fused_gcn_layer_members")
    calls = _counting(monkeypatch, fwd)
    batch = _batch()
    labels = torch.from_numpy(
        np.random.RandomState(9).randint(0, 2, batch.num_graphs)
        .astype(np.float32))
    models = _members(gnn)
    alone = copy.deepcopy(models)
    opt = two_group_adam(models, 5e-4, 1e-4, 1e-6)
    opts = [two_group_adam(model, 5e-4, 1e-4, 1e-6) for model in alone]
    for step in range(2):
        masks = [_masks(batch, 100 * step + s) for s in range(M)]
        del calls[:]
        together = train_step(models, opt, batch, labels, (), "ce", masks,
                              n_seeds=M)
        assert calls == [M] * SMALL["num_layers"]
        for m, (model, o) in enumerate(zip(alone, opts)):
            loss = train_step([model], o, batch, labels, (), "ce",
                              [masks[m]])
            assert torch.equal(loss[0], together[m])
    for model, ref in zip(models, alone):
        sa, sb = model.state_dict(), ref.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
