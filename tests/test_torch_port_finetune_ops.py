"""The PyTorch port's fine-tuning ops against the JAX package, on the CPU,
at small sizes: the unchained GINE layer (K4f / K4b) and GCN layer (K5f /
K5b), forward and VJP, through their plain versions and their
autograd.Functions; the GCN edge term; MaskedBatchNorm's classic mode;
and dropout against flax's.

JAX runs its Pallas kernels in interpreter mode, as its own tests do.
Tolerances, unless a test says otherwise: f32 max|port - jax| <= 1e-5 *
max(1, max|jax|) (sums taken in another order); bf16 3e-2 of max|jax|
(one bf16 ulp is 2^-8 ~ 4e-3; an intermediate may round the other way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from molclr_tpu.models.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from molclr_tpu.ops import fused_gcn as jax_fused_gcn
from molclr_tpu.ops import fused_layer as jax_fused_layer
from molclr_tpu.ops import tile_dense as jax_tile_dense
from molclr_tpu_torch.models.layers import MaskedBatchNorm
from molclr_tpu_torch.models.nets import dropout
from molclr_tpu_torch.ops import fused_gcn, fused_layer
from molclr_tpu_torch.ops.tile_dense import gcn_edge_term

RTOL = 1e-5
BF16_RTOL = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32, RTOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_RTOL)}
GINE_PARAMS = ("h", "etab", "w1", "b1", "w2", "b2")
F32 = {"b1", "b2"}


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    lim = rtol * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= lim, (err, lim)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))
                            ).to(dtype)


def _problem(seed, tiles=3, s=16, d=12, padded_rows=4):
    """Random block-diagonal symmetric adjacency with self-loops on real
    rows (the last `padded_rows` of each tile are padding), edge counts,
    features, weights, and a random cotangent g."""
    rng = np.random.RandomState(seed)
    n = tiles * s
    adj = np.zeros((tiles, s, s), np.float32)
    for k in range(tiles):
        a = (rng.rand(s, s) < 0.3).astype(np.float32)
        a = np.maximum(a, a.T)
        np.fill_diagonal(a, 1.0)
        a[s - padded_rows:, :] = 0
        a[:, s - padded_rows:] = 0
        adj[k] = a
    real = np.diagonal(adj, axis1=1, axis2=2).reshape(-1) > 0
    cnt = np.zeros((n, fused_layer.CNT_PAD), np.float32)
    cnt[:, :8] = rng.randint(0, 3, (n, 8))
    cnt[~real] = 0
    etab = np.zeros((fused_layer.CNT_PAD, d), np.float32)
    etab[:8] = 0.3 * rng.randn(8, d)
    h = rng.randn(n, d)
    h[~real] = 0
    x = dict(h=h, adj=adj, cnt=cnt, etab=etab,
             w1=0.2 * rng.randn(d, 2 * d), b1=0.1 * rng.randn(2 * d),
             w2=0.2 * rng.randn(2 * d, d), b2=0.1 * rng.randn(d),
             w=rng.randn(d, d) / d ** 0.5, g=rng.randn(n, d))
    return {k: np.asarray(v, np.float32) for k, v in x.items()}


def _jx(x, jdt):
    return {k: jnp.asarray(v, jnp.float32 if k in F32 else jdt)
            for k, v in x.items()}


def _tx(x, tdt):
    return {k: t(v, torch.float32 if k in F32 else tdt) for k, v in x.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gine_layer_forward_matches_jax(dtype):
    """(out, agg, mid), the plain forward with its residuals, against the
    Pallas forward (`_run_fwd`) in interpreter mode."""
    jdt, tdt, rtol = DTYPES[dtype]
    x = _problem(1)
    jx, tx = _jx(x, jdt), _tx(x, tdt)
    keys = ("h", "adj", "cnt", "etab", "w1", "b1", "w2", "b2")
    ref = jax_fused_layer._run_fwd(*(jx[k] for k in keys), True)
    got = fused_layer.fused_gine_layer_fwd(*(tx[k] for k in keys),
                                           residuals=True)
    for a, b in zip(got, ref):
        assert a.dtype == tdt
        assert_close(a, b, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gine_layer_vjp_matches_jax(dtype):
    """The autograd.Function (plain forward with residuals, plain backward)
    against jax.vjp of the Pallas layer: gradients of h, etab, W1, b1, W2,
    b2, in the dtypes `_fused_bwd` returns (the weights' and f32 for the
    biases); none for adj and cnt."""
    jdt, tdt, rtol = DTYPES[dtype]
    x = _problem(2)
    jx, tx = _jx(x, jdt), _tx(x, tdt)

    def f(h, etab, w1, b1, w2, b2):
        return jax_fused_layer.fused_gine_layer(
            h, jx["adj"], jx["cnt"], etab, w1, b1, w2, b2, True)

    jout, vjp = jax.vjp(f, *(jx[k] for k in GINE_PARAMS))
    jgrads = vjp(jx["g"])
    for k in GINE_PARAMS:
        tx[k].requires_grad_(True)
    before = fused_layer.fused_gine_layer_bwd.launches
    out = fused_layer.fused_gine_layer(
        tx["h"], tx["adj"], tx["cnt"], tx["etab"], tx["w1"], tx["b1"],
        tx["w2"], tx["b2"])
    assert type(out.grad_fn).__name__ == "_GineBackward"
    out.backward(tx["g"])
    assert fused_layer.fused_gine_layer_bwd.launches == before
    assert_close(out, jout, rtol)
    for k, jg in zip(GINE_PARAMS, jgrads):
        assert tx[k].grad.dtype == tx[k].dtype, k
        assert_close(tx[k].grad, jg, rtol)


def test_fused_gine_layer_bwd_plain_matches_jax_kernel():
    """The plain backward's six outputs against the Pallas backward
    (`_run_bwd`) on the same residuals."""
    x = _problem(3)
    jx, tx = _jx(x, jnp.float32), _tx(x, torch.float32)
    keys = ("h", "adj", "cnt", "etab", "w1", "b1", "w2", "b2")
    _, agg, mid = jax_fused_layer._run_fwd(*(jx[k] for k in keys), True)
    ref = jax_fused_layer._run_bwd(jx["g"], jx["adj"], jx["cnt"], agg, mid,
                                   jx["w1"], jx["w2"], True)
    got = fused_layer.fused_gine_layer_bwd(
        tx["g"], tx["adj"], tx["cnt"], t(agg), t(mid), tx["w1"], tx["w2"])
    for a, b in zip(got, ref):
        assert_close(a, np.asarray(b).reshape(a.shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gcn_layer_matches_jax(dtype):
    """A @ (x @ W): forward and the VJP in x and W (dW in W's dtype)
    against the Pallas layer in interpreter mode."""
    jdt, tdt, rtol = DTYPES[dtype]
    x = _problem(4)
    jx, tx = _jx(x, jdt), _tx(x, tdt)
    jout, vjp = jax.vjp(
        lambda h, w: jax_fused_gcn.fused_gcn_layer(h, jx["adj"], w, True),
        jx["h"], jx["w"])
    jdx, jdw = vjp(jx["g"])
    h = tx["h"].requires_grad_(True)
    w = tx["w"].requires_grad_(True)
    before = fused_gcn.fused_gcn_layer_bwd.launches
    out = fused_gcn.fused_gcn_layer(h, tx["adj"], w)
    assert type(out.grad_fn).__name__ == "_GcnBackward"
    out.backward(tx["g"])
    assert fused_gcn.fused_gcn_layer_bwd.launches == before
    assert out.dtype == tdt and h.grad.dtype == tdt and w.grad.dtype == tdt
    assert_close(out, jout, rtol)
    assert_close(h.grad, jdx, rtol)
    assert_close(w.grad, jdw, rtol)
    with torch.no_grad():
        lean = fused_gcn.fused_gcn_layer(h, tx["adj"], w)
    assert lean.grad_fn is None and torch.equal(lean, out.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_edge_term_matches_jax(dtype):
    """The scalar edge term from the trunk's packed counts against JAX's
    from the ELL view (the counts are the same integers)."""
    jdt, tdt, rtol = DTYPES[dtype]
    rng = np.random.RandomState(5)
    n, k = 40, 5
    bt = rng.randint(0, 5, (n, k))
    bd = rng.randint(0, 3, (n, k))
    mask = rng.rand(n, k) < 0.6
    e1 = rng.randn(5, 1).astype(np.float32)
    e2 = rng.randn(3, 1).astype(np.float32)
    ref = jax_tile_dense.gcn_edge_term(
        jnp.asarray(e1, jdt), jnp.asarray(e2, jdt), jnp.asarray(bt),
        jnp.asarray(bd), jnp.asarray(mask), None, jdt)
    from molclr_tpu_torch.ops.fused_layer import pack_cnt
    from molclr_tpu_torch.ops.scatter_free import _counts

    w = torch.from_numpy(mask).to(tdt)
    cnt = pack_cnt(_counts(torch.from_numpy(bt), w, 5),
                   _counts(torch.from_numpy(bd), w, 3))
    got = gcn_edge_term(t(e1), t(e2), cnt, tdt)
    assert got.dtype == tdt
    assert_close(got, ref, rtol)


def test_unchained_wrappers_reject_bad_arguments():
    x = _tx(_problem(6), torch.float32)
    with pytest.raises(ValueError, match="does not match D"):
        fused_gcn.fused_gcn_layer(x["h"], x["adj"], x["w1"])
    with pytest.raises(TypeError):
        fused_layer.fused_gine_layer(
            x["h"], x["adj"], x["cnt"], x["etab"], x["w1"].double(),
            x["b1"], x["w2"], x["b2"])
    meta = {k: v.to("meta") for k, v in x.items()}
    with pytest.raises(ValueError, match="no kernel"):
        fused_gcn.fused_gcn_layer(meta["h"], meta["adj"], meta["w"])
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.fused_gine_layer(
            *(meta[k] for k in ("h", "adj", "cnt", "etab", "w1", "b1", "w2",
                                "b2")))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
def test_masked_batchnorm_classic_mode_matches_jax(dtype, train):
    """bn(x, mask): the output (f32 for a bf16 x, as JAX promotes it, and
    zero on masked rows), the gradient of x, and the running stats against
    the JAX MaskedBatchNorm's classic mode."""
    jdt, tdt, rtol = DTYPES[dtype]
    rng = np.random.RandomState(7)
    n, d = 30, 6
    x = (2 * rng.randn(n, d) + 1).astype(np.float32)
    mask = rng.rand(n) < 0.8
    g = rng.randn(n, d).astype(np.float32)
    scale = (rng.rand(d) + 0.5).astype(np.float32)
    bias = (0.1 * rng.randn(d)).astype(np.float32)
    mean0 = (0.1 * rng.randn(d)).astype(np.float32)
    var0 = (rng.rand(d) + 0.5).astype(np.float32)
    jbn = JaxMaskedBatchNorm()
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}

    def f(xx):
        return jbn.apply(variables, xx, jnp.asarray(mask), train,
                         mutable=["batch_stats"])

    jy, upd = f(jnp.asarray(x, jdt))
    _, vjp = jax.vjp(lambda xx: f(xx)[0], jnp.asarray(x, jdt))
    (jdx,) = vjp(jnp.asarray(g, jy.dtype))
    bn = MaskedBatchNorm(d)
    with torch.no_grad():
        bn.weight.copy_(t(scale))
        bn.bias.copy_(t(bias))
        bn.running_mean.copy_(t(mean0))
        bn.running_var.copy_(t(var0))
    bn.train(train)
    tx = t(x, tdt).requires_grad_(True)
    y = bn(tx, torch.from_numpy(mask))
    assert y.dtype == torch.float32 and str(jy.dtype) == "float32"
    assert not y[torch.from_numpy(~mask)].any()
    assert_close(y, jy, rtol)
    y.backward(t(g))
    assert tx.grad.dtype == tdt
    assert_close(tx.grad, jdx, rtol)
    assert_close(bn.running_mean, upd["batch_stats"]["mean"])
    assert_close(bn.running_var, upd["batch_stats"]["var"])


def test_dropout_matches_flax_given_its_mask():
    """dropout with flax's keep mask (recovered from flax's output: x has
    no zero) gives flax's output, in f32 and bf16; drawn from a generator
    it keeps about 1 - rate of the elements."""
    rng = np.random.RandomState(8)
    x = rng.randn(50, 7).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = nn.Dropout(0.3).apply({}, jnp.asarray(x, jdt),
                                    deterministic=False,
                                    rngs={"dropout": key})
        keep = torch.from_numpy(np.asarray(ref, np.float32) != 0)
        got = dropout(t(x, tdt), 0.3, keep)
        assert got.dtype == tdt
        assert np.array_equal(got.float().numpy(),
                              np.asarray(ref, np.float32))
    gen = torch.Generator().manual_seed(0)
    drawn = dropout(torch.ones(200, 100), 0.3, generator=gen)
    kept = float((drawn != 0).float().mean())
    assert abs(kept - 0.7) < 0.01
    assert torch.allclose(drawn[drawn != 0], torch.tensor(1 / 0.7))
