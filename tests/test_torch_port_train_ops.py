"""The PyTorch port's training ops against the JAX package, on the CPU, at
small sizes: the K1 layer's VJP (residual forward, plain backward, the
autograd.Function), the embedding lookup's one-hot backward, the NT-Xent
closed form and the K2 kernels' plain versions, and the GCN layer's guard
on a device without its backward kernel.

JAX runs its Pallas kernels in interpreter mode, as its own tests do.
Tolerances, unless a test says otherwise: f32 max|port - jax| <= 1e-5 *
max(1, max|jax|) (sums taken in another order); bf16 3e-2 of max|jax|
(one bf16 ulp is 2^-8 ~ 4e-3; an intermediate may round the other way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.losses import nt_xent_loss as jax_nt_xent_loss
from molclr_tpu.ops import fused_layer as jax_fused_layer
from molclr_tpu.ops import scatter_free as jax_scatter_free
from molclr_tpu.ops.pallas_ntxent import nt_xent_pallas as jax_nt_xent_pallas
from molclr_tpu_torch import losses
from molclr_tpu_torch.ops import fused_gcn, fused_layer, ntxent
from molclr_tpu_torch.ops.scatter_free import embed_lookup

RTOL = 1e-5
BF16_RTOL = 3e-2
ACT = {"h", "adj", "cnt", "etab", "w1", "w2", "w", "g", "agg", "mid", "out"}
PARAMS = ("h", "a", "b", "etab", "w1", "b1", "w2", "b2")


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


def _problem(seed, tiles=3, s=16, d=12, padded_rows=0):
    """Random block-diagonal symmetric adjacency with self-loops on real
    rows; the last `padded_rows` rows of every tile are padding. Returns
    the layer's inputs and random cotangents (g, dsums)."""
    rng = np.random.RandomState(seed)
    n = tiles * s
    blocks = []
    for _ in range(tiles):
        a = (rng.rand(s, s) < 0.3).astype(np.float32)
        a = np.maximum(a, a.T)
        np.fill_diagonal(a, 1.0)
        if padded_rows:
            a[s - padded_rows:, :] = 0
            a[:, s - padded_rows:] = 0
        blocks.append(a)
    adj = np.stack(blocks)
    real = np.diagonal(adj, axis1=1, axis2=2).reshape(-1) > 0
    cnt = np.zeros((n, fused_layer.CNT_PAD), np.float32)
    cnt[:, :8] = rng.randint(0, 3, (n, 8))
    cnt[~real] = 0
    etab = np.zeros((fused_layer.CNT_PAD, d), np.float32)
    etab[:8] = 0.3 * rng.randn(8, d)
    x = dict(h=rng.randn(n, d), a=rng.rand(d) + 0.5, b=0.2 * rng.randn(d),
             adj=adj, cnt=cnt, etab=etab, w1=0.2 * rng.randn(d, 2 * d),
             b1=0.1 * rng.randn(2 * d), w2=0.2 * rng.randn(2 * d, d),
             b2=0.1 * rng.randn(d))
    cot = dict(g=rng.randn(n, d), dsums=0.05 * rng.randn(2, d))
    return ({k: np.asarray(v, np.float32) for k, v in x.items()},
            {k: np.asarray(v, np.float32) for k, v in cot.items()}, real)


def _jax_vjp(x, cot, relu_in, dt):
    """Gradients of JAX's fused_gine_bn_layer (interpret mode) w.r.t.
    PARAMS, as numpy f32."""
    jx = {k: jnp.asarray(v, dt if k in ACT else jnp.float32)
          for k, v in x.items()}

    def f(h, a, b, etab, w1, b1, w2, b2):
        return jax_fused_layer.fused_gine_bn_layer(
            h, a, b, jx["adj"], jx["cnt"], etab, w1, b1, w2, b2, relu_in,
            True)

    (out, sums), vjp = jax.vjp(f, *(jx[k] for k in PARAMS))
    grads = vjp((jnp.asarray(cot["g"], dt), jnp.asarray(cot["dsums"])))
    return out, sums, {k: np.asarray(v, np.float32)
                       for k, v in zip(PARAMS, grads)}


def _port_grads(x, cot, relu_in, dt):
    tx = {k: t(v, dt if k in ACT else torch.float32) for k, v in x.items()}
    for k in PARAMS:
        tx[k].requires_grad_(True)
    out, sums = fused_layer.fused_gine_bn_layer(
        *(tx[k] for k in ("h", "a", "b", "adj", "cnt", "etab", "w1", "b1",
                          "w2", "b2")), relu_in)
    torch.autograd.backward([out, sums], [t(cot["g"], dt), t(cot["dsums"])])
    return out, sums, {k: tx[k].grad for k in PARAMS}


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("padded_rows", [0, 5])
def test_fused_gine_bn_layer_vjp_matches_jax(relu_in, padded_rows):
    """The autograd.Function (plain forward with residuals, plain
    backward) against jax.vjp of the Pallas layer, random (g, dsums)."""
    x, cot, _ = _problem(70 + padded_rows, padded_rows=padded_rows)
    jout, jsums, jgrads = _jax_vjp(x, cot, relu_in, jnp.float32)
    out, sums, grads = _port_grads(x, cot, relu_in, torch.float32)
    assert type(out.grad_fn).__name__ == "_GineBNBackward"
    assert_close(out, jout)
    assert_close(sums, jsums)
    for k in PARAMS:
        assert grads[k].dtype == torch.float32, k
        assert_close(grads[k], jgrads[k]), k


def test_fused_gine_bn_layer_vjp_bf16_matches_jax():
    """bf16 activations: the plain backward casts gt, dmid, dagg and dh
    where the Pallas kernel does; the weight gradients come back in the
    parameters' dtype as `_bn_fused_bwd` returns them."""
    x, cot, _ = _problem(80, padded_rows=3)
    _, _, jgrads = _jax_vjp(x, cot, True, jnp.bfloat16)
    _, _, grads = _port_grads(x, cot, True, torch.bfloat16)
    for k in PARAMS:
        want = torch.bfloat16 if k in ACT else torch.float32
        assert grads[k].dtype == want, k
        assert_close(grads[k], jgrads[k], rtol=BF16_RTOL)


def test_padded_rows_are_inert_in_the_backward():
    """With the cotangent zero on padded rows (as the trunk gives it), the
    padded rows' features change no gradient; dh is zero there."""
    x, cot, real = _problem(85, padded_rows=6)
    cot["g"][~real] = 0
    _, _, g0 = _port_grads(x, cot, True, torch.float32)
    x["h"][~real] = 1e3
    _, _, g1 = _port_grads(x, cot, True, torch.float32)
    for k in PARAMS:
        if k == "h":
            assert torch.equal(g0[k][torch.from_numpy(real)],
                               g1[k][torch.from_numpy(real)])
            assert not g0[k][torch.from_numpy(~real)].any()
        else:
            assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("relu_in", [False, True])
def test_residual_forward_matches_jax(relu_in):
    """agg and mid, the residuals K1f writes for K1b, against the Pallas
    forward's residual outputs."""
    x, _, _ = _problem(90)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    ref = jax_fused_layer._bn_run_fwd(
        *(jx[k] for k in ("h", "a", "b", "adj", "cnt", "etab", "w1", "b1",
                          "w2", "b2")), relu_in, True)
    out = fused_layer.fused_gine_bn_layer_fwd(
        *(t(x[k]) for k in ("h", "a", "b", "adj", "cnt", "etab", "w1", "b1",
                            "w2", "b2")), relu_in, residuals=True)
    for got, want in zip(out, ref):
        assert_close(got, want)


def test_bwd_wrapper_runs_the_plain_backward_on_cpu():
    """fused_gine_bn_layer_bwd on CPU tensors is the plain backward and
    launches no kernel; without a gradient the layer skips autograd."""
    x, cot, _ = _problem(95)
    tx = {k: t(v) for k, v in x.items()}
    before = fused_layer.fused_gine_bn_layer_bwd.launches
    out, _, agg, mid = fused_layer.fused_gine_bn_layer_fwd(
        *(tx[k] for k in ("h", "a", "b", "adj", "cnt", "etab", "w1", "b1",
                          "w2", "b2")), True, residuals=True)
    args = (t(cot["g"]), t(cot["dsums"]), tx["h"], tx["a"], tx["b"],
            tx["adj"], tx["cnt"], agg, mid, out, tx["w1"], tx["w2"], True)
    got = fused_layer.fused_gine_bn_layer_bwd(*args)
    want = fused_layer.fused_gine_bn_layer_bwd_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fused_layer.fused_gine_bn_layer_bwd.launches == before
    with torch.no_grad():
        out, _ = fused_layer.fused_gine_bn_layer(
            *(tx[k] for k in ("h", "a", "b", "adj", "cnt", "etab", "w1",
                              "b1", "w2", "b2")), True)
    assert out.grad_fn is None


def test_layers_on_a_device_without_kernels():
    """The guard's wiring, on the meta device (no kernel there): the GCN
    layer raises NotImplementedError when a gradient is needed (K3b is not
    ported; on the card the forward kernel's output would carry no
    gradient) and ValueError otherwise; the GINE layer goes to its
    autograd.Function and stops at the device check."""
    x, _, _ = _problem(96)
    m = {k: t(v).to("meta") for k, v in x.items()}
    gcn = (m["h"], m["a"], m["b"], m["adj"], m["cnt"], m["etab"],
           m["w1"][:, :12].contiguous(), m["b2"], True)
    with pytest.raises(ValueError, match="no kernel"):
        fused_gcn.fused_gcn_bn_layer(*gcn)
    w = gcn[6].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K3b"):
        fused_gcn.fused_gcn_bn_layer(*gcn[:6], w, *gcn[7:])
    with torch.no_grad():
        with pytest.raises(ValueError, match="no kernel"):
            fused_gcn.fused_gcn_bn_layer(*gcn[:6], w, *gcn[7:])
    h = m["h"].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.fused_gine_bn_layer(
            h, *(m[k] for k in ("a", "b", "adj", "cnt", "etab", "w1", "b1",
                                "w2", "b2")), True)


# ------------------------------------------------------------ embedding


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_backward_matches_jax(dtype):
    """One-hot-matmul backward accumulated in f32 (`_embed_bwd`): equal to
    JAX's in f32 and in bf16, where a scatter-add rounding after every
    add (PyTorch's own indexing backward) would not be."""
    rng = np.random.RandomState(3)
    table = rng.randn(5, 8).astype(np.float32)
    idx = rng.randint(0, 5, (300,))
    g = rng.randn(300, 8).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda tb: jax_scatter_free.embed_lookup(
        tb, jnp.asarray(idx)), jnp.asarray(table, jdt))
    (ref,) = vjp(jnp.asarray(g, jdt))
    tb = t(table, tdt).requires_grad_(True)
    out = embed_lookup(tb, torch.from_numpy(idx))
    out.backward(t(g, tdt))
    assert type(out.grad_fn).__name__ == "_EmbedLookupBackward"
    assert tb.grad.dtype == tdt
    assert np.array_equal(tb.grad.float().numpy(),
                          np.asarray(ref, np.float32))


# --------------------------------------------------------------- NT-Xent


def _pairs(seed, b, d=16, dead=0):
    rng = np.random.RandomState(seed)
    zi = rng.randn(b, d).astype(np.float32)
    zj = (zi + 0.5 * rng.randn(b, d)).astype(np.float32)
    mask = np.ones(b, bool)
    if dead:
        mask[rng.choice(b, dead, replace=False)] = False
    return zi, zj, mask


def _port_loss_and_grads(fn, zi, zj, mask, **kw):
    a, b = t(zi).requires_grad_(True), t(zj).requires_grad_(True)
    loss = fn(a, b, 0.1, pair_mask=None if mask is None
              else torch.from_numpy(mask), **kw)
    loss.backward()
    return loss, a.grad, b.grad


def _jax_loss_and_grads(fn, zi, zj, mask, **kw):
    return jax.value_and_grad(
        lambda a, b: fn(a, b, 0.1, pair_mask=None if mask is None
                        else jnp.asarray(mask), **kw),
        argnums=(0, 1))(jnp.asarray(zi), jnp.asarray(zj))


@pytest.mark.parametrize("use_cosine", [True, False])
@pytest.mark.parametrize("dead", [None, 0, 5])
def test_nt_xent_closed_form_matches_jax(use_cosine, dead):
    zi, zj, mask = _pairs(11, 24, dead=dead or 0)
    mask = None if dead is None else mask
    loss, gi, gj = _port_loss_and_grads(losses.nt_xent_loss, zi, zj, mask,
                                        use_cosine=use_cosine)
    jloss, (ji, jj) = _jax_loss_and_grads(jax_nt_xent_loss, zi, zj, mask,
                                          use_cosine=use_cosine)
    assert_close(loss, jloss)
    assert_close(gi, ji)
    assert_close(gj, jj)


@pytest.mark.parametrize("b,dead", [(64, None), (64, 9), (37, None),
                                    (100, 13)])
def test_nt_xent_kernel_plain_matches_jax_pallas(b, dead):
    """The K2 autograd.Function on the CPU (plain forward and backward,
    odd B padded per half to 64 pairs) against nt_xent_pallas in
    interpreter mode and against the closed form."""
    zi, zj, mask = _pairs(12 + b, b, d=32, dead=dead or 0)
    mask = None if dead is None else mask
    before = (ntxent.ntxent_fwd.launches, ntxent.ntxent_bwd.launches)
    loss, gi, gj = _port_loss_and_grads(ntxent.nt_xent_kernel, zi, zj, mask)
    assert before == (ntxent.ntxent_fwd.launches, ntxent.ntxent_bwd.launches)
    jloss, (ji, jj) = _jax_loss_and_grads(jax_nt_xent_pallas, zi, zj, mask,
                                          interpret=True)
    assert_close(loss, jloss)
    assert_close(gi, ji)
    assert_close(gj, jj)
    closed, ci, cj = _port_loss_and_grads(losses.nt_xent_loss, zi, zj, mask)
    assert_close(loss, closed.detach().numpy())
    assert_close(gi, ci.numpy())
    assert_close(gj, cj.numpy())


def test_ntxent_plain_stats_match_jax_kernels():
    """(m, l, pos) and dreps of the plain versions against the Pallas
    kernels' own outputs on the same pre-normalized reps with dead rows."""
    from molclr_tpu.ops import pallas_ntxent as jp

    rng = np.random.RandomState(5)
    n, d = 256, 24
    reps = rng.randn(n, d).astype(np.float32)
    reps /= np.linalg.norm(reps, axis=1, keepdims=True)
    valid = np.ones(n, np.float32)
    valid[[3, 70, 131, 200]] = 0
    valid[[3 + 128, 70 + 128, 131 - 128, 200 - 128]] = 0
    inv_t = np.full((1, 1), 10.0, np.float32)
    jm, jl, jpos = jp._run_fwd(jnp.asarray(reps), jnp.asarray(valid),
                               jnp.asarray(inv_t), 128, True)
    m, l, pos = ntxent.ntxent_fwd(t(reps), t(valid), 10.0)
    live = valid > 0
    for got, want in ((m, jm), (l, jl), (pos, jpos)):
        assert_close(got[torch.from_numpy(live)], np.asarray(want)[live])
    inv_n = np.full((1, 1), 1.0 / valid.sum(), np.float32)
    jd = jp._run_bwd(jnp.asarray(reps), jnp.asarray(valid), jnp.asarray(inv_t),
                     jnp.asarray(inv_n), jm, jl, 128, True)
    dreps = ntxent.ntxent_bwd(t(reps), t(valid), 10.0,
                              torch.tensor(1.0 / valid.sum()), m, l)
    assert_close(dreps, jd)


def test_resolve_ntxent():
    zi, zj, _ = _pairs(13, 2048, d=8)
    auto = losses.resolve_ntxent("auto")
    before = ntxent.ntxent_fwd.launches
    got = auto(t(zi), t(zj), 0.1, True)
    # 2B = 4096 on CPU tensors: the closed form, not the kernel's wrapper
    assert torch.equal(got, losses.nt_xent_loss(t(zi), t(zj), 0.1, True))
    assert ntxent.ntxent_fwd.launches == before
    assert losses.resolve_ntxent("xla") is losses.nt_xent_loss
    assert losses.resolve_ntxent("pallas") is ntxent.nt_xent_kernel
    with pytest.raises(ValueError):
        losses.resolve_ntxent("fused")
