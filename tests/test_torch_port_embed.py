"""The PyTorch port's serving slice against the JAX package, on the CPU:
MolCLRNet (BN-chained fused trunk, gin and gcn) with weights carried across
by state_dict_from_jax, the checkpoint helpers, and the two embed CLIs on
one .pth file.

Small sizes (tile 32, D 32, 2 layers, feat 64), f32. Tolerance for the
whole model: max|port - jax| <= 1e-4 * max(1, max|jax|) (five products
and a BatchNorm per layer, summed in another order)."""

import jax
import numpy as np
import pytest
import torch

from molclr_tpu.cli import embed as jax_embed
from molclr_tpu.data import featurize_smiles as jax_featurize_smiles
from molclr_tpu.data import pack_batch as jax_pack_batch
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.models import MolCLRNet as JaxMolCLRNet
from molclr_tpu.train.checkpoints import import_torch_params
from molclr_tpu_torch.cli import embed as port_embed
from molclr_tpu_torch.data.featurize import NUM_ATOM_TYPES, featurize_smiles
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import spec_for_graphs
from molclr_tpu_torch.models import MolCLRNet
from molclr_tpu_torch.ops import fused_gcn, fused_layer
from molclr_tpu_torch.train.checkpoints import (
    load_torch_state_dict,
    state_dict_from_jax,
    transfer_state,
)

RTOL = 1e-4
TILE, LAYERS, EMB, FEAT = 32, 2, 32, 64
SMALL = dict(num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT, tile=TILE)


def assert_close(port, ref, rtol=RTOL):
    port = np.asarray(port.detach().numpy() if torch.is_tensor(port)
                      else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    lim = rtol * max(1.0, float(np.abs(ref).max()))
    assert err <= lim, (err, lim)


@pytest.fixture(scope="module")
def batches():
    smiles = synthetic_corpus(24, seed=7)
    gj = [jax_featurize_smiles(s) for s in smiles]
    bj = jax_pack_batch(gj, jax_spec_for_graphs(gj, 24, tile=TILE,
                                                sizing="max"),
                        prefer_native=False)
    gp = [featurize_smiles(s) for s in smiles]
    bp = pack_batch(gp, spec_for_graphs(gp, 24, tile=TILE, sizing="max"))
    return bj, bp


def jax_model_and_vars(gnn, bj):
    """The JAX BN-chained fused model with running stats moved off their
    init by one train-mode step, so eval-mode BatchNorm is not the
    identity."""
    model = JaxMolCLRNet(gnn_type=gnn, fused=True, **SMALL)
    v = model.init(jax.random.PRNGKey(3), bj, train=False)
    _, upd = model.apply(v, bj, train=True, mutable=["batch_stats"])
    return model, {"params": v["params"], "batch_stats": upd["batch_stats"]}


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_molclrnet_eval_matches_jax(batches, gnn):
    bj, bp = batches
    model, v = jax_model_and_vars(gnn, bj)
    hj, zj = model.apply(v, bj, train=False)
    port = MolCLRNet(gnn_type=gnn, **SMALL)
    st = transfer_state(state_dict_from_jax(v["params"], v["batch_stats"]),
                        port)
    expect = {k for k in port.state_dict() if "num_batches" not in k}
    assert st["skipped"] == [] and st["copied"] == len(expect)
    launches = (fused_layer.fused_gine_bn_layer.launches,
                fused_gcn.fused_gcn_bn_layer.launches)
    with torch.no_grad():
        h, z = port.eval()(bp.to("cpu"))
    # the CPU path runs the plain versions and launches no kernel
    assert launches == (fused_layer.fused_gine_bn_layer.launches,
                        fused_gcn.fused_gcn_bn_layer.launches)
    assert h.shape == (bp.num_graphs, FEAT) and z.shape == (bp.num_graphs,
                                                            FEAT // 2)
    assert_close(h, hj)
    assert_close(z, zj)


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_molclrnet_train_mode_matches_jax(batches, gnn):
    """Train mode: BatchNorm statistics from the kernels' moment sums, and
    the running-stat update, agree with the JAX package."""
    bj, bp = batches
    model = JaxMolCLRNet(gnn_type=gnn, fused=True, **SMALL)
    v = model.init(jax.random.PRNGKey(5), bj, train=False)
    (hj, zj), upd = model.apply(v, bj, train=True, mutable=["batch_stats"])
    port = MolCLRNet(gnn_type=gnn, **SMALL)
    transfer_state(state_dict_from_jax(v["params"], v["batch_stats"]), port)
    with torch.no_grad():
        h, z = port.train()(bp.to("cpu"))
    assert_close(h, hj)
    assert_close(z, zj)
    for i in range(LAYERS):
        stats = upd["batch_stats"]["trunk"][f"bn_{i}"]
        assert_close(port.batch_norms[i].running_mean, stats["mean"])
        assert_close(port.batch_norms[i].running_var, stats["var"])


def test_state_dict_from_jax_inverts_import_torch_params():
    """torch state dict -> import_torch_params -> state_dict_from_jax gives
    back every tensor of the reference schema unchanged."""
    for gnn in ("gin", "gcn"):
        port = MolCLRNet(gnn_type=gnn, generator=torch.Generator()
                         .manual_seed(1), **SMALL)
        sd = {k: v for k, v in port.state_dict().items()
              if "num_batches" not in k}
        params, stats = import_torch_params(
            {k: v.numpy() for k, v in sd.items()}, num_layers=LAYERS,
            gnn_type=gnn)
        back = state_dict_from_jax(params, stats)
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k


def test_port_init_uses_reference_schema_and_generator():
    a = MolCLRNet(gnn_type="gin", generator=torch.Generator().manual_seed(4),
                  **SMALL).state_dict()
    b = MolCLRNet(gnn_type="gin", generator=torch.Generator().manual_seed(4),
                  **SMALL).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for key, shape in (("x_embedding1.weight", (NUM_ATOM_TYPES, EMB)),
                       ("gnns.0.mlp.0.weight", (2 * EMB, EMB)),
                       ("gnns.1.mlp.2.weight", (EMB, 2 * EMB)),
                       ("gnns.0.edge_embedding1.weight", (5, EMB)),
                       ("batch_norms.1.running_var", (EMB,)),
                       ("feat_lin.weight", (FEAT, EMB)),
                       ("out_lin.2.weight", (FEAT // 2, FEAT))):
        assert tuple(a[key].shape) == shape, key
    gcn = MolCLRNet(gnn_type="gcn", **SMALL).state_dict()
    assert tuple(gcn["gnns.0.weight"].shape) == (EMB, EMB)
    assert tuple(gcn["gnns.0.edge_embedding2.weight"].shape) == (3, 1)


def test_transfer_state_copies_matching_shapes_only():
    port = MolCLRNet(gnn_type="gin", **SMALL)
    before = port.state_dict()["feat_lin.bias"].clone()
    src = {"x_embedding1.weight": torch.ones(NUM_ATOM_TYPES, EMB),
           "feat_lin.bias": torch.ones(FEAT + 1),         # wrong shape
           "pred_head.0.weight": torch.ones(3, 3)}        # not in the model
    st = transfer_state(src, port)
    assert st["copied"] == 1
    assert sorted(st["skipped"]) == ["feat_lin.bias", "pred_head.0.weight"]
    assert torch.equal(port.x_embedding1.weight, torch.ones(NUM_ATOM_TYPES, EMB))
    assert torch.equal(port.state_dict()["feat_lin.bias"], before)


@pytest.mark.parametrize("option", [dict(tile=0)])
def test_unported_options_raise(option):
    # tile 0 (the ELL trunk) was the last model option the port lacked: it
    # builds now and is held to the JAX package in
    # tests/test_torch_port_options.py (drop_ratio > 0, the unchained
    # trunk, in tests/test_torch_port_finetune.py; normalize_gcn in
    # test_normalize_gcn_matches_jax below); a negative tile, which
    # neither package takes, raises
    assert MolCLRNet(**{**SMALL, **option}).tile == 0
    with pytest.raises(ValueError, match="tile"):
        MolCLRNet(**{**SMALL, "tile": -TILE})


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_normalize_gcn_matches_jax(batches, gnn):
    """normalize_gcn=True builds and agrees with the JAX model in eval and
    in train mode (the GIN trunk ignores the option, as JAX's does; the GCN
    trunk bakes dis_i * dis_j into adj and the norm into the counts)."""
    bj, bp = batches
    model = JaxMolCLRNet(gnn_type=gnn, fused=True, normalize_gcn=True,
                         **SMALL)
    v = model.init(jax.random.PRNGKey(8), bj, train=False)
    (hj, zj), upd = model.apply(v, bj, train=True, mutable=["batch_stats"])
    port = MolCLRNet(gnn_type=gnn, normalize_gcn=True, **SMALL)
    transfer_state(state_dict_from_jax(v["params"], v["batch_stats"]), port)
    with torch.no_grad():
        h, z = port.train()(bp.to("cpu"))
    assert_close(h, hj)
    assert_close(z, zj)
    v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    hj, zj = model.apply(v, bj, train=False)
    with torch.no_grad():
        h, z = port.eval()(bp.to("cpu"))
    assert_close(h, hj)
    assert_close(z, zj)


def _cli_setup(tmp_path, gnn):
    smiles = synthetic_corpus(40, seed=21) + ["C1CC"]      # one unparseable
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(smiles) + "\n")
    port = MolCLRNet(gnn_type=gnn, generator=torch.Generator()
                     .manual_seed(9), **SMALL)
    gp = [featurize_smiles(s) for s in smiles[:16]]
    with torch.no_grad():                                # non-trivial stats
        port.train()(pack_batch(gp, spec_for_graphs(gp, 16, tile=TILE,
                                                    sizing="max")).to("cpu"))
    ckpt = tmp_path / f"{gnn}.pth"
    torch.save(port.state_dict(), ckpt)
    args = ["--checkpoint", str(ckpt), "--model", gnn, "--layers",
            str(LAYERS), "--emb-dim", str(EMB), "--feat-dim", str(FEAT),
            "--batch-size", "16", "--tile", str(TILE), "--cpu"]
    return corpus, args


@pytest.mark.parametrize("gnn,projection", [
    ("gin", False), ("gcn", False), ("gin", True)])
def test_embed_cli_matches_jax_cli(tmp_path, gnn, projection):
    """Both CLIs, from one .pth saved by the port: the same kept rows, the
    same sidecar, and the same embeddings within the model tolerance (the
    JAX CLI runs its unfused trunk, which its own tests hold to the fused
    one)."""
    corpus, args = _cli_setup(tmp_path, gnn)
    args += ["--projection"] if projection else []
    assert port_embed.main([str(corpus), str(tmp_path / "port.npy"),
                            *args]) == 0
    assert jax_embed.main([str(corpus), str(tmp_path / "jax.npy"),
                           *args]) == 0
    emb, ref = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert emb.dtype == np.float32
    assert emb.shape == (40, FEAT // 2 if projection else FEAT)
    assert_close(emb, ref)
    assert ((tmp_path / "port.smiles.txt").read_text()
            == (tmp_path / "jax.smiles.txt").read_text())


def test_embed_cli_skips_molecules_larger_than_the_tile(tmp_path, capsys):
    corpus, args = _cli_setup(tmp_path, "gin")
    big = "C" * (TILE + 3)
    corpus.write_text(corpus.read_text() + big + "\n")
    assert port_embed.main([str(corpus), str(tmp_path / "o.npy"),
                            *args]) == 0
    assert "skipping 1 molecules larger than" in capsys.readouterr().out
    side = (tmp_path / "o.smiles.txt").read_text().splitlines()
    assert big not in side and len(side) == np.load(tmp_path / "o.npy"
                                                    ).shape[0] == 40


def test_embed_cli_errors_on_zero_transferred(tmp_path):
    corpus, args = _cli_setup(tmp_path, "gin")
    bad = tmp_path / "other.pth"
    torch.save({"unrelated.weight": torch.ones(2)}, bad)
    args[args.index("--checkpoint") + 1] = str(bad)
    with pytest.raises(SystemExit):
        port_embed.main([str(corpus), str(tmp_path / "o.npy"), *args])
    assert load_torch_state_dict(str(bad)).keys() == {"unrelated.weight"}
