"""The PyTorch port's node augmentation against the JAX package, on the CPU.

Augmentation is integer and boolean work: given the JAX package's random
inputs (`_rand_keys(rng_n, N)`, `_hash_salts(rng_b)` with rng_n, rng_b =
split(rng)), the port's node_augment must return JAX's views bit for bit
(tolerance 0). The port's own draws are held to the reference's exact
counts and invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.data import augment as jax_augment
from molclr_tpu.data import featurize_smiles as jax_featurize_smiles
from molclr_tpu.data import pack_batch as jax_pack_batch
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu_torch.data import augment
from molclr_tpu_torch.data.featurize import MASK_ATOM_TYPE, featurize_smiles
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import spec_for_graphs


def _batches(tile, n=24, seed=17, sizing="total"):
    smiles = synthetic_corpus(n, seed=seed) + ["C", "CCCCCCCCCCCC"]
    gj = [jax_featurize_smiles(s) for s in smiles]
    bj = jax_pack_batch(gj, jax_spec_for_graphs(gj, n + 4, tile=tile,
                                                sizing=sizing),
                        prefer_native=False)
    gp = [featurize_smiles(s) for s in smiles]
    spec = spec_for_graphs(gp, n + 4, tile=tile, sizing=sizing)
    return bj, pack_batch(gp, spec).to("cpu"), spec


def _jax_draws(rng, num_nodes):
    rng_n, rng_b = jax.random.split(rng)
    return (torch.from_numpy(np.array(jax_augment._rand_keys(rng_n,
                                                               num_nodes))),
            torch.from_numpy(np.array(jax_augment._hash_salts(rng_b))))


@pytest.mark.parametrize("tile,window", [(32, True), (64, False), (0, True),
                                         (0, False)])
@pytest.mark.parametrize("seed", [0, 5])
def test_node_augment_bit_identical_to_jax(tile, window, seed):
    bj, bp, spec = _batches(tile)
    bw = spec.max_graph_bonds if window else 0
    rng = jax.random.PRNGKey(seed)
    ref = jax_augment.node_augment(bj, rng, tile=tile, bond_window=bw)
    view = augment.node_augment(bp, *_jax_draws(rng, bp.num_nodes),
                                tile=tile, bond_window=bw)
    for f in augment.AUG_DELTA_FIELDS:
        assert np.array_equal(getattr(view, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    # and the untouched fields are the base batch's
    assert view.nbr is bp.nbr and view.graph_mask is bp.graph_mask


def test_mix_keys_bit_identical_to_jax():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 2 ** 31 - 1, 4000).astype(np.int32)
    for salts in (np.array([0, 0]), np.array([2 ** 31 - 2, 12345]),
                  rng.randint(0, 2 ** 31 - 1, 2)):
        ref = jax_augment._mix_keys(jnp.asarray(salts, jnp.int32),
                                    jnp.asarray(ids))
        got = augment._mix_keys(torch.from_numpy(salts),
                                torch.from_numpy(ids))
        assert np.array_equal(got.numpy(), np.asarray(ref))
        assert int(got.min()) >= 0 and int(got.max()) < 1 << 20


def test_ranking_helpers_agree_with_each_other_and_jax():
    """The tile, window and sort rankings give the same ranks on valid
    elements, equal to the JAX package's."""
    bj, bp, spec = _batches(32, n=40, seed=4)
    g = torch.Generator().manual_seed(0)
    key_n = torch.randint(0, 1 << 20, (bp.num_nodes,), generator=g)
    key_n[:7] = key_n[7]                           # ties break by position
    sort_n = augment._segment_ranks(key_n, bp.node_graph, bp.node_mask,
                                    bp.graph_n_nodes)
    tile_n = augment._segment_ranks_tile(key_n, bp.node_graph, bp.node_mask,
                                         32)
    real = bp.node_mask
    assert torch.equal(sort_n[real], tile_n[real])
    ref = jax_augment._segment_ranks_tile(jnp.asarray(key_n.numpy(),
                                                      jnp.int32),
                                          jnp.asarray(bj.node_graph),
                                          jnp.asarray(bj.node_mask), 32)
    assert np.array_equal(tile_n.numpy(), np.asarray(ref))
    key_b = torch.randint(0, 1 << 20, (bp.bond_mask.shape[0],), generator=g)
    sort_b = augment._segment_ranks(key_b, bp.bond_graph, bp.bond_mask,
                                    bp.graph_n_bonds)
    win_b = augment._segment_ranks_window(key_b, bp.bond_graph, bp.bond_mask,
                                          spec.max_graph_bonds)
    assert torch.equal(sort_b[bp.bond_mask], win_b[bp.bond_mask])
    ref = jax_augment._segment_ranks(
        jnp.asarray(key_b.numpy(), jnp.int32), jnp.asarray(bj.bond_graph),
        jnp.asarray(bj.bond_mask), jnp.asarray(bj.graph_n_bonds))
    assert np.array_equal(sort_b.numpy(), np.asarray(ref))


def test_node_augment_invariants():
    """With the port's own draws: max(1, floor(0.25 N)) atoms masked and
    floor(0.25 M) bonds dropped per real graph, both directions of a bond
    together and in the ELL view too; self-loops and padding untouched."""
    _, bp, spec = _batches(32, n=40, seed=9)
    vi, vj = augment.paired_augment(bp, torch.Generator().manual_seed(4),
                                    "node", tile=32,
                                    bond_window=spec.max_graph_bonds)
    assert not torch.equal(vi.atom_type, vj.atom_type)
    for v in (vi, vj):
        masked = (v.atom_type == MASK_ATOM_TYPE) & (bp.atom_type
                                                    != MASK_ATOM_TYPE)
        dead_rows = bp.edge_mask & ~v.edge_mask
        dead_bonds = set(bp.edge_bond[dead_rows].tolist())
        for gi in range(bp.num_graphs):
            if not bp.graph_mask[gi]:
                continue
            n, m = int(bp.graph_n_nodes[gi]), int(bp.graph_n_bonds[gi])
            assert int(masked[bp.node_graph == gi].sum()) == max(1, n // 4)
            bonds = set(torch.nonzero(bp.bond_mask & (bp.bond_graph == gi))
                        [:, 0].tolist())
            assert len(bonds & dead_bonds) == m // 4
        # both directed rows of a dropped bond die together
        assert int(dead_rows.sum()) == 2 * len(dead_bonds)
        assert bool((v.chirality[masked] == 0).all())
        slots = bp.nbr_mask & (bp.nbr_bond < bp.bond_mask.shape[0])
        dropped = torch.tensor([b in dead_bonds for b in
                                bp.nbr_bond[slots].tolist()])
        assert torch.equal(v.nbr_mask[slots], ~dropped)
        assert bool(v.nbr_mask[bp.node_mask, 0].all())
        pad = ~bp.node_mask
        assert torch.equal(v.atom_type[pad], bp.atom_type[pad])


def test_paired_augment_kinds_and_deltas():
    _, bp, _ = _batches(32, n=8, seed=2)
    vi, vj = augment.paired_augment(bp, torch.Generator(), "none")
    assert vi is bp and vj is bp
    for kind in ("subgraph", "mix"):
        with pytest.raises(NotImplementedError):
            augment.paired_augment(bp, torch.Generator(), kind)
    with pytest.raises(ValueError):
        augment.paired_augment(bp, torch.Generator(), "edge")
    v, _ = augment.paired_augment(bp, torch.Generator().manual_seed(1),
                                  "node", tile=32)
    back = augment.apply_view_delta(bp, tuple(
        getattr(v, f) for f in augment.AUG_DELTA_FIELDS))
    for f in augment.AUG_DELTA_FIELDS:
        assert torch.equal(getattr(back, f), getattr(v, f))
    # the same generator seed draws the same views
    w, _ = augment.paired_augment(bp, torch.Generator().manual_seed(1),
                                  "node", tile=32)
    assert torch.equal(w.nbr_mask, v.nbr_mask)
