"""The PyTorch port's augmentation (node, subgraph, mix) against the JAX
package, on the CPU.

Augmentation is integer and boolean work: given the JAX package's random
inputs (for node `_rand_keys(rng_n, N)`, `_hash_salts(rng_b)` with rng_n,
rng_b = split(rng); for the BFS kinds the start, tie-break and top-up keys,
salts and mix's fractions its functions draw), the port must return JAX's
views bit for bit (tolerance 0), for tile 0, 32 and 64 and BFS strides 1
and 8. The port's own draws are held to the reference's exact counts and
invariants (those of tests/test_augment.py)."""

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
        # the BFS kinds draw two views from the generator, the same views
        # from the same seed
        views = [augment.paired_augment(bp, torch.Generator().manual_seed(3),
                                        kind, tile=32) for _ in range(2)]
        for v, w in zip(*views):
            assert v.nbr is bp.nbr
            for f in augment.AUG_DELTA_FIELDS:
                assert torch.equal(getattr(v, f), getattr(w, f)), (kind, f)
        masked = [(v.atom_type == MASK_ATOM_TYPE) & bp.node_mask
                  for v in views[0]]
        assert bool(masked[0].any()) and bool(masked[1].any()), kind
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


# ----------------------------------------------------- subgraph and mix


def _bfs_batches(tile):
    """A batch with a long chain (times past any stride boundary) and a
    disconnected salt (unreached atoms), as JAX and as the port."""
    smiles = synthetic_corpus(20, seed=17) + ["C" * 25, "CC(=O)[O-].[Na+]",
                                              "C"]
    gj = [jax_featurize_smiles(s) for s in smiles]
    bj = jax_pack_batch(gj, jax_spec_for_graphs(gj, len(smiles), tile=tile,
                                                sizing="max"),
                        prefer_native=False)
    gp = [featurize_smiles(s) for s in smiles]
    spec = spec_for_graphs(gp, len(smiles), tile=tile, sizing="max")
    return bj, pack_batch(gp, spec).to("cpu"), spec


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_views_equal(got, want):
    for f in augment.AUG_DELTA_FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("tile", [0, 32, 64])
@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize("kind", ["subgraph", "mix"])
def test_bfs_kinds_bit_identical_to_jax(tile, stride, kind):
    """Paired and single subgraph / mix views given JAX's draws (the keys
    its functions draw from their rngs, recomputed here with the same
    splits) equal JAX's views bit for bit (tolerance 0)."""
    bj, bp, spec = _bfs_batches(tile)
    n, g, bw = bp.num_nodes, bp.num_graphs, spec.max_graph_bonds
    ri, rj, rs = jax.random.split(jax.random.PRNGKey(3 + stride), 3)
    key_s = _t(jax_augment._rand_keys(rs, n))
    bfs = dict(tile=tile, bfs_stride=stride, max_waves=30)
    if kind == "subgraph":
        key_t = [_t(jax_augment._rand_keys(jax.random.split(r)[1], n))
                 for r in (ri, rj)]
        ref = jax_augment.paired_subgraph_augment(bj, ri, rj, rs, **bfs)
        got = augment.paired_subgraph_augment(bp, key_s, key_t, **bfs)
        single = (jax_augment.subgraph_augment(
            bj, rj, start_rank_slot=1, start_rng=rs, **bfs),
            augment.subgraph_augment(bp, key_s, key_t[1], start_rank_slot=1,
                                     **bfs))
    else:
        views = []
        for r in (ri, rj):
            rf, rs_v, rn, rb = jax.random.split(r, 4)
            views.append((
                _t(jax.random.uniform(rf, (g,), maxval=0.2)),
                _t(jax_augment._rand_keys(jax.random.split(rs_v)[1], n)),
                _t(jax_augment._rand_keys(rn, n)),
                _t(jax_augment._hash_salts(rb))))
        ref = jax_augment.paired_mix_augment(bj, ri, rj, rs, bond_window=bw,
                                             **bfs)
        got = augment.paired_mix_augment(bp, key_s, views, bond_window=bw,
                                         **bfs)
        rf, rs_v, rn, rb = jax.random.split(ri, 4)
        single = (jax_augment.mix_augment(bj, ri, bond_window=bw, **bfs),
                  augment.mix_augment(
                      bp, _t(jax.random.uniform(rf, (g,), maxval=0.2)),
                      *(_t(jax_augment._rand_keys(r, n))
                        for r in jax.random.split(rs_v)),
                      _t(jax_augment._rand_keys(rn, n)),
                      _t(jax_augment._hash_salts(rb)), bond_window=bw, **bfs))
    for v, r in zip(got, ref):
        _assert_views_equal(v, r)
    _assert_views_equal(single[1], single[0])


def _masked(batch, view):
    return (view.atom_type == MASK_ATOM_TYPE) & batch.node_mask


def _dead_bonds(batch, view):
    return set(batch.edge_bond[batch.edge_mask & ~view.edge_mask].tolist())


def _assert_ell_matches_coo(batch, view):
    """Every live ELL slot is alive in the view iff its bond survives in
    the COO view; both directed rows of a bond die together; self-loops
    always survive."""
    dead = _dead_bonds(batch, view)
    rows = batch.edge_mask & ~view.edge_mask
    assert int(rows.sum()) == 2 * len(dead)
    slots = batch.nbr_mask & (batch.nbr_bond < batch.bond_mask.shape[0])
    expect = torch.tensor([b not in dead
                           for b in batch.nbr_bond[slots].tolist()])
    assert torch.equal(view.nbr_mask[slots], expect)
    assert bool(view.nbr_mask[batch.node_mask, 0].all())


@pytest.mark.parametrize("tile", [0, 32])
def test_subgraph_invariants(tile):
    """With the port's own draws and a horizon of max atoms - 1: exactly
    floor(0.25 N) atoms removed per graph, a connected removed set, every
    bond touching a removed atom dropped and no other, ELL = COO, distinct
    start atoms (the views differ), padding untouched."""
    _, bp, _ = _bfs_batches(tile)
    horizon = int(bp.graph_n_nodes.max()) - 1
    vi, vj = augment.paired_augment(bp, torch.Generator().manual_seed(5),
                                    "subgraph", tile=tile,
                                    max_waves=horizon)
    assert not torch.equal(_masked(bp, vi), _masked(bp, vj))
    src, dst = bp.src[bp.edge_mask], bp.dst[bp.edge_mask]
    for v in (vi, vj):
        m = _masked(bp, v)
        for gi in range(bp.num_graphs):
            if not bp.graph_mask[gi]:
                continue
            nodes = set(torch.nonzero(m & (bp.node_graph == gi))[:, 0]
                        .tolist())
            assert len(nodes) == int(bp.graph_n_nodes[gi]) // 4, gi
            if len(nodes) > 1:     # connected over the original bonds
                seen, frontier = {min(nodes)}, [min(nodes)]
                while frontier:
                    u = frontier.pop()
                    for s, d in zip(src.tolist(), dst.tolist()):
                        if s == u and d in nodes and d not in seen:
                            seen.add(d)
                            frontier.append(d)
                assert seen == nodes, gi
        touches = (m[bp.src] | m[bp.dst]) & bp.edge_mask
        assert torch.equal(v.edge_mask, bp.edge_mask & ~touches)
        _assert_ell_matches_coo(bp, v)
        pad = ~bp.node_mask
        assert torch.equal(v.atom_type[pad], bp.atom_type[pad])


@pytest.mark.parametrize("tile", [0, 32])
def test_mix_invariants(tile):
    """With the port's own draws: floor(0.25 N) atoms masked per graph in
    all, at most ceil(0.75 M) bonds alive, every bond touching a removed
    (BFS) atom dead, ELL = COO."""
    _, bp, spec = _bfs_batches(tile)
    horizon = int(bp.graph_n_nodes.max()) - 1
    views = augment.paired_augment(bp, torch.Generator().manual_seed(6),
                                   "mix", tile=tile,
                                   bond_window=spec.max_graph_bonds,
                                   max_waves=horizon)
    for v in views:
        m = _masked(bp, v)
        dead = _dead_bonds(bp, v)
        for gi in range(bp.num_graphs):
            if not bp.graph_mask[gi]:
                continue
            n, nb = int(bp.graph_n_nodes[gi]), int(bp.graph_n_bonds[gi])
            assert int(m[bp.node_graph == gi].sum()) == n // 4, gi
            bonds = set(torch.nonzero(bp.bond_mask & (bp.bond_graph == gi))
                        [:, 0].tolist())
            assert len(bonds - dead) <= -(-3 * nb // 4), gi
        _assert_ell_matches_coo(bp, v)


def test_max_waves_horizon_on_a_long_chain():
    """A 200-atom chain: the corpus-derived horizon (199) removes exactly
    floor(0.25 N) atoms from every start, the old fixed 32 waves cannot
    from some starts (the reference BFS is unbounded)."""
    g = featurize_smiles("C" * 200)
    spec = spec_for_graphs([g], 2, tile=256, sizing="max")
    bp = pack_batch([g], spec).to("cpu")
    short = 0
    for seed in range(12):
        for mw in (199, 32):
            views = augment.paired_augment(
                bp, torch.Generator().manual_seed(seed), "subgraph",
                tile=256, max_waves=mw)
            for v in views:
                n = int(_masked(bp, v).sum())
                if mw == 199:
                    assert n == 50, (seed, n)
                else:
                    short += int(n < 50)
    assert short > 0
