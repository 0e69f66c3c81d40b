"""Host data pipeline: corpus reader, bulk featurization, bucket sizing,
and the epoch iterator.

Port of molclr_tpu/data/loader.py (read_pretrain_smiles, featurize_many,
spec_for_graphs, BatchIterator). Featurization runs the Python chem
layer; the JAX package's C++ featurizer, which its tests hold to exact
parity with it, is not ported yet, nor is its prefetch thread.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from molclr_tpu_torch.data.featurize import MolGraph, featurize_smiles
from molclr_tpu_torch.data.graphs import PackOverflow, PadSpec, pack_batch


def read_pretrain_smiles(path: str) -> list[str]:
    """One SMILES per line, or CSV whose last column is the SMILES
    (ref dataset/dataset.py:46-53)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            out.append(line.split(",")[-1])
    return out


def featurize_many(smiles: list[str], add_hs: bool = False,
                   max_degree: int = 6):
    """Featurize a corpus; returns (graphs, kept_indices). Molecules that
    fail to parse or exceed max_degree are dropped."""
    graphs, kept = [], []
    for i, s in enumerate(smiles):
        g = featurize_smiles(s, add_hs)
        if g is None or (g.n_atoms and g.max_degree > max_degree):
            continue
        graphs.append(g)
        kept.append(i)
    return graphs, kept


def spec_for_graphs(graphs: list[MolGraph], batch_size: int,
                    max_degree: int = 6, slack: float = 1.1,
                    quantile: float = 1.0, tile: int = 0,
                    sizing: str = "total",
                    margin_sigmas: float = 5.0) -> PadSpec:
    """A PadSpec that fits `batch_size` molecules drawn from this corpus.

    sizing='total' sizes capacity for the statistical total of a random
    batch (batch*mean + margin_sigmas*std*sqrt(batch) + the largest
    molecule); sizing='max' for the worst case batch*max(quantile), so
    that EVERY batch_size-subset fits in any order — with tile packing it
    accounts for first-fit fragmentation exactly (ceil(batch /
    floor(tile / max_atoms)) tiles), which sequential packers (cli/embed.py)
    rely on.

    max_degree is a cap: the spec uses the corpus's own maximum degree
    when smaller. tile > 0 requests tile-aligned packing (see PadSpec)."""
    data_max_deg = max((g.max_degree for g in graphs), default=max_degree)
    atoms = np.array([g.n_atoms for g in graphs])
    edges = np.array([g.edge_src.shape[0] for g in graphs])
    max_degree = min(max_degree, max(1, data_max_deg))
    if len(atoms) == 0:
        atoms, edges = np.array([1]), np.array([2])
    max_graph_bonds = int(edges.max()) // 2

    def capacity(x):
        if sizing == "total":
            est = (batch_size * float(x.mean())
                   + margin_sigmas * float(x.std()) * batch_size ** 0.5
                   + float(x.max()))
            return int(np.ceil(est * min(slack, 1.05)))
        a = x.max() if quantile >= 1.0 else np.quantile(x, quantile)
        return int(np.ceil(batch_size * float(a) * slack))

    n_nodes = capacity(atoms)
    n_edges = -(-capacity(edges) // 2) * 2
    if tile:
        max_atoms = int(atoms.max())
        if max_atoms > tile:
            raise ValueError(
                f"corpus has a {max_atoms}-atom molecule > tile {tile}; "
                f"filter molecules with n_atoms > tile before building the "
                f"spec (as cli/embed.py does) or raise the tile size")
        if sizing == "max":
            # exact worst case under first-fit: every tile holds at least
            # floor(tile / max_atoms) molecules regardless of order
            per_tile = max(1, tile // max_atoms)
            n_nodes = (-(-batch_size // per_tile)) * tile
        else:
            # fragmentation headroom: ~ mean molecule size per boundary
            mean_atoms = float(atoms.mean())
            est_tiles = max(1, -(-n_nodes // tile))
            n_nodes += int(np.ceil(est_tiles * mean_atoms * 0.75))
            n_nodes = -(-max(n_nodes, 8) // tile) * tile
        return PadSpec(batch_size, n_nodes, max(n_edges, 8), max_degree,
                       tile, max_graph_bonds=max_graph_bonds)
    return PadSpec(batch_size, max(n_nodes, 8), max(n_edges, 8), max_degree,
                   max_graph_bonds=max_graph_bonds)


@dataclass
class BatchIterator:
    """Epoch iterator yielding (GraphBatch, label_array | None, indices).

    drop_last=True matches the reference pretrain loader contract
    (dataset/dataset.py:179-183) and keeps batch shapes static. On
    PackOverflow the molecule responsible for the violated bound is dropped
    (and the batch padded short) rather than crashing.

    cache_packed=True packs each batch ONCE (epoch 0's molecule shuffle
    fixes the compositions) and later epochs re-yield the cached batches in
    a freshly shuffled ORDER; augmentation runs per step on the device, so
    only the in-batch negative composition is frozen. Epoch shuffles are
    seeded by seed + epoch counter (`set_epoch` for resume)."""

    graphs: list[MolGraph]
    spec: PadSpec
    labels: np.ndarray | None = None
    batch_size: int | None = None
    shuffle: bool = True
    drop_last: bool = True
    seed: int = 0
    cache_packed: bool = False

    def __post_init__(self):
        if self.batch_size is None:
            self.batch_size = self.spec.n_graphs
        self._epoch = 0
        self._cache = None

    def __len__(self) -> int:
        n = len(self.graphs)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _pack_epoch(self, order) -> Iterator:
        n = len(self.graphs)
        stop = (n - n % self.batch_size) if self.drop_last else n
        for lo in range(0, stop, self.batch_size):
            idx = list(order[lo : lo + self.batch_size])
            batch_graphs = [self.graphs[i] for i in idx]
            dropped = 0
            while True:
                try:
                    gb = pack_batch(batch_graphs, self.spec)
                    break
                except PackOverflow as e:
                    # evict the molecule responsible for the violated bound
                    msg = str(e)
                    if "bond" in msg or "edges" in msg:
                        key = [g.edge_src.shape[0] for g in batch_graphs]
                    else:
                        key = [g.n_atoms for g in batch_graphs]
                    drop = int(np.argmax(key))
                    batch_graphs.pop(drop)
                    idx.pop(drop)
                    dropped += 1
            if dropped:
                warnings.warn(
                    f"PackOverflow: dropped {dropped} molecule(s) from a "
                    f"batch (spec {self.spec}); use sizing='max' if every "
                    f"molecule must be kept", stacklevel=2)
            labels = self.labels[idx] if self.labels is not None else None
            yield gb, labels, np.asarray(idx)

    @property
    def cache(self):
        """The packed-batch cache (None until a full epoch has run with
        cache_packed=True)."""
        return self._cache

    def set_epoch(self, epoch: int) -> None:
        """Advance the shuffle stream to `epoch` (resume)."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator:
        if self._cache is not None:
            rng = np.random.RandomState(self.seed + self._epoch)
            self._epoch += 1
            order = rng.permutation(len(self._cache)) if self.shuffle \
                else np.arange(len(self._cache))
            for b in order:
                yield self._cache[b]
            return
        order = np.arange(len(self.graphs))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        if self.cache_packed:
            # install the cache only once the epoch completes: callers also
            # draw single example batches with next(iter(...))
            cache = []
            for item in self._pack_epoch(order):
                cache.append(item)
                yield item
            self._cache = cache
            return
        yield from self._pack_epoch(order)
