"""How the redesigned K2f and K2b cut the NT-Xent similarity, held to
their sources and to JAX, on the CPU.

`ntxent.ntxent_plan` gives both kernels one block per (64-row tile, column
split), a split being a contiguous run of 64-column tiles; K2f's blocks
leave per-split row statistics that a merge combines (K2b's leave partial
dreps that a fixed-order sum adds). Here:

  * the plan covers every (row, column) pair once, gives at least one full
    wave of blocks on 78, 114 and 132 SMs at 2B = 1,024 and 4,096 and no
    more than one, and fits shared memory, the same for any D (the
    kernels take any D, as the Pallas kernels do);
  * the plain mirror of the split merge (`split_stats_plain`,
    `merge_stats_plain`) agrees with JAX's `_run_fwd` in interpreter mode
    within 1e-5 of max(1, max|jax|) (the splits add l in another order),
    with dead pairs and with a split whose columns are all dead, keeping
    every row's (m, l, pos) finite, so the backward from the merged statistics
    (the plain K2b) agrees with JAX's `_run_bwd` with no NaN;
  * the tiling constants and the ctypes signatures of `ntxent_fwd` /
    `ntxent_bwd` are those of csrc/ntxent.cu.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.ops import pallas_ntxent as jp
from molclr_tpu_torch.ops import ntxent

RTOL = 1e-5
SOURCE = Path(ntxent.__file__).resolve().parent.parent / "csrc" / "ntxent.cu"
# shared memory an H100 block may use, and an SM's (1 KB of it reserved
# for each resident block)
BLOCK_SMEM, SM_SMEM = 232_448, 233_472


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    err = float(np.abs(got - want).max())
    lim = RTOL * max(1.0, float(np.abs(want).max()))
    assert err <= lim, (err, lim)


@pytest.mark.parametrize("n", [128, 256, 384, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("sms", [78, 114, 132])
def test_plan_covers_every_pair_once(n, sms):
    """Row tiles cover the rows once; the splits' runs are non-empty,
    contiguous, in order, at most tiles_per_split long, and cover the
    column tiles once."""
    plan = ntxent.ntxent_plan(n, sms)
    tiles = n // ntxent.BLK
    assert plan["rows"] == ntxent.BLK and tiles * plan["rows"] == n
    runs = plan["runs"]
    assert len(runs) == plan["splits"]
    covered = [t for a, b in runs for t in range(a, b)]
    assert covered == list(range(tiles))
    assert all(0 < b - a <= plan["tiles_per_split"] for a, b in runs)
    assert all(a == s * plan["tiles_per_split"] for s, (a, _) in
               enumerate(runs))


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("sms", [78, 114, 132])
def test_plan_fills_the_card(n, sms):
    """At least one block per SM, and no more blocks than one wave of
    FWD_BLOCKS_PER_SM on each."""
    plan = ntxent.ntxent_plan(n, sms)
    blocks = n // ntxent.BLK * plan["splits"]
    assert sms <= blocks <= ntxent.FWD_BLOCKS_PER_SM * sms, blocks


def test_plan_fits_shared_memory():
    """Both kernels fit a block's shared memory, the same for any D (rows
    and columns stream through the ring), and FWD_BLOCKS_PER_SM K2f blocks
    and two K2b blocks fit an SM."""
    plan = ntxent.ntxent_plan(4096)
    assert plan["smem_fwd"] <= BLOCK_SMEM and plan["smem_bwd"] <= BLOCK_SMEM
    assert ntxent.FWD_BLOCKS_PER_SM * (plan["smem_fwd"] + 1024) <= SM_SMEM
    assert 2 * (plan["smem_bwd"] + 1024) <= SM_SMEM


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_tiling_matches_the_kernel_source():
    """BLK, KC, STAGES, BWD_KC, BWD_STAGES, DO, PC and FWD_BLOCKS_PER_SM,
    with which ntxent_plan works, are the constants of csrc/ntxent.cu, and
    the plan's shared memory is the kernels' (which the C entry points
    check again)."""
    src = SOURCE.read_text()
    assert _constexpr(src, "RB") == _constexpr(src, "CB") == ntxent.BLK
    names = ("KC", "NS", "BKC", "BNS", "DO", "PC")
    assert tuple(_constexpr(src, k) for k in names) == (
        ntxent.KC, ntxent.STAGES, ntxent.BWD_KC, ntxent.BWD_STAGES,
        ntxent.DO, ntxent.PC)
    assert re.search(r"__launch_bounds__\(FWD_NT, (\d+)\)", src).group(1) \
        == str(ntxent.FWD_BLOCKS_PER_SM)
    blk = ntxent.BLK
    stage = 2 * blk * (ntxent.KC + 4)
    bwd_stage = max(2 * blk * (ntxent.BWD_KC + 4),
                    ntxent.PC * (ntxent.DO + 4))
    plan = ntxent.ntxent_plan(1024)
    assert plan["smem_fwd"] == 4 * ntxent.STAGES * stage
    assert plan["smem_bwd"] == 4 * (ntxent.BWD_STAGES * bwd_stage
                                    + blk * (blk + 4))


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("entry", sorted(ntxent.ARGTYPES))
def test_bindings_match_the_entry_points(entry):
    """The wrapper's ctypes signature is the C entry point's parameter
    list: pointers as c_void_p, then ints and floats as themselves."""
    src = SOURCE.read_text()
    head = re.search(rf"int {entry}\(([^)]*)\)", src)
    assert head, entry
    params = [" ".join(p.split()) for p in head.group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else _C_TYPES[p.split()[-2]]
             for p in params]
    assert kinds == ntxent.ARGTYPES[entry], params
    assert params[-1] == "void* stream"


def _reps(n, d, seed):
    rng = np.random.RandomState(seed)
    reps = rng.randn(n, d).astype(np.float32)
    return reps / np.linalg.norm(reps, axis=1, keepdims=True)


@pytest.mark.parametrize("case", ["live", "dead_pairs", "dead_split"])
@pytest.mark.parametrize("sms", [8, 132])
def test_split_merge_matches_jax(case, sms):
    """The plain mirror of K2f's splits and merge on the plan's runs (n =
    512: 4 runs of 2 tiles on 8 SMs, 8 of 1 on 132) against JAX's Pallas
    forward in interpreter mode; every row finite; the plain backward from
    the merged statistics against JAX's backward."""
    n, d, inv_t = 512, 24, 10.0
    plan = ntxent.ntxent_plan(n, sms)
    assert plan["splits"] == {8: 4, 132: 8}[sms]
    reps = _reps(n, d, sms + len(case))
    valid = np.ones(n, np.float32)
    if case == "dead_pairs":
        pairs = np.random.RandomState(1).permutation(n // 2)[:19]
        valid[pairs] = valid[pairs + n // 2] = 0
    dead_run = plan["runs"][1]
    if case == "dead_split":
        # every pair that has a column in the second split is dead
        cols = np.arange(dead_run[0] * ntxent.BLK, dead_run[1] * ntxent.BLK)
        valid[cols % (n // 2)] = valid[cols % (n // 2) + n // 2] = 0
    tr, tv = torch.from_numpy(reps), torch.from_numpy(valid)
    m_s, l_s, pos_s = ntxent.split_stats_plain(tr, tv, inv_t, plan)
    assert m_s.shape == (plan["splits"], n)
    if case == "dead_split":
        width = (dead_run[1] - dead_run[0]) * ntxent.BLK
        assert torch.all(m_s[1] == ntxent.NEG)
        assert torch.all(l_s[1] == width)
    m, l, pos = ntxent.merge_stats_plain(m_s, l_s, pos_s)
    for x in (m, l, pos):
        assert torch.isfinite(x).all()
    assert torch.all(l >= 1.0)

    jv = jnp.asarray(valid)
    jt = jnp.full((1, 1), inv_t, jnp.float32)
    jm, jl, jpos = jp._run_fwd(jnp.asarray(reps), jv, jt, 128, True)
    live = valid > 0
    lt = torch.from_numpy(live)
    for got, want in ((m, jm), (l, jl), (pos, jpos)):
        _close(got[lt], np.asarray(want)[live])
    _close(ntxent.masked_mean(m, l, pos, tv).reshape(1),
           np.asarray(jp._masked_mean(jm, jl, jpos, jv)).reshape(1))

    scale = 1.0 / max(valid.sum(), 1.0)
    dreps = ntxent.ntxent_bwd_plain(tr, tv, inv_t, torch.tensor(scale), m, l)
    assert torch.isfinite(dreps).all()
    jd = jp._run_bwd(jnp.asarray(reps), jv, jt,
                     jnp.full((1, 1), scale, jnp.float32), jm, jl, 128, True)
    _close(dreps, jd)
