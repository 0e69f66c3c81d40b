"""The port's reader of the JAX package's Orbax checkpoints against what
JAX, Orbax and tensorstore write, on the CPU (the port reads them without
any of those packages: molclr_tpu_torch/native/zstd.cpp and
molclr_tpu_torch/train/orbax.py).

- the zstd decoder against frames written by tensorstore's zarr arrays
  (and the zstandard module that Orbax's stack brings): levels 1, 3 and
  19; empty, 1-byte, 100 KB and multi-block (> 128 KB) payloads, random
  and repetitive;
- the OCDBT reader against tensorstore on a store with small nodes (a
  B-tree of several levels) and many versions (a version tree): every
  key of every version;
- every leaf of a JAX Pretrainer's full-state checkpoint and of its
  best/step_0, bit for bit against Orbax's own restore; the committed
  fixture (runs/write_orbax_fixture.py), including a checkpoint written
  by two processes whose sharded leaf is stored in two chunks;
- a FineTuner warm-started from an Orbax directory equal to one
  warm-started from state_dict_from_jax of the same trees;
- cli.embed --checkpoint <dir> --cpu against the JAX package's cli.embed
  on the same directory (tests/test_torch_port_embed.py's tolerance);
- truncated and corrupted files, a zarr3 checkpoint and a manifest that
  names a data file outside the store raise, naming the file.
"""

import os
import shutil
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from molclr_tpu.cli import embed as jax_embed
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.train.checkpoints import load_checkpoint as jax_load
from molclr_tpu.train.config import ModelConfig as JaxModelConfig
from molclr_tpu.train.config import PretrainConfig as JaxPretrainConfig
from molclr_tpu.train.pretrain import Pretrainer as JaxPretrainer
from molclr_tpu_torch.cli import embed as port_embed
from molclr_tpu_torch.native import zstd
from molclr_tpu_torch.train import checkpoints as ckpt_lib
from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig
from molclr_tpu_torch.train.finetune import FineTuner
from molclr_tpu_torch.train.orbax import MANIFEST_MAGIC, OcdbtStore, \
    OrbaxFormatError, _Cursor, _file_table, read_step_dir

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "orbax"
FIXTURE_MODEL = dict(num_layers=2, emb_dim=64, feat_dim=128)
EMBED_RTOL = 1e-4      # tests/test_torch_port_embed.py's RTOL


# ------------------------------------------------------------------ zstd


def _payload(kind: str) -> bytes:
    rng = np.random.default_rng(len(kind))
    return {"empty": b"", "one": b"\x07",
            "random100k": rng.bytes(100_000),
            "repeat100k": b"molclr-" * (100_000 // 7),
            "random300k": rng.bytes(300_000),
            "floats300k": (rng.standard_normal(75_000) * 0.01)
            .astype(np.float32).tobytes(),
            "repeat300k": bytes(range(256)) * 1200}[kind]


def _tensorstore_frame(data: bytes, level: int, tmp_path) -> bytes:
    """The zstd frame of a one-chunk uint8 zarr v2 array that tensorstore
    writes (the chunk file as it lies on disk)."""
    path = tmp_path / f"z{level}"
    arr = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": str(path)},
        "metadata": {"dtype": "|u1", "shape": [len(data)],
                     "chunks": [len(data)],
                     "compressor": {"id": "zstd", "level": level}},
        "create": True, "delete_existing": True}).result()
    arr.write(np.frombuffer(data, np.uint8)).result()
    return (path / "0").read_bytes()


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", ["empty", "one", "random100k", "repeat100k",
                                  "random300k", "floats300k", "repeat300k"])
def test_zstd_decodes_what_tensorstore_and_zstandard_write(tmp_path, level,
                                                           kind):
    data = _payload(kind)
    frames = [zstandard.ZstdCompressor(level=level).compress(data),
              zstandard.ZstdCompressor(level=level, write_checksum=True,
                                       write_content_size=False)
              .compress(data)]
    if data:
        frames.append(_tensorstore_frame(data, level, tmp_path))
    for frame in frames:
        assert zstd.decompress(frame) == data
        assert zstd.decompress(frame, len(data)) == data


def test_zstd_frames_one_after_another_and_errors():
    a, b = _payload("repeat100k"), _payload("random100k")
    two = (zstandard.ZstdCompressor(level=3).compress(a)
           + zstandard.ZstdCompressor(level=19).compress(b))
    assert zstd.decompress(two) == a + b
    frame = zstandard.ZstdCompressor(level=3).compress(a)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame[:-9])
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"not a zstd frame")
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame, len(a) - 1)
    assert zstd.crc32c(b"123456789") == 0xE3069283    # the CRC-32C check


# ------------------------------------------------------------------ OCDBT


def test_ocdbt_reader_matches_tensorstore_on_every_version(tmp_path):
    """Small nodes (so the B-tree has interior levels) and a version-tree
    arity of 2 (so old versions live in version-tree nodes): every key of
    every version as tensorstore reads it."""
    root = tmp_path / "store"
    spec = {"driver": "ocdbt", "base": f"file://{root}/"}
    kv = ts.KvStore.open({**spec, "config": {
        "max_decoded_node_bytes": 300, "version_tree_arity_log2": 1,
        "max_inline_value_bytes": 16}}).result()
    for g in range(6):
        txn = ts.Transaction()
        for i in range(15):
            kv.with_transaction(txn)[f"k{g}/{i:03d}"] = (
                f"v{g}.{i}." * (1 + i % 5)).encode()
        txn.commit_async().result()
    store = OcdbtStore(str(root))
    versions = store.all_versions()
    gens = [v["generation"] for v in versions]
    assert gens == list(range(1, len(gens) + 1)) and len(gens) >= 7
    assert store.version_nodes, "no version-tree node was written"
    assert max(v["height"] for v in versions) >= 2
    for v in versions:
        ref = ts.KvStore.open({**spec, "version": v["generation"]}).result()
        got = store.read_all(v)
        keys = ref.list().result()
        assert sorted(got) == sorted(keys), v["generation"]
        for k in keys:
            assert got[k] == ref.read(k).result().value, (v, k)


# ------------------------------------------------- JAX checkpoints, leaves


def _flat(tree, prefix=()):
    """(path, leaf) of a nested tree; None is no leaf (an empty optax state,
    as jax.tree_util flattens it)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", p)))) for p in path)
        out[key] = leaf
    return out


def _assert_bit_exact(path: str):
    """Every leaf of the port's read of `path` equal to Orbax's restore:
    the same paths, dtypes, shapes and bits."""
    mine = dict(_flat(read_step_dir(path)))
    ref = _jax_flat(jax_load(path, None))
    assert set(mine) == set(ref), (set(mine) ^ set(ref))
    for k, want in ref.items():
        got = mine[k]
        if np.ndim(want) == 0 and not isinstance(got, np.ndarray):
            assert got == np.asarray(want).item(), k
            continue
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    return mine


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A short JAX pretraining run: full-state step_<n> checkpoints and
    best/step_0."""
    tmp = tmp_path_factory.mktemp("jaxpre")
    cfg = JaxPretrainConfig(
        batch_size=16, epochs=2, warm_up=1, valid_size=0.1, seed=0,
        featurize_processes=0, save_every_epochs=1, eval_every_epochs=1,
        ckpt_dir=str(tmp / "ck"), model=JaxModelConfig(
            num_layers=2, emb_dim=32, feat_dim=64, tile=32, fused=True))
    pre = JaxPretrainer(cfg).setup_data(synthetic_corpus(120, seed=2))
    pre.setup_state(next(iter(pre.train_iter))[0])
    pre.train(log=lambda *_: None)
    return tmp / "ck"


def test_jax_pretrainer_checkpoints_read_bit_exactly(jax_run):
    steps = sorted(p for p in os.listdir(jax_run) if p.startswith("step_"))
    assert len(steps) == 2
    for name in steps:
        leaves = _assert_bit_exact(str(jax_run / name))
        assert any(k[0] == "opt_state" and "mu" in k for k in leaves)
        assert ("params", "trunk", "conv_1", "mlp_1", "kernel") in leaves
    best = _assert_bit_exact(str(jax_run / "best" / "step_0"))
    assert set(k[0] for k in best) == {"params", "batch_stats"}
    # the newest checkpoint is the one resolve_pretrained picks
    assert ckpt_lib.resolve_pretrained(str(jax_run)) == str(
        jax_run / max(steps, key=lambda s: int(s[5:])))


def test_fixture_reads_bit_exactly_including_two_chunks():
    _assert_bit_exact(str(FIXTURE / "gin" / "step_0"))
    two = FIXTURE / "two_process" / "step_2"
    tree = read_step_dir(str(two))
    np.testing.assert_array_equal(
        tree["params"]["sharded"], np.arange(48, dtype=np.float32)
        .reshape(8, 6))
    assert tree["params"]["sharded"].dtype == np.float32
    np.testing.assert_array_equal(tree["params"]["rep"],
                                  np.arange(5, dtype=np.int32))
    assert tree["step"] == 2
    keys = OcdbtStore(str(two)).read_all()
    assert {b"params.sharded/0.0", b"params.sharded/1.0"} <= set(keys)
    assert sorted(os.listdir(two)).count("ocdbt.process_1") == 1


# ------------------------------------------------ warm start and embed


def test_finetuner_warm_start_from_orbax_equals_state_dict_from_jax(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    step = str(FIXTURE / "gin" / "step_0")
    trees = jax.tree_util.tree_map(np.asarray, jax_load(step, None))
    pth = tmp_path / "from_jax.pth"
    torch.save(ckpt_lib.state_dict_from_jax(trees["params"],
                                            trees["batch_stats"]), pth)
    models = []
    for src in (step, str(pth)):
        cfg = FineTuneConfig(
            task_name="BBBP", data_root=str(tmp_path / "data"),
            synthetic_fallback=True, synthetic_n=60, batch_size=16,
            epochs=1, ckpt_dir=str(tmp_path / "ft"), pretrained=src,
            model=ModelConfig(gnn_type="gin", drop_ratio=0.3, tile=256,
                              **FIXTURE_MODEL))
        with warnings.catch_warnings():
            # the first run fabricates the synthetic task CSV, with a warning
            warnings.simplefilter("ignore", UserWarning)
            ft = FineTuner(cfg, "cpu").setup_data()
        ft.setup_state()
        models.append(ft.models[0].state_dict())
    assert models[0].keys() == models[1].keys()
    for k in models[0]:
        assert torch.equal(models[0][k], models[1][k]), k
    # and the warm start took the checkpoint's trunk and running stats
    assert torch.equal(models[0]["batch_norms.1.running_var"], torch.from_numpy(
        trees["batch_stats"]["trunk"]["bn_1"]["var"]))


def test_cli_embed_from_orbax_matches_jax_cli(tmp_path):
    step = str(FIXTURE / "gin" / "step_0")
    smiles = str(FIXTURE / "smiles.txt")
    args = ["--checkpoint", step, "--cpu", "--layers", "2",
            "--emb-dim", "64", "--feat-dim", "128"]
    assert jax_embed.main([smiles, str(tmp_path / "jax.npy"), *args]) == 0
    assert port_embed.main([smiles, str(tmp_path / "port.npy"), *args]) == 0
    ref = np.load(tmp_path / "jax.npy")
    got = np.load(tmp_path / "port.npy")
    assert got.shape == ref.shape == (8, 128)
    lim = EMBED_RTOL * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= lim
    # the committed embeddings are JAX's of today
    np.testing.assert_array_equal(np.load(FIXTURE / "embeddings.npy"), ref)
    # an architecture that matches nothing transfers zero parameters
    with pytest.raises(SystemExit):
        port_embed.main([smiles, str(tmp_path / "x.npy"), "--checkpoint",
                         step, "--cpu", "--model", "gcn", "--layers", "2",
                         "--emb-dim", "8", "--feat-dim", "16"])


# ------------------------------------------------------------------ errors


def _copy(tmp_path) -> Path:
    dst = tmp_path / "step_0"
    shutil.copytree(FIXTURE / "gin" / "step_0", dst)
    return dst


def test_truncated_and_corrupted_files_raise_naming_them(tmp_path):
    d = _copy(tmp_path)
    manifest = d / "manifest.ocdbt"
    data = manifest.read_bytes()
    manifest.write_bytes(data[:-7])
    with pytest.raises(OrbaxFormatError, match="manifest.ocdbt.*length"):
        read_step_dir(str(d))
    manifest.write_bytes(data)
    node = next((d / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    node.write_bytes(bytes(raw))
    with pytest.raises(OrbaxFormatError, match=f"{node.name}.*crc32c"):
        read_step_dir(str(d))
    d = _copy(tmp_path / "b")
    big = max((d / "ocdbt.process_0" / "d").iterdir(),
              key=lambda p: p.stat().st_size)
    big.write_bytes(big.read_bytes()[:100])
    with pytest.raises(OrbaxFormatError, match=f"{big.name}.*truncated"):
        read_step_dir(str(d))


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


@pytest.mark.parametrize("escape", ["../", "/"])
def test_manifest_path_outside_the_store_raises(tmp_path, escape):
    """A manifest whose data file table names a path that is absolute or
    leaves the store's root is refused before any such file is opened."""
    d = _copy(tmp_path)
    manifest = d / "manifest.ocdbt"
    where = str(manifest)
    body = OcdbtStore(str(d))._envelope(manifest.read_bytes(),
                                         MANIFEST_MAGIC, where)
    c = _Cursor(body, where)
    c.raw(16, "uuid")
    c.varints(3, "kind, inline, node bytes")
    c.fixed(1, "arity")
    if c.varint("compression_method") == 1:
        c.fixed(4, "zstd_level")
    start = c.pos
    files = _file_table(c, "")
    paths = [(escape + p).encode() for p, _ in files]
    table = (_varint(len(paths)) + b"".join(_varint(0) for _ in paths[1:])
             + b"".join(_varint(len(p)) for p in paths)
             + b"".join(_varint(0) for _ in paths) + b"".join(paths))
    body = body[:start] + table + body[c.pos:]
    # the envelope: magic, length, format version 0, no compression, body,
    # crc32c of everything before it
    length = 4 + 8 + 2 + len(body) + 4
    head = (MANIFEST_MAGIC.to_bytes(4, "big") + length.to_bytes(8, "little")
            + _varint(0) + _varint(0))
    raw = head + body
    manifest.write_bytes(raw + zstd.crc32c(raw).to_bytes(4, "little"))
    with pytest.raises(OrbaxFormatError,
                       match="manifest.ocdbt: field 'path_suffix'.*leaves"):
        read_step_dir(str(d))


def test_zarr3_and_unknown_layouts_raise(tmp_path):
    import orbax.checkpoint as ocp

    path = tmp_path / "z3"
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
        path, {"params": {"w": np.ones((3, 2), np.float32)}})
    with pytest.raises(OrbaxFormatError, match="_METADATA.*use_zarr3"):
        read_step_dir(str(path))
    with pytest.raises(OrbaxFormatError, match="_METADATA"):
        read_step_dir(str(tmp_path))
