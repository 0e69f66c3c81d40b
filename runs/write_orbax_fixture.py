"""Write the Orbax checkpoint fixture of tests/data/orbax/ with the JAX
package, and JAX's embeddings of its SMILES.

    python3 runs/write_orbax_fixture.py [--out tests/data/orbax]

It writes (on the CPU, in about a minute):
  gin/step_0/        a GIN MolCLRNet (2 layers, emb 64, feat 128, tile
                     256) saved as the JAX Pretrainer saves best/step_0:
                     {"params", "batch_stats"} through
                     molclr_tpu.train.checkpoints.save_checkpoint, its
                     running stats drawn away from their initial values
                     so that an eval-mode forward depends on them;
  smiles.txt         a few molecules;
  embeddings.npy     molclr_tpu.cli.embed's output for them from gin/step_0
                     (--cpu, h);
  two_process/step_2/
                     a checkpoint saved by two processes under
                     jax.distributed (one CPU device each): params.sharded
                     is arange(48).reshape(8, 6) f32 sharded over the two
                     processes (two chunks, one written by each), and
                     params.rep arange(5) int32 replicated.
The port reads them without JAX (molclr_tpu_torch/train/orbax.py);
tests/test_torch_port_orbax.py and chip_smoke.py phase 18 hold it to them.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMILES = ["CC(=O)Oc1ccccc1C(=O)O", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
          "CC1(C)S[C@@H]2[C@H](NC(=O)Cc3ccccc3)C(=O)N2[C@H]1C(=O)O",
          "c1ccccc1", "CCO", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
          "O=C(O)CCc1ccccc1", "N#Cc1ccccc1Cl"]
MODEL = dict(num_layers=2, emb_dim=64, feat_dim=128)


def two_process_worker(pid: int, port: int, out: str) -> None:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=pid)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from molclr_tpu.train.checkpoints import save_checkpoint

    mesh = Mesh(np.array(jax.devices()), ("data",))
    full = np.arange(48, dtype=np.float32).reshape(8, 6)
    sharded = jax.make_array_from_callback(
        full.shape, NamedSharding(mesh, P("data")), lambda i: full[i])
    rep = jax.make_array_from_callback(
        (5,), NamedSharding(mesh, P()),
        lambda i: np.arange(5, dtype=np.int32)[i])
    save_checkpoint(out, 2, {"params": {"sharded": sharded, "rep": rep},
                             "step": 2}, force=True)


def write_two_process(out: str) -> None:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(pid), str(port), out],
        cwd=ROOT, env=env) for pid in range(2)]
    for p in procs:
        if p.wait(timeout=300) != 0:
            raise RuntimeError("a two-process writer failed")


def write_model(out: str) -> None:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from molclr_tpu.data.graphs import pack_batch
    from molclr_tpu.data.loader import featurize_many, spec_for_graphs
    from molclr_tpu.models import MolCLRNet
    from molclr_tpu.train.checkpoints import save_checkpoint

    graphs, _ = featurize_many(SMILES)
    spec = spec_for_graphs(graphs, len(graphs), tile=256, sizing="max")
    model = MolCLRNet(gnn_type="gin", tile=256, **MODEL)
    variables = model.init(jax.random.PRNGKey(3),
                           pack_batch(graphs, spec), train=False)
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for bn in stats["trunk"].values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    save_checkpoint(os.path.join(out, "gin"), 0,
                    {"params": params, "batch_stats": stats}, force=True)


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        two_process_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data",
                                                  "orbax"))
    out = os.path.abspath(ap.parse_args().out)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    sys.path.insert(0, ROOT)
    write_model(out)
    with open(os.path.join(out, "smiles.txt"), "w") as f:
        f.write("\n".join(SMILES) + "\n")
    from molclr_tpu.cli.embed import main as jax_embed

    jax_embed([os.path.join(out, "smiles.txt"),
               os.path.join(out, "embeddings.npy"),
               "--checkpoint", os.path.join(out, "gin", "step_0"), "--cpu",
               "--layers", str(MODEL["num_layers"]),
               "--emb-dim", str(MODEL["emb_dim"]),
               "--feat-dim", str(MODEL["feat_dim"])])
    write_two_process(os.path.join(out, "two_process"))
    print(f"wrote the fixture to {out}")


if __name__ == "__main__":
    main()
