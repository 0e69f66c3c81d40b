"""The Pretrainer's profiler ranges (molclr_tpu_torch/train/spans.py) and
the --profile-dir trace, on the CPU at tiny sizes: a range is a shared
no-op without a profiler; under torch.profiler a Pretrainer emits its
ranges nested as it runs them; --profile-dir traces the PROFILE_STEPS
steps after the warm-up on the units and the host path, and says so
where the run ends first."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from molclr_tpu_torch.data.synthetic import synthetic_corpus
from molclr_tpu_torch.train import spans
from molclr_tpu_torch.train.config import ModelConfig, PretrainConfig
from molclr_tpu_torch.train.graphed import GRAPH_WARMUP_STEPS
from molclr_tpu_torch.train.pretrain import PROFILE_STEPS, Pretrainer

SMALL = dict(num_layers=2, emb_dim=16, feat_dim=32, tile=32)
STEP_PARTS = {"step.take", "step.views", "step.encode", "step.loss",
              "step.backward", "step.adam"}


def _pretrainer(tmp_path, aug="node", n=120, epochs=2, batch_size=16,
                **kw):
    cfg = PretrainConfig(batch_size=batch_size, epochs=epochs, warm_up=1, aug=aug,
                         valid_size=0.1, seed=0, eval_every_epochs=1,
                         save_every_epochs=100, ckpt_dir=str(tmp_path),
                         model=ModelConfig(**SMALL), **kw)
    return Pretrainer(cfg, "cpu").setup_data(synthetic_corpus(n, seed=4)) \
        .setup_state()


def _ranges(prof) -> list:
    return [e for e in prof.events()
            if e.name.startswith(("pretrain.", "graphed.", "step."))]


def _parent(e):
    """The innermost program range around e (None at the top)."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(
            ("pretrain.", "graphed.", "step.")):
        p = p.cpu_parent
    return p.name if p is not None else None


def _nesting(prof) -> dict:
    """{range: {the innermost program range around it, or None}}."""
    out = {}
    for e in _ranges(prof):
        out.setdefault(e.name, set()).add(_parent(e))
    return out


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    a, b = spans.span("pretrain.dispatch"), spans.span("step.take")
    assert a is b
    with a as got:
        assert got is None


def test_span_under_the_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("step.take"):
            torch.ones(2).add_(1)
    names = [e.name for e in prof.events()]
    assert "step.take" in names
    assert spans.span("step.take") is spans.span("step.views")


@pytest.mark.parametrize("aug", ["node", "subgraph"])
def test_pretrainer_ranges_nest_as_the_trainer_runs_them(tmp_path, aug):
    """The units path's eager steps and a validation pass under the
    profiler: a key window at the top, each step a pretrain.dispatch
    around pretrain.eager_step around the six step parts, and the
    validation's take, views, forward and loss inside pretrain.validate."""
    pre = _pretrainer(tmp_path, aug)
    pre._activate_units(lambda *_: None)
    assert pre._units
    orders = pre._unit_orders(0)[:3]
    pre.validate(0)                      # fills the resident eval stack
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pre._resident_epoch(0, orders, lambda *_: None)
        pre.validate(0)
    got = _nesting(prof)
    assert got["pretrain.keys"] == {None}
    assert got["pretrain.dispatch"] == {None}
    assert got["pretrain.eager_step"] == {"pretrain.dispatch"}
    assert got["pretrain.validate"] == {None}
    for part in STEP_PARTS:
        want = {"pretrain.eager_step"}
        if part != "step.adam" and part != "step.backward":
            want.add("pretrain.validate")
        assert got[part] == want, part
    count = {}
    for e in _ranges(prof):
        count[e.name] = count.get(e.name, 0) + 1
    assert count["pretrain.dispatch"] == count["pretrain.eager_step"] == 3
    assert count["pretrain.keys"] == count["pretrain.validate"] == 1
    n_valid = pre._eval_stack["graph_mask"].shape[0]
    assert count["step.encode"] == 3 + n_valid
    assert not {n for n in got if n.startswith("graphed.")}


@pytest.mark.parametrize("path", ["units", "host"])
def test_profile_dir_traces_the_steps_after_the_warm_up(tmp_path, path):
    """--profile-dir (cfg.profile_dir) starts the profiler after the
    GRAPH_WARMUP_STEPS steps of a run that captures nothing and traces the
    next PROFILE_STEPS steps, with their ranges: on the units path (eager
    on the CPU), and on the host path with graph steps set as on the
    card, where the host path still captures nothing."""
    lines = []
    pre = _pretrainer(tmp_path, n=260, epochs=1,
                      profile_dir=str(tmp_path / "prof"),
                      **({"device_cache_mb": 0} if path == "host" else {}))
    assert pre.steps_per_epoch >= GRAPH_WARMUP_STEPS + PROFILE_STEPS
    if path == "host":
        pre.graph_steps = 1             # as the card resolves it
    pre.train(log=lines.append)
    assert (pre._stack is None) == (path == "host")
    assert f"profiler: tracing from step {GRAPH_WARMUP_STEPS}" in lines
    assert any(f"profiler trace of {PROFILE_STEPS} steps" in str(x)
               for x in lines)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    # the host's ranges (with CUDA activity each also has a device-side
    # annotation, category gpu_user_annotation)
    names = [e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"]
    resident = PROFILE_STEPS if path == "units" else 0
    assert names.count("pretrain.dispatch") == resident
    assert names.count("pretrain.eager_step") == resident
    assert names.count("step.views") == PROFILE_STEPS
    assert names.count("step.adam") == PROFILE_STEPS
    assert "pretrain.validate" not in names


def test_profile_dir_says_when_the_run_ends_before_a_steady_step(
        tmp_path):
    """A run whose steps end within the warm-up writes no trace and logs
    that it wrote none."""
    lines = []
    pre = _pretrainer(tmp_path, n=40, epochs=1, batch_size=32,
                      profile_dir=str(tmp_path / "prof"))
    assert pre.steps_per_epoch < GRAPH_WARMUP_STEPS
    pre.train(log=lines.append)
    assert ("profiler: no step after the warm-up; no trace written"
            in lines)
    assert not (tmp_path / "prof").exists()
