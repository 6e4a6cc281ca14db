"""The spans inside the port's train step (``repro_torch.obs.spans``), on
the CPU with tiny models (2 layers of width 64, fp32; zamba2's smoke
config for its shared block):

  * off (no profiler): ``span`` hands back the one shared no-op context,
    and a step opens no ``record_function``;
  * the state after steps under a profiler is bit for bit the state after
    the same steps without one;
  * under a CPU profiler each step opens the spans of the table in
    ``obs/spans.py`` under their parents, ``model.block`` twice a layer
    (forward and recompute), and with ``accum_steps`` 2 two forwards and
    two backwards;
  * the benchmark's attribution (``bench/spans.py``) puts the head's
    backward products down to ``model.head_loss`` and a block's to
    ``model.block`` by the autograd nodes' sequence numbers.
"""
import dataclasses
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models.model import TransformerLM  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.train.optimizer import AdamWSettings, tree_items  # noqa: E402
from repro_torch.train.train_loop import TrainStepBuilder  # noqa: E402

ARCHS = ["internlm2-1.8b", "mamba2-1.3b"]
SPANS = ("train.step", "train.forward", "train.backward", "train.stack_grads", "train.adamw",
         "train.write_weights", "model.embed", "model.block", "model.head_loss")
PARENT = {"train.forward": "train.step", "train.backward": "train.step",
          "train.stack_grads": "train.step", "train.adamw": "train.step",
          "train.write_weights": "train.step", "model.embed": "train.forward",
          "model.head_loss": "train.forward"}


def _cfg(arch):
    cfg = configs.get_smoke_config(arch)
    if arch == "zamba2-7b":
        return dataclasses.replace(cfg, dtype="float32")
    return dataclasses.replace(cfg, n_layers=2, dtype="float32")


def _applications(cfg):
    extra = cfg.n_layers // cfg.hybrid_every if cfg.block_pattern == "zamba2" else 0
    return cfg.n_layers + extra


def _builder(arch, accum_steps=1):
    cfg = _cfg(arch)
    model = TransformerLM(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    builder = TrainStepBuilder(model, AdamWSettings(lr=1e-3, warmup_steps=0),
                               accum_steps=accum_steps)
    return builder, builder.init_state(g)


def _batch(cfg, seed, b=2, s=16):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def _profiled(builder, state, steps, first_seed=10, shapes=False):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=shapes) as prof:
        for i in range(steps):
            state, _ = builder.train_step(state, _batch(builder.cfg, first_seed + i))
    return state, prof.events()


def _span_parent(e):
    p = e.cpu_parent
    while p is not None and p.name not in SPANS:
        p = p.cpu_parent
    return p.name if p is not None else None


def test_off_is_the_shared_noop(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert all(spans.span(name) is spans._OFF for name in SPANS)
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    builder, state = _builder("internlm2-1.8b")
    builder.train_step(state, _batch(builder.cfg, 1))
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("train.step") is not spans._OFF


@pytest.mark.parametrize("arch", ARCHS)
def test_state_under_a_profiler_is_bit_identical(arch):
    plain, s_plain = _builder(arch)
    traced, s_traced = _builder(arch)
    for i in range(2):
        s_plain, _ = plain.train_step(s_plain, _batch(plain.cfg, 10 + i))
    s_traced, _ = _profiled(traced, s_traced, 2)
    for (n, a), (_, b) in zip(plain.model.named_parameters(), traced.model.named_parameters()):
        assert torch.equal(a, b), n
    for which in ("master", "m", "v"):
        for (path, a), (_, b) in zip(tree_items(s_plain.opt[which]),
                                     tree_items(s_traced.opt[which])):
            assert torch.equal(a, b), (which, path)
    assert s_plain.step == s_traced.step == 2


@pytest.mark.parametrize("arch,accum", [("internlm2-1.8b", 1), ("mamba2-1.3b", 1),
                                        ("internlm2-1.8b", 2), ("zamba2-7b", 1)])
def test_span_tree_and_counts_per_step(arch, accum):
    builder, state = _builder(arch, accum)
    steps = 2
    _, events = _profiled(builder, state, steps)
    mine = [e for e in events if e.name in SPANS]
    counts = Counter(e.name for e in mine)
    once = {"train.step": 1, "train.adamw": 1, "train.write_weights": 1}
    per_micro = {"train.forward": 1, "train.backward": 1, "train.stack_grads": 1,
                 "model.embed": 1, "model.head_loss": 1,
                 "model.block": 2 * _applications(builder.cfg)}
    want = {**once, **{k: accum * v for k, v in per_micro.items()}}
    assert counts == {k: steps * v for k, v in want.items()}
    for e in mine:
        if e.name == "model.block":
            assert _span_parent(e) in ("train.forward", "train.backward")
        else:
            assert _span_parent(e) == PARENT.get(e.name), e.name
    blocks = Counter(_span_parent(e) for e in mine if e.name == "model.block")
    assert blocks["train.forward"] == blocks["train.backward"] == counts["model.block"] // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_backward_products_map_to_their_forward_span(arch):
    import types

    from bench import spans as bench_spans

    builder, state = _builder(arch)
    _, events = _profiled(builder, state, 1, shapes=True)
    mms = [e for e in events if e.name == "aten::mm"]
    # one device row a product, launched by a runtime call inside it that
    # shares the row's id, as on a card
    work, calls = [], []
    for i, e in enumerate(mms):
        work.append(types.SimpleNamespace(name=f"mm{e.id}", id=-1 - i,
                                          device_type=DeviceType.CUDA, time_range=e.time_range))
        calls.append(types.SimpleNamespace(name="cudaLaunchKernel", id=-1 - i, cpu_parent=e,
                                           thread=e.thread, device_type=DeviceType.CPU,
                                           time_range=e.time_range, sequence_nr=-1))
    events = list(events) + calls
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    split = bench_spans.attribute(events, work, 1, lo, hi)
    where = {}
    for (label, phase), rows in split.rows.items():
        for name in rows:
            where[int(name[2:])] = (label, phase)

    def under_node(e):
        while e is not None:
            if e.name.startswith("autograd::engine::evaluate_function: "):
                return e
            e = e.cpu_parent
        return None

    model = builder.model
    head = model.embed if model.head is None else model.head
    n_head = 0
    for e in mms:
        node = under_node(e)
        parent = _span_parent(e)
        if node is None:  # a forward product: its own span, forward
            assert where[e.id] == (parent, "forward"), e.input_shapes
        elif parent == "model.block":  # the rematerialised forward
            assert where[e.id] == ("model.block", "recompute")
        else:  # a backward product: the span of its forward product
            shapes = [tuple(s) for s in e.input_shapes if s]
            is_head = any(s[0] == head.shape[0] for s in shapes)
            n_head += is_head
            assert where[e.id] == ("model.head_loss" if is_head else "model.block",
                                   "backward"), (node.name, shapes)
    assert n_head >= 1
    assert sum(n for rows in split.rows.values() for n, _ in rows.values()) == len(mms)
