"""``bench/spans.py`` on a synthetic profile: host operations on the step's
thread and on the autograd engine's, device rows linked to them by
correlation id (each shares its id with the runtime call that launched
it, a child of the launching operation).  Each row gets its span and phase (a forward product, the
head's and a block's backward by sequence number, the recompute, the
optimizer, the autograd thread's fallback, a row under no span, a row
whose launching operation is missing), the spans partition the rows, the
idle gaps go to the innermost span open at their middle, and each reading
is None without a split, where its span was never opened, or where
``model.block`` was opened another number of times."""
import types

import pytest
from torch.autograd import DeviceType

from bench import spans

MAIN, AUTOGRAD = 1, 2


class Profile:
    def __init__(self):
        self.events, self.next_id = [], 1

    def host(self, name, start, end, thread=MAIN, parent=None, seq=-1, fwd_thread=0):
        e = types.SimpleNamespace(
            name=name, id=self.next_id, thread=thread, cpu_parent=parent, sequence_nr=seq,
            fwd_thread=fwd_thread, linked_correlation_id=0, device_type=DeviceType.CPU,
            time_range=types.SimpleNamespace(start=start, end=end), scope=0)
        self.next_id += 1
        self.events.append(e)
        return e

    def row(self, name, start, end, op=None):
        """A device row launched by ``op`` (None: a row whose runtime call
        the profile lost)."""
        e = types.SimpleNamespace(
            name=name, id=self.next_id, thread=0, device_type=DeviceType.CUDA,
            time_range=types.SimpleNamespace(start=start, end=end), is_user_annotation=False)
        self.next_id += 1
        self.events.append(e)
        if op is not None:
            call = self.host("cudaLaunchKernel", op.time_range.start, op.time_range.start,
                             thread=op.thread, parent=op)
            call.id = e.id
        return e


def one_step(block_opened=2):
    """One step of a model of one layer: forward (embed, block, head),
    backward on the autograd thread (the head's node, the block's node
    with the block's recompute inside it, AccumulateGrad), AdamW; one row
    after the step, one row of an operation the profile lost."""
    p = Profile()
    step = p.host("train.step", 0, 100)
    fwd = p.host("train.forward", 0, 40, parent=step)
    emb = p.host("model.embed", 1, 4, parent=fwd)
    p.row("gather", 2, 3, p.host("aten::index", 2, 3, parent=emb, seq=5))
    blk = p.host("model.block", 5, 20, parent=fwd)
    p.row("gemm_block_fwd", 6, 8, p.host("aten::mm", 6, 8, parent=blk, seq=7))
    head = p.host("model.head_loss", 25, 38, parent=fwd)
    p.row("sgemm_head_fwd", 26, 30, p.host("aten::mm", 26, 30, parent=head, seq=9))
    p.host("train.backward", 40, 70, parent=step)
    node = p.host(spans.NODE + "MmBackward0", 41, 50, thread=AUTOGRAD, seq=9, fwd_thread=MAIN)
    p.row("sgemm_head_bwd", 42, 45, p.host("aten::mm", 42, 45, thread=AUTOGRAD, parent=node))
    node = p.host(spans.NODE + "MmBackward0", 51, 65, thread=AUTOGRAD, seq=7, fwd_thread=MAIN)
    if block_opened == 2:
        rec = p.host("model.block", 52, 56, thread=AUTOGRAD, parent=node)
        p.row("gemm_block_rec", 53, 55,
              p.host("aten::mm", 53, 55, thread=AUTOGRAD, parent=rec, seq=3))
    p.row("gemm_block_bwd", 57, 60, p.host("aten::mm", 57, 60, thread=AUTOGRAD, parent=node))
    acc = p.host(spans.NODE + "torch::autograd::AccumulateGrad", 66, 68, thread=AUTOGRAD)
    p.row("copy", 66, 68, p.host("aten::copy_", 66, 68, thread=AUTOGRAD, parent=acc))
    stack = p.host("train.stack_grads", 70, 71, parent=step)
    p.row("cat", 70, 71, p.host("aten::cat", 70, 71, parent=stack))
    adamw = p.host("train.adamw", 72, 90, parent=step)
    p.row("adam_add", 73, 80, p.host("aten::add", 73, 80, parent=adamw))
    write = p.host("train.write_weights", 91, 94, parent=step)
    p.row("write", 91, 93, p.host("aten::copy_", 91, 93, parent=write))
    p.row("step_fill", 95, 96, p.host("aten::fill_", 95, 96, parent=step))
    p.row("read_loss", 101, 103, p.host("aten::copy_", 101, 103))
    p.row("lost", 103, 104)
    # the device's copy of a span, left out of the rows
    p.events.append(types.SimpleNamespace(
        name="train.step", id=p.next_id, thread=0, device_type=DeviceType.CUDA,
        time_range=types.SimpleNamespace(start=0, end=100), is_user_annotation=True))
    return p


def split_of(p, lo=0, hi=104):
    return spans.attribute(p.events, spans.work_rows(p.events), 1, lo, hi)


WHERE = {
    "gather": ("model.embed", "forward"),
    "gemm_block_fwd": ("model.block", "forward"),
    "sgemm_head_fwd": ("model.head_loss", "forward"),
    "sgemm_head_bwd": ("model.head_loss", "backward"),
    "gemm_block_rec": ("model.block", "recompute"),
    "gemm_block_bwd": ("model.block", "backward"),
    "copy": ("train.backward", "backward"),
    "cat": ("train.stack_grads", "optimizer"),
    "adam_add": ("train.adamw", "optimizer"),
    "write": ("train.write_weights", "optimizer"),
    "step_fill": ("train.step", "other"),
    "read_loss": (spans.OUTSIDE, "other"),
    "lost": (spans.OUTSIDE, "other"),
}


@pytest.mark.parametrize("row", sorted(WHERE))
def test_each_row_gets_its_span_and_phase(row):
    split = split_of(one_step())
    got = [key for key, names in split.rows.items() if row in names]
    assert got == [WHERE[row]]


def test_the_labels_partition_the_rows():
    p = one_step()
    split = split_of(p)
    total = sum(r.time_range.end - r.time_range.start for r in spans.work_rows(p.events)) / 1e6
    labels = spans.SPANS + (spans.OUTSIDE,)
    assert sum(split.seconds(lab) for lab in labels) == pytest.approx(total, rel=1e-12)
    assert split.total_seconds() == pytest.approx(total, rel=1e-12)
    assert sum(split.operations(lab) for lab in labels) == len(WHERE)
    assert split.step_share() == pytest.approx(1 / (total * 1e6 - 3))
    assert split.opened == {"train.step": 1, "train.forward": 1, "model.embed": 1,
                            "model.block": 2, "model.head_loss": 1, "train.backward": 1,
                            "train.stack_grads": 1, "train.adamw": 1,
                            "train.write_weights": 1}
    assert split.host["model.block"] == pytest.approx((15 + 4) / 1e6)
    assert "[spans]" in split.line() and "model.block" in split.line()


def test_idle_gaps_go_to_the_innermost_open_span():
    split = split_of(one_step())
    # gaps (us) by their middle: 0-2 model.embed, 3-6 train.forward, 8-26
    # model.block, 30-42 model.head_loss; 45-53, 55-57 (the recompute's block
    # has closed at 56), 60-66 and 68-70 train.backward (a node is no span);
    # 71-73 and 80-91 train.adamw; 93-95 (write_weights closed at 94) and
    # 96-101 train.step
    want = {"model.embed": 2, "train.forward": 3, "model.block": 18, "model.head_loss": 12,
            "train.backward": 8 + 2 + 6 + 2, "train.adamw": 2 + 11, "train.step": 2 + 5}
    assert split.idle == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert sum(split.idle.values()) == pytest.approx((104 - 31) / 1e6)


def test_readings_and_when_they_are_none():
    split = split_of(one_step())
    got = {name: spans.metric(split, name, 1) for name in spans.METRICS}
    assert got["blocks_ms_per_step"] == pytest.approx(1e3 * (2 + 2 + 3) / 1e6)
    assert got["head_loss_ms_per_step"] == pytest.approx(1e3 * (4 + 3) / 1e6)
    assert got["adamw_ms_per_step"] == pytest.approx(1e3 * 7 / 1e6)
    assert got["restack_ms_per_step"] == pytest.approx(1e3 * (1 + 2) / 1e6)
    assert got["blocks_ops_per_step"] == 3 and got["adamw_ops_per_step"] == 1
    # no trace; a span never opened; the block opened another number of
    # times than twice an application
    assert all(spans.metric(None, name, 1) is None for name in spans.METRICS)
    assert spans.metric(split, "restack_ms_per_step", 1) is not None
    del split.opened["train.stack_grads"]
    assert spans.metric(split, "restack_ms_per_step", 1) is None
    assert spans.metric(split, "adamw_ms_per_step", 2) is None
    once = split_of(one_step(block_opened=1))
    assert all(spans.metric(once, name, 1) is None for name in spans.METRICS)


@pytest.mark.parametrize("config,apps", [
    ({"n_layers": 24, "block_pattern": "dense"}, 24),
    ({"n_layers": 48, "block_pattern": "mamba2"}, 48),
    ({"n_layers": 81, "block_pattern": "zamba2", "hybrid_every": 6}, 81 + 13)])
def test_block_applications(config, apps):
    assert spans.applications(config, {}) == apps
    assert spans.applications(config, {"accum_steps": 2}) == 2 * apps

