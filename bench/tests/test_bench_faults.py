"""A whole run of each cell with the look for a card skipped, at a size a
CPU holds (the cell's configuration cut to 2 layers of width 64 in fp32,
its traffic to 64 tokens a row), under the cell's own limits: the sound
program comes out correct, and ``correct`` comes out false for each fault
a one-card training cell can have, planted in the program underneath the
harness (a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest), and for the control (the reference
computed in fp8 e4m3 in the program's place)."""
import pytest
import torch

from bench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]
SEED = 2**31 + 77


def tiny(name):
    cell = harness.load_cell(name, ROOT)
    c = dict(cell.config, n_layers=2, d_model=64, vocab=500, dtype="float32")
    if c["block_pattern"] == "dense":
        c.update(n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128)
    else:
        c.update(head_dim=16, ssm=dict(c["ssm"], d_state=16, head_dim=16, chunk=32))
    cell.config, cell.traffic = c, dict(cell.traffic, seq=64)
    return cell


def run(cell):
    return harness.run(cell, SEED, 0.2, False, torch.device("cpu"))[0]


@pytest.fixture
def program_step():
    from repro_torch.train.train_loop import TrainStepBuilder

    orig = TrainStepBuilder.train_step
    yield TrainStepBuilder, orig
    TrainStepBuilder.train_step = orig


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(tiny(name))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_caught(name, program_step):
    cls, _ = program_step

    def unchanged(self, state, batch):
        with torch.no_grad():
            _, met = self.model.loss_fn(batch)
        return state, {**met, "grad_norm": torch.zeros(()), "lr": 0.0}

    cls.train_step = unchanged
    res = run(tiny(name))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_is_caught(name, program_step):
    cls, orig = program_step
    cls.train_step = lambda self, state, batch: orig(self, state, harness.half_batch(batch))
    res = run(tiny(name))
    assert not res["correct"], res["checks"]


def control_gaps(cell, seed, dev):
    return harness.readings_gaps(harness.reference(cell, seed, dev, precision="fp8"),
                                 harness.reference(cell, seed, dev))


def caught(cell, gaps):
    return any(gaps[n] > cell.limits[n] for n in harness.NUMBERS
               if cell.limits[n] is not None)


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("internlm2")])
def test_control_in_fp8_is_caught(name):
    """At the CPU's size the dense cells' control is caught under the
    cells' own limits (its loss gap alone reads 1e-3, 5x the limit).
    mamba2's control is caught by its 48 layers' accumulated error (the
    first gradient of a layer's D, 0.137-0.182 at full size against 0.085),
    which 2 layers do not show (0.02-0.10): it is held at full size by
    ``test_control_in_fp8_is_caught_on_the_card``."""
    cell = tiny(name)
    gaps = control_gaps(cell, SEED, torch.device("cpu"))
    assert caught(cell, gaps), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_in_fp8_is_caught_on_the_card(name):
    """The control at the cell's own size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(name, ROOT)
    gaps = control_gaps(cell, SEED, torch.device("cuda", 0))
    assert caught(cell, gaps), gaps


def test_run_without_a_card_prints_no_result(tmp_path):
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                          CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
