"""The check drives the rest of a run with the timed path broken underneath
and sees `correct` come out false, once for each fault a training cell can
have: a step that returns its state unchanged, and half of each batch left
out with the mean taken over the rest. The cells run on one chip, so there
is no exchange between chips to leave out. The harness's look for a chip is
skipped: the run is on the CPU at a test's size."""
import dataclasses

import pytest
import torch

from bench_port import harness

from conftest import run_tiny, tiny_cell

CELLS = ["flagship-train-unbounded", "cutoff5-train-unbounded"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(name):
    cell = tiny_cell(name)
    _, _, numbers = run_tiny(cell)
    assert harness.judge(numbers, cell.limits), (name, numbers)


def _state_unchanged(monkeypatch):
    from gnnep_tpu_torch.train import loop
    monkeypatch.setattr(loop, "apply_update",
                        lambda params, grads, *a, **k: torch.zeros(()))


def _half_batch(monkeypatch):
    from gnnep_tpu_torch.train import loop
    nll0 = loop.hetero_nll

    def half(model, hyper, batch, y_z, generator, train):
        gm = batch.graph_mask
        keep = (gm.cumsum(0) <= gm.sum() / 2).to(gm.dtype)
        return nll0(model, hyper, dataclasses.replace(
            batch, graph_mask=gm * keep), y_z, generator, train)
    monkeypatch.setattr(loop, "hetero_nll", half)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_training_faults_are_caught(monkeypatch, plant, name):
    cell = tiny_cell(name)
    plant(monkeypatch)
    _, _, numbers = run_tiny(cell)
    assert not harness.judge(numbers, cell.limits), numbers
