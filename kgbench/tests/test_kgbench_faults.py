"""Each cell's comparison catches the faults its timed path can have: a run
with the path broken underneath (the look for a card skipped, the rest of
a run driven on the CPU at a tiny size) comes out not correct. One chip,
so no cell has an exchange between chips to leave out."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kgbench import run
from kgbench.tests.tiny import tiny_cell


def unchanged_state(monkeypatch):
    """A step that returns its state unchanged: the loss and its gradient,
    no optimizer step."""
    from kgwas_tpu_torch import kgwas
    from kgwas_tpu_torch.engine import loop

    def step(model, optimizer, x, layouts, batch_idx, y_node, w_node,
             dropout_gen=None):
        optimizer.zero_grad(set_to_none=True)
        loss = loop.batch_loss(model(x, layouts, training=True), batch_idx,
                               y_node, w_node)
        loss.backward()
        return loss.detach()

    monkeypatch.setattr(loop, "train_step", step)
    monkeypatch.setattr(kgwas, "train_step", step)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from kgwas_tpu_torch.engine import loop

    orig = loop.batch_loss
    monkeypatch.setattr(loop, "batch_loss", lambda pred, b, y, w: orig(
        pred, b[:len(b) // 2], y, w))


def later_blocks(monkeypatch, blocks):
    """TrainScan's calls after its first (on the card, the graph's
    replays) replaced by blocks(scan, batch_mat, previous batch_mat)."""
    from kgwas_tpu_torch.engine import loop

    orig = loop.TrainScan.__call__

    def call(self, batch_mat):
        prev = getattr(self, "_fault_prev", None)
        self._fault_prev = batch_mat
        if prev is None:
            return orig(self, batch_mat)
        return blocks(self, batch_mat, prev)

    monkeypatch.setattr(loop.TrainScan, "__call__", call)


def replay_unchanged(monkeypatch):
    """Replayed blocks that leave the state unchanged: their losses, no
    optimizer step."""
    from kgwas_tpu_torch.engine import loop

    def blocks(scan, batch_mat, prev):
        with torch.no_grad():
            pred = scan.model(scan.x, scan.layouts, training=True)
            return torch.stack([loop.batch_loss(
                pred, torch.as_tensor(np.asarray(b)), scan.y_node,
                scan.w_node) for b in batch_mat])

    later_blocks(monkeypatch, blocks)


def stale_batch(monkeypatch):
    """A batch buffer copied at the capture and never again: every replay
    after the first runs the first replay's batches."""
    from kgwas_tpu_torch.engine import loop

    orig = loop.TrainScan.__call__
    first = {}

    def blocks(scan, batch_mat, prev):
        return orig(scan, first.setdefault(id(scan), batch_mat))

    later_blocks(monkeypatch, blocks)


def altered_prediction(monkeypatch):
    """One SNP's prediction altered where predict_all produces it."""
    from kgwas_tpu_torch.kgwas import KGWAS

    orig = KGWAS.predict_all

    def predict_all(self, params=None):
        out = orig(self, params)
        out[len(out) // 2] += 0.05 * abs(out).max() + 1e-3
        return out

    monkeypatch.setattr(KGWAS, "predict_all", predict_all)


def altered_kgwas_p(monkeypatch):
    """One SNP's KGWAS_P altered where the tail produces it."""
    from kgwas_tpu_torch import kgwas

    orig = kgwas.finalize_predictions

    def finalize(lr_uni, pred):
        table, scale = orig(lr_uni, pred)
        table["KGWAS_P"][0] = 0.5 * table["KGWAS_P"][0] + 0.01
        return table, scale

    monkeypatch.setattr(kgwas, "finalize_predictions", finalize)


FAULTS = [("fullkg2m.train", unchanged_state),
          ("fullkg2m.train", half_batch),
          ("fullkg2m.train", replay_unchanged),
          ("fullkg2m.train", stale_batch),
          ("fullkg2m.forward", altered_prediction),
          ("calib50k.seed", unchanged_state),
          ("calib50k.seed", half_batch),
          ("calib50k.seed", replay_unchanged),
          ("calib50k.seed", stale_batch),
          ("calib50k.seed", altered_kgwas_p)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    # the seed of test_harness's sound tiny runs, which come out correct
    res = run.run_cell(workload, 2**31 + 7, 0.2, False, device="cpu",
                       cell=tiny_cell(workload))
    assert res["correct"] is False, res["checks"]
    if fault in (replay_unchanged, stale_batch):
        # the replayed blocks' own numbers catch it
        assert any(c["value"] > c["limit"] for k, c in res["checks"].items()
                   if k.startswith("replay_")), res["checks"]
