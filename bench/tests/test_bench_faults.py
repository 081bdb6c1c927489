"""A run on the CPU, past the harness's look for a card, with the timed
path broken underneath: ``correct`` comes out false for each fault a
cell can have, and true with none.

The faults: the aggregation leaves the state unchanged (no message is
summed); half of the edges are left out and the rest doubled (half the
batch, the mean taken over the rest); one answer altered where the last
layer produces it; and, out of core, the rows presented in the store's
ids instead of the caller's.  The exchange between chips does not exist
in these one-chip cells.
"""

from __future__ import annotations

import pytest
import torch

from bench.tests.conftest import run_cell


def _zeros(original):
    def fault(feats, src, w, offsets):
        return torch.zeros((offsets.numel() - 1, feats.shape[1]), dtype=torch.float32)
    return fault


def _half(original):
    def fault(feats, src, w, offsets):
        w = w.clone()
        w[1::2] = 0.0
        w[0::2] *= 2.0
        return original(feats, src, w, offsets)
    return fault


def _alter_graduate(original):
    def fault(x, w, b, activation="relu"):
        out = original(x, w, b, activation)
        if activation == "none":  # the last layer
            out = out.clone()
            out[0, 0] += 1.0
        return out
    return fault


def _alter_update(original):
    def fault(spec, agg):
        out = original(spec, agg)
        if not spec.activation:  # the last layer
            out = out.clone()
            out[0, 0] += 1.0
        return out
    return fault


HBM_FAULTS = {
    "state-unchanged": ("repro_torch.dist.mesh", "segment_reduce_sorted", _zeros),
    "half-the-batch": ("repro_torch.dist.mesh", "segment_reduce_sorted", _half),
    "answer-altered": ("repro_torch.dist.mesh", "fused_graduate", _alter_graduate),
}
OOC_FAULTS = {
    "state-unchanged": ("repro_torch.core.broadcast", "segment_reduce_sorted", _zeros),
    "half-the-batch": ("repro_torch.core.broadcast", "segment_reduce_sorted", _half),
    "answer-altered": ("repro_torch.core.graduation", "layer_update", _alter_update),
    "caller-ids-lost": ("repro_torch.storage.layout:GraphStore", "new_of_old",
                        lambda original: lambda self: None),
}


def _patch(monkeypatch, target: str, name: str, make):
    """``target`` is a module, or ``module:Class``; its ``name`` becomes
    ``make(original)``."""
    import importlib

    module, _, cls = target.partition(":")
    owner = importlib.import_module(module)
    if cls:
        owner = getattr(owner, cls)
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))


@pytest.mark.parametrize("cell", ["gcn-hbm", "sage-hbm", "gcn-hbm-uniform", "sage-ooc"])
def test_a_sound_run_is_correct(small_root, capsys, cell):
    rc, line = run_cell(small_root, cell, capsys)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1


@pytest.mark.parametrize("cell", ["gcn-hbm", "sage-hbm"])
@pytest.mark.parametrize("fault", sorted(HBM_FAULTS))
def test_a_broken_hbm_path_is_not_correct(small_root, capsys, monkeypatch, cell, fault):
    _patch(monkeypatch, *HBM_FAULTS[fault])
    rc, line = run_cell(small_root, cell, capsys)
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("fault", sorted(OOC_FAULTS))
def test_a_broken_out_of_core_path_is_not_correct(small_root, capsys, monkeypatch, fault):
    _patch(monkeypatch, *OOC_FAULTS[fault])
    rc, line = run_cell(small_root, "sage-ooc", capsys)
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1
