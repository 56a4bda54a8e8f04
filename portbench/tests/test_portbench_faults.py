"""A run with the timed path broken underneath comes out not correct.

Each test drives a tiny CPU version of a cell (``rehearsal.py``) through its
whole traffic module, set-up, window and checks, with one fault planted in the
program, and holds ``correct`` (every check within its limit) false; the
sound run holds it true. The faults an embed cell can have: an answer altered
where it is produced (every batch's rows shifted by one, or only a slide's
last row in its padded tail bucket) and half of the batch left out with the
mean of the rest in its place. The tail-bucket fault reaches one row a slide,
far under the upper quartile that the bf16 cell compares for precision: the
worst patch's relative gap, over sampled patches that include the last rows
of sampled slides, has to catch it.
"""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests import rehearsal

EMBED = ("embed.virchow2_bf16",)


def _failed(ctx) -> set[str]:
    result = harness.traffic_module(ctx.workload["traffic"]["kind"]).run(ctx)
    return {c["name"] for c in result["checks"] if not c["ok"]}


def _roll_rows(inner):
    def forward_device(self, images_u8, replica=0):
        return torch.roll(inner(self, images_u8, replica), 1, dims=0)

    return forward_device


def _half_batch(inner):
    def forward_device(self, images_u8, replica=0):
        half = max(1, images_u8.shape[0] // 2)
        out = inner(self, images_u8[:half], replica)
        rest = out.mean(dim=0, keepdim=True).expand(images_u8.shape[0] - half, -1)
        return torch.cat([out, rest])

    return forward_device


def _tail_last_row(inner):
    """In a bucket padded with blank rows, the last real row gets the first
    blank row's features."""

    def forward_device(self, images_u8, replica=0):
        out = inner(self, images_u8, replica)
        blank = (images_u8.flatten(1) == 0).all(dim=1).nonzero().flatten()
        if len(blank) and blank[0] > 0:
            out = out.clone()
            out[blank[0] - 1] = out[blank[0]]
        return out

    return forward_device


@pytest.mark.parametrize("cell", EMBED)
def test_embed_sound_run_is_correct(cell, monkeypatch, tmp_path):
    assert not _failed(rehearsal.embed_context(cell, monkeypatch, cache=tmp_path))


@pytest.mark.parametrize("fault", [_roll_rows, _half_batch, _tail_last_row],
                         ids=["answer_altered", "half_batch_left_out", "tail_last_row_altered"])
@pytest.mark.parametrize("cell", EMBED)
def test_embed_fault_is_not_correct(cell, fault, monkeypatch, tmp_path):
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor

    monkeypatch.setattr(TorchFeatureExtractor, "forward_device", fault(TorchFeatureExtractor.forward_device))
    ctx = rehearsal.embed_context(cell, monkeypatch, cache=tmp_path)
    if fault is _tail_last_row:
        # the tiny pool's slides hold 6, 9 and 11 patches: at batches of 16
        # every slide ends in a padded bucket, as nearly every slide of the
        # full-size cohort does, whichever slides the window publishes
        ctx.workload["traffic"]["feature_batch_size"] = 16
    failed = _failed(ctx)
    assert "feature_rel_err" in failed, failed
