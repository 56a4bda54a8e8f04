"""Tiny versions of the cells for CPU rehearsals: the same traffic modules, files and
checks at sizes a CPU runs in seconds (narrow models, small slides, short
windows, embed batches of 4 so that a slide spans several), with the
program's zoo entry narrowed to match."""

from __future__ import annotations

import copy
import dataclasses

from portbench import harness

TINY_VIT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96, embedding_dim=128)
TINY_COHORT = dict(width=1024, height=768, levels=5, tile=256, pool=3)


def embed_context(cell: str, monkeypatch, *, seed: int = 7, seconds: float = 1.0, cache=None) -> harness.Context:
    from atlaspatch_tpu_torch.models.encoders import zoo

    cfg = {**harness.config("virchow2"), **TINY_VIT}
    wl = copy.deepcopy(harness.workload(cell))
    wl["traffic"]["cohort"].update(TINY_COHORT)
    wl["traffic"].update(listing=400, warm_slides=1, check_patches=32, check_last_rows=4, feature_batch_size=4)
    entry = zoo.ENTRIES[wl["traffic"]["encoder"]]
    spec = dataclasses.replace(entry.spec, dim=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
                               heads=cfg["num_attention_heads"], mlp_hidden=cfg["intermediate_size"])
    monkeypatch.setitem(zoo.ENTRIES, entry.name,
                        dataclasses.replace(entry, spec=spec, embedding_dim=cfg["embedding_dim"]))
    if cache is not None:
        from portbench.inputs import cohort

        monkeypatch.setattr(cohort, "CACHE", cache)
    return harness.Context(name=cell, workload=wl, config=cfg, seed=seed, seconds=seconds, trace=False,
                           device="cpu")
