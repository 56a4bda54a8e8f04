"""``finetune_sam2(data_parallel=2)`` over two CPU replicas against the
one-device loop, and its resume (see ``tests/test_torch_parallel.py`` for
the setting).
"""

from __future__ import annotations

import numpy as np
import pytest

from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.parallel import mesh
from torch_parallel_helpers import _cpus
from torch_port_helpers import free_tmp_path, key_bias_mask, shared_flax_params  # noqa: F401


# ------------------------------------------------------------------- fine-tuning
FT_COMMON = dict(epochs=2, batch_size=2, device="cpu", seed=1, val_fraction=0.2, augment=True, trainable="all",
                 learning_rate=1e-3)


def _finetune(images, masks, out, **kw):
    from atlaspatch_tpu_torch.models.train import loop

    losses = []
    summary = loop.finetune_sam2(images, masks, out, on_step=lambda s, loss: losses.append(loss), **kw)
    return losses, summary


def _weights(summary) -> dict:
    with np.load(summary["checkpoint"]) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def dp_finetunes(tmp_path_factory):
    """One corpus and init archive; the one-device run and the uninterrupted
    ``--data-parallel 2`` run over two CPU replicas (losses, summary,
    final weights)."""
    import shutil

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.train import loop
    from atlaspatch_tpu_torch.tools import synthetic_corpus

    tmp = tmp_path_factory.mktemp("dp_finetune")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
        images, masks = synthetic_corpus.generate_corpus(tmp / "corpus", n=5, width=256, height=192)
        init = tmp / "init.npz"
        np.savez(init, **_flatten(shared_flax_params(0)))
        common = dict(FT_COMMON, checkpoint=init)
        one = _finetune(images, masks, tmp / "one", **common)
        with pytest.raises(RuntimeError, match="--data-parallel 2 needs that many devices; 1 visible"):
            loop.finetune_sam2(images, masks, tmp / "refused", data_parallel=2, **common)
        mp.setattr(mesh, "local_devices", lambda kind="cuda": _cpus(2))
        dp = _finetune(images, masks, tmp / "dp", data_parallel=2, **common)
        runs = {"one": (*one, _weights(one[1])), "dp": (*dp, _weights(dp[1]))}
    yield images, masks, common, tmp, runs
    shutil.rmtree(tmp, ignore_errors=True)


def test_data_parallel_finetune_follows_one_device(dp_finetunes):
    *_, runs = dp_finetunes
    (one, s1, w1), (dp, s2, w2) = runs["one"], runs["dp"]
    assert len(one) == len(dp) == 4
    np.testing.assert_allclose(dp, one, rtol=2e-3)
    np.testing.assert_allclose([s2["val_loss"], s2["val_iou"]], [s1["val_loss"], s1["val_iou"]], rtol=2e-3)
    # The weights after four updates, each element held to 1e-4 of its
    # tensor's largest. On this corpus the replicas' summation order moves
    # them by at most 7.5e-6 of it, and a step that drops the second
    # replica's gradient moves 201 of the 219 tensors, by up to 3 times it.
    # Left out are the key biases: softmax over the keys does not change
    # when one vector is added to every key, so their exact gradient is
    # zero, what backward gives is rounding noise, and AdamW turns noise of
    # either sign into a step of the learning rate.
    assert sorted(w1) == sorted(w2)
    worst, worst_key = 0.0, None
    for k in w1:
        keep = ~key_bias_mask(k, w1[k].shape)
        if keep.any():
            rel = float(np.abs(w2[k] - w1[k])[keep].max()) / max(float(np.abs(w1[k])[keep].max()), 1e-30)
            worst, worst_key = max((worst, worst_key), (rel, k))
    assert worst < 1e-4, f"--data-parallel 2 weights differ from one device's by {worst} of {worst_key}'s largest"


def test_data_parallel_resume_reproduces_the_uninterrupted_run(dp_finetunes, monkeypatch):
    """Replicas are made after the checkpoint is restored, and each step
    starts from the trainable tensors the update applies to."""
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config

    images, masks, common, tmp, runs = dp_finetunes
    monkeypatch.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
    monkeypatch.setattr(mesh, "local_devices", lambda kind="cuda": _cpus(2))
    full_losses, _, full_w = runs["dp"]
    out = tmp / "dp_resume"
    _finetune(images, masks, out, data_parallel=2, save_every=1, **dict(common, epochs=1))
    losses, summary = _finetune(images, masks, out, data_parallel=2, save_every=1, resume=True, **common)
    assert summary["resumed_at"] == 2 and summary["steps"] == 4
    np.testing.assert_allclose(losses, full_losses[2:], rtol=1e-5)
    w = _weights(summary)
    worst = max(float(np.max(np.abs(w[k] - full_w[k]))) for k in full_w)
    assert worst < 1e-6, f"--data-parallel 2 resume diverged by {worst}"
