"""The port's SAM2 fine-tuning (atlaspatch_tpu_torch/models/train/) against
the JAX package's (atlaspatch_tpu/models/train/), on the CPU: the loss, the
first-step gradients and three AdamW steps, which share one jitted JAX
``value_and_grad``. The norms mask, the schedule, the loop and the corpus
are in ``tests/test_torch_train_loop.py``.

Both start from one Flax tree at the miniature config (``shared_flax_params(0)``;
the port loads it through ``flax_to_torch``) and the same batches, made from
the synthetic corpus (``make_annotated_thumbnail``, seeds 0-5) by ``load_pair``.
The JAX side's gradients come from one jitted ``jax.value_and_grad`` of its
``seg_loss_fn`` shared by every test; its updates apply the JAX optimizer
(``make_optimizer``) with ``make_train_step``'s gradient and update masks.

Bars: the loss within 1e-5 relative; each trainable tensor's first-step
gradient within 1e-5 + 1e-4·max|g_jax|; after three AdamW steps the losses
within 1e-5 relative and each parameter's change from init within
1e-3·max|Δ_jax| + 1e-7, except elements whose JAX gradient stayed under 1e-6
of its tensor's largest at every step: Adam's m/√v turns their round-off
into steps of up to ±lr, so they are held to 2·lr·steps and counted. So
are elements whose JAX gradient stayed under 1e-6 in absolute value (100
times Adam's eps, where the update depends on |g| through eps): the
decoder's k_proj biases, zero in exact arithmetic, and units whose gradient
is zero but for round-off. The optimizer alone, fed the JAX gradients, is
held to the same bar with no element exempt.
"""

from __future__ import annotations

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atlaspatch_tpu.models.train import finetune as jax_ft
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.models.sam2.convert import from_flax_layout, to_flax_layout
from atlaspatch_tpu_torch.models.train import finetune, loop
from atlaspatch_tpu_torch.ops import attention as A
from atlaspatch_tpu_torch.tools import synthetic_corpus
from torch_port_helpers import CFG, JAX_CFG, free_tmp_path, port_model, shared_flax_params  # noqa: F401

LR = 1e-3
STEPS = 3


@pytest.fixture(scope="module")
def init():
    return shared_flax_params(0)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Three (images, targets) batches of 2 at 128, from 256x192 corpus pairs."""
    import shutil

    root = tmp_path_factory.mktemp("corpus")
    images, masks = synthetic_corpus.generate_corpus(root, n=2 * STEPS, width=256, height=192)
    pairs = loop.collect_pairs(images, masks)
    loaded = [loop.load_pair(img, mask, CFG.image_size) for img, mask in pairs]
    shutil.rmtree(root)
    return [(np.stack([im for im, _ in loaded[i : i + 2]]), np.stack([mk for _, mk in loaded[i : i + 2]]))
            for i in range(0, len(loaded), 2)]


@pytest.fixture(scope="module")
def jax_value_and_grad():
    return jax.jit(jax.value_and_grad(lambda p, im, t: jax_ft.seg_loss_fn(JAX_CFG, p, im, t)))


def _flat(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, tree)).items()}


def _port(init, trainable):
    model = port_model(init)
    params = finetune.trainable_parameters(model, trainable)
    return model, params


def _port_grads(model, params) -> dict[str, np.ndarray]:
    return to_flax_layout(model, {k: t.grad for k, t in params.items()})


# --------------------------------------------------------------- loss and gradients
def test_seg_loss_matches_jax(init, batches, jax_value_and_grad):
    images, targets = batches[0]
    model = port_model(init)
    with torch.no_grad():
        got = float(finetune.seg_loss_fn(model, torch.from_numpy(images), torch.from_numpy(targets)))
        per_sample, iou = finetune.make_eval_step(model)(images, targets)
    want, _ = jax_value_and_grad(jax.tree.map(jnp.asarray, init), images, targets)
    assert got == pytest.approx(float(want), rel=1e-5)
    # the eval step's per-sample terms are the loss's (the JAX eval step's
    # printed means are held in test_torch_cli.py's finetune-sam2 lines)
    assert float(per_sample.mean()) == pytest.approx(got, rel=1e-6)
    assert per_sample.shape == iou.shape == (2,) and ((iou >= 0) & (iou <= 1)).all()


@pytest.mark.parametrize("trainable", ["norms", "all"])
def test_first_step_gradients_match_jax(init, batches, jax_value_and_grad, trainable):
    images, targets = batches[0]
    model, params = _port(init, trainable)
    A.reset_launch_counts()
    loss = finetune.seg_loss_fn(model, torch.from_numpy(images), torch.from_numpy(targets))
    loss.backward()
    assert A.attention.plain_grad_calls == sum(CFG.blocks_per_stage)  # every trunk attention, differentiated
    got = _port_grads(model, {k: t for k, t in params.items() if t.grad is not None})
    _, grads = jax_value_and_grad(jax.tree.map(jnp.asarray, init), images, targets)
    want = _flat(grads)
    unreached = set(params) - set(got)
    assert all(not np.any(want[k]) for k in unreached)  # the object-score head: zero in JAX too
    assert len(got) > (40 if trainable == "norms" else 200)
    for k, g in got.items():
        bound = 1e-5 + 1e-4 * float(np.abs(want[k]).max())
        assert float(np.abs(g - want[k]).max()) <= bound, k


def _jax_steps(init, batches, jax_value_and_grad, trainable, optimizer):
    """make_train_step's body after value_and_grad (atlaspatch_tpu/models/
    train/finetune.py:150-166) on the shared jitted gradients: returns the
    losses, the flat gradients of each step and the final flat params."""
    mask = jax_ft.norm_param_mask(init)

    @jax.jit
    def update(grads, state, params):
        if trainable == "norms":
            grads = jax.tree.map(lambda g, m: g if m else jnp.zeros_like(g), grads, mask)
        updates, state = optimizer.update(grads, state, params)
        if trainable == "norms":
            updates = jax.tree.map(lambda u, m: u if m else jnp.zeros_like(u), updates, mask)
        return optax.apply_updates(params, updates), state, grads

    params = jax.tree.map(jnp.asarray, init)
    state = optimizer.init(params)
    losses, grads_seen = [], []
    for images, targets in batches:
        loss, grads = jax_value_and_grad(params, images, targets)
        params, state, grads = update(grads, state, params)
        losses.append(float(loss))
        grads_seen.append(_flat(grads))
    return losses, grads_seen, _flat(params)


STEP_CASES = [("norms", "constant", 0), ("all", "constant", 0), ("norms", "cosine", 1), ("all", "cosine", 1)]


@pytest.fixture(scope="module")
def jax_runs(init, batches, jax_value_and_grad):
    """run(trainable, schedule, warmup) → _jax_steps over the three batches
    at LR, each case computed once per module."""
    cache = {}

    def run(trainable, schedule, warmup):
        if (trainable, schedule, warmup) not in cache:
            optimizer = jax_ft.make_optimizer(LR, schedule=schedule, warmup_steps=warmup, total_steps=STEPS)
            cache[trainable, schedule, warmup] = _jax_steps(init, batches, jax_value_and_grad, trainable, optimizer)
        return cache[trainable, schedule, warmup]

    return run


def _port_steps(init, trainable, schedule, warmup):
    model, params = _port(init, trainable)
    optimizer, lr = finetune.make_optimizer(params.values(), LR, schedule=schedule, warmup_steps=warmup,
                                            total_steps=STEPS)
    return model, params, optimizer, lr


@pytest.mark.parametrize("trainable, schedule, warmup", STEP_CASES)
def test_three_adamw_steps_match_jax(init, batches, jax_runs, trainable, schedule, warmup, capsys):
    want_losses, jax_grads, want = jax_runs(trainable, schedule, warmup)
    model, params, optimizer, lr = _port_steps(init, trainable, schedule, warmup)
    step = finetune.make_train_step(model, optimizer, lr)
    losses = [float(step(images, targets)) for images, targets in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert finetune.update_count(optimizer) == STEPS

    start = _flat(init)
    got = to_flax_layout(model, {k: t.detach() for k, t in params.items()})
    exempt = eps_only = total = 0
    beyond = Counter()  # eps-only elements outside the strict bar: k_proj biases / others
    for k in want:
        delta_jax = want[k] - start[k]
        if k not in got:  # frozen: the JAX step leaves it exactly as it was
            assert trainable == "norms" and not np.any(delta_jax), k
            continue
        err = np.abs((got[k] - start[k]) - delta_jax)
        relative = np.all([np.abs(g[k]) < 1e-6 * np.abs(g[k]).max() for g in jax_grads], axis=0)
        # under 100·eps (1e-6) the update m̂/(√v̂ + eps) depends on |g| through
        # eps, so round-off in g moves it: the decoder's k_proj biases (zero in
        # exact arithmetic: softmax is unchanged by a shift common to every
        # key) and units whose gradient is zero but for round-off. The
        # optimizer itself is held on the JAX gradients with no element
        # exempt (test_adamw_on_the_jax_gradients_matches_jax).
        absolute = np.all([np.abs(g[k]) < 1e-6 for g in jax_grads], axis=0)
        tiny = relative | absolute
        bound = 1e-3 * float(np.abs(delta_jax).max()) + 1e-7
        assert float(err[~tiny].max(initial=0.0)) <= bound, k
        assert float(err[tiny].max(initial=0.0)) <= 2 * LR * STEPS, k
        exempt += int(tiny.sum())
        eps_only += int((absolute & ~relative).sum())
        beyond["k_proj/bias" if k.endswith("k_proj/bias") else "other"] += int(((err > bound) & absolute & ~relative).sum())
        total += tiny.size
    with capsys.disabled():
        print(f"\n{trainable}/{schedule}: {exempt} of {total} trained elements exempt, {eps_only} of them only "
              f"by |g| < 1e-6 (Adam's eps region), of which {beyond['k_proj/bias']} in k_proj biases and "
              f"{beyond['other']} elsewhere move beyond the strict bar")


@pytest.mark.parametrize("trainable, schedule, warmup", STEP_CASES)
def test_adamw_on_the_jax_gradients_matches_jax(init, jax_runs, trainable, schedule, warmup):
    """The optimizer apart from gradient round-off: the port's AdamW update
    (make_optimizer + apply_update), fed the JAX step's own gradients, moves
    every trained element as the JAX optimizer does, within 1e-3·max|Δ_jax| +
    1e-7 per tensor with no element exempt."""
    _, jax_grads, want = jax_runs(trainable, schedule, warmup)
    model, params, optimizer, lr = _port_steps(init, trainable, schedule, warmup)
    for grads in jax_grads:
        for k, g in from_flax_layout(model, {k: grads[k] for k in params}).items():
            params[k].grad = g
        finetune.apply_update(optimizer, lr)
    assert finetune.update_count(optimizer) == STEPS
    start = _flat(init)
    got = to_flax_layout(model, {k: t.detach() for k, t in params.items()})
    for k in params:
        delta_jax = want[k] - start[k]
        err = float(np.abs((got[k] - start[k]) - delta_jax).max())
        assert err <= 1e-3 * float(np.abs(delta_jax).max()) + 1e-7, k
