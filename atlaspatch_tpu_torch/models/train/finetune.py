"""SAM2 tissue-segmentation fine-tuning on PyTorch.

The port of ``atlaspatch_tpu/models/train/finetune.py``. The reference's
segmentation model was produced by fine-tuning SAM2 hiera-tiny with the
backbone frozen and only normalization layers trained (reference:
CHANGELOG.md:13, SURVEY.md §6). The train step takes the same loss (focal +
dice on mask logits, IoU-head MSE) through autograd and applies AdamW to the
normalization parameters only, or to every parameter.

Parameters are named by the Flax keys of the JAX package's tree
(``flax_key_map``), so the trainable set, the checkpoints and the final
archive line up with the JAX package tensor for tensor. The model runs in
one mode throughout: SAM2 has no dropout and no batch statistics, so the
train step runs the graph of the eval step. Under autograd the trunk's
attention runs the plain products (``ops.attention.attention``), which is
also what the JAX train step differentiates; forwards without a gradient
launch the CUDA kernel.

Several devices (the JAX ``shard_train_step``): ``shard_train_step`` runs
one replica per data device of a local mesh, sums the gradients onto the
first device and applies one update there; ``make_train_step(...,
all_reduce=True)`` is the step of one rank of a process group, whose
gradients and loss are averaged over the ranks before the update.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
import torch.nn.functional as F

from atlaspatch_tpu_torch.models.sam2.convert import flax_key_map
from atlaspatch_tpu_torch.models.sam2.interp import interpolate_torch
from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel, normalize_images

TRAINABLE = ("norms", "all")


def _is_norm(flax_key: str) -> bool:
    # a param is a norm param iff one of its OWNING modules has "norm" in its
    # name (layer_norm1, upscale_layer_norm, ...); the leaf name itself
    # ("scale"/"bias") is shared with convs and must not match
    return any("norm" in n for n in flax_key.split("/")[:-1])


def norm_param_mask(model: SAM2ImageModel) -> dict[str, bool]:
    """{state-dict key: trainable under ``trainable="norms"``}: True exactly
    for the tensors whose JAX parameter the JAX ``norm_param_mask`` marks
    (LayerNorm scales and biases), read through the converter's key map.
    Tensors with no JAX parameter are False."""
    keys = flax_key_map(model)
    return {k: k in keys and _is_norm(keys[k]) for k in model.state_dict()}


def trainable_parameters(model: SAM2ImageModel, trainable: str = "norms") -> dict[str, torch.Tensor]:
    """{Flax key: tensor of ``model``} that the optimizer updates, sorted by
    key, and sets ``requires_grad`` on them and off on every
    other parameter.

    ``"norms"`` (the reference recipe): the normalization parameters only;
    gradients still flow through the frozen layers to the norms below them.
    ``"all"``: every tensor with a JAX parameter, the Fourier projection
    buffer of the prompt encoder included (a parameter in the JAX tree) — the
    mode for training from random init."""
    if trainable not in TRAINABLE:
        raise ValueError(f"trainable must be 'norms' or 'all', got {trainable!r}")
    for p in model.parameters():
        if p.is_inference():
            raise RuntimeError("the SAM2 model holds inference tensors, which autograd cannot train")
        p.requires_grad_(False)
    tensors = model.state_dict(keep_vars=True)
    norms = norm_param_mask(model)
    out: dict[str, torch.Tensor] = {}
    for key, flax_key in flax_key_map(model).items():
        if trainable == "all" or norms[key]:
            out[flax_key] = tensors[key].requires_grad_(True)
    return dict(sorted(out.items()))


def _sigmoid_focal_loss(logits, targets, alpha=0.25, gamma=2.0, reduce=True):
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss.mean() if reduce else loss


def _dice_loss(logits, targets, eps=1.0, reduce=True):
    p = torch.sigmoid(logits)
    num = 2 * (p * targets).sum(dim=(-2, -1)) + eps
    den = p.sum(dim=(-2, -1)) + targets.sum(dim=(-2, -1)) + eps
    per_sample = 1 - num / den
    return per_sample.mean() if reduce else per_sample


def seg_forward(model: SAM2ImageModel, images_u8: torch.Tensor, out_hw):
    """Full-frame box-prompted forward: (logits at out_hw, iou_pred), in the
    params' dtype (float32; float64 where a check wants the exact gradient)."""
    S = model.cfg.image_size
    pixels = normalize_images(model.cfg, images_u8).to(next(model.parameters()).dtype)
    B = images_u8.shape[0]
    box = torch.tensor([[0.0, 0.0, S, S]], dtype=torch.float32, device=images_u8.device)
    boxes = box[None].expand(B, 1, 4)
    masks, iou_pred, _obj = model(pixels, boxes, multimask_output=False)
    low_res = masks[:, 0, 0]  # (B, S/4, S/4)
    logits = interpolate_torch(low_res[..., None], tuple(out_hw), "bilinear")[..., 0]
    return logits, iou_pred


def _per_sample_loss_terms(logits, iou_pred, target_masks):
    """(per-sample loss vector, per-sample IoU vector) — the single source of
    the training objective, shared by seg_loss_fn and the eval step."""
    focal = _sigmoid_focal_loss(logits, target_masks, reduce=False).mean(dim=(-2, -1))
    dice = _dice_loss(logits, target_masks, reduce=False)
    pred_bin = (logits > 0).float()
    inter = (pred_bin * target_masks).sum(dim=(-2, -1))
    union = torch.clamp(pred_bin.sum(dim=(-2, -1)) + target_masks.sum(dim=(-2, -1)) - inter, min=1.0)
    actual_iou = inter / union
    # IoU-head regression toward the actual IoU of the predicted mask
    iou_loss = (iou_pred[:, 0, 0] - actual_iou) ** 2
    return 20.0 * focal + dice + iou_loss, actual_iou


def seg_loss_fn(model: SAM2ImageModel, images_u8: torch.Tensor, target_masks: torch.Tensor):
    """images_u8 (B,S,S,3); target_masks (B,S,S) in {0,1} at full image res."""
    logits, iou_pred = seg_forward(model, images_u8, target_masks.shape[-2:])
    loss, _iou = _per_sample_loss_terms(logits, iou_pred, target_masks)
    return loss.mean()


def _full_float32(model: SAM2ImageModel) -> None:
    """On a card, turn TF32 off in matmuls and cuDNN convolutions (a
    process-wide setting): reference-exact float32, as the float32 segmenter
    keeps it. Called where a step is built."""
    if next(model.parameters()).device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _on_device(model: SAM2ImageModel, images_u8, targets):
    """(uint8 images, float32 targets) as tensors on the model's device, from
    numpy arrays or tensors."""
    device = next(model.parameters()).device
    return (torch.as_tensor(images_u8).to(device),
            torch.as_tensor(targets).to(device=device, dtype=torch.float32))


def make_eval_step(model: SAM2ImageModel):
    """eval_step(images_u8, targets) → per-sample (loss, IoU) vectors, so
    callers can drop padding duplicates before averaging. Runs without a
    gradient, so the trunk's attention launches the kernel on the card."""
    _full_float32(model)

    @torch.no_grad()
    def eval_step(images_u8, targets):
        images, targets = _on_device(model, images_u8, targets)
        logits, iou_pred = seg_forward(model, images, targets.shape[-2:])
        return _per_sample_loss_terms(logits, iou_pred, targets)

    return eval_step


def lr_schedule(
    learning_rate: float,
    schedule: str = "constant",
    warmup_steps: int = 0,
    total_steps: int | None = None,
) -> Callable[[int], float]:
    """lr(count) of the JAX ``make_optimizer``'s optax schedule, as a plain
    function of the number of updates already applied: ``constant`` (with
    optional linear warmup from 0, so the first warmup step has lr 0) or
    ``cosine`` (``warmup_cosine_decay_schedule``: linear warmup to the peak,
    then cosine decay to 0 over total_steps, whose count includes the
    warmup)."""
    warmup_steps = int(warmup_steps)

    def warmup(count: int) -> float:  # optax.linear_schedule(0, lr, warmup_steps)
        return learning_rate * min(count, warmup_steps) / warmup_steps if warmup_steps > 0 else 0.0

    if schedule == "cosine":
        decay = max(int(total_steps or 0), warmup_steps + 1) - warmup_steps

        def lr(count: int) -> float:
            if count < warmup_steps:
                return warmup(count)
            t = min(count - warmup_steps, decay)
            return learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay))

    elif schedule == "constant":

        def lr(count: int) -> float:
            return warmup(count) if count < warmup_steps else learning_rate

    else:
        raise ValueError(f"unknown LR schedule: {schedule!r}")
    return lr


def make_optimizer(
    params: Iterable[torch.Tensor],
    learning_rate: float = 1e-4,
    *,
    schedule: str = "constant",
    warmup_steps: int = 0,
    total_steps: int | None = None,
) -> tuple[torch.optim.AdamW, Callable[[int], float]]:
    """(AdamW over ``params``, lr(count)): optax.adamw's defaults (betas 0.9 /
    0.999, eps 1e-8, decoupled weight decay 0.01) and the JAX schedule. The
    train step sets the learning rate from lr(count) before each update,
    count being the optimizer's own step count, so a restored optimizer
    continues the schedule where it stopped."""
    lr = lr_schedule(learning_rate, schedule, warmup_steps, total_steps)
    optimizer = torch.optim.AdamW(
        list(params), lr=lr(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
    )
    return optimizer, lr


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has applied (0 before the first)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state:
                return int(state["step"])
    return 0


def make_train_step(model: SAM2ImageModel, optimizer: torch.optim.Optimizer, lr: Callable[[int], float], *,
                    all_reduce: bool = False):
    """train_step(images_u8, targets) → loss (a 0-d tensor, before the
    update): one AdamW update of the tensors ``optimizer`` holds (see
    ``trainable_parameters``) at lr(update count). Tensors outside the
    optimizer neither move nor decay, as the JAX step's masked gradients and
    updates leave them.

    ``all_reduce``: one rank of the live default process group, handed its
    equal share of the global batch; the gradients and the loss are
    averaged over the ranks (one ``all_reduce`` of one flat buffer) before
    the update, so every rank applies the global batch's update and returns
    its mean loss."""
    _full_float32(model)

    def train_step(images_u8, targets):
        images, targets = _on_device(model, images_u8, targets)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = seg_loss_fn(model, images, targets)
            loss.backward()
        loss = loss.detach()
        if all_reduce:
            loss = _average_over_ranks(optimizer, loss)
        apply_update(optimizer, lr)
        return loss

    return train_step


def _held(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _average_over_ranks(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> torch.Tensor:
    """Every gradient ``optimizer`` holds (zeros where the loss does not
    reach) and ``loss``, averaged over the default group's ranks in place;
    returns the averaged loss."""
    import torch.distributed as dist

    params = _held(optimizer)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1).to(params[0].grad)])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset : offset + p.numel()].view_as(p))
        offset += p.numel()
    return flat[offset].clone()


def shard_train_step(model: SAM2ImageModel, optimizer: torch.optim.Optimizer, lr: Callable[[int], float], mesh,
                     *, trainable: str = "norms"):
    """The train step data-parallel over ``mesh``'s data devices (the JAX
    ``shard_train_step``): ``model``, on the first, is the first replica,
    and a copy lies on each other device (a device named twice gets two).
    The copies are made at the first call, from ``model`` as it is then (a
    restored checkpoint included), and each call first copies ``model``'s
    trainable tensors into them, so every replica runs the weights the
    update will be applied to. Each replica runs forward and backward on
    its contiguous rows of the batch, its loss weighted by its share of the
    rows so the sum is the global batch mean; the gradients are summed
    onto the first device in device order, and ``optimizer`` (over
    ``model``'s tensors) makes one update there. Returns the global batch
    mean loss before the update."""
    from atlaspatch_tpu_torch.parallel.mesh import replicate, shard_batch

    _full_float32(model)
    devices = mesh.data_devices
    if next(model.parameters()).device != devices[0]:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, the mesh's first device is {devices[0]}")
    replicas: list[SAM2ImageModel] = []
    tensors: list[dict[str, torch.Tensor]] = []

    def train_step(images_u8, targets):
        if not replicas:
            replicas.extend(replicate(mesh, model))
            tensors.extend(trainable_parameters(r, trainable) for r in replicas)
        with torch.no_grad():
            for t in tensors[1:]:
                for key, p in tensors[0].items():
                    t[key].copy_(p)
        parts = zip(shard_batch(mesh, images_u8), shard_batch(mesh, targets))
        n = len(images_u8)
        optimizer.zero_grad(set_to_none=True)
        losses = []
        for i, (replica, (imgs, tgts)) in enumerate(zip(replicas, parts)):
            for t in tensors[i].values():
                t.grad = None
            try:
                imgs, tgts = _on_device(replica, imgs, tgts)
                with torch.enable_grad():
                    loss = seg_loss_fn(replica, imgs, tgts) * (imgs.shape[0] / n)
                    loss.backward()
            except Exception as e:
                raise RuntimeError(f"train replica {i} on {devices[i]} failed: {e}") from e
            losses.append(loss.detach().to(devices[0]))
        with torch.no_grad():
            for key, p in tensors[0].items():
                grads = [t[key].grad for t in tensors if t[key].grad is not None]
                if grads:
                    total = grads[0].to(devices[0])
                    for g in grads[1:]:
                        total = total + g.to(devices[0])
                    p.grad = total
        apply_update(optimizer, lr)
        total_loss = losses[0]
        for part in losses[1:]:
            total_loss = total_loss + part
        return total_loss

    return train_step


def apply_update(optimizer: torch.optim.Optimizer, lr: Callable[[int], float]) -> None:
    """One AdamW update of ``optimizer``'s tensors from the gradients they
    hold, at lr(update count)."""
    rate = lr(update_count(optimizer))
    for group in optimizer.param_groups:
        group["lr"] = rate
        for p in group["params"]:
            if p.grad is None:
                # a tensor the loss does not reach (the object-score head):
                # jax.grad gives it zeros, and optax still decays it and
                # moves its moments
                p.grad = torch.zeros_like(p)
    optimizer.step()
