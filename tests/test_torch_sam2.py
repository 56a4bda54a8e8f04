"""The port's SAM2ImageModel against the Flax model and against transformers' Sam2Model.

Both comparisons run the whole forward (trunk windowing and q-pool, FPN
fusion, prompt encoding, two-way transformer, upscaling head) on the
miniature test config in float32 on the CPU, where every trunk attention is
the plain version. Tolerance 1e-4 on low-res mask logits, IoU and object
score: the repo's model-numerics bar for float32 (the two frameworks sum in
other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atlaspatch_tpu.models.sam2.model import SAM2ImageModel as JaxSAM2ImageModel
from atlaspatch_tpu.models.sam2.model import normalize_images as jax_normalize_images
from atlaspatch_tpu_torch.models.sam2.convert import flax_to_torch
from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel, normalize_images
from torch_port_helpers import CFG, JAX_CFG, port_model, shared_flax_params

TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return shared_flax_params(seed=0)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(2, CFG.image_size, CFG.image_size, 3), dtype=np.uint8)
    boxes = np.array(
        [[[0.0, 0.0, CFG.image_size, CFG.image_size]], [[10.0, 20.0, 100.0, 90.0]]],
        dtype=np.float32,
    )
    return images, boxes


@pytest.mark.parametrize("multimask", [False, True])
def test_port_matches_flax_on_shared_params(params, multimask):
    images, boxes = _inputs(seed=3)
    # jitted: one compile beats op-by-op dispatch of the eager Flax forward
    forward = jax.jit(
        lambda p, x, b: JaxSAM2ImageModel(JAX_CFG).apply(
            {"params": p}, jax_normalize_images(JAX_CFG, x), b, multimask_output=multimask
        )
    )
    want = forward(jax.tree.map(jnp.asarray, params), jnp.asarray(images), jnp.asarray(boxes))
    model = port_model(params)
    with torch.no_grad():
        got = model(
            normalize_images(CFG, torch.from_numpy(images)),
            torch.from_numpy(boxes),
            multimask_output=multimask,
        )
    for name, g, w in zip(("masks", "iou", "obj"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)


def test_flax_to_torch_covers_every_used_parameter(params):
    sd = flax_to_torch(params, CFG)
    own = SAM2ImageModel(CFG).state_dict()
    assert set(sd) <= set(own)
    # only the mask-prompt downscaler (never run on the box path) is absent
    assert {k for k in own if k not in sd} == {
        k for k in own if k.startswith("prompt_encoder.mask_embed.")
    }
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k


def _hf_model():
    """transformers Sam2Model on the miniature config (as in test_sam2_parity)."""
    transformers = pytest.importorskip("transformers")

    backbone = transformers.Sam2HieraDetConfig(
        hidden_size=CFG.hidden_size,
        num_attention_heads=1,
        image_size=[CFG.image_size, CFG.image_size],
        blocks_per_stage=list(CFG.blocks_per_stage),
        embed_dim_per_stage=list(CFG.embed_dim_per_stage),
        num_attention_heads_per_stage=list(CFG.num_heads_per_stage),
        window_size_per_stage=list(CFG.window_size_per_stage),
        global_attention_blocks=list(CFG.global_attention_blocks),
        window_positional_embedding_background_size=list(CFG.window_pos_embed_bkg_size),
    )
    vision = transformers.Sam2VisionConfig(
        backbone_config=backbone,
        backbone_channel_list=list(CFG.backbone_channel_list),
        backbone_feature_sizes=[list(s) for s in CFG.backbone_feature_sizes],
        fpn_hidden_size=CFG.fpn_hidden_size,
    )
    prompt = transformers.Sam2PromptEncoderConfig(
        hidden_size=CFG.prompt_hidden_size,
        image_size=CFG.image_size,
        patch_size=16,
        mask_input_channels=CFG.mask_input_channels,
    )
    decoder = transformers.Sam2MaskDecoderConfig(
        hidden_size=CFG.prompt_hidden_size,
        mlp_dim=CFG.decoder_mlp_dim,
        iou_head_hidden_dim=CFG.iou_head_hidden_dim,
    )
    config = transformers.Sam2Config(
        vision_config=vision, prompt_encoder_config=prompt, mask_decoder_config=decoder
    )
    torch.manual_seed(0)
    model = transformers.Sam2Model(config).eval()
    # randomize params that _init_weights zeroes, so parity is meaningful
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        model.vision_encoder.backbone.pos_embed.normal_(0, 0.5, generator=gen)
        model.vision_encoder.backbone.pos_embed_window.normal_(0, 0.5, generator=gen)
        model.no_memory_embedding.normal_(0, 0.5, generator=gen)
    return model


def test_hf_state_dict_loads_strict_and_matches():
    hf = _hf_model()
    model = SAM2ImageModel(CFG)
    model.load_state_dict(hf.state_dict(), strict=True)
    model.eval()

    images, boxes = _inputs(seed=4)
    pixels = normalize_images(CFG, torch.from_numpy(images))
    with torch.no_grad():
        want = hf(
            pixel_values=pixels.permute(0, 3, 1, 2),
            input_boxes=torch.from_numpy(boxes),
            multimask_output=False,
        )
        masks, iou, obj = model(pixels, torch.from_numpy(boxes), multimask_output=False)
    # the transformers oracle sums in yet another order: the bar of
    # tests/test_sam2_parity.py (2e-4) applies
    np.testing.assert_allclose(masks.numpy(), want.pred_masks.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(iou.numpy(), want.iou_scores.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        obj.numpy(), want.object_score_logits.numpy(), rtol=2e-4, atol=2e-4
    )


@pytest.mark.parametrize("full_width,size,batch", [(False, 128, 2), (True, 256, 1)])
def test_trunk_attention_shapes_match_the_forward(monkeypatch, full_width, size, batch):
    from atlaspatch_tpu_torch.models.sam2 import hiera
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config

    cfg = SAM2Config.tiny() if full_width else CFG
    seen = []
    plain = hiera.attention

    def record(q, k, v, sm_scale=None):
        seen.append((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return plain(q, k, v, sm_scale)

    monkeypatch.setattr(hiera, "attention", record)
    with torch.no_grad():
        hiera.HieraDet(cfg)(torch.zeros(batch, size, size, 3))
    assert seen == hiera.trunk_attention_shapes(cfg, size, batch)


def _hf_to_original_key(key: str) -> str:
    """transformers Sam2Model key → original sam2-package key (the layout of
    the reference's model.pth), for the keys the image path uses."""
    import re

    heads = r"output_hypernetworks_mlps\.\d+|iou_prediction_head|pred_obj_score_head"
    rules = [
        (r"^vision_encoder\.backbone\.patch_embed\.projection\.", "image_encoder.trunk.patch_embed.proj."),
        (r"^vision_encoder\.backbone\.blocks\.(\d+)\.layer_norm(\d)\.", r"image_encoder.trunk.blocks.\1.norm\2."),
        (r"^vision_encoder\.backbone\.blocks\.(\d+)\.mlp\.proj_in\.", r"image_encoder.trunk.blocks.\1.mlp.layers.0."),
        (r"^vision_encoder\.backbone\.blocks\.(\d+)\.mlp\.proj_out\.", r"image_encoder.trunk.blocks.\1.mlp.layers.1."),
        (r"^vision_encoder\.backbone\.", "image_encoder.trunk."),
        (r"^vision_encoder\.neck\.convs\.(\d+)\.(weight|bias)$", r"image_encoder.neck.convs.\1.conv.\2"),
        (r"^prompt_encoder\.shared_embedding\.positional_embedding$",
         "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
        (r"^prompt_encoder\.", "sam_prompt_encoder."),
        (r"^mask_decoder\.transformer\.layer_norm_final_attn\.", "sam_mask_decoder.transformer.norm_final_attn."),
        (r"^mask_decoder\.transformer\.(.*)\.layer_norm(\d)\.", r"sam_mask_decoder.transformer.\1.norm\2."),
        (r"^mask_decoder\.transformer\.(.*)\.o_proj\.", r"sam_mask_decoder.transformer.\1.out_proj."),
        (r"^mask_decoder\.transformer\.(.*)\.mlp\.proj_in\.", r"sam_mask_decoder.transformer.\1.mlp.lin1."),
        (r"^mask_decoder\.transformer\.(.*)\.mlp\.proj_out\.", r"sam_mask_decoder.transformer.\1.mlp.lin2."),
        (r"^mask_decoder\.upscale_conv1\.", "sam_mask_decoder.output_upscaling.0."),
        (r"^mask_decoder\.upscale_layer_norm\.", "sam_mask_decoder.output_upscaling.1."),
        (r"^mask_decoder\.upscale_conv2\.", "sam_mask_decoder.output_upscaling.3."),
        (rf"^mask_decoder\.({heads})\.proj_in\.", r"sam_mask_decoder.\1.layers.0."),
        (rf"^mask_decoder\.({heads})\.layers\.0\.", r"sam_mask_decoder.\1.layers.1."),
        (rf"^mask_decoder\.({heads})\.proj_out\.", r"sam_mask_decoder.\1.layers.2."),
        (r"^mask_decoder\.", "sam_mask_decoder."),
        (r"^no_memory_embedding$", "no_mem_embed"),
    ]
    for pattern, repl in rules:
        new, n = re.subn(pattern, repl, key)
        if n:
            return new
    return key


def test_original_checkpoint_loads_through_the_predictor(tmp_path):
    """A model.pth in the original sam2 naming (plus video-only keys the image
    path drops) loads into the port's predictor with every used weight."""
    from atlaspatch_tpu.models.sam2.convert import _original_to_hf_key as jax_key_map
    from atlaspatch_tpu_torch.core.config import SegmentationConfig
    from atlaspatch_tpu_torch.models.sam2.convert import _original_to_hf_key
    from atlaspatch_tpu_torch.models.sam2.model import init_params
    from atlaspatch_tpu_torch.services.segmentation import SAM2Predictor

    source = init_params(CFG, seed=3)
    orig = {"memory_attention.layers.0.self_attn.q_proj.weight": torch.zeros(2, 2)}
    for key, val in source.state_dict().items():
        if key.startswith(("shared_image_embedding.", "prompt_encoder.mask_embed.")):
            continue
        if key == "prompt_encoder.point_embed.weight":
            for i in range(val.shape[0]):
                orig[f"sam_prompt_encoder.point_embeddings.{i}.weight"] = val[i : i + 1]
            continue
        okey = _hf_to_original_key(key)
        assert _original_to_hf_key(okey) == jax_key_map(okey) == key, (key, okey)
        orig[okey] = val
    path = tmp_path / "model.pth"
    torch.save({"model": orig}, path)

    pred = SAM2Predictor(SegmentationConfig(checkpoint_path=path, device="cpu").validated(), CFG)
    got = pred.model.state_dict()
    for key, val in source.state_dict().items():
        if not key.startswith("prompt_encoder.mask_embed."):
            torch.testing.assert_close(got[key], val, rtol=0, atol=0, msg=key)
