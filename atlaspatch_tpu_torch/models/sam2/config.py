"""SAM2 hiera-tiny architecture configuration.

Values mirror the reference's model spec (reference:
atlas_patch/configs/sam2.1_hiera_t.yaml:4-27 — Hiera embed_dim 96, heads 1,
stages [1,2,7,2], global attention blocks [5,7,9], FPN d_model 256 over
channels [768,384,192,96], top-down levels [2,3], image size 1024). Only the
image-prediction path is modeled; the YAML's memory attention/encoder sections
are video-only and unused by single-image prediction.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HieraBlockSpec:
    """Resolved per-block schedule entry for the hiera trunk.

    ONE source of truth consumed by both the model (hiera.MultiScaleBlock)
    and SAM2Config.validate_input_size — previously each re-derived the
    window/pool schedule from the raw config and could silently drift."""

    stage_idx: int
    block_idx: int
    total_block_idx: int
    dim: int        # input channel count (previous stage's at transitions)
    dim_out: int
    num_heads: int
    window_size: int  # 0 = global attention
    query_stride: int | None  # set on the first block of pooled stages


@dataclass(frozen=True)
class SAM2Config:
    # Hiera trunk
    hidden_size: int = 96
    blocks_per_stage: tuple[int, ...] = (1, 2, 7, 2)
    embed_dim_per_stage: tuple[int, ...] = (96, 192, 384, 768)
    num_heads_per_stage: tuple[int, ...] = (1, 2, 4, 8)
    window_size_per_stage: tuple[int, ...] = (8, 4, 14, 7)
    global_attention_blocks: tuple[int, ...] = (5, 7, 9)
    window_pos_embed_bkg_size: tuple[int, int] = (7, 7)
    num_query_pool_stages: int = 3
    query_stride: int = 2
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6

    # FPN neck
    backbone_channel_list: tuple[int, ...] = (768, 384, 192, 96)
    fpn_hidden_size: int = 256
    fpn_top_down_levels: tuple[int, ...] = (2, 3)
    num_feature_levels: int = 3

    # Prompt encoder / mask decoder
    image_size: int = 1024
    prompt_hidden_size: int = 256
    mask_input_channels: int = 16
    decoder_mlp_dim: int = 2048
    decoder_num_layers: int = 2
    decoder_num_heads: int = 8
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98

    # Normalization constants applied on-device before the encoder
    pixel_mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    pixel_std: tuple[float, float, float] = (0.229, 0.224, 0.225)

    @property
    def stage_ends(self) -> tuple[int, ...]:
        ends = []
        total = 0
        for n in self.blocks_per_stage:
            total += n
            ends.append(total - 1)
        return tuple(ends)

    @property
    def backbone_feature_sizes(self) -> tuple[tuple[int, int], ...]:
        s = self.image_size // self.patch_stride
        return ((s, s), (s // 2, s // 2), (s // 4, s // 4))

    def block_schedule(self) -> tuple[HieraBlockSpec, ...]:
        """Per-block (dim, window, query-stride) schedule in trunk order.

        Mirrors the reference trunk's per-block resolution (stage-transition
        blocks keep the PREVIOUS stage's dim/window; designated blocks run
        global attention; the first block of stages 1..num_query_pool_stages
        query-pools by `query_stride`)."""
        specs: list[HieraBlockSpec] = []
        total = 0
        for stage_idx, n_blocks in enumerate(self.blocks_per_stage):
            for block_idx in range(n_blocks):
                first = stage_idx > 0 and block_idx == 0
                src_stage = stage_idx - 1 if first else stage_idx
                window = self.window_size_per_stage[src_stage]
                if total in self.global_attention_blocks:
                    window = 0
                pooled = (
                    0 < stage_idx <= self.num_query_pool_stages and block_idx == 0
                )
                specs.append(
                    HieraBlockSpec(
                        stage_idx=stage_idx,
                        block_idx=block_idx,
                        total_block_idx=total,
                        dim=self.embed_dim_per_stage[src_stage],
                        dim_out=self.embed_dim_per_stage[stage_idx],
                        num_heads=self.num_heads_per_stage[stage_idx],
                        window_size=window,
                        query_stride=self.query_stride if pooled else None,
                    )
                )
                total += 1
        return tuple(specs)

    def validate_input_size(self, size: int) -> None:
        """Raise ValueError if the hiera window/q-pool math cannot tile `size`.

        The architecture has a latent divisibility constraint (faithful to the
        upstream SAM2 trunk, whose torch code fails the same way on a bad
        view): at each stage-transition block, attention partitions the
        incoming grid into windows of the PREVIOUS stage's size, query-pools
        each window by `query_stride`, and un-partitions on the POOLED grid
        with window `win // query_stride` — so the window counts must agree:
        ceil(H/win) == ceil((H//stride) / (win//stride)). The patch grid must
        also tile the stage-0 window (pos-embed tiling). The shipped
        hiera-tiny spec satisfies this at 1024/768/512; arbitrary (spec, size)
        pairs may not — this turns the reshape crash into a clear error."""
        import math

        grid = size // self.patch_stride
        if size % self.patch_stride:
            raise ValueError(
                f"SAM2 input size {size} is not a multiple of the patch "
                f"stride {self.patch_stride}"
            )
        win0 = self.window_size_per_stage[0]
        if grid % win0:
            raise ValueError(
                f"SAM2 input size {size}: patch grid {grid} does not tile the "
                f"stage-0 window {win0} (positional-embedding tiling)"
            )
        for spec in self.block_schedule():
            win, qs = spec.window_size, spec.query_stride
            out = grid // qs if qs else grid
            if win and qs:
                ws = win // qs
                if ws == 0 or math.ceil(grid / win) != math.ceil(out / ws):
                    raise ValueError(
                        f"SAM2 input size {size} is incompatible with this "
                        f"architecture: stage {spec.stage_idx} transition "
                        f"(grid {grid}, window {win}, query stride {qs}) "
                        f"pools to grid {out} with window {ws}, but the "
                        f"window counts differ ({math.ceil(grid / win)} vs "
                        f"{0 if ws == 0 else math.ceil(out / ws)}). "
                        f"Pick a size whose stage grids tile the windows "
                        f"(the shipped hiera-tiny spec supports "
                        f"1024/768/512)."
                    )
            grid = out

    @classmethod
    def tiny(cls) -> "SAM2Config":
        return cls()

    @classmethod
    def from_reference_yaml(cls, path) -> "SAM2Config":
        """Build a config from the reference's hydra model YAML
        (reference: atlas_patch/configs/sam2.1_hiera_t.yaml). Only the
        image-prediction fields are read; video-only sections are ignored."""
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f)
        model = doc.get("model", doc)
        enc = model.get("image_encoder", {})
        trunk = enc.get("trunk", {})
        neck = enc.get("neck", {})

        kwargs: dict = {}
        if "embed_dim" in trunk:
            kwargs["hidden_size"] = int(trunk["embed_dim"])
        if "stages" in trunk:
            stages = tuple(int(s) for s in trunk["stages"])
            kwargs["blocks_per_stage"] = stages
            base = kwargs.get("hidden_size", 96)
            kwargs["embed_dim_per_stage"] = tuple(base * 2**i for i in range(len(stages)))
            base_heads = int(trunk.get("num_heads", 1))
            kwargs["num_heads_per_stage"] = tuple(
                base_heads * 2**i for i in range(len(stages))
            )
        if "global_att_blocks" in trunk:
            kwargs["global_attention_blocks"] = tuple(
                int(b) for b in trunk["global_att_blocks"]
            )
        if "window_pos_embed_bkg_spatial_size" in trunk:
            kwargs["window_pos_embed_bkg_size"] = tuple(
                int(v) for v in trunk["window_pos_embed_bkg_spatial_size"]
            )
        if "window_spec" in trunk:
            kwargs["window_size_per_stage"] = tuple(int(v) for v in trunk["window_spec"])
        if "d_model" in neck:
            kwargs["fpn_hidden_size"] = int(neck["d_model"])
            # SAM2 ties the prompt-encoder/mask-decoder embedding width to
            # the neck's d_model (the hydra YAML has no separate field for
            # it); leaving the 256 default would break any YAML with a
            # different d_model at the prompt + image-feature add.
            kwargs["prompt_hidden_size"] = int(neck["d_model"])
        if "backbone_channel_list" in neck:
            kwargs["backbone_channel_list"] = tuple(
                int(c) for c in neck["backbone_channel_list"]
            )
        if "fpn_top_down_levels" in neck:
            kwargs["fpn_top_down_levels"] = tuple(
                int(v) for v in neck["fpn_top_down_levels"]
            )
        if "image_size" in model:
            kwargs["image_size"] = int(model["image_size"])
        return cls(**kwargs)

    @classmethod
    def test_tiny(cls) -> "SAM2Config":
        """Miniature config for fast unit tests (same topology, tiny dims)."""
        return cls(
            hidden_size=8,
            blocks_per_stage=(1, 2, 2, 1),
            embed_dim_per_stage=(8, 16, 32, 64),
            num_heads_per_stage=(1, 2, 4, 8),
            window_size_per_stage=(4, 2, 7, 4),
            global_attention_blocks=(4,),
            backbone_channel_list=(64, 32, 16, 8),
            fpn_hidden_size=32,
            image_size=128,
            prompt_hidden_size=32,
            decoder_mlp_dim=64,
            iou_head_hidden_dim=32,
            mask_input_channels=16,
        )
