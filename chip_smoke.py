"""Drive the PyTorch port's segment-and-get-coords and process paths (the int8 serving mode too), its command line, its checkpoint loading, its SAM2 fine-tuning, its multi-device paths, its launch scripts and its mask-quality loop, on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):

  env     torch / CUDA versions, the card's name and power limit, and which of
          Pillow / h5py / OpenCV import (for information only)
  build   the attention kernel's three libraries (nvcc, sm_90a: the wgmma +
          TMA bfloat16 body; the mma.sync bfloat16 body and two float32
          bodies, 3xTF32 on mma.sync and FMA; the float32 small-window body),
          the int8 serving mode's library (int8_linear.so: the row quantizer
          and the int8 linear's two bodies, mma.sync and wgmma fed by TMA;
          no spills in any instantiation, no wgmma serialized by ptxas, SASS
          checked for IMMA, IGMMA and UTMALDG),
          the contour tracer and the slide decoder (g++), all from the sources in
          atlaspatch_tpu_torch/csrc, built in parallel; registers and spills
          per body (none allowed at D = 96 in the wgmma, tf32x3 and f32_win
          bodies), the tf32x3 and f32_win bodies' CTAs per SM, the wgmma
          body's SASS checked for HGMMA and UTMALDG, flash_attn.so's for TF32
          HMMA
  kernel  the attention kernel against its plain PyTorch version at the shapes
          the main path hands it (every trunk block of the --fast preset, of
          the float32 default at batch 1 (segmentation, detect-tissue) and at
          batch 2 (finetune-sam2's validation forward)) plus ragged, q-pool and FMA-body checks;
          each line gives the variant launched, the kernel's time by CUDA
          events and its device time per call by torch.profiler, the plain
          version's and F.scaled_dot_product_attention's time (SDPA's device
          time too, which SDPA is only timed for) and the bound
          (float32 rows: the FP32-core and the 3xTF32 tensor-core bound); an
          float32 line whose shape both f32_win and another body take also
          times the other one, forced on the same inputs (for f32_win rows the
          body kernel_variant picked before f32_win). float32 is held to
          max-abs 1e-4 and, element by element, to attention.f32_error_limit,
          which a planted single TF32 pass on the global float32 block's
          inputs must exceed; bfloat16 to 2e-2 and, element by element, to
          attention.bf16_error_limit, which two planted faults emulated on the
          global block's inputs (P in fp8, one K/V tile skipped) must exceed
  seg     SAM2SegmentationService(device="cuda") at full Hiera-tiny width with
          random weights: (a) the --fast preset (bfloat16, input 768, batch 8)
          on 16 thumbnails of two shapes, (b) float32 at 1024, batch 1, on 2
          thumbnails. The kernel must have launched 12 times per forward, each
          variant as often as kernel_variant picks it at the trunk's shapes
          (the 3 global blocks of each forward of (a) on the wgmma body's
          192-row tile; 9 tf32x3 and 3 f32_win launches per forward of (b),
          none on the FMA body).
          (b)'s logits are held against the same model on the CPU.
  profile one forward of (a) and of (b) under torch.profiler: device time by
          kernel, and the device's busy share of the forward; the forward's
          FLOPs by atlaspatch_tpu_torch/tools/sam2_ceiling.py's count (on the
          meta device) and their rate over the busy time as a share of the
          card's peak for the precision (989 TFLOP/s bfloat16, 67 float32)
  coords  the masks of (a) → contours → patch coordinates on a 4096x3072
          synthetic slide (native containment checked against numpy)
  runner  segment-and-get-coords through the port's ProcessingRunner on
          bench.py's seg_coords_synthetic corpus: 28 SyntheticWSI slides of
          4096x3072 (3 levels, mpp 0.5; four make_tissue_canvas canvases,
          seeds 0-3, round-robin) behind empty .svs placeholders, the --fast
          service (bfloat16, input 768, batch 8; pend depth 3 and the
          remainder batch of 4 both run), patch 256 at 20x. Random-weight
          masks have no structure, so, as bench.py's BenchSegmentation does,
          the real device step runs and its masks are waited for, and then
          extraction gets the thumbnail thresholded at < 220. Checks: 12
          kernel launches per forward with kernel_variant's counts; 28 results
          and no failures; each H5 at patch_h5_path, read back by the port's
          read_h5: coords byte for byte the rows _iter_patch_entries yields
          for the mask handed to extraction, num_patches, passports that
          parse back to their coords, every file attr; no .lock or .stage-*
          file left; the H5 write not the stage with the most host time; a
          second run with skip_existing skips all 28 with no kernel launch
          and no file rewritten. Prints slides/s by host clock (a liveness
          figure), the stage counters and the H5 write's ms per slide
  tiff    segment-and-get-coords and process from slide files on disk,
          through DefaultWSILoader, the factory and the native decoder
          (atlas_tiff, g++ at build). Writes, on the card's host, with
          tests/tiff_builder.py and tests/container_builders.py: (f1)
          bench.py's real-TIFF corpus (28 JPEG SVS of 4096x3072, 3 levels,
          tile 256, AppMag 20, MPP 0.5; canvases seeds 100-103), (f2) one SVS
          of 16384x12288 (4 levels), (f3) an NDPI (single-strip restart JPEG
          with zeroed SOF dims), a MIRAX, a VMS, a VMU and a 2-level DICOM
          series with a label. Prints the decoder's build (g++, the libjpeg
          headers used, ldd, the libjpeg and libopenjp2 loaded) and holds it
          against Pillow's decode of the same bytes (a level-0 region, the
          --fast thumbnail of an (f1) slide by IDCT scaling, a 33003 J2K
          tile): max-abs 0, as tests/test_torch_native_tiff.py measures on
          the CPU. On the card both sides load Pillow's bundled libjpeg, so
          this holds the TIFF walk, tile assembly and J2K colour maths; the
          check across two libjpegs is the CPU test
          test_vendored_libjpeg_route_matches. Runs the runner's checks over (f1)+(f3) on the --fast
          thresholding service (12 launches per forward, every slide an H5,
          a skip pass), prints slides/s beside the runner phase's and the
          per-slide stage ms; then (f2) and two (f1) slides through the
          runner and embed_all (vit_l_16 bfloat16, batch 32): (f2)'s
          coordinates equal the CPU geometry over the same reader's
          thumbnail, 64 of its features match extract_batch on wsi.extract
          reads (per-row cosine > 0.999); prints (f2)'s thumbnail ms,
          patch_read ms per patch, patches/s and the device busy share
  embed   vit_l_16 from the port's registry at full width (dim 1024, depth
          24, 16 heads, 224 px, patch 16) with random weights, on the card.
          Checks: full width at depth 2 in float32 on the card (built with
          TF32 switched on, which the engine must switch off) against the
          same weights on the CPU, max-abs <= 1e-4; the full model in bfloat16
          against float32 on 16 patches, per-row cosine > 0.995; every param
          of the bfloat16 extractor bfloat16 on the card. Rates: bench.py's
          setting (512 random 256x256 uint8 patches through extract_batch at
          batch 32, one warm and 3 timed passes: median patches/s and the
          stage totals), the same at batch 256, the device-resident rate (the
          forward over a batch already on the card), the share of the bf16
          dense bound (the forward's FLOPs per patch over 989 TFLOP/s), the
          device busy share of one extract_batch by torch.profiler with its
          largest device operations, and the peak memory allocated
  int8    the int8 (W8A8) serving mode of vit_l_16. (a0) quantize_rows_s8's
          prologues against their plain versions (the unfused chain: the
          F.layer_norm or activation stored, then the quantizer) on the same
          inputs: layernorm (norm1/norm2 -> qkv/fc1) at K 1,024 and medsiglip's
          1,152, tanh GELU (-> fc2) at 4,096 and 4,304, the attention's
          (B, T, H, D) output read where it lies (identity, -> proj) at
          vit_l_16's rows at batch 32 and 256 (M 6,304 and 50,432; bfloat16,
          and float32 at batch 32), SiLU of SwiGLU halves at virchow's 3,416;
          identity at max-abs 0, the others within 1 in at most 1e-3 of xq and
          s_x within 2^-8 (the flip share printed); device ms per call and per
          forward (48 layernorm, 24 activation, 24 identity) against the
          bound, beside the unfused chain's kernels timed in the same run
          (F.layer_norm, F.gelu, the reshape copy of the attention's output,
          the earlier two-read quantizer from tools/int8_variants.py).
          (a) quantize_rows_s8 (identity)
          and int8_linear_s8 against their plain versions (max-abs 0) at the
          shapes vit_l_16 hands them at batch 32 and 256 (M 6,304 and 50,432;
          (K, N) of qkv, proj, fc1, fc2), at medsiglip's ragged MLP
          ((1152, 4304), (4304, 1152)) at M 8,192 and 5 and at virchow's fc2
          ((3416, 1280), v1 and v2 at batch 32 and 256), over xq as the
          quantizer writes it and weights as the model holds them (rows at
          the 16-byte pitch, pad bytes 0x7f), every call routed to the wgmma
          body, the mma.sync body over packed rows beside for virchow's: the routed call and
          each body of int8_linear_s8 the shape admits (the wgmma body of
          csrc/int8_linear_wgmma.cu, the mma.sync body of
          csrc/int8_linear.cu), forced, each at max-abs 0 against the plain
          version and equal to the other; per shape each body's device ms by
          torch.profiler, the bound, the plain version's ms and the
          library's (torch._int_mm alone, torch._int_mm + the eager
          dequantization, bf16 F.linear), timed only; the sums over one
          vit_l_16 forward and one virchow_v2 forward's 32 fc2 at batch 32
          and 256. (b2) virchow_v2 at full width and depth from the registry,
          32 patches at batch 32: 128 wgmma launches, none on mma.sync,
          features equal (max-abs 0) to the same weights packed again (fc2 on
          mma.sync), each route's resident forward ms. (b) vit_l_16 at full width
          from the registry with --feature-precision int8's dtype and random
          weights: 96 Int8Linear, weight_q int8, qscale float32, the rest
          bfloat16; the float32 extractor's weights quantized; 96 launches of
          each kernel per forward (quantize_rows_s8: 48 layernorm, 24
          gelu_tanh, 24 identity), all 96 linears on the wgmma body (0 on
          mma.sync); int8 vs float32 per-patch cosine > 0.98 on 64
          patches; card int8 vs CPU int8 at depth 2 on the same weights,
          cosine >= 0.999; extract_batch patches/s at batch 32 (512 patches,
          median of 3) and the resident rate at 32 and 256 beside the embed
          phase's bf16 ones; the kernels' share of a forward's device time,
          the top kernels of one batch-256 forward (one LayerNorm kernel, the
          final norm, and no GELU kernel), the device-busy share of one
          batch-32 forward;
          the quant_int8_attn branch's time. (d) content_filter_mask and
          resize_nearest on the card equal to the CPU's. (c) process --fast
          --feature-precision int8 --feature-extractors vit_l_16 through the
          command line over four (f1) slides on the tiff phase's
          coordinates: no segmentation, 96 launches of each kernel per
          encoder forward, all on the wgmma body (printed by body), features
          (n, 1024) float32, coords and attrs unchanged; patches/s by host
          clock
  process the runner phase's 28 slides through ProcessingRunner.run() and
          then PatchFeatureEmbeddingService.embed_all with vit_l_16 in
          bfloat16 (batch 32), as the JAX CLI's process composes them.
          Checks: every H5 holds features/vit_l_16 (num_patches x 1024
          float32, attrs name and embedding_dim) by read_h5, coords and file
          attrs unchanged by the append; one slide's features equal
          extract_batch on its patches read directly (per-row cosine >
          0.999); feature_sets == ["vit_l_16"]; no lock or stage file; a
          second embed_all runs no forward and rewrites no file; a
          configuration asking also for vit_b_16, through the runner with
          skip_existing, reuses every slide's coordinates (no segmentation
          launch) and embeds only vit_b_16. Prints patches/s and the stage
          totals (patch_read, embed_*, h5_append ms per slide)

  cli     the port's command line (atlaspatch_tpu_torch/cli.py) on the card
          with random weights and no --device flag (the default device),
          over the tiff phase's corpus, which stays until this phase ends.
          In process, through cli.main(..., standalone_mode=False), each
          command's attention launches and segmentation forwards counted
          from zero: (1) segment-and-get-coords --fast --patch-size 256
          --target-mag 20 with the grid, mask and contour overlays over
          (f1)+(f3): "Completed 33 slide(s), failures: 0", 12 launches per
          forward, every H5's coordinates byte for byte those that
          PatchExtractionService computes from the masks of an in-process
          --fast SAM2SegmentationService (same settings and seed, batched as
          the runner batches), 4 overlay PNGs per slide that decode; (2)
          detect-tissue --seg-batch-size 8 over the same files and a PNG with
          no MPP: "Created 33 mask overlay(s), failures: 1", both PNGs for
          every healthy slide; (3) process --fast --feature-extractors
          "resnet50 vit_l_16" over the 28 (f1) slides on (1)'s coordinates:
          no segmentation, features (n, 2048) and (n, 1024) finite, coords
          and file attrs unchanged, patches/s per encoder (extract_batch by
          host clock); resnet50 at full width float32 on the card against
          the CPU (<= 1e-4 on 4 patches, TF32 switched on first) and bfloat16
          against float32 (cosine > 0.995). Then a subprocess through the
          real entry point: python -m atlaspatch_tpu_torch.cli info, and
          segment-and-get-coords -v on 2 slides, whose log must name the
          SAM2 device cuda. Prints each command's wall time, slides/s,
          forwards and launches. The corpus stays for the weights phase
  weights every new encoder tower from its published checkpoint layout, with
          seeded values (no network, no JAX): each port tower's Flax-layout
          shapes → tests/upstream_layouts.py's upstream layout → values by
          tests/upstream_values.py, written as the source ships it: (h1)
          uni_v1.safetensors (timm ViT-L/16 at full width, 303 M params,
          F32), (h2) conch_v1.bin (CONCH layout, ViT-B/16 trunk),
          chief-ctranspath.pth (CHIEF's old layout, Swin-T + ConvStem),
          musk.safetensors (BEiT3-large at 384, BF16, the values rounded to
          bf16 first), clip_rn50.pt (open_clip layout); (h3) dinov2_small as
          two .safetensors shards in the HF hub cache layout (HF_HUB_CACHE
          at the phase's temp dir); .safetensors written by the script's
          own few lines. Checks: each file found by the zoo's lookup, and
          zoo._convert of what the port's reader / torch.load gives equal,
          tensor for tensor (max-abs 0), to flax_*_to_torch of the Flax tree
          converted from the dict in memory (dinov2_small from the merged
          shards); verify-weights <dir> --no-sam2 in process (default
          device): 6 PASS and "preflight: 6 PASS, 0 FAIL, 60 SKIP"; a
          second dir whose uni_v1 has one tensor's shape cut: FAIL naming
          the key, exit 1; process --fast --feature-extractors "uni_v1
          conch_v1 chief-ctranspath musk clip_rn50" over four (f1) slides
          on the cli phase's coordinates: no segmentation launch,
          features/<name> of widths 1024/512/768/2048/1024 finite, coords
          and file attrs unchanged; for the five towers float32 on the
          card against the CPU <= 1e-4 on 4 patches (TF32 switched on
          before the build; uni_v1 and musk at depth 2, the rest whole),
          bf16 against float32 per-row cosine > 0.995 on 16, every param
          and floating buffer of the bf16 extractor bf16. Prints the
          reader's GB/s on uni_v1 and musk (page cache), each checkpoint's
          load + convert s, extract_batch bf16 patches/s at batch 32 (warm,
          median of 3 over 128 patches) per encoder and the peak memory,
          each beside the card's name and power limit
  finetune SAM2 fine-tuning at full Hiera-tiny width (input 1024, float32,
          batch 2; random weights written to an init .npz): 10 pairs of
          1024x768 from the port's synthetic corpus; finetune-sam2 --epochs 2
          --val-fraction 0.2 --save-every 1 --trainable norms in process
          (TF32 switched on first: the trainer must turn it off), then
          --resume --epochs 3 ("resumed at step 8"); detect-tissue with the
          fine-tuned sam2_finetuned.npz over the 2 held-out images, and
          evaluate-masks --csv of its masks against the truth. Checks: every
          loss finite; 0 kernel launches and 12 plain autograd attention
          calls in each train step, 12 launches (9 tf32x3, 3 f32_win) in each
          validation and detect-tissue forward; every non-norm tensor of the
          archive byte-identical to init, some norm tensor moved; one row per
          held-out pair in stdout and the CSV; one train step from the same
          init and batch on the card and on the CPU (loss within 1e-4
          relative, norm gradients within FT_GRAD_BOUND of each tensor's
          largest, measured and printed), and the same step with TF32
          switched on after the step is built, a control that must exceed
          FT_GRAD_BOUND; flash_attention refuses a CUDA
          input that requires grad. Prints the train step's ms by host clock
          (median after the first), images/s, one step's device-busy ms by
          torch.profiler, the validation forward's ms, the peak memory and
          the phase's seconds, beside the card's name and power limit
  multi   the multi-device paths on the one card, which each mesh names
          twice (MULTI_CARD) and two processes share. (k0) the attention
          kernel at the --fast trunk's shapes at 4 rows a replica and the
          int8 kernels at 16 patches a replica (M 3,152), against their
          plain versions at the kernel and int8 phases' bars; tensor-parallel
          int8's kernels at the (1, 2) mesh's shard shapes (vit_l_16's proj
          and fc2 rows, K 512 / 2,048 a shard, and dinov3_vit7b16's, K
          2,048 / 4,096 a shard, tanh GELU and SiLU of a gated pair; batch
          32): quantize_rows_s8's amax-only mode against its plain version,
          the shards' amaxes maxed equal to the whole row's and given-amax on
          each shard equal to the one-pass kernel's columns (max-abs 0), as
          the forward routes them (streamed bodies; an activation's
          amax-only stores its values and given-amax quantizes them by the
          identity prologue), and against the template's modes on each
          shard (max-abs 0), each call timed L2-cold beside the template's
          mode, the one-pass kernel, the plain version,
          torch.linalg.vector_norm (identity amax-only) and the byte bound
          of the function it replaces, int8_linear_s8's int32 output (routed to the wgmma body; the mma
          body and both wgmma tile widths forced) against int_product and
          dequant_sum_s32 of the two shards' partials against int8_linear_s8
          on the whole K (max-abs 0), with device ms, bound, plain ms and
          (int32) the mma body's and torch._int_mm's; the int32 partials of
          medsiglip's and virchow_v2's fc2 shards (K 2,152 and 1,708: rows at
          the 16-byte pitch, pad bytes 0x7f) routed to wgmma, every body
          against int_product and their dequant_sum_s32 against
          int8_linear_s8 (max-abs 0), with device ms (wgmma, mma over
          pitched and packed rows), bound, plain and torch._int_mm. (k1)
          SAM2SegmentationService on a (2, 1) mesh at full Hiera-tiny width:
          --fast (bfloat16, 768, batch 8: 4 rows a replica) on the seg
          phase's 16 thumbnails and float32 at 1024 (batch 2: 1 a replica;
          TF32 switched on before the build) on 2; masks against the
          one-device service (float32: bits differ only within 1e-4 of the
          threshold; bfloat16: >= 99.5% per thumbnail, the JAX package's
          partitioning bar); 12 attention launches per replica forward, by
          kernel_variant's counts. (k2) vit_l_16 on a (2, 1) data-parallel
          and a (1, 2) tensor-parallel mesh against one device on 32
          patches: float32 at depth 2 within 1e-4 (TF32 on before each
          build), bfloat16 at full depth per-patch cosine >= 0.999, int8
          data-parallel cosine >= 0.999 with 96 launches of each int8
          kernel per replica forward (48 / 24 / 24 by prologue, every linear
          on wgmma); int8 tensor-parallel (1, 2) at full depth against one
          device's int8, cosine >= 0.999, with one forward's launches by
          prologue, mode, quantizer body, linear body and dequant_sum_s32
          (_tp_launches); and
          dinov3_vit7b16, virchow_v2 and medsiglip at full width, depth 2,
          int8 tensor-parallel against one device, the same (every int32
          partial on wgmma). (k3) finetune-sam2 at the JAX defaults (1024, float32,
          global batch 2) on 5 synthetic 1024x768 pairs from one init
          archive: one process; --data-parallel 2 through the command line
          (losses at rtol 2e-3, 12 launches in its validation forward); two
          ranks sharing the card on gloo (python -c workers through
          maybe_init_distributed: the ranks' losses agree to 1e-5, rtol 2e-3
          to one process, only rank 0 writes sam2_finetuned.npz); a
          one-rank nccl group whose train step all-reduces its gradients on
          the card (one all-reduce, gradients within FT_GRAD_BOUND of the
          plain step's); one shard_train_step over the card named twice,
          its summed gradients within FT_GRAD_BOUND of the plain step's. (k4) segment-and-get-coords from two ranks of one
          gloo group over 4 (f1)-style JPEG SVS and one output directory:
          every slide's coordinates byte for byte one process's, each slide
          processed by one rank, no lock left. One line per part with its
          wall time and the card's name and power limit
  jobs    the port's launch scripts (jobs/atlaspatch_tpu_torch_*.sh) run with
          bash and PYTHON=sys.executable over 6 JPEG SVS of 4096x3072, each
          against an in-process _cli_main run of the argv the script hands
          the CLI (read by running it with a stub python), attention
          launches and forwards counted from each script process's own
          trace (ATLASPATCH_TORCH_TRACE: flash_fwd kernels, sam2_forward and
          embed_forward spans): (l1) two copies of the patch script at once
          on one output directory (SLURM_CPUS_PER_TASK=4,
          SLURM_GPUS_ON_NODE=1): rc 0, coordinates byte for byte, each slide
          processed by one copy, no lock left, 12 launches per forward;
          (l2) the features script (EXTRACTORS=vit_l_16) over that output:
          feature rows equal coordinate rows, features equal the in-process
          run's at max-abs 0 or else cosine >= JOB_FEATURE_COSINE (the bar
          that held is logged), and a second run makes no forward and
          rewrites no H5 file; (l3) the multi-node script on this node
          through this interpreter's torchrun, with stub srun and scontrol
          (localhost) and G=2 ranks sharing the card (gloo), and extra flags
          that give back (l1)'s segmentation settings under --fast: both
          ranks log their gloo group and host shard, coordinates equal
          (l1)'s byte for byte. Wall s per part
  quality (m1) one --trainable all AdamW step at full Hiera-tiny width,
          1024^2, batch 4, from one random init .npz, on the card and on the
          CPU: loss within 1e-4 relative, every gradient within FT_GRAD_BOUND
          of its tensor's largest |CPU gradient|, or of the step's largest
          for the key-bias tensors (exact gradient zero) and for those whose
          CPU float32 gradient lies further than half the bound from the
          float64 one taken on the card (sums that cancel; each printed with
          both distances), the same step with TF32 switched on over its
          bound; 0 kernel launches and
          12 plain autograd attention calls per train step; the step's ms by
          host clock, device-busy ms, images/s and peak memory. (m2) the
          mask-quality loop, bash atlaspatch_tpu_torch/tools/quality_loop.sh
          with PYTHON=sys.executable at its own options (96 training pairs
          of 1024x768, 16 held-out slides of 4096x3072, finetune-sam2
          --trainable all from random init, 20 epochs, batch 4, 1024^2;
          detect-tissue with the trained archive and with random weights;
          evaluate-masks), each output line time-stamped: rc 0, 20 epochs
          with the last train loss below the first, each detect-tissue
          process's trace (ATLASPATCH_TORCH_TRACE) 12 attention launches per
          forward (9 tf32x3, 3 f32_win), trained mean IoU >= 0.90 over the
          16 slides and its error (1 - IoU) at most 1/5 of the random
          baseline's. Prints the training wall time,
          each epoch's loss and val IoU, mean IoU, F1, precision and recall
          of both, beside the reference's IoU (0.980 trained, 0.149 random)

Then one JSON line with the kernel records: the two int8 kernels'
(``launches``: the int8 phase's command-line run, and for int8_linear_s8
``variant_launches``, the same by body; ``extract_launches``: its
extract_batch passes; ms, bound, plain and library ms summed over one
vit_l_16 forward at batch 32; for int8_linear_s8 also ``sources`` (both
bodies), ``mma_ms`` (the mma.sync body, forced), ``int_mm_ms``
(torch._int_mm alone), ``bf16_linear_ms``, ``virchow_fc2`` (the same per
virchow_v2 forward's 32 fc2 at batch 32 and 256, with the mma.sync body
over packed rows as packed_mma_ms), ``virchow_variant_launches`` and the
virchow_v2 forward's ms on each route) after the attention kernel's (``launches``: the seg phase's;
``runner_launches``: the runner phase's; ``tiff_launches``: the tiff phase's
(f1)+(f3) runner pass; ``process_launches``: the process phase's;
``cli_launches``: the cli phase's three in-process commands;
``weights_launches``: the weights phase's process, on existing coordinates;
the encoder path holds no TPU kernel of its own; ``finetune_launches``: the
finetune phase's validation and detect-tissue forwards; ``multi_launches``: the
multi phase's data-parallel segmentation, data-parallel and two-rank
fine-tuning and two-rank command line; ``jobs_launches``: the jobs
phase's script processes, from their traces; ``quality_launches``: the quality phase's
two detect-tissue processes, from their traces; the int8 records' ``multi_launches``:
its data-parallel int8 extract_batch) and tensor-parallel int8's four
records (quantize_rows_s8's amax-only and given-amax modes on their streamed
bodies, the template's modes on the same shards as before_ms, and for
amax-only proj's calls as proj_ms beside vector_norm's as proj_library_ms
and both modes as pair_ms, pair_before_ms and pair_bound_ms;
int8_linear_s8's int32 output with its mma body's time as mma_ms, the
ragged shards' rows as ``ragged`` and the ragged TP forwards' launches as
``ragged_tp_launches``;
dequant_sum_s32: ms, bound and plain ms summed over one vit_l_16 TP (1, 2)
forward at batch 32, launches in (k2)'s forward), the
card's name and power limit, and last the result line. Needs no network, no JAX and no h5py: the H5 files
are written and read by the port's own HDF5 code.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Random weights are the point here, so no checkpoint is looked for outside
# the checkout; the default path (no env overrides); stage counters on.
os.environ["ATLASPATCH_ALLOW_RANDOM_WEIGHTS"] = "1"
os.environ["ATLASPATCH_PROFILE"] = "1"
os.environ["HF_HOME"] = str(Path(__file__).resolve().parent / "_no_hf_cache")
for _var in ("ATLASPATCH_SAM2_CHECKPOINT", "ATLASPATCH_WEIGHTS_DIR", "ATLASPATCH_HOST_RESIZE",
             "ATLASPATCH_DEVICE_MASK_RESIZE", "ATLASPATCH_THUMB_QUANT", "ATLASPATCH_GELU_TANH"):
    os.environ.pop(_var, None)

# dense bf16 tensor core; FP32 CUDA cores; dense TF32 tensor core (3xTF32 takes three passes)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
H100_BYTES_PER_S = 3.35e12
# The record covers the kernel's three libraries: 9 of a --fast forward's 12
# calls run the wgmma body, 3 the mma.sync body of flash_attn.cu; a float32
# forward runs flash_attn.cu's tf32x3 body and flash_attn_f32win.cu.
KERNEL_SOURCES = ["atlaspatch_tpu_torch/csrc/flash_attn_wgmma.cu", "atlaspatch_tpu_torch/csrc/flash_attn.cu",
                  "atlaspatch_tpu_torch/csrc/flash_attn_f32win.cu"]
KERNEL_REPLACES = "atlaspatch_tpu/ops/attention.py:23"  # _flash_kernel
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NO_SPILL = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_total_ms: float = 60.0, max_reps: int = 50) -> float:
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(max_reps, max(3, min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _l2_flush():
    """Overwrite a 256 MB buffer (five times the H100's 50 MB L2), so that the next call reads from HBM."""
    import torch

    global _L2_BUFFER
    if _L2_BUFFER is None:
        _L2_BUFFER = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    _L2_BUFFER.zero_()


_L2_BUFFER = None


def device_ms(fn, reps: int = 20, tries: int = 3, kernel: str | None = "flash_fwd", seen: dict | None = None,
              cold: bool = False) -> float:
    """Mean device time in ms of one fn() call, by torch.profiler, after a
    warm-up (host time between launches is not counted).

    With ``kernel`` (the attention kernel's flash_fwd bodies): those kernels'
    self device time over the launches it recorded of ``reps`` calls. With
    ``kernel=None`` (a library call that may launch several kernels): every
    kernel's device time, over the launches of the one that took the most of
    it, the call's product kernel (so that a helper kernel launched more
    often than once a call does not shrink the mean). The profiler may drop
    some of a burst of launches, or now and then all of them (seen for
    cuBLASLt's _int_mm): the mean is over those it kept, a window that kept
    none is run again, up to ``tries`` times, and where no window kept one,
    fn() is timed by CUDA events instead (host gaps between launches
    included) and the log says so. With ``seen``, fills it with the kernels'
    names and launches in the window it read. With ``cold``, every call
    follows an L2 flush (``_l2_flush``, whose fill kernel is not counted; the
    CUDA-event fallback counts it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cold:
        def fn(call=fn):
            _l2_flush()
            return call()
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                  and (kernel is None or kernel in e.key) and not (cold and "FillFunctor" in e.key)]
        if kernel is None:
            count = max(events, key=lambda e: e.self_device_time_total).count if events else 0
        else:
            count = sum(e.count for e in events)
        if 0 < count <= reps:
            if seen is not None:
                seen.update((e.key, e.count) for e in events)
            return sum(e.self_device_time_total for e in events) / 1e3 / count
    ms = cuda_ms(fn)
    log(f"device_ms: the profiler saw {[(e.key, e.count) for e in events]} of {reps} launches of "
        f"{kernel or 'the call'} in each of {tries} windows; timed by CUDA events instead: {ms:.4f} ms")
    return ms


def other_float32_body(variant: str, tq: int, tk: int, d: int) -> str | None:
    """The body a float32 row is timed against: for f32_win, the one
    kernel_variant picked before f32_win took the windows; for tf32x3 at a
    window f32_win could take, f32_win; else None."""
    from atlaspatch_tpu_torch.ops.attention import F32WIN_MAX_T, TF32X3_HEAD_DIMS

    if variant == "f32_win":
        return "tf32x3" if d in TF32X3_HEAD_DIMS and tq > 16 else "f32"
    if variant == "tf32x3" and max(tq, tk) <= F32WIN_MAX_T:
        return "f32_win"
    return None


def attention_bound(shape, dtype_name: str) -> tuple[float, float]:
    """(operation-bound ms, byte-bound ms) of one attention call: QK^T and PV
    flops over the dtype's peak; Q, K, V read and O written once over HBM."""
    n, h, tq, tk, d = shape
    flops = 4.0 * n * h * tq * tk * d
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * n * h * d * (2 * tq + 2 * tk)
    return 1e3 * flops / H100_PEAK_FLOPS[dtype_name], 1e3 * nbytes / H100_BYTES_PER_S


def tf32x3_bound(shape) -> float:
    """ms of one float32 call on the tensor cores as 3xTF32: three TF32
    passes of its flops at the TF32 peak, or its bytes if they take longer."""
    n, h, tq, tk, d = shape
    return max(1e3 * 3 * 4.0 * n * h * tq * tk * d / H100_PEAK_FLOPS["tf32"],
               attention_bound(shape, "float32")[1])


def planted_faults(q, k, v, scale, want, limit) -> dict:
    """Max |fault - plain| / limit of two faults of a bfloat16 body, emulated
    in plain PyTorch on the same inputs: P rounded to fp8 (e4m3) in place of
    bfloat16, and the first 64-key K/V tile skipped."""
    import torch

    from atlaspatch_tpu_torch.ops.attention import reference_attention

    q, k, v = q.float(), k.float(), v.float()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q * scale, k), dim=-1)
    faults = {
        "p_fp8": torch.einsum("bhqk,bhkd->bhqd", p.to(torch.float8_e4m3fn).float(), v),
        "tile_skipped": reference_attention(q, k[:, :, 64:], v[:, :, 64:], scale),
    }
    return {name: ((out.to(torch.bfloat16).float() - want).abs() / limit).max().item()
            for name, out in faults.items()}


def planted_tf32_fault(q, k, v, scale, want, limit) -> dict:
    """Max |fault - plain| (max-abs) and max |fault - plain| / limit of a
    float32 body with one uncompensated TF32 pass, emulated in plain PyTorch:
    q * scale, k, v and P rounded to TF32 once (to nearest, by bit mask)."""
    import torch

    def tf32(x):
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", tf32(q * scale), tf32(k)), dim=-1)
    err = (torch.einsum("bhqk,bhkd->bhqd", tf32(p), tf32(v)) - want).abs()
    return {"max_abs": err.max().item(), "err/limit": (err / limit).max().item()}


def phase_env(state):
    import torch

    state["card"] = card_line()
    libs = {}
    for mod in ("PIL", "h5py", "cv2"):
        try:
            __import__(mod)
            libs[mod] = True
        except ImportError:
            libs[mod] = False
    log(f"env torch={torch.__version__} cuda={torch.version.cuda} "
        f"device={torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"card=[{state['card']}] host_libs={libs}")


def _ptxas_by_body(log: str) -> dict:
    """ptxas -v of a kernel library: per body (wgmma / mma / f32 / ...), the most
    registers and the instantiations (head dim first) with stack or spills."""
    bodies: dict = {}
    for name, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)", log, re.S):
        kind = re.search(r"flash_fwd_(wgmma|bf16|f32win|f32|tf32x3)_kernel", name).group(1)
        kind = {"bf16": "mma", "f32win": "f32_win"}.get(kind, kind)
        entry = bodies.setdefault(kind, {"kernels": 0, "max_registers": 0, "spilling": []})
        entry["kernels"] += 1
        registers = int(re.search(r"Used (\d+) registers", body).group(1))
        entry["max_registers"] = max(entry["max_registers"], registers)
        stack = re.search(r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill loads)", body)
        if stack and stack.group(1) != NO_SPILL:
            d, second = re.search(r"kernelILi(\d+)E(?:Li(\d+)E)?", name).groups()
            entry["spilling"].append(f"D={d}{'' if second is None else f'/{second}'}: {stack.group(1)}")
    return bodies


def _ptxas_int8(log: str) -> dict:
    """ptxas -v of int8_linear.so: per kernel (int8_linear_s8_wgmma /
    int8_linear_s8 / quantize_rows_s8 / quantize_stream_amax /
    quantize_stream_given / dequant_sum_s32), its instantiations, the most
    registers and those with stack or spills."""
    kernels: dict = {}
    for name, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)", log, re.S):
        kind = re.search(r"(int8_linear_s8_wgmma|int8_linear_s8|quantize_rows_s8|quantize_stream_amax|"
                         r"quantize_stream_given|dequant_sum_s32)_kernel", name).group(1)
        entry = kernels.setdefault(kind, {"kernels": 0, "max_registers": 0, "spilling": []})
        entry["kernels"] += 1
        entry["max_registers"] = max(entry["max_registers"], int(re.search(r"Used (\d+) registers", body).group(1)))
        stack = re.search(r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill loads)", body)
        if stack and stack.group(1) != NO_SPILL:
            entry["spilling"].append(f"{name}: {stack.group(1)}")
    return kernels


def phase_build(state):
    from atlaspatch_tpu_torch.build import build_log, nvcc_path
    from atlaspatch_tpu_torch.io.native import load_contours_library, load_tiff_library
    from atlaspatch_tpu_torch.ops.attention import load_f32win_library, load_flash_library, load_wgmma_library
    from atlaspatch_tpu_torch.ops.int8 import PROLOGUES, load_int8_library
    from atlaspatch_tpu_torch.tools.int8_variants import load_old_quantizer

    def timed(fn):
        t0 = time.perf_counter()
        lib = fn()
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=7) as pool:
        jobs = [pool.submit(timed, fn) for fn in (load_wgmma_library, load_flash_library, load_f32win_library,
                                                  load_int8_library, load_contours_library, load_tiff_library,
                                                  load_old_quantizer)]
        (wgmma_lib, wgmma_s), (flash_lib, flash_s), (win_lib, win_s), (int8_lib, int8_s), (_, contours_s), \
            (_, tiff_s), (_, old_s) = (j.result() for j in jobs)
    bodies = {**_ptxas_by_body(build_log(Path(wgmma_lib._name))),
              **_ptxas_by_body(build_log(Path(flash_lib._name))),
              **_ptxas_by_body(build_log(Path(win_lib._name)))}
    for body in ("wgmma", "tf32x3", "f32_win"):
        if body not in bodies or any(s.startswith("D=96") for s in bodies[body]["spilling"]):
            raise AssertionError(f"the {body} body is missing or spills at D = 96: {bodies.get(body)}")
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")

    def sass(lib):
        return subprocess.run([str(cuobjdump), "-sass", lib._name], capture_output=True, text=True,
                              check=True).stdout

    wgmma_sass, flash_sass, int8_sass = sass(wgmma_lib), sass(flash_lib), sass(int8_lib)
    ops = {op: wgmma_sass.count(op) for op in ("HGMMA", "UTMALDG", "USETMAXREG")}
    if not ops["HGMMA"] or not ops["UTMALDG"]:
        raise AssertionError(f"the wgmma library's SASS lacks HGMMA or UTMALDG: {ops}")
    hmma = Counter(re.findall(r"HMMA\.[\w.]+", flash_sass))
    if not any("TF32" in op for op in hmma):
        raise AssertionError(f"flash_attn.so's SASS has no TF32 HMMA: {dict(hmma)}")
    ctas = flash_lib.atlas_flash_attn_tf32x3_ctas_per_sm()
    if ctas < 1:
        raise AssertionError(f"the tf32x3 body fits no CTA on an SM (cudaError {-ctas})")
    win_ctas = win_lib.atlas_flash_attn_f32win_ctas_per_sm()
    if win_ctas < 1:
        raise AssertionError(f"the f32_win body fits no CTA on an SM (cudaError {-win_ctas})")
    int8_kernels = _ptxas_int8(build_log(Path(int8_lib._name)))
    imma = Counter(re.findall(r"\bI(?:G)?MMA\.[\w.]+|\bUTMALDG[\w.]*", int8_sass))
    int8_ops = {op: sum(n for name, n in imma.items() if name.split(".")[0] == op)
                for op in ("IMMA", "IGMMA", "UTMALDG")}
    if set(int8_kernels) != {"int8_linear_s8", "int8_linear_s8_wgmma", "quantize_rows_s8", "quantize_stream_amax",
                             "quantize_stream_given", "dequant_sum_s32"} \
            or not all(int8_ops.values()):
        raise AssertionError(f"int8_linear.so: kernels {int8_kernels}, SASS {dict(imma)}")
    if any(k["spilling"] for k in int8_kernels.values()):
        raise AssertionError(f"an int8 kernel spills: {int8_kernels}")
    prologues = sorted(set(int(p) for p in re.findall(r"quantize_rows_s8_kernelI\w+?Li\d+ELi\d+ELi(\d+)E",
                                                       build_log(Path(int8_lib._name)))))
    if prologues != list(range(len(PROLOGUES))):
        raise AssertionError(f"quantize_rows_s8 instantiates prologues {prologues}, not the {len(PROLOGUES)} of "
                             f"{PROLOGUES}")
    int8_warnings = [line.strip() for line in build_log(Path(int8_lib._name)).splitlines() if "warning" in line]
    if any("serialized" in line for line in int8_warnings):
        raise AssertionError(f"ptxas serializes the int8 wgmma: {int8_warnings}")
    log(f"build ok flash_attn_wgmma.so {wgmma_s:.1f}s, flash_attn.so {flash_s:.1f}s, "
        f"flash_attn_f32win.so {win_s:.1f}s, int8_linear.so {int8_s:.1f}s and the earlier two-read quantizer "
        f"{old_s:.1f}s (nvcc sm_90a), "
        f"atlas_contours.so {contours_s:.1f}s and "
        f"atlas_tiff.so {tiff_s:.1f}s (g++), "
        f"wall {time.perf_counter() - t0:.1f}s")
    for kind, entry in bodies.items():
        log(f"build ptxas {kind}: {entry['kernels']} kernels, max registers {entry['max_registers']}, "
            f"stack or spills: {'; '.join(entry['spilling']) or 'none'}")
    for kind, entry in int8_kernels.items():
        log(f"build ptxas {kind}: {entry['kernels']} instantiations, max registers {entry['max_registers']}, "
            f"stack or spills: {'; '.join(entry['spilling']) or 'none'}")
    log(f"build int8_linear.so SASS: {int8_ops} ({dict(imma)}); ptxas warnings: {int8_warnings or 'none'}; "
        f"quantize_rows_s8 prologues {dict(enumerate(PROLOGUES))} all instantiated")
    log(f"build wgmma SASS: {ops}; flash_attn.so SASS: {dict(hmma)}; at D = 96: tf32x3 {ctas} CTAs "
        f"of 128 threads per SM, f32_win {win_ctas} CTAs of 384 threads (8 consumer, 4 producer warps) per SM")


def phase_kernel(state):
    import torch
    import torch.nn.functional as F

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.hiera import trunk_attention_shapes
    from atlaspatch_tpu_torch.ops import attention as A

    cfg = SAM2Config.tiny()
    fast = trunk_attention_shapes(cfg, 768, 8)
    default = trunk_attention_shapes(cfg, 1024, 1)
    pair = trunk_attention_shapes(cfg, 1024, 2)  # finetune-sam2's validation forward, batch 2
    checks = [(s, "bfloat16", f"fast block {i}") for i, s in enumerate(fast)]
    checks += [(s, "float32", f"f32-1024 block {i}") for i, s in enumerate(default)]
    checks += [(s, "float32", f"f32-1024x2 block {i}") for i, s in enumerate(pair)]
    checks += [
        ((2, 1, 196, 196, 96), "float32", "ragged window"),
        ((1024, 8, 49, 196, 96), "float32", "q-pool 49/196"),
        ((9216, 2, 16, 64, 96), "float32", "q-pool 16/64"),
        ((8, 4, 2304, 2304, 96), "float32", "global 2304 in f32"),
        ((2, 1, 300, 300, 128), "float32", "FMA body D=128"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst, faults, tf32_fault = [], 0.0, None, None
    worst_ratio = {"bfloat16": 0.0, "float32": 0.0}
    for shape, dtype_name, label in checks:
        n, h, tq, tk, d = shape
        dtype = getattr(torch, dtype_name)
        q = torch.randn(n, h, tq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(n, h, tk, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(n, h, tk, d, device="cuda", generator=gen).to(dtype)
        scale = d**-0.5
        variant = A.kernel_variant(dtype, tq, tk, d)
        got = A.flash_attention(q, k, v, scale)
        error_limit = A.bf16_error_limit if dtype == torch.bfloat16 else A.f32_error_limit
        want, limit = error_limit(q, k, v, scale)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        ratio = ((got.float() - want).abs() / limit).max().item()
        if not (err <= TOL[dtype_name] and ratio <= 1.0):
            raise AssertionError(f"kernel disagrees at {label} {shape} {dtype_name}: max abs "
                                 f"{err}, max err/limit {ratio}")
        worst = max(worst, err)
        worst_ratio[dtype_name] = max(worst_ratio[dtype_name], ratio)
        if faults is None and dtype == torch.bfloat16 and tq == tk == 2304:
            faults = planted_faults(q, k, v, scale, want, limit)
            if not min(faults.values()) > 1.0:
                raise AssertionError(f"a planted fault passes the bfloat16 limit: {faults}")
        if tf32_fault is None and dtype == torch.float32 and tq == tk == 4096:
            tf32_fault = planted_tf32_fault(q, k, v, scale, want, limit)
            if not tf32_fault["err/limit"] > 1.0:
                raise AssertionError(f"a single TF32 pass passes the float32 limit: {tf32_fault}")
        del got, want, limit
        ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale))
        dev_ms = device_ms(lambda: A.flash_attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: A.reference_attention(q, k, v, scale))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        # SDPA is timed only, never called by the port; by device time too,
        # since CUDA events read mostly host time for calls under ~0.05 ms
        sdpa_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), kernel=None)
        op_ms, byte_ms = attention_bound(shape, dtype_name)
        row = dict(label=label, shape=shape, dtype=dtype_name, variant=variant, err=err, ms=ms,
                   dev_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms, sdpa_dev_ms=sdpa_dev_ms,
                   op_ms=op_ms, byte_ms=byte_ms)
        other = other_float32_body(variant, tq, tk, d) if dtype == torch.float32 else None
        if other:
            row["other"] = other
            row["other_ms"] = cuda_ms(lambda: A._launch(other, q, k, v, scale))
            row["other_dev_ms"] = device_ms(lambda: A._launch(other, q, k, v, scale))
            other = (f" other={other} ms={row['other_ms']:.4f} dev_ms={row['other_dev_ms']:.4f} "
                     f"({'faster' if dev_ms < row['other_dev_ms'] else 'NOT faster'} by device time)")
        rows.append(row)
        log(f"kernel {label:18s} (BH={n}x{h}, Tq={tq}, Tkv={tk}, D={d}) {dtype_name:8s} "
            f"{variant:10s} max_abs_err={err:.3g} err/limit={ratio:.3g} ms={ms:.4f} dev_ms={dev_ms:.4f} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} sdpa_dev_ms={sdpa_dev_ms:.4f} "
            f"({'kernel faster' if dev_ms < sdpa_dev_ms else 'SDPA faster'} by device time) "
            f"bound_ms={max(op_ms, byte_ms):.4f} "
            f"({'operations' if op_ms >= byte_ms else 'bytes'})"
            + (f" tf32x3_bound_ms={tf32x3_bound(shape):.4f}" if dtype_name == "float32" else "")
            + (other or "") + f" [{state['card']}]")
        del q, k, v
    torch.cuda.empty_cache()

    # The record: one --fast forward's 12 trunk attention calls, summed; the
    # bound is the sum of each call's bound, named by the larger share of it.
    fast_rows = rows[: len(fast)]
    op = sum(r["op_ms"] for r in fast_rows if r["op_ms"] >= r["byte_ms"])
    byte = sum(r["byte_ms"] for r in fast_rows if r["op_ms"] < r["byte_ms"])
    state["kernel_record"] = {
        "name": "flash_attn",
        "route": "cuda",
        "source": KERNEL_SOURCES[0],
        "sources": KERNEL_SOURCES,
        "replaces": KERNEL_REPLACES,
        "max_abs_err": worst,
        "ms": sum(r["ms"] for r in fast_rows),
        "plain_ms": sum(r["plain_ms"] for r in fast_rows),
        "bound_ms": op + byte,
        "bound_by": "operations" if op >= byte else "bytes",
        "library_ms": sum(r["library_ms"] for r in fast_rows),
    }
    log(f"kernel ok: {len(rows)} shapes, max_abs_err {worst:.3g}; max err/limit bfloat16 "
        f"{worst_ratio['bfloat16']:.3g}, float32 {worst_ratio['float32']:.3g}; planted faults at "
        f"the global blocks: bfloat16 err/limit {({k_: round(v_, 3) for k_, v_ in faults.items()})}, "
        f"one TF32 pass in float32 max abs {tf32_fault['max_abs']:.3g} err/limit "
        f"{tf32_fault['err/limit']:.3g} [{state['card']}]")
    f32_rows = rows[len(fast) : len(fast) + len(default)]
    pair_rows = rows[len(fast) + len(default) : len(fast) + len(default) + len(pair)]
    for name, group in (("--fast", fast_rows), ("float32", f32_rows), ("float32 batch-2", pair_rows)):
        log(f"kernel one {name} forward's 12 calls: kernel {sum(r['ms'] for r in group):.3f} ms "
            f"(device {sum(r['dev_ms'] for r in group):.3f}), "
            f"plain {sum(r['plain_ms'] for r in group):.3f} ms, sdpa "
            f"{sum(r['library_ms'] for r in group):.3f} ms (device {sum(r['sdpa_dev_ms'] for r in group):.3f})"
            ", bound "
            f"{sum(max(r['op_ms'], r['byte_ms']) for r in group):.3f} ms"
            + (f" (3xTF32 bound {sum(tf32x3_bound(r['shape']) for r in group):.3f} ms)"
               if name.startswith("float32") else "")
            + f" [{state['card']}]")
    win = [r for r in f32_rows if r["variant"] == "f32_win"]
    log(f"kernel the float32 forward's {len(win)} f32_win calls: {sum(r['ms'] for r in win):.4f} ms "
        f"(device {sum(r['dev_ms'] for r in win):.4f}); the bodies before, forced: "
        f"{sum(r['other_ms'] for r in win):.4f} ms (device {sum(r['other_dev_ms'] for r in win):.4f}); "
        f"sdpa {sum(r['library_ms'] for r in win):.4f} ms (device {sum(r['sdpa_dev_ms'] for r in win):.4f}); bound "
        f"{sum(max(r['op_ms'], r['byte_ms']) for r in win):.4f} ms [{state['card']}]")
    if not any(r["variant"] == "f32" for r in rows):
        raise AssertionError("no kernel row ran on the FMA body")


def _thumbnails(shapes_wh, per_shape, seed0=0):
    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    thumbs, seed = [], seed0
    for w, h in shapes_wh:
        for _ in range(per_shape):
            thumbs.append(make_tissue_canvas(w, h, seed=seed))
            seed += 1
    return thumbs


def _run_service(svc, thumbs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = svc.segment_thumbnails_async(thumbs)()
    torch.cuda.synchronize()
    return masks, time.perf_counter() - t0


def phase_seg(state):
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.core.config import SegmentationConfig
    from atlaspatch_tpu_torch.models.sam2.hiera import trunk_attention_shapes
    from atlaspatch_tpu_torch.models.sam2.model import pil_nearest_index, thumbs_to_logits
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
    from atlaspatch_tpu_torch.utils import perf

    fast_thumbs = _thumbnails([(256, 192), (224, 160)], per_shape=8)
    f32_thumbs = _thumbnails([(256, 192), (224, 160)], per_shape=1, seed0=100)
    fast = SAM2SegmentationService(
        SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
    )
    f32 = SAM2SegmentationService(SegmentationConfig(device="cuda", precision="float32", batch_size=1))
    assert next(fast.predictor.model.parameters()).dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in fast.predictor.model.parameters())
    # warm-up (cuDNN plans, allocator): not part of the counted run
    _run_service(fast, fast_thumbs)
    _run_service(f32, f32_thumbs)

    perf.reset()
    A.reset_launch_counts()
    fast_masks, fast_s = _run_service(fast, fast_thumbs)
    f32_masks, f32_s = _run_service(f32, f32_thumbs)
    launches = A.flash_attention.launches
    variants = dict(A.flash_attention.variant_launches)
    forwards = 2 + 2  # (a): one batch of 8 per thumbnail shape; (b): one per thumbnail
    if launches != 12 * forwards:
        raise AssertionError(f"kernel launched {launches} times in {forwards} forwards, want 12 each")
    cfg = fast.predictor.model.cfg
    want = Counter()
    for dtype, size, batch, n in ((torch.bfloat16, 768, 8, 2), (torch.float32, 1024, 1, 2)):
        for _, _, tq, tk, d in trunk_attention_shapes(cfg, size, batch):
            want[A.kernel_variant(dtype, tq, tk, d)] += n
    # (a): the global blocks on the 192-row wgmma tile; (b): 9 tf32x3 and 3
    # f32_win per forward, none on the FMA body
    if (variants != dict(want) or want["wgmma_m192"] != 3 * 2 or want["tf32x3"] != 9 * 2
            or want["f32_win"] != 3 * 2 or "f32" in want):
        raise AssertionError(f"kernel variants launched {variants}, want {dict(want)}")
    state["launches"] = launches
    stages = perf.report()

    for masks, thumbs in ((fast_masks, fast_thumbs), (f32_masks, f32_thumbs)):
        for m, t in zip(masks, thumbs):
            assert m.data.shape == t.shape[:2] and np.isin(m.data, (0.0, 1.0)).all()
    log(f"seg (a) --fast bf16 input 768 batch 8: {len(fast_thumbs)} thumbnails in {fast_s:.3f} s "
        f"= {len(fast_thumbs) / fast_s:.2f} thumbnails/s; tissue fraction "
        f"{np.mean([m.data.mean() for m in fast_masks]):.3f} [{state['card']}]")
    log(f"seg (b) f32 input 1024 batch 1: {len(f32_thumbs)} thumbnails in {f32_s:.3f} s "
        f"= {len(f32_thumbs) / f32_s:.2f} thumbnails/s [{state['card']}]")
    log(f"seg kernel launches {launches} in {forwards} forwards (12 per forward), by variant "
        f"{variants}")
    log("seg stages " + json.dumps(stages) + f" [{state['card']}]")

    # (b) on the card (every trunk attention is the kernel) vs the same
    # params on the CPU (every trunk attention is the plain version).
    model = f32.predictor.model
    cpu_model = copy.deepcopy(model).to("cpu")
    S = f32.predictor.input_size
    threshold = f32.cfg.mask_threshold
    for thumb, mask in zip(f32_thumbs, f32_masks):
        t = torch.from_numpy(thumb)[None]
        card_logits = thumbs_to_logits(model, t.cuda())[0].cpu()
        cpu_logits = thumbs_to_logits(cpu_model, t)[0]
        diff = (card_logits - cpu_logits).abs().max().item()
        scale = cpu_logits.abs().max().item()
        if not diff <= 1e-3 * scale:
            raise AssertionError(f"card vs CPU logits differ by {diff} (max |logit| {scale})")
        h, w = thumb.shape[:2]
        small = cpu_logits.numpy()[pil_nearest_index(h, S)][:, pil_nearest_index(w, S)]
        differ = mask.data != (small > threshold)
        if (differ & (np.abs(small - threshold) >= diff)).any():
            raise AssertionError("card mask bits differ from CPU away from the threshold")
        log(f"seg (b) card vs CPU {h}x{w}: max |logit diff| {diff:.3g} "
            f"(<= 1e-3 x max|logit| {scale:.3g}); mask bits differing {int(differ.sum())}, "
            f"all within |logit - threshold| < {diff:.3g}")
    state["fast_masks"] = [m.data for m in fast_masks]
    state["services"] = {"--fast bf16 768 batch 8": (fast, fast_thumbs[:8]),
                         "f32 1024 batch 1": (f32, f32_thumbs[:1])}


def phase_profile(state):
    """One forward of each setting under torch.profiler: device time by
    kernel, and its share of the forward's host-clock time (the best of 3
    runs without the profiler, which slows the host); the forward's FLOPs
    (tools/sam2_ceiling.py's count) and their rate over the busy time as a
    share of the card's peak for the setting's precision."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atlaspatch_tpu_torch.tools.sam2_ceiling import PEAK_TFLOPS, analyze_size

    for label, (svc, thumbs) in state.pop("services").items():
        precision = svc.cfg.precision
        gflop = analyze_size(svc.predictor.input_size, len(thumbs), precision)["flops_per_thumb"] * len(thumbs) / 1e9
        wall_s = min(_run_service(svc, thumbs)[1] for _ in range(3))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _run_service(svc, thumbs)
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy_us = sum(e.self_device_time_total for e in rows)
        if busy_us == 0:
            raise AssertionError("the profiler recorded no device time")
        rows.sort(key=lambda e: -e.self_device_time_total)
        log(f"profile {label}: forward {1e3 * wall_s:.2f} ms host clock (thumbnails in, masks "
            f"out), device busy {busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall_s:.1f}%), "
            f"{sum(e.count for e in rows)} kernel launches [{state['card']}]")
        tflops = gflop / 1e3 / (busy_us / 1e6)
        log(f"profile {label}: {gflop:.2f} GFLOP per forward (tools/sam2_ceiling.py: matrix products, "
            f"convolutions, attention) -> {tflops:.1f} TFLOP/s over the busy time = "
            f"{100 * tflops / PEAK_TFLOPS[precision]:.1f}% of the {PEAK_TFLOPS[precision]:.0f} TFLOP/s "
            f"{precision} peak; over the host-clock forward {gflop / 1e3 / wall_s:.1f} TFLOP/s [{state['card']}]")
        for e in rows[:12]:
            us = e.self_device_time_total
            log(f"profile   {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f}% x{e.count:<4d} {e.key[:110]}")
        svc.close()


def phase_coords(state):
    import numpy as np

    from atlaspatch_tpu_torch.core.config import ExtractionConfig
    from atlaspatch_tpu_torch.io.synthetic_wsi import SyntheticWSI
    from atlaspatch_tpu_torch.ops import contours
    from atlaspatch_tpu_torch.ops.polygon import point_polygon_test, point_polygon_test_numpy
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService

    wsi = SyntheticWSI(size=(4096, 3072), mpp=0.5, seed=0)
    W, H = wsi.get_size(lv=0)  # opens the slide: magnification 20x from mpp 0.5
    svc = PatchExtractionService(ExtractionConfig(patch_size=256, target_magnification=20))
    level, _, psrc, step, _ = svc._prepare_geometry(wsi)
    counts, host_ms = [], []
    for mask in state["fast_masks"]:
        t0 = time.perf_counter()
        coords = svc.compute_coords(*svc._prepare_contours(mask, wsi), patch_size_src=psrc, step_src=step)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        assert coords.ndim == 2 and coords.shape[1] == 2
        assert (coords >= 0).all() and (coords[:, 0] < W).all() and (coords[:, 1] < H).all()
        counts.append(int(coords.shape[0]))
    # the native containment scan against its numpy oracle on the first mask
    tissue, holes = svc._prepare_contours(state["fast_masks"][0], wsi)
    native = svc.compute_coords(tissue, holes, patch_size_src=psrc, step_src=step)
    contours.point_polygon_test = point_polygon_test_numpy
    try:
        oracle = svc.compute_coords(tissue, holes, patch_size_src=psrc, step_src=step)
    finally:
        contours.point_polygon_test = point_polygon_test
    if native.tobytes() != oracle.tobytes():
        raise AssertionError("native containment disagrees with the numpy oracle")
    if sum(counts) == 0:
        raise AssertionError("no patch coordinates from any mask")
    log(f"coords ok: level {level}, patch {psrc}px step {step}px on {W}x{H}; per slide "
        f"{counts}; host ms per slide mean {np.mean(host_ms):.2f} max {np.max(host_ms):.2f}")


RUNNER_SLIDES, RUNNER_WH = 28, (4096, 3072)  # bench.py's seg_coords_synthetic corpus


def _runner_corpus():
    """bench.py's seg_coords_synthetic corpus: (stems, {stem: SyntheticWSI})."""
    from atlaspatch_tpu_torch.io.synthetic_wsi import SyntheticWSI, make_tissue_canvas

    canvases = [make_tissue_canvas(*RUNNER_WH, seed=s, n_blobs=3) for s in range(4)]
    stems = [f"slide{i:03d}" for i in range(RUNNER_SLIDES)]
    wsis = {stem: SyntheticWSI(path=f"/virtual/{stem}.svs", mpp=0.5, level0=canvases[i % 4], levels=3)
            for i, stem in enumerate(stems)}
    return stems, wsis


class _Loader:
    """The corpus's slides by stem, reopened fresh, timed as DefaultWSILoader times it."""

    def __init__(self, wsis):
        self.wsis = wsis

    def open(self, slide):
        from atlaspatch_tpu_torch.utils import perf

        with perf.stage("wsi_open"):
            wsi = self.wsis[slide.stem]
            wsi._loaded = False  # fresh open semantics
            return wsi


class _NullResolver:
    def resolve(self, slide):
        return None


def _thresholding_service(cfg):
    """The port's SAM2 service with bench.py's BenchSegmentation twist: the
    real device step runs and its masks are waited for, but extraction gets
    the thumbnail thresholded at < 220, since random-weight masks have no
    structure to extract patches from."""
    import numpy as np

    from atlaspatch_tpu_torch.core.models import Mask
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService

    class ThresholdingSegmentation(SAM2SegmentationService):
        def segment_thumbnails_async(self, thumbs):
            device_resolve = super().segment_thumbnails_async(thumbs)
            tissue = [(np.asarray(t.convert("L"), np.float32) < 220).astype(np.float32) for t in thumbs]

            def resolve():
                device_resolve()  # the real masks, fetched from the card
                return [Mask(data=m, source_shape=m.shape) for m in tissue]

            return resolve

    return ThresholdingSegmentation(cfg)


def phase_runner(state):
    """segment-and-get-coords through the port's ProcessingRunner: 28 synthetic
    slides in batches of 8 (pend depth 3 and the remainder batch both run) on
    the --fast preset, one atomic H5 per slide by the port's own writer, then
    a second run that must skip every slide."""
    import tempfile

    from atlaspatch_tpu_torch.core.config import SegmentationConfig

    stems, wsis = _runner_corpus()
    seg_cfg = SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
    seg = _thresholding_service(seg_cfg)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_runner_"))
    try:
        _drive_runner(state, seg, seg_cfg, stems, tmp, loader=_Loader(wsis), open_wsi=wsis.__getitem__,
                      what=f"{len(stems)} slides of {RUNNER_WH[0]}x{RUNNER_WH[1]}")
    finally:
        seg.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if state["runner_launches"] != 12 * state["runner_forwards"]:
        raise AssertionError(f"runner: {state['runner_launches']} kernel launches in "
                             f"{state['runner_forwards']} forwards, want 12 each")


def _drive_runner(state, seg, seg_cfg, stems, tmp, *, loader, open_wsi, what, in_dir=None, name="runner"):
    """One counted ProcessingRunner pass over ``stems`` (slides opened by
    ``loader``; ``open_wsi(stem)`` opens one again for the checks), its
    checks, and a skip pass. ``in_dir``: the slides' directory, else empty
    placeholders are written. Records ``<name>_launches``, ``_forwards``,
    ``_rate`` (slides/s) and ``_stages`` in ``state``."""
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.core.config import AppConfig, ExtractionConfig, OutputConfig, ProcessingConfig
    from atlaspatch_tpu_torch.core.paths import patch_h5_path
    from atlaspatch_tpu_torch.models.sam2.hiera import trunk_attention_shapes
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.storage import H5PatchWriter
    from atlaspatch_tpu_torch.utils import perf
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    masks: dict = {}

    class RecordingExtraction(PatchExtractionService):
        def extract(self, wsi, mask, *, slide):
            masks[slide.stem] = mask
            return super().extract(wsi, mask, slide=slide)

    if in_dir is None:
        in_dir = tmp / "slides"
        in_dir.mkdir()
        for stem in stems:
            (in_dir / f"{stem}.svs").touch()  # discovery placeholders
    cfg = AppConfig(
        processing=ProcessingConfig(input_path=in_dir),
        segmentation=seg_cfg,
        extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
        output=OutputConfig(output_root=tmp / "out", skip_existing=True),
        device="cuda",
    )

    def runner():
        return ProcessingRunner(config=cfg, segmentation=seg,
                                extractor=RecordingExtraction(cfg.extraction, cfg.output),
                                visualizer=None, mpp_resolver=_NullResolver(), wsi_loader=loader)

    # warm-up outside the counted run: both batch sizes
    for n in (seg_cfg.batch_size, len(stems) % seg_cfg.batch_size):
        seg.segment_thumbnails_async(seg.prepare_thumbnails([open_wsi(s) for s in stems[:n]]))()
    torch.cuda.synchronize()

    order = [s.stem for s in runner().discover_slides()]  # the runner's batches, in order
    perf.reset()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    results, failures = runner().run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, variants = A.flash_attention.launches, dict(A.flash_attention.variant_launches)
    stages = perf.report()
    state.update({f"{name}_launches": launches, f"{name}_rate": len(stems) / wall_s, f"{name}_stages": stages})

    # the service runs one forward per thumbnail shape in each batch
    batch = seg_cfg.batch_size
    forwards = sum(len({masks[s].shape for s in order[i : i + batch] if s in masks})
                   for i in range(0, len(order), batch))
    shapes = trunk_attention_shapes(seg.predictor.model.cfg, seg_cfg.input_size, seg_cfg.batch_size)
    want = Counter()
    for _, _, tq, tk, d in shapes:
        want[A.kernel_variant(torch.bfloat16, tq, tk, d)] += forwards
    state[f"{name}_forwards"] = forwards
    if launches != len(shapes) * forwards or variants != dict(want):
        raise AssertionError(f"{name}: kernel launched {launches} times by variant {variants} in "
                             f"{forwards} forwards, want {len(shapes)} each: {dict(want)}")
    if failures or sorted(r.slide.stem for r in results) != sorted(stems):
        raise AssertionError(f"{name}: {len(results)} results, failures {failures}")

    extraction = PatchExtractionService(cfg.extraction, cfg.output)
    names = set(H5PatchWriter(chunk_rows=1, patch_size=1, patch_size_level0=1, level0_mag=1, target_mag=1,
                              level0_wh=(1, 1), overlap=0, slide_stem="x", wsi_path="x")._file_attrs())
    passport = re.compile(r"(.+)__x(\d+)_y(\d+)_rw(\d+)_rh(\d+)_lv(\d+)_mag(\w+)_tmag(\w+)_total(\d+)")
    counts, read_ms = [], []
    for res in results:
        stem, wsi = res.slide.stem, open_wsi(res.slide.stem)
        path = patch_h5_path(res.slide, cfg.output, cfg.extraction)
        if res.h5_path != path:
            raise AssertionError(f"{name}: {stem} written to {res.h5_path}, want {path}")
        t1 = time.perf_counter()
        datasets, attrs = read_h5(path)
        read_ms.append(1e3 * (time.perf_counter() - t1))
        entries = extraction._iter_patch_entries(wsi, *extraction._prepare_contours(masks[stem], wsi),
                                                 include_patch=False)
        want_coords = np.asarray([e[:5] for e in entries], dtype=np.int32).reshape(-1, 5)
        coords = datasets["coords"]
        n = coords.shape[0]
        if coords.dtype != np.int32 or coords.tobytes() != want_coords.tobytes():
            raise AssertionError(f"{name}: {stem} coords differ from its extraction's rows")
        if attrs["num_patches"] != n or res.num_patches != n:
            raise AssertionError(f"{name}: {stem} num_patches {attrs['num_patches']} for {n} rows")
        missing = (names | {"num_patches"}) - set(attrs)
        if missing:
            raise AssertionError(f"{name}: {stem} lacks file attrs {sorted(missing)}")
        for row, text in zip(coords, datasets["passports"]):
            m = passport.fullmatch(text.decode("ascii"))
            if not m or m.group(1) != stem or [int(g) for g in m.groups()[1:6]] != row.tolist() \
                    or int(m.group(9)) != n:
                raise AssertionError(f"{name}: {stem} passport {text!r} does not parse to {row}")
        counts.append(n)
    if not max(counts) > 0:
        raise AssertionError(f"{name}: no slide has a patch")
    leftovers = [p.name for p in (tmp / "out" / "patches").iterdir() if not p.name.endswith(".h5")]
    if leftovers or len(list((tmp / "out" / "patches").glob("*.h5"))) != len(stems):
        raise AssertionError(f"{name}: lock or stage files left behind: {leftovers}")

    # the skip pass: same output, skip_existing, nothing launched or rewritten
    mtimes = {p: p.stat().st_mtime_ns for p in (tmp / "out" / "patches").iterdir()}
    A.reset_launch_counts()
    results2, failures2 = runner().run()
    torch.cuda.synchronize()
    if results2 or failures2 or A.flash_attention.launches:
        raise AssertionError(f"{name}: the skip pass gave {len(results2)} results, {failures2}, "
                             f"{A.flash_attention.launches} kernel launches")
    if {p: p.stat().st_mtime_ns for p in (tmp / "out" / "patches").iterdir()} != mtimes:
        raise AssertionError(f"{name}: the skip pass rewrote files")

    h5 = stages.get("h5_write", {})
    slowest = max(stages, key=lambda k: stages[k]["total_s"])
    log(f"{name} {what} (--fast bf16 768 batch 8, "
        f"patch 256 at 20x): {wall_s:.3f} s = {len(stems) / wall_s:.2f} slides/s by host clock; "
        f"kernel launches {launches} in {forwards} forwards, by variant {variants}; patches per slide "
        f"{counts} [{state['card']}]")
    log(f"{name} h5 write {h5.get('mean_ms', float('nan')):.3f} ms per slide (cpu "
        f"{1e3 * h5.get('cpu_s', 0) / max(1, h5.get('count', 1)):.3f} ms), read_h5 back "
        f"{np.mean(read_ms):.3f} ms per slide; the stage that takes most host time: {slowest} "
        f"[{state['card']}]")
    log(f"{name} stages " + json.dumps(stages) + f" [{state['card']}]")
    if slowest == "h5_write":
        raise AssertionError(f"{name}: the H5 writer is the slowest stage: {stages}")
    log(f"{name} skip pass: 0 results, 0 failures, 0 kernel launches, no file rewritten")


# The tiff phase's corpus, written on the card's host by the repo's own
# writers (tests/tiff_builder.py, tests/container_builders.py):
# (f1) bench.py's write_tiff_corpus setting (bench.py:251-274), (f2) one
# slide of a 20x biopsy scan's size, (f3) one slide of each other container.
TIFF_SLIDES, TIFF_WH = 28, (4096, 3072)
BIG_WH, CONTAINER_WH = (16384, 12288), (2048, 1536)
APERIO_DESC = "Aperio Image Library v12\r\n{}x{} | AppMag = 20 | MPP = 0.5"
EMBED_CHECK_PATCHES = 64


def _builders():
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import container_builders
    import tiff_builder

    return tiff_builder, container_builders


def _write_svs(path: str, wh, seed: int, levels: int) -> str:
    """A JPEG-tiled Aperio pyramid (tile 256, compression 7) of a
    make_tissue_canvas canvas (runs in a worker process)."""
    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    tiff_builder, _ = _builders()
    tiff_builder.write_pyramid(path, make_tissue_canvas(*wh, seed=seed, n_blobs=3), levels=levels, tile=256,
                               compression=7, description=APERIO_DESC.format(*wh))
    return path


def _zero_sof_dims(jpeg: bytes) -> bytes:
    """Zero the JPEG SOF height and width, as NDPI writers do past 65,535 px."""
    data = bytearray(jpeg)
    i = data.find(b"\xff\xc0")
    data[i + 5 : i + 9] = b"\x00\x00\x00\x00"
    return bytes(data)


def _write_containers(d: str) -> dict:
    """(f3): an NDPI (a single-strip restart-marker JPEG of zeroed SOF
    dimensions at 20x, a 5x level), a 3-level MIRAX, a 2x2 Hamamatsu VMS, a
    VMU and a 2-level DICOM series with a label instance; {stem: path}."""
    import io

    from PIL import Image

    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    tiff_builder, cb = _builders()
    d = Path(d)
    w, h = CONTAINER_WH
    canvas = {k: make_tissue_canvas(w, h, seed=200 + i, n_blobs=3)
              for i, k in enumerate(("ndpi", "mirax", "vms", "vmu", "dicom"))}
    ndpi = [(65420, tiff_builder.TYPE_LONG, [1]), (65421, tiff_builder.TYPE_FLOAT, [20.0])]
    buf = io.BytesIO()
    Image.fromarray(canvas["ndpi"]).save(buf, "JPEG", quality=90, subsampling=0, restart_marker_rows=1)
    writer = tiff_builder.TiffWriter()
    writer.add_level_raw_strips([_zero_sof_dims(buf.getvalue())], width=w, height=h, rows_per_strip=h,
                                extra_tags=ndpi, resolution=(20000.0, 20000.0, 3))
    writer.add_level(canvas["ndpi"][::4, ::4].copy(),
                     extra_tags=[ndpi[0], (65421, tiff_builder.TYPE_FLOAT, [5.0])])
    writer.save(d / "ndpi.ndpi")
    cb.write_mirax(d / "mirax.mrxs", canvas["mirax"], tile_w=256, tile_h=192, n_levels=3, mpp=0.5, objective=20)
    cb.write_vms(d / "vms.vms", canvas["vms"], cols=2, rows=2, mpp=0.5, lens=20)
    cb.write_vmu(d / "vmu.vmu", canvas["vmu"], column_width=256, mpp=0.5, lens=20)
    base = cb.write_dicom_pyramid(d, canvas["dicom"], n_levels=2, tile=256, mpp=0.5)
    return {"ndpi": d / "ndpi.ndpi", "mirax": d / "mirax.mrxs", "vms": d / "vms.vms", "vmu": d / "vmu.vmu",
            base.stem: base}


def _write_j2k(path: str) -> str:
    """An Aperio 33003 (YCbCr J2K) level of 512x512, tile 256."""
    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas

    tiff_builder, _ = _builders()
    ycc = tiff_builder.rgb_to_full_range_ycbcr(make_tissue_canvas(512, 512, seed=300, n_blobs=2))
    tiff_builder.write_pyramid(path, ycc, levels=1, tile=256, compression=33003)
    return path


def _write_tiff_corpus(root: Path) -> dict:
    """Write the corpus with one spawned process per distinct file; the other
    24 (f1) slides are byte copies of the four canvases' files, as
    write_pyramid would write them again."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    f1, f3, big = root / "f1", root / "f3", root / "big"
    for d in (f1, f3, big):
        d.mkdir()
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=7, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {
            "big": pool.submit(_write_svs, str(big / "big.svs"), BIG_WH, 400, 4),
            "f1": [pool.submit(_write_svs, str(f1 / f"tslide{s:03d}.svs"), TIFF_WH, 100 + s, 3) for s in range(4)],
            "f3": pool.submit(_write_containers, str(f3)),
            "j2k": pool.submit(_write_j2k, str(root / "j2k.svs")),
        }
        f3_paths = jobs["f3"].result()
        big_path = Path(jobs["big"].result())
        for job in jobs["f1"]:
            job.result()
        j2k = Path(jobs["j2k"].result())
    for i in range(4, TIFF_SLIDES):
        shutil.copyfile(f1 / f"tslide{i % 4:03d}.svs", f1 / f"tslide{i:03d}.svs")
    # one runner input: the (f1) slides and the (f3) containers side by side
    slides = root / "slides"
    slides.mkdir()
    paths = {}
    for src in sorted(f1.iterdir()) + sorted(f3.iterdir()):
        (slides / src.name).symlink_to(src)
    for stem, src in f3_paths.items():
        paths[stem] = slides / Path(src).name
    for i in range(TIFF_SLIDES):
        paths[f"tslide{i:03d}"] = slides / f"tslide{i:03d}.svs"
    size = j2k.stat().st_size + sum(p.stat().st_size for d in (f1, f3, big) for p in d.rglob("*") if p.is_file())
    return {"slides": slides, "paths": paths, "big": big_path, "j2k": j2k, "write_s": time.perf_counter() - t0,
            "bytes": size}


def _mapped(marker: str) -> list[str]:
    """The shared objects mapped into this process whose path contains ``marker``."""
    paths = {line.split()[-1] for line in Path("/proc/self/maps").read_text().splitlines()
             if marker in line and line.split()[-1].startswith("/")}
    return sorted(paths) or ["none"]


def _turbo_version(library: str) -> str:
    """The version string libjpeg-turbo embeds in its shared object."""
    try:
        m = re.search(rb"libjpeg-turbo version [0-9.]+", Path(library).read_bytes())
    except OSError:
        return "unreadable"
    return m.group(0).decode() if m else "not found"


def _tiff_probe(state, corpus):
    """How the decoder was built and what it loaded, then the decoder against
    Pillow's decode of the same bytes on this host."""
    import numpy as np

    from atlaspatch_tpu_torch.io import native
    from atlaspatch_tpu_torch.io.factory import WSIFactory
    from atlaspatch_tpu_torch.tools.pillow_check import j2k_ycbcr_tile, tiled_region

    info = native.tiff_library_info()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout.splitlines()[0]
    ldd = subprocess.run(["ldd", info["library"]], capture_output=True, text=True).stdout
    header_dir = info["jpeg_headers"]
    defines = (Path(header_dir) / "jconfig.h").read_text()
    header_version = re.search(r"#define LIBJPEG_TURBO_VERSION\s+(\S+)", defines)
    log(f"tiff probe: {gxx}; libjpeg headers {header_dir} (LIBJPEG_TURBO_VERSION "
        f"{header_version.group(1) if header_version else 'absent'}); linked {info['libjpeg']}; "
        f"libopenjp2 tried after the system sonames: {info['openjp2_fallback'] or 'none'}")
    log("tiff probe: ldd " + info["library"] + "\n" + "\n".join("  " + ln.strip() for ln in ldd.splitlines()))
    linked = re.search(r"libjpeg\S* => (\S+)", ldd)

    # decoder vs Pillow: a level-0 region and the thumbnail of an (f1) slide,
    # one 33003 J2K tile; the bar is tests/test_torch_native_tiff.py's: max-abs 0.
    # Both sides decode JPEG with the same libjpeg here (Pillow's bundled one).
    svs = corpus["paths"]["tslide000"]
    wsi = WSIFactory.load(str(svs))
    f = native.AtlasTiffFile(str(svs))
    checks = {
        "level-0 region 512x512 at (256, 256)": (f.read_region_level(0, 256, 256, 512, 512),
                                                 tiled_region(svs, 0, 256, 256, 512, 512)),
        "thumbnail at 1.25x, IDCT 1/4 (the --fast path)": (
            np.asarray(wsi.get_thumbnail_at_power(power=1.25, scaled_decode=True)),
            tiled_region(svs, 2, 0, 0, TIFF_WH[0] // 4, TIFF_WH[1] // 4, scale=4)),
        "33003 J2K tile 256x256": (native.AtlasTiffFile(str(corpus["j2k"])).read_region_level(0, 256, 0, 256, 256),
                                   j2k_ycbcr_tile(corpus["j2k"], 0, 1)),
    }
    f.close()
    wsi.cleanup()
    for label, (got, want) in checks.items():
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        log(f"tiff decoder vs Pillow, {label}: shape {got.shape}, max-abs {int(diff.max())}, "
            f"mean-abs {float(diff.mean()):.6f}")
        if got.shape != want.shape or diff.max() != 0:
            raise AssertionError(f"tiff: the native decoder differs from Pillow on the {label}")
    jpeg = linked.group(1) if linked else "unresolved"
    log(f"tiff probe: the decoder's libjpeg {jpeg} ({_turbo_version(jpeg)}); libjpeg mapped {_mapped('libjpeg')}; "
        f"libopenjp2 mapped after J2K decodes {_mapped('openjp2')} [{state['card']}]")


def phase_tiff(state):
    """segment-and-get-coords and process from slide files on disk, through
    DefaultWSILoader, the factory and the native decoders."""
    import tempfile

    from atlaspatch_tpu_torch.core.config import SegmentationConfig
    from atlaspatch_tpu_torch.core.models import Slide
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tiff_"))
    state["tiff_tmp"] = tmp  # the corpus stays for the cli and weights phases; weights removes it
    seg = None
    try:
        corpus = state["tiff_corpus"] = _write_tiff_corpus(tmp)
        log(f"tiff corpus: {TIFF_SLIDES} JPEG SVS of {TIFF_WH[0]}x{TIFF_WH[1]} (f1), one of "
            f"{BIG_WH[0]}x{BIG_WH[1]} (f2), NDPI, MIRAX, VMS, VMU and a DICOM series of "
            f"{CONTAINER_WH[0]}x{CONTAINER_WH[1]} (f3): {corpus['bytes'] / 2**20:.1f} MiB written in "
            f"{corpus['write_s']:.1f} s")
        _tiff_probe(state, corpus)
        seg_cfg = SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
        seg = _thresholding_service(seg_cfg)
        loader = DefaultWSILoader()
        paths = corpus["paths"]
        stems = sorted(paths)
        _drive_runner(state, seg, seg_cfg, stems, tmp / "runner", loader=loader,
                      open_wsi=lambda stem: loader.open(Slide(path=paths[stem])), in_dir=corpus["slides"],
                      what=f"{len(stems)} slide files (f1 + f3)", name="tiff")
        stages = state["tiff_stages"]
        per_slide = {k: stages[k]["mean_ms"] for k in ("wsi_open", "thumbnail", "contours", "grid_scan", "h5_write")
                     if k in stages}
        log(f"tiff runner: {state['tiff_rate']:.2f} slides/s from files vs {state['runner_rate']:.2f} "
            f"slides/s on the runner phase's in-memory slides; per-slide stage ms {json.dumps(per_slide)} "
            f"[{state['card']}]")
        _tiff_process(state, seg, seg_cfg, corpus, tmp)
    finally:
        if seg is not None:
            seg.close()
    if state["tiff_launches"] != 12 * state["tiff_forwards"]:
        raise AssertionError(f"tiff: {state['tiff_launches']} kernel launches in {state['tiff_forwards']} forwards")


def _tiff_process(state, seg, seg_cfg, corpus, tmp):
    """(f2) and two (f1) slides through the runner and embed_all (vit_l_16,
    bfloat16, batch 32): patches read by the native decoder."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atlaspatch_tpu_torch.core.config import (
        AppConfig, ExtractionConfig, FeatureExtractionConfig, OutputConfig, ProcessingConfig,
    )
    from atlaspatch_tpu_torch.core.models import Slide
    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader
    from atlaspatch_tpu_torch.utils import perf
    from atlaspatch_tpu_torch.utils.h5 import read_h5_tree

    in_dir = tmp / "process_slides"
    in_dir.mkdir()
    for src in (corpus["big"], corpus["paths"]["tslide000"], corpus["paths"]["tslide001"]):
        (in_dir / src.name).symlink_to(src)
    loader = DefaultWSILoader()
    big = Slide(path=in_dir / corpus["big"].name)

    # (f2)'s thumbnail on a fresh open, as the --fast service reads it
    t0 = time.perf_counter()
    fresh = loader.open(big)
    thumb = seg.prepare_thumbnails([fresh])[0]
    thumb_ms = 1e3 * (time.perf_counter() - t0)
    fresh.cleanup()

    def run(out):
        cfg = AppConfig(
            processing=ProcessingConfig(input_path=in_dir), segmentation=seg_cfg,
            extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
            output=OutputConfig(output_root=out, skip_existing=True),
            features=FeatureExtractionConfig(extractors=["vit_l_16"], batch_size=32, device="cuda",
                                             precision="bfloat16"),
            device="cuda",
        )
        runner = ProcessingRunner(config=cfg, segmentation=seg,
                                  extractor=PatchExtractionService(cfg.extraction, cfg.output),
                                  visualizer=None, mpp_resolver=_NullResolver(), wsi_loader=loader)
        results, failures = runner.run()
        if failures or len(results) != 3:
            raise AssertionError(f"tiff process: the runner gave {len(results)} results, {failures}")
        return cfg, sorted(results, key=lambda r: r.slide.stem)

    def embed(cfg, results):
        svc = PatchFeatureEmbeddingService(cfg.extraction, cfg.output, cfg.features)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fails = svc.embed_all(results, wsi_loader=loader)
        torch.cuda.synchronize()
        if fails:
            raise AssertionError(f"tiff process: embed_all failed: {fails}")
        return time.perf_counter() - t1

    cfg, results = run(tmp / "process_out")
    perf.reset()
    embed_s = embed(cfg, results)
    stages = perf.report()
    total = sum(r.num_patches for r in results)
    res_big = next(r for r in results if r.slide.stem == big.path.stem)
    tree = read_h5_tree(res_big.h5_path)
    coords, feats = tree.datasets["coords"], tree.datasets.get("features/vit_l_16")
    if feats is None or feats.shape != (res_big.num_patches, 1024) or not np.isfinite(feats).all():
        raise AssertionError(f"tiff process: (f2) features {None if feats is None else feats.shape}")

    # (f2)'s coordinates against the port's geometry on the CPU over the same
    # reader's thumbnail, thresholded on the host as the service's masks are
    wsi = loader.open(big)
    mask = (np.asarray(seg.prepare_thumbnails([wsi])[0].convert("L"), np.float32) < 220).astype(np.float32)
    extraction = PatchExtractionService(cfg.extraction, cfg.output)
    entries = extraction._iter_patch_entries(wsi, *extraction._prepare_contours(mask, wsi), include_patch=False)
    cpu_coords = np.asarray([e[:5] for e in entries], dtype=np.int32).reshape(-1, 5)
    if cpu_coords.tobytes() != coords.tobytes():
        raise AssertionError(f"tiff process: (f2) coordinates {coords.shape} differ from the CPU geometry's "
                             f"{cpu_coords.shape}")

    # 64 of (f2)'s features against extract_batch on the same patches read by wsi.extract
    pick = np.linspace(0, len(coords) - 1, EMBED_CHECK_PATCHES).astype(int)
    direct = [wsi.extract((int(x), int(y)), lv=int(lv), wh=(int(rw), int(rh)), mode="array")
              for x, y, rw, rh, lv in coords[pick]]
    ext = build_default_registry(device="cuda", dtype="bfloat16").create("vit_l_16")
    want = ext.extract_batch(direct, batch_size=32)
    ext.cleanup()
    cos = _cos_rows(feats[pick], want)
    if not cos.min() > 0.999:
        raise AssertionError(f"tiff process: (f2) features vs extract_batch per-row cosine {cos.min()}")
    wsi.cleanup()

    # the device's busy share over embed_all: the same work again, under the profiler
    cfg2, results2 = run(tmp / "process_out_profiled")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        embed(cfg2, results2)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)
    if busy_us == 0:
        raise AssertionError("tiff process: the profiler recorded no device time")
    read = stages.get("patch_read", {})
    log(f"tiff process (f2) {BIG_WH[0]}x{BIG_WH[1]}: thumbnail {thumb_ms:.1f} ms on a fresh open "
        f"({thumb.size[0]}x{thumb.size[1]}), {res_big.num_patches} patches; coordinates equal the CPU geometry's "
        f"over the same thumbnail; {EMBED_CHECK_PATCHES} features vs extract_batch on wsi.extract reads: "
        f"per-row cosine min {cos.min():.6f} [{state['card']}]")
    log(f"tiff process embed_all over (f2) + 2 (f1): {total} patches in {embed_s:.3f} s = {total / embed_s:.1f} "
        f"patches/s by host clock; patch_read {1e3 * read.get('total_s', 0) / max(1, total):.3f} ms per patch "
        f"({read.get('count', 0)} blocks); device busy {busy_us / 1e3:.1f} ms = "
        f"{100 * busy_us / 1e6 / embed_s:.1f}% of embed_all [{state['card']}]")
    log("tiff process stages " + json.dumps(stages))


EMBED_PATCHES, EMBED_PASSES = 512, 3  # bench.py's bench_embed_vitl setting


def vit_flops_per_patch(spec) -> float:
    """FLOPs of one ViT forward per image: the patch-embed convolution, and per
    block the qkv, projection and MLP products and QK^T and PV (2 per MAC)."""
    n = spec.tokens
    t = n + spec.prefix_tokens
    d, hidden = spec.dim, spec.hidden_dim
    block = t * (3 * d * d + d * d + 2 * d * hidden) + 2 * t * t * d
    return 2.0 * (n * 3 * spec.patch_size**2 * d + spec.depth * block)


def _cos_rows(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _timed_passes(ext, patches, batch, passes=EMBED_PASSES):
    """One warm pass, then ``passes`` timed ones: (median s, stage report of the timed ones)."""
    import statistics

    import torch

    from atlaspatch_tpu_torch.utils import perf

    ext.extract_batch(patches, batch_size=batch)
    torch.cuda.synchronize()
    perf.reset()
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        out = ext.extract_batch(patches, batch_size=batch)
        times.append(time.perf_counter() - t0)
    assert out.shape == (len(patches), ext.embedding_dim)
    return statistics.median(times), perf.report()


def phase_embed(state):
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor, init_random_weights_
    from atlaspatch_tpu_torch.models.encoders.vit import ViT
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES

    entry = ENTRIES["vit_l_16"]
    spec = entry.spec
    if (spec.dim, spec.depth, spec.heads, spec.img_size, spec.patch_size) != (1024, 24, 16, 224, 16):
        raise AssertionError(f"vit_l_16 is not at full width: {spec}")
    rng = np.random.default_rng(0)
    patches = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(EMBED_PATCHES)]

    # float32 at full width, depth 2: the card (built with TF32 on, which the
    # engine must turn off) against the CPU on the same weights
    shallow = init_random_weights_(ViT(dataclasses.replace(spec, depth=2)), seed=0)
    cpu = TorchFeatureExtractor(name="vit_l_16", embedding_dim=1024, spec=entry.preprocess,
                                model=copy.deepcopy(shallow), device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    card = TorchFeatureExtractor(name="vit_l_16", embedding_dim=1024, spec=entry.preprocess,
                                 model=shallow, device="cuda")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the float32 extractor left TF32 on")
    f32_err = float(np.abs(card.extract_batch(patches[:4]) - cpu.extract_batch(patches[:4])).max())
    if not f32_err <= 1e-4:
        raise AssertionError(f"embed: float32 card vs CPU at depth 2 differ by {f32_err}")
    card.cleanup()
    del cpu, card, shallow

    # the full model from the registry, float32 and bfloat16 (same seed, same weights)
    t0 = time.perf_counter()
    f32 = build_default_registry(device="cuda", dtype="float32").create("vit_l_16")
    bf16 = build_default_registry(device="cuda", dtype="bfloat16").create("vit_l_16")
    build_s = time.perf_counter() - t0
    params = list(bf16.model.parameters())
    if not params or not all(p.dtype == torch.bfloat16 and p.is_cuda for p in params):
        raise AssertionError("embed: a param of the bfloat16 extractor is not bfloat16 on the card")
    w32, w16 = f32.model.blocks[0].attn.qkv.weight, bf16.model.blocks[0].attn.qkv.weight
    if not torch.equal(w32.to(torch.bfloat16), w16):
        raise AssertionError("embed: the float32 and bfloat16 extractors hold different weights")
    ref = f32.extract_batch(patches[:16])
    got = bf16.extract_batch(patches[:16])
    cos = _cos_rows(ref, got)
    if not (np.isfinite(got).all() and got.shape == (16, 1024) and cos.min() > 0.995):
        raise AssertionError(f"embed: bf16 vs float32 per-row cosine {cos.min()}")
    f32.cleanup()
    del f32
    log(f"embed vit_l_16 (dim 1024, depth 24, 16 heads, 224 px, patch 16; random weights, two "
        f"registry builds {build_s:.1f} s): float32 card vs CPU at depth 2 max-abs {f32_err:.3g} (<= 1e-4, "
        f"TF32 off); bf16 vs float32 on 16 patches per-row cosine min {cos.min():.6f} (> 0.995); "
        f"{len(params)} params all bfloat16 on the card")

    flops = vit_flops_per_patch(spec)
    bound_pps = H100_PEAK_FLOPS["bfloat16"] / flops
    torch.cuda.reset_peak_memory_stats()
    rates = {}
    for batch in (32, 256):
        med_s, stages = _timed_passes(bf16, patches, batch)
        rates[batch] = len(patches) / med_s
        log(f"embed extract_batch {len(patches)} patches at batch {batch}: median {med_s:.4f} s of "
            f"{EMBED_PASSES} = {rates[batch]:.1f} patches/s ({100 * rates[batch] / bound_pps:.1f}% of the "
            f"{bound_pps:.0f} patches/s bf16 bound) [{state['card']}]")
        log(f"embed stages at batch {batch} (3 passes) " + json.dumps(stages))
    for batch in (32, 256):
        u8 = torch.from_numpy(np.stack([entry.preprocess.apply_host(p) for p in patches[:batch]])).cuda()
        ms = cuda_ms(lambda: bf16.forward_device(u8), min_total_ms=300.0)
        rates[f"resident_{batch}"] = 1e3 * batch / ms
        log(f"embed resident forward at batch {batch}: {ms:.3f} ms = {rates[f'resident_{batch}']:.1f} "
            f"patches/s ({100 * rates[f'resident_{batch}'] / bound_pps:.1f}% of the bf16 bound; "
            f"{flops / 1e9:.2f} GFLOP per patch) [{state['card']}]")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    wall_s, _ = _timed_passes(bf16, patches, 32, passes=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bf16.extract_batch(patches, batch_size=32)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us == 0:
        raise AssertionError("embed: the profiler recorded no device time")
    rows.sort(key=lambda e: -e.self_device_time_total)
    log(f"embed profile: one extract_batch of {len(patches)} at batch 32, {1e3 * wall_s:.1f} ms host clock "
        f"(without the profiler), device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall_s:.1f}%); "
        f"peak memory allocated {peak_gib:.2f} GiB [{state['card']}]")
    for e in rows[:10]:
        us = e.self_device_time_total
        log(f"embed profile   {us / 1e3:8.2f} ms {100 * us / busy_us:5.1f}% x{e.count:<5d} {e.key[:100]}")
    bf16.cleanup()
    state["embed"] = dict(rates, bound_pps=bound_pps, busy=busy_us / 1e6 / wall_s)


# The int8 phase: vit_l_16's block linears as (K, N), in the order a block runs
# them, and medsiglip's MLP (hidden 4,304: K and N not multiples of 64).
INT8_VITL_LINEARS = {"qkv": (1024, 3072), "proj": (1024, 1024), "fc1": (1024, 4096), "fc2": (4096, 1024)}
INT8_RAGGED = {"fc1": (1152, 4304), "fc2": (4304, 1152)}
# virchow's fc2 (K the SwiGLU half-width 3,416, no multiple of 16; N 1,280) and the tokens a patch
# (v1: cls + 256; v2: cls, 4 registers, 256), and the pad bytes' value in the pitched rows: a product
# that read them would differ from the plain version
INT8_VIRCHOW_FC2 = (3416, 1280)
VIRCHOW_TOKENS = {"virchow_v1": 257, "virchow_v2": 261}
PAD_BYTE = 0x7F
INT8_SOURCE = "atlaspatch_tpu_torch/csrc/int8_linear.cu"
# int8_linear_s8's two bodies: the routed one on vit_l_16's path first
INT8_LINEAR_SOURCES = ["atlaspatch_tpu_torch/csrc/int8_linear_wgmma.cu", INT8_SOURCE]
# Int8Dense's quantizer (the inlined _q8_dyn) and its int8 product with the dequantization
INT8_REPLACES = {"quantize_rows_s8": "atlaspatch_tpu/models/encoders/vit.py:143",
                 "int8_linear_s8": "atlaspatch_tpu/models/encoders/vit.py:146"}
H100_INT8_OPS = 1979e12  # dense int8 tensor-core operations per second
INT8_COS = 0.98  # int8 against float32 per patch: tests/test_int8_mode.py's drift contract


def int8_linear_bound(m: int, n: int, k: int) -> tuple[float, float]:
    """(operation-bound ms, byte-bound ms) of one int8_linear to bfloat16: 2 M
    N K int8 operations over the int8 tensor-core peak; xq, W, both scales and
    the bfloat16 bias read and the bfloat16 output written once over HBM."""
    nbytes = m * k + n * k + 4 * m + 4 * n + 2 * n + 2 * m * n
    return 1e3 * 2.0 * m * n * k / H100_INT8_OPS, 1e3 * nbytes / H100_BYTES_PER_S


def quantize_bound(m: int, k: int) -> float:
    """ms of one quantize_rows of bfloat16 rows: 2 M K bytes in, M K + 4 M out
    over HBM (its few operations per byte bound it by bytes)."""
    return 1e3 * (3 * m * k + 4 * m) / H100_BYTES_PER_S


# quantize_rows_s8's prologues on the main path and beside it: (M, K, prologue, operand, dtype, label)
INT8_PROLOGUE_CASES = [
    *[(b * 197, k, prologue, operand, dtype, f"vit_l_16 b{b}") for b in (32, 256)
      for k, prologue, operand in ((1024, "layernorm", None), (4096, "gelu_tanh", None), (1024, "identity", "heads"))
      for dtype in ("bfloat16", *(("float32",) if b == 32 else ()))],
    (8192, 1152, "layernorm", None, "bfloat16", "medsiglip"), (8192, 4304, "gelu_tanh", None, "bfloat16", "medsiglip"),
    (8192, 3416, "silu", "swiglu", "bfloat16", "virchow SwiGLU half"),
]
FUSED_FLIP_SHARE = 1e-3  # layernorm and the activations: xq within 1 in this share, s_x within 2^-8


def _prologue_operands(m, k, prologue, operand, dtype, gen):
    import torch

    dt = getattr(torch, dtype)
    if operand == "heads":
        attn = torch.softmax(torch.randn(m // 197, 16, 197, 197, device="cuda", generator=gen) * 3, dim=-1).to(dt)
        v = torch.randn(m // 197, 197, 16, k // 16, device="cuda", generator=gen).to(dt)
        return (torch.einsum("bhqk,bkhd->bqhd", attn, v),)
    if prologue == "layernorm":
        return ((torch.randn(m, k, device="cuda", generator=gen) * 2 + 0.3).to(dt),
                (1 + 0.5 * torch.randn(k, device="cuda", generator=gen)).to(dt),
                (0.5 * torch.randn(k, device="cuda", generator=gen)).to(dt), 1e-6)
    if operand == "swiglu":
        a, b = (torch.randn(m, 2 * k, device="cuda", generator=gen) * 2).to(dt).chunk(2, dim=-1)
        return a, prologue, b
    return (torch.randn(m, k, device="cuda", generator=gen) * 2).to(dt), prologue


def _int8_prologue_rows(state) -> dict:
    """(a0) Each prologue against its plain version on the same inputs at INT8_PROLOGUE_CASES, with
    its device ms, bound and plain ms; the unfused chain's kernels (F.layer_norm, F.gelu, the reshape
    copy, the earlier two-read quantizer) on vit_l_16's inputs at batch 32 and 256. Returns the rows and
    the per-forward sums."""
    import torch

    from atlaspatch_tpu_torch.ops import int8 as I
    from atlaspatch_tpu_torch.tools.int8_variants import chain_calls, quantize_bound_ms, quantize_chain

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for m, k, prologue, operand, dtype, label in INT8_PROLOGUE_CASES:
        args = _prologue_operands(m, k, prologue, operand, dtype, gen)
        if prologue == "layernorm":
            fused, plain = I.layernorm_quantize_rows, I.layernorm_quantize_rows_plain
        elif prologue == "identity":
            fused, plain = I.quantize_heads, lambda x: I.quantize_rows_plain(x.reshape(x.shape[0] * x.shape[1], -1))
        else:
            fused, plain = I.act_quantize_rows, I.act_quantize_rows_plain
        I.reset_launch_counts()
        xq, s_x = fused(*args)
        torch.cuda.synchronize()
        if dict(I.quantize_rows.prologue_launches) != {prologue: 1}:
            raise AssertionError(f"int8 {prologue}: launches {dict(I.quantize_rows.prologue_launches)}")
        want_xq, want_s = plain(*args)
        diff = (xq.int() - want_xq.int()).abs()
        err, share = diff.max().item(), (diff > 0).float().mean().item()
        rel = ((s_x - want_s).abs() / want_s).max().item()
        ok = err == 0 and rel == 0 if prologue == "identity" else \
            err <= 1 and share <= FUSED_FLIP_SHARE and rel <= 2.0**-8
        if not ok:
            raise AssertionError(f"int8 quantize_rows_s8 {prologue} {label} M={m} K={k} {dtype}: |dxq| max {err}, "
                                 f"flip share {share}, s_x rel {rel}")
        elem = (2 if dtype == "bfloat16" else 4) * (2 if operand in ("swiglu", "gated") else 1)  # bytes in a value
        row = dict(err=err, share=share, rel=rel, ms=device_ms(lambda: fused(*args), kernel="quantize_rows_s8"),
                   plain_ms=cuda_ms(lambda: plain(*args), max_reps=10), bound_ms=quantize_bound_ms(m, k, elem))
        rows[(m, k, prologue, dtype)] = row
        log(f"int8 quantize_rows_s8 {prologue:9s} {label} M={m:6d} K={k:5d} {dtype}: |dxq| max {err}, flip share "
            f"{share:.3e} ({int((diff > 0).sum())} of {diff.numel()}), s_x rel max {rel:.3e}; dev_ms={row['ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({100 * row['bound_ms'] / row['ms']:.1f}%) plain_ms="
            f"{row['plain_ms']:.4f} [{state['card']}]")
        del args, xq, s_x, want_xq, want_s, diff
    torch.cuda.empty_cache()

    forwards = {}
    for batch in (32, 256):
        m = batch * 197
        chain = quantize_chain(m, gen)
        times = {name: (count, device_ms(fn, kernel=kernel)) for name, (count, fn, kernel) in chain_calls(chain).items()}
        fused = sum(24 * count * ms for name, (count, ms) in times.items() if name in I.PROLOGUES)
        unfused = sum(24 * count * ms for name, (count, ms) in times.items() if name not in I.PROLOGUES)
        bound = 24 * (3 * quantize_bound_ms(m, 1024) + quantize_bound_ms(m, 4096))
        forwards[batch] = dict(ms=fused, unfused_ms=unfused, bound_ms=bound, parts=times)
        log(f"int8 quantize_rows_s8 per vit_l_16 forward at batch {batch} (48 layernorm, 24 gelu_tanh, 24 identity; "
            f"device ms): {fused:.3f} against the bound {bound:.3f} ({100 * bound / fused:.1f}% of it reached); the "
            f"unfused chain it replaces {unfused:.3f}: "
            + ", ".join(f"{name} {24 * count * ms:.3f} ({count} a block, {ms:.4f} a call)"
                        for name, (count, ms) in times.items()) + f" [{state['card']}]")
        del chain
    torch.cuda.empty_cache()
    return {"rows": rows, "forwards": forwards}


def _fill_pad(t) -> None:
    """Set the pad bytes of a row-pitched (rows, K) int8 view (columns K to its pitch) to PAD_BYTE."""
    from atlaspatch_tpu_torch.ops import int8 as I

    rows, k = t.shape
    if I.pitch16(k) != k:
        t.as_strided((rows, I.pitch16(k)), (I.pitch16(k), 1))[:, k:].fill_(PAD_BYTE)


def _int8_kernel_rows(state) -> dict:
    """(a) Both kernels against their plain versions at vit_l_16's shapes at
    batch 32 and 256, medsiglip's ragged ones and virchow's fc2 (K 3,416) at
    batch 32 and 256: max-abs 0 for the routed call and for each
    int8_linear_s8 body the shape admits, forced, against the plain version
    and each other, over xq as the quantizer writes it and the weights as
    the model holds them (both at the 16-byte row pitch, the pad bytes set
    to PAD_BYTE) and, where K is no multiple of 16, the mma body over packed
    rows besides (the route before the pitch); device ms per body, bound,
    plain ms and the library's ms (torch._int_mm alone, and with the eager
    dequantization; bf16 F.linear; on packed rows) per shape. Returns the
    rows."""
    import torch
    import torch.nn.functional as F

    from atlaspatch_tpu_torch.ops import int8 as I

    cases = [(b * 197, k, n, f"vit_l_16 {name} batch {b}") for b in (32, 256)
             for name, (k, n) in INT8_VITL_LINEARS.items()]
    cases += [(m, k, n, f"medsiglip {name} M={m}") for m in (8 * 1024, 5) for name, (k, n) in INT8_RAGGED.items()]
    cases += [(b * t, *INT8_VIRCHOW_FC2, f"{name} fc2 batch {b}") for b in (32, 256)
              for name, t in VIRCHOW_TOKENS.items()]
    gen = torch.Generator(device="cuda").manual_seed(0)
    quant, linear = {}, {}
    for m, k, n, label in cases:
        x = (torch.randn(m, k, device="cuda", generator=gen) * 2).to(torch.bfloat16)
        w = I.pitched(torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int32)
                      .to(torch.int8))
        qscale = (torch.rand(n, device="cuda", generator=gen) + 0.5) / 127.0
        bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
        xq, s_x = I.quantize_rows(x)
        if xq.stride(0) != I.pitch16(k) or w.stride(0) != I.pitch16(k):
            raise AssertionError(f"int8 {label}: xq and weight rows {xq.stride(0)}, {w.stride(0)} bytes apart")
        _fill_pad(xq)
        _fill_pad(w)
        ragged = k % 16 != 0
        xq_p, w_p = xq.contiguous(), w.contiguous()  # packed rows: the route before the pitch, the library's
        want_xq, want_s = I.quantize_rows_plain(x)
        routed = I.linear_variant(m, n, k, torch.bfloat16, xq.data_ptr(), w.data_ptr(), xq.stride(0), w.stride(0))
        bodies = [v for v in I.LINEAR_VARIANTS
                  if v == "mma" or I.wgmma_admits(n, k, torch.bfloat16, xq.data_ptr(), w.data_ptr(), xq.stride(0),
                                                  w.stride(0))]
        calls = {v: (lambda v=v: I._launch_linear(v, xq, s_x, w, qscale, bias, torch.bfloat16)) for v in bodies}
        if ragged:
            calls["mma packed"] = lambda: I._launch_linear("mma", xq_p, s_x, w_p, qscale, bias, torch.bfloat16)
        y = I.int8_linear(xq, s_x, w, qscale, bias, torch.bfloat16)
        forced = {v: fn() for v, fn in calls.items()}
        want = I.int8_linear_plain(xq_p, s_x, w_p, qscale, bias, torch.bfloat16)
        torch.cuda.synchronize()
        q_err = max((xq.int() - want_xq.int()).abs().max().item(), (s_x - want_s).abs().max().item())
        errs = {v: (out.float() - want.float()).abs().max().item() for v, out in {"routed": y, **forced}.items()}
        agree = all(torch.equal(out, forced["mma"]) for out in forced.values())
        err = max(errs.values())
        if q_err != 0 or err != 0 or not agree or routed != "wgmma":
            raise AssertionError(f"int8 {label} (M={m}, K={k}, N={n}): quantize_rows max-abs {q_err}, "
                                 f"int8_linear max-abs {errs} (must be 0), bodies equal {agree}, routed {routed}")
        del want, want_xq, want_s, y, forced
        if (m, k) not in quant:
            row = dict(err=q_err, ms=device_ms(lambda: I.quantize_rows(x), kernel="quantize_rows_s8"),
                       plain_ms=cuda_ms(lambda: I.quantize_rows_plain(x)), bound_ms=quantize_bound(m, k))
            quant[(m, k)] = row
            log(f"int8 quantize_rows_s8 M={m:6d} K={k:5d} ({label.split(' M=')[0]}): max-abs {q_err} "
                f"dev_ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} (bytes) plain_ms={row['plain_ms']:.4f} "
                f"library_ms=null [{state['card']}]")

        def library():  # torch._int_mm and the eager dequantization: timed only, never called by the port
            acc = torch._int_mm(xq_p, w_p.t())
            return (acc.float() * (s_x[:, None] * qscale) + bias).to(torch.bfloat16)

        w16 = w_p.to(torch.bfloat16)
        op_ms, byte_ms = int8_linear_bound(m, n, k)
        body_ms = {v: device_ms(fn, kernel="int8_linear_s8") for v, fn in calls.items()}
        int_mm_kernels: dict = {}  # which kernels cuBLASLt ran for torch._int_mm, and how often
        row = dict(err=err, op_ms=op_ms, byte_ms=byte_ms, variant=routed, ms=body_ms[routed], mma_ms=body_ms["mma"],
                   packed_mma_ms=body_ms.get("mma packed"),
                   plain_ms=cuda_ms(lambda: I.int8_linear_plain(xq, s_x, w, qscale, bias, torch.bfloat16),
                                    max_reps=5),
                   # torch._int_mm takes M > 16 only
                   library_ms=device_ms(library, kernel=None) if m > 16 else None,
                   int_mm_ms=(device_ms(lambda: torch._int_mm(xq_p, w_p.t()), kernel=None, seen=int_mm_kernels)
                              if m > 16 else None),
                   bf16_ms=device_ms(lambda: F.linear(x, w16, bias), kernel=None))
        linear[(m, k, n)] = row
        lib = "null (M <= 16)" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        int_mm = "null" if row["int_mm_ms"] is None else f"{row['int_mm_ms']:.4f}"
        int_mm_ran = {name.split("(")[0].split("<")[-1].rstrip(">"): n for name, n in int_mm_kernels.items()}
        log(f"int8 int8_linear_s8  M={m:6d} K={k:5d} N={n:5d} ({label}): routed {routed}, max-abs {errs} "
            f"(bodies equal{'; rows at the 16-byte pitch, pad bytes 0x7f' if ragged else ''}) dev_ms={row['ms']:.4f} "
            + " ".join(f"{v.replace(' ', '_')}_dev_ms={t:.4f}" for v, t in body_ms.items())
            + f" bound_ms={max(op_ms, byte_ms):.4f} ({'operations' if op_ms >= byte_ms else 'bytes'}) "
            f"plain_ms={row['plain_ms']:.4f} library_ms={lib} (_int_mm + dequant) _int_mm alone dev_ms={int_mm} "
            f"({int_mm_ran or ('not run' if row['int_mm_ms'] is None else 'no launch kept by the profiler')} "
            "in 20 calls) "
            f"bf16 F.linear dev_ms={row['bf16_ms']:.4f} [{state['card']}]")
        del x, w, w16, xq, s_x, xq_p, w_p
    torch.cuda.empty_cache()
    return {"quant": quant, "linear": linear}


def _int8_records(rows, prologue_rows) -> dict:
    """The two kernels' records over one vit_l_16 forward at batch 32 (M =
    6,304): per block 2 layernorm quantizers of K 1,024, one tanh GELU of
    4,096 and one identity of 1,024 (the batch-256 sums beside them), and the
    4 linears, times 24 blocks; int8_linear_s8's ``ms`` is the routed body's,
    ``mma_ms`` the mma.sync body's, forced, on the same inputs; its
    ``virchow_fc2`` the sums over one virchow_v2 forward's 32 fc2 calls
    (M 8,352, K 3,416) at batch 32 and 256: the routed wgmma body over the
    pitched rows, the mma body over them and over packed ones (the route
    before the pitch), the bound and the library calls."""
    m, depth = 32 * 197, 24
    linears = [rows["linear"][(m, k, n)] for k, n in INT8_VITL_LINEARS.values()]
    worst = max(r["err"] for r in [*rows["quant"].values(), *rows["linear"].values()])
    op = sum(r["op_ms"] for r in linears if r["op_ms"] >= r["byte_ms"])
    byte = sum(r["byte_ms"] for r in linears if r["op_ms"] < r["byte_ms"])
    p = prologue_rows["rows"]
    blocks = [p[(m, 1024, "layernorm", "bfloat16")]] * 2 + [p[(m, 4096, "gelu_tanh", "bfloat16")],
                                                           p[(m, 1024, "identity", "bfloat16")]]
    fwd = prologue_rows["forwards"]
    identity_err = max(r["err"] for key, r in p.items() if key[2] == "identity")
    return {
        "quantize_rows_s8": {
            "name": "quantize_rows_s8", "route": "cuda", "source": INT8_SOURCE,
            "replaces": INT8_REPLACES["quantize_rows_s8"], "max_abs_err": max(identity_err, worst),
            "ms": fwd[32]["ms"], "plain_ms": depth * sum(r["plain_ms"] for r in blocks),
            "bound_ms": fwd[32]["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "ms_b256": fwd[256]["ms"], "bound_ms_b256": fwd[256]["bound_ms"],
            "unfused_ms": fwd[32]["unfused_ms"], "unfused_ms_b256": fwd[256]["unfused_ms"],
            "flip_share": max(r["share"] for key, r in p.items() if key[2] != "identity"),
        },
        "int8_linear_s8": {
            "name": "int8_linear_s8", "route": "cuda", "source": INT8_LINEAR_SOURCES[0],
            "sources": INT8_LINEAR_SOURCES, "replaces": INT8_REPLACES["int8_linear_s8"], "max_abs_err": worst,
            "ms": depth * sum(r["ms"] for r in linears), "plain_ms": depth * sum(r["plain_ms"] for r in linears),
            "bound_ms": depth * (op + byte), "bound_by": "operations" if op >= byte else "bytes",
            "library_ms": depth * sum(r["library_ms"] for r in linears),
            "mma_ms": depth * sum(r["mma_ms"] for r in linears),
            "int_mm_ms": depth * sum(r["int_mm_ms"] for r in linears),
            "bf16_linear_ms": depth * sum(r["bf16_ms"] for r in linears),
            "virchow_fc2": {f"batch {b}": _virchow_fc2_sums(rows["linear"][(b * VIRCHOW_TOKENS["virchow_v2"],
                                                                            *INT8_VIRCHOW_FC2)])
                            for b in (32, 256)},
        },
    }


def _virchow_fc2_sums(r) -> dict:
    """One virchow_v2 forward's 32 fc2 calls of a kernel row, ms."""
    blocks = 32
    return {"ms": blocks * r["ms"], "mma_ms": blocks * r["mma_ms"], "packed_mma_ms": blocks * r["packed_mma_ms"],
            "bound_ms": blocks * max(r["op_ms"], r["byte_ms"]), "int_mm_ms": blocks * r["int_mm_ms"],
            "library_ms": blocks * r["library_ms"], "bf16_linear_ms": blocks * r["bf16_ms"]}


def _per_forward(rows, batch: int) -> dict:
    """int8_linear_s8's sums over one vit_l_16 forward (96 linears) at a
    batch: routed body, mma.sync body, bound, _int_mm alone, _int_mm +
    dequant and bf16 F.linear, ms."""
    linears = [rows["linear"][(batch * 197, k, n)] for k, n in INT8_VITL_LINEARS.values()]
    return {key: 24 * sum(r[src] for r in linears) for key, src in
            (("ms", "ms"), ("mma_ms", "mma_ms"), ("int_mm_ms", "int_mm_ms"), ("library_ms", "library_ms"),
             ("bf16_ms", "bf16_ms"))} | {"bound_ms": 24 * sum(max(r["op_ms"], r["byte_ms"]) for r in linears)}


def _int8_launches() -> tuple[int, int]:
    from atlaspatch_tpu_torch.ops import int8 as I

    return I.quantize_rows.launches, I.int8_linear.launches


# quantize_rows_s8's launches by prologue in one vit_l_16 int8 forward
VITL_PROLOGUE_LAUNCHES = {"layernorm": 48, "gelu_tanh": 24, "identity": 24}


def _prologue_launches_are(forwards: int) -> bool:
    """The one-device forwards' quantizers: VITL_PROLOGUE_LAUNCHES by prologue, all one-pass on the template."""
    from atlaspatch_tpu_torch.ops import int8 as I

    return (dict(I.quantize_rows.prologue_launches) == {k: n * forwards for k, n in VITL_PROLOGUE_LAUNCHES.items()}
            and dict(I.quantize_rows.mode_launches) == {"one_pass": 96 * forwards}
            and dict(I.quantize_rows.body_launches) == {"template": 96 * forwards})


def phase_int8(state):
    """The int8 (W8A8) serving mode of vit_l_16: (a) both kernels at the
    shapes it hands them, (b) the encoder at full width, (c) process
    --feature-precision int8 through the command line, (d) the device ops."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor, init_random_weights_
    from atlaspatch_tpu_torch.models.encoders.vit import (
        Attention, Int8Linear, ViT, quantize_vit_state_dict,
    )
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
    from atlaspatch_tpu_torch.ops import int8 as I

    prologue_rows = _int8_prologue_rows(state)
    rows = _int8_kernel_rows(state)
    records = _int8_records(rows, prologue_rows)
    forward_sums = {batch: _per_forward(rows, batch) for batch in (32, 256)}
    for batch, f in forward_sums.items():
        log(f"int8 int8_linear_s8 per vit_l_16 forward at batch {batch} (96 linears, device ms): routed (wgmma) "
            f"{f['ms']:.3f}, mma.sync body {f['mma_ms']:.3f}, bound {f['bound_ms']:.3f} "
            f"({100 * f['bound_ms'] / f['ms']:.1f}% of it reached; mma.sync "
            f"{100 * f['bound_ms'] / f['mma_ms']:.1f}%), _int_mm alone {f['int_mm_ms']:.3f}, _int_mm + dequant "
            f"{f['library_ms']:.3f}, bf16 F.linear {f['bf16_ms']:.3f} [{state['card']}]")
    for batch, f in records["int8_linear_s8"]["virchow_fc2"].items():
        log(f"int8 int8_linear_s8 per virchow_v2 forward at {batch} (32 fc2, K 3,416, device ms): routed (wgmma, "
            f"pitched rows) {f['ms']:.3f}, mma.sync body over the pitched rows {f['mma_ms']:.3f}, over packed rows "
            f"(the route before the pitch) {f['packed_mma_ms']:.3f}, bound {f['bound_ms']:.3f} "
            f"({100 * f['bound_ms'] / f['ms']:.1f}% of it reached), _int_mm alone {f['int_mm_ms']:.3f}, _int_mm + "
            f"dequant {f['library_ms']:.3f}, bf16 F.linear {f['bf16_linear_ms']:.3f} [{state['card']}]")
    virchow = _int8_virchow(state)
    records["int8_linear_s8"].update(virchow_variant_launches=virchow["launches"],
                                     virchow_forward_ms=virchow["ms"], virchow_packed_forward_ms=virchow["packed_ms"])

    # (b) vit_l_16 at full width, random weights from the registry
    entry = ENTRIES["vit_l_16"]
    spec = entry.spec
    if (spec.dim, spec.depth, spec.heads, spec.img_size, spec.patch_size) != (1024, 24, 16, 224, 16):
        raise AssertionError(f"vit_l_16 is not at full width: {spec}")
    rng = np.random.default_rng(0)
    patches = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(EMBED_PATCHES)]
    t0 = time.perf_counter()
    i8 = build_default_registry(device="cuda", dtype="int8").create("vit_l_16")
    f32 = build_default_registry(device="cuda", dtype="float32").create("vit_l_16")
    build_s = time.perf_counter() - t0
    layers = [mod for mod in i8.model.modules() if isinstance(mod, Int8Linear)]
    if i8.compute_dtype != "int8" or len(layers) != 4 * spec.depth:
        raise AssertionError(f"int8: {i8.compute_dtype} extractor with {len(layers)} int8 layers")
    kinds = {}
    for name, t in i8.model.state_dict().items():
        kind = name.rsplit(".", 1)[-1] if name.endswith(("weight_q", "qscale")) else "other"
        kinds.setdefault(kind, set()).add((t.dtype, t.device.type))
    if kinds != {"weight_q": {(torch.int8, "cuda")}, "qscale": {(torch.float32, "cuda")},
                 "other": {(torch.bfloat16, "cuda")}}:
        raise AssertionError(f"int8: tensor kinds after the engine's cast {kinds}")
    want_q, want_s = I.quantize_plain(f32.model.blocks[5].mlp.fc1.weight.float(), dim=1)
    if not (torch.equal(i8.model.blocks[5].mlp.fc1.weight_q, want_q)
            and torch.equal(i8.model.blocks[5].mlp.fc1.qscale, want_s[:, 0])):
        raise AssertionError("int8: the int8 weights are not the float32 extractor's, quantized")
    ref = f32.extract_batch(patches[:64], batch_size=32)
    I.reset_launch_counts()
    got = i8.extract_batch(patches[:64], batch_size=32)
    torch.cuda.synchronize()
    if _int8_launches() != (2 * 96, 2 * 96) or dict(I.int8_linear.variant_launches) != {"wgmma": 2 * 96} \
            or not _prologue_launches_are(2):
        raise AssertionError(f"int8: {_int8_launches()} launches ({dict(I.int8_linear.variant_launches)}, "
                             f"{dict(I.quantize_rows.prologue_launches)}) in 2 forwards (96 each per forward, "
                             f"every linear on the wgmma body, quantizers {VITL_PROLOGUE_LAUNCHES})")
    cos = _cos_rows(ref, got)
    if not (np.isfinite(got).all() and got.shape == (64, 1024) and cos.min() > INT8_COS):
        raise AssertionError(f"int8: int8 vs float32 per-patch cosine min {cos.min()}")
    f32.cleanup()
    del f32
    log(f"int8 vit_l_16 (dim 1024, depth 24, 16 heads; random weights, two registry builds {build_s:.1f} s): "
        f"96 Int8Linear, weight_q int8, qscale float32, the rest bfloat16 on the card; the float32 "
        f"extractor's weights quantized; 96 launches of each kernel per forward, the 96 linears all on the "
        f"wgmma body, the quantizers by prologue {VITL_PROLOGUE_LAUNCHES}; int8 vs float32 on 64 "
        f"patches per-patch cosine min {cos.min():.6f} mean {cos.mean():.6f} (> {INT8_COS}) [{state['card']}]")

    # card int8 against CPU int8 at full width, depth 2, on the same weights
    shallow = init_random_weights_(ViT(dataclasses.replace(spec, depth=2)), seed=0)
    quantized = ViT(dataclasses.replace(spec, depth=2, quant_int8=True))
    quantized.load_state_dict(quantize_vit_state_dict(shallow.state_dict()), strict=True)
    cpu = TorchFeatureExtractor(name="vit_l_16", embedding_dim=1024, spec=entry.preprocess,
                                model=copy.deepcopy(quantized), device="cpu", compute_dtype="int8")
    card = TorchFeatureExtractor(name="vit_l_16", embedding_dim=1024, spec=entry.preprocess,
                                 model=quantized, device="cuda", compute_dtype="int8")
    t0 = time.perf_counter()
    want = cpu.extract_batch(patches[:4])
    cpu_s = time.perf_counter() - t0
    got = card.extract_batch(patches[:4])
    card_cos = _cos_rows(want, got)
    if not card_cos.min() >= 0.999:
        raise AssertionError(f"int8: card vs CPU at depth 2 per-patch cosine min {card_cos.min()}")
    card.cleanup()
    del cpu, card, shallow, quantized
    log(f"int8 card vs CPU at full width, depth 2, same weights, 4 patches: per-patch cosine min "
        f"{card_cos.min():.7f} (>= 0.999; CPU {cpu_s:.1f} s) [{state['card']}]")

    # rates, beside the embed phase's bfloat16 ones
    bf16 = state.get("embed", {})
    I.reset_launch_counts()
    med_s, stages = _timed_passes(i8, patches, 32)
    forwards = (1 + EMBED_PASSES) * len(patches) // 32  # the warm pass and the timed ones
    if _int8_launches() != (96 * forwards, 96 * forwards) \
            or dict(I.int8_linear.variant_launches) != {"wgmma": 96 * forwards} or not _prologue_launches_are(forwards):
        raise AssertionError(f"int8: {_int8_launches()} launches ({dict(I.int8_linear.variant_launches)}, "
                             f"{dict(I.quantize_rows.prologue_launches)}) in {forwards} forwards")
    rate = len(patches) / med_s
    log(f"int8 extract_batch {len(patches)} patches at batch 32: median {med_s:.4f} s of {EMBED_PASSES} = "
        f"{rate:.1f} patches/s (bf16, embed phase: {bf16.get(32, float('nan')):.1f}) [{state['card']}]")
    log("int8 stages at batch 32 (3 passes) " + json.dumps(stages) + f" [{state['card']}]")
    resident = {}
    for batch in (32, 256):
        u8 = torch.from_numpy(np.stack([entry.preprocess.apply_host(p) for p in patches[:batch]])).cuda()
        ms = cuda_ms(lambda: i8.forward_device(u8), min_total_ms=300.0)
        resident[batch] = 1e3 * batch / ms
        log(f"int8 resident forward at batch {batch}: {ms:.3f} ms = {resident[batch]:.1f} patches/s (bf16, "
            f"embed phase: {bf16.get(f'resident_{batch}', float('nan')):.1f}) [{state['card']}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        i8.forward_device(u8)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us == 0:
        raise AssertionError("int8: the profiler recorded no device time")
    dev.sort(key=lambda e: -e.self_device_time_total)
    share = {name: sum(e.self_device_time_total for e in dev if name in e.key) / busy_us
             for name in ("int8_linear_s8", "quantize_rows_s8")}
    norms = sum(e.count for e in dev if "layer_norm" in e.key)
    gelus = sum(e.count for e in dev if "gelu" in e.key.lower())
    if norms != 1 or gelus != 0:  # the final norm only: the blocks' LayerNorms and GELUs run in the quantizer
        raise AssertionError(f"int8: one batch-256 forward ran {norms} LayerNorm and {gelus} GELU kernels")
    log(f"int8 profile: one forward at batch 256, device {busy_us / 1e3:.2f} ms; int8_linear_s8 "
        f"{100 * share['int8_linear_s8']:.1f}%, quantize_rows_s8 {100 * share['quantize_rows_s8']:.1f}%; "
        f"{norms} LayerNorm kernel (the final norm), {gelus} GELU kernels [{state['card']}]")
    for e in dev[:12]:
        log(f"int8 profile   {e.self_device_time_total / 1e3:8.2f} ms {100 * e.self_device_time_total / busy_us:5.1f}% "
            f"x{e.count:<4d} {e.key[:100]} [{state['card']}]")
    # the device-busy share of one batch-32 forward: profiler device time over the host clock of a
    # forward without the profiler (the least of 5)
    u8_32 = u8[:32].contiguous()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        i8.forward_device(u8_32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        i8.forward_device(u8_32)
        torch.cuda.synchronize()
    busy32_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)
    busy32 = busy32_us / 1e6 / min(walls)
    log(f"int8 profile: one forward at batch 32, {1e3 * min(walls):.3f} ms by host clock (least of 5, no "
        f"profiler), device busy {busy32_us / 1e3:.3f} ms = {100 * busy32:.1f}% [{state['card']}]")

    # the int8 attention branch (quant_int8_attn; no entry point turns it on): its time at batch 32
    x = torch.randn(32, 197, 1024, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    x = x.to(torch.bfloat16)
    attn = i8.model.blocks[0].attn
    attn8 = Attention(dataclasses.replace(i8.model.spec, quant_int8_attn=True)).cuda().requires_grad_(False)
    attn8.load_state_dict(attn.state_dict())
    attn8.qkv.bias.data, attn8.proj.bias.data = attn.qkv.bias.data, attn.proj.bias.data
    with torch.no_grad():
        a_cos = torch.nn.functional.cosine_similarity(attn8(x).float().flatten(1), attn(x).float().flatten(1))
        plain_attn_ms, int8_attn_ms = cuda_ms(lambda: attn(x)), cuda_ms(lambda: attn8(x))
    if not a_cos.min().item() > INT8_COS:
        raise AssertionError(f"int8: the int8 attention branch's cosine to the plain branch {a_cos.min()}")
    log(f"int8 attention block at batch 32 (qkv, attention, proj): plain products {plain_attn_ms:.3f} ms, "
        f"int8 products (quant_int8_attn) {int8_attn_ms:.3f} ms by CUDA events; cosine of their outputs min "
        f"{a_cos.min().item():.5f} [{state['card']}]")
    del attn8, x

    # (d) the device ops: content filters and the nearest resize, card against CPU
    from atlaspatch_tpu_torch.ops.filters import content_filter_mask
    from atlaspatch_tpu_torch.ops.resize import resize_nearest

    host = np.stack(patches[:64])
    host[0], host[1] = 0, 250  # a black and a white patch
    batch = torch.from_numpy(host)
    on_card = batch.cuda()
    keep = content_filter_mask(on_card).cpu()
    if not (torch.equal(keep, content_filter_mask(batch)) and keep.any() and not keep.all()):
        raise AssertionError(f"int8: content_filter_mask on the card {keep.tolist()}")
    small = resize_nearest(on_card, (224, 224))
    if not torch.equal(small.cpu(), resize_nearest(batch, (224, 224))):
        raise AssertionError("int8: resize_nearest on the card differs from the CPU")
    filter_ms = cuda_ms(lambda: content_filter_mask(on_card))
    resize_ms = cuda_ms(lambda: resize_nearest(on_card, (224, 224)))
    log(f"int8 device ops on 64 patches of 256x256: content_filter_mask equals the CPU's ({int(keep.sum())} kept), "
        f"{filter_ms:.3f} ms; resize_nearest to 224 equals the CPU's, {resize_ms:.3f} ms [{state['card']}]")
    i8.cleanup()
    del on_card, small
    torch.cuda.empty_cache()

    # (c) the command line: process --fast --feature-precision int8 on four (f1) slides' coordinates
    cli = _int8_cli(state)
    records["quantize_rows_s8"].update(launches=cli["launches"][0], extract_launches=96 * forwards,
                                       prologue_launches=cli["prologues"])
    records["int8_linear_s8"].update(launches=cli["launches"][1], extract_launches=96 * forwards,
                                     variant_launches=cli["variants"])
    state["int8_records"] = [records["quantize_rows_s8"], records["int8_linear_s8"]]
    state["int8"] = dict(rate=rate, resident=resident, cos_min=float(cos.min()), card_cos=float(card_cos.min()),
                         cli=cli, share=share, attn_ms=(plain_attn_ms, int8_attn_ms), forward_sums=forward_sums,
                         busy32=busy32, quantize_forwards=prologue_rows["forwards"])
    for rec in state["int8_records"]:
        log(f"int8 record {rec['name']}: per forward (batch 32) {rec['ms']:.3f} ms device, bound "
            f"{rec['bound_ms']:.3f} ({rec['bound_by']}), plain {rec['plain_ms']:.3f}, library "
            f"{rec['library_ms'] and round(rec['library_ms'], 3)}; launches {rec['launches']} in the cli run"
            f"{'' if 'variant_launches' not in rec else ' ' + str(rec['variant_launches'])}"
            f"{'' if 'prologue_launches' not in rec else ' ' + str(rec['prologue_launches'])} [{state['card']}]")


def _int8_virchow(state) -> dict:
    """(b2) virchow_v2 in the int8 serving mode at full width and depth
    (dim 1,280, 32 blocks, 16 heads, SwiGLU half-width 3,416; random weights
    from the registry), 32 patches at batch 32: its 128 linears all on the
    wgmma body (the engine pitched every weight_q, and fc2's xq comes at the
    16-byte pitch), no mma launch; its features equal, max-abs 0, to the same
    model's with its weights packed again (the route before the pitch: fc2
    on the mma body over packed rows, 96 wgmma + 32 mma launches); the
    resident forward's device-queue ms on each route, in turns (pitched,
    packed, packed, pitched). Returns the launches and the times."""
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.models.encoders.vit import Int8Linear
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
    from atlaspatch_tpu_torch.ops import int8 as I

    entry = ENTRIES["virchow_v2"]
    spec = entry.spec
    if (spec.dim, spec.depth, spec.heads, spec.hidden_dim, spec.swiglu) != (1280, 32, 16, 3416, True):
        raise AssertionError(f"virchow_v2 is not at full width: {spec}")
    t0 = time.perf_counter()
    i8 = build_default_registry(device="cuda", dtype="int8").create("virchow_v2")
    build_s = time.perf_counter() - t0
    fc2 = i8.model.blocks[0].mlp.fc2.weight_q
    if fc2.shape != (1280, 3416) or fc2.stride() != (3424, 1) or fc2.data_ptr() % 16:
        raise AssertionError(f"virchow_v2 int8: fc2 weight {tuple(fc2.shape)} with strides {fc2.stride()}")
    packed = copy.deepcopy(i8.model)
    for mod in packed.modules():
        if isinstance(mod, Int8Linear):
            mod.weight_q = mod.weight_q.contiguous()
    pitched = i8.replicas[0]
    rng = np.random.default_rng(3)
    u8 = torch.from_numpy(np.stack([entry.preprocess.apply_host(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
                                    for _ in range(32)])).cuda()

    def forward(model):
        i8.replicas[0] = model
        try:
            return i8.forward_device(u8)
        finally:
            i8.replicas[0] = pitched

    launches = {}
    outs = {}
    for name, model in (("pitched", pitched), ("packed", packed)):
        I.reset_launch_counts()
        outs[name] = forward(model)
        torch.cuda.synchronize()
        launches[name] = dict(I.int8_linear.variant_launches)
    got, want = outs["pitched"], outs["packed"]
    err = (got - want).abs().max().item()
    if launches != {"pitched": {"wgmma": 128}, "packed": {"wgmma": 96, "mma": 32}} or err != 0 \
            or got.shape != (32, 2560) or not torch.isfinite(got).all():
        raise AssertionError(f"virchow_v2 int8: launches by body {launches}, features {tuple(got.shape)}, "
                             f"max-abs {err} against the packed route (must be 0)")
    ms = {"pitched": [], "packed": []}
    for name in ("pitched", "packed", "packed", "pitched"):
        model = pitched if name == "pitched" else packed
        ms[name].append(cuda_ms(lambda: forward(model), min_total_ms=300.0))
    i8.cleanup()
    del i8, packed, pitched, outs, got, want
    torch.cuda.empty_cache()
    log(f"int8 (b2) virchow_v2 (dim 1280, depth 32, 16 heads, SwiGLU 3,416; random weights, registry build "
        f"{build_s:.1f} s), 32 patches at batch 32: launches by body {launches['pitched']} (fc2's weights and xq at "
        f"the 16-byte pitch), packed again {launches['packed']}; features max-abs {err} between the two routes; "
        f"resident forward ms (CUDA events, pitched / packed / packed / pitched) {ms['pitched'][0]:.3f} / "
        f"{ms['packed'][0]:.3f} / {ms['packed'][1]:.3f} / {ms['pitched'][1]:.3f} [{state['card']}]")
    return {"launches": launches["pitched"], "ms": min(ms["pitched"]), "packed_ms": min(ms["packed"])}


def _int8_cli(state) -> dict:
    """process --fast --feature-precision int8 --feature-extractors vit_l_16
    over four (f1) slides on the tiff phase's coordinates: no segmentation,
    96 launches of each int8 kernel per encoder forward, features (n, 1024)
    float32, coords and file attrs unchanged."""
    import tempfile

    import numpy as np

    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor
    from atlaspatch_tpu_torch.ops import int8 as I
    from atlaspatch_tpu_torch.utils.h5 import read_h5, read_h5_tree

    tiff_root = state["tiff_tmp"]
    f1 = tiff_root / "f1"
    stems = sorted(p.stem for p in f1.glob("*.svs"))[:4]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_int8_"))
    forward = TorchFeatureExtractor.forward_device
    forwards = [0]

    def counted(self, images_u8, replica=0):
        forwards[0] += 1
        return forward(self, images_u8, replica)

    try:
        slides, out = tmp / "slides", tmp / "out"
        (out / "patches").mkdir(parents=True)
        slides.mkdir()
        for stem in stems:
            (slides / f"{stem}.svs").symlink_to((f1 / f"{stem}.svs").resolve())
            (h5,) = (tiff_root / "runner" / "out").rglob(f"{stem}.h5")
            shutil.copy(h5, out / "patches" / f"{stem}.h5")
        before = {s: read_h5(out / "patches" / f"{s}.h5") for s in stems}
        TorchFeatureExtractor.forward_device = counted
        try:
            I.reset_launch_counts()
            lines, wall, attn_launches, seg_forwards = _cli_main(
                ["process", slides, "--output", out, *CLI_SEG_ARGS, "--fast", "--feature-precision", "int8",
                 "--feature-extractors", "vit_l_16"])
            launches, variants = _int8_launches(), dict(I.int8_linear.variant_launches)
            prologues = dict(I.quantize_rows.prologue_launches)
        finally:
            TorchFeatureExtractor.forward_device = forward
        if f"Completed {len(stems)} slide(s), failures: 0" not in lines or seg_forwards or attn_launches:
            raise AssertionError(f"int8 cli: {seg_forwards} segmentation forwards, {attn_launches} attention "
                                 f"launches; {lines[-3:]}")
        if not forwards[0] or launches != (96 * forwards[0], 96 * forwards[0]) \
                or variants != {"wgmma": 96 * forwards[0]} \
                or prologues != {k: n * forwards[0] for k, n in VITL_PROLOGUE_LAUNCHES.items()}:
            raise AssertionError(f"int8 cli: {launches} int8 launches ({variants}, {prologues}) in {forwards[0]} "
                                 f"encoder forwards")
        n_total = 0
        for stem in stems:
            tree = read_h5_tree(out / "patches" / f"{stem}.h5")
            (old_data, old_attrs), n = before[stem], before[stem][0]["coords"].shape[0]
            feats = tree.datasets.get("features/vit_l_16")
            if feats is None or feats.shape != (n, 1024) or feats.dtype != np.float32 or not np.isfinite(feats).all():
                raise AssertionError(f"int8 cli: {stem} features/vit_l_16 is {None if feats is None else feats.shape}")
            if tree.dataset_attrs["features/vit_l_16"] != {"name": "vit_l_16", "embedding_dim": 1024}:
                raise AssertionError(f"int8 cli: {stem} attrs {tree.dataset_attrs['features/vit_l_16']}")
            for key, arr in old_data.items():
                if tree.datasets[key].tobytes() != arr.tobytes():
                    raise AssertionError(f"int8 cli: {stem} {key} changed")
            if dict(tree.attrs) != old_attrs:
                raise AssertionError(f"int8 cli: {stem} file attrs changed")
            n_total += n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"int8 cli process --fast --feature-precision int8 over {len(stems)} (f1) slides, {n_total} patches on "
        f"the tiff phase's coordinates: {wall:.3f} s = {n_total / wall:.1f} patches/s by host clock (the encoder's "
        f"build included); 0 segmentation forwards; {forwards[0]} encoder forwards, {launches[0]} quantize_rows_s8 "
        f"(by prologue {prologues}) and {launches[1]} int8_linear_s8 launches, by body {variants}; features (n, 1024) "
        f"float32 finite, coords "
        f"and attrs unchanged [{state['card']}]")
    return dict(launches=launches, variants=variants, prologues=prologues, forwards=forwards[0], patches=n_total,
                wall=wall)


def phase_process(state):
    """process below the CLI: the runner phase's slides through
    ProcessingRunner.run() and then embed_all with vit_l_16 in bfloat16, as the
    JAX CLI composes them (atlaspatch_tpu/cli.py:313-347)."""
    import tempfile

    from atlaspatch_tpu_torch.core.config import SegmentationConfig

    stems, wsis = _runner_corpus()
    seg_cfg = SegmentationConfig(device="cuda", precision="bfloat16", input_size=768, batch_size=8)
    seg = _thresholding_service(seg_cfg)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_process_"))
    try:
        _drive_process(state, seg, seg_cfg, wsis, stems, tmp)
    finally:
        seg.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _drive_process(state, seg, seg_cfg, wsis, stems, tmp):
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.core.config import (
        AppConfig, ExtractionConfig, FeatureExtractionConfig, OutputConfig, ProcessingConfig,
    )
    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.orchestration.runner import ProcessingRunner
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.feature_embedding import PatchFeatureEmbeddingService
    from atlaspatch_tpu_torch.utils import perf
    from atlaspatch_tpu_torch.utils.h5 import read_h5, read_h5_tree

    in_dir = tmp / "slides"
    in_dir.mkdir()
    for stem in stems:
        (in_dir / f"{stem}.svs").touch()
    out = tmp / "out"

    def config(extractors):
        return AppConfig(
            processing=ProcessingConfig(input_path=in_dir),
            segmentation=seg_cfg,
            extraction=ExtractionConfig(patch_size=256, target_magnification=20, tissue_threshold=0.0),
            output=OutputConfig(output_root=out, skip_existing=True),
            features=FeatureExtractionConfig(extractors=extractors, batch_size=32, device="cuda",
                                             precision="bfloat16"),
            device="cuda",
        )

    def run_process(cfg):
        runner = ProcessingRunner(config=cfg, segmentation=seg,
                                  extractor=PatchExtractionService(cfg.extraction, cfg.output),
                                  visualizer=None, mpp_resolver=_NullResolver(), wsi_loader=_Loader(wsis))
        results, failures = runner.run()
        torch.cuda.synchronize()
        if failures or len(results) != len(stems):
            raise AssertionError(f"process: the runner gave {len(results)} results, {failures}")
        before = {r.slide.stem: read_h5(r.h5_path) for r in results}
        svc = PatchFeatureEmbeddingService(cfg.extraction, cfg.output, cfg.features)
        perf.reset()
        t0 = time.perf_counter()
        fails = svc.embed_all(results, wsi_loader=_Loader(wsis))
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        if fails:
            raise AssertionError(f"process: embed_all failed: {fails}")
        return sorted(results, key=lambda r: r.slide.stem), before, embed_s, perf.report()

    def features_of(results, name):
        got = {}
        for res in results:
            tree = read_h5_tree(res.h5_path)
            feats = tree.datasets.get(f"features/{name}")
            if feats is None or feats.shape != (res.num_patches, 1024 if name == "vit_l_16" else 768) \
                    or feats.dtype != np.float32 or not np.isfinite(feats).all():
                raise AssertionError(f"process: {res.slide.stem} features/{name} is "
                                     f"{None if feats is None else (feats.shape, feats.dtype)}")
            if tree.dataset_attrs.get(f"features/{name}") != {"name": name,
                                                              "embedding_dim": feats.shape[1]}:
                raise AssertionError(f"process: {res.slide.stem} features/{name} attrs "
                                     f"{tree.dataset_attrs.get(f'features/{name}')}")
            got[res.slide.stem] = (tree, feats)
        return got

    def unchanged(results, before, trees):
        for res in results:
            (old_data, old_attrs), tree = before[res.slide.stem], trees[res.slide.stem][0]
            for key, arr in old_data.items():
                if tree.datasets[key].tobytes() != arr.tobytes() or tree.datasets[key].dtype != arr.dtype:
                    raise AssertionError(f"process: {res.slide.stem} {key} changed by the append")
            if set(tree.attrs) != set(old_attrs) or any(
                    type(tree.attrs[k]) is not type(v) or tree.attrs[k] != v for k, v in old_attrs.items()):
                raise AssertionError(f"process: {res.slide.stem} file attrs changed by the append")

    patches_dir = out / "patches"
    A.reset_launch_counts()
    t0 = time.perf_counter()
    results, before, embed_s, stages = run_process(config(["vit_l_16"]))
    wall_s = time.perf_counter() - t0
    launches = A.flash_attention.launches
    state["process_launches"] = launches
    forwards = -(-len(stems) // seg_cfg.batch_size)
    if launches != 12 * forwards:
        raise AssertionError(f"process: {launches} kernel launches in {forwards} segmentation forwards")
    trees = features_of(results, "vit_l_16")
    unchanged(results, before, trees)
    if any(r.metadata.get("feature_sets") != ["vit_l_16"] for r in results):
        raise AssertionError(f"process: feature_sets {[r.metadata.get('feature_sets') for r in results]}")
    leftovers = [p.name for p in patches_dir.iterdir() if not p.name.endswith(".h5")]
    if leftovers:
        raise AssertionError(f"process: lock or stage files left behind: {leftovers}")
    total = sum(r.num_patches for r in results)
    if not total:
        raise AssertionError("process: no patch to embed")

    # one slide's features against extract_batch on its patches read directly
    probe = max(results, key=lambda r: r.num_patches)
    wsi = wsis[probe.slide.stem]
    coords = trees[probe.slide.stem][0].datasets["coords"]
    direct = [wsi.extract((int(x), int(y)), lv=int(lv), wh=(int(rw), int(rh)), mode="array")
              for x, y, rw, rh, lv in coords]
    if any(p.shape[:2] != (256, 256) for p in direct):
        import cv2

        direct = [p if p.shape[:2] == (256, 256) else cv2.resize(p, (256, 256)) for p in direct]
    ext = build_default_registry(device="cuda", dtype="bfloat16").create("vit_l_16")
    want = ext.extract_batch(direct, batch_size=32)
    ext.cleanup()
    got = trees[probe.slide.stem][1]
    cos = _cos_rows(got, want)
    if not cos.min() > 0.999:
        raise AssertionError(f"process: {probe.slide.stem} features vs extract_batch per-row cosine {cos.min()}")
    probe_err = float(np.abs(got - want).max())

    # a second embed_all: nothing to do, no file rewritten
    mtimes = {p: p.stat().st_mtime_ns for p in patches_dir.iterdir()}
    cfg = config(["vit_l_16"])
    perf.reset()
    svc = PatchFeatureEmbeddingService(cfg.extraction, cfg.output, cfg.features)
    if svc.embed_all(results, wsi_loader=_Loader(wsis)):
        raise AssertionError("process: the second embed_all failed")
    again = perf.report()
    if any(k.startswith("embed_") or k == "h5_append" for k in again):
        raise AssertionError(f"process: the second embed_all ran {again}")
    if {p: p.stat().st_mtime_ns for p in patches_dir.iterdir()} != mtimes:
        raise AssertionError("process: the second embed_all rewrote files")

    # one more encoder: the runner reuses every slide's coordinates, only vit_b_16 is embedded
    A.reset_launch_counts()
    results2, before2, _, stages2 = run_process(config(["vit_l_16", "vit_b_16"]))
    if A.flash_attention.launches:
        raise AssertionError(f"process: the reuse pass segmented ({A.flash_attention.launches} launches)")
    trees2 = features_of(results2, "vit_b_16")
    unchanged(results2, before2, trees2)
    for res in results2:
        if trees2[res.slide.stem][0].datasets["features/vit_l_16"].tobytes() != trees[res.slide.stem][1].tobytes():
            raise AssertionError(f"process: {res.slide.stem} vit_l_16 re-embedded")
        if res.metadata.get("feature_sets") != ["vit_b_16", "vit_l_16"]:
            raise AssertionError(f"process: feature_sets {res.metadata.get('feature_sets')}")
    if stages2.get("h5_append", {}).get("count") != len(stems):
        raise AssertionError(f"process: the reuse pass appended {stages2.get('h5_append')}")

    append = stages.get("h5_append", {})
    log(f"process {len(stems)} slides, {total} patches: runner + embed_all {wall_s:.3f} s, embed_all "
        f"{embed_s:.3f} s = {total / embed_s:.1f} patches/s (vit_l_16 bf16 batch 32) by host clock; "
        f"{launches} attention kernel launches in {forwards} segmentation forwards [{state['card']}]")
    log(f"process h5 append {append.get('mean_ms', float('nan')):.3f} ms per slide (cpu "
        f"{1e3 * append.get('cpu_s', 0) / max(1, append.get('count', 1)):.3f} ms); {probe.slide.stem} "
        f"({probe.num_patches} patches) vs extract_batch read directly: per-row cosine min {cos.min():.6f}, "
        f"max-abs {probe_err:.3g} [{state['card']}]")
    log("process stages " + json.dumps(stages) + f" [{state['card']}]")
    log("process second embed_all: no forward, no file rewritten; reuse pass with vit_b_16: 0 "
        f"segmentation launches, {len(stems)} appends of vit_b_16 only; stages " + json.dumps(stages2))


CLI_SEG_ARGS = ["--patch-size", "256", "--target-mag", "20"]


def _cli_main(args, *, counted=True):
    """One in-process command through atlaspatch_tpu_torch.cli.main (its
    exceptions propagate); returns (stdout lines, wall s, attention launches,
    segmentation forwards). The counts are zeroed just before the command."""
    import contextlib
    import io

    import torch

    from atlaspatch_tpu_torch import cli as cli_mod
    from atlaspatch_tpu_torch.models.sam2 import model as sam2_model
    from atlaspatch_tpu_torch.ops import attention as A

    forwards = [0]
    steps = {name: getattr(sam2_model, name) for name in
             ("segment_step_packed_to_shape", "segment_step_packed_from_thumbs", "segment_step_packed")}

    def counting(step):
        def wrapped(*a, **k):
            forwards[0] += 1
            return step(*a, **k)
        return wrapped

    out = io.StringIO()
    for name, step in steps.items():
        setattr(sam2_model, name, counting(step))
    try:
        A.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli_mod.main([str(a) for a in args], standalone_mode=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = A.flash_attention.launches
    finally:
        for name, step in steps.items():
            setattr(sam2_model, name, step)
    lines = out.getvalue().splitlines()
    log(f"cli $ atlaspatch-tpu-torch {' '.join(str(a) for a in args[:1])} ...: " + " | ".join(lines[-2:]))
    return lines, wall, launches, forwards[0]


def _in_process_coords(slides_dir: Path) -> dict:
    """{stem: coords} from an in-process --fast SAM2SegmentationService (the
    same settings and random-weight seed as the CLI's) and the port's
    PatchExtractionService, batched as the runner batches the slides."""
    import numpy as np

    from atlaspatch_tpu_torch.core.config import ExtractionConfig, OutputConfig, SegmentationConfig
    from atlaspatch_tpu_torch.core.models import Slide
    from atlaspatch_tpu_torch.services.extraction import PatchExtractionService
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService
    from atlaspatch_tpu_torch.services.wsi_loader import DefaultWSILoader
    from atlaspatch_tpu_torch.utils.params import get_wsi_files

    seg = SAM2SegmentationService(SegmentationConfig(device="cuda", precision="bfloat16", input_size=768,
                                                     input_size_preset=True, batch_size=8))
    extraction = PatchExtractionService(ExtractionConfig(patch_size=256, target_magnification=20,
                                                         tissue_threshold=0.0),
                                        OutputConfig(output_root=slides_dir.parent / "unused"))
    loader = DefaultWSILoader()
    slides = [Slide(path=Path(p)) for p in get_wsi_files(str(slides_dir))]
    coords = {}
    try:
        for i in range(0, len(slides), 8):
            batch = slides[i : i + 8]
            wsis = [loader.open(s) for s in batch]
            masks = seg.segment_thumbnails(seg.prepare_thumbnails(wsis))
            for slide, wsi, mask in zip(batch, wsis, masks):
                entries = extraction._iter_patch_entries(wsi, *extraction._prepare_contours(mask.data, wsi),
                                                         include_patch=False)
                coords[slide.stem] = np.asarray([e[:5] for e in entries], dtype=np.int32).reshape(-1, 5)
                wsi.cleanup()
    finally:
        seg.close()
    return coords


def _decodes(path: Path) -> bool:
    from PIL import Image

    with Image.open(path) as im:
        im.load()
        return im.format == "PNG" and im.size[0] > 0 and im.size[1] > 0


def phase_cli(state):
    """The port's command line on the card, in-process and as a subprocess,
    over the tiff phase's corpus, with the default device (no --device). The
    corpus and the command's H5 files stay for the weights phase."""
    _drive_cli(state, state["tiff_tmp"])


def _drive_cli(state, root):
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.io.synthetic_wsi import make_tissue_canvas
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor, init_random_weights_
    from atlaspatch_tpu_torch.models.encoders.resnet import ResNet
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
    from atlaspatch_tpu_torch.utils.h5 import read_h5, read_h5_tree

    corpus = state["tiff_corpus"]
    slides = corpus["slides"]
    n_slides = len(corpus["paths"])
    out = root / "cli_out"
    cli_counts = {}

    # 1. segment-and-get-coords --fast with the three overlays, no --device
    lines, wall, launches, forwards = _cli_main(
        ["segment-and-get-coords", slides, "--output", out, *CLI_SEG_ARGS, "--fast",
         "--visualize-grids", "--visualize-mask", "--visualize-contours"])
    cli_counts["segment-and-get-coords"] = (wall, n_slides, forwards, launches)
    if f"Completed {n_slides} slide(s), failures: 0" not in lines:
        raise AssertionError(f"cli segment-and-get-coords printed {lines}")
    if not forwards or launches != 12 * forwards:
        raise AssertionError(f"cli segment-and-get-coords: {launches} attention launches in {forwards} forwards")
    want = _in_process_coords(slides)
    h5s = sorted((out / "patches").glob("*.h5"))
    if sorted(p.stem for p in h5s) != sorted(want):
        raise AssertionError(f"cli: H5 files {[p.stem for p in h5s]} for slides {sorted(want)}")
    per_slide = []
    for path in h5s:
        coords = read_h5(path)[0]["coords"]
        if coords.dtype != np.int32 or coords.tobytes() != want[path.stem].tobytes():
            raise AssertionError(f"cli: {path.stem} coords {coords.shape} differ from the in-process "
                                 f"service's {want[path.stem].shape}")
        per_slide.append(int(coords.shape[0]))
    vis = out / "visualization"
    pngs = sorted(vis.glob("*.png"))
    if len(pngs) != 4 * n_slides or not all(_decodes(p) for p in pngs):
        raise AssertionError(f"cli: {len(pngs)} overlay PNGs for {n_slides} slides, want 4 each that decode")
    for stem in (s for s in corpus["paths"] if s.startswith("tslide")):
        missing = [f for f in (f"{stem}.png", f"{stem}_mask.png", f"{stem}_contours.png") if not (vis / f).exists()]
        if missing:
            raise AssertionError(f"cli: {stem} lacks overlays {missing}")
    log(f"cli segment-and-get-coords --fast over {n_slides} slide files (f1 + f3): {wall:.3f} s = "
        f"{n_slides / wall:.2f} slides/s by host clock with 3 overlays per slide; {forwards} forwards, "
        f"{launches} attention launches; coordinates equal the in-process service's byte for byte; patches "
        f"per slide {per_slide} [{state['card']}]")

    # 2. detect-tissue over the same files plus one PNG with no MPP
    detect_in = root / "detect_in"
    detect_in.mkdir()
    for src in slides.iterdir():
        (detect_in / src.name).symlink_to(src.resolve())
    from PIL import Image

    Image.fromarray(make_tissue_canvas(1024, 768, seed=500, n_blobs=2)).save(detect_in / "nompp.png")
    detect_out = root / "detect_out"
    lines, wall, launches, forwards = _cli_main(["detect-tissue", detect_in, "--output", detect_out,
                                                 "--seg-batch-size", "8"])
    cli_counts["detect-tissue"] = (wall, n_slides + 1, forwards, launches)
    if f"Created {n_slides} mask overlay(s), failures: 1" not in lines:
        raise AssertionError(f"cli detect-tissue printed {lines}")
    if not forwards or launches != 12 * forwards:
        raise AssertionError(f"cli detect-tissue: {launches} attention launches in {forwards} forwards")
    for suffix in ("_mask.png", "_mask_bw.png"):
        found = sorted((detect_out / "visualization").glob(f"*{suffix}"))
        if len(found) != n_slides or any(p.name.startswith("nompp") for p in found) \
                or not all(_decodes(p) for p in found):
            raise AssertionError(f"cli detect-tissue: {len(found)} {suffix} files for {n_slides} healthy slides")
    log(f"cli detect-tissue (float32, 1024, batch 8) over {n_slides} slides + a PNG with no MPP: {wall:.3f} s; "
        f"{forwards} forwards, {launches} attention launches; the poisoned slide failed alone [{state['card']}]")

    # 3. process --fast with resnet50 and vit_l_16 over the 28 (f1) slides, on step 1's coordinates
    f1 = slides.parent / "f1"
    stems = sorted(p.stem for p in f1.glob("*.svs"))
    before = {s: read_h5(out / "patches" / f"{s}.h5") for s in stems}
    timing: dict = {}
    real_extract = TorchFeatureExtractor.extract_batch

    def timed_extract(self, patches, *, batch_size=None):
        t0 = time.perf_counter()
        rows = real_extract(self, patches, batch_size=batch_size)
        entry = timing.setdefault(self.name, [0.0, 0])
        entry[0] += time.perf_counter() - t0
        entry[1] += len(rows)
        return rows

    TorchFeatureExtractor.extract_batch = timed_extract
    try:
        lines, wall, launches, forwards = _cli_main(
            ["process", f1, "--output", out, *CLI_SEG_ARGS, "--fast", "--feature-extractors", "resnet50 vit_l_16"])
    finally:
        TorchFeatureExtractor.extract_batch = real_extract
    cli_counts["process"] = (wall, len(stems), forwards, launches)
    if f"Completed {len(stems)} slide(s), failures: 0" not in lines:
        raise AssertionError(f"cli process printed {lines}")
    if forwards or launches:
        raise AssertionError(f"cli process segmented again ({forwards} forwards) on existing coordinates")
    total = 0
    for stem in stems:
        tree = read_h5_tree(out / "patches" / f"{stem}.h5")
        (old_data, old_attrs), n = before[stem], before[stem][0]["coords"].shape[0]
        for name, dim in (("resnet50", 2048), ("vit_l_16", 1024)):
            feats = tree.datasets.get(f"features/{name}")
            if feats is None or feats.shape != (n, dim) or feats.dtype != np.float32 or not np.isfinite(feats).all():
                raise AssertionError(f"cli process: {stem} features/{name} is "
                                     f"{None if feats is None else (feats.shape, feats.dtype)}")
        for key, arr in old_data.items():
            if tree.datasets[key].tobytes() != arr.tobytes():
                raise AssertionError(f"cli process: {stem} {key} changed")
        if {k: v for k, v in tree.attrs.items()} != old_attrs:
            raise AssertionError(f"cli process: {stem} file attrs changed")
        total += n
    rates = {name: count / secs for name, (secs, count) in timing.items()}
    if set(rates) != {"resnet50", "vit_l_16"} or any(timing[k][1] != total for k in timing):
        raise AssertionError(f"cli process: embedded {timing} for {total} patches")

    # resnet50 at full width: float32 on the card against the CPU on the same weights
    # (built with TF32 on, which the engine must turn off), and bfloat16 against float32
    entry = ENTRIES["resnet50"]
    model = init_random_weights_(ResNet(entry.spec), seed=0)
    rng = np.random.default_rng(1)
    patches = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(4)]
    cpu = TorchFeatureExtractor(name="resnet50", embedding_dim=2048, spec=entry.preprocess,
                                model=copy.deepcopy(model), device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    card = TorchFeatureExtractor(name="resnet50", embedding_dim=2048, spec=entry.preprocess,
                                 model=copy.deepcopy(model), device="cuda")
    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("the float32 resnet50 extractor left cuDNN's TF32 on")
    f32 = card.extract_batch(patches)
    f32_err = float(np.abs(f32 - cpu.extract_batch(patches)).max())
    bf16 = TorchFeatureExtractor(name="resnet50", embedding_dim=2048, spec=entry.preprocess,
                                 model=model, device="cuda", compute_dtype="bfloat16")
    if any(p.dtype != torch.bfloat16 for p in bf16.model.parameters()):
        raise AssertionError("a bfloat16 resnet50 param is not bfloat16")
    cos = _cos_rows(bf16.extract_batch(patches), f32)
    if not f32_err <= 1e-4 or not cos.min() > 0.995:
        raise AssertionError(f"cli resnet50: card vs CPU max-abs {f32_err}, bf16 vs f32 cosine {cos.min()}")
    # the bf16 extractor's rate on 256 patches at batch 32: its first such call, then warm
    many = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(256)]
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        bf16.extract_batch(many, batch_size=32)
        passes.append(len(many) / (time.perf_counter() - t0))
    # one forward at a batch no earlier call used (64), twice: a first call
    # per shape builds cuDNN's plans for every convolution
    unseen = torch.zeros((64, 224, 224, 3), dtype=torch.uint8, device="cuda")
    unseen_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf16.forward_device(unseen)
        torch.cuda.synchronize()
        unseen_ms.append(1e3 * (time.perf_counter() - t0))
    for ext in (card, bf16):
        ext.cleanup()
    log(f"cli process --fast resnet50 + vit_l_16 (bf16, batch 32) over {len(stems)} (f1) slides, {total} patches "
        f"on step 1's coordinates: {wall:.3f} s; extract_batch host clock resnet50 {rates['resnet50']:.1f} "
        f"patches/s, vit_l_16 {rates['vit_l_16']:.1f} patches/s; features (n, 2048) and (n, 1024) finite, coords "
        f"and attrs unchanged; resnet50 float32 card vs CPU max-abs {f32_err:.3g} on 4 patches, bf16 vs float32 "
        f"cosine min {cos.min():.6f}; resnet50 bf16 extract_batch on 256 patches at batch 32: first call "
        f"{passes[0]:.1f}, then {passes[1]:.1f} and {passes[2]:.1f} patches/s; a forward at batch 64 (a new shape) "
        f"{unseen_ms[0]:.1f} ms, again {unseen_ms[1]:.1f} ms [{state['card']}]")

    # the real entry point in a subprocess: info, then segment-and-get-coords -v on 2 slides, no --device
    two = root / "two"
    two.mkdir()
    for stem in stems[:2]:
        (two / f"{stem}.svs").symlink_to((f1 / f"{stem}.svs").resolve())
    repo = Path(__file__).resolve().parent
    runs = {}
    for args in (["info"], ["segment-and-get-coords", two, "--output", root / "sub_out", *CLI_SEG_ARGS, "-v"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "atlaspatch_tpu_torch.cli", *map(str, args)], cwd=repo,
                              capture_output=True, text=True, timeout=300)
        runs[args[0]] = (proc, time.perf_counter() - t0)
        if proc.returncode != 0:
            raise AssertionError(f"cli subprocess {args[0]}: rc {proc.returncode}\n{proc.stderr[-2000:]}")
    info, seg = runs["info"][0], runs["segment-and-get-coords"][0]
    if "Feature extractors (" not in info.stdout or "resnet50" not in info.stdout:
        raise AssertionError(f"cli info printed {info.stdout}")
    device = re.search(r"SAM2 predictor device: (\S+)", seg.stderr)
    if device is None or device.group(1) != "cuda" or "Completed 2 slide(s), failures: 0" not in seg.stdout:
        raise AssertionError(f"cli subprocess: SAM2 device {device and device.group(1)}; {seg.stdout[-500:]}")
    log(f"cli subprocess: python -m atlaspatch_tpu_torch.cli info rc 0 in {runs['info'][1]:.1f} s; "
        f"segment-and-get-coords -v on 2 slides rc 0 in {runs['segment-and-get-coords'][1]:.1f} s, SAM2 device "
        f"{device.group(1)}")
    for command, (wall, n, forwards, launches) in cli_counts.items():
        log(f"cli {command}: {wall:.3f} s, {n / wall:.2f} slides/s, {forwards} forwards, {launches} attention "
            f"launches [{state['card']}]")
    state["cli_launches"] = sum(c[3] for c in cli_counts.values())
    state["cli_rates"] = rates


# --- the weights phase: published checkpoint layouts on the card ---------------------
# name → checkpoint file as its source ships it (h1: uni_v1; h2: the four new towers)
WEIGHT_FILES = {"uni_v1": "uni_v1.safetensors", "conch_v1": "conch_v1.bin",
                "chief-ctranspath": "chief-ctranspath.pth", "musk": "musk.safetensors",
                "clip_rn50": "clip_rn50.pt"}
WEIGHT_WIDTHS = {"uni_v1": 1024, "conch_v1": 512, "chief-ctranspath": 768, "musk": 2048, "clip_rn50": 1024}
SHALLOW = {"uni_v1": 2, "musk": 2}  # depth of the float32 card-vs-CPU check; the others run whole
ST_DTYPES = {"float32": "F32", "bfloat16": "BF16"}


def _write_safetensors(path: Path, tensors: dict) -> None:
    """A .safetensors file of CPU tensors (the safetensors module is absent on
    the card's host): u64 header length, the JSON header padded to 8 bytes,
    the raw bytes."""
    import struct

    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[str(t.dtype).split(".")[1]], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def _tower_shapes(entry) -> dict:
    import torch

    from atlaspatch_tpu_torch.models.encoders.zoo import _TOWERS

    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in _TOWERS[entry.family][0](entry.spec).state_dict().items()}


def _same_state(got: dict, want: dict) -> float:
    """max-abs between two state_dicts with the same keys and shapes."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"weights: keys differ: {sorted(set(got) ^ set(want))[:5]}")
    err = 0.0
    for k, v in want.items():
        if got[k].shape != v.shape:
            raise AssertionError(f"weights: {k} is {tuple(got[k].shape)}, want {tuple(v.shape)}")
        err = max(err, float((got[k].float() - v.float()).abs().max()) if v.numel() else 0.0)
    return err


def phase_weights(state):
    """Every new tower's published checkpoint layout, from files on the card's
    host, through the reader, the converters, verify-weights and process."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_weights_"))
    try:
        _drive_weights(state, tmp, state["tiff_tmp"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(state.pop("tiff_tmp"), ignore_errors=True)


def _drive_weights(state, tmp, tiff_root):
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from upstream_values import upstream_checkpoint

    from atlaspatch_tpu_torch import cli as cli_mod
    from atlaspatch_tpu_torch.models.encoders import zoo
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor
    from atlaspatch_tpu_torch.utils import safetensors as st
    from atlaspatch_tpu_torch.utils.h5 import read_h5, read_h5_tree

    card = state["card"]
    wdir = tmp / "weights"
    wdir.mkdir()
    states, sizes, load_s, gbps = {}, {}, {}, {}

    # (h1) + (h2): a numpy Flax-layout tree's shapes from each port tower, the
    # upstream layout by tests/upstream_layouts.py, seeded values; saved as shipped
    t_make = time.perf_counter()
    for seed, (name, fname) in enumerate(WEIGHT_FILES.items()):
        entry = zoo.ENTRIES[name]
        sd = upstream_checkpoint(entry, _tower_shapes(entry), seed=100 + seed)
        tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
        if name == "musk":  # stored in BF16: the tree is rounded to bf16 values first
            tensors = {k: v.bfloat16() for k, v in tensors.items()}
            sd = {k: v.float().numpy() for k, v in tensors.items()}
        states[name] = zoo._TOWERS[entry.family][1](zoo._convert_flax(entry, sd))  # the tree's state_dict
        path = wdir / fname
        if fname.endswith(".safetensors"):
            _write_safetensors(path, tensors)
        else:
            torch.save({"model": tensors} if name == "chief-ctranspath" else tensors, path)
        sizes[name] = path.stat().st_size
    # (h3) dinov2_small as two shards in the HF hub cache layout
    hub = tmp / "hub"
    snap = hub / "models--facebook--dinov2-small" / "snapshots" / "0123456789abcdef"
    snap.mkdir(parents=True)
    entry = zoo.ENTRIES["dinov2_small"]
    sd = upstream_checkpoint(entry, _tower_shapes(entry), seed=200)
    states["dinov2_small"] = zoo._TOWERS[entry.family][1](zoo._convert_flax(entry, sd))
    keys = sorted(sd)
    for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2 :]), 1):
        _write_safetensors(snap / f"model-0000{i}-of-00002.safetensors", {k: torch.from_numpy(sd[k]) for k in part})
    sizes["dinov2_small"] = sum(p.stat().st_size for p in snap.iterdir())
    make_s = time.perf_counter() - t_make

    # the reader's rate (page cache: the files were just written) and each
    # checkpoint's load + convert, whose state_dict must equal the tree's
    env = {"ATLASPATCH_WEIGHTS_DIR": str(wdir), "HF_HUB_CACHE": str(hub)}
    old_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for name in ("uni_v1", "musk"):
            t0 = time.perf_counter()
            for t in st.load_file(wdir / WEIGHT_FILES[name]).values():  # map, then touch every byte
                if t.numel():
                    t.reshape(-1).view(torch.uint8).max()
            gbps[name] = sizes[name] / (time.perf_counter() - t0) / 1e9
        errs = {}
        for name in (*WEIGHT_FILES, "dinov2_small"):
            entry = zoo.ENTRIES[name]
            path = zoo._find_cached_weights(entry)
            want_path = snap / "model-00001-of-00002.safetensors" if name == "dinov2_small" else wdir / WEIGHT_FILES[name]
            if path != want_path:
                raise AssertionError(f"weights: {name} found {path}, want {want_path}")
            t0 = time.perf_counter()
            got = zoo._convert(entry, zoo._load_state_dict(path))
            load_s[name] = time.perf_counter() - t0
            errs[name] = _same_state(got, states[name])
            if errs[name] != 0.0:
                raise AssertionError(f"weights: {name}'s state_dict from {path.name} differs by {errs[name]}")
        log(f"weights checkpoints (seeded values in the upstream layouts, made and written in {make_s:.1f} s): "
            + "; ".join(f"{n} {sizes[n] / 2**20:.1f} MiB" for n in sizes)
            + f"; reader from the page cache: uni_v1 {gbps['uni_v1']:.2f} GB/s, musk (BF16) {gbps['musk']:.2f} GB/s; "
            f"load + convert s: " + ", ".join(f"{n} {s:.3f}" for n, s in load_s.items())
            + f"; every state_dict equal to the tree's (max-abs 0; dinov2_small from 2 shards) [{card}]")

        # verify-weights over the dir, default device; then a dir whose uni_v1 has one shape wrong
        def verify(args):
            out = io.StringIO()
            code = 0
            with contextlib.redirect_stdout(out):
                try:
                    cli_mod.main([str(a) for a in args], standalone_mode=False)
                except SystemExit as e:
                    code = e.code
            return out.getvalue().splitlines(), code

        t0 = time.perf_counter()
        lines, code = verify(["verify-weights", wdir, "--no-sam2"])
        verify_s = time.perf_counter() - t0
        passed = sorted(ln.split()[1] for ln in lines if ln.startswith("PASS"))
        if code or passed != sorted([*WEIGHT_FILES, "dinov2_small"]) or \
                lines[-1] != "preflight: 6 PASS, 0 FAIL, 60 SKIP":
            raise AssertionError(f"weights: verify-weights rc {code}, PASS {passed}, last line {lines[-1:]}")
        bad_dir = tmp / "bad"
        bad_dir.mkdir()
        bad = st.load_file(wdir / "uni_v1.safetensors")
        bad_key = "blocks.5.attn.qkv.weight"
        bad = {k: (v[:, :-8] if k == bad_key else v) for k, v in bad.items()}
        _write_safetensors(bad_dir / "uni_v1.safetensors", bad)
        bad_lines, bad_code = verify(["verify-weights", bad_dir, "--names", "uni_v1", "--no-sam2"])
        fail = [ln for ln in bad_lines if ln.startswith("FAIL")]
        if bad_code != 1 or len(fail) != 1 or bad_key not in fail[0]:
            raise AssertionError(f"weights: the bad dir gave rc {bad_code}: {bad_lines}")
        log(f"weights verify-weights (default device, forward smoke): {verify_s:.1f} s, "
            + " | ".join(ln for ln in lines if ln.startswith("PASS")) + f" | {lines[-1]}; the bad dir: rc 1, "
            f"{fail[0][:160]} [{card}]")

        # process over four (f1) slides on the cli phase's coordinates
        f1 = tiff_root / "f1"
        stems = sorted(p.stem for p in f1.glob("*.svs"))[:4]
        slides, out = tmp / "slides", tmp / "out"
        (out / "patches").mkdir(parents=True)
        slides.mkdir()
        for stem in stems:
            (slides / f"{stem}.svs").symlink_to((f1 / f"{stem}.svs").resolve())
            shutil.copy(tiff_root / "cli_out" / "patches" / f"{stem}.h5", out / "patches" / f"{stem}.h5")
        before = {s: read_h5(out / "patches" / f"{s}.h5") for s in stems}
        lines, wall, launches, forwards = _cli_main(
            ["process", slides, "--output", out, *CLI_SEG_ARGS, "--fast", "--feature-extractors",
             " ".join(WEIGHT_FILES)])
        if f"Completed {len(stems)} slide(s), failures: 0" not in lines or forwards or launches:
            raise AssertionError(f"weights process: {forwards} forwards, {launches} launches; {lines[-3:]}")
        n_total = 0
        for stem in stems:
            tree = read_h5_tree(out / "patches" / f"{stem}.h5")
            (old_data, old_attrs), n = before[stem], before[stem][0]["coords"].shape[0]
            for name, dim in WEIGHT_WIDTHS.items():
                feats = tree.datasets.get(f"features/{name}")
                if feats is None or feats.shape != (n, dim) or not np.isfinite(feats).all():
                    raise AssertionError(f"weights process: {stem} features/{name} is "
                                         f"{None if feats is None else feats.shape}")
            for key, arr in old_data.items():
                if tree.datasets[key].tobytes() != arr.tobytes():
                    raise AssertionError(f"weights process: {stem} {key} changed")
            if dict(tree.attrs) != old_attrs:
                raise AssertionError(f"weights process: {stem} file attrs changed")
            n_total += n
        state["weights_launches"] = launches
        log(f"weights process --fast over {len(stems)} (f1) slides, {n_total} patches on the cli phase's "
            f"coordinates, 5 encoders from their checkpoint files: {wall:.3f} s, {forwards} segmentation forwards, "
            f"{launches} attention launches; features (n, 1024/512/768/2048/1024) finite, coords and attrs "
            f"unchanged [{card}]")
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # numerics of the four new towers and uni_v1, on the loaded weights
    rng = np.random.default_rng(5)
    patches = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(128)]
    torch.cuda.reset_peak_memory_stats()
    report = {}
    for name in WEIGHT_FILES:
        entry = zoo.ENTRIES[name]
        tower = zoo._TOWERS[entry.family][0]
        spec = entry.spec
        if name in SHALLOW:
            spec = dataclasses.replace(spec, depth=SHALLOW[name])
        shallow = tower(spec)
        shallow.load_state_dict({k: states[name][k] for k in shallow.state_dict()}, strict=True)
        cpu = TorchFeatureExtractor(name=name, embedding_dim=WEIGHT_WIDTHS[name], spec=entry.preprocess,
                                    model=copy.deepcopy(shallow), device="cpu")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        f32 = TorchFeatureExtractor(name=name, embedding_dim=WEIGHT_WIDTHS[name], spec=entry.preprocess,
                                    model=shallow, device="cuda")
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            raise AssertionError(f"weights: the float32 {name} extractor left TF32 on")
        f32_err = float(np.abs(f32.extract_batch(patches[:4]) - cpu.extract_batch(patches[:4])).max())
        f32.cleanup()
        del cpu, f32, shallow
        full = tower(entry.spec)
        full.load_state_dict(states[name], strict=True)
        f32 = TorchFeatureExtractor(name=name, embedding_dim=WEIGHT_WIDTHS[name], spec=entry.preprocess,
                                    model=copy.deepcopy(full), device="cuda")
        bf16 = TorchFeatureExtractor(name=name, embedding_dim=WEIGHT_WIDTHS[name], spec=entry.preprocess,
                                     model=full, device="cuda", compute_dtype="bfloat16")
        tensors = [*bf16.model.parameters(), *(b for b in bf16.model.buffers() if b.is_floating_point())]
        if not all(t.dtype == torch.bfloat16 and t.is_cuda for t in tensors):
            raise AssertionError(f"weights: a param or buffer of the bfloat16 {name} extractor is not bfloat16")
        cos = _cos_rows(f32.extract_batch(patches[:16]), bf16.extract_batch(patches[:16]))
        f32.cleanup()
        if not (f32_err <= 1e-4 and cos.min() > 0.995):
            raise AssertionError(f"weights: {name} float32 card vs CPU {f32_err}, bf16 vs float32 cosine {cos.min()}")
        med_s, _ = _timed_passes(bf16, patches, 32)
        bf16.cleanup()
        report[name] = (f32_err, float(cos.min()), len(patches) / med_s)
        log(f"weights {name}: float32 card vs CPU max-abs {f32_err:.3g} on 4 patches "
            f"({'depth ' + str(SHALLOW[name]) if name in SHALLOW else 'full depth'}, TF32 on before the build); "
            f"bf16 vs float32 cosine min {cos.min():.6f} on 16; {len(tensors)} params and buffers bf16; "
            f"extract_batch bf16 at batch 32 (warm, median of 3 over {len(patches)}) "
            f"{len(patches) / med_s:.1f} patches/s [{card}]")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"weights peak memory allocated {peak_gib:.2f} GiB [{card}]")
    state["weights"] = dict(report=report, gbps=gbps, load_s=load_s, peak_gib=peak_gib)


# --- the finetune phase: finetune-sam2 → detect-tissue → evaluate-masks ------------------
FT_PAIRS = 10  # 1024x768: 8 train, 2 held out at --val-fraction 0.2
FT_ARGS = ["--batch-size", "2", "--val-fraction", "0.2", "--save-every", "1", "--trainable", "norms"]
# card vs CPU norm gradients, per tensor: max |diff| <= this x max |CPU gradient|; the
# sound step reads ~5e-6 and the step with TF32 switched on must read above it
FT_GRAD_BOUND = 1e-4


def _write_ft_corpus(root: Path, n: int, width: int, height: int) -> tuple[Path, Path]:
    """n pairs of the port's synthetic corpus (seeds 0..n-1), written by n
    generate_corpus calls on threads (numpy and PNG encoding release the GIL)."""
    from atlaspatch_tpu_torch.tools.synthetic_corpus import generate_corpus

    with ThreadPoolExecutor(max_workers=min(n, 6)) as pool:
        dirs = list(pool.map(lambda i: generate_corpus(root, n=1, width=width, height=height, seed=i,
                                                       prefix=f"syn{i:02d}_"), range(n)))
    return dirs[0]


def _counting_train_steps(record: dict):
    """Wrap models.train.finetune's step factories, which the loop looks up at
    each run, so every train step and validation forward records its host
    time, loss, attention launches (by variant) and plain autograd calls;
    returns the function that puts the factories back."""
    from atlaspatch_tpu_torch.models.train import finetune as ft
    from atlaspatch_tpu_torch.ops import attention as A

    real = ft.make_train_step, ft.make_eval_step

    def counted(kind, step):
        def run(images, targets):
            launches, grads = A.flash_attention.launches, A.attention.plain_grad_calls
            variants = Counter(A.flash_attention.variant_launches)
            t0 = time.perf_counter()
            out = step(images, targets)
            loss = float(out if kind == "train" else out[0].mean())  # waits for the device
            record[kind].append(dict(s=time.perf_counter() - t0, loss=loss,
                                     launches=A.flash_attention.launches - launches,
                                     grad_calls=A.attention.plain_grad_calls - grads,
                                     variants=dict(Counter(A.flash_attention.variant_launches) - variants)))
            return out
        return run

    ft.make_train_step = lambda model, optimizer, lr, **kw: counted("train", real[0](model, optimizer, lr, **kw))
    ft.make_eval_step = lambda model: counted("eval", real[1](model))

    def restore():
        ft.make_train_step, ft.make_eval_step = real
    return restore


def _one_train_step(init: Path, cfg, images, targets, device: str, tf32: bool = False, trainable: str = "norms"):
    """(model, loss, {Flax key: gradient in the JAX layout}) of one AdamW
    step from ``init`` on ``device`` over the ``trainable`` tensors (the
    norms, or all). TF32 is on when the step is built, which must turn it
    off; ``tf32`` switches it on again for the step itself, a control."""
    import torch

    from atlaspatch_tpu_torch.models.sam2.convert import load_into, load_npz, to_flax_layout
    from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel
    from atlaspatch_tpu_torch.models.train import finetune as ft

    model = SAM2ImageModel(cfg)
    load_into(model, load_npz(init, cfg))
    model.to(device)
    params = ft.trainable_parameters(model, trainable)
    optimizer, lr = ft.make_optimizer(params.values())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = device != "cpu"
    step = ft.make_train_step(model, optimizer, lr)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError(f"finetune: the train step built on {device} left TF32 on")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        loss = float(step(images, targets))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return model, loss, to_flax_layout(model, {k: t.grad for k, t in params.items()})


def phase_finetune(state):
    """finetune-sam2 (Hiera-tiny, 1024, float32, batch 2) on the synthetic
    annotated corpus, its resume, detect-tissue with the fine-tuned archive
    and evaluate-masks, on the card."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_finetune_"))
    try:
        _drive_finetune(state, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _drive_finetune(state, tmp, device="cuda", size=(1024, 768)):
    import csv
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.convert import torch_to_flax_flat
    from atlaspatch_tpu_torch.models.sam2.model import init_params
    from atlaspatch_tpu_torch.models.train import finetune as ft
    from atlaspatch_tpu_torch.models.train.loop import collect_pairs, load_pair
    from atlaspatch_tpu_torch.ops import attention as A

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    images, masks = _write_ft_corpus(tmp / "corpus", FT_PAIRS, *size)
    cfg = SAM2Config.tiny()
    n_attn = sum(cfg.blocks_per_stage)  # trunk attention calls per forward: 12 at Hiera-tiny
    n_launch = n_attn if on_card else 0  # kernel launches per forward without a gradient
    init = tmp / "init.npz"
    np.savez(init, **torch_to_flax_flat(init_params(cfg, seed=0), cfg))  # random weights, written once
    out = tmp / "ft"
    setup_s = time.perf_counter() - t_phase
    dev_args = [] if on_card else ["--device", device]

    # 1. finetune-sam2 --epochs 2, then --resume --epochs 3, in process, with TF32 on before
    record = {"train": [], "eval": []}
    restore = _counting_train_steps(record)
    runs = {}
    try:
        for label, extra in (("run", ["--epochs", "2"]), ("resume", ["--resume", "--epochs", "3"])):
            if on_card:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
            n_train, n_eval = len(record["train"]), len(record["eval"])
            lines, wall, launches, _ = _cli_main(["finetune-sam2", images, "--masks", masks, "-o", out, *FT_ARGS,
                                                  *extra, "--sam2-checkpoint", init, *dev_args])
            if on_card and (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32):
                raise AssertionError(f"finetune {label}: the trainer left TF32 on")
            runs[label] = dict(lines=lines, wall=wall, launches=launches, train=record["train"][n_train:],
                               eval=record["eval"][n_eval:])
    finally:
        restore()
    n_train_pairs = FT_PAIRS - round(0.2 * FT_PAIRS)
    want = {"run": (8, f"Finetuned 8 step(s) over {n_train_pairs} pair(s): loss "),
            "resume": (4, f"Finetuned 4 step(s) over {n_train_pairs} pair(s) (resumed at step 8): loss ")}
    for label, run in runs.items():
        steps, head = want[label]
        if not run["lines"][0].startswith(head) or not run["lines"][1].startswith("Validation (2 held-out pair(s))"):
            raise AssertionError(f"finetune {label} printed {run['lines']}")
        if len(run["train"]) != steps or len(run["eval"]) != (2 if label == "run" else 1):
            raise AssertionError(f"finetune {label}: {len(run['train'])} train steps, {len(run['eval'])} "
                                 "validation forwards")
        for s in run["train"]:
            if not np.isfinite(s["loss"]) or s["launches"] or s["grad_calls"] != n_attn:
                raise AssertionError(f"finetune {label} train step: {s}")
        for s in run["eval"]:
            if not np.isfinite(s["loss"]) or s["launches"] != n_launch or s["grad_calls"] \
                    or (on_card and s["variants"] != {"tf32x3": 9, "f32_win": 3}):
                raise AssertionError(f"finetune {label} validation forward: {s}")
        if run["launches"] != n_launch * len(run["eval"]):
            raise AssertionError(f"finetune {label}: {run['launches']} attention launches")
    ckpts = sorted(p.name for p in (out / "checkpoints").glob("step_*.npz"))
    if ckpts != ["step_00000004.npz", "step_00000008.npz", "step_00000012.npz"]:
        raise AssertionError(f"finetune checkpoints {ckpts}")

    # 2. only the norm tensors moved, every other one byte for byte init's
    with np.load(init) as a, np.load(out / "sam2_finetuned.npz") as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError("finetune: sam2_finetuned.npz keys differ from init.npz")
        moved = {k for k in a.files if a[k].tobytes() != b[k].tobytes()}
        norms = {k for k in a.files if any("norm" in n for n in k.split("/")[:-1])}
    if not moved or not moved <= norms:
        raise AssertionError(f"finetune: moved {sorted(moved - norms)[:5]} outside the norms, "
                             f"{len(moved)} of {len(norms)} norm tensors moved")

    # 3. detect-tissue with the fine-tuned archive over the held-out images, then evaluate-masks
    held = tmp / "held_out"
    held.mkdir()
    val_order = np.random.default_rng(0).permutation(FT_PAIRS)[: FT_PAIRS - n_train_pairs]
    pairs = collect_pairs(images, masks)
    held_pairs = [pairs[i] for i in val_order]
    for img, _ in held_pairs:
        (held / img.name).symlink_to(img)
    (tmp / "mpp.csv").write_text("wsi,mpp\n" + "".join(f"{img.name},2.0\n" for img, _ in held_pairs))
    lines, detect_wall, detect_launches, forwards = _cli_main(
        ["detect-tissue", held, "--output", tmp / "detect", "--mpp-csv", tmp / "mpp.csv",
         "--sam2-checkpoint", out / "sam2_finetuned.npz", *dev_args])
    variants = dict(A.flash_attention.variant_launches)
    if f"Created {len(held_pairs)} mask overlay(s), failures: 0" not in lines:
        raise AssertionError(f"finetune detect-tissue printed {lines}")
    if forwards != len(held_pairs) or detect_launches != n_launch * forwards \
            or (on_card and variants != {"tf32x3": 9 * forwards, "f32_win": 3 * forwards}):
        raise AssertionError(f"finetune detect-tissue: {detect_launches} launches {variants} in {forwards} forwards")
    lines, _, eval_launches, _ = _cli_main(["evaluate-masks", tmp / "detect" / "visualization", "--truth", masks,
                                           "--csv", tmp / "scores.csv"])
    with open(tmp / "scores.csv") as f:
        rows = list(csv.DictReader(f))
    held_stems = sorted(img.stem for img, _ in held_pairs)
    if [ln.split(":")[0] for ln in lines[: len(held_pairs)]] != held_stems or sorted(r["slide"] for r in rows) \
            != held_stems or eval_launches or not lines[len(held_pairs)].startswith("Mean over 2 slide(s)"):
        raise AssertionError(f"finetune evaluate-masks printed {lines}, CSV rows {rows}")

    # 4. one train step from init.npz on the card and on the CPU, the same batch
    loaded = [load_pair(img, mask, cfg.image_size) for img, mask in pairs[:2]]
    batch = np.stack([im for im, _ in loaded]), np.stack([mk for _, mk in loaded])
    card_model, card_loss, card_grads = _one_train_step(init, cfg, *batch, device)
    t0 = time.perf_counter()
    _, cpu_loss, cpu_grads = _one_train_step(init, cfg, *batch, "cpu")
    cpu_step_s = time.perf_counter() - t0

    def grad_rel(grads):
        return max(float(np.abs(grads[k] - g).max()) / max(float(np.abs(g).max()), 1e-30)
                   for k, g in cpu_grads.items())

    loss_rel, sound_rel = abs(card_loss - cpu_loss) / abs(cpu_loss), grad_rel(card_grads)
    if not (loss_rel <= 1e-4 and sound_rel <= FT_GRAD_BOUND):
        raise AssertionError(f"finetune card vs CPU: loss rel {loss_rel}, norm gradients {sound_rel} of their largest")
    control_rel = control_loss_rel = None
    if on_card:  # the control: the bound must catch a step that runs its products in TF32
        _, control_loss, control_grads = _one_train_step(init, cfg, *batch, device, tf32=True)
        control_rel, control_loss_rel = grad_rel(control_grads), abs(control_loss - cpu_loss) / abs(cpu_loss)
        if not control_rel > FT_GRAD_BOUND:
            raise AssertionError(f"finetune: a step in TF32 passes the gradient bound {FT_GRAD_BOUND}: {control_rel}")
        del control_grads

    # 5. the refusal, one profiled step and the eval forward's time
    step_busy_ms = eval_ms = None
    if on_card:
        q = torch.randn(1, 2, 64, 64, device=device, requires_grad=True)
        try:
            A.flash_attention(q, q, q)
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError("flash_attention took a CUDA input that requires grad")
        if "forward-only" not in refusal:
            raise AssertionError(f"flash_attention refused a CUDA input that requires grad for another reason: {refusal}")
        params = ft.trainable_parameters(card_model, "norms")
        optimizer, lr = ft.make_optimizer(params.values())
        step = ft.make_train_step(card_model, optimizer, lr)
        float(step(*batch))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            float(step(*batch))
        rows = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
        step_busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        if not step_busy_ms:
            raise AssertionError("the profiler recorded no device time in the train step")
        for e in rows[:10]:
            log(f"finetune profile {e.self_device_time_total / 1e3:8.3f} ms "
                f"{100 * e.self_device_time_total / 1e3 / step_busy_ms:5.1f}% x{e.count:<4d} {e.key[:100]}")
    else:
        refusal = "not checked off the card"
    train_ms = 1e3 * statistics.median(s["s"] for s in [*runs["run"]["train"][1:], *runs["resume"]["train"]])
    eval_ms = 1e3 * statistics.median(s["s"] for s in [*runs["run"]["eval"][1:], *runs["resume"]["eval"]])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    losses = [s["loss"] for r in runs.values() for s in r["train"]]
    state["finetune_launches"] = sum(r["launches"] for r in runs.values()) + detect_launches
    phase_s = time.perf_counter() - t_phase
    log(f"finetune corpus {FT_PAIRS} pairs of {size[0]}x{size[1]} + init.npz: {setup_s:.1f} s; "
        f"finetune-sam2 --epochs 2 {runs['run']['wall']:.3f} s: {runs['run']['lines'][0]} | "
        f"{runs['run']['lines'][1]}; --resume --epochs 3 {runs['resume']['wall']:.3f} s: {runs['resume']['lines'][0]}")
    log(f"finetune losses {[round(x, 4) for x in losses]} all finite; {len(moved)} of {len(norms)} norm tensors "
        f"moved, every other tensor byte-identical to init.npz; TF32 on before each run, off after")
    log(f"finetune launches: 0 in each of {len(losses)} train steps ({n_attn} plain autograd attention calls each), "
        f"{n_launch} in each of {len(runs['run']['eval']) + len(runs['resume']['eval'])} validation forwards "
        f"({runs['run']['eval'][0]['variants']}); detect-tissue {detect_launches} in {forwards} forwards {variants}")
    log(f"finetune detect-tissue + evaluate-masks over {len(held_pairs)} held-out pairs: {detect_wall:.3f} s; "
        + " | ".join(lines[: len(held_pairs) + 1]))
    log(f"finetune card vs CPU, one norms step at batch 2: loss {card_loss:.6f} vs {cpu_loss:.6f} (rel "
        f"{loss_rel:.3g} <= 1e-4); norm gradients max |diff| {sound_rel:.3g} of each tensor's largest "
        f"(bound {FT_GRAD_BOUND}); control, the same step with TF32 on: gradients {control_rel and f'{control_rel:.3g}'}, "
        f"loss rel {control_loss_rel and f'{control_loss_rel:.3g}'}; CPU step {cpu_step_s:.1f} s; refusal: {refusal}")
    log(f"finetune train step {train_ms:.1f} ms by host clock (median of {len(losses) - 1} after the first), "
        f"{2e3 / train_ms:.2f} images/s; device busy {step_busy_ms and round(step_busy_ms, 2)} ms per step "
        f"(torch.profiler); validation forward {eval_ms:.1f} ms (batch 2); peak memory {peak_gib:.2f} GiB; "
        f"phase {phase_s:.1f} s [{state.get('card', device)}]")
    state["finetune"] = dict(train_ms=train_ms, busy_ms=step_busy_ms, eval_ms=eval_ms, peak_gib=peak_gib,
                             phase_s=phase_s, loss_rel=loss_rel, grad_rel=sound_rel, control_rel=control_rel)


# The multi phase: the multi-device paths on the one card, named twice.
MULTI_CARD = ["cuda:0", "cuda:0"]
MULTI_BF16_AGREE = 0.995  # bf16 DP masks vs one device per thumbnail (tests/test_train_and_parallel.py:270)
MULTI_FT_PAIRS = 5  # 1024x768: 4 train (2 steps at batch 2), 1 held out at --val-fraction 0.2
MULTI_CLI_SLIDES = 4
MULTI_RANK_TIMEOUT = 300

MULTI_FT_WORKER = r"""
import json, sys
import torch.distributed as dist
from atlaspatch_tpu_torch.models.train import loop
from atlaspatch_tpu_torch.ops import attention as A
from atlaspatch_tpu_torch.parallel import multihost
images, masks, out, init, result = sys.argv[1:6]
if not multihost.maybe_init_distributed("cuda"):
    raise SystemExit("no process group")
backend, rank = dist.get_backend(), dist.get_rank()
losses = []
try:
    summary = loop.finetune_sam2(images, masks, out, epochs=1, batch_size=2, val_fraction=0.2, checkpoint=init,
                                 device="cuda", seed=0, on_step=lambda step, loss: losses.append(loss))
finally:
    multihost.shutdown_distributed()
with open(result, "w") as f:
    json.dump({"backend": backend, "rank": rank, "losses": losses, "val_loss": summary["val_loss"],
               "val_iou": summary["val_iou"], "launches": A.flash_attention.launches,
               "jax": any(m == "jax" or m.startswith(("jax.", "flax", "atlaspatch_tpu.")) for m in sys.modules)}, f)
"""

MULTI_CLI_WORKER = r"""
import sys
from atlaspatch_tpu_torch.cli import main
from atlaspatch_tpu_torch.ops import attention as A
main(sys.argv[1:], standalone_mode=False)
print("LAUNCHES", A.flash_attention.launches)
"""


def _rank_env(rank: int, port: int) -> dict:
    """torchrun's variables for one of two ranks on this machine; no
    ATLASPATCH_NUM_HOSTS, so the slides shard over the group."""
    env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONPATH=str(Path(__file__).resolve().parent))
    for var in ("ATLASPATCH_NUM_HOSTS", "ATLASPATCH_HOST_ID"):
        env.pop(var, None)
    return env


def _two_ranks(code: str, argv_of) -> list[tuple[int, str]]:
    """Two ranks of ``python -c code`` (argv_of(rank)), started together and
    each waited for with MULTI_RANK_TIMEOUT (killed past it): (rc, output)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", code, *map(str, argv_of(r))], env=_rank_env(r, port),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    done = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=MULTI_RANK_TIMEOUT)
            done.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out) in enumerate(done):
        if rc != 0:
            raise AssertionError(f"multi: rank {r} exited {rc}:\n{out[-3000:]}")
    return done


def _count_segment_forwards():
    """Wrap the SAM2 packed steps so each replica's forward is counted;
    returns (counter, restore)."""
    from atlaspatch_tpu_torch.models.sam2 import model as sam2_model

    steps = {name: getattr(sam2_model, name) for name in
             ("segment_step_packed_to_shape", "segment_step_packed_from_thumbs", "segment_step_packed")}
    forwards = Counter()

    def counting(step):
        def wrapped(model, batch, *a, **k):
            forwards[batch.shape[0]] += 1
            return step(model, batch, *a, **k)
        return wrapped

    for name, step in steps.items():
        setattr(sam2_model, name, counting(step))

    def restore():
        for name, step in steps.items():
            setattr(sam2_model, name, step)
    return forwards, restore


def _multi_kernel_checks(state):
    """(k0) The kernels against their plain versions at the shapes the
    data-parallel paths hand them that no earlier phase checks: the --fast
    trunk at 4 rows a replica (attention, bfloat16) and vit_l_16 int8 at 16
    patches a replica (M 3,152: the four linears at max-abs 0, the
    quantizer's three prologues at the int8 phase's bars)."""
    import torch

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.hiera import trunk_attention_shapes
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.ops import int8 as I

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(15)
    worst = 0.0
    for n, h, tq, tk, d in trunk_attention_shapes(SAM2Config.tiny(), 768, 4):
        q, k, v = (torch.randn(n, h, t, d, device="cuda", generator=gen).to(torch.bfloat16) for t in (tq, tk, tk))
        got = A.flash_attention(q, k, v, d**-0.5)
        want, limit = A.bf16_error_limit(q, k, v, d**-0.5)
        err = (got.float() - want).abs().max().item()
        ratio = ((got.float() - want).abs() / limit).max().item()
        if not (err <= TOL["bfloat16"] and ratio <= 1.0):
            raise AssertionError(f"multi: attention at {(n, h, tq, tk, d)} max abs {err}, err/limit {ratio}")
        worst = max(worst, err)
    m = 16 * 197
    i8_worst, share_worst = 0, 0.0
    for k_, prologue, operand in ((1024, "layernorm", None), (4096, "gelu_tanh", None), (1024, "identity", "heads")):
        args = _prologue_operands(m, k_, prologue, operand, "bfloat16", gen)
        if prologue == "layernorm":
            fused, plain = I.layernorm_quantize_rows, I.layernorm_quantize_rows_plain
        elif prologue == "identity":
            fused, plain = I.quantize_heads, lambda x: I.quantize_rows_plain(x.reshape(x.shape[0] * x.shape[1], -1))
        else:
            fused, plain = I.act_quantize_rows, I.act_quantize_rows_plain
        (xq, s_x), (want_xq, want_s) = fused(*args), plain(*args)
        diff = (xq.int() - want_xq.int()).abs()
        err, share = diff.max().item(), (diff > 0).float().mean().item()
        rel = ((s_x - want_s).abs() / want_s).max().item()
        ok = err == 0 and rel == 0 if prologue == "identity" else \
            err <= 1 and share <= FUSED_FLIP_SHARE and rel <= 2.0**-8
        if not ok:
            raise AssertionError(f"multi: quantize_rows_s8 {prologue} M={m}: |dxq| {err}, share {share}, s_x {rel}")
        share_worst = max(share_worst, share)
    for k_, n_ in INT8_VITL_LINEARS.values():
        xq, s_x = I.quantize_rows((torch.randn(m, k_, device="cuda", generator=gen) * 2).to(torch.bfloat16))
        w = torch.randint(-127, 128, (n_, k_), device="cuda", generator=gen, dtype=torch.int32).to(torch.int8)
        qs = torch.rand(n_, device="cuda", generator=gen) / 127 + 1e-4
        bias = torch.randn(n_, device="cuda", generator=gen)
        err = (I.int8_linear(xq, s_x, w, qs, bias, torch.bfloat16).float()
               - I.int8_linear_plain(xq, s_x, w, qs, bias, torch.bfloat16).float()).abs().max().item()
        if err != 0:
            raise AssertionError(f"multi: int8_linear_s8 at M={m} K={k_} N={n_} differs by {err}")
    torch.cuda.synchronize()
    log(f"multi (k0) kernels at the per-replica shapes: attention --fast at 4 rows, 12 calls, max abs {worst:.3g} "
        f"(<= {TOL['bfloat16']}, within bf16_error_limit); int8 at M={m}: the 4 linears max-abs 0, quantizer "
        f"prologues identity max-abs 0, layernorm/gelu_tanh flip share max {share_worst:.3e}; part "
        f"{time.perf_counter() - t0:.1f} s wall [{state['card']}]")


# Tensor-parallel int8 on the (1, 2) mesh: the row-parallel layers' shard rows at batch 32.
# vit_l_16 (197 tokens): proj's input 8 heads of 64 (K 512 a shard), fc2's 2,048 tanh-GELU units;
# dinov3_vit7b16 (201 tokens: cls, 4 registers): proj's 16 heads of 128 (2,048), fc2's 4,096 gated units.
TP_ROWS = {"vit_l_16": 32 * 197, "dinov3_vit7b16": 32 * 201}
TP_QUANT_CASES = [  # (model, layer, whole K, prologue, operand)
    ("vit_l_16", "proj", 1024, "identity", "heads"), ("vit_l_16", "fc2", 4096, "gelu_tanh", None),
    ("dinov3_vit7b16", "proj", 4096, "identity", "heads"), ("dinov3_vit7b16", "fc2", 8192, "gelu_tanh", "gated"),
    ("dinov3_vit7b16", "fc2", 8192, "silu", "gated"),
]
TP_LINEAR_CASES = [  # (model, layer, whole K, N)
    ("vit_l_16", "proj", 1024, 1024), ("vit_l_16", "fc2", 4096, 1024),
    ("dinov3_vit7b16", "proj", 4096, 4096), ("dinov3_vit7b16", "fc2", 8192, 4096),
]
# the (1, 2) shards whose K is no multiple of 16, at batch 32: (model, whole K, N, M): medsiglip's fc2
# (1,024 tokens, K 2,152 a shard) and virchow_v2's (261 tokens, K 1,708 a shard)
TP_RAGGED_CASES = [("medsiglip", 4304, 1152, 32 * 1024), ("virchow_v2", 3416, 1280, 32 * 261)]
# the new launches in one TP (1, 2) int8 forward: per block and shard an amax-only and a given-amax
# quantizer before proj (identity) and before fc2 (the amax-only storing the activation's values, the
# given-amax quantizing them by the identity prologue), on the streamed body, and their int32
# partials on the wgmma body; per block one dequant_sum_s32 for each; the layernorm quantizers
# (one-pass, the template) and the column-parallel linears (qkv and fc1, or fc_gate and fc_up, on
# each shard, wgmma, bfloat16) as on one device
def _tp_launches(blocks: int, act: str, linears: int) -> dict:
    return {"prologue": {"layernorm": 2 * blocks, "identity": 6 * blocks, act: 2 * blocks},
            "mode": {"one_pass": 2 * blocks, "amax_only": 4 * blocks, "given_amax": 4 * blocks},
            "body": {"template": 2 * blocks, "stream": 8 * blocks}, "variant": {"wgmma": 2 * linears * blocks},
            "out": {"bfloat16": 2 * (linears - 2) * blocks, "int32": 4 * blocks}, "dequant_sum": 2 * blocks}
TP_INT8_REPLACES = {"amax_only": "atlaspatch_tpu/models/encoders/vit.py:143",
                    "given_amax": "atlaspatch_tpu/models/encoders/vit.py:143",
                    "int32": "atlaspatch_tpu/models/encoders/vit.py:146",
                    "dequant_sum_s32": "atlaspatch_tpu/models/encoders/vit.py:152"}


def _tp_heads(m, k, dtype, gen):
    """The attention's whole (B, T, H, D) output of a TP case (stored (B, H, T, D), as the einsum
    leaves it) and its two shards' heads."""
    import torch

    b, t = (m // 197, 197) if k == 1024 else (m // 201, 201)
    h, d = (16, 64) if k == 1024 else (32, 128)
    attn = torch.softmax(torch.randn(b, h, t, t, device="cuda", generator=gen) * 3, dim=-1).to(dtype)
    v = torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
    whole = torch.einsum("bhqk,bkhd->bqhd", attn, v)
    return whole, [whole[:, :, : h // 2], whole[:, :, h // 2:]]


def _tp_int8_kernel_rows(state) -> dict:
    """(k0) tensor-parallel int8's kernels at the (1, 2) mesh's shard shapes: quantize_rows_s8's
    amax-only mode against its plain version (identity max-abs 0, the activations within 2^-8), the
    shards' amaxes maxed equal to the whole row's, given-amax on each shard with them equal to the
    one-pass kernel's columns and scale (max-abs 0) and to the plain version (identity max-abs 0, the
    activations at the int8 phase's bars); both modes on their streamed body (routed) against the
    template's modes (forced) on each shard, and an activation's amax-only that stores its values with
    those values quantized by the identity prologue, max-abs 0; int8_linear_s8's int32 output
    (routed: wgmma; the mma body and both wgmma widths, forced) against int_product and
    dequant_sum_s32 of the two shards' partials against int8_linear_s8 on the whole K, max-abs 0.
    Device ms of each quantizer call on a shard at every case (the streamed body, the template's mode
    in the same run, the stored-activation pair, the one-pass kernel over the shard, the plain
    version, torch.linalg.vector_norm for the identity amax-only, the byte bounds) and of the int32
    products and dequant_sum_s32 at vit_l_16's shapes, beside bound, plain, torch._int_mm and the
    mma body."""
    import torch

    from atlaspatch_tpu_torch.ops import int8 as I

    gen = torch.Generator(device="cuda").manual_seed(16)
    rows, worst = {}, {"amax_abs": 0.0, "given_abs": 0, "flip_share": 0.0}
    for model, layer, k, prologue, operand in TP_QUANT_CASES:
        m = TP_ROWS[model]
        # routed_amax(part): (amax, what given-amax then quantizes) as the forward routes a shard
        if operand == "heads":
            whole, halves = _tp_heads(m, k, torch.bfloat16, gen)
            args, parts = (whole,), [(h,) for h in halves]
            quantize = I.quantize_heads

            def routed_amax(part):
                return I.heads_amax(*part), part

            def routed_given(src, amax):
                return I.quantize_heads(*src, amax)

            def values(x):
                return x.reshape(x.shape[0] * x.shape[1], -1)

            def forced(x, mode, body, amax=None):
                x, layout, r, c = I._heads_layout("heads", x)
                return I._launch_quantize("identity", x, layout, rows=r, cols=c, mode=mode, amax=amax, body=body)

            def library(x):
                return torch.linalg.vector_norm(x, float("inf"), dim=(-2, -1), dtype=torch.float32)
        else:
            a = (torch.randn(m, k, device="cuda", generator=gen) * 2).to(torch.bfloat16)
            b = (torch.randn(m, k, device="cuda", generator=gen) * 2).to(torch.bfloat16) if operand else None
            args = (a, prologue, b)
            parts = [(a[:, c].contiguous(), prologue, None if b is None else b[:, c].contiguous())
                     for c in (slice(0, k // 2), slice(k // 2, k))]
            quantize, library = I.act_quantize_rows, None

            def routed_amax(part):  # amax-only stores the activation's values
                amax, stored = I.act_row_amax(*part)
                return amax, (stored,)

            def routed_given(src, amax):  # the identity prologue over the stored values
                return I.quantize_rows(*src, amax)

            def values(x, act, y=None):
                return I._act_rows(x, act, y)

            def forced(x, act, y, mode, body, amax=None):
                return I._launch_quantize(act, x, (0, x.stride(0), x.shape[0], 0, x.shape[1]), b=y, mode=mode,
                                          amax=amax, body=body)
        I.reset_launch_counts()
        one_xq, one_s = quantize(*args)
        routed = [routed_amax(part) for part in parts]
        amaxes = [amax for amax, _ in routed]
        maxed = torch.maximum(*amaxes)
        given = [routed_given(src, maxed) for _, src in routed]
        torch.cuda.synchronize()
        if dict(I.quantize_rows.mode_launches) != {"one_pass": 1, "amax_only": 2, "given_amax": 2} \
                or dict(I.quantize_rows.body_launches) != {"template": 1, "stream": 4}:
            raise AssertionError(f"multi tp {model} {layer}: quantizer modes {dict(I.quantize_rows.mode_launches)}, "
                                 f"bodies {dict(I.quantize_rows.body_launches)}")
        plain_amax = [I.row_amax_plain(values(*part)) for part in parts]
        amax_rel = max(((x - want).abs() / want.clamp_min(1e-30)).max().item() for x, want in zip(amaxes, plain_amax))
        amax_abs = max((x - want).abs().max().item() for x, want in zip(amaxes, plain_amax))
        exact = (torch.equal(I._divide(maxed.clamp_min(1e-8), 127.0), one_s)
                 and torch.equal(torch.cat([q for q, _ in given], dim=1), one_xq)
                 and all(torch.equal(s_x, one_s) for _, s_x in given))
        # the streamed bodies against the template's modes (an activation's computing it in both)
        body_err = 0.0
        for part, amax, (q, s_x) in zip(parts, amaxes, given):
            t_amax = forced(*part, "amax_only", "template")
            t_q, t_s = forced(*part, "given_amax", "template", maxed)
            body_err = max(body_err, (amax - t_amax).abs().max().item(), (q.int() - t_q.int()).abs().max().item(),
                           (s_x - t_s).abs().max().item())
        plain_given = [I.quantize_rows_plain(values(*part), maxed) for part in parts]
        diff = torch.cat([(q.int() - pq.int()).abs() for (q, _), (pq, _) in zip(given, plain_given)], dim=1)
        share = (diff > 0).float().mean().item()
        ok = (amax_rel == 0 and diff.max().item() == 0) if prologue == "identity" else \
            (amax_rel <= 2.0**-8 and diff.max().item() <= 1 and share <= FUSED_FLIP_SHARE)
        if not (exact and ok and body_err == 0):
            raise AssertionError(f"multi tp {model} {layer} {prologue} M={m} K={k}: shards equal the one-pass "
                                 f"kernel {exact}; streamed bodies vs the template's modes max-abs {body_err}; amax "
                                 f"rel {amax_rel}, given vs plain |dxq| {diff.max().item()} share {share}")
        worst = {"amax_abs": max(worst["amax_abs"], amax_abs), "given_abs": max(worst["given_abs"], diff.max().item()),
                 "flip_share": max(worst["flip_share"], share)}
        (part, (_, src)), kk = (parts[0], routed[0]), k // 2
        n_in = 1 if operand != "gated" else 2  # bfloat16 operands read a value
        again = 2 * n_in if prologue == "identity" else 4  # the shard read again, or the values stored and read

        def median_ms(fn, kernel):  # one window can misread a short kernel: the median of three, L2 cold
            return sorted(device_ms(fn, kernel=kernel, reps=50, cold=True) for _ in range(3))[1]

        # bounds: amax-only, the function it replaces (the shard read once, 4 bytes a row written);
        # given-amax, what it reads on the route (the heads or the stored values, 2 bytes an element)
        # read once and xq and the scales written; the pair, the function both replace (the shard read
        # twice, xq written once: no route moves less). moved: what the routed pair moves (an
        # activation's stored values written once and read once in place of the shard's second read)
        row = dict(
            amax_rel=amax_rel, share=share,
            amax_ms=median_ms(lambda: routed_amax(part), "quantize_stream_amax"),
            amax_template_ms=median_ms(lambda: forced(*part, "amax_only", "template"), "quantize_rows_s8"),
            given_ms=median_ms(lambda: routed_given(src, maxed), "quantize_stream_given"),
            given_template_ms=median_ms(lambda: forced(*part, "given_amax", "template", maxed), "quantize_rows_s8"),
            one_pass_ms=median_ms(lambda: quantize(*part), "quantize_rows_s8"),
            amax_plain_ms=cuda_ms(lambda: I.row_amax_plain(values(*part)), max_reps=10),
            given_plain_ms=cuda_ms(lambda: I.quantize_rows_plain(values(*part), maxed), max_reps=10),
            amax_bound_ms=1e3 * (2 * n_in * m * kk + 4 * m) / H100_BYTES_PER_S,
            given_bound_ms=1e3 * (3 * m * kk + 8 * m) / H100_BYTES_PER_S,
            pair_bound_ms=1e3 * ((4 * n_in + 1) * m * kk + 12 * m) / H100_BYTES_PER_S,
            pair_moved_ms=1e3 * ((2 * n_in + again + 1) * m * kk + 12 * m) / H100_BYTES_PER_S,
            library_ms=None if library is None else median_ms(lambda: library(*part), None))
        row["pair_ms"] = row["amax_ms"] + row["given_ms"]
        row["pair_template_ms"] = row["amax_template_ms"] + row["given_template_ms"]
        rows[(model, layer, prologue)] = row
        lib_s = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(f"multi (k0) tp int8 quantize_rows_s8 {model} {layer} {prologue}{' * b' if operand == 'gated' else ''} "
            f"M={m} K={k} over 2 shards: amax-only vs plain rel {amax_rel:.3e}, maxed = the whole row's, given-amax "
            f"shards = the one-pass kernel (max-abs 0), streamed bodies = the template's modes (max-abs 0), vs "
            f"plain flip share {share:.3e}; a shard's call dev_ms, L2 cold: amax-only"
            f"{'' if prologue == 'identity' else ' storing the values'} {row['amax_ms']:.4f} "
            f"({100 * row['amax_bound_ms'] / row['amax_ms']:.1f}% of bound {row['amax_bound_ms']:.4f}; template "
            f"{row['amax_template_ms']:.4f}; plain {row['amax_plain_ms']:.4f}; vector_norm {lib_s}), given-amax"
            f"{'' if prologue == 'identity' else ' (identity, over them)'} {row['given_ms']:.4f} "
            f"({100 * row['given_bound_ms'] / row['given_ms']:.1f}% of bound {row['given_bound_ms']:.4f}; template "
            f"{row['given_template_ms']:.4f}; the one-pass kernel on the shard {row['one_pass_ms']:.4f}; plain "
            f"{row['given_plain_ms']:.4f}); the pair {row['pair_ms']:.4f} "
            f"({100 * row['pair_bound_ms'] / row['pair_ms']:.1f}% of bound {row['pair_bound_ms']:.4f}; the bytes it moves {row['pair_moved_ms']:.4f}; template "
            f"{row['pair_template_ms']:.4f}) [{state['card']}]")
        del args, parts, routed, src, given, plain_given, one_xq
    linear_err = 0
    for model, layer, k, n in TP_LINEAR_CASES:
        m = TP_ROWS[model]
        xq, s_x = I.quantize_rows((torch.randn(m, k, device="cuda", generator=gen) * 2).to(torch.bfloat16))
        w = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int32).to(torch.int8)
        qscale = (torch.rand(n, device="cuda", generator=gen) + 0.5) / 127.0
        bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
        halves = [(xq[:, c].contiguous(), w[:, c].contiguous()) for c in (slice(0, k // 2), slice(k // 2, k))]
        I.reset_launch_counts()
        partials = [I.int8_linear_s32(a, b) for a, b in halves]
        got = I.dequant_sum(partials, s_x, qscale, bias, torch.bfloat16)
        torch.cuda.synchronize()
        if dict(I.int8_linear.variant_launches) != {"wgmma": 2} or dict(I.int8_linear.out_launches) != {"int32": 2} \
                or I.dequant_sum.launches != 1:
            raise AssertionError(f"multi tp {model} {layer}: {dict(I.int8_linear.variant_launches)} by body, "
                                 f"{dict(I.int8_linear.out_launches)} by output, {I.dequant_sum.launches} dequant_sum")
        want = I.int8_linear(xq, s_x, w, qscale, bias, torch.bfloat16)
        forced = [[I._launch_linear(v, a, None, b, None, None, torch.int32, bn) for a, b in halves]
                  for v, bn in [("mma", None)] + [("wgmma", bn) for bn in I.WGMMA_BLOCK_NS]]
        s32_err = max((p.long() - I.int8_linear_s32_plain(a, b).long()).abs().max().item()
                      for ps in (partials, *forced) for p, (a, b) in zip(ps, halves))
        sum_err = max((got.float() - want.float()).abs().max().item(),
                      (got.float() - I.dequant_sum_plain(partials, s_x, qscale, bias, torch.bfloat16).float())
                      .abs().max().item())
        if s32_err != 0 or sum_err != 0:
            raise AssertionError(f"multi tp {model} {layer} M={m} K={k} N={n}: int32 partials vs int_product "
                                 f"{s32_err}, dequant_sum vs int8_linear_s8 on the whole K {sum_err}")
        linear_err = max(linear_err, s32_err, sum_err)
        row = {}
        if model == "vit_l_16":
            a, b = halves[0]
            kk = k // 2
            row = dict(s32_ms=device_ms(lambda: I.int8_linear_s32(a, b), kernel="int8_linear_s8"),
                       s32_mma_ms=device_ms(lambda: I._launch_linear("mma", a, None, b, None, None, torch.int32),
                                            kernel="int8_linear_s8"),
                       s32_plain_ms=cuda_ms(lambda: I.int8_linear_s32_plain(a, b), max_reps=5),
                       int_mm_ms=device_ms(lambda: torch._int_mm(a, b.t()), kernel=None),
                       s32_op_ms=1e3 * 2.0 * m * n * kk / H100_INT8_OPS,
                       s32_byte_ms=1e3 * (m * kk + n * kk + 4 * m * n) / H100_BYTES_PER_S,
                       sum_ms=device_ms(lambda: I.dequant_sum(partials, s_x, qscale, bias, torch.bfloat16),
                                        kernel="dequant_sum_s32"),
                       sum_plain_ms=cuda_ms(lambda: I.dequant_sum_plain(partials, s_x, qscale, bias, torch.bfloat16),
                                            max_reps=10),
                       sum_bound_ms=1e3 * (2 * 4 * m * n + 4 * m + 4 * n + 2 * n + 2 * m * n) / H100_BYTES_PER_S)
        rows[(model, layer, "linear")] = row
        bound = max(row["s32_op_ms"], row["s32_byte_ms"]) if row else 0.0
        log(f"multi (k0) tp int8 {model} {layer} M={m} K={k}={k // 2}+{k // 2} N={n}: int8_linear_s8 int32 (wgmma/"
            f"{I.wgmma_block_n(m, n, I._sm_count(0), torch.int32, k // 2)}; mma and both wgmma widths forced) vs "
            f"int_product max-abs 0, dequant_sum_s32 of the 2 partials vs int8_linear_s8 (wgmma) "
            f"on the whole K max-abs 0" + ("" if not row else
                                          f"; a shard's int32 product dev_ms wgmma {row['s32_ms']:.4f} "
                                          f"({100 * bound / row['s32_ms']:.1f}% of bound {bound:.4f}), mma "
                                          f"{row['s32_mma_ms']:.4f} ({100 * bound / row['s32_mma_ms']:.1f}%), _int_mm "
                                          f"{row['int_mm_ms']:.4f} ({100 * bound / row['int_mm_ms']:.1f}%), plain "
                                          f"{row['s32_plain_ms']:.4f}; dequant_sum_s32 {row['sum_ms']:.4f} (bound "
                                          f"{row['sum_bound_ms']:.4f}, plain {row['sum_plain_ms']:.4f})")
            + f" [{state['card']}]")
        del xq, w, halves, partials, forced, got, want
    torch.cuda.empty_cache()
    rows["ragged"], ragged_err = _tp_ragged_rows(state, gen)
    return {"rows": rows, "worst": worst, "linear_err": max(linear_err, ragged_err)}


def _tp_ragged_rows(state, gen) -> tuple[dict, int]:
    """(k0) the int32 partials of the TP_RAGGED_CASES shards, whose K is no
    multiple of 16: each shard's xq and weight at the 16-byte row pitch (pad
    bytes PAD_BYTE), as the quantizer and shard_vit leave them, routed to
    the wgmma body; it and the mma body (over the pitched rows, and over
    packed ones: the route before the pitch), forced, equal int_product, and
    dequant_sum_s32 of the two partials equals int8_linear_s8 on the whole K,
    max-abs 0. A shard's device ms per body, bound, plain and torch._int_mm
    (packed rows; it takes K a multiple of 8 only: not 1,708). Returns the
    rows and the largest error."""
    import torch

    from atlaspatch_tpu_torch.ops import int8 as I

    rows, worst = {}, 0
    for model, k, n, m in TP_RAGGED_CASES:
        kk = k // 2
        xq, s_x = I.quantize_rows((torch.randn(m, k, device="cuda", generator=gen) * 2).to(torch.bfloat16))
        w = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int32).to(torch.int8)
        qscale = (torch.rand(n, device="cuda", generator=gen) + 0.5) / 127.0
        bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
        halves = [(I.pitched(xq[:, c]), I.pitched(w[:, c])) for c in (slice(0, kk), slice(kk, k))]
        for a, b in halves:
            if not a.stride(0) == b.stride(0) == I.pitch16(kk):
                raise AssertionError(f"multi tp {model} fc2: shard rows {a.stride(0)}, {b.stride(0)} bytes apart")
            _fill_pad(a)
            _fill_pad(b)
        packed = [(a.contiguous(), b.contiguous()) for a, b in halves]
        I.reset_launch_counts()
        partials = [I.int8_linear_s32(a, b) for a, b in halves]
        got = I.dequant_sum(partials, s_x, qscale, bias, torch.bfloat16)
        torch.cuda.synchronize()
        launches = dict(I.int8_linear.variant_launches)
        want = I.int8_linear(xq, s_x, w, qscale, bias, torch.bfloat16)
        forced = {"mma": [I._launch_linear("mma", a, None, b, None, None, torch.int32) for a, b in halves],
                  "mma packed": [I._launch_linear("mma", a, None, b, None, None, torch.int32) for a, b in packed],
                  **{f"wgmma/{bn}": [I._launch_linear("wgmma", a, None, b, None, None, torch.int32, bn)
                                     for a, b in halves] for bn in I.WGMMA_BLOCK_NS}}
        s32_err = max((p.long() - I.int8_linear_s32_plain(a, b).long()).abs().max().item()
                      for ps in (partials, *forced.values()) for p, (a, b) in zip(ps, packed))
        sum_err = (got.float() - want.float()).abs().max().item()
        if launches != {"wgmma": 2} or s32_err != 0 or sum_err != 0:
            raise AssertionError(f"multi tp {model} fc2 M={m} K={k}={kk}+{kk} N={n}: int32 partials by body "
                                 f"{launches} (want wgmma), vs int_product max-abs {s32_err}, dequant_sum vs "
                                 f"int8_linear_s8 on the whole K {sum_err}")
        worst = max(worst, s32_err, sum_err)
        a, b = halves[0]
        pa, pb = packed[0]
        row = dict(ms=device_ms(lambda: I.int8_linear_s32(a, b), kernel="int8_linear_s8"),
                   mma_ms=device_ms(lambda: I._launch_linear("mma", a, None, b, None, None, torch.int32),
                                    kernel="int8_linear_s8"),
                   packed_mma_ms=device_ms(lambda: I._launch_linear("mma", pa, None, pb, None, None, torch.int32),
                                           kernel="int8_linear_s8"),
                   plain_ms=cuda_ms(lambda: I.int8_linear_s32_plain(a, b), max_reps=5),
                   int_mm_ms=device_ms(lambda: torch._int_mm(pa, pb.t()), kernel=None) if kk % 8 == 0 else None,
                   op_ms=1e3 * 2.0 * m * n * kk / H100_INT8_OPS,
                   byte_ms=1e3 * (m * kk + n * kk + 4 * m * n) / H100_BYTES_PER_S,
                   block_n=I.wgmma_block_n(m, n, I._sm_count(0), torch.int32, kk))
        rows[model] = row
        bound = max(row["op_ms"], row["byte_ms"])
        int_mm = "none (K no multiple of 8)" if row["int_mm_ms"] is None else \
            f"{row['int_mm_ms']:.4f} ({100 * bound / row['int_mm_ms']:.1f}%)"
        log(f"multi (k0) tp int8 {model} fc2 M={m} K={k}={kk}+{kk} N={n}: the shards' xq and weights at the 16-byte "
            f"pitch ({I.pitch16(kk)} bytes a row, pad bytes 0x7f), int32 partials on wgmma/{row['block_n']}; every "
            f"body (mma over pitched and packed rows, wgmma at both widths, forced) vs int_product max-abs 0, "
            f"dequant_sum_s32 of the 2 partials vs int8_linear_s8 on the whole K max-abs 0; a shard's int32 product "
            f"dev_ms wgmma {row['ms']:.4f} ({100 * bound / row['ms']:.1f}% of bound {bound:.4f}, "
            f"{'operations' if row['op_ms'] >= row['byte_ms'] else 'bytes'}), mma over the pitched rows "
            f"{row['mma_ms']:.4f}, over packed rows (the route before) {row['packed_mma_ms']:.4f}, _int_mm {int_mm}, "
            f"plain {row['plain_ms']:.4f} [{state['card']}]")
        del xq, w, halves, packed, partials, forced, got, want
    torch.cuda.empty_cache()
    return rows, worst


def _tp_int8_records(tp, launches) -> list[dict]:
    """The new modes' and kernels' records over one vit_l_16 TP (1, 2) int8 forward at batch 32 (24
    blocks, 2 shards): ms, bound and plain ms summed over its calls (per block and shard one amax-only
    and one given-amax before proj and before fc2, two int32 partials; per block two dequant_sum_s32),
    the quantizers' template modes on the same shards as before_ms (their body before the streamed
    ones), the int32 partials' mma body as mma_ms (their body before the wgmma one), launches from
    (k2)'s run. fc2's amax-only also stores tanh GELU's values and its given-amax runs the identity
    prologue over them, as the forward routes them, while the template computes the activation in
    both: so amax-only's bound is that of the function it replaces (the shard read once, 4 bytes a
    row written), given-amax's the bytes it must move on the route (the heads or the stored values
    read once, xq and the scales written), and the amax-only record also carries the pair, both
    modes, against the bound of the function both replace (the shard read twice, xq written once:
    pair_ms, pair_before_ms, pair_bound_ms). The amax-only's library call
    (torch.linalg.vector_norm, inf) computes proj's calls only: proj_library_ms beside proj_ms."""
    r = tp["rows"]
    proj, fc2 = r[("vit_l_16", "proj", "identity")], r[("vit_l_16", "fc2", "gelu_tanh")]
    lp, lf = r[("vit_l_16", "proj", "linear")], r[("vit_l_16", "fc2", "linear")]
    calls = 24 * 2
    s32_op = calls * (lp["s32_op_ms"] + lf["s32_op_ms"])
    s32_byte = calls * (lp["s32_byte_ms"] + lf["s32_byte_ms"])
    base = {"route": "cuda", "source": INT8_SOURCE}
    return [
        {**base, "name": "quantize_rows_s8:amax_only", "replaces": TP_INT8_REPLACES["amax_only"],
         "launches": launches["mode"]["amax_only"], "max_abs_err": tp["worst"]["amax_abs"],
         "ms": calls * (proj["amax_ms"] + fc2["amax_ms"]),
         "before_ms": calls * (proj["amax_template_ms"] + fc2["amax_template_ms"]),
         "plain_ms": calls * (proj["amax_plain_ms"] + fc2["amax_plain_ms"]),
         "bound_ms": calls * (proj["amax_bound_ms"] + fc2["amax_bound_ms"]), "bound_by": "bytes",
         "library_ms": None, "proj_ms": calls * proj["amax_ms"], "proj_library_ms": calls * proj["library_ms"],
         "pair_ms": calls * (proj["pair_ms"] + fc2["pair_ms"]),
         "pair_before_ms": calls * (proj["pair_template_ms"] + fc2["pair_template_ms"]),
         "pair_bound_ms": calls * (proj["pair_bound_ms"] + fc2["pair_bound_ms"])},
        {**base, "name": "quantize_rows_s8:given_amax", "replaces": TP_INT8_REPLACES["given_amax"],
         "launches": launches["mode"]["given_amax"], "max_abs_err": tp["worst"]["given_abs"],
         "flip_share": tp["worst"]["flip_share"],
         "ms": calls * (proj["given_ms"] + fc2["given_ms"]),
         "before_ms": calls * (proj["given_template_ms"] + fc2["given_template_ms"]),
         "plain_ms": calls * (proj["given_plain_ms"] + fc2["given_plain_ms"]),
         "bound_ms": calls * (proj["given_bound_ms"] + fc2["given_bound_ms"]), "bound_by": "bytes",
         "library_ms": None},
        {**base, "name": "int8_linear_s8:int32", "source": INT8_LINEAR_SOURCES[0],
         "replaces": TP_INT8_REPLACES["int32"],
         "launches": launches["out"]["int32"], "max_abs_err": tp["linear_err"],
         "ms": calls * (lp["s32_ms"] + lf["s32_ms"]), "mma_ms": calls * (lp["s32_mma_ms"] + lf["s32_mma_ms"]),
         "plain_ms": calls * (lp["s32_plain_ms"] + lf["s32_plain_ms"]),
         "bound_ms": max(s32_op, s32_byte), "bound_by": "operations" if s32_op >= s32_byte else "bytes",
         "library_ms": calls * (lp["int_mm_ms"] + lf["int_mm_ms"]),
         "ragged": {f"{model} fc2 shard": {key: row[key] for key in ("ms", "mma_ms", "packed_mma_ms", "int_mm_ms",
                                                                      "plain_ms")}
                    | {"bound_ms": max(row["op_ms"], row["byte_ms"])} for model, row in r["ragged"].items()}},
        {**base, "name": "dequant_sum_s32", "replaces": TP_INT8_REPLACES["dequant_sum_s32"],
         "launches": launches["dequant_sum"], "max_abs_err": tp["linear_err"],
         "ms": 24 * (lp["sum_ms"] + lf["sum_ms"]), "plain_ms": 24 * (lp["sum_plain_ms"] + lf["sum_plain_ms"]),
         "bound_ms": 24 * (lp["sum_bound_ms"] + lf["sum_bound_ms"]), "bound_by": "bytes", "library_ms": None},
    ]


def _multi_seg(state, mesh) -> int:
    """(k1) SAM2SegmentationService on the data-parallel mesh at full
    Hiera-tiny width (random weights): the --fast preset on the seg phase's
    16 thumbnails, float32 at 1024 on 2 thumbnails of one shape; masks
    against one device's; 12 launches per replica forward, by variant."""
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.core.config import SegmentationConfig
    from atlaspatch_tpu_torch.models.sam2.hiera import trunk_attention_shapes
    from atlaspatch_tpu_torch.models.sam2.model import pil_nearest_index, thumbs_to_logits
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.services.segmentation import SAM2SegmentationService

    settings = (("--fast bf16 768 batch 8", dict(precision="bfloat16", input_size=768, batch_size=8),
                 _thumbnails([(256, 192), (224, 160)], per_shape=8), 4),
                ("f32 1024 batch 2", dict(precision="float32", batch_size=2),
                 _thumbnails([(256, 192)], per_shape=2, seed0=100), 1))
    launches = 0
    for label, kw, thumbs, per_replica in settings:
        one = SAM2SegmentationService(SegmentationConfig(device="cuda", **kw))
        if kw["precision"] == "float32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        dp = SAM2SegmentationService(SegmentationConfig(device="cuda", **kw), mesh=mesh)
        if torch.backends.cuda.matmul.allow_tf32 and kw["precision"] == "float32":
            raise AssertionError("multi: the float32 data-parallel segmenter left TF32 on")
        replicas = dp.predictor._replicas.replicas
        dtype = getattr(torch, kw["precision"])
        if len(replicas) != 2 or replicas[0] is replicas[1] or not all(
                p.dtype == dtype and p.is_cuda for r in replicas for p in r.parameters()):
            raise AssertionError(f"multi {label}: replicas {len(replicas)}, not all {dtype} on the card")
        _run_service(one, thumbs)  # warm-up (cuDNN plans, allocator)
        _run_service(dp, thumbs)
        want, one_wall = _run_service(one, thumbs)
        forwards, restore = _count_segment_forwards()
        A.reset_launch_counts()
        try:
            got, wall = _run_service(dp, thumbs)
        finally:
            restore()
        n_fwd, part_launches = sum(forwards.values()), A.flash_attention.launches
        variants = dict(A.flash_attention.variant_launches)
        cfg = one.predictor.model.cfg
        expect = Counter()
        for _, _, tq, tk, d in trunk_attention_shapes(cfg, one.predictor.input_size, per_replica):
            expect[A.kernel_variant(dtype, tq, tk, d)] += n_fwd
        if part_launches != 12 * n_fwd or variants != dict(expect) or set(forwards) != {per_replica}:
            raise AssertionError(f"multi {label}: {part_launches} launches {variants} in replica "
                                 f"forwards {dict(forwards)}, want 12 each, {dict(expect)}")
        launches += part_launches
        agree = []
        for g, w, t in zip(got, want, thumbs):
            if g.data.shape != w.data.shape:
                raise AssertionError(f"multi {label}: mask shapes {g.data.shape} vs {w.data.shape}")
            if kw["precision"] == "float32":
                S = one.predictor.input_size
                logits = thumbs_to_logits(one.predictor.model, torch.from_numpy(t)[None].cuda())[0].cpu().numpy()
                small = logits[pil_nearest_index(t.shape[0], S)][:, pil_nearest_index(t.shape[1], S)]
                if ((g.data != w.data) & (np.abs(small - one.cfg.mask_threshold) >= 1e-4)).any():
                    raise AssertionError(f"multi {label}: mask bits differ away from the threshold")
            agree.append(float((g.data == w.data).mean()))
        if min(agree) < MULTI_BF16_AGREE:
            raise AssertionError(f"multi {label}: masks agree {min(agree)} with one device")
        log(f"multi (k1) segmentation data-parallel on {MULTI_CARD} {label}: {len(thumbs)} thumbnails in "
            f"{wall:.3f} s wall ({len(thumbs) / wall:.2f}/s; one device {one_wall:.3f} s, "
            f"{len(thumbs) / one_wall:.2f}/s, same run), {n_fwd} replica forwards of {per_replica} rows, "
            f"{part_launches} attention launches (12 each) {variants}; masks vs one device: agreement "
            f"min {min(agree):.6f}" + (" (float32: bits differ only within 1e-4 of the threshold)"
                                        if kw["precision"] == "float32" else f" (>= {MULTI_BF16_AGREE})")
            + f" [{state['card']}]")
        one.close()
        dp.close()
    torch.cuda.empty_cache()
    return launches


def _multi_embed(state) -> tuple[int, int]:
    """(k2) vit_l_16 on a (2, 1) data-parallel and a (1, 2) tensor-parallel
    mesh over the card against one device: float32 at depth 2 (TF32 on
    before the build), bfloat16 at full depth, int8 data-parallel at batch
    32. Returns the int8 kernels' launches in the data-parallel run."""
    import dataclasses

    import numpy as np
    import torch

    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor, init_random_weights_
    from atlaspatch_tpu_torch.models.encoders.vit import RowParallel, ViT
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
    from atlaspatch_tpu_torch.ops import int8 as I
    from atlaspatch_tpu_torch.parallel.mesh import embedding_mesh

    entry = ENTRIES["vit_l_16"]
    meshes = {"dp (2, 1)": (embedding_mesh(1, MULTI_CARD), False), "tp (1, 2)": (embedding_mesh(2, MULTI_CARD), True)}
    rng = np.random.default_rng(3)
    patches = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(32)]
    t0 = time.perf_counter()
    shallow = init_random_weights_(ViT(dataclasses.replace(entry.spec, depth=2)), seed=0)
    one = TorchFeatureExtractor(name="vit_l_16", embedding_dim=1024, spec=entry.preprocess,
                                model=copy.deepcopy(shallow), device="cuda").extract_batch(patches, batch_size=32)
    f32 = {}
    for label, (mesh, tp) in meshes.items():
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        ext = TorchFeatureExtractor(name="vit_l_16", embedding_dim=1024, spec=entry.preprocess,
                                    model=copy.deepcopy(shallow), mesh=mesh, tensor_parallel=tp)
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            raise AssertionError(f"multi {label}: the float32 extractor left TF32 on")
        if tp != isinstance(ext.replicas[0].blocks[0].attn, RowParallel):
            raise AssertionError(f"multi {label}: replicas {ext.replicas[0].blocks[0].attn}")
        f32[label] = float(np.abs(ext.extract_batch(patches, batch_size=32) - one).max())
        if not f32[label] <= 1e-4:
            raise AssertionError(f"multi {label}: float32 at depth 2 differs from one device by {f32[label]}")
        ext.cleanup()
    del shallow
    bf16, cos = {}, {}
    for label, (mesh, tp) in [("one", (None, False)), *meshes.items()]:
        ext = build_default_registry(device="cuda", dtype="bfloat16", mesh=mesh, tensor_parallel=tp).create("vit_l_16")
        bf16[label] = ext.extract_batch(patches, batch_size=32)
        ext.cleanup()
        if label != "one":
            cos[label] = float(_cos_rows(bf16["one"], bf16[label]).min())
            if not cos[label] >= 0.999:
                raise AssertionError(f"multi {label}: bfloat16 per-patch cosine {cos[label]} against one device")
    i8, one_wall = {}, 0.0
    for label, mesh in (("one", None), ("dp (2, 1)", meshes["dp (2, 1)"][0])):
        ext = build_default_registry(device="cuda", dtype="int8", mesh=mesh).create("vit_l_16")
        ext.extract_batch(patches[:4], batch_size=32)  # warm-up
        I.reset_launch_counts()
        t1 = time.perf_counter()
        i8[label] = ext.extract_batch(patches, batch_size=32)
        torch.cuda.synchronize()
        i8_wall = time.perf_counter() - t1
        if label == "one":
            one_wall = i8_wall
        counts = _int8_launches()
        if label != "one":
            replica_fwd = len(ext.replicas)
            if counts != (96 * replica_fwd, 96 * replica_fwd) or not _prologue_launches_are(replica_fwd) \
                    or dict(I.int8_linear.variant_launches) != {"wgmma": 96 * replica_fwd}:
                raise AssertionError(f"multi int8 dp: launches {counts} {dict(I.quantize_rows.prologue_launches)} "
                                     f"{dict(I.int8_linear.variant_launches)} in {replica_fwd} replica forwards")
            int8_launches = counts
        ext.cleanup()
    state["multi_int8_one"] = (patches, i8["one"], one_wall)  # (k2)'s tensor-parallel int8 is held against it
    i8_cos = float(_cos_rows(i8["one"], i8["dp (2, 1)"]).min())
    if not i8_cos >= 0.999:
        raise AssertionError(f"multi int8 dp: per-patch cosine {i8_cos} against one device")
    torch.cuda.empty_cache()
    log(f"multi (k2) vit_l_16 on {MULTI_CARD}, 32 patches at batch 32: float32 depth 2 max-abs vs one device "
        f"{ {k: f'{v:.3g}' for k, v in f32.items()} } (<= 1e-4, TF32 on before each build, off after); bfloat16 "
        f"full depth per-patch cosine min {cos} (>= 0.999); int8 dp cosine min {i8_cos:.6f} (>= 0.999), "
        f"{int8_launches} launches of quantize_rows_s8 / int8_linear_s8 in 2 replica forwards (96 each, "
        f"{VITL_PROLOGUE_LAUNCHES} by prologue, all linears wgmma), int8 dp extract_batch {i8_wall:.3f} s; "
        f"part {time.perf_counter() - t0:.1f} s wall [{state['card']}]")
    return int8_launches


def _int8_counts() -> dict:
    from atlaspatch_tpu_torch.ops import int8 as I

    return {"prologue": dict(I.quantize_rows.prologue_launches), "mode": dict(I.quantize_rows.mode_launches),
            "body": dict(I.quantize_rows.body_launches),
            "variant": dict(I.int8_linear.variant_launches), "out": dict(I.int8_linear.out_launches),
            "dequant_sum": I.dequant_sum.launches}


def _feature_gap(want, got) -> str:
    cos = _cos_rows(want, got)
    return (f"per-patch cosine min {cos.min():.7f}, max-abs {float(abs(got - want).max()):.4g} of "
            f"{float(abs(want).max()):.4g}, {float((got != want).mean()):.3e} of the features differ")


def _multi_tp_int8(state) -> dict:
    """(k2) tensor-parallel int8 on the (1, 2) mesh over the card named twice, against one-device
    int8 on the same 32 patches at batch 32: vit_l_16 at full width and depth from the registry
    (process --feature-parallel tensor --feature-precision int8's extractor), and dinov3_vit7b16 at
    full width (dim 4,096, 32 heads, gated MLP of 8,192), depth cut to 2, random weights. Features
    equal to one device's bit for bit (the int8 parts are exact; cosine, max-abs and the share of
    features that differ printed); the launches of one forward by prologue, mode, body, output dtype
    and dequant_sum_s32 as the design gives them. Returns vit_l_16's."""
    import dataclasses

    import numpy as np
    import torch

    from atlaspatch_tpu_torch.models.encoders import build_default_registry
    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor, init_random_weights_
    from atlaspatch_tpu_torch.models.encoders.vit import RowParallel, ViT, quantize_vit_state_dict
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
    from atlaspatch_tpu_torch.ops import int8 as I
    from atlaspatch_tpu_torch.parallel.mesh import embedding_mesh

    t0 = time.perf_counter()
    patches, want, one_wall = state.pop("multi_int8_one")
    tp = build_default_registry(device="cuda", dtype="int8", mesh=embedding_mesh(2, MULTI_CARD),
                                tensor_parallel=True).create("vit_l_16")
    attn = tp.replicas[0].blocks[0].attn
    if len(tp.replicas) != 1 or not (isinstance(attn, RowParallel) and attn.quantized and len(attn.shards) == 2) \
            or tp.replicas[0].spec.depth != 24:
        raise AssertionError(f"multi tp int8: replicas {len(tp.replicas)}, block attention {attn}")
    tp.extract_batch(patches[:4], batch_size=32)  # warm-up
    I.reset_launch_counts()
    t1 = time.perf_counter()
    got = tp.extract_batch(patches, batch_size=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _int8_counts()
    want_launches = _tp_launches(24, "gelu_tanh", 4)
    if launches != want_launches:
        raise AssertionError(f"multi tp int8 vit_l_16: launches in one forward {launches}, want {want_launches}")
    if not (np.isfinite(got).all() and np.array_equal(got, want)):
        raise AssertionError(f"multi tp int8 vit_l_16: {_feature_gap(want, got)}")
    tp.cleanup()
    log(f"multi (k2) vit_l_16 int8 tensor-parallel (1, 2) on {MULTI_CARD}, full depth, 32 patches at batch 32 "
        f"against one device's int8: {_feature_gap(want, got)} (bit for bit); one forward's launches {launches}; "
        f"extract_batch {wall:.3f} s (one device {one_wall:.3f} s, same run) [{state['card']}]")

    entry = ENTRIES["dinov3_vit7b16"]
    spec = dataclasses.replace(entry.spec, depth=2)
    if (spec.dim, spec.heads, spec.hidden_dim, spec.gated_mlp) != (4096, 32, 8192, True):
        raise AssertionError(f"dinov3_vit7b16 is not at full width: {spec}")
    state_dict = quantize_vit_state_dict(init_random_weights_(ViT(spec).cuda(), seed=0).state_dict())
    model = ViT(dataclasses.replace(spec, quant_int8=True)).cuda()
    model.load_state_dict(state_dict, strict=True)
    del state_dict
    kw = dict(name="dinov3_vit7b16", embedding_dim=entry.embedding_dim, spec=entry.preprocess, compute_dtype="int8")
    one7 = TorchFeatureExtractor(model=copy.deepcopy(model), device="cuda", **kw)
    want7 = one7.extract_batch(patches, batch_size=32)
    one7.cleanup()
    tp7 = TorchFeatureExtractor(model=model, mesh=embedding_mesh(2, MULTI_CARD), tensor_parallel=True, **kw)
    tp7.extract_batch(patches[:4], batch_size=32)
    I.reset_launch_counts()
    got7 = tp7.extract_batch(patches, batch_size=32)
    torch.cuda.synchronize()
    launches7 = _int8_counts()
    # per block: one layernorm quantizer a norm; a shard's amax-only and given-amax before proj
    # (identity) and fc2 (gelu_tanh of fc_gate times fc_up); qkv, fc_gate, fc_up on wgmma in bfloat16,
    # proj and fc2's partials on wgmma in int32 (shard K 2,048 and 4,096); a dequant_sum_s32 for proj
    # and one for fc2
    want_launches = _tp_launches(2, "gelu_tanh", 5)
    if launches7 != want_launches or not (np.isfinite(got7).all() and got7.shape == (32, 4096)
                                          and np.array_equal(got7, want7)):
        raise AssertionError(f"multi tp int8 dinov3_vit7b16: launches {launches7} (want {want_launches}); "
                             f"{_feature_gap(want7, got7)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    tp7.cleanup()
    del model, one7, tp7
    torch.cuda.empty_cache()
    log(f"multi (k2) dinov3_vit7b16 int8 (dim 4096, 32 heads, gated MLP 8192; depth 2 of 40, random weights) "
        f"tensor-parallel (1, 2) on {MULTI_CARD}, 32 patches at batch 32, against one device's int8: "
        f"{_feature_gap(want7, got7)} (bit for bit); one forward's launches {launches7}; peak memory {peak:.1f} GiB; "
        f"part {time.perf_counter() - t0:.1f} s wall [{state['card']}]")
    state["ragged_tp_launches"] = {name: _multi_tp_int8_ragged(state, name, patches) for name, _, _, _ in
                                   TP_RAGGED_CASES}
    return launches


def _multi_tp_int8_ragged(state, name: str, patches) -> dict:
    """(k2) ``name`` (medsiglip or virchow_v2: their fc2 shards' K, 2,152 and
    1,708, no multiple of 16) in the int8 serving mode at full width, depth
    cut to 2, random weights, tensor-parallel (1, 2) over the card named
    twice, against one device's int8 on the same 32 patches at batch 32:
    features bit for bit; one forward's launches as the design gives them,
    every linear on the wgmma body (the int32 partials of the shards at the
    16-byte pitch shard_vit gives their weights). Returns the launches."""
    import dataclasses

    import numpy as np
    import torch

    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor, init_random_weights_
    from atlaspatch_tpu_torch.models.encoders.vit import ViT, quantize_vit_state_dict
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
    from atlaspatch_tpu_torch.ops import int8 as I
    from atlaspatch_tpu_torch.parallel.mesh import embedding_mesh

    t0 = time.perf_counter()
    entry = ENTRIES[name]
    spec = dataclasses.replace(entry.spec, depth=2)
    state_dict = quantize_vit_state_dict(init_random_weights_(ViT(spec).cuda(), seed=0).state_dict())
    model = ViT(dataclasses.replace(spec, quant_int8=True)).cuda()
    model.load_state_dict(state_dict, strict=True)
    del state_dict
    act = model.blocks[0].mlp.act_name
    kw = dict(name=name, embedding_dim=entry.embedding_dim, spec=entry.preprocess, compute_dtype="int8")
    one = TorchFeatureExtractor(model=copy.deepcopy(model), device="cuda", **kw)
    want = one.extract_batch(patches, batch_size=32)
    one.cleanup()
    tp = TorchFeatureExtractor(model=model, mesh=embedding_mesh(2, MULTI_CARD), tensor_parallel=True, **kw)
    shard_k = {sh.fc2.weight_q.shape[1]: sh.fc2.weight_q.stride(0) for sh in tp.replicas[0].blocks[0].mlp.shards}
    tp.extract_batch(patches[:4], batch_size=32)
    I.reset_launch_counts()
    got = tp.extract_batch(patches, batch_size=32)
    torch.cuda.synchronize()
    launches = _int8_counts()
    want_launches = _tp_launches(2, act, 4)
    if launches != want_launches or shard_k != {spec.hidden_dim // 2: I.pitch16(spec.hidden_dim // 2)} \
            or not (np.isfinite(got).all() and got.shape == want.shape and np.array_equal(got, want)):
        raise AssertionError(f"multi tp int8 {name}: launches {launches} (want {want_launches}); fc2 shard K: row "
                             f"pitch {shard_k}; {_feature_gap(want, got)}")
    tp.cleanup()
    del model, one, tp
    torch.cuda.empty_cache()
    log(f"multi (k2) {name} int8 (dim {spec.dim}, {spec.heads} heads, MLP {spec.hidden_dim}{' SwiGLU' if spec.swiglu else ''}; "
        f"depth 2 of {entry.spec.depth}, random weights) tensor-parallel (1, 2) on {MULTI_CARD}, 32 patches at batch "
        f"32, against one device's int8: {_feature_gap(want, got)} (bit for bit); fc2 shards' K and row pitch "
        f"{shard_k}; one forward's launches {launches} (the int32 partials all on wgmma); part "
        f"{time.perf_counter() - t0:.1f} s wall [{state['card']}]")
    return launches


def _multi_finetune(state, tmp) -> int:
    """(k3) finetune-sam2 at the JAX defaults (Hiera-tiny, 1024, float32,
    global batch 2) from one init archive: one process on the card, then
    --data-parallel 2 over the card named twice, then two ranks sharing the
    card on gloo; and a one-rank nccl group all-reducing a step's gradients
    on the card, and one shard_train_step over the card named twice, each
    step's gradients held against the plain step's. Returns the attention
    launches of the multi-device runs."""
    import json as _json

    import numpy as np
    import torch
    import torch.distributed as dist

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.convert import load_into, load_npz, torch_to_flax_flat
    from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel, init_params
    from atlaspatch_tpu_torch.models.train import finetune as ft
    from atlaspatch_tpu_torch.models.train import loop
    from atlaspatch_tpu_torch.models.train.loop import collect_pairs, load_pair
    from atlaspatch_tpu_torch.ops import attention as A
    from atlaspatch_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.perf_counter()
    images, masks = _write_ft_corpus(tmp / "corpus", MULTI_FT_PAIRS, 1024, 768)
    cfg = SAM2Config.tiny()
    init = tmp / "init.npz"
    np.savez(init, **torch_to_flax_flat(init_params(cfg, seed=0), cfg))
    common = dict(epochs=1, batch_size=2, val_fraction=0.2, checkpoint=init, device="cuda", seed=0)
    one_losses = []
    t1 = time.perf_counter()
    one = loop.finetune_sam2(images, masks, tmp / "one", on_step=lambda s, loss: one_losses.append(loss), **common)
    one_s = time.perf_counter() - t1

    # --data-parallel 2 through the command line, the card named twice
    dp_losses, dp_steps = [], []
    real_loop, real_shard = loop.finetune_sam2, ft.shard_train_step

    def recording(*a, on_step=None, **k):
        def both(step, loss):
            dp_losses.append(loss)
            if on_step is not None:
                on_step(step, loss)
        return real_loop(*a, on_step=both, **k)

    def shard(model, optimizer, lr, mesh, **k):
        dp_steps.append(mesh.data_devices)
        return real_shard(model, optimizer, lr, mesh, **k)

    loop.finetune_sam2, ft.shard_train_step = recording, shard
    real_devices = mesh_mod.local_devices
    mesh_mod.local_devices = lambda kind="cuda": [torch.device(d) for d in MULTI_CARD]
    try:
        lines, dp_wall, dp_launches, _ = _cli_main(
            ["finetune-sam2", images, "--masks", masks, "-o", tmp / "dp", "--epochs", "1", "--batch-size", "2",
             "--val-fraction", "0.2", "--sam2-checkpoint", init, "--data-parallel", "2"])
    finally:
        loop.finetune_sam2, ft.shard_train_step = real_loop, real_shard
        mesh_mod.local_devices = real_devices
    if dp_steps != [[torch.device(d) for d in MULTI_CARD]] or dp_launches != 12:
        raise AssertionError(f"multi --data-parallel 2: meshes {dp_steps}, {dp_launches} launches (12: one "
                             "validation forward)")
    np.testing.assert_allclose(dp_losses, one_losses, rtol=2e-3)

    # two ranks on gloo sharing the card, through the loop
    t2 = time.perf_counter()
    ranks = _two_ranks(MULTI_FT_WORKER, lambda r: [images, masks, tmp / f"rank{r}", init, tmp / f"rank{r}.json"])
    ranks_s = time.perf_counter() - t2
    res = [_json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    if [r["backend"] for r in res] != ["gloo", "gloo"] or any(r["jax"] for r in res):
        raise AssertionError(f"multi ranks: backends {[r['backend'] for r in res]}, jax {[r['jax'] for r in res]}")
    np.testing.assert_allclose(res[0]["losses"], res[1]["losses"], rtol=1e-5)
    np.testing.assert_allclose(res[0]["losses"], one_losses, rtol=2e-3)
    np.testing.assert_allclose([res[0]["val_loss"], res[0]["val_iou"]], [one["val_loss"], one["val_iou"]],
                               rtol=2e-3)
    written = [sorted(p.name for p in (tmp / f"rank{r}").iterdir()) for r in range(2)]
    if written != [["sam2_finetuned.npz"], []] or any(r["launches"] != 12 for r in res):
        raise AssertionError(f"multi ranks: files {written}, launches {[r['launches'] for r in res]}")

    # a one-rank nccl group: the step's gradients all-reduced on the card
    pairs = collect_pairs(images, masks)
    loaded = [load_pair(img, mask, cfg.image_size) for img, mask in pairs[:2]]
    batch = np.stack([im for im, _ in loaded]), np.stack([mk for _, mk in loaded])
    models = []
    for _ in range(3):
        model = SAM2ImageModel(cfg)
        load_into(model, load_npz(init, cfg))
        models.append(model.to("cuda"))
    reduced = []
    real_all_reduce = dist.all_reduce

    def counted(tensor, *a, **k):
        reduced.append((tensor.device.type, tensor.numel()))
        return real_all_reduce(tensor, *a, **k)

    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    dist.all_reduce = counted
    try:
        backend = dist.get_backend()
        losses, params = [], []
        for model, all_reduce in zip(models, (True, False)):
            p = ft.trainable_parameters(model, "norms")
            optimizer, lr = ft.make_optimizer(p.values())
            losses.append(float(ft.make_train_step(model, optimizer, lr, all_reduce=all_reduce)(*batch)))
            params.append(p)
    finally:
        dist.all_reduce = real_all_reduce
        dist.destroy_process_group()
    # and one shard_train_step over the card named twice: one row per
    # replica, its summed gradients held where the update leaves them
    p = ft.trainable_parameters(models[2], "norms")
    optimizer, lr = ft.make_optimizer(p.values())
    dp_mesh = mesh_mod.LocalMesh([[torch.device(d)] for d in MULTI_CARD])
    losses.append(float(ft.shard_train_step(models[2], optimizer, lr, dp_mesh)(*batch)))
    params.append(p)

    # the card's backward is not bitwise repeatable (atomic adds), so the
    # gradients are held to the finetune phase's bound, each of its largest
    def grad_gap(got):
        return max(float((got[k].grad - params[1][k].grad).abs().max())
                   / max(float(params[1][k].grad.abs().max()), 1e-30) for k in got)

    grad_rel, shard_rel = grad_gap(params[0]), grad_gap(params[2])
    n_grad = sum(t.numel() for t in params[0].values()) + 1
    if backend != "nccl" or reduced != [("cuda", n_grad)] or grad_rel > FT_GRAD_BOUND \
            or abs(losses[0] - losses[1]) > 1e-6 * abs(losses[1]):
        raise AssertionError(f"multi nccl: backend {backend}, all-reduces {reduced} (want one of {n_grad} on the "
                             f"card), gradients differ by {grad_rel} of their largest, losses {losses}")
    if shard_rel > FT_GRAD_BOUND or abs(losses[2] - losses[1]) > 1e-4 * abs(losses[1]):
        raise AssertionError(f"multi shard_train_step on {MULTI_CARD}: summed gradients differ from the plain "
                             f"step's by {shard_rel} of their largest (bound {FT_GRAD_BOUND}), losses {losses}")
    log(f"multi (k3) finetune-sam2 1024 float32 global batch 2 ({len(one_losses)} steps + validation): one "
        f"process {one_s:.1f} s, losses {[round(x, 6) for x in one_losses]}; --data-parallel 2 on {MULTI_CARD} "
        f"{dp_wall:.1f} s, losses {[round(x, 6) for x in dp_losses]} (rtol 2e-3), 12 launches in its validation "
        f"forward; two gloo ranks sharing the card {ranks_s:.1f} s wall, losses {[round(x, 6) for x in res[0]['losses']]}"
        f" (ranks agree to 1e-5, rtol 2e-3 to one process), val loss {res[0]['val_loss']:.6f} vs "
        f"{one['val_loss']:.6f}, one sam2_finetuned.npz (rank 0), 12 launches each; one-rank nccl group: 1 "
        f"all-reduce of {n_grad} values on the card, its gradients within {grad_rel:.3g} of the plain step's (of each "
        f"tensor's largest; bound {FT_GRAD_BOUND}); shard_train_step on {MULTI_CARD}: summed gradients within "
        f"{shard_rel:.3g} of the plain step's, loss {losses[2]:.6f} vs {losses[1]:.6f}; part "
        f"{time.perf_counter() - t0:.1f} s wall [{state['card']}]")
    return dp_launches + sum(r["launches"] for r in res)


def _multi_cli(state, tmp) -> int:
    """(k4) segment-and-get-coords (float32, batch 1: the same forwards in
    every process) from two ranks of one group (gloo,
    sharing the card, no ATLASPATCH_NUM_HOSTS) over one output directory,
    against one process: every slide's coordinates byte for byte."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from atlaspatch_tpu_torch.utils.h5 import read_h5

    t0 = time.perf_counter()
    slides = tmp / "slides"
    slides.mkdir()
    with ProcessPoolExecutor(max_workers=MULTI_CLI_SLIDES, mp_context=multiprocessing.get_context("spawn")) as pool:
        for job in [pool.submit(_write_svs, str(slides / f"tslide{s:03d}.svs"), TIFF_WH, 100 + s, 3)
                    for s in range(MULTI_CLI_SLIDES)]:
            job.result()
    args = [*CLI_SEG_ARGS, "--verbose"]
    lines, one_wall, _, _ = _cli_main(["segment-and-get-coords", slides, "-o", tmp / "one", *args])
    if f"Completed {MULTI_CLI_SLIDES} slide(s), failures: 0" not in lines:
        raise AssertionError(f"multi cli one process printed {lines}")
    t1 = time.perf_counter()
    done = _two_ranks(MULTI_CLI_WORKER, lambda r: ["segment-and-get-coords", slides, "-o", tmp / "ranks", *args])
    ranks_wall = time.perf_counter() - t1
    launches = 0
    for r, (_, out) in enumerate(done):
        if "backend gloo" not in out or f"Host {r}/2 takes {MULTI_CLI_SLIDES // 2} of {MULTI_CLI_SLIDES}" not in out:
            raise AssertionError(f"multi cli rank {r}: no gloo group or no host shard in its log:\n{out[-2000:]}")
        launches += int(out.rsplit("LAUNCHES", 1)[1].split()[0])
    for s in range(MULTI_CLI_SLIDES):
        stem = f"tslide{s:03d}"
        a = read_h5(tmp / "one" / "patches" / f"{stem}.h5")[0]["coords"]
        b = read_h5(tmp / "ranks" / "patches" / f"{stem}.h5")[0]["coords"]
        if a.shape[0] == 0 or a.tobytes() != b.tobytes():
            raise AssertionError(f"multi cli {stem}: coordinates differ between one process and the two ranks")
        if sum(f"Processed {stem}.svs" in out for _, out in done) != 1:
            raise AssertionError(f"multi cli {stem}: not processed by exactly one rank")
    if list((tmp / "ranks" / "patches").glob("*.lock")):
        raise AssertionError("multi cli: lock files left")
    log(f"multi (k4) segment-and-get-coords over {MULTI_CLI_SLIDES} JPEG SVS of {TIFF_WH[0]}x{TIFF_WH[1]}: "
        f"one process {one_wall:.1f} s; two gloo ranks sharing the card {ranks_wall:.1f} s wall (each process "
        f"starts, loads and builds on its own), {launches} attention launches, every slide's coordinates byte "
        f"for byte one process's, each slide processed once, no lock left; part {time.perf_counter() - t0:.1f} s "
        f"[{state['card']}]")
    return launches


def phase_multi(state):
    """The multi-device paths on the one card: (k0) kernels at the
    per-replica shapes, (k1) data-parallel segmentation, (k2) data- and
    tensor-parallel embedding, (k3) data-parallel and multi-process
    fine-tuning and an nccl all-reduce, (k4) two command-line ranks."""
    import tempfile

    from atlaspatch_tpu_torch.parallel.mesh import embedding_mesh

    t0 = time.perf_counter()
    _multi_kernel_checks(state)
    tp_kernels = _tp_int8_kernel_rows(state)
    launches = _multi_seg(state, embedding_mesh(1, MULTI_CARD))
    state["multi_int8_launches"] = _multi_embed(state)
    state["tp_int8_records"] = _tp_int8_records(tp_kernels, _multi_tp_int8(state))
    state["tp_int8_records"][2]["ragged_tp_launches"] = state.pop("ragged_tp_launches")
    for rec in state["tp_int8_records"]:
        before = "" if "before_ms" not in rec else f" (the template mode {rec['before_ms']:.3f}, same run)"
        log(f"multi tp int8 record {rec['name']}: per vit_l_16 TP (1, 2) forward (batch 32) {rec['ms']:.3f} ms "
            f"device{before}, bound {rec['bound_ms']:.3f} ({rec['bound_by']}), plain {rec['plain_ms']:.3f}, library "
            f"{rec['library_ms'] and round(rec['library_ms'], 3)}; launches {rec['launches']} in one forward"
            + ("" if "pair_ms" not in rec else f"; both modes {rec['pair_ms']:.3f} (template "
               f"{rec['pair_before_ms']:.3f}, bound {rec['pair_bound_ms']:.3f})") + f" [{state['card']}]")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_multi_"))
    try:
        (tmp / "ft").mkdir()
        (tmp / "cli").mkdir()
        launches += _multi_finetune(state, tmp / "ft")
        launches += _multi_cli(state, tmp / "cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["multi_launches"] = launches
    log(f"multi: {launches} attention launches in the multi-device runs; phase {time.perf_counter() - t0:.1f} s "
        f"[{state['card']}]")



# --- the jobs phase: the port's launch scripts on the card -----------------------------
JOB_SCRIPTS = {part: Path(__file__).resolve().parent / "jobs" / f"atlaspatch_tpu_torch_{part}.sh"
               for part in ("patch.slurm", "features.slurm", "multinode.slurm")}
JOBS_SLIDES = 6
JOB_TIMEOUT = 300
JOB_FEATURE_COSINE = 0.999  # the bf16 bar where cuBLAS picks other kernels in the two processes
JOB_VARS = ("ATLASPATCH_NUM_HOSTS", "ATLASPATCH_HOST_ID", "ATLASPATCH_TORCH_TRACE", "WORLD_SIZE", "RANK",
            "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "PYTHON")


def _job_env(**extra) -> dict:
    """The calling environment (random weights, no checkpoint, stage counters
    on) without any group or host-shard variable, with ``extra``."""
    env = {k: v for k, v in os.environ.items() if k not in JOB_VARS and not k.startswith("SLURM_")}
    env.update(PYTHONPATH=str(Path(__file__).resolve().parent), **{k: str(v) for k, v in extra.items()})
    return env


def _script_argv(script: Path, env: dict, *extra) -> list[str]:
    """The command line ``script`` hands ``python -m atlaspatch_tpu_torch.cli``
    in ``env``, read by running it with a stub ``python`` that records its
    arguments (so an in-process run takes the script's own options)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_stub_") as d:
        stub = Path(d) / "python"
        stub.write_text('#!/bin/bash\nprintf \'%s\\0\' "$@" > "$ARGV_OUT"\n')
        stub.chmod(0o755)
        run_env = {k: v for k, v in env.items() if k != "PYTHON"}
        run_env.update(PATH=f"{d}{os.pathsep}{env['PATH']}", ARGV_OUT=f"{d}/argv")
        subprocess.run(["bash", str(script), *map(str, extra)], env=run_env, check=True, timeout=60)
        argv = [a.decode() for a in Path(f"{d}/argv").read_bytes().split(b"\0")[:-1]]
    if argv[:2] != ["-m", "atlaspatch_tpu_torch.cli"]:
        raise AssertionError(f"jobs: {script.name} ran python {argv[:3]}")
    return argv[2:]


def _run_jobs(runs: list[tuple[Path, dict, list]]) -> list[tuple[int, str]]:
    """Start each (script, env, extra flags) under ``bash`` at once, wait for
    each with JOB_TIMEOUT (killed past it); (rc, stdout + stderr) each."""
    procs = [subprocess.Popen(["bash", str(script), *map(str, extra)], env=env, cwd=Path(__file__).resolve().parent,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for script, env, extra in runs]
    done = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOB_TIMEOUT)
            done.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (script, _, _), (rc, out) in zip(runs, done):
        if rc != 0:
            raise AssertionError(f"jobs: {script.name} exited {rc}:\n{out[-3000:]}")
    return done


def _trace_totals(trace_dir: Path) -> tuple[int, int, int, int]:
    """(attention launches, SAM2 forwards, encoder forwards, trace files) in
    the Chrome traces one or more processes wrote to ``trace_dir``."""
    from atlaspatch_tpu_torch.utils.perf import trace_counts

    files = sorted(trace_dir.glob("trace-*.json"))
    counts = Counter()
    for f in files:
        counts.update(trace_counts(f))
    launches = sum(n for k, n in counts.items() if k.startswith("kernel:") and "flash_fwd" in k)
    return launches, counts["span:sam2_forward"], counts["span:embed_forward"], len(files)


def _coords(out: Path) -> dict:
    from atlaspatch_tpu_torch.utils.h5 import read_h5

    return {p.stem: read_h5(p)[0]["coords"] for p in sorted((out / "patches").glob("*.h5"))}


def _same_coords(part: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"jobs {part}: H5 files {sorted(got)}, want {sorted(want)}")
    for stem, coords in want.items():
        if coords.shape[0] == 0 or coords.tobytes() != got[stem].tobytes():
            raise AssertionError(f"jobs {part}: {stem} coords {got[stem].shape} differ from {coords.shape}")


def _processed_once(part: str, outs: list[str], stems) -> list[list[str]]:
    """Each slide in exactly one ``[OK]`` line of the runs' verbose output; the
    slides of each run."""
    mine = [[s for s in stems if f"[OK] {s}.svs ->" in out] for out in outs]
    twice = [s for s in stems if sum(s in m for m in mine) != 1]
    if twice:
        raise AssertionError(f"jobs {part}: slides {twice} not processed by exactly one process: {mine}")
    return mine


def _no_locks(part: str, out: Path) -> None:
    left = sorted(p.name for p in out.rglob("*.lock"))
    if left:
        raise AssertionError(f"jobs {part}: lock files left: {left}")


def phase_jobs(state):
    """The port's launch scripts run with bash on the card, over JOBS_SLIDES
    JPEG SVS of TIFF_WH: (l1) two copies of the patch script at once on one
    output directory, (l2) the features script over it, twice, (l3) the
    multi-node script on this one node through torchrun (two ranks sharing
    the card, stub srun and scontrol). Attention launches and forwards are
    counted from each script process's own trace (ATLASPATCH_TORCH_TRACE)."""
    import multiprocessing
    import socket
    import sysconfig
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from atlaspatch_tpu_torch.utils.h5 import read_h5_tree

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_jobs_"))
    try:
        slides = tmp / "slides"
        slides.mkdir()
        with ProcessPoolExecutor(max_workers=JOBS_SLIDES, mp_context=multiprocessing.get_context("spawn")) as pool:
            for job in [pool.submit(_write_svs, str(slides / f"jslide{s:03d}.svs"), TIFF_WH, 300 + s, 3)
                        for s in range(JOBS_SLIDES)]:
                job.result()
        stems = [f"jslide{s:03d}" for s in range(JOBS_SLIDES)]
        walls = {}

        # (l1) two copies of the patch script at once on one output directory
        t1 = time.perf_counter()
        patch = JOB_SCRIPTS["patch.slurm"]
        out = tmp / "out"
        slurm = dict(WSI_DIR=slides, OUT_DIR=out, SLURM_CPUS_PER_TASK=4, SLURM_GPUS_ON_NODE=1)
        copies = _run_jobs([(patch, _job_env(**slurm, PYTHON=sys.executable, ATLASPATCH_TORCH_TRACE=tmp / f"trace_{c}"),
                             ["--verbose"]) for c in "ab"])
        walls["l1"] = time.perf_counter() - t1
        argv = _script_argv(patch, _job_env(**dict(slurm, OUT_DIR=tmp / "ref")), "--verbose")
        lines, ref_wall, ref_launches, ref_forwards = _cli_main(argv)
        if f"Completed {JOBS_SLIDES} slide(s), failures: 0" not in lines or ref_launches != 12 * ref_forwards:
            raise AssertionError(f"jobs (l1) in-process run: {lines[-2:]}, {ref_launches} launches in "
                                 f"{ref_forwards} forwards")
        want = _coords(tmp / "ref")
        _same_coords("(l1)", _coords(out), want)
        split = _processed_once("(l1)", [o for _, o in copies], stems)
        _no_locks("(l1)", out)
        copy_counts = [_trace_totals(tmp / f"trace_{c}") for c in "ab"]
        l1_launches, l1_forwards = sum(c[0] for c in copy_counts), sum(c[1] for c in copy_counts)
        if [c[3] for c in copy_counts] != [1, 1] or not l1_forwards or l1_launches != 12 * l1_forwards:
            raise AssertionError(f"jobs (l1): traces (launches, forwards, -, files) {copy_counts}")
        log(f"jobs (l1) two copies of {patch.name} at once, {JOBS_SLIDES} slides, SLURM_CPUS_PER_TASK=4, "
            f"SLURM_GPUS_ON_NODE=1: {walls['l1']:.1f} s wall, rc 0 both; slides per copy "
            f"{[len(m) for m in split]} ({split}); traces: {l1_launches} attention launches in {l1_forwards} forwards "
            f"(per copy {[c[:2] for c in copy_counts]}); coordinates equal the in-process run's byte for byte "
            f"({' '.join(argv[:1] + argv[4:])}: {ref_wall:.1f} s, {ref_forwards} forwards); no lock left "
            f"[{state['card']}]")

        # (l2) the features script over (l1)'s output, with an in-process run beside it, then again
        t2 = time.perf_counter()
        features = JOB_SCRIPTS["features.slurm"]
        shutil.copytree(out, tmp / "feat_ref")
        fenv = dict(WSI_DIR=slides, OUT_DIR=out, EXTRACTORS="vit_l_16", SLURM_CPUS_PER_TASK=4, SLURM_GPUS_ON_NODE=1)
        _run_jobs([(features, _job_env(**fenv, PYTHON=sys.executable, ATLASPATCH_TORCH_TRACE=tmp / "trace_f1"), [])])
        walls["l2"] = time.perf_counter() - t2
        f_launches, f_sam2, f_forwards, f_files = _trace_totals(tmp / "trace_f1")
        if f_files != 1 or not f_forwards or f_sam2 or f_launches:
            raise AssertionError(f"jobs (l2): the script's trace has {f_forwards} encoder forwards, {f_sam2} SAM2 "
                                 f"forwards, {f_launches} attention launches")
        argv = _script_argv(features, _job_env(**dict(fenv, OUT_DIR=tmp / "feat_ref")))
        lines, feat_wall, feat_launches, feat_sam2 = _cli_main(argv)
        if f"Completed {JOBS_SLIDES} slide(s), failures: 0" not in lines or feat_launches or feat_sam2:
            raise AssertionError(f"jobs (l2) in-process run: {lines[-2:]}, {feat_sam2} SAM2 forwards")
        max_abs, cos_min, rows = 0.0, 1.0, 0
        for stem in stems:
            got = read_h5_tree(out / "patches" / f"{stem}.h5").datasets
            ref = read_h5_tree(tmp / "feat_ref" / "patches" / f"{stem}.h5").datasets
            feats, n = got.get("features/vit_l_16"), got["coords"].shape[0]
            if feats is None or feats.shape != (n, 1024) or not np.isfinite(feats).all() \
                    or got["coords"].tobytes() != want[stem].tobytes():
                raise AssertionError(f"jobs (l2): {stem} features {None if feats is None else feats.shape} for "
                                     f"{n} coordinate rows")
            max_abs = max(max_abs, float(np.abs(feats - ref["features/vit_l_16"]).max()))
            cos_min = min(cos_min, float(_cos_rows(feats, ref["features/vit_l_16"]).min()))
            rows += n
        bar = "max-abs 0" if max_abs == 0.0 else f"cosine >= {JOB_FEATURE_COSINE}"
        if max_abs != 0.0 and not cos_min >= JOB_FEATURE_COSINE:
            raise AssertionError(f"jobs (l2): features differ from the in-process run's: max-abs {max_abs}, "
                                 f"cosine min {cos_min}")
        _no_locks("(l2)", out)
        mtimes = {p.name: p.stat().st_mtime_ns for p in (out / "patches").glob("*.h5")}
        t3 = time.perf_counter()
        (_, again), = _run_jobs([(features, _job_env(**fenv, PYTHON=sys.executable,
                                                     ATLASPATCH_TORCH_TRACE=tmp / "trace_f2"), [])])
        again_wall = time.perf_counter() - t3
        again_counts = _trace_totals(tmp / "trace_f2")
        if again_counts[:3] != (0, 0, 0) or {p.name: p.stat().st_mtime_ns for p in
                                              (out / "patches").glob("*.h5")} != mtimes:
            raise AssertionError(f"jobs (l2) second run: (launches, SAM2, encoder forwards, traces) {again_counts}, "
                                 f"or an H5 file was rewritten")
        log(f"jobs (l2) {features.name} EXTRACTORS=vit_l_16 over (l1)'s output: {walls['l2']:.1f} s wall, rc 0; "
            f"{f_forwards} encoder forwards, 0 SAM2 forwards (trace); {rows} feature rows, each slide's equal to "
            f"its coordinate rows; against the in-process process run ({feat_wall:.1f} s): max-abs {max_abs:.3g}, "
            f"cosine min {cos_min:.6f}, bar held: {bar}; second run {again_wall:.1f} s wall, 0 forwards, no H5 "
            f"rewritten [{state['card']}]")

        # (l3) the multi-node script on this node: torchrun, two ranks sharing the card
        t4 = time.perf_counter()
        multinode = JOB_SCRIPTS["multinode.slurm"]
        stub = tmp / "stub_bin"
        stub.mkdir()
        (stub / "srun").write_text('#!/bin/bash\nexec "$@"\n')
        (stub / "scontrol").write_text("#!/bin/bash\necho localhost\n")
        for f in stub.iterdir():
            f.chmod(0o755)
        # torchrun of this interpreter, after the stubs
        path = os.pathsep.join([str(stub), sysconfig.get_path("scripts"), os.environ["PATH"]])
        torchrun = shutil.which("torchrun", path=path)
        if torchrun is None:
            raise AssertionError(f"jobs (l3): no torchrun on {path}")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        menv = _job_env(WSI_DIR=slides, OUT_DIR=tmp / "multi", SLURM_NNODES=1, SLURM_JOB_NODELIST="localhost",
                        SLURM_JOB_ID=4242, G=2, RDZV_PORT=port, PYTHON=sys.executable,
                        ATLASPATCH_TORCH_TRACE=tmp / "trace_m")
        menv["PATH"] = path
        # the script passes --fast; these flags give (l1)'s segmentation settings back
        extra = ["--seg-precision", "float32", "--seg-input-size", "1024", "--verbose"]
        (_, mout), = _run_jobs([(multinode, menv, extra)])
        walls["l3"] = time.perf_counter() - t4
        for r in range(2):
            if not re.search(rf"rank {r}/2 \(local rank {r} of 2\), backend gloo", mout) \
                    or f"Host {r}/2 takes" not in mout:
                raise AssertionError(f"jobs (l3): rank {r} logged no gloo group or no host shard:\n{mout[-3000:]}")
        _same_coords("(l3)", _coords(tmp / "multi"), want)
        ranks_split = _processed_once("(l3)", [mout], stems)
        _no_locks("(l3)", tmp / "multi")
        m_launches, m_forwards, _, m_files = _trace_totals(tmp / "trace_m")
        if m_files != 2 or not m_forwards or m_launches != 12 * m_forwards:
            raise AssertionError(f"jobs (l3): {m_files} traces, {m_launches} attention launches in {m_forwards} "
                                 f"forwards")
        shards = re.findall(r"Host \d/2 takes \d+ of \d+ slides", mout)
        log(f"jobs (l3) {multinode.name} on one node (stub srun, scontrol -> localhost), G=2 ranks sharing the card "
            f"through {torchrun}: {walls['l3']:.1f} s wall, rc 0; both ranks on gloo, {shards}; "
            f"{len(ranks_split[0])} slides; traces: {m_launches} attention launches in {m_forwards} forwards; "
            f"coordinates equal (l1)'s byte for byte (extra flags {' '.join(extra)}); no lock left [{state['card']}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["jobs_launches"] = l1_launches + m_launches
    log(f"jobs: wall s per part (l1) {walls['l1']:.1f}, (l2) {walls['l2']:.1f} (+ second run {again_wall:.1f}), "
        f"(l3) {walls['l3']:.1f}; {state['jobs_launches']} attention launches in the scripts' processes; phase "
        f"{time.perf_counter() - t0:.1f} s [{state['card']}]")


# --- the quality phase: --trainable all on the card, then the mask-quality loop ----------
QUALITY_SCRIPT = Path(__file__).resolve().parent / "atlaspatch_tpu_torch" / "tools" / "quality_loop.sh"
QUALITY_TIMEOUT = 900  # s for the whole loop script, killed past it
QUALITY_BATCH = 4  # the loop's --batch-size
QUALITY_IOU = 0.90  # trained mean IoU at least this,
QUALITY_ERROR_RATIO = 5  # and its mean error (1 - IoU) at most 1/5 of the random-weights baseline's
# the reference's figures (a quality yardstick, not a target): trained and random mean IoU on 16 held-out slides
JAX_REFERENCE_IOU = {"trained": 0.980, "random": 0.149}
def _is_key_bias(key: str) -> bool:
    """A Flax SAM2 tensor that is or holds a key bias: a ``k_proj`` bias,
    a Hiera ``qkv`` bias (its middle third). Softmax over the keys is
    unchanged when one vector is added to every key, so their exact gradient
    is zero and what backward gives is rounding noise."""
    return key.endswith(("k_proj/bias", "qkv/bias"))


def _float64_gradients(init: Path, cfg, images, targets, device: str) -> dict:
    """{Flax key: gradient} of the loss at ``init`` in float64 on ``device``:
    the exact gradient, to float32 rounding, that the float32 steps are
    held to where float32 cannot reach FT_GRAD_BOUND."""
    import torch

    from atlaspatch_tpu_torch.models.sam2.convert import load_into, load_npz, to_flax_layout
    from atlaspatch_tpu_torch.models.sam2.model import SAM2ImageModel
    from atlaspatch_tpu_torch.models.train import finetune as ft

    model = SAM2ImageModel(cfg)
    load_into(model, load_npz(init, cfg))
    model.to(device, torch.float64)
    params = ft.trainable_parameters(model, "all")
    ft.seg_loss_fn(model, torch.as_tensor(images).to(device),
                   torch.as_tensor(targets).to(device, torch.float64)).backward()
    return to_flax_layout(model, {k: t.grad if t.grad is not None else torch.zeros_like(t)
                                  for k, t in params.items()})


def _grad_check(grads: dict, cpu: dict, exact: dict) -> dict:
    """{Flax key: (gap, bound, rule)} of a float32 step's gradients ``grads``
    against the CPU's ``cpu``: max |grads - cpu| within FT_GRAD_BOUND of the
    tensor's largest |cpu| (rule ``own``), or of the step's largest |cpu| of
    all tensors where a tensor's own scale is noise: a key bias (``key
    bias``), or a gradient that two float32 computations cannot be held to
    the bound on, the CPU's own float32 one lying further than half of
    FT_GRAD_BOUND of its largest from the float64 gradient ``exact``
    (``float32``: sums over every position that cancel, as the tiled window
    embedding's; two computations each that far off may differ by the
    bound)."""
    import numpy as np

    largest = max(float(np.abs(g).max()) for g in cpu.values())
    rows = {}
    for k, g in cpu.items():
        own = max(float(np.abs(g).max()), 1e-30)
        rule = ("key bias" if _is_key_bias(k) else
                "float32" if float(np.abs(g - exact[k]).max()) > FT_GRAD_BOUND / 2 * own else "own")
        rows[k] = (float(np.abs(grads[k] - g).max()), FT_GRAD_BOUND * (own if rule == "own" else largest), rule)
    return rows


def _quality_step(state, tmp, cfg) -> dict:
    """(m1): one --trainable all AdamW step at full Hiera-tiny width, 1024^2,
    batch QUALITY_BATCH, from one random init .npz, on the card and on the
    CPU (and on the card with TF32 on, a control), then the card step's
    time, device-busy ms and peak memory."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from atlaspatch_tpu_torch.models.sam2.convert import torch_to_flax_flat
    from atlaspatch_tpu_torch.models.sam2.model import init_params
    from atlaspatch_tpu_torch.models.train import finetune as ft
    from atlaspatch_tpu_torch.models.train.loop import collect_pairs, load_pair

    images, masks = _write_ft_corpus(tmp / "corpus", QUALITY_BATCH, 1024, 768)
    loaded = [load_pair(img, mask, cfg.image_size) for img, mask in collect_pairs(images, masks)]
    batch = np.stack([im for im, _ in loaded]), np.stack([mk for _, mk in loaded])
    init = tmp / "init.npz"
    np.savez(init, **torch_to_flax_flat(init_params(cfg, seed=0), cfg))
    n_attn = sum(cfg.blocks_per_stage)
    torch.cuda.reset_peak_memory_stats()

    record = {"train": [], "eval": []}
    restore = _counting_train_steps(record)
    try:
        card_model, card_loss, card_grads = _one_train_step(init, cfg, *batch, "cuda", trainable="all")
        t0 = time.perf_counter()
        _, cpu_loss, cpu_grads = _one_train_step(init, cfg, *batch, "cpu", trainable="all")
        cpu_step_s = time.perf_counter() - t0
        _, control_loss, control_grads = _one_train_step(init, cfg, *batch, "cuda", tf32=True, trainable="all")
    finally:
        restore()
    for s in record["train"]:
        if s["grad_calls"] != n_attn or s["launches"]:
            raise AssertionError(f"quality (m1) train step: {s['launches']} kernel launches, {s['grad_calls']} plain "
                                 f"autograd attention calls, want 0 and {n_attn}")
    if len(record["train"]) != 3:
        raise AssertionError(f"quality (m1): {len(record['train'])} train steps counted, want 3")
    exact = _float64_gradients(init, cfg, *batch, "cuda")
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    sound, control = _grad_check(card_grads, cpu_grads, exact), _grad_check(control_grads, cpu_grads, exact)
    over = {k: r for k, r in sound.items() if not r[0] <= r[1]}
    if not loss_rel <= 1e-4 or over:
        raise AssertionError(f"quality (m1) card vs CPU: loss rel {loss_rel}; gradients over their bound "
                             f"(gap, bound, rule): {over}")
    control_over = sorted(k for k, r in control.items() if not r[0] <= r[1])
    if not control_over:
        raise AssertionError("quality (m1): a step in TF32 passes every gradient bound")
    worst = max((r[0] / r[1], k) for k, r in sound.items() if r[2] == "own")
    worst_cpu = float(np.abs(cpu_grads[worst[1]] - exact[worst[1]]).max()) / float(np.abs(cpu_grads[worst[1]]).max())
    special = {k: r for k, r in sound.items() if r[2] != "own"}
    f32_limited = {k: (r[0], *(float(np.abs(g[k] - exact[k]).max()) for g in (card_grads, cpu_grads)),
                       float(np.abs(cpu_grads[k]).max())) for k, r in special.items() if r[2] == "float32"}
    del control_grads, cpu_grads, exact

    # the card step's time: the same model and batch, steps after the first
    params = ft.trainable_parameters(card_model, "all")
    optimizer, lr = ft.make_optimizer(params.values())
    step = ft.make_train_step(card_model, optimizer, lr)
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        float(step(*batch))
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step(*batch))
    rows = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if not busy_ms:
        raise AssertionError("the profiler recorded no device time in the all-parameter train step")
    step_ms = 1e3 * statistics.median(times[1:])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"quality (m1) one --trainable all AdamW step, Hiera-tiny at full width, 1024^2, batch {QUALITY_BATCH}, "
        f"{len(params)} tensors: loss card {card_loss:.6f} vs CPU {cpu_loss:.6f} (rel {loss_rel:.3g} <= 1e-4); "
        f"{len(sound) - len(special)} gradients within FT_GRAD_BOUND {FT_GRAD_BOUND} of their own largest |CPU "
        f"gradient|, the worst at {worst[0] * FT_GRAD_BOUND:.3g} of it ({worst[1]}; the CPU's distance to the "
        f"float64 gradient {worst_cpu:.3g} of it); control, the same step with "
        f"TF32 on: {len(control_over)} tensors over their bound ({control_over[:4]}...); CPU step {cpu_step_s:.1f} s")
    log(f"quality (m1) held against the step's largest |CPU gradient| instead of their own (key biases: exact "
        f"gradient zero, softmax over the keys is unchanged when one vector is added to every key, so backward gives "
        f"rounding noise): " + ", ".join(f"{k} {r[0]:.3g} <= {r[1]:.3g}" for k, r in special.items()
                                          if r[2] == "key bias"))
    log(f"quality (m1) held against the step's largest |CPU gradient| too, as two float32 steps cannot be held to "
        f"FT_GRAD_BOUND of their own (the CPU's float32 gradient further than half of it from the float64 one; sums "
        f"that cancel): (card vs CPU, "
        f"card vs float64, CPU vs float64, own largest) " + ", ".join(
            f"{k} {g:.3g} {c:.3g} {e:.3g} {m:.3g}" for k, (g, c, e, m) in f32_limited.items()))
    log(f"quality (m1) launches: 0 in each of {len(record['train'])} train steps, {n_attn} plain autograd attention "
        f"calls each; train step {step_ms:.1f} ms by host clock (median of {len(times) - 1} after the first), "
        f"{QUALITY_BATCH * 1e3 / step_ms:.2f} images/s, device busy {busy_ms:.2f} ms (torch.profiler), peak memory "
        f"{peak_gib:.2f} GiB [{state['card']}]")
    for e in rows[:8]:
        log(f"quality profile {e.self_device_time_total / 1e3:8.3f} ms "
            f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% x{e.count:<4d} {e.key[:100]}")
    del card_model, step, optimizer, params
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, busy_ms=busy_ms, images_s=QUALITY_BATCH * 1e3 / step_ms, peak_gib=peak_gib,
                loss_rel=loss_rel, grad_worst=worst, f32_limited=f32_limited, cpu_step_s=cpu_step_s)


def _csv_means(path: Path) -> dict:
    import csv
    import statistics

    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {k: statistics.fmean(float(r[k]) for r in rows) for k in ("iou", "f1", "precision", "recall")} | {
        "n": len(rows)}


def _quality_loop(state, tmp) -> dict:
    """(m2): the loop script with bash, at its own options, every line of its
    output time-stamped on arrival; its epochs, scores and traces read back."""
    from atlaspatch_tpu_torch.utils.perf import trace_counts

    work, traces = tmp / "qloop", tmp / "trace"
    env = _job_env(PYTHON=sys.executable, ATLASPATCH_TORCH_TRACE=traces)
    t0 = time.perf_counter()
    proc = subprocess.Popen(["bash", str(QUALITY_SCRIPT), str(work)], env=env, cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    watchdog = threading.Timer(QUALITY_TIMEOUT, lambda: os.killpg(proc.pid, signal.SIGKILL))
    watchdog.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"quality (m2): {QUALITY_SCRIPT.name} exited {rc} after {wall:.1f} s:\n"
                             + "\n".join(ln for _, ln in lines[-40:]))
    starts = {}  # when bash traced each step's first command, by what it runs
    for t, ln in lines:
        m = re.match(r"\+ .*-m atlaspatch_tpu_torch\.(?:cli (\S+)|tools\.synthetic_corpus)", ln)
        if m:
            starts.setdefault(m.group(1) or "corpus", t)
    train_s = starts["detect-tissue"] - starts["finetune-sam2"]
    epochs = [tuple(float(x) for x in m.groups()) for _, ln in lines if not ln.startswith("+")
              for m in [re.search(r"epoch \d+/\d+: train loss ([\d.]+) \| val loss ([\d.]+) val IoU ([\d.]+)", ln)]
              if m]
    scores = {name: _csv_means(work / f"{name}.csv") for name in ("trained", "random")}
    files = sorted(traces.glob("trace-*.json"))
    per_run = []
    for f in files:
        c = trace_counts(f)
        flash = sum(n for k, n in c.items() if k.startswith("kernel:") and "flash_fwd" in k)
        tf32x3 = sum(n for k, n in c.items() if k.startswith("kernel:") and "flash_fwd_tf32x3" in k)
        f32win = sum(n for k, n in c.items() if k.startswith("kernel:") and "flash_fwd_f32win" in k)
        per_run.append((flash, tf32x3, f32win, c["span:sam2_forward"]))
    if len(per_run) != 2 or any(not fw or (n, a, b) != (12 * fw, 9 * fw, 3 * fw) for n, a, b, fw in per_run):
        raise AssertionError(f"quality (m2): detect-tissue traces (launches, tf32x3, f32_win, forwards) {per_run}, "
                             "want 12, 9 and 3 per forward in each of 2")
    if len(epochs) != 20 or not epochs[-1][0] < epochs[0][0]:
        raise AssertionError(f"quality (m2): epochs (train loss, val loss, val IoU) {epochs}")
    trained, random = scores["trained"], scores["random"]
    if trained["n"] != 16 or random["n"] != 16:
        raise AssertionError(f"quality (m2): {trained['n']} trained and {random['n']} random rows, want 16 each")
    if not (trained["iou"] >= QUALITY_IOU and 1 - trained["iou"] <= (1 - random["iou"]) / QUALITY_ERROR_RATIO):
        raise AssertionError(f"quality (m2): trained mean IoU {trained['iou']:.4f}, random {random['iou']:.4f}; want "
                             f">= {QUALITY_IOU} and an error 1 - IoU at most 1/{QUALITY_ERROR_RATIO} of random's")
    card = state["card"]
    log(f"quality (m2) bash {QUALITY_SCRIPT.relative_to(QUALITY_SCRIPT.parents[2])} (20 epochs, batch 4, 1024^2, "
        f"PYTHON={sys.executable}): rc 0 in {wall:.1f} s wall; steps begin at (s) "
        + ", ".join(f"{k} {v:.1f}" for k, v in starts.items()) + f"; training {train_s:.1f} s wall [{card}]")
    log("quality (m2) epochs (train loss, val loss, val IoU): "
        + "; ".join(f"{i + 1}: {a:.4f} {b:.4f} {c:.4f}" for i, (a, b, c) in enumerate(epochs)))
    for name in ("trained", "random"):
        sc = scores[name]
        log(f"quality (m2) {name} masks on 16 held-out 4096x3072 slides: mean IoU {sc['iou']:.4f}, F1 {sc['f1']:.4f}, "
            f"precision {sc['precision']:.4f}, recall {sc['recall']:.4f} [{card}]; JAX reference, TPU, "
            f"docs/TRAINING.md: IoU {JAX_REFERENCE_IOU[name]:.3f}")
    log(f"quality (m2) the two detect-tissue processes' traces (attention launches, tf32x3, f32_win, forwards): "
        f"{per_run}")
    log(f"quality (m2) trained against random: mean IoU {trained['iou']:.4f} >= {QUALITY_IOU}, error "
        f"{1 - trained['iou']:.4f} = 1/{(1 - random['iou']) / (1 - trained['iou']):.1f} of random's "
        f"{1 - random['iou']:.4f} (held: <= 1/{QUALITY_ERROR_RATIO}); IoU above random by "
        f"{trained['iou'] - random['iou']:.4f} (the reference's 0.831 is over its own random draw) [{card}]")
    state["quality_launches"] = sum(r[0] for r in per_run)
    return dict(wall=wall, train_s=train_s, epochs=epochs, scores=scores, traces=per_run)


def phase_quality(state):
    """(m1) one all-parameter train step on the card against the CPU; (m2)
    the mask-quality loop (atlaspatch_tpu_torch/tools/quality_loop.sh) at the
    reference's options: corpora, finetune-sam2 --trainable all from random
    init, detect-tissue trained and random, evaluate-masks."""
    import tempfile

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_"))
    try:
        step = _quality_step(state, tmp, SAM2Config.tiny())
        loop = _quality_loop(state, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["quality"] = dict(step, **loop)
    log(f"quality: phase {time.perf_counter() - t0:.1f} s [{state['card']}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to drive", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state: dict = {}
    t_all = time.perf_counter()
    try:
        for name, phase in (("env", phase_env), ("build", phase_build), ("kernel", phase_kernel),
                            ("seg", phase_seg), ("profile", phase_profile), ("coords", phase_coords),
                            ("runner", phase_runner), ("tiff", phase_tiff), ("embed", phase_embed),
                            ("int8", phase_int8), ("process", phase_process), ("cli", phase_cli),
                            ("weights", phase_weights), ("finetune", phase_finetune), ("multi", phase_multi),
                            ("jobs", phase_jobs), ("quality", phase_quality)):
            t0 = time.perf_counter()
            try:
                phase(state)
            except BaseException as e:  # noqa: BLE001 — report the phase, then fail
                print(f"phase {name} FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
                raise
            log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
    finally:
        if "tiff_tmp" in state:  # a phase between tiff and weights failed
            shutil.rmtree(state.pop("tiff_tmp"), ignore_errors=True)
    record = dict(state["kernel_record"], launches=state["launches"], runner_launches=state["runner_launches"],
                  tiff_launches=state["tiff_launches"], process_launches=state["process_launches"],
                  cli_launches=state["cli_launches"], weights_launches=state["weights_launches"],
                  finetune_launches=state["finetune_launches"], multi_launches=state["multi_launches"],
                  jobs_launches=state["jobs_launches"], quality_launches=state["quality_launches"])
    keys = ("name", "route", "source", "sources", "replaces", "launches", "runner_launches", "tiff_launches",
            "process_launches", "cli_launches", "weights_launches", "finetune_launches", "multi_launches",
            "jobs_launches", "quality_launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    int8_keys = ("name", "route", "source", "sources", "replaces", "launches", "variant_launches",
                 "prologue_launches", "extract_launches", "multi_launches", "virchow_variant_launches", "max_abs_err",
                 "flip_share", "ms", "mma_ms", "ms_b256", "plain_ms", "bound_ms", "bound_ms_b256", "bound_by",
                 "library_ms", "unfused_ms", "unfused_ms_b256", "int_mm_ms", "bf16_linear_ms", "virchow_fc2",
                 "virchow_forward_ms", "virchow_packed_forward_ms")
    for rec, launches in zip(state["int8_records"], state["multi_int8_launches"]):
        rec["multi_launches"] = launches  # the multi phase's data-parallel int8 extract_batch
    int8 = [{k: rec[k] for k in int8_keys if k in rec} for rec in state["int8_records"]]
    tp_keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "flip_share", "ms", "before_ms",
               "mma_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "proj_ms", "proj_library_ms", "pair_ms",
               "pair_before_ms", "pair_bound_ms", "ragged", "ragged_tp_launches")
    tp_int8 = [{k: rec[k] for k in tp_keys if k in rec} for rec in state["tp_int8_records"]]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: record[k] for k in keys}, *int8, *tp_int8]}))
    print(state["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
